"""Output parsers: extract structured actions from LLM text.

Parity: Agent prompt parsers (src/agent/parsers) — tolerant extraction of
``Action: foo[args]`` (and bare ``foo[args]``) from free-form responses.
"""

from __future__ import annotations

import re

__all__ = ["parse_action", "parse_final_answer"]

_ACTION_RE = re.compile(r"(?:Action\s*:\s*)?([a-zA-Z_][\w ]*\[[^\]]*\])")


def parse_action(text: str) -> str:
    """First action-shaped token in the response; '' if none."""
    m = _ACTION_RE.search(text)
    return m.group(1).strip() if m else ""


def parse_final_answer(text: str) -> str:
    m = re.search(r"(?:final answer|answer)\s*[:=]\s*(.+)", text, re.I)
    return m.group(1).strip() if m else text.strip()
