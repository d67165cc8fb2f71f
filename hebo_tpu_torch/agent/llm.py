"""LLM backends for the agent engine (port of ``hebo_tpu/agent/llm.py``).

The backend is a plain ``str -> str`` callable.  Provided:
  * ``MockLLM`` — deterministic scripted/rule backend for tests and CI,
  * ``HFBackend`` — a local HuggingFace transformers causal LM on
    ``device`` (``"cuda"`` by default); ``transformers`` is imported when
    the first prompt builds the pipeline.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from ..utils.device import resolve_device

__all__ = ["MockLLM", "HFBackend"]


class MockLLM:
    """Deterministic backend: either a FIFO script or a rule table of
    (substring → response)."""

    def __init__(
        self,
        script: Optional[Sequence[str]] = None,
        rules: Optional[Dict[str, str]] = None,
        default: str = "OK",
    ):
        self.script = list(script) if script else []
        self.rules = rules or {}
        self.default = default
        self.calls: List[str] = []

    def __call__(self, prompt: str) -> str:
        self.calls.append(prompt)
        if self.script:
            return self.script.pop(0)
        for key, resp in self.rules.items():
            if key in prompt:
                return resp
        return self.default


class HFBackend:
    """HuggingFace causal-LM backend on ``device``."""

    def __init__(self, model_name: str = "sshleifer/tiny-gpt2", max_new_tokens: int = 48, device="cuda"):
        self.model_name = model_name
        self.max_new_tokens = max_new_tokens
        self.device = resolve_device(device)
        self._pipe = None

    def _ensure(self):
        if self._pipe is None:
            from transformers import pipeline

            self._pipe = pipeline("text-generation", model=self.model_name, device=self.device)

    def __call__(self, prompt: str) -> str:
        self._ensure()
        out = self._pipe(
            prompt, max_new_tokens=self.max_new_tokens, do_sample=False,
            return_full_text=False,
        )
        return out[0]["generated_text"]
