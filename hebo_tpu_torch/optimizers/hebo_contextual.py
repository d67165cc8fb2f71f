"""Contextual HEBO (port of ``hebo_tpu/optimizers/hebo_contextual.py``):
context variables are design-space parameters fixed per ``suggest`` call
(``fix_input``); observations across contexts share one surrogate."""

from __future__ import annotations

from typing import Dict, Optional

from .hebo import HEBO

__all__ = ["HEBO_VectorContextual"]


class HEBO_VectorContextual(HEBO):
    support_contextual = True

    def __init__(self, space, context_params=None, **kw):
        super().__init__(space, **kw)
        self.context_params = list(context_params or [])
        for name in self.context_params:
            if name not in space.params:
                raise ValueError(f"unknown context param {name}")

    def suggest(self, n_suggestions: int = 1, context: Optional[Dict] = None):
        fix = dict(context or {})
        unknown = set(fix) - set(self.context_params)
        if unknown:
            raise ValueError(f"non-context keys: {unknown}")
        return super().suggest(n_suggestions, fix_input=fix or None)
