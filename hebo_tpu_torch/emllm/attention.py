"""Episodic-memory attention: local window + retrieved events (port of
``hebo_tpu/emllm/attention.py``).

Each query block attends over (a) its local sliding window and (b) the KV
of retrieved episodic events, concatenated into one masked dot-product
attention, so the context is bounded by window + retrieved size whatever
the stream's length (EM-LLM's attention patches).

``masked_attention`` writes the JAX package's einsums and softmax: masked
logits are −1e9, not −inf, so a key set with every row masked gives the
mean of V (``scaled_dot_product_attention`` with a boolean mask gives NaN
there).  ``EMLLMAttention`` keeps the local window and the layer's
``EpisodicKVMemory`` on its device, segments the overflow by surprise as
the stream flows, and answers queries with retrieval-augmented attention.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.device import resolve_device
from .memory import EpisodicKVMemory
from .segmentation import _host, segment_events

__all__ = ["masked_attention", "EMLLMAttention"]


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """q (Tq, H, Dh), k / v (Tk, H, Dh), mask (Tk,) bool → (Tq, H, Dh), on
    the tensors' device; logits scaled by 1/√float32(Dh)."""
    d = q.shape[-1]
    logits = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(d)
    logits = torch.where(mask[None, None, :], logits, -1e9)
    return torch.einsum("hqk,khd->qhd", torch.softmax(logits, dim=-1), v)


class EMLLMAttention:
    """Single-layer episodic attention over an unbounded KV stream, on
    ``device`` (``"cuda"`` by default; ``"cpu"`` runs there)."""

    def __init__(self, n_heads: int, head_dim: int, local_window: int = 64, event_len: int = 32,
                 k_sim: int = 4, k_contig: int = 1, surprise_gamma: float = 1.0, device="cuda"):
        self.H, self.Dh = n_heads, head_dim
        self.local_window = local_window
        self.k_sim = k_sim
        self.k_contig = k_contig
        self.surprise_gamma = surprise_gamma
        self.device = resolve_device(device)
        self.memory = EpisodicKVMemory(event_len=event_len, device=self.device)
        self._local_k = torch.zeros((0, n_heads, head_dim), device=self.device)
        self._local_v = torch.zeros((0, n_heads, head_dim), device=self.device)

    def ingest(self, K, V, surprise):
        """Append a chunk of the stream (K, V (T, H, Dh); surprise, host
        numpy or a tensor, aligned with the chunk); the overflow beyond the
        local window is segmented into events and archived to episodic
        memory.  As in the JAX package, the overflow takes the surprise of
        this chunk's first ``overflow`` tokens, padded on the left with its
        first value where the chunk is shorter."""
        K = torch.as_tensor(K, device=self.device)
        V = torch.as_tensor(V, device=self.device)
        self._local_k = torch.cat([self._local_k, K])
        self._local_v = torch.cat([self._local_v, V])
        overflow = len(self._local_k) - self.local_window
        if overflow > 0:
            Ko = self._local_k[:overflow]
            Vo = self._local_v[:overflow]
            s = _host(surprise)[-len(K):][:overflow]
            if len(s) < overflow:
                s = np.pad(s, (overflow - len(s), 0), mode="edge")
            spans = segment_events(Ko.reshape(len(Ko), -1), s, gamma=self.surprise_gamma,
                                   min_event=max(4, self.memory.event_len // 4))
            self.memory.add_events(Ko, Vo, spans)
            self._local_k = self._local_k[overflow:]
            self._local_v = self._local_v[overflow:]

    def attend(self, Q) -> torch.Tensor:
        """Retrieval-augmented attention for queries (Tq, H, Dh): the
        retrieved events (the "reps" mode) come before the local window."""
        parts_k, parts_v = [self._local_k], [self._local_v]
        parts_m = [torch.ones(len(self._local_k), dtype=torch.bool, device=self.device)]
        ids = self.memory.retrieve(Q, self.k_sim, self.k_contig)
        if ids:
            kk, vv, mm = self.memory.gather_kv(ids)
            parts_k.insert(0, kk)
            parts_v.insert(0, vv)
            parts_m.insert(0, mm)
        Q = torch.as_tensor(Q, device=self.device).float()
        return masked_attention(Q, torch.cat(parts_k).float(), torch.cat(parts_v).float(), torch.cat(parts_m))
