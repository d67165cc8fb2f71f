"""Surprise-based event segmentation with graph-theoretic refinement (port
of ``hebo_tpu/emllm/segmentation.py``).

A token stream is split into "episodic events" at points of high model
surprise (−log p(token)), then each boundary is moved within a local
window to the position that maximizes the modularity of the key-similarity
graph (EM-LLM's similarity refinement).

The boundaries are a host decision, as in the JAX package.  The similarity
S = K Kᵀ of the normalized keys is formed once per call on the keys'
device, and one boundary's ≤ 2·window + 1 candidate positions are scored
as one (C, T, T) masked reduction: one host read per boundary.  The sweep
stays greedy (each boundary's window depends on the one chosen before it).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

__all__ = ["surprise_boundaries", "refine_boundaries", "segment_events"]


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def surprise_boundaries(surprise, gamma: float = 1.0, min_event: int = 8) -> np.ndarray:
    """Initial boundaries where surprise(t) > μ + γσ (numpy's population
    σ), spaced ≥ min_event.  surprise: (T,) per-token −log p, numpy or a
    tensor.  Returns sorted boundary indices (host numpy)."""
    s = _host(surprise)
    thr = s.mean() + gamma * s.std()
    cand = np.where(s > thr)[0]
    bounds = []
    last = -min_event
    for c in cand:
        if c - last >= min_event:
            bounds.append(int(c))
            last = c
    return np.asarray(bounds, dtype=np.int64)


def _modularity_gain(K: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Intra-event similarity minus expected (the modularity surrogate used
    for boundary refinement).  labels (T,) or a batch (C, T) → () or (C,)."""
    return _gains(K @ K.T, labels)


def _gains(S: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    T = S.shape[0]
    same = labels[..., :, None] == labels[..., None, :]
    intra = torch.where(same, S, 0.0).sum((-2, -1)) / (T * T)
    total = S.sum() / (T * T)
    frac_same = same.to(S.dtype).mean((-2, -1))
    return intra - total * frac_same


def refine_boundaries(keys, boundaries, window: int = 4, trace: Optional[list] = None) -> np.ndarray:
    """Shift each boundary within ±window to the position maximizing the
    similarity-graph modularity (greedy, one pass; the first maximum wins,
    as ``np.argmax``).  keys (T, F) numpy or a tensor, on whose device the
    scores are computed.  ``trace``, when given, receives one (boundary
    index, candidate positions, their scores) per scored boundary."""
    T = len(keys)
    keys = torch.as_tensor(keys)
    K = (keys / (torch.linalg.vector_norm(keys, dim=1, keepdim=True) + 1e-8)).float()
    S = K @ K.T
    pos = torch.arange(T, device=K.device)
    bounds = [int(b) for b in boundaries]
    for bi in range(len(bounds)):
        lo = bounds[bi - 1] + 1 if bi > 0 else 1
        hi = bounds[bi + 1] - 1 if bi + 1 < len(bounds) else T - 1
        cand = list(range(max(lo, bounds[bi] - window), min(hi, bounds[bi] + window) + 1))
        if not cand:
            continue
        trial = np.repeat(np.asarray(bounds, np.int64)[None], len(cand), 0)
        trial[:, bi] = cand
        trial = torch.as_tensor(trial, device=K.device)
        labels = torch.searchsorted(trial, pos.expand(len(cand), T).contiguous(), right=True)
        scores = _gains(S, labels).cpu().numpy()
        if trace is not None:
            trace.append((bi, cand, scores))
        bounds[bi] = cand[int(np.argmax(scores))]
    return np.asarray(sorted(set(bounds)), dtype=np.int64)


def segment_events(keys, surprise, gamma: float = 1.0, min_event: int = 8, refine_window: int = 4,
                   trace: Optional[list] = None) -> List[tuple]:
    """→ list of (start, end) half-open event spans covering [0, T).
    ``trace`` is passed to ``refine_boundaries``."""
    T = len(keys)
    b = surprise_boundaries(surprise, gamma, min_event)
    if len(b) > 1:
        b = refine_boundaries(keys, b, refine_window, trace=trace)
    edges = [0] + [int(x) for x in b if 0 < x < T] + [T]
    return [(edges[i], edges[i + 1]) for i in range(len(edges) - 1) if edges[i + 1] > edges[i]]
