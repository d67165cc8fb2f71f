"""Episodic KV memory with two-stage retrieval and a sharded similarity
stage (port of ``hebo_tpu/emllm/memory.py``).

Per layer, the KV stream is split into episodic events, each summarized by
its highest-norm ("representative") keys.  Retrieval into the attention
window is two-stage, as EM-LLM's context manager: (1) **similarity**, the
top-k_s events by query·representative score, (2) **contiguity**, the
temporal neighbours of those events.

The events live on the device in preallocated buffers (E_cap, L_event, H,
Dh) that grow by doubling, with a ``lens`` vector; ``buffers()`` returns
views of the filled rows, so no call stacks the events again.  The "full"
mode scores every stored key in batches of events, so the (E, L, H, Tq)
scores never exist whole.  ``retrieve_sharded`` is the similarity stage
over the port's mesh (``parallel/sharded.py``): each rank scores its block
of events and the global top-k merges through an all-gather of (score,
index) pairs.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..parallel.sharded import all_gather, mesh_rank, mesh_size
from ..utils.device import resolve_device

__all__ = ["EpisodicKVMemory", "retrieve_sharded"]

# events scored together in "full" mode: 64 × 128 keys × 8 heads × 512
# query tokens of float32 scores are 128 MiB
_FULL_BATCH_ELEMS = 1 << 25


class EpisodicKVMemory:
    """Append-only episodic store for one layer, on ``device``."""

    def __init__(self, event_len: int = 32, n_rep: int = 4, device="cuda"):
        self.event_len = event_len
        self.n_rep = n_rep
        self.device = resolve_device(device)
        self._n = 0
        self._k = self._v = self._reps = self._lens = None  # allocated at the first event

    def __len__(self):
        return self._n

    def _as(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device, dtype=dtype)

    def _reserve(self, n_new: int, H: int, Dh: int, dtype):
        cap = 0 if self._k is None else self._k.shape[0]
        need = self._n + n_new
        if need <= cap:
            return
        new = max(need, 2 * cap, 1)
        L, R = self.event_len, self.n_rep

        def grow(old, shape, dt):
            t = torch.zeros((new,) + shape, dtype=dt, device=self.device)
            if old is not None:
                t[: self._n] = old[: self._n]
            return t

        self._k = grow(self._k, (L, H, Dh), dtype)
        self._v = grow(self._v, (L, H, Dh), dtype)
        self._reps = grow(self._reps, (R, H, Dh), dtype)
        self._lens = grow(self._lens, (), torch.int64)

    def add_events(self, K, V, spans):
        """K, V: (T, H, Dh), numpy or tensors; spans: list of (start, end).
        Each event keeps its first ``event_len`` rows (zero-padded) and, as
        representatives, its ``n_rep`` highest-norm keys over all its rows
        (zero rows where it has fewer)."""
        K, V = self._as(K), self._as(V)
        spans = [(int(s), int(e)) for s, e in spans if min(int(e), len(K)) > int(s)]
        if not spans:
            return
        T, H, Dh = K.shape
        L, R, n_ev = self.event_len, self.n_rep, len(spans)
        starts = np.asarray([s for s, _ in spans])
        ns = np.asarray([min(e, T) - s for s, e in spans])
        self._reserve(n_ev, H, Dh, K.dtype)
        # the first L rows of each event, zero past its end
        rows = starts[:, None] + np.arange(L)[None]
        keep = self._as(np.arange(L)[None] < ns[:, None])[..., None, None]
        idx = self._as(np.minimum(rows, T - 1))
        sl = slice(self._n, self._n + n_ev)
        self._k[sl] = torch.where(keep, K[idx], 0)
        self._v[sl] = torch.where(keep, V[idx], 0)
        # representatives: the highest-norm keys of the whole event
        W = int(ns.max())
        rows = starts[:, None] + np.arange(W)[None]
        inside = self._as(np.arange(W)[None] < ns[:, None])
        norms = torch.linalg.vector_norm(K.reshape(T, -1), dim=1)
        nr = torch.where(inside, norms[self._as(np.minimum(rows, T - 1))], -torch.inf)
        r = min(R, W)
        top = torch.topk(nr, r, dim=1).indices  # (n_ev, r), by falling norm
        got = self._as(starts)[:, None] + top
        has = (top < self._as(ns)[:, None])[..., None, None]
        self._reps[sl] = 0
        self._reps[sl, :r] = torch.where(has, K[got.clamp(max=T - 1)], 0)
        self._lens[sl] = self._as(np.minimum(ns, L))
        self._n += n_ev

    def buffers(self):
        """Views of the filled rows: (E, L, H, Dh) K / V, (E, n_rep, H, Dh)
        reps, (E,) lens."""
        if not self._n:
            return None
        n = self._n
        return self._k[:n], self._v[:n], self._reps[:n], self._lens[:n]

    def scores(self, q, mode: str = "reps") -> torch.Tensor:
        """(E,) similarity of every event to the query block q (Tq, H, Dh)."""
        E = self._n
        q = self._as(q, self._k.dtype)
        if mode == "full":
            L, H, Dh = self._k.shape[1:]
            qh = q.reshape(-1, H, Dh).permute(1, 2, 0)  # (H, Dh, Tq)
            per = max(1, _FULL_BATCH_ELEMS // (L * H * qh.shape[-1]))
            valid = torch.arange(L, device=self.device)[None] < self._lens[:E, None]  # (E, L)
            out = []
            for e0 in range(0, E, per):
                e1 = min(E, e0 + per)
                kb = self._k[e0:e1].reshape(-1, H, Dh).transpose(0, 1)  # (H, b·L, Dh)
                s = torch.bmm(kb, qh).amax(-1)  # (H, b·L): max over the query tokens
                s = s.reshape(H, e1 - e0, L).amax(0)  # (b, L): and over the heads
                out.append(torch.where(valid[e0:e1], s, -torch.inf).amax(-1))
            return torch.cat(out)
        qf = q.reshape(-1, q.shape[-2] * q.shape[-1]).mean(0)
        rf = self._reps[:E].reshape(E, self.n_rep, -1).amax(1)
        return rf @ qf

    def retrieve(self, q, k_sim: int = 4, k_contig: int = 2, mode: str = "reps") -> List[int]:
        """Two-stage retrieval for query block q (Tq, H, Dh) → sorted event
        indices (similarity winners + temporal neighbours).

        ``mode="reps"`` scores the high-norm representative keys (the mean
        query against each event's elementwise max over its reps);
        ``mode="full"`` max-pools the attention score q·k over every stored
        key row and head of an event and over the query tokens.  One host
        read (the top-k indices) per call."""
        if not self._n:
            return []
        s = self.scores(q, mode)
        top = torch.topk(s, min(k_sim, self._n)).indices.cpu().tolist()
        chosen = set(top)
        for t in top:  # contiguity stage
            for d in range(1, k_contig + 1):
                if t - d >= 0:
                    chosen.add(t - d)
                if t + d < self._n:
                    chosen.add(t + d)
        return sorted(chosen)

    def gather_kv(self, event_ids: List[int]):
        """(Lr, H, Dh) concatenated K / V and the (Lr,) validity mask of the
        retrieved ids, on the memory's device; None for no ids."""
        if len(event_ids) == 0:
            return None
        idx = self._as(list(event_ids), torch.int64)
        H, Dh = self._k.shape[2:]
        m = torch.arange(self.event_len, device=self.device)[None] < self._lens[idx][:, None]
        return self._k[idx].reshape(-1, H, Dh), self._v[idx].reshape(-1, H, Dh), m.reshape(-1)


def retrieve_sharded(mesh, reps, q, k_sim: int = 4, axis: str = "mem") -> torch.Tensor:
    """The similarity stage over the ranks of ``mesh`` (``make_mesh``; None
    is a world of one): every rank passes the same (E, F) flattened
    representatives and (F,) query (the JAX package's caller passes one
    global array), scores its block of E / world rows on the tensors'
    device, and the (score, global index) pairs of each block's top-k are
    all-gathered, rank-major, and merged by a top-k on every rank.
    Returns the (k_sim,) global indices by falling score.  E must be a
    multiple of the world size, as ``shard_map`` requires.  ``axis`` must
    name the mesh's axis.  Ties may resolve to another index than
    ``lax.top_k``'s (the lower one)."""
    if mesh is not None and tuple(mesh.mesh_dim_names) != (axis,):
        raise ValueError(f"retrieve_sharded: axis {axis!r} is not the mesh's {mesh.mesh_dim_names}")
    reps, q = torch.as_tensor(reps), torch.as_tensor(q)
    E, world = reps.shape[0], mesh_size(mesh)
    if E % world:
        raise ValueError(f"retrieve_sharded: {E} events do not divide over {world} ranks")
    per = E // world
    d = mesh_rank(mesh)
    scores = reps[d * per:(d + 1) * per] @ q.to(reps.device)
    top_s, top_i = torch.topk(scores, min(k_sim, per))
    all_s = all_gather(top_s, mesh)
    all_i = all_gather(top_i + d * per, mesh)
    return all_i[torch.topk(all_s, k_sim).indices]
