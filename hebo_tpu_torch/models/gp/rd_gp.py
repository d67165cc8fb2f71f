"""Random-decomposition additive GP (port of ``hebo_tpu/models/gp/rd_gp.py``;
RDUCB, MCBO ``RandDecompositionGP``).

K(x, x') = Σ_c σ_c² Π_{d ∈ clique c} k_d(x_d, x'_d): Matérn-5/2 on the
min-max-scaled numerics, exp-agreement on the categoricals.  The cliques
are a random spanning tree (``random_tree``), a random overlapping cover or
partition, or learned by the Gibbs structure learner (``structure.py``).

Every clique's Gram comes from one batched tensor program, where the JAX
package loops over cliques (rd_gp.py:118-131): the (B, D, N, M) stack of
per-dimension kernels, a gather by the cliques' dimension indices (padded
with a slab of ones), a product over each clique's slots and a sum
weighted by the clique scales.  The per-clique posteriors that the
message-passing optimizer and ``AddLCB`` read (``predict_cliques``) take
all cliques, each with its own query set, in one call, with the cache's
W = L⁻¹ where the JAX package solves with L (rd_gp.py:174).  The fit is
``GPCore.fit_from_batched`` (Adam, 100 epochs, lr 0.05 by default): every
step one K1 ladder at (restarts, bucket).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...utils.dtypes import pad_bucket
from ..base import register_model
from .gp import GP, GPCache, GPCore, GPData, GPParams, make_data
from .structure import assignment_to_cliques, learn_assignment

__all__ = ["random_tree", "graph_overlap_cliques", "graph_nonoverlap_cliques", "RDGPCore", "RDGP"]


def graph_overlap_cliques(D: int, rng: np.random.Generator, clique_size: int = 3,
                          n_cliques: int = 0) -> List[Tuple[int, ...]]:
    """Random overlapping clique cover (RDUCB ``GraphOverlap``)."""
    n_cliques = n_cliques or max(1, D // max(clique_size - 1, 1))
    cliques, covered = [], set()
    while len(cliques) < n_cliques or len(covered) < D:
        c = tuple(sorted(rng.choice(D, size=min(clique_size, D), replace=False)))
        cliques.append(c)
        covered.update(c)
        if len(cliques) > 4 * n_cliques:
            break
    for d in range(D):  # ensure full coverage
        if d not in covered:
            cliques.append((d,))
    return cliques


def graph_nonoverlap_cliques(D: int, rng: np.random.Generator,
                             clique_size: int = 3) -> List[Tuple[int, ...]]:
    """Random partition into disjoint cliques (``GraphNonOverlap``)."""
    perm = list(rng.permutation(D))
    out = []
    while perm:
        out.append(tuple(sorted(perm[:clique_size])))
        perm = perm[clique_size:]
    return out


def random_tree(D: int, rng: np.random.Generator) -> List[Tuple[int, int]]:
    """Random spanning tree by random-order union (the disjoint-set
    construction of RDUCB's ``get_random_graph``)."""
    if D == 1:
        return [(0, 0)]
    nodes = list(rng.permutation(D))
    edges = []
    connected = [nodes[0]]
    for v in nodes[1:]:
        u = connected[rng.integers(len(connected))]
        edges.append((min(u, v), max(u, v)))
        connected.append(v)
    return edges


def _slot_product(G: torch.Tensor) -> torch.Tensor:
    """(B, C, k, N, M) → (B, C, N, M): the product over each clique's k slots."""
    K = G[:, :, 0]
    for i in range(1, G.shape[2]):
        K = K * G[:, :, i]
    return K


class RDGPCore(GPCore):
    """Additive-over-cliques GP core.  ``cliques``: tuples of opt-frame
    column indices.  ``log_ls`` holds the per-dimension lengthscales (the
    numerics, then the categoricals' θ) and then the per-clique log scales."""

    def __init__(self, *args, cliques: Sequence[Tuple[int, ...]] = (), **kw):
        super().__init__(*args, **kw)
        self.cliques = tuple(tuple(c) for c in cliques)
        self.n_cliques = len(self.cliques)
        self.sc_off = self.d_num + len(self.cat_dims)
        self.d_feat = self.sc_off + self.n_cliques
        D = self.d_num + len(self.cat_dims)
        # each clique's distinct dims (rd_gp.py:120 multiplies over set(dims)),
        # padded with the index D of a slab of ones
        dims = [tuple(dict.fromkeys(c)) for c in self.cliques]
        k = max((len(c) for c in dims), default=1)
        self._slots = np.full((self.n_cliques, k), D, np.int64)
        for i, c in enumerate(dims):
            self._slots[i, : len(c)] = c
        # per opt-frame dim: its lengthscale's index in log_ls, its scaling
        # column among the numerics (-1: categorical)
        self._ls_idx = np.zeros(D, np.int64)
        self._num_col = np.full(D, -1, np.int64)
        for j, d in enumerate(self.numeric_dims):
            self._ls_idx[d], self._num_col[d] = j, j
        for j, d in enumerate(self.cat_dims):
            self._ls_idx[d] = self.d_num + j

    def _meta(self, device):
        """(slots, ls index, numeric column, is-categorical) on ``device``."""
        def make(d):
            t = lambda a: torch.as_tensor(a, device=d)
            return (t(self._slots), t(self._ls_idx), t(np.maximum(self._num_col, 0)),
                    t(self._num_col < 0))
        return self._const("rd_meta", device, make)

    def dim_kernels(self, params: GPParams, X1: torch.Tensor, X2: torch.Tensor,
                    data: GPData, dims: torch.Tensor) -> torch.Tensor:
        """(B, *dims.shape, N, M) per-dimension kernels k_d for the opt-frame
        dims ``dims``, between the columns X1 (*dims.shape, N) and
        X2 (*dims.shape, M) of those dims (rd_gp.py:93-110)."""
        _, ls_idx, num_col, is_cat = self._meta(X1.device)
        B = params.log_sc.shape[0]
        lead = dims.shape
        flat = dims.reshape(-1)
        ls = torch.exp(params.log_ls.index_select(1, ls_idx.index_select(0, flat))).view(B, *lead, 1, 1)
        cat = is_cat.index_select(0, flat).view(*lead, 1, 1)
        if self.d_num:
            col = num_col.index_select(0, flat)
            lb = data.x_lb.index_select(0, col).view(*lead, 1)
            span = data.x_span.index_select(0, col).view(*lead, 1)
            s1, s2 = (X1 - lb) / span, (X2 - lb) / span
        else:
            s1, s2 = X1, X2
        diff = torch.abs(s1[..., :, None] - s2[..., None, :]) / ls
        s = math.sqrt(5.0) * diff
        num = (1.0 + s + 5.0 * diff ** 2 / 3.0) * torch.exp(-s)
        if not self.cat_dims:
            return num
        agree = (X1[..., :, None] == X2[..., None, :]).to(X1.dtype)
        return torch.where(cat, torch.exp(ls * (agree - 1.0)), num)

    def clique_grams(self, params: GPParams, X1: torch.Tensor, X2: torch.Tensor,
                     data: GPData, cliques: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, C, N, M) σ_c² Π_d k_d of the cliques ``cliques`` (C,) (all by
        default) between X1 (N, D) and X2 (M, D), or X2 (C, M, D): one
        query set per clique."""
        slots, _, _, _ = self._meta(X1.device)
        if cliques is None:
            cliques = torch.arange(self.n_cliques, device=X1.device)
        sl = slots.index_select(0, cliques)  # (C, k)
        D = self._num_col.shape[0]
        valid = sl < D
        d = torch.where(valid, sl, torch.zeros_like(sl))
        x1 = X1.transpose(0, 1).index_select(0, d.reshape(-1)).view(*d.shape, -1)
        if X2.dim() == 2:
            x2 = X2.transpose(0, 1).index_select(0, d.reshape(-1)).view(*d.shape, -1)
        else:
            x2 = torch.gather(X2.transpose(1, 2), 1, d[:, :, None].expand(-1, -1, X2.shape[1]))
        Kd = self.dim_kernels(params, x1, x2, data, d)  # (B, C, k, N, M)
        Kd = torch.where(valid[None, :, :, None, None], Kd, torch.ones_like(Kd))
        sc = torch.exp(params.log_ls[:, self.sc_off:].index_select(1, cliques))
        return sc[:, :, None, None] * _slot_product(Kd)

    def gram_points(self, params: GPParams, X1: torch.Tensor, X2: torch.Tensor,
                    data: GPData) -> torch.Tensor:
        """(B, N, M): the stack of per-dimension kernels over all D dims,
        gathered by the cliques' slots, multiplied within and summed over
        the cliques with their scales."""
        slots, _, _, _ = self._meta(X1.device)
        D = self._num_col.shape[0]
        ar = torch.arange(D, device=X1.device)
        stack = self.dim_kernels(params, X1.transpose(0, 1), X2.transpose(0, 1), data, ar)
        stack = torch.cat([stack, torch.ones_like(stack[:, :1])], 1)  # (B, D + 1, N, M)
        B, _, N, M = stack.shape
        G = stack.index_select(1, slots.reshape(-1)).view(B, *slots.shape, N, M)
        sc = torch.exp(params.log_ls[:, self.sc_off:])
        return torch.einsum("bc,bcnm->bnm", sc, _slot_product(G))

    def prior_diag(self, params: GPParams) -> torch.Tensor:
        """(B,) Σ_c σ_c²."""
        return torch.exp(params.log_ls[:, self.sc_off:]).sum(-1)

    def init_params(self, data: GPData, n: int, generator: Optional[torch.Generator] = None,
                    draws=None) -> GPParams:
        """``n`` stacked initial sets (rd_gp.py:138-159): lengthscales
        0.1·N(0, 1), clique scales 1/n_cliques, no embeddings.  ``draws`` =
        (unused, ls_normals (n, D_feat)), as ``GPCore.init_params``'s."""
        f32 = dict(dtype=torch.float32, device=data.X.device)
        if draws is None:
            z_ls = torch.randn((n, self.d_feat), generator=generator, **f32)
        else:
            z_ls = torch.as_tensor(draws[1], **f32)
        log_ls = 0.1 * z_ls
        scale = -math.log(float(max(self.n_cliques, 1)))
        log_ls = torch.cat([log_ls[:, : self.sc_off],
                            torch.full((n, self.n_cliques), scale, **f32)], 1)
        return GPParams(
            log_ls=log_ls, log_sc=torch.zeros((n,), **f32),
            log_noise=torch.full((n,), math.log(1e-2), **f32), mean=torch.zeros((n,), **f32),
            emb=torch.zeros((n, 0, 0), **f32), log_wa=torch.zeros((n, self.d_num), **f32),
            log_wb=torch.zeros((n, self.d_num), **f32))

    def predict_cliques(self, params: GPParams, cache: GPCache, data: GPData, Xs: torch.Tensor,
                        cliques: torch.Tensor):
        """Per-sample posteriors (mu, var), each (S, C, P, 1), of the
        additive components ``cliques`` (C,) at their query sets Xs
        (C, P, D), standardized-y frame, no constant mean (rd_gp.py:162-177)."""
        if cache.Wf is None:
            raise ValueError("predict_cliques needs the dense cache's Wf = L⁻¹")
        Ks = self.clique_grams(params, data.X, Xs, data, cliques)  # (S, C, N, P)
        Ks = Ks * data.mask.to(Ks.dtype)[:, None]
        mu = Ks.transpose(-1, -2) @ cache.alpha[:, None]
        v = cache.Wf[:, None] @ Ks
        sc = torch.exp(params.log_ls[:, self.sc_off:].index_select(1, cliques))
        var = torch.clamp(sc[:, :, None] - (v * v).sum(-2), min=1e-10)[..., None]
        okb = cache.ok[:, None, None, None]
        return (torch.where(okb, mu, torch.zeros_like(mu)),
                torch.where(okb, var, torch.ones_like(var)))


@register_model("gp_rd")
class RDGP(GP):
    """Random-decomposition GP with resampling of the decomposition
    (rd_gp.py:180-305).

    ``resample_decomposition()`` draws a fresh random tree (RDUCB's policy,
    algorithms.py:398-431), or a random cover / partition
    (``decomposition="overlap"`` / ``"nonoverlap"``); with
    ``decomposition="learn"`` it marks the structure stale, and the next
    ``fit`` runs the Gibbs structure learner on the training data."""

    def __init__(self, space, num_out: int = 1, device="cuda", **conf):
        super().__init__(space, num_out=num_out, device=device, **conf)
        self._conf = conf
        self._decomp_seed = conf.get("decomposition_seed", 0)
        self._learn_pending = False
        self.resample_decomposition()

    def resample_decomposition(self):
        rng = np.random.default_rng(self._decomp_seed)
        self._decomp_seed += 1
        D = self.space.num_cols
        strategy = self._conf.get("decomposition", "tree")
        if strategy in ("tree", "learn"):
            # "learn" starts from a random tree; the learner replaces it at
            # the next fit
            self.cliques = random_tree(D, rng)
            if strategy == "learn":
                self._learn_pending = True
        elif strategy == "overlap":
            self.cliques = graph_overlap_cliques(D, rng, clique_size=self._conf.get("clique_size", 3))
        elif strategy == "nonoverlap":
            self.cliques = graph_nonoverlap_cliques(D, rng,
                                                    clique_size=self._conf.get("clique_size", 3))
        else:
            raise ValueError(f"unknown decomposition {strategy!r}")
        self._rebuild_core()

    def _rebuild_core(self):
        space, conf = self.space, self._conf
        self.core = RDGPCore(
            numeric_dims=tuple(space.numeric_dims) + tuple(space.perm_dims),
            cat_dims=tuple(space.cat_dims),
            num_categories=tuple(int(space.num_categories[c]) for c in space.cat_dims),
            optimizer=conf.get("optimizer", "adam"),
            n_steps=conf.get("num_epochs", 100),
            lr=conf.get("lr", 0.05),
            n_ensemble=conf.get("n_ensemble", 1),
            cliques=tuple(self.cliques),
        )

    def learn_decomposition(self, X: np.ndarray, y: np.ndarray, draws=None):
        """Run the Gibbs learner on (opt-frame X, y) and adopt the
        best-likelihood decomposition (rd_gp.py:236-267); ``draws`` as
        ``learn_assignment``'s."""
        n_pad = pad_bucket(max(len(X), 2))
        data = make_data(X, y, self.core.numeric_dims, n_pad, self.device)
        D = self.space.num_cols
        mgs = int(self._conf.get("max_group_size", 3))
        # M must exceed ceil(D / max_group_size), or no single-dim move is
        # feasible; the default leaves 4 slack groups
        M = int(self._conf.get("n_groups", min(D, -(-D // mgs) + 4)))
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self._decomp_seed)
        self._decomp_seed += 1
        z, _ = learn_assignment(
            data.X, data.y, data.mask, data.x_lb, data.x_span,
            numeric_dims=tuple(self.core.numeric_dims), cat_dims=tuple(self.core.cat_dims),
            M=M, max_group_size=mgs, n_sweeps=int(self._conf.get("n_structure_sweeps", 2)),
            generator=gen, draws=draws)
        self.cliques = assignment_to_cliques(z.cpu().numpy(), M)
        self._rebuild_core()
        self._learn_pending = False

    def fit(self, X, y):
        if self._learn_pending and len(X) >= 3:
            self.learn_decomposition(np.asarray(X), np.asarray(y))
        return super().fit(X, y)

    def predict_cliques(self, Xs: Sequence[np.ndarray], cliques: Sequence[int]):
        """Per-clique posteriors at opt-frame query sets, raw-y frame: one
        batched evaluation per distinct query count; returns lists of
        (P_c, 1) numpy arrays, in the order of ``cliques``."""
        out_mu, out_var = [None] * len(cliques), [None] * len(cliques)
        groups = {}
        for i, x in enumerate(Xs):
            groups.setdefault(len(x), []).append(i)
        ys = float(self.data.y_std)
        with torch.no_grad():
            for idx in groups.values():
                Xq = torch.as_tensor(np.stack([np.asarray(Xs[i], np.float32) for i in idx]),
                                     device=self.device)
                cs = torch.as_tensor([int(cliques[i]) for i in idx], device=self.device)
                mus, vars_ = self.core.predict_cliques(self.samples, self.caches, self.data, Xq, cs)
                mu = mus.mean(0)
                var = torch.clamp((vars_ + mus ** 2).mean(0) - mu ** 2, min=1e-10)
                mu, var = mu.cpu().numpy() * ys, var.cpu().numpy() * ys ** 2
                for k, i in enumerate(idx):
                    out_mu[i], out_var[i] = mu[k], var[k]
        return out_mu, out_var

    def predict_clique(self, Xs: np.ndarray, c: int):
        """Per-clique posterior (mu, var), each (P, 1), at opt-frame
        candidates Xs, raw-y frame (rd_gp.py:270-305)."""
        mu, var = self.predict_cliques([Xs], [c])
        return mu[0], var[0]
