"""Gradient-boosted oblivious trees with uncertainty (port of
``hebo_tpu/models/boosting.py``; ids ``gbdt`` and ``catboost``).

Both a mean and a log-variance head are boosted on the Gaussian NLL with
Fisher-diagonal Newton leaves, and the predictive variance is the virtual
ensembles' knowledge uncertainty (variance of the mean head over truncated
stage sums) plus the data uncertainty (mean predicted noise variance).

``_fit_forest`` runs the rounds × levels loop on the device with no host
read: per level, the four histograms (mean and log-variance heads ×
gradient and Hessian, per leaf, feature and bin) are one matrix product of
the leaf one-hot times a stacked (N, 4) statistic against the code one-hot,
then cumulative sums over bins, the two-head gain, the forbidden last bin
and one flat argmax pick the (feature, bin) split.  Newton leaf values get
Langevin noise √lr·ε/√(H + λ).  The per-round row bag (R, N) and ε
(R, 2^T, 2) are drawn up front from the model's generator, or fed.
``_predict_forest`` is the staged cumulative sum and the virtual-ensemble
gather.  The host binning (``_feature_spec``, ``_bin_fit``, ``_bin_apply``)
is a numpy copy of the JAX package's; ``_bin_apply_t`` is the device
binning, equal to ``np.searchsorted(side="right")``.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.dtypes import pad_bucket
from .base import BaseModel, register_model

__all__ = ["GBDT", "Forest", "fit_forest", "predict_forest"]


class Forest(NamedTuple):
    feats: torch.Tensor  # (R, T) int64 split feature per level
    bins: torch.Tensor  # (R, T) int64 split bin per level (go right if code > bin)
    leaf_w: torch.Tensor  # (R, 2**T, 2) leaf deltas (mean, log-var heads)


def gauss_grads(pred: torch.Tensor, y: torch.Tensor):
    """Gradients of the Gaussian NLL in (μ, s = log σ²) and their Fisher
    Hessians, each (N, 2)."""
    mu, s = pred[:, 0], torch.clamp(pred[:, 1], -10.0, 10.0)
    inv_var = torch.exp(-s)
    r = mu - y
    g = torch.stack([r * inv_var, 0.5 * (1.0 - r * r * inv_var)], 1)
    return g, torch.stack([inv_var, torch.full_like(s, 0.5)], 1)


def fit_forest(codes: torch.Tensor, y: torch.Tensor, mask: torch.Tensor, n_rounds: int,
               depth: int, n_bins: int, lr: float = 0.2, lam: float = 1.0,
               subsample: float = 0.8, generator: Optional[torch.Generator] = None,
               bags: Optional[torch.Tensor] = None, eps: Optional[torch.Tensor] = None,
               splits: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               trace: Optional[List[torch.Tensor]] = None) -> Forest:
    """Boost ``n_rounds`` oblivious trees of ``depth`` levels on codes
    (N, F) in [0, n_bins), standardized y (N,) and the valid rows ``mask``.

    ``bags`` (R, N) bool and ``eps`` (R, 2^T, 2) feed the round's row bag
    and leaf noise; ``splits`` = (feats, bins) forces every level's split
    (the tests grow the JAX package's tree structure); ``trace`` collects
    each level's (F, B) split score."""
    N, Fn = codes.shape
    L, dev = 2 ** depth, codes.device
    f32 = dict(dtype=torch.float32, device=dev)
    if bags is None:
        bags = torch.rand((n_rounds, N), generator=generator, **f32) < subsample
    if eps is None:
        eps = torch.randn((n_rounds, L, 2), generator=generator, **f32)
    codes = codes.long()
    code_oh = (codes[:, :, None] == torch.arange(n_bins, device=dev)).to(torch.float32)
    code_oh = code_oh.reshape(N, Fn * n_bins)
    levels = torch.arange(L, device=dev)
    weight = mask.to(torch.float32)[None] * bags.to(torch.float32)  # (R, N)
    pred = torch.zeros((N, 2), **f32)
    feats = torch.zeros((n_rounds, depth), dtype=torch.long, device=dev)
    bins = torch.zeros((n_rounds, depth), dtype=torch.long, device=dev)
    leaf_w = torch.zeros((n_rounds, L, 2), **f32)
    for r in range(n_rounds):
        g, h = gauss_grads(pred, y)
        g, h = g * weight[r, :, None], h * weight[r, :, None]
        stat = torch.cat([g, h], 1)  # (N, 4): g_μ, g_s, h_μ, h_s
        leaf = torch.zeros((N,), dtype=torch.long, device=dev)
        for t in range(depth):
            leaf_oh = (leaf[:, None] == levels).to(torch.float32)  # (N, L)
            lhs = (stat[:, :, None] * leaf_oh[:, None, :]).reshape(N, 4 * L)
            hist = (lhs.T @ code_oh).reshape(4, L, Fn, n_bins)
            cum = torch.cumsum(hist, -1)
            GL, HL = cum[:2], cum[2:]
            GT, HT = cum[:2, ..., -1:], cum[2:, ..., -1:]
            gain = GL ** 2 / (HL + lam) + (GT - GL) ** 2 / ((HT - HL) + lam)
            score = (gain[0] + gain[1]).sum(0)  # (F, B), summed over leaves
            # last bin = degenerate split (everything left); forbid it
            score[:, -1] = -math.inf
            if trace is not None:
                trace.append(score)
            if splits is None:
                flat = torch.argmax(score.reshape(-1))
                f_star, b_star = flat // n_bins, flat % n_bins
            else:
                f_star, b_star = splits[0][r, t].long(), splits[1][r, t].long()
            go_right = codes.gather(1, f_star.reshape(1, 1).expand(N, 1))[:, 0] > b_star
            leaf = leaf * 2 + go_right.long()
            feats[r, t] = f_star
            bins[r, t] = b_star
        leaf_oh = (leaf[:, None] == levels).to(torch.float32)
        Gl, Hl = leaf_oh.T @ g, leaf_oh.T @ h  # (L, 2)
        w = -Gl / (Hl + lam) + math.sqrt(lr) * eps[r] / torch.sqrt(Hl + lam)
        pred = pred + lr * w[leaf]
        leaf_w[r] = lr * w
    return Forest(feats=feats, bins=bins, leaf_w=leaf_w)


def predict_forest(forest: Forest, codes: torch.Tensor, n_virtual: int):
    """Staged predictions → (mean, total variance) in the standardized
    frame: the stage sums truncated at ``n_virtual`` evenly spaced stages of
    the second half of the rounds; knowledge uncertainty = variance of the
    mean head over them, data uncertainty = mean of exp(log-var head)."""
    R, T = forest.feats.shape
    P = codes.shape[0]
    c = codes.long()[:, forest.feats.reshape(-1)].reshape(P, R, T)
    bits = (c > forest.bins[None]).long()  # (P, R, T)
    pows = 2 ** torch.arange(T - 1, -1, -1, device=codes.device)
    leaf = (bits * pows).sum(-1)  # (P, R)
    contrib = forest.leaf_w[torch.arange(R, device=codes.device)[None, :], leaf]  # (P, R, 2)
    staged = torch.cumsum(contrib, 1)
    ks = np.clip(R // 2 + ((np.arange(n_virtual) + 1) * (R - R // 2)) // n_virtual - 1, 0, R - 1)
    sub = staged[:, torch.as_tensor(ks, device=codes.device)]  # (P, K, 2)
    # averaging sub-ensemble means integrates out the Langevin leaf noise
    mu = sub[:, :, 0].mean(1)
    knowledge = sub[:, :, 0].var(1, unbiased=False)
    data = torch.exp(torch.clamp(sub[:, :, 1], -10.0, 10.0)).mean(1)
    return mu, knowledge + data


@register_model("gbdt")
@register_model("catboost")
class GBDT(BaseModel):
    """Oblivious-tree gradient boosting with RMSEWithUncertainty semantics."""

    support_ts = False
    support_grad = False
    support_warm_start = False

    def __init__(self, space, num_out: int = 1, device="cuda", **conf):
        super().__init__(space, num_out=num_out, **conf)
        assert num_out == 1, "GBDT is single-output; use multi_task wrapper"
        self.device = resolve_device(device)
        self.n_rounds = int(conf.get("num_epochs", 100))
        self.num_ensembles = int(conf.get("num_ensembles", 10))
        if self.n_rounds < 2 * self.num_ensembles:
            # reference guard: iterations >= 2 * num_ensembles (catboost.py:29-30)
            self.n_rounds = 2 * self.num_ensembles
        self.lr = float(conf.get("lr", 0.2))
        self.depth = int(conf.get("depth", 4))
        self.n_bins = int(conf.get("n_bins", 32))
        self.lam = float(conf.get("lam", 1.0))
        self._edges: Optional[list] = None
        self.forest: Optional[Forest] = None

    # ------------------------------------------------------- host binning
    def _feature_spec(self):
        """Expanded feature list: numeric cols pass through (quantile bins);
        categorical cols one-hot into per-category binary features."""
        spec = []
        for d in range(self.space.num_cols):
            if d in self.space.cat_dims:
                for c in range(int(self.space.num_categories[d])):
                    spec.append(("cat", d, c))
            else:
                spec.append(("num", d, -1))
        return spec

    def _bin_fit(self, X: np.ndarray):
        spec = self._feature_spec()
        edges = []
        for kind, d, _c in spec:
            if kind == "num":
                qs = np.quantile(X[:, d], np.linspace(0, 1, self.n_bins + 1)[1:-1])
                edges.append(np.unique(qs).astype(np.float32))
            else:
                edges.append(np.asarray([0.5], np.float32))
        self._edges = edges

    def _bin_apply(self, X: np.ndarray) -> np.ndarray:
        spec = self._feature_spec()
        cols = []
        for (kind, d, c), e in zip(spec, self._edges):
            v = (X[:, d] == c).astype(np.float32) if kind == "cat" else X[:, d]
            cols.append(np.searchsorted(e, v, side="right"))
        return np.stack(cols, 1).astype(np.int32)

    def _device_binning(self):
        """Index tensors and the padded edge matrix for the device binning."""
        spec = self._feature_spec()
        src = np.asarray([d for _k, d, _c in spec], np.int64)
        is_cat = np.asarray([k == "cat" for k, _d, _c in spec], bool)
        cat_val = np.asarray([max(c, 0) for _k, _d, c in spec], np.float32)
        E = max(len(e) for e in self._edges)
        edges = np.full((len(spec), E), np.inf, np.float32)
        for i, e in enumerate(self._edges):
            edges[i, : len(e)] = e
        return tuple(torch.as_tensor(a, device=self.device) for a in (src, is_cat, cat_val, edges))

    @staticmethod
    def _bin_apply_t(Xs, src, is_cat, cat_val, edges) -> torch.Tensor:
        """(P, D) opt-frame → (P, F) codes, Σ(v ≥ e) = ``searchsorted(e, v, 'right')``."""
        v_raw = Xs.index_select(1, src)  # (P, F)
        v = torch.where(is_cat[None, :], (v_raw == cat_val[None, :]).to(Xs.dtype), v_raw)
        return (v[:, :, None] >= edges[None, :, :]).sum(-1)

    # --------------------------------------------------------------- api
    def fit(self, X, y, draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """``draws`` = (bags (R, N_pad) bool, ε (R, 2^T, 2)) feeds the
        rounds' random numbers; otherwise they come from a generator seeded
        by ``random_seed`` (42) plus the number of valid rows."""
        X = np.asarray(X, np.float32)
        y = np.asarray(y, np.float32).reshape(len(X), -1)[:, 0]
        ok = np.isfinite(y) & np.all(np.isfinite(X), axis=1)
        X, y = X[ok], y[ok]
        self._y_mean = float(np.mean(y)) if len(y) else 0.0
        ystd = float(np.std(y)) if len(y) else 1.0
        self._y_std = ystd if ystd > 1e-8 else 1.0
        self._bin_fit(X)
        codes = self._bin_apply(X)
        n_pad = pad_bucket(max(len(X), 2))
        cp = np.zeros((n_pad, codes.shape[1]), np.int32)
        yp = np.zeros((n_pad,), np.float32)
        mk = np.zeros((n_pad,), bool)
        cp[: len(X)] = codes
        yp[: len(X)] = (y - self._y_mean) / self._y_std
        mk[: len(X)] = True
        seed = int(self.conf.get("random_seed", 42)) + len(X)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        bags, eps = (None, None) if draws is None else (
            torch.as_tensor(d, device=self.device) for d in draws)
        dev = self.device
        self.forest = fit_forest(
            torch.as_tensor(cp, device=dev), torch.as_tensor(yp, device=dev),
            torch.as_tensor(mk, device=dev), n_rounds=self.n_rounds, depth=self.depth,
            n_bins=self.n_bins, lr=self.lr, lam=self.lam,
            subsample=float(self.conf.get("subsample", 0.8)), generator=gen, bags=bags, eps=eps)
        return self

    def predict(self, X):
        assert self.forest is not None, "fit first"
        X = np.asarray(X, np.float32)
        p = len(X)
        codes = self._bin_apply(X)
        cp = np.zeros((pad_bucket(max(p, 2)), codes.shape[1]), np.int32)
        cp[:p] = codes
        mu, var = predict_forest(self.forest, torch.as_tensor(cp, device=self.device),
                                 self.num_ensembles)
        mu = mu[:p].cpu().numpy().reshape(-1, 1) * self._y_std + self._y_mean
        var = var[:p].cpu().numpy().reshape(-1, 1) * self._y_std ** 2
        return mu, np.maximum(var, 1e-12)

    # ------------------------------ pure-state protocol (device prediction)
    @property
    def state(self):
        assert self.forest is not None, "fit first"
        f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=self.device)  # noqa: E731
        return (self.forest, *self._device_binning(), f32(self._y_mean), f32(self._y_std))

    def predict_pure(self, state, Xs):
        forest, src, is_cat, cat_val, edges, y_mean, y_std = state
        codes = self._bin_apply_t(Xs, src, is_cat, cat_val, edges)
        mu, var = predict_forest(forest, codes, self.num_ensembles)
        return mu[:, None] * y_std + y_mean, torch.clamp(var[:, None], min=1e-12) * y_std ** 2

    @property
    def noise(self):
        return np.zeros(1)
