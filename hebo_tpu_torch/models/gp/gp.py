"""Exact GP surrogate — HEBO's model (port of ``hebo_tpu/models/gp/gp.py``).

ARD Matérn-3/2 (or Matérn-1/2, -5/2, RBF, the arc-sine MLP kernel:
``kernel=``) over the min-max scaled numerics × learned categorical
embeddings, Gamma(0.5, 0.5) prior on the outputscale, LogNormal prior on
the noise with a noise floor, y standardization, median-distance
lengthscale init, and pSGLD (default), Adam or slice-sampled
hyperparameters with the jitter-ladder NLL.  Options: the Kumaraswamy input
warp of the numerics (``input_warp``, gp.py:221-227) and heteroscedastic
noise σ²(x) = exp(log_noise + 2·tanh(w·φ(x) + b)) (``heteroscedastic``,
gp.py:333-345, the ``noise_w`` leaf).  ``GP(inference=...)`` puts a
posterior over the hyperparameters after the MAP fit: HMC, SVI or SMC
(``inference.py``), each log-density evaluation one batched NLL over the
chains, draws or particles.  ``gpy_wgp`` (input warp, 4 restarts) and
``gpy_mlp`` (the MLP kernel) are GPs with other defaults.

The JAX package's ``vmap`` over restarts and ensemble samples is a leading
batch axis here: every ``GPParams`` leaf carries it, and every ``GPCore``
method works on the whole batch.  The optimizer ``scan`` is a Python loop.
Random numbers come from a ``torch.Generator`` on the device, or are passed
in (``init_params(draws=...)``, ``fit_from_batched(noise=...)``) so that a
test can feed the JAX package's own draws.

Categorical columns take one of seven ``cat_kernel`` modes (gp.py:136-181):
``embedding`` (learned embeddings inside the Matérn, HEBO's default),
``hed`` (the Hamming similarity to ``hed_num_anchors`` fixed random anchors
as extra Matérn features, BODi), the purely pairwise ``overlap``,
``transformed_overlap``, ``diffusion`` (COMBO) and ``ssk`` (string
subsequence kernel, AntBO/BOSS), whose Gram multiplies the Matérn part of
the numerics, and ``conditional_to`` (hierarchical spaces: each category
group's Gram is the stationary kernel over its own numeric dims, inside a
transformed overlap; ``cond_groups``, ``cond_cat_to_group``).  Their
parameters trail ``log_ls`` (θ per column for transformed overlap and
conditional_to, the decays β per column for diffusion, logits of the match
and gap decays for SSK).

On CUDA the Matérn-3/2 Gram goes through kernel K2 (``ops/gram.py``), the
SSK Gram through kernel K3 (``ops/ssk.py``) and every factorization through
kernel K1 (``ops/chol_kernel.py``).

Above ``max_cholesky_size`` (2048) the posterior keeps all the data through
pivoted-Cholesky-preconditioned block CG (``ops/cg.py``, gp.py:713-733 and
:773-785), and ``GP.fit`` infers the hyperparameters on a subsample of
``max_cholesky_size`` points (gp.py:1076-1103).  The CG cache holds the
train system ``Kt`` and the Woodbury factor, made once per fitted state,
so an acquisition evaluation runs one Gram (N, P) and one PCG.

``GP(mesh=...)`` (a 1-D device mesh, ``parallel/sharded.make_mesh``)
takes the block-sharded route there instead (gp.py:194-205, :673-705):
the posterior is the row-slab Cholesky over the ranks
(``ops/block_chol.block_ladder_factor``: K1 per diagonal block, the
2-rung ladder), gathered on every rank with W = L⁻¹, so predictions stay
the dense path's products; and ``inference="hmc"`` / ``"smc"`` shard the
chains / particles over the ranks (gp.py:977-1040), with ``n_chains`` and
``n_particles`` rounded up to a multiple of the mesh size.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ...ops.block_chol import block_ladder_factor
from ...ops.cg import pcg_solve, pivoted_cholesky, woodbury_factor, woodbury_precond_apply
from ...ops.chol import LADDER, batched_ladder_factor, make_masked_nll_batched
from ...ops.gram import matern32_gram
from ...ops.ssk import ssk_gram
from ...utils.device import resolve_device
from ...utils.dtypes import pad_bucket
from ..base import BaseModel, register_model
from ...parallel.sharded import mesh_size
from .inference import (hmc_sample, hmc_sample_sharded, slice_sample, smc_sample,
                        smc_sample_sharded, svi_fit)
from .tree import adam_step, tree_leaves, tree_map, tree_unflatten
from .kernels import (MATERN_FNS, conditional_transformed_overlap, diffusion_kernel,
                      embed_categorical, hed_embed, overlap, sq_dist, transformed_overlap)

__all__ = ["GPParams", "GPData", "GPCache", "GPCore", "GP", "WarpedGP", "MLPKernelGP",
           "make_data", "map_fit"]


class GPParams(NamedTuple):
    """Hyperparameters; every leaf has a leading batch axis (restarts or
    ensemble samples).  Field order is the JAX pytree's leaf order."""

    log_ls: torch.Tensor  # (B, D_feat): feature lengthscales ++ cat-kernel params
    log_sc: torch.Tensor  # (B,)
    log_noise: torch.Tensor  # (B,)
    mean: torch.Tensor  # (B,)
    emb: torch.Tensor  # (B, total_cats, E), or (B, 0, 0) without categoricals
    log_wa: torch.Tensor  # (B, D_num) Kumaraswamy warp a (log), used with input_warp
    log_wb: torch.Tensor  # (B, D_num) Kumaraswamy warp b (log)
    # (B, n_feat_dims + 1) heteroscedastic noise weights and bias; None
    # otherwise, and then no leaf (JAX's pytree flattening skips None)
    noise_w: Optional[torch.Tensor] = None


class GPData(NamedTuple):
    """Padded, scaled training data on the device."""

    X: torch.Tensor  # (Nmax, D) opt frame
    y: torch.Tensor  # (Nmax, 1) standardized
    mask: torch.Tensor  # (Nmax,) bool
    x_lb: torch.Tensor  # (D_num,)
    x_span: torch.Tensor  # (D_num,)
    y_mean: torch.Tensor  # ()
    y_std: torch.Tensor  # ()


class GPCache(NamedTuple):
    """Posterior caches per ensemble sample: L, α and W = L⁻¹; on the CG
    route L is the (N, k) pivoted-Cholesky preconditioner factor, with the
    train system, the Woodbury factor and the solve's relative residual."""

    L: torch.Tensor  # (S, Nmax, Nmax), or (S, Nmax, cg_rank) on the CG route
    alpha: torch.Tensor  # (S, Nmax, 1)
    ok: torch.Tensor  # (S,) bool
    Wf: Optional[torch.Tensor] = None  # (S, Nmax, Nmax)
    Kt: Optional[torch.Tensor] = None  # (S, Nmax, Nmax) CG: the train system
    Q: Optional[torch.Tensor] = None  # (S, Nmax, cg_rank) CG: the Woodbury factor
    res: Optional[torch.Tensor] = None  # (S,) CG: relative residual of α


_CAT_KERNELS = ("embedding", "overlap", "transformed_overlap", "diffusion", "hed", "ssk",
                "conditional_to")
_OPTIMIZERS = ("psgld", "adam", "slice")


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: maximum then minimum, whose gradients at a tie are
    halved as JAX's."""
    full = lambda v: torch.full((), v, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, full(lo)), full(hi))


class GPCore:
    """Static configuration + batched functions of the GP."""

    def __init__(
        self,
        numeric_dims: Tuple[int, ...],
        cat_dims: Tuple[int, ...],
        num_categories: Tuple[int, ...],
        kernel: str = "matern32",
        cat_kernel: str = "embedding",
        noise_lb: float = 8.9e-5,
        emb_dim: Optional[int] = None,
        hed_num_anchors: int = 16,
        ssk_max_subseq: int = 3,
        optimizer: str = "psgld",
        n_steps: int = 100,
        lr: float = 0.05,
        psgld_burnin_frac: float = 0.5,
        n_ensemble: int = 1,
        input_warp: bool = False,
        heteroscedastic: bool = False,
        max_cholesky_size: int = 2048,
        cg_rank: int = 128,
        cg_iters: int = 96,
        cond_groups=None,
        cond_cat_to_group=None,
    ):
        if kernel not in MATERN_FNS:
            raise ValueError(f"unknown kernel {kernel!r}; known: {sorted(MATERN_FNS)}")
        if cat_dims and cat_kernel not in _CAT_KERNELS:
            raise ValueError(f"unknown cat_kernel {cat_kernel!r}; known: {', '.join(_CAT_KERNELS)}")
        if optimizer not in _OPTIMIZERS:
            raise ValueError(f"unknown optimizer {optimizer!r}; known: {', '.join(_OPTIMIZERS)}")
        self.numeric_dims = tuple(numeric_dims)
        self.cat_dims = tuple(cat_dims)
        self.num_categories = tuple(num_categories)
        self.kernel_name = kernel
        self.kfn = MATERN_FNS[kernel]
        self.input_warp = bool(input_warp)
        self.heteroscedastic = bool(heteroscedastic)
        self.noise_lb = noise_lb
        self.optimizer = optimizer
        self.n_steps = n_steps
        self.lr = lr
        self.psgld_burnin_frac = psgld_burnin_frac
        self.n_ensemble = max(1, n_ensemble)
        maxc = max(self.num_categories) if self.num_categories else 0
        self.emb_dim = emb_dim if emb_dim is not None else min(50, 1 + maxc // 2)
        self.total_cats = sum(self.num_categories)
        self._cat_offsets = np.cumsum((0,) + self.num_categories[:-1]).astype(np.int64)
        self.d_num = len(self.numeric_dims)
        self.cat_kernel = cat_kernel if self.cat_dims else "embedding"
        C = len(self.cat_dims)
        n_cat_feat = {"embedding": C * self.emb_dim,
                      "hed": int(hed_num_anchors)}.get(self.cat_kernel, 0)
        # trailing cat-kernel parameters of log_ls: θ or β per column, or SSK's two decays
        self.n_cat_param = {"transformed_overlap": C, "diffusion": C, "conditional_to": C,
                            "ssk": 2}.get(self.cat_kernel, 0)
        self.hed_anchors = None
        if self.cat_kernel == "hed":
            # the JAX package's anchors (gp.py:146-149): the same numpy draws
            rng = np.random.default_rng(7)
            self.hed_anchors = np.stack(
                [rng.integers(0, np.asarray(self.num_categories)) for _ in range(int(hed_num_anchors))]
            ).astype(np.float32)  # (m, C)
        # conditional_to: groups of positions into numeric_dims, and each
        # category's group (-1: no hyperparameters)
        self.cond_groups = tuple(tuple(int(i) for i in g) for g in (cond_groups or ()))
        self.cond_cat_to_group = tuple(int(g) for g in (cond_cat_to_group or ()))
        self.ssk_max_subseq = int(ssk_max_subseq)
        self.n_feat_dims = self.d_num + n_cat_feat
        self.d_feat = self.n_feat_dims + self.n_cat_param
        # above max_cholesky_size: pivoted-Cholesky-preconditioned CG
        self.max_cholesky_size = int(max_cholesky_size)
        self.cg_rank = int(cg_rank)
        self.cg_iters = int(cg_iters)
        # a device mesh (GP(mesh=...)): above max_cholesky_size the
        # block-sharded route takes the CG route's place
        self.mesh = None
        self._index = {}

    def _use_cg(self, n: int) -> bool:
        return n > self.max_cholesky_size and self.mesh is None

    def _use_block_sharded(self, n: int) -> bool:
        return n > self.max_cholesky_size and self.mesh is not None

    def _columns(self, device: torch.device):
        """(numeric column indices, categorical column indices, embedding
        offsets) as tensors on ``device``, made once per device: indexing
        with a Python list copies it to the device at every call, which a
        captured CUDA graph cannot hold."""
        key = str(device)
        cols = self._index.get(key)
        if cols is None:
            as_t = lambda v: torch.as_tensor(np.asarray(v, np.int64), device=device)
            cols = (as_t(self.numeric_dims), as_t(self.cat_dims), as_t(self._cat_offsets))
            self._index[key] = cols
        return cols

    def _const(self, name: str, device: torch.device, make):
        """A constant tensor ``make(device)`` made once per device (the HED
        anchors, the cardinalities, the conditional groups), for the same
        reason as ``_columns``."""
        key = (name, str(device))
        t = self._index.get(key)
        if t is None:
            t = self._index[key] = make(device)
        return t

    # ------------------------------------------------------------- features
    def features(self, params: GPParams, X: torch.Tensor, data: GPData) -> torch.Tensor:
        """(B, N, n_feat_dims): scaled numerics in [-1, 1] (through the
        Kumaraswamy CDF u → 1 − (1 − uᵃ)ᵇ with ``input_warp``) ++
        embeddings; zero-width for a purely pairwise categorical kernel."""
        B = params.log_sc.shape[0]
        num_idx, cat_idx, offs = self._columns(X.device)
        parts = []
        if self.d_num:
            xn = X.index_select(1, num_idx)
            u = _clip((xn - data.x_lb) / data.x_span, 0.0, 1.0).expand(B, -1, -1)
            if self.input_warp:
                a = torch.exp(params.log_wa)[:, None, :]
                b = torch.exp(params.log_wb)[:, None, :]
                ua = torch.pow(_clip(u, 1e-6, 1.0 - 1e-6), a)
                u = 1.0 - torch.pow(_clip(1.0 - ua, 1e-6, 1.0), b)
            parts.append(2.0 * u - 1.0)
        if self.cat_dims and self.cat_kernel == "embedding":
            parts.append(embed_categorical(X.index_select(1, cat_idx), params.emb, offs))
        elif self.cat_dims and self.cat_kernel == "hed":
            anchors = self._const("hed", X.device, lambda d: torch.as_tensor(self.hed_anchors, device=d))
            parts.append(hed_embed(X.index_select(1, cat_idx), anchors).expand(B, -1, -1))
        if not parts:
            return X.new_zeros((B, X.shape[0], 0))
        return torch.cat(parts, -1)

    def cat_gram(self, params: GPParams, X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
        """(B or 1, N, M) pairwise categorical kernel (gp.py:298-327)."""
        cat_idx = self._columns(X1.device)[1]
        c1 = X1.index_select(1, cat_idx)
        c2 = X2.index_select(1, cat_idx)
        cat_p = params.log_ls[:, self.n_feat_dims:]
        if self.cat_kernel == "overlap":
            return overlap(c1, c2)[None]
        if self.cat_kernel == "transformed_overlap":
            return transformed_overlap(c1, c2, torch.exp(cat_p))
        if self.cat_kernel == "diffusion":
            ncat = self._const("ncat", X1.device, lambda d: torch.as_tensor(
                self.num_categories, dtype=torch.float32, device=d))
            return diffusion_kernel(c1, c2, torch.exp(cat_p), ncat)
        return ssk_gram(c1, c2, torch.sigmoid(cat_p[:, 0]), torch.sigmoid(cat_p[:, 1]),
                        self.ssk_max_subseq)

    def gram(self, params: GPParams, f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
        """(B, N, M) outputscale × the stationary kernel over feature-space
        points f1 (B, N, F), f2 (B, M, F) (gp.py:248-252; SVGP's inducing
        path); Matérn-3/2 through kernel K2, whose VJP carries the gradient
        in f1, f2 and ℓ on CUDA."""
        ls = torch.exp(params.log_ls[:, : self.n_feat_dims])
        return self._stationary(f1, f2, ls, torch.exp(params.log_sc))

    def _stationary(self, f1: torch.Tensor, f2: torch.Tensor, ls: torch.Tensor,
                    sc: torch.Tensor) -> torch.Tensor:
        """(B, N, M) sc × the stationary kernel over features (B, N, F),
        (B, M, F) with lengthscales (B, F); Matérn-3/2 through kernel K2."""
        if self.kernel_name == "matern32":
            l3 = ls[:, None, :]
            return matern32_gram((f1 / l3).contiguous(), (f2 / l3).contiguous(), sc.contiguous())
        return sc[:, None, None] * self.kfn(f1, f2, ls)

    def gram_points(self, params: GPParams, X1: torch.Tensor, X2: torch.Tensor,
                    data: GPData) -> torch.Tensor:
        """(B, N, M) outputscale × the stationary kernel over the features
        (Matérn-3/2: kernel K2) × the pairwise categorical kernel, where
        there is one; for ``conditional_to`` the outputscale × the
        conditional transformed overlap of the groups' Grams
        (gp.py:270-309)."""
        sc = torch.exp(params.log_sc)
        if self.cat_kernel == "conditional_to":
            return sc[:, None, None] * self._conditional_gram(params, X1, X2, data)
        if self.n_feat_dims:
            ls = torch.exp(params.log_ls[:, : self.n_feat_dims])
            K = self._stationary(self.features(params, X1, data), self.features(params, X2, data),
                                 ls, sc)
        else:
            K = sc[:, None, None]
        if self.cat_kernel not in ("embedding", "hed"):
            K = K * self.cat_gram(params, X1, X2)
        return K

    def _conditional_gram(self, params: GPParams, X1: torch.Tensor, X2: torch.Tensor,
                          data: GPData) -> torch.Tensor:
        """(B, N, M) conditional transformed overlap: each group's Gram is
        the unit-scale stationary kernel over its numeric dims (K2 for
        Matérn-3/2); without groups, ones."""
        f1, f2 = self.features(params, X1, data), self.features(params, X2, data)
        ls = torch.exp(params.log_ls[:, : self.n_feat_dims])
        B = ls.shape[0]
        ones = ls.new_ones((B,))
        grams = []
        for k, dims in enumerate(self.cond_groups):
            d = self._const(f"cond{k}", X1.device, lambda dv, dims=dims: torch.as_tensor(
                dims, dtype=torch.int64, device=dv))
            grams.append(self._stationary(f1.index_select(-1, d), f2.index_select(-1, d),
                                          ls.index_select(-1, d), ones))
        if not grams:
            grams = [f1.new_ones((B, X1.shape[0], X2.shape[0]))]
        cat_idx = self._columns(X1.device)[1]
        c2g = self._const("c2g", X1.device, lambda dv: torch.as_tensor(
            self.cond_cat_to_group, dtype=torch.int64, device=dv))
        lam = torch.exp(params.log_ls[:, self.n_feat_dims:])
        return conditional_transformed_overlap(X1.index_select(1, cat_idx), X2.index_select(1, cat_idx),
                                               torch.stack(grams, 1), c2g, lam)

    def noise_base(self, params: GPParams) -> torch.Tensor:
        """(B,) the homoscedastic noise variance; the CG routes'
        preconditioner keeps it with heteroscedastic noise too, as the JAX
        package does (gp.py:719, :779, :832)."""
        return torch.exp(params.log_noise) + self.noise_lb

    def noise_diag(self, params: GPParams, X: torch.Tensor, data: GPData) -> torch.Tensor:
        """(B, N) observation-noise variance at the points X: the base, or
        with ``heteroscedastic`` exp(log_noise + 2·tanh(w·φ(x) + b)) + the
        floor (gp.py:333-345)."""
        if not self.heteroscedastic or params.noise_w is None:
            return self.noise_base(params)[:, None].expand(-1, X.shape[0])
        f = self.features(params, X, data)
        w = params.noise_w
        mod = torch.tanh((f @ w[:, :-1, None])[..., 0] + w[:, -1:])
        return torch.exp(params.log_noise[:, None] + 2.0 * mod) + self.noise_lb

    def _train_system(self, params: GPParams, data: GPData):
        """(Kt, r): masked train Gram + noise with identity padded rows, and
        the centred residual."""
        K = self.gram_points(params, data.X, data.X, data)
        n = K.shape[-1]
        eye = torch.eye(n, dtype=K.dtype, device=K.device)
        m = data.mask.to(K.dtype)
        m2 = m[:, None] * m[None, :]
        noise = self.noise_diag(params, data.X, data)
        Kt = m2 * (K + noise[:, :, None] * eye) + eye * (1.0 - m)
        r = (data.y - params.mean[:, None, None]) * m[:, None]
        return Kt, r

    # ------------------------------------------------------------------ nll
    def nll_batched(self, params: GPParams, data: GPData) -> torch.Tensor:
        Kt, r = self._train_system(params, data)
        n_act = data.mask.to(Kt.dtype).sum().expand(Kt.shape[0])
        return make_masked_nll_batched((0.0, 1e-3))(Kt, r, n_act)

    def log_prior(self, params: GPParams) -> torch.Tensor:
        sc = torch.exp(params.log_sc)
        lp = 0.5 * params.log_sc - 0.5 * sc
        lp = lp + (-0.5 * ((params.log_noise - math.log(1e-2)) / 1.0) ** 2)
        lp = lp + (-0.5 * (params.log_ls / 3.0) ** 2).sum(-1) * 0.1
        if params.emb.numel():
            lp = lp - 0.5 * (params.emb ** 2).sum((-2, -1)) / 10.0
        if self.input_warp:
            lp = lp - 0.5 * ((params.log_wa / 0.75) ** 2).sum(-1)
            lp = lp - 0.5 * ((params.log_wb / 0.75) ** 2).sum(-1)
        if self.heteroscedastic and params.noise_w is not None:
            lp = lp - 0.5 * (params.noise_w ** 2).sum(-1)
        return lp

    def loss_batched(self, params: GPParams, data: GPData) -> torch.Tensor:
        return self.nll_batched(params, data) - self.log_prior(params)

    # The JAX package's per-restart ``nll`` (gp.py:348) and ``loss`` (:392),
    # which the sharded suggest programs call: every method here already
    # takes a batch of parameter sets, so they are the batched ones.
    nll = nll_batched
    loss = loss_batched

    # ----------------------------------------------------------------- init
    def init_params(self, data: GPData, n: int, generator: Optional[torch.Generator] = None,
                    draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> GPParams:
        """``n`` stacked initial parameter sets (gp.py:422-463).

        ``draws`` = (emb_normals (n, total_cats, E), ls_normals (n, D_feat))
        replaces the generator's draws."""
        dev = data.X.device
        f32 = dict(dtype=torch.float32, device=dev)
        E = self.emb_dim if self.total_cats else 0
        if draws is None:
            z_emb = torch.randn((n, self.total_cats, E), generator=generator, **f32)
            z_ls = torch.randn((n, self.d_feat), generator=generator, **f32)
        else:
            z_emb, z_ls = (torch.as_tensor(t, **f32) for t in draws)
        p0 = GPParams(
            log_ls=torch.zeros((n, self.d_feat), **f32),
            log_sc=torch.zeros((n,), **f32),
            log_noise=torch.full((n,), math.log(1e-2), **f32),
            mean=torch.zeros((n,), **f32),
            emb=0.5 * z_emb,
            log_wa=torch.zeros((n, self.d_num), **f32),
            log_wb=torch.zeros((n, self.d_num), **f32),
            noise_w=(torch.zeros((n, self.n_feat_dims + 1), **f32)
                     if self.heteroscedastic else None),
        )
        if self.n_feat_dims:
            f = self.features(p0, data.X, data)
            d2 = sq_dist(f, f)
            m2 = data.mask[:, None] & data.mask[None, :]
            d2 = torch.where(m2 & (d2 > 1e-12), d2, torch.full_like(d2, float("nan")))
            # the mean of the two middle values, as jnp.nanmedian
            # (torch.nanmedian returns the lower one)
            med = torch.sqrt(torch.nanquantile(d2.reshape(n, -1), 0.5, dim=1))
            med = torch.where(torch.isfinite(med) & (med > 1e-6), med, torch.ones_like(med))
            log_med = torch.log(med)
        else:
            log_med = torch.zeros((n,), **f32)
        # feature dims: median-distance init; trailing cat-kernel params: 0
        log_ls = torch.cat([log_med[:, None].expand(n, self.n_feat_dims),
                            torch.zeros((n, self.n_cat_param), **f32)], 1)
        return p0._replace(log_ls=log_ls + 0.1 * z_ls)

    # ------------------------------------------------------------------ fit
    def fit_from_batched(
        self, params0: GPParams, data: GPData,
        generator: Optional[torch.Generator] = None,
        noise: Optional[Callable[[int], Sequence[torch.Tensor]]] = None,
        uniforms: Optional[torch.Tensor] = None,
        loop: Optional[Callable] = None,
    ):
        """Run the optimizer on the stacked restarts (gp.py:561-651).

        Returns ``(final_params (R,...), final_loss (R,), samples (S,R,...))``.
        ``noise(step)`` gives pSGLD's standard normals for a step, one tensor
        per ``GPParams`` leaf in leaf order (``noise_w`` only when it is
        there); by default they come from ``generator``.  ``slice`` runs
        ``inference.slice_sample`` on the restarts as one batch (20 burn-in
        sweeps, then every second; the JAX package maps the per-restart
        sampler, gp.py:575-580); ``uniforms`` replaces its draws and
        ``loop`` runs its coordinate steps (``slice_sample``)."""
        n = self.n_steps
        lr = self.lr
        burn = int(n * self.psgld_burnin_frac)
        S = self.n_ensemble
        sample_steps = [burn + (k * max(n - burn, 1)) // S for k in range(S)]
        wrap = lambda ls: tree_unflatten(params0, ls)

        if self.optimizer == "slice":
            with torch.no_grad():
                samples = slice_sample(lambda q: -self.loss_batched(q, data), params0, generator,
                                       n_samples=S, n_burnin=20, thinning=2, uniforms=uniforms,
                                       loop=loop)
                pf = tree_map(lambda t: t[-1], samples)
                return pf, self.loss_batched(pf, data), samples

        p = [t.detach().clone() for t in tree_leaves(params0)]
        # the samples are copied out at their steps, into buffers made here
        # (a captured graph may not keep references to its step tensors)
        samples = [t.new_empty((S,) + t.shape) for t in p]

        def grad(p):
            leaves = [t.detach().requires_grad_(True) for t in p]
            with torch.enable_grad():
                total = self.loss_batched(wrap(leaves), data).sum()
                gs = torch.autograd.grad(total, leaves, allow_unused=True)
            return [
                torch.nan_to_num(torch.clamp(g, -1e3, 1e3)) if g is not None
                else torch.zeros_like(t)
                for g, t in zip(gs, p)
            ]

        if self.optimizer == "adam":
            mu = [torch.zeros_like(t) for t in p]
            nu = [torch.zeros_like(t) for t in p]
            for i in range(n):
                g = grad(p)
                for j in range(len(p)):
                    p[j], mu[j], nu[j] = adam_step(p[j], g[j], mu[j], nu[j], i + 1, lr)
            pf = wrap(p)
            samples = wrap([t.expand((S,) + t.shape) for t in p])
            with torch.no_grad():
                return pf, self.loss_batched(pf, data), samples

        alpha_rms, lam = 0.99, 1e-5
        V = [torch.zeros_like(t) for t in p]
        for i in range(n):
            g = grad(p)
            if noise is not None:
                z = [torch.as_tensor(t, dtype=torch.float32, device=data.X.device)
                     for t in noise(i)]
            else:
                z = [torch.randn(t.shape, generator=generator, dtype=t.dtype,
                                 device=t.device) for t in p]
            inject = 1.0 if i >= burn else 0.0
            for j in range(len(p)):
                V[j] = alpha_rms * V[j] + (1 - alpha_rms) * g[j] ** 2
                G = 1.0 / (lam + torch.sqrt(V[j]))
                step_noise = torch.sqrt(torch.clamp(lr * G, min=0.0)) * z[j]
                p[j] = p[j] - 0.5 * lr * G * g[j] + inject * step_noise
            for k, s in enumerate(sample_steps):
                if s == i:
                    for buf, t in zip(samples, p):
                        buf[k].copy_(t)
        pf = wrap(p)
        samples = wrap(samples)
        with torch.no_grad():
            return pf, self.loss_batched(pf, data), samples

    def fit_from(self, params0: GPParams, data: GPData,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[Callable[[int], Sequence[torch.Tensor]]] = None):
        """The JAX package's per-chain ``fit_from`` (gp.py:466-558) for a
        batch of chains, as one run of ``fit_from_batched``: the optimizer
        updates are elementwise, so each chain follows its own trajectory
        on its own draws, and each NLL factors through K1's ladder on
        CUDA.  Returns (final params (R, ...), final loss (R,), samples
        (S, R, ...))."""
        return self.fit_from_batched(params0, data, generator, noise=noise)

    def prior_diag(self, params: GPParams) -> torch.Tensor:
        """(B,) k(x, x): the outputscale for the normalised stationary
        kernels (gp.py:653-655); subclasses with other kernels override it."""
        return torch.exp(params.log_sc)

    # ------------------------------------------------------------ posterior
    @torch.no_grad()
    def posterior_cache(self, samples: GPParams, data: GPData) -> GPCache:
        """The JAX package's CG cache (gp.py:713-733), over the sample axis:
        L is the rank-``cg_rank`` preconditioner factor, α comes from PCG,
        and ``ok`` holds when α is finite and its relative residual is below
        0.2, since float32 CG stalls near 1e-2 on small-noise systems.  The
        cache keeps the train system Kt and the Woodbury factor Q for the
        predictions."""
        Kt, r = self._train_system(samples, data)
        P = pivoted_cholesky(Kt, self.cg_rank)
        delta = self.noise_base(samples)
        Q = woodbury_factor(P, delta)
        apply = woodbury_precond_apply(P, delta, Q)
        alpha, res = pcg_solve(lambda X: Kt @ X, r, precond_apply=apply,
                               n_iters=self.cg_iters)
        res = res[:, 0]
        ok = torch.isfinite(alpha).all(-1).all(-1) & (res < 0.2)
        return GPCache(L=P, alpha=alpha, ok=ok, Kt=Kt, Q=Q, res=res)

    @torch.no_grad()
    def posterior_cache_batched(self, samples: GPParams, data: GPData) -> GPCache:
        """L, α and W = L⁻¹ per ensemble sample from one batched full-ladder
        factorization (gp.py:734-761); above ``max_cholesky_size`` the CG
        ``posterior_cache``, or with a mesh the block-sharded factor of each
        sample (gp.py:673-705, :746).  Between bucket 2048 and ``max_cholesky_size``
        the JAX package factors each sample densely (gp.py:746), since its
        slab kernel stops at 2048; kernel K1 takes any N, so every bucket up
        to ``max_cholesky_size`` runs the same ladder here."""
        n = data.X.shape[0]
        if self._use_cg(n):
            return self.posterior_cache(samples, data)
        Kt, r = self._train_system(samples, data)
        if self._use_block_sharded(n):
            # one row-slab factorization over the mesh per sample, its
            # 2-rung ladder (gp.py:673-705), L and W gathered on every rank
            L, W, ok = (torch.stack(t) for t in zip(*(block_ladder_factor(K, self.mesh)
                                                      for K in Kt)))
        else:
            L, W, ok = batched_ladder_factor(Kt, LADDER)
        okb = ok[:, None, None]
        eye = torch.eye(n, dtype=Kt.dtype, device=Kt.device)
        Ls = torch.where(okb, L, eye)
        Ws = torch.where(okb, W, torch.zeros_like(W))
        alpha = Ws.transpose(-1, -2) @ (Ws @ r)
        return GPCache(L=Ls, alpha=alpha, ok=ok, Wf=Ws)

    def predict_scaled(self, params: GPParams, cache: GPCache, data: GPData,
                       Xs: torch.Tensor):
        """Per-sample posterior (mu, var), each (S, P, 1), in the
        standardized-y frame (gp.py:763-798)."""
        Ks = self.gram_points(params, data.X, Xs, data)  # (S, N, P)
        Ks = Ks * data.mask.to(Ks.dtype)[:, None]
        mu = params.mean[:, None, None] + Ks.transpose(-1, -2) @ cache.alpha
        kss = self.prior_diag(params)[:, None]
        if self._use_cg(data.X.shape[0]):
            # the explained variance kᵀ Kt⁻¹ k from a block PCG over the P
            # columns; Kt and the Woodbury factor come from the cache
            if cache.Kt is None or cache.Q is None:
                raise ValueError("predict_scaled: a CG cache needs its Kt and Q (posterior_cache)")
            apply = woodbury_precond_apply(cache.L, self.noise_base(params), cache.Q)
            vsol, _ = pcg_solve(lambda X: cache.Kt @ X, Ks, precond_apply=apply,
                                n_iters=self.cg_iters)
            expl = (Ks * vsol).sum(-2)
        else:
            v = cache.Wf @ Ks if cache.Wf is not None else torch.linalg.solve_triangular(
                cache.L, Ks, upper=False)
            expl = (v * v).sum(-2)
        var = torch.clamp(kss - expl, min=1e-10)[..., None]
        okb = cache.ok[:, None, None]
        mu = torch.where(okb, mu, torch.zeros_like(mu))
        var = torch.where(okb, var, torch.ones_like(var))
        return mu, var

    def predict_ensemble(self, samples: GPParams, caches: GPCache, data: GPData,
                         Xs: torch.Tensor):
        """Moment-matched mixture over the sample axis → (P, 1), (P, 1)."""
        mus, vars_ = self.predict_scaled(samples, caches, data, Xs)
        mu = mus.mean(0)
        var = (vars_ + mus ** 2).mean(0) - mu ** 2
        return mu, torch.clamp(var, min=1e-10)

    @torch.no_grad()
    def joint_sample_scaled(self, params: GPParams, cache: GPCache, data: GPData,
                            Xs: torch.Tensor, n_samples: int,
                            generator: Optional[torch.Generator] = None,
                            z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Joint posterior draws at Xs (P, D) for Thompson sampling
        (gp.py:811-844), from one sample (``params``' and ``cache``'s
        leading axis 1): (n_samples, P) in the standardized-y frame.  The
        explained covariance is (W Ks)ᵀ(W Ks) with the cached W = L⁻¹, or a
        block PCG on the CG route; the P×P covariance is factored by K1's
        ladder at base jitter 1e-5 (``safe_cholesky(cov, base_jitter=1e-5)``
        in the JAX package).  ``z`` (n_samples, P) replaces the generator's
        normals."""
        Ks = self.gram_points(params, data.X, Xs, data)
        Ks = Ks * data.mask.to(Ks.dtype)[:, None]
        Kss = self.gram_points(params, Xs, Xs, data)
        mu = (params.mean[:, None, None] + Ks.transpose(-1, -2) @ cache.alpha)[0, :, 0]
        if self._use_cg(data.X.shape[0]):
            if cache.Kt is None or cache.Q is None:
                raise ValueError("joint_sample_scaled: a CG cache needs its Kt and Q")
            apply = woodbury_precond_apply(cache.L, self.noise_base(params), cache.Q)
            vsol, _ = pcg_solve(lambda X: cache.Kt @ X, Ks, precond_apply=apply,
                                n_iters=self.cg_iters)
            cov = Kss - Ks.transpose(-1, -2) @ vsol
        else:
            if cache.Wf is None:
                raise ValueError("joint_sample_scaled: a dense cache needs its Wf = L⁻¹")
            v = cache.Wf @ Ks
            cov = Kss - v.transpose(-1, -2) @ v
        Lc, _, _ = batched_ladder_factor(cov, LADDER, base_jitter=1e-5)
        if z is None:
            z = torch.randn((n_samples, Xs.shape[0]), generator=generator, dtype=mu.dtype,
                            device=mu.device)
        return mu[None, :] + torch.as_tensor(z, device=mu.device) @ Lc[0].transpose(0, 1)


def select(params: GPParams, idx: torch.Tensor, dim: int = 0) -> GPParams:
    """Leaf-wise ``t.index_select(dim, idx).squeeze(dim)`` (no host sync)."""
    return tree_map(lambda t: t.index_select(dim, idx.reshape(1)).squeeze(dim), params)


def map_fit(core: GPCore, data: GPData, n_restarts: int,
            generator: Optional[torch.Generator] = None,
            init_draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
            noise: Optional[Callable[[int], Sequence[torch.Tensor]]] = None,
            uniforms: Optional[torch.Tensor] = None, loop: Optional[Callable] = None):
    """Init ``n_restarts`` stacked restarts, fit them, keep the best:
    returns (params (1,...) of the best restart, its samples (S,...)).
    ``init_draws``, ``noise`` and ``uniforms`` replace the generator's
    draws, as in ``init_params`` and ``fit_from_batched``; ``loop`` as
    there."""
    p0 = core.init_params(data, n_restarts, generator, draws=init_draws)
    pf, loss, samples = core.fit_from_batched(p0, data, generator, noise=noise, uniforms=uniforms,
                                              loop=loop)
    best = torch.argmin(loss)
    pf = tree_map(lambda t: t.index_select(0, best.reshape(1)), pf)
    return pf, select(samples, best, dim=1)


# ------------------------------------------------------------------ wrapper
def make_data(X: np.ndarray, y: np.ndarray, numeric_dims, n_pad: int,
              device) -> GPData:
    """Host side: drop non-finite rows, standardize y, min-max-fit the
    numerics, pad to ``n_pad`` (gp.py:847-884)."""
    X = np.asarray(X, dtype=np.float32)
    y = np.asarray(y, dtype=np.float32).reshape(len(X), -1)[:, :1]
    ok = np.isfinite(y[:, 0]) & np.all(np.isfinite(X), axis=1)
    X, y = X[ok], y[ok]
    n = len(X)
    y_mean = float(np.mean(y)) if n else 0.0
    y_std = float(np.std(y)) if n else 1.0
    y_std = y_std if y_std > 1e-8 else 1.0
    nd = list(numeric_dims)
    if nd and n:
        lb = X[:, nd].min(axis=0)
        ub = X[:, nd].max(axis=0)
    else:
        lb = np.zeros(len(nd), np.float32)
        ub = np.ones(len(nd), np.float32)
    span = np.where(ub - lb < 1e-8, 1.0, ub - lb)
    Xp = np.zeros((n_pad, X.shape[1]), np.float32)
    yp = np.zeros((n_pad, 1), np.float32)
    mask = np.zeros((n_pad,), bool)
    Xp[:n] = X
    yp[:n] = (y - y_mean) / y_std
    mask[:n] = True
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return GPData(X=t(Xp), y=t(yp), mask=torch.as_tensor(mask, device=device),
                  x_lb=t(lb), x_span=t(span), y_mean=t(y_mean), y_std=t(y_std))


_INFERENCE = ("map", "hmc", "svi", "smc")


def _take(n: int, S: int) -> np.ndarray:
    """``jnp.linspace(0, n - 1, S).astype(int32)``: S indices spread over n."""
    return np.linspace(0, n - 1, S).astype(np.float32).astype(np.int64)


@register_model("gp")
class GP(BaseModel):
    """Host-side wrapper: pads to buckets and keeps the fitted state.

    ``inference`` is ``map`` (the MAP fit's pSGLD / Adam / slice samples)
    or a sampler run after the MAP fit on the fitted data (gp.py:998-1048):
    ``hmc`` (``n_chains`` chains started at the MAP point jittered by
    0.05, ``n_warmup`` warm-up transitions, ``n_ensemble`` spread over the
    draws), ``svi`` (a mean-field Gaussian at the MAP point) or ``smc``
    (``n_particles`` prior-initialised particles)."""

    support_ts = True
    support_grad = True
    support_warm_start = True

    def __init__(self, space, num_out: int = 1, device="cuda", **conf):
        super().__init__(space, num_out=num_out, **conf)
        if num_out != 1:
            raise ValueError("GP is single-output")
        self.device = resolve_device(device)
        self.inference = conf.get("inference", "map")
        if self.inference not in _INFERENCE:
            raise ValueError(f"unknown inference {self.inference!r}; known: {', '.join(_INFERENCE)}")
        self.core = GPCore(
            numeric_dims=tuple(space.numeric_dims) + tuple(space.perm_dims),
            cat_dims=tuple(space.cat_dims),
            num_categories=tuple(int(space.num_categories[c]) for c in space.cat_dims),
            kernel=conf.get("kernel", "matern32"),
            cat_kernel=conf.get("cat_kernel", "embedding"),
            noise_lb=conf.get("noise_lb", 8.9e-5),
            emb_dim=conf.get("emb_dim"),
            hed_num_anchors=conf.get("hed_num_anchors", 16),
            ssk_max_subseq=conf.get("ssk_max_subseq", 3),
            optimizer=conf.get("optimizer", "psgld"),
            n_steps=conf.get("num_epochs", 100),
            lr=conf.get("lr", 0.05),
            n_ensemble=conf.get("n_ensemble", 1),
            input_warp=conf.get("input_warp", False),
            heteroscedastic=conf.get("heteroscedastic", False),
            max_cholesky_size=conf.get("max_cholesky_size", 2048),
            cg_rank=conf.get("cg_rank", 128),
            cg_iters=conf.get("cg_iters", 96),
            cond_groups=conf.get("cond_groups"),
            cond_cat_to_group=conf.get("cond_cat_to_group"),
        )
        self.n_restarts = conf.get("n_restarts", 1)
        # a 1-D DeviceMesh: the block-sharded posterior above
        # max_cholesky_size, and HMC's chains / SMC's particles over the
        # ranks, their counts rounded up to a multiple of the mesh size
        self.mesh = self.core.mesh = conf.get("mesh")
        axis = conf.get("mesh_axis")
        if axis is not None and (self.mesh is None or axis not in self.mesh.mesh_dim_names):
            raise ValueError(f"mesh_axis {axis!r} is not an axis of the mesh")
        n_dev = mesh_size(self.mesh)
        rup = lambda v: -(-int(v) // n_dev) * n_dev
        self.n_chains = rup(conf.get("n_chains", 4))
        self.n_warmup = conf.get("n_warmup", 64)
        self.n_particles = rup(conf.get("n_particles", 32))
        self._seed = conf.get("seed", 0)
        self.params: Optional[GPParams] = None
        self.samples: Optional[GPParams] = None
        self.caches: Optional[GPCache] = None
        self.data: Optional[GPData] = None
        self.fit_data: Optional[GPData] = None  # what the hyperparameters were fitted on
        self.accept_rate: Optional[torch.Tensor] = None  # HMC's, per chain
        self.rhat: Optional[torch.Tensor] = None  # HMC's split-R̂ on a mesh

    def fit(self, X, y):
        """Fit the hyperparameters and build the posterior caches.  Above
        ``max_cholesky_size`` (gp.py:1076-1103) the hyperparameters are
        fitted (and sampled) on a random subsample of ``max_cholesky_size``
        valid points, in that subsample's own y and x normalization, and the
        CG cache is built on all the data, in the full data's
        normalization, as in the JAX package.  (The JAX package also builds
        a dense cache of the subsample and drops it; that is not done
        here.)"""
        n_pad = pad_bucket(max(len(X), 2))
        nd = self.core.numeric_dims
        self.data = make_data(X, y, nd, n_pad, self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self._seed)
        self._seed += 1
        mcs = self.core.max_cholesky_size
        self.fit_data = self.data
        if n_pad > mcs:
            Xa = np.asarray(X, np.float32)
            ya = np.asarray(y, np.float32).reshape(len(X), -1)[:, :1]
            ok = np.isfinite(ya[:, 0]) & np.all(np.isfinite(Xa), axis=1)
            Xv, yv = Xa[ok], ya[ok]
            ksub = min(len(Xv), mcs)
            idx = np.random.default_rng(self._seed).choice(len(Xv), size=ksub, replace=False)
            self.fit_data = make_data(Xv[idx], yv[idx], nd, pad_bucket(max(ksub, 2)), self.device)
        self.params, self.samples = map_fit(self.core, self.fit_data, self.n_restarts, gen)
        if self.inference != "map":
            self.samples = self._sample(self.params, self.fit_data, gen)
        self.caches = self.core.posterior_cache_batched(self.samples, self.data)
        return self

    def _sample(self, pf: GPParams, data: GPData, gen: torch.Generator) -> GPParams:
        """The hyperparameter posterior's ``n_ensemble`` samples after the
        MAP point ``pf`` (gp.py:1000-1048); every log-density evaluation is
        one batched NLL (K1 on CUDA) over the chains, draws or particles."""
        core, S = self.core, self.core.n_ensemble
        logp = lambda p: -core.loss_batched(p, data)
        if self.inference == "hmc":
            C = self.n_chains
            chain0 = tree_map(lambda t: t.expand((C,) + t.shape[1:]) + 0.05 * torch.randn(
                (C,) + t.shape[1:], generator=gen, dtype=t.dtype, device=t.device), pf)
            n_per = max(1, S)
            if self.mesh is not None:
                draws, self.accept_rate, self.rhat = hmc_sample_sharded(
                    logp, chain0, gen, self.mesh, n_chains=C, n_warmup=self.n_warmup,
                    n_samples=n_per)
            else:
                draws, self.accept_rate = hmc_sample(logp, chain0, gen, n_chains=C,
                                                     n_warmup=self.n_warmup, n_samples=n_per)
            take = torch.as_tensor(_take(n_per * C, S), device=pf.log_sc.device)
            return tree_map(lambda t: t.reshape((n_per * C,) + t.shape[2:]).index_select(0, take),
                            draws)
        if self.inference == "svi":
            return svi_fit(logp, pf, gen, n_samples=S)[0]
        parts0 = core.init_params(data, self.n_particles, gen)
        if self.mesh is not None:
            parts, _ = smc_sample_sharded(core.log_prior, lambda p: -core.nll_batched(p, data),
                                          parts0, gen, self.mesh)
        else:
            parts, _ = smc_sample(core.log_prior, lambda p: -core.nll_batched(p, data), parts0, gen)
        take = torch.as_tensor(_take(self.n_particles, S), device=pf.log_sc.device)
        return tree_map(lambda t: t.index_select(0, take), parts)

    @property
    def state(self):
        return (self.samples, self.caches, self.data)

    def predict_pure(self, state, Xs: torch.Tensor):
        """(mu, var) in the raw-y frame for opt-frame tensors Xs (P, D),
        differentiable in Xs (the interleaved and bandit optimizers descend
        the acquisition through it); callers that need no gradient run it
        under ``torch.no_grad``."""
        samples, caches, data = state
        mu, var = self.core.predict_ensemble(samples, caches, data, Xs)
        return mu * data.y_std + data.y_mean, var * data.y_std ** 2

    @torch.no_grad()
    def predict(self, X):
        if self.data is None:
            raise RuntimeError("fit first")
        X = np.asarray(X, dtype=np.float32)
        p = len(X)
        Xp = np.zeros((pad_bucket(p), X.shape[1]), np.float32)
        Xp[:p] = X
        mu, var = self.predict_pure(self.state, torch.as_tensor(Xp, device=self.device))
        return mu.cpu().numpy()[:p], var.cpu().numpy()[:p]

    def sample_f(self, n_samples: int = 1, seed: int = 0):
        """f(Xq) → (n_samples, n, 1) joint posterior draws at Xq (n, D) in
        the raw-y frame, from the first hyperparameter sample
        (gp.py:1134-1150); each call draws from a generator seeded by
        ``seed``."""
        if self.data is None:
            raise RuntimeError("fit first")

        def f(Xq: np.ndarray) -> np.ndarray:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            p0, c0 = (tree_map(lambda t: t[:1], x) for x in (self.samples, self.caches))
            Xs = torch.as_tensor(np.asarray(Xq, np.float32), device=self.device)
            draws = self.core.joint_sample_scaled(p0, c0, self.data, Xs, n_samples, gen)
            d = self.data
            return (draws[:, :, None] * d.y_std + d.y_mean).cpu().numpy()

        return f

    @torch.no_grad()
    def joint_sample_pure(self, state, generator: torch.Generator, Xs: torch.Tensor):
        """One joint posterior draw f(Xs) → (P, 1) in the raw-y frame, from
        a hyperparameter sample picked uniformly (gp.py:1163-1180), with no
        host read."""
        samples, caches, data = state
        S = samples.log_sc.shape[0]
        i = torch.randint(0, S, (1,), generator=generator, device=data.X.device)
        p, c = (tree_map(lambda t: t.index_select(0, i), x) for x in (samples, caches))
        draw = self.core.joint_sample_scaled(p, c, data, Xs, 1, generator)
        return draw[0][:, None] * data.y_std + data.y_mean

    @property
    def noise(self):
        if self.params is None:
            return np.zeros(1)
        ys = float(self.data.y_std)
        return np.asarray(
            [float(torch.exp(self.params.log_noise[0]) + self.core.noise_lb) * ys ** 2]
        )


@register_model("gpy_wgp")
class WarpedGP(GP):
    """Input-warped GP: the Kumaraswamy warp of the numerics fitted with the
    other hyperparameters, over 4 restarts (gp.py:1191-1204)."""

    def __init__(self, space, num_out: int = 1, device="cuda", **conf):
        conf.setdefault("input_warp", True)
        conf.setdefault("n_restarts", 4)
        super().__init__(space, num_out=num_out, device=device, **conf)


@register_model("gpy_mlp")
class MLPKernelGP(GP):
    """GP with the arc-sine MLP kernel (gp.py:1206-1216)."""

    def __init__(self, space, num_out: int = 1, device="cuda", **conf):
        conf.setdefault("kernel", "mlp")
        super().__init__(space, num_out=num_out, device=device, **conf)
