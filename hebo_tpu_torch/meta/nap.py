"""NAP: a transformer neural-process surrogate for meta-BO (port of
``hebo_tpu/meta/nap.py``; model id ``nap``).

A PFN-style masked transformer over (x, y) context tokens and (x, 0)
query tokens, where every token attends only to the valid context tokens.
It is meta-trained once per process and shape key (the class-level
``_pretrained`` cache) on random GP-sample tasks with the Gaussian NLL of
held-out points, then ``fit`` only stores the context: inference is
amortized.

The layers follow flax's definitions, not PyTorch's defaults: LayerNorm
with ε = 1e-6 and the variance as E[x²] − E[x]², the tanh-approximated
GELU, masked logits filled with the float32 minimum, truncated
lecun-normal kernels with zero biases, and multi-head attention written
out (q / k / v projections to ``d_model``, the query scaled by
1/√head_dim, the output projection).  ``nap_from_flax`` carries a flax
parameter tree across.

``sample_gp_tasks`` factors each task's RBF (or Hamming) Gram through
kernel K1's ladder (``ops/chol.batched_ladder_factor`` with one rung and
no jitter: ``jnp.linalg.cholesky``, whose failed factor is non-finite).
Every random number of a task can be fed (``TaskDraws``), and so can each
meta-training step's task and context size.
"""

from __future__ import annotations

import math
import time
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from ..models.base import BaseModel, register_model
from ..models.gp.tree import adam_step
from ..ops.chol import batched_ladder_factor
from ..utils.device import resolve_device

__all__ = ["TransformerNP", "TaskDraws", "draw_tasks", "sample_gp_tasks", "meta_train_np",
           "NAPSurrogate", "nap_from_flax"]

_TRUNC = 0.87962566103423978  # std of a standard normal truncated to [−2, 2]


def _trunc_normal(t: torch.Tensor, std: float, generator) -> torch.Tensor:
    """flax's truncated ``variance_scaling`` normal: N(0, std²) cut at ±2 std."""
    s = std / _TRUNC
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, s, -2.0 * s, 2.0 * s, generator=generator)


class _Dense(nn.Linear):
    """flax ``nn.Dense``: lecun-normal (truncated) kernel, zero bias (none
    with ``bias=False``), drawn by ``reset`` from the model's generator (not
    at construction)."""

    def reset_parameters(self):
        pass

    def reset(self, generator):
        _trunc_normal(self.weight, 1.0 / math.sqrt(self.in_features), generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class _Embed(nn.Embedding):
    """flax ``nn.Embed``, drawn by ``TransformerNP`` from its generator."""

    def reset_parameters(self):
        pass


class _LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: ε 1e-6, variance E[x²] − E[x]² clipped at 0."""

    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=device))
        self.bias = nn.Parameter(torch.zeros(d, device=device))

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
        return (x - mean) * (torch.rsqrt(var + 1e-6) * self.scale) + self.bias


class _Attention(nn.Module):
    """flax ``MultiHeadDotProductAttention(num_heads, qkv_features=d)`` on
    (h, h) with a key mask ``key_ok`` (B, T) and / or a mask ``allowed``
    broadcastable to (B, H, T, T) (a causal (T, T) one, say); True attends."""

    def __init__(self, d: int, n_heads: int, device=None):
        super().__init__()
        self.n_heads = n_heads
        self.query, self.key, self.value, self.out = (_Dense(d, d, device=device) for _ in range(4))

    def forward(self, h, key_ok=None, allowed=None):
        B, T, d = h.shape
        H = self.n_heads
        hd = d // H
        q = self.query(h).view(B, T, H, hd) / math.sqrt(hd)
        k = self.key(h).view(B, T, H, hd)
        v = self.value(h).view(B, T, H, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if key_ok is not None:
            logits = logits.masked_fill(~key_ok[:, None, None, :], torch.finfo(logits.dtype).min)
        if allowed is not None:
            logits = logits.masked_fill(~allowed, torch.finfo(logits.dtype).min)
        w = torch.softmax(logits, -1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, T, d))


class _Block(nn.Module):
    def __init__(self, d: int, n_heads: int, device=None):
        super().__init__()
        self.attn = _Attention(d, n_heads, device)
        self.ln1 = _LayerNorm(d, device)
        self.ff1 = _Dense(d, 2 * d, device=device)
        self.ff2 = _Dense(2 * d, d, device=device)
        self.ln2 = _LayerNorm(d, device)

    def forward(self, h, key_ok=None, allowed=None):
        h = self.ln1(h + self.attn(h, key_ok, allowed))
        return self.ln2(h + self.ff2(F.gelu(self.ff1(h), approximate="tanh")))


class TransformerNP(nn.Module):
    """Masked transformer: context tokens embed (x, y), query tokens (x, 0)
    and attend only to valid context tokens.  With ``cat_dims``, each
    categorical column (an integer code stored as a float) looks up a
    per-column table of width min(8, 1 + c // 2) before the token
    projections."""

    def __init__(self, dim_x: int, d_model: int = 64, n_heads: int = 4, n_layers: int = 3,
                 cat_dims: Tuple[int, ...] = (), num_categories: Tuple[int, ...] = (),
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.dim_x, self.d_model, self.n_heads, self.n_layers = dim_x, d_model, n_heads, n_layers
        self.cat_dims, self.num_categories = tuple(cat_dims), tuple(num_categories)
        cat_set = set(self.cat_dims)
        self.num_idx = tuple(j for j in range(dim_x) if j not in cat_set)
        self.cat_emb = nn.ModuleList(_Embed(c, min(8, 1 + c // 2), device=device)
                                     for c in self.num_categories)
        d_in = len(self.num_idx) + sum(e.embedding_dim for e in self.cat_emb) + 1
        self.ctx_proj = _Dense(d_in, d_model, device=device)
        self.qry_proj = _Dense(d_in, d_model, device=device)
        self.blocks = nn.ModuleList(_Block(d_model, n_heads, device) for _ in range(n_layers))
        self.mu_head = _Dense(d_model, 1, device=device)
        self.ls_head = _Dense(d_model, 1, device=device)
        for m in self.modules():
            if isinstance(m, _Dense):
                m.reset(generator)
        for e in self.cat_emb:  # flax's default_embed_init: variance 1 / features
            _trunc_normal(e.weight, 1.0 / math.sqrt(e.embedding_dim), generator)
        self._idx = None

    def _feat(self, X):
        if not self.cat_dims:
            return X
        if self._idx is None or self._idx.device != X.device:
            self._idx = torch.as_tensor(self.num_idx, dtype=torch.long, device=X.device)
        parts = [X.index_select(-1, self._idx)] if self.num_idx else []
        for e, j in zip(self.cat_emb, self.cat_dims):
            parts.append(e(X[..., j].long()))
        return torch.cat(parts, -1)

    def forward(self, Xc, yc, Xq, ctx_mask):
        """Xc (B, Nc, dx), yc (B, Nc, 1), Xq (B, Nq, dx), ctx_mask (B, Nc)
        bool → (μ, log σ), each (B, Nq, 1)."""
        B, Nc, _ = Xc.shape
        Nq = Xq.shape[1]
        emb_c = self.ctx_proj(torch.cat([self._feat(Xc), yc], -1))
        emb_q = self.qry_proj(torch.cat([self._feat(Xq), Xq.new_zeros((B, Nq, 1))], -1))
        h = torch.cat([emb_c, emb_q], 1)
        key_ok = torch.cat([ctx_mask, ctx_mask.new_zeros((B, Nq))], 1)
        for blk in self.blocks:
            h = blk(h, key_ok)
        hq = h[:, Nc:, :]
        return self.mu_head(hq), torch.clamp(self.ls_head(hq), -5.0, 3.0)


class TaskDraws(NamedTuple):
    """The random numbers of a batch of tasks: X uniform on [−1, 1]
    (B, n, dx), the categorical codes (B, n, n_cat) (or None), log ℓ
    uniform on [−1.5, 0.5] (B, 1, 1, 1), z (B, n) and ε (B, n, 1) standard
    normal."""

    X: torch.Tensor
    codes: Optional[torch.Tensor]
    log_ls: torch.Tensor
    z: torch.Tensor
    eps: torch.Tensor


def draw_tasks(batch: int, n_points: int, dim_x: int, num_categories: Sequence[int] = (),
               generator: Optional[torch.Generator] = None, device="cuda") -> TaskDraws:
    f32 = dict(dtype=torch.float32, device=device)
    X = 2.0 * torch.rand((batch, n_points, dim_x), generator=generator, **f32) - 1.0
    codes = None
    if num_categories:
        codes = torch.stack([torch.randint(0, c, (batch, n_points), generator=generator,
                                           device=device) for c in num_categories], -1)
    log_ls = 2.0 * torch.rand((batch, 1, 1, 1), generator=generator, **f32) - 1.5
    return TaskDraws(X=X, codes=codes, log_ls=log_ls,
                     z=torch.randn((batch, n_points), generator=generator, **f32),
                     eps=torch.randn((batch, n_points, 1), generator=generator, **f32))


def sample_gp_tasks(batch: int, n_points: int, dim_x: int, cat_dims=(), num_categories=(),
                    generator: Optional[torch.Generator] = None,
                    draws: Optional[TaskDraws] = None, device="cuda"):
    """Random smooth functions (RBF GP samples with a random lengthscale;
    the categorical columns hold codes and enter a Hamming distance) on
    random X: returns (X (B, n, dx), y (B, n, 1)).  The Gram plus 1e-4·I is
    factored by K1 (one rung, no jitter) on CUDA and its plain version on
    the CPU."""
    d = draws if draws is not None else draw_tasks(batch, n_points, dim_x, num_categories,
                                                   generator, device)
    X = d.X
    if cat_dims:
        X = X.clone()
        for i, j in enumerate(cat_dims):
            X[:, :, j] = d.codes[..., i].to(X.dtype)
    ls = torch.exp(d.log_ls)
    diff = X[:, :, None, :] - X[:, None, :, :]
    if cat_dims:
        is_cat = torch.zeros((dim_x,), dtype=torch.bool, device=X.device)
        is_cat[list(cat_dims)] = True
        d2 = torch.where(is_cat, (diff.abs() > 1e-6).to(X.dtype), diff ** 2).sum(-1, keepdim=True)
    else:
        d2 = (diff ** 2).sum(-1, keepdim=True)
    eye = torch.eye(n_points, dtype=X.dtype, device=X.device)
    K = torch.exp(-0.5 * d2[..., 0] / ls[..., 0] ** 2) + 1e-4 * eye
    L, _, _ = batched_ladder_factor(K, rungs=(0.0,), base_jitter=0.0)
    f = (L @ d.z[..., None])[..., 0]
    return X, f[..., None] + 0.05 * d.eps


def meta_train_np(model: TransformerNP, generator: Optional[torch.Generator] = None, *,
                  n_steps: int = 500, batch: int = 16, n_points: int = 32, min_ctx: int = 4,
                  lr: float = 1e-3, steps: Optional[List[Tuple[TaskDraws, int]]] = None):
    """PFN objective: Adam on the NLL of the last 4 points of each task
    given a random-size context of the first ``n_points − 4``.  Starts
    from ``model``'s parameters; ``steps`` feeds each step's (task draws,
    context size).  Returns (params dict, losses (n_steps,) numpy); the
    losses stay on the device until the end."""
    dev = next(model.parameters()).device
    cat_kw = dict(cat_dims=model.cat_dims, num_categories=model.num_categories)
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    losses = torch.empty((n_steps,), device=dev)
    nctx = n_points - 4
    pos = torch.arange(nctx, device=dev)
    for s in range(n_steps):
        if steps is None:
            draws = draw_tasks(batch, n_points, model.dim_x, model.num_categories, generator, dev)
            nc = torch.randint(min_ctx, nctx, (), generator=generator, device=dev)
        else:
            draws, nc = steps[s]
        X, y = sample_gp_tasks(batch, n_points, model.dim_x, draws=draws, **cat_kw)
        ctx_mask = (pos[None, :] < nc).expand(batch, nctx)
        Xc, yc, Xq, yq = X[:, :nctx], y[:, :nctx], X[:, nctx:], y[:, nctx:]
        with torch.enable_grad():
            cur = {k: v.requires_grad_(True) for k, v in params.items()}
            m, log_sigma = functional_call(model, cur, (Xc, yc * ctx_mask[..., None], Xq, ctx_mask))
            nll = 0.5 * (((yq - m) / torch.exp(log_sigma)) ** 2 + 2 * log_sigma
                         + math.log(2 * math.pi))
            loss = nll.mean()
            grads = torch.autograd.grad(loss, list(cur.values()))
        losses[s] = loss.detach()
        for (k, p), g in zip(cur.items(), grads):
            params[k], mu[k], nu[k] = adam_step(p.detach(), g, mu[k], nu[k], s + 1, lr)
    return params, losses.cpu().numpy()


class _FlaxTree:
    """The leaves of a flax parameter tree (nested dicts of arrays, with or
    without the top ``"params"`` level) by path, each to be taken once, as
    ``dtype`` arrays."""

    def __init__(self, flax_params, dtype=np.float32):
        tree = flax_params.get("params", flax_params)
        self.leaves, self.used = {}, set()

        def walk(node, path):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, path + (k,))
            else:
                self.leaves[path] = np.array(node, dtype)

        walk(tree, ())
        self.top = {p[0] for p in self.leaves}

    def take(self, *path):
        if path in self.used:
            raise ValueError(f"flax leaf {'/'.join(path)} used twice")
        self.used.add(path)
        return self.leaves[path]

    def dense(self, out: dict, name: str, flax_name: str) -> None:
        """A Dense kernel (in, out) becomes the transposed Linear weight."""
        out[f"{name}.weight"] = self.take(flax_name, "kernel").T
        out[f"{name}.bias"] = self.take(flax_name, "bias")

    def blocks(self, out: dict, n_layers: int, first_ff: int) -> None:
        """The transformer blocks: attention query / key / value kernels
        (d, H, hd) become (H·hd, d) weights and the out kernel (H, hd, d) a
        (d, H·hd) weight; LayerNorm's scale and bias carry over.  Flax names
        the outer Dense of Dense(d)(gelu(Dense(2d)(h))) first, and layer l's
        pair is Dense_{first_ff + 2l}, Dense_{first_ff + 2l + 1}."""
        for l in range(n_layers):
            mha = f"MultiHeadDotProductAttention_{l}"
            for part in ("query", "key", "value"):
                k = self.take(mha, part, "kernel")
                out[f"blocks.{l}.attn.{part}.weight"] = k.reshape(k.shape[0], -1).T
                out[f"blocks.{l}.attn.{part}.bias"] = self.take(mha, part, "bias").reshape(-1)
            k = self.take(mha, "out", "kernel")
            out[f"blocks.{l}.attn.out.weight"] = k.reshape(-1, k.shape[-1]).T
            out[f"blocks.{l}.attn.out.bias"] = self.take(mha, "out", "bias")
            for ln, idx in (("ln1", 2 * l), ("ln2", 2 * l + 1)):
                out[f"blocks.{l}.{ln}.scale"] = self.take(f"LayerNorm_{idx}", "scale")
                out[f"blocks.{l}.{ln}.bias"] = self.take(f"LayerNorm_{idx}", "bias")
            self.dense(out, f"blocks.{l}.ff2", f"Dense_{first_ff + 2 * l}")
            self.dense(out, f"blocks.{l}.ff1", f"Dense_{first_ff + 2 * l + 1}")

    def state_dict(self, out: dict, model: nn.Module, keep=()) -> dict:
        """``out`` as tensors on ``model``'s device, after checking that every
        flax leaf was used and every parameter of ``model`` (but those named
        in ``keep``, which ``model``'s own values fill) is set at its shape."""
        if self.used != set(self.leaves):
            raise ValueError(f"flax leaves not used: {sorted(set(self.leaves) - self.used)}")
        own = dict(model.named_parameters())
        for k in keep:
            out[k] = own[k].detach().cpu().numpy()
        if set(out) != set(own):
            raise ValueError(f"parameters not set: {sorted(set(own) - set(out))}")
        dev = next(model.parameters()).device
        res = {}
        for k, v in out.items():
            if tuple(v.shape) != tuple(own[k].shape):
                raise ValueError(f"{k}: flax shape {v.shape}, port shape {tuple(own[k].shape)}")
            res[k] = torch.as_tensor(np.ascontiguousarray(v), device=dev)
        return res


def nap_from_flax(flax_params, model: TransformerNP) -> dict:
    """A flax ``TransformerNP`` parameter tree (nested dicts of arrays,
    with or without the top ``"params"`` level) → the port's parameter dict
    for ``model``: a Dense kernel (in, out) becomes the transposed Linear
    weight, an attention query / key / value kernel (d, H, hd) a (H·hd, d)
    weight and its out kernel (H, hd, d) a (d, H·hd) weight; LayerNorm's
    scale and bias and the Embed tables carry over.  Every flax leaf must
    be used exactly once."""
    tree, out = _FlaxTree(flax_params), {}
    n = model.n_layers
    tree.dense(out, "ctx_proj", "Dense_0")
    tree.dense(out, "qry_proj", "Dense_1")
    for i in range(len(model.cat_dims)):
        out[f"cat_emb.{i}.weight"] = tree.take(f"cat_emb{i}", "embedding")
    tree.blocks(out, n, 2)
    tree.dense(out, "mu_head", f"Dense_{2 + 2 * n}")
    tree.dense(out, "ls_head", f"Dense_{3 + 2 * n}")
    return tree.state_dict(out, model)


@register_model("nap")
class NAPSurrogate(BaseModel):
    """Meta-trained neural-process surrogate with the BaseModel contract.

    The transformer is meta-trained once per process and key (input width,
    widths, steps, categorical columns, device), from a ``torch.Generator``
    seeded with 42 (the JAX package's ``PRNGKey(42)``); ``fit`` only stores
    the context set.  ``meta_train_s`` is the seconds this instance spent
    meta-training (0 when the cache held the weights)."""

    _pretrained: dict = {}

    support_grad = True

    def __init__(self, space, num_out=1, device="cuda", **conf):
        super().__init__(space, num_out, **conf)
        assert num_out == 1
        self.device = resolve_device(device)
        self.d_model = conf.get("d_model", 64)
        self.n_layers = conf.get("n_layers", 3)
        self.meta_steps = conf.get("meta_steps", 300)
        self._seed = conf.get("seed", 0)
        self.dim_x = space.num_cols
        cat_dims = tuple(int(c) for c in space.cat_dims)
        num_cats = tuple(int(space.num_categories[c]) for c in space.cat_dims)
        gen = torch.Generator(device=self.device).manual_seed(42)
        self.model = TransformerNP(dim_x=self.dim_x, d_model=self.d_model, n_layers=self.n_layers,
                                   cat_dims=cat_dims, num_categories=num_cats, generator=gen,
                                   device=self.device)
        # numeric-column mask: cat codes bypass the [-1, 1] normalization
        self._num_mask = np.ones((self.dim_x,), bool)
        if cat_dims:
            self._num_mask[list(cat_dims)] = False
        ck = (self.dim_x, self.d_model, self.n_layers, self.meta_steps, cat_dims, num_cats,
              str(self.device))
        self.meta_train_s = 0.0
        if ck not in NAPSurrogate._pretrained:
            t0 = time.time()
            params, _ = meta_train_np(self.model, gen, n_steps=self.meta_steps)
            self.meta_train_s = time.time() - t0
            NAPSurrogate._pretrained[ck] = params
        self.params = NAPSurrogate._pretrained[ck]
        self._ctx = None
        self._bounds = None

    def fit(self, X, y):
        X = np.asarray(X, np.float32)
        y = np.asarray(y, np.float32).reshape(len(X), 1)
        ok = np.isfinite(y[:, 0])
        X, y = X[ok], y[ok]
        Xn = self._normalize_np(X)
        mu_y, sd_y = float(y.mean()), max(float(y.std()), 1e-8)
        self._ctx = (Xn, (y - mu_y) / sd_y, mu_y, sd_y)
        return self

    def _normalize_np(self, X):
        lb, ub = self.space.opt_lb, self.space.opt_ub
        Xn = 2 * (np.asarray(X, np.float32) - lb) / np.maximum(ub - lb, 1e-9) - 1
        return np.where(self._num_mask, Xn, np.asarray(X, np.float32)).astype(np.float32)

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def _apply(self, params, Xc, yc, Xq):
        ones = torch.ones((1, Xc.shape[0]), dtype=torch.bool, device=Xc.device)
        return functional_call(self.model, params, (Xc[None], yc[None], Xq[None], ones))

    def predict(self, X):
        Xn_c, yn_c, mu_y, sd_y = self._ctx
        with torch.no_grad():
            mu, log_sigma = self._apply(self.params, self._t(Xn_c), self._t(yn_c),
                                        self._t(self._normalize_np(X)))
        mu = mu[0].cpu().numpy() * sd_y + mu_y
        var = (np.exp(log_sigma[0].cpu().numpy()) * sd_y) ** 2
        return mu, var

    # pure-state protocol
    @property
    def state(self):
        Xn_c, yn_c, mu_y, sd_y = self._ctx
        return (self.params, self._t(Xn_c), self._t(yn_c), self._t(mu_y), self._t(sd_y))

    def predict_pure(self, state, Xs):
        params, Xn_c, yn_c, mu_y, sd_y = state
        if self._bounds is None or self._bounds[0].device != Xs.device:
            self._bounds = tuple(torch.as_tensor(a, device=Xs.device) for a in (
                np.asarray(self.space.opt_lb, np.float32), np.asarray(self.space.opt_ub, np.float32),
                self._num_mask))
        lb, ub, num_mask = self._bounds
        Xq = 2 * (Xs - lb) / torch.clamp(ub - lb, min=1e-9) - 1
        Xq = torch.where(num_mask, Xq, Xs)
        mu, log_sigma = self._apply(params, Xn_c, yn_c, Xq)
        mu = mu[0] * sd_y + mu_y
        var = (torch.exp(log_sigma[0]) * sd_y) ** 2
        return mu, torch.clamp(var, min=1e-10)

    @property
    def noise(self):
        return np.zeros(1)
