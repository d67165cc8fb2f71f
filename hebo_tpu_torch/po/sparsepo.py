"""SparsePO: token-masked preference optimization (port of
``hebo_tpu/po/sparsepo.py``).

Parity: SparsePO (src/trainers/): DPO-style preference optimization where
the per-token log-ratio contributions are weighted by LEARNED sparse
masks — only the tokens that matter for the preference receive gradient,
yielding targeted updates.

``TinyLM`` is a small causal transformer with flax's layer definitions
(``meta/nap.py``'s ``_Dense``, ``_LayerNorm`` and ``_Attention``: LayerNorm
ε 1e-6 with the variance E[x²] − E[x]², the tanh GELU, the attention
written out as the masked softmax flax computes, masked logits at the
float32 minimum); its weights are drawn from a ``torch.Generator`` at
construction, and ``tinylm_from_flax`` carries a flax tree across.
Training applies a parameter dict with ``torch.func.functional_call`` and
steps optax's Adam on the model's device (``models.gp.tree.adam_train``:
all parameters as one flat vector); the frozen reference's
log-probabilities of every pair are computed once, and the losses stay on
the device until the end.  Each step's minibatch indices are drawn from a
generator or fed (``idx``).  The mask heads see the hidden states detached (flax's
``stop_gradient``), so the DPO gradient reaches the LM only through the
log-ratios.

Mask flavors (reference parity, src/masks/mask_models.py + the two
trainers src/trainers/{sparse,mapo}_trainer.py):
  * ``learned``     — last-hidden-state mask head (SimpleMaskLayer),
  * ``all_layers``  — per-layer mask heads + linear mixer
                      (SimpleMaskAllLayers),
  * ``activation``  — MaPO: mask derived from model activations (z-normed
                      per-token hidden norms), no learned mask params,
  * ``common``      — one mask (from the chosen sequence) shared across
                      the pair (the common-mask trainer variant).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from ..meta.nap import _Block, _Dense, _Embed, _FlaxTree, _LayerNorm, _trunc_normal
from ..models.gp.tree import adam_train
from ..utils.device import resolve_device

__all__ = ["TinyLM", "sparse_dpo_loss", "train_sparse_po", "make_pref_data",
           "preference_accuracy", "tinylm_from_flax"]

Params = Dict[str, torch.Tensor]


class TinyLM(nn.Module):
    """Small causal transformer LM with a token-mask head."""

    def __init__(self, vocab: int, d_model: int = 64, n_heads: int = 4, n_layers: int = 2,
                 max_len: int = 64, generator: Optional[torch.Generator] = None, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.vocab, self.d_model, self.n_heads = vocab, d_model, n_heads
        self.n_layers, self.max_len = n_layers, max_len
        self.tok_emb = _Embed(vocab, d_model, device=dev)
        self.pos_emb = _Embed(max_len, d_model, device=dev)
        self.blocks = nn.ModuleList(_Block(d_model, n_heads, dev) for _ in range(n_layers))
        self.head = _Dense(d_model, vocab, device=dev)
        self.mask_head = _Dense(d_model, 1, device=dev)
        self.mask_l = nn.ModuleList(_Dense(d_model, 1, device=dev) for _ in range(n_layers))
        self.mask_ln = nn.ModuleList(_LayerNorm(d_model, dev) for _ in range(n_layers))
        self.mask_mixer = _Dense(n_layers, 1, bias=False, device=dev)
        for m in self.modules():
            if isinstance(m, _Dense):
                m.reset(generator)
        for e in (self.tok_emb, self.pos_emb):  # flax's default_embed_init: variance 1 / features
            _trunc_normal(e.weight, 1.0 / math.sqrt(d_model), generator)
        self._causal = {}

    def forward(self, tokens):
        B, T = tokens.shape
        h = self.tok_emb(tokens) + self.pos_emb.weight[:T][None]
        allowed = self._causal.get((T, h.device))
        if allowed is None:
            allowed = self._causal[T, h.device] = torch.tril(
                torch.ones((T, T), dtype=torch.bool, device=h.device))
        per_layer = []
        for blk in self.blocks:
            h = blk(h, allowed=allowed)
            per_layer.append(h)
        logits = self.head(h)
        hs = h.detach()
        # flavor heads (all computed; the loss selects one):
        # SimpleMaskLayer — last hidden state
        mask_logits = self.mask_head(hs)[..., 0]
        # SimpleMaskAllLayers — per-layer heads + linear mixer
        per = torch.stack([lin(ln(x.detach()))[..., 0]
                           for lin, ln, x in zip(self.mask_l, self.mask_ln, per_layer)], -1)
        mask_all_layers = self.mask_mixer(per)[..., 0]
        # MaPO — activation statistic, parameter-free: z-normed hidden norm
        act = torch.sqrt((hs * hs).sum(-1))  # (B, T)
        act = (act - act.mean(1, keepdim=True)) / (act.std(1, keepdim=True, correction=0) + 1e-6)
        return logits, {"learned": mask_logits, "all_layers": mask_all_layers, "activation": act}


def _token_logps(logits, tokens):
    """log p(token_t | <t) for t ≥ 1: (B, T-1)."""
    lp = F.log_softmax(logits[:, :-1], -1)
    return torch.gather(lp, -1, tokens[:, 1:, None])[..., 0]


def _select_mask(masks_c, masks_r, mask_mode: str):
    """Pick a flavor's (chosen, rejected) mask logits (see module doc)."""
    if mask_mode in ("learned", "all_layers", "activation"):
        return masks_c[mask_mode], masks_r[mask_mode]
    if mask_mode == "common":
        # one mask shared across the pair (common-mask trainer variant):
        # computed from the chosen sequence's learned head
        return masks_c["learned"], masks_c["learned"]
    raise ValueError(f"unknown mask_mode {mask_mode!r}")


def _ref_logps(model, ref_params, tokens):
    """The frozen reference's log p(token_t | <t), (B, T-1)."""
    with torch.no_grad():
        logits, _ = functional_call(model, ref_params, (tokens,))
        return _token_logps(logits, tokens)


def _scores(model, params, ref_lp, chosen, rejected, mask_mode):
    """The mask-weighted log-ratio sums (s_c, s_r) and masks (m_c, m_r),
    given the reference's log-probabilities ``ref_lp`` of the chosen rows
    then the rejected ones.  Chosen and rejected go through the model as
    one batch."""
    B = chosen.shape[0]
    both = torch.cat([chosen, rejected], 0)
    logits, masks = functional_call(model, params, (both,))
    ratio = _token_logps(logits, both) - ref_lp
    mlog_c, mlog_r = _select_mask({k: v[:B] for k, v in masks.items()},
                                  {k: v[B:] for k, v in masks.items()}, mask_mode)
    m_c = torch.sigmoid(mlog_c[:, 1:])
    m_r = torch.sigmoid(mlog_r[:, 1:])
    return (m_c * ratio[:B]).sum(1), (m_r * ratio[B:]).sum(1), m_c, m_r


def _dpo(s_c, s_r, m_c, m_r, beta, mask_l1):
    dpo = -torch.mean(F.logsigmoid(beta * (s_c - s_r)))
    sparsity = mask_l1 * (torch.mean(m_c) + torch.mean(m_r))
    return dpo + sparsity, (torch.mean(m_c) + torch.mean(m_r)) / 2


def sparse_dpo_loss(model: TinyLM, params: Params, ref_params: Params, chosen, rejected,
                    beta: float = 0.5, mask_l1: float = 0.05, mask_mode: str = "learned"):
    """DPO with per-token masks (flavor selected by ``mask_mode``).

    π/π_ref log-ratios are aggregated with mask weights m_t ∈ (0, 1)
    (sigmoid of the selected mask head); an L1 term drives the masks
    sparse (no-op for the parameter-free MaPO activation flavor).
    Returns (loss, mean mask)."""
    ref_lp = _ref_logps(model, ref_params, torch.cat([chosen, rejected], 0))
    return _dpo(*_scores(model, params, ref_lp, chosen, rejected, mask_mode), beta, mask_l1)


def make_pref_data(n_pairs: int, T: int, vocab: int, good_token: int = 3,
                   generator: Optional[torch.Generator] = None, device="cuda"):
    """Synthetic preferences: chosen sequences contain ``good_token`` in
    the second half; rejected do not — only those positions should matter
    (the mask's job).  Returns (chosen, rejected), int64 (n_pairs, T)."""
    dev = resolve_device(device)
    chosen = torch.randint(4, vocab, (n_pairs, T), generator=generator, device=dev)
    chosen[:, T // 2] = good_token
    rejected = torch.randint(4, vocab, (n_pairs, T), generator=generator, device=dev)
    return chosen, rejected


def train_sparse_po(
    model: TinyLM,
    chosen: torch.Tensor,
    rejected: torch.Tensor,
    *,
    n_steps: int = 150,
    lr: float = 1e-3,
    beta: float = 0.5,
    mask_l1: float = 0.05,
    batch: int = 16,
    mask_mode: str = "learned",
    idx=None,
    generator: Optional[torch.Generator] = None,
):
    """→ (params, metrics dict).  Training starts from ``model``'s own
    weights, whose frozen copy is the DPO reference; ``idx`` (n_steps,
    batch) are each step's pair indices, drawn from ``generator`` when not
    fed."""
    dev = next(model.parameters()).device
    chosen, rejected = (torch.as_tensor(t, dtype=torch.long, device=dev) for t in (chosen, rejected))
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    ref_params = {k: v.clone() for k, v in params.items()}
    if idx is None:
        idx = torch.randint(0, chosen.shape[0], (n_steps, batch), generator=generator, device=dev)
    idx = torch.as_tensor(idx, dtype=torch.long, device=dev)
    # the frozen reference's log-probabilities of every pair, once
    ref_c, ref_r = _ref_logps(model, ref_params, chosen), _ref_logps(model, ref_params, rejected)
    masks = []

    def loss_fn(cur, i):
        val, mask_mean = _dpo(*_scores(model, cur, torch.cat([ref_c[i], ref_r[i]]), chosen[i], rejected[i],
                                       mask_mode), beta, mask_l1)
        masks.append(mask_mean.detach())
        return val

    params, losses = adam_train(params, loss_fn, n_steps, lr, lambda s: idx[s])
    return params, {
        "loss": losses,
        "mask_mean": torch.stack(masks).cpu().numpy(),
        "ref_params": ref_params,
    }


def preference_accuracy(model, params, ref_params, chosen, rejected,
                        beta=0.5, mask_mode: str = "learned") -> float:
    with torch.no_grad():
        ref_lp = _ref_logps(model, ref_params, torch.cat([chosen, rejected], 0))
        s_c, s_r, _, _ = _scores(model, params, ref_lp, chosen, rejected, mask_mode)
    return float(torch.mean((s_c > s_r).to(torch.float32)))


def tinylm_from_flax(flax_params, model: TinyLM) -> Params:
    """A flax ``TinyLM`` parameter tree (with or without the top
    ``"params"`` level) → the port's parameter dict for ``model``, on its
    device: the embeddings carry over, the blocks map as NAP's
    (``meta/nap.py``'s ``_FlaxTree.blocks``; flax names layer l's pair
    Dense_{2l}, Dense_{2l+1}), then the LM head Dense_{2L}, the learned
    mask head Dense_{2L+1}, the per-layer heads ``mask_l{i}`` /
    ``mask_ln{i}`` and the bias-free ``mask_mixer``, in ``model``'s float
    type.  Every flax leaf must be used exactly once."""
    f64 = next(model.parameters()).dtype == torch.float64
    tree, out = _FlaxTree(flax_params, np.float64 if f64 else np.float32), {}
    L = model.n_layers
    out["tok_emb.weight"] = tree.take("Embed_0", "embedding")
    out["pos_emb.weight"] = tree.take("Embed_1", "embedding")
    tree.blocks(out, L, 0)
    tree.dense(out, "head", f"Dense_{2 * L}")
    tree.dense(out, "mask_head", f"Dense_{2 * L + 1}")
    for i in range(L):
        tree.dense(out, f"mask_l.{i}", f"mask_l{i}")
        out[f"mask_ln.{i}.scale"] = tree.take(f"mask_ln{i}", "scale")
        out[f"mask_ln.{i}.bias"] = tree.take(f"mask_ln{i}", "bias")
    out["mask_mixer.weight"] = tree.take("mask_mixer", "kernel").T
    return tree.state_dict(out, model)
