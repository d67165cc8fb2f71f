"""SVGP's ELBO gradient on a CUDA card against float64 at fitted points.

    python3 -m hebo_tpu_torch.bench.svgp_grad_probe

``tests/test_torch_cuda.py::test_svgp_elbo_gradient_on_card_equals_cpu``
holds the card's float32 gradient of each hyperparameter (and of the
inducing points Z) within (n − 1)·ε₃₂·M of the float64 gradient on the CPU
from the same parameters, where M is the sum of the magnitudes of the
terms that make up that gradient (``gradient_terms``) and n = M·N + M² the
Gram entries it depends on (float32's recursive-summation bound).  This probe
fits the same SVGP (300 Sobol points, 32 inducing points) on the card at
several seeds and epoch counts and prints per fit, for each leaf, the
largest |card − float64| / (ε₃₂ · M) (``card_ratio``), the same ratio for
the CPU's float32 gradient (``cpu32_ratio``, the yardstick of float32 at
that point), the older measure |card − float64| / max |float64|, and the
loss's relative error.  The first line is the card's name and power limit.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from hebo_tpu_torch import DesignSpace  # noqa: E402
from hebo_tpu_torch.models import get_model  # noqa: E402
from hebo_tpu_torch.models.gp import svgp  # noqa: E402
from hebo_tpu_torch.models.gp.gp import GPData  # noqa: E402
from hebo_tpu_torch.models.gp.tree import tree_map  # noqa: E402

EPS32 = float(np.finfo(np.float32).eps)
LEAVES = ("log_ls", "log_sc", "log_noise", "mean", "Z")
# the fitted points: (seed, epochs)
POINTS = ((0, 20), (1, 20), (2, 20), (0, 30), (0, 50))


def fit(seed: int, epochs: int, device="cuda"):
    """The SVGP of the check: 300 Sobol points in [0, 1]⁶, 32 inducing
    points, ``epochs`` Adam steps."""
    space = DesignSpace([{"name": f"x{i}", "type": "num", "lb": 0.0, "ub": 1.0} for i in range(6)])
    X = space.sobol_sample_opt(300, seed=seed).astype(np.float32)
    y = (((X - 0.4) ** 2).sum(1, keepdims=True) + 0.3 * np.sin(5 * X[:, :1])).astype(np.float32)
    return get_model("svgp", space, device=device, num_epochs=epochs).fit(X, y)


def gradient(m, device, dtype=torch.float32):
    """(loss, {leaf: gradient}) of the ELBO loss at m's parameters, on
    ``device`` in ``dtype``."""
    p = svgp.SVGPParams(gp=tree_map(lambda v: v.detach().to(device, dtype).requires_grad_(True), m.params.gp),
                        Z=m.params.Z.detach().to(device, dtype).requires_grad_(True))
    data = GPData(*(v.to(device, dtype) if v.is_floating_point() else v.to(device) for v in m.data))
    loss = m.core.loss(p, data).sum()
    gs = torch.autograd.grad(loss, [p.gp.log_ls, p.gp.log_sc, p.gp.log_noise, p.gp.mean, p.Z])
    return loss.detach(), dict(zip(LEAVES, gs))


def _abs_jac_z(A, B, G, ls, sc):
    """Σ_n |G_mn| · |∂k(a_m, b_n)/∂a_m| for the Matérn-3/2 k = sc (1 + s)
    e^{−s}, s = √3 ‖(a − b)/ℓ‖: |∂k/∂a_f| = 3 sc e^{−s} |a_f − b_f| / ℓ_f²."""
    diff = A[:, None, :] - B[None, :, :]
    s = math.sqrt(3.0) * torch.sqrt(((diff / ls) ** 2).sum(-1))
    w = G.abs() * 3.0 * sc * torch.exp(-s)
    return (w[..., None] * diff.abs() / ls ** 2).sum(1)


def gradient_terms(m):
    """The float64 CPU gradient of every leaf and M, the sum of the
    magnitudes of the terms that make it up, from float64 pieces:

    * the Gram hyperparameters log ℓ and log σ²: Σ |∂L/∂K| ⊙ ∂K/∂θ over
      Kmm and Kmn (∂K/∂θ ≥ 0 for both, so this is the VJP with cotangent
      |∂L/∂K|), plus |the rest| (the trace term's σ² and the prior);
    * Z: Σ |∂L/∂K| ⊙ |∂K/∂Z| over Kmn and both sides of Kmm (closed form);
    * the mean: Σ_i |∂L/∂y_i| (y − mean enters as r), plus |the rest|;
    * log σ²_noise: σ²_noise Σ |∂L/∂B ⊙ (B − I)| / σ²_noise over the
      inner matrix B = I + A Aᵀ / σ²_noise, plus |the rest|.
    Returns ({leaf: float64 gradient}, {leaf: M})."""
    core = m.core
    p = svgp.SVGPParams(gp=tree_map(lambda v: v.detach().cpu().double().requires_grad_(True), m.params.gp),
                        Z=m.params.Z.detach().cpu().double().requires_grad_(True))
    data = GPData(*(v.cpu().double() if v.is_floating_point() else v.cpu() for v in m.data))
    data = data._replace(y=data.y.clone().requires_grad_(True))
    grams, factored = [], []
    gram0, ladder0 = core.gram, svgp.ladder_factor_inv

    def spy_gram(gp, a, b):
        grams.append((a, b, gram0(gp, a, b)))
        return grams[-1][2]

    def spy_ladder(K, rungs):
        factored.append(K)
        return ladder0(K, rungs)

    core.gram, svgp.ladder_factor_inv = spy_gram, spy_ladder
    try:
        loss = core.loss(p, data).sum()
    finally:
        del core.gram
        svgp.ladder_factor_inv = ladder0
    (_, _, Kmm), (_, f, Kmn) = grams
    B = factored[1]
    leaves = [p.gp.log_ls, p.gp.log_sc, p.gp.log_noise, p.gp.mean, p.Z]
    *g, gmm, gmn, gB, gy = torch.autograd.grad(loss, leaves + [Kmm, Kmn, B, data.y])
    g = dict(zip(LEAVES, g))
    # the Gram hyperparameters: VJPs of the Grams with |G| and with G
    th = p.gp._replace(log_ls=p.gp.log_ls.detach().requires_grad_(True),
                       log_sc=p.gp.log_sc.detach().requires_grad_(True))
    Z, f = p.Z.detach(), f.detach()
    grams2 = [gram0(th, Z, Z), gram0(th, Z, f)]
    absv = torch.autograd.grad(grams2, [th.log_ls, th.log_sc], [gmm.abs(), gmn.abs()], retain_graph=True)
    sgnv = torch.autograd.grad(grams2, [th.log_ls, th.log_sc], [gmm, gmn])
    M = {k: a + (g[k] - s).abs() for k, a, s in zip(("log_ls", "log_sc"), absv, sgnv)}
    # Z: both sides of Kmm, and Kmn
    F = Z.shape[-1]
    ls, sc = torch.exp(p.gp.log_ls.detach()[0, :F]), torch.exp(p.gp.log_sc.detach()[0])
    Zs, fs = Z[0] / ls, f[0] / ls  # the Gram's scaled inputs
    M["Z"] = ((_abs_jac_z(Zs, fs, gmn[0], 1.0, sc) + _abs_jac_z(Zs, Zs, gmm[0], 1.0, sc)
               + _abs_jac_z(Zs, Zs, gmm[0].T, 1.0, sc)) / ls)[None]
    # the mean: r = (y − mean) m, so ∂L/∂mean = −Σ ∂L/∂y
    M["mean"] = gy.abs().sum().reshape(1) + (g["mean"] + gy.sum()).abs()
    # the noise: B = I + A Aᵀ / σ², ∂B/∂σ² = −(B − I) / σ²
    noise = torch.exp(p.gp.log_noise.detach()) + core.noise_lb
    eye = torch.eye(B.shape[-1], dtype=B.dtype)
    viaB = -(gB * (B.detach() - eye)).sum((-2, -1)) / noise
    en = torch.exp(p.gp.log_noise.detach())
    M["log_noise"] = en * (gB * (B.detach() - eye)).abs().sum((-2, -1)) / noise + (g["log_noise"] - en * viaB).abs()
    return {k: v.detach() for k, v in g.items()}, M


def ratios(m) -> dict:
    """Per leaf: the largest |card − float64| / (ε₃₂ M) and the same for the
    CPU's float32 gradient, the older |card − float64| / max |float64|, and
    the loss's relative error."""
    g64, M = gradient_terms(m)
    lc, gc = gradient(m, "cuda")
    l32, g32 = gradient(m, "cpu")
    l64 = float(gradient(m, "cpu", torch.float64)[0])
    r = lambda a, k: float(((a[k].cpu().double() - g64[k]).abs() / (EPS32 * M[k])).max())
    return {"card_ratio": {k: r(gc, k) for k in LEAVES}, "cpu32_ratio": {k: r(g32, k) for k in LEAVES},
            "card_err_over_max": {k: float((gc[k].cpu().double() - g64[k]).abs().max() / g64[k].abs().max())
                                  for k in LEAVES},
            "loss_rel_err": abs(float(lc) - l64) / abs(l64), "cpu32_loss_rel_err": abs(float(l32) - l64) / abs(l64)}


def main():
    if not torch.cuda.is_available():
        sys.exit("svgp_grad_probe: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    from hebo_tpu_torch.ops import native

    native.build()
    for seed, epochs in POINTS:
        print(json.dumps({"seed": seed, "epochs": epochs, **ratios(fit(seed, epochs))}), flush=True)


if __name__ == "__main__":
    main()
