"""SVGP's ELBO gradient on a CUDA card against the CPU's at fitted points.

    python3 -m hebo_tpu_torch.bench.svgp_grad_probe

``tests/test_torch_cuda.py::test_svgp_elbo_gradient_on_card_equals_cpu``
holds the card's gradient within 2e-3 of each leaf's largest |value| at
one fitted point (seed 0, 20 epochs).  This probe fits the same SVGP
(300 Sobol points, 32 inducing points) on the card at several seeds and
epoch counts, evaluates the ELBO and its gradient on the card and on the
CPU from the same parameters, and prints per fit the loss's relative error
and each gradient leaf's error over its largest |value|.  The outputscale's
gradient sums 32 × 300 terms with cancellation, so its error depends on
the point.  The first line is the card's name and power limit.
"""

from __future__ import annotations

import json
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
from hebo_tpu_torch.models.gp.tree import tree_leaves, tree_map  # noqa: E402


def errors(seed: int, epochs: int) -> dict:
    space = DesignSpace([{"name": f"x{i}", "type": "num", "lb": 0.0, "ub": 1.0} for i in range(6)])
    X = space.sobol_sample_opt(300, seed=seed).astype(np.float32)
    y = (((X - 0.4) ** 2).sum(1, keepdims=True) + 0.3 * np.sin(5 * X[:, :1])).astype(np.float32)
    m = get_model("svgp", space, device="cuda", num_epochs=epochs).fit(X, y)
    out = {}
    for dev in ("cuda", "cpu"):
        p = svgp.SVGPParams(gp=tree_map(lambda v: v.to(dev).requires_grad_(True), m.params.gp),
                            Z=m.params.Z.to(dev).requires_grad_(True))
        loss = m.core.loss(p, GPData(*(v.to(dev) for v in m.data))).sum()
        out[dev] = [loss.detach()] + list(torch.autograd.grad(loss, tree_leaves(p.gp) + [p.Z],
                                                              allow_unused=True))
    (lg, *gg), (lc, *gc) = out["cuda"], out["cpu"]
    return {"seed": seed, "epochs": epochs,
            "loss_rel_err": abs(float(lg) - float(lc)) / abs(float(lc)),
            "grad_err_over_max": [float((g.cpu() - c).abs().max() / c.abs().max())
                                  for g, c in zip(gg, gc) if c is not None]}


def main():
    if not torch.cuda.is_available():
        sys.exit("svgp_grad_probe: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    from hebo_tpu_torch.ops import native

    native.build()
    for seed, epochs in ((0, 20), (1, 20), (2, 20), (0, 30), (0, 50)):
        print(json.dumps(errors(seed, epochs)), flush=True)


if __name__ == "__main__":
    main()
