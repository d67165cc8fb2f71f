"""Kernel K2 (the Matérn-3/2 Gram, ``csrc/gram.cu``) and its gradient alone
on a CUDA card.

    python3 hebo_tpu_torch/bench/gram_probe.py [--root DIR] [--reps 200]

A tool for comparing two checkouts on one card: ``--root`` names the
checkout whose ``hebo_tpu_torch`` is imported (default: this one), so a
parent commit unpacked with ``git archive`` is timed by the same script in
the same call.  ``chip_smoke.py`` and ``profile_suggest`` import
``device_per_call``.  For each (B, N, M, D) it prints one JSON line:

* the forward: device µs per launch of the kernels whose name holds
  ``matern32_gram`` (``torch.profiler`` over ``reps`` calls) and its max
  abs error against the plain version;
* the backward, as the fit runs it (``torch.autograd.grad`` of the Gram
  with respect to a, b and sc): every device launch it makes and their
  summed device µs, per backward call (and each K2 VJP kernel's µs), and
  its max abs error over the largest |gradient| of autograd of the plain
  form.

The first line is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

SHAPES = [(2, 1024, 1024, 6), (1, 1024, 1024, 6), (2, 128, 128, 6), (1, 1024, 100, 6),
          (1, 128, 100, 6), (2, 1000, 1000, 6), (2, 256, 256, 20),
          # the samplers' and the large-N fit's VJPs, and the paths' small ones
          (4, 1024, 1024, 6), (32, 1024, 1024, 6), (2, 2048, 2048, 6), (1, 1024, 1024, 8),
          (4, 128, 128, 6), (1, 256, 256, 3), (1, 256, 256, 19), (1, 256, 8, 19),
          (1, 256, 256, 30), (1, 64, 8, 6), (1, 64, 1, 6), (1, 32, 3072, 6), (2, 64, 64, 6)]


def device_by_name(torch, fn, reps):
    """{device event name: (mean device µs per launch, launches per call)}
    of ``fn`` over ``reps`` calls, by ``torch.profiler`` after one warm-up
    round (the profiler's own warm-up step, then ``reps`` calls)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=acts, schedule=sched) as prof:
        for _ in range(2):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
    acc = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us, n = acc.get(e.name, (0.0, 0))
            acc[e.name] = (us + e.device_time_total, n + 1)
    return {k: (us / n, n / reps) for k, (us, n) in acc.items()}


def device_per_call(torch, fn, reps, key=None):
    """Device µs and device launches per call of ``fn``, over the device
    events whose name holds ``key`` (all where ``key`` is None).  The time
    is each kernel's mean µs per launch times its launches per call, rounded
    to a whole number, so an event that the profiler drops now and then
    does not lower it; the launches are as counted."""
    ev = [v for k, v in device_by_name(torch, fn, reps).items() if key is None or key in k]
    return sum(us * max(1, round(n)) for us, n in ev), sum(n for _, n in ev)


def inputs(torch, rng, B, N, M, D, dev):
    """a, b scaled like a fit's 1/ℓ-scaled features, sc, and a cotangent g."""
    t = lambda *s: torch.as_tensor(rng.standard_normal(s).astype(np.float32), device=dev)
    sc = torch.as_tensor(rng.uniform(0.5, 1.5, B).astype(np.float32), device=dev)
    return t(B, N, D), t(B, M, D), sc, t(B, N, M)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("gram_probe: needs a CUDA device")
    from hebo_tpu_torch.ops import gram

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "root": args.root}), flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for B, N, M, D in SHAPES:
        a, b, sc, g = inputs(torch, rng, B, N, M, D, dev)
        fwd_us, _ = device_per_call(torch, lambda: gram.matern32_gram(a, b, sc, 1e-3), args.reps,
                                    "matern32_gram")
        fwd_err = (gram.matern32_gram(a, b, sc, 1e-3)
                   - gram.matern32_gram_plain(a, b, sc, 1e-3)).abs().max().item()
        leaves = [t.clone().requires_grad_(True) for t in (a, b, sc)]
        K = gram.matern32_gram(*leaves)
        bwd = lambda: torch.autograd.grad(K, leaves, g, retain_graph=True)
        by_name = device_by_name(torch, bwd, args.reps)
        bwd_us = sum(us * max(1, round(n)) for us, n in by_name.values())
        bwd_launches = sum(n for _, n in by_name.values())
        split = {k.split("(")[0].split("::")[-1].split("<")[0]: us
                 for k, (us, _) in by_name.items() if "matern32" in k}
        K0 = gram.matern32_gram_plain(*leaves)
        want = torch.autograd.grad(K0, leaves, g)
        bwd_err = max(((x - y).abs().max() / y.abs().max()).item() for x, y in zip(bwd(), want))
        print(json.dumps({"shape": [B, N, M, D], "fwd_device_us": fwd_us, "fwd_max_abs_err": fwd_err,
                          "bwd_device_us": bwd_us, "bwd_launches": bwd_launches,
                          "bwd_split_us": split, "bwd_err_over_max": bwd_err}), flush=True)


if __name__ == "__main__":
    main()
