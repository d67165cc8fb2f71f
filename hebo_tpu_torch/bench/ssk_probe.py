"""Kernel K3 (the SSK Gram, ``csrc/ssk.cu``) alone on a CUDA card.

    python3 hebo_tpu_torch/bench/ssk_probe.py [--root DIR] [--reps 200]

A tool for comparing two checkouts on one card: ``--root`` names the
checkout whose ``hebo_tpu_torch`` is imported (default: this one), so a
parent commit unpacked with ``git archive`` is timed by the same script in
the same call.  ``chip_smoke.py`` times K3 at the AntBO shapes with this
module's ``device_us``; the probe adds a sweep of small cross launches and
one pair (the floor of a launch), BOSS and BOiLS' shapes at L 25 (pest
control, 5 letters: the fit, the one-flip neighbours, the GA's population,
the descents' queries and the self sets) and the route edges at L 12 / 16 /
17 / 32 / 33.  For each shape it prints one JSON line: the wrapper's device µs
per launch (``torch.profiler``: the K3 kernels' summed device time over
``reps`` launches), its max relative error against the plain version, and
the route the kernel took where the package reports one.  The first line is
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

CROSS = [(1, 256, 256, 11, 3), (2, 256, 256, 11, 3), (1, 209, 256, 11, 3), (1, 209, 32, 11, 3),
         (1, 32, 32, 11, 3), (1, 8, 32, 11, 3), (1, 64, 32, 11, 3), (1, 128, 32, 11, 3),
         (1, 1, 256, 11, 3), (1, 1, 1, 11, 3), (1, 256, 256, 12, 3),
         (1, 256, 256, 25, 3), (1, 256, 101, 25, 3), (1, 256, 64, 25, 3), (1, 256, 8, 25, 3),
         (1, 101, 101, 25, 3), (1, 64, 64, 25, 3), (1, 256, 256, 16, 3), (1, 256, 256, 17, 3),
         (1, 256, 256, 32, 3), (1, 256, 256, 33, 3), (1, 256, 256, 9, 5)]
SELF = [(1, 256, 11, 3), (1, 32, 11, 3), (2, 256, 11, 3), (1, 256, 25, 3), (1, 101, 25, 3),
        (1, 64, 25, 3), (1, 8, 25, 3), (1, 256, 32, 3), (1, 256, 33, 3)]


def device_us(torch, fn, reps, key="ssk"):
    """Device µs per launch of the kernels whose name holds ``key`` over
    ``reps`` calls of ``fn`` (after one warm-up call), and their count."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and key in e.name]
    return sum(e.device_time_total for e in ev) / max(len(ev), 1), len(ev)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ssk_probe: needs a CUDA device")
    from hebo_tpu_torch.ops import ssk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "root": args.root}), flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    rel = lambda a, b: ((a - b).abs() / b.abs().clamp(min=1e-6)).max().item()
    for mode, shapes in (("cross", CROSS), ("self", SELF)):
        for shape in shapes:
            B, N = shape[:2]
            M, L, P = shape[2:] if mode == "cross" else (None,) + shape[2:]
            letters = 20 if L <= 11 else 5  # AntBO's amino acids; pest control's 5 options
            s1 = torch.as_tensor(rng.integers(0, letters, (N, L)), dtype=torch.int32, device=dev)
            s2 = None if M is None else torch.as_tensor(rng.integers(0, letters, (M, L)),
                                                        dtype=torch.int32, device=dev)
            lam2 = torch.as_tensor(rng.uniform(0.1, 0.8, B), dtype=torch.float32, device=dev)
            gap = torch.as_tensor(rng.uniform(0.3, 0.9, B), dtype=torch.float32, device=dev)
            if mode == "cross":
                call = lambda: ssk.ssk_cross(s1, s2, lam2, gap, P)
                want = ssk.ssk_cross_plain(s1, s2, lam2, gap, P)
            else:
                call = lambda: ssk.ssk_self(s1, lam2, gap, P)
                want = ssk.ssk_self_plain(s1, lam2, gap, P)
            us, n = device_us(torch, call, args.reps)
            row = {"mode": mode, "shape": list(shape), "device_us": us, "kernels": n,
                   "max_rel_err": max(rel(a, b) for a, b in zip(call(), want))}
            if hasattr(ssk, "route"):  # an older checkout's route() takes no pair count
                try:
                    row["route"] = ssk.route(L, P, B * N * (M or 1))
                except TypeError:
                    row["route"] = ssk.route(L, P)
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
