"""Variants of K2's VJP (``bench/vjp_variants.cu``) against the port's kernel
on a CUDA card.

    python3 hebo_tpu_torch/bench/vjp_probe.py [--reps 100]

The variants, none of them in the port (``vjp_variants.cu`` says what each
changes): 1 and 2 one launch with tickets at 64- and 32-row tiles, 3 and 4
the same tile pass with the port's reduce launch, 5 g loaded before the
distances, 6 the row and column sums through shared memory, 7 and 8 the
port's kernels at 32- and 16-row tiles.  The file
includes ``csrc/gram.cu`` and is built apart into ``hebo_tpu_torch/build/``.
For each shape of chip_smoke's ``check_gram_vjp`` it prints one JSON line:
per variant (and "port", the port's kernel) the error over the plain
version's largest |gradient| on random points and on a self-Gram with
coincident rows, whether two calls give the same bits, and device µs per
call (``torch.profiler``) in the order port, variants, variants reversed,
port.  chip_smoke builds and times none of them: they are built only when
this probe runs.  The first line is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
VARIANTS = {1: "fused 64", 2: "fused 32", 3: "tiles 64", 4: "tiles 32", 5: "g first",
            6: "smem sums", 7: "port rows 32", 8: "port rows 16"}
FUSED_MAX_D = 8  # vjp_variants.cu kFusedD


def build():
    """The variants' library, built with the port's nvcc flags."""
    from hebo_tpu_torch.ops import native

    src = Path(__file__).with_name("vjp_variants.cu")
    text = src.read_bytes() + (native.CSRC / "gram.cu").read_bytes()
    lib = native.BUILD / f"libvjp_variants-{hashlib.sha256(text).hexdigest()[:16]}.so"
    if not lib.exists():
        native.BUILD.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        out = subprocess.run([native._nvcc(), *native.NVCC_FLAGS, "-o", str(tmp), str(src)],
                             capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(f"vjp_variants.cu: nvcc exit {out.returncode}:\n"
                               f"{out.stdout}{out.stderr}")
        os.replace(tmp, lib)
    so = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    so.vjp_variant.argtypes = [I] + [P] * 9 + [I] * 4 + [P]
    so.vjp_variant.restype = I
    for fn in (so.vjp_variant_scratch, so.vjp_variant_counters):
        fn.restype = ctypes.c_longlong
    so.vjp_variant_scratch.argtypes, so.vjp_variant_counters.argtypes = [I] * 5, [I] * 4
    return so


def variants(torch, dev):
    """{name: fn(a, b, sc, g) -> (ga, gb, gsc)} of the variants that take D
    (``VARIANTS``; 1-4 only up to ``FUSED_MAX_D`` features), built here."""
    from hebo_tpu_torch.ops import native

    so = build()
    counters = torch.zeros(1 << 16, dtype=torch.int32, device=dev)

    def run(v, a, b, sc, g):
        B, N, D = a.shape
        M = b.shape[1]
        if so.vjp_variant_counters(B, N, M, v) > counters.numel():
            raise ValueError(f"vjp variant {v}: too many tiles at {(B, N, M, D)}")
        out = torch.empty(B * (N + M) * D + B, dtype=torch.float32, device=dev)
        scratch = torch.empty(so.vjp_variant_scratch(B, N, M, D, v), dtype=torch.float32,
                              device=dev)
        ga, gb, gsc = out.split([B * N * D, B * M * D, B])
        err = native.call(so.vjp_variant, a.device, v, a.data_ptr(), b.data_ptr(), sc.data_ptr(),
                          g.data_ptr(), scratch.data_ptr(), counters.data_ptr(), ga.data_ptr(),
                          gb.data_ptr(), gsc.data_ptr(), B, N, M, D)
        native.check(err, f"vjp variant {v}")
        return ga.view(B, N, D), gb.view(B, M, D), gsc

    return {name: (lambda a, b, sc, g, v=v: run(v, a, b, sc, g)) for v, name in VARIANTS.items()}


def compare(torch, fns, a, b, sc, g, x, reps):
    """{name: {err, same_bits, us}} of each fn(a, b, sc, g) against the plain
    version (on (a, b) and, for a square Gram, the self-Gram of x), two calls'
    bits, and device µs per call in the order fns, fns reversed."""
    from hebo_tpu_torch.bench.gram_probe import device_per_call
    from hebo_tpu_torch.ops import gram

    N, M = a.shape[1], b.shape[1]
    out = {}
    for name, fn in fns.items():
        errs = []
        for p, q in [(a, b)] + ([(x, x)] if N == M else []):
            got, want = fn(p, q, sc, g), gram.matern32_gram_vjp_plain(p, q, sc, g)
            errs += [((u - v).abs().max() / v.abs().max()).item() for u, v in zip(got, want)]
        same = all(torch.equal(u, v) for u, v in zip(fn(a, b, sc, g), fn(a, b, sc, g)))
        out[name] = {"err": max(errs), "same_bits": same, "us": []}
    for name in list(fns) + list(fns)[::-1]:
        fn = fns[name]
        out[name]["us"].append(device_per_call(torch, lambda: fn(a, b, sc, g), reps,
                                               "matern32_vjp")[0])
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--shapes", nargs="+", default=None, metavar="BxNxMxD",
                    help="shapes to time in place of chip_smoke's VJP_SHAPES")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("vjp_probe: needs a CUDA device")
    import chip_smoke
    from hebo_tpu_torch.ops import gram

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    dev = torch.device("cuda")
    var = variants(torch, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = chip_smoke.VJP_SHAPES if args.shapes is None else [
        tuple(int(x) for x in sh.split("x")) for sh in args.shapes]
    for B, N, M, D in shapes:
        a = torch.randn((B, N, D), generator=gen, device=dev)
        b = torch.randn((B, M, D), generator=gen, device=dev)
        sc = torch.rand((B,), generator=gen, device=dev) + 0.5
        g = torch.randn((B, N, M), generator=gen, device=dev)
        x = a * min(1.0, math.sqrt(6.0 / D))
        k = min(8, N // 4)
        x[:, N // 2: N // 2 + k] = x[:, :k]
        x[:, -2 * k:] = 0.0
        fns = {"port": gram.matern32_gram_vjp}
        fns.update({name: fn for v, (name, fn) in enumerate(var.items(), 1)
                    if v > 4 or D <= FUSED_MAX_D})
        print(json.dumps({"shape": [B, N, M, D], **compare(torch, fns, a, b, sc, g, x, args.reps)}),
              flush=True)


if __name__ == "__main__":
    main()
