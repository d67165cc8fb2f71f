"""Kernel K5 (NSGA-II rank and crowding, ``csrc/pareto.cu``) alone on a CUDA card.

    python3 hebo_tpu_torch/bench/pareto_probe.py [--root DIR] [--reps 200] [--no-phases]
                                                 [--suggest N ...] [--threads T]

A tool for comparing two checkouts on one card: ``--root`` names the
checkout whose ``hebo_tpu_torch`` is imported (default: this one), so a
parent commit unpacked with ``git archive`` is timed by the same script in
the same call.  For each shape (P, M) of the NSGA-II loops, on
standard-normal objectives, for the chain inputs at M = 2 and 3 (row i is
(i, i, ...), so every point is its own front) and for one front (rows on
the simplex, none dominating another, as late NSGA-II generations hold),
it prints one JSON line:

* ``k5_us``: device µs per launch of the kernel (``torch.profiler``, the
  device events whose name holds ``nsga2_rank_crowd``, over ``reps``
  calls), the same with a matmul and an add before each launch
  (``k5_after_other_kernels_us``: the instruction cache as HEBO's graph
  leaves it), and the number of fronts;
* one NSGA-II generation's sorts as the checkout's callers run them: the
  tournament (``nsga2_key`` of K5's output at (P, M)) and survival (a stable
  argsort of the key of (2P, M), first P), each as the device µs per call
  of every kernel but K5 and, apart, of the kernels whose name holds
  "sort"; where the checkout has ``nsga2_select``, the same two calls
  through it;
* with ``--suggest N``, first, HEBO's ``suggest(8)`` on Ackley-6D after N
  Sobol observations (the fused graph): a SHA-256 of the suggestion's
  values, to compare two checkouts' suggestions;
* ``phases`` (unless ``--no-phases``): a copy of the checkout's
  ``pareto.cu`` with a ``clock64()`` stamp by thread 0 at the kernel's
  entry, after each ``__syncthreads();`` and at its end, built apart into
  ``hebo_tpu_torch/build/`` and launched three times through the
  checkout's own wrapper (``nsga2_select(F, P // 2)`` where the checkout
  has it), the stamps of the last (warm instruction cache); the cycles
  between consecutive stamps, summed by (from line, to line) of the source
  with their count, and the total.  The shipped
  kernel carries no stamp.

With ``--threads T`` every time and stamp comes from a copy built with a
CTA of T threads.  The first line is the card's name, power limit and SM
clocks.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

SHAPES = [(100, 3), (200, 3), (100, 1), (200, 1), (100, 2), (200, 2), (64, 1), (128, 1),
          (100, 4), (200, 4)]
CHAINS = [(200, 2), (200, 3)]
FRONTS = [(100, 3), (200, 3), (200, 2)]

_HOOKS = r"""
__device__ long long g_probe_t[8192];
__device__ int g_probe_site[8192];
__device__ int g_probe_n;
#define PROBE_STAMP(site) do { if (threadIdx.x == 0 && g_probe_n < 8192) { \
  g_probe_site[g_probe_n] = (site); g_probe_t[g_probe_n] = clock64(); ++g_probe_n; } } while (0)
"""

_ENTRY = r"""
extern "C" int probe_reset() {
  int zero = 0;
  return (int)cudaMemcpyToSymbol(g_probe_n, &zero, sizeof(int));
}
extern "C" int probe_read(long long* t, int* site, int* n) {
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(n, g_probe_n, sizeof(int));
  cudaMemcpyFromSymbol(t, g_probe_t, 8192 * sizeof(long long));
  cudaMemcpyFromSymbol(site, g_probe_site, 8192 * sizeof(int));
  return (int)cudaGetLastError();
}
"""


def instrument(src: str) -> str:
    """``src`` with a stamp at the ``__global__`` kernel's entry (site 0),
    after every ``__syncthreads();`` (site = its line) and before the
    kernel's closing brace (site -1)."""
    lines = src.split("\n")
    out = []
    for n, line in enumerate(lines, 1):
        if re.search(r"(^|[;{}\s])__syncthreads\(\);", line):
            line = line.replace("__syncthreads();", f"__syncthreads(); PROBE_STAMP({n});")
        out.append(line)
    src = "\n".join(out)
    g = src.index("__global__")
    body = src.index("{", src.index(")", src.index("(", g)))
    depth, end = 0, body
    for end in range(body, len(src)):
        depth += {"{": 1, "}": -1}.get(src[end], 0)
        if depth == 0:
            break
    src = (src[:body + 1] + " PROBE_STAMP(0);" + src[body + 1:end] + " PROBE_STAMP(-1);\n"
           + src[end:])
    ns = src.index("namespace {")
    return src[:ns + len("namespace {")] + _HOOKS + src[ns + len("namespace {"):] + _ENTRY


def build_probe(native, stamps=True, threads=None):
    """The checkout's ``pareto.cu``, with the stamps (``instrument``) and/or
    its CTA's thread count set to ``threads``, built apart."""
    src = (native.CSRC / "pareto.cu").read_text()
    if threads is not None:
        src, n = re.subn(r"constexpr int kThreads = \d+;",
                         f"constexpr int kThreads = {threads};", src)
        if n != 1:
            raise SystemExit("pareto_probe: pareto.cu has no kThreads constant")
    tag = f"{'stamps' if stamps else 'plain'}_{threads or 'as_built'}"
    if stamps:
        src = instrument(src)
    native.BUILD.mkdir(parents=True, exist_ok=True)
    cu, so = native.BUILD / f"pareto_probe_{tag}.cu", native.BUILD / f"libpareto_probe_{tag}.so"
    cu.write_text(src)
    flags = [f for f in native.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([native._nvcc(), *flags, "-o", str(so), str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in native.SIGNATURES["pareto"].items():
        f = getattr(lib, fn)
        f.argtypes, f.restype = argtypes, ctypes.c_int
    if stamps:
        lib.probe_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    return lib


class _Using:
    """The checkout's wrappers launch from ``lib`` (None: the built one)
    while open."""

    def __init__(self, native, lib):
        self.native, self.lib = native, lib

    def __enter__(self):
        self.saved = self.native._loaded.get("pareto")
        if self.lib is not None:
            self.native._loaded["pareto"] = self.lib

    def __exit__(self, *exc):
        if self.saved is None:
            self.native._loaded.pop("pareto", None)
        else:
            self.native._loaded["pareto"] = self.saved


def phases(torch, native, pareto, lib, F, warm=3):
    """The instrumented kernel through the checkout's wrapper, ``warm``
    launches (the stamps of the last, with warm caches):
    {"from-to": [cycles, count]} between consecutive stamps, and the total."""
    call = ((lambda: pareto.nsga2_select(F, F.shape[0] // 2)) if hasattr(pareto, "nsga2_select")
            else (lambda: pareto.nsga2_rank_crowd(F)))
    with _Using(native, lib):
        for _ in range(warm):
            torch.cuda.synchronize()
            native.check(lib.probe_reset(), "probe_reset")
            call()
        t, site, n = (ctypes.c_longlong * 8192)(), (ctypes.c_int * 8192)(), ctypes.c_int()
        native.check(lib.probe_read(t, site, ctypes.byref(n)), "probe_read")
    stamps = [(site[k], t[k]) for k in range(n.value)]
    seg = {}
    for (s0, t0), (s1, t1) in zip(stamps, stamps[1:]):
        c, k = seg.get(f"{s0}-{s1}", (0, 0))
        seg[f"{s0}-{s1}"] = (c + t1 - t0, k + 1)
    return {"stamps": len(stamps), "total_cycles": stamps[-1][1] - stamps[0][1],
            "segments": {k: [c, k2] for k, (c, k2) in seg.items()}}


def device_us(torch, fn, reps, keep):
    """Device µs per call of ``fn`` summed over the kernels whose name passes
    ``keep``, and their launches per call (``torch.profiler``, after one
    warm-up call)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and keep(e.name)]
    return sum(e.device_time_total for e in ev) / reps, len(ev) / reps


def generation(torch, pareto, F1, F2, reps):
    """The sorts around K5 in one generation: tournament key at F1 (P, M),
    survival order at F2 (2P, M)."""
    P = F1.shape[0]
    not_k5 = lambda n: "nsga2_rank_crowd" not in n
    is_sort = lambda n: "sort" in n.lower()
    tour = lambda: pareto.nsga2_key(*pareto.nsga2_rank_crowd(F1))
    surv = lambda: torch.argsort(pareto.nsga2_key(*pareto.nsga2_rank_crowd(F2)), stable=True)[:P]
    row = {}
    for name, fn in (("tournament", tour), ("survival", surv)):
        us, n = device_us(torch, fn, reps, not_k5)
        sus, sn = device_us(torch, fn, reps, is_sort)
        row[name] = {"other_us": us, "other_launches": n, "sort_us": sus, "sort_launches": sn}
    if hasattr(pareto, "nsga2_select"):
        for name, fn in (("tournament_select", lambda: pareto.nsga2_select(F1)[2]),
                         ("survival_select", lambda: pareto.nsga2_select(F2, P)[3])):
            us, n = device_us(torch, fn, reps, lambda n: True)
            sus, sn = device_us(torch, fn, reps, is_sort)
            row[name] = {"all_us": us, "launches": n, "sort_us": sus, "sort_launches": sn}
    return row


def suggestion_sha(n_obs):
    """SHA-256 of HEBO's suggest(8) on Ackley-6D after ``n_obs`` Sobol
    observations, on the card's graph path."""
    import hashlib
    import math

    import numpy as np
    from hebo_tpu_torch import HEBO, DesignSpace

    space = DesignSpace([{"name": f"x{i}", "type": "num", "lb": -32.768, "ub": 32.768}
                         for i in range(6)])

    def ackley(df):
        X = df[[f"x{i}" for i in range(6)]].values.astype(float)
        s1, s2 = (X ** 2).mean(1) ** 0.5, np.cos(2 * math.pi * X).mean(1)
        return (-20.0 * np.exp(-0.2 * s1) - np.exp(s2) + 20.0 + math.e).reshape(-1, 1)

    opt = HEBO(space, device="cuda")
    warm = space.inverse_transform(space.sobol_sample_opt(n_obs, seed=1))
    opt.observe(warm, ackley(warm))
    rec = opt.suggest(8)
    opt.observe(rec, ackley(rec))
    rec = opt.suggest(8)  # the replayed graph
    vals = np.ascontiguousarray(rec.values.astype(np.float64))
    return hashlib.sha256(vals.tobytes()).hexdigest(), vals[0].tolist()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--no-phases", action="store_true")
    ap.add_argument("--suggest", type=int, nargs="*", default=[])
    ap.add_argument("--threads", type=int, default=None,
                    help="time (and stamp) a copy built with this CTA size instead")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("pareto_probe: needs a CUDA device")
    from hebo_tpu_torch.ops import native, pareto

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(json.dumps({"card": smi.stdout.strip(), "root": args.root}), flush=True)
    for n_obs in args.suggest:
        sha, first = suggestion_sha(n_obs)
        print(json.dumps({"suggest": n_obs, "sha256": sha, "first_row": first}), flush=True)
    dev = torch.device("cuda")
    lib = None if args.no_phases else build_probe(native, threads=args.threads)
    timed = None if args.threads is None else build_probe(native, False, args.threads)
    cases = ([(P, M, None) for P, M in SHAPES] + [(P, M, "chain") for P, M in CHAINS]
             + [(P, M, "one front") for P, M in FRONTS])
    for P, M, kind in cases:
        if kind == "chain":
            F = torch.arange(P, dtype=torch.float32, device=dev)[:, None].repeat(1, M)
            F = F[torch.randperm(P, generator=torch.Generator().manual_seed(P)).to(dev)]
        elif kind == "one front":  # on the simplex: no point dominates another
            E = -torch.rand((P, M), generator=torch.Generator(device=dev).manual_seed(P),
                            device=dev).log()
            F = E / E.sum(1, keepdim=True)
        else:
            F = torch.randn((P, M), generator=torch.Generator(device=dev).manual_seed(P),
                            device=dev)
        with _Using(native, timed):
            k5 = lambda name: "nsga2_rank_crowd" in name
            us, n = device_us(torch, lambda: pareto.nsga2_rank_crowd(F), args.reps, k5)
            # each launch after a matmul and an add, as inside HEBO's graph,
            # where other kernels' code has left the instruction cache
            A = torch.randn((512, 512), device=dev)
            cold, _ = device_us(torch, lambda: (A @ A + 1.0, pareto.nsga2_rank_crowd(F)),
                                args.reps, k5)
            rank, _ = pareto.nsga2_rank_crowd(F)
            row = {"shape": [P, M], "input": kind or "normal", "threads": args.threads, "k5_us": us,
                   "k5_after_other_kernels_us": cold, "k5_launches": n,
                   "fronts": int(rank.max().item()) + 1}
            if kind is None and P in (64, 100):
                g2 = torch.Generator(device=dev).manual_seed(2 * P + 1)
                F2 = torch.randn((2 * P, M), generator=g2, device=dev)
                row["generation"] = generation(torch, pareto, F, F2, args.reps)
        if lib is not None:
            row["phases"] = phases(torch, native, pareto, lib, F)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
