"""Where kernel K1 (``csrc/chol.cu``) spends its time on a CUDA card.

    python3 hebo_tpu_torch/bench/chol_probe.py [--root DIR] [--only shapes|winv] [--shapes BxN ...]
    python3 hebo_tpu_torch/bench/chol_probe.py --variants [factor|winv]
    python3 hebo_tpu_torch/bench/chol_probe.py --winv-timeline

1. For each (B, N) of the main paths and of the routes' edges: the routes
   K1a and K1b take there, ``chol_factor`` on each of its routes (forced)
   and on its own and ``chol_winv`` on the size's route, against
   ``torch.linalg.cholesky_ex`` / ``solve_triangular`` (ms per call, CUDA
   events over back-to-back calls); from calls under ``torch.profiler``,
   each device kernel's launches per call and device µs per launch, for a
   factoring call and for a skipped one (every matrix's flag set, as on the
   jitter ladder's later rungs), per route.
2. The tile factor's phases: an instrumented copy of ``chol.cu`` (a
   ``clock64()`` stamp by thread 0 at the start of ``factor_tile`` and
   after each of its CTA barriers) is built apart into
   ``hebo_tpu_torch/build/`` and run on one 64×64 tile; prints the cycle
   offsets, three times.
3. K1a's flow route's timeline at (1, 2048) and (1, 5051): another
   instrumented copy stamps ``%globaltimer`` per task (start, sums done,
   the diagonal task's chain inputs there, published); prints, per range
   of columns, the mean step between two diagonal tasks' ends and where
   the diagonal task of column k stood against the end of column k - 1's
   (started, sums done, inputs there; the subdiagonal sum's end), and the
   tasks in flight at nine points of the run.
4. With ``--variants`` (in place of parts 1-3): K1a's flow route against
   variants of itself, or with ``--variants winv`` K1b's.  Each variant is
   ``chol.cu`` with text substitutions (``VARIANTS``, ``WINV_VARIANTS``),
   all built at once apart into
   ``hebo_tpu_torch/build/`` and timed on the flow route at
   ``VARIANT_SHAPES`` in turns with the source as it is ("base": base,
   variants, variants in reverse, base).  Prints each variant's ptxas
   registers and spills of the flow kernel, its max abs error against the
   plain version at (1, 1000) and whether two launches give the same bits,
   then one JSON line per shape.
5. With ``--winv-timeline`` (in place of parts 1-3): K1b's flow route with
   a ``%globaltimer`` stamp per task at (1, 5051) and (2, 1024)
   (``winv_timeline``).

``--root`` names the checkout whose ``hebo_tpu_torch`` is imported
(default: this one), so a parent commit unpacked with ``git archive`` is
timed by the same script in the same call; a checkout whose K1a has one
route is timed on it, and one whose K1b has no ``winv_route`` (the
recursive doubling it had before its flow route) names K1b's route
"doubling".  ``--only shapes`` skips parts 2 and 3, ``--only
winv`` also times K1b alone in part 1; ``--shapes`` times other shapes than
``SHAPES`` in part 1 (e.g. ``2x128 16x24``).
Prints JSON lines, the card's name and power limit first; needs a CUDA card
and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

# the main paths' K1 shapes, BOCS's Gibbs sweep (1, 5051), K1a's route edge
# (nt 7 / 8: N 448 / 512) and large batches of small and middling sizes
SHAPES = [(1, 32), (1, 128), (2, 128), (1, 256), (24, 256), (64, 256), (1, 448), (2, 448), (1, 512),
          (2, 512), (1, 704),
          (1, 768), (2, 768), (1, 1024), (2, 1024), (4, 1024), (32, 1024), (128, 1024), (2, 2048),
          (1, 3072), (2, 3072), (1, 4096), (1, 5051)]

# part 4: the flow routes' shapes timed against their variants
VARIANT_SHAPES = [(2, 1024), (32, 1024), (2, 2048), (1, 3072), (1, 5051)]

_WAIT3 = """__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n <= 0) cp_async_wait<0>();
  else if (n == 1) cp_async_wait<1>();
  else cp_async_wait<2>();
}"""

# name: [(text in chol.cu, its replacement), ...]
# * two_ctas: two CTAs an SM (ptxas caps a thread at 128 registers);
# * stages3: three panel stages in flight instead of two;
# * column_order: tickets column by column, the diagonal first, without
#   the diagonal chain's two columns of look-ahead;
# * no_products / no_panel_loads: the panel loop without its products /
#   its panel copies; both give wrong factors and show what each part of
#   the loop costs against the chain.
VARIANTS = {
    "two_ctas": [("__launch_bounds__(kThreads, 1)\nchol_flow", "__launch_bounds__(kThreads, 2)\nchol_flow")],
    "stages3": [("constexpr int kFlowStages = 2;", "constexpr int kFlowStages = 3;"),
                ("""__device__ __forceinline__ void cp_async_wait_upto(int n) {
  static_assert(kFlowStages == 2, "cp_async_wait_upto covers n < 2");
  if (n <= 0) cp_async_wait<0>();
  else cp_async_wait<1>();
}""", _WAIT3)],
    "column_order": [("""    if (i < 3) {  // ticket -> (i, k): see the task order above
      k = i >> 1;
      i = i > 0;
    } else {
      int c = 0, r = i - 3;
      while (r >= nt - c) r -= nt - c++;
      i = r < 3 ? c + 2 : c + r;
      k = r < 3 ? c + r : c;
    }""", """    while (i >= nt - k) i -= nt - k++;
    i += k;""")],
    "no_products": [("      mma_nt_8x8(P, diag ? P : P + TILE_F, acc, gy, gx, 16 * g);\n", "")],
    "no_panel_loads": [("""  load_tile_async(P, Lb + i * ldt + j * T, Np);
  if (i != k) load_tile_async(Q, Lb + k * ldt + j * T, Np);
  cp_async_commit();""", "  cp_async_commit();")],
}

_FENCED_PUBLISH = [("  if (threadIdx.x == 0) st_release(flag, v);",
                    "  if (threadIdx.x == 0) {\n    __threadfence();\n    st_release(flag, v);\n  }")]

# `--variants winv`: K1b's flow route against variants of itself
# * two_ctas: as above, for winv_flow;
# * fenced_publish: a __threadfence before the release store (both flow
#   kernels).
WINV_VARIANTS = {
    "two_ctas": [("__launch_bounds__(kThreads, 1)\nwinv_flow", "__launch_bounds__(kThreads, 2)\nwinv_flow")],
    "fenced_publish": _FENCED_PUBLISH,
}


def _ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _kernels_per_call(torch, fn, calls=5):
    """{kernel name: [launches per call, device µs per launch]}."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.split("::")[-1].split("(")[0]
            n, us = by.get(name, (0, 0.0))
            by[name] = (n + 1, us + e.device_time_total)
    return {k: [n / calls, round(us / n, 2)] for k, (n, us) in by.items()}


def _summary(per_kernel):
    """Launches per call and device µs per call over the K1 kernels."""
    k1 = {k: v for k, v in per_kernel.items() if "chol_" in k or "winv_" in k}
    return {"launches": sum(n for n, _ in k1.values()),
            "device_us": round(sum(n * us for n, us in k1.values()), 2), "kernels": k1}


def shapes(torch, ck, todo=SHAPES, winv_only=False):
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    routes = getattr(ck, "ROUTES", ())
    for B, N in todo:
        A = torch.randn((B, N, N), generator=gen, device=dev)
        K = (A @ A.transpose(1, 2) / N + 0.5 * torch.eye(N, device=dev)).contiguous()
        L, Wd = ck.chol_factor(K)
        W = ck.chol_winv(L, Wd)
        eye = torch.eye(L.shape[-1], device=dev).expand_as(L)
        reps = 200 if N <= 256 else 20 if N <= 1024 else 5
        skip = torch.ones(B, dtype=torch.int32, device=dev)
        jit = torch.zeros(B, device=dev)
        out = (L.clone(), Wd.clone())
        row = {"shape": [B, N], "route": ck.route(N) if routes else "step",
               "winv_route": ck.winv_route(N) if hasattr(ck, "winv_route") else "doubling"}
        if not winv_only:
            row["chol_factor_ms"] = _ms(torch, lambda: ck.chol_factor(K), reps)
            for r in routes:
                row[f"chol_factor_{r}_ms"] = _ms(torch, lambda: ck.chol_factor(K, route=r), reps)
                row[f"chol_factor_{r}_device_us"] = _summary(
                    _kernels_per_call(torch, lambda: ck.chol_factor(K, route=r)))["device_us"]
            row.update(
                cholesky_ex_ms=_ms(torch, lambda: torch.linalg.cholesky_ex(K), reps),
                chol_factor_per_call=_summary(_kernels_per_call(torch, lambda: ck.chol_factor(K))),
                skipped_per_call=_summary(_kernels_per_call(
                    torch, lambda: ck.chol_factor(K, jit, skip, out=out))))
        row.update(
            chol_winv_ms=_ms(torch, lambda: ck.chol_winv(L, Wd), reps),
            solve_triangular_ms=_ms(torch, lambda: torch.linalg.solve_triangular(L, eye, upper=False), reps),
            chol_winv_per_call=_summary(_kernels_per_call(torch, lambda: ck.chol_winv(L, Wd))),
            chol_winv_skipped_per_call=_summary(_kernels_per_call(
                torch, lambda: ck.chol_winv(L, Wd, skip, out=W))),
        )
        print(json.dumps(row), flush=True)


_HOOKS = """
__device__ long long g_stamp[64];
__device__ int g_nstamp;
#define STAMP() do { if (threadIdx.x == 0) g_stamp[g_nstamp++] = clock64(); } while (0)
"""

_ENTRY = """
extern "C" int probe_tile(const float* K, float* L, float* Wd, long long* out, int* n) {
  int zero = 0;
  cudaMemcpyToSymbol(g_nstamp, &zero, sizeof(int));
  chol_first<<<dim3(1, 1), kThreads>>>(K, nullptr, nullptr, L, Wd, L, 64, 64);
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(out, g_stamp, 64 * sizeof(long long));
  cudaMemcpyFromSymbol(n, g_nstamp, sizeof(int));
  return (int)cudaGetLastError();
}
"""


def _build(native, sources):
    """{name: (library, nvcc's log)} for {name: CUDA source}: one nvcc each,
    all started at once, into ``hebo_tpu_torch/build/``; K1's C ABI bound."""
    native.BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cu, so = native.BUILD / f"{name}.cu", native.BUILD / f"lib{name}.so"
        cu.write_text(src)
        procs[name] = (so, subprocess.Popen([native._nvcc(), *native.NVCC_FLAGS, "-o", str(so), str(cu)],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"chol_probe {name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(so))
        for f, argtypes in native.SIGNATURES["chol"].items():
            getattr(lib, f).argtypes = argtypes
            getattr(lib, f).restype = ctypes.c_int
        out[name] = (lib, log)
    return out


def _substitute(src, subs, what):
    for old, new in subs:
        if src.count(old) != 1:
            raise RuntimeError(f"chol_probe {what}: no single {old[:60]!r} in chol.cu")
        src = src.replace(old, new)
    return src


def phases(torch, native):
    src = (native.CSRC / "chol.cu").read_text()
    a = src.index("__device__ void factor_tile")
    b = src.index("// Store a factored tile")
    body = src[a:b].replace("__syncthreads();", "__syncthreads(); STAMP();")
    body = body.replace("tx = t & 15, ty = t >> 4;\n", "tx = t & 15, ty = t >> 4;\n  STAMP();\n", 1)
    src = src[:a] + body + src[b:]
    src = src.replace("namespace {", "namespace {" + _HOOKS, 1) + _ENTRY
    lib = _build(native, {"chol_probe": src})["chol_probe"][0]
    A = torch.randn(64, 64, device="cuda", generator=torch.Generator(device="cuda").manual_seed(1))
    K = (A @ A.T / 64 + 0.5 * torch.eye(64, device="cuda")).contiguous()
    L = torch.empty(64, 64, device="cuda")
    Wd = torch.empty(64, 64, device="cuda")
    out, n = (ctypes.c_longlong * 64)(), ctypes.c_int()
    for _ in range(3):
        err = lib.probe_tile(ctypes.c_void_p(K.data_ptr()), ctypes.c_void_p(L.data_ptr()),
                             ctypes.c_void_p(Wd.data_ptr()), out, ctypes.byref(n))
        native.check(err, "chol_probe")
        stamps = list(out)[: n.value]
        print(json.dumps({"factor_tile_cycles_at_barriers": [s - stamps[0] for s in stamps],
                          "L_max_abs_err": (L - torch.linalg.cholesky(K)).abs().max().item()}),
              flush=True)


_TIMER = """
__device__ long long* g_task_stamps;
__device__ __forceinline__ long long global_ns() {
  long long v;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));
  return v;
}
#define STAMP(s) do { if (threadIdx.x == 0) g_task_stamps[((size_t)b * n_tasks + ticket) * 4 + (s)] = global_ns(); } while (0)
"""

# (text in chol_flow, the same text with a stamp): 0 the task starts, 1 its
# sums are done, 2 the diagonal task's chain inputs are there, 3 published
_TASK_STAMPS = [
    ("    int k = 0, i = s_task;\n", "    int k = 0, i = s_task;\n    const int ticket = i;\n"),
    ("    const bool diag = i == k;\n", "    const bool diag = i == k;\n    STAMP(0);\n"),
    ("    cp_async_wait<0>();\n    __syncthreads();  // every product done, C landed",
     "    STAMP(1);\n    cp_async_wait<0>();\n    __syncthreads();  // every product done, C landed"),
    ("        wait_cols(rows, k - 1, k - 1, k - 1, h0, h1);  // Wd_{k-1} stored\n      }\n",
     "        wait_cols(rows, k - 1, k - 1, k - 1, h0, h1);  // Wd_{k-1} stored\n      }\n      STAMP(2);\n"),
    ("publish(rows + k, k + 1);", "publish(rows + k, k + 1);\n      STAMP(3);"),
    ("publish(subs + i, 1);", "publish(subs + i, 1);\n      STAMP(3);"),
    ("publish(rows + i, k + 1);", "publish(rows + i, k + 1);\n      STAMP(3);"),
]


def timeline(torch, native, ck):
    import numpy as np

    src = _substitute((native.CSRC / "chol.cu").read_text(), _TASK_STAMPS, "timeline")
    src = src.replace("namespace {", "namespace {" + _TIMER, 1) + (
        '\nextern "C" int probe_set_stamps(void* p) {\n'
        "  return (int)cudaMemcpyToSymbol(g_task_stamps, &p, sizeof(p));\n}\n")
    lib = _build(native, {"chol_timeline": src})["chol_timeline"][0]
    lib.probe_set_stamps.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2)
    for N in (2048, 5051):
        A = torch.randn((1, N, N), generator=gen, device=dev)
        K = (A @ A.transpose(1, 2) / N + 0.5 * torch.eye(N, device=dev)).contiguous()
        Np = ck.padded_size(N)
        nt = Np // ck.TILE
        n_tasks = nt * (nt + 1) // 2
        stamps = torch.zeros(n_tasks * 4, dtype=torch.int64, device=dev)
        native.check(lib.probe_set_stamps(stamps.data_ptr()), "chol_probe timeline")
        L = torch.empty((1, Np, Np), device=dev)
        Wd = torch.empty((1, nt, ck.TILE, ck.TILE), device=dev)
        sync = torch.empty(2 * nt + 1, dtype=torch.int32, device=dev)

        def call():
            native.check(native.call(lib.hebo_chol_factor, dev, K.data_ptr(), None, None, L.data_ptr(),
                                     Wd.data_ptr(), sync.data_ptr(), 1, 1, N, Np), "chol_probe timeline")

        for _ in range(3):
            call()
        torch.cuda.synchronize()
        S = stamps.view(n_tasks, 4).cpu().numpy().astype(np.float64) / 1e3  # µs
        S -= S[:, 0].min()
        task = {ik: t for t, ik in enumerate(ck._flow_tasks(nt))}  # (i, k) -> ticket
        end = np.array([S[task[k, k], 3] for k in range(nt)])
        cols = []
        for k in range(1, nt):
            d = S[task[k, k]]
            cols.append(dict(k=k, step=end[k] - end[k - 1], started=d[0] - end[k - 1],
                             sums_done=d[1] - end[k - 1], inputs=d[2] - end[k - 1],
                             sub_done=S[task[k, k - 1], 3] - end[k - 1], chain=end[k] - d[2]))
        busy = float((S[:, 3] - S[:, 0]).sum())
        total = float(S[:, 3].max())
        print(json.dumps({"timeline": [1, N], "tasks": n_tasks, "span_us": round(total, 2),
                          "task_us_sum": round(busy, 2)}), flush=True)
        for lo, hi in ((1, 10), (10, 20), (20, 40), (40, 60), (60, nt)):
            sel = [c for c in cols if lo <= c["k"] < hi]
            if sel:
                print(json.dumps({"columns": [lo, hi], **{f: round(float(np.mean([c[f] for c in sel])), 2)
                                                          for f in cols[0] if f != "k"}}), flush=True)
        at = np.linspace(0, total, 11)[1:-1]
        print(json.dumps({"tasks_in_flight": [int(((S[:, 0] <= x) & (S[:, 3] > x)).sum()) for x in at]}),
              flush=True)


# (text in winv_flow, the same text with a stamp): 0 the task starts, 1 its
# sum's products are done, 2 the sum is reduced, 3 W_ik stored and published
# (for a diagonal task, W_ii copied)
_WINV_STAMPS = [
    ("    const int k = ticket - i * (i + 1) / 2;\n", "    const int k = ticket - i * (i + 1) / 2;\n    STAMP(0);\n"),
    ("      __syncthreads();  // every thread has read s_ticket\n",
     "      __syncthreads();  // every thread has read s_ticket\n      STAMP(3);\n"),
    ("    cp_async_wait<0>();\n    __syncthreads();  // every product done, Wd_i landed",
     "    STAMP(1);\n    cp_async_wait<0>();\n    __syncthreads();  // every product done, Wd_i landed"),
    ("    {  // W_ik = -Wd_i S;", "    STAMP(2);\n    {  // W_ik = -Wd_i S;"),
    ("    publish(cols + k, i - k);\n", "    publish(cols + k, i - k);\n    STAMP(3);\n"),
]


def winv_timeline(torch, native, ck, todo=((1, 5051), (2, 1024))):
    """K1b's flow route with a ``%globaltimer`` stamp per task (see
    ``_WINV_STAMPS``): per shape the span, the CTAs' busy share, µs per
    term of the sums by row range, the sums' reduction and the Wd product's
    µs a task, the column-0 chain's step, and the tasks in flight at nine
    points of the run."""
    import numpy as np

    src = _substitute((native.CSRC / "chol.cu").read_text(), _WINV_STAMPS, "winv timeline")
    src = src.replace("namespace {", "namespace {" + _TIMER, 1) + (
        '\nextern "C" int probe_set_stamps(void* p) {\n'
        "  return (int)cudaMemcpyToSymbol(g_task_stamps, &p, sizeof(p));\n}\n")
    lib = _build(native, {"winv_timeline": src})["winv_timeline"][0]
    lib.probe_set_stamps.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    for B, N in todo:
        A = torch.randn((B, N, N), generator=gen, device=dev)
        L, Wd = ck.chol_factor((A @ A.transpose(1, 2) / N + 0.5 * torch.eye(N, device=dev)).contiguous())
        Np = L.shape[-1]
        nt = Np // ck.TILE
        n_tasks = nt * (nt + 1) // 2
        stamps = torch.zeros(B * n_tasks * 4, dtype=torch.int64, device=dev)
        native.check(lib.probe_set_stamps(stamps.data_ptr()), "chol_probe winv timeline")
        W = torch.empty_like(L)
        sync = torch.empty(B * (nt + 1), dtype=torch.int32, device=dev)
        for _ in range(3):
            native.check(native.call(lib.hebo_chol_winv, dev, L.data_ptr(), Wd.data_ptr(), None, W.data_ptr(),
                                     sync.data_ptr(), B, Np), "chol_probe winv timeline")
        torch.cuda.synchronize()
        S = stamps.view(B, n_tasks, 4).cpu().numpy().astype(np.float64) / 1e3  # µs
        S -= S[:, :, 0].min()
        ik = ck._winv_flow_tasks(nt)
        off = np.array([i != k for i, k in ik])
        terms = np.array([i - k for i, k in ik], np.float64)
        rows = np.array([i for i, _ in ik])
        span = float(S[:, :, 3].max())
        ctas = min(max(1, torch.cuda.get_device_properties(dev).multi_processor_count // B), n_tasks)
        busy = float((S[:, :, 3] - S[:, :, 0]).sum()) / (span * ctas * B)
        out = {"winv_timeline": [B, N], "tasks": n_tasks, "span_us": round(span, 2), "busy": round(busy, 3),
               "reduce_us": round(float(np.median((S[:, off, 2] - S[:, off, 1]))), 2),
               "wd_product_us": round(float(np.median((S[:, off, 3] - S[:, off, 2]))), 2),
               "column0_step_us": round(float(np.median(np.diff(
                   [S[0, ik.index((i, 0)), 3] for i in range(1, nt)]))), 2) if nt > 2 else None}
        per_term = (S[:, :, 1] - S[:, :, 0]) / np.maximum(terms, 1)
        for lo, hi in ((1, 10), (10, 20), (20, 40), (40, 60), (60, nt)):
            sel = off & (rows >= lo) & (rows < min(hi, nt))
            if sel.any():
                out[f"us_per_term_rows_{lo}_{hi}"] = round(float(np.median(per_term[:, sel])), 3)
                out[f"row_end_us_{min(hi, nt) - 1}"] = round(float(S[:, rows == min(hi, nt) - 1, 3].max()), 2)
        at = np.linspace(0, span, 11)[1:-1]
        out["tasks_in_flight"] = [int(((S[:, :, 0] <= x) & (S[:, :, 3] > x)).sum()) for x in at]
        print(json.dumps(out), flush=True)


def variants(torch, native, ck, kind="factor", reps=10):
    """Part 4 for K1a's flow route (``kind`` "factor": ``VARIANTS``) or
    K1b's (``kind`` "winv": ``WINV_VARIANTS``)."""
    subs_by_name = VARIANTS if kind == "factor" else WINV_VARIANTS
    mangled = "chol_flowE" if kind == "factor" else "winv_flowE"
    src = (native.CSRC / "chol.cu").read_text()
    built = _build(native, {f"chol_{name}": _substitute(src, subs, name)
                            for name, subs in {"base": [], **subs_by_name}.items()})
    libs = {}
    for key, (lib, log) in built.items():
        name, fn = key[len("chol_"):], None
        for line in log.splitlines():
            if "Function properties for" in line:
                fn = line.split("Function properties for")[-1].strip()
            if fn and mangled in fn and ("Used" in line or "spill" in line):
                print(json.dumps({"variant": name, "ptxas": line.split("info    :")[-1].strip()}), flush=True)
        libs[name] = lib
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    flow = ck.ROUTES.index("flow")

    def spd(B, N):
        A = torch.randn((B, N, N), generator=gen, device=dev)
        return (A @ A.transpose(1, 2) / N + 0.5 * torch.eye(N, device=dev)).contiguous()

    def factor(lib, K):  # K1a's flow route, forced
        B, n, _ = K.shape
        Np = ck.padded_size(n)
        nt = Np // ck.TILE
        L = torch.empty((B, Np, Np), device=dev)
        Wd = torch.empty((B, nt, ck.TILE, ck.TILE), device=dev)
        sync = torch.empty(B * (2 * nt + 1), dtype=torch.int32, device=dev)
        native.check(native.call(lib.hebo_chol_factor, dev, K.data_ptr(), None, None, L.data_ptr(),
                                 Wd.data_ptr(), sync.data_ptr(), flow, B, n, Np), "chol_probe variants")
        return L, Wd

    def winv(lib, LWd):  # K1b's flow route (the size's from 2 tiles)
        L, Wd = LWd
        B, Np, _ = L.shape
        W = torch.empty_like(L)
        sync = torch.empty(B * (Np // ck.TILE + 1), dtype=torch.int32, device=dev)
        native.check(native.call(lib.hebo_chol_winv, dev, L.data_ptr(), Wd.data_ptr(), None, W.data_ptr(),
                                 sync.data_ptr(), B, Np), "chol_probe variants")
        return (W,)

    run, make = (factor, lambda B, N: spd(B, N)) if kind == "factor" else (
        winv, lambda B, N: ck.chol_factor(spd(B, N)))
    x = make(1, 1000)
    want = ck.chol_factor_plain(x) if kind == "factor" else (ck.chol_winv_plain(*x),)
    for name, lib in libs.items():
        got, again = run(lib, x), run(lib, x)
        print(json.dumps({"variant": name,
                          "max_abs_err_1000": max((a - b).abs().max().item() for a, b in zip(got, want)),
                          "same_bits": all(torch.equal(a, b) for a, b in zip(got, again))}), flush=True)
    order = ["base"] + list(subs_by_name) + list(subs_by_name)[::-1] + ["base"]
    for B, N in VARIANT_SHAPES:
        x = make(B, N)
        row = {"shape": [B, N]}
        for name in order:
            row.setdefault(name, []).append(round(_ms(torch, lambda: run(libs[name], x), reps), 4))
        print(json.dumps(row), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--only", choices=["shapes", "winv"], default=None)
    ap.add_argument("--shapes", nargs="+", default=None, metavar="BxN")
    ap.add_argument("--variants", nargs="?", const="factor", choices=["factor", "winv"], default=None,
                    help="part 4 only, for K1a (factor, the default) or K1b (winv)")
    ap.add_argument("--winv-timeline", action="store_true", help="part 5 only")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch

    from hebo_tpu_torch.ops import chol_kernel as ck
    from hebo_tpu_torch.ops import native

    if not torch.cuda.is_available():
        raise SystemExit("chol_probe: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi, "root": args.root}), flush=True)
    if args.variants:
        variants(torch, native, ck, args.variants)
        return
    if args.winv_timeline:
        winv_timeline(torch, native, ck)
        return
    shapes(torch, ck, [tuple(int(x) for x in s.split("x")) for s in args.shapes] if args.shapes else SHAPES,
           winv_only=args.only == "winv")
    if args.only is None:
        phases(torch, native)
        if hasattr(ck, "ROUTES"):
            timeline(torch, native, ck)


if __name__ == "__main__":
    main()
