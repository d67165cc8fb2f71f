"""Where kernel K1 (``csrc/chol.cu``) spends its time on a CUDA card.

    python3 hebo_tpu_torch/bench/chol_probe.py [--root DIR] [--only shapes|winv] [--shapes BxN ...]
    python3 hebo_tpu_torch/bench/chol_probe.py --variants [factor|winv|tile|fused]
    python3 hebo_tpu_torch/bench/chol_probe.py --winv-timeline
    python3 hebo_tpu_torch/bench/chol_probe.py --fused [--shapes BxN ...]
    python3 hebo_tpu_torch/bench/chol_probe.py --bits-against DIR [--shapes BxN ...]

1. For each (B, N) of the main paths and of the routes' edges: the routes
   K1a and K1b take there, ``chol_factor`` on each of its routes (forced)
   and on its own and ``chol_winv`` on the size's route, against
   ``torch.linalg.cholesky_ex`` / ``solve_triangular`` (ms per call, CUDA
   events over back-to-back calls); from calls under ``torch.profiler``,
   each device kernel's launches per call and device µs per launch, for a
   factoring call and for a skipped one (every matrix's flag set, as on the
   jitter ladder's later rungs), per route; where K1a takes its flow route,
   the same for the fused call ``chol_factor_inv`` (L, Wd and W).
2. The tile factor's phases: an instrumented copy of ``chol.cu``
   (``clock64()`` stamps by warp 0, the chain, around each diagonal block's
   factor, and by warp 1, a worker, around its waits and its look-ahead
   update) is built apart into ``hebo_tpu_torch/build/`` and run on one
   64×64 tile; prints the total cycles, each block's factor and its column
   step (cycles / 16), the workers' look-ahead and the tail, three times.
   On a checkout whose tile factor has no chain warp (``--root``), the
   stamps come after each CTA barrier, as that checkout's probe took them.
3. K1a's flow route's timeline at (1, 2048) and (1, 5051): another
   instrumented copy stamps ``%globaltimer`` per task (start, sums done,
   the diagonal task's chain inputs there, published); prints, per range
   of columns, the mean step between two diagonal tasks' ends and where
   the diagonal task of column k stood against the end of column k - 1's
   (started, sums done, inputs there; the subdiagonal sum's end), and the
   tasks in flight at nine points of the run.
4. With ``--variants`` (in place of parts 1-3): K1a's flow route against
   variants of itself, with ``--variants winv`` K1b's, with ``--variants
   tile`` the tile factor's (timed through K1a's both routes and the fused
   call, and by part 2's stamps), with ``--variants fused`` the fused
   call's.  Each variant is ``chol.cu`` with text substitutions
   (``VARIANTS``, ``WINV_VARIANTS``, ``TILE_VARIANTS``, ``FUSED_VARIANTS``),
   all built at once apart into
   ``hebo_tpu_torch/build/`` and timed at
   ``VARIANT_SHAPES`` in turns with the source as it is ("base": base,
   variants, variants in reverse, base).  Prints each variant's ptxas
   registers and spills of the kernel, its max abs error against the
   plain version at (1, 1000) and whether two launches give the same bits,
   then one JSON line per shape.
5. With ``--winv-timeline`` (in place of parts 1-3): K1b's flow route with
   a ``%globaltimer`` stamp per task at (1, 5051) and (2, 1024)
   (``winv_timeline``).
6. With ``--fused`` (in place of parts 1-3): the fused call's timeline
   (``fused_timeline``), a ``%globaltimer`` stamp at each task's start and
   end, K1a's tasks and W's apart, at (1, 5051), (2, 1024) and (1, 1024)
   (or ``--shapes``): the span, when L's last task ended, the diagonal
   chain's step per range of columns, how far W's rows end behind L's,
   each kind's busy share of the CTAs and the tasks of each kind in flight
   at nine points of the run.
7. With ``--bits-against DIR`` (in place of parts 1-3): this checkout's K1
   against DIR's ``csrc/chol.cu`` (another checkout, e.g. the parent
   unpacked by ``git archive``), built apart, at ``BITS_SHAPES`` (or
   ``--shapes``): whether K1a on each of its routes, K1b and, where K1a
   takes its flow route, this checkout's fused call give DIR's bits.

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

# part 7: the shapes of both routes, their edge and the main paths'
BITS_SHAPES = [(1, 64), (2, 128), (1, 256), (3, 200), (2, 448), (1, 512), (2, 1024), (4, 1024),
               (32, 1024), (1, 3072), (1, 5051)]

# part 4: the flow routes' shapes timed against their variants, and the
# tile factor's (both of K1a's routes)
VARIANT_SHAPES = [(2, 1024), (32, 1024), (2, 2048), (1, 3072), (1, 5051)]
TILE_VARIANT_SHAPES = [(2, 128), (1, 256), (2, 1024), (1, 1024), (1, 5051)]

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
    "two_ctas": [("__launch_bounds__(kThreads, 1)\nchol_flow(", "__launch_bounds__(kThreads, 2)\nchol_flow(")],
    "stages3": [("constexpr int kFlowStages = 2;", "constexpr int kFlowStages = 3;"),
                ("""__device__ __forceinline__ void cp_async_wait_upto(int n) {
  static_assert(kFlowStages == 2, "cp_async_wait_upto covers n < 2");
  if (n <= 0) cp_async_wait<0>();
  else cp_async_wait<1>();
}""", _WAIT3)],
    "column_order": [("""    if (i < 3) {  // (0, 0), (1, 0), (1, 1)
      k = i >> 1;
      i = i > 0;
    } else {
      factor_ticket(i - 3, nt, i, k);
    }""", """    while (i >= nt - k) i -= nt - k++;
    i += k;""")],
    "no_products": [("    mma_nt_8x8(P, diag ? P : P + TILE_F, acc, gy, gx, 16 * g);\n", "")],
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


# `--variants tile`: the tile factor against variants of itself
# * shfl_block16: the diagonal block's column steps broadcast by
#   __shfl_sync, the next pivot's entry first, in place of shared memory and
#   __syncwarp (slower: 224-241 against 183-198 cycles a step on an H100 80GB
#   HBM3 at 700 W);
# * pipelined_block16: each step takes the next pivot's entry first and
#   computes the next pivot at once, the other updates after it (the same
#   bits; no faster: 184-198 against 182-196 cycles a step, the same card).
_SHFL_BLOCK16 = """__device__ __forceinline__ void factor_block16(float* A, float* X, int o) {
  const int r = threadIdx.x & 31;
  float a[SB], x[SB], dd[SB], own_inv = 0.f;
#pragma unroll
  for (int c = 0; c < SB; ++c) {
    a[c] = A[(o + r) * LD + o + c];
    x[c] = c == r ? 1.f : 0.f;
    dd[c] = A[(o + c) * LD + o + c];
  }
#pragma unroll
  for (int k = 0; k < SB; ++k) {
    const float d = dd[k];
    const float inv = inv_sqrt_pivot(d);
    const float m = r > k ? a[k] * inv : 0.f;
    a[k] = r > k ? m : (r == k ? d * inv : 0.f);
    if (r == k) own_inv = inv;
    const float mx = m * inv;  // row op with the scaled row k
#pragma unroll
    for (int c = k + 1; c < SB; ++c) {
      const float v = __shfl_sync(0xffffu, m, c, SB);  // L[c][k]
      a[c] = fmaf(-m, v, a[c]);
      dd[c] = fmaf(-v, v, dd[c]);
    }
#pragma unroll
    for (int c = 0; c <= k; ++c) {
      const float v = __shfl_sync(0xffffu, x[c], k, SB);  // unscaled inverse row k
      x[c] = fmaf(-mx, v, x[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < SB; ++c) {
    A[(o + r) * LD + o + c] = c <= r ? a[c] : 0.f;
    X[(o + r) * LD + o + c] = c <= r ? x[c] * own_inv : 0.f;
  }
}

"""
_PIPELINED_BLOCK16 = """__device__ __forceinline__ void factor_block16(float* A, float* X, int o) {
  __shared__ __align__(16) float colb[2][SB];  // multipliers of step k
  __shared__ __align__(16) float xrow[2][SB];  // unscaled row k of the inverse
  const int r = threadIdx.x;
  float a[SB], x[SB], dd[SB], own_inv = 0.f;
#pragma unroll
  for (int c = 0; c < SB; ++c) {
    a[c] = A[(o + r) * LD + o + c];
    x[c] = c == r ? 1.f : 0.f;
    dd[c] = A[(o + c) * LD + o + c];
  }
  float inv = inv_sqrt_pivot(dd[0]);
#pragma unroll
  for (int k = 0; k < SB; ++k) {
    const float d = dd[k];
    const float m = r > k ? a[k] * inv : 0.f;
    a[k] = r > k ? m : (r == k ? d * inv : 0.f);
    if (r == k) own_inv = inv;
    colb[k & 1][r] = m;
    if (r == k) {
#pragma unroll
      for (int q = 0; 4 * q <= k; ++q)
        *reinterpret_cast<float4*>(&xrow[k & 1][4 * q]) =
            make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
    }
    __syncwarp(0xffffu);
    const float mx = m * inv;  // row op with the scaled row k
    float inv_next = 0.f;
    if (k + 1 < SB) {  // the next pivot's entry first
      const float v = colb[k & 1][k + 1];
      a[k + 1] = fmaf(-m, v, a[k + 1]);
      dd[k + 1] = fmaf(-v, v, dd[k + 1]);
      inv_next = inv_sqrt_pivot(dd[k + 1]);
    }
#pragma unroll
    for (int q = 0; q < SB / 4; ++q) {
      if (4 * q + 3 > k + 1) {
        const float4 v = *reinterpret_cast<const float4*>(&colb[k & 1][4 * q]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = 4 * q + u;
          if (c > k + 1) {
            a[c] = fmaf(-m, lane4(v, u), a[c]);
            dd[c] = fmaf(-lane4(v, u), lane4(v, u), dd[c]);
          }
        }
      }
      if (4 * q <= k) {
        const float4 v = *reinterpret_cast<const float4*>(&xrow[k & 1][4 * q]);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (4 * q + u <= k) x[4 * q + u] = fmaf(-mx, lane4(v, u), x[4 * q + u]);
      }
    }
    inv = inv_next;
  }
#pragma unroll
  for (int c = 0; c < SB; ++c) {
    A[(o + r) * LD + o + c] = c <= r ? a[c] : 0.f;
    X[(o + r) * LD + o + c] = c <= r ? x[c] * own_inv : 0.f;
  }
}

"""


def _block16(text):
    def sub(src):
        a = src.index("__device__ __forceinline__ void factor_block16")
        b = src.index("// The tile factor's warps 1-7")
        return src[:a] + text + "\n" + src[b:]
    return sub


TILE_VARIANTS = {"shfl_block16": _block16(_SHFL_BLOCK16), "pipelined_block16": _block16(_PIPELINED_BLOCK16)}

# `--variants fused`: the fused call's ticket order, W's rows kWinvLag
# columns after their diagonal task's (4 in chol.cu); "last": every row of W
# after K1a's last task
FUSED_VARIANTS = {f"lag{n}": [("constexpr int kWinvLag = 4;", f"constexpr int kWinvLag = {n};")]
                  for n in (1, 2, 3, 6, 8)}
FUSED_VARIANTS["last"] = [("constexpr int kWinvLag = 4;", "constexpr int kWinvLag = 1 << 20;")]


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
        if hasattr(ck, "chol_factor_inv") and row["route"] == "flow":
            out3 = (L.clone(), Wd.clone(), W.clone())
            row.update(
                chol_factor_inv_ms=_ms(torch, lambda: ck.chol_factor_inv(K), reps),
                chol_factor_inv_per_call=_summary(_kernels_per_call(torch, lambda: ck.chol_factor_inv(K))),
                chol_factor_inv_skipped_per_call=_summary(_kernels_per_call(
                    torch, lambda: ck.chol_factor_inv(K, jit, skip, out=out3))))
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
#define STAMP_T(slot, thread) do { if (threadIdx.x == (thread)) g_stamp[slot] = clock64(); } while (0)
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

# (text in factor_tile, the same text with stamps): slot 0 the start; for
# diagonal block b, 1 + 3b / 2 + 3b warp 0's factor begins / ends, 3 + 3b
# the CTA barrier after it passed, 22 + 3b a worker (thread 32) has done
# its share of column block b - 1 (tile_rest); 14 / 15 the tail's barriers
_TILE_STAMPS = [
    ("  const int t = threadIdx.x, ty = t >> 4, tx = t & 15;\n  for (int b = 0; b < 4; ++b) {\n",
     "  const int t = threadIdx.x, ty = t >> 4, tx = t & 15;\n  STAMP_T(0, 0);\n  for (int b = 0; b < 4; ++b) {\n"),
    ("    if (t < SB) factor_block16(A, X, SB * b);\n"
     "    else if (t >= 32 && b > 0) tile_rest(A, X, b - 1, t - 32);\n",
     "    STAMP_T(1 + 3 * b, 0);\n"
     "    if (t < SB) factor_block16(A, X, SB * b);\n"
     "    else if (t >= 32 && b > 0) tile_rest(A, X, b - 1, t - 32);\n"
     "    STAMP_T(2 + 3 * b, 0);\n    STAMP_T(22 + 3 * b, 32);\n"),
    ("    __syncthreads();  // L_bb and X_bb are there, and the workers' blocks\n",
     "    __syncthreads();  // L_bb and X_bb are there, and the workers' blocks\n    STAMP_T(3 + 3 * b, 0);\n"),
    ("  X[(48 + ty) * LD + 32 + tx] = double16_x(X, 32, ty, tx);\n  __syncthreads();\n",
     "  X[(48 + ty) * LD + 32 + tx] = double16_x(X, 32, ty, tx);\n  __syncthreads();\n  STAMP_T(14, 0);\n"),
    ("  for (int j = 0; j < 2; ++j) X[(48 + ty) * LD + tx + SB * j] = double32_x(X, 1, j, ty, tx);\n"
     "  __syncthreads();\n",
     "  for (int j = 0; j < 2; ++j) X[(48 + ty) * LD + tx + SB * j] = double32_x(X, 1, j, ty, tx);\n"
     "  __syncthreads();\n  STAMP_T(15, 0);\n"),
]


def _tile_source(src):
    """chol.cu with the tile factor's stamps and the probe's entry; a tile
    factor without warp 0's chain (no tile_rest) is stamped after each CTA
    barrier."""
    if "tile_rest(" in src:
        src = _substitute(src, _TILE_STAMPS, "tile stamps")
    else:
        a = src.index("__device__ void factor_tile")
        b = src.index("// Store a factored tile")
        body = src[a:b].replace("__syncthreads();", "__syncthreads(); STAMP();")
        body = body.replace("tx = t & 15, ty = t >> 4;\n", "tx = t & 15, ty = t >> 4;\n  STAMP();\n", 1)
        src = src[:a] + body + src[b:]
    return src.replace("namespace {", "namespace {" + _HOOKS, 1) + _ENTRY


def _tile_cycles(torch, native, lib, what, runs=3):
    """Part 2 on the library `lib` built from ``_tile_source``."""
    A = torch.randn(64, 64, device="cuda", generator=torch.Generator(device="cuda").manual_seed(1))
    K = (A @ A.T / 64 + 0.5 * torch.eye(64, device="cuda")).contiguous()
    L = torch.empty(64, 64, device="cuda")
    Wd = torch.empty(64, 64, device="cuda")
    out, n = (ctypes.c_longlong * 64)(), ctypes.c_int()
    for _ in range(runs):
        err = lib.probe_tile(ctypes.c_void_p(K.data_ptr()), ctypes.c_void_p(L.data_ptr()),
                             ctypes.c_void_p(Wd.data_ptr()), out, ctypes.byref(n))
        native.check(err, "chol_probe")
        st = list(out)
        row = {"tile": what, "L_max_abs_err": (L - torch.linalg.cholesky(K)).abs().max().item()}
        if n.value:  # stamps after each CTA barrier
            row["factor_tile_cycles_at_barriers"] = [x - st[0] for x in st[: n.value]]
            row["total_cycles"] = st[n.value - 1] - st[0]
        else:
            f = [st[2 + 3 * b] - st[1 + 3 * b] for b in range(4)]
            row.update(
                total_cycles=st[15] - st[0], block_factor_cycles=f,
                column_step_cycles=[round(x / 16, 1) for x in f],
                workers_rest_cycles=[st[22 + 3 * b] - st[1 + 3 * b] for b in range(1, 4)],
                barrier_after_block_cycles=[st[3 + 3 * b] - st[2 + 3 * b] for b in range(4)],
                lookahead_cycles=[st[4 + 3 * b] - st[3 + 3 * b] for b in range(3)],
                tail_cycles=st[15] - st[12])
        print(json.dumps(row), flush=True)


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
            if hasattr(lib, f):  # another checkout's source may lack the newer entry points
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
    src = _tile_source((native.CSRC / "chol.cu").read_text())
    lib = _build(native, {"chol_probe": src})["chol_probe"][0]
    _tile_cycles(torch, native, lib, "base")


_TIMER = """
__device__ long long* g_task_stamps;
__shared__ int g_probe_ticket, g_probe_tasks;  // thread 0's task: ticket, tasks a matrix
__device__ __forceinline__ long long global_ns() {
  long long v;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));
  return v;
}
#define STAMP(s) do { if (threadIdx.x == 0) g_task_stamps[((size_t)blockIdx.y * g_probe_tasks + g_probe_ticket) * 4 + (s)] = global_ns(); } while (0)
"""

# (text in chol_flow and its factor_task, the same text with a stamp): 0
# the task starts, 1 its sums are done, 2 the diagonal task's chain inputs
# are there, 3 published
_TASK_STAMPS = [
    ("    int k = 0, i = s_task;\n",
     "    int k = 0, i = s_task;\n    if (t == 0) { g_probe_ticket = i; g_probe_tasks = n_tasks; }\n"),
    ("  const bool diag = i == k;\n", "  const bool diag = i == k;\n  STAMP(0);\n"),
    ("  cp_async_wait<0>();\n  __syncthreads();  // every product done, C landed",
     "  STAMP(1);\n  cp_async_wait<0>();\n  __syncthreads();  // every product done, C landed"),
    ("      wait_cols(rows, k - 1, k - 1, k - 1, h0, h1);  // Wd_{k-1} stored\n    }\n",
     "      wait_cols(rows, k - 1, k - 1, k - 1, h0, h1);  // Wd_{k-1} stored\n    }\n    STAMP(2);\n"),
    ("publish(rows + k, k + 1);", "publish(rows + k, k + 1);\n    STAMP(3);"),
    ("publish(subs + i, 1);", "publish(subs + i, 1);\n    STAMP(3);"),
    ("publish(rows + i, k + 1);", "publish(rows + i, k + 1);\n    STAMP(3);"),
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
    ("    const int k = ticket - i * (i + 1) / 2;\n",
     "    const int k = ticket - i * (i + 1) / 2;\n"
     "    if (t == 0) { g_probe_ticket = ticket; g_probe_tasks = n_tasks; }\n    STAMP(0);\n"),
    ("    __syncthreads();  // every thread has read the ticket\n",
     "    __syncthreads();  // every thread has read the ticket\n    STAMP(3);\n"),
    ("  cp_async_wait<0>();\n  __syncthreads();  // every product done (and Wd_i landed, without kFused)",
     "  STAMP(1);\n  cp_async_wait<0>();\n  __syncthreads();  // every product done (and Wd_i landed, without kFused)"),
    ("  {  // W_ik = -Wd_i S;", "  STAMP(2);\n  {  // W_ik = -Wd_i S;"),
    ("  publish(cols + k, i - k);\n", "  publish(cols + k, i - k);\n  STAMP(3);\n"),
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


# (text in chol_flow_inv, the same text with stamps): 0 the task starts, 1
# it ends, 2 its kind and place (1,000,000 for W's, + 1,000 i + k)
_FUSED_STAMPS = [
    ("    const int ticket = s_task;\n    if (ticket >= n_tasks) return;\n    int i, k;\n",
     "    const int ticket = s_task;\n    if (ticket >= n_tasks) return;\n    int i, k;\n"
     "    if (t == 0) { g_probe_ticket = ticket; g_probe_tasks = n_tasks; }\n    STAMP(0);\n"),
    ("    if (fused_ticket(ticket, nt, i, k))\n"
     "      winv_task<true>(i, k, Lb, W + mat, Wdb, cols, rows, sm, s_ready, Np);\n"
     "    else\n"
     "      factor_task(i, k, K, jitter, Lb, Wdb, rows, subs, sm, s_ready, b, n, Np);\n",
     "    const bool is_w = fused_ticket(ticket, nt, i, k);\n"
     "    if (is_w)\n"
     "      winv_task<true>(i, k, Lb, W + mat, Wdb, cols, rows, sm, s_ready, Np);\n"
     "    else\n"
     "      factor_task(i, k, K, jitter, Lb, Wdb, rows, subs, sm, s_ready, b, n, Np);\n"
     "    STAMP(1);\n"
     "    if (t == 0) g_task_stamps[((size_t)b * n_tasks + ticket) * 4 + 2] = is_w * 1000000 + i * 1000 + k;\n"),
]


def fused_timeline(torch, native, ck, todo=((1, 5051), (2, 1024), (1, 1024))):
    """Part 6: the fused call with a ``%globaltimer`` stamp at each task's
    start and end (``_FUSED_STAMPS``)."""
    import numpy as np

    src = _substitute((native.CSRC / "chol.cu").read_text(), _FUSED_STAMPS, "fused timeline")
    src = src.replace("namespace {", "namespace {" + _TIMER, 1) + (
        '\nextern "C" int probe_set_stamps(void* p) {\n'
        "  return (int)cudaMemcpyToSymbol(g_task_stamps, &p, sizeof(p));\n}\n")
    lib = _build(native, {"fused_timeline": src})["fused_timeline"][0]
    lib.probe_set_stamps.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for B, N in todo:
        A = torch.randn((B, N, N), generator=gen, device=dev)
        K = (A @ A.transpose(1, 2) / N + 0.5 * torch.eye(N, device=dev)).contiguous()
        Np = ck.padded_size(N)
        nt = Np // ck.TILE
        n_tasks = nt * (nt + 1)
        stamps = torch.zeros(B * n_tasks * 4, dtype=torch.int64, device=dev)
        native.check(lib.probe_set_stamps(stamps.data_ptr()), "chol_probe fused timeline")
        L = torch.empty((B, Np, Np), device=dev)
        Wd = torch.empty((B, nt, ck.TILE, ck.TILE), device=dev)
        W = torch.empty_like(L)
        sync = torch.empty(B * (3 * nt + 1), dtype=torch.int32, device=dev)
        for _ in range(3):
            native.check(native.call(lib.hebo_chol_factor_inv, dev, K.data_ptr(), None, None, L.data_ptr(),
                                     Wd.data_ptr(), W.data_ptr(), sync.data_ptr(), B, N, Np),
                         "chol_probe fused timeline")
        torch.cuda.synchronize()
        S = stamps.view(B, n_tasks, 4).cpu().numpy()
        code = S[:, :, 2]
        T = S[:, :, :2].astype(np.float64) / 1e3  # µs
        T -= T[:, :, 0].min()
        is_w = code >= 1000000
        ti, tk = (code % 1000000) // 1000, code % 1000
        span = float(T[:, :, 1].max())
        l_end = float(np.where(is_w, 0, T[:, :, 1]).max())
        dur = T[:, :, 1] - T[:, :, 0]
        ctas = min(max(1, sms // B), n_tasks) * B
        diag = {}
        for b in range(B):
            for x in np.flatnonzero(~is_w[b] & (ti[b] == tk[b])):
                diag.setdefault(int(ti[b, x]), []).append(T[b, x, 1])
        dend = np.array([max(diag[k]) for k in range(nt)])
        wrow = np.array([max(T[b, x, 1] for b in range(B) for x in np.flatnonzero(is_w[b] & (ti[b] == w)))
                         for w in range(nt)])
        out = {"fused_timeline": [B, N], "tasks": n_tasks, "span_us": round(span, 2),
               "L_end_us": round(l_end, 2), "W_after_L_us": round(span - l_end, 2),
               "busy_L": round(float(dur[~is_w].sum()) / (span * ctas), 3),
               "busy_W": round(float(dur[is_w].sum()) / (span * ctas), 3)}
        for lo, hi in ((1, 10), (10, 20), (20, 40), (40, 60), (60, nt)):
            if lo < nt:
                hi = min(hi, nt)
                out[f"chain_step_us_cols_{lo}_{hi}"] = round(float(np.mean(np.diff(dend)[lo - 1:hi - 1])), 2)
                out[f"W_row_end_behind_L_diag_us_rows_{lo}_{hi}"] = round(float(np.mean((wrow - dend)[lo:hi])), 2)
        at = np.linspace(0, span, 11)[1:-1]
        live = lambda m, x: int((m & (T[:, :, 0] <= x) & (T[:, :, 1] > x)).sum())
        out["L_tasks_in_flight"] = [live(~is_w, x) for x in at]
        out["W_tasks_in_flight"] = [live(is_w, x) for x in at]
        print(json.dumps(out), flush=True)


def variants(torch, native, ck, kind="factor", reps=10):
    """Part 4 for K1a's flow route (``kind`` "factor": ``VARIANTS``), K1b's
    (``kind`` "winv": ``WINV_VARIANTS``), the tile factor (``kind`` "tile":
    ``TILE_VARIANTS``; also part 2's stamps per variant) or the fused call
    (``kind`` "fused": ``FUSED_VARIANTS``).  A variant is a list of (text,
    replacement) or a function of the source."""
    subs_by_name = {"factor": VARIANTS, "winv": WINV_VARIANTS, "tile": TILE_VARIANTS,
                    "fused": FUSED_VARIANTS}[kind]
    mangled = {"factor": "chol_flowE", "winv": "winv_flowE", "tile": "chol_flow", "fused": "chol_flow_invE"}[kind]
    src = (native.CSRC / "chol.cu").read_text()
    apply = lambda subs, name: subs(src) if callable(subs) else _substitute(src, subs, name)
    sources = {f"chol_{name}": apply(subs, name) for name, subs in {"base": [], **subs_by_name}.items()}
    if kind == "tile":
        sources.update({f"tile_{name[5:]}": _tile_source(v) for name, v in list(sources.items())})
    built = _build(native, sources)
    libs = {}
    for key, (lib, log) in built.items():
        if key.startswith("tile_"):
            continue
        name, fn = key[len("chol_"):], None
        for line in log.splitlines():
            if "Function properties for" in line:
                fn = line.split("Function properties for")[-1].strip()
            if fn and mangled in fn and ("Used" in line or "spill" in line):
                print(json.dumps({"variant": name, "ptxas": line.split("info    :")[-1].strip()}), flush=True)
        libs[name] = lib
    if kind == "tile":
        for key, (lib, _) in built.items():
            if key.startswith("tile_"):
                _tile_cycles(torch, native, lib, key[5:], runs=2)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def spd(B, N):
        A = torch.randn((B, N, N), generator=gen, device=dev)
        return (A @ A.transpose(1, 2) / N + 0.5 * torch.eye(N, device=dev)).contiguous()

    def factor(lib, K, route=ck.ROUTES.index("flow")):  # K1a, on a forced route
        B, n, _ = K.shape
        Np = ck.padded_size(n)
        nt = Np // ck.TILE
        L = torch.empty((B, Np, Np), device=dev)
        Wd = torch.empty((B, nt, ck.TILE, ck.TILE), device=dev)
        scratch = (torch.empty(B * (2 * nt + 1), dtype=torch.int32, device=dev) if ck.ROUTES[route] == "flow"
                   else torch.empty_like(L) if Np > ck.TILE else L)
        native.check(native.call(lib.hebo_chol_factor, dev, K.data_ptr(), None, None, L.data_ptr(),
                                 Wd.data_ptr(), scratch.data_ptr(), route, B, n, Np), "chol_probe variants")
        return L, Wd

    def winv(lib, LWd):  # K1b's flow route (the size's from 2 tiles)
        L, Wd = LWd
        B, Np, _ = L.shape
        W = torch.empty_like(L)
        sync = torch.empty(B * (Np // ck.TILE + 1), dtype=torch.int32, device=dev)
        native.check(native.call(lib.hebo_chol_winv, dev, L.data_ptr(), Wd.data_ptr(), None, W.data_ptr(),
                                 sync.data_ptr(), B, Np), "chol_probe variants")
        return (W,)

    def fused(lib, K):  # the fused call (from 8 tiles)
        B, n, _ = K.shape
        Np = ck.padded_size(n)
        nt = Np // ck.TILE
        L = torch.empty((B, Np, Np), device=dev)
        Wd = torch.empty((B, nt, ck.TILE, ck.TILE), device=dev)
        W = torch.empty_like(L)
        sync = torch.empty(B * (3 * nt + 1), dtype=torch.int32, device=dev)
        native.check(native.call(lib.hebo_chol_factor_inv, dev, K.data_ptr(), None, None, L.data_ptr(),
                                 Wd.data_ptr(), W.data_ptr(), sync.data_ptr(), B, n, Np), "chol_probe variants")
        return L, Wd, W

    def plain3(K):
        L, Wd = ck.chol_factor_plain(K)
        return L, Wd, ck.chol_winv_plain(L, Wd)

    run, make, want_of = {
        "factor": (factor, spd, ck.chol_factor_plain),
        "winv": (winv, lambda B, N: ck.chol_factor(spd(B, N)), lambda x: (ck.chol_winv_plain(*x),)),
        "tile": (fused, spd, plain3),
        "fused": (fused, spd, plain3)}[kind]
    x = make(1, 1000)
    want = want_of(x)
    for name, lib in libs.items():
        got, again = run(lib, x), run(lib, x)
        print(json.dumps({"variant": name,
                          "max_abs_err_1000": max((a - b).abs().max().item() for a, b in zip(got, want)),
                          "same_bits": all(torch.equal(a, b) for a, b in zip(got, again))}), flush=True)
    order = ["base"] + list(subs_by_name) + list(subs_by_name)[::-1] + ["base"]
    step = ck.ROUTES.index("step")
    for B, N in (TILE_VARIANT_SHAPES if kind == "tile" else VARIANT_SHAPES):
        x = make(B, N)
        fns = [("", run)] if ck.route(N) == "flow" else []
        if kind == "tile" and ck.route(N) != "flow":  # the step route: K1a alone
            fns = [("step_", lambda lib, K: factor(lib, K, step))]
        for tag, fn in fns:
            row = {"shape": [B, N], "call": tag + ("fused" if fn is run and kind in ("tile", "fused") else kind)}
            for name in order:
                row.setdefault(name, []).append(round(_ms(torch, lambda: fn(libs[name], x), reps), 4))
            print(json.dumps(row), flush=True)


def bits_against(torch, native, ck, root, todo=BITS_SHAPES):
    """Part 7."""
    src = (Path(root) / "hebo_tpu_torch" / "csrc" / "chol.cu").read_text()
    other = _build(native, {"chol_other": src})["chol_other"][0]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)

    def other_pair(K, r):  # DIR's K1a on route r, then its K1b
        B, n, _ = K.shape
        Np = ck.padded_size(n)
        nt = Np // ck.TILE
        L = torch.empty((B, Np, Np), device=dev)
        Wd = torch.empty((B, nt, ck.TILE, ck.TILE), device=dev)
        W = torch.empty_like(L)
        scratch = (torch.empty(B * (2 * nt + 1), dtype=torch.int32, device=dev) if ck.ROUTES[r] == "flow"
                   else torch.empty_like(L) if Np > ck.TILE else L)
        native.check(native.call(other.hebo_chol_factor, dev, K.data_ptr(), None, None, L.data_ptr(),
                                 Wd.data_ptr(), scratch.data_ptr(), r, B, n, Np), "chol_probe bits")
        sync = torch.empty(B * (nt + 1), dtype=torch.int32, device=dev)
        native.check(native.call(other.hebo_chol_winv, dev, L.data_ptr(), Wd.data_ptr(), None, W.data_ptr(),
                                 sync.data_ptr(), B, Np), "chol_probe bits")
        return L, Wd, W

    same = lambda xs, ys: all(torch.equal(x, y) for x, y in zip(xs, ys))  # noqa: E731
    for B, N in todo:
        A = torch.randn((B, N, N), generator=gen, device=dev)
        K = (A @ A.transpose(1, 2) / N + 0.5 * torch.eye(N, device=dev)).contiguous()
        row = {"bits_against": [B, N], "root": root, "route": ck.route(N)}
        for r, name in enumerate(ck.ROUTES):
            L, Wd, W = other_pair(K, r)
            row[f"chol_factor_{name}"] = same(ck.chol_factor(K, route=name), (L, Wd))
            if name == ck.route(N):
                row["chol_winv"] = same((ck.chol_winv(L, Wd),), (W,))
                if name == "flow":
                    row["chol_factor_inv"] = same(ck.chol_factor_inv(K), (L, Wd, W))
        print(json.dumps(row), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--only", choices=["shapes", "winv"], default=None)
    ap.add_argument("--shapes", nargs="+", default=None, metavar="BxN")
    ap.add_argument("--variants", nargs="?", const="factor", choices=["factor", "winv", "tile", "fused"],
                    default=None, help="part 4 only, for K1a (factor, the default), K1b (winv), the tile "
                    "factor (tile) or the fused call (fused)")
    ap.add_argument("--winv-timeline", action="store_true", help="part 5 only")
    ap.add_argument("--fused", action="store_true", help="part 6 only (with --shapes: those shapes)")
    ap.add_argument("--bits-against", default=None, metavar="DIR",
                    help="part 7 only: this checkout's K1 against DIR's chol.cu, bit for bit")
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
    todo = [tuple(int(x) for x in s.split("x")) for s in args.shapes] if args.shapes else None
    if args.fused:
        fused_timeline(torch, native, ck, *([todo] if todo else []))
        return
    if args.bits_against:
        bits_against(torch, native, ck, args.bits_against, *([todo] if todo else []))
        return
    shapes(torch, ck, todo or SHAPES, winv_only=args.only == "winv")
    if args.only is None:
        phases(torch, native)
        if hasattr(ck, "ROUTES"):
            timeline(torch, native, ck)


if __name__ == "__main__":
    main()
