"""Where kernel K1 (``csrc/chol.cu``) spends its time on a CUDA card.

    python3 -m hebo_tpu_torch.bench.chol_probe

1. For each (B, N) of the main paths: ``chol_factor`` and ``chol_winv``
   against ``torch.linalg.cholesky_ex`` / ``solve_triangular`` (ms per
   call, CUDA events over back-to-back calls), and, from one call under
   ``torch.profiler``, each device kernel's launches and µs per call.
2. The tile factor's phases: an instrumented copy of ``chol.cu`` (a
   ``clock64()`` stamp by thread 0 at the start of ``factor_tile`` and
   after each of its CTA barriers) is built apart into
   ``hebo_tpu_torch/build/`` and run on one 64×64 tile; prints the cycle
   offsets, three times.
Prints JSON lines; needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from ..ops import chol_kernel as ck
from ..ops import native

SHAPES = [(1, 32), (1, 128), (2, 128), (1, 256), (1, 1024), (2, 1024), (2, 2048)]


def _ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _kernels_per_call(fn, calls=5):
    """{kernel name: [launches per call, device µs per launch]}."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
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


def shapes():
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for B, N in SHAPES:
        A = torch.randn((B, N, N), generator=gen, device=dev)
        K = (A @ A.transpose(1, 2) / N + 0.5 * torch.eye(N, device=dev)).contiguous()
        L, Wd = ck.chol_factor(K)
        eye = torch.eye(L.shape[-1], device=dev).expand_as(L)
        reps = 200 if N <= 256 else 20
        print(json.dumps({
            "shape": [B, N],
            "chol_factor_ms": _ms(lambda: ck.chol_factor(K), reps),
            "cholesky_ex_ms": _ms(lambda: torch.linalg.cholesky_ex(K), reps),
            "chol_winv_ms": _ms(lambda: ck.chol_winv(L, Wd), reps),
            "solve_triangular_ms": _ms(lambda: torch.linalg.solve_triangular(L, eye, upper=False), reps),
            "chol_factor_kernels": _kernels_per_call(lambda: ck.chol_factor(K)),
            "chol_winv_kernels": _kernels_per_call(lambda: ck.chol_winv(L, Wd)),
        }), flush=True)


_HOOKS = """
__device__ long long g_stamp[64];
__device__ int g_nstamp;
#define STAMP() do { if (threadIdx.x == 0) g_stamp[g_nstamp++] = clock64(); } while (0)
"""

_ENTRY = """
extern "C" int probe_tile(const float* K, float* L, float* Wd, long long* out, int* n) {
  int zero = 0;
  cudaMemcpyToSymbol(g_nstamp, &zero, sizeof(int));
  chol_first<<<dim3(1, 1), kThreads>>>(K, L, Wd, L, 64, 64);
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(out, g_stamp, 64 * sizeof(long long));
  cudaMemcpyFromSymbol(n, g_nstamp, sizeof(int));
  return (int)cudaGetLastError();
}
"""


def phases():
    src = (native.CSRC / "chol.cu").read_text()
    a = src.index("__device__ void factor_tile")
    b = src.index("// Store a factored tile")
    body = src[a:b].replace("__syncthreads();", "__syncthreads(); STAMP();")
    body = body.replace("tx = t & 15, ty = t >> 4;\n", "tx = t & 15, ty = t >> 4;\n  STAMP();\n", 1)
    src = src[:a] + body + src[b:]
    src = src.replace("namespace {", "namespace {" + _HOOKS, 1) + _ENTRY
    native.BUILD.mkdir(parents=True, exist_ok=True)
    cu, so = native.BUILD / "chol_probe.cu", native.BUILD / "libchol_probe.so"
    cu.write_text(src)
    flags = [f for f in native.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([native._nvcc(), *flags, "-o", str(so), str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chol_probe: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    shapes()
    phases()


if __name__ == "__main__":
    main()
