// Nondominated rank and NSGA-II crowding distance in one launch (kernel K5).
//
// Replaces hebo_tpu/ops/pareto.py::nondominated_rank (:45-78, an XLA
// while_loop over the (P, P) domination matrix) and crowding_distance
// (:81-141, per-objective lexsorts and segment min/max).  The JAX package
// has no pallas_call here: XLA keeps the peel loop on the device.  The
// port's plain version peels with a host test (ops/pareto.py), so on the
// card this kernel keeps the loop on the device, as the JAX program does,
// and a captured graph can hold it.
//
// Input F (N, M) float32 (N = P for the tournament, 2P for survival),
// an optional valid (N,) bool mask.  Output rank (N,) int32 (0 = Pareto
// front, N for a point never peeled) and crowd (N,) float32, equal to the
// plain version bit for bit:
//   D[i][j]   i dominates j: all(F_i <= F_j) and any(F_i < F_j) with IEEE
//             compares (a NaN compares false); with the mask, an invalid
//             row dominates nothing and every valid row dominates it;
//   peel t    the points with no unpeeled dominator get rank t, and each
//             remaining point loses one count per peeled dominator, until
//             every point has a rank (at most N peels);
//   crowding  per objective m, in the order (rank, f, index) with NaN after
//             every number and -0 equal to +0 (the stable sorts' order),
//             d_m = (f_next - f_prev) / span for a point with a neighbour
//             of its front on both sides, else 1e30; span = max(f_max -
//             f_min, 1e-12) over the point's front, NaN if the front holds
//             a NaN in m; crowd = inf if any d_m >= 1e30, else
//             (d_0 + d_1 + ... ) / M summed in objective order with each
//             d_m clamped to at most 1e30 (a NaN passes through).
//
// What bounds it on an H100: neither bytes nor FLOPs.  At N = 200, M = 3
// it reads 2.4 KB and does ~120k compares for the domination matrix and as
// many for the crowding neighbours: well under a microsecond of one SM.
// The time is the launch, the chain of peels (CTA barriers per front) and
// the latency of the scans.  So one CTA of 1024 threads does it all in
// shared memory:
//   dom   N x ceil(N/32) words: bit i of word (j, i/32) says i dominates j
//         (200 x 7 words, 5.6 KB at N = 200);
//   peel  a thread per point tests "unpeeled with no dominator left"; the
//         front is a bitset built with shared atomicOr, and each remaining
//         point subtracts popc(dom_j & front) per word;
//   crowd a thread per (point, objective) counts the points of its front
//         before it in the (f, index) order: that is its place in the
//         front's sorted run, which the peel laid out (front t starts
//         where front t-1 ends).  Each thread writes itself there, and
//         then reads its neighbours and the run's ends (min and max; a
//         NaN sorts last, so a front with a NaN gets a NaN span).  A
//         thread per point sums its M gaps in objective order.  O(N^2 M)
//         independent compares, no sort and no reduction chain.  (Two
//         earlier versions searched for the neighbours directly: a thread
//         per point, ~200 us at N = 200, and a warp per (point, objective)
//         with shuffle reductions, ~114 us: both waiting on dependent
//         shared loads and shuffles on one SM.)

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr float kBig = 1e30f;
constexpr int kStaticSmemLimit = 48 * 1024;

// a before b in the order of torch.argsort / jnp.argsort on floats: NaN
// after every number; equal values (including -0 and +0) tie.
__device__ __forceinline__ bool f_before(float a, float b) {
  if (isnan(a)) return false;
  if (isnan(b)) return true;
  return a < b;
}

__device__ __forceinline__ bool key_before(float fa, int a, float fb, int b) {
  if (f_before(fa, fb)) return true;
  if (f_before(fb, fa)) return false;
  return a < b;
}

__global__ void __launch_bounds__(kThreads)
nsga2_rank_crowd(const float* __restrict__ F, const unsigned char* __restrict__ valid,
                 int* __restrict__ rank_out, float* __restrict__ crowd_out, int N, int M) {
  extern __shared__ float4 smem4[];
  const int W = (N + 31) / 32;
  unsigned* dom = reinterpret_cast<unsigned*>(smem4);  // N * W
  unsigned* front = dom + (size_t)N * W;                // W
  float* Fs = reinterpret_cast<float*>(front + W);      // N * M
  int* rk = reinterpret_cast<int*>(Fs + (size_t)N * M);  // N
  int* ndom = rk + N;                                   // N
  float* gap = reinterpret_cast<float*>(ndom + N);      // N * M: d_m per point
  int* order = reinterpret_cast<int*>(gap + (size_t)N * M);  // M * N: sorted runs
  int* start = order + (size_t)N * M;                   // N + 2: where front t starts
  const int tid = threadIdx.x;

  for (int e = tid; e < N * M; e += kThreads) Fs[e] = F[e];
  for (int j = tid; j < N; j += kThreads) rk[j] = -1;
  if (tid == 0) start[0] = 0;
  __syncthreads();

  // domination bitsets, one (j, word) per thread step
  for (int e = tid; e < N * W; e += kThreads) {
    const int j = e / W, w = e % W;
    const bool vj = valid == nullptr || valid[j];
    unsigned bits = 0u;
    const int i_end = min(32 * w + 32, N);
    for (int i = 32 * w; i < i_end; ++i) {
      bool d;
      if (valid != nullptr && !valid[i]) {
        d = false;
      } else if (!vj) {
        d = true;
      } else {
        bool le = true, lt = false;
        for (int m = 0; m < M; ++m) {
          const float a = Fs[i * M + m], b = Fs[j * M + m];
          le = le && (a <= b);
          lt = lt || (a < b);
        }
        d = le && lt;
      }
      bits |= (unsigned)d << (i - 32 * w);
    }
    dom[e] = bits;
  }
  __syncthreads();
  for (int j = tid; j < N; j += kThreads) {
    int c = 0;
    for (int w = 0; w < W; ++w) c += __popc(dom[j * W + w]);
    ndom[j] = c;
  }

  // peel fronts until every point has one (at most N peels)
  for (int t = 0; t < N; ++t) {
    for (int w = tid; w < W; w += kThreads) front[w] = 0u;
    __syncthreads();
    for (int j = tid; j < N; j += kThreads)
      if (rk[j] < 0 && ndom[j] == 0) atomicOr(&front[j >> 5], 1u << (j & 31));
    __syncthreads();
    if (tid == 0) {
      int c = 0;
      for (int w = 0; w < W; ++w) c += __popc(front[w]);
      start[t + 1] = start[t] + c;
    }
    int left = 0;
    for (int j = tid; j < N; j += kThreads) {
      if (front[j >> 5] >> (j & 31) & 1u) {
        rk[j] = t;
      } else if (rk[j] < 0) {
        int c = 0;
        for (int w = 0; w < W; ++w) c += __popc(dom[j * W + w] & front[w]);
        ndom[j] -= c;
        left = 1;
      }
    }
    if (!__syncthreads_or(left)) break;
  }
  __syncthreads();
  // a point never peeled (none is, as domination has no cycle) takes rank
  // N, as in the plain version, and its own run after the peeled ones
  if (tid == 0) {
    int done = 0;
    for (int j = 0; j < N; ++j) done += rk[j] >= 0;
    start[N] = done;
    start[N + 1] = N;
  }
  for (int j = tid; j < N; j += kThreads)
    if (rk[j] < 0) rk[j] = N;
  __syncthreads();

  // crowding: each (point, objective) finds its place in its front's run
  // of the (f, index) order ...
  for (int pj = tid; pj < N * M; pj += kThreads) {
    const int j = pj / M, m = pj % M;
    const int r = rk[j];
    const float fj = Fs[pj];
    int before = 0;
    for (int k = 0; k < N; ++k)
      before += (rk[k] == r) & key_before(Fs[k * M + m], k, fj, j);
    order[m * N + start[r] + before] = j;
    reinterpret_cast<int*>(gap)[pj] = start[r] + before;  // this thread's, read below
  }
  __syncthreads();
  // ... and reads its neighbours and the run's ends there
  for (int pj = tid; pj < N * M; pj += kThreads) {
    const int j = pj / M, m = pj % M;
    const int r = rk[j];
    const int* run = order + m * N;
    const int lo = start[r], hi = start[r + 1] - 1;
    const int p = reinterpret_cast<const int*>(gap)[pj];
    float d = kBig;
    if (p > lo && p < hi) {
      float span = __fsub_rn(Fs[run[hi] * M + m], Fs[run[lo] * M + m]);  // NaN sorts last
      span = span < 1e-12f ? 1e-12f : span;  // torch.clamp(min=): NaN stays NaN
      d = __fdiv_rn(__fsub_rn(Fs[run[p + 1] * M + m], Fs[run[p - 1] * M + m]), span);
    }
    gap[pj] = d;
  }
  __syncthreads();
  for (int j = tid; j < N; j += kThreads) {
    float sum = 0.f;
    bool boundary = false;
    for (int m = 0; m < M; ++m) {
      const float d = gap[j * M + m];
      boundary = boundary || d >= kBig;
      const float c = d > kBig ? kBig : d;  // torch.clamp(max=): NaN stays NaN
      sum = m == 0 ? c : __fadd_rn(sum, c);
    }
    rank_out[j] = rk[j];
    crowd_out[j] = boundary ? INFINITY : __fdiv_rn(sum, (float)M);
  }
}

size_t smem_bytes(int N, int M) {
  const size_t W = (N + 31) / 32;
  return 4 * ((size_t)N * W + W + 3 * (size_t)N * M + 3 * (size_t)N + 2);
}

size_t g_smem_set[32] = {};  // dynamic shared memory allowed so far, per device

}  // namespace

// K5.  F (N, M) float32, valid (N,) bool or null -> rank (N,) int32,
// crowd (N,) float32.  Returns the first error (attribute or launch).
extern "C" int hebo_nsga2_rank_crowd(const float* F, const unsigned char* valid, int* rank,
                                     float* crowd, int N, int M, void* stream) {
  if (N == 0) return 0;
  if (M < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(N, M);
  if (smem > (size_t)kStaticSmemLimit) {
    int dev = 0;
    int err = (int)cudaGetDevice(&dev);
    if (err) return err;
    if (dev < 0 || dev >= 32) return (int)cudaErrorInvalidDevice;
    if (g_smem_set[dev] < smem) {
      err = (int)cudaFuncSetAttribute(nsga2_rank_crowd,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err) return err;
      g_smem_set[dev] = smem;
    }
  }
  nsga2_rank_crowd<<<1, kThreads, smem, (cudaStream_t)stream>>>(F, valid, rank, crowd, N, M);
  return (int)cudaGetLastError();
}
