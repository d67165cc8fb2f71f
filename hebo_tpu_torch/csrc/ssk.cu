// String-subsequence-kernel (SSK) raw totals with forward tangents (kernel K3).
//
// Replaces the Pallas kernels hebo_tpu/ops/pallas_ssk.py::_cross_kernel
// (pallas_call :148) and ::_self_kernel (pallas_call :167).  For every batch
// entry bt (one (lam2, gap) pair per restart or ensemble sample) and every
// pair of integer code strings (s, t) of length L it runs the subsequence DP
// of max_subseq = P steps
//
//   K_1 = lam2 * m,            m[a,b] = (s[a] == t[b])
//   K_p = lam2 * m * (D^T K_{p-1} D),   D[i,j] = gap^(j-i-1) for j > i, else 0
//
// and writes tot = sum_p sum_ab K_p together with its derivatives in lam2
// (the squared match decay) and in gap.  "cross" mode takes all (i, j) pairs
// of s1 (N,L) x s2 (M,L) and writes (B,N,M); "self" mode takes the pairs
// (i, i) of s1 and writes (B,N), the normaliser's diagonal.
//
// Form of the DP.  The TPU kernel flattens each pair's L x L matrix into L^2
// lanes and runs every step as a dense (L^2 x L^2) matmul with W = D (x) D,
// which suits the 128x128 MXU (~2.3e5 FLOP per pair at L = 11).  Because D
// is strictly upper triangular with geometric entries, D^T K D is two decayed
// prefix recursions instead:
//
//   R[i,b] = K[i,b-1] + gap * R[i,b-1]      (along a row)
//   T[a,b] = R[a-1,b] + gap * T[a-1,b]      (down a column),  D^T K D = T,
//
// with tangents R' = K' + R + gap * R' and T' = R' + T + gap * T' in gap
// (R, T the values before the update).  That is O(L^2) per step: at
// (L, P) = (11, 3) the three chains need ~2.3e3 FLOP per pair, counting the
// match mask as a select and skipping the structural zeros (K_p vanishes
// for a or b < p - 1; chip_smoke.py's ssk_flops).  This kernel runs the
// full L x L loops, mask products included.  Row a of step p
// needs only rows < a of step p-1, so all steps stream row by row: for each
// row a, steps run from P down to 1; step p reads T_p (row a) to form its
// row of K_p, then feeds that row's prefix scan R into T_{p+1}, whose row-a
// values step p+1 has already consumed.  The only state carried across rows
// is T_p for p = 2..P: 3 chains x (P-1) x L floats (66 at L = 11, P = 3).
//
// What bounds it on an H100: at the path's shapes (B, N, M) = (1, 256, 256)
// the kernel writes 0.79 MB (0.23 us at 3.35 TB/s) and the DP needs
// ~0.15 GFLOP of dependent FP32 scalar arithmetic (~2.3 us at 67 TFLOP/s),
// so operations bound it, and in practice the per-thread chain does.
//
// Design: one thread per (batch entry, pair).  The carried state T has a
// run-time size (L and P are arguments), so it cannot live in registers
// without one instantiation per (L, P); it lives in dynamic shared memory,
// laid out [slot][thread] so that the 32 threads of a warp touch 32
// consecutive words (no bank conflicts).  The row running scalars (R and
// the previous column's K, three chains each) live in registers.  t's codes
// are staged in shared memory beside T; s's code for the current row is one
// load per row.  The ragged edge is masked by the pair index (q < pairs),
// so the caller pads nothing.  At (L, P) = (11, 3) a thread uses 77 words
// (308 B), a 128-thread block 39 KB.  Sums run in another order than the
// TPU kernel's matmuls: float32 results agree to ~1e-6 relative.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr size_t kMaxSmem = 232448;  // H100 opt-in shared memory per block

__global__ void ssk_kernel(const int* __restrict__ s1, const int* __restrict__ s2,
                           const float* __restrict__ lam2s, const float* __restrict__ gaps,
                           float* __restrict__ K, float* __restrict__ Kl,
                           float* __restrict__ Kg, int N, int M, int L, int P,
                           int self_mode) {
  extern __shared__ float sh[];
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int bt = blockIdx.y;
  const long long pairs = self_mode ? (long long)N : (long long)N * M;
  const long long q = (long long)blockIdx.x * nthr + tid;
  if (q >= pairs) return;  // ragged edge; the kernel has no barrier
  const long long i = self_mode ? q : q / M;
  const long long j = self_mode ? q : q % M;
  const int* srow = s1 + i * L;
  const int* trow = (self_mode ? s1 : s2) + j * L;

  // T slots: ((p-2)*3 + chain)*L + b for p = 2..P, then t's L codes
  const int nT = 3 * (P - 1) * L;
  float* Tsh = sh;
  int* tsh = reinterpret_cast<int*>(sh + (size_t)nT * nthr);
  for (int b = 0; b < L; ++b) tsh[b * nthr + tid] = trow[b];
  for (int k = 0; k < nT; ++k) Tsh[k * nthr + tid] = 0.f;

  const float lam2 = lam2s[bt];
  const float g = gaps[bt];
  float tot = 0.f, totl = 0.f, totg = 0.f;

  for (int a = 0; a < L; ++a) {
    const int sa = srow[a];
    for (int p = P; p >= 1; --p) {
      // T_p (read, p >= 2) and T_{p+1} (updated, p < P)
      const float* Tp = p >= 2 ? Tsh + (size_t)(p - 2) * 3 * L * nthr : nullptr;
      float* Tn = p < P ? Tsh + (size_t)(p - 1) * 3 * L * nthr : nullptr;
      float R = 0.f, Rl = 0.f, Rg = 0.f;     // prefix scan of row a of K_p
      float kp = 0.f, kpl = 0.f, kpg = 0.f;  // K_p[a, b-1]
      for (int b = 0; b < L; ++b) {
        const float m = (sa == tsh[b * nthr + tid]) ? 1.f : 0.f;
        float k, kl, kg;
        if (p == 1) {
          k = lam2 * m;
          kl = m;
          kg = 0.f;
        } else {
          const float tv = Tp[(size_t)(0 * L + b) * nthr + tid];
          const float tl = Tp[(size_t)(1 * L + b) * nthr + tid];
          const float tg = Tp[(size_t)(2 * L + b) * nthr + tid];
          const float lm = lam2 * m;
          k = lm * tv;
          kl = m * fmaf(lam2, tl, tv);
          kg = lm * tg;
        }
        tot += k;
        totl += kl;
        totg += kg;
        if (p < P) {
          Rg = kpg + R + g * Rg;  // uses R before its update
          R = fmaf(g, R, kp);
          Rl = fmaf(g, Rl, kpl);
          float* tvp = Tn + (size_t)(0 * L + b) * nthr + tid;
          float* tlp = Tn + (size_t)(1 * L + b) * nthr + tid;
          float* tgp = Tn + (size_t)(2 * L + b) * nthr + tid;
          const float tv = *tvp;
          *tgp = Rg + tv + g * *tgp;
          *tvp = fmaf(g, tv, R);
          *tlp = fmaf(g, *tlp, Rl);
          kp = k;
          kpl = kl;
          kpg = kg;
        }
      }
    }
  }
  const long long o = (long long)bt * pairs + q;
  K[o] = tot;
  Kl[o] = totl;
  Kg[o] = totg;
}

int launch(const int* s1, const int* s2, const float* lam2, const float* gap,
           float* K, float* Kl, float* Kg, int B, int N, int M, int L, int P,
           int self_mode, cudaStream_t stream) {
  if (L < 1 || P < 1) return (int)cudaErrorInvalidValue;
  const long long pairs = self_mode ? (long long)N : (long long)N * M;
  if (B == 0 || pairs == 0) return 0;
  const size_t words = (size_t)3 * (P - 1) * L + L;
  int nthr = kThreads;
  while (nthr > 32 && words * 4 * nthr > kMaxSmem) nthr /= 2;
  const size_t smem = words * 4 * nthr;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ssk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (pairs + nthr - 1) / nthr;
  if (blocks > 0x7fffffffLL || B > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, B);
  ssk_kernel<<<grid, nthr, smem, stream>>>(s1, s2, lam2, gap, K, Kl, Kg, N, M,
                                           L, P, self_mode);
  return (int)cudaGetLastError();
}

}  // namespace

// s1 (N,L), s2 (M,L) int32 codes; lam2, gap (B,) float32; K, Kl, Kg
// (B,N,M) float32; all contiguous on the device.  Launches on `stream` and
// returns cudaGetLastError() (or cudaErrorInvalidValue for shapes it does
// not take).
extern "C" int hebo_ssk_cross(const int* s1, const int* s2, const float* lam2,
                              const float* gap, float* K, float* Kl, float* Kg,
                              int B, int N, int M, int L, int P, void* stream) {
  return launch(s1, s2, lam2, gap, K, Kl, Kg, B, N, M, L, P, 0,
                (cudaStream_t)stream);
}

// The same DP on the pairs (i, i) of s (N,L): K, Kl, Kg (B,N).
extern "C" int hebo_ssk_self(const int* s, const float* lam2, const float* gap,
                             float* K, float* Kl, float* Kg, int B, int N, int L,
                             int P, void* stream) {
  return launch(s, s, lam2, gap, K, Kl, Kg, B, N, 1, L, P, 1,
                (cudaStream_t)stream);
}
