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
// lanes and runs every step as a dense (L^2 x L^2) matmul with W = D (x) D.
// Here D^T K D is two decayed prefix recursions,
//
//   R[i,b] = K[i,b-1] + gap * R[i,b-1]      (along a row)
//   T[a,b] = R[a-1,b] + gap * T[a-1,b]      (down a column),  D^T K D = T,
//
// with gap tangents R' = K' + R + gap * R' and T' = R' + T + gap * T' (R, T
// the values before the update).  Row a of step p needs only rows < a of
// step p-1, so all steps stream row by row: for each row a, steps run from P
// down to 1; step p reads T_p (row a) to form its row of K_p, and its row
// scan R feeds T_{p+1}, whose row-a values step p+1 has already consumed.
// The state carried across rows is T_p for p = 2..P.
//
// The lam2 tangent needs no chain of its own: K_p = lam2^p V_p with V_1 = m
// and V_p = m * (D^T V_{p-1} D) free of lam2, so with S_p = sum_ab V_p
//
//   tot = sum_p lam2^p S_p,  d tot/d lam2 = sum_p p lam2^(p-1) S_p,
//   d tot/d gap = sum_p lam2^p S'_p        (S'_p the gap tangent of S_p).
//
// Two chains (value and gap tangent) run the recursions, on V.  Structural
// zeros: V_p[a,b] = 0 for a or b < p-1, and its row scan R = 0 for b < p.
//
// What bounds it on an H100: at the AntBO path's (B,N,M) = (1,256,256),
// (L,P) = (11,3), the kernel writes 0.79 MB (0.23 us at 3.35 TB/s) and the
// two-chain DP needs ~1,660 FP32 operations per pair (10 per carried step of
// the R and T recursions, 1-2 per match, the totals), ~0.11 GFLOP in all
// (1.6 us at 67 TFLOP/s), so operations bound it.  Most launches on the path are small (the fit's
// N = M = bucket, the local search's ~209 x 32 pairs, ssk_self's N pairs):
// their time is one pair's dependent chain plus the launch's fixed cost.
// Two routes, chosen by shape (pick_route):
//
// * regs: one thread per (batch entry, pair), templated on P and a
//   compile-time column bound LMAX (11 for P <= 3, AntBO's CDR3 length; 8
//   for P = 4, 5), run-time L <= LMAX with columns b >= L masked out of the
//   match.  T (2 chains x (P-1) x LMAX floats), t's codes and the row's
//   match flags live in registers; every step and column loop unrolls,
//   structural zeros drop at compile time (the first P-1 rows are peeled),
//   the match mask is a select.  The P steps of one row are independent, so
//   their chains interleave: the critical path per row is one row scan (LMAX
//   dependent FMAs), not the whole step sequence.  No spills (ptxas' report,
//   printed by chip_smoke.py).  64-thread CTAs, so a launch of a few
//   hundred pairs spreads over as many SMs as it has CTAs.
// * smem: the general route for L or P beyond the register budget (the
//   kernel of the first port): one thread per pair, run-time L and P, three
//   chains (value, lam2 tangent, gap tangent) in dynamic shared memory laid
//   out [slot][thread].
//
// Measured on an H100 80GB HBM3 at 700 W (hebo_tpu_torch/bench/ssk_probe.py):
// regs takes 7.9 us per launch at (1,256,256,11,3) and 3.1-3.5 us at every
// launch of a few thousand pairs or fewer, where the smem route takes
// 34-44 us.  LMAX 12 at P <= 3 cost ~10% more at L = 11 (the masked column
// still runs its recursions); 128-thread CTAs measured the same as 64.  A
// third route that split one pair over 16 lanes (lane = column, the row scan
// by __shfl_up_sync doubling) was built and measured beside regs at LMAX
// 12: never faster (3.7 vs 3.6 us at 256 self pairs, 48 vs 8.8 us at
// 65,536 cross pairs), so it is not kept.
//
// Each mode has its own kernel symbols (ssk_cross_*, ssk_self_*), so a
// profiler tells them apart.  Sums run in another order than the TPU
// kernel's matmuls: float32 results agree to ~1e-6 relative.

#include <cuda_runtime.h>

namespace {

enum Route { kRegs = 0, kSmem = 1 };

constexpr int kRegThreads = 64;
constexpr int kSmemThreads = 128;
constexpr size_t kMaxSmem = 232448;  // H100 opt-in shared memory per block

__host__ __device__ constexpr int lmax_regs(int P) {
  return P >= 1 && P <= 3 ? 11 : P <= 5 ? 8 : 0;
}

int pick_route(int L, int P) { return P >= 1 && L >= 1 && L <= lmax_regs(P) ? kRegs : kSmem; }

struct Args {
  const int* s1;
  const int* s2;
  const float* lam2s;
  const float* gaps;
  float* K;
  float* Kl;
  float* Kg;
  int N, M, L, P;
};

// The pair q's code rows (self: (i, i)).
template <bool SELF>
__device__ __forceinline__ void pair_rows(const Args& x, long long q, const int*& srow,
                                          const int*& trow) {
  const long long i = SELF ? q : q / x.M;
  const long long j = SELF ? q : q % x.M;
  srow = x.s1 + i * x.L;
  trow = (SELF ? x.s1 : x.s2) + j * x.L;
}

// tot, d/dlam2, d/dgap from the per-step sums S_p, S'_p (p = 1..P).
template <int P>
__device__ __forceinline__ void totals(float lam2, const float (&S)[P], const float (&Sg)[P],
                                       float& tot, float& totl, float& totg) {
  tot = 0.f, totl = 0.f, totg = 0.f;
  float pw = 1.f;  // lam2^(p-1)
#pragma unroll
  for (int p = 1; p <= P; ++p) {
    totl = fmaf((float)p * pw, S[p - 1], totl);
    pw *= lam2;
    tot = fmaf(pw, S[p - 1], tot);
    totg = fmaf(pw, Sg[p - 1], totg);
  }
}

// ---------------------------------------------------------------- regs route

template <int P>
struct NT {
  static constexpr int v = P > 1 ? P - 1 : 1;
};

// One row a of all P steps; rows a < AMIN are gone, AMIN = min(a, P - 1), so
// steps p with p - 1 > AMIN (structural zero rows) drop at compile time.
template <int P, int LMAX, int AMIN>
__device__ __forceinline__ void regs_row(int sa, const int (&t)[LMAX], int L, float g,
                                         float (&tv)[NT<P>::v][LMAX],
                                         float (&tg)[NT<P>::v][LMAX], float (&S)[P],
                                         float (&Sg)[P]) {
  bool m[LMAX];
#pragma unroll
  for (int b = 0; b < LMAX; ++b) m[b] = b < L && sa == t[b];
#pragma unroll
  for (int p = P; p >= 1; --p) {
    if (p - 1 > AMIN) continue;
    float R = 0.f, Rg = 0.f;    // row scan of V_p and its gap tangent
    float up = 0.f, ugp = 0.f;  // V_p[a, b-1], V'_p[a, b-1]
#pragma unroll
    for (int b = 0; b < LMAX; ++b) {
      if (b < p - 1) continue;  // structural zero column
      float u, ug;
      if (p == 1) {
        u = m[b] ? 1.f : 0.f;
        ug = 0.f;
      } else {
        u = m[b] ? tv[p - 2][b] : 0.f;
        ug = m[b] ? tg[p - 2][b] : 0.f;
      }
      S[p - 1] += u;
      if (p > 1) Sg[p - 1] += ug;
      if (p < P) {
        if (b >= p) {  // R = 0 at b <= p - 1
          Rg = fmaf(g, Rg, ugp + R);
          R = fmaf(g, R, up);
          tg[p - 1][b] = fmaf(g, tg[p - 1][b], Rg + tv[p - 1][b]);
          tv[p - 1][b] = fmaf(g, tv[p - 1][b], R);
        }
        up = u;
        ugp = ug;
      }
    }
  }
}

// Rows A..L-1: the first P-1 rows peeled with their compile-time row index,
// the rest in a loop with every step live.
template <int P, int LMAX, int A>
__device__ __forceinline__ void regs_rows(const int* srow, const int (&t)[LMAX], int L, float g,
                                          float (&tv)[NT<P>::v][LMAX],
                                          float (&tg)[NT<P>::v][LMAX], float (&S)[P],
                                          float (&Sg)[P]) {
  if constexpr (A < P - 1) {
    if (A < L) {
      regs_row<P, LMAX, A>(srow[A], t, L, g, tv, tg, S, Sg);
      regs_rows<P, LMAX, A + 1>(srow, t, L, g, tv, tg, S, Sg);
    }
  } else {
    int sa = A < L ? srow[A] : 0;
#pragma unroll 1
    for (int a = A; a < L; ++a) {
      const int sn = a + 1 < L ? srow[a + 1] : 0;  // next row's code, loaded early
      regs_row<P, LMAX, A>(sa, t, L, g, tv, tg, S, Sg);
      sa = sn;
    }
  }
}

template <int P, int LMAX, bool SELF>
__device__ __forceinline__ void regs_body(const Args& x) {
  const int bt = blockIdx.y;
  const long long pairs = SELF ? (long long)x.N : (long long)x.N * x.M;
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= pairs) return;  // ragged edge; one thread per pair, no shuffles
  const int *srow, *trow;
  pair_rows<SELF>(x, q, srow, trow);
  int t[LMAX];
#pragma unroll
  for (int b = 0; b < LMAX; ++b) t[b] = b < x.L ? trow[b] : 0;
  float tv[NT<P>::v][LMAX], tg[NT<P>::v][LMAX];
#pragma unroll
  for (int k = 0; k < NT<P>::v; ++k)
#pragma unroll
    for (int b = 0; b < LMAX; ++b) tv[k][b] = tg[k][b] = 0.f;
  float S[P], Sg[P];
#pragma unroll
  for (int p = 0; p < P; ++p) S[p] = Sg[p] = 0.f;
  regs_rows<P, LMAX, 0>(srow, t, x.L, x.gaps[bt], tv, tg, S, Sg);
  float tot, totl, totg;
  totals<P>(x.lam2s[bt], S, Sg, tot, totl, totg);
  const long long o = (long long)bt * pairs + q;
  x.K[o] = tot;
  x.Kl[o] = totl;
  x.Kg[o] = totg;
}

template <int P, int LMAX>
__global__ void __launch_bounds__(kRegThreads) ssk_cross_regs(Args x) {
  regs_body<P, LMAX, false>(x);
}
template <int P, int LMAX>
__global__ void __launch_bounds__(kRegThreads) ssk_self_regs(Args x) {
  regs_body<P, LMAX, true>(x);
}

// ---------------------------------------------------------------- smem route

template <bool SELF>
__device__ __forceinline__ void smem_body(const Args& x) {
  extern __shared__ float sh[];
  const int L = x.L, P = x.P;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int bt = blockIdx.y;
  const long long pairs = SELF ? (long long)x.N : (long long)x.N * x.M;
  const long long q = (long long)blockIdx.x * nthr + tid;
  if (q >= pairs) return;  // ragged edge; the kernel has no barrier
  const int *srow, *trow;
  pair_rows<SELF>(x, q, srow, trow);

  // T slots: ((p-2)*3 + chain)*L + b for p = 2..P, then t's L codes
  const int nT = 3 * (P - 1) * L;
  float* Tsh = sh;
  int* tsh = reinterpret_cast<int*>(sh + (size_t)nT * nthr);
  for (int b = 0; b < L; ++b) tsh[b * nthr + tid] = trow[b];
  for (int k = 0; k < nT; ++k) Tsh[k * nthr + tid] = 0.f;

  const float lam2 = x.lam2s[bt];
  const float g = x.gaps[bt];
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
  x.K[o] = tot;
  x.Kl[o] = totl;
  x.Kg[o] = totg;
}

__global__ void ssk_cross_smem(Args x) { smem_body<false>(x); }
__global__ void ssk_self_smem(Args x) { smem_body<true>(x); }

// ------------------------------------------------------------------ launches

template <typename Kern>
int grid_launch(Kern kern, long long threads, int nthr, int B, size_t smem, cudaStream_t stream,
                const Args& x) {
  const long long blocks = (threads + nthr - 1) / nthr;
  if (blocks > 0x7fffffffLL || B > 65535) return (int)cudaErrorInvalidValue;
  kern<<<dim3((unsigned)blocks, B), nthr, smem, stream>>>(x);
  return (int)cudaGetLastError();
}

template <int P>
int launch_regs(const Args& x, int B, long long pairs, bool self_mode, cudaStream_t s) {
  constexpr int LMAX = lmax_regs(P);
  return self_mode ? grid_launch(ssk_self_regs<P, LMAX>, pairs, kRegThreads, B, 0, s, x)
                   : grid_launch(ssk_cross_regs<P, LMAX>, pairs, kRegThreads, B, 0, s, x);
}

int launch_smem(const Args& x, int B, long long pairs, bool self_mode, cudaStream_t s) {
  const size_t words = (size_t)3 * (x.P - 1) * x.L + x.L;
  int nthr = kSmemThreads;
  while (nthr > 32 && words * 4 * nthr > kMaxSmem) nthr /= 2;
  const size_t smem = words * 4 * nthr;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kern = self_mode ? ssk_self_smem : ssk_cross_smem;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return grid_launch(kern, pairs, nthr, B, smem, s, x);
}

int launch(const Args& x, int B, bool self_mode, cudaStream_t s) {
  if (x.L < 1 || x.P < 1) return (int)cudaErrorInvalidValue;
  const long long pairs = self_mode ? (long long)x.N : (long long)x.N * x.M;
  if (B == 0 || pairs == 0) return 0;
  switch (pick_route(x.L, x.P) == kSmem ? 0 : x.P) {
    case 1: return launch_regs<1>(x, B, pairs, self_mode, s);
    case 2: return launch_regs<2>(x, B, pairs, self_mode, s);
    case 3: return launch_regs<3>(x, B, pairs, self_mode, s);
    case 4: return launch_regs<4>(x, B, pairs, self_mode, s);
    case 5: return launch_regs<5>(x, B, pairs, self_mode, s);
    default: return launch_smem(x, B, pairs, self_mode, s);
  }
}

}  // namespace

// s1 (N,L), s2 (M,L) int32 codes; lam2, gap (B,) float32; K, Kl, Kg
// (B,N,M) float32; all contiguous on the device.  Picks the route by shape,
// launches on `stream` and returns cudaGetLastError() (or
// cudaErrorInvalidValue for shapes it does not take).
extern "C" int hebo_ssk_cross(const int* s1, const int* s2, const float* lam2,
                              const float* gap, float* K, float* Kl, float* Kg,
                              int B, int N, int M, int L, int P, void* stream) {
  const Args x{s1, s2, lam2, gap, K, Kl, Kg, N, M, L, P};
  return launch(x, B, false, (cudaStream_t)stream);
}

// The same DP on the pairs (i, i) of s (N,L): K, Kl, Kg (B,N).
extern "C" int hebo_ssk_self(const int* s, const float* lam2, const float* gap,
                             float* K, float* Kl, float* Kg, int B, int N, int L,
                             int P, void* stream) {
  const Args x{s, s, lam2, gap, K, Kl, Kg, N, 1, L, P};
  return launch(x, B, true, (cudaStream_t)stream);
}

// The route hebo_ssk_cross / hebo_ssk_self take for (L, P): 0 regs, 1 smem.
extern "C" int hebo_ssk_route(int L, int P) { return pick_route(L, P); }
