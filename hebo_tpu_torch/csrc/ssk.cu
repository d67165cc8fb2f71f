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
// (1.6 us at 67 TFLOP/s), so operations bound it; at BOSS / BOiLS' L = 25
// a pair needs ~9,800 operations, 0.64 GFLOP at (1,256,256).  Most launches
// on the paths are small (the fit's N = M = bucket, the local searches'
// neighbours against the bucket, ssk_self's N pairs): their time is one
// pair's dependent chain plus the launch's fixed cost.  Four routes, chosen
// by shape (pick_route):
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
// * regs32: the same thread per pair and state in registers for
//   12 <= L <= 32 at P <= 3 (LMAX 32), with the column loop outside
//   the step loop: at column b all P steps run, P down to 1 (step p reads
//   T_p[a, b] before step p - 1 overwrites it with row a + 1's value), so
//   one basic block holds every step's work of a column and the chains
//   still interleave; the loop ends at b = L (a uniform branch), so no
//   masked column runs.  Same arithmetic in the same order as regs.
// * warp: for 12 <= L <= 32 at P <= 3 when the launch has few pairs
//   (B * pairs <= 7 L^2), one warp per pair, lane = column, as a
//   wavefront: at step t lane b does row t - b, taking column b - 1's R, u
//   and row code of the same row from lane b - 1 by shuffle, so a pair's
//   dependent chain is 2L - 1 steps of one shuffle and a few FMAs instead of
//   L^2 column steps.  T_p[a, b] of the lane's column lives in the lane's
//   registers; the per-lane sums S_p close by a fixed butterfly.  Its lanes
//   idle half the time, so it pays only while a launch is latency-bound:
//   regs32 takes ~L^2 dependent column steps a pair, the warp route ~2L
//   steps but L times the lanes, so the pair count where regs32 catches up
//   grows as ~L^2 (7 L^2 from same-card comparisons of the two routes
//   at L 25 and 32).
// * smem: the general route for what the register budgets leave (P >= 4 at
//   L > 8, P >= 6, L > 32): one thread per pair, run-time L and P, the same
//   two chains and per-step sums as regs in dynamic shared memory laid out
//   [slot][thread].
//
// Measured on an H100 80GB HBM3 at 700 W (hebo_tpu_torch/bench/ssk_probe.py):
// regs takes 7.9 us per launch at (1,256,256,11,3) and 3.1-3.5 us at every
// launch of a few thousand pairs or fewer.  LMAX 12 at P <= 3 cost ~10% more
// at L = 11 (the masked column still runs its recursions); 128-thread CTAs
// measured the same as 64.  A 16-lane split of one pair was never faster
// than regs at L = 11.  The first design's shared-memory kernel (three
// chains, one thread per pair) took 149-158 us per launch at L = 25 for any
// pair count up to 65,536 and 315 us at (1,256,256,25,3): 175 words of
// state a thread left two CTAs of 128 threads resident per SM.
//
// Each mode has its own kernel symbols (ssk_cross_*, ssk_self_*), so a
// profiler tells them apart.  Sums run in another order than the TPU
// kernel's matmuls: float32 results agree to ~1e-6 relative.

#include <cuda_runtime.h>

namespace {

enum Route { kRegs = 0, kSmem = 1, kRegs32 = 2, kWarp = 3 };

constexpr int kRegThreads = 64;
constexpr int kSmemThreads = 128;
constexpr int kWarpThreads = 128;            // 4 pairs per CTA on the warp route
constexpr long long kWarpWork = 7;           // the warp route takes B * pairs <= kWarpWork * L^2
constexpr size_t kMaxSmem = 232448;          // H100 opt-in shared memory per block
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int lmax_regs(int P) {
  return P >= 1 && P <= 3 ? 11 : P <= 5 ? 8 : 0;
}

// The route for strings of length L, max_subseq P and B * pairs = work.
int pick_route(int L, int P, long long work) {
  if (P < 1 || L < 1) return kSmem;
  if (L <= lmax_regs(P)) return kRegs;
  if (P > 3 || L > 32) return kSmem;
  return work <= kWarpWork * L * L ? kWarp : kRegs32;
}

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

// ---------------------------------------------------------------- regs routes

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

// The same row for LMAX 32, the column loop outside the step loop:
// step p at column b reads T_p[a, b] (tv[p - 2][b]) before step p - 1, which
// runs after it at the same column, replaces it with T_p[a + 1, b].  The loop
// ends at b = L (uniform over the launch).  Each S_p, R and T element sees
// the same operations in the same order as in regs_row.
template <int P, int LMAX, int AMIN>
__device__ __forceinline__ void long_row(int sa, const int (&t)[LMAX], int L, float g,
                                         float (&tv)[NT<P>::v][LMAX],
                                         float (&tg)[NT<P>::v][LMAX], float (&S)[P],
                                         float (&Sg)[P]) {
  float R[NT<P>::v], Rg[NT<P>::v], up[NT<P>::v], ugp[NT<P>::v];
#pragma unroll
  for (int k = 0; k < NT<P>::v; ++k) R[k] = Rg[k] = up[k] = ugp[k] = 0.f;
#pragma unroll
  for (int b = 0; b < LMAX; ++b) {
    if (b >= L) break;
    const bool m = sa == t[b];
#pragma unroll
    for (int p = P; p >= 1; --p) {
      if (p - 1 > AMIN || b < p - 1) continue;  // structural zero row or column
      float u, ug;
      if (p == 1) {
        u = m ? 1.f : 0.f;
        ug = 0.f;
      } else {
        u = m ? tv[p - 2][b] : 0.f;
        ug = m ? tg[p - 2][b] : 0.f;
      }
      S[p - 1] += u;
      if (p > 1) Sg[p - 1] += ug;
      if (p < P) {
        if (b >= p) {
          Rg[p - 1] = fmaf(g, Rg[p - 1], ugp[p - 1] + R[p - 1]);
          R[p - 1] = fmaf(g, R[p - 1], up[p - 1]);
          tg[p - 1][b] = fmaf(g, tg[p - 1][b], Rg[p - 1] + tv[p - 1][b]);
          tv[p - 1][b] = fmaf(g, tv[p - 1][b], R[p - 1]);
        }
        up[p - 1] = u;
        ugp[p - 1] = ug;
      }
    }
  }
}

template <int P, int LMAX, int AMIN>
__device__ __forceinline__ void any_row(int sa, const int (&t)[LMAX], int L, float g,
                                        float (&tv)[NT<P>::v][LMAX], float (&tg)[NT<P>::v][LMAX],
                                        float (&S)[P], float (&Sg)[P]) {
  if constexpr (LMAX > 11)
    long_row<P, LMAX, AMIN>(sa, t, L, g, tv, tg, S, Sg);
  else
    regs_row<P, LMAX, AMIN>(sa, t, L, g, tv, tg, S, Sg);
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
      any_row<P, LMAX, A>(srow[A], t, L, g, tv, tg, S, Sg);
      regs_rows<P, LMAX, A + 1>(srow, t, L, g, tv, tg, S, Sg);
    }
  } else {
    int sa = A < L ? srow[A] : 0;
#pragma unroll 1
    for (int a = A; a < L; ++a) {
      const int sn = a + 1 < L ? srow[a + 1] : 0;  // next row's code, loaded early
      any_row<P, LMAX, A>(sa, t, L, g, tv, tg, S, Sg);
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

// ---------------------------------------------------------------- warp route

// One warp per (batch entry, pair), lane b = column b (L <= 32), run as a
// wavefront: at step t lane b does row a = t - b, so lane b - 1 did the
// same row one step before and hands over what column b's recursions need
// from column b - 1 (u_p, u'_p, R_p, R'_p for p < P, and the row's code) by
// one __shfl_up_sync each.  Lane b keeps T_p[a, b] for p = 2..P and its
// share of S_p.  Every R and T element sees the operations of the serial
// scan in the same order; 2L - 1 steps, each a handful of dependent FMAs
// behind one shuffle's latency, with no branch inside a step but the
// lane's row range.
template <int P, bool SELF>
__device__ __forceinline__ void warp_body(const Args& x) {
  constexpr int NP = NT<P>::v;
  const int lane = threadIdx.x & 31;
  const int bt = blockIdx.y;
  const long long pairs = SELF ? (long long)x.N : (long long)x.N * x.M;
  const long long q = (long long)blockIdx.x * (kWarpThreads / 32) + (threadIdx.x >> 5);
  if (q >= pairs) return;  // the whole warp: q is uniform over it
  const int *srow, *trow;
  pair_rows<SELF>(x, q, srow, trow);
  const int L = x.L;
  const bool live = lane < L;
  const int tb = live ? trow[lane] : 0;  // column b's code
  const int sl = live ? srow[lane] : 0;  // row a's code, held by lane a
  const float g = x.gaps[bt];
  float tv[NP], tg[NP], S[P], Sg[P];
  float pu[NP], pug[NP], pR[NP], pRg[NP];  // column b's values of the lane's last row
#pragma unroll
  for (int k = 0; k < NP; ++k) tv[k] = tg[k] = pu[k] = pug[k] = pR[k] = pRg[k] = 0.f;
#pragma unroll
  for (int p = 0; p < P; ++p) S[p] = Sg[p] = 0.f;
  int code = 0;
#pragma unroll 1
  for (int t = 0; t < 2 * L - 1; ++t) {
    float ru[NP], rug[NP], rR[NP], rRg[NP];  // column b - 1's, row a
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      ru[k] = __shfl_up_sync(kFull, pu[k], 1);
      rug[k] = __shfl_up_sync(kFull, pug[k], 1);
      rR[k] = __shfl_up_sync(kFull, pR[k], 1);
      rRg[k] = __shfl_up_sync(kFull, pRg[k], 1);
    }
    const int up_code = __shfl_up_sync(kFull, code, 1);
    const int row_code = __shfl_sync(kFull, sl, t & 31);  // s[t], for lane 0
    const int a = t - lane;
    if (live && a >= 0 && a < L) {
      code = lane == 0 ? row_code : up_code;
      const bool m = code == tb;
      // Rows a < p - 1 and columns b < p - 1 are structural zeros here too:
      // T_p and u_p are exactly 0 there, so the steps run on them unmasked
      // and leave the same zeros as the routes that skip them.  Lane 0 has
      // no column before it: its R is 0.
#pragma unroll
      for (int p = P; p >= 1; --p) {
        float u, ug;
        if (p == 1) {
          u = m ? 1.f : 0.f;
          ug = 0.f;
        } else {
          u = m ? tv[p - 2] : 0.f;
          ug = m ? tg[p - 2] : 0.f;
        }
        S[p - 1] += u;
        if (p > 1) Sg[p - 1] += ug;
        if (p < P) {
          const float Rg = lane == 0 ? 0.f : fmaf(g, rRg[p - 1], rug[p - 1] + rR[p - 1]);
          const float R = lane == 0 ? 0.f : fmaf(g, rR[p - 1], ru[p - 1]);
          tg[p - 1] = fmaf(g, tg[p - 1], Rg + tv[p - 1]);
          tv[p - 1] = fmaf(g, tv[p - 1], R);
          pu[p - 1] = u;
          pug[p - 1] = ug;
          pR[p - 1] = R;
          pRg[p - 1] = Rg;
        }
      }
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) {
      S[p] += __shfl_xor_sync(kFull, S[p], off);
      Sg[p] += __shfl_xor_sync(kFull, Sg[p], off);
    }
  if (lane == 0) {
    float tot, totl, totg;
    totals<P>(x.lam2s[bt], S, Sg, tot, totl, totg);
    const long long o = (long long)bt * pairs + q;
    x.K[o] = tot;
    x.Kl[o] = totl;
    x.Kg[o] = totg;
  }
}

template <int P>
__global__ void __launch_bounds__(kWarpThreads) ssk_cross_warp(Args x) {
  warp_body<P, false>(x);
}
template <int P>
__global__ void __launch_bounds__(kWarpThreads) ssk_self_warp(Args x) {
  warp_body<P, true>(x);
}

// ---------------------------------------------------------------- smem route

// The regs route's two chains and per-step sums with run-time L and P, in
// shared memory: slot k of the thread at sh[k * nthr + tid].
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

  // slots: T_p value and gap tangent ((p-2)*2 + chain)*L + b for p = 2..P,
  // then S_p, S'_p (2P), then t's L codes
  const int nT = 2 * (P - 1) * L;
  float* T = sh + tid;
  float* Ssh = T + (size_t)nT * nthr;
  int* tsh = reinterpret_cast<int*>(Ssh + (size_t)2 * P * nthr);
  for (int b = 0; b < L; ++b) tsh[(size_t)b * nthr] = trow[b];
  for (int k = 0; k < nT + 2 * P; ++k) T[(size_t)k * nthr] = 0.f;

  const float g = x.gaps[bt];
  for (int a = 0; a < L; ++a) {
    const int sa = srow[a];
    for (int p = P; p >= 1; --p) {
      if (a < p - 1) continue;  // structural zero row
      const float* Tp = p >= 2 ? T + (size_t)(p - 2) * 2 * L * nthr : nullptr;  // T_p, read
      float* Tn = p < P ? T + (size_t)(p - 1) * 2 * L * nthr : nullptr;         // T_(p+1)
      float s = Ssh[(size_t)(p - 1) * nthr], sg = Ssh[(size_t)(P + p - 1) * nthr];
      float R = 0.f, Rg = 0.f, up = 0.f, ugp = 0.f;
      for (int b = p - 1; b < L; ++b) {  // columns < p - 1 are structural zeros
        const bool m = sa == tsh[(size_t)b * nthr];
        float u, ug;
        if (p == 1) {
          u = m ? 1.f : 0.f;
          ug = 0.f;
        } else {
          u = m ? Tp[(size_t)b * nthr] : 0.f;
          ug = m ? Tp[(size_t)(L + b) * nthr] : 0.f;
        }
        s += u;
        if (p > 1) sg += ug;
        if (p < P) {
          if (b >= p) {
            Rg = fmaf(g, Rg, ugp + R);
            R = fmaf(g, R, up);
            float* tvp = Tn + (size_t)b * nthr;
            float* tgp = Tn + (size_t)(L + b) * nthr;
            const float tv = *tvp;
            *tgp = fmaf(g, *tgp, Rg + tv);
            *tvp = fmaf(g, tv, R);
          }
          up = u;
          ugp = ug;
        }
      }
      Ssh[(size_t)(p - 1) * nthr] = s;
      Ssh[(size_t)(P + p - 1) * nthr] = sg;
    }
  }
  const float lam2 = x.lam2s[bt];
  float tot = 0.f, totl = 0.f, totg = 0.f, pw = 1.f;  // as totals<P>
  for (int p = 1; p <= P; ++p) {
    const float S = Ssh[(size_t)(p - 1) * nthr], Sg = Ssh[(size_t)(P + p - 1) * nthr];
    totl = fmaf((float)p * pw, S, totl);
    pw *= lam2;
    tot = fmaf(pw, S, tot);
    totg = fmaf(pw, Sg, totg);
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

template <int P, int LMAX>
int launch_regs(const Args& x, int B, long long pairs, bool self_mode, cudaStream_t s) {
  return self_mode ? grid_launch(ssk_self_regs<P, LMAX>, pairs, kRegThreads, B, 0, s, x)
                   : grid_launch(ssk_cross_regs<P, LMAX>, pairs, kRegThreads, B, 0, s, x);
}

template <int P>
int launch_warp(const Args& x, int B, long long pairs, bool self_mode, cudaStream_t s) {
  return self_mode ? grid_launch(ssk_self_warp<P>, 32 * pairs, kWarpThreads, B, 0, s, x)
                   : grid_launch(ssk_cross_warp<P>, 32 * pairs, kWarpThreads, B, 0, s, x);
}

int launch_smem(const Args& x, int B, long long pairs, bool self_mode, cudaStream_t s) {
  const size_t words = (size_t)2 * (x.P - 1) * x.L + 2 * x.P + x.L;
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
  const int route = pick_route(x.L, x.P, (long long)B * pairs);
  switch (route * 8 + (route == kSmem ? 0 : x.P)) {
    case kRegs * 8 + 1: return launch_regs<1, lmax_regs(1)>(x, B, pairs, self_mode, s);
    case kRegs * 8 + 2: return launch_regs<2, lmax_regs(2)>(x, B, pairs, self_mode, s);
    case kRegs * 8 + 3: return launch_regs<3, lmax_regs(3)>(x, B, pairs, self_mode, s);
    case kRegs * 8 + 4: return launch_regs<4, lmax_regs(4)>(x, B, pairs, self_mode, s);
    case kRegs * 8 + 5: return launch_regs<5, lmax_regs(5)>(x, B, pairs, self_mode, s);
    case kRegs32 * 8 + 1: return launch_regs<1, 32>(x, B, pairs, self_mode, s);
    case kRegs32 * 8 + 2: return launch_regs<2, 32>(x, B, pairs, self_mode, s);
    case kRegs32 * 8 + 3: return launch_regs<3, 32>(x, B, pairs, self_mode, s);
    case kWarp * 8 + 1: return launch_warp<1>(x, B, pairs, self_mode, s);
    case kWarp * 8 + 2: return launch_warp<2>(x, B, pairs, self_mode, s);
    case kWarp * 8 + 3: return launch_warp<3>(x, B, pairs, self_mode, s);
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

// The route hebo_ssk_cross / hebo_ssk_self take for (L, P) at a launch of
// B * pairs = work: 0 regs, 1 smem, 2 regs32, 3 warp.
extern "C" int hebo_ssk_route(int L, int P, long long work) { return pick_route(L, P, work); }
