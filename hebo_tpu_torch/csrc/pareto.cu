// NSGA-II nondominated rank, crowding distance, sort key and survivor order
// (kernel K5): one launch of one CTA, all in shared memory, where it fits
// (hebo_nsga2_fits: up to ~1,250 rows at M >= 2, 4,096 at M = 1), and the
// grid route past it, up to 32,768 rows (after nsga2_rank_crowd below).
//
// Replaces hebo_tpu/ops/pareto.py::nondominated_rank (:45-78, an XLA
// while_loop over the (P, P) domination matrix), crowding_distance
// (:81-127, per-objective lexsorts and segment min/max) and nsga2_key
// (:130-141, an argsort of an argsort), and the stable argsort of that key
// that survival takes (acq_optimizers/evolution.py).  The JAX package has
// no pallas_call here: XLA keeps the peel loop and the sorts on the device.
//
// Input F (N, M) float32 (N = P for the tournament, 2P for survival), an
// optional valid (N,) bool mask, n_keep.  Outputs, equal to the plain
// version (ops/pareto.py: nsga2_rank_crowd_plain, nsga2_key, a stable
// argsort) bit for bit:
//   rank  (N,) int32: D[i][j] (i dominates j) is all(F_i <= F_j) and
//         any(F_i < F_j) with IEEE compares (a NaN compares false); with the
//         mask an invalid row dominates nothing and every valid row
//         dominates it.  Front t is the points with no dominator left after
//         fronts 0..t-1 are peeled (rank N for a point never peeled: none
//         is, as domination has no cycle).
//   crowd (N,) float32: per objective m, in the order (rank, f, index) with
//         NaN after every number and -0 equal to +0, d_m = (f_next -
//         f_prev) / span for a point with a neighbour of its front on both
//         sides, else 1e30; span = max(f_max - f_min, 1e-12) over the
//         front, NaN if the front holds a NaN in m; crowd = inf if any d_m
//         >= 1e30, else (d_0 + d_1 + ...) / M summed in objective order with
//         each d_m clamped to at most 1e30 (a NaN passes through).
//   key   (N,) float32, optional: rank * N + ordinal, the ordinal being the
//         point's place in the stable descending order of crowd (NaN as
//         -inf).  The keys are distinct integers below 2^24.
//   order (n_keep,) int64, optional: order[k] is the point with exactly k
//         keys below its own, i.e. torch.argsort(key, stable=True)[:n_keep].
//
// What bounds it on an H100: latency, not bytes or FLOPs.  At N = 200, M = 3
// it reads 2.4 KB and does ~240k compares: well under a microsecond of one
// SM's instruction throughput.  The time is the launch, the chain of peels
// (one per front, each waiting on the last), the barriers between phases
// and the dependent loads of one thread per point.  v3 (one CTA of 1024
// threads, three CTA barriers, a serial count and a dominator count per
// front, an O(N^2 M) crowding placement) took 22.3 us at (100, 3), 45.9 at
// (200, 3), 97.7 at (100, 1) and 220.9 at (200, 1), and the callers then
// sorted its output three times per generation (PERF.md, the K5 row).  This
// version:
// one CTA of 512 threads, all in shared memory.  The per-point passes take
// a thread per point (at the NSGA-II loops' N <= 256 half the threads wait
// there); the dom tiles spread over 16 warps, which measured faster than 8
// (256 threads) and than 32 (1024, whose barriers wait on more warps).  The
// code is compact (one instantiation per M in 2..4 for dom, per register
// width for the peel): a launch inside HEBO's graph finds the instruction
// cache cold.
//   load   F as rows padded to 2 or 4 floats (one vector load per point;
//          zero rows up to a multiple of 32), valid once as a bitmask;
//   dom    N x WS words (WS = W | 1 for conflict-free row reads, W =
//          ceil(N/32)): bit i of dom[j][w] says point 32w+i dominates j.  A
//          warp takes a pair of words (a <= b): each lane holds one point i
//          of word a in registers and walks the 32 points j of word b;
//          all(F_i <= F_j) and all(F_j <= F_i) give both directions (with
//          one of them true no NaN is involved, so any(<) is the other's
//          negation): one __ballot_sync gives dom[j][a], another the
//          reverse, which a 32 x 32 bit transpose turns into dom[i][b]; the
//          valid mask applies to whole words after the 32 steps.  Half the
//          tiles, half the compares of a full sweep.
//   peel   (M >= 2) warp 0 alone, no CTA barrier: the unpeeled set is a
//          bitmask held by every lane, each lane owns points j = lane (mod
//          32) with their dom rows, ranks and slots in registers (N <= 256;
//          shared memory beyond), a point is in the front when dom[j] &
//          unpeeled is zero, __ballot_sync gives the front's words and
//          __popc of the ballots where the front starts (start[t]) and
//          each member's slot (memb: front by front, in index order).
//   rank at M = 1: no peel.  With one objective i dominates j exactly when
//          f_i < f_j, so a valid number's rank is the count of distinct
//          valid numbers below it (-0 and +0 one value, +-inf as numbers), a
//          valid NaN's is 0 and an invalid row's is 1 + the largest valid
//          rank (0 when no row is valid).  Two O(N^2) passes of independent
//          compares on order keys (first of its value, rank), then a count
//          per rank, a one-warp scan into start and a cursor per rank for
//          the slots.
//   crowd  per objective: each member counts the members of its front
//          below it in (f's order key, point), 64-bit keys with no NaN
//          branch, O(sum of front sizes^2); then reads its neighbours and
//          the run's ends.  The sum runs in objective order.
//   key    each point counts the points before it in (crowding descending,
//   order  point), O(N^2) on 64-bit keys, two a load; then the members of
//          its front of smaller ordinal: its place in the key order.  No
//          sort.
// About 2M + 6 CTA barriers per launch, none per front.  The O(N^2) loops
// load 16 bytes at a time into independent counts: a dependent chain of
// loads or adds per element is what v1-v3 lost their time to.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNaNKey = 0xffffffffu;
constexpr float kBig = 1e30f;
constexpr int kSmemMax = 232448;  // dynamic shared memory one H100 CTA may use
constexpr int kNMax = 4096;       // rank * N + ordinal stays below 2^24: exact in float32
constexpr int kStaticSmemLimit = 48 * 1024;

// An unsigned key in the order of torch.argsort on floats: -0 as +0, NaN
// after +inf, every NaN equal.
__device__ __forceinline__ unsigned order_key(float f) {
  if (isnan(f)) return kNaNKey;
  const unsigned u = __float_as_uint(f == 0.f ? 0.f : f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Row stride of F in shared memory: one 8- or 16-byte load per point.
__host__ __device__ __forceinline__ int row_stride(int M) { return M == 3 ? 4 : M; }
// Every array in shared memory starts on 16 bytes (uint4 loads).
__host__ __device__ __forceinline__ int align4(int n) { return (n + 3) & ~3; }

struct Lt { __device__ bool operator()(unsigned a, unsigned b) const { return a < b; } };
struct Eq { __device__ bool operator()(unsigned a, unsigned b) const { return a == b; } };

// #{lo <= k < hi : cmp(a[k], x)}, a 16-byte aligned: uint4 loads and four
// independent counts, so the loop waits on no load and no add.
template <class Cmp>
__device__ __forceinline__ int count_range(const unsigned* a, int lo, int hi, unsigned x, Cmp cmp) {
  int c0 = 0, c1 = 0, c2 = 0, c3 = 0, k = lo;
  for (; k < hi && (k & 3); ++k) c0 += cmp(a[k], x);
#pragma unroll 4
  for (; k + 4 <= hi; k += 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(a + k);
    c0 += cmp(v.x, x);
    c1 += cmp(v.y, x);
    c2 += cmp(v.z, x);
    c3 += cmp(v.w, x);
  }
  for (; k < hi; ++k) c1 += cmp(a[k], x);
  return c0 + c1 + c2 + c3;
}

// #{lo <= k < hi : a[k] < x}, a 16-byte aligned: two keys a load, two
// counts.
__device__ __forceinline__ int count_lt64(const unsigned long long* a, int lo, int hi,
                                          unsigned long long x) {
  int c0 = 0, c1 = 0, k = lo;
  if (k < hi && (k & 1)) c1 += a[k++] < x;
#pragma unroll 4
  for (; k + 2 <= hi; k += 2) {
    const ulonglong2 v = *reinterpret_cast<const ulonglong2*>(a + k);
    c0 += v.x < x;
    c1 += v.y < x;
  }
  if (k < hi) c0 += a[k] < x;
  return c0 + c1;
}

template <int MR>
__device__ __forceinline__ void load_row(const float* Fr, int i, float* f) {
  if constexpr (MR == 2) {
    const float2 v = reinterpret_cast<const float2*>(Fr)[i];
    f[0] = v.x, f[1] = v.y;
  } else {
    const float4 v = reinterpret_cast<const float4*>(Fr)[i];
    f[0] = v.x, f[1] = v.y, f[2] = v.z;
    if constexpr (MR == 4) f[3] = v.w;
  }
}

// Transposes the 32 x 32 bit matrix held one row a lane (bit c of lane r's
// word is element (r, c)): five rounds of swapping off-diagonal blocks.
__device__ __forceinline__ unsigned transpose32(unsigned x, int lane) {
  const unsigned masks[5] = {0x0000ffffu, 0x00ff00ffu, 0x0f0f0f0fu, 0x33333333u, 0x55555555u};
#pragma unroll
  for (int r = 0, s = 16; r < 5; ++r, s >>= 1) {
    const unsigned m = masks[r], y = __shfl_xor_sync(kFull, x, s);
    x = (lane & s) ? (x & ~m) | ((y & ~m) >> s) : (x & m) | ((y & m) << s);
  }
  return x;
}

// dom: a warp per pair of words (a <= b).  MR = M for M in 2..4 (the row in
// registers, one vector load per j, the 32 steps unrolled), 0 for any M
// (rolled).  Each step is compares and two ballots: col, bits i dominating
// j (dom[j][a]), kept by lane j; row, bits i that j dominates, kept by lane
// j and transposed into dom[i][b] after the 32 steps.  The mask is applied
// to whole words after the loop (an invalid row dominates nothing and
// every valid row dominates it); rows past N are zero-padded and masked
// the same way.
template <int MR>
__device__ void build_dom(const float* Fr, const unsigned* vm, unsigned* dom, int N, int M,
                          int W, int WS, int warp, int lane) {
  const int units = W * (W + 1) / 2;
  const int MP = MR == 2 ? 2 : MR > 0 ? 4 : M;
  for (int u = warp; u < units; u += kWarps) {
    int a = 0, rem = u;
    while (rem >= W - a) rem -= W - a, ++a;
    const int b = a + rem;
    const int i = 32 * a + lane;
    float fi[MR > 0 ? MR : 1];
    if constexpr (MR > 0) load_row<MR>(Fr, i, fi);
    const float* Fb = Fr + 32 * b * MP;
    unsigned col_j = 0u, row_j = 0u;
    auto step = [&](int jj) {
      bool le_ij = true, le_ji = true;
      if constexpr (MR > 0) {
        float fj[MR];
        load_row<MR>(Fb, jj, fj);
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          le_ij = le_ij && (fi[m] <= fj[m]);
          le_ji = le_ji && (fj[m] <= fi[m]);
        }
      } else {
        for (int m = 0; m < M; ++m) {
          const float x = Fr[i * M + m], y = Fb[jj * M + m];
          le_ij = le_ij && (x <= y);
          le_ji = le_ji && (y <= x);
        }
      }
      // with one of le_ij, le_ji true no NaN is involved, so any(<) is the
      // other's negation
      const unsigned col = __ballot_sync(kFull, le_ij && !le_ji);  // i dominates j
      const unsigned row = __ballot_sync(kFull, le_ji && !le_ij);  // j dominates i
      col_j = lane == jj ? col : col_j;
      row_j = lane == jj ? row : row_j;
    };
    if constexpr (MR > 0) {
#pragma unroll
      for (int jj = 0; jj < 32; ++jj) step(jj);
    } else {
#pragma unroll 1
      for (int jj = 0; jj < 32; ++jj) step(jj);
    }
    // lane l is point j = 32b + l here; the words over i in word a
    const unsigned va = vm[a], in_a = 32 * a + 32 <= N ? kFull : (1u << (N - 32 * a)) - 1u;
    const bool vj = (vm[b] >> lane) & 1u;
    if (32 * b + lane < N) dom[(32 * b + lane) * WS + a] = vj ? col_j & va : va;
    if (a != b) {
      row_j = vj ? (row_j & va) | (in_a & ~va) : 0u;
      const unsigned row_i = transpose32(row_j, lane);  // lane l is point 32a + l: bits j in b
      if (32 * a + lane < N) dom[(32 * a + lane) * WS + b] = row_i;
    }
  }
}

// The peel by one warp, the dom rows of its points, their ranks and slots in
// registers (N <= 32 WR).  Per front: the hit test, a ballot per word, and
// the members' ranks and slots by select.
template <int WR>
__device__ void peel_regs(const unsigned* dom, int* rk, int* memb, int* start, int N, int W,
                          int WS, int lane) {
  unsigned Um[WR], d[WR][WR];
  int rank[WR], slot[WR];
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < WR; ++k) {
    const int j = 32 * k + lane, left = N - 32 * k;
    Um[k] = left >= 32 ? kFull : left > 0 ? (1u << left) - 1u : 0u;
    rank[k] = N, slot[k] = 0;
#pragma unroll
    for (int w = 0; w < WR; ++w) d[k][w] = (j < N && w < W) ? dom[j * WS + w] : 0u;
  }
  int s = 0;
  for (int t = 0; s < N; ++t) {
    unsigned fr[WR];
#pragma unroll
    for (int k = 0; k < WR; ++k) {
      unsigned hit = 0u;
#pragma unroll
      for (int w = 0; w < WR; ++w) hit |= d[k][w] & Um[w];
      fr[k] = __ballot_sync(kFull, ((Um[k] >> lane) & 1u) && hit == 0u);
    }
    int c = s;
#pragma unroll
    for (int k = 0; k < WR; ++k) {
      const bool in = (fr[k] >> lane) & 1u;
      rank[k] = in ? t : rank[k];
      slot[k] = in ? c + __popc(fr[k] & lt) : slot[k];
      c += __popc(fr[k]);
      Um[k] &= ~fr[k];
    }
    if (lane == 0) start[t] = s, start[t + 1] = c;
    if (c == s) {
      // nothing peeled (it cannot happen: domination has no cycle): the
      // rest take rank N, as in the plain version, and the last run
#pragma unroll
      for (int k = 0; k < WR; ++k) {
        slot[k] = (Um[k] >> lane) & 1u ? c + __popc(Um[k] & lt) : slot[k];
        c += __popc(Um[k]);
      }
      if (lane == 0) start[N] = s, start[N + 1] = N;
      break;
    }
    s = c;
  }
#pragma unroll
  for (int k = 0; k < WR; ++k) {
    const int j = 32 * k + lane;
    if (j < N) rk[j] = rank[k], memb[slot[k]] = j;
  }
}

// The peel by one warp for N > 256: dom rows and the unpeeled set (Um, W
// words) in shared memory, the front's words staged in fw.
__device__ void peel_smem(const unsigned* dom, unsigned* Um, unsigned* fw, int* rk, int* memb,
                          int* start, int N, int W, int WS, int lane) {
  const unsigned lt = (1u << lane) - 1u;
  for (int k = lane; k < W; k += 32) {
    const int left = N - 32 * k;
    Um[k] = left >= 32 ? kFull : (1u << left) - 1u;
  }
  for (int j = lane; j < N; j += 32) rk[j] = N;
  __syncwarp();
  int s = 0;
  for (int t = 0; s < N; ++t) {
    int c = s;
    for (int k = 0; k < W; ++k) {
      bool in = false;
      if ((Um[k] >> lane) & 1u) {
        const unsigned* row = dom + (32 * k + lane) * WS;
        unsigned hit = 0u;
        for (int w = 0; w < W; ++w) hit |= row[w] & Um[w];
        in = hit == 0u;
      }
      const unsigned f = __ballot_sync(kFull, in);
      if (in) rk[32 * k + lane] = t, memb[c + __popc(f & lt)] = 32 * k + lane;
      c += __popc(f);
      if (lane == 0) fw[k] = f;
    }
    __syncwarp();
    for (int k = lane; k < W; k += 32) Um[k] &= ~fw[k];
    if (lane == 0) start[t] = s, start[t + 1] = c;
    __syncwarp();
    if (c == s) {
      // nothing peeled (it cannot happen): the rest keep rank N, last run
      for (int k = 0; k < W; ++k) {
        const unsigned f = Um[k];
        if ((f >> lane) & 1u) memb[c + __popc(f & lt)] = 32 * k + lane;
        c += __popc(f);
      }
      if (lane == 0) start[N] = s, start[N + 1] = N;
      break;
    }
    s = c;
  }
}

// M = 1: the closed-form rank, then the members' slots by a count per rank
// (start, zeroed by the caller) and a cursor per rank.  Scratch in the
// union region: hk, gk (order keys), cur (N + 1 counters).
__device__ void rank_one_objective(const float* Fr, const unsigned* vm, int* rk, int* memb,
                                   int* start, unsigned* U, int N, int W, int tid, int warp,
                                   int lane) {
  unsigned* hk = U;                                      // valid ? key : NaN's
  unsigned* gk = hk + align4(N);                         // key at its value's first index
  int* cur = reinterpret_cast<int*>(gk + align4(N));     // N + 1
  for (int i = tid; i < N; i += kThreads) {
    hk[i] = ((vm[i >> 5] >> (i & 31)) & 1u) ? order_key(Fr[i]) : kNaNKey;
    cur[i] = 0;
  }
  if (tid == 0) cur[N] = 0;
  __syncthreads();
  int firsts = 0;
  for (int i = tid; i < N; i += kThreads) {
    const unsigned x = hk[i];
    const bool first = x != kNaNKey && count_range(hk, 0, i, x, Eq()) == 0;
    gk[i] = first ? x : kNaNKey;
    firsts += first;
  }
  if (firsts) atomicAdd(cur + N, firsts);
  __syncthreads();
  const int distinct = cur[N];
  bool any_valid = false;
  for (int w = 0; w < W; ++w) any_valid = any_valid || vm[w] != 0u;
  for (int i = tid; i < N; i += kThreads) {
    const unsigned x = hk[i];
    int r = 0;
    if (!((vm[i >> 5] >> (i & 31)) & 1u)) r = any_valid ? max(distinct, 1) : 0;
    else if (x != kNaNKey) r = count_range(gk, 0, N, x, Lt());
    rk[i] = r;
    atomicAdd(start + r + 1, 1);
  }
  __syncthreads();
  // start[r] = #{rank < r}: an inclusive scan of the counts by one warp
  if (warp == 0) {
    int carry = 0;
    for (int base = 1; base <= N + 1; base += 32) {
      const int k = base + lane;
      int v = k <= N + 1 ? start[k] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, v, o);
        v += lane >= o ? y : 0;
      }
      if (k <= N + 1) start[k] = v + carry;
      carry += __shfl_sync(kFull, v, 31);
    }
  }
  __syncthreads();
  for (int i = tid; i < N; i += kThreads) {
    const int r = rk[i];
    memb[start[r] + atomicAdd(cur + r, 1)] = i;
  }
}

__global__ void __launch_bounds__(kThreads)
nsga2_rank_crowd(const float* __restrict__ F, const unsigned char* __restrict__ valid,
                 int* __restrict__ rank_out, float* __restrict__ crowd_out,
                 float* __restrict__ key_out, long long* __restrict__ order_out, int n_keep,
                 int N, int M) {
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int W = (N + 31) / 32, WS = W | 1, MP = row_stride(M);
  float* Fr = reinterpret_cast<float*>(smem4);                        // 32W * MP, zero past N
  unsigned* vm = reinterpret_cast<unsigned*>(Fr + align4(32 * W * MP));  // W: valid bits
  unsigned* Um = vm + W;                                              // W: unpeeled (N > 256)
  unsigned* fw = Um + W;                                              // W: a front's words
  int* rk = reinterpret_cast<int*>(vm + align4(3 * W));               // N: rank by point
  int* memb = rk + align4(N);                                         // N: points front by front
  int* start = memb + align4(N);                                      // N + 2: where front t starts
  unsigned* U = reinterpret_cast<unsigned*>(start + align4(N + 2));   // union, smem_words()

  for (int e = tid; e < N * M; e += kThreads) {
    const int i = e / M;
    Fr[i * MP + e - i * M] = F[e];
  }
  for (int e = N * MP + tid; e < 32 * W * MP; e += kThreads) Fr[e] = 0.f;  // rows past N
  for (int w = warp; w < W; w += kWarps) {
    const int i = 32 * w + lane;
    const unsigned bits = __ballot_sync(kFull, i < N && (valid == nullptr || valid[i]));
    if (lane == 0) vm[w] = bits;
  }
  for (int r = tid; r < N + 2; r += kThreads) start[r] = 0;
  __syncthreads();

  if (M == 1) {
    rank_one_objective(Fr, vm, rk, memb, start, U, N, W, tid, warp, lane);
  } else {
    unsigned* dom = U;
    switch (M) {
      case 2: build_dom<2>(Fr, vm, dom, N, M, W, WS, warp, lane); break;
      case 3: build_dom<3>(Fr, vm, dom, N, M, W, WS, warp, lane); break;
      case 4: build_dom<4>(Fr, vm, dom, N, M, W, WS, warp, lane); break;
      default: build_dom<0>(Fr, vm, dom, N, M, W, WS, warp, lane); break;
    }
    __syncthreads();
    if (warp == 0) {
      if (W <= 2) peel_regs<2>(dom, rk, memb, start, N, W, WS, lane);
      else if (W <= 4) peel_regs<4>(dom, rk, memb, start, N, W, WS, lane);
      else if (W <= 7) peel_regs<7>(dom, rk, memb, start, N, W, WS, lane);  // survival at P 100
      else if (W <= 8) peel_regs<8>(dom, rk, memb, start, N, W, WS, lane);
      else peel_smem(dom, Um, fw, rk, memb, start, N, W, WS, lane);
    }
  }
  __syncthreads();

  // crowding, one objective at a time, in slot order p (member memb[p]); a
  // front's run is the order of the keys (f's order key, point)
  unsigned long long* uk = reinterpret_cast<unsigned long long*>(U);  // N
  int* run = reinterpret_cast<int*>(U + align4(2 * N));  // N: the (rank, f, point) order
  int* pos = run + align4(N);                            // N: each slot's place in run
  float* sum = reinterpret_cast<float*>(pos + align4(N));  // N: sum of clamped d_m
  int* edge = reinterpret_cast<int*>(sum + align4(N));     // N: some d_m >= 1e30
  int* fb = edge + align4(N);                              // N: the slot's front, s | e << 16
  auto key_of = [&](int j, int m) {
    return (unsigned long long)order_key(Fr[j * MP + m]) << 32 | (unsigned)j;
  };
  for (int p = tid; p < N; p += kThreads) {
    const int j = memb[p], r = rk[j];
    uk[p] = key_of(j, 0);
    fb[p] = start[r] | start[r + 1] << 16;
  }
  __syncthreads();
  for (int m = 0; m < M; ++m) {
    for (int p = tid; p < N; p += kThreads) {
      const int s = fb[p] & 0xffff, e = fb[p] >> 16;
      const int x = s + count_lt64(uk, s, e, uk[p]);
      run[x] = memb[p];
      pos[p] = x;
    }
    __syncthreads();
    for (int p = tid; p < N; p += kThreads) {
      const int s = fb[p] & 0xffff, e = fb[p] >> 16, x = pos[p];
      float d = kBig;
      if (x > s && x < e - 1) {
        float span = __fsub_rn(Fr[run[e - 1] * MP + m], Fr[run[s] * MP + m]);  // NaN sorts last
        span = span < 1e-12f ? 1e-12f : span;  // torch.clamp(min=): NaN stays NaN
        d = __fdiv_rn(__fsub_rn(Fr[run[x + 1] * MP + m], Fr[run[x - 1] * MP + m]), span);
      }
      const float c = d > kBig ? kBig : d;  // torch.clamp(max=): NaN stays NaN
      sum[p] = m == 0 ? c : __fadd_rn(sum[p], c);
      edge[p] = (m == 0 ? 0 : edge[p]) | (d >= kBig);
      if (m + 1 < M) uk[p] = key_of(memb[p], m + 1);
    }
    __syncthreads();
  }

  // outputs by point; in slot order, the key of the crowding's descending
  // order, ties by point (stable, as torch.argsort)
  unsigned long long* ck = uk;  // N (uk, run and pos are dead)
  int* ords = run;              // N: each slot's ordinal
  for (int p = tid; p < N; p += kThreads) {
    const int j = memb[p];
    const float c = edge[p] ? INFINITY : __fdiv_rn(sum[p], (float)M);
    crowd_out[j] = c;
    rank_out[j] = rk[j];
    ck[p] = (unsigned long long)~order_key(isnan(c) ? -INFINITY : c) << 32 | (unsigned)j;
  }
  if (key_out == nullptr) return;
  __syncthreads();
  // ordinal: the points before in that order
  for (int p = tid; p < N; p += kThreads) {
    const int o = count_lt64(ck, 0, N, ck[p]), j = memb[p];
    ords[p] = o;
    key_out[j] = __fadd_rn(__fmul_rn((float)rk[j], (float)N), (float)o);
  }
  if (order_out == nullptr || n_keep <= 0) return;
  __syncthreads();
  // order: the fronts before, then the members of the front of lower ordinal
  for (int p = tid; p < N; p += kThreads) {
    const int s = fb[p] & 0xffff, e = fb[p] >> 16;
    const int x = s + count_range(reinterpret_cast<const unsigned*>(ords), s, e, ords[p], Lt());
    if (x < n_keep) order_out[x] = memb[p];
  }
}

// Shared memory words: F's rows, the valid bits, Um and fw, rank, memb,
// start, and the union of dom (M >= 2), M = 1's scratch and the crowding's
// arrays.
size_t smem_words(int N, int M) {
  const int W = (N + 31) / 32, WS = W | 1;
  const size_t dom = M >= 2 ? (size_t)N * WS : 0;
  const size_t one = 2 * (size_t)align4(N) + N + 1;
  const size_t crowd = (size_t)align4(2 * N) + 5 * (size_t)align4(N);
  const size_t u = dom > crowd ? dom : crowd;
  return (size_t)align4(32 * W * row_stride(M)) + align4(3 * W) + 2 * (size_t)align4(N) +
         align4(N + 2) + (u > one ? u : one);
}

size_t g_smem_set[32] = {};  // dynamic shared memory allowed so far, per device


// ---------------------------------------------------------------------------
// The grid route: every N the one-CTA route refuses, up to kGridNMax rows.
//
// Past ~1,250 rows at M >= 2 the dom bitset (N * ceil(N/32) words) outgrows
// one CTA's shared memory (NSGA-II survival ranks 2 * pop rows: MACE above
// pop 624), and past N = 4096 the keys rank * N + ordinal leave float32's
// exact integers.  This route keeps the bitset in device memory (2 MiB at
// N = 4096, 8 MiB at 8192: both stay in L2) and spreads the O(N^2) passes
// over a grid.  A fixed sequence of launches whatever the data, no host
// read, every scratch array from the caller:
//   M >= 2:  nsga2_grid_zero zeroes the dominator counts;
//     nsga2_grid_dom: a warp per pair of words (a <= b), the ballots and
//       32 x 32 transposes of build_dom, writes both directions' "whom i
//       dominates" rows (domr, N x W words) and adds each point's
//       dominators to its count by integer atomics (any order gives the
//       same counts);
//     nsga2_grid_peel: one CTA peels by dominator counts (Deb's fast
//       nondominated sort): front t's members' domr rows lower their
//       dominatees' counts (16-bit, in shared memory), a word of 32 points
//       by a warp, 32 members at a time by a bit transpose; a count
//       reaching 0 puts its point in front t + 1.  One CTA barrier a front,
//       and the bitset read once over all fronts, where the one-CTA peel
//       tests every unpeeled row per front.
//   M = 1:  nsga2_grid_first and nsga2_grid_rank_one, rank_one_objective's
//     closed form as two counting passes, a warp a point; nsga2_grid_group:
//     one CTA turns the ranks into front starts (a count per rank, a scan)
//     and members.
//   nsga2_grid_crowd: a warp a point; per objective its place in its
//     front's run (f's order key, point), its neighbours and the run's ends
//     from one pass over the front's members and warp reductions; the sum
//     in objective order, as nsga2_rank_crowd.
//   nsga2_grid_key: a warp a point; the ordinal (the points before it in
//     (crowding descending, point)) and the key rounded as the plain
//     version rounds it, __fadd_rn(__fmul_rn(rank, N), ordinal).
//   nsga2_grid_order: a warp a point; its place in the stable order of the
//     rounded keys, (key bits, point).  Past 2^24 keys of one front or of
//     two neighbouring fronts can tie or cross after rounding, so the
//     front-by-front order of nsga2_rank_crowd would be wrong there.
// The atomics append a front's members in no set order; every pass after
// the peel counts keys that carry the point's index, so no output depends
// on that order.
//
// What bounds it on an H100 (80GB HBM3, 700 W; chip_smoke and draft runs):
// the peel's chain of fronts, one CTA.  At (1400, 3) a nsga2_select takes
// ~88 us in 6 launches, 68 of them the peel (22 fronts, ~3 us a front: an
// L2 read of the members' words, the transposes, one CTA barrier); at
// (4096, 3) ~438 us (peel 396); a 4,200-front chain ~8.9 ms (2.1 us a
// front).  A shared-memory atomic a domination pair (Deb's own count
// updates) was several times slower in drafts, with or without a word's
// bits spread over a warp's lanes.

constexpr int kGridNMax = 32768;   // 16-bit counts; the peel's shared memory
constexpr int kGridThreads = 256;  // a grid kernel's CTA
constexpr int kGridWarps = kGridThreads / 32;
constexpr int kOneThreads = 1024;  // the one CTA of nsga2_grid_peel and _group

__device__ __forceinline__ bool valid_at(const unsigned char* valid, int i, int N) {
  return i < N && (valid == nullptr || valid[i]);
}

// #{q < n : a[q] < x} by one warp, four independent counts a lane.
__device__ __forceinline__ int warp_count_lt(const unsigned long long* __restrict__ a, int n,
                                             unsigned long long x, int lane) {
  int c0 = 0, c1 = 0, c2 = 0, c3 = 0, q = lane;
  for (; q + 96 < n; q += 128) {
    c0 += a[q] < x;
    c1 += a[q + 32] < x;
    c2 += a[q + 64] < x;
    c3 += a[q + 96] < x;
  }
  for (; q < n; q += 32) c0 += a[q] < x;
  return (int)__reduce_add_sync(kFull, (unsigned)(c0 + c1 + c2 + c3));
}

__device__ __forceinline__ unsigned long long min64(unsigned long long a, unsigned long long b) {
  return a < b ? a : b;
}
__device__ __forceinline__ unsigned long long max64(unsigned long long a, unsigned long long b) {
  return a > b ? a : b;
}

// nsga2_grid_dom: warp w of CTA (x, b) takes the pair of words (a = 8x + w, b),
// a <= b.  MR = M for M in 2..4 (rows in registers, j's row by shuffles),
// 0 for any M (read from F).  The valid mask as in build_dom; rows past N
// take part in no domination.
template <int MR>
__global__ void __launch_bounds__(kGridThreads)
nsga2_grid_dom(const float* __restrict__ F, const unsigned char* __restrict__ valid,
               unsigned* __restrict__ domr, int* __restrict__ cnt, int N, int M, int W) {
  const int lane = threadIdx.x & 31;
  const int a = blockIdx.x * kGridWarps + (threadIdx.x >> 5), b = blockIdx.y;
  if (a > b) return;  // a whole warp
  const int i = 32 * a + lane, jl = 32 * b + lane;
  const unsigned va = __ballot_sync(kFull, valid_at(valid, i, N));
  const bool vj = valid_at(valid, jl, N);
  const unsigned in_a = 32 * a + 32 <= N ? kFull : (1u << (N - 32 * a)) - 1u;
  float fi[MR > 0 ? MR : 1], fj[MR > 0 ? MR : 1];
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    fi[m] = i < N ? F[(size_t)i * M + m] : 0.f;
    fj[m] = jl < N ? F[(size_t)jl * M + m] : 0.f;
  }
  unsigned col_j = 0u, row_j = 0u;
  auto step = [&](int jj) {
    bool le_ij = true, le_ji = true;
    if constexpr (MR > 0) {
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        const float y = __shfl_sync(kFull, fj[m], jj);
        le_ij = le_ij && (fi[m] <= y);
        le_ji = le_ji && (y <= fi[m]);
      }
    } else {
      const int j = 32 * b + jj;
      for (int m = 0; m < M; ++m) {
        const float x = i < N ? F[(size_t)i * M + m] : 0.f;
        const float y = j < N ? F[(size_t)j * M + m] : 0.f;
        le_ij = le_ij && (x <= y);
        le_ji = le_ji && (y <= x);
      }
    }
    const unsigned col = __ballot_sync(kFull, le_ij && !le_ji);  // i dominates j
    const unsigned row = __ballot_sync(kFull, le_ji && !le_ij);  // j dominates i
    col_j = lane == jj ? col : col_j;
    row_j = lane == jj ? row : row_j;
  };
  if constexpr (MR > 0) {
#pragma unroll
    for (int jj = 0; jj < 32; ++jj) step(jj);
  } else {
#pragma unroll 1
    for (int jj = 0; jj < 32; ++jj) step(jj);
  }
  // lane l is point j = 32b + l: its dominators in word a, whom it dominates there
  col_j = jl < N ? (vj ? col_j & va : va) : 0u;
  row_j = vj ? (row_j & va) | (in_a & ~va) : 0u;
  if (jl < N) {
    domr[(size_t)jl * W + a] = row_j;
    if (col_j) atomicAdd(cnt + jl, __popc(col_j));
  }
  if (a != b) {  // lane l is point i = 32a + l: whom it dominates in word b, its dominators there
    const unsigned ri = transpose32(col_j, lane), di = transpose32(row_j, lane);
    if (i < N) {
      domr[(size_t)i * W + b] = ri;
      if (di) atomicAdd(cnt + i, __popc(di));
    }
  }
}

__global__ void nsga2_grid_zero(int* __restrict__ p, int n) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < n) p[k] = 0;
}

// Shared memory of nsga2_grid_peel: a 16-bit count a point, then the
// members.
size_t peel_smem(int N) { return 4 * ((size_t)align4((N + 1) / 2) + (size_t)N); }

// Appends the lanes' points j where `in` to the members at base + *add (one
// atomic a warp), with rank r.  The whole warp calls it.
__device__ __forceinline__ void warp_append(bool in, int j, int r, int base, int* add, int* mb,
                                            int* rk, int lane) {
  const unsigned m = __ballot_sync(kFull, in);
  if (m == 0u) return;
  const int lead = __ffs(m) - 1;
  int slot = 0;
  if (lane == lead) slot = atomicAdd(add, __popc(m));
  slot = base + __shfl_sync(kFull, slot, lead) + __popc(m & ((1u << lane) - 1u));
  if (in) mb[slot] = j, rk[j] = r;
}

// Of the 32 (or fewer) members whose words x of one domr column the lanes
// hold (lane l: member l's word), how many dominate point 32w + lane: a
// 32 x 32 bit transpose and a count, or for a few members their words by
// shuffles.
__device__ __forceinline__ int dominators_in(unsigned x, int members, int lane) {
  if (members > 8) return __popc(transpose32(x, lane));
  int n = 0;
  for (int m = 0; m < members; ++m) n += (__shfl_sync(kFull, x, m) >> lane) & 1u;
  return n;
}

// The peel by dominator counts, one CTA.  rank, memb (front by front) and
// start (start[t] where front t starts) to device memory.  Per front, a
// warp takes a word w of the domr rows: its lanes read 32 members' words w
// at a time, and after a transpose lane l holds which of them dominate
// point 32w + l, so each point's count drops once a front by a plain
// shared-memory store (no atomics: one lane owns the point), and a point
// whose count reaches 0 joins the next front.
__global__ void __launch_bounds__(kOneThreads)
nsga2_grid_peel(const unsigned* __restrict__ domr, const int* __restrict__ cnt,
                int* __restrict__ rk, int* __restrict__ memb, int* __restrict__ start, int N,
                int W) {
  extern __shared__ float4 smem4[];
  unsigned short* c16 = reinterpret_cast<unsigned short*>(smem4);            // N
  int* mb = reinterpret_cast<int*>(smem4) + align4((N + 1) / 2);             // N
  __shared__ int nxt[3];  // front t appends with nxt[(t + 1) % 3]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, warp0 = tid - lane;
  constexpr int kWarpsOne = kOneThreads / 32;
  if (tid < 3) nxt[tid] = 0;
  for (int j = tid; j < N; j += kOneThreads) c16[j] = (unsigned short)cnt[j];
  __syncthreads();
  for (int j0 = warp0; j0 < N; j0 += kOneThreads) {
    const int j = j0 + lane;
    warp_append(j < N && cnt[j] == 0, j, 0, 0, &nxt[0], mb, rk, lane);
  }
  if (tid == 0) start[0] = 0;
  __syncthreads();
  int s = 0, e = nxt[0], t = 0;
  while (e > s) {
    // front t is mb[s, e); front t + 1 goes after it.  nxt[t % 3] was read
    // by every thread before the last barrier, nxt[(t + 2) % 3] is next
    // front's: each counter is reset a barrier before its use and after its
    // last read.
    int* add = &nxt[(t + 1) % 3];
    if (tid == 0) start[t + 1] = e, nxt[(t + 2) % 3] = 0;
    const int size = e - s;
    const int mid = lane < size ? mb[s + lane] : 0;  // the first 32 members
    for (int w = warp; w < W; w += kWarpsOne) {
      int dec = dominators_in(lane < size ? domr[(size_t)mid * W + w] : 0u, min(size, 32), lane);
      for (int g = 32; g < size; g += 32) {
        const int k = g + lane;
        dec += dominators_in(k < size ? domr[(size_t)mb[s + k] * W + w] : 0u, min(size - g, 32),
                             lane);
      }
      const int j = 32 * w + lane;
      bool zero = false;
      if (dec > 0) {  // j < N: rows past N dominate nothing and are dominated by nothing
        const int c = c16[j] - dec;
        c16[j] = (unsigned short)c;
        zero = c == 0;
      }
      warp_append(zero, j, t + 1, e, add, mb, rk, lane);
    }
    __syncthreads();
    s = e;
    e += *reinterpret_cast<volatile int*>(add);
    ++t;
  }
  if (s < N) {
    // nothing peeled with points left (it cannot happen: domination has no
    // cycle): they take rank N, as in the plain version, and the last run
    int* add = &nxt[t % 3];  // 0: the last front added nothing
    for (int j0 = warp0; j0 < N; j0 += kOneThreads) {
      const int j = j0 + lane;
      warp_append(j < N && c16[j] != 0, j, N, s, add, mb, rk, lane);
    }
    if (tid == 0) start[N] = s, start[N + 1] = N;
    __syncthreads();
  }
  for (int k = tid; k < N; k += kOneThreads) memb[k] = mb[k];
}

__device__ __forceinline__ unsigned key_one(const float* F, const unsigned char* valid, int i) {
  return valid == nullptr || valid[i] ? order_key(F[i]) : kNaNKey;
}

// M = 1, a warp a point i: gk[i] its order key if i is the first valid row
// of its value, NaN's key if not.
__global__ void __launch_bounds__(kGridThreads)
nsga2_grid_first(const float* __restrict__ F, const unsigned char* __restrict__ valid,
                 unsigned* __restrict__ gk, int N) {
  const int lane = threadIdx.x & 31, i = blockIdx.x * kGridWarps + (threadIdx.x >> 5);
  if (i >= N) return;
  const unsigned x = key_one(F, valid, i);
  unsigned c = 0u;
  if (x != kNaNKey) {
    for (int q = lane; q < i; q += 32) c += key_one(F, valid, q) == x;
    c = __reduce_add_sync(kFull, c);
  }
  if (lane == 0) gk[i] = x != kNaNKey && c == 0u ? x : kNaNKey;
}

// M = 1, a warp a point: rank_one_objective's rank.
__global__ void __launch_bounds__(kGridThreads)
nsga2_grid_rank_one(const float* __restrict__ F, const unsigned char* __restrict__ valid,
                    const unsigned* __restrict__ gk, int* __restrict__ rk, int N) {
  const int lane = threadIdx.x & 31, i = blockIdx.x * kGridWarps + (threadIdx.x >> 5);
  if (i >= N) return;
  int r = 0;
  if (valid != nullptr && !valid[i]) {
    unsigned d = 0u, v = 0u;
    for (int q = lane; q < N; q += 32) d += gk[q] != kNaNKey, v += valid[q] != 0;
    d = __reduce_add_sync(kFull, d);
    v = __reduce_add_sync(kFull, v);
    r = v ? max((int)d, 1) : 0;
  } else {
    const unsigned x = order_key(F[i]);
    if (x != kNaNKey) {
      unsigned c = 0u;
      for (int q = lane; q < N; q += 32) c += gk[q] < x;
      r = (int)__reduce_add_sync(kFull, c);
    }
  }
  if (lane == 0) rk[i] = r;
}

// M = 1, one CTA: start[r] = #{rank < r} (a count per rank, an inclusive
// scan of the counts) and the members, front by front.
__global__ void __launch_bounds__(kOneThreads)
nsga2_grid_group(const int* __restrict__ rk, int* __restrict__ memb, int* __restrict__ start,
                 int N) {
  extern __shared__ float4 smem4[];
  int* h = reinterpret_cast<int*>(smem4);  // N + 2
  __shared__ int part[kOneThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, n = N + 2;
  for (int k = tid; k < n; k += kOneThreads) h[k] = 0;
  __syncthreads();
  for (int j = tid; j < N; j += kOneThreads) atomicAdd(h + rk[j] + 1, 1);
  __syncthreads();
  // inclusive scan: thread t sums its chunk, the CTA scans the sums
  const int chunk = (n + kOneThreads - 1) / kOneThreads;
  const int lo = min(n, tid * chunk), hi = min(n, lo + chunk);
  int v = 0;
  for (int k = lo; k < hi; ++k) v += h[k];
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    x += lane >= o ? y : 0;
  }
  if (lane == 31) part[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int p = part[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, p, o);
      p += lane >= o ? y : 0;
    }
    part[lane] = p;
  }
  __syncthreads();
  int run = x - v + (warp > 0 ? part[warp - 1] : 0);
  for (int k = lo; k < hi; ++k) run += h[k], h[k] = run, start[k] = run;
  __syncthreads();
  for (int j = tid; j < N; j += kOneThreads) memb[atomicAdd(h + rk[j], 1)] = j;
}

// A warp a point j: its crowding, and (ck not null) its key in (crowding
// descending, point) order.
__global__ void __launch_bounds__(kGridThreads)
nsga2_grid_crowd(const float* __restrict__ F, const int* __restrict__ rk,
                 const int* __restrict__ memb, const int* __restrict__ start,
                 float* __restrict__ crowd_out, unsigned long long* __restrict__ ck, int N, int M) {
  const int lane = threadIdx.x & 31, j = blockIdx.x * kGridWarps + (threadIdx.x >> 5);
  if (j >= N) return;
  const int r = rk[j], s = start[r], e = start[r + 1];
  auto key_of = [&](int q, int m) {
    return (unsigned long long)order_key(F[(size_t)q * M + m]) << 32 | (unsigned)q;
  };
  auto f_of = [&](unsigned long long k, int m) { return F[(size_t)(unsigned)k * M + m]; };
  float sum = 0.f;
  bool edge = false;
  for (int m = 0; m < M; ++m) {
    const unsigned long long own = key_of(j, m);
    unsigned below = 0u;
    unsigned long long prev = 0ull, next = ~0ull, first = ~0ull, last = 0ull;
    for (int k = s + lane; k < e; k += 32) {
      const unsigned long long x = key_of(memb[k], m);
      below += x < own;
      prev = x < own ? max64(prev, x) : prev;
      next = x > own ? min64(next, x) : next;
      first = min64(first, x);
      last = max64(last, x);
    }
    below = __reduce_add_sync(kFull, below);
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) {
      prev = max64(prev, __shfl_xor_sync(kFull, prev, o));
      next = min64(next, __shfl_xor_sync(kFull, next, o));
      first = min64(first, __shfl_xor_sync(kFull, first, o));
      last = max64(last, __shfl_xor_sync(kFull, last, o));
    }
    float d = kBig;
    if (below > 0u && (int)below < e - s - 1) {
      float span = __fsub_rn(f_of(last, m), f_of(first, m));  // NaN sorts last
      span = span < 1e-12f ? 1e-12f : span;  // torch.clamp(min=): NaN stays NaN
      d = __fdiv_rn(__fsub_rn(f_of(next, m), f_of(prev, m)), span);
    }
    const float c = d > kBig ? kBig : d;  // torch.clamp(max=): NaN stays NaN
    sum = m == 0 ? c : __fadd_rn(sum, c);
    edge = edge || d >= kBig;
  }
  if (lane == 0) {
    const float c = edge ? INFINITY : __fdiv_rn(sum, (float)M);
    crowd_out[j] = c;
    if (ck != nullptr)
      ck[j] = (unsigned long long)~order_key(isnan(c) ? -INFINITY : c) << 32 | (unsigned)j;
  }
}

// A warp a point: the ordinal, the key and (kk not null) the key's place
// key (key bits, point).
__global__ void __launch_bounds__(kGridThreads)
nsga2_grid_key(const int* __restrict__ rk, const unsigned long long* __restrict__ ck,
               float* __restrict__ key_out, unsigned long long* __restrict__ kk, int N) {
  const int lane = threadIdx.x & 31, j = blockIdx.x * kGridWarps + (threadIdx.x >> 5);
  if (j >= N) return;
  const int o = warp_count_lt(ck, N, ck[j], lane);
  if (lane == 0) {
    const float key = __fadd_rn(__fmul_rn((float)rk[j], (float)N), (float)o);
    key_out[j] = key;
    if (kk != nullptr) kk[j] = (unsigned long long)__float_as_uint(key) << 32 | (unsigned)j;
  }
}

// A warp a point: its place in torch.argsort(key, stable=True).
__global__ void __launch_bounds__(kGridThreads)
nsga2_grid_order(const unsigned long long* __restrict__ kk, long long* __restrict__ order_out,
                 int n_keep, int N) {
  const int lane = threadIdx.x & 31, j = blockIdx.x * kGridWarps + (threadIdx.x >> 5);
  if (j >= N) return;
  const int x = warp_count_lt(kk, N, kk[j], lane);
  if (lane == 0 && x < n_keep) order_out[x] = j;
}

// The grid route's scratch, in bytes from its start (256-byte aligned).
struct GridScratch {
  size_t domr, cnt, gk, memb, start, ck, kk, total;
};

GridScratch grid_scratch(int N, int M) {
  const size_t n = (size_t)N, W = (n + 31) / 32;
  auto up = [](size_t b) { return (b + 255) & ~(size_t)255; };
  GridScratch g{};
  size_t o = 0;
  g.domr = o, o += up(M >= 2 ? 4 * n * W : 0);
  g.cnt = o, o += up(M >= 2 ? 4 * n : 0);
  g.gk = o, o += up(M == 1 ? 4 * n : 0);
  g.memb = o, o += up(4 * n);
  g.start = o, o += up(4 * (n + 2));
  g.ck = o, o += up(8 * n);
  g.kk = o, o += up(8 * n);
  g.total = o;
  return g;
}

bool g_grid_smem_set[32] = {};  // the one-CTA kernels' shared memory allowed, per device

}  // namespace

// Whether K5 takes (N, M): its shared memory fits one CTA and its keys are
// exact.
extern "C" int hebo_nsga2_fits(int N, int M) {
  return N >= 0 && N <= kNMax && M >= 1 && 4 * smem_words(N, M) <= (size_t)kSmemMax;
}

// K5.  F (N, M) float32, valid (N,) bool or null -> rank (N,) int32, crowd
// (N,) float32, and unless null key (N,) float32 and order (n_keep,) int64.
// Returns the first error (size, attribute or launch).
extern "C" int hebo_nsga2_rank_crowd(const float* F, const unsigned char* valid, int* rank,
                                     float* crowd, float* key, long long* order, int n_keep,
                                     int N, int M, void* stream) {
  if (N == 0) return 0;
  if (!hebo_nsga2_fits(N, M)) return (int)cudaErrorInvalidValue;
  const size_t smem = 4 * smem_words(N, M);
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
  nsga2_rank_crowd<<<1, kThreads, smem, (cudaStream_t)stream>>>(F, valid, rank, crowd, key, order,
                                                                n_keep, N, M);
  return (int)cudaGetLastError();
}

// K5's route at (N, M): 0 the one-CTA route (hebo_nsga2_fits), 1 the grid
// route (N <= kGridNMax), -1 neither.
extern "C" int hebo_nsga2_route(int N, int M) {
  if (hebo_nsga2_fits(N, M)) return 0;
  return N > 0 && N <= kGridNMax && M >= 1 ? 1 : -1;
}

// Bytes of scratch hebo_nsga2_rank_crowd_grid takes at (N, M) (at most
// ~136 MB, at N = kGridNMax).
extern "C" int hebo_nsga2_grid_scratch(int N, int M) { return (int)grid_scratch(N, M).total; }

// K5's grid route: the contract of hebo_nsga2_rank_crowd for the (N, M)
// that hebo_nsga2_route puts on it, with `scratch` of
// hebo_nsga2_grid_scratch(N, M) bytes.  Returns the first error.
extern "C" int hebo_nsga2_rank_crowd_grid(const float* F, const unsigned char* valid, int* rank,
                                          float* crowd, float* key, long long* order, int n_keep,
                                          void* scratch, int N, int M, void* stream) {
  if (hebo_nsga2_route(N, M) != 1) return (int)cudaErrorInvalidValue;
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev < 0 || dev >= 32) return (int)cudaErrorInvalidDevice;
  if (!g_grid_smem_set[dev]) {
    err = (int)cudaFuncSetAttribute(nsga2_grid_peel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)peel_smem(kGridNMax));
    if (!err)
      err = (int)cudaFuncSetAttribute(nsga2_grid_group, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      4 * (kGridNMax + 2));
    if (err) return err;
    g_grid_smem_set[dev] = true;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const GridScratch g = grid_scratch(N, M);
  char* base = static_cast<char*>(scratch);
  int* memb = reinterpret_cast<int*>(base + g.memb);
  int* start = reinterpret_cast<int*>(base + g.start);
  auto* ck = reinterpret_cast<unsigned long long*>(base + g.ck);
  auto* kk = reinterpret_cast<unsigned long long*>(base + g.kk);
  const int W = (N + 31) / 32, blocks = (N + kGridWarps - 1) / kGridWarps;
  if (M >= 2) {
    auto* domr = reinterpret_cast<unsigned*>(base + g.domr);
    int* cnt = reinterpret_cast<int*>(base + g.cnt);
    nsga2_grid_zero<<<(N + kGridThreads - 1) / kGridThreads, kGridThreads, 0, st>>>(cnt, N);
    const dim3 tiles((W + kGridWarps - 1) / kGridWarps, W);
    auto dom = M == 2 ? nsga2_grid_dom<2> : M == 3 ? nsga2_grid_dom<3>
             : M == 4 ? nsga2_grid_dom<4> : nsga2_grid_dom<0>;
    dom<<<tiles, kGridThreads, 0, st>>>(F, valid, domr, cnt, N, M, W);
    if ((err = (int)cudaGetLastError())) return err;
    nsga2_grid_peel<<<1, kOneThreads, peel_smem(N), st>>>(domr, cnt, rank, memb, start, N, W);
  } else {
    auto* gk = reinterpret_cast<unsigned*>(base + g.gk);
    nsga2_grid_first<<<blocks, kGridThreads, 0, st>>>(F, valid, gk, N);
    if ((err = (int)cudaGetLastError())) return err;
    nsga2_grid_rank_one<<<blocks, kGridThreads, 0, st>>>(F, valid, gk, rank, N);
    if ((err = (int)cudaGetLastError())) return err;
    nsga2_grid_group<<<1, kOneThreads, 4 * (size_t)(N + 2), st>>>(rank, memb, start, N);
  }
  if ((err = (int)cudaGetLastError())) return err;
  const bool with_order = key != nullptr && order != nullptr && n_keep > 0;
  nsga2_grid_crowd<<<blocks, kGridThreads, 0, st>>>(F, rank, memb, start, crowd,
                                              key != nullptr ? ck : nullptr, N, M);
  if ((err = (int)cudaGetLastError()) || key == nullptr) return err;
  nsga2_grid_key<<<blocks, kGridThreads, 0, st>>>(rank, ck, key, with_order ? kk : nullptr, N);
  if ((err = (int)cudaGetLastError()) || !with_order) return err;
  nsga2_grid_order<<<blocks, kGridThreads, 0, st>>>(kk, order, n_keep, N);
  return (int)cudaGetLastError();
}
