// Batched blocked Cholesky with the triangular inverse (kernels K1a, K1b,
// and the two in one launch pair).
//
// Replaces the two Pallas kernels behind hebo_tpu/ops/pallas_chol.py::
// chol_inv_slab (:684):
//   K1a  hebo_chol_factor  <- _factor_slab_kernel (pallas_call :613):
//        K = L L^T and the inverses Wd_j of the 64x64 diagonal tiles of L;
//   K1b  hebo_chol_winv    <- _winv_tile_kernel (pallas_call :665):
//        W = L^-1;
//   hebo_chol_factor_inv   <- both: L, Wd and W in one launch pair where
//        K1a takes its flow route (the fused route below).
//
// Layout: the wrapper pads an (n, n) matrix to Np = 64 * ceil(n / 64) with
// an identity block (exact: the factor and inverse of blockdiag(K, I) are
// blockdiag(L, I) and blockdiag(W, I)) and slices back.  nt = Np / 64.
//
// K1a has two routes; pick_route (exported as hebo_chol_route) chooses by
// the padded size alone, so a matrix takes the same route, and gives the
// same bits, alone or in a batch:
//
// * step (nt < kFlowMinTiles = 8, N <= 448): the chain regime, small
//   buckets.  There N^3/3 FLOPs are 0.5 us or less of the FP32 peak, while
//   the factorization is a chain of nt dependent diagonal tiles and every
//   link costs a launch plus the tile work on one SM.  So this route
//   shortens each link, right-looking over 64-wide panels, nt launches:
//   chol_first    one CTA per matrix factors tile (0, 0) of blockdiag(K, I)
//                 while the others copy blockdiag(K, I)'s lower tiles into
//                 a scratch A and zero the upper tiles of L;
//   chol_step j   (j = 0 .. nt-2) one CTA per lower tile (i, k) of the
//                 trailing matrix, j < k <= i: it forms the panel tiles
//                 L_ij = A_ij Wd_j^T and L_kj itself (CTA (i, i) stores
//                 L_ij), updates A_ik -= L_ij L_kj^T, and the CTA of tile
//                 (j+1, j+1) factors it at once (look-ahead), so the next
//                 step finds Wd_{j+1} ready.  The panel is read from the
//                 scratch copy A and written to L, so no CTA reads a tile
//                 another CTA of the same launch writes.  Each link is two
//                 tile products plus one tile factor on one SM.
//   Small buckets (Np <= 256, at most 4 launches) take the same route: one
//   CTA per matrix holding every tile in shared memory would save at most
//   three ~1 us launch gaps, and would run all trailing products on one SM.
//
// * flow (nt >= 8): the work regime, many tiles (BOCS's Gibbs sweep at
//   (1, 5051), nt = 79: N^3/3 is 43 GFLOP, 0.64 ms of the FP32 peak) or
//   many matrices.  There the step route spends its time on work it
//   repeats: every CTA of step j forms both of its panel tiles itself (three
//   tile products per off-diagonal tile where a Cholesky needs one, ~243k
//   against ~85k at nt = 79), reads and writes its trailing tile once per
//   step, and waits on the step's last wave.  This route is left-looking
//   and data-driven, two launches whether it factors or skips:
//   chol_flow_init  zeros each matrix's counters;
//   chol_flow       a persistent grid (the CTAs that fit on the card at
//                   once, split between the matrices) that takes tasks from
//                   a per-matrix ticket counter, column by column, the
//                   diagonal chain's tasks two columns early (factor_ticket).
//                   Task (i, k) (factor_task): C = K_ik (+ jitter) -
//                   sum_{j<k} L_ij L_kj^T, streaming the stored panel tiles
//                   L_ij, L_kj through a cp.async double buffer as they
//                   become ready; then the panel tile L_ik = C Wd_k^T is
//                   formed once and stored (and L_ki zeroed), or the
//                   diagonal tile is factored into L_kk and Wd_k.  The
//                   diagonal task of column k also forms L_{k,k-1} from the
//                   subdiagonal task's stored sum, so the chain crosses one
//                   CTA boundary per column.
//   Row i's tiles finish in column order (task (i, k) reads L_i,k-1), so one
//   counter per row says how many of its tiles are stored (released after
//   the stores, read with acquire).  A task waits only on tasks with smaller
//   tickets, which CTAs already running hold, so the grid cannot deadlock
//   whatever the residency.  The diagonal chain overlaps the rest: the
//   chain's tasks of column k+2 take their tickets before the rest of
//   column k and sum their first products then; what stays serial per
//   column is one panel product, one update product and the tile factor,
//   ~15-17 us.  The products run on 8x8 register tiles: the CTA's four
//   64-thread groups each sum a 16-wide quarter of the depth of every
//   product (each operand float read from shared memory feeds 4 FMAs, where
//   the step route's 4x4 tiles feed 2), and the four partial sums are added
//   in a fixed order at the end of the task.  One CTA an SM: 254 registers
//   a thread, no spills (capped at 128 for two CTAs an SM, it spills 712
//   bytes a thread and takes 2.63 against 1.64 ms at (1, 5051);
//   bench/chol_probe.py --variants, H100 80GB HBM3 at 700 W, which also
//   shows what holds this route there: without its products it runs in
//   1.31 ms, the chain's floor, without its panel copies in 1.45 ms).
//   The rule's bound is measured (bench/chol_probe.py, both routes forced,
//   H100 80GB HBM3 at 700 W): from 8 tiles the flow route is the faster at
//   every batch measured (1 to 128; 3-7 % at 8-11 tiles and B <= 2, 7-67 %
//   from 16 tiles).  Below 8 tiles the step route is the faster at small
//   batches, in device time (flow against step: +11 % at (2, 128), +5 % at
//   (1, 256), a tie at (2, 448); at 1 tile one launch against two), so the
//   rule keeps it there; at B 24-64 and N 256 the flow route wins by
//   24-49 % (64.5 against 84.2-87.6 us at (24, 256)), but the rule does not
//   split by B.
//
// The tile factor (factor_tile, both routes) blocks the 64x64 tile into four
//   16-wide blocks.  Its time is the chain of warp 0: 16 lanes factor each
//   16x16 diagonal block and its inverse in registers (factor_block16), 16
//   dependent column steps a block, each yielding an L column and a W row
//   broadcast through shared memory.  Between two diagonal blocks every warp forms the one sub-panel
//   block and the one diagonal-block update that the next block needs (the
//   look-ahead, two CTA barriers); while warp 0 factors that block, warps
//   1-7 solve and update the rest of the sub-trailing matrix on 4x4
//   register tiles (a quarter of the shared-memory reads of an entry a
//   thread, so they slow warp 0 little) and form Wd's off-diagonal blocks
//   by doubling.  Every entry is summed in the order of a CTA-wide sweep
//   (_tile_factor_plain), so the schedule does not change the bits.
//   Measured with clock64 (bench/chol_probe.py and --variants tile, H100
//   80GB HBM3 at 700 W; the cycles in PERF.md): the 64 column steps are
//   most of a tile's time; broadcasting by __shfl_sync in place of shared
//   memory makes each step slower, taking the next pivot's entry first
//   leaves it as it is, and the same arithmetic as a CTA-wide sweep, with
//   warp 0 waiting at each barrier, takes ~15 % longer.
//
// K1b takes its route by the padded size alone too (pick_winv_route,
// exported as hebo_chol_winv_route), so W has the same bits alone or in a
// batch:
//
// * copy (nt < kWinvFlowMinTiles = 2, N <= 64): one launch, winv_init,
//   which copies Wd into W (W = L^-1 = Wd at one tile).
//
// * flow (nt >= 2): blocked forward substitution, what _winv_tile_kernel
//   computes, as a persistent grid like K1a's flow route, two launches
//   whether it factors or skips:
//   winv_flow_init  zeros each matrix's counters;
//   winv_flow       the CTAs that fit on the card at once, split between the
//                   matrices, take tasks from a per-matrix ticket counter in
//                   row order: (0, 0), (1, 0), (1, 1), (2, 0), ... (i, 0 .. i).
//                   Task (i, k), k < i (winv_task):
//                     W_ik = -Wd_i sum_{j=k}^{i-1} L_ij W_jk   (W_kk = Wd_k)
//                   streaming L_ij and W_jk through the cp.async stages as
//                   soon as W_jk is stored, the last term L_{i,i-1} W_{i-1,k}
//                   last (its L tile is copied while W_{i-1,k} is awaited);
//                   the sum on 8x8 register tiles, the four 64-thread groups
//                   each over a 16-wide quarter of the depth, the partial
//                   sums added in a fixed order; then the product with Wd_i
//                   (4x4 tiles over the whole depth, as K1a's panel tile) is
//                   stored and the tile W_ki above the diagonal zeroed.
//                   Task (i, i) copies Wd_i into W_ii.
//   Column k's tiles finish in row order (task (i, k) reads W_{i-1,k}), so
//   one counter per column says how many of its rows below the diagonal are
//   stored (released after the stores, read with acquire).  Row i's tasks
//   come after row i-1's, so a task waits only on smaller tickets, which
//   CTAs already running hold: no deadlock whatever the residency.  The
//   work is ~nt^3/6 tile products (85k at nt = 79: 0.67 ms of the FP32
//   peak); the chain per column is nt-1 steps of one update product, the
//   sum's reduction and one Wd product, ~6 us a step.  Measured
//   (bench/chol_probe.py, H100 80GB HBM3 at 700 W): at (1, 5051) the first
//   20 rows are chain-bound (~120 us), the rest run ~1.86 us a term on
//   every SM, their products issuing FMAs at ~2/3 of the FP32 rate; two
//   CTAs an SM (128 registers) win 11 % at (32, 1024) and lose 7-9 % where
//   the chain counts.  At one tile W is Wd, and one copy launch does it.
//
// The fused route (hebo_chol_factor_inv, where K1a takes its flow route):
//   L, Wd and W in two launches whether it factors or skips, instead of
//   K1a's two and K1b's two:
//   chol_flow_inv_init  zeros each matrix's counters (K1a's and W's);
//   chol_flow_inv       one persistent grid that takes K1a's flow tasks and
//                       W's tasks from one ticket counter per matrix
//                       (fused_ticket): K1a's tickets in their order, and W's
//                       row w after K1a's tasks of column w - 2 + kWinvLag
//                       (winv_slot), kWinvLag = 4 columns after the column
//                       whose tasks hold L's diagonal task (w, w).
//   Each task runs as in its own launch (factor_task, winv_task<true>), so
//   L, Wd and W have the pair's bits; a task of W waits, term by term, for
//   its L tile (L_ij stored once rows[i] > j) and its W tile, and for Wd_i
//   (rows[i] == i + 1) only before its last product, so row i's sums run
//   while L's row i is formed.  Every tile a task reads is formed by a task
//   with a smaller ticket: no deadlock, as above.  W's row i no longer waits
//   for the whole of L: at (2, 1024) the fused call ends 4.3-4.8 us after
//   L's last task (bench/chol_probe.py --fused).  Where L leaves no SM idle
//   for long (BOCS's (1, 5051): W's large rows need L's late rows, which
//   its chain forms last) the grid gains only the launches; kWinvLag is
//   measured (--variants fused: lag 1 costs 4 % at (1, 5051) and 13 % at
//   (1, 3072), W after all of L 1-13 %).  Shared memory: K1b's six tiles
//   (104,448 bytes, one CTA an SM).
//
// Tile products: FP32 FMA from shared memory with 16-byte reads (no TF32:
// the JAX package runs them at Precision.HIGHEST); operand tiles arrive by
// cp.async, double-buffered in the flow routes.  K1a's step route and
// K1b's Wd product use 256 threads with 4x4 outputs each; one 64^3
// product is ~1.2 us of one SM's FP32 rate.  Kernels whose dynamic shared memory exceeds 48 KB
// get cudaFuncSetAttribute first, and its error code is returned like a
// launch error.
//
// The jitter ladder (ops/chol.py::batched_ladder_factor) runs every rung
// on the device, with no host test: each rung passes
//   jitter (B,)  added to K's diagonal (not the identity padding) where
//                K1a reads K, so no K + jitter*I is formed in device
//                memory;
//   skip (B,)    a matrix whose flag is set is left as it is in L, Wd and
//                W: every CTA of it returns at once.  The ladder sets the
//                flag for the matrices an earlier rung factored, so a rung
//                that no matrix needs costs its launches (2 on the fused
//                route; below it K1a nt on its step route, and K1b 1 at
//                one tile, else 2), not a factorization.
// Either may be null (no jitter, no skip).
//
// Failure semantics: a pivot that is not > 0 (negative, zero or NaN) gives
// a NaN diagonal entry, never a clamped one; the NaN spreads through the
// panel and trailing updates to every later tile of that matrix's L and W,
// so the jitter ladder sees it, as with jnp.linalg.cholesky.  Every CTA
// works inside one matrix, so a NaN never reaches a batch neighbour.  No
// float atomics (the flow routes' tickets and counters are integers, and
// which CTA runs a task does not change its arithmetic): results are
// bit-reproducible.

#include <cuda_runtime.h>

namespace {

constexpr int T = 64;           // tile edge
constexpr int LD = T + 4;       // shared row stride: 16-byte rows, conflict-free float4 reads
constexpr int TILE_F = T * LD;  // floats per shared tile
constexpr int SB = 16;          // sub-block edge of the tile factor
constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int kFourTiles = 4 * TILE_F * (int)sizeof(float);  // 69,632 bytes
// the flow route's panel stages: one in use, one in flight (three were no
// faster: bench/chol_probe.py --variants)
constexpr int kFlowStages = 2;
constexpr int kFlowTiles = (2 * kFlowStages + 1) * TILE_F * (int)sizeof(float);  // 87,040 bytes
// the flow routes' shapes (pick_route, pick_winv_route)
constexpr int kFlowMinTiles = 8;
constexpr int kWinvFlowMinTiles = 2;
// K1b's flow route: the panel stages (L_ij, W_jk), Wd_i and the sum S
constexpr int kWinvTiles = (2 * kFlowStages + 2) * TILE_F * (int)sizeof(float);  // 104,448 bytes
// the fused flow route (chol_flow_inv): W's row w takes its tickets after
// K1a's tasks of column w - 2 + kWinvLag (winv_slot)
constexpr int kWinvLag = 4;

__device__ __forceinline__ float quiet_nan() { return __int_as_float(0x7fffffff); }

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// the same for a count known at run time, n < kFlowStages
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  static_assert(kFlowStages == 2, "cp_async_wait_upto covers n < 2");
  if (n <= 0) cp_async_wait<0>();
  else cp_async_wait<1>();
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// Start the copy of a 64x64 tile (row stride ld floats) into shared S.
__device__ __forceinline__ void load_tile_async(float* S, const float* g, size_t ld) {
#pragma unroll
  for (int q = 0; q < T * T / 4 / kThreads; ++q) {
    const int e = threadIdx.x + q * kThreads;
    const int r = e >> 4, c = (e & 15) * 4;
    cp_async16(S + r * LD + c, g + r * ld + c);
  }
}

__device__ __forceinline__ float lane4(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// acc[i][j] += sum_m P[ty+16i][m] * Q[tx+16j][m]      (P Q^T)
__device__ __forceinline__ void mma_nt(const float* P, const float* Q, float acc[4][4],
                                       int tx, int ty) {
#pragma unroll 2
  for (int m = 0; m < T; m += 4) {
    float4 p[4], q[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[i] = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * LD + m);
      q[i] = *reinterpret_cast<const float4*>(Q + (tx + 16 * i) * LD + m);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][j] = fmaf(lane4(p[i], k), lane4(q[j], k), acc[i][j]);
  }
}

// acc[i][j] += sum_m P[ty+16i][m] * Q[m][4tx+j]       (P Q)
__device__ __forceinline__ void mma_nn(const float* P, const float* Q, float acc[4][4],
                                       int tx, int ty) {
#pragma unroll 2
  for (int m = 0; m < T; m += 4) {
    float4 p[4], q[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[i] = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * LD + m);
      q[i] = *reinterpret_cast<const float4*>(Q + (m + i) * LD + 4 * tx);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(lane4(p[i], k), lane4(q[k], j), acc[i][j]);
  }
}

// acc[a][b] += sum_{m0 <= m < m0+16} P[gy+8a][m] * Q[gx+8b][m]   (P Q^T over
// a 16-wide quarter of the depth, 8x8 outputs a thread; a warp reads four
// P rows and eight Q rows per float4, conflict-free at the LD stride)
__device__ __forceinline__ void mma_nt_8x8(const float* P, const float* Q, float acc[8][8],
                                           int gy, int gx, int m0) {
#pragma unroll
  for (int m = m0; m < m0 + 16; m += 4) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float4 q[4];
#pragma unroll
      for (int b = 0; b < 4; ++b)
        q[b] = *reinterpret_cast<const float4*>(Q + (gx + 8 * (4 * h + b)) * LD + m);
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const float4 p = *reinterpret_cast<const float4*>(P + (gy + 8 * a) * LD + m);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          float& v = acc[a][4 * h + b];
          v = fmaf(p.x, q[b].x, v);
          v = fmaf(p.y, q[b].y, v);
          v = fmaf(p.z, q[b].z, v);
          v = fmaf(p.w, q[b].w, v);
        }
      }
    }
  }
}

// acc[a][c] += sum_{m0 <= m < m0+16} P[gy+8a][m] * Q[m][4gx + (c&3) + 32(c>>2)]
// (P Q over a 16-wide quarter of the depth, 8x8 outputs a thread; a warp
// reads four P rows and two 128-byte segments of each Q row per float4,
// conflict-free at the LD stride)
__device__ __forceinline__ void mma_nn_8x8(const float* P, const float* Q, float acc[8][8],
                                           int gy, int gx, int m0) {
#pragma unroll
  for (int m = m0; m < m0 + 16; m += 4) {
    float4 q[4][2];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      q[u][0] = *reinterpret_cast<const float4*>(Q + (m + u) * LD + 4 * gx);
      q[u][1] = *reinterpret_cast<const float4*>(Q + (m + u) * LD + 32 + 4 * gx);
    }
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const float4 p = *reinterpret_cast<const float4*>(P + (gy + 8 * a) * LD + m);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float pu = lane4(p, u);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* v = acc[a] + 4 * h;
          v[0] = fmaf(pu, q[u][h].x, v[0]);
          v[1] = fmaf(pu, q[u][h].y, v[1]);
          v[2] = fmaf(pu, q[u][h].z, v[2]);
          v[3] = fmaf(pu, q[u][h].w, v[3]);
        }
      }
    }
  }
}

__device__ __forceinline__ float inv_sqrt_pivot(float d) {
  const float y = rsqrtf(d);  // one Newton step: 1/sqrt(d) to ~1 ulp
  return d > 0.f ? y * fmaf(-0.5f * d * y, y, 1.5f) : quiet_nan();
}

// Lanes 0-15 of one warp factor the 16x16 diagonal block at (o, o) of the
// tile in shared A, and its inverse, in registers.  Lane r holds row r of
// the block and of its inverse, and its own copy of the block's diagonal.
// Each column step yields an L column and an inverse row, both broadcast
// through shared memory; the inverse rows stay unscaled (the multipliers
// carry 1/L_kk) and each lane scales its own row once at the end.  Writes
// L into A and the inverse into X (zeros above the diagonal).
__device__ __forceinline__ void factor_block16(float* A, float* X, int o) {
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
#pragma unroll
  for (int k = 0; k < SB; ++k) {
    const float d = dd[k];
    const float inv = inv_sqrt_pivot(d);
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
#pragma unroll
    for (int q = 0; q < SB / 4; ++q) {
      if (4 * q + 3 > k) {
        const float4 v = *reinterpret_cast<const float4*>(&colb[k & 1][4 * q]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = 4 * q + u;
          if (c > k) {
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
  }
#pragma unroll
  for (int c = 0; c < SB; ++c) {
    A[(o + r) * LD + o + c] = c <= r ? a[c] : 0.f;
    X[(o + r) * LD + o + c] = c <= r ? x[c] * own_inv : 0.f;
  }
}

// The tile factor's warps 1-7 (the workers) sync among themselves on a
// named barrier while warp 0 factors a diagonal block.
constexpr int kBarWorkers = 1;
constexpr int kWorkers = kThreads - 32;

__device__ __forceinline__ void bar_workers() {
  asm volatile("bar.sync %0, %1;\n" ::"r"(kBarWorkers), "r"(kWorkers) : "memory");
}

// Entry (ty, tx) of the sub-panel block L_rb = A_rb X_bb^T (16-blocks;
// X_bb is zero above its diagonal).
__device__ __forceinline__ float solve_entry(const float* A, const float* X, int r, int b, int ty,
                                             int tx) {
  const float* ar = A + (SB * r + ty) * LD + SB * b;
  const float* xr = X + (SB * b + tx) * LD + SB * b;
  float v = 0.f;
#pragma unroll
  for (int m = 0; m < SB; m += 4) {
    const float4 p = *reinterpret_cast<const float4*>(ar + m);
    const float4 q = *reinterpret_cast<const float4*>(xr + m);
    v = fmaf(p.x, q.x, fmaf(p.y, q.y, fmaf(p.z, q.z, fmaf(p.w, q.w, v))));
  }
  return v;
}

// Entry (ty, tx) of L_rb L_cb^T, the sub-panel read from its copy in X's
// blocks (r, b) and (c, b).
__device__ __forceinline__ float update_entry(const float* X, int r, int c, int b, int ty, int tx) {
  const float* pr = X + (SB * r + ty) * LD + SB * b;
  const float* qr = X + (SB * c + tx) * LD + SB * b;
  float acc = 0.f;
#pragma unroll
  for (int m = 0; m < SB; m += 4) {
    const float4 p = *reinterpret_cast<const float4*>(pr + m);
    const float4 q = *reinterpret_cast<const float4*>(qr + m);
#pragma unroll
    for (int k = 0; k < 4; ++k) acc = fmaf(lane4(p, k), lane4(q, k), acc);
  }
  return acc;
}

// The 4x4 entries u (rows 4(u>>2).., columns 4(u&3).. of the 16-block) of
// solve_entry (into X's block (r, b), the sub-panel's staging) and of
// update_entry (subtracted from A's block (r, c)), each summed in the
// same order as there; four rows of each operand feed 16 entries, so the
// workers read a quarter of the shared memory that an entry a thread
// reads while warp 0 factors.
__device__ __forceinline__ void solve_tile4(const float* A, float* X, int r, int b, int u) {
  const int y0 = SB * r + 4 * (u >> 2), x0 = SB * b + 4 * (u & 3);
  float v[4][4] = {};
#pragma unroll
  for (int m = 0; m < SB; m += 4) {
    float4 p[4], q[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[i] = *reinterpret_cast<const float4*>(A + (y0 + i) * LD + SB * b + m);
      q[i] = *reinterpret_cast<const float4*>(X + (x0 + i) * LD + SB * b + m);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[i][j] = fmaf(p[i].x, q[j].x, fmaf(p[i].y, q[j].y, fmaf(p[i].z, q[j].z, fmaf(p[i].w, q[j].w, v[i][j]))));
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) X[(y0 + i) * LD + x0 + j] = v[i][j];
}
__device__ __forceinline__ void update_tile4(const float* X, float* A, int r, int c, int b, int u) {
  const int y0 = SB * r + 4 * (u >> 2), x0 = SB * c + 4 * (u & 3);
  float acc[4][4] = {};
#pragma unroll
  for (int m = 0; m < SB; m += 4) {
    float4 p[4], q[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[i] = *reinterpret_cast<const float4*>(X + (y0 + i) * LD + SB * b + m);
      q[i] = *reinterpret_cast<const float4*>(X + (x0 + i) * LD + SB * b + m);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][j] = fmaf(lane4(p[i], k), lane4(q[j], k), acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) A[(y0 + i) * LD + x0 + j] -= acc[i][j];
}

// Wd's off-diagonal entry (ty, tx) at level 16 of the doubling, for the
// pair of diagonal blocks at s1, s2 = s1 + 16: Y = L21 X11 (kept in X's
// block (s1, s2) above the diagonal), then X21 = -X22 Y.
__device__ __forceinline__ float double16_y(const float* A, const float* X, int s1, int ty, int tx) {
  const int s2 = s1 + SB;
  float y = 0.f;
#pragma unroll
  for (int m = 0; m < SB; ++m) y = fmaf(A[(s2 + ty) * LD + s1 + m], X[(s1 + m) * LD + s1 + tx], y);
  return y;
}
__device__ __forceinline__ float double16_x(const float* X, int s1, int ty, int tx) {
  const int s2 = s1 + SB;
  float w = 0.f;
#pragma unroll
  for (int m = 0; m < SB; ++m) w = fmaf(X[(s2 + ty) * LD + s2 + m], X[(s1 + m) * LD + s2 + tx], w);
  return -w;
}

// Level 32: Y = L[32:64, 0:32] X[0:32, 0:32] (kept in X[0:32, 32:64]) as
// the 4x4 entries u of its 16-block (i, j), each summed over m in order and
// skipping X11's and X22's upper blocks; then entry (32 + ty + 16i,
// tx + 16j) of X[32:64, 0:32] = -X[32:64, 32:64] Y.
__device__ __forceinline__ void double32_y_tile4(const float* A, float* X, int i, int j, int u) {
  const int y0 = SB * i + 4 * (u >> 2), x0 = SB * j + 4 * (u & 3);
  float acc[4][4] = {};
  for (int m = SB * j; m < 2 * SB; ++m) {
    const float4 q = *reinterpret_cast<const float4*>(X + m * LD + x0);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float p = A[(32 + y0 + a) * LD + m];
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(p, lane4(q, c), acc[a][c]);
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) X[(y0 + a) * LD + 32 + x0 + c] = acc[a][c];
}
__device__ __forceinline__ float double32_x(const float* X, int i, int j, int ty, int tx) {
  float w = 0.f;
#pragma unroll
  for (int m = 0; m < 2 * SB; ++m)
    if (m < SB * (i + 1)) w = fmaf(X[(32 + ty + SB * i) * LD + 32 + m], X[m * LD + 32 + tx + SB * j], w);
  return -w;
}

// The workers' share of column block b, while warp 0 factors diagonal
// block b + 1: the sub-panel blocks (r, b), r >= b + 2 (staged in X's
// blocks (r, b), which Wd's off-diagonal blocks overwrite later, then
// copied into A once every worker has formed its own), the sub-trailing
// blocks (r, c), b+1 <= c <= r, r >= b + 2, and what Wd's doubling can
// form with the blocks factored so far.  w: the worker's index.
__device__ __forceinline__ void tile_rest(float* A, float* X, int b, int w) {
  if (b == 0) {  // level 16, pair (0, 1): Y = L10 X00
    for (int e = w; e < SB * SB; e += kWorkers)
      X[(e >> 4) * LD + SB + (e & 15)] = double16_y(A, X, 0, e >> 4, e & 15);
  } else if (b == 1) {  // X10 = -X11 Y
    for (int e = w; e < SB * SB; e += kWorkers)
      X[(SB + (e >> 4)) * LD + (e & 15)] = double16_x(X, 0, e >> 4, e & 15);
  } else {  // level 16, pair (2, 3): Y = L32 X22; level 32's Y, then its row block 2
    for (int e = w; e < SB * SB + 64; e += kWorkers) {
      if (e < SB * SB) X[(32 + (e >> 4)) * LD + 48 + (e & 15)] = double16_y(A, X, 32, e >> 4, e & 15);
      else double32_y_tile4(A, X, (e - SB * SB) >> 5, ((e - SB * SB) >> 4) & 1, e & 15);
    }
    bar_workers();
    for (int e = w; e < 2 * SB * SB; e += kWorkers)
      X[(32 + ((e >> 4) & 15)) * LD + (e & 15) + SB * (e >> 8)] = double32_x(X, 0, e >> 8, (e >> 4) & 15, e & 15);
    return;
  }
  const int nrows = 2 - b;  // sub-panel blocks below (b+1, b)
  for (int u = w; u < nrows * 16; u += kWorkers) solve_tile4(A, X, b + 2 + (u >> 4), b, u & 15);
  bar_workers();
  for (int e = w; e < nrows * SB * SB; e += kWorkers) {
    const int o = (SB * (b + 2 + (e >> 8)) + ((e >> 4) & 15)) * LD + SB * b + (e & 15);
    A[o] = X[o];
  }
  const int nblk = (3 - b) * (4 - b) / 2 - 1;  // the blocks after (b+1, b+1), row by row
  for (int u = w; u < nblk * 16; u += kWorkers) {
    int q = (u >> 4) + 1, r = b + 1, c = b + 1;
    while (q > 0) {
      if (c < r) ++c;
      else c = b + 1, ++r;
      --q;
    }
    update_tile4(X, A, r, c, b, u & 15);
  }
}

// Factor the SPD tile in shared A (its lower part is read): A <- L and
// X <- L^-1 on and below the diagonal (store_factor zeros what lies above).
// 256 threads; ends with a barrier.
//
// 16-wide blocks b = 0..3.  The chain is warp 0's: it factors diagonal
// block b (factor_block16); then every warp forms the sub-panel block
// (b+1, b) and updates the next diagonal block (the look-ahead, one entry
// a thread), and warp 0 factors that block while warps 1-7 (tile_rest)
// solve and update the rest of the sub-trailing matrix and form Wd's
// off-diagonal blocks by doubling: level 16, Y = L21 X11 then X21 = -X22 Y
// for the pairs of diagonal blocks (0, 1) and (2, 3); level 32,
// Y = L[32:64, 0:32] X[0:32, 0:32] then X[32:64, 0:32] = -X[32:64, 32:64] Y,
// whose row block 2 needs only X22.  After the last diagonal block every
// warp forms X32 = -X33 Y, then X's row block 3.  Each entry is summed in
// the order of a CTA-wide sweep over the blocks (_tile_factor_plain), and
// A's entries take their updates in block order, so the schedule does not
// change the bits.
__device__ void factor_tile(float* A, float* X) {
  const int t = threadIdx.x, ty = t >> 4, tx = t & 15;
  for (int b = 0; b < 4; ++b) {
    if (t < SB) factor_block16(A, X, SB * b);
    else if (t >= 32 && b > 0) tile_rest(A, X, b - 1, t - 32);
    __syncthreads();  // L_bb and X_bb are there, and the workers' blocks
    if (b == 3) break;
    // the look-ahead: L_{b+1,b}, then A_{b+1,b+1} -= L_{b+1,b} L_{b+1,b}^T
    const int n1 = b + 1;
    X[(SB * n1 + ty) * LD + SB * b + tx] = solve_entry(A, X, n1, b, ty, tx);
    __syncthreads();
    A[(SB * n1 + ty) * LD + SB * b + tx] = X[(SB * n1 + ty) * LD + SB * b + tx];
    A[(SB * n1 + ty) * LD + SB * n1 + tx] -= update_entry(X, n1, n1, b, ty, tx);
    __syncthreads();
  }
  X[(48 + ty) * LD + 32 + tx] = double16_x(X, 32, ty, tx);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 2; ++j) X[(48 + ty) * LD + tx + SB * j] = double32_x(X, 1, j, ty, tx);
  __syncthreads();
}

// Store a factored tile: its L (lower, zeros above) and its inverse Wd.
__device__ __forceinline__ void store_factor(const float* A, const float* X, float* Lt,
                                             size_t ld, float* Wt) {
  for (int e = threadIdx.x; e < T * T; e += kThreads) {
    const int r = e / T, c = e % T;
    Lt[r * ld + c] = c <= r ? A[r * LD + c] : 0.f;
    Wt[e] = c <= r ? X[r * LD + c] : 0.f;
  }
}

// First launch, grid (1 + copy CTAs, B).  CTA 0 of each matrix factors
// tile (0, 0) of blockdiag(K, I) into L_00 and Wd_0; the others (none when
// nt = 1) copy blockdiag(K, I) on and below the tile diagonal into the
// scratch A and zero L above it, while tile (0, 0) is factored.
__global__ void __launch_bounds__(kThreads)
chol_first(const float* __restrict__ K, const float* __restrict__ jitter,
           const int* __restrict__ skip, float* __restrict__ L, float* __restrict__ Wd,
           float* __restrict__ A, int n, int Np) {
  __shared__ __align__(16) float As[TILE_F];
  __shared__ __align__(16) float Xs[TILE_F];
  const int b = blockIdx.y;
  if (skip != nullptr && skip[b]) return;
  const float jit = jitter != nullptr ? jitter[b] : 0.f;
  const float* Kb = K + (size_t)b * n * n;
  const size_t total = (size_t)Np * Np;
  if (blockIdx.x == 0) {
    for (int e = threadIdx.x; e < T * T; e += kThreads) {
      const int r = e / T, c = e % T;
      As[r * LD + c] = (r < n && c < n) ? (r == c ? Kb[(size_t)r * n + c] + jit : Kb[(size_t)r * n + c])
                                        : (r == c ? 1.f : 0.f);
    }
    __syncthreads();
    factor_tile(As, Xs);
    store_factor(As, Xs, L + b * total, Np, Wd + (size_t)b * (Np / T) * T * T);
    return;
  }
  float* Ab = A + b * total;
  float* Lb = L + b * total;
  for (size_t e = (blockIdx.x - 1) * (size_t)blockDim.x + threadIdx.x; e < total;
       e += (size_t)(gridDim.x - 1) * blockDim.x) {
    const int r = (int)(e / Np), c = (int)(e % Np);
    if (c / T > r / T) Lb[e] = 0.f;
    else Ab[e] = (r < n && c < n) ? (r == c ? Kb[(size_t)r * n + c] + jit : Kb[(size_t)r * n + c])
                                  : (r == c ? 1.f : 0.f);
  }
}

// Step j: tile (i, k), j < k <= i, of the trailing matrix.  Forms L_ij and
// L_kj from the panel, A_ik -= L_ij L_kj^T; CTA (i, i) stores L_ij, and
// CTA (j+1, j+1) factors its updated tile into L and Wd (look-ahead).
__global__ void __launch_bounds__(kThreads)
chol_step(const int* __restrict__ skip, float* __restrict__ A, float* __restrict__ L,
          float* __restrict__ Wd, int Np, int j) {
  if (skip != nullptr && skip[blockIdx.y]) return;
  extern __shared__ float4 smem4[];
  float* P = reinterpret_cast<float*>(smem4);
  float* Q = P + TILE_F;
  float* Ws = Q + TILE_F;
  float* C = Ws + TILE_F;
  const int b = blockIdx.y, nt = Np / T, t = blockIdx.x;
  // decode the lower-triangle tile index t -> (ii, kk), kk <= ii
  int ii = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while ((ii + 1) * (ii + 2) / 2 <= t) ++ii;
  while (ii * (ii + 1) / 2 > t) --ii;
  const int i = j + 1 + ii, k = j + 1 + (t - ii * (ii + 1) / 2);
  const bool diag = k == i;
  const size_t mat = (size_t)b * Np * Np, ldt = (size_t)T * Np;
  float* Ab = A + mat;
  float* Wdb = Wd + (size_t)b * nt * T * T;
  load_tile_async(P, Ab + i * ldt + j * T, Np);
  if (!diag) load_tile_async(Q, Ab + k * ldt + j * T, Np);
  load_tile_async(Ws, Wdb + (size_t)j * T * T, T);
  load_tile_async(C, Ab + i * ldt + k * T, Np);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float lp[4][4] = {}, lq[4][4] = {};
  mma_nt(P, Ws, lp, tx, ty);
  if (!diag) mma_nt(Q, Ws, lq, tx, ty);
  __syncthreads();
  float* Lij = L + mat + i * ldt + j * T;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int o = (ty + 16 * r) * LD + tx + 16 * c;
      P[o] = lp[r][c];
      if (!diag) Q[o] = lq[r][c];
      else Lij[(size_t)(ty + 16 * r) * Np + tx + 16 * c] = lp[r][c];
    }
  __syncthreads();
  float acc[4][4] = {};
  mma_nt(P, diag ? P : Q, acc, tx, ty);
  if (i == j + 1) {  // look-ahead: factor the updated diagonal tile now
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) C[(ty + 16 * r) * LD + tx + 16 * c] -= acc[r][c];
    __syncthreads();
    factor_tile(C, P);
    store_factor(C, P, L + mat + i * ldt + i * T, Np, Wdb + (size_t)i * T * T);
    return;
  }
  float* Aik = Ab + i * ldt + k * T;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int rr = ty + 16 * r, cc = tx + 16 * c;
      Aik[(size_t)rr * Np + cc] = C[rr * LD + cc] - acc[r][c];
    }
}


// ---- the flow route ----

// Zero each matrix's counters: rows[0..nt-1] (tiles of the row stored),
// subs[0..nt-1] (the subdiagonal tile's sum stored) and the ticket counter.
__global__ void chol_flow_init(const int* __restrict__ skip, int* __restrict__ sync, int nt) {
  const int b = blockIdx.x;
  if (skip != nullptr && skip[b]) return;
  for (int e = threadIdx.x; e <= 2 * nt; e += blockDim.x) sync[(size_t)b * (2 * nt + 1) + e] = 0;
}

// Thread 0: have row i and row k stored their tiles of panel column j?
// Refreshes the cached counts with an acquire read when they say no.
__device__ __forceinline__ bool cols_ready(const int* rows, int i, int k, int j, int& have_i,
                                           int& have_k) {
  if (j < have_i && j < have_k) return true;
  have_i = ld_acquire(rows + i);
  have_k = i == k ? have_i : ld_acquire(rows + k);
  return j < have_i && j < have_k;
}

__device__ __forceinline__ void wait_cols(const int* rows, int i, int k, int j, int& have_i,
                                          int& have_k) {
  while (!cols_ready(rows, i, k, j, have_i, have_k)) __nanosleep(32);
}

// Start the copies of panel column j's tiles L_ij (and L_kj off the diagonal).
__device__ __forceinline__ void load_panel(float* P, float* Q, const float* Lb, size_t ldt,
                                           int Np, int i, int k, int j) {
  load_tile_async(P, Lb + i * ldt + j * T, Np);
  if (i != k) load_tile_async(Q, Lb + k * ldt + j * T, Np);
  cp_async_commit();
}

// Store the 64x64 tile S (shared, LD stride) to G (row stride ld floats).
__device__ __forceinline__ void store_tile(const float* S, float* G, size_t ld) {
#pragma unroll
  for (int q = 0; q < T * T / 4 / kThreads; ++q) {
    const int e = threadIdx.x + q * kThreads, r = e >> 4, c = (e & 15) * 4;
    *reinterpret_cast<float4*>(G + r * ld + c) = *reinterpret_cast<const float4*>(S + r * LD + c);
  }
}

// Zero the 64x64 tile G (row stride ld floats).
__device__ __forceinline__ void zero_tile(float* G, size_t ld) {
#pragma unroll
  for (int q = 0; q < T * T / 4 / kThreads; ++q) {
    const int e = threadIdx.x + q * kThreads, r = e >> 4, c = (e & 15) * 4;
    *reinterpret_cast<float4*>(G + r * ld + c) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// L_ik = C Wd^T (C, Ws shared) into global tile G and, when S is not null,
// into shared S; zeros the mirrored tile Z above the diagonal.
__device__ __forceinline__ void panel_tile(const float* C, const float* Ws, float* G, float* S,
                                           float* Z, size_t ld) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float lp[4][4] = {};
  mma_nt(C, Ws, lp, tx, ty);
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      G[(ty + 16 * r) * ld + tx + 16 * c] = lp[r][c];
      if (S != nullptr) S[(ty + 16 * r) * LD + tx + 16 * c] = lp[r][c];
    }
  zero_tile(Z, ld);
}

// After a barrier that follows the task's stores: publish `v` at `flag`.
// The release store orders the CTA's stores, which the barrier ordered
// before it, ahead of the flag for a reader that loads it with acquire (a
// __threadfence before it as well cost 0.4-6 % of K1b's flow route:
// bench/chol_probe.py --variants winv, H100 80GB HBM3 at 700 W).
__device__ __forceinline__ void publish(int* flag, int v) {
  if (threadIdx.x == 0) st_release(flag, v);
}

// One task (i, k) of K1a's flow route, for matrix b (its L tiles at Lb,
// its Wd at Wdb, its counters rows and subs):
//   (i, k), i > k + 1: C = K_ik - sum_{j<k} L_ij L_kj^T, then L_ik = C Wd_k^T
//     once Wd_k is stored; rows[i] = k + 1.
//   (k + 1, k): the same sum, stored in L's tile (k+1, k); subs[k+1] = 1.
//   (k, k): C = K_kk (+ jitter) - the sum over j < k - 1; then, once
//     subs[k] and Wd_{k-1} are there, L_{k,k-1} = C_{k,k-1} Wd_{k-1}^T
//     (rows[k] = k) and C -= L_{k,k-1} L_{k,k-1}^T; the tile factor gives
//     L_kk and Wd_k (rows[k] = k + 1).
// So the diagonal chain crosses one CTA boundary per column (Wd_{k-1} to
// the diagonal task of column k), not two.  Shared memory sm: four operand
// tiles (two stages of L_ij, L_kj; then the four groups' partial sums,
// C_{k,k-1}, Wd and L_{k,k-1}, or the tile factor's inverse) and the tile C
// (K_ik, then the task's sum); s_ready: two ints.
__device__ __forceinline__ void factor_task(int i, int k, const float* __restrict__ K,
                                            const float* __restrict__ jitter, float* Lb, float* Wdb,
                                            int* rows, int* subs, float* sm, int* s_ready, int b,
                                            int n, int Np) {
  float* C = sm + 2 * kFlowStages * TILE_F;
  const int t = threadIdx.x;
  const int g = t >> 6, gy = (t & 63) >> 3, gx = t & 7;  // 8x8 product: group, row, column
  const size_t ldt = (size_t)T * Np;
  const bool diag = i == k;
  // C <- tile (i, k) of blockdiag(K, I), asynchronously, in a group of its own
  {
    const float* Kb = K + (size_t)b * n * n;
    for (int e = t; e < T * T; e += kThreads) {
      const int r = e >> 6, c = e & 63, gr = i * T + r, gc = k * T + c;
      if (gr < n && gc < n) cp_async4(C + r * LD + c, Kb + (size_t)gr * n + gc);
      else C[r * LD + c] = gr == gc ? 1.f : 0.f;
    }
    cp_async_commit();
  }
  // Panel j's tiles go to stage j % kFlowStages, one commit group a panel;
  // `issued` panels have their copies started (the same count in every
  // thread).  While panel j's product runs, the copies of the next ones
  // that are stored already are in flight.
  const int jend = diag && k > 0 ? k - 1 : k;  // the diagonal's last product comes later
  int have_i = 0, have_k = 0;                   // thread 0's view of rows[i], rows[k]
  int issued = 0;
  float acc[8][8] = {};
  for (int j = 0; j < jend; ++j) {
    const int lim = min(j + kFlowStages, jend);  // stages free once panel j - 1 is done
    if (t == 0) {
      if (min(have_i, have_k) < lim) cols_ready(rows, i, k, lim - 1, have_i, have_k);
      s_ready[j & 1] = max(0, min(lim, min(have_i, have_k)) - issued);
    }
    const bool late = issued == j;  // panel j's copies not started yet
    if (!late) cp_async_wait_upto(issued - j - 1);  // panel j landed
    __syncthreads();  // ... for every thread; panel j - 1's product done
    for (int q = s_ready[j & 1]; q > 0; --q, ++issued) {
      float* S = sm + (issued % kFlowStages) * 2 * TILE_F;
      load_panel(S, S + TILE_F, Lb, ldt, Np, i, k, issued);
    }
    if (late) {
      if (issued == j) {  // panel j is not stored yet
        if (t == 0) wait_cols(rows, i, k, j, have_i, have_k);
        __syncthreads();
        float* S = sm + (j % kFlowStages) * 2 * TILE_F;
        load_panel(S, S + TILE_F, Lb, ldt, Np, i, k, j);
        ++issued;
      }
      cp_async_wait_upto(issued - j - 1);
      __syncthreads();
    }
    const float* P = sm + (j % kFlowStages) * 2 * TILE_F;
    mma_nt_8x8(P, diag ? P : P + TILE_F, acc, gy, gx, 16 * g);
  }
  cp_async_wait<0>();
  __syncthreads();  // every product done, C landed
  float* R = sm + g * TILE_F;  // group g's partial sum
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < 8; ++c) R[(gy + 8 * a) * LD + gx + 8 * c] = acc[a][c];
  __syncthreads();
  {
    const float jit = diag && jitter != nullptr ? jitter[b] : 0.f;
    for (int e = t; e < T * T; e += kThreads) {
      const int r = e >> 6, c = e & 63, o = r * LD + c;
      const float s = ((sm[o] + sm[TILE_F + o]) + sm[2 * TILE_F + o]) + sm[3 * TILE_F + o];
      const float kv = diag && r == c && i * T + r < n ? C[o] + jit : C[o];
      C[o] = kv - s;
    }
  }
  __syncthreads();
  if (diag && k > 0) {
    // the chain: L_{k,k-1} from the subdiagonal task's sum, then C -= its
    // product with itself
    float* Lsub = Lb + k * ldt + (k - 1) * T;
    if (t == 0)
      while (!ld_acquire(subs + k)) __nanosleep(32);
    __syncthreads();
    load_tile_async(sm, Lsub, Np);  // in flight while Wd_{k-1} is awaited
    if (t == 0) {
      int h0 = 0, h1 = 0;
      wait_cols(rows, k - 1, k - 1, k - 1, h0, h1);  // Wd_{k-1} stored
    }
    __syncthreads();
    load_tile_async(sm + TILE_F, Wdb + (size_t)(k - 1) * T * T, T);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float* Ls = sm + 2 * TILE_F;
    panel_tile(sm, sm + TILE_F, Lsub, Ls, Lb + (k - 1) * ldt + k * T, Np);
    __syncthreads();
    publish(rows + k, k);
    const int tx = t & 15, ty = t >> 4;
    float up[4][4] = {};
    mma_nt(Ls, Ls, up, tx, ty);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) C[(ty + 16 * r) * LD + tx + 16 * c] -= up[r][c];
    __syncthreads();
  }
  if (diag) {
    factor_tile(C, sm);
    store_factor(C, sm, Lb + k * ldt + k * T, Np, Wdb + (size_t)k * T * T);
    __syncthreads();
    publish(rows + k, k + 1);
  } else if (i == k + 1) {
    store_tile(C, Lb + i * ldt + k * T, Np);
    __syncthreads();
    publish(subs + i, 1);
  } else {
    if (t == 0) {
      int h0 = 0, h1 = 0;
      wait_cols(rows, k, k, k, h0, h1);  // Wd_k stored
    }
    __syncthreads();
    load_tile_async(sm + TILE_F, Wdb + (size_t)k * T * T, T);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    panel_tile(C, sm + TILE_F, Lb + i * ldt + k * T, nullptr, Lb + k * ldt + i * T, Np);
    __syncthreads();
    publish(rows + i, k + 1);
  }
}

// K1a's ticket -> task (i, k), for tickets at or past 3: for each column c
// the chain's three tasks two columns ahead, (c+2, c), (c+2, c+1) and
// (c+2, c+2), then the rest of column c, (c+3 .. nt-1, c); r is the ticket
// less 3.
__device__ __forceinline__ void factor_ticket(int r, int nt, int& i, int& k) {
  int c = 0;
  while (r >= nt - c) r -= nt - c++;
  i = r < 3 ? c + 2 : c + r;
  k = r < 3 ? c + r : c;
}

// Persistent grid (CTAs, B), 256 threads, one CTA an SM.  Each CTA takes
// task tickets of its matrix until none is left.  The tickets run through
// (0, 0), (1, 0), (1, 1), then factor_ticket's order: the tasks of the
// diagonal chain two columns ahead come before the rest of column c, and
// each task still follows every task it reads.
__global__ void __launch_bounds__(kThreads, 1)
chol_flow(const float* __restrict__ K, const float* __restrict__ jitter,
          const int* __restrict__ skip, float* __restrict__ L, float* __restrict__ Wd,
          int* __restrict__ sync, int n, int Np) {
  const int b = blockIdx.y;
  if (skip != nullptr && skip[b]) return;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  __shared__ int s_task;
  __shared__ int s_ready[2];
  const int nt = Np / T, t = threadIdx.x, n_tasks = nt * (nt + 1) / 2;
  int* rows = sync + (size_t)b * (2 * nt + 1);
  int* subs = rows + nt;
  float* Lb = L + (size_t)b * Np * Np;
  float* Wdb = Wd + (size_t)b * nt * T * T;
  for (;;) {
    if (t == 0) s_task = atomicAdd(subs + nt, 1);
    __syncthreads();
    int k = 0, i = s_task;
    if (i >= n_tasks) return;
    if (i < 3) {  // (0, 0), (1, 0), (1, 1)
      k = i >> 1;
      i = i > 0;
    } else {
      factor_ticket(i - 3, nt, i, k);
    }
    factor_task(i, k, K, jitter, Lb, Wdb, rows, subs, sm, s_ready, b, n, Np);
  }
}

// W = Wd at one tile (Np == 64), where the two have the same layout: grid
// (T*T/4/kThreads, B), one float4 a thread.
__global__ void winv_init(const int* __restrict__ skip, const float* __restrict__ Wd,
                          float* __restrict__ W) {
  const int b = blockIdx.y;
  if (skip != nullptr && skip[b]) return;
  const size_t e = (size_t)b * T * T / 4 + blockIdx.x * blockDim.x + threadIdx.x;
  reinterpret_cast<float4*>(W)[e] = reinterpret_cast<const float4*>(Wd)[e];
}

// ---- K1b's flow route ----

// Zero each matrix's counters: cols[0..nt-1] (rows of the column stored
// below the diagonal) and the ticket counter.
__global__ void winv_flow_init(const int* __restrict__ skip, int* __restrict__ sync, int nt) {
  const int b = blockIdx.x;
  if (skip != nullptr && skip[b]) return;
  for (int e = threadIdx.x; e <= nt; e += blockDim.x) sync[(size_t)b * (nt + 1) + e] = 0;
}

// Start the copies of term j = k + p of task (i, k): L_ij and W_jk (Wd_k
// for p = 0), one commit group.
__device__ __forceinline__ void load_term(float* S, const float* Lb, const float* Wb,
                                          const float* Wdb, size_t ldt, int Np, int i, int k,
                                          int p) {
  const int j = k + p;
  load_tile_async(S, Lb + i * ldt + j * T, Np);
  if (p == 0) load_tile_async(S + TILE_F, Wdb + (size_t)k * T * T, T);
  else load_tile_async(S + TILE_F, Wb + j * ldt + k * T, Np);
  cp_async_commit();
}

// Thread 0: wait until rows[i] >= v.
__device__ __forceinline__ void wait_rows(const int* rows, int i, int v) {
  while (ld_acquire(rows + i) < v) __nanosleep(32);
}

// Thread 0: how many leading terms of task (i, k) of W are readable: term
// p = j - k needs W_jk (cols[k] >= p; Wd_k for p = 0) and, where L is
// formed in the same launch (kFused), L_ij (rows[i] > j; then Wd_k, which
// L_ik waited for, is there too).
template <bool kFused>
__device__ __forceinline__ int winv_terms(const int* cols, const int* rows, int i, int k) {
  const int h = 1 + ld_acquire(cols + k);
  return kFused ? min(h, ld_acquire(rows + i) - k) : h;
}

// One task (i, k) of W (K1b's flow route; with kFused, of chol_flow_inv,
// where L, Wd and the counters rows[] come from the same launch), for
// matrix b's tiles at Lb, Wb, Wdb and its column counters cols:
//   W_ik = -Wd_i sum_{j=k}^{i-1} L_ij W_jk   (W_kk = Wd_k),  W_ii = Wd_i,
// streaming L_ij and W_jk through the cp.async stages as soon as both are
// stored, the last term L_{i,i-1} W_{i-1,k} last; the sum on 8x8 register
// tiles, the four 64-thread groups each over a 16-wide quarter of the
// depth, the partial sums added in a fixed order; then the product with
// Wd_i (4x4 tiles over the whole depth) is stored, the tile W_ki above the
// diagonal zeroed, and cols[k] = i - k published.  kFused changes only
// when tiles are awaited and copied, never the arithmetic, so W has the
// same bits either way.  Shared memory sm: the panel stages (L_ij, W_jk;
// then the four groups' partial sums), Wd_i and the sum S; s_ready: two
// ints.
template <bool kFused>
__device__ __forceinline__ void winv_task(int i, int k, const float* Lb, float* Wb,
                                          const float* Wdb, int* cols, const int* rows, float* sm,
                                          int* s_ready, int Np) {
  float* Ws = sm + 2 * kFlowStages * TILE_F;  // Wd_i
  float* S = Ws + TILE_F;
  const int t = threadIdx.x;
  const int g = t >> 6, gy = (t & 63) >> 3, gx = t & 7;  // 8x8 product: group, row, column
  const size_t ldt = (size_t)T * Np;
  if (k == i) {  // W_ii = Wd_i
    if (kFused) {
      if (t == 0) wait_rows(rows, i, i + 1);
      __syncthreads();
    }
#pragma unroll
    for (int q = 0; q < T * T / 4 / kThreads; ++q) {
      const int e = t + q * kThreads, r = e >> 4, c = (e & 15) * 4;
      *reinterpret_cast<float4*>(Wb + i * ldt + i * T + r * Np + c) =
          *reinterpret_cast<const float4*>(Wdb + (size_t)i * T * T + r * T + c);
    }
    __syncthreads();  // every thread has read the ticket
    return;
  }
  if (!kFused) {  // Wd_i is there from the start
    load_tile_async(Ws, Wdb + (size_t)i * T * T, T);
    cp_async_commit();
  }
  // Term p (j = k + p) goes to stage p % kFlowStages, one commit group a
  // term; `issued` terms have their copies started (the same count in
  // every thread).  Without kFused term 0 (L_ik, Wd_k) is readable at once.
  const int np = i - k;
  int have = kFused ? 0 : 1;  // thread 0's view: terms [0, have) readable
  int issued = 0;
  if (!kFused) {
    load_term(sm, Lb, Wb, Wdb, ldt, Np, i, k, 0);  // in flight while the counter is read
    issued = 1;
  }
  float acc[8][8] = {};
  for (int p = 0; p < np; ++p) {
    const int lim = min(p + kFlowStages, np);  // stages free once term p - 1 is done
    if (t == 0) {
      if (have < lim) have = winv_terms<kFused>(cols, rows, i, k);
      s_ready[p & 1] = max(0, min(lim, have) - issued);
    }
    const bool late = issued == p;  // term p's copies not started yet
    if (!late) cp_async_wait_upto(issued - p - 1);  // term p landed
    __syncthreads();  // ... for every thread; term p - 1's product done
    for (int q = s_ready[p & 1]; q > 0; --q, ++issued)
      load_term(sm + (issued % kFlowStages) * 2 * TILE_F, Lb, Wb, Wdb, ldt, Np, i, k, issued);
    if (late) {
      float* P = sm + (p % kFlowStages) * 2 * TILE_F;
      if (issued == p) {
        if (kFused) {  // term p is not readable yet
          if (t == 0)
            while (have <= p) {
              __nanosleep(32);
              have = winv_terms<true>(cols, rows, i, k);
            }
          __syncthreads();
          load_term(P, Lb, Wb, Wdb, ldt, Np, i, k, p);
        } else {  // W_{k+p,k} is not stored yet: copy L_{i,k+p} meanwhile
          load_tile_async(P, Lb + i * ldt + (k + p) * T, Np);
          if (t == 0)
            while (have <= p) {
              __nanosleep(32);
              have = winv_terms<false>(cols, rows, i, k);
            }
          __syncthreads();
          load_tile_async(P + TILE_F, Wb + (k + p) * ldt + k * T, Np);
          cp_async_commit();
        }
        ++issued;
      }
      cp_async_wait_upto(issued - p - 1);
      __syncthreads();
    }
    const float* P = sm + (p % kFlowStages) * 2 * TILE_F;
    mma_nn_8x8(P, P + TILE_F, acc, gy, gx, 16 * g);
  }
  if (kFused && t == 0) wait_rows(rows, i, i + 1);  // Wd_i stored
  cp_async_wait<0>();
  __syncthreads();  // every product done (and Wd_i landed, without kFused)
  if (kFused) {  // Wd_i's copy runs while the partial sums are added
    load_tile_async(Ws, Wdb + (size_t)i * T * T, T);
    cp_async_commit();
  }
  float* R = sm + g * TILE_F;  // group g's partial sum
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(R + (gy + 8 * a) * LD + 32 * h + 4 * gx) =
          make_float4(acc[a][4 * h], acc[a][4 * h + 1], acc[a][4 * h + 2], acc[a][4 * h + 3]);
  __syncthreads();
#pragma unroll
  for (int q = 0; q < T * T / 4 / kThreads; ++q) {
    const int e = t + q * kThreads, o = (e >> 4) * LD + (e & 15) * 4;
    const float4 r0 = *reinterpret_cast<const float4*>(sm + o);
    const float4 r1 = *reinterpret_cast<const float4*>(sm + TILE_F + o);
    const float4 r2 = *reinterpret_cast<const float4*>(sm + 2 * TILE_F + o);
    const float4 r3 = *reinterpret_cast<const float4*>(sm + 3 * TILE_F + o);
    *reinterpret_cast<float4*>(S + o) =
        make_float4(((r0.x + r1.x) + r2.x) + r3.x, ((r0.y + r1.y) + r2.y) + r3.y,
                    ((r0.z + r1.z) + r2.z) + r3.z, ((r0.w + r1.w) + r2.w) + r3.w);
  }
  if (kFused) cp_async_wait<0>();
  __syncthreads();
  {  // W_ik = -Wd_i S; the tile W_ki above the diagonal is zero
    const int tx = t & 15, ty = t >> 4;
    float w[4][4] = {};
    mma_nn(Ws, S, w, tx, ty);
    float* out = Wb + i * ldt + k * T;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      *reinterpret_cast<float4*>(out + (size_t)(ty + 16 * r) * Np + 4 * tx) =
          make_float4(-w[r][0], -w[r][1], -w[r][2], -w[r][3]);
    zero_tile(Wb + k * ldt + i * T, Np);
  }
  __syncthreads();
  publish(cols + k, i - k);
}

// Persistent grid (CTAs, B), 256 threads, one CTA an SM.  Each CTA takes
// task tickets of its matrix in row order until none is left; ticket
// i(i+1)/2 + k is task (i, k), k <= i (see the notes at the top).
__global__ void __launch_bounds__(kThreads, 1)
winv_flow(const float* __restrict__ L, const float* __restrict__ Wd,
          const int* __restrict__ skip, float* __restrict__ W, int* __restrict__ sync, int Np) {
  const int b = blockIdx.y;
  if (skip != nullptr && skip[b]) return;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  __shared__ int s_ticket;
  __shared__ int s_ready[2];
  const int nt = Np / T, t = threadIdx.x, n_tasks = nt * (nt + 1) / 2;
  int* cols = sync + (size_t)b * (nt + 1);
  const size_t mat = (size_t)b * Np * Np;
  for (;;) {
    if (t == 0) s_ticket = atomicAdd(cols + nt, 1);
    __syncthreads();
    const int ticket = s_ticket;
    if (ticket >= n_tasks) return;
    int i = (int)((sqrtf(8.f * ticket + 1.f) - 1.f) * 0.5f);
    while ((i + 1) * (i + 2) / 2 <= ticket) ++i;
    while (i * (i + 1) / 2 > ticket) --i;
    const int k = ticket - i * (i + 1) / 2;
    winv_task<false>(i, k, L + mat, W + mat, Wd + (size_t)b * nt * T * T, cols, nullptr, sm, s_ready,
                     Np);
  }
}

// ---- the fused flow route: L, Wd and W in one launch ----

// Zero each matrix's counters: rows[0..nt-1], subs[0..nt-1] (K1a's),
// cols[0..nt-1] (W's) and the ticket counter.
__global__ void chol_flow_inv_init(const int* __restrict__ skip, int* __restrict__ sync, int nt) {
  const int b = blockIdx.x;
  if (skip != nullptr && skip[b]) return;
  for (int e = threadIdx.x; e <= 3 * nt; e += blockDim.x) sync[(size_t)b * (3 * nt + 1) + e] = 0;
}

// The slot of W's row w in the fused ticket order: its tasks come right
// after K1a's tasks of column c = slot (after (0, 0), (1, 0), (1, 1) for
// slot -1), kWinvLag columns after the column whose tasks hold L's
// diagonal task (w, w) (column w - 2; the first three tasks for w < 2).
__device__ __forceinline__ int winv_slot(int w, int nt) {
  return min(max(w - 2, -1) + kWinvLag, nt - 3);
}

// The fused ticket -> task (i, k); true for a task of W.  K1a's tickets in
// their order (factor_ticket), W's row w, (w, 0) .. (w, w), after the
// tasks of column winv_slot(w).  A task waits only on tasks with smaller
// tickets.
__device__ __forceinline__ bool fused_ticket(int r, int nt, int& i, int& k) {
  if (r < 3) {
    k = r >> 1;
    i = r > 0;
    return false;
  }
  r -= 3;
  int w = 0;  // the next row of W to place
  for (int c = -1;; ++c) {
    if (c >= 0) {
      if (r < nt - c) {
        i = r < 3 ? c + 2 : c + r;
        k = r < 3 ? c + r : c;
        return false;
      }
      r -= nt - c;
    }
    for (; w < nt && winv_slot(w, nt) == c; ++w) {
      if (r <= w) {
        i = w;
        k = r;
        return true;
      }
      r -= w + 1;
    }
  }
}

// Persistent grid (CTAs, B), 256 threads, one CTA an SM: K1a's flow tasks
// and W's tasks from one ticket counter per matrix (fused_ticket's order),
// each task run by factor_task or winv_task<true> as in the two launches
// of chol_flow and winv_flow, so L, Wd and W have their bits.  Shared
// memory: K1b's six tiles (K1a's tasks use the first five).
__global__ void __launch_bounds__(kThreads, 1)
chol_flow_inv(const float* __restrict__ K, const float* __restrict__ jitter,
              const int* __restrict__ skip, float* __restrict__ L, float* __restrict__ Wd,
              float* __restrict__ W, int* __restrict__ sync, int n, int Np) {
  const int b = blockIdx.y;
  if (skip != nullptr && skip[b]) return;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  __shared__ int s_task;
  __shared__ int s_ready[2];
  const int nt = Np / T, t = threadIdx.x, n_tasks = nt * (nt + 1);
  int* rows = sync + (size_t)b * (3 * nt + 1);
  int* subs = rows + nt;
  int* cols = subs + nt;
  const size_t mat = (size_t)b * Np * Np;
  float* Lb = L + mat;
  float* Wdb = Wd + (size_t)b * nt * T * T;
  for (;;) {
    if (t == 0) s_task = atomicAdd(cols + nt, 1);
    __syncthreads();
    const int ticket = s_task;
    if (ticket >= n_tasks) return;
    int i, k;
    if (fused_ticket(ticket, nt, i, k))
      winv_task<true>(i, k, Lb, W + mat, Wdb, cols, rows, sm, s_ready, Np);
    else
      factor_task(i, k, K, jitter, Lb, Wdb, rows, subs, sm, s_ready, b, n, Np);
  }
}

int elementwise_blocks(int Np, int per_thread) {
  const long long total = (long long)Np * Np / per_thread;
  long long blocks = (total + kThreads - 1) / kThreads;
  return (int)(blocks < 1024 ? blocks : 1024);
}

// Allow `bytes` of dynamic shared memory for `fn`, once per device.
template <typename F>
int allow_smem(F* fn, unsigned* done, int bytes) {
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err || (*done >> dev & 1u)) return err;
  err = (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (!err) *done |= 1u << dev;
  return err;
}

template <typename F>
int allow_four_tiles(F* fn, unsigned* done) {
  return allow_smem(fn, done, kFourTiles);
}

unsigned g_step_smem = 0, g_flow_smem = 0, g_winv_smem = 0, g_fused_smem = 0;
// per device: CTAs resident at once
int g_flow_ctas[32] = {}, g_winv_ctas[32] = {}, g_fused_ctas[32] = {};

// CTAs of the persistent kernel `fn` (`bytes` of dynamic shared memory)
// that fit on the current card at once, cached per device in `cache`.
template <typename F>
int resident_ctas(F* fn, unsigned* smem_done, int bytes, int* cache, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev < 32 && cache[dev] > 0) {
    *out = cache[dev];
    return 0;
  }
  if ((err = allow_smem(fn, smem_done, bytes))) return err;
  if ((err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) return err;
  if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, bytes)))
    return err;
  *out = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < 32) cache[dev] = *out;
  return 0;
}

// A persistent grid's CTAs per matrix: the resident CTAs split between the
// B matrices, at least one, at most the tasks of one.
int per_matrix(int ctas, int B, int n_tasks) {
  const int per = ctas / B;
  return per < 1 ? 1 : per < n_tasks ? per : n_tasks;
}

// K1a's route for matrices of padded size Np, at any batch: 1 (flow) from
// kFlowMinTiles tiles, else 0 (step).
int pick_route(int Np) { return Np / T >= kFlowMinTiles ? 1 : 0; }

// K1b's route, the same way: 1 (flow) from kWinvFlowMinTiles tiles, else
// 0 (copy).
int pick_winv_route(int Np) { return Np / T >= kWinvFlowMinTiles ? 1 : 0; }

}  // namespace

// K1a's route at this padded size: 0 step, 1 flow (see the notes at the top).
extern "C" int hebo_chol_route(int Np) { return pick_route(Np); }

// K1b's route at this padded size: 0 copy, 1 flow.
extern "C" int hebo_chol_winv_route(int Np) { return pick_winv_route(Np); }

// K1a.  K (B,n,n) + diag(jitter) -> L (B,Np,Np) lower triangular, Wd
// (B,Np/64,64,64); matrices whose skip flag is set keep their L and Wd.
// jitter (B,) and skip (B,) may be null.  route: -1 picks by the shape
// (pick_route), 0 or 1 forces a route.  scratch: on the step route the
// trailing matrix, B*Np*Np floats (unused when Np == 64); on the flow route
// B*(2*Np/64 + 1) ints of counters.  Np must be a multiple of 64
// and >= n.  Returns the first error (attribute, occupancy or launch).
extern "C" int hebo_chol_factor(const float* K, const float* jitter, const int* skip, float* L,
                                float* Wd, void* scratch, int route, int B, int n, int Np,
                                void* stream) {
  if (B == 0) return 0;
  if (Np % T != 0 || Np < n || route > 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nt = Np / T;
  int err = 0;
  if (route < 0) route = pick_route(Np);
  if (route == 1) {
    int ctas = 0;
    if ((err = resident_ctas(chol_flow, &g_flow_smem, kFlowTiles, g_flow_ctas, &ctas))) return err;
    int* sync = static_cast<int*>(scratch);
    chol_flow_init<<<B, 128, 0, st>>>(skip, sync, nt);
    if ((err = (int)cudaGetLastError())) return err;
    const int grid = per_matrix(ctas, B, nt * (nt + 1) / 2);
    chol_flow<<<dim3(grid, B), kThreads, kFlowTiles, st>>>(K, jitter, skip, L, Wd, sync, n, Np);
    return (int)cudaGetLastError();
  }
  float* A = static_cast<float*>(scratch);
  if (nt > 1 && (err = allow_four_tiles(chol_step, &g_step_smem))) return err;
  const int copy_ctas = nt > 1 ? elementwise_blocks(Np, 1) : 0;
  chol_first<<<dim3(1 + copy_ctas, B), kThreads, 0, st>>>(K, jitter, skip, L, Wd, A, n, Np);
  if ((err = (int)cudaGetLastError())) return err;
  for (int j = 0; j + 1 < nt; ++j) {
    const int m = nt - 1 - j;
    chol_step<<<dim3(m * (m + 1) / 2, B), kThreads, kFourTiles, st>>>(skip, A, L, Wd, Np, j);
    if ((err = (int)cudaGetLastError())) return err;
  }
  return 0;
}

// K1b.  L (B,Np,Np), Wd (B,Np/64,64,64) -> W = L^-1 (B,Np,Np); matrices
// whose skip flag is set keep their W (skip may be null).  The route is
// the size's (pick_winv_route).  scratch: on the flow route B*(Np/64 + 1)
// ints of counters (unused when Np == 64).  Returns the first error
// (attribute, occupancy or launch).
extern "C" int hebo_chol_winv(const float* L, const float* Wd, const int* skip, float* W,
                              void* scratch, int B, int Np, void* stream) {
  if (B == 0) return 0;
  if (Np % T != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (pick_winv_route(Np) == 0) {
    winv_init<<<dim3(T * T / 4 / kThreads, B), kThreads, 0, st>>>(skip, Wd, W);
    return (int)cudaGetLastError();
  }
  const int nt = Np / T;
  int ctas = 0, err = 0;
  if ((err = resident_ctas(winv_flow, &g_winv_smem, kWinvTiles, g_winv_ctas, &ctas))) return err;
  int* sync = static_cast<int*>(scratch);
  winv_flow_init<<<B, 128, 0, st>>>(skip, sync, nt);
  if ((err = (int)cudaGetLastError())) return err;
  const int grid = per_matrix(ctas, B, nt * (nt + 1) / 2);
  winv_flow<<<dim3(grid, B), kThreads, kWinvTiles, st>>>(L, Wd, skip, W, sync, Np);
  return (int)cudaGetLastError();
}

// K1 in one launch pair where K1a takes its flow route (pick_route(Np) ==
// 1): K (B,n,n) + diag(jitter) -> L (B,Np,Np), Wd (B,Np/64,64,64) and
// W = L^-1 (B,Np,Np), the bits of hebo_chol_factor's flow route and then
// hebo_chol_winv; matrices whose skip flag is set keep their L, Wd and W.
// jitter (B,) and skip (B,) may be null.  scratch: B*(3*Np/64 + 1) ints of
// counters.  Returns cudaErrorInvalidValue below the flow route's size,
// else the first error (attribute, occupancy or launch).
extern "C" int hebo_chol_factor_inv(const float* K, const float* jitter, const int* skip, float* L,
                                    float* Wd, float* W, void* scratch, int B, int n, int Np,
                                    void* stream) {
  if (B == 0) return 0;
  if (Np % T != 0 || Np < n || pick_route(Np) != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nt = Np / T;
  int ctas = 0, err = 0;
  if ((err = resident_ctas(chol_flow_inv, &g_fused_smem, kWinvTiles, g_fused_ctas, &ctas))) return err;
  int* sync = static_cast<int*>(scratch);
  chol_flow_inv_init<<<B, 128, 0, st>>>(skip, sync, nt);
  if ((err = (int)cudaGetLastError())) return err;
  const int grid = per_matrix(ctas, B, nt * (nt + 1));
  chol_flow_inv<<<dim3(grid, B), kThreads, kWinvTiles, st>>>(K, jitter, skip, L, Wd, W, sync, n, Np);
  return (int)cudaGetLastError();
}
