// Batched blocked Cholesky with the triangular inverse (kernels K1a, K1b).
//
// Replaces the two Pallas kernels behind hebo_tpu/ops/pallas_chol.py::
// chol_inv_slab (:684):
//   K1a  hebo_chol_factor  <- _factor_slab_kernel (pallas_call :613):
//        K = L L^T and the inverses Wd_j of the 64x64 diagonal tiles of L;
//   K1b  hebo_chol_winv    <- _winv_tile_kernel (pallas_call :665):
//        W = L^-1.
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
//                   diagonal chain's tasks two columns early.  Task (i, k):
//                   C = K_ik (+ jitter) - sum_{j<k} L_ij L_kj^T, streaming
//                   the stored panel tiles L_ij, L_kj through a cp.async
//                   double buffer as they become ready; then the panel tile
//                   L_ik = C Wd_k^T is formed once and stored (and L_ki
//                   zeroed), or the diagonal tile is factored into L_kk and
//                   Wd_k.  The diagonal task of column k also forms
//                   L_{k,k-1} from the subdiagonal task's stored sum, so the
//                   chain crosses one CTA boundary per column.
//   Row i's tiles finish in column order (task (i, k) reads L_i,k-1), so one
//   counter per row says how many of its tiles are stored (released after
//   the stores, read with acquire).  A task waits only on tasks with smaller
//   tickets, which CTAs already running hold, so the grid cannot deadlock
//   whatever the residency.  The diagonal chain overlaps the rest: the
//   chain's tasks of column k+2 take their tickets before the rest of
//   column k and sum their first products then; what stays serial per
//   column is one panel product, one update product and the tile factor,
//   ~17 us.  The products run on 8x8 register tiles: the CTA's four
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
//   16-wide sub-panels: 16 lanes of one warp factor each 16x16 diagonal
//   block and its inverse in registers with no CTA barrier (each column step
//   yields an L column and a W row, as _diag_factor_inverse_merged does,
//   broadcast through shared memory), the CTA solves the sub-panel below it
//   and updates the sub-trailing block, and Wd's off-diagonal 16-blocks come
//   by doubling: 14 CTA barriers per tile instead of 128.  What sets its
//   time is the chain of 64 dependent column steps on one warp (~190 cycles
//   each: pivot, broadcast, row update; about 60% of the ~12 us per tile,
//   measured with clock64 on an H100 80GB HBM3 at 700 W); blocking the steps
//   four columns per round did not shorten it, since the warp is bound by
//   its dependent FMA chains either way.
//
// K1b, recursive doubling, 1 + 2 ceil(log2 nt) launches: W's diagonal tiles
//   are Wd; at level h = 1, 2, 4, ... tiles, for each pair of diagonal
//   blocks [s1, s1+h), [s1+h, s1+2h) (the second cut at nt),
//     X = L21 W11            (winv_level<true>,  into a scratch S)
//     W21 = -W22 X           (winv_level<false>)
//   one CTA per output tile, summing over the non-zero tiles of the
//   triangular factor.  The chain is sum 2h ~ 2 nt tile products (30 at
//   nt = 16) instead of forward substitution's nt(nt-1)/2 (120).
//
// Tile products: FP32 FMA from shared memory with 16-byte reads (no TF32:
// the JAX package runs them at Precision.HIGHEST); operand tiles arrive by
// cp.async, double-buffered in K1b and in the flow route.  The step route
// and K1b use 256 threads with 4x4 outputs each; one 64^3 product is ~1.2 us
// of one SM's FP32 rate.  Kernels whose dynamic shared memory exceeds 48 KB
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
//                that no matrix needs costs its launches (nt in the step
//                route, 2 in the flow route, 1 + 2 ceil(log2 nt) in K1b),
//                not a factorization.
// Either may be null (no jitter, no skip).
//
// Failure semantics: a pivot that is not > 0 (negative, zero or NaN) gives
// a NaN diagonal entry, never a clamped one; the NaN spreads through the
// panel and trailing updates to every later tile of that matrix's L and W,
// so the jitter ladder sees it, as with jnp.linalg.cholesky.  Every CTA
// works inside one matrix, so a NaN never reaches a batch neighbour.  No
// float atomics (the flow route's tickets and counters are integers, and
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
// the flow route's shapes (pick_route)
constexpr int kFlowMinTiles = 8;

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

// Factor the SPD tile in shared A (its lower part is read): A <- L and
// X <- L^-1 on and below the diagonal (store_factor zeros what lies above).
// Ends with a barrier.
__device__ void factor_tile(float* A, float* X) {
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  for (int o = 0; o < T; o += SB) {
    if (t < SB) factor_block16(A, X, o);
    __syncthreads();
    const int nb = (T - o) / SB - 1;  // 16-row blocks below the diagonal block
    if (nb == 0) break;
    // sub-panel solve, thread (ty, tx) -> rows o+16+16i+ty, column o+tx:
    // L[r][o+tx] = sum_m A[r][o+m] Xblk[tx][m]  (Xblk is zero above its
    // diagonal).  Staged in X's lower blocks, which the doubling below
    // overwrites, so the trailing update can read it without a second
    // barrier while A's panel columns take the final values.
    float v[3] = {};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if (i >= nb) break;
      const float* ar = A + (o + SB + SB * i + ty) * LD + o;
      const float* xr = X + (o + tx) * LD + o;
#pragma unroll
      for (int m = 0; m < SB; m += 4) {
        const float4 p = *reinterpret_cast<const float4*>(ar + m);
        const float4 q = *reinterpret_cast<const float4*>(xr + m);
        v[i] = fmaf(p.x, q.x, fmaf(p.y, q.y, fmaf(p.z, q.z, fmaf(p.w, q.w, v[i]))));
      }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i)
      if (i < nb) X[(o + SB + SB * i + ty) * LD + o + tx] = v[i];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 3; ++i)
      if (i < nb) A[(o + SB + SB * i + ty) * LD + o + tx] = v[i];
    // sub-trailing update of the 16-blocks (bi, bj), bj <= bi < nb:
    // A[r][c] -= sum_m L[r][o+m] L[c][o+m], r = o+16+16bi+ty, c = o+16+16bj+tx
    // (the sub-panel L read from its copy in X)
    float acc[3][3] = {};
#pragma unroll
    for (int m = 0; m < SB; m += 4) {
      float4 p[3], q[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        if (i >= nb) break;
        p[i] = *reinterpret_cast<const float4*>(X + (o + SB + SB * i + ty) * LD + o + m);
        q[i] = *reinterpret_cast<const float4*>(X + (o + SB + SB * i + tx) * LD + o + m);
      }
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j <= i; ++j) {
          if (i >= nb) break;
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[i][j] = fmaf(lane4(p[i], k), lane4(q[j], k), acc[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j)
        if (i < nb) A[(o + SB + SB * i + ty) * LD + o + SB + SB * j + tx] -= acc[i][j];
    __syncthreads();
  }
  // off-diagonal 16-blocks of X by doubling.  Level 16: for the pairs of
  // diagonal blocks (0, 1) and (2, 3), Y = L21 X11 (kept in X's upper
  // part), X21 = -X22 Y; thread (ty, tx) forms entry (ty, tx) of both.
  {
    float y[2] = {};
#pragma unroll
    for (int pr = 0; pr < 2; ++pr) {
      const int s1 = 32 * pr, s2 = s1 + SB;
#pragma unroll
      for (int m = 0; m < SB; ++m) y[pr] = fmaf(A[(s2 + ty) * LD + s1 + m], X[(s1 + m) * LD + s1 + tx], y[pr]);
      X[(s1 + ty) * LD + s2 + tx] = y[pr];
    }
    __syncthreads();
#pragma unroll
    for (int pr = 0; pr < 2; ++pr) {
      const int s1 = 32 * pr, s2 = s1 + SB;
      float w = 0.f;
#pragma unroll
      for (int m = 0; m < SB; ++m) w = fmaf(X[(s2 + ty) * LD + s2 + m], X[(s1 + m) * LD + s2 + tx], w);
      X[(s2 + ty) * LD + s1 + tx] = -w;
    }
    __syncthreads();
  }
  // Level 32: Y = L[32:64, 0:32] X[0:32, 0:32] into X[0:32, 32:64], then
  // X[32:64, 0:32] = -X[32:64, 32:64] Y; thread (ty, tx) forms the entries
  // (ty + 16i, tx + 16j).  The sums skip X11's and X22's upper block.
  {
    float acc[2][2] = {};
#pragma unroll
    for (int m = 0; m < 2 * SB; ++m) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (m >= SB * j)
            acc[i][j] = fmaf(A[(32 + ty + SB * i) * LD + m], X[m * LD + tx + SB * j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) X[(ty + SB * i) * LD + 32 + tx + SB * j] = acc[i][j];
    __syncthreads();
    float w[2][2] = {};
#pragma unroll
    for (int m = 0; m < 2 * SB; ++m) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (m < SB * (i + 1))
            w[i][j] = fmaf(X[(32 + ty + SB * i) * LD + 32 + m], X[m * LD + 32 + tx + SB * j], w[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) X[(32 + ty + SB * i) * LD + tx + SB * j] = -w[i][j];
    __syncthreads();
  }
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

// After a barrier that follows the task's stores: make them visible, then
// publish `v` at `flag`.
__device__ __forceinline__ void publish(int* flag, int v) {
  if (threadIdx.x == 0) {
    __threadfence();
    st_release(flag, v);
  }
}

// Persistent grid (CTAs, B), 256 threads, one CTA an SM.  Each CTA takes
// task tickets of its matrix until none is left.  The tickets run through
// (0, 0), (1, 0), (1, 1), then for each column c: (c+2, c), (c+2, c+1),
// (c+2, c+2), then (c+3 .. nt-1, c): the tasks of the diagonal chain two
// columns ahead come before the rest of column c, and each task still
// follows every task it reads.
// Three kinds of task:
//   (i, k), i > k + 1: C = K_ik - sum_{j<k} L_ij L_kj^T, then L_ik = C Wd_k^T
//     once Wd_k is stored; rows[i] = k + 1.
//   (k + 1, k): the same sum, stored in L's tile (k+1, k); subs[k+1] = 1.
//   (k, k): C = K_kk (+ jitter) - the sum over j < k - 1; then, once
//     subs[k] and Wd_{k-1} are there, L_{k,k-1} = C_{k,k-1} Wd_{k-1}^T
//     (rows[k] = k) and C -= L_{k,k-1} L_{k,k-1}^T; the tile factor gives
//     L_kk and Wd_k (rows[k] = k + 1).
// So the diagonal chain crosses one CTA boundary per column (Wd_{k-1} to
// the diagonal task of column k), not two.  Shared memory: four operand
// tiles (two stages of L_ij, L_kj; then the four groups' partial sums,
// C_{k,k-1}, Wd and L_{k,k-1}, or the tile factor's inverse) and the tile C
// (K_ik, then the task's sum).
__global__ void __launch_bounds__(kThreads, 1)
chol_flow(const float* __restrict__ K, const float* __restrict__ jitter,
          const int* __restrict__ skip, float* __restrict__ L, float* __restrict__ Wd,
          int* __restrict__ sync, int n, int Np) {
  const int b = blockIdx.y;
  if (skip != nullptr && skip[b]) return;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* C = sm + 2 * kFlowStages * TILE_F;
  __shared__ int s_task;
  __shared__ int s_ready[2];
  const int nt = Np / T, t = threadIdx.x, n_tasks = nt * (nt + 1) / 2;
  const int g = t >> 6, gy = (t & 63) >> 3, gx = t & 7;  // 8x8 product: group, row, column
  int* rows = sync + (size_t)b * (2 * nt + 1);
  int* subs = rows + nt;
  const size_t ldt = (size_t)T * Np;
  float* Lb = L + (size_t)b * Np * Np;
  float* Wdb = Wd + (size_t)b * nt * T * T;
  for (;;) {
    if (t == 0) s_task = atomicAdd(subs + nt, 1);
    __syncthreads();
    int k = 0, i = s_task;
    if (i >= n_tasks) return;
    if (i < 3) {  // ticket -> (i, k): see the task order above
      k = i >> 1;
      i = i > 0;
    } else {
      int c = 0, r = i - 3;
      while (r >= nt - c) r -= nt - c++;
      i = r < 3 ? c + 2 : c + r;
      k = r < 3 ? c + r : c;
    }
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
}

// W on and above the tile diagonal: Wd_i on it, 0 above it.
__global__ void winv_init(const int* __restrict__ skip, const float* __restrict__ Wd,
                          float* __restrict__ W, int Np) {
  const int b = blockIdx.y;
  if (skip != nullptr && skip[b]) return;
  const int nt = Np / T;
  const size_t total4 = (size_t)Np * Np / 4;
  float4* Wb = reinterpret_cast<float4*>(W + (size_t)b * Np * Np);
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < total4;
       e += (size_t)gridDim.x * blockDim.x) {
    const int r = (int)(e * 4 / Np), c = (int)(e * 4 % Np);
    const int ti = r / T, tc = c / T;
    if (tc > ti) Wb[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    else if (tc == ti)
      Wb[e] = *reinterpret_cast<const float4*>(
          Wd + (((size_t)b * nt + ti) * T + r % T) * T + c % T);
  }
}

// One doubling level of W = L^-1 at block size h tiles, one CTA per output
// tile (a, bb) of a pair's 21 block (first block [s1, s1+h), second
// [s2, s2+h) cut at nt):
//   kX:  S(s2+a, s1+bb) = sum_{c=bb}^{h-1} L(s2+a, s1+c) W(s1+c, s1+bb)
//   !kX: W(s2+a, s1+bb) = -sum_{c=0}^{a} W(s2+a, s2+c) S(s2+c, s1+bb)
// The sums skip the zero tiles of the triangular W11 and W22; operand tiles
// are double-buffered with cp.async.
template <bool kX>
__global__ void __launch_bounds__(kThreads)
winv_level(const int* __restrict__ skip, const float* __restrict__ L, float* __restrict__ W,
           float* __restrict__ S, int Np, int h) {
  if (skip != nullptr && skip[blockIdx.y]) return;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int nt = Np / T, b = blockIdx.y;
  const int p = blockIdx.x / (h * h), a = (blockIdx.x / h) % h, bb = blockIdx.x % h;
  const int s1 = 2 * p * h, s2 = s1 + h;
  if (s2 + a >= nt) return;
  const size_t mat = (size_t)b * Np * Np, ldt = (size_t)T * Np;
  const float* Lb = L + mat;
  float* Wb = W + mat;
  float* Sb = S + mat;
  const int c_lo = kX ? bb : 0, c_hi = kX ? h : a + 1;
  auto ptrP = [&](int c) -> const float* {
    return kX ? Lb + (s2 + a) * ldt + (s1 + c) * T : Wb + (s2 + a) * ldt + (s2 + c) * T;
  };
  auto ptrQ = [&](int c) -> const float* {
    return kX ? Wb + (s1 + c) * ldt + (s1 + bb) * T : Sb + (s2 + c) * ldt + (s1 + bb) * T;
  };
  load_tile_async(sm, ptrP(c_lo), Np);
  load_tile_async(sm + TILE_F, ptrQ(c_lo), Np);
  cp_async_commit();
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4] = {};
  for (int c = c_lo; c < c_hi; ++c) {
    const float* cur = sm + ((c - c_lo) & 1) * 2 * TILE_F;
    if (c + 1 < c_hi) {
      float* nxt = sm + ((c + 1 - c_lo) & 1) * 2 * TILE_F;
      load_tile_async(nxt, ptrP(c + 1), Np);
      load_tile_async(nxt + TILE_F, ptrQ(c + 1), Np);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    mma_nn(cur, cur + TILE_F, acc, tx, ty);
    __syncthreads();
  }
  float* out = (kX ? Sb : Wb) + (s2 + a) * ldt + (s1 + bb) * T;
  const float sign = kX ? 1.f : -1.f;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    *reinterpret_cast<float4*>(out + (size_t)(ty + 16 * r) * Np + 4 * tx) =
        make_float4(sign * acc[r][0], sign * acc[r][1], sign * acc[r][2], sign * acc[r][3]);
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

unsigned g_step_smem = 0, g_xlevel_smem = 0, g_wlevel_smem = 0, g_flow_smem = 0;
int g_flow_ctas[32] = {};  // per device: chol_flow CTAs resident at once

// CTAs of chol_flow that fit on the current card at once.
int flow_ctas(int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev < 32 && g_flow_ctas[dev] > 0) {
    *out = g_flow_ctas[dev];
    return 0;
  }
  if ((err = allow_smem(chol_flow, &g_flow_smem, kFlowTiles))) return err;
  if ((err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) return err;
  if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chol_flow, kThreads,
                                                                kFlowTiles)))
    return err;
  *out = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < 32) g_flow_ctas[dev] = *out;
  return 0;
}

// K1a's route for matrices of padded size Np, at any batch: 1 (flow) from
// kFlowMinTiles tiles, else 0 (step).
int pick_route(int Np) { return Np / T >= kFlowMinTiles ? 1 : 0; }

}  // namespace

// K1a's route at this padded size: 0 step, 1 flow (see the notes at the top).
extern "C" int hebo_chol_route(int Np) { return pick_route(Np); }

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
    if ((err = flow_ctas(&ctas))) return err;
    int* sync = static_cast<int*>(scratch);
    chol_flow_init<<<B, 128, 0, st>>>(skip, sync, nt);
    if ((err = (int)cudaGetLastError())) return err;
    const int per = ctas / B, n_tasks = nt * (nt + 1) / 2;
    const int grid = per < 1 ? 1 : per < n_tasks ? per : n_tasks;
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
// whose skip flag is set keep their W (skip may be null).  S (B,Np,Np) is
// scratch (unused when Np == 64).
extern "C" int hebo_chol_winv(const float* L, const float* Wd, const int* skip, float* W,
                              float* S, int B, int Np, void* stream) {
  if (B == 0) return 0;
  if (Np % T != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nt = Np / T;
  winv_init<<<dim3(elementwise_blocks(Np, 4), B), kThreads, 0, st>>>(skip, Wd, W, Np);
  int err = (int)cudaGetLastError();
  if (err || nt == 1) return err;
  if ((err = allow_four_tiles(winv_level<true>, &g_xlevel_smem))) return err;
  if ((err = allow_four_tiles(winv_level<false>, &g_wlevel_smem))) return err;
  for (int h = 1; h < nt; h *= 2) {
    const int pairs = (nt - h + 2 * h - 1) / (2 * h);
    const dim3 grid(pairs * h * h, B);
    winv_level<true><<<grid, kThreads, kFourTiles, st>>>(skip, L, W, S, Np, h);
    if ((err = (int)cudaGetLastError())) return err;
    winv_level<false><<<grid, kThreads, kFourTiles, st>>>(skip, L, W, S, Np, h);
    if ((err = (int)cudaGetLastError())) return err;
  }
  return 0;
}
