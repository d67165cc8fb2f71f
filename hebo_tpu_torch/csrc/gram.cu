// Fused ARD Matérn-3/2 Gram for a batch of point sets (kernel K2), and its
// vector-Jacobian product.
//
// Replaces the Pallas kernel hebo_tpu/ops/pallas_gram.py::_kernel (its
// pallas_call sites :87 `_pallas_call` and :164 `_interpret_call`) and the
// XLA-fused VJP of that module's custom_vjp (:128-133).  For every batch
// entry b the forward computes
//
//   K[b,i,j] = sc[b] * (1 + s) * exp(-s),   s = sqrt(3) * d,
//   d = sqrt(max(d2, 0) + 1e-16),   d2 = |a_i|^2 + |b_j|^2 - 2 a_i.b_j,
//
// plus `jitter` on the global diagonal (i == j).  a and b arrive already
// scaled by 1/lengthscale.  The distance uses the same expansion form as
// the Pallas kernel (:61-71); s and exp(-s) come from the special function
// unit (matern_s, exp_neg), so kernel and plain version agree to a few ulp.
//
// The VJP of K against a cotangent g has a closed form.  With
// G_ij = -3 sc g_ij exp(-s_ij) [d2_ij >= 0] (the clamp passes the gradient
// where d2 >= 0, as torch.clamp does),
//
//   ga_i = a_i sum_j G_ij - sum_j G_ij b_j,
//   gb_j = b_j sum_i G_ij - sum_i G_ij a_i,
//   gsc  = sum_ij g_ij (1 + s_ij) exp(-s_ij).
//
// The roofline bound of both on an H100: device memory.  D is small (6 for
// Ackley-6D, d_num + C*emb_dim with categoricals), so the forward writes
// N*M floats and the VJP reads as many (8 MiB at (2, 1024, 1024, 6), 2.5 us
// at 3.35 TB/s) against ~50 and ~100 MFLOP, far below the 67 TFLOP/s FP32
// rate.  So neither kernel keeps the distance tile in device memory:
//
// * One CTA of 256 threads per (batch, 16*RI-row x 64-column tile).  Each
//   thread owns RI rows (ty, ty+16, ...) and 4 adjacent columns (4*tx..),
//   so a warp's store (forward) or load of g (VJP) is two 256-byte row
//   pieces of 16-byte float4 accesses.  The rows per thread RI (4, 2 or 1)
//   come from pick_rows below: the largest that still gives every SM a CTA.
// * distance_tile stages the tile's a- and b-rows in shared memory in
//   chunks of 16 features (each chunk's values all asked for before the
//   first is stored: one load latency a chunk) and accumulates dot products
//   and squared norms in registers; the Matérn transform (forward) or G
//   (VJP) follows in registers.
// * The VJP reduces G's rows across the 16 lanes that share them (warp
//   shuffles, halving the values each step) and its columns across the 16
//   thread rows (one shuffle, then the 8 warps through shared memory), and
//   writes per-tile partial sums: (B, col tiles, D, N) for ga, (B, row
//   tiles, D, M) for gb, one value per tile for gsc.
// * A second launch sums the partials in tile order.  No float atomics:
//   every sum has a fixed order, so two runs on the same inputs give the
//   same bits.
//
// Measured on an H100 80GB HBM3 at 700 W (hebo_tpu_torch/bench/gram_probe.py):
// at HEBO's fit shape (2,1024,1024,6) the VJP's tile pass takes ~9 us, its
// 512 CTAs one wave in lockstep.  With g already in L2 (as after the
// backward that produces it, and in back-to-back timing) the pass is bound
// by instruction issue in the reductions, not by g's 8 MiB (2.5 us at 3.35
// TB/s).  Tried against it on the same card and not kept, each slower
// there: a persistent walk over a strip's column tiles with g prefetched (a
// ring of one-row cp.async.bulk copies, or the next tile's g in registers:
// one or two CTAs per SM leave the reductions' latency exposed); g by
// cp.async into shared memory ahead of the staging (in one wave it only adds
// work); a tensor-core route (G [b 1] and [a 1]^T G by mma.m16n8k8 in
// three TF32 products, g by cp.async into shared memory), slower at D = 6
// and faster only past 16 features, where no path's VJP runs; four lanes
// per output in the second launch.  Tried later, in
// hebo_tpu_torch/bench/vjp_variants.cu (bench/vjp_probe.py times them
// beside this kernel), none faster at (2,1024,1024,6) and (32,1024,1024,6):
// one launch whose last CTA per row strip, column strip and batch entry
// sums the partials (a ticket each; the tail alone costs ~13 us), 8 x 8 or
// 4 x 8 values a thread with the sums through shared memory (64-thread
// CTAs, 8 to 16 warps an SM), g loaded before the distances, this layout
// with the sums through shared memory in place of the shuffles, and this
// kernel at 32- and 16-row tiles (more than one wave).

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 64;      // columns per CTA: 16 threads x 4 adjacent columns
constexpr int kChunk = 16;     // features staged in shared memory at a time
constexpr int kThreads = 256;  // 16 x 16
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 68;       // shared row length: 64 + 4 keeps float4 alignment
constexpr unsigned kFull = 0xffffffffu;
constexpr float kSqrt3 = 1.7320508075688772f;
constexpr float kLog2e = 1.4426950408889634f;

// s = sqrt(3) * sqrt(max(d2, 0) + 1e-16) and exp(-s) on the special
// function unit (sqrt.approx, ex2.approx: within a few ulp), one
// instruction each instead of the IEEE sequences of sqrtf and expf
__device__ __forceinline__ float matern_s(float d2) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(fmaxf(d2, 0.f) + 1e-16f));
  return kSqrt3 * r;
}

__device__ __forceinline__ float exp_neg(float s) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(-kLog2e * s));
  return r;
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

long num_tiles(int B, int N, int M, int rows) {
  return (long)B * ((N + rows - 1) / rows) * ((M + kCols - 1) / kCols);
}

// Rows per CTA tile (16 * RI), the one shape rule of both kernels: the
// largest tile that still gives every SM at least one CTA, else 16 rows.
int pick_rows(int B, int N, int M) {
  for (int rows = 64; rows > 16; rows /= 2)
    if (num_tiles(B, N, M, rows) >= sm_count()) return rows;
  return 16;
}

// Shared-memory staging of one 16-feature chunk of the tile's a-rows and
// b-rows, feature-major.
struct Stage {
  float a[kChunk][kPad];
  float b[kChunk][kPad];
};

// One chunk's a- and b-values of thread t: row (or column) t % R for
// features t / R + j 256 / R, RI of them for a and 4 for b (0 past the chunk
// or the matrix), loaded into registers, then stored to shared memory.
template <int RI>
struct Chunk {
  float a[RI], b[4];
};

template <int RI>
__device__ __forceinline__ void load_chunk(Chunk<RI>& v, const float* ab, const float* bb,
                                           int row0, int col0, int k0, int kc, int N, int M,
                                           int D) {
  constexpr int R = 16 * RI;
  const int r = threadIdx.x % R, c = threadIdx.x % kCols;
#pragma unroll
  for (int j = 0; j < RI; ++j) {
    const int k = threadIdx.x / R + j * (kThreads / R);
    v.a[j] = k < kc && row0 + r < N ? ab[(size_t)(row0 + r) * D + k0 + k] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = threadIdx.x / kCols + j * (kThreads / kCols);
    v.b[j] = k < kc && col0 + c < M ? bb[(size_t)(col0 + c) * D + k0 + k] : 0.f;
  }
}

// The same chunk straight from device memory to shared memory, value by
// value (no registers held: the VJP re-stages later chunks while G is live).
template <int RI>
__device__ __forceinline__ void stage_chunk(Stage& st, const float* ab, const float* bb,
                                            int row0, int col0, int k0, int kc, int N, int M,
                                            int D) {
  constexpr int R = 16 * RI;
  const int r = threadIdx.x % R, c = threadIdx.x % kCols;
  for (int k = threadIdx.x / R; k < kc; k += kThreads / R)
    st.a[k][r] = row0 + r < N ? ab[(size_t)(row0 + r) * D + k0 + k] : 0.f;
  for (int k = threadIdx.x / kCols; k < kc; k += kThreads / kCols)
    st.b[k][c] = col0 + c < M ? bb[(size_t)(col0 + c) * D + k0 + k] : 0.f;
}

template <int RI>
__device__ __forceinline__ void store_chunk(Stage& st, const Chunk<RI>& v, int kc) {
  constexpr int R = 16 * RI;
  const int r = threadIdx.x % R, c = threadIdx.x % kCols;
#pragma unroll
  for (int j = 0; j < RI; ++j) {
    const int k = threadIdx.x / R + j * (kThreads / R);
    if (k < kc) st.a[k][r] = v.a[j];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = threadIdx.x / kCols + j * (kThreads / kCols);
    if (k < kc) st.b[k][c] = v.b[j];
  }
}

// d2[i][j] = |a_r|^2 + |b_c|^2 - 2 a_r.b_c (unclamped) for the thread's rows
// r = row0 + ty + 16 i and columns c = col0 + 4 tx + j.  Each chunk's
// values are all asked for before the first is stored, so a chunk costs one
// load latency.  Leaves the last chunk staged in `st` and ends with a barrier.
template <int RI>
__device__ __forceinline__ void distance_tile(Stage& st, const float* ab, const float* bb,
                                              int row0, int col0, int N, int M, int D,
                                              float (&d2)[RI][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float an[RI], bn[4];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    an[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) d2[i][j] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) bn[j] = 0.f;
  for (int k0 = 0; k0 < D; k0 += kChunk) {
    const int kc = min(kChunk, D - k0);
    Chunk<RI> v;
    load_chunk<RI>(v, ab, bb, row0, col0, k0, kc, N, M, D);
    store_chunk<RI>(st, v, kc);
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kc; ++k) {
      const float4 bv = *reinterpret_cast<const float4*>(&st.b[k][4 * tx]);
      const float bq[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) bn[j] = fmaf(bq[j], bq[j], bn[j]);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float av = st.a[k][ty + 16 * i];
        an[i] = fmaf(av, av, an[i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) d2[i][j] = fmaf(av, bq[j], d2[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) d2[i][j] = an[i] + bn[j] - 2.f * d2[i][j];
}

template <int RI>
__global__ void __launch_bounds__(kThreads)
matern32_gram_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     const float* __restrict__ sc, float jitter,
                     float* __restrict__ out, int N, int M, int D) {
  __shared__ __align__(16) Stage st;
  const int bt = blockIdx.z;
  const int row0 = blockIdx.y * 16 * RI;
  const int col0 = blockIdx.x * kCols;
  float d2[RI][4];
  distance_tile<RI>(st, a + (size_t)bt * N * D, b + (size_t)bt * M * D, row0, col0, N, M, D, d2);

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float scale = sc[bt];
  const int c0 = col0 + 4 * tx;
  float* ob = out + (size_t)bt * N * M;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= N) continue;
    float k[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float s = matern_s(d2[i][j]);
      k[j] = scale * (1.f + s) * exp_neg(s);
      if (r == c0 + j) k[j] += jitter;
    }
    float* orow = ob + (size_t)r * M;
    if ((M & 3) == 0 && c0 + 3 < M) {
      *reinterpret_cast<float4*>(orow + c0) = make_float4(k[0], k[1], k[2], k[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c0 + j < M) orow[c0 + j] = k[j];
    }
  }
}

// Sum v[0..RI) over the 16 lanes that share a thread row (lane bits 0-3).
// Each step sends half of the remaining values to the partner lane and
// keeps the other half, so the lane ends with the full sum of value
// `which`; lanes with tx % (16 / RI) == 0 hold distinct values.
template <int RI>
__device__ __forceinline__ float reduce_row(const float (&v)[RI], int tx, int& which) {
  float w[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) w[i] = v[i];
  which = 0;
  int off = 8;
#pragma unroll
  for (int h = RI / 2; h >= 1; h /= 2, off >>= 1) {
    const bool up = (tx & off) != 0;
#pragma unroll
    for (int q = 0; q < h; ++q) {
      const float send = up ? w[q] : w[q + h];
      const float keep = up ? w[q + h] : w[q];
      w[q] = keep + __shfl_xor_sync(kFull, send, off);
    }
    which += up ? h : 0;
  }
#pragma unroll
  for (; off >= 1; off >>= 1) w[0] += __shfl_xor_sync(kFull, w[0], off);
  return w[0];
}

template <int RI>
__global__ void __launch_bounds__(kThreads)
matern32_vjp_tile(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ sc, const float* __restrict__ g,
                  float* __restrict__ pa, float* __restrict__ pb, float* __restrict__ ps,
                  int N, int M, int D) {
  __shared__ __align__(16) Stage st;
  __shared__ float rowbuf[kChunk][16 * RI];
  __shared__ float colbuf[kWarps][kChunk][kCols];
  __shared__ float wsum[kWarps];
  const int bt = blockIdx.z;
  const int row0 = blockIdx.y * 16 * RI;
  const int col0 = blockIdx.x * kCols;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* ab = a + (size_t)bt * N * D;
  const float* bb = b + (size_t)bt * M * D;
  float d2[RI][4];
  distance_tile<RI>(st, ab, bb, row0, col0, N, M, D, d2);

  // G in registers (0 outside the matrix), its row and column sums, and
  // the thread's share of gsc
  const float scale = sc[bt];
  const int c0 = col0 + 4 * tx;
  const float* gb_ = g + (size_t)bt * N * M;
  float G[RI][4], rs[RI], cs[4] = {0.f, 0.f, 0.f, 0.f};
  float tsc = 0.f;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = row0 + ty + 16 * i;
    float gv[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < N) {
      const float* grow = gb_ + (size_t)r * M;
      if ((M & 3) == 0 && c0 + 3 < M) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(grow + c0));
        gv[0] = v.x; gv[1] = v.y; gv[2] = v.z; gv[3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c0 + j < M) gv[j] = __ldg(grow + c0 + j);
      }
    }
    rs[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float s = matern_s(d2[i][j]);
      const float e = exp_neg(s);
      tsc = fmaf(gv[j], (1.f + s) * e, tsc);
      G[i][j] = d2[i][j] >= 0.f ? -3.f * scale * gv[j] * e : 0.f;
      rs[i] += G[i][j];
      cs[j] += G[i][j];
    }
  }

  // gsc: the tile's sum, warps in order
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) tsc += __shfl_xor_sync(kFull, tsc, off);
  if (lane == 0) wsum[warp] = tsc;

  const int Ct = gridDim.x, Rt = gridDim.y;
  float* pab = pa + ((size_t)bt * Ct + blockIdx.x) * D * N + row0;
  float* pbb = pb + ((size_t)bt * Rt + blockIdx.y) * D * M + col0;
  const bool up16 = lane >= 16;
  for (int k0 = 0; k0 < D; k0 += kChunk) {
    const int kc = min(kChunk, D - k0);
    if (D > kChunk) {  // else distance_tile left the one chunk staged
      __syncthreads();
      stage_chunk<RI>(st, ab, bb, row0, col0, k0, kc, N, M, D);
    }
    __syncthreads();
    for (int k = 0; k < kc; ++k) {
      const float4 bv = *reinterpret_cast<const float4*>(&st.b[k][4 * tx]);
      const float bq[4] = {bv.x, bv.y, bv.z, bv.w};
      float av[RI], p[RI], q[4];
#pragma unroll
      for (int i = 0; i < RI; ++i) av[i] = st.a[k][ty + 16 * i];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        p[i] = av[i] * rs[i];
#pragma unroll
        for (int j = 0; j < 4; ++j) p[i] = fmaf(-G[i][j], bq[j], p[i]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        q[j] = bq[j] * cs[j];
#pragma unroll
        for (int i = 0; i < RI; ++i) q[j] = fmaf(-G[i][j], av[i], q[j]);
      }
      int which;
      const float pr = reduce_row<RI>(p, tx, which);
      if (tx % (16 / RI) == 0) rowbuf[k][ty + 16 * which] = pr;
      // columns: the two thread rows of this warp, then the warps below
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float send = up16 ? q[h] : q[h + 2];
        const float keep = up16 ? q[h + 2] : q[h];
        colbuf[warp][k][4 * tx + h + (up16 ? 2 : 0)] = keep + __shfl_xor_sync(kFull, send, 16);
      }
    }
    __syncthreads();
    const int r = threadIdx.x % (16 * RI), c = threadIdx.x % kCols;
    if (row0 + r < N)
      for (int k = threadIdx.x / (16 * RI); k < kc; k += kThreads / (16 * RI))
        pab[(size_t)(k0 + k) * N + r] = rowbuf[k][r];
    if (col0 + c < M)
      for (int k = threadIdx.x / kCols; k < kc; k += kThreads / kCols) {
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) v += colbuf[w][k][c];
        pbb[(size_t)(k0 + k) * M + c] = v;
      }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += wsum[w];
    ps[(size_t)bt * Rt * Ct + blockIdx.y * Ct + blockIdx.x] = v;
  }
}

// Second launch: ga, gb from the per-tile partials in tile order, one
// thread per output element in (batch, feature, row) order, so a warp reads
// each tile's partials in one piece.  The last block's warps sum gsc, warp
// w for the batch entries w, w + 8, ...: strided lane sums, then a fixed
// tree.
__global__ void __launch_bounds__(kThreads)
matern32_vjp_reduce(const float* __restrict__ pa, const float* __restrict__ pb,
                    const float* __restrict__ ps, float* __restrict__ ga,
                    float* __restrict__ gb, float* __restrict__ gsc,
                    int B, int N, int M, int D, int Rt, int Ct) {
  if (blockIdx.x == gridDim.x - 1) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int bt = warp; bt < B; bt += kWarps) {
      float v = 0.f;
#pragma unroll 8
      for (int t = lane; t < Rt * Ct; t += 32) v += ps[(size_t)bt * Rt * Ct + t];
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
      if (lane == 0) gsc[bt] = v;
    }
    return;
  }
  const unsigned na = (unsigned)B * D * N, nb = (unsigned)B * D * M;
  unsigned e = blockIdx.x * kThreads + threadIdx.x;
  const float* p;
  float* out;
  unsigned T, L;
  if (e < na) {
    p = pa; out = ga; T = Ct; L = N;
  } else if (e < na + nb) {
    e -= na; p = pb; out = gb; T = Rt; L = M;
  } else {
    return;
  }
  const unsigned per = D * L;
  const unsigned bt = e / per, rest = e - bt * per;  // rest = k * L + i
  const unsigned k = rest / L, i = rest - k * L;
  p += (size_t)bt * T * per + rest;
  float v = 0.f;
#pragma unroll 8
  for (unsigned t = 0; t < T; ++t) v += p[(size_t)t * per];
  out[((size_t)bt * L + i) * D + k] = v;
}

}  // namespace

// a (B,N,D), b (B,M,D), sc (B,), out (B,N,M); all float32, contiguous, on
// the device.  Launches on `stream` and returns cudaGetLastError().
extern "C" int hebo_matern32_gram(const float* a, const float* b,
                                  const float* sc, float jitter, float* out,
                                  int B, int N, int M, int D, void* stream) {
  if (B == 0 || N == 0 || M == 0) return 0;
  const int rows = pick_rows(B, N, M);
  dim3 grid((M + kCols - 1) / kCols, (N + rows - 1) / rows, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (rows == 64)
    matern32_gram_kernel<4><<<grid, kThreads, 0, s>>>(a, b, sc, jitter, out, N, M, D);
  else if (rows == 32)
    matern32_gram_kernel<2><<<grid, kThreads, 0, s>>>(a, b, sc, jitter, out, N, M, D);
  else
    matern32_gram_kernel<1><<<grid, kThreads, 0, s>>>(a, b, sc, jitter, out, N, M, D);
  return (int)cudaGetLastError();
}

// Rows per CTA tile (64, 32 or 16) that both kernels take at this shape.
extern "C" int hebo_matern32_gram_rows(int B, int N, int M) { return pick_rows(B, N, M); }

// VJP of hebo_matern32_gram (without jitter, which has no gradient) against
// g (B,N,M): ga (B,N,D), gb (B,M,D), gsc (B,).  `scratch` holds
// B*Ct*N*D + B*Rt*M*D + B*Rt*Ct floats, Ct = ceil(M/64) and
// Rt = ceil(N/rows) with rows = hebo_matern32_gram_rows(B, N, M).  Two
// launches on `stream`; returns cudaGetLastError().
extern "C" int hebo_matern32_gram_vjp(const float* a, const float* b, const float* sc,
                                      const float* g, float* scratch, float* ga, float* gb,
                                      float* gsc, int B, int N, int M, int D, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (N == 0 || M == 0) {  // an empty Gram: every gradient is 0
    cudaMemsetAsync(ga, 0, sizeof(float) * B * N * D, s);
    cudaMemsetAsync(gb, 0, sizeof(float) * B * M * D, s);
    cudaMemsetAsync(gsc, 0, sizeof(float) * B, s);
    return (int)cudaGetLastError();
  }
  const int rows = pick_rows(B, N, M);
  const int Ct = (M + kCols - 1) / kCols, Rt = (N + rows - 1) / rows;
  float* pa = scratch;
  float* pb = pa + (size_t)B * Ct * N * D;
  float* ps = pb + (size_t)B * Rt * M * D;
  dim3 grid(Ct, Rt, B);
  if (rows == 64)
    matern32_vjp_tile<4><<<grid, kThreads, 0, s>>>(a, b, sc, g, pa, pb, ps, N, M, D);
  else if (rows == 32)
    matern32_vjp_tile<2><<<grid, kThreads, 0, s>>>(a, b, sc, g, pa, pb, ps, N, M, D);
  else
    matern32_vjp_tile<1><<<grid, kThreads, 0, s>>>(a, b, sc, g, pa, pb, ps, N, M, D);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  const long outs = (long)B * N * D + (long)B * M * D;
  const int blocks = (int)((outs + kThreads - 1) / kThreads) + 1;
  matern32_vjp_reduce<<<blocks, kThreads, 0, s>>>(pa, pb, ps, ga, gb, gsc, B, N, M, D, Rt, Ct);
  return (int)cudaGetLastError();
}
