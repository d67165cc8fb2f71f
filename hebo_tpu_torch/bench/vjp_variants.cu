// Variants of K2's VJP tried against the port's kernel (csrc/gram.cu) on
// an H100 80GB HBM3 at 700 W, none faster there (PERF.md §6): built and timed by
// bench/vjp_probe.py, never by the port.  This file includes the port's
// gram.cu, so the variants share its helpers and its reduce kernel.
//   1, 2  matern32_vjp_fused<8 or 4, true>: one launch; 64 threads a
//         (64 or 32)-row x 64-column tile, 8 x 8 or 4 x 8 values a thread, g
//         loaded first, row and column sums through shared memory, and the
//         last CTA of each row strip, column strip and batch entry (integer
//         tickets) sums the partials in tile order;
//   3, 4  the same tile pass, then matern32_vjp_reduce (two launches);
//   5     matern32_vjp_tile with g loaded before the distances;
//   6     matern32_vjp_tile with the row and column sums through shared
//         memory (four features at a time) in place of shuffles;
//   7, 8  the port's kernels themselves at 32- and 16-row tiles (more CTAs
//         than one wave, so one CTA's loads can overlap another's sums).

#include "../csrc/gram.cu"

namespace {

template <int RI, bool kGFirst, bool kSmemRed>
__global__ void __launch_bounds__(kThreads)
matern32_vjp_tile_v(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ sc, const float* __restrict__ g,
                  float* __restrict__ pa, float* __restrict__ pb, float* __restrict__ ps,
                  int N, int M, int D) {
  __shared__ __align__(16) Stage st;
  __shared__ float rowbuf[kSmemRed ? 1 : kChunk][16 * RI];
  __shared__ float colbuf[kSmemRed ? 1 : kWarps][kSmemRed ? 1 : kChunk][kCols];
  __shared__ float pq_a[kSmemRed ? 4 : 1][kSmemRed ? 16 * RI : 1][17];  // [k][row][tx]
  __shared__ float pq_b[kSmemRed ? 4 : 1][kSmemRed ? kCols : 1][17];    // [k][column][ty]
  __shared__ float wsum[kWarps];
  const int bt = blockIdx.z;
  const int row0 = blockIdx.y * 16 * RI;
  const int col0 = blockIdx.x * kCols;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* ab = a + (size_t)bt * N * D;
  const float* bb = b + (size_t)bt * M * D;
  float d2[RI][4];
  const int c0 = col0 + 4 * tx;
  const float* gb_ = g + (size_t)bt * N * M;
  float gvs[RI][4];
  auto load_g = [&]() {
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = row0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) gvs[i][j] = 0.f;
      if (r < N) {
        const float* grow = gb_ + (size_t)r * M;
        if ((M & 3) == 0 && c0 + 3 < M) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(grow + c0));
          gvs[i][0] = v.x; gvs[i][1] = v.y; gvs[i][2] = v.z; gvs[i][3] = v.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (c0 + j < M) gvs[i][j] = __ldg(grow + c0 + j);
        }
      }
    }
  };
  if (kGFirst) load_g();
  distance_tile<RI>(st, ab, bb, row0, col0, N, M, D, d2);
  if (!kGFirst) load_g();

  // G in registers (0 outside the matrix), its row and column sums, and
  // the thread's share of gsc
  const float scale = sc[bt];
  float G[RI][4], rs[RI], cs[4] = {0.f, 0.f, 0.f, 0.f};
  float tsc = 0.f;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const float* gv = gvs[i];
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
    if constexpr (kSmemRed) {
      // the products to shared memory, four features at a time, then one
      // thread a sum over the 16 lanes (rows) or thread rows (columns)
      for (int k1 = 0; k1 < kc; k1 += 4) {
        const int kq = min(4, kc - k1);
        for (int kk = 0; kk < kq; ++kk) {
          const int k = k1 + kk;
          const float4 bv = *reinterpret_cast<const float4*>(&st.b[k][4 * tx]);
          const float bq[4] = {bv.x, bv.y, bv.z, bv.w};
          float av[RI];
#pragma unroll
          for (int i = 0; i < RI; ++i) av[i] = st.a[k][ty + 16 * i];
#pragma unroll
          for (int i = 0; i < RI; ++i) {
            float pv = av[i] * rs[i];
#pragma unroll
            for (int j = 0; j < 4; ++j) pv = fmaf(-G[i][j], bq[j], pv);
            pq_a[kk][ty + 16 * i][tx] = pv;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float qv = bq[j] * cs[j];
#pragma unroll
            for (int i = 0; i < RI; ++i) qv = fmaf(-G[i][j], av[i], qv);
            pq_b[kk][4 * tx + j][ty] = qv;
          }
        }
        __syncthreads();
        for (int o = threadIdx.x; o < kq * (16 * RI + kCols); o += kThreads) {
          if (o < kq * 16 * RI) {
            const int kk = o / (16 * RI), r = o - kk * 16 * RI;
            if (row0 + r >= N) continue;
            float v = 0.f;
#pragma unroll
            for (int t = 0; t < 16; ++t) v += pq_a[kk][r][t];
            pab[(size_t)(k0 + k1 + kk) * N + r] = v;
          } else {
            const int o2 = o - kq * 16 * RI, kk = o2 / kCols, c = o2 - kk * kCols;
            if (col0 + c >= M) continue;
            float v = 0.f;
#pragma unroll
            for (int t = 0; t < 16; ++t) v += pq_b[kk][c][t];
            pbb[(size_t)(k0 + k1 + kk) * M + c] = v;
          }
        }
        __syncthreads();
      }
      continue;
    }
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

// Variants 1-4: one launch (kTail) or the tile pass alone.  A CTA of 64 threads (8 x 8) takes a
// (8 TM)-row x 64-column tile, each thread TM rows (ty + 8i) and 8 columns
// (4tx + 32j + u, so that a row's g comes in two 16-byte loads), with g
// asked for before the a- and b-rows are staged, so its latency overlaps
// the staging and the distances.  Row and column sums of the thread's
// products go through shared memory (one store a value, then eight loads a
// sum), not shuffles.  The tile's partials go to device memory as in
// matern32_vjp_tile; then each CTA takes a ticket from its row strip's,
// its column strip's and its batch entry's counters, and the last CTA of
// each sums that strip's (or entry's) partials in tile order and resets the
// counter: the same bits from call to call, no second launch.  The
// counters start at 0 and are left at 0; calls that share them must not
// overlap (one stream a device).  D <= kFusedD.
constexpr int kFusedD = 8;
constexpr int kFusedThreads = 64;

template <int TM, bool kTail>
__global__ void __launch_bounds__(kFusedThreads)
matern32_vjp_fused(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ sc, const float* __restrict__ g,
                   float* __restrict__ pa, float* __restrict__ pb, float* __restrict__ ps,
                   float* __restrict__ ga, float* __restrict__ gb, float* __restrict__ gsc,
                   int* __restrict__ counters, int N, int M, int D) {
  constexpr int R = 8 * TM;
  __shared__ __align__(16) float sa[kFusedD][R];
  __shared__ __align__(16) float sbv[kFusedD][kCols];
  __shared__ __align__(16) float red_a[kFusedD][R][8];  // a row's products by tx
  __shared__ float red_b[kFusedD][kCols][9];             // a column's by ty (9: no conflicts)
  __shared__ float wsum[2];
  __shared__ int last[3];
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3, lane = tid & 31;
  const int bt = blockIdx.z, row0 = blockIdx.y * R, col0 = blockIdx.x * kCols;
  const int Ct = gridDim.x, Rt = gridDim.y;
  const float* ab = a + (size_t)bt * N * D;
  const float* bb = b + (size_t)bt * M * D;

  // g first: two 16-byte loads a row where they fit
  float G[TM][8];
  const float* gt = g + (size_t)bt * N * M;
  const bool vec = (M & 3) == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + 8 * i;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = col0 + 4 * tx + 32 * j;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < N) {
        const float* gr = gt + (size_t)r * M + c;
        if (vec && c + 3 < M) {
          v = __ldg(reinterpret_cast<const float4*>(gr));
        } else {
          v.x = c < M ? __ldg(gr) : 0.f;
          v.y = c + 1 < M ? __ldg(gr + 1) : 0.f;
          v.z = c + 2 < M ? __ldg(gr + 2) : 0.f;
          v.w = c + 3 < M ? __ldg(gr + 3) : 0.f;
        }
      }
      G[i][4 * j] = v.x, G[i][4 * j + 1] = v.y, G[i][4 * j + 2] = v.z, G[i][4 * j + 3] = v.w;
    }
  }
  // the tile's a- and b-rows, feature-major (0 past the matrix)
  for (int e = tid; e < R * D; e += kFusedThreads) {
    const int r = e / D, k = e - r * D;
    sa[k][r] = row0 + r < N ? ab[(size_t)(row0 + r) * D + k] : 0.f;
  }
  for (int e = tid; e < kCols * D; e += kFusedThreads) {
    const int c = e / D, k = e - c * D;
    sbv[k][c] = col0 + c < M ? bb[(size_t)(col0 + c) * D + k] : 0.f;
  }
  __syncthreads();

  auto load_b = [&](int k, float (&bq)[8]) {
    const float4 u = *reinterpret_cast<const float4*>(&sbv[k][4 * tx]);
    const float4 v = *reinterpret_cast<const float4*>(&sbv[k][32 + 4 * tx]);
    bq[0] = u.x, bq[1] = u.y, bq[2] = u.z, bq[3] = u.w;
    bq[4] = v.x, bq[5] = v.y, bq[6] = v.z, bq[7] = v.w;
  };
  float d2[TM][8], an[TM], bn[8];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    an[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) d2[i][c] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) bn[c] = 0.f;
#pragma unroll 2
  for (int k = 0; k < D; ++k) {
    float bq[8];
    load_b(k, bq);
#pragma unroll
    for (int c = 0; c < 8; ++c) bn[c] = fmaf(bq[c], bq[c], bn[c]);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float av = sa[k][ty + 8 * i];
      an[i] = fmaf(av, av, an[i]);
#pragma unroll
      for (int c = 0; c < 8; ++c) d2[i][c] = fmaf(av, bq[c], d2[i][c]);
    }
  }
  // G = -3 sc g e^{-s} [d2 >= 0], its row and column sums, gsc's terms
  const float scale = sc[bt];
  float rs[TM], cs[8], tsc = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) cs[c] = 0.f;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    rs[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float dd = an[i] + bn[c] - 2.f * d2[i][c];
      const float s = matern_s(dd), e = exp_neg(s), gv = G[i][c];
      tsc = fmaf(gv, (1.f + s) * e, tsc);
      G[i][c] = dd >= 0.f ? -3.f * scale * gv * e : 0.f;
      rs[i] += G[i][c];
      cs[c] += G[i][c];
    }
  }
  // per feature: the thread's row products a_i rs_i - sum_c G b_c and
  // column products b_c cs_c - sum_i G a_i, to shared memory
#pragma unroll 2
  for (int k = 0; k < D; ++k) {
    float bq[8], av[TM];
    load_b(k, bq);
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = sa[k][ty + 8 * i];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float p = av[i] * rs[i];
#pragma unroll
      for (int c = 0; c < 8; ++c) p = fmaf(-G[i][c], bq[c], p);
      red_a[k][ty + 8 * i][tx] = p;
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float q = bq[c] * cs[c];
#pragma unroll
      for (int i = 0; i < TM; ++i) q = fmaf(-G[i][c], av[i], q);
      red_b[k][4 * tx + 32 * (c >> 2) + (c & 3)][ty] = q;
    }
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) tsc += __shfl_xor_sync(kFull, tsc, off);
  if (lane == 0) wsum[tid >> 5] = tsc;
  __syncthreads();

  // the tile's partials: row t (ga), column t (gb), the tile's gsc
  float* pab = pa + ((size_t)bt * Ct + blockIdx.x) * D * N + row0;
  float* pbb = pb + ((size_t)bt * Rt + blockIdx.y) * D * M + col0;
  for (int r = tid; r < R; r += kFusedThreads)
    if (row0 + r < N)
      for (int k = 0; k < D; ++k) {
        const float4 u = *reinterpret_cast<const float4*>(&red_a[k][r][0]);
        const float4 v = *reinterpret_cast<const float4*>(&red_a[k][r][4]);
        pab[(size_t)k * N + r] = ((u.x + u.y) + (u.z + u.w)) + ((v.x + v.y) + (v.z + v.w));
      }
  if (col0 + tid < M)
    for (int k = 0; k < D; ++k) {
      float v = 0.f;
#pragma unroll
      for (int t = 0; t < 8; ++t) v += red_b[k][tid][t];
      pbb[(size_t)k * M + tid] = v;
    }
  if (tid == 0) ps[((size_t)bt * Rt + blockIdx.y) * Ct + blockIdx.x] = wsum[0] + wsum[1];

  if (!kTail) return;
  // tickets: the last CTA of a row strip, a column strip, a batch entry
  int* cnt_row = counters + (size_t)bt * Rt + blockIdx.y;
  int* cnt_col = counters + (size_t)gridDim.z * Rt + (size_t)bt * Ct + blockIdx.x;
  int* cnt_b = counters + (size_t)gridDim.z * (Rt + Ct) + bt;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last[0] = atomicAdd(cnt_row, 1) == Ct - 1;
    last[1] = atomicAdd(cnt_col, 1) == Rt - 1;
    last[2] = atomicAdd(cnt_b, 1) == Rt * Ct - 1;
  }
  __syncthreads();
  if (!(last[0] | last[1] | last[2])) return;
  __threadfence();
  if (last[0]) {  // ga for the strip's rows: the Ct column tiles' partials in order
    const float* p0 = pa + (size_t)bt * Ct * D * N + row0;
    for (int e = tid; e < R * D; e += kFusedThreads) {
      const int k = e / R, r = e - k * R;
      if (row0 + r >= N) continue;
      float v = 0.f;
#pragma unroll 4
      for (int t = 0; t < Ct; ++t) v += __ldcg(p0 + ((size_t)t * D + k) * N + r);
      ga[((size_t)bt * N + row0 + r) * D + k] = v;
    }
    if (tid == 0) *cnt_row = 0;
  }
  if (last[1]) {  // gb for the strip's columns: the Rt row tiles' partials in order
    const float* p0 = pb + (size_t)bt * Rt * D * M + col0;
    for (int e = tid; e < kCols * D; e += kFusedThreads) {
      const int k = e / kCols, c = e - k * kCols;
      if (col0 + c >= M) continue;
      float v = 0.f;
#pragma unroll 4
      for (int t = 0; t < Rt; ++t) v += __ldcg(p0 + ((size_t)t * D + k) * M + c);
      gb[((size_t)bt * M + col0 + c) * D + k] = v;
    }
    if (tid == 0) *cnt_col = 0;
  }
  if (last[2] && tid < 32) {  // gsc: strided lane sums, then a fixed tree
    const float* p0 = ps + (size_t)bt * Rt * Ct;
    float v = 0.f;
    for (int t = tid; t < Rt * Ct; t += 32) v += __ldcg(p0 + t);
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
    if (tid == 0) gsc[bt] = v, *cnt_b = 0;
  }
}


int variant_rows(int B, int N, int M, int v) {
  return v == 1 || v == 3 ? 64 : v == 2 || v == 4 || v == 7 ? 32 : v == 8 ? 16 : pick_rows(B, N, M);
}

}  // namespace

// Floats of scratch variant v takes: as hebo_matern32_gram_vjp's at its tile.
extern "C" long long vjp_variant_scratch(int B, int N, int M, int D, int v) {
  const long long rows = variant_rows(B, N, M, v);
  const long long Ct = (M + kCols - 1) / kCols, Rt = (N + rows - 1) / rows;
  return (long long)B * (Ct * N * D + Rt * M * D + Rt * Ct);
}

// Zeroed ints variants 1 and 2 take as tickets (and leave zeroed).
extern "C" long long vjp_variant_counters(int B, int N, int M, int v) {
  const long long rows = variant_rows(B, N, M, v);
  return (long long)B * ((N + rows - 1) / rows + (M + kCols - 1) / kCols + 1);
}

// Variant v (1-8) of hebo_matern32_gram_vjp; D <= kFusedD for 1-4.
extern "C" int vjp_variant(int v, const float* a, const float* b, const float* sc, const float* g,
                           float* scratch, int* counters, float* ga, float* gb, float* gsc, int B,
                           int N, int M, int D, void* stream) {
  if (v < 1 || v > 8 || (v <= 4 && D > kFusedD) || B == 0 || N == 0 || M == 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int rows = variant_rows(B, N, M, v);
  const int Ct = (M + kCols - 1) / kCols, Rt = (N + rows - 1) / rows;
  float* pa = scratch;
  float* pb = pa + (size_t)B * Ct * N * D;
  float* ps = pb + (size_t)B * Rt * M * D;
  const dim3 grid(Ct, Rt, B);
  if (v <= 4) {
    auto k = v == 1 ? matern32_vjp_fused<8, true> : v == 2 ? matern32_vjp_fused<4, true>
           : v == 3 ? matern32_vjp_fused<8, false> : matern32_vjp_fused<4, false>;
    k<<<grid, kFusedThreads, 0, s>>>(a, b, sc, g, pa, pb, ps, ga, gb, gsc, counters, N, M, D);
    if (v <= 2) return (int)cudaGetLastError();
  } else if (v >= 7) {
    auto k = rows == 32 ? matern32_vjp_tile<2> : matern32_vjp_tile<1>;
    k<<<grid, kThreads, 0, s>>>(a, b, sc, g, pa, pb, ps, N, M, D);
  } else {
    const bool first = v == 5;
    auto k = rows == 64 ? (first ? matern32_vjp_tile_v<4, true, false>
                                 : matern32_vjp_tile_v<4, false, true>)
           : rows == 32 ? (first ? matern32_vjp_tile_v<2, true, false>
                                 : matern32_vjp_tile_v<2, false, true>)
                        : (first ? matern32_vjp_tile_v<1, true, false>
                                 : matern32_vjp_tile_v<1, false, true>);
    k<<<grid, kThreads, 0, s>>>(a, b, sc, g, pa, pb, ps, N, M, D);
  }
  const int err = (int)cudaGetLastError();
  if (err) return err;
  const long outs = (long)B * N * D + (long)B * M * D;
  matern32_vjp_reduce<<<(int)((outs + kThreads - 1) / kThreads) + 1, kThreads, 0, s>>>(
      pa, pb, ps, ga, gb, gsc, B, N, M, D, Rt, Ct);
  return (int)cudaGetLastError();
}
