// K3xl: K3's strided x pass above 16384 in one HBM pass, a column FFT
// over a cluster of 8 blocks whose M-point line DFTs are register row
// FFTs (rows_fft.cuh) instead of the line kernels' Stockham passes.
//
// Replaces pfb_tpu/ops/pallas_cfft.py:fftx_c2c (Pallas _kx_kernel) along
// axis -2 of a (P, Nin, L) float32 re/im stack, L > 1, at N = 8 M with M
// = 256 R2 for R2 = 9, 10, 12, 15, 16 (N = 18432, 20480, 24576, 30720,
// 32768: the PSF grids of the 128-aligned images 4608^2, 5120^2, 6144^2,
// 7680^2 and 8192^2; ops/cfft.py:cols_long_route), with in_rolled /
// out_rolled as cfft.cu absorbs them. The earlier route, K3f
// (cfft_four.cu) and then the cluster column kernel (cfft_cols.cu) at M
// on 8 L columns, read and wrote the stack twice through a full-size
// intermediate; the cluster column kernel's Stockham passes
// (fft_lines.cuh:block_fft) took most of its time there (its skeleton,
// with the passes compiled out, against the whole kernel at (1, 2304,
// 147456): scripts/torch_kernel_lab.py --long, PERF.md). A cluster of 8
// blocks takes a tile of W adjacent columns of one plane, as the cluster
// column kernel does:
//   1. block c loads rows n = c + 8 m (m < M) of the tile with 16-byte
//      loads into W lines of M in shared memory; in_rolled reads element
//      i < N/2 at n = (i - N/4) mod N and writes zeros in the other rows;
//   2. the M-point DFT of each line, K3r's three register stages (16 x
//      R2 x 16) between the line in shared memory and registers: stage 1
//      reads its butterflies from the line (all reads before the first
//      in-place write), stage 2 transposes through the same buffer, and
//      stage 3 writes each butterfly's outputs Y_c[k1] back over its own
//      inputs;
//   3. after cluster.sync(), block c' takes k1 in its eighth of M, reads
//      Y_c[k1] of every block through distributed shared memory,
//      multiplies by W_N^(c k1) (a float64 table rounded once) and
//      finishes with the 8-point DFT in registers, X[k1 + M k2] = sum_c
//      W_8^(c k2) W_N^(c k1) Y_c[k1]; a thread holds four adjacent
//      columns and writes each output row with one 16-byte store of re
//      and one of im (out_rolled: only the kept rows);
//   4. a last cluster.sync() keeps each block's shared memory alive until
//      its peers have read it.
// What bounds it on the H100: bytes, 8 P L (Nin + Nout). W = 8 columns
// (a full 32-byte sector of re and of im a row) where the block's 8 lines
// of M + M/16 float2 fit its shared memory (M <= 3072: 157-209 KB), else
// 4; 512 threads with registers for one block an SM.
#include <cooperative_groups.h>

#include "rows_fft.cuh"

namespace cg = cooperative_groups;

namespace pfbt {

constexpr int kXlC = 8;        // blocks a cluster
constexpr int kXlT = 512;      // threads a block
constexpr int kXlChunk = 4;    // adjacent columns a thread loads and stores
constexpr int kXlU = 8;        // load units a thread issues before storing

__host__ __device__ constexpr int xl_width(int M) {
  return M <= 3072 ? 8 : 4;
}

// One cluster of 8 blocks per tile of W columns of one plane; M = 16 R2
// 16; TW the length-M rows plan's table, TN W_N^e for e < N.
template <int M, int R2>
__global__ void __launch_bounds__(kXlT, 1)
cols_long_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                 float* __restrict__ yr, float* __restrict__ yi, int L,
                 int in_rolled, int out_rolled, int inv, int vec,
                 const float2* __restrict__ TW,
                 const float2* __restrict__ TN) {
  constexpr int W = xl_width(M);
  constexpr int N = kXlC * M;
  constexpr int NB = M / 16;          // stage-1 and stage-3 butterflies
  constexpr int NF = W * NB;          // of the block's W lines
  constexpr int B = (NF + kXlT - 1) / kXlT;
  constexpr int G = W / kXlChunk;     // column groups of a tile
  constexpr int LP = M + M / 16;      // a padded line (rpad)
  static_assert(16 * R2 * 16 == M, "M = 16 R2 16");
  extern __shared__ float2 sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();
  const int t = threadIdx.x;
  const bool iv = inv != 0;
  const int Nin = in_rolled ? N / 2 : N, Nout = out_rolled ? N / 2 : N;
  const int ntile = (L + W - 1) / W;
  const int tile = blockIdx.x / kXlC;
  const int b = tile / ntile;
  const int j0 = (tile - b * ntile) * W;
  const float* xrb = xr + (long)b * Nin * L;
  const float* xib = xi ? xi + (long)b * Nin * L : nullptr;

  // 1. rows n = c + 8 m of the tile into lines s = 0..W-1 of M; lanes
  // 0-15 of a warp on 16 consecutive m of one column group
  constexpr int units = M / 16 * G * 16;
  for (int u0 = 0; u0 < units; u0 += kXlU * kXlT) {
    float re[kXlU][kXlChunk], im[kXlU][kXlChunk];
    int slot[kXlU];
#pragma unroll
    for (int h = 0; h < kXlU; ++h) {
      const int u = u0 + h * kXlT + t;
      const int q = u >> 4;
      const int g = q % G, m = (q / G) * 16 + (u & 15);
      const int j = j0 + kXlChunk * g;
      int i = c + kXlC * m;
      if (in_rolled) i = (i + N / 4) % N;  // element i sits at n
      slot[h] = u < units ? kXlChunk * g * LP + rpad(m) : -1;
#pragma unroll
      for (int e = 0; e < kXlChunk; ++e) re[h][e] = im[h][e] = 0.f;
      if (slot[h] < 0 || i >= Nin || j >= L) continue;
      const long a = (long)i * L + j;
      if (vec) {
        const float4 r4 = __ldg(reinterpret_cast<const float4*>(xrb + a));
        re[h][0] = r4.x; re[h][1] = r4.y; re[h][2] = r4.z; re[h][3] = r4.w;
        if (xib) {
          const float4 i4 = __ldg(reinterpret_cast<const float4*>(xib + a));
          im[h][0] = i4.x; im[h][1] = i4.y; im[h][2] = i4.z;
          im[h][3] = i4.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < kXlChunk; ++e)
          if (j + e < L) {
            re[h][e] = xrb[a + e];
            if (xib) im[h][e] = xib[a + e];
          }
      }
    }
#pragma unroll
    for (int h = 0; h < kXlU; ++h)
      if (slot[h] >= 0) {
#pragma unroll
        for (int e = 0; e < kXlChunk; ++e)
          sm[slot[h] + e * LP] = make_float2(re[h][e], im[h][e]);
      }
  }
  __syncthreads();

  // 2. the M-point DFT of each line: stage 1 (radix 16) from the line,
  // stage 2 (radix R2), stage 3 (radix 16) back over its inputs
  float2 v[B][16];
#pragma unroll
  for (int bb = 0; bb < B; ++bb) {
    const int f = t + bb * kXlT;
    if (NF % kXlT && f >= NF) continue;
    const int s = f / NB, j = f - s * NB;
#pragma unroll
    for (int q = 0; q < 16; ++q) v[bb][q] = sm[s * LP + rpad(j + q * NB)];
  }
  __syncthreads();  // every read of stage 1 before its in-place writes
#pragma unroll
  for (int bb = 0; bb < B; ++bb) {
    const int f = t + bb * kXlT;
    if (NF % kXlT && f >= NF) continue;
    const int s = f / NB, j = f - s * NB;
    small_dft<16>(v[bb], iv);
#pragma unroll
    for (int q = 0; q < 16; ++q) sm[rpad(s * M + 16 * j + q)] = v[bb][q];
  }
  __syncthreads();
  rows_mid<R2, kXlT, W, true>(sm, TW, iv);
  __syncthreads();
#pragma unroll
  for (int bb = 0; bb < B; ++bb) {
    const int f = t + bb * kXlT;
    if (NF % kXlT && f >= NF) continue;
    const int s = f / NB, j = f - s * NB;
    float2* line = sm + s * LP;
    rows_last_load<M, R2, true>(line, TW, j, iv, v[bb]);
    small_dft<16>(v[bb], iv);
#pragma unroll
    for (int q = 0; q < 16; ++q) line[rpad(j + q * NB)] = v[bb][q];
  }
  cluster.sync();

  // 3. block c' finishes k1 in [c' Mc, (c' + 1) Mc) for every column
  const float2* src[kXlC];
#pragma unroll
  for (int r = 0; r < kXlC; ++r) src[r] = cluster.map_shared_rank(sm, r);
  constexpr int Mc = M / kXlC;
  constexpr int pairs = (Mc + 15) / 16 * G * 16;
  const float sg = iv ? -1.f : 1.f;
  for (int u = t; u < pairs; u += kXlT) {
    const int q = u >> 4;
    const int g = q % G, kl = (q / G) * 16 + (u & 15);
    const int k1 = c * Mc + kl;
    const int j = j0 + kXlChunk * g;
    if (kl >= Mc || j >= L) continue;
    float2 w[kXlC][kXlChunk];
#pragma unroll
    for (int r = 0; r < kXlC; ++r) {
      float2 tw = make_float2(1.f, 0.f);
      if (r > 0) {
        const float2 e = __ldg(&TN[r * k1]);
        tw = make_float2(e.x, sg * e.y);
      }
#pragma unroll
      for (int e = 0; e < kXlChunk; ++e) {
        const float2 y = src[r][(kXlChunk * g + e) * LP + rpad(k1)];
        w[r][e] = r > 0 ? cmul(y, tw) : y;
      }
    }
    float2 v8[kXlChunk][kXlC];
#pragma unroll
    for (int e = 0; e < kXlChunk; ++e) {
#pragma unroll
      for (int r = 0; r < kXlC; ++r) v8[e][r] = w[r][e];
      small_dft<kXlC>(v8[e], iv);
    }
#pragma unroll
    for (int k2 = 0; k2 < kXlC; ++k2) {
      int r = k1 + M * k2;
      if (out_rolled) {
        r = (r + N / 4) % N;  // X[k] goes to row (k + N/4) mod N
        if (r >= N / 2) continue;
      }
      const long a = ((long)b * Nout + r) * L + j;
      if (vec) {
        *reinterpret_cast<float4*>(yr + a) = make_float4(
            v8[0][k2].x, v8[1][k2].x, v8[2][k2].x, v8[3][k2].x);
        *reinterpret_cast<float4*>(yi + a) = make_float4(
            v8[0][k2].y, v8[1][k2].y, v8[2][k2].y, v8[3][k2].y);
      } else {
#pragma unroll
        for (int e = 0; e < kXlChunk; ++e)
          if (j + e < L) {
            yr[a + e] = v8[e][k2].x;
            yi[a + e] = v8[e][k2].y;
          }
      }
    }
  }
  // 4. no block leaves while a peer may still read its shared memory
  cluster.sync();
}

template <int M, int R2>
static cudaError_t launch_cols_long(const float* xr, const float* xi,
                                    float* yr, float* yi, int B, int L,
                                    int in_rolled, int out_rolled, int inv,
                                    int vec, const float2* TW,
                                    const float2* TN, cudaStream_t stream) {
  constexpr int W = xl_width(M);
  return launch_cluster(cols_long_kernel<M, R2>, kXlC,
                        (long)B * ((L + W - 1) / W) * kXlC, kXlT,
                        (size_t)W * (M + M / 16) * sizeof(float2), stream,
                        xr, xi, yr, yi, L, in_rolled, out_rolled, inv, vec,
                        TW, TN);
}

}  // namespace pfbt

// The x pass of a (B, Nin, L) stack at N = 8 M, M = 256 R2 for R2 = 9,
// 10, 12, 15, 16 (Nin = N, or N/2 when in_rolled; Nout likewise); TW is
// the length-M rows plan's table (pfbt_rows_twiddles), TN W_N^e for e < N
// (pfbt_cols_twiddles at N).
extern "C" int pfbt_cfft_cols_long(const float* xr, const float* xi,
                                   float* yr, float* yi, int B, int L,
                                   int N, int in_rolled, int out_rolled,
                                   int inverse, const void* TW,
                                   const void* TN, void* stream) {
  if (B < 1 || L < 1 || !xr || !yr || !yi || !TW || !TN)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = L % pfbt::kXlChunk == 0 && pfbt::aligned16(xr) &&
                  pfbt::aligned16(xi) && pfbt::aligned16(yr) &&
                  pfbt::aligned16(yi);
  const float2* tw = static_cast<const float2*>(TW);
  const float2* tn = static_cast<const float2*>(TN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PFBT_COLS_LONG(n, r2)                                              \
  case n:                                                                  \
    return static_cast<int>(pfbt::launch_cols_long<n / 8, r2>(             \
        xr, xi, yr, yi, B, L, in_rolled, out_rolled, inverse, vec, tw, tn, \
        s));
  switch (N) {
    PFBT_COLS_LONG(18432, 9)
    PFBT_COLS_LONG(20480, 10)
    PFBT_COLS_LONG(24576, 12)
    PFBT_COLS_LONG(30720, 15)
    PFBT_COLS_LONG(32768, 16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PFBT_COLS_LONG
}
