// K3yl: K3's y pass above 16384 in one HBM pass, the c2c DFT of
// contiguous rows of N = 2 M by two blocks a row, each a register row FFT
// of M = 16 R2 16 (rows_fft.cuh).
//
// Replaces pfb_tpu/ops/pallas_cfft.py:fftx_c2c (Pallas _kx_kernel) on the
// transposed view (the y pass of fft2_c2c_pruned, pallas_cfft.py:191,
// 201, 210) at the row lengths of the PSF grids of the 128-aligned images
// from 4608^2 to 8192^2: N = 2 M, M = 256 R2 with R2 = 36, 40, 45, 48,
// 50, 54, 60, 64 (N = 18432-32768; ops/cfft.py:rows_long_route). A row of
// 147-262 KB does not fit one block's shared memory; half of it does. The
// earlier route at these lengths, K3f (cfft_four.cu) and then the cluster
// column kernel at N / 8 on 8 columns, read and wrote the whole stack
// twice through a full-size intermediate. Here, by decimation in
// frequency,
//   X[2 k' + c] = sum_{n < M} u_c[n] W_M^(n k'),
//   u_0[n] = x[n] + x[n + M],  u_1[n] = (x[n] - x[n + M]) W_N^n,
// block c of the pair (2 r + c) of row r:
//   1. stage 1 of K3r (radix 16) from HBM to registers: butterfly j takes
//      u_c at n = j + q M/16 from both halves of the row (whole 128-byte
//      segments a warp; the pair's two blocks read the same row, the
//      second read served by L2), W_N^n from a float64 table rounded
//      once; in_rolled (the N/2 image rows at (i - N/4) mod N) reads one
//      value a point, the halves' image rows not overlapping;
//   2. stages 2 and 3 of K3r on its line in shared memory: X[2 k' + c]
//      for k' = j + q M/16 in registers;
//   3. the stores: row k = 2 k' + c, each warp's 4-byte stores at every
//      other float, the other half of each segment its pair's (merged in
//      L2); out_rolled computes and stores the kept rows only (k' < M/4
//      and k' >= 3M/4: K3r's dft16<false, true>).
// What bounds it on the H100: bytes, 8 R (Nin + Nout), each input read
// once from HBM and each output written once. A block holds M + M/16
// float2 (78-139 KB) and 256 threads with registers for one block an SM,
// two at R2 = 48 (stage 1 three whole rounds of butterflies, 104 KB),
// where two blocks took less time on the H100 than one, and more at R2 =
// 36. A cluster of the two blocks that read the row's halves from each
// other's shared memory (distributed shared memory, one HBM read of the
// row) measured slower than this at every length.
#include "rows_fft.cuh"

namespace pfbt {

// Two blocks of kRowBflies threads per row of N = 2 M, M = 16 R2 16; TW
// the length-M rows plan's table, TN W_N^e for e < N.
template <int M, int R2, int MINB>
__global__ void __launch_bounds__(kRowBflies, MINB)
rows_long_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                 float* __restrict__ yr, float* __restrict__ yi,
                 int in_rolled, int out_rolled, int inv,
                 const float2* __restrict__ TW,
                 const float2* __restrict__ TN) {
  constexpr int T = kRowBflies;
  constexpr int NB = M / 16;  // stage-1 and stage-3 butterflies
  constexpr int B = (NB + T - 1) / T;
  static_assert(16 * R2 * 16 == M, "M = 16 R2 16");
  extern __shared__ float2 sm[];
  const int c = blockIdx.x & 1;
  const int t = threadIdx.x;
  const bool iv = inv != 0;
  const long row = blockIdx.x / 2;
  const long N = 2L * M;
  const long Nin = in_rolled ? N / 2 : N, Nout = out_rolled ? N / 2 : N;
  const float* xrl = xr + row * Nin;
  const float* xil = xi ? xi + row * Nin : nullptr;
  const float sg = iv ? -1.f : 1.f;

  // 1. u_c at n = j + q NB, every load of the thread issued first, then
  // stage 1 (radix 16) into the line
  float2 v[B][16];
#pragma unroll
  for (int bb = 0; bb < B; ++bb) {
    const int j = t + bb * T;
    if (NB % T && j >= NB) continue;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int n = j + q * NB;
      if (in_rolled) {
        // n < M/2 (q < 8): x[n] is input n + M/2 and x[n + M] zero;
        // else x[n] zero and x[n + M] input n - M/2
        const int i = q < 8 ? n + M / 2 : n - M / 2;
        v[bb][q] = make_float2(xrl[i], xil ? xil[i] : 0.f);
        if (c && q >= 8) v[bb][q] = make_float2(-v[bb][q].x, -v[bb][q].y);
      } else {
        const float2 p = make_float2(xrl[n], xil ? xil[n] : 0.f);
        const float2 r = make_float2(xrl[n + M], xil ? xil[n + M] : 0.f);
        v[bb][q] = c ? csub(p, r) : cadd(p, r);
      }
    }
  }
#pragma unroll
  for (int bb = 0; bb < B; ++bb) {
    const int j = t + bb * T;
    if (NB % T && j >= NB) continue;
    if (c) {
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const float2 w = __ldg(&TN[j + q * NB]);
        v[bb][q] = cmul(v[bb][q], make_float2(w.x, sg * w.y));
      }
    }
    small_dft<16>(v[bb], iv);
#pragma unroll
    for (int q = 0; q < 16; ++q) sm[rpad(16 * j + q)] = v[bb][q];
  }
  __syncthreads();

  // 2. stage 2 (radix R2) and stage 3 (radix 16): X_c[j + NB q] in v
  rows_mid<R2, T, 1, true>(sm, TW, iv);
  __syncthreads();
#pragma unroll
  for (int bb = 0; bb < B; ++bb) {
    const int j = t + bb * T;
    if (NB % T && j >= NB) continue;
    rows_last_load<M, R2, true>(sm, TW, j, iv, v[bb]);
    if (out_rolled)
      dft16<false, true>(v[bb], iv);
    else
      small_dft<16>(v[bb], iv);
  }

  // 3. row k = 2 k' + c; out_rolled: row (k + N/4) mod N of the kept half
  float* yrl = yr + row * Nout;
  float* yil = yi + row * Nout;
#pragma unroll
  for (int bb = 0; bb < B; ++bb) {
    const int j = t + bb * T;
    if (NB % T && j >= NB) continue;
    if (out_rolled) {
      // k' = j + q NB, q < 4: k < N/4 at row k + M/2; q >= 12: k >= 3N/4
      // at row k - 3M/2
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const long ra = 2L * (j + q * NB) + c + M / 2;
        const long rb = 2L * (j + (q + 12) * NB) + c - 3 * (M / 2);
        yrl[ra] = v[bb][q].x;
        yil[ra] = v[bb][q].y;
        yrl[rb] = v[bb][12 + q].x;
        yil[rb] = v[bb][12 + q].y;
      }
    } else {
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const long r = 2L * (j + q * NB) + c;
        yrl[r] = v[bb][q].x;
        yil[r] = v[bb][q].y;
      }
    }
  }
}

template <int M, int R2, int MINB>
static cudaError_t launch_rows_long(const float* xr, const float* xi,
                                    float* yr, float* yi, int rows,
                                    int in_rolled, int out_rolled, int inv,
                                    const float2* TW, const float2* TN,
                                    cudaStream_t stream) {
  const size_t smem = (size_t)(M + M / 16) * sizeof(float2);
  cudaError_t e = allow_smem(rows_long_kernel<M, R2, MINB>, smem);
  if (e != cudaSuccess) return e;
  rows_long_kernel<M, R2, MINB><<<(unsigned)(2L * rows), kRowBflies, smem,
                                  stream>>>(xr, xi, yr, yi, in_rolled,
                                            out_rolled, inv, TW, TN);
  return cudaGetLastError();
}

}  // namespace pfbt

// The y pass of a (rows, Nin) stack at N = 2 M, M = 256 R2 for R2 = 36,
// 40, 45, 48, 50, 54, 60, 64 (Nin = N, or N/2 when in_rolled; Nout
// likewise); TW is the length-M rows plan's table (pfbt_rows_twiddles), TN
// W_N^e for e < N (pfbt_cols_twiddles at N).
extern "C" int pfbt_cfft_rows_long(const float* xr, const float* xi,
                                   float* yr, float* yi, int rows, int N,
                                   int in_rolled, int out_rolled,
                                   int inverse, const void* TW,
                                   const void* TN, void* stream) {
  if (rows < 1 || !xr || !yr || !yi || !TW || !TN)
    return static_cast<int>(cudaErrorInvalidValue);
  const float2* tw = static_cast<const float2*>(TW);
  const float2* tn = static_cast<const float2*>(TN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PFBT_ROWS_LONG(n, r2, minb)                                        \
  case n:                                                                  \
    return static_cast<int>(pfbt::launch_rows_long<n / 2, r2, minb>(       \
        xr, xi, yr, yi, rows, in_rolled, out_rolled, inverse, tw, tn, s));
  switch (N) {
    PFBT_ROWS_LONG(18432, 36, 1)
    PFBT_ROWS_LONG(20480, 40, 1)
    PFBT_ROWS_LONG(23040, 45, 1)
    PFBT_ROWS_LONG(24576, 48, 2)
    PFBT_ROWS_LONG(25600, 50, 1)
    PFBT_ROWS_LONG(27648, 54, 1)
    PFBT_ROWS_LONG(30720, 60, 1)
    PFBT_ROWS_LONG(32768, 64, 1)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PFBT_ROWS_LONG
}
