// K10br's kernel and its launch at one length (psf_rows.cu has the
// design). The instances are compiled in four sources, so that their
// builds run side by side: psf_rows_short.cu (NY = 256-1536),
// psf_rows.cu (2048-7680), psf_rows_mid.cu (8192-12288) and
// psf_rows_long.cu (12800-16384), each with a dispatch over its lengths.
#pragma once

#include "psf_rows.cuh"
#include "rows_fft.cuh"

namespace pfbt {

__device__ __forceinline__ void prefetch_l2(const float* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// One block of T = row_threads(R2) threads per S = rows_per_block(R2)
// rows of z (row g = blockIdx.x S + s < R for line s of the block); stages
// 1 and 3 have N/16 butterflies a row (B a thread), stage 2 has 256.
// kHalf: ny <= N/2. kFull: H is the full (nb, NX, N) transfer function
// (K11), else (R, N).
template <int N, int R2, int MINB, bool kHalf, bool kFull>
__global__ void __launch_bounds__(row_threads(R2), MINB)
psf_rows_fused_kernel(const float* __restrict__ zr,
                      const float* __restrict__ zi,
                      const float* __restrict__ hr,
                      const float* __restrict__ hi, float* __restrict__ wr,
                      float* __restrict__ wi, int R, int ny, int NX,
                      const float2* __restrict__ TW) {
  constexpr int T = row_threads(R2);
  constexpr int S = rows_per_block(R2);
  constexpr int NB = N / 16;
  constexpr int NF = S * NB;  // stage-1 butterflies of the block
  constexpr int B = (NF + T - 1) / T;
  constexpr int Q = kHalf ? 8 : 16;  // stage-1 inputs and last outputs
  static_assert(16 * R2 * 16 == N, "N = 16 R2 16");
  extern __shared__ float2 sm[];
  const int t = threadIdx.x;
  const int g0 = blockIdx.x * S;
  // offsets, not pointers, of row g (32-bit: the launches are cut so that
  // they fit), so the row lives in registers beside fewer addresses: z's
  // row, and H's rows, row g, or (kFull) rows kx and (NX - kx) mod NX of
  // band b
  auto h_rows = [&](int g, int& ha, int& hm) {
    ha = g * N;
    hm = ha;
    if (kFull) {
      const int nxh = NX / 2 + 1;
      const int b = g / nxh, kx = g - b * nxh;
      ha = (b * NX + kx) * N;
      hm = (b * NX + (NX - kx) % NX) * N;
    }
  };
  for (int l = t; l < S * (N / 32); l += T) {
    const int s = S > 1 ? l / (N / 32) : 0, ll = l - s * (N / 32);
    if (S > 1 && g0 + s >= R) continue;
    int ha, hm;
    h_rows(g0 + s, ha, hm);
    prefetch_l2(hr + ha + 32 * ll);
    if (hi) prefetch_l2(hi + ha + 32 * ll);
    if (kFull) {
      prefetch_l2(hr + hm + 32 * ll);
      if (hi) prefetch_l2(hi + hm + 32 * ll);
    }
  }

  // 1. forward radix 16 from HBM: every load of the thread issued first
  float2 v[B][16];
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int f = t + b * T;
    if (NF % T && f >= NF) continue;
    const int s = S > 1 ? f / NB : 0, j = f - s * NB;
    if (S > 1 && g0 + s >= R) continue;
    const int zo = (g0 + s) * ny;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int n = j + q * NB;
      v[b][q] = n < ny ? make_float2(zr[zo + n], zi[zo + n])
                       : make_float2(0.f, 0.f);
    }
  }
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int f = t + b * T;
    if (NF % T && f >= NF) continue;
    const int s = S > 1 ? f / NB : 0, j = f - s * NB;
    if (kHalf)
      dft16_low<true, false>(v[b], false);
    else
      small_dft<16>(v[b], false);
#pragma unroll
    for (int q = 0; q < 16; ++q) sm[rpad(s * N + 16 * j + q)] = v[b][q];
  }
  __syncthreads();

  // 2. forward radix R2 (none at R2 = 1)
  if constexpr (R2 > 1) {
    rows_mid<R2, T, S, true>(sm, TW, false);
    __syncthreads();
  }

  // 3. forward radix 16: X[k], k = j + NB q, in v[b][q]; 4. the product
  // with H at the same k; 5. the inverse's radix 16 on n = j + NB q
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int f = t + b * T;
    if (NF % T && f >= NF) continue;
    const int s = S > 1 ? f / NB : 0, j = f - s * NB;
    rows_last_load<N, R2, true>(sm + s * (N + N / 16), TW, j, false, v[b]);
    if (S > 1 && g0 + s >= R) continue;
    int ha, hm;
    h_rows(g0 + s, ha, hm);
    small_dft<16>(v[b], false);
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int k = j + NB * q;
      float h_r, h_i = 0.f;
      if (kFull) {
        const int km = hm + (k ? N - k : 0);
        h_r = 0.5f * (hr[ha + k] + hr[km]);
        if (hi) h_i = 0.5f * (hi[ha + k] - hi[km]);
      } else {
        h_r = hr[ha + k];
        if (hi) h_i = hi[ha + k];
      }
      const float2 x = v[b][q];
      v[b][q] = hi ? make_float2(x.x * h_r - x.y * h_i,
                                 x.x * h_i + x.y * h_r)
                   : make_float2(x.x * h_r, x.y * h_r);
    }
    small_dft<16>(v[b], true);
  }
  __syncthreads();  // every stage-3 read done before the stores
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int f = t + b * T;
    if (NF % T && f >= NF) continue;
    const int s = S > 1 ? f / NB : 0, j = f - s * NB;
#pragma unroll
    for (int q = 0; q < 16; ++q) sm[rpad(s * N + 16 * j + q)] = v[b][q];
  }
  __syncthreads();

  // 6. inverse radix R2
  if constexpr (R2 > 1) {
    rows_mid<R2, T, S, true>(sm, TW, true);
    __syncthreads();
  }

  // 7. inverse radix 16 to HBM, outputs k = j + NB q < ny only
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int f = t + b * T;
    if (NF % T && f >= NF) continue;
    const int s = S > 1 ? f / NB : 0, j = f - s * NB;
    if (S > 1 && g0 + s >= R) continue;
    const int zo = (g0 + s) * ny;
    rows_last_load<N, R2, true>(sm + s * (N + N / 16), TW, j, true, v[b]);
    if (kHalf)
      dft16_low<false, true>(v[b], true);
    else
      small_dft<16>(v[b], true);
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int k = j + q * NB;
      if (k < ny) {
        wr[zo + k] = v[b][q].x;
        wi[zo + k] = v[b][q].y;
      }
    }
  }
}

template <int N, int R2, int MINB>
inline cudaError_t launch_fused(const float* zr, const float* zi,
                                const float* hr, const float* hi, float* wr,
                                float* wi, int R, int ny, int NX,
                                const float2* TW, cudaStream_t st) {
  using Kernel = void (*)(const float*, const float*, const float*,
                          const float*, float*, float*, int, int, int,
                          const float2*);
  const bool half = 2 * ny <= N;
  const Kernel kernel =
      NX ? (half ? psf_rows_fused_kernel<N, R2, MINB, true, true>
                 : psf_rows_fused_kernel<N, R2, MINB, false, true>)
         : (half ? psf_rows_fused_kernel<N, R2, MINB, true, false>
                 : psf_rows_fused_kernel<N, R2, MINB, false, false>);
  constexpr int S = rows_per_block(R2);
  const size_t smem = (size_t)S * (N + N / 16) * sizeof(float2);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<(unsigned)((R + S - 1) / S), row_threads(R2), smem, st>>>(
      zr, zi, hr, hi, wr, wi, R, ny, NX, TW);
  return cudaGetLastError();
}

// case n of a length dispatch: the launch of K10br at NY = n = 256 r2
// with registers for minb blocks an SM
#define PFBT_FUSED(n, r2, minb)                                             \
  case n:                                                                   \
    return launch_fused<n, r2, minb>(zr, zi, hr, hi, wr, wi, R, ny, NX, T, \
                                     st);

// One launch at a length of psf_rows_short.cu (256-1536),
// psf_rows_mid.cu (8192-12288) or psf_rows_long.cu (12800-16384);
// cudaErrorInvalidValue at another NY.
cudaError_t launch_length_short(const float* zr, const float* zi,
                                const float* hr, const float* hi, float* wr,
                                float* wi, int R, int ny, int NY, int NX,
                                const float2* T, cudaStream_t st);
cudaError_t launch_length_mid(const float* zr, const float* zi,
                              const float* hr, const float* hi, float* wr,
                              float* wi, int R, int ny, int NY, int NX,
                              const float2* T, cudaStream_t st);
cudaError_t launch_length_long(const float* zr, const float* zi,
                               const float* hr, const float* hi, float* wr,
                               float* wi, int R, int ny, int NY, int NX,
                               const float2* T, cudaStream_t st);

}  // namespace pfbt
