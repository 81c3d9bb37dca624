// K10br: the PSF rows stage as a fused register row FFT.
//
// Replaces the rows stage of pfb_tpu/ops/pallas_fft.py, where the TPU
// runs it in _k2t_kernel / _k2tr_kernel (psf_convolve_pallas_v3_cube,
// _cube_cg), psf_v3_stage_k2, K11's _k2_kernel (psf_convolve_pallas) and
// the _k2o_kernel of K13 / K14: per kept spectrum row g, the forward DFT
// of the row zero-padded from ny to N = NY, the product with its row of
// the transfer function H, the inverse DFT left unscaled (the column
// stage scales by 1 / (NX NY)), cropped to ny. psf_conv.cu's rows_stage
// sends every entry's rows stage here at N = 2048, 2560, 3072, 4096,
// 4608, 5120, 6144, 8192 and 12288 (psf_rows_fused), so K1, K2, K10 stage
// 2, K11 and K12-K14 take it at one N, and a row's arithmetic depends
// only on that row and N: K10's row shards stay bitwise K1.
//
// What bounds it on the H100: bytes, each row of z read once, of w
// written once and of H read once (4 or 8 bytes a spectrum value, 16 for
// K11's two rows of the full H): H is half the traffic at a complex H.
// psf_rows_kernel (psf_conv.cu) keeps the zero-padded row in shared
// memory, sweeps it twice per radix pass of each transform (ten sweeps
// each at 8192 = 16 16 16 2), transforms the known zeros and computes
// all N outputs of the inverse: shared memory sets its pace. Here the row
// lives in registers through both transforms, K3r's plan (rows_fft.cuh:
// N = 16 R2 16, row_threads(R2) threads, one row a block):
//   1. forward radix 16 from HBM: butterfly j loads n = j + q N/16 for
//      n < ny only; where ny <= N/2 (every PSF at twice the image) the
//      zeros at q >= 8 are never loaded or multiplied (dft16_low<true>);
//   2. forward radix R2 between two padded transposes (rows_mid);
//   3. forward radix 16 leaves X[j + q N/16] in registers, which is the
//      layout the inverse's stage 1 takes: the product with H happens in
//      registers and neither shared memory nor HBM sees the spectrum.
//      H's row is loaded at those k, a whole 128-byte segment a warp
//      (K11's mirrored row N - k runs downward across the warp);
//   4. inverse radix 16 in registers, then the transposes and radix R2;
//   5. inverse radix 16 to HBM computes and stores k < ny only
//      (dft16_low<..., true> where ny <= N/2).
// Four transposes through one shared buffer against twenty sweeps, and no
// HBM traffic but z, H and w. H's lines are hinted into L2 when the block
// starts (prefetch.global.L2), so their loads after the forward transform
// wait on L2, not on HBM. The launch bounds ask for registers for three
// blocks an SM at 2048-4096 (K3r's four spilled here; three measured level
// or faster, PERF.md), two at 4608-8192 and one at 12288, as K3r's.
#include <algorithm>

#include "psf_rows.cuh"
#include "rows_fft.cuh"

namespace pfbt {

__device__ __forceinline__ void prefetch_l2(const float* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// One block of T = row_threads(R2) threads per row g of z; stages 1 and
// 3 have N/16 butterflies (B a thread), stage 2 has 256. kHalf: ny <= N/2.
// kFull: H is the full (nb, NX, N) transfer function (K11), else (R, N).
template <int N, int R2, int MINB, bool kHalf, bool kFull>
__global__ void __launch_bounds__(row_threads(R2), MINB)
psf_rows_fused_kernel(const float* __restrict__ zr,
                      const float* __restrict__ zi,
                      const float* __restrict__ hr,
                      const float* __restrict__ hi, float* __restrict__ wr,
                      float* __restrict__ wi, int ny, int NX,
                      const float2* __restrict__ TW) {
  constexpr int T = row_threads(R2);
  constexpr int NB = N / 16;
  constexpr int B = (NB + T - 1) / T;
  constexpr int Q = kHalf ? 8 : 16;  // stage-1 inputs and last outputs
  static_assert(16 * R2 * 16 == N, "N = 16 R2 16");
  extern __shared__ float2 sm[];
  const int t = threadIdx.x;
  // offsets, not pointers, of the block's rows (32-bit: the launches
  // are cut so that they fit), so the row lives in registers beside fewer
  // addresses
  const int zo = blockIdx.x * ny;
  int ha = blockIdx.x * N, hm = ha;  // H's rows: row g, or (kFull) rows
  if (kFull) {                       // kx and (NX - kx) mod NX of band b
    const int nxh = NX / 2 + 1;
    const int b = blockIdx.x / nxh, kx = blockIdx.x - b * nxh;
    ha = (b * NX + kx) * N;
    hm = (b * NX + (NX - kx) % NX) * N;
  }
  for (int l = t; l < N / 32; l += T) {
    prefetch_l2(hr + ha + 32 * l);
    if (hi) prefetch_l2(hi + ha + 32 * l);
    if (kFull) {
      prefetch_l2(hr + hm + 32 * l);
      if (hi) prefetch_l2(hi + hm + 32 * l);
    }
  }

  // 1. forward radix 16 from HBM: every load of the thread issued first
  float2 v[B][16];
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int j = t + b * T;
    if (NB % T && j >= NB) continue;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int n = j + q * NB;
      v[b][q] = n < ny ? make_float2(zr[zo + n], zi[zo + n])
                       : make_float2(0.f, 0.f);
    }
  }
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int j = t + b * T;
    if (NB % T && j >= NB) continue;
    if (kHalf)
      dft16_low<true, false>(v[b], false);
    else
      small_dft<16>(v[b], false);
#pragma unroll
    for (int q = 0; q < 16; ++q) sm[rpad(16 * j + q)] = v[b][q];
  }
  __syncthreads();

  // 2. forward radix R2
  rows_mid<R2, T, true>(sm, TW, false);
  __syncthreads();

  // 3. forward radix 16: X[k], k = j + NB q, in v[b][q]; 4. the product
  // with H at the same k; 5. the inverse's radix 16 on n = j + NB q
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int j = t + b * T;
    if (NB % T && j >= NB) continue;
    rows_last_load<N, R2, true>(sm, TW, j, false, v[b]);
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
    const int j = t + b * T;
    if (NB % T && j >= NB) continue;
#pragma unroll
    for (int q = 0; q < 16; ++q) sm[rpad(16 * j + q)] = v[b][q];
  }
  __syncthreads();

  // 6. inverse radix R2
  rows_mid<R2, T, true>(sm, TW, true);
  __syncthreads();

  // 7. inverse radix 16 to HBM, outputs k = j + NB q < ny only
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int j = t + b * T;
    if (NB % T && j >= NB) continue;
    rows_last_load<N, R2, true>(sm, TW, j, true, v[b]);
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
static cudaError_t launch_fused(const float* zr, const float* zi,
                                const float* hr, const float* hi, float* wr,
                                float* wi, int R, int ny, int NX,
                                const float2* TW, cudaStream_t st) {
  using Kernel = void (*)(const float*, const float*, const float*,
                          const float*, float*, float*, int, int,
                          const float2*);
  const bool half = 2 * ny <= N;
  const Kernel kernel =
      NX ? (half ? psf_rows_fused_kernel<N, R2, MINB, true, true>
                 : psf_rows_fused_kernel<N, R2, MINB, false, true>)
         : (half ? psf_rows_fused_kernel<N, R2, MINB, true, false>
                 : psf_rows_fused_kernel<N, R2, MINB, false, false>);
  const size_t smem = (size_t)(N + N / 16) * sizeof(float2);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<(unsigned)R, row_threads(R2), smem, st>>>(zr, zi, hr, hi, wr, wi, ny,
                                                 NX, TW);
  return cudaGetLastError();
}

// One launch at any fused length NY.
static cudaError_t launch_length(const float* zr, const float* zi,
                                 const float* hr, const float* hi, float* wr,
                                 float* wi, int R, int ny, int NY, int NX,
                                 const float2* T, cudaStream_t st) {
#define PFBT_FUSED(n, r2, minb)                                             \
  case n:                                                                   \
    return launch_fused<n, r2, minb>(zr, zi, hr, hi, wr, wi, R, ny, NX, T, \
                                     st);
  switch (NY) {
    PFBT_FUSED(2048, 8, 3)
    PFBT_FUSED(2560, 10, 3)
    PFBT_FUSED(3072, 12, 3)
    PFBT_FUSED(4096, 16, 3)
    PFBT_FUSED(4608, 18, 2)
    PFBT_FUSED(5120, 20, 2)
    PFBT_FUSED(6144, 24, 2)
    PFBT_FUSED(8192, 32, 2)
    PFBT_FUSED(12288, 48, 1)
    default:
      return cudaErrorInvalidValue;
  }
#undef PFBT_FUSED
}

cudaError_t psf_rows_fused_stage(const float* zr, const float* zi,
                                 const float* hr, const float* hi, float* wr,
                                 float* wi, int R, int ny, int NY, int NX,
                                 const void* TR, int* launches,
                                 cudaStream_t st) {
  // a unit of rows: one row, or (K11) a band's NX/2 + 1 rows, whose H is
  // the band's NX rows
  const long rows = NX ? NX / 2 + 1 : 1, hrows = NX ? NX : 1;
  if (R < 1 || ny < 1 || ny > NY || NX < 0 || NX % 2 || R % rows || !TR ||
      !psf_rows_fused(NY))
    return cudaErrorInvalidValue;
  // units a launch, so that its offsets into z, w and H fit in 31 bits
  const long kMax = 0x7fffffffL;
  const long per = std::min(kMax / (rows * ny), kMax / (hrows * NY));
  if (per < 1) return cudaErrorInvalidValue;
  const float2* T = static_cast<const float2*>(TR);
  for (long u = 0, units = R / rows; u < units; u += per) {
    const long zo = u * rows * ny, ho = u * hrows * NY;
    const cudaError_t e = launch_length(
        zr + zo, zi + zo, hr + ho, hi ? hi + ho : nullptr, wr + zo, wi + zo,
        static_cast<int>(std::min(per, units - u) * rows), ny, NY, NX, T, st);
    if (e != cudaSuccess) return e;
    if (launches) ++*launches;
  }
  return cudaSuccess;
}

}  // namespace pfbt

// 1 where the rows stage of length NY takes K10br, 0 where it keeps
// psf_rows_kernel (the predicate every entry asks; ops/psf.py:rows_route
// is its mirror).
extern "C" int pfbt_psf_rows_route(int NY) {
  return pfbt::psf_rows_fused(NY) ? 1 : 0;
}

// K10br alone: R rows of z (R, ny) -> w (R, ny) against H (R, NY) (NX =
// 0) or the full (nb, NX, NY) transfer function (NX > 0, R = nb (NX/2 +
// 1)); TR the rows plan's table at NY (pfbt_rows_twiddles). Refuses an NY
// off the route. *launches (may be null) gains one for each launch of the
// kernel (psf_rows_fused_stage).
extern "C" int pfbt_psf_rows(const float* zr, const float* zi,
                             const float* hr, const float* hi, float* wr,
                             float* wi, int R, int ny, int NY, int NX,
                             const void* TR, int* launches, void* stream) {
  return static_cast<int>(pfbt::psf_rows_fused_stage(
      zr, zi, hr, hi, wr, wi, R, ny, NY, NX, TR, launches,
      static_cast<cudaStream_t>(stream)));
}
