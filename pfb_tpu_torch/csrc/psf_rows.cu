// K10br: the PSF rows stage as a fused register row FFT.
//
// Replaces the rows stage of pfb_tpu/ops/pallas_fft.py, where the TPU
// runs it in _k2t_kernel / _k2tr_kernel (psf_convolve_pallas_v3_cube,
// _cube_cg), psf_v3_stage_k2, K11's _k2_kernel (psf_convolve_pallas) and
// the _k2o_kernel of K13 / K14: per kept spectrum row g, the forward DFT
// of the row zero-padded from ny to N = NY, the product with its row of
// the transfer function H, the inverse DFT left unscaled (the column
// stage scales by 1 / (NX NY)), cropped to ny. psf_conv.cu's rows_stage
// sends every entry's rows stage here at N = 256 R2, R2 = 1-64 5-smooth
// (256-16384, psf_rows_fused), so K1, K2, K10 stage
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
// N = 16 R2 16, row_threads(R2) threads, one row a block from 2048,
// rows_per_block(R2) = 16 / R2 below):
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
// or faster, PERF.md), two at 4608-8192 and one from 9216, as K3r's.
// Short rows (NY = 256-1536, psf_rows_short.cu): 16 / R2 rows a block of
// 192-256 threads, a stage-1 and stage-3 butterfly a thread, registers for
// two blocks an SM. psf_rows_kernel took 8192 / NY rows a block there
// with two to four shared-memory passes a transform; a stage of (8, NY/2
// + 1, NY/2) rows moves 0.4-14 MB, so the launch sets part of its time.
#include <algorithm>

#include "psf_rows_kernel.cuh"

namespace pfbt {

// One launch at any fused length NY.
static cudaError_t launch_length(const float* zr, const float* zi,
                                 const float* hr, const float* hi, float* wr,
                                 float* wi, int R, int ny, int NY, int NX,
                                 const float2* T, cudaStream_t st) {
  if (NY > 12288)
    return launch_length_long(zr, zi, hr, hi, wr, wi, R, ny, NY, NX, T, st);
  if (NY > 7680)
    return launch_length_mid(zr, zi, hr, hi, wr, wi, R, ny, NY, NX, T, st);
  if (NY < 2048)
    return launch_length_short(zr, zi, hr, hi, wr, wi, R, ny, NY, NX, T, st);
  switch (NY) {
    PFBT_FUSED(2048, 8, 3)
    PFBT_FUSED(2304, 9, 3)
    PFBT_FUSED(2560, 10, 3)
    PFBT_FUSED(3072, 12, 3)
    PFBT_FUSED(3840, 15, 3)
    PFBT_FUSED(4096, 16, 3)
    PFBT_FUSED(4608, 18, 2)
    PFBT_FUSED(5120, 20, 2)
    PFBT_FUSED(6144, 24, 2)
    PFBT_FUSED(6400, 25, 2)
    PFBT_FUSED(6912, 27, 2)
    PFBT_FUSED(7680, 30, 2)
    default:
      return cudaErrorInvalidValue;
  }
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
