// The PSF rows stage on the register row FFT (psf_rows.cu), as
// psf_conv.cu's entries call it. See psf_rows.cu for the design.
#pragma once

#include <cuda_runtime.h>

namespace pfbt {

// Whether the rows stage of length NY takes the fused register row FFT
// (K10br): NY = 16 R2 16 with R2 a 5-smooth radix from 1 to 64, 256-16384
// (the instances of psf_rows*.cu and cfft_rows.cu). Every other NY keeps
// psf_rows_kernel (psf_conv.cu). ops/psf.py:rows_route is its mirror.
inline bool psf_rows_fused(int NY) {
  switch (NY) {
    case 256: case 512: case 768: case 1024: case 1280: case 1536:
    case 2048: case 2304: case 2560: case 3072: case 3840: case 4096:
    case 4608: case 5120: case 6144: case 6400: case 6912: case 7680:
    case 8192: case 9216: case 10240: case 11520: case 12288: case 12800:
    case 13824: case 15360: case 16384:
      return true;
    default:
      return false;
  }
}

// R rows of z (R, ny) -> w (R, ny): the forward DFT of each row
// zero-padded to NY, the product with its row of H, the unscaled inverse
// DFT, cropped to ny. NX == 0: H is (R, NY), row g for row g (K1, K2,
// K10). NX > 0: H is the full (nb, NX, NY) transfer function and row g =
// b (NX/2 + 1) + kx multiplies H_h(kx, k) = (H(kx, k) + conj H(-kx, -k))
// / 2 (K11). hi may be null (a real H). TR is the rows plan's twiddle
// table at NY (pfbt_rows_twiddles). Needs psf_rows_fused(NY). The kernel
// addresses a launch's rows with 32-bit offsets, so a stage whose z or H
// holds 2^31 elements or more runs as several launches (whole bands for
// K11); *launches (may be null) gains one for each.
cudaError_t psf_rows_fused_stage(const float* zr, const float* zi,
                                 const float* hr, const float* hi, float* wr,
                                 float* wi, int R, int ny, int NY, int NX,
                                 const void* TR, int* launches,
                                 cudaStream_t stream);

}  // namespace pfbt
