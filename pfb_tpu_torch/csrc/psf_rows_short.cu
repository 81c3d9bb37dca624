// K10br's instances at NY = 256-1536, R2 = 1-6, several rows a block
// (psf_rows_kernel.cuh, rows_fft.cuh: rows_per_block; psf_rows.cu has the
// design and dispatches here), with registers for two blocks an SM of
// 192-256 threads: at three (80 registers) ptxas spilled 72-356 bytes a
// thread in every instance but 256's (K3r's short instances, with no H
// to load, fit three without a spill).
#include "psf_rows_kernel.cuh"

namespace pfbt {

cudaError_t launch_length_short(const float* zr, const float* zi,
                                const float* hr, const float* hi, float* wr,
                                float* wi, int R, int ny, int NY, int NX,
                                const float2* T, cudaStream_t st) {
  switch (NY) {
    PFBT_FUSED(256, 1, 2)
    PFBT_FUSED(512, 2, 2)
    PFBT_FUSED(768, 3, 2)
    PFBT_FUSED(1024, 4, 2)
    PFBT_FUSED(1280, 5, 2)
    PFBT_FUSED(1536, 6, 2)
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace pfbt
