// K10br's instances at NY = 12800-16384 (psf_rows_kernel.cuh; psf_rows.cu
// has the design and dispatches here).
#include "psf_rows_kernel.cuh"

namespace pfbt {

cudaError_t launch_length_long(const float* zr, const float* zi,
                               const float* hr, const float* hi, float* wr,
                               float* wi, int R, int ny, int NY, int NX,
                               const float2* T, cudaStream_t st) {
  switch (NY) {
    PFBT_FUSED(12800, 50, 1)
    PFBT_FUSED(13824, 54, 1)
    PFBT_FUSED(15360, 60, 1)
    PFBT_FUSED(16384, 64, 1)
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace pfbt
