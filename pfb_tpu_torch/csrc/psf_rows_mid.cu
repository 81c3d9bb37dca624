// K10br's instances at NY = 8192-12288 (psf_rows_kernel.cuh; psf_rows.cu
// has the design and dispatches here).
#include "psf_rows_kernel.cuh"

namespace pfbt {

cudaError_t launch_length_mid(const float* zr, const float* zi,
                              const float* hr, const float* hi, float* wr,
                              float* wi, int R, int ny, int NY, int NX,
                              const float2* T, cudaStream_t st) {
  switch (NY) {
    PFBT_FUSED(8192, 32, 2)
    PFBT_FUSED(9216, 36, 1)
    PFBT_FUSED(10240, 40, 1)
    PFBT_FUSED(11520, 45, 1)
    PFBT_FUSED(12288, 48, 1)
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace pfbt
