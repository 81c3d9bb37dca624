// K4 / K7's launcher (pg_grid.cu), as the lab entry of lab_spread.cu
// calls it.
#pragma once

#include <cuda_runtime.h>

namespace pfbt {

// The spread of pg_grid.cu: K7 where gmap is given (entries through the
// block's map, w relative to woff), else K4; mode 0 the kernel, 1-4 the
// lab's skeletons (pg_grid.cu).
cudaError_t pg_spread_launch(const float* pos, const float* vis,
                             const int* gmap, const int* start,
                             const int* count, float* out, int C, int NS,
                             int nw, int Thx, int Thy, int k, double beta,
                             int woff, int mode, cudaStream_t st);

}  // namespace pfbt
