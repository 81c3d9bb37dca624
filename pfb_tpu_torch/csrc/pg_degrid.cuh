// K6 / K9's operands and launcher (pg_degrid.cu), as the lab entry of
// lab_degrid.cu calls them.
#pragma once

#include <cuda_runtime.h>

#include "pg_es.cuh"

namespace pfbt {

// A degrid's operands: the (nw, Nx, Ny) grids gr, gi, the entries'
// positions pos (rows 0-2 read) and tile ids tid; K9 where gmap is given
// (entry gmap[i] for block i, w relative to woff, the result added to
// out), else K6 (entry i, the result written).
struct DegridArgs {
  const float* gr;
  const float* gi;
  const float* pos;
  const int* tid;
  const int* gmap;
  float* out;
  int NE, C, nw, Thx, Thy, txs, tys, nty, Nx, Ny, k;
  float beta, woff;
};

inline bool degrid_args_ok(const DegridArgs& a) {
  return a.k >= 1 && a.k + 1 <= kMaxTaps && a.NE >= 1 && a.C >= 1 &&
         a.nw >= 1 && a.Thx >= 1 && a.Thy >= 1 && a.Thx <= a.Nx &&
         a.Thy <= a.Ny;
}

// The designs of pg_degrid.cu: the earlier thread a visibility, the
// lanes along the taps (k = 7), the staged window, and the one K6 / K9
// launch (the window where three of its blocks fit an SM, else the taps at
// k = 7 and the thread at other k).
constexpr int kDegridThread = 0;
constexpr int kDegridTaps = 1;
constexpr int kDegridWindow = 2;
constexpr int kDegridShipped = 3;

// The degrid of pg_degrid.cu by one of its designs; mode 0 the kernel,
// 1-3 the lab's skeletons (lab_degrid.cu).
cudaError_t pg_degrid_launch(const DegridArgs& a, int design, int mode,
                             cudaStream_t st);

}  // namespace pfbt
