// Shared pieces of the pg gridder's kernels (pg_grid.cu, pg_fold.cu,
// pg_degrid.cu): the "exponential of semicircle" kernel and the tap
// ranges of a visibility.
//
// A visibility at tile-local coordinate u (pos row 0 of the plan) has
// nonzero ES factors only at the integers x with |x - u| <= k/2: at most
// k + 1 of them, starting at ceil(u - k/2) (k + 1 only when u - k/2 is
// an integer). The kernels evaluate those taps and no others, where the
// TPU kernels evaluate the factors densely over the whole tile.
#pragma once

#include <cuda_runtime.h>

namespace pfbt {

// Largest tap count a kernel takes: support k <= 16, plus the tap at
// exactly k/2.
constexpr int kMaxTaps = 17;

// exp(beta k (sqrt(1 - t^2) - 1)) for |t| <= 1, else 0: the float32
// formula of pfb_tpu/ops/pgridder.py:_es, with t = (x - u) rkh and
// rkh = 1 / (k/2) (XLA evaluates the JAX package's division by k/2 so;
// it decides the taps at exactly k/2).
__device__ __forceinline__ float es_tap(float x, float u, float rkh,
                                        float betak) {
  const float t = (x - u) * rkh;
  if (fabsf(t) > 1.0f) return 0.0f;
  return expf(betak * (sqrtf(fmaxf(1.0f - t * t, 0.0f)) - 1.0f));
}

// First tap of a coordinate: ceil(c - k/2).
__device__ __forceinline__ int first_tap(float c, float kh) {
  return static_cast<int>(ceilf(c - kh));
}

__device__ __forceinline__ int posmod(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

}  // namespace pfbt
