// K5: the pg gridder's fold. The live tiles' halo'd blocks are
// overlap-added into the periodic (2 nw, Nx, Ny) grids.
//
// Replaces pfb_tpu/ops/pgridder.py:_fold_pallas (Pallas kernels
// _fold_kernel and _fold_kernel_pipe, which compute the same output):
// block element (i, j) of tile (tx, ty) lands at
// ((tx txs - k/2 + i) mod Nx, (ty tys - k/2 + j) mod Ny).
//
// What bounds it on the H100, and what the design does about it:
// - The TPU kernels stage (8, 128)-aligned windows into an extended grid
//   with DMA read-modify-writes, roll them into place and wrap the
//   margins afterwards; all of that serves the TPU's DMA. Here the fold
//   is a gather: one thread per grid point (X, Y) finds the tiles whose
//   halo'd blocks cover it (at most two per axis when N >= the block
//   size, through the periodic wrap as well), reads their elements and
//   writes the point once, for every plane.
// - Neighbouring tiles' halos overlap. A scatter would need atomics or
//   colour passes; the gather needs neither, sums in a fixed order
//   (reruns are bitwise equal) and writes every grid point, so the grid
//   needs no zeroing pass.
// - The pass moves the grid stack once (write) and the live blocks about
//   once (read, coalesced along y), so device-memory bandwidth bounds it.
//
// K8 is the same kernel over one w block of the w-plane-blocked engine
// (pfb_tpu_torch/ops/pg_stream.py), through its own entry point: it
// replaces pfb_tpu/ops/pg_stream.py:_fold_pallas_gs (Pallas kernel
// _fold_kernel_batched), which folds the block's compact slots
// (2B, NT, Thx, Thy) with unshifted origins into an extended buffer,
// wraps its margins (_fold_finish) and rolls by (-k/2, -k/2). Shifted
// origins taken mod N give the same grids, and the gather needs none of
// the colour batches, DMA semaphores, extended buffer or roll; the
// block's tile -> slot table (-1 for a tile outside the block) comes
// from the plan.
#include "pg_es.cuh"

namespace pfbt {

// Up to 4 (tile, offset) covers of coordinate X along one axis of ntile
// tiles of size ts with blocks of Th = ts + k elements, origin shifted
// by h, period N.
__device__ __forceinline__ int axis_covers(int X, int N, int ntile, int ts,
                                           int Th, int h, int* tile,
                                           int* off) {
  int n = 0;
  const int ext = (ntile - 1) * ts + Th;  // extended coordinates [0, ext)
  for (int e = X + h - N; e < ext; e += N) {
    if (e < 0) continue;
    const int t = e / ts;
    for (int tt = t; tt >= t - 1 && tt >= 0; --tt) {
      const int i = e - tt * ts;
      if (tt < ntile && i < Th && n < 4) {
        tile[n] = tt;
        off[n] = i;
        ++n;
      }
    }
  }
  return n;
}

__global__ void pg_fold_kernel(const float* __restrict__ Yc,
                               const int* __restrict__ tslot,
                               float* __restrict__ out, int nq, int NS,
                               int Thx, int Thy, int txs, int tys, int ntx,
                               int nty, int h, int Nx, int Ny) {
  const int Y = blockIdx.x * blockDim.x + threadIdx.x;
  const int X = blockIdx.y;
  if (Y >= Ny) return;
  int tx[4], ox[4], ty[4], oy[4];
  const int nx = axis_covers(X, Nx, ntx, txs, Thx, h, tx, ox);
  const int ny = axis_covers(Y, Ny, nty, tys, Thy, h, ty, oy);
  const size_t P = static_cast<size_t>(Thx) * Thy;
  size_t src[16];
  int n = 0;
  for (int a = 0; a < nx; ++a)
    for (int b = 0; b < ny; ++b) {
      const int sl = tslot[tx[a] * nty + ty[b]];
      if (sl >= 0)
        src[n++] = static_cast<size_t>(sl) * P +
                   static_cast<size_t>(ox[a]) * Thy + oy[b];
    }
  const size_t plane_in = static_cast<size_t>(NS) * P;
  const size_t plane_out = static_cast<size_t>(Nx) * Ny;
  const size_t o = static_cast<size_t>(X) * Ny + Y;
  for (int q = 0; q < nq; ++q) {
    const float* yq = Yc + q * plane_in;
    float sum = 0.0f;
    for (int l = 0; l < n; ++l) sum += yq[src[l]];
    out[q * plane_out + o] = sum;
  }
}

}  // namespace pfbt

// K5. Yc (nq, NS, Thx, Thy), tslot (ntx * nty,) int32 (compact slot of a
// live tile, -1 otherwise) -> out (nq, Nx, Ny). Needs Nx >= Thx and
// Ny >= Thy. Returns a CUDA error code (0 on success).
extern "C" int pfbt_pg_fold(const float* Yc, const int* tslot, float* out,
                            int nq, int NS, int Thx, int Thy, int txs,
                            int tys, int ntx, int nty, int k, int Nx,
                            int Ny, void* stream) {
  if (Nx < Thx || Ny < Thy || txs < k || tys < k || nq < 1 || NS < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int T = 256;
  dim3 grid((Ny + T - 1) / T, Nx);
  pfbt::pg_fold_kernel<<<grid, T, 0, static_cast<cudaStream_t>(stream)>>>(
      Yc, tslot, out, nq, NS, Thx, Thy, txs, tys, ntx, nty, k / 2, Nx, Ny);
  return static_cast<int>(cudaGetLastError());
}

// K8. One w block's slots Yc (2B, NT, Thx, Thy) and its tile -> slot
// table tslot (ntx * nty,) int32 -> the block's periodic grids out (2B,
// Nx, Ny).
extern "C" int pfbt_pg_fold_gs(const float* Yc, const int* tslot, float* out,
                               int nq, int NT, int Thx, int Thy, int txs,
                               int tys, int ntx, int nty, int k, int Nx,
                               int Ny, void* stream) {
  return pfbt_pg_fold(Yc, tslot, out, nq, NT, Thx, Thy, txs, tys, ntx, nty,
                      k, Nx, Ny, stream);
}
