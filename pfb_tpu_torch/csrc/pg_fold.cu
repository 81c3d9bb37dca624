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
//   is a gather: every grid point sums the elements of the live blocks
//   that cover it and is written once, for every plane. Neighbouring
//   tiles' halos overlap; a scatter would need atomics or colour passes,
//   the gather needs neither, sums in a fixed order (reruns are bitwise
//   equal) and writes every grid point, so the grid needs no zeroing
//   pass.
// - Bytes bound it: the grid stack written once and the live blocks read
//   about once. Most of the grid lies under no live tile on the paths, so
//   the writes, zeros mostly, dominate.
// - Every grid point finds its sources the same way, with no loop and no
//   table: in the shifted coordinate u = (X + k/2) mod N, tile t's block
//   holds u at offset u + m N - t ts for a wrap m, and with N >= Th = ts +
//   k only tiles floor(e / ts) - 1 and floor(e / ts) of e = u and u + N
//   can (fold_covers): at most two live, three where the last tile's
//   remainder is below k (fold_max_covers). A point's sources are the
//   live pairs of its x and y candidates, summed in the order (x
//   candidate, y candidate), each candidate in the order wrap m, then
//   tile downward, the order of the per-point kernel this one replaced,
//   so the grids are bit for bit what they were: offsets and flags in
//   registers (fixed slots), never in local memory.
// - A block takes kFoldRows grid rows of kFoldThreads aligned columns, so
//   the x candidates are uniform across it and every warp stores whole
//   lines. Blocks that follow the tile footprints instead (ts columns, the
//   pieces found once a block) measured about 2x slower on the paths'
//   tiles (PERF.md): their rows start at any 4-byte offset (ts = 121, 249;
//   k/2 = 3), so every row segment shares partial lines with its
//   neighbours'; and 4 x 4 candidate pairs a point held 86 registers and
//   two blocks an SM, against 40 registers at two slots an axis (64 with
//   the plane loads below in flight).
// - The grid's third dimension takes kFoldPlanes planes at a time, so the
//   blocks that run together write neighbouring rows of fewer planes; a
//   thread keeps a source's loads of eight planes (then four, then one)
//   in flight before their stores. Sixteen planes a block measured best
//   of 2, 4, 8, 16 and all (PERF.md).
// - One point a thread, scalar loads and stores. float2 / float4 would
//   need ts, Th and k/2 multiples of 2 / 4 along y: of the plans' k (4, 5,
//   7, 9, 11, 13) only k = 4 (epsilon >= 3e-2) allows float2 and none
//   float4, and the paths run k = 7. Four points a thread with float4
//   stores and scalar loads on the paths' tiles measured 1.8x slower: a
//   warp of 128 columns holds points where a tile starts or ends, which
//   take them one at a time, and the warp waits for them.
// - A point with no live source writes zeros with streaming stores.
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

constexpr int kFoldThreads = 256;
constexpr int kFoldRows = 8;     // grid rows a block
constexpr int kFoldPlanes = 16;  // planes a block (gridDim.z)

// The live (tile, offset) candidates of grid coordinate X along an axis
// of period N, ntile = ceil(N / ts) tiles of step ts and blocks of Th =
// ts + k, origin shifted by h: for e = u + m N (u = (X + h) mod N, m = 0,
// 1), tiles floor(e / ts) and floor(e / ts) - 1 where the tile exists and
// its block holds e, in that order (the summation order of the per-point
// kernel this one replaced, so the grids keep their bits), the first C of
// them in t[], i[]
// (fixed slots, no local memory); returns how many there are. At most 2
// unless the last tile's remainder N - (ntile - 1) ts is below k, then 3
// (fold_max_covers).
template <int C>
__device__ __forceinline__ int fold_covers(int X, int N, int ntile, int ts,
                                           int Th, int h, int* t, int* i) {
  const int u = X + h < N ? X + h : X + h - N;
  int n = 0;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int e = u + m * N, tt = e / ts;
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      const int tc = tt - d, ic = e - tc * ts;
      if (tc >= 0 && tc < ntile && ic < Th) {
#pragma unroll
        for (int c = 0; c < C; ++c)
          if (n == c) {
            t[c] = tc;
            i[c] = ic;
          }
        ++n;
      }
    }
  }
  return n;
}

// Candidates a coordinate can have along an axis (see fold_covers).
static int fold_max_covers(int N, int ts, int k) {
  const int ntile = (N + ts - 1) / ts;
  return N - (ntile - 1) * ts < k ? 3 : 2;
}

// Q planes of the point at o (plane stride so): the sum of its live
// sources (plane stride si from sq) in the order a, then b, the Q loads of
// a source in flight before the Q stores.
template <int C, int Q>
__device__ __forceinline__ void fold_planes(const float* __restrict__ sq,
                                            float* o, size_t si, size_t so,
                                            const bool (&ok)[C][C],
                                            const int (&off)[C][C]) {
  float acc[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) acc[j] = 0.f;
#pragma unroll
  for (int a = 0; a < C; ++a)
#pragma unroll
    for (int b = 0; b < C; ++b)
      if (ok[a][b]) {
#pragma unroll
        for (int j = 0; j < Q; ++j) acc[j] += __ldg(sq + j * si + off[a][b]);
      }
#pragma unroll
  for (int j = 0; j < Q; ++j) o[j * so] = acc[j];
}

// Thread: column Y of kFoldRows rows X of kFoldPlanes planes (blockIdx.z);
// C candidates an axis at most.
template <int C>
__global__ void __launch_bounds__(kFoldThreads)
pg_fold_kernel(const float* __restrict__ Yc, const int* __restrict__ tslot,
               float* __restrict__ out, int nq, int NS, int Thx, int Thy,
               int txs, int tys, int ntx, int nty, int h, int Nx, int Ny) {
  const int Y = blockIdx.x * kFoldThreads + threadIdx.x;
  if (Y >= Ny) return;
  int ty[C], oy[C];
  const int ncy = fold_covers<C>(Y, Ny, nty, tys, Thy, h, ty, oy);
  const int P = Thx * Thy;
  const size_t si = (size_t)NS * P, so = (size_t)Nx * Ny;
  const int q0 = blockIdx.z * kFoldPlanes;
  const int nqb = min(kFoldPlanes, nq - q0);
  const float* sq = Yc + q0 * si;
  const int X1 = min(Nx, (int)(blockIdx.y + 1) * kFoldRows);
  for (int X = blockIdx.y * kFoldRows; X < X1; ++X) {
    int tx[C], ox[C];
    const int ncx = fold_covers<C>(X, Nx, ntx, txs, Thx, h, tx, ox);
    // the sources: x candidate a (uniform in the block) by y candidate b
    bool ok[C][C];
    int off[C][C];
    bool any = false;
#pragma unroll
    for (int a = 0; a < C; ++a)
#pragma unroll
      for (int b = 0; b < C; ++b) {
        const int s = a < ncx && b < ncy
                          ? __ldg(tslot + tx[a] * nty + ty[b]) : -1;
        ok[a][b] = s >= 0;
        off[a][b] = s * P + ox[a] * Thy + oy[b];
        any |= ok[a][b];
      }
    float* o = out + (q0 * (size_t)Nx + X) * Ny + Y;
    if (!any) {
      for (int j = 0; j < nqb; ++j) __stcs(o + j * so, 0.f);
      continue;
    }
    int j = 0;
    for (; j + 8 <= nqb; j += 8)
      fold_planes<C, 8>(sq + j * si, o + j * so, si, so, ok, off);
    if (j + 4 <= nqb) {
      fold_planes<C, 4>(sq + j * si, o + j * so, si, so, ok, off);
      j += 4;
    }
    for (; j < nqb; ++j)
      fold_planes<C, 1>(sq + j * si, o + j * so, si, so, ok, off);
  }
}

template <int C>
static cudaError_t launch_fold(const float* Yc, const int* tslot, float* out,
                               int nq, int NS, int Thx, int Thy, int txs,
                               int tys, int ntx, int nty, int h, int Nx,
                               int Ny, cudaStream_t st) {
  const dim3 grid((Ny + kFoldThreads - 1) / kFoldThreads,
                  (Nx + kFoldRows - 1) / kFoldRows,
                  (nq + kFoldPlanes - 1) / kFoldPlanes);
  pg_fold_kernel<C><<<grid, kFoldThreads, 0, st>>>(
      Yc, tslot, out, nq, NS, Thx, Thy, txs, tys, ntx, nty, h, Nx, Ny);
  return cudaGetLastError();
}

}  // namespace pfbt

// K5. Yc (nq, NS, Thx, Thy), tslot (ntx * nty,) int32 (compact slot of a
// live tile, -1 otherwise) -> out (nq, Nx, Ny). Needs Nx >= Thx, Ny >=
// Thy, ntx = ceil(Nx / txs), nty = ceil(Ny / tys) (the plans' tiles) and
// blocks of Th = ts + k with k <= ts. Returns a CUDA error code (0 on
// success).
extern "C" int pfbt_pg_fold(const float* Yc, const int* tslot, float* out,
                            int nq, int NS, int Thx, int Thy, int txs,
                            int tys, int ntx, int nty, int k, int Nx,
                            int Ny, void* stream) {
  using namespace pfbt;
  if (Nx < Thx || Ny < Thy || txs < k || tys < k || nq < 1 || NS < 1 ||
      ntx != (Nx + txs - 1) / txs || nty != (Ny + tys - 1) / tys ||
      (long)NS * Thx * Thy > 0x7fffffffL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int h = k / 2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      fold_max_covers(Nx, txs, k) == 3 || fold_max_covers(Ny, tys, k) == 3
          ? launch_fold<3>(Yc, tslot, out, nq, NS, Thx, Thy, txs, tys, ntx,
                           nty, h, Nx, Ny, st)
          : launch_fold<2>(Yc, tslot, out, nq, NS, Thx, Thy, txs, tys, ntx,
                           nty, h, Nx, Ny, st);
  return static_cast<int>(e);
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
