// The PSF column stages on thread-block clusters (psf_cols.cu), as
// psf_conv.cu's entries call them. See psf_cols.cu for the design.
#pragma once

#include <cuda_runtime.h>

#include "fft_lines.cuh"

namespace pfbt {

// The cluster route's floor, its clusters from kShortNX to 4096 (M =
// 512-768 at C = 4) and below kShortNX (tiny_clusters), for K3's x pass
// (cfft_cols.cu) and the column stages alike: ops/cfft.py:_CLUSTER_MIN_N,
// _SHORT_N, _SHORT_C and _TINY_C mirror them. kShortClusters = 4 was
// chosen on the H100 against 2 (scripts/torch_kernel_lab.py --cols-const
// kShortClusters=2,4), and kTinyClusters = 2 against 1 (--cols-const
// kTinyClusters=1,2, PERF.md).
constexpr int kColsMinNX = 256;
constexpr int kShortNX = 2048;
constexpr int kShortClusters = 4;
constexpr int kTinyClusters = 2;
// Blocks an SM that K3c's registers are budgeted for below kShortNX
// (cfft_cols.cu: blocks of up to kThreads threads, kVpt values a thread;
// 2: 64 registers, as line_fft_kernel's), probed on the H100 against 1
// (128 registers) by --cols-const kTinyColsMinBlocks=1,2 (PERF.md).
constexpr int kTinyColsMinBlocks = 2;

// C, the blocks of a cluster, where the column stages of length NX on L
// columns take the cluster kernels; 0 where they keep line_fft_kernel.
int psf_cols_clusters(int NX, int L);

// Columns of a tile of W lines of M = N / C: below kShortNX the widest of
// 32, 16, 8 and 4 whose lines fit a block's kLineElems values, so that a
// short column's block still holds 4096-8192 values and its rows are
// 32-128 bytes of re and of im; from kShortNX 8 where they fit, else 4
// (one 32-byte sector of re and of im a row, or half).
inline int cols_tile_width(int N, int C) {
  const int M = N / C;
  if (N >= kShortNX) return M * 8 <= kLineElems ? 8 : 4;
  int W = 32;
  while (W > 4 && M * W > kLineElems) W /= 2;
  return W;
}

// C below kShortNX, where a whole column fits one block: one block a tile
// where its tile is 8 columns (a 32-byte sector of re and of im a row, N
// = 768-1024; no exchange through distributed shared memory), else
// kTinyClusters. On the H100 (CUDA-graph replays, PERF.md) one block took
// 6-30% less time than two at 768 and 1024, and two took 10-50% less at
// 256 (twice the blocks of 72-144), 512 (M = 256: a radix pass less) and
// 1280-1536 (one block's tile is 4 columns, half a sector a row).
inline int tiny_clusters(int N) {
  return cols_tile_width(N, 1) == 8 ? 1 : kTinyClusters;
}

// cluster.sync(), or __syncthreads() in a cluster of one block
template <int C, class Cluster>
__device__ __forceinline__ void cluster_sync(Cluster& cluster) {
  if constexpr (C == 1)
    __syncthreads();
  else
    cluster.sync();
}

// Forward column stage: x (nb, nx, L) real -> zr, zi (nb, rows, L), rows
// k < keep of the length-NX transform of the zero-padded columns, rows
// keep .. rows - 1 zero. C must be psf_cols_clusters(NX, L) (> 0); TM is
// the length-NX/C plan's table (pfbt_twiddles), TN W_N^e for e < NX
// (pfbt_cols_twiddles); skeleton = 1 the lab's copy skeleton.
cudaError_t psf_cols_fwd(const float* x, float* zr, float* zi, int nb,
                         int nx, int L, int NX, int keep, int rows, int C,
                         int skeleton, const void* TM, const void* TN,
                         cudaStream_t stream);

// Inverse column stage: rows k < keep of wr, wi (nb, rows, L), the rows
// past them the conjugate mirror of rows 1 .. NX - keep -> out (nb, nx, L),
// the real part of the inverse transform times `scale`.
cudaError_t psf_cols_inv(const float* wr, const float* wi, float* out,
                         int nb, int nx, int L, int NX, int keep, int rows,
                         float scale, int C, int skeleton, const void* TM,
                         const void* TN, cudaStream_t stream);

// K2's stage 1 on the forward kernel: p = beta_b p_prev - r (beta (nb,))
// of pp, rr (nb, nx, L) written to pn, its spectrum rows k <= NX/2 ->
// zr, zi (nb, NX/2 + 1, L).
cudaError_t psf_cols_fwd_cg(const float* pp, const float* rr,
                            const float* beta, float* pn, float* zr,
                            float* zi, int nb, int nx, int L, int NX, int C,
                            const void* TM, const void* TN,
                            cudaStream_t stream);

// K2's stage 3 on the inverse kernel: the Hermitian half wr, wi (nb, NX/2
// + 1, L) -> out (nb, nx, L) times `scale`, and per column the float64
// sums of p . out and p . p (p = pn), each block's into part (nb, L, C,
// 2).
cudaError_t psf_cols_inv_cg(const float* wr, const float* wi,
                            const float* pn, float* out, double* part,
                            int nb, int nx, int L, int NX, float scale,
                            int C, const void* TM, const void* TN,
                            cudaStream_t stream);

}  // namespace pfbt
