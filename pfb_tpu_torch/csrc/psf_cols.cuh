// The PSF column stages on thread-block clusters (psf_cols.cu), as
// psf_conv.cu's entries call them. See psf_cols.cu for the design.
#pragma once

#include <cuda_runtime.h>

namespace pfbt {

// The cluster route's floor, and its clusters below NX = 4096 (M = 512-768
// at C = 4), for K3's x pass (cfft_cols.cu) and the column stages alike:
// ops/cfft.py:_CLUSTER_MIN_N and _SHORT_C mirror them. C = 4 was chosen
// on the H100 against C = 2 (scripts/torch_kernel_lab.py --cols-const
// kShortClusters=2,4, PERF.md).
constexpr int kColsMinNX = 2048;
constexpr int kShortClusters = 4;

// C, the blocks of a cluster, where the column stages of length NX on L
// columns take the cluster kernels; 0 where they keep line_fft_kernel.
int psf_cols_clusters(int NX, int L);

// Columns of a tile at NX on clusters of C blocks.
int psf_cols_width(int NX, int C);

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
