// The split-precision x pass: K3's four-step c2c DFT along the middle axis
// of a (P, Nin, L) float32 re/im stack with every real product taken as
// three bf16 products on the tensor cores.
//
// Replaces pfb_tpu/ops/pallas_cfft.py:_kx_kernel(prec="split") (the
// fftx_c2c precision="split" mode, _dot_split3) and the k_3x variant of
// scripts/wl_g2i_lab.py:237. N = N1 N2 (ops/cfft.py:_factor):
//   stage 1: C[p, n2] = W1tw[n2] X[p, n2], (N1 x n1_in) x (n1_in x L),
//            X[p, n2][a, l] = x[p, a N2 + n2, l];
//   stage 2: Y[p] = W2 C[p], (K2 x N2) x (N2 x N1 L), and Y[p] viewed as
//            (K2 N1, L) is the output, rows k = k1 + N1 k2 (K2 = N2 / 2
//            rolled rows when out_rolled, as the constants select them).
// Each complex product is Karatsuba's three real products, as _cmm forms
// them: t1 = Wr Xr, t2 = Wi Xi, t3 = (Wr + Wi)(Xr + Xi), re = t1 - t2,
// im = t3 - t1 - t2. Each real product A B is A1 B1 + A1 B2 + A2 B1 with
// A1 = bf16(A), A2 = bf16(A - A1) (round to nearest even), the products
// exact and summed in FP32 (wmma bf16 16x16x16 with float accumulators).
// The constants' hi/lo planes are made once on the host
// (ops/cfft.py:_split_consts); the data are split as they are staged.
//
// What bounds it on the H100: a stage reads its operand once and writes
// its result once, so the pass moves the input, a (P, N2, N1, L) float32
// re/im intermediate twice and the output; its 9 bf16 products per complex
// product are about 193 GFLOP a plane at N = 8192, 0.2 ms at the tensor
// cores' 989 TFLOP/s. The first version stays simple: two launches of one
// kernel with the intermediate in device memory (a block's shared memory
// cannot hold an 8192-row strip), one block per (64-column tile, batch,
// plane), its operand columns split into six bf16 planes in shared memory
// (104 KB at N1 = 128, so two blocks, 8 warps, an SM), the constants'
// 16-row tiles read from L2 by each warp.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace pfbt {

using namespace nvcuda;

constexpr int kSplitCols = 64;  // columns of a block's tile
constexpr int kSplitWarps = 4;
constexpr int kSplitNJ = 2;  // 16-column tiles of a warp's unit
constexpr int kSplitUnitsPerRow = kSplitCols / 16 / kSplitNJ;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
    FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
    FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__device__ __forceinline__ void split_bf16(float a, __nv_bfloat16* hi,
                                           __nv_bfloat16* lo) {
  const __nv_bfloat16 h = __float2bfloat16_rn(a);
  *hi = h;
  *lo = __float2bfloat16_rn(a - __bfloat162float(h));
}

// acc += A B split three ways: A1 B1 + A2 B1 + A1 B2 (planes a[0], a[1]
// of A; b1, b2 the hi and lo planes of B at the fragment's origin)
__device__ __forceinline__ void mma3(FragC& acc, const FragA& a1,
                                     const FragA& a2,
                                     const __nv_bfloat16* b1,
                                     const __nv_bfloat16* b2) {
  FragB b;
  wmma::load_matrix_sync(b, b1, kSplitCols);
  wmma::mma_sync(acc, a1, b, acc);
  wmma::mma_sync(acc, a2, b, acc);
  wmma::load_matrix_sync(b, b2, kSplitCols);
  wmma::mma_sync(acc, a1, b, acc);
}

// One (Mp x kSplitCols) tile of Y = A X for the batch blockIdx.y and the
// plane blockIdx.z. A: six bf16 planes (Wr hi, lo, Wi hi, lo, Ws hi, lo),
// each (Mp, Kp) row-major with zero padding, the batch's at A + b a_b.
// X: rows r < K at xr/xi + p in_p + b in_b + r in_r, columns < ncols.
// Y: rows m < M at yr/yi + p out_p + b out_b + m out_r.
__global__ void __launch_bounds__(32 * kSplitWarps)
split_cgemm_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                   float* __restrict__ yr, float* __restrict__ yi,
                   const __nv_bfloat16* __restrict__ A, long long a_b, int M,
                   int Mp, int K, int Kp, int ncols, long long in_p,
                   long long in_b, long long in_r, long long out_p,
                   long long out_b, long long out_r) {
  extern __shared__ __align__(128) unsigned char split_smem[];
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(split_smem);
  const int plane = Kp * kSplitCols;
  float* stage = reinterpret_cast<float*>(Bs + 6 * plane);
  const int col0 = blockIdx.x * kSplitCols;
  const long long b = blockIdx.y, p = blockIdx.z;
  const float* xr0 = xr + p * in_p + b * in_b + col0;
  const float* xi0 = xi + p * in_p + b * in_b + col0;

  // stage the operand: Xr, Xi and Xr + Xi, each as hi and lo planes
  for (int t = threadIdx.x; t < plane; t += blockDim.x) {
    const int r = t / kSplitCols, j = t - r * kSplitCols;
    float a = 0.f, c = 0.f;
    if (r < K && col0 + j < ncols) {
      a = xr0[r * in_r + j];
      c = xi0[r * in_r + j];
    }
    split_bf16(a, Bs + t, Bs + plane + t);
    split_bf16(c, Bs + 2 * plane + t, Bs + 3 * plane + t);
    split_bf16(a + c, Bs + 4 * plane + t, Bs + 5 * plane + t);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const __nv_bfloat16* Ab = A + b * a_b;
  const size_t apl = (size_t)Mp * Kp;
  float* st = stage + warp * 2 * 256;
  const int nunits = (Mp / 16) * kSplitUnitsPerRow;
  for (int u = warp; u < nunits; u += kSplitWarps) {
    const int mi = u / kSplitUnitsPerRow;
    const int nj0 = (u - mi * kSplitUnitsPerRow) * kSplitNJ;
    FragC t1[kSplitNJ], t2[kSplitNJ], t3[kSplitNJ];
#pragma unroll
    for (int j = 0; j < kSplitNJ; ++j) {
      wmma::fill_fragment(t1[j], 0.f);
      wmma::fill_fragment(t2[j], 0.f);
      wmma::fill_fragment(t3[j], 0.f);
    }
    for (int kk = 0; kk < Kp; kk += 16) {
      FragA a[6];
#pragma unroll
      for (int q = 0; q < 6; ++q)
        wmma::load_matrix_sync(a[q], Ab + q * apl + (size_t)mi * 16 * Kp + kk,
                               Kp);
#pragma unroll
      for (int j = 0; j < kSplitNJ; ++j) {
        const __nv_bfloat16* B0 = Bs + kk * kSplitCols + (nj0 + j) * 16;
        mma3(t1[j], a[0], a[1], B0, B0 + plane);
        mma3(t2[j], a[2], a[3], B0 + 2 * plane, B0 + 3 * plane);
        mma3(t3[j], a[4], a[5], B0 + 4 * plane, B0 + 5 * plane);
      }
    }
#pragma unroll
    for (int j = 0; j < kSplitNJ; ++j) {
      // accumulators of one shape share one element layout
      for (int e = 0; e < t1[j].num_elements; ++e) {
        const float r = t1[j].x[e] - t2[j].x[e];
        t3[j].x[e] = t3[j].x[e] - t1[j].x[e] - t2[j].x[e];
        t1[j].x[e] = r;
      }
      wmma::store_matrix_sync(st, t1[j], 16, wmma::mem_row_major);
      wmma::store_matrix_sync(st + 256, t3[j], 16, wmma::mem_row_major);
      __syncwarp();
      const int c0 = col0 + (nj0 + j) * 16;
      for (int e = lane; e < 256; e += 32) {
        const int r = e / 16, c = e - r * 16;
        const int m = mi * 16 + r;
        if (m < M && c0 + c < ncols) {
          const long long o = p * out_p + b * out_b + m * out_r + c0 + c;
          yr[o] = st[e];
          yi[o] = st[256 + e];
        }
      }
      __syncwarp();
    }
  }
}

static inline size_t split_smem_bytes(int Kp) {
  return (size_t)6 * Kp * kSplitCols * sizeof(__nv_bfloat16) +
         (size_t)kSplitWarps * 2 * 256 * sizeof(float);
}

static inline cudaError_t launch_split(
    const float* xr, const float* xi, float* yr, float* yi,
    const __nv_bfloat16* A, long long a_b, int M, int Mp, int K, int Kp,
    int ncols, int nbatch, int P, long long in_p, long long in_b,
    long long in_r, long long out_p, long long out_b, long long out_r,
    cudaStream_t stream) {
  const size_t smem = split_smem_bytes(Kp);
  cudaError_t e = cudaFuncSetAttribute(
      split_cgemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((ncols + kSplitCols - 1) / kSplitCols, nbatch, P);
  split_cgemm_kernel<<<grid, 32 * kSplitWarps, smem, stream>>>(
      xr, xi, yr, yi, A, a_b, M, Mp, K, Kp, ncols, in_p, in_b, in_r, out_p,
      out_b, out_r);
  return cudaGetLastError();
}

}  // namespace pfbt

// The split x pass of a (P, Nin, L) stack, Nin = n1_in N2, into (P, K2 N1,
// L) through the (P, N2, N1, L) intermediate cr/ci. A1: (N2, 6, M1p, K1p)
// bf16 planes of W1tw (M1p, K1p: N1 and n1_in rounded up to 16); A2: (6,
// M2p, K2p) of W2 (K2 and N2 rounded up). Returns a CUDA error code.
extern "C" int pfbt_cfft_split(const float* xr, const float* xi, float* cr,
                               float* ci, float* yr, float* yi,
                               const void* A1, const void* A2, int P, int L,
                               int N1, int N2, int n1_in, int K2,
                               void* stream) {
  const int M1p = (N1 + 15) / 16 * 16, K1p = (n1_in + 15) / 16 * 16;
  const int M2p = (K2 + 15) / 16 * 16, K2p = (N2 + 15) / 16 * 16;
  if (P < 1 || L < 1 || N1 < 1 || N2 < 1 || n1_in < 1 || n1_in > N1 ||
      K2 < 1 || K2 > N2 || pfbt::split_smem_bytes(K1p) > 232448 ||
      pfbt::split_smem_bytes(K2p) > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long NL = (long long)N1 * L;
  cudaError_t e = pfbt::launch_split(
      xr, xi, cr, ci, static_cast<const __nv_bfloat16*>(A1),
      6LL * M1p * K1p, N1, M1p, n1_in, K1p, L, N2, P,
      (long long)n1_in * N2 * L, L, (long long)N2 * L, N2 * NL, NL, L, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = pfbt::launch_split(cr, ci, yr, yi,
                         static_cast<const __nv_bfloat16*>(A2), 0, K2, M2p,
                         N2, K2p, (int)NL, 1, P, N2 * NL, 0, NL, K2 * NL, 0,
                         NL, s);
  return static_cast<int>(e);
}
