// K3fr (the lab's): K3's y pass above 16384 in one HBM pass, the c2c DFT
// of contiguous rows of N = 8 M on a cluster of 8 blocks a row. It
// measured slower on the H100 than the four-step it was to replace (its
// M-point DFTs in shared memory, four cluster barriers a row; PERF.md), so
// no route takes it: cfft_rows_long.cu (K3yl) takes the rows of the PSF
// grids on a cluster of two blocks with register stages instead.
//
// Replaces pfb_tpu/ops/pallas_cfft.py:fftx_c2c (Pallas _kx_kernel) on the
// transposed view (the y pass of fft2_c2c_pruned, pallas_cfft.py:191,
// 201, 210) at the row lengths no kernel takes in one block: the PSF grids
// of the 128-aligned images from 4608^2 to 8192^2 (N = 18432-32768) and
// any N = 8 M above 16384 with M <= kMaxN a product of 2, 3 and 5
// (ops/cfft.py:four_rows_fits). The earlier route at these lengths, K3f
// (cfft_four.cu) and then the cluster column kernel at M on 8 columns,
// read and wrote the whole stack twice through a full-size intermediate;
// here a row is read once and written once, with no intermediate:
//   1. block c of the row's cluster loads x[c M + m], m < M, into its
//      shared memory (the strided factor n1 = c of n = n2 + M n1, as K3f
//      decimates); in_rolled (the N/2 image rows at (i - N/4) mod N)
//      loads only blocks n1 = 0, 1, 6, 7, whose rows hold the image, and
//      blocks 2-5 are zeros that are never loaded or read;
//   2. after cluster.sync(), block c takes n2 in its eighth of M, reads
//      x[n2 + M n1] from the eight blocks through distributed shared
//      memory, forms the 8-point DFTs over n1 and multiplies by the
//      twiddles W_N^(n2 k1) (K3f's float64 table rounded once, [k1 - 1]
//      [n2], conjugated for the inverse); after a second cluster.sync()
//      (every read of the exchange done) it writes T_k1[n2] into block
//      k1's shared memory, in place;
//   3. after a third, block k1 transforms its line T_k1 of M in shared
//      memory (fft_lines.cuh:block_fft, the Stockham passes of the line
//      kernels): X[k1 + 8 k2] = sum_n2 W_M^(n2 k2) T_k1[n2];
//   4. after a fourth, block c' stores the output rows [c' Nout/8,
//      (c' + 1) Nout/8), reading X[k] from block k mod 8 at k / 8, so
//      every warp stores whole 128-byte segments of re and of im;
//      out_rolled stores only the kept half, row r < N/2 holding X[(r -
//      N/4) mod N], spread over all eight blocks;
//   5. a last cluster.sync() keeps each block's shared memory alive
//      until its peers have read it.
// What bounds it on the H100: bytes, 8 R (Nin + Nout), each input read
// once and each output written once. The 8-point DFTs and twiddles are
// some 10 operations a value, the M-point DFT 5 log2 M. A block has
// ceil(M / kVpt) threads (kVpt values a thread in the Stockham passes,
// two n2 a thread in step 2) and M + M/32 float2 of shared memory: 18-33
// KB at M = 2304-4096, so several clusters share an SM.
#include <cooperative_groups.h>

#include "fft_lines.cuh"

namespace cg = cooperative_groups;

namespace pfbt {

constexpr int kFourC = 8;  // blocks a cluster: the radix over n1
constexpr int kFourRowsMaxT = kMaxN / kVpt;  // threads a block at M = kMaxN
constexpr int kFourU = 4;  // loads (stores) a thread issues before storing

template <int B8>
__global__ void __launch_bounds__(kFourRowsMaxT)
four_rows_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                 float* __restrict__ yr, float* __restrict__ yi,
                 int in_rolled, int out_rolled, int inv, LinePlan p,
                 const float2* __restrict__ TW) {
  extern __shared__ float2 sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();
  const int M = p.N, T = blockDim.x, t = threadIdx.x;
  const long N = (long)kFourC * M;
  const long row = blockIdx.x / kFourC;
  const long Nin = in_rolled ? N / 2 : N, Nout = out_rolled ? N / 2 : N;
  const bool iv = inv != 0;

  // 1. x[c M + m] into the block's line; in_rolled: n < 2M holds input
  // i = n + 2M, n >= 6M input i = n - 6M
  const bool live = !in_rolled || c < 2 || c >= 6;
  if (live) {
    const long i0 = row * Nin + (in_rolled ? (c < 2 ? (long)(c + 2) * M
                                                    : (long)(c - 6) * M)
                                           : (long)c * M);
    for (int m0 = 0; m0 < M; m0 += kFourU * T) {
      float re[kFourU], im[kFourU];
#pragma unroll
      for (int h = 0; h < kFourU; ++h) {
        const int m = m0 + h * T + t;
        re[h] = im[h] = 0.f;
        if (m < M) {
          re[h] = __ldg(xr + i0 + m);
          if (xi) im[h] = __ldg(xi + i0 + m);
        }
      }
#pragma unroll
      for (int h = 0; h < kFourU; ++h) {
        const int m = m0 + h * T + t;
        if (m < M) sm[spad(m)] = make_float2(re[h], im[h]);
      }
    }
  }
  cluster.sync();

  // 2. the 8-point DFTs over n1 of block c's n2, their twiddles, and the
  // exchange into block k1's line
  const float2* src[kFourC];
#pragma unroll
  for (int r = 0; r < kFourC; ++r) src[r] = cluster.map_shared_rank(sm, r);
  const int Mc = (M + kFourC - 1) / kFourC;
  const int lo = c * Mc, hi = min(M, lo + Mc);
  const float sg = iv ? -1.f : 1.f;
  float2 v[B8][kFourC];
#pragma unroll
  for (int b = 0; b < B8; ++b) {
    const int n2 = lo + t + b * T;
    if (n2 >= hi) continue;
#pragma unroll
    for (int n1 = 0; n1 < kFourC; ++n1)
      v[b][n1] = (!in_rolled || n1 < 2 || n1 >= 6) ? src[n1][spad(n2)]
                                                   : make_float2(0.f, 0.f);
    small_dft<kFourC>(v[b], iv);
#pragma unroll
    for (int k1 = 1; k1 < kFourC; ++k1) {
      const float2 w = __ldg(&TW[(k1 - 1) * M + n2]);
      v[b][k1] = cmul(v[b][k1], make_float2(w.x, sg * w.y));
    }
  }
  cluster.sync();  // every read of step 2 done before the in-place writes
#pragma unroll
  for (int b = 0; b < B8; ++b) {
    const int n2 = lo + t + b * T;
    if (n2 >= hi) continue;
#pragma unroll
    for (int k1 = 0; k1 < kFourC; ++k1)
      cluster.map_shared_rank(sm, k1)[spad(n2)] = v[b][k1];
  }
  cluster.sync();

  // 3. the M-point DFT of the block's line: X[c + 8 k2] at sm[spad(k2)]
  block_fft<kVpt>(sm, 1, p, iv);
  cluster.sync();

  // 4. output rows [c Nout/8, (c + 1) Nout/8), X[k] from block k mod 8
  const long q = Nout / kFourC;
  const long r0 = c * q;
  float* yrl = yr + row * Nout;
  float* yil = yi + row * Nout;
  for (long s0 = 0; s0 < q; s0 += kFourU * T) {
    float2 o[kFourU];
#pragma unroll
    for (int h = 0; h < kFourU; ++h) {
      const long s = s0 + h * T + t;
      if (s >= q) continue;
      const long r = r0 + s;
      const long k = out_rolled ? (r < N / 4 ? r + 3 * N / 4 : r - N / 4) : r;
      o[h] = src[k & (kFourC - 1)][spad((int)(k >> 3))];
    }
#pragma unroll
    for (int h = 0; h < kFourU; ++h) {
      const long s = s0 + h * T + t;
      if (s >= q) continue;
      yrl[r0 + s] = o[h].x;
      yil[r0 + s] = o[h].y;
    }
  }
  // 5. no block leaves while a peer may still read its shared memory
  cluster.sync();
}

}  // namespace pfbt

// The y pass of a (rows, Nin) stack at N = 8 M, M <= kMaxN a product of 2,
// 3 and 5 (Nin = N, or N/2 when in_rolled; Nout likewise); TM is the
// length-M plan's table (pfbt_twiddles), TW the four-step's W_N^(n2 k1)
// (pfbt_four_twiddles at N). One cluster of 8 blocks a row.
extern "C" int pfbt_cfft_four_rows(const float* xr, const float* xi,
                                   float* yr, float* yi, int rows, int N,
                                   int in_rolled, int out_rolled,
                                   int inverse, const void* TM,
                                   const void* TW, void* stream) {
  pfbt::LinePlan p;
  if (rows < 1 || N % pfbt::kFourC || N <= pfbt::kMaxN || !xr || !yr ||
      !yi || !TW || !pfbt::make_plan(N / pfbt::kFourC, TM, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  const int M = p.N;
  // ceil(M / kVpt) threads, a multiple of 32: at most two n2 a thread in
  // step 2 (2 T >= ceil(M / 8))
  const unsigned threads =
      (unsigned)(((M + pfbt::kVpt - 1) / pfbt::kVpt + 31) / 32 * 32);
  return static_cast<int>(pfbt::launch_cluster(
      pfbt::four_rows_kernel<2>, pfbt::kFourC, (long)rows * pfbt::kFourC,
      threads, pfbt::smem_bytes(M), static_cast<cudaStream_t>(stream), xr,
      xi, yr, yi, in_rolled, out_rolled, inverse, p,
      static_cast<const float2*>(TW)));
}
