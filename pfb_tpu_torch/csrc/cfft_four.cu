// K3f: the first step of K3's four-step transform above 16384 (both
// passes), the radix-8 DFTs over the strided factor with their twiddles,
// and the reorder that leaves the rest to the cluster column kernel.
//
// Replaces pfb_tpu/ops/pallas_cfft.py:fftx_c2c (Pallas _kx_kernel) where
// its length has no kernel of one pass here: the JAX kernel is a
// four-step over _factor(N) at any length; line_fft_kernel keeps a line
// in one block and stops at kMaxN = 16384 (64 K float2 of shared memory a
// line), the cluster column kernel at a tile of 8192 values a block, the
// register row kernel at N = 256 R2, R2 <= 64. So at N = 8 M > 16384
// (the PSF grids of 128-aligned images above 4096^2, N = 18432-32768, and
// the transforms of images above 8192^2) ops/cfft.py:fftx_c2c_four runs
//   x[n2 + M n1] (n1 < 8, n2 < M) -> this kernel:
//     T[n2][k1] = W_N^{n2 k1} sum_{n1} x[n2 + M n1] W_8^{n1 k1}
//   -> the M-point DFT over n2 of each (k1, column) on the cluster column
//      kernel (fftx_c2c at M with 8 L columns: M = N / 8 = 2304-4096 there),
//      whose output row k2 of column (k1, l) is X[k1 + 8 k2][l]: natural
//      order, so no pass follows.
// A (P, Nin, L) float32 re/im stack becomes the (P, M, 8, L) stack T.
// in_rolled (the N/2 image rows at (i - N/4) mod N) is absorbed here: N/4
// = 2 M, so input block i1 = i / M of M rows is n1 = (i1 - 2) mod 8, and
// n1 = 2..5 are zeros never loaded; out_rolled is the cluster kernel's
// (N/4 = 8 (M/4): the kept rows are its rolled rows at M, M % 4 == 0).
//
// What bounds it on the H100: bytes, the input read once and T written
// once (8 P L (Nin + N)); the radix-8 DFT and seven twiddles a point are
// some 60 operations for 16-32 bytes. One thread a (plane, n2, column),
// columns fastest, so the loads of each n1 and, where L >= 32 (the x
// pass), the stores of each k1 are whole 128-byte segments a warp. On
// contiguous rows (L = 1, the y pass) the eight outputs of a thread are
// adjacent, so a block of 256 threads stages its 2048 outputs in shared
// memory (one float of padding every 32: conflict-free both ways) and
// stores them as whole segments. The twiddles are a float64 table rounded
// once (four_twiddle_kernel), [k1 - 1][n2], conjugated for the inverse.
#include "fft_lines.cuh"

namespace pfbt {

constexpr int kFourThreads = 256;
constexpr int kFourStage = 8 * kFourThreads + 8 * kFourThreads / 32;

template <bool kRows>
__global__ void __launch_bounds__(kFourThreads)
four_step_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                 float* __restrict__ tr, float* __restrict__ ti, long total,
                 int M, int L, int in_rolled, int inv,
                 const float2* __restrict__ TW) {
  const int t = threadIdx.x;
  const long g = (long)blockIdx.x * kFourThreads + t;
  const long q = g / L;  // p M + n2
  const int l = static_cast<int>(g - q * L);
  const int n2 = static_cast<int>(q % M);
  const long p = q / M;
  const long stride = (long)M * L;  // one block of M rows
  float2 v[8];
  if (g < total) {
    const long a = (p * (in_rolled ? 4 : 8) * M + n2) * L + l;
    auto load = [&](long i) {
      return make_float2(xr[i], xi ? xi[i] : 0.f);
    };
    if (in_rolled) {
#pragma unroll
      for (int n1 = 2; n1 < 6; ++n1) v[n1] = make_float2(0.f, 0.f);
      v[6] = load(a);
      v[7] = load(a + stride);
      v[0] = load(a + 2 * stride);
      v[1] = load(a + 3 * stride);
    } else {
#pragma unroll
      for (int n1 = 0; n1 < 8; ++n1) v[n1] = load(a + n1 * stride);
    }
    small_dft<8>(v, inv != 0);
    const float sg = inv ? -1.f : 1.f;
#pragma unroll
    for (int k1 = 1; k1 < 8; ++k1) {
      const float2 w = __ldg(&TW[(k1 - 1) * M + n2]);
      v[k1] = cmul(v[k1], make_float2(w.x, sg * w.y));
    }
  }
  if (!kRows) {
    if (g < total) {
#pragma unroll
      for (int k1 = 0; k1 < 8; ++k1) {
        const long o = (q * 8 + k1) * L + l;
        tr[o] = v[k1].x;
        ti[o] = v[k1].y;
      }
    }
    return;
  }
  // L == 1: the block's outputs are T[8 g0 .. 8 g0 + 2048), thread t's
  // at 8 t + k1
  __shared__ float sr[kFourStage], si[kFourStage];
#pragma unroll
  for (int k1 = 0; k1 < 8; ++k1) {
    const int s = 8 * t + k1;
    sr[s + (s >> 5)] = v[k1].x;
    si[s + (s >> 5)] = v[k1].y;
  }
  __syncthreads();
  const long o0 = (long)blockIdx.x * kFourThreads * 8, end = 8 * total;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int s = t + j * kFourThreads;
    if (o0 + s < end) {
      tr[o0 + s] = sr[s + (s >> 5)];
      ti[o0 + s] = si[s + (s >> 5)];
    }
  }
}

// The four-step's twiddles exp(-2 pi i n2 k1 / N), k1 = 1..7, n2 < M = N/8,
// at [k1 - 1][n2] (7 M entries), in float64, rounded once.
__global__ void four_twiddle_kernel(float2* __restrict__ T, int N) {
  const int M = N / 8;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= 7 * M) return;
  const int k1 = e / M + 1, n2 = e - (k1 - 1) * M;
  double sn, cs;
  sincospi(-2.0 * ((double)n2 * k1) / N, &sn, &cs);
  T[e] = make_float2((float)cs, (float)sn);
}

}  // namespace pfbt

// The four-step's first step on a (P, Nin, L) stack (Nin = N, or N/2 when
// in_rolled) into T (P, N/8, 8, L); N % 8 == 0, TW the table of
// pfbt_four_twiddles at N.
extern "C" int pfbt_cfft_four(const float* xr, const float* xi, float* tr,
                              float* ti, int P, int L, int N, int in_rolled,
                              int inverse, const void* TW, void* stream) {
  if (P < 1 || L < 1 || N < 8 || N % 8 || !xr || !tr || !ti || !TW)
    return static_cast<int>(cudaErrorInvalidValue);
  const int M = N / 8;
  const long total = (long)P * M * L;
  const long blocks = (total + pfbt::kFourThreads - 1) / pfbt::kFourThreads;
  if (blocks > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  const float2* T = static_cast<const float2*>(TW);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L == 1)
    pfbt::four_step_kernel<true><<<(unsigned)blocks, pfbt::kFourThreads, 0,
                                   s>>>(xr, xi, tr, ti, total, M, L,
                                        in_rolled, inverse, T);
  else
    pfbt::four_step_kernel<false><<<(unsigned)blocks, pfbt::kFourThreads, 0,
                                    s>>>(xr, xi, tr, ti, total, M, L,
                                         in_rolled, inverse, T);
  return static_cast<int>(cudaGetLastError());
}

// The four-step's twiddle table at N (7 N/8 float2 entries) into T.
extern "C" int pfbt_four_twiddles(int N, void* T, void* stream) {
  if (N < 8 || N % 8) return static_cast<int>(cudaErrorInvalidValue);
  const int n = 7 * (N / 8), threads = 256;
  pfbt::four_twiddle_kernel<<<(n + threads - 1) / threads, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<float2*>(T), N);
  return static_cast<int>(cudaGetLastError());
}
