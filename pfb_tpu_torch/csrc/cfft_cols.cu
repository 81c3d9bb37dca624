// K3's strided x pass at N >= 256: a column FFT over a thread-block
// cluster (from 2048) or a block (below).
//
// Replaces pfb_tpu/ops/pallas_cfft.py:fftx_c2c (Pallas _kx_kernel) along
// axis -2 of a (P, Nin, L) float32 re/im stack where L > 1 and N >= 256
// (ops/cfft.py:cluster_route), with in_rolled / out_rolled as cfft.cu
// absorbs them: forward e^-, inverse e^+, no 1/N.
//
// What bounds it on the H100: bytes, 8 P (Nin L + Nout L), each input
// read once and each output written once. line_fft_kernel
// (fft_lines.cuh) keeps whole lines of N in one block's shared memory,
// so at N = 8192 a block takes one column and a warp's load uses 4
// bytes of each 32-byte sector: a copy with its load/store loops alone
// costs 7.2x a contiguous copy of the same bytes
// (scripts/torch_g2i_lab.py). Here N = C M, and a cluster of C blocks
// takes a tile of W adjacent columns of one plane, so every row segment
// it moves is W floats of re and W of im (one full sector each at W =
// 8):
//   1. block c loads rows n = c + C m (m < M) of the tile with 16-byte
//      loads into W shared-memory lines of M, lanes 0-15 of a warp on 16
//      consecutive m so that the stores into the lines do not conflict;
//      in_rolled reads element i < N/2 at n = (i - N/4) mod N and writes
//      zeros in the other rows;
//   2. block_fft (fft_lines.cuh) transforms the W lines: Y_c[k1];
//   3. after cluster.sync(), block c' takes k1 in its slice of M/C,
//      reads Y_c[k1] of every block c of the cluster through distributed
//      shared memory, multiplies by W_N^{c k1} (a float64 table rounded
//      once to float32, conjugated for the inverse) and finishes with a
//      C-point DFT in registers:
//        X[k1 + M k2] = sum_c W_C^{c k2} W_N^{c k1} Y_c[k1];
//      a thread holds four adjacent columns and writes each output row
//      with one 16-byte store of re and one of im; out_rolled writes
//      only the rows (k + N/4) mod N < N/2, half of the k2;
//   4. a second cluster.sync() keeps every block's shared memory alive
//      until its peers have read it.
// No HBM intermediate and no transpose pass. The skeleton instance
// (kFFT = false, the lab's) keeps the loads, the exchange and the stores
// and compiles the FFT passes, the twiddles and the C-point DFT out: it
// writes X[k1 + M c] = x[c + C k1]. At 2048 <= N < 4096 (four or more
// columns a block of the line kernel, 16-byte row segments, half of each
// sector) the same design takes clusters of kShortClusters blocks
// (psf_cols.cuh), M = 512-768 at C = 4.
//
// Short columns (256 <= N < 2048: the w-plane grids of the 128-aligned
// images from 128^2 to 768^2 and the PSF grids up to 384^2, before this
// on line_fft_kernel): a whole column fits one block, so the kernel runs
// on clusters of tiny_clusters(N) blocks (psf_cols.cuh: one where one
// block's tile is 8 columns, N = 768-1024, and there step 3 reads the
// block's own shared memory, the C-point DFT is the identity and the
// cluster syncs are __syncthreads; else kTinyClusters = 2) and tiles of
// W = cols_tile_width(N, C) columns, up to 32 (32 at N = 256 and 512, 8
// at 768-1536), so that a block holds 4096-8192 values and a row segment
// is 32-128 bytes of re and of im in 16-byte loads and stores.
// line_fft_kernel takes 8192 / N adjacent columns a block there with
// 4-byte loads, one pass of shared memory a radix pass as here. What
// bounds the kernel is still the bytes, but a pass of (9, 512^2) moves
// 28 MB, 8 us at the HBM rate, so the launch and the latency of one
// load -> FFT -> store round of a block set a floor near it.
//
// Long columns (K3cl, the lab's: 16384 < N <= 32768 with N / 8 5-smooth;
// ops/cfft.py:fftx_c2c_cluster_long): the same kernel on clusters of 8
// and tiles of W = 4 lines of M = N / 8 (2304-4096, 74-131 KB of shared
// memory, one block an SM), one read and one write a pass. Its Stockham
// passes left it level with or slower than the four-step (cfft_four.cu,
// then this kernel at M on 8 L columns, two reads and two writes) on the
// H100, so no route takes it; cfft_cols_long.cu (K3xl) does these lines
// by the register row FFT instead (PERF.md).
#include <cooperative_groups.h>

#include "fft_lines.cuh"
#include "psf_cols.cuh"

namespace cg = cooperative_groups;

namespace pfbt {

constexpr int kChunk = 4;  // adjacent columns a thread loads and stores

// W_N^e = exp(-2 pi i e / N) for e < N, in float64, rounded once
__global__ void cols_twiddle_kernel(float2* __restrict__ T, int N) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < N) {
    double sn, cs;
    sincospi(-2.0 * e / N, &sn, &cs);
    T[e] = make_float2((float)cs, (float)sn);
  }
}

// One cluster of C blocks per tile of W columns (W a multiple of 4) of
// one plane; p is the plan of M = N / C (W lines in shared memory), VPT
// values a thread, MINB blocks an SM (registers for MINB blocks of MAXT
// threads); vec: L % 4 == 0 and 16-byte aligned pointers (float4 loads
// and stores).
template <int C, int VPT, int MAXT, int MINB, bool kFFT>
__global__ void __launch_bounds__(MAXT, MINB)
cols_fft_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                float* __restrict__ yr, float* __restrict__ yi, int L,
                int Nin, int Nout, int in_rolled, int out_rolled, int inv,
                int W, int vec, LinePlan p, const float2* __restrict__ TN) {
  extern __shared__ float2 sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();
  const int M = p.N, N = C * M;
  const FastDiv fg(W / kChunk);
  const int ntile = (L + W - 1) / W;
  const int tile = blockIdx.x / C;
  const int b = tile / ntile;
  const int j0 = (tile - b * ntile) * W;
  const float* xrb = xr + (long)b * Nin * L;
  const float* xib = xi ? xi + (long)b * Nin * L : nullptr;

  // 1. rows n = c + C m of the tile into lines s = 0..W-1 of M; a
  // thread issues all kU of its loads before it stores any
  constexpr int kU = VPT / kChunk;
  const int units = ((M + 15) >> 4) * fg.d * 16;
  for (int u0 = 0; u0 < units; u0 += kU * blockDim.x) {
    float re[kU][kChunk], im[kU][kChunk];
    int slot[kU];
#pragma unroll
    for (int h = 0; h < kU; ++h) {
      const int u = u0 + h * blockDim.x + threadIdx.x;
      const int q = u >> 4;
      const int g = fg.mod(q), m = fg.div(q) * 16 + (u & 15);
      const int j = j0 + kChunk * g;
      int i = c + C * m;
      if (in_rolled) i = (i + N / 4) % N;  // element i sits at n
      slot[h] = (u < units && m < M) ? kChunk * g * M + m : -1;
#pragma unroll
      for (int t = 0; t < kChunk; ++t) re[h][t] = im[h][t] = 0.f;
      if (slot[h] < 0 || i >= Nin || j >= L) continue;
      const long a = (long)i * L + j;
      if (vec) {
        const float4 r4 = __ldg(reinterpret_cast<const float4*>(xrb + a));
        re[h][0] = r4.x; re[h][1] = r4.y; re[h][2] = r4.z; re[h][3] = r4.w;
        if (xib) {
          const float4 i4 = __ldg(reinterpret_cast<const float4*>(xib + a));
          im[h][0] = i4.x; im[h][1] = i4.y; im[h][2] = i4.z;
          im[h][3] = i4.w;
        }
      } else {
#pragma unroll
        for (int t = 0; t < kChunk; ++t)
          if (j + t < L) {
            re[h][t] = xrb[a + t];
            if (xib) im[h][t] = xib[a + t];
          }
      }
    }
#pragma unroll
    for (int h = 0; h < kU; ++h)
      if (slot[h] >= 0) {
#pragma unroll
        for (int t = 0; t < kChunk; ++t)
          sm[spad(slot[h] + t * M)] = make_float2(re[h][t], im[h][t]);
      }
  }
  __syncthreads();

  // 2. Y_c = the M-point DFTs of the lines
  if (kFFT) block_fft<VPT>(sm, W, p, inv != 0);
  cluster_sync<C>(cluster);

  // 3. block c' finishes k1 in [c' Mc, (c' + 1) Mc) for every column
  const float2* src[C];
#pragma unroll
  for (int r = 0; r < C; ++r)
    src[r] = C == 1 ? sm : cluster.map_shared_rank(sm, r);
  const int Mc = (M + C - 1) / C;
  const int pairs = ((Mc + 15) >> 4) * fg.d * 16;
  const float sg = inv ? -1.f : 1.f;
  for (int u = threadIdx.x; u < pairs; u += blockDim.x) {
    const int q = u >> 4;
    const int g = fg.mod(q), kl = fg.div(q) * 16 + (u & 15);
    const int k1 = c * Mc + kl;
    const int j = j0 + kChunk * g;
    if (kl >= Mc || k1 >= M || j >= L) continue;
    float2 v[kChunk][C];
#pragma unroll
    for (int r = 0; r < C; ++r) {
      float2 w = make_float2(1.f, 0.f);
      if (kFFT && r > 0) {
        const float2 t = __ldg(&TN[r * k1]);
        w = make_float2(t.x, sg * t.y);
      }
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        const float2 y = src[r][spad((kChunk * g + t) * M + k1)];
        v[t][r] = (kFFT && r > 0) ? cmul(y, w) : y;
      }
    }
    if (kFFT) {
#pragma unroll
      for (int t = 0; t < kChunk; ++t) small_dft<C>(v[t], inv != 0);
    }
#pragma unroll
    for (int k2 = 0; k2 < C; ++k2) {
      int r = k1 + M * k2;
      if (out_rolled) {
        r = (r + N / 4) % N;  // X[k] goes to row (k + N/4) mod N
        if (r >= N / 2) continue;
      }
      const long a = ((long)b * Nout + r) * L + j;
      if (vec) {
        *reinterpret_cast<float4*>(yr + a) = make_float4(
            v[0][k2].x, v[1][k2].x, v[2][k2].x, v[3][k2].x);
        *reinterpret_cast<float4*>(yi + a) = make_float4(
            v[0][k2].y, v[1][k2].y, v[2][k2].y, v[3][k2].y);
      } else {
#pragma unroll
        for (int t = 0; t < kChunk; ++t)
          if (j + t < L) {
            yr[a + t] = v[t][k2].x;
            yi[a + t] = v[t][k2].y;
          }
      }
    }
  }
  // 4. no block leaves while a peer may still read its shared memory
  cluster_sync<C>(cluster);
}

template <int C, int VPT, int MAXT, int MINB>
static cudaError_t launch_cols(const float* xr, const float* xi, float* yr,
                               float* yi, int B, int L, int Nin, int Nout,
                               int in_rolled, int out_rolled, int inv, int W,
                               int vec, int skeleton, const LinePlan& p,
                               const float2* TN, unsigned threads,
                               size_t smem, cudaStream_t stream) {
  void (*kernel)(const float*, const float*, float*, float*, int, int, int,
                 int, int, int, int, int, LinePlan, const float2*) =
      skeleton ? cols_fft_kernel<C, VPT, MAXT, MINB, false>
               : cols_fft_kernel<C, VPT, MAXT, MINB, true>;
  return launch_cluster(kernel, C, (long)B * ((L + W - 1) / W) * C,
                        threads, smem, stream, xr, xi, yr, yi, L, Nin, Nout,
                        in_rolled, out_rolled, inv, W, vec, p, TN);
}

// Two blocks an SM (2 kVpt values a thread, half the threads, registers
// for two) where the tile is 8 columns wide or fills the block (M W =
// kLineElems); else one block an SM, kVpt values a thread. On the H100
// (scripts/torch_g2i_lab.py, PERF.md) two blocks took 10-24% less time
// at W = 8 (N = 4096, 6144, 8192) and 6-14% less at N = 16384 (W = 4,
// 8192 values); one block 33-38% less at N = 12288 (W = 4, 6144 values)
// and 6-25% less at W = 4 with 4096 values. Below kShortNX (a whole
// column in the block) kVpt values a thread and registers for
// kTinyColsMinBlocks blocks of kThreads: a block's work is short there,
// and warps resident on an SM hide the latency of its loads.
static inline bool two_blocks_an_sm(int M, int W) {
  return W == 8 || M * W == kLineElems;
}

template <int C>
static cudaError_t launch_cols_c(const float* xr, const float* xi,
                                 float* yr, float* yi, int B, int L, int Nin,
                                 int Nout, int in_rolled, int out_rolled,
                                 int inv, int W, int vec, int skeleton,
                                 const LinePlan& p, const float2* TN,
                                 cudaStream_t stream) {
  const LineLaunch lc = line_launch(p.N, W);  // kVpt values a thread
  constexpr bool kShort = C == 1 || C == kTinyClusters;
  if constexpr (kShort) {
    if (C * p.N < kShortNX)
      return launch_cols<C, kVpt, kThreads, kTinyColsMinBlocks>(
          xr, xi, yr, yi, B, L, Nin, Nout, in_rolled, out_rolled, inv, W,
          vec, skeleton, p, TN, lc.threads, lc.smem, stream);
  }
  // the short band's clusters take no N from kShortNX up (cluster_shape)
  if constexpr (kShort && C != 4 && C != 8 && C != kShortClusters) {
    return cudaErrorInvalidValue;
  } else {
    if constexpr (C == 8) {
      // long tiles above kMaxN: 2 kVpt values a thread, registers for one
      // block of up to kThreads
      if (p.N * W > kLineElems)
        return launch_cols<C, 2 * kVpt, kThreads, 1>(
            xr, xi, yr, yi, B, L, Nin, Nout, in_rolled, out_rolled, inv, W,
            vec, skeleton, p, TN, lc.threads, lc.smem, stream);
    }
    if (two_blocks_an_sm(p.N, W)) {
      const unsigned threads = ((lc.threads / 2 + 31) / 32) * 32;
      return launch_cols<C, 2 * kVpt, kThreads / 2, 2>(
          xr, xi, yr, yi, B, L, Nin, Nout, in_rolled, out_rolled, inv, W,
          vec, skeleton, p, TN, threads, lc.smem, stream);
    }
    return launch_cols<C, kVpt, kThreads, 1>(
        xr, xi, yr, yi, B, L, Nin, Nout, in_rolled, out_rolled, inv, W, vec,
        skeleton, p, TN, lc.threads, lc.smem, stream);
  }
}

}  // namespace pfbt

// The x pass of a (B, Nin, L) stack on clusters of C blocks (1, 4, 8,
// kShortClusters or kTinyClusters) and tiles of W columns (4, 8, 16 or
// 32; (N / C) W <= kLineElems), as ops/cfft.py:cluster_shape picks them;
// above kMaxN (K3cl, the lab's: ops/cfft.py:cluster_long_fits) C = 8 and
// tiles of up to kLongLineElems values.
// TM is the length-(N / C) plan's table (pfbt_twiddles), TN W_N^e for e <
// N (pfbt_cols_twiddles).
// skeleton = 1 launches the lab's copy skeleton.
extern "C" int pfbt_cfft_cols(const float* xr, const float* xi, float* yr,
                              float* yi, int B, int L, int N, int Nin,
                              int Nout, int in_rolled, int out_rolled,
                              int inverse, int C, int W, int skeleton,
                              const void* TM, const void* TN, void* stream) {
  pfbt::LinePlan p;
  const bool rolled = in_rolled || out_rolled;
  if ((C != 1 && C != 4 && C != 8 && C != pfbt::kShortClusters &&
       C != pfbt::kTinyClusters) ||
      N % C != 0 || (rolled && N % 4) ||
      (W != 4 && W != 8 && W != 16 && W != 32) || L < 1 || B < 1 || !yi ||
      Nin != (in_rolled ? N / 2 : N) || Nout != (out_rolled ? N / 2 : N) ||
      (long)(N / C) * W > (C == 8 && N > pfbt::kMaxN ? pfbt::kLongLineElems
                                                     : pfbt::kLineElems) ||
      !pfbt::make_plan(N / C, TM, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = L % pfbt::kChunk == 0 && pfbt::aligned16(xr) &&
                  pfbt::aligned16(xi) && pfbt::aligned16(yr) &&
                  pfbt::aligned16(yi);
  const float2* T = static_cast<const float2*>(TN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto launch =
      C == 8   ? pfbt::launch_cols_c<8>
      : C == 4 ? pfbt::launch_cols_c<4>
      : C == pfbt::kShortClusters ? pfbt::launch_cols_c<pfbt::kShortClusters>
      : C == pfbt::kTinyClusters  ? pfbt::launch_cols_c<pfbt::kTinyClusters>
                                  : pfbt::launch_cols_c<1>;
  return static_cast<int>(launch(xr, xi, yr, yi, B, L, Nin, Nout, in_rolled,
                                 out_rolled, inverse, W, vec, skeleton, p, T,
                                 s));
}

// The table W_N^e = exp(-2 pi i e / N), e < N (N float2 entries), into T.
extern "C" int pfbt_cols_twiddles(int N, void* T, void* stream) {
  if (N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  pfbt::cols_twiddle_kernel<<<(N + threads - 1) / threads, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<float2*>(T), N);
  return static_cast<int>(cudaGetLastError());
}
