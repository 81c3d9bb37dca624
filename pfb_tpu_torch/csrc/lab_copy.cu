// Memory-pattern probes for the x pass: copies of a (P, N, N) float32
// stack (or two, read side by side as K3 reads re and im) that move what
// an x pass moves, in four access patterns, with no arithmetic.
//
// Replaces the copy kernels of scripts/wl_g2i_lab.py: k_skel (:213),
// f_single (:300), f_row (:323), f_split (:357) and f_batch (:380).
//   strip     a block takes S adjacent columns of one plane, reads all N
//             rows into shared memory with K3's load loop and slot map
//             (fft_lines.cuh: line_fft_kernel, spad) and writes the first
//             N/2 rows: out (P, N/2, N). f_single, and k_skel on re + im.
//   rows      a block takes S contiguous full rows of one plane, stages
//             each row in shared memory and writes its first N/2
//             columns: out (P, N, N/2). f_row.
//   relayout  as rows, through 32 x 32 tiles stored transposed in shared
//             memory and read back (the relayout a four-step x pass
//             needs), adding 1 as f_split's body does: out (P, N, N/2).
//   batched   as strip, one block for the same S columns of all P planes.
//             f_batch.
// Every mode reads the whole input once and writes its output once, and
// stages what it reads in shared memory, as the TPU kernels stage it in
// VMEM (a load whose value is never used would be dropped). What bounds
// them: the bytes, at best; a warp of the strip modes touches 32 rows, one
// 32-byte sector each, of which it uses S floats (S = 1 at N = 8192), so
// they show what K3's strided load and store loops cost before any FFT.
#include "fft_lines.cuh"

namespace pfbt {

enum CopyMode { kCopyStrip = 0, kCopyRows = 1, kCopyRelayout = 2,
                kCopyBatched = 3 };

template <int MODE>
__global__ void lab_copy_kernel(const float* __restrict__ x0,
                                const float* __restrict__ x1,
                                float* __restrict__ y0,
                                float* __restrict__ y1, int P, int N,
                                int S) {
  extern __shared__ float cbuf[];
  const int H = N / 2;
  const size_t NN = (size_t)N * N;
  const int nst = x1 ? 2 : 1;
  if (MODE == kCopyStrip || MODE == kCopyBatched) {
    const int j0 = blockIdx.x * S;
    const int p0 = MODE == kCopyStrip ? blockIdx.y : 0;
    const int np = MODE == kCopyStrip ? 1 : P;
    const int slots = S * N + (S * N >> 5) + 1;
    for (int q = 0; q < np; ++q) {
      float* b0 = cbuf + (size_t)nst * q * slots;
      const size_t off = (size_t)(p0 + q) * NN + j0;
      for (int t = threadIdx.x; t < S * N; t += blockDim.x) {
        const int s = t % S, i = t / S;
        const size_t a = off + (size_t)i * N + s;
        b0[spad(s * N + i)] = x0[a];
        if (x1) b0[slots + spad(s * N + i)] = x1[a];
      }
    }
    __syncthreads();
    for (int q = 0; q < np; ++q) {
      const float* b0 = cbuf + (size_t)nst * q * slots;
      const size_t off = (size_t)(p0 + q) * H * N + j0;
      for (int t = threadIdx.x; t < S * H; t += blockDim.x) {
        const int s = t % S, r = t / S;
        const size_t a = off + (size_t)r * N + s;
        y0[a] = b0[spad(s * N + r)];
        if (x1) y1[a] = b0[slots + spad(s * N + r)];
      }
    }
  } else if (MODE == kCopyRows) {
    const int p = blockIdx.y;
    for (int i = blockIdx.x * S; i < (blockIdx.x + 1) * S; ++i) {
      const float4* src0 = reinterpret_cast<const float4*>(x0 + p * NN +
                                                           (size_t)i * N);
      const float4* src1 = reinterpret_cast<const float4*>(
          x1 ? x1 + p * NN + (size_t)i * N : nullptr);
      float4* b = reinterpret_cast<float4*>(cbuf);
      for (int c = threadIdx.x; c < N / 4; c += blockDim.x) {
        b[c] = src0[c];
        if (x1) b[N / 4 + c] = src1[c];
      }
      __syncthreads();
      float4* dst0 = reinterpret_cast<float4*>(y0 + (p * (size_t)N + i) * H);
      float4* dst1 = reinterpret_cast<float4*>(
          x1 ? y1 + (p * (size_t)N + i) * H : nullptr);
      for (int c = threadIdx.x; c < H / 4; c += blockDim.x) {
        dst0[c] = b[c];
        if (x1) dst1[c] = b[N / 4 + c];
      }
      __syncthreads();
    }
  } else {
    // 32 x 32 tiles, a block of 32 x 8 threads: each tile is stored
    // transposed (tile[c][r] = x[r][c]), read back across the threads
    // (thread tx then holds column c0 + r of row r0 + tx: the four-step
    // relayout), stored in row order in tile2 with 1 added and written
    // out; tiles past the first N/2 columns are only read
    float(*tile)[33] = reinterpret_cast<float(*)[33]>(cbuf);
    float(*tile2)[33] = tile + 32;
    const int p = blockIdx.y;
    const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
    for (int r0 = blockIdx.x * S; r0 < (blockIdx.x + 1) * S; r0 += 32)
      for (int c0 = 0; c0 < N; c0 += 32)
        for (int c = 0; c < nst; ++c) {
          const float* x = (c ? x1 : x0) + p * NN;
          for (int r = ty; r < 32; r += 8)
            tile[tx][r] = x[(size_t)(r0 + r) * N + c0 + tx];
          __syncthreads();
          if (c0 < H) {  // uniform across the block
            for (int r = ty; r < 32; r += 8) tile2[tx][r] = tile[r][tx] + 1.0f;
            __syncthreads();
            float* y = (c ? y1 : y0) + p * (size_t)N * H;
            for (int r = ty; r < 32; r += 8)
              y[(size_t)(r0 + r) * H + c0 + tx] = tile2[r][tx];
          }
          __syncthreads();
        }
  }
}

// Shared memory and threads of a mode's block.
static inline void copy_shape(int mode, int P, int N, int S, int nst,
                              size_t* smem, int* threads) {
  if (mode == kCopyStrip || mode == kCopyBatched) {
    const size_t slots = (size_t)S * N + (S * N >> 5) + 1;
    *smem = sizeof(float) * nst * slots * (mode == kCopyBatched ? P : 1);
    const LineLaunch c = line_launch(N, S);
    *threads = c.threads;
  } else if (mode == kCopyRows) {
    *smem = sizeof(float) * (size_t)N * nst;
    *threads = 256;
  } else {
    *smem = sizeof(float) * 2 * 32 * 33;
    *threads = 256;
  }
}

template <int MODE>
static cudaError_t launch_copy(const float* x0, const float* x1, float* y0,
                               float* y1, int P, int N, int S, size_t smem,
                               int threads, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      lab_copy_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(N / S, MODE == kCopyBatched ? 1 : P);
  lab_copy_kernel<MODE><<<grid, threads, smem, stream>>>(x0, x1, y0, y1, P,
                                                          N, S);
  return cudaGetLastError();
}

}  // namespace pfbt

// One copy probe of x0 (and x1 when not null) (P, N, N) into y0 (y1):
// mode 0 strip, 1 rows, 2 relayout, 3 batched; S columns (strip,
// batched) or rows (rows, relayout) per block, dividing N (a multiple of
// 32 for relayout). Returns a CUDA error code.
extern "C" int pfbt_lab_copy(const float* x0, const float* x1, float* y0,
                             float* y1, int mode, int P, int N, int S,
                             void* stream) {
  using namespace pfbt;
  if (P < 1 || N < 64 || N % 64 || S < 1 || N % S || mode < 0 || mode > 3 ||
      ((mode == kCopyStrip || mode == kCopyBatched) &&
       (long)S * N > 2L * kLineElems) ||
      (mode == kCopyRelayout && S % 32))
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem;
  int threads;
  copy_shape(mode, P, N, S, x1 ? 2 : 1, &smem, &threads);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kCopyStrip:
      return static_cast<int>(
          launch_copy<kCopyStrip>(x0, x1, y0, y1, P, N, S, smem, threads, s));
    case kCopyRows:
      return static_cast<int>(
          launch_copy<kCopyRows>(x0, x1, y0, y1, P, N, S, smem, threads, s));
    case kCopyRelayout:
      return static_cast<int>(launch_copy<kCopyRelayout>(
          x0, x1, y0, y1, P, N, S, smem, threads, s));
    default:
      return static_cast<int>(launch_copy<kCopyBatched>(
          x0, x1, y0, y1, P, N, S, smem, threads, s));
  }
}
