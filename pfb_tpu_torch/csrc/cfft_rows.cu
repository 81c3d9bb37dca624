// K3r: K3's y pass, the c2c DFT along contiguous rows, as a row FFT
// whose line lives in registers.
//
// Replaces pfb_tpu/ops/pallas_cfft.py:fftx_c2c (Pallas _kx_kernel) where
// the JAX package runs it on the transposed view of a plane stack, the
// y-axis pass of fft2_c2c_pruned (pallas_cfft.py:191, 201, 210): here
// the unnormalised DFT of each of R contiguous rows of a (R, Nin)
// float32 re/im stack, with in_rolled / out_rolled as cfft.cu absorbs
// them (forward e^-, inverse e^+, no 1/N; xi == nullptr reads a real
// input). N = 256 R2 for every 5-smooth R2 from 1 to 64, 256-16384: the
// row length of every 128-aligned image from 128^2 to 8192^2 and of its
// PSF grid up to 4096^2 (ops/cfft.py:row_route); below 2048 several lines
// a block (rows_fft.cuh: rows_per_block).
//
// What bounds it on the H100: bytes, 8 R (Nin + Nout), each input read
// once and each output written once. line_fft_kernel (fft_lines.cuh)
// keeps a line of 8192 in one block of 512 threads with 64 registers
// (two lines an SM), sweeps shared memory twice per radix pass (ten
// sweeps at 8192 = 16 16 16 2), issues no HBM traffic while the line is
// transformed and transforms the known zeros of a rolled input. Here N =
// 16 R2 16 (R2 = 8-64, 5-smooth) in three Stockham stages, one line a
// block (rows_fft.cuh):
//   1. radix 16 from HBM to registers: butterfly j takes n = j + q N/16,
//      so each warp's loads are whole 128-byte segments of re and of im;
//      in_rolled reads input chunk [N/4, N/2) at n < N/4 (q < 4) and
//      chunk [0, N/4) at n >= 3N/4 (q >= 12) by offset, and the zeros at
//      q = 4..11 are never loaded, stored or multiplied (dft16<true>);
//   2. radix R2 in registers (one register DFT or a pair R2 = RA RB of
//      them), between two transposes through shared memory;
//   3. radix 16 from shared memory to HBM: output k = j + q N/16, so the
//      stores are whole segments too; out_rolled computes and stores the
//      kept rows only (q < 4 and q >= 12, dft16<..., true>).
// Two transposes through one shared buffer (N + N/16 float2, one float2
// of padding every 16 so that every access is free of bank conflicts),
// against ten sweeps. The stage twiddles W_{Ns R}^{q k} are a float64
// table rounded once to float32 (rows_twiddle_kernel), conjugated for the
// inverse. Latency is hidden by resident lines: the launch bounds ask for
// registers for four blocks an SM at 2048-4096 (a butterfly a thread in
// stages 1 and 3), two at 4608-8192 and one from 9216 (stages 1 and 3
// hold three or four butterflies a thread there; from 13824 one line's
// buffer, N + N/16 float2, leaves room for no second block anyway), so
// one block's stages run while another's loads are in flight. A persistent
// block that prefetched its next line with 1-D bulk copies
// (cp.async.bulk, an mbarrier) measured slower at every shape of the
// paths on the H100 (PERF.md) and was not kept. The
// skeleton instance (kFFT = false, the lab's) keeps the loads, the
// transposes and the stores and compiles the radix arithmetic and the
// twiddles out.
//
// Short rows (N = 256-1536, R2 = 1-6): a block of S = 16 / R2 lines, a
// stage-1 and stage-3 butterfly a thread (rows_fft.cuh), registers for
// three blocks an SM. line_fft_kernel took 8192 / N lines a block there in
// two to four shared-memory passes (N = 256 = 16 x 16: two, 1536 = 16 x 16
// x 2 x 3: four), each a read and a write of the whole buffer; here the
// same HBM traffic with two transposes (one at 256). A pass of 9 planes
// moves 2-30 MB, 1-9 us at the HBM rate, so the launch sets part of the
// floor.
#include "rows_fft.cuh"

namespace pfbt {

// One block of T = row_threads(R2) threads per S = rows_per_block(R2)
// lines of N = 16 R2 16 (line s of the block is row blockIdx.x S + s <
// rows); stage 1 and 3 have N/16 butterflies a line (B a thread), stage 2
// has 256. The table TW holds (R - 1) Ns entries per stage, [q - 1][k]
// (stage 1's are 1).
template <int N, int R2, int MINB, bool kFFT>
__global__ void __launch_bounds__(row_threads(R2), MINB)
rows_fft_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                float* __restrict__ yr, float* __restrict__ yi, int rows,
                int in_rolled, int out_rolled, int inv,
                const float2* __restrict__ TW) {
  constexpr int T = row_threads(R2);
  constexpr int S = rows_per_block(R2);
  constexpr int NB = N / 16;
  constexpr int NF = S * NB;  // stage-1 butterflies of the block
  constexpr int B = (NF + T - 1) / T;
  static_assert(16 * R2 * 16 == N, "N = 16 R2 16");
  extern __shared__ float2 sm[];
  const int t = threadIdx.x;
  const bool iv = inv != 0;
  const long Nin = in_rolled ? N / 2 : N, Nout = out_rolled ? N / 2 : N;

  // 1. radix 16 from HBM: every load of the thread issued first
  float2 v[B][16];
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int f = t + b * T;
    if (NF % T && f >= NF) continue;
    const int s = S > 1 ? f / NB : 0, j = f - s * NB;
    const long g = (long)blockIdx.x * S + s;
    if (S > 1 && g >= rows) continue;
    const float* xrl = xr + g * Nin;
    const float* xil = xi ? xi + g * Nin : nullptr;
    if (in_rolled) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int ia = j + (q + 4) * NB, ib = j + q * NB;
        v[b][q] = make_float2(xrl[ia], xil ? xil[ia] : 0.f);
        v[b][12 + q] = make_float2(xrl[ib], xil ? xil[ib] : 0.f);
      }
#pragma unroll
      for (int q = 4; q < 12; ++q) v[b][q] = make_float2(0.f, 0.f);
    } else {
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int i = j + q * NB;
        v[b][q] = make_float2(xrl[i], xil ? xil[i] : 0.f);
      }
    }
  }
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int f = t + b * T;
    if (NF % T && f >= NF) continue;
    const int s = S > 1 ? f / NB : 0, j = f - s * NB;
    if (kFFT) {
      if (in_rolled)
        dft16<true, false>(v[b], iv);
      else
        small_dft<16>(v[b], iv);
    }
#pragma unroll
    for (int q = 0; q < 16; ++q) sm[rpad(s * N + 16 * j + q)] = v[b][q];
  }
  __syncthreads();

  // 2. radix R2, Ns = 16 (none at R2 = 1)
  if constexpr (R2 > 1) {
    rows_mid<R2, T, S, kFFT>(sm, TW, iv);
    __syncthreads();
  }

  // 3. radix 16 to HBM, Ns = N / 16: butterfly j reads n = j + NB q,
  // twiddles W_N^{q j}, writes X[j + NB q]
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int f = t + b * T;
    if (NF % T && f >= NF) continue;
    const int s = S > 1 ? f / NB : 0, j = f - s * NB;
    const long g = (long)blockIdx.x * S + s;
    if (S > 1 && g >= rows) continue;
    float* yrl = yr + g * Nout;
    float* yil = yi + g * Nout;
    rows_last_load<N, R2, kFFT>(sm + s * (N + N / 16), TW, j, iv, v[b]);
    if (kFFT) {
      if (out_rolled)
        dft16<false, true>(v[b], iv);
      else
        small_dft<16>(v[b], iv);
    }
    if (out_rolled) {
      // row r holds X[(r - N/4) mod N]: X[j + q NB] (q < 4) at row
      // j + (q + 4) NB, X[j + (q + 12) NB] at row j + q NB
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int ra = j + (q + 4) * NB, rb = j + q * NB;
        yrl[ra] = v[b][q].x;
        yil[ra] = v[b][q].y;
        yrl[rb] = v[b][12 + q].x;
        yil[rb] = v[b][12 + q].y;
      }
    } else {
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int r = j + q * NB;
        yrl[r] = v[b][q].x;
        yil[r] = v[b][q].y;
      }
    }
  }
}

// The rows plan's stage twiddles exp(-2 pi i q k / (Ns R)), [q - 1][k]
// per stage (16 at Ns = 1, R2 at 16, 16 at N / 16: N - 1 entries), in
// float64, rounded once.
__global__ void rows_twiddle_kernel(float2* __restrict__ T, int N, int R2) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= N - 1) return;
  int Ns = 1, R = 16, off = 0;
  if (e >= 15 + (R2 - 1) * 16) {
    Ns = 16 * R2;
    off = 15 + (R2 - 1) * 16;
  } else if (e >= 15) {
    Ns = 16;
    R = R2;
    off = 15;
  }
  const int q = (e - off) / Ns + 1, k = (e - off) % Ns;
  double sn, cs;
  sincospi(-2.0 * q * k / ((double)Ns * R), &sn, &cs);
  T[e] = make_float2((float)cs, (float)sn);
}

template <int N, int R2, int MINB>
static cudaError_t launch_rows(const float* xr, const float* xi, float* yr,
                               float* yi, int rows, int in_rolled,
                               int out_rolled, int inv, int skeleton,
                               const float2* TW, cudaStream_t stream) {
  void (*kernel)(const float*, const float*, float*, float*, int, int, int,
                 int, const float2*) =
      skeleton ? rows_fft_kernel<N, R2, MINB, false>
               : rows_fft_kernel<N, R2, MINB, true>;
  constexpr int S = rows_per_block(R2);
  const size_t smem = (size_t)S * (N + N / 16) * sizeof(float2);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<(unsigned)((rows + S - 1) / S), row_threads(R2), smem, stream>>>(
      xr, xi, yr, yi, rows, in_rolled, out_rolled, inv, TW);
  return cudaGetLastError();
}

}  // namespace pfbt

// The y pass of a (rows, Nin) stack at N = 256 R2, R2 = 1-64 5-smooth;
// TW is the rows plan's table
// (pfbt_rows_twiddles). skeleton = 1 launches the lab's
// load/transpose/store skeleton.
extern "C" int pfbt_cfft_rows(const float* xr, const float* xi, float* yr,
                              float* yi, int rows, int N, int in_rolled,
                              int out_rolled, int inverse, int skeleton,
                              const void* TW, void* stream) {
  if (rows < 1 || !yi) return static_cast<int>(cudaErrorInvalidValue);
  const float2* T = static_cast<const float2*>(TW);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PFBT_ROWS(n, r2, minb)                                              \
  case n:                                                                   \
    return static_cast<int>(pfbt::launch_rows<n, r2, minb>(                 \
        xr, xi, yr, yi, rows, in_rolled, out_rolled, inverse, skeleton, T, \
        s));
  switch (N) {
    PFBT_ROWS(256, 1, 3)
    PFBT_ROWS(512, 2, 3)
    PFBT_ROWS(768, 3, 3)
    PFBT_ROWS(1024, 4, 3)
    PFBT_ROWS(1280, 5, 3)
    PFBT_ROWS(1536, 6, 3)
    PFBT_ROWS(2048, 8, 4)
    PFBT_ROWS(2304, 9, 4)
    PFBT_ROWS(2560, 10, 4)
    PFBT_ROWS(3072, 12, 4)
    PFBT_ROWS(3840, 15, 4)
    PFBT_ROWS(4096, 16, 4)
    PFBT_ROWS(4608, 18, 2)
    PFBT_ROWS(5120, 20, 2)
    PFBT_ROWS(6144, 24, 2)
    PFBT_ROWS(6400, 25, 2)
    PFBT_ROWS(6912, 27, 2)
    PFBT_ROWS(7680, 30, 2)
    PFBT_ROWS(8192, 32, 2)
    PFBT_ROWS(9216, 36, 1)
    PFBT_ROWS(10240, 40, 1)
    PFBT_ROWS(11520, 45, 1)
    PFBT_ROWS(12288, 48, 1)
    PFBT_ROWS(12800, 50, 1)
    PFBT_ROWS(13824, 54, 1)
    PFBT_ROWS(15360, 60, 1)
    PFBT_ROWS(16384, 64, 1)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PFBT_ROWS
}

// The rows plan's twiddle table (N - 1 float2 entries) into T.
extern "C" int pfbt_rows_twiddles(int N, void* T, void* stream) {
  if (N % 256 || N < 256 || N > 16384)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = N - 1, threads = 256;
  pfbt::rows_twiddle_kernel<<<(n + threads - 1) / threads, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<float2*>(T), N, N / 256);
  return static_cast<int>(cudaGetLastError());
}
