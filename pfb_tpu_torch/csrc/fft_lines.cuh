// Batched complex DFTs along one axis, one line per shared-memory row.
//
// Shared by cfft.cu (w-plane transforms) and psf_conv.cu (PSF-Hessian
// convolution). A line of length N (any product of 2, 3 and 5 up to
// kMaxN) is transformed in place in shared memory by a mixed-radix
// Stockham FFT (radix 16 first, then one pass of 8, 4 or 2, then 3s and
// 5s), which leaves the spectrum in natural order. Each pass reads every
// element of the block's lines into registers, synchronises, and writes
// the butterflies' outputs back, so one shared buffer serves all passes.
// Radix 16 (a 4 x 4 FFT in registers) takes N = 4096 in three passes.
//
// A block holds up to kLineElems complex values (64 KB, plus one float2
// of padding after every 32 so that the strided stores of the early
// passes spread over the banks) and each thread kVpt of them, so a
// block has 512 threads. The launch bounds name only the block size:
// ptxas then gives a thread 64 registers (two blocks per SM), which
// timed faster on the H100 than 128 registers at one block per SM.
//
// Each pass multiplies by its own twiddles exp(-2 pi i q k / (Ns R)),
// stored [q][k] so that neighbouring threads read neighbouring entries.
// The table (N - 1 entries for all passes of a length-N plan) is made
// on the device by cfft.cu's twiddle_kernel in float64 with sincospi
// and rounded once to float32; the inverse transform conjugates it.
#pragma once

#include <cuda_runtime.h>

namespace pfbt {

constexpr int kMaxPass = 21;      // 3 bits a pass in `codes`
constexpr int kMaxN = 16384;
constexpr int kLineElems = 8192;  // S * N per block (S lines of length N)
// a tile of the cluster column kernel above kMaxN (cfft_cols.cu: W = 4
// lines of M = N / 8 <= 4096), one block an SM
constexpr int kLongLineElems = 2 * kLineElems;
constexpr int kVpt = 16;          // values per thread at kLineElems
constexpr int kThreads = kLineElems / kVpt;

// The radix of pass i sits in bits 3i..3i+2 of `codes` (0: 16, 1: 8,
// 2: 4, 3: 2, 4: 3, 5: 5), so the plan is a few scalars.
struct LinePlan {
  int N, npass;
  unsigned long long codes;
  const float2* T;  // pass twiddles (twiddle_kernel), device memory
};

__host__ __device__ __forceinline__ int radix_of(unsigned code) {
  switch (code) {
    case 0: return 16;
    case 1: return 8;
    case 2: return 4;
    case 3: return 2;
    case 4: return 3;
    default: return 5;
  }
}

// shared-memory slot of element i of the block's lines
__device__ __forceinline__ int spad(int i) { return i + (i >> 5); }

__host__ __device__ __forceinline__ size_t smem_bytes(int elems) {
  return (size_t)(elems + (elems >> 5) + 1) * sizeof(float2);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// exp(-2 pi i m / 16), conjugated for the inverse; m is a compile-time
// constant after unrolling, so the tables fold away
__device__ __forceinline__ float2 w16(int m, bool inv) {
  constexpr float c[16] = {
      1.f,          0.92387953f,  0.70710678f,  0.38268343f,
      0.f,          -0.38268343f, -0.70710678f, -0.92387953f,
      -1.f,         -0.92387953f, -0.70710678f, -0.38268343f,
      0.f,          0.38268343f,  0.70710678f,  0.92387953f};
  constexpr float s[16] = {
      0.f,          0.38268343f,  0.70710678f,  0.92387953f,
      1.f,          0.92387953f,  0.70710678f,  0.38268343f,
      0.f,          -0.38268343f, -0.70710678f, -0.92387953f,
      -1.f,         -0.92387953f, -0.70710678f, -0.38268343f};
  return make_float2(c[m & 15], inv ? s[m & 15] : -s[m & 15]);
}

// (cos, sin) of 2 pi e / R for the odd radices
template <int R>
__device__ __forceinline__ float2 unit_root(int e) {
  if (R == 3) {
    constexpr float c[3] = {1.f, -0.5f, -0.5f};
    constexpr float s[3] = {0.f, 0.86602540378443865f,
                            -0.86602540378443865f};
    return make_float2(c[e], s[e]);
  }
  constexpr float c[5] = {1.f, 0.30901699437494742f, -0.80901699437494742f,
                          -0.80901699437494742f, 0.30901699437494742f};
  constexpr float s[5] = {0.f, 0.95105651629515357f, 0.58778525229247313f,
                          -0.58778525229247313f, -0.95105651629515357f};
  return make_float2(c[e], s[e]);
}

// in-register DFT of R values, forward e^- (inv: e^+)
template <int R>
__device__ __forceinline__ void small_dft(float2* v, bool inv) {
  if (R == 1) {
    // the C-point DFT of a cluster of one block (cfft_cols.cu, psf_cols.cu)
  } else if (R == 2) {
    const float2 a = v[0], b = v[1];
    v[0] = make_float2(a.x + b.x, a.y + b.y);
    v[1] = make_float2(a.x - b.x, a.y - b.y);
  } else if (R == 4) {
    const float2 a = v[0], b = v[1], c = v[2], d = v[3];
    const float2 s0 = make_float2(a.x + c.x, a.y + c.y);
    const float2 s1 = make_float2(a.x - c.x, a.y - c.y);
    const float2 s2 = make_float2(b.x + d.x, b.y + d.y);
    // -i (b - d) forward, +i (b - d) inverse
    const float2 bd = make_float2(b.x - d.x, b.y - d.y);
    const float2 s3 =
        inv ? make_float2(-bd.y, bd.x) : make_float2(bd.y, -bd.x);
    v[0] = make_float2(s0.x + s2.x, s0.y + s2.y);
    v[1] = make_float2(s1.x + s3.x, s1.y + s3.y);
    v[2] = make_float2(s0.x - s2.x, s0.y - s2.y);
    v[3] = make_float2(s1.x - s3.x, s1.y - s3.y);
  } else if (R == 8) {
    // even and odd halves by radix 4, then one radix-2 step
    float2 e[4] = {v[0], v[2], v[4], v[6]};
    float2 o[4] = {v[1], v[3], v[5], v[7]};
    small_dft<4>(e, inv);
    small_dft<4>(o, inv);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 t = k == 0 ? o[k] : cmul(o[k], w16(2 * k, inv));
      v[k] = make_float2(e[k].x + t.x, e[k].y + t.y);
      v[k + 4] = make_float2(e[k].x - t.x, e[k].y - t.y);
    }
  } else if (R == 16) {
    // 4 x 4: n = 4 n1 + n2, k = k1 + 4 k2
    float2 a[4][4];
#pragma unroll
    for (int n2 = 0; n2 < 4; ++n2) {
#pragma unroll
      for (int n1 = 0; n1 < 4; ++n1) a[n2][n1] = v[4 * n1 + n2];
      small_dft<4>(a[n2], inv);
#pragma unroll
      for (int k1 = 1; k1 < 4; ++k1)
        if (n2 > 0) a[n2][k1] = cmul(a[n2][k1], w16(n2 * k1, inv));
    }
#pragma unroll
    for (int k1 = 0; k1 < 4; ++k1) {
      float2 b[4] = {a[0][k1], a[1][k1], a[2][k1], a[3][k1]};
      small_dft<4>(b, inv);
#pragma unroll
      for (int k2 = 0; k2 < 4; ++k2) v[k1 + 4 * k2] = b[k2];
    }
  } else {
    // direct DFT for the odd radices 3 and 5
    const float sg = inv ? 1.f : -1.f;
    float2 in[R];
#pragma unroll
    for (int q = 0; q < R; ++q) in[q] = v[q];
#pragma unroll
    for (int m = 0; m < R; ++m) {
      float2 acc = make_float2(0.f, 0.f);
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const float2 u = unit_root<R>((q * m) % R);
        const float2 w = make_float2(u.x, sg * u.y);
        acc.x += in[q].x * w.x - in[q].y * w.y;
        acc.y += in[q].x * w.y + in[q].y * w.x;
      }
      v[m] = acc;
    }
  }
}

// a / d and a % d, with a shift when d is a power of two
struct FastDiv {
  int d, shift;
  __device__ __forceinline__ explicit FastDiv(int d_) : d(d_), shift(0) {
    while ((1 << shift) < d_) ++shift;
    if ((1 << shift) != d_) shift = -1;
  }
  __device__ __forceinline__ int div(int a) const {
    return shift >= 0 ? a >> shift : a / d;
  }
  __device__ __forceinline__ int mod(int a) const { return a - div(a) * d; }
};

// One Stockham pass of radix R over the S lines at sm (line s at
// element s*N); Ns is the product of the radices already applied and
// T[(q - 1) Ns + k] = exp(-2 pi i q k / (Ns R)) this pass's twiddles.
template <int R, int VPT>
__device__ __forceinline__ void stockham_pass(float2* sm, int S, int N,
                                              const float2* __restrict__ T,
                                              int Ns, bool inv) {
  constexpr int BMAX = (VPT + R - 1) / R;
  const FastDiv nb(N / R), ns(Ns);
  const int total = S * nb.d;
  float2 v[BMAX][R];
#pragma unroll
  for (int b = 0; b < BMAX; ++b) {
    const int bf = threadIdx.x + b * blockDim.x;
    if (bf < total) {
      const int s = nb.div(bf);
      const int base = s * N + (bf - s * nb.d);
#pragma unroll
      for (int q = 0; q < R; ++q) v[b][q] = sm[spad(base + q * nb.d)];
    }
  }
  __syncthreads();
  const float sg = inv ? -1.f : 1.f;
#pragma unroll
  for (int b = 0; b < BMAX; ++b) {
    const int bf = threadIdx.x + b * blockDim.x;
    if (bf < total) {
      const int s = nb.div(bf);
      const int j = bf - s * nb.d;
      const int jq = ns.div(j);
      const int k = j - jq * Ns;
#pragma unroll
      for (int q = 1; q < R; ++q) {
        const float2 t = __ldg(&T[(q - 1) * Ns + k]);
        v[b][q] = cmul(v[b][q], make_float2(t.x, sg * t.y));
      }
      small_dft<R>(v[b], inv);
      const int o = s * N + jq * Ns * R + k;
#pragma unroll
      for (int q = 0; q < R; ++q) sm[spad(o + q * Ns)] = v[b][q];
    }
  }
  __syncthreads();
}

// natural -> natural DFT of S lines of length p.N in shared memory
template <int VPT>
__device__ __forceinline__ void block_fft(float2* sm, int S, LinePlan p,
                                          bool inv) {
  int Ns = 1;
  const float2* T = p.T;
  unsigned long long c = p.codes;
  for (int i = 0; i < p.npass; ++i, c >>= 3) {
    switch (c & 7ull) {
      case 0: stockham_pass<16, VPT>(sm, S, p.N, T, Ns, inv); break;
      case 1: stockham_pass<8, VPT>(sm, S, p.N, T, Ns, inv); break;
      case 2: stockham_pass<4, VPT>(sm, S, p.N, T, Ns, inv); break;
      case 3: stockham_pass<2, VPT>(sm, S, p.N, T, Ns, inv); break;
      case 4: stockham_pass<3, VPT>(sm, S, p.N, T, Ns, inv); break;
      default: stockham_pass<5, VPT>(sm, S, p.N, T, Ns, inv);
    }
    const int R = radix_of((unsigned)(c & 7ull));
    T += (R - 1) * Ns;
    Ns *= R;
  }
}

enum InMode { kInNatural = 0, kInRolled = 1, kInHermitian = 2 };
enum OutMode { kOutNatural = 0, kOutRolled = 1 };

// Transform of the lines of a (B, in_rows, L) float32 re/im stack along
// its middle axis, reading rows i < Nin <= in_rows, into a
// (B, out_rows, L) stack, writing rows r < Nout <= out_rows and zeros in
// rows Nout..out_rows-1 (the row padding of a space shard's half
// spectrum; every other caller passes in_rows = Nin, out_rows = Nout).
// Lines are (b, j) pairs taken S at a time; when L > 1 the S lines of a
// block are adjacent columns, so loads and stores are coalesced across
// the strip, and when L == 1 a line is one contiguous row.
//   in:  kInNatural   element i < Nin sits at n = i, zeros beyond
//        kInRolled    element i < N/2 sits at n = (i - N/4) mod N
//        kInHermitian element i < Nin (N/2 < Nin <= N) is X[i], and the
//                     rows past them are the conjugate mirror,
//                     X[N - i] = conj X[i] for 0 < i <= N - Nin
//   out: kOutNatural  row r < Nout is X[r]
//        kOutRolled   row r < N/2 is X[(r - N/4) mod N]
// xi == nullptr reads a real input; yi == nullptr stores the real part.
template <int VPT>
__global__ void __launch_bounds__(kThreads)
line_fft_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                float* __restrict__ yr, float* __restrict__ yi, int B,
                int L, int Nin, int in_rows, int Nout, int out_rows,
                int in_mode, int out_mode, int inv, float scale, int S,
                LinePlan p) {
  extern __shared__ float2 sm[];
  const int N = p.N;
  const int nlines = B * L;
  const int g0 = blockIdx.x * S;
  const FastDiv fs(S), fl(L), fin(Nin), fout(out_rows);

  const bool need_zero =
      in_mode == kInRolled || (in_mode == kInNatural && Nin < N);
  if (need_zero) {
    for (int i = threadIdx.x; i < S * N; i += blockDim.x)
      sm[spad(i)] = make_float2(0.f, 0.f);
    __syncthreads();
  }
  for (int t = threadIdx.x; t < S * Nin; t += blockDim.x) {
    const int s = (L == 1) ? fin.div(t) : fs.mod(t);
    const int i = (L == 1) ? fin.mod(t) : fs.div(t);
    const int g = g0 + s;
    if (g >= nlines) continue;
    const int b = fl.div(g), j = g - b * L;
    const long a = ((long)b * in_rows + i) * L + j;
    const float re = xr[a];
    const float im = xi ? xi[a] : 0.f;
    const int n = (in_mode == kInRolled) ? (i - N / 4 + N) % N : i;
    sm[spad(s * N + n)] = make_float2(re, im);
    if (in_mode == kInHermitian && i > 0 && N - i >= Nin)
      sm[spad(s * N + N - i)] = make_float2(re, -im);
  }
  __syncthreads();

  block_fft<VPT>(sm, S, p, inv != 0);

  for (int t = threadIdx.x; t < S * out_rows; t += blockDim.x) {
    const int s = (L == 1) ? fout.div(t) : fs.mod(t);
    const int r = (L == 1) ? fout.mod(t) : fs.div(t);
    const int g = g0 + s;
    if (g >= nlines) continue;
    const int b = fl.div(g), j = g - b * L;
    const int k = (out_mode == kOutRolled) ? (r - N / 4 + N) % N : r;
    const float2 v = r < Nout ? sm[spad(s * N + k)] : make_float2(0.f, 0.f);
    const long a = ((long)b * out_rows + r) * L + j;
    yr[a] = v.x * scale;
    if (yi) yi[a] = v.y * scale;
  }
}

// Radix plan for N (16s, then one 8, 4 or 2, then 3s and 5s); false if
// N has another prime factor or exceeds kMaxN.
static inline bool make_plan(int N, const void* T, LinePlan* p) {
  if (N < 2 || N > kMaxN) return false;
  p->N = N;
  p->T = static_cast<const float2*>(T);
  p->npass = 0;
  p->codes = 0;
  int m = N;
  auto push = [&](unsigned code) {
    p->codes |= (unsigned long long)code << (3 * p->npass++);
  };
  while (m % 16 == 0) {
    push(0);
    m /= 16;
  }
  if (m % 8 == 0) {
    push(1);
    m /= 8;
  } else if (m % 4 == 0) {
    push(2);
    m /= 4;
  } else if (m % 2 == 0) {
    push(3);
    m /= 2;
  }
  for (unsigned code = 4; code <= 5; ++code) {
    while (m % radix_of(code) == 0) {
      if (p->npass == kMaxPass) return false;
      push(code);
      m /= radix_of(code);
    }
  }
  return m == 1;
}

// Lines per block (by default the largest power of two with S * N <=
// kLineElems; a caller may ask for any S with S * N <= 2 kLineElems),
// values per thread (kVpt, or 2 kVpt where S * N > kLineElems), threads
// per block (a multiple of 32, at most kThreads).
struct LineLaunch {
  int S, threads, vpt;
  size_t smem;
};

static inline LineLaunch line_launch(int N, int S = 0) {
  LineLaunch c;
  c.S = 1;
  if (S > 0)
    c.S = S;
  else
    while (2 * c.S * N <= kLineElems) c.S *= 2;
  c.vpt = (c.S * N <= kLineElems) ? kVpt : 2 * kVpt;
  const int t = (c.S * N + c.vpt - 1) / c.vpt;
  c.threads = ((t + 31) / 32) * 32;
  c.smem = smem_bytes(c.S * N);
  return c;
}

template <typename K>
static inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

static inline bool aligned16(const void* a) {
  return (reinterpret_cast<unsigned long long>(a) & 15ull) == 0;
}

// Launch `kernel` on `blocks` blocks of `threads` in clusters of C along
// x, with `smem` bytes of dynamic shared memory (cfft_cols.cu,
// psf_cols.cu).
template <typename... KArgs, typename... Args>
static cudaError_t launch_cluster(void (*kernel)(KArgs...), int C,
                                  long blocks, unsigned threads, size_t smem,
                                  cudaStream_t stream, Args... args) {
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

static inline cudaError_t launch_lines(const float* xr, const float* xi,
                                       float* yr, float* yi, int B, int L,
                                       int Nin, int in_rows, int Nout,
                                       int out_rows, int in_mode,
                                       int out_mode, int inv, float scale,
                                       const LinePlan& p,
                                       cudaStream_t stream, int S = 0) {
  if (S < 0 || (long)S * p.N > 2L * kLineElems) return cudaErrorInvalidValue;
  const LineLaunch c = line_launch(p.N, S);
  const long nlines = (long)B * L;
  if (nlines > 0x7fffffffL) return cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((nlines + c.S - 1) / c.S);
  cudaError_t e;
  if (c.vpt == kVpt) {
    e = allow_smem(line_fft_kernel<kVpt>, c.smem);
    if (e != cudaSuccess) return e;
    line_fft_kernel<kVpt><<<grid, c.threads, c.smem, stream>>>(
        xr, xi, yr, yi, B, L, Nin, in_rows, Nout, out_rows, in_mode,
        out_mode, inv, scale, c.S, p);
  } else {
    e = allow_smem(line_fft_kernel<2 * kVpt>, c.smem);
    if (e != cudaSuccess) return e;
    line_fft_kernel<2 * kVpt><<<grid, c.threads, c.smem, stream>>>(
        xr, xi, yr, yi, B, L, Nin, in_rows, Nout, out_rows, in_mode,
        out_mode, inv, scale, c.S, p);
  }
  return cudaGetLastError();
}

}  // namespace pfbt
