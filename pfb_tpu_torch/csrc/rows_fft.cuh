// Device code of the register row FFTs, N = 16 R2 16 in three Stockham
// stages, S = rows_per_block(R2) lines a block: K3r's y pass
// (cfft_rows.cu) and the PSF rows stage K10br (psf_rows.cu). Stage 1 is
// radix 16 between HBM and registers (butterfly j holds n = j + q N/16),
// stage 2 radix R2 in registers between two transposes through one padded
// shared buffer (rows_mid), stage 3 radix 16 from shared memory
// (rows_last_load) with output k = j + q N/16 in registers. Stage 2 has
// kRowBflies = 256 butterflies a line (N = 256 R2); stages 1 and 3 have
// N/16 = 16 R2. R2 is any 5-smooth radix from 1 to 64 (N = 256-16384),
// each a DFT in registers (reg_dft): 16, 8 and below directly, the others
// as a pair R2 = RA RB of smaller ones with the roots W_R2 between them;
// at R2 = 1 (N = 256 = 16 x 16) there is no stage 2. A block has
// row_threads(R2) threads.
//
// Short rows (R2 = 1-6, N = 256-1536: the y passes of the w-plane grids of
// the 128-aligned images from 128^2 to 768^2 and the rows stages of their
// PSF Hessians, before this on line_fft_kernel and psf_rows_kernel): one
// line a block would give stages 1 and 3 only 16-96 butterflies, so a
// block takes S = 16 / R2 lines (16, 8, 5, 4, 3, 2) side by side in its
// shared buffer, one stage-1 and stage-3 butterfly a thread (S 16 R2 =
// 192-256 threads) and 16 / R2 stage-2 butterflies, the last round of
// R2 = 3, 5 and 6 partly idle (89%, 80%, 89% busy). A line's arithmetic is
// the same whichever slot of the block it takes, so K10's row shards stay
// bitwise K1. The stage twiddles W_{Ns R}^{q k} come from
// cfft_rows.cu's float64 table (pfbt_rows_twiddles), [q - 1][k] per stage,
// conjugated for the inverse.
#pragma once

#include "fft_lines.cuh"

namespace pfbt {

constexpr int kRowBflies = 256;  // stage 2's butterflies, N / R2
// Threads a block at R2 = 8 (N = 2048), where stages 1 and 3 have 128
// butterflies: 256 threads leave half of them idle there, 128 give each a
// butterfly in stages 1 and 3 and two in stage 2. On the H100
// (scripts/torch_kernel_lab.py --rows-const kShortRowThreads, PERF.md) 128
// took 10-16% less time at 2048 and 3-18% more at R2 = 10 and 12 (160 and
// 192 butterflies: a second one for a quarter or half of 128 threads), so
// every other R2 keeps 256.
constexpr int kShortRowThreads = 128;

// Lines a block: one from R2 = 8, 16 / R2 below (16 R2 S = 192-256
// threads, one stage-1 butterfly each).
__host__ __device__ constexpr int rows_per_block(int R2) {
  return R2 >= 8 ? 1 : 16 / R2;
}

__host__ __device__ constexpr int row_threads(int R2) {
  return R2 == 8   ? kShortRowThreads
         : R2 > 8  ? kRowBflies
                   : rows_per_block(R2) * 16 * R2;
}

// shared-memory slot of element i of the line: one float2 of padding
// every 16, so a half-warp's stride-16 stores of stage 1 hit 16 banks
__device__ __forceinline__ int rpad(int i) { return i + (i >> 4); }

// exp(-2 pi i m / 96), conjugated for the inverse (m < 96 a constant
// after unrolling)
__device__ __forceinline__ float2 w96(int m, bool inv) {
  constexpr float c[96] = {
      1.000000000f, 0.997858923f, 0.991444861f, 0.980785280f,
      0.965925826f, 0.946930129f, 0.923879533f, 0.896872742f,
      0.866025404f, 0.831469612f, 0.793353340f, 0.751839807f,
      0.707106781f, 0.659345815f, 0.608761429f, 0.555570233f,
      0.500000000f, 0.442288690f, 0.382683432f, 0.321439465f,
      0.258819045f, 0.195090322f, 0.130526192f, 0.065403129f,
      0.f, -0.065403129f, -0.130526192f, -0.195090322f,
      -0.258819045f, -0.321439465f, -0.382683432f, -0.442288690f,
      -0.500000000f, -0.555570233f, -0.608761429f, -0.659345815f,
      -0.707106781f, -0.751839807f, -0.793353340f, -0.831469612f,
      -0.866025404f, -0.896872742f, -0.923879533f, -0.946930129f,
      -0.965925826f, -0.980785280f, -0.991444861f, -0.997858923f,
      -1.000000000f, -0.997858923f, -0.991444861f, -0.980785280f,
      -0.965925826f, -0.946930129f, -0.923879533f, -0.896872742f,
      -0.866025404f, -0.831469612f, -0.793353340f, -0.751839807f,
      -0.707106781f, -0.659345815f, -0.608761429f, -0.555570233f,
      -0.500000000f, -0.442288690f, -0.382683432f, -0.321439465f,
      -0.258819045f, -0.195090322f, -0.130526192f, -0.065403129f,
      0.f, 0.065403129f, 0.130526192f, 0.195090322f,
      0.258819045f, 0.321439465f, 0.382683432f, 0.442288690f,
      0.500000000f, 0.555570233f, 0.608761429f, 0.659345815f,
      0.707106781f, 0.751839807f, 0.793353340f, 0.831469612f,
      0.866025404f, 0.896872742f, 0.923879533f, 0.946930129f,
      0.965925826f, 0.980785280f, 0.991444861f, 0.997858923f,
  };
  const float sn = c[(m + 72) % 96];  // sin(2 pi m / 96)
  return make_float2(c[m % 96], inv ? sn : -sn);
}

// exp(-2 pi i m / 20) and exp(-2 pi i m / 18), conjugated for the
// inverse (m a constant after unrolling): the roots of radices 5, 10, 20
// and 9, 18
__device__ __forceinline__ float2 w20(int m, bool inv) {
  constexpr float c[20] = {
      1.000000000f, 0.951056516f, 0.809016994f, 0.587785252f, 0.309016994f,
      0.f, -0.309016994f, -0.587785252f, -0.809016994f, -0.951056516f,
      -1.000000000f, -0.951056516f, -0.809016994f, -0.587785252f,
      -0.309016994f, 0.f, 0.309016994f, 0.587785252f, 0.809016994f,
      0.951056516f};
  const float sn = c[(m + 15) % 20];  // sin(2 pi m / 20)
  return make_float2(c[m % 20], inv ? sn : -sn);
}

__device__ __forceinline__ float2 w18(int m, bool inv) {
  constexpr float c[18] = {
      1.000000000f, 0.939692621f, 0.766044443f, 0.500000000f, 0.173648178f,
      -0.173648178f, -0.500000000f, -0.766044443f, -0.939692621f,
      -1.000000000f, -0.939692621f, -0.766044443f, -0.500000000f,
      -0.173648178f, 0.173648178f, 0.500000000f, 0.766044443f,
      0.939692621f};
  constexpr float s[18] = {
      0.f, 0.342020143f, 0.642787610f, 0.866025404f, 0.984807753f,
      0.984807753f, 0.866025404f, 0.642787610f, 0.342020143f, 0.f,
      -0.342020143f, -0.642787610f, -0.866025404f, -0.984807753f,
      -0.984807753f, -0.866025404f, -0.642787610f, -0.342020143f};
  return make_float2(c[m % 18], inv ? s[m % 18] : -s[m % 18]);
}

// cos and sin of x, |x| <= pi/4, in float64 by their Taylor series (to
// x^29, below 1e-17 there), for tables the compiler evaluates
__host__ __device__ constexpr double taylor_cos(double x) {
  double term = 1.0, sum = 1.0;
  for (int k = 1; k <= 14; ++k) {
    term *= -x * x / ((2.0 * k - 1.0) * (2.0 * k));
    sum += term;
  }
  return sum;
}

__host__ __device__ constexpr double taylor_sin(double x) {
  double term = x, sum = x;
  for (int k = 1; k <= 14; ++k) {
    term *= -x * x / ((2.0 * k) * (2.0 * k + 1.0));
    sum += term;
  }
  return sum;
}

// cos and sin of 2 pi m / R rounded once to float32, m < R: the angle
// is reduced exactly to a quadrant and an octant in integers (4 m = q R
// + r), so the series sees |x| <= pi/4
template <int R>
struct RootTable {
  float c[R], s[R];
  __host__ __device__ constexpr RootTable() : c(), s() {
    constexpr double kHalfPi = 1.57079632679489661923;
    for (int m = 0; m < R; ++m) {
      const int q = 4 * m / R, r = 4 * m - q * R;  // angle q pi/2 + phi
      const bool low = 2 * r <= R;                 // phi <= pi/4
      const double x = kHalfPi * (low ? r : R - r) / R;
      const double cp = low ? taylor_cos(x) : taylor_sin(x);  // cos phi
      const double sp = low ? taylor_sin(x) : taylor_cos(x);  // sin phi
      c[m] = static_cast<float>(q == 0 ? cp : q == 1 ? -sp : q == 2 ? -cp
                                                                   : sp);
      s[m] = static_cast<float>(q == 0 ? sp : q == 1 ? cp : q == 2 ? -sp
                                                                   : -cp);
    }
  }
};

// W_R^m = exp(-2 pi i m / R), conjugated for the inverse: from the typed
// table whose length R divides (96, 20, 18: the radices up to 48 that
// had them), else from R's own table, made by the compiler in float64
// and rounded once (m a constant after unrolling)
template <int R>
__device__ __forceinline__ float2 wroot(int m, bool inv) {
  if constexpr (96 % R == 0) return w96((m % R) * (96 / R), inv);
  else if constexpr (20 % R == 0) return w20((m % R) * (20 / R), inv);
  else if constexpr (18 % R == 0) return w18((m % R) * (18 / R), inv);
  else {
    constexpr RootTable<R> t{};
    const int e = m % R;
    return make_float2(t.c[e], inv ? t.s[e] : -t.s[e]);
  }
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
// i a forward, -i a inverse (W_4^3 = i forward)
__device__ __forceinline__ float2 iw(float2 a, bool inv) {
  return inv ? make_float2(a.y, -a.x) : make_float2(-a.y, a.x);
}
// a + c b for a real c
__device__ __forceinline__ float2 caxpy(float2 a, float c, float2 b) {
  return make_float2(a.x + c * b.x, a.y + c * b.y);
}

// X_k = sum_n x_n W_3^{n k}: X_1,2 = x0 - (x1 + x2) / 2 -+ i sin(2 pi/3)
// (x1 - x2) forward
__device__ __forceinline__ void odd_dft3(float2* v, bool inv) {
  constexpr float s = 0.866025404f;  // sin(2 pi / 3)
  const float2 t = cadd(v[1], v[2]);
  const float2 m = caxpy(v[0], -0.5f, t);
  const float2 d = iw(csub(v[1], v[2]), inv);
  v[0] = cadd(v[0], t);
  v[1] = caxpy(m, -s, d);
  v[2] = caxpy(m, s, d);
}

// X_k = sum_n x_n W_5^{n k} by the symmetric pairs t1 = x1 + x4, t2 = x2 +
// x3 and antisymmetric d1 = x1 - x4, d2 = x2 - x3: X_1,4 = x0 + c1 t1 +
// c2 t2 -+ i (s1 d1 + s2 d2), X_2,3 = x0 + c2 t1 + c1 t2 -+ i (s2 d1 - s1
// d2) forward (c_k, s_k = cos, sin 2 pi k / 5)
__device__ __forceinline__ void odd_dft5(float2* v, bool inv) {
  constexpr float c1 = 0.309016994f, c2 = -0.809016994f;
  constexpr float s1 = 0.951056516f, s2 = 0.587785252f;
  const float2 t1 = cadd(v[1], v[4]), t2 = cadd(v[2], v[3]);
  const float2 d1 = csub(v[1], v[4]), d2 = csub(v[2], v[3]);
  const float2 a1 = caxpy(caxpy(v[0], c1, t1), c2, t2);
  const float2 a2 = caxpy(caxpy(v[0], c2, t1), c1, t2);
  const float2 b1 = iw(caxpy(make_float2(s1 * d1.x, s1 * d1.y), s2, d2),
                       inv);
  const float2 b2 = iw(caxpy(make_float2(s2 * d1.x, s2 * d1.y), -s1, d2),
                       inv);
  v[0] = cadd(v[0], cadd(t1, t2));
  v[1] = csub(a1, b1);
  v[4] = cadd(a1, b1);
  v[2] = csub(a2, b2);
  v[3] = cadd(a2, b2);
}

// The pair R = RA (R / RA) that reg_dft takes at a radix R without a DFT
// of its own (0 elsewhere)
__host__ __device__ constexpr int pair_ra(int R) {
  switch (R) {
    case 9: return 3;
    case 10: case 15: case 20: case 25: return 5;
    case 6: return 3;
    case 12: return 4;
    case 18: case 27: case 36: case 45: return 9;
    case 24: case 32: case 40: return 8;
    case 30: case 50: return 10;
    case 48: case 64: return 16;
    case 54: return 18;
    case 60: return 20;
    default: return 0;
  }
}

template <int R>
__device__ __forceinline__ void reg_dft(float2* v, bool inv);

// DFT of R = RA RB values in registers: n = RB n1 + n2, k = k1 + RA k2,
// RB DFTs of RA, the twiddles W_R^{n2 k1}, RA DFTs of RB
template <int RA, int RB>
__device__ __forceinline__ void dft_pair(float2* v, bool inv) {
  constexpr int R = RA * RB;
  float2 a[RB][RA];
#pragma unroll
  for (int n2 = 0; n2 < RB; ++n2) {
#pragma unroll
    for (int n1 = 0; n1 < RA; ++n1) a[n2][n1] = v[RB * n1 + n2];
    reg_dft<RA>(a[n2], inv);
#pragma unroll
    for (int k1 = 1; k1 < RA; ++k1)
      if (n2 > 0) a[n2][k1] = cmul(a[n2][k1], wroot<R>(n2 * k1, inv));
  }
#pragma unroll
  for (int k1 = 0; k1 < RA; ++k1) {
    float2 b[RB];
#pragma unroll
    for (int n2 = 0; n2 < RB; ++n2) b[n2] = a[n2][k1];
    reg_dft<RB>(b, inv);
#pragma unroll
    for (int k2 = 0; k2 < RB; ++k2) v[k1 + RA * k2] = b[k2];
  }
}

// An R-point DFT in registers: radices 3 and 5 by their shared sums, 2,
// 4, 8 and 16 by fft_lines.cuh's small_dft, the others as a pair
template <int R>
__device__ __forceinline__ void reg_dft(float2* v, bool inv) {
  if constexpr (R == 3) odd_dft3(v, inv);
  else if constexpr (R == 5) odd_dft5(v, inv);
  else if constexpr (R == 2 || R == 4 || R == 8 || R == 16)
    small_dft<R>(v, inv);
  else {
    constexpr int RA = pair_ra(R);
    static_assert(RA > 0, "no register DFT of this radix");
    dft_pair<RA, R / RA>(v, inv);
  }
}

// 16-point DFT as 4 x 4 (n = 4 n1 + n2, k = k1 + 4 k2). kIn: only the
// inputs n1 = 0 and 3 (q < 4, q >= 12) are non-zero, the rest are not
// read. kOut: only the outputs k2 = 0 and 3 (q < 4, q >= 12) are made.
template <bool kIn, bool kOut>
__device__ __forceinline__ void dft16(float2* v, bool inv) {
  float2 a[4][4];
#pragma unroll
  for (int n2 = 0; n2 < 4; ++n2) {
    if (kIn) {
      // sum over n1 in {0, 3} of x W_4^{n1 k1}
      const float2 x0 = v[n2], x3 = v[12 + n2];
      a[n2][0] = cadd(x0, x3);
      a[n2][1] = cadd(x0, iw(x3, inv));
      a[n2][2] = csub(x0, x3);
      a[n2][3] = csub(x0, iw(x3, inv));
    } else {
#pragma unroll
      for (int n1 = 0; n1 < 4; ++n1) a[n2][n1] = v[4 * n1 + n2];
      small_dft<4>(a[n2], inv);
    }
#pragma unroll
    for (int k1 = 1; k1 < 4; ++k1)
      if (n2 > 0) a[n2][k1] = cmul(a[n2][k1], w16(n2 * k1, inv));
  }
#pragma unroll
  for (int k1 = 0; k1 < 4; ++k1) {
    float2 b[4] = {a[0][k1], a[1][k1], a[2][k1], a[3][k1]};
    if (kOut) {
      // k2 = 0 and 3: W_4^{3 n2} = 1, i, -1, -i forward
      v[k1] = cadd(cadd(b[0], b[1]), cadd(b[2], b[3]));
      v[k1 + 12] = cadd(csub(b[0], b[2]), iw(csub(b[1], b[3]), inv));
    } else {
      small_dft<4>(b, inv);
#pragma unroll
      for (int k2 = 0; k2 < 4; ++k2) v[k1 + 4 * k2] = b[k2];
    }
  }
}

// 16-point DFT as 4 x 4 where kIn: only the inputs n1 = 0 and 1 (q < 8)
// are non-zero, the rest are not read; kOut: only the outputs k2 = 0 and
// 1 (q < 8) are made. A row zero-padded to twice its length, and its
// crop back.
template <bool kIn, bool kOut>
__device__ __forceinline__ void dft16_low(float2* v, bool inv) {
  float2 a[4][4];
#pragma unroll
  for (int n2 = 0; n2 < 4; ++n2) {
    if (kIn) {
      // sum over n1 in {0, 1} of x W_4^{n1 k1}; W_4 = -iw
      const float2 x0 = v[n2], x1 = v[4 + n2];
      a[n2][0] = cadd(x0, x1);
      a[n2][1] = csub(x0, iw(x1, inv));
      a[n2][2] = csub(x0, x1);
      a[n2][3] = cadd(x0, iw(x1, inv));
    } else {
#pragma unroll
      for (int n1 = 0; n1 < 4; ++n1) a[n2][n1] = v[4 * n1 + n2];
      small_dft<4>(a[n2], inv);
    }
#pragma unroll
    for (int k1 = 1; k1 < 4; ++k1)
      if (n2 > 0) a[n2][k1] = cmul(a[n2][k1], w16(n2 * k1, inv));
  }
#pragma unroll
  for (int k1 = 0; k1 < 4; ++k1) {
    float2 b[4] = {a[0][k1], a[1][k1], a[2][k1], a[3][k1]};
    if (kOut) {
      // k2 = 0 and 1: W_4^{n2} = 1, -i, -1, i forward
      v[k1] = cadd(cadd(b[0], b[1]), cadd(b[2], b[3]));
      v[k1 + 4] = csub(csub(b[0], b[2]), iw(csub(b[1], b[3]), inv));
    } else {
      small_dft<4>(b, inv);
#pragma unroll
      for (int k2 = 0; k2 < 4; ++k2) v[k1 + 4 * k2] = b[k2];
    }
  }
}

// Stage 2, radix R2 at Ns = 16, on the S lines in shared memory (line s at
// element s N) with T threads: butterfly f = 256 s + t of line s reads n
// = t + 256 q, writes (t / 16) 16 R2 + 16 q + t % 16; a thread takes f =
// threadIdx.x + T b. The caller synchronises before (stage 1's stores)
// and after (stage 3's loads). kFFT = false (the lab's skeleton) keeps the
// two transposes alone.
template <int R2, int T, int S, bool kFFT>
__device__ __forceinline__ void rows_mid(float2* sm, const float2* TW,
                                         bool inv) {
  constexpr int NF = S * kRowBflies;
  constexpr int B2 = (NF + T - 1) / T;
  static_assert(S > 1 || B2 * T == kRowBflies, "T divides 256");
  const float sg = inv ? -1.f : 1.f;
  float2 u[B2][R2];
#pragma unroll
  for (int b = 0; b < B2; ++b) {
    const int f = threadIdx.x + T * b;
    if (NF % T && f >= NF) continue;
    const int s = S > 1 ? f / kRowBflies : 0;
    const int base = s * kRowBflies * R2, t = f - s * kRowBflies;
#pragma unroll
    for (int q = 0; q < R2; ++q)
      u[b][q] = sm[rpad(base + t + kRowBflies * q)];
  }
  __syncthreads();  // every read done before the in-place writes
#pragma unroll
  for (int b = 0; b < B2; ++b) {
    const int f = threadIdx.x + T * b;
    if (NF % T && f >= NF) continue;
    const int s = S > 1 ? f / kRowBflies : 0;
    const int base = s * kRowBflies * R2, t = f - s * kRowBflies;
    if (kFFT) {
      const float2* T2 = TW + 15 + (t & 15);
#pragma unroll
      for (int q = 1; q < R2; ++q) {
        const float2 w = __ldg(&T2[(q - 1) * 16]);
        u[b][q] = cmul(u[b][q], make_float2(w.x, sg * w.y));
      }
      reg_dft<R2>(u[b], inv);
    }
    const int o = base + (t >> 4) * 16 * R2 + (t & 15);
#pragma unroll
    for (int q = 0; q < R2; ++q) sm[rpad(o + 16 * q)] = u[b][q];
  }
}

// Stage 3's input, Ns = N / 16: butterfly j reads n = j + NB q into v and
// multiplies by the twiddles W_N^{q j} (kFFT); the caller takes the
// radix-16 DFT, which leaves X[j + NB q] in v[q].
template <int N, int R2, bool kFFT>
__device__ __forceinline__ void rows_last_load(const float2* sm,
                                               const float2* TW, int j,
                                               bool inv, float2* v) {
  constexpr int NB = N / 16;
  const float sg = inv ? -1.f : 1.f;
  const float2* T3 = TW + 15 + (R2 - 1) * 16;
#pragma unroll
  for (int q = 0; q < 16; ++q) v[q] = sm[rpad(j + NB * q)];
  if (kFFT) {
#pragma unroll
    for (int q = 1; q < 16; ++q) {
      const float2 w = __ldg(&T3[(q - 1) * NB + j]);
      v[q] = cmul(v[q], make_float2(w.x, sg * w.y));
    }
  }
}

}  // namespace pfbt
