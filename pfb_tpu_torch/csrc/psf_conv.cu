// The PSF-Hessian convolution of an image cube,
//   out_b = crop_{nx,ny}(ifft2(H_b * fft2(pad_{NX,NY}(x_b)))),
// in three forms that share one stage structure:
//
// K1  pfbt_psf_conv: the operator of pfb_tpu_torch/ops/fft.py:
//     psf_convolve_cube. Replaces pfb_tpu/ops/pallas_fft.py:
//     psf_convolve_pallas_v3_cube (Pallas kernels _k1t_kernel,
//     _k2t_kernel/_k2tr_kernel, _k3t_kernel). H is the port's own layout:
//     the Hermitian half (nb, NX/2+1, NY) float32 real part plus an
//     optional imaginary part (absent for an even PSF, real_transfer).
// K2  pfbt_psf_conv_cg: K1 fused with a conjugate-gradient step. Replaces
//     pallas_fft.py:psf_convolve_pallas_v3_cube_cg (_k1t_cg_kernel,
//     _k2t/_k2tr, _k3t_cg_kernel): stage 1 forms the direction
//     p = beta_b p_prev - r as it loads the columns and writes p; stage 3
//     sums p . conv(p) and p . p per column (float64, fixed order: on the
//     cluster route per block, psf_cols.cu's CgIn / CgOut), and a last
//     small pass adds each column's partials and then the columns of each
//     band in a fixed order, so reruns are bitwise equal (no atomics).
// K11 pfbt_psf_conv_full: Re(ifft2(H fft2(pad(x))))[:nx, :ny] with the
//     FULL complex transfer function (nb, NX, NY) and any 5-smooth even
//     NX >= nx, NY >= ny (the image need not be half the PSF). Replaces
//     pallas_fft.py:psf_convolve_pallas and its band loop
//     psf_convolve_pallas_cube (_k1_kernel, _k2_kernel, _k3_kernel); here
//     the bands ride one launch sequence. For a real x, X(-k) = conj X(k),
//     so
//       Re(ifft2(H X)) = ifft2(H_h X),   H_h(k) = (H(k) + conj H(-k)) / 2,
//     and H_h is Hermitian. Stage 2 forms H_h for kept row kx from rows kx
//     and (NX - kx) mod NX of H, and the half-spectrum stages of K1 then
//     give the real part exactly.
// K10 pfbt_psf_stage_cols_fwd / pfbt_psf_stage_rows / pfbt_psf_stage_cols_inv:
//     K1's three stages as separate calls on the shards of a space-sharded
//     cube, for the all-to-all transposes between them. Replaces
//     pallas_fft.py:psf_v3_stage_k1/k2/k3. The column stages are K1's
//     column kernels on a shard's (nb, rows, nyl) half spectrum with rows
//     >= NX/2 + 1 (padded to the shard count; stage 1 writes the pad rows
//     as zeros, stage 3 reads rows <= NX/2 at the padded row stride); the
//     rows stage takes a row shard and the matching rows of H. Stage 2
//     leaves the inverse y-DFT unscaled and stage 3 scales by 1 / (NX NY),
//     as K1 does, so a shard's lines equal K1's bit for bit.
// K15 the column stages with `keep` = NXH = NX/2 + N1 (N1 x N2 = NX the
//     TPU's four-step factors): replaces pallas_fft.py:_k1h_kernel (the
//     forward keeps spectrum rows k < NXH) and _k3h_kernel (the inverse
//     reads those rows and mirrors rows 1 .. NX/2 - N1 into NX - i, then
//     takes the real part scaled by 1 / NX). On a non-Hermitian input
//     rows NX/2 + 1 .. NXH - 1 are read as given, as the TPU kernel does.
//
// The stages (the TPU's three stage boundaries, not its blocking):
//   1. per column: forward x-DFT of the zero-padded real column, keeping
//      rows 0..NX/2 (Hermitian half);              column kernel
//   2. per kept row: forward y-DFT of the zero-padded row, multiply by H,
//      inverse y-DFT, crop to ny;                   rows kernel
//   3. per column: inverse x-DFT with the conjugate mirror rebuilt, real
//      part, crop to nx, scale 1/(NX NY).           column kernel
// The column kernel of a stage is the cluster column FFT of psf_cols.cu
// where psf_cols_clusters(NX, ny) holds (NX >= 256 and its tile fits),
// else line_fft_kernel (fft_lines.cuh). Every entry here asks the same
// predicate, so K1, K2, K10, K11 and K15 take one route at one NX; the
// caller passes the C it expects (0 for the line kernel) and the tables
// of that route, and an entry refuses a C that is not the predicate's.
// On the cluster route K2's stages are the cluster kernels with its
// prologue and epilogue, so its conv(p) is K1's of its own p bit for bit;
// on the line route, the fused line kernels below.
// The rows kernel of every entry (K1, K2, K10, K11) is the fused register
// row FFT K10br of psf_rows.cu where psf_rows_fused(NY) holds (NY = 256
// R2, R2 = 1-64 5-smooth), else psf_rows_kernel below. No 128-aligned
// sigma-2 path reaches the line kernels (K2's below, psf_rows_kernel,
// line_fft_kernel) since the routes reach NX = NY = 256; they keep the
// other lengths (rows no multiple of 256, NX % 4 != 0, NX < 256), and
// pfbt_psf_line_lab runs them at any length for the lab. The caller
// passes that route's table as TY (pfbt_rows_twiddles, or the length-NY
// plan's pfbt_twiddles) and the route it is for
// (`fused`, 1 or 0), and an entry refuses a route that is not the
// predicate's; *nfused (may be null) gains the number of K10br launches
// the entry made.
// Row i of a column is written only for i < nx and read for i <= NX/2, so
// nx may exceed NX/2 (psf_oversize < 2).
//
// What bounds them on the H100: each stage reads and writes the half
// spectrum once (8 bytes per complex element in, 8 out, plus 4 or 8 of H
// in stage 2; 16 for K11's two rows of the full H), and the FFT passes run
// in shared memory, so the line kernels are bound by shared-memory traffic
// and, on the line route, by the narrow column strips of the strided x
// passes (stages 1 and 3), not by FLOPs. The design keeps every line
// resident in shared memory across all passes of its transform, and stage
// 2 runs both y transforms and the H multiply on one residency of the row
// (in registers on K10br), so the spectrum never goes to HBM between them.
// K2's extra vector work rides the columns that stages 1 and 3 already
// hold (16-byte quads on the cluster route).
#include "fft_lines.cuh"
#include "psf_cols.cuh"
#include "psf_rows.cuh"

namespace pfbt {

// kFull false: row g of the spectrum multiplies row g of the Hermitian
// half H (nb * (NX/2+1) rows). kFull true: H is the full (nb, NX, NY)
// transfer function and row g = (b, kx) multiplies H_h(kx, .).
template <int VPT, bool kFull>
__global__ void __launch_bounds__(kThreads)
psf_rows_kernel(const float* __restrict__ zr, const float* __restrict__ zi,
                const float* __restrict__ hr, const float* __restrict__ hi,
                float* __restrict__ wr, float* __restrict__ wi, int R,
                int ny, int S, int NX, LinePlan p) {
  extern __shared__ float2 sm[];
  const int N = p.N;
  const long g0 = (long)blockIdx.x * S;
  const FastDiv fn(N), fny(ny);

  for (int t = threadIdx.x; t < S * N; t += blockDim.x) {
    const int s = fn.div(t), n = t - s * N;
    const long g = g0 + s;
    float2 v = make_float2(0.f, 0.f);
    if (g < R && n < ny) v = make_float2(zr[g * ny + n], zi[g * ny + n]);
    sm[spad(t)] = v;
  }
  __syncthreads();

  block_fft<VPT>(sm, S, p, false);

  const int nxh = NX / 2 + 1;
  for (int t = threadIdx.x; t < S * N; t += blockDim.x) {
    const int s = fn.div(t), k = t - s * N;
    const long g = g0 + s;
    if (g >= R) continue;
    float h_r, h_i;
    if (kFull) {
      const long b = g / nxh;
      const int kx = (int)(g - b * nxh);
      const long a = (b * NX + kx) * N + k;
      const long m = (b * NX + (NX - kx) % NX) * N + (N - k) % N;
      h_r = 0.5f * (hr[a] + hr[m]);
      h_i = hi ? 0.5f * (hi[a] - hi[m]) : 0.f;
    } else {
      h_r = hr[g * N + k];
      h_i = hi ? hi[g * N + k] : 0.f;
    }
    const float2 v = sm[spad(t)];
    sm[spad(t)] = make_float2(v.x * h_r - v.y * h_i, v.x * h_i + v.y * h_r);
  }
  __syncthreads();

  block_fft<VPT>(sm, S, p, true);

  for (int t = threadIdx.x; t < S * ny; t += blockDim.x) {
    const int s = fny.div(t), m = t - s * ny;
    const long g = g0 + s;
    if (g >= R) continue;
    const float2 v = sm[spad(s * N + m)];
    wr[g * ny + m] = v.x;
    wi[g * ny + m] = v.y;
  }
}

template <int VPT, bool kFull>
static cudaError_t launch_rows(const float* zr, const float* zi,
                               const float* hr, const float* hi, float* wr,
                               float* wi, int R, int ny, int NX,
                               const LineLaunch& c, const LinePlan& p,
                               cudaStream_t st) {
  cudaError_t e = allow_smem(psf_rows_kernel<VPT, kFull>, c.smem);
  if (e != cudaSuccess) return e;
  psf_rows_kernel<VPT, kFull><<<(R + c.S - 1) / c.S, c.threads, c.smem,
                                st>>>(zr, zi, hr, hi, wr, wi, R, ny, c.S,
                                      NX, p);
  return cudaGetLastError();
}

// The rows stage of length NY on either route: K10br (psf_rows.cu) where
// psf_rows_fused(NY) holds, TY then the rows plan's table
// (pfbt_rows_twiddles) and fused 1; else psf_rows_kernel, TY the length-NY
// plan's (pfbt_twiddles) and fused 0.
static bool rows_ok(int NY, const void* TY, int fused) {
  LinePlan py;
  if (fused != (psf_rows_fused(NY) ? 1 : 0)) return false;
  return fused ? TY != nullptr : make_plan(NY, TY, &py);
}

// The rows stage on psf_rows_kernel, TY the length-NY plan's table.
template <bool kFull>
static cudaError_t line_rows(const float* zr, const float* zi,
                             const float* hr, const float* hi, float* wr,
                             float* wi, int R, int ny, int NX, int NY,
                             const void* TY, cudaStream_t st) {
  LinePlan py;
  if (!make_plan(NY, TY, &py)) return cudaErrorInvalidValue;
  const LineLaunch c = line_launch(py.N);
  return c.vpt == kVpt
             ? launch_rows<kVpt, kFull>(zr, zi, hr, hi, wr, wi, R, ny, NX, c,
                                        py, st)
             : launch_rows<2 * kVpt, kFull>(zr, zi, hr, hi, wr, wi, R, ny,
                                            NX, c, py, st);
}

template <bool kFull>
static cudaError_t rows_stage(const float* zr, const float* zi,
                              const float* hr, const float* hi, float* wr,
                              float* wi, int R, int ny, int NX, int NY,
                              const void* TY, int* nfused,
                              cudaStream_t st) {
  if (psf_rows_fused(NY))
    return psf_rows_fused_stage(zr, zi, hr, hi, wr, wi, R, ny, NY,
                                kFull ? NX : 0, TY, nfused, st);
  return line_rows<kFull>(zr, zi, hr, hi, wr, wi, R, ny, NX, NY, TY, st);
}

// K2 stage 1: p = beta_b p_prev - r on the S columns of a block, written
// to pn, then the forward x-DFT of the zero-padded columns of p, rows
// 0..NX/2 kept (line_fft_kernel's natural path with the direction update
// as its prologue).
template <int VPT>
__global__ void __launch_bounds__(kThreads)
cg_cols_fwd_kernel(const float* __restrict__ pp, const float* __restrict__ rr,
                   const float* __restrict__ beta, float* __restrict__ pn,
                   float* __restrict__ zr, float* __restrict__ zi, int nb,
                   int nx, int ny, int nxh, int S, LinePlan p) {
  extern __shared__ float2 sm[];
  const int N = p.N;
  const int nlines = nb * ny;
  const int g0 = blockIdx.x * S;
  const FastDiv fs(S), fl(ny);

  for (int i = threadIdx.x; i < S * N; i += blockDim.x)
    sm[spad(i)] = make_float2(0.f, 0.f);
  __syncthreads();
  for (int t = threadIdx.x; t < S * nx; t += blockDim.x) {
    const int s = fs.mod(t), i = fs.div(t);
    const int g = g0 + s;
    if (g >= nlines) continue;
    const int b = fl.div(g), j = g - b * ny;
    const long a = ((long)b * nx + i) * ny + j;
    const float v = beta[b] * pp[a] - rr[a];
    pn[a] = v;
    sm[spad(s * N + i)] = make_float2(v, 0.f);
  }
  __syncthreads();

  block_fft<VPT>(sm, S, p, false);

  for (int t = threadIdx.x; t < S * nxh; t += blockDim.x) {
    const int s = fs.mod(t), r = fs.div(t);
    const int g = g0 + s;
    if (g >= nlines) continue;
    const int b = fl.div(g), j = g - b * ny;
    const long a = ((long)b * nxh + r) * ny + j;
    const float2 v = sm[spad(s * N + r)];
    zr[a] = v.x;
    zi[a] = v.y;
  }
}

// K2 stage 3: inverse x-DFT of the Hermitian-half columns (conjugate
// mirror rebuilt), real part cropped to nx and scaled, written to out;
// and per column the float64 sums of p . out and p . p. The launch makes
// blockDim a multiple of S, so thread t always holds column t mod S; the
// threads' partial sums are added per column in thread order.
template <int VPT>
__global__ void __launch_bounds__(kThreads)
cg_cols_inv_kernel(const float* __restrict__ wr, const float* __restrict__ wi,
                   const float* __restrict__ pn, float* __restrict__ out,
                   double* __restrict__ colsum, int nb, int nx, int ny,
                   int nxh, float scale, int S, LinePlan p) {
  extern __shared__ float2 sm[];
  const int N = p.N;
  const int nlines = nb * ny;
  const int g0 = blockIdx.x * S;
  const FastDiv fs(S), fl(ny);

  for (int t = threadIdx.x; t < S * nxh; t += blockDim.x) {
    const int s = fs.mod(t), i = fs.div(t);
    const int g = g0 + s;
    if (g >= nlines) continue;
    const int b = fl.div(g), j = g - b * ny;
    const long a = ((long)b * nxh + i) * ny + j;
    const float re = wr[a], im = wi[a];
    sm[spad(s * N + i)] = make_float2(re, im);
    if (i > 0 && i < N - i) sm[spad(s * N + N - i)] = make_float2(re, -im);
  }
  __syncthreads();

  block_fft<VPT>(sm, S, p, true);

  double pap = 0.0, ppp = 0.0;
  for (int t = threadIdx.x; t < S * nx; t += blockDim.x) {
    const int s = fs.mod(t), r = fs.div(t);
    const int g = g0 + s;
    if (g >= nlines) continue;
    const int b = fl.div(g), j = g - b * ny;
    const long a = ((long)b * nx + r) * ny + j;
    const float v = sm[spad(s * N + r)].x * scale;
    out[a] = v;
    const double q = pn[a];
    pap += q * (double)v;
    ppp += q * q;
  }
  __syncthreads();  // every read of the line buffer is done
  double* red = reinterpret_cast<double*>(sm);
  red[2 * threadIdx.x] = pap;
  red[2 * threadIdx.x + 1] = ppp;
  __syncthreads();
  if ((int)threadIdx.x < S && g0 + (int)threadIdx.x < nlines) {
    double a0 = 0.0, a1 = 0.0;
    for (int u = threadIdx.x; u < (int)blockDim.x; u += S) {
      a0 += red[2 * u];
      a1 += red[2 * u + 1];
    }
    colsum[2 * (long)(g0 + threadIdx.x)] = a0;
    colsum[2 * (long)(g0 + threadIdx.x) + 1] = a1;
  }
}

constexpr int kSumThreads = 256;

// K2's last pass: per band, the ny column sums added in a fixed order
// (strided per thread, then a tree), rounded once to float32:
// pap[b] = [p . conv(p), p . p]. A column's sum is the sum of its `parts`
// partials (the cluster route's blocks, in block order) taken first.
__global__ void __launch_bounds__(kSumThreads)
band_sums_kernel(const double* __restrict__ colsum, float* __restrict__ pap,
                 int ny, int parts) {
  __shared__ double s0[kSumThreads], s1[kSumThreads];
  const long b = blockIdx.x;
  double a0 = 0.0, a1 = 0.0;
  for (int j = threadIdx.x; j < ny; j += kSumThreads) {
    const double* cs = colsum + 2 * (b * ny + j) * parts;
    double c0 = cs[0], c1 = cs[1];
    for (int c = 1; c < parts; ++c) {
      c0 += cs[2 * c];
      c1 += cs[2 * c + 1];
    }
    a0 += c0;
    a1 += c1;
  }
  s0[threadIdx.x] = a0;
  s1[threadIdx.x] = a1;
  __syncthreads();
  for (int h = kSumThreads / 2; h > 0; h >>= 1) {
    if ((int)threadIdx.x < h) {
      s0[threadIdx.x] += s0[threadIdx.x + h];
      s1[threadIdx.x] += s1[threadIdx.x + h];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    pap[2 * b] = (float)s0[0];
    pap[2 * b + 1] = (float)s1[0];
  }
}

// Launch shape of K2's column kernels: line_launch's, with the check that
// each thread keeps one column and that the reduction scratch fits.
static inline bool cg_launch(int N, LineLaunch* c) {
  *c = line_launch(N);
  return c->threads % c->S == 0 &&
         (size_t)16 * c->threads <= c->smem;
}

// The column stages' route: C = psf_cols_clusters(NX, L) blocks a
// cluster and the tables TM, TN (psf_cols.cuh), or C = 0 and the length-NX
// plan of TX into px for line_fft_kernel; false where the caller's C is
// not the predicate's or a table is missing.
static bool cols_route(int NX, int L, int C, const void* TX, const void* TM,
                       const void* TN, LinePlan* px) {
  if (C != psf_cols_clusters(NX, L)) return false;
  return C ? TM && TN : make_plan(NX, TX, px);
}

// Stage 1 on either route: x (nb, nx, L) real -> z (nb, rows, L), rows
// k < keep of the spectrum, the rest zero.
static cudaError_t cols_fwd(const float* x, float* zr, float* zi, int nb,
                            int nx, int L, int NX, int keep, int rows,
                            int C, const LinePlan& px, const void* TM,
                            const void* TN, cudaStream_t st) {
  if (C)
    return psf_cols_fwd(x, zr, zi, nb, nx, L, NX, keep, rows, C, 0, TM, TN,
                        st);
  return launch_lines(x, nullptr, zr, zi, nb, L, nx, nx, keep, rows,
                      kInNatural, kOutNatural, 0, 1.0f, px, st);
}

// Stage 3 on either route: rows k < keep of w (nb, rows, L) and their
// conjugate mirror -> out (nb, nx, L), the real inverse times scale.
static cudaError_t cols_inv(const float* wr, const float* wi, float* out,
                            int nb, int nx, int L, int NX, int keep,
                            int rows, float scale, int C,
                            const LinePlan& px, const void* TM,
                            const void* TN, cudaStream_t st) {
  if (C)
    return psf_cols_inv(wr, wi, out, nb, nx, L, NX, keep, rows, scale, C,
                        0, TM, TN, st);
  return launch_lines(wr, wi, out, nullptr, nb, L, keep, rows, nx, nx,
                      kInHermitian, kOutNatural, 1, scale, px, st);
}

// Stages 1-3 of K1 (full = false) and K11 (full = true).
static int conv_stages(const float* x, const float* hr, const float* hi,
                       float* zr, float* zi, float* wr, float* wi,
                       float* out, int nb, int nx, int ny, int NX, int NY,
                       int C, const void* TX, const void* TY,
                       const void* TM, const void* TN, int fused,
                       int* nfused, bool full, cudaStream_t st) {
  LinePlan px;
  if (NX % 2 || nx > NX || ny > NY || !rows_ok(NY, TY, fused) ||
      !cols_route(NX, ny, C, TX, TM, TN, &px))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nxh = NX / 2 + 1;

  // 1. x (nb, nx, ny) real -> z (nb, nxh, ny)
  cudaError_t e = cols_fwd(x, zr, zi, nb, nx, ny, NX, nxh, nxh, C, px, TM,
                           TN, st);
  if (e != cudaSuccess) return static_cast<int>(e);

  // 2. rows of z -> w (nb, nxh, ny)
  const int R = nb * nxh;
  e = full ? rows_stage<true>(zr, zi, hr, hi, wr, wi, R, ny, NX, NY, TY,
                              nfused, st)
           : rows_stage<false>(zr, zi, hr, hi, wr, wi, R, ny, NX, NY, TY,
                               nfused, st);
  if (e != cudaSuccess) return static_cast<int>(e);

  // 3. w (nb, nxh, ny) Hermitian half -> out (nb, nx, ny) real
  const float scale = 1.0f / ((float)NX * (float)NY);
  e = cols_inv(wr, wi, out, nb, nx, ny, NX, nxh, nxh, scale, C, px, TM, TN,
               st);
  return static_cast<int>(e);
}

template <int VPT>
static cudaError_t cg_stage1(const float* pp, const float* rr,
                             const float* beta, float* pn, float* zr,
                             float* zi, int nb, int nx, int ny, int nxh,
                             const LineLaunch& c, const LinePlan& p,
                             cudaStream_t st) {
  cudaError_t e = allow_smem(cg_cols_fwd_kernel<VPT>, c.smem);
  if (e != cudaSuccess) return e;
  const unsigned grid = (unsigned)(((long)nb * ny + c.S - 1) / c.S);
  cg_cols_fwd_kernel<VPT><<<grid, c.threads, c.smem, st>>>(
      pp, rr, beta, pn, zr, zi, nb, nx, ny, nxh, c.S, p);
  return cudaGetLastError();
}

template <int VPT>
static cudaError_t cg_stage3(const float* wr, const float* wi,
                             const float* pn, float* out, double* colsum,
                             int nb, int nx, int ny, int nxh, float scale,
                             const LineLaunch& c, const LinePlan& p,
                             cudaStream_t st) {
  cudaError_t e = allow_smem(cg_cols_inv_kernel<VPT>, c.smem);
  if (e != cudaSuccess) return e;
  const unsigned grid = (unsigned)(((long)nb * ny + c.S - 1) / c.S);
  cg_cols_inv_kernel<VPT><<<grid, c.threads, c.smem, st>>>(
      wr, wi, pn, out, colsum, nb, nx, ny, nxh, scale, c.S, p);
  return cudaGetLastError();
}

}  // namespace pfbt

// K1 and K11: C of the column route (pfbt_psf_cols_route(NX, ny)), TX the
// length-NX plan's table (line route), TM, TN the cluster route's; TY the
// rows stage's table at NY and fused its route (pfbt_psf_rows_route(NY)),
// *nfused (may be null) the K10br launches made (rows_ok).
extern "C" int pfbt_psf_conv(const float* x, const float* hr,
                             const float* hi, float* zr, float* zi,
                             float* wr, float* wi, float* out, int nb,
                             int nx, int ny, int NX, int NY, int C,
                             const void* TX, const void* TY, const void* TM,
                             const void* TN, int fused, int* nfused,
                             void* stream) {
  return pfbt::conv_stages(x, hr, hi, zr, zi, wr, wi, out, nb, nx, ny, NX,
                           NY, C, TX, TY, TM, TN, fused, nfused, false,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int pfbt_psf_conv_full(const float* x, const float* hr,
                                  const float* hi, float* zr, float* zi,
                                  float* wr, float* wi, float* out, int nb,
                                  int nx, int ny, int NX, int NY, int C,
                                  const void* TX, const void* TY,
                                  const void* TM, const void* TN, int fused,
                                  int* nfused, void* stream) {
  return pfbt::conv_stages(x, hr, hi, zr, zi, wr, wi, out, nb, nx, ny, NX,
                           NY, C, TX, TY, TM, TN, fused, nfused, true,
                           static_cast<cudaStream_t>(stream));
}

// K10 stage 1 and K15's forward: x (nb, nx, L) real columns -> z (nb,
// rows, L) re/im, spectrum rows 0 .. keep - 1 of the forward x-DFT of
// length NX and rows keep .. rows - 1 zero (K10: keep = NX/2 + 1; K15:
// keep = rows = NXH). C, TX, TM, TN as pfbt_psf_conv's, at (NX, L).
extern "C" int pfbt_psf_stage_cols_fwd(const float* x, float* zr, float* zi,
                                       int nb, int nx, int L, int NX,
                                       int keep, int rows, int C,
                                       const void* TX, const void* TM,
                                       const void* TN, void* stream) {
  using namespace pfbt;
  LinePlan px;
  if (NX % 2 || nx > NX || keep < NX / 2 + 1 || keep > NX || rows < keep ||
      !cols_route(NX, L, C, TX, TM, TN, &px))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cols_fwd(x, zr, zi, nb, nx, L, NX, keep, rows, C,
                                   px, TM, TN,
                                   static_cast<cudaStream_t>(stream)));
}

// K10 stage 2: R rows of z (R, ny) against the matching rows of H (R, NY)
// -> w (R, ny), K1's rows stage (y-DFT of the zero-padded row, product,
// unscaled inverse y-DFT, crop), TY, fused and nfused as pfbt_psf_conv's.
extern "C" int pfbt_psf_stage_rows(const float* zr, const float* zi,
                                   const float* hr, const float* hi,
                                   float* wr, float* wi, int R, int ny,
                                   int NY, const void* TY, int fused,
                                   int* nfused, void* stream) {
  using namespace pfbt;
  if (ny > NY || !rows_ok(NY, TY, fused))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(rows_stage<false>(
      zr, zi, hr, hi, wr, wi, R, ny, 0, NY, TY, nfused,
      static_cast<cudaStream_t>(stream)));
}

// K10 stage 3 and K15's inverse: rows 0 .. keep - 1 of w (nb, rows, L),
// the rows past them rebuilt as the conjugate mirror of rows
// 1 .. NX - keep (kInHermitian) -> out (nb, nx, L), the real part of the
// inverse x-DFT times `scale` (K10: keep = NX/2 + 1, the Hermitian half;
// K15: keep = NXH). C, TX, TM, TN as pfbt_psf_conv's, at (NX, L).
extern "C" int pfbt_psf_stage_cols_inv(const float* wr, const float* wi,
                                       float* out, int nb, int nx, int L,
                                       int NX, int keep, int rows,
                                       float scale, int C, const void* TX,
                                       const void* TM, const void* TN,
                                       void* stream) {
  using namespace pfbt;
  LinePlan px;
  if (NX % 2 || nx > NX || keep < NX / 2 + 1 || keep > NX || rows < keep ||
      !cols_route(NX, L, C, TX, TM, TN, &px))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cols_inv(wr, wi, out, nb, nx, L, NX, keep, rows,
                                   scale, C, px, TM, TN,
                                   static_cast<cudaStream_t>(stream)));
}

// K2: C, TX, TM, TN as pfbt_psf_conv's (the column route, asked as K1
// asks it at (NX, ny)); TY, fused and nfused as pfbt_psf_conv's. colsum
// holds the column sums: (nb, ny, 2) on the line route, (nb, ny, C, 2) on
// the cluster route (its blocks' partials). stages: the stages launched
// (bit 1: stage 1, 2: rows, 4: stage 3 and the band sums; 7 is K2), so
// the lab can time one on the scratch a full call left.
extern "C" int pfbt_psf_conv_cg(const float* pp, const float* rr,
                                const float* beta, const float* hr,
                                const float* hi, float* pn, float* zr,
                                float* zi, float* wr, float* wi, float* out,
                                double* colsum, float* pap, int nb, int nx,
                                int ny, int NX, int NY, int C,
                                const void* TX, const void* TY,
                                const void* TM, const void* TN, int fused,
                                int* nfused, int stages, void* stream) {
  using namespace pfbt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  LinePlan px;
  LineLaunch c;
  if (NX % 2 || nx > NX || ny > NY || !rows_ok(NY, TY, fused) ||
      !cols_route(NX, ny, C, TX, TM, TN, &px) ||
      (!C && !cg_launch(NX, &c)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nxh = NX / 2 + 1;
  const float scale = 1.0f / ((float)NX * (float)NY);

  // 1. p = beta p_prev - r -> pn; its x spectrum -> z (nb, nxh, ny)
  cudaError_t e = cudaSuccess;
  if ((stages & 1) && C)
    e = psf_cols_fwd_cg(pp, rr, beta, pn, zr, zi, nb, nx, ny, NX, C, TM, TN,
                        st);
  else if (stages & 1)
    e = c.vpt == kVpt
            ? cg_stage1<kVpt>(pp, rr, beta, pn, zr, zi, nb, nx, ny, nxh, c,
                              px, st)
            : cg_stage1<2 * kVpt>(pp, rr, beta, pn, zr, zi, nb, nx, ny,
                                  nxh, c, px, st);
  if (e != cudaSuccess) return static_cast<int>(e);

  // 2. rows, as K1
  if (stages & 2)
    e = rows_stage<false>(zr, zi, hr, hi, wr, wi, nb * nxh, ny, NX, NY, TY,
                          nfused, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!(stages & 4)) return 0;

  // 3. conv(p) -> out, column sums of p.conv(p) and p.p -> colsum
  if (C)
    e = psf_cols_inv_cg(wr, wi, pn, out, colsum, nb, nx, ny, NX, scale, C,
                        TM, TN, st);
  else
    e = c.vpt == kVpt
            ? cg_stage3<kVpt>(wr, wi, pn, out, colsum, nb, nx, ny, nxh,
                              scale, c, px, st)
            : cg_stage3<2 * kVpt>(wr, wi, pn, out, colsum, nb, nx, ny, nxh,
                                  scale, c, px, st);
  if (e != cudaSuccess) return static_cast<int>(e);

  // 4. per band: pap (nb, 1, 2)
  band_sums_kernel<<<nb, kSumThreads, 0, st>>>(colsum, pap, ny,
                                               C ? C : 1);
  return static_cast<int>(cudaGetLastError());
}

// The lab's PSF line kernels at any length, whatever the routes say (the
// kernels the lengths below 2048 took before the cluster and register
// routes reached them): stage 1, the forward column stage of a (nb, n, L)
// real into rows k < keep of o1, o2 (nb, rows, L), on line_fft_kernel;
// stage 2, K1's rows stage on psf_rows_kernel, nb rows of a, b (nb, n)
// against hr, hi (nb, N) into o1, o2 (nb, n); stage 3, the inverse column
// stage of rows k < keep of a, b (nb, rows, L) into o1 (nb, n, L) times
// scale, on line_fft_kernel. TX is the length-N plan's table
// (pfbt_twiddles).
extern "C" int pfbt_psf_line_lab(int stage, const float* a, const float* b,
                                 const float* hr, const float* hi,
                                 float* o1, float* o2, int nb, int n, int L,
                                 int N, int keep, int rows, float scale,
                                 const void* TX, void* stream) {
  using namespace pfbt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  LinePlan p;
  if (nb < 1 || n < 1 || n > N || !make_plan(N, TX, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  if (stage == 2)
    return static_cast<int>(
        line_rows<false>(a, b, hr, hi, o1, o2, nb, n, 0, N, TX, st));
  if (N % 2 || keep < N / 2 + 1 || keep > N || rows < keep ||
      (stage != 1 && stage != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      stage == 1 ? cols_fwd(a, o1, o2, nb, n, L, N, keep, rows, 0, p,
                            nullptr, nullptr, st)
                 : cols_inv(a, b, o1, nb, n, L, N, keep, rows, scale, 0, p,
                            nullptr, nullptr, st));
}
