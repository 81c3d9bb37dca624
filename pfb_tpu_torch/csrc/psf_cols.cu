// The PSF-Hessian's column stages at NX >= 4096: column FFTs over a
// thread-block cluster.
//
// Replaces the column stages of pfb_tpu/ops/pallas_fft.py:psf_v3_stage_k1
// (:1075) and psf_v3_stage_k3 (:1153), K10's stages 1 and 3, and with them
// the column stages of K1 (psf_convolve_pallas_v3_cube), K11
// (psf_convolve_pallas), K12 (psf_convolve_pallas_v3) and K15
// (_k1h_kernel / _k3h_kernel): every entry of psf_conv.cu that runs a
// column stage launches these kernels where psf_cols_clusters holds.
//
// What bounds them on the H100: bytes, each input read once and each
// output written once. line_fft_kernel keeps whole lines of NX in one
// block, so at NX = 4096 a block holds two columns and at 8192 one, and a
// warp's loads and stores use 4-8 bytes of each 32-byte sector. Here, as
// in K3's cluster column kernel (cfft_cols.cu), NX = C M and a cluster of
// C blocks takes a tile of W adjacent columns of one band, so every row
// segment it moves is W floats (a full sector at W = 8).
//
// Forward (x (nb, nx, L) real -> zr, zi (nb, rows, L)):
//   1. block c loads rows n = c + C m < nx of the tile (the rows from nx
//      up are the zero padding: zeros, no load); a thread loads four
//      adjacent columns with one 16-byte load. The columns (j, j + 1) of
//      each global pair (j even) go into one complex line Z = x_j + i
//      x_{j+1}, W/2 lines of M (on the H100 1.3-1.6x faster than a line
//      a column with a zero imaginary part, PERF.md);
//   2. block_fft (fft_lines.cuh) transforms the lines: Y_c[k1];
//   3. after cluster.sync(), each block reads Y_c[k1] of every block c
//      through distributed shared memory, multiplies by W_N^{c k1} and
//      finishes with a C-point DFT in registers:
//        Z[k1 + M k2] = sum_c W_C^{c k2} W_N^{c k1} Y_c[k1].
//      It separates the two real columns' spectra,
//        X_j[k]     = (Z[k] + conj Z[N - k]) / 2,
//        X_{j+1}[k] = (Z[k] - conj Z[N - k]) / (2i),
//      with N - (k1 + M k2) = (M - k1) + M (C - 1 - k2) for k1 > 0 and
//      M (C - k2) for k1 = 0: a thread takes k1 = h and its mirror M - h
//      (h = 0 pairs the self-mirrored k1 = 0 and M/2), so the separation
//      stays in its registers. It stores only the kept rows k < keep
//      (keep = NX/2 + 1: k2 < C/2 and the row NX/2) and the blocks write
//      rows keep .. rows - 1 as zeros (a space shard's row padding);
//   4. a second cluster.sync() keeps every block's shared memory alive
//      until its peers have read it.
// Inverse (wr, wi (nb, rows, L) -> out (nb, nx, L) real):
//   1. block c loads spectrum rows k = c + C m of the tile at the row
//      stride `rows` and forms each column's Hermitian part H[k] =
//      (G[k] + conj G[N - k]) / 2 of its spectrum G (G[k] = W[k] for k <
//      keep, the conjugate mirror conj W[N - k] above): W[k] for 0 < k
//      <= N - keep, conj W[N - k] for k >= keep, and both loads only
//      where both rows are given (k = 0, and NX/2 at keep = NX/2 + 1:
//      their real parts, the rows the plain version reads as real). The
//      real part of the inverse transform of G is the inverse transform
//      of H, so the columns (j, j + 1) of a pair go into one line Z = H_j
//      + i H_{j+1} and one complex inverse gives x_j in its real part and
//      x_{j+1} in its imaginary part, with no separation step;
//   2-4. as the forward, conjugated twiddles; rows n = n1 + M n2 < nx of
//      the output are stored, times `scale`.
// No HBM intermediate. A column's arithmetic depends on neither the
// tile's position nor L nor the row stride, and the pairs are the global
// (2q, 2q + 1), so a space shard of K10 (widths multiples of 128) gives
// K1's bits. The skeleton instances (kFFT = false, the lab's) keep the
// loads, the exchange, the separation and the stores and compile the FFT
// passes, the twiddles and the C-point DFT out.
#include <cooperative_groups.h>

#include "fft_lines.cuh"
#include "psf_cols.cuh"

namespace cg = cooperative_groups;

namespace pfbt {

constexpr int kColsThreads = 256;  // most threads a block
constexpr int kQuad = 4;           // adjacent columns a thread moves
// Blocks an SM the registers are budgeted for: three, 85 registers a
// thread. On the H100 (scripts/torch_kernel_lab.py --minblocks, PERF.md)
// three was the fastest or level at the paths' shapes, though more values
// spill than at two; one, with no spill, was the slowest.
constexpr int kColsMinBlocks = 3;

int psf_cols_width(int NX, int C) {
  return (NX / C) * 8 <= kLineElems ? 8 : 4;
}

int psf_cols_clusters(int NX, int L) {
  if (L < 2 || NX < 4096 || NX % 4) return 0;
  const int C = (NX > 4096 && NX % 8 == 0) ? 8 : 4;
  const int M = NX / C;
  LinePlan p;
  if (M % 2 || M * psf_cols_width(NX, C) > kLineElems ||
      !make_plan(M, nullptr, &p))
    return 0;
  return C;
}

// four adjacent floats of a row from p (16-byte aligned when vec); zeros
// at columns j + t >= L
__device__ __forceinline__ void load_quad(const float* __restrict__ p,
                                          int j, int L, int vec, float* v) {
  if (vec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  } else {
#pragma unroll
    for (int t = 0; t < kQuad; ++t) v[t] = j + t < L ? p[t] : 0.f;
  }
}

__device__ __forceinline__ void store_quad(float* p, int j, int L, int vec,
                                           float a, float b, float c,
                                           float d) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
  } else {
    const float v[kQuad] = {a, b, c, d};
#pragma unroll
    for (int t = 0; t < kQuad; ++t)
      if (j + t < L) p[t] = v[t];
  }
}

// Z[k1 + M k2] for k2 < C of lines `line` and line + 1: Y_r[k1] of every
// block r of the cluster times W_N^{r k1} (sg = -1 conjugates it), then
// the C-point DFT; without kFFT, Y_r[k1] alone.
template <int C, bool kFFT>
__device__ __forceinline__ void gather2(const float2* const (&src)[C],
                                        int line, int M, int k1,
                                        const float2* __restrict__ TN,
                                        float sg, float2 (&v)[2][C]) {
#pragma unroll
  for (int r = 0; r < C; ++r) {
    float2 w = make_float2(1.f, 0.f);
    if (kFFT && r > 0) {
      const float2 t = __ldg(&TN[r * k1]);
      w = make_float2(t.x, sg * t.y);
    }
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      const float2 y = src[r][spad((line + l) * M + k1)];
      v[l][r] = (kFFT && r > 0) ? cmul(y, w) : y;
    }
  }
  if (kFFT) {
    small_dft<C>(v[0], sg < 0.f);
    small_dft<C>(v[1], sg < 0.f);
  }
}

// X_j[k] and X_{j+1}[k] of a pair line from a = Z[k] and m = Z[N - k]
__device__ __forceinline__ void separate(float2 a, float2 m, float2& xj,
                                         float2& xj1) {
  xj = make_float2(0.5f * (a.x + m.x), 0.5f * (a.y - m.y));
  xj1 = make_float2(0.5f * (a.y + m.y), 0.5f * (m.x - a.x));
}

// Rows k1 + M k2 < keep of the four columns of pair lines v (partner
// vectors pm at index pi(k2)) into zr, zi.
template <int C>
__device__ __forceinline__ void store_pairs(float* zrb, float* zib, int L,
                                            int j, int vec, int M, int k1,
                                            int keep, bool self0,
                                            const float2 (&v)[2][C],
                                            const float2 (&pm)[2][C]) {
#pragma unroll
  for (int k2 = 0; k2 < C; ++k2) {
    const int k = k1 + M * k2;
    if (k >= keep) continue;
    const int i = self0 ? (C - k2) % C : C - 1 - k2;
    float2 x0, x1, x2, x3;
    separate(v[0][k2], pm[0][i], x0, x1);
    separate(v[1][k2], pm[1][i], x2, x3);
    const long a = (long)k * L + j;
    store_quad(zrb + a, j, L, vec, x0.x, x1.x, x2.x, x3.x);
    store_quad(zib + a, j, L, vec, x0.y, x1.y, x2.y, x3.y);
  }
}

// The forward stage: one cluster of C blocks per tile of W columns (W a
// multiple of 4) of one band, W/2 pair lines of M = NX / C (p its plan);
// VPT values a thread, registers for kColsMinBlocks blocks an SM.
template <int C, int VPT, bool kFFT>
__global__ void __launch_bounds__(kColsThreads, kColsMinBlocks)
psf_cols_fwd_kernel(const float* __restrict__ x, float* __restrict__ zr,
                    float* __restrict__ zi, int L, int nx, int keep,
                    int rows, int W, int vec, LinePlan p,
                    const float2* __restrict__ TN) {
  extern __shared__ float2 sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();
  const int M = p.N;
  const FastDiv fg(W / kQuad);
  const int ntile = (L + W - 1) / W;
  const int tile = blockIdx.x / C;
  const int b = tile / ntile;
  const int j0 = (tile - b * ntile) * W;
  const float* xb = x + (long)b * nx * L;
  float* zrb = zr + (long)b * rows * L;
  float* zib = zi + (long)b * rows * L;

  // 1. rows n = c + C m of the tile into the lines, lanes 0-15 of a warp
  // on 16 consecutive m (conflict-free shared stores); a thread issues
  // all kU of its loads before it stores any
  constexpr int kU = VPT / kQuad;
  const int units = ((M + 15) >> 4) * fg.d * 16;
  for (int u0 = 0; u0 < units; u0 += kU * blockDim.x) {
    float v[kU][kQuad];
    int slot[kU];
#pragma unroll
    for (int h = 0; h < kU; ++h) {
      const int u = u0 + h * blockDim.x + threadIdx.x;
      const int q = u >> 4;
      const int g = fg.mod(q), m = fg.div(q) * 16 + (u & 15);
      const int j = j0 + kQuad * g;
      const int n = c + C * m;
      slot[h] = (u < units && m < M) ? 2 * g * M + m : -1;
#pragma unroll
      for (int t = 0; t < kQuad; ++t) v[h][t] = 0.f;
      if (slot[h] >= 0 && n < nx && j < L)
        load_quad(xb + (long)n * L + j, j, L, vec, v[h]);
    }
#pragma unroll
    for (int h = 0; h < kU; ++h) {
      if (slot[h] < 0) continue;
      sm[spad(slot[h])] = make_float2(v[h][0], v[h][1]);
      sm[spad(slot[h] + M)] = make_float2(v[h][2], v[h][3]);
    }
  }
  __syncthreads();

  // 2. Y_c = the M-point DFTs of the lines
  if (kFFT) block_fft<VPT>(sm, W / 2, p, false);
  cluster.sync();

  // 3. the exchange, the C-point DFTs and the kept rows
  const float2* src[C];
#pragma unroll
  for (int r = 0; r < C; ++r) src[r] = cluster.map_shared_rank(sm, r);
  // block c takes h in [c Hc, (c + 1) Hc): k1 = h and its mirror
  const int Mh = M / 2;
  const int Hc = (Mh + C - 1) / C;
  const int work = ((Hc + 15) >> 4) * fg.d * 16;
  for (int u = threadIdx.x; u < work; u += blockDim.x) {
    const int q = u >> 4;
    const int g = fg.mod(q), hl = fg.div(q) * 16 + (u & 15);
    const int h = c * Hc + hl;
    const int j = j0 + kQuad * g;
    if (hl >= Hc || h >= Mh || j >= L) continue;
    const int ka = h, kb = h ? M - h : Mh;
    float2 va[2][C], vb[2][C];
    gather2<C, kFFT>(src, 2 * g, M, ka, TN, 1.f, va);
    gather2<C, kFFT>(src, 2 * g, M, kb, TN, 1.f, vb);
    // k1 = 0 and M/2 mirror into themselves; h > 0 into each other
    store_pairs<C>(zrb, zib, L, j, vec, M, ka, keep, h == 0, va,
                   h ? vb : va);
    store_pairs<C>(zrb, zib, L, j, vec, M, kb, keep, false, vb,
                   h ? va : vb);
  }
  // rows keep .. rows - 1 of the tile: zeros, spread over the cluster
  for (int u = c * blockDim.x + threadIdx.x; u < (rows - keep) * fg.d;
       u += C * blockDim.x) {
    const int j = j0 + kQuad * fg.mod(u);
    const long a = (long)(keep + fg.div(u)) * L + j;
    if (j < L) {
      store_quad(zrb + a, j, L, vec, 0.f, 0.f, 0.f, 0.f);
      store_quad(zib + a, j, L, vec, 0.f, 0.f, 0.f, 0.f);
    }
  }
  // 4. no block leaves while a peer may still read its shared memory
  cluster.sync();
}

// The inverse stage: one cluster of C blocks per tile of W columns of one
// band, W/2 pair lines of M = NX / C; VPT values a thread, registers for
// kColsMinBlocks blocks an SM.
template <int C, int VPT, bool kFFT>
__global__ void __launch_bounds__(kColsThreads, kColsMinBlocks)
psf_cols_inv_kernel(const float* __restrict__ wr,
                    const float* __restrict__ wi, float* __restrict__ out,
                    int L, int nx, int keep, int rows, float scale, int W,
                    int vec, LinePlan p, const float2* __restrict__ TN) {
  extern __shared__ float2 sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();
  const int M = p.N, N = C * M;
  const FastDiv fg(W / kQuad);
  const int ntile = (L + W - 1) / W;
  const int tile = blockIdx.x / C;
  const int b = tile / ntile;
  const int j0 = (tile - b * ntile) * W;
  const float* wrb = wr + (long)b * rows * L;
  const float* wib = wi + (long)b * rows * L;
  float* ob = out + (long)b * nx * L;

  // 1. spectrum rows k = c + C m of the tile: the Hermitian part of each
  // column, the pairs packed as Z = H_j + i H_{j+1}
  constexpr int kU = VPT / kQuad;
  const int units = ((M + 15) >> 4) * fg.d * 16;
  for (int u0 = 0; u0 < units; u0 += kU * blockDim.x) {
    float hr[kU][kQuad], hi[kU][kQuad];
    int slot[kU];
#pragma unroll
    for (int h = 0; h < kU; ++h) {
      const int u = u0 + h * blockDim.x + threadIdx.x;
      const int q = u >> 4;
      const int g = fg.mod(q), m = fg.div(q) * 16 + (u & 15);
      const int j = j0 + kQuad * g;
      const int k = c + C * m, mk = k ? N - k : 0;
      slot[h] = (u < units && m < M) ? 2 * g * M + m : -1;
#pragma unroll
      for (int t = 0; t < kQuad; ++t) hr[h][t] = hi[h][t] = 0.f;
      if (slot[h] < 0 || j >= L) continue;
      const bool da = k < keep, db = mk < keep;
      float ar[kQuad], ai[kQuad], br[kQuad], bi[kQuad];
      if (da) {
        load_quad(wrb + (long)k * L + j, j, L, vec, ar);
        load_quad(wib + (long)k * L + j, j, L, vec, ai);
      }
      if (db) {
        load_quad(wrb + (long)mk * L + j, j, L, vec, br);
        load_quad(wib + (long)mk * L + j, j, L, vec, bi);
      }
#pragma unroll
      for (int t = 0; t < kQuad; ++t) {
        if (da && db) {
          hr[h][t] = 0.5f * (ar[t] + br[t]);
          hi[h][t] = 0.5f * (ai[t] - bi[t]);
        } else if (da) {
          hr[h][t] = ar[t];
          hi[h][t] = ai[t];
        } else {
          hr[h][t] = br[t];
          hi[h][t] = -bi[t];
        }
      }
    }
#pragma unroll
    for (int h = 0; h < kU; ++h) {
      if (slot[h] < 0) continue;
      sm[spad(slot[h])] = make_float2(hr[h][0] - hi[h][1],
                                      hi[h][0] + hr[h][1]);
      sm[spad(slot[h] + M)] = make_float2(hr[h][2] - hi[h][3],
                                          hi[h][2] + hr[h][3]);
    }
  }
  __syncthreads();

  // 2. Y_c = the inverse M-point DFTs of the lines
  if (kFFT) block_fft<VPT>(sm, W / 2, p, true);
  cluster.sync();

  // 3. block c' finishes n1 in [c' Mc, (c' + 1) Mc); rows n1 + M n2 < nx
  const float2* src[C];
#pragma unroll
  for (int r = 0; r < C; ++r) src[r] = cluster.map_shared_rank(sm, r);
  const int Mc = (M + C - 1) / C;
  const int work = ((Mc + 15) >> 4) * fg.d * 16;
  for (int u = threadIdx.x; u < work; u += blockDim.x) {
    const int q = u >> 4;
    const int g = fg.mod(q), nl = fg.div(q) * 16 + (u & 15);
    const int n1 = c * Mc + nl;
    const int j = j0 + kQuad * g;
    if (nl >= Mc || n1 >= M || j >= L) continue;
    float2 v[2][C];
    gather2<C, kFFT>(src, 2 * g, M, n1, TN, -1.f, v);
#pragma unroll
    for (int n2 = 0; n2 < C; ++n2) {
      const int n = n1 + M * n2;
      if (n < nx)
        store_quad(ob + (long)n * L + j, j, L, vec, v[0][n2].x * scale,
                   v[0][n2].y * scale, v[1][n2].x * scale,
                   v[1][n2].y * scale);
    }
  }
  // 4. no block leaves while a peer may still read its shared memory
  cluster.sync();
}

// Threads of a block of S lines of M at VPT values a thread (a multiple of
// 32, at most kColsThreads).
static inline unsigned cols_threads(int S, int M, int VPT) {
  return (unsigned)((((S * M + VPT - 1) / VPT) + 31) / 32 * 32);
}

template <int C>
static cudaError_t fwd_c(const float* x, float* zr, float* zi, int nb,
                         int nx, int L, int keep, int rows, int W, int vec,
                         int skeleton, const LinePlan& p, const float2* TN,
                         cudaStream_t st) {
  const long blocks = (long)nb * ((L + W - 1) / W) * C;
  const int M = p.N;
  void (*k)(const float*, float*, float*, int, int, int, int, int, int,
            LinePlan, const float2*) =
      skeleton ? psf_cols_fwd_kernel<C, kVpt, false>
               : psf_cols_fwd_kernel<C, kVpt, true>;
  return launch_cluster(k, C, blocks, cols_threads(W / 2, M, kVpt),
                        smem_bytes(W / 2 * M), st, x, zr, zi, L, nx, keep,
                        rows, W, vec, p, TN);
}

template <int C>
static cudaError_t inv_c(const float* wr, const float* wi, float* out,
                         int nb, int nx, int L, int keep, int rows,
                         float scale, int W, int vec, int skeleton,
                         const LinePlan& p, const float2* TN,
                         cudaStream_t st) {
  const long blocks = (long)nb * ((L + W - 1) / W) * C;
  const int M = p.N;
  void (*k)(const float*, const float*, float*, int, int, int, int, float,
            int, int, LinePlan, const float2*) =
      skeleton ? psf_cols_inv_kernel<C, kVpt, false>
               : psf_cols_inv_kernel<C, kVpt, true>;
  return launch_cluster(k, C, blocks, cols_threads(W / 2, M, kVpt),
                        smem_bytes(W / 2 * M), st, wr, wi, out, L, nx, keep,
                        rows, scale, W, vec, p, TN);
}

// the shape checks both stages share; the plan of M = NX / C into p
static bool cols_args(int nb, int nx, int L, int NX, int keep, int rows,
                      int C, const void* TM, const void* TN, LinePlan* p) {
  return C > 0 && C == psf_cols_clusters(NX, L) && TM && TN && nb >= 1 &&
         nx >= 1 && nx <= NX && keep >= NX / 2 + 1 && keep <= NX &&
         rows >= keep && make_plan(NX / C, TM, p);
}

cudaError_t psf_cols_fwd(const float* x, float* zr, float* zi, int nb,
                         int nx, int L, int NX, int keep, int rows, int C,
                         int skeleton, const void* TM, const void* TN,
                         cudaStream_t stream) {
  LinePlan p;
  if (!cols_args(nb, nx, L, NX, keep, rows, C, TM, TN, &p))
    return cudaErrorInvalidValue;
  const int W = psf_cols_width(NX, C);
  const int vec = L % kQuad == 0 && aligned16(x) && aligned16(zr) &&
                  aligned16(zi);
  const float2* T = static_cast<const float2*>(TN);
  return C == 4 ? fwd_c<4>(x, zr, zi, nb, nx, L, keep, rows, W, vec,
                           skeleton, p, T, stream)
                : fwd_c<8>(x, zr, zi, nb, nx, L, keep, rows, W, vec,
                           skeleton, p, T, stream);
}

cudaError_t psf_cols_inv(const float* wr, const float* wi, float* out,
                         int nb, int nx, int L, int NX, int keep, int rows,
                         float scale, int C, int skeleton, const void* TM,
                         const void* TN, cudaStream_t stream) {
  LinePlan p;
  if (!cols_args(nb, nx, L, NX, keep, rows, C, TM, TN, &p))
    return cudaErrorInvalidValue;
  const int W = psf_cols_width(NX, C);
  const int vec = L % kQuad == 0 && aligned16(wr) && aligned16(wi) &&
                  aligned16(out);
  const float2* T = static_cast<const float2*>(TN);
  return C == 4 ? inv_c<4>(wr, wi, out, nb, nx, L, keep, rows, scale, W,
                           vec, skeleton, p, T, stream)
                : inv_c<8>(wr, wi, out, nb, nx, L, keep, rows, scale, W,
                           vec, skeleton, p, T, stream);
}

}  // namespace pfbt

// C of the cluster route at (NX, L), 0 where line_fft_kernel runs.
extern "C" int pfbt_psf_cols_route(int NX, int L) {
  return pfbt::psf_cols_clusters(NX, L);
}

// The forward column stage on the cluster kernel; skeleton = 1 the lab's
// copy skeleton.
extern "C" int pfbt_psf_cols_fwd(const float* x, float* zr, float* zi,
                                 int nb, int nx, int L, int NX, int keep,
                                 int rows, int C, int skeleton,
                                 const void* TM, const void* TN,
                                 void* stream) {
  return static_cast<int>(pfbt::psf_cols_fwd(
      x, zr, zi, nb, nx, L, NX, keep, rows, C, skeleton, TM, TN,
      static_cast<cudaStream_t>(stream)));
}

// The inverse column stage on the cluster kernel; skeleton = 1 the lab's
// copy skeleton.
extern "C" int pfbt_psf_cols_inv(const float* wr, const float* wi,
                                 float* out, int nb, int nx, int L, int NX,
                                 int keep, int rows, float scale, int C,
                                 int skeleton, const void* TM,
                                 const void* TN, void* stream) {
  return static_cast<int>(pfbt::psf_cols_inv(
      wr, wi, out, nb, nx, L, NX, keep, rows, scale, C, skeleton, TM, TN,
      static_cast<cudaStream_t>(stream)));
}
