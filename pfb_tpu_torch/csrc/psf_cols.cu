// The PSF-Hessian's column stages at NX >= 256: column FFTs over a
// thread-block cluster (from 2048) or a block (below).
//
// Replaces the column stages of pfb_tpu/ops/pallas_fft.py:psf_v3_stage_k1
// (:1075) and psf_v3_stage_k3 (:1153), K10's stages 1 and 3, and with them
// the column stages of K1 (psf_convolve_pallas_v3_cube), K11
// (psf_convolve_pallas), K12 (psf_convolve_pallas_v3) and K15
// (_k1h_kernel / _k3h_kernel): every entry of psf_conv.cu that runs a
// column stage launches these kernels where psf_cols_clusters holds. K2
// (psf_convolve_pallas_v3_cube_cg's _k1t_cg_kernel / _k3t_cg_kernel)
// launches them with its prologue and epilogue (CgIn, CgOut below): the
// forward kernel takes its input quads from an `In` functor and the
// inverse hands its output quads to an `Out` functor.
//
// What bounds them on the H100: bytes, each input read once and each
// output written once. line_fft_kernel keeps whole lines of NX in one
// block, so at NX = 2048 a block holds four columns, at 4096 two and at
// 8192 one, and a warp's loads and stores use 4-16 bytes of each 32-byte
// sector. Here, as
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
//
// Short columns (256 <= NX < 2048, the PSF Hessians of the 128-aligned
// images from 128^2 to 768^2, before this on line_fft_kernel and K2's
// line kernels): a whole column fits one block, so the same kernels run on
// clusters of one block where its tile is 8 columns (NX = 768-1024: the
// exchange reads the block's own shared memory, the C-point DFT is the
// identity and cluster_sync a __syncthreads), else of kTinyClusters =
// 2 (psf_cols.cuh: tiny_clusters), and tiles of up to 32 columns
// (cols_tile_width: 32 at NX = 256 and 512, 8 at 768-1536), so a block
// holds 2048-4096 pair values and each row segment it moves is 32-128
// bytes of 16-byte loads. What bounds them is
// still the bytes, but at these sizes a stage moves 0.5-20 MB, a few
// microseconds at the HBM rate, so the launch and the block's load ->
// FFT -> store latency set much of its time. The line route's shape
// there, one column per line with a zero imaginary part, S = 8192 / NX
// lines a block and 4-byte loads, does twice the FFT work of the pairs.
#include <cooperative_groups.h>

#include <type_traits>

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

int psf_cols_clusters(int NX, int L) {
  if (L < 2 || NX < kColsMinNX || NX % 4) return 0;
  const int C = NX < kShortNX  ? tiny_clusters(NX)
                : NX < 4096    ? kShortClusters
                : (NX > 4096 && NX % 8 == 0) ? 8
                                             : 4;
  const int M = NX / C;
  LinePlan p;
  if (NX % C || M % 2 || M * cols_tile_width(NX, C) > kLineElems ||
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

// The forward stage's input quads. ColsIn (K10ac): four columns of x
// as given. CgIn (K2's stage 1): the direction p = beta_b p_prev - r,
// formed in registers from 16-byte loads of p_prev and r and stored to pn
// with one 16-byte store; the FFT then sees the same values as K10ac
// loading pn, so K2's spectrum is K10ac's of its own p bit for bit.
struct ColsIn {
  const float* x;
  __device__ __forceinline__ void load(int, long a, int j, int L, int vec,
                                       float* v) const {
    load_quad(x + a, j, L, vec, v);
  }
};

struct CgIn {
  const float* pp;
  const float* rr;
  const float* beta;
  float* pn;
  __device__ __forceinline__ void load(int b, long a, int j, int L, int vec,
                                       float* v) const {
    float q[kQuad], r[kQuad];
    load_quad(pp + a, j, L, vec, q);
    load_quad(rr + a, j, L, vec, r);
    const float bb = __ldg(beta + b);
#pragma unroll
    for (int t = 0; t < kQuad; ++t) v[t] = bb * q[t] - r[t];
    store_quad(pn + a, j, L, vec, v[0], v[1], v[2], v[3]);
  }
};

// The inverse stage's output quads. ColsOut (K10cc): stored. CgOut (K2's
// stage 3): stored, and the quad of p (pn) at the same rows and columns
// read, p . out and p . p added per column in float64 (kSums columns a
// thread). The block then adds its threads' sums per column in a fixed
// order (cg_block_sums), so K2 stays deterministic with no atomics.
struct ColsOut {
  static constexpr int kSums = 0;
  float* out;
  __device__ __forceinline__ void put(long a, int j, int L, int vec,
                                      const float (&v)[kQuad],
                                      double (&)[1][2]) const {
    store_quad(out + a, j, L, vec, v[0], v[1], v[2], v[3]);
  }
};

struct CgOut {
  static constexpr int kSums = kQuad;
  float* out;
  const float* pn;
  double* part;  // (nb, L, C, 2): each block's column sums
  __device__ __forceinline__ void put(long a, int j, int L, int vec,
                                      const float (&v)[kQuad],
                                      double (&s)[kQuad][2]) const {
    store_quad(out + a, j, L, vec, v[0], v[1], v[2], v[3]);
    float q[kQuad];
    load_quad(pn + a, j, L, vec, q);
#pragma unroll
    for (int t = 0; t < kQuad; ++t) {
      const double d = q[t];
      s[t][0] += d * (double)v[t];
      s[t][1] += d * d;
    }
  }
};

// K2's per-block column sums: every thread holds the sums of the four
// columns of its quad g = (threadIdx.x / 16) mod (W / 4) (the same quad
// in every pass of the stores' loop: blockDim / 16 is a multiple of W /
// 4); the lanes of a warp with one quad are added by a fixed butterfly,
// the warps that hold a column in order into red (after the stage's last
// cluster sync, when no peer reads sm any more; at W <= 8 every warp holds
// every column), and thread t < W then holds column j0 + t's block sums in
// (*s0, *s1).
__device__ __forceinline__ bool cg_block_sums(double (&s)[kQuad][2],
                                              double* red, int W,
                                              double* s0, double* s1) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarp = blockDim.x / 32, nq = W / kQuad;
#pragma unroll
  for (int t = 0; t < kQuad; ++t)
#pragma unroll
    for (int u = 0; u < 2; ++u)
      for (int o = nq == 1 ? 16 : 8; o > 0; o >>= 1)
        s[t][u] += __shfl_xor_sync(0xffffffffu, s[t][u], o);
  // lane 0 holds quad (2 warp) mod nq's sums, lane 16 quad (2 warp + 1)
  // mod nq's (nq >= 2)
  if (lane % 16 == 0 && lane / 16 < nq)
#pragma unroll
    for (int t = 0; t < kQuad; ++t) {
      const int col = ((threadIdx.x >> 4) % nq) * kQuad + t;
      red[2 * (warp * W + col)] = s[t][0];
      red[2 * (warp * W + col) + 1] = s[t][1];
    }
  __syncthreads();
  const int col = threadIdx.x;
  if (col >= W) return false;
  const int g = col / kQuad;
  double a0 = 0.0, a1 = 0.0;
  for (int w = 0; w < nwarp; ++w) {
    if (nq > 2 && (2 * w) % nq != g && (2 * w + 1) % nq != g) continue;
    a0 += red[2 * (w * W + col)];
    a1 += red[2 * (w * W + col) + 1];
  }
  *s0 = a0;
  *s1 = a1;
  return true;
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
template <int C, int VPT, bool kFFT, class In>
__global__ void __launch_bounds__(kColsThreads, kColsMinBlocks)
psf_cols_fwd_kernel(In in, float* __restrict__ zr, float* __restrict__ zi,
                    int L, int nx, int keep, int rows, int W, int vec,
                    LinePlan p, const float2* __restrict__ TN) {
  extern __shared__ float2 sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();
  const int M = p.N;
  const FastDiv fg(W / kQuad);
  const int ntile = (L + W - 1) / W;
  const int tile = blockIdx.x / C;
  const int b = tile / ntile;
  const int j0 = (tile - b * ntile) * W;
  const long xb = (long)b * nx * L;
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
        in.load(b, xb + (long)n * L + j, j, L, vec, v[h]);
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
  cluster_sync<C>(cluster);

  // 3. the exchange, the C-point DFTs and the kept rows
  const float2* src[C];
#pragma unroll
  for (int r = 0; r < C; ++r)
    src[r] = C == 1 ? sm : cluster.map_shared_rank(sm, r);
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
  cluster_sync<C>(cluster);
}

// The inverse stage: one cluster of C blocks per tile of W columns of one
// band, W/2 pair lines of M = NX / C; VPT values a thread, registers for
// kColsMinBlocks blocks an SM.
template <int C, int VPT, bool kFFT, class Out>
__global__ void __launch_bounds__(kColsThreads, kColsMinBlocks)
psf_cols_inv_kernel(const float* __restrict__ wr,
                    const float* __restrict__ wi, Out o, int L, int nx,
                    int keep, int rows, float scale, int W, int vec,
                    LinePlan p, const float2* __restrict__ TN) {
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
  const long ob = (long)b * nx * L;

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
  cluster_sync<C>(cluster);

  // 3. block c' finishes n1 in [c' Mc, (c' + 1) Mc); rows n1 + M n2 < nx
  const float2* src[C];
#pragma unroll
  for (int r = 0; r < C; ++r)
    src[r] = C == 1 ? sm : cluster.map_shared_rank(sm, r);
  const int Mc = (M + C - 1) / C;
  const int work = ((Mc + 15) >> 4) * fg.d * 16;
  double acc[Out::kSums ? Out::kSums : 1][2] = {};
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
      const float s[kQuad] = {v[0][n2].x * scale, v[0][n2].y * scale,
                              v[1][n2].x * scale, v[1][n2].y * scale};
      if (n < nx) o.put(ob + (long)n * L + j, j, L, vec, s, acc);
    }
  }
  // 4. no block leaves while a peer may still read its shared memory
  cluster_sync<C>(cluster);
  if constexpr (Out::kSums > 0) {
    // K2: this block's column sums of the tile, (nb, L, C, 2); band_sums
    // adds a column's C partials in block order (adding them through DSMEM
    // on block 0 instead costs a third cluster.sync and measured 0.02-0.04
    // ms slower on the H100: PERF.md)
    double s0, s1;
    const int j = j0 + (int)threadIdx.x;
    if (cg_block_sums(acc, reinterpret_cast<double*>(sm), W, &s0, &s1) &&
        j < L) {
      const long a = (((long)b * L + j) * C + c) * 2;
      o.part[a] = s0;
      o.part[a + 1] = s1;
    }
  }
}

// Threads of a block of S lines of M at VPT values a thread (a multiple of
// 32, at most kColsThreads).
static inline unsigned cols_threads(int S, int M, int VPT) {
  return (unsigned)((((S * M + VPT - 1) / VPT) + 31) / 32 * 32);
}

template <int C, class In>
static cudaError_t fwd_c(In in, float* zr, float* zi, int nb, int nx, int L,
                         int keep, int rows, int W, int vec, int skeleton,
                         const LinePlan& p, const float2* TN,
                         cudaStream_t st) {
  const long blocks = (long)nb * ((L + W - 1) / W) * C;
  const int M = p.N;
  void (*k)(In, float*, float*, int, int, int, int, int, int, LinePlan,
            const float2*) = psf_cols_fwd_kernel<C, kVpt, true, In>;
  // the lab's skeleton of the plain stage only (K2's entries pass 0)
  if constexpr (std::is_same_v<In, ColsIn>)
    if (skeleton) k = psf_cols_fwd_kernel<C, kVpt, false, In>;
  return launch_cluster(k, C, blocks, cols_threads(W / 2, M, kVpt),
                        smem_bytes(W / 2 * M), st, in, zr, zi, L, nx, keep,
                        rows, W, vec, p, TN);
}

template <int C, class Out>
static cudaError_t inv_c(const float* wr, const float* wi, Out o, int nb,
                         int nx, int L, int keep, int rows, float scale,
                         int W, int vec, int skeleton, const LinePlan& p,
                         const float2* TN, cudaStream_t st) {
  const long blocks = (long)nb * ((L + W - 1) / W) * C;
  const int M = p.N;
  const unsigned threads = cols_threads(W / 2, M, kVpt);
  // K2's sums keep a thread on one quad (cg_block_sums)
  if (Out::kSums && (threads / 16) % (W / kQuad)) return cudaErrorInvalidValue;
  void (*k)(const float*, const float*, Out, int, int, int, int, float, int,
            int, LinePlan, const float2*) =
      psf_cols_inv_kernel<C, kVpt, true, Out>;
  if constexpr (std::is_same_v<Out, ColsOut>)
    if (skeleton) k = psf_cols_inv_kernel<C, kVpt, false, Out>;
  return launch_cluster(k, C, blocks, threads,
                        smem_bytes(W / 2 * M), st, wr, wi, o, L, nx, keep,
                        rows, scale, W, vec, p, TN);
}

// the shape checks both stages share; the plan of M = NX / C into p
static bool cols_args(int nb, int nx, int L, int NX, int keep, int rows,
                      int C, const void* TM, const void* TN, LinePlan* p) {
  return C > 0 && C == psf_cols_clusters(NX, L) && TM && TN && nb >= 1 &&
         nx >= 1 && nx <= NX && keep >= NX / 2 + 1 && keep <= NX &&
         rows >= keep && make_plan(NX / C, TM, p);
}

template <class In>
static cudaError_t cols_fwd(In in, bool aligned, float* zr, float* zi,
                            int nb, int nx, int L, int NX, int keep,
                            int rows, int C, int skeleton, const void* TM,
                            const void* TN, cudaStream_t stream) {
  LinePlan p;
  if (!cols_args(nb, nx, L, NX, keep, rows, C, TM, TN, &p))
    return cudaErrorInvalidValue;
  const int W = cols_tile_width(NX, C);
  const int vec = L % kQuad == 0 && aligned && aligned16(zr) &&
                  aligned16(zi);
  const float2* T = static_cast<const float2*>(TN);
  const auto launch = C == 8   ? fwd_c<8, In>
                      : C == 4 ? fwd_c<4, In>
                      : C == kShortClusters ? fwd_c<kShortClusters, In>
                      : C == kTinyClusters  ? fwd_c<kTinyClusters, In>
                                            : fwd_c<1, In>;
  return launch(in, zr, zi, nb, nx, L, keep, rows, W, vec, skeleton, p, T,
                stream);
}

template <class Out>
static cudaError_t cols_inv(const float* wr, const float* wi, Out o,
                            bool aligned, int nb, int nx, int L, int NX,
                            int keep, int rows, float scale, int C,
                            int skeleton, const void* TM, const void* TN,
                            cudaStream_t stream) {
  LinePlan p;
  if (!cols_args(nb, nx, L, NX, keep, rows, C, TM, TN, &p))
    return cudaErrorInvalidValue;
  const int W = cols_tile_width(NX, C);
  const int vec = L % kQuad == 0 && aligned && aligned16(wr) &&
                  aligned16(wi);
  const float2* T = static_cast<const float2*>(TN);
  const auto launch = C == 8   ? inv_c<8, Out>
                      : C == 4 ? inv_c<4, Out>
                      : C == kShortClusters ? inv_c<kShortClusters, Out>
                      : C == kTinyClusters  ? inv_c<kTinyClusters, Out>
                                            : inv_c<1, Out>;
  return launch(wr, wi, o, nb, nx, L, keep, rows, scale, W, vec, skeleton, p,
                T, stream);
}

cudaError_t psf_cols_fwd(const float* x, float* zr, float* zi, int nb,
                         int nx, int L, int NX, int keep, int rows, int C,
                         int skeleton, const void* TM, const void* TN,
                         cudaStream_t stream) {
  return cols_fwd(ColsIn{x}, aligned16(x), zr, zi, nb, nx, L, NX, keep,
                  rows, C, skeleton, TM, TN, stream);
}

cudaError_t psf_cols_inv(const float* wr, const float* wi, float* out,
                         int nb, int nx, int L, int NX, int keep, int rows,
                         float scale, int C, int skeleton, const void* TM,
                         const void* TN, cudaStream_t stream) {
  return cols_inv(wr, wi, ColsOut{out}, aligned16(out), nb, nx, L, NX, keep,
                  rows, scale, C, skeleton, TM, TN, stream);
}

cudaError_t psf_cols_fwd_cg(const float* pp, const float* rr,
                            const float* beta, float* pn, float* zr,
                            float* zi, int nb, int nx, int L, int NX, int C,
                            const void* TM, const void* TN,
                            cudaStream_t stream) {
  const int nxh = NX / 2 + 1;
  return cols_fwd(CgIn{pp, rr, beta, pn},
                  aligned16(pp) && aligned16(rr) && aligned16(pn), zr, zi,
                  nb, nx, L, NX, nxh, nxh, C, 0, TM, TN, stream);
}

cudaError_t psf_cols_inv_cg(const float* wr, const float* wi,
                            const float* pn, float* out, double* part,
                            int nb, int nx, int L, int NX, float scale,
                            int C, const void* TM, const void* TN,
                            cudaStream_t stream) {
  const int nxh = NX / 2 + 1;
  return cols_inv(wr, wi, CgOut{out, pn, part},
                  aligned16(pn) && aligned16(out), nb, nx, L, NX, nxh, nxh,
                  scale, C, 0, TM, TN, stream);
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
