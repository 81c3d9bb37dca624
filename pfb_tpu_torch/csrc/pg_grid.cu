// K4: the pg gridder's spread. Every live uv tile's visibilities are
// spread onto the tile's halo'd (2, nw, Thx, Thy) block of both
// components, all w planes.
//
// Replaces pfb_tpu/ops/pgridder.py:_grid_pallas (Pallas kernel
// _grid_kernel): per entry of C visibilities,
//   out[p, x, y] += sum_c CW[p, c] CU[x, c] CV[c, y] v_c,
// accumulated over the tile's consecutive entries. Output (2, nw, NS,
// Thx, Thy) float32 for the compact tile slots (slot order and the entry
// range [start, start + count) of each slot come from the caller; a slot
// with no entries is left unwritten: the fold reads only live slots).
//
// What bounds it on the H100, and what the design does about it:
// - The TPU kernel forms a dense (nw Thx, C) @ (C, 2 Thy) product per
//   entry because its matrix unit wants dense tiles; only k^3 of those
//   products per visibility and component are nonzero (343 of 20,480 at
//   k = 7, nw = 10). Here each visibility is reduced to its k + 1 taps
//   per axis (pg_es.cuh), and only the taps are multiplied.
// - A tile's whole w column, (2, nw, Thx, Thy) float32, is 164 KB at
//   k = 7, nw = 10 and more for the PSF grid or larger tiles: too much
//   for one block's shared memory. So the block is cut into patches of
//   one plane x kRows rows x 32 columns; a warp owns a patch and keeps
//   it in registers (lane = column, 2 kRows accumulators a lane).
// - A block takes the patches of GCOL adjacent patch columns (rb, cb) x
//   PZ planes (spread_shape: all planes of one patch column where nw >=
//   8, up to 16; several columns where nw is small), so the region it
//   covers is small and most of a slot's visibilities miss it. The
//   block walks the slot's visibilities (its entries concatenated, in
//   plan order) in rounds of 32 a warp: (1) each warp tests 32
//   candidates against the block's region and publishes a ballot mask;
//   (2) the candidates that meet the region are compacted, in plan
//   order, into a shared list with their first taps and values; (3) the
//   block evaluates the listed visibilities' 3 (k + 1) tap factors, one
//   (visibility, axis, tap) a thread; (4) each warp ballots the list
//   against its own patch and accumulates the hits in order. The
//   factors are evaluated once a block for the visibilities that meet
//   its region (the earlier design evaluated every visibility's factors
//   in every block of its slot, and had every warp test every
//   visibility one at a time: PERF.md has the split), and a round of 32
//   candidates a warp shares four barriers. At the paths' k = 7 a hit's
//   rows are one warp-uniform jump to code with the rows and factor
//   offsets as constants (hit_rows_at), four hits' loads ahead of their
//   rows; other k take a predicated loop over the patch's rows.
// - What is left bounds it: the slot with the longest chain (its
//   entries, one round after another, in each of its blocks) takes about
//   the whole kernel's time on the pg path's plans (PERF.md, "longest
//   slot alone").
// - Deterministic without atomics, and bit for bit the earlier design's
//   grids: every grid cell belongs to one lane, which sums the same
//   products (es_tap / first_tap, the same float operations) over its
//   visibilities in plan order; the lists skip only visibilities whose
//   support misses the cell's patch, which added nothing there.
// FP32 FMA throughout, expf/sqrtf for the factors; no fast math.
//
// K7, the same kernel over one w block of the w-plane-blocked engine
// (pfb_tpu_torch/ops/pg_stream.py), replaces
// pfb_tpu/ops/pg_stream.py:_grid_pallas_gs (Pallas kernel
// _grid_kernel_gs, "identical math to pgridder._grid_kernel"): a slot's
// entries are positions [start, start + count) of the block's entry map
// gmap, which point into the global (tile, w)-sorted stream; the w
// coordinate there is absolute and the block's first plane woff is
// subtracted in float32 (exact for the planes a visibility reaches, so
// taps at exactly k/2 are decided as in K4), and the w factors are
// evaluated for every block size, one plane included. Output (2, B, NT,
// Thx, Thy) for the block's B planes and NT compact slots; slots with no
// entry (the colour padding) are left unwritten.
//
// The lab's skeleton instances (kMode > 0, scripts/torch_kernel_lab.py
// --spread) drop parts from the end: 1 counts the hits instead of
// accumulating them, 2 drops the warps' pass over the list, 3 the factor
// evaluation, 4 everything but the rounds' barriers.
#include "pg_es.cuh"
#include "pg_spread.cuh"

namespace pfbt {

constexpr int kRows = 16;       // rows of a warp's patch
constexpr int kBlockWarps = 8;  // warps a block where nw allows fewer
constexpr int kCompiledKT = 8;  // the taps of the paths' k = 7 (eps 1e-5)
constexpr int kHitBatch = 4;    // hits a warp loads before it adds them
static_assert(kCompiledKT % 4 == 0 && kCompiledKT <= kRows,
              "the factor loads are float4 and a hit's offset one jump");

// Patches of a block: PZ planes of GCOL patch columns; NPG plane groups,
// NCG column groups; warps = PZ GCOL (at most 16).
struct SpreadShape {
  int PZ, GCOL, NPG, NCG, warps;
};

static SpreadShape spread_shape(int nw, int ncol) {
  SpreadShape s;
  s.NPG = (nw + 15) / 16;
  s.PZ = (nw + s.NPG - 1) / s.NPG;
  s.GCOL = s.PZ >= kBlockWarps ? 1 : kBlockWarps / s.PZ;
  if (s.GCOL > ncol) s.GCOL = ncol;
  s.NCG = (ncol + s.GCOL - 1) / s.GCOL;
  s.warps = s.PZ * s.GCOL;
  return s;
}

// Shared-memory bytes of a block of `warps` warps at k: a round's list of
// up to 32 candidates a warp (first taps, coordinates, 3 (k + 1) factors
// and the value of each) and the warps' ballot masks.
static size_t spread_smem(int warps, int k) {
  const size_t n = 32 * static_cast<size_t>(warps);
  return n * (sizeof(int4) + (3 * (k + 1) + 5) * sizeof(float)) +
         warps * sizeof(unsigned);
}

// One hit's rows of a patch: rows r of the patch with 0 <= r - O < KT get
// the column factor c[r - O] times (wr, wi), O = (first x tap) - (patch's
// first row). At a compile-time O the rows and offsets are constants, so
// a hit costs its (at most KT) rows, with no per-row test.
template <int O, int KT>
__device__ __forceinline__ void hit_rows(float (&ar)[kRows],
                                         float (&ai)[kRows],
                                         const float (&c)[KT], float wr,
                                         float wi) {
#pragma unroll
  for (int r = O > 0 ? O : 0; r < kRows && r < O + KT; ++r) {
    ar[r] = fmaf(c[r - O], wr, ar[r]);
    ai[r] = fmaf(c[r - O], wi, ai[r]);
  }
}

// hit_rows at the runtime offset o in (-KT, kRows): one warp-uniform jump
// to the instance of its O (KT <= kRows, so o + kRows is in [0, 32)).
template <int KT>
__device__ __forceinline__ void hit_rows_at(int o, float (&ar)[kRows],
                                            float (&ai)[kRows],
                                            const float (&c)[KT], float wr,
                                            float wi) {
#define PFBT_HIT(i)                               \
  case i:                                         \
    hit_rows<(i) - kRows, KT>(ar, ai, c, wr, wi); \
    break;
#define PFBT_HIT4(i) PFBT_HIT(i) PFBT_HIT(i + 1) PFBT_HIT(i + 2) PFBT_HIT(i + 3)
  switch (o + kRows) {
    PFBT_HIT4(0) PFBT_HIT4(4) PFBT_HIT4(8) PFBT_HIT4(12)
    PFBT_HIT4(16) PFBT_HIT4(20) PFBT_HIT4(24) PFBT_HIT4(28)
    default: break;
  }
#undef PFBT_HIT4
#undef PFBT_HIT
}

// kGS: K7 (entries through the block's map gmap, w relative to woff,
// w factors always); otherwise K4 (entries in plan order, w factors when
// nw > 1). kKT: the tap count k + 1 where the paths' k = 7 takes the
// compile-time rows (hit_rows_at), 0 for any k (a predicated row loop).
// kMode: 0 the kernel, > 0 the lab's skeletons (file comment).
template <bool kGS, int kKT, int kMode>
__global__ void __launch_bounds__(512)
pg_spread_kernel(const float* __restrict__ pos, const float* __restrict__ vis,
                 const int* __restrict__ gmap, const int* __restrict__ start,
                 const int* __restrict__ count, float* __restrict__ out,
                 int C, int NS, int nw, int Thx, int Thy, int k, float beta,
                 float woff, int PZ, int GCOL, int NPG) {
  extern __shared__ int4 smi[];
  const int s = blockIdx.x;
  const int e0 = start[s];
  const int ne = count[s];
  if (ne == 0) return;  // no live tile: the fold never reads this slot
  const int KT = k + 1;
  const bool do_w = kGS || nw > 1;
  const int KW = do_w ? KT : 1;
  const int RB = (Thx + kRows - 1) / kRows, CB = (Thy + 31) / 32;
  const int ncol = RB * CB;
  const int NW = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cg = blockIdx.y / NPG, pg = blockIdx.y - cg * NPG;
  // this warp's patch
  const int col = cg * GCOL + warp / PZ;
  const int p = pg * PZ + warp % PZ;
  const bool active = col < ncol && p < nw && p < (pg + 1) * PZ;
  const int xlo = (col / CB) * kRows, ylo = (col % CB) * 32;
  const int y = ylo + lane;
  // the block's region: its patch columns' bounding box and its planes
  const int c0 = cg * GCOL, c1 = min(c0 + GCOL, ncol) - 1;
  const bool one_row = c0 / CB == c1 / CB;
  const int bx0 = (c0 / CB) * kRows, bx1 = (c1 / CB + 1) * kRows;
  const int by0 = one_row ? (c0 % CB) * 32 : 0;
  const int by1 = one_row ? (c1 % CB + 1) * 32 : CB * 32;
  const int bp0 = pg * PZ, bp1 = min(nw, bp0 + PZ);
  // the round's list: first taps (x, y, w) [n], coordinates (x, y, w)
  // [3][n], the u, v, w tap factors [3][n][KT], the values [2][n]; then
  // the warps' masks
  const int n = 32 * NW;
  int4* tap = smi;
  float* crd = reinterpret_cast<float*>(tap + n);
  float* fu = crd + 3 * n;
  float* fv = fu + n * KT;
  float* fw = fv + n * KT;
  float* vr = fw + n * KT;
  float* vi = vr + n;
  unsigned* masks = reinterpret_cast<unsigned*>(vi + n);

  const float kh = 0.5f * static_cast<float>(k);
  const float betak = beta * static_cast<float>(k);
  const float rkh = 1.0f / kh;
  float ar[kRows], ai[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) ar[r] = ai[r] = 0.0f;

  const int total = ne * C;
  for (int i0 = 0; i0 < total; i0 += n) {
    __syncthreads();  // the previous round's list is consumed
    if (kMode == 4) continue;
    // 1. this warp's 32 candidates against the block's region
    const int i = i0 + 32 * warp + lane;
    bool hit = false;
    float cx = 0.f, cy = 0.f, cz = 0.f, v0 = 0.f, v1 = 0.f;
    int tx = 0, ty = 0, tz = 0;
    if (i < total) {
      const int m = i / C, c = i - m * C;
      const int e = kGS ? gmap[e0 + m] : e0 + m;
      const float* pe = pos + static_cast<size_t>(e) * 8 * C;
      const float* ve = vis + static_cast<size_t>(e) * 2 * C;
      cx = pe[c];
      cy = pe[C + c];
      cz = do_w ? pe[2 * C + c] - woff : 0.f;
      v0 = ve[c];
      v1 = ve[C + c];
      tx = first_tap(cx, kh);
      ty = first_tap(cy, kh);
      tz = do_w ? first_tap(cz, kh) : 0;
      hit = tx + KT > bx0 && tx < bx1 && ty + KT > by0 && ty < by1 &&
            tz + KW > bp0 && tz < bp1;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) masks[warp] = mask;
    __syncthreads();
    // 2. the hits into the list, in plan order
    int off = 0, nl = 0;
    for (int w = 0; w < NW; ++w) {
      const int cnt = __popc(masks[w]);
      off += w < warp ? cnt : 0;
      nl += cnt;
    }
    if (hit) {
      const int j = off + __popc(mask & ((1u << lane) - 1u));
      tap[j] = make_int4(tx, ty, tz, 0);
      crd[j] = cx;
      crd[n + j] = cy;
      crd[2 * n + j] = cz;
      vr[j] = v0;
      vi[j] = v1;
    }
    __syncthreads();
    // 3. the listed visibilities' tap factors
    if (kMode <= 2) {
      for (int t = threadIdx.x; t < 3 * nl * KT; t += blockDim.x) {
        const int a = t / (nl * KT);
        const int r = t - a * nl * KT;
        const int j = r / KT, jj = r - j * KT;
        const float x = crd[a * n + j];
        fu[a * n * KT + r] =
            a < 2 || do_w
                ? es_tap(static_cast<float>(first_tap(x, kh) + jj), x, rkh,
                         betak)
                : (jj == 0 ? 1.0f : 0.0f);
      }
      __syncthreads();
    }
    if (kMode >= 2 || !active) continue;
    // 4. the warp's hits among the listed, in order
    for (int b = 0; b < nl; b += 32) {
      const int j = b + lane;
      bool mine = false;
      if (j < nl) {
        const int4 t = tap[j];
        mine = p >= t.z && p < t.z + KW && t.x + KT > xlo &&
               t.x < xlo + kRows && t.y + KT > ylo && t.y < ylo + 32;
      }
      unsigned hits = __ballot_sync(0xffffffffu, mine);
      if constexpr (kKT > 0 && kMode == 0) {
        // kHitBatch hits at a time: all their loads, then their rows in
        // list order, so the loads of a batch overlap
        while (hits) {
          float c[kHitBatch][kKT], hr[kHitBatch], hi[kHitBatch];
          int ho[kHitBatch];
          bool ok[kHitBatch];
#pragma unroll
          for (int q = 0; q < kHitBatch; ++q) {
            const int jh = b + (hits ? __ffs(hits) - 1 : 0);
            ok[q] = hits != 0;
            hits &= hits - 1;
            const int4 t = tap[jh];
            const int dy = y - t.y;
            ok[q] = ok[q] && dy >= 0 && dy < kKT;
            const int u = jh * kKT;
            const float f = fv[u + (ok[q] ? dy : 0)] *
                            fw[u + (ok[q] ? p - t.z : 0)];
            hr[q] = f * vr[jh];
            hi[q] = f * vi[jh];
            ho[q] = t.x - xlo;
#pragma unroll
            for (int i = 0; i < kKT; i += 4) {
              const float4 v = *reinterpret_cast<const float4*>(fu + u + i);
              c[q][i] = v.x;
              c[q][i + 1] = v.y;
              c[q][i + 2] = v.z;
              c[q][i + 3] = v.w;
            }
          }
#pragma unroll
          for (int q = 0; q < kHitBatch; ++q)
            if (ok[q]) hit_rows_at<kKT>(ho[q], ar, ai, c[q], hr[q], hi[q]);
        }
        continue;
      }
      // any k: a hit at a time, a predicated row loop
      while (hits) {
        const int jh = b + __ffs(hits) - 1;
        hits &= hits - 1;
        const int4 t = tap[jh];
        const int dy = y - t.y;
        if (dy < 0 || dy >= KT) continue;
        if (kMode == 1) {
          ar[0] += 1.0f;
          continue;
        }
        // the row's factor, by plane tap and column tap, times the value
        const int u = jh * KT;
        const float f = fv[u + dy] * fw[u + p - t.z];
        const float wr = f * vr[jh], wi = f * vi[jh];
        const float* cu = fu + u;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int dx = xlo + r - t.x;
          if (dx >= 0 && dx < KT) {
            ar[r] = fmaf(cu[dx], wr, ar[r]);
            ai[r] = fmaf(cu[dx], wi, ai[r]);
          }
        }
      }
    }
  }
  if (!active || y >= Thy) return;
  const size_t P = static_cast<size_t>(Thx) * Thy;
  float* o_r = out + (static_cast<size_t>(p) * NS + s) * P + y;
  float* o_i = out + (static_cast<size_t>(nw + p) * NS + s) * P + y;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int x = xlo + r;
    if (x < Thx) {
      o_r[static_cast<size_t>(x) * Thy] = ar[r];
      o_i[static_cast<size_t>(x) * Thy] = ai[r];
    }
  }
}

template <bool kGS, int kKT, int kMode>
static cudaError_t launch_mode(const float* pos, const float* vis,
                               const int* gmap, const int* start,
                               const int* count, float* out, int C, int NS,
                               int nw, int Thx, int Thy, int k, float beta,
                               float woff, const SpreadShape& sh,
                               size_t smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      pg_spread_kernel<kGS, kKT, kMode>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(NS, sh.NCG * sh.NPG);
  pg_spread_kernel<kGS, kKT, kMode><<<grid, 32 * sh.warps, smem, st>>>(
      pos, vis, gmap, start, count, out, C, NS, nw, Thx, Thy, k, beta, woff,
      sh.PZ, sh.GCOL, sh.NPG);
  return cudaGetLastError();
}

template <bool kGS>
static cudaError_t launch_spread(const float* pos, const float* vis,
                                 const int* gmap, const int* start,
                                 const int* count, float* out, int C, int NS,
                                 int nw, int Thx, int Thy, int k,
                                 double beta, int woff, int mode,
                                 cudaStream_t st) {
  if (k < 1 || k + 1 > kMaxTaps || NS < 1 || nw < 1 || C < 1 || Thx < 1 ||
      Thy < 1 || mode < 0 || mode > 4 || (mode && k + 1 != kCompiledKT))
    return cudaErrorInvalidValue;
  const int ncol = ((Thx + kRows - 1) / kRows) * ((Thy + 31) / 32);
  const SpreadShape sh = spread_shape(nw, ncol);
  const size_t smem = spread_smem(sh.warps, k);
  const float b = static_cast<float>(beta), wo = static_cast<float>(woff);
#define PFBT_SPREAD(M)                                                        \
  launch_mode<kGS, kCompiledKT, M>(pos, vis, gmap, start, count, out, C, NS, \
                                   nw, Thx, Thy, k, b, wo, sh, smem, st)
  if (k + 1 != kCompiledKT)
    return launch_mode<kGS, 0, 0>(pos, vis, gmap, start, count, out, C, NS,
                                  nw, Thx, Thy, k, b, wo, sh, smem, st);
  switch (mode) {
    case 0: return PFBT_SPREAD(0);
    case 1: return PFBT_SPREAD(1);
    case 2: return PFBT_SPREAD(2);
    case 3: return PFBT_SPREAD(3);
    default: return PFBT_SPREAD(4);
  }
#undef PFBT_SPREAD
}

cudaError_t pg_spread_launch(const float* pos, const float* vis,
                             const int* gmap, const int* start,
                             const int* count, float* out, int C, int NS,
                             int nw, int Thx, int Thy, int k, double beta,
                             int woff, int mode, cudaStream_t st) {
  return gmap ? launch_spread<true>(pos, vis, gmap, start, count, out, C,
                                    NS, nw, Thx, Thy, k, beta, woff, mode,
                                    st)
              : launch_spread<false>(pos, vis, gmap, start, count, out, C,
                                     NS, nw, Thx, Thy, k, beta, woff, mode,
                                     st);
}

}  // namespace pfbt

// K4. pos (NE, 8, C), vis (NE, 2, C), start/count (NS,) int32 -> out (2,
// nw, NS, Thx, Thy); slots with no entries are left unwritten. Returns a
// CUDA error code (0 on success).
extern "C" int pfbt_pg_spread(const float* pos, const float* vis,
                              const int* start, const int* count,
                              float* out, int C, int NS, int nw, int Thx,
                              int Thy, int k, double beta, void* stream) {
  return static_cast<int>(pfbt::launch_spread<false>(
      pos, vis, nullptr, start, count, out, C, NS, nw, Thx, Thy, k, beta, 0,
      0, static_cast<cudaStream_t>(stream)));
}

// K7. pos (NEg + 1, 8, C) and vis (NEg + 1, 2, C) of the global stream,
// the block's entry map gmap (its live prefix) and per-slot map ranges
// start/count (NT,) int32, the block's first plane woff -> out (2, B, NT,
// Thx, Thy); slots with no entries are left unwritten.
extern "C" int pfbt_pg_spread_gs(const float* pos, const float* vis,
                                 const int* gmap, const int* start,
                                 const int* count, float* out, int C, int NT,
                                 int B, int Thx, int Thy, int k, int woff,
                                 double beta, void* stream) {
  return static_cast<int>(pfbt::launch_spread<true>(
      pos, vis, gmap, start, count, out, C, NT, B, Thx, Thy, k, beta, woff,
      0, static_cast<cudaStream_t>(stream)));
}
