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
//   it in registers (lane = column, 2 kRows accumulators a lane), and a
//   block of 8 warps takes 8 patches of one tile. Shared memory holds
//   only the current entry's visibility factors, computed once per block
//   and entry, one (visibility, axis, tap) per thread.
// - Each warp walks the tile's visibilities in plan order and skips, with
//   one warp-uniform test on the visibility's first taps, those whose
//   support misses its patch; that scan, not the arithmetic, bounds the
//   kernel. The tile with the most entries (the dense core of the uv
//   coverage) sets the longest chain.
// - Deterministic without atomics: every grid cell belongs to one lane,
//   which sums its visibilities in plan order, so reruns are bitwise
//   equal.
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
#include "pg_es.cuh"

namespace pfbt {

constexpr int kRows = 16;  // rows of a warp's patch
constexpr int kWarps = 8;  // patches (warps) of a block

// kGS: K7 (entries through the block's map gmap, w relative to woff,
// w factors always); otherwise K4 (entries in plan order, w factors when
// nw > 1).
template <bool kGS>
__global__ void pg_spread_kernel(const float* __restrict__ pos,
                                 const float* __restrict__ vis,
                                 const int* __restrict__ gmap,
                                 const int* __restrict__ start,
                                 const int* __restrict__ count,
                                 float* __restrict__ out, int C, int NS,
                                 int nw, int Thx, int Thy, int k,
                                 float beta, float woff) {
  extern __shared__ int4 smi[];
  const int s = blockIdx.x;
  const int e0 = start[s];
  const int ne = count[s];
  if (ne == 0) return;  // no live tile: the fold never reads this slot
  const int KT = k + 1;
  const bool do_w = kGS || nw > 1;
  const int KW = do_w ? KT : 1;
  const int RB = (Thx + kRows - 1) / kRows, CB = (Thy + 31) / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int patch = blockIdx.y * kWarps + warp;
  const bool active = patch < nw * RB * CB;
  const int p = patch / (RB * CB);
  const int rb = (patch / CB) % RB;
  const int xlo = rb * kRows, ylo = (patch % CB) * 32;
  const int y = ylo + lane;
  // per-entry visibility data: first taps (x, y, w) [C], then the u, v,
  // w tap factors [C][KT] and the values [C]
  int4* tap = smi;
  float* fu = reinterpret_cast<float*>(tap + C);
  float* fv = fu + C * KT;
  float* fw = fv + C * KT;
  float* vr = fw + C * KT;
  float* vi = vr + C;

  const float kh = 0.5f * static_cast<float>(k);
  const float betak = beta * static_cast<float>(k);
  const float rkh = 1.0f / kh;
  float ar[kRows], ai[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) ar[r] = ai[r] = 0.0f;

  for (int m = e0; m < e0 + ne; ++m) {
    __syncthreads();  // the previous entry's data are consumed
    const int e = kGS ? gmap[m] : m;
    const float* pe = pos + static_cast<size_t>(e) * 8 * C;
    const float* ve = vis + static_cast<size_t>(e) * 2 * C;
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      tap[c] = make_int4(first_tap(pe[c], kh), first_tap(pe[C + c], kh),
                         do_w ? first_tap(pe[2 * C + c] - woff, kh) : 0, 0);
      vr[c] = ve[c];
      vi[c] = ve[C + c];
    }
    for (int i = threadIdx.x; i < 3 * C * KT; i += blockDim.x) {
      const int a = i / (C * KT);
      const int r = i - a * C * KT;
      const int c = r / KT, j = r - c * KT;
      const float x = a == 2 ? pe[a * C + c] - woff : pe[a * C + c];
      fu[a * C * KT + r] =
          a < 2 || do_w
              ? es_tap(static_cast<float>(first_tap(x, kh) + j), x, rkh,
                       betak)
              : (j == 0 ? 1.0f : 0.0f);
    }
    __syncthreads();
    if (!active) continue;
    for (int c = 0; c < C; ++c) {
      const int4 t = tap[c];  // (x, y, w) first taps
      if (p < t.z || p >= t.z + KW || t.x + KT <= xlo ||
          t.x >= xlo + kRows || t.y + KT <= ylo || t.y >= ylo + 32)
        continue;  // warp-uniform: the support misses this patch
      const int dy = y - t.y;
      if (dy < 0 || dy >= KT) continue;
      const float f = fv[c * KT + dy] * fw[c * KT + p - t.z];
      const float wr = f * vr[c], wi = f * vi[c];
      const float* cu = fu + c * KT;
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

template <bool kGS>
int launch_spread(const float* pos, const float* vis, const int* gmap,
                  const int* start, const int* count, float* out, int C,
                  int NS, int nw, int Thx, int Thy, int k, double beta,
                  int woff, void* stream) {
  if (k < 1 || k + 1 > kMaxTaps || NS < 1 || nw < 1 || C < 1 || Thx < 1 ||
      Thy < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(C) *
      (sizeof(int4) + (3 * (k + 1) + 2) * sizeof(float));
  const int npatch = nw * ((Thx + kRows - 1) / kRows) * ((Thy + 31) / 32);
  cudaError_t err = cudaFuncSetAttribute(
      pg_spread_kernel<kGS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(NS, (npatch + kWarps - 1) / kWarps);
  pg_spread_kernel<kGS><<<grid, 32 * kWarps, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      pos, vis, gmap, start, count, out, C, NS, nw, Thx, Thy, k,
      static_cast<float>(beta), static_cast<float>(woff));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pfbt

// K4. pos (NE, 8, C), vis (NE, 2, C), start/count (NS,) int32 -> out (2,
// nw, NS, Thx, Thy); slots with no entries are left unwritten. Returns a
// CUDA error code (0 on success).
extern "C" int pfbt_pg_spread(const float* pos, const float* vis,
                              const int* start, const int* count,
                              float* out, int C, int NS, int nw, int Thx,
                              int Thy, int k, double beta, void* stream) {
  return pfbt::launch_spread<false>(pos, vis, nullptr, start, count, out, C,
                                    NS, nw, Thx, Thy, k, beta, 0, stream);
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
  return pfbt::launch_spread<true>(pos, vis, gmap, start, count, out, C, NT,
                                   B, Thx, Thy, k, beta, woff, stream);
}
