// The spread lab (scripts/torch_kernel_lab.py --spread): K4 / K7's
// earlier design, kept as the lab's and the card tests' reference, and
// the skeletons of both designs.
//
// The earlier design (PRs 2-11) ran a block of 8 warps per 8 patches of a
// slot (one plane x 16 rows x 32 columns each, in plane-major order) and,
// for every entry of the slot, two barriers around the evaluation of all
// 3 C (k + 1) tap factors of the entry by the block's threads; then every
// warp walked all C visibilities with one warp-uniform test each and
// accumulated those whose support met its patch. Every block of a slot
// evaluated the same factors. Its grids are bit for bit those of
// pg_grid.cu's kernel, which sums the same products in the same order.
//
// Skeletons (kMode, both designs): 1 counts the hits instead of
// accumulating them, 2 drops the warps' scan, 3 the factor evaluation, 4
// everything but the per-entry (per-round) barriers. The differences of
// consecutive modes split a design's time into the accumulation, the
// scan, the factors, the loads and the barriers.
#include "pg_es.cuh"
#include "pg_spread.cuh"

namespace pfbt {

constexpr int kScanRows = 16;  // rows of a warp's patch
constexpr int kScanWarps = 8;  // patches (warps) of a block

template <bool kGS, int kMode>
__global__ void pg_spread_scan_kernel(const float* __restrict__ pos,
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
  if (ne == 0) return;
  const int KT = k + 1;
  const bool do_w = kGS || nw > 1;
  const int KW = do_w ? KT : 1;
  const int RB = (Thx + kScanRows - 1) / kScanRows, CB = (Thy + 31) / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int patch = blockIdx.y * kScanWarps + warp;
  const bool active = patch < nw * RB * CB;
  const int p = patch / (RB * CB);
  const int rb = (patch / CB) % RB;
  const int xlo = rb * kScanRows, ylo = (patch % CB) * 32;
  const int y = ylo + lane;
  int4* tap = smi;
  float* fu = reinterpret_cast<float*>(tap + C);
  float* fv = fu + C * KT;
  float* fw = fv + C * KT;
  float* vr = fw + C * KT;
  float* vi = vr + C;

  const float kh = 0.5f * static_cast<float>(k);
  const float betak = beta * static_cast<float>(k);
  const float rkh = 1.0f / kh;
  float ar[kScanRows], ai[kScanRows];
#pragma unroll
  for (int r = 0; r < kScanRows; ++r) ar[r] = ai[r] = 0.0f;

  for (int m = e0; m < e0 + ne; ++m) {
    __syncthreads();
    if (kMode == 4) {
      __syncthreads();
      continue;
    }
    const int e = kGS ? gmap[m] : m;
    const float* pe = pos + static_cast<size_t>(e) * 8 * C;
    const float* ve = vis + static_cast<size_t>(e) * 2 * C;
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      tap[c] = make_int4(first_tap(pe[c], kh), first_tap(pe[C + c], kh),
                         do_w ? first_tap(pe[2 * C + c] - woff, kh) : 0, 0);
      vr[c] = ve[c];
      vi[c] = ve[C + c];
    }
    if (kMode <= 2) {
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
    }
    __syncthreads();
    if (!active || kMode >= 2) continue;
    for (int c = 0; c < C; ++c) {
      const int4 t = tap[c];
      if (p < t.z || p >= t.z + KW || t.x + KT <= xlo ||
          t.x >= xlo + kScanRows || t.y + KT <= ylo || t.y >= ylo + 32)
        continue;
      const int dy = y - t.y;
      if (dy < 0 || dy >= KT) continue;
      if (kMode == 1) {
        ar[0] += 1.0f;
        continue;
      }
      const float f = fv[c * KT + dy] * fw[c * KT + p - t.z];
      const float wr = f * vr[c], wi = f * vi[c];
      const float* cu = fu + c * KT;
#pragma unroll
      for (int r = 0; r < kScanRows; ++r) {
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
  for (int r = 0; r < kScanRows; ++r) {
    const int x = xlo + r;
    if (x < Thx) {
      o_r[static_cast<size_t>(x) * Thy] = ar[r];
      o_i[static_cast<size_t>(x) * Thy] = ai[r];
    }
  }
}

template <bool kGS, int kMode>
static cudaError_t scan_mode(const float* pos, const float* vis,
                             const int* gmap, const int* start,
                             const int* count, float* out, int C, int NS,
                             int nw, int Thx, int Thy, int k, float beta,
                             float woff, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(C) *
      (sizeof(int4) + (3 * (k + 1) + 2) * sizeof(float));
  const int npatch =
      nw * ((Thx + kScanRows - 1) / kScanRows) * ((Thy + 31) / 32);
  cudaError_t err = cudaFuncSetAttribute(
      pg_spread_scan_kernel<kGS, kMode>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(NS, (npatch + kScanWarps - 1) / kScanWarps);
  pg_spread_scan_kernel<kGS, kMode><<<grid, 32 * kScanWarps, smem, st>>>(
      pos, vis, gmap, start, count, out, C, NS, nw, Thx, Thy, k, beta, woff);
  return cudaGetLastError();
}

template <bool kGS>
static cudaError_t scan_spread(const float* pos, const float* vis,
                               const int* gmap, const int* start,
                               const int* count, float* out, int C, int NS,
                               int nw, int Thx, int Thy, int k, float beta,
                               float woff, int mode, cudaStream_t st) {
#define PFBT_SCAN(M)                                                     \
  scan_mode<kGS, M>(pos, vis, gmap, start, count, out, C, NS, nw, Thx, \
                    Thy, k, beta, woff, st)
  switch (mode) {
    case 0: return PFBT_SCAN(0);
    case 1: return PFBT_SCAN(1);
    case 2: return PFBT_SCAN(2);
    case 3: return PFBT_SCAN(3);
    default: return PFBT_SCAN(4);
  }
#undef PFBT_SCAN
}

}  // namespace pfbt

// The spread lab: design 0 the earlier design above, 1 pg_grid.cu's
// kernel; mode 0 the kernel, 1-4 its skeletons. K7 where gmap is given
// (woff the block's first plane), else K4; operands and output as
// pfbt_pg_spread's / pfbt_pg_spread_gs's.
extern "C" int pfbt_pg_spread_lab(const float* pos, const float* vis,
                                  const int* gmap, const int* start,
                                  const int* count, float* out, int C,
                                  int NS, int nw, int Thx, int Thy, int k,
                                  int woff, double beta, int design,
                                  int mode, void* stream) {
  using namespace pfbt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (design == 1)
    return static_cast<int>(pg_spread_launch(pos, vis, gmap, start, count,
                                             out, C, NS, nw, Thx, Thy, k,
                                             beta, woff, mode, st));
  if (design != 0 || mode < 0 || mode > 4 || k < 1 || k + 1 > kMaxTaps ||
      NS < 1 || nw < 1 || C < 1 || Thx < 1 || Thy < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float b = static_cast<float>(beta), wo = static_cast<float>(woff);
  return static_cast<int>(
      gmap ? scan_spread<true>(pos, vis, gmap, start, count, out, C, NS, nw,
                               Thx, Thy, k, b, wo, mode, st)
           : scan_spread<false>(pos, vis, gmap, start, count, out, C, NS,
                                nw, Thx, Thy, k, b, wo, mode, st));
}
