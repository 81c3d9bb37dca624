// K6: the pg gridder's degrid. Each visibility gathers its k^3 support
// from the w-plane grids, both components.
//
// Replaces pfb_tpu/ops/pgridder.py:_degrid_pallas (Pallas kernel
// _degrid_kernel): per entry of C visibilities,
//   V_c = sum_p CW[p, c] sum_x CU[x, c] sum_y G[p, x, y] CV[y, c]
// over the tile's halo'd window, for the real and imaginary grids.
// Output (NE, 2, C) float32.
//
// What bounds it on the H100, and what the design does about it:
// - The TPU kernel DMAs an (8, 128)-aligned window of a wrap-padded copy
//   of the grid stack and contracts it densely on its matrix unit. Here
//   one thread owns one visibility and reads only its support: the
//   k + 1 taps per axis of pg_es.cuh, inside the tile's (Thx, Thy)
//   window, with grid indices taken modulo (Nx, Ny) from the true window
//   start, so neither the padded copy nor the alignment is needed.
// - The reads are gathers: the C visibilities of a block lie in one uv
//   tile, so their footprints share the tile's window and hit L1/L2, but
//   a warp's load touches up to 32 separate sectors. Latency of those
//   gathers bounds the kernel, not arithmetic (k^3 FMAs per component).
// - The y taps of a row are contiguous in memory; their factors and
//   column indices are made once per visibility and kept in registers
//   (loops over kMaxTaps taps, unrolled, with a guard on k).
// FP32 FMA throughout, expf/sqrtf for the factors; no fast math.
// Deterministic: each output is summed by one thread in a fixed order.
//
// K9, the same kernel over one w block of the w-plane-blocked engine
// (pfb_tpu_torch/ops/pg_stream.py), replaces
// pfb_tpu/ops/pg_stream.py:_degrid_pallas_gs (Pallas kernel
// _degrid_kernel_gs): one CUDA block per position of the block's entry
// map gmap, whose global entry e it degrids from the block's B planes
// (w relative to the block's first plane woff, w factors always) and
// ADDS to acc[e]. No wrap-padded grid copies, no (8, 128)-aligned window
// starts (pos rows 3-6): indices are taken modulo (Nx, Ny) from the
// tile's true window start. A block's map holds each entry once, so the
// add needs no atomics, and blocks are launched one after another, so
// the sum over the 2-3 blocks an entry reaches has a fixed order.
#include "pg_es.cuh"

namespace pfbt {

// kGS: K9 (entry gmap[blockIdx.x], w relative to woff, w factors
// always, the result added to out); otherwise K6 (entry blockIdx.x, w
// factors when nw > 1, the result written).
template <bool kGS>
__global__ void pg_degrid_kernel(const float* __restrict__ gr,
                                 const float* __restrict__ gi,
                                 const float* __restrict__ pos,
                                 const int* __restrict__ tid,
                                 const int* __restrict__ gmap,
                                 float* __restrict__ out, int C, int nw,
                                 int Thx, int Thy, int txs, int tys, int nty,
                                 int Nx, int Ny, int k, float beta,
                                 float woff) {
  const int e = kGS ? gmap[blockIdx.x] : blockIdx.x;
  const bool do_w = kGS || nw > 1;
  const int t = tid[e];
  const int h = k / 2;
  const int sx = posmod((t / nty) * txs - h, Nx);
  const int sy = posmod((t % nty) * tys - h, Ny);
  const float kh = 0.5f * static_cast<float>(k);
  const float betak = beta * static_cast<float>(k);
  const float rkh = 1.0f / kh;
  const float* pe = pos + static_cast<size_t>(e) * 8 * C;
  const size_t plane = static_cast<size_t>(Nx) * Ny;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float u = pe[c], v = pe[C + c], wf = pe[2 * C + c] - woff;
    const int x0 = first_tap(u, kh), y0 = first_tap(v, kh);
    const int p0 = do_w ? first_tap(wf, kh) : 0;
    const int KW = do_w ? k + 1 : 1;
    float cv[kMaxTaps];
    int ycol[kMaxTaps];
#pragma unroll
    for (int j = 0; j < kMaxTaps; ++j) {
      const int y = y0 + j;
      const bool in = j <= k && y >= 0 && y < Thy;
      cv[j] = in ? es_tap(static_cast<float>(y), v, rkh, betak) : 0.0f;
      ycol[j] = in ? (sy + y) % Ny : 0;
    }
    float ar = 0.0f, ai = 0.0f;
    for (int dp = 0; dp < KW; ++dp) {
      const int p = p0 + dp;
      if (p < 0 || p >= nw) continue;
      const float cw = do_w
          ? es_tap(static_cast<float>(p), wf, rkh, betak) : 1.0f;
#pragma unroll
      for (int dx = 0; dx < kMaxTaps; ++dx) {
        const int x = x0 + dx;
        if (dx > k || x < 0 || x >= Thx) continue;
        const float cu = es_tap(static_cast<float>(x), u, rkh, betak);
        const size_t row =
            p * plane + static_cast<size_t>((sx + x) % Nx) * Ny;
        const float* rr = gr + row;
        const float* ri = gi + row;
        float sr = 0.0f, si = 0.0f;
#pragma unroll
        for (int j = 0; j < kMaxTaps; ++j) {
          if (j <= k) {
            sr = fmaf(rr[ycol[j]], cv[j], sr);
            si = fmaf(ri[ycol[j]], cv[j], si);
          }
        }
        const float f = cw * cu;
        ar = fmaf(f, sr, ar);
        ai = fmaf(f, si, ai);
      }
    }
    float* o = out + static_cast<size_t>(e) * 2 * C + c;
    if (kGS) {
      o[0] += ar;
      o[C] += ai;
    } else {
      o[0] = ar;
      o[C] = ai;
    }
  }
}

template <bool kGS>
int launch_degrid(const float* gr, const float* gi, const float* pos,
                  const int* tid, const int* gmap, float* out, int NE, int C,
                  int nw, int Thx, int Thy, int txs, int tys, int nty, int Nx,
                  int Ny, int k, double beta, int woff, void* stream) {
  if (k < 1 || k + 1 > kMaxTaps || NE < 1 || C < 1 || nw < 1 || Thx > Nx ||
      Thy > Ny)
    return static_cast<int>(cudaErrorInvalidValue);
  const int T = C < 128 ? C : 128;
  pg_degrid_kernel<kGS><<<NE, T, 0, static_cast<cudaStream_t>(stream)>>>(
      gr, gi, pos, tid, gmap, out, C, nw, Thx, Thy, txs, tys, nty, Nx, Ny, k,
      static_cast<float>(beta), static_cast<float>(woff));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pfbt

// K6. gr, gi (nw, Nx, Ny), pos (NE, 8, C), tid (NE,) int32 -> out (NE, 2,
// C). Returns a CUDA error code (0 on success).
extern "C" int pfbt_pg_degrid(const float* gr, const float* gi,
                              const float* pos, const int* tid, float* out,
                              int NE, int C, int nw, int Thx, int Thy,
                              int txs, int tys, int nty, int Nx, int Ny,
                              int k, double beta, void* stream) {
  return pfbt::launch_degrid<false>(gr, gi, pos, tid, nullptr, out, NE, C,
                                    nw, Thx, Thy, txs, tys, nty, Nx, Ny, k,
                                    beta, 0, stream);
}

// K9. The block's grids gr, gi (B, Nx, Ny), the global stream's pos
// (NEg + 1, 8, C) and entry tiles utid (NEg,) int32, the live prefix of
// the block's entry map gmap (NE,) int32 and its first plane woff; adds
// each mapped entry's visibilities to acc (NEg + 1, 2, C).
extern "C" int pfbt_pg_degrid_gs(const float* gr, const float* gi,
                                 const float* pos, const int* utid,
                                 const int* gmap, float* acc, int NE, int C,
                                 int B, int Thx, int Thy, int txs, int tys,
                                 int nty, int Nx, int Ny, int k, int woff,
                                 double beta, void* stream) {
  return pfbt::launch_degrid<true>(gr, gi, pos, utid, gmap, acc, NE, C, B,
                                   Thx, Thy, txs, tys, nty, Nx, Ny, k, beta,
                                   woff, stream);
}
