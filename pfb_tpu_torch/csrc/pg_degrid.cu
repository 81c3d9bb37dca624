// K6: the pg gridder's degrid. Each visibility gathers its k^3 support
// from the w-plane grids, both components.
//
// Replaces pfb_tpu/ops/pgridder.py:_degrid_pallas (Pallas kernel
// _degrid_kernel): per entry of C visibilities,
//   V_c = sum_p CW[p, c] sum_x CU[x, c] sum_y G[p, x, y] CV[y, c]
// over the tile's halo'd window, for the real and imaginary grids.
// Output (NE, 2, C) float32.
//
// What bounds it on the H100, and what the designs do about it:
// - The TPU kernel DMAs an (8, 128)-aligned window of a wrap-padded copy
//   of the grid stack and contracts it densely on its matrix unit. Here
//   only a visibility's support is read: the k + 1 taps per axis of
//   pg_es.cuh, inside the tile's (Thx, Thy) window, with grid indices
//   taken modulo (Nx, Ny) from the true window start, so neither the
//   padded copy nor the alignment is needed.
// - The earlier design (one thread a visibility, its taps gathered from
//   global memory: pg_degrid_thread_kernel) spent three quarters of its
//   time on the gathers: each visibility's (k + 1)^2 taps of a plane
//   come from L2 as about 30 sectors, and an entry's visibilities cover
//   its tile's window several times over (PERF.md has the split).
// - The window design (K6 / K9 where three of its blocks fit an SM): a
//   block takes one entry and stages its tile's window into shared
//   memory one plane at a time, the planes any of its visibilities
//   needs in order, in 16-byte cp.async copies (4-byte ones where Ny %
//   4 != 0), so an entry reads each window point once from L2. Each
//   thread then sums one visibility from shared memory exactly as the
//   earlier design sums it from global memory (its 3 (k + 1) factors
//   once, the planes in order, each row's y taps in order, the rows in
//   order), so the outputs are the earlier design's bits. The threads of
//   a warp take visibilities whose rows start on distinct banks (a
//   counting sort of the entry on that key), so a warp's shared loads
//   are conflict-free as far as the entry allows.
// - Where fewer fit (the tile ladder's longer tiles: (64, 256) windows
//   at k = 7, 138 KiB, one block; (40, 256) at k = 9, 92.5 KiB, two),
//   little hides a block's staging, and the window lost to the earlier
//   design on a plan of such tiles (PERF.md has the times). There k = 7
//   takes the taps design: a group of 8 lanes a visibility, lane j the
//   j-th tap of each axis (its three factors, and G[p, x, y0 + j] of
//   every row x from global memory, one run of 8 floats a group), the
//   taps handed to their rows' lanes through a padded shared tile, the
//   rows' sums, taken by shuffles, folded in order: the same sums again.
//   Other k take the earlier design: the taps in groups of 16 lanes
//   (k = 9) took twice its time.
// - At k = 7 the tap count is a compile-time 8 (kFixedTaps), so every
//   tap loop is unrolled without guards; other k up to 16 take a guard
//   on k (kMaxTaps factors).
// FP32 FMA throughout, expf/sqrtf for the factors; no fast math.
// Deterministic: each output is summed in a fixed order without atomics.
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
#include <cstdint>

#include "pg_degrid.cuh"
#include "pg_es.cuh"

namespace pfbt {

constexpr int kFixedTaps = 8;       // the taps of the paths' k = 7
constexpr int kTapsThreads = 256;

// A group's tile: 8 rows of 8 (re, im) pairs and a pad, so that rows
// read by 16-byte loads and a half-warp's 8-byte stores meet distinct
// banks; plus an offset that puts two groups of a half-warp on
// different banks. In floats.
constexpr int kTileStride = 2 * kFixedTaps + 4;
constexpr int kTapRegion = kFixedTaps * kTileStride + 16;

// The earlier design: a thread a visibility, a block of
// min(C, 128) threads an entry. It evaluates its 3 (k + 1) tap factors
// alone (loops unrolled to kMaxTaps with a guard on k) and gathers its
// (k + 1)^2 taps of each plane and component one scalar load at a time.
// kGS: K9 (entry gmap[blockIdx.x], w relative to woff, w factors
// always, the result added to out); otherwise K6 (entry blockIdx.x, w
// factors when nw > 1, the result written). kMode 0 the kernel, 1-3 the
// lab's skeletons (lab_degrid.cu): the factors alone, the loads alone,
// the sums on register data.
template <bool kGS, int kMode>
__global__ void pg_degrid_thread_kernel(const float* __restrict__ gr,
                                        const float* __restrict__ gi,
                                        const float* __restrict__ pos,
                                        const int* __restrict__ tid,
                                        const int* __restrict__ gmap,
                                        float* __restrict__ out, int C,
                                        int nw, int Thx, int Thy, int txs,
                                        int tys, int nty, int Nx, int Ny,
                                        int k, float beta, float woff) {
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
      cv[j] = !in ? 0.0f
              : kMode == 2 ? 1.0f
              : kMode == 3 ? v
                           : es_tap(static_cast<float>(y), v, rkh, betak);
      ycol[j] = in ? (sy + y) % Ny : 0;
    }
    float ar = 0.0f, ai = 0.0f;
    for (int dp = 0; dp < KW; ++dp) {
      const int p = p0 + dp;
      if (p < 0 || p >= nw) continue;
      const float cw = kMode == 2 || !do_w ? 1.0f
                       : kMode == 3        ? wf
                           : es_tap(static_cast<float>(p), wf, rkh, betak);
#pragma unroll
      for (int dx = 0; dx < kMaxTaps; ++dx) {
        const int x = x0 + dx;
        if (dx > k || x < 0 || x >= Thx) continue;
        const float cu = kMode == 2 ? 1.0f
                         : kMode == 3
                             ? u
                             : es_tap(static_cast<float>(x), u, rkh, betak);
        if (kMode == 1) {
          ar += cw * cu;
          continue;
        }
        const size_t row =
            p * plane + static_cast<size_t>((sx + x) % Nx) * Ny;
        const float* rr = gr + row;
        const float* ri = gi + row;
        float sr = 0.0f, si = 0.0f;
#pragma unroll
        for (int j = 0; j < kMaxTaps; ++j) {
          if (j <= k) {
            if (kMode == 2) {
              sr += rr[ycol[j]];
              si += ri[ycol[j]];
            } else if (kMode == 3) {
              sr = fmaf(static_cast<float>(ycol[j] + dx), cv[j], sr);
              si = fmaf(static_cast<float>(ycol[j] - dx), cv[j], si);
            } else {
              sr = fmaf(rr[ycol[j]], cv[j], sr);
              si = fmaf(ri[ycol[j]], cv[j], si);
            }
          }
        }
        const float f = cw * cu;
        ar = fmaf(f, sr, ar);
        ai = fmaf(f, si, ai);
      }
    }
    if (kMode == 1) {
#pragma unroll
      for (int j = 0; j < kMaxTaps; ++j) ai += cv[j];
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

template <bool kGS, int kMode>
static cudaError_t thread_launch(const DegridArgs& a, cudaStream_t st) {
  const int T = a.C < 128 ? a.C : 128;
  pg_degrid_thread_kernel<kGS, kMode><<<a.NE, T, 0, st>>>(
      a.gr, a.gi, a.pos, a.tid, a.gmap, a.out, a.C, a.nw, a.Thx, a.Thy,
      a.txs, a.tys, a.nty, a.Nx, a.Ny, a.k, a.beta, a.woff);
  return cudaGetLastError();
}

// The taps design at k = 7: 8 lanes a visibility. kGS and kMode as the
// thread design's; skeleton 3 keeps the exchange between lanes.
template <bool kGS, int kMode>
__global__ void __launch_bounds__(kTapsThreads)
    pg_degrid_taps_kernel(const DegridArgs a) {
  constexpr int KT = kFixedTaps, k = KT - 1, TS = kTileStride;
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4) +
                (threadIdx.x / KT) * kTapRegion;
  const int j = threadIdx.x % KT;  // the lane's tap; its row in the sums
  const unsigned gmask = ((1u << KT) - 1) << (threadIdx.x % 32 / KT * KT);
  const int NG = blockDim.x / KT;

  const int e = kGS ? a.gmap[blockIdx.x] : blockIdx.x;
  const int C = a.C;
  const bool do_w = kGS || a.nw > 1;
  const int t = a.tid[e];
  const int h = k / 2;
  const int sx = posmod((t / a.nty) * a.txs - h, a.Nx);
  const int sy = posmod((t % a.nty) * a.tys - h, a.Ny);
  const float kh = 0.5f * static_cast<float>(k);
  const float betak = a.beta * static_cast<float>(k);
  const float rkh = 1.0f / kh;
  const float* pe = a.pos + static_cast<size_t>(e) * 8 * C;
  const size_t plane = static_cast<size_t>(a.Nx) * a.Ny;

  for (int c = threadIdx.x / KT; c < C; c += NG) {
    const float u = pe[c], v = pe[C + c], wf = pe[2 * C + c] - a.woff;
    const int x0 = first_tap(u, kh), y0 = first_tap(v, kh);
    const int p0 = do_w ? first_tap(wf, kh) : 0;
    // lane j's taps: y0 + j, x0 + j, p0 + j
    const int y = y0 + j, x = x0 + j;
    const bool yin = y >= 0 && y < a.Thy;
    const bool xin = x >= 0 && x < a.Thx;
    const int col = yin ? (sy + y) % a.Ny : 0;
    float cvj, cuj, cwj;
    if (kMode == 2) {
      cvj = cuj = cwj = 1.0f;
    } else if (kMode == 3) {
      cvj = yin ? v : 0.0f;
      cuj = u;
      cwj = wf;
    } else {
      cvj = yin ? es_tap(static_cast<float>(y), v, rkh, betak) : 0.0f;
      cuj = xin ? es_tap(static_cast<float>(x), u, rkh, betak) : 0.0f;
      cwj = do_w ? es_tap(static_cast<float>(p0 + j), wf, rkh, betak)
                 : 1.0f;
    }
    float* o = a.out + static_cast<size_t>(e) * 2 * C + c;
    if (kMode == 1) {
      if (j < 2) o[j * C] = cvj + cuj + cwj;
    } else {
      // every row's offset in a plane (-1 outside the window), and the y
      // factors and x factors of all taps
      float cv[KT], cu[KT];
      long long ro[KT];
#pragma unroll
      for (int i = 0; i < KT; ++i) {
        cv[i] = __shfl_sync(gmask, cvj, i, KT);
        cu[i] = __shfl_sync(gmask, cuj, i, KT);
        const int xi = x0 + i;
        const int gx = sx + xi < a.Nx ? sx + xi : sx + xi - a.Nx;
        const bool in = xi >= 0 && xi < a.Thx;
        ro[i] = in ? static_cast<long long>(gx) * a.Ny : -1;
      }
      // the planes of the taps inside the grids, in order: a warp runs as
      // many as its group with the most
      const int plo = p0 > 0 ? p0 : 0;
      const int phi = do_w ? (p0 + k + 1 < a.nw ? p0 + k + 1 : a.nw) : 1;
      float ar = 0.0f, ai = 0.0f;
      for (int p = plo; p < phi; ++p) {
        const float cw = __shfl_sync(gmask, cwj, p - p0, KT);
        const float* Pr = a.gr + p * plane + col;
        const float* Pi = a.gi + p * plane + col;
        float lr[KT], li[KT];
#pragma unroll
        for (int i = 0; i < KT; ++i) {
          if (kMode == 3) {
            lr[i] = static_cast<float>(ro[i] + col);
            li[i] = static_cast<float>(ro[i] - col);
          } else {
            lr[i] = ro[i] >= 0 ? Pr[ro[i]] : 0.0f;
            li[i] = ro[i] >= 0 ? Pi[ro[i]] : 0.0f;
          }
        }
        if (kMode == 2) {
#pragma unroll
          for (int i = 0; i < KT; ++i) {
            ar += lr[i];
            ai += li[i];
          }
        } else {
          // the taps to their rows' lanes: tap j of row i at row i, pair j
          __syncwarp(gmask);
#pragma unroll
          for (int i = 0; i < KT; ++i)
            reinterpret_cast<float2*>(tile + i * TS)[j] =
                make_float2(lr[i], li[i]);
          __syncwarp(gmask);
          // lane j sums row j's y taps in order
          float sr = 0.0f, si = 0.0f;
#pragma unroll
          for (int q = 0; q < KT; q += 2) {
            const float4 g = *reinterpret_cast<const float4*>(tile + j * TS +
                                                              2 * q);
            sr = fmaf(g.x, cv[q], sr);
            si = fmaf(g.y, cv[q], si);
            sr = fmaf(g.z, cv[q + 1], sr);
            si = fmaf(g.w, cv[q + 1], si);
          }
          // the rows folded in order
#pragma unroll
          for (int i = 0; i < KT; ++i) {
            const float s_r = __shfl_sync(gmask, sr, i, KT);
            const float s_i = __shfl_sync(gmask, si, i, KT);
            if (ro[i] >= 0) {
              const float f = cw * cu[i];
              ar = fmaf(f, s_r, ar);
              ai = fmaf(f, s_i, ai);
            }
          }
        }
      }
      if (j < 2) {
        const float r = j == 0 ? ar : ai;
        if (kGS)
          o[j * C] += r;
        else
          o[j * C] = r;
      }
    }
  }
}

template <bool kGS, int kMode>
static cudaError_t taps_launch(const DegridArgs& a, cudaStream_t st) {
  constexpr int KT = kFixedTaps;
  const int T = KT * a.C < kTapsThreads ? KT * a.C : kTapsThreads;
  const size_t smem = sizeof(float) * (T / KT) * kTapRegion;
  pg_degrid_taps_kernel<kGS, kMode><<<a.NE, T, smem, st>>>(a);
  return cudaGetLastError();
}

// The window design: a block stages its entry's tile window one plane at
// a time in shared memory, the real and imaginary rows apart, and each
// thread degrids one visibility from it.
constexpr int kWinThreads = 256;
// K6 / K9 take the window where this many of its blocks fit an SM's
// shared memory: with fewer, the blocks' staging is not hidden, and at
// two the window lost to the earlier design on a sparse plan (PERF.md).
constexpr int kWinMinBlocks = 3;

// A staged row: window column y at float kWinPad<KT> + sy % 4 + y, so
// that 16-byte copies of the grid land 16-byte aligned; the floats
// either side are taps outside the window (factor 0) and only need to
// be finite.
template <int KT>
constexpr int kWinPad = (KT + 3) / 4 * 4;

template <int KT>
__host__ __device__ inline int window_row(int Thy) {
  return (kWinPad<KT> + Thy + KT + 6) / 4 * 4;
}

template <int KT>
static size_t window_smem(const DegridArgs& a) {
  return sizeof(float) * 2 * a.Thx * window_row<KT>(a.Thy);
}

// Asynchronous copies global -> shared (cp.async) of 4 or 16 bytes,
// their commit and the wait for all of a thread's copies.
template <int kBytes>
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d),
                 "l"(src));
#else
  for (int i = 0; i < kBytes / 4; ++i) dst[i] = src[i];
#endif
}

__device__ __forceinline__ void copies_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;");
#endif
}

__device__ __forceinline__ void copies_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;" ::: "memory");
#endif
}

// Stage plane p of the tile window starting at (sx, sy) into w (the
// Thx real rows, then the Thx imaginary rows, RS floats each); a warp a
// row. With vec (Ny % 4 == 0, 16-byte aligned grids) the copies are the
// 16-byte chunks that hold the window's columns, in one segment or two
// where the window wraps at Ny; else one float at a time.
template <int KT>
__device__ __forceinline__ void stage_plane(float* w, const DegridArgs& a,
                                            int p, int sx, int sy, int RS,
                                            bool vec) {
  const size_t base = static_cast<size_t>(p) * a.Nx * a.Ny;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarp = blockDim.x / 32;
  const int at = kWinPad<KT> + sy % 4;  // the float of window column 0
  for (int r = warp; r < a.Thx; r += nwarp) {
    const int gx = sx + r < a.Nx ? sx + r : sx + r - a.Nx;
    const size_t row = base + static_cast<size_t>(gx) * a.Ny;
    float* wr = w + r * RS;
    float* wi = w + (a.Thx + r) * RS;
    if (vec) {
      // global columns [sy, e1) then [0, e2)
      const int e1 = sy + a.Thy < a.Ny ? sy + a.Thy : a.Ny;
      const int e2 = sy + a.Thy - e1;
      const int c0 = sy / 4 * 4;
      const int n1 = (e1 - c0 + 3) / 4, n2 = (e2 + 3) / 4;
      for (int q = lane; q < n1 + n2; q += 32) {
        const int g = q < n1 ? c0 + 4 * q : 4 * (q - n1);
        const int d = q < n1 ? at + g - sy : at + a.Ny - sy + g;
        copy_async<16>(wr + d, a.gr + row + g);
        copy_async<16>(wi + d, a.gi + row + g);
      }
    } else {
      for (int y = lane; y < a.Thy; y += 32) {
        const int gy = sy + y < a.Ny ? sy + y : sy + y - a.Ny;
        copy_async<4>(wr + at + y, a.gr + row + gy);
        copy_async<4>(wi + at + y, a.gi + row + gy);
      }
    }
  }
  copies_commit();
}

template <bool kGS, int KT, bool kFixed, int kMode>
__global__ void __launch_bounds__(kWinThreads)
    pg_degrid_window_kernel(const DegridArgs a, bool vec) {
  extern __shared__ float4 smem4[];
  float* win = reinterpret_cast<float*>(smem4);  // one plane
  __shared__ int range[2];  // the planes any visibility of the pass needs
  __shared__ int bucket[33];
  __shared__ int order[kWinThreads];
  const int RS = window_row<KT>(a.Thy);
  const int e = kGS ? a.gmap[blockIdx.x] : blockIdx.x;
  const int C = a.C;
  const int k = kFixed ? KT - 1 : a.k;
  const bool do_w = kGS || a.nw > 1;
  const int t = a.tid[e];
  const int h = k / 2;
  const int sx = posmod((t / a.nty) * a.txs - h, a.Nx);
  const int sy = posmod((t % a.nty) * a.tys - h, a.Ny);
  const float kh = 0.5f * static_cast<float>(k);
  const float betak = a.beta * static_cast<float>(k);
  const float rkh = 1.0f / kh;
  const float* pe = a.pos + static_cast<size_t>(e) * 8 * C;
  const int at = kWinPad<KT> + sy % 4;  // the float of window column 0

  // the floats of every row that no copy writes
  const int lo_end = at, hi_beg = at + a.Thy;
  const int nfill = lo_end + RS - hi_beg;
  for (int i = threadIdx.x; i < 2 * a.Thx * nfill; i += blockDim.x) {
    const int r = i / nfill, q = i % nfill;
    win[r * RS + (q < lo_end ? q : hi_beg + q - lo_end)] = 0.0f;
  }
  // the first float of a row's taps from y0, clamped so that they stay
  // inside the row (taps outside the window have factor 0, add nothing)
  auto first_col = [&](int y0) {
    const int f = at + y0;
    return f < 0 ? 0 : f > RS - KT ? RS - KT : f;
  };
  for (int c0 = 0; c0 < C; c0 += blockDim.x) {
    if (threadIdx.x == 0) {
      range[0] = a.nw;
      range[1] = 0;
    }
    for (int b = threadIdx.x; b < 33; b += blockDim.x) bucket[b] = 0;
    __syncthreads();
    // The visibilities to threads: the 32 of a warp read their first
    // rows on distinct banks ((x0 RS + first column) mod 32, so every
    // tap of every row too) as far as the entry allows, by a counting
    // sort on that key dealt out across the warps. A thread sums one
    // visibility, so any assignment gives the same outputs.
    {
      const int cs = c0 + threadIdx.x;
      int key = 32;
      if (cs < C) {
        const int bx = first_tap(pe[cs], kh) * RS +
                       first_col(first_tap(pe[C + cs], kh));
        key = bx & 31;
      }
      const int rank = atomicAdd(&bucket[key], 1);
      __syncthreads();
      if (threadIdx.x == 0) {
        int sum = 0;
        for (int b = 0; b < 33; ++b) {
          const int n = bucket[b];
          bucket[b] = sum;
          sum += n;
        }
      }
      __syncthreads();
      const int pos = bucket[key] + rank, W = blockDim.x / 32;
      order[pos % W * 32 + pos / W] = cs;
      __syncthreads();
    }
    const int c = order[threadIdx.x];
    const bool live = c < C;
    // the visibility's taps and factors, as the earlier design makes them
    const float u = live ? pe[c] : 0.0f, v = live ? pe[C + c] : 0.0f;
    const float wf = live ? pe[2 * C + c] - a.woff : 0.0f;
    const int x0 = first_tap(u, kh), y0 = first_tap(v, kh);
    const int p0 = do_w ? first_tap(wf, kh) : 0;
    const int plo = p0 > 0 ? p0 : 0;
    const int phi = !live ? 0
                    : do_w ? (p0 + k + 1 < a.nw ? p0 + k + 1 : a.nw)
                           : 1;
    float cv[KT], cu[KT], cw[KT];
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const bool tj = kFixed || j <= k;
      const int y = y0 + j, x = x0 + j;
      if (kMode == 2) {
        cv[j] = cu[j] = cw[j] = 1.0f;
      } else if (kMode == 3) {
        cv[j] = tj && y >= 0 && y < a.Thy ? v : 0.0f;
        cu[j] = u;
        cw[j] = wf;
      } else {
        cv[j] = tj && y >= 0 && y < a.Thy
                    ? es_tap(static_cast<float>(y), v, rkh, betak)
                    : 0.0f;
        cu[j] = tj && x >= 0 && x < a.Thx
                    ? es_tap(static_cast<float>(x), u, rkh, betak)
                    : 0.0f;
        cw[j] = do_w && tj
                    ? es_tap(static_cast<float>(p0 + j), wf, rkh, betak)
                    : 1.0f;
      }
    }
    if (plo < phi) {
      atomicMin(&range[0], plo);
      atomicMax(&range[1], phi);
    }
    const int ys = first_col(y0);
    __syncthreads();
    const int lo = range[0], hi = range[1];
    constexpr bool kStaged = kMode != 1 && kMode != 3;
    if (kStaged && lo < hi) stage_plane<KT>(win, a, lo, sx, sy, RS, vec);
    float ar = 0.0f, ai = 0.0f;
    for (int p = lo; p < hi; ++p) {
      if (kStaged) {  // plane p has landed
        copies_wait();
        __syncthreads();
      }
      if (p >= plo && p < phi) {
        // the w factor of plane p, then the rows in order
        float cwp = cw[0];
#pragma unroll
        for (int j = 1; j < KT; ++j)
          if (p - p0 == j) cwp = cw[j];
        if (kMode == 1) {
          ar += cwp;
          ai += cu[0] + cv[0];
        } else {
#pragma unroll
          for (int dx = 0; dx < KT; ++dx) {
            const int x = x0 + dx;
            if ((kFixed || dx <= k) && x >= 0 && x < a.Thx) {
              const float* rr = win + x * RS + ys;
              const float* ri = rr + a.Thx * RS;
              float sr = 0.0f, si = 0.0f;
#pragma unroll
              for (int j = 0; j < KT; ++j) {
                if (kFixed || j <= k) {
                  if (kMode == 3) {
                    sr = fmaf(static_cast<float>(x + j), cv[j], sr);
                    si = fmaf(cv[dx], cv[j], si);
                  } else if (kMode == 2) {
                    sr += rr[j];
                    si += ri[j];
                  } else {
                    sr = fmaf(rr[j], cv[j], sr);
                    si = fmaf(ri[j], cv[j], si);
                  }
                }
              }
              const float f = cwp * cu[dx];
              ar = fmaf(f, sr, ar);
              ai = fmaf(f, si, ai);
            }
          }
        }
      }
      if (kStaged && p + 1 < hi) {
        __syncthreads();  // plane p is read
        stage_plane<KT>(win, a, p + 1, sx, sy, RS, vec);
      }
    }
    if (live) {
      float* o = a.out + static_cast<size_t>(e) * 2 * C + c;
      if (kGS) {
        o[0] += ar;
        o[C] += ai;
      } else {
        o[0] = ar;
        o[C] = ai;
      }
    }
    __syncthreads();  // range is reset for the next pass
  }
}

// The blocks of kern with smem bytes of dynamic shared memory that an
// SM of this card holds by shared memory (each block takes its static
// shared memory and the card's reservation too): 0 where a block passes
// the card's opt-in limit, or on an error.
template <typename Kern>
static int blocks_an_sm(Kern kern, size_t smem) {
  int dev = 0, optin = 0, per_sm = 0, reserved = 0;
  cudaFuncAttributes fa{};
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&per_sm,
                             cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                             dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&reserved,
                             cudaDevAttrReservedSharedMemoryPerBlock,
                             dev) != cudaSuccess ||
      cudaFuncGetAttributes(&fa, kern) != cudaSuccess)
    return 0;
  const size_t block = smem + fa.sharedSizeBytes;
  if (block > static_cast<size_t>(optin)) return 0;
  return static_cast<int>(per_sm / (block + reserved));
}

template <bool kGS, int KT, bool kFixed, int kMode>
static cudaError_t window_launch(const DegridArgs& a, cudaStream_t st) {
  // whole warps: the staging takes a row a warp
  const int T = a.C < kWinThreads ? (a.C + 31) / 32 * 32 : kWinThreads;
  const size_t smem = window_smem<KT>(a);
  auto kern = pg_degrid_window_kernel<kGS, KT, kFixed, kMode>;
  if (blocks_an_sm(kern, smem) < 1) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const bool vec =
      a.Ny % 4 == 0 && reinterpret_cast<uintptr_t>(a.gr) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(a.gi) % 16 == 0;
  kern<<<a.NE, T, smem, st>>>(a, vec);
  return cudaGetLastError();
}

// One design's launch in one mode (0 the kernel, 1-3 the skeletons; the
// taps and the window take them at k = 7 only, the taps no other k).
template <bool kGS, int kMode>
static cudaError_t design_launch(const DegridArgs& a, int design,
                                 cudaStream_t st) {
  const bool fixed = a.k + 1 == kFixedTaps;
  if (design == kDegridThread) return thread_launch<kGS, kMode>(a, st);
  if (design == kDegridTaps && fixed) return taps_launch<kGS, kMode>(a, st);
  if (design == kDegridWindow && fixed)
    return window_launch<kGS, kFixedTaps, true, kMode>(a, st);
  if (design == kDegridWindow && kMode == 0)
    return window_launch<kGS, kMaxTaps, false, 0>(a, st);
  return cudaErrorInvalidValue;
}

template <bool kGS>
static cudaError_t degrid_launch(const DegridArgs& a, int design, int mode,
                                 cudaStream_t st) {
  if (design == kDegridShipped) {
    const int blocks =
        a.k + 1 == kFixedTaps
            ? blocks_an_sm(pg_degrid_window_kernel<kGS, kFixedTaps, true, 0>,
                           window_smem<kFixedTaps>(a))
            : blocks_an_sm(pg_degrid_window_kernel<kGS, kMaxTaps, false, 0>,
                           window_smem<kMaxTaps>(a));
    design = blocks >= kWinMinBlocks  ? kDegridWindow
             : a.k + 1 == kFixedTaps ? kDegridTaps
                                     : kDegridThread;
  }
  switch (mode) {
    case 0: return design_launch<kGS, 0>(a, design, st);
    case 1: return design_launch<kGS, 1>(a, design, st);
    case 2: return design_launch<kGS, 2>(a, design, st);
    case 3: return design_launch<kGS, 3>(a, design, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t pg_degrid_launch(const DegridArgs& a, int design, int mode,
                             cudaStream_t st) {
  if (!degrid_args_ok(a)) return cudaErrorInvalidValue;
  return a.gmap ? degrid_launch<true>(a, design, mode, st)
                : degrid_launch<false>(a, design, mode, st);
}

}  // namespace pfbt

// K6. gr, gi (nw, Nx, Ny), pos (NE, 8, C), tid (NE,) int32 -> out (NE, 2,
// C). Returns a CUDA error code (0 on success).
extern "C" int pfbt_pg_degrid(const float* gr, const float* gi,
                              const float* pos, const int* tid, float* out,
                              int NE, int C, int nw, int Thx, int Thy,
                              int txs, int tys, int nty, int Nx, int Ny,
                              int k, double beta, void* stream) {
  const pfbt::DegridArgs a{gr,  gi,  pos, tid, nullptr, out, NE,
                           C,   nw,  Thx, Thy, txs,     tys, nty,
                           Nx,  Ny,  k,   static_cast<float>(beta), 0.0f};
  return static_cast<int>(
      pfbt::pg_degrid_launch(a, pfbt::kDegridShipped, 0,
                              static_cast<cudaStream_t>(stream)));
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
  const pfbt::DegridArgs a{gr,  gi,  pos, utid, gmap, acc, NE,
                           C,   B,   Thx, Thy,  txs,  tys, nty,
                           Nx,  Ny,  k,   static_cast<float>(beta),
                           static_cast<float>(woff)};
  return static_cast<int>(
      pfbt::pg_degrid_launch(a, pfbt::kDegridShipped, 0,
                              static_cast<cudaStream_t>(stream)));
}
