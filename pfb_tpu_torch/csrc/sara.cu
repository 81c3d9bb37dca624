// S1 / S2: the SARA dictionary's analysis (psi_dot) and synthesis
// (psi_hdot) on the packed coefficient layout (ops/psi.py).
//
// No TPU kernel is replaced: the JAX package runs SARA as plain jnp
// (pfb_tpu/ops/wavelets.py, pfb_tpu/ops/psi.py). These kernels take the
// place of the port's plain chain of strided conv1d calls with cat,
// transpose, pad, stack and clone (ops/psi.py:psi_dot_plain,
// psi_hdot_plain), which stays beside them for CPU and float64 tensors.
//
// The arithmetic is ops/wavelets.py's, in float32 FMAs only (no TF32, no
// tensor cores: in TF32 the Psi round trip loses about three digits):
// - analysis   out[o] = sum_j f[j] x[2o+1-j], x zero-extended, first along
//   y (the image's last axis), then along x;
// - synthesis  out[2m+p] += sum_j f[2j+p] c[m+F/2-1-j], first along x,
//   then along y;
// - the packed (Nymax, Nxmax) slot of a basis is transposed against the
//   image; level k's block of four quadrants (fy, fx) sits at (py, px)
//   (ops/psi.py:sara_plan, from make_spec's ix, iy), its low-low
//   quadrant overwritten by level k+1's block.
//
// What bounds them on the H100, and what the design does about it:
// - Bytes. A few FMAs a byte; the image (8, 2048^2) is 134 MB and the
//   coefficient cube (8, 3, 2055^2) 405 MB, so each direction's bound is
//   about 0.16 ms at 3.35 TB/s. The design moves each byte about once.
// - Analysis, one launch a level over every basis and band (grid: tiles
//   x bases, bands; the bases of a tile neighbours in launch order, so
//   the image of level 0 comes from HBM once and from L2 for the other
//   bases). A block loads its tile of the level's input with the F - 2
//   zero-extended halo into shared memory once, runs the stride-2 pass
//   along y (lo and hi), then along x, in shared memory, and writes the
//   detail quadrants straight to their place in the packed slot. The
//   level's approximation goes to a scratch buffer that the next level
//   reads (never the packed slot, which the next level overwrites);
//   the deepest level writes it to the slot. The 'self' slot is the
//   tiled transpose of the image, the slot's pad written as zeros by the
//   same blocks; the slot area no level's block covers is zeroed by
//   psi_zero_kernel (a few thin rectangles), so no memset, pad or stack.
// - Synthesis, one launch a level, deepest first. A block loads the four
//   quadrants of its coefficient tile (the low-low one from the deeper
//   level's output in scratch), runs the up-pass along x, then along y,
//   in shared memory. The last level's blocks take every basis of a tile
//   in turn, the next basis's tiles loading while this one's passes run,
//   add the 'self' slot's transpose, and write the image once.
// - Every tile reaches shared memory by cp.async, zero-filled outside the
//   image or block, all of a block's copies in flight at once (with plain
//   loads through registers, a few in flight, and no second tile buffer,
//   S2 took 1.8x longer).
// - Shared-memory rows have odd pitches where a warp walks down a column,
//   so those reads are free of bank conflicts. Taps live in registers for
//   F = 2 and 4 (db1, db2); other F read them through the read-only cache
//   (compiling F = 6 and 8 as well made S2 spill and cost it 9 %).
#include <cuda_runtime.h>

namespace pfbt {

constexpr int kSaraTile = 32;  // coefficients a tile edge (ops/psi.py:_TILE)
constexpr int kSaraThreads = 256;
constexpr int kSaraOut = (2 * kSaraTile) * (2 * kSaraTile) / kSaraThreads;
constexpr int kSaraPitch = 2 * kSaraTile + 1;  // a 2T-wide shared row
constexpr int kSaraZeroSplit = 16;             // blocks a zero rectangle

// The fields of a level record, int64 each (ops/psi.py:LevelRec).
enum {
  R_F,         // filter length; 0: the 'self' slot
  R_NX,        // analysis: the level's input (x, y); synthesis: its output
  R_NY,
  R_CX,        // coefficients along x, y (self: Nxmax, Nymax)
  R_CY,
  R_PX,        // the level's block in the slot: first column, first row
  R_PY,
  R_SLOT,      // the basis's slot (band 0)
  R_SRC,       // scratch offset of the input approximation, -1: none
  R_DST,       // scratch offset of the output approximation, -1: none
  R_SRC_BAND,  // elements between bands of the source
  R_DST_BAND,  // elements between bands of the destination
  R_TILES_X,   // tiles along x, y
  R_TILES_Y,
  R_TAPS,      // offset of the taps: lo (F), then hi (F)
  R_SRC_LD,    // row length of the source
  R_DST_LD,    // row length of the destination
  kSaraRec
};

// A basis's two filters: in registers for a compiled length, else read
// through the read-only cache.
template <int kF>
struct SaraTaps {
  float lo_[kF], hi_[kF];
  __device__ __forceinline__ SaraTaps(const float* t, int) {
#pragma unroll
    for (int j = 0; j < kF; ++j) {
      lo_[j] = __ldg(t + j);
      hi_[j] = __ldg(t + kF + j);
    }
  }
  __device__ __forceinline__ float lo(int j) const { return lo_[j]; }
  __device__ __forceinline__ float hi(int j) const { return hi_[j]; }
};

template <>
struct SaraTaps<0> {
  const float* t_;
  int F_;
  __device__ __forceinline__ SaraTaps(const float* t, int F) : t_(t), F_(F) {}
  __device__ __forceinline__ float lo(int j) const { return __ldg(t_ + j); }
  __device__ __forceinline__ float hi(int j) const {
    return __ldg(t_ + F_ + j);
  }
};

// An asynchronous 4-byte copy global -> shared (cp.async), zero-filled
// where !ok (src is then never read), and the wait for all of a thread's
// copies.
__device__ __forceinline__ void copy4(float* dst, const float* src, bool ok) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
#else
  *dst = ok ? *src : 0.f;
#endif
}

__device__ __forceinline__ void copies_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;");
#endif
}

// Wait for all but the newest N groups of this thread's copies.
template <int N>
__device__ __forceinline__ void copies_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
#endif
}

// Floats of shared memory a block takes for filters up to F long.
__host__ __device__ inline int dot_smem_floats(int F) {
  const int W = 2 * kSaraTile + (F > 2 ? F : 2) - 2;
  const int wav = W * (W + 1) + 2 * W * (kSaraTile + 1);
  const int self = 2 * kSaraTile * kSaraPitch;
  return wav > self ? wav : self;
}

// S2: two tile buffers (a record's tiles load into one while the other's
// passes run), then the x pass's rows.
__host__ __device__ inline int hdot_buf_floats(int F) {
  const int E = kSaraTile + (F > 2 ? F : 2) / 2 - 1;
  const int self = 2 * kSaraTile * kSaraPitch;
  return 4 * E * E > self ? 4 * E * E : self;
}

__host__ __device__ inline int hdot_smem_floats(int F) {
  const int E = kSaraTile + (F > 2 ? F : 2) / 2 - 1;
  return 2 * hdot_buf_floats(F) + 2 * E * kSaraPitch;
}

// The 'self' slot's tile (ti, tj) of 2T x 2T: slot[Y][X] = x[X][Y] inside
// the image, 0 in the slot's pad.
__device__ __forceinline__ void self_dot_tile(
    const long long* __restrict__ rec, const float* __restrict__ x,
    float* __restrict__ coeffs, int band, int ti, int tj, int Nxmax,
    long long slot_band, float* sm) {
  constexpr int T2 = 2 * kSaraTile;
  const int nx = rec[R_NX], ny = rec[R_NY], Nx = rec[R_CX], Ny = rec[R_CY];
  const int X0 = T2 * ti, Y0 = T2 * tj, t = threadIdx.x;
  const float* in = x + band * rec[R_SRC_BAND];
  for (int i = t; i < T2 * T2; i += kSaraThreads) {
    const int r = i / T2, c = i - r * T2, X = X0 + r, Y = Y0 + c;
    const bool ok = X < nx && Y < ny;
    copy4(sm + r * kSaraPitch + c, ok ? in + (long long)X * ny + Y : in, ok);
  }
  copies_commit();
  copies_wait<0>();
  __syncthreads();
  float* slot = coeffs + band * slot_band + rec[R_SLOT];
  for (int i = t; i < T2 * T2; i += kSaraThreads) {
    const int Yl = i / T2, Xl = i - Yl * T2, X = X0 + Xl, Y = Y0 + Yl;
    if (X < Nx && Y < Ny)
      slot[(long long)Y * Nxmax + X] = sm[Xl * kSaraPitch + Yl];
  }
}

// One analysis tile of T x T coefficients of a wavelet basis at one level.
template <int kF>
__device__ __forceinline__ void dwt_tile(
    const long long* __restrict__ rec, int Fr, const float* __restrict__ x,
    float* __restrict__ coeffs, float* __restrict__ scratch,
    const float* __restrict__ taps, int band, int ti, int tj, int Nxmax,
    long long slot_band, float* sm) {
  constexpr int T = kSaraTile, PR = kSaraTile + 1;
  const int F = kF ? kF : Fr;
  const int W = 2 * T + F - 2, PW = W + 1;
  float* sIn = sm;           // [W][PW]: x along rows, y along columns
  float* sR = sm + W * PW;   // [2][W][PR]: the y pass's lo, hi
  const int nx = rec[R_NX], ny = rec[R_NY], Cx = rec[R_CX], Cy = rec[R_CY];
  const int ld = rec[R_SRC_LD];
  const long long src = rec[R_SRC];
  const int X0 = 2 * T * ti - (F - 2), Y0 = 2 * T * tj - (F - 2);
  const int t = threadIdx.x;
  if (src < 0) {  // the image: (x, y) rows, y contiguous
    const float* in = x + band * rec[R_SRC_BAND];
    for (int i = t; i < W * W; i += kSaraThreads) {
      const int r = i / W, c = i - r * W, X = X0 + r, Y = Y0 + c;
      const bool ok = X >= 0 && X < nx && Y >= 0 && Y < ny;
      copy4(sIn + r * PW + c, ok ? in + (long long)X * ld + Y : in, ok);
    }
  } else {  // the finer level's approximation: packed orientation (y, x)
    const float* in = scratch + src + band * rec[R_SRC_BAND];
    for (int i = t; i < W * W; i += kSaraThreads) {
      const int c = i / W, r = i - c * W, X = X0 + r, Y = Y0 + c;
      const bool ok = X >= 0 && X < nx && Y >= 0 && Y < ny;
      copy4(sIn + r * PW + c, ok ? in + (long long)Y * ld + X : in, ok);
    }
  }
  copies_commit();
  const SaraTaps<kF> tp(taps + rec[R_TAPS], F);
  copies_wait<0>();
  __syncthreads();
  // along y: every input row r, T outputs
  for (int i = t; i < W * T; i += kSaraThreads) {
    const int r = i / T, oy = i - r * T;
    const float* row = sIn + r * PW + 2 * oy + F - 1;
    float l = 0.f, h = 0.f;
#pragma unroll
    for (int j = 0; j < F; ++j) {
      const float v = row[-j];
      l = fmaf(tp.lo(j), v, l);
      h = fmaf(tp.hi(j), v, h);
    }
    sR[r * PR + oy] = l;
    sR[(W + r) * PR + oy] = h;
  }
  __syncthreads();
  // along x, straight to the slot (quadrant (fy, fx) at rows py + fy Cy,
  // columns px + fx Cx); low-low to scratch below the deepest level
  const int px = rec[R_PX], py = rec[R_PY];
  const long long dst = rec[R_DST];
  float* slot = coeffs + band * slot_band + rec[R_SLOT];
  float* ll = dst < 0 ? nullptr : scratch + dst + band * rec[R_DST_BAND];
  for (int i = t; i < T * T; i += kSaraThreads) {
    const int oy = i / T, ox = i - oy * T;
    const int gx = T * ti + ox, gy = T * tj + oy;
    if (gx >= Cx || gy >= Cy) continue;
#pragma unroll
    for (int fy = 0; fy < 2; ++fy) {
      const float* col = sR + (fy * W + 2 * ox + F - 1) * PR + oy;
      float l = 0.f, h = 0.f;
#pragma unroll
      for (int j = 0; j < F; ++j) {
        const float v = col[-j * PR];
        l = fmaf(tp.lo(j), v, l);
        h = fmaf(tp.hi(j), v, h);
      }
      float* o = slot + (long long)(py + fy * Cy + gy) * Nxmax + px + gx;
      if (fy == 0 && ll != nullptr)
        ll[(long long)gy * rec[R_DST_LD] + gx] = l;
      else
        o[0] = l;
      o[Cx] = h;
    }
  }
}

__global__ void __launch_bounds__(kSaraThreads)
    psi_dot_kernel(const float* __restrict__ x, float* __restrict__ coeffs,
                   float* __restrict__ scratch,
                   const long long* __restrict__ plan,
                   const float* __restrict__ taps, int nrec, int Nxmax,
                   long long slot_band) {
  extern __shared__ float sm[];
  const int r = blockIdx.x % nrec, tile = blockIdx.x / nrec;
  const int band = blockIdx.y;
  const long long* rec = plan + r * kSaraRec;
  const int tx = rec[R_TILES_X], ty = rec[R_TILES_Y];
  if (tile >= tx * ty) return;
  const int tj = tile / tx, ti = tile - tj * tx;
  const int F = rec[R_F];
  switch (F) {
    case 0:
      self_dot_tile(rec, x, coeffs, band, ti, tj, Nxmax, slot_band, sm);
      break;
    case 2:
      dwt_tile<2>(rec, F, x, coeffs, scratch, taps, band, ti, tj, Nxmax,
                  slot_band, sm);
      break;
    case 4:
      dwt_tile<4>(rec, F, x, coeffs, scratch, taps, band, ti, tj, Nxmax,
                  slot_band, sm);
      break;
    default:
      dwt_tile<0>(rec, F, x, coeffs, scratch, taps, band, ti, tj, Nxmax,
                  slot_band, sm);
  }
}

// The output point k of this thread in a 2T x 2T tile: y fastest for the
// image (its rows run along y), x fastest for the packed orientation.
__device__ __forceinline__ void out_point(bool img, int k, int& Xl, int& Yl) {
  constexpr int T2 = 2 * kSaraTile, S = kSaraThreads / T2;
  const int t = threadIdx.x;
  Xl = img ? t / T2 + S * k : t % T2;
  Yl = img ? t % T2 : t / T2 + S * k;
}

// Start the copies of a synthesis record's tiles into buf: a wavelet
// basis's four quadrants of E x E coefficients (the low-low one from the
// deeper level's output in scratch), or the 'self' slot's 2T x 2T tile.
template <int kF>
__device__ __forceinline__ void idwt_load(
    const long long* __restrict__ rec, int Fr,
    const float* __restrict__ coeffs, const float* __restrict__ scratch,
    int band, int ti, int tj, int Nxmax, long long slot_band, float* buf) {
  constexpr int T = kSaraTile;
  const int F = kF ? kF : Fr;
  const int E = T + F / 2 - 1;
  const int Cx = rec[R_CX], Cy = rec[R_CY], px = rec[R_PX], py = rec[R_PY];
  const long long src = rec[R_SRC];
  const float* slot = coeffs + band * slot_band + rec[R_SLOT];
  const float* ll = src < 0 ? nullptr : scratch + src + band * rec[R_SRC_BAND];
  const int m0x = T * ti, m0y = T * tj;
  for (int i = threadIdx.x; i < 4 * E * E; i += kSaraThreads) {
    const int q = i / (E * E), rem = i - q * E * E, a = rem / E,
              b = rem - a * E;
    const int fy = q >> 1, fx = q & 1, my = m0y + a, mx = m0x + b;
    const bool ok = my < Cy && mx < Cx;
    const float* s = !ok ? slot
                     : q == 0 && ll != nullptr
                         ? ll + (long long)my * rec[R_SRC_LD] + mx
                         : slot + (long long)(py + fy * Cy + my) * Nxmax +
                               px + fx * Cx + mx;
    copy4(buf + i, s, ok);
  }
}

__device__ __forceinline__ void self_hdot_load(
    const long long* __restrict__ rec, const float* __restrict__ coeffs,
    int band, int ti, int tj, int Nxmax, long long slot_band, float* buf) {
  constexpr int T2 = 2 * kSaraTile;
  const int nx = rec[R_NX], ny = rec[R_NY], X0 = T2 * ti, Y0 = T2 * tj;
  const float* slot = coeffs + band * slot_band + rec[R_SLOT];
  for (int i = threadIdx.x; i < T2 * T2; i += kSaraThreads) {
    const int Yl = i / T2, Xl = i - Yl * T2, X = X0 + Xl, Y = Y0 + Yl;
    const bool ok = X < nx && Y < ny;
    copy4(buf + Yl * kSaraPitch + Xl,
          ok ? slot + (long long)Y * Nxmax + X : slot, ok);
  }
}

// A synthesis filter pair's taps of one parity, f[2j + odd]: in
// registers for a compiled length, else read through the read-only cache.
template <int kF>
struct UpTaps {
  float lo_[kF / 2], hi_[kF / 2];
  __device__ __forceinline__ UpTaps(const float* t, int, bool odd) {
#pragma unroll
    for (int j = 0; j < kF / 2; ++j) {
      lo_[j] = __ldg(t + 2 * j + odd);
      hi_[j] = __ldg(t + kF + 2 * j + odd);
    }
  }
  __device__ __forceinline__ float lo(int j) const { return lo_[j]; }
  __device__ __forceinline__ float hi(int j) const { return hi_[j]; }
};

template <>
struct UpTaps<0> {
  const float* t_;
  int F_;
  __device__ __forceinline__ UpTaps(const float* t, int F, bool odd)
      : t_(t + odd), F_(F) {}
  __device__ __forceinline__ float lo(int j) const {
    return __ldg(t_ + 2 * j);
  }
  __device__ __forceinline__ float hi(int j) const {
    return __ldg(t_ + F_ + 2 * j);
  }
};

// A wavelet basis's 2T x 2T output points from its loaded tiles, added
// to acc (this thread's kSaraOut points, out_point). A thread's points
// share their parity along x and along y in both passes (2T divides the
// block and out_point's strides are even), so each pass holds the one
// parity's taps.
template <int kF>
__device__ __forceinline__ void idwt_passes(
    const long long* __restrict__ rec, int Fr,
    const float* __restrict__ taps, bool img, const float* sB, float* rx,
    float* acc) {
  constexpr int T = kSaraTile, T2 = 2 * kSaraTile;
  const int F = kF ? kF : Fr;
  const int H = F / 2 - 1, E = T + H, t = threadIdx.x;
  const float* tf = taps + rec[R_TAPS];
  // along x: rx[fy][a][Xl] = sum_fx up(quadrant (fy, fx) row a)[Xl]
  {
    const int Xl = t % T2, ml = Xl >> 1;
    const UpTaps<kF> g(tf, F, Xl & 1);
    for (int i = t / T2; i < 2 * E; i += kSaraThreads / T2) {
      const int a = i % E, fy = i / E;
      const float* c = sB + (fy * 2 * E + a) * E + ml + H;
      float v = 0.f;
#pragma unroll
      for (int j = 0; j < F / 2; ++j) v = fmaf(g.lo(j), c[-j], v);
#pragma unroll
      for (int j = 0; j < F / 2; ++j) v = fmaf(g.hi(j), c[E * E - j], v);
      rx[(fy * E + a) * kSaraPitch + Xl] = v;
    }
  }
  __syncthreads();
  // along y
  int X0l, Y0l;
  out_point(img, 0, X0l, Y0l);
  const UpTaps<kF> g(tf, F, Y0l & 1);
#pragma unroll
  for (int k = 0; k < kSaraOut; ++k) {
    int Xl, Yl;
    out_point(img, k, Xl, Yl);
    const float* c = rx + ((Yl >> 1) + H) * kSaraPitch + Xl;
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < F / 2; ++j)
      v = fmaf(g.lo(j), c[-j * kSaraPitch], v);
#pragma unroll
    for (int j = 0; j < F / 2; ++j)
      v = fmaf(g.hi(j), c[(E - j) * kSaraPitch], v);
    acc[k] += v;
  }
}

__device__ __forceinline__ void hdot_load(
    const long long* __restrict__ rec, const float* __restrict__ coeffs,
    const float* __restrict__ scratch, int band, int ti, int tj, int Nxmax,
    long long slot_band, float* buf) {
  const int F = rec[R_F];
  switch (F) {
    case 0:
      self_hdot_load(rec, coeffs, band, ti, tj, Nxmax, slot_band, buf);
      break;
    case 2:
      idwt_load<2>(rec, F, coeffs, scratch, band, ti, tj, Nxmax, slot_band,
                   buf);
      break;
    case 4:
      idwt_load<4>(rec, F, coeffs, scratch, band, ti, tj, Nxmax, slot_band,
                   buf);
      break;
    default:
      idwt_load<0>(rec, F, coeffs, scratch, band, ti, tj, Nxmax, slot_band,
                   buf);
  }
  copies_commit();
}

__device__ __forceinline__ void hdot_passes(
    const long long* __restrict__ rec, const float* __restrict__ taps,
    bool img, const float* buf, float* rx, float* acc) {
  const int F = rec[R_F];
  switch (F) {
    case 0:  // the 'self' slot's transpose
#pragma unroll
      for (int k = 0; k < kSaraOut; ++k) {
        int Xl, Yl;
        out_point(true, k, Xl, Yl);
        acc[k] += buf[Yl * kSaraPitch + Xl];
      }
      break;
    case 2:
      idwt_passes<2>(rec, F, taps, img, buf, rx, acc);
      break;
    case 4:
      idwt_passes<4>(rec, F, taps, img, buf, rx, acc);
      break;
    default:
      idwt_passes<0>(rec, F, taps, img, buf, rx, acc);
  }
}

// sum = 0: a block a (tile, basis), its output the coarser approximation
// in scratch; sum = 1 (the finest level): a block a tile, every basis of
// the launch in turn (the 'self' slot among them), the image written once.
// The next record's tiles load while this one's passes run.
__global__ void __launch_bounds__(kSaraThreads)
    psi_hdot_kernel(const float* __restrict__ coeffs, float* __restrict__ img,
                    float* __restrict__ scratch,
                    const long long* __restrict__ plan,
                    const float* __restrict__ taps, int nrec, int sum,
                    int Nxmax, long long slot_band, int buf_floats) {
  extern __shared__ float sm[];
  const int r0 = sum ? 0 : blockIdx.x % nrec;
  const int r1 = sum ? nrec : r0 + 1;
  const int tile = sum ? blockIdx.x : blockIdx.x / nrec;
  const int band = blockIdx.y;
  const long long* rec0 = plan + r0 * kSaraRec;
  const int tx = rec0[R_TILES_X], ty = rec0[R_TILES_Y];
  if (tile >= tx * ty) return;
  const int tj = tile / tx, ti = tile - tj * tx;
  const bool im = sum != 0;
  float* rx = sm + 2 * buf_floats;
  float acc[kSaraOut];
#pragma unroll
  for (int k = 0; k < kSaraOut; ++k) acc[k] = 0.f;
  hdot_load(rec0, coeffs, scratch, band, ti, tj, Nxmax, slot_band, sm);
  for (int r = r0; r < r1; ++r) {
    float* buf = sm + ((r - r0) & 1) * buf_floats;
    if (r + 1 < r1) {
      hdot_load(plan + (r + 1) * kSaraRec, coeffs, scratch, band, ti, tj,
                Nxmax, slot_band, sm + ((r + 1 - r0) & 1) * buf_floats);
      copies_wait<1>();
    } else {
      copies_wait<0>();
    }
    __syncthreads();
    hdot_passes(plan + r * kSaraRec, taps, im, buf, rx, acc);
    __syncthreads();
  }
  constexpr int T2 = 2 * kSaraTile;
  const int nxo = rec0[R_NX], nyo = rec0[R_NY], ld = rec0[R_DST_LD];
  float* out = im ? img + band * rec0[R_DST_BAND]
                  : scratch + rec0[R_DST] + band * rec0[R_DST_BAND];
#pragma unroll
  for (int k = 0; k < kSaraOut; ++k) {
    int Xl, Yl;
    out_point(im, k, Xl, Yl);
    const int X = T2 * ti + Xl, Y = T2 * tj + Yl;
    if (X < nxo && Y < nyo)
      out[im ? (long long)X * ld + Y : (long long)Y * ld + X] = acc[k];
  }
}

// Zeros in the slot area no level's block covers: rectangles (slot offset,
// y0, y1, x0, x1), kSaraZeroSplit blocks each, a band a grid row.
__global__ void __launch_bounds__(kSaraThreads)
    psi_zero_kernel(float* __restrict__ coeffs,
                    const long long* __restrict__ rects, int Nxmax,
                    long long slot_band) {
  const long long* q = rects + 5 * (blockIdx.x / kSaraZeroSplit);
  const int part = blockIdx.x % kSaraZeroSplit;
  const int y0 = q[1], x0 = q[3], w = q[4] - q[3];
  const long long n = (long long)(q[2] - q[1]) * w;
  float* slot = coeffs + blockIdx.y * slot_band + q[0];
  for (long long i = part * kSaraThreads + threadIdx.x; i < n;
       i += kSaraThreads * kSaraZeroSplit) {
    const int y = y0 + (int)(i / w), xx = x0 + (int)(i % w);
    slot[(long long)y * Nxmax + xx] = 0.f;
  }
}

template <typename K>
static cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace pfbt

// S1, one level: nrec records (device) -> the level's quadrants in the
// packed coefficients (nband, nbasis, Nymax, Nxmax) and its approximation
// in scratch. tiles: the most tiles a record has; maxF: the longest filter.
extern "C" int pfbt_psi_dot_level(const float* x, float* coeffs,
                                  float* scratch, const long long* plan,
                                  const float* taps, int nrec, int nband,
                                  int tiles, int maxF, int Nxmax,
                                  long long slot_band, void* stream) {
  using namespace pfbt;
  if (nrec < 1 || nband < 1 || nband > 65535 || tiles < 1 || maxF < 0 ||
      (long long)tiles * nrec > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * dot_smem_floats(maxF);
  cudaError_t e = set_smem(psi_dot_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  psi_dot_kernel<<<dim3(tiles * nrec, nband), kSaraThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      x, coeffs, scratch, plan, taps, nrec, Nxmax, slot_band);
  return static_cast<int>(cudaGetLastError());
}

// S2, one level: sum = 0 writes each record's output approximation to
// scratch (a block a tile and record); sum = 1 sums every record's tile
// into the image (nband, nx, ny).
extern "C" int pfbt_psi_hdot_level(const float* coeffs, float* img,
                                   float* scratch, const long long* plan,
                                   const float* taps, int nrec, int nband,
                                   int tiles, int maxF, int sum, int Nxmax,
                                   long long slot_band, void* stream) {
  using namespace pfbt;
  if (nrec < 1 || nband < 1 || nband > 65535 || tiles < 1 || maxF < 0 ||
      (long long)tiles * (sum ? 1 : nrec) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * hdot_smem_floats(maxF);
  cudaError_t e = set_smem(psi_hdot_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  psi_hdot_kernel<<<dim3(sum ? tiles : tiles * nrec, nband), kSaraThreads,
                    smem, static_cast<cudaStream_t>(stream)>>>(
      coeffs, img, scratch, plan, taps, nrec, sum, Nxmax, slot_band,
      hdot_buf_floats(maxF));
  return static_cast<int>(cudaGetLastError());
}

// Zeros of S1: nrect rectangles (device, 5 int64 each) in every band.
extern "C" int pfbt_psi_zero(float* coeffs, const long long* rects,
                             int nrect, int nband, int Nxmax,
                             long long slot_band, void* stream) {
  using namespace pfbt;
  if (nrect < 1 || nband < 1 || nband > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  psi_zero_kernel<<<dim3(nrect * kSaraZeroSplit, nband), kSaraThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(coeffs, rects, Nxmax,
                                                         slot_band);
  return static_cast<int>(cudaGetLastError());
}
