// Native gridder plan builder (a copy of pfb_tpu/native/plan.cc, so the
// port builds the same plans without importing the JAX package).
//
// The pg gridder (pfb_tpu_torch/ops/pgridder.py) needs a host-side plan:
// every (row, chan) visibility is binned to a uv tile, tiles are packed
// into capacity-C entry blocks (stable order, duplicates-by-split for
// over-full tiles, one all-padding entry for empty tiles) and the
// tile-local kernel coordinates + (8, 128)-aligned window coordinates
// are packed into the (nentries, 8, C) position tensor. This C++
// builder does it in two O(N) passes with per-tile cursors (a stable
// counting sort) and no temporaries, bit-identical to the numpy
// planner.
//
// Exposed as a plain C ABI consumed via ctypes
// (pfb_tpu_torch/native/__init__.py); all buffers are allocated by the
// caller.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>
#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

inline int64_t posmod(int64_t a, int64_t n) {
  int64_t r = a % n;
  return r < 0 ? r + n : r;
}

struct Geom {
  const double* uvw;      // (nrow, 3)
  const double* freq;     // (nchan,)
  int64_t nrow, nchan;
  double cellx, celly;
  int64_t Nx, Ny, txs, tys, nty;
  double w0, dw;
  int nw;
};

// per-visibility grid coordinates and tile id; i = row * nchan + chan.
// Multiply order matches the numpy planner exactly
// (((u * s) * cell) * N, s = freq / c) so the outputs are
// bit-identical.
inline void vis_coords(const Geom& g, int64_t i, double* ug, double* vg,
                       double* wp, int64_t* tid) {
  const double c_light = 299792458.0;
  int64_t r = i / g.nchan;
  int64_t c = i % g.nchan;
  double s = g.freq[c] / c_light;
  double u = ((g.uvw[3 * r + 0] * s) * g.cellx) * (double)g.Nx;
  double v = ((g.uvw[3 * r + 1] * s) * g.celly) * (double)g.Ny;
  double w = g.uvw[3 * r + 2] * s;
  *ug = u;
  *vg = v;
  *wp = g.nw > 1 ? (w - g.w0) / g.dw : 0.0;
  // nearbyint: round-half-even, matching np.round in the numpy planner
  int64_t tx = posmod((int64_t)std::nearbyint(u), g.Nx) / g.txs;
  int64_t ty = posmod((int64_t)std::nearbyint(v), g.Ny) / g.tys;
  *tid = tx * g.nty + ty;
}

}  // namespace

extern "C" {

// Pass 1: per-tile visibility counts (tile_counts must be zeroed,
// length ntx*nty).
int pg_plan_count(const double* uvw, int64_t nrow, const double* freq,
                  int64_t nchan, double cellx, double celly,
                  int64_t Nx, int64_t Ny, int64_t txs, int64_t tys,
                  int64_t ntx, int64_t nty, double w0, double dw,
                  int nw, int64_t* tile_counts) {
  Geom g{uvw, freq, nrow, nchan, cellx, celly, Nx, Ny,
         txs, tys, nty, w0, dw, nw};
  const int64_t n = nrow * nchan;
  const int64_t ntiles = ntx * nty;
#ifdef _OPENMP
#pragma omp parallel
  {
    int64_t* local = new int64_t[ntiles]();
    double ug, vg, wp;
    int64_t tid;
#pragma omp for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
      vis_coords(g, i, &ug, &vg, &wp, &tid);
      ++local[tid];
    }
#pragma omp critical
    for (int64_t t = 0; t < ntiles; ++t) tile_counts[t] += local[t];
    delete[] local;
  }
#else
  double ug, vg, wp;
  int64_t tid;
  for (int64_t i = 0; i < n; ++i) {
    vis_coords(g, i, &ug, &vg, &wp, &tid);
    ++tile_counts[tid];
  }
#endif
  return 0;
}

// Pass 2: fill the plan arrays. entry_offset (ntiles+1) is the prefix
// sum of max(1, ceil(count/C)) per tile; outputs (len nentries):
//   pos   (nentries, 8, C) zero-initialised by the caller
//   tid   (nentries,) int32
//   idx   (nentries, C) int32 zero-initialised
//   pm    (nentries, C) float64 zero-initialised (1.0 = live slot)
int pg_plan_fill(const double* uvw, int64_t nrow, const double* freq,
                 int64_t nchan, double cellx, double celly, int64_t Nx,
                 int64_t Ny, int64_t txs, int64_t tys, int64_t ntx,
                 int64_t nty, double w0, double dw, int nw, int64_t C,
                 int64_t k, const int64_t* tile_counts,
                 const int64_t* entry_offset, int64_t nentries,
                 double* pos, int32_t* tid_out, int32_t* idx,
                 double* pm) {
  Geom g{uvw, freq, nrow, nchan, cellx, celly, Nx, Ny,
         txs, tys, nty, w0, dw, nw};
  const int64_t n = nrow * nchan;
  const int64_t ntiles = ntx * nty;
  const double pad_uv = -2.0 * (double)k;

  // scatter pass: raw ug/vg/wp into per-tile entry slots in stable
  // (encounter) order via per-tile cursors — a stable counting sort.
  // Parallelised by TILE RANGE: every thread scans all visibilities
  // (the coordinate math is ~10% of the pass) but only writes tiles it
  // owns, so writes are disjoint and cache-local. Ranges are balanced
  // by visibility count, not tile count.
#ifdef _OPENMP
#pragma omp parallel
  {
    int nth = omp_get_num_threads();
    int me = omp_get_thread_num();
    int64_t per = (n + nth - 1) / nth;  // target vis per thread
    if (per < 1) per = 1;
    // thread me owns tile t iff (vis count before t) / per == me:
    // disjoint, covering, contiguous ranges balanced by vis count
    int64_t t_lo = ntiles, t_hi = ntiles;
    for (int64_t t = 0, a = 0; t < ntiles; ++t) {
      int64_t owner = a / per;
      if (owner == (int64_t)me && t_lo == ntiles) t_lo = t;
      if (owner > (int64_t)me) { t_hi = t; break; }
      a += tile_counts[t];
    }
    if (t_lo < t_hi) {
      int64_t* cursor = new int64_t[t_hi - t_lo]();
      double ug, vg, wp;
      int64_t t;
      for (int64_t i = 0; i < n; ++i) {
        vis_coords(g, i, &ug, &vg, &wp, &t);
        if (t < t_lo || t >= t_hi) continue;
        int64_t cur = cursor[t - t_lo]++;
        int64_t e = entry_offset[t] + cur / C;
        int64_t s = cur % C;
        double* p = pos + (e * 8 + 0) * C;
        p[s] = ug;
        p[C + s] = vg;
        p[2 * C + s] = wp;
        idx[e * C + s] = (int32_t)i;
        pm[e * C + s] = 1.0;
      }
      delete[] cursor;
    }
  }
#else
  int64_t* cursor = new int64_t[ntiles]();
  double ug, vg, wp;
  int64_t t;
  for (int64_t i = 0; i < n; ++i) {
    vis_coords(g, i, &ug, &vg, &wp, &t);
    int64_t cur = cursor[t]++;
    int64_t e = entry_offset[t] + cur / C;
    int64_t s = cur % C;
    double* p = pos + (e * 8 + 0) * C;
    p[s] = ug;
    p[C + s] = vg;
    p[2 * C + s] = wp;
    idx[e * C + s] = (int32_t)i;
    pm[e * C + s] = 1.0;
  }
  delete[] cursor;
#endif

  // entry pass: tile ids, empty-tile padding, local + window coords
  const int64_t h = k / 2;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 16)
#endif
  for (int64_t t2 = 0; t2 < ntiles; ++t2) {
    int64_t e0 = entry_offset[t2];
    int64_t e1 = entry_offset[t2 + 1];
    int64_t tx = t2 / nty;
    int64_t ty = t2 % nty;
    int64_t sx = posmod(tx * txs - h, Nx);
    int64_t sy = posmod(ty * tys - h, Ny);
    double ax = (double)((sx / 8) * 8);
    double ay = (double)((sy / 128) * 128);
    double dxw = (double)(sx) - ax;
    double dyw = (double)(sy) - ay;
    bool empty = tile_counts[t2] == 0;
    for (int64_t e = e0; e < e1; ++e) {
      tid_out[e] = (int32_t)t2;
      double* p = pos + e * 8 * C;
      for (int64_t s = 0; s < C; ++s) {
        double pu = empty ? pad_uv : p[s];
        double pv = empty ? pad_uv : p[C + s];
        // tile-local coordinates with the mod-wrap unwrapped
        double ul = std::fmod(pu, (double)Nx);
        if (ul < 0) ul += (double)Nx;
        ul -= (double)(tx * txs) - (double)h;
        if (ul < 0) ul += (double)Nx;
        if (ul > (double)(txs + k)) ul -= (double)Nx;
        double vl = std::fmod(pv, (double)Ny);
        if (vl < 0) vl += (double)Ny;
        vl -= (double)(ty * tys) - (double)h;
        if (vl < 0) vl += (double)Ny;
        if (vl > (double)(tys + k)) vl -= (double)Ny;
        p[s] = ul;
        p[C + s] = vl;
        p[3 * C + s] = ul + dxw;
        p[4 * C + s] = vl + dyw;
        p[5 * C + s] = ax;
        p[6 * C + s] = ay;
      }
    }
  }
  (void)nentries;
  return 0;
}


// Sampling-density (uv counts) gridding with the ES k-stencil —
// the reference's numba _compute_counts kernel
// (pfb/utils/weighting.py:43-103) as native code: threads accumulate
// into private grids (bounded thread count keeps the nx*ny copies in
// memory), reduced at the end. Per-tap drop semantics for
// out-of-grid taps. Mirrors pfb_tpu/ops/weighting.py exactly.
// Returns 1, touching nothing, for a stencil wider than the 16 taps of
// its per-row buffer (k > 16) or a negative k.
int pg_compute_counts(const double* uvw, int64_t nrow,
                      const double* freq, int64_t nchan,
                      const uint8_t* mask, int64_t nx, int64_t ny,
                      double cellx, double celly, int k,
                      double* out) {
  if (k < 0 || k > 16) return 1;
  const double u_cell = 1.0 / ((double)nx * cellx);
  const double umax = std::fabs(-1.0 / cellx / 2.0 - u_cell / 2.0);
  const double v_cell = 1.0 / ((double)ny * celly);
  const double vmax = std::fabs(-1.0 / celly / 2.0 - v_cell / 2.0);
  const double c0 = 299792458.0;
  const int ko2 = k / 2;
  const int64_t npix = nx * ny;
  const double beta_k = 2.3 * (double)k;
#pragma omp parallel num_threads(8)
  {
    std::vector<double> loc(npix, 0.0);
    std::vector<double> nf(nchan);
    for (int64_t c = 0; c < nchan; ++c) nf[c] = freq[c] / c0;
#pragma omp for schedule(static) nowait
    for (int64_t r = 0; r < nrow; ++r) {
      const double uu = uvw[3 * r], vv = uvw[3 * r + 1];
      for (int64_t c = 0; c < nchan; ++c) {
        if (!mask[r * nchan + c]) continue;
        const double ug = (uu * nf[c] + umax) / u_cell;
        const double vg = (vv * nf[c] + vmax) / v_cell;
        if (k) {
          const int64_t ui = (int64_t)std::nearbyint(ug);
          const int64_t vi = (int64_t)std::nearbyint(vg);
          double yv[16];
          for (int j = -ko2; j < ko2; ++j) {
            const int64_t y = vi + j;
            const double t = ((double)y - vg + 0.5) / (double)ko2;
            yv[j + ko2] = (std::fabs(t) <= 1.0)
                ? std::exp(beta_k * (std::sqrt(std::max(
                      (1.0 - t) * (1.0 + t), 0.0)) - 1.0))
                : 0.0;
          }
          for (int i = -ko2; i < ko2; ++i) {
            const int64_t x = ui + i;
            if (x < 0 || x >= nx) continue;
            const double tx = ((double)x - ug + 0.5) / (double)ko2;
            if (std::fabs(tx) > 1.0) continue;
            const double xv = std::exp(beta_k * (std::sqrt(std::max(
                (1.0 - tx) * (1.0 + tx), 0.0)) - 1.0));
            double* rowp = loc.data() + x * ny;
            for (int j = -ko2; j < ko2; ++j) {
              const int64_t y = vi + j;
              if (y < 0 || y >= ny) continue;
              rowp[y] += xv * yv[j + ko2];
            }
          }
        } else {
          const int64_t ui = (int64_t)std::floor(ug);
          const int64_t vi = (int64_t)std::floor(vg);
          if (ui >= 0 && ui < nx && vi >= 0 && vi < ny)
            loc[ui * ny + vi] += 1.0;
        }
      }
    }
#pragma omp critical
    {
      for (int64_t i = 0; i < npix; ++i) out[i] += loc[i];
    }
  }
  return 0;
}


// ---------------------------------------------------------------
// Global-stream (tile, w)-sorted plan builder: the native twin of
// pfb_tpu_torch/ops/pg_stream.py:_pg_plan_gs_numpy. Pass 1 counts
// visibilities per uv tile; the caller derives entry offsets
// (ceil(count/C) entries per non-empty tile); pass 2 buckets the
// visibilities tile-major, stable-sorts each tile's slice by
// fractional w-plane position (ties keep original order — matching
// np.lexsort((wpos, tid))), and packs the per-entry position/index/
// mask arrays bit-identically to the numpy path. It keeps no
// fixed-size tap arrays, so it takes any support k.

int pg_gs_count(const double* uvw, int64_t nrow, const double* freq,
                int64_t nchan, double cellx, double celly, int64_t Nx,
                int64_t Ny, int64_t txs, int64_t tys, int64_t ntx,
                int64_t nty, double w0, double dw, int nw,
                int64_t* tile_counts) {
  Geom g{uvw, freq, nrow, nchan, cellx, celly, Nx, Ny,
         txs, tys, nty, w0, dw, nw};
  const int64_t n = nrow * nchan;
  const int64_t ntiles = ntx * nty;
#pragma omp parallel
  {
    std::vector<int64_t> loc(ntiles, 0);
#pragma omp for schedule(static) nowait
    for (int64_t i = 0; i < n; ++i) {
      double ug, vg, wp;
      int64_t tid;
      vis_coords(g, i, &ug, &vg, &wp, &tid);
      loc[tid]++;
    }
#pragma omp critical
    {
      for (int64_t t = 0; t < ntiles; ++t) tile_counts[t] += loc[t];
    }
  }
  return 0;
}

int pg_gs_fill(const double* uvw, int64_t nrow, const double* freq,
               int64_t nchan, double cellx, double celly, int64_t Nx,
               int64_t Ny, int64_t txs, int64_t tys, int64_t ntx,
               int64_t nty, double w0, double dw, int nw, int64_t C,
               int64_t k, const int64_t* tile_counts,
               const int64_t* vis_offsets,
               const int64_t* entry_offsets, int64_t NEg,
               double* pos, int32_t* gidx, double* gpm,
               int32_t* utid, int64_t* pmin, int64_t* pmax,
               int64_t* sxy) {
  Geom g{uvw, freq, nrow, nchan, cellx, celly, Nx, Ny,
         txs, tys, nty, w0, dw, nw};
  const int64_t n = nrow * nchan;
  const int64_t ntiles = ntx * nty;
  // bucket visibilities tile-major (stable: ascending i within tile)
  std::vector<int64_t> order(n);
  std::vector<double> wpos(n);
  {
    std::vector<int64_t> cursor(ntiles);
    for (int64_t t = 0; t < ntiles; ++t) cursor[t] = vis_offsets[t];
    for (int64_t i = 0; i < n; ++i) {
      double ug, vg, wp;
      int64_t tid;
      vis_coords(g, i, &ug, &vg, &wp, &tid);
      wpos[i] = wp;
      order[cursor[tid]++] = i;
    }
  }
  const int64_t h = k / 2;
#pragma omp parallel for schedule(dynamic, 64)
  for (int64_t t = 0; t < ntiles; ++t) {
    const int64_t cnt = tile_counts[t];
    if (!cnt) continue;
    int64_t* slice = order.data() + vis_offsets[t];
    std::stable_sort(slice, slice + cnt,
                     [&](int64_t a, int64_t b) {
                       return wpos[a] < wpos[b];
                     });
    const int64_t tx = t / nty, ty = t % nty;
    const int64_t sxv = posmod(tx * txs - h, Nx);
    const int64_t syv = posmod(ty * tys - h, Ny);
    const int64_t ax = (sxv / 8) * 8, ay = (syv / 128) * 128;
    const double dxw = (double)(sxv - ax), dyw = (double)(syv - ay);
    const int64_t ne = (cnt + C - 1) / C;
    for (int64_t e = 0; e < ne; ++e) {
      const int64_t ent = entry_offsets[t] + e;
      utid[ent] = (int32_t)t;
      sxy[ent] = (ax / 8) * 512 + (ay / 128);
      double wmin = 1e300, wmax = -1e300;
      double* p = pos + ent * 8 * C;
      int32_t* gi = gidx + ent * C;
      double* pm = gpm + ent * C;
      for (int64_t s = 0; s < C; ++s) {
        const int64_t sv = e * C + s;
        double ug = 0.0, vg = 0.0, wp = 0.0;
        if (sv < cnt) {
          const int64_t i = slice[sv];
          int64_t tid_;
          vis_coords(g, i, &ug, &vg, &wp, &tid_);
          gi[s] = (int32_t)i;
          pm[s] = 1.0;
          if (wp < wmin) wmin = wp;
          if (wp > wmax) wmax = wp;
        } else {
          gi[s] = 0;
          pm[s] = 0.0;
        }
        // identical transforms to _pg_plan_gs (incl. pad slots at
        // coordinate 0.0, whose values flow through the same mod /
        // unwrap arithmetic)
        double ul = std::fmod(ug, (double)Nx);
        if (ul < 0) ul += (double)Nx;
        ul = ul - (double)(tx * txs) + (double)h;
        if (ul < 0) ul += (double)Nx;
        if (ul > (double)(txs + k)) ul -= (double)Nx;
        double vl = std::fmod(vg, (double)Ny);
        if (vl < 0) vl += (double)Ny;
        vl = vl - (double)(ty * tys) + (double)h;
        if (vl < 0) vl += (double)Ny;
        if (vl > (double)(tys + k)) vl -= (double)Ny;
        p[0 * C + s] = ul;
        p[1 * C + s] = vl;
        p[2 * C + s] = wp;
        p[3 * C + s] = ul + dxw;
        p[4 * C + s] = vl + dyw;
        p[5 * C + s] = (double)ax;
        p[6 * C + s] = (double)ay;
        p[7 * C + s] = 0.0;
      }
      int64_t lo = (int64_t)std::ceil(wmin - (double)k / 2.0);
      int64_t hi2 = (int64_t)std::floor(wmax + (double)k / 2.0);
      if (lo < 0) lo = 0;
      if (hi2 > nw - 1) hi2 = nw - 1;
      pmin[ent] = lo;
      pmax[ent] = hi2;
    }
  }
  (void)NEg;
  return 0;
}

}  // extern "C"
