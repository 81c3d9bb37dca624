"""SARA wavelet dictionary Psi (counterpart of pfb_tpu/ops/psi.py).

- 'self' stores the transposed image;
- Psi is unnormalised: hdot(dot(x)) = nbasis * x (the primal-dual
  compensates with nu = nbasis);
- dot:  (nband, nx, ny) -> (nband, nbasis, Nymax, Nxmax);
- hdot: coefficients -> image, summed over bases.
Every function is batched over the leading axes.

A CUDA float32 tensor runs the hand-written kernels S1 (:func:`psi_dot`)
and S2 (:func:`psi_hdot`) of ``csrc/sara.cu`` on the packed layout; any
other tensor (the CPU, float64) runs the plain versions
(:func:`psi_dot_plain`, :func:`psi_hdot_plain`). While a torch profiler
runs, each call counts under ``psi.kernel`` or ``psi.plain``, by the route
it took. :func:`sara_plan` is the kernels' launch arithmetic.
"""

import math
from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F_

from pfb_tpu_torch import kernels
from pfb_tpu_torch.ops.wavelets import dwt2d, idwt2d, make_spec
from pfb_tpu_torch.utils.profiling import count

_TILE = 32  # coefficients a tile edge (csrc/sara.cu:kSaraTile)


@dataclass(frozen=True)
class PsiSpec:
    nx: int
    ny: int
    bases: Tuple[str, ...]
    nlevel: int
    specs: Tuple
    Nxmax: int
    Nymax: int

    @property
    def nbasis(self):
        return len(self.bases)


def make_psi(nx, ny, bases=("self", "db1", "db2"), nlevel=3) -> PsiSpec:
    specs = []
    Nxmax, Nymax = 0, 0
    for w in bases:
        if w == "self":
            specs.append(None)
            Nxmax = max(Nxmax, nx)
            Nymax = max(Nymax, ny)
        else:
            s = make_spec(w, nx, ny, nlevel)
            specs.append(s)
            Nxmax = max(Nxmax, s.Ntotx)
            Nymax = max(Nymax, s.Ntoty)
    return PsiSpec(nx, ny, tuple(bases), nlevel, tuple(specs), Nxmax, Nymax)


def psi_dot_plain(x, psi: PsiSpec):
    """Plain version of :func:`psi_dot`."""
    outs = []
    for w, s in zip(psi.bases, psi.specs):
        a = x.transpose(-1, -2) if w == "self" else dwt2d(x, s)
        outs.append(F_.pad(a, (0, psi.Nxmax - a.shape[-1],
                               0, psi.Nymax - a.shape[-2])))
    return torch.stack(outs, dim=-3)


def psi_hdot_plain(alpha, psi: PsiSpec):
    """Plain version of :func:`psi_hdot`."""
    out = None
    for i, (w, s) in enumerate(zip(psi.bases, psi.specs)):
        a = alpha[..., i, :, :]
        if w == "self":
            term = a[..., :psi.ny, :psi.nx].transpose(-1, -2)
        else:
            term = idwt2d(a[..., :s.Ntoty, :s.Ntotx], s)
        out = term if out is None else out + term
    return out


def _kernel_route(t):
    if t.is_cuda and t.dtype == torch.float32:
        count("psi.kernel")
        return True
    count("psi.plain")
    return False


def psi_dot(x, psi: PsiSpec):
    """Image (..., nx, ny) -> coefficients (..., nbasis, Nymax, Nxmax).
    ``psi_dot.launches`` counts S1's launches."""
    if not _kernel_route(x):
        return psi_dot_plain(x, psi)
    if x.shape[-2:] != (psi.nx, psi.ny):
        raise ValueError(f"psi_dot: image {tuple(x.shape)} for "
                         f"{psi.nx} x {psi.ny}")
    return _psi_dot_kernel(x, psi)


def _psi_dot_kernel(x, psi):
    lead = x.shape[:-2]
    out = torch.empty(lead + (psi.nbasis, psi.Nymax, psi.Nxmax),
                      dtype=torch.float32, device=x.device)
    nband = math.prod(lead)
    if nband == 0:
        return out
    dp = _device_plan(psi, nband, x.device)
    x = x.contiguous()
    scratch = torch.empty(max(dp.plan.scratch, 1), dtype=torch.float32,
                          device=x.device)
    lib, st = kernels.library(), kernels.stream_ptr()
    slot_band = psi.nbasis * psi.Nymax * psi.Nxmax
    if dp.plan.rects:
        kernels.check(lib.pfbt_psi_zero(
            out.data_ptr(), dp.rects, len(dp.plan.rects), nband, psi.Nxmax,
            slot_band, st), "psi_zero")
        psi_dot.launches += 1
    for ptr, recs in zip(dp.dot, dp.plan.dot):
        kernels.check(lib.pfbt_psi_dot_level(
            x.data_ptr(), out.data_ptr(), scratch.data_ptr(), ptr,
            dp.taps.data_ptr(), len(recs), nband, _tiles(recs),
            _max_filter(recs), psi.Nxmax, slot_band, st), "psi_dot_level")
        psi_dot.launches += 1
    return out


psi_dot.launches = 0


def psi_hdot(alpha, psi: PsiSpec):
    """Coefficients (..., nbasis, Nymax, Nxmax) -> image (..., nx, ny).
    ``psi_hdot.launches`` counts S2's launches."""
    if not _kernel_route(alpha):
        return psi_hdot_plain(alpha, psi)
    if alpha.shape[-3:] != (psi.nbasis, psi.Nymax, psi.Nxmax):
        raise ValueError(f"psi_hdot: coefficients {tuple(alpha.shape)} for "
                         f"{psi.nbasis} bases of {psi.Nymax} x {psi.Nxmax}")
    return _psi_hdot_kernel(alpha, psi)


def _psi_hdot_kernel(alpha, psi):
    lead = alpha.shape[:-3]
    out = torch.empty(lead + (psi.nx, psi.ny), dtype=torch.float32,
                      device=alpha.device)
    nband = math.prod(lead)
    if nband == 0:
        return out
    dp = _device_plan(psi, nband, alpha.device)
    alpha = alpha.contiguous()
    scratch = torch.empty(max(dp.plan.scratch, 1), dtype=torch.float32,
                          device=alpha.device)
    lib, st = kernels.library(), kernels.stream_ptr()
    slot_band = psi.nbasis * psi.Nymax * psi.Nxmax
    for i, (ptr, recs) in enumerate(zip(dp.hdot, dp.plan.hdot)):
        last = i == len(dp.hdot) - 1
        kernels.check(lib.pfbt_psi_hdot_level(
            alpha.data_ptr(), out.data_ptr(), scratch.data_ptr(), ptr,
            dp.taps.data_ptr(), len(recs), nband, _tiles(recs),
            _max_filter(recs), int(last), psi.Nxmax, slot_band, st),
            "psi_hdot_level")
        psi_hdot.launches += 1
    return out


psi_hdot.launches = 0


# ---------------------------------------------------------------------
# the kernels' launch arithmetic


class LevelRec(NamedTuple):
    """One basis at one level of a launch (csrc/sara.cu's record, int64
    fields in this order). Analysis: the level's input image (nx, ny)
    comes from ``src`` (-1: the image itself), its approximation goes to
    ``dst`` (-1: the slot, at the deepest level). Synthesis: the
    low-low quadrant comes from ``src`` (-1: the slot, at the deepest
    level), the output (nx, ny) goes to ``dst`` (-1: the image). The
    'self' slot has F = 0 (analysis: Cx, Cy = Nxmax, Nymax)."""
    F: int
    nx: int
    ny: int
    Cx: int
    Cy: int
    px: int
    py: int
    slot: int
    src: int
    dst: int
    src_band: int
    dst_band: int
    tiles_x: int
    tiles_y: int
    taps: int
    src_ld: int
    dst_ld: int


@dataclass(frozen=True)
class SaraPlan:
    """``dot``: S1's launches, finest level first; ``hdot``: S2's,
    deepest first, the last summing every basis into the image; each a
    tuple of :class:`LevelRec`. ``rects``: (slot offset, y0, y1, x0, x1)
    of the slot area no level's block covers. ``taps``: each wavelet
    basis's dec_lo, dec_hi, rec_lo, rec_hi. ``scratch``: floats of the
    approximations between levels, each a (nband, Cy, Cx) block in the
    packed orientation."""
    dot: tuple
    hdot: tuple
    rects: tuple
    taps: tuple
    scratch: int


def _cdiv(a, b):
    return -(-a // b)


def block_origin(spec, k):
    """(py, px): the first row and column of level k's block of 2 sy[k] x
    2 sx[k] in the packed slot (wavelets.py:dwt2d)."""
    return (spec.iy[k][1] - 2 * spec.sy[k], spec.ix[k][1] - 2 * spec.sx[k])


def zero_rects(spec, Nymax, Nxmax):
    """The (y0, y1, x0, x1) rectangles of the (Nymax, Nxmax) slot outside
    every level's block: the area dwt2d and the slot's pad leave 0."""
    blocks = []
    for k in range(spec.nlevel):
        py, px = block_origin(spec, k)
        blocks.append((py, py + 2 * spec.sy[k], px, px + 2 * spec.sx[k]))
    ys = sorted({0, Nymax} | {b[0] for b in blocks} | {b[1] for b in blocks})
    xs = sorted({0, Nxmax} | {b[2] for b in blocks} | {b[3] for b in blocks})
    rects = []
    for y0, y1 in zip(ys, ys[1:]):
        run = None
        for x0, x1 in zip(xs, xs[1:]):
            hit = any(b[0] <= y0 and y1 <= b[1] and b[2] <= x0 and x1 <= b[3]
                      for b in blocks)
            if not hit:
                run = (run[0], x1) if run else (x0, x1)
            elif run:
                rects.append((y0, y1) + run)
                run = None
        if run:
            rects.append((y0, y1) + run)
    merged = []  # rows of one width that follow each other: one rectangle
    for r in rects:
        m = next((i for i, q in enumerate(merged) if q[1] == r[0]
                  and q[2:] == r[2:]), None)
        if m is None:
            merged.append(r)
        else:
            merged[m] = (merged[m][0], r[1]) + r[2:]
    return merged


def sara_plan(psi: PsiSpec, nband: int) -> SaraPlan:
    """S1's and S2's launches for ``nband`` images (the leading axes
    flattened), from ``psi``'s specs."""
    T = _TILE
    slot_size = psi.Nymax * psi.Nxmax
    nx, ny = psi.nx, psi.ny
    wav = [(s, sp) for s, sp in enumerate(psi.specs) if sp is not None]
    L = psi.nlevel if wav else 1
    taps, dec, rec = [], {}, {}
    for s, sp in wav:
        dec[s] = len(taps)
        taps += list(sp.dec_lo) + list(sp.dec_hi)
        rec[s] = len(taps)
        taps += list(sp.rec_lo) + list(sp.rec_hi)
    levels, scratch = [], 0
    for k in range(L - 1):
        offs = {}
        for s, sp in wav:
            offs[s] = scratch
            scratch += nband * sp.sx[k] * sp.sy[k]
        levels.append(offs)

    def approx(s, sp, k):
        """(offset, band stride, row length) of level k's approximation."""
        return levels[k][s], sp.sx[k] * sp.sy[k], sp.sx[k]

    dot = []
    for k in range(L):
        recs = []
        if k == 0 and "self" in psi.bases:
            s = psi.bases.index("self")
            recs.append(LevelRec(
                0, nx, ny, psi.Nxmax, psi.Nymax, 0, 0, s * slot_size, -1, -1,
                nx * ny, 0, _cdiv(psi.Nxmax, 2 * T), _cdiv(psi.Nymax, 2 * T),
                0, ny, psi.Nxmax))
        for s, sp in wav:
            if k == 0:
                sin, sband, sld, inx, iny = -1, nx * ny, ny, nx, ny
            else:
                sin, sband, sld = approx(s, sp, k - 1)
                inx, iny = sp.sx[k - 1], sp.sy[k - 1]
            dout, dband, dld = approx(s, sp, k) if k < L - 1 else \
                (-1, 0, psi.Nxmax)
            py, px = block_origin(sp, k)
            recs.append(LevelRec(
                sp.F, inx, iny, sp.sx[k], sp.sy[k], px, py, s * slot_size,
                sin, dout, sband, dband, _cdiv(sp.sx[k], T),
                _cdiv(sp.sy[k], T), dec[s], sld, dld))
        dot.append(tuple(recs))

    hdot = []
    for k in reversed(range(L)):
        recs = []
        for s, sp in wav:
            sin, sband, sld = approx(s, sp, k) if k < L - 1 else \
                (-1, 0, psi.Nxmax)
            if k > 0:
                onx, ony = sp.sx[k - 1], sp.sy[k - 1]
                dout, dband, dld = approx(s, sp, k - 1)
            else:
                onx, ony, dout, dband, dld = nx, ny, -1, nx * ny, ny
            py, px = block_origin(sp, k)
            recs.append(LevelRec(
                sp.F, onx, ony, sp.sx[k], sp.sy[k], px, py, s * slot_size,
                sin, dout, sband, dband, _cdiv(onx, 2 * T),
                _cdiv(ony, 2 * T), rec[s], sld, dld))
        if k == 0 and "self" in psi.bases:
            s = psi.bases.index("self")
            recs.append(LevelRec(
                0, nx, ny, psi.Nxmax, psi.Nymax, 0, 0, s * slot_size, -1, -1,
                psi.Nymax * psi.Nxmax, nx * ny, _cdiv(nx, 2 * T),
                _cdiv(ny, 2 * T), 0, psi.Nxmax, ny))
        hdot.append(tuple(recs))

    rects = tuple((s * slot_size,) + r for s, sp in wav
                  for r in zero_rects(sp, psi.Nymax, psi.Nxmax))
    return SaraPlan(tuple(dot), tuple(hdot), rects, tuple(taps), scratch)


def _tiles(recs):
    return max(r.tiles_x * r.tiles_y for r in recs)


def _max_filter(recs):
    return max(r.F for r in recs)


class _DevicePlan(NamedTuple):
    plan: SaraPlan
    records: torch.Tensor  # int64: every launch's records, then the rects
    taps: torch.Tensor     # float32
    dot: tuple             # device address of each S1 launch's records
    hdot: tuple
    rects: int


_PLANS = {}


def _device_plan(psi, nband, device):
    """:func:`sara_plan` on ``device``, made once per (psi, nband,
    device)."""
    key = (psi, nband, str(device))
    if key not in _PLANS:
        plan = sara_plan(psi, nband)
        rows = [list(r) for recs in plan.dot + plan.hdot for r in recs]
        flat = [v for r in rows for v in r] + \
            [v for q in plan.rects for v in q]
        records = torch.tensor(flat, dtype=torch.int64).to(device)
        taps = torch.tensor(plan.taps or [0.0],
                            dtype=torch.float32).to(device)
        base, step = records.data_ptr(), 8 * len(LevelRec._fields)
        addrs, i = [], 0
        for recs in plan.dot + plan.hdot:
            addrs.append(base + step * i)
            i += len(recs)
        nd = len(plan.dot)
        _PLANS[key] = _DevicePlan(plan, records, taps, tuple(addrs[:nd]),
                                  tuple(addrs[nd:]), base + step * i)
    return _PLANS[key]
