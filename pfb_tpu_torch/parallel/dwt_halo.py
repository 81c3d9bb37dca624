"""Space-sharded SARA dictionary with a filter-length halo exchange
(counterpart of pfb_tpu/parallel/dwt_halo.py).

Layouts (those of parallel/dist.py:primal_dual_space_dist):
  image cube  ("band", "space", None): x rows sharded
  dual cube   ("band", None, "space", None): packed coefficient rows
              (the y-derived axis) sharded in chunks of qy

Per basis and analysis level i:
1. the y-axis analysis convolutions run locally on the x-sharded approx
   rows (y is not sharded);
2. the (rows, 2 Cy) output is left-padded by the level's packed row
   offset Wy and right-padded to ps * qy, and one all-to-all plus a
   local transpose gives every shard exactly the packed rows it owns;
3. the x-axis convolutions are then local, and the level block is
   masked into the shard's packed canvas (deeper levels overwrite the
   approx quadrant of shallower ones);
4. the next level's approx stays x-sharded: the strided lo_x convolution
   needs F - 2 rows of the left neighbour (one ppermute, the halo), and
   the rows beyond nx / 2^i (the zero-extension tail, fewer than F rows)
   are computed from a gathered strip and kept replicated.
Synthesis mirrors it with two all-to-all transposes per level.

The functions here run on the shards of one band row: ``xs`` is the
list of row shards in mesh order and ``devs`` their devices
(parallel/mesh.py:along runs them per band row).
"""

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F_

from pfb_tpu_torch.ops.psi import PsiSpec
from pfb_tpu_torch.ops.wavelets import (WaveletSpec, _down_conv_last, _filt,
                                        _up_conv_last, coeff_size)
from pfb_tpu_torch.parallel import collectives as coll


@dataclass(frozen=True)
class HaloLevel:
    Nx: int      # true input x size (global)
    Ny: int      # true input y size
    Cx: int      # x coefficient count (spec.sx[i])
    Cy: int      # y coefficient count (spec.sy[i])
    Wx: int      # packed column offset of this level's block
    Wy: int      # packed row offset of this level's block
    c_in: int    # sharded input rows per shard, nx / (2^i ps)
    t_in: int    # replicated tail input rows, Nx - ps c_in
    spx: int     # synthesis output x size
    spy: int     # synthesis output y size


@dataclass(frozen=True)
class HaloBasisPlan:
    wavelet: str
    spec: Optional[WaveletSpec]
    levels: Tuple[HaloLevel, ...]


@dataclass(frozen=True)
class HaloPsiPlan:
    psi: PsiSpec
    ps: int
    qy: int
    bases: Tuple[HaloBasisPlan, ...]


def make_halo_plan(psi: PsiSpec, ps: int, qy: int) -> HaloPsiPlan:
    """Static bookkeeping; raises ValueError where the halo design's
    shape preconditions fail (the caller falls back to the gather
    method)."""
    nx = psi.nx
    L = psi.nlevel
    if nx % (ps * 2 ** L) != 0:
        raise ValueError(
            f"halo DWT needs nx={nx} divisible by ps*2^L={ps * 2**L}")
    plans = []
    for w, s in zip(psi.bases, psi.specs):
        if w == "self":
            plans.append(HaloBasisPlan(w, None, ()))
            continue
        F = s.F
        levels = []
        Nx, Ny = s.nx, s.ny
        for i in range(L):
            c_in = nx // (2 ** i * ps)
            t_in = Nx - ps * c_in
            if t_in < 0:
                raise ValueError(f"negative tail at level {i}")
            if i < L - 1 and c_in // 2 < F - 2:
                raise ValueError(f"halo DWT: local chunk {c_in // 2} < "
                                 f"F-2={F - 2} at level {i + 1}")
            Cx, Cy = s.sx[i], s.sy[i]
            assert Cx == coeff_size(Nx + Nx % 2, F) or \
                Cx == coeff_size(Nx, F), (Cx, Nx, F)
            Wx = s.ix[i][1] - 2 * Cx
            Wy = s.iy[i][1] - 2 * Cy
            if Wy + 2 * Cy > ps * qy:
                raise ValueError("packed rows exceed ps*qy")
            levels.append(HaloLevel(Nx, Ny, Cx, Cy, Wx, Wy, c_in, t_in,
                                    s.spx[i], s.spy[i]))
            Nx, Ny = Cx, Cy
        plans.append(HaloBasisPlan(w, s, tuple(levels)))
    return HaloPsiPlan(psi, ps, qy, tuple(plans))


def _pad_cols(a, left, total):
    """Zero-pad the last axis: ``left`` zeros, then up to ``total``."""
    right = total - left - a.shape[-1]
    assert right >= 0, (a.shape, left, total)
    return F_.pad(a, (left, right))


def _a2a_transpose(xs, devs):
    """(nbl, m, ps * q) -> (nbl, q, ps * m) per shard: one all-to-all
    (split the last axis, concatenate the rows) and a local transpose."""
    return [g.transpose(1, 2)
            for g in coll.all_to_all(xs, devs, 2, 1)]


def _strided_conv(x, f):
    """VALID stride-2 correlation with f[::-1] along axis 1 of (nbl, c,
    m) -> (nbl, (c - F) // 2 + 1, m)."""
    xt = x.transpose(1, 2)
    lead = xt.shape[:-1]
    k = _filt(tuple(f[::-1]), x.dtype, x.device)
    out = F_.conv1d(xt.reshape(-1, 1, xt.shape[-1]), k, stride=2)
    return out.reshape(*lead, -1).transpose(1, 2)


def _halo_down_conv(mains, devs, f):
    """Strided zero-extension analysis convolution along the sharded axis
    1 of each (nbl, c, m): the last F - 2 rows of the left neighbour (one
    ppermute; shard 0 receives zeros, the zero extension), then a VALID
    stride-2 convolution gives the shard's c / 2 outputs."""
    ps = len(mains)
    F = len(f)
    if F > 2:
        halos = coll.ppermute([m[:, -(F - 2):, :] for m in mains], devs,
                              [(i, i + 1) for i in range(ps - 1)])
        mains = [torch.cat([h, m], dim=1) for h, m in zip(halos, mains)]
    return [_strided_conv(m, f) for m in mains]


def _tail_conv(main_los, tail_los, devs, f, n_out):
    """The analysis outputs past the sharded range (global x-coefficient
    rows >= ps c / 2) depend only on the last F - 2 main rows and the
    replicated tail: gather that strip, convolve, keep (nbl, n_out, m) on
    every shard."""
    if n_out == 0:
        return [m[:, :0, :] for m in main_los]
    ps = len(main_los)
    F = len(f)
    need = max(F - 2, 0)
    outs = []
    if need:
        take = min(need, main_los[0].shape[1])
        strips = coll.all_gather([m[:, m.shape[1] - take:, :]
                                  for m in main_los], devs, 1)
    for r, tl in enumerate(tail_los):
        if need:
            strip = strips[r]
            if ps * take < need:
                strip = F_.pad(strip, (0, 0, need - ps * take, 0))
            else:
                strip = strip[:, -need:, :]
            xin = torch.cat([strip, tl], dim=1)
        else:
            xin = tl
        want = 2 * (n_out - 1) + F
        if want > xin.shape[1]:
            xin = F_.pad(xin, (0, 0, 0, want - xin.shape[1]))
        outs.append(_strided_conv(xin, f)[:, :n_out, :])
    return outs


def _grow(r, qy, device):
    return r * qy + torch.arange(qy, device=device)


def _rowmask(r, qy, lo, hi, device):
    g = _grow(r, qy, device)
    return ((g >= lo) & (g < hi))[None, :, None]


def halo_psi_dot(xs, devs, plan: HaloPsiPlan):
    """Analysis on the shards of one band row: (nbl, nxl, ny) each ->
    (nbl, nbasis, qy, Nxmax) each."""
    psi, ps, qy = plan.psi, plan.ps, plan.qy
    outs = [[] for _ in xs]
    for bp in plan.bases:
        canv = [torch.zeros((x.shape[0], qy, psi.Nxmax), dtype=x.dtype,
                            device=x.device) for x in xs]
        if bp.wavelet == "self":
            # x.T: the rows become y, one transposing all-to-all
            gT = _a2a_transpose([_pad_cols(x, 0, ps * qy) for x in xs], devs)
            for r in range(ps):
                canv[r][..., :psi.nx] = gT[r]
                outs[r].append(canv[r])
            continue
        s = bp.spec
        lo, hi = s.dec_lo, s.dec_hi
        mains = xs
        tails = [x[:, :0, :] for x in xs]
        for li, lev in enumerate(bp.levels):
            m = [a[..., :lev.Ny] for a in mains]
            mlo = [_down_conv_last(a, lo) for a in m]       # (nbl, c, Cy)
            mhi = [_down_conv_last(a, hi) for a in m]
            if lev.t_in:
                tlo = [_down_conv_last(t[..., :lev.Ny], lo) for t in tails]
                thi = [_down_conv_last(t[..., :lev.Ny], hi) for t in tails]
            else:
                tlo = thi = [a.new_zeros((a.shape[0], 0, lev.Cy))
                             for a in m]
            # pass 2 through the packed-aligned transpose
            gT = _a2a_transpose(
                [_pad_cols(torch.cat([a, b], dim=-1), lev.Wy, ps * qy)
                 for a, b in zip(mlo, mhi)], devs)          # (nbl, qy, ps c)
            for r in range(ps):
                row_full = gT[r]
                if lev.t_in:
                    tcat = _pad_cols(torch.cat([tlo[r], thi[r]], dim=-1),
                                     lev.Wy, ps * qy)
                    tsl = tcat[:, :, r * qy:(r + 1) * qy]
                    row_full = torch.cat([row_full, tsl.transpose(1, 2)],
                                         dim=-1)
                row_full = row_full[..., :lev.Nx]
                blk = torch.cat([_down_conv_last(row_full, lo),
                                 _down_conv_last(row_full, hi)], dim=-1)
                msk = _rowmask(r, qy, lev.Wy, lev.Wy + 2 * lev.Cy,
                               blk.device)
                seg = canv[r][..., lev.Wx:lev.Wx + 2 * lev.Cx]
                canv[r][..., lev.Wx:lev.Wx + 2 * lev.Cx] = \
                    torch.where(msk, blk, seg)
            # next approx: lo_x of the lo_y outputs
            if li + 1 < len(bp.levels):
                nxt = bp.levels[li + 1]
                mains = _halo_down_conv(mlo, devs, lo)      # (nbl, c/2, Cy)
                tails = _tail_conv(mlo, tlo, devs, lo, nxt.t_in)
        for r in range(ps):
            outs[r].append(canv[r])
    return [torch.stack(o, dim=1) for o in outs]


def halo_psi_hdot(als, devs, plan: HaloPsiPlan):
    """Synthesis on the shards of one band row: (nbl, nbasis, qy, Nxmax)
    each -> (nbl, nxl, ny) each, summed over the bases."""
    psi, ps, qy = plan.psi, plan.ps, plan.qy
    nxl = psi.nx // ps
    out = [torch.zeros((a.shape[0], nxl, psi.ny), dtype=a.dtype,
                       device=a.device) for a in als]
    for bi, bp in enumerate(plan.bases):
        canv = [a[:, bi] for a in als]
        if bp.wavelet == "self":
            h = _a2a_transpose([_pad_cols(c[..., :psi.nx], 0, ps * nxl)
                                for c in canv], devs)      # (nbl, nxl, ps qy)
            out = [o + g[..., :psi.ny] for o, g in zip(out, h)]
            continue
        img = None
        for li in range(len(bp.levels) - 1, -1, -1):
            lev = bp.levels[li]
            blks = []
            if img is not None:
                # the deeper reconstruction replaces the approx quadrant
                apprT = _a2a_transpose(
                    [_pad_cols(im[..., :lev.Cy], lev.Wy, ps * qy)
                     for im in img], devs)
            for r in range(ps):
                blk = canv[r][..., lev.Wx:lev.Wx + 2 * lev.Cx]
                msk = _rowmask(r, qy, lev.Wy, lev.Wy + 2 * lev.Cy,
                               blk.device)
                blk = torch.where(msk, blk, torch.zeros_like(blk))
                if img is not None:
                    amsk = _rowmask(r, qy, lev.Wy, lev.Wy + lev.Cy,
                                    blk.device)
                    blk = torch.cat([torch.where(
                        amsk, apprT[r][..., :lev.Cx], blk[..., :lev.Cx]),
                        blk[..., lev.Cx:]], dim=-1)
                blks.append(blk)
            rx = [_up_conv_last(b[..., :lev.Cx].contiguous(),
                                bp.spec.rec_lo, lev.spx) +
                  _up_conv_last(b[..., lev.Cx:].contiguous(),
                                bp.spec.rec_hi, lev.spx)
                  for b in blks]                            # (nbl, qy, spx)
            # x container: ps * upad >= spx, a multiple of ps
            upad = nxl if li == 0 else -(-lev.spx // ps)
            h = _a2a_transpose([_pad_cols(a, 0, ps * upad) for a in rx],
                               devs)                        # (nbl, upad, ps qy)
            img = []
            for g in h:
                hs = g[..., lev.Wy:lev.Wy + 2 * lev.Cy]
                img.append(_up_conv_last(hs[..., :lev.Cy].contiguous(),
                                         bp.spec.rec_lo, lev.spy) +
                           _up_conv_last(hs[..., lev.Cy:].contiguous(),
                                         bp.spec.rec_hi, lev.spy))
        out = [o + im[:, :nxl, :psi.ny] for o, im in zip(out, img)]
    return out
