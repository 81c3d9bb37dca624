"""The w-plane-blocked pg engine (counterpart of pfb_tpu/ops/pg_stream.py):
the pg gridder for w-term imaging at 4096^2 and larger, where the
all-planes grids would not fit. Grid memory is O(plane_block x padded
grid) instead of O(nw x padded grid).

The plan (:func:`pgrid_plan_wblocked`, the JAX package's format, built by
the native builder or its numpy twin) holds ONE global entry stream: the
visibilities binned per uv tile, w-sorted inside each tile and packed into
capacity-C entries, so each entry reaches a tight range of w planes. Each
block of B planes selects the entries it reaches through an entry map
``gmap`` and lays their tiles out in compact slots (colour-major, as in
the JAX package). Per call:

- the adjoint weights, phase-shifts and gathers the visibilities into the
  stream once, then for each live block spreads its mapped entries onto
  their slots (K7, :func:`pg_spread_gs`), folds the slots into the
  block's periodic (2B, Nx, Ny) grids (K8, :func:`pg_fold_gs`) and adds
  the block's planes to the image (ops/wgridder.py, K3 on the card);
- the forward transforms the image to each live block's B plane grids
  and adds every mapped entry's degridded visibilities to one per-entry
  accumulator (K9, :func:`pg_degrid_gs`), then scatters it back to
  (nrow, nchan) once.

The JAX block ``lax.scan`` is a Python loop over live blocks here, and
the kernel launches cover each block's live entries, so the JAX
package's static stream-length buckets are not needed.

Each of K7, K8 and K9 is a wrapper: a CUDA float32 operand launches the
hand-written kernel (``csrc/pg_grid.cu``, ``pg_fold.cu``,
``pg_degrid.cu``); a CPU operand runs the plain PyTorch version beside
it (``*_plain``), which the CPU tests hold against the JAX package's
Pallas kernels in interpret mode.

:func:`stack_pg_plans_wblocked` plans every dataset with one shared
geometry for the band-sharded exact residual (parallel/dist.py), and
:func:`_hessian_pg_cube_local_wblocked` runs a band shard's datasets.
Not ported: the plan's ``shapes_to`` / ``NEg`` padding and the stacks'
row padding, which serve XLA's compile cache.
"""

import numpy as np
import torch

from pfb_tpu_torch import kernels
from pfb_tpu_torch.config import as_device, kernel_dtype
from pfb_tpu_torch.native import pg_gs_plan_native
from pfb_tpu_torch.ops.dft import LIGHTSPEED
from pfb_tpu_torch.ops.mmgridder import _pad_tiles, _tile_geometry
from pfb_tpu_torch.ops.pgridder import (_auto_tiles, _ds_beam_image,
                                        _fold_geom, _np, _shift_phases,
                                        _weights, pg_degrid_plain,
                                        pg_fold_plain, pg_spread_plain,
                                        w_geometry, w_geometry_union)
from pfb_tpu_torch.ops.wgridder import (_grid_setup, _grid_to_image,
                                        _image_to_grid, gi_consts,
                                        kernel_params)

FOLD_G = 8  # the JAX package's fold batch: colour runs are padded to it


# ---------------------------------------------------------------------
# plan


def _pg_plan_gs_numpy(uvw_np, freq_np, Nx, Ny, cellx, celly, txs, tys, ntx,
                      nty, w0, dw, nw, C, k):
    """The numpy twin of the native global-stream builder (same outputs
    bit for bit): pos (NEg+1, 8, C) [rows 0-2 tile-local u, v and the
    ABSOLUTE fractional w plane; rows 3-6 the JAX package's degrid window
    coordinates, which the port's kernels do not read], gidx (NEg+1, C)
    flat visibility indices, gpm mask, utid (NEg,) tile ids, each entry's
    first and last w tap (pmin, pmax) and sxy window starts. The last row
    is the null entry (coordinates -2k, zero mask)."""
    del ntx
    scale = freq_np / LIGHTSPEED
    ug = (uvw_np[:, 0:1] * scale[None, :]) * cellx * Nx
    vg = (uvw_np[:, 1:2] * scale[None, :]) * celly * Ny
    wl = uvw_np[:, 2:3] * scale[None, :]
    wpos = ((wl - w0) / dw).ravel() if nw > 1 else np.zeros(ug.size)
    ugf, vgf = ug.ravel(), vg.ravel()

    tx_ = np.mod(np.round(ugf).astype(np.int64), Nx) // txs
    ty_ = np.mod(np.round(vgf).astype(np.int64), Ny) // tys
    tid_all = tx_ * nty + ty_
    order = np.lexsort((wpos, tid_all))  # tile-major, w-ascending
    tids = tid_all[order]
    (pu, pv, pw), utid, idx, pmask, _ = _pad_tiles(
        order, tids, [ugf, vgf, wpos], C)
    nent = utid.size

    ty = utid % nty
    tx = utid // nty
    h = k // 2
    pu_loc = np.mod(pu, Nx) - (tx * txs)[:, None] + h
    pv_loc = np.mod(pv, Ny) - (ty * tys)[:, None] + h
    pu_loc = np.where(pu_loc < 0, pu_loc + Nx, pu_loc)
    pu_loc = np.where(pu_loc > txs + k, pu_loc - Nx, pu_loc)
    pv_loc = np.where(pv_loc < 0, pv_loc + Ny, pv_loc)
    pv_loc = np.where(pv_loc > tys + k, pv_loc - Ny, pv_loc)

    sx = np.mod(tx * txs - h, Nx)
    sy = np.mod(ty * tys - h, Ny)
    ax, ay = (sx // 8) * 8, (sy // 128) * 128
    pos = np.zeros((nent + 1, 8, C), np.float64)
    pos[:nent, 0] = pu_loc
    pos[:nent, 1] = pv_loc
    pos[:nent, 2] = pw
    pos[:nent, 3] = pu_loc + (sx - ax)[:, None]
    pos[:nent, 4] = pv_loc + (sy - ay)[:, None]
    pos[:nent, 5] = ax[:, None]
    pos[:nent, 6] = ay[:, None]
    pos[nent, 0:2] = -2.0 * k
    pos[nent, 3:5] = -2.0 * k

    gidx = np.zeros((nent + 1, C), np.int64)
    gidx[:nent] = idx
    gpm = np.zeros((nent + 1, C), bool)
    gpm[:nent] = pmask

    # per-entry w-tap support [pmin, pmax] (inclusive: the ES factor is
    # nonzero at |p - w| == k/2)
    wmin = np.where(pmask, pw, np.inf).min(axis=1)
    wmax = np.where(pmask, pw, -np.inf).max(axis=1)
    pmin = np.maximum(np.ceil(wmin - k / 2.0), 0).astype(np.int64)
    pmax = np.minimum(np.floor(wmax + k / 2.0), nw - 1).astype(np.int64)
    sxy = (ax // 8) * 512 + (ay // 128)
    return pos, gidx, gpm, utid, pmin, pmax, sxy


def _pg_plan_gs(uvw_np, freq_np, Nx, Ny, cellx, celly, txs, tys, ntx, nty,
                w0, dw, nw, C, k):
    """The global stream from the native builder, or its numpy twin."""
    args = dict(Nx=Nx, Ny=Ny, cellx=cellx, celly=celly, txs=txs, tys=tys,
                ntx=ntx, nty=nty, w0=w0, dw=dw, nw=nw, C=C, k=k)
    nat = pg_gs_plan_native(uvw_np, freq_np, **args)
    if nat is not None:
        return nat
    return _pg_plan_gs_numpy(uvw_np, freq_np, **args)


def _block_maps(utid, pmin, pmax, sxy_g, nblocks, B, nty, txs, tys, k, G):
    """Per-block entry maps and compact-slot layouts, as the JAX package
    makes them: for each block ``gmap`` (entries of the global stream
    whose w taps reach the block, null-padded), ``tp`` ((slot << 1) |
    live), ``sxy`` window starts and ``ltid``/``lflag`` slot -> tile.
    Slots are colour-major, every colour run padded to a multiple of G;
    a tile's entries are consecutive in a block's map."""
    NEg = utid.size
    Sx, Sy = _fold_geom(txs + k, tys + k, txs, tys)

    emaps, tps, sxys, ltids, lflags = [], [], [], [], []
    for b in range(nblocks):
        lo, hi = b * B, b * B + B - 1
        eb = np.flatnonzero((pmin <= hi) & (pmax >= lo))
        tb = utid[eb]
        ut, inv = np.unique(tb, return_inverse=True)
        col = (ut // nty % Sx) * Sy + (ut % nty) % Sy
        order2 = np.lexsort((ut, col))
        cs = col[order2]
        if ut.size:
            starts = np.flatnonzero(np.r_[True, cs[1:] != cs[:-1]])
            lens = np.diff(np.r_[starts, cs.size])
            pads = (-lens) % G
            offs = np.cumsum(np.r_[0, (lens + pads)[:-1]])
            within = np.arange(cs.size) - np.repeat(starts, lens)
            slot_sorted = np.repeat(offs, lens) + within
            NTb = int((lens + pads).sum())
            rank = np.empty(ut.size, np.int64)
            rank[order2] = slot_sorted
            ltid_b = np.zeros(NTb, np.int64)
            lflag_b = np.zeros(NTb, np.int64)
            ltid_b[slot_sorted] = ut[order2]
            lflag_b[slot_sorted] = 1
            ctid = rank[inv]
        else:
            ltid_b = np.zeros(0, np.int64)
            lflag_b = np.zeros(0, np.int64)
            ctid = np.zeros(0, np.int64)
        emaps.append(eb)
        tps.append(ctid * 2 + 1)
        sxys.append(sxy_g[eb])
        ltids.append(ltid_b)
        lflags.append(lflag_b)

    NEb = max(max((e.size for e in emaps), default=1), 1)
    NT = max(max((t.size for t in ltids), default=G), G)
    NT = -(-NT // G) * G

    gmap = np.full((nblocks, NEb), NEg, np.int64)  # the null entry
    tp = np.zeros((nblocks, NEb), np.int64)
    sxy = np.zeros((nblocks, NEb), np.int64)
    ltid = np.zeros((nblocks, NT), np.int64)
    lflag = np.zeros((nblocks, NT), np.int64)
    nelive = np.zeros(nblocks, np.int64)
    for b in range(nblocks):
        ne = emaps[b].size
        gmap[b, :ne] = emaps[b]
        tp[b, :ne] = tps[b]
        sxy[b, :ne] = sxys[b]
        if ne:  # pad slots repeat the last live slot with live bit 0
            tp[b, ne:] = (tps[b][-1] // 2) * 2
        nt = ltids[b].size
        ltid[b, :nt] = ltids[b]
        lflag[b, :nt] = lflags[b]
        nelive[b] = ne
    return gmap, tp, sxy, ltid, lflag, nelive > 0, nelive, NEb, NT


def _slot_tables(tp, ltid, lflag, nelive, ntiles):
    """The kernels' per-block tables: each slot's range [start, start +
    count) of map positions (count 0 for colour padding) and the tile ->
    slot table (-1 for a tile outside the block). (nblocks, NT) and
    (nblocks, ntiles) int64."""
    nblocks, NT = ltid.shape
    start = np.zeros((nblocks, NT), np.int64)
    count = np.zeros((nblocks, NT), np.int64)
    tslot = np.full((nblocks, ntiles), -1, np.int64)
    for b in range(nblocks):
        ne = int(nelive[b])
        if ne:
            slot = tp[b, :ne] >> 1
            count[b] = np.bincount(slot, minlength=NT)
            first = np.flatnonzero(np.r_[True, slot[1:] != slot[:-1]])
            start[b, slot[first]] = first
        live = np.flatnonzero(lflag[b])
        tslot[b, ltid[b, live]] = live
    return start, count, tslot


def _utid_from_maps(gmap, tp, ltid, nelive, NEg):
    """Each global entry's tile from the block maps (every entry lies in
    at least one block): utid[gmap[b, m]] = ltid[b, tp[b, m] >> 1]."""
    utid = np.full(NEg, -1, np.int64)
    for b in range(gmap.shape[0]):
        ne = int(nelive[b])
        utid[gmap[b, :ne]] = ltid[b, tp[b, :ne] >> 1]
    if (utid < 0).any():
        raise ValueError("plan: an entry of the stream lies in no block")
    return utid


_HOST_KEYS = ("tp", "sxy", "lflag", "blive", "nelive", "woff", "w0s")


def _finish_plan(meta, arrays, utid, device, dtype):
    """The port's plan dict: the JAX package's keys, with the kernels'
    tables (utid, start, count, tslot) added; arrays the kernels and
    plain versions read go to ``device``, the rest stay numpy."""
    p0 = meta["p0"]
    start, count, tslot = _slot_tables(arrays["tp"], arrays["ltid"],
                                       arrays["lflag"], arrays["nelive"],
                                       p0["ntx"] * p0["nty"])

    def dev(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device,
                                                           dtype=dt)

    i32 = torch.int32
    out = dict(meta)
    out.update({key: np.asarray(arrays[key]) for key in _HOST_KEYS})
    out.update(
        pos=dev(arrays["pos"], dtype), gidx=dev(arrays["gidx"], i32),
        gpm=dev(arrays["gpm"], dtype), gmap=dev(arrays["gmap"], i32),
        ltid=dev(arrays["ltid"], i32), utid=dev(utid, i32),
        start=dev(start, i32), count=dev(count, i32),
        tslot=dev(tslot, i32),
        uvw_full=dev(arrays["uvw_full"], torch.float64),
        freq_d=dev(arrays["freq_d"], torch.float64))
    return out


def pgrid_plan_wblocked(uvw, freq, *, nx, ny, cellx, celly, epsilon=1e-7,
                        sigma=2.0, capacity=None, x0=0.0, y0=0.0,
                        plane_block=8, dtype=None, w_params=None,
                        tile_u=None, tile_v=None, device=None):
    """W-plane-blocked global-stream plan (the JAX package's arrays and
    keys, ``p0`` included). ``plane_block`` bounds the planes per block:
    B = min(plane_block, nw), then evened out over the same number of
    blocks. Capacity 256 from 2^22 visibilities, else 128; auto-ladder
    tiles from 2^18. ``p0["cfft_prec"]`` is kept for the JAX package's
    format; the port's plane transforms are plain float32 and ignore
    it. Arrays go to ``device``: positions and mask in ``dtype``
    (float32 on CUDA, float64 on the CPU by default), indices int32."""
    k, beta = kernel_params(epsilon)
    Nx, Ny = _grid_setup(nx, ny, cellx, celly, sigma)
    uvw_np = _np(uvw).astype(np.float64)
    freq_np = _np(freq).astype(np.float64)
    device = as_device(device)
    if dtype is None:
        dtype = kernel_dtype(device, torch.float64)
    nrow, nchan = uvw_np.shape[0], freq_np.shape[0]
    if w_params is not None:
        nw, w0, dw = w_params
    else:
        nw, w0, dw = w_geometry(uvw_np, freq_np, nx, ny, cellx, celly, x0,
                                y0, sigma, k, True)
    if capacity is None:
        capacity = 256 if nrow * nchan >= (1 << 22) else 128
    if tile_u is None and tile_v is None and nrow * nchan >= (1 << 18):
        tile_u, tile_v = _auto_tiles(uvw_np, freq_np, Nx, Ny, cellx, celly,
                                     k, capacity)
    txs, tys = _tile_geometry(Nx, Ny, k, tile_u, tile_v)
    ntx = -(-Nx // txs)
    nty = -(-Ny // tys)
    C = capacity
    B = min(int(plane_block), nw)
    nblocks = max(1, -(-nw // B))
    B = -(-nw // nblocks)

    pos, gidx, gpm, utid, pmin, pmax, sxy_g = _pg_plan_gs(
        uvw_np, freq_np, Nx, Ny, cellx, celly, txs, tys, ntx, nty, w0, dw,
        nw, C, k)
    NEg = utid.size
    gmap, tp, sxy, ltid, lflag, blive, nelive, NEb, NT = _block_maps(
        utid, pmin, pmax, sxy_g, nblocks, B, nty, txs, tys, k, FOLD_G)

    p0 = dict(k=k, beta=float(beta), Nx=Nx, Ny=Ny, ntx=ntx, nty=nty,
              txs=txs, tys=tys, C=C, nx=nx, ny=ny, cellx=cellx, celly=celly,
              x0=x0, y0=y0, rdtype=dtype, nw=B, w0=float(w0), dw=float(dw),
              nentries=NEg, nrow=nrow, nchan=nchan,
              cfft_prec="split" if epsilon >= 1e-5 else None)
    meta = dict(p0=p0, B=B, nblocks=nblocks, nw=nw, w0=float(w0),
                dw=float(dw), nrow=nrow, nchan=nchan, NEg=NEg, NEb=NEb,
                NT=NT, G=FOLD_G)
    arrays = dict(pos=pos, gidx=gidx, gpm=gpm, gmap=gmap, tp=tp, sxy=sxy,
                  ltid=ltid, lflag=lflag, blive=blive, nelive=nelive,
                  woff=(np.arange(nblocks) * B).astype(np.int32)[:, None],
                  w0s=w0 + np.arange(nblocks) * B * dw, uvw_full=uvw_np,
                  freq_d=freq_np)
    return _finish_plan(meta, arrays, utid, device, dtype)


def plan_wblocked_from_jax(bp, device=None, dtype=None):
    """The port's blocked plan from a JAX ``pgrid_plan_wblocked`` dict
    (arrays as numpy or JAX arrays), so that both packages run on the
    same binning."""
    device = as_device(device)
    if dtype is None:
        dtype = torch.float64 if np.dtype(bp["p0"]["rdtype"]) == np.float64 \
            else torch.float32
    meta = {key: bp[key] for key in ("B", "nblocks", "nw", "w0", "dw",
                                     "nrow", "nchan", "NEg", "NEb", "NT",
                                     "G")}
    meta["p0"] = dict(bp["p0"], rdtype=dtype)
    arrays = {key: np.array(bp[key]) for key in (
        "pos", "gidx", "gpm", "gmap", "tp", "sxy", "ltid", "lflag",
        "blive", "nelive", "woff", "w0s", "uvw_full", "freq_d")}
    arrays["tp"] = arrays["tp"].astype(np.int64)
    utid = _utid_from_maps(arrays["gmap"].astype(np.int64), arrays["tp"],
                           arrays["ltid"], arrays["nelive"], bp["NEg"])
    return _finish_plan(meta, arrays, utid, device, dtype)


# ---------------------------------------------------------------------
# K7: spread of one block


def _slot_of_positions(start, count):
    """The slot of each map position of a block, from the slots' ranges
    (on their device)."""
    ne = int(count.sum())
    cl = count.long()
    sl = torch.repeat_interleave(torch.arange(count.numel(),
                                              device=count.device), cl)
    first = torch.repeat_interleave(start.long(), cl)
    base = torch.repeat_interleave(torch.cumsum(cl, 0) - cl, cl)
    out = torch.empty(ne, dtype=torch.long, device=count.device)
    out[first + torch.arange(ne, device=count.device) - base] = sl
    return out


def _block_view(pos, gmap, woff):
    """The mapped entries' positions with w relative to the block's first
    plane (the JAX kernels subtract woff in the working dtype)."""
    p = pos[gmap.long()]
    p[:, 2] = p[:, 2] - float(woff)
    return p


def pg_spread_gs_plain(pos, vis, gmap, start, count, *, woff, beta, k, B,
                       Thx, Thy):
    """Plain K7: dense ES factors of the mapped entries (w - woff), the
    TPU kernel's per-entry product, and ``index_add_`` over the block's
    slots. -> (2, B, NT, Thx, Thy); slots with no entry hold zeros."""
    NT = start.numel()
    g = gmap.long()
    slots = dict(NS=NT, ent_slot=_slot_of_positions(start, count))
    return pg_spread_plain(_block_view(pos, gmap, woff), vis[g], slots,
                           beta=beta, k=k, nw=B, Thx=Thx, Thy=Thy, do_w=True)


def pg_spread_gs(pos, vis, gmap, start, count, *, woff, beta, k, B, Thx,
                 Thy):
    """K7: spread one w block's mapped entries onto its compact slots.
    ``pos`` (NEg+1, 8, C) and ``vis`` (NEg+1, 2, C) are the global
    stream, ``gmap`` the live prefix of the block's entry map, ``start``
    / ``count`` (NT,) each slot's range of map positions, ``woff`` the
    block's first plane -> (2, B, NT, Thx, Thy). Only slots with entries
    hold a result; the kernel leaves the others unwritten. CUDA float32
    operands launch csrc/pg_grid.cu, CPU operands run
    :func:`pg_spread_gs_plain`."""
    NEg1, _, C = pos.shape
    if vis.shape != (NEg1, 2, C) or start.shape != count.shape:
        raise ValueError(f"pg_spread_gs: vis {tuple(vis.shape)}, start "
                         f"{tuple(start.shape)}, count {tuple(count.shape)} "
                         f"for pos {tuple(pos.shape)}")
    kw = dict(woff=woff, beta=beta, k=k, B=B, Thx=Thx, Thy=Thy)
    if not pos.is_cuda:
        return pg_spread_gs_plain(pos, vis, gmap, start, count, **kw)
    kernels.require_cuda_f32("pg_spread_gs", pos, vis)
    kernels.require_cuda_i32("pg_spread_gs", gmap, start, count)
    NT = start.numel()
    out = torch.empty((2, B, NT, Thx, Thy), dtype=torch.float32,
                      device=pos.device)
    code = kernels.library().pfbt_pg_spread_gs(
        pos.data_ptr(), vis.data_ptr(), gmap.data_ptr(), start.data_ptr(),
        count.data_ptr(), out.data_ptr(), C, NT, B, Thx, Thy, k, int(woff),
        float(beta), kernels.stream_ptr())
    kernels.check(code, "pg_spread_gs")
    pg_spread_gs.launches += 1
    return out


pg_spread_gs.launches = 0


# the lab's designs of the spread (``csrc/lab_spread.cu``)
SPREAD_DESIGNS = {"scan": 0, "lists": 1}
SPREAD_MODES = ("kernel", "no FMA", "no scan", "no factors", "barriers")


def pg_spread_lab(pos, vis, start, count, *, beta, k, nw, Thx, Thy,
                  gmap=None, woff=0, design="lists", mode="kernel"):
    """The spread lab's entry (``csrc/lab_spread.cu``, for
    scripts/torch_kernel_lab.py --spread and the card tests): ``design``
    "lists" is K4 / K7's kernel (``csrc/pg_grid.cu``), "scan" the
    earlier design kept as their reference, whose grids are bit for bit
    the same; ``mode`` one of :data:`SPREAD_MODES`, the kernel or a
    skeleton that drops parts from the end (its output is not a grid).
    K7's operands where ``gmap`` is given (``woff`` its block's first
    plane, :func:`pg_spread_gs`'s), else K4's (``pgridder.pg_spread``'s,
    ``start`` / ``count`` the slots'). CUDA float32 operands launch the
    kernel; CPU operands run the plain spread (the kernel mode only). ->
    (2, nw, NS, Thx, Thy), slots with no entries unwritten."""
    NS = start.numel()
    NE1, _, C = pos.shape
    if design not in SPREAD_DESIGNS or mode not in SPREAD_MODES or \
            vis.shape != (NE1, 2, C) or count.shape != start.shape:
        raise ValueError(f"pg_spread_lab: design {design!r}, mode {mode!r},"
                         f" pos {tuple(pos.shape)}, vis {tuple(vis.shape)}")
    if not pos.is_cuda:
        if mode != "kernel":
            raise ValueError("pg_spread_lab: a skeleton needs the card")
        if gmap is None:
            ent = torch.full((NE1,), NS, dtype=torch.long,
                             device=pos.device)
            ent[:int(count.sum())] = _slot_of_positions(start, count)
            return pg_spread_plain(pos, vis, dict(NS=NS, ent_slot=ent),
                                   beta=beta, k=k, nw=nw, Thx=Thx, Thy=Thy)
        return pg_spread_gs_plain(pos, vis, gmap, start, count, woff=woff,
                                  beta=beta, k=k, B=nw, Thx=Thx, Thy=Thy)
    kernels.require_cuda_f32("pg_spread_lab", pos, vis)
    kernels.require_cuda_i32("pg_spread_lab", start, count,
                             *(() if gmap is None else (gmap,)))
    out = torch.empty((2, nw, NS, Thx, Thy), dtype=torch.float32,
                      device=pos.device)
    code = kernels.library().pfbt_pg_spread_lab(
        pos.data_ptr(), vis.data_ptr(),
        None if gmap is None else gmap.data_ptr(), start.data_ptr(),
        count.data_ptr(), out.data_ptr(), C, NS, nw, Thx, Thy, k, int(woff),
        float(beta), SPREAD_DESIGNS[design], SPREAD_MODES.index(mode),
        kernels.stream_ptr())
    kernels.check(code, "pg_spread_lab")
    pg_spread_lab.launches += 1
    return out


pg_spread_lab.launches = 0


# ---------------------------------------------------------------------
# K8: fold of one block


def pg_fold_gs_plain(Yc, tslot, *, nty, txs, tys, k, Nx, Ny):
    """Plain K8: ``index_add_`` of the block's slots (those in its tile
    -> slot table) at their shifted origins mod (Nx, Ny)."""
    NT = Yc.shape[1]
    dev = Yc.device
    inb = tslot >= 0
    sl = tslot[inb].long()
    tile = torch.zeros(NT, dtype=torch.long, device=dev)
    tile[sl] = torch.arange(tslot.numel(), device=dev)[inb]
    live = torch.zeros(NT, dtype=torch.bool, device=dev)
    live[sl] = True
    return pg_fold_plain(Yc, dict(tile=tile, live=live), nty=nty, txs=txs,
                         tys=tys, k=k, Nx=Nx, Ny=Ny)


def pg_fold_gs(Yc, tslot, *, ntx, nty, txs, tys, k, Nx, Ny):
    """K8: overlap-add one block's slots (2B, NT, Thx, Thy) into its
    periodic (2B, Nx, Ny) grids; ``tslot`` (ntx * nty,) is the block's
    tile -> slot table. CUDA float32 operands launch csrc/pg_fold.cu,
    CPU operands run :func:`pg_fold_gs_plain`."""
    if tslot.numel() != ntx * nty:
        raise ValueError(f"pg_fold_gs: tile table of {tslot.numel()} for "
                         f"{ntx} x {nty} tiles")
    if not Yc.is_cuda:
        return pg_fold_gs_plain(Yc, tslot, nty=nty, txs=txs, tys=tys, k=k,
                                Nx=Nx, Ny=Ny)
    kernels.require_cuda_f32("pg_fold_gs", Yc)
    kernels.require_cuda_i32("pg_fold_gs", tslot)
    nq, NT, Thx, Thy = Yc.shape
    if Nx < Thx or Ny < Thy:
        raise ValueError(f"pg_fold_gs: grid ({Nx}, {Ny}) smaller than a "
                         f"tile block ({Thx}, {Thy})")
    out = torch.empty((nq, Nx, Ny), dtype=torch.float32, device=Yc.device)
    code = kernels.library().pfbt_pg_fold_gs(
        Yc.data_ptr(), tslot.data_ptr(), out.data_ptr(), nq, NT, Thx, Thy,
        txs, tys, ntx, nty, k, Nx, Ny, kernels.stream_ptr())
    kernels.check(code, "pg_fold_gs")
    pg_fold_gs.launches += 1
    return out


pg_fold_gs.launches = 0


# ---------------------------------------------------------------------
# K9: degrid of one block, accumulated


def pg_degrid_gs_plain(gr, gi, pos, utid, gmap, acc, *, woff, beta, k, B,
                       txs, tys, nty):
    """Plain K9: the mapped entries' (B, Thx, Thy) windows from their
    true start (indices mod the grid), the modulo-window contraction of
    the plain K6, added into ``acc`` rows ``gmap`` (distinct)."""
    g = gmap.long()
    vis = pg_degrid_plain(gr, gi, _block_view(pos, gmap, woff), utid[g],
                          beta=beta, k=k, nw=B, txs=txs, tys=tys, nty=nty,
                          do_w=True)
    return acc.index_add_(0, g, vis)


def pg_degrid_gs(gr, gi, pos, utid, gmap, acc, *, woff, beta, k, B, txs,
                 tys, nty):
    """K9: degrid one w block's mapped entries from its (B, Nx, Ny) grids
    and ADD them to the per-entry accumulator ``acc`` (NEg+1, 2, C) in
    place (returned). ``pos`` and ``utid`` (NEg,) are the global stream's
    positions and entry tiles, ``gmap`` the live prefix of the block's
    entry map, ``woff`` its first plane. CUDA float32 operands launch
    csrc/pg_degrid.cu, CPU operands run :func:`pg_degrid_gs_plain`."""
    kw = dict(woff=woff, beta=beta, k=k, B=B, txs=txs, tys=tys, nty=nty)
    NEg1, _, C = pos.shape
    Nx, Ny = gr.shape[-2:]
    if gr.shape != (B, Nx, Ny) or gi.shape != gr.shape or \
            acc.shape != (NEg1, 2, C) or utid.shape != (NEg1 - 1,):
        raise ValueError(f"pg_degrid_gs: grids {tuple(gr.shape)}, "
                         f"{tuple(gi.shape)}, acc {tuple(acc.shape)}, utid "
                         f"{tuple(utid.shape)} for B={B}, pos "
                         f"{tuple(pos.shape)}")
    if not gr.is_cuda:
        return pg_degrid_gs_plain(gr, gi, pos, utid, gmap, acc, **kw)
    kernels.require_cuda_f32("pg_degrid_gs", gr, gi, pos, acc)
    kernels.require_cuda_i32("pg_degrid_gs", utid, gmap)
    Thx, Thy = txs + k, tys + k
    if Nx < Thx or Ny < Thy:
        raise ValueError(f"pg_degrid_gs: grid ({Nx}, {Ny}) smaller than a "
                         f"tile window ({Thx}, {Thy})")
    code = kernels.library().pfbt_pg_degrid_gs(
        gr.data_ptr(), gi.data_ptr(), pos.data_ptr(), utid.data_ptr(),
        gmap.data_ptr(), acc.data_ptr(), gmap.numel(), C, B, Thx, Thy, txs,
        tys, nty, Nx, Ny, k, int(woff), float(beta), kernels.stream_ptr())
    kernels.check(code, "pg_degrid_gs")
    pg_degrid_gs.launches += 1
    return acc


pg_degrid_gs.launches = 0


# the lab's designs of the degrid (``csrc/lab_degrid.cu``)
DEGRID_DESIGNS = {"thread": 0, "taps": 1, "window": 2}
DEGRID_MODES = ("kernel", "factors", "loads", "sums")


def pg_degrid_lab(gr, gi, pos, tid, *, beta, k, nw, txs, tys, nty,
                  gmap=None, acc=None, woff=0, design="window",
                  mode="kernel"):
    """The degrid lab's entry (``csrc/lab_degrid.cu``, for
    scripts/torch_kernel_lab.py --degrid and the card tests): ``design``
    one of K6 / K9's three kernels (``csrc/pg_degrid.cu``): "window"
    where three of its blocks fit an SM, else "taps" at k = 7 (the only k
    it takes) and "thread", the earlier design and the others'
    reference, at other k; all three give the same bits. ``mode`` one
    of :data:`DEGRID_MODES`, the kernel or a skeleton that keeps one
    part (the factors, the grid loads, or the sums on register data; its
    output is not a degrid; the taps and the window take them at k = 7
    only). K9's operands
    where ``gmap`` is given (``tid`` the stream's entry tiles, ``woff``
    the block's first plane, ``acc`` the accumulator it adds to, in
    place: :func:`pg_degrid_gs`'s), else K6's (``pgridder.pg_degrid``'s,
    w factors when nw > 1). CUDA float32 operands launch the kernel; CPU
    operands run the plain degrid (the kernel mode only)."""
    NE1, _, C = pos.shape
    Nx, Ny = gr.shape[-2:]
    if design not in DEGRID_DESIGNS or mode not in DEGRID_MODES or \
            gr.shape != (nw, Nx, Ny) or gi.shape != gr.shape or \
            (gmap is None) != (acc is None) or \
            (acc is not None and acc.shape != (NE1, 2, C)):
        raise ValueError(f"pg_degrid_lab: design {design!r}, mode {mode!r},"
                         f" grids {tuple(gr.shape)}, {tuple(gi.shape)}, pos "
                         f"{tuple(pos.shape)}, nw={nw}")
    kw = dict(beta=beta, k=k, txs=txs, tys=tys, nty=nty)
    if not gr.is_cuda:
        if mode != "kernel":
            raise ValueError("pg_degrid_lab: a skeleton needs the card")
        if gmap is None:
            return pg_degrid_plain(gr, gi, pos, tid, nw=nw, **kw)
        return pg_degrid_gs_plain(gr, gi, pos, tid, gmap, acc, woff=woff,
                                  B=nw, **kw)
    kernels.require_cuda_f32("pg_degrid_lab", gr, gi, pos, acc)
    kernels.require_cuda_i32("pg_degrid_lab", tid,
                             *(() if gmap is None else (gmap,)))
    if gmap is None:
        acc = torch.empty((NE1, 2, C), dtype=torch.float32,
                          device=gr.device)
    code = kernels.library().pfbt_pg_degrid_lab(
        gr.data_ptr(), gi.data_ptr(), pos.data_ptr(), tid.data_ptr(),
        None if gmap is None else gmap.data_ptr(), acc.data_ptr(),
        NE1 if gmap is None else gmap.numel(), C, nw, txs + k, tys + k, txs,
        tys, nty, Nx, Ny, k, int(woff), float(beta), DEGRID_DESIGNS[design],
        DEGRID_MODES.index(mode), kernels.stream_ptr())
    kernels.check(code, "pg_degrid_lab")
    pg_degrid_lab.launches += 1
    return acc


pg_degrid_lab.launches = 0


# ---------------------------------------------------------------------
# operators


def _live_blocks(bp):
    """(b, live prefix of gmap[b], woff) for every block with entries."""
    for b in range(bp["nblocks"]):
        ne = int(bp["nelive"][b])
        if ne:
            yield b, bp["gmap"][b, :ne], int(bp["woff"][b, 0])


def _consts(bp):
    p0 = bp["p0"]
    return gi_consts(p0["nx"], p0["ny"], p0["cellx"], p0["celly"], p0["k"],
                     p0["beta"], p0["Nx"], p0["Ny"], True, float(bp["dw"]),
                     p0["x0"], p0["y0"], rdtype=p0["rdtype"],
                     device=bp["pos"].device)


def _weighted_vispack(bp, vr, vi, wflat):
    """Weight and centre-shift the components, then gather them into the
    global packed stream (NEg+1, 2, C), once per call."""
    p0 = bp["p0"]
    rdt = p0["rdtype"]
    vr, vi = vr.to(rdt), vi.to(rdt)
    if p0["x0"] or p0["y0"]:
        cs, sn = _shift_phases(bp["uvw_full"], bp["freq_d"], p0["x0"],
                               p0["y0"], rdt)
        vr, vi = vr * cs - vi * sn, vr * sn + vi * cs
    if wflat is not None:
        vr = vr * wflat
        vi = vi * wflat
    g = bp["gidx"].long()
    gpm = bp["gpm"]
    return torch.stack([vr.reshape(-1)[g] * gpm, vi.reshape(-1)[g] * gpm],
                       dim=1).contiguous()


def _adjoint_wblocked_impl(bp, vr, vi, wflat, consts=None):
    """Blocked adjoint: one gather into the stream, then per live block
    spread (K7), fold (K8) and the block's planes to the image."""
    p0 = bp["p0"]
    B, k = bp["B"], p0["k"]
    txs, tys = p0["txs"], p0["tys"]
    Thx, Thy = txs + k, tys + k
    if consts is None:
        consts = _consts(bp)
    vispack = _weighted_vispack(bp, vr, vi, wflat)
    img = torch.zeros((p0["nx"], p0["ny"]), dtype=p0["rdtype"],
                      device=vispack.device)
    for b, gmap, woff in _live_blocks(bp):
        Yc = pg_spread_gs(bp["pos"], vispack, gmap, bp["start"][b],
                          bp["count"][b], woff=woff, beta=p0["beta"], k=k,
                          B=B, Thx=Thx, Thy=Thy)
        folded = pg_fold_gs(Yc.reshape(2 * B, bp["NT"], Thx, Thy),
                            bp["tslot"][b], ntx=p0["ntx"], nty=p0["nty"],
                            txs=txs, tys=tys, k=k, Nx=p0["Nx"], Ny=p0["Ny"])
        del Yc
        img = img + _grid_to_image(
            folded[:B], folded[B:], p0["nx"], p0["ny"], p0["cellx"],
            p0["celly"], k, p0["beta"], p0["Nx"], p0["Ny"], True, B,
            float(bp["w0s"][b]), float(bp["dw"]), False, p0["x0"], p0["y0"],
            consts=consts)
    return img


def _forward_wblocked_impl(bp, image, consts=None):
    """Blocked forward: per live block the image's B plane grids and K9
    into one per-entry accumulator, then one scatter back to (nrow,
    nchan) (each visibility sits in one slot; pad slots add exact
    zeros, so ``index_add_`` is deterministic here)."""
    p0 = bp["p0"]
    B, k, C = bp["B"], p0["k"], p0["C"]
    rdt = p0["rdtype"]
    image = image.to(rdt)
    if consts is None:
        consts = _consts(bp)
    acc = torch.zeros((bp["NEg"] + 1, 2, C), dtype=rdt, device=image.device)
    for b, gmap, woff in _live_blocks(bp):
        gr, gi = _image_to_grid(
            image, p0["nx"], p0["ny"], p0["cellx"], p0["celly"], k,
            p0["beta"], p0["Nx"], p0["Ny"], True, B, float(bp["w0s"][b]),
            float(bp["dw"]), False, p0["x0"], p0["y0"], consts=consts)
        pg_degrid_gs(gr.contiguous(), gi.contiguous(), bp["pos"],
                     bp["utid"], gmap, acc, woff=woff, beta=p0["beta"], k=k,
                     B=B, txs=p0["txs"], tys=p0["tys"], nty=p0["nty"])
        del gr, gi
    nvis = bp["nrow"] * bp["nchan"]
    g = bp["gidx"].long().reshape(-1)
    gpm = bp["gpm"]
    fr = torch.zeros(nvis, dtype=rdt, device=acc.device).index_add_(
        0, g, (acc[:, 0] * gpm).reshape(-1))
    fi = torch.zeros(nvis, dtype=rdt, device=acc.device).index_add_(
        0, g, (acc[:, 1] * gpm).reshape(-1))
    fr = fr.reshape(bp["nrow"], bp["nchan"])
    fi = fi.reshape(bp["nrow"], bp["nchan"])
    if p0["x0"] or p0["y0"]:
        cs, sn = _shift_phases(bp["uvw_full"], bp["freq_d"], p0["x0"],
                               p0["y0"], fr.dtype)
        fr, fi = fr * cs + fi * sn, fi * cs - fr * sn
    return fr, fi


def make_adjoint_pg_wblocked(bp, wgt=None, mask=None):
    """R.H through the blocked plan: (vr, vi) (nrow, nchan) -> (nx, ny)
    image, weighted by wgt * mask, on the plan's device."""
    p0 = bp["p0"]
    dev = bp["pos"].device
    w = _weights(wgt, mask, p0["rdtype"], dev)
    consts = _consts(bp)

    def adjoint(vr, vi):
        return _adjoint_wblocked_impl(bp, vr.to(dev), vi.to(dev), w,
                                      consts=consts)

    return adjoint


def make_hessian_pg_wblocked(bp, wgt=None, mask=None):
    """R.H W R through the blocked plan: x (nx, ny) -> (nx, ny), grid
    memory bounded at O(B x padded grid), on the plan's device."""
    p0 = bp["p0"]
    dev = bp["pos"].device
    w = _weights(wgt, mask, p0["rdtype"], dev)
    consts = _consts(bp)

    def matvec(x):
        fr, fi = _forward_wblocked_impl(bp, x.to(dev), consts=consts)
        return _adjoint_wblocked_impl(bp, fr, fi, w, consts=consts)

    matvec.plans = [bp]
    return matvec


# ---------------------------------------------------------------------
# stacked (one shared geometry for the datasets of a band-sharded cube)


def stack_pg_plans_wblocked(dds, *, nx, ny, epsilon=1e-7, plane_block=8,
                            use_beam=True, mask_image=None, capacity=None,
                            bands=None, device=None, dtype=None):
    """Per-dataset blocked plans with one shared geometry (counterpart of
    the JAX package's stack_pg_plans_wblocked): the union w grid, one
    tile choice from all datasets' rows and one capacity (256 from 2^22
    visibilities of the row-bucketed largest dataset, else 128).
    ``bands`` limits the plans to those band ids (a band shard's).
    Returns dict(items=[(bandid, plan, weights, beam or None)])."""
    from pfb_tpu_torch.ops.gridder import row_bucket

    device = as_device(device)
    R = row_bucket(max(ds["UVW"].shape[0] for ds in dds))
    nchan = max(ds["FREQ"].shape[0] for ds in dds)
    if capacity is None:
        capacity = 256 if R * nchan >= (1 << 22) else 128
    cell = float(dds[0]["cell_rad"])
    x0 = float(dds[0].get("x0", 0.0))
    y0 = float(dds[0].get("y0", 0.0))
    for ds in dds:
        if float(ds["cell_rad"]) != cell or \
                float(ds.get("x0", 0.0)) != x0 or \
                float(ds.get("y0", 0.0)) != y0:
            raise ValueError("stack_pg_plans_wblocked: mixed cell sizes or "
                             "phase centres")
    k, _ = kernel_params(epsilon)
    wp = w_geometry_union([(ds["UVW"], ds["FREQ"]) for ds in dds], nx, ny,
                          cell, cell, x0, y0, 2.0, k, True)
    all_uvw = np.concatenate([_np(ds["UVW"]) for ds in dds])
    tu = tv = None
    if all_uvw.shape[0] * nchan >= (1 << 18):
        Nx_, Ny_ = _grid_setup(nx, ny, cell, cell, 2.0)
        tu, tv = _auto_tiles(all_uvw, _np(dds[0]["FREQ"]), Nx_, Ny_, cell,
                             cell, k, capacity)
    has_beam = use_beam and any("BEAM" in ds for ds in dds)
    items = []
    for ds in dds:
        if bands is not None and int(ds["bandid"]) not in bands:
            continue
        bp = pgrid_plan_wblocked(
            ds["UVW"], ds["FREQ"], nx=nx, ny=ny, cellx=cell, celly=cell,
            epsilon=epsilon, capacity=capacity, x0=x0, y0=y0,
            plane_block=plane_block, w_params=wp, tile_u=tu, tile_v=tv,
            device=device, dtype=dtype)
        rdt = bp["p0"]["rdtype"]
        w = _weights(_np(ds["WEIGHT"]) * _np(ds["MASK"]), None, rdt, device)
        beam = None
        if has_beam or mask_image is not None:
            beam = torch.as_tensor(_ds_beam_image(
                ds, nx, ny, use_beam, mask_image)).to(device=device,
                                                      dtype=rdt)
        items.append((int(ds["bandid"]), bp, w, beam))
    return dict(items=items)


def _hessian_pg_cube_local_wblocked(x, items, consts, band0=0):
    """sum_d beam R.H W R (beam x) per band of the (nbl, nx, ny) block x
    holding bands band0.., through the blocked plans of
    :func:`stack_pg_plans_wblocked` (others are skipped), one dataset at
    a time; not divided by wsum. ``consts`` from one of the plans (the
    geometry is shared)."""
    conv = [torch.zeros_like(x[0]) for _ in range(x.shape[0])]
    for b, bp, w, beam in items:
        j = b - band0
        if not 0 <= j < x.shape[0]:
            continue
        xin = x[j] * beam if beam is not None else x[j]
        fr, fi = _forward_wblocked_impl(bp, xin, consts=consts)
        c = _adjoint_wblocked_impl(bp, fr, fi, w, consts=consts)
        del fr, fi
        conv[j] = conv[j] + (c * beam if beam is not None else c)
    return torch.stack(conv)
