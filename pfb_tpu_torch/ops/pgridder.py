"""The pg gridder: ES-kernel w-stacking (de)gridding over uv tiles
(counterpart of pfb_tpu/ops/pgridder.py).

Visibilities are binned per uv tile on the host (:func:`pgrid_plan`,
the same plan format as the JAX package, built by the native builder or
its numpy twin). The adjoint spreads each live tile's entries onto the
tile's halo'd (2, nw, Thx, Thy) block (K4, :func:`pg_spread`), folds the
blocks into the periodic (2 nw, Nx, Ny) grids (K5, :func:`pg_fold`) and
transforms the w planes to the image (ops/wgridder.py, K3 on the card).
The forward transforms the image to the w-plane grids and gathers each
visibility's support from them (K6, :func:`pg_degrid`).

Each of K4, K5 and K6 is a wrapper: a CUDA float32 operand launches the
hand-written kernel (``csrc/pg_grid.cu``, ``pg_fold.cu``,
``pg_degrid.cu``); a CPU operand runs the plain PyTorch version beside
it (``*_plain``), which the CPU tests hold against the JAX package's
Pallas kernels in interpret mode.

The w-plane-blocked engine (``plane_block``, kernels K7-K9) is
ops/pg_stream.py; the row-distributed adjoint is
parallel/dist.py:make_vis2dirty_rowdist on :func:`_spread_fold_from_plan`
and :func:`_grid_to_image_from_plan`.

While a torch profiler runs (utils/profiling.py): device spans
``pg.spread_fold`` (K4, K5), ``pg.wplanes`` (the w screens and plane
transforms, both ways) and ``pg.degrid`` (K6) in the from-plan
functions; ``pg.plan.host`` (geometry, tiles, the binning) and
``pg.plan.upload`` (the plan's copies to the device) where plans are
built; ``pg.applications``, one a stacked Hessian application; and
the blocking copies: ``sync.pg.colour_perm`` (the slots' colour
permutation, each spread), ``sync.pg.phasor`` (ops/wgridder.py, each
w-plane pass) and ``sync.pg.plan_upload`` (each plan array).
"""

import numpy as np
import torch

from pfb_tpu_torch import kernels
from pfb_tpu_torch.config import as_device, kernel_dtype
from pfb_tpu_torch.native import pg_plan_native
from pfb_tpu_torch.ops.dft import LIGHTSPEED
from pfb_tpu_torch.ops.mmgridder import (_bin_to_tiles, _pad_tiles,
                                         _tile_geometry)
from pfb_tpu_torch.ops.wgridder import (_grid_setup, _grid_to_image,
                                        _image_to_grid, _nm1_min, _w_params,
                                        es_kernel, gi_consts,
                                        kernel_params)
from pfb_tpu_torch.utils import profiling

# elements of the largest temporary of a plain version's chunk
_PLAIN_CHUNK = 1 << 24


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def w_geometry(uvw, freq, nx, ny, cellx, celly, x0, y0, sigma, k,
               do_wgridding):
    """(nw, w0, dw) w-plane geometry of an observation."""
    if not do_wgridding:
        return 1, 0.0, 1.0
    return _w_params(_np(uvw), _np(freq),
                     _nm1_min(nx, ny, cellx, celly, x0, y0), sigma, k)


def _pg_plan_numpy(uvw_np, freq_np, Nx, Ny, cellx, celly, txs, tys,
                   ntx, nty, w0, dw, nw, C, k):
    """Pure-numpy plan binning/packing (the twin of native/plan.cc; same
    outputs bit for bit)."""
    scale = freq_np / LIGHTSPEED
    ug = (uvw_np[:, 0:1] * scale[None, :]) * cellx * Nx
    vg = (uvw_np[:, 1:2] * scale[None, :]) * celly * Ny
    wl = uvw_np[:, 2:3] * scale[None, :]
    wpos = ((wl - w0) / dw).ravel() if nw > 1 else np.zeros(ug.size)

    ugf, vgf = ug.ravel(), vg.ravel()
    order, tids, _, _ = _bin_to_tiles(
        ugf, vgf, np.zeros(ugf.size, np.int64), txs, tys, Nx, Ny, 1)
    (pu, pv, pw), utid, idx, pmask, _ = _pad_tiles(order, tids,
                                                   [ugf, vgf, wpos], C)

    # one all-padding entry for every uv tile with no visibilities
    # (u = -2k keeps its factors identically zero)
    ntiles = ntx * nty
    missing = np.setdiff1d(np.arange(ntiles), utid)
    if missing.size:
        nm = missing.size
        pu = np.concatenate([pu, np.full((nm, C), -2.0 * k)])
        pv = np.concatenate([pv, np.full((nm, C), -2.0 * k)])
        pw = np.concatenate([pw, np.zeros((nm, C))])
        idx = np.concatenate([idx, np.zeros((nm, C), idx.dtype)])
        pmask = np.concatenate([pmask, np.zeros((nm, C), bool)])
        utid = np.concatenate([utid, missing])
        order2 = np.argsort(utid, kind="stable")
        pu, pv, pw = pu[order2], pv[order2], pw[order2]
        idx, pmask, utid = idx[order2], pmask[order2], utid[order2]

    nentries = utid.size
    ty = utid % nty
    tx = utid // nty
    h = k // 2
    pu_loc = np.mod(pu, Nx) - (tx * txs)[:, None] + h
    pv_loc = np.mod(pv, Ny) - (ty * tys)[:, None] + h
    # unwrap coordinates that the mod moved by one period
    pu_loc = np.where(pu_loc < 0, pu_loc + Nx, pu_loc)
    pu_loc = np.where(pu_loc > txs + k, pu_loc - Nx, pu_loc)
    pv_loc = np.where(pv_loc < 0, pv_loc + Ny, pv_loc)
    pv_loc = np.where(pv_loc > tys + k, pv_loc - Ny, pv_loc)

    # (nentries, 8, C): rows 0-2 tile-local u, v and fractional w plane;
    # rows 3-4 the same relative to the (8, 128)-aligned window start
    # and rows 5-6 that start (the JAX package's degrid windows; the
    # port's kernels read rows 0-2 only); row 7 is padding
    sx = np.mod(tx * txs - h, Nx)
    sy = np.mod(ty * tys - h, Ny)
    ax, ay = (sx // 8) * 8, (sy // 128) * 128
    pos = np.zeros((nentries, 8, C), np.float64)
    pos[:, 0] = pu_loc
    pos[:, 1] = pv_loc
    pos[:, 2] = pw
    pos[:, 3] = pu_loc + (sx - ax)[:, None]
    pos[:, 4] = pv_loc + (sy - ay)[:, None]
    pos[:, 5] = ax[:, None]
    pos[:, 6] = ay[:, None]
    return pos, utid, idx, pmask, nentries


def _auto_tiles(uvw_np, freq_np, Nx, Ny, cellx, celly, k, C):
    """(tile_u, tile_v) from a small ladder by the JAX package's cost
    model: entries x (3.2 + 1e-4 x halo'd tile elements). Sparse
    coverage prefers bigger tiles; dense coverage keeps the default."""
    scale = freq_np / LIGHTSPEED
    ug = np.mod(np.round((uvw_np[:, 0:1] * scale[None, :]) * cellx
                         * Nx).ravel().astype(np.int64), Nx)
    vg = np.mod(np.round((uvw_np[:, 1:2] * scale[None, :]) * celly
                         * Ny).ravel().astype(np.int64), Ny)
    txs0, tys0 = _tile_geometry(Nx, Ny, k, None, None)
    best = None
    for dtx, dty in ((0, 0), (16, 0), (16, 128), (48, 128)):
        txs, tys = txs0 + dtx, tys0 + dty
        if txs > Nx or tys > Ny:
            continue
        nty = -(-Ny // tys)
        tid = (ug // txs) * nty + vg // tys
        cnt = np.bincount(tid)
        cnt = cnt[cnt > 0]
        entries = int(np.ceil(cnt / C).sum())
        cost = entries * (3.2 + 1e-4 * ((txs + k) * (tys + k)))
        if best is None or cost < best[0]:
            best = (cost, txs, tys)
    return best[1], best[2]


def pgrid_plan(uvw, freq, *, nx, ny, cellx, celly, epsilon=1e-7,
               do_wgridding=True, sigma=2.0, capacity=128, tile_u=None,
               tile_v=None, dtype=None, x0=0.0, y0=0.0, w_params=None,
               nentries_to=None, device=None):
    """Reusable plan: geometry + per-uv-tile binning of the (row, chan)
    visibilities into capacity-C entries, the JAX package's format.
    ``w_params=(nw, w0, dw)`` overrides the w-plane geometry;
    ``nentries_to`` pads the entry stream with no-op entries. Arrays go
    to ``device`` (None: the card when there is one): pos and pm in
    ``dtype`` (float32 on CUDA, float64 on the CPU by default), tid and
    idx as int32, uvw and freq (for the centre shift) in float64."""
    with profiling.span("pg.plan.host"):
        k, beta = kernel_params(epsilon)
        Nx, Ny = _grid_setup(nx, ny, cellx, celly, sigma)
        uvw_np = _np(uvw).astype(np.float64)
        freq_np = _np(freq).astype(np.float64)
        device = as_device(device)
        if dtype is None:
            dtype = kernel_dtype(device, torch.float64)

        if w_params is not None:
            nw, w0, dw = w_params
        else:
            nw, w0, dw = w_geometry(uvw_np, freq_np, nx, ny, cellx, celly,
                                    x0, y0, sigma, k, do_wgridding)
        if tile_u is None and tile_v is None and \
                uvw_np.shape[0] * freq_np.shape[0] >= (1 << 18):
            tile_u, tile_v = _auto_tiles(uvw_np, freq_np, Nx, Ny, cellx,
                                         celly, k, capacity)
        txs, tys = _tile_geometry(Nx, Ny, k, tile_u, tile_v)
        ntx = -(-Nx // txs)
        nty = -(-Ny // tys)
        C = capacity

        nat = pg_plan_native(uvw_np, freq_np, Nx=Nx, Ny=Ny, cellx=cellx,
                             celly=celly, txs=txs, tys=tys, ntx=ntx, nty=nty,
                             w0=w0, dw=dw, nw=nw, C=C, k=k)
        if nat is not None:
            pos, utid, idx, pmask = nat
        else:
            pos, utid, idx, pmask, _ = _pg_plan_numpy(
                uvw_np, freq_np, Nx, Ny, cellx, celly, txs, tys, ntx, nty, w0,
                dw, nw, C, k)

        # drop the all-padding entries of empty uv tiles
        live = pmask.any(axis=1)
        if not live.any():
            live[0] = True  # keep one entry so shapes stay non-empty
        if not live.all():
            pos, utid = pos[live], utid[live]
            idx, pmask = idx[live], pmask[live]
        nentries = utid.size

        if nentries_to is not None:
            if nentries_to < nentries:
                raise ValueError(
                    f"nentries_to={nentries_to} < nentries={nentries}")
            npe = nentries_to - nentries
            if npe:
                # no-op entries: the last entry's tile, coordinates at -2k
                # (identically zero factors), zero mask
                pade = np.repeat(pos[-1:], npe, axis=0)
                pade[:, 0:2] = -2.0 * k
                pade[:, 3:5] = -2.0 * k
                pos = np.concatenate([pos, pade])
                utid = np.concatenate([utid, np.full(npe, utid[-1])])
                idx = np.concatenate([idx, np.zeros((npe, C), idx.dtype)])
                pmask = np.concatenate([pmask, np.zeros((npe, C), bool)])
                nentries = nentries_to

    with profiling.span("pg.plan.upload"):
        def dev(a, dt):
            profiling.count("sync.pg.plan_upload")
            return torch.as_tensor(np.ascontiguousarray(a)).to(device=device,
                                                               dtype=dt)

        return dict(
            k=k, beta=float(beta), Nx=Nx, Ny=Ny, nw=nw, w0=w0, dw=dw,
            ntx=ntx, nty=nty, txs=txs, tys=tys, C=C, nentries=nentries,
            rdtype=dtype, nx=nx, ny=ny, cellx=cellx, celly=celly, x0=x0,
            y0=y0, nrow=uvw_np.shape[0], nchan=freq_np.shape[0],
            pos=dev(pos, dtype), tid=dev(utid, torch.int32),
            idx=dev(idx, torch.int32), pm=dev(pmask, dtype),
            uvw_d=dev(uvw_np, torch.float64),
            freq_d=dev(freq_np, torch.float64))


def plan_from_jax(plan, device=None, dtype=None):
    """The port's plan from a JAX ``pgrid_plan`` dict (arrays as numpy
    or JAX arrays), so that both packages run on the same binning."""
    device = as_device(device)
    if dtype is None:
        dtype = torch.float64 if np.dtype(plan["rdtype"]) == np.float64 \
            else torch.float32
    out = {key: plan[key] for key in (
        "k", "beta", "Nx", "Ny", "nw", "w0", "dw", "ntx", "nty", "txs",
        "tys", "C", "nentries", "nx", "ny", "cellx", "celly", "x0", "y0",
        "nrow", "nchan")}
    out["rdtype"] = dtype
    for key, dt in (("pos", dtype), ("tid", torch.int32),
                    ("idx", torch.int32), ("pm", dtype),
                    ("uvw_d", torch.float64), ("freq_d", torch.float64)):
        out[key] = torch.as_tensor(np.array(plan[key])).to(device=device,
                                                             dtype=dt)
    return out


# ---------------------------------------------------------------------
# compact tile slots


def _fold_geom(Thx, Thy, txs, tys):
    """The JAX package's colour strides (Sx, Sy): tiles of one colour
    have pairwise-disjoint fold windows there. The port keeps its
    colour-major slot order so both packages lay out the same blocks."""
    EX = -(-(Thx + 8) // 8) * 8
    EY = -(-(Thy + 128) // 128) * 128
    Sx = max(1, -(-(EX + 7) // txs))
    Sy = max(1, -(-(EY + 127) // tys))
    return Sx, Sy


def _colour_perm(ntx, nty, txs, tys, k):
    Sx, Sy = _fold_geom(txs + k, tys + k, txs, tys)
    tt = np.arange(ntx * nty)
    col = (tt // nty % Sx) * Sy + (tt % nty % Sy)
    return np.lexsort((tt, col))


def _compact_slots(tid, pm, ntx, nty, txs, tys, k):
    """Compact slots of the live uv tiles, in colour-major order, from a
    plan's sorted tile ids and mask (on their device, no host sync).
    Returns a dict: ``NS`` slots (min(entries, tiles)); per entry its
    slot (``ent_slot``, NS for an entry of a tile with no live entry);
    per slot its tile, whether it is live and its entry range
    (``start``, ``count``; a tile's entries are consecutive in the plan);
    per tile its slot (``tslot``, -1 when not live)."""
    dev = tid.device
    ntiles = ntx * nty
    NE = tid.shape[0]
    NS = min(NE, ntiles)
    tidl = tid.long()
    lv = (pm != 0).any(dim=1).long()
    tval = torch.zeros(ntiles, dtype=torch.long, device=dev).scatter_reduce(
        0, tidl, lv, "amax")
    profiling.count("sync.pg.colour_perm")
    perm = torch.as_tensor(_colour_perm(ntx, nty, txs, tys, k), device=dev)
    tp = tval[perm]
    rank = torch.empty(ntiles, dtype=torch.long, device=dev).scatter_(
        0, perm, torch.cumsum(tp, 0) - tp)
    tslot = torch.where(tval > 0, rank, -1)
    ent_slot = torch.where(tval[tidl] > 0, rank[tidl], NS)
    ar = torch.arange(NE, device=dev)
    start = torch.full((NS + 1,), NE, dtype=torch.long,
                       device=dev).scatter_reduce(0, ent_slot, ar, "amin")
    count = torch.zeros(NS + 1, dtype=torch.long, device=dev).scatter_add(
        0, ent_slot, torch.ones_like(ar))
    tile = torch.zeros(NS + 1, dtype=torch.long, device=dev).scatter(
        0, ent_slot, tidl)
    return dict(NS=NS, ent_slot=ent_slot, tile=tile[:NS],
                live=count[:NS] > 0,
                start=start[:NS].to(torch.int32).contiguous(),
                count=count[:NS].to(torch.int32).contiguous(),
                tslot=tslot.to(torch.int32).contiguous())


# ---------------------------------------------------------------------
# K4: spread


def _factors(pos, lo, hi, beta, k, nw, Thx, Thy, do_w=None):
    """Dense ES factors of entries [lo, hi): CU (E, Thx, C), CV (E, C,
    Thy), CW (E, nw, C) from pos rows 0-2. The argument is scaled by
    1/(k/2), as XLA evaluates the JAX package's division by k/2; it
    decides the taps at exactly k/2 (the lowest visibility w sits at
    exactly k/2 planes from the first plane). The w factors are ones
    unless ``do_w`` (default: nw > 1)."""
    rkh = 1.0 / (k / 2.0)
    p = pos[lo:hi]
    dt, dev = pos.dtype, pos.device
    u, v, wf = p[:, 0], p[:, 1], p[:, 2]
    xs = torch.arange(Thx, dtype=dt, device=dev)
    ys = torch.arange(Thy, dtype=dt, device=dev)
    CU = es_kernel((xs[None, :, None] - u[:, None, :]) * rkh, beta, k)
    CV = es_kernel((ys[None, None, :] - v[:, :, None]) * rkh, beta, k)
    if do_w is None:
        do_w = nw > 1
    if do_w:
        ps = torch.arange(nw, dtype=dt, device=dev)
        CW = es_kernel((ps[None, :, None] - wf[:, None, :]) * rkh, beta, k)
    else:
        CW = torch.ones((hi - lo, 1, p.shape[-1]), dtype=dt, device=dev)
    return CU, CV, CW


def pg_spread_plain(pos, vis, slots, *, beta, k, nw, Thx, Thy, do_w=None):
    """Plain K4: per entry the dense product A @ CVv with A[(p, x), c] =
    CW[p, c] CU[x, c] and CVv = [CV v_r, CV v_i] (the TPU kernel's
    formulation), then a segment sum over the compact slots. Returns
    (2, nw, NS, Thx, Thy)."""
    NE, _, C = pos.shape
    NS = slots["NS"]
    out = torch.zeros((2, nw, NS + 1, Thx, Thy), dtype=pos.dtype,
                      device=pos.device)
    step = max(1, _PLAIN_CHUNK // (nw * Thx * 2 * Thy))
    for lo in range(0, NE, step):
        hi = min(lo + step, NE)
        CU, CV, CW = _factors(pos, lo, hi, beta, k, nw, Thx, Thy, do_w)
        A = (CW[:, :, None, :] * CU[:, None, :, :]).reshape(
            hi - lo, nw * Thx, C)
        vr, vi = vis[lo:hi, 0], vis[lo:hi, 1]
        CVv = torch.cat([CV * vr[:, :, None], CV * vi[:, :, None]], dim=-1)
        res = torch.bmm(A, CVv).reshape(hi - lo, nw, Thx, 2, Thy)
        out.index_add_(2, slots["ent_slot"][lo:hi],
                       res.permute(3, 1, 0, 2, 4))
    return out[:, :, :NS]


def pg_spread(pos, vis, slots, *, beta, k, nw, Thx, Thy):
    """K4: spread the entries of every compact slot onto its halo'd
    (2, nw, Thx, Thy) block; (NE, 8, C) positions, (NE, 2, C) weighted
    visibilities -> (2, nw, NS, Thx, Thy). Only live slots
    (``slots["live"]``) hold a result; the kernel leaves the others
    unwritten. CUDA float32 operands launch csrc/pg_grid.cu, CPU
    operands run :func:`pg_spread_plain`."""
    NE, _, C = pos.shape
    if vis.shape != (NE, 2, C):
        raise ValueError(f"pg_spread: vis {tuple(vis.shape)} for pos "
                         f"{tuple(pos.shape)}")
    if not pos.is_cuda:
        return pg_spread_plain(pos, vis, slots, beta=beta, k=k, nw=nw,
                               Thx=Thx, Thy=Thy)
    kernels.require_cuda_f32("pg_spread", pos, vis)
    kernels.require_cuda_i32("pg_spread", slots["start"], slots["count"])
    NS = slots["NS"]
    out = torch.empty((2, nw, NS, Thx, Thy), dtype=torch.float32,
                      device=pos.device)
    code = kernels.library().pfbt_pg_spread(
        pos.data_ptr(), vis.data_ptr(), slots["start"].data_ptr(),
        slots["count"].data_ptr(), out.data_ptr(), C, NS, nw, Thx, Thy, k,
        float(beta), kernels.stream_ptr())
    kernels.check(code, "pg_spread")
    pg_spread.launches += 1
    return out


pg_spread.launches = 0


def pack_entries(pos, vis, tid, pm, P, *, ntx, nty, txs, tys, k):
    """The paired-entry probe's operands (scripts/wl_g2i_lab.py:
    pair_ilp_probe, scripts/wl_capacity_ab.py:probe): the first E - E mod
    P entries, each run of P consecutive entries concatenated along the
    visibility axis, (E/P, 8, P C) positions and (E/P, 2, P C)
    visibilities, the run's first tile id and the compact slots of those
    ids. :func:`pg_spread` on them runs K4 unchanged at capacity P C, and
    every packed step lands on its first entry's tile, as on the TPU: a
    run that straddles two tiles gives a wrong grid (the probe times the
    kernel; P = 1 is the plan itself). Returns dict(pos, vis, tid, pm,
    slots)."""
    NE, _, C = pos.shape
    E = NE - NE % P
    if E == 0:
        raise ValueError(f"pack_entries: {NE} entries for P={P}")

    def cat(a):
        rows = a.shape[1]
        return a[:E].reshape(E // P, P, rows, C).transpose(1, 2).reshape(
            E // P, rows, P * C).contiguous()

    tidp = tid[:E:P].contiguous()
    pmp = pm[:E].reshape(E // P, P * C)
    return dict(pos=cat(pos), vis=cat(vis), tid=tidp, pm=pmp,
                slots=_compact_slots(tidp, pmp, ntx, nty, txs, tys, k))


# ---------------------------------------------------------------------
# K5: fold


def pg_fold_plain(Yc, slots, *, nty, txs, tys, k, Nx, Ny):
    """Plain K5: ``index_add_`` of every live slot's block at its
    periodic grid positions. (nq, NS, Thx, Thy) -> (nq, Nx, Ny)."""
    nq, NS, Thx, Thy = Yc.shape
    dev = Yc.device
    h = k // 2
    tile = slots["tile"]
    X = torch.remainder(((tile // nty) * txs - h)[:, None]
                        + torch.arange(Thx, device=dev), Nx)
    Y = torch.remainder(((tile % nty) * tys - h)[:, None]
                        + torch.arange(Thy, device=dev), Ny)
    flat = (X[:, :, None] * Ny + Y[:, None, :]).reshape(-1)
    out = torch.zeros((nq, Nx * Ny), dtype=Yc.dtype, device=dev)
    live = slots["live"][:, None, None]
    for q in range(nq):
        src = torch.where(live, Yc[q], torch.zeros((), dtype=Yc.dtype,
                                                   device=dev))
        out[q].index_add_(0, flat, src.reshape(-1))
    return out.reshape(nq, Nx, Ny)


def fold_covers(N, ntile, ts, Th, h, device=None):
    """The four (tile, offset) candidates of every grid coordinate X along
    one axis in K5's gather (``csrc/pg_fold.cu:fold_covers``): with u = (X
    + h) mod N and e = u + m N (m = 0, 1), tiles floor(e / ts) and
    floor(e / ts) - 1, in that order, offset e - t ts; valid where the
    tile exists (ntile of step ts) and its block of Th holds e. Returns
    (t, i, ok), each (4, N)."""
    u = (torch.arange(N, device=device) + h) % N
    cand = []
    for m in (0, 1):
        e = u + m * N
        for t in (e // ts, e // ts - 1):
            i = e - t * ts
            cand.append((t, i, (t >= 0) & (t < ntile) & (i < Th)))
    return tuple(torch.stack(c) for c in zip(*cand))


def pg_fold_gather_plain(Yc, tslot, *, ntx, nty, txs, tys, k, Nx, Ny):
    """K5's gather as torch operations, in Yc's type: every grid point
    adds the live blocks' elements of its candidate pairs
    (:func:`fold_covers` along x, then along y, in the kernel's order)
    onto zeros; ``tslot`` (ntx * nty,) maps a tile to its slot, -1 when
    it is not live. (nq, NS, Thx, Thy) -> (nq, Nx, Ny)."""
    nq, _, Thx, Thy = Yc.shape
    dev = Yc.device
    tx, ox, vx = fold_covers(Nx, ntx, txs, Thx, k // 2, dev)
    ty, oy, vy = fold_covers(Ny, nty, tys, Thy, k // 2, dev)
    ts = tslot.to(device=dev, dtype=torch.long)
    out = Yc.new_zeros((nq, Nx, Ny))
    for a in range(4):
        xa = tx[a].clamp(0, ntx - 1)[:, None] * nty
        for b in range(4):
            s = ts[xa + ty[b].clamp(0, nty - 1)[None, :]]
            ok = vx[a][:, None] & vy[b][None, :] & (s >= 0)
            if ok.any():
                g = Yc[:, s.clamp(min=0), ox[a].clamp(0, Thx - 1)[:, None],
                       oy[b].clamp(0, Thy - 1)[None, :]]
                out = torch.where(ok, out + g, out)
    return out


def pg_fold(Yc, slots, *, ntx, nty, txs, tys, k, Nx, Ny):
    """K5: overlap-add the live slots' halo'd blocks (nq, NS, Thx, Thy)
    into the periodic (nq, Nx, Ny) grids. CUDA float32 operands launch
    csrc/pg_fold.cu, CPU operands run :func:`pg_fold_plain`."""
    if not Yc.is_cuda:
        return pg_fold_plain(Yc, slots, nty=nty, txs=txs, tys=tys, k=k,
                             Nx=Nx, Ny=Ny)
    kernels.require_cuda_f32("pg_fold", Yc)
    kernels.require_cuda_i32("pg_fold", slots["tslot"])
    nq, NS, Thx, Thy = Yc.shape
    if slots["tslot"].numel() != ntx * nty or NS != slots["NS"]:
        raise ValueError("pg_fold: slots do not match the tile geometry")
    if Nx < Thx or Ny < Thy:
        raise ValueError(f"pg_fold: grid ({Nx}, {Ny}) smaller than a "
                         f"tile block ({Thx}, {Thy})")
    out = torch.empty((nq, Nx, Ny), dtype=torch.float32, device=Yc.device)
    code = kernels.library().pfbt_pg_fold(
        Yc.data_ptr(), slots["tslot"].data_ptr(), out.data_ptr(), nq, NS,
        Thx, Thy, txs, tys, ntx, nty, k, Nx, Ny, kernels.stream_ptr())
    kernels.check(code, "pg_fold")
    pg_fold.launches += 1
    return out


pg_fold.launches = 0


# ---------------------------------------------------------------------
# K6: degrid


def pg_degrid_plain(gr, gi, pos, tid, *, beta, k, nw, txs, tys, nty,
                    do_w=None):
    """Plain K6, the JAX package's engine="xla" formulation: per entry
    the (nw, Thx, Thy) window from the true window start (indices modulo
    the grid), T[p, c, y] = sum_x CU[c, x] G[p, x, y], then
    V[c] = sum_p CW[p, c] sum_y T[p, c, y] CV[c, y]. -> (NE, 2, C)."""
    NE, _, C = pos.shape
    Nx, Ny = gr.shape[-2:]
    Thx, Thy = txs + k, tys + k
    h = k // 2
    dev = pos.device
    out = torch.empty((NE, 2, C), dtype=gr.dtype, device=dev)
    step = max(1, _PLAIN_CHUNK // (nw * C * Thy))
    ax = torch.arange(Thx, device=dev)
    ay = torch.arange(Thy, device=dev)
    for lo in range(0, NE, step):
        hi = min(lo + step, NE)
        t = tid[lo:hi].long()
        X = torch.remainder(((t // nty) * txs - h)[:, None] + ax, Nx)
        Y = torch.remainder(((t % nty) * tys - h)[:, None] + ay, Ny)
        CUT, CV, CW = _factors(pos, lo, hi, beta, k, nw, Thx, Thy, do_w)
        CU = CUT.transpose(1, 2)
        for comp, g in enumerate((gr, gi)):
            win = g[:, X[:, :, None], Y[:, None, :]]  # (nw, E, Thx, Thy)
            tr = torch.einsum("ecx,pexy->epcy", CU, win)
            f = (tr * CV[:, None]).sum(-1)  # (E, nw, C)
            out[lo:hi, comp] = (f * CW).sum(1)
    return out


def pg_degrid(gr, gi, pos, tid, *, beta, k, nw, txs, tys, nty):
    """K6: each visibility's support gathered from the (nw, Nx, Ny)
    w-plane grids, both components -> (NE, 2, C). CUDA float32 operands
    launch csrc/pg_degrid.cu, CPU operands run :func:`pg_degrid_plain`."""
    if not gr.is_cuda:
        return pg_degrid_plain(gr, gi, pos, tid, beta=beta, k=k, nw=nw,
                               txs=txs, tys=tys, nty=nty)
    kernels.require_cuda_f32("pg_degrid", gr, gi, pos)
    kernels.require_cuda_i32("pg_degrid", tid)
    NE, _, C = pos.shape
    Nx, Ny = gr.shape[-2:]
    if gr.shape != (nw, Nx, Ny) or gi.shape != gr.shape or \
            tid.shape != (NE,):
        raise ValueError(f"pg_degrid: grids {tuple(gr.shape)}, "
                         f"{tuple(gi.shape)}, tid {tuple(tid.shape)} for "
                         f"nw={nw}, {NE} entries")
    Thx, Thy = txs + k, tys + k
    if Nx < Thx or Ny < Thy:
        raise ValueError(f"pg_degrid: grid ({Nx}, {Ny}) smaller than a "
                         f"tile window ({Thx}, {Thy})")
    out = torch.empty((NE, 2, C), dtype=torch.float32, device=gr.device)
    code = kernels.library().pfbt_pg_degrid(
        gr.data_ptr(), gi.data_ptr(), pos.data_ptr(), tid.data_ptr(),
        out.data_ptr(), NE, C, nw, Thx, Thy, txs, tys, nty, Nx, Ny, k,
        float(beta), kernels.stream_ptr())
    kernels.check(code, "pg_degrid")
    pg_degrid.launches += 1
    return out


pg_degrid.launches = 0


# ---------------------------------------------------------------------
# adjoint and forward


def _shift_phases(uvw, freq, x0, y0, dtype):
    """cos/sin of the centre-shift phase per (row, chan), in ``dtype``.
    The phase is formed and reduced to one turn in float64 (the plans
    keep uvw and freq in float64): a centre a few fields away puts it
    thousands of turns out, past float32's resolution of a turn."""
    scale = freq.double() / LIGHTSPEED
    uvw = uvw.double()
    ph = (uvw[:, 0:1] * x0 + uvw[:, 1:2] * y0) * scale[None, :]
    ph = 2.0 * np.pi * (ph - torch.round(ph))
    return torch.cos(ph).to(dtype), torch.sin(ph).to(dtype)


def _spread_fold(vr, vi, wflat, tid, pos, idx, pm, uvw, freq, *, beta, k,
                 nw, ntx, nty, txs, tys, C, x0, y0, Nx, Ny):
    """Weight and shift the visibility components, pack them per tile
    entry, spread (K4) and fold (K5) -> the (2 nw, Nx, Ny) grids (real
    planes, then imaginary planes)."""
    Thx, Thy = txs + k, tys + k
    if x0 or y0:
        cs, sn = _shift_phases(uvw, freq, x0, y0, vr.dtype)
        vr, vi = vr * cs - vi * sn, vr * sn + vi * cs
    if wflat is not None:
        vr = vr * wflat
        vi = vi * wflat
    ix = idx.long()
    vr, vi = vr.reshape(-1), vi.reshape(-1)
    vispack = torch.stack([vr[ix] * pm, vi[ix] * pm], dim=1).contiguous()
    slots = _compact_slots(tid, pm, ntx, nty, txs, tys, k)
    Yc = pg_spread(pos, vispack, slots, beta=beta, k=k, nw=nw, Thx=Thx,
                   Thy=Thy)
    return pg_fold(Yc.reshape(2 * nw, slots["NS"], Thx, Thy), slots,
                   ntx=ntx, nty=nty, txs=txs, tys=tys, k=k, Nx=Nx, Ny=Ny)


def plan_consts(p):
    """The grid-correction constants of a plan's image geometry (shared
    by its adjoint and forward; compute once per plan family)."""
    nw = p["nw"]
    return gi_consts(p["nx"], p["ny"], p["cellx"], p["celly"], p["k"],
                     p["beta"], p["Nx"], p["Ny"], nw > 1, float(p["dw"]),
                     p["x0"], p["y0"], rdtype=p["rdtype"],
                     device=p["pos"].device)


def _spread_fold_from_plan(p, vr, vi, wflat):
    """Spread (K4) and fold (K5) of a plan's weighted components into the
    (2 nw, Nx, Ny) grids: the unit that the row-distributed adjoint sums
    over its shards (parallel/dist.py:make_vis2dirty_rowdist)."""
    with profiling.span("pg.spread_fold", device=p["pos"].device):
        return _spread_fold(
            vr, vi, wflat, p["tid"], p["pos"], p["idx"], p["pm"],
            p["uvw_d"], p["freq_d"], beta=p["beta"], k=p["k"], nw=p["nw"],
            ntx=p["ntx"], nty=p["nty"], txs=p["txs"], tys=p["tys"],
            C=p["C"], x0=p["x0"], y0=p["y0"], Nx=p["Nx"], Ny=p["Ny"])


def _grid_to_image_from_plan(p, folded, divide_by_n=False, consts=None):
    """The w planes of folded (2 nw, Nx, Ny) grids to the (nx, ny) image
    in the plan's geometry."""
    nw = p["nw"]
    with profiling.span("pg.wplanes", device=folded.device):
        return _grid_to_image(folded[:nw], folded[nw:], p["nx"], p["ny"],
                              p["cellx"], p["celly"], p["k"], p["beta"],
                              p["Nx"], p["Ny"], nw > 1, nw, float(p["w0"]),
                              float(p["dw"]), divide_by_n, p["x0"], p["y0"],
                              consts=consts)


def _adjoint_from_plan(p, vr, vi, wflat, consts=None, divide_by_n=False):
    """R.H of a plan: (nrow, nchan) components -> (nx, ny) image."""
    return _grid_to_image_from_plan(p, _spread_fold_from_plan(p, vr, vi,
                                                               wflat),
                                    divide_by_n=divide_by_n, consts=consts)


def _forward_from_plan(p, image, consts=None, divide_by_n=False):
    """R of a plan: (nx, ny) image -> (nrow, nchan) components (fr, fi),
    degridded by :func:`pg_degrid` (K6)."""
    nw, k = p["nw"], p["k"]
    with profiling.span("pg.wplanes", device=image.device):
        gr, gi = _image_to_grid(image, p["nx"], p["ny"], p["cellx"],
                                p["celly"], k, p["beta"], p["Nx"], p["Ny"],
                                nw > 1, nw, float(p["w0"]), float(p["dw"]),
                                divide_by_n, p["x0"], p["y0"], consts=consts)
    with profiling.span("pg.degrid", device=image.device):
        kw = dict(beta=p["beta"], k=k, nw=nw, txs=p["txs"], tys=p["tys"],
                  nty=p["nty"])
        out = pg_degrid(gr.contiguous(), gi.contiguous(), p["pos"],
                        p["tid"], **kw)
        del gr, gi
        nvis = int(p["nrow"]) * int(p["nchan"])
        ix = p["idx"].long().reshape(-1)
        pm = p["pm"]
        fr = torch.zeros(nvis, dtype=out.dtype,
                         device=out.device).index_add_(
            0, ix, (out[:, 0] * pm).reshape(-1))
        fi = torch.zeros(nvis, dtype=out.dtype,
                         device=out.device).index_add_(
            0, ix, (out[:, 1] * pm).reshape(-1))
        nchan = int(p["nchan"])
        fr, fi = fr.reshape(-1, nchan), fi.reshape(-1, nchan)
        if p["x0"] or p["y0"]:
            cs, sn = _shift_phases(p["uvw_d"], p["freq_d"], p["x0"],
                                   p["y0"], fr.dtype)
            fr, fi = fr * cs + fi * sn, fi * cs - fr * sn
    return fr, fi


def _weights(wgt, mask, rdtype, device):
    """wgt * mask (either may be None) as a tensor on the plan's
    device."""
    w = None
    for a in (wgt, mask):
        if a is not None:
            a = torch.as_tensor(a).to(device=device, dtype=rdtype)
            w = a if w is None else w * a
    return w


def vis2dirty_pg(uvw, freq, vis, wgt=None, mask=None, *, nx, ny, cellx,
                 celly, epsilon=1e-7, do_wgridding=True, sigma=2.0,
                 capacity=None, divide_by_n=False, plan=None, x0=0.0,
                 y0=0.0, **kw):
    """R.H through the pg gridder: visibilities (complex, or a (real,
    imag) pair) -> dirty image in the visibilities' real dtype. Pass
    plan=pgrid_plan(...) to reuse the binning."""
    if isinstance(vis, (tuple, list)):
        vr, vi = vis
    else:
        vr, vi = vis.real, vis.imag
    if plan is None:
        plan = pgrid_plan(uvw, freq, nx=nx, ny=ny, cellx=cellx,
                          celly=celly, epsilon=epsilon,
                          do_wgridding=do_wgridding, sigma=sigma,
                          capacity=capacity or 128, x0=x0, y0=y0,
                          dtype=vr.dtype, device=vr.device)
    p = plan
    dev = p["pos"].device
    vr = vr.to(device=dev, dtype=p["rdtype"])
    vi = vi.to(device=dev, dtype=p["rdtype"])
    w = _weights(wgt, mask, p["rdtype"], dev)
    return _adjoint_from_plan(p, vr, vi, w, divide_by_n=divide_by_n)


def dirty2vis_pg(uvw, freq, image, cellx, celly, *, epsilon=1e-7,
                 do_wgridding=True, sigma=2.0, capacity=None,
                 divide_by_n=False, plan=None, x0=0.0, y0=0.0, split=False,
                 **kw):
    """R through the pg gridder: image -> visibilities (complex, or a
    (real, imag) pair with ``split``)."""
    nx, ny = image.shape
    if plan is None:
        plan = pgrid_plan(uvw, freq, nx=nx, ny=ny, cellx=cellx,
                          celly=celly, epsilon=epsilon,
                          do_wgridding=do_wgridding, sigma=sigma,
                          capacity=capacity or 128, x0=x0, y0=y0,
                          dtype=image.dtype, device=image.device)
    p = plan
    img = image.to(device=p["pos"].device, dtype=p["rdtype"])
    fr, fi = _forward_from_plan(p, img, divide_by_n=divide_by_n)
    if split:
        return fr, fi
    return torch.complex(fr, fi)


# ---------------------------------------------------------------------
# Hessians


def make_hessian_pg(plan, wgt=None, mask=None):
    """R.H W R for one dataset through the pg gridder: x -> (nx, ny)
    vis2dirty(wgt * dirty2vis(x)), on the plan's device."""
    p = plan
    dev = p["pos"].device
    w = _weights(wgt, mask, p["rdtype"], dev)
    consts = plan_consts(p)

    def matvec(x):
        fr, fi = _forward_from_plan(p, x.to(device=dev, dtype=p["rdtype"]),
                                    consts=consts)
        return _adjoint_from_plan(p, fr, fi, w, consts=consts)

    matvec.plans = [p]
    return matvec


def w_geometry_union(dss, nx, ny, cellx, celly, x0, y0, sigma, k,
                     do_wgridding):
    """Shared (nw, w0, dw) covering every dataset's w range: the
    one-dataset geometry of the pooled signed-w extrema."""
    if not do_wgridding:
        return 1, 0.0, 1.0
    wmin, wmax = np.inf, -np.inf
    for uvw, freq in dss:
        ws = _np(uvw)[:, 2:3] * (_np(freq)[None, :] / LIGHTSPEED)
        wmin = min(wmin, ws.min())
        wmax = max(wmax, ws.max())
    uvw_syn = np.array([[0.0, 0.0, wmin], [0.0, 0.0, wmax]])
    return w_geometry(uvw_syn, np.array([LIGHTSPEED]), nx, ny, cellx,
                      celly, x0, y0, sigma, k, do_wgridding)


def _ds_beam_image(ds, nx, ny, use_beam, mask_image):
    """The beam times the mask image of one dataset, as numpy (ones where
    neither is given)."""
    bm = np.ones((nx, ny))
    if use_beam and "BEAM" in ds:
        bm = bm * _np(ds["BEAM"])
    if mask_image is not None:
        bm = bm * _np(mask_image)
    return bm


def stack_pg_plans(dds, *, nx, ny, epsilon=1e-7, do_wgridding=True,
                   use_beam=True, mask_image=None, capacity=128,
                   bands=None, device=None, dtype=None):
    """Per-dataset pg plans with one shared geometry: one w-plane grid
    (:func:`w_geometry_union`) and one tile choice from all datasets.
    Unlike the JAX package, rows and entry counts are not padded to a
    common bucket (that served XLA's compile cache). ``bands`` limits the
    plans to the datasets of those band ids (a band shard's), the
    geometry still coming from all of them. Returns dict(p0,
    items=[(bandid, plan, weights, beam or None)]); p0 is None when no
    dataset is planned."""
    device = as_device(device)
    cell = float(dds[0]["cell_rad"])
    x0 = float(dds[0].get("x0", 0.0))
    y0 = float(dds[0].get("y0", 0.0))
    for ds in dds:
        if float(ds["cell_rad"]) != cell:
            raise ValueError("stack_pg_plans: mixed cell sizes")
        if float(ds.get("x0", 0.0)) != x0 or float(ds.get("y0", 0.0)) != y0:
            raise ValueError("stack_pg_plans: mixed phase centres")
    with profiling.span("pg.plan.host"):
        k, _ = kernel_params(epsilon)
        wp = w_geometry_union([(ds["UVW"], ds["FREQ"]) for ds in dds], nx,
                              ny, cell, cell, x0, y0, 2.0, k, do_wgridding)
        nchan = max(ds["FREQ"].shape[0] for ds in dds)
        all_uvw = np.concatenate([_np(ds["UVW"]) for ds in dds])
        tu = tv = None
        if all_uvw.shape[0] * nchan >= (1 << 18):
            Nx_, Ny_ = _grid_setup(nx, ny, cell, cell, 2.0)
            tu, tv = _auto_tiles(all_uvw, _np(dds[0]["FREQ"]), Nx_, Ny_,
                                 cell, cell, k, capacity)
    items = []
    has_beam = use_beam and any("BEAM" in ds for ds in dds)
    for ds in dds:
        if bands is not None and int(ds["bandid"]) not in bands:
            continue
        plan = pgrid_plan(ds["UVW"], ds["FREQ"], nx=nx, ny=ny, cellx=cell,
                          celly=cell, epsilon=epsilon,
                          do_wgridding=do_wgridding, capacity=capacity,
                          x0=x0, y0=y0, w_params=wp, tile_u=tu, tile_v=tv,
                          device=device, dtype=dtype)
        with profiling.span("pg.plan.upload"):
            profiling.count("sync.pg.plan_upload")
            w = _weights(_np(ds["WEIGHT"]) * _np(ds["MASK"]), None,
                         plan["rdtype"], device)
            beam = None
            if has_beam or mask_image is not None:
                profiling.count("sync.pg.plan_upload")
                beam = torch.as_tensor(_ds_beam_image(
                    ds, nx, ny, use_beam, mask_image)).to(
                        device=device, dtype=plan["rdtype"])
        items.append((int(ds["bandid"]), plan, w, beam))
    return dict(p0=items[0][1] if items else None, items=items)


def _hessian_pg_cube_local(x, items, consts, band0=0):
    """sum_d beam R.H W R (beam x) per band of the (nbl, nx, ny) block x
    holding bands band0.., over ``items`` (bandid, plan, weights, beam)
    of :func:`stack_pg_plans` (others are skipped), one dataset at a
    time; not divided by wsum."""
    conv = [torch.zeros_like(x[0]) for _ in range(x.shape[0])]
    for b, plan, w, beam in items:
        j = b - band0
        if not 0 <= j < x.shape[0]:
            continue
        xin = x[j] * beam if beam is not None else x[j]
        fr, fi = _forward_from_plan(plan, xin, consts=consts)
        c = _adjoint_from_plan(plan, fr, fi, w, consts=consts)
        del fr, fi
        conv[j] = conv[j] + (c * beam if beam is not None else c)
    return torch.stack(conv)


def make_hessian_pg_stacked(dds, nband, wsum, nx, ny, sigmainv=0.0,
                            use_beam=True, mask_image=None, epsilon=1e-7,
                            do_wgridding=True, device=None):
    """Dataset-reduced vis-space Hessian through the pg gridder over
    plans with one shared geometry (:func:`stack_pg_plans`): x (nband,
    nx, ny) -> per band sum_d beam R.H W R (beam x) / wsum, one dataset
    at a time (bounds the working set to one dataset's w-plane grids)."""
    st = stack_pg_plans(dds, nx=nx, ny=ny, epsilon=epsilon,
                        do_wgridding=do_wgridding, use_beam=use_beam,
                        mask_image=mask_image, device=device)
    p0 = st["p0"]
    consts = plan_consts(p0)
    rdtype = p0["rdtype"]
    wsum = float(wsum)

    def matvec(x):
        profiling.count("pg.applications")
        x = x.to(device=p0["pos"].device, dtype=rdtype)
        out = _hessian_pg_cube_local(x, st["items"], consts) / wsum
        if sigmainv:
            out = out + x * sigmainv ** 2
        return out

    matvec.plans = [plan for _, plan, _, _ in st["items"]]
    return matvec
