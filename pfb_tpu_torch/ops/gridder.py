"""Measurement-operator products and the vis-space Hessians
(counterpart of pfb_tpu/ops/gridder.py): the dft, wgrid and pg backends,
the pg gridder's w-plane-blocked engine, robust weighting, the
exact-residual operator of the major cycle and the multi-field joint
Hessian :func:`make_hess_vis_dct`.

The JAX package's ``mm`` backend (its matmul gridder, the TPU's way onto
its matrix units) runs here as ``pg``: both compute R and R.H to the
gridder's epsilon, and on the card the pg gridder's kernels do it in
less time and memory (see :data:`ROUTES`).
"""

from functools import partial

import numpy as np
import torch

from pfb_tpu_torch.config import as_device, kernel_dtype
from pfb_tpu_torch.ops.dft import dirty2vis_dft, vis2dirty_dft
from pfb_tpu_torch.ops.fft import make_psfhat
from pfb_tpu_torch.ops.weighting import counts_to_weights

# backend names of the JAX package that the port runs on another backend
ROUTES = {"mm": "pg"}


def route(backend):
    """The backend the port runs for ``backend``."""
    return ROUTES.get(backend, backend)


def get_backend(backend, epsilon=None, do_wgridding=None,
                double_accum=None):
    """(dirty2vis, vis2dirty) for the named backend ("mm" runs pg), with
    epsilon / do_wgridding / double_accum bound in when given (the exact
    DFT maps do_wgridding onto its do_wterm switch and takes no epsilon;
    the pg gridder is float32 on the card and takes no double_accum, as
    in the JAX package)."""
    backend = route(backend)
    if backend == "dft":
        d2v, v2d = dirty2vis_dft, vis2dirty_dft
        if do_wgridding is not None:
            d2v = partial(d2v, do_wterm=do_wgridding)
            v2d = partial(v2d, do_wterm=do_wgridding)
        return d2v, v2d
    if backend == "wgrid":
        from pfb_tpu_torch.ops.wgridder import (dirty2vis_wgrid,
                                                vis2dirty_wgrid)
        d2v, v2d = dirty2vis_wgrid, vis2dirty_wgrid
    elif backend == "pg":
        from pfb_tpu_torch.ops.pgridder import dirty2vis_pg, vis2dirty_pg
        d2v, v2d = dirty2vis_pg, vis2dirty_pg
    else:
        raise ValueError(f"Unknown gridder backend {backend}")
    kw = {}
    if epsilon is not None:
        kw["epsilon"] = epsilon
    if do_wgridding is not None:
        kw["do_wgridding"] = do_wgridding
    if kw:
        d2v, v2d = partial(d2v, **kw), partial(v2d, **kw)
    if double_accum is not None and backend == "wgrid":
        v2d = partial(v2d, double_accum=double_accum)
    return d2v, v2d


def row_bucket(nrow, minimum=64):
    """Round a row count up to the next bucket (64, 96, 128, 192, ...):
    the JAX package's compile-cache ladder, kept so both packages pad
    the same rows."""
    n = minimum
    while n < nrow:
        h = n + n // 2
        if nrow <= h:
            return h
        n *= 2
    return n


def pad_rows(nrow_to, uvw, *arrays):
    """Zero-pad the row axis of uvw and per-(row, chan) arrays; padded
    rows carry zero weight/mask."""
    npad = nrow_to - uvw.shape[0]
    if npad == 0:
        return (uvw,) + arrays
    out = [torch.nn.functional.pad(uvw, (0, 0, 0, npad))]
    for a in arrays:
        out.append(None if a is None else
                   torch.nn.functional.pad(a, (0, 0, 0, npad)))
    return tuple(out)


def image_data_products(uvw, freq, vis, wgt, mask, counts, nx, ny, nx_psf,
                        ny_psf, cellx, celly, model=None, robustness=None,
                        x0=0.0, y0=0.0, l2reweight_dof=None, do_dirty=True,
                        do_psf=True, do_weight=True, do_residual=True,
                        backend="dft", epsilon=None, do_wgridding=None,
                        double_accum=None):
    """DIRTY, WSUM, PSF(+PSFHAT), RESIDUAL and effective WEIGHT for one
    (time, band) dataset, keyed with the reference's dds field names.
    All inputs are tensors on one device; ``counts`` (nx, ny) feeds the
    Briggs weights of ``robustness``."""
    d2v, v2d = get_backend(backend, epsilon, do_wgridding, double_accum)
    out = {}
    nrow = uvw.shape[0]
    uvw, vis, wgt, mask = pad_rows(row_bucket(nrow), uvw, vis, wgt, mask)
    rdtype = vis.real.dtype

    residual_vis = None
    if model is not None:
        mr, mi = d2v(uvw, freq, model, cellx, celly, x0=x0, y0=y0,
                     split=True)
        residual_vis = ((vis.real - mr) * mask, (vis.imag - mi) * mask)

    if l2reweight_dof:
        if residual_vis is None:
            raise ValueError(
                "Requested l2 reweight but no model passed in.")
        ressq = residual_vis[0] ** 2 + residual_vis[1] ** 2
        ovar = ressq.sum() / mask.sum()
        wgt = (l2reweight_dof + 1) / (l2reweight_dof + ressq / ovar) / ovar

    if robustness is not None:
        if counts is None:
            raise ValueError("counts are None but robustness specified.")
        imwgt = counts_to_weights(counts, uvw, freq, nx, ny, cellx, celly,
                                  robustness)
        wgt = imwgt if wgt is None else wgt * imwgt

    if do_weight:
        out["WEIGHT"] = wgt[:nrow]
    out["WSUM"] = torch.where(mask.bool(), wgt,
                              torch.zeros_like(wgt)).sum().reshape(1)

    if do_dirty:
        out["DIRTY"] = v2d(uvw, freq, vis, wgt=wgt, mask=mask, nx=nx, ny=ny,
                           cellx=cellx, celly=celly, x0=x0, y0=y0)

    if do_psf:
        psf_vis = (torch.ones(vis.shape, dtype=rdtype, device=vis.device),
                   torch.zeros(vis.shape, dtype=rdtype, device=vis.device))
        if x0 or y0:
            # unit delta at the shifted phase centre
            delta = torch.zeros((128, 128), dtype=rdtype, device=vis.device)
            delta[64, 64] = 1.0
            psf_vis = d2v(uvw, freq, delta, cellx, celly, x0=x0, y0=y0,
                          split=True)
        psf = v2d(uvw, freq, psf_vis, wgt=wgt, mask=mask, nx=nx_psf,
                  ny=ny_psf, cellx=cellx, celly=celly, x0=x0, y0=y0)
        out["PSF"] = psf
        out["PSFHAT"] = make_psfhat(psf)

    if model is not None and do_residual:
        out["RESIDUAL"] = v2d(uvw, freq, residual_vis, wgt=wgt, mask=mask,
                              nx=nx, ny=ny, cellx=cellx, celly=celly,
                              x0=x0, y0=y0)
    return out


def hessian_slice(x, uvw, freq, wgt, mask, cellx, celly, x0=0.0, y0=0.0,
                  beam=None, backend="dft", epsilon=None,
                  do_wgridding=None):
    """One-dataset vis-space Hessian: beam * R.H W R (beam * x)."""
    d2v, v2d = get_backend(backend, epsilon, do_wgridding)
    uvw, wgt, mask = pad_rows(row_bucket(uvw.shape[0]), uvw, wgt, mask)
    xin = x * beam if beam is not None else x
    mr, mi = d2v(uvw, freq, xin, cellx, celly, x0=x0, y0=y0, split=True)
    conv = v2d(uvw, freq, (mr * mask, mi * mask), wgt=wgt, mask=mask,
               nx=x.shape[0], ny=x.shape[1], cellx=cellx, celly=celly,
               x0=x0, y0=y0)
    if beam is not None:
        conv = conv * beam
    return conv


def _ds_tensors(ds, device):
    return {k: torch.as_tensor(ds[k]).to(device)
            for k in ("UVW", "FREQ", "WEIGHT", "MASK")}


def hessian_dds(x, dds, wsum, sigmainv=0.0, mask_image=None,
                use_beam=True, backend="dft", _cache=None):
    """Vis-space Hessian reduced over datasets: the exact residual
    operator of the major cycle. Like the JAX package, ``epsilon`` and
    ``do_wgridding`` are not plumbed here, so a wgrid residual runs at
    the backend's default epsilon (1e-7)."""
    nband = x.shape[0]
    conv = [torch.zeros_like(x[0]) for _ in range(nband)]
    for i, ds in enumerate(dds):
        b = ds["bandid"]
        t = _cache[i] if _cache is not None else _ds_tensors(ds, x.device)
        beam = None
        if use_beam and "BEAM" in ds:
            beam = torch.as_tensor(ds["BEAM"]).to(x.device)
            if mask_image is not None:
                beam = beam * mask_image
        elif mask_image is not None:
            beam = mask_image
        conv[b] = conv[b] + hessian_slice(
            x[b], t["UVW"], t["FREQ"], t["WEIGHT"], t["MASK"],
            ds["cell_rad"], ds["cell_rad"], x0=ds.get("x0", 0.0),
            y0=ds.get("y0", 0.0), beam=beam, backend=backend)
    out = torch.stack(conv) / wsum
    if sigmainv:
        out = out + x * sigmainv**2
    return out


def _ds_beam(ds, use_beam, mask_image, device):
    beam = None
    if use_beam and "BEAM" in ds:
        beam = torch.as_tensor(ds["BEAM"]).to(device)
    if mask_image is not None:
        mi = torch.as_tensor(mask_image).to(device)
        beam = mi if beam is None else beam * mi
    return beam


def stack_dds(dds, nband, use_beam=True, mask_image=None, bands=None,
              device=None):
    """The datasets grouped per band for the band-sharded DFT Hessian
    (counterpart of the JAX package's stack_dds, which pads them into
    dense arrays for one compiled program; here they stay lists). Every
    dataset must share the cell size. ``bands`` keeps only those band
    ids. Returns dict(by_band=[[(tensors, beam or None), ...] per band],
    cell, x0, y0)."""
    device = as_device(device)
    cell = float(dds[0]["cell_rad"])
    for ds in dds:
        if float(ds["cell_rad"]) != cell:
            raise ValueError("stack_dds: mixed cell sizes")
    by_band = [[] for _ in range(nband)]
    for ds in dds:
        b = int(ds["bandid"])
        if bands is None or b in bands:
            by_band[b].append((_ds_tensors(ds, device),
                               _ds_beam(ds, use_beam, mask_image, device)))
    return dict(by_band=by_band, cell=cell,
                x0=float(dds[0].get("x0", 0.0)),
                y0=float(dds[0].get("y0", 0.0)))


def _hessian_stacked_local(x, st, *, nx, ny, band0=0):
    """R.H W R per band of the (nbl, nx, ny) block x holding bands
    band0.., summed over each band's datasets of :func:`stack_dds` (exact
    DFT, w term on); not divided by wsum."""
    cell, x0, y0 = st["cell"], st["x0"], st["y0"]
    out = []
    for j in range(x.shape[0]):
        acc = torch.zeros_like(x[j])
        for t, beam in st["by_band"][band0 + j]:
            xin = x[j] * beam if beam is not None else x[j]
            mvis = dirty2vis_dft(t["UVW"], t["FREQ"], xin, cell, cell,
                                 x0=x0, y0=y0)
            c = vis2dirty_dft(t["UVW"], t["FREQ"], mvis * t["MASK"],
                              wgt=t["WEIGHT"], mask=t["MASK"], nx=nx, ny=ny,
                              cellx=cell, celly=cell, x0=x0, y0=y0)
            acc = acc + (c * beam if beam is not None else c)
        out.append(acc)
    return torch.stack(out)


def _reduce_datasets(per_ds, nband, wsum, sigmainv):
    """x (nband, nx, ny) -> per band sum_d beam H_d(beam x) / wsum (+
    sigmainv^2 x) over (bandid, beam or None, H_d) triples; the matvec
    carries the datasets' plans as ``matvec.plans``."""
    def matvec(x):
        conv = [torch.zeros_like(x[0]) for _ in range(nband)]
        for b, beam, h in per_ds:
            c = h(x[b] if beam is None else beam * x[b]).to(x.dtype)
            conv[b] = conv[b] + (c if beam is None else beam * c)
        out = torch.stack(conv) / wsum
        if sigmainv:
            out = out + x * sigmainv**2
        return out

    matvec.plans = [p for _, _, h in per_ds for p in h.plans]
    return matvec


def make_hessian_dds(dds, nband, wsum, nx, ny, sigmainv=0.0,
                     mask_image=None, use_beam=True, backend="dft",
                     epsilon=1e-7, do_wgridding=True, plane_block=None,
                     device=None):
    """The exact-residual operator of the major cycle, built once:
    x (nband, nx, ny) tensor -> R.H W R x / wsum per band.

    - ``wgrid`` runs :func:`hessian_dds`, which (as in the JAX package,
      ops/gridder.py:427-432) does not pass ``epsilon`` or
      ``do_wgridding`` on: the residual runs at epsilon = 1e-7, always
      w-gridded.
    - ``pg`` plans every dataset with the caller's ``epsilon`` and
      ``do_wgridding`` (JAX ops/gridder.py:340-383): one shared geometry
      for more than one dataset of one cell size and phase centre, else
      (as the JAX package's mm branch does) each dataset's own plan. The
      returned matvec carries its plans as ``matvec.plans``.
    - ``pg`` with ``plane_block`` and w-gridding runs every dataset
      through the w-plane-blocked engine (ops/pg_stream.py, JAX
      ops/gridder.py:303-338): one plan per dataset on its own rows,
      grid memory O(plane_block x padded grid).
    - ``mm`` runs ``pg``.
    - ``dft``, as in the JAX package, always evaluates the w term.
    ``device`` None means the card when there is one."""
    device = as_device(device)
    backend = route(backend)
    if backend == "wgrid":
        cache = [_ds_tensors(ds, device) for ds in dds]

        def matvec_loop(x):
            return hessian_dds(x, dds, wsum, sigmainv=sigmainv,
                               mask_image=mask_image, use_beam=use_beam,
                               backend=backend, _cache=cache)
        return matvec_loop

    if backend == "pg" and plane_block and do_wgridding:
        from pfb_tpu_torch.ops.pg_stream import (make_hessian_pg_wblocked,
                                                 pgrid_plan_wblocked)
        per_ds = []
        for ds in dds:
            bp = pgrid_plan_wblocked(
                np.asarray(ds["UVW"]), np.asarray(ds["FREQ"]), nx=nx, ny=ny,
                cellx=float(ds["cell_rad"]), celly=float(ds["cell_rad"]),
                epsilon=epsilon, plane_block=int(plane_block),
                x0=float(ds.get("x0", 0.0)), y0=float(ds.get("y0", 0.0)),
                device=device)
            per_ds.append((ds["bandid"],
                           _ds_beam(ds, use_beam, mask_image, device),
                           make_hessian_pg_wblocked(bp, wgt=ds["WEIGHT"],
                                                    mask=ds["MASK"])))
        return _reduce_datasets(per_ds, nband, wsum, sigmainv)

    if backend == "pg":
        from pfb_tpu_torch.ops.pgridder import (make_hessian_pg,
                                                make_hessian_pg_stacked,
                                                pgrid_plan)
        geoms = {(float(ds["cell_rad"]), float(ds.get("x0", 0.0)),
                  float(ds.get("y0", 0.0))) for ds in dds}
        if len(dds) > 1 and len(geoms) == 1:
            return make_hessian_pg_stacked(
                dds, nband, wsum, nx, ny, sigmainv=sigmainv,
                use_beam=use_beam, mask_image=mask_image, epsilon=epsilon,
                do_wgridding=do_wgridding, device=device)
        per_ds = []
        for ds in dds:
            plan = pgrid_plan(
                np.asarray(ds["UVW"]), np.asarray(ds["FREQ"]), nx=nx, ny=ny,
                cellx=float(ds["cell_rad"]), celly=float(ds["cell_rad"]),
                epsilon=epsilon, do_wgridding=do_wgridding,
                x0=float(ds.get("x0", 0.0)), y0=float(ds.get("y0", 0.0)),
                device=device)
            per_ds.append((ds["bandid"],
                           _ds_beam(ds, use_beam, mask_image, device),
                           make_hessian_pg(plan, wgt=ds["WEIGHT"],
                                           mask=ds["MASK"])))
        return _reduce_datasets(per_ds, nband, wsum, sigmainv)

    if backend != "dft":
        raise ValueError(f"Unknown gridder backend {backend}")

    per_ds = []
    for ds in dds:
        t = _ds_tensors(ds, device)
        per_ds.append((ds["bandid"],
                       _ds_beam(ds, use_beam, mask_image, device), t,
                       float(ds["cell_rad"]),
                       float(ds.get("x0", 0.0)), float(ds.get("y0", 0.0))))

    def matvec_dft(x):
        conv = [torch.zeros_like(x[0]) for _ in range(nband)]
        for b, beam, t, cell, x0, y0 in per_ds:
            xin = x[b] * beam if beam is not None else x[b]
            mvis = dirty2vis_dft(t["UVW"], t["FREQ"], xin, cell, cell,
                                 x0=x0, y0=y0)
            c = vis2dirty_dft(t["UVW"], t["FREQ"], mvis * t["MASK"],
                              wgt=t["WEIGHT"], mask=t["MASK"], nx=nx,
                              ny=ny, cellx=cell, celly=cell, x0=x0, y0=y0)
            if beam is not None:
                c = c * beam
            conv[b] = conv[b] + c
        out = torch.stack(conv) / wsum
        if sigmainv:
            out = out + x * sigmainv**2
        return out

    return matvec_dft


def make_hess_vis_dct(vis_ds, field_geom, sigmainv=1.0, backend="dft",
                      epsilon=None, do_wgridding=None, device=None):
    """Multi-field joint vis-space Hessian (counterpart of the JAX
    package's make_hess_vis_dct; reference hess_vis): for each shared
    visibility dataset the model visibilities of every field, each
    rendered at its own phase centre and cell, are summed and gridded
    back onto every field's grid, so the fields couple through the
    shared visibilities. The matvec maps ``{field: {key: (nx, ny)
    tensor}}`` to the same nest (solved by opt/pcg.py:cg_dct).

    ``vis_ds``: dataset dicts with UVW/FREQ/WEIGHT/MASK and a ``key``
    naming the (time, band) slot; ``field_geom``: ``{field: dict(nx=,
    ny=, cell_rad=, x0=, y0=)}``. Any backend; pg (and mm, which runs
    pg) plans every (dataset, field) pair once. The datasets go to
    ``device`` (None: the card when there is one), float32 on CUDA and
    float64 on the CPU."""
    device = as_device(device)
    dtype = kernel_dtype(device, torch.float64)
    d2v, v2d = get_backend(backend, epsilon, do_wgridding)
    make_plan = None
    if route(backend) == "pg":
        from pfb_tpu_torch.ops.pgridder import pgrid_plan as make_plan
    pkw = {k: v for k, v in (("epsilon", epsilon),
                             ("do_wgridding", do_wgridding)) if v is not None}

    items = []
    for ds in vis_ds:
        t = {k: torch.as_tensor(np.asarray(ds[k])).to(device, dtype)
             for k in ("UVW", "FREQ", "WEIGHT", "MASK")}
        geo = {}
        for f, g in field_geom.items():
            kw = dict(x0=g.get("x0", 0.0), y0=g.get("y0", 0.0))
            if make_plan is not None:
                kw["plan"] = make_plan(
                    np.asarray(ds["UVW"]), np.asarray(ds["FREQ"]),
                    nx=g["nx"], ny=g["ny"], cellx=g["cell_rad"],
                    celly=g["cell_rad"], dtype=dtype, device=device, **kw,
                    **pkw)
            geo[f] = kw
        items.append((ds["key"], t, geo))

    def matvec(x):
        out = {f: {k: sigmainv * v for k, v in sub.items()}
               for f, sub in x.items()}
        for key, t, geo in items:
            mvis = None
            for f, g in field_geom.items():
                mv = d2v(t["UVW"], t["FREQ"], x[f][key], g["cell_rad"],
                         g["cell_rad"], **geo[f])
                mvis = mv if mvis is None else mvis + mv
            mvis = mvis * t["MASK"]
            for f, g in field_geom.items():
                out[f][key] = out[f][key] + v2d(
                    t["UVW"], t["FREQ"], mvis, wgt=t["WEIGHT"],
                    mask=t["MASK"], nx=g["nx"], ny=g["ny"],
                    cellx=g["cell_rad"], celly=g["cell_rad"], **geo[f])
        return out

    return matvec
