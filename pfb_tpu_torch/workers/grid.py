"""grid worker: xds -> dds (dirty/PSF/PSFHAT/weights per (time, band)).
Counterpart of pfb_tpu/workers/grid.py: image sizing from uv_max, then
one image_data_products pass per dataset on ``device``. ``robustness``
sets Briggs weights from host uv counts (ops/weighting.py), written to
the dds as COUNTS; ``backend`` is "dft", "wgrid", "mm" or "pg" ("mm"
runs "pg", ops/gridder.py:ROUTES).

``row_shards`` > 1 with the pg backend grids each dataset's DIRTY, PSF
and RESIDUAL through the row-sharded adjoint
(parallel/dist.py:make_vis2dirty_rowdist) over ``devices`` (None: every
visible CUDA device, or the CPU); with fewer devices than shards, or
another backend, it warns and grids on one device, as the JAX package
does. A list that repeats a device gives virtual shards on it.

``transfer_model_from`` names an mds store (or passes its dict): the
component model is rendered on the host onto each dataset's image grid
at its (time_out, freq_out) and the RESIDUAL is made from it as from a
MODEL (reference grid.py:308-334).

``nband`` other than the xds band count re-bins the channels
(workers/concat.py:concat_chan), ``concat_row`` joins each band's time
chunks into one dataset (concat_row), and ``target`` recentres each
dataset's image on an ephemeris body or 'HH:MM:SS,DD:MM:SS' through
(x0, y0) from utils/astrometry.py:radec_to_lm (reference grid.py:371);
all on the host.
"""

import numpy as np
import torch

from pfb_tpu_torch.config import as_device
from pfb_tpu_torch.ops.dft import LIGHTSPEED
from pfb_tpu_torch.ops.fft import good_even_size
from pfb_tpu_torch.ops.gridder import image_data_products, route
from pfb_tpu_torch.ops.weighting import (compute_counts_host,
                                         filter_extreme_counts)
from pfb_tpu_torch.utils import dstore
from pfb_tpu_torch.utils.logging import get_logger

log = get_logger("GRID")


def _grid(xdsi=None, output_filename=None, product="I", suffix="main",
          nband=None, field_of_view=None, cell_size=None, nx=None,
          ny=None, super_resolution_factor=2.0, robustness=None,
          dirty=True, psf=True, psf_oversize=2.0, residual=True,
          weight=True, filter_extreme_counts_flag=False,
          filter_level=10.0, filter_nbox=None, l2reweight_dof=None,
          overwrite=True, write=True,
          backend="dft", epsilon=1e-7, do_wgridding=True,
          double_accum=True, transfer_model_from=None,
          use_best_model=False, target=None, x0=0.0, y0=0.0, xds=None,
          fits_mfs=False, fits_cubes=False, row_shards=0, device=None,
          devices=None, **kw):
    """Returns the list of dds datasets (and writes
    ``{output_filename}_{PRODUCT}_{suffix}.dds`` unless write=False, with
    the MFS image and the per-band cubes of DIRTY, PSF and RESIDUAL as
    FITS files for ``fits_mfs`` and ``fits_cubes``)."""
    device = as_device(device)
    if xdsi is None:
        path = xds if isinstance(xds, str) and xds else \
            f"{output_filename}_{product.upper()}.xds"
        xds = dstore.read_store(path)
    else:
        xds = xdsi

    fields = kw.get("fields")
    if fields is not None:
        from pfb_tpu_torch.workers.init import _idlist
        fields = _idlist(fields)
        xds = [ds for ds in xds if ds.get("fieldid", 0) in fields]
    fids = {ds.get("fieldid", 0) for ds in xds}
    if len(fids) > 1:
        raise ValueError(f"xds spans fields {sorted(fids)} — image one "
                         "field per grid run (fields=...) or solve jointly "
                         "with ops.gridder.make_hess_vis_dct + "
                         "opt.pcg.cg_dct")

    nband_in = np.unique([ds["freq_out"] for ds in xds]).size
    if nband is not None and nband != nband_in:
        # channel re-binning (reference grid.py:203-214)
        from pfb_tpu_torch.workers.concat import concat_chan
        xds = concat_chan(xds, nband)
    if kw.get("concat_row"):
        from pfb_tpu_torch.workers.concat import concat_row
        xds = concat_row(xds)

    freqs_out = np.unique([ds["freq_out"] for ds in xds])
    times_out = np.unique([ds["time_out"] for ds in xds])

    uv_max = max(np.abs(ds["UVW"][:, :2]).max() for ds in xds)
    max_freq = max(ds["FREQ"].max() for ds in xds)
    cell_N = 1.0 / (2 * uv_max * max_freq / LIGHTSPEED)
    if cell_size is not None:
        cell_rad = cell_size * np.pi / 60 / 60 / 180
        if cell_N / cell_rad < 1:
            raise ValueError("Requested cell size too large.")
    else:
        cell_rad = cell_N / super_resolution_factor
    if nx is None:
        fov = field_of_view * 3600
        cell_arcsec = cell_rad * 60 * 60 * 180 / np.pi
        nx = ny = good_even_size(int(fov / cell_arcsec))
    else:
        ny = ny if ny is not None else nx
    nx_psf = good_even_size(int(psf_oversize * nx))
    ny_psf = good_even_size(int(psf_oversize * ny))
    real_type = xds[0]["WEIGHT"].dtype

    def tens(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device)

    mds = transfer_model_from
    if isinstance(mds, (str, bytes)):
        mds = dstore.read_store(str(mds))[0]

    # row-sharded gridding: each dataset's rows split over a mesh, one sum
    # of the partial uv grids per image
    rd_mesh = None
    if row_shards and int(row_shards) > 1:
        if route(backend) != "pg":
            log.warning("row-shards=%s needs the 'pg' backend (got %r); "
                        "gridding single-device", row_shards, backend)
        else:
            from pfb_tpu_torch.parallel.mesh import Mesh, default_devices
            devs = default_devices() if devices is None else \
                [torch.device(d) for d in devices]
            nsh = min(int(row_shards), len(devs))
            if nsh > 1:
                rd_mesh = Mesh(1, nsh, devs[:nsh])
                log.info("row-sharding gridding over %d shards", nsh)
            else:
                log.warning("row-shards=%s but only %d device(s) given; "
                            "gridding single-device", row_shards, len(devs))

    def launch(ds):
        """Launch one dataset's device products (asynchronous on CUDA:
        dataset k+1 is launched before dataset k is copied back)."""
        x0_ds, y0_ds = x0, y0
        if target is not None:
            # (x0, y0) = direction cosines of the target with respect to
            # this dataset's phase centre
            from pfb_tpu_torch.utils.astrometry import (parse_target,
                                                        radec_to_lm)
            radec_t = parse_target(target, obs_time=ds.get("time_out"))
            x0_ds, y0_ds = radec_to_lm(radec_t, (ds["ra"], ds["dec"]))
        model = ds.get("MODEL")
        if use_best_model and mds is None:
            model = ds.get("MODEL_BEST", model)
        if mds is not None:
            from pfb_tpu_torch.models.comps import eval_mds_to_slice
            model = eval_mds_to_slice(mds, ds["time_out"], ds["freq_out"],
                                      nx, ny, cell_rad, x0_ds,
                                      y0_ds).astype(real_type)
        counts = None
        if robustness is not None:
            counts = compute_counts_host(ds["UVW"], ds["FREQ"], ds["MASK"],
                                         nx, ny, cell_rad, cell_rad)
            if filter_extreme_counts_flag:
                counts = filter_extreme_counts(counts, level=filter_level,
                                               nbox=filter_nbox)
        kwp = dict(robustness=robustness,
                   model=None if model is None else tens(model), x0=x0_ds,
                   y0=y0_ds, l2reweight_dof=l2reweight_dof, backend=backend,
                   epsilon=epsilon, do_wgridding=do_wgridding,
                   double_accum=double_accum)
        args = (tens(ds["UVW"]), tens(ds["FREQ"]), tens(ds["VIS"]),
                tens(ds["WEIGHT"]), tens(ds["MASK"]),
                None if counts is None else tens(counts.astype(real_type)),
                nx, ny, nx_psf, ny_psf, cell_rad, cell_rad)
        if rd_mesh is not None:
            # weights and wsum through the one-device path, the adjoints
            # through the row-sharded gridder
            out = image_data_products(*args, do_dirty=False, do_psf=False,
                                      do_weight=True, do_residual=False,
                                      **kwp)
            out.update(_rowdist_products(
                rd_mesh, ds["UVW"], ds["FREQ"], ds["VIS"],
                out["WEIGHT"].cpu().numpy(), ds["MASK"], nx, ny, nx_psf,
                ny_psf, cell_rad, model, x0_ds, y0_ds, epsilon,
                do_wgridding, device, do_dirty=dirty, do_psf=psf,
                do_residual=residual and model is not None))
            if not weight:
                out.pop("WEIGHT")
        else:
            out = image_data_products(*args, do_dirty=dirty, do_psf=psf,
                                      do_weight=weight,
                                      do_residual=residual, **kwp)
        return dict(ds=ds, out=out, model=model, counts=counts, x0=x0_ds,
                    y0=y0_ds,
                    bandid=int(np.where(freqs_out == ds["freq_out"])[0][0]),
                    timeid=int(np.where(times_out == ds["time_out"])[0][0]))

    def finish(p):
        ds, out = p["ds"], p["out"]

        def host(k):
            return out[k].cpu().numpy()

        out_ds = {
            "ra": ds["ra"], "dec": ds["dec"], "x0": p["x0"],
            "y0": p["y0"],
            "cell_rad": cell_rad, "bandid": p["bandid"],
            "timeid": p["timeid"],
            "freq_out": ds["freq_out"], "time_out": ds["time_out"],
            "robustness": robustness, "product": product,
            "super_resolution_factor": super_resolution_factor,
            "field_of_view": field_of_view, "nx": nx, "ny": ny,
            "nx_psf": nx_psf, "ny_psf": ny_psf,
            "FREQ": np.asarray(ds["FREQ"]),
            "UVW": np.asarray(ds["UVW"]),
            "MASK": np.asarray(ds["MASK"]),
            "BEAM": _eval_ds_beam(ds, nx, ny, cell_rad, p["x0"], p["y0"],
                                  real_type),
            "WSUM": host("WSUM"),
        }
        if dirty:
            out_ds["DIRTY"] = host("DIRTY")
        if psf:
            out_ds["PSF"] = host("PSF")
            ph = out["PSFHAT"]
            out_ds["PSFHAT_real"] = ph.real.cpu().numpy()
            out_ds["PSFHAT_imag"] = ph.imag.cpu().numpy()
        if weight:
            out_ds["WEIGHT"] = host("WEIGHT")
        if "RESIDUAL" in out:
            out_ds["RESIDUAL"] = host("RESIDUAL")
        if p["model"] is not None:
            out_ds["MODEL"] = np.asarray(p["model"])
        if p["counts"] is not None:
            out_ds["COUNTS"] = p["counts"]
        return out_ds

    dds = []
    pending = None
    for ds in xds:
        nxt = launch(ds)
        if pending is not None:
            dds.append(finish(pending))
        pending = nxt
    if pending is not None:
        dds.append(finish(pending))

    if write and output_filename is not None:
        name = f"{output_filename}_{product.upper()}_{suffix}.dds"
        dstore.write_store(name, dds, overwrite=overwrite)
        if fits_mfs or fits_cubes:
            from pfb_tpu_torch.utils.fits import dds2fits, dds2fits_mfs
            base = f"{output_filename}_{product.upper()}_{suffix}"
            cols = ["DIRTY"] if dirty else []
            cols += ["PSF"] if psf else []
            cols += ["RESIDUAL"] if any("RESIDUAL" in d for d in dds) else []
            for col in cols:
                if fits_mfs:
                    dds2fits_mfs(dds, col, base)
                if fits_cubes:
                    dds2fits(dds, col, base)
    return dds


def _rowdist_products(mesh, uvw, freq, vis, wgt_eff, mask, nx, ny, nx_psf,
                      ny_psf, cell_rad, model, x0, y0, epsilon, do_wgridding,
                      device, do_dirty=True, do_psf=True, do_residual=False):
    """DIRTY, PSF (+PSFHAT) and RESIDUAL of one dataset through the
    row-sharded pg adjoint (parallel/dist.py:make_vis2dirty_rowdist):
    ``wgt_eff`` is the imaging weight (robust and l2 applied), the mask
    rides in it. The degrids of the model and of the shifted PSF stay on
    ``device``."""
    from pfb_tpu_torch.ops.fft import make_psfhat
    from pfb_tpu_torch.ops.gridder import get_backend, pad_rows, row_bucket
    from pfb_tpu_torch.parallel.dist import make_vis2dirty_rowdist

    uvw = np.asarray(uvw)
    freq = np.asarray(freq)
    visa = np.asarray(vis)
    we = np.asarray(wgt_eff) * np.asarray(mask)
    nrow = uvw.shape[0]
    kwd = dict(cellx=cell_rad, celly=cell_rad, epsilon=epsilon,
               do_wgridding=do_wgridding, x0=x0, y0=y0)
    out = {}
    if do_dirty or do_residual:
        v2d_img, _ = make_vis2dirty_rowdist(mesh, uvw, freq, nx=nx, ny=ny,
                                            **kwd)
    if do_dirty:
        out["DIRTY"] = v2d_img(visa.real, visa.imag, we)
    if do_residual or (do_psf and (x0 or y0)):
        d2v, _ = get_backend("pg", epsilon, do_wgridding)
        uvw_p, = pad_rows(row_bucket(nrow), torch.as_tensor(uvw).to(device))
        freq_t = torch.as_tensor(freq).to(device)

        def degrid(img):
            vr, vi = d2v(uvw_p, freq_t, img, cell_rad, cell_rad, x0=x0,
                         y0=y0, split=True)
            return vr[:nrow].cpu().numpy(), vi[:nrow].cpu().numpy()
    if do_residual:
        mvr, mvi = degrid(torch.as_tensor(np.asarray(model)).to(device))
        out["RESIDUAL"] = v2d_img(visa.real - mvr, visa.imag - mvi, we)
    if do_psf:
        v2d_psf, _ = make_vis2dirty_rowdist(mesh, uvw, freq, nx=nx_psf,
                                            ny=ny_psf, **kwd)
        if x0 or y0:
            delta = np.zeros((128, 128), we.dtype)
            delta[64, 64] = 1.0
            delta = torch.as_tensor(delta).to(device)
            psf = v2d_psf(*degrid(delta), we)
        else:
            ones = np.ones(visa.shape, we.dtype)
            psf = v2d_psf(ones, np.zeros_like(ones), we)
        out["PSF"] = psf
        out["PSFHAT"] = make_psfhat(psf)
    return out


def _eval_ds_beam(ds, nx, ny, cell_rad, x0, y0, real_type):
    """The xds beam evaluated onto the image grid."""
    if "BEAM" not in ds or "l_beam" not in ds:
        return np.ones((nx, ny), real_type)
    from pfb_tpu_torch.utils.beam import eval_beam
    cell_deg = np.rad2deg(cell_rad)
    l = (-(nx // 2) + np.arange(nx)) * cell_deg + np.rad2deg(x0)
    m = (-(ny // 2) + np.arange(ny)) * cell_deg + np.rad2deg(y0)
    return eval_beam(ds["BEAM"], ds["l_beam"], ds["m_beam"],
                     l, m).astype(real_type)


def psfhat_of(ds):
    """Reassemble the complex PSFHAT of a dds dataset."""
    return ds["PSFHAT_real"] + 1j * ds["PSFHAT_imag"]
