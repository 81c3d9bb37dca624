"""grid worker: xds -> dds (dirty/PSF/PSFHAT/weights per (time, band)).
Counterpart of pfb_tpu/workers/grid.py: image sizing from uv_max, then
one image_data_products pass per dataset on ``device``. ``robustness``
sets Briggs weights from host uv counts (ops/weighting.py), written to
the dds as COUNTS; ``backend`` is "dft", "wgrid" or "pg".

Not ported yet (they raise): channel re-binning (``nband`` != the xds
band count), ``concat_row``, ``row_shards``, ``target`` and
``transfer_model_from``.
"""

import numpy as np
import torch

from pfb_tpu_torch.config import as_device
from pfb_tpu_torch.ops.dft import LIGHTSPEED
from pfb_tpu_torch.ops.fft import good_even_size
from pfb_tpu_torch.ops.gridder import image_data_products
from pfb_tpu_torch.ops.weighting import (compute_counts_host,
                                         filter_extreme_counts)
from pfb_tpu_torch.utils import dstore


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
          row_shards=0, device=None, **kw):
    """Returns the list of dds datasets (and writes
    ``{output_filename}_{PRODUCT}_{suffix}.dds`` unless write=False)."""
    if transfer_model_from is not None or target is not None or \
            (row_shards and int(row_shards) > 1) or kw.get("concat_row"):
        raise NotImplementedError(
            "transfer_model_from / target / row_shards / concat_row are "
            "not ported to pfb_tpu_torch yet")
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
                         "field per grid run (fields=...)")

    freqs_out = np.unique([ds["freq_out"] for ds in xds])
    times_out = np.unique([ds["time_out"] for ds in xds])
    if nband is not None and nband != freqs_out.size:
        raise NotImplementedError("channel re-binning (concat_chan) is not "
                                  "ported yet")

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

    def launch(ds):
        """Launch one dataset's device products (asynchronous on CUDA:
        dataset k+1 is launched before dataset k is copied back)."""
        model = ds.get("MODEL")
        if use_best_model:
            model = ds.get("MODEL_BEST", model)
        counts = None
        if robustness is not None:
            counts = compute_counts_host(ds["UVW"], ds["FREQ"], ds["MASK"],
                                         nx, ny, cell_rad, cell_rad)
            if filter_extreme_counts_flag:
                counts = filter_extreme_counts(counts, level=filter_level,
                                               nbox=filter_nbox)
        out = image_data_products(
            tens(ds["UVW"]), tens(ds["FREQ"]), tens(ds["VIS"]),
            tens(ds["WEIGHT"]), tens(ds["MASK"]),
            None if counts is None else tens(counts.astype(real_type)),
            nx, ny, nx_psf,
            ny_psf, cell_rad, cell_rad, robustness=robustness,
            model=None if model is None else tens(model), x0=x0, y0=y0,
            l2reweight_dof=l2reweight_dof, do_dirty=dirty, do_psf=psf,
            do_weight=weight, do_residual=residual, backend=backend,
            epsilon=epsilon, do_wgridding=do_wgridding,
            double_accum=double_accum)
        return dict(ds=ds, out=out, model=model, counts=counts,
                    bandid=int(np.where(freqs_out == ds["freq_out"])[0][0]),
                    timeid=int(np.where(times_out == ds["time_out"])[0][0]))

    def finish(p):
        ds, out = p["ds"], p["out"]

        def host(k):
            return out[k].cpu().numpy()

        out_ds = {
            "ra": ds["ra"], "dec": ds["dec"], "x0": x0, "y0": y0,
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
            "BEAM": _eval_ds_beam(ds, nx, ny, cell_rad, x0, y0, real_type),
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
    return dds


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
