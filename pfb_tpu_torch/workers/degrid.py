"""degrid worker: mds component model -> MODEL_DATA-style column.

Counterpart of pfb_tpu/workers/degrid.py (reference
pfb/workers/degrid.py:21-236 + comps2vis, pfb/operators/gridder.py:
394-548): per (time chunk, band) render the fitted model onto the image
grid at the chunk's mean (t, f) on the host, degrid it to model
visibilities on ``device`` through the backend of ops/gridder.py
(``dft``, ``wgrid``, ``mm`` or ``pg``), and carry them to the host as
complex128, optionally accumulating into an existing column.

With ``backend="pg"`` (or ``"mm"``, which runs pg) each (time chunk,
band) builds its own plan on the host (ops/pgridder.py:pgrid_plan) and
runs the image-to-grid transforms (K3c / K3r by route) and the degrid
kernel (K6) on the card.
"""

import time

import numpy as np
import torch

from pfb_tpu_torch.config import as_device, kernel_dtype
from pfb_tpu_torch.models.comps import eval_mds_to_slice
from pfb_tpu_torch.ops.gridder import get_backend, route
from pfb_tpu_torch.ops.pgridder import pgrid_plan
from pfb_tpu_torch.utils import dstore
from pfb_tpu_torch.utils.ms import read_ms, update_ms_column


def _degrid(ms=None, mds=None, output_filename=None, product="I",
            suffix="main", model_column="MODEL_DATA",
            channels_per_image=None, integrations_per_image=-1,
            accumulate=False, backend="dft", epsilon=1e-7,
            do_wgridding=True, nx=None, ny=None,
            cell_rad=None, x0=0.0, y0=0.0, write=True, device=None,
            stats=None, **kw):
    """Returns the model visibility column (nrow, nchan, ncorr) and
    writes it into the MS unless write=False.

    The image is degridded in the card's working dtype (float32 on CUDA,
    float64 on the CPU). ``device`` None means the card when there is
    one. ``stats``, when a dict, receives the host seconds of rendering
    the model (``render_s``), of the pg plans (``plan_s``), of the
    degrids including their copies to the host (``degrid_s``) and of
    writing the column (``write_s``), and the number of images
    (``nimages``)."""
    device = as_device(device)
    if isinstance(mds, str):
        mds = dstore.read_store(mds)[0]

    msd = read_ms(ms)
    uvw = msd["UVW"]
    time_col = msd["TIME"]
    freq = msd["FREQ"]
    data_shape = msd["DATA"].shape
    nrow, nchan, ncorr = data_shape

    utime = np.unique(time_col)
    ntime = utime.size
    tbin_map = np.searchsorted(utime, time_col)

    ipi = integrations_per_image
    if ipi in (0, -1, None):
        ipi = ntime
    cpi = channels_per_image
    if cpi in (0, -1, None):
        cpi = nchan

    # model grid defaults to the mds fit grid
    nx = nx or mds["npix_x"]
    ny = ny or mds["npix_y"]
    cell_rad = cell_rad or mds["cell_rad_x"]
    x0 = x0 or mds.get("center_x", 0.0)
    y0 = y0 or mds.get("center_y", 0.0)

    d2v, _ = get_backend(backend, epsilon, do_wgridding)
    rdt = kernel_dtype(device, torch.float64)
    t = dict(render_s=0.0, plan_s=0.0, degrid_s=0.0, write_s=0.0,
             nimages=0)

    vis = np.zeros((nrow, nchan), dtype=np.complex128)
    for t0 in range(0, ntime, ipi):
        rows = np.where((tbin_map >= t0) & (tbin_map < t0 + ipi))[0]
        tout = float(np.mean(utime[t0:t0 + ipi]))
        uvw_t = torch.as_tensor(uvw[rows]).to(device)
        for c0 in range(0, nchan, cpi):
            csel = slice(c0, min(c0 + cpi, nchan))
            fout = float(np.mean(freq[csel]))
            tic = time.perf_counter()
            image = eval_mds_to_slice(mds, tout, fout, nx, ny, cell_rad,
                                      x0, y0)
            t["render_s"] += time.perf_counter() - tic
            kwp = {}
            if route(backend) == "pg":
                tic = time.perf_counter()
                kwp["plan"] = pgrid_plan(
                    uvw[rows], freq[csel], nx=nx, ny=ny, cellx=cell_rad,
                    celly=cell_rad, epsilon=epsilon,
                    do_wgridding=do_wgridding, x0=x0, y0=y0, dtype=rdt,
                    device=device)
                if device.type == "cuda":  # the plan's copies to the card
                    torch.cuda.synchronize(device)
                t["plan_s"] += time.perf_counter() - tic
            tic = time.perf_counter()
            mvr, mvi = d2v(uvw_t, torch.as_tensor(freq[csel]).to(device),
                           torch.as_tensor(image).to(device, rdt), cell_rad,
                           cell_rad, x0=x0, y0=y0, split=True, **kwp)
            vis[np.ix_(rows, range(csel.start, csel.stop))] = \
                mvr.double().cpu().numpy() + 1j * mvi.double().cpu().numpy()
            t["degrid_s"] += time.perf_counter() - tic
            t["nimages"] += 1
            del kwp

    model_vis = np.zeros(data_shape, dtype=np.complex128)
    model_vis[..., 0] = vis
    if ncorr > 1:
        model_vis[..., -1] = vis

    if write and ms is not None:
        if accumulate and model_column in msd:
            model_vis = model_vis + msd[model_column]
        tic = time.perf_counter()
        update_ms_column(ms, model_column, model_vis)
        t["write_s"] = time.perf_counter() - tic
    if stats is not None:
        stats.update(t)
    return model_vis
