"""fastim worker: high-cadence residual snapshot imaging (counterpart of
pfb_tpu/workers/fastim.py; reference pfb/workers/fastim.py +
utils/stokes2im.py).

For every (scan, time-chunk, band) it makes one small residual dirty
image: weights, optional model subtraction (from an mds), robust
weighting and gridding in one pass, written to an fds store for the
smoovie movie maker. Each snapshot's device work is launched before the
previous snapshot is copied back to the host, so host I/O (column
slicing, host plans, fds assembly) overlaps device gridding.

The model is rendered on the host and degridded on ``device`` at
``channels_per_degrid_image`` resolution inside each
``channels_per_grid_image`` output band (reference fastim.yaml). For
``backend="pg"`` each snapshot's adjoint runs the spread K4, the fold K5
and the transforms K3c / K3r by route, and each model sub-band's degrid
the degrid K6.

Device dtype: complex64 / float32 on CUDA with ``precision="single"``
(the pg kernels' type), float64 otherwise; RESIDUAL is stored in the
``precision`` type.
"""

import numpy as np
import torch

from pfb_tpu_torch.config import as_device
from pfb_tpu_torch.models.comps import eval_mds_to_slice
from pfb_tpu_torch.ops.dft import LIGHTSPEED
from pfb_tpu_torch.ops.fft import good_even_size
from pfb_tpu_torch.ops.gridder import get_backend
from pfb_tpu_torch.ops.weighting import (compute_counts_host,
                                         counts_to_weights,
                                         filter_extreme_counts)
from pfb_tpu_torch.utils import dstore
from pfb_tpu_torch.utils.ms import read_ms
from pfb_tpu_torch.utils.stokes import unity_jones, weight_data
from pfb_tpu_torch.workers.init import _column_expr, _idlist


def _fastim(ms=None, output_filename=None, product="I", suffix="fds",
            mds=None, transfer_model_from=None,
            channels_per_image=None, channels_per_grid_image=None,
            channels_per_degrid_image=None, integrations_per_image=1,
            fields=None, ddids=None, scans=None, freq_range=None,
            robustness=None, filter_extreme_counts_flag=False,
            filter_nbox=None, filter_level=10.0, l2reweight_dof=None,
            super_resolution_factor=2.0, field_of_view=1.0, nx=None,
            ny=None, cell_size=None, target=None, backend="dft",
            epsilon=1e-7, do_wgridding=True, gain_table=None,
            gain_term="NET", data_column="DATA", weight_column=None,
            sigma_column=None, flag_column="FLAG", precision="single",
            overwrite=True, write=True, device=None, **kw):
    """Returns the list of fds datasets (one small image per
    (scan, time-chunk, band)). ``device`` None means the card when there
    is one."""
    device = as_device(device)
    msd = read_ms(ms)
    data = _column_expr(msd, data_column)
    nrow, nchan_ms, ncorr = data.shape
    uvw = msd["UVW"]
    time = msd["TIME"]
    ant1, ant2 = msd["ANTENNA1"], msd["ANTENNA2"]
    freq_all = np.asarray(msd["FREQ"], np.float64)
    flag = msd.get(flag_column, np.zeros(data.shape, bool))
    if sigma_column is not None:
        sigma = np.asarray(msd[sigma_column], np.float64)
        with np.errstate(divide="ignore"):
            wgt_in = np.where(sigma > 0, 1.0 / (sigma * sigma), 0.0)
    else:
        wgt_in = msd.get(weight_column or "WEIGHT_SPECTRUM",
                         np.ones(data.shape))
    pol = str(msd.get("POLTYPE", "linear"))

    # row selection (reference fastim.yaml fields/ddids/scans)
    fid = np.asarray(msd.get("FIELD_ID", np.zeros(nrow, np.int32)))
    did = np.asarray(msd.get("DATA_DESC_ID",
                             np.zeros(nrow, np.int32)))
    sid = np.asarray(msd.get("SCAN_NUMBER", np.zeros(nrow, np.int32)))
    rsel = np.ones(nrow, bool)
    for ids, arr in ((_idlist(fields), fid), (_idlist(ddids), did),
                     (_idlist(scans), sid)):
        if ids is not None:
            rsel &= np.isin(arr, list(ids))
    if not rsel.all():
        (data, uvw, time, ant1, ant2, flag, wgt_in, sid) = (
            a[rsel] for a in (data, uvw, time, ant1, ant2, flag,
                              wgt_in, sid))
        nrow = data.shape[0]

    # channel selection (freq-range "fmin:fmax")
    if isinstance(freq_range, str) and freq_range:
        lo, _, hi = freq_range.partition(":")
        fmin = float(lo) if lo else -np.inf
        fmax = float(hi) if hi else np.inf
        csel_all = np.where((freq_all >= fmin) & (freq_all <= fmax))[0]
        data = data[:, csel_all]
        flag = flag[:, csel_all]
        wgt_in = wgt_in[:, csel_all]
        freq = freq_all[csel_all]
    else:
        freq = freq_all
    nchan = freq.size

    utime = np.unique(time)
    ntime = utime.size
    tbin_map = np.searchsorted(utime, time)
    nant = int(max(ant1.max(), ant2.max())) + 1

    if gain_table is not None:
        if isinstance(gain_table, str):
            path, _, term = gain_table.partition("::")
            g = np.load(path)
            term = term or gain_term
            jones = np.asarray(g[f"jones_{term}"]
                               if f"jones_{term}" in g.files
                               else g["jones"])
        else:
            jones = np.asarray(gain_table)
    else:
        jones = unity_jones(ntime, nant, nchan)

    mds = transfer_model_from if transfer_model_from is not None \
        else mds
    if isinstance(mds, str):
        mds = dstore.read_store(mds)[0]

    ipi = integrations_per_image or 1
    cpi = channels_per_grid_image
    if cpi in (0, -1, None):  # fall back to the legacy alias
        cpi = channels_per_image
    if cpi in (0, -1, None):
        cpi = nchan
    cpdi = channels_per_degrid_image
    if cpdi in (0, -1, None):
        cpdi = cpi
    cpdi = min(cpdi, cpi)

    # image geometry
    uv_max = np.abs(uvw[:, :2]).max()
    cell_N = 1.0 / (2 * uv_max * freq.max() / LIGHTSPEED)
    if cell_size is not None:
        cell_rad = cell_size * np.pi / 60 / 60 / 180
    else:
        cell_rad = cell_N / super_resolution_factor
    if nx is None:
        cell_arcsec = cell_rad * 60 * 60 * 180 / np.pi
        nx = good_even_size(int(field_of_view * 3600 / cell_arcsec))
    ny = ny or nx

    ra0 = float(np.atleast_1d(
        np.asarray(msd.get("FIELD_RA", msd.get("RA", 0.0))))[0])
    dec0 = float(np.atleast_1d(
        np.asarray(msd.get("FIELD_DEC", msd.get("DEC", 0.0))))[0])
    x0 = y0 = 0.0
    if target is not None:
        from pfb_tpu_torch.utils.astrometry import parse_target, radec_to_lm
        radec_t = parse_target(target, obs_time=float(np.mean(time)))
        x0, y0 = radec_to_lm(radec_t, (ra0, dec0))

    flag_rc = flag.any(axis=-1)
    d2v, v2d = get_backend(backend, epsilon, do_wgridding)
    rdt = np.float32 if precision == "single" else np.float64
    single = device.type == "cuda" and precision == "single"
    rdev = torch.float32 if single else torch.float64
    cdev = torch.complex64 if single else torch.complex128
    scan = sid

    def dev(a, dt=None):
        t = torch.as_tensor(np.ascontiguousarray(a))
        return t.to(device) if dt is None else t.to(device=device, dtype=dt)

    def launch(srows, t0, t1, sid_, c0):
        """Launch one (scan, time-chunk, band) snapshot's device work;
        returns device tensors and metadata (no host sync)."""
        rows = srows[(tbin_map[srows] >= t0) & (tbin_map[srows] < t1)]
        tout = float(np.mean(utime[t0:t1]))
        csel = slice(c0, min(c0 + cpi, nchan))
        vis, wout = weight_data(
            dev(data[rows][:, csel], cdev), dev(wgt_in[rows][:, csel], rdev),
            dev(flag_rc[rows][:, csel].astype(np.uint8)),
            dev(jones[:, :, csel], cdev), dev(tbin_map[rows]),
            dev(ant1[rows]), dev(ant2[rows]), product=product, pol=pol)
        mask = (~flag_rc[rows][:, csel]).astype(np.uint8)
        mask_t = dev(mask)
        uvw_t = dev(uvw[rows], rdev)
        freq_t = dev(freq[csel], rdev)
        fout = float(np.mean(freq[csel]))

        if mds is not None:
            # degrid the model at cpdi-channel resolution within the
            # grid band (reference channels-per-degrid-image)
            nsub = csel.stop - csel.start
            mvis_parts = []
            for d0 in range(0, nsub, cpdi):
                dsel = slice(d0, min(d0 + cpdi, nsub))
                fsub = freq[csel][dsel]
                image = eval_mds_to_slice(mds, tout, float(np.mean(fsub)),
                                          nx, ny, cell_rad, x0, y0)
                mvis_parts.append(d2v(uvw_t, dev(fsub, rdev),
                                      dev(image, rdev), cell_rad,
                                      cell_rad, x0=x0, y0=y0, split=True))
            vis = vis - torch.complex(
                torch.cat([p[0] for p in mvis_parts], dim=1),
                torch.cat([p[1] for p in mvis_parts], dim=1))

        if l2reweight_dof:
            # Student-t reweighting from the residual visibilities
            # (reference stokes2im.py l2reweight path)
            ressq = (vis * vis.conj()).real
            mb = mask_t.bool()
            wcount = mb.sum()
            ovar = torch.where(mb, ressq, 0.0).sum() / \
                torch.clamp(wcount, min=1)
            wout = wout * (l2reweight_dof + 1) / \
                (l2reweight_dof + ressq / ovar)

        if robustness is not None:
            counts = compute_counts_host(uvw[rows], freq[csel], mask, nx,
                                         ny, cell_rad, cell_rad)
            if filter_extreme_counts_flag:
                counts = filter_extreme_counts(counts, level=filter_level,
                                               nbox=filter_nbox)
            imw = counts_to_weights(dev(counts, rdev), uvw_t, freq_t, nx,
                                    ny, cell_rad, cell_rad, robustness)
            wout = wout * imw

        wsum = torch.where(mask_t.bool(), wout, 0.0).sum()
        dirty = v2d(uvw_t, freq_t, vis, wgt=wout, mask=mask_t, nx=nx,
                    ny=ny, cellx=cell_rad, celly=cell_rad, x0=x0, y0=y0)
        return dict(dirty=dirty, wsum=wsum, tout=tout, fout=fout,
                    timeid=int(t0 // ipi), bandid=int(c0 // cpi),
                    scanid=int(sid_))

    def finish(p):
        """Copy a launched snapshot back to a host fds entry."""
        return {
            "RESIDUAL": p["dirty"].cpu().numpy().astype(rdt),
            "WSUM": np.atleast_1d(float(p["wsum"])),
            "time_out": p["tout"],
            "freq_out": p["fout"],
            "timeid": p["timeid"],
            "bandid": p["bandid"],
            "scanid": p["scanid"],
            "cell_rad": float(cell_rad),
            "x0": float(x0),
            "y0": float(y0),
            "ra": ra0,
            "dec": dec0,
        }

    # time chunks never cross scan boundaries (reference fastim chunks
    # per (ddid, scan)); snapshot k+1 is launched before snapshot k is
    # copied back
    fds_out = []
    pending = None
    for sv in np.unique(scan):
        srows = np.where(scan == sv)[0]
        tbins = np.unique(tbin_map[srows])
        for i0 in range(0, tbins.size, ipi):
            t0 = tbins[i0]
            t1 = tbins[min(i0 + ipi, tbins.size) - 1] + 1
            for c0 in range(0, nchan, cpi):
                nxt = launch(srows, t0, t1, sv, c0)
                if pending is not None:
                    fds_out.append(finish(pending))
                pending = nxt
    if pending is not None:
        fds_out.append(finish(pending))

    if write and output_filename is not None:
        name = f"{output_filename}_{product.upper()}_{suffix}.fds"
        dstore.write_store(name, fds_out, overwrite=overwrite)
    return fds_out
