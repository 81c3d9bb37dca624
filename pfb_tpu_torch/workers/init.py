"""init worker: MS (+ optional gain table) -> per-chunk Stokes
visibility store (xds). Counterpart of pfb_tpu/workers/init.py; the
Jones/Stokes step runs in torch on ``device``; rephasing to a common
``radec`` and the ``site_latitude`` beam average run on the host
(utils/astrometry.py, utils/beam.py).

Reference: pfb/workers/init.py + utils/stokes2vis.py +
construct_mappings (utils/misc.py:250-487). Reads the npz MS, groups
rows per (FIELD_ID, DATA_DESC_ID, SCAN_NUMBER), splits each group's
rows into time chunks (integrations_per_image) and channels into freq
chunks (channels_per_image) after optional frequency-range filtering,
computes Jones-corrected Stokes visibilities + weights
(utils/stokes.py; diag or full 2x2 mode, gains aligned onto the data
grid by (time, chan) binning), optionally channel-averages, and writes
an xds store with the reference's field names.
"""

import re

import numpy as np
import torch

from pfb_tpu_torch.config import as_device
from pfb_tpu_torch.utils import dstore
from pfb_tpu_torch.utils.ms import open_ms_source
from pfb_tpu_torch.utils.stokes import unity_jones, weight_data


def _column_expr(msd, expr):
    """Evaluate a data-column expression like "DATA-MODEL_DATA" or
    "CORRECTED_DATA+MODEL_DATA" (reference stokes2vis.py:78-92)."""
    toks = re.split(r"([+-])", expr.replace(" ", ""))
    out = np.asarray(msd[toks[0]], np.complex128)
    for op, name in zip(toks[1::2], toks[2::2]):
        col = np.asarray(msd[name], np.complex128)
        out = out + col if op == "+" else out - col
    return out


def _expr_columns(expr):
    return tuple(t for t in re.split(r"[+-]", expr.replace(" ", ""))
                 if t)


def _jones_mode(jones):
    """Infer QuartiCal gain layout: (t, a, f, dir, 2) diag,
    (t, a, f, dir, 2, 2) or (..., 4) full (flattened row-major)."""
    if jones.ndim == 6 and jones.shape[-2:] == (2, 2):
        return jones.reshape(jones.shape[:-2] + (4,)), "full"
    if jones.shape[-1] == 4:
        return jones, "full"
    if jones.shape[-1] == 2:
        return jones, "diag"
    raise ValueError(f"Unrecognised jones shape {jones.shape}")


def _idlist(sel):
    """Normalise a selection to an int array: CLI strings are
    comma-separated ("0,2"), programmatic callers pass ints/lists."""
    if sel is None:
        return None
    if isinstance(sel, str):
        sel = [int(s) for s in sel.split(",") if s.strip() != ""]
    return np.atleast_1d(sel).astype(np.int64)


def _bin_map(grid, values):
    """Index of the gain-grid bin each value falls in (right-closed
    lower bound — the (time, chan)-binned gain application of
    reference utils/misc.py:415-439)."""
    idx = np.searchsorted(np.asarray(grid), np.asarray(values),
                          side="right") - 1
    return np.clip(idx, 0, len(grid) - 1)


def _chan_average(vis, wgt, freq, cb):
    """Weighted channel averaging by factor cb (reference
    stokes2vis.py 'chan-average': vis = sum(w v)/sum(w), w = sum(w))."""
    nr, nc = vis.shape
    if nc % cb:
        raise ValueError(
            f"chan_average={cb} does not divide nchan={nc}")
    nco = nc // cb
    wb = wgt.reshape(nr, nco, cb)
    vb = (vis * wgt).reshape(nr, nco, cb).sum(-1)
    ws = wb.sum(-1)
    vis_o = np.where(ws > 0, vb / np.where(ws > 0, ws, 1.0), 0.0)
    return vis_o, ws, freq.reshape(nco, cb).mean(-1)


def _init(ms=None, output_filename=None, product="I",
          channels_per_image=None, integrations_per_image=-1,
          gain_table=None, gain_term="NET", data_column="DATA",
          weight_column=None, sigma_column=None, flag_column="FLAG",
          beam_model=None, max_field_of_view=3.0,
          beam_resolution=64,
          chan_average=1, freq_range=None, fields=None, ddids=None,
          scans=None, site_latitude=None, precision="double",
          radec=None, overwrite=True, write=True, device=None, **kw):
    """Returns the list of xds datasets (and writes
    ``{output_filename}_{PRODUCT}.xds`` unless write=False).

    Chunking mirrors construct_mappings (utils/misc.py:250-487): rows
    grouped per (FIELD_ID, DATA_DESC_ID, SCAN_NUMBER), then by unique
    time into integrations_per_image-sized chunks; channels filtered to
    ``freq_range`` ("fmin:fmax" in Hz, either side optional) and split
    into channels_per_image-sized chunks (-1/None = all), each
    optionally averaged down by ``chan_average``. ``data_column``
    accepts +/- arithmetic between columns ("DATA-MODEL_DATA").

    ``ms`` accepts a single MS (path / column dict) or a LIST of MSs
    (or a comma-separated path string) — the reference scans many
    (misc.py:250, init.py:236). Big per-row columns are read per
    (group, time-chunk) slab through the MS source, never whole-table,
    so observations larger than RAM ingest with bounded memory
    (CasaMSSource streams getcol(startrow, nrow) runs).
    """
    device = as_device(device)
    if isinstance(ms, (list, tuple)):
        ms_list = list(ms)
    elif isinstance(ms, str) and "," in ms:
        ms_list = [p for p in ms.split(",") if p]
    else:
        ms_list = [ms]

    datasets = []
    radec_shared = {}
    for m in ms_list:
        datasets.extend(_init_one_ms(
            m, product=product, channels_per_image=channels_per_image,
            integrations_per_image=integrations_per_image,
            gain_table=gain_table, gain_term=gain_term,
            data_column=data_column, weight_column=weight_column,
            sigma_column=sigma_column, flag_column=flag_column,
            beam_model=beam_model,
            max_field_of_view=max_field_of_view,
            beam_resolution=beam_resolution,
            chan_average=chan_average, freq_range=freq_range,
            fields=fields, ddids=ddids, scans=scans,
            site_latitude=site_latitude, precision=precision,
            radec=radec, _radec_shared=radec_shared, device=device))

    if write and output_filename is not None:
        name = f"{output_filename}_{product.upper()}.xds"
        dstore.write_store(name, datasets, overwrite=overwrite)
    return datasets


def _init_one_ms(ms, product, channels_per_image,
                 integrations_per_image, gain_table, gain_term,
                 data_column, weight_column, sigma_column, flag_column,
                 beam_model, max_field_of_view, chan_average,
                 freq_range, fields, ddids, scans, site_latitude,
                 precision, radec, _radec_shared, beam_resolution=64,
                 device="cpu"):
    src = open_ms_source(ms)
    idx = src.index()

    time = np.asarray(idx["TIME"])
    ant1 = np.asarray(idx["ANTENNA1"])
    ant2 = np.asarray(idx["ANTENNA2"])
    nrow = time.shape[0]
    freq_tab = np.asarray(idx["FREQ"], np.float64)
    pol = str(idx.get("POLTYPE", "linear"))

    # per-chunk slab columns: the data expression's terms + flags +
    # weights + UVW (bounded memory; see _init docstring)
    slab_cols = set(_expr_columns(data_column)) | {"UVW"}
    if flag_column:
        slab_cols.add(flag_column)
    if sigma_column is not None:
        slab_cols.add(sigma_column)
    else:
        slab_cols.add(weight_column or "WEIGHT_SPECTRUM")
    slab_cols = tuple(slab_cols)

    fid = np.asarray(idx.get("FIELD_ID", np.zeros(nrow, np.int32)))
    did = np.asarray(idx.get("DATA_DESC_ID",
                             np.zeros(nrow, np.int32)))
    sid = np.asarray(idx.get("SCAN_NUMBER", np.zeros(nrow, np.int32)))
    # per-field phase centres (FIELD table analogue); scalars fall back
    fra = np.atleast_1d(np.asarray(idx.get("FIELD_RA",
                                           idx.get("RA", 0.0))))
    fdec = np.atleast_1d(np.asarray(idx.get("FIELD_DEC",
                                            idx.get("DEC", 0.0))))

    nant = int(max(ant1.max(), ant2.max())) + 1

    if gain_table is not None:
        if isinstance(gain_table, str):
            # QuartiCal-style term selection: 'path::TERM' wins over
            # the gain-term option (reference init.py:146)
            path, _, term = gain_table.partition("::")
            g = np.load(path)
            term = term or gain_term
        else:
            g, term = gain_table, gain_term
        is_d = hasattr(g, "files") or isinstance(g, dict)
        keys = set(g.files if hasattr(g, "files") else g.keys()) \
            if is_d else set()
        if is_d and f"jones_{term}" in keys:
            jones = np.asarray(g[f"jones_{term}"])
        elif is_d:
            jones = np.asarray(g["jones"])
        else:
            jones = np.asarray(g)
        jones, mode = _jones_mode(jones)
        gain_time = np.asarray(g["gain_time"]) if (
            hasattr(g, "files") and "gain_time" in g.files) or (
            isinstance(g, dict) and "gain_time" in g) else None
        gain_freq = np.asarray(g["gain_freq"]) if (
            hasattr(g, "files") and "gain_freq" in g.files) or (
            isinstance(g, dict) and "gain_freq" in g) else None
    else:
        jones, mode = None, "diag"
        gain_time = gain_freq = None

    if isinstance(freq_range, str) and freq_range:
        lo, _, hi = freq_range.partition(":")
        fmin = float(lo) if lo else -np.inf
        fmax = float(hi) if hi else np.inf
    elif freq_range is not None:
        fmin, fmax = freq_range
    else:
        fmin, fmax = -np.inf, np.inf

    fields = _idlist(fields)
    ddids = _idlist(ddids)
    scans = _idlist(scans)

    radec_out = None
    if radec is not None:
        # parse once per run and share across the MS list so every
        # field of every MS re-references to the SAME centre
        if "radec" not in _radec_shared:
            from pfb_tpu_torch.utils.astrometry import parse_target
            _radec_shared["radec"] = parse_target(
                radec, obs_time=float(np.mean(time)))
        radec_out = _radec_shared["radec"]

    # (field, ddid, scan) groups (reference misc.py:312-370)
    groups = np.unique(np.stack([fid, did, sid], axis=1), axis=0)

    datasets = []
    pending = None

    def finish(p):
        """Materialise a launched chunk (device->host readback +
        host-side averaging/beam/assembly). Chunk k+1's weight_data
        launch and slab read happen BEFORE this runs for chunk k, so the
        host I/O overlaps the device work."""
        vis = p["vis"].cpu().numpy()
        wout = p["wout"].cpu().numpy()
        if precision == "single":
            vis = vis.astype(np.complex64)
            wout = wout.astype(np.float32)
        freq_c = p["freq_c"]
        if chan_average and chan_average > 1:
            vis, wout, freq_c = _chan_average(vis, wout, freq_c,
                                              int(chan_average))
        mask = (wout > 0).astype(np.uint8)
        ut = p["utime_chunk"]
        ds = {
            "VIS": vis,
            "WEIGHT": wout,
            "MASK": mask,
            "UVW": p["uvw"],
            "FREQ": freq_c,
            "time_out": float(np.mean(ut)),
            "freq_out": float(np.mean(freq_c)),
            "freq_min": float(freq_c.min()),
            "freq_max": float(freq_c.max()),
            "time_min": float(ut.min()),
            "time_max": float(ut.max()),
            "ra": p["ra"],
            "dec": p["dec"],
            "fieldid": p["fieldid"],
            "ddid": p["ddid"],
            "scanid": p["scanid"],
            "product": product,
        }
        # primary beam on a coarse grid at freq_out (reference
        # attaches BEAM/l_beam/m_beam, stokes2vis.py:235-280);
        # with site_latitude the beam is the parallactic-angle
        # average over the chunk's time samples (beam.py:16-83)
        from pfb_tpu_torch.utils.beam import interp_beam
        nb = int(beam_resolution)
        cell_b = max_field_of_view / nb
        bkw = {}
        if site_latitude is not None:
            bkw = dict(utime=ut, radec=(ds["ra"], ds["dec"]),
                       lat=site_latitude)
        bvals, l_b, m_b = interp_beam(ds["freq_out"], nb, nb, cell_b,
                                      btype=beam_model, **bkw)
        ds["BEAM"] = bvals
        ds["l_beam"] = l_b
        ds["m_beam"] = m_b
        datasets.append(ds)
    for f, d, s in groups:
        if fields is not None and f not in fields:
            continue
        if ddids is not None and d not in ddids:
            continue
        if scans is not None and s not in scans:
            continue
        gsel = (fid == f) & (did == d) & (sid == s)
        grow = np.where(gsel)[0]

        freq_g = freq_tab[d] if freq_tab.ndim == 2 else freq_tab
        chans = np.where((freq_g >= fmin) & (freq_g <= fmax))[0]
        if chans.size == 0:
            continue
        nchan = chans.size

        ra_f = float(fra[min(f, fra.size - 1)])
        dec_f = float(fdec[min(f, fdec.size - 1)])
        need_rephase = radec_out is not None and not np.allclose(
            (ra_f, dec_f), radec_out)
        if need_rephase:
            radec_orig = (ra_f, dec_f)
            ra_f, dec_f = radec_out

        utime = np.unique(time[grow])
        ntime = utime.size
        tbin = np.searchsorted(utime, time[grow])

        ipi = integrations_per_image
        if ipi in (0, -1, None):
            ipi = ntime
        cpi = channels_per_image
        if cpi in (0, -1, None):
            cpi = nchan

        if jones is None:
            # identity on the exact data grid
            jones_g = unity_jones(ntime, nant, nchan)
            tmap = tbin
            fsel_gain = np.arange(nchan)
        else:
            # align gains onto the data grid by (time, chan) bins
            tgrid = gain_time if gain_time is not None else utime
            fgrid = gain_freq if gain_freq is not None else freq_g
            tmap = _bin_map(tgrid, time[grow])
            fsel_gain = _bin_map(fgrid, freq_g[chans])
            jones_g = jones

        for t0 in range(0, ntime, ipi):
            tsel = (tbin >= t0) & (tbin < t0 + ipi)
            rows = grow[tsel]
            rloc = np.where(tsel)[0]

            # stream THIS chunk's big columns (bounded memory)
            slab = src.read_rows(rows, slab_cols)
            data_t = _column_expr(slab, data_column)
            uvw_t = np.asarray(slab["UVW"])
            flag_t = np.asarray(slab[flag_column]) if (
                flag_column and flag_column in slab) else \
                np.zeros(data_t.shape, bool)
            if sigma_column is not None:
                # weights from standard deviations (ref init.py:216)
                sigma = np.asarray(slab[sigma_column], np.float64)
                with np.errstate(divide="ignore"):
                    wgt_t = np.where(sigma > 0,
                                     1.0 / (sigma * sigma), 0.0)
            else:
                wcol = weight_column or "WEIGHT_SPECTRUM"
                wgt_t = np.asarray(slab[wcol]) if wcol in slab else \
                    np.ones(data_t.shape)
            if need_rephase:
                # re-reference to the common centre on the host (exact
                # fixvis-style uvw rotation + phase counter-rotation)
                from pfb_tpu_torch.utils.astrometry import rephase_to
                data_t, uvw_t = rephase_to(data_t, uvw_t, radec_orig,
                                           radec_out, freq_g)
            flag_rc = flag_t[:, chans].any(axis=-1)

            for c0 in range(0, nchan, cpi):
                cloc = np.arange(c0, min(c0 + cpi, nchan))
                csel = chans[cloc]
                jsel = fsel_gain[cloc]
                def dev(a):
                    return torch.as_tensor(np.ascontiguousarray(a)).to(
                        device)
                vis, wout = weight_data(
                    dev(data_t[:, csel]), dev(wgt_t[:, csel]),
                    dev(flag_rc[:, cloc].astype(np.uint8)),
                    dev(jones_g[:, :, jsel]), dev(tmap[rloc]),
                    dev(ant1[rows]), dev(ant2[rows]),
                    product=product, pol=pol, mode=mode)
                nxt = dict(vis=vis, wout=wout, freq_c=freq_g[csel],
                           uvw=uvw_t,
                           utime_chunk=utime[t0:t0 + ipi],
                           ra=ra_f, dec=dec_f, fieldid=int(f),
                           ddid=int(d), scanid=int(s))
                if pending is not None:
                    finish(pending)
                pending = nxt

    if pending is not None:
        finish(pending)
    return datasets
