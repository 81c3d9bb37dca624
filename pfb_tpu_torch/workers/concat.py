"""Dataset concatenation along row (time) and channel (band) axes: a
host copy of pfb_tpu/workers/concat.py (numpy only), so the port imports
nothing of pfb_tpu.

Equivalents of concat_row / concat_chan (reference:
pfb/utils/misc.py:776-987): concat_row merges all time chunks of a band
into one dataset (wsum-weighted beam); concat_chan maps nband_in
frequency chunks onto nband_out coarser bands by concatenating the
channel axes of datasets sharing a time chunk.
"""

import numpy as np


def concat_row(xds):
    """Merge datasets of equal freq_out across time chunks."""
    freqs = np.unique([ds["freq_out"] for ds in xds])
    times = np.unique([ds["time_out"] for ds in xds])
    if times.size == 1:
        return xds
    out = []
    for nu in freqs:
        group = [ds for ds in xds if ds["freq_out"] == nu]
        group = sorted(group, key=lambda d: d["time_out"])
        ds0 = dict(group[0])
        ds0["VIS"] = np.concatenate([d["VIS"] for d in group], axis=0)
        ds0["WEIGHT"] = np.concatenate([d["WEIGHT"] for d in group],
                                       axis=0)
        ds0["MASK"] = np.concatenate([d["MASK"] for d in group], axis=0)
        ds0["UVW"] = np.concatenate([d["UVW"] for d in group], axis=0)
        ds0["time_out"] = float(np.mean([d["time_out"] for d in group]))
        ds0["time_min"] = float(min(d.get("time_min", d["time_out"])
                                    for d in group))
        ds0["time_max"] = float(max(d.get("time_max", d["time_out"])
                                    for d in group))
        out.append(ds0)
    return out


def concat_chan(xds, nband_out):
    """Re-bin the frequency axis onto nband_out bands.

    Datasets sharing a time chunk are combined on the UNION of their
    channel grids: channels appearing in more than one dataset (e.g.
    overlapping spectral windows of different DDIDs) are summed with
    their weights, vis = sum(w v) / sum(w), w = sum(w) — the weighted
    overlap-sum of reference sum_overlap (utils/misc.py:1030-1067).
    Datasets in a group must share the row set (same rows/UVW).
    """
    times = np.unique([ds["time_out"] for ds in xds])
    out = []
    for t in times:
        tgroup = sorted([ds for ds in xds if ds["time_out"] == t],
                        key=lambda d: d["freq_out"])
        nrow = tgroup[0]["VIS"].shape[0]
        for d in tgroup[1:]:
            if d["VIS"].shape[0] != nrow or not np.array_equal(
                    d["UVW"], tgroup[0]["UVW"]):
                raise ValueError(
                    "concat_chan: datasets in a time chunk must share "
                    "the same rows/UVW")
        # union channel grid across the group
        ufreq = np.unique(np.concatenate([d["FREQ"] for d in tgroup]))
        if nband_out > ufreq.size:
            raise ValueError(
                f"Cannot split {ufreq.size} channels into "
                f"{nband_out} bands")
        edges = np.linspace(0, ufreq.size, nband_out + 1).astype(int)
        for b in range(nband_out):
            bfreq = ufreq[edges[b]:edges[b + 1]]
            if bfreq.size == 0:
                continue
            wv = np.zeros((nrow, bfreq.size), np.complex128)
            ws = np.zeros((nrow, bfreq.size))
            touched = False
            for d in tgroup:
                sel = np.isin(d["FREQ"], bfreq)
                if not sel.any():
                    continue
                touched = True
                # channels are unique within one dataset, so plain
                # fancy-index accumulation is safe (no duplicate idx)
                idx = np.searchsorted(bfreq, d["FREQ"][sel])
                w = d["WEIGHT"][:, sel] * d["MASK"][:, sel]
                ws[:, idx] += w
                wv[:, idx] += w * d["VIS"][:, sel]
            if not touched:
                continue
            ds0 = dict(tgroup[0])
            ds0["VIS"] = np.where(ws > 0, wv / np.where(ws > 0, ws, 1.0),
                                  0.0)
            ds0["WEIGHT"] = ws
            ds0["MASK"] = (ws > 0).astype(tgroup[0]["MASK"].dtype)
            ds0["FREQ"] = bfreq
            ds0["freq_out"] = float(np.mean(bfreq))
            ds0["freq_min"] = float(bfreq.min())
            ds0["freq_max"] = float(bfreq.max())
            out.append(ds0)
    return out
