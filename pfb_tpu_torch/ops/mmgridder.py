"""Tiling helpers of the matmul gridder that the pg gridder uses
(counterpart of the same functions in pfb_tpu/ops/mmgridder.py).

The matmul gridder itself is not ported: it was the TPU's way onto its
matrix units, and ``backend="mm"`` runs the pg gridder in the port
(ops/gridder.py:ROUTES), which computes the same R and R.H to the
gridder's epsilon on the card's own kernels. What is kept: the tile
geometry and the host-side binning of visibilities into capacity-C tile
entries.
"""

import numpy as np


def _tile_geometry(Nx, Ny, k, tile_u=None, tile_v=None):
    """(txs, tys): the smallest txs >= k with txs + k a multiple of 8,
    and tys = 128 - k, unless given; each at least k (a tile's halo
    lands on its immediate neighbour) and at most the grid."""
    if tile_u is None:
        tile_u = k + (-2 * k) % 8
    if tile_v is None:
        tile_v = max(128 - k, k)
    txs = max(min(tile_u, Nx), k)
    tys = max(min(tile_v, Ny), k)
    return txs, tys


def _bin_to_tiles(ug, vg, wplane, tx_size, ty_size, Nx, Ny, nw):
    """Host-side binning: tile id per (vis, w-plane-base); returns
    (order, sorted tile ids, ntx, nty) with tiles keyed (wplane, tx,
    ty)."""
    ntx = -(-Nx // tx_size)
    nty = -(-Ny // ty_size)
    tx = (np.mod(np.round(ug).astype(np.int64), Nx)) // tx_size
    ty = (np.mod(np.round(vg).astype(np.int64), Ny)) // ty_size
    tid = (wplane * ntx + tx) * nty + ty
    order = np.argsort(tid, kind="stable")
    return order, tid[order], ntx, nty


def _pad_tiles(order, tids, values, C):
    """Group sorted per-vis arrays into (nentries, C) padded blocks;
    tiles holding more than C visibilities split into several entries
    with the same tile id. Returns (padded arrays, entry tile ids,
    scatter map, mask, entry counts)."""
    utid, starts = np.unique(tids, return_index=True)
    counts = np.diff(np.append(starts, tids.size))
    nsplit = -(-counts // C)
    nentries = int(nsplit.sum())
    gstart = np.cumsum(np.append(0, nsplit[:-1]))
    oi = np.arange(nentries) - np.repeat(gstart, nsplit)
    entry_tid = np.repeat(utid, nsplit)
    entry_start = np.repeat(starts, nsplit) + oi * C
    entry_count = np.minimum(np.repeat(counts, nsplit) - oi * C, C)
    pos = entry_start[:, None] + np.arange(C)[None, :]
    mask = np.arange(C)[None, :] < entry_count[:, None]
    idx = order[np.minimum(pos, tids.size - 1)]
    idx[~mask] = 0
    out = []
    for v in values:
        pv = v[idx]
        pv[~mask] = 0.0
        out.append(pv)
    return out, entry_tid, idx, mask, entry_count
