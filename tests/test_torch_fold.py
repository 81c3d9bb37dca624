"""The pg fold's gather (csrc/pg_fold.cu, K5 and K8) on the CPU: the
kernel's own source enumeration (ops/pgridder.py:fold_covers, four
candidate tiles a coordinate along each axis) against an exhaustive
search of every point's covering tiles, and the gather model
(pg_fold_gather_plain: the candidates' live pairs summed in the kernel's
order) against the plain index_add_ fold
(pg_fold_gs_plain) and the JAX package's folds in Pallas interpret mode
(pgridder.py:_fold_pallas, pg_stream.py:_fold_pallas_gs), on geometries
with the periodic wrap and ragged last tiles, Nx == Thx, odd and even k,
dead tiles and an empty block. Float64 throughout: 1e-12 of max (the
sums run in different orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfb_tpu.ops import pg_stream as pgs_j
from pfb_tpu.ops import pgridder as pg_j
from pfb_tpu_torch.ops import pg_stream as pgs_t
from pfb_tpu_torch.ops import pgridder as pg_t
from pfb_tpu_torch.ops.pgridder import fold_covers, pg_fold_gather_plain

torch.set_num_threads(1)

# (Nx, Ny, txs, tys, k, dead share): ragged last tiles and the wrap,
# Nx == Thx (Nx = 16 = 10 + 6), a grid that is a multiple of the tiles,
# odd and even k, k = txs, an empty block
GEOMS = [(64, 64, 13, 13, 7, 0.3), (64, 60, 10, 10, 4, 0.3),
         (16, 16, 10, 10, 6, 0.0), (16, 24, 10, 12, 6, 0.5),
         (60, 48, 12, 12, 8, 0.3), (48, 40, 9, 11, 5, 0.5),
         (40, 64, 13, 21, 3, 0.2), (35, 33, 7, 11, 7, 0.4),
         (64, 64, 13, 13, 7, 1.0)]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _case(Nx, Ny, txs, tys, k, dead, nq=3, seed=0):
    """Y (nq, NS, Thx, Thy) float64 and the live tiles (sorted) from a
    seed; NS = live tiles + 2 (two slots no tile uses)."""
    rng = np.random.default_rng(seed + Nx + Ny + k)
    ntx, nty = -(-Nx // txs), -(-Ny // tys)
    tiles = np.flatnonzero(rng.random(ntx * nty) >= dead)
    Y = rng.normal(size=(nq, tiles.size + 2, txs + k, tys + k))
    return Y, tiles, dict(ntx=ntx, nty=nty, txs=txs, tys=tys, k=k, Nx=Nx,
                          Ny=Ny)


def _tslot(tiles, ntiles, slots):
    t = np.full(ntiles, -1, np.int32)
    t[tiles] = slots
    return torch.as_tensor(t)


# ---------------------------------------------------------------------
# the candidates


@pytest.mark.parametrize("N,ts,k", [(64, 13, 7), (16, 10, 6), (60, 12, 8),
                                    (33, 11, 7), (35, 7, 7), (4096, 25, 7),
                                    (8192, 249, 7), (20, 10, 8)])
def test_fold_covers_are_every_cover(N, ts, k):
    """For every grid coordinate the valid candidates are exactly the
    (tile, offset) pairs of an exhaustive search over tiles and wraps
    (tile t's block of ts + k holds X at offset (X + k/2) + m N - t ts), at
    most three of them, each once."""
    ntile, Th, h = -(-N // ts), ts + k, k // 2
    t, i, ok = (a.numpy() for a in fold_covers(N, ntile, ts, Th, h))
    assert t.shape == (4, N)
    for X in range(N):
        want = {(tt, X + h + m * N - tt * ts) for m in range(-2, 4)
                for tt in range(ntile) if 0 <= X + h + m * N - tt * ts < Th}
        got = [(t[c, X], i[c, X]) for c in range(4) if ok[c, X]]
        assert len(got) == len(set(got)) <= 3
        assert set(got) == want, X


# ---------------------------------------------------------------------
# the gather model


@pytest.mark.parametrize("geom", GEOMS)
def test_gather_model_matches_index_add_plain(geom):
    """The gather model against the plain fold (index_add_ of every live
    slot at its periodic positions), slots in a shuffled order with two
    slots no tile uses; an empty block gives zeros."""
    Y, tiles, kw = _case(*geom)
    slots = np.random.default_rng(1).permutation(Y.shape[1])[:tiles.size]
    tslot = _tslot(tiles, kw["ntx"] * kw["nty"], slots)
    Yt = torch.as_tensor(Y)
    got = pg_fold_gather_plain(Yt, tslot, **kw)
    ref = pgs_t.pg_fold_gs_plain(Yt, tslot, **{
        key: kw[key] for key in ("nty", "txs", "tys", "k", "Nx", "Ny")})
    assert got.shape == (Y.shape[0], kw["Nx"], kw["Ny"])
    if tiles.size:
        assert _rel(got, ref) <= 1e-12
    else:
        assert not got.any() and not ref.any()


@pytest.mark.parametrize("geom", GEOMS)
def test_gather_model_matches_jax_fold_pallas(geom):
    """The gather model against the JAX fold (pgridder.py:_fold_pallas,
    interpret mode) with slot s holding tile ltid[s] where lflag[s]."""
    Y, tiles, kw = _case(*geom)
    NS = Y.shape[1]
    ltid = np.zeros(NS, np.int32)
    lflag = np.zeros(NS, np.int32)
    ltid[:tiles.size], lflag[:tiles.size] = tiles, 1
    ref = np.asarray(pg_j._fold_pallas(
        jnp.asarray(Y), jnp.asarray(ltid), jnp.asarray(lflag),
        nw=Y.shape[0], interpret=True, **kw))
    got = pg_fold_gather_plain(
        torch.as_tensor(Y), _tslot(tiles, kw["ntx"] * kw["nty"],
                                   np.arange(tiles.size)), **kw)
    if tiles.size:
        assert _rel(got, ref) <= 1e-12
    else:
        assert not got.any() and not np.asarray(ref).any()


@pytest.mark.parametrize("geom", GEOMS)
def test_gather_model_matches_jax_fold_pallas_gs(geom):
    """The gather model against the JAX blocked fold
    (pg_stream.py:_fold_pallas_gs, interpret mode) on the slot layout the
    JAX plan builds for one block (pg_stream.py:_block_maps: colour-major,
    runs padded to FOLD_G), which the port's tile -> slot table
    inverts."""
    Y0, tiles, kw = _case(*geom)
    G = pgs_t.FOLD_G
    n = tiles.size
    _, _, _, ltid, lflag, *_ = pgs_j._block_maps(
        tiles, np.zeros(n, np.int64), np.zeros(n, np.int64),
        np.zeros(n, np.int64), 1, 1, kw["ntx"], kw["nty"], kw["txs"],
        kw["tys"], kw["k"], G)
    ltid, lflag = ltid[0], lflag[0]
    NT = ltid.size
    rng = np.random.default_rng(2)
    Y = rng.normal(size=(Y0.shape[0], NT) + Y0.shape[2:])
    ref = np.asarray(pgs_j._fold_pallas_gs(
        jnp.asarray(Y), jnp.asarray(ltid.astype(np.int32)),
        jnp.asarray(lflag.astype(np.int32)), nw=Y.shape[0], G=G,
        interpret=True, **kw))
    live = np.flatnonzero(lflag)
    tslot = _tslot(ltid[live], kw["ntx"] * kw["nty"], live)
    got = pg_fold_gather_plain(torch.as_tensor(Y), tslot, **kw)
    if n:
        assert _rel(got, ref) <= 1e-12
    else:
        assert not got.any() and not np.asarray(ref).any()


def test_cpu_wrappers_match_the_gather_model():
    """pg_fold / pg_fold_gs on CPU tensors run the plain fold (no launch
    counted), which the gather model matches."""
    Y, tiles, kw = _case(64, 64, 13, 13, 7, 0.3, seed=4)
    Yt = torch.as_tensor(Y)
    tslot = _tslot(tiles, kw["ntx"] * kw["nty"], np.arange(tiles.size))
    n0 = (pg_t.pg_fold.launches, pgs_t.pg_fold_gs.launches)
    a = pgs_t.pg_fold_gs(Yt, tslot, **kw)
    NS = Y.shape[1]
    live = torch.zeros(NS, dtype=torch.bool)
    live[:tiles.size] = True
    tile = torch.zeros(NS, dtype=torch.long)
    tile[:tiles.size] = torch.as_tensor(tiles)
    b = pg_t.pg_fold(Yt, dict(tslot=tslot, NS=NS, tile=tile, live=live),
                     **kw)
    assert (pg_t.pg_fold.launches, pgs_t.pg_fold_gs.launches) == n0
    model = pg_fold_gather_plain(Yt, tslot, **kw)
    assert _rel(a, model) <= 1e-12 and _rel(b, model) <= 1e-12
