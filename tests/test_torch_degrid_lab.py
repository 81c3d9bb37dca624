"""The degrid lab's entry (pg_stream.pg_degrid_lab, csrc/lab_degrid.cu) on
the CPU: it runs the plain degrids K6 / K9 there, whatever the design
(the designs differ only on the card, where tests/test_torch_gpu.py holds
them against each other bit for bit), and the skeletons, which have no
plain version, need the card."""

import pytest
import torch

from pfb_tpu_torch.ops import pg_stream as pgs
from pfb_tpu_torch.ops import pgridder as pg
from pfb_tpu_torch.utils.simulation import image_size_for, simulate_obs

torch.set_num_threads(1)


def _obs(seed=3):
    obs = simulate_obs(nant=8, ntime=6, nchan=2, seed=seed)
    _, cell = image_size_for(obs, fov_deg=1.0)
    return obs, cell


def _grids(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g, dtype=torch.float64),
            torch.randn(shape, generator=g, dtype=torch.float64))


# (epsilon -> k, w gridding, capacity): the paths' k = 7, k = 5 and 9,
# one plane, and a capacity of 8, which puts many entries on one tile
K6_CASES = [(1e-5, True, 128), (1e-3, True, 128), (1e-7, True, 128),
            (1e-5, False, 128), (1e-5, True, 8)]


@pytest.mark.parametrize("eps,do_w,cap", K6_CASES)
def test_lab_runs_k6s_plain_degrid_on_the_cpu(eps, do_w, cap):
    obs, cell = _obs()
    p = pg.pgrid_plan(obs.uvw, obs.freq, nx=64, ny=64, cellx=cell,
                      celly=cell, epsilon=eps, do_wgridding=do_w,
                      capacity=cap, device="cpu")
    assert (p["nw"] > 1) == do_w
    if cap == 8:  # many entries on one tile
        _, runs = torch.unique_consecutive(p["tid"], return_counts=True)
        assert int(runs.max()) > 1
    gr, gi = _grids((p["nw"], p["Nx"], p["Ny"]), 0)
    kw = dict(beta=p["beta"], k=p["k"], nw=p["nw"], txs=p["txs"],
              tys=p["tys"], nty=p["nty"])
    got = pgs.pg_degrid_lab(gr, gi, p["pos"], p["tid"], **kw)
    assert torch.equal(got, pg.pg_degrid_plain(gr, gi, p["pos"], p["tid"],
                                               **kw))


@pytest.mark.parametrize("eps", [1e-5, 1e-7])
def test_lab_runs_k9s_plain_degrid_on_the_cpu(eps):
    """Every live block of a w-blocked plan added in block order into one
    nonzero accumulator, as the blocked forward does: entries that reach
    two or more blocks take each block's sum in turn."""
    obs, cell = _obs()
    bp = pgs.pgrid_plan_wblocked(obs.uvw, obs.freq, nx=64, ny=64,
                                 cellx=cell, celly=cell, epsilon=eps,
                                 plane_block=2, device="cpu")
    p0, B = bp["p0"], bp["B"]
    maps = [bp["gmap"][b, :int(bp["nelive"][b])]
            for b in range(bp["nblocks"])]
    reached = torch.bincount(torch.cat(maps).long(),
                             minlength=bp["NEg"] + 1)
    assert int(reached.max()) >= 2
    g = torch.Generator().manual_seed(1)
    acc0 = torch.randn((bp["NEg"] + 1, 2, p0["C"]), generator=g,
                       dtype=torch.float64)
    got, ref = acc0.clone(), acc0.clone()
    kw = dict(beta=p0["beta"], k=p0["k"], txs=p0["txs"], tys=p0["tys"],
              nty=p0["nty"])
    for b, gmap in enumerate(maps):
        if not gmap.numel():
            continue
        gr, gi = _grids((B, p0["Nx"], p0["Ny"]), 10 + b)
        woff = int(bp["woff"][b, 0])
        out = pgs.pg_degrid_lab(gr, gi, bp["pos"], bp["utid"], gmap=gmap,
                                acc=got, woff=woff, nw=B, **kw)
        assert out is got
        pgs.pg_degrid_gs_plain(gr, gi, bp["pos"], bp["utid"], gmap, ref,
                               woff=woff, B=B, **kw)
    assert torch.equal(got, ref)


def test_lab_refuses_skeletons_on_the_cpu_and_unknown_names():
    g = torch.zeros((1, 64, 64))
    pos = torch.zeros((1, 8, 4))
    tid = torch.zeros(1, dtype=torch.int32)
    kw = dict(beta=2.3, k=7, nw=1, txs=9, tys=57, nty=1)
    for mode in pgs.DEGRID_MODES[1:]:
        with pytest.raises(ValueError):
            pgs.pg_degrid_lab(g, g, pos, tid, mode=mode, **kw)
    with pytest.raises(ValueError):
        pgs.pg_degrid_lab(g, g, pos, tid, design="tiles", **kw)
    with pytest.raises(ValueError):
        pgs.pg_degrid_lab(g, g, pos, tid, mode="stores", **kw)
    with pytest.raises(ValueError):  # grids of another plane count
        pgs.pg_degrid_lab(g, g, pos, tid, **dict(kw, nw=2))
    with pytest.raises(ValueError):  # K9 needs its accumulator
        pgs.pg_degrid_lab(g, g, pos, tid, gmap=tid, **kw)
    with pytest.raises(ValueError):  # of the stream's shape
        pgs.pg_degrid_lab(g, g, pos, tid, gmap=tid,
                          acc=torch.zeros((1, 2, 5)), **kw)
