"""The spread lab's entry (pg_stream.pg_spread_lab, csrc/lab_spread.cu) on
the CPU: both designs run the plain spreads K4 / K7 there, and the
skeletons, which have no plain version, need the card."""

import pytest
import torch

from pfb_tpu_torch.ops import pg_stream as pgs
from pfb_tpu_torch.ops import pgridder as pg
from pfb_tpu_torch.utils.simulation import image_size_for, simulate_obs

torch.set_num_threads(1)


def _obs():
    obs = simulate_obs(nant=8, ntime=6, nchan=2, seed=3)
    _, cell = image_size_for(obs, fov_deg=1.0)
    return obs, cell


@pytest.mark.parametrize("design", sorted(pgs.SPREAD_DESIGNS))
def test_lab_runs_k4s_plain_spread_on_the_cpu(design):
    obs, cell = _obs()
    p = pg.pgrid_plan(obs.uvw, obs.freq, nx=64, ny=64, cellx=cell,
                      celly=cell, epsilon=1e-5, device="cpu")
    k, nw, txs, tys = p["k"], p["nw"], p["txs"], p["tys"]
    slots = pg._compact_slots(p["tid"], p["pm"], p["ntx"], p["nty"], txs,
                              tys, k)
    g = torch.Generator().manual_seed(0)
    vis = torch.randn((p["nentries"], 2, p["C"]), generator=g,
                      dtype=p["pos"].dtype) * p["pm"][:, None]
    kw = dict(beta=p["beta"], k=k, nw=nw, Thx=txs + k, Thy=tys + k)
    got = pgs.pg_spread_lab(p["pos"], vis, slots["start"], slots["count"],
                            design=design, **kw)
    ref = pg.pg_spread_plain(p["pos"], vis, slots, **kw)
    live = slots["live"]
    assert torch.equal(got[:, :, live], ref[:, :, live])


@pytest.mark.parametrize("design", sorted(pgs.SPREAD_DESIGNS))
def test_lab_runs_k7s_plain_spread_on_the_cpu(design):
    obs, cell = _obs()
    bp = pgs.pgrid_plan_wblocked(obs.uvw, obs.freq, nx=64, ny=64,
                                 cellx=cell, celly=cell, epsilon=1e-5,
                                 plane_block=2, device="cpu")
    p0, B = bp["p0"], bp["B"]
    k = p0["k"]
    b = int(bp["nelive"].argmax())
    gmap = bp["gmap"][b, :int(bp["nelive"][b])]
    st, ct = bp["start"][b], bp["count"][b]
    g = torch.Generator().manual_seed(1)
    vis = torch.randn((bp["NEg"] + 1, 2, p0["C"]), generator=g,
                      dtype=bp["pos"].dtype) * bp["gpm"][:, None]
    kw = dict(woff=int(bp["woff"][b, 0]), beta=p0["beta"], k=k,
              Thx=p0["txs"] + k, Thy=p0["tys"] + k)
    got = pgs.pg_spread_lab(bp["pos"], vis, st, ct, gmap=gmap, nw=B,
                            design=design, **kw)
    ref = pgs.pg_spread_gs_plain(bp["pos"], vis, gmap, st, ct, B=B, **kw)
    assert torch.equal(got, ref)


def test_lab_refuses_skeletons_on_the_cpu_and_unknown_names():
    pos = torch.zeros((1, 8, 4))
    vis = torch.zeros((1, 2, 4))
    st = torch.zeros(1, dtype=torch.int32)
    ct = torch.ones(1, dtype=torch.int32)
    kw = dict(beta=2.3, k=7, nw=1, Thx=16, Thy=32)
    with pytest.raises(ValueError):
        pgs.pg_spread_lab(pos, vis, st, ct, mode="no FMA", **kw)
    with pytest.raises(ValueError):
        pgs.pg_spread_lab(pos, vis, st, ct, design="tree", **kw)
    with pytest.raises(ValueError):
        pgs.pg_spread_lab(pos, vis[:, :1], st, ct, **kw)
