"""pfb_tpu_torch's pg gridder (ops/pgridder.py, ops/gridder.py pg
branches) against pfb_tpu on the same numpy inputs, CPU, float64.

- plans and tile choices: identical (the same host code, native or
  numpy);
- the plain spread+fold (K4+K5) against the JAX package's
  _spread_fold with its Pallas kernels in interpret mode: 1e-12
  relative (the two sum in different orders);
- the plain degrid (K6) against JAX _degrid_pallas in interpret mode:
  1e-12 relative;
- the operators and Hessians against JAX's: 1e-10 relative; against the
  exact DFT oracle: 1e-6 (the gridding error at epsilon = 1e-7);
- adjointness in the port: 1e-12 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfb_tpu.ops import gridder as gridder_j
from pfb_tpu.ops import pgridder as pg_j
from pfb_tpu.utils.simulation import image_size_for, simulate_obs
from pfb_tpu_torch.ops import dft as dft_t
from pfb_tpu_torch.ops import gridder as gridder_t
from pfb_tpu_torch.ops import pgridder as pg_t

torch.set_num_threads(1)
pmp = pytest.mark.parametrize
NX = 64


@pytest.fixture(scope="module")
def obs():
    o = simulate_obs(nant=7, ntime=6, nchan=2, seed=3)
    _, cell = image_size_for(o, fov_deg=0.2)
    rng = np.random.default_rng(0)
    shape = (o.uvw.shape[0], o.freq.size)
    return dict(uvw=o.uvw, freq=o.freq, cell=cell,
                vis=rng.normal(size=shape) + 1j * rng.normal(size=shape),
                wgt=rng.random(shape), img=rng.normal(size=(NX, NX)))


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / \
        np.abs(np.asarray(b)).max()


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _plans(obs, **kw):
    c = obs["cell"]
    args = dict(nx=NX, ny=NX, cellx=c, celly=c, **kw)
    return (pg_j.pgrid_plan(obs["uvw"], obs["freq"], **args),
            pg_t.pgrid_plan(obs["uvw"], obs["freq"], **args))


_PLAN_KEYS = ("k", "beta", "Nx", "Ny", "nw", "w0", "dw", "ntx", "nty",
              "txs", "tys", "C", "nentries", "nx", "ny", "cellx", "celly",
              "x0", "y0", "nrow", "nchan")


@pmp("kw", [dict(epsilon=1e-7), dict(epsilon=1e-5, do_wgridding=False),
            dict(epsilon=1e-5, x0=1e-3, y0=-2e-3, capacity=32),
            dict(epsilon=1e-7, w_params=(20, -40.0, 5.0)),
            dict(epsilon=1e-7, nentries_to=64),
            dict(epsilon=1e-5, tile_u=25, tile_v=249)])
def test_pgrid_plan_matches_jax(obs, kw):
    pj, pt = _plans(obs, **kw)
    for key in _PLAN_KEYS:
        assert pt[key] == pj[key], key
    assert pt["rdtype"] == torch.float64
    for key in ("pos", "tid", "idx", "pm", "uvw_d", "freq_d"):
        np.testing.assert_array_equal(pt[key].numpy(), np.asarray(pj[key]),
                                      err_msg=key)
    assert pt["tid"].dtype == pt["idx"].dtype == torch.int32


def test_pgrid_plan_numpy_builder_matches_native(obs, monkeypatch):
    """The numpy twin of the native builder gives the same plan."""
    from pfb_tpu_torch import native
    if native.get_lib() is None:
        pytest.skip("no C++ compiler")
    _, nat = _plans(obs, epsilon=1e-7)
    monkeypatch.setattr(pg_t, "pg_plan_native", lambda *a, **k: None)
    _, npy = _plans(obs, epsilon=1e-7)
    for key in ("pos", "tid", "idx", "pm"):
        assert torch.equal(nat[key], npy[key]), key


@pmp("nx,k,C,seed", [(1024, 7, 128, 0), (2048, 9, 128, 1),
                     (256, 7, 64, 2)])
def test_auto_tiles_matches_jax(nx, k, C, seed):
    rng = np.random.default_rng(seed)
    uvw = rng.normal(scale=200.0, size=(3000, 3))
    freq = np.linspace(0.9e9, 1.1e9, 3)
    cell = 1.0 / (2.0 * np.abs(uvw[:, :2]).max() * freq[-1] / 299792458.0)
    Nx = 2 * nx
    got = pg_t._auto_tiles(uvw, freq, Nx, Nx, cell / 2, cell / 2, k, C)
    assert got == pg_j._auto_tiles(uvw, freq, Nx, Nx, cell / 2, cell / 2, k,
                                   C)


def _spread_fold_args(p):
    return (p["tid"], p["pos"], p["idx"], p["pm"], p["uvw_d"],
            p["freq_d"])


def _statics(p):
    return dict(beta=p["beta"], k=p["k"], nw=p["nw"], ntx=p["ntx"],
                nty=p["nty"], txs=p["txs"], tys=p["tys"], C=p["C"],
                x0=p["x0"], y0=p["y0"], Nx=p["Nx"], Ny=p["Ny"])


@pmp("eps,do_w,shift", [(1e-7, False, False), (1e-7, True, False),
                         (1e-7, True, True), (1e-5, False, True),
                         (1e-5, True, False)])
def test_spread_fold_plain_matches_jax_interpret(obs, eps, do_w, shift):
    """Plain K4+K5 against JAX _spread_fold (Pallas kernels in interpret
    mode) on the same plan and weighted visibilities: 1e-12."""
    x0, y0 = (1e-3, -2e-3) if shift else (0.0, 0.0)
    pj, _ = _plans(obs, epsilon=eps, do_wgridding=do_w, x0=x0, y0=y0)
    pt = pg_t.plan_from_jax(pj)
    vr, vi, w = obs["vis"].real, obs["vis"].imag, obs["wgt"]
    ref = pg_j._spread_fold(jnp.asarray(vr), jnp.asarray(vi),
                            jnp.asarray(w), *_spread_fold_args(pj),
                            interpret=True, **_statics(pj))
    got = pg_t._spread_fold(_t(vr), _t(vi), _t(w), *_spread_fold_args(pt),
                            **_statics(pt))
    assert got.shape == (2 * pt["nw"], pt["Nx"], pt["Ny"])
    assert _rel(got.numpy(), ref) < 1e-12


@pmp("eps,do_w", [(1e-7, False), (1e-7, True), (1e-5, True)])
def test_degrid_plain_matches_jax_interpret(obs, eps, do_w):
    """Plain K6 against JAX _degrid_pallas (interpret mode) on the same
    plan and random w-plane grids: 1e-12."""
    pj, _ = _plans(obs, epsilon=eps, do_wgridding=do_w)
    pt = pg_t.plan_from_jax(pj)
    k, nw, txs, tys = pj["k"], pj["nw"], pj["txs"], pj["tys"]
    rng = np.random.default_rng(7)
    gr = rng.normal(size=(nw, pj["Nx"], pj["Ny"]))
    gi = rng.normal(size=gr.shape)
    ThxA = -(-(txs + k + 7) // 8) * 8
    ThyA = -(-(tys + k + 127) // 128) * 128
    pad = ((0, 0), (0, ThxA), (0, ThyA))
    pos = pj["pos"]
    sx = pos[:, 5, 0].astype(jnp.int32)
    sy = pos[:, 6, 0].astype(jnp.int32)
    ref = pg_j._degrid_pallas(pj["tid"], sx // 8, sy // 128, pos,
                              jnp.pad(jnp.asarray(gr), pad, mode="wrap"),
                              jnp.pad(jnp.asarray(gi), pad, mode="wrap"),
                              pj["beta"], k, nw, ThxA, ThyA, pj["C"],
                              interpret=True, pm=pj["pm"])
    got = pg_t.pg_degrid(_t(gr), _t(gi), pt["pos"], pt["tid"],
                         beta=pt["beta"], k=k, nw=nw, txs=txs, tys=tys,
                         nty=pt["nty"])
    pm = pt["pm"][:, None]
    assert _rel((got * pm).numpy(), np.asarray(ref) * np.asarray(pm)) < 1e-12


@pmp("shift", [False, True])
@pmp("do_w", [False, True])
def test_pg_operators_match_jax(obs, do_w, shift):
    c = obs["cell"]
    x0, y0 = (1e-3, -2e-3) if shift else (0.0, 0.0)
    eps = 1e-5 if shift else 1e-7
    kw = dict(nx=NX, ny=NX, cellx=c, celly=c, epsilon=eps,
              do_wgridding=do_w, x0=x0, y0=y0)
    ref = pg_j.vis2dirty_pg(obs["uvw"], obs["freq"], obs["vis"],
                            wgt=obs["wgt"], **kw)
    got = pg_t.vis2dirty_pg(_t(obs["uvw"]), _t(obs["freq"]),
                            _t(obs["vis"]), wgt=_t(obs["wgt"]), **kw)
    assert _rel(got.numpy(), ref) < 1e-10
    dkw = dict(epsilon=eps, do_wgridding=do_w, x0=x0, y0=y0)
    ref = pg_j.dirty2vis_pg(obs["uvw"], obs["freq"],
                            jnp.asarray(obs["img"]), c, c, **dkw)
    got = pg_t.dirty2vis_pg(_t(obs["uvw"]), _t(obs["freq"]), _t(obs["img"]),
                            c, c, **dkw)
    assert _rel(got.numpy(), ref) < 1e-10


@pmp("do_w", [False, True])
def test_pg_operators_match_dft(obs, do_w):
    c = obs["cell"]
    uvw, freq = _t(obs["uvw"]), _t(obs["freq"])
    kw = dict(nx=NX, ny=NX, cellx=c, celly=c)
    ref = dft_t.vis2dirty_dft(uvw, freq, _t(obs["vis"]), wgt=_t(obs["wgt"]),
                              do_wterm=do_w, **kw)
    got = pg_t.vis2dirty_pg(uvw, freq, _t(obs["vis"]), wgt=_t(obs["wgt"]),
                            epsilon=1e-7, do_wgridding=do_w, **kw)
    assert _rel(got.numpy(), ref.numpy()) < 1e-6
    ref = dft_t.dirty2vis_dft(uvw, freq, _t(obs["img"]), c, c,
                              do_wterm=do_w)
    got = pg_t.dirty2vis_pg(uvw, freq, _t(obs["img"]), c, c, epsilon=1e-7,
                            do_wgridding=do_w)
    assert _rel(got.numpy(), ref.numpy()) < 1e-6


@pmp("shift", [False, True])
def test_pg_adjointness(obs, shift):
    """<R x, v> = <x, R^H v> (real part of the complex inner product)."""
    c = obs["cell"]
    x0, y0 = (2e-3, 1e-3) if shift else (0.0, 0.0)
    _, p = _plans(obs, epsilon=1e-5, x0=x0, y0=y0)
    x, v = _t(obs["img"]), _t(obs["vis"])
    rx = pg_t.dirty2vis_pg(None, None, x, c, c, plan=p)
    rhv = pg_t.vis2dirty_pg(None, None, v, nx=NX, ny=NX, cellx=c, celly=c,
                            plan=p)
    lhs = float((rx.conj() * v).real.sum())
    rhs = float((x * rhv).sum())
    assert abs(lhs - rhs) < 1e-12 * abs(rhs)


def _datasets(obs, nband=2, ndata=2, seed=11):
    """nband x ndata datasets with ragged row counts from one
    observation."""
    rng = np.random.default_rng(seed)
    nrow = obs["uvw"].shape[0]
    cuts = np.sort(rng.choice(np.arange(10, nrow - 10), nband * ndata - 1,
                              replace=False))
    dds = []
    for i, rows in enumerate(np.split(np.arange(nrow), cuts)):
        shape = (rows.size, obs["freq"].size)
        mask = (rng.random(shape) > 0.1).astype(np.float64)
        dds.append(dict(UVW=obs["uvw"][rows],
                        FREQ=obs["freq"] * (1 + 0.05 * i),
                        WEIGHT=rng.random(shape), MASK=mask,
                        bandid=i % nband, cell_rad=obs["cell"]))
    return dds


def test_make_hessian_pg_matches_jax(obs):
    pj, pt = _plans(obs, epsilon=1e-7, x0=1e-3)
    hj = pg_j.make_hessian_pg(pj, wgt=obs["wgt"])
    ht = pg_t.make_hessian_pg(pt, wgt=obs["wgt"])
    assert _rel(ht(_t(obs["img"])).numpy(),
                hj(jnp.asarray(obs["img"]))) < 1e-10


def test_stacked_hessian_matches_jax(obs):
    """2 bands x 2 datasets with ragged rows: shared w grid and tiles;
    the port does not pad rows or entries."""
    dds = _datasets(obs)
    x = np.random.default_rng(3).normal(size=(2, NX, NX))
    kw = dict(epsilon=1e-7, do_wgridding=True)
    hj = pg_j.make_hessian_pg_stacked(dds, 2, 3.0, NX, NX, sigmainv=0.1,
                                      **kw)
    ht = pg_t.make_hessian_pg_stacked(dds, 2, 3.0, NX, NX, sigmainv=0.1,
                                      **kw)
    assert len({(p["nw"], p["w0"], p["txs"]) for p in ht.plans}) == 1
    assert _rel(ht(_t(x)).numpy(), hj(jnp.asarray(x))) < 1e-10


@pmp("ndata", [1, 4])
def test_make_hessian_dds_pg_plans_with_callers_epsilon(obs, ndata):
    """The pg residual plans with the epsilon it is given (k = 7 at
    1e-5, as the JAX package's pg branches do), not the 1e-7 (k = 9)
    of the wgrid path's hessian_dds."""
    dds = _datasets(obs)[:ndata] if ndata > 1 else \
        [dict(_datasets(obs)[0], bandid=0)]
    nband = 2 if ndata > 1 else 1
    x = np.random.default_rng(4).normal(size=(nband, NX, NX))
    kw = dict(backend="pg", epsilon=1e-5, do_wgridding=True)
    ht = gridder_t.make_hessian_dds(dds, nband, 2.0, NX, NX, **kw)
    assert [p["k"] for p in ht.plans] == [7] * ndata
    hj = gridder_j.make_hessian_dds(dds, nband, 2.0, NX, NX, **kw)
    assert _rel(ht(_t(x)).numpy(), hj(jnp.asarray(x))) < 1e-10
