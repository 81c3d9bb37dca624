"""pfb_tpu_torch's w-plane-blocked pg engine (ops/pg_stream.py, the
make_hessian_dds plane_block branch) against pfb_tpu on the same numpy
inputs, CPU, float64.

- plans: identical arrays and keys (the same host code, native or
  numpy), and the native global-stream builder bit-identical to its
  numpy twin;
- the plain spread+fold (K7+K8) and degrid (K9) of every block against
  the JAX package's Pallas kernels in interpret mode: 1e-12 relative
  (the two sum in different orders);
- the blocked adjoint, forward and Hessian against JAX's blocked
  operators and against the port's unblocked ones: 1e-10 relative;
- adjointness: 1e-12 relative;
- every public device parameter of the port defaults to the card when
  there is one.
"""

import importlib
import inspect
import pkgutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pfb_tpu_torch
from pfb_tpu.ops import gridder as gridder_j
from pfb_tpu.ops import pg_stream as pgs_j
from pfb_tpu.utils.simulation import image_size_for, simulate_obs
from pfb_tpu_torch.ops import gridder as gridder_t
from pfb_tpu_torch.ops import pg_stream as pgs_t
from pfb_tpu_torch.ops import pgridder as pg_t

torch.set_num_threads(1)
pmp = pytest.mark.parametrize
NX = 64
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def obs():
    o = simulate_obs(nant=7, ntime=6, nchan=2, seed=3)
    _, cell = image_size_for(o, fov_deg=0.2)
    rng = np.random.default_rng(0)
    shape = (o.uvw.shape[0], o.freq.size)
    return dict(uvw=o.uvw, freq=o.freq, cell=cell,
                vr=rng.normal(size=shape), vi=rng.normal(size=shape),
                wgt=rng.random(shape), img=rng.normal(size=(NX, NX)))


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / \
        np.abs(np.asarray(b)).max()


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _fine_w(obs, epsilon):
    """A w grid 12 times finer than the observation's w range (the
    default one spans it with one plane), so that each entry reaches only
    some blocks and the block maps differ."""
    k, _ = pg_t.kernel_params(epsilon)
    ws = obs["uvw"][:, 2:3] * obs["freq"][None] / pg_t.LIGHTSPEED
    dw = (ws.max() - ws.min()) / 12
    w0 = ws.min() - (k / 2) * dw
    return int(np.ceil((ws.max() - w0) / dw + k / 2)) + 1, w0, dw


def _plans(obs, fine=False, **kw):
    c = obs["cell"]
    if fine:
        kw["w_params"] = _fine_w(obs, kw["epsilon"])
    args = dict(nx=NX, ny=NX, cellx=c, celly=c, plane_block=3, **kw)
    return (pgs_j.pgrid_plan_wblocked(obs["uvw"], obs["freq"], **args),
            pgs_t.pgrid_plan_wblocked(obs["uvw"], obs["freq"], device=CPU,
                                      **args))


_META = ("B", "nblocks", "nw", "w0", "dw", "nrow", "nchan", "NEg", "NEb",
         "NT", "G")
_ARRAYS = ("pos", "gidx", "gpm", "gmap", "tp", "sxy", "ltid", "lflag",
           "blive", "nelive", "woff", "w0s", "uvw_full", "freq_d")


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pmp("builder", ["native", "numpy"])
@pmp("capacity,fine", [(128, False), (256, False), (16, True)])
@pmp("shift", [False, True])
def test_wblocked_plan_matches_jax(obs, monkeypatch, builder, capacity,
                                   fine, shift):
    if builder == "numpy":
        monkeypatch.setattr(pgs_t, "pg_gs_plan_native", lambda *a, **k: None)
    x0, y0 = (1e-3, -2e-3) if shift else (0.0, 0.0)
    pj, pt = _plans(obs, fine, epsilon=1e-7, capacity=capacity, x0=x0, y0=y0)
    assert pt["nblocks"] > 1
    # the fine w grid gives maps of different lengths, a coarse one not
    assert (len(set(pt["nelive"].tolist())) > 2) == fine
    for key in _META:
        assert pt[key] == pj[key], key
    for key, val in pj["p0"].items():
        assert key == "rdtype" or pt["p0"][key] == val, key
    assert pt["p0"]["rdtype"] == torch.float64
    for key in _ARRAYS:
        np.testing.assert_array_equal(_np(pt[key]), np.asarray(pj[key]),
                                      err_msg=key)
    # the tables the port adds agree with the JAX plan they come from
    pf = pgs_t.plan_wblocked_from_jax(pj, device=CPU)
    for key in ("utid", "start", "count", "tslot"):
        assert torch.equal(pf[key], pt[key]), key


@pmp("eps,plane_block", [(1e-7, 3), (1e-5, 2)])
def test_gs_native_builder_matches_numpy(obs, eps, plane_block):
    from pfb_tpu_torch import native
    if native.get_lib() is None:
        pytest.skip("no C++ compiler")
    c = obs["cell"]
    k, _ = pg_t.kernel_params(eps)
    Nx, Ny = pg_t._grid_setup(NX, NX, c, c, 2.0)
    nw, w0, dw = pg_t.w_geometry(obs["uvw"], obs["freq"], NX, NX, c, c, 0.0,
                                 0.0, 2.0, k, True)
    txs, tys = pgs_t._tile_geometry(Nx, Ny, k, None, None)
    args = (obs["uvw"], obs["freq"], Nx, Ny, c, c, txs, tys, -(-Nx // txs),
            -(-Ny // tys), w0, dw, nw, 64, k)
    nat = pgs_t._pg_plan_gs(*args)
    npy = pgs_t._pg_plan_gs_numpy(*args)
    for a, b, name in zip(nat, npy, ("pos", "gidx", "gpm", "utid", "pmin",
                                     "pmax", "sxy")):
        np.testing.assert_array_equal(a, np.asarray(b, a.dtype),
                                      err_msg=name)


def _geom(p):
    p0 = p["p0"]
    k = p0["k"]
    return k, p0["txs"] + k, p0["tys"] + k


def _vispack_j(pj, vr, vi, w):
    return pgs_j._weighted_vispack(pj, jnp.asarray(vr), jnp.asarray(vi),
                                   jnp.asarray(w))


@pmp("eps,shift,fine", [(1e-7, False, False), (1e-7, True, False),
                        (1e-5, False, True)])
def test_spread_fold_plain_matches_jax_interpret(obs, eps, shift, fine):
    """Plain K7+K8 per block against JAX _grid_pallas_gs +
    _fold_pallas_gs (interpret mode) on the same plan and packed
    visibilities: 1e-12."""
    x0, y0 = (1e-3, -2e-3) if shift else (0.0, 0.0)
    pj, _ = _plans(obs, fine, epsilon=eps, x0=x0, y0=y0,
                   capacity=16 if fine else None)
    pt = pgs_t.plan_wblocked_from_jax(pj, device=CPU)
    p0 = pj["p0"]
    k, Thx, Thy = _geom(pj)
    B, NT = pj["B"], pj["NT"]
    vj = _vispack_j(pj, obs["vr"], obs["vi"], obs["wgt"])
    vt = pgs_t._weighted_vispack(pt, _t(obs["vr"]), _t(obs["vi"]),
                                 _t(obs["wgt"]))
    assert _rel(vt.numpy(), vj) < 1e-15
    for b, gmap, woff in pgs_t._live_blocks(pt):
        Yj = pgs_j._grid_pallas_gs(pj["tp"][b], pj["gmap"][b],
                                   pj["woff"][b], pj["pos"], vj, p0["beta"],
                                   k, B, NT, Thx, Thy, p0["C"],
                                   interpret=True)
        Yt = pgs_t.pg_spread_gs(pt["pos"], vt, gmap, pt["start"][b],
                                pt["count"][b], woff=woff, beta=p0["beta"],
                                k=k, B=B, Thx=Thx, Thy=Thy)
        live = np.asarray(pj["lflag"][b]) > 0
        assert _rel(Yt.numpy()[:, :, live], np.asarray(Yj)[:, :, live]) \
            < 1e-12
        Gj = pgs_j._fold_pallas_gs(
            Yj.reshape(2 * B, NT, Thx, Thy), pj["ltid"][b], pj["lflag"][b],
            ntx=p0["ntx"], nty=p0["nty"], txs=p0["txs"], tys=p0["tys"], k=k,
            Nx=p0["Nx"], Ny=p0["Ny"], nw=B, G=pj["G"], interpret=True)
        Gt = pgs_t.pg_fold_gs(Yt.reshape(2 * B, NT, Thx, Thy),
                              pt["tslot"][b], ntx=p0["ntx"], nty=p0["nty"],
                              txs=p0["txs"], tys=p0["tys"], k=k,
                              Nx=p0["Nx"], Ny=p0["Ny"])
        assert Gt.shape == (2 * B, p0["Nx"], p0["Ny"])
        assert _rel(Gt.numpy(), Gj) < 1e-12


@pmp("eps,fine", [(1e-7, False), (1e-5, True)])
def test_degrid_plain_matches_jax_interpret(obs, eps, fine):
    """Plain K9 per block against JAX _degrid_pallas_gs (interpret mode)
    on the same plan, random block grids and a random accumulator:
    1e-12 on the live slots."""
    pj, _ = _plans(obs, fine, epsilon=eps, capacity=16 if fine else None)
    pt = pgs_t.plan_wblocked_from_jax(pj, device=CPU)
    p0 = pj["p0"]
    k, Thx, Thy = _geom(pj)
    B = pj["B"]
    ThxA = -(-(Thx + 7) // 8) * 8
    ThyA = -(-(Thy + 127) // 128) * 128
    pad = ((0, 0), (0, ThxA), (0, ThyA))
    rng = np.random.default_rng(7)
    acc0 = rng.normal(size=(pj["NEg"] + 1, 2, p0["C"]))
    gpm = np.asarray(pj["gpm"])[:, None]
    for b, gmap, woff in pgs_t._live_blocks(pt):
        gr = rng.normal(size=(B, p0["Nx"], p0["Ny"]))
        gi = rng.normal(size=gr.shape)
        ref = pgs_j._degrid_pallas_gs(
            pj["tp"][b], pj["gmap"][b], pj["woff"][b], pj["sxy"][b],
            pj["pos"], jnp.pad(jnp.asarray(gr), pad, mode="wrap"),
            jnp.pad(jnp.asarray(gi), pad, mode="wrap"), jnp.asarray(acc0),
            p0["beta"], k, B, ThxA, ThyA, p0["C"], interpret=True)
        got = pgs_t.pg_degrid_gs(_t(gr), _t(gi), pt["pos"], pt["utid"], gmap,
                                 _t(acc0).clone(), woff=woff,
                                 beta=p0["beta"], k=k, B=B, txs=p0["txs"],
                                 tys=p0["tys"], nty=p0["nty"])
        assert _rel(got.numpy() * gpm, np.asarray(ref) * gpm) < 1e-12


@pmp("eps,shift,fine", [(1e-7, False, False), (1e-7, True, False),
                        (1e-5, True, True)])
def test_wblocked_operators_match_jax(obs, eps, shift, fine):
    """Adjoint, forward and Hessian of the blocked engine against JAX's
    on the same plan: 1e-10."""
    x0, y0 = (1e-3, -2e-3) if shift else (0.0, 0.0)
    pj, pt = _plans(obs, fine, epsilon=eps, x0=x0, y0=y0)
    ref = pgs_j._adjoint_wblocked_impl(pj, jnp.asarray(obs["vr"]),
                                       jnp.asarray(obs["vi"]),
                                       jnp.asarray(obs["wgt"]), True)
    got = pgs_t.make_adjoint_pg_wblocked(pt, wgt=obs["wgt"])(
        _t(obs["vr"]), _t(obs["vi"]))
    assert _rel(got.numpy(), ref) < 1e-10
    fj = pgs_j._forward_wblocked_impl(pj, jnp.asarray(obs["img"]), True)
    ft = pgs_t._forward_wblocked_impl(pt, _t(obs["img"]))
    for a, b in zip(ft, fj):
        assert _rel(a.numpy(), b) < 1e-10
    hj = pgs_j.make_hessian_pg_wblocked(pj, wgt=obs["wgt"])
    ht = pgs_t.make_hessian_pg_wblocked(pt, wgt=obs["wgt"])
    assert _rel(ht(_t(obs["img"])).numpy(), hj(jnp.asarray(obs["img"]))) \
        < 1e-10


@pmp("shift,fine", [(False, False), (True, False), (False, True)])
def test_wblocked_operators_match_unblocked(obs, shift, fine):
    """The blocked engine against the port's all-planes pg operators on
    the same observation and w grid: 1e-10."""
    c = obs["cell"]
    x0, y0 = (1e-3, -2e-3) if shift else (0.0, 0.0)
    _, bp = _plans(obs, fine, epsilon=1e-7, x0=x0, y0=y0, capacity=16)
    p = pg_t.pgrid_plan(obs["uvw"], obs["freq"], nx=NX, ny=NX, cellx=c,
                        celly=c, epsilon=1e-7, x0=x0, y0=y0, device=CPU,
                        w_params=(bp["nw"], bp["w0"], bp["dw"]))
    assert p["nw"] == bp["nw"] > bp["B"]
    vr, vi, w = _t(obs["vr"]), _t(obs["vi"]), _t(obs["wgt"])
    ref = pg_t._adjoint_from_plan(p, vr, vi, w)
    got = pgs_t.make_adjoint_pg_wblocked(bp, wgt=obs["wgt"])(vr, vi)
    assert _rel(got, ref) < 1e-10
    x = _t(obs["img"])
    for a, b in zip(pgs_t._forward_wblocked_impl(bp, x),
                    pg_t._forward_from_plan(p, x)):
        assert _rel(a, b) < 1e-10
    assert _rel(pgs_t.make_hessian_pg_wblocked(bp, wgt=obs["wgt"])(x),
                pg_t.make_hessian_pg(p, wgt=obs["wgt"])(x)) < 1e-10


@pmp("shift", [False, True])
def test_wblocked_adjointness(obs, shift):
    """<R x, v> = <x, R^H v> through the blocked engine."""
    x0, y0 = (2e-3, 1e-3) if shift else (0.0, 0.0)
    _, bp = _plans(obs, epsilon=1e-5, x0=x0, y0=y0)
    x, vr, vi = _t(obs["img"]), _t(obs["vr"]), _t(obs["vi"])
    fr, fi = pgs_t._forward_wblocked_impl(bp, x)
    rhv = pgs_t.make_adjoint_pg_wblocked(bp)(vr, vi)
    lhs = float((fr * vr + fi * vi).sum())
    rhs = float((x * rhv).sum())
    assert abs(lhs - rhs) < 1e-12 * abs(rhs)


def _datasets(obs, seed=11):
    """Two datasets (one per band) with ragged rows from one
    observation, and a beam on the first."""
    rng = np.random.default_rng(seed)
    nrow = obs["uvw"].shape[0]
    cut = nrow // 2 + 7
    dds = []
    for i, rows in enumerate((np.arange(cut), np.arange(cut, nrow))):
        shape = (rows.size, obs["freq"].size)
        ds = dict(UVW=obs["uvw"][rows], FREQ=obs["freq"] * (1 + 0.05 * i),
                  WEIGHT=rng.random(shape),
                  MASK=(rng.random(shape) > 0.1).astype(np.float64),
                  bandid=i, cell_rad=obs["cell"])
        if i == 0:
            ds["BEAM"] = 0.5 + rng.random((NX, NX))
        dds.append(ds)
    return dds


def test_make_hessian_dds_plane_block_matches_jax(obs):
    """make_hessian_dds(backend="pg", plane_block=2) with two datasets,
    a beam and a mask_image against the JAX package's: 1e-10."""
    dds = _datasets(obs)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, NX, NX))
    mask_image = (rng.random((NX, NX)) > 0.2).astype(np.float64)
    kw = dict(backend="pg", epsilon=1e-7, plane_block=2, sigmainv=0.1,
              mask_image=mask_image)
    ht = gridder_t.make_hessian_dds(dds, 2, 3.0, NX, NX, device=CPU, **kw)
    assert all(bp["nblocks"] > 1 and bp["B"] == 2 for bp in ht.plans)
    hj = gridder_j.make_hessian_dds(dds, 2, 3.0, NX, NX, **kw)
    assert _rel(ht(_t(x)).numpy(), hj(jnp.asarray(x))) < 1e-10


def _public_callables():
    for info in pkgutil.walk_packages(pfb_tpu_torch.__path__,
                                      "pfb_tpu_torch."):
        mod = importlib.import_module(info.name)
        for name, obj in vars(mod).items():
            if name.startswith("_") or not inspect.isfunction(obj) or \
                    obj.__module__ != mod.__name__:
                continue
            yield f"{mod.__name__}.{name}", obj


def test_public_device_parameters_default_to_the_card():
    """No public function of the port defaults ``device`` or ``devices``
    to the CPU: a caller who names none gets the card (every visible
    card, for a mesh) when there is one. parallel/ is walked too."""
    found, bad, parallel = 0, [], []
    for name, fn in _public_callables():
        for key in ("device", "devices"):
            par = inspect.signature(fn).parameters.get(key)
            if par is None:
                continue
            found += 1
            if name.startswith("pfb_tpu_torch.parallel."):
                parallel.append(name)
            if par.default is not None and par.default is not \
                    inspect.Parameter.empty:
                bad.append((name, key, par.default))
    assert found >= 8
    assert "pfb_tpu_torch.parallel.mesh.make_mesh" in parallel
    assert "pfb_tpu_torch.parallel.runtime.set_client" in parallel
    assert not bad, bad
