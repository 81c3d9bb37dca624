"""backend="mm" in pfb_tpu_torch: the name runs the pg gridder
(ops/gridder.py:ROUTES), held against the JAX package's matmul gridder on
the same numpy inputs, CPU, float64.

- get_backend("mm") returns the pg gridder's functions, and
  make_hessian_dds(backend="mm") is the pg Hessian (within 1e-12 of max:
  the pg gridder's own run-to-run spread on the CPU is ~1e-15);
- vis2dirty / dirty2vis through "mm" against the JAX package's
  vis2dirty_mm / dirty2vis_mm, and against the exact DFT oracle (the
  tolerances of tests/test_mmgridder.py: 1e-6 adjoint, 5e-6 forward;
  two gridders each within those of the oracle differ by at most twice
  them);
- make_hessian_dds(backend="mm") against the JAX package's at 2e-6 of
  max, and self-adjoint at 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfb_tpu.ops import gridder as gridder_j
from pfb_tpu.ops import mmgridder as mm_j
from pfb_tpu.utils.simulation import image_size_for, simulate_obs
from pfb_tpu_torch.ops import dft as dft_t
from pfb_tpu_torch.ops import gridder as gridder_t
from pfb_tpu_torch.ops import pgridder as pg_t

torch.set_num_threads(1)
pmp = pytest.mark.parametrize
CPU = torch.device("cpu")
ADJ, FWD = 1e-6, 5e-6


@pytest.fixture(scope="module")
def obs():
    o = simulate_obs(nant=7, ntime=6, nchan=2, seed=3)
    nx, cell = image_size_for(o, fov_deg=0.2)
    nx = min(nx, 64)
    rng = np.random.default_rng(0)
    shape = (o.uvw.shape[0], o.freq.size)
    return dict(uvw=o.uvw, freq=o.freq, cell=cell, nx=nx,
                vis=rng.normal(size=shape) + 1j * rng.normal(size=shape),
                wgt=rng.random(shape), img=rng.normal(size=(nx, nx)))


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / \
        np.abs(np.asarray(b)).max()


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _geom(obs, centre):
    c = obs["cell"]
    x0, y0 = (3 * c, -2 * c) if centre == "offset" else (0.0, 0.0)
    return dict(nx=obs["nx"], ny=obs["nx"], cellx=c, celly=c, x0=x0, y0=y0)


def test_mm_routes_to_pg():
    assert gridder_t.route("mm") == "pg"
    assert gridder_t.route("wgrid") == "wgrid"
    d2v, v2d = gridder_t.get_backend("mm")
    assert (d2v, v2d) == (pg_t.dirty2vis_pg, pg_t.vis2dirty_pg)
    # double_accum is bound for wgrid only: the pg gridder takes none
    d2v, v2d = gridder_t.get_backend("mm", epsilon=1e-5, double_accum=True)
    assert v2d.func is pg_t.vis2dirty_pg
    assert v2d.keywords == d2v.keywords == dict(epsilon=1e-5)
    with pytest.raises(ValueError, match="Unknown gridder backend"):
        gridder_t.get_backend("nope")


@pmp("do_w", [False, True])
@pmp("centre", ["zero", "offset"])
def test_vis2dirty_mm_matches_jax_mm(obs, do_w, centre):
    kw = dict(_geom(obs, centre), epsilon=1e-7, do_wgridding=do_w)
    ref = mm_j.vis2dirty_mm(obs["uvw"], obs["freq"], obs["vis"],
                            wgt=obs["wgt"], **kw)
    _, v2d = gridder_t.get_backend("mm")
    got = v2d(_t(obs["uvw"]), _t(obs["freq"]), _t(obs["vis"]),
              wgt=_t(obs["wgt"]), **kw)
    assert got.dtype == torch.float64
    assert _rel(got, ref) < 2 * ADJ


@pmp("do_w", [False, True])
@pmp("centre", ["zero", "offset"])
def test_dirty2vis_mm_matches_jax_mm(obs, do_w, centre):
    g = _geom(obs, centre)
    kw = dict(epsilon=1e-7, do_wgridding=do_w, x0=g["x0"], y0=g["y0"])
    ref = mm_j.dirty2vis_mm(obs["uvw"], obs["freq"], jnp.asarray(obs["img"]),
                            g["cellx"], g["celly"], **kw)
    d2v, _ = gridder_t.get_backend("mm")
    got = d2v(_t(obs["uvw"]), _t(obs["freq"]), _t(obs["img"]), g["cellx"],
              g["celly"], **kw)
    assert got.dtype == torch.complex128
    assert _rel(got, ref) < 2 * FWD


@pmp("do_w", [False, True])
@pmp("centre", ["zero", "offset"])
def test_mm_matches_dft(obs, do_w, centre):
    """The counterparts of tests/test_mmgridder.py's oracle tests (both
    directions, with and without the w term and the centre shift)."""
    g = _geom(obs, centre)
    uvw, freq, vis, wgt, img = (_t(obs[k])
                                for k in ("uvw", "freq", "vis", "wgt", "img"))
    d2v, v2d = gridder_t.get_backend("mm", epsilon=1e-7, do_wgridding=do_w)
    ref = dft_t.vis2dirty_dft(uvw, freq, vis, wgt=wgt, do_wterm=do_w, **g)
    assert _rel(v2d(uvw, freq, vis, wgt=wgt, **g), ref) < ADJ
    vref = dft_t.dirty2vis_dft(uvw, freq, img, g["cellx"], g["celly"],
                               do_wterm=do_w, x0=g["x0"], y0=g["y0"])
    vgot = d2v(uvw, freq, img, g["cellx"], g["celly"], x0=g["x0"],
               y0=g["y0"])
    assert _rel(vgot, vref) < FWD


@pytest.fixture(scope="module")
def dds2(obs):
    """Two bands' datasets with beams, as the Hessian tests build them."""
    rng = np.random.default_rng(4)
    out = []
    nx = obs["nx"]
    for b in range(2):
        sl = slice(b, b + 1)
        out.append(dict(UVW=obs["uvw"], FREQ=obs["freq"][sl],
                        WEIGHT=obs["wgt"][:, sl],
                        MASK=(rng.random((obs["uvw"].shape[0], 1)) > 0.1
                              ).astype(np.float64),
                        BEAM=0.5 + rng.random((nx, nx)), bandid=b,
                        cell_rad=obs["cell"], x0=obs["cell"] * b, y0=0.0))
    return out


@pmp("use_beam", [False, True])
def test_make_hessian_dds_mm_matches_jax(obs, dds2, use_beam):
    """The port's "mm" Hessian is its pg Hessian, and within
    2e-6 of max of the JAX package's matmul Hessian."""
    nx = obs["nx"]
    x = np.random.default_rng(6).normal(size=(2, nx, nx))
    kw = dict(sigmainv=1e-3, use_beam=use_beam, epsilon=1e-7,
              do_wgridding=True)
    hj = gridder_j.make_hessian_dds(dds2, 2, 3.0, nx, nx, backend="mm",
                                    **kw)
    ht = gridder_t.make_hessian_dds(dds2, 2, 3.0, nx, nx, backend="mm",
                                    device=CPU, **kw)
    hp = gridder_t.make_hessian_dds(dds2, 2, 3.0, nx, nx, backend="pg",
                                    device=CPU, **kw)
    got = ht(_t(x))
    assert _rel(got, hp(_t(x))) < 1e-12
    assert _rel(got, np.asarray(hj(jnp.asarray(x)))) < 2 * ADJ


def test_make_hessian_dds_mm_self_adjoint(obs, dds2):
    nx = obs["nx"]
    rng = np.random.default_rng(8)
    u, v = (_t(rng.normal(size=(2, nx, nx))) for _ in range(2))
    h = gridder_t.make_hessian_dds(dds2, 2, 3.0, nx, nx, backend="mm",
                                   device=CPU)
    a, b = float((v * h(u)).sum()), float((h(v) * u).sum())
    assert abs(a - b) < 1e-12 * abs(a)
