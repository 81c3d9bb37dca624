"""The port's mesh layer (pfb_tpu_torch.parallel): mesh construction,
sharded tensors and collectives against numpy; the band-sharded solver
steps against pfb_tpu.parallel.dist on the same inputs (the JAX side on
the 8 virtual CPU devices of tests/conftest.py, the port on a virtual
CPU mesh). float64; tolerances per test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from pfb_tpu.ops.fft import make_psfhat as make_psfhat_j
from pfb_tpu.ops.psi import make_psi as make_psi_j
from pfb_tpu.parallel import dist as dist_j
from pfb_tpu.parallel.mesh import band_sharding, make_mesh as make_mesh_j
from pfb_tpu_torch.ops.psf import prep_h
from pfb_tpu_torch.ops.psi import make_psi
from pfb_tpu_torch.parallel import collectives as coll
from pfb_tpu_torch.parallel import dist
from pfb_tpu_torch.parallel.mesh import (Mesh, Sharded, along, make_mesh,
                                         shard, smap)

torch.set_num_threads(1)
CPU = torch.device("cpu")
NB, NX = 8, 32


def _t(a):
    return torch.as_tensor(np.array(a))


def _psf_setup(nband=NB, nx=NX):
    nxp = 2 * nx
    x = np.arange(nxp) - nxp // 2
    xx, yy = np.meshgrid(x, x, indexing="ij")
    psf = np.zeros((nband, nxp, nxp))
    for b in range(nband):
        s = 1.0 + 0.3 * b
        psf[b] = 0.5 * np.exp(-0.5 * (xx**2 + yy**2) / s**2)
        psf[b, nxp // 2, nxp // 2] += 0.5
    return psf, np.asarray(make_psfhat_j(jnp.asarray(psf))), nxp


@pytest.fixture(scope="module")
def meshes():
    return (make_mesh_j(nband=8, nspace=1),
            make_mesh(nband=8, nspace=1, devices=[CPU] * 8))


# ---------------------------------------------------------------------
# mesh, sharded tensors


def test_make_mesh_shapes_and_count_check():
    m = make_mesh(nband=2, nspace=4, devices=["cpu"] * 8)
    assert m.shape == {"band": 2, "space": 4} and m.size == 8
    assert m.groups("band")[1] == [1, 5]
    assert m.groups("space")[1] == [4, 5, 6, 7]
    assert make_mesh(nspace=2, devices=["cpu"] * 6).shape["band"] == 3
    with pytest.raises(AssertionError):
        make_mesh(nband=3, nspace=2, devices=["cpu"] * 8)
    assert make_mesh().devices  # the visible devices (the CPU here)


@pytest.mark.parametrize("spec", [("band", None, None),
                                  ("band", "space", None),
                                  (None, "space", None), ()])
def test_shard_gather_round_trip(spec):
    """A 2 x 4 mesh: split dims padded to the axis multiple and cut by
    gather; shards the spec does not tell apart share one tensor."""
    mesh = make_mesh(nband=2, nspace=4, devices=[CPU] * 8)
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(4, 10, 6)))
    s = shard(x, mesh, spec, pad_value=7.0)
    assert torch.equal(s.gather(), x)
    assert s.shape == (4, 10, 6)
    if "space" not in spec:
        assert s.parts[0] is s.parts[3]
    else:
        assert s.parts[0].shape[1] == 3  # ceil(10 / 4)
        assert float(s.parts[3][0, -1, 0]) == 7.0  # padding
    if "band" not in spec:
        assert s.parts[0] is s.parts[4]


def test_along_and_smap_compute_shared_shards_once():
    mesh = make_mesh(nband=2, nspace=4, devices=[CPU] * 8)
    s = shard(torch.arange(8.0).reshape(2, 4), mesh, ("band",))
    calls = []
    out = smap(lambda a: calls.append(1) or a * 2, s.parts)
    assert len(calls) == 2 and out[0] is out[3]
    tot = along(mesh, "band", coll.psum, s.parts)
    assert torch.equal(tot[5], torch.tensor([[4.0, 6.0, 8.0, 10.0]]))
    assert tot[0] is tot[7]


# ---------------------------------------------------------------------
# collectives against numpy


@pytest.mark.parametrize("name", ["psum", "all_gather", "all_to_all",
                                  "psum_scatter", "ppermute"])
def test_collectives_match_numpy(name):
    rng = np.random.default_rng(1)
    xs_np = [rng.normal(size=(2, 8, 12)) for _ in range(4)]
    xs = [_t(a) for a in xs_np]
    devs = [CPU] * 4
    if name == "psum":
        got = coll.psum(xs, devs)
        ref = [sum(xs_np)] * 4
    elif name == "all_gather":
        got = coll.all_gather(xs, devs, 1)
        ref = [np.concatenate(xs_np, axis=1)] * 4
    elif name == "all_to_all":
        got = coll.all_to_all(xs, devs, 2, 1)
        ref = [np.concatenate([a[:, :, 3 * r:3 * r + 3] for a in xs_np],
                              axis=1) for r in range(4)]
    elif name == "psum_scatter":
        got = coll.psum_scatter(xs, devs, 1)
        tot = sum(xs_np)
        ref = [tot[:, 2 * r:2 * r + 2] for r in range(4)]
    else:
        got = coll.ppermute(xs, devs, [(i, i + 1) for i in range(3)])
        ref = [np.zeros_like(xs_np[0])] + xs_np[:3]
    for g, r in zip(got, ref):
        assert_allclose(g.numpy(), r, rtol=0, atol=1e-14)


def test_psum_is_in_mesh_order_and_repeatable():
    rng = np.random.default_rng(2)
    xs = [_t(rng.normal(size=1000).astype(np.float32) * 10**k)
          for k in range(4)]
    a = coll.psum(xs, [CPU] * 4)[0]
    b = coll.psum(xs, [CPU] * 4)[0]
    assert torch.equal(a, b)
    assert torch.equal(a, ((xs[0] + xs[1]) + xs[2]) + xs[3])


# ---------------------------------------------------------------------
# band-sharded steps against pfb_tpu.parallel.dist


def test_hessian_dist_fft_matches_jax(meshes):
    mj, mt = meshes
    psf, psfhat, lastsize = _psf_setup()
    x = np.random.default_rng(0).normal(size=(NB, NX, NX))
    sh = band_sharding(mj)
    ref = np.asarray(dist_j.hessian_psf_dist(mj, lastsize, sigmainv=0.3)(
        jax.device_put(jnp.asarray(x), sh),
        jax.device_put(jnp.asarray(psfhat), sh)))
    got = dist.hessian_psf_dist(mt, lastsize, sigmainv=0.3)(_t(x),
                                                            _t(psfhat))
    assert isinstance(got, Sharded)
    assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)


def _psf128(nband=4, nx=128):
    """128-aligned PSF cube (v3 supported) with per-band structure and
    broken even symmetry (complex H), as tests/test_dist_fast.py."""
    nxp = 2 * nx
    x = np.arange(nxp) - nxp // 2
    xx, yy = np.meshgrid(x, x, indexing="ij")
    psf = np.zeros((nband, nxp, nxp), np.float32)
    for b in range(nband):
        s = 2.0 + 0.5 * b
        psf[b] = 0.4 * np.exp(-0.5 * (xx**2 + yy**2) / s**2)
        psf[b, nxp // 2, nxp // 2] += 0.6
        psf[b, nxp // 2 + 3, nxp // 2 + 1] += 0.02
    return psf


def test_hessian_and_power_method_dist_pallas_match_jax_interpret():
    """engine="pallas" on 4 band shards: the port's plain K1 per shard
    against the JAX package's v3 Pallas pipeline in interpret mode (both
    float32): matvec 1e-5 of max, power-method eigenvalue 1e-4."""
    from pfb_tpu.ops.psf import prep_pallas_hessian
    nband, nx = 4, 128
    psf = _psf128(nband, nx)
    x = np.random.default_rng(0).normal(size=(nband, nx, nx)).astype(
        np.float32)
    mj = make_mesh_j(nband=4, nspace=1, devices=jax.devices()[:4])
    mt = make_mesh(nband=4, nspace=1, devices=[CPU] * 4)
    hr, hi, row_block = prep_pallas_hessian(jnp.asarray(psf), nx, nx)
    hj = (hr,) if hi is None else (hr, hi)
    assert len(hj) == 2
    kwj = dict(engine="pallas", nx=nx, ny=nx, row_block=row_block, nh=2)
    ref = np.asarray(dist_j.hessian_psf_dist(mj, **kwj)(jnp.asarray(x),
                                                        *hj))
    h_t = prep_h(_t(psf), nx, nx, torch.float32)
    kwt = dict(engine="pallas")
    got = dist.hessian_psf_dist(mt, **kwt)(_t(x), *h_t).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()

    b0 = np.random.default_rng(42).normal(size=(nband, nx, nx)).astype(
        np.float32)
    beta_j, _ = dist_j.power_method_dist(mj, tol=1e-6, maxit=100, **kwj)(
        jax.device_put(jnp.asarray(b0), band_sharding(mj)), *hj)
    beta_t, b_t = dist.power_method_dist(mt, tol=1e-6, maxit=100, **kwt)(
        _t(b0), *h_t)
    assert abs(float(beta_t) - float(beta_j)) / float(beta_j) < 1e-4
    assert b_t.shape == (nband, nx, nx)


def test_power_method_dist_matches_jax(meshes):
    mj, mt = meshes
    psf, psfhat, lastsize = _psf_setup()
    b0 = np.random.default_rng(1).normal(size=(NB, NX, NX))
    sh = band_sharding(mj)
    beta_j, b_j = dist_j.power_method_dist(mj, lastsize, tol=1e-10,
                                           maxit=500)(
        jax.device_put(jnp.asarray(b0), sh),
        jax.device_put(jnp.asarray(psfhat), sh))
    beta_t, b_t = dist.power_method_dist(mt, lastsize, tol=1e-10,
                                         maxit=500)(_t(b0), _t(psfhat))
    assert_allclose(float(beta_t), float(beta_j), rtol=1e-10)
    assert_allclose(b_t.numpy(), np.asarray(b_j), rtol=1e-8, atol=1e-10)


def test_pcg_dist_matches_jax(meshes):
    mj, mt = meshes
    psf, psfhat, lastsize = _psf_setup()
    model = np.zeros((NB, NX, NX))
    model[:, 10, 12] = 1.0
    model[:, 20, 8] = 2.0
    sigmainv = 1e-3
    b = np.asarray(dist_j.hessian_psf_dist(mj, lastsize, sigmainv=sigmainv)(
        jnp.asarray(model), jnp.asarray(psfhat)))
    kw = dict(sigmainv=sigmainv, tol=1e-10, maxit=200, minit=10)
    sh = band_sharding(mj)
    ref = np.asarray(dist_j.pcg_dist(mj, lastsize, **kw)(
        jax.device_put(jnp.asarray(b), sh),
        jax.device_put(jnp.zeros_like(jnp.asarray(b)), sh),
        jax.device_put(jnp.asarray(psfhat), sh)))
    got = dist.pcg_dist(mt, lastsize, **kw)(_t(b), torch.zeros(b.shape,
                                                               dtype=torch.float64),
                                            _t(psfhat))
    assert_allclose(got.numpy(), ref, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("positivity", [1, 2])
def test_primal_dual_dist_matches_jax(meshes, positivity):
    """Band-varying amplitudes, so positivity 2's any-band mask must be
    summed over the band shards; with and without the reweight restart:
    rtol 1e-8, atol 1e-10."""
    mj, mt = meshes
    psf, psfhat, lastsize = _psf_setup()
    model = np.zeros((NB, NX, NX))
    amp = 1.0 + 0.25 * np.arange(NB)
    model[:, 10, 12] = 1.5 * amp
    model[:, 20, 8] = 2.0 * amp[::-1]
    data = np.asarray(dist_j.hessian_psf_dist(mj, lastsize)(
        jnp.asarray(model), jnp.asarray(psfhat)))
    if positivity == 2:
        # O(1) data of both signs: a PSF-convolved model has bands at the
        # FFTs' rounding level where wider bands do not, and positivity
        # 2's mask would then follow the rounding
        data = data + np.random.default_rng(6).normal(size=data.shape)
    psi_j = make_psi_j(NX, NX, ("self", "db1"), 2)
    psi_t = make_psi(NX, NX, ("self", "db1"), 2)
    nbasis = psi_t.nbasis
    v0 = np.zeros((NB, nbasis, psi_t.Nymax, psi_t.Nxmax))
    w = np.ones((nbasis, psi_t.Nymax, psi_t.Nxmax))
    rc = np.full(w.shape, 0.3)
    sh = band_sharding(mj)
    beta, _ = dist_j.power_method_dist(mj, lastsize, tol=1e-8, maxit=200)(
        jax.device_put(jnp.ones((NB, NX, NX)), sh),
        jax.device_put(jnp.asarray(psfhat), sh))
    L, lam = float(beta) * 1.05, 1e-3
    kw = dict(nu=nbasis, tol=1e-7, maxit=300, positivity=positivity)
    csh = jax.sharding.NamedSharding(
        mj, jax.sharding.PartitionSpec("band", None, None, None))
    pd_j = dist_j.primal_dual_dist(mj, psi_j, lastsize, **kw)
    pd_t = dist.primal_dual_dist(mt, psi_t, lastsize, **kw)
    for do_rw in (False, True):
        xj, vj, wj, kj = pd_j(
            jax.device_put(jnp.zeros((NB, NX, NX)), sh),
            jax.device_put(jnp.asarray(v0), csh),
            jax.device_put(jnp.asarray(data), sh),
            jax.device_put(jnp.asarray(psfhat), sh), jnp.asarray(w),
            jnp.asarray(lam), jnp.asarray(L), rms_comps=jnp.asarray(rc),
            do_reweight=do_rw)
        xt, vt, wt, kt = pd_t(torch.zeros((NB, NX, NX), dtype=torch.float64),
                              _t(v0), _t(data), _t(psfhat), _t(w), lam, L,
                              rms_comps=_t(rc), do_reweight=do_rw)
        assert kt == int(kj) and np.abs(np.asarray(xj)).max() > 0.1
        for a, b in ((xt, xj), (vt, vj), (wt, wj)):
            assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8, atol=1e-10)


def test_coeff_rms_dist_matches_jax(meshes):
    mj, mt = meshes
    rng = np.random.default_rng(5)
    resid = rng.normal(size=(NB, NX, NX))
    bandw = rng.random(NB) + 0.5
    psi_j = make_psi_j(NX, NX, ("self", "db1", "db2"), 2)
    psi_t = make_psi(NX, NX, ("self", "db1", "db2"), 2)
    ref = np.asarray(dist_j.coeff_rms_dist(mj, psi_j, 3.7)(
        jax.device_put(jnp.asarray(resid), band_sharding(mj)),
        jnp.asarray(bandw)))
    got = dist.coeff_rms_dist(mt, psi_t, 3.7)(_t(resid), _t(bandw))
    assert_allclose(got.numpy(), ref, rtol=1e-10)


def test_mesh_of_several_devices_moves_shards():
    """A mesh over two distinct devices (the CPU under two names is one
    device, so use the meta device for the layout check only)."""
    m = Mesh(1, 2, [torch.device("cpu"), torch.device("meta")])
    s = shard(torch.zeros(2, 4), m, (None, "space"))
    assert s.parts[1].device.type == "meta" and s.parts[0].device == CPU


def test_set_client_single_host_only():
    from pfb_tpu_torch.parallel.runtime import set_client
    m = set_client(nspace=1, devices=[CPU] * 2)
    assert m.shape == {"band": 2, "space": 1}
    # several processes need a coordinator, and a coordinator needs the
    # process count and this process's index (tests/test_torch_multiprocess.py
    # runs the two-process mesh)
    with pytest.raises(ValueError):
        set_client(num_processes=2, devices=[CPU] * 2)
    with pytest.raises(ValueError):
        set_client(coordinator="localhost:1234", num_processes=2)
