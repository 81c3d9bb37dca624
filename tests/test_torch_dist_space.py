"""The port's space-sharded path against pfb_tpu on the same inputs: K10's
plain stages against psf_v3_stage_k1/k2/k3 (Pallas interpret mode),
hessian_psf_space_dist for its three methods, primal_dual_space_dist with
the halo and gather dictionaries, the halo-exchange Psi, and the early
check of ``lastsize``. The JAX side runs on the 8 virtual CPU devices of
tests/conftest.py, the port on virtual CPU meshes. Tolerances per test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P
from numpy.testing import assert_allclose

from pfb_tpu.ops.fft import make_psfhat as make_psfhat_j
from pfb_tpu.ops.psf import prep_pallas_hessian_space
from pfb_tpu.ops.psi import make_psi as make_psi_j
from pfb_tpu.parallel import dist as dist_j
from pfb_tpu.parallel.mesh import make_mesh as make_mesh_j
from pfb_tpu_torch.ops.psf import (h_from_jax_space, prep_h_space,
                                   psf_convolve_h, psf_stage_cols_fwd,
                                   psf_stage_cols_inv, psf_stage_rows,
                                   space_rows, v3_space_supported)
from pfb_tpu_torch.ops.psi import make_psi, psi_dot, psi_hdot
from pfb_tpu_torch.parallel import dist
from pfb_tpu_torch.parallel.dwt_halo import (halo_psi_dot, halo_psi_hdot,
                                             make_halo_plan)
from pfb_tpu_torch.parallel.mesh import along, make_mesh, shard

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _t(a):
    return torch.as_tensor(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _psf256(nband=2, nx=256, even=False):
    nxp = 2 * nx
    x = np.arange(nxp) - nxp // 2
    xx, yy = np.meshgrid(x, x, indexing="ij")
    psf = np.zeros((nband, nxp, nxp), np.float32)
    for b in range(nband):
        psf[b] = 0.4 * np.exp(-0.5 * (xx**2 + yy**2) / (2.0 + b)**2)
        psf[b, nxp // 2, nxp // 2] += 0.6
        if not even:
            psf[b, nxp // 2 + 3, nxp // 2 + 1] += 0.02
    return psf


def _psf_small(nband, nx, ny):
    nxp, nyp = 2 * nx, 2 * ny
    xx, yy = np.meshgrid(np.arange(nxp) - nxp // 2,
                         np.arange(nyp) - nyp // 2, indexing="ij")
    psf = np.zeros((nband, nxp, nyp))
    for b in range(nband):
        s = 1.0 + 0.3 * b
        psf[b] = 0.5 * np.exp(-0.5 * (xx**2 + yy**2) / s**2)
        psf[b, nxp // 2, nyp // 2] += 0.5
    return psf, np.asarray(make_psfhat_j(jnp.asarray(psf))), nyp


# ---------------------------------------------------------------------
# K10's plain stages against the JAX stages (interpret mode)


@pytest.fixture(scope="module", params=["complex", "real"])
def k10_case(request):
    """nband 2, nx 256, 2 space shards: the JAX stages K1 -> K2 -> K3 on
    the whole (padded) spectrum, and H in both layouts."""
    from pfb_tpu.ops.pallas_fft import (psf_v3_stage_k1, psf_v3_stage_k2,
                                        psf_v3_stage_k3)
    nband, nx, ps = 2, 256, 2
    assert v3_space_supported(nx, nx, ps)
    psf = _psf256(nband, nx, even=request.param == "real")
    Hsr, Hsi, NXH = prep_pallas_hessian_space(jnp.asarray(psf), nx, nx, ps)
    assert (Hsi is None) == (request.param == "real")
    x = np.random.default_rng(0).normal(size=(nband, nx, nx)).astype(
        np.float32)
    zr, zi = psf_v3_stage_k1(jnp.asarray(x), nx, interpret=True)
    pad = [(0, 0), (0, Hsr.shape[2] - NXH), (0, 0)]
    zr_p, zi_p = jnp.pad(zr, pad), jnp.pad(zi, pad)
    wr, wi = psf_v3_stage_k2(zr_p, zi_p, Hsr, Hsi, interpret=True)
    out = psf_v3_stage_k3(wr[:, :NXH], wi[:, :NXH], nx, interpret=True)
    hr, hi = h_from_jax_space(Hsr, Hsi, nx, nx, ps)
    return dict(nx=nx, ps=ps, x=x, z=(np.asarray(zr), np.asarray(zi)),
                w=(np.asarray(wr), np.asarray(wi)), out=np.asarray(out),
                hr=hr, hi=hi, psf=psf)


def test_k10_stage1_matches_jax(k10_case):
    """Stage 1 on each column shard: rows 0..nx of the JAX stage's
    spectrum, the pad rows zero; 1e-5 of max."""
    c = k10_case
    nx, ps = c["nx"], c["ps"]
    rows = space_rows(nx, ps)
    nyl = nx // ps
    for r in range(ps):
        xs = _t(c["x"][:, :, r * nyl:(r + 1) * nyl])
        zr, zi = psf_stage_cols_fwd(xs, 2 * nx, rows)
        assert zr.shape == (2, rows, nyl)
        for got, ref in ((zr, c["z"][0]), (zi, c["z"][1])):
            ref = ref[:, :nx + 1, r * nyl:(r + 1) * nyl]
            assert np.abs(got[:, :nx + 1].numpy() - ref).max() <= \
                1e-5 * np.abs(c["z"][0]).max()
        assert not zr[:, nx + 1:].any() and not zi[:, nx + 1:].any()


def test_k10_stage2_matches_jax(k10_case):
    """Stage 2 on each row shard of the port's padded rows, fed the JAX
    stage-1 rows, against the JAX stage 2 times NY (the port leaves the
    inverse y transform unscaled); 1e-5 of max."""
    c = k10_case
    nx, ps = c["nx"], c["ps"]
    rows = space_rows(nx, ps)
    rl = rows // ps
    hr = shard(_t(c["hr"]), make_mesh(1, ps, [CPU] * ps),
               ("band", "space", None))
    hi = None if c["hi"] is None else \
        shard(_t(c["hi"]), make_mesh(1, ps, [CPU] * ps),
              ("band", "space", None))
    scale = np.abs(c["w"][0]).max()
    for r in range(ps):
        sl = slice(r * rl, (r + 1) * rl)
        wr, wi = psf_stage_rows(_t(c["z"][0][:, sl]), _t(c["z"][1][:, sl]),
                                hr.parts[r],
                                None if hi is None else hi.parts[r])
        keep = min(rl, nx + 1 - r * rl)
        for got, ref in ((wr, c["w"][0]), (wi, c["w"][1])):
            assert np.abs(got[:, :keep].numpy() / (2 * nx)
                          - ref[:, sl][:, :keep]).max() <= 1e-5 * scale


def test_k10_stage3_matches_jax(k10_case):
    """Stage 3 on each column shard of the JAX stage-2 output (times NY,
    padded to the port's rows, read at the padded row stride) against
    the JAX stage 3; and the three stages chained equal K1's plain
    version; 1e-5 of max."""
    c = k10_case
    nx, ps = c["nx"], c["ps"]
    rows = space_rows(nx, ps)
    nyl = nx // ps
    NX = NY = 2 * nx
    w = [np.pad(a[:, :nx + 1] * NY, ((0, 0), (0, rows - nx - 1), (0, 0)))
         for a in c["w"]]
    for r in range(ps):
        cols = slice(r * nyl, (r + 1) * nyl)
        got = psf_stage_cols_inv(_t(w[0][:, :, cols]), _t(w[1][:, :, cols]),
                                 nx, NX, NY)
        assert got.shape == (2, nx, nyl)
        assert _rel(got.numpy(), c["out"][:, :, cols]) <= 1e-5
    # chained over the whole cube (one shard) against K1's plain version
    x = _t(c["x"])
    zr, zi = psf_stage_cols_fwd(x, NX, rows)
    wr, wi = psf_stage_rows(zr, zi, _t(c["hr"]),
                            None if c["hi"] is None else _t(c["hi"]))
    chained = psf_stage_cols_inv(wr, wi, nx, NX, NY)
    ref = psf_convolve_h(x, _t(c["hr"][:, :nx + 1]),
                         None if c["hi"] is None else _t(c["hi"][:, :nx + 1]))
    assert _rel(chained.numpy(), ref.numpy()) <= 1e-5


def test_prep_h_space_pads_rows_with_zeros():
    psf = _t(_psf256(1, 128))
    hr, hi = prep_h_space(psf, 128, 128, 4, torch.float64)
    assert hr.shape == (1, space_rows(128, 4), 256)
    assert space_rows(128, 4) == 132 and not hr[:, 129:].any()
    assert hi is not None and not hi[:, 129:].any()


# ---------------------------------------------------------------------
# hessian_psf_space_dist


@pytest.mark.parametrize("method", ["fft", "allgather"])
def test_hessian_space_dist_matches_jax(method):
    """fft and allgather on a 2 x 4 mesh, sigmainv 0 and 0.7: float64,
    1e-11."""
    nband, nx, ny = 2, 32, 48
    psf, psfhat, lastsize = _psf_small(nband, nx, ny)
    x = np.random.default_rng(3).normal(size=(nband, nx, ny))
    mj = make_mesh_j(nband=2, nspace=4)
    mt = make_mesh(nband=2, nspace=4, devices=[CPU] * 8)
    xd = jax.device_put(jnp.asarray(x), NamedSharding(mj, P("band",
                                                              "space")))
    if method == "fft":
        hj = jax.device_put(dist_j.prep_psfhat_space(jnp.asarray(psfhat), 4),
                            NamedSharding(mj, P("band", None, "space")))
        ht = dist.prep_psfhat_space(_t(psfhat), 4)
    else:
        hj = jax.device_put(jnp.asarray(psfhat), NamedSharding(mj,
                                                                P("band")))
        ht = _t(psfhat)
    for sigmainv in (0.0, 0.7):
        ref = np.asarray(dist_j.hessian_psf_space_dist(
            mj, lastsize, sigmainv=sigmainv, method=method)(xd, hj))
        got = dist.hessian_psf_space_dist(mt, lastsize, sigmainv=sigmainv,
                                          method=method)(_t(x), ht)
        assert_allclose(got.numpy(), ref, rtol=1e-11, atol=1e-11)


def test_hessian_space_dist_pallas_matches_jax_and_k1():
    """method="pallas" (K10's plain stages with all-to-all transposes) on
    a 2 x 2 mesh against the JAX package's space-distributed v3 pipeline
    in interpret mode (1e-5 of max), and against K1's plain version on
    the whole cube (1e-6 of max)."""
    nband, nx, ps = 2, 256, 2
    psf = _psf256(nband, nx)
    x = np.random.default_rng(0).normal(size=(nband, nx, nx)).astype(
        np.float32)
    mj = make_mesh_j(nband=nband, nspace=ps,
                     devices=jax.devices()[:nband * ps])
    Hsr, Hsi, _ = prep_pallas_hessian_space(jnp.asarray(psf), nx, nx, ps)
    hsh = NamedSharding(mj, P("band", None, "space", None))
    hj = tuple(jax.device_put(h, hsh) for h in (Hsr, Hsi))
    xs = jax.device_put(jnp.asarray(x), NamedSharding(
        mj, P("band", "space", None)))
    ref = np.asarray(dist_j.hessian_psf_space_dist(
        mj, method="pallas", nx=nx, ny=nx, nh=2)(xs, *hj))

    mt = make_mesh(nband=nband, nspace=ps, devices=[CPU] * 4)
    hr, hi = prep_h_space(_t(psf), nx, nx, ps, torch.float32)
    got = dist.hessian_psf_space_dist(mt, method="pallas")(
        _t(x), hr, hi).numpy()
    assert _rel(got, ref) <= 1e-5
    k1 = psf_convolve_h(_t(x), hr[:, :nx + 1], hi[:, :nx + 1]).numpy()
    assert _rel(got, k1) <= 1e-6


@pytest.mark.parametrize("which", ["hessian", "primal_dual"])
def test_fft_engine_needs_lastsize(which):
    """Early check (the JAX package fails later, inside the FFT, when
    lastsize=None reaches engine "fft"): a ValueError at build time."""
    mt = make_mesh(nband=1, nspace=2, devices=[CPU] * 2)
    with pytest.raises(ValueError, match="lastsize"):
        if which == "hessian":
            dist.hessian_psf_space_dist(mt, method="fft")
        else:
            dist.primal_dual_space_dist(mt, make_psi(32, 32, ("self",), 1),
                                        engine="fft")


# ---------------------------------------------------------------------
# primal_dual_space_dist


@pytest.mark.parametrize("psi_method", ["halo", "gather"])
def test_primal_dual_space_dist_matches_jax(psi_method):
    """2 x 4 mesh, fft engine, through a reweight restart: x, v, l1weight
    against the JAX package's; float64, rtol 1e-8, atol 1e-10."""
    nband, nx, ny = 2, 32, 32
    psf, psfhat, lastsize = _psf_small(nband, nx, ny)
    model = np.zeros((nband, nx, ny))
    model[:, 10, 12] = 1.5
    model[:, 20, 8] = 2.0
    mj = make_mesh_j(nband=2, nspace=4)
    mt = make_mesh(nband=2, nspace=4, devices=[CPU] * 8)
    data = np.asarray(dist_j.hessian_psf_dist(
        make_mesh_j(nband=2, nspace=1, devices=jax.devices()[:2]),
        lastsize)(jnp.asarray(model), jnp.asarray(psfhat)))
    bases = ("self", "db1", "db2")
    psi_j, psi_t = make_psi_j(nx, ny, bases, 2), make_psi(nx, ny, bases, 2)
    nbasis = psi_t.nbasis
    v0 = np.zeros((nband, nbasis, psi_t.Nymax, psi_t.Nxmax))
    w = np.ones((nbasis, psi_t.Nymax, psi_t.Nxmax))
    rc = np.full(w.shape, 0.3)
    L, lam = 30.0, 1e-3
    kw = dict(nu=nbasis, tol=1e-7, maxit=300, positivity=1,
              psi_method=psi_method)
    pd_j = dist_j.primal_dual_space_dist(mj, psi_j, lastsize, **kw)
    pd_t = dist.primal_dual_space_dist(mt, psi_t, lastsize, **kw)
    assert pd_t.psi_method == psi_method
    cube = NamedSharding(mj, P("band", "space", None))
    php_j = jax.device_put(dist_j.prep_psfhat_space(jnp.asarray(psfhat), 4),
                           NamedSharding(mj, P("band", None, "space")))
    php_t = dist.prep_psfhat_space(_t(psfhat), 4)
    for do_rw in (False, True):
        xj, vj, wj, kj = pd_j(jax.device_put(jnp.zeros_like(data), cube),
                              jnp.asarray(v0),
                              jax.device_put(jnp.asarray(data), cube),
                              php_j, jnp.asarray(w), jnp.asarray(lam),
                              jnp.asarray(L), rms_comps=jnp.asarray(rc),
                              do_reweight=do_rw)
        xt, vt, wt, kt = pd_t(torch.zeros(data.shape, dtype=torch.float64),
                              _t(v0), _t(data), php_t, _t(w), lam, L,
                              rms_comps=_t(rc), do_reweight=do_rw)
        assert kt == int(kj)
        assert vt.shape == v0.shape and wt.shape == w.shape
        for a, b in ((xt, xj), (vt, vj), (wt, wj)):
            assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8, atol=1e-10)


def test_primal_dual_space_pallas_tracks_fft():
    """The K10 gradient (plain stages, float32) against the distributed
    rFFT2 one (float64) through 6 iterations on a 2 x 2 mesh, as
    tests/test_dist_fast.py does for the JAX package: 1e-4 of max."""
    nband, nx, ps = 2, 256, 2
    psf = _psf256(nband, nx).astype(np.float64)
    rng = np.random.default_rng(1)
    data = rng.normal(size=(nband, nx, nx)).astype(np.float32)
    psi = make_psi(nx, nx, ("self", "db1"), 2)
    v0 = torch.zeros((nband, psi.nbasis, psi.Nymax, psi.Nxmax))
    l1w = torch.ones((psi.nbasis, psi.Nymax, psi.Nxmax))
    mt = make_mesh(nband=nband, nspace=ps, devices=[CPU] * 4)
    kw = dict(nu=psi.nbasis, tol=0.0, maxit=6, positivity=1, gamma=1.0)
    psfhat = np.asarray(make_psfhat_j(jnp.asarray(psf)))
    pd_f = dist.primal_dual_space_dist(mt, psi, 2 * nx, **kw)
    xf, _, _, _ = pd_f(torch.zeros(nband, nx, nx, dtype=torch.float64),
                       v0.double(), _t(data).double(),
                       dist.prep_psfhat_space(_t(psfhat), ps), l1w.double(),
                       1e-3, 2.0)
    hr, hi = prep_h_space(_t(psf), nx, nx, ps, torch.float32)
    pd_p = dist.primal_dual_space_dist(mt, psi, engine="pallas", **kw)
    xp, _, _, k = pd_p(torch.zeros(nband, nx, nx), v0, _t(data), (hr, hi),
                       l1w, 1e-3, 2.0)
    assert k == 6
    xf = xf.numpy()
    assert np.abs(xp.numpy() - xf).max() < 1e-4 * np.abs(xf).max() + 1e-5


@pytest.mark.parametrize("psi_method", ["halo", "gather"])
def test_primal_dual_space_pallas_matches_jax(psi_method):
    """The solver that runs every PD gradient on K10: engine "pallas" on
    a 2 x 2 mesh at 256^2 through 6 iterations, float32, against the JAX
    package's primal_dual_space_dist(engine="pallas") with its Pallas
    stages in interpret mode: x within 1e-5 of its max, v within 1e-4
    (the dual update subtracts the threshold from sums far larger than
    the float32 result, so its rounding is the larger)."""
    nband, nx, ps = 2, 256, 2
    psf = _psf256(nband, nx)
    data = np.random.default_rng(1).normal(size=(nband, nx, nx)).astype(
        np.float32)
    psi_j = make_psi_j(nx, nx, ("self", "db1"), 2)
    psi_t = make_psi(nx, nx, ("self", "db1"), 2)
    v0 = np.zeros((nband, psi_t.nbasis, psi_t.Nymax, psi_t.Nxmax),
                  np.float32)
    l1w = np.ones((psi_t.nbasis, psi_t.Nymax, psi_t.Nxmax), np.float32)
    kw = dict(nu=psi_t.nbasis, tol=0.0, maxit=6, positivity=1, gamma=1.0,
              psi_method=psi_method)

    mj = make_mesh_j(nband=nband, nspace=ps,
                     devices=jax.devices()[:nband * ps])
    cube = NamedSharding(mj, P("band", "space", None))
    Hsr, Hsi, _ = prep_pallas_hessian_space(jnp.asarray(psf), nx, nx, ps)
    hsh = NamedSharding(mj, P("band", None, "space", None))
    hj = tuple(jax.device_put(h, hsh) for h in (Hsr, Hsi))
    pd_j = dist_j.primal_dual_space_dist(mj, psi_j, engine="pallas", nx=nx,
                                         ny=nx, nh=2, **kw)
    xj, vj, _, kj = pd_j(
        jax.device_put(jnp.zeros((nband, nx, nx), jnp.float32), cube),
        jax.device_put(jnp.asarray(v0), NamedSharding(
            mj, P("band", None, "space", None))),
        jax.device_put(jnp.asarray(data), cube), hj, jnp.asarray(l1w),
        jnp.float32(1e-3), jnp.float32(2.0))

    mt = make_mesh(nband=nband, nspace=ps, devices=[CPU] * 4)
    hr, hi = prep_h_space(_t(psf), nx, nx, ps, torch.float32)
    pd_t = dist.primal_dual_space_dist(mt, psi_t, engine="pallas", **kw)
    assert pd_t.psi_method == psi_method
    xt, vt, _, kt = pd_t(torch.zeros(nband, nx, nx), _t(v0), _t(data),
                         (hr, hi), _t(l1w), 1e-3, 2.0)
    assert kt == int(kj) == 6
    assert _rel(xt.numpy(), xj) <= 1e-5
    assert _rel(vt.numpy(), vj) <= 1e-4


# ---------------------------------------------------------------------
# the halo-exchange Psi


@pytest.mark.parametrize("case", [
    dict(nband=2, nx=64, ny=48, bases=("self", "db1"), nlevel=2, nb=2, ps=4),
    dict(nband=2, nx=64, ny=48, bases=("self", "db1", "db2"), nlevel=2,
         nb=2, ps=4),
    dict(nband=2, nx=64, ny=48, bases=("db2",), nlevel=3, nb=2, ps=4),
    dict(nband=1, nx=128, ny=64, bases=("self", "db1", "db2"), nlevel=2,
         nb=1, ps=8)])
def test_halo_psi_parity(case):
    """Analysis and synthesis of the halo Psi on the shards against the
    one-device dictionary, and the tight-frame identity through the
    distributed pair (tests/test_dwt_halo.py's cases): 1e-10."""
    nx, ny, ps = case["nx"], case["ny"], case["ps"]
    psi = make_psi(nx, ny, case["bases"], case["nlevel"])
    qy = -(-psi.Nymax // ps)
    plan = make_halo_plan(psi, ps, qy)
    mt = make_mesh(nband=case["nb"], nspace=ps,
                   devices=[CPU] * (case["nb"] * ps))
    rng = np.random.default_rng(0)
    x = _t(rng.normal(size=(case["nband"], nx, ny)))
    xs = shard(x, mt, ("band", "space", None))

    def dot(parts):
        return along(mt, "space", lambda a, d: halo_psi_dot(a, d, plan),
                     parts)

    def hdot(parts):
        return along(mt, "space", lambda a, d: halo_psi_hdot(a, d, plan),
                     parts)

    coeff = ("band", None, "space", None)
    a = dot(xs.parts)
    from pfb_tpu_torch.parallel.mesh import Sharded
    a_g = Sharded(mt, coeff, psi_dot(x, psi).shape, a).gather()
    assert_allclose(a_g.numpy(), psi_dot(x, psi).numpy(), rtol=1e-10,
                    atol=1e-10)
    alpha = _t(rng.normal(size=a_g.shape))
    img = hdot(shard(alpha, mt, coeff).parts)
    img_g = Sharded(mt, ("band", "space", None), x.shape, img).gather()
    assert_allclose(img_g.numpy(), psi_hdot(alpha, psi).numpy(), rtol=1e-10,
                    atol=1e-10)
    back = Sharded(mt, ("band", "space", None), x.shape,
                   hdot(a)).gather()
    assert_allclose(back.numpy(), psi.nbasis * x.numpy(), rtol=1e-10,
                    atol=1e-10)


def test_halo_plan_matches_jax():
    from pfb_tpu.parallel.dwt_halo import make_halo_plan as make_halo_plan_j
    psi_j = make_psi_j(64, 48, ("self", "db1", "db2"), 2)
    psi_t = make_psi(64, 48, ("self", "db1", "db2"), 2)
    pj = make_halo_plan_j(psi_j, 4, 14)
    pt = make_halo_plan(psi_t, 4, 14)
    for bj, bt in zip(pj.bases, pt.bases):
        assert [tuple(vars(lv).values()) for lv in bj.levels] == \
            [tuple(vars(lv).values()) for lv in bt.levels]
    with pytest.raises(ValueError):
        make_halo_plan(make_psi(60, 48, ("db1",), 2), 4, 14)
