"""pfb_tpu_torch SARA pieces (ops/wavelets.py, ops/psi.py, ops/prox.py)
against pfb_tpu, float64 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfb_tpu.ops import prox as prox_j
from pfb_tpu.ops import psi as psi_j
from pfb_tpu.ops import wavelets as wav_j
from pfb_tpu_torch.ops import prox as prox_t
from pfb_tpu_torch.ops import psi as psi_t
from pfb_tpu_torch.ops import wavelets as wav_t

torch.set_num_threads(1)
NX, NY = 64, 48


def _img(seed=0, shape=(NX, NY)):
    return np.random.default_rng(seed).normal(size=shape)


@pytest.mark.parametrize("wavelet", ["db1", "db2", "db3"])
def test_dwt_perfect_reconstruction_and_parity(wavelet):
    x = _img(1)
    s_t = wav_t.make_spec(wavelet, NX, NY, 3)
    c = wav_t.dwt2d(torch.as_tensor(x), s_t)
    np.testing.assert_allclose(wav_t.idwt2d(c, s_t).numpy(), x, atol=1e-12)
    s_j = wav_j.make_spec(wavelet, NX, NY, 3)
    np.testing.assert_allclose(c.numpy(),
                               np.asarray(wav_j.dwt2d(jnp.asarray(x), s_j)),
                               atol=1e-12)


def test_psi_round_trip_and_parity():
    """hdot(dot(x)) = nbasis x (1e-11, as tests/test_psi_prox.py), and
    both directions match the JAX package at 1e-12."""
    bases = ("self", "db1", "db2")
    x = np.stack([_img(2), _img(3)])
    p_t = psi_t.make_psi(NX, NY, bases, 3)
    p_j = psi_j.make_psi(NX, NY, bases, 3)
    a = psi_t.psi_dot(torch.as_tensor(x), p_t)
    np.testing.assert_allclose(psi_t.psi_hdot(a, p_t).numpy(),
                               len(bases) * x, atol=1e-11)
    a_j = np.asarray(psi_j.psi_dot(jnp.asarray(x), p_j))
    np.testing.assert_allclose(a.numpy(), a_j, atol=1e-12)
    coeffs = np.random.default_rng(4).normal(size=a_j.shape)
    np.testing.assert_allclose(
        psi_t.psi_hdot(torch.as_tensor(coeffs), p_t).numpy(),
        np.asarray(psi_j.psi_hdot(jnp.asarray(coeffs), p_j)), atol=1e-12)


def test_prox_and_dual_update_match_jax():
    rng = np.random.default_rng(5)
    v = rng.normal(size=(3, 2, 8, 9))
    vp = rng.normal(size=v.shape)
    w = rng.random((2, 8, 9)) + 0.5
    for fn in ("prox_21", "prox_21m"):
        np.testing.assert_allclose(
            getattr(prox_t, fn)(torch.as_tensor(v), 0.7,
                                torch.as_tensor(w)).numpy(),
            np.asarray(getattr(prox_j, fn)(jnp.asarray(v), 0.7,
                                           jnp.asarray(w))), atol=1e-13)
    np.testing.assert_allclose(
        prox_t.dual_update_21m(torch.as_tensor(vp), torch.as_tensor(v),
                               0.9, sigma=1.3,
                               weight=torch.as_tensor(w)).numpy(),
        np.asarray(prox_j.dual_update_21m(jnp.asarray(vp), jnp.asarray(v),
                                          0.9, sigma=1.3,
                                          weight=jnp.asarray(w))),
        atol=1e-13)
    # zero band-sum leaves the dual untouched in both
    z = np.zeros_like(v)
    np.testing.assert_array_equal(
        prox_t.dual_update_21m(torch.as_tensor(z), torch.as_tensor(z),
                               0.9).numpy(), z)


@pytest.mark.parametrize("zero_columns", [False, True])
def test_dual_update_21_matches_jax(zero_columns):
    """tests/test_psi_prox.py:73's case (3 bands, 2 bases, 6 x 7, lam
    0.25, sigma 1.7, a weight a coefficient) within 1e-12 relative; with
    ``zero_columns`` some coefficients are 0 in every band, where both
    leave the dual at 0."""
    rng = np.random.default_rng(2)
    nband, nbasis, ny, nx = 3, 2, 6, 7
    vp = rng.normal(size=(nband, nbasis, ny, nx))
    v = rng.normal(size=(nband, nbasis, ny, nx))
    w = np.abs(rng.normal(size=(nbasis, ny, nx)))
    if zero_columns:
        vp[:, 0, :2] = v[:, 0, :2] = 0.0
        vp[:, 1, :, 3] = v[:, 1, :, 3] = 0.0
    got = prox_t.dual_update_21(torch.as_tensor(vp), torch.as_tensor(v),
                                0.25, sigma=1.7,
                                weight=torch.as_tensor(w)).numpy()
    ref = np.asarray(prox_j.dual_update_21(jnp.asarray(vp), jnp.asarray(v),
                                           0.25, sigma=1.7,
                                           weight=jnp.asarray(w)))
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    if zero_columns:
        assert not got[:, 0, :2].any() and not got[:, 1, :, 3].any()
        assert np.isfinite(got).all()
    # default sigma and weight
    np.testing.assert_allclose(
        prox_t.dual_update_21(torch.as_tensor(vp), torch.as_tensor(v),
                              0.4).numpy(),
        np.asarray(prox_j.dual_update_21(jnp.asarray(vp), jnp.asarray(v),
                                         0.4)), rtol=1e-12, atol=1e-14)


# ---------------------------------------------------------------------
# S1 / S2's route and launch arithmetic (ops/psi.py:sara_plan). The
# kernels themselves run only on the card (tests/test_torch_gpu.py).

# the card tests' shapes: (nband, nx, ny), bases, levels
PLAN_CASES = [((8, 2048, 2048), ("self", "db1", "db2"), 3),
              ((2, 3072, 3072), ("self", "db1", "db2"), 3)] + [
    ((nb, nx, ny), ("self", w), nl)
    for nb, nx, ny in ((3, 1350, 1000), (2, 64, 48), (1, 100, 100))
    for w in ("db1", "db2", "db3", "db4")
    for nl in range(1, wav_t.dwt_max_level(min(nx, ny), w) + 1)]
SMALL_CASES = [c for c in PLAN_CASES if c[0][1] <= 135] + [
    ((3, 135, 100), ("self", "db1", "db2", "db3", "db4"), 2),
    ((1, 70, 90), ("db5", "self"), 1), ((2, 66, 66), ("db6", "db2"), 2)]


def _id(case):
    (nb, nx, ny), bases, nl = case
    return f"{nb}x{nx}x{ny}-{'+'.join(bases)}-L{nl}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_psi_cpu_route_is_the_plain_version(dtype):
    """CPU tensors, float32 or float64, take the plain route: psi.plain
    counts each call, psi.kernel none, no kernel launches, and the
    outputs are the plain versions' bit for bit."""
    from pfb_tpu_torch.utils import profiling
    p = psi_t.make_psi(NX, NY, ("self", "db1", "db2"), 3)
    x = torch.as_tensor(np.stack([_img(6), _img(7)]), dtype=dtype)
    a = torch.as_tensor(np.random.default_rng(8).normal(
        size=(2, 3, p.Nymax, p.Nxmax)), dtype=dtype)
    launches = (psi_t.psi_dot.launches, psi_t.psi_hdot.launches)
    profiling.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        c = psi_t.psi_dot(x, p)
        h = psi_t.psi_hdot(a, p)
        counts = profiling.counters()
    profiling.reset()
    assert counts.get("psi.plain") == 2 and "psi.kernel" not in counts
    assert (psi_t.psi_dot.launches, psi_t.psi_hdot.launches) == launches
    assert c.dtype == h.dtype == dtype
    assert torch.equal(c, psi_t.psi_dot_plain(x, p))
    assert torch.equal(h, psi_t.psi_hdot_plain(a, p))


def test_kernel_constants_mirror_the_source():
    """ops/psi.py's tile edge and record fields are csrc/sara.cu's."""
    import re
    from pathlib import Path
    src = (Path(psi_t.__file__).parents[1] / "csrc" / "sara.cu").read_text()
    assert int(re.search(r"kSaraTile = (\d+);", src)[1]) == psi_t._TILE
    enum = src[src.index("enum {"):src.index("kSaraRec")]
    fields = [f.lower() for f in re.findall(r"\bR_(\w+),", enum)]
    assert fields == [f.lower() for f in psi_t.LevelRec._fields]


@pytest.mark.parametrize("case", PLAN_CASES, ids=_id)
def test_sara_plan_against_make_spec(case):
    """Tile counts, block origins, scratch offsets and sizes, and the
    chain of approximations from level to level, from make_spec."""
    (nb, nx, ny), bases, nl = case
    p = psi_t.make_psi(nx, ny, bases, nl)
    plan = psi_t.sara_plan(p, nb)
    T, slot = psi_t._TILE, p.Nymax * p.Nxmax
    wav = [(s, sp) for s, sp in enumerate(p.specs) if sp is not None]
    assert len(plan.dot) == len(plan.hdot) == nl
    # scratch: one (nband, sy[k], sx[k]) block a basis and level k < nl - 1,
    # end to end
    blocks = sorted((r.dst, nb * r.Cx * r.Cy, k) for k, recs in
                    enumerate(plan.dot) for r in recs if r.dst >= 0)
    assert [k for _, _, k in blocks] == sorted(
        k for k in range(nl - 1) for _ in wav)
    assert [o for o, _, _ in blocks] == list(
        np.cumsum([0] + [n for _, n, _ in blocks])[:-1])
    assert plan.scratch == sum(n for _, n, _ in blocks)
    for k, recs in enumerate(plan.dot):
        rw = [r for r in recs if r.F]
        assert len(rw) == len(wav)
        for r, (s, sp) in zip(rw, wav):
            assert r.F == sp.F and r.slot == s * slot
            assert (r.Cx, r.Cy) == (sp.sx[k], sp.sy[k])
            assert (r.px, r.py) == (sp.ix[k][1] - 2 * sp.sx[k],
                                    sp.iy[k][1] - 2 * sp.sy[k])
            assert r.px >= 0 and r.py >= 0
            assert r.px + 2 * r.Cx <= p.Nxmax and r.py + 2 * r.Cy <= p.Nymax
            assert (r.tiles_x - 1) * T < r.Cx <= r.tiles_x * T
            assert (r.tiles_y - 1) * T < r.Cy <= r.tiles_y * T
            assert list(plan.taps[r.taps:r.taps + 2 * r.F]) == \
                list(sp.dec_lo + sp.dec_hi)
            if k == 0:
                assert (r.src, r.nx, r.ny, r.src_ld) == (-1, nx, ny, ny)
                assert r.src_band == nx * ny
            else:
                prev = plan.dot[k - 1][[q.slot for q in plan.dot[k - 1]]
                                       .index(r.slot)]
                assert r.src == prev.dst >= 0 and r.src_band == prev.dst_band
                assert (r.nx, r.ny, r.src_ld) == (prev.Cx, prev.Cy, prev.Cx)
            if k < nl - 1:
                assert r.dst >= 0
                assert (r.dst_band, r.dst_ld) == (r.Cx * r.Cy, r.Cx)
            else:
                assert r.dst == -1
    self_dot = [r for r in plan.dot[0] if not r.F]
    assert len(self_dot) == ("self" in bases)
    for r in self_dot:
        assert (r.Cx, r.Cy, r.src_ld) == (p.Nxmax, p.Nymax, ny)
        assert r.tiles_x * 2 * T >= p.Nxmax and r.tiles_y * 2 * T >= p.Nymax
    # synthesis: deepest first, each level's output the next one's
    # low-low quadrant, the last into the image with 'self'
    for i, recs in enumerate(plan.hdot):
        k = nl - 1 - i
        for r in recs:
            assert (r.tiles_x - 1) * 2 * T < r.nx <= r.tiles_x * 2 * T
            assert (r.tiles_y - 1) * 2 * T < r.ny <= r.tiles_y * 2 * T
            if not r.F:
                assert k == 0 and (r.nx, r.ny) == (nx, ny)
                continue
            d = next(q for q in plan.dot[k] if q.slot == r.slot)
            assert (r.Cx, r.Cy, r.px, r.py) == (d.Cx, d.Cy, d.px, d.py)
            assert (r.src, r.src_band) == (d.dst, d.dst_band)
            if k:
                assert (r.nx, r.ny) == (d.nx, d.ny)
                assert (r.dst, r.dst_ld) == (d.src, d.src_ld)
            else:
                assert (r.nx, r.ny, r.dst, r.dst_ld, r.dst_band) == \
                    (nx, ny, -1, ny, nx * ny)
    assert [len(recs) for recs in plan.hdot][-1] == len(bases)


@pytest.mark.parametrize("case", PLAN_CASES, ids=_id)
def test_zero_rects_cover_what_no_block_does(case):
    """The rectangles and the levels' blocks tile each slot, disjoint."""
    (nb, nx, ny), bases, nl = case
    p = psi_t.make_psi(nx, ny, bases, nl)
    plan = psi_t.sara_plan(p, nb)
    slot = p.Nymax * p.Nxmax
    for s, sp in enumerate(p.specs):
        if sp is None:
            continue
        paint = np.zeros((p.Nymax, p.Nxmax), dtype=np.int32)
        for k in range(nl):
            py, px = psi_t.block_origin(sp, k)
            blk = np.zeros_like(paint, dtype=bool)
            blk[py:py + 2 * sp.sy[k], px:px + 2 * sp.sx[k]] = True
            paint[blk & (paint == 0)] = 1
        for off, y0, y1, x0, x1 in plan.rects:
            if off == s * slot:
                assert y0 < y1 and x0 < x1
                paint[y0:y1, x0:x1] += 2
        assert set(np.unique(paint)) <= {1, 2}


def _slot(out, r, p):
    return out.view(out.shape[0], -1)[:, r.slot:r.slot + p.Nymax * p.Nxmax] \
        .view(-1, p.Nymax, p.Nxmax)


def _approx(scratch, off, band, ld, n, nb):
    """A (nb, n, ld) scratch block in the packed orientation, as an image
    (nb, ld, n)."""
    return scratch[off:off + nb * band].view(nb, n, ld).transpose(-1, -2)


def _run_plan(x, a, p, plan):
    """sara_plan's launches carried out by the plain level functions
    (wavelets.py's _dwt_level, _idwt_level) on NaN-filled outputs and
    scratch: its offsets, origins, sizes and rectangles, without the
    kernels' tiling."""
    nb = x.shape[0]
    out = torch.full((nb, p.nbasis, p.Nymax, p.Nxmax), float("nan"),
                     dtype=x.dtype)
    scratch = torch.full((max(plan.scratch, 1),), float("nan"),
                         dtype=x.dtype)
    for off, y0, y1, x0, x1 in plan.rects:
        out.view(nb, -1)[:, off:off + p.Nymax * p.Nxmax].view(
            nb, p.Nymax, p.Nxmax)[:, y0:y1, x0:x1] = 0
    for recs in plan.dot:
        for r in recs:
            slot = _slot(out, r, p)
            if not r.F:
                slot.zero_()
                slot[:, :r.ny, :r.nx] = x.transpose(-1, -2)
                continue
            img = x if r.src < 0 else _approx(scratch, r.src, r.src_band,
                                              r.src_ld, r.ny, nb)
            blk, _ = wav_t._dwt_level(img, p.specs[r.slot // (
                p.Nymax * p.Nxmax)])
            keep = blk.clone()
            if r.dst >= 0:
                _approx(scratch, r.dst, r.dst_band, r.dst_ld, r.Cy, nb)[:] = \
                    blk[:, :r.Cy, :r.Cx].transpose(-1, -2)
                dst = slot[:, r.py:r.py + 2 * r.Cy, r.px:r.px + 2 * r.Cx]
                keep[:, :r.Cy, :r.Cx] = dst[:, :r.Cy, :r.Cx]
            slot[:, r.py:r.py + 2 * r.Cy, r.px:r.px + 2 * r.Cx] = keep
    img = None
    for recs in plan.hdot:
        total = None
        for r in recs:
            slot = _slot(a, r, p)
            if not r.F:
                term = slot[:, :r.ny, :r.nx].transpose(-1, -2)
            else:
                blk = slot[:, r.py:r.py + 2 * r.Cy,
                           r.px:r.px + 2 * r.Cx].clone()
                if r.src >= 0:
                    blk[:, :r.Cy, :r.Cx] = _approx(
                        scratch, r.src, r.src_band, r.src_ld, r.Cy,
                        nb).transpose(-1, -2)
                sp = p.specs[r.slot // (p.Nymax * p.Nxmax)]
                k = sp.sx.index(r.Cx)
                term = wav_t._idwt_level(blk, sp, sp.spx[k], sp.spy[k])[
                    :, :r.nx, :r.ny]
            if r.dst >= 0:
                _approx(scratch, r.dst, r.dst_band, r.dst_ld, r.ny, nb)[:] = \
                    term
            else:
                total = term if total is None else total + term
        img = total
    return out, img


@pytest.mark.parametrize("case", SMALL_CASES, ids=_id)
def test_sara_plan_carried_out_is_psi(case):
    """The plan's launches, each record carried out by the plain level
    functions, give psi_dot_plain and psi_hdot_plain (float64)."""
    (nb, nx, ny), bases, nl = case
    p = psi_t.make_psi(nx, ny, bases, nl)
    x = torch.as_tensor(np.random.default_rng(9).normal(size=(nb, nx, ny)))
    a = torch.as_tensor(np.random.default_rng(10).normal(
        size=(nb, p.nbasis, p.Nymax, p.Nxmax)))
    c, h = _run_plan(x, a, p, psi_t.sara_plan(p, nb))
    ref = psi_t.psi_dot_plain(x, p)
    assert not torch.isnan(c).any()
    np.testing.assert_allclose(c.numpy(), ref.numpy(), rtol=0, atol=1e-13)
    np.testing.assert_allclose(h.numpy(), psi_t.psi_hdot_plain(a, p).numpy(),
                               rtol=0, atol=1e-12)
