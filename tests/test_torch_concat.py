"""pfb_tpu_torch/workers/concat.py against pfb_tpu on the CPU: concat_row
and concat_chan on the same xds, every field at 1e-12 relative; and the
port's counterparts of tests/test_concat.py, with their own tolerances.
(``_grid(concat_row=True)`` and ``_grid(nband=...)`` are held against
pfb_tpu in tests/test_torch_post_workers.py.)"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from pfb_tpu.workers.concat import concat_chan as concat_chan_j
from pfb_tpu.workers.concat import concat_row as concat_row_j
from pfb_tpu_torch.utils.ms import simulate_ms
from pfb_tpu_torch.workers.concat import concat_chan, concat_row
from pfb_tpu_torch.workers.grid import _grid
from pfb_tpu_torch.workers.init import _init

torch.set_num_threads(1)
TOL = 1e-12


def _same(a, b):
    assert set(a) == set(b)
    for k in b:
        if isinstance(b[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            scale = max(np.abs(b[k]).max(), 1e-300) if b[k].size else 1.0
            assert np.abs(a[k] - b[k]).max(initial=0.0) <= TOL * scale, k
        else:
            assert a[k] == b[k], k


@pytest.fixture(scope="module")
def xds(tmp_path_factory):
    ms = str(tmp_path_factory.mktemp("concat") / "t.npz")
    simulate_ms(ms, nant=7, ntime=6, nchan=4, nsource=2, fov_deg=0.3,
                seed=5)
    return _init(ms=ms, channels_per_image=1, integrations_per_image=2,
                 write=False, device="cpu")


@pytest.mark.parametrize("how", ["row", "chan1", "chan2", "chan4",
                                 "chan2_row"])
def test_concat_matches_jax(xds, how):
    if how == "row":
        got, ref = concat_row(xds), concat_row_j(xds)
    elif how == "chan2_row":
        got = concat_row(concat_chan(xds, 2))
        ref = concat_row_j(concat_chan_j(xds, 2))
    else:
        nb = int(how[4:])
        got, ref = concat_chan(xds, nb), concat_chan_j(xds, nb)
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        _same(a, b)


def test_concat_chan_overlap_matches_jax():
    rng = np.random.default_rng(4)
    nrow = 12
    uvw = rng.normal(size=(nrow, 3))

    def mk(freq):
        return dict(UVW=uvw, time_out=0.0, ra=0.0, dec=0.0,
                    VIS=(rng.normal(size=(nrow, freq.size))
                         + 1j * rng.normal(size=(nrow, freq.size))),
                    WEIGHT=rng.random((nrow, freq.size)),
                    MASK=(rng.random((nrow, freq.size)) > 0.2).astype(
                        np.uint8),
                    FREQ=freq, freq_out=float(freq.mean()))

    ds = [mk(np.array([1.0e9, 1.1e9, 1.2e9])), mk(np.array([1.2e9, 1.3e9]))]
    for nb in (1, 2, 4):
        for a, b in zip(concat_chan(ds, nb), concat_chan_j(ds, nb)):
            _same(a, b)


# the port's counterparts of tests/test_concat.py


def test_concat_chan_grid_equivalence(tmp_path):
    ms_path = str(tmp_path / "t.npz")
    simulate_ms(ms_path, nant=7, ntime=4, nchan=4, nsource=2,
                fov_deg=0.3, seed=5)
    xds1 = _init(ms=ms_path, channels_per_image=1, write=False,
                 device="cpu")
    xds2 = _init(ms=ms_path, channels_per_image=2, write=False,
                 device="cpu")
    assert len(xds1) == 4 and len(xds2) == 2
    rebinned = concat_chan(xds1, 2)
    assert len(rebinned) == 2
    for a, b in zip(sorted(rebinned, key=lambda d: d["freq_out"]),
                    sorted(xds2, key=lambda d: d["freq_out"])):
        assert_allclose(a["VIS"], b["VIS"])
        assert_allclose(a["WEIGHT"], b["WEIGHT"])
        assert a["freq_out"] == b["freq_out"]
    kw = dict(field_of_view=0.3, write=False, robustness=None, psf=False,
              residual=False, device="cpu")
    dds_a = _grid(xdsi=xds1, nband=2, **kw)
    dds_b = _grid(xdsi=xds2, **kw)
    assert len(dds_a) == 2
    for a, b in zip(dds_a, dds_b):
        assert_allclose(a["DIRTY"], b["DIRTY"], rtol=1e-12)


def test_concat_row(tmp_path):
    ms_path = str(tmp_path / "t.npz")
    simulate_ms(ms_path, nant=6, ntime=4, nchan=2, nsource=2,
                fov_deg=0.3, seed=6)
    xds = _init(ms=ms_path, channels_per_image=1, integrations_per_image=2,
                write=False, device="cpu")
    assert len(xds) == 4
    merged = concat_row(xds)
    assert len(merged) == 2
    nrow_tot = sum(d["UVW"].shape[0] for d in xds
                   if d["freq_out"] == merged[0]["freq_out"])
    assert merged[0]["UVW"].shape[0] == nrow_tot


def test_concat_chan_weighted_overlap():
    rng = np.random.default_rng(3)
    nrow = 16
    uvw = rng.normal(size=(nrow, 3))
    f1 = np.array([1.0e9, 1.1e9, 1.2e9])
    f2 = np.array([1.2e9, 1.3e9])
    common = dict(UVW=uvw, time_out=0.0, ra=0.0, dec=0.0, product="I")

    def mk(freq, seed):
        r = np.random.default_rng(seed)
        return dict(common,
                    VIS=(r.normal(size=(nrow, freq.size)) +
                         1j * r.normal(size=(nrow, freq.size))),
                    WEIGHT=r.random((nrow, freq.size)),
                    MASK=np.ones((nrow, freq.size), np.uint8),
                    FREQ=freq, freq_out=float(freq.mean()))

    d1, d2 = mk(f1, 1), mk(f2, 2)
    out = concat_chan([d1, d2], 1)
    assert len(out) == 1
    o = out[0]
    assert_allclose(o["FREQ"], np.array([1.0e9, 1.1e9, 1.2e9, 1.3e9]))
    assert_allclose(o["VIS"][:, 0], d1["VIS"][:, 0])
    assert_allclose(o["WEIGHT"][:, 3], d2["WEIGHT"][:, 1])
    w1, w2 = d1["WEIGHT"][:, 2], d2["WEIGHT"][:, 0]
    expect = (w1 * d1["VIS"][:, 2] + w2 * d2["VIS"][:, 0]) / (w1 + w2)
    assert_allclose(o["VIS"][:, 2], expect)
    assert_allclose(o["WEIGHT"][:, 2], w1 + w2)


def test_concat_chan_row_mismatch_raises():
    rng = np.random.default_rng(0)
    a = dict(UVW=rng.normal(size=(8, 3)), time_out=0.0,
             VIS=np.ones((8, 2), complex), WEIGHT=np.ones((8, 2)),
             MASK=np.ones((8, 2), np.uint8),
             FREQ=np.array([1e9, 1.1e9]), freq_out=1.05e9)
    b = dict(a, UVW=rng.normal(size=(8, 3)))
    with pytest.raises(ValueError):
        concat_chan([a, b], 1)
