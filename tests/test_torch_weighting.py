"""pfb_tpu_torch robust weighting (ops/weighting.py, _grid(robustness=))
against pfb_tpu on the same numpy inputs, CPU, float64.

- uv counts: the native builder and the numpy path against
  pfb_tpu.compute_counts_host with a 0/1 mask, 1e-12 relative (sums in
  another order); with a mask of other nonzero values both port paths
  count a visibility once;
- Briggs weights and the count filters: 1e-12 relative;
- _grid(robustness=0.0, backend="dft") products: 1e-10 relative, and the
  COUNTS the JAX package writes to its dds store read back by the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfb_tpu.ops import weighting as w_j
from pfb_tpu.utils.ms import simulate_ms as simulate_ms_j
from pfb_tpu.utils.simulation import image_size_for, simulate_obs
from pfb_tpu.workers.grid import _grid as grid_j
from pfb_tpu.workers.init import _init as init_j
from pfb_tpu_torch import native
from pfb_tpu_torch.ops import weighting as w_t
from pfb_tpu_torch.utils import dstore
from pfb_tpu_torch.workers.grid import _grid as grid_t
from pfb_tpu_torch.workers.init import _init as init_t

torch.set_num_threads(1)
pmp = pytest.mark.parametrize
NX = 64


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / \
        np.abs(np.asarray(b)).max()


@pytest.fixture(scope="module")
def obs():
    o = simulate_obs(nant=9, ntime=8, nchan=3, seed=5)
    _, cell = image_size_for(o, fov_deg=0.2)
    rng = np.random.default_rng(1)
    mask = (rng.random((o.uvw.shape[0], o.freq.size)) > 0.2).astype(
        np.float64)
    return dict(uvw=o.uvw, freq=o.freq, cell=cell, mask=mask)


@pmp("k", [0, 6])
def test_counts_native_and_numpy_match_jax(obs, k):
    args = (obs["uvw"], obs["freq"], obs["mask"], NX, NX, obs["cell"],
            obs["cell"])
    ref = w_j.compute_counts_host(*args, k=k)
    assert ref.sum() > 0
    assert _rel(w_t.compute_counts_numpy(*args, k=k), ref) < 1e-12
    if native.get_lib() is None:
        pytest.skip("no C++ compiler")
    assert _rel(native.pg_counts_native(*args, k=k), ref) < 1e-12
    assert _rel(w_t.compute_counts_host(*args, k=k), ref) < 1e-12


def test_counts_gate_on_nonzero_mask(obs):
    """A mask entry of 2 counts once in both port paths (the reference's
    numba kernel and the native builder gate on mask != 0)."""
    m2 = obs["mask"] * 2.0
    args = (obs["uvw"], obs["freq"])
    rest = (NX, NX, obs["cell"], obs["cell"])
    ref = w_t.compute_counts_numpy(*args, obs["mask"], *rest)
    np.testing.assert_array_equal(w_t.compute_counts_numpy(*args, m2, *rest),
                                  ref)
    if native.get_lib() is None:
        pytest.skip("no C++ compiler")
    # the native threads' grids are reduced in no fixed order
    assert _rel(native.pg_counts_native(*args, m2, *rest), ref) < 1e-12


def _taps(obs, nx, cell, k):
    """(lowest, highest) stencil cell index, over u and v, of the live
    samples of ``obs`` on an nx^2 grid of ``cell``."""
    from pfb_tpu_torch.ops.dft import LIGHTSPEED
    u_cell = 1.0 / (nx * cell)
    umax = abs(-1.0 / cell / 2.0 - u_cell / 2.0)
    g = (obs["uvw"][:, :2, None] * obs["freq"][None, None, :] / LIGHTSPEED
         + umax) / u_cell  # (row, 2, chan)
    live = np.broadcast_to((obs["mask"] != 0)[:, None, :], g.shape)
    c = (np.round(g) if k else np.floor(g))[live]
    return c.min() - k // 2, c.max() + max(k // 2 - 1, 0)


def _edge_cell(obs, share):
    """A cell on which the grid spans ``share`` of the data's uv extent
    (1 / (share * 2 max|uv| f_max / c))."""
    from pfb_tpu_torch.ops.dft import LIGHTSPEED
    return 1.0 / (share * 2 * np.abs(obs["uvw"][:, :2]).max()
                  * obs["freq"].max() / LIGHTSPEED)


@pmp("k", [6, 0])
def test_device_counts_match_jax_inside_the_grid(obs, k):
    """compute_counts against the JAX package's device counts where every
    stencil tap lies inside the grid (a cell of 1 / (4 max|uv| f_max / c)
    at nx = 64, as tests/test_gridder.py:99), 0/1 mask, 1e-12 of max."""
    nx, cell = 64, _edge_cell(obs, 2.0)
    lo, hi = _taps(obs, nx, cell, k)
    assert lo >= 0 and hi < nx, (lo, hi)
    args = (obs["uvw"], obs["freq"], obs["mask"], nx, nx, cell, cell)
    ref = np.asarray(w_j.compute_counts(
        jnp.asarray(obs["uvw"]), jnp.asarray(obs["freq"]),
        jnp.asarray(obs["mask"]), *args[3:], k=k))
    got = w_t.compute_counts(*args, k=k, device="cpu")
    assert got.dtype == torch.float64 and got.shape == (nx, nx)
    assert ref.sum() > 0
    assert _rel(got.numpy(), ref) < 1e-12


@pmp("k", [6, 0])
def test_device_counts_drop_taps_off_the_grid(obs, k):
    """On a 32^2 grid that spans 3/4 of the data's uv extent, taps fall
    below 0 and past nx - 1: compute_counts drops them all, as the host
    counts (native and numpy) do."""
    nx, cell = 32, _edge_cell(obs, 0.75)
    lo, hi = _taps(obs, nx, cell, k)
    assert lo < 0 and hi >= nx, (lo, hi)
    args = (obs["uvw"], obs["freq"], obs["mask"], nx, nx, cell, cell)
    ref = w_t.compute_counts_numpy(*args, k=k)
    got = w_t.compute_counts(*args, k=k, device="cpu").numpy()
    assert _rel(got, ref) < 1e-12
    assert _rel(got, w_t.compute_counts_host(*args, k=k)) < 1e-12


def test_device_counts_one_visibility_at_the_low_edge():
    """One visibility at ug = 1.0 (k = 6: taps on rows -2 .. 3): only rows
    0-3 get counts, and the counts are the host's."""
    from pfb_tpu_torch.ops.dft import LIGHTSPEED
    nx, cell, freq = 32, 1e-4, np.array([LIGHTSPEED])
    u_cell = 1.0 / (nx * cell)
    umax = abs(-1.0 / cell / 2.0 - u_cell / 2.0)
    uvw = np.array([[1.0 * u_cell - umax, 0.25 * u_cell, 0.0]])
    mask = np.ones((1, 1))
    got = w_t.compute_counts(uvw, freq, mask, nx, nx, cell, cell,
                             device="cpu").numpy()
    ref = w_t.compute_counts_numpy(uvw, freq, mask, nx, nx, cell, cell)
    assert sorted(set(np.nonzero(got)[0])) == [0, 1, 2, 3]
    assert _rel(got, ref) < 1e-12


@pmp("k", [6, 0])
def test_device_counts_gate_on_nonzero_mask(obs, k):
    """A mask of 2s (and of other nonzero values) gives the counts of a
    mask of 1s, in float32 and float64 uvw."""
    nx, cell = 64, obs["cell"]
    rest = (nx, nx, cell, cell)
    m2 = obs["mask"] * np.where(np.arange(obs["mask"].shape[1]) % 2, 2.0,
                                0.5)
    for uvw in (obs["uvw"], obs["uvw"].astype(np.float32)):
        ref = w_t.compute_counts(uvw, obs["freq"], obs["mask"], *rest, k=k,
                                 device="cpu")
        got = w_t.compute_counts(uvw, obs["freq"], m2, *rest, k=k,
                                 device="cpu")
        assert got.dtype == torch.as_tensor(uvw).dtype
        assert ref.sum() > 0
        torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pmp("k", [6, 0])
def test_counts_host_row_chunk(obs, k):
    """compute_counts_host takes the JAX package's row_chunk (37 rows, as
    tests/test_gridder.py:259) and gives the unchunked counts."""
    args = (obs["uvw"], obs["freq"], obs["mask"], NX, NX, obs["cell"],
            obs["cell"])
    ref = w_t.compute_counts_numpy(*args, k=k)
    assert _rel(w_t.compute_counts_host(*args, k=k, row_chunk=37), ref) \
        < 1e-12
    assert _rel(w_t.compute_counts_numpy(*args, k=k, row_chunk=37), ref) \
        < 1e-12


def test_native_counts_reject_wide_stencil(obs):
    if native.get_lib() is None:
        pytest.skip("no C++ compiler")
    with pytest.raises(ValueError, match="k=18"):
        native.pg_counts_native(obs["uvw"], obs["freq"], obs["mask"], NX, NX,
                                obs["cell"], obs["cell"], k=18)


@pmp("robust", [-2.0, 0.0, 2.0])
def test_counts_to_weights_matches_jax(obs, robust):
    counts = w_j.compute_counts_host(obs["uvw"], obs["freq"], obs["mask"],
                                     NX, NX, obs["cell"], obs["cell"])
    args = (NX, NX, obs["cell"], obs["cell"], robust)
    ref = w_j.counts_to_weights(jnp.asarray(counts), jnp.asarray(obs["uvw"]),
                                jnp.asarray(obs["freq"]), *args)
    got = w_t.counts_to_weights(torch.as_tensor(counts),
                                torch.as_tensor(obs["uvw"]),
                                torch.as_tensor(obs["freq"]), *args)
    assert got.dtype == torch.float64
    assert np.abs(np.asarray(ref)).max() > 0
    assert _rel(got.numpy(), ref) < 1e-12
    zero = w_t.counts_to_weights(torch.zeros((NX, NX), dtype=torch.float64),
                                 torch.as_tensor(obs["uvw"]),
                                 torch.as_tensor(obs["freq"]), *args)
    assert not zero.any()


@pmp("nbox", [None, 3])
def test_filter_extreme_counts_matches_jax(obs, nbox):
    counts = w_j.compute_counts_host(obs["uvw"], obs["freq"], obs["mask"],
                                     NX, NX, obs["cell"], obs["cell"])
    ref = w_j.filter_extreme_counts(counts, level=5.0, nbox=nbox)
    got = w_t.filter_extreme_counts(counts, level=5.0, nbox=nbox)
    assert not np.array_equal(ref, counts)
    assert _rel(got, ref) < 1e-12


@pytest.fixture(scope="module")
def gridded(tmp_path_factory):
    d = tmp_path_factory.mktemp("weighting")
    ms = str(d / "obs.npz")
    simulate_ms_j(ms, nant=7, ntime=4, nchan=2, nsource=2, fov_deg=0.2,
                  seed=4)
    kw = dict(nx=NX, ny=NX, field_of_view=0.2, robustness=0.0, psf=True,
              residual=False, backend="dft",
              filter_extreme_counts_flag=True, filter_level=5.0)
    xj = init_j(ms=ms, output_filename=str(d / "j"), channels_per_image=1)
    xt = init_t(ms=ms, channels_per_image=1, write=False, device="cpu")
    dj = grid_j(xdsi=xj, output_filename=str(d / "j"), suffix="main", **kw)
    dt = grid_t(xdsi=xt, write=False, device="cpu", **kw)
    return dict(d=d, dj=dj, dt=dt)


def test_grid_robust_matches_jax(gridded):
    for p, q in zip(gridded["dj"], gridded["dt"]):
        for key in ("DIRTY", "PSF", "WEIGHT", "COUNTS"):
            assert _rel(q[key], p[key]) < 1e-10, key
        assert q["WSUM"][0] == pytest.approx(p["WSUM"][0], rel=1e-12)
        assert q["robustness"] == 0.0


def test_port_reads_counts_written_by_jax(gridded):
    back = dstore.read_store(str(gridded["d"] / "j_I_main.dds"))
    for ds, q in zip(back, gridded["dt"]):
        assert _rel(ds["COUNTS"], q["COUNTS"]) < 1e-10
