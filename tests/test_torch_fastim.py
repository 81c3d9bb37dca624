"""pfb_tpu_torch's fastim and smoovie workers against pfb_tpu on the CPU
in float64, on one observation (7 antennas, 6 integrations in 2 scans,
4 channels) fed to both packages.

- fastim's snapshots, per backend, at the tolerances that
  tests/test_torch_pgridder.py and tests/test_torch_wgridder.py use for
  the same backend against the JAX package (1e-10 relative for dft,
  wgrid and pg): each fds entry's RESIDUAL and WSUM, and its ids and
  coordinates exactly; with and without a model (an mds from
  model2comps, degridded at ``channels_per_degrid_image``), Briggs
  weights with the extreme-count filter, l2 reweighting, scan and
  channel selection and a target;
- the snapshots of the exact DFT sum to the one image of the whole
  observation (gridding is linear): 1e-10 of its peak;
- smoovie's frames from the same fds: 1e-12 relative, and the movie
  files the JAX package writes;
- the port's counterparts of tests/test_aux_workers.py:47, 95, 217, 255.
"""

import os

import numpy as np
import pytest
import torch

from pfb_tpu.utils.ms import simulate_ms
from pfb_tpu.workers.fastim import _fastim as fastim_j
from pfb_tpu.workers.grid import _grid as grid_j
from pfb_tpu.workers.init import _init as init_j
from pfb_tpu.workers.model2comps import _model2comps as m2c_j
from pfb_tpu.workers.smoovie import _smoovie as smoovie_j
from pfb_tpu_torch.workers.fastim import _fastim as fastim_t
from pfb_tpu_torch.workers.smoovie import _smoovie as smoovie_t

torch.set_num_threads(1)
pmp = pytest.mark.parametrize
FOV = 0.3


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / \
        np.abs(np.asarray(b)).max()


@pytest.fixture(scope="module")
def obs(tmp_path_factory):
    d = tmp_path_factory.mktemp("fastim")
    ms = str(d / "t.npz")
    model, *_ = simulate_ms(ms, nant=7, ntime=6, nchan=4, nsource=2,
                            fov_deg=FOV, seed=5, nscan=2)
    dds = grid_j(xdsi=init_j(ms=ms, write=False, channels_per_image=2),
                 field_of_view=FOV, psf=False, residual=False, write=False)
    for ds in dds:  # a deconvolved model: 0.8 of the truth
        ds["MODEL"] = 0.8 * model[2 * ds["bandid"]]
    mds = m2c_j(ddsi=dds, nbasisf=2)
    msd = dict(np.load(ms))
    ra = float(np.atleast_1d(msd.get("FIELD_RA", msd.get("RA")))[0])
    dec = float(np.atleast_1d(msd.get("FIELD_DEC", msd.get("DEC")))[0])
    return dict(d=d, ms=ms, mds=mds, target=f"{ra + 5e-4},{dec - 4e-4}",
                freqs=msd["FREQ"])


CASES = {
    "dft": dict(backend="dft", integrations_per_image=2,
                channels_per_image=1),
    "dft_select": dict(backend="dft", integrations_per_image=1,
                       channels_per_grid_image=-1, scans="1",
                       robustness=0.0, filter_extreme_counts_flag=True,
                       freq_range="chan:1-3"),
    "wgrid_model": dict(backend="wgrid", epsilon=1e-7,
                        integrations_per_image=2, channels_per_grid_image=4,
                        channels_per_degrid_image=2, mds=True,
                        robustness=0.0, l2reweight_dof=2.0),
    "pg_model": dict(backend="pg", epsilon=1e-7, integrations_per_image=3,
                     channels_per_grid_image=2, channels_per_degrid_image=1,
                     mds=True, target=True),
    "pg": dict(backend="pg", epsilon=1e-7, integrations_per_image=1,
               channels_per_grid_image=-1, robustness=-1.0),
}


def _kw(obs, case):
    kw = dict(CASES[case], field_of_view=FOV, write=False)
    if kw.pop("mds", False):
        kw["mds"] = obs["mds"]
    if kw.pop("target", False):
        kw["target"] = obs["target"]
    if kw.get("freq_range") == "chan:1-3":
        f = obs["freqs"]
        kw["freq_range"] = f"{f[1] - 1.0}:{f[3] + 1.0}"
    return kw


@pmp("case", list(CASES))
def test_fastim_matches_jax(obs, case):
    kw = _kw(obs, case)
    ft = fastim_t(ms=obs["ms"], device="cpu", **kw)
    fj = fastim_j(ms=obs["ms"], **kw)
    assert len(ft) == len(fj) > 1
    for a, b in zip(ft, fj):
        assert set(a) == set(b)
        for k in ("time_out", "freq_out", "timeid", "bandid", "scanid",
                  "cell_rad", "x0", "y0", "ra", "dec"):
            assert a[k] == b[k], k
        assert a["RESIDUAL"].dtype == b["RESIDUAL"].dtype == np.float32
        assert _rel(a["WSUM"], b["WSUM"]) < 1e-12
    # float32 storage, as both packages' precision="single"; the float64
    # snapshots at the backend's tolerance
    kw64 = dict(kw, precision="double")
    ft = fastim_t(ms=obs["ms"], device="cpu", **kw64)
    fj = fastim_j(ms=obs["ms"], **kw64)
    for a, b in zip(ft, fj):
        assert _rel(a["RESIDUAL"], b["RESIDUAL"]) < 1e-10
    if "target" in kw:
        assert ft[0]["x0"] != 0.0


def test_fastim_snapshots_sum_to_one_image(obs):
    """Gridding is linear: the 6 one-integration snapshots (natural
    weights, exact DFT) sum to the image of all integrations at once,
    RESIDUAL and WSUM, with and without a model."""
    for mds in (None, obs["mds"]):
        kw = dict(backend="dft", channels_per_grid_image=-1,
                  field_of_view=FOV, write=False, precision="double",
                  mds=mds, channels_per_degrid_image=2)
        snaps = fastim_t(ms=obs["ms"], device="cpu",
                         integrations_per_image=1, **kw)
        one = fastim_t(ms=obs["ms"], device="cpu",
                       integrations_per_image=6, **kw)
        assert len(snaps) == 6 and len(one) == 2   # one image per scan
        total = sum(ds["RESIDUAL"] for ds in snaps)
        whole = sum(ds["RESIDUAL"] for ds in one)
        assert np.abs(total - whole).max() < 1e-10 * np.abs(whole).max()
        ws = sum(float(ds["WSUM"][0]) for ds in snaps)
        assert abs(ws - sum(float(ds["WSUM"][0]) for ds in one)) < \
            1e-12 * ws


@pmp("opt", [dict(animate_axis="time", time_bin=2),
             dict(animate_axis="freq", annotate=True, movie_cubes=True),
             dict(animate_axis="time", respect_scan_boundaries=False,
                  time_bin=3, fits_mfs=True, fits_cubes=True,
                  out_format="mp4")])
def test_smoovie_matches_jax(obs, tmp_path, opt):
    fds = fastim_j(ms=obs["ms"], integrations_per_image=1,
                   channels_per_image=2, field_of_view=FOV, write=False)
    ft = smoovie_t(fdsi=fds, output_filename=str(tmp_path / "t"), **opt)
    fj = smoovie_j(fdsi=fds, output_filename=str(tmp_path / "j"), **opt)
    assert len(ft) == len(fj) > 0
    for a, b in zip(ft, fj):
        assert _rel(a, b) < 1e-12
    made = sorted(os.listdir(tmp_path))
    assert [p[1:] for p in made if p.startswith("t")] == \
        [p[1:] for p in made if p.startswith("j")]
    assert any("_movie." in p for p in made)


def _gif_frames(path):
    from PIL import Image
    im = Image.open(path)
    out = []
    for k in range(im.n_frames):
        im.seek(k)
        out.append(np.asarray(im.convert("RGB")))
    return out, im.info.get("duration"), im.info.get("loop")


def test_grey_map_is_matplotlibs():
    """smoovie's numpy grey map gives matplotlib's "gray" bytes."""
    import matplotlib

    from pfb_tpu_torch.workers.smoovie import _grey_rgba
    x = np.random.default_rng(7).random((64, 33))
    x[0, :5] = [0.0, 1.0, 1 / 256, 255 / 256, np.nan]
    ref = (matplotlib.colormaps.get_cmap("gray")(x) * 255).astype(np.uint8)
    np.testing.assert_array_equal((_grey_rgba(x) * 255).astype(np.uint8),
                                  ref)


def test_smoovie_without_matplotlib_or_pil(obs, tmp_path, monkeypatch):
    """With neither matplotlib nor PIL importable (the card's machine has
    neither), smoovie's grey movie comes from the numpy colour map and
    GIF encoder: its frames decode to matplotlib's "gray" bytes of the
    JAX package's frames under the reference's median-rms scaling, every
    level kept (PIL's writer keeps 16 here), with the frame time and
    looping of the JAX package's GIF."""
    import sys

    import matplotlib
    fds = fastim_j(ms=obs["ms"], integrations_per_image=1,
                   channels_per_image=2, field_of_view=FOV, write=False)
    kw = dict(fdsi=fds, animate_axis="time", time_bin=2)
    fj = smoovie_j(output_filename=str(tmp_path / "j"), **kw)
    with monkeypatch.context() as m:
        for mod in ("PIL", "PIL.Image", "matplotlib"):
            m.setitem(sys.modules, mod, None)
        ft = smoovie_t(output_filename=str(tmp_path / "t"), **kw)
    for a, b in zip(ft, fj):
        assert _rel(a, b) < 1e-12
    gt, dt, lt = _gif_frames(tmp_path / "t_I_movie.gif")
    _, dj, lj = _gif_frames(tmp_path / "j_I_movie.gif")
    assert len(gt) == len(fj) and (dt, lt) == (dj, lj)
    medrms = float(np.median([np.std(f) for f in fj]))
    lo, hi = -3.5 * medrms, 3.5 * medrms
    cm = matplotlib.colormaps.get_cmap("gray")
    for a, f in zip(gt, fj):
        fn = np.clip((f - lo) / (hi - lo), 0.0, 1.0)
        np.testing.assert_array_equal(
            a, (cm(fn) * 255).astype(np.uint8)[..., :3])


# the port's counterparts of the reference tests


@pytest.fixture(scope="module")
def small_pipeline(tmp_path_factory):
    from pfb_tpu_torch.utils.ms import simulate_ms as simulate_ms_t
    tmp = tmp_path_factory.mktemp("aux")
    ms_path = str(tmp / "t.npz")
    simulate_ms_t(ms_path, nant=8, ntime=6, nchan=2, nsource=3,
                  fov_deg=0.3, seed=21)
    return dict(ms=ms_path)


def test_fastim_smoovie(small_pipeline, tmp_path):
    """tests/test_aux_workers.py:47 on the port."""
    p = small_pipeline
    fds = fastim_t(ms=p["ms"], output_filename=str(tmp_path / "f"),
                   integrations_per_image=2, channels_per_image=1,
                   field_of_view=0.3, device="cpu")
    assert len(fds) == 3 * 2
    assert all("RESIDUAL" in ds for ds in fds)
    frames = smoovie_t(fdsi=fds, output_filename=str(tmp_path / "f"),
                       animate_axis="time")
    assert len(frames) == 3
    assert os.path.exists(str(tmp_path / "f") + "_I_movie.gif")


def test_fastim_smoovie_scans(tmp_path):
    """tests/test_aux_workers.py:95 on the port."""
    from pfb_tpu_torch.utils.ms import simulate_ms as simulate_ms_t
    ms_path = str(tmp_path / "t.npz")
    simulate_ms_t(ms_path, nant=7, ntime=9, nchan=2, nsource=2,
                  fov_deg=0.3, seed=4, nscan=3)
    fds = fastim_t(ms=ms_path, output_filename=str(tmp_path / "f"),
                   integrations_per_image=2, channels_per_image=2,
                   field_of_view=0.3, device="cpu")
    assert len(fds) == 3 * 2
    assert sorted({ds["scanid"] for ds in fds}) == [0, 1, 2]
    frames = smoovie_t(fdsi=fds, output_filename=str(tmp_path / "f"),
                       animate_axis="time", t_bin=2, annotate=True,
                       out_format="mp4")
    assert len(frames) == 3
    made = [p for p in os.listdir(tmp_path) if p.endswith((".mp4", ".gif"))]
    assert made, "no movie written"


def test_fastim_selection_and_degrid_resolution(tmp_path):
    """tests/test_aux_workers.py:217 on the port."""
    from pfb_tpu_torch.utils.ms import simulate_ms as simulate_ms_t
    ms_path = str(tmp_path / "t.npz")
    simulate_ms_t(ms_path, nant=7, ntime=6, nchan=4, nsource=2,
                  fov_deg=0.3, seed=5, nscan=2)
    freqs = dict(np.load(ms_path))["FREQ"]
    fds = fastim_t(ms=ms_path, output_filename=None, scans="0",
                   integrations_per_image=1, channels_per_image=-1,
                   field_of_view=0.3, write=False, device="cpu")
    assert len(fds) == 3
    assert all(ds["scanid"] == 0 for ds in fds)
    fr = f"{freqs[0]}:{freqs[1] + 1.0}"
    fds = fastim_t(ms=ms_path, output_filename=None, freq_range=fr,
                   integrations_per_image=-1, write=False,
                   field_of_view=0.3, device="cpu")
    assert all(abs(ds["freq_out"] - freqs[:2].mean()) < 1.0 for ds in fds)
    fds = fastim_t(ms=ms_path, output_filename=None,
                   integrations_per_image=2, channels_per_grid_image=4,
                   channels_per_degrid_image=2, field_of_view=0.3,
                   write=False, device="cpu")
    assert len(fds) >= 2


def test_smoovie_parity_features(tmp_path):
    """tests/test_aux_workers.py:255 on the port."""
    from pfb_tpu_torch.utils.ms import simulate_ms as simulate_ms_t
    ms_path = str(tmp_path / "t.npz")
    simulate_ms_t(ms_path, nant=7, ntime=6, nchan=2, nsource=2,
                  fov_deg=0.3, seed=6)
    fds = fastim_t(ms=ms_path, output_filename=None,
                   integrations_per_image=2, channels_per_image=1,
                   field_of_view=0.3, write=False, device="cpu")
    tmid = np.median([ds["time_out"] for ds in fds])
    frames = smoovie_t(fdsi=fds, output_filename=str(tmp_path / "m"),
                       time_range=f":{tmid}", movie_cubes=True,
                       fits_mfs=True, min_frac=3.0, max_frac=3.0,
                       time_bin=1)
    assert len(frames) < 3
    made = os.listdir(tmp_path)
    assert any("band0000_movie" in p for p in made)
    assert any(p.endswith("_frames_mfs.fits") for p in made)
