"""The frozen traffic generator against the program's simulator."""

import numpy as np

from harness import simobs


def test_observation_matches_program_simulator(tmp_path):
    from pfb_tpu_torch.utils.ms import read_ms, simulate_ms
    from pfb_tpu_torch.utils.simulation import image_size_for, simulate_obs
    cfg = dict(nant=8, ntime=4, nchan=3, duration_h=1.0, freq0_hz=1.0e9,
               bandwidth_hz=0.4e9, dec_rad=-0.5, lat_rad=-0.52,
               extent_m=1000.0, layout_seed=5, nsource=6, nx=64, srf=2.0)
    seed = 5
    cols, truth = simobs.observation(cfg, seed)
    obs = simulate_obs(nant=8, ntime=4, nchan=3, seed=5, extent=1000.0)
    _, cell = image_size_for(obs, fov_deg=1.0, srf=2.0)
    fov = (64 + 0.5) * np.rad2deg(cell)
    model, ix, iy, nx, cell_rad, _ = simulate_ms(
        str(tmp_path / "sim.npz"), nant=8, ntime=4, nchan=3, nsource=6,
        fov_deg=fov, seed=5, extent=1000.0, srf=2.0)
    ms = read_ms(str(tmp_path / "sim.npz"))
    assert nx == 64 and cell_rad == truth["cell"]
    np.testing.assert_array_equal(model, truth["model"])
    for k in ("DATA", "UVW", "TIME", "ANTENNA1", "ANTENNA2", "FLAG",
              "WEIGHT_SPECTRUM", "FREQ", "FIELD_ID", "DATA_DESC_ID",
              "SCAN_NUMBER", "RA", "DEC", "POLTYPE"):
        np.testing.assert_array_equal(cols[k], ms[k], err_msg=k)


def test_seeds_change_only_the_sky():
    cfg = dict(nant=8, ntime=4, nchan=2, duration_h=1.0, freq0_hz=1.0e9,
               bandwidth_hz=0.4e9, dec_rad=-0.5, lat_rad=-0.52,
               extent_m=1000.0, layout_seed=5, nsource=6, nx=64, srf=2.0)
    a, ta = simobs.observation(cfg, 1)
    b, tb = simobs.observation(cfg, 2**31 + 7)
    np.testing.assert_array_equal(a["UVW"], b["UVW"])
    assert not np.array_equal(ta["model"], tb["model"])
    c, tc = simobs.observation(cfg, 2**31 + 7)
    np.testing.assert_array_equal(b["DATA"], c["DATA"])
