"""The plain reference: its NUFFT against the exact DFT, its SARA
against the program's packed wavelets, its imaging products against the
program's grid worker, all on the CPU at small sizes."""

import numpy as np
import pytest
import torch

from reference.nufft import Plan, dft_adjoint
from reference.sara import Sara, dwt, idwt


@pytest.mark.parametrize("k,tol", [(7, 5e-6), (9, 1e-7)])
def test_nufft_against_exact_dft(k, tol):
    rng = np.random.default_rng(1)
    nrow, nx = 2000, 48
    uvw = rng.normal(size=(nrow, 3)) * np.array([500.0, 500.0, 100.0])
    freq = np.array([1.0e9, 1.2e9])
    cell = 1.0 / (2 * np.abs(uvw[:, :2]).max() * freq.max() /
                  299792458.0) / 2.0
    vis = rng.normal(size=(nrow, 2)) + 1j * rng.normal(size=(nrow, 2))
    plan = Plan(uvw, freq, nx, nx, cell, k=k)
    exact = dft_adjoint(uvw, freq, vis, nx, nx, cell)
    got = plan.adjoint(torch.as_tensor(vis))
    assert float((got - exact).abs().max() / exact.abs().max()) < tol
    x = torch.as_tensor(rng.normal(size=(nx, nx)))
    y = torch.as_tensor(vis).reshape(-1)
    lhs = float((plan.forward(x) * y.conj()).sum().real)
    rhs = float((x * plan.adjoint(y)).sum())
    assert lhs == pytest.approx(rhs, rel=1e-12)


def _blocks(c, spec):
    """The program's packed coefficients as the reference's list."""
    out = []
    for i in range(spec.nlevel):
        hx, hy = spec.ix[i][1], spec.iy[i][1]
        lx, ly = hx - 2 * spec.sx[i], hy - 2 * spec.sy[i]
        b = c[..., ly:ly + 2 * spec.sy[i], lx:lx + 2 * spec.sx[i]]
        cy, cx = spec.sy[i], spec.sx[i]
        out += [b[..., :cy, cx:].transpose(-1, -2),
                b[..., cy:, :cx].transpose(-1, -2),
                b[..., cy:, cx:].transpose(-1, -2)]
    return out + [b[..., :cy, :cx].transpose(-1, -2)]


@pytest.mark.parametrize("name,nx,ny", [("db1", 64, 64), ("db2", 64, 64),
                                        ("db2", 96, 80)])
def test_wavelets_against_program(name, nx, ny):
    from pfb_tpu_torch.ops.wavelets import dwt2d, idwt2d, make_spec
    g = torch.Generator().manual_seed(3)
    spec = make_spec(name, nx, ny, 3)
    x = torch.randn((2, nx, ny), generator=g, dtype=torch.float64)
    for a, b in zip(_blocks(dwt2d(x, spec), spec), dwt(x, name, 3)):
        assert torch.allclose(a, b, atol=1e-13)
    c = dwt2d(x, spec)
    c = c + torch.randn(c.shape, generator=g, dtype=c.dtype) * (c != 0)
    assert torch.allclose(idwt2d(c, spec), idwt(_blocks(c, spec), name, 3,
                                                nx, ny), atol=1e-12)


def test_psi_round_trip():
    s = Sara(96, 80)
    x = torch.randn((2, 96, 80), dtype=torch.float64)
    assert torch.allclose(s.hdot(s.dot(x)), 3 * x, atol=1e-12)


def test_imaging_against_grid_worker():
    from bench_helpers import SEED, small_parts
    from harness.simobs import observation
    from pfb_tpu_torch.workers.cubes import dds2cubes
    from pfb_tpu_torch.workers.grid import _grid
    from pfb_tpu_torch.workers.init import _init
    from reference.imaging import Observation
    cfg = small_parts()["cfg"]
    cols, _ = observation(cfg, SEED)
    cpu = torch.device("cpu")
    xds = _init(ms=cols, write=False, device=cpu, precision="double",
                channels_per_image=1)
    dds = _grid(xdsi=xds, write=False, device=cpu, backend="pg",
                nx=cfg["nx"], ny=cfg["nx"], epsilon=1e-7, robustness=0.0,
                super_resolution_factor=cfg["srf"], psf=True,
                residual=False)
    dirty, _, _, psf, *_ = dds2cubes(dds, cfg["nchan"])
    obs = Observation(cols, cfg["nx"], cfg["srf"], 0.0, support=9,
                      device=cpu)
    rd, rp = obs.dirty.numpy(), obs.psf.numpy()
    assert np.abs(dirty - rd).max() < 1e-6 * np.abs(rd).max()
    assert np.abs(psf - rp).max() < 1e-6 * np.abs(rp).max()
    x = torch.zeros((cfg["nchan"], cfg["nx"], cfg["nx"]),
                    dtype=torch.float64)
    x[:, 40, 70] = 1.0
    from pfb_tpu_torch.ops.gridder import make_hessian_dds
    h = make_hessian_dds(dds, cfg["nchan"], dds2cubes(dds, 4)[6].sum(),
                         cfg["nx"], cfg["nx"], use_beam=False, backend="pg",
                         epsilon=1e-7, device=cpu)(x).numpy()
    hr = obs.hessian(x).numpy()
    assert np.abs(h - hr).max() < 1e-6 * np.abs(hr).max()
