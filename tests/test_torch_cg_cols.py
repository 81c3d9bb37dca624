"""K2's cluster route (the CG-fused PSF convolution on the cluster column
kernels of csrc/psf_cols.cu): its plain model against K2's plain version
and the JAX package's psf_convolve_pallas_v3_cube_cg in interpret mode,
and the route K2's wrapper takes on a stand-in CUDA stack."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfb_tpu.ops.pallas_fft import psf_convolve_pallas_v3_cube_cg
from pfb_tpu.ops.psf import prep_pallas_hessian
from pfb_tpu_torch import kernels
from pfb_tpu_torch.ops import psf
from pfb_tpu_torch.ops.psf import (h_from_jax_v3, psf_cols_fwd, psf_cols_inv,
                                   psf_convolve_h_cg,
                                   psf_convolve_h_cg_cols_plain,
                                   psf_convolve_h_cg_plain)

torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _operands(nb, nx, ny, seed, complex_h=True):
    g = torch.Generator().manual_seed(seed)
    pp, r = (torch.randn((nb, nx, ny), generator=g, dtype=torch.float64)
             for _ in range(2))
    beta = torch.rand((nb, 1, 1), generator=g, dtype=torch.float64)
    hr = torch.randn((nb, nx + 1, 2 * ny), generator=g, dtype=torch.float64)
    hi = torch.randn_like(hr) if complex_h else None
    return pp, r, beta, hr, hi


@pytest.mark.parametrize("C", [2, 4, 8])
@pytest.mark.parametrize("nx,ny,complex_h", [(128, 24, True),
                                             (256, 15, True),
                                             (128, 8, False),
                                             (1024, 16, True)])
def test_cluster_model_matches_k2_plain(C, nx, ny, complex_h):
    """The cluster route's decomposition (prologue, decimated columns,
    rows, decimated inverse, block partials in order) is K2's function:
    p, conv(p) and [p . conv, p . p] in float64, odd column counts
    included."""
    ops = _operands(2, nx, ny, seed=nx + ny + C, complex_h=complex_h)
    got = psf_convolve_h_cg_cols_plain(*ops, C=C)
    ref = psf_convolve_h_cg_plain(*ops)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        assert _rel(a, b) <= 1e-12


@pytest.mark.parametrize("C", [2, 4])
@pytest.mark.parametrize("real_transfer", [False, True])
def test_cluster_model_matches_jax_cg(C, real_transfer):
    """nx = 128, 2 bands: the model against psf_convolve_pallas_v3_cube_cg
    in interpret mode (test_torch_psf_full.py's case and tolerance)."""
    nb, nx = 2, 128
    rng = np.random.default_rng(4)
    psf_np = rng.normal(size=(nb, 2 * nx, 2 * nx)).astype(np.float32)
    phrT, phiT, rb = prep_pallas_hessian(jnp.asarray(psf_np), nx, nx,
                                         real_transfer=real_transfer)
    pp, r = (rng.normal(size=(nb, nx, nx)).astype(np.float32)
             for _ in range(2))
    beta = rng.uniform(0.1, 1.0, size=(nb, 1, 1)).astype(np.float32)
    out_j = psf_convolve_pallas_v3_cube_cg(
        jnp.asarray(pp), jnp.asarray(r), jnp.asarray(beta), phrT, phiT, nx,
        nx, row_block=rb, interpret=True)
    hr, hi = h_from_jax_v3(phrT, phiT, nx, nx)
    assert (hi is None) == real_transfer
    t = [torch.as_tensor(a).double() for a in (pp, r, beta, hr)]
    out_t = psf_convolve_h_cg_cols_plain(
        *t, None if hi is None else torch.as_tensor(hi).double(), C=C)
    for a, b in zip(out_t, out_j):
        assert a.shape == b.shape
        assert _rel(a.numpy(), b) < 1e-5


@pytest.mark.parametrize("C", [2, 4])
def test_cluster_model_at_2048_matches_jax_cg(C):
    """nx = 1024 (NX = 2048, the route's clusters of 4 and the lab's of
    2) on 128 columns, 2 bands: the model against
    psf_convolve_pallas_v3_cube_cg in interpret mode (1e-5)."""
    nb, nx, ny = 2, 1024, 128
    assert psf.cols_route(2 * nx, ny)
    rng = np.random.default_rng(5)
    psf_np = rng.normal(size=(nb, 2 * nx, 2 * ny)).astype(np.float32)
    phrT, phiT, rb = prep_pallas_hessian(jnp.asarray(psf_np), nx, ny,
                                         real_transfer=False)
    pp, r = (rng.normal(size=(nb, nx, ny)).astype(np.float32)
             for _ in range(2))
    beta = rng.uniform(0.1, 1.0, size=(nb, 1, 1)).astype(np.float32)
    out_j = psf_convolve_pallas_v3_cube_cg(
        jnp.asarray(pp), jnp.asarray(r), jnp.asarray(beta), phrT, phiT, nx,
        ny, row_block=rb, interpret=True)
    hr, hi = h_from_jax_v3(phrT, phiT, nx, ny)
    t = [torch.as_tensor(a).double() for a in (pp, r, beta, hr, hi)]
    out_t = psf_convolve_h_cg_cols_plain(*t, C=C)
    for a, b in zip(out_t, out_j):
        assert a.shape == b.shape
        assert _rel(a.numpy(), b) < 1e-5


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card, so that the wrapper's
    routing can be followed here."""

    @property
    def is_cuda(self):
        return True


class _Lib:
    """A stand-in kernel library: records K2's C argument and the stages
    it was asked to launch."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        assert name == "pfbt_psf_conv_cg"

        def entry(*args):
            self.calls.append((args[18], args[-2]))
            return 0
        return entry


@pytest.fixture
def stand_in(monkeypatch):
    lib = _Lib()
    monkeypatch.setattr(kernels, "library", lambda: lib)
    monkeypatch.setattr(kernels, "require_cuda_f32", lambda *a: None)
    monkeypatch.setattr(kernels, "stream_ptr", lambda: 0)
    monkeypatch.setattr(kernels, "twiddles",
                        lambda N, dev, kind="plan": torch.zeros((N, 2)))
    return lib


def _card(*shape):
    return torch.zeros(shape).as_subclass(_OnCard)


@pytest.mark.parametrize("nx,ny,C", [(2048, 16, 4), (4096, 8, 8),
                                     (1024, 16, 4), (2048, 1, 0),
                                     (512, 16, 1), (1280, 16, 4),
                                     (1536, 16, 4), (64, 16, 0),
                                     (128, 16, 2), (768, 16, 2)])
def test_k2_takes_k1s_column_route_and_counts(stand_in, nx, ny, C):
    """On a CUDA stack K2 passes cols_route's C at (2 nx, ny) to its entry
    (0: the line kernels), the entry launches every stage, and the
    cluster column kernels' counters gain one launch a stage on the
    route; K2's own counter one a call."""
    assert psf.cols_route(2 * nx, ny) == bool(C)
    n0 = (psf_cols_fwd.launches, psf_cols_inv.launches,
          psf_convolve_h_cg.launches)
    p = _card(2, nx, ny)
    pn, out, pap = psf_convolve_h_cg(p, p, _card(2, 1, 1),
                                     _card(2, nx + 1, 2 * ny))
    assert stand_in.calls == [(C, 7)]
    assert (pn.shape, out.shape, pap.shape) == (p.shape, p.shape, (2, 1, 2))
    got = (psf_cols_fwd.launches - n0[0], psf_cols_inv.launches - n0[1],
           psf_convolve_h_cg.launches - n0[2])
    assert got == ((1, 1, 1) if C else (0, 0, 1))
