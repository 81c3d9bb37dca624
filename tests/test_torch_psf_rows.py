"""The PSF rows stage's register route (csrc/psf_rows.cu, K10br) on the
CPU: the kernel's own decomposition as torch operations
(ops/psf.py:psf_rows_plain: the three stages of ops/cfft.py:row_radices
with stage 1 reading only the rows that hold values, the product with H
in the registers' layout k = j + q NY/16, the unscaled inverse and the
crop to ny) against the plain stage (psf_stage_rows_plain, torch.fft) in
float64, at lengths of the kernel's form (16 R2 16 and the like) with ny
below, at and above NY / 2, for a real, a complex and a full (K11) H;
against the JAX package's rows stages in Pallas interpret mode
(psf_v3_stage_k2 for K1's and K10's rows; K11's through its whole
pipeline, psf_convolve_pallas(_cube)); the route rule; and, on a stand-in
CUDA stack, which entries take the route, which table they pass and
which launches they count.

Tolerance: 1e-12 of max where both sides are float64; 1e-5 of max
against the JAX package in float32 (tests/test_torch_dist_space.py's K10
gate: a float32 FFT is ~1e-6 log2 N from exact)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pfb_tpu.ops.pallas_fft as pf
from pfb_tpu.ops.mmfft import make_full_psfhat as make_full_psfhat_j
from pfb_tpu.ops.psf import prep_pallas_hessian_space
from pfb_tpu_torch import kernels
from pfb_tpu_torch.ops import pallas_fft as pt
from pfb_tpu_torch.ops import psf
from pfb_tpu_torch.ops.psf import (full_h_rows, h_from_jax_full,
                                   h_from_jax_space, psf_rows,
                                   psf_rows_plain, psf_stage_cols_fwd_plain,
                                   psf_stage_cols_inv_plain,
                                   psf_stage_rows_plain, rows_route,
                                   space_rows)

torch.set_num_threads(1)
TOL = 1e-5


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _rows(N, ny, mode, R=5, seed=0):
    """(zr, zi, hr, hi, NX) in float64 from a seed: R rows against H rows
    (hi None for a real H), or (mode "full") a full (1, NX, N) H with
    NX / 2 + 1 = R spectrum rows."""
    rng = np.random.default_rng(seed + N + ny)
    z = [_t(rng.normal(size=(R, ny))) for _ in range(2)]
    if mode == "full":
        NX = 2 * (R - 1)
        h = [_t(rng.normal(size=(1, NX, N))) for _ in range(2)]
        return z[0][None], z[1][None], h[0], h[1], NX
    h = [_t(rng.normal(size=(R, N))) for _ in range(2)]
    return z[0], z[1], h[0], h[1] if mode == "complex" else None, None


# ---------------------------------------------------------------------
# the staged model against the plain stage


@pytest.mark.parametrize("N", [512, 640, 2304, 3072, 2048, 2560, 4608, 5120,
                               256, 768, 1280, 1536])
@pytest.mark.parametrize("mode", ["real", "complex", "full"])
@pytest.mark.parametrize("half", ["<", "=", ">"])
def test_rows_plain_matches_stage_plain_f64(N, mode, half):
    """The decomposition (16 x R2 x 16 where 256 divides N, R2 = 8, 10,
    12, 18, 20 at the lengths 2048-5120; 16, 5, 8 at 640) with ny below,
    at and above N / 2 against the plain stage in float64; the full H
    through its Hermitian part."""
    ny = N // 2 + {"<": -19, "=": 0, ">": 77}[half]
    zr, zi, hr, hi, NX = _rows(N, ny, mode)
    wr, wi = psf_rows_plain(zr, zi, hr, hi, NX)
    assert wr.dtype == torch.float64 and wr.shape == zr.shape
    h = (hr, hi) if NX is None else full_h_rows(hr, hi)
    qr, qi = psf_stage_rows_plain(zr, zi, *h)
    assert _rel(wr, qr) <= 1e-12 and _rel(wi, qi) <= 1e-12


def test_full_h_rows_is_the_hermitian_part():
    """full_h_rows: H_h(kx, k) = (H(kx, k) + conj H(-kx, -k)) / 2 on rows
    kx <= NX / 2, element by element."""
    rng = np.random.default_rng(3)
    H = rng.normal(size=(2, 6, 10)) + 1j * rng.normal(size=(2, 6, 10))
    hr, hi = full_h_rows(_t(H.real), _t(H.imag))
    assert hr.shape == (2, 4, 10)
    for b in range(2):
        for kx in range(4):
            for k in range(10):
                want = 0.5 * (H[b, kx, k] + np.conj(H[b, -kx % 6, -k % 10]))
                assert abs(hr[b, kx, k] - want.real) < 1e-15
                assert abs(hi[b, kx, k] - want.imag) < 1e-15
    assert full_h_rows(_t(H.real), None)[1] is None


@pytest.mark.parametrize("ny", [1, 31, 32, 33, 256, 257])
def test_rows_plain_reads_only_the_loaded_rows(ny):
    """Stage 1 reads the rows q < ceil(ny / (N/16)): a row's values past
    ny never enter (z holds ny values), at ny that do and do not fill a
    stage-1 row of N/16 = 32."""
    N = 512
    zr, zi, hr, hi, _ = _rows(N, ny, "complex", R=2, seed=ny)
    wr, wi = psf_rows_plain(zr, zi, hr, hi)
    qr, qi = psf_stage_rows_plain(zr, zi, hr, hi)
    assert _rel(wr, qr) <= 1e-12 and _rel(wi, qi) <= 1e-12


# ---------------------------------------------------------------------
# against the JAX package


def _psf(nb, n, even=False):
    xg = np.arange(n) - n // 2
    xx, yy = np.meshgrid(xg, xg, indexing="ij")
    p = np.zeros((nb, n, n), np.float32)
    for b in range(nb):
        p[b] = 0.4 * np.exp(-0.5 * (xx**2 + yy**2) / (2.0 + b) ** 2)
        p[b, n // 2, n // 2] += 0.6
        if not even:
            p[b, n // 2 + 3, n // 2 + 1] += 0.02
    return p


@pytest.mark.parametrize("h_type", ["complex", "real"])
def test_rows_plain_matches_jax_stage_k2(h_type):
    """nx = 256, NY = 512 (16 x 2 x 16): the JAX stage 2
    (psf_v3_stage_k2, interpret mode) on the JAX stage-1 spectrum against
    the decomposition on the port's H (K10's layout, two space shards),
    times NY (the port leaves the inverse unscaled); 1e-5 of max."""
    nb, nx, ps = 2, 256, 2
    p = _psf(nb, 2 * nx, even=h_type == "real")
    Hsr, Hsi, NXH = prep_pallas_hessian_space(jnp.asarray(p), nx, nx, ps)
    assert (Hsi is None) == (h_type == "real")
    x = np.random.default_rng(0).normal(size=(nb, nx, nx)).astype(
        np.float32)
    zr, zi = pf.psf_v3_stage_k1(jnp.asarray(x), nx, interpret=True)
    pad = [(0, 0), (0, Hsr.shape[2] - NXH), (0, 0)]
    wr_j, wi_j = (np.asarray(a) for a in pf.psf_v3_stage_k2(
        jnp.pad(zr, pad), jnp.pad(zi, pad), Hsr, Hsi, interpret=True))
    hr, hi = h_from_jax_space(Hsr, Hsi, nx, nx, ps)
    rows = space_rows(nx, ps)
    z = [_t(np.pad(np.asarray(a)[:, :nx + 1], pad[:1] + [(0, rows - nx - 1)]
                   + pad[2:])) for a in (zr, zi)]
    wr, wi = psf_rows_plain(*z, _t(hr), None if hi is None else _t(hi))
    scale = np.abs(wr_j).max()
    for got, ref in ((wr, wr_j), (wi, wi_j)):
        assert np.abs(got[:, :nx + 1].numpy() / (2 * nx)
                      - ref[:, :nx + 1]).max() <= TOL * scale


def _k11_chain(x, hr, hi, NX):
    """K11 through the decomposition: the forward column stage (rows NX/2
    + 1 kept), K10br's rows on the full H, the inverse column stage
    cropped to nx and scaled by 1 / (NX NY)."""
    nb, nx, ny = x.shape
    NY = hr.shape[-1]
    zr, zi = psf_stage_cols_fwd_plain(x, NX, NX // 2 + 1)
    wr, wi = psf_rows_plain(zr, zi, hr, hi, NX)
    return psf_stage_cols_inv_plain(wr, wi, nx, NX, NY)


def test_full_h_rows_through_k11_match_jax_pallas_cube():
    """nx = 64 in NX = NY = 192 (16 x 3 x 4, ny < NY / 2): K11's pipeline
    with the decomposition's rows stage on the full H against the JAX
    band loop psf_convolve_pallas_cube in interpret mode; 1e-5 of max."""
    nx, NX = 64, 192
    p = _psf(2, NX)
    x = np.random.default_rng(3).normal(size=(2, nx, nx)).astype(np.float32)
    hr_j, hi_j = make_full_psfhat_j(jnp.asarray(p))
    HrT, HiT = jnp.swapaxes(hr_j, -1, -2), jnp.swapaxes(hi_j, -1, -2)
    ref = np.asarray(pf.psf_convolve_pallas_cube(
        jnp.asarray(x), HrT, HiT, nx, nx, lane_block=64, row_block=64,
        interpret=True))
    hr, hi = (_t(a) for a in h_from_jax_full(HrT, HiT))
    assert _rel(_k11_chain(_t(x), hr, hi, NX), ref) <= TOL


@pytest.mark.parametrize("nx,ny,NX,NY", [(64, 96, 128, 192),
                                         (96, 112, 128, 192)])
def test_full_h_rows_through_k11_match_jax_random_h(nx, ny, NX, NY):
    """A random H, one band through the JAX single-band pipeline
    psf_convolve_pallas, ny = NY / 2 and ny > NY / 2 (nx > NX / 2 in the
    second); 1e-5 of max."""
    rng = np.random.default_rng(nx + ny)
    x = rng.normal(size=(nx, ny)).astype(np.float32)
    Hr, Hi = (rng.normal(size=(NX, NY)).astype(np.float32)
              for _ in range(2))
    ref = np.asarray(pf.psf_convolve_pallas(
        jnp.asarray(x), jnp.asarray(Hr.T), jnp.asarray(Hi.T), nx, ny,
        lane_block=64, row_block=64, interpret=True))
    got = _k11_chain(_t(x)[None], _t(Hr)[None], _t(Hi)[None], NX)[0]
    assert _rel(got, ref) <= TOL


def test_rows_plain_at_2048_matches_jax_stage_k2():
    """nx = 64, ny = 1024, NY = 2048 (16 x 8 x 16, the rows stage of
    1024^2 images): the JAX stage 2 (psf_v3_stage_k2, interpret mode) on
    the JAX stage-1 spectrum against the decomposition on the port's H
    (K10's layout, two space shards), times NY; 1e-5 of max."""
    nb, nx, ny, ps = 2, 64, 1024, 2
    rng = np.random.default_rng(20)
    p = rng.normal(size=(nb, 2 * nx, 2 * ny)).astype(np.float32)
    Hsr, Hsi, NXH = prep_pallas_hessian_space(jnp.asarray(p), nx, ny, ps)
    x = rng.normal(size=(nb, nx, ny)).astype(np.float32)
    zr, zi = pf.psf_v3_stage_k1(jnp.asarray(x), nx, interpret=True)
    pad = [(0, 0), (0, Hsr.shape[2] - NXH), (0, 0)]
    wr_j, wi_j = (np.asarray(a) for a in pf.psf_v3_stage_k2(
        jnp.pad(zr, pad), jnp.pad(zi, pad), Hsr, Hsi, interpret=True))
    hr, hi = h_from_jax_space(Hsr, Hsi, nx, ny, ps)
    rows = space_rows(nx, ps)
    z = [_t(np.pad(np.asarray(a)[:, :nx + 1], pad[:1] + [(0, rows - nx - 1)]
                   + pad[2:])) for a in (zr, zi)]
    assert rows_route(2 * ny) and hr.shape[-1] == 2 * ny
    wr, wi = psf_rows_plain(*z, _t(hr), _t(hi))
    scale = np.abs(wr_j).max()
    for got, ref in ((wr, wr_j), (wi, wi_j)):
        assert np.abs(got[:, :nx + 1].numpy() / (2 * ny)
                      - ref[:, :nx + 1]).max() <= TOL * scale


def test_k1_at_1024_through_the_routes_matches_jax_v3_cube():
    """K1 at nx = 1024 (NX = 2048) on 128 columns (NY = 256) through the
    route's decomposition: the forward cluster column stage at
    cluster_shape's C (4: M = 512), the rows stage, the inverse cluster
    column stage scaled by 1 / (NX NY), against the JAX package's
    psf_convolve_pallas_v3_cube in interpret mode; 1e-5 of max."""
    from pfb_tpu.ops.psf import prep_pallas_hessian
    from pfb_tpu_torch.ops.cfft import cluster_shape
    nb, nx, ny = 1, 1024, 128
    NX, NY = 2 * nx, 2 * ny
    assert psf.cols_route(NX, ny) and psf.v3_supported(nx, ny)
    C = cluster_shape(NX)[0]
    p = _psf(nb, NX)[:, :, NX // 2 - ny:NX // 2 + ny]
    phrT, phiT, rb = prep_pallas_hessian(jnp.asarray(p), nx, ny,
                                         real_transfer=False)
    x = np.random.default_rng(21).normal(size=(nb, nx, ny)).astype(
        np.float32)
    ref = np.asarray(pf.psf_convolve_pallas_v3_cube(
        jnp.asarray(x), phrT, phiT, nx, ny, row_block=rb, interpret=True))
    hr, hi = (_t(a) for a in psf.h_from_jax_v3(phrT, phiT, nx, ny))
    zr, zi = psf.psf_cols_fwd_plain(_t(x), NX, nx + 1, C=C)
    wr, wi = psf_rows_plain(zr, zi, hr, hi)
    got = psf.psf_cols_inv_plain(wr, wi, nx, NX, C=C, scale=1.0 / (NX * NY))
    assert _rel(got, ref) <= TOL


@pytest.mark.parametrize("nx", [128, 256])
def test_k1_short_through_the_routes_matches_jax_v3_cube(nx):
    """K1 at (2, nx^2) in (2 nx)^2, nx = 128 and 256 (the shapes at which
    the JAX v3 pipeline's interpret mode runs below 1024^2), through the
    short routes' decompositions: the forward cluster column stage at
    cluster_shape's C (_TINY_C), the rows stage (R2 = 1 and 2), the
    inverse cluster column stage scaled by 1 / (NX NY), against
    psf_convolve_pallas_v3_cube in interpret mode; 1e-5 of max."""
    from pfb_tpu.ops.psf import prep_pallas_hessian
    from pfb_tpu_torch.ops.cfft import cluster_shape
    nb = 2
    NX = NY = 2 * nx
    assert psf.cols_route(NX, nx) and rows_route(NY) and \
        psf.v3_supported(nx, nx)
    C = cluster_shape(NX)[0]
    p = _psf(nb, NX)
    phrT, phiT, rb = prep_pallas_hessian(jnp.asarray(p), nx, nx,
                                         real_transfer=False)
    x = np.random.default_rng(nx).normal(size=(nb, nx, nx)).astype(
        np.float32)
    ref = np.asarray(pf.psf_convolve_pallas_v3_cube(
        jnp.asarray(x), phrT, phiT, nx, nx, row_block=rb, interpret=True))
    hr, hi = (_t(a) for a in psf.h_from_jax_v3(phrT, phiT, nx, nx))
    zr, zi = psf.psf_cols_fwd_plain(_t(x), NX, nx + 1, C=C)
    wr, wi = psf_rows_plain(zr, zi, hr, hi)
    got = psf.psf_cols_inv_plain(wr, wi, nx, NX, C=C, scale=1.0 / (NX * NY))
    assert _rel(got, ref) <= TOL


@pytest.mark.parametrize("nx", [128, 64])
def test_rows_plain_short_matches_jax_stage_k2(nx):
    """nx = 128 (NY = 256 = 16 x 16, no stage 2) and 64 on 256 columns
    (NY = 512, R2 = 2): the JAX stage 2 (psf_v3_stage_k2, interpret mode)
    on the JAX stage-1 spectrum against the decomposition on the port's H
    (K10's layout, two space shards), times NY; 1e-5 of max."""
    nb, ps = 2, 2
    ny = 128 if nx == 128 else 256
    rng = np.random.default_rng(nx + 7)
    p = rng.normal(size=(nb, 2 * nx, 2 * ny)).astype(np.float32)
    Hsr, Hsi, NXH = prep_pallas_hessian_space(jnp.asarray(p), nx, ny, ps)
    x = rng.normal(size=(nb, nx, ny)).astype(np.float32)
    zr, zi = pf.psf_v3_stage_k1(jnp.asarray(x), nx, interpret=True)
    pad = [(0, 0), (0, Hsr.shape[2] - NXH), (0, 0)]
    wr_j, wi_j = (np.asarray(a) for a in pf.psf_v3_stage_k2(
        jnp.pad(zr, pad), jnp.pad(zi, pad), Hsr, Hsi, interpret=True))
    hr, hi = h_from_jax_space(Hsr, Hsi, nx, ny, ps)
    rows = space_rows(nx, ps)
    z = [_t(np.pad(np.asarray(a)[:, :nx + 1], pad[:1] + [(0, rows - nx - 1)]
                   + pad[2:])) for a in (zr, zi)]
    assert rows_route(2 * ny) and hr.shape[-1] == 2 * ny
    wr, wi = psf_rows_plain(*z, _t(hr), _t(hi))
    scale = np.abs(wr_j).max()
    for got, ref in ((wr, wr_j), (wi, wi_j)):
        assert np.abs(got[:, :nx + 1].numpy() / (2 * ny)
                      - ref[:, :nx + 1]).max() <= TOL * scale


@pytest.mark.parametrize("nx,ny,NX,NY", [(1280, 64, 2560, 128),
                                         (64, 1280, 128, 2560),
                                         (64, 384, 128, 768),
                                         (64, 640, 128, 1280),
                                         (384, 64, 768, 128),
                                         (640, 64, 1280, 128)])
def test_k11_at_1280_through_the_routes_matches_jax(nx, ny, NX, NY):
    """K11 on a random H at the length 2560 along x (the cluster column
    stages at cluster_shape's C) and along y (K10br's rows stage on the
    full H), through the routes' decompositions, against the JAX
    single-band psf_convolve_pallas in interpret mode; 1e-5 of max."""
    from pfb_tpu_torch.ops.cfft import cluster_shape
    rng = np.random.default_rng(nx + ny)
    x = rng.normal(size=(nx, ny)).astype(np.float32)
    Hr, Hi = (rng.normal(size=(NX, NY)).astype(np.float32)
              for _ in range(2))
    ref = np.asarray(pf.psf_convolve_pallas(
        jnp.asarray(x), jnp.asarray(Hr.T), jnp.asarray(Hi.T), nx, ny,
        lane_block=64, row_block=64, interpret=True))
    xt, nxh = _t(x)[None], NX // 2 + 1
    if psf.cols_route(NX, ny):
        C = cluster_shape(NX)[0]
        zr, zi = psf.psf_cols_fwd_plain(xt, NX, nxh, C=C)
    else:
        zr, zi = psf_stage_cols_fwd_plain(xt, NX, nxh)
    assert psf.cols_route(NX, ny) or rows_route(NY)
    wr, wi = psf_rows_plain(zr, zi, _t(Hr)[None], _t(Hi)[None], NX)
    if psf.cols_route(NX, ny):
        got = psf.psf_cols_inv_plain(wr, wi, nx, NX, C=C,
                                     scale=1.0 / (NX * NY))
    else:
        got = psf_stage_cols_inv_plain(wr, wi, nx, NX, NY)
    assert _rel(got[0], ref) <= TOL


# ---------------------------------------------------------------------
# the route


NEW_ROW_LENGTHS = (2304, 3840, 6400, 6912, 7680, 9216, 10240, 11520, 12800,
                   13824, 15360, 16384)
# the short instances, R2 = 1-6, several rows a block
SHORT_ROW_LENGTHS = (256, 512, 768, 1024, 1280, 1536)


def test_rows_route_on_every_paths_length():
    """The rule on the NY of every path: K1 and K10 at 2048 (1024^2
    images) and 4096 (2048^2), K11 at 2560 and 3072 (1280^2 and 1536^2),
    4608 (psf_oversize 1.5 at 3072^2) and 5120, K1, K2, K12-K14 and L1 at
    8192, K11 at 6144, and 12288; since R2 was generalised, every 256 R2
    with R2 5-smooth from 8 to 64 (the PSF Hessians of the 128-aligned
    images from 1024^2 to 8192^2: 2304 at 1152^2, 3840 at 1920^2, ...,
    16384 at 8192^2); since the short instances, 256 R2 with R2 = 1-6 too
    (the PSF Hessians of 128^2 to 768^2); lengths that are no multiple of
    256 (3000, K11's 1920 at psf_oversize 1.5 of 1280^2) and the
    multiples whose R2 is not 5-smooth (1792 = 256 x 7, 3584 = 256 x 14)
    or past 64 keep psf_rows_kernel."""
    for NY in (2048, 2560, 3072, 4096, 4608, 5120, 6144, 8192, 12288) + \
            NEW_ROW_LENGTHS + SHORT_ROW_LENGTHS:
        assert rows_route(NY)
    for NY in (128, 1920, 1792, 3000, 3584, 16640, 18432):
        assert not rows_route(NY)
    assert [NY for NY in range(2, 16900, 2) if rows_route(NY)] == sorted(
        (2048, 2560, 3072, 4096, 4608, 5120, 6144, 8192, 12288)
        + NEW_ROW_LENGTHS + SHORT_ROW_LENGTHS)


@pytest.mark.parametrize("N", NEW_ROW_LENGTHS)
@pytest.mark.parametrize("mode", ["complex", "full"])
def test_rows_plain_new_lengths_match_stage_plain_f64(N, mode):
    """The decomposition at the lengths R2 = 9-64 added to the register
    route (16 x R2 x 16), ny = N / 2 (every PSF at twice the image) and
    ny above it, against the plain stage in float64; the full H through
    its Hermitian part."""
    for ny in (N // 2, N // 2 + 77):
        zr, zi, hr, hi, NX = _rows(N, ny, mode, R=3)
        wr, wi = psf_rows_plain(zr, zi, hr, hi, NX)
        h = (hr, hi) if NX is None else full_h_rows(hr, hi)
        qr, qi = psf_stage_rows_plain(zr, zi, *h)
        assert _rel(wr, qr) <= 1e-12 and _rel(wi, qi) <= 1e-12


@pytest.mark.parametrize("NY", NEW_ROW_LENGTHS)
def test_k11_new_row_lengths_match_jax(NY):
    """K11 on a random H with its rows stage at each length added to the
    register route (the PSF Hessians of 1152^2-8192^2 images along y; 64
    rows along x, NX = 128, on the line route there), through the
    decomposition, against the JAX single-band psf_convolve_pallas in
    interpret mode; 1e-5 of max."""
    nx, ny, NX = 64, NY // 2, 128
    rng = np.random.default_rng(NY)
    x = rng.normal(size=(nx, ny)).astype(np.float32)
    Hr, Hi = (rng.normal(size=(NX, NY)).astype(np.float32)
              for _ in range(2))
    ref = np.asarray(pf.psf_convolve_pallas(
        jnp.asarray(x), jnp.asarray(Hr.T), jnp.asarray(Hi.T), nx, ny,
        lane_block=64, row_block=64, interpret=True))
    assert rows_route(NY)
    got = _k11_chain(_t(x)[None], _t(Hr)[None], _t(Hi)[None], NX)[0]
    assert _rel(got, ref) <= TOL


def test_cpu_wrapper_runs_the_staged_plain_version():
    """psf_rows on CPU tensors: the decomposition (no launch counted); it
    raises off the route and on operands that do not match."""
    zr, zi, hr, hi, _ = _rows(4096, 2048, "complex", R=2)
    n0 = psf_rows.launches
    wr, wi = psf_rows(zr, zi, hr, hi)
    mr, mi = psf_rows_plain(zr, zi, hr, hi)
    assert torch.equal(wr, mr) and torch.equal(wi, mi)
    zf, zfi, Hr, Hi, NX = _rows(4096, 2048, "full", R=3)
    wr, wi = psf_rows(zf, zfi, Hr, Hi, NX)
    assert _rel(wr, psf_rows_plain(zf, zfi, Hr, Hi, NX)[0]) == 0.0
    assert psf_rows.launches == n0
    with pytest.raises(ValueError):
        psf_rows(zr[:, :500], zi[:, :500], hr[:, :1000])    # NY = 1000
    with pytest.raises(ValueError):
        psf_rows(zr, zi, hr[:1])                            # rows differ
    with pytest.raises(ValueError):
        psf_rows(zf, zfi, Hr, Hi, NX + 2)                   # R != NX/2 + 1


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card, so that the wrappers'
    routing can be followed here."""

    @property
    def is_cuda(self):
        return True


# the positions of TY (the rows stage's table), of the route it is for
# (None: pfbt_psf_rows takes K10br's only) and of the int in which the
# entry reports its K10br launches, in each entry's arguments
_TY = {"pfbt_psf_conv": (15, 18, 19), "pfbt_psf_conv_full": (15, 18, 19),
       "pfbt_psf_conv_cg": (20, 23, 24),
       "pfbt_psf_stage_rows": (9, 10, 11), "pfbt_psf_rows": (10, None, 11)}


class _Lib:
    """A stand-in kernel library: records each entry that has a rows
    stage, with the kind of the table it was given and the route it
    declared, and reports ``launches`` K10br launches where the table is
    K10br's."""

    def __init__(self):
        self.calls = []
        self.kinds = {}
        self.launches = 1

    def __getattr__(self, name):
        def entry(*args):
            if name in _TY:
                ty, fused, out = _TY[name]
                kind = self.kinds[args[ty]]
                self.calls.append((name, kind, 1 if fused is None
                                   else args[fused]))
                out = args[out].contents
                out.value += self.launches if kind == "rows" else 0
            return 0
        return entry


@pytest.fixture
def stand_in(monkeypatch):
    lib = _Lib()
    tables = {}

    def twiddles(N, dev, kind="plan"):
        if (kind, N) not in tables:
            tables[kind, N] = torch.zeros((N, 2))
            lib.kinds[tables[kind, N].data_ptr()] = kind
        return tables[kind, N]
    monkeypatch.setattr(kernels, "library", lambda: lib)
    monkeypatch.setattr(kernels, "require_cuda_f32", lambda *a: None)
    monkeypatch.setattr(kernels, "stream_ptr", lambda: 0)
    monkeypatch.setattr(kernels, "twiddles", twiddles)
    return lib


def _card(*shape):
    return torch.zeros(shape).as_subclass(_OnCard)


@pytest.mark.parametrize("entry", ["K1", "K2", "K10b", "K11", "K12", "K13",
                                   "K14", "direct"])
@pytest.mark.parametrize("NY", [4096, 8192, 2048, 2560, 5120, 1024, 2304,
                                3584, 512])
def test_entries_take_the_route_and_count(stand_in, entry, NY):
    """On a CUDA stack every entry with a rows stage passes the rows
    table (pfbt_rows_twiddles) at a route length and the line plan's
    (pfbt_twiddles) elsewhere, and psf_rows.launches counts one K10br
    launch per rows stage on the route, psf_rows_line one
    psf_rows_kernel launch per stage off it, whichever entry ran it; the
    entries' own counters count as before."""
    ny = NY // 2
    nx = 16
    n0 = psf_rows.launches
    l0 = psf.psf_rows_line.launches
    own = {"K1": psf.psf_convolve_h, "K2": psf.psf_convolve_h_cg,
           "K10b": psf.psf_stage_rows, "K11": psf.psf_convolve_full,
           "K12": pt.psf_convolve_pallas_v3,
           "K13": pt.psf_convolve_pallas_v2,
           "K14": pt.psf_convolve_pallas_opt, "direct": psf_rows}[entry]
    k0 = own.launches
    if entry == "K1":
        psf.psf_convolve_h(_card(1, nx, ny), _card(1, nx + 1, NY))
        name = "pfbt_psf_conv"
    elif entry == "K2":
        psf.psf_convolve_h_cg(_card(1, nx, ny), _card(1, nx, ny),
                              _card(1, 1, 1), _card(1, nx + 1, NY))
        name = "pfbt_psf_conv_cg"
    elif entry == "K10b":
        psf.psf_stage_rows(_card(2, 9, ny), _card(2, 9, ny), _card(2, 9, NY))
        name = "pfbt_psf_stage_rows"
    elif entry == "K11":
        psf.psf_convolve_full(_card(1, nx, ny), _card(1, 2 * nx, NY),
                              _card(1, 2 * nx, NY))
        name = "pfbt_psf_conv_full"
    elif entry == "K12":
        pt.psf_convolve_pallas_v3(_card(nx, ny), _card(nx + 1, NY), None, nx,
                                  ny)
        name = "pfbt_psf_conv"
    elif entry in ("K13", "K14"):
        own(_card(nx, ny), _card(2 * nx, NY), _card(2 * nx, NY), nx, ny)
        name = "pfbt_psf_conv_full"
    else:
        if not rows_route(NY):
            with pytest.raises(ValueError):
                psf_rows(_card(3, ny), _card(3, ny), _card(3, NY))
            assert stand_in.calls == [] and psf_rows.launches == n0
            return
        psf_rows(_card(3, ny), _card(3, ny), _card(3, NY))
        name = "pfbt_psf_rows"
    on = rows_route(NY)
    assert stand_in.calls == [(name, "rows" if on else "plan", int(on))]
    assert psf_rows.launches - n0 == int(on)
    assert psf.psf_rows_line.launches - l0 == int(not on)
    if own is not psf_rows:
        assert own.launches == k0 + 1


@pytest.mark.parametrize("entry", ["K1", "K10b", "direct"])
def test_entries_count_the_launches_the_library_reports(stand_in, entry):
    """psf_rows.launches adds what the C entry reports (here two launches,
    as a stage whose z or H holds 2^31 elements or more makes), not one
    per call that the route predicts."""
    stand_in.launches = 2
    n0 = psf_rows.launches
    if entry == "K1":
        psf.psf_convolve_h(_card(1, 16, 2048), _card(1, 17, 4096))
    elif entry == "K10b":
        psf.psf_stage_rows(_card(2, 9, 2048), _card(2, 9, 2048),
                           _card(2, 9, 4096))
    else:
        psf_rows(_card(3, 2048), _card(3, 2048), _card(3, 4096))
    assert psf_rows.launches - n0 == 2
