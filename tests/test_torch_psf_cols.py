"""The PSF column stages' cluster route (csrc/psf_cols.cu) on the CPU: the
kernels' own decomposition as torch operations (ops/psf.py:
psf_cols_fwd_plain / psf_cols_inv_plain: decimation n = c + C m, the
M-point DFTs, the twiddles W_N^{c k1}, the C-point DFT, the pair packing
and its separation, the kept rows and the padded rows) in float64 against
the JAX package's K10 stages (psf_v3_stage_k1 / _k3), K11
(psf_convolve_pallas_cube) and K15 (_k1h_kernel / _k3h_kernel) in Pallas
interpret mode (float32), at C = 2, 4 and 8; the skeletons against an
element-by-element construction; the route rule; and, on a stand-in
CUDA stack, which entries take the route and count its launches.

Tolerance: 1e-5 of max|JAX| (tests/test_torch_dist_space.py's K10 gate,
the JAX tests' own: a float32 four-step DFT is ~1e-6 log2 N from exact);
1e-12 where both sides are float64."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import pfb_tpu.ops.pallas_fft as pf
from pfb_tpu.ops.mmfft import make_full_psfhat as make_full_psfhat_j
from pfb_tpu_torch import kernels
from pfb_tpu_torch.ops import cfft as cf
from pfb_tpu_torch.ops import pallas_fft as pt
from pfb_tpu_torch.ops import psf
from pfb_tpu_torch.ops.cfft import cluster_shape
from pfb_tpu_torch.ops.psf import (cols_route, h_from_jax_full,
                                   psf_cols_fwd, psf_cols_fwd_plain,
                                   psf_cols_inv, psf_cols_inv_plain,
                                   psf_stage_cols_fwd_plain,
                                   psf_stage_cols_inv_plain, space_rows)

torch.set_num_threads(1)
TOL = 1e-5
NB, L = 2, 128
_JAX = {}


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _k10_jax(nx):
    """x (NB, nx, L) from a seed, the JAX stage 1 on it (NXH rows) and the
    JAX stage 3 on that spectrum, in interpret mode; cached per nx."""
    if nx not in _JAX:
        x = np.random.default_rng(nx).normal(size=(NB, nx, L)).astype(
            np.float32)
        zr, zi = pf.psf_v3_stage_k1(jnp.asarray(x), nx, interpret=True)
        out = pf.psf_v3_stage_k3(zr, zi, nx, interpret=True)
        _JAX[nx] = (x, np.asarray(zr), np.asarray(zi), np.asarray(out))
    return _JAX[nx]


def _pad_rows(a, rows):
    return np.pad(a, ((0, 0), (0, rows - a.shape[1]), (0, 0)))


# ---------------------------------------------------------------------
# the decimated plain versions against the JAX K10 stages


@pytest.mark.parametrize("NX", [256, 512, 1024, 2048])
@pytest.mark.parametrize("C", [2, 4, 8, 1])
@pytest.mark.parametrize("nspace", [1, 4])
def test_cols_fwd_plain_matches_jax_stage_k1(NX, C, nspace):
    """Rows 0 .. NX/2 of the JAX stage 1 (v3's NXH rows), two real
    columns as one complex line, separated in the exchange; the rows as
    K1 has them (nspace 1) and padded to four space shards' count
    (zeros)."""
    nx = NX // 2
    x, zr_j, zi_j, _ = _k10_jax(nx)
    rows = space_rows(nx, nspace)
    assert (rows > nx + 1) == (nspace > 1)
    zr, zi = psf_cols_fwd_plain(_t(x), NX, rows, C=C)
    scale = max(np.abs(zr_j).max(), np.abs(zi_j).max())
    for got, ref in ((zr, zr_j), (zi, zi_j)):
        assert np.abs(got[:, :nx + 1].numpy() - ref[:, :nx + 1]).max() <= \
            TOL * scale
        assert not got[:, nx + 1:].any()


@pytest.mark.parametrize("NX", [256, 512, 1024, 2048])
@pytest.mark.parametrize("C", [2, 4, 8, 1])
def test_cols_inv_plain_matches_jax_stage_k3(NX, C):
    """The JAX stage 3 on the JAX stage-1 spectrum against the inverse
    plain version on its rows 0 .. NX/2, read at a padded row stride, the
    pairs packed as one line, scaled by 1 / NX; and both give x back."""
    nx = NX // 2
    x, zr_j, zi_j, out_j = _k10_jax(nx)
    rows = space_rows(nx, 4)
    w = [_t(_pad_rows(a[:, :nx + 1], rows)) for a in (zr_j, zi_j)]
    got = psf_cols_inv_plain(*w, nx, NX, C=C, scale=1.0 / NX)
    assert got.shape == (NB, nx, L)
    assert _rel(got, out_j) <= TOL
    assert _rel(got, x) <= TOL


@pytest.mark.parametrize("C", [2, 4, 8])
def test_cols_plain_odd_columns_match_jax(C):
    """An odd L: the last column pairs with zeros. The first 127 columns
    of the JAX L = 128 run, both directions."""
    NX = 512
    nx = NX // 2
    x, zr_j, zi_j, out_j = _k10_jax(nx)
    Lo = L - 1
    zr, zi = psf_cols_fwd_plain(_t(x[..., :Lo]), NX, nx + 1, C=C)
    assert zr.shape == (NB, nx + 1, Lo)
    scale = np.abs(zr_j).max()
    assert np.abs(zr.numpy() - zr_j[:, :nx + 1, :Lo]).max() <= TOL * scale
    assert np.abs(zi.numpy() - zi_j[:, :nx + 1, :Lo]).max() <= TOL * scale
    got = psf_cols_inv_plain(_t(zr_j[:, :nx + 1, :Lo]),
                             _t(zi_j[:, :nx + 1, :Lo]), nx, NX, C=C,
                             scale=1.0 / NX)
    assert _rel(got, out_j[..., :Lo]) <= TOL


def _psf(nb, n):
    xg = np.arange(n) - n // 2
    xx, yy = np.meshgrid(xg, xg, indexing="ij")
    p = np.zeros((nb, n, n))
    for b in range(nb):
        p[b] = 0.4 * np.exp(-0.5 * (xx**2 + yy**2) / (3.0 + b) ** 2)
        p[b, n // 2, n // 2] += 0.6
        p[b, n // 2 + 3, n // 2 + 1] += 0.05
    return p


@pytest.mark.parametrize("C", [2, 4, 8])
def test_k11_through_decimated_columns_matches_jax(C):
    """nx = 64 in NX = 192 (psf_oversize 3, nx != NX/2, a K11 shape): the
    forward decimated stage (rows nx .. NX - 1 zero), K11's rows stage
    with H's Hermitian part, the inverse decimated stage cropped to nx,
    against the JAX band loop psf_convolve_pallas_cube in interpret
    mode."""
    nx, NX = 64, 192
    p = _psf(2, NX).astype(np.float32)
    x = np.random.default_rng(3).normal(size=(2, nx, nx)).astype(np.float32)
    hr_j, hi_j = make_full_psfhat_j(jnp.asarray(p))
    HrT, HiT = jnp.swapaxes(hr_j, -1, -2), jnp.swapaxes(hi_j, -1, -2)
    ref = np.asarray(pf.psf_convolve_pallas_cube(
        jnp.asarray(x), HrT, HiT, nx, nx, lane_block=64, row_block=64,
        interpret=True))
    hr, hi = (_t(a) for a in h_from_jax_full(HrT, HiT))
    H = torch.complex(hr, hi)
    Hh = 0.5 * (H + torch.roll(H.flip(-2, -1), (1, 1), (-2, -1)).conj())
    nxh = NX // 2 + 1
    zr, zi = psf_cols_fwd_plain(_t(x), NX, nxh, C=C)
    z = torch.fft.fft(torch.complex(zr, zi), n=NX, dim=-1) * Hh[:, :nxh]
    w = torch.fft.ifft(z, dim=-1)[..., :nx]
    got = psf_cols_inv_plain(w.real.contiguous(), w.imag.contiguous(), nx,
                             NX, C=C, scale=1.0 / NX)
    assert _rel(got, ref) <= TOL


@pytest.mark.parametrize("NX,C", [(2560, 4), (3072, 4), (2560, 2),
                                  (3072, 2), (768, 1), (768, 2), (1280, 1),
                                  (1280, 2), (1536, 1)])
def test_k11_columns_below_4096_match_jax(NX, C):
    """K11 at 1280^2 in 2560^2 and 1536^2 in 3072^2 (v3 does not hold
    there), and at 384^2, 640^2 and 768^2 in twice that (radices 3 and 5,
    where the JAX v3 stages do not run), on 64 columns (NY = 128): the
    forward decimated stage at the route's clusters (C = 4 from 2048: M =
    640, 768; below, one block or _TINY_C) and at C = 2 (M = 1280, 1536)
    or 1-2 below, K11's rows stage with H's Hermitian part, the inverse
    decimated stage cropped to nx, against the JAX single-band
    psf_convolve_pallas on a random H in interpret mode."""
    nx, ny, NY = NX // 2, 64, 128
    assert cols_route(NX, ny) and cluster_shape(NX)[0] == \
        (4 if NX >= 2048 else 1 if NX == 768 else cf._TINY_C)
    rng = np.random.default_rng(NX + C)
    x = rng.normal(size=(nx, ny)).astype(np.float32)
    Hr, Hi = (rng.normal(size=(NX, NY)).astype(np.float32)
              for _ in range(2))
    ref = np.asarray(pf.psf_convolve_pallas(
        jnp.asarray(x), jnp.asarray(Hr.T), jnp.asarray(Hi.T), nx, ny,
        lane_block=64, row_block=64, interpret=True))
    hr, hi = psf.full_h_rows(_t(Hr)[None], _t(Hi)[None])
    nxh = NX // 2 + 1
    zr, zi = psf_cols_fwd_plain(_t(x)[None], NX, nxh, C=C)
    w = torch.fft.ifft(torch.fft.fft(torch.complex(zr, zi), n=NY, dim=-1)
                       * torch.complex(hr, hi), dim=-1)[..., :ny]
    got = psf_cols_inv_plain(w.real.contiguous(), w.imag.contiguous(), nx,
                             NX, C=C, scale=1.0 / NX)
    assert _rel(got[0], ref) <= TOL


@pytest.mark.parametrize("NX", [2048, 2560, 3072])
def test_cpu_wrappers_take_the_routes_clusters(NX):
    """psf_cols_fwd / psf_cols_inv below 4096 on CPU tensors: the
    decimated plain versions at the route's C = 4 (the stage's function);
    the shapes off the route raise: NX below the 256 floor on many
    columns, M = NX / C not 5-smooth or odd, one column."""
    nx, Lc = NX // 2, 6
    assert cluster_shape(NX)[0] == 4 and cols_route(NX, Lc)
    g = torch.Generator().manual_seed(NX)
    x = torch.randn((1, nx, Lc), generator=g, dtype=torch.float64)
    ref = psf_stage_cols_fwd_plain(x, NX, nx + 1)
    zr, zi = psf_cols_fwd(x, NX, nx + 1)
    assert _rel(zr, ref[0]) <= 1e-12 and _rel(zi, ref[1]) <= 1e-12
    out = psf_cols_inv(zr, zi, nx, NX, scale=1.0 / NX)
    assert _rel(out, x) <= 1e-12
    for n in (NX // 16, 128, 2044):   # below the floor; M = 2044
        assert not cols_route(n, 64)
        with pytest.raises(ValueError):
            psf_cols_fwd(torch.zeros((1, n // 2, 64), dtype=torch.float64),
                         n, n // 2 + 1)
    with pytest.raises(ValueError):   # M = 2052 / 4 = 513 odd
        psf_cols_fwd(torch.zeros((1, 1026, 4), dtype=torch.float64), 2052,
                     1027)
    with pytest.raises(ValueError):
        psf_cols_inv(zr[..., :1], zi[..., :1], nx, NX)


# ---------------------------------------------------------------------
# K15's keep = NXH


def _k15_jax(x, nx, inverse):
    """_k1h_kernel (forward) or _k3h_kernel (inverse) in interpret mode,
    lane block 128 (as tests/test_torch_pallas_fft.py calls them)."""
    NX = 2 * nx
    N1, N2 = pf._factor(NX)
    NXH = N1 * (N2 // 2 + 1)
    nb, ny, Lb = x[0].shape[0], x[0].shape[-1], 128
    in_strip = pl.BlockSpec((1, nx, Lb), lambda b, j: (b, 0, j),
                            memory_space=pltpu.VMEM)
    h_strip = pl.BlockSpec((1, NXH, Lb), lambda b, j: (b, 0, j),
                           memory_space=pltpu.VMEM)
    kw = dict(grid=(nb, ny // Lb), interpret=True)
    if not inverse:
        return pl.pallas_call(
            partial(pf._k1h_kernel, N=NX, L=Lb),
            in_specs=[in_strip] + pf._const_specs(NX),
            out_specs=(h_strip, h_strip),
            out_shape=(jax.ShapeDtypeStruct((nb, NXH, ny), jnp.float32),) * 2,
            **kw)(*x, *pf.consts_for(NX))
    return pl.pallas_call(
        partial(pf._k3h_kernel, N=NX, L=Lb),
        in_specs=[h_strip] * 2 + pf._const_specs(NX), out_specs=in_strip,
        out_shape=jax.ShapeDtypeStruct((nb, nx, ny), jnp.float32),
        **kw)(*x, *pf.consts_for(NX))


@pytest.mark.parametrize("C", [2, 4, 8])
def test_k15_keep_through_decimated_columns_matches_jax(C):
    """keep = NXH (NX = 512: 288 rows): the forward decimated stage
    against _k1h_kernel; the inverse against _k3h_kernel on
    a random non-Hermitian (NXH, L) spectrum, where the mirror rule and
    rows NX/2 + 1 .. NXH - 1 decide the answer (the Hermitian part of
    each column's spectrum before the pairs are packed)."""
    nx = 256
    NX, NXH = 2 * nx, pt.v3_rows(2 * nx)
    rng = np.random.default_rng(15)
    x = rng.normal(size=(2, nx, 128)).astype(np.float32)
    zr_j, zi_j = (np.asarray(a) for a in _k15_jax((jnp.asarray(x),), nx,
                                                   False))
    scale = max(np.abs(zr_j).max(), np.abs(zi_j).max())
    zr, zi = psf_cols_fwd_plain(_t(x), NX, NXH, NXH, C=C)
    assert np.abs(zr.numpy() - zr_j).max() <= TOL * scale
    assert np.abs(zi.numpy() - zi_j).max() <= TOL * scale
    w = [rng.normal(size=(2, NXH, 128)).astype(np.float32) for _ in range(2)]
    ref = np.asarray(_k15_jax(tuple(jnp.asarray(a) for a in w), nx, True))
    got = psf_cols_inv_plain(_t(w[0]), _t(w[1]), nx, NX, NXH, C=C,
                             scale=1.0 / NX)
    assert _rel(got, ref) <= TOL
    # the Hermitian-half reading is another answer on this spectrum
    half = psf_stage_cols_inv_plain(_t(w[0]), _t(w[1]), nx, NX, 1)
    assert _rel(half, ref) > 1e-2


@pytest.mark.parametrize("keep", [None, 150])
def test_decimated_plain_equals_rfft_plain_in_float64(keep):
    """The decimated versions against the functions' plain versions
    (rfft / irfft, or fft / ifft with the mirror where keep > NX/2 + 1)
    in float64: 1e-12 of max, at C = 4, nx < NX/2 and padded rows."""
    NX, nx, Lc = 256, 100, 9
    g = torch.Generator().manual_seed(4)
    x = torch.randn((2, nx, Lc), generator=g, dtype=torch.float64)
    k = keep or NX // 2 + 1
    got = psf_cols_fwd_plain(x, NX, k + 3, keep, C=4)
    ref = psf_stage_cols_fwd_plain(x, NX, k + 3, keep)
    for a, b in zip(got, ref):
        assert _rel(a, b) <= 1e-12
    w = [torch.randn((2, k + 3, Lc), generator=g, dtype=torch.float64)
         for _ in range(2)]
    got = psf_cols_inv_plain(*w, nx, NX, keep, C=4, scale=1.0 / NX)
    assert _rel(got, psf_stage_cols_inv_plain(*w, nx, NX, 1, keep)) <= 1e-12


# ---------------------------------------------------------------------
# the skeletons: the index algebra alone


def test_fwd_skeleton_plain_is_the_exchange_and_separation():
    """The forward skeleton (loads, exchange, separation, stores; no FFT
    passes, twiddles or C-point DFT) writes, for the pair line Z_q =
    x_{2q} + i x_{2q+1}, S[k1 + M c] = Z[c + C k1], then X_{2q}[k] = (S[k]
    + conj S[N - k]) / 2 and X_{2q+1}[k] = (S[k] - conj S[N - k]) / (2i),
    rows k < keep and zeros to ``rows``: element by element in numpy, nx
    < NX and an odd L."""
    NX, C, nx, Lc, keep, rows = 32, 4, 20, 3, 17, 19
    M = NX // C
    x = np.random.default_rng(2).normal(size=(1, nx, Lc))
    ref = np.zeros((1, rows, Lc), complex)
    for q in range((Lc + 1) // 2):
        Z = np.zeros(NX, complex)
        for n in range(nx):
            Z[n] = x[0, n, 2 * q] + 1j * (x[0, n, 2 * q + 1]
                                          if 2 * q + 1 < Lc else 0.0)
        S = np.zeros(NX, complex)
        for k1 in range(M):
            for c in range(C):
                S[k1 + M * c] = Z[c + C * k1]
        for k in range(keep):
            m = np.conj(S[(NX - k) % NX])
            ref[0, k, 2 * q] = (S[k] + m) / 2
            if 2 * q + 1 < Lc:
                ref[0, k, 2 * q + 1] = (S[k] - m) / 2j
    zr, zi = psf_cols_fwd_plain(torch.as_tensor(x), NX, rows, keep, C=C,
                                fft=False)
    assert np.abs(zr.numpy() - ref.real).max() <= 1e-15
    assert np.abs(zi.numpy() - ref.imag).max() <= 1e-15


def test_inv_skeleton_plain_is_the_hermitian_part_and_exchange():
    """The inverse skeleton: each column's Hermitian part H (W[k] for 0 <
    k <= N - keep, conj W[N - k] for k >= keep, the mean where both rows
    are given), the pair line Z_q = H_{2q} + i H_{2q+1}, out[n1 + M c] =
    Z[c + C n1] split into its real (column 2q) and imaginary (2q + 1)
    parts, rows n < nx times scale: element by element in numpy."""
    NX, C, nx, Lc, keep, rows, scale = 32, 4, 20, 3, 19, 21, 0.5
    M = NX // C
    rng = np.random.default_rng(3)
    w = rng.normal(size=(1, rows, Lc)) + 1j * rng.normal(size=(1, rows, Lc))
    H = np.zeros((NX, Lc + 1), complex)
    for j in range(Lc):
        for k in range(NX):
            a = w[0, k, j] if k < keep else None
            b = np.conj(w[0, (NX - k) % NX, j]) if (NX - k) % NX < keep \
                else None
            H[k, j] = (a + b) / 2 if a is not None and b is not None else \
                (a if a is not None else b)
    ref = np.zeros((1, nx, Lc))
    for q in range((Lc + 1) // 2):
        Z = H[:, 2 * q] + 1j * H[:, 2 * q + 1]
        for n1 in range(M):
            for c in range(C):
                n = n1 + M * c
                if n < nx:
                    ref[0, n, 2 * q] = Z[c + C * n1].real * scale
                    if 2 * q + 1 < Lc:
                        ref[0, n, 2 * q + 1] = Z[c + C * n1].imag * scale
    got = psf_cols_inv_plain(torch.as_tensor(w.real), torch.as_tensor(w.imag),
                             nx, NX, keep, C=C, scale=scale, fft=False)
    assert np.abs(got.numpy() - ref).max() <= 1e-15


# ---------------------------------------------------------------------
# the route


def test_cols_route_on_every_paths_shapes():
    """The rule on the NX of every path: K1 and K10 at 2048 (1024^2
    images) and 4096 (2048^2), K11 at 2560 and 3072 (1280^2 and 1536^2),
    K1, K12 and K15 at 8192, K11 at 6144 (3072^2) and 4608 (psf_oversize
    1.5), and K1 at every NX from 256 to 1536 (128^2 to 768^2 images)
    take the cluster kernels; below 256, a single column, M = NX / C odd
    or not 5-smooth and a tile past 8192 values keep the line kernel.
    The shapes follow ops/cfft.py:cluster_shape."""
    for NX, L in ((4096, 2048), (4096, 512), (8192, 4096), (6144, 3072),
                  (4608, 3072), (12288, 8), (16384, 2), (2048, 1024),
                  (2048, 256), (2560, 1280), (3072, 1536), (3000, 8),
                  (1024, 512), (256, 128), (1536, 768), (768, 384)):
        assert cols_route(NX, L), (NX, L)
    for NX, L in ((128, 64), (8192, 1), (2048, 1), (2044, 8), (1350, 8),
                  (4100, 8), (32768, 8), (6561, 8), (2052, 8), (1028, 8)):
        assert not cols_route(NX, L), (NX, L)
    assert [cluster_shape(n) for n in (2048, 2560, 3072, 4096, 4608, 6144,
                                       8192, 12288, 16384)] \
        == [(4, 8), (4, 8), (4, 8), (4, 8), (8, 8), (8, 8), (8, 8), (8, 4),
            (8, 4)]
    assert [n for n in range(2, 4096, 2) if cols_route(n, 8)] == \
        [n for n in range(256, 2048, 4)
         if psf.good_size(n // cluster_shape(n)[0]) == n // cluster_shape(n)[0]
         and n // cluster_shape(n)[0] % 2 == 0] + \
        [n for n in range(2048, 4096, 4) if psf.good_size(n // 4) == n // 4
         and n // 4 % 2 == 0]
    with pytest.raises(ValueError):
        cluster_shape(6561)


@pytest.mark.parametrize("NX", [4096, 4608, 6144, 8192, 12288, 16384, 2048,
                                2560, 3072, 256, 512, 768, 1024, 1280, 1536])
def test_cols_tile_fits_a_block(NX):
    """Every route shape is one the kernels launch: C in (1, 2, 4, 8)
    dividing NX, M = NX / C even, W/2 pair lines of M within 4096 values
    (256 threads of 16 values), W a multiple of 4, and (K2's column sums)
    a thread on one quad of the tile: the (W/2) M / 16 threads, rounded
    up to a warp, a multiple of 16 W / 4."""
    C, W = cluster_shape(NX)
    M = NX // C
    assert C in (1, 2, 4, 8) and NX % C == 0 and M % 2 == 0 and W % 4 == 0
    threads = -(-((W // 2) * M // 16) // 32) * 32
    assert (threads // 16) % (W // 4) == 0
    assert (W // 2) * M <= 4096 and W * M <= 8192


def test_cpu_wrappers_run_the_decimated_plain_versions():
    """psf_cols_fwd / psf_cols_inv on CPU tensors: the decimated plain
    versions at cluster_shape's C (no launch counted); they raise off the
    route."""
    NX, nx, Lc = 4096, 2048, 4
    g = torch.Generator().manual_seed(5)
    x = torch.randn((1, nx, Lc), generator=g, dtype=torch.float64)
    n0 = (psf_cols_fwd.launches, psf_cols_inv.launches)
    zr, zi = psf_cols_fwd(x, NX, nx + 2)
    ref = psf_cols_fwd_plain(x, NX, nx + 2, C=4)
    assert torch.equal(zr, ref[0]) and torch.equal(zi, ref[1])
    out = psf_cols_inv(zr, zi, nx, NX, scale=1.0 / NX)
    assert _rel(out, x) <= 1e-12
    assert (psf_cols_fwd.launches, psf_cols_inv.launches) == n0
    with pytest.raises(ValueError):
        psf_cols_fwd(x[..., :1], NX, nx + 1)        # one column
    with pytest.raises(ValueError):
        psf_cols_fwd(x[:, :64], 128, 65)             # NX < 256
    with pytest.raises(ValueError):
        psf_cols_inv(zr[..., :1], zi[..., :1], nx, NX)


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card, so that the wrappers'
    routing can be followed here."""

    @property
    def is_cuda(self):
        return True


class _Lib:
    """A stand-in kernel library: records each entry's C argument."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        pos = {"pfbt_psf_conv": 13, "pfbt_psf_conv_full": 13,
               "pfbt_psf_stage_cols_fwd": 9, "pfbt_psf_stage_cols_inv": 10,
               "pfbt_psf_cols_fwd": 9, "pfbt_psf_cols_inv": 10}[name]

        def entry(*args):
            self.calls.append((name, args[pos]))
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


@pytest.mark.parametrize("entry,NX,L,C", [
    ("K1", 4096, 16, 4), ("K1", 1024, 16, 1), ("K11", 6144, 8, 8),
    ("K11", 4608, 8, 8), ("K12", 8192, 4, 8), ("K10", 4096, 8, 4),
    ("K10", 2048, 8, 4), ("K15", 8192, 8, 8), ("direct", 4096, 8, 4),
    ("K1", 2048, 16, 4), ("K11", 2560, 8, 4), ("K11", 3072, 8, 4),
    ("K10", 1024, 8, 1), ("K15", 2048, 8, 4), ("direct", 2048, 8, 4),
    ("K11", 1024, 8, 1), ("K1", 128, 16, 0), ("K10", 128, 8, 0),
    ("K11", 1350, 8, 0), ("direct", 256, 8, 2)])
def test_entries_take_the_route_and_count(stand_in, entry, NX, L, C):
    """On a CUDA stack every entry with a column stage passes the C of
    cols_route to its C entry point (0: the line kernel), and the cluster
    kernels' counters (psf_cols_fwd / psf_cols_inv) count one launch per
    stage that took the route, whichever entry launched it, the line
    kernel's (psf_cols_line) one per stage off it; the entries' own
    counters count as before."""
    nx = NX // 2
    n0 = (psf_cols_fwd.launches, psf_cols_inv.launches)
    l0 = psf.psf_cols_line.launches
    own = None
    if entry == "K1":
        own = psf.psf_convolve_h
        k0 = own.launches
        psf.psf_convolve_h(_card(1, nx, L), _card(1, nx + 1, 2 * L))
        want, stages = [("pfbt_psf_conv", C)], (1, 1)
    elif entry == "K11":
        own = psf.psf_convolve_full
        k0 = own.launches
        psf.psf_convolve_full(_card(1, min(3072, NX), L),
                              _card(1, NX, 2 * L), _card(1, NX, 2 * L))
        want, stages = [("pfbt_psf_conv_full", C)], (1, 1)
    elif entry == "K12":
        own = pt.psf_convolve_pallas_v3
        k0 = own.launches
        n = 128 * L
        assert pt.v3_supported(nx, n)
        pt.psf_convolve_pallas_v3(_card(nx, n), _card(nx + 1, 2 * n), None,
                                  nx, n)
        want, stages = [("pfbt_psf_conv", C)], (1, 1)
    elif entry == "K10":
        own = psf.psf_stage_cols_fwd
        k0 = own.launches
        zr, zi = psf.psf_stage_cols_fwd(_card(2, nx, L), NX, nx + 3)
        psf.psf_stage_cols_inv(_card(2, nx + 3, L), _card(2, nx + 3, L), nx,
                               NX, NX)
        want = [("pfbt_psf_stage_cols_fwd", C), ("pfbt_psf_stage_cols_inv", C)]
        stages = (1, 1)
    elif entry == "K15":
        own = pt.v3_cols_fwd
        k0 = own.launches
        NXH = pt.v3_rows(NX)
        pt.v3_cols_fwd(_card(1, nx, L), nx)
        pt.v3_cols_inv(_card(1, NXH, L), _card(1, NXH, L), nx)
        want = [("pfbt_psf_stage_cols_fwd", C), ("pfbt_psf_stage_cols_inv", C)]
        stages = (1, 1)
    else:
        psf_cols_fwd(_card(1, nx, L), NX, nx + 1)
        psf_cols_inv(_card(1, nx + 1, L), _card(1, nx + 1, L), nx, NX)
        want = [("pfbt_psf_cols_fwd", C), ("pfbt_psf_cols_inv", C)]
        stages = (1, 1)
    assert stand_in.calls == want
    got = (psf_cols_fwd.launches - n0[0], psf_cols_inv.launches - n0[1])
    assert got == (stages if C else (0, 0))
    assert psf.psf_cols_line.launches - l0 == (0 if C else sum(stages))
    if own is not None:
        assert own.launches == k0 + 1
