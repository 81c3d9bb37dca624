"""pfb_tpu_torch w-plane c2c transforms (ops/cfft.py, the plain versions
of the CUDA kernels on the CPU: the line kernel's, the cluster column
kernel's steps at C = 2, 4, 8 and 16, the row kernel's three stages, and
above 16384 the four-step's, the long column and row kernels' (K3xl,
K3yl) and the lab's one-pass designs' (K3cl, K3fr)) against
pfb_tpu/ops/pallas_cfft.py in interpret mode; the routes of every pass
of the imaging paths at the 128-aligned images from 1024^2 to 8192^2
against the kernels' instance tables. Float32 on both
sides, or float64 in the port; tolerance 1e-5 of max|ref| (f32 four-step
DFTs, ~1e-6 log2 N)."""

import itertools
import re
from functools import partial
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfb_tpu.ops.pallas_cfft import fft2_c2c_pruned as fft2_j
from pfb_tpu.ops.pallas_cfft import fftx_c2c as fftx_j
from pfb_tpu_torch.ops import cfft as cf
from pfb_tpu_torch.ops.cfft import (_factor, cfft_supported,
                                    cluster_long_fits, cluster_route,
                                    cluster_shape, cols_long_route,
                                    fft2_c2c_pruned, fftx_c2c,
                                    fftx_c2c_cluster,
                                    fftx_c2c_cluster_long,
                                    fftx_c2c_cluster_plain,
                                    fftx_c2c_cols_long,
                                    fftx_c2c_cols_long_plain, fftx_c2c_four,
                                    fftx_c2c_four_first_plain,
                                    fftx_c2c_four_plain, fftx_c2c_four_rows,
                                    fftx_c2c_route,
                                    fftx_c2c_rows, fftx_c2c_rows_long,
                                    fftx_c2c_rows_long_plain,
                                    fftx_c2c_rows_plain,
                                    fftx_c2c_rows_skeleton_plain,
                                    four_rows_fits, four_step_fits,
                                    four_step_route, row_radices, row_route,
                                    rows_long_route)

torch.set_num_threads(1)
N = 256


def _rand(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _close(got, ref, tol=1e-5):
    ref = np.asarray(ref)
    assert np.abs(np.asarray(got) - ref).max() <= tol * np.abs(ref).max()


def _smooth(m):
    """Whether m has no prime factor but 2, 3 and 5."""
    for p in (2, 3, 5):
        while m % p == 0:
            m //= p
    return m == 1


@pytest.mark.parametrize("mode", ["full", "in_rolled", "out_rolled"])
@pytest.mark.parametrize("inverse", [False, True])
def test_fftx_matches_jax(mode, inverse):
    in_rolled, out_rolled = mode == "in_rolled", mode == "out_rolled"
    xr, xi = _rand((2, N // 2 if in_rolled else N, 128), seed=7)
    yr_j, yi_j = fftx_j(jnp.asarray(xr), jnp.asarray(xi), N=N,
                        inverse=inverse, in_rolled=in_rolled,
                        out_rolled=out_rolled, interpret=True)
    yr, yi = fftx_c2c(torch.as_tensor(xr), torch.as_tensor(xi), N=N,
                      inverse=inverse, in_rolled=in_rolled,
                      out_rolled=out_rolled)
    _close(yr.numpy(), yr_j)
    _close(yi.numpy(), yi_j)


@pytest.mark.parametrize("pruned", ["in", "out", "none"])
def test_fft2_pruned_matches_jax(pruned):
    pin = pruned == "in"
    n = N // 2 if pin else N
    xr, xi = _rand((2, n, n), seed=8)
    kw = dict(Nx=N, Ny=N, inverse=not pin, pruned_in=pin,
              pruned_out=pruned == "out")
    yr_j, yi_j = fft2_j(jnp.asarray(xr), jnp.asarray(xi),
                        interpret=True, **kw)
    yr, yi = fft2_c2c_pruned(torch.as_tensor(xr), torch.as_tensor(xi), **kw)
    _close(yr.numpy(), yr_j)
    _close(yi.numpy(), yi_j)


def test_supported_lengths_match_jax():
    from pfb_tpu.ops.pallas_cfft import cfft_supported as sup_j
    from pfb_tpu.ops.pallas_fft import _factor as factor_j
    for n in (256, 512, 2304, 4096, 6144, 8192, 1000, 640):
        assert cfft_supported(n) == sup_j(n)
        assert _factor(n) == factor_j(n)


def test_real_input_and_shape_checks():
    xr, _ = _rand((1, N, 4), seed=9)
    t = torch.as_tensor(xr)
    yr, yi = fftx_c2c(t, None, N=N)
    ref = np.fft.fft(xr.astype(np.float64), axis=-2)
    _close(yr.numpy(), ref.real)
    _close(yi.numpy(), ref.imag)
    with pytest.raises(ValueError):
        fftx_c2c(t, t, N=N, in_rolled=True)


# ---------------------------------------------------------------------
# the cluster column kernel's plain version (csrc/cfft_cols.cu's steps)

_JAX_REF = {}


def _jax_ref(N, mode, inverse, L, real=False):
    """JAX fftx_c2c(interpret=True) on seeded inputs, once per case (the
    reference does not depend on C); lane_block=L takes a ragged L;
    ``real``: xi zeros."""
    key = (N, mode, inverse, L, real)
    if key not in _JAX_REF:
        in_rolled, out_rolled = mode == "in_rolled", mode == "out_rolled"
        xr, xi = _rand((2, N // 2 if in_rolled else N, L), seed=N + L)
        if real:
            xi = np.zeros_like(xi)
        ref = fftx_j(jnp.asarray(xr), jnp.asarray(xi), N=N, inverse=inverse,
                     in_rolled=in_rolled, out_rolled=out_rolled,
                     lane_block=min(L, 128), interpret=True)
        _JAX_REF[key] = (xr, xi, np.asarray(ref[0]), np.asarray(ref[1]))
    return _JAX_REF[key]


@pytest.mark.parametrize("N", [512, 640, 2304, 256, 768, 1280])
@pytest.mark.parametrize("C", [2, 4, 8, 16, 1])
@pytest.mark.parametrize("mode", ["full", "in_rolled", "out_rolled"])
@pytest.mark.parametrize("inverse", [False, True])
def test_cluster_plain_matches_jax(N, C, mode, inverse):
    xr, xi, rr, ri = _jax_ref(N, mode, inverse, 128)
    yr, yi = fftx_c2c_cluster_plain(
        torch.as_tensor(xr), torch.as_tensor(xi), N=N, C=C, inverse=inverse,
        in_rolled=mode == "in_rolled", out_rolled=mode == "out_rolled")
    _close(yr.numpy(), rr)
    _close(yi.numpy(), ri)


@pytest.mark.parametrize("mode", ["full", "in_rolled", "out_rolled"])
@pytest.mark.parametrize("inverse", [False, True])
def test_cluster_plain_ragged_matches_jax(mode, inverse):
    """L = 20, not a multiple of the kernel's 8-column tiles: the CPU
    wrapper (the plain version at cluster_shape's C) against JAX with
    lane_block=20."""
    N = 640
    xr, xi, rr, ri = _jax_ref(N, mode, inverse, 20)
    yr, yi = fftx_c2c_cluster(
        torch.as_tensor(xr), torch.as_tensor(xi), N=N, inverse=inverse,
        in_rolled=mode == "in_rolled", out_rolled=mode == "out_rolled")
    _close(yr.numpy(), rr)
    _close(yi.numpy(), ri)


def test_cluster_route_and_shape():
    """The dispatch rule, written once in ops/cfft.py: the strided x pass
    (L > 1) at N >= 256 takes the cluster kernel where its tile fits and
    N / C is 5-smooth; the y pass (L = 1), N < 256, N % 4 != 0, tiles
    past a block's 8192 values and N / C with another prime factor (2044,
    4100) keep line_fft_kernel. The shapes the card runs: clusters of 4
    blocks and tiles of 8 columns from 2048 to 4096; below 2048 one block
    where its tile is 8 columns (768, 1024), else clusters of _TINY_C = 2,
    with tiles of up to 32 columns."""
    assert cluster_route(4096, 8) and cluster_route(8192, 4096)
    assert cluster_route(16384, 2) and cluster_route(4320, 2)
    assert cluster_route(2048, 2048) and cluster_route(2560, 8)
    assert cluster_route(3072, 2) and cluster_route(3000, 8)
    assert not cluster_route(8192, 1) and not cluster_route(2048, 1)
    assert cluster_route(1024, 2048) and not cluster_route(2044, 8)
    assert cluster_route(256, 2) and cluster_route(1536, 8)
    assert not cluster_route(4100, 2) and not cluster_route(128, 8)
    assert not cluster_route(1350, 8) and not cluster_route(1024, 1)
    assert not cluster_route(2050, 8)
    assert not cluster_route(6561, 8) and not cluster_route(8748, 8)
    assert not cluster_route(32768, 8)
    assert [cluster_shape(n) for n in (2048, 2560, 3072, 4096, 6144, 8192,
                                       12288, 16384)] \
        == [(4, 8), (4, 8), (4, 8), (4, 8), (8, 8), (8, 8), (8, 4), (8, 4)]
    assert cf._TINY_C == 2
    assert [cluster_shape(n) for n in (256, 512, 768, 1024, 1280, 1536)] \
        == [(2, 32), (2, 32), (1, 8), (1, 8), (2, 8), (2, 8)]
    with pytest.raises(ValueError):
        cluster_shape(6561)
    # a CPU stack keeps the plain route whatever the shape
    xr, xi = _rand((1, 4096, 4), seed=10)
    yr, _ = fftx_c2c(torch.as_tensor(xr), torch.as_tensor(xi), N=4096)
    ref = np.fft.fft(xr.astype(np.float64) + 1j * xi, axis=-2)
    _close(yr.numpy(), ref.real)


@pytest.mark.parametrize("N", [2048, 4096, 6144, 8192, 12288, 16384, 2560,
                               3072, 4608, 5120, 256, 512, 768, 1024, 1280,
                               1536])
def test_cluster_shape_fits_a_block(N):
    """Every shape the route takes is one the kernel launches: a cluster
    of 1, 2, 4 or 8 blocks dividing N, tiles of 4, 8, 16 or 32 columns (8
    or 4 from 2048), at most 8192 values a block, and each row segment of
    a tile a whole number of 16-byte chunks."""
    C, W = cluster_shape(N)
    assert C in (1, 2, 4, 8) and W in (4, 8, 16, 32) and N % C == 0
    assert W <= 8 or N < 2048
    assert (N // C) * W <= 8192 and W % 4 == 0
    assert cluster_route(N, 2) == (N >= 256)


@pytest.mark.parametrize("mode", ["full", "in_rolled", "out_rolled"])
def test_cluster_skeleton_plain_is_the_exchange_permutation(mode):
    """The skeleton (loads, exchange, stores, no FFT passes) writes
    X[k1 + M c] = x[c + C k1]: checked element by element in numpy."""
    N, C, L = 2048, 4, 3
    M = N // C
    in_rolled, out_rolled = mode == "in_rolled", mode == "out_rolled"
    xr, xi = _rand((2, N // 2 if in_rolled else N, L), seed=11)
    full = xr + 1j * xi
    if in_rolled:
        full = np.zeros((2, N, L), complex)
        full[:, (np.arange(N // 2) - N // 4) % N] = xr + 1j * xi
    want = np.empty((2, N, L), complex)
    for k1 in range(M):
        for c in range(C):
            want[:, k1 + M * c] = full[:, c + C * k1]
    if out_rolled:
        want = want[:, (np.arange(N // 2) - N // 4) % N]
    assert cluster_shape(N)[0] == C
    yr, yi = fftx_c2c_cluster(torch.as_tensor(xr), torch.as_tensor(xi), N=N,
                              skeleton=True, in_rolled=in_rolled,
                              out_rolled=out_rolled)
    assert np.array_equal(yr.numpy(), want.real.astype(np.float32))
    assert np.array_equal(yi.numpy(), want.imag.astype(np.float32))


# ---------------------------------------------------------------------
# the row kernel's plain version (csrc/cfft_rows.cu's steps), against the
# JAX y pass: fftx_c2c on the transposed view, as pallas_cfft.py:
# fft2_c2c_pruned runs it

_JAX_ROWS = {}


def _jax_rows(N, mode, inverse, R, real=False):
    """R seeded rows of a y pass and the JAX fftx_c2c(interpret=True) of
    their transposed (1, Nin, R) view, transposed back to (R, Nout);
    ``real``: xi zeros."""
    key = (N, mode, inverse, R, real)
    if key not in _JAX_ROWS:
        in_rolled, out_rolled = mode == "in_rolled", mode == "out_rolled"
        xr, xi = _rand((R, N // 2 if in_rolled else N), seed=N + R)
        if real:
            xi = np.zeros_like(xi)
        ref = fftx_j(jnp.asarray(xr.T[None]), jnp.asarray(xi.T[None]), N=N,
                     inverse=inverse, in_rolled=in_rolled,
                     out_rolled=out_rolled, lane_block=R, interpret=True)
        _JAX_ROWS[key] = (xr, xi, np.asarray(ref[0])[0].T,
                          np.asarray(ref[1])[0].T)
    return _JAX_ROWS[key]


@pytest.mark.parametrize("N", [512, 640, 2304, 3072, 2048, 2560, 4608, 5120,
                               256, 768, 1024, 1280, 1536])
@pytest.mark.parametrize("mode", ["full", "in_rolled", "out_rolled"])
@pytest.mark.parametrize("inverse", [False, True])
def test_rows_plain_matches_jax(N, mode, inverse):
    """The row kernel's stages (16, N/256, 16 where 256 divides N: R2 = 8,
    10, 12, 18, 20 at the lengths 2048-5120, the short R2 = 1-6 at
    256-1536 (none at 256 = 16 x 16); 16, 5, 8 at 640), rolled chunk
    offsets and kept half, in float64, against the JAX y pass in
    float32."""
    xr, xi, rr, ri = _jax_rows(N, mode, inverse, 8)
    yr, yi = fftx_c2c_rows_plain(
        torch.as_tensor(xr[..., None], dtype=torch.float64),
        torch.as_tensor(xi[..., None], dtype=torch.float64), N=N,
        inverse=inverse, in_rolled=mode == "in_rolled",
        out_rolled=mode == "out_rolled")
    assert yr.dtype == torch.float64 and yr.shape == rr.shape + (1,)
    _close(yr.numpy()[..., 0], rr)
    _close(yi.numpy()[..., 0], ri)


@pytest.mark.parametrize("mode", ["full", "in_rolled", "out_rolled"])
@pytest.mark.parametrize("inverse", [False, True])
def test_rows_wrapper_ragged_rows_matches_jax(mode, inverse):
    """5 rows at N = 4096, a length the kernel is built for: the CPU
    wrapper (the plain version) against the JAX y pass with lane_block=5,
    and fftx_c2c's CPU route beside it."""
    N = 4096
    xr, xi, rr, ri = _jax_rows(N, mode, inverse, 5)
    kw = dict(N=N, inverse=inverse, in_rolled=mode == "in_rolled",
              out_rolled=mode == "out_rolled")
    a, b = torch.as_tensor(xr[..., None]), torch.as_tensor(xi[..., None])
    for fn in (fftx_c2c_rows, fftx_c2c):
        yr, yi = fn(a, b, **kw)
        _close(yr.numpy()[..., 0], rr)
        _close(yi.numpy()[..., 0], ri)


def _stage_permutation(N, radices):
    """The Stockham stages' index map with no arithmetic, element by
    element: stage (R, Ns) moves n = j + q N/R (j = jq Ns + k) to
    jq Ns R + q Ns + k; returns src with out[m] = in[src[m]]."""
    src = list(range(N))
    Ns = 1
    for R in radices:
        nxt = [0] * N
        for j in range(N // R):
            jq, k = divmod(j, Ns)
            for q in range(R):
                nxt[jq * Ns * R + q * Ns + k] = src[j + q * (N // R)]
        src = nxt
        Ns *= R
    return np.array(src)


@pytest.mark.parametrize("N", [640, 3072, 4096])
@pytest.mark.parametrize("mode", ["full", "in_rolled", "out_rolled"])
def test_rows_skeleton_plain_is_the_stage_permutation(N, mode):
    """The skeleton (loads, two transposes, stores; no radix arithmetic)
    is the stages' permutation of the rolled line, kept rows selected as
    fftx_c2c selects them; the CPU wrapper's skeleton route gives it."""
    in_rolled, out_rolled = mode == "in_rolled", mode == "out_rolled"
    xr, xi = _rand((3, N // 2 if in_rolled else N), seed=12)
    full = xr + 1j * xi
    if in_rolled:
        full = np.zeros((3, N), complex)
        full[:, (np.arange(N // 2) - N // 4) % N] = xr + 1j * xi
    want = full[:, _stage_permutation(N, row_radices(N))]
    if out_rolled:
        want = want[:, (np.arange(N // 2) - N // 4) % N]
    kw = dict(N=N, in_rolled=in_rolled, out_rolled=out_rolled)
    a, b = torch.as_tensor(xr[..., None]), torch.as_tensor(xi[..., None])
    outs = [fftx_c2c_rows_skeleton_plain(a, b, **kw)]
    if row_route(N, 1):
        outs.append(fftx_c2c_rows(a, b, skeleton=True, **kw))
    for yr, yi in outs:
        assert np.array_equal(yr.numpy()[..., 0], want.real.astype(np.float32))
        assert np.array_equal(yi.numpy()[..., 0], want.imag.astype(np.float32))


def test_row_route_and_radices():
    """The dispatch rule, written once in ops/cfft.py: contiguous rows (L
    = 1) at the kernel's 27 lengths 256 R2 (R2 5-smooth, 1-64) take the
    row kernel; L > 1 never does (the cluster route's), nor other N (not
    a multiple of 256, or R2 not 5-smooth or past 64); no shape takes
    both routes. The plan is 16 x R2 x 16 at those lengths."""
    lengths = tuple(256 * r for r in range(1, 65) if _smooth(r))
    assert len(lengths) == 27 and lengths[0] == 256 and \
        lengths[-1] == 16384
    for n in lengths:
        assert row_route(n, 1) and not cluster_route(n, 1)
        assert not row_route(n, 8) and cluster_route(n, 8)
        assert row_radices(n) == (16, n // 256, 16)
    for n in (128, 1000, 1792, 3000, 3584, 4100, 6561, 16640, 18432):
        assert not row_route(n, 1)
    assert tuple(n for n in range(2, 16900) if row_route(n, 1)) == lengths
    for n, L in itertools.product((512, 2048, 4096, 6144, 8192, 12288,
                                   16384), (1, 2, 8, 64)):
        assert not (row_route(n, L) and cluster_route(n, L))
    assert row_radices(640) == (16, 5, 8) and row_radices(960) == (16, 15, 4)
    t = torch.zeros((2, 4096, 2))
    with pytest.raises(ValueError):   # L = 2: not contiguous rows
        fftx_c2c_rows(t, t, N=4096)
    with pytest.raises(ValueError):   # N = 1000: no instance
        fftx_c2c_rows(t[:, :1000, :1], None, N=1000)


class _CardStack:
    """A stand-in for a CUDA stack: a shape and ``is_cuda``, so that
    fftx_c2c's routing can be followed on the CPU."""
    is_cuda = True
    device = torch.device("cpu")

    def __init__(self, *shape):
        self.shape = shape


@pytest.mark.parametrize("N,L,route", [
    (8192, 8, "cluster"), (8192, 1, "rows"), (4096, 1, "rows"),
    (2048, 1, "rows"), (2048, 8, "cluster"), (16384, 1, "rows"),
    (1024, 8, "cluster"), (3000, 1, "line"), (3000, 8, "cluster"),
    (1350, 8, "line"), (160, 8, "line"), (2044, 8, "line"),
    (512, 1, "rows"), (1536, 1, "rows"), (256, 8, "cluster"),
    (5120, 1, "rows"), (2560, 8, "cluster"), (2304, 1, "rows"),
    (7680, 1, "rows"), (18432, 1, "rows_long"),
    (18432, 9216, "cols_long"), (32768, 1, "rows_long"),
    (16000, 1, "line"), (65536, 8, "four"), (131072, 1, "four"),
    (23040, 9216, "four")])
def test_fftx_c2c_route_order(monkeypatch, N, L, route):
    """A CUDA stack asks cluster_route first, then row_route, then
    cols_long_route, rows_long_route and four_step_route, then takes
    line_fft_kernel: each route's wrapper is called exactly where its
    rule says (fftx_c2c_route names it)."""
    called = []
    assert fftx_c2c_route(N, L) == route
    monkeypatch.setattr(cf.kernels, "require_cuda_f32", lambda *a: None)
    monkeypatch.setattr(cf, "fftx_c2c_cluster",
                        lambda *a, **k: called.append("cluster") or "c")
    monkeypatch.setattr(cf, "fftx_c2c_rows",
                        lambda *a, **k: called.append("rows") or "r")
    monkeypatch.setattr(cf, "fftx_c2c_four",
                        lambda *a, **k: called.append("four") or "f")
    monkeypatch.setattr(cf, "fftx_c2c_cols_long",
                        lambda *a, **k: called.append("cols_long") or "l")
    monkeypatch.setattr(cf, "fftx_c2c_rows_long",
                        lambda *a, **k: called.append("rows_long") or "w")

    def line(*a, **k):
        called.append("line")
        raise RuntimeError("no card")
    monkeypatch.setattr(cf.kernels, "library", line)
    x = _CardStack(2, N, L)
    try:
        cf.fftx_c2c(x, None, N=N)
    except RuntimeError:
        pass
    assert called == [route]


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card, so that the wrappers can
    be followed down to the kernel library here."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("N,L", [(2048, 1), (2048, 8), (2560, 1), (2560, 8),
                                 (3072, 1), (3072, 8), (4608, 1), (5120, 1),
                                 (1024, 8), (3000, 1), (2304, 1), (3840, 1),
                                 (16384, 1), (18432, 1), (18432, 4),
                                 (32768, 1), (256, 8), (512, 1), (768, 24),
                                 (1536, 1), (1350, 8), (65536, 2),
                                 (23040, 4), (24576, 2), (19200, 1)])
def test_fftx_c2c_passes_the_new_routes_shapes(monkeypatch, N, L):
    """On a stand-in CUDA stack (a stand-in library recording each entry's
    shape arguments) fftx_c2c at the lengths 2048-5120 launches the
    cluster kernel on clusters of 4 and tiles of 8 columns (its strided
    x pass) and the row kernel at the length (its y pass, also at R2 = 9,
    15 and 64), each counted on its own route; below 2048 the cluster
    kernel at cluster_shape's (C, W) (one block or _TINY_C, tiles of 8-32)
    and the row kernel at R2 = 2 and 6; above 16384 the long column
    kernel (K3xl) for the x pass at N = 8 x 256 R2 and the long row
    kernel (K3yl) for rows at N = 2 x 256 R2, each once on its own
    counter, and at the other lengths (23040, 19200, 65536) K3f at N,
    then the cluster kernel at N / 8 on 8 L columns; N = 3000
    (not a multiple of 256) and 1350 (N % 4 == 2) launch
    line_fft_kernel."""
    calls, cols = [], []

    class Lib:
        def __getattr__(self, name):
            def entry(*a):
                calls.append({"pfbt_cfft_cols": lambda: (name, a[12], a[13]),
                              "pfbt_cfft_rows": lambda: (name, a[5]),
                              "pfbt_cfft_four": lambda: (name, a[6]),
                              "pfbt_cfft_rows_long": lambda: (name, a[5]),
                              "pfbt_cfft_cols_long": lambda: (name, a[6]),
                              "pfbt_cfft": lambda: (name, a[6])}[name]())
                if name == "pfbt_cfft_cols":
                    cols.append((a[6], a[5]))
                return 0
            return entry
    monkeypatch.setattr(cf.kernels, "library", lambda: Lib())
    monkeypatch.setattr(cf.kernels, "require_cuda_f32", lambda *a: None)
    monkeypatch.setattr(cf.kernels, "stream_ptr", lambda: 0)
    monkeypatch.setattr(cf.kernels, "twiddles",
                        lambda n, dev, kind="plan": torch.zeros((n, 2)))
    x = torch.zeros((2, N, L)).as_subclass(_OnCard)
    counters = (fftx_c2c, cf.fftx_c2c_cluster, cf.fftx_c2c_rows,
                fftx_c2c_four, fftx_c2c_cols_long, fftx_c2c_rows_long)
    n0 = tuple(f.launches for f in counters)
    y = cf.fftx_c2c(x, x, N=N)
    got = tuple(f.launches - n for f, n in zip(counters, n0))
    if cluster_route(N, L):
        C, W = cluster_shape(N)
        assert N < 2048 and C in (1, cf._TINY_C) or (C, W) == (4, 8)
        assert calls == [("pfbt_cfft_cols", C, W)]
        assert got == (0, 1, 0, 0, 0, 0)
    elif row_route(N, L):
        assert calls == [("pfbt_cfft_rows", N)] and got == (0, 0, 1, 0, 0, 0)
    elif cols_long_route(N, L):
        assert calls == [("pfbt_cfft_cols_long", N)]
        assert got == (0, 0, 0, 0, 1, 0) and y[0].shape == (2, N, L)
    elif rows_long_route(N, L):
        assert calls == [("pfbt_cfft_rows_long", N)]
        assert got == (0, 0, 0, 0, 0, 1) and y[0].shape == (2, N, L)
    elif four_step_route(N, L):
        assert calls == [("pfbt_cfft_four", N),
                         ("pfbt_cfft_cols",) + cluster_shape(N // 8)]
        assert cols == [(N // 8, 8 * L)] and got == (0, 1, 0, 1, 0, 0)
        assert y[0].shape == (2, N, L)
    else:
        assert N in (1350, 3000)
        assert calls == [("pfbt_cfft", N)] and got == (1, 0, 0, 0, 0, 0)


@pytest.mark.parametrize("N", [2048, 2560, 3072])
def test_cluster_wrapper_takes_the_routes_clusters(N):
    """fftx_c2c_cluster below 4096 on a CPU stack: the plain version at
    the route's (C, W) = (4, 8), which is the transform, both ways."""
    assert cluster_shape(N) == (4, 8) and cluster_route(N, 4)
    xr, xi = _rand((1, N, 4), seed=N)
    a, b = torch.as_tensor(xr, dtype=torch.float64), \
        torch.as_tensor(xi, dtype=torch.float64)
    z = xr.astype(np.float64) + 1j * xi
    for inverse, ref in ((False, np.fft.fft(z, axis=-2)),
                         (True, N * np.fft.ifft(z, axis=-2))):
        yr, yi = fftx_c2c_cluster(a, b, N=N, inverse=inverse)
        _close(yr.numpy(), ref.real, 1e-12)
        _close(yi.numpy(), ref.imag, 1e-12)


# ---------------------------------------------------------------------
# the register row kernel at R2 = 9-64, the four-step above 16384, and the
# routes of the imaging paths

NEW_ROW_LENGTHS = (2304, 3840, 6400, 6912, 7680, 9216, 10240, 11520, 12800,
                   13824, 15360, 16384)


@pytest.mark.parametrize("N", NEW_ROW_LENGTHS)
@pytest.mark.parametrize("mode,inverse", [("full", False),
                                          ("in_rolled", False),
                                          ("out_rolled", True)])
def test_rows_plain_new_lengths_match_jax(N, mode, inverse):
    """The row kernel's plan at the lengths whose R2 = N / 256 (9, 15, 25,
    27, 30, 36, 40, 45, 50, 54, 60, 64) it was generalised to: 16 x R2 x
    16, rolled chunk offsets and kept half, in float64, against the JAX y
    pass in float32 on 4 rows."""
    assert row_route(N, 1) and row_radices(N) == (16, N // 256, 16)
    xr, xi, rr, ri = _jax_rows(N, mode, inverse, 4)
    yr, yi = fftx_c2c_rows_plain(
        torch.as_tensor(xr[..., None], dtype=torch.float64),
        torch.as_tensor(xi[..., None], dtype=torch.float64), N=N,
        inverse=inverse, in_rolled=mode == "in_rolled",
        out_rolled=mode == "out_rolled")
    _close(yr.numpy()[..., 0], rr)
    _close(yi.numpy()[..., 0], ri)


@pytest.mark.parametrize("N", [18432, 512])
@pytest.mark.parametrize("mode", ["full", "in_rolled", "out_rolled"])
@pytest.mark.parametrize("inverse", [False, True])
def test_four_step_plain_matches_jax(N, mode, inverse):
    """The four-step's steps (8-point DFTs over the strided factor,
    W_N^(n2 k1), the reorder, the N/8-point DFTs; fftx_c2c_four_plain) in
    float64 against the JAX fftx_c2c in interpret mode in float32 on (2,
    Nin, 8) stacks: at 18432 (the PSF grid of a 4608^2 image, on the
    four-step's lengths, now the lab's earlier route) and at 512, the split
    forced off the route; fftx_c2c_four and fftx_c2c on a CPU stack at
    18432 beside them."""
    xr, xi, rr, ri = _jax_ref(N, mode, inverse, 8)
    kw = dict(N=N, inverse=inverse, in_rolled=mode == "in_rolled",
              out_rolled=mode == "out_rolled")
    a, b = (torch.as_tensor(v, dtype=torch.float64) for v in (xr, xi))
    yr, yi = fftx_c2c_four_plain(a, b, **kw)
    assert yr.dtype == torch.float64 and yr.shape == rr.shape
    _close(yr.numpy(), rr)
    _close(yi.numpy(), ri)
    assert four_step_fits(N, 8) == (N > 16384)
    if N > 16384:
        for fn in (fftx_c2c_four, fftx_c2c):
            yr, yi = fn(torch.as_tensor(xr), torch.as_tensor(xi), **kw)
            _close(yr.numpy(), rr)
            _close(yi.numpy(), ri)
    else:
        with pytest.raises(ValueError):
            fftx_c2c_four(a, b, **kw)


def test_four_step_route_and_refusals():
    """The four-step fits above 16384 where N / 8 is on the cluster route
    with 8 L columns and rolled (N % 32 == 0): 18432-32768 and on to 8 x
    16384; never at or below 16384. Where it fits, rows (L = 1) of N = 2
    x 256 R2 take K3yl and the x pass at N = 8 x 256 R2 K3xl, so
    four_step_route keeps the rest: the x pass at 23040, 25600, 27648 and
    above 32768, the rows above 32768. A CUDA stack of a length above
    16384 off the routes is refused before any launch (no length above
    kMaxN reaches line_fft_kernel)."""
    for N in (18432, 20480, 23040, 24576, 25600, 27648, 30720, 32768,
              65536, 131072):
        for L in (1, 2, 4096):
            assert four_step_fits(N, L)
            new = ("rows_long" if N <= 32768 else "four") if L == 1 else \
                "cols_long" if N in (18432, 20480, 24576, 30720, 32768) \
                else "four"
            assert fftx_c2c_route(N, L) == new
            assert four_step_route(N, L) == (new == "four")
    for N in (16384, 8192, 2048, 16392, 16400, 24584, 262144, 20000 * 8):
        for L in (1, 4):
            assert not four_step_route(N, L) and not four_step_fits(N, L)
    for N, L in ((16400, 1), (24584, 1), (262144, 8), (160000, 1)):
        with pytest.raises(ValueError):
            fftx_c2c_route(N, L)
    t = torch.zeros((1, 16400, 1)).as_subclass(_OnCard)
    with pytest.raises(ValueError):
        fftx_c2c(t, t, N=16400)


@pytest.mark.parametrize("N, L", [(512, 3), (18432, 1)])
@pytest.mark.parametrize("in_rolled", [False, True])
@pytest.mark.parametrize("inverse", [False, True])
def test_four_step_first_plain_is_its_definition(N, L, in_rolled, inverse):
    """K3f's plain version (fftx_c2c_four_first_plain) in float64 against
    its sums written out in numpy: T[n2, L k1 + l] = W_N^(n2 k1) sum_n1
    x[n2 + M n1, l] W_8^(n1 k1) (conjugate roots, no scale, for the
    inverse), x zero-padded from the rolled rows; then its M-point DFTs
    over n2 are the whole transform."""
    M = N // 8
    nin = N // 2 if in_rolled else N
    xr, xi = _rand((2, nin, L), 31)
    a, b = (torch.as_tensor(v, dtype=torch.float64) for v in (xr, xi))
    tr, ti = fftx_c2c_four_first_plain(a, b, N=N, inverse=inverse,
                                       in_rolled=in_rolled)
    assert tr.shape == (2, M, 8 * L) and tr.dtype == torch.float64
    x = np.zeros((2, N, L), complex)
    z = xr.astype(np.float64) + 1j * xi.astype(np.float64)
    if in_rolled:
        x[:, :nin // 2], x[:, N - nin // 2:] = z[:, nin // 2:], z[:, :nin // 2]
    else:
        x[:] = z
    s = 1.0 if inverse else -1.0
    k1 = np.arange(8)
    w8 = np.exp(s * 2j * np.pi * np.outer(k1, k1) / 8)  # [n1, k1]
    wn = np.exp(s * 2j * np.pi * np.outer(np.arange(M), k1) / N)  # [n2, k1]
    ref = np.einsum("paml,ak->pmkl", x.reshape(2, 8, M, L), w8)
    ref = (ref * wn[None, :, :, None]).reshape(2, M, 8 * L)
    _close(tr.numpy(), ref.real)
    _close(ti.numpy(), ref.imag)
    X = np.fft.ifft(ref.reshape(2, M, 8, L), axis=1) * M if inverse else \
        np.fft.fft(ref.reshape(2, M, 8, L), axis=1)
    yr, yi = cf.fftx_c2c_plain(
        a, b, N=N, inverse=inverse, in_rolled=in_rolled)
    _close(X.reshape(2, N, L).real, yr.numpy())
    _close(X.reshape(2, N, L).imag, yi.numpy())


@pytest.mark.parametrize("N", [18432, 512])
@pytest.mark.parametrize("mode", ["full", "in_rolled", "out_rolled"])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("real", [False, True])
def test_rows_long_plain_matches_jax(N, mode, inverse, real):
    """K3yl's steps (fftx_c2c_rows_long_plain: the halves x[n] and x[n +
    N/2], u_0 = their sum, u_1 = their difference times W_N^n in float64,
    the register row kernel's three stages on each, X[2 k' + c] and the
    kept rows) and those of the lab's eight-block row kernel K3fr
    (the four-step's, fftx_c2c_four_plain) in float64 against the JAX y pass
    (fftx_c2c on the transposed view, interpret mode) in float32 on 2
    rows: at 18432 (the PSF grid of a 4608^2 image, on the route) and at
    512 = 2 x 256, the split forced off it; with xi and with a real input
    (None through the wrappers, zeros to JAX); fftx_c2c_rows_long,
    fftx_c2c_four_rows and fftx_c2c on a CPU stack at 18432 beside
    them."""
    xr, xi, rr, ri = _jax_rows(N, mode, inverse, 2, real)
    kw = dict(N=N, inverse=inverse, in_rolled=mode == "in_rolled",
              out_rolled=mode == "out_rolled")
    a, b = (torch.as_tensor(v[..., None], dtype=torch.float64)
            for v in (xr, xi))
    for plain in (fftx_c2c_rows_long_plain, fftx_c2c_four_plain):
        yr, yi = plain(a, b, **kw)
        assert yr.dtype == torch.float64 and yr.shape == rr.shape + (1,)
        _close(yr.numpy()[..., 0], rr)
        _close(yi.numpy()[..., 0], ri)
    assert rows_long_route(N, 1) == four_rows_fits(N, 1) == (N > 16384)
    if N > 16384:
        for fn in (fftx_c2c_rows_long, fftx_c2c_four_rows, fftx_c2c):
            yr, yi = fn(torch.as_tensor(xr[..., None]),
                        None if real else torch.as_tensor(xi[..., None]),
                        **kw)
            _close(yr.numpy()[..., 0], rr)
            _close(yi.numpy()[..., 0], ri)
    else:
        for fn in (fftx_c2c_rows_long, fftx_c2c_four_rows):
            with pytest.raises(ValueError):
                fn(a, b, **kw)


@pytest.mark.parametrize("N", [18432, 512])
@pytest.mark.parametrize("mode", ["full", "in_rolled", "out_rolled"])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("real", [False, True])
def test_cols_long_plain_matches_jax(N, mode, inverse, real):
    """K3xl's steps (fftx_c2c_cols_long_plain: rows n = c + 8 m of block
    c, the register row kernel's three stages on each line of N/8, W_N^(c
    k1) in float64, the 8-point DFTs across the cluster, the kept rows)
    and those of the lab's K3cl (fftx_c2c_cluster_plain at C = 8, the N/8-point
    DFTs whole) in float64 against the JAX x pass in interpret mode in
    float32 on (2, Nin, 8) stacks: at 18432 (on the route) and at 512 =
    8 x 64, forced off it; with xi and with a real input;
    fftx_c2c_cols_long, fftx_c2c_cluster_long and fftx_c2c on a CPU stack
    at 18432 beside them."""
    xr, xi, rr, ri = _jax_ref(N, mode, inverse, 8, real)
    kw = dict(N=N, inverse=inverse, in_rolled=mode == "in_rolled",
              out_rolled=mode == "out_rolled")
    a, b = (torch.as_tensor(v, dtype=torch.float64) for v in (xr, xi))
    for plain in (fftx_c2c_cols_long_plain, partial(fftx_c2c_cluster_plain,
                                                    C=8)):
        yr, yi = plain(a, b, **kw)
        assert yr.dtype == torch.float64 and yr.shape == rr.shape
        _close(yr.numpy(), rr)
        _close(yi.numpy(), ri)
    assert cols_long_route(N, 8) == cluster_long_fits(N, 8) == (N > 16384)
    if N > 16384:
        for fn in (fftx_c2c_cols_long, fftx_c2c_cluster_long, fftx_c2c):
            yr, yi = fn(torch.as_tensor(xr),
                        None if real else torch.as_tensor(xi), **kw)
            _close(yr.numpy(), rr)
            _close(yi.numpy(), ri)
    else:
        for fn in (fftx_c2c_cols_long, fftx_c2c_cluster_long):
            with pytest.raises(ValueError):
                fn(a, b, **kw)


def test_long_routes_keep_every_length_the_four_step_took():
    """No length loses its kernel: every N above 16384 up to 8 x 16384
    that the four-step fits still reaches one, K3yl for rows of N = 2 x
    256 R2 (the eight PSF grids 18432-32768 among them), K3xl for the x
    pass at N = 8 x 256 R2 (five of them), the four-step everywhere else;
    K3yl's plain version and the wrappers refuse stacks off their
    routes."""
    n, seen = 0, set()
    for N in range(16392, 8 * 16384 + 1, 8):
        for L in (1, 3):
            if not four_step_fits(N, L):
                continue
            n += 1
            route = fftx_c2c_route(N, L)
            want = "rows_long" if L == 1 and N // 2 in cf._ROW_LENGTHS \
                else "cols_long" if L > 1 and N // 8 in cf._ROW_LENGTHS \
                and N <= 32768 else "four"
            assert route == want, (N, L, route)
            seen.add(route)
    assert n > 100 and seen == {"rows_long", "cols_long", "four"}
    with pytest.raises(ValueError):
        fftx_c2c_rows_long_plain(torch.zeros((1, 512, 2)),
                                 torch.zeros((1, 512, 2)), N=512)
    t = torch.zeros((1, 18432, 2))
    for fn in (fftx_c2c_four_rows, fftx_c2c_rows_long):
        with pytest.raises(ValueError):
            fn(t, t, N=18432)
    for fn in (fftx_c2c_cluster_long, fftx_c2c_cols_long):
        with pytest.raises(ValueError):
            fn(t[..., :1], t[..., :1], N=18432)
    with pytest.raises(ValueError):
        fftx_c2c_cols_long(torch.zeros((1, 23040, 2)),
                           torch.zeros((1, 23040, 2)), N=23040)


def _cu_ints(name, pattern):
    """The integer groups of ``pattern`` in the sources csrc/``name`` (a
    glob)."""
    csrc = Path(cf.__file__).resolve().parents[1] / "csrc"
    return [tuple(int(v) for v in m) if isinstance(m, tuple) else int(m)
            for src in sorted(csrc.glob(name))
            for m in re.findall(pattern, src.read_text())]


def test_route_table_every_image_1024_to_8192():
    """For every 128-aligned 5-smooth image from 1024^2 to 8192^2 (21
    sizes): the image grid's and the PSF grid's w-plane transforms (the
    grid worker's nx_psf = good_even_size(2 nx), both on the gridder's
    sigma = 2 grids, which _resolve_cfft sends to fftx_c2c), their x pass
    out_rolled and in_rolled and their y pass, and the PSF Hessian's
    column and rows stages at NX = NY = 2 nx each reach a routed kernel
    whose plan takes the length: the cluster kernel with a tile within a
    block, the register row kernel at an instanced N (the C++ tables of
    cfft_rows.cu, psf_rows*.cu and psf_rows.cuh, and the rows twiddles'
    ceiling, read from the sources), the four-step with N / 8 on the
    cluster route, and from 18432 (4608^2) up the PSF grids' rows on the
    long row kernel (K3yl) and their x pass on the long column kernel
    (K3xl) at the five lengths N / 8 = 256 R2 it is built for (the
    tables of cfft_rows_long.cu and cfft_cols_long.cu read from the
    sources), the four-step at the other three. No pass is left on
    line_fft_kernel or psf_rows_kernel, so none above kMaxN reaches
    them."""
    from pfb_tpu_torch.ops import psf
    from pfb_tpu_torch.ops.fft import good_even_size
    from pfb_tpu_torch.ops.wgridder import _grid_setup, _resolve_cfft
    k3r = dict(_cu_ints("cfft_rows.cu", r"PFBT_ROWS\((\d+), (\d+), \d+\)"))
    k10br = dict(_cu_ints("psf_rows*.cu",
                          r"PFBT_FUSED\((\d+), (\d+), \d+\)"))
    fused = _cu_ints("psf_rows.cuh", r"case (\d+):")
    ceiling = _cu_ints("cfft_rows.cu", r"N > (\d+)\)")
    kmax = _cu_ints("fft_lines.cuh", r"constexpr int kMaxN = (\d+);")
    k3xl = dict(_cu_ints("cfft_cols_long.cu",
                         r"PFBT_COLS_LONG\((\d+), (\d+)\)"))
    k3yl = dict(_cu_ints("cfft_rows_long.cu",
                         r"PFBT_ROWS_LONG\((\d+), (\d+), \d+\)"))
    assert k3xl == {2048 * r: r for r in (9, 10, 12, 15, 16)}
    assert k3yl == {512 * r: r for r in (36, 40, 45, 48, 50, 54, 60, 64)}
    assert k3r == k10br == {256 * r: r for r in cf._ROW_RADICES}
    assert sorted(fused) == sorted(k3r) == list(cf._ROW_LENGTHS)
    assert ceiling == [max(k3r)] and kmax == [cf._LINE_MAX_N]

    def takes(N, L):
        route = fftx_c2c_route(N, L)
        if route == "cluster":
            C, W = cluster_shape(N)
            return (N // C) * W <= 8192 and N % C == 0
        if route == "rows":
            return L == 1 and k3r.get(N) == N // 256
        if route == "four":
            return N % 32 == 0 and takes(N // 8, 8 * L) and \
                fftx_c2c_route(N // 8, 8 * L) == "cluster"
        if route == "cols_long":
            return L > 1 and k3xl.get(N) == N // 2048
        if route == "rows_long":
            return L == 1 and k3yl.get(N) == N // 512
        return False

    images = [128 * m for m in range(8, 65) if _smooth(m)]
    assert len(images) == 21 and images[0] == 1024 and images[-1] == 8192
    cell = 1e-5
    seen = set()
    for nx in images:
        for n in (nx, good_even_size(int(2.0 * nx))):
            Nx, Ny = _grid_setup(n, n, cell, cell, 2.0)
            assert (Nx, Ny) == (2 * n, 2 * n)
            assert _resolve_cfft("auto", torch.float32, n, n, Nx, Ny, True)
            for N, L in ((Nx, Ny), (Nx, Ny // 2), (Ny, 1)):
                assert takes(N, L), (nx, n, N, L, fftx_c2c_route(N, L))
                seen.add(fftx_c2c_route(N, L))
        NX = NY = 2 * nx
        assert psf.cols_route(NX, nx) and psf.rows_route(NY)
        assert NY in fused and k10br[NY] == NY // 256
    assert seen == {"cluster", "rows", "cols_long", "rows_long", "four"}
    for N in (18432, 20480, 23040, 24576, 25600, 27648, 30720, 32768):
        assert fftx_c2c_route(N, 1) == "rows_long"
        assert fftx_c2c_route(N, N) == fftx_c2c_route(N, N // 2) == \
            ("cols_long" if N in k3xl else "four")


def test_route_table_every_image_128_to_8192():
    """For every 128-aligned 5-smooth image from 128^2 to 8192^2 (27
    sizes, those below 1024^2 on the short designs): the image grid's and
    the PSF grid's w-plane transforms (the grid worker's nx_psf =
    good_even_size(2 nx), both on the gridder's sigma = 2 grids, which
    _resolve_cfft sends to fftx_c2c), their x pass out_rolled and
    in_rolled and their y pass, and the PSF Hessian's column and rows
    stages at NX = NY = 2 nx each reach a redesigned kernel whose plan
    takes the length: the cluster kernel with a tile within a block (one
    block or _TINY_C below 2048), the register row kernel at an instanced
    N (the C++ tables of cfft_rows.cu, psf_rows*.cu and psf_rows.cuh read from
    the sources, R2 = 1-64), and from 18432 up the long row kernel (K3yl)
    for rows, the long column kernel (K3xl) or the four-step for the x
    pass.
    None reaches line_fft_kernel, psf_rows_kernel or K2's line column
    kernels (which K2 takes only off cols_route)."""
    from pfb_tpu_torch.ops import psf
    from pfb_tpu_torch.ops.fft import good_even_size
    from pfb_tpu_torch.ops.wgridder import _grid_setup, _resolve_cfft
    k3r = dict(_cu_ints("cfft_rows.cu", r"PFBT_ROWS\((\d+), (\d+), \d+\)"))
    k10br = dict(_cu_ints("psf_rows*.cu",
                          r"PFBT_FUSED\((\d+), (\d+), \d+\)"))
    fused = _cu_ints("psf_rows.cuh", r"case (\d+):")
    floor = _cu_ints("cfft_rows.cu", r"N < (\d+) \|\|")
    k3xl = dict(_cu_ints("cfft_cols_long.cu",
                         r"PFBT_COLS_LONG\((\d+), (\d+)\)"))
    k3yl = dict(_cu_ints("cfft_rows_long.cu",
                         r"PFBT_ROWS_LONG\((\d+), (\d+), \d+\)"))
    assert k3xl == {2048 * r: r for r in (9, 10, 12, 15, 16)}
    assert k3yl == {512 * r: r for r in (36, 40, 45, 48, 50, 54, 60, 64)}
    assert k3r == k10br == {256 * r: r for r in cf._ROW_RADICES}
    assert sorted(fused) == sorted(k3r) == list(cf._ROW_LENGTHS)
    assert floor == [min(k3r)] == [256]
    assert _cu_ints("psf_cols.cuh", r"kColsMinNX = (\d+);") == \
        [cf._CLUSTER_MIN_N] == [256]
    assert _cu_ints("psf_cols.cuh", r"kTinyClusters = (\d+);") == \
        [cf._TINY_C]

    def takes(N, L):
        route = fftx_c2c_route(N, L)
        if route == "cluster":
            C, W = cluster_shape(N)
            assert N >= 2048 or C in (1, cf._TINY_C)
            return (N // C) * W <= 8192 and N % C == 0 and _smooth(N // C)
        if route == "rows":
            return L == 1 and k3r.get(N) == N // 256
        if route == "four":
            return N % 32 == 0 and takes(N // 8, 8 * L) and \
                fftx_c2c_route(N // 8, 8 * L) == "cluster"
        if route == "cols_long":
            return L > 1 and k3xl.get(N) == N // 2048
        if route == "rows_long":
            return L == 1 and k3yl.get(N) == N // 512
        return False

    images = [128 * m for m in range(1, 65) if _smooth(m)]
    assert len(images) == 27 and images[0] == 128 and images[-1] == 8192
    cell = 1e-5
    seen, short = set(), set()
    for nx in images:
        for n in (nx, good_even_size(int(2.0 * nx))):
            Nx, Ny = _grid_setup(n, n, cell, cell, 2.0)
            assert (Nx, Ny) == (2 * n, 2 * n)
            assert _resolve_cfft("auto", torch.float32, n, n, Nx, Ny, True)
            for N, L in ((Nx, Ny), (Nx, Ny // 2), (Ny, 1)):
                assert takes(N, L), (nx, n, N, L, fftx_c2c_route(N, L))
                seen.add(fftx_c2c_route(N, L))
                if N < 2048:
                    short.add((N, fftx_c2c_route(N, L)))
        NX = NY = 2 * nx
        assert psf.cols_route(NX, nx) and psf.rows_route(NY)
        assert NY in fused and k10br[NY] == NY // 256
    assert seen == {"cluster", "rows", "cols_long", "rows_long", "four"}
    for N in (18432, 20480, 23040, 24576, 25600, 27648, 30720, 32768):
        assert fftx_c2c_route(N, 1) == "rows_long"
        assert fftx_c2c_route(N, N) == fftx_c2c_route(N, N // 2) == \
            ("cols_long" if N in k3xl else "four")
    assert short == {(n, r) for n in (256, 512, 768, 1024, 1280, 1536)
                     for r in ("cluster", "rows")}
