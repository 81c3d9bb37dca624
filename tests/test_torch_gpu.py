"""The hand-written CUDA kernels of pfb_tpu_torch against their plain
PyTorch versions on the card. Skipped without a CUDA device; on the
card run ``python -m pytest --noconftest tests/test_torch_gpu.py`` (the
repo's conftest imports jax, which the card's machine need not have).

Tolerance max|kernel - plain| <= 1e-5 max|plain|: the FFT kernels (K1,
K2, K3, K10-K15) are float32 FFT pipelines (expected ~1e-6 log2 N); the pg
gridder's kernels,
all planes (K4-K6) or one w block (K7-K9), sum at most a tile's
visibilities per grid point, or k^3 taps per visibility, in float32
(expected ~1e-7 to 1e-6). K3's three routes (line, cluster, row
kernel) each count their own launches, and so do the PSF column stages'
cluster kernels (psf_cols_fwd / psf_cols_inv), from every entry that
takes their route; on that route K10's space shards stay bit for bit
K1. The rows stage's register kernel (K10br, psf_rows) is held against
the plain stage and its own staged decomposition at every length it is
built for, counts its launches from every entry with a rows stage, and
keeps K10's row shards bit for bit K1; the fold (K5, K8) equals its
gather model (the same sources summed in the same order) bit for bit,
and the plain index_add_ fold within the tolerance. The lab kernels
(scripts/torch_g2i_lab.py, scripts/torch_capacity_lab.py): the copy
probes equal slicing exactly; the cluster and row kernels' skeletons
equal their plain permutations exactly; the
line kernel with an explicit lines-per-block is held to 1e-5 of max
against the plain transform; the split x pass
is held to 1e-5 of max against its plain version (the same split
products summed in another order; a one-ulp change of an intermediate
can move a product's bf16 low part, about 2^-17 of the product)."""

import itertools

import numpy as np
import pytest
import torch

from pfb_tpu_torch.ops import cfft as cf
from pfb_tpu_torch.ops import memlab
from pfb_tpu_torch.ops import pallas_fft as pft
from pfb_tpu_torch.ops import pg_stream as pgs
from pfb_tpu_torch.ops import pgridder as pg
from pfb_tpu_torch.ops import psf as psf_mod
from pfb_tpu_torch.ops.cfft import fftx_c2c, fftx_c2c_plain
from pfb_tpu_torch.ops.psf import (make_psf_convolve_pallas, prep_h,
                                   prep_h_full, prep_h_space,
                                   psf_convolve_full,
                                   psf_convolve_full_plain, psf_convolve_h,
                                   psf_convolve_h_cg,
                                   psf_convolve_h_cg_plain,
                                   psf_convolve_h_plain, psf_stage_cols_fwd,
                                   psf_stage_cols_fwd_plain,
                                   psf_stage_cols_inv,
                                   psf_stage_cols_inv_plain, psf_stage_rows,
                                   psf_stage_rows_plain, space_rows)
from pfb_tpu_torch.opt.pcg import make_pcg_bands_fused, pcg_bands
from pfb_tpu_torch.utils.simulation import image_size_for, simulate_obs

pytestmark = pytest.mark.gpu
TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ok(out, ref):
    return float((out - ref).abs().max()) <= TOL * float(ref.abs().max())


def _launches():
    """(line kernel, cluster kernel, row kernel) launch counts."""
    return (fftx_c2c.launches, cf.fftx_c2c_cluster.launches,
            cf.fftx_c2c_rows.launches)


# every length of the register row kernels (K3r, K10br): 256 R2, R2
# 5-smooth from 1 to 64; the nine of PRs 9-14 first, the short ones (R2 =
# 1-6, several rows a block) last
SHORT_LENGTHS = (256, 512, 768, 1024, 1280, 1536)
ROW_LENGTHS = (4096, 6144, 8192, 12288, 2048, 2560, 3072, 4608, 5120, 2304,
               3840, 6400, 6912, 7680, 9216, 10240, 11520, 12800, 13824,
               15360, 16384) + SHORT_LENGTHS


@pytest.mark.parametrize("N,L", [(256, 128), (512, 1), (640, 8),
                                 (2304, 128), (8192, 64), (16384, 4),
                                 (4096, 8), (6144, 24), (8192, 16),
                                 (8192, 20), (12288, 8), (8192, 1),
                                 (2048, 8), (2560, 24), (3072, 1),
                                 (4608, 1), (5120, 1), (1024, 8),
                                 (3000, 1)])
@pytest.mark.parametrize("mode", ["full", "in_rolled", "out_rolled"])
@pytest.mark.parametrize("inverse", [False, True])
def test_cfft_kernel_matches_plain(cuda, N, L, mode, inverse):
    """K3 on its three routes; the cluster column kernel launches exactly
    where cluster_route says (L > 1 and N >= 256 here), the row kernel
    where row_route says (L = 1 at its 27 lengths), the line kernel
    elsewhere, and each launch counts on its own route only."""
    g = torch.Generator(device=cuda).manual_seed(N + L)
    kw = dict(N=N, inverse=inverse, in_rolled=mode == "in_rolled",
              out_rolled=mode == "out_rolled")
    nin = N // 2 if kw["in_rolled"] else N
    xr = torch.randn((2, nin, L), generator=g, device=cuda)
    xi = torch.randn((2, nin, L), generator=g, device=cuda)
    n0, c0, r0 = _launches()
    yr, yi = fftx_c2c(xr, xi, **kw)
    torch.cuda.synchronize()
    cluster = L > 1 and N >= 256
    rows = L == 1 and N in ROW_LENGTHS
    assert cf.cluster_route(N, L) == cluster
    assert cf.row_route(N, L) == rows
    assert _launches() == (n0 + (not cluster and not rows), c0 + cluster,
                           r0 + rows)
    pr, pi = fftx_c2c_plain(xr, xi, **kw)
    assert _ok(yr, pr) and _ok(yi, pi)


@pytest.mark.parametrize("N", ROW_LENGTHS)
@pytest.mark.parametrize("mode", ["full", "in_rolled", "out_rolled"])
@pytest.mark.parametrize("inverse", [False, True])
def test_rows_kernel_matches_plain(cuda, N, mode, inverse):
    """K3r (fftx_c2c_rows) on 37 rows (no multiple of anything the
    launch takes) against its plain version, with xi and with a real
    input (xi None); the skeleton equals its plain permutation bit for
    bit."""
    g = torch.Generator(device=cuda).manual_seed(N + 37)
    kw = dict(N=N, in_rolled=mode == "in_rolled",
              out_rolled=mode == "out_rolled")
    nin = N // 2 if kw["in_rolled"] else N
    xr = torch.randn((37, nin, 1), generator=g, device=cuda)
    xi = torch.randn((37, nin, 1), generator=g, device=cuda)
    for b in (xi, None):
        n0, c0, r0 = _launches()
        yr, yi = cf.fftx_c2c_rows(xr, b, inverse=inverse, **kw)
        torch.cuda.synchronize()
        assert _launches() == (n0, c0, r0 + 1)
        pr, pi = cf.fftx_c2c_rows_plain(
            xr, torch.zeros_like(xr) if b is None else b, inverse=inverse,
            **kw)
        assert _ok(yr, pr) and _ok(yi, pi)
    sr, si = cf.fftx_c2c_rows(xr, xi, skeleton=True, **kw)
    pr, pi = cf.fftx_c2c_rows_skeleton_plain(xr, xi, **kw)
    assert torch.equal(sr, pr) and torch.equal(si, pi)


@pytest.mark.parametrize("N,pruned", [(4096, "out"), (8192, "in"),
                                      (6144, "out"), (2048, "out"),
                                      (2048, "in"), (2560, "in"),
                                      (3072, "out"), (1024, "out"),
                                      (256, "in"), (512, "out"),
                                      (768, "in"), (1280, "out"),
                                      (1536, "in")])
def test_fft2_launches_by_route(cuda, N, pruned):
    """fft2_c2c_pruned: at every 128-aligned grid from N = 256 (the pg
    grids of 128^2 images and up) the x pass launches the cluster kernel
    and the y pass K3r, never line_fft_kernel. Against the plain 2-D
    transform."""
    g = torch.Generator(device=cuda).manual_seed(N)
    pin = pruned == "in"
    n = N // 2 if pin else N
    xr = torch.randn((2, n, n), generator=g, device=cuda)
    xi = torch.randn((2, n, n), generator=g, device=cuda)
    kw = dict(Nx=N, Ny=N, inverse=not pin, pruned_in=pin,
              pruned_out=not pin)
    n0, c0, r0 = _launches()
    yr, yi = cf.fft2_c2c_pruned(xr, xi, **kw)
    torch.cuda.synchronize()
    assert _launches() == (n0, c0 + 1, r0 + 1)
    ref = torch.fft.ifft2 if not pin else torch.fft.fft2
    z = torch.zeros((2, N, N), dtype=torch.complex64, device=cuda)
    rows = (torch.arange(n, device=cuda) - N // 4) % N if pin else \
        torch.arange(N, device=cuda)
    z[:, rows[:, None], rows[None, :]] = torch.complex(xr, xi)
    full = ref(z) * (N * N if not pin else 1)
    if not pin:
        keep = (torch.arange(N // 2, device=cuda) - N // 4) % N
        full = full[:, keep[:, None], keep[None, :]]
    assert _ok(yr, full.real) and _ok(yi, full.imag)


@pytest.mark.parametrize("N,L", [(4096, 20), (8192, 48), (6144, 13),
                                 (2048, 24), (12288, 12), (16384, 6),
                                 (2560, 20), (3072, 12), (256, 40),
                                 (512, 24), (768, 20), (1024, 12),
                                 (1280, 13), (1536, 8)])
@pytest.mark.parametrize("mode", ["full", "in_rolled", "out_rolled"])
def test_cluster_kernel_launch_parameters(cuda, N, L, mode):
    """fftx_c2c_cluster at cluster_shape's (C, W) against the plain
    transform, with a real input (xi None), a view at a 4-byte offset
    (the scalar load/store path) and ragged tiles; the skeleton equals
    its plain permutation bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(N + L)
    kw = dict(N=N, in_rolled=mode == "in_rolled",
              out_rolled=mode == "out_rolled")
    nin = N // 2 if kw["in_rolled"] else N
    buf = torch.randn((2 * 2 * nin * L + 1,), generator=g, device=cuda)
    xr = buf[:2 * nin * L].view(2, nin, L)
    xi = buf[2 * nin * L:-1].view(2, nin, L)
    xo = buf[1:2 * nin * L + 1].view(2, nin, L)
    for (a, b), inverse in itertools.product(((xr, xi), (xr, None),
                                              (xo, xi)), (False, True)):
        c0 = cf.fftx_c2c_cluster.launches
        yr, yi = cf.fftx_c2c_cluster(a, b, inverse=inverse, **kw)
        torch.cuda.synchronize()
        assert cf.fftx_c2c_cluster.launches == c0 + 1
        pr, pi = fftx_c2c_plain(a, torch.zeros_like(a) if b is None else b,
                                inverse=inverse, **kw)
        assert _ok(yr, pr) and _ok(yi, pi)
    pr, pi = cf.fftx_c2c_cluster_skeleton_plain(
        xr, xi, C=cf.cluster_shape(N)[0], **kw)
    sr, si = cf.fftx_c2c_cluster(xr, xi, skeleton=True, **kw)
    assert torch.equal(sr, pr) and torch.equal(si, pi)


@pytest.mark.parametrize("N", [6561, 8748, 3000, 16000, 1350, 160])
def test_cfft_other_lengths_keep_the_line_kernel(cuda, N):
    """N = 3^8 (no cluster of 4 divides it), 4 * 3^7 (a tile of 4 columns
    of N / 4 exceeds a block), 1350 (N % 4 == 2) and 160 (below the
    cluster route's 256) take line_fft_kernel on strided columns, as
    cluster_route says; on
    contiguous rows (L = 1) those and 3000 and 16000 (no multiple of 256;
    16384 has had a row kernel instance since R2 = 64) take it too, as
    row_route says. The other two routes launch nothing."""
    g = torch.Generator(device=cuda).manual_seed(N)
    n0, c0, r0 = _launches()
    Ls = (1,) if N in (3000, 16000) else (16, 1)
    for L in Ls:
        xr = torch.randn((2, N, L), generator=g, device=cuda)
        xi = torch.randn((2, N, L), generator=g, device=cuda)
        for inverse in (False, True):
            yr, yi = fftx_c2c(xr, xi, N=N, inverse=inverse)
            pr, pi = fftx_c2c_plain(xr, xi, N=N, inverse=inverse)
            assert _ok(yr, pr) and _ok(yi, pi)
    assert _launches() == (n0 + 2 * len(Ls), c0, r0)


@pytest.mark.parametrize("N,L", [(18432, 1), (18432, 5), (18432, 64),
                                 (32768, 1), (32768, 3)])
@pytest.mark.parametrize("mode", ["full", "in_rolled", "out_rolled"])
@pytest.mark.parametrize("inverse", [False, True])
def test_four_step_matches_plain(cuda, N, L, mode, inverse):
    """The four-step above 16384 (fftx_c2c's route there before K3xl and
    K3yl, the lab's since; the line kernel's plan stops at 16384): K3f
    once, then the cluster kernel at N / 8 once, the line and row kernels
    never; against torch.fft and against the four-step's plain version,
    with xi and with a real input."""
    g = torch.Generator(device=cuda).manual_seed(N + L)
    kw = dict(N=N, inverse=inverse, in_rolled=mode == "in_rolled",
              out_rolled=mode == "out_rolled")
    nin = N // 2 if kw["in_rolled"] else N
    xr = torch.randn((2, nin, L), generator=g, device=cuda)
    xi = torch.randn((2, nin, L), generator=g, device=cuda)
    assert cf.four_step_fits(N, L)
    for b in (xi, None):
        n0, f0 = _launches(), cf.fftx_c2c_four.launches
        yr, yi = cf.fftx_c2c_four(xr, b, **kw)
        torch.cuda.synchronize()
        assert _launches() == (n0[0], n0[1] + 1, n0[2])
        assert cf.fftx_c2c_four.launches == f0 + 1
        bb = torch.zeros_like(xr) if b is None else b
        pr, pi = fftx_c2c_plain(xr, bb, **kw)
        assert _ok(yr, pr) and _ok(yi, pi)
        mr, mi = cf.fftx_c2c_four_plain(xr, bb, **kw)
        assert _ok(yr, mr) and _ok(yi, mi)


@pytest.mark.parametrize("N,L", [(18432, 1), (32768, 1), (18432, 5),
                                 (18432, 64), (32768, 3)])
@pytest.mark.parametrize("mode", ["full", "in_rolled", "out_rolled"])
@pytest.mark.parametrize("inverse", [False, True])
def test_long_kernels_match_plain(cuda, N, L, mode, inverse):
    """fftx_c2c above 16384 on the PSF grids' lengths: rows (L = 1) on the
    long row kernel (K3yl), the x pass on the long column kernel (K3xl),
    each once on its own counter, the four-step, line, cluster and row
    kernels never; against its plain version and against torch.fft, with
    xi and with a real input. The lab's one-pass designs of the same
    pass (K3fr for rows, K3cl for the x pass) against theirs."""
    g = torch.Generator(device=cuda).manual_seed(N + L + 7)
    kw = dict(N=N, inverse=inverse, in_rolled=mode == "in_rolled",
              out_rolled=mode == "out_rolled")
    nin = N // 2 if kw["in_rolled"] else N
    xr = torch.randn((2, nin, L), generator=g, device=cuda)
    xi = torch.randn((2, nin, L), generator=g, device=cuda)
    if L == 1:
        path, plain = cf.fftx_c2c_rows_long, cf.fftx_c2c_rows_long_plain
        lab, lab_plain = cf.fftx_c2c_four_rows, cf.fftx_c2c_four_plain
    else:
        path, plain = cf.fftx_c2c_cols_long, cf.fftx_c2c_cols_long_plain
        lab = cf.fftx_c2c_cluster_long

        def lab_plain(a, b, **k):
            return cf.fftx_c2c_cluster_plain(a, b, C=cf._LONG_C, **k)
    assert cf.fftx_c2c_route(N, L) == ("rows_long" if L == 1
                                       else "cols_long")
    for b in (xi, None):
        bb = torch.zeros_like(xr) if b is None else b
        pr, pi = fftx_c2c_plain(xr, bb, **kw)
        n0, f0 = _launches(), cf.fftx_c2c_four.launches
        p0 = path.launches
        yr, yi = fftx_c2c(xr, b, **kw)
        torch.cuda.synchronize()
        assert _launches() == n0 and cf.fftx_c2c_four.launches == f0
        assert path.launches == p0 + 1
        assert _ok(yr, pr) and _ok(yi, pi)
        mr, mi = plain(xr, bb, **kw)
        assert _ok(yr, mr) and _ok(yi, mi)
        q0 = lab.launches
        yr, yi = lab(xr, b, **kw)
        torch.cuda.synchronize()
        assert lab.launches == q0 + 1
        mr, mi = lab_plain(xr, bb, **kw)
        assert _ok(yr, mr) and _ok(yi, mi) and _ok(yr, pr)


def test_grid_pg_w_gridded_psf_grid_above_16384(cuda, tmp_path):
    """_grid(backend="pg", do_wgridding=True) at 4608^2 on a small
    observation: every w plane of its 18432^2 PSF grid takes K3xl (x pass)
    and K3yl (rows), a launch of each for every four planes, and no
    kernel of the four-step (K3f) or the line kernel; its PSF and dirty
    image finite, the PSF's peak at the centre."""
    from pfb_tpu_torch.utils.ms import simulate_ms
    from pfb_tpu_torch.workers.grid import _grid
    from pfb_tpu_torch.workers.init import _init
    ms = str(tmp_path / "t.npz")
    simulate_ms(ms, nant=8, ntime=4, nchan=2, nsource=3, fov_deg=0.4,
                seed=19)
    xds = _init(ms=ms, write=False, channels_per_image=2,
                precision="single", device=cuda)
    n0, f0 = _launches(), cf.fftx_c2c_four.launches
    x0, y0 = cf.fftx_c2c_cols_long.launches, cf.fftx_c2c_rows_long.launches
    dds = _grid(xdsi=xds, device=cuda, write=False, nx=4608, ny=4608,
                cell_size=0.5, robustness=0.0, backend="pg", epsilon=1e-5,
                do_wgridding=True, psf=True, residual=False)
    torch.cuda.synchronize()
    nx, ny = cf.fftx_c2c_cols_long.launches - x0, \
        cf.fftx_c2c_rows_long.launches - y0
    assert nx == ny >= len(dds) and cf.fftx_c2c_four.launches == f0
    assert _launches()[0] == n0[0]
    for ds in dds:
        psf = np.asarray(ds["PSF"], np.float64)
        assert psf.shape == (9216, 9216) and np.isfinite(psf).all()
        assert np.isfinite(np.asarray(ds["DIRTY"])).all()
        assert np.unravel_index(psf.argmax(), psf.shape) == (4608, 4608)


def test_grid_pg_psf_grid_above_16384_matches_cpu(cuda, tmp_path):
    """_grid(backend="pg") at 4608^2 on a small observation: its PSF is
    9216^2 on a grid of 18432^2, whose two passes take K3xl and K3yl (the
    four-step before them; the grid raised on the card before that), its
    image grid of 9216^2 the cluster and row kernels (R2 = 36),
    w-gridding off so that one plane fits; the PSF and the dirty image
    against the CPU's within 1e-5 of their peaks."""
    from pfb_tpu_torch.utils.ms import simulate_ms
    from pfb_tpu_torch.workers.grid import _grid
    from pfb_tpu_torch.workers.init import _init
    ms = str(tmp_path / "t.npz")
    simulate_ms(ms, nant=8, ntime=4, nchan=2, nsource=3, fov_deg=0.4,
                seed=19)
    xds = _init(ms=ms, write=False, channels_per_image=2,
                precision="single", device=cuda)
    kw = dict(write=False, nx=4608, ny=4608, cell_size=0.5, robustness=0.0,
              backend="pg", epsilon=1e-5, do_wgridding=False, psf=True,
              residual=False)
    n0, f0 = _launches(), cf.fftx_c2c_four.launches
    x0, y0 = cf.fftx_c2c_cols_long.launches, cf.fftx_c2c_rows_long.launches
    dds = _grid(xdsi=xds, device=cuda, **kw)
    torch.cuda.synchronize()
    n1 = _launches()
    assert n1[0] == n0[0] and n1[1] > n0[1] and n1[2] > n0[2]
    assert cf.fftx_c2c_four.launches == f0
    assert cf.fftx_c2c_cols_long.launches - x0 == len(dds)
    assert cf.fftx_c2c_rows_long.launches - y0 == len(dds)
    ref = _grid(xdsi=_init(ms=ms, write=False, channels_per_image=2,
                           precision="single", device="cpu"),
                device="cpu", **kw)
    for ds, rs in zip(dds, ref):
        assert ds["PSF"].shape == (9216, 9216)
        for key in ("PSF", "DIRTY"):
            got, want = (np.asarray(d[key], np.float64) for d in (ds, rs))
            assert np.abs(got - want).max() <= TOL * np.abs(want).max()


@pytest.mark.parametrize("nb,nx", [(2, 128), (1, 1152), (2, 1024)])
@pytest.mark.parametrize("complex_h", [False, True])
def test_psf_kernel_matches_plain(cuda, nb, nx, complex_h):
    """H from a random real PSF (complex) or its even part (real)."""
    g = torch.Generator(device=cuda).manual_seed(nx)
    x = torch.randn((nb, nx, nx), generator=g, device=cuda)
    psf = torch.randn((nb, 2 * nx, 2 * nx), generator=g, device=cuda)
    hr, hi = prep_h(psf, nx, nx, torch.float32,
                    real_transfer=not complex_h)
    out = psf_convolve_h(x, hr, hi)
    torch.cuda.synchronize()
    assert _ok(out, psf_convolve_h_plain(x, hr, hi))


def test_psf_kernel_any_h(cuda):
    """An H that is not the transform of a real PSF: the kernel and the
    plain version both read rows 0 and NX/2 as real."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((2, 1024, 1024), generator=g, device=cuda)
    hr = torch.randn((2, 1025, 2048), generator=g, device=cuda)
    hi = torch.randn_like(hr)
    assert _ok(psf_convolve_h(x, hr, hi), psf_convolve_h_plain(x, hr, hi))


def test_wrappers_reject_bad_operands(cuda):
    x = torch.zeros((1, 256, 128), device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError):
        fftx_c2c(x, x, N=256)
    y = torch.zeros((1, 128, 128), device=cuda)
    h = torch.zeros((1, 129, 256), device=cuda)
    with pytest.raises(ValueError):
        psf_convolve_h(y, h.double())


def _pg_plan(cuda, nx, eps, do_w, tiles=(None, None), seed=0,
             capacity=128):
    """A float32 pg plan on the card from a simulated observation whose uv
    coverage reaches both signs of u and v (so tiles wrap)."""
    obs = simulate_obs(nant=16, ntime=24, nchan=4, seed=seed)
    _, cell = image_size_for(obs, fov_deg=1.0)
    return pg.pgrid_plan(obs.uvw, obs.freq, nx=nx, ny=nx, cellx=cell,
                         celly=cell, epsilon=eps, do_wgridding=do_w,
                         capacity=capacity, tile_u=tiles[0],
                         tile_v=tiles[1], dtype=torch.float32, device=cuda)


def _spread_fold(p, vis, kernel):
    k, nw, txs, tys = p["k"], p["nw"], p["txs"], p["tys"]
    slots = pg._compact_slots(p["tid"], p["pm"], p["ntx"], p["nty"], txs,
                              tys, k)
    kw = dict(beta=p["beta"], k=k, nw=nw, Thx=txs + k, Thy=tys + k)
    spread = pg.pg_spread if kernel else pg.pg_spread_plain
    Y = spread(p["pos"], vis, slots, **kw)
    Y = Y.reshape(2 * nw, slots["NS"], txs + k, tys + k)
    fkw = dict(nty=p["nty"], txs=txs, tys=tys, k=k, Nx=p["Nx"], Ny=p["Ny"])
    if kernel:
        G = pg.pg_fold(Y, slots, ntx=p["ntx"], **fkw)
    else:
        G = pg.pg_fold_plain(Y, slots, **fkw)
    return Y[:, slots["live"]], G  # only live slots hold a result


# (nx, epsilon -> k, w planes, tiles): k = 7 and 9, nw = 1 and > 1,
# default and auto-ladder tiles, an 8192-point grid (periodic wrap of the
# tiles at both edges)
PG_CASES = [(512, 1e-5, True, (None, None)),
            (512, 1e-7, True, (None, None)),
            (512, 1e-5, False, (None, None)),
            (1024, 1e-5, True, (57, 249)),
            (1024, 1e-7, False, (63, 247)),
            (4096, 1e-5, True, (None, None))]


@pytest.mark.parametrize("nx,eps,do_w,tiles", PG_CASES)
def test_pg_spread_fold_kernels_match_plain(cuda, nx, eps, do_w, tiles):
    p = _pg_plan(cuda, nx, eps, do_w, tiles, seed=nx)
    assert (p["nw"] > 1) == do_w
    g = torch.Generator(device=cuda).manual_seed(nx)
    vis = torch.randn((p["nentries"], 2, p["C"]), generator=g,
                      device=cuda) * p["pm"][:, None]
    n4, n5 = pg.pg_spread.launches, pg.pg_fold.launches
    Yk, Gk = _spread_fold(p, vis.contiguous(), kernel=True)
    torch.cuda.synchronize()
    assert (pg.pg_spread.launches, pg.pg_fold.launches) == (n4 + 1, n5 + 1)
    Yp, Gp = _spread_fold(p, vis, kernel=False)
    assert _ok(Yk, Yp)
    assert _ok(Gk, Gp)


@pytest.mark.parametrize("nx,eps,do_w,tiles", PG_CASES)
def test_pg_degrid_kernel_matches_plain(cuda, nx, eps, do_w, tiles):
    p = _pg_plan(cuda, nx, eps, do_w, tiles, seed=nx + 1)
    g = torch.Generator(device=cuda).manual_seed(nx)
    gr = torch.randn((p["nw"], p["Nx"], p["Ny"]), generator=g, device=cuda)
    gi = torch.randn_like(gr)
    kw = dict(beta=p["beta"], k=p["k"], nw=p["nw"], txs=p["txs"],
              tys=p["tys"], nty=p["nty"])
    n6 = pg.pg_degrid.launches
    out = pg.pg_degrid(gr, gi, p["pos"], p["tid"], **kw)
    torch.cuda.synchronize()
    assert pg.pg_degrid.launches == n6 + 1
    assert _ok(out, pg.pg_degrid_plain(gr, gi, p["pos"], p["tid"], **kw))


def test_pg_kernel_reruns_bitwise_equal(cuda):
    """K4, K5 and K6 sum in a fixed order (no atomics): reruns give the
    same bits."""
    p = _pg_plan(cuda, 1024, 1e-5, True, seed=2)
    g = torch.Generator(device=cuda).manual_seed(2)
    vis = (torch.randn((p["nentries"], 2, p["C"]), generator=g,
                       device=cuda) * p["pm"][:, None]).contiguous()
    runs = [_spread_fold(p, vis, kernel=True) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    gr, gi = runs[0][1][:p["nw"]], runs[0][1][p["nw"]:]
    kw = dict(beta=p["beta"], k=p["k"], nw=p["nw"], txs=p["txs"],
              tys=p["tys"], nty=p["nty"])
    a = pg.pg_degrid(gr, gi, p["pos"], p["tid"], **kw)
    b = pg.pg_degrid(gr, gi, p["pos"], p["tid"], **kw)
    assert torch.equal(a, b)


def test_pg_operator_f32_card_matches_f64_cpu(cuda):
    """vis2dirty_pg / dirty2vis_pg through the kernels (float32, card)
    against the plain versions in float64 on the CPU: 1e-5."""
    obs = simulate_obs(nant=16, ntime=24, nchan=4, seed=9)
    _, cell = image_size_for(obs, fov_deg=1.0)
    rng = np.random.default_rng(9)
    shape = (obs.uvw.shape[0], obs.freq.size)
    vis = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    img = rng.normal(size=(256, 256))
    kw = dict(nx=256, ny=256, cellx=cell, celly=cell, epsilon=1e-5)
    ref = pg.vis2dirty_pg(obs.uvw, obs.freq, torch.as_tensor(vis), **kw)
    got = pg.vis2dirty_pg(obs.uvw, obs.freq,
                          torch.as_tensor(vis.astype(np.complex64)).to(cuda),
                          **kw)
    assert _ok(got.cpu().double(), ref)
    dkw = dict(epsilon=1e-5)
    ref = pg.dirty2vis_pg(obs.uvw, obs.freq, torch.as_tensor(img), cell,
                          cell, **dkw)
    got = pg.dirty2vis_pg(obs.uvw, obs.freq,
                          torch.as_tensor(img, dtype=torch.float32).to(cuda),
                          cell, cell, **dkw)
    assert _ok(got.cpu().to(torch.complex128), ref)


def test_pg_wrappers_reject_bad_operands(cuda):
    p = _pg_plan(cuda, 512, 1e-5, True)
    k, nw, txs, tys = p["k"], p["nw"], p["txs"], p["tys"]
    slots = pg._compact_slots(p["tid"], p["pm"], p["ntx"], p["nty"], txs,
                              tys, k)
    kw = dict(beta=p["beta"], k=k, nw=nw, Thx=txs + k, Thy=tys + k)
    vis = torch.zeros((p["nentries"], 2, p["C"]), device=cuda)
    with pytest.raises(ValueError):
        pg.pg_spread(p["pos"].double(), vis.double(), slots, **kw)
    with pytest.raises(ValueError):
        pg.pg_spread(p["pos"], vis[:, :1], slots, **kw)
    Y = torch.zeros((2 * nw, slots["NS"], txs + k, tys + k), device=cuda)
    with pytest.raises(ValueError):
        pg.pg_fold(Y, dict(slots, tslot=slots["tslot"].long()),
                   ntx=p["ntx"], nty=p["nty"], txs=txs, tys=tys, k=k,
                   Nx=p["Nx"], Ny=p["Ny"])
    g = torch.zeros((nw, p["Nx"], p["Ny"]), device=cuda)
    dkw = dict(beta=p["beta"], k=k, nw=nw, txs=txs, tys=tys, nty=p["nty"])
    with pytest.raises(ValueError):
        pg.pg_degrid(g, g[:, :, :-1], p["pos"], p["tid"], **dkw)
    with pytest.raises(ValueError):
        pg.pg_degrid(g, g, p["pos"], p["tid"].long(), **dkw)


def _gs_plan(cuda, nx, eps, tiles=(None, None), seed=0):
    """A float32 w-blocked plan on the card (plane_block 2)."""
    obs = simulate_obs(nant=16, ntime=24, nchan=4, seed=seed)
    _, cell = image_size_for(obs, fov_deg=1.0)
    return pgs.pgrid_plan_wblocked(obs.uvw, obs.freq, nx=nx, ny=nx,
                                   cellx=cell, celly=cell, epsilon=eps,
                                   plane_block=2, tile_u=tiles[0],
                                   tile_v=tiles[1], dtype=torch.float32,
                                   device=cuda)


def _gs_block(bp, b, vis, acc, kernel):
    """K7, K8 and K9 chained (or their plain versions) on block b: the
    spread's slots with entries, the fold of the spread and the
    accumulator after the degrid of those grids. (The kernels' fold reads
    only the slots with entries, which their spread writes.)"""
    p0 = bp["p0"]
    k, B, NT = p0["k"], bp["B"], bp["NT"]
    txs, tys = p0["txs"], p0["tys"]
    ne = int(bp["nelive"][b])
    gmap, woff = bp["gmap"][b, :ne], int(bp["woff"][b, 0])
    st, ct = bp["start"][b], bp["count"][b]
    kw = dict(woff=woff, beta=p0["beta"], k=k, B=B, Thx=txs + k,
              Thy=tys + k)
    spread = pgs.pg_spread_gs if kernel else pgs.pg_spread_gs_plain
    Y = spread(bp["pos"], vis, gmap, st, ct, **kw)
    Yf = Y.reshape(2 * B, NT, txs + k, tys + k)
    fkw = dict(nty=p0["nty"], txs=txs, tys=tys, k=k, Nx=p0["Nx"],
               Ny=p0["Ny"])
    if kernel:
        G = pgs.pg_fold_gs(Yf, bp["tslot"][b], ntx=p0["ntx"], **fkw)
    else:
        G = pgs.pg_fold_gs_plain(Yf, bp["tslot"][b], **fkw)
    degrid = pgs.pg_degrid_gs if kernel else pgs.pg_degrid_gs_plain
    acc = degrid(G[:B].contiguous(), G[B:].contiguous(), bp["pos"],
                 bp["utid"], gmap, acc.clone(), woff=woff, beta=p0["beta"],
                 k=k, B=B, txs=txs, tys=tys, nty=p0["nty"])
    return Y[:, :, ct > 0], G, acc


# (nx, epsilon, tiles): k = 7 and 9, default and auto-ladder tiles, an
# 8192-point grid
GS_CASES = [(512, 1e-5, (None, None)), (512, 1e-7, (None, None)),
            (1024, 1e-5, (57, 249)), (4096, 1e-5, (None, None))]


@pytest.mark.parametrize("nx,eps,tiles", GS_CASES)
def test_pg_gs_kernels_match_plain(cuda, nx, eps, tiles):
    """K7, K8 and K9 against their plain versions on every live block."""
    bp = _gs_plan(cuda, nx, eps, tiles, seed=nx)
    assert bp["nblocks"] > 1
    g = torch.Generator(device=cuda).manual_seed(nx)
    vis = (torch.randn((bp["NEg"] + 1, 2, bp["p0"]["C"]), generator=g,
                       device=cuda) * bp["gpm"][:, None]).contiguous()
    acc = torch.randn(vis.shape, generator=g, device=cuda)
    for b in range(bp["nblocks"]):
        if not bp["blive"][b]:
            continue
        n = [f.launches for f in (pgs.pg_spread_gs, pgs.pg_fold_gs,
                                  pgs.pg_degrid_gs)]
        got = _gs_block(bp, b, vis, acc, kernel=True)
        torch.cuda.synchronize()
        assert [f.launches for f in (pgs.pg_spread_gs, pgs.pg_fold_gs,
                                     pgs.pg_degrid_gs)] == [x + 1 for x in n]
        ref = _gs_block(bp, b, vis, acc, kernel=False)
        for a, r in zip(got, ref):
            assert _ok(a, r)


def test_pg_gs_kernel_reruns_bitwise_equal(cuda):
    """K7, K8 and K9 sum in a fixed order (no atomics)."""
    bp = _gs_plan(cuda, 1024, 1e-5, seed=3)
    g = torch.Generator(device=cuda).manual_seed(3)
    vis = (torch.randn((bp["NEg"] + 1, 2, bp["p0"]["C"]), generator=g,
                       device=cuda) * bp["gpm"][:, None]).contiguous()
    acc = torch.zeros_like(vis)
    b = int(bp["nelive"].argmax())
    runs = [_gs_block(bp, b, vis, acc, kernel=True) for _ in range(2)]
    for a, r in zip(*runs):
        assert torch.equal(a, r)


def test_pg_wblocked_hessian_f32_card_matches_f64_cpu(cuda):
    """The blocked Hessian through K7-K9 and K3 (float32, card) against
    its plain versions in float64 on the CPU: 1e-5."""
    obs = simulate_obs(nant=16, ntime=24, nchan=4, seed=9)
    _, cell = image_size_for(obs, fov_deg=1.0)
    img = np.random.default_rng(9).normal(size=(256, 256))
    kw = dict(nx=256, ny=256, cellx=cell, celly=cell, epsilon=1e-5,
              plane_block=2)
    ref = pgs.make_hessian_pg_wblocked(pgs.pgrid_plan_wblocked(
        obs.uvw, obs.freq, device="cpu", **kw))(torch.as_tensor(img))
    bp = pgs.pgrid_plan_wblocked(obs.uvw, obs.freq, device=cuda, **kw)
    assert bp["nblocks"] > 1
    got = pgs.make_hessian_pg_wblocked(bp)(
        torch.as_tensor(img, dtype=torch.float32).to(cuda))
    assert _ok(got.cpu().double(), ref)


def test_pg_gs_wrappers_reject_bad_operands(cuda):
    bp = _gs_plan(cuda, 512, 1e-5)
    p0 = bp["p0"]
    k, B = p0["k"], bp["B"]
    txs, tys = p0["txs"], p0["tys"]
    gmap = bp["gmap"][0, :int(bp["nelive"][0])]
    st, ct = bp["start"][0], bp["count"][0]
    vis = torch.zeros((bp["NEg"] + 1, 2, p0["C"]), device=cuda)
    kw = dict(woff=0, beta=p0["beta"], k=k, B=B, Thx=txs + k, Thy=tys + k)
    with pytest.raises(ValueError):
        pgs.pg_spread_gs(bp["pos"].double(), vis.double(), gmap, st, ct,
                         **kw)
    with pytest.raises(ValueError):
        pgs.pg_spread_gs(bp["pos"], vis, gmap.long(), st, ct, **kw)
    with pytest.raises(ValueError):
        pgs.pg_spread_gs(bp["pos"], vis[:, :1], gmap, st, ct, **kw)
    Y = torch.zeros((2 * B, bp["NT"], txs + k, tys + k), device=cuda)
    fkw = dict(ntx=p0["ntx"], nty=p0["nty"], txs=txs, tys=tys, k=k,
               Nx=p0["Nx"], Ny=p0["Ny"])
    with pytest.raises(ValueError):
        pgs.pg_fold_gs(Y, bp["tslot"][0, :-1], **fkw)
    with pytest.raises(ValueError):
        pgs.pg_fold_gs(Y, bp["tslot"][0].long(), **fkw)
    grid = torch.zeros((B, p0["Nx"], p0["Ny"]), device=cuda)
    dkw = dict(woff=0, beta=p0["beta"], k=k, B=B, txs=txs, tys=tys,
               nty=p0["nty"])
    with pytest.raises(ValueError):
        pgs.pg_degrid_gs(grid, grid[:, :, :-1], bp["pos"], bp["utid"], gmap,
                         vis, **dkw)
    with pytest.raises(ValueError):
        pgs.pg_degrid_gs(grid, grid, bp["pos"], bp["utid"], gmap,
                         vis.double(), **dkw)


# (nb, nx, ny, NX, NY): psf = 2x, 3x and 1.5x the image, NX != NY, and
# nx > NX / 2
K11_CASES = [(2, 128, 128, 384, 384), (8, 256, 256, 384, 384),
             (1, 1024, 768, 1536, 1280), (2, 320, 200, 480, 256)]


@pytest.mark.parametrize("nb,nx,ny,NX,NY", K11_CASES)
def test_psf_full_kernel_matches_plain(cuda, nb, nx, ny, NX, NY):
    """K11 with a random non-Hermitian full H, and with the H of a random
    real PSF; reruns bitwise equal."""
    g = torch.Generator(device=cuda).manual_seed(nx + NX)
    x = torch.randn((nb, nx, ny), generator=g, device=cuda)
    hr = torch.randn((nb, NX, NY), generator=g, device=cuda)
    hi = torch.randn_like(hr)
    n0 = psf_convolve_full.launches
    out = psf_convolve_full(x, hr, hi)
    torch.cuda.synchronize()
    assert psf_convolve_full.launches == n0 + 1
    assert _ok(out, psf_convolve_full_plain(x, hr, hi))
    assert torch.equal(out, psf_convolve_full(x, hr, hi))
    hr, hi = prep_h_full(torch.randn((nb, NX, NY), generator=g,
                                     device=cuda), torch.float32)
    assert _ok(psf_convolve_full(x, hr, hi),
               psf_convolve_full_plain(x, hr, hi))
    assert _ok(psf_convolve_full(x, hr, None),
               psf_convolve_full_plain(x, hr, None))


@pytest.mark.parametrize("nb,nx", [(2, 128), (3, 1152), (8, 512)])
@pytest.mark.parametrize("complex_h", [False, True])
def test_psf_cg_kernel_matches_plain(cuda, nb, nx, complex_h):
    """K2: p, conv(p) and [p.conv(p), p.p] against the plain version;
    reruns bitwise equal (fixed-order float64 sums, no atomics)."""
    g = torch.Generator(device=cuda).manual_seed(nx + nb)
    psf = torch.randn((nb, 2 * nx, 2 * nx), generator=g, device=cuda)
    hr, hi = prep_h(psf, nx, nx, torch.float32, real_transfer=not complex_h)
    pp, r = (torch.randn((nb, nx, nx), generator=g, device=cuda)
             for _ in range(2))
    beta = torch.rand((nb, 1, 1), generator=g, device=cuda)
    n0 = psf_convolve_h_cg.launches
    got = psf_convolve_h_cg(pp, r, beta, hr, hi)
    torch.cuda.synchronize()
    assert psf_convolve_h_cg.launches == n0 + 1
    ref = psf_convolve_h_cg_plain(pp, r, beta, hr, hi)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        assert _ok(a, b)
    for a, b in zip(got, psf_convolve_h_cg(pp, r, beta, hr, hi)):
        assert torch.equal(a, b)


def test_cg_fused_on_card_matches_pcg_bands(cuda):
    """The CG-fused solver on K2 against pcg_bands on K1, 25 fixed
    iterations, per-band wsum and sigmainv: 1e-4 of max."""
    nb, nx = 4, 512
    xg = torch.arange(2 * nx, device=cuda) - nx
    rr = xg[:, None] ** 2 + xg[None, :] ** 2
    psf = torch.stack([0.4 * torch.exp(-0.5 * rr / (3.0 + b) ** 2)
                       for b in range(nb)]).float()
    psf[:, nx, nx] += 0.6
    ws = torch.linspace(1.0, 1.5, nb, device=cuda)[:, None, None]
    conv = make_psf_convolve_pallas(psf, nx, nx, sigmainv=1e-2, wsum=ws)
    model = torch.zeros((nb, nx, nx), device=cuda)
    model[:, nx // 3, nx // 2] = 1.0
    b = conv(model)
    x0 = torch.zeros_like(b)
    ref = pcg_bands(conv, b, x0=x0, tol=0.0, maxit=25)
    n0 = psf_convolve_h_cg.launches
    got = make_pcg_bands_fused(conv.apply, tol=0.0, maxit=25,
                               apply_cg=conv.apply_cg,
                               cg_scale=conv.cg_scale)(b, x0, conv.consts)
    assert psf_convolve_h_cg.launches == n0 + 25
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


def test_psf_full_and_cg_wrappers_reject_bad_operands(cuda):
    x = torch.zeros((1, 128, 128), device=cuda)
    h = torch.zeros((1, 384, 384), device=cuda)
    with pytest.raises(ValueError):
        psf_convolve_full(x.double(), h)
    with pytest.raises(ValueError):
        psf_convolve_full(x, h, h.double())
    hh = torch.zeros((1, 129, 256), device=cuda)
    beta = torch.zeros((1, 1, 1), device=cuda)
    with pytest.raises(ValueError):
        psf_convolve_h_cg(x, x.double(), beta, hh)
    with pytest.raises(ValueError):
        psf_convolve_h_cg(x, x, beta.double(), hh)


# ---------------------------------------------------------------------
# K10: K1's stages on space shards


def _k10_h(cuda, nb, nx, nspace, complex_h):
    x = torch.arange(2 * nx, device=cuda) - nx
    r2 = (x[:, None] ** 2 + x[None, :] ** 2).float()
    psf = torch.stack([0.4 * torch.exp(-0.5 * r2 / (2.0 + b) ** 2)
                       for b in range(nb)])
    psf[:, nx, nx] += 0.6
    psf[:, nx + 3, nx + 1] += 0.02
    return prep_h_space(psf, nx, nx, nspace, torch.float32,
                        real_transfer=not complex_h)


@pytest.mark.parametrize("nb,nx,nspace", [(2, 128, 1), (2, 256, 2),
                                          (4, 512, 4), (3, 1024, 4)])
@pytest.mark.parametrize("complex_h", [False, True])
def test_k10_stage_kernels_match_plain(cuda, nb, nx, nspace, complex_h):
    """Each stage on each shard of a space-sharded cube (rows padded to
    the shard count) against its plain version; pad rows zero."""
    hr, hi = _k10_h(cuda, nb, nx, nspace, complex_h)
    assert (hi is None) != complex_h
    NX = NY = 2 * nx
    rows = space_rows(nx, nspace)
    nyl, rl = nx // nspace, rows // nspace
    g = torch.Generator(device=cuda).manual_seed(nx + nspace)
    x = torch.randn((nb, nx, nyl), generator=g, device=cuda)
    n0 = [f.launches for f in (psf_stage_cols_fwd, psf_stage_rows,
                               psf_stage_cols_inv)]
    zr, zi = psf_stage_cols_fwd(x, NX, rows)
    pr, pi = psf_stage_cols_fwd_plain(x, NX, rows)
    assert _ok(zr, pr) and _ok(zi, pi)
    assert not zr[:, nx + 1:].any() and not zi[:, nx + 1:].any()
    h = [a[:, :rl].contiguous() for a in (hr, hi) if a is not None]
    z = [torch.randn((nb, rl, nx), generator=g, device=cuda)
         for _ in range(2)]
    wr, wi = psf_stage_rows(z[0], z[1], *h)
    qr, qi = psf_stage_rows_plain(z[0], z[1], h[0], h[1] if complex_h
                                  else None)
    assert _ok(wr, qr) and _ok(wi, qi)
    w = [torch.randn((nb, rows, nyl), generator=g, device=cuda)
         for _ in range(2)]
    out = psf_stage_cols_inv(w[0], w[1], nx, NX, NY)
    assert _ok(out, psf_stage_cols_inv_plain(w[0], w[1], nx, NX, NY))
    torch.cuda.synchronize()
    assert [f.launches for f in (psf_stage_cols_fwd, psf_stage_rows,
                                 psf_stage_cols_inv)] == [n + 1 for n in n0]


@pytest.mark.parametrize("nspace", [1, 2, 4])
@pytest.mark.parametrize("complex_h", [False, True])
def test_space_matvec_matches_k1(cuda, nspace, complex_h):
    """hessian_psf_space_dist(method="pallas") on a (2, nspace) virtual
    mesh of the card against K1 on the whole cube: within 1e-6 of max
    (each line goes through the same FFT code; the all-to-alls are
    copies), and reruns bitwise equal."""
    from pfb_tpu_torch.parallel.dist import hessian_psf_space_dist
    from pfb_tpu_torch.parallel.mesh import make_mesh
    nb, nx = 4, 512
    hr, hi = _k10_h(cuda, nb, nx, nspace, complex_h)
    g = torch.Generator(device=cuda).manual_seed(nspace)
    x = torch.randn((nb, nx, nx), generator=g, device=cuda)
    mesh = make_mesh(nband=2, nspace=nspace, devices=[cuda] * (2 * nspace))
    hs = (hr,) if hi is None else (hr, hi)
    f = hessian_psf_space_dist(mesh, method="pallas")
    a = f(x, *hs).gather()
    b = f(x, *hs).gather()
    assert torch.equal(a, b)
    ref = psf_convolve_h(x, hr[:, :nx + 1].contiguous(),
                         None if hi is None else hi[:, :nx + 1].contiguous())
    assert float((a - ref).abs().max()) <= 1e-6 * float(ref.abs().max())


def test_k10_wrappers_reject_bad_operands(cuda):
    x = torch.zeros((1, 128, 64), device=cuda)
    with pytest.raises(ValueError):
        psf_stage_cols_fwd(x, 256, 128)          # rows < NX/2 + 1
    with pytest.raises(ValueError):
        psf_stage_cols_fwd(x.double(), 256, 130)  # float64 on the card
    z = torch.zeros((1, 65, 128), device=cuda)
    with pytest.raises(ValueError):
        psf_stage_rows(z, z, torch.zeros((1, 64, 256), device=cuda))
    w = torch.zeros((1, 130, 64), device=cuda)
    with pytest.raises(ValueError):
        psf_stage_cols_inv(w[:, :, :32], w, 128, 256, 256)


# ---------------------------------------------------------------------
# K12-K15: ops/pallas_fft.py's single-band convolutions and v3 column
# transforms, at the CPU tests' shapes and at NX = 8192


@pytest.mark.parametrize("nx", [128, 256, 4096])
@pytest.mark.parametrize("complex_h", [False, True])
def test_k12_matches_plain(cuda, nx, complex_h):
    """psf_convolve_pallas_v3 (one band of K1) against its plain version,
    H from a random PSF (complex) or its even part (real)."""
    g = torch.Generator(device=cuda).manual_seed(nx + 12)
    x = torch.randn((nx, nx), generator=g, device=cuda)
    psf = torch.randn((1, 2 * nx, 2 * nx), generator=g, device=cuda)
    hr, hi = prep_h(psf, nx, nx, torch.float32, real_transfer=not complex_h)
    hi = None if hi is None else hi[0]
    n0 = pft.psf_convolve_pallas_v3.launches
    out = pft.psf_convolve_pallas_v3(x, hr[0], hi, nx, nx)
    torch.cuda.synchronize()
    assert pft.psf_convolve_pallas_v3.launches == n0 + 1
    assert _ok(out, pft.psf_convolve_pallas_v3_plain(x, hr[0], hi))


@pytest.mark.parametrize("nx", [64, 128, 4096])
@pytest.mark.parametrize("entry", ["psf_convolve_pallas_v2",
                                   "psf_convolve_pallas_opt"])
def test_k13_k14_match_plain_and_k12(cuda, nx, entry):
    """K13 / K14 (one band of K11, full complex H) against their plain
    version, and against K12 on the same PSF (both Re(ifft2(H X)))."""
    fn = getattr(pft, entry)
    g = torch.Generator(device=cuda).manual_seed(nx + 13)
    x = torch.randn((nx, nx), generator=g, device=cuda)
    psf = torch.randn((1, 2 * nx, 2 * nx), generator=g, device=cuda)
    Hr, Hi = prep_h_full(psf, torch.float32)
    n0 = fn.launches
    out = fn(x, Hr[0], Hi[0], nx, nx)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    assert _ok(out, pft.psf_convolve_pallas_v2_plain(x, Hr[0], Hi[0]))
    if pft.v3_supported(nx, nx):
        hr, hi = prep_h(psf, nx, nx, torch.float32, real_transfer=False)
        assert _ok(out, pft.psf_convolve_pallas_v3(x, hr[0], hi[0], nx, nx))


@pytest.mark.parametrize("nb,nx,L", [(2, 128, 128), (2, 256, 128),
                                     (1, 4096, 512)])
@pytest.mark.parametrize("spectrum", ["forward", "random"])
def test_k15_matches_plain(cuda, nb, nx, L, spectrum):
    """v3_cols_fwd / v3_cols_inv against their plain versions; the
    inverse on the forward's spectrum (the round trip gives x back) and
    on a random non-Hermitian (NXH, L) spectrum, where the mirror rule
    decides the answer."""
    g = torch.Generator(device=cuda).manual_seed(nx + L)
    NXH = pft.v3_rows(2 * nx)
    x = torch.randn((nb, nx, L), generator=g, device=cuda)
    n0 = (pft.v3_cols_fwd.launches, pft.v3_cols_inv.launches)
    zr, zi = pft.v3_cols_fwd(x, nx)
    pr, pi = pft.v3_cols_fwd_plain(x, nx)
    assert zr.shape == (nb, NXH, L)
    assert _ok(zr, pr) and _ok(zi, pi)
    if spectrum == "random":
        zr, zi = (torch.randn((nb, NXH, L), generator=g, device=cuda)
                  for _ in range(2))
    out = pft.v3_cols_inv(zr, zi, nx)
    torch.cuda.synchronize()
    assert (pft.v3_cols_fwd.launches, pft.v3_cols_inv.launches) == \
        (n0[0] + 1, n0[1] + 1)
    ref = pft.v3_cols_inv_plain(zr, zi, nx)
    assert _ok(out, ref)
    if spectrum == "forward":
        assert _ok(out, x)
    else:
        half = psf_stage_cols_inv_plain(zr, zi, nx, 2 * nx, 1)
        assert not _ok(half, ref)


@pytest.mark.parametrize("complex_h", [False, True])
def test_column_stages_default_keep_bitwise_k1(cuda, complex_h):
    """The column stages with the default keep, with keep = NX/2 + 1
    given, and chained through the rows stage, against K1: bitwise equal
    (the mirror rule writes the same rows at keep = NX/2 + 1), and K11
    reruns bitwise equal."""
    nb, nx = 2, 512
    NX = NY = 2 * nx
    hr, hi = _k10_h(cuda, nb, nx, 1, complex_h)
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn((nb, nx, nx), generator=g, device=cuda)
    z = psf_stage_cols_fwd(x, NX, nx + 1)
    assert all(torch.equal(a, b) for a, b in zip(
        z, psf_stage_cols_fwd(x, NX, nx + 1, keep=nx + 1)))
    w = psf_stage_rows(*z, hr, hi)
    out = psf_stage_cols_inv(*w, nx, NX, NY)
    assert torch.equal(out, psf_stage_cols_inv(*w, nx, NX, NY, keep=nx + 1))
    assert torch.equal(out, psf_convolve_h(x, hr, hi))
    Hr, Hi = prep_h_full(torch.randn((nb, NX, NY), generator=g,
                                     device=cuda), torch.float32)
    assert torch.equal(psf_convolve_full(x, Hr, Hi),
                       psf_convolve_full(x, Hr, Hi))


def test_k12_k15_wrappers_reject_bad_operands(cuda):
    x = torch.zeros((128, 128), device=cuda)
    h = torch.zeros((129, 256), device=cuda)
    with pytest.raises(ValueError):   # float64 on the card
        pft.psf_convolve_pallas_v3(x.double(), h.double(), None, 128, 128)
    H = torch.zeros((256, 256), device=cuda)
    with pytest.raises(ValueError):
        pft.psf_convolve_pallas_v2(x, H[:, :200], None, 128, 128)
    with pytest.raises(ValueError):   # rows other than NXH = 144
        pft.v3_cols_inv(h[None], h[None], 128)
    with pytest.raises(ValueError):   # keep above NX
        psf_stage_cols_fwd(x[None], 256, 300, keep=257)


# ---------------------------------------------------------------------
# the PSF column stages on the cluster route (csrc/psf_cols.cu)

# (nb, nx, NX, L, rows, keep) at every shape chip_smoke.py gives them: K1
# at (8, 2048^2), K1 and K12 at 4096^2, one K10 shard of the (2, 4) mesh,
# K11 at 3072^2 in 6144^2 and in 4608^2, K15's NXH rows at 8192, and K1
# at every short NX (256-1536, one block or clusters of _TINY_C) with a K10
# shard at 1024
COLS_CASES = [(8, 2048, 4096, 2048, 2049, None),
              (8, 4096, 8192, 4096, 4097, None),
              (4, 2048, 4096, 512, 2052, None),
              (8, 3072, 6144, 3072, 3073, None),
              (2, 3072, 4608, 3072, 2305, None),
              (8, 4096, 8192, 4096, 4224, 4224),
              (8, 1024, 2048, 1024, 1025, None),
              (4, 1024, 2048, 256, 1028, None),
              (8, 1280, 2560, 1280, 1281, None),
              (8, 1536, 3072, 1536, 1537, None),
              (2, 1024, 2048, 1024, 1088, 1088),
              (8, 128, 256, 128, 129, None),
              (8, 256, 512, 256, 257, None),
              (8, 384, 768, 384, 385, None),
              (8, 512, 1024, 512, 513, None),
              (4, 512, 1024, 128, 516, None),
              (8, 640, 1280, 640, 641, None),
              (8, 768, 1536, 768, 769, None)]


def test_cols_route_matches_its_mirror(cuda):
    """The C++ predicate that decides (pfbt_psf_cols_route) against
    ops/psf.py:cols_route and ops/cfft.py:cluster_shape, on every even NX
    from 2 to 16400 and L = 1, 2, 8."""
    from pfb_tpu_torch import kernels
    lib = kernels.library()
    bad = []
    for NX in range(2, 16404, 2):
        for L in (1, 2, 8):
            want = cf.cluster_shape(NX)[0] if psf_mod.cols_route(NX, L) \
                else 0
            if lib.pfbt_psf_cols_route(NX, L) != want:
                bad.append((NX, L))
    assert not bad


@pytest.mark.parametrize("nb,nx,NX,L,rows,keep", COLS_CASES)
def test_cols_kernels_match_plain(cuda, nb, nx, NX, L, rows, keep):
    """The forward and the inverse kernel against the functions' plain
    versions (rfft / irfft, or fft / ifft with the mirror at keep = NXH,
    on a random non-Hermitian spectrum), each counting one launch; the
    pad rows zero."""
    g = torch.Generator(device=cuda).manual_seed(nx + L + rows)
    x = torch.randn((nb, nx, L), generator=g, device=cuda)
    k = keep or NX // 2 + 1
    pr, pi = psf_stage_cols_fwd_plain(x, NX, rows, keep)
    n0 = psf_mod.psf_cols_fwd.launches
    zr, zi = psf_mod.psf_cols_fwd(x, NX, rows, keep)
    torch.cuda.synchronize()
    assert psf_mod.psf_cols_fwd.launches == n0 + 1
    assert _ok(zr, pr) and _ok(zi, pi)
    assert not zr[:, k:].any() and not zi[:, k:].any()
    del pr, pi, zr, zi
    w = [torch.randn((nb, rows, L), generator=g, device=cuda)
         for _ in range(2)]
    n0 = psf_mod.psf_cols_inv.launches
    out = psf_mod.psf_cols_inv(w[0], w[1], nx, NX, keep, scale=1.0 / NX)
    torch.cuda.synchronize()
    assert psf_mod.psf_cols_inv.launches == n0 + 1
    assert _ok(out, psf_stage_cols_inv_plain(w[0], w[1], nx, NX, 1, keep))


@pytest.mark.parametrize("NX,L", [(4096, 13), (8192, 6), (6144, 3),
                                  (2048, 13), (3072, 5), (256, 37),
                                  (512, 13), (1536, 5)])
def test_cols_kernels_unaligned_and_ragged(cuda, NX, L):
    """Column counts that are not a multiple of the tile or of 4, an odd
    last pair, and operands 4 bytes past a 16-byte boundary (the scalar
    loads and stores) against the plain versions."""
    nx = NX // 2
    g = torch.Generator(device=cuda).manual_seed(NX + L)

    def shifted(*shape):
        n = int(np.prod(shape))
        t = torch.randn(n + 1, generator=g, device=cuda)[1:].view(shape)
        assert t.is_contiguous() and t.data_ptr() % 16
        return t
    x = shifted(2, nx, L)
    zr, zi = psf_mod.psf_cols_fwd(x, NX, nx + 3)
    pr, pi = psf_stage_cols_fwd_plain(x, NX, nx + 3)
    assert _ok(zr, pr) and _ok(zi, pi)
    wr, wi = shifted(2, nx + 3, L), shifted(2, nx + 3, L)
    out = psf_mod.psf_cols_inv(wr, wi, nx, NX)
    assert _ok(out, psf_stage_cols_inv_plain(wr, wi, nx, NX, 1) * NX)


@pytest.mark.parametrize("NX,L,keep", [(4096, 512, None), (8192, 16, 4224),
                                       (1024, 40, None), (256, 64, 160)])
def test_cols_skeletons_equal_their_plain_permutations(cuda, NX, L, keep):
    """The lab's skeletons (loads, exchange, separation or Hermitian part,
    stores; no FFT) equal the plain versions' index algebra run on the
    card in float32, bit for bit."""
    nx = NX // 2
    k = keep or NX // 2 + 1
    g = torch.Generator(device=cuda).manual_seed(NX)
    x = torch.randn((2, nx, L), generator=g, device=cuda)
    C = cf.cluster_shape(NX)[0]
    got = psf_mod.psf_cols_fwd(x, NX, k + 2, keep, skeleton=True)
    ref = psf_mod.psf_cols_fwd_plain(x, NX, k + 2, keep, C=C, fft=False)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    w = [torch.randn((2, k + 2, L), generator=g, device=cuda)
         for _ in range(2)]
    got = psf_mod.psf_cols_inv(*w, nx, NX, keep, scale=0.5, skeleton=True)
    ref = psf_mod.psf_cols_inv_plain(*w, nx, NX, keep, C=C, scale=0.5,
                                     fft=False)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("complex_h", [False, True])
def test_cluster_column_stages_bitwise_k1(cuda, complex_h):
    """At nx = 2048 (NX = 4096, the cluster route): K10's stages chained
    on the whole cube and on four column shards of 512 (the padded row
    stride of four space shards) equal K1 bit for bit, and K1 launches
    each cluster kernel once, a cube below the route (NX = 128) none."""
    nb, nx = 2, 2048
    NX = NY = 2 * nx
    hr, hi = _k10_h(cuda, nb, nx, 4, complex_h)
    h1 = [a[:, :nx + 1].contiguous() for a in (hr, hi) if a is not None]
    g = torch.Generator(device=cuda).manual_seed(10)
    x = torch.randn((nb, nx, nx), generator=g, device=cuda)
    n0 = (psf_mod.psf_cols_fwd.launches, psf_mod.psf_cols_inv.launches)
    ref = psf_convolve_h(x, *h1)
    torch.cuda.synchronize()
    assert (psf_mod.psf_cols_fwd.launches, psf_mod.psf_cols_inv.launches) \
        == (n0[0] + 1, n0[1] + 1)
    assert _ok(ref, psf_convolve_h_plain(x, h1[0], h1[1] if complex_h
                                         else None))
    rows = space_rows(nx, 4)
    z = [psf_stage_cols_fwd(x[..., q * 512:(q + 1) * 512].contiguous(), NX,
                            rows) for q in range(4)]
    zr, zi = (torch.cat([a[i] for a in z], dim=-1) for i in (0, 1))
    wr, wi = psf_stage_rows(zr, zi, *[a.contiguous() for a in
                                      (hr, hi) if a is not None])
    out = torch.cat([psf_stage_cols_inv(wr[..., q * 512:(q + 1) * 512]
                                        .contiguous(),
                                        wi[..., q * 512:(q + 1) * 512]
                                        .contiguous(), nx, NX, NY)
                     for q in range(4)], dim=-1)
    assert torch.equal(out, ref)
    small = torch.randn((nb, 64, 64), generator=g, device=cuda)
    n1 = (psf_mod.psf_cols_fwd.launches, psf_mod.psf_cols_inv.launches)
    hs = _k10_h(cuda, nb, 64, 1, True)
    psf_convolve_h(small, hs[0][:, :65].contiguous(),
                   hs[1][:, :65].contiguous())
    assert (psf_mod.psf_cols_fwd.launches,
            psf_mod.psf_cols_inv.launches) == n1


@pytest.mark.parametrize("nspace", [2, 4])
def test_space_matvec_bitwise_k1_on_the_cluster_route(cuda, nspace):
    """hessian_psf_space_dist(method="pallas") on a (2, nspace) virtual
    mesh at (4, 2048^2), where K10's and K1's column stages take the
    cluster kernels: bit for bit K1 (chip_smoke.py's gate)."""
    from pfb_tpu_torch.parallel.dist import hessian_psf_space_dist
    from pfb_tpu_torch.parallel.mesh import make_mesh
    nb, nx = 4, 2048
    hr, hi = _k10_h(cuda, nb, nx, nspace, True)
    g = torch.Generator(device=cuda).manual_seed(nspace + 20)
    x = torch.randn((nb, nx, nx), generator=g, device=cuda)
    mesh = make_mesh(nband=2, nspace=nspace, devices=[cuda] * (2 * nspace))
    f = hessian_psf_space_dist(mesh, method="pallas")
    n0 = psf_mod.psf_cols_fwd.launches
    a = f(x, hr, hi).gather()
    assert psf_mod.psf_cols_fwd.launches > n0
    ref = psf_convolve_h(x, hr[:, :nx + 1].contiguous(),
                         hi[:, :nx + 1].contiguous())
    assert torch.equal(a, ref)


def test_space_matvec_bitwise_k1_at_1024(cuda):
    """The same at (4, 1024^2) on a (2, 4) virtual mesh (v3_space_supported
    holds: 256 columns a shard), where K10's and K1's stages take the
    cluster column kernels at NX = 2048 and K10br at NY = 2048: bit for
    bit K1, and no PSF line kernel launches."""
    from pfb_tpu_torch.parallel.dist import hessian_psf_space_dist
    from pfb_tpu_torch.parallel.mesh import make_mesh
    nb, nx, nspace = 4, 1024, 4
    assert psf_mod.v3_space_supported(nx, nx, nspace)
    hr, hi = _k10_h(cuda, nb, nx, nspace, True)
    g = torch.Generator(device=cuda).manual_seed(24)
    x = torch.randn((nb, nx, nx), generator=g, device=cuda)
    mesh = make_mesh(nband=2, nspace=nspace, devices=[cuda] * (2 * nspace))
    f = hessian_psf_space_dist(mesh, method="pallas")
    n0 = (psf_mod.psf_cols_fwd.launches, psf_mod.psf_rows.launches,
          psf_mod.psf_cols_line.launches, psf_mod.psf_rows_line.launches)
    a = f(x, hr, hi).gather()
    got = [c.launches - n for c, n in zip(
        (psf_mod.psf_cols_fwd, psf_mod.psf_rows, psf_mod.psf_cols_line,
         psf_mod.psf_rows_line), n0)]
    assert got[0] > 0 and got[1] > 0 and got[2:] == [0, 0]
    ref = psf_convolve_h(x, hr[:, :nx + 1].contiguous(),
                         hi[:, :nx + 1].contiguous())
    assert torch.equal(a, ref)


def test_space_matvec_bitwise_k1_at_512(cuda):
    """The same at (4, 512^2) on a (2, 4) virtual mesh (128 columns a
    shard), where K10's and K1's column stages take the cluster kernels
    at NX = 1024 on one block a tile (C = 1) and the rows stages K10br
    at NY = 1024 (R2 = 4, four rows a block, a shard's rows in other
    slots of a block than K1's): bit for bit K1, and no PSF line kernel
    launches."""
    from pfb_tpu_torch.parallel.dist import hessian_psf_space_dist
    from pfb_tpu_torch.parallel.mesh import make_mesh
    nb, nx, nspace = 4, 512, 4
    assert psf_mod.v3_space_supported(nx, nx, nspace)
    hr, hi = _k10_h(cuda, nb, nx, nspace, True)
    g = torch.Generator(device=cuda).manual_seed(25)
    x = torch.randn((nb, nx, nx), generator=g, device=cuda)
    mesh = make_mesh(nband=2, nspace=nspace, devices=[cuda] * (2 * nspace))
    f = hessian_psf_space_dist(mesh, method="pallas")
    n0 = (psf_mod.psf_cols_fwd.launches, psf_mod.psf_rows.launches,
          psf_mod.psf_cols_line.launches, psf_mod.psf_rows_line.launches)
    a = f(x, hr, hi).gather()
    got = [c.launches - n for c, n in zip(
        (psf_mod.psf_cols_fwd, psf_mod.psf_rows, psf_mod.psf_cols_line,
         psf_mod.psf_rows_line), n0)]
    assert got[0] > 0 and got[1] > 0 and got[2:] == [0, 0]
    ref = psf_convolve_h(x, hr[:, :nx + 1].contiguous(),
                         hi[:, :nx + 1].contiguous())
    assert torch.equal(a, ref)


@pytest.mark.parametrize("complex_h", [False, True])
def test_k2_conv_bitwise_k1_at_512(cuda, complex_h):
    """K2 at (8, 512^2) of 1024 (chip_smoke.py phase 33's shape): its
    column stages on the cluster kernels (one block a tile at NX = 1024),
    its rows stage on K10br, conv(p) bit for bit K1's of its own p, p and
    pap against the plain version, reruns bit for bit; no PSF line kernel
    launches."""
    nb, nx = 8, 512
    g = torch.Generator(device=cuda).manual_seed(512 + complex_h)
    psf = torch.randn((nb, 2 * nx, 2 * nx), generator=g, device=cuda)
    hr, hi = prep_h(psf, nx, nx, torch.float32, real_transfer=not complex_h)
    del psf
    pp, r = (torch.randn((nb, nx, nx), generator=g, device=cuda)
             for _ in range(2))
    beta = torch.rand((nb, 1, 1), generator=g, device=cuda)
    counters = (psf_mod.psf_cols_fwd, psf_mod.psf_cols_inv, psf_mod.psf_rows,
                psf_mod.psf_cols_line, psf_mod.psf_rows_line)
    n0 = [c.launches for c in counters]
    got = psf_convolve_h_cg(pp, r, beta, hr, hi)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, n0)] == [1, 1, 1, 0, 0]
    for a, b in zip(got, psf_convolve_h_cg_plain(pp, r, beta, hr, hi)):
        assert _ok(a, b)
    assert torch.equal(got[1], psf_convolve_h(got[0], hr, hi))
    for a, b in zip(got, psf_convolve_h_cg(pp, r, beta, hr, hi)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("nx", [1024, 1280, 1536, 512, 128, 256, 384, 640,
                                768])
def test_psf_entries_take_the_new_routes(cuda, nx):
    """K1, K2 and K11 at (2, nx^2) in (2 nx)^2: at NX = NY = 256-3072
    every column stage launches the cluster kernels and every rows stage
    K10br, and no PSF line kernel launches (psf_cols_line,
    psf_rows_line). Each against its plain version."""
    g = torch.Generator(device=cuda).manual_seed(nx)
    x = torch.randn((2, nx, nx), generator=g, device=cuda)
    psf = torch.randn((2, 2 * nx, 2 * nx), generator=g, device=cuda)
    hr, hi = prep_h(psf, nx, nx, torch.float32, real_transfer=False)
    Hr, Hi = prep_h_full(psf, torch.float32)
    beta = torch.full((2, 1, 1), 0.5, device=cuda)
    on = True
    assert psf_mod.cols_route(2 * nx, nx) == on
    assert psf_mod.rows_route(2 * nx) == on
    calls = [(lambda: psf_convolve_h(x, hr, hi),
              lambda: psf_convolve_h_plain(x, hr, hi)),
             (lambda: psf_convolve_h_cg(x, x, beta, hr, hi)[1],
              lambda: psf_convolve_h_cg_plain(x, x, beta, hr, hi)[1]),
             (lambda: psf_convolve_full(x, Hr, Hi),
              lambda: psf_convolve_full_plain(x, Hr, Hi))]
    counters = (psf_mod.psf_cols_fwd, psf_mod.psf_cols_inv,
                psf_mod.psf_rows, psf_mod.psf_cols_line,
                psf_mod.psf_rows_line)
    for fn, plain in calls:
        n0 = [c.launches for c in counters]
        out = fn()
        torch.cuda.synchronize()
        got = [c.launches - n for c, n in zip(counters, n0)]
        assert got == ([1, 1, 1, 0, 0] if on else [0, 0, 0, 2, 1])
        assert _ok(out, plain())


@pytest.mark.parametrize("NX", [2048, 2560, 3072, 512, 1024, 1536])
def test_cluster_kernels_take_only_the_routes_clusters(cuda, NX):
    """Below 4096, K3c (fftx_c2c_cluster) and the PSF column kernels
    (psf_cols_fwd / _inv) on the route's clusters (4 from 2048, one block
    or _TINY_C below) against their plain versions; the column entry refuses
    another C (2, or 4 where the route's is 2) and the wrappers refuse NX
    = 128, below the 256 floor, on the same 40 columns, launching
    nothing."""
    from pfb_tpu_torch import kernels
    g = torch.Generator(device=cuda).manual_seed(NX + 2)
    nx, L = NX // 2, 40
    x = torch.randn((2, nx, L), generator=g, device=cuda)
    xr, xi = (torch.randn((2, NX, L), generator=g, device=cuda)
              for _ in range(2))
    w = [torch.randn((2, nx + 1, L), generator=g, device=cuda)
         for _ in range(2)]
    C = cf.cluster_shape(NX)[0]
    assert C == (4 if NX >= 2048 else 1 if NX == 1024 else cf._TINY_C)
    yr, yi = cf.fftx_c2c_cluster(xr, xi, N=NX, inverse=True)
    pr, pi = fftx_c2c_plain(xr, xi, N=NX, inverse=True)
    assert _ok(yr, pr) and _ok(yi, pi)
    zr, zi = psf_mod.psf_cols_fwd(x, NX, nx + 1)
    pr, pi = psf_stage_cols_fwd_plain(x, NX, nx + 1)
    assert _ok(zr, pr) and _ok(zi, pi)
    out = psf_mod.psf_cols_inv(*w, nx, NX, scale=1.0 / NX)
    assert _ok(out, psf_stage_cols_inv_plain(*w, nx, NX, 1))
    _, _, TM, TN = psf_mod._cols_tables(NX, L, cuda)
    code = kernels.library().pfbt_psf_cols_fwd(
        x.data_ptr(), zr.data_ptr(), zi.data_ptr(), 2, nx, L, NX, nx + 1,
        nx + 1, 2 if C != 2 else 4, 0, TM, TN, kernels.stream_ptr())
    assert code != 0
    n0 = (psf_mod.psf_cols_fwd.launches, psf_mod.psf_cols_inv.launches)
    with pytest.raises(ValueError):
        psf_mod.psf_cols_fwd(x[:, :64], 128, 65)
    with pytest.raises(ValueError):
        psf_mod.psf_cols_inv(*(a[:, :65] for a in w), 64, 128)
    assert (psf_mod.psf_cols_fwd.launches,
            psf_mod.psf_cols_inv.launches) == n0


@pytest.mark.parametrize("NX", [512, 1536])
def test_psf_line_lab_matches_plain(cuda, NX):
    """The lab's PSF line kernels (psf_line_lab: line_fft_kernel's column
    stages and psf_rows_kernel, at lengths now on the routes) against the
    K10 stages' plain versions, counting their own launches and none of
    the paths' counters."""
    nx = NX // 2
    g = torch.Generator(device=cuda).manual_seed(NX + 5)
    x = torch.randn((2, nx, 40), generator=g, device=cuda)
    w = [torch.randn((2, nx + 1, 40), generator=g, device=cuda)
         for _ in range(2)]
    hr, hi = (torch.randn((2 * (nx + 1), NX), generator=g, device=cuda)
              for _ in range(2))
    z = [torch.randn((2 * (nx + 1), nx), generator=g, device=cuda)
         for _ in range(2)]
    paths = (psf_mod.psf_cols_fwd, psf_mod.psf_cols_inv, psf_mod.psf_rows,
             psf_mod.psf_cols_line, psf_mod.psf_rows_line)
    n0 = [c.launches for c in paths] + [psf_mod.psf_line_lab.launches]
    got = psf_mod.psf_line_lab(1, x, NX=NX, rows=nx + 1)
    ref = psf_stage_cols_fwd_plain(x, NX, nx + 1)
    assert all(_ok(a, b) for a, b in zip(got, ref))
    got = psf_mod.psf_line_lab(3, *w, NX=NX, nx=nx, NY=NX)
    assert _ok(got, psf_stage_cols_inv_plain(*w, nx, NX, NX))
    got = psf_mod.psf_line_lab(2, *z, NX=NX, hr=hr, hi=hi)
    ref = psf_stage_rows_plain(*z, hr, hi)
    assert all(_ok(a, b) for a, b in zip(got, ref))
    torch.cuda.synchronize()
    n1 = [c.launches for c in paths] + [psf_mod.psf_line_lab.launches]
    assert n1 == n0[:-1] + [n0[-1] + 3]


def test_cols_wrappers_reject_bad_operands(cuda):
    x = torch.zeros((1, 2048, 8), device=cuda)
    with pytest.raises(ValueError):   # NX below the route
        psf_mod.psf_cols_fwd(x[:, :64], 128, 65)
    with pytest.raises(ValueError):   # float64 on the card
        psf_mod.psf_cols_fwd(x.double(), 4096, 2049)
    with pytest.raises(ValueError):   # rows below keep
        psf_mod.psf_cols_fwd(x, 4096, 2048)
    w = torch.zeros((1, 2049, 8), device=cuda)
    with pytest.raises(ValueError):
        psf_mod.psf_cols_inv(w, w[..., :4], 2048, 4096)


# ---------------------------------------------------------------------
# the rows stage's register route (K10br, csrc/psf_rows.cu)


def test_rows_route_matches_its_mirror(cuda):
    """The C++ predicate that decides (pfbt_psf_rows_route) against
    ops/psf.py:rows_route on every even NY up to 16400; K3's row_route
    takes the same lengths."""
    from pfb_tpu_torch import kernels
    lib = kernels.library()
    bad = [NY for NY in range(2, 16402, 2)
           if lib.pfbt_psf_rows_route(NY) != int(psf_mod.rows_route(NY))
           or cf.row_route(NY, 1) != psf_mod.rows_route(NY)]
    assert not bad


def test_row_kernel_launches_exactly_on_its_route(cuda):
    """The row kernel's entry (pfbt_cfft_rows) launches at every length
    from 2 to 16384 where ops/cfft.py:row_route holds and refuses every
    other: its instances and the mirror agree."""
    from pfb_tpu_torch import kernels
    lib = kernels.library()
    buf = torch.zeros((4, 16384), device=cuda)
    table = kernels.twiddles(12288, cuda, kind="rows")
    bad = []
    for N in range(2, 16386, 2):
        T = kernels.twiddles(N, cuda, kind="rows") if cf.row_route(N, 1) \
            else table
        code = lib.pfbt_cfft_rows(buf[0].data_ptr(), buf[1].data_ptr(),
                                  buf[2].data_ptr(), buf[3].data_ptr(), 1,
                                  N, 0, 0, 0, 0, T.data_ptr(),
                                  kernels.stream_ptr())
        if (code == 0) != cf.row_route(N, 1):
            bad.append((N, code))
    torch.cuda.synchronize()
    assert not bad


def _rows_case(cuda, NY, ny, mode, R=37):
    """R rows of z and their H from a seed: (zr, zi, hr, hi, NX) with NX
    None, or (mode "full") the full (1, NX, NY) H with NX / 2 + 1 = R."""
    g = torch.Generator(device=cuda).manual_seed(NY + ny)
    z = [torch.randn((R, ny), generator=g, device=cuda) for _ in range(2)]
    if mode == "full":
        NX = 2 * (R - 1)
        h = [torch.randn((1, NX, NY), generator=g, device=cuda)
             for _ in range(2)]
        return z[0][None], z[1][None], h[0], h[1], NX
    h = [torch.randn((R, NY), generator=g, device=cuda) for _ in range(2)]
    return z[0], z[1], h[0], h[1] if mode == "complex" else None, None


@pytest.mark.parametrize("NY", ROW_LENGTHS)
@pytest.mark.parametrize("mode", ["real", "complex", "full"])
@pytest.mark.parametrize("half", ["<", "=", ">"])
def test_rows_kernel_matches_plain(cuda, NY, mode, half):
    """K10br on 37 rows at each length it is built for, real, complex and
    full (K11's Hermitian part) H, ny below, at and above NY / 2, against
    the plain stage (torch.fft) and its own staged decomposition; one
    launch counted."""
    ny = NY // 2 + {"<": -40, "=": 0, ">": min(300, NY // 2 - 8)}[half]
    zr, zi, hr, hi, NX = _rows_case(cuda, NY, ny, mode)
    n0 = psf_mod.psf_rows.launches
    wr, wi = psf_mod.psf_rows(zr, zi, hr, hi, NX)
    torch.cuda.synchronize()
    assert psf_mod.psf_rows.launches == n0 + 1
    h = (hr, hi) if NX is None else psf_mod.full_h_rows(hr, hi)
    qr, qi = psf_stage_rows_plain(zr, zi, *h)
    assert _ok(wr, qr) and _ok(wi, qi)
    mr, mi = psf_mod.psf_rows_plain(zr, zi, hr, hi, NX)
    assert _ok(wr, mr) and _ok(wi, mi)


@pytest.mark.parametrize("full", [False, True])
def test_rows_kernel_launches_in_chunks_past_2_31(cuda, full):
    """A rows stage whose H holds 2^31 elements or more runs as two
    launches (the kernel's offsets are 32-bit): 524,325 rows against H
    (R, 4096), or K11's 262,148 bands of a full (nb, 2, 4096) H, cut at
    whole bands; the rows on each side of the cut and the last ones match
    the plain stage."""
    NY, ny = 4096, 16
    per = 0x7FFFFFFF // NY             # H rows a launch can address
    g = torch.Generator(device=cuda).manual_seed(31)
    if full:
        NX, nb = 2, per // 2 + 5
        hr = torch.randn((nb, NX, NY), generator=g, device=cuda)
        zr, zi = (torch.randn((nb, 2, ny), generator=g, device=cuda)
                  for _ in range(2))
        idx = torch.tensor([0, per // 2 - 2, per // 2 - 1, per // 2,
                            per // 2 + 1, nb - 1], device=cuda)
    else:
        NX, R = None, per + 38
        hr = torch.randn((R, NY), generator=g, device=cuda)
        zr, zi = (torch.randn((R, ny), generator=g, device=cuda)
                  for _ in range(2))
        idx = torch.tensor([0, per - 2, per - 1, per, per + 1, R - 1],
                           device=cuda)
    n0 = psf_mod.psf_rows.launches
    wr, wi = psf_mod.psf_rows(zr, zi, hr, None, NX)
    torch.cuda.synchronize()
    assert psf_mod.psf_rows.launches == n0 + 2
    h = hr[idx]
    h = psf_mod.full_h_rows(h, None) if full else (h, None)
    qr, qi = psf_stage_rows_plain(zr[idx], zi[idx], *h)
    assert _ok(wr[idx], qr) and _ok(wi[idx], qi)


@pytest.mark.parametrize("complex_h", [False, True])
def test_rows_stage_shards_bitwise_k1(cuda, complex_h):
    """At NY = 4096 (the register route): K10 stage 2 on four row shards
    of K1's padded spectrum equals the stage on all rows, and K10's
    stages chained equal K1, bit for bit; K1 and each K10b call count one
    K10br launch, and the line kernel's rows stage (NY = 128) none."""
    nb, nx = 2, 2048
    NX = NY = 2 * nx
    hr, hi = _k10_h(cuda, nb, nx, 4, complex_h)
    hs = [a for a in (hr, hi) if a is not None]
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn((nb, nx, nx), generator=g, device=cuda)
    n0 = psf_mod.psf_rows.launches
    ref = psf_convolve_h(x, *[a[:, :nx + 1].contiguous() for a in hs])
    rows = space_rows(nx, 4)
    zr, zi = psf_stage_cols_fwd(x, NX, rows)
    wr, wi = psf_stage_rows(zr, zi, *hs)
    rl = rows // 4
    parts = [psf_stage_rows(zr[:, q * rl:(q + 1) * rl].contiguous(),
                            zi[:, q * rl:(q + 1) * rl].contiguous(),
                            *[a[:, q * rl:(q + 1) * rl].contiguous()
                              for a in hs]) for q in range(4)]
    torch.cuda.synchronize()
    assert psf_mod.psf_rows.launches == n0 + 6
    assert torch.equal(torch.cat([p[0] for p in parts], dim=1), wr)
    assert torch.equal(torch.cat([p[1] for p in parts], dim=1), wi)
    assert torch.equal(psf_stage_cols_inv(wr, wi, nx, NX, NY), ref)
    small = _k10_h(cuda, nb, 64, 1, True)
    n1 = psf_mod.psf_rows.launches
    psf_convolve_h(x[:, :64, :64].contiguous(),
                   *[a[:, :65].contiguous() for a in small])
    assert psf_mod.psf_rows.launches == n1


def test_rows_route_counts_from_every_entry(cuda):
    """K1, K2, K10b, K11 and K12-K14 at NY = 4096 each add one K10br
    launch, and match their plain versions."""
    nx = 2048
    g = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn((1, nx, nx), generator=g, device=cuda)
    psf = torch.randn((1, 2 * nx, 2 * nx), generator=g, device=cuda)
    hr, hi = prep_h(psf, nx, nx, torch.float32, real_transfer=False)
    Hr, Hi = prep_h_full(psf, torch.float32)
    beta = torch.full((1, 1, 1), 0.5, device=cuda)
    zr, zi = (torch.randn((1, nx + 1, nx), generator=g, device=cuda)
              for _ in range(2))
    calls = [
        (lambda: psf_convolve_h(x, hr, hi),
         lambda: psf_convolve_h_plain(x, hr, hi)),
        (lambda: psf_convolve_h_cg(x, x, beta, hr, hi)[1],
         lambda: psf_convolve_h_cg_plain(x, x, beta, hr, hi)[1]),
        (lambda: psf_stage_rows(zr, zi, hr, hi)[0],
         lambda: psf_stage_rows_plain(zr, zi, hr, hi)[0]),
        (lambda: psf_convolve_full(x, Hr, Hi),
         lambda: psf_convolve_full_plain(x, Hr, Hi)),
        (lambda: pft.psf_convolve_pallas_v3(x[0], hr[0], hi[0], nx, nx),
         lambda: pft.psf_convolve_pallas_v3_plain(x[0], hr[0], hi[0])),
        (lambda: pft.psf_convolve_pallas_v2(x[0], Hr[0], Hi[0], nx, nx),
         lambda: pft.psf_convolve_pallas_v2_plain(x[0], Hr[0], Hi[0])),
        (lambda: pft.psf_convolve_pallas_opt(x[0], Hr[0], Hi[0], nx, nx),
         lambda: pft.psf_convolve_pallas_opt_plain(x[0], Hr[0], Hi[0]))]
    for fn, plain in calls:
        n0 = psf_mod.psf_rows.launches
        out = fn()
        torch.cuda.synchronize()
        assert psf_mod.psf_rows.launches == n0 + 1
        assert _ok(out, plain())


def test_rows_wrapper_rejects_bad_operands(cuda):
    z = torch.zeros((3, 1024), device=cuda)
    with pytest.raises(ValueError):   # NY off the route (256 x 14)
        psf_mod.psf_rows(z, z, torch.zeros((3, 3584), device=cuda))
    with pytest.raises(ValueError):   # float64 on the card
        psf_mod.psf_rows(z.double(), z.double(),
                         torch.zeros((3, 4096), device=cuda).double())
    with pytest.raises(ValueError):   # rows of z and H differ
        psf_mod.psf_rows(z, z, torch.zeros((2, 4096), device=cuda))
    with pytest.raises(ValueError):   # full H: R != nb (NX/2 + 1)
        psf_mod.psf_rows(z, z, torch.zeros((1, 8, 4096), device=cuda),
                         NX=8)


# ---------------------------------------------------------------------
# the fold's tile-wise gather (K5, K8)


def _fold_case(cuda, Nx, Ny, txs, tys, k, nq, dead, seed):
    """Random slots Y (nq, NS, txs + k, tys + k) and a tile -> slot table
    with a share ``dead`` of the tiles dead, from a seed."""
    rng = np.random.default_rng(seed)
    ntx, nty = -(-Nx // txs), -(-Ny // tys)
    live = rng.random(ntx * nty) >= dead
    NS = int(live.sum()) + 2
    tslot = np.full(ntx * nty, -1, np.int32)
    tslot[live] = rng.permutation(NS)[:int(live.sum())]
    Y = torch.as_tensor(rng.normal(size=(nq, NS, txs + k, tys + k)),
                        dtype=torch.float32, device=cuda)
    return Y, torch.as_tensor(tslot, device=cuda), dict(
        ntx=ntx, nty=nty, txs=txs, tys=tys, k=k, Nx=Nx, Ny=Ny)


# (Nx, Ny, txs, tys, k, nq, dead share): the periodic wrap with ragged last
# tiles, Nx == Thx, odd and even k (k/2, tys and Ny multiples of 4 or 2,
# or not), dead tiles, an empty block, and the paths' tiles at 4096^2
FOLD_CASES = [(64, 64, 13, 13, 7, 5, 0.3), (64, 64, 12, 12, 8, 6, 0.5),
              (64, 60, 10, 10, 4, 5, 0.3), (16, 16, 10, 10, 6, 8, 0.0),
              (20, 48, 10, 12, 8, 1, 0.3), (48, 40, 9, 11, 5, 7, 0.5),
              (64, 64, 25, 25, 7, 8, 1.0), (4096, 4096, 25, 121, 7, 20, 0.92),
              (4096, 4096, 24, 124, 8, 8, 0.9)]


@pytest.mark.parametrize("Nx,Ny,txs,tys,k,nq,dead", FOLD_CASES)
def test_fold_kernel_matches_its_gather_model(cuda, Nx, Ny, txs, tys, k,
                                              nq, dead):
    """K8 (and K5 through its own entry) against the gather model
    (ops/pgridder.py:pg_fold_gather_plain: the same pieces summed in the
    same order, bit for bit) and the plain index_add_ fold (1e-5 of max);
    reruns bitwise equal; one launch counted each."""
    Y, tslot, kw = _fold_case(cuda, Nx, Ny, txs, tys, k, nq, dead,
                              seed=Nx + txs + k)
    n0 = (pg.pg_fold.launches, pgs.pg_fold_gs.launches)
    a = pgs.pg_fold_gs(Y, tslot, **kw)
    b = pgs.pg_fold_gs(Y, tslot, **kw)
    NS = Y.shape[1]
    live = torch.zeros(NS, dtype=torch.bool, device=cuda)
    tile = torch.zeros(NS, dtype=torch.long, device=cuda)
    inb = tslot >= 0
    live[tslot[inb].long()] = True
    tile[tslot[inb].long()] = torch.arange(tslot.numel(),
                                           device=cuda)[inb]
    c = pg.pg_fold(Y, dict(tslot=tslot, NS=NS, tile=tile, live=live), **kw)
    torch.cuda.synchronize()
    assert (pg.pg_fold.launches, pgs.pg_fold_gs.launches) == \
        (n0[0] + 1, n0[1] + 2)
    assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(a, pg.pg_fold_gather_plain(Y, tslot, **kw))
    ref = pgs.pg_fold_gs_plain(Y, tslot, **{
        key: kw[key] for key in ("nty", "txs", "tys", "k", "Nx", "Ny")})
    if dead < 1.0:
        assert _ok(a, ref)
    else:
        assert not a.any() and not ref.any()


def test_fold_refuses_tiles_that_miss_the_grid(cuda):
    """ntx txs < Nx leaves grid points that no footprint covers: the
    entry refuses (CUDA error 1), as it does a block larger than the
    grid."""
    Y, tslot, kw = _fold_case(cuda, 64, 64, 13, 13, 7, 2, 0.3, seed=1)
    with pytest.raises(RuntimeError):
        pgs.pg_fold_gs(Y, tslot[:4 * 5].contiguous(),
                       **dict(kw, ntx=4, nty=5))


# ---------------------------------------------------------------------
# the lab kernels (L2, L3)


@pytest.mark.parametrize("N,L,S", [(2048, 128, 1), (2048, 128, 2),
                                   (2048, 128, 8), (8192, 64, 2),
                                   (256, 3, 64), (960, 5, 16)])
@pytest.mark.parametrize("inverse", [False, True])
def test_cfft_lab_launch_parameters(cuda, N, L, S, inverse):
    """fftx_c2c_lab (line_fft_kernel with an explicit S, the x pass
    before the cluster kernel) against the plain transform; cut to its
    first pass it gives the plain first radix pass."""
    g = torch.Generator(device=cuda).manual_seed(N + S)
    xr = torch.randn((2, N, L), generator=g, device=cuda)
    xi = torch.randn((2, N, L), generator=g, device=cuda)
    kw = dict(N=N, inverse=inverse, out_rolled=True)
    n0 = cf.fftx_c2c_lab.launches
    yr, yi = cf.fftx_c2c_lab(xr, xi, S=S, **kw)
    fr, fi = cf.fftx_c2c_lab(xr, xi, S=S, npass=1, **kw)
    torch.cuda.synchronize()
    assert cf.fftx_c2c_lab.launches == n0 + 2
    pr, pi = fftx_c2c_plain(xr, xi, **kw)
    assert _ok(yr, pr) and _ok(yi, pi)
    pr, pi = cf.fftx_c2c_first_pass_plain(xr, xi, **kw)
    assert _ok(fr, pr) and _ok(fi, pi)


@pytest.mark.parametrize("N,P,L,inverse,in_rolled,out_rolled", [
    (1024, 2, 128, True, False, True), (1024, 1, 96, False, False, False),
    (2048, 2, 128, True, False, True), (2048, 1, 64, False, True, False),
    (8192, 1, 128, True, False, True)])
def test_split_kernel_matches_plain(cuda, N, P, L, inverse, in_rolled,
                                    out_rolled):
    g = torch.Generator(device=cuda).manual_seed(N + L)
    nin = N // 2 if in_rolled else N
    xr = torch.randn((P, nin, L), generator=g, device=cuda)
    xi = torch.randn((P, nin, L), generator=g, device=cuda)
    kw = dict(N=N, inverse=inverse, in_rolled=in_rolled,
              out_rolled=out_rolled)
    n0 = cf.fftx_c2c_split.launches
    yr, yi = cf.fftx_c2c_split(xr, xi, **kw)
    torch.cuda.synchronize()
    assert cf.fftx_c2c_split.launches == n0 + 1
    pr, pi = cf.fftx_c2c_split_plain(xr, xi, **kw)
    assert _ok(yr, pr) and _ok(yi, pi)
    # about 1e-5 of max from the float64 transform (the split's own error)
    dr, di = fftx_c2c_plain(xr.double(), xi.double(), **kw)
    assert float((yr.double() - dr).abs().max()) <= \
        5e-5 * float(dr.abs().max())


@pytest.mark.parametrize("mode", memlab.MODES)
@pytest.mark.parametrize("N,P,two", [(512, 2, True), (2048, 3, False),
                                     (8192, 1, True)])
def test_lab_copy_matches_slicing(cuda, mode, N, P, two):
    g = torch.Generator(device=cuda).manual_seed(N)
    x = torch.randn((P, N, N), generator=g, device=cuda)
    x2 = torch.randn((P, N, N), generator=g, device=cuda) if two else None
    Ss = (64, 128, 256) if mode == "rows" else (None,)
    for S in Ss:
        n0 = memlab.lab_copy.launches
        y, y2 = memlab.lab_copy(mode, x, x2, S=S)
        torch.cuda.synchronize()
        assert memlab.lab_copy.launches == n0 + 1
        ref, ref2 = memlab.lab_copy_plain(mode, x, x2)
        assert torch.equal(y, ref)
        assert (y2 is None) == (not two)
        if two:
            assert torch.equal(y2, ref2)


@pytest.mark.parametrize("P", [1, 2])
def test_paired_entries_spread_matches_plain(cuda, P):
    """K4 through pack_entries (capacity P C) against the plain spread on
    the same packed operands."""
    p = _pg_plan(cuda, 1024, 1e-5, True, seed=5)
    g = torch.Generator(device=cuda).manual_seed(P)
    vis = (torch.randn((p["nentries"], 2, p["C"]), generator=g,
                       device=cuda) * p["pm"][:, None]).contiguous()
    k = p["k"]
    pk = pg.pack_entries(p["pos"], vis, p["tid"], p["pm"], P, ntx=p["ntx"],
                         nty=p["nty"], txs=p["txs"], tys=p["tys"], k=k)
    assert pk["pos"].shape[-1] == P * p["C"]
    kw = dict(beta=p["beta"], k=k, nw=p["nw"], Thx=p["txs"] + k,
              Thy=p["tys"] + k)
    n0 = pg.pg_spread.launches
    out = pg.pg_spread(pk["pos"], pk["vis"], pk["slots"], **kw)
    torch.cuda.synchronize()
    assert pg.pg_spread.launches == n0 + 1
    ref = pg.pg_spread_plain(pk["pos"], pk["vis"], pk["slots"], **kw)
    live = pk["slots"]["live"]
    assert _ok(out[:, :, live], ref[:, :, live])


def test_lab_wrappers_reject_bad_operands(cuda):
    x = torch.zeros((1, 512, 512), device=cuda)
    with pytest.raises(ValueError):   # float64 on the card
        memlab.lab_copy("strip", x.double())
    with pytest.raises(ValueError):   # relayout rows not a multiple of 32
        memlab.lab_copy("relayout", x, S=16)
    with pytest.raises(ValueError):   # S * N above 16384
        cf.fftx_c2c_lab(x, x, N=512, S=64)
    y = torch.zeros((8, 8192, 8192), device=cuda)
    with pytest.raises(RuntimeError):  # two stacks' strips of 8 planes
        memlab.lab_copy("batched", y, y)  # exceed a block's shared memory
    with pytest.raises(ValueError):
        cf.fftx_c2c_lab(x, x, N=512, npass=2)
    z = torch.zeros((1, 32768, 16), device=cuda)
    with pytest.raises(ValueError):   # no cluster of 4 or 8 divides N
        cf.fftx_c2c_cluster(z[:, :6561], z[:, :6561], N=6561)
    with pytest.raises(ValueError):   # 4 lines of 4096 exceed a block
        cf.fftx_c2c_cluster(z, z, N=32768)
    r = torch.zeros((4, 8192, 1), device=cuda)
    with pytest.raises(ValueError):   # no row kernel instance at 1024
        cf.fftx_c2c_rows(r[:, :1024], r[:, :1024], N=1024)
    with pytest.raises(ValueError):   # strided columns
        cf.fftx_c2c_rows(z[:, :8192, :2], z[:, :8192, :2], N=8192)
    with pytest.raises(ValueError):   # float64 on the card
        cf.fftx_c2c_rows(r.double(), r.double(), N=8192)
    with pytest.raises(ValueError):   # 512 rows for N = 1024
        cf.fftx_c2c_split(x, x, N=1024)
    with pytest.raises(ValueError):
        cf.fftx_c2c_split(x.double(), x.double(), N=512)


@pytest.mark.parametrize("nx,C", [(2048, 4), (4096, 8), (1024, 4),
                                  (512, 1), (128, cf._TINY_C),
                                  (768, cf._TINY_C)])
@pytest.mark.parametrize("complex_h", [False, True])
def test_k2_cluster_route_matches_plain_and_k1(cuda, nx, C, complex_h):
    """K2 where cols_route holds, (2, 1024^2) of 2048, (2, 2048^2) of 4096,
    (2, 4096^2) of 8192 and the short NX = 256, 1024 and 1536 (tiles of
    32 columns at C = 2, 8 at C = 1 and 8 at C = 2): its stages launch
    the cluster column kernels (their counters gain one launch each); p, conv(p) and pap against the plain version;
    conv bitwise K1 of K2's own p (the same FFT on the same values);
    reruns bitwise (block partials added in a fixed order)."""
    nb = 2
    assert psf_mod.cols_route(2 * nx, nx) and \
        cf.cluster_shape(2 * nx)[0] == C
    g = torch.Generator(device=cuda).manual_seed(nx + complex_h)
    psf = torch.randn((nb, 2 * nx, 2 * nx), generator=g, device=cuda)
    hr, hi = prep_h(psf, nx, nx, torch.float32, real_transfer=not complex_h)
    del psf
    pp, r = (torch.randn((nb, nx, nx), generator=g, device=cuda)
             for _ in range(2))
    beta = torch.rand((nb, 1, 1), generator=g, device=cuda)
    n0 = (psf_mod.psf_cols_fwd.launches, psf_mod.psf_cols_inv.launches,
          psf_convolve_h_cg.launches)
    got = psf_convolve_h_cg(pp, r, beta, hr, hi)
    torch.cuda.synchronize()
    assert (psf_mod.psf_cols_fwd.launches, psf_mod.psf_cols_inv.launches,
            psf_convolve_h_cg.launches) == tuple(n + 1 for n in n0)
    ref = psf_convolve_h_cg_plain(pp, r, beta, hr, hi)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        assert _ok(a, b)
    assert torch.equal(got[1], psf_convolve_h(got[0], hr, hi))
    for a, b in zip(got, psf_convolve_h_cg(pp, r, beta, hr, hi)):
        assert torch.equal(a, b)


def test_k2_stages_alone_chain_to_k2(cuda):
    """psf_cg_stages: the three stages launched one at a time on one
    scratch give K2's outputs bit for bit."""
    nb, nx = 2, 2048
    g = torch.Generator(device=cuda).manual_seed(12)
    psf = torch.randn((nb, 2 * nx, 2 * nx), generator=g, device=cuda)
    hr, hi = prep_h(psf, nx, nx, torch.float32, real_transfer=False)
    pp, r = (torch.randn((nb, nx, nx), generator=g, device=cuda)
             for _ in range(2))
    beta = torch.rand((nb, 1, 1), generator=g, device=cuda)
    want = psf_convolve_h_cg(pp, r, beta, hr, hi)
    bufs = None
    for s in (1, 2, 4):
        bufs = psf_mod.psf_cg_stages(pp, r, beta, hr, hi, s, bufs)
    for a, k in zip(want, ("pn", "out", "pap")):
        assert torch.equal(a, bufs[k])


SPREAD_CASES = [(512, 1e-5, True), (512, 1e-7, True), (512, 1e-5, False),
                (1024, 1e-5, True)]


@pytest.mark.parametrize("nx,eps,do_w", SPREAD_CASES)
def test_spread_k4_bitwise_the_scan_design(cuda, nx, eps, do_w):
    """K4 (the lists) against the earlier design kept in the lab
    (csrc/lab_spread.cu, "scan") on seeded plans, k = 7 (the compiled
    rows) and 9, one and many planes: the live slots bit for bit; reruns
    bit for bit."""
    p = _pg_plan(cuda, nx, eps, do_w, seed=nx + 1)
    k, nw, txs, tys = p["k"], p["nw"], p["txs"], p["tys"]
    slots = pg._compact_slots(p["tid"], p["pm"], p["ntx"], p["nty"], txs,
                              tys, k)
    g = torch.Generator(device=cuda).manual_seed(nx)
    vis = (torch.randn((p["nentries"], 2, p["C"]), generator=g,
                       device=cuda) * p["pm"][:, None]).contiguous()
    kw = dict(beta=p["beta"], k=k, nw=nw, Thx=txs + k, Thy=tys + k)
    live = slots["live"]
    got = pg.pg_spread(p["pos"], vis, slots, **kw)[:, :, live]
    ref = pgs.pg_spread_lab(p["pos"], vis, slots["start"], slots["count"],
                            design="scan", **kw)[:, :, live]
    assert torch.equal(got, ref)
    again = pg.pg_spread(p["pos"], vis, slots, **kw)[:, :, live]
    assert torch.equal(got, again)


@pytest.mark.parametrize("nx,eps", [(512, 1e-5), (512, 1e-7), (1024, 1e-5)])
def test_spread_k7_bitwise_the_scan_design(cuda, nx, eps):
    """K7 on every live block of a seeded w-blocked plan against the
    earlier design: the slots with entries bit for bit; reruns bit for
    bit."""
    bp = _gs_plan(cuda, nx, eps, seed=nx + 2)
    p0, B = bp["p0"], bp["B"]
    k = p0["k"]
    g = torch.Generator(device=cuda).manual_seed(nx)
    vis = (torch.randn((bp["NEg"] + 1, 2, p0["C"]), generator=g,
                       device=cuda) * bp["gpm"][:, None]).contiguous()
    for b in range(bp["nblocks"]):
        if not bp["blive"][b]:
            continue
        gmap = bp["gmap"][b, :int(bp["nelive"][b])]
        st, ct = bp["start"][b], bp["count"][b]
        kw = dict(woff=int(bp["woff"][b, 0]), beta=p0["beta"], k=k,
                  Thx=p0["txs"] + k, Thy=p0["tys"] + k)
        sl = ct > 0
        got = pgs.pg_spread_gs(bp["pos"], vis, gmap, st, ct, B=B, **kw)
        ref = pgs.pg_spread_lab(bp["pos"], vis, st, ct, gmap=gmap, nw=B,
                                design="scan", **kw)
        assert torch.equal(got[:, :, sl], ref[:, :, sl])
        again = pgs.pg_spread_gs(bp["pos"], vis, gmap, st, ct, B=B, **kw)
        assert torch.equal(got[:, :, sl], again[:, :, sl])


def test_spread_lab_skeletons_launch(cuda):
    """Each skeleton of both designs launches on a k = 7 plan and counts
    its launch; a skeleton at another k is refused (only the paths' k is
    compiled with them)."""
    p = _pg_plan(cuda, 512, 1e-5, True, seed=5)
    k, txs, tys = p["k"], p["txs"], p["tys"]
    assert k == 7
    slots = pg._compact_slots(p["tid"], p["pm"], p["ntx"], p["nty"], txs,
                              tys, k)
    vis = torch.zeros((p["nentries"], 2, p["C"]), device=cuda)
    kw = dict(beta=p["beta"], k=k, nw=p["nw"], Thx=txs + k, Thy=tys + k)
    for design in pgs.SPREAD_DESIGNS:
        for mode in pgs.SPREAD_MODES:
            n0 = pgs.pg_spread_lab.launches
            pgs.pg_spread_lab(p["pos"], vis, slots["start"], slots["count"],
                              design=design, mode=mode, **kw)
            assert pgs.pg_spread_lab.launches == n0 + 1
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError):
        pgs.pg_spread_lab(p["pos"], vis, slots["start"], slots["count"],
                          design="lists", mode="no FMA", **dict(kw, k=9))


# (nx, epsilon -> k, w gridding, capacity): k = 7 (the compiled taps), 5
# and 9 (the window's guard on k; the taps take only k = 7), one plane,
# and a capacity of 16, which puts a hot tile's visibilities in many
# entries, one block each
DEGRID_CASES = [(512, 1e-5, True, 128), (512, 1e-3, True, 128),
                (512, 1e-7, True, 128), (512, 1e-5, False, 128),
                (1024, 1e-5, True, 16)]


@pytest.mark.parametrize("nx,eps,do_w,cap", DEGRID_CASES)
def test_degrid_k6_bitwise_the_thread_design(cuda, nx, eps, do_w, cap):
    """K6 and the lab's window design (and the taps at k = 7) against the
    earlier design (csrc/pg_degrid.cu, the lab's "thread") on seeded
    plans and grids: bit for bit; reruns bit for bit."""
    p = _pg_plan(cuda, nx, eps, do_w, seed=nx + 3, capacity=cap)
    if cap == 16:
        _, runs = torch.unique_consecutive(p["tid"], return_counts=True)
        assert int(runs.max()) >= 8
    g = torch.Generator(device=cuda).manual_seed(nx)
    gr = torch.randn((p["nw"], p["Nx"], p["Ny"]), generator=g, device=cuda)
    gi = torch.randn_like(gr)
    kw = dict(beta=p["beta"], k=p["k"], nw=p["nw"], txs=p["txs"],
              tys=p["tys"], nty=p["nty"])
    got = pg.pg_degrid(gr, gi, p["pos"], p["tid"], **kw)
    ref = pgs.pg_degrid_lab(gr, gi, p["pos"], p["tid"], design="thread",
                            **kw)
    assert torch.equal(got, ref)
    assert torch.equal(got, pg.pg_degrid(gr, gi, p["pos"], p["tid"], **kw))
    for design in ("taps", "window") if p["k"] == 7 else ("window",):
        assert torch.equal(pgs.pg_degrid_lab(gr, gi, p["pos"], p["tid"],
                                             design=design, **kw), ref)


def test_degrid_window_on_a_grid_of_2_mod_4(cuda):
    """A 90-point grid (Ny % 4 == 2): the window stages its rows one float
    at a time, not in 16-byte chunks; K6 and K9 bit for bit the earlier
    design."""
    p = _pg_plan(cuda, 45, 1e-5, True, tiles=(None, 40), seed=12)
    assert p["Ny"] % 4 == 2
    g = torch.Generator(device=cuda).manual_seed(12)
    gr = torch.randn((p["nw"], p["Nx"], p["Ny"]), generator=g, device=cuda)
    gi = torch.randn_like(gr)
    kw = dict(beta=p["beta"], k=p["k"], nw=p["nw"], txs=p["txs"],
              tys=p["tys"], nty=p["nty"])
    got = pg.pg_degrid(gr, gi, p["pos"], p["tid"], **kw)
    assert torch.equal(got, pgs.pg_degrid_lab(gr, gi, p["pos"], p["tid"],
                                              design="thread", **kw))
    bp = _gs_plan(cuda, 45, 1e-5, tiles=(None, 40), seed=12)
    p0, B = bp["p0"], bp["B"]
    b = int(bp["nelive"].argmax())
    gmap = bp["gmap"][b, :int(bp["nelive"][b])]
    gr = torch.randn((B, p0["Nx"], p0["Ny"]), generator=g, device=cuda)
    gi = torch.randn_like(gr)
    acc = torch.randn((bp["NEg"] + 1, 2, p0["C"]), generator=g, device=cuda)
    kw = dict(woff=int(bp["woff"][b, 0]), beta=p0["beta"], k=p0["k"],
              txs=p0["txs"], tys=p0["tys"], nty=p0["nty"])
    ref = pgs.pg_degrid_lab(gr, gi, bp["pos"], bp["utid"], gmap=gmap,
                            acc=acc.clone(), nw=B, design="thread", **kw)
    got = pgs.pg_degrid_gs(gr, gi, bp["pos"], bp["utid"], gmap, acc, B=B,
                           **kw)
    assert torch.equal(got, ref)


def test_degrid_window_too_large_takes_the_taps(cuda):
    """Tile windows whose shared memory leaves one block an SM (tile_v
    900 on a 1024-point grid, 116 KiB) or passes a block's limit (tile_v
    1900 on 2048 points, 241 KiB) at k = 7: K6 takes the taps design, bit
    for bit the earlier one; the window design runs the first and refuses
    the second."""
    for nx, tile_v in ((512, 900), (1024, 1900)):
        p = _pg_plan(cuda, nx, 1e-5, True, tiles=(None, tile_v), seed=11)
        assert p["k"] == 7
        g = torch.Generator(device=cuda).manual_seed(11)
        gr = torch.randn((p["nw"], p["Nx"], p["Ny"]), generator=g,
                         device=cuda)
        gi = torch.randn_like(gr)
        kw = dict(beta=p["beta"], k=p["k"], nw=p["nw"], txs=p["txs"],
                  tys=p["tys"], nty=p["nty"])
        got = pg.pg_degrid(gr, gi, p["pos"], p["tid"], **kw)
        ref = pgs.pg_degrid_lab(gr, gi, p["pos"], p["tid"], design="thread",
                                **kw)
        assert torch.equal(got, ref)
        assert torch.equal(got, pgs.pg_degrid_lab(gr, gi, p["pos"],
                                                  p["tid"], design="taps",
                                                  **kw))
        if tile_v == 900:
            assert torch.equal(got, pgs.pg_degrid_lab(
                gr, gi, p["pos"], p["tid"], design="window", **kw))
        else:
            with pytest.raises(RuntimeError):
                pgs.pg_degrid_lab(gr, gi, p["pos"], p["tid"],
                                  design="window", **kw)
            torch.cuda.synchronize()


@pytest.mark.parametrize("eps", [1e-3, 1e-7])
def test_degrid_one_block_an_sm_takes_the_thread_at_other_k(cuda, eps):
    """A tile window that leaves one block an SM (tile_v 900) at k = 5 and
    9: K6 and K9 take the earlier design (the taps refuse these k), bit
    for bit the window's."""
    p = _pg_plan(cuda, 512, eps, True, tiles=(None, 900), seed=13)
    assert p["k"] != 7
    g = torch.Generator(device=cuda).manual_seed(13)
    gr = torch.randn((p["nw"], p["Nx"], p["Ny"]), generator=g, device=cuda)
    gi = torch.randn_like(gr)
    kw = dict(beta=p["beta"], k=p["k"], nw=p["nw"], txs=p["txs"],
              tys=p["tys"], nty=p["nty"])
    got = pg.pg_degrid(gr, gi, p["pos"], p["tid"], **kw)
    assert torch.equal(got, pgs.pg_degrid_lab(gr, gi, p["pos"], p["tid"],
                                              design="window", **kw))
    with pytest.raises(RuntimeError):
        pgs.pg_degrid_lab(gr, gi, p["pos"], p["tid"], design="taps", **kw)
    torch.cuda.synchronize()
    bp = _gs_plan(cuda, 512, eps, tiles=(None, 900), seed=13)
    p0, B = bp["p0"], bp["B"]
    b = int(bp["nelive"].argmax())
    gmap = bp["gmap"][b, :int(bp["nelive"][b])]
    gr = torch.randn((B, p0["Nx"], p0["Ny"]), generator=g, device=cuda)
    gi = torch.randn_like(gr)
    acc = torch.randn((bp["NEg"] + 1, 2, p0["C"]), generator=g, device=cuda)
    kw = dict(woff=int(bp["woff"][b, 0]), beta=p0["beta"], k=p0["k"],
              txs=p0["txs"], tys=p0["tys"], nty=p0["nty"])
    ref = pgs.pg_degrid_lab(gr, gi, bp["pos"], bp["utid"], gmap=gmap,
                            acc=acc.clone(), nw=B, design="window", **kw)
    got = pgs.pg_degrid_gs(gr, gi, bp["pos"], bp["utid"], gmap, acc, B=B,
                           **kw)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("nx,eps", [(512, 1e-5), (512, 1e-3), (512, 1e-7),
                                    (1024, 1e-5)])
def test_degrid_k9_bitwise_the_thread_design(cuda, nx, eps):
    """K9 and the lab's window design (and the taps at k = 7) on every
    live block of a seeded w-blocked plan, added in block order into one
    nonzero accumulator, against the earlier design: bit for bit; reruns
    bit for bit."""
    bp = _gs_plan(cuda, nx, eps, seed=nx + 4)
    p0, B = bp["p0"], bp["B"]
    g = torch.Generator(device=cuda).manual_seed(nx)
    acc0 = torch.randn((bp["NEg"] + 1, 2, p0["C"]), generator=g,
                       device=cuda)
    got, ref, again = acc0.clone(), acc0.clone(), acc0.clone()
    labs = {d: acc0.clone()
            for d in (("taps", "window") if p0["k"] == 7 else ("window",))}
    kw = dict(beta=p0["beta"], k=p0["k"], txs=p0["txs"], tys=p0["tys"],
              nty=p0["nty"])
    for b in range(bp["nblocks"]):
        if not bp["blive"][b]:
            continue
        gmap = bp["gmap"][b, :int(bp["nelive"][b])]
        woff = int(bp["woff"][b, 0])
        gr = torch.randn((B, p0["Nx"], p0["Ny"]), generator=g, device=cuda)
        gi = torch.randn_like(gr)
        for acc in (got, again):
            pgs.pg_degrid_gs(gr, gi, bp["pos"], bp["utid"], gmap, acc,
                             woff=woff, B=B, **kw)
        for design, acc in dict(labs, thread=ref).items():
            pgs.pg_degrid_lab(gr, gi, bp["pos"], bp["utid"], gmap=gmap,
                              acc=acc, woff=woff, nw=B, design=design, **kw)
    assert not torch.equal(got, acc0)
    assert torch.equal(got, ref)
    assert torch.equal(got, again)
    for acc in labs.values():
        assert torch.equal(acc, ref)


def test_degrid_lab_skeletons_launch(cuda):
    """Each skeleton of every design launches on a k = 7 plan, K6's and
    K9's operands, and counts its launch; a skeleton of the taps or the
    window at another k is refused (only the paths' k is compiled with
    them), and the taps kernel too."""
    p = _pg_plan(cuda, 512, 1e-5, True, seed=5)
    assert p["k"] == 7
    gr = torch.zeros((p["nw"], p["Nx"], p["Ny"]), device=cuda)
    kw = dict(beta=p["beta"], k=7, nw=p["nw"], txs=p["txs"], tys=p["tys"],
              nty=p["nty"])
    gmap = torch.arange(p["nentries"], dtype=torch.int32, device=cuda)
    acc = torch.zeros((p["nentries"], 2, p["C"]), device=cuda)
    for design in pgs.DEGRID_DESIGNS:
        for mode in pgs.DEGRID_MODES:
            for k9 in ({}, dict(gmap=gmap, acc=acc)):
                n0 = pgs.pg_degrid_lab.launches
                pgs.pg_degrid_lab(gr, gr, p["pos"], p["tid"], design=design,
                                  mode=mode, **k9, **kw)
                assert pgs.pg_degrid_lab.launches == n0 + 1
    torch.cuda.synchronize()
    for design, mode in (("taps", "loads"), ("window", "loads"),
                         ("taps", "kernel")):
        with pytest.raises(RuntimeError):
            pgs.pg_degrid_lab(gr, gr, p["pos"], p["tid"], design=design,
                              mode=mode, **dict(kw, k=9))
        torch.cuda.synchronize()


def _post_obs(tmp_path, device, **grid):
    """A small observation through init -> grid on ``device``, with 0.8
    of the true model as MODEL."""
    from pfb_tpu_torch.utils.ms import simulate_ms
    from pfb_tpu_torch.workers.grid import _grid
    from pfb_tpu_torch.workers.init import _init
    ms = str(tmp_path / "t.npz")
    model = simulate_ms(ms, nant=16, ntime=12, nchan=4, nsource=5,
                        fov_deg=0.4, seed=13)[0]
    xds = _init(ms=ms, write=False, channels_per_image=1,
                precision="single", device=device)
    dds = _grid(xdsi=xds, write=False, device=device, field_of_view=0.4,
                robustness=0.0, backend="pg", epsilon=1e-5, **grid)
    for ds in dds:
        ds["MODEL"] = 0.8 * model[ds["bandid"]]
    return ms, dds


def test_degrid_pg_on_card_matches_cpu(cuda, tmp_path):
    """_degrid(backend="pg") on the card (float32 kernels, a plan and one
    K6 launch per band) against the same call on the CPU (float64 plain
    versions): 1e-5 of max."""
    from pfb_tpu_torch.workers.degrid import _degrid
    from pfb_tpu_torch.workers.model2comps import _model2comps
    ms, dds = _post_obs(tmp_path, "cpu", psf=False, residual=False)
    mds = _model2comps(ddsi=dds)
    kw = dict(ms=ms, mds=mds, backend="pg", epsilon=1e-5,
              channels_per_image=1, write=False)
    ref = _degrid(device="cpu", **kw)
    n0 = pg.pg_degrid.launches
    got = _degrid(device=cuda, **kw)
    assert pg.pg_degrid.launches == n0 + len(dds)
    assert np.abs(ref).max() > 0
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()


def test_fluxmop_pg_on_card_reduces_residual(cuda, tmp_path):
    """_fluxmop(backend="pg") on the card from the dirty image: its MFS
    residual peak below 0.6 of the MFS dirty peak
    (tests/test_aux_workers.py:38), with the spread, fold and degrid
    kernels launched in its exact residual; on a (1, 4) virtual space
    mesh the model stays within 1e-4 of max."""
    from pfb_tpu_torch.workers.fluxmop import _fluxmop
    _, dds = _post_obs(tmp_path, cuda, psf=True, residual=False)
    for ds in dds:
        del ds["MODEL"]
    kw = dict(backend="pg", epsilon=1e-5, use_psf=True, sigmainv=1e-4,
              gamma=0.9, cg_maxit=100, write=False, device=cuda, verbose=0)
    n0 = [f.launches for f in (pg.pg_spread, pg.pg_fold, pg.pg_degrid)]
    m1, r1 = _fluxmop(ddsi=[dict(d) for d in dds], **kw)
    n1 = [f.launches for f in (pg.pg_spread, pg.pg_fold, pg.pg_degrid)]
    assert all(b > a for a, b in zip(n0, n1))
    wsum = sum(float(d["WSUM"][0]) for d in dds)
    dirty = sum(d["DIRTY"] for d in dds) / wsum
    assert np.abs(r1.sum(0)).max() < 0.6 * np.abs(dirty).max()
    m4, _ = _fluxmop(ddsi=[dict(d) for d in dds], space_shards=4,
                     devices=[cuda] * 4, **kw)
    assert np.abs(m4 - m1).max() <= 1e-4 * np.abs(m1).max()


def test_fwdbwd_pg_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """_fwdbwd(backend="pg", parametrisation="id", niter=2) on the card
    against the same call on the CPU (float32 data in both, each power
    method started from one numpy draw): the exact residual launches the
    spread, fold and degrid kernels and no PSF kernel, the MFS residual
    peak falls below 0.5 of the MFS dirty peak (tests/test_fwdbwd.py:49),
    and the model agrees to 2e-3 of max: rounding grows through the PCG
    and primal-dual solves, and the same CPU run in float32 reads 6.2e-4
    of max from its float64 twin."""
    from pfb_tpu_torch.opt.power_method import power_method
    from pfb_tpu_torch.workers import fwdbwd as fwdbwd_mod

    def pm(A, imsize, b0=None, device=None, dtype=torch.float64, **kw):
        if b0 is None:
            b0 = torch.as_tensor(np.random.default_rng(42).standard_normal(
                imsize)).to(device=device, dtype=dtype)
        return power_method(A, imsize, b0=b0, device=device, dtype=dtype,
                            **kw)

    monkeypatch.setattr(fwdbwd_mod, "power_method", pm)
    _, dds = _post_obs(tmp_path, "cpu", psf=True, residual=False)
    for ds in dds:
        del ds["MODEL"]
    kw = dict(backend="pg", epsilon=1e-5, niter=2, parametrisation="id",
              rmsfactor=0.3, bases="self,db1", nlevels=2, write=False,
              verbose=0)
    mc, _, _ = fwdbwd_mod._fwdbwd(ddsi=[dict(d) for d in dds],
                                  device="cpu", **kw)
    kernels = (pg.pg_spread, pg.pg_fold, pg.pg_degrid, psf_convolve_h,
               psf_convolve_full)
    n0 = [f.launches for f in kernels]
    mg, _, rg = fwdbwd_mod._fwdbwd(ddsi=[dict(d) for d in dds],
                                   device=cuda, **kw)
    n1 = [f.launches for f in kernels]
    assert all(b > a for a, b in zip(n0[:3], n1[:3]))
    assert n1[3:] == n0[3:]
    wsum = sum(float(d["WSUM"][0]) for d in dds)
    dirty = sum(d["DIRTY"] for d in dds) / wsum
    assert np.abs(rg.sum(0)).max() < 0.5 * np.abs(dirty).max()
    err = np.abs(mg - mc).max() / np.abs(mc).max()
    assert err <= 2e-3, err


def test_fastim_pg_on_card_matches_cpu(cuda, tmp_path):
    """_fastim(backend="pg") on the card, with an mds degridded at two
    channels a sub-band, against the same call on the CPU (float64 plain
    versions): every snapshot's RESIDUAL within 1e-5 of the largest
    snapshot peak and its WSUM to 1e-6; K4 and K5 at least once a
    snapshot, K6 once a snapshot and sub-band."""
    from pfb_tpu_torch.workers.fastim import _fastim
    from pfb_tpu_torch.workers.model2comps import _model2comps
    ms, dds = _post_obs(tmp_path, "cpu", psf=False, residual=False)
    mds = _model2comps(ddsi=dds)
    kw = dict(ms=ms, backend="pg", epsilon=1e-5, integrations_per_image=3,
              channels_per_grid_image=-1, channels_per_degrid_image=2,
              field_of_view=0.4, mds=mds, write=False)
    ref = _fastim(device="cpu", **kw)
    n0 = [f.launches for f in (pg.pg_spread, pg.pg_fold, pg.pg_degrid)]
    got = _fastim(device=cuda, **kw)
    n1 = [f.launches for f in (pg.pg_spread, pg.pg_fold, pg.pg_degrid)]
    ns = len(ref)
    assert len(got) == ns == 4
    assert n1[0] - n0[0] >= ns and n1[1] - n0[1] >= ns
    assert n1[2] - n0[2] == 2 * ns
    peak = max(np.abs(d["RESIDUAL"]).max() for d in ref)
    for a, b in zip(got, ref):
        assert np.abs(a["RESIDUAL"] - b["RESIDUAL"]).max() <= TOL * peak
        assert abs(a["WSUM"][0] - b["WSUM"][0]) <= 1e-6 * b["WSUM"][0]


def test_fit_spi_on_card_matches_cpu(cuda):
    """utils/spi.py:fit_spi on the card (the batched Gauss-Newton on
    device tensors) against the same call on the CPU: the same pixels
    fitted, alpha and i0 to 1e-10 relative (float64 in both)."""
    from pfb_tpu_torch.utils.spi import fit_spi
    rng = np.random.default_rng(3)
    freqs = 1e9 + np.arange(4) * 1e8
    cube = np.zeros((4, 64, 64))
    pix = rng.integers(0, 64, size=(200, 2))
    for (ix, iy), a in zip(pix, rng.normal(-0.7, 0.2, size=200)):
        cube[:, ix, iy] = (1.0 + rng.random()) * (freqs / freqs.mean()) ** a
    ac, ic = fit_spi(cube, freqs, threshold=0.1, device="cpu")
    ag, ig = fit_spi(cube, freqs, threshold=0.1, device=cuda)
    np.testing.assert_array_equal(np.isnan(ag), np.isnan(ac))
    ok = ~np.isnan(ac)
    for g, c in ((ag, ac), (ig, ic)):
        assert np.abs(g[ok] - c[ok]).max() <= 1e-10 * np.abs(c[ok]).max()


def _cli_run(tmp_path, device, ms, tag, hessnorm=None):
    """The CLI's pipeline: init -> grid(pg) at 256^2 x 2 (float32 data)
    -> spotless(pallas, pg) when ``hessnorm`` is given; returns the dds."""
    from click.testing import CliRunner

    from pfb_tpu_torch.utils import dstore
    from pfb_tpu_torch.workers.main import cli
    out = str(tmp_path / tag)
    steps = f"""steps:
  - worker: init
    params: {{ms: {ms}, output-filename: {out}, channels-per-image: 1,
             precision: single, overwrite: true}}
  - worker: grid
    params: {{output-filename: {out}, backend: pg, nx: 256, ny: 256,
             field-of-view: 0.4, robustness: 0.0, psf: true,
             residual: false, epsilon: 1.0e-5, overwrite: true}}
"""
    if hessnorm is not None:
        steps += f"""  - worker: spotless
    params: {{output-filename: {out}, engine: pallas, backend: pg,
             epsilon: 1.0e-5, niter: 2, pd-maxit: 50, nlevels: 2,
             hessnorm: {hessnorm!r}, verbose: 0, pd-verbose: 0}}
"""
    recipe = tmp_path / f"{tag}.yaml"
    recipe.write_text(steps)
    r = CliRunner().invoke(cli, ["--device", str(device), "pipeline",
                                 str(recipe)])
    assert r.exit_code == 0, (r.output, r.exception)
    return dstore.read_store(out + "_I_main.dds")


def test_cli_pipeline_on_card_matches_cpu(cuda, tmp_path):
    """The CLI's init -> grid(pg) -> spotless(engine pallas, pg) at 256^2 x
    2 bands on the card (``--device cuda``) against the same recipe on the
    CPU (float32 data in both; one hessnorm, 1.05 max|PSFHAT|, given to
    both so that the power method's device-dependent start vector is out
    of the comparison): DIRTY and PSF within 1e-5 of max, the model within
    2e-3 of max (the tolerance of the fwdbwd card test: rounding grows
    through the primal-dual solves), and K1, K4, K5 and K6 launched on the
    card only."""
    from pfb_tpu_torch.utils.ms import simulate_ms
    ms = str(tmp_path / "t.npz")
    simulate_ms(ms, nant=16, ntime=12, nchan=2, nsource=5, fov_deg=0.4,
                seed=13)
    cpu = _cli_run(tmp_path, "cpu", ms, "cpu0")
    psf = np.stack([ds["PSF"] for ds in cpu])
    wsum = sum(float(ds["WSUM"][0]) for ds in cpu)
    hn = 1.05 * float(np.abs(np.fft.rfft2(psf / wsum)).max())
    kernels = (psf_convolve_h, pg.pg_spread, pg.pg_fold, pg.pg_degrid)
    n0 = [f.launches for f in kernels]
    cpu = _cli_run(tmp_path, "cpu", ms, "cpu", hessnorm=hn)
    assert [f.launches for f in kernels] == n0
    gpu = _cli_run(tmp_path, cuda, ms, "gpu", hessnorm=hn)
    assert all(f.launches > n for f, n in zip(kernels, n0))
    for key, tol in (("DIRTY", TOL), ("PSF", TOL), ("MODEL", 2e-3)):
        a = np.stack([ds[key] for ds in cpu])
        b = np.stack([ds[key] for ds in gpu])
        assert a.shape == b.shape and np.abs(a).max() > 0, key
        assert np.abs(b - a).max() <= tol * np.abs(a).max(), key


MESH_CHILD = r"""
import sys
root, port, rank, out = sys.argv[1:5]
sys.path.insert(0, root)
import numpy as np
import torch
from pfb_tpu_torch.ops.psf import psf_convolve_h
from pfb_tpu_torch.parallel.runtime import set_client
sys.path.insert(0, root + "/tests")
from test_torch_gpu import _mesh_case
set_client(coordinator=f"127.0.0.1:{port}", num_processes=2,
           process_id=int(rank), devices=["cuda:0"])
hess, beta = _mesh_case(1)
np.savez(out, hess=hess, beta=beta, k1=psf_convolve_h.launches)
"""


def _mesh_case(nvirtual):
    """hessian_psf_dist(engine="pallas") and power_method_dist on a (2, 1)
    band mesh of (4, 256^2) with a random PSF, ``nvirtual`` shards on
    cuda:0 in this process."""
    from pfb_tpu_torch.parallel.dist import hessian_psf_dist, power_method_dist
    from pfb_tpu_torch.parallel.mesh import make_mesh
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(30)
    psf = torch.rand((4, 512, 512), generator=g, device=dev)
    x = torch.randn((4, 256, 256), generator=g, device=dev)
    h = [a for a in prep_h(psf, 256, 256, torch.float32) if a is not None]
    mesh = make_mesh(nband=2, nspace=1, devices=[dev] * nvirtual)
    hess = hessian_psf_dist(mesh, engine="pallas")(x, *h).gather()
    beta, _ = power_method_dist(mesh, engine="pallas", tol=1e-5,
                                maxit=50)(x, *h)
    return hess.cpu().numpy(), float(beta)


def test_two_process_band_mesh_on_one_card(cuda, tmp_path):
    """Two processes joined by set_client(coordinator=...) on one card
    (gloo, host-staged), one band shard each, against the one-process
    (2, 1) mesh of virtual shards: the K1 matvec and the power method's
    beta within 1e-5 of max (the sums across the processes are taken in
    mesh order, so they read equal bit for bit), K1 launched in each
    process."""
    import socket
    import subprocess
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    outs = [str(tmp_path / f"m{r}.npz") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", MESH_CHILD, root,
                               str(port), str(r), outs[r]],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, lg in zip(procs, logs):
        assert p.returncode == 0, lg[-3000:]
    hess, beta = _mesh_case(2)
    for o in outs:
        d = np.load(o)
        assert int(d["k1"]) > 0
        assert np.abs(d["hess"] - hess).max() <= TOL * np.abs(hess).max()
        assert abs(float(d["beta"]) - beta) <= TOL * abs(beta)


def test_mm_route_and_joint_hessian_on_card_matches_cpu(cuda):
    """backend "mm" on the card runs the pg kernels (K4, K5, K6), and
    make_hessian_dds(backend="mm") on two datasets with different phase
    centres (one pg plan each) and make_hess_vis_dct(backend="mm") on two
    fields, in float32, agree with the CPU's float64 runs within 1e-5 of
    max, at 1024^2 (2048^2 grids: the w planes on K3c and K3r)."""
    from pfb_tpu_torch.ops.gridder import make_hess_vis_dct, make_hessian_dds
    obs = simulate_obs(nant=16, ntime=8, nchan=2, seed=3)
    nx = 1024
    _, cell = image_size_for(obs, fov_deg=1.0)
    rng = np.random.default_rng(0)
    shape = (obs.uvw.shape[0], obs.freq.size)
    wgt = rng.random(shape)
    dds = [dict(UVW=obs.uvw, FREQ=obs.freq[b:b + 1], WEIGHT=wgt[:, b:b + 1],
                MASK=np.ones((shape[0], 1)), bandid=b, cell_rad=cell,
                x0=3 * cell * b, y0=-2 * cell * b) for b in range(2)]
    x = rng.normal(size=(2, nx, nx))
    hk = dict(backend="mm", epsilon=1e-5, do_wgridding=True)
    n0 = (pg.pg_spread.launches, pg.pg_fold.launches,
          pg.pg_degrid.launches) + _launches()
    h32 = make_hessian_dds(dds, 2, 1.0, nx, nx, device=cuda, **hk)
    out = h32(torch.as_tensor(x).to(cuda, torch.float32))
    n1 = (pg.pg_spread.launches, pg.pg_fold.launches,
          pg.pg_degrid.launches) + _launches()
    assert all(b - a >= 2 for a, b in zip(n0[:3], n1[:3]))
    assert n1[4] > n0[4] and n1[5] > n0[5]
    h64 = make_hessian_dds(dds, 2, 1.0, nx, nx, device="cpu", **hk)
    assert _ok(out.double().cpu(), h64(torch.as_tensor(x)))

    geom = {"f0": dict(nx=nx, ny=nx, cell_rad=cell, x0=0.0, y0=0.0),
            "f1": dict(nx=nx, ny=nx, cell_rad=cell, x0=4 * nx * cell,
                       y0=0.0)}
    ds = dict(dds[0], key="k")
    u = {f: {"k": rng.normal(size=(nx, nx))} for f in geom}
    hv = {dev: make_hess_vis_dct([ds], geom, sigmainv=1e-3, backend="mm",
                                 epsilon=1e-5, device=dev)
          for dev in (cuda, "cpu")}
    got = hv[cuda]({f: {"k": torch.as_tensor(a["k"]).to(cuda, torch.float32)}
                    for f, a in u.items()})
    ref = hv["cpu"]({f: {"k": torch.as_tensor(a["k"])} for f, a in u.items()})
    for f in geom:
        assert got[f]["k"].dtype == torch.float32
        assert _ok(got[f]["k"].double().cpu(), ref[f]["k"])


@pytest.mark.parametrize("k", [6, 0])
def test_compute_counts_on_card_matches_numpy(cuda, k):
    """The device counts on the card against the numpy counts, float64
    uvw, on a 32^2 grid spanning 3/4 of the uv extent (taps below 0 and
    past nx - 1 dropped): 1e-12 of max (atomic sums in another order)."""
    from pfb_tpu_torch.ops.dft import LIGHTSPEED
    from pfb_tpu_torch.ops.weighting import (compute_counts,
                                             compute_counts_numpy)
    o = simulate_obs(nant=9, ntime=8, nchan=3, seed=5)
    mask = (np.random.default_rng(1).random((o.uvw.shape[0], o.freq.size))
            > 0.2).astype(np.float64)
    nx = 32
    cell = 1.0 / (1.5 * np.abs(o.uvw[:, :2]).max() * o.freq.max()
                  / LIGHTSPEED)
    args = (o.uvw, o.freq, mask, nx, nx, cell, cell)
    ref = compute_counts_numpy(*args, k=k)
    got = compute_counts(*args, k=k)
    assert got.is_cuda and got.dtype == torch.float64
    got = got.cpu().numpy()
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


def test_hessian_psf_slice_on_card_matches_cube_band(cuda):
    from pfb_tpu_torch.ops.fft import make_psfhat
    from pfb_tpu_torch.ops.psf import hessian_psf_cube, hessian_psf_slice
    g = torch.Generator(device="cuda").manual_seed(0)
    nb, n = 4, 256
    psf = torch.randn(nb, 2 * n, 2 * n, device=cuda, generator=g)
    x = torch.randn(nb, n, n, device=cuda, generator=g)
    beam = torch.rand(nb, n, n, device=cuda, generator=g) + 0.5
    ph = make_psfhat(psf)
    cube = hessian_psf_cube(x, ph, beam=beam, sigmainv=1e-3, wsum=3.0)
    for b in range(nb):
        got = hessian_psf_slice(x[b], ph[b], beam=beam[b], sigmainv=1e-3,
                                wsum=3.0)
        assert _ok(got, cube[b])


@pytest.mark.parametrize("band_chunk", [1, 3])
def test_psfhat_band_chunk_on_card_matches_unchunked(cuda, band_chunk):
    from pfb_tpu_torch.ops.fft import make_psfhat
    from pfb_tpu_torch.ops.mmfft import make_full_psfhat
    g = torch.Generator(device="cuda").manual_seed(1)
    psf = torch.randn(8, 384, 384, device=cuda, generator=g)
    ref = make_psfhat(psf)
    got = make_psfhat(psf, band_chunk=band_chunk)
    assert got.is_cuda and got.shape == ref.shape
    assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())
    hr0, hi0 = make_full_psfhat(psf)
    hr, hi = make_full_psfhat(psf, band_chunk=band_chunk)
    scale = float(hr0.abs().max())
    assert float((hr - hr0).abs().max()) <= 1e-6 * scale
    assert float((hi - hi0).abs().max()) <= 1e-6 * scale


def test_dual_update_21_on_card_matches_cpu_float64(cuda):
    """float32 on the card against float64 on the CPU from the same
    float32 inputs, at chip_smoke.py phase 35's lam and sigma: 1e-6 of
    max. Where the threshold is a small share of the norm (lam 0.3 here)
    the formula's 1 - soft / vnorm cancels to about 0.05 and float32
    reads 1.1e-6 of max on the CPU too."""
    from pfb_tpu_torch.ops.prox import dual_update_21
    rng = np.random.default_rng(2)
    vp = rng.standard_normal((8, 3, 64, 48), dtype=np.float32)
    v = rng.standard_normal(vp.shape, dtype=np.float32)
    w = rng.random(vp.shape[1:], dtype=np.float32) + 0.5
    vp[:, 0, :4] = v[:, 0, :4] = 0.0
    ref = dual_update_21(torch.as_tensor(vp, dtype=torch.float64),
                         torch.as_tensor(v, dtype=torch.float64), 5.0,
                         sigma=1.7, weight=torch.as_tensor(
                             w, dtype=torch.float64))
    got = dual_update_21(torch.as_tensor(vp, device=cuda),
                         torch.as_tensor(v, device=cuda), 5.0, sigma=1.7,
                         weight=torch.as_tensor(w, device=cuda))
    assert got.dtype == torch.float32
    assert float((got.cpu().double() - ref).abs().max()) <= \
        1e-6 * float(ref.abs().max())
    assert not got[:, 0, :4].any()


# S1 / S2 (csrc/sara.cu): psi_dot and psi_hdot's kernel route against the
# plain route, both float32 on the card. The plain route is strided conv1d
# with TF32 off; the kernels' FMAs sum the taps in another order.
def _sara_cases():
    from pfb_tpu_torch.ops.filters import dwt_max_level
    big = [((8, 2048, 2048), ("self", "db1", "db2"), (3,)),
           ((2, 3072, 3072), ("self", "db1", "db2"), (3,))]
    return big + [((nb, nx, ny), ("self", w),
                   tuple(range(1, dwt_max_level(min(nx, ny), w) + 1)))
                  for nb, nx, ny in ((3, 1350, 1000), (2, 64, 48),
                                     (1, 100, 100))
                  for w in ("db1", "db2", "db3", "db4")]


def _sara_id(case):
    (nb, nx, ny), bases, _ = case
    return f"{nb}x{nx}x{ny}-{'+'.join(bases)}"


@pytest.mark.parametrize("case", _sara_cases(), ids=_sara_id)
def test_sara_kernels_match_plain(cuda, case):
    """Every level count of the case: both directions within 1e-5 of
    max|plain|, the slots' pad and uncovered area exactly 0, psi.kernel
    counting each call and S1 / S2 launching."""
    from pfb_tpu_torch.ops import psi as P
    from pfb_tpu_torch.utils import profiling
    shape, bases, levels = case
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = torch.randn(shape, generator=g, device=cuda)
    for nl in levels:
        p = P.make_psi(shape[1], shape[2], bases, nl)
        a = torch.randn((shape[0], p.nbasis, p.Nymax, p.Nxmax), generator=g,
                        device=cuda)
        n0 = (P.psi_dot.launches, P.psi_hdot.launches)
        profiling.reset()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            c = P.psi_dot(x, p)
            h = P.psi_hdot(a, p)
            counts = profiling.counters()
        profiling.reset()
        torch.cuda.synchronize()
        assert counts.get("psi.kernel") == 2 and "psi.plain" not in counts
        assert P.psi_dot.launches - n0[0] == nl + bool(
            P.sara_plan(p, shape[0]).rects)
        assert P.psi_hdot.launches - n0[1] == nl
        ref = P.psi_dot_plain(x, p)
        assert _ok(c, ref), (nl, float((c - ref).abs().max()))
        href = P.psi_hdot_plain(a, p)
        assert _ok(h, href), (nl, float((h - href).abs().max()))
        for off, y0, y1, x0, x1 in P.sara_plan(p, shape[0]).rects:
            s = off // (p.Nymax * p.Nxmax)
            assert not c[:, s, y0:y1, x0:x1].any()


@pytest.mark.parametrize("shape", [(8, 2048, 2048), (2, 100, 100)])
def test_sara_kernels_adjoint_and_round_trip(cuda, shape):
    """<psi_dot(x), a> = <x, psi_hdot(a)> and psi_hdot(psi_dot(x)) =
    nbasis x, on the kernel route (sums in float64 on the card)."""
    from pfb_tpu_torch.ops import psi as P
    p = P.make_psi(shape[1], shape[2], ("self", "db1", "db2"), 3)
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(shape, generator=g, device=cuda)
    a = torch.randn((shape[0], p.nbasis, p.Nymax, p.Nxmax), generator=g,
                    device=cuda)
    lhs = (P.psi_dot(x, p).double() * a.double()).sum()
    rhs = (x.double() * P.psi_hdot(a, p).double()).sum()
    assert abs(float(lhs - rhs)) <= 1e-5 * float(
        (x.double().norm() * a.double().norm()))
    back = P.psi_hdot(P.psi_dot(x, p), p)
    assert _ok(back, p.nbasis * x)
