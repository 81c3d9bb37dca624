"""Batched c2c DFTs for the w-stacking gridder's plane transforms
(counterpart of pfb_tpu/ops/pallas_cfft.py).

:func:`fftx_c2c` is the unnormalised c2c DFT along axis -2 of a
(P, Nin, L) plane stack with the gridder's roll/crop absorbed:

- ``in_rolled``: the N/2 image rows sit at (i - N/4) mod N (no pad or
  roll pass);
- ``out_rolled``: only rows (r - N/4) mod N, r < N/2 are emitted (no
  roll or crop pass).

A CUDA float32 stack runs a hand-written kernel, chosen by
:func:`fftx_c2c_route` (:func:`cluster_route`, :func:`row_route`,
:func:`cols_long_route`, :func:`rows_long_route`,
:func:`four_step_route`, in that order): the strided x pass (L > 1) at
256 <= N <= 16384
runs the cluster column FFT :func:`fftx_c2c_cluster`
(``csrc/cfft_cols.cu``: a cluster of C blocks shares a tile of W columns
through distributed shared memory; below 2048 one block or a cluster of
``_TINY_C`` = 2, :func:`cluster_shape`, and tiles of up to 32 columns);
contiguous rows (L = 1) at N = 256 R2, R2 a 5-smooth radix from 1 to 64
(256-16384), run the row FFT
:func:`fftx_c2c_rows` (``csrc/cfft_rows.cu``: three register stages, two
transposes through shared memory, several lines a block below 2048);
above 16384 the x pass at N = 8 x 256 R2 (R2 = 9, 10, 12, 15, 16)
runs the long column kernel :func:`fftx_c2c_cols_long` (K3xl,
``csrc/cfft_cols_long.cu``: clusters of 8 blocks, each block's lines of
N / 8 by the register row FFT) and the rows of N = 2 x 256 R2 (R2 =
36-64, the PSF grids of the 128-aligned images from 4608^2 to 8192^2)
the long row kernel :func:`fftx_c2c_rows_long` (K3yl,
``csrc/cfft_rows_long.cu``: two blocks a row, the radix-2 step on the
loads, then the register row FFT of N / 2 a block), each one HBM read
and one write; the other passes above 16384 run the four-step
:func:`fftx_c2c_four` (``csrc/cfft_four.cu``, then the cluster kernel
at N / 8); everything
else ``line_fft_kernel`` (``csrc/cfft.cu``, whole lines in one block, up
to 16384): no pass of a 128-aligned sigma-2 grid takes it, only rows no
multiple of 256, N % 4 != 0 and N < 256. A CPU stack runs the plain
version :func:`fftx_c2c_plain` (``torch.fft`` with the roll/crop written
out).
The y pass of :func:`fft2_c2c_pruned` runs the same transform on
contiguous rows, viewing (P, nrow, Ny) as (P*nrow, Ny, 1), so no
transpose pass is needed.

Lab entries sit beside it (scripts/torch_g2i_lab.py,
scripts/torch_kernel_lab.py --long), and no imaging path calls them:

- :func:`fftx_c2c_lab`: K3 with launch parameters, lines per block ``S``
  and the plan cut to its first radix pass (``npass=1``, timing only);
- :func:`fftx_c2c_split`: the x pass of the JAX package's
  ``fftx_c2c(precision="split")``, a four-step transform whose real
  products are three bf16 products each, on the tensor cores
  (``csrc/cfft_split.cu``), with its plain version
  :func:`fftx_c2c_split_plain` (the same split products as torch
  matmuls). pg_stream's blocked engine keeps the float32 K3;
- above 16384 the one-pass designs that measured slower than the
  four-step: :func:`fftx_c2c_cluster_long` (K3cl, the cluster column
  kernel's Stockham passes on long tiles) and :func:`fftx_c2c_four_rows`
  (K3fr, eight blocks a row), and :func:`fftx_c2c_four` itself at the
  lengths K3xl and K3yl took from it.
"""

import math
from functools import lru_cache

import numpy as np
import torch

from pfb_tpu_torch import kernels

__all__ = ["fftx_c2c", "fftx_c2c_plain", "fft2_c2c_pruned",
           "cfft_supported", "cluster_route", "cluster_shape",
           "fftx_c2c_cluster", "fftx_c2c_cluster_plain",
           "fftx_c2c_cluster_skeleton_plain", "row_route", "row_radices",
           "fftx_c2c_rows", "fftx_c2c_rows_plain",
           "fftx_c2c_rows_skeleton_plain", "four_step_route",
           "four_step_fits", "fftx_c2c_four", "fftx_c2c_four_plain",
           "cols_long_route", "fftx_c2c_cols_long",
           "fftx_c2c_cols_long_plain", "cluster_long_fits",
           "fftx_c2c_cluster_long",
           "rows_long_route",
           "fftx_c2c_rows_long", "fftx_c2c_rows_long_plain",
           "four_rows_fits", "fftx_c2c_four_rows",
           "fftx_c2c_route",
           "fftx_c2c_lab",
           "fftx_c2c_first_pass_plain", "fftx_c2c_split",
           "fftx_c2c_split_plain"]

_LINE_ELEMS = 8192  # csrc/fft_lines.cuh: kLineElems
_LINE_MAX_N = 16384  # csrc/fft_lines.cuh: kMaxN
_CLUSTER_MIN_N = 256  # csrc/psf_cols.cuh: kColsMinNX
_SHORT_N = 2048  # csrc/psf_cols.cuh: kShortNX
_SHORT_C = 4  # clusters from 2048 to 4096, csrc/psf_cols.cuh: kShortClusters
_TINY_C = 2  # clusters below 2048, csrc/psf_cols.cuh: kTinyClusters
_LONG_C, _LONG_W = 8, 4  # K3cl's clusters and tile width above 16384
_LONG_ELEMS = 16384  # its tile, csrc/fft_lines.cuh: kLongLineElems
# csrc/cfft_cols_long.cu instances (K3xl): 8 x 256 R2, R2 = 9, 10, 12, 15, 16
_COLS_LONG_LENGTHS = (18432, 20480, 24576, 30720, 32768)
# csrc/cfft_rows.cu and csrc/psf_rows*.cu instances (csrc/psf_rows.cuh:
# psf_rows_fused): 256 R2 for every 5-smooth R2 from 1 to 64
_ROW_RADICES = (1, 2, 3, 4, 5, 6, 8, 9, 10, 12, 15, 16, 18, 20, 24, 25, 27,
                30, 32, 36, 40, 45, 48, 50, 54, 60, 64)
_ROW_LENGTHS = tuple(256 * r for r in _ROW_RADICES)


def _factor(N):
    """N = N1 * N2 with N2 the largest divisor <= sqrt(N) (the split of
    pfb_tpu/ops/pallas_fft.py:_factor)."""
    for n2 in range(int(N ** 0.5), 0, -1):
        if N % n2 == 0:
            return N // n2, n2
    return N, 1


def _smooth(m):
    """Whether m has no prime factor but 2, 3 and 5 (the kernels'
    plans, csrc/fft_lines.cuh:make_plan)."""
    for p in (2, 3, 5):
        while m % p == 0:
            m //= p
    return m == 1


def cfft_supported(N):
    """The shapes the TPU route takes (quarter-aligned factor blocks,
    128-aligned length); the gridder routes to the kernel on the same
    rule."""
    N1, N2 = _factor(N)
    return N % 128 == 0 and N1 % 4 == 0 and N2 % 4 == 0


def _rolled_index(N, device):
    return (torch.arange(N // 2, device=device) - N // 4) % N


def _full_rows(z, N, in_rolled):
    """z with its N/2 image rows placed at (i - N/4) mod N when
    ``in_rolled`` (zeros elsewhere), else z."""
    if not in_rolled:
        return z
    full = torch.zeros(z.shape[:-2] + (N, z.shape[-1]), dtype=z.dtype,
                       device=z.device)
    full[..., _rolled_index(N, z.device), :] = z
    return full


def _out_rows(y, N, out_rolled):
    """(re, im) of y, only the rows (r - N/4) mod N, r < N/2 when
    ``out_rolled``."""
    if out_rolled:
        y = y[..., _rolled_index(N, y.device), :]
    return y.real.contiguous(), y.imag.contiguous()


def fftx_c2c_plain(xr, xi, *, N, inverse=False, in_rolled=False,
                   out_rolled=False):
    """Plain version of the kernels: torch.fft along dim -2."""
    z = _full_rows(torch.complex(xr, xi), N, in_rolled)
    y = torch.fft.ifft(z, dim=-2) * N if inverse else \
        torch.fft.fft(z, dim=-2)
    return _out_rows(y, N, out_rolled)


def _check_stack(name, xr, xi, N, in_rolled, out_rolled):
    """(P, Nin, L) of an x-pass operand; raises on the wrong row count,
    rolled modes at N % 4 != 0, or re and im of different shapes."""
    P, Nin, L = xr.shape
    if Nin != (N // 2 if in_rolled else N):
        raise ValueError(f"{name}: {Nin} input rows for N={N}, "
                         f"in_rolled={in_rolled}")
    if (in_rolled or out_rolled) and N % 4:
        raise ValueError(f"{name}: rolled modes need N % 4 == 0, N={N}")
    if xi is not None and xi.shape != xr.shape:
        raise ValueError(f"{name}: shapes {xr.shape} != {xi.shape}")
    return P, Nin, L


def cluster_route(N, L):
    """Whether :func:`fftx_c2c` on a CUDA stack launches the cluster
    column kernel (``csrc/cfft_cols.cu``): the strided x pass (L > 1) at
    N >= 256 (from 2048, where ``line_fft_kernel`` fits one to four
    columns in a block and its warps use 4-16 bytes of each 32-byte
    sector, on clusters; below, where a column fits a block, on clusters
    of ``_TINY_C`` blocks with wider tiles and 16-byte loads), on the
    shapes the kernel takes (N % 4 == 0 and a tile of :func:`cluster_
    shape` within a block's 8192 values: N <= 16384, or <= 8192 where 8
    does not divide N; N / C a product of 2, 3 and 5). The y pass (L = 1,
    contiguous rows), N < 256, N % 4 != 0 and the other N keep
    ``line_fft_kernel``."""
    if L < 2 or N < _CLUSTER_MIN_N or N % 4:
        return False
    C, W = cluster_shape(N)
    return (N // C) * W <= _LINE_ELEMS and _smooth(N // C)


def cluster_shape(N):
    """(C, W) of the cluster kernel at N: C blocks a cluster (8 above
    4096 where 8 divides N, 4 at 4096 and the others, ``_SHORT_C`` from
    2048 to 4096, one or ``_TINY_C`` below 2048) and tiles of W columns
    (csrc/psf_cols.cuh:cols_tile_width, which M = N / C sets): from 2048,
    8 (a full 32-byte sector of re and of im a row) where the block's W
    lines of M fit 8192 complex values, else 4 (N = 12288, 16384); below
    2048 (csrc/psf_cols.cuh:tiny_clusters) one block where its tile, the
    widest of 32, 16, 8 and 4 that fits, is 8 columns (768 and 1024),
    else ``_TINY_C`` = 2 blocks (32 columns at 256 and 512, 8 at 1280 and
    1536)."""
    if N % 4:
        raise ValueError(f"fftx_c2c_cluster: N={N} is not a multiple of 4")
    if N < _SHORT_N:
        C = 1 if _tiny_width(N) == 8 else _TINY_C
        return C, _tiny_width(N // C)
    C = _SHORT_C if N < 4096 else 8 if N > 4096 and N % 8 == 0 else 4
    return C, (8 if (N // C) * 8 <= _LINE_ELEMS else 4)


def _tiny_width(M):
    """Columns of a tile of lines of M below 2048: the widest of 32, 16,
    8 and 4 within a block's 8192 values."""
    W = 32
    while W > 4 and M * W > _LINE_ELEMS:
        W //= 2
    return W


def row_route(N, L):
    """Whether :func:`fftx_c2c` on a CUDA stack launches the row kernel
    (``csrc/cfft_rows.cu``, K3r): contiguous rows (L = 1, the y pass) at
    the lengths it is built for, N = 16 R2 16 with R2 a 5-smooth radix
    from 1 to 64 (:data:`_ROW_LENGTHS`, 256-16384: the y pass of every
    128-aligned image grid from 128^2 to 8192^2 and of its PSF grid up
    to 4096^2; below 2048, 16 / R2 lines a block). Other N (not a
    multiple of 256, or no instance) keep ``line_fft_kernel`` up to 16384
    and the routes above 16384 there.
    :func:`cluster_route` is asked first; the two never both hold (it
    needs L > 1)."""
    return L == 1 and N in _ROW_LENGTHS


def cols_long_route(N, L):
    """Whether :func:`fftx_c2c` on a CUDA stack launches the long column
    kernel (:func:`fftx_c2c_cols_long`, K3xl, ``csrc/cfft_cols_long.cu``):
    the strided x pass (L > 1) above 16384 at N = 8 x 256 R2, R2 = 9, 10,
    12, 15, 16 (18432, 20480, 24576, 30720, 32768: the PSF grids of the
    128-aligned images 4608^2, 5120^2, 6144^2, 7680^2 and 8192^2); a
    cluster of 8 blocks a tile, each line's DFT a register row FFT."""
    return L > 1 and N in _COLS_LONG_LENGTHS


def cluster_long_fits(N, L):
    """Whether the lab's cluster column kernel on long tiles
    (:func:`fftx_c2c_cluster_long`, K3cl) takes a (P, ., L) stack: the
    strided x pass (L > 1) above 16384 up to 8 x 4096 = 32768 where N / 8
    is a product of 2, 3 and 5: clusters of 8 blocks, each 4 lines of N /
    8 (up to 16384 values, one block an SM)."""
    return L > 1 and _LINE_MAX_N < N <= _LONG_C * _LONG_ELEMS // _LONG_W \
        and N % _LONG_C == 0 and _smooth(N // _LONG_C)


def rows_long_route(N, L):
    """Whether :func:`fftx_c2c` on a CUDA stack launches the long row
    kernel (:func:`fftx_c2c_rows_long`, K3yl, ``csrc/cfft_rows_long.cu``):
    contiguous rows (L = 1, the y pass) above 16384 whose half is a
    length of the register row kernel, N = 2 x 256 R2 with R2 = 36, 40,
    45, 48, 50, 54, 60, 64 (18432-32768: the PSF grids of the 128-aligned
    images from 4608^2 to 8192^2); two blocks a row."""
    return L == 1 and N > _LINE_MAX_N and N % 2 == 0 and \
        N // 2 in _ROW_LENGTHS


def four_rows_fits(N, L):
    """Whether the lab's eight-block row kernel (:func:`fftx_c2c_four_rows`,
    ``csrc/cfft_four_rows.cu``) takes a (P, ., L) stack: rows (L = 1)
    above 16384, N = 8 M with M <= 16384 a product of 2, 3 and 5."""
    return L == 1 and N > _LINE_MAX_N and N % 8 == 0 and \
        N // 8 <= _LINE_MAX_N and _smooth(N // 8)


def four_step_fits(N, L):
    """Whether the four-step :func:`fftx_c2c_four` (K3f, then the cluster
    kernel at N / 8) takes a (P, ., L) stack of length N: N > 16384, N %
    32 == 0 (the cluster kernel keeps the rolled rows at M = N / 8) and
    M on the cluster route with 8 L columns; up to 8 x 16384."""
    return N > _LINE_MAX_N and N % 32 == 0 and cluster_route(N // 8, 8 * L)


def four_step_route(N, L):
    """Whether :func:`fftx_c2c` on a CUDA stack runs the four-step
    :func:`fftx_c2c_four` (``csrc/cfft_four.cu``, K3f, then the cluster
    kernel at N / 8): where it fits (:func:`four_step_fits`) and no kernel
    of one pass takes the length: the x pass at the other lengths (23040,
    25600, 27648 among the PSF grids of 4608^2-8192^2, whose N / 8 is no
    multiple of 256, and above 32768) and the rows whose half is no length
    of the register row kernel (``line_fft_kernel`` stops at its kMaxN,
    the cluster kernel at a tile of 8192 values, the row kernels at R2 =
    64)."""
    return four_step_fits(N, L) and not cols_long_route(N, L) and \
        not rows_long_route(N, L)


def fftx_c2c_route(N, L):
    """The kernel :func:`fftx_c2c` runs on a CUDA (P, ., L) stack of
    length N: "cluster", "rows", "cols_long", "rows_long", "four" or
    "line"; ValueError where none takes it (N above 16384 off the routes
    above 16384)."""
    if cluster_route(N, L):
        return "cluster"
    if row_route(N, L):
        return "rows"
    if cols_long_route(N, L):
        return "cols_long"
    if rows_long_route(N, L):
        return "rows_long"
    if four_step_route(N, L):
        return "four"
    if N > _LINE_MAX_N:
        raise ValueError(f"fftx_c2c: no kernel takes N={N}, L={L} (the "
                         f"line kernel stops at {_LINE_MAX_N}; above it "
                         "the kernels need N/8 a product of 2, 3 and 5, "
                         "the four-step N % 32 == 0 and N/8 on the "
                         "cluster route)")
    return "line"


def fftx_c2c(xr, xi, *, N, inverse=False, in_rolled=False,
             out_rolled=False):
    """Unnormalised c2c DFT along axis -2 of a (P, Nin, L) stack
    (Nin = N, or N/2 when ``in_rolled``); output (P, Nout, L) with
    Nout = N or N/2 (``out_rolled``). Forward e^-, inverse e^+, no 1/N.
    ``xi`` may be None for a real input. A CUDA stack launches the
    kernel :func:`fftx_c2c_route` names, else ``line_fft_kernel``.
    ``fftx_c2c.launches`` counts the launches of ``line_fft_kernel``;
    ``fftx_c2c_cluster.launches``, ``fftx_c2c_rows.launches``,
    ``fftx_c2c_cols_long.launches``, ``fftx_c2c_rows_long.launches``
    and ``fftx_c2c_four.launches`` those of the others (the four-step's
    cluster step counts as the cluster kernel's)."""
    P, Nin, L = _check_stack("fftx_c2c", xr, xi, N, in_rolled, out_rolled)
    if not xr.is_cuda:
        xi_ = torch.zeros_like(xr) if xi is None else xi
        return fftx_c2c_plain(xr, xi_, N=N, inverse=inverse,
                              in_rolled=in_rolled, out_rolled=out_rolled)
    kernels.require_cuda_f32("fftx_c2c", xr, xi)
    kw = dict(N=N, inverse=inverse, in_rolled=in_rolled,
              out_rolled=out_rolled)
    route = fftx_c2c_route(N, L)
    if route == "cluster":
        return fftx_c2c_cluster(xr, xi, **kw)
    if route == "rows":
        return fftx_c2c_rows(xr, xi, **kw)
    if route == "cols_long":
        return fftx_c2c_cols_long(xr, xi, **kw)
    if route == "rows_long":
        return fftx_c2c_rows_long(xr, xi, **kw)
    if route == "four":
        return fftx_c2c_four(xr, xi, **kw)
    Nout = N // 2 if out_rolled else N
    yr = torch.empty((P, Nout, L), dtype=torch.float32, device=xr.device)
    yi = torch.empty_like(yr)
    W = kernels.twiddles(N, xr.device)
    code = kernels.library().pfbt_cfft(
        xr.data_ptr(), None if xi is None else xi.data_ptr(),
        yr.data_ptr(), yi.data_ptr(), P, L, N, Nin, Nout,
        int(in_rolled), int(out_rolled), int(inverse), W.data_ptr(),
        kernels.stream_ptr())
    kernels.check(code, "fftx_c2c")
    fftx_c2c.launches += 1
    return yr, yi


fftx_c2c.launches = 0


# ---------------------------------------------------------------------
# the cluster column kernel (K3's x pass at N >= 256)


def fftx_c2c_cluster_plain(xr, xi, *, N, C, inverse=False, in_rolled=False,
                           out_rolled=False):
    """Plain version of the cluster kernel's steps as torch operations:
    decimate n = c + C m, the M-point DFTs Y_c[k1] (M = N / C), the
    twiddles W_N^{c k1} (float64, rounded once to the working type), the
    C-point DFTs X[k1 + M k2] = sum_c W_C^{c k2} Z_c[k1], and the rolled
    row selection. Same shapes and conventions as :func:`fftx_c2c`."""
    if N % C:
        raise ValueError(f"fftx_c2c_cluster_plain: C={C} does not divide "
                         f"N={N}")
    M = N // C
    z = _full_rows(torch.complex(xr, xi), N, in_rolled)
    P, _, L = z.shape
    zz = z.reshape(P, M, C, L)  # [m, c] = x[c + C m]
    Y = torch.fft.ifft(zz, dim=1) * M if inverse else torch.fft.fft(zz,
                                                                   dim=1)
    sign = 1.0 if inverse else -1.0
    e = torch.outer(torch.arange(M, dtype=torch.float64),
                    torch.arange(C, dtype=torch.float64))
    tw = torch.polar(torch.ones_like(e), sign * 2.0 * np.pi * e / N)
    Z = Y * tw.to(Y.dtype).to(Y.device)[None, :, :, None]
    X = torch.fft.ifft(Z, dim=2) * C if inverse else torch.fft.fft(Z, dim=2)
    return _out_rows(X.transpose(1, 2).reshape(P, N, L), N, out_rolled)


def fftx_c2c_cluster_skeleton_plain(xr, xi, *, N, C, in_rolled=False,
                                    out_rolled=False):
    """Plain version of the cluster kernel's skeleton (its loads,
    exchange and stores with the FFT passes compiled out): X[k1 + M c] =
    x[c + C k1], rows selected as :func:`fftx_c2c` selects them."""
    M = N // C
    z = _full_rows(torch.complex(xr, xi), N, in_rolled)
    P, _, L = z.shape
    return _out_rows(z.reshape(P, M, C, L).transpose(1, 2).reshape(P, N, L),
                     N, out_rolled)


def fftx_c2c_cluster(xr, xi, *, N, inverse=False, in_rolled=False,
                     out_rolled=False, skeleton=False):
    """K3's x pass on the cluster column kernel (``csrc/cfft_cols.cu``):
    same shapes and conventions as :func:`fftx_c2c`, one HBM read of
    the input and one write of the output, on clusters of C blocks and
    tiles of W columns from :func:`cluster_shape`; raises where (N / C) W
    exceeds a block's 8192 values (N > 16384). ``skeleton=True``
    launches the lab's load/exchange/store skeleton
    (:func:`fftx_c2c_cluster_skeleton_plain`). A CPU stack runs the
    plain versions."""
    P, Nin, L = _check_stack("fftx_c2c_cluster", xr, xi, N, in_rolled,
                             out_rolled)
    C, W = cluster_shape(N)
    if (N // C) * W > _LINE_ELEMS:
        raise ValueError(f"fftx_c2c_cluster: N={N} exceeds a block's "
                         f"{_LINE_ELEMS} values at C={C}, W={W}")
    kw = dict(N=N, C=C, in_rolled=in_rolled, out_rolled=out_rolled)
    if not xr.is_cuda:
        xi_ = torch.zeros_like(xr) if xi is None else xi
        if skeleton:
            return fftx_c2c_cluster_skeleton_plain(xr, xi_, **kw)
        return fftx_c2c_cluster_plain(xr, xi_, inverse=inverse, **kw)
    kernels.require_cuda_f32("fftx_c2c_cluster", xr, xi)
    Nout = N // 2 if out_rolled else N
    yr = torch.empty((P, Nout, L), dtype=torch.float32, device=xr.device)
    yi = torch.empty_like(yr)
    code = kernels.library().pfbt_cfft_cols(
        xr.data_ptr(), None if xi is None else xi.data_ptr(),
        yr.data_ptr(), yi.data_ptr(), P, L, N, Nin, Nout, int(in_rolled),
        int(out_rolled), int(inverse), C, W, int(skeleton),
        kernels.twiddles(N // C, xr.device).data_ptr(),
        kernels.twiddles(N, xr.device, kind="cols").data_ptr(),
        kernels.stream_ptr())
    kernels.check(code, "fftx_c2c_cluster")
    fftx_c2c_cluster.launches += 1
    return yr, yi


fftx_c2c_cluster.launches = 0


# ---------------------------------------------------------------------
# the row kernel (K3's y pass on contiguous rows)


def row_radices(N):
    """The three stage radices (R1, R2, R3) of the row kernel's plan:
    R1 = gcd(N, 16), R3 = gcd(N / R1, 16), R2 the rest; (16, N/256, 16)
    wherever 256 divides N, which the kernel's lengths do."""
    r1 = math.gcd(N, 16)
    r3 = math.gcd(N // r1, 16)
    return r1, N // (r1 * r3), r3


def _row_line(xr, xi, N, in_rolled):
    """The (P, N) complex lines of a (P, Nin, 1) row stack; ``in_rolled``
    places input chunk [N/4, N/2) at [0, N/4) and chunk [0, N/4) at
    [3N/4, N), with zeros between (the kernel's chunk offsets)."""
    z = torch.complex(xr, xi)[..., 0]
    if in_rolled:
        q = N // 4
        z = torch.cat([z[:, q:2 * q], z.new_zeros((z.shape[0], N // 2)),
                       z[:, :q]], dim=1)
    return z


def _row_out(X, N, out_rolled):
    """(re, im) (P, Nout, 1) of the (P, N) spectra; ``out_rolled`` keeps
    X[3N/4:] then X[:N/4] (row r holds X[(r - N/4) mod N])."""
    if out_rolled:
        q = N // 4
        X = torch.cat([X[:, 3 * q:], X[:, :q]], dim=1)
    return X.real.contiguous()[..., None], X.imag.contiguous()[..., None]


def _row_stages(z, N, inverse, fft=True, nin=None):
    """The row kernel's Stockham stages on (P, N) lines: stage (R, Ns)
    reads n = j + q N/R (j = jq Ns + k), multiplies by W_{Ns R}^{q k}
    (float64, rounded once to the working type), takes the R-point DFT
    over q and writes jq Ns R + q Ns + k. ``fft=False`` keeps the index
    algebra alone (the skeleton). With ``nin``, z is (P, nin), the first
    nin values of lines zero-padded to N, and stage 1 reads only the rows
    q that hold them (n < nin), as the PSF rows kernel does."""
    P = z.shape[0]
    sign = 1.0 if inverse else -1.0
    Ns = 1
    for R in row_radices(N):
        nb = N // (R * Ns)
        if nin is not None and Ns == 1:
            Q = -(-nin // nb)
            x = torch.nn.functional.pad(z, (0, Q * nb - nin))
            x = x.reshape(P, Q, nb, 1)
        else:
            x = z.reshape(P, R, nb, Ns)  # [q, jq, k]
        if fft:
            if Ns > 1:
                e = torch.outer(torch.arange(R, dtype=torch.float64),
                                torch.arange(Ns, dtype=torch.float64))
                tw = torch.polar(torch.ones_like(e),
                                 sign * 2.0 * np.pi * e / (Ns * R))
                x = x * tw.to(z.dtype).to(z.device)[:, None, :]
            x = torch.fft.ifft(x, n=R, dim=1) * R if inverse else \
                torch.fft.fft(x, n=R, dim=1)
        z = x.transpose(1, 2).reshape(P, N)  # [jq, q, k]
        Ns *= R
    return z


def fftx_c2c_rows_plain(xr, xi, *, N, inverse=False, in_rolled=False,
                        out_rolled=False):
    """Plain version of the row kernel's steps as torch operations on a
    (P, Nin, 1) stack: the rolled chunk offsets, the three stages of
    :func:`row_radices` with their twiddles, and the kept half. Same
    conventions as :func:`fftx_c2c`; any N (the tests run lengths with
    factors 3 and 5 that the kernel is not built for)."""
    z = _row_stages(_row_line(xr, xi, N, in_rolled), N, inverse)
    return _row_out(z, N, out_rolled)


def fftx_c2c_rows_skeleton_plain(xr, xi, *, N, in_rolled=False,
                                 out_rolled=False):
    """Plain version of the row kernel's skeleton (its loads, two
    transposes and stores with the radix arithmetic and twiddles
    compiled out): the stages' index permutation alone."""
    z = _row_stages(_row_line(xr, xi, N, in_rolled), N, False, fft=False)
    return _row_out(z, N, out_rolled)


def fftx_c2c_rows(xr, xi, *, N, inverse=False, in_rolled=False,
                  out_rolled=False, skeleton=False):
    """K3's y pass on the row kernel (``csrc/cfft_rows.cu``): the DFT of
    each contiguous row of a (P, Nin, 1) stack, same conventions as
    :func:`fftx_c2c`, one HBM read of the input and one write of the
    output; raises where :func:`row_route` does not hold (L > 1 or N
    without an instance). ``skeleton=True`` launches the lab's
    load/transpose/store skeleton (:func:`fftx_c2c_rows_skeleton_plain`).
    A CPU stack runs the plain versions."""
    P, Nin, L = _check_stack("fftx_c2c_rows", xr, xi, N, in_rolled,
                             out_rolled)
    if not row_route(N, L):
        raise ValueError(f"fftx_c2c_rows: N={N}, L={L}; the row kernel "
                         f"takes L = 1 and N in {_ROW_LENGTHS}")
    kw = dict(N=N, in_rolled=in_rolled, out_rolled=out_rolled)
    if not xr.is_cuda:
        xi_ = torch.zeros_like(xr) if xi is None else xi
        if skeleton:
            return fftx_c2c_rows_skeleton_plain(xr, xi_, **kw)
        return fftx_c2c_rows_plain(xr, xi_, inverse=inverse, **kw)
    kernels.require_cuda_f32("fftx_c2c_rows", xr, xi)
    if P > 0x7fffffff:
        raise ValueError(f"fftx_c2c_rows: {P} rows exceed one launch")
    Nout = N // 2 if out_rolled else N
    yr = torch.empty((P, Nout, 1), dtype=torch.float32, device=xr.device)
    yi = torch.empty_like(yr)
    code = kernels.library().pfbt_cfft_rows(
        xr.data_ptr(), None if xi is None else xi.data_ptr(),
        yr.data_ptr(), yi.data_ptr(), P, N, int(in_rolled), int(out_rolled),
        int(inverse), int(skeleton),
        kernels.twiddles(N, xr.device, kind="rows").data_ptr(),
        kernels.stream_ptr())
    kernels.check(code, "fftx_c2c_rows")
    fftx_c2c_rows.launches += 1
    return yr, yi


fftx_c2c_rows.launches = 0


# ---------------------------------------------------------------------
# the four-step above 16384 (K3f, then the cluster kernel at N / 8)


def fftx_c2c_four_first_plain(xr, xi, *, N, inverse=False,
                              in_rolled=False):
    """Plain version of K3f alone, the four-step's first steps as torch
    operations on a (P, Nin, L) stack, N = 8 M: x[n2 + M n1] as [n1, n2],
    the 8-point DFTs over n1, the twiddles W_N^(n2 k1) (float64, rounded
    once to the working type) and the reorder to [n2, k1]: the real and
    imaginary (P, M, 8 L) stacks whose M-point DFTs over n2 finish the
    transform. Any N % 8 == 0."""
    if N % 8:
        raise ValueError(f"fftx_c2c_four_plain: N={N} is not a multiple "
                         "of 8")
    M = N // 8
    z = _full_rows(torch.complex(xr, xi), N, in_rolled)
    P, _, L = z.shape
    zz = z.reshape(P, 8, M, L)  # [n1, n2] = x[n2 + M n1]
    Y = torch.fft.ifft(zz, dim=1) * 8 if inverse else torch.fft.fft(zz,
                                                                   dim=1)
    sign = 1.0 if inverse else -1.0
    e = torch.outer(torch.arange(8, dtype=torch.float64),
                    torch.arange(M, dtype=torch.float64))
    tw = torch.polar(torch.ones_like(e), sign * 2.0 * np.pi * e / N)
    T = (Y * tw.to(Y.dtype).to(Y.device)[None, :, :, None]).transpose(1, 2)
    T = T.reshape(P, M, 8 * L)
    return T.real.contiguous(), T.imag.contiguous()


def fftx_c2c_four_plain(xr, xi, *, N, inverse=False, in_rolled=False,
                        out_rolled=False):
    """Plain version of the four-step's steps as torch operations on a
    (P, Nin, L) stack: :func:`fftx_c2c_four_first_plain`, then the
    M-point DFTs over n2, whose [k2, k1] is X[k1 + 8 k2] in natural
    order, and the rolled row selection. Same conventions as
    :func:`fftx_c2c`; any N % 8 == 0."""
    tr, ti = fftx_c2c_four_first_plain(xr, xi, N=N, inverse=inverse,
                                       in_rolled=in_rolled)
    P, M, L = tr.shape[0], N // 8, tr.shape[2] // 8
    T = torch.complex(tr, ti).reshape(P, M, 8, L)
    X = torch.fft.ifft(T, dim=1) * M if inverse else torch.fft.fft(T, dim=1)
    return _out_rows(X.reshape(P, N, L), N, out_rolled)


def fftx_c2c_four(xr, xi, *, N, inverse=False, in_rolled=False,
                  out_rolled=False):
    """K3 above 16384 as a four-step N = 8 M: K3f (``csrc/cfft_four.cu``:
    the 8-point DFTs over the strided factor, the twiddles W_N^(n2 k1)
    and the reorder to a (P, M, 8, L) stack, one HBM read and one write)
    and the M-point DFTs on :func:`fftx_c2c` at M with 8 L columns (the
    cluster column kernel, which also keeps the rolled rows), whose rows
    are in natural order. Same shapes and conventions as
    :func:`fftx_c2c`; raises where :func:`four_step_fits` does not hold.
    :func:`fftx_c2c` takes it only on :func:`four_step_route`; at the
    lengths of K3xl and K3yl it is the lab's earlier route.
    ``fftx_c2c_four.launches`` counts K3f's launches. A CPU stack runs
    :func:`fftx_c2c_four_plain`."""
    P, Nin, L = _check_stack("fftx_c2c_four", xr, xi, N, in_rolled,
                             out_rolled)
    if not four_step_fits(N, L):
        raise ValueError(f"fftx_c2c_four: N={N}, L={L} does not fit the "
                         "four-step")
    kw = dict(N=N, inverse=inverse, in_rolled=in_rolled,
              out_rolled=out_rolled)
    if not xr.is_cuda:
        xi_ = torch.zeros_like(xr) if xi is None else xi
        return fftx_c2c_four_plain(xr, xi_, **kw)
    kernels.require_cuda_f32("fftx_c2c_four", xr, xi)
    M = N // 8
    tr = xr.new_empty((P, M, 8 * L))
    ti = xr.new_empty((P, M, 8 * L))
    code = kernels.library().pfbt_cfft_four(
        xr.data_ptr(), None if xi is None else xi.data_ptr(),
        tr.data_ptr(), ti.data_ptr(), P, L, N, int(in_rolled), int(inverse),
        kernels.twiddles(N, xr.device, kind="four").data_ptr(),
        kernels.stream_ptr())
    kernels.check(code, "fftx_c2c_four")
    fftx_c2c_four.launches += 1
    yr, yi = fftx_c2c(tr, ti, N=M, inverse=inverse, out_rolled=out_rolled)
    del tr, ti
    return yr.reshape(P, -1, L), yi.reshape(P, -1, L)


fftx_c2c_four.launches = 0


# ---------------------------------------------------------------------
# one pass above 16384: K3xl (x pass) and K3yl (y pass), and the lab's
# designs K3cl and K3fr


def fftx_c2c_cluster_long(xr, xi, *, N, inverse=False, in_rolled=False,
                          out_rolled=False, skeleton=False):
    """The lab's x pass above 16384 on the cluster column kernel with long
    tiles (K3cl, ``csrc/cfft_cols.cu``; no route takes it: its Stockham
    passes left it level with or slower than the four-step, PERF.md):
    clusters of 8 blocks, each 4 lines of N / 8, one HBM read of the input
    and one write of the output. Same shapes and conventions as
    :func:`fftx_c2c`; raises where :func:`cluster_long_fits` does not
    hold. ``skeleton=True`` launches its load/exchange/store skeleton. A
    CPU stack runs the plain versions (the cluster kernel's at C = 8)."""
    P, Nin, L = _check_stack("fftx_c2c_cluster_long", xr, xi, N, in_rolled,
                             out_rolled)
    if not cluster_long_fits(N, L):
        raise ValueError(f"fftx_c2c_cluster_long: N={N}, L={L} does not fit "
                         "its kernel")
    kw = dict(N=N, in_rolled=in_rolled, out_rolled=out_rolled)
    if not xr.is_cuda:
        xi_ = torch.zeros_like(xr) if xi is None else xi
        if skeleton:
            return fftx_c2c_cluster_skeleton_plain(xr, xi_, C=_LONG_C, **kw)
        return fftx_c2c_cluster_plain(xr, xi_, C=_LONG_C, inverse=inverse,
                                      **kw)
    kernels.require_cuda_f32("fftx_c2c_cluster_long", xr, xi)
    Nout = N // 2 if out_rolled else N
    yr = torch.empty((P, Nout, L), dtype=torch.float32, device=xr.device)
    yi = torch.empty_like(yr)
    code = kernels.library().pfbt_cfft_cols(
        xr.data_ptr(), None if xi is None else xi.data_ptr(),
        yr.data_ptr(), yi.data_ptr(), P, L, N, Nin, Nout, int(in_rolled),
        int(out_rolled), int(inverse), _LONG_C, _LONG_W, int(skeleton),
        kernels.twiddles(N // _LONG_C, xr.device).data_ptr(),
        kernels.twiddles(N, xr.device, kind="cols").data_ptr(),
        kernels.stream_ptr())
    kernels.check(code, "fftx_c2c_cluster_long")
    fftx_c2c_cluster_long.launches += 1
    return yr, yi


fftx_c2c_cluster_long.launches = 0


def fftx_c2c_cols_long_plain(xr, xi, *, N, inverse=False, in_rolled=False,
                             out_rolled=False):
    """Plain version of K3xl's steps as torch operations on a (P, Nin, L)
    stack, N = 8 M: rows n = c + 8 m of block c, the register row
    kernel's three stages on each line of M (:func:`row_radices` at M,
    twiddles float64 rounded once), the twiddles W_N^(c k1), the 8-point
    DFTs across the cluster, X[k1 + M k2] and the kept rows. Any N % 8 ==
    0 (the tests run lines that are no length of the kernel)."""
    if N % 8:
        raise ValueError(f"fftx_c2c_cols_long_plain: N={N} is not a "
                         "multiple of 8")
    M = N // 8
    z = _full_rows(torch.complex(xr, xi), N, in_rolled)
    P, _, L = z.shape
    lines = z.reshape(P, M, 8, L).permute(0, 2, 3, 1).reshape(-1, M)
    Y = _row_stages(lines, M, inverse).reshape(P, 8, L, M)
    Y = Y.permute(0, 3, 1, 2)  # [k1, c, l]
    sign = 1.0 if inverse else -1.0
    e = torch.outer(torch.arange(M, dtype=torch.float64),
                    torch.arange(8, dtype=torch.float64))
    tw = torch.polar(torch.ones_like(e), sign * 2.0 * np.pi * e / N)
    Z = Y * tw.to(Y.dtype).to(Y.device)[None, :, :, None]
    X = torch.fft.ifft(Z, dim=2) * 8 if inverse else torch.fft.fft(Z, dim=2)
    return _out_rows(X.transpose(1, 2).reshape(P, N, L), N, out_rolled)


def fftx_c2c_cols_long(xr, xi, *, N, inverse=False, in_rolled=False,
                       out_rolled=False):
    """K3's x pass above 16384 on the long column kernel (K3xl,
    ``csrc/cfft_cols_long.cu``): a cluster of 8 blocks a tile of 8 (N <=
    24576) or 4 columns, each block's lines of N / 8 by the register row
    FFT, then the 8-point DFTs across the cluster through distributed
    shared memory; one HBM read of the input and one write of the output.
    Same shapes and conventions as :func:`fftx_c2c`; raises where
    :func:`cols_long_route` does not hold. A CPU stack runs
    :func:`fftx_c2c_cols_long_plain`."""
    P, Nin, L = _check_stack("fftx_c2c_cols_long", xr, xi, N, in_rolled,
                             out_rolled)
    if not cols_long_route(N, L):
        raise ValueError(f"fftx_c2c_cols_long: N={N}, L={L} is off its "
                         "route")
    kw = dict(N=N, inverse=inverse, in_rolled=in_rolled,
              out_rolled=out_rolled)
    if not xr.is_cuda:
        xi_ = torch.zeros_like(xr) if xi is None else xi
        return fftx_c2c_cols_long_plain(xr, xi_, **kw)
    kernels.require_cuda_f32("fftx_c2c_cols_long", xr, xi)
    Nout = N // 2 if out_rolled else N
    yr = torch.empty((P, Nout, L), dtype=torch.float32, device=xr.device)
    yi = torch.empty_like(yr)
    code = kernels.library().pfbt_cfft_cols_long(
        xr.data_ptr(), None if xi is None else xi.data_ptr(),
        yr.data_ptr(), yi.data_ptr(), P, L, N, int(in_rolled),
        int(out_rolled), int(inverse),
        kernels.twiddles(N // 8, xr.device, kind="rows").data_ptr(),
        kernels.twiddles(N, xr.device, kind="cols").data_ptr(),
        kernels.stream_ptr())
    kernels.check(code, "fftx_c2c_cols_long")
    fftx_c2c_cols_long.launches += 1
    return yr, yi


fftx_c2c_cols_long.launches = 0


def fftx_c2c_four_rows(xr, xi, *, N, inverse=False, in_rolled=False,
                       out_rolled=False):
    """The lab's eight-block row kernel above 16384 (K3fr,
    ``csrc/cfft_four_rows.cu``; no route takes it: it measured slower than
    the four-step it was to replace, PERF.md): the DFT of each contiguous
    row of a (P, Nin, 1) stack on a cluster of 8 blocks a row (the radix-8
    step across the cluster through distributed shared memory, then an
    N/8-point DFT a block in shared memory), one HBM read of the input
    and one write of the output. Same conventions as :func:`fftx_c2c`;
    raises where :func:`four_rows_fits` does not hold. A CPU stack runs
    the four-step's plain version (:func:`fftx_c2c_four_plain`: the same
    steps, the radix-8 over n1, the twiddles and the N/8-point DFTs)."""
    P, Nin, L = _check_stack("fftx_c2c_four_rows", xr, xi, N, in_rolled,
                             out_rolled)
    if not four_rows_fits(N, L):
        raise ValueError(f"fftx_c2c_four_rows: N={N}, L={L} does not fit "
                         "its kernel")
    kw = dict(N=N, inverse=inverse, in_rolled=in_rolled,
              out_rolled=out_rolled)
    if not xr.is_cuda:
        xi_ = torch.zeros_like(xr) if xi is None else xi
        return fftx_c2c_four_plain(xr, xi_, **kw)
    kernels.require_cuda_f32("fftx_c2c_four_rows", xr, xi)
    if P * 8 > 0x7fffffff:
        raise ValueError(f"fftx_c2c_four_rows: {P} rows exceed one launch")
    Nout = N // 2 if out_rolled else N
    yr = torch.empty((P, Nout, 1), dtype=torch.float32, device=xr.device)
    yi = torch.empty_like(yr)
    code = kernels.library().pfbt_cfft_four_rows(
        xr.data_ptr(), None if xi is None else xi.data_ptr(),
        yr.data_ptr(), yi.data_ptr(), P, N, int(in_rolled), int(out_rolled),
        int(inverse), kernels.twiddles(N // 8, xr.device).data_ptr(),
        kernels.twiddles(N, xr.device, kind="four").data_ptr(),
        kernels.stream_ptr())
    kernels.check(code, "fftx_c2c_four_rows")
    fftx_c2c_four_rows.launches += 1
    return yr, yi


fftx_c2c_four_rows.launches = 0


def fftx_c2c_rows_long_plain(xr, xi, *, N, inverse=False, in_rolled=False,
                             out_rolled=False):
    """Plain version of K3yl's steps as torch operations on a (P, Nin, 1)
    row stack, N = 2 M: the halves x[n] and x[n + M], u_0 = x[n] + x[n +
    M] and u_1 = (x[n] - x[n + M]) W_N^n (float64, rounded once to the
    working type), the register row kernel's three stages on each
    (:func:`row_radices` at M), X[2 k' + c] and the kept rows. Any even N
    (the tests run halves that are no length of the kernel)."""
    if N % 2 or xr.shape[-1] != 1:
        raise ValueError(f"fftx_c2c_rows_long_plain: rows (P, Nin, 1) of an "
                         f"even N, got N={N}, {tuple(xr.shape)}")
    M = N // 2
    z = _full_rows(torch.complex(xr, xi), N, in_rolled)[..., 0]
    a, b = z[:, :M], z[:, M:]
    sign = 1.0 if inverse else -1.0
    e = torch.arange(M, dtype=torch.float64)
    w = torch.polar(torch.ones_like(e), sign * 2.0 * np.pi * e / N)
    u1 = (a - b) * w.to(z.dtype).to(z.device)
    X = torch.stack([_row_stages(a + b, M, inverse),
                     _row_stages(u1, M, inverse)], dim=-1).reshape(-1, N)
    return _out_rows(X[..., None], N, out_rolled)


def fftx_c2c_rows_long(xr, xi, *, N, inverse=False, in_rolled=False,
                       out_rolled=False):
    """K3's y pass above 16384 on the long row kernel (K3yl,
    ``csrc/cfft_rows_long.cu``): the DFT of each contiguous row of a (P,
    Nin, 1) stack, N = 2 M, by two blocks a row (block c the radix-2 step's
    u_c from both halves of the row, then its register row FFT of M, X[2
    k' + c]), one HBM read of the input and one write of the output. Same
    conventions as :func:`fftx_c2c`; raises where :func:`rows_long_route`
    does not hold. A CPU stack runs :func:`fftx_c2c_rows_long_plain`."""
    P, Nin, L = _check_stack("fftx_c2c_rows_long", xr, xi, N, in_rolled,
                             out_rolled)
    if not rows_long_route(N, L):
        raise ValueError(f"fftx_c2c_rows_long: N={N}, L={L} is off its "
                         "route")
    kw = dict(N=N, inverse=inverse, in_rolled=in_rolled,
              out_rolled=out_rolled)
    if not xr.is_cuda:
        xi_ = torch.zeros_like(xr) if xi is None else xi
        return fftx_c2c_rows_long_plain(xr, xi_, **kw)
    kernels.require_cuda_f32("fftx_c2c_rows_long", xr, xi)
    if P * 2 > 0x7fffffff:
        raise ValueError(f"fftx_c2c_rows_long: {P} rows exceed one launch")
    Nout = N // 2 if out_rolled else N
    yr = torch.empty((P, Nout, 1), dtype=torch.float32, device=xr.device)
    yi = torch.empty_like(yr)
    code = kernels.library().pfbt_cfft_rows_long(
        xr.data_ptr(), None if xi is None else xi.data_ptr(),
        yr.data_ptr(), yi.data_ptr(), P, N, int(in_rolled), int(out_rolled),
        int(inverse), kernels.twiddles(N // 2, xr.device, kind="rows")
        .data_ptr(), kernels.twiddles(N, xr.device, kind="cols").data_ptr(),
        kernels.stream_ptr())
    kernels.check(code, "fftx_c2c_rows_long")
    fftx_c2c_rows_long.launches += 1
    return yr, yi


fftx_c2c_rows_long.launches = 0


def fft2_c2c_pruned(xr, xi, *, Nx, Ny, inverse, pruned_in=False,
                    pruned_out=False):
    """2D c2c transform of a (P, ., .) plane stack with the sigma=2
    roll-crops absorbed. pruned_out (grid_to_image): (P, Nx, Ny) grids
    -> (P, Nx/2, Ny/2) image-ordered planes. pruned_in (image_to_grid):
    (P, Nx/2, Ny/2) image planes -> (P, Nx, Ny) grids. Neither: full
    (P, Nx, Ny) transform. x pass first, then the y pass on rows."""
    if pruned_in and pruned_out:
        raise ValueError("fft2_c2c_pruned: pruned_in and pruned_out")
    P = xr.shape[0]
    yr, yi = fftx_c2c(xr, xi, N=Nx, inverse=inverse, in_rolled=pruned_in,
                      out_rolled=pruned_out)
    nrow, ncol = yr.shape[-2:]
    yr, yi = fftx_c2c(yr.reshape(P * nrow, ncol, 1),
                      yi.reshape(P * nrow, ncol, 1), N=Ny,
                      inverse=inverse, in_rolled=pruned_in,
                      out_rolled=pruned_out)
    return yr.reshape(P, nrow, -1), yi.reshape(P, nrow, -1)


# ---------------------------------------------------------------------
# lab entries: K3's launch parameters


def lines_per_block(N):
    """Lines per block of K3's default launch (csrc/fft_lines.cuh:
    line_launch): the largest power of two S with S * N <= 8192."""
    S = 1
    while 2 * S * N <= _LINE_ELEMS:
        S *= 2
    return S


def _first_radix(N):
    """The radix of the first pass of the kernels' plan (make_plan)."""
    for r in (16, 8, 4, 2, 3, 5):
        if N % r == 0:
            return r
    raise ValueError(f"N={N} has no factor 2, 3 or 5")


def fftx_c2c_first_pass_plain(xr, xi, *, N, inverse=False,
                              out_rolled=False):
    """Plain version of K3's plan cut to its first radix pass R (the
    Stockham pass with no twiddles): y[j R + m] = sum_q x[j + q N/R]
    e^(-+2 pi i q m / R), rows selected as ``out_rolled`` selects them."""
    R = _first_radix(N)
    z = torch.complex(xr, xi)
    P, _, L = z.shape
    zz = z.reshape(P, R, N // R, L)
    y = torch.fft.ifft(zz, dim=1) * R if inverse else \
        torch.fft.fft(zz, dim=1)
    y = y.transpose(1, 2).reshape(P, N, L)
    if out_rolled:
        y = y[:, _rolled_index(N, y.device)]
    return y.real.contiguous(), y.imag.contiguous()


def fftx_c2c_lab(xr, xi, *, N, inverse=False, in_rolled=False,
                 out_rolled=False, S=None, npass=None):
    """``line_fft_kernel`` (K3) on a (P, Nin, L) stack with lab launch
    parameters, whatever :func:`fftx_c2c`'s routes say: ``S`` lines per
    block (None: K3's own choice; S * N <= 16384) and ``npass=1`` to run
    only the plan's first radix pass (timing; the output is then
    :func:`fftx_c2c_first_pass_plain`'s; not with ``in_rolled``). A CPU
    stack runs the plain version."""
    P, Nin, L = xr.shape
    if Nin != (N // 2 if in_rolled else N) or xi is None or \
            xi.shape != xr.shape:
        raise ValueError(f"fftx_c2c_lab: (P, Nin, L) re and im stacks for "
                         f"N={N}, in_rolled={in_rolled}, got "
                         f"{tuple(xr.shape)}")
    if npass not in (None, 1) or (npass and in_rolled):
        raise ValueError(f"fftx_c2c_lab: npass={npass} (None, or 1 "
                         "without in_rolled)")
    if S is not None and not 1 <= S * N <= 2 * _LINE_ELEMS:
        raise ValueError(f"fftx_c2c_lab: S={S} at N={N} (S * N <= "
                         f"{2 * _LINE_ELEMS})")
    if (in_rolled or out_rolled) and N % 4:
        raise ValueError("fftx_c2c_lab: rolled modes need N % 4 == 0")
    kw = dict(N=N, inverse=inverse, out_rolled=out_rolled)
    if not xr.is_cuda:
        if npass == 1:
            return fftx_c2c_first_pass_plain(xr, xi, **kw)
        return fftx_c2c_plain(xr, xi, in_rolled=in_rolled, **kw)
    kernels.require_cuda_f32("fftx_c2c_lab", xr, xi)
    Nout = N // 2 if out_rolled else N
    yr = torch.empty((P, Nout, L), dtype=torch.float32, device=xr.device)
    yi = torch.empty_like(yr)
    W = kernels.twiddles(N, xr.device)
    code = kernels.library().pfbt_cfft_lab(
        xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(), P, L, N,
        Nin, Nout, int(in_rolled), int(out_rolled), int(inverse), S or 0,
        npass or 0, W.data_ptr(), kernels.stream_ptr())
    kernels.check(code, "fftx_c2c_lab")
    fftx_c2c_lab.launches += 1
    return yr, yi


fftx_c2c_lab.launches = 0


# ---------------------------------------------------------------------
# the split-precision x pass


@lru_cache(maxsize=None)
def _cfft_consts_np(N, sign, in_rolled, out_rolled):
    """The four-step stage matrices of the x pass (a copy of
    pfb_tpu/ops/pallas_cfft.py:_cfft_consts_np): W1tw (N2, N1, n1_in)
    with the twiddles absorbed, W2 (K2, N2), re and im, made in float64
    and rounded once to float32; ``in_rolled`` keeps the n1 blocks of
    the N/2 image rows, ``out_rolled`` the k2 rows of the rolled crop."""
    N1, N2 = _factor(N)
    n1 = np.arange(N1)
    n2 = np.arange(N2)
    W1 = np.exp(sign * 2j * np.pi * np.outer(n1, n1) / N1)
    tw = np.exp(sign * 2j * np.pi * np.outer(n1, n2) / N)
    W2 = np.exp(sign * 2j * np.pi * np.outer(n2, n2) / N2)
    W1tw = W1[None, :, :] * tw.T[:, :, None]
    if in_rolled:
        n1_sel = np.concatenate([np.arange(3 * N1 // 4, N1),
                                 np.arange(0, N1 // 4)])
        W1tw = W1tw[:, :, n1_sel]
    if out_rolled:
        k2_sel = np.concatenate([np.arange(3 * N2 // 4, N2),
                                 np.arange(0, N2 // 4)])
        W2 = W2[k2_sel]
    f32 = np.float32
    return (W1tw.real.astype(f32), W1tw.imag.astype(f32),
            W2.real.astype(f32), W2.imag.astype(f32))


def _cfft_consts(N, inverse, in_rolled, out_rolled, device):
    return tuple(torch.as_tensor(a, device=device) for a in
                 _cfft_consts_np(N, 1 if inverse else -1, in_rolled,
                                 out_rolled))


def _split_bf16(a):
    """a ~= hi + lo, hi = bf16(a), lo = bf16(a - hi), both rounded to
    nearest even (pfb_tpu/ops/pallas_cfft.py:_split_bf16)."""
    hi = a.to(torch.bfloat16)
    return hi, (a - hi.float()).to(torch.bfloat16)


def _dot3(A, B):
    """A @ B ~= A1 B1 + A1 B2 + A2 B1 (pallas_cfft.py:_dot_split3), the
    bf16 components as float32 so each product is exact."""
    A1, A2 = (t.float() for t in _split_bf16(A))
    B1, B2 = (t.float() for t in _split_bf16(B))
    return A1 @ B1 + A1 @ B2 + A2 @ B1


def _cmm_split(wr, wi, xr, xi):
    """(wr + i wi)(xr + i xi) by Karatsuba's three real products
    (pfb_tpu/ops/pallas_fft.py:_cmm), each split three ways."""
    t1 = _dot3(wr, xr)
    t2 = _dot3(wi, xi)
    t3 = _dot3(wr + wi, xr + xi)
    return t1 - t2, t3 - t1 - t2


def _check_split(xr, xi, N, in_rolled):
    if not cfft_supported(N):
        raise ValueError(f"fftx_c2c_split: N={N} is not cfft_supported")
    if xr.dim() != 3 or xi is None or xi.shape != xr.shape or \
            xr.shape[1] != (N // 2 if in_rolled else N):
        raise ValueError(f"fftx_c2c_split: (P, Nin, L) re and im stacks "
                         f"for N={N}, in_rolled={in_rolled}, got "
                         f"{tuple(xr.shape)}")


def fftx_c2c_split_plain(xr, xi, *, N, inverse=False, in_rolled=False,
                         out_rolled=False):
    """Plain version of the split x pass: the four-step stages of
    ``_kx_kernel(prec="split")`` as torch matmuls on bf16-rounded float32
    operands. Same shapes and conventions as :func:`fftx_c2c`."""
    _check_split(xr, xi, N, in_rolled)
    w1r, w1i, w2r, w2i = _cfft_consts(N, inverse, in_rolled, out_rolled,
                                      xr.device)
    N2, N1, n1_in = w1r.shape
    P, _, L = xr.shape
    x3r = xr.reshape(P, n1_in, N2, L).transpose(1, 2)
    x3i = xi.reshape(P, n1_in, N2, L).transpose(1, 2)
    cr, ci = _cmm_split(w1r, w1i, x3r, x3i)  # (P, N2, N1, L)
    yr, yi = _cmm_split(w2r, w2i, cr.reshape(P, N2, N1 * L),
                        ci.reshape(P, N2, N1 * L))
    K2 = w2r.shape[0]
    return yr.reshape(P, K2 * N1, L), yi.reshape(P, K2 * N1, L)


_SPLIT_CONSTS = {}


def _split_planes(wr, wi):
    """(..., 6, Mp, Kp) bf16 planes (Wr hi, lo, Wi hi, lo, Ws hi, lo) of a
    complex matrix stack, Ws = Wr + Wi in float32, zero-padded to
    multiples of 16 in both matrix axes."""
    M, K = wr.shape[-2:]
    pad = (0, -K % 16, 0, -M % 16)
    planes = []
    for a in (wr, wi, wr + wi):
        planes += list(_split_bf16(torch.nn.functional.pad(a, pad)))
    return torch.stack(planes, dim=-3).contiguous()


def _split_consts(N, inverse, in_rolled, out_rolled, device):
    key = (N, inverse, in_rolled, out_rolled, str(device))
    if key not in _SPLIT_CONSTS:
        w1r, w1i, w2r, w2i = _cfft_consts(N, inverse, in_rolled, out_rolled,
                                          device)
        _SPLIT_CONSTS[key] = (_split_planes(w1r, w1i),
                              _split_planes(w2r, w2i))
    return _SPLIT_CONSTS[key]


def fftx_c2c_split(xr, xi, *, N, inverse=False, in_rolled=False,
                   out_rolled=False):
    """The split-precision x pass of a (P, Nin, L) stack (the JAX
    package's ``fftx_c2c(precision="split")``): same shapes and
    conventions as :func:`fftx_c2c`, every real product three bf16
    products with float32 sums (about 1e-5 relative). CUDA float32
    stacks launch ``csrc/cfft_split.cu`` (two launches through a (P, N2,
    N1, L) intermediate); CPU stacks run :func:`fftx_c2c_split_plain`."""
    _check_split(xr, xi, N, in_rolled)
    if not xr.is_cuda:
        return fftx_c2c_split_plain(xr, xi, N=N, inverse=inverse,
                                    in_rolled=in_rolled,
                                    out_rolled=out_rolled)
    kernels.require_cuda_f32("fftx_c2c_split", xr, xi)
    N1, N2 = _factor(N)
    n1_in = N1 // 2 if in_rolled else N1
    K2 = N2 // 2 if out_rolled else N2
    P, _, L = xr.shape
    A1, A2 = _split_consts(N, inverse, in_rolled, out_rolled, xr.device)
    cr = torch.empty((P, N2, N1, L), dtype=torch.float32, device=xr.device)
    ci = torch.empty_like(cr)
    yr = torch.empty((P, K2 * N1, L), dtype=torch.float32, device=xr.device)
    yi = torch.empty_like(yr)
    code = kernels.library().pfbt_cfft_split(
        xr.data_ptr(), xi.data_ptr(), cr.data_ptr(), ci.data_ptr(),
        yr.data_ptr(), yi.data_ptr(), A1.data_ptr(), A2.data_ptr(), P, L, N1,
        N2, n1_in, K2, kernels.stream_ptr())
    kernels.check(code, "fftx_c2c_split")
    fftx_c2c_split.launches += 1
    return yr, yi


fftx_c2c_split.launches = 0
