"""Image-space PSF Hessian (counterpart of pfb_tpu/ops/psf.py).

Two engines, as in the JAX package:

- :func:`make_psf_convolve` (``engine="fft"``): ``torch.fft`` on the
  rfft2 transfer function PSFHAT;
- :func:`make_psf_convolve_pallas` (``engine="pallas"``): the
  hand-written kernels of ``csrc/psf_conv.cu`` on CUDA, their plain
  versions on the CPU. Where the JAX package runs its v3 pipeline (psf =
  2x image, :func:`v3_supported`) that is K1, :func:`psf_convolve_h`
  (counterpart of ``psf_convolve_pallas_v3_cube``), with K2,
  :func:`psf_convolve_h_cg`, for the CG-fused solver; elsewhere K11,
  :func:`psf_convolve_full` (counterpart of ``psf_convolve_pallas``).

K1's and K2's transfer function H is the port's own layout: the
Hermitian half along x of ``fft2(ifftshift(psf))``, (nb, nx+1, 2ny), as
a real part plus an optional imaginary part (dropped for an even PSF,
see :func:`prep_h`). :func:`h_from_jax_v3` converts the JAX package's
scrambled v3 operands into it. K11 takes the full (nb, NX, NY) transfer
function (:func:`prep_h_full`); :func:`h_from_jax_full` converts the
JAX package's transposed operands.

K10 is K1's three stages as separate calls (:func:`psf_stage_cols_fwd`,
:func:`psf_stage_rows`, :func:`psf_stage_cols_inv`, counterparts of
``psf_v3_stage_k1/k2/k3``) for the space-sharded convolution of
parallel/dist.py, which puts all-to-all transposes between them. Its H is
K1's with the rows padded to the shard count (:func:`prep_h_space`).

The column stages of every entry (K1, K2, K10, K11, and through them
K12-K15) run on one of two kernels, by :func:`cols_route` at (NX,
columns): at NX >= 256 where the tile fits, the cluster column FFT of
``csrc/psf_cols.cu``, below 2048 on clusters of one or two blocks
(:func:`psf_cols_fwd` / :func:`psf_cols_inv` count its launches, from
whichever entry; K2's with its prologue and epilogue,
:func:`psf_convolve_h_cg_cols_plain` its decomposition); elsewhere
``line_fft_kernel`` (K2: its fused line kernels), whose launches from
every entry :data:`psf_cols_line` counts. The C++ predicate
``psf_cols_clusters`` decides and an entry refuses a route it does not
hold, so the mirror here and the kernels cannot disagree silently.
:func:`psf_cols_fwd_plain` / :func:`psf_cols_inv_plain` are the cluster
kernels' own decomposition as torch operations, for the CPU tests.

The rows stage of every entry (K1, K2, K10 stage 2, K11, and through them
K12-K14) runs on one of two kernels, by :func:`rows_route` at NY: at NY =
256 R2, R2 a 5-smooth radix from 1 to 64 (256-16384), the fused
register row FFT K10br of ``csrc/psf_rows.cu`` (:func:`psf_rows` counts
its launches, from whichever entry, as the entry reports them), elsewhere
``psf_rows_kernel`` (:data:`psf_rows_line` counts its launches). The C++
predicate ``psf_rows_fused`` decides, on NY alone; the entries take the
route's twiddle table with the route it is for and refuse a route that is
not the predicate's. :func:`psf_rows_plain` is K10br's decomposition as
torch operations.
"""

import ctypes

import numpy as np
import torch

from pfb_tpu_torch import kernels
from pfb_tpu_torch.config import kernel_dtype
from pfb_tpu_torch.ops.cfft import (_CLUSTER_MIN_N, _LINE_ELEMS,
                                    _ROW_LENGTHS, _factor, _row_stages,
                                    cluster_shape)
from pfb_tpu_torch.ops.fft import (good_size, psf_convolve_cube,
                                   psf_convolve_slice)
from pfb_tpu_torch.ops.mmfft import make_full_psfhat


def hessian_psf_slice(x, psfhat, beam=None, lastsize=None, sigmainv=0.0,
                      wsum=None):
    """One band's beam * (PSF conv (beam * x)) / wsum + sigmainv * x;
    ``lastsize`` defaults to psfhat.shape[-2], as the cube form's."""
    if lastsize is None:
        lastsize = psfhat.shape[-2]
    xin = x * beam if beam is not None else x
    xout = psf_convolve_slice(xin, psfhat, lastsize)
    if beam is not None:
        xout = xout * beam
    if wsum is not None:
        xout = xout / wsum
    return xout + x * sigmainv


def hessian_psf_cube(x, psfhat, beam=None, lastsize=None, sigmainv=0.0,
                     wsum=None, band_chunk=None):
    """beam * (PSF conv (beam * x)) / wsum + sigmainv * x."""
    if lastsize is None:
        lastsize = psfhat.shape[-2]
    xin = x * beam if beam is not None else x
    xout = psf_convolve_cube(xin, psfhat, lastsize, band_chunk=band_chunk)
    if beam is not None:
        xout = xout * beam
    if wsum is not None:
        xout = xout / wsum
    return xout + x * sigmainv


def make_psf_convolve(psfhat, lastsize, beam=None, sigmainv=0.0, wsum=None,
                      band_chunk=None):
    """Cube Hessian matvec on torch.fft (the unit the deconvolvers
    use)."""
    def matvec(x):
        return hessian_psf_cube(x, psfhat, beam=beam, lastsize=lastsize,
                                sigmainv=sigmainv, wsum=wsum,
                                band_chunk=band_chunk)
    return matvec


def v3_supported(nx, ny):
    """The shapes on which the JAX package runs its v3 Pallas pipeline
    (pfb_tpu/ops/pallas_fft.py:v3_supported); the port routes to its
    kernel on the same rule."""
    NX, NY = 2 * nx, 2 * ny
    if NY % 128 or (NY // 128) % 2:
        return False
    N1x, N2x = _factor(NX)
    return N1x % 2 == 0 and N2x % 2 == 0 and N1x % N2x == 0


def psf_convolve_h_plain(x, hr, hi):
    """Plain version of the kernel: crop(ifft2(H * fft2(pad(x)))) per
    band, with H given as its Hermitian half along x
    (nb, nx+1, 2ny) real (+ imaginary) parts."""
    nx, ny = x.shape[-2:]
    NX, NY = 2 * nx, hr.shape[-1]
    h = hr if hi is None else torch.complex(hr, hi)
    z = torch.fft.rfft(x, n=NX, dim=-2)
    z = torch.fft.ifft(torch.fft.fft(z, n=NY, dim=-1) * h, dim=-1)
    z = z[..., :ny].contiguous()
    # the c2r transform reads rows 0 and NX/2 as real (the kernel's
    # mirror rebuild does the same); cuFFT leaves non-Hermitian input
    # undefined, so an H that is not the transform of a real PSF would
    # otherwise give a device-dependent answer
    z[..., 0, :].imag.zero_()
    z[..., NX // 2, :].imag.zero_()
    return torch.fft.irfft(z, n=NX, dim=-2)[..., :nx, :]


# ---------------------------------------------------------------------
# the column route: the cluster column kernels (csrc/psf_cols.cu)

def cols_route(NX, L):
    """Whether the column stages of length NX on L columns take the
    cluster column kernels (``csrc/psf_cols.cu:psf_cols_clusters``, which
    decides; this is its mirror): L >= 2, NX >= 256 (the PSF Hessian of
    every 128-aligned image from 128^2; below 2048 on one block or
    clusters of ``_TINY_C``), NX % 4 == 0 and, at ops/cfft.py:cluster_shape's
    (C, W), C dividing NX, M = NX / C even (two columns pair, and k1 pairs
    with M - k1), a tile of W lines of M within 8192 values and M a
    product of 2, 3 and 5. Every other shape keeps ``line_fft_kernel``."""
    if L < 2 or NX < _CLUSTER_MIN_N or NX % 4:
        return False
    C, W = cluster_shape(NX)
    M = NX // C
    return NX % C == 0 and M % 2 == 0 and M * W <= _LINE_ELEMS and \
        good_size(M) == M


def _cols_tables(NX, L, device):
    """(C, TX, TM, TN) for an entry with a column stage at (NX, L): the
    cluster route's C and table pointers (the plan of NX / C and W_N^e),
    or C = 0 and the length-NX plan of line_fft_kernel."""
    if cols_route(NX, L):
        C = cluster_shape(NX)[0]
        return (C, None, kernels.twiddles(NX // C, device).data_ptr(),
                kernels.twiddles(NX, device, kind="cols").data_ptr())
    return 0, kernels.twiddles(NX, device).data_ptr(), None, None


class _Launches:
    """A launch counter (``.launches``) of a kernel that no wrapper of
    its own launches."""

    def __init__(self, doc):
        self.__doc__ = doc
        self.launches = 0


psf_cols_line = _Launches(
    "Launches of the PSF column stages' shared-memory line kernels "
    "(line_fft_kernel; K2's cg_cols_fwd / _inv_kernel), from every entry "
    "whose column stage is off cols_route.")
psf_rows_line = _Launches(
    "Launches of psf_rows_kernel, the rows stage's shared-memory line "
    "kernel, from every entry whose rows stage is off rows_route.")


def _count_cols(C, fwd=1, inv=1):
    """Count the column kernels' launches of an entry that ran on route
    C: the cluster kernels', or on the line route (C = 0)
    :data:`psf_cols_line`'s."""
    if C:
        psf_cols_fwd.launches += fwd
        psf_cols_inv.launches += inv
    else:
        psf_cols_line.launches += fwd + inv


def _decimated(z, C, inverse, fft=True):
    """The cluster kernels' transform of (nb, NX, L') complex lines along
    dim 1: decimate n = c + C m, the M-point DFTs Y_c[k1] (M = NX / C),
    the twiddles W_N^{-+c k1} (float64, rounded once to the working type)
    and the C-point DFTs Z[k1 + M k2] = sum_c W_C^{c k2} W_N^{c k1}
    Y_c[k1]; unnormalised, forward e^- and inverse e^+. ``fft=False``
    keeps the index algebra alone (the skeleton): Z[k1 + M c] =
    z[c + C k1]."""
    nb, NX, Lz = z.shape
    M = NX // C
    y = z.reshape(nb, M, C, Lz)  # [m, c] = z[c + C m]
    if fft:
        y = torch.fft.ifft(y, dim=1) * M if inverse else \
            torch.fft.fft(y, dim=1)
        e = torch.outer(torch.arange(M, dtype=torch.float64),
                        torch.arange(C, dtype=torch.float64))
        tw = torch.polar(torch.ones_like(e),
                         (1.0 if inverse else -1.0) * 2.0 * np.pi * e / NX)
        y = y * tw.to(y.dtype).to(y.device)[None, :, :, None]
        y = torch.fft.ifft(y, dim=2) * C if inverse else \
            torch.fft.fft(y, dim=2)
    return y.transpose(1, 2).reshape(nb, NX, Lz)  # row k1 + M k2


def _pair_lines(a):
    """(..., L) real columns -> (..., ceil(L / 2)) lines a_{2q} + i
    a_{2q+1}, an odd L's last column paired with zeros."""
    if a.shape[-1] % 2:
        a = torch.nn.functional.pad(a, (0, 1))
    return torch.complex(a[..., 0::2], a[..., 1::2])


def _unpair(zr, zi, L):
    """The columns of a pair stack back in order: (..., Lz) -> (..., L)
    with column 2q from zr and 2q + 1 from zi."""
    return torch.stack([zr, zi], dim=-1).flatten(-2)[..., :L]


def psf_cols_fwd_plain(x, NX, rows, keep=None, *, C, fft=True):
    """The forward cluster column kernel's steps as torch operations, in
    x's type: the zero-padded columns, two adjacent columns as one line Z
    = x_j + i x_{j+1}, :func:`_decimated`, the separation X_j[k] = (Z[k] +
    conj Z[N - k]) / 2, X_{j+1}[k] = (Z[k] - conj Z[N - k]) / (2i), the
    kept rows k < keep (default NX/2 + 1) and zero rows to ``rows``.
    ``fft=False`` gives the skeleton's output. Returns (zr, zi)."""
    keep = _keep(NX, keep)
    nb, nx, L = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, 0, NX - nx))
    Z = _decimated(_pair_lines(xp), C, False, fft)
    Zm = Z[:, (-torch.arange(NX, device=x.device)) % NX]
    a, m = (Z.real, Z.imag), (Zm.real, Zm.imag)
    Z = torch.complex(
        _unpair(0.5 * (a[0] + m[0]), 0.5 * (a[1] + m[1]), L),
        _unpair(0.5 * (a[1] - m[1]), 0.5 * (m[0] - a[0]), L))
    Z = torch.nn.functional.pad(Z[:, :keep], (0, 0, 0, rows - keep))
    return Z.real.contiguous(), Z.imag.contiguous()


def _hermitian_part(w, NX, keep):
    """H[k] = (G[k] + conj G[N - k]) / 2 of the spectra G[k] = w[k] for k
    < keep, conj w[N - k] above, (nb, keep, L) -> (nb, NX, L): w[k] for 0
    < k <= N - keep, conj w[N - k] for k >= keep, the mean where both rows
    are given (the real parts of rows 0 and, at keep = NX/2 + 1, NX/2)."""
    k = torch.arange(NX, device=w.device)
    mk = (-k) % NX
    da, db = k < keep, mk < keep
    a = w[:, k.clamp(max=keep - 1)]
    b = w[:, mk.clamp(max=keep - 1)].conj()
    both = (da & db)[None, :, None]
    return torch.where(both, 0.5 * (a + b),
                       torch.where(da[None, :, None], a, b))


def psf_cols_inv_plain(wr, wi, nx, NX, keep=None, *, C, scale=1.0,
                       fft=True):
    """The inverse cluster column kernel's steps as torch operations, in
    wr's type: rows 0 .. keep - 1 (default NX/2 + 1) of the (nb, rows, L)
    spectra, their Hermitian part (:func:`_hermitian_part`), two adjacent
    columns as one line Z = H_j + i H_{j+1}, the inverse
    :func:`_decimated`, x_j the real part and x_{j+1} the imaginary part,
    rows n < nx times ``scale``. ``fft=False`` gives the skeleton's
    output."""
    keep = _keep(NX, keep)
    L = wr.shape[-1]
    H = _hermitian_part(torch.complex(wr[:, :keep], wi[:, :keep]), NX, keep)
    hr, hi = H.real, H.imag
    if L % 2:
        hr, hi = (torch.nn.functional.pad(t, (0, 1)) for t in (hr, hi))
    Z = torch.complex(hr[..., 0::2] - hi[..., 1::2],
                      hi[..., 0::2] + hr[..., 1::2])
    z = _decimated(Z, C, True, fft)[:, :nx]
    return _unpair(z.real, z.imag, L) * scale


def psf_cols_fwd(x, NX, rows, keep=None, *, skeleton=False):
    """The forward column stage on the cluster column kernel
    (``csrc/psf_cols.cu``): x (nb, nx, L) real -> (zr, zi), each (nb,
    rows, L), :func:`psf_stage_cols_fwd`'s function, at (C, W) =
    ops/cfft.py:cluster_shape; raises where :func:`cols_route` does not
    hold. ``skeleton=True`` runs the lab's skeleton: the loads, exchange,
    separation and stores with the FFT compiled out. A CPU tensor runs
    :func:`psf_cols_fwd_plain`. ``psf_cols_fwd.launches`` counts the
    kernel's launches here and from every entry that takes the route."""
    nb, nx, L = x.shape
    keep = _keep(NX, keep)
    if not cols_route(NX, L) or nx > NX or rows < keep:
        raise ValueError(f"psf_cols_fwd: x {tuple(x.shape)}, NX {NX}, rows "
                         f"{rows}, keep {keep}")
    C = cluster_shape(NX)[0]
    if not x.is_cuda:
        return psf_cols_fwd_plain(x, NX, rows, keep, C=C, fft=not skeleton)
    kernels.require_cuda_f32("psf_cols_fwd", x)
    zr = torch.empty((nb, rows, L), dtype=torch.float32, device=x.device)
    zi = torch.empty_like(zr)
    _, _, TM, TN = _cols_tables(NX, L, x.device)
    code = kernels.library().pfbt_psf_cols_fwd(
        x.data_ptr(), zr.data_ptr(), zi.data_ptr(), nb, nx, L, NX, keep,
        rows, C, int(skeleton), TM, TN, kernels.stream_ptr())
    kernels.check(code, "psf_cols_fwd")
    _count_cols(C, inv=0)
    return zr, zi


psf_cols_fwd.launches = 0


def psf_cols_inv(wr, wi, nx, NX, keep=None, *, scale=1.0, skeleton=False):
    """The inverse column stage on the cluster column kernel
    (``csrc/psf_cols.cu``): rows 0 .. keep - 1 (default NX/2 + 1) of wr,
    wi (nb, rows, L), the rows past them the conjugate mirror of rows 1
    .. NX - keep -> (nb, nx, L), the real inverse transform times
    ``scale``; raises where :func:`cols_route` does not hold.
    ``skeleton=True`` runs the lab's skeleton. A CPU tensor runs
    :func:`psf_cols_inv_plain`. ``psf_cols_inv.launches`` counts the
    kernel's launches here and from every entry that takes the route."""
    nb, rows, L = wr.shape
    keep = _keep(NX, keep)
    if not cols_route(NX, L) or wi.shape != wr.shape or nx > NX or \
            rows < keep:
        raise ValueError(f"psf_cols_inv: w {tuple(wr.shape)}, nx {nx}, NX "
                         f"{NX}, keep {keep}")
    C = cluster_shape(NX)[0]
    if not wr.is_cuda:
        return psf_cols_inv_plain(wr, wi, nx, NX, keep, C=C, scale=scale,
                                  fft=not skeleton)
    kernels.require_cuda_f32("psf_cols_inv", wr, wi)
    out = torch.empty((nb, nx, L), dtype=torch.float32, device=wr.device)
    _, _, TM, TN = _cols_tables(NX, L, wr.device)
    code = kernels.library().pfbt_psf_cols_inv(
        wr.data_ptr(), wi.data_ptr(), out.data_ptr(), nb, nx, L, NX, keep,
        rows, float(scale), C, int(skeleton), TM, TN, kernels.stream_ptr())
    kernels.check(code, "psf_cols_inv")
    _count_cols(C, fwd=0)
    return out


psf_cols_inv.launches = 0


# ---------------------------------------------------------------------
# the rows route: the fused register row FFT (csrc/psf_rows.cu)


def rows_route(NY):
    """Whether the rows stage of length NY takes K10br, the fused register
    row FFT (``csrc/psf_rows.cu:psf_rows_fused``, which decides; this is
    its mirror): NY = 16 R2 16 with R2 a 5-smooth radix from 1 to 64
    (256-16384: every PSF Hessian of a 128-aligned image from 128^2 to
    8192^2; below 2048 16 / R2 rows a block), K3r's lengths
    (ops/cfft.py:row_route). Every other NY keeps ``psf_rows_kernel``."""
    return NY in _ROW_LENGTHS


def _rows_args(NY, device):
    """The rows-stage arguments of an entry at NY: the twiddle table's
    pointer (K10br's three-stage table, or the length-NY plan of
    ``psf_rows_kernel``), the route it is for (1 or 0; the entry refuses
    the other), and a pointer to the int in which the entry reports its
    K10br launches (:func:`_count_rows`)."""
    fused = rows_route(NY)
    table = kernels.twiddles(NY, device, kind="rows" if fused else "plan")
    return table.data_ptr(), int(fused), ctypes.pointer(ctypes.c_int(0))


def _count_rows(fused, nfused):
    """Count the rows-stage launches of an entry that ran one rows stage
    on route ``fused``: the K10br launches it reported through
    ``nfused``, or the launch of ``psf_rows_kernel``
    (:data:`psf_rows_line`)."""
    psf_rows.launches += nfused.contents.value
    if not fused:
        psf_rows_line.launches += 1


def full_h_rows(hr, hi, rows=None):
    """K11's Hermitian part of the full (nb, NX, NY) transfer function on
    the kept spectrum rows kx < rows (default NX/2 + 1): H_h(kx, k) = (H(kx,
    k) + conj H(-kx, -k)) / 2, as (hr_h, hi_h or None), each (nb, rows,
    NY)."""
    nb, NX, NY = hr.shape
    rows = NX // 2 + 1 if rows is None else rows
    kx = torch.arange(rows, device=hr.device)
    mx, ky = (-kx) % NX, (-torch.arange(NY, device=hr.device)) % NY
    hr_h = 0.5 * (hr[:, kx] + hr[:, mx][:, :, ky])
    hi_h = None if hi is None else 0.5 * (hi[:, kx] - hi[:, mx][:, :, ky])
    return hr_h, hi_h


def psf_rows_plain(zr, zi, hr, hi=None, NX=None):
    """K10br's decomposition as torch operations, in zr's type: each row of
    z (..., ny) zero-padded to NY, the forward stages of K3r's plan
    (ops/cfft.py:_row_stages, stage 1 reading only the rows q that hold
    values), the product with its row of H in the registers' layout k = j
    + q NY/16, the unscaled inverse stages and the crop to ny; returns
    (wr, wi). H (..., NY) rows match z's (K1, K2, K10); with ``NX``, H is
    the full (nb, NX, NY) transfer function and z (nb, NX/2 + 1, ny) takes
    its Hermitian part (K11, :func:`full_h_rows`)."""
    if NX is not None:
        hr, hi = full_h_rows(hr, hi, zr.shape[-2])
    shape, ny, N = zr.shape, zr.shape[-1], hr.shape[-1]
    z = torch.complex(zr, zi).reshape(-1, ny)
    h = hr if hi is None else torch.complex(hr, hi)
    X = _row_stages(z, N, False, nin=ny).reshape(-1, 16, N // 16)  # [q, j]
    X = X * h.reshape(-1, 16, N // 16)
    w = _row_stages(X.reshape(-1, N), N, True)[:, :ny].reshape(shape)
    return w.real.contiguous(), w.imag.contiguous()


def psf_rows(zr, zi, hr, hi=None, NX=None):
    """K10br, the rows stage on the fused register row FFT
    (``csrc/psf_rows.cu``): :func:`psf_rows_plain`'s function of (R, ny)
    or (nb, rows, ny) rows z and H (same rows, NY) or, with ``NX``, the
    full (nb, NX, NY) transfer function (K11; z (nb, NX/2 + 1, ny)); raises
    where :func:`rows_route` does not hold. A CPU tensor runs
    :func:`psf_rows_plain`. ``psf_rows.launches`` counts the kernel's
    launches, here and from every entry that takes the route, as the C
    entries report them (a stage whose z or H holds 2^31 elements or more
    runs as several launches)."""
    ny, NY = zr.shape[-1], hr.shape[-1]
    R = zr.numel() // ny
    ok = rows_route(NY) and zi.shape == zr.shape and ny <= NY and \
        (hi is None or hi.shape == hr.shape)
    if NX is None:
        ok = ok and hr.shape[:-1] == zr.shape[:-1]
    else:
        ok = ok and hr.dim() == 3 and hr.shape[1] == NX and NX % 2 == 0 \
            and R == hr.shape[0] * (NX // 2 + 1)
    if not ok:
        raise ValueError(f"psf_rows: z {tuple(zr.shape)}, H "
                         f"{tuple(hr.shape)}, NX {NX}")
    if not zr.is_cuda:
        return psf_rows_plain(zr, zi, hr, hi, NX)
    kernels.require_cuda_f32("psf_rows", zr, zi, hr, hi)
    wr = torch.empty_like(zr)
    wi = torch.empty_like(zr)
    TY, _, nfused = _rows_args(NY, zr.device)
    code = kernels.library().pfbt_psf_rows(
        zr.data_ptr(), zi.data_ptr(), hr.data_ptr(),
        None if hi is None else hi.data_ptr(), wr.data_ptr(), wi.data_ptr(),
        R, ny, NY, NX or 0, TY, nfused, kernels.stream_ptr())
    kernels.check(code, "psf_rows")
    _count_rows(1, nfused)
    return wr, wi


psf_rows.launches = 0


def psf_convolve_h(x, hr, hi=None):
    """PSF convolution of an (nb, nx, ny) cube with the port's H:
    the CUDA kernel for CUDA tensors, the plain version on the CPU."""
    nb, nx, ny = x.shape
    if hr.shape != (nb, nx + 1, 2 * ny) or \
            (hi is not None and hi.shape != hr.shape):
        raise ValueError(f"psf_convolve_h: H {tuple(hr.shape)} does not "
                         f"match x {tuple(x.shape)}")
    if not x.is_cuda:
        return psf_convolve_h_plain(x, hr, hi)
    kernels.require_cuda_f32("psf_convolve_h", x, hr, hi)
    out = _conv_stages("pfbt_psf_conv", x, hr, hi, 2 * nx, 2 * ny)
    psf_convolve_h.launches += 1
    return out


psf_convolve_h.launches = 0


def _conv_stages(entry, x, hr, hi, NX, NY):
    """Launch K1 or K11 (``entry``) on validated CUDA operands: the
    scratch spectra (nb, NX/2+1, ny) and the output are allocated here;
    the column stages take :func:`cols_route`'s kernels and the rows stage
    :func:`rows_route`'s (counted)."""
    nb, nx, ny = x.shape
    dev = x.device
    zr = torch.empty((nb, NX // 2 + 1, ny), dtype=torch.float32, device=dev)
    zi, wr, wi = (torch.empty_like(zr) for _ in range(3))
    out = torch.empty_like(x)
    C, TX, TM, TN = _cols_tables(NX, ny, dev)
    TY, fused, nfused = _rows_args(NY, dev)
    code = getattr(kernels.library(), entry)(
        x.data_ptr(), hr.data_ptr(), None if hi is None else hi.data_ptr(),
        zr.data_ptr(), zi.data_ptr(), wr.data_ptr(), wi.data_ptr(),
        out.data_ptr(), nb, nx, ny, NX, NY, C, TX, TY, TM, TN, fused, nfused,
        kernels.stream_ptr())
    kernels.check(code, entry)
    _count_cols(C)
    _count_rows(fused, nfused)
    return out


def psf_convolve_full_plain(x, hr, hi):
    """Plain version of K11: Re(ifft2(H fft2(pad_{NX,NY}(x))))[:nx, :ny]
    per band, with the full (nb, NX, NY) transfer function as real (+
    imaginary) parts. Complex transforms only: no c2r transform sees H,
    so any H is read as given."""
    nx, ny = x.shape[-2:]
    NX, NY = hr.shape[-2:]
    h = hr if hi is None else torch.complex(hr, hi)
    z = torch.fft.fft2(x, s=(NX, NY)) * h
    return torch.fft.ifft2(z).real[..., :nx, :ny].contiguous()


def psf_convolve_full(x, hr, hi=None):
    """K11: the PSF convolution of an (nb, nx, ny) cube with the full
    (nb, NX, NY) transfer function, any even 5-smooth NX >= nx and NY >=
    ny: the CUDA kernel for CUDA tensors (all bands in one launch
    sequence), the plain version on the CPU."""
    nb, nx, ny = x.shape
    if hr.dim() != 3 or hr.shape[0] != nb or hr.shape[1] < nx or \
            hr.shape[2] < ny or hr.shape[1] % 2 or \
            (hi is not None and hi.shape != hr.shape):
        raise ValueError(f"psf_convolve_full: H {tuple(hr.shape)} does "
                         f"not match x {tuple(x.shape)}")
    if not x.is_cuda:
        return psf_convolve_full_plain(x, hr, hi)
    kernels.require_cuda_f32("psf_convolve_full", x, hr, hi)
    out = _conv_stages("pfbt_psf_conv_full", x, hr, hi, *hr.shape[1:])
    psf_convolve_full.launches += 1
    return out


psf_convolve_full.launches = 0


def psf_convolve_h_cg_plain(p_prev, r, beta, hr, hi):
    """Plain version of K2: p = beta p_prev - r, conv = K1(p), and per
    band pap = [p . conv, p . p] as an (nb, 1, 2) tensor."""
    p = beta * p_prev - r
    conv = psf_convolve_h_plain(p, hr, hi)
    pap = torch.stack([torch.sum(p * conv, dim=(-2, -1)),
                       torch.sum(p * p, dim=(-2, -1))], dim=-1)
    return p, conv, pap[:, None, :]


def psf_convolve_h_cg_cols_plain(p_prev, r, beta, hr, hi=None, *, C):
    """K2's cluster route as torch operations, in p_prev's type: p = beta
    p_prev - r, the forward cluster column stage
    (:func:`psf_cols_fwd_plain`), the rows stage
    (:func:`psf_stage_rows_plain`), the inverse (:func:`psf_cols_inv_plain`
    times 1 / (NX NY)), then the sums in the kernel's order: block c of a
    tile's cluster stores the rows n = n1 + M n2 with n1 // ceil(M / C) =
    c (M = NX / C) and adds p . conv and p . p over them per column; a
    column's C block partials are added in block order, then the band's
    columns. Returns (p, conv, pap) as :func:`psf_convolve_h_cg_plain`."""
    nb, nx, ny = p_prev.shape
    NX, NY = 2 * nx, 2 * ny
    p = beta * p_prev - r
    zr, zi = psf_cols_fwd_plain(p, NX, NX // 2 + 1, C=C)
    wr, wi = psf_stage_rows_plain(zr, zi, hr, hi)
    conv = psf_cols_inv_plain(wr, wi, nx, NX, C=C, scale=1.0 / (NX * NY))
    M = NX // C
    block = (torch.arange(nx, device=p.device) % M) // -(-M // C)
    prod = torch.stack([p * conv, p * p], dim=-1)  # (nb, nx, ny, 2)
    part = prod.new_zeros((nb, C, ny, 2)).index_add_(1, block, prod)
    col = part[:, 0]
    for c in range(1, C):
        col = col + part[:, c]
    return p, conv, col.sum(dim=1)[:, None, :]


def psf_convolve_h_cg(p_prev, r, beta, hr, hi=None):
    """K2, the CG-fused K1 (counterpart of
    psf_convolve_pallas_v3_cube_cg): from p_prev, r (nb, nx, ny) and beta
    (nb, 1, 1) returns (p, conv(p), pap) with p = beta p_prev - r and pap
    (nb, 1, 2) = [p . conv(p), p . p]; the CUDA kernel for CUDA tensors,
    the plain version on the CPU. H as :func:`psf_convolve_h`'s."""
    nb, nx, ny = p_prev.shape
    if r.shape != p_prev.shape or tuple(beta.shape) != (nb, 1, 1) or \
            hr.shape != (nb, nx + 1, 2 * ny) or \
            (hi is not None and hi.shape != hr.shape):
        raise ValueError(f"psf_convolve_h_cg: p {tuple(p_prev.shape)}, r "
                         f"{tuple(r.shape)}, beta {tuple(beta.shape)}, H "
                         f"{tuple(hr.shape)} do not match")
    if not p_prev.is_cuda:
        return psf_convolve_h_cg_plain(p_prev, r, beta, hr, hi)
    bufs = psf_cg_stages(p_prev, r, beta, hr, hi)
    return bufs["pn"], bufs["out"], bufs["pap"]


def psf_cg_stages(p_prev, r, beta, hr, hi=None, stages=7, bufs=None):
    """K2's stages on validated-shape CUDA operands (psf_convolve_h_cg's):
    bit 1 stage 1 (p and its column spectra), bit 2 the rows stage, bit 4
    stage 3 (conv(p) and the column sums) and the band sums; ``stages=7``
    is K2. ``bufs``, the dict a previous call returned, keeps the scratch,
    so a stage alone reads its predecessor's output (the lab's per-stage
    times). Returns the dict: pn (p), out (conv(p)), pap and the scratch.
    The column stages take :func:`cols_route`'s kernels at (2 nx, ny),
    as K1's do, and the rows stage :func:`rows_route`'s (counted)."""
    kernels.require_cuda_f32("psf_convolve_h_cg", p_prev, r, beta, hr, hi)
    nb, nx, ny = p_prev.shape
    NX, NY = 2 * nx, 2 * ny
    dev = p_prev.device
    C, TX, TM, TN = _cols_tables(NX, ny, dev)
    if bufs is None:
        zr = torch.empty((nb, nx + 1, ny), dtype=torch.float32, device=dev)
        bufs = dict(pn=torch.empty_like(p_prev), out=torch.empty_like(p_prev),
                    zr=zr, zi=torch.empty_like(zr), wr=torch.empty_like(zr),
                    wi=torch.empty_like(zr),
                    colsum=torch.empty((nb, ny, max(C, 1), 2),
                                       dtype=torch.float64, device=dev),
                    pap=torch.empty((nb, 1, 2), dtype=torch.float32,
                                    device=dev))
    TY, fused, nfused = _rows_args(NY, dev)
    code = kernels.library().pfbt_psf_conv_cg(
        p_prev.data_ptr(), r.data_ptr(), beta.data_ptr(), hr.data_ptr(),
        None if hi is None else hi.data_ptr(),
        *(bufs[k].data_ptr() for k in ("pn", "zr", "zi", "wr", "wi", "out",
                                       "colsum", "pap")),
        nb, nx, ny, NX, NY, C, TX, TY, TM, TN, fused, nfused, int(stages),
        kernels.stream_ptr())
    kernels.check(code, "psf_convolve_h_cg")
    _count_cols(C, fwd=stages & 1, inv=(stages >> 2) & 1)
    if stages & 2:
        _count_rows(fused, nfused)
    psf_convolve_h_cg.launches += 1
    return bufs


psf_convolve_h_cg.launches = 0


def prep_h(psf, nx, ny, dtype, real_transfer="auto"):
    """The kernel's transfer function from a (nb, 2nx, 2ny) PSF cube:
    rows 0..nx of fft2(ifftshift(psf)), computed once per run with
    torch.fft in float64 and stored in ``dtype``. Returns (hr, hi) with
    hi None when the transfer function is taken as real:
    ``real_transfer="auto"`` drops Im H when max|Im H| / max|Re H| <
    1e-5 (an even PSF), which makes the operator its even part, as in
    pfb_tpu/ops/psf.py:prep_pallas_hessian; True forces it, False keeps
    the full complex H."""
    nb, nx_psf, ny_psf = psf.shape
    if not (nx_psf == 2 * nx and ny_psf == 2 * ny):
        raise ValueError(f"prep_h: psf {tuple(psf.shape)} is not twice "
                         f"the ({nx}, {ny}) image")
    hr = torch.empty((nb, nx + 1, ny_psf), dtype=dtype, device=psf.device)
    hi = torch.empty_like(hr)
    for b in range(nb):
        p = torch.fft.ifftshift(psf[b].to(torch.float64), dim=(-2, -1))
        h = torch.fft.fft(torch.fft.rfft(p, dim=-2), dim=-1)
        hr[b] = h.real
        hi[b] = h.imag
        del h, p
    if real_transfer == "auto":
        use_real = float(hi.abs().max() / hr.abs().max()) < 1e-5
    else:
        use_real = bool(real_transfer)
    return hr, (None if use_real else hi)


def unscramble_jax(a):
    """The JAX package's scrambled transfer function -> natural layout.

    ``scramble_HT`` (pallas_fft.py:528-538) puts H[kx, k1 + N1y*k2] at
    [k1, kx, k2] of an (N1y, rows, N2y) operand, after any leading band
    axis; this returns (..., rows, N1y * N2y) as a numpy array."""
    a = np.asarray(a)
    *lead, N1y, R, N2y = a.shape
    nl = len(lead)
    h = np.transpose(a, tuple(range(nl)) + (nl + 1, nl + 2, nl))
    return np.ascontiguousarray(h.reshape(*lead, R, N1y * N2y))


def h_from_jax_v3(phrT, phiT, nx, ny, rows=None):
    """The JAX package's v3 operands -> the port's H.

    Inverts ``scramble_HT``/``prep_H_v3`` (pallas_fft.py:519-538) and the
    swapaxes of ``prep_pallas_hessian`` (ops/psf.py:85-88): the JAX
    operand (nb, N1y, NXH, N2y), or (N1y, NXH, N2y) for one band, holds
    H[b, kx, k1 + N1y*k2] at [b, k1, kx, k2], with NXH >= nx+1 kept
    x-spectrum rows. Returns the first ``rows`` of them (default nx + 1,
    K1's H; NXH for the rows stage on K15's layout). Takes and returns
    numpy arrays; phiT may be None."""
    rows = nx + 1 if rows is None else rows

    def one(a):
        h = unscramble_jax(a)
        if h.shape[-1] != 2 * ny or h.shape[-2] < rows:
            raise ValueError(f"h_from_jax_v3: operand {np.shape(a)} does "
                             f"not match ({nx}, {ny}), {rows} rows")
        return np.ascontiguousarray(h[..., :rows, :])
    return one(phrT), (None if phiT is None else one(phiT))


def prep_h_full(psf, dtype):
    """K11's transfer function from an (nb, NX, NY) PSF cube: the full
    fft2(ifftshift(psf)) (ops/mmfft.py:make_full_psfhat), computed band
    by band in float64 and stored in ``dtype`` as (hr, hi), each (nb,
    NX, NY). Always complex, as the JAX package's general route is."""
    hr = torch.empty(psf.shape, dtype=dtype, device=psf.device)
    hi = torch.empty_like(hr)
    for b in range(psf.shape[0]):
        r, i = make_full_psfhat(psf[b].to(torch.float64))
        hr[b] = r
        hi[b] = i
        del r, i
    return hr, hi


def h_from_jax_full(HrT, HiT):
    """The JAX package's K11 operands -> the port's: ``psf_convolve_pallas``
    takes the full transfer function transposed, (nb, NY, NX) (or (NY, NX)
    for one band; ops/psf.py:238-239 swapaxes make_full_psfhat's output),
    and K11 takes (nb, NX, NY). Takes and returns numpy arrays; HiT may be
    None."""
    def one(a):
        return np.ascontiguousarray(np.swapaxes(np.asarray(a), -1, -2))
    return one(HrT), (None if HiT is None else one(HiT))


def v3_space_supported(nx, ny, nspace):
    """The shapes on which the JAX package runs its space-sharded v3
    pipeline (pfb_tpu/ops/psf.py:v3_space_supported): v3, ny splittable
    into nspace 128-column shards and nx into nspace row shards. The
    port's K10 routes on the same rule."""
    return v3_supported(nx, ny) and ny % (nspace * 128) == 0 and \
        nx % nspace == 0


def space_rows(nx, nspace):
    """Rows of the space-sharded half spectrum: nx + 1 (NX/2 + 1 with NX
    = 2 nx) padded to a multiple of ``nspace``."""
    return -(-(nx + 1) // nspace) * nspace


def prep_h_space(psf, nx, ny, nspace, dtype, real_transfer="auto"):
    """K10's transfer function: :func:`prep_h`'s (nb, nx+1, 2ny) rows
    zero-padded to :func:`space_rows` so that the all-to-all between the
    column and row stages splits them evenly (zero H rows give zero
    output rows). Shard it ("band", "space", None). Returns (hr, hi or
    None)."""
    hr, hi = prep_h(psf, nx, ny, dtype, real_transfer=real_transfer)
    pad = space_rows(nx, nspace) - (nx + 1)

    def padded(h):
        return None if h is None else \
            torch.nn.functional.pad(h, (0, 0, 0, pad))
    return padded(hr), padded(hi)


def h_from_jax_space(Hsr, Hsi, nx, ny, nspace):
    """The JAX package's ``prep_pallas_hessian_space`` operands (nb, N1y,
    NXH_pad, N2y), rows padded to nspace * 128, -> the port's K10 H (nb,
    space_rows(nx, nspace), 2ny). Takes and returns numpy arrays; Hsi may
    be None."""
    hr, hi = h_from_jax_v3(Hsr, Hsi, nx, ny)
    pad = ((0, 0), (0, space_rows(nx, nspace) - (nx + 1)), (0, 0))
    return np.pad(hr, pad), (None if hi is None else np.pad(hi, pad))


# ---------------------------------------------------------------------
# K10: K1's stages as separate calls on space shards


def _keep(NX, keep):
    """The spectrum rows a column stage keeps: NX/2 + 1 (the Hermitian
    half) unless given; NX/2 + 1 <= keep <= NX."""
    keep = NX // 2 + 1 if keep is None else int(keep)
    if NX % 2 or not NX // 2 + 1 <= keep <= NX:
        raise ValueError(f"column stage: keep {keep} outside "
                         f"[{NX // 2 + 1}, {NX}] for NX {NX}")
    return keep


def psf_stage_cols_fwd_plain(x, NX, rows, keep=None):
    """Plain version of K10 stage 1 (and of K15's forward): spectrum rows
    0 .. keep - 1 of the zero-padded columns' x transform, rows padded
    with zeros to ``rows``; returns (zr, zi)."""
    keep = _keep(NX, keep)
    if keep == NX // 2 + 1:
        z = torch.fft.rfft(x, n=NX, dim=-2)
    else:
        z = torch.fft.fft(x, n=NX, dim=-2)[..., :keep, :]
    z = torch.nn.functional.pad(z, (0, 0, 0, rows - keep))
    return z.real.contiguous(), z.imag.contiguous()


def cols_fwd_launch(name, x, NX, rows, keep):
    """Launch the forward column stage on validated shapes, on
    :func:`cols_route`'s kernel (the calling wrapper counts its own
    launch; the cluster kernel's is counted here)."""
    nb, nx, L = x.shape
    kernels.require_cuda_f32(name, x)
    zr = torch.empty((nb, rows, L), dtype=torch.float32, device=x.device)
    zi = torch.empty_like(zr)
    C, TX, TM, TN = _cols_tables(NX, L, x.device)
    code = kernels.library().pfbt_psf_stage_cols_fwd(
        x.data_ptr(), zr.data_ptr(), zi.data_ptr(), nb, nx, L, NX, keep,
        rows, C, TX, TM, TN, kernels.stream_ptr())
    kernels.check(code, name)
    _count_cols(C, inv=0)
    return zr, zi


def psf_stage_cols_fwd(x, NX, rows, keep=None):
    """K10 stage 1 (counterpart of psf_v3_stage_k1): x (nb, nx, nyl)
    column shard -> (zr, zi), each (nb, rows, nyl), the x spectrum of the
    columns zero-padded to NX, rows keep (default NX/2 + 1) .. rows - 1
    zero. The CUDA kernel for CUDA tensors, the plain version on the
    CPU."""
    nb, nx, L = x.shape
    keep = _keep(NX, keep)
    if nx > NX or rows < keep:
        raise ValueError(f"psf_stage_cols_fwd: x {tuple(x.shape)}, NX {NX}, "
                         f"rows {rows}, keep {keep}")
    if not x.is_cuda:
        return psf_stage_cols_fwd_plain(x, NX, rows, keep)
    out = cols_fwd_launch("psf_stage_cols_fwd", x, NX, rows, keep)
    psf_stage_cols_fwd.launches += 1
    return out


psf_stage_cols_fwd.launches = 0


def psf_stage_rows_plain(zr, zi, hr, hi):
    """Plain version of K10 stage 2: fft of the rows zero-padded to NY,
    product with H, unscaled inverse fft, crop; returns (wr, wi)."""
    ny, NY = zr.shape[-1], hr.shape[-1]
    h = hr if hi is None else torch.complex(hr, hi)
    w = torch.fft.ifft(torch.fft.fft(torch.complex(zr, zi), n=NY, dim=-1) * h,
                       dim=-1, norm="forward")[..., :ny]
    return w.real.contiguous(), w.imag.contiguous()


def psf_stage_rows(zr, zi, hr, hi=None):
    """K10 stage 2 (counterpart of psf_v3_stage_k2): the spectrum rows
    (nb, rl, ny) of a row shard against the matching H rows (nb, rl, NY)
    -> (wr, wi) (nb, rl, ny), the inverse y transform left unscaled (stage
    3 scales). The CUDA kernel for CUDA tensors (:func:`rows_route`'s),
    the plain version on the CPU."""
    if zi.shape != zr.shape or hr.shape[:-1] != zr.shape[:-1] or \
            hr.shape[-1] < zr.shape[-1] or \
            (hi is not None and hi.shape != hr.shape):
        raise ValueError(f"psf_stage_rows: z {tuple(zr.shape)}, H "
                         f"{tuple(hr.shape)} do not match")
    if not zr.is_cuda:
        return psf_stage_rows_plain(zr, zi, hr, hi)
    kernels.require_cuda_f32("psf_stage_rows", zr, zi, hr, hi)
    ny, NY = zr.shape[-1], hr.shape[-1]
    wr = torch.empty_like(zr)
    wi = torch.empty_like(zr)
    TY, fused, nfused = _rows_args(NY, zr.device)
    code = kernels.library().pfbt_psf_stage_rows(
        zr.data_ptr(), zi.data_ptr(), hr.data_ptr(),
        None if hi is None else hi.data_ptr(), wr.data_ptr(), wi.data_ptr(),
        zr.numel() // ny, ny, NY, TY, fused, nfused, kernels.stream_ptr())
    kernels.check(code, "psf_stage_rows")
    _count_rows(fused, nfused)
    psf_stage_rows.launches += 1
    return wr, wi


psf_stage_rows.launches = 0


def psf_stage_cols_inv_plain(wr, wi, nx, NX, NY, keep=None):
    """Plain version of K10 stage 3 (and of K15's inverse): rows 0 ..
    keep - 1, rows keep .. NX - 1 the conjugate mirror of rows 1 .. NX -
    keep; the real part of the inverse x transform, cropped to nx, / NY.
    With the default keep = NX/2 + 1 that is the irfft of the Hermitian
    half (rows 0 and NX/2 read as real, as the kernel does)."""
    keep = _keep(NX, keep)
    w = torch.complex(wr[..., :keep, :], wi[..., :keep, :])
    if keep == NX // 2 + 1:
        w[..., 0, :].imag.zero_()
        w[..., NX // 2, :].imag.zero_()
        y = torch.fft.irfft(w, n=NX, dim=-2)
    else:
        mirror = w[..., 1:NX - keep + 1, :].conj().flip(-2)
        y = torch.fft.ifft(torch.cat([w, mirror], dim=-2), dim=-2).real
    return y[..., :nx, :] / NY


def cols_inv_launch(name, wr, wi, nx, NX, keep, scale):
    """Launch the inverse column stage on validated shapes, output times
    ``scale``, on :func:`cols_route`'s kernel (the calling wrapper counts
    its own launch; the cluster kernel's is counted here)."""
    nb, rows, L = wr.shape
    kernels.require_cuda_f32(name, wr, wi)
    out = torch.empty((nb, nx, L), dtype=torch.float32, device=wr.device)
    C, TX, TM, TN = _cols_tables(NX, L, wr.device)
    code = kernels.library().pfbt_psf_stage_cols_inv(
        wr.data_ptr(), wi.data_ptr(), out.data_ptr(), nb, nx, L, NX, keep,
        rows, scale, C, TX, TM, TN, kernels.stream_ptr())
    kernels.check(code, name)
    _count_cols(C, fwd=0)
    return out


def psf_stage_cols_inv(wr, wi, nx, NX, NY, keep=None):
    """K10 stage 3 (counterpart of psf_v3_stage_k3): rows 0 .. keep - 1
    (default NX/2 + 1, the Hermitian half) of the column shard (nb, rows,
    nyl), read at the padded row stride with no copy -> (nb, nx, nyl), the
    real inverse x transform scaled by 1 / (NX NY). The CUDA kernel for
    CUDA tensors, the plain version on the CPU."""
    nb, rows, L = wr.shape
    keep = _keep(NX, keep)
    if wi.shape != wr.shape or nx > NX or rows < keep:
        raise ValueError(f"psf_stage_cols_inv: w {tuple(wr.shape)}, nx {nx}, "
                         f"NX {NX}, keep {keep}")
    if not wr.is_cuda:
        return psf_stage_cols_inv_plain(wr, wi, nx, NX, NY, keep)
    out = cols_inv_launch(
        "psf_stage_cols_inv", wr, wi, nx, NX, keep,
        float(np.float32(1.0) / (np.float32(NX) * np.float32(NY))))
    psf_stage_cols_inv.launches += 1
    return out


psf_stage_cols_inv.launches = 0


def psf_line_lab(stage, a, b=None, *, NX, nx=None, rows=None, hr=None,
                 hi=None, NY=None):
    """The lab's PSF line kernels at any length, whatever the routes say
    (``pfbt_psf_line_lab``: the kernels the lengths below 2048 took before
    the cluster and register routes reached them), with K10's stage
    conventions: stage 1 is :func:`psf_stage_cols_fwd`'s function on
    ``line_fft_kernel`` (x = a, NX, ``rows``; keep NX/2 + 1), stage 2
    :func:`psf_stage_rows`'s on ``psf_rows_kernel`` (a, b against hr, hi;
    NX unused), stage 3 :func:`psf_stage_cols_inv`'s on
    ``line_fft_kernel`` (a, b, ``nx``, NX, ``NY``). A CPU tensor runs the
    stage's plain version. ``psf_line_lab.launches`` counts its launches
    (no path's counter does)."""
    if stage == 1:
        if not a.is_cuda:
            return psf_stage_cols_fwd_plain(a, NX, rows)
        nb, n, L = a.shape
        keep = NX // 2 + 1
        o1 = a.new_empty((nb, rows, L))
        o2 = torch.empty_like(o1)
        args = (a, None, None, None, o1, o2, nb, n, L, NX, keep, rows, 1.0)
        res = (o1, o2)
    elif stage == 2:
        if not a.is_cuda:
            return psf_stage_rows_plain(a, b, hr, hi)
        n, N = a.shape[-1], hr.shape[-1]
        o1, o2 = torch.empty_like(a), torch.empty_like(a)
        args = (a, b, hr, hi, o1, o2, a.numel() // n, n, 1, N, 0, 0, 1.0)
        res = (o1, o2)
    elif stage == 3:
        if not a.is_cuda:
            return psf_stage_cols_inv_plain(a, b, nx, NX, NY)
        nb, r, L = a.shape
        o1 = a.new_empty((nb, nx, L))
        scale = float(np.float32(1.0) / (np.float32(NX) * np.float32(NY)))
        args = (a, b, None, None, o1, None, nb, nx, L, NX, NX // 2 + 1, r,
                scale)
        res = o1
    else:
        raise ValueError(f"psf_line_lab: stage {stage} (1, 2 or 3)")
    kernels.require_cuda_f32("psf_line_lab", *(t for t in args[:4]
                                               if torch.is_tensor(t)))
    N = args[9]
    ptrs = [None if t is None else t.data_ptr() for t in args[:6]]
    code = kernels.library().pfbt_psf_line_lab(
        stage, *ptrs, *args[6:12], args[12],
        kernels.twiddles(N, a.device).data_ptr(), kernels.stream_ptr())
    kernels.check(code, "psf_line_lab")
    psf_line_lab.launches += 1
    return res


psf_line_lab.launches = 0


def make_psf_convolve_pallas(psf, nx, ny, beam=None, sigmainv=0.0,
                             wsum=None, real_transfer="auto"):
    """PSF-Hessian matvec on the PSF-convolution kernels (counterpart of
    pfb_tpu/ops/psf.py:make_psf_convolve_pallas). ``psf`` is the
    (nband, nx_psf, ny_psf) PSF tensor.

    Routed on the JAX package's rule: with psf = 2x image and
    :func:`v3_supported`, K1 (:func:`psf_convolve_h`), and the returned
    matvec has ``.apply(x, consts)``, ``.consts`` and ``.real_transfer``
    so the fused solvers (opt/) keep the JAX package's shape; without a
    beam also ``.apply_cg(p_prev, r, beta, consts)`` on K2 and
    ``.cg_scale = (wsum, sigmainv or None)`` for
    opt/pcg.py:make_pcg_bands_fused. Any other shape takes K11
    (:func:`psf_convolve_full`) with the full complex transfer function
    (``real_transfer`` is not read there, as in the JAX package), and the
    matvec has no ``.apply``: callers take the host-loop solvers.

    The operator works in float32 on CUDA (the kernels' type) and in the
    PSF's dtype on the CPU."""
    dtype = kernel_dtype(psf.device, psf.dtype)
    has_sig = float(sigmainv) != 0.0
    nx_psf, ny_psf = psf.shape[-2:]
    if not (nx_psf == 2 * nx and ny_psf == 2 * ny and v3_supported(nx, ny)):
        hr_f, hi_f = prep_h_full(psf, dtype)

        def matvec_full(x):
            xin = (x * beam if beam is not None else x).to(dtype)
            out = psf_convolve_full(xin.contiguous(), hr_f, hi_f)
            if beam is not None:
                out = out * beam
            if wsum is not None:
                out = out / wsum
            if has_sig:
                out = out + x.to(dtype) * sigmainv
            return out

        return matvec_full

    hr, hi = prep_h(psf, nx, ny, dtype, real_transfer=real_transfer)

    def apply(x, consts):
        beam_c = consts["beam"]
        xin = (x * beam_c if beam_c is not None else x).to(dtype)
        out = psf_convolve_h(xin.contiguous(), consts["hr"], consts["hi"])
        if beam_c is not None:
            out = out * beam_c
        if wsum is not None:
            out = out / wsum
        if has_sig:
            out = out + x.to(dtype) * sigmainv
        return out

    consts = {"hr": hr, "hi": hi, "beam": beam}

    def matvec(x):
        return apply(x, consts)

    matvec.apply = apply
    matvec.consts = consts
    matvec.real_transfer = hi is None
    matvec.dtype = dtype
    if beam is None:
        def apply_cg(p_prev, r, beta, consts):
            """The CG-fused matvec (K2): p = beta p_prev - r, conv(p)
            and [p . conv(p), p . p]; the solver folds wsum and
            sigmainv in (cg_scale)."""
            return psf_convolve_h_cg(p_prev, r, beta, consts["hr"],
                                     consts["hi"])

        matvec.apply_cg = apply_cg
        matvec.cg_scale = (wsum, sigmainv if has_sig else None)
    return matvec
