"""FFT helpers (counterpart of pfb_tpu/ops/fft.py).

Conventions (identical to pfb_tpu and the reference):
- ``psfhat = rfft2(ifftshift(psf))``, forward unnormalised;
- the inverse transform is normalised by 1/N.

:func:`psf_convolve_cube` is the plain version of the PSF-convolution
kernel in ops/psf.py.
"""

import torch


def good_size(n: int, even: bool = False) -> int:
    """Smallest 5-smooth number >= n (optionally even)."""
    if n <= 2:
        return max(n, 1) if not even else 2

    def smooth(m):
        for p in (2, 3, 5):
            while m % p == 0:
                m //= p
        return m == 1

    m = n
    while True:
        if smooth(m) and (not even or m % 2 == 0):
            return m
        m += 1


def good_even_size(n: int) -> int:
    """Smallest even 5-smooth number >= n (reference
    pfb/workers/grid.py:259-262 sizing loop)."""
    m = good_size(n)
    while m % 2:
        m = good_size(m + 1)
    return m


def fft2d(x, axes=(-2, -1)):
    """rfft2 of ifftshift(x) over ``axes``, forward unnormalised."""
    return torch.fft.rfft2(torch.fft.ifftshift(x, dim=axes), dim=axes)


def fft_cube(x):
    """Per-band rfft2 of ifftshift over the last two axes."""
    return fft2d(x, axes=(-2, -1))


def _band_chunks(fn, x, band_chunk, *outs):
    """fn over ``band_chunk`` bands of x at a time, each chunk's results
    written into ``outs`` (preallocated, one per result of fn), so the
    transform's workspace is one chunk's. Returns ``outs``."""
    for b in range(0, x.shape[0], band_chunk):
        res = fn(x[b:b + band_chunk])
        for out, r in zip(outs, res if isinstance(res, tuple) else (res,)):
            out[b:b + band_chunk] = r
    return outs


def make_psfhat(psf, band_chunk=None):
    """PSFHAT from a PSF image or cube: rfft2(ifftshift(psf)).
    ``band_chunk`` bounds the FFT workspace of a big cube by
    transforming that many bands at a time."""
    if band_chunk is None or psf.ndim == 2 or psf.shape[0] <= band_chunk:
        return fft2d(psf)
    nb, NX, NY = psf.shape
    out = torch.empty((nb, NX, NY // 2 + 1), device=psf.device,
                      dtype=torch.promote_types(psf.dtype, torch.complex64))
    return _band_chunks(fft2d, psf, band_chunk, out)[0]


def _convolve(x, psfhat, lastsize):
    nx, ny = x.shape[-2:]
    nx_psf = psfhat.shape[-2]
    xpad = torch.nn.functional.pad(x, (0, lastsize - ny, 0, nx_psf - nx))
    xhat = torch.fft.rfft2(xpad, dim=(-2, -1)) * psfhat
    out = torch.fft.irfft2(xhat, s=(nx_psf, lastsize), dim=(-2, -1))
    return out[..., :nx, :ny]


def psf_convolve_slice(x, psfhat, lastsize):
    """Zero-pad -> rfft2 -> * psfhat -> irfft2 -> unpad for one (nx, ny)
    image; psfhat is rfft2(ifftshift(psf)) of a (nx_psf, lastsize) PSF."""
    return _convolve(x, psfhat, lastsize)


def psf_convolve_cube(x, psfhat, lastsize, band_chunk=None):
    """Batched PSF convolution over the band axis: x (nband, nx, ny),
    psfhat (nband, nx_psf, lastsize//2+1). ``band_chunk`` bounds the FFT
    workspace by convolving that many bands at a time."""
    if band_chunk is None or x.shape[0] <= band_chunk:
        return _convolve(x, psfhat, lastsize)
    return torch.cat([_convolve(x[b:b + band_chunk],
                                psfhat[b:b + band_chunk], lastsize)
                      for b in range(0, x.shape[0], band_chunk)])


def get_padding_info(nx, ny, pfrac):
    """Padding bookkeeping for FFT convolutions (host numbers only;
    reference: pfb/utils/misc.py:170-183)."""
    npad_x = int(pfrac * nx)
    nfft = good_size(nx + npad_x, True)
    npad_xl = (nfft - nx) // 2
    npad_xr = nfft - nx - npad_xl
    npad_y = int(pfrac * ny)
    nfft = good_size(ny + npad_y, True)
    npad_yl = (nfft - ny) // 2
    npad_yr = nfft - ny - npad_yl
    padding = ((0, 0), (npad_xl, npad_xr), (npad_yl, npad_yr))
    unpad_x = slice(npad_xl, -npad_xr) if npad_xr else slice(npad_xl, None)
    unpad_y = slice(npad_yl, -npad_yr) if npad_yr else slice(npad_yl, None)
    return padding, unpad_x, unpad_y
