"""The full PSF transfer function (counterpart of
pfb_tpu/ops/mmfft.py:make_full_psfhat).

Only this helper comes over. The JAX module's matmul FFTs compute
functions the port already runs on the card: ``fft_mm_last`` and
``fft2_mm`` are 2-D FFTs (cuFFT, or ops/cfft.py's K3c / K3r on the
w-plane stacks), and ``psf_convolve_mm`` is the PSF convolution with the
full transfer function (ops/psf.py:psf_convolve_full, kernel K11, which
multiplies by the full fft2 transfer function this builds). They were
the TPU's way round a slow XLA FFT.
"""

import torch

from pfb_tpu_torch.ops.fft import _band_chunks


def _full(sh):
    N2 = sh.shape[-1]
    H2 = N2 // 2 + 1
    half = torch.fft.rfft2(sh, dim=(-2, -1))  # (..., N1, H2)
    hr, hi = half.real, half.imag
    # the missing columns k2 = H2..N2-1 mirror k2' = N2-k2 in 1..N2-H2,
    # with the rows reversed mod N1: row 0 stays, rows 1..N1-1 flip
    src = hr[..., :, 1:N2 - H2 + 1].flip(-1)
    srci = hi[..., :, 1:N2 - H2 + 1].flip(-1)
    mr = torch.cat([src[..., :1, :], src[..., 1:, :].flip(-2)], dim=-2)
    mi = -torch.cat([srci[..., :1, :], srci[..., 1:, :].flip(-2)], dim=-2)
    return torch.cat([hr, mr], dim=-1), torch.cat([hi, mi], dim=-1)


def make_full_psfhat(psf, band_chunk=None):
    """Full (fft2, not rfft2) transform of ifftshift(psf) over the last
    two axes as real and imaginary parts, built from the rfft2 half
    spectrum by Hermitian extension: for a real input X[N1-k1 mod N1,
    N2-k2 mod N2] = conj X[k1, k2]. Works in the PSF's dtype (the JAX
    package casts to float32 first). ``band_chunk`` bounds the FFT
    workspace of a cube by transforming that many bands at a time."""
    sh = torch.fft.ifftshift(psf, dim=(-2, -1))
    if band_chunk is None or sh.ndim == 2 or sh.shape[0] <= band_chunk:
        return _full(sh)
    hr, hi = torch.empty_like(sh), torch.empty_like(sh)
    return _band_chunks(_full, sh, band_chunk, hr, hi)
