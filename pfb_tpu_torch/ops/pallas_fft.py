"""Single-band PSF convolutions and the v3 column transforms (counterpart
of the public functions of pfb_tpu/ops/pallas_fft.py that ops/psf.py
does not already hold), so each one sits at the JAX package's path.

The device code is K1's and K11's (``csrc/psf_conv.cu``); this module
routes and adapts operands, and every entry point counts its own launches
(``.launches``) beside a plain PyTorch version that a CPU tensor runs:

- K12 :func:`psf_convolve_pallas_v3`: one band of K1 against the
  Hermitian half of H;
- K13 :func:`psf_convolve_pallas_v2` and K14 :func:`psf_convolve_pallas_opt`:
  one band of K11 against the full complex H. For a real x,
  Re(ifft2(H X)) = ifft2(H_h X) with H_h = (H(k) + conj H(-k)) / 2, the
  Hermitian part K11 forms in its rows stage, and K11 already skips the
  padded input's zero half and the cropped output's discarded half (its
  column stages read nx rows and write nx rows), which is what K14 adds
  over the JAX package's unfused pipeline;
- K15 :func:`v3_cols_fwd` / :func:`v3_cols_inv`: the column stages on
  the v3 row layout of NXH = NX/2 + N1x spectrum rows (``_k1h_kernel`` /
  ``_k3h_kernel``), through K10's column-stage entries with ``keep`` =
  NXH;
- :func:`psf_convolve_pallas` and :func:`psf_convolve_pallas_cube`: K11
  under the JAX package's names.

Every transfer function here is in the port's natural layout (kx, ky):
:func:`prep_H_v3` and :func:`scramble_HT` take the JAX functions'
transposed (NY, NX) H and return K1's and K11's H. The JAX package's
scramble is a TPU lane layout that the card does not need, and redoing it
per call would copy H every matvec. ``ops/psf.py:h_from_jax_v3`` and
:func:`h_from_jax_v2` convert scrambled JAX operands for the tests.

The TPU-only knobs (``lane_block``, ``row_block``, ``interpret``,
``vmem_mb``, ``precision``) are not taken: the card runs FP32 throughout,
where the TPU's DEFAULT precision is a single bf16 pass.
"""

import torch

from pfb_tpu_torch import kernels
from pfb_tpu_torch.ops.cfft import _factor
from pfb_tpu_torch.ops.psf import (_conv_stages, cols_fwd_launch,
                                   cols_inv_launch, psf_convolve_full,
                                   psf_convolve_full_plain,
                                   psf_convolve_h_plain,
                                   psf_stage_cols_fwd_plain,
                                   psf_stage_cols_inv_plain, unscramble_jax,
                                   v3_supported)

__all__ = ["v3_supported", "prep_H_v3", "scramble_HT", "v3_rows",
           "psf_convolve_pallas_v3", "psf_convolve_pallas_v3_plain",
           "psf_convolve_pallas_v2", "psf_convolve_pallas_v2_plain",
           "psf_convolve_pallas_opt", "psf_convolve_pallas_opt_plain",
           "psf_convolve_pallas", "psf_convolve_pallas_cube",
           "v3_cols_fwd", "v3_cols_fwd_plain", "v3_cols_inv",
           "v3_cols_inv_plain", "h_from_jax_v2"]


def _factor_lane(N):
    """The TPU's lane split N = N1 x 128 (pallas_fft.py:245)."""
    if N % 128:
        raise ValueError(f"_factor_lane: {N} is not a multiple of 128")
    return N // 128, 128


def v3_rows(NX):
    """NXH = N1x (N2x/2 + 1) = NX/2 + N1x: the x-spectrum rows the v3
    column transforms keep, (N1x, N2x) = _factor(NX)."""
    N1, N2 = _factor(NX)
    return N1 * (N2 // 2 + 1)


def prep_H_v3(HT):
    """K1's transfer function from the transposed full H (..., NY, NX)
    that the JAX ``prep_H_v3`` takes: rows kx <= NX/2 as (..., NX/2 + 1,
    NY)."""
    NX = HT.shape[-1]
    return HT.transpose(-1, -2)[..., :NX // 2 + 1, :].contiguous()


def scramble_HT(HT):
    """K11's transfer function from the transposed full H (..., NY, NX)
    that the JAX ``scramble_HT`` takes: (..., NX, NY)."""
    return HT.transpose(-1, -2).contiguous()


def h_from_jax_v2(Hsr, Hsi):
    """The JAX package's v2 operands, ``scramble_HT`` of the full H, (...,
    N1y, NX, N2y) -> the port's (..., NX, NY). Takes and returns numpy
    arrays; Hsi may be None."""
    return unscramble_jax(Hsr), (None if Hsi is None else unscramble_jax(Hsi))


def _band(t):
    return None if t is None else t[None]


def psf_convolve_pallas_v3_plain(x, hr, hi):
    """Plain version of K12: K1's plain version on one band."""
    return psf_convolve_h_plain(x[None], hr[None], _band(hi))[0]


def psf_convolve_pallas_v3(x, hr, hi, nx, ny):
    """K12 (counterpart of psf_convolve_pallas_v3): the PSF convolution
    crop(ifft2(H fft2(pad x))) of one (nx, ny) band at psf_oversize 2,
    with H as K1's Hermitian half (nx + 1, 2ny) real part and imaginary
    part (``hi`` None: a real H, an even PSF). Raises ValueError where the
    JAX function asserts. The CUDA kernel for CUDA tensors, the plain
    version on the CPU."""
    NX, NY = 2 * nx, 2 * ny
    if not v3_supported(nx, ny):
        raise ValueError(f"psf_convolve_pallas_v3: ({nx}, {ny}) is not a v3 "
                         "shape")
    if tuple(x.shape) != (nx, ny) or tuple(hr.shape) != (nx + 1, NY) or \
            (hi is not None and hi.shape != hr.shape):
        raise ValueError(f"psf_convolve_pallas_v3: x {tuple(x.shape)}, H "
                         f"{tuple(hr.shape)} do not match ({nx}, {ny})")
    if not x.is_cuda:
        return psf_convolve_pallas_v3_plain(x, hr, hi)
    kernels.require_cuda_f32("psf_convolve_pallas_v3", x, hr, hi)
    out = _conv_stages("pfbt_psf_conv", x[None], hr[None], _band(hi), NX,
                       NY)[0]
    psf_convolve_pallas_v3.launches += 1
    return out


psf_convolve_pallas_v3.launches = 0


def psf_convolve_pallas_v2_plain(x, hr, hi):
    """Plain version of K13 and K14: K11's plain version on one band,
    Re(ifft2(H fft2(pad x))) cropped."""
    return psf_convolve_full_plain(x[None], hr[None], _band(hi))[0]


psf_convolve_pallas_opt_plain = psf_convolve_pallas_v2_plain


def _full_band(fn, x, hr, hi, nx, ny):
    """One band of K11 at psf_oversize 2 for the entry point ``fn``,
    which counts the launch."""
    NX, NY = 2 * nx, 2 * ny
    if tuple(hr.shape) != (NX, NY):
        raise ValueError(f"{fn.__name__} requires psf_oversize == 2: H "
                         f"{tuple(hr.shape)} for ({nx}, {ny})")
    if tuple(x.shape) != (nx, ny) or (hi is not None and
                                      hi.shape != hr.shape):
        raise ValueError(f"{fn.__name__}: x {tuple(x.shape)}, H "
                         f"{tuple(hr.shape)} do not match ({nx}, {ny})")
    if not x.is_cuda:
        return psf_convolve_pallas_v2_plain(x, hr, hi)
    kernels.require_cuda_f32(fn.__name__, x, hr, hi)
    out = _conv_stages("pfbt_psf_conv_full", x[None], hr[None], _band(hi),
                       NX, NY)[0]
    fn.launches += 1
    return out


def psf_convolve_pallas_v2(x, hr, hi, nx, ny):
    """K13 (counterpart of psf_convolve_pallas_v2): one (nx, ny) band at
    psf_oversize 2 against the full (2nx, 2ny) transfer function, real
    and imaginary parts (:func:`h_from_jax_v2` converts the JAX package's
    scrambled operands): Re(ifft2(H fft2(pad x))) cropped. The CUDA
    kernel (K11's) for CUDA tensors, the plain version on the CPU."""
    return _full_band(psf_convolve_pallas_v2, x, hr, hi, nx, ny)


psf_convolve_pallas_v2.launches = 0


def psf_convolve_pallas_opt(x, hr, hi, nx, ny):
    """K14 (counterpart of psf_convolve_pallas_opt, the zero- and
    crop-aware pipeline): :func:`psf_convolve_pallas_v2`'s function, H
    in the port's (NX, NY) layout (``ops/psf.py:h_from_jax_full`` converts
    the JAX package's transposed one); raises ValueError unless
    psf_oversize is 2, as the JAX function asserts."""
    return _full_band(psf_convolve_pallas_opt, x, hr, hi, nx, ny)


psf_convolve_pallas_opt.launches = 0


def psf_convolve_pallas(x, hr, hi, nx, ny):
    """K11 on one (nx, ny) band (counterpart of psf_convolve_pallas): any
    full (NX, NY) transfer function with NX >= nx, NY >= ny, counted by
    ``ops/psf.py:psf_convolve_full``."""
    if tuple(x.shape) != (nx, ny):
        raise ValueError(f"psf_convolve_pallas: x {tuple(x.shape)} is not "
                         f"({nx}, {ny})")
    return psf_convolve_full(x[None], hr[None], _band(hi))[0]


def psf_convolve_pallas_cube(x, hr, hi, nx, ny):
    """K11 on an (nb, nx, ny) cube with (nb, NX, NY) transfer functions
    (counterpart of psf_convolve_pallas_cube's band loop: here the bands
    share one launch sequence)."""
    if tuple(x.shape[-2:]) != (nx, ny):
        raise ValueError(f"psf_convolve_pallas_cube: x {tuple(x.shape)} is "
                         f"not (nb, {nx}, {ny})")
    return psf_convolve_full(x, hr, hi)


def _v3_cols(nx):
    """(NX, NXH) of K15 at nx image rows; the TPU kernels' factor rule
    (N1x, N2x even, N2x | N1x; pallas_fft.py:771, v3_supported)."""
    NX = 2 * nx
    N1, N2 = _factor(NX)
    if N1 % 2 or N2 % 2 or N1 % N2:
        raise ValueError(f"v3 column transforms: NX = {NX} factors as "
                         f"({N1}, {N2}), outside the v3 rule")
    return NX, v3_rows(NX)


def v3_cols_fwd_plain(x, nx):
    """Plain version of K15's forward."""
    NX, NXH = _v3_cols(nx)
    return psf_stage_cols_fwd_plain(x, NX, NXH, keep=NXH)


def v3_cols_fwd(x, nx):
    """K15 forward (counterpart of ``_k1h_kernel``): the real (nb, nx, L)
    columns zero-padded to NX = 2nx -> (zr, zi), each (nb, NXH, L), the
    x spectrum's rows k < NXH. The CUDA kernel for CUDA tensors, the plain
    version on the CPU."""
    NX, NXH = _v3_cols(nx)
    if x.dim() != 3 or x.shape[1] != nx:
        raise ValueError(f"v3_cols_fwd: x {tuple(x.shape)} is not (nb, "
                         f"{nx}, L)")
    if not x.is_cuda:
        return v3_cols_fwd_plain(x, nx)
    out = cols_fwd_launch("v3_cols_fwd", x, NX, NXH, NXH)
    v3_cols_fwd.launches += 1
    return out


v3_cols_fwd.launches = 0


def v3_cols_inv_plain(wr, wi, nx):
    """Plain version of K15's inverse."""
    NX, NXH = _v3_cols(nx)
    return psf_stage_cols_inv_plain(wr, wi, nx, NX, 1, keep=NXH)


def v3_cols_inv(wr, wi, nx):
    """K15 inverse (counterpart of ``_k3h_kernel``): spectrum rows k <
    NXH (nb, NXH, L), rows NX - m rebuilt as conj of rows m = 1 .. NX/2 -
    N1x, -> (nb, nx, L), the real part of the inverse x transform scaled
    by 1 / NX. Rows NX/2 + 1 .. NXH - 1 are read as given, so a
    non-Hermitian input gives the TPU kernel's answer. The CUDA kernel for
    CUDA tensors, the plain version on the CPU."""
    NX, NXH = _v3_cols(nx)
    if wr.dim() != 3 or wr.shape[1] != NXH or wi.shape != wr.shape:
        raise ValueError(f"v3_cols_inv: w {tuple(wr.shape)} is not (nb, "
                         f"{NXH}, L)")
    if not wr.is_cuda:
        return v3_cols_inv_plain(wr, wi, nx)
    out = cols_inv_launch("v3_cols_inv", wr, wi, nx, NX, NXH, 1.0 / NX)
    v3_cols_inv.launches += 1
    return out


v3_cols_inv.launches = 0
