"""The table of peaks and the operations and bytes of a kernel: a copy
of chip_smoke.py's arithmetic (``bound``, ``fft_flops``, ``conv_work``),
held to the original by benchmark/tests/test_bench_roofline.py.

Peaks are the published ones of one NVIDIA H100 SXM at its 700 W limit
(NVIDIA's data sheet, dense rates): the run prints the card's power
limit beside every share of them."""

import math

HBM_BPS = 3.35e12  # H100 SXM memory rate (NVIDIA data sheet)
FP32_FLOPS = 67e12  # H100 SXM FP32 rate outside the tensor cores
BF16_TC_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate (data sheet)


def bound(nbytes, flops, tc_flops=0.0):
    """(bound_ms, bound_by): the largest of the bytes over the memory
    rate, the FP32 operations over the FP32 rate and the bf16 tensor-core
    operations over the tensor-core rate."""
    tb = nbytes / HBM_BPS
    tf = max(flops / FP32_FLOPS, tc_flops / BF16_TC_FLOPS)
    return 1e3 * max(tb, tf), "bytes" if tb >= tf else "operations"


def fft_flops(n, lines, real=False):
    """5 n log2 n operations for each complex line of length n (half for
    a real line)."""
    return lines * 5.0 * n * math.log2(n) * (0.5 if real else 1.0)


def conv_work(nb, nx, ny, NX, NY, hr_numel, complex_h, extra=0):
    """(bytes, operations) of a padded PSF convolution of an (nb, nx, ny)
    cube: x read, H (``hr_numel`` elements, twice for a complex H) read,
    out written, plus ``extra`` cube passes of 4 bytes an element; per
    band a real x transform of each of ny columns and back, a complex y
    transform of NX/2 + 1 rows and back, the product with H."""
    nxh = NX // 2 + 1
    nbytes = 4 * ((2 + extra) * nb * nx * ny
                  + hr_numel * (2 if complex_h else 1))
    flops = nb * (fft_flops(NX, 2 * ny, real=True) + fft_flops(NY, 2 * nxh)
                  + nxh * NY * (6 if complex_h else 2))
    return nbytes, flops
