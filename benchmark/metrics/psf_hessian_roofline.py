"""The PSF Hessian's share of its roofline: the least time of one
application at the H100's published peaks (harness/roofline.py: x, H
and out moved once, the column and row transforms and the product
counted) over the device time of the PSF kernels (``psf_*_kernel`` by
name in the trace) per application the program's launch counter counts (K1 or
K11, whichever spotless built)."""

import re

from harness.roofline import bound

PSF_KERNEL = re.compile(r"(^|\W)psf_\w*kernel")


def read(ctx):
    sp = ctx["spans"]
    work = sp.notes.get("psf_work")
    calls = ctx["launches"].get(sp.notes.get("psf_counter"), 0)
    dev = sum(s for n, (s, _) in ctx["by_kernel"].items()
              if PSF_KERNEL.search(n))
    if work is None or not calls or dev <= 0:
        return None
    return 100.0 * bound(*work)[0] / (1e3 * dev / calls)
