"""Restored-image helper (counterpart of pfb_tpu/utils/restoration.py,
a host module; reference: pfb/utils/restoration.py:6-59)."""

import numpy as np

from pfb_tpu_torch.utils.misc import convolve2gaussres, fitcleanbeam


def restore_image(model, residual, psf_mfs=None, gaussparf=None):
    """model convolved with the (fitted) clean beam + residual."""
    nband, nx, ny = model.shape
    if gaussparf is None:
        if psf_mfs is None:
            raise ValueError("need psf_mfs or gaussparf")
        gaussparf = fitcleanbeam(psf_mfs[None], level=0.5,
                                 pixsize=1.0)[0]
    x = np.arange(-(nx // 2), nx - nx // 2)
    y = np.arange(-(ny // 2), ny - ny // 2)
    xx, yy = np.meshgrid(x, y, indexing="ij")
    return convolve2gaussres(model, xx, yy, gaussparf,
                             norm_kernel=False) + residual
