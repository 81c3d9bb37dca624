"""Mask operator: image <-> unmasked-pixel vector (counterpart of
pfb_tpu/ops/mask.py; reference pfb/operators/mask.py:4-27).

``dot`` is an index gather, ``hdot`` an ``index_copy_`` into zeros
(the JAX package's ``.at[].set``)."""

import numpy as np
import torch


class Mask:
    def __init__(self, mask):
        """mask: (nx, ny) boolean (True = keep)."""
        self.mask = np.asarray(mask, bool)
        self.nx, self.ny = self.mask.shape
        self.idx = torch.as_tensor(np.flatnonzero(self.mask.ravel()))
        self.n = int(self.idx.numel())

    def dot(self, x):
        """image -> vector of unmasked pixels."""
        return x.reshape(*x.shape[:-2], -1)[..., self.idx.to(x.device)]

    def hdot(self, v):
        """vector -> image (zeros elsewhere)."""
        lead = v.shape[:-1]
        flat = torch.zeros((*lead, self.nx * self.ny), dtype=v.dtype,
                           device=v.device)
        flat.index_copy_(-1, self.idx.to(v.device), v)
        return flat.reshape(*lead, self.nx, self.ny)
