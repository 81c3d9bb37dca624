"""Plain SARA dictionary: the image itself and Daubechies wavelets over
a few levels, with zero extension at the edges.

Per axis of length N and filter length F (even):
- analysis: C = (N + F - 1) // 2 coefficients, c[o] = sum_j f[j]
  x[2o + 1 - j], x zero outside [0, N);
- synthesis of C coefficients to O = 2C - F + 2 samples:
  y[2m] = sum_j f[2j] c[m + F/2 - 1 - j],
  y[2m + 1] = sum_j f[2j + 1] c[m + F/2 - 1 - j], c zero outside [0, C).
A level splits an image into four bands (lo/hi along each axis) and the
next level splits the lo-lo band. Synthesis runs from the deepest level
up, each level's reconstruction cropped to the lo-lo band it replaces,
and the last to the image. Coefficients are kept flat, every basis's
bands joined (their layout does not enter the solver: the prox is
elementwise over coefficients, so any order of them serves).
"""

import math

import torch

S3 = math.sqrt(3.0)
_REC_LO = {
    "db1": (1 / math.sqrt(2.0), 1 / math.sqrt(2.0)),
    "db2": tuple(c / (4 * math.sqrt(2.0))
                 for c in (1 + S3, 3 + S3, 3 - S3, 1 - S3)),
}


def bank(name):
    """(dec_lo, dec_hi, rec_lo, rec_hi) of a Daubechies basis."""
    rec_lo = _REC_LO[name]
    dec_lo = rec_lo[::-1]
    rec_hi = tuple(((-1) ** i) * c for i, c in enumerate(dec_lo))
    return dec_lo, rec_hi[::-1], rec_lo, rec_hi


def _analysis(x, f, dim):
    """Filter and decimate along ``dim``."""
    x = x.movedim(dim, -1)
    N, F = x.shape[-1], len(f)
    C = (N + F - 1) // 2
    # c[o] = sum_j f[j] x[2o + 1 - j]: pad so that x index i sits at
    # i + F - 2 (the smallest index read is 2*0 + 1 - (F - 1))
    xp = torch.nn.functional.pad(x, (F - 2, 2 * C - N + 1))
    out = None
    for j, fj in enumerate(f):
        s = F - 1 - j
        term = fj * xp[..., s:s + 2 * C:2]
        out = term if out is None else out + term
    return out.movedim(-1, dim)


def _synthesis(c, f, O, dim):
    """Upsample and filter along ``dim`` to O samples."""
    c = c.movedim(dim, -1)
    C, h = c.shape[-1], len(f) // 2
    M = (O + 1) // 2
    # c[m + h - 1 - j] for m < M reads up to index M + h - 2
    cp = torch.nn.functional.pad(c, (0, max(0, M + h - 1 - C)))
    ev = od = None
    for j in range(h):
        seg = cp[..., h - 1 - j:h - 1 - j + M]
        ev = f[2 * j] * seg if ev is None else ev + f[2 * j] * seg
        od = f[2 * j + 1] * seg if od is None else od + f[2 * j + 1] * seg
    y = torch.stack([ev, od], dim=-1).reshape(*c.shape[:-1], 2 * M)
    return y[..., :O].movedim(-1, dim)


def dwt(img, name, nlevel):
    """Multi-level analysis of (..., nx, ny): list of coefficient
    tensors [detail bands per level..., final lo-lo]."""
    dl, dh, _, _ = bank(name)
    out = []
    a = img
    for _ in range(nlevel):
        lo = _analysis(a, dl, -1)
        hi = _analysis(a, dh, -1)
        ll = _analysis(lo, dl, -2)
        out += [_analysis(lo, dh, -2), _analysis(hi, dl, -2),
                _analysis(hi, dh, -2)]
        a = ll
    out.append(a)
    return out


def idwt(coeffs, name, nlevel, nx, ny):
    """Synthesis of :func:`dwt`'s list to (..., nx, ny)."""
    _, _, rl, rh = bank(name)
    F = len(rl)
    rec = coeffs[-1]
    for lev in range(nlevel - 1, -1, -1):
        lh, hl, hh = coeffs[3 * lev:3 * lev + 3]
        Cx, Cy = lh.shape[-2], lh.shape[-1]
        ll = rec[..., :Cx, :Cy]
        Ox, Oy = 2 * Cx - F + 2, 2 * Cy - F + 2
        lo = _synthesis(ll, rl, Ox, -2) + _synthesis(lh, rh, Ox, -2)
        hi = _synthesis(hl, rl, Ox, -2) + _synthesis(hh, rh, Ox, -2)
        rec = _synthesis(lo, rl, Oy, -1) + _synthesis(hi, rh, Oy, -1)
    return rec[..., :nx, :ny]


class Sara:
    """Psi: image (nb, nx, ny) -> coefficients (nb, ncoef), every basis's
    bands flattened and joined; Psi.H splits them and sums the bases'
    syntheses."""

    def __init__(self, nx, ny, bases=("self", "db1", "db2"), nlevel=3):
        self.nx, self.ny, self.bases, self.nlevel = nx, ny, bases, nlevel
        self.nbasis = len(bases)
        probe = self._parts(torch.zeros((1, nx, ny), dtype=torch.float64))
        self.shapes = [[t.shape[1:] for t in b] for b in probe]
        self.sizes = [t.numel() for b in probe for t in b]

    def _parts(self, x):
        return [[x] if b == "self" else dwt(x, b, self.nlevel)
                for b in self.bases]

    def dot(self, x):
        nb = x.shape[0]
        return torch.cat([t.reshape(nb, -1) for b in self._parts(x)
                          for t in b], dim=1)

    def hdot(self, flat):
        nb = flat.shape[0]
        pieces = iter(torch.split(flat, self.sizes, dim=1))
        out = None
        for b, shapes in zip(self.bases, self.shapes):
            c = [next(pieces).reshape(nb, *s) for s in shapes]
            term = c[0] if b == "self" else idwt(c, b, self.nlevel,
                                                  self.nx, self.ny)
            out = term if out is None else out + term
        return out
