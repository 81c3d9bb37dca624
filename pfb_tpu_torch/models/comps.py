"""Continuous time/frequency sky models (the mds contract).

A host copy of pfb_tpu/models/comps.py (numpy, scipy and sympy), so the
port's model2comps, degrid and grid(transfer_model_from) read and write
the same mds stores without importing JAX.

A deconvolved image cube is compressed to its non-zero pixel locations
plus per-pixel coefficients of an additive polynomial basis in scaled
time/frequency coordinates. The on-disk contract (shared with
pfb-clean's pfb/utils/misc.py:1084-1313, so either tool can read the
other's mds) is a sympy expression string over symbols ``t``/``f`` and
named parameters, together with ``texpr``/``fexpr`` strings mapping raw
coordinates to the scaled fit coordinates.

The contract is derived from a small per-axis basis abstraction
(`_AxisBasis`): each axis contributes design-matrix columns and matching
sympy terms; the fit is a standard ridge-regularised weighted least
squares over the concatenated columns.

Note one deliberate deviation from pfb-clean, kept from the JAX package:
when both ntime > 1 and nband > 1 pfb-clean's design-matrix row ordering
does not match its data ordering (misc.py:1112 tiles time values
band-major while the data is time-major); here the time columns are
repeated band-fast so the pairing is consistent for any (ntime, nband).
"""

import numpy as np
import sympy as sm
from scipy.interpolate import RegularGridInterpolator
from sympy.parsing.sympy_parser import parse_expr
from sympy.utilities.lambdify import lambdify


class _AxisBasis:
    """Fit basis for one coordinate axis.

    columns   : (ncoord, nterms) design-matrix columns at the data coords
    terms     : matching sympy expressions in the *scaled* symbol
    coord_map : sympy expression mapping the raw symbol to the scaled one
    """

    def __init__(self, columns, terms, coord_map):
        self.columns = np.asarray(columns, dtype=float)
        self.terms = list(terms)
        self.coord_map = coord_map


def _monomial_axis(vals, sym, powers):
    """Monomials of vals/vals[0] at the given powers."""
    ref = vals[0]
    scaled = vals / ref
    cols = scaled[:, None] ** np.asarray(powers, dtype=float)[None, :]
    terms = [sym ** int(p) for p in powers]
    return _AxisBasis(cols, terms, sym / ref)


def _legendre_axis(vals, sym, orders):
    """Legendre polynomials on vals mapped to [-1, 1].

    A single-point axis is left unscaled (only order-0 terms make
    sense there and P0 == 1 regardless).
    """
    if vals.size > 1:
        mid = (vals.max() + vals.min()) / 2.0
        half = np.abs(vals - mid).max()
        scaled = (vals - mid) / half
        coord_map = (sym - mid) / half
    else:
        scaled = vals
        coord_map = sym
    cols = np.stack(
        [np.polynomial.Legendre.basis(k)(scaled) for k in orders], axis=1)
    terms = [sm.polys.orthopolys.legendre_poly(k, sym) for k in orders]
    return _AxisBasis(cols, terms, coord_map)


_AXIS_BUILDERS = {"poly": _monomial_axis, "Legendre": _legendre_axis}


def fit_image_cube(time, freq, image, wgt=None, nbasist=None,
                   nbasisf=None, method="poly", sigmasq=0):
    """Weighted ridge fit of an (ntime, nband, nx, ny) image cube onto
    an additive time+frequency basis.

    Returns ``(coeffs, Ix, Iy, expr, params, texpr, fexpr)`` — the mds
    contract (reference pfb/utils/misc.py:1084-1214): ``expr`` is a
    sympy expression string in (t, f) over the named ``params``;
    ``texpr``/``fexpr`` map raw time/frequency to the scaled fit
    coordinates.
    """
    time = np.atleast_1d(np.asarray(time, dtype=float))
    freq = np.atleast_1d(np.asarray(freq, dtype=float))
    ntime, nband = time.size, freq.size
    nbasist = ntime if nbasist is None else nbasist
    nbasisf = nband if nbasisf is None else nbasisf
    if nbasist > ntime or nbasisf > nband:
        raise ValueError("cannot fit more basis functions than samples")
    if method not in _AXIS_BUILDERS:
        raise NotImplementedError(f"Unknown fit method {method}")
    build = _AXIS_BUILDERS[method]
    t_sym, f_sym = sm.symbols(("t", "f"))

    support = np.any(image, axis=(0, 1))
    Ix, Iy = np.where(support)
    y = image[:, :, Ix, Iy].reshape(ntime * nband, Ix.size)

    if ntime == 1 and nband == 1:
        # degenerate single-plane cube: one amplitude per pixel
        amp = sm.symbols("a")
        return (y, Ix, Iy, str(amp), [str(amp)], str(t_sym), str(f_sym))

    # time axis always contributes the constant term; the frequency
    # axis only adds non-constant terms (orders >= 1) so the additive
    # model stays identifiable
    taxis = build(time, t_sym, range(nbasist))
    blocks = [np.repeat(taxis.columns, nband, axis=0)]
    terms = list(taxis.terms)
    names = [f"t{i}" for i in range(nbasist)]
    fexpr = f_sym
    if nband > 1:
        faxis = build(freq, f_sym, range(1, nbasisf))
        blocks.append(np.tile(faxis.columns, (ntime, 1)))
        terms += faxis.terms
        names += [f"f{i}" for i in range(1, nbasisf)]
        fexpr = faxis.coord_map

    X = np.concatenate(blocks, axis=1)
    w = (np.ones((ntime * nband, 1)) if wgt is None
         else np.asarray(wgt, dtype=float).reshape(ntime * nband, 1))
    XtW = X.T * w.ravel()
    gram = XtW @ X
    if sigmasq:
        gram = gram + sigmasq * np.eye(gram.shape[0])
    coeffs = np.linalg.solve(gram, XtW @ y)

    params = sm.symbols(names)
    expr = sum(p * term for p, term in zip(params, terms))
    return (coeffs, Ix, Iy, str(expr), [str(p) for p in params],
            str(taxis.coord_map), str(fexpr))


class ComponentModel:
    """A parsed mds model: renders per-pixel values at any (t, f).

    Consumes the string contract produced by :func:`fit_image_cube`
    (or by the reference's model2comps — the formats interoperate).
    """

    def __init__(self, coeffs, Ix, Iy, expr, params, texpr, fexpr):
        self.coeffs = np.asarray(coeffs, dtype=float)
        self.Ix = np.asarray(Ix)
        self.Iy = np.asarray(Iy)
        syms = sm.symbols(("t", "f")) + sm.symbols(tuple(params))
        self._value = lambdify(syms, parse_expr(str(expr)))
        self._tmap = lambdify(syms[0], parse_expr(str(texpr)))
        self._fmap = lambdify(syms[1], parse_expr(str(fexpr)))

    def pixel_values(self, t, f):
        """Component amplitudes at raw coordinates (t, f)."""
        return self._value(self._tmap(t), self._fmap(f), *self.coeffs)

    def render(self, t, f, nx, ny):
        """Paint the components onto an (nx, ny) zero image."""
        image = np.zeros((nx, ny), dtype=float)
        image[self.Ix, self.Iy] = self.pixel_values(t, f)
        return image


def eval_coeffs_to_cube(time, freq, nx, ny, coeffs, Ix, Iy, expr,
                        paramf, texpr, fexpr):
    """Render the fitted model onto an (ntime, nfreq, nx, ny) cube
    (reference misc.py:1217-1235)."""
    time = np.atleast_1d(time)
    freq = np.atleast_1d(freq)
    model = ComponentModel(coeffs, Ix, Iy, expr, paramf, texpr, fexpr)
    return np.stack([
        np.stack([model.render(t, f, nx, ny) for f in freq])
        for t in time])


def _axis_coords(n, cell, centre):
    """Pixel-centre world coordinates of an n-pixel axis."""
    return (np.arange(n) - n // 2) * cell + centre


def eval_coeffs_to_slice(time, freq, coeffs, Ix, Iy, expr, paramf,
                         texpr, fexpr, nxi, nyi, cellxi, cellyi, x0i,
                         y0i, nxo, nyo, cellxo, cellyo, x0o, y0o):
    """Render the model at one (time, freq) onto a possibly different
    image grid, zero-padding then linearly regridding as needed
    (reference misc.py:1238-1313)."""
    model = ComponentModel(coeffs, Ix, Iy, expr, paramf, texpr, fexpr)
    image = model.render(time, freq, nxi, nyi)

    xin = _axis_coords(nxi, cellxi, x0i)
    yin = _axis_coords(nyi, cellyi, y0i)
    xout = _axis_coords(nxo, cellxo, x0o)
    yout = _axis_coords(nyo, cellyo, y0o)

    def overshoot(gap, cell):
        return int(np.ceil(gap / cell)) if gap > 0 else 0

    # grow the input image so the output grid falls inside it
    pads = ((overshoot(xin[0] - xout[0], cellxi),
             overshoot(xout[-1] - xin[-1], cellxi)),
            (overshoot(yin[0] - yout[0], cellyi),
             overshoot(yout[-1] - yin[-1], cellyi)))
    if any(p for pair in pads for p in pair):
        image = np.pad(image, pads)
        xin = (np.arange(-pads[0][0], nxi + pads[0][1]) - nxi // 2) \
            * cellxi + x0i
        yin = (np.arange(-pads[1][0], nyi + pads[1][1]) - nyi // 2) \
            * cellyi + y0i

    same_grid = (image.shape == (nxo, nyo) and xin[0] == xout[0]
                 and yin[0] == yout[0] and cellxi == cellxo
                 and cellyi == cellyo)
    if same_grid:
        return image
    interp = RegularGridInterpolator((xin, yin), image, method="linear",
                                     bounds_error=True)
    xx, yy = np.meshgrid(xout, yout, indexing="ij")
    return interp((xx, yy))


def eval_mds_to_slice(mds, time, freq, nx, ny, cell_rad, x0=0.0, y0=0.0):
    """Render an mds (the dict of one mds store dataset) at one (time,
    freq) onto an (nx, ny) grid of square cells ``cell_rad`` centred at
    (x0, y0): :func:`eval_coeffs_to_slice` with the store's fields."""
    return eval_coeffs_to_slice(
        time, freq, mds["coefficients"], mds["location_x"],
        mds["location_y"], mds["parametrisation"], mds["params"],
        mds["texpr"], mds["fexpr"], mds["npix_x"], mds["npix_y"],
        mds["cell_rad_x"], mds["cell_rad_y"], mds.get("center_x", 0.0),
        mds.get("center_y", 0.0), nx, ny, cell_rad, cell_rad, x0, y0)
