"""Clean-beam fitting (``fitcleanbeam``, ``Gaussian2D``), convolution to
a common resolution (``convolve2gaussres``), Kronecker matvecs, edge
slicing, island removal and ``to4d``: carried over from
pfb_tpu/utils/misc.py unchanged (numpy/scipy only; the JAX package runs
them on the host too), so the port imports no JAX.
"""

import numpy as np
from scipy.ndimage import label

# FWHM exponent convention shared with the reference (misc.py:109-138):
# the profile is exp(-K * q) with q the squared coordinate in FWHM
# units, K = 2*sqrt(2*ln 2).
_FWHM_EXPONENT = 2.0 * np.sqrt(2.0 * np.log(2.0))


def to4d(data):
    """Broadcast 1-4D arrays to 4D (reference misc.py:96-106)."""
    if data.ndim == 4:
        return data
    if data.ndim == 2:
        return data[None, None]
    if data.ndim == 3:
        return data[None]
    if data.ndim == 1:
        return data[None, None, None]
    raise ValueError("Only arrays with ndim <= 4 can be broadcast to 4D.")


def kron_matvec(A, b):
    """Matvec with kron(A[0], A[1], ...) applied factor by factor,
    never forming the product (reference misc.py:63-74)."""
    x = b.ravel()
    for M in A:
        x = (M @ x.reshape(M.shape[1], -1)).T.ravel()
    return x.reshape(b.shape)


def _overlap_1d(centre, n_im, n_win):
    """Overlap of an n_win window centred at ``centre`` with [0, n_im).

    Returns matching (image_slice, window_slice).
    """
    half = n_win // 2
    lo = max(centre - half, 0)
    hi = min(centre + half, n_im)
    shift = half - centre
    return slice(lo, hi), slice(lo + shift, hi + shift)


def give_edges(p, q, nx, ny, nx_psf, ny_psf):
    """Matching image/PSF slices for a PSF centred at pixel (p, q)
    (reference misc.py:141-167)."""
    sx, spx = _overlap_1d(p, nx, nx_psf)
    sy, spy = _overlap_1d(q, ny, ny_psf)
    return sx, sy, spx, spy


def _beam_frame(x, y, pa_deg):
    """Rotate sky coordinates into the beam principal-axis frame."""
    t = np.deg2rad(-pa_deg)
    c, s = np.cos(t), np.sin(t)
    return c * x - s * y, s * x + c * y


def beam_profile(x, y, fwhm_u, fwhm_v, pa_deg):
    """Unit-peak elliptical Gaussian with the two FWHMs along the
    rotated u/v axes."""
    u, v = _beam_frame(x, y, pa_deg)
    q = (u / fwhm_u) ** 2 + (v / fwhm_v) ** 2
    return np.exp(-_FWHM_EXPONENT * q)


def Gaussian2D(xin, yin, GaussPar=(1.0, 1.0, 0.0), normalise=True,
               nsigma=5):
    """Elliptical Gaussian kernel on a coordinate grid, truncated at
    ``nsigma`` major-axis widths (reference misc.py:109-138).

    GaussPar = (fwhm_maj, fwhm_min, position angle in degrees); the
    minor axis lies along u (the first rotated coordinate), matching
    the reference's parameter order.
    """
    smaj, smin, pa = GaussPar
    kern = beam_profile(xin, yin, smin, smaj, pa)
    kern = np.where(xin**2 + yin**2 <= (nsigma * smaj) ** 2, kern, 0.0)
    if normalise:
        kern = kern / kern.sum()
    return kern


def _beam_jacobian(x, y, params):
    """Model values and d(model)/d(params) for the beam profile.

    params = (fwhm_u, fwhm_v, pa_deg).  Analytic derivatives: with
    m = exp(-K q), dm/dp = -K m dq/dp, and the frame rotation gives
    du/dt = -v, dv/dt = u for t = -deg2rad(pa).
    """
    a, b, pa = params
    u, v = _beam_frame(x, y, pa)
    q = (u / a) ** 2 + (v / b) ** 2
    m = np.exp(-_FWHM_EXPONENT * q)
    dq_da = -2.0 * u**2 / a**3
    dq_db = -2.0 * v**2 / b**3
    # dt/d(pa_deg) = -pi/180 and dq/dt = -2uv/a^2 + 2uv/b^2
    dq_dpa = 2.0 * u * v * (1.0 / a**2 - 1.0 / b**2) * (np.pi / 180.0)
    scale = -_FWHM_EXPONENT * m
    return m, np.stack([scale * dq_da, scale * dq_db, scale * dq_dpa],
                       axis=-1)


def _moment_seed(data, x, y):
    """Initial (fwhm_u, fwhm_v, pa) from weighted second moments."""
    w = np.maximum(data, 0.0)
    wsum = w.sum()
    mxx = (w * x * x).sum() / wsum
    myy = (w * y * y).sum() / wsum
    mxy = (w * x * y).sum() / wsum
    theta = 0.5 * np.arctan2(2.0 * mxy, mxx - myy)
    half_tr = (mxx + myy) / 2.0
    radius = np.hypot((mxx - myy) / 2.0, mxy)
    lam_maj = max(half_tr + radius, 1e-12)
    lam_min = max(half_tr - radius, 1e-12)
    # exp(-K q) has variance fwhm^2/(2K) along each principal axis;
    # the major axis (angle theta from x) lies along v, i.e. at pa =
    # theta - 90deg in the beam-frame convention
    s = np.sqrt(2.0 * _FWHM_EXPONENT)
    return (s * np.sqrt(lam_min), s * np.sqrt(lam_maj),
            np.degrees(theta) - 90.0)


def _fit_beam_gn(data, x, y, p0, maxit=100, tol=1e-12):
    """Levenberg-damped Gauss-Newton fit of the beam profile to
    ``data`` at coordinates (x, y)."""
    p = np.asarray(p0, dtype=float)
    lam = 1e-3
    m, J = _beam_jacobian(x, y, p)
    r = data - m
    cost = float(r @ r)
    for _ in range(maxit):
        g = J.T @ r
        H = J.T @ J
        # absolute floor keeps the system regular when a column
        # vanishes (PA is unconstrained for a circular beam)
        damp = lam * np.diag(np.diag(H)) + 1e-10 * np.eye(3)
        trial = p + np.linalg.solve(H + damp, g)
        trial[:2] = np.maximum(np.abs(trial[:2]), 1e-6)
        m, Jt = _beam_jacobian(x, y, trial)
        rt = data - m
        trial_cost = float(rt @ rt)
        if trial_cost <= cost:
            converged = cost - trial_cost < tol * max(cost, 1.0)
            p, J, r, cost = trial, Jt, rt, trial_cost
            lam = max(lam / 3.0, 1e-12)
            if converged:
                break
        else:
            lam *= 10.0
            if lam > 1e12:
                break
    return p


def fitcleanbeam(psf, level=0.5, pixsize=1.0, extent=15.0):
    """Fit a 2D Gaussian to each band's PSF main lobe (reference
    misc.py:529-584).

    The main lobe is located by labelling the region above ``level``
    and taking the island containing the central pixel; its size seeds
    the fit and sets the fit radius (``extent`` times the island
    radius).  Returns [fwhm_maj, fwhm_min, pa_deg] per band in
    ``pixsize`` units.
    """
    nband, nx, ny = psf.shape
    xg = np.arange(-(nx // 2), nx - nx // 2)
    yg = np.arange(-(ny // 2), ny - ny // 2)
    xx, yy = np.meshgrid(xg, yg, indexing="ij")
    rsq_grid = xx**2 + yy**2

    beams = []
    for v in range(nband):
        if not psf[v].any():
            beams.append([np.nan, np.nan, np.nan])
            continue
        psfv = psf[v] / psf[v].max()
        islands, _ = label(psfv > level)
        lobe = islands == islands[nx // 2, ny // 2]
        xl, yl = xx[lobe], yy[lobe]
        lobe_rsq = np.abs(xl).max() ** 2 + np.abs(yl).max() ** 2

        sel = rsq_grid < extent * lobe_rsq
        seed = _moment_seed(psfv[lobe], xl, yl)
        pu, pv, pa = _fit_beam_gn(psfv[sel], xx[sel], yy[sel], seed)
        if pu > pv:
            # major ended up along u: a 90deg frame rotation puts it
            # back on v, the Gaussian2D major axis
            pu, pv, pa = pv, pu, pa + 90.0
        pa = (pa + 90.0) % 180.0 - 90.0
        beams.append([pv * pixsize, pu * pixsize, pa])
    return beams


def convolve2gaussres(image, xx, yy, gaussparf, gausspari=None,
                      pfrac=0.5, norm_kernel=False):
    """Convolve a cube to a target resolution, optionally deconvolving
    each band's initial resolution in the Fourier domain (reference
    misc.py:186-238)."""
    from pfb_tpu_torch.ops.fft import get_padding_info

    nband, nx, ny = image.shape
    padding, unpad_x, unpad_y = get_padding_info(nx, ny, pfrac)
    firstsize = nx + int(np.sum(padding[1]))
    lastsize = ny + int(np.sum(padding[2]))

    def kernel_hat(par):
        kern = Gaussian2D(xx, yy, par, normalise=norm_kernel)
        kern = np.pad(kern, padding[1:], mode="constant")
        return np.fft.rfft2(np.fft.ifftshift(kern))

    target_hat = kernel_hat(gaussparf)
    imhat = np.fft.rfft2(
        np.fft.ifftshift(np.pad(image, padding, mode="constant"),
                         axes=(1, 2)), axes=(1, 2))

    if gausspari is None:
        imhat *= target_hat[None]
    else:
        for b in range(nband):
            band_hat = kernel_hat(gausspari[b])
            live = np.abs(band_hat) > 0.0
            imhat[b] *= np.where(
                live, target_hat / np.where(live, band_hat, 1.0), 0.0)

    out = np.fft.irfft2(imhat, s=(firstsize, lastsize), axes=(1, 2))
    return np.fft.fftshift(out, axes=(1, 2))[:, unpad_x, unpad_y]


def remove_large_islands(x, max_island_size=100):
    """Zero islands larger than max_island_size pixels
    (reference misc.py:1355-1363)."""
    islands, num = label(x.squeeze())
    for i in range(1, num + 1):
        msk = islands == i
        if msk.sum() > max_island_size:
            x[msk] = 0.0
    return x
