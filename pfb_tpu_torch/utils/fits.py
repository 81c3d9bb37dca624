"""Minimal FITS I/O (pure numpy — astropy-free).

Equivalent of pfb/utils/fits.py in the reference: save/load image
cubes with the same axis conventions (data transposed to FITS order,
4-axis RA/DEC/FREQ/STOKES WCS headers) — implemented directly against
the FITS standard (2880-byte header blocks of 80-char cards, big-endian
data).

A host copy of pfb_tpu/utils/fits.py (numpy only), so the port's workers
write the same files without importing JAX.
"""

import numpy as np

_BLOCK = 2880


def _card(key, value, comment=""):
    if isinstance(value, bool):
        v = "T" if value else "F"
        card = f"{key:<8}= {v:>20}"
    elif isinstance(value, (int, np.integer)):
        card = f"{key:<8}= {value:>20d}"
    elif isinstance(value, (float, np.floating)):
        card = f"{key:<8}= {value:>20.14E}"
    elif isinstance(value, str):
        card = f"{key:<8}= '{value:<8}'"
    else:
        raise TypeError(f"Unsupported header value {value!r}")
    if comment:
        card += f" / {comment}"
    return card[:80].ljust(80)


def set_wcs(cell_x, cell_y, nx, ny, radec, freq, unit="Jy/beam",
            GuassPar=None, ms_time=None, header=True):
    """Header dict mirroring the reference's set_wcs
    (pfb/utils/fits.py): cell sizes in degrees, radec in radians, freq
    scalar or array (Hz)."""
    freq = np.atleast_1d(freq)
    nchan = freq.size
    if nchan > 1:
        crval3 = freq[0]
        df = freq[1] - freq[0]
    else:
        crval3 = freq[0]
        df = 1.0
    hdr = {
        "SIMPLE": True,
        "BITPIX": -64,
        "NAXIS": 4,
        "NAXIS1": nx,
        "NAXIS2": ny,
        "NAXIS3": nchan,
        "NAXIS4": 1,
        "CTYPE1": "RA---SIN",
        "CTYPE2": "DEC--SIN",
        "CTYPE3": "FREQ",
        "CTYPE4": "STOKES",
        "CRPIX1": nx / 2 + 1,
        "CRPIX2": ny / 2 + 1,
        "CRPIX3": 1.0,
        "CRPIX4": 1.0,
        "CRVAL1": np.rad2deg(radec[0]),
        "CRVAL2": np.rad2deg(radec[1]),
        "CRVAL3": float(crval3),
        "CRVAL4": 1.0,
        "CDELT1": -cell_x,
        "CDELT2": cell_y,
        "CDELT3": float(df),
        "CDELT4": 1.0,
        "CUNIT1": "deg",
        "CUNIT2": "deg",
        "CUNIT3": "Hz",
        "BUNIT": unit,
        "EQUINOX": 2000.0,
    }
    if GuassPar is not None:
        hdr = add_beampars(hdr, GuassPar)
    return hdr


def add_beampars(hdr, GaussPar, GaussPars=None, unit2deg=1.0):
    """BMAJ/BMIN/BPA cards (reference fits.py add_beampars)."""
    if len(np.asarray(GaussPar).shape) > 1:
        GaussPar = GaussPar[0]
    hdr["BMAJ"] = GaussPar[0] * unit2deg
    hdr["BMIN"] = GaussPar[1] * unit2deg
    hdr["BPA"] = GaussPar[2] * unit2deg
    if GaussPars is not None:
        for i, gp in enumerate(GaussPars):
            hdr[f"BMAJ{i + 1}"] = gp[0] * unit2deg
            hdr[f"BMIN{i + 1}"] = gp[1] * unit2deg
            hdr[f"BPA{i + 1}"] = gp[2] * unit2deg
    return hdr


def save_fits(data, name, hdr=None, overwrite=True, dtype=np.float32):
    """Write an image (cube) with the reference's axis convention: the
    (..., nx, ny) array is transposed so FITS NAXIS1 is x
    (reference fits.py save_fits: data.T with a final flip)."""
    from pfb_tpu_torch.utils.misc import to4d
    data = to4d(np.asarray(data))  # (nstokes, nchan, nx, ny)
    data = np.require(data.astype(dtype), requirements="C")
    if hdr is None:
        hdr = {"SIMPLE": True}
    hdr = dict(hdr)
    bitpix = {np.dtype(np.float32): -32,
              np.dtype(np.float64): -64}[np.dtype(dtype)]
    hdr["BITPIX"] = bitpix
    # FITS stores axes fastest-first: NAXIS1 = x
    fits_data = np.transpose(data, (0, 1, 3, 2))[:, :, ::-1, :]
    hdr["NAXIS"] = 4
    hdr["NAXIS1"], hdr["NAXIS2"] = data.shape[2], data.shape[3]
    hdr["NAXIS3"], hdr["NAXIS4"] = data.shape[1], data.shape[0]

    cards = [_card("SIMPLE", hdr.pop("SIMPLE", True))]
    cards.append(_card("BITPIX", hdr.pop("BITPIX")))
    for ax in ["NAXIS", "NAXIS1", "NAXIS2", "NAXIS3", "NAXIS4"]:
        cards.append(_card(ax, hdr.pop(ax)))
    for key, val in hdr.items():
        cards.append(_card(key, val))
    cards.append("END".ljust(80))
    header = "".join(cards)
    header += " " * ((-len(header)) % _BLOCK)

    be = fits_data.astype(f">f{abs(bitpix) // 8}")
    payload = be.tobytes()
    payload += b"\x00" * ((-len(payload)) % _BLOCK)
    with open(name, "wb") as fh:
        fh.write(header.encode("ascii"))
        fh.write(payload)


def load_fits(name, dtype=np.float64):
    """Read back a FITS file written by save_fits (also handles generic
    single-HDU image FITS). Returns the array in the reference's
    (nstokes, nchan, nx, ny) convention."""
    with open(name, "rb") as fh:
        raw = fh.read()
    # parse header
    hdr = {}
    pos = 0
    done = False
    while not done:
        block = raw[pos:pos + _BLOCK].decode("ascii", errors="replace")
        pos += _BLOCK
        for i in range(0, _BLOCK, 80):
            card = block[i:i + 80]
            key = card[:8].strip()
            if key == "END":
                done = True
                break
            if "=" not in card:
                continue
            val = card[9:].split("/")[0].strip()
            if val.startswith("'"):
                hdr[key] = val.strip("'").strip()
            elif val in ("T", "F"):
                hdr[key] = val == "T"
            else:
                try:
                    hdr[key] = int(val)
                except ValueError:
                    try:
                        hdr[key] = float(val)
                    except ValueError:
                        hdr[key] = val
    bitpix = hdr["BITPIX"]
    naxis = hdr["NAXIS"]
    shape = [hdr[f"NAXIS{i}"] for i in range(naxis, 0, -1)]
    npts = int(np.prod(shape))
    data = np.frombuffer(raw[pos:pos + npts * abs(bitpix) // 8],
                         dtype=f">f{abs(bitpix) // 8}")
    data = data.reshape(shape).astype(dtype)
    from pfb_tpu_torch.utils.misc import to4d
    data = to4d(data)
    # undo the save transform
    data = np.transpose(data[:, :, ::-1, :], (0, 1, 3, 2))
    return data


def dds2fits(dds, column, outname, norm_wsum=True):
    """Per-band FITS cubes from dds datasets
    (reference fits.py dds2fits)."""
    freqs = np.unique([ds["freq_out"] for ds in dds])
    written = []
    for ds in dds:
        b = ds["bandid"]
        data = ds[column]
        wsum = ds["WSUM"][0]
        if norm_wsum and wsum > 0:
            data = data / wsum
        cell_deg = np.rad2deg(ds["cell_rad"])
        hdr = set_wcs(cell_deg, cell_deg, data.shape[-2], data.shape[-1],
                      [ds["ra"], ds["dec"]], ds["freq_out"])
        name = f"{outname}_{column.lower()}_b{b:04d}.fits"
        save_fits(data, name, hdr)
        written.append(name)
    return written


def dds2fits_mfs(dds, column, outname, norm_wsum=True):
    """MFS (band-summed) FITS image (reference fits.py dds2fits_mfs)."""
    freqs = np.unique([ds["freq_out"] for ds in dds])
    nband = freqs.size
    data = None
    wsum = 0.0
    for ds in dds:
        d = ds[column]
        if data is None:
            data = np.zeros_like(d)
        data = data + d
        wsum += ds["WSUM"][0]
    if norm_wsum and wsum > 0:
        data = data / wsum
    else:
        data = data / nband
    ds = dds[0]
    cell_deg = np.rad2deg(ds["cell_rad"])
    hdr = set_wcs(cell_deg, cell_deg, data.shape[-2], data.shape[-1],
                  [ds["ra"], ds["dec"]], float(np.mean(freqs)))
    name = f"{outname}_{column.lower()}_mfs.fits"
    save_fits(data, name, hdr)
    return [name]
