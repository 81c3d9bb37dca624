"""Dataset stores in zarr-v2 layout, written with pure numpy.

The reference persists its inter-worker products as zarr stores of
xarray datasets (xds/dds/mds/fds — SURVEY.md section 1 "storage
formats"; written via xds_to_zarr, reference pfb/workers/init.py:79-81,
grid.py:506-586). The zarr package is unavailable in this environment,
but zarr v2 is just JSON metadata + raw chunk files, so this module
emits the format directly:

    <basename>.dds/
        .zgroup                      {"zarr_format": 2}
        .zattrs                      store-level attrs
        ds_0000/
            .zgroup
            .zattrs                  dataset attrs (bandid, cell_rad, …)
            DIRTY/
                .zarray              zarr v2 array metadata (raw, C)
                .zattrs              {"_ARRAY_DIMENSIONS": ["x","y"]}
                0.0                  chunk bytes (single whole-array chunk)
            PSF/ …
        ds_0001/ …

Each dataset group is a valid xarray-readable zarr group (arrays carry
the xarray ``_ARRAY_DIMENSIONS`` convention), so reference-side tooling
can open the products with ``zarr.open(path)`` /
``xarray.open_zarr(path, group='ds_0000')``. Field names, dims and
attrs follow the reference schema (VIS/WEIGHT/MASK/UVW/FREQ/BEAM —
pfb/utils/stokes2vis.py:235-280; DIRTY ('x','y'), PSF ('x_psf','y_psf'),
PSFHAT ('x_psf','yo2'), DUAL ('c','i','j'), MODEL_BEST ('x','y'),
L1WEIGHT ('b','c') — pfb/workers/grid.py:545-573, spotless.py:381-394,
625).

A dataset in memory is just ``dict`` with numpy arrays + attrs merged
(attrs under plain keys; complex arrays stored natively as '<c8'/'<c16').
Stores written by earlier rounds of this build (npy directories with
attrs.json) are still readable.
"""

import json
import shutil
from pathlib import Path

import numpy as np

_ATTRS = "attrs.json"  # legacy (round<=3) layout marker

# Reference dimension names per field (see module docstring citations).
# Used for the xarray _ARRAY_DIMENSIONS attribute; a within-dataset
# length clash falls back to private per-field dims so the group always
# stays xarray-openable.
_FIELD_DIMS = {
    "VIS": ("row", "chan"),
    "WEIGHT": ("row", "chan"),
    "MASK": ("row", "chan"),
    "UVW": ("row", "uvw"),
    "FREQ": ("chan",),
    "BEAM": ("l_beam", "m_beam"),
    "DIRTY": ("x", "y"),
    "RESIDUAL": ("x", "y"),
    "MODEL": ("x", "y"),
    "MODEL_BEST": ("x", "y"),
    "UPDATE": ("x", "y"),
    "MODELP": ("x", "y"),
    "COUNTS": ("x", "y"),
    "IMAGE": ("x", "y"),
    "PSF": ("x_psf", "y_psf"),
    "PSFHAT": ("x_psf", "yo2"),
    "WSUM": ("scalar",),
    "DUAL": ("c", "i", "j"),
    "L1WEIGHT": ("b", "c"),
    "PARAM": ("x", "y"),
    "coefficients": ("par", "comps"),
    "location_x": ("x",),
    "location_y": ("y",),
    "params": ("par",),
    "times": ("t",),
    "freqs": ("f",),
}


def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, (np.bool_,)):
        return bool(o)
    raise TypeError(f"not serialisable: {type(o)}")


def _dump(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, default=_json_default)


def _zarr_dtype(dt):
    """numpy dtype -> zarr v2 dtype string (always little-endian on
    write; '|' for single-byte types)."""
    dt = np.dtype(dt)
    if dt.kind in "SU":
        return dt.str  # e.g. '<U12' — fixed-width strings pass through
    if dt.itemsize == 1:
        return "|" + dt.str[1:]
    return "<" + dt.str[1:]


def _write_array(adir, name, arr, dims):
    """One zarr v2 array: whole-array single chunk, no compressor."""
    adir.mkdir(parents=True, exist_ok=True)
    arr = np.ascontiguousarray(arr)
    dt = _zarr_dtype(arr.dtype)
    arr = arr.astype(np.dtype(dt), copy=False)
    meta = {
        "zarr_format": 2,
        "shape": list(arr.shape),
        "chunks": [max(int(s), 1) for s in arr.shape],
        "dtype": dt,
        "compressor": None,
        "fill_value": None,
        "order": "C",
        "filters": None,
    }
    _dump(adir / ".zarray", meta)
    _dump(adir / ".zattrs", {"_ARRAY_DIMENSIONS": list(dims)})
    if arr.size:
        key = ".".join(["0"] * max(arr.ndim, 1))
        with open(adir / key, "wb") as f:
            f.write(arr.tobytes(order="C"))


def _ds_dims(ds_arrays):
    """Assign dims per array from the reference table, de-clashing any
    same-name dims that would get two lengths in one dataset (xarray
    refuses those)."""
    sizes = {}
    out = {}
    for key, arr in ds_arrays.items():
        dims = _FIELD_DIMS.get(key)
        if dims is None or len(dims) != arr.ndim:
            dims = tuple(f"{key}_d{i}" for i in range(arr.ndim))
        fixed = []
        for d, n in zip(dims, arr.shape):
            if sizes.get(d, n) != n:
                d = f"{key}_{d}"
            sizes.setdefault(d, n)
            fixed.append(d)
        out[key] = tuple(fixed)
    return out


def write_store(path, datasets, overwrite=True):
    """Write a list of dataset dicts to ``path`` as a zarr-v2 group
    hierarchy. Arrays (ndim >= 1) become zarr arrays; scalars/strings/
    lists land in the group .zattrs."""
    path = Path(path)
    if path.exists():
        if overwrite:
            shutil.rmtree(path)
        else:
            raise FileExistsError(path)
    path.mkdir(parents=True)
    _dump(path / ".zgroup", {"zarr_format": 2})
    _dump(path / ".zattrs", {"writer": "pfb_tpu",
                             "n_datasets": len(datasets)})
    for i, ds in enumerate(datasets):
        write_ds(path, i, ds)


def _split(ds):
    arrays, attrs = {}, {}
    for key, val in ds.items():
        arr = np.asarray(val) if not np.isscalar(val) and \
            not isinstance(val, (str, list, tuple, dict, type(None))) \
            else None
        if arr is not None and arr.ndim >= 1:
            arrays[key] = arr
        else:
            attrs[key] = val
    return arrays, attrs


def write_ds(path, index, ds):
    dpath = Path(path) / f"ds_{index:04d}"
    dpath.mkdir(parents=True, exist_ok=True)
    root = Path(path)
    if not (root / ".zgroup").exists():
        _dump(root / ".zgroup", {"zarr_format": 2})
    arrays, attrs = _split(ds)
    _dump(dpath / ".zgroup", {"zarr_format": 2})
    _dump(dpath / ".zattrs", attrs)
    dims = _ds_dims(arrays)
    for key, arr in arrays.items():
        _write_array(dpath / key, key, arr, dims[key])


def update_ds(path, index, arrays=None, attrs=None):
    """In-place update of selected fields/attrs of one dataset — the
    writeback contract the deconvolvers rely on for checkpoint/resume
    (reference: workers/spotless.py:374-394, klean.py:355-374)."""
    dpath = Path(path) / f"ds_{index:04d}"
    if arrays:
        if (dpath / _ATTRS).exists():  # legacy store: keep npy layout
            for key, val in arrays.items():
                np.save(dpath / f"{key}.npy", np.asarray(val))
        else:
            cur = {k: np.asarray(v) for k, v in arrays.items()}
            # include existing arrays in the clash check
            for sub in dpath.iterdir():
                if sub.is_dir() and (sub / ".zarray").exists() \
                        and sub.name not in cur:
                    meta = json.load(open(sub / ".zarray"))
                    cur[sub.name] = np.empty(meta["shape"],
                                             dtype=np.uint8)
            dims = _ds_dims(cur)
            for key, val in arrays.items():
                _write_array(dpath / key, key, np.asarray(val),
                             dims[key])
    if attrs:
        afile = dpath / (_ATTRS if (dpath / _ATTRS).exists()
                         else ".zattrs")
        with open(afile) as f:
            cur = json.load(f)
        cur.update(attrs)
        _dump(afile, cur)


def _read_array(adir):
    """Read one zarr v2 array (multi-chunk supported). Compressed
    chunks (blosc/zlib/gzip/bz2/lzma/zstd/lz4 + shuffle/delta filters
    — the reference's ``xds_to_zarr`` writes blosc-lz4-shuffle by
    default, pfb-clean's pfb/workers/init.py:79-81) are decoded by
    the pure-python :mod:`pfb_tpu_torch.utils.codecs` layer."""
    from pfb_tpu_torch.utils import codecs

    meta = json.load(open(adir / ".zarray"))
    compressor = meta.get("compressor")
    filters = meta.get("filters")
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    dt = np.dtype(meta["dtype"])
    order = meta.get("order", "C")

    def _decode(raw, nitems):
        raw = codecs.decompress_chunk(raw, compressor,
                                      nbytes=nitems * dt.itemsize)
        raw = codecs.decode_filters(raw, filters, dt)
        return raw

    if not shape:
        raw = _decode(open(adir / "0", "rb").read(), 1)
        return np.frombuffer(raw, dtype=dt).reshape(())
    out = np.zeros(shape, dtype=dt)
    if out.size == 0:
        return out
    grid = [max(-(-s // c), 1) for s, c in zip(shape, chunks)]
    sep = meta.get("dimension_separator", ".")
    csize = int(np.prod(chunks))
    for idx in np.ndindex(*grid):
        key = sep.join(str(i) for i in idx)
        raw = _decode(open(adir / key, "rb").read(), csize)
        block = np.frombuffer(raw, dtype=dt).reshape(chunks,
                                                     order=order)
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, shape))
        out[sl] = block[tuple(slice(0, s.stop - s.start) for s in sl)]
    return out


def _read_ds_zarr(dpath):
    ds = {}
    zattrs = dpath / ".zattrs"
    if zattrs.exists():
        ds.update(json.load(open(zattrs)))
    ds.pop("_ARRAY_DIMENSIONS", None)
    for sub in sorted(dpath.iterdir()):
        if sub.is_dir() and (sub / ".zarray").exists():
            ds[sub.name] = _read_array(sub)
    return ds


def _read_ds_legacy(dpath):
    ds = {}
    with open(dpath / _ATTRS) as f:
        ds.update(json.load(f))
    for npy in sorted(dpath.glob("*.npy")):
        ds[npy.stem] = np.load(npy)
    return ds


def read_store(path):
    """Read all datasets of a store back as a list of dicts. Handles
    both the zarr-v2 layout and the legacy npy-directory layout."""
    path = Path(path)
    if not path.is_dir():
        raise FileNotFoundError(path)
    out = []
    for dpath in sorted(path.glob("ds_*")):
        if (dpath / _ATTRS).exists():
            out.append(_read_ds_legacy(dpath))
        else:
            out.append(_read_ds_zarr(dpath))
    return out


def store_exists(path):
    return Path(path).is_dir()


def remove_store(path):
    """Delete the store at ``path``; a missing path is no error."""
    if Path(path).exists():
        shutil.rmtree(path)
