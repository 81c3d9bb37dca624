"""model2comps worker: dds MODEL cube -> continuous component model
(mds store). Counterpart of pfb_tpu/workers/model2comps.py (reference
pfb/workers/model2comps.py:22-200): weighted least squares of the model
cube onto monomial or Legendre time/freq bases, stored with the symbolic
parametrisation string + coordinate transforms so any (t, f, grid) slice
can be rendered later. A host worker, as in the JAX package: it runs no
device code, so a ``device`` argument passes through ``kw`` unused.
"""

import numpy as np

from pfb_tpu_torch.models.comps import fit_image_cube
from pfb_tpu_torch.utils import dstore


def _model2comps(ddsi=None, output_filename=None, product="I",
                 suffix="main", model_name="MODEL", nbasist=None,
                 nbasisf=None, fit_mode="Legendre", sigmasq=0.0,
                 model_out=None, out_format="zarr", min_val=None,
                 model_fits=None, use_wsum=True, overwrite=True, **kw):
    """Returns the mds dataset dict (and writes
    ``{output_filename}_{PRODUCT}_{suffix}_{model_name}.mds``).

    min_val: zero components whose MFS flux is below this level before
    fitting (reference model2comps.py:132-141). model_fits: fit a
    model read from a fits cube instead of the dds (reference
    model2comps.py model-fits). out_format: zarr (dstore) or json."""
    if ddsi is None:
        dds_name = f"{output_filename}_{product.upper()}_{suffix}.dds"
        dds = dstore.read_store(dds_name)
    else:
        dds = ddsi

    freqs_out = np.unique([ds["freq_out"] for ds in dds])
    times_out = np.unique([ds["time_out"] for ds in dds])
    nband = freqs_out.size
    ntime = times_out.size
    nx = dds[0]["DIRTY"].shape[0] if "DIRTY" in dds[0] else \
        dds[0][model_name].shape[0]
    ny = dds[0]["DIRTY"].shape[1] if "DIRTY" in dds[0] else \
        dds[0][model_name].shape[1]

    # assemble (ntime, nband, nx, ny) model and (ntime, nband) weights
    model = np.zeros((ntime, nband, nx, ny))
    wgt = np.zeros((ntime, nband))
    for ds in dds:
        t = int(np.where(times_out == ds["time_out"])[0][0])
        b = int(np.where(freqs_out == ds["freq_out"])[0][0])
        if model_name in ds:
            model[t, b] = ds[model_name]
        wgt[t, b] += ds["WSUM"][0]
    if not use_wsum:
        wgt = np.ones_like(wgt)

    if model_fits is not None:
        # degrid from a fits model: (nband, nx, ny) cube or 2D image
        # broadcast over the dds grid (reference model-fits option)
        from pfb_tpu_torch.utils.fits import load_fits
        fmod = load_fits(model_fits)
        fmod = np.atleast_3d(fmod)
        if fmod.ndim == 3 and fmod.shape[0] not in (1, nband):
            raise ValueError(
                f"model-fits has {fmod.shape[0]} bands, dds has "
                f"{nband}")
        model = np.broadcast_to(
            fmod[None], (ntime, nband, nx, ny)).copy()

    if min_val is not None:
        # only fit components above min_val in the mean model over the
        # populated (t, b) planes (reference model2comps.py:132-138)
        mmfs = np.mean(model[wgt > 0], axis=0)
        model = np.where(np.abs(mmfs)[None, None] >= min_val, model,
                         0.0)

    if not model.any():
        raise ValueError("Model is empty"
                         + (f" or has no components above {min_val}"
                            if min_val is not None else ""))

    fsel = wgt.sum(axis=0) > 0
    coeffs, Ix, Iy, expr, params, texpr, fexpr = fit_image_cube(
        times_out, freqs_out[fsel], model[:, fsel], wgt=wgt[:, fsel],
        nbasist=nbasist,
        nbasisf=nbasisf if nbasisf is not None else int(fsel.sum()),
        method=fit_mode, sigmasq=sigmasq)

    mds = {
        "coefficients": coeffs,
        "location_x": Ix,
        "location_y": Iy,
        "params": list(params),
        "times": np.asarray(times_out),
        "freqs": np.asarray(freqs_out),
        "spec": "genesis",
        "cell_rad_x": dds[0]["cell_rad"],
        "cell_rad_y": dds[0]["cell_rad"],
        "npix_x": nx,
        "npix_y": ny,
        "texpr": texpr,
        "fexpr": fexpr,
        "center_x": dds[0].get("x0", 0.0),
        "center_y": dds[0].get("y0", 0.0),
        "ra": dds[0]["ra"],
        "dec": dds[0]["dec"],
        "stokes": product,
        "parametrisation": expr,
    }

    if output_filename is not None:
        name = model_out or (f"{output_filename}_{product.upper()}_"
                             f"{suffix}_{model_name.lower()}.mds")
        if out_format == "json":
            # portable interchange format (reference
            # model2comps.py:192-199 writes json too)
            import json
            ser = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                   for k, v in mds.items()}
            with open(name + ".json", "w") as f:
                json.dump(ser, f)
        else:
            dstore.write_store(name, [mds], overwrite=overwrite)
    return mds
