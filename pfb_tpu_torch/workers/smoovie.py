"""smoovie worker: render fds residual snapshots to a movie: a host
copy of pfb_tpu/workers/smoovie.py (numpy, matplotlib, PIL, imageio),
so the port imports nothing of pfb_tpu. Two additions let it run where
matplotlib and PIL are not installed: the default grey colour map is
computed in numpy (the bytes of matplotlib's "gray"), and a grey movie
is written by a numpy GIF encoder when PIL is missing. Other colour
maps and ``annotate`` still need matplotlib.

Equivalent of pfb/workers/smoovie.py:21-461: scan-boundary-respecting
time (or freq) binning with wsum-weighted frame sums, median-rms colour
scaling (vmin = -min_frac * medrms, vmax = max_frac * medrms,
reference smoovie.py:104-105,273-284), optional annotated frame
rendering, per-band movies (movie-cubes) and fits frame output. The
reference uses streamjoy + matplotlib; here frames are normalised,
colour-mapped with matplotlib and written as an animated GIF via PIL
or an mp4 via imageio when an ffmpeg backend is installed (GIF
fallback otherwise).
"""

import numpy as np

from pfb_tpu_torch.utils import dstore
from pfb_tpu_torch.utils.logging import get_logger

log = get_logger("SMOOVIE")


def sum_blocks(frames, wsums):
    """wsum-weighted frame sum (reference smoovie.py sum_blocks)."""
    wsum = np.sum(wsums)
    out = np.sum(frames, axis=0)
    if wsum > 0:
        out = out / wsum
    return out, wsum


def _bin_keys_scanwise(fds, key_of, nbin, respect_scans=True):
    """Group datasets into bins of nbin consecutive keys; bins never
    cross a scan boundary unless respect_scans=False (reference
    smoovie.py respect-scan-boundaries)."""
    if respect_scans:
        scans = sorted({ds.get("scanid", 0) for ds in fds})
    else:
        scans = [None]
    groups = []
    for s in scans:
        sds = fds if s is None else \
            [ds for ds in fds if ds.get("scanid", 0) == s]
        keys = np.unique([key_of(ds) for ds in sds])
        for i0 in range(0, keys.size, nbin):
            sel = set(keys[i0:i0 + nbin].tolist())
            group = [ds for ds in sds if key_of(ds) in sel]
            if group:
                groups.append(group)
    return groups


def _render_annotated(frame, label, cmap, lo, hi, text_colour="cyan"):
    """Matplotlib-rendered RGB frame with a label and colorbar
    (reference plot_frame, smoovie.py:380-430)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(5, 5), dpi=96)
    im = ax.imshow(frame.T, origin="lower", cmap=cmap, vmin=lo,
                   vmax=hi)
    ax.text(0.03, 0.97, label, transform=ax.transAxes, fontsize=9,
            va="top", color=text_colour)
    ax.axis("off")
    fig.colorbar(im, ax=ax, shrink=0.8)
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return buf


def _parse_range(rng_str):
    if not rng_str:
        return -np.inf, np.inf
    lo, _, hi = str(rng_str).partition(":")
    return (float(lo) if lo else -np.inf,
            float(hi) if hi else np.inf)


def _smoovie(fdsi=None, output_filename=None, product="I",
             suffix="fds", fds=None, outname=None, animate_axis="time",
             out_format="gif", fps=5, time_bin=1, freq_bin=1,
             cmap="grey", annotate=False, text_colour="cyan",
             min_frac=3.5, max_frac=3.5, time_range=None,
             freq_range=None, respect_scan_boundaries=True,
             movie_mfs=True, movie_cubes=False, fits_mfs=False,
             fits_cubes=False, optimize=False, crf=12,
             overwrite=True, write=True, **kw):
    """Returns the list of rendered MFS frames (2D arrays); writes the
    movie(s). out_format 'gif' or 'mp4' (mp4 needs an imageio ffmpeg
    backend; falls back to gif). movie_cubes renders one movie per
    frequency band; fits_mfs/fits_cubes write the binned frames as
    fits images."""
    # legacy aliases (pre-parity option names)
    time_bin = kw.pop("t_bin", None) or time_bin
    freq_bin = kw.pop("f_bin", None) or freq_bin
    if fdsi is None:
        name = fds if isinstance(fds, str) and fds else \
            f"{output_filename}_{product.upper()}_{suffix}.fds"
        fds_l = dstore.read_store(name)
    else:
        fds_l = fdsi

    tlo, thi = _parse_range(time_range)
    flo, fhi = _parse_range(freq_range)
    fds_l = [ds for ds in fds_l
             if tlo <= ds["time_out"] <= thi
             and flo <= ds["freq_out"] <= fhi]

    if animate_axis == "time":
        key_of = lambda ds: ds["time_out"]
        nbin = time_bin or 1
    else:
        key_of = lambda ds: ds["freq_out"]
        nbin = freq_bin or 1

    def binned_frames(sub):
        frames, labels = [], []
        for group in _bin_keys_scanwise(sub, key_of, nbin,
                                        respect_scan_boundaries):
            frame, _ = sum_blocks(
                np.stack([ds["RESIDUAL"] for ds in group]),
                np.stack([ds["WSUM"][0] for ds in group]))
            frames.append(frame)
            if animate_axis == "time":
                labels.append(
                    f"scan {group[0].get('scanid', 0)}  "
                    f"t = {np.mean([key_of(d) for d in group]):.1f} s")
            else:
                labels.append(
                    f"nu = "
                    f"{np.mean([key_of(d) for d in group])/1e6:.1f}"
                    " MHz")
        return frames, labels

    frames, labels = binned_frames(fds_l)

    base = outname or (f"{output_filename}_{product.upper()}"
                       if output_filename else None)

    def render(frames_b, labels_b, tag):
        """Colour-map + write one movie (reference render_gif/mp4)."""
        cmname = "gray" if cmap in ("grey", "gray", "Grays") else cmap
        if cmname == "gray":
            cm = _grey_rgba
        else:
            import matplotlib
            cm = matplotlib.colormaps.get_cmap(cmname)
        # median-rms scaling (reference smoovie.py:273-284, 104-105)
        medrms = float(np.median([np.std(f) for f in frames_b]))
        if medrms <= 0:
            medrms = 1.0
        lo, hi = -min_frac * medrms, max_frac * medrms
        rgb = []
        for f, lab in zip(frames_b, labels_b):
            if annotate:
                rgb.append(_render_annotated(f, lab, cmname, lo, hi,
                                             text_colour))
            else:
                fn = np.clip((f - lo) / (hi - lo), 0.0, 1.0)
                rgb.append((cm(fn) * 255).astype(np.uint8))
        out = f"{base}{tag}_movie.{out_format}"
        if out_format == "mp4":
            try:
                import imageio
                with imageio.get_writer(
                        out, fps=fps,
                        output_params=["-crf", str(crf)]) as w:
                    for r in rgb:
                        w.append_data(r[..., :3])
            except Exception as e:  # no ffmpeg backend in this env
                log.warning(
                    "mp4 writer unavailable (%s); writing GIF", e)
                out = out[:-4] + ".gif"
                _write_gif(out, rgb, fps, optimize)
        else:
            _write_gif(out, rgb, fps, optimize)
        log.info("wrote %s (%d frames)", out, len(rgb))

    if write and base is not None and frames:
        if movie_mfs:
            render(frames, labels, "")
        if movie_cubes:
            bands = sorted({ds.get("bandid", 0) for ds in fds_l})
            for b in bands:
                sub = [ds for ds in fds_l if ds.get("bandid", 0) == b]
                fb, lb = binned_frames(sub)
                if fb:
                    render(fb, lb, f"_band{b:04d}")
        if fits_mfs or fits_cubes:
            from pfb_tpu_torch.utils.fits import save_fits, set_wcs
            cell_deg = np.rad2deg(float(fds_l[0].get("cell_rad",
                                                     1e-5)))
            radec = [fds_l[0].get("ra", 0.0), fds_l[0].get("dec", 0.0)]
            freq0 = float(np.mean([ds["freq_out"] for ds in fds_l]))
            nx, ny = frames[0].shape
            hdr = set_wcs(cell_deg, cell_deg, nx, ny, radec, freq0)
            if fits_mfs:
                save_fits(np.stack(frames),
                          f"{base}_frames_mfs.fits", hdr,
                          overwrite=overwrite)
            if fits_cubes:
                for b in sorted({ds.get("bandid", 0)
                                 for ds in fds_l}):
                    sub = [ds for ds in fds_l
                           if ds.get("bandid", 0) == b]
                    fb, _ = binned_frames(sub)
                    if fb:
                        save_fits(np.stack(fb),
                                  f"{base}_frames_band{b:04d}.fits",
                                  hdr, overwrite=overwrite)
    return frames


def _grey_rgba(x):
    """matplotlib's "gray" colour map (256 levels) on values in [0, 1]
    as RGBA floats: level min(int(256 x), 255) of a linspace(0, 1, 256)
    table, NaN to (0, 0, 0, 0), so (_grey_rgba(x) * 255).astype(uint8)
    gives the bytes matplotlib gives."""
    x = np.asarray(x, np.float64)
    bad = np.isnan(x)
    idx = np.minimum((np.where(bad, 0.0, x) * 256).astype(np.int64), 255)
    g = np.linspace(0.0, 1.0, 256)[idx]
    out = np.stack([g, g, g, np.ones_like(g)], axis=-1)
    out[bad] = 0.0
    return out


def _write_gif(out, rgb, fps, optimize=False):
    try:
        from PIL import Image
    except ImportError:
        log.warning("PIL unavailable; writing the GIF with the numpy "
                    "grey encoder")
        _write_grey_gif(out, rgb, fps)
        return
    imgs = [Image.fromarray(r) for r in rgb]
    imgs[0].save(out, save_all=True, append_images=imgs[1:],
                 duration=int(1000 / fps), loop=0, optimize=optimize)


def _lzw_literal(pix):
    """GIF image data for 8-bit indices with an LZW minimum code size of
    8, as literal 9-bit codes: a clear code before every 254 indices
    keeps the decoder's table below 512 entries, so the width never
    grows; LSB-first bit packing, 255-byte sub-blocks."""
    pix = np.asarray(pix, np.uint16).ravel()
    n = pix.size
    nrun = -(-n // 254)
    codes = np.full((nrun, 255), 256, np.uint16)   # clear, then 254
    body = np.full(nrun * 254, 0xFFFF, np.uint16)
    body[:n] = pix
    codes[:, 1:] = body.reshape(nrun, 254)
    codes = codes.ravel()
    codes = np.concatenate([codes[codes != 0xFFFF],
                            np.array([257], np.uint16)])   # end of info
    bits = ((codes[:, None] >> np.arange(9, dtype=np.uint16)) & 1)
    data = np.packbits(bits.astype(np.uint8).ravel(), bitorder="little")
    nblk = -(-data.size // 255)
    blocks = np.zeros((nblk, 256), np.uint8)
    blocks[:, 0] = 255
    blocks[-1, 0] = data.size - 255 * (nblk - 1)
    flat = np.zeros(nblk * 255, np.uint8)
    flat[:data.size] = data
    blocks[:, 1:] = flat.reshape(nblk, 255)
    keep = np.ones(blocks.shape, bool)
    keep[-1, 1 + blocks[-1, 0]:] = False
    return bytes([8]) + blocks[keep].tobytes() + b"\x00"


def _write_grey_gif(out, rgb, fps):
    """An animated GIF of grey RGB(A) frames (R = G = B, opaque) with a
    256-level grey palette, looping, ``int(1000 / fps)`` ms a frame (as
    PIL stores it), without PIL."""
    import struct
    h, w = rgb[0].shape[:2]
    head = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0),
            np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes(),
            b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"]
    delay = int(1000 / fps) // 10
    with open(out, "wb") as f:
        f.write(b"".join(head))
        for r in rgb:
            r = np.asarray(r)
            if not (np.array_equal(r[..., 0], r[..., 1]) and
                    np.array_equal(r[..., 0], r[..., 2]) and
                    (r.shape[-1] == 3 or (r[..., 3] == 255).all())):
                raise ValueError("the numpy GIF encoder takes opaque grey "
                                 "frames only; install PIL for colour")
            f.write(struct.pack("<BBBBHBB", 0x21, 0xF9, 4, 0, delay, 0, 0))
            f.write(struct.pack("<BHHHHB", 0x2C, 0, 0, w, h, 0))
            f.write(_lzw_literal(r[..., 0]))
        f.write(b"\x3b")
