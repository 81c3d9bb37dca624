"""Native (C++) host plan building, loaded via ctypes (counterpart of
pfb_tpu/native/__init__.py).

``plan.cc`` holds the pg gridder's plan builders (uv-tile binning and
entry packing, and the (tile, w)-sorted global stream of the
w-plane-blocked engine) and the uv counts of robust weighting. It is host code,
not a device kernel: ``g++`` compiles it on first use into
``build/pfb_tpu_torch/native/<source hash>/`` beside the package (with
OpenMP when the compiler has it), and a later process loads the built
library. Every routine has a numpy twin that gives the same output bit
for bit, which runs on a machine without ``g++`` or with
``PFB_TPU_NO_NATIVE`` set; :func:`builder` says which one runs.
"""

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "plan.cc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / \
    "pfb_tpu_torch" / "native"


class _State:
    lib = None
    tried = False


def _build_lib():
    """Compile plan.cc to a shared library; returns its path, or None
    when no compiler is available."""
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    out_dir = _BUILD_ROOT / tag
    out = out_dir / "libpfbt_plan.so"
    if out.exists():
        return out
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libpfbt_plan.{os.getpid()}.so"
    base = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC),
            "-o", str(tmp)]
    for cmd in (base + ["-fopenmp"], base):  # OpenMP when available
        try:
            subprocess.run(cmd, check=True, capture_output=True)
        except (subprocess.CalledProcessError, FileNotFoundError):
            continue
        os.replace(tmp, out)
        return out
    return None


def get_lib():
    """The loaded native library, or None (the numpy path runs)."""
    if _State.tried:
        return _State.lib
    _State.tried = True
    if os.environ.get("PFB_TPU_NO_NATIVE"):
        return None
    path = _build_lib()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    i64 = ctypes.c_int64
    dbl = ctypes.c_double
    p_dbl = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.pg_plan_count.argtypes = [
        p_dbl, i64, p_dbl, i64, dbl, dbl, i64, i64, i64, i64, i64,
        i64, dbl, dbl, ctypes.c_int, p_i64]
    lib.pg_plan_fill.argtypes = [
        p_dbl, i64, p_dbl, i64, dbl, dbl, i64, i64, i64, i64, i64,
        i64, dbl, dbl, ctypes.c_int, i64, i64, p_i64, p_i64, i64,
        p_dbl, p_i32, p_i32, p_dbl]
    lib.pg_compute_counts.argtypes = [
        p_dbl, i64, p_dbl, i64, p_u8, i64, i64, dbl, dbl,
        ctypes.c_int, p_dbl]
    lib.pg_gs_count.argtypes = [
        p_dbl, i64, p_dbl, i64, dbl, dbl, i64, i64, i64, i64, i64,
        i64, dbl, dbl, ctypes.c_int, p_i64]
    lib.pg_gs_fill.argtypes = [
        p_dbl, i64, p_dbl, i64, dbl, dbl, i64, i64, i64, i64, i64,
        i64, dbl, dbl, ctypes.c_int, i64, i64, p_i64, p_i64, p_i64,
        i64, p_dbl, p_i32, p_dbl, p_i32, p_i64, p_i64, p_i64]
    for fn in (lib.pg_plan_count, lib.pg_plan_fill, lib.pg_compute_counts,
               lib.pg_gs_count, lib.pg_gs_fill):
        fn.restype = ctypes.c_int
    _State.lib = lib
    return lib


def builder():
    """Which plan builder runs in this process: "native (g++)" or
    "numpy"."""
    return "numpy" if get_lib() is None else "native (g++)"


def pg_plan_native(uvw, freq, *, Nx, Ny, cellx, celly, txs, tys, ntx,
                   nty, w0, dw, nw, C, k):
    """Native uv-tile binning + entry packing for pgrid_plan: returns
    (pos (nentries, 8, C) f64, tid (nentries,) i32, idx (nentries, C)
    i32, pmask (nentries, C) f64 0/1), bit-identical to the numpy
    path, or None when no native library is available."""
    lib = get_lib()
    if lib is None:
        return None
    uvw = np.ascontiguousarray(uvw, np.float64)
    freq = np.ascontiguousarray(freq, np.float64)
    nrow, nchan = uvw.shape[0], freq.shape[0]
    ntiles = ntx * nty
    counts = np.zeros(ntiles, np.int64)
    lib.pg_plan_count(uvw, nrow, freq, nchan, cellx, celly, Nx, Ny,
                      txs, tys, ntx, nty, w0, dw, nw, counts)
    entries_per = np.maximum(1, -(-counts // C))
    offsets = np.zeros(ntiles + 1, np.int64)
    np.cumsum(entries_per, out=offsets[1:])
    nentries = int(offsets[-1])
    pos = np.zeros((nentries, 8, C), np.float64)
    tid = np.zeros(nentries, np.int32)
    idx = np.zeros((nentries, C), np.int32)
    pm = np.zeros((nentries, C), np.float64)
    lib.pg_plan_fill(uvw, nrow, freq, nchan, cellx, celly, Nx, Ny,
                     txs, tys, ntx, nty, w0, dw, nw, C, k, counts,
                     offsets, nentries, pos, tid, idx, pm)
    return pos, tid, idx, pm


def pg_counts_native(uvw, freq, mask, nx, ny, cellx, celly, k=6):
    """Native ES-stencil uv counts (the reference's numba
    _compute_counts as C++), gating on mask != 0, or None when no
    native library is available. Raises for k > 16."""
    lib = get_lib()
    if lib is None:
        return None
    uvw = np.ascontiguousarray(uvw, np.float64)
    freq = np.ascontiguousarray(freq, np.float64)
    mask = np.ascontiguousarray(np.asarray(mask) != 0, np.uint8)
    out = np.zeros(int(nx) * int(ny), np.float64)
    code = lib.pg_compute_counts(uvw, uvw.shape[0], freq, freq.shape[0],
                                 mask, int(nx), int(ny), float(cellx),
                                 float(celly), int(k), out)
    if code != 0:
        raise ValueError(f"pg_compute_counts: stencil k={k} outside 0..16")
    return out.reshape(int(nx), int(ny))


def pg_gs_plan_native(uvw, freq, *, Nx, Ny, cellx, celly, txs, tys, ntx,
                      nty, w0, dw, nw, C, k):
    """Native global-stream plan builder (per-visibility coordinates,
    (tile, w) sort, entry packing) for ops/pg_stream.py: returns (pos
    (NEg+1, 8, C) f64, gidx (NEg+1, C) i32, gpm (NEg+1, C) f64 0/1,
    utid (NEg,) i64, pmin, pmax, sxy (NEg,) i64) bit-identical to the
    numpy twin, or None when no native library is available."""
    lib = get_lib()
    if lib is None:
        return None
    uvw = np.ascontiguousarray(uvw, np.float64)
    freq = np.ascontiguousarray(freq, np.float64)
    nrow, nchan = uvw.shape[0], freq.shape[0]
    ntiles = ntx * nty
    counts = np.zeros(ntiles, np.int64)
    lib.pg_gs_count(uvw, nrow, freq, nchan, cellx, celly, Nx, Ny,
                    txs, tys, ntx, nty, w0, dw, nw, counts)
    vis_offsets = np.zeros(ntiles, np.int64)
    np.cumsum(counts[:-1], out=vis_offsets[1:])
    entries_per = -(-counts // C)  # 0 for empty tiles
    entry_offsets = np.zeros(ntiles, np.int64)
    np.cumsum(entries_per[:-1], out=entry_offsets[1:])
    NEg = int(entries_per.sum())
    pos = np.zeros((NEg + 1, 8, C), np.float64)
    gidx = np.zeros((NEg + 1, C), np.int32)
    gpm = np.zeros((NEg + 1, C), np.float64)
    utid = np.zeros(NEg, np.int32)
    pmin = np.zeros(NEg, np.int64)
    pmax = np.zeros(NEg, np.int64)
    sxy = np.zeros(NEg, np.int64)
    lib.pg_gs_fill(uvw, nrow, freq, nchan, cellx, celly, Nx, Ny,
                   txs, tys, ntx, nty, w0, dw, nw, C, k, counts,
                   vis_offsets, entry_offsets, NEg,
                   pos.reshape(-1), gidx.reshape(-1),
                   gpm.reshape(-1), utid, pmin, pmax, sxy)
    # the null entry (coordinates -2k: identically zero factors)
    pos[NEg, 0:2] = -2.0 * k
    pos[NEg, 3:5] = -2.0 * k
    return pos, gidx, gpm, utid.astype(np.int64), pmin, pmax, sxy
