"""Build and load the hand-written CUDA kernels (``csrc/``).

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded through ``ctypes``. The build
runs at first use, never at import, into ``build/pfb_tpu_torch/<hash>/``
next to the package, keyed by a hash of the sources; a later process
finds the library there and loads it without compiling.

A missing ``nvcc`` or a failed compile raises: nothing falls back to the
plain PyTorch versions.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = ("cfft.cu", "psf_conv.cu", "pg_grid.cu", "pg_fold.cu",
            "pg_degrid.cu", "cfft_split.cu", "lab_copy.cu", "cfft_cols.cu",
            "cfft_rows.cu", "psf_cols.cu", "psf_rows.cu", "lab_spread.cu",
            "lab_degrid.cu", "cfft_four.cu", "psf_rows_mid.cu",
            "psf_rows_long.cu", "psf_rows_short.cu", "cfft_four_rows.cu",
            "cfft_rows_long.cu", "cfft_cols_long.cu", "sara.cu")
_HEADERS = ("fft_lines.cuh", "pg_degrid.cuh", "pg_es.cuh", "pg_spread.cuh",
            "psf_cols.cuh", "psf_rows.cuh", "psf_rows_kernel.cuh",
            "rows_fft.cuh")
_BUILD_ROOT = Path(__file__).resolve().parents[1] / "build" / \
    "pfb_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    "pfbt_cfft": [_P] * 4 + [_I] * 8 + [_P] * 2,
    "pfbt_cfft_lab": [_P] * 4 + [_I] * 10 + [_P] * 2,
    "pfbt_cfft_split": [_P] * 8 + [_I] * 6 + [_P],
    "pfbt_cfft_cols": [_P] * 4 + [_I] * 11 + [_P] * 3,
    "pfbt_cols_twiddles": [_I, _P, _P],
    "pfbt_cfft_rows": [_P] * 4 + [_I] * 6 + [_P] * 2,
    "pfbt_rows_twiddles": [_I, _P, _P],
    "pfbt_cfft_four": [_P] * 4 + [_I] * 5 + [_P] * 2,
    "pfbt_four_twiddles": [_I, _P, _P],
    "pfbt_cfft_four_rows": [_P] * 4 + [_I] * 5 + [_P] * 3,
    "pfbt_cfft_rows_long": [_P] * 4 + [_I] * 5 + [_P] * 3,
    "pfbt_cfft_cols_long": [_P] * 4 + [_I] * 6 + [_P] * 3,
    "pfbt_lab_copy": [_P] * 4 + [_I] * 4 + [_P],
    "pfbt_psf_conv": [_P] * 8 + [_I] * 6 + [_P] * 4 + [_I, _P, _P],
    "pfbt_psf_stage_cols_fwd": [_P] * 3 + [_I] * 7 + [_P] * 4,
    "pfbt_psf_stage_rows": [_P] * 6 + [_I] * 3 + [_P, _I, _P, _P],
    "pfbt_psf_stage_cols_inv": [_P] * 3 + [_I] * 6 + [_F, _I] + [_P] * 4,
    "pfbt_psf_conv_full": [_P] * 8 + [_I] * 6 + [_P] * 4 + [_I, _P, _P],
    "pfbt_psf_cols_route": [_I, _I],
    "pfbt_psf_cols_fwd": [_P] * 3 + [_I] * 8 + [_P] * 3,
    "pfbt_psf_cols_inv": [_P] * 3 + [_I] * 6 + [_F] + [_I] * 2 + [_P] * 3,
    "pfbt_psf_conv_cg": [_P] * 13 + [_I] * 6 + [_P] * 4 + [_I, _P, _I, _P],
    "pfbt_psf_rows_route": [_I],
    "pfbt_psf_line_lab": [_I] + [_P] * 6 + [_I] * 6 + [_F, _P, _P],
    "pfbt_psf_rows": [_P] * 6 + [_I] * 4 + [_P] * 3,
    "pfbt_twiddles": [_I, _P, _P],
    "pfbt_pg_spread": [_P] * 5 + [_I] * 6 + [_D, _P],
    "pfbt_pg_fold": [_P] * 3 + [_I] * 11 + [_P],
    "pfbt_pg_degrid": [_P] * 5 + [_I] * 11 + [_D, _P],
    "pfbt_pg_spread_gs": [_P] * 6 + [_I] * 7 + [_D, _P],
    "pfbt_pg_spread_lab": [_P] * 6 + [_I] * 7 + [_D, _I, _I, _P],
    "pfbt_pg_fold_gs": [_P] * 3 + [_I] * 11 + [_P],
    "pfbt_pg_degrid_gs": [_P] * 6 + [_I] * 12 + [_D, _P],
    "pfbt_pg_degrid_lab": [_P] * 6 + [_I] * 12 + [_D, _I, _I, _P],
    "pfbt_psi_dot_level": [_P] * 5 + [_I] * 5 + [_L, _P],
    "pfbt_psi_hdot_level": [_P] * 5 + [_I] * 6 + [_L, _P],
    "pfbt_psi_zero": [_P] * 2 + [_I] * 3 + [_L, _P],
}


class _State:
    lib = None
    build_seconds = None
    source_seconds = None


def _source_hash():
    h = hashlib.sha256()
    for name in _SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc():
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "pfb_tpu_torch are built on a machine with the "
                           "CUDA toolkit")
    return found


def build(verbose=False):
    """Compile the kernels if their library is not built yet; returns
    the library path. ``verbose`` adds ``-Xptxas -v`` (registers, shared
    memory, spills) to the compile and prints its output."""
    out_dir = _BUILD_ROOT / _source_hash()
    lib_path = out_dir / "libpfbt_kernels.so"
    if lib_path.exists() and not verbose:
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    tmp = out_dir / f"libpfbt_kernels.{tag}.so"
    nvcc = _nvcc()
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    if verbose:
        flags += ["-Xptxas", "-v"]
    t0 = time.perf_counter()
    # one nvcc per source, all started together, then one link
    objs = [out_dir / f"{Path(s).stem}.{tag}.o" for s in _SOURCES]
    procs = [subprocess.Popen([nvcc, *flags, "-c", "-o", str(o),
                               str(_CSRC / s)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s, o in zip(_SOURCES, objs)]

    def finish(p):
        log = p.communicate()[0]
        return log, time.perf_counter() - t0
    with ThreadPoolExecutor(len(procs)) as pool:
        done = list(pool.map(finish, procs))
    logs = [log for log, _ in done]
    failed = [(s, p.returncode, log) for s, p, log in
              zip(_SOURCES, procs, logs) if p.returncode != 0]
    if not failed:
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp)]
                             + [str(o) for o in objs], capture_output=True,
                             text=True)
        if res.returncode != 0:
            failed.append(("link", res.returncode, res.stdout + res.stderr))
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{s} ({rc}):\n{log}" for s, rc, log in failed))
    if verbose:
        print("".join(logs))
    os.replace(tmp, lib_path)
    _State.build_seconds = time.perf_counter() - t0
    _State.source_seconds = {s: round(sec, 1) for s, (_, sec) in
                             zip(_SOURCES, done)}
    return lib_path


def library():
    """The loaded kernel library (built on first call)."""
    if _State.lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _State.lib = lib
    return _State.lib


def build_seconds():
    """Seconds the last compile in this process took (None if the
    library was found already built)."""
    return _State.build_seconds


def source_seconds():
    """Seconds from the start of the last compile in this process to the
    end of each source's nvcc (all run at once), by source; None if the
    library was found already built."""
    return _State.source_seconds


def check(code, name):
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} "
                           f"({torch.cuda.get_device_name()})")


def stream_ptr():
    return torch.cuda.current_stream().cuda_stream


def require_cuda_f32(name, *tensors):
    """Validate kernel operands: CUDA, float32, contiguous, one
    device."""
    dev = None
    for t in tensors:
        if t is None:
            continue
        if not t.is_cuda or t.dtype != torch.float32 or \
                not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous float32 "
                             f"CUDA tensors, got {t.dtype} on {t.device} "
                             f"(contiguous={t.is_contiguous()})")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: operands on {dev} and {t.device}")
        dev = t.device


def require_cuda_i32(name, *tensors):
    """Validate index operands: CUDA, int32, contiguous."""
    for t in tensors:
        if not t.is_cuda or t.dtype != torch.int32 or \
                not t.is_contiguous():
            raise ValueError(f"{name}: index operands must be contiguous "
                             f"int32 CUDA tensors, got {t.dtype} on "
                             f"{t.device}")


_TWIDDLES = {}


def twiddles(N, device, kind="plan"):
    """A twiddle table made on the device in float64 and rounded once to
    float32, as an (N, 2) float32 tensor on the CUDA ``device``, made once
    per (kind, N, device). ``kind="plan"``: the kernels' length-N FFT
    plan (each pass's exp(-2 pi i q k / (Ns R))); ``kind="cols"``: W_N^e
    = exp(-2 pi i e / N) for e < N, the cluster column kernels'
    (``csrc/cfft_cols.cu``, ``csrc/psf_cols.cu``); ``kind="rows"``: the
    row kernel's three stages (``csrc/cfft_rows.cu``), N - 1 entries;
    ``kind="four"``: the four-step's W_N^(n2 k1), k1 = 1..7, n2 < N/8
    (``csrc/cfft_four.cu``), 7 N/8 entries."""
    key = (kind, N, str(device))
    if key not in _TWIDDLES:
        make = {"plan": "pfbt_twiddles", "cols": "pfbt_cols_twiddles",
                "rows": "pfbt_rows_twiddles",
                "four": "pfbt_four_twiddles"}[kind]
        t = torch.empty((N, 2), dtype=torch.float32, device=device)
        check(getattr(library(), make)(N, t.data_ptr(), stream_ptr()),
              f"twiddles({kind}, {N})")
        _TWIDDLES[key] = t
    return _TWIDDLES[key]
