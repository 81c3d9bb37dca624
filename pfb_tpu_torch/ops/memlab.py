"""Memory-pattern probes for the w-plane x pass (counterparts of the copy
kernels of scripts/wl_g2i_lab.py: ``k_skel``, ``f_single``, ``f_row``,
``f_split`` and ``f_batch``).

Each probe copies one (P, N, N) float32 stack, or two read side by side
as K3 reads re and im, in one access pattern and with no arithmetic
(``csrc/lab_copy.cu``):

- ``strip``: K3's x-pass pattern, S adjacent columns of one plane a block
  (S defaults to K3's own lines per block), all N rows read, the first
  N/2 written: out (P, N/2, N);
- ``rows``: S contiguous full rows a block (S defaults to 64; the TPU lab
  swept 64, 128 and 256), the first N/2 columns written: out (P, N,
  N/2);
- ``relayout``: as ``rows`` (S = 128), through 32 x 32 shared-memory tiles
  stored transposed and read back across threads, 1 added as
  ``f_split``'s body adds it: out (P, N, N/2) = x[..., :N/2] + 1;
- ``batched``: as ``strip``, one block for the same columns of all P
  planes: out (P, N/2, N).

Only scripts/torch_g2i_lab.py and the tests call them. A CUDA float32
stack launches the kernel; a CPU stack runs :func:`lab_copy_plain`
(slicing).
"""

import torch

from pfb_tpu_torch import kernels
from pfb_tpu_torch.ops.cfft import _LINE_ELEMS, lines_per_block

__all__ = ["MODES", "default_S", "lab_copy", "lab_copy_plain"]

MODES = ("strip", "rows", "relayout", "batched")


def default_S(mode, N):
    """Columns (strip, batched) or rows (rows, relayout) per block."""
    if mode in ("strip", "batched"):
        return lines_per_block(N)
    return 64 if mode == "rows" else 128


def _plain_one(mode, x):
    H = x.shape[-1] // 2
    if mode in ("strip", "batched"):
        return x[:, :H].contiguous()
    if mode == "rows":
        return x[..., :H].contiguous()
    return x[..., :H] + 1.0


def lab_copy_plain(mode, x, x2=None):
    """Plain version of a copy probe: slicing. Returns (y, y2), y2 None
    without x2."""
    _check(mode, x, x2)
    return _plain_one(mode, x), None if x2 is None else _plain_one(mode, x2)


def _check(mode, x, x2):
    if mode not in MODES:
        raise ValueError(f"lab_copy: mode {mode!r} not in {MODES}")
    if x.dim() != 3 or x.shape[1] != x.shape[2] or x.shape[1] % 64:
        raise ValueError(f"lab_copy: a (P, N, N) stack with N % 64 == 0, "
                         f"got {tuple(x.shape)}")
    if x2 is not None and x2.shape != x.shape:
        raise ValueError(f"lab_copy: shapes {tuple(x.shape)} and "
                         f"{tuple(x2.shape)}")


def lab_copy(mode, x, x2=None, *, S=None):
    """One copy probe of the (P, N, N) stack ``x`` (and ``x2``, read side
    by side); ``S`` columns or rows per block (None: :func:`default_S`).
    Returns (y, y2), y2 None without x2."""
    _check(mode, x, x2)
    P, N, _ = x.shape
    S = default_S(mode, N) if S is None else S
    if S < 1 or N % S or (mode == "relayout" and S % 32) or \
            (mode in ("strip", "batched") and S * N > 2 * _LINE_ELEMS):
        raise ValueError(f"lab_copy: S={S} for mode {mode!r} at N={N}")
    if not x.is_cuda:
        return lab_copy_plain(mode, x, x2)
    kernels.require_cuda_f32("lab_copy", x, x2)
    shape = (P, N // 2, N) if mode in ("strip", "batched") else (P, N, N // 2)
    y = torch.empty(shape, dtype=torch.float32, device=x.device)
    y2 = None if x2 is None else torch.empty_like(y)
    code = kernels.library().pfbt_lab_copy(
        x.data_ptr(), None if x2 is None else x2.data_ptr(), y.data_ptr(),
        None if y2 is None else y2.data_ptr(), MODES.index(mode), P, N, S,
        kernels.stream_ptr())
    kernels.check(code, f"lab_copy({mode})")
    lab_copy.launches += 1
    return y, y2


lab_copy.launches = 0
