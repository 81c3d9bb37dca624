"""Device and dtype policy of the PyTorch port (counterpart of
pfb_tpu/config.py).

- CPU (tests, parity checks): float64, as the JAX package runs its
  tests with x64 enabled.
- CUDA: float32 by default (``_init(precision="single")``); the
  hand-written kernels are float32-only. The H100 has FP64, so the
  gridder's ``double_accum`` spreads in float64 there too.

Every op takes its dtype from its inputs; this module only supplies the
default device, the default dtypes a caller may allocate with
(:func:`set_precision`) and the working dtype of an operator with a
kernel. The JAX package's ``on_tpu`` has no counterpart: the port asks
:func:`default_device` which device it runs on.

float32 convolutions on CUDA go through cuDNN in TF32 by default (about
three decimal digits). The SARA transform (ops/wavelets.py) is a strided
``conv1d``, and TF32 there would break the Psi round trip, so TF32 is
switched off for both matmuls and convolutions when this module is
imported. Setting the two flags touches no device.
"""

import numpy as np
import torch

from pfb_tpu_torch.utils.profiling import count

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def default_device():
    """The CUDA device when one is visible, else the CPU."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def as_device(device):
    return default_device() if device is None else torch.device(device)


def kernel_dtype(device, dtype):
    """Working dtype of an operator that has a hand-written kernel:
    float32 on CUDA (the kernels' type), the caller's dtype on the CPU
    (where the plain version runs)."""
    return torch.float32 if torch.device(device).type == "cuda" \
        else dtype


_PRECISION = "double" if torch.get_default_dtype() == torch.float64 \
    else "single"


def set_precision(precision: str):
    """Set the default precision: 'single' or 'double'. It decides what
    :func:`default_real_dtype` and :func:`default_complex_dtype` return,
    and nothing else: torch's default dtype is left alone, because the
    port allocates with explicit dtypes and its kernels are float32
    only."""
    global _PRECISION
    if precision not in ("single", "double"):
        raise ValueError(f"Unknown precision {precision}")
    _PRECISION = precision


def default_real_dtype():
    return torch.float64 if _PRECISION == "double" else torch.float32


def default_complex_dtype():
    return torch.complex128 if _PRECISION == "double" else torch.complex64


def complex_for(real_dtype):
    """Complex dtype matching a real dtype."""
    return torch.promote_types(real_dtype, torch.complex64)


def to_device(x, dtype=None, device=None):
    """numpy (or a tensor) -> tensor on ``device`` (the card when there
    is one), complex included, in ``dtype`` or the input's dtype."""
    if isinstance(x, np.ndarray):
        x = np.ascontiguousarray(x)
    return torch.as_tensor(x, dtype=dtype, device=as_device(device))


def to_host(x):
    """Tensor -> numpy, complex included. A tensor's bytes count under
    ``copy.d2h_bytes``, its readback under ``sync.d2h``
    (utils/profiling.py: while a profiler runs, on every device)."""
    if isinstance(x, torch.Tensor):
        count("copy.d2h_bytes", x.numel() * x.element_size())
        count("sync.d2h")
        return x.detach().cpu().numpy()
    return np.asarray(x)
