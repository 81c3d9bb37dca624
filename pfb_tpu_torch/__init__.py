"""pfb_tpu_torch — the PyTorch/CUDA port of pfb_tpu.

Same layout as pfb_tpu (``ops/``, ``opt/``, ``deconv/``, ``models/``,
``parallel/``, ``parser/``, ``workers/``, ``utils/``), so each module's
counterpart is found by path. Every worker of the JAX package runs on an
NVIDIA Hopper card, from Python or from the command line
(``python -m pfb_tpu_torch.workers.main``, console script
``pfb-tpu-torch``), through the hand-written CUDA kernels of ``csrc/``:
the PSF-Hessian convolutions (``ops/psf.py``, ``ops/pallas_fft.py``),
the w-plane c2c transforms (``ops/cfft.py``) and the pg gridder's
spread, fold and degrid (``ops/pgridder.py``, ``ops/pg_stream.py``). The
mesh layer (``parallel/``) shards bands and image rows over devices and,
through ``set_client(coordinator=...)``, over processes. On the CPU every
kernel wrapper runs its plain PyTorch version.

The package imports torch, numpy and scipy only: never jax, never
pfb_tpu. The numpy-only host modules it needs are carried over as
copies under ``utils/``.
"""

__version__ = "0.1.0"

from pfb_tpu_torch.config import default_real_dtype, set_precision
