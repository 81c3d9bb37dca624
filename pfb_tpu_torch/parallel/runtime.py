"""Runtime setup (counterpart of pfb_tpu/parallel/runtime.py:set_client).

Single host only: the mesh is built over the visible devices (or the
given ones). Multi-host runs (``coordinator=``) wait for a
torch.distributed/NCCL backend behind parallel/collectives.py (ROADMAP,
queue item "a torch.distributed/NCCL backend for collectives.py").
"""

import torch

from pfb_tpu_torch.parallel.mesh import default_devices, make_mesh


def set_client(nband=None, nspace=1, precision="single", coordinator=None,
               num_processes=None, process_id=None, devices=None):
    """Set the working precision and return the device mesh over
    ``devices`` (None: every visible CUDA device, or the CPU).
    ``precision="double"`` makes float64 torch's default dtype."""
    if coordinator is not None or (num_processes or 1) > 1:
        raise NotImplementedError(
            "multi-host set_client(coordinator=...) waits for the "
            "torch.distributed/NCCL backend of parallel/collectives.py "
            "(ROADMAP queue)")
    if precision == "double":
        torch.set_default_dtype(torch.float64)
    devices = default_devices() if devices is None else list(devices)
    if nband is None:
        nband = len(devices) // nspace
    return make_mesh(nband=nband, nspace=nspace, devices=devices)
