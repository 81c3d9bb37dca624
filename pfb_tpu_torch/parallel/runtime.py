"""Runtime setup (counterpart of pfb_tpu/parallel/runtime.py:set_client).

One process: the mesh is built over the visible devices (or the given
ones). Several processes (``coordinator=``): torch.distributed joins them
over gloo first, and the mesh is the global one, process-major, each
process holding its own devices' shards (parallel/mesh.py). Gloo moves
tensors through host memory; NCCL, for processes on separate cards, waits
for a four-card setup (ROADMAP).
"""

import datetime

import torch

from pfb_tpu_torch.parallel.mesh import default_devices, make_mesh

# seconds a rendezvous or a collective waits for the other processes
# before it fails (instead of hanging)
TIMEOUT_S = 120


def set_client(nband=None, nspace=1, precision="single", coordinator=None,
               num_processes=None, process_id=None, devices=None):
    """Set the working precision, join the processes of a multi-process
    run and return the device mesh over every process's ``devices`` (None:
    every visible CUDA device, or the CPU). ``precision="double"`` makes
    float64 torch's default dtype. ``coordinator`` is process 0's
    host:port (a free port there), with ``num_processes`` and this
    process's ``process_id``."""
    if precision == "double":
        torch.set_default_dtype(torch.float64)
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator= needs num_processes and "
                             "process_id")
        import torch.distributed as dist
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator}",
            world_size=int(num_processes), rank=int(process_id),
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    elif (num_processes or 1) > 1:
        raise ValueError("num_processes > 1 needs a coordinator")
    devices = default_devices() if devices is None else \
        [torch.device(d) for d in devices]
    return make_mesh(nband=nband, nspace=nspace, devices=devices)
