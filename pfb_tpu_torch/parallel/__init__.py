"""Multi-device execution: meshes, sharded tensors, collectives and the
distributed solver steps (counterpart of pfb_tpu/parallel).

The JAX package runs these as single SPMD programs (``shard_map`` over a
``jax.sharding.Mesh``). The port's mesh is a grid of ``torch.device``
driven in lockstep over its shards; entries may repeat, so a single card
holds several virtual shards. A mesh may span processes joined by
``runtime.set_client(coordinator=...)`` (torch.distributed over gloo),
each process holding its own devices' shards.
"""

from pfb_tpu_torch.parallel.mesh import Sharded, gather, make_mesh, shard
from pfb_tpu_torch.parallel.dist import (hessian_psf_dist, pcg_dist,
                                         power_method_dist,
                                         primal_dual_dist)
