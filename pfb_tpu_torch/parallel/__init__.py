"""Multi-device execution: meshes, sharded tensors, collectives and the
distributed solver steps (counterpart of pfb_tpu/parallel).

The JAX package runs these as single SPMD programs (``shard_map`` over a
``jax.sharding.Mesh``). The port's mesh is a grid of ``torch.device``
driven from one process, in lockstep over its shards; entries may
repeat, so a single card holds several virtual shards.
"""

from pfb_tpu_torch.parallel.mesh import Sharded, gather, make_mesh, shard
from pfb_tpu_torch.parallel.dist import (hessian_psf_dist, pcg_dist,
                                         power_method_dist,
                                         primal_dual_dist)
