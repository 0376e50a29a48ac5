"""Multi-device execution of the port: device meshes and sharded tensors
(:mod:`.mesh`), the halo ring of sharded stencils (:mod:`.stencil`) and
process-level runs over ``torch.distributed`` (:mod:`.multihost`)."""

from .mesh import (Mesh, Placement, blocks_mesh, make_mesh, param_sharding,
                   replicated, shard, shard_devices, single_axis_mesh,
                   unshard, volume_sharding)
from .stencil import crop_halo, halo_exchange, sharded_stencil
