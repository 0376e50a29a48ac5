"""Multi-device execution of the port: device meshes and sharded tensors
(:mod:`.mesh`), the halo ring of sharded stencils (:mod:`.stencil`),
process-level runs over ``torch.distributed`` (:mod:`.multihost`), and the
pipeline, expert and ring-attention primitives (:mod:`.pipeline`,
:mod:`.experts`, :mod:`.ring_attention`)."""

from .mesh import (Mesh, Placement, blocks_mesh, make_mesh, param_sharding,
                   replicated, shard, shard_devices, single_axis_mesh,
                   torch_param_sharding, unshard, volume_sharding)
from .stencil import crop_halo, halo_exchange, sharded_stencil
from .pipeline import make_pipe_mesh, pipeline_apply, stack_stage_params
from .experts import make_expert_mesh, moe_apply
from .ring_attention import make_seq_mesh, ring_attention
