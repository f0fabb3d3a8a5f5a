from pathtrace_tpu_torch.parallel.mesh import Mesh, initialize_multihost, make_mesh
from pathtrace_tpu_torch.parallel.shard import (render_aovs_sharded, render_channels_sharded,
                                                render_slab_sharded, sharded_loss_grads)

__all__ = [
    "Mesh",
    "make_mesh",
    "initialize_multihost",
    "render_aovs_sharded",
    "render_channels_sharded",
    "render_slab_sharded",
    "sharded_loss_grads",
]
