"""The (data, lat, channel) mesh over torch.distributed (port of
msfno_tpu/parallel): the mesh and its layout rules, the active mesh and the
model's explicit collectives, the all_to_all sharded SHT and training over
the mesh."""

from msfno_torch.parallel.distributed import (  # noqa: F401
    initialize_distributed,
    measure_scaling,
    world_size_hint,
)
from msfno_torch.parallel.mesh import AXES, factorize, make_mesh  # noqa: F401
from msfno_torch.parallel.sharded_train import make_sharded_train_step  # noqa: F401
