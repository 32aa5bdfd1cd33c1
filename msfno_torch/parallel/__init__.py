"""Data-parallel training over torch.distributed (port of msfno_tpu/parallel,
the data axis; the lat and channel axes are ROADMAP Queue 1 item 7)."""

from msfno_torch.parallel.distributed import (  # noqa: F401
    initialize_distributed,
    measure_scaling,
    world_size_hint,
)
from msfno_torch.parallel.mesh import AXES, factorize, make_mesh  # noqa: F401
from msfno_torch.parallel.sharded_train import make_sharded_train_step  # noqa: F401
