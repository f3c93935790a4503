"""Multi-rank execution of the port on torch.distributed: a ("dp", "tp")
DeviceMesh, the placement trees of the model weights, and the batch
placement helpers (counterpart of ``tortoise_tpu/parallel``)."""

from tortoise_tpu_torch.parallel.mesh import (  # noqa: F401
    init_from_env,
    make_mesh,
)
from tortoise_tpu_torch.parallel.sharding import (  # noqa: F401
    ar_param_specs,
    batch_spec,
    diffusion_param_specs,
    gather_batch,
    place_batch,
    replicated,
    shard_tree,
    vocoder_param_specs,
)
