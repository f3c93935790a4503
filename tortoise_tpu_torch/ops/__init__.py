"""Tensor ops of the port; ``ops.cuda`` holds the Hopper kernels."""

from tortoise_tpu_torch.ops.basic import (  # noqa: F401
    layer_norm,
    group_norm,
    gelu,
    silu,
    leaky_relu,
    pdot,
)
