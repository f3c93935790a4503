"""Tensor ops of the port; ``ops.cuda`` holds the Hopper kernels."""
