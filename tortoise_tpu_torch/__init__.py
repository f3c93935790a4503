"""tortoise-tpu-torch: the PyTorch + CUDA (Hopper) port of tortoise_tpu.

Same stages and public layouts as the JAX package beside it — AR speech
token decoder, conditioned DDPM mel decoder, LVC vocoder — with each TPU
kernel on the synthesis path rewritten as a hand-written sm_90a kernel
(``csrc/``, wrappers in ``ops/cuda/``). The package imports ``torch``,
never ``jax``; it reuses the JAX package's jax-free modules
(``tortoise_tpu.config``, ``io``, ``text``, ``rng``, ``native``).
"""

__version__ = "0.1.0"
