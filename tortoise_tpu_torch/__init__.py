"""tortoise-tpu-torch: the PyTorch + CUDA (Hopper) port of tortoise_tpu.

Same stages and public layouts as the JAX package beside it — AR speech
token decoder, conditioned DDPM mel decoder, LVC vocoder — with each TPU
kernel on the synthesis path rewritten as a hand-written sm_90a kernel
(``csrc/``, wrappers in ``ops/cuda/``). The package stands alone: it
imports ``torch``, never ``jax`` and nothing of the JAX package. Its host
modules (``config``, ``io``, ``text``, ``rng``, ``native``) are its own
copies of the JAX package's modules of the same names; only the tests
import both packages. Entry points run on the card unless the caller
passes ``device="cpu"``.
"""

__version__ = "0.1.0"
