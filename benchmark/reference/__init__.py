"""The plain reference of Tortoise-TTS v2 that decides a run's ``correct``.

A frozen copy of the model equations in plain PyTorch, float32, with no
kernel, cache, batching or padding: the GPT-2 AR trunk and head
(``ar``), the conditioned DDPM denoiser and its 80-step respaced loop
(``diffusion``, ``schedule``), and the UnivNet/LVC vocoder
(``vocoder``). Weights arrive as the benchmark made them, in float32;
what the program derives from them (its int8 planes, its casts, its
schedule tables) is worked out here again (``precision``).

It imports neither ``jax``, nor ``tortoise_tpu``, nor anything of
``tortoise_tpu_torch``. Callers turn TF32 off for the reference run
(``precision.tf32_mode``); the lower-precision control turns it on.
"""
