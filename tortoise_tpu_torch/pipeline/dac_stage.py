"""The DAC stage of the Dia family: audio codes -> 44.1 kHz audio
(``models.dac``), in f32 with TF32 off (as upstream runs the codec) on
the run's device, eagerly (a request's length varies; the stage is a few
percent of its work).
"""

from __future__ import annotations

import contextlib

import torch

from tortoise_tpu_torch.models import dac as dmodel
from tortoise_tpu_torch.params import tree_to_torch
from tortoise_tpu_torch.pipeline.common import cached_cast, resolve_device
from tortoise_tpu_torch.utils import profiling


@contextlib.contextmanager
def _no_tf32():
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


@torch.inference_mode()
def dac(params, codes, cfg: dmodel.DacConfig = dmodel.DacConfig(),
        device=None) -> torch.Tensor:
    """(B, n_codebooks, T) codes (device tensor or array) -> (B, T * hop)
    f32 audio on the device, in the span ``dac.forward`` (counter
    ``audio_s``). Codes outside the codebook (Dia's specials, >= its
    size) become 0 first. The f32 weight tree is placed once per tree
    and device."""
    device = resolve_device(device)
    with profiling.span("dac.cast", device):
        params = cached_cast(params, "dac",
                             lambda p: tree_to_torch(p, device), device)
    codes = torch.as_tensor(codes, device=device).long()
    codes = torch.where(codes < cfg.codebook_size, codes, 0)
    with profiling.span("dac.forward", device,
                        audio_s=codes.shape[-1] * cfg.hop / cfg.sample_rate):
        with _no_tf32():
            return dmodel.forward(params, cfg, codes)
