"""The Vocos stage of the F5-TTS family: generated log-mel -> audio
(``models.vocos``), in f32 on the run's device, eagerly (a request's
generated length varies; the stage is a small share of its work).
"""

from __future__ import annotations

import torch

from tortoise_tpu_torch.models import vocos as vmodel
from tortoise_tpu_torch.params import tree_to_torch
from tortoise_tpu_torch.pipeline.common import cached_cast, resolve_device
from tortoise_tpu_torch.utils import profiling


@torch.inference_mode()
def vocos(params, mel, cfg: vmodel.VocosConfig = vmodel.VocosConfig(),
          device=None) -> torch.Tensor:
    """(B, n_mel, n) log-mel (device tensor or array) -> (B, n * hop) f32
    audio on the device, in the span ``vocos.forward`` (counter
    ``audio_s``). The f32 weight tree is placed once per tree and
    device."""
    device = resolve_device(device)
    with profiling.span("vocos.cast", device):
        params = cached_cast(params, "vocos",
                             lambda p: tree_to_torch(p, device), device)
    mel = torch.as_tensor(mel, device=device)
    with profiling.span("vocos.forward", device,
                        audio_s=mel.shape[-1] * cfg.hop / cfg.sample_rate):
        return vmodel.forward(params, cfg, mel)
