"""The port's entry points run on the card unless the caller asks for the
CPU: on a machine without a card, a call that names no device raises."""

import numpy as np
import pytest
import torch

from tortoise_tpu_torch import cli
from tortoise_tpu_torch.config import tiny_ar_config, tiny_vocoder_config
from tortoise_tpu_torch.io.checkpoint import (
    random_ar_params,
    random_vocoder_params,
)
from tortoise_tpu_torch.pipeline import ar_stage, vocoder_stage
from tortoise_tpu_torch.pipeline.common import resolve_device
from tortoise_tpu_torch.pipeline.synthesize import TortoiseModels, synthesize


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_defaults_to_the_card(no_card):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")


def test_stage_entry_points_without_a_device_raise(no_card):
    mel = np.zeros((tiny_vocoder_config().n_mel, 8), np.float32)
    vparams = random_vocoder_params(tiny_vocoder_config(), 0)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        vocoder_stage.vocoder(vparams, mel, tiny_vocoder_config())
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ar_stage.autoregressive(random_ar_params(tiny_ar_config(), 0),
                                [1, 4, 0], np.zeros(64, np.float32),
                                cfg=tiny_ar_config())
    with pytest.raises(RuntimeError, match="no CUDA card"):
        synthesize(TortoiseModels.random(0, tiny=True), tokens=[1, 4, 0],
                   voice=np.zeros(64, np.float32))
    audio = vocoder_stage.vocoder(vparams, mel, tiny_vocoder_config(),
                                  device="cpu")
    assert audio.shape == (vocoder_stage.audio_length(
        8, tiny_vocoder_config()),)


def test_cli_device_defaults_to_cuda():
    assert cli.build_parser().parse_args([]).device == "cuda"
