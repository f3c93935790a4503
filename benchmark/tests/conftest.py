"""Shared pieces of the harness's CPU tests: the repository root on the
path, and tiny sizes of the benchmark's configurations and mixes (the
port's tiny configs, with texts its 32-id vocabulary can hold)."""

import dataclasses
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def tiny(cell_name: str):
    """(spec, cell, config, mix) of ``cell_name`` at the port's tiny
    sizes."""
    from benchmark import harness
    from tortoise_tpu_torch.config import (
        tiny_ar_config,
        tiny_diffusion_config,
        tiny_vocoder_config,
    )

    spec = harness.load_spec()
    cell = harness.cell(spec, cell_name)
    config = harness.config_of(spec, cell)

    def fields(c, keys):
        return {k: list(v) if isinstance(v, tuple) else v
                for k, v in dataclasses.asdict(c).items() if k in keys}

    config["ar"] = fields(tiny_ar_config(), config["ar"])
    config["diffusion"] = fields(tiny_diffusion_config(),
                                 config["diffusion"])
    config["vocoder"] = fields(tiny_vocoder_config(), config["vocoder"])
    mix = harness.mix_of(cell)
    mix["text"] = dict(mix["text"], min_len=6, max_len=20, wrap=[31, 0],
                       id_high=31, sizes=4)
    return spec, cell, config, mix


@pytest.fixture
def tiny_cell():
    return tiny
