"""The attention-kernel gate of the port's CLI and server
(``cli.flash_on``), on the CPU.

The JAX CLI turns ``use_flash`` on on its TPU whatever the plane, unless
``--no-flash`` (tortoise_tpu/cli.py). The port reads "on its TPU" as "on
the card": the denoiser runs kernel B on the bf16 plane and, on the
default f32 plane, on the split-TF32 body; ``--no-flash`` and the CPU
turn it off. The server takes the same rule (it has no ``--no-flash``).
Here the card's device object is made and never used: synthesis and the
server are stopped before any work, once the gate has been read.
"""

import pytest
import torch

from tortoise_tpu_torch import cli, serve
from tortoise_tpu_torch.pipeline import common
from tortoise_tpu_torch.pipeline import synthesize as syn

CUDA, CPU = torch.device("cuda"), torch.device("cpu")


class _Stop(Exception):
    pass


@pytest.fixture
def on_card(monkeypatch):
    """resolve_device hands back the device asked for, card or not; the
    f32 plane's TF32 switches are restored after the test."""
    for mod in (torch.backends.cuda.matmul, torch.backends.cudnn):
        monkeypatch.setattr(mod, "allow_tf32", mod.allow_tf32)
    monkeypatch.setattr(common, "resolve_device",
                        lambda device=None: torch.device(device))
    monkeypatch.setattr(serve, "resolve_device",
                        lambda device=None: torch.device(device))


@pytest.mark.parametrize("device,no_flash,want", [
    (CUDA, False, True), (CUDA, True, False), (CPU, False, False),
    (CPU, True, False)])
def test_flash_on_is_the_card_unless_no_flash(device, no_flash, want):
    assert cli.flash_on(device, no_flash) is want
    if not no_flash:
        assert cli.flash_on(device) is want


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("plane", [[], ["--bf16"], ["--bf16", "--int8-weights"],
                                   ["--no-flash"], ["--bf16", "--no-flash"]])
def test_cli_sets_use_flash_by_the_gate(on_card, monkeypatch, plane, device):
    """On the card the CLI runs the attention kernel on the f32 plane too
    (no --bf16); --no-flash and the CPU run the plain attention."""
    seen = {}

    def stop(models, **kw):
        seen.update(use_flash=models.diffusion_cfg.use_flash,
                    dtype=kw["compute_dtype"], device=kw["device"])
        raise _Stop

    monkeypatch.setattr(syn, "synthesize", stop)
    with pytest.raises(_Stop):
        cli.run(["--random-weights", "--tiny", "--device", device,
                 "--tokens", "1,5,9,0", "--seed", "0", *plane])
    assert seen["device"] == torch.device(device)
    assert seen["dtype"] == (torch.bfloat16 if "--bf16" in plane else None)
    assert seen["use_flash"] is cli.flash_on(torch.device(device),
                                             "--no-flash" in plane)
    assert seen["use_flash"] is (device == "cuda"
                                 and "--no-flash" not in plane)


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("plane", [[], ["--f32"]])
def test_server_main_sets_use_flash_by_the_gate(on_card, monkeypatch, plane,
                                                device):
    """serve.main asks cli.flash_on for its models' use_flash: on the card
    on the default bf16 plane and with --f32 alike, off on the CPU."""
    asked, seen = [], {}
    gate = serve.flash_on

    def flash_on(dev, *a):
        asked.append(dev)
        return gate(dev, *a)

    class Server:
        def __init__(self, models, **kw):
            seen.update(use_flash=models.diffusion_cfg.use_flash,
                        dtype=kw["compute_dtype"])
            raise _Stop

    monkeypatch.setattr(serve, "flash_on", flash_on)
    monkeypatch.setattr(serve, "SynthesisServer", Server)
    with pytest.raises(_Stop):
        serve.main(["--random-weights", "--tiny", "--device", device,
                    "--port", "0", *plane])
    assert asked == [torch.device(device)]
    assert seen["use_flash"] is (device == "cuda")
    assert seen["dtype"] == (None if plane else torch.bfloat16)
