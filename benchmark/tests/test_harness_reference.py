"""The plain reference at tiny widths on the CPU against the port's
eager path there: the f32 plane to float rounding, the int8 plane's
quantized weights and activations to its bf16 rounding."""

import numpy as np
import pytest
import torch

from benchmark import check, weights
from benchmark.families import tortoise
from benchmark.reference import ar as R_ar
from benchmark.reference import diffusion as R_diff
from benchmark.reference import vocoder as R_voc
from benchmark.reference.precision import Precision, quantize_weight


def _port(config, seed):
    from tortoise_tpu_torch.pipeline.synthesize import TortoiseModels

    dev = torch.device("cpu")
    w = weights.make(config, seed, dev)
    ar, diff, voc = tortoise.port_configs(config, dev)
    return TortoiseModels(ar_params=w["ar"], diffusion_params=w["diffusion"],
                          vocoder_params=w["vocoder"], ar_cfg=ar,
                          diffusion_cfg=diff, vocoder_cfg=voc)


@pytest.mark.parametrize("cell,tol", [("f32-single", 1e-5),
                                      ("int8-single", 3e-2)])
def test_reference_agrees_with_the_port(tiny_cell, cell, tol):
    from tortoise_tpu_torch.pipeline.synthesize import synthesize

    _, _, config, _ = tiny_cell(cell)
    models = _port(config, 11)
    text = [31, 4, 9, 16, 25, 2, 7, 0]
    voice = np.random.default_rng(0).normal(0, .5, 64).astype(np.float32)
    int8 = config["plane"]["int8_weights"]
    res = synthesize(models, tokens=text, voice=voice, seed=5, device="cpu",
                     sampler_params={"top_k": 1}, int8_weights=int8,
                     compute_dtype=torch.bfloat16 if int8 else None)
    s = tortoise.Served(text=text, voice=voice, greedy=True,
                        tokens=tortoise.served_tokens(res.sequences[0],
                                                      config["ar"]),
                        audio=res.audio, latents=res.latents[0],
                        mel=res.mel, seed=5)
    ref = tortoise.Reference(config, 11, torch.device("cpu"),
                             tortoise.reference_precision(config))
    pen = ref.logits(s)
    # teacher-forced on the port's own greedy tokens, the reference puts
    # the same token first
    assert pen.argmax(-1).tolist() == s.tokens
    nums = tortoise.numbers(ref, s, ("ar_gap", "latent_err", "mel_err",
                                     "audio_err"))
    assert nums["ar_gap"] == 0.0
    for k in ("latent_err", "mel_err", "audio_err"):
        assert nums[k] < tol, (k, nums[k])


@pytest.mark.parametrize("kind", ["bf16", "fp8"])
def test_vocoder_operands_rounded_where_the_port_rounds(tiny_cell, kind):
    """The reference vocoder with bf16 operands is the port's bf16
    vocoder to float rounding, nearer than the float32 reference; with
    fp8 operands (the control) it departs from both."""
    from tortoise_tpu_torch.pipeline import vocoder_stage

    _, _, config, _ = tiny_cell("int8-single")
    c = config["vocoder"]
    dev = torch.device("cpu")
    w = weights.make(config, 4, dev)["vocoder"]
    mel = torch.clamp(torch.randn(c["n_mel"], 24,
                                  generator=torch.Generator().manual_seed(2))
                      * 0.5, -1, 1)
    port = torch.as_tensor(vocoder_stage.vocoder_batch_device(
        w, mel[None], [24], tortoise.port_configs(config, dev)[2], seed=9,
        compute_dtype=torch.bfloat16, device="cpu")[0])
    total = 24 + c["mel_pad_frames"]
    noise = torch.randn((1, c["noise_ch"], (total + 31) // 32 * 32),
                        generator=torch.Generator().manual_seed(9))[
        0, :, :total]
    pm = R_voc.padded_mel(mel, c)
    ref = {k: R_voc.forward(w, c, pm, noise, k) for k in (None, "bf16",
                                                          kind)}
    if kind == "bf16":
        assert check._rel(port, ref["bf16"]) < 1e-3
        assert check._rel(port, ref["bf16"]) < check._rel(port, ref[None])
    else:
        assert check._rel(ref[kind], ref["bf16"]) > 1e-2
        assert check._rel(port, ref[kind]) > 1e-2


def test_quantizers_match_the_stated_rounding():
    w = torch.randn(3, 8, 5)
    q = quantize_weight(w, 8, (-2,))
    scale = w.abs().amax(-2, keepdim=True) / 127
    assert torch.allclose(q / scale, torch.round(q / scale), atol=1e-4)
    assert (q.abs() <= w.abs().amax(-2, keepdim=True) * (1 + 1e-6)).all()
    assert torch.equal(quantize_weight(w, None, (-2,)), w)


def test_the_control_departs_from_the_reference(tiny_cell):
    _, _, config, _ = tiny_cell("int8-single")
    ref = tortoise.Reference(config, 3, torch.device("cpu"),
                             tortoise.reference_precision(config))
    ctrl = tortoise.Reference(config, 3, torch.device("cpu"),
                              tortoise.control_precision(config))
    assert tortoise.control_precision(config) == Precision(4, 8,
                                                           vocoder="fp8")
    lat = torch.randn(12, config["ar"]["d_model"])
    gen = torch.Generator().manual_seed(1)

    def noises():
        while True:
            yield torch.randn(8, 51, generator=gen)

    a = R_diff.sample(ref.diff, config["diffusion"], lat, noises())
    gen.manual_seed(1)
    b = R_diff.sample(ctrl.diff, config["diffusion"], lat, noises())
    assert check._rel(b, a) > 1e-2
    from tortoise_tpu_torch.pipeline import ar_stage

    port_ar = tortoise.port_configs(config, torch.device("cpu"))[0]
    for seq in ([1, 2, 3], [7] * 13, [4, 5, 5, 5, 37]):
        padded = R_ar.pad_sequence(seq, config["ar"])
        assert padded == ar_stage.apply_padding(seq, port_ar)
        assert [R_ar.keep_length(padded, config["ar"])] == \
            ar_stage.trim_keep_lengths([padded], port_ar)
    assert R_voc.padded_mel(torch.zeros(8, 4), config["vocoder"]).shape == (
        8, 4 + config["vocoder"]["mel_pad_frames"])
