"""``dryrun_multichip(n)``: the parallel structure end to end on n ranks
at tiny shapes (counterpart of ``__graft_entry__.dryrun_multichip``).

    python -m tortoise_tpu_torch.parallel.dryrun 4               # NCCL, 4 cards
    python -m tortoise_tpu_torch.parallel.dryrun 4 --device cpu  # gloo, CPU

Each rank, on ``make_mesh(n)``: the tp-sharded AR prefill and one decode
step on its dp rows; the dp plane of ``autoregressive_batch`` (kernel A
on each rank's rows, its plain twin on the CPU) on a pure-dp mesh for 4
steps; one tp-sharded denoiser eval; one tp-sharded vocoder forward.
Every output must be finite and of its shape.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np


def _rank(rank: int, world: int, device: str) -> dict:
    import torch

    from tortoise_tpu_torch.config import (
        tiny_ar_config,
        tiny_diffusion_config,
        tiny_vocoder_config,
    )
    from tortoise_tpu_torch.io.checkpoint import (
        random_ar_params,
        random_diffusion_params,
        random_vocoder_params,
    )
    from tortoise_tpu_torch.models import ar
    from tortoise_tpu_torch.models import diffusion as dmodel
    from tortoise_tpu_torch.models import vocoder as vmodel
    from tortoise_tpu_torch.ops.relpos import relative_position_buckets
    from tortoise_tpu_torch.parallel import (
        ar_param_specs,
        diffusion_param_specs,
        gather_batch,
        make_mesh,
        place_batch,
        shard_tree,
        vocoder_param_specs,
    )
    from tortoise_tpu_torch.parallel.mesh import axis_group, axis_size
    from tortoise_tpu_torch.params import tree_to_torch
    from tortoise_tpu_torch.pipeline import ar_stage

    mesh = make_mesh(world, device_type=device)
    tp = axis_group(mesh, "tp")
    dp = axis_size(mesh, "dp")
    rng = np.random.default_rng(0)
    out = {"mesh": tuple(mesh.mesh.shape)}

    def check(name, x, shape):
        x = x.float().cpu()
        if tuple(x.shape) != shape or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{name}: {tuple(x.shape)} (want {shape}), "
                                 f"finite {bool(torch.isfinite(x).all())}")
        out[name] = shape

    # the tp-sharded AR prefill + one decode step, dp over the rows
    cfg = tiny_ar_config()
    params = shard_tree(tree_to_torch(random_ar_params(cfg, 0), device),
                        ar_param_specs(mesh), mesh)
    b, t = 2 * dp, 8
    text = place_batch(rng.integers(0, cfg.n_text_vocab, (b, t)), mesh)
    valid = place_batch(np.ones((b, t), bool), mesh)
    voice = torch.as_tensor(rng.normal(0, 0.5, (cfg.d_model,))
                            .astype(np.float32), device=device)
    logits, cache = ar.prefill(params, cfg, text, valid, voice, tp=tp)
    check("prefill_logits", gather_batch(logits, mesh), (b, cfg.n_mel_vocab))
    tokens = torch.full((text.shape[0],), 5, device=text.device)
    logits, _ = ar.decode_step(params, cfg, cache, tokens, 0, tp=tp)
    check("decode_logits", gather_batch(logits, mesh), (b, cfg.n_mel_vocab))

    # the dp plane of the AR stage on a pure-dp mesh (kernel A per rank)
    dmesh = make_mesh(world, shape=(world, 1), device_type=device)
    fcfg = dataclasses.replace(tiny_ar_config(), fused_decode=True,
                               max_decode_steps=4)
    toks = [list(rng.integers(0, fcfg.n_text_vocab, (5,)))
            for _ in range(world)]
    voices = rng.normal(0, .5, (world, fcfg.d_model)).astype(np.float32)
    _, padded = ar_stage.autoregressive_batch(
        random_ar_params(fcfg, 3), toks, voices, fcfg, seed=5,
        compute_dtype=torch.bfloat16, int8_weights=True, mesh=dmesh,
        device=device)
    if [len(s) for s in padded] != [fcfg.pad_mel_length + 2] * world:
        raise AssertionError(f"dp plane: padded sequences {padded}")
    out["dp_plane_rows"] = len(padded)

    # one tp-sharded denoiser eval (CFG rows over dp)
    dcfg = tiny_diffusion_config()
    dparams = shard_tree(
        tree_to_torch(random_diffusion_params(dcfg, 1), device),
        diffusion_param_specs(mesh), mesh)
    t = 16
    x = place_batch(rng.normal(0, 1, (2 * dp, dcfg.n_mel, t))
                    .astype(np.float32), mesh)
    code = place_batch(rng.normal(0, 0.5, (2 * dp, dcfg.d_model, t))
                       .astype(np.float32), mesh)
    buckets = torch.as_tensor(relative_position_buckets(
        t, dcfg.rel_pos_buckets, dcfg.rel_pos_max_distance), device=device)
    eps = dmodel.denoise(dparams, dcfg, x, code, 100, buckets, tp=tp)
    check("denoise", gather_batch(eps, mesh), (2 * dp, 2 * dcfg.n_mel, t))

    # one vocoder forward, the kernel predictor's channels tp-sharded
    vcfg = tiny_vocoder_config()
    vparams = shard_tree(
        tree_to_torch(random_vocoder_params(vcfg, 2), device),
        vocoder_param_specs(mesh, n_stages=len(vcfg.strides)), mesh)
    m = 12
    mel = place_batch(rng.normal(0, 1, (2 * dp, vcfg.n_mel, m))
                      .astype(np.float32), mesh)
    noise = place_batch(rng.normal(0, 1, (2 * dp, vcfg.noise_ch, m))
                        .astype(np.float32), mesh)
    audio = vmodel.vocoder_forward(vparams, vcfg, mel, noise, tp=tp)
    check("audio", gather_batch(audio, mesh),
          (2 * dp, m * vcfg.total_upsample - 6))
    return out


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     timeout: float = 120.0) -> list:
    """Run the dry run on ``n_devices`` spawned ranks (NCCL, one card a
    rank; gloo on the CPU with ``device="cpu"``); returns each rank's
    summary. Raises with the ranks' output when one fails (a rank without
    a card fails in ``make_mesh``)."""
    from tortoise_tpu_torch.parallel.launch import run_ranks

    return run_ranks(_rank, n_devices, (device,), timeout=timeout,
                     backend="nccl" if device == "cuda" else "gloo")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=4)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)
    for r, summary in enumerate(dryrun_multichip(args.n, args.device)):
        print(f"rank {r}: {summary}")
    print(f"dryrun_multichip({args.n}): OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
