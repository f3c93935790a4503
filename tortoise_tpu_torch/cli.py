"""Command-line entry point of the PyTorch port (single utterance):

    python -m tortoise_tpu_torch.cli --message "hello world" \\
        --voice models/mol.bin --seed 0 --bf16 --int8-weights --output out.wav

On a CUDA card the production plane is ``--bf16 --int8-weights``: the AR
decode runs kernel A each step, the denoiser and conditioner attention
run kernel B (unless ``--no-flash``), and the AR prefill/latent passes
run kernel C once B*S^2 crosses the config's threshold (the latent pass
does at --batch-size 8). Without ``--bf16`` the run is the f32 parity
plane and no kernel runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

STAGES = ("autoregressive_s", "diffusion_s", "vocoder_s")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tortoise_tpu_torch",
        description="Tortoise-TTS inference, PyTorch + CUDA port")
    p.add_argument("--message", default="this is a test message.",
                   help="text to synthesize")
    p.add_argument("--tokens", default=None,
                   help="raw comma-separated text token ids (the full "
                        "wrapped sequence); overrides --message")
    p.add_argument("--messages-file", default=None,
                   help="batched synthesis of one message per line "
                        "(not ported yet)")
    p.add_argument("--stream", action="store_true",
                   help="streaming synthesis (not ported yet)")
    p.add_argument("--voice", default=None,
                   help="path to a 1024-f32 voice latent .bin")
    p.add_argument("--output", default="output.wav", help="output WAV path")
    p.add_argument("--seed", type=int, default=None,
                   help="RNG seed (default: wall clock)")
    p.add_argument("--models", default="models",
                   help="directory with ggml-*.bin + tokenizer.json")
    p.add_argument("--batch-size", type=int, default=1,
                   help="AR candidate sequences")
    p.add_argument("--sampler", choices=("jax", "reference"), default="jax",
                   help="jax: on-device sampling (torch.Generator); "
                        "reference: mt19937 parity plane")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 matmul operands and activations")
    p.add_argument("--int8-weights", action="store_true",
                   help="int8 matmul weights with per-column scales")
    p.add_argument("--diffusion-steps", type=int, default=80,
                   help="respaced DDPM steps (80 matches the reference)")
    p.add_argument("--no-flash", action="store_true",
                   help="plain attention in the denoiser instead of the "
                        "packed attention kernel")
    p.add_argument("--random-weights", action="store_true",
                   help="synthetic random checkpoint (flow testing)")
    p.add_argument("--tiny", action="store_true",
                   help="with --random-weights: tiny test-size models")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda when available)")
    return p


def run(argv=None):
    """Parse ``argv``, synthesize, write the WAV, print the stage walls;
    returns the SynthesisResult."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.messages_file or args.stream:
        flag = "--messages-file" if args.messages_file else "--stream"
        parser.exit(2, f"{flag} is not ported to tortoise_tpu_torch yet; "
                       f"use tortoise_tpu.cli for it\n")
    if args.diffusion_steps < 2:
        parser.error(f"--diffusion-steps must be >= 2, "
                     f"got {args.diffusion_steps}")
    if args.seed is None:
        import time

        args.seed = int(time.time()) & 0x7FFFFFFF

    import numpy as np
    import torch

    from tortoise_tpu_torch.pipeline.common import resolve_device
    from tortoise_tpu_torch.pipeline.synthesize import (
        TortoiseModels,
        synthesize,
    )

    device = resolve_device(args.device)
    if args.random_weights:
        models = TortoiseModels.random(args.seed, tiny=args.tiny)
        tok_path = os.path.join(args.models, "tokenizer.json")
        if not args.tiny and os.path.exists(tok_path):
            from tortoise_tpu.text.tokenizer import Tokenizer

            models.tokenizer = Tokenizer.from_file(tok_path)
    else:
        models = TortoiseModels.from_ggml_dir(args.models)

    if args.voice is not None:
        voice = args.voice
        if not os.path.exists(voice):
            for cand in (os.path.join(args.models, voice + ".bin"),
                         os.path.join(args.models, voice)):
                if os.path.exists(cand):
                    voice = cand
                    break
            else:
                raise SystemExit(f"voice not found: {args.voice}")
    else:
        default_voice = os.path.join(args.models, "mol.bin")
        if os.path.exists(default_voice) and not args.random_weights:
            voice = default_voice
        else:
            voice = np.zeros((models.ar_cfg.d_model,), np.float32)
            print("warning: no --voice given; using a zero conditioning "
                  "latent", file=sys.stderr)

    compute_dtype = torch.bfloat16 if args.bf16 else None
    if device.type == "cuda" and compute_dtype is None:
        # the f32 parity plane: true f32 products in cuBLAS and cuDNN
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    models.diffusion_cfg = dataclasses.replace(
        models.diffusion_cfg, n_sample_timesteps=args.diffusion_steps,
        use_flash=(device.type == "cuda" and args.bf16
                   and not args.no_flash))

    tokens = None
    if args.tokens is not None:
        try:
            tokens = [int(t) for t in args.tokens.split(",") if t.strip()]
        except ValueError:
            raise SystemExit(f"--tokens must be comma-separated integers, "
                             f"got {args.tokens!r}")
        if not tokens:
            raise SystemExit("--tokens parsed to an empty id list")
    elif models.tokenizer is None:
        rng = np.random.default_rng(args.seed)
        tokens = rng.integers(1, models.ar_cfg.n_text_vocab, size=8).tolist()
        print("warning: no tokenizer.json; using stand-in tokens",
              file=sys.stderr)

    result = synthesize(models, message=args.message, tokens=tokens,
                        voice=voice, seed=args.seed,
                        batch_size=args.batch_size, sampler=args.sampler,
                        compute_dtype=compute_dtype,
                        int8_weights=args.int8_weights, device=device)
    result.save(args.output)
    total = sum(result.timings[k] for k in STAGES)
    dur = len(result.audio) / result.sample_rate
    where = str(device) if device.type != "cuda" else \
        torch.cuda.get_device_name(device)
    print(f"wrote {args.output}: {len(result.audio)} samples ({dur:.2f}s @ "
          f"{result.sample_rate} Hz) on {where}; stages: "
          + ", ".join(f"{k}={result.timings[k]:.2f}s" for k in STAGES)
          + f"; total {total:.2f}s (RTF {total / max(dur, 1e-9):.3f})")
    return result


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
