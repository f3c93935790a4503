"""Command-line entry point of the PyTorch port:

    python -m tortoise_tpu_torch.cli --message "hello world" \\
        --voice models/mol.bin --seed 0 --bf16 --int8-weights --output out.wav

``--messages-file`` synthesizes one message per line as one batch
(``synthesize_batch``; outputs get a ``-<i>`` suffix); ``--stream`` runs
the streaming path (``pipeline/streaming.py``) and prints the time to
first audio.

On a CUDA card the denoiser and conditioner attention run kernel B on
either plane unless ``--no-flash`` (``flash_on``: the JAX CLI's rule,
with its TPU read as the card). The production plane is ``--bf16
--int8-weights``: the AR decode also runs kernel A each step, and the AR
prefill/latent passes run kernel C once B*S^2 crosses the config's
threshold (the latent pass does at --batch-size 8). Without ``--bf16``
the run is the f32 parity plane: kernel B runs there on an f32 qkv, on
the split-TF32 tensor-core body, and the AR stage runs plain PyTorch.

``--family f5 --random-weights`` runs F5-TTS v1 Base and its Vocos
(``pipeline.f5_stage``) on seeded weights through the same
``synthesize()``: ``--tokens`` are the char ids to speak (seeded
stand-in ids without them), the reference clip a seeded 3 s log-mel
(0.1 s with ``--tiny``) with a seeded transcript (F5-TTS has no voice
file or tokenizer here); ``--bf16`` runs its DiT in bf16.

``--family dia --random-weights`` runs Dia-1.6B and the DAC 44.1 kHz
decoder (``pipeline.dia_stage``) on seeded weights: ``--message`` (bytes,
``[S1]``/``[S2]`` as the speakers; a seeded dialogue without it) after a
seeded 3 s prompt of codes and transcript (5 frames with ``--tiny``);
``--bf16`` runs its encoder and decoder in bf16.

With ``TORTOISE_TRACE_DIR`` set, the synthesis (not the model load) runs
under ``torch.profiler``, and a Chrome trace of it goes to that
directory: the program's ``tt.`` spans beside the kernels
(``utils.profiling``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

STAGES = ("autoregressive_s", "diffusion_s", "vocoder_s")


def flash_on(device, no_flash: bool = False) -> bool:
    """Whether the denoiser runs its attention kernel (``use_flash``):
    on the card whatever the plane, unless ``no_flash``; never on the CPU.
    The JAX CLI's rule (flash on its TPU unless --no-flash); the server
    takes it too."""
    return device.type == "cuda" and not no_flash


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
                   help="file with one message per line: synthesize all of "
                        "them as one batch; outputs get a -<i> suffix")
    p.add_argument("--voice", default=None,
                   help="path to a 1024-f32 voice latent .bin")
    p.add_argument("--output", default="output.wav", help="output WAV path")
    p.add_argument("--seed", type=int, default=None,
                   help="RNG seed (default: wall clock)")
    p.add_argument("--no-progress", action="store_true",
                   help="disable the live diffusion progress bar")
    p.add_argument("--models", default="models",
                   help="directory with ggml-*.bin + tokenizer.json")
    p.add_argument("--cache-dir", default=None,
                   help="directory for the converted .npz checkpoint cache")
    p.add_argument("--batch-size", type=int, default=1,
                   help="AR candidate sequences")
    p.add_argument("--sampler", choices=("jax", "reference"), default="jax",
                   help="jax: on-device sampling (torch.Generator); "
                        "reference: mt19937 parity plane")
    p.add_argument("--tokenizer-method", choices=("greedy", "bpe"),
                   default="greedy",
                   help="greedy matches the reference runtime; bpe matches "
                        "upstream tortoise-tts")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 matmul operands and activations")
    p.add_argument("--int8-weights", action="store_true",
                   help="int8 matmul weights with per-column scales")
    p.add_argument("--temperature", type=float, default=None,
                   help="AR sampling temperature (default 0.8)")
    p.add_argument("--top-k", type=int, default=None,
                   help="AR top-k candidates (default 50; above 128 the "
                        "plain sampler runs instead of kernel A's)")
    p.add_argument("--top-p-drop", type=float, default=None,
                   help="drop candidates whose ascending cumulative mass "
                        "is <= this (default 0.2)")
    p.add_argument("--repetition-penalty", type=float, default=None,
                   help="penalty on the previous token's logit "
                        "(default 2.0)")
    p.add_argument("--diffusion-steps", type=int, default=80,
                   help="respaced DDPM steps (80 matches the reference)")
    p.add_argument("--no-flash", action="store_true",
                   help="plain attention in the denoiser instead of the "
                        "packed attention kernel")
    p.add_argument("--stream", action="store_true",
                   help="streaming synthesis: windowed diffusion and "
                        "chunked vocoding; prints the time to first audio")
    p.add_argument("--stream-window", type=int, default=352,
                   help="streaming: mel frames denoised per window")
    p.add_argument("--stream-overlap", type=int, default=32,
                   help="streaming: crossfaded frames between windows")
    p.add_argument("--stream-first-window", type=int, default=96,
                   help="streaming: width of the smaller first window (0: "
                        "the same as the others)")
    p.add_argument("--vocoder-margin", type=int, default=32,
                   help="streaming: context frames vocoded on each side "
                        "of a chunk and dropped")
    p.add_argument("--random-weights", action="store_true",
                   help="synthetic random checkpoint (flow testing)")
    p.add_argument("--tiny", action="store_true",
                   help="with --random-weights: tiny test-size models")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; fails without a card, "
                        "pass --device cpu for the CPU)")
    p.add_argument("--family", choices=("tortoise", "f5", "dia"),
                   default="tortoise",
                   help="model family: Tortoise-TTS v2, F5-TTS v1 Base or "
                        "Dia-1.6B (the last two with --random-weights)")
    return p


def _check_modes(args) -> None:
    """The JAX CLI's rules: the batched and streaming paths run the
    jax sampler at one candidate, and --messages-file takes neither
    --stream nor --tokens."""
    if args.messages_file:
        if args.sampler != "jax" or args.batch_size != 1:
            raise SystemExit(
                "--messages-file is the batched jax-sampler path; "
                "--sampler reference and --batch-size apply to --message")
        if args.stream or args.tokens is not None:
            raise SystemExit(
                "--messages-file conflicts with --stream and --tokens; "
                "they apply to the single-utterance path")
    if args.stream and (args.sampler != "jax" or args.batch_size != 1):
        raise SystemExit(
            "--stream is the single-candidate jax-sampler path; --sampler "
            "reference and --batch-size apply to the one-shot path")


def _progress(args):
    """The diffusion progress callback: a bar on stderr unless
    --no-progress."""
    if args.no_progress:
        return None
    from tortoise_tpu_torch.utils.progress import progress_bar

    return progress_bar


def run(argv=None):
    """Parse ``argv``, synthesize, write the WAV(s), print the walls;
    returns the SynthesisResult (the list of them with --messages-file,
    the StreamChunk list with --stream)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    _check_modes(args)
    if args.diffusion_steps < 2:
        parser.error(f"--diffusion-steps must be >= 2, "
                     f"got {args.diffusion_steps}")
    if args.seed is None:
        import time

        args.seed = int(time.time()) & 0x7FFFFFFF

    import numpy as np
    import torch

    from tortoise_tpu_torch.pipeline.ar_stage import sampler_overrides
    from tortoise_tpu_torch.pipeline.common import resolve_device
    from tortoise_tpu_torch.pipeline.synthesize import TortoiseModels
    from tortoise_tpu_torch.utils.profiling import trace

    device = resolve_device(args.device)
    if args.family != "tortoise":
        with trace():
            return FAMILY_RUNS[args.family](args, device)
    if args.random_weights:
        models = TortoiseModels.random(args.seed, tiny=args.tiny)
        tok_path = os.path.join(args.models, "tokenizer.json")
        if not args.tiny and os.path.exists(tok_path):
            from tortoise_tpu_torch.text.tokenizer import Tokenizer

            models.tokenizer = Tokenizer.from_file(tok_path)
    else:
        models = TortoiseModels.from_ggml_dir(args.models, args.cache_dir)

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
        use_flash=flash_on(device, args.no_flash))

    sampler_params = sampler_overrides(args.temperature, args.top_k,
                                       args.top_p_drop,
                                       args.repetition_penalty)
    kw = dict(voice=voice, seed=args.seed, compute_dtype=compute_dtype,
              int8_weights=args.int8_weights, sampler_params=sampler_params,
              tokenizer_method=args.tokenizer_method, device=device)
    with trace():
        return _run_synthesis(args, models, kw)


def _run_f5(args, device):
    """--family f5: one utterance of F5-TTS on seeded weights."""
    import numpy as np
    import torch

    from tortoise_tpu_torch.pipeline.f5_stage import F5Models, F5Voice
    from tortoise_tpu_torch.pipeline.synthesize import synthesize

    if not args.random_weights:
        raise SystemExit("--family f5 runs on --random-weights only (the "
                         "published checkpoints are not loaded here)")
    models = F5Models.random(args.seed, tiny=args.tiny, device=device)
    vc = models.vocos_cfg
    rng = np.random.default_rng(args.seed)
    ref_s = 0.1 if args.tiny else 3.0  # the tiny Vocos's hop is 16
    voice = F5Voice(
        mel=rng.normal(-4.0, 2.0, (int(ref_s * vc.sample_rate) // vc.hop,
                                   vc.n_mel)).astype(np.float32),
        text=rng.integers(1, models.cfg.text_vocab,
                          max(1, round(15 * ref_s))).tolist())
    if args.tokens is not None:
        tokens = [int(t) for t in args.tokens.split(",") if t.strip()]
    else:
        tokens = rng.integers(1, models.cfg.text_vocab, 80).tolist()
    result = synthesize(models, tokens=tokens, voice=voice, seed=args.seed,
                        compute_dtype=torch.bfloat16 if args.bf16 else None,
                        progress=_progress(args), device=device)
    result.save(args.output)
    total = result.timings["f5_s"] + result.timings["vocos_s"]
    dur = len(result.audio) / result.sample_rate
    print(f"wrote {args.output}: {len(result.audio)} samples ({dur:.2f}s @ "
          f"{result.sample_rate} Hz); f5={result.timings['f5_s']:.2f}s, "
          f"vocos={result.timings['vocos_s']:.2f}s; total {total:.2f}s "
          f"(RTF {total / max(dur, 1e-9):.3f})")
    return result


def _run_dia(args, device):
    """--family dia: one utterance of Dia on seeded weights."""
    import numpy as np
    import torch

    from tortoise_tpu_torch.pipeline.dia_stage import DiaModels, DiaVoice
    from tortoise_tpu_torch.pipeline.synthesize import synthesize

    if not args.random_weights:
        raise SystemExit("--family dia runs on --random-weights only (the "
                         "published checkpoints are not loaded here)")
    models = DiaModels.random(args.seed, tiny=args.tiny, device=device)
    cfg, dc = models.cfg, models.dac_cfg
    rng = np.random.default_rng(args.seed)
    frames = 5 if args.tiny else round(3.0 * dc.sample_rate / dc.hop)
    voice = DiaVoice(
        codes=rng.integers(0, dc.codebook_size, (frames, cfg.channels)),
        text=[1] + rng.integers(32, 127, 8 if args.tiny else 45).tolist())
    message = args.message or "[S1] " + "".join(
        chr(c) for c in rng.integers(97, 123, 60))
    result = synthesize(models, message=message, voice=voice,
                        seed=args.seed,
                        compute_dtype=torch.bfloat16 if args.bf16 else None,
                        progress=_progress(args), device=device,
                        min_frames=8 if args.tiny else 0,
                        max_frames=16 if args.tiny else None)
    result.save(args.output)
    total = result.timings["dia_s"] + result.timings["dac_s"]
    dur = len(result.audio) / result.sample_rate
    print(f"wrote {args.output}: {len(result.audio)} samples ({dur:.2f}s @ "
          f"{result.sample_rate} Hz); dia={result.timings['dia_s']:.2f}s, "
          f"dac={result.timings['dac_s']:.2f}s; total {total:.2f}s "
          f"(RTF {total / max(dur, 1e-9):.3f})")
    return result


# the runs of the families beside Tortoise's, on seeded weights
FAMILY_RUNS = {"f5": _run_f5, "dia": _run_dia}


def _run_synthesis(args, models, kw):
    """The synthesis the flags ask for: one batch (--messages-file), a
    stream (--stream) or one utterance."""
    import numpy as np
    import torch

    from tortoise_tpu_torch.pipeline.synthesize import synthesize

    device = kw["device"]
    if args.messages_file:
        return _run_batch(args, models, kw)

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

    if args.stream:
        return _run_stream(args, models, tokens, kw)
    result = synthesize(models, message=args.message, tokens=tokens,
                        batch_size=args.batch_size, sampler=args.sampler,
                        progress=_progress(args), **kw)
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


def _run_batch(args, models, kw):
    """--messages-file: every line through one synthesize_batch call."""
    import numpy as np

    from tortoise_tpu_torch.pipeline.synthesize import synthesize_batch

    with open(args.messages_file) as f:
        messages = [line.strip() for line in f if line.strip()]
    if not messages:
        raise SystemExit(f"{args.messages_file}: no messages found")
    tokens_list = None
    if models.tokenizer is None:
        rng = np.random.default_rng(args.seed)
        tokens_list = [
            rng.integers(1, models.ar_cfg.n_text_vocab,
                         size=max(2, min(len(m), 12))).tolist()
            for m in messages]
        print("warning: no tokenizer.json; using stand-in tokens",
              file=sys.stderr)
    voice = kw.pop("voice")
    results = synthesize_batch(models, messages=messages,
                               tokens_list=tokens_list, voices=voice,
                               progress=_progress(args), **kw)
    root, ext = os.path.splitext(args.output)
    for i, r in enumerate(results):
        path = f"{root}-{i}{ext or '.wav'}"
        r.save(path)
        print(f"wrote {path}: {len(r.audio)} samples "
              f"({len(r.audio) / r.sample_rate:.2f}s)")
    total = sum(results[0].timings[k] for k in STAGES)
    dur = sum(len(r.audio) for r in results) / results[0].sample_rate
    print(f"batch of {len(results)}: {total:.2f}s (RTF "
          f"{total / max(dur, 1e-9):.3f})")
    return results


def _run_stream(args, models, tokens, kw):
    """--stream: write the concatenated chunks, print the first chunk's
    latency and the wall."""
    import time

    import numpy as np

    from tortoise_tpu_torch.io.wav import write_wav
    from tortoise_tpu_torch.pipeline.streaming import stream_synthesize

    t0 = time.monotonic()
    chunks = []
    for chunk in stream_synthesize(
            models, message=args.message, tokens=tokens,
            window_frames=args.stream_window,
            overlap_frames=args.stream_overlap,
            vocoder_margin=args.vocoder_margin,
            first_window_frames=args.stream_first_window or None, **kw):
        if not chunks:
            print(f"first audio after {chunk.latency_s:.2f}s "
                  f"({len(chunk.audio)} samples)", flush=True)
        chunks.append(chunk)
    wall = time.monotonic() - t0
    audio = np.concatenate([c.audio for c in chunks])
    sr = models.vocoder_cfg.sample_rate
    write_wav(args.output, audio, sr)
    dur = len(audio) / sr
    print(f"wrote {args.output}: {len(audio)} samples ({dur:.2f}s @ {sr} "
          f"Hz); first_audio {chunks[0].latency_s:.2f}s, wall {wall:.2f}s "
          f"(RTF {wall / max(dur, 1e-9):.3f})")
    return chunks


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
