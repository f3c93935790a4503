"""End-to-end synthesis benchmark of the port (counterpart of the JAX
package's ``bench.py``; the names below are that file's).

    python -m tortoise_tpu_torch.bench                          # the card
    BENCH_SMALL=1 BENCH_DEVICE=cpu python -m tortoise_tpu_torch.bench

Runs the three stages at production width on synthetic random weights
(the published GGML weights are not redistributable) and reports the
real-time factor:

    RTF = wall seconds of the synthesize() call / audio seconds

(lower is better), the best of ``BENCH_REPS`` passes after a warmup
pass. The headline JSON line is printed as soon as the core numbers
exist and printed again, enriched, after each further section: parse
the LAST line of stdout. A section that fails prints the line with
``"<section>": {"error": ...}`` and the bench exits 1; so does a kernel
self-check that is not ok. Nothing falls back to another plane.

The headline plane is bf16 activations + int8 matmul weights. Fields
that differ from the JAX bench's:

- no ``vs_baseline``: its target RTF is the JAX package's goal on a TPU;
- the roofline shares use the H100's published peaks;
- ``kernel_launches``: the launches of each hand-written kernel during
  one timed pass of each section (``ops.cuda.launch_counts``), and
  ``kernel_check.launches`` those of the self-check;
- ``checked_sync``'s composed route reports ``sync_consistent: false``
  (with ``sync_composed: true``): the composed split is no one pass.

Knobs (environment): BENCH_DEVICE (default the card; ``cpu`` asks for
the CPU), BENCH_SMALL=1 the tiny configs, BENCH_F32=1 the f32 plane
(TF32 off for matmuls and cuDNN, as the CLI does; f32 weights, no int8
plane), BENCH_REPS (3) timed passes, BENCH_BUDGET_S (1500) wall budget
past which sections are skipped and listed in ``bench_sections_skipped``,
BENCH_BATCH_SIZES (``4,8,16``) the batch sweep, BENCH_ALT_PATH=0 skips
the bf16-weights section, BENCH_NO_FLASH=1 runs the denoiser without its
attention kernel, and BENCH_WEIGHTS_CACHE the host-tree and int8-plane
cache (default ``tortoise_torch_bench_weights`` in the temporary
directory; empty disables it). The trees live in a subdirectory keyed
by a hash of the sources that make them (``weights_dir``), so an edit to
the weights, the quantizers or the plane layout never loads a stale
plane; the warm-start child (BENCH_CHILD=1, set by the bench itself)
loads the plane the parent wrote there.
The JAX bench's BENCH_FLASH_BQ, BENCH_FLASH_HPP, BENCH_FLASH_GROUP,
BENCH_FLASH_VMEM_MB and BENCH_DIFF_UNROLL set the TPU's Pallas tiling
and loop unrolling; they mean nothing to the CUDA kernels and are not
read.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Optional

import numpy as np
import torch

from tortoise_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
from tortoise_tpu_torch.pipeline.common import resolve_device, sync

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# NVIDIA H100 SXM5 80GB published peaks (dense): HBM3 bytes/s, bf16
# tensor-core FLOP/s (the int8 plane's products run as bf16 matmuls) and
# f32 FLOP/s without TF32 (the f32 plane turns TF32 off)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


# the sources that decide the cached trees' bytes: the configs, the
# random weights, the quantizers and the plane's on-disk layout
_TREE_SOURCES = ("config.py", "io/checkpoint.py", "io/plane_cache.py",
                 "ops/basic.py", "pipeline/ar_stage.py",
                 "pipeline/diffusion_stage.py")


def weights_dir(small: bool) -> Optional[str]:
    """The bench's cache directory for one size: under BENCH_WEIGHTS_CACHE
    (None when that is empty), named by the size, the seed and a hash of
    ``_TREE_SOURCES``, since ``plane_cache.save_plane`` keeps a plane that
    exists rather than replacing it: its path must be keyed by content."""
    base = os.environ.get(
        "BENCH_WEIGHTS_CACHE",
        os.path.join(tempfile.gettempdir(), "tortoise_torch_bench_weights"))
    if not base:
        return None
    pkg = os.path.dirname(os.path.abspath(__file__))
    h = hashlib.sha256()
    for rel in _TREE_SOURCES:
        with open(os.path.join(pkg, rel), "rb") as f:
            h.update(f.read())
    return os.path.join(
        base, f"{'tiny' if small else 'full'}_0_{h.hexdigest()[:16]}")


def build_models(small, use_bf16, int8=False, device=None):
    """Returns (models, models_f32). With the int8 plane on and a cache
    dir set, the quantized host trees are disk-cached (io/plane_cache): a
    later process memory-maps the int8 bytes instead of drawing and
    quantizing the f32 weights. models_f32 keeps the float source for the
    bf16-weights section; it is None when the plane cache served."""
    from tortoise_tpu_torch.cli import flash_on
    from tortoise_tpu_torch.io import plane_cache
    from tortoise_tpu_torch.pipeline.synthesize import TortoiseModels

    device = resolve_device(device)
    cache_dir = weights_dir(small)
    plane_dir = os.path.join(cache_dir, "plane_int8") if (
        cache_dir and int8) else None
    models_f32 = None
    models = None
    if plane_dir:
        tree = plane_cache.load_plane(plane_dir)
        if tree is not None:
            models = TortoiseModels(
                ar_params=tree["ar"], diffusion_params=tree["diffusion"],
                vocoder_params=tree["vocoder"])
            if small:
                from tortoise_tpu_torch.config import (
                    tiny_ar_config,
                    tiny_diffusion_config,
                    tiny_vocoder_config,
                )

                models.ar_cfg = tiny_ar_config()
                models.diffusion_cfg = tiny_diffusion_config()
                models.vocoder_cfg = tiny_vocoder_config()
    if models is None:
        models_f32 = TortoiseModels.random(seed=0, tiny=small,
                                           cache_dir=cache_dir)
        models = models_f32
        if plane_dir:
            from tortoise_tpu_torch.pipeline.ar_stage import quantize_ar_host
            from tortoise_tpu_torch.pipeline.diffusion_stage import (
                quantize_diffusion_weights,
            )

            ar_q = quantize_ar_host(models_f32.ar_params)
            diff_q = quantize_diffusion_weights(models_f32.diffusion_params)
            plane_cache.save_plane(
                {"ar": ar_q, "diffusion": diff_q,
                 "vocoder": models_f32.vocoder_params}, plane_dir)
            # run on the quantized trees (the stages' casts pass pairs
            # through); models_f32 stays for the bf16-weights section
            models = dataclasses.replace(models_f32, ar_params=ar_q,
                                         diffusion_params=diff_q)
    if small:
        models.ar_cfg = dataclasses.replace(models.ar_cfg,
                                            max_decode_steps=8,
                                            pad_mel_length=8)
    models.diffusion_cfg = dataclasses.replace(
        models.diffusion_cfg, use_flash=flash_on(
            device, no_flash=os.environ.get("BENCH_NO_FLASH") == "1"))
    return models, models_f32


def checked_sync(run_sync, max_tries: int = 3, ref_wall=None):
    """Run a stage-synced pass and check that its decomposition can be
    trusted, two ways:

    1. self-consistent: the top-level stage walls (autoregressive_s +
       diffusion_s + vocoder_s) sum to within 25% of the pass's own wall;
    2. representative: with ``ref_wall`` (the async wall the split is
       meant to explain), the pass's wall is at most 2x of it.

    Retries up to max_tries and keeps the best pass (consistent first,
    then the smallest error and wall). If no pass is clean, the split is
    composed from each substage's minimum over the attempts and shipped
    when it sums to at most 2x ``ref_wall``, with ``sync_composed: True``
    and ``sync_consistent: False``: no one pass measured it.

    run_sync() -> (timings_dict, wall_s, payload). Returns
    (payload, timings, wall, {"sync_retries": n, "sync_consistent": ok,
    ...}).
    """
    top = ("autoregressive_s", "diffusion_s", "vocoder_s")
    best = None
    attempts = []
    for attempt in range(max_tries):
        timings, wall, payload = run_sync()
        attempts.append((timings, wall, payload))
        ssum = sum(timings.get(k, 0.0) for k in top)
        err = abs(ssum - wall) / max(wall, 1e-9)
        ok = err <= 0.25 and (ref_wall is None or wall <= 2.0 * ref_wall)
        key = (not ok, err, wall)
        if best is None or key < best[0]:
            best = (key, timings, wall, payload)
        if ok:
            return payload, timings, wall, {
                "sync_retries": attempt, "sync_consistent": True}
        print(f"stage-sync decomposition untrustworthy (sum {ssum:.2f}s, "
              f"wall {wall:.2f}s, async ref "
              f"{ref_wall if ref_wall is None else round(ref_wall, 2)}s), "
              f"retrying", file=sys.stderr, flush=True)
    _, timings, wall, payload = best
    keys = set().union(*(t.keys() for t, _, _ in attempts))
    composed = {k: min(t[k] for t, _, _ in attempts if k in t)
                for k in keys}
    csum = sum(composed.get(k, 0.0) for k in top)
    if ref_wall is not None and csum <= 2.0 * ref_wall:
        return payload, composed, csum, {
            "sync_retries": max_tries - 1, "sync_consistent": False,
            "sync_composed": True}
    return payload, timings, wall, {
        "sync_retries": max_tries - 1, "sync_consistent": False}


# the self-check's kernels, by their launch-counter names
CHECKED_KERNELS = ("flash_attention_packed", "flash_attention_causal_qkv",
                   "decode_trunk")


def kernel_selfcheck(device=None) -> dict:
    """Kernels B, C and A on the card at the JAX bench's shapes. B and C
    at (b, h, t, d) = (2, 16, 512, 64) with one row's last 40 keys
    invalid, against an f32 softmax attention on the f32 values of the
    same bf16 inputs, B's bias gathered from the (h, t, t) bucket ids
    apart from the kernels' own bias builder; A (the int8 decode step) at
    production width with 2 layers, a 256-slot cache and a 1024-entry
    vocab, against the per-layer decode on the same weights and cache.
    The dict gives each max |diff|, the launches of each kernel during the
    check (so the kernel ran, not its plain version) and ``ok``: every
    diff within the JAX bench's limits and every kernel launched."""
    from tortoise_tpu_torch.config import ARConfig
    from tortoise_tpu_torch.io.checkpoint import random_ar_params
    from tortoise_tpu_torch.models import ar
    from tortoise_tpu_torch.ops.cuda import flash_attention as fa
    from tortoise_tpu_torch.ops.relpos import (
        relative_position_buckets,
        relpos_bias,
    )
    from tortoise_tpu_torch.pipeline.ar_stage import cast_matmul_weights

    device = resolve_device(device)
    out = {}
    rng = np.random.default_rng(0)

    def dev(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def maxdiff(got, want):
        return float((got.float() - want.float()).abs().max())

    def attend(q, k, v, add):
        # the reference: softmax(q k^T / sqrt(d) + add) v in f32 over
        # (b, h, t, d), merged back to (b, t, h * d)
        s = q.float() @ k.float().transpose(-1, -2) * q.shape[-1] ** -0.5
        ctx = torch.softmax(s + add, dim=-1) @ v.float()
        return ctx.transpose(1, 2).flatten(2)

    reset_launch_counts()
    # 1) kernel B, the denoiser's packed attention with the rel-pos bias:
    # per-head interleaved qkv, (h, t, t) bias from the bucket table
    b, h, t, d = 2, 16, 512, 64
    qkv = dev(rng.normal(0, 1, (b, t, 3 * h * d)), torch.float32).bfloat16()
    table = dev(rng.normal(0, 0.1, (32, h)), torch.float32)
    valid = dev(np.arange(t)[None, :] < np.array([t - 40, t])[:, None])
    key_mask = torch.where(valid, 0.0, float("-inf"))[:, None, None, :]
    got = fa.flash_attention_packed(qkv, h, valid, bias_table=table)
    q5 = qkv.reshape(b, t, h, 3, d).permute(3, 0, 2, 1, 4)
    bias = relpos_bias(table, dev(relative_position_buckets(t, 32, 64)))
    want = attend(q5[0], q5[1], q5[2], bias[None] + key_mask)
    out["packed_flash_maxdiff"] = maxdiff(got, want)

    # 2) kernel C, the causal AR prefill/latent attention: part-major qkv
    # ([all q | all k | all v])
    got = fa.flash_attention_causal_qkv(qkv, h, valid)
    qp = qkv.reshape(b, t, 3, h, d).permute(2, 0, 3, 1, 4)
    causal = torch.full((t, t), float("-inf"), device=device).triu(1)
    want = attend(qp[0], qp[1], qp[2], causal + key_mask)
    out["causal_flash_maxdiff"] = maxdiff(got, want)

    # 3) kernel A, the int8 decode step, against the per-layer decode
    cfg = ARConfig(n_layer=2, cache_len=256, n_mel_vocab=1024,
                   n_text_vocab=64, n_text_pos=32, fused_decode=True,
                   start_mel_token=1022, stop_mel_token=1023)
    params = cast_matmul_weights(random_ar_params(cfg, seed=1, fast=True),
                                 torch.bfloat16, int8=True, device=device)
    text = dev(rng.integers(0, 64, (2, 12)), torch.long)
    tvalid = torch.ones((2, 12), dtype=torch.bool, device=device)
    vc = dev(rng.normal(0, 0.5, (cfg.d_model,)), torch.float32)
    _, cache = ar.prefill(params, cfg, text, tvalid, vc, torch.bfloat16)
    toks = torch.tensor([3, 5], dtype=torch.long, device=device)

    def step(c):
        # decode_step writes its slot in place: each plane gets a copy
        fresh = ar.KVCache(cache.k.clone(), cache.v.clone(),
                           cache.valid.clone(), cache.length)
        return ar.decode_step(params, c, fresh, toks, 0, torch.bfloat16)

    l_fused, c_fused = step(cfg)
    l_plain, c_plain = step(dataclasses.replace(cfg, fused_decode=False))
    out["decode_trunk_logits_maxdiff"] = maxdiff(l_fused, l_plain)
    out["decode_trunk_kv_maxdiff"] = maxdiff(c_fused.k, c_plain.k)
    counts = launch_counts()
    out["launches"] = {k: counts[k] for k in CHECKED_KERNELS}

    # the JAX bench's limits (~10x the bf16 spread it saw on the TPU); a
    # B without its bias or its key mask lands past its limit
    limits = {"packed_flash_maxdiff": 0.2, "causal_flash_maxdiff": 0.2,
              "decode_trunk_logits_maxdiff": 0.5,
              "decode_trunk_kv_maxdiff": 0.2}
    out["ok"] = (all(out[k] <= v for k, v in limits.items())
                 and all(out["launches"][k] > 0 for k in CHECKED_KERNELS))
    return out


def roofline_stats(models, result, use_bf16: bool,
                   int8: bool = False) -> dict:
    """ms/step and roofline shares of the two hot stages, with the JAX
    bench's byte and FLOP counts over the H100's peaks.

    AR decode is weight-streaming (HBM) bound: one step reads every
    matmul weight and the whole KV cache once; its share is that
    streaming time over the measured decode-loop ms/step. Diffusion is
    matmul bound: the analytic FLOPs of one CFG (batch-2) denoiser eval
    over the peak, per measured step."""
    from tortoise_tpu_torch.pipeline.ar_stage import pick_bucket, size_cache

    acfg, dcfg = models.ar_cfg, models.diffusion_cfg
    wbytes = 1 if int8 else (2 if use_bf16 else 4)
    d = acfg.d_model
    per_layer = d * 3 * d + d * d + d * 4 * d + 4 * d * d
    ar_bytes = (acfg.n_layer * per_layer + acfg.n_mel_vocab * d) * wbytes
    # the KV cache (k and v), sized to the text bucket as the stage does
    c = size_cache(acfg, pick_bucket(len(result.tokens))).cache_len
    cache_bytes = acfg.n_layer * c * d * 2 * (2 if use_bf16 else 4)
    # the denominator is the decode loop's wall from the stage-synced
    # split (prefill and the latent pass are batch passes, not weight
    # streaming); without the split the step count is unknown: null
    if "ar_decode_loop_s" in result.timings:
        n_steps = max(int(result.timings["ar_decode_steps"]), 1)
        ar_ms = result.timings["ar_decode_loop_s"] * 1e3 / n_steps
    else:
        ar_ms = None
    ar_floor_ms = (ar_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3

    if result.mel is not None:
        t = result.mel.shape[-1]
    else:
        # audio = (t + pad_frames) * upsample - 6 samples
        vcfg = models.vocoder_cfg
        t = ((len(result.audio) + 6) // vcfg.total_upsample
             - vcfg.mel_pad_frames)
    dd = dcfg.d_model
    res_flops = 2 * t * (dd * dd + 3 * dd * dd)        # k1 + k3 convs
    attn_flops = 2 * t * (dd * 3 * dd + dd * dd) + 4 * t * t * dd
    n_attn = dcfg.n_main_layers + dcfg.n_integrator_layers
    n_res = n_attn + dcfg.n_tail_resblocks
    eval_flops = 2 * (n_res * res_flops + n_attn * attn_flops)  # CFG batch 2
    diff_s = result.timings["diffusion_s"] / dcfg.n_sample_timesteps
    peak = BF16_FLOPS if use_bf16 else F32_FLOPS
    return {
        "ar_ms_per_step": None if ar_ms is None else round(ar_ms, 3),
        "ar_hbm_roofline_pct": None if ar_ms is None else round(
            100 * ar_floor_ms / max(ar_ms, 1e-9), 1),
        "diffusion_ms_per_cfg_step": round(diff_s * 1e3, 2),
        "diffusion_mfu_pct": round(
            100 * eval_flops / max(diff_s, 1e-9) / peak, 1),
    }


def _smi_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return (out.stdout.strip().splitlines() or [out.stderr.strip()])[0]


def _upload(models, compute_dtype, int8, device) -> float:
    """The warm-start child's upload: the trees onto the card and the AR
    and diffusion casts of the plane, up to a device sync; seconds."""
    from tortoise_tpu_torch.pipeline import diffusion_stage, vocoder_stage
    from tortoise_tpu_torch.pipeline.ar_stage import cast_matmul_weights

    t0 = time.monotonic()
    models.to_device(include_ar=False, include_diffusion=not int8,
                     device=device)
    diffusion_stage._prepare_params(models.diffusion_params, int8, device)
    if int8:
        cast_matmul_weights(models.ar_params, compute_dtype, int8=True,
                            device=device)
    vocoder_stage.device_params(models.vocoder_params, device)
    sync(device)
    return time.monotonic() - t0


def main() -> int:
    small = os.environ.get("BENCH_SMALL") == "1"
    use_bf16 = os.environ.get("BENCH_F32") != "1"
    child = os.environ.get("BENCH_CHILD") == "1"
    bench_t0 = time.monotonic()
    budget_s = float(os.environ.get("BENCH_BUDGET_S", "1500"))

    def remaining_s() -> float:
        return budget_s - (time.monotonic() - bench_t0)

    from tortoise_tpu_torch.pipeline.synthesize import (
        synthesize,
        synthesize_batch,
    )

    device = resolve_device(os.environ.get("BENCH_DEVICE") or None)
    on_card = device.type == "cuda"
    compute_dtype = torch.bfloat16 if use_bf16 else None
    if on_card and not use_bf16:
        # the f32 plane: true f32 products in cuBLAS and cuDNN
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    # int8 AR + denoiser matmul weights on the bf16 plane: the production
    # plane
    int8 = use_bf16

    t_build0 = time.monotonic()
    models, models_f32 = build_models(small, use_bf16, int8, device)
    build_s = time.monotonic() - t_build0
    plane_cache_hit = int8 and models_f32 is None
    if child:
        upload_s = _upload(models, compute_dtype, int8, device)

    rng = np.random.default_rng(0)
    # wrapped text: id 255, 24 random ids, 0; the tiny configs take 255
    # clamped into their vocab and as many ids as their 24 text positions
    # hold (the JAX bench reads past its tiny position table there)
    start_tok = min(255, models.ar_cfg.n_text_vocab - 1)
    max_ids = models.ar_cfg.n_text_pos - 2

    def text(n):
        return [start_tok] + rng.integers(
            3, models.ar_cfg.n_text_vocab, size=min(n, max_ids)
        ).tolist() + [0]

    tokens = text(24)
    voice = rng.normal(0, 0.5, (models.ar_cfg.d_model,)).astype(np.float32)

    def run(seed, stage_sync=False, int8_weights=int8, on=models):
        t0 = time.monotonic()
        result = synthesize(on, tokens=tokens, voice=voice, seed=seed,
                            batch_size=1, sampler="jax",
                            compute_dtype=compute_dtype,
                            int8_weights=int8_weights,
                            stage_sync=stage_sync, materialize=False,
                            device=device)
        return result, time.monotonic() - t0

    # warmup: on the card the first call builds the kernels into _build/
    # (when not built yet) and makes the weight casts
    _, compile_wall = run(0)

    if child:
        # the warm start: this fresh process's first-run wall (plane load
        # and upload timed apart above) and one steady pass; printed
        # progressively so the parent can read the first line if the
        # steady pass outlives its timeout
        probe = {"first_run_s": round(compile_wall, 3),
                 "steady_run_s": None,
                 "weights_build_s": round(build_s, 3),
                 "upload_s": round(upload_s, 3),
                 "plane_cache_hit": plane_cache_hit}
        print(json.dumps(probe), flush=True)
        _, steady = run(1)
        probe["steady_run_s"] = round(steady, 3)
        print(json.dumps(probe), flush=True)
        return 0

    kc = None
    if on_card:
        try:
            kc = kernel_selfcheck(device)
        except Exception as e:
            traceback.print_exc()
            kc = {"ok": False, "error": f"{type(e).__name__}: {e}"[:300]}
        print(json.dumps({"kernel_check": kc}), file=sys.stderr, flush=True)

    n_timed = 1 if small else int(os.environ.get("BENCH_REPS", "3"))
    runs = []
    for i in range(n_timed):
        reset_launch_counts()
        runs.append(run(1 + i))
        if i == 0:
            launches = {"core": launch_counts()}
    result, wall = min(runs, key=lambda rw: rw[1])

    # the stage split comes from stage-synced passes, with their own wall
    # (sync_wall_s), held to the async wall by checked_sync
    def run_sync():
        res, w = run(1, stage_sync=True)
        return res.timings, w, res

    _, sync_tim, sync_wall, sync_meta = checked_sync(run_sync,
                                                     ref_wall=wall)
    result = dataclasses.replace(result, timings=sync_tim)

    audio_s = len(result.audio) / result.sample_rate
    rtf = wall / max(audio_s, 1e-9)
    line = {
        "metric": "rtf",
        "value": round(rtf, 5),
        "unit": "wall_s_per_audio_s",
        "rtf": round(rtf, 5),
        "audio_s": round(audio_s, 3),
        "wall_s": round(wall, 3),
        "first_run_s": round(compile_wall, 3),
        # seconds-valued entries only (ar_decode_steps is a count)
        "stages_s": {k: round(v, 3) for k, v in result.timings.items()
                     if k.endswith("_s")},
        "ar_decode_steps": int(result.timings.get("ar_decode_steps", 0)),
        "sync_wall_s": round(sync_wall, 3),
        "device": (torch.cuda.get_device_name(device) if on_card
                   else str(device)),
        "bf16": use_bf16,
    }
    if on_card:
        line["nvidia_smi"] = _smi_line()
    line.update(sync_meta)
    line["int8_weights"] = int8
    line["weights_build_s"] = round(build_s, 3)
    line["plane_cache_hit"] = plane_cache_hit
    if kc is not None:
        line["kernel_check"] = kc
    line.update(roofline_stats(models, result, use_bf16, int8))
    line["kernel_launches"] = launches

    skipped_sections = []

    def emit():
        # the last JSON line wins: each section prints the richer line
        if skipped_sections:
            line["bench_sections_skipped"] = skipped_sections
        line["bench_elapsed_s"] = round(time.monotonic() - bench_t0, 1)
        print(json.dumps(line), flush=True)

    def section_fits(name: str, est_s: float) -> bool:
        if remaining_s() >= est_s:
            return True
        skipped_sections.append(name)
        print(f"bench budget low ({remaining_s():.0f}s left), skipping "
              f"{name} (~{est_s:.0f}s)", file=sys.stderr, flush=True)
        return False

    emit()  # the core numbers are out from here on

    def section(where, name, fn, *args) -> bool:
        """Run one section; a failure puts ``{"error": ...}`` at
        ``where[name]`` and prints the line."""
        try:
            fn(*args)
            return True
        except Exception as e:
            traceback.print_exc()
            where[name] = {"error": f"{type(e).__name__}: {e}"[:500]}
            emit()
            return False

    def streaming():
        from tortoise_tpu_torch.pipeline.streaming import stream_synthesize

        def run_stream(seed):
            t0 = time.monotonic()
            first = None
            n_samples = n_chunks = 0
            # a small first window: the first audio waits for its loop
            for chunk in stream_synthesize(
                    models, tokens=tokens, voice=voice, seed=seed,
                    compute_dtype=compute_dtype, int8_weights=int8,
                    first_window_frames=None if small else 96,
                    device=device):
                if first is None:
                    first = chunk.latency_s
                n_samples += len(chunk.audio)
                n_chunks += 1
            return first, time.monotonic() - t0, n_samples, n_chunks

        run_stream(1)  # warmup pass
        reset_launch_counts()
        sfirst, swall, s_samples, s_chunks = run_stream(1)
        launches["streaming"] = launch_counts()
        s_audio = s_samples / result.sample_rate
        line["streaming"] = {
            "first_audio_s": round(sfirst, 3),
            "wall_s": round(swall, 3),
            "audio_s": round(s_audio, 3),
            "rtf": round(swall / max(s_audio, 1e-9), 5),
            "chunks": s_chunks,
        }
        emit()

    def batched(bsz):
        tlists = [text(18 + 3 * (i % 6)) for i in range(bsz)]

        def run_batch(seed, stage_sync=False):
            t0 = time.monotonic()
            rs = synthesize_batch(
                models, tokens_list=tlists, voices=voice, seed=seed,
                compute_dtype=compute_dtype, int8_weights=int8,
                stage_sync=stage_sync, materialize=False, device=device)
            return rs, time.monotonic() - t0

        _, bwarm = run_batch(0)
        # best of two timed passes of the same work
        reset_launch_counts()
        rs, bwall = run_batch(1)
        launches[f"batched.{bsz}"] = launch_counts()
        if remaining_s() > 2.5 * bwall:
            rs2, bwall2 = run_batch(1)
            if bwall2 < bwall:
                rs, bwall = rs2, bwall2

        def run_batch_sync():
            bres, w = run_batch(1, stage_sync=True)
            return bres[0].timings, w, bres

        _, btim, bsync_wall, bsync_meta = checked_sync(
            run_batch_sync, ref_wall=bwall)
        btotal = sum(len(r.audio) / r.sample_rate for r in rs)
        line["batched"][str(bsz)] = {
            "batch": bsz,
            "wall_s": round(bwall, 3),
            "audio_s_total": round(btotal, 3),
            "aggregate_rtf": round(bwall / max(btotal, 1e-9), 5),
            "first_run_s": round(bwarm, 3),
            "stages_s": {k: round(v, 3) for k, v in btim.items()
                         if k.endswith("_s")},
            "sync_wall_s": round(bsync_wall, 3),
            **bsync_meta,
        }
        emit()

    def alt_plane():
        from tortoise_tpu_torch.pipeline.common import clear_cast_cache
        from tortoise_tpu_torch.pipeline.synthesize import TortoiseModels

        # the headline plane's casts go first: three AR planes at once
        # (f32 source, int8, bf16) is what ran the JAX bench out of memory
        clear_cast_cache()
        alt = models_f32
        if alt is None:  # the plane cache served the headline run
            alt = TortoiseModels.random(seed=0, tiny=small,
                                        cache_dir=weights_dir(small))
        # the same configs as the headline run (flash, small-mode cuts)
        alt.ar_cfg = models.ar_cfg
        alt.diffusion_cfg = models.diffusion_cfg
        alt.vocoder_cfg = models.vocoder_cfg
        alt_runs = []
        for i in range(2):
            reset_launch_counts()
            alt_runs.append(run(1 + i, int8_weights=False, on=alt))
            if i == 0:
                launches["bf16_weights_path"] = launch_counts()
        res, alt_wall = min(alt_runs, key=lambda rw: rw[1])
        alt_sync, _ = run(1, stage_sync=True, int8_weights=False, on=alt)
        res = dataclasses.replace(res, timings=alt_sync.timings)
        alt_audio = len(res.audio) / res.sample_rate
        stats = roofline_stats(models, res, use_bf16, int8=False)
        line["bf16_weights_path"] = {
            "rtf": round(alt_wall / max(alt_audio, 1e-9), 5),
            "wall_s": round(alt_wall, 3),
            "ar_ms_per_step": stats["ar_ms_per_step"],
            "ar_hbm_roofline_pct": stats["ar_hbm_roofline_pct"],
        }
        emit()

    def warmstart():
        # a fresh process on the plane this one wrote: its first-run wall
        # is the restart cost (imports, plane load, upload, first casts);
        # ``-m`` from ROOT finds the package there
        env = dict(os.environ, BENCH_CHILD="1")
        out = subprocess.run(
            [sys.executable, "-m", "tortoise_tpu_torch.bench"], env=env,
            cwd=ROOT, capture_output=True, text=True,
            timeout=max(60.0, min(900.0, remaining_s())))
        if out.returncode != 0:
            raise RuntimeError(f"the child exited {out.returncode}: "
                               f"{out.stderr[-1500:]}")
        probe = json.loads(out.stdout.strip().splitlines()[-1])
        line["second_process_first_run_s"] = probe["first_run_s"]
        line["second_process_steady_run_s"] = probe["steady_run_s"]
        line["second_process_weights_load_s"] = probe["weights_build_s"]
        line["second_process_upload_s"] = probe["upload_s"]
        line["second_process_plane_cache_hit"] = probe["plane_cache_hit"]
        emit()

    ok = True
    if section_fits("streaming", 180):
        ok = section(line, "streaming", streaming)
    if ok and not small:
        line["batched"] = {}
        for bsz in [int(b) for b in os.environ.get(
                "BENCH_BATCH_SIZES", "4,8,16").split(",") if b.strip()]:
            if not section_fits(f"batched.{bsz}", 150 + 6 * bsz):
                continue
            if not section(line["batched"], str(bsz), batched, bsz):
                ok = False
                break
    if (ok and not small and int8
            and os.environ.get("BENCH_ALT_PATH", "1") == "1"
            and section_fits("alt_weight_plane", 240)):
        ok = section(line, "bf16_weights_path", alt_plane)
    if ok and not small and section_fits("warmstart", 420):
        ok = section(line, "warmstart", warmstart)
    emit()
    if kc is not None and not kc["ok"]:
        print("kernel self-check failed", file=sys.stderr, flush=True)
        return 1
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
