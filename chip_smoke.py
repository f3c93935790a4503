#!/usr/bin/env python3
"""Smoke check of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure exits nonzero before the result line):

1. environment: torch/CUDA versions, nvcc, the card's name and power limit;
   TF32 is turned off for matmuls and cuDNN so f32 checks are true f32;
2. build: compiles ``tortoise_tpu_torch/csrc/*.cu`` for sm_90a;
3. kernels: each hand-written kernel (A decode trunk, B packed attention,
   C causal qkv attention, D1/D2 strided attention, E fused LVC, F int8
   packed attention) against its plain PyTorch version at the shapes the
   main paths give it, with the stated tolerance (2e-2 relative for bf16
   outputs, 1e-4 for f32 ones, 1e-5 of max |out| for the split-TF32 f32
   attention body; F's within one bf16 rounding of its plain version's
   f32 result, 1e-5 of max |out| in f32), and the time of both
   (CUDA
   events, after warm-up); D1 also against kernel B on one qkv, and B
   and C at head width 128 (B there timed with its plain version, SDPA
   and bound); the
   serving shapes: A on ragged rows at B = 4 and 16, B at a stream
   window (8, 384) and on a batch's ragged CFG rows; D1 at a ragged
   T = 1000 and on a server batch's 16 CFG rows; D2 in each of its modes
   (causal at the latent pass's (8, 16, 535, 64); the bucket bias, a
   materialized bias, Tq 256 x Tkv 1000 with the formula bias and causal
   with it at (2, 16, 1000, 64); timed against plain, SDPA and the bound)
   and again at head widths 16, 32 and 128; B and C at head width 16;
   the f32 attention body (flash_attention_bhtd.cu, split TF32 on the
   tensor cores; each case at 1e-5 of max |out|, timed against its plain
   version, SDPA in f32 and its bound, with the f32 FMA bound beside it):
   D2 causal at (8, 16, 535, 64) and D1 at (2, 32, 2176, 32) on views of
   a packed qkv, every other D2 mode at (2, 16, 1000, 64), D1 and D2 at
   head widths 16, 32 and 128, a batch row with no valid key (the mean
   of V) and 8192 keys;
   E per hop at L = 2208 and at a 32-frame chunk (timed), at a ragged L
   = 2186 and on two batch rows of stacked kernels; B and C on an f32 qkv
   (the split-TF32 body, the same checks: the denoiser's and the latent
   pass's shapes, head widths 16, 32 and 128, a row with no valid key);
   kernel F, the
   int8-score packed attention, at the A/B's (2, 2176) x 16 x 64 (all
   keys valid and a ragged row; timed beside its plain version, its
   quantize pass and its attention kernel each alone, kernel B on the
   same qkv, its bound and the design's floor), at head widths 32 and
   128 and on one head at 28,000 keys; kernel G, the denoiser's group
   norm with its chain, at (2, 2176, 1024) in 32 groups with 40 padded
   frames on both planes, as attn_norm and as res_out_norm (FiLM, SiLU),
   against its plain twin's f32 result (1e-5 of max |out| in f32, one
   bf16 rounding in bf16), two calls bit-equal, timed beside the twin,
   the eager chain it replaced and its byte bound; kernels Q8 and E8,
   the int8 product's row quantize and epilogue around the bf16 GEMM, at
   the denoiser's qkv, proj, integrating and res_out_conv shapes on bf16
   and f32 inputs, bit-equal to the eager chain, timed beside it and
   their byte bounds; then the A/B script
   scripts/torch_ubench_attn_int8_ab.py
   in a fresh process, whose launch counts of F and B must equal the
   calls it made (F's launches in the result line are that run's);
4. end to end at full production width (random weights, bf16 + int8
   unless named, stand-in tokens), eleven requests, each with the launch
   counts set to 0
   before it and read after it, each of which must launch kernel G
   (every request runs the denoiser): request 1 through the CLI at
   --batch-size 1 must launch kernels A, B, Q8 and E8, request 2 at
   --batch-size 8 must also launch kernel C (the latent pass); every
   request runs its
   sampling and denoising loops as CUDA graphs of one step
   (pipeline/graphs.py), whose replays the launch counts include; then
   the graph phase: synthesize() at request 1's settings on its weights,
   on the bf16 + int8, the bf16-weights and the f32 planes, with the
   loops eager and as graphs in turns (eager, graph, graph, eager), must
   give equal tokens, bit-equal mel and audio and equal launch counts
   (A, B and Bf among them), and prints each run's wall ms/step, RTF,
   peak memory, the graphs' capture times and the sampling and
   denoising loops' wall and busy ms/step alone (cut steps); request 3,
   synthesize() with the diffusion fallback config (32 heads of 32) and
   the fused LVC,
   must launch A, D1 and E (12 times) and not B; request 4, six
   concurrent POST /synthesize to the HTTP server, must form one batch
   padded to 8 and launch A, B and C; request 5, one POST /stream on the
   fused-LVC vocoder, must launch A, B and E and stream the one-shot
   length; request 6, a fresh process that memory-maps the int8 plane
   the parent wrote (io/plane_cache.py) and synthesizes at request 1's
   settings, must give request 1's tokens and audio (rel 1e-3; expect
   bit-equal) and launch A and B; the audio must be finite and of the
   vocoder's length for its mel. Then the parity runner's dry run: 3 SKIP
   and exit 0 without weights, exit 1 on a corrupt vocoder file. Then
   the port on a mesh (``parallel/``): request 7, one rank on NCCL
   (``make_mesh(1)``), synthesize_batch on request 4's texts over 8 rows
   with the mesh and without: equal sequences, bit-equal audio, kernels A,
   B and C; request 8, two ranks on the one card (gloo by name): (a) dp
   (2, 1) must launch A and B and not C on each rank and give request
   7's tokens (a parting is held to the firm-row rule and to the two
   batch shapes' logits), and bit for bit the tokens and audio of the
   mesh-less run of each rank's 4 rows with the global draws' rows;
   kernel A, splitting its work as for the whole batch, must give rows
   0-3 at B = 4 the bits they have at B = 8; the audio against request
   7's is printed beside each stage's part of the difference;
   (b) tp (1, 2), cut to 48 decode and 20 denoising steps (full widths):
   a prefill + decode_step and a denoiser eval within 2e-2 of one rank's,
   and a 2-row batch with finite audio of the vocoder's length that
   launches B and not A; request 9, the CLI on its default f32 plane (no
   --bf16, no --int8-weights) at request 1's settings, must launch kernel
   B on the split-TF32 body 1,044 times (REQUEST_B_LAUNCHES) and kernel
   G 3,685 times (REQUEST_G_LAUNCHES), beside the same request with
   --no-flash (no attention kernel, G as often) and one f32 denoiser eval
   with flash on and off (1e-4 of max |out|, both timed); request 10,
   the port's benchmark (``python -m tortoise_tpu_torch.bench``) in a
   fresh process with one timed pass, the batch of 8 and its warm-start
   child (BENCH_ENV), must exit 0 with rtf > 0, its kernel self-check
   ok, the streaming and batch-8 sections without an error, the child's
   first run on a plane-cache hit, and A, B and C launched, F not, in
   its sections' timed passes (their sum is request 10's count);
   request 11, the load test of scripts/torch_ubench_serve.py in this
   process on request 4's weights (8 Poisson arrivals at 2 a second,
   batches of up to 4 rows), must answer every request with finite
   latencies in at least 2 batches, an aggregate RTF above 0, and launch
   A and B;
5. the per-layer microbenchmarks: scripts 2-10 of
   scripts/torch_ubench_*.py in this process on the same weights at full
   width, reps and steps cut; they must run to their results with kernel
   A in decode on the int8 plane and not on the bf16-weights plane, C in
   the forced prefill and latent passes and not in the plain ones, B in
   the denoiser eval with flash on and no attention kernel with it off
   (G either way), E with use_pallas_lvc and none without, and the gn
   script's patch gone;
6. small-input agreement: the tiny f32 parity plane on the card against
   the same run on the CPU (same tokens, mel and audio within tolerance),
   on the default configs and on the fallback + fused-LVC configs; the
   stages' JAX flags: the AR stage with qkv_f16 (same tokens; on the
   bf16 + int8 kernel plane it must launch neither kernel A nor C, and
   the same call without it both) and the diffusion and vocoder stages
   with bucketed=False at a 39-frame mel on a 2-heads-of-64 denoiser
   (kernel B) and on the fallback + fused-LVC configs (D1 and E); then
   synthesize_batch (3 ragged rows) and stream_synthesize with the
   random draws of both runs from one numpy source.

The line before the last is ``{"kernels": [...]}`` (A-F, "Bf":
kernel B on an f32 qkv, the split-TF32 body, counted in request 9, and
G, which ports no Pallas kernel),
preceded by the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``. ``--profile`` instead profiles a
decode step and a diffusion step after phase 3 (device time by kernel,
idle share; traces under ``chiprun_out/``) and stops without a result
line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# stand-in wrapped text ids (255 ... 0), a 30-id prompt: text bucket 32,
# so the latent pass runs S = 1 + 32 + 502 = 535 positions
STANDIN_TOKENS = [255] + [(7 * i + 3) % 200 + 20 for i in range(28)] + [0]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int = 10, warmup: int = 2) -> float:
    """Device ms per call. The timed calls queue behind a ~30 ms device
    sleep, so the events read the device's time and not the host's
    enqueue rate (a wrapper's Python costs more than a small kernel)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(torch, got, want) -> tuple:
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        return float("inf"), float("inf")
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1e-30)


# published peaks of one H100 SXM (NVIDIA's data sheet; dense rates) and
# the MUFU's exp rate: 132 SMs x 16 exp2 a clock x 1.98 GHz boost clock
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12
INT8_OPS = 1979e12
MUFU_EXPS = 132 * 16 * 1.98e9


def nbytes(*xs) -> int:
    """Bytes of every tensor in xs (nested tuples, lists and dicts)."""
    total = 0
    for x in xs:
        if isinstance(x, dict):
            total += nbytes(*x.values())
        elif isinstance(x, (tuple, list)):
            total += nbytes(*x)
        elif hasattr(x, "element_size"):
            total += x.numel() * x.element_size()
    return total


def bound(n_bytes, flops=0.0, flop_rate=BF16_FLOPS, exps=0.0) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations (tensor-core or f32 FLOPs, exps)
    over their peak rate."""
    parts = {"bytes": n_bytes / HBM_BYTES_PER_S,
             "flops": flops / flop_rate, "exps": exps / MUFU_EXPS}
    by = max(parts, key=parts.get)
    print(f"    bound: {n_bytes / 1e6:.1f} MB -> {parts['bytes'] * 1e3:.4f} "
          f"ms; {flops / 1e9:.2f} GFLOP -> {parts['flops'] * 1e3:.4f} ms; "
          f"{exps / 1e6:.1f} M exps -> {parts['exps'] * 1e3:.4f} ms")
    return dict(bound_ms=parts[by] * 1e3,
                bound_by="bytes" if by == "bytes" else "operations")


def sdpa_ms(torch, q, k, v, add, label) -> float:
    """The one PyTorch call that computes an attention kernel's function:
    scaled_dot_product_attention on the same (B, H, T, D) views with the
    bias, key mask and causal mask pre-built as one float attn_mask
    outside the timed region. Times it as the kernels are timed and
    prints the backend it ran (the kernels a profiled call launched)."""
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    mask = add.to(q.dtype)

    def call():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA})
    ms = cuda_ms(torch, call)
    print(f"  {label} SDPA (float attn_mask {tuple(mask.shape)}): {ms:.3f} "
          f"ms; kernels {[n[:70] for n in names]}")
    del mask
    return ms


# Phase 3's attention and LVC shapes and inputs, which
# scripts/torch_kernel_times.py times as well.
# B: (b, t, valid length of row 1 or None), 16 heads of 64; the first timed
# (2B CFG rows, T, a ragged row's length, heads of 64): 16 heads at full
# width; 8 and 4 are a tp rank's local heads at tp = 2 (request 8(b)) and 4
B_CASES = ((2, 2176, None, 16), (2, 1000, 937, 16), (8, 384, None, 16),
           (8, 2176, 1813, 16), (4, 2176, 1813, 8), (4, 2176, None, 4))
C_SHAPE = (8, 16, 535)  # (b, heads, S): the AR latent pass at batch 8
# D1: (b, t, heads, head width, key masks), timed at head width 32
D1_CASES = ((2, 2176, 32, 32, (None, 1900)), (2, 1000, 32, 32, (937,)),
            (16, 1000, 32, 32, ("ragged",)), (2, 2176, 16, 64, (None,)))
WIDE = ((2, 2176), (8, 535))  # (b, t) of B and C at 8 heads of 128
# D2 at head width 64: (mode, b, heads, Tq, Tkv); the first is the result
# line's (the AR latent pass's shape at batch 8, causal with a key mask)
D2_CASES = (("causal", 8, 16, 535, 535), ("buckets", 2, 16, 1000, 1000),
            ("materialized", 2, 16, 1000, 1000),
            ("unequal", 2, 16, 256, 1000),
            ("causal_formula", 2, 16, 1000, 1000))
D2_WIDTHS = (16, 32, 128)  # every mode again at 4 heads of these widths
# f32 inputs on flash_attention_bhtd.cu's split-TF32 body: (route, b,
# heads, T, D) on views of a packed qkv; then every D2_CASES mode but the
# first in f32, every route at head widths F32_WIDTHS (1024 / d heads: B,
# D1 and D2 at (2, 1000), C at C_SHAPE's (8, 535)), a row with no valid
# key, and F32_LONG's (b, heads, Tq, Tkv) at width 64, past what a
# whole-Tkv window in shared memory could hold
FMA_CASES = (("D2", 8, 16, 535, 64), ("D1", 2, 32, 2176, 32))
F32_WIDTHS = (16, 32, 128)
F32_LONG = (2, 16, 256, 8192)
F32_TOL = 1e-5  # the split-TF32 body against its plain version
# E: (L, batch rows) at each hop: 500 latents' 2208 bucket, a stream
# chunk, the ragged 2186 frames, then two batch rows
E_CASES = ((2208, 1), (32, 1), (2186, 1), (2208, 2), (32, 2))
E_HOPS = (8, 64, 256)
# F: the A/B's (b, t, heads, head width) and row 1's valid length in its
# ragged case; the other head widths at (2, 300) x 4 heads
F_SHAPE = (2, 2176, 16, 64)
F_RAGGED = 1813
F_WIDTHS = (32, 128)
# one head at a length whose bias window and key mask the first design
# could not stage in a block (it took at most 26,368 padded keys at width
# 64)
F_LONG = 28000
# G: the denoiser's CFG map (b, t, channels, groups), its last 40 frames
# padded, on both planes; the chains of attn_norm (mask only) and
# res_out_norm (mask, FiLM, SiLU); the first of each plane is timed
G_SHAPE = (2, 2176, 1024, 32)
G_PADDED = 40
G_CHAINS = (("res_out_norm", "rows", True), ("attn_norm", None, False))
# Q8 and E8: the int8 denoiser's products at G_SHAPE's rows, the same 40
# padded frames: (name, K, N, padding) of qkv, proj (and res_in_conv),
# the integrating product and res_out_conv; the second is timed into the
# result line
I8_CASES = (("qkv", 1024, 3072, 0), ("proj", 1024, 1024, 0),
            ("integrating", 2048, 1024, 0), ("res_out_conv", 1024, 1024, 1))


def bf16_qkv(torch, g, b, t, h, d):
    return torch.randn((b, t, 3 * h * d), generator=g,
                       device="cuda").to(torch.bfloat16)


def views(qkv, h, d):
    """(B, H, T, D) q, k, v views of a per-head-interleaved qkv."""
    b, t, _ = qkv.shape
    x = qkv.view(b, t, h, 3, d)
    return tuple(x[:, :, :, p].transpose(1, 2) for p in range(3))


def d2_inputs(torch, g, mode, b, h, tq, tkv, d=64, dtype=None):
    """q (B, H, Tq, D), k and v (B, H, Tkv, D) in bf16 (or ``dtype``) and
    flash_attention's keywords for one D2 case: "causal" (the latent
    pass's key mask: two padded text slots), "buckets" (bucket ids and a
    table), "materialized" (an (H, Tq, Tkv) f32 bias), "unequal" (the
    formula bias at Tq != Tkv), "causal_formula" (causal with the formula
    bias); all but "causal" with the last row's keys cut 63 short."""
    from tortoise_tpu_torch.ops.relpos import relative_position_buckets

    dev = torch.device("cuda")
    dtype = torch.bfloat16 if dtype is None else dtype
    q = torch.randn((b, h, tq, d), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((b, h, tkv, d), generator=g, device=dev).to(dtype)
            for _ in range(2))
    table = torch.randn((32, h), generator=g, device=dev) * 0.3
    if mode == "causal":
        valid = torch.ones((b, tkv), dtype=torch.bool, device=dev)
        valid[:, 1 + 30:1 + 32] = False
    else:
        lens = torch.tensor([tkv] * (b - 1) + [tkv - 63], device=dev)
        valid = torch.arange(tkv, device=dev)[None, :] < lens[:, None]
    kw = dict(kv_valid=valid, causal=mode.startswith("causal"))
    if mode == "buckets":
        kw.update(bias_buckets=torch.as_tensor(
            relative_position_buckets(tq), device=dev), bias_table=table)
    elif mode == "materialized":
        kw["bias"] = torch.randn((h, tq, tkv), generator=g, device=dev)
    elif mode in ("unequal", "causal_formula"):
        kw.update(bias_table=table, bias_formula=True)
    return q, k, v, kw


def attention_add(torch, K, q, k, kw):
    """(the bias, key mask and causal mask of one flash_attention call as
    one additive (B, H, Tq, Tkv) f32 tensor for SDPA, the Toeplitz vector
    or None, the materialized bias or None)."""
    tq, tkv = q.shape[2], k.shape[2]
    vec, full, _ = K._bias_args(q, k, kw.get("bias"), kw["causal"],
                                kw.get("bias_buckets"), kw.get("bias_table"),
                                8.0, kw.get("bias_formula", False), 64)
    add = torch.zeros((), device=q.device)
    if kw["kv_valid"] is not None:
        add = K._additive_mask(kw["kv_valid"])[:, None, None, :]
    if vec is not None:
        add = add + K._toeplitz_full(vec, tq, tkv)[None]
    if full is not None:
        add = add + full[None]
    if kw["causal"]:
        add = add + K._causal_add(tq, tkv, q.device)
    return add, vec, full


def attention_pairs(b, h, tq, tkv, causal) -> float:
    """(query, key) pairs a call scores: under the top-left diagonal when
    causal (row i sees min(i + 1, Tkv) keys)."""
    if not causal:
        return float(b * h * tq * tkv)
    n = min(tq, tkv)
    return float(b * h * (n * (n + 1) // 2 + (tq - n) * tkv))


def lvc_inputs(torch, g, b, L, hop):
    """Kernel E's arguments for one conv block of b rows at the vocoder's
    widths (32 channels in and gated): x, the block's kernel as the
    vocoder passes it (a [:, 1] slice of the 4 blocks' stacked kernels,
    so rows lie the stack's batch stride apart), bias, residual, hop."""
    t = L * hop
    stacked = torch.randn((b, 4, 32, 64, 3, L), generator=g,
                          device="cuda") * 0.1
    return (torch.randn((b, 32, t), generator=g, device="cuda"),
            stacked[:, 1], torch.randn((b, 64, L), generator=g,
                                       device="cuda"),
            torch.randn((b, 32, t), generator=g, device="cuda"), hop)


def gn_inputs(torch, g, dtype, film):
    """Kernel G's arguments at G_SHAPE: (x, groups, w, b, eps, mask) and
    the keywords (film, silu) of one of G_CHAINS' FiLM forms."""
    b, t, c, groups = G_SHAPE
    dev = torch.device("cuda")
    x = (torch.randn((b, t, c), generator=g, device=dev) * 1.7 + 0.3).to(
        dtype)
    w = 1 + 0.2 * torch.randn(c, generator=g, device=dev)
    bias = 0.2 * torch.randn(c, generator=g, device=dev)
    mask = torch.arange(t, device=dev)[None, :].expand(b, t) < t - G_PADDED
    pair = None
    if film is not None:
        pair = tuple((0.5 * torch.randn((b, c), generator=g, device=dev))
                     .to(dtype) for _ in range(2))
    return (x, groups, w, bias, 1e-5, mask), pair


def gn_eager_chain(torch, x, groups, w, bias, eps, mask, film, silu):
    """What kernel G replaced in models/diffusion.py: ops.basic's
    group_norm_tc, then FiLM, SiLU and the mask as eager ops in x's
    dtype."""
    import torch.nn.functional as F

    from tortoise_tpu_torch.ops.basic import group_norm_tc

    y = group_norm_tc(x, groups, w, bias, eps, mask=mask,
                      fast=x.dtype == torch.bfloat16)
    if film is not None:
        scale, shift = film
        y = y * (1.0 + scale)[:, None, :] + shift[:, None, :]
    if silu:
        y = torch.where(mask[:, :, None], F.silu(y),
                        torch.zeros((), dtype=y.dtype, device=y.device))
    return y


def _kernel_a_weights(torch):
    """Random production-width kernel-A weights: 30 layers, D=1024, H=16,
    F=4096, Vp=8320 (8194 real logits)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    L, D, F, V, VP = 30, 1024, 4096, 8194, 8320

    def rn(*shape, s=1.0):
        return torch.randn(shape, generator=g, device=dev) * s

    def q8(k_in, n_out):
        wq = torch.randint(-127, 128, (L, k_in, n_out), generator=g,
                           device=dev, dtype=torch.int8)
        return wq, (torch.rand((L, 1, n_out), generator=g, device=dev)
                    * 0.5 + 0.5) * (1.5 / (127 * k_in ** 0.5))

    blocks = {
        "ln1_w": 1 + rn(L, D, s=0.1), "ln1_b": rn(L, D, s=0.1),
        "attn_w": q8(D, 3 * D), "attn_b": rn(L, 3 * D, s=0.1),
        "proj_w": q8(D, D), "proj_b": rn(L, D, s=0.1),
        "ln2_w": 1 + rn(L, D, s=0.1), "ln2_b": rn(L, D, s=0.1),
        "fc_w": q8(D, F), "fc_b": rn(L, F, s=0.1),
        "fc_proj_w": q8(F, D), "fc_proj_b": rn(L, D, s=0.1),
    }
    lm_b = torch.full((1, VP), -1e30, device=dev)
    lm_b[:, :V] = rn(1, V, s=0.1)
    head = {"ln_f_w": 1 + rn(1, D, s=0.1), "ln_f_b": rn(1, D, s=0.1),
            "lm_ln_w": 1 + rn(1, D, s=0.1), "lm_ln_b": rn(1, D, s=0.1),
            "lm_wq": torch.randint(-127, 128, (D, VP), generator=g,
                                   device=dev, dtype=torch.int8),
            "lm_sc": torch.full((1, VP), 4.0 / (127 * 32), device=dev),
            "lm_b": lm_b}
    return blocks, head, g


def _kernel_a_inputs(torch, b, weights=None):
    """(blocks, cache_k, cache_v, bias_row, x, kwargs) for one decode step
    of b rows over a C=640-slot cache (a 32-token bucket's size_cache)
    holding 300 valid slots in every row, with the head and the default
    sampler."""
    blocks, head, g = weights or _kernel_a_weights(torch)
    dev = torch.device("cuda")
    L, D, C, V = 30, 1024, 640, 8194
    ck = torch.randn((L, b, C, D), generator=g, device=dev).bfloat16()
    cv = torch.randn((L, b, C, D), generator=g, device=dev).bfloat16()
    bias_row = torch.full((b, C), -1e30, device=dev)
    bias_row[:, :300] = 0.0
    x = torch.randn((b, D), generator=g, device=dev)
    prev = torch.randint(0, V, (b, 1), generator=g, device=dev,
                         dtype=torch.int32)
    u = torch.rand((b, 1), generator=g, device=dev)
    kw = dict(head=head, prev_u=(prev, u), sampler=(0.8, 50, 0.2, 2.0))
    return blocks, ck, cv, bias_row, x, kw


def _mid_step_u(torch, logits, prev, u, sampler):
    """Per row, the middle of the step of the sampler's CDF (over its
    kept top-k candidates) that ``u`` falls on: a draw there picks the
    same token under small logit differences."""
    from tortoise_tpu_torch.ops.sampling import process_logits_topk

    probs, _ = process_logits_topk(logits.float(), prev, *sampler)
    cum = torch.cumsum(probs, dim=-1)
    pos = torch.clamp((cum < u).sum(dim=-1, keepdim=True),
                      max=probs.shape[-1] - 1)
    hi = torch.gather(cum, -1, pos)
    lo = torch.where(pos > 0, torch.gather(cum, -1, (pos - 1).clamp(min=0)),
                     0.0)
    return ((lo + hi) / 2).float()


def _cdf_gaps(torch, logits, prev, u, sampler) -> list:
    """Per row, how far ``u`` lies from the nearest edge of the step of
    the sampler's CDF it falls on: a token check at ``u`` holds under
    logit differences that move the CDF by less than this."""
    from tortoise_tpu_torch.ops.sampling import process_logits_topk

    probs, _ = process_logits_topk(logits.float(), prev, *sampler)
    cum = torch.cumsum(probs, dim=-1)
    pos = torch.clamp((cum < u).sum(dim=-1, keepdim=True),
                      max=probs.shape[-1] - 1)
    hi = torch.gather(cum, -1, pos)
    lo = torch.where(pos > 0, torch.gather(cum, -1, (pos - 1).clamp(min=0)),
                     0.0)
    return torch.minimum(u - lo, hi - u).flatten().tolist()


def _firm_rows(torch, K, logits, prev, u, sampler, noise, trials=16):
    """(B,) bool: rows whose plain draw at ``u`` keeps its token when the
    logits get Gaussian noise of std ``noise`` (``trials`` draws)."""
    g = torch.Generator(device=logits.device).manual_seed(7)
    want = K.sample_plain(logits, prev, u, sampler)
    firm = torch.ones_like(want, dtype=torch.bool)
    for _ in range(trials):
        shaken = logits + noise * torch.randn(
            logits.shape, generator=g, device=logits.device)
        firm &= K.sample_plain(shaken, prev, u, sampler) == want
    return firm[:, 0]


def _check_firm_tokens(torch, K, args, kw, got, want, label):
    """Tokens of a ragged batch: the two paths' logits differ within
    tolerance, and a draw near the edge of a CDF step, the top-k cut or
    the nucleus cut flips on a ~1e-2 logit difference. So both paths draw
    at the middle of each row's step of the plain CDF, and must pick the
    same token on every row whose plain draw holds under Gaussian logit
    noise of twice the paths' RMS difference, with at least max(1, b // 2)
    such rows."""
    V, b = 8194, args[4].shape[0]
    prev, u = kw["prev_u"]
    mid_u = _mid_step_u(torch, want[3], prev, u, kw["sampler"])
    mid = dict(kw, prev_u=(prev, mid_u))
    tok_k = K.fused_decode_trunk(*args, **mid)[4]
    tok_p = K.fused_decode_trunk_plain(*args, **mid)[4]
    rms = float((got[3][:, :V] - want[3][:, :V]).float().pow(2).mean()
                .sqrt())
    firm = _firm_rows(torch, K, want[3], prev, mid_u, kw["sampler"], 2 * rms)
    same = (tok_k == tok_p)[:, 0]
    print(f"  A {label} mid-step tokens kernel={tok_k[:, 0].tolist()} "
          f"plain={tok_p[:, 0].tolist()}; {int(firm.sum())} firm rows "
          f"(logit RMS diff {rms:.2e}), equal on {int(same.sum())} rows")
    if int(firm.sum()) < max(1, b // 2) or not bool(same[firm].all()):
        fail(f"kernel A tokens differ from the plain path on a firm row "
             f"({label}): {tok_k.tolist()} vs {tok_p.tolist()}, firm "
             f"{firm.tolist()}")


def check_kernel_a(torch, results):
    """Kernel A at production width, with and without the head + sampler.
    B in {1, 4} with 300 valid cache slots in every row: tokens at the
    raw uniforms must equal the plain path's. B in {4, 16} (16 is the
    largest server batch bucket) with ragged rows (300 - 7 * row slots,
    as in a server batch): tokens must equal the plain path's on the rows
    whose draw is firm (``_check_firm_tokens``). On every case the
    in-kernel sampler must equal the plain sampler on the kernel's own
    logits at the raw uniforms."""
    from tortoise_tpu_torch.ops.cuda import decode_trunk as K

    V, worst, tol = 8194, 0.0, 2e-2
    weights = _kernel_a_weights(torch)
    timing = None
    for b in (1, 4, 16):
        blocks, ck, cv, bias_row, x, full = _kernel_a_inputs(torch, b,
                                                             weights)
        prev, u = full["prev_u"]
        cases = []
        if b < 16:
            cases.append(("uniform", bias_row))
        if b > 1:
            ragged = torch.full_like(bias_row, -1e30)
            for i in range(b):
                ragged[i, :300 - 7 * i] = 0.0
            cases.append(("ragged", ragged))
        for layout, bias in cases:
            label = f"b={b} {layout}"
            args = (blocks, ck, cv, bias, x)
            for with_head in (False, True):
                kw = full if with_head else {}
                got = K.fused_decode_trunk(*args, **kw)
                want = K.fused_decode_trunk_plain(*args, **kw)
                torch.cuda.synchronize()
                names = ("hidden", "k_rows", "v_rows", "logits")
                # logits: the V real columns (the padded ones sit at -1e30)
                pairs = [(gt, wt) for gt, wt in zip(got[:4], want[:4])]
                if with_head:
                    pairs[3] = (got[3][:, :V], want[3][:, :V])
                for name, (gt, wt) in zip(names, pairs):
                    err, rel = rel_err(torch, gt, wt)
                    worst = max(worst, err)
                    print(f"  A {label} head={with_head} {name}: "
                          f"max_abs_err={err:.3e} rel={rel:.3e} (tol rel "
                          f"{tol})")
                    if not rel <= tol:
                        fail(f"kernel A {name} {label} disagrees: rel {rel}")
                if not with_head:
                    continue
                tok_k = got[4].cpu().tolist()
                tok_same = K.sample_plain(got[3], prev, u, kw["sampler"])
                if tok_same.cpu().tolist() != tok_k:
                    fail(f"kernel A sampler disagrees with its plain "
                         f"version on the same logits ({label}): {tok_k} "
                         f"vs {tok_same.cpu().tolist()}")
                if layout == "uniform":
                    tok_p = want[4].cpu().tolist()
                    gaps = _cdf_gaps(torch, want[3], prev, u, kw["sampler"])
                    print(f"  A {label} tokens kernel={tok_k} plain={tok_p}; "
                          f"u's distance to the plain CDF's nearest step "
                          f"edge per row {[f'{g:.2e}' for g in gaps]}")
                    if tok_k != tok_p:
                        fail(f"kernel A tokens differ from the plain path "
                             f"({label}): {tok_k} vs {tok_p}")
                else:
                    _check_firm_tokens(torch, K, args, kw, got, want, label)
            if b == 16:
                k_ms = cuda_ms(torch, lambda: K.fused_decode_trunk(*args,
                                                                   **full))
                p_ms = cuda_ms(torch, lambda: K.fused_decode_trunk_plain(
                    *args, **full), iters=3)
                print(f"  A decode step (B=16, C=640, ragged, head+sampler): "
                      f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms")
            if b == 1:
                timing = (
                    cuda_ms(torch, lambda: K.fused_decode_trunk(*args,
                                                                **full)),
                    cuda_ms(torch, lambda: K.fused_decode_trunk_plain(
                        *args, **full), iters=3))
                per_step = device_launches(
                    torch, lambda: K.fused_decode_trunk(*args, **full), 3,
                    "decode")
                # bytes: every weight, the head, the whole cache, the
                # inputs and outputs once; the FLOPs are ~2 per weight
                # byte, far under the byte time
                out = K.fused_decode_trunk(*args, **full)
                a_bound = bound(nbytes(args, full, out),
                                flops=2.0 * nbytes(blocks, full["head"]))
    print(f"  A decode step (B=1, C=640, head+sampler): kernel "
          f"{timing[0]:.3f} ms, plain {timing[1]:.3f} ms; {per_step:g} "
          f"kernel launches per decode step")
    results["A"] = dict(max_abs_err=worst, ms=timing[0], plain_ms=timing[1],
                        library_ms=None, **a_bound)


def device_launches(torch, fn, calls, match) -> float:
    """Kernels whose name holds ``match`` that the device ran per call of
    ``fn`` (torch.profiler over ``calls`` calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and match in e.key)
    return n / calls


def trace_kernel_a(torch) -> None:
    """Kernel A's own timeline (its tt_decode_set_trace hook, the global
    timer at every grid barrier) at B = 1 and 16: per layer phase, the
    mean time from block 0 leaving the barrier before it to the last
    block arriving at the barrier after it (work), and from there to
    block 0 leaving that barrier (barrier)."""
    from tortoise_tpu_torch.ops.cuda import build
    from tortoise_tpu_torch.ops.cuda import decode_trunk as K

    lib = build.library()
    weights = _kernel_a_weights(torch)
    names = ("qkv", "attention", "proj+residual", "LN2", "fc+GELU",
             "fc_proj+residual", "LN1")
    for b in (1, 16):
        blocks, ck, cv, bias_row, x, kw = _kernel_a_inputs(torch, b, weights)
        buf = torch.zeros(4096, dtype=torch.int64, device="cuda")
        lib.tt_decode_set_trace(buf.data_ptr())
        try:
            K.fused_decode_trunk(blocks, ck, cv, bias_row, x, **kw)
            torch.cuda.synchronize()
        finally:
            lib.tt_decode_set_trace(None)
        t = buf.cpu().tolist()
        exits = [t[0]] + [v for v in t[1:2048] if v]
        ends = t[2048:2048 + len(exits) - 1]
        work = [(ends[k] - exits[k]) / 1e3 for k in range(len(ends))]
        wait = [(exits[k + 1] - ends[k]) / 1e3 for k in range(len(ends))]
        per = len(names)
        n_layer = (len(ends) - 3) // per
        print(f"  A trace B={b}: {len(ends)} barriers over "
              f"{(exits[-1] - exits[0]) / 1e3:.1f} us, barrier mean "
              f"{sum(wait) / len(wait):.2f} us; LN1 of layer 0 "
              f"{work[0]:.2f} us; head {work[-2]:.2f} us, sampler "
              f"{work[-1]:.2f} us")
        for j, name in enumerate(names):
            w = [work[1 + per * i + j] for i in range(n_layer)]
            g = [wait[1 + per * i + j] for i in range(n_layer)]
            print(f"    {name:13s} work {sum(w) / n_layer:6.2f} us, barrier "
                  f"{sum(g) / n_layer:5.2f} us (mean of {n_layer} layers)")
        del blocks, ck, cv, bias_row, x, kw, buf


def profile_phase(torch) -> None:
    """torch.profiler over 5 kernel-A decode steps (B=1) and a 3-step
    production-width diffusion run (B=1, 500 latents, bf16 + int8,
    kernel B): device time by kernel, and the traces under chiprun_out/."""
    import dataclasses

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tortoise_tpu_torch.ops.cuda import decode_trunk as K
    from tortoise_tpu_torch.pipeline import diffusion_stage as DS
    from tortoise_tpu_torch.pipeline.synthesize import TortoiseModels

    def report(prof, name, n, wall_s):
        # device-side events only (kernels, copies): an op's own row would
        # count its kernels' time a second time
        rows = [(evt.self_device_time_total, evt.count, evt.key)
                for evt in prof.key_averages()
                if evt.device_type == DeviceType.CUDA
                and evt.self_device_time_total > 0]
        rows.sort(reverse=True)
        busy_ms = sum(r[0] for r in rows) / 1e3 / n
        wall_ms = wall_s * 1e3 / n
        print(f"  {name}: device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms "
              f"wall per iteration over {n} (idle share "
              f"{1 - busy_ms / wall_ms:.3f}); by kernel (device us per "
              f"iteration, launches per iteration):")
        for dev, count, key in rows[:12]:
            print(f"    {dev / n:10.1f} us  {count / n:7.1f}x  {key[:90]}")
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        prof.export_chrome_trace(os.path.join(ROOT, "chiprun_out",
                                              f"trace_{name}.json"))

    args = _kernel_a_inputs(torch, 1)
    for _ in range(2):
        K.fused_decode_trunk(*args[:5], **args[5])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(5):
            K.fused_decode_trunk(*args[:5], **args[5])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    report(prof, "decode_step", 5, wall)
    trace_kernel_a(torch)

    models = TortoiseModels.random(0)
    cfg = dataclasses.replace(models.diffusion_cfg, use_flash=True,
                              n_sample_timesteps=3)
    params = DS._prepare_params(models.diffusion_params, True, "cuda")
    lat = torch.randn((1, 512, 1024), device="cuda")
    DS.diffusion_batch_device(params, lat, [500], cfg, compute_dtype=
                              torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        DS.diffusion_batch_device(params, lat, [500], cfg, compute_dtype=
                                  torch.bfloat16, device="cuda")
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    report(prof, "diffusion_3_steps", 3, wall)


def check_kernel_b(torch, results):
    """Kernel B: the denoiser's (2, 2176, 3072) bf16 packed qkv with the
    rel-pos table, unmasked, plus a masked ragged length; a stream
    window's (8, 384) unmasked; a server batch's 2B = 8 CFG rows at 2176
    with one utterance (rows 1 and 5) shorter; a tp rank's 2-row batch
    on its 8 (tp = 2) or 4 (tp = 4) local heads."""
    from tortoise_tpu_torch.ops.cuda import flash_attention as K

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    worst, tol = 0.0, 2e-2
    timing = None
    for b, t, n_valid, H in B_CASES:
        table = torch.randn((32, H), generator=g, device=dev) * 0.3
        qkv = bf16_qkv(torch, g, b, t, H, 64)
        valid = None
        if n_valid is not None:
            lens = [t] * b
            lens[1] = n_valid
            if b > 2:  # a batch: utterance 1's conditioned and free rows
                lens[b // 2 + 1] = n_valid
            valid = torch.arange(t, device=dev)[None, :] < torch.tensor(
                lens, device=dev)[:, None]
        bias_vec = K.relpos_bias_vector(table, t)
        got = K.flash_attention_packed(qkv, H, valid, bias_vec=bias_vec)
        want = K.flash_attention_packed_plain(qkv, H, valid, bias_vec)
        torch.cuda.synchronize()
        err, rel = rel_err(torch, got, want)
        worst = max(worst, err)
        print(f"  B ({b}, {t}) x {H} heads valid={n_valid}: max_abs_err="
              f"{err:.3e} rel={rel:.3e} (tol rel {tol})")
        if not rel <= tol:
            fail(f"kernel B disagrees at ({b}, {t}) x {H} heads: rel {rel}")
        if timing is None:
            timing = (
                cuda_ms(torch, lambda: K.flash_attention_packed(
                    qkv, H, valid, bias_vec=bias_vec)),
                cuda_ms(torch, lambda: K.flash_attention_packed_plain(
                    qkv, H, valid, bias_vec), iters=3))
            q, k, v = views(qkv, H, 64)
            lib_ms = sdpa_ms(torch, q, k, v,
                             K._toeplitz_full(bias_vec, t, t)[None],
                             "B (2, 2176)")
            b_bound = bound(nbytes(qkv, bias_vec, got),
                            flops=4.0 * b * H * t * t * 64,
                            exps=float(b * H * t * t))
    print(f"  B (2, 2176) x 16 heads: kernel {timing[0]:.3f} ms, plain "
          f"{timing[1]:.3f} ms, SDPA {lib_ms:.3f} ms")
    results["B"] = dict(max_abs_err=worst, ms=timing[0], plain_ms=timing[1],
                        library_ms=lib_ms, **b_bound)


def check_kernel_c(torch, results):
    """Kernel C: the AR latent pass at --batch-size 8, S = 535 with a
    text bucket of 32 holding 30 real ids."""
    from tortoise_tpu_torch.ops.cuda import flash_attention as K

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    (b, H, s), tol = C_SHAPE, 2e-2
    qkv = bf16_qkv(torch, g, b, s, H, 64)
    valid = torch.ones((b, s), dtype=torch.bool, device=dev)
    valid[:, 1 + 30:1 + 32] = False
    got = K.flash_attention_causal_qkv(qkv, H, valid)
    want = K.flash_attention_causal_qkv_plain(qkv, H, valid)
    torch.cuda.synchronize()
    err, rel = rel_err(torch, got, want)
    print(f"  C B={b} S={s}: max_abs_err={err:.3e} rel={rel:.3e} "
          f"(tol rel {tol})")
    if not rel <= tol:
        fail(f"kernel C disagrees: rel {rel}")
    ms = cuda_ms(torch, lambda: K.flash_attention_causal_qkv(qkv, H, valid))
    plain_ms = cuda_ms(torch, lambda: K.flash_attention_causal_qkv_plain(
        qkv, H, valid), iters=3)
    q, k, v = K._split_part_major(qkv, H)
    add = K._causal_add(s, s, dev)[None, None] + \
        K._additive_mask(valid)[:, None, None, :]
    lib_ms = sdpa_ms(torch, q, k, v, add, "C (8, 535)")
    pairs = b * H * s * (s + 1) / 2  # (query, key) pairs under the diagonal
    c_bound = bound(nbytes(qkv, valid, got), flops=4.0 * 64 * pairs,
                    exps=pairs)
    print(f"  C (8, 535) x 16 heads: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, SDPA {lib_ms:.3f} ms")
    results["C"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        library_ms=lib_ms, **c_bound)


def _check(torch, name, got, want, tol, worst):
    err, rel = rel_err(torch, got, want)
    print(f"  {name}: max_abs_err={err:.3e} rel={rel:.3e} (tol rel {tol})")
    if not rel <= tol:
        fail(f"{name} disagrees: rel {rel}")
    return max(worst, err)


def check_kernel_d1(torch, results):
    """Kernel D1, the denoiser's fallback attention, on the wgmma + TMA
    body: 32 heads of 32 over strided views of the (2, 2176, 3072) bf16
    qkv, unmasked and masked; a ragged T = 1000; the 16 CFG rows of an
    8-request server batch at T = 1000 with ragged masks; then 16 heads
    of 64 held against kernel B on the same qkv. Each timed shape prints
    the kernel's, SDPA's and the bound's ms."""
    from tortoise_tpu_torch.ops.cuda import flash_attention as K

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    worst, tol = 0.0, 2e-2
    for b, t, h, d, masks in D1_CASES:
        qkv = bf16_qkv(torch, g, b, t, h, d)
        q, k, v = views(qkv, h, d)
        kw = dict(bias_table=torch.randn((32, h), generator=g,
                                         device=dev) * 0.3,
                  bias_formula=True)
        vec = K.relpos_bias_vector(kw["bias_table"], t)
        for n_valid in masks:
            valid = None
            if n_valid == "ragged":  # rows 2i, 2i+1: one request's CFG pair
                lens = torch.tensor([t - 37 * (i // 2) for i in range(b)],
                                    device=dev)
                valid = torch.arange(t, device=dev)[None, :] < lens[:, None]
            elif n_valid is not None:
                lens = torch.tensor([t] * (b - 1) + [n_valid], device=dev)
                valid = torch.arange(t, device=dev)[None, :] < lens[:, None]
            label = f"D1 ({b}, {h}, {t}, {d}) valid={n_valid}"
            got = K.flash_attention(q, k, v, None, valid, **kw)
            want = K.flash_attention_plain(q, k, v, None, valid, **kw)
            torch.cuda.synchronize()
            worst = _check(torch, label, got, want, tol, worst)
            if n_valid is None:
                unmasked = got
            if d == 64:
                continue

            def call():
                return K.flash_attention(q, k, v, None, valid, **kw)
            ms = cuda_ms(torch, call)
            add = K._toeplitz_full(vec, t, t)[None]
            if valid is not None:
                add = add + K._additive_mask(valid)[:, None, None, :]
            lib_ms = sdpa_ms(torch, q, k, v, add, label)
            d_bound = bound(nbytes(qkv, vec, valid, got),
                            flops=4.0 * b * h * t * t * d,
                            exps=float(b * h * t * t))
            print(f"  {label}: kernel {ms:.3f} ms, SDPA {lib_ms:.3f} ms, "
                  f"bound {d_bound['bound_ms']:.4f} ms")
            if (b, t, n_valid) == (2, 2176, None):
                plain_ms = cuda_ms(torch, lambda: K.flash_attention_plain(
                    q, k, v, None, valid, **kw), iters=3)
                main = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                            **d_bound)
        if d == 64:
            via_b = K.flash_attention_packed(qkv, h,
                                             bias_table=kw["bias_table"])
            worst = _check(torch, "D1 (16 x 64) against kernel B",
                           K._merge(unmasked), via_b, tol, worst)
            ms_b = cuda_ms(torch, lambda: K.flash_attention_packed(
                qkv, h, bias_table=kw["bias_table"]))
            ms_d = cuda_ms(torch, lambda: K.flash_attention(
                q, k, v, None, None, **kw))
            print(f"  (2, 2176) x 16 heads of 64: kernel B {ms_b:.3f} ms, "
                  f"kernel D1 {ms_d:.3f} ms")
    print(f"  D1 (2, 2176) x 32 heads of 32: kernel {main['ms']:.3f} ms, "
          f"plain {main['plain_ms']:.3f} ms, SDPA {main['library_ms']:.3f} "
          f"ms")
    results["D1"] = dict(max_abs_err=worst, **main)


def check_kernel_d2(torch, results):
    """Kernel D2, the generic body, on the wgmma + TMA body: each of
    D2_CASES at head width 64 (causal with a key mask at the AR latent
    pass's shape (8, 16, 535, 64); the bucket bias, a materialized bias,
    Tq 256 x Tkv 1000 with the formula bias, and causal with the formula
    bias at (2, 16, 1000, 64), each with a ragged row) held against its
    plain version and timed (kernel, plain, SDPA, bound), one launch of
    D2 a call with an f32 output; then every mode at 4 heads of
    D2_WIDTHS, checked."""
    from tortoise_tpu_torch.ops.cuda import flash_attention as K

    g = torch.Generator(device="cuda").manual_seed(4)
    worst, tol, main = 0.0, 2e-2, None
    for mode, b, h, tq, tkv in D2_CASES:
        q, k, v, kw = d2_inputs(torch, g, mode, b, h, tq, tkv)
        label = f"D2 {mode} ({b}, {h}, {tq}, {tkv}, 64)"
        before = K._generic_flash.launches
        got = K.flash_attention(q, k, v, **kw)
        if K._generic_flash.launches != before + 1 or \
                got.dtype != torch.float32:
            fail(f"{label} was not one f32 launch of D2")
        want = K.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        worst = _check(torch, label, got, want, tol, worst)
        ms = cuda_ms(torch, lambda: K.flash_attention(q, k, v, **kw))
        plain_ms = cuda_ms(torch, lambda: K.flash_attention_plain(
            q, k, v, **kw), iters=3)
        add, vec, full = attention_add(torch, K, q, k, kw)
        lib_ms = sdpa_ms(torch, q, k, v, add, label)
        del add
        pairs = attention_pairs(b, h, tq, tkv, kw["causal"])
        d2_bound = bound(nbytes(q, k, v, kw["kv_valid"], vec, full, got),
                         flops=4.0 * 64 * pairs, exps=pairs)
        print(f"  {label}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
              f"SDPA {lib_ms:.4f} ms, bound {d2_bound['bound_ms']:.4f} ms "
              f"({d2_bound['bound_by']})")
        if main is None:
            main = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                        **d2_bound)
        del q, k, v, kw, got, want, vec, full
    for d in D2_WIDTHS:
        for mode, *_ in D2_CASES:
            tq, tkv = (256, 1000) if mode == "unequal" else (300, 300)
            q, k, v, kw = d2_inputs(torch, g, mode, 2, 4, tq, tkv, d)
            got = K.flash_attention(q, k, v, **kw)
            worst = _check(torch, f"D2 {mode} (2, 4, {tq}, {tkv}, {d})",
                           got, K.flash_attention_plain(q, k, v, **kw), tol,
                           worst)
    results["D2"] = dict(max_abs_err=worst, **main)


def f32_bound(n_bytes, d, pairs) -> dict:
    """The split-TF32 body's bound: three TF32 products a product (3 x 4D
    FLOPs a pair) at 495 TFLOP/s, the exps and the bytes; and, beside it
    as ``fma_bound_ms``, the same work as f32 FMAs at 67 TFLOP/s."""
    tf = bound(n_bytes, flops=12.0 * d * pairs, flop_rate=TF32_FLOPS,
               exps=pairs)
    fma = bound(n_bytes, flops=4.0 * d * pairs, flop_rate=F32_FLOPS,
                exps=pairs)
    return dict(tf, fma_bound_ms=fma["bound_ms"])


def _f32_case(torch, K, label, call, plain, qkv_views, add, inputs, pairs,
              counter, mean=None) -> dict:
    """One f32 call of the split-TF32 body: one launch of the route's
    ``counter`` and of the body, an f32 output held at F32_TOL of max
    |out| against the plain version (and ``mean``, the mean of V, where
    given), timed against the plain version, SDPA in f32 on the same
    views (``add``: bias, mask and causal mask as one float mask) and the
    bound of ``inputs`` + the output. Returns the row's numbers."""
    before = (counter.launches, K._launch_d.launches)
    got = call()
    if (counter.launches, K._launch_d.launches) != (
            before[0] + 1, before[1] + 1) or got.dtype != torch.float32:
        fail(f"{label} was not one f32 launch of its kernel on the "
             f"split-TF32 body")
    want = plain()
    torch.cuda.synchronize()
    err = _check(torch, label, got, want, F32_TOL, 0.0)
    if mean is not None:
        _check(torch, f"{label}, its fully masked row against the mean of V",
               mean[0](got), mean[1], F32_TOL, 0.0)
    n_bytes = nbytes(inputs, got)
    del got, want
    ms = cuda_ms(torch, call)
    plain_ms = cuda_ms(torch, plain, iters=3)
    lib_ms = sdpa_ms(torch, *qkv_views, add, label)
    bd = f32_bound(n_bytes, qkv_views[0].shape[-1], pairs)
    print(f"  {label}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, SDPA "
          f"(f32) {lib_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms "
          f"({bd['bound_by']}), f32 FMA bound {bd['fma_bound_ms']:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bd["bound_ms"],
                bound_by=bd["bound_by"])


def _ragged(torch, b, t, cut=63):
    """A (b, t) key mask with the last row's keys cut ``cut`` short."""
    lens = torch.tensor([t] * (b - 1) + [t - cut], device="cuda")
    return torch.arange(t, device="cuda")[None, :] < lens[:, None]


def check_f32_body(torch):
    """flash_attention_bhtd.cu's split-TF32 body on D1 and D2's f32
    calls, each held at F32_TOL of max |out| against its plain version
    and timed (kernel, plain, SDPA in f32, the bound with the f32 FMA
    bound beside it; ``_f32_case``): FMA_CASES (D2 causal with the latent
    pass's key mask at (8, 16, 535, 64) and D1 at (2, 32, 2176, 32) with
    the formula bias, on views of a packed qkv); every other D2_CASES
    mode at (2, 16, 1000, 64) in f32; D1 and D2 (causal with the formula
    bias) at each of F32_WIDTHS; D2 with a materialized bias and a batch
    row with no valid key (the mean of V); and D2 at F32_LONG's 8192
    keys with the formula bias and a ragged row."""
    from tortoise_tpu_torch.ops.cuda import flash_attention as K

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)

    def d_case(label, q, k, v, kw, inputs, mean=None):
        add, vec, full = attention_add(torch, K, q, k, kw)
        tq, tkv = q.shape[2], k.shape[2]
        fn = K._grouped_flash if (kw.get("bias_formula") and not
                                  kw["causal"] and tq == tkv) \
            else K._generic_flash
        _f32_case(torch, K, label, lambda: K.flash_attention(q, k, v, **kw),
                  lambda: K.flash_attention_plain(q, k, v, **kw), (q, k, v),
                  add, (inputs, kw["kv_valid"], vec, full),
                  attention_pairs(q.shape[0], q.shape[1], tq, tkv,
                                  kw["causal"]), fn, mean)

    for route, b, h, t, d in FMA_CASES:
        qkv = torch.randn((b, t, 3 * h * d), generator=g, device=dev)
        q, k, v = views(qkv, h, d)
        if route == "D2":
            valid = torch.ones((b, t), dtype=torch.bool, device=dev)
            valid[:, 1 + 30:1 + 32] = False
            kw = dict(kv_valid=valid, causal=True)
        else:
            kw = dict(kv_valid=None, causal=False,
                      bias_table=torch.randn((32, h), generator=g,
                                             device=dev) * 0.3,
                      bias_formula=True)
        d_case(f"{route} f32 ({b}, {h}, {t}, {d})", q, k, v, kw, qkv)
        del qkv, q, k, v
    for mode, b, h, tq, tkv in D2_CASES[1:]:
        q, k, v, kw = d2_inputs(torch, g, mode, b, h, tq, tkv,
                                dtype=torch.float32)
        d_case(f"D2 f32 {mode} ({b}, {h}, {tq}, {tkv}, 64)", q, k, v, kw,
               (q, k, v))
        del q, k, v, kw
    for d in F32_WIDTHS:
        h, t = 1024 // d, 1000
        qkv = torch.randn((2, t, 3 * h * d), generator=g, device=dev)
        q, k, v = views(qkv, h, d)
        kw = dict(kv_valid=_ragged(torch, 2, t), causal=False,
                  bias_table=torch.randn((32, h), generator=g,
                                         device=dev) * 0.3,
                  bias_formula=True)
        d_case(f"D1 f32 (2, {h}, {t}, {d})", q, k, v, kw, qkv)
        del qkv, q, k, v
        q, k, v, kw = d2_inputs(torch, g, "causal_formula", 2, h, t, t, d,
                                dtype=torch.float32)
        d_case(f"D2 f32 causal_formula (2, {h}, {t}, {t}, {d})", q, k, v,
               kw, (q, k, v))
        del q, k, v, kw
    q, k, v, kw = d2_inputs(torch, g, "materialized", 2, 16, 1000, 1000,
                            dtype=torch.float32)
    kw["kv_valid"] = kw["kv_valid"].clone()
    kw["kv_valid"][1] = False  # batch row 1: no valid key
    d_case("D2 f32 materialized, row 1 with no valid key (2, 16, 1000, "
           "1000, 64)", q, k, v, kw, (q, k, v),
           mean=(lambda got: got[1], v[1].mean(dim=1, keepdim=True)
                 .expand(16, 1000, 64)))
    del q, k, v, kw
    b, h, tq, tkv = F32_LONG
    q, k, v, kw = d2_inputs(torch, g, "unequal", b, h, tq, tkv,
                            dtype=torch.float32)
    d_case(f"D2 f32 long keys, formula bias ({b}, {h}, {tq}, {tkv}, 64)",
           q, k, v, kw, (q, k, v))
    del q, k, v, kw


def check_wide_heads(torch):
    """Kernels B and C at head width 128 (8 heads of a 1024 width): their
    wrappers run the wgmma + TMA body on strided views of the same qkv,
    two 64-column boxes a tile. Then both at head width 16."""
    from tortoise_tpu_torch.ops.cuda import flash_attention as K

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    (b, t), (bc, s) = WIDE
    qkv = bf16_qkv(torch, g, b, t, 8, 128)
    bias_vec = K.relpos_bias_vector(
        torch.randn((32, 8), generator=g, device=dev) * 0.3, t)
    out = K.flash_attention_packed(qkv, 8, bias_vec=bias_vec)
    _check(torch, f"B at 8 heads of 128 ({b}, {t})", out,
           K.flash_attention_packed_plain(qkv, 8, None, bias_vec), 2e-2, 0.0)
    ms_b = cuda_ms(torch, lambda: K.flash_attention_packed(
        qkv, 8, bias_vec=bias_vec))
    plain_b = cuda_ms(torch, lambda: K.flash_attention_packed_plain(
        qkv, 8, None, bias_vec), iters=3)
    q, k, v = views(qkv, 8, 128)
    lib_b = sdpa_ms(torch, q, k, v, K._toeplitz_full(bias_vec, t, t)[None],
                    f"B128 ({b}, {t})")
    b128 = bound(nbytes(qkv, bias_vec, out), flops=4.0 * b * 8 * t * t * 128,
                 exps=float(b * 8 * t * t))
    print(f"  B128 ({b}, {t}) x 8 heads of 128: kernel {ms_b:.3f} ms, plain "
          f"{plain_b:.3f} ms, SDPA {lib_b:.3f} ms, bound "
          f"{b128['bound_ms']:.4f} ms ({b128['bound_by']})")
    qkv = bf16_qkv(torch, g, bc, s, 8, 128)
    valid = torch.ones((bc, s), dtype=torch.bool, device=dev)
    valid[:, 31:33] = False
    _check(torch, f"C at 8 heads of 128 ({bc}, {s})",
           K.flash_attention_causal_qkv(qkv, 8, valid),
           K.flash_attention_causal_qkv_plain(qkv, 8, valid), 2e-2, 0.0)
    ms_c = cuda_ms(torch, lambda: K.flash_attention_causal_qkv(qkv, 8,
                                                                valid))
    print(f"  head width 128: B route {ms_b:.3f} ms, C route {ms_c:.3f} ms")
    # the tiny configs' 4 heads of 16: the wgmma + TMA body on strided
    # views (one 16-column box a tile, the 32-byte swizzle), bf16 output
    qkv = torch.randn((2, 230, 3 * 64), generator=g,
                      device=dev).to(torch.bfloat16)
    valid = torch.arange(230, device=dev)[None, :] < torch.tensor(
        [[230], [201]], device=dev)
    bias_vec = K.relpos_bias_vector(
        torch.randn((32, 4), generator=g, device=dev) * 0.3, 230)
    _check(torch, "B at 4 heads of 16 (2, 230)",
           K.flash_attention_packed(qkv, 4, valid, bias_vec=bias_vec),
           K.flash_attention_packed_plain(qkv, 4, valid, bias_vec), 2e-2, 0.0)
    _check(torch, "C at 4 heads of 16 (2, 230)",
           K.flash_attention_causal_qkv(qkv, 4, valid),
           K.flash_attention_causal_qkv_plain(qkv, 4, valid), 2e-2, 0.0)


def check_kernel_e(torch, results):
    """Kernel E per vocoder stage (hops 8, 64, 256), each checked and
    timed (kernel, plain, bound): one conv block's slice of the stacked
    predicted kernels for 500 latents (M = 2186 frames in a 2208 bucket),
    a stream chunk's 32-frame bucket, the ragged L = 2186, and two batch
    rows taken as a block slice of the stacked kernels (the vocoder's
    batch stride). The first shape's three hops make the result line."""
    from tortoise_tpu_torch.ops.cuda import lvc as K

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    worst, tol, main = 0.0, 1e-4, dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    bound_by = {}
    for L, b in E_CASES:
        for hop in E_HOPS:
            args = lvc_inputs(torch, g, b, L, hop)
            label = f"E hop {hop} (B={b}, L={L}, T={L * hop})"
            got = K.lvc_gated_residual(*args)
            want = K.lvc_gated_residual_plain(*args)
            torch.cuda.synchronize()
            worst = _check(torch, label, got, want, tol, worst)
            k_ms = cuda_ms(torch, lambda: K.lvc_gated_residual(*args))
            p_ms = cuda_ms(torch, lambda: K.lvc_gated_residual_plain(
                *args), iters=3)
            # f32 FMAs outside the tensor cores: 32 in x 3 taps x 64
            # out per sample; bytes: x, this block's kernels, bias,
            # residual, output
            e_bound = bound(nbytes(args[:4], got),
                            flops=2.0 * 32 * 3 * 64 * L * hop * b,
                            flop_rate=F32_FLOPS)
            print(f"  {label}: kernel {k_ms:.4f} ms, plain {p_ms:.3f} "
                  f"ms, bound {e_bound['bound_ms']:.4f} ms "
                  f"({e_bound['bound_by']}); plan "
                  f"{K.lvc_plan(b, 32, 32, L, hop)}")
            if (L, b) == (2208, 1):
                main["ms"] += k_ms
                main["plain_ms"] += p_ms
                main["bound_ms"] += e_bound["bound_ms"]
                by = e_bound["bound_by"]
                bound_by[by] = bound_by.get(by, 0.0) + e_bound["bound_ms"]
            del args, got, want
    print(f"  E one conv block per stage (L = 2208, 3 hops summed): kernel "
          f"{main['ms']:.3f} ms, plain {main['plain_ms']:.3f} ms, bound "
          f"{main['bound_ms']:.4f} ms")
    results["E"] = dict(max_abs_err=worst, library_ms=None,
                        bound_by=max(bound_by, key=bound_by.get), **main)


def check_kernel_g(torch, results):
    """Kernel G at G_SHAPE on both planes, each of G_CHAINS: against its
    plain twin's f32 result (f32 maps at 1e-5 of max |out|, bf16 ones
    within one bf16 rounding plus 1e-5 of max |out|), two calls bit-equal,
    then timed beside the twin, the eager chain it replaced and its bound
    (x and the mask read once, the output written once). The bf16
    res_out_norm chain makes the result line."""
    from tortoise_tpu_torch.ops.cuda import group_norm as K

    g = torch.Generator(device="cuda").manual_seed(12)
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for name, film, silu in G_CHAINS:
            args, pair = gn_inputs(torch, g, dtype, film)
            kw = dict(film=pair, silu=silu)
            got = K.group_norm_act(*args, **kw)
            again = K.group_norm_act(*args, **kw)
            want = K.group_norm_act_plain(*args, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                fail(f"G {name} {dtype}: two calls differ")
            err = (got.float() - want).abs()
            top = float(want.abs().max())
            if dtype == torch.float32:
                past = float(err.max()) - 1e-5 * top
            else:
                a = want.abs().clamp_min(torch.finfo(torch.float32).tiny)
                ulp = torch.exp2(torch.floor(torch.log2(a)) - 7)
                past = float((err - 0.5 * ulp).max()) - 1e-5 * top
            label = f"G {name} ({dtype}, {tuple(args[0].shape)})"
            print(f"  {label}: max_abs_err={float(err.max()):.3e} rel="
                  f"{float(err.max()) / top:.3e}, past its tolerance by "
                  f"{past:.3e}")
            if past > 0:
                fail(f"{label} is past its tolerance by {past:.3e}")
            worst = max(worst, float(err.max()) / top)
            k_ms = cuda_ms(torch, lambda: K.group_norm_act(*args, **kw))
            p_ms = cuda_ms(torch, lambda: K.group_norm_act_plain(*args, **kw),
                           iters=3)
            e_ms = cuda_ms(torch, lambda: gn_eager_chain(
                torch, *args, pair, silu), iters=3)
            g_bound = bound(nbytes(args[0], args[5], got))
            print(f"  {label}: kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, "
                  f"eager chain it replaced {e_ms:.3f} ms, bound "
                  f"{g_bound['bound_ms']:.4f} ms ({g_bound['bound_by']}); "
                  f"plan {K.gn_plan(*args[0].shape[:2])}")
            if dtype == torch.bfloat16 and name == G_CHAINS[0][0]:
                results["G"] = dict(ms=k_ms, plain_ms=p_ms, library_ms=None,
                                    eager_chain_ms=e_ms, **g_bound)
            del args, pair, got, again, want, err
    results["G"]["max_abs_err"] = worst


def check_int8_product(torch, results):
    """Kernels Q8 and E8 at I8_CASES, bf16 and f32 inputs: Q8's codes and
    scales, E8's output (bf16 with the bias, f32 without a cast) and the
    whole route's product against the eager chain, bit for bit; then Q8,
    E8 and the route timed beside the eager chains they replace and their
    byte bounds (x read once and the codes written once; the f32 sums
    read once and the output written once). The eager chains are the
    plain models: ops.basic's quantize_rows, the pad of a conv's codes and
    scales, the codes' cast to bf16; the scales, tap sums, cast and bias
    as eager ops."""
    from tortoise_tpu_torch.models import diffusion as TDM
    from tortoise_tpu_torch.ops import conv
    from tortoise_tpu_torch.ops.basic import mm_bf16, quantize_cols
    from tortoise_tpu_torch.ops.cuda import int8_product as K

    b, t = G_SHAPE[:2]
    g = torch.Generator(device="cuda").manual_seed(22)

    def eager(x, pair, bias, padding):
        route = K.takes_kernels
        K.takes_kernels = lambda *a, **k: False
        try:
            if padding:
                return conv.conv1d_nwc(x, pair, bias, padding=1,
                                       compute_dtype=torch.bfloat16,
                                       out_dtype=torch.bfloat16)
            return TDM._linear(x, pair, bias, torch.bfloat16, torch.bfloat16)
        finally:
            K.takes_kernels = route

    for dtype in (torch.bfloat16, torch.float32):
        for name, k_in, n, padding in I8_CASES:
            x = torch.randn((b, t, k_in), generator=g, device="cuda") * 1.7
            x[1, -G_PADDED:] = 0.0
            x = x.to(dtype)
            taps = 2 * padding + 1
            pair = quantize_cols(0.05 * torch.randn(
                (taps * k_in, n), generator=g, device="cuda"))
            bias = torch.randn(n, generator=g, device="cuda")
            x3 = x if padding else x.reshape(1, -1, k_in)
            label = f"{name} ({dtype}, K {k_in}, N {n}, k{taps})"
            codes, s_row = K.quantize_rows(x3, padding)
            want = K.quantize_rows_plain(x3, padding)
            if not (torch.equal(codes, want[0]) and torch.equal(s_row,
                                                                want[1])):
                fail(f"Q8 {label}: codes or scales differ from the eager "
                     f"quantize")
            sums = [mm_bf16(codes.reshape(-1, k_in), wj)
                    for wj in pair[0].reshape(taps, k_in, n)]
            for od, bb in ((torch.bfloat16, bias), (None, None)):
                if not torch.equal(K.epilogue(sums, s_row, pair[1], bb, od),
                                   K.epilogue_plain(sums, s_row, pair[1], bb,
                                                    od)):
                    fail(f"E8 {label} out {od}: differs from the eager "
                         f"epilogue")
            got = K.int8_product(x, pair, bias, torch.bfloat16, padding)
            if not torch.equal(got, eager(x, pair, bias, padding)):
                fail(f"int8 product {label}: differs from the eager chain")
            q_ms = cuda_ms(torch, lambda: K.quantize_rows(x3, padding))
            qe_ms = cuda_ms(torch, lambda: K.quantize_rows_plain(x3,
                                                                 padding))
            q_bound = bound(nbytes(x, codes, s_row))
            e_ms = cuda_ms(torch, lambda: K.epilogue(
                sums, s_row, pair[1], bias, torch.bfloat16))
            ee_ms = cuda_ms(torch, lambda: K.epilogue_plain(
                sums, s_row, pair[1], bias, torch.bfloat16))
            e_bound = bound(nbytes(sums, got, s_row))
            r_ms = cuda_ms(torch, lambda: K.int8_product(
                x, pair, bias, torch.bfloat16, padding))
            re_ms = cuda_ms(torch, lambda: eager(x, pair, bias, padding))
            print(f"  Q8 {label}: kernel {q_ms:.4f} ms, the eager chain it "
                  f"replaced {qe_ms:.4f} ms, bound {q_bound['bound_ms']:.4f}"
                  f" ms; E8: kernel {e_ms:.4f} ms, eager chain {ee_ms:.4f} "
                  f"ms, bound {e_bound['bound_ms']:.4f} ms; the product: "
                  f"route {r_ms:.4f} ms, eager {re_ms:.4f} ms; bit-equal")
            if dtype == torch.bfloat16 and name == I8_CASES[1][0]:
                results["Q8"] = dict(ms=q_ms, plain_ms=qe_ms,
                                     library_ms=None, max_abs_err=0.0,
                                     **q_bound)
                results["E8"] = dict(ms=e_ms, plain_ms=ee_ms,
                                     library_ms=None, max_abs_err=0.0,
                                     **e_bound)
            del x, x3, pair, codes, s_row, want, sums, got


def check_f32_packed_and_causal(torch, results):
    """Kernels B and C on an f32 qkv, as the Pallas kernels take it (the
    default CLI's plane, request 9): the split-TF32 body of
    flash_attention_bhtd.cu on strided views, counted as B or C and as
    the body, each held at F32_TOL of max |out| and timed (``_f32_case``).
    B at the denoiser's (2, 2176) x 16 x 64 with the rel-pos bias (the
    result line's "Bf" row), C at the latent pass's (8, 535) x 16 x 64
    with its key mask; both at each of F32_WIDTHS (1024 / d heads; B at
    (2, 1000) with a ragged row); B with a batch row that has no valid
    key (the mean of V)."""
    from tortoise_tpu_torch.ops.cuda import flash_attention as K

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)

    def b_case(label, b, t, h, d, valid, mean=False):
        qkv = torch.randn((b, t, 3 * h * d), generator=g, device=dev)
        vec = K.relpos_bias_vector(
            torch.randn((32, h), generator=g, device=dev) * 0.3, t)
        add = K._toeplitz_full(vec, t, t)[None]
        if valid is not None:
            add = add + K._additive_mask(valid)[:, None, None, :]
        q, k, v = views(qkv, h, d)
        row = None
        if mean:  # row 1's output is the mean of its values, every head
            row = (lambda got: got[1], v[1].mean(dim=1).reshape(1, h * d)
                   .expand(t, h * d))
        return _f32_case(
            torch, K, label,
            lambda: K.flash_attention_packed(qkv, h, valid, bias_vec=vec),
            lambda: K.flash_attention_packed_plain(qkv, h, valid, vec),
            (q, k, v), add, (qkv, vec, valid),
            attention_pairs(b, h, t, t, False), K.flash_attention_packed,
            row)

    def c_case(label, b, s, h, d):
        qkv = torch.randn((b, s, 3 * h * d), generator=g, device=dev)
        valid = torch.ones((b, s), dtype=torch.bool, device=dev)
        valid[:, 1 + 30:1 + 32] = False
        q, k, v = K._split_part_major(qkv, h)
        add = K._causal_add(s, s, dev)[None, None] + \
            K._additive_mask(valid)[:, None, None, :]
        return _f32_case(
            torch, K, label,
            lambda: K.flash_attention_causal_qkv(qkv, h, valid),
            lambda: K.flash_attention_causal_qkv_plain(qkv, h, valid),
            (q, k, v), add, (qkv, valid),
            attention_pairs(b, h, s, s, True),
            K.flash_attention_causal_qkv)

    (b, t, _, h), (bc, hc, s) = B_CASES[0], C_SHAPE
    results["Bf"] = b_case(f"B f32 ({b}, {t}) x {h} heads of 64", b, t, h,
                           64, None)
    c_case(f"C f32 ({bc}, {s}) x {hc} heads of 64", bc, s, hc, 64)
    for d in F32_WIDTHS:
        b_case(f"B f32 (2, 1000) x {1024 // d} heads of {d}", 2, 1000,
               1024 // d, d, _ragged(torch, 2, 1000))
        c_case(f"C f32 ({bc}, {s}) x {1024 // d} heads of {d}", bc, s,
               1024 // d, d)
    valid = torch.ones((2, 1000), dtype=torch.bool, device=dev)
    valid[1] = False
    b_case("B f32 (2, 1000) x 16 heads of 64, row 1 with no valid key", 2,
           1000, 16, 64, valid, mean=True)


def _check_f(torch, K, name, qkv, h, valid, table, got, worst):
    """Kernel F's output against its plain version. Both quantize the
    same f32 values of qkv and part only in the order of l's sum, so an
    f32 output is held at 1e-5 of max |out|, and a bf16 one, element by
    element, within one bf16 rounding of the plain version's f32 result:
    |got - want| <= 2^-8 |want| + 1e-5 max |want|. (Q's scale taken per
    head instead of per 128-row block moves the output of N(0, 1) inputs
    by ~2e-2 of max |out|.) The error printed and kept is against the
    plain version in qkv's dtype."""
    want32 = K.flash_packed_i8_plain(qkv.float(), h, valid, table)
    if got.dtype == torch.float32:
        return _check(torch, name, got, want32, 1e-5, worst)
    over = ((got.float() - want32).abs() - 2.0 ** -8 * want32.abs()).max()
    slack = 1e-5 * float(want32.abs().max())
    print(f"  {name}: past one bf16 rounding of the f32 plain result by "
          f"{float(over):.3e} (allowed {slack:.3e})")
    if not float(over) <= slack:
        fail(f"{name} is more than one bf16 rounding from its plain version")
    err, _ = rel_err(torch, got, want32.to(got.dtype))
    return max(worst, err)


def expf_sass_ops(torch) -> dict:
    """The SASS instructions of one expf (what torch.exp runs on a CUDA
    float tensor, and what kernel F takes for its weights), by pipe: a
    one-line kernel compiled for sm_90a and read back with cuobjdump.
    Kernel F's design floor puts its exps on the FMA pipe at this count."""
    from tortoise_tpu_torch.ops.cuda import build

    nvcc = build.find_nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "expf.cu")
        with open(src, "w") as f:
            f.write("__global__ void k(float* x) {\n"
                    "  x[threadIdx.x] = expf(x[threadIdx.x]);\n}\n")
        cubin = os.path.join(tmp, "expf.cubin")
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                        "-O3", "-cubin", "-o", cubin, src], check=True,
                       capture_output=True, timeout=300)
        sass = subprocess.run([cuobjdump, "-sass", cubin], check=True,
                              capture_output=True, text=True,
                              timeout=120).stdout
    ops = []
    for line in sass.splitlines():
        parts = line.split("*/")
        if len(parts) < 2 or "/*" not in parts[0]:
            continue
        op = parts[1].strip().split(" ")[0].split(".")[0]
        if op and op[0] != "@" and op.isupper():
            ops.append(op)
    body = ops[ops.index("LDG") + 1:ops.index("STG")] if "LDG" in ops \
        and "STG" in ops else ops
    fma = [o for o in body if o in ("FFMA", "FADD", "FMUL", "FSETP", "FSEL",
                                    "FMNMX", "FCHK", "FSWZADD")]
    mufu = [o for o in body if o == "MUFU"]
    print(f"  expf on sm_90a: {len(body)} instructions between load and "
          f"store, {len(fma)} on the FMA pipe, {len(mufu)} MUFU: {body}")
    return dict(fma=len(fma), mufu=len(mufu), all=len(body))


def check_kernel_f(torch, results):
    """Kernel F, the int8-score packed attention, at the A/B's F_SHAPE in
    bf16: all keys valid, then row 1 valid to F_RAGGED, each one launch
    of the quantize pass and one of the attention kernel, held to its
    plain version by ``_check_f``; the first timed beside its plain
    version, its quantize pass and its attention kernel each alone, and
    kernel B on the same qkv (its yardstick: no one PyTorch call computes
    F), with the function's bound and the design's floor (the second
    score pass's int8 products, each exp's expf instructions on the FMA
    pipe). Then 4 heads of F_WIDTHS at a ragged (2, 300), in bf16 and
    f32, and F_LONG, a length past the bias window the first design
    staged a block."""
    import numpy as np

    from tortoise_tpu_torch.ops.cuda import flash_attention as KB
    from tortoise_tpu_torch.ops.cuda import flash_attention_int8 as K

    dev = torch.device("cuda")
    rng = np.random.default_rng(10)
    b, t, h, d = F_SHAPE
    worst, main = 0.0, None
    qkv = torch.as_tensor(rng.normal(0, 1, (b, t, 3 * h * d)).astype(
        np.float32)).to(dev).bfloat16()
    table = torch.as_tensor(rng.normal(0, 0.1, (32, h)).astype(
        np.float32)).to(dev)
    for n_valid in (None, F_RAGGED):
        valid = torch.ones((b, t), dtype=torch.bool, device=dev)
        if n_valid is not None:
            valid[1, n_valid:] = False
        label = f"F ({b}, {t}) x {h} heads of {d} valid={n_valid}"
        before = (K.flash_packed_i8.launches, K.quantize_kv.launches)
        got = K.flash_packed_i8(qkv, h, valid, table)
        if (K.flash_packed_i8.launches, K.quantize_kv.launches) != (
                before[0] + 1, before[1] + 1):
            fail(f"{label} was not one launch of each of F's kernels")
        worst = _check_f(torch, K, label, qkv, h, valid, table, got, worst)
        if main is not None:
            continue
        ms = cuda_ms(torch, lambda: K.flash_packed_i8(qkv, h, valid, table))
        plain_ms = cuda_ms(torch, lambda: K.flash_packed_i8_plain(
            qkv, h, valid, table), iters=3)
        b_ms = cuda_ms(torch, lambda: KB.flash_attention_packed(
            qkv, h, valid, bias_table=table))
        quant_ms = cuda_ms(torch, lambda: K.quantize_kv(qkv, h))
        mask, bias = K.i8_side_inputs(qkv, h, valid, table)
        kv = K.quantize_kv(qkv, h)
        attn_ms = cuda_ms(torch, lambda: K.attend_i8(qkv, h, kv, mask, bias))
        pairs = float(b * h * t * t)
        # the function's work: q . k and p . v (2D int8 ops a pair each);
        # the second score pass and the int8 K/V round trip through memory
        # are costs of this design, not of the function
        f_bound = bound(nbytes(qkv, valid, table, got),
                        flops=4.0 * d * pairs, flop_rate=INT8_OPS,
                        exps=pairs)
        tp = K.padded_length(t)
        exp_ops = expf_sass_ops(torch)
        floor_pass2 = 2.0 * d * b * h * tp * tp / INT8_OPS * 1e3
        floor_expf = float(b * h * tp * tp) * exp_ops["fma"] / (
            F32_FLOPS / 2) * 1e3
        print(f"  {label}: kernel {ms:.4f} ms = quantize pass {quant_ms:.4f} "
              f"ms + attention kernel {attn_ms:.4f} ms (each alone), plain "
              f"{plain_ms:.3f} ms, kernel B on the same qkv {b_ms:.4f} ms, "
              f"bound {f_bound['bound_ms']:.4f} ms ({f_bound['bound_by']}); "
              f"the design's floor beside it: its second score pass "
              f"{floor_pass2:.4f} ms of int8 products, its {tp}^2 x {b * h} "
              f"padded exps at {exp_ops['fma']} FMA-pipe instructions each "
              f"{floor_expf:.4f} ms")
        main = dict(ms=ms, plain_ms=plain_ms, library_ms=None, **f_bound)
    for d in F_WIDTHS:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((2, 300, 3 * 4 * d), device=dev).to(dtype)
            valid = torch.arange(300, device=dev)[None, :] < torch.tensor(
                [[300], [259]], device=dev)
            tab = torch.randn((32, 4), device=dev) * 0.1
            worst = _check_f(torch, K, f"F (2, 300) x 4 heads of {d} "
                             f"{dtype}", x, 4, valid, tab,
                             K.flash_packed_i8(x, 4, valid, tab), worst)
    t_long = F_LONG
    x = torch.randn((1, t_long, 3 * 64), device=dev).bfloat16()
    valid = torch.arange(t_long, device=dev)[None, :] < t_long - 77
    tab = torch.randn((32, 1), device=dev) * 0.1
    worst = _check_f(torch, K, f"F (1, {t_long}) x 1 head of 64 (past the "
                     f"first design's bias-window limit)", x, 1, valid, tab,
                     K.flash_packed_i8(x, 1, valid, tab), worst)
    del x
    torch.cuda.empty_cache()
    results["F"] = dict(max_abs_err=worst, **main)


def run_int8_ab(smi) -> dict:
    """scripts/torch_ubench_attn_int8_ab.py in a fresh process on the card
    (kernel F against kernel B at the denoiser's shape, chained and
    timed): it must exit 0, print F's error against B and both times, and
    count as many launches of F, of its quantize pass and of B as the
    calls it made. Returns its result."""
    script = os.path.join(ROOT, "scripts", "torch_ubench_attn_int8_ab.py")
    proc = subprocess.run([sys.executable, script], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    for line in proc.stdout.splitlines():
        print("  A/B: " + line)
    if proc.returncode != 0:
        fail(f"the int8 A/B exited {proc.returncode}: {proc.stderr[-2000:]}")
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith('{"ab"')]
    if not lines:
        fail(f"the int8 A/B printed no result line: {proc.stdout[-2000:]}")
    ab = json.loads(lines[-1])["ab"]
    calls, launches = ab["calls"], ab["launches"]
    if set(launches.values()) != {calls} or "i8_ms" not in ab or \
            not ab["i8_ms"] > 0 or not ab["bf16_ms"] > 0:
        fail(f"the int8 A/B made {calls} calls of each variant but counted "
             f"{launches}, or printed no times: {ab}")
    print(f"  int8 A/B: F vs B max abs err {ab['max_abs_err']:.4f} (rel "
          f"{ab['rel_err']:.4f}); B {ab['bf16_ms']:.4f} ms/call, F "
          f"{ab['i8_ms']:.4f} ms/call; launches {launches} over {calls} "
          f"calls [{smi}]")
    return ab


def run_request(torch, batch_size: int, out_dir: str, smi: str,
                plane=("--bf16", "--int8-weights"), label=None):
    """The CLI at full width with the ``plane`` flags (requests 1 and 2 on
    the production plane, request 9 on the default f32 plane); returns
    its SynthesisResult."""
    from tortoise_tpu_torch import cli
    from tortoise_tpu_torch.pipeline.vocoder_stage import audio_length

    label = label or f"b={batch_size}"
    out = os.path.join(out_dir, f"request_b{batch_size}.wav")
    argv = ["--random-weights", *plane, "--seed", "0",
            "--no-progress", "--batch-size", str(batch_size), "--tokens",
            ",".join(map(str, STANDIN_TOKENS)), "--output", out]
    t0 = time.monotonic()
    res = cli.run(argv)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    import numpy as np

    audio, mel = np.asarray(res.audio), np.asarray(res.mel)
    if not (np.isfinite(audio).all() and np.isfinite(mel).all()):
        fail(f"request {label}: non-finite audio or mel")
    want = audio_length(mel.shape[-1])
    if mel.shape[0] != 100 or audio.shape != (want,):
        fail(f"request {label}: mel {mel.shape}, audio "
             f"{audio.shape}, want ({want},)")
    dur = len(audio) / res.sample_rate
    t = res.timings
    st = {k: round(v, 3) for k, v in t.items()}
    print(f"  request {label}: {len(res.sequences)} candidates, "
          f"mel {mel.shape}, audio {len(audio)} samples ({dur:.2f} s); "
          f"stage walls {st}; call wall {wall:.2f} s, RTF "
          f"{sum(t[k] for k in cli.STAGES) / dur:.3f}, AR "
          f"{t['ar_decode_loop_s'] / t['ar_decode_steps'] * 1e3:.3f} "
          f"ms/step, diffusion "
          f"{t['diffusion_loop_s'] / t['diffusion_steps'] * 1e3:.3f} "
          f"ms/CFG-step [{smi}]")
    return res


# the graph-loop phase's planes: (name, compute dtype, int8 weights, decode
# steps): request 1's 500 on its own plane, cut on the two planes whose
# eager step takes 20-30 ms
GRAPH_PLANES = (("bf16 + int8", "bfloat16", True, 500),
                ("bf16 weights", "bfloat16", False, 128),
                ("f32", None, False, 128))
GRAPH_TURNS = (True, False, False, True)  # eager, graph, graph, eager
GRAPH_AR_STEPS = 8  # the busy A/B's decode steps
GRAPH_DIFFUSION_STEPS = 2  # its denoising steps (of 80)


@contextlib.contextmanager
def eager_loops(eager: bool):
    """With ``eager``, the stages' sampling and denoising loops run
    eagerly on the card (their private ``eager`` argument, as an A/B
    run may); else as they are (step graphs on the card)."""
    import functools

    from tortoise_tpu_torch.pipeline import ar_stage
    from tortoise_tpu_torch.pipeline import diffusion_stage as dst

    gen, den = ar_stage._generate, dst._denoise_loop
    if eager:
        ar_stage._generate = functools.partial(gen, eager=True)
        dst._denoise_loop = functools.partial(den, eager=True)
    try:
        yield
    finally:
        ar_stage._generate, dst._denoise_loop = gen, den


def check_graph_loops(torch, smi, reset_launch_counts, launch_counts):
    """The stage loops as step graphs against the eager loops, at full
    width on request 1's weights and settings (``synthesize()``, batch 1,
    seed 0, the stand-in tokens, a zero voice) on the bf16 + int8, the
    bf16-weights and the f32 planes (GRAPH_PLANES; the last two cut to
    128 decode steps), in turns (eager, graph, graph, eager): equal
    tokens, bit-equal mel and audio, equal launch counts (kernels A, B
    and Bf among them). Prints each run's AR and diffusion
    wall ms/step, RTF and peak memory, each graph's capture time and the
    first graph run's extra wall; then wall and busy ms/step of the
    sampling loop (GRAPH_AR_STEPS steps) and the denoising loop
    (GRAPH_DIFFUSION_STEPS steps) alone, eager against graph in turns,
    from the decode and diffstage scripts' ``loop_ab``."""
    import dataclasses

    import numpy as np

    from tortoise_tpu_torch.pipeline import ar_stage, graphs
    from tortoise_tpu_torch.pipeline.common import clear_cast_cache
    from tortoise_tpu_torch.pipeline.synthesize import (
        TortoiseModels,
        synthesize,
    )

    models = TortoiseModels.random(0, diffusion={"use_flash": True})
    voice = np.zeros((models.ar_cfg.d_model,), np.float32)
    dev = torch.device("cuda")
    lat = np.random.default_rng(0).normal(
        0, 0.5, (500, models.diffusion_cfg.d_model)).astype(np.float32)
    for name, cd, int8, steps in GRAPH_PLANES:
        cd = None if cd is None else getattr(torch, cd)
        plane_models = dataclasses.replace(models, ar_cfg=dataclasses.replace(
            models.ar_cfg, max_decode_steps=steps))
        runs = []
        for eager in GRAPH_TURNS:
            reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.monotonic()
            with eager_loops(eager):
                res = synthesize(plane_models, tokens=STANDIN_TOKENS,
                                 voice=voice, seed=0, compute_dtype=cd,
                                 int8_weights=int8, device=dev)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            t = res.timings
            dur = len(res.audio) / res.sample_rate
            runs.append(dict(
                eager=eager, seq=res.sequences, mel=np.asarray(res.mel),
                audio=np.asarray(res.audio), counts=launch_counts(),
                wall=wall, peak=torch.cuda.max_memory_allocated() / 2**20,
                ar=t["ar_decode_loop_s"] / t["ar_decode_steps"] * 1e3,
                diff=t["diffusion_loop_s"] / t["diffusion_steps"] * 1e3,
                rtf=sum(t[k] for k in ("autoregressive_s", "diffusion_s",
                                       "vocoder_s")) / dur))
            r = runs[-1]
            print(f"  graphs, {name}, {'eager' if eager else 'graph'}: AR "
                  f"{r['ar']:.3f} ms/step, diffusion {r['diff']:.3f} "
                  f"ms/CFG-step, RTF {r['rtf']:.4f}, call wall {wall:.3f} s, "
                  f"peak memory {r['peak']:.1f} MiB [{smi}]")
            if not eager and len(runs) == 2:
                caps = [f"{k[0]} {g.capture_s:.3f} s"
                        for k, g in graphs.entries()
                        if g.capture_s is not None]
                print(f"  graphs, {name}: captures {caps}")
        want = runs[0]
        for r in runs[1:]:
            if r["seq"] != want["seq"]:
                fail(f"graphs, {name}: tokens differ between the eager and "
                     f"the graph loops")
            for k in ("mel", "audio"):
                if not np.array_equal(r[k], want[k]):
                    fail(f"graphs, {name}: {k} differs between the eager and "
                         f"the graph loops by up to "
                         f"{float(np.abs(r[k] - want[k]).max()):.3e}")
            if r["counts"] != want["counts"]:
                fail(f"graphs, {name}: launch counts differ: eager "
                     f"{want['counts']}, {r['counts']}")
        print(f"  graphs, {name}: equal tokens, bit-equal mel and audio, "
              f"equal launches {want['counts']}; the first graph run's "
              f"extra wall {runs[1]['wall'] - runs[2]['wall']:.3f} s [{smi}]")
        # the loops alone: wall and busy a step, in turns
        dec = ubench("decode")
        params = ar_stage.cast_matmul_weights(models.ar_params, cd, int8,
                                              dev)
        ab = dec.loop_ab(params, ar_stage.size_cache(models.ar_cfg,
                                                     dec.TEXT_BUCKET), 1,
                         GRAPH_AR_STEPS, dev, 1, smi, cd, name)
        ds = ubench("diffstage")
        plane = {True: "int8", False: "bf16"}[int8] if cd else "f32"
        stage = ds.Stage(models.diffusion_params, dataclasses.replace(
            models.diffusion_cfg, n_sample_timesteps=GRAPH_DIFFUSION_STEPS),
            lat, dev, plane)
        dab = ds.loop_ab(stage, smi)
        if not (ab["same_tokens"] and dab["same_mel"]):
            fail(f"graphs, {name}: the loops alone differ: {ab} {dab}")
        for what, d in (("sampling loop", ab), ("denoising loop", dab)):
            if d["graph"]["launches_per_step"] != \
                    d["eager"]["launches_per_step"]:
                fail(f"graphs, {name}: {what} launches a step differ: {d}")
            print(f"  graphs, {name}, {what} alone (ms/step wall / busy, "
                  f"best of two turns): eager "
                  f"{d['eager']['ms_per_step']:.3f} / "
                  f"{d['eager']['busy_ms_per_step']:.3f}, graph "
                  f"{d['graph']['ms_per_step']:.3f} / "
                  f"{d['graph']['busy_ms_per_step']:.3f} [{smi}]")
        del params, stage
    del models
    clear_cast_cache()
    torch.cuda.empty_cache()


# kernel B's launches in one request at B = 1: the code conditioner's 4
# attention blocks once, then 13 attention layers (3 integrator + 10 main)
# in each of 80 denoising steps
REQUEST_B_LAUNCHES = 4 + 13 * 80
# kernel G's in the same request: code_norm and the conditioner's 4
# attention norms once, then 46 group norms (3 x 3 integrator, 10 x 3 main,
# 3 x 2 tail, out_norm) in each of 80 denoising steps
REQUEST_G_LAUNCHES = 5 + 46 * 80


def run_request_9(torch, models, out_dir, smi, reset_launch_counts,
                  launch_counts) -> dict:
    """The CLI on its default plane (no --bf16, no --int8-weights) at
    request 1's tokens, seed and batch size: the f32 parity plane, where
    the denoiser runs kernel B on the split-TF32 body, as the JAX CLI
    runs its Pallas kernel B on an f32 qkv. It must launch B on that body
    REQUEST_B_LAUNCHES times and kernel G REQUEST_G_LAUNCHES times; then
    the same request with --no-flash (no attention kernel; G as before)
    beside it; then one full-width f32 denoiser eval (one CFG
    step, B = 2, T = 2176, ``models``' diffusion weights) with use_flash
    on and off on the same inputs, held within 1e-4 of max |out| and both
    timed. Returns request 9's launch counts."""
    import dataclasses

    from tortoise_tpu_torch.models import diffusion as dm
    from tortoise_tpu_torch.ops.relpos import relative_position_buckets
    from tortoise_tpu_torch.pipeline import diffusion_stage as dst

    reset_launch_counts()
    run_request(torch, 1, out_dir, smi, plane=(), label="9 (f32 plane)")
    counts = launch_counts()
    for key, want in (("flash_attention_packed", REQUEST_B_LAUNCHES),
                      ("flash_attention_f32", REQUEST_B_LAUNCHES),
                      ("group_norm_act", REQUEST_G_LAUNCHES)):
        if counts[key] != want:
            fail(f"request 9 launched {key} {counts[key]} times, want "
                 f"{want}: {counts}")
    reset_launch_counts()
    run_request(torch, 1, out_dir, smi, plane=("--no-flash",),
                label="9 with --no-flash (f32 plane, plain attention)")
    off = launch_counts()
    if off.pop("group_norm_act") != REQUEST_G_LAUNCHES or any(off.values()):
        fail(f"request 9 with --no-flash launched an attention kernel, or "
             f"G other than {REQUEST_G_LAUNCHES} times: {off}")
    dcfg = models.diffusion_cfg
    params = dst._prepare_params(models.diffusion_params, False, "cuda")
    g = torch.Generator(device="cuda").manual_seed(3)
    t = B_CASES[0][1]
    x = torch.randn((2, dcfg.n_mel, t), generator=g, device="cuda")
    code = 0.5 * torch.randn((2, dcfg.d_model, t), generator=g,
                             device="cuda")
    buckets = torch.as_tensor(relative_position_buckets(
        t, dcfg.rel_pos_buckets, dcfg.rel_pos_max_distance), device="cuda")
    out, ms = {}, {}
    with torch.inference_mode():
        for flash in (True, False):
            cfg = dataclasses.replace(dcfg, use_flash=flash)
            ids = None if flash else buckets

            def ev():
                return dm.denoise(params, cfg, x, code, 100, ids)
            out[flash] = ev()
            ms[flash] = cuda_ms(torch, ev, iters=3, warmup=1)
    _check(torch, f"request 9's denoiser eval (2, {t}) f32, flash against "
           f"plain attention", out[True], out[False], 1e-4, 0.0)
    print(f"  one f32 denoiser eval (CFG step, B = 2, T = {t}): flash "
          f"{ms[True]:.3f} ms, plain attention {ms[False]:.3f} ms [{smi}]")
    del params, x, code, out
    return counts


# request 10's bench settings: one timed pass, the batch of 8 (kernel C
# runs in its prefill and latent passes), no bf16-weights section
BENCH_ENV = {"BENCH_REPS": "1", "BENCH_BATCH_SIZES": "8",
             "BENCH_ALT_PATH": "0"}


def run_request_10(smi) -> dict:
    """The port's benchmark, ``python -m tortoise_tpu_torch.bench``, in a
    fresh process at full width with BENCH_ENV and its warm-start child,
    its weights and int8 plane in a git-ignored directory of the
    checkout. It must exit 0 with a last line that parses, ``rtf`` > 0,
    ``kernel_check.ok``, the streaming and batched["8"] sections without
    an error, the warm start's first run on a plane-cache hit, and
    kernels A, B and C launched, F not, in its sections' timed passes.
    Returns those launches summed over the sections."""
    import shutil

    base = os.path.join(ROOT, "_plane_cache")
    os.makedirs(base, exist_ok=True)
    work = tempfile.mkdtemp(dir=base)
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(BENCH_ENV, BENCH_WEIGHTS_CACHE=work, PYTHONPATH=ROOT)
    t0 = time.monotonic()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "tortoise_tpu_torch.bench"], cwd=ROOT,
            env=env, capture_output=True, text=True, timeout=900)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    wall = time.monotonic() - t0
    if proc.returncode != 0:
        fail(f"request 10: the bench exited {proc.returncode}: "
             f"{proc.stdout[-1500:]} {proc.stderr[-2500:]}")
    try:
        line = json.loads(proc.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError) as e:
        fail(f"request 10: the bench's last line does not parse ({e}): "
             f"{proc.stdout[-1500:]}")
    launches = {}
    for counts in line.get("kernel_launches", {}).values():
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
    batched = line.get("batched", {}).get("8", {"error": "missing"})
    stream = line.get("streaming", {"error": "missing"})
    checks = (
        (line.get("rtf", 0) > 0, f"rtf {line.get('rtf')}"),
        (line.get("kernel_check", {}).get("ok") is True,
         f"kernel_check {line.get('kernel_check')}"),
        ("error" not in stream, f"streaming {stream}"),
        ("error" not in batched, f"batched 8 {batched}"),
        (isinstance(line.get("second_process_first_run_s"), (int, float))
         and line.get("second_process_plane_cache_hit") is True,
         "warm start: first run "
         f"{line.get('second_process_first_run_s')}, plane cache hit "
         f"{line.get('second_process_plane_cache_hit')}"),
        (all(launches.get(k, 0) > 0 for k in (
            "decode_trunk", "flash_attention_packed",
            "flash_attention_causal_qkv")), f"launches {launches}"),
        (launches.get("flash_packed_i8", 0) == 0
         and launches.get("int8_quantize_kv", 0) == 0,
         f"kernel F launched: {launches}"),
    )
    for ok, msg in checks:
        if not ok:
            fail(f"request 10 (the bench): {msg}")
    kc = line["kernel_check"]
    print(f"  request 10 (python -m tortoise_tpu_torch.bench, {BENCH_ENV}): "
          f"RTF {line['rtf']} (wall {line['wall_s']} s / audio "
          f"{line['audio_s']} s), AR {line['ar_ms_per_step']} ms/step "
          f"({line['ar_hbm_roofline_pct']}% of HBM roofline), diffusion "
          f"{line['diffusion_ms_per_cfg_step']} ms/CFG-step (MFU "
          f"{line['diffusion_mfu_pct']}%), sync_consistent "
          f"{line['sync_consistent']}; stream first audio "
          f"{stream['first_audio_s']} s, RTF {stream['rtf']}; batch 8 "
          f"aggregate RTF {batched['aggregate_rtf']}; warm start first run "
          f"{line['second_process_first_run_s']} s (upload "
          f"{line['second_process_upload_s']} s); kernel check "
          f"{ {k: v for k, v in kc.items() if k.endswith('maxdiff')} }; "
          f"process wall {wall:.1f} s [{smi}]")
    return launches


def ubench(name: str):
    """scripts/torch_ubench_<name>.py, loaded by path (scripts/ is no
    package)."""
    import importlib.util

    path = os.path.join(ROOT, "scripts", f"torch_ubench_{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_ubench_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# request 11's load test: 8 requests at 2 a second on batches of up to
# 4 rows, so the server forms more than one batch
SERVE_LOAD = dict(n_requests=8, rate=2.0, max_batch=4, max_wait_ms=100.0)


def run_request_11(torch, models, smi, reset_launch_counts,
                   launch_counts) -> dict:
    """The load test of scripts/torch_ubench_serve.py in this process on
    ``models`` (bf16 + int8, kernel B on): SERVE_LOAD's Poisson arrivals
    through SynthesisServer.submit. It must answer every request with
    finite latencies, form at least 2 batches, give an aggregate RTF
    above 0 and launch kernels A and B. Returns its launch counts."""
    import math

    reset_launch_counts()
    r = ubench("serve").run(models, device="cuda", card=smi, **SERVE_LOAD)
    counts = launch_counts()
    lat = [r[k] for k in ("p50_s", "p90_s", "p99_s", "max_s")]
    if not all(math.isfinite(v) and v > 0 for v in lat) \
            or r["batches"] < 2 or not r["aggregate_rtf"] > 0 \
            or r["failed_batches"]:
        fail(f"request 11 (the load test): {r}")
    print(f"  request 11 (load test, {SERVE_LOAD}): wall {r['wall_s']:.3f} s, "
          f"aggregate RTF {r['aggregate_rtf']:.5f}, latency p50 "
          f"{r['p50_s']:.3f} p99 {r['p99_s']:.3f} s, {r['batches']} batches "
          f"of {r['mean_rows']:.2f} rows, {r['padded_rows']} padded rows "
          f"[{smi}]")
    return counts


def run_ubench_phase(torch, models, smi, reset_launch_counts) -> None:
    """Scripts 2-10 of scripts/torch_ubench_*.py once each in this
    process, on ``models``' trees at full width with cut reps and steps.
    Each must run to its result; the launches must show kernel A in
    decode on the int8 plane and not on the bf16-weights plane, kernel C
    in the forced prefill and latent passes (and not in the plain ones),
    kernel B with flash on and no attention kernel with it off (kernel G
    either way), kernel E with use_pallas_lvc and none without; the
    group-norm patch must be gone after the gn script."""
    import dataclasses

    import numpy as np

    from tortoise_tpu_torch.models import diffusion as dm
    from tortoise_tpu_torch.ops.cuda import group_norm

    dev = torch.device("cuda")
    dcfg = dataclasses.replace(models.diffusion_cfg, use_flash=True)
    t0 = time.monotonic()
    reset_launch_counts()
    res = {}
    lat = np.random.default_rng(0).normal(
        0, 0.5, (500, dcfg.d_model)).astype(np.float32)
    res["diffstage"] = ubench("diffstage").run(
        models.diffusion_params, dataclasses.replace(
            dcfg, n_sample_timesteps=8), lat, dev, runs=2, card=smi)
    res["gn"] = ubench("gn").run(models.diffusion_params, dcfg, 2304, dev,
                                 reps=1, card=smi)
    if dm.group_norm_act is not group_norm.group_norm_act:
        fail("the gn script left models.diffusion.group_norm_act patched")
    im = ubench("int8_matmul")
    res["int8_matmul"] = im.run(im.M, im.SHAPES, dev, reps=10, card=smi)
    res["decode"] = ubench("decode").run(
        models.ar_params, models.ar_cfg, steps=8, device=dev, reps=1,
        sampler=True, card=smi)
    res["prefill"] = ubench("prefill").run(
        models.ar_params, models.ar_cfg, device=dev, reps=1, card=smi)
    res["diffusion"] = ubench("diffusion").run(
        models.diffusion_params, dcfg, device=dev, reps=1, card=smi)
    vcfg = models.vocoder_cfg
    res["vocoder"] = ubench("vocoder").run(models.vocoder_params, vcfg,
                                           device=dev, reps=1, card=smi)
    res["vocstage"] = ubench("vocstage").run(models.vocoder_params, vcfg,
                                             device=dev, runs=2, card=smi)
    res["sampler_ops"] = ubench("sampler_ops").run(32, dev, reps=1,
                                                   card=smi)
    a, c = "decode_trunk", "flash_attention_causal_qkv"
    b, e = "flash_attention_packed", "lvc_gated_residual"
    dec, pre = res["decode"], res["prefill"]["runs"]
    diff, voc = res["diffusion"], res["vocoder"]
    checks = [
        *((dec["int8"][k]["decode_launches"].get(a, 0) > 0,
           f"decode B={k}: kernel A not launched on the int8 plane")
          for k in dec["int8"]),
        *((a not in dec["bf16"][k]["decode_launches"],
           f"decode B={k}: kernel A launched on the bf16-weights plane")
          for k in dec["bf16"]),
        *((pre[k]["flash"]["launches"].get(c, 0) > 0
           and c not in pre[k]["plain"]["launches"],
           f"prefill B={k}: kernel C in flash / plain "
           f"{pre[k]['flash']['launches']} / {pre[k]['plain']['launches']}")
          for k in pre),
        (diff["flash"]["launches"].get(b, 0) > 0
         and diff["flash_no_mask"]["launches"].get(b, 0) > 0
         and set(diff["plain"]["launches"]) == {
             "group_norm_act", "int8_quantize_rows", "int8_epilogue"},
         "diffusion launches: " + ", ".join(
             f"{k} {diff[k]['launches']}"
             for k in ("flash", "plain", "flash_no_mask"))),
        (voc["fused_lvc"]["launches"].get(e, 0) > 0
         and not voc["plain_lvc"]["launches"],
         f"vocoder launches {voc['fused_lvc']['launches']} / "
         f"{voc['plain_lvc']['launches']}"),
        (res["diffstage"]["loop_busy_share"] > 0,
         f"diffstage {res['diffstage']}"),
    ]
    for ok, msg in checks:
        if not ok:
            fail(f"the microbenchmark phase: {msg}")
    ds = res["diffstage"]
    print(f"  ubench phase: {len(res)} scripts in "
          f"{time.monotonic() - t0:.1f} s; diffstage (8 steps) "
          f"{ds['ms_per_step']:.3f} ms/step, busy share "
          f"{ds['loop_busy_share']:.3f}; gn base "
          f"{res['gn']['base']['ms']:.3f} ms, decode int8 B=1 "
          f"{dec['int8']['1']['decode']['ms_per_step']:.3f} ms/step; "
          f"kernel C from B*S^2 = {res['prefill']['crossover_score']} [{smi}]")


# request 3's configuration: the diffusion fallback (32 heads of 32, so
# 6 * 32 % 128 != 0 and every attention runs kernel D1) and the fused LVC
# (kernel E on all 12 conv blocks); widths and T stay full
FALLBACK = dict(diffusion={"n_head": 32, "use_flash": True},
                vocoder={"use_pallas_lvc": True})


def run_request_3(torch, smi: str, models=None) -> dict:
    """synthesize() on the fallback + fused-LVC slice at B=1: text -> AR
    (kernel A) -> diffusion (kernel D1) -> vocoder (kernel E) -> audio,
    bf16 + int8, the jax sampler, stand-in tokens, zero voice. Returns
    the stage timings with the call's wall ("wall_s") and "rtf"."""
    import numpy as np

    from tortoise_tpu_torch.pipeline.synthesize import (
        TortoiseModels,
        synthesize,
    )
    from tortoise_tpu_torch.pipeline.vocoder_stage import audio_length

    if models is None:
        models = TortoiseModels.random(0, **FALLBACK)
    t0 = time.monotonic()
    res = synthesize(models, tokens=STANDIN_TOKENS,
                     voice=np.zeros((1024,), np.float32), seed=0,
                     compute_dtype=torch.bfloat16, int8_weights=True,
                     device="cuda")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    audio, mel = np.asarray(res.audio), np.asarray(res.mel)
    if not (np.isfinite(audio).all() and np.isfinite(mel).all()):
        fail("request 3: non-finite audio or mel")
    want = audio_length(mel.shape[-1])
    if mel.shape[0] != 100 or audio.shape != (want,):
        fail(f"request 3: mel {mel.shape}, audio {audio.shape}, want "
             f"({want},)")
    dur = len(audio) / res.sample_rate
    t = res.timings
    st = {k: round(v, 3) for k, v in t.items()}
    stages = ("autoregressive_s", "diffusion_s", "vocoder_s")
    rtf = sum(t[k] for k in stages) / dur
    print(f"  request 3 (fallback diffusion, fused LVC): mel {mel.shape}, "
          f"audio {len(audio)} samples ({dur:.2f} s); stage walls {st}; "
          f"call wall {wall:.2f} s, RTF {rtf:.3f}"
          f", AR {t['ar_decode_loop_s'] / t['ar_decode_steps'] * 1e3:.3f} "
          f"ms/step, diffusion "
          f"{t['diffusion_loop_s'] / t['diffusion_steps'] * 1e3:.3f} "
          f"ms/CFG-step [{smi}]")
    return dict(t, wall_s=wall, rtf=rtf)


def check_small_agreement(torch, launch_counts, reset_launch_counts):
    """Tiny f32 parity plane on the card vs the CPU: same decisions, on
    the default configs and on the fallback + fused-LVC configs (whose
    card run must launch kernels D1 and E)."""
    import numpy as np

    from tortoise_tpu_torch.pipeline.synthesize import (
        TortoiseModels,
        synthesize,
    )

    voice = np.random.default_rng(0).normal(0, 0.5, 64).astype(np.float32)
    toks = [3, 9, 4, 12, 7, 1, 20, 5]
    # the tiny denoiser's 4 heads of 16 take the fallback route as they are
    fused = dict(diffusion={"use_flash": True},
                 vocoder={"use_pallas_lvc": True})
    for label, cfgs in (("default", {}), ("fallback + fused LVC", fused)):
        models = TortoiseModels.random(3, tiny=True, **cfgs)
        cpu = synthesize(models, tokens=toks, voice=voice, seed=5,
                         sampler="reference", device="cpu")
        reset_launch_counts()
        gpu = synthesize(models, tokens=toks, voice=voice, seed=5,
                         sampler="reference", device="cuda")
        counts = launch_counts()
        if cfgs and not (counts["flash_attention_grouped"] > 0
                         and counts["lvc_gated_residual"] > 0):
            fail(f"tiny f32 {label}: kernels D1 and E did not run on the "
                 f"card: {counts}")
        if cpu.sequences != gpu.sequences:
            fail(f"tiny f32 {label}: token streams differ {cpu.sequences} "
                 f"vs {gpu.sequences}")
        for name in ("mel", "audio"):
            a, b = getattr(gpu, name), getattr(cpu, name)
            err = float(np.abs(a - b).max())
            rel = err / max(float(np.abs(b).max()), 1e-30)
            print(f"  tiny f32 {label} cuda vs cpu {name}: max_abs_err="
                  f"{err:.3e} rel={rel:.3e} (tol rel 1e-3)")
            if not rel <= 1e-3:
                fail(f"tiny f32 {label} {name} differs between cuda and "
                     f"cpu")


def check_small_api_flags(torch, launch_counts, reset_launch_counts):
    """The two flags the JAX package's stages take, on the card vs the
    CPU at tiny widths. qkv_f16: the AR stage on the reference sampler
    plane (f32), with the flag: same tokens, latents within 1e-3; then on
    kernel A's and C's plane (bf16 + int8, fused decode on, the flash
    prefill gate at 0; 2 heads of 64, the head width kernel A takes),
    where the flag must keep both kernels off while the same call
    without it launches both. bucketed=False: the
    diffusion stage (mt19937 noise) and the vocoder on a 9-frame latent,
    a 39-frame mel that no bucket divides, on a denoiser of 2 heads of 64
    (kernel B, the packed route) and on the fallback + fused-LVC configs
    (kernels D1 and E); each must launch its kernels, and the mel and
    audio agree within 1e-3 of the CPU's max."""
    import dataclasses

    import numpy as np

    from tortoise_tpu_torch.io.checkpoint import random_ar_params
    from tortoise_tpu_torch.pipeline import ar_stage
    from tortoise_tpu_torch.pipeline import diffusion_stage as DS
    from tortoise_tpu_torch.pipeline import vocoder_stage as VS
    from tortoise_tpu_torch.pipeline.synthesize import TortoiseModels
    from tortoise_tpu_torch.rng import ReferenceRng

    def agree(label, got, want):
        got, want = np.asarray(got), np.asarray(want)
        if got.shape != want.shape:
            fail(f"{label}: shapes {got.shape} vs {want.shape}")
        err = float(np.abs(got - want).max())
        rel = err / max(float(np.abs(want).max()), 1e-30)
        print(f"  {label} cuda vs cpu: max_abs_err={err:.3e} rel={rel:.3e} "
              f"(tol rel 1e-3)")
        if not rel <= 1e-3:
            fail(f"{label} differs between cuda and cpu")

    voice = np.random.default_rng(0).normal(0, 0.5, 64).astype(np.float32)
    toks = [3, 9, 4, 12, 7, 1, 20, 5]
    models = TortoiseModels.random(3, tiny=True)
    runs = {dev: ar_stage.autoregressive(
        models.ar_params, toks, voice, 1, models.ar_cfg, "reference", 5,
        None, None, True, device=dev) for dev in ("cpu", "cuda")}
    if runs["cpu"][1] != runs["cuda"][1]:
        fail(f"tiny qkv_f16 AR stage: token streams differ {runs['cpu'][1]} "
             f"vs {runs['cuda'][1]}")
    agree("tiny f32 qkv_f16 AR latents", runs["cuda"][0][0],
          runs["cpu"][0][0])
    # kernel A takes heads of 64: 2 heads of 64 at the tiny depth
    cfg = dataclasses.replace(models.ar_cfg, d_model=128, n_head=2,
                              d_mlp=256, fused_decode=True,
                              flash_prefill_min_score=0)
    params = random_ar_params(cfg, 3)
    voice128 = np.random.default_rng(1).normal(0, 0.5, 128).astype(
        np.float32)
    for flag in (False, True):
        reset_launch_counts()
        lat, _ = ar_stage.autoregressive(
            params, toks, voice128, 2, cfg, "reference", 5, None,
            torch.bfloat16, flag, True, device="cuda")
        c = launch_counts()
        a, cc = c["decode_trunk"], c["flash_attention_causal_qkv"]
        print(f"  tiny bf16 + int8 AR stage, qkv_f16={flag}: kernel A "
              f"{a} launches, kernel C {cc}")
        if not np.isfinite(lat[0]).all():
            fail(f"tiny bf16 + int8 qkv_f16={flag}: latents not finite")
        if flag and (a or cc):
            fail(f"qkv_f16 launched kernel A or C: {c}")
        if not flag and not (a and cc):
            fail(f"the bf16 + int8 AR stage without qkv_f16 did not "
                 f"launch kernels A and C: {c}")

    packed = dict(diffusion={"d_model": 128, "n_head": 2, "timestep_dim": 128,
                             "use_flash": True})
    fused = dict(diffusion={"use_flash": True},
                 vocoder={"use_pallas_lvc": True})
    for label, cfgs, needs in (
            ("packed (2 heads of 64)", packed, ("flash_attention_packed",)),
            ("fallback + fused LVC", fused, ("flash_attention_grouped",
                                             "lvc_gated_residual"))):
        m = TortoiseModels.random(3, tiny=True, **cfgs)
        dcfg = dataclasses.replace(m.diffusion_cfg, n_sample_timesteps=8)
        lat = np.random.default_rng(4).normal(0, 0.5, (9, dcfg.d_model))
        out = {}
        for dev in ("cpu", "cuda"):
            reset_launch_counts()
            mel = DS.diffusion(m.diffusion_params, lat, dcfg, 0,
                               ReferenceRng(4), True, None, False,
                               device=dev)
            audio = VS.vocoder(m.vocoder_params, mel, m.vocoder_cfg, 0,
                               ReferenceRng(2), None, False, device=dev)
            out[dev] = (mel, audio, launch_counts())
        c = out["cuda"][2]
        frames = out["cuda"][0].shape[1]
        total = frames + m.vocoder_cfg.mel_pad_frames
        if frames % 64 == 0 or total % 32 == 0 or any(c[k] < 1
                                                      for k in needs):
            fail(f"tiny unbucketed {label}: {frames} mel frames, {total} "
                 f"vocoder frames, launches {c}, want {needs}")
        print(f"  tiny unbucketed {label}: {frames} mel frames, {total} "
              f"vocoder frames; launches {({k: c[k] for k in needs})}")
        agree(f"tiny unbucketed {label} mel", out["cuda"][0], out["cpu"][0])
        agree(f"tiny unbucketed {label} audio", out["cuda"][1],
              out["cpu"][1])


class _HttpFront:
    """A started SynthesisServer behind its HTTP front end on 127.0.0.1
    at an ephemeral port; records the futures of the requests it takes so
    the script can read their stage walls."""

    def __init__(self, server):
        import threading

        from tortoise_tpu_torch.serve import make_http_server

        self.server = server.start()
        self.futures = []
        submit = server.submit

        def recording_submit(*a, **k):
            fut = submit(*a, **k)
            self.futures.append(fut)
            return fut

        server.submit = recording_submit
        self.httpd = make_http_server(server, "127.0.0.1", 0)
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def post(self, path, body):
        """-> (status, response, connection) with the body unread."""
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                          timeout=600)
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp, conn

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=60)
        self.server.stop()


def _voice_files(out_dir, n, d):
    import numpy as np

    paths = []
    for i in range(n):
        path = os.path.join(out_dir, f"voice{i}.bin")
        np.random.default_rng(10 + i).normal(0, 0.5, (d,)) \
            .astype(np.float32).tofile(path)
        paths.append(path)
    return paths


def _one_shot_length(models, sequence):
    from tortoise_tpu_torch.pipeline.ar_stage import trim_keep_lengths
    from tortoise_tpu_torch.pipeline.diffusion_stage import (
        mel_length_for_latents,
    )
    from tortoise_tpu_torch.pipeline.vocoder_stage import audio_length

    keep = trim_keep_lengths([sequence], models.ar_cfg)[0]
    return audio_length(mel_length_for_latents(keep), models.vocoder_cfg)


def run_request_4(torch, models, out_dir, smi, reset_launch_counts,
                  launch_counts):
    """The server at full width: 6 concurrent POST /synthesize (3 text
    lengths in the 32-bucket, 2 voices) must form ONE batch padded to 8;
    every response a WAV of its row's length with finite samples.
    Returns the launch counts of the request."""
    import threading

    import numpy as np

    from tortoise_tpu_torch.serve import SynthesisServer

    voices = _voice_files(out_dir, 2, models.ar_cfg.d_model)
    # 3 lengths x 2 voices; the two rows of one length differ in one id,
    # so every reply maps to its own row
    bodies = [{"tokens": [255, 20 + i % 2] + STANDIN_TOKENS[2:n - 1] + [0],
               "voice": voices[i % 2], "seed": 4}
              for i, n in enumerate((30, 30, 22, 22, 14, 14))]
    torch.cuda.reset_peak_memory_stats()
    front = _HttpFront(SynthesisServer(
        models, compute_dtype=torch.bfloat16, int8_weights=True,
        max_batch=8, max_wait_ms=2000, device="cuda"))
    replies = [None] * len(bodies)

    def post(i):
        status, resp, conn = front.post("/synthesize", bodies[i])
        replies[i] = (status, resp.read())
        conn.close()

    try:
        reset_launch_counts()
        t0 = time.monotonic()
        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = launch_counts()
        stats = front.server.stats()
        peak = torch.cuda.max_memory_allocated() / 2**20
    finally:
        front.close()
    if any(r is None or r[0] != 200 for r in replies):
        fail(f"request 4: not every POST /synthesize answered 200: "
             f"{[r and (r[0], r[1][:200]) for r in replies]}")
    if (stats["batches"], stats["rows"], stats["padded_rows"]) != (1, 6, 2):
        fail(f"request 4: want 1 batch of 6 rows padded to 8, stats {stats}")
    results = [f.result(timeout=60) for f in front.futures]
    by_tokens = {tuple(r.tokens): r for r in results}
    audio_s = 0.0
    for body, (_, wav) in zip(bodies, replies):
        audio = np.frombuffer(wav[44:], dtype=np.float32)
        res = by_tokens[tuple(body["tokens"])]
        want = _one_shot_length(models, res.sequences[0])
        if wav[:4] != b"RIFF" or audio.shape != (want,):
            fail(f"request 4: a reply of {len(audio)} samples, want {want}")
        if not np.isfinite(audio).all():
            fail("request 4: non-finite audio")
        audio_s += len(audio) / models.vocoder_cfg.sample_rate
    t = results[0].timings
    stages = sum(t[k] for k in ("autoregressive_s", "diffusion_s",
                                "vocoder_s"))
    print(f"  request 4 (server, 6 rows in one batch of 8): stats {stats}; "
          f"stage walls { {k: round(v, 3) for k, v in t.items()} }; "
          f"{audio_s:.2f} s of audio, per-row RTF {stages / audio_s:.4f} "
          f"(stage walls / summed audio s), AR "
          f"{t['ar_decode_loop_s'] / t['ar_decode_steps'] * 1e3:.3f} ms/step, "
          f"diffusion {t['diffusion_loop_s'] / t['diffusion_steps'] * 1e3:.3f}"
          f" ms/CFG-step; HTTP wall {wall:.2f} s; peak memory from the "
          f"warmup on {peak:.1f} MiB (step graphs on) [{smi}]")
    return counts


def run_request_5(torch, models, smi, reset_launch_counts, launch_counts):
    """POST /stream at full width with the default geometry (window 352,
    overlap 32, first window 96, margin 32) on the fused-LVC vocoder: the
    chunked body's float32 frames must have the one-shot length. Returns
    the launch counts of the request."""
    import numpy as np

    from tortoise_tpu_torch.pipeline.synthesize import synthesize
    from tortoise_tpu_torch.serve import SynthesisServer

    voice = np.random.default_rng(10).normal(
        0, 0.5, (models.ar_cfg.d_model,)).astype(np.float32)
    front = _HttpFront(SynthesisServer(
        models, compute_dtype=torch.bfloat16, int8_weights=True,
        default_voice=voice, device="cuda"))
    try:
        reset_launch_counts()
        t0 = time.monotonic()
        status, resp, conn = front.post("/stream",
                                        {"tokens": STANDIN_TOKENS, "seed": 5})
        if status != 200 or resp.getheader("Transfer-Encoding") != "chunked":
            fail(f"request 5: status {status}, {resp.read()[:200]}")
        body, first_s, n_reads = b"", None, 0
        while True:
            part = resp.read1(1 << 20)
            if not part:
                break
            body += part
            n_reads += 1
            if first_s is None and len(body) > 44:
                first_s = time.monotonic() - t0
        conn.close()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = launch_counts()
        stats = front.server.stats()
        peak = torch.cuda.max_memory_allocated() / 2**20
    finally:
        front.close()
    audio = np.frombuffer(body[44:], dtype=np.float32)
    if body[:4] != b"RIFF" or stats.get("streams_completed") != 1:
        fail(f"request 5: bad stream body or stats {stats}")
    one_shot = synthesize(models, tokens=STANDIN_TOKENS, voice=voice, seed=5,
                          compute_dtype=torch.bfloat16, int8_weights=True,
                          device="cuda")
    if audio.shape != one_shot.audio.shape or not np.isfinite(audio).all():
        fail(f"request 5: streamed {audio.shape} samples, the one-shot "
             f"path {one_shot.audio.shape}")
    dur = len(audio) / models.vocoder_cfg.sample_rate
    t = one_shot.timings
    print(f"  request 5 (POST /stream, fused LVC): {len(audio)} samples "
          f"({dur:.2f} s) in {n_reads} reads; time to first audio "
          f"{first_s:.3f} s, total wall {wall:.2f} s (RTF "
          f"{wall / dur:.4f}); then synthesize() on the same weight trees: "
          f"ar_cast_s {t['ar_cast_s']:.4f}, diffusion_cast_s "
          f"{t['diffusion_cast_s']:.4f} (cached casts) [{smi}]")
    return counts


class _NumpyStream:
    """A numpy-seeded random source standing where a stage keeps its
    torch.Generator, so the card and the CPU draw the same numbers."""

    def __init__(self, seed):
        import numpy as np

        self.rng = np.random.default_rng(seed)
        self.seed = seed


def _replay_numpy_streams(torch):
    """Route every draw of the port's stages through numpy (the seams
    make_generator, draw_uniform, draw_normal, window_generator); returns
    a function that restores them."""
    import numpy as np

    from tortoise_tpu_torch.pipeline import ar_stage, common, streaming
    from tortoise_tpu_torch.pipeline import diffusion_stage as dst
    from tortoise_tpu_torch.pipeline import vocoder_stage as vst

    def draw(kind):
        def fn(gen, shape, device):
            x = (gen.rng.random(shape, np.float32) if kind == "u"
                 else gen.rng.standard_normal(shape, np.float32))
            return torch.as_tensor(x).to(device)
        return fn

    seams = [(common, "make_generator", lambda seed, dev: _NumpyStream(seed)),
             (ar_stage, "draw_uniform", draw("u")),
             (dst, "draw_normal", draw("n")), (vst, "draw_normal", draw("n")),
             (streaming, "window_generator",
              lambda gen, i: _NumpyStream([gen.seed, i]))]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in seams]
    for mod, name, fn in seams:
        setattr(mod, name, fn)

    def restore():
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return restore


def check_small_serving_agreement(torch):
    """The tiny f32 plane's synthesize_batch (3 ragged rows, per-row
    voices) and stream_synthesize on the card against the CPU, with the
    uniforms and noise of both runs from one numpy source: the same
    tokens, mel and audio within 1e-3 relative."""
    import dataclasses

    import numpy as np

    from tortoise_tpu_torch.pipeline.streaming import (
        collect_stream,
        stream_synthesize,
    )
    from tortoise_tpu_torch.pipeline.synthesize import (
        TortoiseModels,
        synthesize_batch,
    )

    def agree(label, got, want):
        err = float(np.abs(got - want).max())
        rel = err / max(float(np.abs(want).max()), 1e-30)
        print(f"  tiny f32 {label} cuda vs cpu: max_abs_err={err:.3e} "
              f"rel={rel:.3e} (tol rel 1e-3)")
        if got.shape != want.shape or not rel <= 1e-3:
            fail(f"tiny f32 {label} differs between cuda and cpu")

    models = TortoiseModels.random(4, tiny=True)
    models.diffusion_cfg = dataclasses.replace(models.diffusion_cfg,
                                               n_sample_timesteps=20)
    rows = [[1, 5, 9, 4, 0], [1, 3, 9, 4, 12, 7, 20, 0],
            [1, 11, 2, 6, 8, 30, 17, 9, 22, 4, 0]]
    voices = np.random.default_rng(1).normal(0, 0.5, (3, 64)) \
        .astype(np.float32)
    restore = _replay_numpy_streams(torch)
    try:
        runs = {dev: synthesize_batch(models, tokens_list=rows,
                                      voices=voices, seed=6, device=dev)
                for dev in ("cpu", "cuda")}
        geom = dict(window_frames=24, overlap_frames=8,
                    first_window_frames=16, vocoder_margin=8)
        streams = {dev: list(stream_synthesize(
            models, tokens=rows[2], voice=voices[2], seed=7, device=dev,
            **geom)) for dev in ("cpu", "cuda")}
    finally:
        restore()
    for i, (g, c) in enumerate(zip(runs["cuda"], runs["cpu"])):
        if g.sequences != c.sequences:
            fail(f"tiny f32 synthesize_batch row {i}: tokens differ "
                 f"{g.sequences} vs {c.sequences}")
        agree(f"synthesize_batch row {i} mel", g.mel, c.mel)
        agree(f"synthesize_batch row {i} audio", g.audio, c.audio)
    if len(streams["cuda"]) < 2 or len(streams["cuda"]) != len(
            streams["cpu"]):
        fail(f"tiny f32 stream: {len(streams['cuda'])} chunks on the card, "
             f"{len(streams['cpu'])} on the cpu")
    agree(f"stream_synthesize ({len(streams['cuda'])} chunks) audio",
          collect_stream(streams["cuda"]), collect_stream(streams["cpu"]))


# request 6: a fresh process synthesizes from the int8 plane on disk
WARM_AUDIO_TOL = 1e-3  # relative to request 1's max |audio|; expect 0


def write_warm_plane(plane_dir) -> dict:
    """The int8 plane of TortoiseModels.random(0) at full width: AR pairs
    by quantize_ar_host, diffusion pairs by the host quantizer, the
    vocoder in f32. Returns the host walls and the plane's bytes."""
    from tortoise_tpu_torch.io.plane_cache import save_plane
    from tortoise_tpu_torch.pipeline.ar_stage import quantize_ar_host
    from tortoise_tpu_torch.pipeline.diffusion_stage import (
        quantize_diffusion_weights,
    )
    from tortoise_tpu_torch.pipeline.synthesize import TortoiseModels

    models = TortoiseModels.random(0)
    t0 = time.monotonic()
    tree = {"ar": quantize_ar_host(models.ar_params),
            "diffusion": quantize_diffusion_weights(models.diffusion_params),
            "vocoder": models.vocoder_params}
    quantize_s = time.monotonic() - t0
    t0 = time.monotonic()
    save_plane(tree, plane_dir)
    save_s = time.monotonic() - t0
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(plane_dir) for f in fs)
    return dict(quantize_s=quantize_s, save_s=save_s, bytes=size)


def warm_start_child(plane_dir, wav_path, t_spawn) -> int:
    """The fresh process of request 6: load the plane memory-mapped, build
    TortoiseModels from it, synthesize at request 1's settings (stand-in
    tokens, zero voice, seed 0, one candidate, bf16 + int8, kernel B in
    the denoiser), write the WAV, print one JSON line."""
    t_main = time.time()
    sys.path.insert(0, ROOT)
    import dataclasses

    import numpy as np
    import torch

    from tortoise_tpu_torch.config import DiffusionConfig
    from tortoise_tpu_torch.io.plane_cache import load_plane
    from tortoise_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from tortoise_tpu_torch.pipeline.synthesize import (
        TortoiseModels,
        synthesize,
    )

    torch.backends.cuda.matmul.allow_tf32 = False  # as the parent's phase 1
    torch.backends.cudnn.allow_tf32 = False
    t_imported = time.time()
    t0 = time.monotonic()
    tree = load_plane(plane_dir, mmap=True)
    load_s = time.monotonic() - t0
    if tree is None:
        fail(f"request 6: no plane at {plane_dir}")
    models = TortoiseModels(
        ar_params=tree["ar"], diffusion_params=tree["diffusion"],
        vocoder_params=tree["vocoder"],
        diffusion_cfg=dataclasses.replace(DiffusionConfig(), use_flash=True))
    reset_launch_counts()
    res = synthesize(models, tokens=STANDIN_TOKENS,
                     voice=np.zeros((1024,), np.float32), seed=0,
                     batch_size=1, compute_dtype=torch.bfloat16,
                     int8_weights=True, device="cuda")
    res.save(wav_path)
    t_wav = time.time()
    launches = launch_counts()
    jax_pkg = "tortoise_tpu"
    print(json.dumps({"warm_start": dict(
        sequences=res.sequences, launches=launches, load_s=load_s,
        timings=res.timings, imports_s=t_imported - t_main,
        start_to_main_s=t_main - t_spawn, wall_s=t_wav - t_spawn,
        jaxy=sorted(k for k in sys.modules
                    if k in ("jax", jax_pkg)
                    or k.startswith(("jax.", "jaxlib", jax_pkg + "."))))}),
          flush=True)
    return 0


def run_request_6(smi, req1) -> dict:
    """Warm start: the parent writes the int8 plane into a git-ignored
    directory of the checkout, a fresh process loads it and synthesizes
    at request 1's settings, and its tokens, audio and launches are held
    against request 1's. Returns the child's launch counts."""
    import shutil

    import numpy as np

    from tortoise_tpu_torch.io.wav import read_wav

    base = os.path.join(ROOT, "_plane_cache")
    os.makedirs(base, exist_ok=True)
    work = tempfile.mkdtemp(dir=base)
    try:
        plane = os.path.join(work, "plane")
        written = write_warm_plane(plane)
        wav = os.path.join(work, "warm.wav")
        t_spawn = time.time()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__),
             "--warm-start-child", plane, wav, repr(t_spawn)],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        spawn_wall = time.time() - t_spawn
        if proc.returncode != 0:
            fail(f"request 6: the fresh process exited {proc.returncode}: "
                 f"{proc.stderr[-2000:]}")
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith('{"warm_start"')]
        if not line:
            fail(f"request 6: no result line: {proc.stdout[-2000:]}")
        child = json.loads(line[-1])["warm_start"]
        audio, _ = read_wav(wav)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if child["jaxy"]:
        fail(f"request 6: the fresh process imported {child['jaxy'][:8]}")
    if child["sequences"] != req1.sequences:
        fail("request 6: the warm-started tokens differ from request 1's")
    want = np.asarray(req1.audio, np.float32)
    if audio.shape != want.shape or not np.isfinite(audio).all():
        fail(f"request 6: audio {audio.shape}, request 1 {want.shape}")
    err = float(np.abs(audio - want).max())
    rel = err / max(float(np.abs(want).max()), 1e-30)
    print(f"  request 6 (fresh process on the int8 plane): tokens equal "
          f"request 1's ({len(child['sequences'][0])} ids); audio "
          f"max_abs_err={err:.3e} rel={rel:.3e} (tol rel {WARM_AUDIO_TOL}; "
          f"bit-equal: {err == 0.0})")
    if not rel <= WARM_AUDIO_TOL:
        fail(f"request 6: audio differs from request 1's: rel {rel}")
    t, t1 = child["timings"], req1.timings
    st = {k: round(v, 4) for k, v in t.items()}
    print(f"  request 6: plane {written['bytes'] / 1e6:.1f} MB written in "
          f"{written['save_s']:.3f} s (host quantize "
          f"{written['quantize_s']:.3f} s); child: spawn to main "
          f"{child['start_to_main_s']:.3f} s, imports {child['imports_s']:.3f} s, load_plane "
          f"{child['load_s']:.4f} s, ar_cast_s {t['ar_cast_s']:.4f}, "
          f"diffusion_cast_s {t['diffusion_cast_s']:.4f} (request 1: "
          f"{t1['ar_cast_s']:.4f}, {t1['diffusion_cast_s']:.4f}); stage "
          f"walls {st}; process start to WAV {child['wall_s']:.3f} s "
          f"(parent's wall to exit {spawn_wall:.3f} s) [{smi}]")
    return child["launches"]


def check_parity_dry_run(out_dir) -> None:
    """python -m tortoise_tpu_torch.parity without weights: 3 SKIP and
    exit 0; with a corrupt vocoder file: FAIL and exit 1."""
    empty = os.path.join(out_dir, "parity_empty")
    bad = os.path.join(out_dir, "parity_bad")
    os.makedirs(empty)
    os.makedirs(bad)
    with open(os.path.join(bad, "ggml-vocoder-model.bin"), "wb") as f:
        f.write(b"not a ggml file!")
    for models, want_rc, want in ((empty, 0, "SKIP"), (bad, 1, "FAIL")):
        proc = subprocess.run(
            [sys.executable, "-m", "tortoise_tpu_torch.parity", "--models",
             models], cwd=ROOT, capture_output=True, text=True, timeout=300)
        n = proc.stdout.count(want)
        print(f"  parity dry run ({os.path.basename(models)}): exit "
              f"{proc.returncode}, {n} {want}")
        if proc.returncode != want_rc or n != (3 if want == "SKIP" else 1):
            fail(f"parity on {os.path.basename(models)}: exit "
                 f"{proc.returncode}, want {want_rc}: {proc.stdout[-800:]} "
                 f"{proc.stderr[-800:]}")


# requests 7 and 8: the port on a mesh (parallel/), bf16 + int8, full width
MESH_TP_TOL = 2e-2     # request 8(b) against one rank's outputs, relative
MESH_TP_STEPS = 48     # request 8(b)'s decode steps (widths stay full)
MESH_TP_DIFFUSION = 20  # request 8(b)'s denoising steps (of 80)


def _mesh_rows():
    """Request 4's stand-in texts on 8 rows (4 lengths x 2 voices; the two
    rows of a length differ in one id)."""
    import numpy as np

    rows = [[255, 20 + i % 2] + STANDIN_TOKENS[2:n - 1] + [0]
            for i, n in enumerate((30, 30, 22, 22, 14, 14, 26, 26))]
    voices = np.stack([np.random.default_rng(10 + i % 2).normal(
        0, 0.5, (1024,)).astype(np.float32) for i in range(8)])
    return rows, voices


def _mesh_kw(torch) -> dict:
    return dict(seed=0, compute_dtype=torch.bfloat16, int8_weights=True,
                device="cuda", materialize=False)


def run_request_7(torch, models, smi, reset_launch_counts, launch_counts):
    """One rank on NCCL: a world-size-1 group (FileStore in a temporary
    directory) and make_mesh(1); synthesize_batch on 8 rows with the mesh
    and without, at one seed. The sequences must be equal, the audio
    bit-equal, and the mesh run must launch A, B and C. Returns (launch
    counts, the mesh run's results)."""
    import numpy as np
    import torch.distributed as dist

    from tortoise_tpu_torch.parallel import make_mesh
    from tortoise_tpu_torch.pipeline.synthesize import synthesize_batch

    rows, voices = _mesh_rows()
    kw = _mesh_kw(torch)
    t0 = time.monotonic()
    plain = synthesize_batch(models, tokens_list=rows, voices=voices, **kw)
    torch.cuda.synchronize()
    plain_wall = time.monotonic() - t0
    with tempfile.TemporaryDirectory(dir=ROOT) as d:
        dist.init_process_group("nccl", rank=0, world_size=1,
                                init_method="file://" + os.path.join(d, "s"))
        try:
            mesh = make_mesh(1)
            reset_launch_counts()
            t0 = time.monotonic()
            meshed = synthesize_batch(models, tokens_list=rows, voices=voices,
                                      mesh=mesh, **kw)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            counts = launch_counts()
        finally:
            dist.destroy_process_group()
    if [r.sequences for r in meshed] != [r.sequences for r in plain]:
        fail("request 7: the mesh run's sequences differ from the "
             "mesh-less run's")
    err = max(float(np.abs(a.audio - b.audio).max())
              for a, b in zip(meshed, plain))
    t = meshed[0].timings
    print(f"  request 7 (make_mesh(1), NCCL, 8 rows): sequences equal the "
          f"mesh-less run's; audio max |diff| {err:.3e}; launches {counts}; "
          f"stage walls { {k: round(v, 3) for k, v in t.items()} }; wall "
          f"{wall:.2f} s (mesh-less {plain_wall:.2f} s) [{smi}]")
    if err != 0.0:
        fail(f"request 7: audio not bit-equal to the mesh-less run's: {err}")
    return counts, meshed


def _request_8_rank(rank, world, rows, voices):
    """One of request 8's two ranks, both on cuda:0, on a gloo group named
    as such (NCCL refuses two ranks on one device). (a) dp (2, 1):
    synthesize_batch on the 8 rows. (b) tp (1, 2): one prefill +
    decode_step and one denoiser eval held against this rank's own
    single-rank outputs of the same inputs, then a 2-row synthesize_batch
    cut in depth to MESH_TP_STEPS decode and MESH_TP_DIFFUSION denoising
    steps (widths stay full: every tp collective is staged through the
    host under gloo, and the 80-step run took 51 s a rank)."""
    import dataclasses

    import numpy as np
    import torch

    from tortoise_tpu_torch.models import ar
    from tortoise_tpu_torch.models import diffusion as dm
    from tortoise_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from tortoise_tpu_torch.parallel import (
        ar_param_specs,
        make_mesh,
        shard_tree,
    )
    from tortoise_tpu_torch.parallel.mesh import axis_group
    from tortoise_tpu_torch.pipeline import ar_stage
    from tortoise_tpu_torch.pipeline import diffusion_stage as dst
    from tortoise_tpu_torch.pipeline.synthesize import (
        TortoiseModels,
        synthesize_batch,
    )

    torch.backends.cuda.matmul.allow_tf32 = False  # as the parent's phase 1
    torch.backends.cudnn.allow_tf32 = False
    models = TortoiseModels.random(0, diffusion={"use_flash": True})
    kw, bf16 = _mesh_kw(torch), torch.bfloat16
    out = {}

    def timed_batch(label, m, rows, voices, mesh):
        reset_launch_counts()
        t0 = time.monotonic()
        res = synthesize_batch(m, tokens_list=rows, voices=voices, mesh=mesh,
                               **kw)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = launch_counts()
        t = res[0].timings
        print(f"rank {rank} request 8({label}): launches {counts}; stage "
              f"walls { {k: round(v, 3) for k, v in t.items()} }; wall "
              f"{wall:.2f} s", flush=True)
        return dict(sequences=[r.sequences for r in res],
                    audio=[r.audio for r in res], launches=counts,
                    wall=wall, timings=t)

    out["a"] = timed_batch("a", models, rows, voices,
                           make_mesh(2, shape=(2, 1), backend="gloo"))

    mesh = make_mesh(2, shape=(1, 2), backend="gloo")
    tp = axis_group(mesh, "tp")
    cfg = dataclasses.replace(ar_stage.size_cache(models.ar_cfg, 32),
                              fused_decode=False)
    full = ar_stage.cast_matmul_weights(models.ar_params, bf16, True, "cuda")
    local = shard_tree(dict(full, head_pack=None), ar_param_specs(mesh),
                       mesh)
    ids = torch.zeros((2, 32), dtype=torch.long, device="cuda")
    valid = torch.zeros((2, 32), dtype=torch.bool, device="cuda")
    for i, row in enumerate(rows[:2]):
        ids[i, :len(row)] = torch.as_tensor(row)
        valid[i, :len(row)] = True
    voice = torch.as_tensor(voices[:2], device="cuda")
    tok = torch.full((2,), 7, device="cuda")

    def rel(got, want):
        got, want = got.float(), want.float()
        if not bool(torch.isfinite(got).all()):
            return float("inf")
        return float((got - want).abs().max() / want.abs().max())

    l1, c1 = ar.prefill(full, cfg, ids, valid, voice, bf16)
    l2, c2 = ar.prefill(local, cfg, ids, valid, voice, bf16, tp=tp)
    d1, _ = ar.decode_step(full, cfg, c1, tok, 0, bf16)
    d2, _ = ar.decode_step(local, cfg, c2, tok, 0, bf16, tp=tp)
    dcfg = models.diffusion_cfg
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((2, dcfg.n_mel, 256), generator=g, device="cuda")
    code = 0.5 * torch.randn((2, dcfg.d_model, 256), generator=g,
                             device="cuda")
    e1 = dm.denoise(dst._prepare_params(models.diffusion_params, True,
                                        "cuda"), dcfg, x, code, 100, None,
                    None, bf16)
    e2 = dm.denoise(dst._prepare_params(models.diffusion_params, True,
                                        "cuda", mesh), dcfg, x, code, 100,
                    None, None, bf16, tp)
    out["b_rel"] = dict(prefill=rel(l2, l1), decode_step=rel(d2, d1),
                        denoise=rel(e2, e1))
    print(f"rank {rank} request 8(b) tp (1, 2) against one rank: rel "
          f"{out['b_rel']}", flush=True)
    cut = dataclasses.replace(
        models, ar_cfg=dataclasses.replace(
            models.ar_cfg, max_decode_steps=MESH_TP_STEPS),
        diffusion_cfg=dataclasses.replace(
            dcfg, n_sample_timesteps=MESH_TP_DIFFUSION))
    out["b"] = timed_batch("b", cut, rows[:2], voices[:2], mesh)
    out["b"]["lengths"] = [_one_shot_length(cut, s[0])
                           for s in out["b"]["sequences"]]
    out["b"]["finite"] = all(bool(np.isfinite(a).all())
                             for a in out["b"]["audio"])
    return out


def _rel_audio(got, want) -> float:
    import numpy as np

    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if got.shape != want.shape or not np.isfinite(got).all():
        return float("inf")
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                  1e-30)


@contextlib.contextmanager
def _as_dp_rank(n, sel):
    """Mesh-less stage calls on rows ``sel`` of an ``n``-row batch, as a
    dp rank runs them: every draw the global batch's draw cut to those
    rows, and kernel A's work split as for the global batch."""
    from tortoise_tpu_torch.models import ar
    from tortoise_tpu_torch.pipeline import ar_stage
    from tortoise_tpu_torch.pipeline import diffusion_stage as dst
    from tortoise_tpu_torch.pipeline import vocoder_stage as vst

    seams = [(ar_stage, "draw_uniform"), (dst, "draw_normal"),
             (vst, "draw_normal")]
    saved = [getattr(m, name) for m, name in seams]
    step = ar.decode_sample_step
    try:
        ar.decode_sample_step = lambda *a, **k: step(
            *a, **dict(k, split_rows=n))
        for (m, name), draw in zip(seams, saved):
            setattr(m, name, lambda g, shape, dev, draw=draw:
                    draw(g, (n,) + tuple(shape[1:]), dev)[sel])
        yield
    finally:
        ar.decode_sample_step = step
        for (m, name), draw in zip(seams, saved):
            setattr(m, name, draw)


def _dp_reference(torch, models, rows, voices, n_ranks):
    """Request 8(a)'s dp run without a mesh: each rank's rows as a batch of
    their own (the shapes its kernels see), ``_as_dp_rank``."""
    from tortoise_tpu_torch.pipeline.synthesize import synthesize_batch

    n, per = len(rows), len(rows) // n_ranks
    out = []
    for r in range(n_ranks):
        sel = slice(r * per, (r + 1) * per)
        with _as_dp_rank(n, sel):
            out += synthesize_batch(models, tokens_list=rows[sel],
                                    voices=voices[sel], **_mesh_kw(torch))
    return out


def _locate_audio_dependence(torch, models, rows, voices) -> dict:
    """Where request 8(a)'s audio parts from request 7's although its
    tokens are equal: each stage of rows 0-3 at B = 8 against the same
    rows at B = 4 (no mesh; ``_as_dp_rank``), the 4-row run given the
    8-row run's input at every stage: the AR stage's latents (its latent
    pass takes kernel C on 8 rows, the plain attention on 4), one
    denoiser eval, the whole diffusion stage on the 8-row latents, and
    the vocoder on the 8-row mel. Returns each stage's rel max |diff|
    over rows 0-3."""
    from tortoise_tpu_torch.models import diffusion as dm
    from tortoise_tpu_torch.ops.relpos import relative_position_buckets
    from tortoise_tpu_torch.pipeline import ar_stage
    from tortoise_tpu_torch.pipeline import diffusion_stage as dst
    from tortoise_tpu_torch.pipeline import vocoder_stage as vst

    bf16, n, sel = torch.bfloat16, len(rows), slice(0, 4)
    kw = dict(compute_dtype=bf16, device="cuda")

    def rel(a, b):
        a, b = a.float(), b.float()
        return float((a - b).abs().max() / b.abs().max())

    def stages(rows_, voices_, lat=None, mel=None, lens=None):
        got = {}
        lat_, keeps, _ = ar_stage.autoregressive_batch(
            models.ar_params, rows_, voices_, models.ar_cfg, seed=0,
            int8_weights=True, return_device_latents=True, **kw)
        got["latents"] = lat_
        m, lens_ = dst.diffusion_batch_device(
            models.diffusion_params, lat_ if lat is None else lat, keeps,
            models.diffusion_cfg, seed=1, int8_weights=True, **kw)
        got["mel"] = m
        got["audio"] = vst.vocoder_batch_device(
            models.vocoder_params, m if mel is None else mel,
            lens_ if lens is None else lens, models.vocoder_cfg, seed=2,
            **kw)
        return got, lens_

    whole, lens = stages(rows, voices)
    with _as_dp_rank(n, sel):
        part, _ = stages(rows[sel], voices[sel], whole["latents"][sel],
                         whole["mel"][sel], lens[sel])
    dcfg = models.diffusion_cfg
    params = dst._prepare_params(models.diffusion_params, True, "cuda")
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((2 * n, dcfg.n_mel, 256), generator=g, device="cuda")
    code = 0.5 * torch.randn((2 * n, dcfg.d_model, 256), generator=g,
                             device="cuda")
    buckets = torch.as_tensor(relative_position_buckets(
        256, dcfg.rel_pos_buckets, dcfg.rel_pos_max_distance), device="cuda")
    e8 = dm.denoise(params, dcfg, x, code, 100, buckets, None, bf16)
    e4 = dm.denoise(params, dcfg, x[:8], code[:8], 100, buckets, None, bf16)
    out = {"AR latents": rel(part["latents"], whole["latents"][sel]),
           "one denoiser eval (CFG rows 0-7 of 16)": rel(e4, e8[:8]),
           "diffusion stage on the same latents":
               rel(part["mel"], whole["mel"][sel]),
           "vocoder on the same mel": max(
               rel(torch.as_tensor(a), torch.as_tensor(b))
               for a, b in zip(part["audio"], whole["audio"][:4]))}
    print(f"  request 8(a)'s audio against request 7's, stage by stage at "
          f"B = 4 vs B = 8 on the same input (rel max |diff|): {out}")
    return out


class _StageSampler:
    """The stage's plain sampler in the form ``_firm_rows`` calls."""

    @staticmethod
    def sample_plain(logits, prev, u, sampler):
        from tortoise_tpu_torch.ops import sampling as S

        probs, ids = S.process_logits_topk(logits, prev, *sampler)
        return S.sample_from_topk_u(u, probs, ids)[:, None]


def _check_mesh_tokens(torch, models, rows, voices, want, got, label):
    """Request 8(a)'s tokens against request 7's. The first differing row
    of each rank's 4 is held at its first differing step to both batch
    shapes' logits there (request 7's 8 rows and the rank's 4, teacher
    forced on request 7's tokens), under the sampler that drew it (kernel
    A's after step 0 on its plane, else the stage's): the draw's gap to
    the nearest CDF edge; whether each shape's logits pick the token its
    run picked (then the batch shape's rounding at that edge is the
    whole difference); and the firm-row rule (the pick holds under
    Gaussian logit noise of twice the two shapes' RMS difference). A row
    the two shapes do not explain and whose draw is firm fails. Returns
    the rows whose tokens are equal."""
    from tortoise_tpu_torch.models import ar
    from tortoise_tpu_torch.ops.cuda import decode_trunk
    from tortoise_tpu_torch.pipeline import ar_stage, common

    same = [g == w for g, w in zip(got, want)]
    if all(same):
        return same
    sampler = ar_stage.normalize_sampler(None)
    cfg = ar_stage.size_cache(models.ar_cfg, 32)
    params = ar_stage.cast_matmul_weights(models.ar_params, torch.bfloat16,
                                          True, "cuda")
    # sequences are padded (start id first), so sampled id s is at s + 1
    drawn = [seq[0][1:] for seq in want]
    for r in {i // 4 * 4 + [*same[i // 4 * 4:], False].index(False)
              for i, ok in enumerate(same) if not ok}:
        w, g = want[r][0][1:], got[r][0][1:]
        s = next(i for i in range(min(len(w), len(g))) if w[i] != g[i])
        gen = common.make_generator(0, "cuda")
        for _ in range(s + 1):
            u = ar_stage.draw_uniform(gen, (8, 1), "cuda")
        logits = []
        for sel in (list(range(8)), list(range(r // 4 * 4, r // 4 * 4 + 4))):
            ids = torch.zeros((len(sel), 32), dtype=torch.long, device="cuda")
            valid = torch.zeros_like(ids, dtype=torch.bool)
            for j, i in enumerate(sel):
                ids[j, :len(rows[i])] = torch.as_tensor(rows[i])
                valid[j, :len(rows[i])] = True
            voice = torch.as_tensor(voices[sel], device="cuda")
            lg, cache = ar.prefill(params, cfg, ids, valid, voice,
                                   torch.bfloat16)
            for step in range(s):
                tok = torch.as_tensor([drawn[i][step] if step < len(
                    drawn[i]) else cfg.stop_mel_token for i in sel],
                    device="cuda")
                lg, cache = ar.decode_step(params, cfg, cache, tok, step,
                                           torch.bfloat16, split_rows=8)
            logits.append(lg[sel.index(r)][None].float())
        drew = decode_trunk if s > 0 and ar.can_fuse_sampling(
            params, cfg, torch.bfloat16, 8, sampler) else _StageSampler
        if s == 0:
            prev = torch.ones((1, 34), dtype=torch.long, device="cuda")
            prev[:, -1] = cfg.start_mel_token
        else:
            prev = torch.tensor([[w[s - 1]]], device="cuda")
        u_r = u[r:r + 1]
        rms = float((logits[0] - logits[1]).pow(2).mean().sqrt())
        gap = _cdf_gaps(torch, logits[0], prev, u_r, sampler)[0]
        picks = [int(drew.sample_plain(lg, prev, u_r, sampler)[0, 0])
                 for lg in logits]
        explained = picks == [w[s], g[s]]
        firm = bool(_firm_rows(torch, drew, logits[0], prev, u_r, sampler,
                               2 * rms)[0])
        print(f"  {label}: row {r} differs first at step {s} (tokens "
              f"{w[s]} / {g[s]}): draw gap to the CDF edge {gap:.3e}, "
              f"logit RMS diff 8 vs 4 rows {rms:.3e}, the two shapes' "
              f"logits pick {picks} (explained {explained}), firm {firm}")
        if firm and not explained:
            fail(f"{label}: row {r}'s tokens differ on a firm draw")
    return same


LOCATE_A_STEPS = 330  # past slot 320, where B = 4's second chunk begins
LOCATE_PLAIN_STEPS = 16


def _locate_batch_dependence(torch, models, rows, voices, want) -> dict:
    """Where the AR stage's per-row bits depend on B: rows 0-3 in request
    7's batch of 8 against the same rows as a batch of 4 (a dp rank's),
    on identical inputs. The prefill of each shape (kernel C runs in
    neither: B * 34^2 is under flash_prefill_min_score); then decode
    steps teacher forced on request 7's tokens, both shapes from ONE
    cache (the 8-row prefill's; the 4-row copy is its first rows):
    kernel A at B = 4 with its own split of the cache attention and with
    the 8-row batch's (``split_rows``, as a dp rank runs it), for
    LOCATE_A_STEPS steps; the plain decode_step for LOCATE_PLAIN_STEPS.
    Returns, for each, the largest |diff| of rows 0-3's logits from the
    8-row run's and the first step that differs (0.0 and None: that part
    is row-independent)."""
    import dataclasses

    from tortoise_tpu_torch.models import ar
    from tortoise_tpu_torch.pipeline import ar_stage

    bf16 = torch.bfloat16
    cfg = ar_stage.size_cache(models.ar_cfg, 32)
    params = ar_stage.cast_matmul_weights(models.ar_params, bf16, True,
                                          "cuda")
    ids = torch.zeros((8, 32), dtype=torch.long, device="cuda")
    valid = torch.zeros_like(ids, dtype=torch.bool)
    for i, row in enumerate(rows):
        ids[i, :len(row)] = torch.as_tensor(row)
        valid[i, :len(row)] = True
    voice = torch.as_tensor(voices, device="cuda")

    def diff(a, b):
        return float((a.float() - b.float()).abs().max())

    l8, c8 = ar.prefill(params, cfg, ids, valid, voice, bf16)
    l4, c4 = ar.prefill(params, cfg, ids[:4], valid[:4], voice[:4], bf16)
    out = {"prefill logits": diff(l8[:4], l4),
           "prefill cache": max(diff(c8.k[:, :4], c4.k),
                                diff(c8.v[:, :4], c4.v))}
    drawn = [seq[0][1:] for seq in want]
    for label, fused, split, steps in (
            ("kernel A, B = 4's own split", True, None, LOCATE_A_STEPS),
            ("kernel A, split as B = 8", True, 8, LOCATE_A_STEPS),
            ("plain decode_step", False, None, LOCATE_PLAIN_STEPS)):
        c = dataclasses.replace(cfg, fused_decode=fused)
        caches = [ar.KVCache(c8.k[:, :n].clone(), c8.v[:, :n].clone(),
                             c8.valid[:n].clone(), c8.length)
                  for n in (8, 4)]
        worst, first = 0.0, None
        for step in range(steps):
            tok = torch.as_tensor([d[step] for d in drawn], device="cuda")
            lg8, caches[0] = ar.decode_step(params, c, caches[0], tok, step,
                                            bf16)
            lg4, caches[1] = ar.decode_step(params, c, caches[1], tok[:4],
                                            step, bf16, split_rows=split)
            e = diff(lg8[:4], lg4)
            if e > 0 and first is None:
                first = step
            worst = max(worst, e)
        out[f"{label}, {steps} steps from one cache"] = (worst, first)
    print(f"  the AR stage's B-dependence, rows 0-3 at B = 8 vs B = 4 "
          f"(max |diff|, first differing step): {out}")
    return out


def run_request_8(torch, models, smi, req7) -> dict:
    """Two ranks on the one card (gloo): (a) dp (2, 1) must launch A and B
    on each rank and not C (4 x 535^2 is under flash_prefill_min_score),
    give request 7's tokens (a difference is held to the firm-row rule and
    to the two batch shapes' logits, ``_check_mesh_tokens``), and the
    tokens and audio of the same-shape mesh-less reference
    (``_dp_reference``) bit for bit. Kernel A, split as for the whole
    batch, must be row-independent (``_locate_batch_dependence``). The
    audio against request 7's is printed with each stage's part of the
    difference (``_locate_audio_dependence``), not held: the mesh-less
    port's audio of 4 rows already parts from that of the same rows in a
    batch of 8 (PERF.md).
    (b) tp (1, 2) within MESH_TP_TOL of one rank's outputs, finite audio
    of the vocoder's length, B and not A on each rank. Returns the ranks'
    summed launch counts."""
    from tortoise_tpu_torch.parallel.launch import run_ranks

    rows, voices = _mesh_rows()
    t0 = time.monotonic()
    ref = _dp_reference(torch, models, rows, voices, 2)
    print(f"  request 8(a)'s same-shape mesh-less reference (2 batches of 4 "
          f"rows, the global draws' rows) in {time.monotonic() - t0:.2f} s")
    with tempfile.TemporaryDirectory(dir=ROOT) as d:
        t0 = time.monotonic()
        try:
            out = run_ranks(_request_8_rank, 2, (rows, voices), workdir=d,
                            timeout=600, backend="gloo", threads=4)
        except RuntimeError as e:
            fail(f"request 8: {e}")
        wall = time.monotonic() - t0
        for r in range(2):
            with open(os.path.join(d, f"rank{r}.log")) as f:
                for line in f.read().splitlines():
                    if line.startswith(f"rank {r} "):
                        print("  " + line)
    print(f"  request 8 (2 ranks on cuda:0, gloo): (a) dp walls "
          f"{[round(o['a']['wall'], 2) for o in out]} s, (b) tp "
          f"{MESH_TP_STEPS} decode and {MESH_TP_DIFFUSION} denoising steps "
          f"(depth cut, full widths), walls "
          f"{[round(o['b']['wall'], 2) for o in out]} s; spawn to exit "
          f"{wall:.2f} s [{smi}]")
    want_seq = [r.sequences for r in req7]
    probe = _locate_batch_dependence(torch, models, rows, voices, want_seq)
    _locate_audio_dependence(torch, models, rows, voices)
    checks = []
    for r, o in enumerate(out):
        a, b = o["a"], o["b"]
        errs = [_rel_audio(x, y.audio) for x, y in zip(a["audio"], ref)]
        e7 = [_rel_audio(x, y.audio) for x, y, ok in zip(
            a["audio"], req7, _check_mesh_tokens(
                torch, models, rows, voices, want_seq, a["sequences"],
                f"request 8(a) rank {r}")) if ok]
        print(f"  request 8(a) rank {r}: {len(e7)} of 8 rows' tokens equal "
              f"request 7's" + (f", their audio rel max {max(e7):.3e}"
                                if e7 else "") +
              f"; tokens equal the same-shape reference's: "
              f"{a['sequences'] == [x.sequences for x in ref]}, audio rel "
              f"max {max(errs):.3e} against it")
        checks += [
            (a["launches"]["decode_trunk"] >= 1
             and a["launches"]["flash_attention_packed"] >= 1,
             f"request 8(a): rank {r} did not launch A and B: "
             f"{a['launches']}"),
            (a["launches"]["flash_attention_causal_qkv"] == 0,
             f"request 8(a): rank {r} launched C: {a['launches']}"),
            (a["sequences"] == [x.sequences for x in ref],
             f"request 8(a): rank {r}'s tokens differ from the same-shape "
             f"mesh-less reference's"),
            (max(errs) == 0.0,
             f"request 8(a): rank {r}'s audio differs from the same-shape "
             f"reference's: {errs}"),
            (all(v <= MESH_TP_TOL for v in o["b_rel"].values()),
             f"request 8(b): rank {r} differs from one rank's outputs by "
             f"more than {MESH_TP_TOL}: {o['b_rel']}"),
            (b["finite"] and [len(x) for x in b["audio"]] == b["lengths"],
             f"request 8(b): rank {r} audio finite {b['finite']}, lengths "
             f"{[len(x) for x in b['audio']]} want {b['lengths']}"),
            (b["launches"]["flash_attention_packed"] >= 1
             and b["launches"]["decode_trunk"] == 0,
             f"request 8(b): rank {r} must launch B and not A: "
             f"{b['launches']}")]
    split = probe[f"kernel A, split as B = 8, {LOCATE_A_STEPS} steps from "
                  f"one cache"]
    checks.append((split == (0.0, None),
                   f"request 8: kernel A at B = 4 split as B = 8 is not "
                   f"row-independent: {split}"))
    for ok, msg in checks:
        if not ok:
            fail(msg)
    return {k: sum(o[p]["launches"][k] for o in out for p in "ab")
            for k in out[0]["a"]["launches"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="after the kernel checks, profile a decode step "
                         "and a diffusion step with torch.profiler, then "
                         "stop (no result line)")
    ap.add_argument("--warm-start-child", nargs=3,
                    metavar=("PLANE", "WAV", "T_SPAWN"),
                    help=argparse.SUPPRESS)  # request 6's fresh process
    args = ap.parse_args(argv)
    if args.warm_start_child:
        plane, wav, t_spawn = args.warm_start_child
        return warm_start_child(plane, wav, float(t_spawn))
    sys.path.insert(0, ROOT)
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a card")
    try:
        from tortoise_tpu_torch.ops.cuda import (
            build,
            launch_counts,
            reset_launch_counts,
        )
    except ImportError as e:
        fail(f"tortoise_tpu_torch not found beside {__file__}: {e}")

    print("[1/6] environment", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, nvcc {build.find_nvcc()}")
    print(f"  card: {smi}; device_count {torch.cuda.device_count()}")

    print("[2/6] kernel build", flush=True)
    t0 = time.monotonic()
    lib_path = build.build()
    build.library()
    print(f"  built {os.path.relpath(lib_path, ROOT)} in "
          f"{time.monotonic() - t0:.1f} s")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas: " + line.strip())

    print("[3/6] kernels vs plain PyTorch at main-path shapes", flush=True)
    results = {}
    check_kernel_a(torch, results)
    check_kernel_b(torch, results)
    check_kernel_c(torch, results)
    check_kernel_d1(torch, results)
    check_kernel_d2(torch, results)
    check_wide_heads(torch)
    check_f32_body(torch)
    check_kernel_e(torch, results)
    check_kernel_g(torch, results)
    check_int8_product(torch, results)
    check_f32_packed_and_causal(torch, results)
    check_kernel_f(torch, results)
    ab = run_int8_ab(smi)
    if args.profile:
        print("[profile] torch.profiler", flush=True)
        profile_phase(torch)
        return 0

    pallas = "tortoise_tpu/ops/pallas/"
    kernels = {
        "A": ("fused_decode_trunk", "decode_trunk",
              "tortoise_tpu_torch/csrc/decode_trunk.cu",
              pallas + "decode_trunk.py:277"),
        "B": ("flash_attention_packed", "flash_attention_packed",
              "tortoise_tpu_torch/csrc/flash_attention.cu",
              pallas + "flash_attention.py:269"),
        "C": ("flash_attention_causal_qkv", "flash_attention_causal_qkv",
              "tortoise_tpu_torch/csrc/flash_attention.cu",
              pallas + "flash_attention.py:441"),
        "D1": ("flash_attention (grouped band-bias body)",
               "flash_attention_grouped",
               "tortoise_tpu_torch/csrc/flash_attention.cu",
               pallas + "flash_attention.py:154"),
        "D2": ("flash_attention (generic body)", "flash_attention_generic",
               "tortoise_tpu_torch/csrc/flash_attention.cu",
               pallas + "flash_attention.py:549"),
        "E": ("lvc_gated_residual", "lvc_gated_residual",
              "tortoise_tpu_torch/csrc/lvc.cu", pallas + "lvc.py:50"),
        "F": ("flash_packed_i8", "flash_packed_i8",
              "tortoise_tpu_torch/csrc/flash_attention_int8.cu",
              "scripts/ubench_attn_int8_ab.py:100"),
        # kernel B on an f32 qkv (request 9): the split-TF32 body, counted
        # by the body's own launcher as well as by B
        "Bf": ("flash_attention_packed (f32 qkv: split-TF32 body)",
               "flash_attention_f32",
               "tortoise_tpu_torch/csrc/flash_attention_bhtd.cu",
               pallas + "flash_attention.py:269"),
        # no Pallas kernel: XLA fuses group_norm_tc and the chain after it
        "G": ("group_norm_act", "group_norm_act",
              "tortoise_tpu_torch/csrc/group_norm.cu", None),
        # no Pallas kernel: XLA fuses the int8 product's glue
        "Q8": ("int8_product (row quantize)", "int8_quantize_rows",
               "tortoise_tpu_torch/csrc/int8_product.cu", None),
        "E8": ("int8_product (epilogue)", "int8_epilogue",
               "tortoise_tpu_torch/csrc/int8_product.cu", None),
    }
    # each request is one path: counts set to 0 just before it, read just
    # after. Kernels every request of its path must launch, and kernels
    # it must not launch:
    needs = {1: ("A", "B", "G", "Q8", "E8"), 2: ("A", "B", "C", "G", "Q8",
                                                 "E8"),
             3: ("A", "D1", "E", "G"), 4: ("A", "B", "C", "G"),
             5: ("A", "B", "E", "G"), 6: ("A", "B", "G"),
             7: ("A", "B", "C", "G"), 8: ("A", "B", "G"),
             9: ("B", "Bf", "G"), 10: ("A", "B", "C", "G"),
             11: ("A", "B", "G")}
    print("[4/6] end to end at full production width (random weights, "
          "bf16 + int8)", flush=True)
    per_request = {}
    with tempfile.TemporaryDirectory(dir=ROOT) as out_dir:
        req = {}
        for r, batch_size in ((1, 1), (2, 8)):
            reset_launch_counts()
            req[r] = run_request(torch, batch_size, out_dir, smi)
            per_request[r] = launch_counts()
        # the stage loops as step graphs against the eager loops
        t_graphs = time.monotonic()
        check_graph_loops(torch, smi, reset_launch_counts, launch_counts)
        print(f"  graph-loop phase wall {time.monotonic() - t_graphs:.1f} s")
        reset_launch_counts()
        run_request_3(torch, smi)
        per_request[3] = launch_counts()
        # the serving path: one padded server batch, then one stream on
        # the same weights with the fused-LVC vocoder
        import dataclasses

        from tortoise_tpu_torch.pipeline.synthesize import TortoiseModels

        models = TortoiseModels.random(0, diffusion={"use_flash": True})
        per_request[4] = run_request_4(torch, models, out_dir, smi,
                                       reset_launch_counts, launch_counts)
        per_request[5] = run_request_5(
            torch, dataclasses.replace(models, vocoder_cfg=dataclasses.replace(
                models.vocoder_cfg, use_pallas_lvc=True)), smi,
            reset_launch_counts, launch_counts)
        # the warm start: its launches are counted in the child
        per_request[6] = run_request_6(smi, req[1])
        check_parity_dry_run(out_dir)
        # the mesh: one rank on NCCL, then two ranks on the card (gloo)
        t_mesh = time.monotonic()
        per_request[7], req[7] = run_request_7(
            torch, models, smi, reset_launch_counts, launch_counts)
        per_request[8] = run_request_8(torch, models, smi, req[7])
        print(f"  requests 7-8 (mesh) wall {time.monotonic() - t_mesh:.1f} s "
              f"[{smi}]")
        # the CLI on its default f32 plane: kernel B on the split-TF32 body
        per_request[9] = run_request_9(torch, models, out_dir, smi,
                                       reset_launch_counts, launch_counts)
        # the load test on the same weights
        per_request[11] = run_request_11(torch, models, smi,
                                         reset_launch_counts, launch_counts)
        # the port's benchmark in its own process: this one's casts go
        from tortoise_tpu_torch.pipeline.common import clear_cast_cache

        clear_cast_cache()
        torch.cuda.empty_cache()
        per_request[10] = run_request_10(smi)
    for r, c in per_request.items():
        print(f"  launches, request {r}: {c}")
        for key in needs[r]:
            if c[kernels[key][1]] < 1:
                fail(f"request {r} did not launch kernel {key}")
        if c["flash_packed_i8"] or c["int8_quantize_kv"]:
            fail(f"request {r} launched kernel F, which no request's path "
                 f"runs: {c}")
    c3 = per_request[3]
    if c3["flash_attention_packed"] != 0:
        fail(f"request 3 launched kernel B: {c3}")
    if c3["lvc_gated_residual"] != 12:
        fail(f"request 3 launched kernel E {c3['lvc_gated_residual']} "
             f"times, want 12 (4 conv blocks x 3 stages)")
    counts = {k: sum(c[w] for c in per_request.values())
              for k, (_, w, _, _) in kernels.items()}
    counts["F"] = ab["launches"]["flash_packed_i8"]  # F's path: the A/B

    print("[5/6] the per-layer microbenchmarks (scripts/torch_ubench_*.py, "
          "cut reps)", flush=True)
    run_ubench_phase(torch, models, smi, reset_launch_counts)
    del models
    clear_cast_cache()
    torch.cuda.empty_cache()

    print("[6/6] small-input agreement (tiny f32 plane, cuda vs cpu)",
          flush=True)
    check_small_agreement(torch, launch_counts, reset_launch_counts)
    check_small_api_flags(torch, launch_counts, reset_launch_counts)
    check_small_serving_agreement(torch)

    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[k], **results[k]}
        for k, (name, _, src, rep) in kernels.items()]}
    print(json.dumps(line))
    print(smi)
    jax_pkg = "tortoise_tpu"  # the JAX package (the port is its sibling)
    jaxy = sorted(k for k in sys.modules
                  if k in ("jax", jax_pkg)
                  or k.startswith(("jax.", "jaxlib", jax_pkg + ".")))
    if jaxy:
        fail(f"JAX or the JAX package was imported: {jaxy[:8]}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
