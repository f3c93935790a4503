#!/usr/bin/env python3
"""Smoke check of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure exits nonzero before the result line):

1. environment: torch/CUDA versions, nvcc, the card's name and power limit;
   TF32 is turned off for matmuls and cuDNN so f32 checks are true f32;
2. build: compiles ``tortoise_tpu_torch/csrc/*.cu`` for sm_90a;
3. kernels: each hand-written kernel (A decode trunk, B packed attention,
   C causal qkv attention, D1/D2 strided attention, E fused LVC) against
   its plain PyTorch version at the shapes the main paths give it, with
   the stated tolerance (2e-2 relative for bf16 outputs, 1e-4 for E's
   f32), and the time of both (CUDA events, after warm-up); D1 also
   against kernel B on one qkv, and B and C at head width 128; the
   serving shapes: A on ragged rows at B = 4 and 16, B at a stream
   window (8, 384) and on a
   batch's ragged CFG rows, E at a 32-frame chunk;
4. end to end at full production width (random weights, bf16 + int8,
   stand-in tokens), five requests, each with the launch counts set to 0
   before it and read after it: request 1 through the CLI at
   --batch-size 1 must launch kernels A and B, request 2 at --batch-size
   8 must also launch kernel C (the latent pass); request 3, synthesize()
   with the diffusion fallback config (32 heads of 32) and the fused LVC,
   must launch A, D1 and E (12 times) and not B; request 4, six
   concurrent POST /synthesize to the HTTP server, must form one batch
   padded to 8 and launch A, B and C; request 5, one POST /stream on the
   fused-LVC vocoder, must launch A, B and E and stream the one-shot
   length; the audio must be finite and of the vocoder's length for its
   mel;
5. small-input agreement: the tiny f32 parity plane on the card against
   the same run on the CPU (same tokens, mel and audio within tolerance),
   on the default configs and on the fallback + fused-LVC configs; then
   synthesize_batch (3 ragged rows) and stream_synthesize with the
   random draws of both runs from one numpy source.

The line before the last is ``{"kernels": [...]}``, preceded by the
card's name and power limit; the last line is
``{"ok": true, "device": {...}}``. ``--profile`` instead profiles a
decode step and a diffusion step after phase 3 (device time by kernel,
idle share; traces under ``chiprun_out/``) and stops without a result
line.
"""

from __future__ import annotations

import argparse
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
                    print(f"  A {label} tokens kernel={tok_k} plain={tok_p}")
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
    print(f"  A decode step (B=1, C=640, head+sampler): kernel "
          f"{timing[0]:.3f} ms, plain {timing[1]:.3f} ms")
    results["A"] = dict(max_abs_err=worst, ms=timing[0], plain_ms=timing[1])


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
    with one utterance (rows 1 and 5) shorter."""
    from tortoise_tpu_torch.ops.cuda import flash_attention as K

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    H, worst, tol = 16, 0.0, 2e-2
    table = torch.randn((32, H), generator=g, device=dev) * 0.3
    timing = None
    for b, t, n_valid in ((2, 2176, None), (2, 1000, 937), (8, 384, None),
                          (8, 2176, 1813)):
        qkv = torch.randn((b, t, 3 * H * 64), generator=g,
                          device=dev).to(torch.bfloat16)
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
        print(f"  B ({b}, {t}) valid={n_valid}: max_abs_err={err:.3e} "
              f"rel={rel:.3e} (tol rel {tol})")
        if not rel <= tol:
            fail(f"kernel B disagrees at T={t}: rel {rel}")
        if timing is None:
            timing = (
                cuda_ms(torch, lambda: K.flash_attention_packed(
                    qkv, H, valid, bias_vec=bias_vec)),
                cuda_ms(torch, lambda: K.flash_attention_packed_plain(
                    qkv, H, valid, bias_vec), iters=3))
    print(f"  B (2, 2176) x 16 heads: kernel {timing[0]:.3f} ms, plain "
          f"{timing[1]:.3f} ms")
    results["B"] = dict(max_abs_err=worst, ms=timing[0], plain_ms=timing[1])


def check_kernel_c(torch, results):
    """Kernel C: the AR latent pass at --batch-size 8, S = 535 with a
    text bucket of 32 holding 30 real ids."""
    from tortoise_tpu_torch.ops.cuda import flash_attention as K

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    b, H, s, tol = 8, 16, 535, 2e-2
    qkv = torch.randn((b, s, 3 * H * 64), generator=g,
                      device=dev).to(torch.bfloat16)
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
    print(f"  C (8, 535) x 16 heads: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms")
    results["C"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def _check(torch, name, got, want, tol, worst):
    err, rel = rel_err(torch, got, want)
    print(f"  {name}: max_abs_err={err:.3e} rel={rel:.3e} (tol rel {tol})")
    if not rel <= tol:
        fail(f"{name} disagrees: rel {rel}")
    return max(worst, err)


def _views(qkv, h, d):
    """(B, H, T, D) q, k, v views of a per-head-interleaved qkv."""
    b, t, _ = qkv.shape
    x = qkv.view(b, t, h, 3, d)
    return tuple(x[:, :, :, p].transpose(1, 2) for p in range(3))


def check_kernel_d1(torch, results):
    """Kernel D1, the denoiser's fallback attention: 32 heads of 32 over
    strided views of the (2, 2176, 3072) bf16 qkv, unmasked and masked;
    then 16 heads of 64 held against kernel B on the same qkv."""
    from tortoise_tpu_torch.ops.cuda import flash_attention as K

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    t, worst, tol, timing = 2176, 0.0, 2e-2, None
    for h, d in ((32, 32), (16, 64)):
        qkv = torch.randn((2, t, 3 * h * d), generator=g,
                          device=dev).to(torch.bfloat16)
        q, k, v = _views(qkv, h, d)
        kw = dict(bias_table=torch.randn((32, h), generator=g,
                                         device=dev) * 0.3,
                  bias_formula=True)
        for n_valid in (None, 1900):
            valid = None
            if n_valid is not None:
                valid = torch.arange(t, device=dev)[None, :] < torch.tensor(
                    [[t], [n_valid]], device=dev)
            got = K.flash_attention(q, k, v, None, valid, **kw)
            want = K.flash_attention_plain(q, k, v, None, valid, **kw)
            torch.cuda.synchronize()
            worst = _check(torch, f"D1 ({h} x {d}) valid={n_valid}", got,
                           want, tol, worst)
            if n_valid is None:
                unmasked = got
            if h == 32 and n_valid is None:
                timing = (
                    cuda_ms(torch, lambda: K.flash_attention(
                        q, k, v, None, valid, **kw)),
                    cuda_ms(torch, lambda: K.flash_attention_plain(
                        q, k, v, None, valid, **kw), iters=3))
        if h == 16:
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
    print(f"  D1 (2, 2176) x 32 heads of 32: kernel {timing[0]:.3f} ms, "
          f"plain {timing[1]:.3f} ms")
    results["D1"] = dict(max_abs_err=worst, ms=timing[0], plain_ms=timing[1])


def check_kernel_d2(torch, results):
    """Kernel D2, the generic body: causal with a key mask at the AR
    latent pass's shape (8, 16, 535, 64), and the bucket-bias mode at
    (2, 16, 1000, 64) with a ragged row."""
    from tortoise_tpu_torch.ops.cuda import flash_attention as K
    from tortoise_tpu_torch.ops.relpos import relative_position_buckets

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    worst, tol = 0.0, 2e-2

    def qkv_of(b, h, t):
        return tuple(torch.randn((b, h, t, 64), generator=g, device=dev)
                     .to(torch.bfloat16) for _ in range(3))

    q, k, v = qkv_of(8, 16, 535)
    valid = torch.ones((8, 535), dtype=torch.bool, device=dev)
    valid[:, 1 + 30:1 + 32] = False
    got = K.flash_attention(q, k, v, None, valid, causal=True)
    want = K.flash_attention_plain(q, k, v, None, valid, causal=True)
    torch.cuda.synchronize()
    worst = _check(torch, "D2 causal (8, 16, 535, 64)", got, want, tol,
                   worst)
    ms = cuda_ms(torch, lambda: K.flash_attention(q, k, v, None, valid,
                                                  causal=True))
    plain_ms = cuda_ms(torch, lambda: K.flash_attention_plain(
        q, k, v, None, valid, causal=True), iters=3)

    q, k, v = qkv_of(2, 16, 1000)
    valid = torch.arange(1000, device=dev)[None, :] < torch.tensor(
        [[1000], [937]], device=dev)
    kw = dict(bias_buckets=torch.as_tensor(relative_position_buckets(1000),
                                           device=dev),
              bias_table=torch.randn((32, 16), generator=g, device=dev) * .3)
    got = K.flash_attention(q, k, v, None, valid, **kw)
    want = K.flash_attention_plain(q, k, v, None, valid, **kw)
    torch.cuda.synchronize()
    worst = _check(torch, "D2 bucket bias (2, 16, 1000, 64)", got, want,
                   tol, worst)
    ms_b = cuda_ms(torch, lambda: K.flash_attention(q, k, v, None, valid,
                                                    **kw))
    print(f"  D2 causal (8, 16, 535, 64): kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms; bucket bias (2, 16, 1000, 64): kernel "
          f"{ms_b:.3f} ms")
    results["D2"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms)


def check_wide_heads(torch):
    """Kernels B and C at head width 128 (8 heads of a 1024 width): their
    wrappers run kernel D on strided views of the same qkv."""
    from tortoise_tpu_torch.ops.cuda import flash_attention as K

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    qkv = torch.randn((2, 2176, 3 * 1024), generator=g,
                      device=dev).to(torch.bfloat16)
    bias_vec = K.relpos_bias_vector(
        torch.randn((32, 8), generator=g, device=dev) * 0.3, 2176)
    _check(torch, "B at 8 heads of 128 (2, 2176)",
           K.flash_attention_packed(qkv, 8, bias_vec=bias_vec),
           K.flash_attention_packed_plain(qkv, 8, None, bias_vec), 2e-2, 0.0)
    ms_b = cuda_ms(torch, lambda: K.flash_attention_packed(
        qkv, 8, bias_vec=bias_vec))
    qkv = torch.randn((8, 535, 3 * 1024), generator=g,
                      device=dev).to(torch.bfloat16)
    valid = torch.ones((8, 535), dtype=torch.bool, device=dev)
    valid[:, 31:33] = False
    _check(torch, "C at 8 heads of 128 (8, 535)",
           K.flash_attention_causal_qkv(qkv, 8, valid),
           K.flash_attention_causal_qkv_plain(qkv, 8, valid), 2e-2, 0.0)
    ms_c = cuda_ms(torch, lambda: K.flash_attention_causal_qkv(qkv, 8,
                                                                valid))
    print(f"  head width 128: B route {ms_b:.3f} ms, C route {ms_c:.3f} ms")


def check_kernel_e(torch, results):
    """Kernel E at the three vocoder stages for 500 latents (M = 2186
    frames in a 2208 bucket; hops 8, 64, 256; one conv block's slice of
    the stacked predicted kernels), timed; then at a stream chunk's
    smallest width, one 32-frame bucket, at each hop."""
    from tortoise_tpu_torch.ops.cuda import lvc as K

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    L, worst, tol, ms, plain_ms = 2208, 0.0, 1e-4, 0.0, 0.0
    for hop in (8, 64, 256):
        t = L * hop
        x = torch.randn((1, 32, t), generator=g, device=dev)
        kern = torch.randn((1, 4, 32, 64, 3, L), generator=g,
                           device=dev) * 0.1
        bias = torch.randn((1, 64, L), generator=g, device=dev)
        res = torch.randn((1, 32, t), generator=g, device=dev)
        args = (x, kern[:, 1], bias, res, hop)
        got = K.lvc_gated_residual(*args)
        want = K.lvc_gated_residual_plain(*args)
        torch.cuda.synchronize()
        worst = _check(torch, f"E hop {hop} (1, 32, {t})", got, want, tol,
                       worst)
        k_ms = cuda_ms(torch, lambda: K.lvc_gated_residual(*args))
        p_ms = cuda_ms(torch, lambda: K.lvc_gated_residual_plain(*args))
        print(f"  E hop {hop}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms")
        ms, plain_ms = ms + k_ms, plain_ms + p_ms
        del x, kern, bias, res, args, got, want
    for hop in (8, 64, 256):
        L = 32
        args = (torch.randn((1, 32, L * hop), generator=g, device=dev),
                torch.randn((1, 32, 64, 3, L), generator=g, device=dev) * .1,
                torch.randn((1, 64, L), generator=g, device=dev),
                torch.randn((1, 32, L * hop), generator=g, device=dev), hop)
        worst = _check(torch, f"E hop {hop} (1, 32, {L * hop}), L = {L}",
                       K.lvc_gated_residual(*args),
                       K.lvc_gated_residual_plain(*args), tol, worst)
    print(f"  E one conv block per stage: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms")
    results["E"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms)


def run_request(torch, batch_size: int, out_dir: str, smi: str):
    from tortoise_tpu_torch import cli
    from tortoise_tpu_torch.pipeline.vocoder_stage import audio_length

    out = os.path.join(out_dir, f"request_b{batch_size}.wav")
    argv = ["--random-weights", "--bf16", "--int8-weights", "--seed", "0",
            "--batch-size", str(batch_size), "--tokens",
            ",".join(map(str, STANDIN_TOKENS)), "--output", out]
    t0 = time.monotonic()
    res = cli.run(argv)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    import numpy as np

    audio, mel = np.asarray(res.audio), np.asarray(res.mel)
    if not (np.isfinite(audio).all() and np.isfinite(mel).all()):
        fail(f"request b={batch_size}: non-finite audio or mel")
    want = audio_length(mel.shape[-1])
    if mel.shape[0] != 100 or audio.shape != (want,):
        fail(f"request b={batch_size}: mel {mel.shape}, audio "
             f"{audio.shape}, want ({want},)")
    dur = len(audio) / res.sample_rate
    t = res.timings
    st = {k: round(v, 3) for k, v in t.items()}
    print(f"  request b={batch_size}: {len(res.sequences)} candidates, "
          f"mel {mel.shape}, audio {len(audio)} samples ({dur:.2f} s); "
          f"stage walls {st}; call wall {wall:.2f} s, RTF "
          f"{sum(t[k] for k in cli.STAGES) / dur:.3f}, AR "
          f"{t['ar_decode_loop_s'] / t['ar_decode_steps'] * 1e3:.3f} "
          f"ms/step, diffusion "
          f"{t['diffusion_loop_s'] / t['diffusion_steps'] * 1e3:.3f} "
          f"ms/CFG-step [{smi}]")


# request 3's configuration: the diffusion fallback (32 heads of 32, so
# 6 * 32 % 128 != 0 and every attention runs kernel D1) and the fused LVC
# (kernel E on all 12 conv blocks); widths and T stay full
FALLBACK = dict(diffusion={"n_head": 32, "use_flash": True},
                vocoder={"use_pallas_lvc": True})


def run_request_3(torch, smi: str):
    """synthesize() on the fallback + fused-LVC slice at B=1: text -> AR
    (kernel A) -> diffusion (kernel D1) -> vocoder (kernel E) -> audio,
    bf16 + int8, the jax sampler, stand-in tokens, zero voice."""
    import numpy as np

    from tortoise_tpu_torch.pipeline.synthesize import (
        TortoiseModels,
        synthesize,
    )
    from tortoise_tpu_torch.pipeline.vocoder_stage import audio_length

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
    print(f"  request 3 (fallback diffusion, fused LVC): mel {mel.shape}, "
          f"audio {len(audio)} samples ({dur:.2f} s); stage walls {st}; "
          f"call wall {wall:.2f} s, RTF {sum(t[k] for k in stages) / dur:.3f}"
          f", AR {t['ar_decode_loop_s'] / t['ar_decode_steps'] * 1e3:.3f} "
          f"ms/step, diffusion "
          f"{t['diffusion_loop_s'] / t['diffusion_steps'] * 1e3:.3f} "
          f"ms/CFG-step [{smi}]")


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
          f" ms/CFG-step; HTTP wall {wall:.2f} s [{smi}]")
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="after the kernel checks, profile a decode step "
                         "and a diffusion step with torch.profiler, then "
                         "stop (no result line)")
    args = ap.parse_args(argv)
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

    print("[1/5] environment", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, nvcc {build.find_nvcc()}")
    print(f"  card: {smi}; device_count {torch.cuda.device_count()}")

    print("[2/5] kernel build", flush=True)
    t0 = time.monotonic()
    lib_path = build.build()
    build.library()
    print(f"  built {os.path.relpath(lib_path, ROOT)} in "
          f"{time.monotonic() - t0:.1f} s")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas: " + line.strip())

    print("[3/5] kernels vs plain PyTorch at main-path shapes", flush=True)
    results = {}
    check_kernel_a(torch, results)
    check_kernel_b(torch, results)
    check_kernel_c(torch, results)
    check_kernel_d1(torch, results)
    check_kernel_d2(torch, results)
    check_wide_heads(torch)
    check_kernel_e(torch, results)
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
               "tortoise_tpu_torch/csrc/flash_attention_bhtd.cu",
               pallas + "flash_attention.py:154"),
        "D2": ("flash_attention (generic body)", "flash_attention_generic",
               "tortoise_tpu_torch/csrc/flash_attention_bhtd.cu",
               pallas + "flash_attention.py:549"),
        "E": ("lvc_gated_residual", "lvc_gated_residual",
              "tortoise_tpu_torch/csrc/lvc.cu", pallas + "lvc.py:50"),
    }
    # each request is one path: counts set to 0 just before it, read just
    # after. Kernels every request of its path must launch, and kernels
    # it must not launch:
    needs = {1: ("A", "B"), 2: ("A", "B", "C"), 3: ("A", "D1", "E"),
             4: ("A", "B", "C"), 5: ("A", "B", "E")}
    print("[4/5] end to end at full production width (random weights, "
          "bf16 + int8)", flush=True)
    per_request = {}
    with tempfile.TemporaryDirectory(dir=ROOT) as out_dir:
        for r, batch_size in ((1, 1), (2, 8)):
            reset_launch_counts()
            run_request(torch, batch_size, out_dir, smi)
            per_request[r] = launch_counts()
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
        models = dataclasses.replace(models, vocoder_cfg=dataclasses.replace(
            models.vocoder_cfg, use_pallas_lvc=True))
        per_request[5] = run_request_5(torch, models, smi,
                                       reset_launch_counts, launch_counts)
    for r, c in per_request.items():
        print(f"  launches, request {r}: {c}")
        for key in needs[r]:
            if c[kernels[key][1]] < 1:
                fail(f"request {r} did not launch kernel {key}")
    c3 = per_request[3]
    if c3["flash_attention_packed"] != 0:
        fail(f"request 3 launched kernel B: {c3}")
    if c3["lvc_gated_residual"] != 12:
        fail(f"request 3 launched kernel E {c3['lvc_gated_residual']} "
             f"times, want 12 (4 conv blocks x 3 stages)")
    counts = {k: sum(c[w] for c in per_request.values())
              for k, (_, w, _, _) in kernels.items()}

    print("[5/5] small-input agreement (tiny f32 plane, cuda vs cpu)",
          flush=True)
    check_small_agreement(torch, launch_counts, reset_launch_counts)
    check_small_serving_agreement(torch)

    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[k], **results[k]}
        for k, (name, _, src, rep) in kernels.items()]}
    print(json.dumps(line))
    print(smi)
    if "jax" in sys.modules:
        fail("jax was imported")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
