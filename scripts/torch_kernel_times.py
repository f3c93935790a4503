#!/usr/bin/env python3
"""The port's kernel timer: device and host times of every hand-written
kernel on one NVIDIA card, at the shapes the main paths give it, beside
its plain twin, the one PyTorch call that computes an attention kernel's
function (``F.scaled_dot_product_attention``, "SDPA") and its bound. It
times the tortoise_tpu_torch of the checkout at --root (this one by
default), at this script's shapes and inputs, so two checkouts compare
inside one call, in turns (parent, change, change, parent):

    python3 scripts/torch_kernel_times.py --root _archive/parent --label parent
    python3 scripts/torch_kernel_times.py --label change

Every line of output is one JSON object with the label and the card's
name and power limit. The first has the build (seconds, and ptxas's
register and spill report of every kernel; both near 0 and empty when
the checkout's library was built already); then one line a kernel and
shape: ``ms`` (device time a call: CUDA events over 10 calls queued
behind a device sleep, so the events read the device and not the host's
enqueue), ``host_us`` (the wrapper's host time a call: 50 calls enqueued
without a sync), and where they apply ``plain_ms`` (the plain twin),
``sdpa_ms`` and ``bound_ms`` / ``bound_by`` (``bound``). Rows, as
PERF.md's kernel table names them: A at B = 1 and 16; B, B128, C, C128
(heads of 64 and of 128); D1 (with B on the same qkv at 16 heads of
64); each D2 mode; Bf, Cf, Df2, Df1 and the f32 D2 modes (split-TF32
body; ``fma_bound_ms`` beside its bound); E per hop; F (its quantize
pass and attention kernel alone, B on the same qkv, the design's floor);
G; Q8 and E8 with the whole int8 product at the denoiser's shapes.

--profile adds torch.profiler over kernel A's decode step and a 3-step
full-width denoising run (device time by kernel, idle share; with
TORTOISE_TRACE_DIR set, as for the CLI, their Chrome traces there), then
kernel A's own timeline per layer phase
(its tt_decode_set_trace hook). --plane-upload N times the int8 plane of
TortoiseModels.random(0) instead of the kernels: its casts (first, then
after clear_cast_cache) and its upload three ways, N rounds.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

B_SHAPE = (2, 2176, 16)  # (2B CFG rows, T, heads of 64): the denoiser's
C_SHAPE = (8, 16, 535)  # (b, heads, S): the AR latent pass at batch 8
# D1: (b, t, heads, head width, key masks), the fallback's 32 heads of 32
D1_CASES = ((2, 2176, 32, 32, (None, 1900)), (2, 1000, 32, 32, (937,)),
            (16, 1000, 32, 32, ("ragged",)), (2, 2176, 16, 64, (None,)))
# D2 at head width 64: (mode, b, heads, Tq, Tkv); the first is the AR
# latent pass's shape at batch 8, causal with a key mask
D2_CASES = (("causal", 8, 16, 535, 535), ("buckets", 2, 16, 1000, 1000),
            ("materialized", 2, 16, 1000, 1000),
            ("unequal", 2, 16, 256, 1000),
            ("causal_formula", 2, 16, 1000, 1000))
# f32 inputs on the split-TF32 body: (route, b, heads, T, D) on views of
# a packed qkv, and (b, heads, Tq, Tkv) past a whole-Tkv window
FMA_CASES = (("D2", 8, 16, 535, 64), ("D1", 2, 32, 2176, 32))
F32_LONG = (2, 16, 256, 8192)
# E: (L, batch rows) at each hop: 500 latents' 2208 bucket, a stream
# chunk, the ragged 2186 frames, then two batch rows
E_CASES = ((2208, 1), (32, 1), (2186, 1), (2208, 2), (32, 2))
E_HOPS = (8, 64, 256)
F_SHAPE = (2, 2176, 16, 64)  # F: the A/B's (b, t, heads, head width)
# G: the denoiser's CFG map (b, t, channels, groups), its last 40 frames
# padded; the chains of res_out_norm (mask, FiLM, SiLU) and attn_norm
G_SHAPE = (2, 2176, 1024, 32)
G_PADDED = 40
G_CHAINS = (("res_out_norm", "rows", True), ("attn_norm", None, False))
# Q8 and E8: the int8 denoiser's products at G_SHAPE's rows: (name, K, N,
# padding) of qkv, proj (and res_in_conv), the integrating product and
# res_out_conv
I8_CASES = (("qkv", 1024, 3072, 0), ("proj", 1024, 1024, 0),
            ("integrating", 2048, 1024, 0), ("res_out_conv", 1024, 1024, 1))

# published peaks of one H100 SXM (NVIDIA's data sheet; dense rates) and
# the MUFU's exp rate: 132 SMs x 16 exp2 a clock x 1.98 GHz boost clock
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12
INT8_OPS = 1979e12
MUFU_EXPS = 132 * 16 * 1.98e9


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
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


def host_us(torch, fn, n: int = 50) -> float:
    """Host microseconds a call, the calls enqueued back to back (the
    queue is deep enough that none of them waits for the device)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def rel_err(torch, got, want) -> tuple:
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        return float("inf"), float("inf")
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1e-30)


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
    return dict(bound_ms=parts[by] * 1e3,
                bound_by="bytes" if by == "bytes" else "operations")


def f32_bound(n_bytes, d, pairs) -> dict:
    """The split-TF32 body's bound: three TF32 products a product (3 x 4D
    FLOPs a pair) at 495 TFLOP/s, the exps and the bytes; and, beside it
    as ``fma_bound_ms``, the same work as f32 FMAs at 67 TFLOP/s."""
    tf = bound(n_bytes, flops=12.0 * d * pairs, flop_rate=TF32_FLOPS,
               exps=pairs)
    fma = bound(n_bytes, flops=4.0 * d * pairs, flop_rate=F32_FLOPS,
                exps=pairs)
    return dict(tf, fma_bound_ms=fma["bound_ms"])


def sdpa_ms(torch, q, k, v, add) -> dict:
    """The one PyTorch call that computes an attention kernel's function:
    scaled_dot_product_attention on the same (B, H, T, D) views with the
    bias, key mask and causal mask pre-built as one float attn_mask
    outside the timed region. Its ms and the kernels a profiled call
    launched (the backend it ran)."""
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
    names = sorted({e.key[:70] for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA})
    return dict(sdpa_ms=cuda_ms(torch, call), sdpa_kernels=names)


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


def bf16_qkv(torch, g, b, t, h, d):
    return torch.randn((b, t, 3 * h * d), generator=g,
                       device="cuda").to(torch.bfloat16)


def views(qkv, h, d):
    """(B, H, T, D) q, k, v views of a per-head-interleaved qkv."""
    b, t, _ = qkv.shape
    x = qkv.view(b, t, h, 3, d)
    return tuple(x[:, :, :, p].transpose(1, 2) for p in range(3))


def ragged(torch, b, t, cut=63):
    """A (b, t) key mask with the last row's keys cut ``cut`` short."""
    lens = torch.tensor([t] * (b - 1) + [t - cut], device="cuda")
    return torch.arange(t, device="cuda")[None, :] < lens[:, None]


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
        valid = ragged(torch, b, tkv)
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
    the FiLM pair of one of G_CHAINS' forms (None without)."""
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


def kernel_a_weights(torch, device="cuda"):
    """Random production-width kernel-A weights: 30 layers, D=1024, H=16,
    F=4096, Vp=8320 (8194 real logits). Returns (blocks, head, the
    generator that drew them)."""
    dev = torch.device(device)
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


def kernel_a_inputs(torch, b, weights=None, device="cuda"):
    """(blocks, cache_k, cache_v, bias_row, x, kwargs) for one decode step
    of b rows over a C=640-slot cache (a 32-token bucket's size_cache)
    holding 300 valid slots in every row, with the head and the default
    sampler."""
    blocks, head, g = weights or kernel_a_weights(torch, device)
    dev = torch.device(device)
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


def expf_sass_ops(torch) -> dict:
    """The SASS instructions of one expf (what kernel F takes for its
    weights), by pipe: a one-line kernel compiled for sm_90a and read
    back with cuobjdump. Kernel F's design floor puts its exps on the FMA
    pipe at this count."""
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
    return dict(fma=len(fma), mufu=body.count("MUFU"), all=len(body))


class Timer:
    """Emits one JSON line a measurement, with the run's label and the
    card; ``kernel`` times a call (``timed``) with its plain twin, SDPA
    and bound where given."""

    def __init__(self, torch, label, card):
        self.torch, self.label, self.card = torch, label, card

    def line(self, **kw):
        print(json.dumps(dict(label=self.label, card=self.card, **kw)),
              flush=True)

    def kernel(self, name, shape, fn, plain=None, sdpa=None, **extra):
        """``sdpa``: (q, k, v, additive mask) of SDPA's call."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        row = dict(kernel=name, shape=shape, ms=cuda_ms(torch, fn),
                   host_us=host_us(torch, fn))
        if plain is not None:
            row["plain_ms"] = cuda_ms(torch, plain, iters=3)
        if sdpa is not None:
            row.update(sdpa_ms(torch, *sdpa))
        self.line(**row, **extra)


def time_a(torch, T):
    from tortoise_tpu_torch.ops.cuda import decode_trunk as K

    weights = kernel_a_weights(torch)
    for b in (1, 16):
        blocks, ck, cv, bias_row, x, full = kernel_a_inputs(torch, b,
                                                            weights)
        args = (blocks, ck, cv, bias_row, x)
        out = K.fused_decode_trunk(*args, **full)
        # bytes: every weight, the head, the whole cache, the inputs and
        # outputs once; the FLOPs are ~2 per weight byte
        T.kernel("A", [b, 640], lambda: K.fused_decode_trunk(*args, **full),
                 plain=lambda: K.fused_decode_trunk_plain(*args, **full),
                 launches_per_step=device_launches(
                     torch, lambda: K.fused_decode_trunk(*args, **full), 3,
                     "decode"),
                 **bound(nbytes(args, full, out),
                         flops=2.0 * nbytes(blocks, full["head"])))
        del blocks, ck, cv, bias_row, x, full, args, out


def time_attention(torch, T, g):
    from tortoise_tpu_torch.ops.cuda import flash_attention as K

    dev = torch.device("cuda")

    def table(h):
        return torch.randn((32, h), generator=g, device=dev) * 0.3

    b, t, h = B_SHAPE
    for name, h, d in (("B", h, 64), ("B128", 8, 128)):
        qkv = bf16_qkv(torch, g, b, t, h, d)
        vec = K.relpos_bias_vector(table(h), t)
        out = K.flash_attention_packed(qkv, h, bias_vec=vec)
        T.kernel(name, [b, t, h, d],
                 lambda: K.flash_attention_packed(qkv, h, bias_vec=vec),
                 plain=lambda: K.flash_attention_packed_plain(qkv, h, None,
                                                              vec),
                 sdpa=(*views(qkv, h, d), K._toeplitz_full(vec, t, t)[None]),
                 **bound(nbytes(qkv, vec, out), flops=4.0 * b * h * t * t * d,
                         exps=float(b * h * t * t)))
    b, h, s = C_SHAPE
    for name, h, d in (("C", h, 64), ("C128", 8, 128)):
        qkv = bf16_qkv(torch, g, b, s, h, d)
        valid = torch.ones((b, s), dtype=torch.bool, device=dev)
        valid[:, 1 + 30:1 + 32] = False
        out = K.flash_attention_causal_qkv(qkv, h, valid)
        pairs = attention_pairs(b, h, s, s, True)
        add = K._causal_add(s, s, dev)[None, None] + \
            K._additive_mask(valid)[:, None, None, :]
        T.kernel(name, [b, s, h, d],
                 lambda: K.flash_attention_causal_qkv(qkv, h, valid),
                 plain=lambda: K.flash_attention_causal_qkv_plain(qkv, h,
                                                                  valid),
                 sdpa=(*K._split_part_major(qkv, h), add),
                 **bound(nbytes(qkv, valid, out), flops=4.0 * d * pairs,
                         exps=pairs))
    for b, t, h, d, masks in D1_CASES:
        qkv = bf16_qkv(torch, g, b, t, h, d)
        q, k, v = views(qkv, h, d)
        kw = dict(bias_table=table(h), bias_formula=True)
        vec = K.relpos_bias_vector(kw["bias_table"], t)
        if d == 64:  # 16 heads of 64: D1 against B on one qkv
            T.kernel("D1 views", [b, h, t, d], lambda: K.flash_attention(
                q, k, v, **kw))
            T.kernel("B on D1's qkv", [b, h, t, d],
                     lambda: K.flash_attention_packed(
                         qkv, h, bias_table=kw["bias_table"]))
            continue
        for n_valid in masks:
            valid = None
            if n_valid == "ragged":  # rows 2i, 2i+1: one request's CFG pair
                lens = torch.tensor([t - 37 * (i // 2) for i in range(b)],
                                    device=dev)
                valid = torch.arange(t, device=dev)[None, :] < lens[:, None]
            elif n_valid is not None:
                valid = ragged(torch, b, t, t - n_valid)
            add = K._toeplitz_full(vec, t, t)[None]
            if valid is not None:
                add = add + K._additive_mask(valid)[:, None, None, :]
            out = K.flash_attention(q, k, v, None, valid, **kw)
            first = (b, t, n_valid) == (2, 2176, None)
            T.kernel("D1", [b, h, t, d, n_valid],
                     lambda: K.flash_attention(q, k, v, None, valid, **kw),
                     plain=(lambda: K.flash_attention_plain(
                         q, k, v, None, valid, **kw)) if first else None,
                     sdpa=(q, k, v, add),
                     **bound(nbytes(qkv, vec, valid, out),
                             flops=4.0 * b * h * t * t * d,
                             exps=float(b * h * t * t)))
    for mode, b, h, tq, tkv in D2_CASES:
        q, k, v, kw = d2_inputs(torch, g, mode, b, h, tq, tkv)
        add, vec, full = attention_add(torch, K, q, k, kw)
        out = K.flash_attention(q, k, v, **kw)
        pairs = attention_pairs(b, h, tq, tkv, kw["causal"])
        T.kernel(f"D2 {mode}", [b, h, tq, tkv, 64],
                 lambda: K.flash_attention(q, k, v, **kw),
                 plain=lambda: K.flash_attention_plain(q, k, v, **kw),
                 sdpa=(q, k, v, add),
                 **bound(nbytes(q, k, v, kw["kv_valid"], vec, full, out),
                         flops=4.0 * 64 * pairs, exps=pairs))
        del q, k, v, kw, add, vec, full, out


def time_f32_body(torch, T, g):
    """Bf, Cf, Df2, Df1 and the f32 D2 modes on the split-TF32 body."""
    from tortoise_tpu_torch.ops.cuda import flash_attention as K

    dev = torch.device("cuda")

    def case(name, shape, call, plain, qkv_views, add, inputs, pairs):
        out = call()
        T.kernel(name, shape, call, plain=plain, sdpa=(*qkv_views, add),
                 **f32_bound(nbytes(inputs, out), qkv_views[0].shape[-1],
                             pairs))

    b, t, h = B_SHAPE
    qkv = torch.randn((b, t, 3 * h * 64), generator=g, device=dev)
    vec = K.relpos_bias_vector(torch.randn((32, h), generator=g,
                                           device=dev) * 0.3, t)
    case("Bf", [b, t, h, 64],
         lambda: K.flash_attention_packed(qkv, h, bias_vec=vec),
         lambda: K.flash_attention_packed_plain(qkv, h, None, vec),
         views(qkv, h, 64), K._toeplitz_full(vec, t, t)[None], (qkv, vec),
         attention_pairs(b, h, t, t, False))
    b, h, s = C_SHAPE
    qkv = torch.randn((b, s, 3 * h * 64), generator=g, device=dev)
    valid = torch.ones((b, s), dtype=torch.bool, device=dev)
    valid[:, 1 + 30:1 + 32] = False
    case("Cf", [b, s, h, 64],
         lambda: K.flash_attention_causal_qkv(qkv, h, valid),
         lambda: K.flash_attention_causal_qkv_plain(qkv, h, valid),
         K._split_part_major(qkv, h),
         K._causal_add(s, s, dev)[None, None]
         + K._additive_mask(valid)[:, None, None, :], (qkv, valid),
         attention_pairs(b, h, s, s, True))
    cases = []
    for route, b, h, t, d in FMA_CASES:
        x = torch.randn((b, t, 3 * h * d), generator=g, device=dev)
        q, k, v = views(x, h, d)
        if route == "D2":
            valid = torch.ones((b, t), dtype=torch.bool, device=dev)
            valid[:, 1 + 30:1 + 32] = False
            kw = dict(kv_valid=valid, causal=True)
        else:
            kw = dict(kv_valid=None, causal=False, bias_table=torch.randn(
                (32, h), generator=g, device=dev) * 0.3, bias_formula=True)
        cases.append((f"{route[0]}f{route[1]}", [b, h, t, t, d], q, k, v, kw,
                      x))
    for mode, b, h, tq, tkv in D2_CASES[1:]:
        q, k, v, kw = d2_inputs(torch, g, mode, b, h, tq, tkv,
                                dtype=torch.float32)
        cases.append((f"Df2 {mode}", [b, h, tq, tkv, 64], q, k, v, kw,
                      (q, k, v)))
    b, h, tq, tkv = F32_LONG
    q, k, v, kw = d2_inputs(torch, g, "unequal", b, h, tq, tkv,
                            dtype=torch.float32)
    cases.append(("Df2 long keys", [b, h, tq, tkv, 64], q, k, v, kw,
                  (q, k, v)))
    for name, shape, q, k, v, kw, inputs in cases:
        add, vec, full = attention_add(torch, K, q, k, kw)
        case(name, shape, lambda: K.flash_attention(q, k, v, **kw),
             lambda: K.flash_attention_plain(q, k, v, **kw), (q, k, v), add,
             (inputs, kw["kv_valid"], vec, full),
             attention_pairs(q.shape[0], q.shape[1], q.shape[2], k.shape[2],
                             kw["causal"]))
        del add, vec, full


def time_e(torch, T, g):
    from tortoise_tpu_torch.ops.cuda import lvc as K

    for L, b in E_CASES:
        for hop in E_HOPS:
            args = lvc_inputs(torch, g, b, L, hop)
            out = K.lvc_gated_residual(*args)
            # f32 FMAs outside the tensor cores: 32 in x 3 taps x 64 out
            # per sample; bytes: x, this block's kernels, bias, residual,
            # output
            T.kernel("E", [b, L, hop], lambda: K.lvc_gated_residual(*args),
                     plain=lambda: K.lvc_gated_residual_plain(*args),
                     plan=K.lvc_plan(b, 32, 32, L, hop),
                     **bound(nbytes(args[:4], out),
                             flops=2.0 * 32 * 3 * 64 * L * hop * b,
                             flop_rate=F32_FLOPS))
            del args, out


def time_f(torch, T, g):
    """Kernel F at F_SHAPE in bf16, all keys valid: the call, its plain
    twin, its quantize pass and its attention kernel each alone, kernel
    B on the same qkv (no one PyTorch call computes F), the function's
    bound and the design's floor (the second score pass's int8 products,
    each exp's expf instructions on the FMA pipe)."""
    from tortoise_tpu_torch.ops.cuda import flash_attention as KB
    from tortoise_tpu_torch.ops.cuda import flash_attention_int8 as K

    b, t, h, d = F_SHAPE
    qkv = bf16_qkv(torch, g, b, t, h, d)
    valid = torch.ones((b, t), dtype=torch.bool, device="cuda")
    table = torch.randn((32, h), generator=g, device="cuda") * 0.1
    out = K.flash_packed_i8(qkv, h, valid, table)
    pairs = float(b * h * t * t)
    tp = K.padded_length(t)
    exp_ops = expf_sass_ops(torch)
    mask, bias = K.i8_side_inputs(qkv, h, valid, table)
    kv = K.quantize_kv(qkv, h)
    # the function's work: q . k and p . v (2D int8 ops a pair each); the
    # second score pass and the int8 K/V round trip are this design's
    T.kernel("F", [b, t, h, d], lambda: K.flash_packed_i8(qkv, h, valid,
                                                          table),
             plain=lambda: K.flash_packed_i8_plain(qkv, h, valid, table),
             quantize_pass_ms=cuda_ms(torch, lambda: K.quantize_kv(qkv, h)),
             attention_kernel_ms=cuda_ms(torch, lambda: K.attend_i8(
                 qkv, h, kv, mask, bias)),
             b_same_qkv_ms=cuda_ms(torch, lambda: KB.flash_attention_packed(
                 qkv, h, valid, bias_table=table)),
             floor_pass2_ms=2.0 * d * b * h * tp * tp / INT8_OPS * 1e3,
             floor_expf_ms=float(b * h * tp * tp) * exp_ops["fma"]
             / (F32_FLOPS / 2) * 1e3, expf_sass=exp_ops,
             **bound(nbytes(qkv, valid, table, out), flops=4.0 * d * pairs,
                     flop_rate=INT8_OPS, exps=pairs))


def time_g(torch, T, g):
    from tortoise_tpu_torch.ops.cuda import group_norm as K

    for dtype in (torch.bfloat16, torch.float32):
        for name, film, silu in G_CHAINS:
            args, pair = gn_inputs(torch, g, dtype, film)
            out = K.group_norm_act(*args, film=pair, silu=silu)
            # x and the mask read once, the output written once
            T.kernel("G", [*args[0].shape, args[1], str(dtype)[6:], name],
                     lambda: K.group_norm_act(*args, film=pair, silu=silu),
                     plain=lambda: K.group_norm_act_plain(
                         *args, film=pair, silu=silu),
                     plan=K.gn_plan(*args[0].shape[:2]),
                     **bound(nbytes(args[0], args[5], out)))
            del args, pair, out


def time_int8_product(torch, T, g):
    """Q8 and E8 at I8_CASES on bf16 and f32 maps, each beside its plain
    twin, and the whole product as the denoiser calls it (``_linear``,
    ``conv1d_nwc``)."""
    from tortoise_tpu_torch.models import diffusion as TDM
    from tortoise_tpu_torch.ops import conv
    from tortoise_tpu_torch.ops.basic import mm_bf16, quantize_cols
    from tortoise_tpu_torch.ops.cuda import int8_product as K

    b, t = G_SHAPE[:2]
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
            codes, s_row = K.quantize_rows(x3, padding)
            sums = [mm_bf16(codes.reshape(-1, k_in), wj)
                    for wj in pair[0].reshape(taps, k_in, n)]
            out = K.epilogue(sums, s_row, pair[1], bias, torch.bfloat16)
            shape = [b, t, k_in, n, name, str(dtype)[6:]]
            T.kernel("Q8", shape, lambda: K.quantize_rows(x3, padding),
                     plain=lambda: K.quantize_rows_plain(x3, padding),
                     **bound(nbytes(x, codes, s_row)))
            T.kernel("E8", shape, lambda: K.epilogue(
                sums, s_row, pair[1], bias, torch.bfloat16),
                plain=lambda: K.epilogue_plain(sums, s_row, pair[1], bias,
                                               torch.bfloat16),
                **bound(nbytes(sums, out, s_row)))
            if padding:
                T.kernel("int8 product", shape, lambda: conv.conv1d_nwc(
                    x, pair, bias, padding=1, compute_dtype=torch.bfloat16,
                    out_dtype=torch.bfloat16))
            else:
                T.kernel("int8 product", shape, lambda: TDM._linear(
                    x, pair, bias, torch.bfloat16, torch.bfloat16))
            del x, x3, pair, bias, codes, s_row, sums, out


def trace_kernel_a(torch, T) -> None:
    """Kernel A's own timeline (its tt_decode_set_trace hook, the global
    timer at every grid barrier) at B = 1 and 16: per layer phase, the
    mean time from block 0 leaving the barrier before it to the last
    block arriving at the barrier after it (work), and from there to
    block 0 leaving that barrier (barrier)."""
    from tortoise_tpu_torch.ops.cuda import build
    from tortoise_tpu_torch.ops.cuda import decode_trunk as K

    lib = build.library()
    weights = kernel_a_weights(torch)
    names = ("qkv", "attention", "proj+residual", "LN2", "fc+GELU",
             "fc_proj+residual", "LN1")
    for b in (1, 16):
        blocks, ck, cv, bias_row, x, kw = kernel_a_inputs(torch, b, weights)
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
        T.line(kernel="A trace", shape=[b], barriers=len(ends),
               step_us=(exits[-1] - exits[0]) / 1e3,
               barrier_mean_us=sum(wait) / len(wait),
               ln1_layer0_us=work[0], head_us=work[-2], sampler_us=work[-1],
               phases_us={name: dict(
                   work=sum(work[1 + per * i + j] for i in range(n_layer))
                   / n_layer,
                   barrier=sum(wait[1 + per * i + j] for i in range(n_layer))
                   / n_layer) for j, name in enumerate(names)})
        del blocks, ck, cv, bias_row, x, kw, buf


def profile_phase(torch, T) -> None:
    """torch.profiler over 5 kernel-A decode steps (B=1) and a 3-step
    production-width diffusion run (B=1, 500 latents, bf16 + int8,
    kernel B): device time by kernel, the idle share, and the Chrome
    traces in $TORTOISE_TRACE_DIR where it is set."""
    import dataclasses

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tortoise_tpu_torch.ops.cuda import decode_trunk as K
    from tortoise_tpu_torch.pipeline import diffusion_stage as DS
    from tortoise_tpu_torch.pipeline.synthesize import TortoiseModels

    def profiled(name, n, fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3 / n
        # device-side events only: an op's own row would count its
        # kernels' time a second time
        rows = sorted(((e.self_device_time_total, e.count, e.key)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and e.self_device_time_total > 0), reverse=True)
        busy_ms = sum(r[0] for r in rows) / 1e3 / n
        T.line(kernel=f"profile {name}", wall_ms=wall_ms, busy_ms=busy_ms,
               idle_share=1 - busy_ms / wall_ms,
               top=[[dev / n, count / n, key[:90]]
                    for dev, count, key in rows[:12]])
        trace_dir = os.environ.get("TORTOISE_TRACE_DIR")
        if trace_dir:
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(trace_dir,
                                                  f"trace_{name}.json"))

    args = kernel_a_inputs(torch, 1)
    profiled("decode_step", 5, lambda: K.fused_decode_trunk(*args[:5],
                                                            **args[5]))
    del args
    trace_kernel_a(torch, T)
    models = TortoiseModels.random(0)
    cfg = dataclasses.replace(models.diffusion_cfg, use_flash=True,
                              n_sample_timesteps=3)
    params = DS._prepare_params(models.diffusion_params, True, "cuda")
    lat = torch.randn((1, 512, 1024), device="cuda")
    profiled("diffusion_3_steps", 1, lambda: DS.diffusion_batch_device(
        params, lat, [500], cfg, compute_dtype=torch.bfloat16,
        device="cuda"))


def write_plane(plane_dir) -> dict:
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


def plane_upload(torch, T, rounds: int) -> None:
    """The int8 plane's casts of the loaded tree (first, then after
    clear_cast_cache), then its upload three ways, in turns, ``rounds``
    rounds: a read-only map copied first (what params.tree_to_torch does
    with a read-only array), the copy-on-write map that load_plane gives,
    and a read-only map copied into pinned memory."""
    import shutil

    import numpy as np

    from tortoise_tpu_torch.io.plane_cache import load_plane
    from tortoise_tpu_torch.pipeline import ar_stage, common, diffusion_stage

    base = os.path.join(HERE, "_plane_cache")
    os.makedirs(base, exist_ok=True)
    work = tempfile.mkdtemp(dir=base)
    try:
        plane = os.path.join(work, "plane")
        written = write_plane(plane)
        tree = load_plane(plane, mmap=True)
        casts = {}
        for turn in ("first", "again"):
            common.clear_cast_cache()
            for name, fn in (("ar", lambda: ar_stage.cast_matmul_weights(
                    tree["ar"], torch.bfloat16, True, "cuda")),
                    ("diffusion", lambda: diffusion_stage._prepare_params(
                        tree["diffusion"], True, "cuda"))):
                t0 = time.monotonic()
                fn()
                torch.cuda.synchronize()
                casts[f"{name}_cast_s_{turn}"] = time.monotonic() - t0
        common.clear_cast_cache()
        del tree
        T.line(kernel="plane casts", plane_bytes=written["bytes"], **casts)
        files = [os.path.join(d, f) for d, _, fs in os.walk(plane)
                 for f in fs if f.endswith(".npy")]

        def copy_first():
            return [torch.from_numpy(np.load(f, mmap_mode="r").copy())
                    .to("cuda") for f in files]

        def cow_map():
            return [torch.from_numpy(np.load(f, mmap_mode="c")).to("cuda")
                    for f in files]

        def pinned():
            out = []
            for f in files:
                a = np.load(f, mmap_mode="r")
                h = torch.from_numpy(np.empty(0, a.dtype))
                h = torch.empty(a.shape, dtype=h.dtype, pin_memory=True)
                h.numpy()[...] = a
                out.append(h.to("cuda", non_blocking=True))
            return out

        ways = {"copy_first": copy_first, "cow_map": cow_map,
                "pinned": pinned}
        got = {k: [] for k in ways}
        for _ in range(rounds):
            for name, fn in ways.items():
                torch.cuda.synchronize()
                t0 = time.monotonic()
                leaves = fn()
                torch.cuda.synchronize()
                got[name].append(time.monotonic() - t0)
                del leaves
                torch.cuda.empty_cache()
        T.line(kernel="plane upload", rounds=rounds, **got)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose tortoise_tpu_torch is timed")
    ap.add_argument("--label", default="this")
    ap.add_argument("--profile", action="store_true",
                    help="then profile a decode step and 3 denoising steps "
                         "and trace kernel A's phases")
    ap.add_argument("--plane-upload", type=int, default=0, metavar="N",
                    help="time the int8 plane (casts, then N rounds of "
                         "upload three ways) instead of the kernels")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_times: needs a CUDA card", file=sys.stderr)
        return 1
    from tortoise_tpu_torch.ops.cuda import build

    if not build.__file__.startswith(root):
        print(f"torch_kernel_times: imported {build.__file__}, not from "
              f"{root}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    T = Timer(torch, args.label, smi_line())
    if args.plane_upload:
        plane_upload(torch, T, args.plane_upload)
        return 0
    t0 = time.monotonic()
    build.build()
    build.library()
    T.line(kernel="build", seconds=time.monotonic() - t0,
           ptxas=[ln.split("ptxas info    :")[-1].strip()
                  for ln in build.build_log.splitlines()
                  if "registers" in ln or "spill" in ln
                  or "Compiling" in ln])
    g = torch.Generator(device="cuda").manual_seed(11)
    time_a(torch, T)
    time_attention(torch, T, g)
    time_f32_body(torch, T, g)
    time_e(torch, T, g)
    time_f(torch, T, g)
    time_g(torch, T, g)
    time_int8_product(torch, T, g)
    if args.profile:
        profile_phase(torch, T)
    return 0


if __name__ == "__main__":
    sys.exit(main())
