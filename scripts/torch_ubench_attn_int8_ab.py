#!/usr/bin/env python3
"""A/B on one NVIDIA card: kernel F, the int8-score packed attention
(``tortoise_tpu_torch/ops/cuda/flash_attention_int8.py``), against kernel
B, the bf16 packed attention (``flash_attention_packed``), at the
denoiser's shape (B, H, T, D) = (2, 16, 2176, 64). The port's
counterpart of ``scripts/ubench_attn_int8_ab.py``'s ``main``:

    python3 scripts/torch_ubench_attn_int8_ab.py               # the card
    python3 scripts/torch_ubench_attn_int8_ab.py --device cpu  # plain only

Inputs from numpy seed 0: qkv ~ N(0, 1) in bf16, the (32, H) rel-pos
table ~ N(0, 0.1), an all-valid key mask. It prints F's max abs and
relative error against B on the same qkv; then, on the card, each one's
device time a call over N = 10 chained calls (each output fed back as
``cat([out] * 3, -1) * 0.5 + c * 0.5``, as the JAX loop does), timed
with CUDA events around each call alone (for F its quantize pass and its
attention kernel; for B its kernel; the mask and bias of both are built
once before the loop), all calls queued behind a device sleep so the
events read device time.
No ``hpp`` sweep: heads per program is a knob of the TPU's VMEM.
``--device cpu`` runs the plain versions, prints the error and skips the
timing, as the JAX script does on its CPU backend.

Every line ends with the card's name and power limit; the last line is
one JSON object ``{"ab": {...}}`` with the error, the times, the calls
made and the launch counts (the counters are set to 0 at the start).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

B, H, T, D, N = 2, 16, 2176, 64, 10
WARMUP = 2  # chained calls of each variant before the timed ones


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def make_inputs(torch, b, t, h, d, device):
    """(qkv (b, t, 3hd) bf16, table (32, h) f32, mask (b, t) bool) from
    numpy seed 0, in the JAX script's order."""
    import numpy as np

    rng = np.random.default_rng(0)
    qkv = torch.as_tensor(rng.normal(0, 1, (b, t, 3 * h * d)).astype(
        np.float32)).to(device=device, dtype=torch.bfloat16)
    table = torch.as_tensor(rng.normal(0, 0.1, (32, h)).astype(
        np.float32)).to(device)
    mask = torch.ones((b, t), dtype=torch.bool, device=device)
    return qkv, table, mask


def accuracy(qkv, n_head, mask, table) -> dict:
    """Kernel F against kernel B on one qkv (the plain versions on the
    CPU): their outputs, F's max abs error and that error over B's max
    magnitude."""
    from tortoise_tpu_torch.ops.cuda.flash_attention import (
        flash_attention_packed,
    )
    from tortoise_tpu_torch.ops.cuda.flash_attention_int8 import (
        flash_packed_i8,
    )

    o_b = flash_attention_packed(qkv, n_head, mask, bias_table=table)
    o_f = flash_packed_i8(qkv, n_head, mask, table)
    err = float((o_b.float() - o_f.float()).abs().max())
    rel = err / max(float(o_b.float().abs().max()), 1e-9)
    return dict(b_out=o_b, f_out=o_f, max_abs_err=err, rel_err=rel)


def chained_ms(torch, call, qkv, n: int, warmup: int) -> float:
    """Device ms a call of ``call`` over ``n`` chained calls after
    ``warmup`` ones: CUDA events around each call alone, the whole loop
    queued behind a device sleep."""
    c = qkv
    for _ in range(warmup):
        out = call(c)
        c = torch.cat([out] * 3, dim=-1) * 0.5 + c * 0.5
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    torch.cuda._sleep(50_000_000)
    for start, end in events:
        start.record()
        out = call(c)
        end.record()
        c = torch.cat([out] * 3, dim=-1) * 0.5 + c * 0.5
    torch.cuda.synchronize()
    if not bool(torch.isfinite(c).all()):
        raise RuntimeError("the chained loop gave non-finite values")
    return sum(s.elapsed_time(e) for s, e in events) / n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu "
                         "(plain versions, no timing)")
    args = ap.parse_args(argv)
    import torch

    from tortoise_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from tortoise_tpu_torch.ops.cuda import flash_attention as FA
    from tortoise_tpu_torch.ops.cuda import flash_attention_int8 as FI

    on_card = args.device != "cpu"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("the A/B runs on a CUDA card by default (pass "
                           "--device cpu for the plain versions)")
    card = card_line() if on_card else "cpu (no card)"
    shape = (B, H, T, D)
    qkv, table, mask = make_inputs(torch, B, T, H, D, args.device)
    reset_launch_counts()
    acc = accuracy(qkv, H, mask, table)
    print(f"int8 vs bf16 kernel at (B, H, T, D) = {shape}: max abs err "
          f"{acc['max_abs_err']:.4f} (rel {acc['rel_err']:.4f}) [{card}]",
          flush=True)
    result = dict(shape=shape, device=args.device, card=card,
                  max_abs_err=acc["max_abs_err"], rel_err=acc["rel_err"])
    calls = 1
    if on_card:
        b_side = (FA._device_mask(mask, B, T, qkv.device),
                  FA.relpos_bias_vector(table, T))
        f_side = FI.i8_side_inputs(qkv, H, mask, table)
        variants = (("bf16", lambda c: FA.launch_packed(c, H, *b_side)),
                    ("i8", lambda c: FI.launch_i8(c, H, *f_side)))
        for name, call in variants:
            ms = chained_ms(torch, call, qkv, N, WARMUP)
            result[f"{name}_ms"] = ms
            print(f"{name}: {ms:7.4f} ms/call ({N} chained calls) "
                  f"[{card}]", flush=True)
        calls += WARMUP + N
    else:
        print(f"CPU: skipping device timing [{card}]", flush=True)
    counts = launch_counts()
    result.update(calls=calls, launches={
        k: counts[k] for k in ("flash_attention_packed", "flash_packed_i8",
                               "int8_quantize_kv")})
    print(f"launches {result['launches']} over {calls} calls of each "
          f"variant [{card}]", flush=True)
    print(json.dumps({"ab": result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
