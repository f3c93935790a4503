#!/usr/bin/env python3
"""Does an int8 x int8 -> int32 product beat bf16 on this card at the
denoiser's matmul shapes, and does dynamic per-row activation
quantization eat the gain? The counterpart of
``scripts/ubench_int8_matmul.py``.

    python3 scripts/torch_ubench_int8_matmul.py              # the card
    python3 scripts/torch_ubench_int8_matmul.py --device cpu --small

M = 4352 rows (the CFG batch of 2 at the bench's T = 2176; ``--small``:
64) at the three hot (K, N): qkv 1024 -> 3072, proj 1024 -> 1024, the
k3 conv as a 3072 -> 1024 product. Five variants, inputs from numpy
seed 0 (x ~ N(0, 1) and w ~ N(0, 0.02) in bf16, w quantized per column):

  bf16       ``pdot(x, w, bf16, bf16)``: the bf16 product;
  int8w      ``pdot(x, (wq, scale), bf16, bf16)``: the port's int8
             weight-only path (the weight widened to bf16);
  int8 full  ``quantize_rows`` (per-row absmax scale), ``torch._int_mm``
             (int8 x int8 -> int32), then ``acc * s_row * scale`` in
             ``pdot_int8act``'s order, cast to bf16;
  int8 preq  the same on rows quantized beforehand: the int8 product
             and its scales alone;
  int8 mm    ``torch._int_mm`` alone, int32 out: the library's int8
             GEMM without the eager scale epilogue.

``torch._int_mm`` is a library call used here as a yardstick; it is no
port of a kernel (the JAX package computes these products outside
Pallas, and the port's ``pdot_int8act`` runs them as bf16 products,
``tortoise_tpu_torch/ops/basic.py``). Each variant's time is the mean
device ms of 30 calls between CUDA events, queued behind a
device sleep so the events read the device, after a warmup call; best
of 3 such runs. It prints us, TFLOP/s (2 M K N a call) and the share of
its own peak (989 TFLOP/s bf16, 1,979 TOP/s int8; the H100 SXM data
sheet). On the CPU: the host clock, the same variants.

The last line is ``{"int8_matmul": {...}}`` with every number printed
and the launch counts since the start.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_ubench_common as U  # noqa: E402

M = 4352
SMALL_M = 64
SHAPES = ((1024, 3072), (1024, 1024), (3072, 1024))
SMALL_SHAPES = ((64, 192), (64, 64), (192, 64))
ROUNDS = 3


def variants():
    """{name: fn(x, w, wq, wq_cm, scale, xq, s_row) -> (M, N)}: bf16,
    but int32 for "int8 mm"."""
    import torch

    from tortoise_tpu_torch.ops.basic import pdot, quantize_rows

    bf = torch.bfloat16

    def bf16(x, w, wq, wq_cm, scale, xq, s_row):
        return pdot(x, w, bf, bf)

    def int8w(x, w, wq, wq_cm, scale, xq, s_row):
        return pdot(x, (wq, scale), bf, bf)

    def full(x, w, wq, wq_cm, scale, xq, s_row):
        q, s = quantize_rows(x)
        acc = torch._int_mm(q.to(torch.int8), wq_cm)
        return (acc.float() * s * scale).to(bf)

    def preq(x, w, wq, wq_cm, scale, xq, s_row):
        return (torch._int_mm(xq, wq_cm).float() * s_row * scale).to(bf)

    def mm(x, w, wq, wq_cm, scale, xq, s_row):
        return torch._int_mm(xq, wq_cm)

    return {"bf16": bf16, "int8w": int8w, "int8 full": full,
            "int8 preq": preq, "int8 mm": mm}


def operands(m: int, k: int, n: int, rng, device):
    """(x, w, wq, wq_cm, scale, xq, s_row): x (m, k) and w (k, n) in
    bf16, w's per-column int8 pair (``quantize_cols``) with wq also
    column-major (``torch._int_mm``'s usual second operand), x's int8
    rows and scales (``quantize_rows``)."""
    import torch

    from tortoise_tpu_torch.ops.basic import quantize_cols, quantize_rows

    x = torch.as_tensor(rng.normal(0, 1, (m, k)).astype(np.float32)).to(
        device=device, dtype=torch.bfloat16)
    w = torch.as_tensor(rng.normal(0, 0.02, (k, n)).astype(np.float32)).to(
        device=device, dtype=torch.bfloat16)
    wq, scale = quantize_cols(w.float())
    xq, s_row = quantize_rows(x)
    return x, w, wq, wq.t().contiguous().t(), scale, xq.to(torch.int8), s_row


def mean_ms(fn, device, reps: int) -> float:
    """Mean ms a call over ``reps`` calls, best of ROUNDS, after a warmup
    call (module docstring)."""
    import torch

    fn()
    best = float("inf")
    for _ in range(ROUNDS):
        if device.type == "cuda":
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(20_000_000)
            t0.record()
            for _ in range(reps):
                fn()
            t1.record()
            torch.cuda.synchronize()
            ms = t0.elapsed_time(t1)
        else:
            t = time.perf_counter()
            for _ in range(reps):
                fn()
            ms = (time.perf_counter() - t) * 1e3
        best = min(best, ms / reps)
    return best


def run(m: int, shapes, device, reps: int = 30, card: str = "") -> dict:
    rng = np.random.default_rng(0)
    fns = variants()
    out = dict(m=m, reps=reps, shapes={})
    for k, n in shapes:
        ops = operands(m, k, n, rng, device)
        flops = 2 * m * k * n
        print(f"(M={m}, K={k}, N={n}) [{card}]", flush=True)
        row = {}
        for name, fn in fns.items():
            ms = mean_ms(lambda fn=fn: fn(*ops), device, reps)
            row[name] = dict(us=ms * 1e3, tflops=None, peak_share=None)
            rate = ""
            if device.type == "cuda":  # a rate of the card's peak only
                peak = U.INT8_OPS if name.startswith("int8 ") \
                    else U.BF16_FLOPS
                r = flops / (ms * 1e-3)
                row[name].update(tflops=r / 1e12, peak_share=r / peak)
                rate = f" {r / 1e12:7.1f} TFLOP/s ({r / peak:.3f} of its peak)"
            print(f"  {name:10s} {ms * 1e3:9.1f} us{rate} [{card}]",
                  flush=True)
        out["shapes"][f"{k}x{n}"] = row
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    U.add_device_args(ap)
    args = ap.parse_args(argv)
    dev, card = U.start(args.device)
    result = run(SMALL_M if args.small else M,
                 SMALL_SHAPES if args.small else SHAPES, dev, card=card)
    return U.emit("int8_matmul", result, dev, card, args.small)


if __name__ == "__main__":
    main()
