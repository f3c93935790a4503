#!/usr/bin/env python3
"""Device and host times of the port's kernels B, C, D1 and E on one
NVIDIA card, for the tortoise_tpu_torch of the checkout at --root, at
the phase-3 shapes and inputs of this checkout's chip_smoke.py (its
B_CASES, C_SHAPE, D1_CASES, WIDE, E_CASES and input builders); with
--request3 N, also N runs of chip_smoke's request 3 (synthesize() on the
diffusion fallback and the fused LVC: kernels A, D1 and E). Two
checkouts compare inside one call, in turns:

    python3 scripts/torch_kernel_times.py --root _archive/parent --label parent
    python3 scripts/torch_kernel_times.py --label change

Each line of output is one JSON object with the label, the card's name
and power limit, and either a kernel's shape, ``ms`` (device time a
call: CUDA events over 10 calls queued behind a device sleep, as
chip_smoke.py times them) and ``host_us`` (the wrapper's host time a
call: 50 calls enqueued without a sync), or request 3's stage timings.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose tortoise_tpu_torch is timed")
    ap.add_argument("--label", default="this")
    ap.add_argument("--request3", type=int, default=0, metavar="N",
                    help="also run chip_smoke's request 3 N times")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_times: needs a CUDA card", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from tortoise_tpu_torch.ops.cuda import flash_attention as FA
    from tortoise_tpu_torch.ops.cuda import lvc as LV

    if not FA.__file__.startswith(root):
        print(f"torch_kernel_times: imported {FA.__file__}, not from {root}",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smoke.smi_line()
    g = torch.Generator(device="cuda").manual_seed(11)

    def emit(kernel, shape, fn):
        fn()
        torch.cuda.synchronize()
        print(json.dumps(dict(label=args.label, kernel=kernel, shape=shape,
                              ms=smoke.cuda_ms(torch, fn),
                              host_us=host_us(torch, fn), card=card)),
              flush=True)

    def table(h):
        return torch.randn((32, h), generator=g, device="cuda") * 0.3

    for b, t, h, d, _ in smoke.D1_CASES:
        q, k, v = smoke.views(smoke.bf16_qkv(torch, g, b, t, h, d), h, d)
        tab = table(h)
        if d == 32:
            emit("D1", [b, h, t, d], lambda: FA.flash_attention(
                q, k, v, bias_table=tab, bias_formula=True))
            continue
        # the same work on views of a packed qkv and on contiguous copies
        for form, ops in (("views", (q, k, v)),
                          ("contiguous", [x.contiguous() for x in (q, k, v)])):
            emit(f"D1 {form}", [b, h, t, d], lambda: FA.flash_attention(
                *ops, bias_table=tab, bias_formula=True))
    b, t, _ = smoke.B_CASES[0]
    x = smoke.bf16_qkv(torch, g, b, t, 16, 64)
    vec = FA.relpos_bias_vector(table(16), t)
    emit("B", [b, 16, t, 64],
         lambda: FA.flash_attention_packed(x, 16, bias_vec=vec))
    (b, t), (bc, s) = smoke.WIDE
    xw = smoke.bf16_qkv(torch, g, b, t, 8, 128)
    vec_w = FA.relpos_bias_vector(table(8), t)
    emit("B", [b, 8, t, 128],
         lambda: FA.flash_attention_packed(xw, 8, bias_vec=vec_w))
    b, h, s = smoke.C_SHAPE
    xc = smoke.bf16_qkv(torch, g, b, s, h, 64)
    valid = torch.ones((b, s), dtype=torch.bool, device="cuda")
    valid[:, 31:33] = False
    emit("C", [b, h, s, 64],
         lambda: FA.flash_attention_causal_qkv(xc, h, valid))
    for L, b in smoke.E_CASES:
        for hop in smoke.E_HOPS:
            e_args = smoke.lvc_inputs(torch, g, b, L, hop)
            emit("E", [b, L, hop], lambda: LV.lvc_gated_residual(*e_args))
            del e_args
    if args.request3:
        from tortoise_tpu_torch.pipeline.synthesize import TortoiseModels

        models = TortoiseModels.random(0, **smoke.FALLBACK)
        for n in range(args.request3):
            t = smoke.run_request_3(torch, card, models)
            print(json.dumps(dict(
                label=args.label, kernel="request 3", run=n, card=card,
                diffusion_ms_per_step=t["diffusion_loop_s"]
                / t["diffusion_steps"] * 1e3,
                ar_ms_per_step=t["ar_decode_loop_s"] / t["ar_decode_steps"]
                * 1e3, **t)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
