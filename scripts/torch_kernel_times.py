#!/usr/bin/env python3
"""Device and host times of the port's kernels A, B, C, D1, D2, E, F and
G on one NVIDIA card, for the tortoise_tpu_torch of the checkout at
--root, at the phase-3 shapes and inputs of this checkout's
chip_smoke.py (its kernel-A weights and inputs at B = 1 and 16, B_CASES,
C_SHAPE, D1_CASES, WIDE, D2_CASES, E_CASES, F_SHAPE, G_SHAPE, G_CHAINS
and input builders; f32 inputs: B and C, D2 causal and D1 at FMA_CASES,
and every other D2_CASES mode, where the checkout's kernels take them; F
and G only where the checkout has them, and on every checkout "G eager
chain", the group norm chain as eager ops, which kernel G replaced in the
denoiser; "int8 product", the denoiser's int8 products at I8_CASES as
the checkout runs them: eagerly before kernels Q8 and E8, on them
after); with --request3 N, also N runs of chip_smoke's request 3
(synthesize() on the diffusion fallback and the fused LVC: kernels A, D1
and E). Two checkouts compare inside one call, in turns:

    python3 scripts/torch_kernel_times.py --root _archive/parent --label parent
    python3 scripts/torch_kernel_times.py --label change

Each line of output is one JSON object with the label, the card's name
and power limit, and either a kernel's shape, ``ms`` (device time a
call: CUDA events over 10 calls queued behind a device sleep, as
chip_smoke.py times them) and ``host_us`` (the wrapper's host time a
call: 50 calls enqueued without a sync), or request 3's stage timings.

With --plane-upload N it times request 6's int8 plane instead of the
kernels: chip_smoke's write_warm_plane writes it under the git-ignored
_plane_cache/, then one line has the loaded tree's weight casts (the
first in this process, then again after clear_cast_cache) and one line
the seconds to put the whole plane on the card three ways, in turns, N
rounds: a read-only map copied first (what params.tree_to_torch does
with a read-only array), the copy-on-write map that load_plane gives,
and a read-only map copied into pinned memory.
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


def _takes_f32(FA) -> bool:
    """Whether this checkout's kernels B and C take an f32 qkv."""
    import torch

    try:
        FA.attention_body(torch.float32, 64, "B")
    except ValueError:
        return False
    return True


def plane_upload(torch, smoke, emit_line, rounds: int) -> None:
    """Request 6's plane: casts of the loaded tree, then its upload three
    ways (see the module's docstring)."""
    import shutil
    import tempfile

    import numpy as np

    from tortoise_tpu_torch.io.plane_cache import load_plane
    from tortoise_tpu_torch.pipeline import ar_stage, common, diffusion_stage

    base = os.path.join(HERE, "_plane_cache")
    os.makedirs(base, exist_ok=True)
    work = tempfile.mkdtemp(dir=base)
    try:
        plane = os.path.join(work, "plane")
        written = smoke.write_warm_plane(plane)
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
        emit_line(kernel="plane casts", plane_bytes=written["bytes"], **casts)
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
        emit_line(kernel="plane upload", rounds=rounds, **got)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose tortoise_tpu_torch is timed")
    ap.add_argument("--label", default="this")
    ap.add_argument("--request3", type=int, default=0, metavar="N",
                    help="also run chip_smoke's request 3 N times")
    ap.add_argument("--plane-upload", type=int, default=0, metavar="N",
                    help="time request 6's plane (casts, then N rounds of "
                         "upload three ways) instead of the kernels")
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
    if args.plane_upload:
        plane_upload(torch, smoke, lambda **kw: print(json.dumps(dict(
            label=args.label, card=card, **kw)), flush=True),
            args.plane_upload)
        return 0
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

    from tortoise_tpu_torch.ops.cuda import decode_trunk as DT

    weights = smoke._kernel_a_weights(torch)
    for b in (1, 16):
        blocks, ck, cv, bias_row, xa, full = smoke._kernel_a_inputs(
            torch, b, weights)
        emit("A", [b], lambda: DT.fused_decode_trunk(
            blocks, ck, cv, bias_row, xa, **full))
        del blocks, ck, cv, bias_row, xa, full
    del weights

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
    b, t, _, h = smoke.B_CASES[0]
    x = smoke.bf16_qkv(torch, g, b, t, h, 64)
    vec = FA.relpos_bias_vector(table(h), t)
    emit("B", [b, h, t, 64],
         lambda: FA.flash_attention_packed(x, h, bias_vec=vec))
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
    for mode, b, h, tq, tkv in smoke.D2_CASES:
        q, k, v, kw = smoke.d2_inputs(torch, g, mode, b, h, tq, tkv)
        emit(f"D2 {mode}", [b, h, tq, tkv, 64],
             lambda: FA.flash_attention(q, k, v, **kw))
        del q, k, v, kw
    # f32 B, C, D1 and D2 (the f32 body) and kernel F, where this checkout
    # has them
    if _takes_f32(FA):
        b, t, _, h = smoke.B_CASES[0]
        xf = torch.randn((b, t, 3 * h * 64), generator=g, device="cuda")
        vec = FA.relpos_bias_vector(table(h), t)
        emit("B f32", [b, h, t, 64],
             lambda: FA.flash_attention_packed(xf, h, bias_vec=vec))
        b, h, s = smoke.C_SHAPE
        xf = torch.randn((b, s, 3 * h * 64), generator=g, device="cuda")
        valid = torch.ones((b, s), dtype=torch.bool, device="cuda")
        valid[:, 31:33] = False
        emit("C f32", [b, h, s, 64],
             lambda: FA.flash_attention_causal_qkv(xf, h, valid))
        del xf
    for route, b, h, t, d in smoke.FMA_CASES:
        xf = torch.randn((b, t, 3 * h * d), generator=g, device="cuda")
        q, k, v = smoke.views(xf, h, d)
        if route == "D2":
            valid = torch.ones((b, t), dtype=torch.bool, device="cuda")
            valid[:, 31:33] = False
            kw = dict(kv_valid=valid, causal=True)
        else:
            kw = dict(bias_table=table(h), bias_formula=True)
        emit(f"{route} f32", [b, h, t, d],
             lambda: FA.flash_attention(q, k, v, **kw))
        del xf, q, k, v
    for mode, b, h, tq, tkv in smoke.D2_CASES[1:]:
        q, k, v, kw = smoke.d2_inputs(torch, g, mode, b, h, tq, tkv,
                                      dtype=torch.float32)
        emit(f"D2 f32 {mode}", [b, h, tq, tkv, 64],
             lambda: FA.flash_attention(q, k, v, **kw))
        del q, k, v, kw
    try:
        from tortoise_tpu_torch.ops.cuda import flash_attention_int8 as FI
    except ImportError:
        FI = None
    if FI is not None:
        b, t, h, d = smoke.F_SHAPE
        xi = smoke.bf16_qkv(torch, g, b, t, h, d)
        valid = torch.ones((b, t), dtype=torch.bool, device="cuda")
        tab = table(h) / 3
        emit("F", [b, h, t, d], lambda: FI.flash_packed_i8(xi, h, valid, tab))
        emit("F quantize pass", [b, h, t, d], lambda: FI.quantize_kv(xi, h))
        del xi
    for L, b in smoke.E_CASES:
        for hop in smoke.E_HOPS:
            e_args = smoke.lvc_inputs(torch, g, b, L, hop)
            emit("E", [b, L, hop], lambda: LV.lvc_gated_residual(*e_args))
            del e_args
    try:
        from tortoise_tpu_torch.ops.cuda import group_norm as GN
    except ImportError:  # a checkout from before kernel G
        GN = None
    for dtype in (torch.bfloat16, torch.float32):
        for name, film, silu in smoke.G_CHAINS:
            gn_args, pair = smoke.gn_inputs(torch, g, dtype, film)
            shape = [*gn_args[0].shape, gn_args[1], str(dtype)[6:], name]
            if GN is not None:
                emit("G", shape, lambda: GN.group_norm_act(
                    *gn_args, film=pair, silu=silu))
            emit("G eager chain", shape, lambda: smoke.gn_eager_chain(
                torch, *gn_args, pair, silu))
            del gn_args, pair
    from tortoise_tpu_torch.models import diffusion as TDM
    from tortoise_tpu_torch.ops import conv
    from tortoise_tpu_torch.ops.basic import quantize_cols

    b, t = smoke.G_SHAPE[:2]
    for name, k_in, n, padding in smoke.I8_CASES:
        x = (torch.randn((b, t, k_in), generator=g, device="cuda") * 1.7).to(
            torch.bfloat16)
        pair = quantize_cols(0.05 * torch.randn(
            ((2 * padding + 1) * k_in, n), generator=g, device="cuda"))
        bias = torch.randn(n, generator=g, device="cuda")
        if padding:
            emit("int8 product", [b, t, k_in, n, name], lambda: (
                conv.conv1d_nwc(x, pair, bias, padding=1,
                                compute_dtype=torch.bfloat16,
                                out_dtype=torch.bfloat16)))
        else:
            emit("int8 product", [b, t, k_in, n, name], lambda: TDM._linear(
                x, pair, bias, torch.bfloat16, torch.bfloat16))
        del x, pair, bias
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
