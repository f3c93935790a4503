#!/usr/bin/env python3
"""Variants of the split-TF32 f32 attention body side by side, on one
NVIDIA card: each variant is ``csrc/flash_attention_bhtd.cu`` with one
design choice changed by a text substitution, built with nvcc into its
own library under ``tortoise_tpu_torch/_build/variants/`` (all builds at
once), then every variant runs the kernel timer's f32 shapes
(``scripts/torch_kernel_times.py``) through the
port's wrappers, in two rounds (forward, then reversed):

    python3 scripts/torch_f32_body_variants.py

Variants: "as built"; "cvt.rna rounding" (the PTX conversion instead of
the two integer ops, the same bits); "64-key tiles"; "8 warps" (128
query rows a block); "one P V accumulator" (P V summed
into O across the whole key loop, rescaled in place, instead of fresh
accumulators every tile); "one TF32 product" (hi*hi alone) and "one
TF32 product, no split" (the raw f32 bits, truncated by the tensor
cores): plain TF32, to see what the split and its two extra products
cost, and how far plain TF32 is from f32. Cases: B at (2, 2176) x 16 x 64, C at
(8, 535) x 16 x 64, D2 causal (8, 16, 535, 64) and D1 (2, 32, 2176, 32)
on views of a packed qkv, B at 8 heads of 128 and 64 heads of 16, and
D2 over 8192 keys (the timer's F32_LONG). Each line of output is one
JSON object: the variant, the case, device ms a call (the timer's
cuda_ms) in each round, the error against the plain version relative to
its max |out|, the card's name and power limit; one line a variant has
its ptxas register and spill report.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PV_FRESH = """    float pv[kDT][4];
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
      pv[dt][0] = pv[dt][1] = pv[dt][2] = pv[dt][3] = 0.f;
"""
_PV_IN_O = """#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] *= corr[e >> 1];
    float (&pv)[kDT][4] = o;
"""
_MMA3 = """  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);"""
_SPLIT = """  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));"""
_PV_ADD = """#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[dt][e] = fmaf(o[dt][e], corr[e >> 1], pv[dt][e]);
"""
VARIANTS = {
    "as built": [],
    "cvt.rna rounding": [(
        "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
        '  uint32_t y;\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));'
        "\n  return y;")],
    "64-key tiles": [("constexpr int kBK = 32;", "constexpr int kBK = 64;")],
    "8 warps": [("constexpr int kWarps = 4;", "constexpr int kWarps = 8;")],
    "one P V accumulator": [(_PV_FRESH, _PV_IN_O), (_PV_ADD, "")],
    # plain TF32 (not f32-accurate): what the split and its two extra
    # products cost
    "one TF32 product": [(_MMA3, "  mma_tf32(c, ah, bh);")],
    "one TF32 product, no split": [
        (_MMA3, "  mma_tf32(c, ah, bh);"),
        (_SPLIT, "  hi = __float_as_uint(x);\n  lo = 0u;")],
}


def build_variants(build) -> dict:
    """{variant: (loaded library, ptxas report)}; raises if a
    substitution no longer matches the source or a build fails."""
    src_path = build.SRC_DIR / "flash_attention_bhtd.cu"
    src = src_path.read_text()
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build.find_nvcc()
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: its substitution "
                                   f"does not match the source once")
            text = text.replace(old, new)
        cu = out_dir / f"variant{i}.cu"
        cu.write_text(text)
        so = out_dir / f"variant{i}.so"
        procs[name] = (so, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-I", str(build.SRC_DIR), "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name!r} failed to build:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.tt_flash_bhtd.argtypes = list(build.SIGNATURES["tt_flash_bhtd"])
        lib.tt_flash_bhtd.restype = ctypes.c_int
        report = [ln.split("ptxas info    :")[-1].strip()
                  for ln in log.splitlines()
                  if "registers" in ln or "spill" in ln]
        libs[name] = (lib, report)
    return libs


def cases(torch, times, FA):
    """[(label, call, plain output)] at the kernel timer's f32 shapes."""
    g = torch.Generator(device="cuda").manual_seed(12)
    dev = torch.device("cuda")
    out = []

    def table(h):
        return torch.randn((32, h), generator=g, device=dev) * 0.3

    for label, b, t, h, d in (("B", 2, 2176, 16, 64), ("B", 2, 2176, 8, 128),
                              ("B", 2, 1000, 64, 16)):
        qkv = torch.randn((b, t, 3 * h * d), generator=g, device=dev)
        vec = FA.relpos_bias_vector(table(h), t)
        out.append((f"{label} ({b}, {t}) x {h} heads of {d}",
                    lambda qkv=qkv, h=h, vec=vec: FA.flash_attention_packed(
                        qkv, h, bias_vec=vec),
                    FA.flash_attention_packed_plain(qkv, h, None, vec)))
    b, h, s = times.C_SHAPE
    qkv = torch.randn((b, s, 3 * h * 64), generator=g, device=dev)
    valid = torch.ones((b, s), dtype=torch.bool, device=dev)
    valid[:, 31:33] = False
    out.append((f"C ({b}, {s}) x {h} heads of 64",
                lambda: FA.flash_attention_causal_qkv(qkv, h, valid),
                FA.flash_attention_causal_qkv_plain(qkv, h, valid)))
    for route, b, h, t, d in times.FMA_CASES:
        x = torch.randn((b, t, 3 * h * d), generator=g, device=dev)
        q, k, v = times.views(x, h, d)
        if route == "D2":
            vd = torch.ones((b, t), dtype=torch.bool, device=dev)
            vd[:, 31:33] = False
            kw = dict(kv_valid=vd, causal=True)
        else:
            kw = dict(bias_table=table(h), bias_formula=True)
        out.append((f"{route} ({b}, {h}, {t}, {d})",
                    lambda q=q, k=k, v=v, kw=kw: FA.flash_attention(
                        q, k, v, **kw),
                    FA.flash_attention_plain(q, k, v, **kw)))
    b, h, tq, tkv = times.F32_LONG
    q, k, v, kw = times.d2_inputs(torch, g, "unequal", b, h, tq, tkv,
                                  dtype=torch.float32)
    out.append((f"D2 ({b}, {h}, {tq}, {tkv}, 64), formula bias",
                lambda: FA.flash_attention(q, k, v, **kw),
                FA.flash_attention_plain(q, k, v, **kw)))
    return out


def main() -> int:
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("torch_f32_body_variants: needs a CUDA card", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "torch_kernel_times", os.path.join(HERE, "scripts",
                                           "torch_kernel_times.py"))
    times = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(times)
    from tortoise_tpu_torch.ops.cuda import build
    from tortoise_tpu_torch.ops.cuda import flash_attention as FA

    torch.backends.cuda.matmul.allow_tf32 = False
    card = times.smi_line()
    libs = build_variants(build)
    for name, (_, report) in libs.items():
        print(json.dumps(dict(variant=name, ptxas=report, card=card)),
              flush=True)
    work = cases(torch, times, FA)
    torch.cuda.synchronize()
    got = {}
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            build._lib = libs[name][0]  # the wrappers launch this library
            for label, call, want in work:
                out = call()
                torch.cuda.synchronize()
                rel = times.rel_err(torch, out, want)[1]
                ms = times.cuda_ms(torch, call)
                got.setdefault((name, label), []).append((ms, rel))
    build._lib = None
    for name in libs:
        for label, _, _ in work:
            runs = got[(name, label)]
            print(json.dumps(dict(variant=name, case=label,
                                  ms=[m for m, _ in runs],
                                  rel_err=max(r for _, r in runs),
                                  card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
