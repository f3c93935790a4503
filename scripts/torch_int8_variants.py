#!/usr/bin/env python3
"""Variants of kernel F (``csrc/flash_attention_int8.cu``, the int8-score
packed attention) side by side on one NVIDIA card: each variant is the
source with one design choice changed by a text substitution, built with
nvcc into its own library under ``tortoise_tpu_torch/_build/variants/``
(all builds at once); then each runs kernel F through the port's wrapper
at the A/B's (2, 2176) x 16 x 64 in bf16, at 2048 rows (512 blocks: no
third wave on 132 SMs at two blocks an SM, where 2176 rows make 544) and
at 8 heads of 128, in two rounds (forward, then reversed):

    python3 scripts/torch_int8_variants.py

Variants: "as built"; "one block an SM at width 64" (no register cap of
two blocks); "3 stages" (the ring); "512-thread quantize blocks" (twice
the quantize pass's threads, one 16-byte chunk a thread a tile at width
64); "no uniform-tile path" (every tile
takes the bias and mask from the staged window; the same bits);
"fast exp" (``__expf``, ex2.approx: a timing probe of what expf's
accuracy costs; it may flip weights, and the error column says whether
it did); "no pass 1" (the row max taken as 30: a timing probe of the
second walk, its output wrong). Each line of output is one JSON object:
the variant, the case, the device ms of the quantize pass and of the
attention kernel alone in each round (chip_smoke's cuda_ms), the
output's max abs difference from the plain version, the card's name and
power limit; one line a variant has its ptxas register and spill report.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PASS1 = """    score_tile<D>(s, qa, stage);
    float b0;
    if (uniform_tile(bw, mk, lo, lane, b0)) {
      // the max"""
VARIANTS = {
    "as built": [],
    "one block an SM at width 64": [(
        "static constexpr int kMinBlocks = D > 64 ? 1 : 2;",
        "static constexpr int kMinBlocks = D > 32 ? 1 : 2;")],
    "3 stages": [("constexpr int kStages = 4;", "constexpr int kStages = 3;")],
    "512-thread quantize blocks": [(
        "constexpr int kQuantThreads = 256;",
        "constexpr int kQuantThreads = 512;")],
    "no uniform-tile path": [(
        "  return __all_sync(0xffffffffu, same);",
        "  return false && __all_sync(0xffffffffu, same);")],
    "fast exp": [('#include "common.cuh"\n',
                  '#include "common.cuh"\n#define expf __expf\n')],
    "no pass 1": [
        ("  float ma = -INFINITY, mb = -INFINITY;",
         "  float ma = 30.f, mb = 30.f;"),
        (_PASS1, """    float b0;
    if (true) {
      // the max""")],
}
ENTRIES = ("tt_int8_quantize_kv", "tt_flash_packed_i8")


def build_variants(build) -> dict:
    """{variant: (loaded library, ptxas report)}; raises if a
    substitution no longer matches the source or a build fails."""
    src = (build.SRC_DIR / "flash_attention_int8.cu").read_text()
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
        cu = out_dir / f"int8_variant{i}.cu"
        cu.write_text(text)
        so = out_dir / f"int8_variant{i}.so"
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
        for entry in ENTRIES:
            fn = getattr(lib, entry)
            fn.argtypes = list(build.SIGNATURES[entry])
            fn.restype = ctypes.c_int
        report = [ln.split("ptxas info    :")[-1].strip()
                  for ln in log.splitlines()
                  if ("registers" in ln or "spill" in ln)]
        libs[name] = (lib, report)
    return libs


def main() -> int:
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_int8_variants: needs a CUDA card", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from tortoise_tpu_torch.ops.cuda import build
    from tortoise_tpu_torch.ops.cuda import flash_attention_int8 as K

    card = smoke.smi_line()
    libs = build_variants(build)
    for name, (_, report) in libs.items():
        print(json.dumps(dict(variant=name, ptxas=report, card=card)),
              flush=True)
    rng = np.random.default_rng(10)
    work = []
    for b, t, h, d in (smoke.F_SHAPE, (2, 2048, 16, 64), (2, 2176, 8, 128)):
        qkv = torch.as_tensor(rng.normal(0, 1, (b, t, 3 * h * d)).astype(
            np.float32)).cuda().bfloat16()
        table = torch.as_tensor(rng.normal(0, 0.1, (32, h)).astype(
            np.float32)).cuda()
        valid = torch.ones((b, t), dtype=torch.bool, device="cuda")
        mask, bias = K.i8_side_inputs(qkv, h, valid, table)
        want = K.flash_packed_i8_plain(qkv, h, valid, table)
        work.append((f"F ({b}, {t}) x {h} heads of {d}", qkv, h, mask, bias,
                     want))
    torch.cuda.synchronize()
    got = {}
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            build._lib = libs[name][0]  # the wrappers launch this library
            for label, qkv, h, mask, bias, want in work:
                out = K.launch_i8(qkv, h, mask, bias)
                torch.cuda.synchronize()
                err = float((out.float() - want.float()).abs().max())
                kv = K.quantize_kv(qkv, h)
                quant_ms = smoke.cuda_ms(torch, lambda: K.quantize_kv(qkv, h))
                attn_ms = smoke.cuda_ms(torch, lambda: K.attend_i8(
                    qkv, h, kv, mask, bias))
                got.setdefault((name, label), []).append(
                    (quant_ms, attn_ms, err))
    build._lib = None
    for name in libs:
        for label, *_ in work:
            runs = got[(name, label)]
            print(json.dumps(dict(variant=name, case=label,
                                  quant_ms=[r[0] for r in runs],
                                  attn_ms=[r[1] for r in runs],
                                  max_abs_err=max(r[2] for r in runs),
                                  card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
