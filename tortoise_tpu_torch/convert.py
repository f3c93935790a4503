"""Checkpoint conversion:

    python -m tortoise_tpu_torch.convert --models /path/to/models --out cache/

Converts the reference's GGML weight files into the npz pytree caches
that ``TortoiseModels.from_ggml_dir(models, cache_dir=out)`` (and
``cli.py --cache-dir``) load directly, through the port's own
``io/checkpoint`` converters. The files are the JAX package's
(``ar.npz``, ``diffusion.npz``, ``vocoder.npz``), so either package reads
them. Host-only: no device is touched. Exits 1 when a weight file is
missing (the others are still converted).
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tortoise_tpu_torch.convert")
    p.add_argument("--models", required=True,
                   help="directory with ggml-*.bin files")
    p.add_argument("--out", required=True, help="output cache directory")
    args = p.parse_args(argv)

    from tortoise_tpu_torch.io.checkpoint import (
        convert_ar_checkpoint,
        convert_diffusion_checkpoint,
        convert_vocoder_checkpoint,
    )

    os.makedirs(args.out, exist_ok=True)
    jobs = [
        ("ggml-model.bin", "ar.npz", convert_ar_checkpoint),
        ("ggml-diffusion-model.bin", "diffusion.npz",
         convert_diffusion_checkpoint),
        ("ggml-vocoder-model.bin", "vocoder.npz",
         convert_vocoder_checkpoint),
    ]
    rc = 0
    for src, dst, fn in jobs:
        path = os.path.join(args.models, src)
        if not os.path.exists(path):
            print(f"skip {src}: not found", file=sys.stderr)
            rc = 1
            continue
        t0 = time.monotonic()
        fn(path, os.path.join(args.out, dst))
        print(f"{src} -> {dst} ({time.monotonic() - t0:.1f}s)")
    return rc


if __name__ == "__main__":
    sys.exit(main())
