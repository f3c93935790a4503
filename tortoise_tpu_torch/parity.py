"""Parity runner against the reference's shipped fixtures, on the port's
own stages:

    python -m tortoise_tpu_torch.parity --models /path/to/models \\
        [--assets DIR] [--reference DIR] [--tol 0.01] \\
        [--stages ar,diff,voc] [--oracles] [--device cuda]

The counterpart of ``python -m tortoise_tpu.parity``, with the same
contract. It mirrors the reference's three staged regression tests
(test_autoregressive / test_diffusion / test_vocoder,
main.cpp:6256-6510):

- **autoregressive**: restore the serialized mt19937 state from
  ``assets/test_autoregressive_seed.bin`` (+ ``..._distribution.bin``),
  run the 4-candidate sampled generation of the fixed prompt on the
  reference sampler plane, compare the token sequences with the 4x500
  golden table in the reference source (main.cpp:6288-6456, parsed here)
  and the trimmed latents with ``assets/target_trimmed_latents.bin``.
- **diffusion**: seeded ``assets/diffusion_input.bin`` (43x1024 latents)
  -> mel vs ``assets/target_mel.bin`` (100x187).
- **vocoder**: ``assets/target_mel.bin`` -> audio vs
  ``assets/target_audio.bin`` (50,426 samples), default-seeded engine.

Every stage runs the f32 plane; on a CUDA device TF32 is turned off for
matmuls and cuDNN first, so the products are true f32. Tolerance follows
the reference: element-wise |diff| <= 0.01 (main.cpp:6201, 6223); token
ids exact. A stage whose weight file is absent reports SKIP (the GGML
weights are not distributed with this repo); a broken one reports FAIL
and the run exits 1; otherwise it exits 0. The device is resolved only
when a stage has its weights, so a dry run needs no card.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import re
import sys
from typing import List, Optional

import numpy as np

# the reference checkout (tortoise.cpp: main.cpp, models/, assets/), put
# in the git-ignored ``reference/`` at this repository's root; point
# --reference / --assets elsewhere to read it from another place
DEFAULT_REFERENCE = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "reference"))

# the reference's fixed test prompt token ids (main.cpp:6267-6269)
TEST_TOKENS = [255, 15, 55, 49, 9, 9, 9, 2, 134, 16, 51, 31, 2, 19, 46, 18,
               176, 13, 0, 0]

STAGE_NAMES = {"ar": "autoregressive", "diff": "diffusion", "voc": "vocoder"}


@dataclasses.dataclass
class StageResult:
    stage: str
    status: str               # "pass" | "fail" | "skip"
    detail: str = ""
    max_abs_err: Optional[float] = None
    token_mismatches: Optional[int] = None


def load_f32(path: str, count: Optional[int] = None) -> np.ndarray:
    return np.fromfile(path, dtype=np.float32, count=count or -1)


def golden_token_table(reference_dir: str = DEFAULT_REFERENCE):
    """Parse the 4x500 target_sequences table out of the reference source
    (main.cpp:6288-6456)."""
    with open(os.path.join(reference_dir, "main.cpp")) as f:
        src = f.read()
    m = re.search(
        r"std::vector<std::vector<int>> target_sequences = \{(.*?)\};",
        src, re.S)
    if not m:
        raise ValueError("target_sequences table not found in main.cpp")
    rows = re.findall(r"\{([^{}]*)\}", m.group(1))
    table = [[int(x) for x in re.findall(r"\d+", row)] for row in rows]
    if len(table) != 4 or any(len(r) != 500 for r in table):
        raise ValueError("unexpected target_sequences table shape")
    return table


def make_reference_rng(seed_file: str, dist_file: Optional[str] = None):
    """ReferenceRng restored from the reference's serialized engine-state
    fixtures (std::mt19937 operator>> dumps, main.cpp:6260-6265)."""
    from tortoise_tpu_torch.rng import ReferenceRng

    rng = ReferenceRng(0)
    rng.load_state_file(seed_file)
    if dist_file:
        try:
            rng.load_normal_state_file(dist_file)
        except ValueError:
            # uniform-distribution fixtures carry no normal state (fewer
            # than 3 fields): the only condition ignored here
            pass
    return rng


def parity_device(device=None):
    """The stage's device (None: the card, which raises without one); on
    CUDA, TF32 is turned off for matmuls and cuDNN (the f32 plane)."""
    import torch

    from tortoise_tpu_torch.pipeline.common import resolve_device

    device = resolve_device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def run_autoregressive(models_dir: str, assets_dir: str,
                       reference_dir: str = DEFAULT_REFERENCE,
                       tol: float = 0.01, device=None) -> StageResult:
    """Stage-1 golden: sampled token table (exact) + trimmed latents."""
    weights = os.path.join(models_dir, "ggml-model.bin")
    if not os.path.exists(weights):
        return StageResult("autoregressive", "skip",
                           f"weights absent: {weights}")
    from tortoise_tpu_torch.io.checkpoint import convert_ar_checkpoint
    from tortoise_tpu_torch.io.voice import load_voice_latent
    from tortoise_tpu_torch.pipeline import ar_stage

    params = convert_ar_checkpoint(weights)
    rng = make_reference_rng(
        os.path.join(assets_dir, "test_autoregressive_seed.bin"),
        os.path.join(assets_dir, "test_autoregressive_distribution.bin"))
    voice = load_voice_latent(os.path.join(models_dir, "mol.bin"))
    latents, sequences = ar_stage.autoregressive(
        params, TEST_TOKENS, voice, batch_size=4, sampler="reference",
        rng=rng, device=parity_device(device))

    want_table = golden_token_table(reference_dir)
    # the reference compares the trim_latents view: start/stop stripped
    # (main.cpp:4881-4886)
    got = [s[1:-1] for s in sequences]
    if len(got) != len(want_table) or any(
            len(g) != len(w) for g, w in zip(got, want_table)):
        return StageResult(
            "autoregressive", "fail",
            f"sequence shape mismatch: {[len(g) for g in got]} vs "
            f"{[len(w) for w in want_table]}")
    mismatches = sum(1 for g, w in zip(got, want_table)
                     for a, b in zip(g, w) if a != b)

    flat = np.concatenate([l.reshape(-1) for l in latents])
    want = load_f32(os.path.join(assets_dir, "target_trimmed_latents.bin"))
    if flat.shape != want.shape:
        return StageResult(
            "autoregressive", "fail",
            f"latent shape {flat.shape} != fixture {want.shape}; "
            f"{mismatches} token mismatches",
            token_mismatches=mismatches)
    err = float(np.max(np.abs(flat - want)))
    ok = mismatches == 0 and err <= tol
    return StageResult("autoregressive", "pass" if ok else "fail",
                       max_abs_err=err, token_mismatches=mismatches)


def run_diffusion(models_dir: str, assets_dir: str, tol: float = 0.01,
                  device=None) -> StageResult:
    """Stage-2 golden: diffusion_input.bin -> target_mel.bin."""
    weights = os.path.join(models_dir, "ggml-diffusion-model.bin")
    if not os.path.exists(weights):
        return StageResult("diffusion", "skip",
                           f"weights absent: {weights}")
    from tortoise_tpu_torch.io.checkpoint import convert_diffusion_checkpoint
    from tortoise_tpu_torch.pipeline import diffusion_stage

    params = convert_diffusion_checkpoint(weights)
    rng = make_reference_rng(
        os.path.join(assets_dir, "test_diffusion_seed.bin"),
        os.path.join(assets_dir, "test_diffusion_normal_distribution.bin"))
    latents = load_f32(
        os.path.join(assets_dir, "diffusion_input.bin")).reshape(43, 1024)
    mel = diffusion_stage.diffusion(params, latents, rng=rng,
                                    device=parity_device(device))
    want = load_f32(os.path.join(assets_dir, "target_mel.bin")
                    ).reshape(100, 187)
    if mel.shape != want.shape:
        return StageResult("diffusion", "fail",
                           f"mel shape {mel.shape} != fixture {want.shape}")
    err = float(np.max(np.abs(mel - want)))
    return StageResult("diffusion", "pass" if err <= tol else "fail",
                       max_abs_err=err)


def run_vocoder(models_dir: str, assets_dir: str, tol: float = 0.01,
                device=None) -> StageResult:
    """Stage-3 golden: target_mel.bin -> target_audio.bin."""
    weights = os.path.join(models_dir, "ggml-vocoder-model.bin")
    if not os.path.exists(weights):
        return StageResult("vocoder", "skip",
                           f"weights absent: {weights}")
    from tortoise_tpu_torch.io.checkpoint import convert_vocoder_checkpoint
    from tortoise_tpu_torch.pipeline import vocoder_stage
    from tortoise_tpu_torch.rng import ReferenceRng

    params = convert_vocoder_checkpoint(weights)
    # standalone, the reference's vocoder test runs with the
    # process-default engine (seed 5489)
    rng = ReferenceRng(5489)
    mel = load_f32(os.path.join(assets_dir, "target_mel.bin")
                   ).reshape(100, 187)
    audio = vocoder_stage.vocoder(params, mel, rng=rng,
                                  device=parity_device(device))
    want = load_f32(os.path.join(assets_dir, "target_audio.bin"))
    if audio.shape != want.shape:
        return StageResult(
            "vocoder", "fail",
            f"audio shape {audio.shape} != fixture {want.shape}")
    err = float(np.max(np.abs(audio - want)))
    return StageResult("vocoder", "pass" if err <= tol else "fail",
                       max_abs_err=err)


STAGES = {
    "ar": run_autoregressive,
    "diff": run_diffusion,
    "voc": run_vocoder,
}


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tortoise_tpu_torch.parity",
        description="Run the reference's staged golden regressions "
                    "against the PyTorch port.")
    p.add_argument("--models", required=True,
                   help="directory with ggml-model.bin / "
                        "ggml-diffusion-model.bin / ggml-vocoder-model.bin "
                        "/ mol.bin")
    p.add_argument("--assets", default=None,
                   help="fixtures directory (default: <reference>/assets)")
    p.add_argument("--reference", default=DEFAULT_REFERENCE,
                   help="reference checkout (for the golden token table)")
    p.add_argument("--tol", type=float, default=0.01,
                   help="element-wise abs tolerance (reference: 0.01)")
    p.add_argument("--stages", default="ar,diff,voc",
                   help="comma list from {ar,diff,voc}")
    p.add_argument("--oracles", action="store_true",
                   help="also run the port's oracle suites "
                        "(tests/test_torch_*_oracle.py), which compile the "
                        "reference's own functions from source")
    p.add_argument("--device", default="cuda",
                   help="torch device of the stages (default cuda; fails "
                        "without a card, pass --device cpu for the CPU)")
    args = p.parse_args(argv)
    assets = args.assets or os.path.join(args.reference, "assets")
    names = [n.strip() for n in args.stages.split(",")]
    for name in names:
        if name not in STAGES:
            p.error(f"unknown stage '{name}'")

    if args.oracles:
        import subprocess

        tests_dir = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tests")
        suites = sorted(
            os.path.join(tests_dir, f) for f in os.listdir(tests_dir)
            if re.fullmatch(r"test_torch_\w+_oracle\.py", f)) \
            if os.path.isdir(tests_dir) else []
        if not suites:
            # a bare `pytest -q` would run the whole suite instead
            print("oracle suites: none found under tests/ "
                  "(test_torch_*_oracle.py)", flush=True)
            return 2
        rc = subprocess.call([sys.executable, "-m", "pytest", "-q", *suites])
        print(f"oracle suites: {'PASS' if rc == 0 else 'FAIL'}", flush=True)
        if rc != 0:
            return rc

    results: List[StageResult] = []
    for name in names:
        try:
            if name == "ar":
                r = run_autoregressive(args.models, assets, args.reference,
                                       args.tol, args.device)
            else:
                r = STAGES[name](args.models, assets, args.tol, args.device)
        except FileNotFoundError as e:
            # a missing voice, fixture or reference file is environmental,
            # like missing weights: SKIP, and go on with the other stages
            r = StageResult(STAGE_NAMES[name], "skip", f"missing file: {e}")
        except Exception as e:
            r = StageResult(STAGE_NAMES[name], "fail",
                            f"{type(e).__name__}: {e}")
        results.append(r)
        bits = [f"{r.stage:16s} {r.status.upper()}"]
        if r.max_abs_err is not None:
            bits.append(f"max|d|={r.max_abs_err:.3e} (tol {args.tol:g})")
        if r.token_mismatches is not None:
            bits.append(f"token mismatches={r.token_mismatches}")
        if r.detail:
            bits.append(r.detail)
        print("  ".join(bits), flush=True)

    n_fail = sum(r.status == "fail" for r in results)
    n_skip = sum(r.status == "skip" for r in results)
    n_pass = sum(r.status == "pass" for r in results)
    print(f"parity: {n_pass} pass, {n_fail} fail, {n_skip} skip"
          + ("  (skipped stages need the GGML weight files)"
             if n_skip else ""))
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
