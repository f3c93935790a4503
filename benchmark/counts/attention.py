"""Kernels B (``csrc/flash_attention.cu`` ``qkv_kernel``, bf16) and Bf
(``csrc/flash_attention_bhtd.cu`` ``attn_tf32x3``, f32 in split TF32):
the denoiser's relative-position attention, one call an attention
block, over (rows, T) x heads x 64.

A call needs 4 * D operations and one exp a (query, key) pair of each
row and head, and reads the packed qkv and the (32, H) bucket table and
writes the context once. Bf runs each f32 product as three TF32 ones.
"""

from benchmark.peaks import EXPS_PER_S, HBM_BYTES_PER_S, OPS_PER_S

SYMBOLS = {"bf16": "qkv_kernel<false>", "f32": "attn_tf32x3"}


def work(rows: int, t: int, heads: int, d: int, elem: int) -> dict:
    pairs = rows * heads * t * t
    return {"flops": 4.0 * d * pairs, "exps": float(pairs),
            "bytes": float(rows * t * 4 * heads * d * elem
                           + 32 * heads * 4 + rows * t)}


def bound_s(rows: int, t: int, heads: int, d: int, plane: str) -> float:
    """The least time of one call: the larger of its products at the
    plane's rate, its exps and its bytes."""
    if plane == "bf16":
        w, rate = work(rows, t, heads, d, 2), OPS_PER_S["bf16"]
    else:
        w, rate = work(rows, t, heads, d, 4), OPS_PER_S["split_tf32"]
    return max(w["flops"] / rate, w["exps"] / EXPS_PER_S,
               w["bytes"] / HBM_BYTES_PER_S)


def calls(diffusion: dict, keep: int, out_len: int, rows: int = 1) -> list:
    """(rows, T) of each call a request's diffusion stage makes: the
    latent conditioner's blocks at its latent count, then each step's
    integrator and main layers over the conditioned and unconditioned
    rows at its mel length."""
    per_step = diffusion["n_integrator_layers"] + diffusion["n_main_layers"]
    return ([(rows, keep)] * diffusion["n_latent_cond_blocks"]
            + [(2 * rows, out_len)] * (per_step
                                       * diffusion["n_sample_timesteps"]))
