"""The model FLOPs of one F5-TTS request, by product class, for
``f5_mfu_pct.single``, and the work of kernel B in its loop, for
``f5_attention_roofline_pct.single``.

Two FLOPs a multiply-add, counted for what the request needs: its own T
frames (no bucket padding), both CFG rows of every one of the ``nfe``
evals. The configuration's ``products`` maps each kind to its class:

- ``dit_linear``: the blocks' q, k, v, out and FFN products, the input
  projection, the output projection, once a row and frame; the time MLP
  and every AdaLN product, once an eval;
- ``dit_conv``: the conv position embedding's two grouped convs;
- ``dit_attention``: q k and p v of every (query, key) pair of every
  block and head;
- ``text_linear``: the text encoder's ConvNeXt-V2 blocks (depthwise conv
  and both products), once a request for both rows;
- ``vocos``: Vocos's convolutions and products over the generated
  frames (the iSTFT's FFT is not a product and is left out).

``weight_bytes`` is what one eval reads of the DiT's weights.
"""

from __future__ import annotations

from benchmark.counts import attention
from benchmark.peaks import OPS_PER_S


def eval_flops(c: dict, t: int) -> dict:
    """One CFG eval (both rows) at T = ``t`` frames."""
    d, n, m, td = c["dim"], c["depth"], c["mel_dim"], c["text_dim"]
    ff = d * c["ff_mult"]
    per_frame = (n * 2 * (4 * d * d + 2 * d * ff)
                 + 2 * (2 * m + td) * d + 2 * d * m)
    once = 2 * (c["freq_embed_dim"] * d + d * d) + 2 * d * (6 * d * n + 2 * d)
    conv = 2 * 2 * d * (d // c["conv_pos_groups"]) * c["conv_pos_kernel"]
    return {"dit_linear": 2 * t * per_frame + once,
            "dit_conv": 2 * t * conv,
            "dit_attention": 2 * n * 4 * t * t * d}


def request_flops(c: dict, vc: dict, t: int, t_ref: int) -> dict:
    """A whole request: ``nfe`` evals, the text encoder, Vocos on the
    generated T - T_ref frames."""
    out = {k: c["nfe"] * v for k, v in eval_flops(c, t).items()}
    td, ti = c["text_dim"], c["text_dim"] * c["conv_mult"]
    out["text_linear"] = 2 * t * c["conv_layers"] * (2 * 2 * td * ti
                                                     + 2 * td * 7)
    vd, vi = vc["dim"], vc["intermediate_dim"]
    per_frame = (2 * vc["n_mel"] * vd * 7
                 + vc["layers"] * (2 * vd * 7 + 2 * 2 * vd * vi)
                 + 2 * vd * (vc["n_fft"] + 2))
    out["vocos"] = (t - t_ref) * per_frame
    return out


def least_time_s(flops: dict, products: dict) -> float:
    """Each class's FLOPs at its peak (``benchmark.peaks``)."""
    return sum(f / OPS_PER_S[products[k]] for k, f in flops.items())


def weight_bytes(c: dict, elem: int = 2) -> int:
    d, n, m, td = c["dim"], c["depth"], c["mel_dim"], c["text_dim"]
    ff = d * c["ff_mult"]
    blocks = n * (6 * d * d + 4 * d * d + 2 * d * ff + 6 * d + 4 * d + ff + d)
    rest = ((2 * m + td) * d + d + 2 * (d * d // c["conv_pos_groups"]
                                        * c["conv_pos_kernel"] + d)
            + 2 * d * d + 2 * d + m * d + m
            + c["freq_embed_dim"] * d + d * d + 2 * d)
    return elem * (blocks + rest)


def attention_bound_s(c: dict, t_pad: int, evals: int) -> float:
    """Kernel B's least time over ``evals`` evals at the padded length:
    one call a block, both rows (``counts.attention.bound_s``, its bf16
    plane)."""
    return evals * c["depth"] * attention.bound_s(
        2, t_pad, c["heads"], c["dim"] // c["heads"], "bf16")
