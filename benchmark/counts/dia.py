"""The work of one Dia request: the model FLOPs by product class, for
``dia_mfu_pct.single``, and the bytes a decode step must read, for
``dia_step_roofline_pct.single``.

Two FLOPs a multiply-add, counted for what the request needs: the text's
own bytes and the cache's valid positions (no bucket padding), both CFG
rows. The configuration's ``products`` maps each kind to its class:

- ``dia_linear``: every product with a weight: the encoder's layers over
  the text, the cross K/V projections once a request, the decoder's
  layers at each prefill position and decode step, the head at each
  step;
- ``dia_attention``: q k and p v of every (query, key) pair: the
  encoder's, the prefill's causal and cross pairs, each step's self
  (its valid keys) and cross pairs;
- ``dac``: the DAC decoder's convolutions over the generated frames.

A decode step at B = 2 reads each weight it multiplies once
(``step_weights``: the self and cross q/o, the fused q/k/v, both MLP
products, the norms and the head; not the cross K/V projections, which
run once a request, nor the embeddings, which it gathers), the self K/V
of its valid positions (``kv_bytes_per_frame`` each) and the text's
cross K/V (``cross_bytes_per_byte`` each), in bf16.
"""

from __future__ import annotations

from benchmark.peaks import HBM_BYTES_PER_S, OPS_PER_S


def params(c: dict, dc: dict = None) -> dict:
    """Parameter counts: ``encoder`` (its layers and final norm),
    ``decoder`` (its layers and final norm), ``embeddings`` (the byte
    table, the codes' table and the head), and ``dac`` with ``dc``."""
    e, d = c["enc_dim"], c["dec_dim"]
    eq, ekv = (c["enc_heads"] * c["enc_head_dim"],
               c["enc_kv_heads"] * c["enc_head_dim"])
    enc = c["enc_layers"] * (2 * e + e * (eq + 2 * ekv) + eq * e
                             + 3 * c["enc_ffn"] * e) + e
    dec = c["dec_layers"] * (step_layer(c) + 2 * cross_width(c) * e) + d
    out = {"encoder": enc, "decoder": dec,
           "embeddings": c["enc_vocab"] * e
           + 2 * c["channels"] * c["vocab"] * d}
    if dc is not None:
        out["dac"] = dac_params(dc)
    return out


def cross_width(c: dict) -> int:
    return c["cross_heads"] * c["cross_head_dim"]


def step_layer(c: dict) -> int:
    """The weights of one decoder layer a step multiplies: three norms,
    the fused q/k/v, o, the cross q and o, the MLP."""
    d = c["dec_dim"]
    dq, dkv = (c["dec_heads"] * c["dec_head_dim"],
               c["dec_kv_heads"] * c["dec_head_dim"])
    cw = cross_width(c)
    return (3 * d + d * (dq + 2 * dkv) + dq * d + 2 * cw * d
            + 3 * c["dec_ffn"] * d)


def step_weights(c: dict) -> int:
    """The weights one decode step reads: every layer's, the final norm
    and the head."""
    d = c["dec_dim"]
    return (c["dec_layers"] * step_layer(c) + d
            + c["channels"] * c["vocab"] * d)


def kv_bytes_per_frame(c: dict, elem: int = 2) -> int:
    """The self K/V of one cached position, both rows, every layer."""
    return (2 * 2 * c["dec_layers"] * c["dec_kv_heads"]
            * c["dec_head_dim"] * elem)


def cross_bytes_per_byte(c: dict, elem: int = 2) -> int:
    """The cross K/V of one text byte, both rows, every layer."""
    return 2 * 2 * c["dec_layers"] * cross_width(c) * elem


def step_bytes(c: dict, kv_len: int, text_len: int) -> int:
    """The least bytes one decode step reads: its weights, ``kv_len``
    positions of self K/V and ``text_len`` bytes of cross K/V."""
    return (2 * step_weights(c) + kv_len * kv_bytes_per_frame(c)
            + text_len * cross_bytes_per_byte(c))


def loop_bound_s(c: dict, prompt: int, text_len: int, steps: int) -> float:
    """The least time of a loop of ``steps`` steps after a ``prompt``
    position prefill: step s reads prompt + s + 1 valid positions."""
    kv = steps * (prompt + 1) + steps * (steps - 1) // 2
    return ((steps * (2 * step_weights(c) + text_len
                      * cross_bytes_per_byte(c))
             + kv * kv_bytes_per_frame(c)) / HBM_BYTES_PER_S)


def step_flops(c: dict) -> int:
    """The products with weights of one decode step, both rows."""
    return 2 * 2 * (step_weights(c) - c["dec_layers"] * 3 * c["dec_dim"]
                    - c["dec_dim"])


def dac_params(dc: dict) -> int:
    n, lat, ch = dc["n_codebooks"], dc["latent"], dc["dim"]
    total = n * dc["codebook_size"] * dc["codebook_dim"] \
        + n * (lat * dc["codebook_dim"] + lat) + ch * lat * 7 + ch
    for s in dc["rates"]:
        o = ch // 2
        total += ch + ch * o * 2 * s + o + 3 * (2 * o + o * o * 7 + o
                                                + o * o + o)
        ch = o
    return total + ch + ch * 7 + 1


def dac_flops_per_frame(dc: dict) -> int:
    """The DAC decoder's products for one frame of codes."""
    lat, ch = dc["latent"], dc["dim"]
    f = 2 * dc["n_codebooks"] * dc["codebook_dim"] * lat + 2 * lat * ch * 7
    samples = 1
    for s in dc["rates"]:
        o = ch // 2
        f += samples * 2 * ch * o * 2 * s  # each input sample's 2s taps
        samples *= s
        f += samples * 3 * 2 * (o * o * 7 + o * o)
        ch = o
    return f + samples * 2 * ch * 7


def request_flops(c: dict, dc: dict, prompt: int, text_len: int,
                  frames: int, steps: int) -> dict:
    """A whole request: the encoder over ``text_len`` bytes, the cross
    K/V, the prefill of ``prompt`` positions, ``steps`` decode steps,
    and the DAC over ``frames`` frames."""
    e = c["enc_dim"]
    per_enc_token = 2 * (params(c)["encoder"] - c["enc_layers"] * 2 * e - e)
    enc_attn = 2 * 4 * c["enc_layers"] * c["enc_heads"] \
        * c["enc_head_dim"] * text_len * text_len
    cross = 2 * 2 * c["dec_layers"] * 2 * cross_width(c) * e * text_len
    lin_step = step_flops(c)
    dq, cw = c["dec_heads"] * c["dec_head_dim"], cross_width(c)
    # causal pairs of the prefill, then each step's valid keys
    self_pairs = prompt * (prompt + 1) // 2 \
        + steps * (prompt + 1) + steps * (steps - 1) // 2
    attn = 2 * 4 * c["dec_layers"] * (
        dq * self_pairs + cw * text_len * (prompt + steps))
    head = 2 * 2 * c["channels"] * c["vocab"] * c["dec_dim"]
    return {"dia_linear": 2 * text_len * per_enc_token + cross
            + prompt * (lin_step - head) + steps * lin_step,
            "dia_attention": enc_attn + attn,
            "dac": frames * dac_flops_per_frame(dc)}


def least_time_s(flops: dict, products: dict) -> float:
    """Each class's FLOPs at its peak (``benchmark.peaks``)."""
    return sum(f / OPS_PER_S[products[k]] for k, f in flops.items())
