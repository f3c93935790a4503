"""Kernel A (``csrc/decode_trunk.cu``, one launch a decode step): the
int8 decode step of the 30-layer AR trunk with the head and sampler.

Bytes a call needs: every int8 matmul weight and its f32 column scales,
the f32 norm and bias vectors, the padded int8 head with its scales and
bias (the vocabulary padded to a multiple of 128) and the four head norm
vectors, the bf16 K and V rows of the cache up to the step's position,
the f32 key-bias row over them, the f32 input row, and the outputs (the
new bf16 K and V rows, the hidden row, the padded logits, the token).
"""

SYMBOL = "decode_step_kernel"


def bytes_per_call(ar: dict, batch: int, kv_rows: int) -> float:
    d, f, n = ar["d_model"], ar["d_mlp"], ar["n_layer"]
    vp = (ar["n_mel_vocab"] + 127) // 128 * 128
    weights = n * (d * 3 * d + d * d + d * f + f * d)            # int8
    scales = 4 * n * (3 * d + d + f + d)
    vectors = 4 * n * (2 * d + 3 * d + d + 2 * d + f + d)
    head = d * vp + 4 * 2 * vp + 4 * 4 * d
    cache = batch * (2 * n * kv_rows * d * 2 + 4 * kv_rows)
    io = batch * (4 * d + 2 * n * d * 2 + 4 * d + 4 * vp + 4 + 8)
    return float(weights + scales + vectors + head + cache + io)


def calls(ar: dict, text_len: int, tokens: int, batch: int = 1) -> list:
    """(batch, kv_rows) of each call decoding ``tokens`` after a text of
    ``text_len`` ids: the first token comes from the prefill, each later
    one from a call that reads the voice, text and start rows and the
    rows written before it."""
    prefix = 1 + text_len + 1
    return [(batch, prefix + i) for i in range(tokens - 1)]


def bound_s(ar: dict, calls_: list) -> float:
    """The least time of ``calls_``: bytes over HBM (its operations, ~2
    a weight byte, take far less)."""
    from benchmark.peaks import HBM_BYTES_PER_S

    return sum(bytes_per_call(ar, b, r) for b, r in calls_) / HBM_BYTES_PER_S
