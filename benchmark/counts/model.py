"""The model FLOPs of one request, by product class, for ``mfu_pct``.

Two FLOPs a multiply-add, counted for what the request needs: its own
text and tokens (no padding, no pad rows of a batch), causal attention
over the pairs it keeps. The configuration file's ``products`` maps
each kind of product below to its class (``bf16``, ``int8``, ``f32``,
``split_tf32``), and ``benchmark.peaks`` gives each class its rate.

- ``ar_linear``: the 30 blocks' four matmuls, in the prefill, in each
  decode step and in the latent pass;
- ``ar_head``: the vocabulary head, at the prefill's last position and
  each decode step;
- ``ar_attention``: q k and p v of each causal pair;
- ``diffusion_int8_linear``: the products the int8 plane quantizes (the
  resblocks' k1 and k3 convs, qkv and proj of the integrator and main
  layers, the tail's convs, the integrating conv);
- ``diffusion_linear``: the rest (latent conditioner, time MLP, FiLM
  projections, the input and output convs);
- ``diffusion_attention``: q k and p v of every (query, key) pair;
- ``vocoder``: every convolution, transposed conv and LVC.
"""

from __future__ import annotations

from benchmark.peaks import OPS_PER_S


def ar_flops(ar: dict, text_len: int, tokens: int) -> dict:
    d, f, n, v = ar["d_model"], ar["d_mlp"], ar["n_layer"], ar["n_mel_vocab"]
    per_tok = 2 * n * (3 * d * d + d * d + 2 * d * f)
    s0 = 1 + text_len + 1                      # voice, text, start
    s1 = 1 + text_len + ar["pad_mel_length"] + 2
    rows = [s0 + i + 1 for i in range(tokens - 1)]

    def causal(s):
        return 4 * d * n * s * (s + 1) / 2

    return {
        "ar_linear": per_tok * (s0 + (tokens - 1) + s1),
        "ar_head": 2.0 * d * v * tokens,
        "ar_attention": causal(s0) + causal(s1) + 4 * d * n * sum(rows),
    }


def diffusion_flops(c: dict, keep: int, out_len: int) -> dict:
    d, m = c["d_model"], c["n_mel"]
    t, steps = out_len, c["n_sample_timesteps"]
    n_attn = c["n_integrator_layers"] + c["n_main_layers"]
    n_res = n_attn + c["n_tail_resblocks"]
    cond_lin = (2 * keep * d * d * 3
                + c["n_latent_cond_blocks"] * 2 * keep * (3 * d * d + d * d))
    cond_attn = c["n_latent_cond_blocks"] * 4 * keep * keep * d
    # one eval of one row
    int8_lin = (n_res * 2 * t * (d * d + 3 * d * d)
                + n_attn * 2 * t * (3 * d * d + d * d)
                + 2 * t * 2 * d * d)
    other = (2 * (c["timestep_dim"] * d + d * d) + n_res * 2 * d * 2 * d
             + 2 * t * m * d * 3 + 2 * t * d * 2 * m * 3)
    attn = n_attn * 4 * t * t * d
    evals = 2 * steps                          # conditioned, unconditioned
    return {
        "diffusion_int8_linear": evals * int8_lin,
        "diffusion_linear": cond_lin + evals * other,
        "diffusion_attention": cond_attn + evals * attn,
    }


def vocoder_flops(c: dict, mel_frames: int) -> float:
    frames = mel_frames + c["mel_pad_frames"]
    ch, kp, k = c["ch"], c["kpnet_ch"], c["lvc_kernel"]
    out = 2 * frames * ch * c["noise_ch"] * 7
    length = frames
    for s in c["strides"]:
        length *= s
        out += 2 * length * ch * ch * 2       # transposed conv, 2s taps / s
        out += 2 * frames * (kp * c["n_mel"] * 5 + 6 * kp * kp * 3
                             + (c["kpnet_kernel_ch"] + c["kpnet_bias_ch"])
                             * kp * 3)
        out += len(c["dilations"]) * 2 * length * (ch * ch * 3
                                                    + ch * k * c["lvc_out_ch"])
    return float(out + 2 * length * ch * 7)


def request_flops(config: dict, text_len: int, tokens: int, keep: int,
                  mel_frames: int) -> dict:
    """FLOPs by product class of one request (module docstring)."""
    kinds = {**ar_flops(config["ar"], text_len, tokens),
             **diffusion_flops(config["diffusion"], keep, mel_frames),
             "vocoder": vocoder_flops(config["vocoder"], mel_frames)}
    out: dict = {}
    for kind, flops in kinds.items():
        cls = config["products"][kind]
        out[cls] = out.get(cls, 0.0) + flops
    return out


def least_time_s(flops_by_class: dict) -> float:
    return sum(f / OPS_PER_S[c] for c, f in flops_by_class.items())
