"""Seeded random weights of Tortoise-TTS v2, drawn on the device.

The published weights are not redistributable, so every run draws its
own from ``--seed``: one ``torch.Generator`` on the device, one
``randn`` per model (AR, diffusion, vocoder) into a flat float32 buffer,
carved into the tensors of the port's tree layout. Each tensor is
N(0, std) with the std of its model (0.02, 0.02, 0.05) and norm weights
centred at 1: the scale rules of the port's ``random_*_params``, frozen
here. The trees are plain dicts of float32 tensors; the program casts
or quantizes them itself, and the reference rounds them again from the
same floats.
"""

from __future__ import annotations

import math

import torch

# tree leaves whose name ends so are norm weights, centred at 1
_NORM_WEIGHTS = ("ln1_w", "ln2_w", "ln_f_w", "lm_ln_w", "norm_w")


def ar_shapes(c: dict) -> dict:
    d, f, n = c["d_model"], c["d_mlp"], c["n_layer"]
    return {
        "text_emb": (c["n_text_vocab"], d), "text_pos": (c["n_text_pos"], d),
        "mel_emb": (c["n_mel_vocab"], d), "mel_pos": (c["n_mel_pos"], d),
        "blocks": {
            "ln1_w": (n, d), "ln1_b": (n, d),
            "attn_w": (n, d, 3 * d), "attn_b": (n, 3 * d),
            "proj_w": (n, d, d), "proj_b": (n, d),
            "ln2_w": (n, d), "ln2_b": (n, d),
            "fc_w": (n, d, f), "fc_b": (n, f),
            "fc_proj_w": (n, f, d), "fc_proj_b": (n, d),
        },
        "ln_f_w": (d,), "ln_f_b": (d,), "lm_ln_w": (d,), "lm_ln_b": (d,),
        "lm_w": (c["n_mel_vocab"], d), "lm_b": (c["n_mel_vocab"],),
    }


def _resblock(n, d):
    return {
        "res_in_norm_w": (n, d), "res_in_norm_b": (n, d),
        "res_in_conv_w": (n, d, d), "res_in_conv_b": (n, d),
        "res_emb_w": (n, 2 * d, d), "res_emb_b": (n, 2 * d),
        "res_out_norm_w": (n, d), "res_out_norm_b": (n, d),
        "res_out_conv_w": (n, d, d, 3), "res_out_conv_b": (n, d),
    }


def _attn(n, d, c):
    return {
        "attn_norm_w": (n, d), "attn_norm_b": (n, d),
        "attn_qkv_w": (n, 3 * d, d), "attn_qkv_b": (n, 3 * d),
        "attn_proj_w": (n, d, d), "attn_proj_b": (n, d),
        "attn_rel_w": (n, c["rel_pos_buckets"], c["n_head"]),
    }


def diffusion_shapes(c: dict) -> dict:
    d, m = c["d_model"], c["n_mel"]
    ni, nl, nt = (c["n_integrator_layers"], c["n_main_layers"],
                  c["n_tail_resblocks"])
    return {
        "cond_scale": (d,), "cond_shift": (d,),
        "latent_conv_w": (d, d, 3), "latent_conv_b": (d,),
        "latent_blocks": _attn(c["n_latent_cond_blocks"], d, c),
        "code_norm_w": (d,), "code_norm_b": (d,),
        "time_w0": (d, c["timestep_dim"]), "time_b0": (d,),
        "time_w1": (d, d), "time_b1": (d,),
        "integrator": {**_resblock(ni, d), **_attn(ni, d, c)},
        "inp_w": (d, m, 3), "inp_b": (d,),
        "integrating_w": (d, 2 * d), "integrating_b": (d,),
        "layers": {**_resblock(nl, d), **_attn(nl, d, c)},
        "tail": _resblock(nt, d),
        "out_norm_w": (d,), "out_norm_b": (d,),
        "out_w": (2 * m, d, 3), "out_b": (2 * m,),
        "uncond": (d,),
    }


def vocoder_shapes(c: dict) -> dict:
    ch, kp, mel = c["ch"], c["kpnet_ch"], c["n_mel"]
    nb = len(c["dilations"])
    stages = [{
        "kp_in_w": (kp, mel, 5), "kp_in_b": (kp,),
        "kp_res": {"w1": (3, kp, kp, 3), "b1": (3, kp),
                   "w3": (3, kp, kp, 3), "b3": (3, kp)},
        "kp_kernel_w": (c["kpnet_kernel_ch"], kp, 3),
        "kp_kernel_b": (c["kpnet_kernel_ch"],),
        "kp_bias_w": (c["kpnet_bias_ch"], kp, 3),
        "kp_bias_b": (c["kpnet_bias_ch"],),
        "convt_w": (ch, ch, 2 * s), "convt_b": (ch,),
        "cb_w": (nb, ch, ch, 3), "cb_b": (nb, ch),
    } for s in c["strides"]]
    return {"pre_w": (ch, c["noise_ch"], 7), "pre_b": (ch,),
            "stages": stages, "post_w": (1, ch, 7), "post_b": (1,)}


def _leaves(shapes, prefix=""):
    if isinstance(shapes, dict):
        for k, v in shapes.items():
            yield from _leaves(v, k)
    elif isinstance(shapes, list):
        for v in shapes:
            yield from _leaves(v, prefix)
    else:
        yield prefix, shapes


def numel(shapes) -> int:
    return sum(math.prod(s) for _, s in _leaves(shapes))


def _carve(buf, shapes, off):
    """The tree of ``shapes`` as views of ``buf`` from ``off``; norm
    weights get 1 added. Returns (tree, next offset)."""
    if isinstance(shapes, dict):
        out = {}
        for k, v in shapes.items():
            out[k], off = _carve(buf, v, off)
            if k.endswith(_NORM_WEIGHTS) and isinstance(out[k], torch.Tensor):
                out[k].add_(1.0)
        return out, off
    if isinstance(shapes, list):
        out = []
        for v in shapes:
            t, off = _carve(buf, v, off)
            out.append(t)
        return out, off
    n = math.prod(shapes)
    return buf[off:off + n].view(shapes), off + n


def _draw(gen, shapes, std, device):
    buf = torch.randn(numel(shapes), generator=gen, device=device,
                      dtype=torch.float32).mul_(std)
    return _carve(buf, shapes, 0)[0]


def make(config: dict, seed: int, device) -> dict:
    """{"ar", "diffusion", "vocoder"} float32 trees on ``device`` from
    ``seed``: the same seed gives the same weights."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    w = config["weights"]
    return {
        "ar": _draw(gen, ar_shapes(config["ar"]), w["ar_std"], device),
        "diffusion": _draw(gen, diffusion_shapes(config["diffusion"]),
                           w["diffusion_std"], device),
        "vocoder": _draw(gen, vocoder_shapes(config["vocoder"]),
                         w["vocoder_std"], device),
    }
