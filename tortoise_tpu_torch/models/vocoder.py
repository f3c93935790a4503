"""UnivNet-style kernel-predictor / location-variable-convolution vocoder
(counterpart of ``tortoise_tpu/models/vocoder.py``).

noise (64 ch) -> reflect pad 3 -> conv_pre k7 -> 3 upsample stages
(leaky -> conv_transpose -> trim; kernel predictor on the padded mel;
4 conv blocks: leaky -> dilated conv k3 -> leaky -> LVC -> gated
sigmoid*tanh -> residual) -> leaky -> conv_post k7 with no padding, so
audio length = M*256 - 6. The LVC runs as one batched matmul per hop
chunk, or with ``cfg.use_pallas_lvc`` as kernel E (``ops.cuda.lvc``),
which fuses it with the gate and the residual add. With a bucketed
length (``mel_len``) every stage masks past the true length and the
input reflection is written at the true edges.

Tensor parallelism (``tp``, an ``AxisGroup`` on the mesh's "tp" axis,
with the tree from ``parallel.shard_tree``): each rank computes its
output channels of the kernel predictor's kernel and bias convs, the
channels are gathered before the per-block reshape, and the trunk (and
kernel E) runs whole on every rank.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tortoise_tpu_torch.config import VocoderConfig
from tortoise_tpu_torch.ops.basic import leaky_relu
from tortoise_tpu_torch.ops.conv import (
    conv1d,
    conv_transpose1d,
    location_variable_conv,
    reflect_pad1d,
)
from tortoise_tpu_torch.ops.cuda.lvc import lvc_gated_residual


def _mask_time(x, valid_len):
    """Zero (B, C, T) beyond valid_len (int or (B,) tensor)."""
    if valid_len is None:
        return x
    t = x.shape[-1]
    vl = torch.as_tensor(valid_len, device=x.device).reshape(-1, 1, 1)
    ok = torch.arange(t, device=x.device)[None, None, :] < vl
    return torch.where(ok, x, 0.0)


def reflect_extend(x, true_len, pad: int):
    """Write the right-edge reflection of a length-`true_len` signal into
    the `pad` slots after it. x (B, C, T); true_len int or (B,)."""
    if true_len is None:
        return x
    b, c, t = x.shape
    tl = torch.as_tensor(true_len, device=x.device).reshape(-1, 1).expand(b, 1)
    j = torch.arange(t, device=x.device)[None, :] - tl
    src = torch.clamp(tl - 2 - j, 0, t - 1)
    reflected = torch.gather(x, -1, src[:, None, :].expand(b, c, t))
    use = (j >= 0) & (j < pad)
    return torch.where(use[:, None, :], reflected, x)


def kernel_predictor(stage, mel, cfg: VocoderConfig, valid_len=None,
                     compute_dtype=None, tp=None):
    """Padded mel (B, n_mel, L) -> (kernels (B, nblk, C_in, C_out, K, L),
    biases (B, nblk, C_out, L))."""
    b, _, l = mel.shape
    nblk = len(cfg.dilations)
    c = conv1d(_mask_time(mel, valid_len), stage["kp_in_w"],
               stage["kp_in_b"], padding=2, compute_dtype=compute_dtype)
    c = leaky_relu(c, cfg.leaky_slope)
    res = stage["kp_res"]
    for r in range(res["w1"].shape[0]):
        y = conv1d(_mask_time(c, valid_len), res["w1"][r], res["b1"][r],
                   padding=1, compute_dtype=compute_dtype)
        y = leaky_relu(y, cfg.leaky_slope)
        y = conv1d(_mask_time(y, valid_len), res["w3"][r], res["b3"][r],
                   padding=1, compute_dtype=compute_dtype)
        c = c + leaky_relu(y, cfg.leaky_slope)
    c = _mask_time(c, valid_len)
    kernels = conv1d(c, stage["kp_kernel_w"], stage["kp_kernel_b"],
                     padding=1, compute_dtype=compute_dtype)
    biases = conv1d(c, stage["kp_bias_w"], stage["kp_bias_b"], padding=1,
                    compute_dtype=compute_dtype)
    if tp is not None:  # this rank's output channels -> all of them
        kernels, biases = tp.all_gather(kernels, 1), tp.all_gather(biases, 1)
    kernels = kernels.reshape(b, nblk, cfg.ch, cfg.lvc_out_ch,
                              cfg.lvc_kernel, l)
    return kernels, biases.reshape(b, nblk, cfg.lvc_out_ch, l)


def vocoder_forward(params, cfg: VocoderConfig, mel, noise, mel_len=None,
                    compute_dtype=None, tp=None):
    """mel (B, n_mel, M) denormalized + pad frames (+ zero bucket padding
    with `mel_len` the true M); noise (B, noise_ch, M). Returns audio
    (B, M * prod(strides) - 6)."""
    if mel_len is None:
        x = reflect_pad1d(noise, 3)
    else:
        # reflect at the TRUE signal edges: 3 zero slots each side, the
        # static left reflection, then the right one at the true length
        x = F.pad(_mask_time(noise, mel_len), (3, 3))
        x = torch.cat([x[:, :, [6, 5, 4]], x[:, :, 3:]], dim=-1)
        x = reflect_extend(x, torch.as_tensor(mel_len, device=x.device) + 3,
                           3)
    x = conv1d(x, params["pre_w"], params["pre_b"], padding=0,
               compute_dtype=compute_dtype)
    up = 1
    for i, stride in enumerate(cfg.strides):
        stage = params["stages"][i]
        valid = None if mel_len is None else mel_len * up
        x = _mask_time(leaky_relu(x, cfg.leaky_slope), valid)
        x = conv_transpose1d(x, stage["convt_w"], stage["convt_b"],
                             stride=stride, compute_dtype=compute_dtype)
        trim = cfg.trim_paddings[i]
        x = x[:, :, trim:x.shape[-1] - trim]
        up *= stride
        valid = None if mel_len is None else mel_len * up
        x = _mask_time(x, valid)
        kernels, biases = kernel_predictor(stage, mel, cfg, mel_len,
                                           compute_dtype, tp)
        hop = cfg.hop_sizes[i]
        for c, dil in enumerate(cfg.dilations):
            y = _mask_time(leaky_relu(x, cfg.leaky_slope), valid)
            y = conv1d(y, stage["cb_w"][c], stage["cb_b"][c], padding=dil,
                       dilation=dil, compute_dtype=compute_dtype)
            y = _mask_time(leaky_relu(y, cfg.leaky_slope), valid)
            if cfg.use_pallas_lvc:
                # kernel E: LVC, gate and residual in one pass, in f32
                # whatever compute_dtype is (like the JAX fused route)
                x = lvc_gated_residual(y.float(), kernels[:, c].float(),
                                       biases[:, c].float(), x.float(), hop)
            else:
                y = location_variable_conv(y, kernels[:, c], biases[:, c],
                                           hop, compute_dtype)
                x = x + torch.sigmoid(y[:, :cfg.ch]) * torch.tanh(
                    y[:, cfg.ch:])
            x = _mask_time(x, valid)
    x = leaky_relu(x, cfg.leaky_slope)
    x = _mask_time(x, None if mel_len is None else mel_len * up)
    audio = conv1d(x, params["post_w"], params["post_b"], padding=0,
                   compute_dtype=compute_dtype)
    return audio[:, 0, :]
