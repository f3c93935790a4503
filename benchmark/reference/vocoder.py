"""The vocoder stage: Tortoise's UnivNet generator with location-variable
convolutions, one request at a time at its own length.

The [-1, 1] mel is mapped to the Tacotron range and 10 frames of
-11.5129 are appended. Noise (64 channels, one frame a mel frame) ->
reflect pad 3 -> k7 conv -> 3 stages (leaky ReLU -> transposed conv of
stride s, kernel 2s, trimmed; a kernel predictor on the mel gives each of
4 conv blocks its per-frame kernels and biases; a block: leaky ReLU ->
dilated k3 conv -> leaky ReLU -> LVC of hop 8, 64, 256 -> sigmoid x tanh
gate -> residual) -> leaky ReLU -> k7 conv with no padding. Audio:
(frames + 10) * 256 - 6 samples. ``operands`` rounds both operands of
every product (convolutions and the LVC) as ``precision.round_operand``
does; the biases, gates and residuals stay float32. Rounded operands are
exact in TF32, so cuDNN may run the convolutions on TF32 tensor cores
(``check.Reference.audio``): the sums stay float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.precision import round_operand

MEL_MAX = 2.3143386840820312
MEL_MIN = -11.512925148010254
MEL_PAD_VALUE = -11.5129


def padded_mel(mel: torch.Tensor, cfg: dict) -> torch.Tensor:
    """(100, M) normalized mel -> (100, M + pad) Tacotron-range mel."""
    den = (mel.float() + 1.0) / 2.0 * (MEL_MAX - MEL_MIN) + MEL_MIN
    pad = torch.full((mel.shape[0], cfg["mel_pad_frames"]), MEL_PAD_VALUE,
                     device=mel.device)
    return torch.cat([den, pad], dim=1)


def _conv(x, w, b, kind, **kw):
    """A convolution of rounded operands; its bias added after."""
    return F.conv1d(round_operand(x, kind), round_operand(w, kind),
                    **kw) + b[:, None]


def _kernel_predictor(st, mel, cfg, kind):
    slope = cfg["leaky_slope"]
    c = F.leaky_relu(_conv(mel, st["kp_in_w"], st["kp_in_b"], kind,
                           padding=2), slope)
    res = st["kp_res"]
    for r in range(res["w1"].shape[0]):
        y = F.leaky_relu(_conv(c, res["w1"][r], res["b1"][r], kind,
                               padding=1), slope)
        y = _conv(y, res["w3"][r], res["b3"][r], kind, padding=1)
        c = c + F.leaky_relu(y, slope)
    k = _conv(c, st["kp_kernel_w"], st["kp_kernel_b"], kind, padding=1)
    b = _conv(c, st["kp_bias_w"], st["kp_bias_b"], kind, padding=1)
    n_blk, l = len(cfg["dilations"]), mel.shape[-1]
    k = k.reshape(1, n_blk, cfg["ch"], cfg["lvc_out_ch"], cfg["lvc_kernel"],
                  l)
    return k, b.reshape(1, n_blk, cfg["lvc_out_ch"], l)


def _lvc(x, kernel, bias, hop, kind):
    """x (1, C_in, L * hop); kernel (1, C_in, C_out, K, L); bias (1,
    C_out, L): out[o, l * hop + s] = sum_{k, i} xpad[i, l * hop + s + k]
    kernel[i, o, k, l] + bias[o, l], summed as one product a frame over
    (tap, channel) pairs, tap-major."""
    _, c_in, t = x.shape
    _, _, c_out, k, l = kernel.shape
    xp = F.pad(round_operand(x, kind), ((k - 1) // 2, (k - 1) // 2))
    win = torch.cat([xp[0, :, j:j + t] for j in range(k)], dim=0)
    win = win.t().reshape(l, hop, k * c_in)            # (l, s, k * i)
    kern = round_operand(kernel[0], kind).permute(3, 2, 0, 1).reshape(
        l, k * c_in, c_out)                            # (l, k * i, o)
    out = torch.matmul(win, kern) + bias[0].t()[:, None, :]
    return out.permute(2, 0, 1).reshape(1, c_out, l * hop)


def forward(p, cfg: dict, mel: torch.Tensor, noise: torch.Tensor,
            operands=None) -> torch.Tensor:
    """(100, M + pad) Tacotron-range mel, (64, M + pad) noise -> audio;
    ``operands``: the rounding of every product's operands (module
    docstring)."""
    slope, kind = cfg["leaky_slope"], operands
    mel = mel[None].float()
    x = F.pad(noise[None].float(), (3, 3), mode="reflect")
    x = _conv(x, p["pre_w"], p["pre_b"], kind)
    for i, stride in enumerate(cfg["strides"]):
        st = p["stages"][i]
        x = F.conv_transpose1d(round_operand(F.leaky_relu(x, slope), kind),
                               round_operand(st["convt_w"], kind),
                               stride=stride) + st["convt_b"][:, None]
        trim = cfg["trim_paddings"][i]
        x = x[:, :, trim:x.shape[-1] - trim]
        kernels, biases = _kernel_predictor(st, mel, cfg, kind)
        for c, dil in enumerate(cfg["dilations"]):
            y = F.leaky_relu(x, slope)
            y = _conv(y, st["cb_w"][c], st["cb_b"][c], kind, padding=dil,
                      dilation=dil)
            y = _lvc(F.leaky_relu(y, slope), kernels[:, c], biases[:, c],
                     cfg["hop_sizes"][i], kind)
            x = x + torch.sigmoid(y[:, :cfg["ch"]]) * torch.tanh(
                y[:, cfg["ch"]:])
    x = _conv(F.leaky_relu(x, slope), p["post_w"], p["post_b"], kind)
    return x[0, 0]
