"""The Vocos vocoder (charactr/vocos-mel-24khz, arXiv:2306.00814): a
ConvNeXt backbone over the log-mel and an iSTFT head, F5-TTS's vocoder.

Conv1d (k 7) and LN, ``layers`` ConvNeXt blocks (depthwise conv k 7, LN,
Linear, exact GELU, Linear, layer scale, residual), a final LN and a
Linear to n_fft + 2 channels: a log-magnitude (exp, clipped at 100) and
a phase per bin; then the inverse STFT with "same" padding (irfft, Hann
window, overlap-add at ``hop``, trimmed by (n_fft - hop) / 2 on each
side, divided by the window envelope). Time-major inside, f32 (the
configuration's plane: F5-TTS runs Vocos in f32).
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from tortoise_tpu_torch.ops.basic import pdot


@dataclasses.dataclass(frozen=True)
class VocosConfig:
    n_mel: int = 100
    dim: int = 512
    intermediate_dim: int = 1536
    layers: int = 8
    n_fft: int = 1024
    hop: int = 256
    sample_rate: int = 24000
    ln_eps: float = 1e-6


def tiny_vocos_config() -> VocosConfig:
    """The CPU tests' size: 2 blocks, n_fft 64, hop 16."""
    return VocosConfig(dim=32, intermediate_dim=64, layers=2, n_fft=64,
                       hop=16)


def param_shapes(cfg: VocosConfig) -> dict:
    """The weight tree's shapes (torch layouts, blocks stacked)."""
    d, di, n = cfg.dim, cfg.intermediate_dim, cfg.layers
    return {
        "embed_w": (d, cfg.n_mel, 7), "embed_b": (d,),
        "norm_w": (d,), "norm_b": (d,),
        "blocks": {"dw_w": (n, d, 7), "dw_b": (n, d),
                   "ln_w": (n, d), "ln_b": (n, d),
                   "pw1_w": (n, di, d), "pw1_b": (n, di),
                   "pw2_w": (n, d, di), "pw2_b": (n, d),
                   "gamma": (n, d)},
        "final_w": (d,), "final_b": (d,),
        "out_w": (cfg.n_fft + 2, d), "out_b": (cfg.n_fft + 2,),
    }


def _conv(x, w, b, groups=1):
    """Conv1d over (B, T, C), "same" zero padding."""
    return F.conv1d(x.transpose(1, 2), w, b, padding=w.shape[-1] // 2,
                    groups=groups).transpose(1, 2)


def _ln(x, w, b, eps):
    return F.layer_norm(x, x.shape[-1:], w, b, eps)


def backbone(p, cfg: VocosConfig, mel):
    """(B, n_mel, n) log-mel -> (B, n, n_fft + 2) head outputs."""
    x = _ln(_conv(mel.float().transpose(1, 2), p["embed_w"], p["embed_b"]),
            p["norm_w"], p["norm_b"], cfg.ln_eps)
    pb = p["blocks"]
    for l in range(cfg.layers):
        y = _conv(x, pb["dw_w"][l][:, None], pb["dw_b"][l], groups=cfg.dim)
        y = _ln(y, pb["ln_w"][l], pb["ln_b"][l], cfg.ln_eps)
        y = F.gelu(pdot(y, pb["pw1_w"][l].T) + pb["pw1_b"][l])
        x = x + pb["gamma"][l] * (pdot(y, pb["pw2_w"][l].T) + pb["pw2_b"][l])
    x = _ln(x, p["final_w"], p["final_b"], cfg.ln_eps)
    return pdot(x, p["out_w"].T) + p["out_b"]


@functools.cache
def _window(n_fft: int, device) -> torch.Tensor:
    return torch.hann_window(n_fft, device=device)


def istft(mag, phase, cfg: VocosConfig):
    """(B, n, n_fft / 2 + 1) magnitude and phase -> (B, n * hop) audio,
    "same" padding."""
    b, n, _ = mag.shape
    win = _window(cfg.n_fft, mag.device)
    spec = torch.complex(mag * torch.cos(phase), mag * torch.sin(phase))
    frames = torch.fft.irfft(spec, cfg.n_fft, dim=-1) * win
    size = (n - 1) * cfg.hop + cfg.n_fft
    pad = (cfg.n_fft - cfg.hop) // 2

    def overlap_add(cols):  # (B, n_fft, n) -> (B, size)
        return F.fold(cols, (1, size), (1, cfg.n_fft),
                      stride=(1, cfg.hop))[:, 0, 0]

    y = overlap_add(frames.transpose(1, 2))
    env = overlap_add(win.square()[None, :, None].expand(1, -1, n))
    return (y / env)[:, pad:size - pad]


def forward(p, cfg: VocosConfig, mel):
    """(B, n_mel, n) log-mel -> (B, n * hop) audio."""
    h = backbone(p, cfg, mel)
    half = cfg.n_fft // 2 + 1
    mag = torch.exp(h[..., :half]).clip(max=1e2)
    return istft(mag, h[..., half:], cfg)
