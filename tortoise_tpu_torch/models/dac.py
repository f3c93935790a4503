"""The decoder of the DAC 44.1 kHz codec (descriptinc/descript-audio-codec
``dac/model/dac.py``, arXiv:2306.06546), Dia's vocoder: codes -> audio.

- codes: ``n_codebooks`` codebooks of ``codebook_size`` x
  ``codebook_dim``; each code's vector through its codebook's 1x1 conv
  to ``latent`` channels, summed over the codebooks;
- a conv k 7 to ``dim`` channels;
- one block a rate s of ``rates`` (the channels halve each block): Snake,
  a transposed conv of kernel 2 s, stride s, padding ceil(s / 2), then
  residual units at dilations 1, 3 and 9 (Snake, conv k 7, Snake,
  conv k 1, added to the unit's input);
- Snake, a conv k 7 to one channel, tanh.

Snake(x) = x + sin(alpha x)^2 / (alpha + 1e-9), alpha one a channel.
Weight norm is folded into the weights. Channel-major (B, C, T) maps, in
f32 (upstream runs the codec in f32).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F

DILATIONS = (1, 3, 9)


@dataclasses.dataclass(frozen=True)
class DacConfig:
    """The 44 kHz model: 9 codebooks of 1024 x 8, latent 1024, decoder
    width 1536, rates 8-8-4-2 (512 samples a frame)."""
    n_codebooks: int = 9
    codebook_size: int = 1024
    codebook_dim: int = 8
    latent: int = 1024
    dim: int = 1536
    rates: Tuple[int, ...] = (8, 8, 4, 2)
    sample_rate: int = 44100

    @property
    def hop(self) -> int:
        return math.prod(self.rates)


def tiny_dac_config() -> DacConfig:
    """The CPU tests' size: 3 codebooks of 36 x 4, latent 16, width 32,
    two blocks at rates 4 and 2 (a hop of 8)."""
    return DacConfig(n_codebooks=3, codebook_size=36, codebook_dim=4,
                     latent=16, dim=32, rates=(4, 2))


def param_shapes(cfg: DacConfig) -> dict:
    """The weight tree's shapes (torch layouts: (out, in, k) convs, (in,
    out, k) transposed convs). Names starting with ``alpha`` are Snake's
    (centred at 1), ``codebook`` the code vectors."""
    n, lat = cfg.n_codebooks, cfg.latent
    tree = {"codebook": (n, cfg.codebook_size, cfg.codebook_dim),
            "proj_w": (n, lat, cfg.codebook_dim), "proj_b": (n, lat),
            "conv1_w": (cfg.dim, lat, 7), "conv1_b": (cfg.dim,)}
    c = cfg.dim
    for i, s in enumerate(cfg.rates):
        o = c // 2
        block = {"alpha": (c,), "convt_w": (c, o, 2 * s), "convt_b": (o,)}
        for j in range(len(DILATIONS)):
            block[f"res{j}"] = {"alpha1": (o,), "conv1_w": (o, o, 7),
                                "conv1_b": (o,), "alpha2": (o,),
                                "conv2_w": (o, o, 1), "conv2_b": (o,)}
        tree[f"block{i}"] = block
        c = o
    tree.update(alpha=(c,), conv2_w=(1, c, 7), conv2_b=(1,))
    return tree


def snake(x, alpha):
    """Snake over (B, C, T) with (C,) alpha."""
    a = alpha[:, None]
    return x + (a + 1e-9).reciprocal() * torch.sin(a * x).pow(2)


def embed(p, cfg: DacConfig, codes):
    """(B, n_codebooks, T) codes -> (B, latent, T): each codebook's
    vectors through its 1x1 conv, summed."""
    z = 0.0
    for i in range(cfg.n_codebooks):
        e = p["codebook"][i][codes[:, i]].transpose(1, 2)
        z = z + F.conv1d(e, p["proj_w"][i][..., None], p["proj_b"][i])
    return z


def forward(p, cfg: DacConfig, codes):
    """(B, n_codebooks, T) codes in [0, codebook_size) -> (B, T * hop)
    f32 audio."""
    x = F.conv1d(embed(p, cfg, codes), p["conv1_w"], p["conv1_b"],
                 padding=3)
    for i, s in enumerate(cfg.rates):
        b = p[f"block{i}"]
        x = F.conv_transpose1d(snake(x, b["alpha"]), b["convt_w"],
                               b["convt_b"], stride=s,
                               padding=math.ceil(s / 2))
        for j, d in enumerate(DILATIONS):
            r = b[f"res{j}"]
            y = F.conv1d(snake(x, r["alpha1"]), r["conv1_w"], r["conv1_b"],
                         dilation=d, padding=3 * d)
            x = x + F.conv1d(snake(y, r["alpha2"]), r["conv2_w"],
                             r["conv2_b"])
    x = F.conv1d(snake(x, p["alpha"]), p["conv2_w"], p["conv2_b"], padding=3)
    return torch.tanh(x)[:, 0]
