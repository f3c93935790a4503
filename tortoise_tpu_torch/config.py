"""Model hyper-parameter configs of the PyTorch port.

The port's own copy of ``tortoise_tpu/config.py``: the same dataclasses,
fields and defaults, so a test can build both packages' configs from one
set of fields. Values mirror the (hardcoded) shapes of the reference implementation:
AR transformer shapes from `autoregressive_model_load` (main.cpp:482-897),
diffusion net shapes from `diffusion_model_load` (main.cpp:931-1634),
vocoder shapes from `vocoder_model_load` (main.cpp:1665-2021).

Configs are plain frozen dataclasses so they hash (usable as cache keys)
and can be scaled down for tests.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ARConfig:
    """GPT-2-style autoregressive speech-token decoder (30 layers, d=1024)."""

    n_layer: int = 30
    d_model: int = 1024
    n_head: int = 16
    d_mlp: int = 4096
    n_text_vocab: int = 256          # text_embedding.weight rows (main.cpp:683)
    n_text_pos: int = 404            # text_pos_embedding rows (main.cpp:685)
    n_mel_vocab: int = 8194          # mel_embedding.weight rows (main.cpp:687)
    n_mel_pos: int = 608             # mel_pos_embedding rows (main.cpp:689)
    ln_eps: float = 1e-5             # ggml_norm eps (main.cpp:2204)
    # sampling-time structural constants (main.cpp:4510-4532, 5191)
    start_mel_token: int = 8192
    stop_mel_token: int = 8193
    calm_token: int = 83
    strip_token: int = 8139
    tail_tokens: tuple = (45, 45, 248)  # forced last-3 ids (main.cpp:4527-4529)
    pad_mel_length: int = 500        # sequences padded to 500 + [8192 .. 8193]
    max_decode_steps: int = 500
    # decode KV cache: 1 latent + n_text_pos text + 1 start-mel + 500 mel,
    # rounded up to a lane-friendly size.  (The reference's 404-slot cache,
    # main.cpp:794-797, silently overflows for long generations; we size it
    # correctly instead.)
    cache_len: int = 1024
    # fused decode trunk (kernel A, ops/cuda/decode_trunk.py): one call
    # per token for all layers. Engages only on the int8 + bfloat16
    # production plane at small batch; the f32 parity path never
    # dispatches to it.
    fused_decode: bool = True
    # causal flash attention (kernel C, ops/cuda/flash_attention.py) for
    # the full-sequence prefill/latent passes on the bf16/int8 planes:
    # the plain form materializes (B, H, S, S) f32 scores per layer
    # (~2 GB transient at B=16, S~930). The f32 parity plane always
    # keeps the plain softmax.
    flash_prefill: bool = True
    # engage the flash kernel only when the per-layer score block it
    # replaces is at least this big: B*S*S >= this. The value is the JAX
    # package's (tuned on a TPU); it has not been measured on a card.
    # Tests set 0 to force the kernel on tiny shapes.
    flash_prefill_min_score: int = 2_000_000

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_head


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    """Conditioned DDPM mel decoder (10+3 layers, d=1024, 100 mel bins)."""

    d_model: int = 1024
    n_head: int = 16
    n_mel: int = 100
    n_latent_cond_blocks: int = 4    # latent_conditioner.1-4 (main.cpp:1254)
    n_integrator_layers: int = 3     # conditioning_timestep_integrator (1296)
    n_main_layers: int = 10          # layers.0-9 (main.cpp:1383)
    n_tail_resblocks: int = 3        # layers.10-12 (main.cpp:1460)
    n_groups: int = 32               # ggml_group_norm(.., 32)
    gn_eps: float = 1e-5
    rel_pos_buckets: int = 32        # get_relative_position_buckets (4722-4749)
    rel_pos_max_distance: int = 64
    timestep_dim: int = 1024         # generate_timestep_embedding dim
    timestep_max_period: int = 10000
    n_train_timesteps: int = 4000    # get_beta_schedule(4000) (main.cpp:5656)
    n_sample_timesteps: int = 80     # respaced loop (main.cpp:5723)
    cond_free_k: float = 2.0         # base_conditioning_free_k (main.cpp:5654)
    use_flash: bool = False          # flash-attention kernels B / D
    # the JAX package's TPU kernel tuning knobs, kept so the two packages'
    # configs carry the same fields; the port's kernels do not read them
    flash_bq: int = 128              # query block (128: 2176=17x128, no pad)
    flash_hpp: int = 4               # heads/program, packed kernel (8: VMEM)
    flash_group: int = 2             # heads/program, grouped kernel
    flash_vmem_mb: int = 0           # Mosaic VMEM limit override (0 = default)
    main_unroll: int = 1             # lax.scan unroll over the 10 main layers
    # ubench-only diagnostics — NEVER set in production configs: they
    # change the computed function (skip attention / skip the whole net)
    diag_no_attn: bool = False
    diag_fake_denoise: bool = False

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_head


@dataclasses.dataclass(frozen=True)
class VocoderConfig:
    """UnivNet-style kernel-predictor / LVC vocoder (mel -> 24 kHz audio)."""

    n_mel: int = 100
    noise_ch: int = 64               # input Gaussian noise channels
    ch: int = 32                     # hidden channel width
    strides: tuple = (8, 8, 4)       # conv-transpose strides (main.cpp:4132)
    trim_paddings: tuple = (4, 4, 2) # post-transpose trims (main.cpp:4133)
    hop_sizes: tuple = (8, 64, 256)  # LVC hops (main.cpp:4134)
    dilations: tuple = (1, 3, 9, 27) # conv_block dilations (main.cpp:4326)
    lvc_kernel: int = 3
    lvc_out_ch: int = 64             # gated 2x32
    kpnet_ch: int = 64               # kernel-predictor hidden width
    kpnet_kernel_ch: int = 24576     # 4 blocks * 32 in * 64 out * k3
    kpnet_bias_ch: int = 256         # 4 blocks * 64
    mel_pad_frames: int = 10         # appended MEL_MIN frames (main.cpp:6051)
    leaky_slope: float = 0.2
    sample_rate: int = 24000
    # fused LVC+gate+residual kernel (kernel E, ops/cuda/lvc.py), off by
    # default as in the JAX package; the batched per-chunk matmul LVC
    # runs otherwise
    use_pallas_lvc: bool = False

    @property
    def total_upsample(self) -> int:
        out = 1
        for s in self.strides:
            out *= s
        return out


# Audio / mel constants shared across stages (main.cpp:5575-5584, 5616-5617)
TACOTRON_MEL_MAX = 2.3143386840820312
TACOTRON_MEL_MIN = -11.512925148010254
MEL_PAD_VALUE = -11.5129             # literal used by the vocoder driver (6053)
OUTPUT_SAMPLE_RATE = 24000
# output_sequence_length = latent_len * 4 * 24000 / 22050 (main.cpp:5617)
MEL_LEN_NUMER = 4 * 24000
MEL_LEN_DENOM = 22050


def mel_length_for_latents(latent_len: int) -> int:
    """Diffusion output mel frame count for an AR latent count."""
    return latent_len * MEL_LEN_NUMER // MEL_LEN_DENOM


def tiny_ar_config() -> ARConfig:
    """Scaled-down AR config for unit tests."""
    return ARConfig(
        n_layer=2, d_model=64, n_head=4, d_mlp=128, n_text_vocab=32,
        n_text_pos=24, n_mel_vocab=40, n_mel_pos=64, cache_len=64,
        start_mel_token=36, stop_mel_token=37, calm_token=5, strip_token=33,
        tail_tokens=(3, 3, 8), pad_mel_length=16, max_decode_steps=16,
    )


def tiny_diffusion_config() -> DiffusionConfig:
    return DiffusionConfig(
        d_model=64, n_head=4, n_mel=8, n_latent_cond_blocks=2,
        n_integrator_layers=1, n_main_layers=2, n_tail_resblocks=1,
        n_groups=4, timestep_dim=64,
    )


def tiny_vocoder_config() -> VocoderConfig:
    return VocoderConfig(
        n_mel=8, noise_ch=4, ch=4, strides=(2, 2), trim_paddings=(1, 1),
        hop_sizes=(2, 4), dilations=(1, 3), lvc_out_ch=8, kpnet_ch=8,
        kpnet_kernel_ch=2 * 4 * 8 * 3, kpnet_bias_ch=2 * 8, mel_pad_frames=2,
    )
