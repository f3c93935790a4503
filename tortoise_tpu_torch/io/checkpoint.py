"""GGML checkpoint -> JAX pytree conversion (+ synthetic random params).

The reference's three weight files hold named f32 tensors (loader shape
declarations at main.cpp:482-897, 931-1634, 1665-2021). Our reader
(io/ggml.py) delivers numpy arrays with ggml's ne reversed, which lands on
the original torch orientations:

- GPT-2 Conv1D-style weights (attn.c_attn/c_proj, mlp.c_fc/c_proj) arrive
  (in, out) and are used as ``x @ W`` (the reference transposes them into
  ggml's contraction layout at main.cpp:2769-2777 — numerically identical).
- torch Linear weights (lm_head.1) arrive (out, in), used as ``x @ W.T``.

Per-layer tensors are stacked along a leading layer axis so the trunk runs
as one `lax.scan` (30 launches -> 1 compiled loop body).

Converted checkpoints can be cached as .npz for fast reload.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from tortoise_tpu_torch.config import ARConfig

_AR_PREFIX = "inference_model.transformer.h."

_BLOCK_FIELDS = {
    "ln1_w": ("ln_1.weight", None),
    "ln1_b": ("ln_1.bias", None),
    "attn_w": ("attn.c_attn.weight", None),
    "attn_b": ("attn.c_attn.bias", None),
    "proj_w": ("attn.c_proj.weight", None),
    "proj_b": ("attn.c_proj.bias", None),
    "ln2_w": ("ln_2.weight", None),
    "ln2_b": ("ln_2.bias", None),
    "fc_w": ("mlp.c_fc.weight", None),
    "fc_b": ("mlp.c_fc.bias", None),
    "fc_proj_w": ("mlp.c_proj.weight", None),
    "fc_proj_b": ("mlp.c_proj.bias", None),
}


def ar_params_from_tensors(tensors: Dict[str, np.ndarray],
                           cfg: ARConfig = ARConfig()) -> dict:
    """Build the AR param pytree from a GGML tensor dict
    (tensor names established at main.cpp:736-800)."""
    blocks = {}
    for field, (suffix, _) in _BLOCK_FIELDS.items():
        blocks[field] = np.stack(
            [tensors[f"{_AR_PREFIX}{i}.{suffix}"] for i in range(cfg.n_layer)]
        )
    return {
        "text_emb": np.asarray(tensors["text_embedding.weight"]),
        "text_pos": np.asarray(tensors["text_pos_embedding.emb.weight"]),
        "mel_emb": np.asarray(tensors["mel_embedding.weight"]),
        "mel_pos": np.asarray(tensors["mel_pos_embedding.emb.weight"]),
        "blocks": blocks,
        "ln_f_w": np.asarray(tensors["inference_model.transformer.ln_f.weight"]),
        "ln_f_b": np.asarray(tensors["inference_model.transformer.ln_f.bias"]),
        "lm_ln_w": np.asarray(tensors["inference_model.lm_head.0.weight"]),
        "lm_ln_b": np.asarray(tensors["inference_model.lm_head.0.bias"]),
        "lm_w": np.asarray(tensors["inference_model.lm_head.1.weight"]),
        "lm_b": np.asarray(tensors["inference_model.lm_head.1.bias"]),
    }


def ar_tensor_inventory(cfg: ARConfig = ARConfig()) -> Dict[str, tuple]:
    """The full {ggml_name: numpy_shape} inventory of ggml-model.bin
    (shape declarations at main.cpp:683-800)."""
    d, mlp = cfg.d_model, cfg.d_mlp
    inv = {
        "text_embedding.weight": (cfg.n_text_vocab, d),
        "text_pos_embedding.emb.weight": (cfg.n_text_pos, d),
        "mel_embedding.weight": (cfg.n_mel_vocab, d),
        "mel_pos_embedding.emb.weight": (cfg.n_mel_pos, d),
        "inference_model.transformer.ln_f.weight": (d,),
        "inference_model.transformer.ln_f.bias": (d,),
        "inference_model.lm_head.0.weight": (d,),
        "inference_model.lm_head.0.bias": (d,),
        "inference_model.lm_head.1.weight": (cfg.n_mel_vocab, d),
        "inference_model.lm_head.1.bias": (cfg.n_mel_vocab,),
    }
    shapes = {
        "ln_1.weight": (d,), "ln_1.bias": (d,),
        "attn.c_attn.weight": (d, 3 * d), "attn.c_attn.bias": (3 * d,),
        "attn.c_proj.weight": (d, d), "attn.c_proj.bias": (d,),
        "ln_2.weight": (d,), "ln_2.bias": (d,),
        "mlp.c_fc.weight": (d, mlp), "mlp.c_fc.bias": (mlp,),
        "mlp.c_proj.weight": (mlp, d), "mlp.c_proj.bias": (d,),
    }
    for i in range(cfg.n_layer):
        for suffix, shape in shapes.items():
            inv[f"{_AR_PREFIX}{i}.{suffix}"] = shape
    return inv


def random_ggml_tensors(inventory: Dict[str, tuple], seed: int = 0,
                        scale: float = 0.02,
                        fast: bool = False) -> Dict[str, np.ndarray]:
    """Synthetic checkpoint with the production tensor inventory — used for
    tests and benchmarking because the published weights are not
    redistributable with this repo. Norm weights are centered at 1.

    fast=True draws float32 directly (~2x the f64-then-cast throughput on
    ~600M bench-scale params) at the cost of a DIFFERENT stream; the
    committed pseudo-golden fixtures pin the default f64 stream, so they
    must keep fast=False."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in inventory.items():
        if fast:
            arr = rng.standard_normal(size=shape, dtype=np.float32)
            arr *= np.float32(scale)
        else:
            arr = rng.normal(0.0, scale, size=shape).astype(np.float32)
        base = name.rsplit(".", 1)[0]
        norm_like = ("ln_1", "ln_2", "ln_f", "lm_head.0", "norm",
                     "in_layers.0", "out_layers.0", "out.0")
        if base.endswith(norm_like) and name.endswith(".weight"):
            arr += 1.0
        out[name] = arr
    return out


def random_ar_params(cfg: ARConfig, seed: int = 0,
                     fast: bool = False) -> dict:
    return ar_params_from_tensors(
        random_ggml_tensors(ar_tensor_inventory(cfg), seed, fast=fast), cfg
    )


def save_npz(path: str, params: dict) -> None:
    flat = {}

    def rec(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(f"{prefix}{k}/", v)
        elif isinstance(node, (list, tuple)):
            for k, v in enumerate(node):
                rec(f"{prefix}#{k}/", v)  # '#' marks list indices
        else:
            flat[prefix[:-1]] = np.asarray(node)

    rec("", params)
    # atomic publish (tmp + rename, like io/plane_cache.py): an
    # interrupted multi-second savez of a ~GB tree must not leave a
    # truncated zip at the final path — _cache_fresh would accept it by
    # mtime and every later run would die in load_npz
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + f".tmp.{os.getpid()}"
    try:
        np.savez(tmp, **flat)
        # np.savez appends .npz when the target lacks the suffix
        produced = tmp if os.path.exists(tmp) else tmp + ".npz"
        os.replace(produced, path)
    except BaseException:
        for cand in (tmp, tmp + ".npz"):
            if os.path.exists(cand):
                os.unlink(cand)
        raise


def load_npz(path: str) -> dict:
    """Inverse of save_npz. NOTE: sequence nodes come back as LISTS
    (this codec does not record list-vs-tuple, unlike io/plane_cache's
    manifest codec) — consumers that branch on `isinstance(w, tuple)`
    for quantized pairs must normalize, as quantize_ar_host /
    quantize_diffusion_weights already do."""
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]

    def delistify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("#") for k in node):
            return [delistify(node[f"#{i}"]) for i in range(len(node))]
        return {k: delistify(v) for k, v in node.items()}

    return delistify(out)


def _cache_fresh(cache_path: str, source_path: str) -> bool:
    """A converted-npz cache is valid only if it is newer than its GGML
    source — replacing the weight file with the same cache_path used to
    silently serve the OLD converted tree."""
    try:
        return os.path.getmtime(cache_path) >= os.path.getmtime(source_path)
    except OSError:
        return os.path.exists(cache_path)


def convert_ar_checkpoint(ggml_path: str, cache_path: str | None = None,
                          cfg: ARConfig = ARConfig()) -> dict:
    """Load ggml-model.bin -> pytree, optionally caching as npz."""
    if cache_path and os.path.exists(cache_path) \
            and _cache_fresh(cache_path, ggml_path):
        return load_npz(cache_path)
    from tortoise_tpu_torch.io.ggml import read_ggml

    params = ar_params_from_tensors(read_ggml(ggml_path), cfg)
    if cache_path:
        save_npz(cache_path, params)
    return params


# ---------------------------------------------------------------------------
# diffusion model (ggml-diffusion-model.bin, loader at main.cpp:931-1634)
# ---------------------------------------------------------------------------

from tortoise_tpu_torch.config import DiffusionConfig  # noqa: E402


def _diffusion_layer_fields(d: int, h: int = 16, nb: int = 32):
    """{pytree_field: (name_suffix, numpy_shape)} for one resblock+attn
    diffusion layer (struct diffusion_layer, main.cpp:212-248)."""
    return {
        "res_in_norm_w": ("resblk.in_layers.0.weight", (d,)),
        "res_in_norm_b": ("resblk.in_layers.0.bias", (d,)),
        "res_in_conv_w": ("resblk.in_layers.2.weight", (d, d)),
        "res_in_conv_b": ("resblk.in_layers.2.bias", (d,)),
        "res_emb_w": ("resblk.emb_layers.1.weight", (2 * d, d)),
        "res_emb_b": ("resblk.emb_layers.1.bias", (2 * d,)),
        "res_out_norm_w": ("resblk.out_layers.0.weight", (d,)),
        "res_out_norm_b": ("resblk.out_layers.0.bias", (d,)),
        "res_out_conv_w": ("resblk.out_layers.3.weight", (d, d, 3)),
        "res_out_conv_b": ("resblk.out_layers.3.bias", (d,)),
        "attn_norm_w": ("attn.norm.weight", (d,)),
        "attn_norm_b": ("attn.norm.bias", (d,)),
        "attn_qkv_w": ("attn.qkv.weight", (3 * d, d)),
        "attn_qkv_b": ("attn.qkv.bias", (3 * d,)),
        "attn_proj_w": ("attn.proj_out.weight", (d, d)),
        "attn_proj_b": ("attn.proj_out.bias", (d,)),
        "attn_rel_w": (
            "attn.relative_pos_embeddings.relative_attention_bias.weight",
            (nb, h),
        ),
    }


def _resblock_fields(d: int):
    """Plain residual block (layers.10-12, main.cpp:190-210)."""
    return {
        "res_in_norm_w": ("in_layers.0.weight", (d,)),
        "res_in_norm_b": ("in_layers.0.bias", (d,)),
        "res_in_conv_w": ("in_layers.2.weight", (d, d)),
        "res_in_conv_b": ("in_layers.2.bias", (d,)),
        "res_emb_w": ("emb_layers.1.weight", (2 * d, d)),
        "res_emb_b": ("emb_layers.1.bias", (2 * d,)),
        "res_out_norm_w": ("out_layers.0.weight", (d,)),
        "res_out_norm_b": ("out_layers.0.bias", (d,)),
        "res_out_conv_w": ("out_layers.3.weight", (d, d, 3)),
        "res_out_conv_b": ("out_layers.3.bias", (d,)),
    }


def _latent_block_fields(d: int, h: int = 16, nb: int = 32):
    return {
        "attn_norm_w": ("norm.weight", (d,)),
        "attn_norm_b": ("norm.bias", (d,)),
        "attn_qkv_w": ("qkv.weight", (3 * d, d)),
        "attn_qkv_b": ("qkv.bias", (3 * d,)),
        "attn_proj_w": ("proj_out.weight", (d, d)),
        "attn_proj_b": ("proj_out.bias", (d,)),
        "attn_rel_w": (
            "relative_pos_embeddings.relative_attention_bias.weight",
            (nb, h),
        ),
    }


def diffusion_tensor_inventory(cfg: DiffusionConfig = DiffusionConfig()):
    d = cfg.d_model
    inv = {
        "diffusion_conditioning_latent": (1, 2 * d),
        "latent_conditioner.0.weight": (d, d, 3),
        "latent_conditioner.0.bias": (d,),
        "code_norm.weight": (d,),
        "code_norm.bias": (d,),
        "time_embed.0.weight": (d, d),
        "time_embed.0.bias": (d,),
        "time_embed.2.weight": (d, d),
        "time_embed.2.bias": (d,),
        "inp_block.weight": (d, cfg.n_mel, 3),
        "inp_block.bias": (d,),
        "integrating_conv.weight": (d, 2 * d),
        "integrating_conv.bias": (d,),
        "out.0.weight": (d,),
        "out.0.bias": (d,),
        "out.2.weight": (2 * cfg.n_mel, d, 3),
        "out.2.bias": (2 * cfg.n_mel,),
        "unconditioned_embedding": (d,),
    }
    for i in range(1, cfg.n_latent_cond_blocks + 1):
        for field, (suffix, shape) in _latent_block_fields(
                d, cfg.n_head, cfg.rel_pos_buckets).items():
            inv[f"latent_conditioner.{i}.{suffix}"] = shape
    for i in range(cfg.n_integrator_layers):
        for field, (suffix, shape) in _diffusion_layer_fields(
                d, cfg.n_head, cfg.rel_pos_buckets).items():
            inv[f"conditioning_timestep_integrator.{i}.{suffix}"] = shape
    for i in range(cfg.n_main_layers):
        for field, (suffix, shape) in _diffusion_layer_fields(
                d, cfg.n_head, cfg.rel_pos_buckets).items():
            inv[f"layers.{i}.{suffix}"] = shape
    for i in range(cfg.n_main_layers,
                   cfg.n_main_layers + cfg.n_tail_resblocks):
        for field, (suffix, shape) in _resblock_fields(d).items():
            inv[f"layers.{i}.{suffix}"] = shape
    return inv


def _stack_fields(tensors, fields, prefix_fmt, indices):
    out = {}
    for field, (suffix, _) in fields.items():
        out[field] = np.stack(
            [tensors[prefix_fmt.format(i) + suffix] for i in indices]
        )
    return out


def diffusion_params_from_tensors(tensors,
                                  cfg: DiffusionConfig = DiffusionConfig()):
    d = cfg.d_model
    cond = np.asarray(tensors["diffusion_conditioning_latent"]).reshape(2 * d)
    return {
        "cond_scale": cond[:d],
        "cond_shift": cond[d:],
        "latent_conv_w": np.asarray(tensors["latent_conditioner.0.weight"]),
        "latent_conv_b": np.asarray(tensors["latent_conditioner.0.bias"]),
        "latent_blocks": _stack_fields(
            tensors, _latent_block_fields(d, cfg.n_head, cfg.rel_pos_buckets),
            "latent_conditioner.{}.",
            range(1, cfg.n_latent_cond_blocks + 1)),
        "code_norm_w": np.asarray(tensors["code_norm.weight"]),
        "code_norm_b": np.asarray(tensors["code_norm.bias"]),
        "time_w0": np.asarray(tensors["time_embed.0.weight"]),
        "time_b0": np.asarray(tensors["time_embed.0.bias"]),
        "time_w1": np.asarray(tensors["time_embed.2.weight"]),
        "time_b1": np.asarray(tensors["time_embed.2.bias"]),
        "integrator": _stack_fields(
            tensors, _diffusion_layer_fields(d, cfg.n_head,
                                             cfg.rel_pos_buckets),
            "conditioning_timestep_integrator.{}.",
            range(cfg.n_integrator_layers)),
        "inp_w": np.asarray(tensors["inp_block.weight"]),
        "inp_b": np.asarray(tensors["inp_block.bias"]),
        "integrating_w": np.asarray(tensors["integrating_conv.weight"]),
        "integrating_b": np.asarray(tensors["integrating_conv.bias"]),
        "layers": _stack_fields(
            tensors, _diffusion_layer_fields(d, cfg.n_head,
                                             cfg.rel_pos_buckets),
            "layers.{}.", range(cfg.n_main_layers)),
        "tail": _stack_fields(
            tensors, _resblock_fields(d), "layers.{}.",
            range(cfg.n_main_layers,
                  cfg.n_main_layers + cfg.n_tail_resblocks)),
        "out_norm_w": np.asarray(tensors["out.0.weight"]),
        "out_norm_b": np.asarray(tensors["out.0.bias"]),
        "out_w": np.asarray(tensors["out.2.weight"]),
        "out_b": np.asarray(tensors["out.2.bias"]),
        "uncond": np.asarray(tensors["unconditioned_embedding"]),
    }


def random_diffusion_params(cfg: DiffusionConfig, seed: int = 0,
                            fast: bool = False):
    return diffusion_params_from_tensors(
        random_ggml_tensors(diffusion_tensor_inventory(cfg), seed,
                            fast=fast), cfg
    )


def convert_diffusion_checkpoint(ggml_path: str, cache_path=None,
                                 cfg: DiffusionConfig = DiffusionConfig()):
    if cache_path and os.path.exists(cache_path) \
            and _cache_fresh(cache_path, ggml_path):
        return load_npz(cache_path)
    from tortoise_tpu_torch.io.ggml import read_ggml

    params = diffusion_params_from_tensors(read_ggml(ggml_path), cfg)
    if cache_path:
        save_npz(cache_path, params)
    return params


# ---------------------------------------------------------------------------
# vocoder model (ggml-vocoder-model.bin, loader at main.cpp:1665-2021)
# ---------------------------------------------------------------------------

from tortoise_tpu_torch.config import VocoderConfig  # noqa: E402


def vocoder_tensor_inventory(cfg: VocoderConfig = VocoderConfig()):
    ch, noise, mel = cfg.ch, cfg.noise_ch, cfg.n_mel
    kp, out2 = cfg.kpnet_ch, cfg.lvc_out_ch
    inv = {
        "conv_pre.weight": (ch, noise, 7),
        "conv_pre.bias": (ch,),
        "conv_post.1.weight": (1, ch, 7),
        "conv_post.1.bias": (1,),
    }
    for i, stride in enumerate(cfg.strides):
        p = f"res_stack.{i}."
        inv[p + "kernel_predictor.input_conv.0.weight"] = (kp, mel, 5)
        inv[p + "kernel_predictor.input_conv.0.bias"] = (kp,)
        for c in range(3):
            rp = p + f"kernel_predictor.residual_convs.{c}."
            inv[rp + "1.weight"] = (kp, kp, 3)
            inv[rp + "1.bias"] = (kp,)
            inv[rp + "3.weight"] = (kp, kp, 3)
            inv[rp + "3.bias"] = (kp,)
        inv[p + "kernel_predictor.kernel_conv.weight"] = (
            cfg.kpnet_kernel_ch, kp, 3)
        inv[p + "kernel_predictor.kernel_conv.bias"] = (cfg.kpnet_kernel_ch,)
        inv[p + "kernel_predictor.bias_conv.weight"] = (cfg.kpnet_bias_ch,
                                                        kp, 3)
        inv[p + "kernel_predictor.bias_conv.bias"] = (cfg.kpnet_bias_ch,)
        inv[p + "convt_pre.1.weight"] = (ch, ch, 2 * stride)
        inv[p + "convt_pre.1.bias"] = (ch,)
        for c in range(len(cfg.dilations)):
            inv[p + f"conv_blocks.{c}.1.weight"] = (ch, ch, 3)
            inv[p + f"conv_blocks.{c}.1.bias"] = (ch,)
    return inv


def vocoder_params_from_tensors(tensors,
                                cfg: VocoderConfig = VocoderConfig()):
    """conv_post.1.weight is stored 2-D (7, 32) in ggml ne (main.cpp:1786)
    == numpy (32, 7); reshape to (1, 32, 7)."""
    post_w = np.asarray(tensors["conv_post.1.weight"]).reshape(1, cfg.ch, 7)
    stages = []
    for i in range(len(cfg.strides)):
        p = f"res_stack.{i}."
        stages.append({
            "kp_in_w": np.asarray(
                tensors[p + "kernel_predictor.input_conv.0.weight"]),
            "kp_in_b": np.asarray(
                tensors[p + "kernel_predictor.input_conv.0.bias"]),
            "kp_res": {
                "w1": np.stack([np.asarray(
                    tensors[p + f"kernel_predictor.residual_convs.{c}.1.weight"])
                    for c in range(3)]),
                "b1": np.stack([np.asarray(
                    tensors[p + f"kernel_predictor.residual_convs.{c}.1.bias"])
                    for c in range(3)]),
                "w3": np.stack([np.asarray(
                    tensors[p + f"kernel_predictor.residual_convs.{c}.3.weight"])
                    for c in range(3)]),
                "b3": np.stack([np.asarray(
                    tensors[p + f"kernel_predictor.residual_convs.{c}.3.bias"])
                    for c in range(3)]),
            },
            "kp_kernel_w": np.asarray(
                tensors[p + "kernel_predictor.kernel_conv.weight"]),
            "kp_kernel_b": np.asarray(
                tensors[p + "kernel_predictor.kernel_conv.bias"]),
            "kp_bias_w": np.asarray(
                tensors[p + "kernel_predictor.bias_conv.weight"]),
            "kp_bias_b": np.asarray(
                tensors[p + "kernel_predictor.bias_conv.bias"]),
            "convt_w": np.asarray(tensors[p + "convt_pre.1.weight"]),
            "convt_b": np.asarray(tensors[p + "convt_pre.1.bias"]),
            "cb_w": np.stack([np.asarray(
                tensors[p + f"conv_blocks.{c}.1.weight"])
                for c in range(len(cfg.dilations))]),
            "cb_b": np.stack([np.asarray(
                tensors[p + f"conv_blocks.{c}.1.bias"])
                for c in range(len(cfg.dilations))]),
        })
    return {
        "pre_w": np.asarray(tensors["conv_pre.weight"]),
        "pre_b": np.asarray(tensors["conv_pre.bias"]),
        "stages": stages,
        "post_w": post_w,
        "post_b": np.asarray(tensors["conv_post.1.bias"]),
    }


def random_vocoder_params(cfg: VocoderConfig, seed: int = 0,
                          fast: bool = False):
    tensors = random_ggml_tensors(vocoder_tensor_inventory(cfg), seed,
                                  scale=0.05, fast=fast)
    # store conv_post 2-D like the real file
    tensors["conv_post.1.weight"] = tensors["conv_post.1.weight"].reshape(
        cfg.ch, 7)
    return vocoder_params_from_tensors(tensors, cfg)


def convert_vocoder_checkpoint(ggml_path: str, cache_path=None,
                               cfg: VocoderConfig = VocoderConfig()):
    if cache_path and os.path.exists(cache_path) \
            and _cache_fresh(cache_path, ggml_path):
        return load_npz(cache_path)
    from tortoise_tpu_torch.io.ggml import read_ggml

    params = vocoder_params_from_tensors(read_ggml(ggml_path), cfg)
    if cache_path:
        save_npz(cache_path, params)
    return params
