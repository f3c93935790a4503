"""Conditioned DDPM mel decoder (counterpart of
``tortoise_tpu/models/diffusion.py``).

Same structure, weights and layouts as the JAX package: latent
conditioner (conv k3 + 4 rel-pos attention blocks) -> code_norm + FiLM by
the stored conditioning latent -> nearest upscale; timestep MLP; 3
integrator layers; inp conv -> concat -> integrating conv -> 10 main
(resblock + attention) layers -> 3 tail resblocks -> out norm + SiLU +
conv -> [100 means | 100 variance fracs]. The fused qkv channels are
per-head interleaved, c = h*3D + part*D + d.

Internals are time-major (B, T, C); ``denoise`` and ``code_embeddings``
keep the (B, C, T) views at their boundary. With ``cfg.use_flash`` every
attention goes through a kernel of ``ops.cuda.flash_attention`` — kernel
B when the packed route takes the head layout (``use_packed``), else
kernel D1 (the JAX package's fallback ``flash_attention`` route): on a
CUDA tensor the hand-written kernel, on the CPU its plain version.
Every group norm, with what follows it up to the next product (affine,
FiLM, SiLU, the zeroing of padded frames), is one call of
``ops.cuda.group_norm.group_norm_act`` (kernel G on a card, its plain
twin on the CPU): 46 a denoiser eval, 5 a conditioner pass.

Tensor parallelism (``tp``, an ``AxisGroup`` on the mesh's "tp" axis,
with the tree from ``parallel.shard_tree``): each rank holds n_head/tp
heads of every attention (kernel B or D1 runs on them, with their slice
of the rel-pos table) and C/tp hidden channels of every resblock (its
n_groups/tp groups normalize locally, its channels of the FiLM scale and
shift apply); attn_proj and res_out_conv are row-parallel products,
all-reduced in f32 before their bias. On the int8 plane those products
quantize their activations on the whole row's absmax (a MAX over tp) and
all-reduce their exact integer sums before the scales apply, so they
equal the single rank's products bit for bit.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tortoise_tpu_torch.config import DiffusionConfig
from tortoise_tpu_torch.ops.basic import pdot, silu
from tortoise_tpu_torch.ops.conv import conv1d_nwc
from tortoise_tpu_torch.ops.cuda import int8_product as i8
from tortoise_tpu_torch.ops.cuda.flash_attention import (
    flash_attention,
    flash_attention_packed,
)
from tortoise_tpu_torch.ops.cuda.group_norm import group_norm_act
from tortoise_tpu_torch.ops.relpos import relpos_bias
from tortoise_tpu_torch.parallel.mesh import local_count

NEG_INF = -1e30


def _linear(x, w, b, compute_dtype=None, out_dtype=None):
    if isinstance(w, tuple):
        # pre-transposed int8 pair: dynamic per-row activation quantization
        return i8.int8_product(x, w, b, out_dtype)
    if out_dtype is not None and compute_dtype is not None:
        return pdot(x, w.T, compute_dtype, out_dtype) + b.to(out_dtype)
    return pdot(x, w.T, compute_dtype) + b


def _row_linear(x, w, b, compute_dtype, out_dtype, tp):
    """``_linear`` for a row-parallel weight: under tp this rank's partial
    product in f32, all-reduced, then cast and biased as ``_linear``
    does."""
    if tp is None:
        return _linear(x, w, b, compute_dtype, out_dtype)
    if isinstance(w, tuple):
        return i8.int8_product(x, w, b, out_dtype, row_max=_row_max(tp),
                               reduce=tp.all_reduce)
    out = tp.all_reduce(pdot(x, w.T, compute_dtype, torch.float32))
    if out_dtype is not None:
        return out.to(out_dtype) + b.to(out_dtype)
    return out + b


def _row_max(tp):
    return lambda absmax: tp.all_reduce(absmax, op=dist.ReduceOp.MAX)


def use_packed(cfg: DiffusionConfig) -> bool:
    """True when the attention runs kernel B (flash on, even heads, and
    6*d_head a multiple of 128, as in the JAX package)."""
    return cfg.use_flash and cfg.n_head % 2 == 0 \
        and (6 * cfg.d_head) % 128 == 0


def _layer(stack, l: int) -> dict:
    return {k: (v[0][l], v[1][l]) if isinstance(v, tuple) else v[l]
            for k, v in stack.items()}


def _attention(block, x, buckets, cfg: DiffusionConfig, mask=None,
               compute_dtype=None, tp=None):
    """Rel-pos attention block over (B, T, C); mask (B, T) bool or None;
    buckets (T, T) ids (used by the plain path only)."""
    b, t, c = x.shape
    h, dh = local_count(cfg.n_head, tp, "heads"), cfg.d_head
    y = group_norm_act(x, cfg.n_groups, block["attn_norm_w"],
                       block["attn_norm_b"], cfg.gn_eps, mask)
    qkv = _linear(y, block["attn_qkv_w"], block["attn_qkv_b"],
                  compute_dtype, out_dtype=compute_dtype)  # (B, T, 3C)
    if use_packed(cfg):
        kv_valid = None if mask is None else mask.expand(b, t)
        merged = flash_attention_packed(
            qkv.to(compute_dtype or x.dtype), h, kv_valid,
            bias_table=block["attn_rel_w"],
            bias_max_distance=cfg.rel_pos_max_distance)
    elif cfg.use_flash:
        # kernel D1 on strided (B, H, T, D) views of the fused qkv; on a
        # card it writes (B, T, H, D) memory, so the merge copies nothing
        kv_valid = None if mask is None else mask.expand(b, t)
        qkv5 = qkv.to(compute_dtype or x.dtype).reshape(b, t, h, 3, dh)
        q, k, v = (qkv5[:, :, :, part].transpose(1, 2) for part in range(3))
        ctx = flash_attention(q, k, v, None, kv_valid,
                              bias_table=block["attn_rel_w"],
                              bias_formula=True,
                              bias_max_distance=cfg.rel_pos_max_distance)
        merged = ctx.transpose(1, 2).reshape(b, t, h * dh)
    else:
        q, k, v = qkv.reshape(b, t, h, 3, dh).permute(3, 0, 2, 1, 4)
        scores = pdot(q, k.transpose(-1, -2), compute_dtype) / (
            float(dh) ** 0.5)
        scores = scores + relpos_bias(block["attn_rel_w"], buckets)[None]
        if mask is not None:
            scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
        probs = torch.softmax(scores.float(), dim=-1)
        ctx = pdot(probs.to(q.dtype), v, compute_dtype)
        merged = ctx.permute(0, 2, 1, 3).reshape(b, t, h * dh)
    out = _row_linear(merged, block["attn_proj_w"], block["attn_proj_b"],
                      compute_dtype, compute_dtype, tp)
    return x + out.to(x.dtype)


def _resblock(block, x, time_emb, cfg: DiffusionConfig, mask=None,
              compute_dtype=None, tp=None):
    """FiLM resblock over (B, T, C); time_emb (B, C)."""
    groups = local_count(cfg.n_groups, tp, "groups")
    y = group_norm_act(x, cfg.n_groups, block["res_in_norm_w"],
                       block["res_in_norm_b"], cfg.gn_eps, mask, silu=True)
    y = _linear(y, block["res_in_conv_w"], block["res_in_conv_b"],
                compute_dtype, out_dtype=compute_dtype)
    emb = _linear(silu(time_emb), block["res_emb_w"], block["res_emb_b"],
                  compute_dtype)
    scale, shift = torch.chunk(emb.to(y.dtype), 2, dim=-1)
    if tp is not None:  # this rank's channels of the FiLM
        lo, hi = tp.split(scale.shape[-1])
        scale, shift = scale[..., lo:hi], shift[..., lo:hi]
    # FiLM, SiLU, and padded frames zeroed after it: the FiLM shift is
    # nonzero there and would leak into the last valid frame of the k3 conv
    y = group_norm_act(y, groups, block["res_out_norm_w"],
                       block["res_out_norm_b"], cfg.gn_eps, mask,
                       film=(scale, shift), silu=True)
    if tp is None:
        y = conv1d_nwc(y, block["res_out_conv_w"], block["res_out_conv_b"],
                       padding=1, compute_dtype=compute_dtype,
                       out_dtype=compute_dtype)
    else:  # row-parallel: all-reduce, then the bias as conv1d_nwc adds it
        w = block["res_out_conv_w"]
        if isinstance(w, tuple):  # the exact integer sums are reduced
            y = conv1d_nwc(y, w, padding=1, row_max=_row_max(tp),
                           reduce=tp.all_reduce)
        else:
            y = tp.all_reduce(conv1d_nwc(y, w, padding=1,
                                         compute_dtype=compute_dtype))
        od, bias = compute_dtype, block["res_out_conv_b"]
        y = y.to(od) + bias.to(od) if od is not None else y + bias
    if mask is not None:
        y = torch.where(mask[:, :, None], y, torch.zeros((), dtype=y.dtype,
                                                         device=y.device))
    return x + y.to(x.dtype)


def latent_conditioner(params, cfg: DiffusionConfig, latents, lat_buckets,
                       lat_mask=None, compute_dtype=None, tp=None):
    """AR latents (B, L, 1024) -> conditioned code embedding (B, L, 1024)."""
    x = latents
    if lat_mask is not None:
        x = torch.where(lat_mask[:, :, None], x, 0.0)
    x = conv1d_nwc(x, params["latent_conv_w"], params["latent_conv_b"],
                   padding=1, compute_dtype=compute_dtype)
    for l in range(cfg.n_latent_cond_blocks):
        x = _attention(_layer(params["latent_blocks"], l), x, lat_buckets,
                       cfg, lat_mask, compute_dtype, tp)
    film = tuple(params[k].to(x.dtype) for k in ("cond_scale", "cond_shift"))
    return group_norm_act(x, cfg.n_groups, params["code_norm_w"],
                          params["code_norm_b"], cfg.gn_eps, lat_mask,
                          film=film)


def time_mlp(params, t_emb, compute_dtype=None):
    """Sinusoidal embedding (B, C) -> FiLM time embedding (B, C)."""
    h = silu(_linear(t_emb, params["time_w0"], params["time_b0"],
                     compute_dtype))
    return _linear(h, params["time_w1"], params["time_b1"], compute_dtype)


def _diffusion_layer(layer, x, time_emb, buckets, cfg, mask, compute_dtype,
                     tp=None):
    x = _resblock(layer, x, time_emb, cfg, mask, compute_dtype, tp)
    return _attention(layer, x, buckets, cfg, mask, compute_dtype, tp)


def integrate_code(params, cfg: DiffusionConfig, code_emb, time_emb,
                   out_buckets, mask=None, compute_dtype=None, tp=None):
    """The conditioning_timestep_integrator layers, time-major."""
    x = code_emb
    for l in range(cfg.n_integrator_layers):
        x = _diffusion_layer(_layer(params["integrator"], l), x, time_emb,
                             out_buckets, cfg, mask, compute_dtype, tp)
    return x


def trunk(params, cfg: DiffusionConfig, noisy_mel, code_emb, time_emb,
          out_buckets, mask=None, compute_dtype=None, tp=None):
    """Noisy mel (B, T, 100) + integrated code emb (B, T, 1024) ->
    (B, T, 200) [means | var fracs], time-major."""
    x = conv1d_nwc(noisy_mel, params["inp_w"], params["inp_b"], padding=1,
                   compute_dtype=compute_dtype, out_dtype=compute_dtype)
    x = torch.cat([x, code_emb.to(x.dtype)], dim=-1)
    x = _linear(x, params["integrating_w"], params["integrating_b"],
                compute_dtype, out_dtype=compute_dtype)
    for l in range(cfg.n_main_layers):
        x = _diffusion_layer(_layer(params["layers"], l), x, time_emb,
                             out_buckets, cfg, mask, compute_dtype, tp)
    for l in range(cfg.n_tail_resblocks):
        x = _resblock(_layer(params["tail"], l), x, time_emb, cfg, mask,
                      compute_dtype, tp)
    x = group_norm_act(x, cfg.n_groups, params["out_norm_w"],
                       params["out_norm_b"], cfg.gn_eps, mask, silu=True)
    x = conv1d_nwc(x, params["out_w"], params["out_b"], padding=1,
                   compute_dtype=compute_dtype)
    if mask is not None:
        x = torch.where(mask[:, :, None], x, 0.0)
    return x


def code_embeddings(params, cfg: DiffusionConfig, latents, lat_buckets,
                    out_len_pad: int, lat_len=None, out_len=None,
                    lat_mask=None, compute_dtype=None, tp=None):
    """Loop-invariant part of the denoiser: the (B, 1024, Tpad)
    conditioned and unconditioned code embeddings. lat_len/out_len are the
    true lengths (ints or (B,) tensors) for the nearest-upscale indices."""
    cond = latent_conditioner(params, cfg, latents, lat_buckets, lat_mask,
                              compute_dtype, tp)
    b, n_lat, _ = cond.shape
    dev = cond.device
    ar_t = torch.arange(out_len_pad, device=dev)
    if lat_len is None:
        idx = (ar_t * n_lat // out_len_pad).expand(b, out_len_pad)
    else:
        lat_len = torch.as_tensor(lat_len, device=dev).reshape(-1, 1)
        out_len = torch.as_tensor(out_len if out_len is not None
                                  else out_len_pad, device=dev).reshape(-1, 1)
        idx = (ar_t[None, :] * lat_len) // out_len.clamp_min(1)
        idx = torch.minimum(idx, (lat_len - 1).clamp_min(0)).clamp_min(0)
        idx = idx.expand(b, out_len_pad)
    up = torch.gather(cond, 1, idx[:, :, None].expand(b, out_len_pad,
                                                      cond.shape[-1]))
    uncond = params["uncond"].to(up.dtype).expand_as(up)
    return up.transpose(1, 2), uncond.transpose(1, 2)


def denoise(params, cfg: DiffusionConfig, x, code_emb, t_orig, out_buckets,
            mask=None, compute_dtype=None, tp=None):
    """One denoiser evaluation. x (B, 100, T) noisy mel; code_emb
    (B, 1024, T) — cond/uncond stacked as a batch of 2 for CFG; t_orig
    the ORIGINAL timestep id: a number, or a (1,) or (B,) tensor on the
    device (the denoising loop reads it from its schedule table at the
    step's device index). Returns (B, 200, T) float32."""
    from tortoise_tpu_torch.pipeline.schedule import timestep_embedding

    if mask is not None and mask.shape[0] not in (1, x.shape[0]):
        mask = mask.repeat(x.shape[0] // mask.shape[0], 1)
    t = torch.as_tensor(t_orig, device=x.device).to(torch.float32)
    t_emb = timestep_embedding(t.reshape(-1).expand(x.shape[0]),
                               cfg.timestep_dim, cfg.timestep_max_period,
                               device=x.device)
    time_emb = time_mlp(params, t_emb, compute_dtype)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        time_emb = time_emb.to(compute_dtype)
    # time-major and contiguous, as the group norms take it: one copy
    code_emb = code_emb.transpose(1, 2).to(
        compute_dtype or code_emb.dtype, copy=True,
        memory_format=torch.contiguous_format)
    code = integrate_code(params, cfg, code_emb, time_emb, out_buckets, mask,
                          compute_dtype, tp)
    out = trunk(params, cfg, x.transpose(1, 2), code, time_emb, out_buckets,
                mask, compute_dtype, tp)
    return out.transpose(1, 2).float()
