"""Hand-written Hopper kernels (``csrc/*.cu``) with their plain PyTorch
twins and launch counters. Importing this package builds nothing: the
library is compiled on the first CUDA call (see ``build``)."""


def _wrappers():
    from tortoise_tpu_torch.ops.cuda import flash_attention as fa
    from tortoise_tpu_torch.ops.cuda import flash_attention_int8 as fi
    from tortoise_tpu_torch.ops.cuda import int8_product as ip
    from tortoise_tpu_torch.ops.cuda.conv_pos import conv_pos_embed
    from tortoise_tpu_torch.ops.cuda.decode_trunk import fused_decode_trunk
    from tortoise_tpu_torch.ops.cuda.group_norm import group_norm_act
    from tortoise_tpu_torch.ops.cuda.lvc import lvc_gated_residual

    return {"decode_trunk": fused_decode_trunk,
            "flash_attention_packed": fa.flash_attention_packed,
            "flash_attention_causal_qkv": fa.flash_attention_causal_qkv,
            "flash_attention_grouped": fa._grouped_flash,
            "flash_attention_generic": fa._generic_flash,
            "flash_attention_f32": fa._launch_d,
            "lvc_gated_residual": lvc_gated_residual,
            "group_norm_act": group_norm_act,
            "flash_packed_i8": fi.flash_packed_i8,
            "int8_quantize_kv": fi.quantize_kv,
            "int8_quantize_rows": ip.quantize_rows,
            "int8_epilogue": ip.epilogue,
            "conv_pos": conv_pos_embed}


def launch_counts() -> dict:
    """{kernel name: launches on a CUDA tensor since the last reset}."""
    return {k: fn.launches for k, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def add_launch_counts(counts: dict) -> None:
    """Add ``counts`` ({kernel name: n}, n may be negative) to the
    wrappers' counters: a step graph's replay launches without running
    the wrappers, so it adds the launches its capture recorded."""
    wrappers = _wrappers()
    for k, n in counts.items():
        wrappers[k].launches += n
