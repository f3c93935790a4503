"""Rank-side bodies of the port's mesh tests (``test_torch_parallel.py``,
``test_torch_serve_mesh.py``). Each runs in a spawned gloo rank
(``tortoise_tpu_torch.parallel.launch.run_ranks``), imports torch, numpy
and the port only, and returns numpy results that the pytest process
holds against the JAX package. The JAX key chains arrive as recorded
GLOBAL arrays (``streams``: {stage seed: [draws in order]}) and are
replayed through the port's draw seams, so under dp each rank's slicing
of the global draw is what is tested."""

from __future__ import annotations

import dataclasses
import inspect
import sys
import time
import warnings

import numpy as np
import torch

JAXY = ("jax", "jaxlib", "tortoise_tpu")


def jaxy_modules():
    return sorted(k for k in sys.modules if k.split(".")[0] in JAXY)


class Replay:
    """A recorded stream standing where a stage keeps its generator."""

    def __init__(self, arrays):
        self.arrays, self.i = arrays, 0

    def next(self, shape):
        a = self.arrays[self.i]
        if a.shape != tuple(shape):
            raise AssertionError(f"draw {self.i}: recorded {a.shape}, "
                                 f"drawn {tuple(shape)}")
        self.i += 1
        return a


def replay_streams(streams):
    """Route the draws of every stage whose seed is in ``streams`` through
    the recorded arrays; other seeds keep their torch.Generator."""
    from tortoise_tpu_torch.pipeline import ar_stage, common
    from tortoise_tpu_torch.pipeline import diffusion_stage as dst
    from tortoise_tpu_torch.pipeline import vocoder_stage as vst

    make = common.make_generator

    def make_generator(seed, device):
        if int(seed) in streams:
            return Replay(streams[int(seed)])
        return make(seed, device)

    def seam(orig):
        def draw(gen, shape, device):
            if isinstance(gen, Replay):
                return torch.as_tensor(gen.next(shape), device=device)
            return orig(gen, shape, device)
        return draw

    common.make_generator = make_generator
    ar_stage.draw_uniform = seam(ar_stage.draw_uniform)
    dst.draw_normal = seam(dst.draw_normal)
    vst.draw_normal = seam(vst.draw_normal)


def _np(x):
    return x.detach().float().cpu().numpy()


def _spy_dp_plane():
    """Record the AR sampling loop's planes: for each call of
    ``ar_stage._generate``, whether dp split its rows, and the kernel-A
    steps (``ar.decode_sample_step`` calls) it made."""
    from tortoise_tpu_torch.models import ar
    from tortoise_tpu_torch.pipeline import ar_stage

    calls = []
    gen, step = ar_stage._generate, ar.decode_sample_step
    sig = inspect.signature(gen)

    def spy_gen(*a, **k):
        calls.append([sig.bind(*a, **k).arguments.get("dp") is not None, 0])
        return gen(*a, **k)

    def spy_step(*a, **k):
        calls[-1][1] += 1
        return step(*a, **k)

    ar_stage._generate, ar.decode_sample_step = spy_gen, spy_step
    return calls


def mesh_22(rank, world, inp):
    """Every (2, 2) case: make_mesh, the tp-sharded AR prefill + decode,
    the dp plane's gate under tp, the tp denoiser / conditioner /
    diffusion_batch, the tp vocoder, synthesize_batch."""
    from tortoise_tpu_torch.config import (
        tiny_ar_config,
        tiny_diffusion_config,
        tiny_vocoder_config,
    )
    from tortoise_tpu_torch.models import ar
    from tortoise_tpu_torch.models import diffusion as dm
    from tortoise_tpu_torch.models import vocoder as vm
    from tortoise_tpu_torch.parallel import (
        ar_param_specs,
        diffusion_param_specs,
        gather_batch,
        make_mesh,
        place_batch,
        shard_tree,
        vocoder_param_specs,
    )
    from tortoise_tpu_torch.parallel.mesh import axis_group
    from tortoise_tpu_torch.params import tree_to_torch
    from tortoise_tpu_torch.pipeline import ar_stage
    from tortoise_tpu_torch.pipeline import diffusion_stage as dst
    from tortoise_tpu_torch.pipeline.synthesize import (
        TortoiseModels,
        synthesize_batch,
    )

    replay_streams(inp["streams"])
    out = {}
    mesh = make_mesh(device_type="cpu")
    out["mesh_default"] = tuple(mesh.mesh.shape)
    out["mesh_names"] = mesh.mesh_dim_names
    for shape in ((4, 1), (1, 4)):
        out[f"mesh_{shape}"] = tuple(make_mesh(4, shape=shape,
                                               device_type="cpu").mesh.shape)
    for kw, key in ((dict(n_devices=64), "need_64"),
                    (dict(backend="nccl"), "backend")):
        try:
            make_mesh(device_type="cpu", **kw)
        except ValueError as e:
            out[key] = str(e)
    tp = axis_group(mesh, "tp")

    # the tp-sharded AR prefill + one decode step (f32), dp over the rows
    cfg = tiny_ar_config()
    params = tree_to_torch(inp["ar_params"])
    sp = shard_tree(params, ar_param_specs(mesh), mesh)
    out["ar_attn_w_local"] = tuple(sp["blocks"]["attn_w"].shape)
    ids, valid = place_batch(inp["text_ids"], mesh), \
        place_batch(np.ones(inp["text_ids"].shape, bool), mesh)
    voice = torch.as_tensor(inp["voice"])
    logits, cache = ar.prefill(sp, cfg, ids, valid, voice, tp=tp)
    out["prefill"] = _np(gather_batch(logits, mesh))
    tok = place_batch(np.full((inp["text_ids"].shape[0],), 7), mesh)
    logits, _ = ar.decode_step(sp, cfg, cache, tok, 0, tp=tp)
    out["decode"] = _np(gather_batch(logits, mesh))

    # tp = 2: the dp plane (kernel A per rank) must not engage
    fcfg = dataclasses.replace(tiny_ar_config(), fused_decode=True)
    calls = _spy_dp_plane()
    _, padded = ar_stage.autoregressive_batch(
        inp["fused_params"], inp["gate_tokens"], inp["gate_voices"], fcfg,
        seed=1, compute_dtype=torch.bfloat16, int8_weights=True, mesh=mesh,
        device="cpu")
    out["gate_tp_calls"], out["gate_tp_rows"] = list(calls), len(padded)

    # tp denoiser, latent conditioner, and the whole stage (f32)
    dcfg = tiny_diffusion_config()
    dp_ = shard_tree(tree_to_torch(inp["diff_params"]),
                     diffusion_param_specs(mesh), mesh)
    out["qkv_local"] = tuple(dp_["layers"]["attn_qkv_w"].shape)
    out["res_in_local"] = tuple(dp_["layers"]["res_in_conv_w"].shape)
    buckets = torch.as_tensor(inp["buckets"])
    eps = dm.denoise(dp_, dcfg, place_batch(inp["x"], mesh),
                     place_batch(inp["code"], mesh), 100, buckets, tp=tp)
    out["denoise"] = _np(gather_batch(eps, mesh))
    lat = dm.latent_conditioner(dp_, dcfg, place_batch(inp["lat"], mesh),
                                torch.as_tensor(inp["lat_buckets"]), tp=tp)
    out["conditioner"] = _np(gather_batch(lat, mesh))
    out["diffusion_batch"] = dst.diffusion_batch(
        inp["diff_params"], inp["lats"], dcfg, seed=5, device="cpu",
        mesh=mesh)

    # the tp vocoder: kernel-predictor channels split, then gathered
    vcfg = tiny_vocoder_config()
    vp = shard_tree(tree_to_torch(inp["voc_params"]),
                    vocoder_param_specs(mesh, len(vcfg.strides)), mesh)
    out["kp_local"] = tuple(vp["stages"][0]["kp_kernel_w"].shape)
    audio = vm.vocoder_forward(vp, vcfg, place_batch(inp["mel"], mesh),
                               place_batch(inp["noise"], mesh), tp=tp)
    out["vocoder"] = _np(gather_batch(audio, mesh))

    # the public batch API on the mesh
    models = TortoiseModels.random(seed=0, tiny=True)
    res = synthesize_batch(models, tokens_list=inp["syn_tokens"],
                           voices=inp["syn_voices"], seed=7, device="cpu",
                           mesh=mesh)
    out["syn_sequences"] = [r.sequences for r in res]
    out["syn_audio"] = [r.audio for r in res]
    out["jaxy"] = jaxy_modules()
    return out


def mesh_41(rank, world, inp):
    """Every (4, 1) case: the dp plane of the AR stage, its gate on a
    batch dp cannot split, the dp diffusion stage, place_batch and
    gather_batch."""
    from tortoise_tpu_torch.config import tiny_ar_config, \
        tiny_diffusion_config
    from tortoise_tpu_torch.parallel import gather_batch, make_mesh, \
        place_batch
    from tortoise_tpu_torch.pipeline import ar_stage
    from tortoise_tpu_torch.pipeline import diffusion_stage as dst

    replay_streams(inp["streams"])
    out = {}
    mesh = make_mesh(4, shape=(4, 1), device_type="cpu")
    fcfg = dataclasses.replace(tiny_ar_config(), fused_decode=True)
    calls = _spy_dp_plane()
    lat, seqs = ar_stage.autoregressive_batch(
        inp["fused_params"], inp["dp_tokens"], inp["dp_voices"], fcfg,
        seed=11, compute_dtype=torch.bfloat16, int8_weights=True,
        mesh=mesh, device="cpu")
    out["dp_calls"], out["dp_sequences"] = list(calls), seqs
    out["dp_latents"] = lat
    del calls[:]
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        _, seqs3 = ar_stage.autoregressive_batch(
            inp["fused_params"], inp["dp_tokens"][:3], inp["dp_voices"][:3],
            fcfg, seed=12, compute_dtype=torch.bfloat16, int8_weights=True,
            mesh=mesh, device="cpu")
    out["gate_3_calls"], out["gate_3_sequences"] = list(calls), seqs3
    out["gate_3_warned"] = any("REPLICATED" in str(w.message) for w in seen)
    out["diffusion_dp"] = dst.diffusion_batch(
        inp["diff_params"], inp["dp_lats"], tiny_diffusion_config(), seed=5,
        device="cpu", mesh=mesh)

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        whole = place_batch(np.arange(18, dtype=np.float32).reshape(6, 3),
                            mesh)
    out["place_6"] = (tuple(whole.shape),
                      [str(w.message) for w in seen])
    out["gather_6"] = _np(gather_batch(whole, mesh, n_rows=6))
    arr = np.arange(24, dtype=np.float32).reshape(8, 3)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        local = place_batch(arr, mesh)
    out["place_8"] = (_np(local), [str(w.message) for w in seen])
    out["gather_8"] = _np(gather_batch(local, mesh))
    out["gather_8_rows"] = _np(gather_batch(local, mesh, n_rows=8))
    out["place_none"] = place_batch(arr, None) is arr
    out["jaxy"] = jaxy_modules()
    return out


def serve_22(rank, world, inp):
    """A SynthesisServer on rank 0 of a (2, 2) mesh and followers on the
    other ranks: 4 requests in one batch, one stream on rank 0, then the
    same 4 rows through synthesize_batch on the mesh."""
    from tortoise_tpu_torch import serve
    from tortoise_tpu_torch.parallel import make_mesh
    from tortoise_tpu_torch.pipeline.synthesize import (
        TortoiseModels,
        synthesize_batch,
    )

    mesh = make_mesh(device_type="cpu")
    models = TortoiseModels.random(seed=0, tiny=True)
    voice, rows = inp["voice"], inp["tokens"]
    out = {}
    if rank == 0:
        server = serve.SynthesisServer(models, max_batch=4,
                                       max_wait_ms=3000,
                                       default_voice=voice, device="cpu",
                                       mesh=mesh)
        with server:
            futs = [server.submit(tokens=t, seed=3) for t in rows]
            results = [f.result(timeout=100) for f in futs]
            chunks = list(server.stream(tokens=rows[0], seed=3,
                                        window_frames=24, overlap_frames=8,
                                        first_window_frames=16,
                                        vocoder_margin=8))
        out["stats"] = server.stats()
        out["server_audio"] = [r.audio for r in results]
        out["server_sequences"] = [r.sequences for r in results]
        out["stream_chunks"] = len(chunks)
        out["stream_samples"] = sum(len(c.audio) for c in chunks)
        try:
            server.start()
        except RuntimeError as e:
            out["restart"] = str(e)
    else:
        try:
            serve.SynthesisServer(models, default_voice=voice, device="cpu",
                                  mesh=mesh)
        except ValueError as e:
            out["not_rank0"] = str(e)
        t0 = time.monotonic()
        out["joined"] = serve.serve_follower(models, mesh, device="cpu")
        out["follow_s"] = time.monotonic() - t0
    res = synthesize_batch(models, tokens_list=rows, voices=[voice] * 4,
                           seed=3, device="cpu", mesh=mesh,
                           materialize=False)
    out["batch_audio"] = [r.audio for r in res]
    out["batch_sequences"] = [r.sequences for r in res]
    out["jaxy"] = jaxy_modules()
    return out


def fail_on_rank_1(rank, world):
    """A rank that fails: run_ranks must fail the run with its log."""
    if rank == 1:
        raise RuntimeError("rank 1 fails here")
    import torch.distributed as dist

    dist.barrier()  # rank 0 waits on the rank that died
