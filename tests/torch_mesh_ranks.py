"""Rank-side bodies of the port's mesh tests (``test_torch_parallel.py``,
``test_torch_serve_mesh.py``; ``card_dp_tp`` of ``test_torch_device.py``
on a card). Each runs in a spawned gloo rank
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


# card_dp_tp's tp part: its tolerance against one rank's outputs
# (relative), and the depth its batch is cut to (widths stay full: every
# tp collective is staged through the host under gloo)
CARD_TP_TOL = 2e-2
CARD_TP_STEPS = 48
CARD_TP_DIFFUSION = 20


def card_dp_tp(rank, world, rows, voices):
    """Two ranks on cuda:0 over gloo (NCCL refuses two ranks on one
    device), full width, bf16 + int8. (a) dp (2, 1): synthesize_batch on
    ``rows``. (b) tp (1, 2): one prefill + decode_step and one denoiser
    eval against this rank's own single-rank outputs of the same inputs,
    then a 2-row synthesize_batch cut to CARD_TP_STEPS decode and
    CARD_TP_DIFFUSION denoising steps. Returns each part's tokens, audio
    and launch counts, and (b)'s relative differences."""
    from tortoise_tpu_torch.models import ar
    from tortoise_tpu_torch.models import diffusion as dm
    from tortoise_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from tortoise_tpu_torch.parallel import ar_param_specs, make_mesh, \
        shard_tree
    from tortoise_tpu_torch.parallel.mesh import axis_group
    from tortoise_tpu_torch.pipeline import ar_stage
    from tortoise_tpu_torch.pipeline import diffusion_stage as dst
    from tortoise_tpu_torch.pipeline.synthesize import (
        TortoiseModels,
        synthesize_batch,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    models = TortoiseModels.random(0, diffusion={"use_flash": True})
    bf16 = torch.bfloat16
    kw = dict(seed=0, compute_dtype=bf16, int8_weights=True, device="cuda",
              materialize=False)

    def batch(m, rows, voices, mesh):
        reset_launch_counts()
        res = synthesize_batch(m, tokens_list=rows, voices=voices, mesh=mesh,
                               **kw)
        torch.cuda.synchronize()
        return dict(sequences=[r.sequences for r in res],
                    audio=[np.asarray(r.audio) for r in res],
                    launches=launch_counts())

    out = {"a": batch(models, rows, voices,
                      make_mesh(2, shape=(2, 1), backend="gloo"))}
    mesh = make_mesh(2, shape=(1, 2), backend="gloo")
    tp = axis_group(mesh, "tp")
    cfg = dataclasses.replace(ar_stage.size_cache(models.ar_cfg, 32),
                              fused_decode=False)
    full = ar_stage.cast_matmul_weights(models.ar_params, bf16, True, "cuda")
    local = shard_tree(dict(full, head_pack=None), ar_param_specs(mesh),
                       mesh)
    ids = torch.zeros((2, 32), dtype=torch.long, device="cuda")
    valid = torch.zeros((2, 32), dtype=torch.bool, device="cuda")
    for i, row in enumerate(rows[:2]):
        ids[i, :len(row)] = torch.as_tensor(row)
        valid[i, :len(row)] = True
    voice = torch.as_tensor(voices[:2], device="cuda")
    tok = torch.full((2,), 7, device="cuda")

    def rel(got, want):
        got, want = got.float(), want.float()
        if not bool(torch.isfinite(got).all()):
            return float("inf")
        return float((got - want).abs().max() / want.abs().max())

    l1, c1 = ar.prefill(full, cfg, ids, valid, voice, bf16)
    l2, c2 = ar.prefill(local, cfg, ids, valid, voice, bf16, tp=tp)
    d1, _ = ar.decode_step(full, cfg, c1, tok, 0, bf16)
    d2, _ = ar.decode_step(local, cfg, c2, tok, 0, bf16, tp=tp)
    dcfg = models.diffusion_cfg
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((2, dcfg.n_mel, 256), generator=g, device="cuda")
    code = 0.5 * torch.randn((2, dcfg.d_model, 256), generator=g,
                             device="cuda")
    e1 = dm.denoise(dst._prepare_params(models.diffusion_params, True,
                                        "cuda"), dcfg, x, code, 100, None,
                    None, bf16)
    e2 = dm.denoise(dst._prepare_params(models.diffusion_params, True,
                                        "cuda", mesh), dcfg, x, code, 100,
                    None, None, bf16, tp)
    out["b_rel"] = dict(prefill=rel(l2, l1), decode_step=rel(d2, d1),
                        denoise=rel(e2, e1))
    cut = dataclasses.replace(
        models, ar_cfg=dataclasses.replace(
            models.ar_cfg, max_decode_steps=CARD_TP_STEPS),
        diffusion_cfg=dataclasses.replace(
            dcfg, n_sample_timesteps=CARD_TP_DIFFUSION))
    out["b"] = batch(cut, rows[:2], voices[:2], mesh)
    out["b"]["lengths"] = [card_audio_length(cut, s[0])
                           for s in out["b"]["sequences"]]
    return out


def card_audio_length(models, sequence):
    """The audio samples the one-shot path gives for ``sequence``."""
    from tortoise_tpu_torch.pipeline.ar_stage import trim_keep_lengths
    from tortoise_tpu_torch.pipeline.diffusion_stage import (
        mel_length_for_latents,
    )
    from tortoise_tpu_torch.pipeline.vocoder_stage import audio_length

    keep = trim_keep_lengths([sequence], models.ar_cfg)[0]
    return audio_length(mel_length_for_latents(keep), models.vocoder_cfg)
