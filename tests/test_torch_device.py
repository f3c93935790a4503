"""The port's entry points run on the card unless the caller asks for the
CPU: on a machine without a card, a call that names no device raises."""

import contextlib
import dataclasses
import functools

import numpy as np
import pytest
import torch

from tortoise_tpu_torch import cli
from tortoise_tpu_torch.config import tiny_ar_config, tiny_vocoder_config
from tortoise_tpu_torch.io.checkpoint import (
    random_ar_params,
    random_vocoder_params,
)
from tortoise_tpu_torch.pipeline import ar_stage, vocoder_stage
from tortoise_tpu_torch.pipeline.common import resolve_device
from tortoise_tpu_torch.pipeline.synthesize import TortoiseModels, synthesize


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_defaults_to_the_card(no_card):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")


def test_stage_entry_points_without_a_device_raise(no_card):
    mel = np.zeros((tiny_vocoder_config().n_mel, 8), np.float32)
    vparams = random_vocoder_params(tiny_vocoder_config(), 0)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        vocoder_stage.vocoder(vparams, mel, tiny_vocoder_config())
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ar_stage.autoregressive(random_ar_params(tiny_ar_config(), 0),
                                [1, 4, 0], np.zeros(64, np.float32),
                                cfg=tiny_ar_config())
    with pytest.raises(RuntimeError, match="no CUDA card"):
        synthesize(TortoiseModels.random(0, tiny=True), tokens=[1, 4, 0],
                   voice=np.zeros(64, np.float32))
    audio = vocoder_stage.vocoder(vparams, mel, tiny_vocoder_config(),
                                  device="cpu")
    assert audio.shape == (vocoder_stage.audio_length(
        8, tiny_vocoder_config()),)


def test_cli_device_defaults_to_cuda():
    assert cli.build_parser().parse_args([]).device == "cuda"


# ---- the paths on the card at full width (cuda-marked; skip here) ----
#
# Each test runs one path of the port with the launch counters set to 0
# just before it and holds which hand-written kernels it launched, and
# which it must not; every path runs the denoiser, so every one launches
# kernel G, and no path launches kernel F (its path is its own A/B).

# stand-in wrapped text ids (255 ... 0), a 30-id prompt: text bucket 32,
# so the latent pass runs S = 1 + 32 + 502 = 535 positions
STANDIN_TOKENS = [255] + [(7 * i + 3) % 200 + 20 for i in range(28)] + [0]
# kernel name (PERF.md's kernel table) -> its launch counter
KERNELS = {"A": "decode_trunk", "B": "flash_attention_packed",
           "C": "flash_attention_causal_qkv",
           "D1": "flash_attention_grouped", "E": "lvc_gated_residual",
           "Bf": "flash_attention_f32", "G": "group_norm_act",
           "Q8": "int8_quantize_rows", "E8": "int8_epilogue"}
# the diffusion fallback (32 heads of 32: 6 * 32 % 128 != 0, so every
# attention runs kernel D1) and the fused LVC (kernel E on all 12 conv
# blocks); widths and T stay full
FALLBACK = dict(diffusion={"n_head": 32, "use_flash": True},
                vocoder={"use_pallas_lvc": True})
# kernels B's and G's launches in one B = 1 request: the conditioner's 4
# attention blocks and 5 group norms once, then 13 attention layers and
# 46 group norms in each of 80 denoising steps
REQUEST_B_LAUNCHES = 4 + 13 * 80
REQUEST_G_LAUNCHES = 5 + 46 * 80


def assert_launched(counts, need, never=()):
    """``counts`` (launch_counts()) shows every kernel of ``need`` at
    least once, none of ``never`` and no kernel F."""
    for k in need:
        assert counts[KERNELS[k]] >= 1, (k, counts)
    for k in never:
        assert counts[KERNELS[k]] == 0, (k, counts)
    assert counts["flash_packed_i8"] == counts["int8_quantize_kv"] == 0, \
        counts


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def full_models(card):
    """TortoiseModels.random(0) at the published widths with the denoiser
    on its kernel (as the CLI and the server turn it on on the card)."""
    return TortoiseModels.random(0, diffusion={"use_flash": True})


def _synthesize(models, **kw):
    """One utterance at the CLI's request settings (the stand-in tokens,
    a zero voice, seed 0) on the bf16 + int8 plane, with the launch
    counts it made."""
    from tortoise_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    reset_launch_counts()
    args = dict(tokens=STANDIN_TOKENS, voice=np.zeros((1024,), np.float32),
                seed=0, compute_dtype=torch.bfloat16, int8_weights=True,
                device="cuda")
    res = synthesize(models, **dict(args, **kw))
    torch.cuda.synchronize()
    return res, launch_counts()


def _assert_audio(res):
    audio, mel = np.asarray(res.audio), np.asarray(res.mel)
    assert np.isfinite(audio).all() and np.isfinite(mel).all()
    assert mel.shape[0] == 100
    assert audio.shape == (vocoder_stage.audio_length(mel.shape[-1]),)


@pytest.fixture(scope="module")
def request_1(full_models):
    return _synthesize(full_models)


@pytest.mark.cuda
def test_int8_synthesize_on_card_launches_a_b_g_q8_e8(request_1):
    res, counts = request_1
    _assert_audio(res)
    assert_launched(counts, ("A", "B", "G", "Q8", "E8"), never=("C", "D1"))


def _cli(tmp_path, *flags, batch_size=1):
    """The CLI at full width on --random-weights (seed 0) with ``flags``;
    returns its result and the launch counts it made."""
    from tortoise_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    reset_launch_counts()
    res = cli.run(["--random-weights", *flags, "--seed", "0", "--no-progress",
                   "--batch-size", str(batch_size), "--tokens",
                   ",".join(map(str, STANDIN_TOKENS)),
                   "--output", str(tmp_path / "out.wav")])
    torch.cuda.synchronize()
    return res, launch_counts()


@pytest.mark.cuda
def test_int8_cli_batch_of_8_on_card_launches_kernel_c(card, tmp_path):
    """At --batch-size 8 the prefill and the latent pass take kernel C."""
    res, counts = _cli(tmp_path, "--bf16", "--int8-weights", batch_size=8)
    _assert_audio(res)
    assert_launched(counts, ("A", "B", "C", "G", "Q8", "E8"))


@pytest.mark.cuda
def test_f32_cli_on_card_runs_kernel_b_on_the_split_tf32_body(
        card, full_models, tmp_path):
    """The CLI on its default plane (f32, TF32 off) launches kernel B on
    the split-TF32 body once an attention, counted by B and by the body,
    and never A; with --no-flash no attention kernel, G as often; one
    full-width f32 denoiser eval agrees with and without flash within
    1e-4 of max |out|."""
    import dataclasses

    from tortoise_tpu_torch.models import diffusion as dm
    from tortoise_tpu_torch.ops.relpos import relative_position_buckets
    from tortoise_tpu_torch.pipeline import diffusion_stage as dst

    res, counts = _cli(tmp_path)
    _assert_audio(res)
    assert counts[KERNELS["B"]] == counts[KERNELS["Bf"]] == \
        REQUEST_B_LAUNCHES, counts
    assert counts[KERNELS["G"]] == REQUEST_G_LAUNCHES, counts
    assert_launched(counts, (), never=("A", "C", "D1", "E", "Q8", "E8"))
    _, off = _cli(tmp_path, "--no-flash")
    assert off.pop(KERNELS["G"]) == REQUEST_G_LAUNCHES
    assert not any(off.values()), off
    dcfg = full_models.diffusion_cfg
    params = dst._prepare_params(full_models.diffusion_params, False, "cuda")
    g = torch.Generator(device="cuda").manual_seed(3)
    t = 2176
    x = torch.randn((2, dcfg.n_mel, t), generator=g, device="cuda")
    code = 0.5 * torch.randn((2, dcfg.d_model, t), generator=g,
                             device="cuda")
    buckets = torch.as_tensor(relative_position_buckets(
        t, dcfg.rel_pos_buckets, dcfg.rel_pos_max_distance), device="cuda")
    with torch.inference_mode():
        out = [dm.denoise(params, dataclasses.replace(dcfg, use_flash=flash),
                          x, code, 100, None if flash else buckets)
               for flash in (True, False)]
    err = float((out[0] - out[1]).abs().max())
    assert err <= 1e-4 * float(out[1].abs().max()), err


@pytest.mark.cuda
def test_fallback_synthesize_on_card_launches_d1_and_e(card):
    """The diffusion fallback (32 heads of 32) and the fused LVC: kernel
    A, D1 at every attention and E exactly 12 times (4 conv blocks x 3
    stages), never B."""
    res, counts = _synthesize(TortoiseModels.random(0, **FALLBACK))
    _assert_audio(res)
    assert_launched(counts, ("A", "D1", "E", "G"), never=("B",))
    assert counts[KERNELS["E"]] == 12, counts


# the planes the stage loops run on: (compute dtype, int8 weights)
PLANES = {"bf16 + int8": (torch.bfloat16, True),
          "bf16 weights": (torch.bfloat16, False), "f32": (None, False)}
GRAPH_DECODE_STEPS = 128  # the eager f32 decode step takes 20-30 ms


@contextlib.contextmanager
def _eager_loops():
    """The stages' sampling and denoising loops run eagerly on the card
    (their private ``eager`` argument), not as step graphs."""
    from tortoise_tpu_torch.pipeline import diffusion_stage as dst

    gen, den = ar_stage._generate, dst._denoise_loop
    ar_stage._generate = functools.partial(gen, eager=True)
    dst._denoise_loop = functools.partial(den, eager=True)
    try:
        yield
    finally:
        ar_stage._generate, dst._denoise_loop = gen, den


@pytest.mark.cuda
@pytest.mark.parametrize("plane", sorted(PLANES))
def test_step_graphs_replay_the_eager_loops_at_full_width_on_card(
        full_models, plane):
    """``synthesize()`` at the published widths (request 1's settings, the
    decode cut to GRAPH_DECODE_STEPS steps) with the sampling and
    denoising loops run eagerly, then as step graphs twice (the capture,
    then the replay of the cached graphs): equal tokens, bit-equal mel and
    audio, equal launch counts."""
    from tortoise_tpu_torch.pipeline import graphs

    cd, int8 = PLANES[plane]
    models = dataclasses.replace(full_models, ar_cfg=dataclasses.replace(
        full_models.ar_cfg, max_decode_steps=GRAPH_DECODE_STEPS))
    graphs.clear()
    runs = []
    for eager in (True, False, False):
        with _eager_loops() if eager else contextlib.nullcontext():
            res, counts = _synthesize(models, compute_dtype=cd,
                                      int8_weights=int8)
        runs.append((res.sequences, np.asarray(res.mel),
                     np.asarray(res.audio), counts))
    seq, mel, audio, counts = runs[0]
    _assert_audio(res)
    assert counts[KERNELS["G"]] >= 1, counts
    for i, (s, m, a, c) in enumerate(runs[1:], 1):
        assert s == seq, i
        assert np.array_equal(m, mel), (i, float(np.abs(m - mel).max()))
        assert np.array_equal(a, audio), (i, float(np.abs(a - audio).max()))
        assert c == counts, (i, c, counts)


WARM_START = """
import dataclasses, json, sys
import numpy as np, torch
from tortoise_tpu_torch.config import DiffusionConfig
from tortoise_tpu_torch.io.plane_cache import load_plane
from tortoise_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
from tortoise_tpu_torch.pipeline.synthesize import TortoiseModels, synthesize

plane, wav, tokens = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
tree = load_plane(plane, mmap=True)
models = TortoiseModels(
    ar_params=tree["ar"], diffusion_params=tree["diffusion"],
    vocoder_params=tree["vocoder"],
    diffusion_cfg=dataclasses.replace(DiffusionConfig(), use_flash=True))
reset_launch_counts()
res = synthesize(models, tokens=tokens, voice=np.zeros((1024,), np.float32),
                 seed=0, compute_dtype=torch.bfloat16, int8_weights=True,
                 device="cuda")
res.save(wav)
print(json.dumps({"sequences": res.sequences, "launches": launch_counts(),
                  "jaxy": sorted(k for k in sys.modules
                                 if k.split(".")[0] in ("jax", "jaxlib",
                                                        "tortoise_tpu"))}))
"""


@pytest.mark.cuda
def test_warm_start_on_card_from_a_written_int8_plane(full_models,
                                                      request_1, tmp_path):
    """The int8 plane written on the host (quantize_ar_host, the host
    diffusion quantizer, the vocoder in f32) and loaded memory-mapped by a
    fresh process that imports no JAX gives request 1's tokens and audio
    (rel 1e-3; expect bit-equal) and launches A and B there."""
    import json
    import os
    import subprocess
    import sys

    from tortoise_tpu_torch.io.plane_cache import save_plane
    from tortoise_tpu_torch.io.wav import read_wav
    from tortoise_tpu_torch.pipeline.ar_stage import quantize_ar_host
    from tortoise_tpu_torch.pipeline.diffusion_stage import (
        quantize_diffusion_weights,
    )

    plane, wav = str(tmp_path / "plane"), str(tmp_path / "warm.wav")
    save_plane({"ar": quantize_ar_host(full_models.ar_params),
                "diffusion": quantize_diffusion_weights(
                    full_models.diffusion_params),
                "vocoder": full_models.vocoder_params}, plane)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", WARM_START, plane, wav,
         json.dumps(STANDIN_TOKENS)], cwd=root, capture_output=True,
        text=True, timeout=600, env=dict(os.environ, PYTHONPATH=root))
    assert proc.returncode == 0, proc.stderr[-3000:]
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    assert child["jaxy"] == []
    assert_launched(child["launches"], ("A", "B", "G"))
    want, _ = request_1
    assert child["sequences"] == want.sequences
    audio, _ = read_wav(wav)
    want_audio = np.asarray(want.audio, np.float32)
    assert audio.shape == want_audio.shape and np.isfinite(audio).all()
    err = float(np.abs(audio - want_audio).max())
    assert err <= 1e-3 * float(np.abs(want_audio).max()), err


def _mesh_rows():
    """8 rows of stand-in text (4 lengths x 2 voices; the two rows of a
    length differ in one id)."""
    rows = [[255, 20 + i % 2] + STANDIN_TOKENS[2:n - 1] + [0]
            for i, n in enumerate((30, 30, 22, 22, 14, 14, 26, 26))]
    voices = np.stack([np.random.default_rng(10 + i % 2).normal(
        0, 0.5, (1024,)).astype(np.float32) for i in range(8)])
    return rows, voices


MESH_KW = dict(seed=0, compute_dtype=torch.bfloat16, int8_weights=True,
               device="cuda", materialize=False)


@pytest.fixture(scope="module")
def request_7(full_models):
    """One rank on NCCL (a world-size-1 group, ``make_mesh(1)``):
    synthesize_batch on the 8 mesh rows without and with the mesh; the
    launch counts of the mesh run."""
    import os
    import tempfile

    import torch.distributed as dist

    from tortoise_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from tortoise_tpu_torch.parallel import make_mesh
    from tortoise_tpu_torch.pipeline.synthesize import synthesize_batch

    rows, voices = _mesh_rows()
    plain = synthesize_batch(full_models, tokens_list=rows, voices=voices,
                             **MESH_KW)
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", rank=0, world_size=1,
                                init_method="file://" + os.path.join(d, "s"))
        try:
            reset_launch_counts()
            meshed = synthesize_batch(full_models, tokens_list=rows,
                                      voices=voices, mesh=make_mesh(1),
                                      **MESH_KW)
            torch.cuda.synchronize()
            counts = launch_counts()
        finally:
            dist.destroy_process_group()
    return plain, meshed, counts


@pytest.mark.cuda
def test_one_nccl_rank_on_card_equals_the_mesh_less_run(request_7):
    plain, meshed, counts = request_7
    assert [r.sequences for r in meshed] == [r.sequences for r in plain]
    for a, b in zip(meshed, plain):
        assert np.array_equal(a.audio, b.audio)
    assert_launched(counts, ("A", "B", "C", "G"))


def _as_dp_rank(n, sel):
    """Patches for mesh-less stage calls on rows ``sel`` of an ``n``-row
    batch, as a dp rank runs them: every draw the global batch's draw
    cut to those rows, and kernel A's work split as for the global
    batch. Returns the function that restores them."""
    from tortoise_tpu_torch.models import ar
    from tortoise_tpu_torch.pipeline import ar_stage
    from tortoise_tpu_torch.pipeline import diffusion_stage as dst
    from tortoise_tpu_torch.pipeline import vocoder_stage as vst

    seams = [(ar_stage, "draw_uniform"), (dst, "draw_normal"),
             (vst, "draw_normal")]
    saved = [getattr(m, name) for m, name in seams]
    step = ar.decode_sample_step
    ar.decode_sample_step = lambda *a, **k: step(*a, **dict(k, split_rows=n))
    for (m, name), draw in zip(seams, saved):
        setattr(m, name, lambda g, shape, dev, draw=draw:
                draw(g, (n,) + tuple(shape[1:]), dev)[sel])

    def restore():
        ar.decode_sample_step = step
        for (m, name), draw in zip(seams, saved):
            setattr(m, name, draw)
    return restore


def _sample_plain(logits, prev, u, sampler):
    """The AR stage's plain sampler, in kernel A's sample_plain form."""
    from tortoise_tpu_torch.ops import sampling as S

    probs, ids = S.process_logits_topk(logits, prev, *sampler)
    return S.sample_from_topk_u(u, probs, ids)[:, None]


def _check_dp_tokens(full_models, rows, voices, want, got):
    """A dp rank's tokens against the 8-row batch's. The first differing
    row of each rank's 4 is held at its first differing step to both
    batch shapes' logits there (teacher forced on the 8-row tokens),
    under the sampler that drew it (kernel A's after step 0 on its plane,
    else the stage's): the two shapes' logits must pick the two runs'
    tokens (the batch shape's rounding at a CDF edge is the whole
    difference), or the draw must not be firm (its token flips under
    Gaussian logit noise of twice the two shapes' RMS difference)."""
    from test_torch_cuda import firm_rows

    from tortoise_tpu_torch.models import ar
    from tortoise_tpu_torch.ops.cuda import decode_trunk
    from tortoise_tpu_torch.pipeline import ar_stage, common

    same = [g == w for g, w in zip(got, want)]
    sampler = ar_stage.normalize_sampler(None)
    cfg = ar_stage.size_cache(full_models.ar_cfg, 32)
    params = ar_stage.cast_matmul_weights(full_models.ar_params,
                                          torch.bfloat16, True, "cuda")
    drawn = [seq[0][1:] for seq in want]  # sampled id s sits at s + 1
    for r in {i // 4 * 4 + [*same[i // 4 * 4:], False].index(False)
              for i, ok in enumerate(same) if not ok}:
        w, g = want[r][0][1:], got[r][0][1:]
        s = next(i for i in range(min(len(w), len(g))) if w[i] != g[i])
        gen = common.make_generator(0, "cuda")
        for _ in range(s + 1):
            u = ar_stage.draw_uniform(gen, (8, 1), "cuda")
        logits = []
        for sel in (list(range(8)), list(range(r // 4 * 4, r // 4 * 4 + 4))):
            ids = torch.zeros((len(sel), 32), dtype=torch.long, device="cuda")
            valid = torch.zeros_like(ids, dtype=torch.bool)
            for j, i in enumerate(sel):
                ids[j, :len(rows[i])] = torch.as_tensor(rows[i])
                valid[j, :len(rows[i])] = True
            lg, cache = ar.prefill(params, cfg, ids, valid, torch.as_tensor(
                voices[sel], device="cuda"), torch.bfloat16)
            for step in range(s):
                tok = torch.as_tensor([drawn[i][step] if step < len(
                    drawn[i]) else cfg.stop_mel_token for i in sel],
                    device="cuda")
                lg, cache = ar.decode_step(params, cfg, cache, tok, step,
                                           torch.bfloat16, split_rows=8)
            logits.append(lg[sel.index(r)][None].float())
        fused = s > 0 and ar.can_fuse_sampling(params, cfg, torch.bfloat16,
                                               8, sampler)
        draw = decode_trunk.sample_plain if fused else _sample_plain
        if s == 0:
            prev = torch.ones((1, 34), dtype=torch.long, device="cuda")
            prev[:, -1] = cfg.start_mel_token
        else:
            prev = torch.tensor([[w[s - 1]]], device="cuda")
        u_r = u[r:r + 1]
        picks = [int(draw(lg, prev, u_r, sampler)[0, 0]) for lg in logits]
        rms = float((logits[0] - logits[1]).pow(2).mean().sqrt())
        firm = bool(firm_rows(logits[0], prev, u_r, sampler, 2 * rms,
                              draw)[0])
        assert picks == [w[s], g[s]] or not firm, (r, s, picks, w[s], g[s])


LOCATE_A_STEPS = 330  # past slot 320, where B = 4's second chunk begins


def _assert_split_rows_keep_the_batch_bits(full_models, rows, voices, want):
    """Kernel A at B = 4 with the 8-row batch's split (``split_rows``, as a
    dp rank runs it) gives rows 0-3 the logits they have at B = 8: decode
    steps teacher forced on the 8-row tokens from ONE cache (the 8-row
    prefill's; the 4-row copy is its first rows), LOCATE_A_STEPS steps."""
    from tortoise_tpu_torch.models import ar
    from tortoise_tpu_torch.pipeline import ar_stage

    bf16 = torch.bfloat16
    cfg = dataclasses.replace(ar_stage.size_cache(full_models.ar_cfg, 32),
                              fused_decode=True)
    params = ar_stage.cast_matmul_weights(full_models.ar_params, bf16, True,
                                          "cuda")
    ids = torch.zeros((8, 32), dtype=torch.long, device="cuda")
    valid = torch.zeros_like(ids, dtype=torch.bool)
    for i, row in enumerate(rows):
        ids[i, :len(row)] = torch.as_tensor(row)
        valid[i, :len(row)] = True
    _, c8 = ar.prefill(params, cfg, ids, valid,
                       torch.as_tensor(voices, device="cuda"), bf16)
    caches = [ar.KVCache(c8.k[:, :n].clone(), c8.v[:, :n].clone(),
                         c8.valid[:n].clone(), c8.length) for n in (8, 4)]
    drawn = [seq[0][1:] for seq in want]
    for step in range(LOCATE_A_STEPS):
        tok = torch.as_tensor([d[step] for d in drawn], device="cuda")
        lg8, caches[0] = ar.decode_step(params, cfg, caches[0], tok, step,
                                        bf16)
        lg4, caches[1] = ar.decode_step(params, cfg, caches[1], tok[:4],
                                        step, bf16, split_rows=8)
        assert torch.equal(lg8[:4], lg4), step


@pytest.mark.cuda
def test_two_gloo_ranks_on_card_dp_and_tp(full_models, request_7, tmp_path):
    """Two ranks on the one card over gloo. (a) dp (2, 1): each rank
    launches A and B and not C (4 x 535^2 is under the flash prefill
    gate), and gives bit for bit the tokens and audio of the mesh-less
    run of its 4 rows with the global draws' rows (``_as_dp_rank``); its
    tokens against the 8-row batch's are held by ``_check_dp_tokens``;
    kernel A split as for the whole batch keeps rows 0-3's bits. (b) tp
    (1, 2): a prefill, a decode step and a denoiser eval within 2e-2 of
    one rank's, a 2-row batch with finite audio of the vocoder's length
    that launches B and not A."""
    import torch_mesh_ranks as ranks

    from tortoise_tpu_torch.parallel.launch import run_ranks
    from tortoise_tpu_torch.pipeline.synthesize import synthesize_batch

    rows, voices = _mesh_rows()
    ref = []
    for r in range(2):
        sel = slice(4 * r, 4 * r + 4)
        restore = _as_dp_rank(8, sel)
        try:
            ref += synthesize_batch(full_models, tokens_list=rows[sel],
                                    voices=voices[sel], **MESH_KW)
        finally:
            restore()
    out = run_ranks(ranks.card_dp_tp, 2, (rows, voices),
                    workdir=str(tmp_path), timeout=900, backend="gloo",
                    threads=4)
    want = [r.sequences for r in request_7[0]]
    for o in out:
        a, b = o["a"], o["b"]
        assert_launched(a["launches"], ("A", "B", "G"), never=("C",))
        assert a["sequences"] == [x.sequences for x in ref]
        for got, x in zip(a["audio"], ref):
            assert np.array_equal(got, x.audio)
        _check_dp_tokens(full_models, rows, voices, want, a["sequences"])
        assert all(v <= ranks.CARD_TP_TOL for v in o["b_rel"].values()), \
            o["b_rel"]
        assert [len(x) for x in b["audio"]] == b["lengths"]
        assert all(np.isfinite(x).all() for x in b["audio"])
        assert_launched(b["launches"], ("B", "G"), never=("A",))
    _assert_split_rows_keep_the_batch_bits(full_models, rows, voices, want)


def _agree(got, want, rel=1e-3):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * max(float(np.abs(want).max()), 1e-30), err


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["default", "fallback + fused LVC"])
def test_tiny_f32_plane_on_card_agrees_with_cpu(card, label):
    """The tiny f32 parity plane on the card and on the CPU (the
    reference sampler): the same tokens, mel and audio within 1e-3 of
    max |out|; the fallback + fused-LVC configs launch D1 and E on the
    card (the tiny denoiser's 4 heads of 16 take the fallback)."""
    from tortoise_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    cfgs = {} if label == "default" else dict(
        diffusion={"use_flash": True}, vocoder={"use_pallas_lvc": True})
    models = TortoiseModels.random(3, tiny=True, **cfgs)
    voice = np.random.default_rng(0).normal(0, 0.5, 64).astype(np.float32)
    kw = dict(tokens=[3, 9, 4, 12, 7, 1, 20, 5], voice=voice, seed=5,
              sampler="reference")
    cpu = synthesize(models, device="cpu", **kw)
    reset_launch_counts()
    gpu = synthesize(models, device="cuda", **kw)
    if cfgs:
        assert_launched(launch_counts(), ("D1", "E"))
    assert gpu.sequences == cpu.sequences
    _agree(gpu.mel, cpu.mel)
    _agree(gpu.audio, cpu.audio)


@pytest.mark.cuda
def test_stage_flags_on_card_agree_with_cpu(card):
    """The two flags the JAX package's stages take, on the card against
    the CPU at tiny widths. qkv_f16: the AR stage on the f32 plane (the
    same tokens, latents within 1e-3); on kernel A's and C's plane (bf16
    + int8, fused decode, the flash prefill gate at 0, 2 heads of 64) the
    flag keeps both kernels off, and the same call without it launches
    both. bucketed=False: the diffusion stage (mt19937 noise) and the
    vocoder on a 9-latent input, a 39-frame mel that no bucket divides,
    on 2 heads of 64 (kernel B) and on the fallback + fused-LVC configs
    (D1 and E): each launches its kernels, mel and audio within 1e-3."""
    from tortoise_tpu_torch.io.checkpoint import random_ar_params
    from tortoise_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from tortoise_tpu_torch.pipeline import diffusion_stage as DS
    from tortoise_tpu_torch.rng import ReferenceRng

    voice = np.random.default_rng(0).normal(0, 0.5, 64).astype(np.float32)
    toks = [3, 9, 4, 12, 7, 1, 20, 5]
    models = TortoiseModels.random(3, tiny=True)
    runs = {dev: ar_stage.autoregressive(
        models.ar_params, toks, voice, 1, models.ar_cfg, "reference", 5,
        None, None, True, device=dev) for dev in ("cpu", "cuda")}
    assert runs["cpu"][1] == runs["cuda"][1]
    _agree(runs["cuda"][0][0], runs["cpu"][0][0])
    cfg = dataclasses.replace(models.ar_cfg, d_model=128, n_head=2,
                              d_mlp=256, fused_decode=True,
                              flash_prefill_min_score=0)
    params = random_ar_params(cfg, 3)
    voice128 = np.random.default_rng(1).normal(0, 0.5, 128).astype(
        np.float32)
    for flag in (False, True):
        reset_launch_counts()
        lat, _ = ar_stage.autoregressive(
            params, toks, voice128, 2, cfg, "reference", 5, None,
            torch.bfloat16, flag, True, device="cuda")
        assert np.isfinite(lat[0]).all()
        counts = launch_counts()
        if flag:
            assert_launched(counts, (), never=("A", "C"))
        else:
            assert_launched(counts, ("A", "C"))
    packed = dict(diffusion={"d_model": 128, "n_head": 2, "timestep_dim": 128,
                             "use_flash": True})
    fused = dict(diffusion={"use_flash": True},
                 vocoder={"use_pallas_lvc": True})
    for cfgs, need in ((packed, ("B",)), (fused, ("D1", "E"))):
        m = TortoiseModels.random(3, tiny=True, **cfgs)
        dcfg = dataclasses.replace(m.diffusion_cfg, n_sample_timesteps=8)
        lat = np.random.default_rng(4).normal(0, 0.5, (9, dcfg.d_model))
        out = {}
        for dev in ("cpu", "cuda"):
            reset_launch_counts()
            mel = DS.diffusion(m.diffusion_params, lat, dcfg, 0,
                               ReferenceRng(4), True, None, False,
                               device=dev)
            audio = vocoder_stage.vocoder(m.vocoder_params, mel,
                                          m.vocoder_cfg, 0, ReferenceRng(2),
                                          None, False, device=dev)
            out[dev] = (mel, audio, launch_counts())
        frames = out["cuda"][0].shape[1]
        assert frames % 64 and (frames + m.vocoder_cfg.mel_pad_frames) % 32
        assert_launched(out["cuda"][2], need)
        _agree(out["cuda"][0], out["cpu"][0])
        _agree(out["cuda"][1], out["cpu"][1])
