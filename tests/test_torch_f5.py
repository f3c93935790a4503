"""F5-TTS v1 Base and Vocos in the port (``models.f5``, ``models.vocos``,
``pipeline.f5_stage``, ``pipeline.vocos_stage``) against the plain
reference ``tests/reference_f5.py``, at a tiny size on the CPU (2 blocks,
dim 64, 4 heads of 16, text 32, one ConvNeXt block; Vocos with 2 blocks,
n_fft 64, hop 16), on seeded weights, in f32.

Tolerances, each for its reason:

- ``F32``: 2e-6 relative L2. Both sides are f32 on the same weights; they
  differ only in the order of sums (batched rows, fused q/k/v and AdaLN
  products, kernel B's plain twin against a softmax), each ~1e-7.
- ``PAD``: 1e-6 relative L2 between a bucket-padded and an unpadded eval
  of the port on the real frames: the padded frames are masked, so only
  the products' blocking over a longer T differs.
- ``BF16``: the bf16 plane against the bf16-rounded reference, 2e-2: the
  port keeps its activations in bf16 between the products (the reference
  rounds only the operands), ~6e-3 here; ``FP8``: the fp8 control (its
  operands in e4m3) reads ~6e-2 there, so it must exceed 2e-2.

The ``cuda`` case (a card only) runs one bucket through the step graph
and kernel B, held to the eager CPU path at 2e-2 (bf16, another order of
sums on the card).
"""

import contextlib
import dataclasses
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import reference_f5 as R
from tortoise_tpu_torch.models import f5 as FM
from tortoise_tpu_torch.models import vocos as VM
from tortoise_tpu_torch.pipeline import f5_stage as S
from tortoise_tpu_torch.pipeline import graphs
from tortoise_tpu_torch.pipeline.synthesize import synthesize
from tortoise_tpu_torch.utils import profiling

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
F32, PAD, BF16 = 2e-6, 1e-6, 2e-2
PROBES = (0, 16, 31)


def rel(got, want) -> float:
    got = torch.as_tensor(np.asarray(got)).double()
    want = torch.as_tensor(np.asarray(want)).double()
    return float((got - want).norm() / want.norm())


@pytest.fixture(scope="module")
def models():
    return S.F5Models.random(3, tiny=True)


def ref_trees(m, seed=3):
    return R.random_params(dataclasses.asdict(m.cfg),
                           dataclasses.asdict(m.vocos_cfg), S.WEIGHTS, seed,
                           "cpu")


def request(seed=0, ref_frames=37, ref_len=6, gen_len=9, vocab=40):
    rng = np.random.default_rng(seed)
    mel = rng.normal(-4, 2, (ref_frames, 100)).astype(np.float32)
    return (S.F5Voice(mel, rng.integers(0, vocab, ref_len).tolist()),
            rng.integers(0, vocab, gen_len).tolist())


def same_tree(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_tree(a[k], b[k]) for k in a)
    return torch.equal(a, b)


def test_weights_are_the_references(models):
    """The port's seeded draw is the reference's, tensor for tensor (the
    same layouts, order and scales)."""
    p, v = ref_trees(models)
    assert same_tree(models.params, p) and same_tree(models.vocos_params, v)


@pytest.mark.parametrize("nfe", [32, 7])
def test_sway_schedule(nfe):
    """t_k = s + sway (cos(pi s / 2) - 1 + s), s = k / nfe, bit for bit
    the reference's; dt_k its differences; t runs from 0 to 1."""
    t, dt = FM.schedule(nfe, -1.0)
    want = R.schedule(nfe, -1.0)
    assert torch.equal(t, want[:-1]) and torch.equal(dt, want[1:] - want[:-1])
    assert want[0] == 0 and want[-1] == 1
    s = torch.arange(nfe + 1, dtype=torch.float64) / nfe
    assert torch.allclose(want.double(), s - (torch.cos(torch.pi / 2 * s)
                                              - 1 + s), atol=1e-6)


@pytest.mark.parametrize("case", [(37, 6, 9), (300, 50, 90), (5, 3, 2)])
def test_duration_rule(case):
    """utils_infer's T and cfm.py's floor, as the reference has them."""
    ref_frames, ref_len, gen_len = case
    assert S.frames(*case) == R.frames(*case)
    assert S.frames(*case) > max(ref_len + gen_len, ref_frames)


def _eval_inputs(m, voice, gen, t_pad=None, seed=1):
    """The port's inputs of one CFG eval: (prep, x, cond_text, masks) at
    T (``t_pad`` frames with the rest masked)."""
    cfg = m.cfg
    ids = voice.text + gen
    t = S.frames(voice.mel.shape[0], len(voice.text), len(gen))
    tp = t_pad or t
    prep = FM.prepare(m.params, cfg)
    idx = torch.zeros(tp, dtype=torch.long)
    idx[:len(ids)] = torch.as_tensor(ids) + 1
    valid = torch.arange(tp) < t
    fm = None if tp == t else valid[None, :, None]
    text = FM.text_embed(prep, cfg, idx, len(ids), fm)
    cond = torch.zeros(2, tp, cfg.mel_dim)
    cond[0, :voice.mel.shape[0]] = torch.as_tensor(voice.mel)
    x = torch.zeros(1, tp, cfg.mel_dim)
    x[0, :t] = torch.randn(t, cfg.mel_dim,
                           generator=torch.Generator().manual_seed(seed))
    kv = None if fm is None else valid.expand(2, tp)
    return prep, x, torch.cat([cond, text], -1), fm, kv, t


@pytest.mark.parametrize("k", PROBES)
def test_one_cfg_eval(models, k):
    """One eval (both rows, guided) at an unpadded T equals the
    reference's guided velocity at the same state and time (``F32``)."""
    voice, gen = request()
    prep, x, ct, fm, kv, t = _eval_inputs(models, voice, gen)
    tk = FM.schedule(32, -1.0)[0][k:k + 1]
    v = FM.guided(FM.velocity(prep, models.cfg, x, ct, tk, fm, kv), 2.0)
    p, _ = ref_trees(models)
    req = R.Request(p, dataclasses.asdict(models.cfg), voice.mel, voice.text,
                    gen)
    assert rel(v[0], req.velocity(x[0], tk[0])) < F32


def test_padded_eval_equals_the_unpadded_one(models):
    """T rounded up to its bucket (256) with the padded frames masked
    gives the unpadded eval's velocities on the real frames (``PAD``),
    both rows."""
    voice, gen = request(seed=4)
    tk = torch.tensor([0.3])
    outs = []
    for pad in (None, S.BUCKET):
        prep, x, ct, fm, kv, t = _eval_inputs(models, voice, gen, pad)
        outs.append(FM.velocity(prep, models.cfg, x, ct, tk, fm, kv)[:, :t])
    assert outs[1].shape[1] < S.BUCKET
    assert rel(outs[1], outs[0]) < PAD


def test_grn_reads_only_the_real_frames():
    """The GRN's norm over time leaves masked frames out: a padded map
    gives the unpadded map's GRN on its frames."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 11, 8, generator=g)
    gamma, beta = torch.randn(8, generator=g), torch.randn(8, generator=g)
    pad = torch.cat([x, torch.randn(2, 5, 8, generator=g)], dim=1)
    mask = (torch.arange(16) < 11)[None, :, None]
    assert torch.allclose(FM.grn(pad, gamma, beta, mask)[:, :11],
                          FM.grn(x, gamma, beta), atol=1e-6)


@pytest.mark.parametrize("frames", [1, 9, 40])
def test_vocos_matches_the_reference(models, frames):
    """Vocos (fold-based iSTFT) on a (mel, n) log-mel equals the
    reference's frame-by-frame overlap-add (``F32``)."""
    _, v = ref_trees(models)
    mel = torch.randn(1, 100, frames,
                      generator=torch.Generator().manual_seed(frames))
    got = VM.forward(models.vocos_params, models.vocos_cfg, mel)[0]
    want = R.vocos(v, dataclasses.asdict(models.vocos_cfg), mel[0])
    assert got.shape == (frames * models.vocos_cfg.hop,)
    assert rel(got, want) < F32


def test_synthesize_runs_the_loop_and_vocos(models):
    """``synthesize()`` on the bundle: the loop at T's bucket from the
    seed's y0, against the reference's unpadded 32-step loop and its
    Vocos on the port's mel (``F32``); the probes against the reference's
    guided velocity at the port's own states."""
    voice, gen = request(seed=2)
    res = synthesize(models, tokens=gen, voice=voice, seed=5, device="cpu",
                     probe_steps=PROBES)
    p, v = ref_trees(models)
    c = dataclasses.asdict(models.cfg)
    req = R.Request(p, c, voice.mel, voice.text, gen)
    y0 = torch.randn(req.t_len, 100,
                     generator=torch.Generator().manual_seed(5))
    mel = req.sample(y0)[req.ref_frames:].T
    assert res.mel.shape == tuple(mel.shape)
    assert rel(res.mel, mel) < F32
    ts = R.schedule(32, -1.0)
    assert res.probes["steps"] == list(PROBES)
    for j, k in enumerate(PROBES):
        assert rel(res.probes["v"][j],
                   req.velocity(res.probes["x"][j], ts[k])) < F32
    audio = R.vocos(v, dataclasses.asdict(models.vocos_cfg),
                    torch.as_tensor(res.mel))
    assert rel(res.audio, audio) < F32
    assert res.sample_rate == 24000 and res.tokens == gen
    assert {"f5_s", "f5_loop_s", "vocos_s"} <= set(res.timings)


def test_bf16_plane_and_its_fp8_control(models):
    """The bf16 plane against the bf16-rounded reference within ``BF16``:
    its loop from the same y0, its guided velocity at its own probed
    states; the fp8 control's velocity at those states beyond it (the
    check's method)."""
    voice, gen = request(seed=6)
    res = synthesize(models, tokens=gen, voice=voice, seed=8, device="cpu",
                     compute_dtype=torch.bfloat16, probe_steps=PROBES)
    p, _ = ref_trees(models)
    c = dataclasses.asdict(models.cfg)
    ref, ctrl = (R.Request(p, c, voice.mel, voice.text, gen, r)
                 for r in ("bf16", "fp8"))
    y0 = torch.randn(ref.t_len, 100,
                     generator=torch.Generator().manual_seed(8))
    assert rel(res.mel, ref.sample(y0)[ref.ref_frames:].T) < BF16
    ts = R.schedule(32, -1.0)
    for j, k in enumerate(PROBES):
        x, want = res.probes["x"][j], ref.velocity(res.probes["x"][j], ts[k])
        assert rel(res.probes["v"][j], want) < BF16
        assert rel(ctrl.velocity(x, ts[k]), want) > BF16


def test_spans_and_counters(models):
    """Under the profiler a request records its spans: ``synthesize``
    over the stages ``f5`` and ``vocos``; ``f5.text``; the loop with
    ``steps`` 32 and ``frames`` (the padded T); ``vocos.forward`` with
    ``audio_s``."""
    voice, gen = request(seed=3)
    profiling.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        res = synthesize(models, tokens=gen, voice=voice, seed=1,
                         device="cpu")
    spans = {s.name: s for s in profiling.records()}
    assert {"synthesize", "f5", "f5.cast", "f5.text", "f5.denoise_loop",
            "vocos", "vocos.forward", "download"} <= set(spans)
    loop = spans["f5.denoise_loop"]
    assert loop.counters["steps"] == 32
    assert loop.counters["frames"] == S.BUCKET
    root = spans["synthesize"].id
    assert all(s.request == root for s in spans.values())
    assert spans["vocos.forward"].counters["audio_s"] == pytest.approx(
        len(res.audio) / res.sample_rate)


class _FakeGraph:
    """torch.cuda.CUDAGraph's stand-in: a replay reruns the captured step
    in Python."""

    def replay(self):
        step = next(g for _, g in graphs.entries() if g._graph is self)
        step._step(step.bufs)


@contextlib.contextmanager
def _fake_capture(graph, **kw):
    """torch.cuda.graph's stand-in: the step runs, and its buffers are
    put back after, as a capture records without running."""
    step = next(g for _, g in graphs.entries()
                if g._warm and g._graph is None)
    saved = [(t, t.clone()) for t in step.bufs.values()
             if isinstance(t, torch.Tensor)]
    yield
    for t, v in saved:
        t.copy_(v)


class _Stream:
    def wait_stream(self, other):
        pass


def test_loop_replays_one_captured_step_a_bucket(models, monkeypatch):
    """On the graph route (stubbed here) a request warms up, captures and
    replays one step: 1 + 1 + 30 steps, the eager loop's mel and probes
    bit for bit; a second request of another length in the same bucket
    replays all 32 on the same entry."""
    for name, value in (("CUDAGraph", _FakeGraph), ("graph", _fake_capture),
                        ("Stream", _Stream), ("current_stream", _Stream),
                        ("stream", lambda s: contextlib.nullcontext())):
        monkeypatch.setattr(torch.cuda, name, value)
    voice, gen = request(seed=7)
    eager = synthesize(models, tokens=gen, voice=voice, seed=2, device="cpu",
                       probe_steps=PROBES)
    monkeypatch.setattr(graphs, "use_graphs",
                        lambda device, mesh=None: mesh is None)
    graphs.clear()
    try:
        got = synthesize(models, tokens=gen, voice=voice, seed=2,
                         device="cpu", probe_steps=PROBES)
        (key, g), = graphs.entries()
        assert (g.warmups, g.captures, g.replays) == (1, 1, 30)
        synthesize(models, tokens=gen[:-2], voice=voice, seed=3,
                   device="cpu")
        assert len(graphs.entries()) == 1 and g.replays == 62
    finally:
        graphs.clear()
    assert np.array_equal(got.mel, eager.mel)
    assert np.array_equal(got.audio, eager.audio)
    assert torch.equal(got.probes["v"], eager.probes["v"])


@pytest.mark.parametrize("n,ref_len,parts", [(90, 50, 1), (90, 6, 3),
                                              (101, 5, 4)])
def test_long_texts_are_chunked(models, n, ref_len, parts):
    """A text past utils_infer's max_chars = len(ref) / ref_s * (22 -
    ref_s) (here a 3 s clip: 19 / 3 ids a reference id) is cut into
    nearly equal chunks of at most that many ids, in order."""
    vc = models.vocos_cfg
    ref_frames = 3 * vc.sample_rate // vc.hop
    chunks = S.chunk_texts(list(range(n)), ref_frames, ref_len, vc)
    assert sum(chunks, []) == list(range(n))
    assert len(chunks) == parts
    assert all(len(ch) <= int(ref_len / 3 * 19) for ch in chunks)


def test_chunked_synthesis_joins_the_chunks(models, monkeypatch):
    """Each chunk is one loop on the same clip, seeded seed + i; the
    audio and the mel are the chunks' joined."""
    voice, gen = request(seed=5, gen_len=12)
    with monkeypatch.context() as mp:
        mp.setattr(S, "chunk_texts", lambda g, *a: [list(g[:5]),
                                                    list(g[5:])])
        res = synthesize(models, tokens=gen, voice=voice, seed=4,
                         device="cpu")
    parts = [synthesize(models, tokens=g, voice=voice, seed=s, device="cpu")
             for g, s in ((gen[:5], 4), (gen[5:], 5))]
    assert np.array_equal(res.mel, np.concatenate([p.mel for p in parts],
                                                  axis=1))
    assert np.array_equal(res.audio, np.concatenate([p.audio
                                                     for p in parts]))


def test_the_references_agree_bit_for_bit(models):
    """``benchmark/reference/f5.py`` and ``tests/reference_f5.py`` give
    the same weights, velocity, loop and audio to the last bit."""
    spec = importlib.util.spec_from_file_location(
        "bench_reference_f5", os.path.join(ROOT, "benchmark", "reference",
                                           "f5.py"))
    B = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(B)
    c, vc = (dataclasses.asdict(models.cfg),
             dataclasses.asdict(models.vocos_cfg))
    voice, gen = request(seed=11)
    outs = []
    for mod in (R, B):
        p, v = mod.random_params(c, vc, S.WEIGHTS, 21, "cpu")
        req = mod.Request(p, c, voice.mel, voice.text, gen, "bf16")
        y0 = torch.randn(req.t_len, 100,
                         generator=torch.Generator().manual_seed(3))
        mel = req.sample(y0)
        outs.append([mel, req.velocity(y0, torch.tensor(0.5)),
                     mod.vocos(v, vc, mel[req.ref_frames:].T, "tf32")])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_references_import_neither_the_port_nor_jax():
    """Both copies of the reference load torch and nothing of the port or
    of JAX."""
    code = ("import sys, importlib.util\n"
            "for i, p in enumerate(sys.argv[1:]):\n"
            "    s = importlib.util.spec_from_file_location(f'r{i}', p)\n"
            "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run(
        [sys.executable, "-c", code, os.path.join(HERE, "reference_f5.py"),
         os.path.join(ROOT, "benchmark", "reference", "f5.py")],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "torch" in tops
    assert not tops & {"jax", "jaxlib", "tortoise_tpu", "tortoise_tpu_torch"}


def test_a_tortoise_process_loads_nothing_of_f5():
    """The F5 modules load only when an F5 bundle is synthesized."""
    code = ("import sys\n"
            "import tortoise_tpu_torch.pipeline.synthesize\n"
            "import tortoise_tpu_torch.cli, tortoise_tpu_torch.serve\n"
            "print(sorted(m for m in sys.modules if 'f5' in m "
            "or 'vocos' in m))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_cli_family_f5(tmp_path):
    """``cli --family f5 --random-weights --tiny`` writes the WAV of a
    seeded reference clip and stand-in ids."""
    from tortoise_tpu_torch import cli
    from tortoise_tpu_torch.io.wav import read_wav

    out = tmp_path / "f5.wav"
    res = cli.run(["--family", "f5", "--random-weights", "--tiny",
                   "--device", "cpu", "--seed", "3", "--no-progress",
                   "--tokens", "5,6,7,8,9", "--output", str(out)])
    audio, sr = read_wav(str(out))
    assert sr == 24000 and len(audio) == len(res.audio) > 0
    assert res.tokens == [5, 6, 7, 8, 9]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the step graph and kernel B run "
                    "only there)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graph_loop_and_kernel_b_on_card(cuda_device, monkeypatch):
    """One bucket on the card (4 heads of 64, so kernel B's fused-qkv
    body): the step graph's loop in bf16 against the eager CPU path, 2e-2
    relative L2 on the mel, the probes and the audio; every attention a
    launch of B (2 blocks x 32 steps). y0 is drawn on the CPU for both
    (the card's generator draws other numbers)."""
    from tortoise_tpu_torch.ops import cuda as kernels

    monkeypatch.setattr(S, "draw_normal", lambda gen, shape, device: (
        torch.randn(shape, generator=torch.Generator().manual_seed(9))
        .to(device)))

    cfg = dataclasses.replace(FM.tiny_f5_config(), dim=256, heads=4)
    vcfg = VM.tiny_vocos_config()
    p, v = S.random_params(cfg, vcfg, S.WEIGHTS, 5, "cpu")
    voice, gen = request(seed=1, ref_frames=300, ref_len=40, gen_len=60)
    outs = {}
    for dev in ("cpu", cuda_device):
        m = S.F5Models(p, v, cfg, vcfg)
        graphs.clear()
        kernels.reset_launch_counts()
        outs[str(dev)] = synthesize(m, tokens=gen, voice=voice, seed=9,
                                    compute_dtype=torch.bfloat16,
                                    device=dev, probe_steps=PROBES)
        if dev != "cpu":
            (_, g), = graphs.entries()
            assert (g.warmups, g.captures, g.replays) == (1, 1, 30)
            assert kernels.launch_counts()["flash_attention_packed"] == \
                cfg.depth * cfg.nfe
    cpu, card = outs["cpu"], outs[str(cuda_device)]
    assert rel(card.mel, cpu.mel) < 2e-2
    assert rel(card.probes["v"].cpu(), cpu.probes["v"]) < 2e-2
    assert rel(card.audio, cpu.audio) < 2e-2
