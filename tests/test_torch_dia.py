"""Dia-1.6B and the DAC decoder in the port (``models.dia``,
``models.dac``, ``pipeline.dia_stage``, ``pipeline.dac_stage``) against
the plain reference ``tests/reference_dia.py``, at a tiny size on the
CPU (2 + 2 layers of width 64, 4 heads of 16, 2 K/V heads, 3 channels of
40 codes, delay (0, 2, 3); a DAC of 2 blocks), on seeded weights.

Tolerances, each for its reason:

- ``F32``: 2e-6 relative L2. Both sides are f32 on the same weights; they
  differ only in the order of sums (batched rows, the fused q/k/v, the
  cache against one causal pass, kernel D's plain twin against a
  softmax), each ~1e-7.
- ``BF16``: the bf16 plane against the bf16-rounded reference, 1.5e-2:
  both round the same product operands, but the port rounds the softmax
  weights before their normalisation (kernel D) and the reference after,
  ~4e-3 here; ``FP8``: the fp8 control (e4m3 operands) reads ~6e-2
  there, so it must exceed 1.5e-2.
- ``HF``: 1e-5 between the reference and transformers' own modules on
  the same weights (another order of sums in f32).

The ``cuda`` case (a card only) runs the decode step graph at full width
and kernel D2's routes against the eager CPU path.
"""

import contextlib
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import reference_dia as R
from tortoise_tpu_torch.models import dac as DM
from tortoise_tpu_torch.models import dia as M
from tortoise_tpu_torch.params import numel
from tortoise_tpu_torch.pipeline import dia_stage as S
from tortoise_tpu_torch.pipeline import graphs
from tortoise_tpu_torch.pipeline.synthesize import synthesize
from tortoise_tpu_torch.utils import profiling

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
F32, BF16, HF = 2e-6, 1.5e-2, 1e-5


def rel(got, want) -> float:
    got = torch.as_tensor(np.asarray(got)).double()
    want = torch.as_tensor(np.asarray(want)).double()
    return float((got - want).norm() / want.norm())


@pytest.fixture(scope="module")
def models():
    return S.DiaModels.random(3, tiny=True)


def ref_trees(m, seed=3):
    return R.random_params(dataclasses.asdict(m.cfg),
                           dataclasses.asdict(m.dac_cfg), S.WEIGHTS, seed,
                           "cpu")


def request(seed=0, prompt=7, ref_len=9, gen_len=12):
    rng = np.random.default_rng(seed)
    return (S.DiaVoice(rng.integers(0, 36, (prompt, 3)),
                       rng.integers(3, 200, ref_len).tolist()),
            rng.integers(3, 200, gen_len).tolist())


def same_tree(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_tree(a[k], b[k]) for k in a)
    return torch.equal(a, b)


def test_weights_are_the_references(models):
    """The port's seeded draw is the reference's, tensor for tensor; the
    query projections are drawn at std / sqrt(head width) and the norm
    weights and Snake's alphas centred at 1."""
    p, d = ref_trees(models)
    assert same_tree(models.params, p) and same_tree(models.dac_params, d)
    q = models.params["decoder"]["q"]
    assert float(q.std()) == pytest.approx(0.02 / 4, rel=0.1)
    assert float(models.params["encoder"]["sa_norm"].mean()) == \
        pytest.approx(1.0, abs=0.01)
    assert float(models.dac_params["block0"]["res1"]["alpha2"].mean()) == \
        pytest.approx(1.0, abs=0.02)


def test_full_width_parameter_count():
    """The published widths hold 1.611 B parameters (encoder 251.7 M,
    decoder 1,321.3 M, embeddings and head 38.2 M); the DAC decoder
    54.2 M."""
    n = numel(M.param_shapes(M.DiaConfig()))
    assert n == 1_611_160_576
    assert numel(DM.param_shapes(DM.DacConfig())) == 54_247_777


@pytest.mark.parametrize("text,ids", [
    ("[S1] Hi. [S2] Yo!", [1, 32, 72, 105, 46, 32, 2, 32, 89, 111, 33]),
    ("café", [99, 97, 102, 195, 169]),
    ("", [])])
def test_byte_tokenizer(text, ids):
    """DiaTokenizer: UTF-8 bytes, ``[S1]`` and ``[S2]`` as bytes 1 and
    2."""
    assert M.tokenize(text) == ids


def test_rotary_tables():
    """The complex table holds rotate-half's angles (inv_freq 1 /
    theta^(2i / D)), the reference's; on pair-ordered q/k rows the
    in-place complex rotary equals the reference's rotate-half of the
    unpermuted dims, and v passes unrotated."""
    cis = M.rope_table(50, 16, 10000.0, torch.device("cpu"))
    rc, rs = R.rope(50, 16, 10000.0, "cpu")
    assert torch.allclose(cis.real, rc[:, :8], atol=1e-6)
    assert torch.allclose(cis.imag, rs[:, :8], atol=1e-6)
    assert torch.equal(rc[:, :8], rc[:, 8:])
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 50, h, 16, generator=g) for h in (4, 2, 2))
    perm = M.pair_order(torch.eye(16)[:, None].expand(16, 1, 16)
                        .reshape(16, 16), 16).argmax(-1)
    qkv = torch.cat([q[..., perm].flatten(-2), k[..., perm].flatten(-2),
                     v.flatten(-2)], dim=-1)
    gq, gk, gv = M.rotate_qk(qkv, 4, 2, 16, cis, torch.float32)
    inv = torch.argsort(perm)
    for got, want in ((gq, q), (gk, k)):
        ref = R.rotate(want.transpose(1, 2), rc, rs).transpose(1, 2)
        assert torch.allclose(got[..., inv], ref, atol=1e-5)
    assert torch.equal(gv, v)


@pytest.mark.parametrize("pad", [0, 5])
def test_encoder(models, pad):
    """Both CFG rows of the port's encoder (the unconditioned row zero
    bytes) at the text's length, and padded with the padded keys masked,
    equal the reference's rows on the unpadded text (``F32``)."""
    p, _ = ref_trees(models)
    c = dataclasses.asdict(models.cfg)
    text = np.random.default_rng(1).integers(3, 200, 13).tolist()
    n = len(text)
    ids = torch.zeros(n + pad, dtype=torch.long)
    ids[:n] = torch.tensor(text)
    valid = (torch.arange(n + pad) < n).expand(2, -1)
    prep = M.prepare(models.params, models.cfg)
    got = M.encode(prep, models.cfg, torch.stack([ids, torch.zeros_like(ids)]),
                   valid)[:, :n]
    assert rel(got[0], R.encode(p, c, text)) < F32
    assert rel(got[1], R.encode(p, c, [0] * n)) < F32


def _cached_logits(m, text, grid, prompt, steps, pad=0, cd=None):
    """The port's logits (2, steps, C, V): ``prompt`` positions of
    ``grid`` prefilled into the cache, then one decode step a position
    (teacher-forced on ``grid``)."""
    cfg = m.cfg
    prep = M.prepare(m.params, cfg, cd)
    dt = cd or torch.float32
    n = len(text)
    tt = n + pad
    ids = torch.zeros(tt, dtype=torch.long)
    ids[:n] = torch.tensor(text)
    valid = (torch.arange(tt) < n).expand(2, -1)
    enc = M.encode(prep, cfg, torch.stack([ids, torch.zeros_like(ids)]),
                   valid, cd)
    ck, cv = M.cross_kv(prep, cfg, enc, cd)
    tmask = M.key_mask(valid)
    tc = prompt + steps + 3
    shape = (cfg.dec_layers, 2, cfg.dec_kv_heads, tc, cfg.dec_head_dim)
    cache_k, cache_v = torch.zeros(shape, dtype=dt), torch.zeros(shape,
                                                                 dtype=dt)
    g = torch.as_tensor(grid)
    if prompt:
        M.prefill(prep, cfg, g[:prompt], cache_k, cache_v, ck, cv, tmask, cd)
    out = []
    for i in range(steps):
        pos = torch.tensor([prompt + i])
        smask = M.key_mask(torch.arange(tc) <= pos).expand(2, tc)
        out.append(M.decode_step(prep, cfg, g[prompt + i][None], pos,
                                 cache_k, cache_v, ck, cv, smask, tmask, cd))
    return torch.stack(out, dim=1)


@pytest.mark.parametrize("pad", [0, 11])
def test_prefill_and_cached_decode_match_the_full_forward(models, pad):
    """A 9-position prefill and 20 cached decode steps give the
    teacher-forced full forward's logits, both rows and every channel
    (``F32``); with ``pad`` the text is padded and its keys masked (a
    ragged text mask)."""
    p, _ = ref_trees(models)
    c = dataclasses.asdict(models.cfg)
    rng = np.random.default_rng(2)
    text = rng.integers(3, 200, 17).tolist()
    grid = rng.integers(0, 36, (29, 3))
    got = _cached_logits(models, text, grid, 9, 20, pad)
    want = R.logits(p, c, text, grid)[:, 9:29]
    assert rel(got, want) < F32
    assert rel(got[1], want[1]) < F32  # the unconditioned row alone


def test_bf16_plane_and_its_fp8_control(models):
    """On bf16 operands, against the bf16-rounded reference within
    ``BF16``; the fp8 control beyond it (the check's method)."""
    p, _ = ref_trees(models)
    c = dataclasses.asdict(models.cfg)
    rng = np.random.default_rng(4)
    text = rng.integers(3, 200, 21).tolist()
    grid = rng.integers(0, 36, (40, 3))
    got = _cached_logits(models, text, grid, 16, 24, 7, torch.bfloat16)
    want = R.logits(p, c, text, grid, "bf16")[:, 16:40]
    assert rel(got, want) < BF16
    ctrl = R.logits(p, c, text, grid, "fp8")[:, 16:40]
    assert rel(ctrl, want) > BF16


def test_delay_grid_and_revert_round_trip(models):
    """``delay_grid`` is DiaProcessor's: channel c's frame t at position
    t + 1 + delay[c], BOS before it, PAD after; reading the frames back at
    step g + delay[c] (``revert``) gives the codes again."""
    cfg = models.cfg
    codes = np.arange(15).reshape(5, 3) + 1
    g = S.delay_grid(codes, cfg)
    assert g.shape == (1 + 5 + 3, 3)
    assert g[:, 0].tolist() == [38, 1, 4, 7, 10, 13, 37, 37, 37]
    assert g[:, 1].tolist() == [38, 38, 38, 2, 5, 8, 11, 14, 37]
    assert g[:, 2].tolist() == [38, 38, 38, 38, 3, 6, 9, 12, 15]
    steps = torch.as_tensor(g[1:])
    assert torch.equal(S.revert(steps, cfg, 5), torch.as_tensor(codes.T))
    assert S.delay_grid(np.zeros((0, 3)), cfg).tolist() == [
        [38, 38, 38], [37, 38, 38], [37, 38, 38], [37, 37, 38]]


def _logits(seed, cfg, lead_eos=False):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, cfg.channels, cfg.vocab, generator=g) * 3
    if lead_eos:
        x[0, 0, cfg.eos] = 50.0
    return x


def _guide(cfg, logits, s, eos_at=-1, lo=0, hi=100):
    t = lambda v: torch.tensor([v])  # noqa: E731
    return S.guide(cfg, logits, t(s), t(eos_at), t(lo), t(hi))


def test_cfg_top_k_keeps_the_cond_logits(models):
    """The guided logits pick the top ``guidance_top_k`` codes; the
    scores there are the cond logits (over the temperature), not the
    guided ones; a channel past channel 0 never scores EOS or above."""
    cfg = models.cfg
    x = _logits(0, cfg)
    scores, _ = _guide(cfg, x, 3)
    guided = x[0] + (x[0] - x[1]) * cfg.guidance
    for c in range(cfg.channels):
        top = set(guided[c].topk(cfg.guidance_top_k).indices.tolist())
        kept = set(torch.nonzero(scores[c] > -1e30).flatten().tolist())
        assert kept <= top and kept
        for i in kept:
            assert scores[c, i] == x[0, c, i] / cfg.temperature
    assert bool((scores[1:, cfg.eos:] < -1e30).all())
    assert bool((scores[0, cfg.eos + 1:] < -1e30).all())


def test_channel_masks_and_the_eos_countdown(models):
    """EOS leading on channel 0 is its only candidate and starts the
    countdown: channel c takes EOS at e + delay[c] (3 steps of tail at
    delay (0, 2, 3)), PAD after; before it, EOS is masked everywhere."""
    cfg = models.cfg
    scores, e = _guide(cfg, _logits(1, cfg), 4)
    assert int(e) == -1 and bool((scores[:, cfg.eos] < -1e30).all())
    scores, e = _guide(cfg, _logits(1, cfg, lead_eos=True), 5)
    assert int(e) == 5
    assert torch.isfinite(scores[0]).sum() == 1 and scores[0].argmax() == 36
    seen = []
    for s in range(5, 10):
        codes, e = S.sample_codes(cfg, _logits(s, cfg, s == 5), torch.tensor(
            [s]), e if s > 5 else torch.tensor([-1]), torch.tensor([0]),
            torch.tensor([100]), torch.full((3,), 0.5), torch.full((3,), -1))
        seen.append(codes.tolist())
    eos, pad = cfg.eos, cfg.pad
    assert [r[0] for r in seen] == [eos, pad, pad, pad, pad]
    assert [r[1] for r in seen][2:] == [eos, pad, pad]
    assert [r[2] for r in seen][3:] == [eos, pad]
    assert all(r[c] < eos for r in seen[:2] for c in (1, 2))


def test_min_and_max_frames(models):
    """Before ``min_frames`` EOS is masked even where it leads; at
    ``max_frames`` it is forced on channel 0 whatever leads."""
    cfg = models.cfg
    scores, e = _guide(cfg, _logits(2, cfg, lead_eos=True), 3, lo=4)
    assert int(e) == -1 and bool(scores[0, cfg.eos] < -1e30)
    scores, e = _guide(cfg, _logits(2, cfg), 4, lo=4, hi=4)
    assert int(e) == 4 and scores[0].argmax() == cfg.eos
    assert torch.isfinite(scores[0]).sum() == 1


def test_sampler_matches_transformers_processors(models):
    """``guide`` over a run of steps equals transformers' Dia processor
    chain (CFG with top-k, min new tokens, temperature, the channel
    filter, top-k, top-p, the EOS delay pattern) as probabilities, EOS
    led at step 6; skipped where transformers lacks them."""
    lp = pytest.importorskip("transformers.generation.logits_process")
    if not hasattr(lp, "DiaEOSDelayPatternLogitsProcessor"):
        pytest.skip("this transformers has no Dia processors")
    cfg = models.cfg
    lo, hi = 3, 9
    chain = [lp.DiaClassifierFreeGuidanceLogitsProcessor(
                 cfg.guidance, cfg.guidance_top_k),
             lp.MinNewTokensLengthLogitsProcessor(1, lo, cfg.eos),
             lp.TemperatureLogitsWarper(cfg.temperature),
             lp.DiaEOSChannelFilterLogitsProcessor(cfg.channels, cfg.eos),
             lp.TopKLogitsWarper(cfg.guidance_top_k),
             lp.TopPLogitsWarper(cfg.top_p),
             lp.DiaEOSDelayPatternLogitsProcessor(
                 list(cfg.delay), cfg.eos, hi + cfg.max_delay + 2)]
    e = torch.tensor([-1])
    for s in range(12):
        x = _logits(10 + s, cfg, lead_eos=s == 6)
        ids = torch.zeros(cfg.channels, 1 + s, dtype=torch.long)
        want = x.reshape(-1, cfg.vocab).clone()
        for proc in chain:
            want = proc(ids, want)
        got, e = S.guide(cfg, x, torch.tensor([s]), e, torch.tensor([lo]),
                         torch.tensor([hi]))
        assert torch.allclose(torch.softmax(got, -1),
                              torch.softmax(want, -1), atol=1e-6), s
    assert int(e) == 6


def test_draw_takes_no_code_of_probability_zero():
    """The inverse-CDF draw at u = 0 and u just under 1 lands on codes
    that can be drawn."""
    scores = torch.full((2, 8), -float("inf"))
    scores[0, 3] = scores[0, 5] = 0.0
    scores[1, 0] = 1.0
    for u in (0.0, 0.999999):
        codes = S.draw(scores, torch.full((2,), u))
        assert codes[0] in (3, 5) and codes[1] == 0


@pytest.mark.parametrize("frames", [1, 6, 20])
def test_dac_matches_the_reference(models, frames):
    """The DAC decoder on (codebooks, frames) codes equals the
    reference's (``F32``), hop x frames samples long; codes past the
    codebook decode as code 0."""
    _, d = ref_trees(models)
    dc = dataclasses.asdict(models.dac_cfg)
    codes = torch.randint(0, 36, (1, 3, frames),
                          generator=torch.Generator().manual_seed(frames))
    got = S.dac_stage.dac(models.dac_params, codes, models.dac_cfg, "cpu")[0]
    assert got.shape == (frames * models.dac_cfg.hop,)
    assert rel(got, R.dac(d, dc, codes[0])) < F32
    special = codes.clone()
    special[0, 1, 0] = 38
    zeroed = codes.clone()
    zeroed[0, 1, 0] = 0
    assert torch.equal(
        S.dac_stage.dac(models.dac_params, special, models.dac_cfg, "cpu"),
        S.dac_stage.dac(models.dac_params, zeroed, models.dac_cfg, "cpu"))


def test_synthesize_end_to_end(models):
    """``synthesize()`` on the bundle: a forced length of 20 frames, the
    probed logits against the reference's teacher-forced forward over the
    program's own grid, the audio against the reference DAC on its codes
    (``F32``), 44.1 kHz."""
    voice, gen = request(seed=2)
    res = synthesize(models, tokens=gen, voice=voice, seed=5, device="cpu",
                     probe_steps=(0, 11, 23), min_frames=20, max_frames=20)
    p, d = ref_trees(models)
    c = dataclasses.asdict(models.cfg)
    grid = res.probes["grid"]
    assert grid.shape == (7 + 24, 3) and res.probes["steps"] == [0, 11, 23]
    assert torch.equal(grid[:8], torch.as_tensor(S.delay_grid(voice.codes,
                                                              models.cfg))[:8])
    want = R.logits(p, c, voice.text + gen, grid)
    for j, k in enumerate(res.probes["steps"]):
        assert rel(res.probes["logits"][j], want[:, 7 + k]) < F32
    assert res.codes.shape == (3, 20)
    assert bool((res.codes < 36).all())
    audio = R.dac(d, dataclasses.asdict(models.dac_cfg), res.codes)
    assert rel(res.audio, audio) < F32
    assert res.sample_rate == 44100 and len(res.audio) == 20 * 8
    assert res.tokens == voice.text + gen
    assert {"dia_s", "dia_loop_s", "dac_s"} <= set(res.timings)


def test_the_prompt_is_forced_into_the_delayed_channels(models):
    """In the first max-delay steps a channel whose delayed prompt still
    holds codes takes them, not its draw; no prompt gives BOS there."""
    voice, gen = request(seed=3, prompt=5)
    res = synthesize(models, tokens=gen, voice=voice, seed=1, device="cpu",
                     probe_steps=(0,), min_frames=6, max_frames=6)
    g = S.delay_grid(voice.codes, models.cfg)
    grid = res.probes["grid"].numpy()
    # positions 6 and 7: channel 1 (delay 2) and 2 (delay 3) still the prompt
    assert grid[6, 1] == g[6, 1] and grid[7, 2] == g[7, 2]
    assert grid[8, 2] == g[8, 2]
    none = synthesize(models, tokens=gen, voice=None, seed=1, device="cpu",
                      probe_steps=(0,), min_frames=4, max_frames=4)
    ng = none.probes["grid"].numpy()
    assert ng[:3, 2].tolist() == [38, 38, 38] and ng[1, 0] != 38


def test_text_and_message(models):
    """``message`` goes through the byte tokenizer; the transcript comes
    first."""
    voice, _ = request(seed=4)
    res = synthesize(models, message="[S1] Hi.", voice=voice, seed=1,
                     device="cpu", min_frames=3, max_frames=3)
    assert res.tokens == voice.text + [1, 32, 72, 105, 46]
    with pytest.raises(ValueError):
        synthesize(models, voice=voice, device="cpu", max_frames=3)


def test_spans_and_counters(models):
    """Under the profiler a request records ``synthesize`` over the
    stages ``dia`` and ``dac``; ``dia.text``, ``dia.prefill``; the loop
    with ``steps`` (frames + max delay + 1), ``frames`` (the cache
    bucket), ``text_len`` (the text bucket), ``prompt`` and ``text``;
    ``dac.forward`` with ``audio_s``."""
    voice, gen = request(seed=3)
    profiling.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        res = synthesize(models, tokens=gen, voice=voice, seed=1,
                         device="cpu", min_frames=10, max_frames=10)
    spans = {s.name: s for s in profiling.records()}
    assert {"synthesize", "dia", "dia.cast", "dia.text", "dia.prefill",
            "dia.decode_loop", "dac", "dac.cast", "dac.forward",
            "download"} <= set(spans)
    loop = spans["dia.decode_loop"].counters
    assert loop["steps"] == 10 + 3 + 1
    assert loop["frames"] == min(S.CACHE_BUCKET, models.cfg.max_positions)
    assert loop["text_len"] == S.TEXT_BUCKET
    assert (loop["prompt"], loop["text"]) == (7, 21)
    root = spans["synthesize"].id
    assert all(s.request == root for s in spans.values())
    assert spans["dac.forward"].counters["audio_s"] == pytest.approx(
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


def test_loop_replays_one_captured_step_a_key(models, monkeypatch):
    """On the graph route (stubbed here) a request warms up, captures and
    replays one step: its codes, probes and audio bit for bit the eager
    loop's; a second request at the same (text, cache) key replays every
    step on the same entry, and a longer text takes a second key."""
    for name, value in (("CUDAGraph", _FakeGraph), ("graph", _fake_capture),
                        ("Stream", _Stream), ("current_stream", _Stream),
                        ("stream", lambda s: contextlib.nullcontext())):
        monkeypatch.setattr(torch.cuda, name, value)
    voice, gen = request(seed=7)
    kw = dict(device="cpu", probe_steps=(0, 7, 16), min_frames=13,
              max_frames=13)
    eager = synthesize(models, tokens=gen, voice=voice, seed=2, **kw)
    monkeypatch.setattr(graphs, "use_graphs",
                        lambda device, mesh=None: mesh is None)
    graphs.clear()
    try:
        got = synthesize(models, tokens=gen, voice=voice, seed=2, **kw)
        (key, g), = graphs.entries()
        assert (g.warmups, g.captures, g.replays) == (1, 1, 15)
        again = synthesize(models, tokens=gen[:-2], voice=voice, seed=2,
                           **kw)
        assert len(graphs.entries()) == 1 and g.replays == 32
        synthesize(models, tokens=gen * 12, voice=voice, seed=3,
                   device="cpu", min_frames=2, max_frames=2)
        assert len(graphs.entries()) == 2
    finally:
        graphs.clear()
    assert np.array_equal(got.codes, eager.codes)
    assert np.array_equal(got.audio, eager.audio)
    assert torch.equal(got.probes["logits"], eager.probes["logits"])
    assert torch.equal(got.probes["grid"], eager.probes["grid"])
    assert again.codes.shape == (3, 13)


def test_the_references_agree_bit_for_bit():
    """``benchmark/reference/dia.py`` and ``tests/reference_dia.py`` are
    one file twice."""
    with open(os.path.join(ROOT, "benchmark", "reference", "dia.py"),
              "rb") as f:
        bench = f.read()
    with open(os.path.join(HERE, "reference_dia.py"), "rb") as f:
        assert f.read() == bench


def test_references_import_neither_the_port_nor_jax():
    """Both copies of the reference load torch and nothing of the port,
    of JAX or of transformers."""
    code = ("import sys, importlib.util\n"
            "for i, p in enumerate(sys.argv[1:]):\n"
            "    s = importlib.util.spec_from_file_location(f'r{i}', p)\n"
            "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run(
        [sys.executable, "-c", code, os.path.join(HERE, "reference_dia.py"),
         os.path.join(ROOT, "benchmark", "reference", "dia.py")],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "torch" in tops
    assert not tops & {"jax", "jaxlib", "tortoise_tpu", "tortoise_tpu_torch",
                       "transformers"}


def test_a_tortoise_process_loads_nothing_of_dia():
    """The Dia and DAC modules load only when a Dia bundle is
    synthesized."""
    code = ("import sys\n"
            "import tortoise_tpu_torch.pipeline.synthesize\n"
            "import tortoise_tpu_torch.cli, tortoise_tpu_torch.serve\n"
            "print(sorted(m for m in sys.modules if m.startswith("
            "'tortoise_tpu_torch') and ('dia' in m or 'dac' in m)))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_cli_family_dia(tmp_path):
    """``cli --family dia --random-weights --tiny`` writes the WAV of a
    seeded prompt and the message's bytes."""
    from tortoise_tpu_torch import cli
    from tortoise_tpu_torch.io.wav import read_wav

    out = tmp_path / "dia.wav"
    res = cli.run(["--family", "dia", "--random-weights", "--tiny",
                   "--device", "cpu", "--seed", "3", "--no-progress",
                   "--message", "[S1] Hi.", "--output", str(out)])
    audio, sr = read_wav(str(out))
    assert sr == 44100 and len(audio) == len(res.audio) > 0
    assert res.tokens[-5:] == [1, 32, 72, 105, 46]


# ------------------------------------------------ transformers cross-check

def _hf_dia(c, p):
    """transformers' DiaForConditionalGeneration at the tiny widths with
    the reference's weights."""
    mod = pytest.importorskip("transformers.models.dia.modeling_dia")
    conf = pytest.importorskip("transformers.models.dia.configuration_dia")
    enc = conf.DiaEncoderConfig(
        num_hidden_layers=c["enc_layers"], hidden_size=c["enc_dim"],
        num_attention_heads=c["enc_heads"],
        num_key_value_heads=c["enc_kv_heads"], head_dim=c["enc_head_dim"],
        intermediate_size=c["enc_ffn"], norm_eps=c["norm_eps"],
        vocab_size=c["enc_vocab"], rope_theta=c["rope_theta"])
    dec = conf.DiaDecoderConfig(
        num_hidden_layers=c["dec_layers"], hidden_size=c["dec_dim"],
        intermediate_size=c["dec_ffn"], num_attention_heads=c["dec_heads"],
        num_key_value_heads=c["dec_kv_heads"], head_dim=c["dec_head_dim"],
        cross_num_attention_heads=c["cross_heads"],
        cross_head_dim=c["cross_head_dim"],
        cross_num_key_value_heads=c["cross_heads"],
        cross_hidden_size=c["enc_dim"], norm_eps=c["norm_eps"],
        vocab_size=c["vocab"], num_channels=c["channels"],
        rope_theta=c["rope_theta"])
    cfg = conf.DiaConfig(encoder_config=enc, decoder_config=dec,
                         delay_pattern=list(c["delay"]),
                         eos_token_id=c["eos"], pad_token_id=c["pad"],
                         bos_token_id=c["bos"])
    cfg._attn_implementation = "eager"
    hf = mod.DiaForConditionalGeneration(cfg).eval()
    pe, pd = p["encoder"], p["decoder"]
    sd = {"model.encoder.embedding.weight": pe["emb"],
          "model.encoder.norm.weight": pe["norm"],
          "model.decoder.embeddings.embed.weight": pd["emb"],
          "model.decoder.norm.weight": pd["norm"],
          "logits_dense.weight": pd["head"]}
    for l in range(c["enc_layers"]):
        b = f"model.encoder.layers.{l}."
        sd.update({b + "pre_sa_norm.weight": pe["sa_norm"][l],
                   b + "post_sa_norm.weight": pe["mlp_norm"][l],
                   b + "mlp.gate_up_proj.weight": pe["gate_up"][l],
                   b + "mlp.down_proj.weight": pe["down"][l]})
        for n in "qkvo":
            sd[b + f"self_attention.{n}_proj.weight"] = pe[n][l]
    for l in range(c["dec_layers"]):
        b = f"model.decoder.layers.{l}."
        sd.update({b + "pre_sa_norm.weight": pd["sa_norm"][l],
                   b + "pre_ca_norm.weight": pd["ca_norm"][l],
                   b + "pre_mlp_norm.weight": pd["mlp_norm"][l],
                   b + "mlp.gate_up_proj.weight": pd["gate_up"][l],
                   b + "mlp.down_proj.weight": pd["down"][l]})
        for n in "qkvo":
            sd[b + f"self_attention.{n}_proj.weight"] = pd[n][l]
            sd[b + f"cross_attention.{n}_proj.weight"] = pd[f"ca_{n}"][l]
    missing, unexpected = hf.load_state_dict(sd, strict=False)
    assert not unexpected and all("rotary" in k or "offsets" in k
                                  for k in missing), (missing, unexpected)
    return hf


def test_reference_is_transformers_dia(models):
    """The reference's teacher-forced logits of both CFG rows equal
    transformers' ``DiaForConditionalGeneration`` (eager attention, no
    cache) on the same weights, text and grid (``HF``)."""
    c = dataclasses.asdict(models.cfg)
    p, _ = ref_trees(models)
    hf = _hf_dia(c, p)
    rng = np.random.default_rng(5)
    text = rng.integers(3, 200, 15).tolist()
    grid = rng.integers(0, 36, (22, 3))
    ids = torch.tensor([text, [0] * len(text)])
    with torch.no_grad():
        out = hf(input_ids=ids, attention_mask=torch.ones_like(ids),
                 decoder_input_ids=torch.as_tensor(grid)[None].repeat(2, 1, 1),
                 use_cache=False)
    got = out.logits.view(2, 3, 22, 40).transpose(1, 2)
    assert rel(got, R.logits(p, c, text, grid)) < HF


def test_reference_is_transformers_dac():
    """The reference DAC decoder equals transformers' ``DacModel.decode``
    on the same weights and codes (a power-of-two codebook, as DacModel
    asks), ``HF``."""
    mod = pytest.importorskip("transformers.models.dac.modeling_dac")
    conf = pytest.importorskip("transformers.models.dac.configuration_dac")
    dc = dict(n_codebooks=3, codebook_size=32, codebook_dim=4, latent=16,
              dim=32, rates=(4, 2), sample_rate=44100)
    hf = mod.DacModel(conf.DacConfig(
        encoder_hidden_size=4, downsampling_ratios=[2, 4],
        decoder_hidden_size=32, n_codebooks=3, codebook_size=32,
        codebook_dim=4)).eval()
    _, d = R.random_params(dataclasses.asdict(M.tiny_dia_config()), dc,
                           S.WEIGHTS, 9, "cpu")
    sd = {"decoder.conv1.weight": d["conv1_w"],
          "decoder.conv1.bias": d["conv1_b"],
          "decoder.snake1.alpha": d["alpha"][None, :, None],
          "decoder.conv2.weight": d["conv2_w"],
          "decoder.conv2.bias": d["conv2_b"]}
    for i in range(3):
        q = f"quantizer.quantizers.{i}."
        sd.update({q + "codebook.weight": d["codebook"][i],
                   q + "out_proj.weight": d["proj_w"][i][..., None],
                   q + "out_proj.bias": d["proj_b"][i]})
    for i in range(2):
        b, blk = f"decoder.block.{i}.", d[f"block{i}"]
        sd.update({b + "snake1.alpha": blk["alpha"][None, :, None],
                   b + "conv_t1.weight": blk["convt_w"],
                   b + "conv_t1.bias": blk["convt_b"]})
        for j in range(3):
            u, r = b + f"res_unit{j + 1}.", blk[f"res{j}"]
            sd.update({u + "snake1.alpha": r["alpha1"][None, :, None],
                       u + "conv1.weight": r["conv1_w"],
                       u + "conv1.bias": r["conv1_b"],
                       u + "snake2.alpha": r["alpha2"][None, :, None],
                       u + "conv2.weight": r["conv2_w"],
                       u + "conv2.bias": r["conv2_b"]})
    missing, unexpected = hf.load_state_dict(sd, strict=False)
    assert not unexpected
    assert all(k.startswith("encoder.") or "in_proj" in k for k in missing)
    codes = torch.randint(0, 32, (1, 3, 9),
                          generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = hf.decode(audio_codes=codes).audio_values[0]
    assert rel(got, R.dac(d, dc, codes[0])) < HF


# ----------------------------------------------------------------- card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the step graph and kernel D2 run "
                    "only there)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_full_width_step_graph_and_d2_on_card(cuda_device, monkeypatch):
    """At the published widths (2 encoder and 3 decoder layers) on bf16:
    the encoder, the cross K/V, a 40-position prefill and 22 decode steps
    through the step graph, every attention a launch of kernel D2 (at
    width 128 with ``kv_valid`` and scale 1, causal, and the single query
    with its GQA rows folded), against the eager CPU path on the same
    weights and uniforms: 2e-2 relative L2 on the logits of both rows at
    every probed step whose grid the two runs share."""
    from tortoise_tpu_torch.ops import cuda as kernels

    monkeypatch.setattr(S, "draw_uniform", lambda gen, shape, device: (
        torch.rand(shape, generator=torch.Generator().manual_seed(4))
        .to(device)))
    cfg = dataclasses.replace(M.DiaConfig(), enc_layers=2, dec_layers=3)
    p, _ = S.random_params(cfg, DM.tiny_dac_config(), S.WEIGHTS, 5, "cpu")
    rng = np.random.default_rng(0)
    voice = S.DiaVoice(rng.integers(0, 1024, (40, 9)),
                       rng.integers(32, 127, 50).tolist())
    gen = rng.integers(32, 127, 70).tolist()
    outs = {}
    for dev in ("cpu", cuda_device):
        graphs.clear()
        kernels.reset_launch_counts()
        prep = S._prepare(p, cfg, torch.bfloat16, dev)
        _, probes = S.generate(prep, cfg, voice.codes, voice.text + gen, 3,
                               6, 6, torch.bfloat16, torch.device(dev),
                               probe_steps=(0, 3, 6, 21))
        outs[str(dev)] = probes
        if dev != "cpu":
            (_, g), = graphs.entries()
            assert (g.warmups, g.captures, g.replays) == (1, 1, 20)
            # the encoder, the prefill's self and cross, 22 steps' of each
            assert kernels.launch_counts()["flash_attention_generic"] == \
                cfg.enc_layers + 2 * cfg.dec_layers * (1 + 22)
        graphs.clear()
        S.common.clear_cast_cache()
    cpu, card = outs["cpu"], outs[str(cuda_device)]
    shared = 0
    for j, k in enumerate(cpu["steps"]):
        if torch.equal(card["grid"][:41 + k].cpu(), cpu["grid"][:41 + k]):
            assert rel(card["logits"][j].cpu(), cpu["logits"][j]) < 2e-2
            shared += 1
    assert shared >= 1
