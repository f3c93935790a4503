"""The port's sampling loops as one step on device indices
(``pipeline/graphs.py``), on the CPU.

- The device-index step pieces (``models.ar._write_rows`` and
  ``_embed_step``, ``diffusion_stage.posterior_step`` on the schedule's
  device tables, the denoiser's time input from a device tensor) give
  the bits of the host-int formulas they replaced, kept here as the
  oracle.
- ``ar_stage._generate`` and ``diffusion_stage._denoise_loop`` give the
  tokens and mel of the host-int loops they replaced (copies here), and
  agree with the JAX package's loops on the same random numbers, within
  ``tests/pseudo_golden_lib.py``'s tolerance (1e-3 of max |out| on the
  f32 plane; the tokens equal).
- The graph cache (its key, LRU bound, and the drop of a tree's entries
  by ``clear_cast_cache`` and by the cast cache's eviction), the launch
  counts a replay adds, and the routing rule, with stubs standing in for
  ``torch.cuda``'s graph, stream and capture; through those stubs (a
  replay reruns the captured step) the graph route of both loops gives
  the eager route's bits, call after call on one cached entry.

The card's own cases (graph against eager at full kernels) are in
``tests/test_torch_cuda.py``.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tortoise_tpu.config import tiny_ar_config as jax_tiny_ar_config
from tortoise_tpu.models import ar as JAR
from tortoise_tpu.models import diffusion as JDM
from tortoise_tpu.pipeline import ar_stage as JS
from tortoise_tpu.pipeline import diffusion_stage as JDS
from tortoise_tpu_torch.config import tiny_ar_config, tiny_diffusion_config
from tortoise_tpu_torch.io.checkpoint import (
    random_ar_params,
    random_diffusion_params,
)
from tortoise_tpu_torch.models import ar as TAR
from tortoise_tpu_torch.models import diffusion as TDM
from tortoise_tpu_torch.ops import cuda as kernels
from tortoise_tpu_torch.ops import sampling as S
from tortoise_tpu_torch.pipeline import ar_stage as TS
from tortoise_tpu_torch.pipeline import common as TC
from tortoise_tpu_torch.pipeline import diffusion_stage as TDS
from tortoise_tpu_torch.pipeline import graphs
from tortoise_tpu_torch.pipeline import schedule as ds
from tortoise_tpu_torch.pipeline.schedule import timestep_embedding

torch.set_num_threads(1)  # the tier-1 run's workers share the cores

F32_TOL = 1e-3  # tests/pseudo_golden_lib.py's default


def close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), \
        (err, np.abs(want).max())


# ---------------------------------------------------------------------------
# the host-int formulas the device indices replaced (the oracle)
# ---------------------------------------------------------------------------

def host_write_rows(cache, k_rows, v_rows):
    n = cache.length
    cache.k[:, :, n] = k_rows.to(cache.k.dtype)
    cache.v[:, :, n] = v_rows.to(cache.v.dtype)
    cache.valid[:, n] = True
    return TAR.KVCache(cache.k, cache.v, cache.valid, n + 1)


def host_embed_step(params, tokens, step):
    return params["mel_emb"][tokens.long()] + params["mel_pos"][step + 2]


def host_posterior_step(sched, cfg, x, cond_mean, uncond_mean, var_frac, t,
                        noise, variance_swap=True):
    k = ds.cond_free_k(t, cfg.n_sample_timesteps, cfg.cond_free_k)
    k1 = float(np.float32(1.0) + np.float32(k))
    eps = k1 * cond_mean - k * uncond_mean
    frac = (var_frac + 1.0) / 2.0
    max_log, min_log = sched["log_betas"][t], sched["post_logvar"][t]
    logvar = (frac * min_log + (1.0 - frac) * max_log if variance_swap
              else frac * max_log + (1.0 - frac) * min_log)
    x0 = torch.clamp(sched["sqrt_recip_acp"][t] * x
                     - sched["sqrt_recipm1_acp"][t] * eps, -1.0, 1.0)
    mean = sched["coef1"][t] * x0 + sched["coef2"][t] * x
    if t > 0:
        return mean + torch.exp(0.5 * logvar) * noise
    return mean


def host_generate(params, cfg, first_logits, first_penalty_ids, cache,
                  generator, compute_dtype, sampler):
    """The sampling loop as it was: a Python list of per-step tokens and
    the host step passed to decode_step."""
    b, dev, stop = first_logits.shape[0], first_logits.device, \
        cfg.stop_mel_token

    def draw_u():
        return TS.draw_uniform(generator, (b, 1), dev)

    probs, ids = S.process_logits_topk(first_logits, first_penalty_ids,
                                       *sampler)
    tok = S.sample_from_topk_u(draw_u(), probs, ids)
    tokens, finished = [tok], tok == stop
    lengths = torch.ones((b,), dtype=torch.int32, device=dev)
    fuse = TAR.can_fuse_sampling(params, cfg, compute_dtype, b, sampler)
    step = 1
    while step < cfg.max_decode_steps and not bool((tok == stop).all()):
        prev, u = tok, draw_u()
        if fuse:
            tok, cache = TAR.decode_sample_step(params, cfg, cache, prev,
                                                step - 1, u, compute_dtype,
                                                sampler=sampler)
        else:
            logits, cache = TAR.decode_step(params, cfg, cache, prev,
                                            step - 1, compute_dtype)
            probs, ids = S.process_logits_topk(logits, prev[:, None].long(),
                                               *sampler)
            tok = S.sample_from_topk_u(u, probs, ids)
        tokens.append(tok)
        lengths = torch.where(finished, lengths, lengths + 1)
        finished = finished | (tok == stop)
        step += 1
    return torch.stack(tokens, dim=1), lengths


def host_denoise_loop(params, cfg, sched, code_emb2, x, out_buckets,
                      out_mask, draw_noise, compute_dtype, variance_swap):
    """The denoising loop as it was: host t, the schedule read at it."""
    b, n = x.shape[0], cfg.n_sample_timesteps
    tmap = sched["tmap"].numpy()
    for i in range(n):
        t = n - 1 - i
        out = TDM.denoise(params, cfg, torch.cat([x, x], dim=0), code_emb2,
                          int(tmap[t]), out_buckets, out_mask,
                          compute_dtype)
        x = host_posterior_step(sched, cfg, x, out[:b, :cfg.n_mel],
                                out[b:, :cfg.n_mel], out[:b, cfg.n_mel:], t,
                                draw_noise(), variance_swap)
        if out_mask is not None:
            x = torch.where(out_mask[:, None, :], x, 0.0)
    return x


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

PLANES = {"f32": (None, False), "bf16": (torch.bfloat16, False),
          "bf16_int8": (torch.bfloat16, True)}


AR_CFG = dataclasses.replace(tiny_ar_config(), fused_decode=True)
AR_HOST = random_ar_params(AR_CFG, 7)


def ar_case(plane, b=2, seed=7):
    """(cfg, cast params, first logits, first penalty ids, primed cache)
    on the tiny config (one weight tree; ``seed`` draws the prompt); the
    int8 plane runs kernel A's plain version."""
    cd, int8 = PLANES[plane]
    cfg = AR_CFG
    params = TS.cast_matmul_weights(AR_HOST, cd, int8)
    rng = np.random.default_rng(seed)
    t = 12
    ids = torch.as_tensor(rng.integers(0, cfg.n_text_vocab, (b, t)))
    valid = torch.arange(t)[None, :] < torch.tensor([[t], [9]])[:b]
    voice = torch.as_tensor(rng.normal(0, .5, cfg.d_model)
                            .astype(np.float32))
    logits, cache = TAR.prefill(params, cfg, ids, valid, voice, cd)
    first = torch.ones((b, t + 2), dtype=torch.long)
    first[:, -1] = cfg.start_mel_token
    return cfg, params, logits, first, cache


def fresh(cache):
    return TAR.KVCache(cache.k.clone(), cache.v.clone(), cache.valid.clone(),
                       cache.length)


DIFF_HOST = random_diffusion_params(tiny_diffusion_config(), 2)


def diffusion_case(b=2, steps=4, seed=2, masked=True):
    """(cfg, device params, sched, code_emb2, x, buckets, out_mask) on the
    tiny denoiser, f32 (one weight tree; ``seed`` draws the inputs)."""
    cfg = dataclasses.replace(tiny_diffusion_config(),
                              n_sample_timesteps=steps)
    params = TDS._prepare_params(DIFF_HOST, False, "cpu")
    rng = np.random.default_rng(seed)
    t = 24
    code = torch.as_tensor(rng.normal(0, .5, (2 * b, cfg.d_model, t))
                           .astype(np.float32))
    x = torch.as_tensor(rng.normal(0, 1, (b, cfg.n_mel, t))
                        .astype(np.float32))
    mask = None
    if masked:
        mask = torch.arange(t)[None, :] < torch.tensor([[t], [19]])[:b]
        x = torch.where(mask[:, None, :], x, 0.0)
    buckets = TDS._buckets(t, cfg, "cpu")
    return (cfg, params, TDS.schedule_arrays(cfg), code, x, buckets, mask)


def noise_source(shape, seed):
    rng = np.random.default_rng(seed)
    return lambda: torch.as_tensor(rng.normal(0, 1, shape)
                                   .astype(np.float32))


# ---------------------------------------------------------------------------
# the step pieces on device indices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("index", ["int", "device"])
def test_write_rows_and_embed_step_match_the_host_int_formulas(index):
    rng = np.random.default_rng(0)
    l, b, c, hd = 2, 3, 16, 8

    def arr(*shape):
        return torch.as_tensor(rng.normal(0, 1, shape).astype(np.float32))

    k, v = arr(l, b, c, hd).bfloat16(), arr(l, b, c, hd).bfloat16()
    valid = torch.as_tensor(rng.random((b, c)) < .5)
    want = TAR.KVCache(k.clone(), v.clone(), valid.clone(), 5)
    pos = None if index == "int" else torch.tensor([5])
    got = TAR.KVCache(k.clone(), v.clone(), valid.clone(), 5, pos)
    params = {"mel_emb": arr(40, hd), "mel_pos": arr(64, hd)}
    tokens = torch.as_tensor(rng.integers(0, 40, b))
    for step in range(3):
        rows = arr(l, b, hd), arr(l, b, hd)
        want = host_write_rows(want, *rows)
        got = TAR._write_rows(got, *rows)
        for name in ("k", "v", "valid"):
            assert torch.equal(getattr(got, name), getattr(want, name))
        assert got.length == want.length
        at = step if index == "int" else torch.tensor([step])
        assert torch.equal(TAR._embed_step(params, tokens, at),
                           host_embed_step(params, tokens, step))
    if pos is not None:
        assert got.pos is pos and pos.tolist() == [8]  # advanced in place


def test_schedule_tables_match_the_host_schedule():
    cfg = dataclasses.replace(tiny_diffusion_config(), n_sample_timesteps=80)
    sched = TDS.schedule_arrays(cfg)
    n = cfg.n_sample_timesteps
    s = ds.make_schedule(cfg.n_train_timesteps, n_steps=n)
    assert sched["tmap"].tolist() == list(s.timestep_map)
    for t in range(n):
        k = ds.cond_free_k(t, n, cfg.cond_free_k)
        assert float(sched["cfk"][t]) == k
        assert float(sched["cfk1"][t]) == float(np.float32(1) +
                                                np.float32(k))
    assert sched["noisy"].tolist() == [t > 0 for t in range(n)]


@pytest.mark.parametrize("swap", [True, False])
@pytest.mark.parametrize("t", [0, 1, 40, 79])
def test_posterior_step_matches_the_host_int_formula(t, swap):
    cfg = dataclasses.replace(tiny_diffusion_config(),
                              n_sample_timesteps=80)
    sched = TDS.schedule_arrays(cfg)
    rng = np.random.default_rng(t)
    x, cm, um, cv, noise = (torch.as_tensor(rng.normal(0, s, (2, 8, 12))
                                            .astype(np.float32))
                            for s in (1.0, .3, .3, .3, 1.0))
    want = host_posterior_step(sched, cfg, x, cm, um, cv, t, noise, swap)
    for at in (t, torch.tensor([t])):
        got = TDS.posterior_step(sched, cfg, x, cm, um, cv, at, noise, swap)
        assert torch.equal(got, want)


def test_denoiser_time_input_from_a_device_tensor():
    cfg, params, sched, code, x, buckets, mask = diffusion_case(
        b=1, masked=False)
    t = 2
    idx = torch.tensor([t])
    tmap = sched["tmap"]
    host = torch.full((2,), float(int(tmap[t])))
    assert torch.equal(
        timestep_embedding(tmap[idx].float().expand(2), cfg.timestep_dim),
        timestep_embedding(host, cfg.timestep_dim))
    x2 = torch.cat([x, x])
    assert torch.equal(
        TDM.denoise(params, cfg, x2, code, tmap[idx], buckets),
        TDM.denoise(params, cfg, x2, code, int(tmap[t]), buckets))


# ---------------------------------------------------------------------------
# the loops against the loops they replaced, and against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plane", list(PLANES))
def test_generate_matches_the_host_int_loop(plane):
    cfg, params, logits, first, cache = ar_case(plane)
    cd = PLANES[plane][0]
    want_t, want_l = host_generate(params, cfg, logits, first, fresh(cache),
                                   TC.make_generator(3, "cpu"), cd,
                                   TAR.DEFAULT_SAMPLER)
    got_t, got_l = TS._generate(params, cfg, logits, first, fresh(cache),
                                TC.make_generator(3, "cpu"), cd,
                                TAR.DEFAULT_SAMPLER)
    assert got_t.dtype == torch.int32
    assert torch.equal(got_t, want_t.to(torch.int32))
    assert torch.equal(got_l, want_l)


class JaxKey:
    """A jax.random key where the port keeps a torch.Generator."""

    def __init__(self, key):
        self.key = key


def split_then(draw):
    """A port draw seam that splits the key before each draw, as the JAX
    loops do."""
    def fn(gen, shape, device):
        gen.key, sub = jax.random.split(gen.key)
        return torch.as_tensor(np.asarray(draw(sub, shape)), device=device)
    return fn


def test_generate_matches_jax(monkeypatch):
    """f32 plane, the JAX key chain replayed through ``draw_uniform``:
    the JAX loop's tokens and lengths."""
    cfg, params, logits, first, cache = ar_case("f32")
    monkeypatch.setattr(TS, "draw_uniform", split_then(jax.random.uniform))
    toks, lengths = TS._generate(params, cfg, logits, first, fresh(cache),
                                 JaxKey(jax.random.PRNGKey(4)), None,
                                 TAR.DEFAULT_SAMPLER)
    jcfg = jax_tiny_ar_config()
    jp = JS.cast_matmul_weights(AR_HOST, None, False)
    rng = np.random.default_rng(7)
    t = 12
    ids = rng.integers(0, cfg.n_text_vocab, (2, t))
    valid = np.arange(t)[None, :] < np.array([[t], [9]])
    voice = rng.normal(0, .5, cfg.d_model).astype(np.float32)
    jl, jc = JAR.prefill(jp, jcfg, jnp.asarray(ids), jnp.asarray(valid),
                         jnp.asarray(voice))
    close(logits, jl, F32_TOL)
    jt, jn, jlen = JS._generate_body(jp, jcfg, jl, jnp.asarray(first.numpy()),
                                     jc, jax.random.PRNGKey(4),
                                     cfg.max_decode_steps)
    assert toks.tolist() == np.asarray(jt)[:, :int(jn)].tolist()
    assert lengths.tolist() == np.asarray(jlen).tolist()


@pytest.mark.parametrize("masked", [True, False])
def test_denoise_loop_matches_the_host_int_loop(masked):
    cfg, params, sched, code, x, buckets, mask = diffusion_case(
        masked=masked)
    want = host_denoise_loop(params, cfg, sched, code, x, buckets, mask,
                             noise_source(x.shape, 5), None, True)
    x_in = x.clone()
    got = TDS._denoise_loop(params, cfg, sched, code, x, buckets, mask,
                            noise_source(x.shape, 5), None, True)
    assert torch.equal(got, want)
    assert torch.equal(x, x_in)  # the caller's x is not written


def test_denoise_loop_matches_jax():
    """f32, the same noise each step: the JAX fori_loop body's mel."""
    cfg, params, sched, code, x, buckets, mask = diffusion_case()
    draws = [noise_source(x.shape, 6)() for _ in range(
        cfg.n_sample_timesteps)]
    it = iter(draws)
    got = TDS._denoise_loop(params, cfg, sched, code, x, buckets, mask,
                            lambda: next(it), None, True)
    jparams = jax.tree.map(jnp.asarray, DIFF_HOST)
    jsched = JDS._schedule_arrays(cfg)
    jx = jnp.asarray(x.numpy())
    jmask = jnp.asarray(mask.numpy())
    for i in range(cfg.n_sample_timesteps):
        t = cfg.n_sample_timesteps - 1 - i
        out = JDM.denoise(jparams, cfg, jnp.concatenate([jx, jx]),
                          jnp.asarray(code.numpy()), jsched["tmap"][t],
                          jnp.asarray(buckets.numpy()), jmask)
        b = jx.shape[0]
        jx = JDS.posterior_step(jsched, cfg, jx, out[:b, :cfg.n_mel],
                                out[b:, :cfg.n_mel], out[:b, cfg.n_mel:], t,
                                jnp.asarray(draws[i].numpy()))
        jx = jnp.where(jmask[:, None, :], jx, 0.0)
    close(got.numpy(), np.asarray(jx), F32_TOL)


# ---------------------------------------------------------------------------
# the graph cache, the launch counts, the routing rule (stubbed torch.cuda)
# ---------------------------------------------------------------------------

def _tensors(bufs):
    for v in bufs.values():
        if isinstance(v, torch.Tensor):
            yield v
        elif isinstance(v, TAR.KVCache):
            yield from (t for t in (v.k, v.v, v.valid, v.pos)
                        if t is not None)


def _set_counts(counts):
    now = kernels.launch_counts()
    kernels.add_launch_counts({k: n - now[k] for k, n in counts.items()})


class FakeGraph:
    """torch.cuda.CUDAGraph's stand-in: a replay reruns the captured
    step in Python, with the wrappers' counters left as they were (a
    replay runs no wrapper)."""

    made = []

    def __init__(self):
        FakeGraph.made.append(self)
        self.replays = 0

    def replay(self):
        self.replays += 1
        step = next(g for _, g in graphs.entries() if g._graph is self)
        counts = kernels.launch_counts()
        step._step(step.bufs)
        _set_counts(counts)


@contextlib.contextmanager
def fake_capture(graph, **kw):
    """torch.cuda.graph's stand-in: the step runs in Python but, as a
    capture records without running, its buffers are put back after."""
    step = next(g for _, g in graphs.entries()
                if g._warm and g._graph is None)
    saved = [(t, t.clone()) for t in _tensors(step.bufs)]
    yield
    for t, v in saved:
        t.copy_(v)


class FakeStream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def stub_cuda(monkeypatch):
    """torch.cuda's graph, stream and capture stubbed; the routing rule
    sends CPU calls without a mesh to the graph route."""
    FakeGraph.made = []
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", fake_capture)
    monkeypatch.setattr(torch.cuda, "Stream", FakeStream)
    monkeypatch.setattr(torch.cuda, "current_stream", FakeStream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(graphs, "use_graphs",
                        lambda device, mesh=None: mesh is None)
    graphs.clear()
    yield
    graphs.clear()


def test_routing_rule():
    assert graphs.use_graphs("cuda") is True
    assert graphs.use_graphs(torch.device("cuda", 0), None) is True
    assert graphs.use_graphs("cpu") is False
    assert graphs.use_graphs("cuda", mesh=object()) is False
    assert graphs.use_graphs("cpu", mesh=object()) is False


def test_the_loops_ask_the_routing_rule(monkeypatch):
    """Each loop asks ``use_graphs`` with its device and mesh, and a CPU
    call takes the eager route (nothing cached)."""
    asked = []
    real = graphs.use_graphs

    def spy(device, mesh=None):
        asked.append((torch.device(device).type, mesh))
        return real(device, mesh)

    monkeypatch.setattr(graphs, "use_graphs", spy)
    graphs.clear()
    cfg, params, logits, first, cache = ar_case("f32")
    TS._generate(params, cfg, logits, first, fresh(cache),
                 TC.make_generator(0, "cpu"), None, TAR.DEFAULT_SAMPLER)
    mesh = object()
    dcfg, dparams, sched, code, x, buckets, mask = diffusion_case(steps=2)
    TDS._denoise_loop(dparams, dcfg, sched, code, x, buckets, mask,
                      noise_source(x.shape, 0), None, True, mesh=mesh)
    assert asked == [("cpu", None), ("cpu", mesh)]
    assert graphs.entries() == []


def test_a_mesh_or_eager_keeps_the_eager_loop(stub_cuda):
    """With graphs on for the CPU (stubbed), ``mesh=`` and the private
    ``eager`` argument still run the eager loop."""
    cfg, params, sched, code, x, buckets, mask = diffusion_case(steps=2)
    for kw in ({"mesh": object()}, {"eager": True}):
        TDS._denoise_loop(params, cfg, sched, code, x, buckets, mask,
                          noise_source(x.shape, 0), None, True, **kw)
    assert graphs.entries() == [] and FakeGraph.made == []


def test_replays_add_the_captured_launch_counts(stub_cuda):
    """The warm-up counts as it runs; the capture's counts are taken back
    and every replay adds them, so the counters read the launches of
    every step, and ``launches`` holds one step's."""
    kernels.reset_launch_counts()
    A = kernels._wrappers()["decode_trunk"]
    B = kernels._wrappers()["flash_attention_packed"]

    def step(bufs):
        A.launches += 1
        B.launches += 13
        bufs["n"] += 1

    tree = object()
    g = graphs.cached(("k",), tree,
                      lambda: graphs.StepGraph({"n": torch.zeros(())}, step))
    for i in range(1, 6):
        g()
        counts = kernels.launch_counts()
        assert counts["decode_trunk"] == i
        assert counts["flash_attention_packed"] == 13 * i
        assert float(g.bufs["n"]) == i
    assert g.launches == {"decode_trunk": 1, "flash_attention_packed": 13}
    assert FakeGraph.made[0].replays == 4 and g.capture_s is not None
    kernels.reset_launch_counts()


def test_graph_cache_key_bound_and_drop(stub_cuda):
    made = []

    def build():
        g = graphs.StepGraph({}, lambda bufs: None)
        made.append(g)
        return g

    t1, t2 = object(), object()
    a = graphs.cached(("ar", 1), t1, build)
    assert graphs.cached(("ar", 1), t1, build) is a
    assert graphs.cached(("ar", 2), t1, build) is not a   # another key
    assert graphs.cached(("ar", 1), t2, build) is not a   # another tree
    assert len(made) == 3
    for i in range(graphs.MAX_GRAPHS):
        graphs.cached(("fill", i), t2, build)
    keys = [k for k, _ in graphs.entries()]
    assert len(keys) == graphs.MAX_GRAPHS      # the oldest three went
    assert ("ar", 1) not in keys and ("ar", 2) not in keys
    graphs.drop_tree(t2)
    assert all(g is not made[2] for _, g in graphs.entries())
    graphs.cached(("ar", 1), t1, build)
    graphs.drop_tree(t1)
    assert graphs.entries() == []


def test_lru_keeps_the_recent_entry(stub_cuda):
    tree = object()
    first = graphs.cached(("a",), tree, lambda: graphs.StepGraph({}, None))
    for i in range(graphs.MAX_GRAPHS - 1):
        graphs.cached(("b", i), tree, lambda: graphs.StepGraph({}, None))
        graphs.cached(("a",), tree, lambda: graphs.StepGraph({}, None))
    graphs.cached(("c",), tree, lambda: graphs.StepGraph({}, None))
    assert graphs.cached(("a",), tree, lambda: None) is first


def test_clear_cast_cache_drops_the_graphs(stub_cuda):
    """A graph reads its cast tree by address: clearing the cast cache,
    or evicting the tree from it, drops the tree's graphs."""
    host = [{"w": np.zeros(2, np.float32)} for _ in range(TC._CAST_CACHE_MAX
                                                        + 1)]
    TC.clear_cast_cache()
    trees = [TC.cached_cast(h, "graphs-test", lambda p: {"w": object()},
                            "cpu") for h in host[:2]]
    for i, t in enumerate(trees):
        graphs.cached(("g", i), t, lambda: graphs.StepGraph({}, None))
    TC.clear_cast_cache()
    assert graphs.entries() == []
    trees = [TC.cached_cast(h, "graphs-test", lambda p: {"w": object()},
                            "cpu") for h in host[:TC._CAST_CACHE_MAX]]
    graphs.cached(("first",), trees[0], lambda: graphs.StepGraph({}, None))
    graphs.cached(("last",), trees[-1], lambda: graphs.StepGraph({}, None))
    TC.cached_cast(host[-1], "graphs-test", lambda p: {"w": object()},
                   "cpu")                      # evicts trees[0]
    assert [k for k, _ in graphs.entries()] == [("last",)]
    TC.clear_cast_cache()


@pytest.mark.parametrize("plane", ["f32", "bf16_int8"])
def test_generate_graph_route_gives_the_eager_bits(stub_cuda, plane):
    """Three calls on one cached entry (new prompts and seeds, the
    static cache reloaded each time) against the eager loop."""
    for seed in (7, 8, 9):
        cfg, params, logits, first, cache = ar_case(plane, seed=seed)
        cfg_s = dataclasses.replace(cfg, max_decode_steps=12)
        want = TS._generate(params, cfg_s, logits, first, fresh(cache),
                            TC.make_generator(seed, "cpu"),
                            PLANES[plane][0], TAR.DEFAULT_SAMPLER,
                            eager=True)
        got = TS._generate(params, cfg_s, logits, first, fresh(cache),
                           TC.make_generator(seed, "cpu"),
                           PLANES[plane][0], TAR.DEFAULT_SAMPLER)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert len(graphs.entries()) == 1
    assert len(FakeGraph.made) == 1 and FakeGraph.made[0].replays > 0


def test_reference_plane_graph_route_gives_the_eager_tokens(stub_cuda,
                                                            monkeypatch):
    from tortoise_tpu_torch.rng import ReferenceRng

    cfg = tiny_ar_config()
    params = random_ar_params(cfg, 3)
    voice = np.random.default_rng(0).normal(0, .5, 64).astype(np.float32)
    runs = []
    for graphed in (False, True, True):
        monkeypatch.setattr(graphs, "use_graphs",
                            lambda device, mesh=None, g=graphed: g)
        runs.append(TS.autoregressive(params, [3, 9, 4, 12], voice, 2, cfg,
                                      "reference", rng=ReferenceRng(5),
                                      device="cpu"))
    for lat, padded in runs[1:]:
        assert padded == runs[0][1]
        for a, b in zip(lat, runs[0][0]):
            assert np.array_equal(a, b)
    assert len(graphs.entries()) == 1


def test_denoise_loop_graph_route_gives_the_eager_bits(stub_cuda):
    """Three calls on one cached entry (new x, code and mask each time)
    against the eager loop; progress fires at the same points."""
    for seed in (2, 3, 4):
        cfg, params, sched, code, x, buckets, mask = diffusion_case(
            seed=seed)
        seen = {True: [], False: []}
        out = {}
        for eager in (True, False):
            out[eager] = TDS._denoise_loop(
                params, cfg, sched, code, x, buckets, mask,
                noise_source(x.shape, seed), None, True,
                seen[eager].append, {2, 4}, eager=eager)
        assert torch.equal(out[False], out[True])
        assert seen[False] == seen[True] == [0.5, 1.0]
    assert len(graphs.entries()) == 1
