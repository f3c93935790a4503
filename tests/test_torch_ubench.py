"""The port's per-layer microbenchmarks (``scripts/torch_ubench_*.py``)
on the CPU, and the parts of them that must match the JAX scripts or the
JAX package.

- Each script runs with ``--device cpu --small`` to its JSON line (the
  plain versions, tiny configs; no kernel launches), and raises without
  a card unless given ``--device cpu``.
- The load test's request plan against ``scripts/ubench_serve.py``'s
  draw order, replayed here with numpy: equal tokens and delays.
- The group-norm variants of ``torch_ubench_gn.py`` on the tiny f32
  denoiser (the port's ``group_norm_act`` with the variant's norm) against
  the JAX ``denoise`` with its ``group_norm_tc`` patched to the same
  norm, at 1e-4 of max |out|.
- The four int8-matmul variants at a cut M against the JAX package's
  ``pdot`` / ``pdot_int8act``: within one bf16 ulp, and the int32 sums
  of ``torch._int_mm`` exact.
- The decode script's byte counts against the JAX script's formulas on
  the tiny config, on both planes.
- The diffusion stage split's loop output against
  ``diffusion_batch_device``'s mel for the same seed: equal.
- The loop A/B fields of the decode and diffstage scripts (eager against
  a step graph, in turns): on the CPU the eager loop alone, one turn,
  no busy time, and every turn's tokens or mel equal.

The scripts are loaded by path, read-only; the JAX package is called
on the CPU.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
sys.path.insert(0, SCRIPTS)

torch.set_num_threads(1)  # the tier-1 run's workers share the cores

# (script, its JSON key, argv for the tiny CPU run)
RUNS = [
    ("serve", "serve", ["4", "50", "2", "20"]),
    ("diffstage", "diffstage", []),
    ("gn", "gn", ["32", "2"]),
    ("int8_matmul", "int8_matmul", []),
    ("decode", "decode", ["4", "--sampler"]),
    ("prefill", "prefill", ["1,2"]),
    ("diffusion", "diffusion", ["32"]),
    ("vocoder", "vocoder", ["32"]),
    ("vocstage", "vocstage", []),
    ("sampler_ops", "sampler_ops", []),
]


def load(name):
    path = os.path.join(SCRIPTS, f"torch_ubench_{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_ubench_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,key,argv", RUNS, ids=[r[0] for r in RUNS])
def test_script_runs_on_the_cpu(name, key, argv, monkeypatch, tmp_path,
                                capsys):
    """``--device cpu --small`` to the JSON line: the script's own key,
    the CPU named, no kernel launched."""
    monkeypatch.setenv("BENCH_WEIGHTS_CACHE", str(tmp_path / "weights"))
    result = load(name).main(argv + ["--device", "cpu", "--small"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == json.dumps({key: result})
    assert result["device"] == "cpu" and result["card"] == "cpu (no card)"
    assert result["small"] is True
    assert set(result["launches"].values()) == {0}


def test_serve_warm_check_on_the_cpu(monkeypatch, tmp_path, capsys):
    """--warm-check: the warmup and two batches of max_batch rows, timed,
    and no load test."""
    monkeypatch.setenv("BENCH_WEIGHTS_CACHE", str(tmp_path / "weights"))
    result = load("serve").main(["1", "2.0", "2", "--warm-check",
                                 "--device", "cpu", "--small"])
    assert result["batches"] == 2 and result["max_batch"] == 2
    assert result["batch_1_s"] > 0 and result["batch_2_s"] > 0
    assert "p50_s" not in result
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == {"serve": result}


@pytest.mark.parametrize("name", [r[0] for r in RUNS])
def test_script_needs_a_card(name, monkeypatch):
    """Without ``--device cpu`` a script runs on the card, and raises
    where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        load(name).main([])


def test_request_plan_follows_the_jax_draw_order():
    """request_plan(32, 2.0, ...) draws what scripts/ubench_serve.py
    draws from its default_rng(0): the voice, then each request's tokens
    (length first), then the arrival gaps."""
    from tortoise_tpu.config import ARConfig

    cfg = ARConfig()
    voice, tokens, delays = load("serve").request_plan(
        32, 2.0, cfg.n_text_vocab, cfg.d_model, 0)
    rng = np.random.default_rng(0)
    want_voice = rng.normal(0, 0.5, (cfg.d_model,)).astype(np.float32)
    start_tok = min(255, cfg.n_text_vocab - 1)

    def toks():
        return [start_tok] + rng.integers(
            3, cfg.n_text_vocab, size=int(rng.integers(16, 30))).tolist() \
            + [0]

    want_tokens = [toks() for _ in range(32)]
    want_delays = np.cumsum(rng.exponential(1.0 / 2.0, 32))
    np.testing.assert_array_equal(voice, want_voice)
    assert tokens == want_tokens
    np.testing.assert_array_equal(delays, want_delays)


@pytest.fixture(scope="module")
def tiny_denoiser():
    from tortoise_tpu.config import tiny_diffusion_config
    from tortoise_tpu.io.checkpoint import random_diffusion_params

    cfg = tiny_diffusion_config()
    return cfg, random_diffusion_params(cfg, seed=0)


@pytest.mark.parametrize("variant", ["base", "gn-affine", "gn-skip"])
def test_gn_variants_against_jax(tiny_denoiser, variant):
    """Each variant of torch_ubench_gn.py on the tiny f32 denoiser (the
    port's group_norm_act with the variant's norm) equals the JAX denoise
    with the JAX module's group_norm_tc patched by the same function, at
    1e-4 of max |out|; both names are restored."""
    import tortoise_tpu.models.diffusion as JDM
    import tortoise_tpu_torch.models.diffusion as TDM
    from tortoise_tpu.ops.relpos import relative_position_buckets
    from tortoise_tpu_torch.params import tree_to_torch

    gn = load("gn")
    cfg, params = tiny_denoiser
    t = 48
    x, code = gn.inputs(cfg, t, "cpu")
    bk = relative_position_buckets(t, cfg.rel_pos_buckets,
                                   cfg.rel_pos_max_distance)
    fn = gn.VARIANTS[variant]
    real = (TDM.group_norm_act, JDM.group_norm_tc)
    with gn.patched(TDM, gn.as_op(fn)), \
            gn.patched(JDM, fn, "group_norm_tc"):
        got = TDM.denoise(tree_to_torch(params), cfg, x, code, 1234,
                          torch.as_tensor(bk)).numpy()
        want = np.asarray(JDM.denoise(
            params, cfg, jnp.asarray(x.numpy()), jnp.asarray(code.numpy()),
            1234, jnp.asarray(bk)), np.float32)
    assert (TDM.group_norm_act, JDM.group_norm_tc) == real
    assert np.isfinite(want).all()
    err = np.abs(got - want).max()
    assert err <= 1e-4 * np.abs(want).max(), (variant, err)


def _bf16_ulp(v):
    """One bf16 ulp at |v| (8 significant bits)."""
    a = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(a)) - 7)


def test_int8_matmul_variants_against_jax():
    """At M = 64 on the small shapes, each variant agrees with the JAX
    package's product within one bf16 ulp: bf16 and int8w with pdot,
    int8 full and int8 preq with pdot_int8act cast to bf16; the int32
    sums of "int8 mm" (torch._int_mm alone) are exact."""
    from tortoise_tpu.ops import basic as J

    im = load("int8_matmul")
    rng = np.random.default_rng(0)
    fns = im.variants()
    bf = jnp.bfloat16
    for k, n in im.SMALL_SHAPES:
        ops = im.operands(im.SMALL_M, k, n, rng, "cpu")
        x, w, wq, wq_cm, scale, xq, s_row = ops
        xj = jnp.asarray(x.float().numpy(), bf)
        wj = jnp.asarray(w.float().numpy(), bf)
        pair = (jnp.asarray(wq.numpy()), jnp.asarray(scale.numpy()))
        want = {"bf16": J.pdot(xj, wj, bf, bf),
                "int8w": J.pdot(xj, pair, bf, bf)}
        want["int8 full"] = want["int8 preq"] = \
            J.pdot_int8act(xj, pair).astype(bf)
        acc = fns["int8 mm"](*ops).numpy()
        np.testing.assert_array_equal(
            acc, xq.numpy().astype(np.int64) @ wq.numpy().astype(np.int64))
        for name, fn in fns.items():
            if name == "int8 mm":
                continue
            got = fn(*ops).float().numpy()
            ref = np.asarray(want[name], np.float32)
            gap = np.abs(got - ref)
            ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(ref)))
            assert (gap <= ulp).all(), (name, k, n, gap.max())


@pytest.mark.parametrize("int8", [True, False], ids=["int8", "bf16"])
def test_decode_byte_counts_match_the_jax_formulas(int8):
    """byte_counts on the port's cast tree and primed cache equals the
    JAX script's nbytes / wb / cb on the JAX package's, tiny config."""
    from tortoise_tpu.config import tiny_ar_config
    from tortoise_tpu.io.checkpoint import random_ar_params
    from tortoise_tpu.models import ar as JAR
    from tortoise_tpu.pipeline import ar_stage as JS
    from tortoise_tpu_torch.models import ar as TAR
    from tortoise_tpu_torch.pipeline import ar_stage as TS

    dec = load("decode")
    cfg = TS.size_cache(tiny_ar_config(), dec.TEXT_BUCKET)
    host = random_ar_params(cfg, seed=0)
    tparams = TS.cast_matmul_weights(host, torch.bfloat16, int8=int8,
                                     device="cpu")
    prompt = dec._prompt(cfg, 2, np.random.default_rng(0), "cpu")
    _, cache = TAR.prefill(tparams, cfg, *prompt, torch.bfloat16)
    got = dec.byte_counts(tparams, cache)

    jparams = JS.cast_matmul_weights(host, jnp.bfloat16, int8=int8)
    _, jcache = JAR.prefill(jparams, cfg, *(jnp.asarray(a.numpy())
                                            for a in prompt), jnp.bfloat16)

    def nb(tree):
        return sum(int(np.prod(v.shape)) * v.dtype.itemsize
                   for v in jax.tree.leaves(tree))

    want = {"nbytes": nb(jparams),
            "wb": sum(nb(jparams["blocks"][k])
                      for k in ("attn_w", "proj_w", "fc_w", "fc_proj_w")),
            "cb": int(np.prod(jcache.k.shape) + np.prod(jcache.v.shape)) * 2}
    assert got == want


def test_diffstage_loop_matches_the_stage():
    """The stage split's code embedding, noise and loop give
    diffusion_batch_device's mel for the same seed, bit for bit (tiny
    config, bf16 + int8, 4 steps)."""
    import dataclasses

    from tortoise_tpu_torch.config import tiny_diffusion_config
    from tortoise_tpu_torch.io.checkpoint import random_diffusion_params
    from tortoise_tpu_torch.pipeline import diffusion_stage as DS

    ds = load("diffstage")
    cfg = dataclasses.replace(tiny_diffusion_config(), n_sample_timesteps=4)
    params = random_diffusion_params(cfg, seed=1)
    lat = np.random.default_rng(0).normal(0, 0.5, (40, cfg.d_model)) \
        .astype(np.float32)
    dev = torch.device("cpu")
    stage = ds.Stage(params, cfg, lat, dev)
    with torch.inference_mode():
        _, got = ds.one_run(stage, 3)
    want, out_lens = DS.diffusion_batch_device(
        params, torch.as_tensor(lat[None]), [40], cfg, seed=3,
        compute_dtype=torch.bfloat16, int8_weights=True, device="cpu")
    assert got.shape == tuple(want.shape)
    np.testing.assert_array_equal(got, want.float().numpy())


def test_prefill_crossover():
    """The smallest score from which flash wins at every larger one;
    None when it loses at the largest."""
    cross = load("prefill").crossover
    assert cross([(5, 3.0, 2.0), (10, 1.0, 2.0), (100, 1.0, 2.0)]) == 10
    assert cross([(5, 1.0, 2.0), (10, 3.0, 2.0), (100, 1.0, 2.0)]) == 100
    assert cross([(5, 1.0, 2.0), (100, 3.0, 2.0)]) is None


@pytest.mark.parametrize("name,argv", [("decode", ["4"]), ("diffstage", [])])
def test_loop_ab_fields_on_the_cpu(name, argv, capsys):
    """``loop``: turns eager, graph, graph, eager on a card; on the CPU
    only the eager loop exists, so one eager turn and no graph entry."""
    mod = load(name)
    assert mod.LOOP_TURNS == (True, False, False, True)
    result = mod.main(argv + ["--device", "cpu", "--small"])
    if name == "decode":
        loops = [result[p][b]["loop"] for p in ("int8", "bf16")
                 for b in result[p]]
        same = "same_tokens"
    else:
        loops, same = [result["loop"]], "same_mel"
    assert loops
    for lp in loops:
        assert lp["graph"] is None and lp[same] is True
        eager = lp["eager"]
        assert len(eager["turns"]) == 1 and eager["turns"][0][1] is None
        assert eager["ms_per_step"] > 0 and eager["busy_ms_per_step"] is None
        assert eager["launches_per_step"] == {}
