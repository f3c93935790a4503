"""The one traffic generator: seeded, deterministic, and the same set of
sizes, arrivals and sampler settings for every seed."""

import pytest

from benchmark import harness, traffic

CELLS = [w["name"] for w in harness.load_spec()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_plan(cell):
    mix = harness.mix_of(harness.cell(harness.load_spec(), cell))
    a = traffic.make_plan(mix, 2 ** 31 + 17, 1024)
    b = traffic.make_plan(mix, 2 ** 31 + 17, 1024)
    c = traffic.make_plan(mix, 5, 1024)
    assert [(r.tokens, r.voice, r.seed, r.greedy, r.due)
            for r in a.requests] == [(r.tokens, r.voice, r.seed, r.greedy,
                                      r.due) for r in b.requests]
    assert (a.voices == b.voices).all()
    assert [r.tokens for r in a.requests] != [r.tokens for r in c.requests]


@pytest.mark.parametrize("cell", CELLS)
def test_every_seed_the_same_sizes(cell):
    mix = harness.mix_of(harness.cell(harness.load_spec(), cell))
    k = mix["text"]["sizes"]
    plans = [traffic.make_plan(mix, s, 1024) for s in (1, 2, 3 ** 20)]
    for p in plans:
        reqs = p.requests
        assert len(reqs) == mix["plan"]
        for i in range(0, len(reqs) - k + 1, k):
            block = sorted(len(r.tokens) for r in reqs[i:i + k])
            assert block == sorted(traffic.lengths(mix))
        assert all(mix["text"]["min_len"] <= len(r.tokens)
                   <= mix["text"]["max_len"] for r in reqs)
        assert all(r.tokens[0] == mix["text"]["wrap"][0]
                   and r.tokens[-1] == mix["text"]["wrap"][1] for r in reqs)
        assert all(0 <= r.seed < 2 ** 31 for r in reqs)
    greedy = [[r.greedy for r in p.requests] for p in plans]
    assert greedy[0] == greedy[1] == greedy[2]
    if "bursts" in mix:
        sizes = mix["bursts"]["sizes"]
        for p in plans:
            due = [r.due for r in p.requests]
            counts = [due.count(k * mix["bursts"]["every_s"])
                      for k in range(len(sizes))]
            assert sorted(counts) == sorted(sizes)
    if "arrivals" in mix:
        a = mix["arrivals"]["sizes"]
        for p in plans:
            gaps = [y.due - x.due for x, y in zip(p.requests, p.requests[1:])]
            assert sorted(gaps[:a]) == pytest.approx(sorted(traffic.gaps(mix)))


@pytest.mark.parametrize("every,want", [(None, []), (1, list(range(8))),
                                        (4, [1, 5])])
def test_greedy_every(every, want):
    mix = harness.mix_of(harness.cell(harness.load_spec(), "int8-single"))
    mix["greedy_every"] = every
    plan = traffic.make_plan(mix, 3, 16)
    assert [r.index for r in plan.requests[:8] if r.greedy] == want


def test_lengths_cover_the_buckets():
    mix = harness.mix_of(harness.cell(harness.load_spec(), "int8-single"))
    from tortoise_tpu_torch.pipeline.ar_stage import pick_bucket

    assert {pick_bucket(n) for n in traffic.lengths(mix)} == {
        64, 128, 192, 256}


@pytest.mark.parametrize("key,params", [
    ("arrivals", {"rate": 0.36, "sizes": 8}),
    ("bursts", {"every_s": 15.0, "sizes": [8]})])
def test_open_loop_plans(key, params):
    """A later open-loop mix (Poisson arrivals or bursts) gets every seed
    the same gaps or burst sizes, in a seeded order."""
    mix = harness.mix_of(harness.cell(harness.load_spec(), "int8-single"))
    mix[key] = params
    plans = [traffic.make_plan(mix, s, 16) for s in (1, 2 ** 31 + 5)]
    for p in plans:
        due = [r.due for r in p.requests]
        assert due[0] == 0.0 and due == sorted(due)
        if key == "arrivals":
            gaps = [b - a for a, b in zip(due, due[1:])]
            assert sorted(gaps[:8]) == pytest.approx(sorted(traffic.gaps(mix)))
        else:
            assert due[:8] == [0.0] * 8 and due[8] == 15.0
    assert [r.due for r in plans[0].requests] != [
        r.due for r in plans[1].requests] or key == "bursts"
