"""The readers of the program's own spans (``benchmark/program_spans.py``
and the five metrics on it) on a synthetic recorder: device time a step
or a second of audio, the host's gaps between leaf spans, the share of
replayed graph steps, the window's bounds, and nothing read from a
program without the recorder."""

import types

import pytest

from benchmark import harness, program_spans
from tortoise_tpu_torch.utils import profiling

S = 1_000_000_000  # ns a second


def _span(sid, name, parent, t0, t1, dev=None, **counters):
    return types.SimpleNamespace(id=sid, name=name, parent=parent,
                                 t0=int(t0 * S), t1=int(t1 * S), dev=dev,
                                 counters=counters)


def _request(base, t0, scale=1.0):
    """A request at host time t0: the device interval 0-10 ms (x scale);
    leaves at 1-3 (cast), 3-4 (prefill), 4.5-6.5 (loop, 100 steps, a
    graph.capture inside it), 7-9 (diffusion loop, 2 steps), 9-9.5
    (vocoder, 0.25 s of audio); gaps 0-1, 4-4.5, 6.5-7, 9.5-10: 2.5 of 10
    ms."""
    ms = 1e-3 * scale

    def d(a, b):
        return (a * ms, b * ms)

    r = base
    return [
        _span(r + 1, "ar.cast", r + 9, t0 + .1, t0 + .2, d(1, 3)),
        _span(r + 2, "ar.prefill", r + 9, t0 + .2, t0 + .3, d(3, 4)),
        _span(r + 3, "graph.capture", r + 4, t0 + .3, t0 + .35, d(5, 6)),
        _span(r + 4, "ar.decode_loop", r + 9, t0 + .3, t0 + .5, d(4.5, 6.5),
              steps=100, graph_warmups=0, graph_captures=1,
              graph_replays=99),
        _span(r + 9, "ar", r + 10, t0 + .1, t0 + .5),
        _span(r + 5, "diffusion.denoise_loop", r + 10, t0 + .5, t0 + .7,
              d(7, 9), steps=2, graph_warmups=0, graph_captures=0,
              graph_replays=2),
        _span(r + 6, "vocoder.forward", r + 10, t0 + .7, t0 + .8,
              d(9, 9.5), audio_s=0.25),
        _span(r + 10, "synthesize", None, t0, t0 + .9, d(0, 10)),
    ]


@pytest.fixture
def recorded(monkeypatch):
    spans = (_request(0, 10.0) + _request(100, 11.0, scale=2.0)
             + _request(200, 30.0))        # after the window closed
    monkeypatch.setattr(profiling, "records", lambda: spans)
    return harness.Run(cell={}, config={}, mix={}, seed=0, device=None,
                       opened=9.5, closed=20.0)


def _read(name, run):
    return harness.metric(name).read(run)


def test_requests_inside_the_window(recorded):
    reqs = program_spans.requests(recorded)
    assert [r.id for r, _ in reqs] == [10, 110]
    assert sorted(s.name for s in reqs[0][1]) == sorted(
        ["ar.cast", "ar.prefill", "graph.capture", "ar.decode_loop", "ar",
         "diffusion.denoise_loop", "vocoder.forward"])


def test_device_time_a_step_and_a_second(recorded):
    # 2 ms + 4 ms over 200 steps; 2 ms + 4 ms over 4 steps;
    # 0.5 ms + 1 ms over 0.5 s of audio
    assert _read("ar_device_ms_per_step.single", recorded) \
        == pytest.approx(6.0 / 200)
    assert _read("diffusion_device_ms_per_step.single", recorded) \
        == pytest.approx(6.0 / 4)
    assert _read("vocoder_device_ms_per_s.single", recorded) \
        == pytest.approx(1.5 / 0.5)


def test_host_gaps_and_graph_replays(recorded):
    assert _read("host_gap_pct.single", recorded) == pytest.approx(25.0)
    # 99 + 2 replays of 1 + 99 + 2 steps, in each of two requests
    assert _read("graph_replay_pct.single", recorded) \
        == pytest.approx(100.0 * 101 / 102)


def test_leaves_past_the_request_are_clipped(monkeypatch):
    spans = _request(0, 10.0)
    spans[0].dev = (-2e-3, 3e-3)                  # starts before the request
    monkeypatch.setattr(profiling, "records", lambda: spans)
    run = harness.Run(cell={}, config={}, mix={}, seed=0, device=None,
                      opened=0.0, closed=20.0)
    assert program_spans.host_gap_pct(run) == pytest.approx(15.0)


@pytest.mark.parametrize("name", [
    "ar_device_ms_per_step.single", "diffusion_device_ms_per_step.single",
    "vocoder_device_ms_per_s.single", "host_gap_pct.single",
    "graph_replay_pct.single"])
def test_nothing_to_read(monkeypatch, name):
    """A program without the recorder, an empty window, and spans without
    a device interval or graph steps (the CPU's) give None."""
    run = harness.Run(cell={}, config={}, mix={}, seed=0, device=None,
                      opened=0.0, closed=20.0)
    monkeypatch.delattr(profiling, "records")
    assert _read(name, run) is None
    monkeypatch.setattr(profiling, "records", lambda: [], raising=False)
    assert _read(name, run) is None
    spans = _request(0, 10.0)
    for s in spans:
        s.dev = None
        for k in program_spans.GRAPH_COUNTERS:
            s.counters.pop(k, None)
    monkeypatch.setattr(profiling, "records", lambda: spans)
    assert _read(name, run) is None
