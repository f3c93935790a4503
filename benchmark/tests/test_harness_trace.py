"""The traced run's reduction (busy time as the union of device events,
the harness's spans kept off the device timeline, idle gaps labelled by
the span the host was in) and a traced run's line at tiny sizes."""

import time
import types

import torch
from torch.autograd import DeviceType

import benchmark.run as R
from benchmark import trace


class _Event:
    def __init__(self, name, start_us, dur_us, device):
        self._n, self._s, self._d = name, start_us * 1000, dur_us * 1000
        self._dev = DeviceType.CUDA if device else DeviceType.CPU

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev


def _prof(events):
    res = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=res))


def test_reduce_unions_device_time_and_labels_gaps():
    ev = [_Event("bench.window", 0, 100, False),
          _Event("bench.window", 0, 100, True),      # the span's mirror
          _Event("bench.synthesize", 10, 60, False),
          _Event("kernel_x", 10, 20, True),
          _Event("kernel_y", 20, 20, True),          # overlaps kernel_x
          _Event("kernel_x", 50, 10, True),
          _Event("kernel_x", 95, 10, True)]          # clipped at 100
    t = trace.reduce(_prof(ev))
    assert t.window_s == 100e-6
    assert abs(t.busy_s - 45e-6) < 1e-12
    s, n = t.kernel_s("kernel_x")
    assert abs(s - 35e-6) < 1e-12 and n == 3
    assert [name for name, _ in t.device_ops()] == ["kernel_x", "kernel_y"]
    labels = [g[0] for g in t.idle_gaps]
    assert labels[0].startswith("harness")              # 60-95, no span
    assert any(lb.startswith("synthesize") for lb in labels)
    assert abs(sum(g[1] for g in t.idle_gaps) - 55e-6) < 1e-12


def test_a_traced_run_reports_per_layer_metrics(tiny_cell):
    spec, c, config, mix = tiny_cell("int8-single")
    out = R.run_cell(spec, c, 99, 1.0, True, torch.device("cpu"),
                     time.monotonic(), config=config, mix=mix)
    names = {m["name"] for m in spec["per_layer"]}
    assert set(out["metrics"]) <= names
    assert {"ar_ms_per_step.single", "diffusion_ms_per_step.single",
            "mfu_pct.single"} <= set(out["metrics"])
    assert "window_s" in out["device"] and "breakdown" in out
    assert list(out)[-1] == "check"
