"""The counting functions against PERF.md's kernel table (its bound
column) and the model FLOPs' classes."""

import json
import os

import pytest

from benchmark import harness
from benchmark.counts import attention, kernel_a, model


def _config(name):
    with open(os.path.join(harness.HERE, "configs", name + ".json")) as f:
        return json.load(f)


def test_kernel_a_bytes_at_the_kernel_tables_shape():
    # PERF.md: A 467.6 MB at B = 1, text bucket 32 (a 640-slot cache read
    # whole), 0.140 ms
    ar = _config("tortoise-v2-int8")["ar"]
    b = kernel_a.bytes_per_call(ar, 1, 640)
    assert round(b / 1e6, 1) == 467.6
    assert kernel_a.bound_s(ar, [(1, 640)]) * 1e3 == pytest.approx(0.1396,
                                                                   abs=1e-4)


def test_kernel_a_calls_read_the_rows_written():
    ar = _config("tortoise-v2-int8")["ar"]
    calls = kernel_a.calls(ar, 30, 500)
    assert len(calls) == 499 and calls[0] == (1, 32) and calls[-1] == (1, 530)


def test_kernel_b_at_the_kernel_tables_shape():
    # PERF.md: B 38.8 GFLOP and 151.5 M exps at (2, 2176) x 16 x 64,
    # bound 0.039 ms; Bf 116.4 GFLOP of TF32x3, 0.2351 ms
    w = attention.work(2, 2176, 16, 64, 2)
    assert round(w["flops"] / 1e9, 1) == 38.8
    assert round(w["exps"] / 1e6, 1) == 151.5
    assert attention.bound_s(2, 2176, 16, 64, "bf16") * 1e3 == pytest.approx(
        0.0392, abs=1e-4)
    assert attention.bound_s(2, 2176, 16, 64, "f32") * 1e3 == pytest.approx(
        0.2351, abs=1e-4)


def test_kernel_b_calls_a_request():
    d = _config("tortoise-v2-int8")["diffusion"]
    calls = attention.calls(d, 500, 2176)
    assert len(calls) == 4 + 13 * 80 and calls[-1] == (2, 2176)


@pytest.mark.parametrize("name", ["tortoise-v2-int8", "tortoise-v2-f32"])
def test_model_flops_by_class(name):
    cfg = _config(name)
    f = model.request_flops(cfg, 144, 500, 500, 2176)
    assert set(f) == set(cfg["products"].values())
    total = sum(f.values())
    # the denoising loop dominates: 160 evals of ~0.78 TFLOP
    assert 120e12 < total < 135e12
    assert model.least_time_s(f) > 0
    if name.endswith("int8"):
        assert f["int8"] > f["bf16"]
