"""The port's SynthesisServer on a mesh (the counterpart of
``tests/test_serve.py::test_serve_on_mesh``): 4 gloo ranks on the CPU,
a (2, 2) mesh of the tiny models. Rank 0 runs the server and its queue;
ranks 1-3 run ``serve_follower`` and join each batch rank 0 broadcasts.
Four requests must form one batch of 4 rows whose audio equals the same
rows through ``synthesize_batch`` on the mesh (1e-5); a stream runs on
rank 0 alone; ``stop()`` releases the followers. The rank bodies are in
``tests/torch_mesh_ranks.py`` (no JAX there)."""

import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from tortoise_tpu.serve import SynthesisServer as JaxServer
from tortoise_tpu_torch.parallel.launch import run_ranks
from tortoise_tpu_torch.serve import SynthesisServer, serve_follower

torch.set_num_threads(1)  # see tests/test_torch_batch.py


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    rng = np.random.default_rng(4)
    inp = dict(voice=rng.normal(0, 0.5, (64,)).astype(np.float32),
               tokens=[rng.integers(1, 32, 5).tolist() + [0]
                       for _ in range(4)])
    out = run_ranks(ranks.serve_22, 4, (inp,),
                    workdir=str(tmp_path_factory.mktemp("serve22")),
                    timeout=110.0)
    return inp, out


def test_serve_on_mesh(served):
    """4 requests on a (2, 2) mesh resolve in one batch of 4 rows through
    the mesh's synthesize_batch: the followers joined it."""
    _, out = served
    st = out[0]["stats"]
    assert st["batches"] == 1 and st["rows"] == 4 and st["padded_rows"] == 0
    assert all(len(a) > 0 for a in out[0]["server_audio"])
    # the followers joined that batch, then the synthesize_batch below
    assert [o["joined"] for o in out[1:]] == [1, 1, 1]


def test_serve_on_mesh_audio_equals_synthesize_batch(served):
    _, out = served
    assert out[0]["server_sequences"] == out[0]["batch_sequences"]
    for got, want in zip(out[0]["server_audio"], out[0]["batch_audio"]):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-5
    # every rank returns every row
    for o in out[1:]:
        for got, want in zip(o["batch_audio"], out[0]["batch_audio"]):
            np.testing.assert_array_equal(got, want)


def test_serve_on_mesh_streams_on_rank_0(served):
    _, out = served
    assert out[0]["stream_chunks"] >= 1 and out[0]["stream_samples"] > 0


def test_serve_on_mesh_roles(served):
    """Only rank 0 may run the server; a stopped mesh server cannot start
    again (its followers have returned); the ranks import no JAX."""
    _, out = served
    assert all("rank 0" in o["not_rank0"] for o in out[1:])
    assert "starts once" in out[0]["restart"]
    assert [o["jaxy"] for o in out] == [[]] * 4


def test_server_takes_mesh_like_the_jax_server():
    import inspect

    assert "mesh" in inspect.signature(JaxServer).parameters
    assert "mesh" in inspect.signature(SynthesisServer).parameters
    assert list(inspect.signature(serve_follower).parameters)[:2] == \
        ["models", "mesh"]
