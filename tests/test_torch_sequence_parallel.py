"""The port's sequence-parallel state and its Predictor over a mesh on the
CPU.

Four gloo ranks in subprocesses (tests/_torch_sp_worker.py, 120 s
limit) over a (4, 1) and a (2, 2) mesh: the hierarchical state with the
chunk axis split over 4 and over 2 data indices against the JAX
`build_sequence_parallel_state_fn` on 4 and 2 virtual CPU devices
(tests/test_parallel.py's bar: rtol 1e-5, atol 1e-6), and the
data-parallel (float32, int8) and sequence-parallel (student, teacher)
Predictors against the JAX Predictors over the same meshes
(tests/test_serving.py's bar, rtol 1e-5 and atol 1e-6) and against the
one-process Predictor of the port."""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_sp_worker as worker
from efficientvideoclassification_youtube8m_tpu import parallel as jparallel
from efficientvideoclassification_youtube8m_tpu import train as jtrain
from efficientvideoclassification_youtube8m_tpu.serving import Predictor as JaxPredictor
from efficientvideoclassification_youtube8m_torch.parallel import mesh as tmesh
from efficientvideoclassification_youtube8m_torch.parallel.sequence_parallel import (
    build_sequence_parallel_state_fn,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6
CFG = worker.CFG


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("sp_ranks")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "_torch_sp_worker.py"), str(out_dir)],
        env=dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                 RANK=str(rank), WORLD_SIZE=str(worker.WORLD),
                 PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", "")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO)
        for rank in range(worker.WORLD)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=120)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a sequence-parallel worker timed out (a deadlock?)")
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"WORKER_OK {rank}" in out, out[-4000:]
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(worker.WORLD)]


@pytest.fixture(scope="module")
def jax_params():
    jo = jtrain.make_optimizer(CFG.optimizer, CFG.clip_gradient_norm)
    state = jtrain.init_distill_state(CFG, jo)
    return {"teacher": state.params_teacher, "student": state.params_student}


def _jax_mesh(data):
    return jparallel.create_mesh(data=data, devices=jax.devices()[:data])


@pytest.mark.parametrize("data", [2, 4])
def test_state_matches_jax_sequence_parallel(ranks, jax_params, data):
    x, nf = worker.state_inputs()
    fn = jparallel.build_sequence_parallel_state_fn(CFG, _jax_mesh(data))
    want = np.asarray(fn(jax_params["teacher"]["rnn_l1"], jax_params["teacher"]["rnn_l2"],
                         jnp.asarray(x.numpy()), jnp.asarray(nf.numpy())))
    for got in ranks:
        np.testing.assert_allclose(got[f"state/{data}"], want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("key,tower,data,kwargs", [
    ("dp/4", "student", 4, {}),
    ("dp/2", "student", 2, {}),
    ("dp_int8/4", "student", 4, {"quantize": "int8"}),
    ("sp_student/2", "student", 2, {"sequence_parallel": True}),
    ("sp_teacher/2", "teacher", 2, {"sequence_parallel": True}),
    ("sp_teacher/4", "teacher", 4, {"sequence_parallel": True}),
])
def test_mesh_predictor_matches_jax(ranks, jax_params, key, tower, data, kwargs):
    """Every rank returns the whole request, as the JAX Predictor over the
    same mesh and the port's one-process Predictor do."""
    feats, nf = worker.request()
    want = JaxPredictor(CFG, jax_params[tower], tower, serve_batch=worker.SERVE_BATCH,
                        mesh=_jax_mesh(data), **kwargs).predict(feats, nf)
    one = "one/int8" if kwargs.get("quantize") else f"one/{tower}"
    for got in ranks:
        assert got[key].shape == (worker.REQUEST_ROWS, CFG.num_classes)
        np.testing.assert_allclose(got[key], want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got[key], got[one], rtol=RTOL, atol=ATOL)


def test_chunks_must_split_over_the_data_axis(ranks):
    """The student's 2 chunks do not split over 4 data indices: ValueError,
    on every rank, as the JAX Predictor raises it."""
    assert all(bool(got["refused"]) for got in ranks)
    with pytest.raises(ValueError):
        JaxPredictor(CFG, {}, mesh=_jax_mesh(4), sequence_parallel=True)
    mesh = tmesh.Mesh(group=None, rank=0, world_size=4, device=torch.device("cpu"), data=4)
    with pytest.raises(ValueError, match="not divisible by data axis 4"):
        build_sequence_parallel_state_fn(CFG, mesh, num_chunks=2)


def test_one_process_sequence_parallel_is_the_forward():
    """Without a group the sequence-parallel state is the model's own."""
    from efficientvideoclassification_youtube8m_torch.train.state import init_model

    model = init_model(CFG)
    x, nf = worker.state_inputs()
    fn = build_sequence_parallel_state_fn(CFG, tmesh.create_mesh(device="cpu"))
    with torch.no_grad():
        want = model(x, nf, num_chunks=CFG.num_inputs_to_lstm)["state"]
    np.testing.assert_array_equal(fn(model.rnn_l1, model.rnn_l2, x, nf).numpy(),
                                  want.numpy())
