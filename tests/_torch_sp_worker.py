"""One rank of the four-rank gloo run of
tests/test_torch_sequence_parallel.py.

    MASTER_ADDR=localhost MASTER_PORT=<port> RANK=<r> WORLD_SIZE=4 \
        python tests/_torch_sp_worker.py <out_dir>

On the CPU at tiny widths, over two meshes of the same four ranks: the
(4, 1) mesh and the (2, 2) mesh, whose data groups are ranks {0, 2} and
{1, 3}. The sequence-parallel hierarchical state at 4 and at 2 data
indices; the data-parallel Predictor (float32 and int8) and the
sequence-parallel Predictor (student and teacher) beside the one-process
Predictor on the same request; the refusal of a chunk count the data
axis does not divide. Writes <out_dir>/rank<r>.npz.
"""

import datetime
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from efficientvideoclassification_youtube8m_torch.parallel import distributed  # noqa: E402
from efficientvideoclassification_youtube8m_torch.parallel.mesh import create_mesh  # noqa: E402
from efficientvideoclassification_youtube8m_torch.parallel.sequence_parallel import (  # noqa: E402
    build_sequence_parallel_state_fn,
)
from efficientvideoclassification_youtube8m_torch.serving import Predictor  # noqa: E402
from efficientvideoclassification_youtube8m_torch.train.optimizer import (  # noqa: E402
    make_optimizer,
)
from efficientvideoclassification_youtube8m_torch.train.state import (  # noqa: E402
    init_distill_state,
)
from efficientvideoclassification_youtube8m_torch.utils.config import (  # noqa: E402
    TrainConfig,
)

WORLD = 4
# tests/test_serving.py's config (teacher: 4 chunks, student: 2), float32
CFG = TrainConfig(
    num_classes=30, batch_size=4, lstm_cells=8, lstm_layers=2,
    max_num_frames=40, num_inputs_to_lstm=4, num_inputs_L1=2, every_n=2,
    feature_names="rgb, audio", feature_sizes="6, 2", scan_unroll=1,
    compute_dtype="float32",
)
SERVE_BATCH = 8
REQUEST_ROWS = 11  # two chunks, the second padded


def state_inputs():
    """tests/test_parallel.py's sequence-parallel inputs: normal frames
    and frame counts that end in every chunk, and none."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, CFG.max_num_frames, CFG.total_feature_size))
    return (torch.from_numpy(x.astype(np.float32)),
            torch.tensor([40, 23, 7, 1], dtype=torch.int32))


def request():
    rng = np.random.default_rng(6)
    feats = rng.integers(0, 256, size=(REQUEST_ROWS, CFG.max_num_frames,
                                       CFG.total_feature_size), dtype=np.uint8)
    nf = rng.integers(0, CFG.max_num_frames + 1, size=REQUEST_ROWS).astype(np.int32)
    return feats, nf


def towers():
    """The seed-0 towers (the JAX package's init)."""
    opt = make_optimizer(CFG.optimizer, CFG.clip_gradient_norm)
    state = init_distill_state(CFG, opt)
    return {"teacher": state.teacher.eval(), "student": state.student.eval()}


def main():
    out_dir = sys.argv[1]
    torch.set_num_threads(1)
    distributed.initialize(device="cpu", timeout=datetime.timedelta(seconds=90))
    rank = distributed.rank()
    meshes = {4: create_mesh(device="cpu"), 2: create_mesh(model=2, device="cpu")}
    model = towers()
    out = {}
    x, nf = state_inputs()
    for data, mesh in meshes.items():
        fn = build_sequence_parallel_state_fn(CFG, mesh)
        out[f"state/{data}"] = fn(model["teacher"].rnn_l1, model["teacher"].rnn_l2,
                                  x, nf).numpy()
    feats, frames = request()
    kw = dict(serve_batch=SERVE_BATCH, device="cpu")
    for tower in ("student", "teacher"):
        out[f"one/{tower}"] = Predictor(CFG, model[tower], tower, **kw).predict(feats, frames)
    out["one/int8"] = Predictor(CFG, model["student"], quantize="int8", **kw).predict(
        feats, frames)
    for data, mesh in meshes.items():
        out[f"dp/{data}"] = Predictor(CFG, model["student"], mesh=mesh, **kw).predict(
            feats, frames)
        out[f"sp_teacher/{data}"] = Predictor(CFG, model["teacher"], "teacher", mesh=mesh,
                                              sequence_parallel=True, **kw).predict(feats, frames)
    out["dp_int8/4"] = Predictor(CFG, model["student"], mesh=meshes[4], quantize="int8",
                                 **kw).predict(feats, frames)
    out["sp_student/2"] = Predictor(CFG, model["student"], mesh=meshes[2],
                                    sequence_parallel=True, **kw).predict(feats, frames)
    try:  # the student's 2 chunks over 4 data indices
        Predictor(CFG, model["student"], mesh=meshes[4], sequence_parallel=True, **kw)
        out["refused"] = np.asarray(False)
    except ValueError:
        out["refused"] = np.asarray(True)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    distributed.shutdown()
    print("WORKER_OK", rank, flush=True)


if __name__ == "__main__":
    main()
