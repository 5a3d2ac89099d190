"""Writes the JAX-written orbax checkpoints of tests/fixtures/orbax_jax/.

    python tests/_orbax_fixture_writer.py one <dir>
        a tiny StudentState through the JAX package's
        `save_checkpoint(..., backend="orbax")`: <dir>/model.ckpt-7 and its
        leaves as <dir>/values.npz (keys "params_student/rnn_l1/0/kernel");
    python tests/_orbax_fixture_writer.py two <dir> <port> <process_id>
        (two processes, each with 2 virtual CPU devices, as
        tests/_multihost_worker.py runs): a tiny DistillState on a
        (data 1, model 4) mesh whose MoE columns are split over the four
        devices, so each process writes its own columns
        (`ocdbt.process_0/`, `ocdbt.process_1/`) and those leaves have a
        grid of four chunks: <dir>/model.ckpt-2 and <dir>/values.npz.

tests/test_torch_orbax.py reads the committed directories with the port
and regenerates the one-process one with JAX to compare values (orbax's
metadata holds timestamps, so the bytes differ from run to run).
"""

import os
import shutil
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def tiny_config():
    from efficientvideoclassification_youtube8m_tpu.utils.config import TrainConfig

    return TrainConfig(
        num_classes=32, batch_size=8, lstm_cells=8, lstm_layers=2,
        max_num_frames=40, num_inputs_to_lstm=4, num_inputs_L1=2, every_n=2,
        feature_names="rgb, audio", feature_sizes="6, 2", scan_unroll=1,
        compute_dtype="float32")


def flat_values(tree) -> dict:
    import jax

    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k))))
                     for k in path): np.asarray(v) for path, v in leaves}


def student_state(seed: int = 7):
    """The seed's StudentState with every leaf made non-zero."""
    import jax

    from efficientvideoclassification_youtube8m_tpu import train as jtrain

    cfg = tiny_config()
    opt = jtrain.make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = jtrain.student_state_from_distill(jtrain.init_distill_state(cfg, opt), opt)
    rng = np.random.default_rng(seed)
    noise = lambda x: (np.asarray(x) + rng.normal(size=np.shape(x))  # noqa: E731
                       .astype(np.float32)).astype(np.asarray(x).dtype)
    return state.replace(opt_student=jax.tree.map(noise, state.opt_student),
                         global_step=np.asarray(7, np.int32))


def write_one(out_dir: str) -> str:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from efficientvideoclassification_youtube8m_tpu.train import save_checkpoint

    state = student_state()
    shutil.rmtree(out_dir, ignore_errors=True)
    path = save_checkpoint(out_dir, state, 7, backend="orbax")
    np.savez(os.path.join(out_dir, "values.npz"), **flat_values(state))
    return path


def write_two(out_dir: str, port: int, pid: int) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                               num_processes=2, process_id=pid)
    from jax.experimental import multihost_utils

    from efficientvideoclassification_youtube8m_tpu import train as jtrain
    from efficientvideoclassification_youtube8m_tpu.parallel import (
        create_mesh,
        place_state,
    )

    cfg = tiny_config()
    opt = jtrain.make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    host = jtrain.init_distill_state(cfg, opt)
    mesh = create_mesh(model=4)
    state = place_state(host, mesh, min_dim=32)
    if pid == 0:
        shutil.rmtree(out_dir, ignore_errors=True)
    multihost_utils.sync_global_devices("fixture_dir_clean")
    jtrain.save_checkpoint(out_dir, state, 2, backend="orbax")
    multihost_utils.sync_global_devices("fixture_written")
    if pid == 0:
        np.savez(os.path.join(out_dir, "values.npz"), **flat_values(host))
    multihost_utils.sync_global_devices("fixture_values")
    print("FIXTURE_OK", pid, flush=True)


if __name__ == "__main__":
    # absolute: the JAX orbax save names its directory by its absolute
    # path, and `max_to_keep` would take a relative listing of the same
    # directory for an older checkpoint and remove it
    target = os.path.abspath(sys.argv[2])
    if sys.argv[1] == "one":
        write_one(target)
    else:
        write_two(target, int(sys.argv[3]), int(sys.argv[4]))
