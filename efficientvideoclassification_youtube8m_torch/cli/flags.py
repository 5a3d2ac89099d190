"""The binaries' flags (port of the JAX package's cli/flags.py).

Flag names and defaults match the union of the reference's per-binary
DEFINE_* blocks (train.py:27-99, frame_level_models.py:16-47,
video_level_models.py:14-19), as the JAX package's parser does, so
reference invocations port 1:1. Beside the parser: the parameter-list
dump, `--steps_per_dispatch` resolution and the device the flags name.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import List, Optional

import torch
from torch import nn

from efficientvideoclassification_youtube8m_torch.utils.config import TrainConfig
from efficientvideoclassification_youtube8m_torch.utils.summary import jax_order


def _bool(v: str) -> bool:
    return str(v).lower() in ("1", "true", "t", "yes", "y")


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    # dataset / model
    p.add_argument("--train_dir", default="./tmp/model/")
    p.add_argument("--train_data_pattern", default="")
    p.add_argument("--eval_data_pattern", default="")
    p.add_argument("--input_data_pattern", default="")
    p.add_argument("--feature_names", default="rgb, audio")
    p.add_argument("--feature_sizes", default="1024, 128")
    p.add_argument("--frame_features", type=_bool, default=True)
    p.add_argument("--model", default="HierarchicalLstmModel")
    p.add_argument("--start_new_model", type=_bool, default=False,
                   nargs="?", const=True)
    p.add_argument("--num_classes", type=int, default=4716)
    p.add_argument("--bagging", type=_bool, default=False)
    # training
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--every_n", type=int, default=10)
    p.add_argument("--label_loss", default="CrossEntropyLoss")
    p.add_argument("--class_counts_file", default="",
                   help="per-class counts file for CrossEntropyLossClassImbalance")
    p.add_argument("--dropout", type=float, default=1.0)
    p.add_argument("--regularization_penalty", type=float, default=1.0)
    p.add_argument("--base_learning_rate", type=float, default=0.001)
    p.add_argument("--learning_rate_decay", type=float, default=0.95)
    p.add_argument("--learning_rate_decay_examples", type=float, default=4000000)
    p.add_argument("--num_epochs", type=int, default=5)
    p.add_argument("--num_readers", type=int, default=4,
                   help="how many input files are read at once; in file "
                   "order with the native parser a team of threads sized "
                   "from the CPUs the process may use decodes their records")
    p.add_argument("--optimizer", default="AdamOptimizer")
    p.add_argument("--clip_gradient_norm", type=float, default=1.0)
    p.add_argument("--log_device_placement", type=_bool, default=False)
    p.add_argument("--gpu", type=int, default=0,
                   help="index of the CUDA device the default --device "
                   "/gpu:0 names")
    p.add_argument("--device", default="/gpu:0",
                   help="/gpu:N, cuda:N or cpu (inference_ensemble.py:54); "
                   "a CUDA device that is not there raises")
    # model hyperparameters
    p.add_argument("--lstm_cells", type=int, default=1024)
    p.add_argument("--lstm_layers", type=int, default=2)
    p.add_argument("--max_num_frames", type=int, default=300)
    p.add_argument("--num_inputs_to_lstm", type=int, default=20)
    p.add_argument("--num_inputs_L1", type=int, default=5)
    p.add_argument("--video_level_classifier_model", default="MoeModel")
    p.add_argument("--moe_num_mixtures", type=int, default=2)
    p.add_argument("--num_hidden_units", type=int, default=1024)
    p.add_argument("--iterations", type=int, default=30)
    p.add_argument("--dbof_cluster_size", type=int, default=8192)
    p.add_argument("--dbof_hidden_size", type=int, default=1024)
    p.add_argument("--dbof_pooling_method", default="max")
    p.add_argument("--dbof_add_batch_norm", type=_bool, default=True)
    p.add_argument("--sample_random_frames", type=_bool, default=True)
    # vestigial reference flags (frame_level_models.py:20-46): registered
    # at import there but consumed by no shipped model (the atrous-conv /
    # attention experiments never landed); accepted here with the same
    # defaults so reference invocations parse. `a_rate` keeps the
    # reference's DEFINE_string-with-int-default quirk by parsing as str.
    p.add_argument("--ppfs_normalize", type=_bool, default=False)
    p.add_argument("--input_features", type=int, default=1024)
    p.add_argument("--a_rate", default="2")
    p.add_argument("--num_conv2d_layers", type=int, default=4)
    p.add_argument("--filter_size", type=int, default=10)
    p.add_argument("--att_hid_size", type=int, default=100)
    # eval / inference
    p.add_argument("--top_k", type=int, default=20)
    p.add_argument("--run_once", type=_bool, default=False,
                   nargs="?", const=True)
    # rebuild-specific
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--scan_unroll", type=int, default=15,
                   help="accepted for flag parity; the port's recurrences "
                   "take no unroll")
    p.add_argument("--use_pallas_inference", type=_bool, default=True,
                   help="the hand-written forward-only recurrence kernels "
                   "(bf16, int8) on a CUDA device")
    p.add_argument("--lstm_pallas_train", type=_bool, default=True,
                   help="the hand-written train forward and backward "
                   "kernels in bf16 on a CUDA device; the plain scan "
                   "elsewhere. Gated by the convergence bands of "
                   "scripts/acceptance_run.py on the card.")
    p.add_argument("--faithful_quirks", type=_bool, default=True)
    p.add_argument("--model_parallelism", type=int, default=1,
                   help="size of the 'model' mesh axis (tensor "
                   "parallelism: the column-sharded MoE head); the "
                   "processes of a group are laid out data x model")
    p.add_argument("--sync_batch_norm", type=_bool, default=False,
                   help="DBoF's batch-norm moments averaged over the "
                   "data-parallel ranks inside the forward")
    p.add_argument("--use_shardmap_train", type=_bool, default=False,
                   help="the JAX package's explicit data-parallel train "
                   "step; every data-parallel step of this package is "
                   "that per-device program, so it changes nothing; "
                   "requires model_parallelism=1")
    p.add_argument("--save_model_secs", type=int, default=30 * 60)
    p.add_argument("--save_summaries_secs", type=int, default=120,
                   help="cadence of the in-graph scalar + per-variable "
                   "histogram summaries (the reference Supervisor's "
                   "save_summaries_secs, train.py:503)")
    p.add_argument("--checkpoint_format", default="msgpack",
                   choices=["msgpack", "orbax"],
                   help="msgpack: one file; orbax: a directory in orbax's "
                   "layout (train/orbax_io.py)")
    p.add_argument("--async_checkpoint", type=_bool, default=True,
                   help="overlap periodic checkpoint writes with training "
                   "(pinned host snapshot + background write; the final "
                   "save is always joined before exit)")
    p.add_argument("--use_native_io", type=_bool, default=True)
    p.add_argument("--deterministic_input", type=_bool, default=False,
                   help="make the multi-reader input pipeline yield the "
                   "single-reader batch stream exactly (round-robin file "
                   "dispatch + in-order drain; files still parse "
                   "concurrently) — reproducible runs at a small "
                   "throughput cost under skewed shard sizes")
    p.add_argument("--fetch_depth", type=int, default=4,
                   help="in-flight dispatch depth of the eval loops' "
                   "lag-N fetch ring (1 = sequential fetch); FIFO drain "
                   "keeps epoch metrics identical at any depth")
    return p


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    cfg_fields = TrainConfig.__dataclass_fields__
    kw = {k: v for k, v in vars(args).items() if k in cfg_fields}
    return TrainConfig(**kw)


def dump_flags(args: argparse.Namespace, logger: Optional[logging.Logger] = None):
    """The reference dumps all FLAGS at startup (train.py:705-707)."""
    log = (logger or logging.getLogger()).info
    for key in sorted(vars(args)):
        log("%s: %s", key, getattr(args, key))


def setup_logging():
    logging.basicConfig(
        level=logging.INFO,
        format="%(levelname)s:%(name)s:%(asctime)s: %(message)s",
    )



def param_names(module: nn.Module, prefix: str) -> List[str]:
    """The reference's trainable-variable dump (train.py:326-328): one
    `prefix/path:[shape]` entry per parameter, in the JAX package's order
    and format (`model/rnn_l1/0/kernel:[1280, 4096]`)."""
    shapes = {name: list(t.shape) for name, t in module.state_dict().items()}
    return [f"{prefix}/{name.replace('.', '/')}:{shapes[name]}"
            for name in jax_order(shapes)]


def resolve_steps_per_dispatch(args: argparse.Namespace,
                               logger: Optional[logging.Logger] = None) -> int:
    """Resolve --steps_per_dispatch and write the result back onto args:
    an explicit K >= 1 wins, and 0 and negative values read as 1. The
    eval binaries fetch the outputs of K batches at a time
    (`cli.loop.eval_loop`); the epoch metrics are those of K = 1, and
    `cli.infer` takes its rows from the device top-k at K > 1."""
    k = getattr(args, "steps_per_dispatch", 1)
    if k == 0 and logger is not None:
        logger.info("steps_per_dispatch auto-resolved to 1")
    args.steps_per_dispatch = max(1, k)
    return args.steps_per_dispatch


def resolve_device(args: argparse.Namespace) -> torch.device:
    """The device the flags name: `--device` as `/gpu:N`, `gpu:N`, `cuda`,
    `cuda:N` or `cpu` (`/cpu:0`); the default `/gpu:0` takes its index
    from `--gpu`, or from LOCAL_RANK when a launcher sets it and `--gpu`
    is left at 0 (one process per card). A CUDA device where CUDA is not
    available raises: nothing falls back to the CPU on its own."""
    name = str(args.device).strip().lower().lstrip("/")
    kind, _, index = name.partition(":")
    if kind == "cpu":
        return torch.device("cpu")
    if kind not in ("gpu", "cuda"):
        raise ValueError(f"--device {args.device!r}: expected /gpu:N, cuda:N "
                         "or cpu")
    if name == "gpu:0":
        index = str(args.gpu or os.environ.get("LOCAL_RANK", 0))
    if not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device} asks for a CUDA device and "
                           "none is available; pass --device cpu to run on "
                           "the CPU")
    device = torch.device("cuda", int(index or 0))
    if device.index >= torch.cuda.device_count():
        raise RuntimeError(f"--device {args.device}: there are only "
                           f"{torch.cuda.device_count()} CUDA devices")
    return device
