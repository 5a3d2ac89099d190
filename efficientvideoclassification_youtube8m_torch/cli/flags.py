"""The binaries' flags (port of the JAX package's cli/flags.py).

The parser, `config_from_args`, `dump_flags` and `setup_logging` do not
import jax and are the JAX package's, re-exported. Ported here: the
parameter-list dump, `--steps_per_dispatch` resolution, and the device
the flags name.
"""

from __future__ import annotations

import argparse
import logging
from typing import List, Optional

import torch
from torch import nn

from efficientvideoclassification_youtube8m_torch.utils.summary import jax_order
from efficientvideoclassification_youtube8m_tpu.cli.flags import (  # noqa: F401
    base_parser,
    config_from_args,
    dump_flags,
    setup_logging,
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
    negative values clamp to 1, and 0 ("auto") is 1, as the JAX rule
    resolves it on a non-TPU backend. K > 1 stacks K batches into one
    launch, which the JAX package needed for a high-latency host link;
    whether the H100 needs it, or CUDA graphs instead, is ROADMAP Queue 1
    item 9's open question, so K > 1 raises."""
    k = getattr(args, "steps_per_dispatch", 1)
    if k > 1:
        raise NotImplementedError(
            "--steps_per_dispatch > 1 is not ported: whether K-stacked "
            "dispatch or CUDA graphs are needed on the GPU is open (ROADMAP "
            "Queue 1 item 9)")
    if k == 0 and logger is not None:
        logger.info("steps_per_dispatch auto-resolved to 1")
    args.steps_per_dispatch = 1
    return 1


def resolve_device(args: argparse.Namespace) -> torch.device:
    """The device the flags name: `--device` as `/gpu:N`, `gpu:N`, `cuda`,
    `cuda:N` or `cpu` (`/cpu:0`); the default `/gpu:0` takes its index
    from `--gpu`. A CUDA device where CUDA is not available raises:
    nothing falls back to the CPU on its own."""
    name = str(args.device).strip().lower().lstrip("/")
    kind, _, index = name.partition(":")
    if kind == "cpu":
        return torch.device("cpu")
    if kind not in ("gpu", "cuda"):
        raise ValueError(f"--device {args.device!r}: expected /gpu:N, cuda:N "
                         "or cpu")
    if name == "gpu:0":
        index = str(args.gpu)
    if not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device} asks for a CUDA device and "
                           "none is available; pass --device cpu to run on "
                           "the CPU")
    device = torch.device("cuda", int(index or 0))
    if device.index >= torch.cuda.device_count():
        raise RuntimeError(f"--device {args.device}: there are only "
                           f"{torch.cuda.device_count()} CUDA devices")
    return device


def check_ported(args: argparse.Namespace) -> None:
    """Raise NotImplementedError, naming its ROADMAP item, for a flag the
    port does not cover yet: the model zoo beyond the flagship, orbax
    checkpoints and the parallel paths."""
    if (args.model != "HierarchicalLstmModel"
            or args.video_level_classifier_model != "MoeModel"):
        raise NotImplementedError(
            f"--model {args.model} with --video_level_classifier_model "
            f"{args.video_level_classifier_model}: the port covers the "
            "flagship HierarchicalLstmModel + MoeModel; the rest of the zoo "
            "is ROADMAP Queue 1 item 12")
    if args.checkpoint_format == "orbax":
        raise NotImplementedError(
            "--checkpoint_format orbax is not ported yet (ROADMAP Queue 1 "
            "item 13); use msgpack")
    if getattr(args, "use_shardmap_train", False):
        raise NotImplementedError(
            "--use_shardmap_train comes with the parallel port (ROADMAP "
            "Queue 1 item 13)")
    if getattr(args, "model_parallelism", 1) > 1:
        raise NotImplementedError(
            "--model_parallelism > 1 comes with the parallel port (ROADMAP "
            "Queue 1 item 13)")
