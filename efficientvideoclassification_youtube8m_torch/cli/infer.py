"""Inference: student checkpoint -> Kaggle CSV (port of the JAX package's
cli/infer.py, frame-level path, one batch per launch, single process on
one device).

The core of the reference's inference binaries
(`inference_ensemble.py:113-204` minus the ensemble feed): stream test
shards, run the student, write `VideoId,LabelConfidencePairs` top-k rows.
The loader strides the frames to every_n at the parser. In bf16 on a
CUDA device the recurrences run in the forward-only kernel
(`--use_pallas_inference`, default on); `--quantize int8` quantizes the
restored student once and runs the int8 forward, whose recurrences run in
the int8 kernel on a CUDA device.

--alpha_bias/--tensor_name reproduce `inference_bias.py:129,158-168`:
before running, the named bias parameter b is replaced by
`b/alpha + mean(b - b/alpha)`.
"""

from __future__ import annotations

import logging
import sys
import time
from collections import deque

import numpy as np
import torch
from torch import nn

from efficientvideoclassification_youtube8m_torch.cli import flags as flags_lib
from efficientvideoclassification_youtube8m_torch.cli.loop import HostFetch, device_prefetch
from efficientvideoclassification_youtube8m_torch.cli.validate import EVAL_FIELDS
from efficientvideoclassification_youtube8m_torch.data import FrameDataLoader
from efficientvideoclassification_youtube8m_torch.ensemble import (
    format_lines,
    write_predictions_csv,
)
from efficientvideoclassification_youtube8m_torch.ops.quantize import (
    quantize_hierarchical_params,
)
from efficientvideoclassification_youtube8m_torch.parallel import distributed
from efficientvideoclassification_youtube8m_torch.train.checkpoint import (
    latest_checkpoint,
    restore_subtree,
)
from efficientvideoclassification_youtube8m_torch.train.state import (
    StudentState,
    init_model,
)
from efficientvideoclassification_youtube8m_torch.train.step import (
    build_eval_step,
    build_quantized_eval_step,
)

logger = logging.getLogger("infer")


def rescale_bias_param(model: nn.Module, tensor_path: str, alpha: float
                       ) -> nn.Module:
    """new = old/alpha + mean(old - old/alpha) (inference_bias.py:158-161)
    for the parameter at the '/'-joined JAX path `tensor_path`
    (`classifier/experts/b` is `classifier.experts.b`, as weights.py names
    them). The arithmetic is the JAX package's, on a numpy copy in the
    parameter's dtype, so the result is bit-identical to it. Returns
    `model`, changed in place."""
    name = ".".join(k for k in tensor_path.split("/") if k)
    params = model.state_dict()
    if name not in params:
        raise KeyError(f"no parameter {tensor_path!r} (as {name!r}); the "
                       f"model has {sorted(params)}")
    param = params[name]
    old = param.detach().cpu().numpy()
    scaled = old / alpha
    new = scaled + np.mean(old - scaled)
    with torch.no_grad():
        param.copy_(torch.from_numpy(new))
    return model


def inference(args) -> None:
    distributed.initialize()
    flags_lib.check_ported(args)
    cfg = flags_lib.config_from_args(args)
    if not args.frame_features:
        raise NotImplementedError(
            "--frame_features=False (video-level models on aggregated "
            "Examples) is not ported yet (ROADMAP Queue 1, the model zoo "
            "and losses)")
    quantize = getattr(args, "quantize", "none")
    if quantize == "int8" and (
            cfg.model != "HierarchicalLstmModel"
            or cfg.video_level_classifier_model != "MoeModel"):
        raise ValueError(
            "--quantize int8 covers the flagship HierarchicalLstmModel "
            "+ MoeModel configuration")
    # no auto mode here, as in the JAX package: 0 is 1, and K > 1 (rows
    # from the device top-k, whose tie order differs) is not ported
    if getattr(args, "steps_per_dispatch", 1) == 0:
        logger.info("steps_per_dispatch=0 (auto) is not applied to "
                    "inference (device-top-k tie order differs from the "
                    "host path); using 1")
    flags_lib.resolve_steps_per_dispatch(args)
    device = flags_lib.resolve_device(args)

    # parameters only: the optimizer slots are neither allocated nor read
    state = StudentState(student=init_model(cfg, device=device), opt_student={},
                         global_step=0, dropout_keep_prob=cfg.dropout)
    ckpt = latest_checkpoint(cfg.train_dir)
    if ckpt is None:
        raise IOError(f"unable to find a checkpoint at location: {cfg.train_dir}")
    logger.info("restoring variables from %s", ckpt)
    restore_subtree(ckpt, state, ("params_student",) + EVAL_FIELDS)
    params = state.student
    if args.tensor_name:
        logger.info("rescaling bias %s by alpha=%s", args.tensor_name,
                    args.alpha_bias)
        rescale_bias_param(params, args.tensor_name, args.alpha_bias)
    if quantize == "int8":
        params = quantize_hierarchical_params(
            params, cfg.total_feature_size, cfg.lstm_cells, cfg.lstm_layers,
            device=device)
        step_fn = build_quantized_eval_step(cfg, top_k=args.top_k,
                                            host_subsampled=True)
    else:
        step_fn = build_eval_step(cfg, top_k=args.top_k, host_subsampled=True)

    loader = FrameDataLoader(
        args.input_data_pattern,
        batch_size=cfg.batch_size,
        feature_names=cfg.feature_names_list,
        feature_sizes=cfg.feature_sizes_list,
        max_frames=cfg.max_num_frames,
        vocab_size=cfg.num_classes,
        num_readers=cfg.num_readers,
        deterministic=cfg.deterministic_input,
        num_epochs=1,
        shuffle=False,
        pad_final_batch=True,
        use_native=cfg.use_native_io,
        # parse and move only the kept frames
        frame_stride=cfg.every_n,
    )

    def rows():
        num_examples_processed = 0
        start_time = time.time()
        # lag-N ring (like cli.eval): several launches in flight, the
        # oldest result pulled; the FIFO drain keeps the loader's row order
        ring: deque = deque()
        depth = max(1, cfg.fetch_depth)

        def emit(fetch, vids, pad):
            nonlocal num_examples_processed
            valid = len(vids) - pad
            preds = fetch.get()["predictions"].numpy()[:valid]
            num_examples_processed += valid
            logger.info("num examples processed: %d elapsed seconds: %.2f",
                        num_examples_processed, time.time() - start_time)
            yield from format_lines(vids[:valid], preds, args.top_k)

        for (f, l, n), (vids, pad) in device_prefetch(
                loader, device, host_keep=lambda b: (b.video_ids, b.pad)):
            ring.append((HostFetch(step_fn(params, f, l, n), ("predictions",)),
                         vids, pad))
            if len(ring) > depth:
                yield from emit(*ring.popleft())
        while ring:
            yield from emit(*ring.popleft())

    write_predictions_csv(args.output_file, rows())
    logger.info("Done with inference. The output file was written to %s",
                args.output_file)


def main(argv=None):
    flags_lib.setup_logging()
    parser = flags_lib.base_parser("Inference: checkpoint -> Kaggle CSV (GPU)")
    parser.add_argument("--output_file", required=True)
    parser.add_argument("--tensor_name", default="",
                        help="params path for bias rescaling, e.g. "
                        "classifier/experts/b")
    parser.add_argument("--alpha_bias", type=float, default=1.0)
    parser.add_argument("--quantize", default="none",
                        choices=["none", "int8"],
                        help="int8: serve the quantized student path")
    parser.add_argument("--steps_per_dispatch", type=int, default=1,
                        help="1 (0 is read as 1): one batch per launch; K > 1 "
                        "is not ported (ROADMAP Queue 1, the host paths of "
                        "the binaries)")
    args = parser.parse_args(argv)
    flags_lib.dump_flags(args, logger)
    inference(args)


if __name__ == "__main__":
    main(sys.argv[1:])
