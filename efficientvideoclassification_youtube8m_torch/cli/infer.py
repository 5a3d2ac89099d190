"""Inference: student checkpoint -> Kaggle CSV (port of the JAX package's
cli/infer.py).

The JAX binary is one process over every local device: it reads global
batches and splits the rows over the mesh's data axis (and the head's
columns over its model axis). The port runs one process per device:
under a `torch.distributed` group rank 0 reads the global batches and
each rank runs its data index's rows (`distributed.scatter_batches`);
the rows are gathered in batch order and the master alone writes the
CSV, whose bytes are one process's.

The core of the reference's inference binaries
(`inference_ensemble.py:113-204` minus the ensemble feed): stream test
shards, run the student, write `VideoId,LabelConfidencePairs` top-k rows.
The loader strides the frames to every_n at the parser. In bf16 on a
CUDA device the recurrences run in the forward-only kernel
(`--use_pallas_inference`, default on); `--quantize int8` quantizes the
restored student once and runs the int8 forward, whose recurrences run in
the int8 kernel on a CUDA device. `--frame_features=False` reads
pre-aggregated Examples into a video-level model
(inference_bias.py:195-199).

--alpha_bias/--tensor_name reproduce `inference_bias.py:129,158-168`:
before running, the named bias parameter b is replaced by
`b/alpha + mean(b - b/alpha)`.

`--steps_per_dispatch K` fetches the outputs of K batches at a time
(`cli.loop.eval_loop`). At K > 1 the rows come from the step's device
top-k (the packed host bundle), ties ranked lowest class first as
`lax.top_k` ranks them, as the JAX binary does at the same K; K = 1 ranks
the host copy of the predictions.
"""

from __future__ import annotations

import logging
import sys
import time

import numpy as np
import torch
from torch import nn

from efficientvideoclassification_youtube8m_torch.cli import flags as flags_lib
from efficientvideoclassification_youtube8m_torch.cli.loop import eval_loop
from efficientvideoclassification_youtube8m_torch.cli.validate import (
    EVAL_FIELDS,
    eval_loader,
)
from efficientvideoclassification_youtube8m_torch.ensemble import (
    format_lines,
    format_ranked_lines,
    write_predictions_csv,
)
from efficientvideoclassification_youtube8m_torch.ops.quantize import (
    quantize_hierarchical_params,
)
from efficientvideoclassification_youtube8m_torch.train.checkpoint import (
    latest_checkpoint,
    restore_subtree,
)
from efficientvideoclassification_youtube8m_torch.train.state import (
    StudentState,
    init_model,
)
from efficientvideoclassification_youtube8m_torch.parallel import distributed
from efficientvideoclassification_youtube8m_torch.parallel.mesh import (
    create_mesh,
    shard_state,
)
from efficientvideoclassification_youtube8m_torch.parallel.sharded_step import (
    build_sharded_eval_step,
    build_sharded_quantized_eval_step,
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
    cfg = flags_lib.config_from_args(args)
    aggregated = not args.frame_features
    quantize = getattr(args, "quantize", "none")
    if quantize == "int8":
        # before the parameters are touched, as in the JAX package
        if aggregated:
            raise ValueError("--quantize int8 is the frame-level student path")
        if (cfg.model != "HierarchicalLstmModel"
                or cfg.video_level_classifier_model != "MoeModel"):
            raise ValueError(
                "--quantize int8 covers the flagship HierarchicalLstmModel "
                "+ MoeModel configuration")
    # no auto mode here, as in the JAX package: 0 is 1, since the K > 1
    # rows come from the device top-k
    if getattr(args, "steps_per_dispatch", 1) == 0:
        logger.info("steps_per_dispatch=0 (auto) is not applied to "
                    "inference (device-top-k tie order differs from the "
                    "host path); using 1")
    steps = flags_lib.resolve_steps_per_dispatch(args)
    device = flags_lib.resolve_device(args)
    distributed.initialize(device=device)
    host = distributed.host_context(cfg.batch_size, args.model_parallelism)

    # parameters only: the optimizer slots are neither allocated nor read
    state = StudentState(student=init_model(cfg, device=device), opt_student={},
                         global_step=0, dropout_keep_prob=cfg.dropout)
    # the JAX binary's mesh (model > 1 on one process raises, as it does
    # on one device)
    mesh = create_mesh(model=args.model_parallelism, device=device)
    shard_state(state, mesh)
    ckpt = distributed.broadcast_str(
        latest_checkpoint(cfg.train_dir) if host.is_master else None)
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
        step_fn = build_sharded_quantized_eval_step(cfg, mesh, top_k=args.top_k,
                                                    host_subsampled=True)
    else:
        step_fn = build_sharded_eval_step(cfg, mesh, top_k=args.top_k,
                                          host_subsampled=not aggregated,
                                          aggregated=aggregated)
    # the global batches, read by rank 0; frame path: parse and move only
    # the kept frames
    loader = eval_loader(cfg, args, frame_stride=1 if aggregated else cfg.every_n,
                         aggregated=aggregated, pattern=args.input_data_pattern,
                         host=distributed.HostContext(0, 1, cfg.batch_size, True))
    stream = distributed.scatter_batches(loader, mesh)
    model = args.model_parallelism

    # K > 1: the rows from the device top-k, as the JAX binary's at the same K
    device_topk = steps > 1
    key = "host_pack" if device_topk else "predictions"

    def rows():
        num_examples_processed = 0
        start_time = time.time()
        for out, (vids, pad) in eval_loop(
                stream, device, steps, max(1, cfg.fetch_depth),
                lambda f, l, n: step_fn(params, f, l, n), (key,),
                host_keep=lambda b: (b.video_ids, b.pad)):
            fetched = out[key].numpy()
            if device_topk:
                top = distributed.unpack_host_pack(fetched, None)
                got, _ = distributed.gather_eval_rows(
                    {k: top[k] for k in ("topk_idx", "topk_val")}, pad, model)
                lines = format_ranked_lines(vids, got["topk_idx"], got["topk_val"])
            else:
                got, _ = distributed.gather_eval_rows({"predictions": fetched},
                                                      pad, model)
                lines = format_lines(vids, got["predictions"], args.top_k)
            num_examples_processed += len(vids)
            logger.info("num examples processed: %d elapsed seconds: %.2f",
                        num_examples_processed, time.time() - start_time)
            yield from lines

    if host.is_master:
        write_predictions_csv(args.output_file, rows())
        logger.info("Done with inference. The output file was written to %s",
                    args.output_file)
    else:
        for _ in rows():  # the gathers are collectives of every rank
            pass


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
                        help="K batches a fetch; K > 1 takes the rows from "
                        "the device top-k (probability ties ranked lowest "
                        "class first, which the K = 1 host ranking may "
                        "order otherwise); 0 and negative values read as 1")
    args = parser.parse_args(argv)
    flags_lib.dump_flags(args, logger)
    inference(args)


if __name__ == "__main__":
    main(sys.argv[1:])
