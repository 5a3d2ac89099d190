"""Ensemble inference: a learned ensemble head over K prior prediction
CSVs (port of the JAX package's cli/inference_ensemble.py, single process
on one device).

The reference's inference_ensemble.py: stream test videos, assemble
`old_predictions` [B, K, classes] from K sorted prediction CSVs keyed by
video id (:155-191), run an ensemble head on the video-level features
and old_predictions, write the Kaggle CSV. Frame-level shards are
mean-pooled over their true frames into video-level features. The head
checkpoint is cli.train_ensemble's msgpack map, from either package.
"""

from __future__ import annotations

import logging
import sys
import time

import numpy as np
import torch

from efficientvideoclassification_youtube8m_torch.cli import flags as flags_lib
from efficientvideoclassification_youtube8m_torch.data import (
    AggregatedDataLoader,
    FrameDataLoader,
)
from efficientvideoclassification_youtube8m_torch.ensemble import (
    PredictionStore,
    format_lines,
    write_predictions_csv,
)
from efficientvideoclassification_youtube8m_torch.models import get_model
from efficientvideoclassification_youtube8m_torch.train import msgpack_io
from efficientvideoclassification_youtube8m_torch.train.step import preprocess_batch
from efficientvideoclassification_youtube8m_torch.weights import load_jax_params

logger = logging.getLogger("inference_ensemble")


def load_head(path: str):
    """(model name, parameter tree, input size, K or None) of a head
    checkpoint; K is absent from the JAX package's oldest head files."""
    raw = msgpack_io.load(path)
    k = raw.get("num_models")
    return (raw["model"], raw["params"], int(raw["input_size"]),
            None if k is None else int(k))


def inference(args) -> None:
    cfg = flags_lib.config_from_args(args)
    device = flags_lib.resolve_device(args)
    head_name, head_params, head_input, head_k = load_head(args.head_checkpoint)
    logger.info("ensemble head: %s (input %d)", head_name, head_input)
    if head_input != cfg.total_feature_size:
        raise ValueError(
            f"head checkpoint {args.head_checkpoint!r} was trained on "
            f"input_size {head_input}, but --feature_names/"
            f"--feature_sizes describe {cfg.total_feature_size} features")
    store = PredictionStore(args.preds_pattern, cfg.num_classes)
    if head_k is not None and head_k != store.num_models:
        raise ValueError(
            f"head checkpoint {args.head_checkpoint!r} was trained over "
            f"{head_k} prediction files, but --preds_pattern matches "
            f"{store.num_models}")
    # the head's "vocab_size" is K for the weight-over-models heads
    head = get_model(head_name)(head_input, store.num_models,
                                num_classes=cfg.num_classes, device=device)
    load_jax_params(head, head_params)

    @torch.no_grad()
    def run_head(features, old_predictions, num_frames):
        if features.dtype == torch.uint8:
            # frame-level input: mean-pool the TRUE frames (the padding is
            # zeroed by preprocess_batch)
            x = preprocess_batch(cfg, features, num_frames)
            denom = torch.clamp(num_frames.to(torch.float32), min=1.0)
            features = torch.sum(x, dim=1) / denom[:, None]
        return head(features, old_predictions=old_predictions)["predictions"]

    loader_cls = FrameDataLoader if args.frame_features else AggregatedDataLoader
    loader_kwargs = dict(
        batch_size=cfg.batch_size,
        feature_names=cfg.feature_names_list,
        feature_sizes=cfg.feature_sizes_list,
        vocab_size=cfg.num_classes,
        num_readers=cfg.num_readers,
        deterministic=cfg.deterministic_input,
        num_epochs=1,
        shuffle=False,
        pad_final_batch=True,
    )
    if args.frame_features:
        loader_kwargs.update(max_frames=cfg.max_num_frames,
                             use_native=cfg.use_native_io)
    loader = loader_cls(args.input_data_pattern, **loader_kwargs)

    def rows():
        num_examples_processed = 0
        start_time = time.time()
        for batch in loader:
            valid = len(batch.video_ids) - batch.pad
            old = store.assemble(batch.video_ids[:valid])
            if batch.pad:
                old = np.concatenate(
                    [old, np.zeros((batch.pad,) + old.shape[1:], old.dtype)])
            preds = run_head(*(torch.from_numpy(a).to(device) for a in (
                batch.features, old, batch.num_frames))).cpu().numpy()[:valid]
            num_examples_processed += valid
            logger.info("num examples processed: %d elapsed seconds: %.2f",
                        num_examples_processed, time.time() - start_time)
            yield from format_lines(batch.video_ids[:valid], preds, args.top_k)

    write_predictions_csv(args.output_file, rows())
    logger.info("Done with inference. The output file was written to %s",
                args.output_file)


def main(argv=None):
    flags_lib.setup_logging()
    parser = flags_lib.base_parser("Ensemble inference over prior CSVs (GPU)")
    parser.add_argument("--output_file", required=True)
    parser.add_argument("--preds_pattern", required=True)
    parser.add_argument("--head_checkpoint", required=True)
    args = parser.parse_args(argv)
    flags_lib.dump_flags(args, logger)
    inference(args)


if __name__ == "__main__":
    main(sys.argv[1:])
