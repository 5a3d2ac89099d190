"""Ensemble-head trainer (port of the JAX package's cli/train_ensemble.py,
single process on one device).

The reference trains its ensemble heads (video_level_models.py:227-373)
through its train graph with an `old_predictions` input beside
video-level features. This binary trains any of the five ensemble heads
on pre-aggregated Example shards and K prior-prediction CSVs, and saves
a head checkpoint for cli.inference_ensemble: a msgpack map {"model":
name, "params": the JAX parameter tree, "input_size", "num_models"},
written by `train/msgpack_io.py` as the JAX binary writes it with flax,
so a head file of either package reads in the other.
"""

from __future__ import annotations

import logging
import os
import sys

import torch

from efficientvideoclassification_youtube8m_torch import losses as losses_lib
from efficientvideoclassification_youtube8m_torch.cli import flags as flags_lib
from efficientvideoclassification_youtube8m_torch.data import AggregatedDataLoader
from efficientvideoclassification_youtube8m_torch.ensemble import PredictionStore
from efficientvideoclassification_youtube8m_torch.models import get_model
from efficientvideoclassification_youtube8m_torch.ops import prng
from efficientvideoclassification_youtube8m_torch.train import msgpack_io
from efficientvideoclassification_youtube8m_torch.train.optimizer import (
    exponential_decay,
    make_optimizer,
)
from efficientvideoclassification_youtube8m_torch.train.state import params_of
from efficientvideoclassification_youtube8m_torch.train.step import (
    model_label_loss,
    param_grads,
)
from efficientvideoclassification_youtube8m_torch.weights import to_jax_params

logger = logging.getLogger("train_ensemble")

# the heads whose output is sized by K, the number of models, and that
# blend `old_predictions` (video_level_models.py:227-373); a plain
# video-level head sized by K would be a K-class head
ENSEMBLE_HEADS = (
    "LinearRegressionEnsemble",
    "SingleHiddenLayerEnsemble",
    "LinearRegressionWeightedMeanEnsemble",
    "LinearRegressionWeightedMeanEnsembleDifferenceLoss",
    "IndependentClassEnsemble",
)


def train_ensemble(args) -> torch.nn.Module:
    """Returns the trained head."""
    cfg = flags_lib.config_from_args(args)
    if args.model not in ENSEMBLE_HEADS:
        raise ValueError(
            f"--model {args.model} is not an ensemble head; this binary "
            f"trains weight-over-models heads only: {ENSEMBLE_HEADS}")
    device = flags_lib.resolve_device(args)
    store = PredictionStore(args.preds_pattern, cfg.num_classes)
    num_models = store.num_models
    head = get_model(args.model)(cfg.total_feature_size, num_models,
                                 num_classes=cfg.num_classes,
                                 key=prng.prng_key(cfg.seed), device=device)
    optimizer = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    opt_state = optimizer.init(params_of(head))
    schedule = exponential_decay(cfg.base_learning_rate, cfg.batch_size,
                                 cfg.learning_rate_decay_examples,
                                 cfg.learning_rate_decay)
    label_loss_fn = losses_lib.get_loss(cfg.label_loss)

    gstep = 0
    for epoch in range(cfg.num_epochs or 1):
        loader = AggregatedDataLoader(
            cfg.train_data_pattern,
            batch_size=cfg.batch_size,
            feature_names=cfg.feature_names_list,
            feature_sizes=cfg.feature_sizes_list,
            vocab_size=cfg.num_classes,
            num_readers=cfg.num_readers,
            deterministic=cfg.deterministic_input,
            num_epochs=1,
            shuffle=True,
            seed=cfg.seed + epoch,
        )
        for batch in loader:
            features, old, labels = (
                torch.from_numpy(a).to(device) for a in
                (batch.features, store.assemble(batch.video_ids), batch.labels))
            out = head(features, old_predictions=old, labels=labels)
            loss = (model_label_loss(out, labels, label_loss_fn)
                    + cfg.regularization_penalty * out["regularization_loss"])
            (grads,) = param_grads(loss, head)
            optimizer.update(grads, opt_state, params_of(head), schedule(gstep))
            gstep += 1
            # a device sync: at the log cadence only
            if gstep % args.log_every == 0:
                logger.info("epoch %d step %d loss %.4f", epoch, gstep,
                            loss.item())

    os.makedirs(os.path.dirname(args.head_checkpoint) or ".", exist_ok=True)
    with open(args.head_checkpoint, "wb") as f:
        msgpack_io.dump({
            "model": args.model,
            "params": to_jax_params(head),
            "input_size": cfg.total_feature_size,
            # lets inference_ensemble reject a prediction-CSV count mismatch
            "num_models": num_models,
        }, f)
    logger.info("saved ensemble head to %s", args.head_checkpoint)
    return head


def main(argv=None):
    flags_lib.setup_logging()
    parser = flags_lib.base_parser("Train an ensemble head over K CSVs (GPU)")
    parser.add_argument("--preds_pattern", required=True)
    parser.add_argument("--head_checkpoint", required=True)
    parser.add_argument("--log_every", type=int, default=10,
                        help="log (and device-sync) the loss every N steps")
    # the frame-level default only; an explicit --model is validated
    parser.set_defaults(model="LinearRegressionEnsemble")
    args = parser.parse_args(argv)
    flags_lib.dump_flags(args, logger)
    return train_ensemble(args)


if __name__ == "__main__":
    main(sys.argv[1:])
