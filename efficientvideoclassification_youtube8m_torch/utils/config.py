"""Configuration — the reference's flag surface as a dataclass (a copy of
the JAX package's utils/config.py: the same fields and defaults).

Flag names/defaults follow the union of `tf.flags` definitions across the
reference binaries (SURVEY.md §2.4; `train.py:27-99`,
`frame_level_models.py:16-47`, `video_level_models.py:14-19`). The CLI
layer (cli/) exposes them under identical `--flag` names.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


def parse_feature_csv(feature_names: str, feature_sizes: str) -> Tuple[List[str], List[int]]:
    """`GetListOfFeatureNamesAndSizes` (utils.py:127-148)."""
    names = [n.strip() for n in feature_names.split(",")]
    sizes = [int(s) for s in feature_sizes.split(",")]
    if len(names) != len(sizes):
        raise ValueError(
            f"length of the feature names (={len(names)}) != "
            f"length of feature sizes (={len(sizes)})"
        )
    return names, sizes


@dataclasses.dataclass
class TrainConfig:
    # dataset / model (train.py:29-59)
    train_dir: str = "./tmp/model/"
    train_data_pattern: str = ""
    feature_names: str = "rgb, audio"
    feature_sizes: str = "1024, 128"
    frame_features: bool = True
    model: str = "HierarchicalLstmModel"
    start_new_model: bool = False
    num_classes: int = 4716

    # training (train.py:62-99)
    batch_size: int = 256
    every_n: int = 10
    label_loss: str = "CrossEntropyLoss"
    dropout: float = 1.0  # keep-prob, plumbed like the reference's dropout_var
    regularization_penalty: float = 1.0
    base_learning_rate: float = 0.001
    learning_rate_decay: float = 0.95
    learning_rate_decay_examples: float = 4000000
    num_epochs: Optional[int] = 5
    num_readers: int = 4
    optimizer: str = "AdamOptimizer"
    clip_gradient_norm: float = 1.0

    # model hyperparameters (frame_level_models.py:16-47,
    # video_level_models.py:14-19)
    lstm_cells: int = 1024
    lstm_layers: int = 2  # the run scripts pass 2 (run_train.sh)
    max_num_frames: int = 300
    num_inputs_to_lstm: int = 20
    num_inputs_L1: int = 5  # student chunk count (train.py:356)
    video_level_classifier_model: str = "MoeModel"
    moe_num_mixtures: int = 2
    num_hidden_units: int = 1024
    iterations: int = 30  # frames a training sample draws (DBoF, Gated NetVLAD)
    dbof_cluster_size: int = 8192
    dbof_hidden_size: int = 1024
    dbof_pooling_method: str = "max"
    dbof_add_batch_norm: bool = True
    sample_random_frames: bool = True

    # eval / inference (validate.py:60-61, inference_*.py)
    class_counts_file: str = ""  # for CrossEntropyLossClassImbalance (counts_tv)
    top_k: int = 20
    run_once: bool = False

    # rebuild-specific knobs
    seed: int = 0
    compute_dtype: str = "float32"  # or "bfloat16" for tensor-core matmuls
    # the JAX package's scan unroll; accepted for flag parity, the port's
    # recurrences take no unroll
    scan_unroll: int = 15
    # the hand-written forward-only recurrence kernels (bf16 and int8) on
    # the eval, validate and serving paths, on a CUDA device
    use_pallas_inference: bool = True
    # the hand-written train forward and backward kernels, in bf16 on a
    # CUDA device; the plain scan elsewhere. The convergence gate
    # (scripts/acceptance_run.py of this package) holds its bands with
    # them on the card.
    lstm_pallas_train: bool = True
    faithful_quirks: bool = True  # L_REP double-count + global_step += 2
    use_native_io: bool = True
    # deterministic multi-reader input: round-robin file dispatch +
    # in-file-order drain makes the batch stream identical to the
    # single-reader stream (and across relaunches) while files still
    # parse concurrently. Off = work-stealing readers (highest
    # throughput under skewed shard sizes; arrival order then depends
    # on thread timing, like the reference's shuffle_batch_join).
    deterministic_input: bool = False
    # synced (cross-rank) batch-norm moments for data-parallel DBoF
    # training: one all-reduce per BN layer inside the forward makes the
    # gradients those of the global batch's statistics
    sync_batch_norm: bool = False
    # in-flight dispatch depth of the eval loops' lag-N fetch ring:
    # results are pulled N batches behind dispatch so N launches' worth
    # of dispatch + D2H latency overlaps device compute (FIFO drain —
    # epoch metrics are order-identical to the sequential loop)
    fetch_depth: int = 4

    @property
    def feature_names_list(self) -> List[str]:
        return parse_feature_csv(self.feature_names, self.feature_sizes)[0]

    @property
    def feature_sizes_list(self) -> List[int]:
        return parse_feature_csv(self.feature_names, self.feature_sizes)[1]

    @property
    def total_feature_size(self) -> int:
        return sum(self.feature_sizes_list)

    @property
    def max_frames_student(self) -> int:
        return self.max_num_frames // self.every_n

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)
