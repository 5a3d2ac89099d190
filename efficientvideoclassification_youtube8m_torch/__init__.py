"""PyTorch + CUDA port of efficientvideoclassification_youtube8m_tpu.

The JAX package beside this one is the reference; every module here
mirrors the JAX module of the same path and is tested against it on the
same weights and inputs. This package imports `torch` and never `jax`,
and nothing of the JAX package: what it needs of that package's jax-free
modules (the data plane, the host metrics, the events writer, the flag
parser, the config, the CSV tools) is copied here.

Layering (bottom-up), as far as the port reaches so far:
  data/      TFRecord shards, the native C++ parser (data/native, built
             into build/native/) and the batching loaders; TF-V2 bundles
  ops/       preprocessing, the plain TF1-semantics LSTM scan, the int8
             quantized forward (ops/quantize), and the hand-written CUDA
             recurrence kernels (ops/csrc, ops/kernels): the forward-only
             bf16 and int8 scans and the train forward and backward
  models/    registry, MoeModel, HierarchicalLstmModel
  losses     the label loss and the two distillation losses
  metrics/   the host AP/mAP calculators and EvaluationMetrics; the
             device-side top-k and PERR
  train/     TF-semantics optimizers, the training state, and the steps:
             preprocessing, the tower forwards, distill, finetune,
             validate, eval and int8 eval (data-parallel given a process
             group); msgpack checkpoints and TF-V2 import and export
  parallel/  torch.distributed: the process group, the data-parallel
             steps and collectives, the stream sync and eval-row gather
  weights    numpy parameter bridge to and from the JAX pytree layout
  serving    Predictor: bf16 and int8 student/teacher serving on one
             device
  ensemble   Kaggle-CSV rows and the max ensemble
  cli/       the binaries: train, validate, convert, finetune, eval, infer,
             inference_bias, max_ensemble, inspect_checkpoint, hash_check,
             train_ensemble, inference_ensemble, export_tf
  utils/     the config, the summaries, the profiler
  scripts/   the convergence gate (acceptance_run)
"""

__version__ = "0.1.0"
