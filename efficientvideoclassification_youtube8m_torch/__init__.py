"""PyTorch + CUDA port of efficientvideoclassification_youtube8m_tpu.

The JAX package beside this one is the reference; every module here
mirrors the JAX module of the same path and is tested against it on the
same weights and inputs. This package imports `torch` and never `jax`.
Jax-free code of the JAX package (`utils/config.py`, the host-side
metrics) is imported, not copied.

Layering (bottom-up), as far as the port reaches so far:
  ops/       preprocessing, the plain TF1-semantics LSTM scan, the int8
             quantized forward (ops/quantize), and the hand-written CUDA
             recurrence kernels (ops/csrc, ops/kernels): the forward-only
             bf16 and int8 scans and the train forward and backward
  models/    registry, MoeModel, HierarchicalLstmModel
  losses     the label loss and the two distillation losses
  metrics/   device-side top-k and PERR
  train/     TF-semantics optimizers, the training state, and the steps:
             preprocessing, the tower forwards, distill, finetune,
             validate, eval and int8 eval
  weights    numpy parameter bridge to and from the JAX pytree layout
  serving    Predictor: bf16 and int8 student/teacher serving on one
             device
"""

__version__ = "0.1.0"
