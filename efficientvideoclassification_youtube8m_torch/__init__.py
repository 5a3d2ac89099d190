"""PyTorch + CUDA port of efficientvideoclassification_youtube8m_tpu.

The JAX package beside this one is the reference; every module here
mirrors the JAX module of the same path and is tested against it on the
same weights and inputs. This package imports `torch` and never `jax`.
Jax-free code of the JAX package (`utils/config.py`) is imported, not
copied.

Layering (bottom-up), as far as the port reaches so far:
  ops/       preprocessing, the plain TF1-semantics LSTM scan, and the
             hand-written CUDA recurrence kernel (ops/csrc, ops/kernels)
  models/    registry, MoeModel, HierarchicalLstmModel
  train/     the forward half of the train/eval step (preprocess_batch,
             forward_student, forward_teacher)
  weights    numpy parameter bridge to and from the JAX pytree layout
  serving    Predictor: bf16 student/teacher serving on one device
"""

__version__ = "0.1.0"
