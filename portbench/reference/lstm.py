"""The plain reference of the YouTube-8M starter code's frame-level LSTM
baseline (Abu-El-Haija et al., YouTube-8M: A Large-Scale Video
Classification Benchmark, arXiv:1609.08675; google/youtube-8m
`frame_level_models.py` `LstmModel`, with its `MoeModel` head) at
inference, in plain PyTorch, float32 with TF32 off.

It imports nothing of the program. Parameters are a dict of tensors under
the program's names: ``rnn.<layer>.kernel`` [input + cells, 4 cells] and
``.bias`` [4 cells], bottom up; ``classifier.gates.w`` [state, mixtures +
1, classes], ``classifier.experts.w`` [state, mixtures, classes],
``classifier.experts.b`` [mixtures, classes].

* A `MultiRNNCell` of TF1 `BasicLSTMCell(cells, forget_bias=1.0)` run by
  `dynamic_rnn` over every frame with `sequence_length` the video's
  length: `model.lstm_stack` (gates i, j, f, o; the forget bias inside
  the sigmoid; past a row's length the state frozen and the output
  zero).
* The head reads the stack's final state through `model.moe`.

Departures from the published code:

* The state is the TF1.x starter's `state_is_tuple=False` layout, [c0,
  h0, c1, h1], 4 x cells wide, as the reference's hierarchical model has
  it; later starter versions feed the top layer's h alone.
* The input is the port's (`model.preprocess`): uint8 frames dequantised
  to [-2, 2], l2-normalised per frame over all the features, padding
  frames zero; the starter l2-normalises the dequantised features too.
* The true-frame count is the eval binaries' (`model.student_frames`):
  int(num_frames / max_frames x (max_frames // every_n)) in float64,
  which at every_n 1 is one frame short at 12 lengths (55, 79, 97, 110,
  123, 158, 171, 194, 207, 220, 233, 246); the starter's
  `sequence_length` counts every true frame. It is worked out on the
  host (`lengths`): on a CUDA tensor PyTorch divides by a Python scalar
  as a product with its reciprocal, which comes out exact at those 12
  lengths, so a count made on the card is not the binaries'.
* Inference only.

Every product goes through `prec.mm(x, w)` and every stored input
projection through `prec.store(t)`, so that a lower precision (the
control) can be put in their place; `PLAIN` is float32.
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench.reference import model as ref_model
from portbench.reference.model import PLAIN, Params, Precision


def layers(params: Params):
    """[(kernel, bias)] of the stack, bottom up."""
    n = sum(1 for k in params if k.startswith("rnn.") and k.endswith(".kernel"))
    return [(params[f"rnn.{i}.kernel"], params[f"rnn.{i}.bias"]) for i in range(n)]


def lengths(num_frames: torch.Tensor, every_n: int, max_frames: int) -> torch.Tensor:
    """The eval binaries' true-frame count of each video, divided on the
    host in float64 (the module's docstring), on `num_frames`' device."""
    host = ref_model.student_frames(num_frames.cpu().to(torch.int64), every_n, max_frames)
    return host.to(num_frames.device)


def predictions(params: Params, frames_u8: torch.Tensor, num_frames: torch.Tensor,
                cfg: Dict, prec: Precision = PLAIN) -> torch.Tensor:
    """The predictions [B, V] for uint8 frames [B, max_frames, D] (or
    already strided to every_n) and the videos' true lengths, under a
    configuration file's flags `cfg`."""
    every_n, max_frames = cfg["every_n"], cfg["max_num_frames"]
    if frames_u8.shape[1] == max_frames:
        frames_u8 = frames_u8[:, ::every_n]
    nf = lengths(num_frames, every_n, max_frames)
    state = ref_model.lstm_stack(layers(params), ref_model.preprocess(frames_u8, nf), nf, prec)
    return ref_model.moe(params, state, prec)[0]
