"""The plain reference of the paper's Hierarchical LSTM with its MoE head
(Bhardwaj, Srinivasan & Khapra, CVPR 2019; the YouTube-8M starter code's
MoE, arXiv:1609.08675), in plain PyTorch, float32 with TF32 off.

It imports nothing of the program. Parameters are a dict of tensors under
the names of the published checkpoint layout (``rnn_l1.<layer>.kernel``
[input + cells, 4 cells], ``.bias``; ``rnn_l2...``; ``classifier.gates.w``
[state, mixtures + 1, classes], ``classifier.experts.w`` [state,
mixtures, classes], ``classifier.experts.b`` [mixtures, classes]).

* Input: uint8 frames dequantized to [-2, 2] (x * 4/255 + 4/512 - 2),
  l2-normalized per frame, frames past a video's length set to zero.
* TF1 `BasicLSTMCell(forget_bias=1.0)`: gates [x, h] @ kernel + bias,
  split i, j, f, o; c' = c sigmoid(f + 1) + sigmoid(i) tanh(j), h' =
  tanh(c') sigmoid(o); `dynamic_rnn` masking: past a row's length the
  state is frozen and the output is zero. A stack of layers; its final
  state is [c0, h0, c1, h1, ...].
* Hierarchy: L1 runs over each video's frames cut into `chunks` equal
  chunks (a chunk's length: the frames of the video that fall in it);
  L2 runs over the chunks' final L1 states, for ceil(frames / chunk
  length) steps; the head reads L2's final state.
* The student sees frames 0, every_n, 2 every_n, ... with the length
  int(frames / max_frames * (max_frames // every_n)) computed in float64.
* MoE: softmax over mixtures + 1 gates per class, sigmoid experts, the
  prediction the sum of the first `mixtures` gate x expert products;
  l2 of both weight matrices x 1e-8.

Every product goes through `prec.mm(x, w)` and every intermediate a
lower-precision program would store (the input projections) through
`prec.store(t)`, so that a lower precision (the control) can be put in
their place; `PLAIN` is float32.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

Params = Dict[str, torch.Tensor]


class Precision:
    """The arithmetic of the products and of the stored intermediates."""

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return x @ w

    def store(self, t: torch.Tensor) -> torch.Tensor:
        return t


PLAIN = Precision()


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def preprocess(frames_u8: torch.Tensor, num_frames: torch.Tensor) -> torch.Tensor:
    x = frames_u8.to(torch.float32) * (4.0 / 255.0) + (4.0 / 512.0 - 2.0)
    x = x / torch.sqrt(torch.clamp((x * x).sum(-1, keepdim=True), min=1e-12))
    t = torch.arange(x.shape[1], device=x.device)
    return x * (t[None, :] < num_frames[:, None]).to(x.dtype)[:, :, None]


def student_frames(num_frames: torch.Tensor, every_n: int, max_frames: int
                   ) -> torch.Tensor:
    keep = max_frames // every_n
    nf = torch.clamp(num_frames.to(torch.float64), 0, max_frames)
    return (nf / max_frames * keep).to(torch.int64)


def lstm_stack(layers, xs: torch.Tensor, lengths: torch.Tensor,
               prec: Precision = PLAIN) -> torch.Tensor:
    """`layers`: [(kernel, bias)] bottom up; xs [B, T, D]; lengths [B].
    Returns the final state [B, 2 H len(layers)]."""
    finals = []
    inputs = xs
    for kernel, bias in layers:
        B, T, D = inputs.shape
        H = kernel.shape[1] // 4
        proj = prec.store(prec.mm(inputs.reshape(B * T, D), kernel[:D])).reshape(B, T, 4 * H)
        c = xs.new_zeros(B, H)
        h = xs.new_zeros(B, H)
        outs = []
        for t in range(T):
            gates = proj[:, t] + prec.mm(h, kernel[D:]) + bias
            i, j, f, o = gates.split(H, dim=1)
            c_new = c * torch.sigmoid(f + 1.0) + torch.sigmoid(i) * torch.tanh(j)
            h_new = torch.tanh(c_new) * torch.sigmoid(o)
            live = (t < lengths)[:, None]
            c = torch.where(live, c_new, c)
            h = torch.where(live, h_new, h)
            outs.append(torch.where(live, h_new, torch.zeros_like(h_new)))
        finals += [c, h]
        inputs = torch.stack(outs, dim=1)
    return torch.cat(finals, dim=1)


def _layers(params: Params, level: str):
    n = sum(1 for k in params if k.startswith(f"{level}.") and k.endswith(".kernel"))
    return [(params[f"{level}.{i}.kernel"], params[f"{level}.{i}.bias"])
            for i in range(n)]


def moe(params: Params, state: torch.Tensor, prec: Precision = PLAIN
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(predictions [B, V], regularization loss)."""
    gw, ew = params["classifier.gates.w"], params["classifier.experts.w"]
    D, m1, V = gw.shape
    m = m1 - 1
    gate = prec.mm(state, gw.reshape(D, m1 * V)).reshape(-1, m1, V)
    expert = prec.mm(state, ew.reshape(D, m * V)).reshape(-1, m, V)
    expert = expert + params["classifier.experts.b"]
    pred = (torch.softmax(gate, dim=1)[:, :m] * torch.sigmoid(expert)).sum(1)
    reg = 1e-8 * 0.5 * ((gw * gw).sum() + (ew * ew).sum())
    return pred, reg


def tower(params: Params, x: torch.Tensor, num_frames: torch.Tensor,
          chunks: int, prec: Precision = PLAIN) -> Dict[str, torch.Tensor]:
    """The hierarchical model on preprocessed frames x [B, T, D] with
    lengths num_frames [B]: {"state", "predictions", "reg"}."""
    B, T, D = x.shape
    step = T // chunks
    starts = torch.arange(chunks, device=x.device) * step
    l1_len = torch.clamp(num_frames[:, None] - starts[None, :], 0, step)
    l1 = lstm_stack(_layers(params, "rnn_l1"), x.reshape(B * chunks, step, D),
                    l1_len.reshape(-1), prec)
    l2_len = torch.ceil(num_frames.to(torch.float64) / step).to(torch.int64)
    state = lstm_stack(_layers(params, "rnn_l2"), l1.reshape(B, chunks, -1),
                       l2_len, prec)
    pred, reg = moe(params, state, prec)
    return {"state": state, "predictions": pred, "reg": reg}


def student_input(frames_u8: torch.Tensor, num_frames: torch.Tensor,
                  every_n: int, max_frames: int):
    """The student's (preprocessed frames, lengths) from full-frame or
    already strided uint8 frames."""
    if frames_u8.shape[1] == max_frames:
        frames_u8 = frames_u8[:, ::every_n]
    nf = student_frames(num_frames, every_n, max_frames)
    return preprocess(frames_u8, nf), nf


def student_predictions(params: Params, frames_u8: torch.Tensor,
                        num_frames: torch.Tensor, cfg: Dict,
                        prec: Precision = PLAIN) -> torch.Tensor:
    """The student's predictions [B, V] for uint8 frames (full or strided
    to every_n) and the videos' true lengths."""
    x, nf = student_input(frames_u8, num_frames.to(torch.int64),
                          cfg["every_n"], cfg["max_num_frames"])
    return tower(params, x, nf, cfg["num_inputs_L1"], prec)["predictions"]


def predictions(params: Params, frames_u8: torch.Tensor, num_frames: torch.Tensor,
                cfg: Dict, which: str = "student", prec: Precision = PLAIN
                ) -> torch.Tensor:
    """`which` tower's predictions [B, V]: the student's as above, the
    teacher's over every frame (full uint8 frames) in `num_inputs_to_lstm`
    chunks."""
    if which == "student":
        return student_predictions(params, frames_u8, num_frames, cfg, prec)
    nf = num_frames.to(torch.int64)
    return tower(params, preprocess(frames_u8, nf), nf, cfg["num_inputs_to_lstm"],
                 prec)["predictions"]


def cross_entropy(predictions: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The per-video cross entropy [B] of the YouTube-8M starter code's
    eval (epsilon 1e-5) over the classes of dense 0/1 `labels` [B, V]."""
    eps = 1e-5
    y = labels.to(predictions.dtype)
    return -torch.sum(y * torch.log(predictions + eps)
                      + (1 - y) * torch.log(1 - predictions + eps), dim=1)


def glorot_limit(fan_in: int, fan_out: int) -> float:
    return math.sqrt(6.0 / (fan_in + fan_out))
