"""Frame-level models (port of the JAX package's models/frame_level.py).
Only the flagship `HierarchicalLstmModel` so far.

The reference runs one `dynamic_rnn` per chunk of frames sharing one
2-layer LSTM, stacks the chunk final states, and runs a second 2-layer
LSTM over them. Here the chunks are folded into the batch axis —
[B, T, D] -> [B*C, T/C, D] — so L1 is one scan whose recurrent product
has batch B*C, and L2 is one scan over the C stacked chunk states.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
from torch import nn

from efficientvideoclassification_youtube8m_torch.models.base import (
    get_model,
    register_model,
)
from efficientvideoclassification_youtube8m_torch.ops.kernels.lstm_scan import (
    multi_lstm_scan_fused,
)
from efficientvideoclassification_youtube8m_torch.ops.kernels.lstm_train import (
    multi_lstm_scan_train_fused,
)
from efficientvideoclassification_youtube8m_torch.ops.lstm import (
    init_multi_lstm,
    multi_lstm_scan,
)


@register_model("HierarchicalLstmModel")
class HierarchicalLstmModel(nn.Module):
    """Two-level hierarchical LSTM + a video-level classifier.

    `forward` covers both the teacher (300 frames, 20 chunks) and the
    student (300//every_n frames, num_inputs_L1 chunks): same math,
    different shapes. Returns {"state": [B, layers*2*cells],
    "predictions": [B, vocab], "regularization_loss"}; "state" is the
    distillation target. Parameters follow the JAX pytree:
    ``rnn_l1.<layer>.{kernel,bias}``, ``rnn_l2.<layer>...``,
    ``classifier...``.
    """

    def __init__(self, input_size: int, vocab_size: int,
                 lstm_cells: int = 1024, lstm_layers: int = 2,
                 classifier: str = "MoeModel",
                 classifier_kwargs: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None, device=None,
                 **_):
        super().__init__()
        state_dim = lstm_layers * 2 * lstm_cells
        self.vocab_size = vocab_size
        self.rnn_l1 = init_multi_lstm(generator, input_size, lstm_cells,
                                      lstm_layers, device)
        self.rnn_l2 = init_multi_lstm(generator, state_dim, lstm_cells,
                                      lstm_layers, device)
        self.classifier = get_model(classifier)(
            state_dim, vocab_size, generator=generator, device=device,
            **(classifier_kwargs or {}))

    def forward(self, model_input: torch.Tensor,  # [B, T, D]
                num_frames: torch.Tensor,  # [B] (rescaled for the student)
                num_chunks: int = 20,
                classifier: Optional[str] = None,
                compute_dtype: torch.dtype = torch.float32,
                use_kernel: bool = False,
                use_kernel_train: bool = False,
                **classifier_kwargs) -> Dict[str, Any]:
        """`use_kernel` runs both levels through the forward-only bf16
        kernel (inference; it records no gradient), `use_kernel_train`
        through the differentiable train kernels (ops/kernels/
        lstm_train.py, bf16 whatever `compute_dtype` says, as the JAX
        `pallas_train` path); otherwise the plain scan in
        `compute_dtype`."""
        if classifier is not None and classifier != self.classifier.name:
            raise ValueError(f"the module's classifier is a "
                             f"{self.classifier.name}, not {classifier}")
        B, T, D = model_input.shape
        if T % num_chunks:
            raise ValueError(f"{T} frames do not split into {num_chunks} chunks")
        chunk_len = T // num_chunks

        if use_kernel_train:
            scan_fn = multi_lstm_scan_train_fused
        elif use_kernel:
            scan_fn = multi_lstm_scan_fused
        else:
            scan_fn = functools.partial(multi_lstm_scan,
                                        compute_dtype=compute_dtype)

        # L1: fold chunks into the batch axis -> one shared-weight scan.
        x_chunks = model_input.reshape(B * num_chunks, chunk_len, D)
        chunk_starts = chunk_len * torch.arange(
            num_chunks, dtype=torch.int32, device=model_input.device)
        seq_l1 = torch.clamp(
            num_frames.to(torch.int32)[:, None] - chunk_starts[None, :],
            0, chunk_len,
        ).reshape(B * num_chunks)
        l1_state = scan_fn(self.rnn_l1, x_chunks, seq_l1)

        # L2: scan over the per-chunk final states.
        l2_input = l1_state.reshape(B, num_chunks, -1).to(torch.float32)
        seq_l2 = torch.ceil(
            num_frames.to(torch.float32) / float(chunk_len)).to(torch.int32)
        state = scan_fn(self.rnn_l2, l2_input, seq_l2)

        result = self.classifier(state, compute_dtype=compute_dtype,
                                 **classifier_kwargs)
        result["state"] = state
        return result
