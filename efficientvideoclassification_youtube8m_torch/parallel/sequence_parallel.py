"""Explicit sequence parallelism for the hierarchical LSTM (port of the
JAX package's parallel/sequence_parallel.py).

The reference's sequence-scaling mechanism is the two-level hierarchy:
300 frames = 20 independent 15-frame L1 blocks. Under data parallelism
those blocks ride in the folded batch axis; this module splits the BLOCK
axis itself over the data axis of the mesh: each rank runs L1 on its
contiguous slice of every video's chunks, one all-gather assembles the
block states, and the short L2 and the head run on every rank. It serves
a small batch of long videos at a lower latency than one device would.

The chunk axis splits in whole chunks, so the data size must divide the
number of chunks (the student's 5 chunks take 1 or 5 ranks, the
teacher's 20 take 2, 4, 5, 10 or 20).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from efficientvideoclassification_youtube8m_torch.models.frame_level import (
    lstm_scan_fn,
)
from efficientvideoclassification_youtube8m_torch.parallel.mesh import Mesh
from efficientvideoclassification_youtube8m_torch.train.step import _model_apply_kwargs
from efficientvideoclassification_youtube8m_torch.utils.config import TrainConfig


def build_sequence_parallel_state_fn(cfg: TrainConfig, mesh: Mesh,
                                     num_chunks: int = None,
                                     compute_dtype: torch.dtype = None):
    """fn(rnn_l1, rnn_l2, features_f32, num_frames) -> the hierarchical
    state [B, layers*2*cells], with the chunk axis split over the mesh's
    data axis. The features are the PREPROCESSED [B, T, D] floats, the
    same on every rank; the state comes out whole on every rank.

    L1 and L2 take the single-device inference routing of the forward
    (`train.step._model_apply_kwargs`) for `cfg` in `compute_dtype`
    (default: the config's): the forward-only bf16 kernel in bf16 on a
    CUDA device with `cfg.use_pallas_inference`, else the plain scan."""
    num_chunks = num_chunks or cfg.num_inputs_to_lstm
    ndev = mesh.shape["data"]
    if num_chunks % ndev:
        raise ValueError(
            f"num_chunks={num_chunks} not divisible by data axis {ndev}")
    local_chunks = num_chunks // ndev
    index = mesh.data_index
    if compute_dtype is not None:
        cfg = cfg.replace(compute_dtype=str(compute_dtype).removeprefix("torch."))
    kw = _model_apply_kwargs(cfg, mesh.device, inference=True)
    scan = lstm_scan_fn(use_kernel=kw["use_kernel"], compute_dtype=kw["compute_dtype"])

    @torch.no_grad()
    def fn(rnn_l1, rnn_l2, features: torch.Tensor, num_frames: torch.Tensor):
        B, T, D = features.shape
        if T % num_chunks:
            raise ValueError(f"{T} frames do not split into {num_chunks} chunks")
        chunk_len = T // num_chunks
        t_local = local_chunks * chunk_len
        # this rank's contiguous chunk slice, [B*local_chunks, chunk_len, D]
        x_local = features[:, index * t_local:(index + 1) * t_local]
        x_chunks = x_local.reshape(B * local_chunks, chunk_len, D)
        # the chunk ids are offset by the rank's first chunk: without it
        # every rank but the first would take the frame counts of chunk 0
        chunk_ids = index * local_chunks + torch.arange(
            local_chunks, dtype=torch.int32, device=features.device)
        seq_l1 = torch.clamp(
            num_frames.to(torch.int32)[:, None] - chunk_len * chunk_ids[None, :],
            0, chunk_len).reshape(B * local_chunks)
        l1_state = scan(rnn_l1, x_chunks, seq_l1).reshape(B, local_chunks, -1)
        l1_state = l1_state.to(torch.promote_types(l1_state.dtype, torch.float32))
        if ndev > 1:
            # ONE collective: every rank's block states, in chunk order
            parts = [torch.empty_like(l1_state) for _ in range(ndev)]
            dist.all_gather(parts, l1_state.contiguous(), group=mesh.group)
            l1_state = torch.cat(parts, dim=1)  # [B, num_chunks, S]
        seq_l2 = torch.ceil(num_frames.to(torch.float32) / float(chunk_len)
                            ).to(torch.int32)
        return scan(rnn_l2, l1_state, seq_l2)

    return fn
