"""Embeddable serving API (port of the JAX package's serving.py).

Build a Predictor once from parameters, then call `predict` on uint8
frame batches:

    from efficientvideoclassification_youtube8m_torch.serving import Predictor
    p = Predictor(cfg, params, device="cuda")   # JAX-layout tree or module
    probs = p.predict(features_u8, num_frames)   # [B, 4716]
    vals, idx = p.predict_topk(features_u8, num_frames, k=20)

Serves the STUDENT (the paper's deliverable: ~10x fewer frames) by
default; `tower="teacher"` serves the teacher. In bf16 on a CUDA device
the LSTM recurrences run in the hand-written kernel
(ops/kernels/lstm_scan.py). `quantize="int8"` serves the int8 weight +
activation forward (ops/quantize.py): the weights are quantized once, at
construction, and on a CUDA device the recurrences run in the int8 kernel
(ops/kernels/lstm_scan_int8.py). Student requests are strided on the
host, so only 1/every_n of the uint8 bytes cross to the device.

Over a mesh (parallel/mesh.py; every rank builds the Predictor and sends
it the same request, and every rank returns the whole [B, vocab]):

    p = Predictor(cfg, params, device=dev, mesh=create_mesh(device=dev))
    p = Predictor(cfg, params, device=dev, sequence_parallel=True)

`mesh=` alone is data-parallel serving, bf16 or int8: each rank runs its
data index's rows of every padded serve_batch chunk and the rows are
gathered. `sequence_parallel=True` (bf16, the hierarchical model) splits
each video's chunks over the data axis
(parallel/sequence_parallel.py) and runs L2 and the head on every rank.
"""

from __future__ import annotations

from collections import deque
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from efficientvideoclassification_youtube8m_torch.ops.preprocess import (
    host_subsample,
    student_num_frames,
)
from efficientvideoclassification_youtube8m_torch.ops.quantize import (
    quantize_hierarchical_params,
    quantized_hierarchical_forward,
)
from efficientvideoclassification_youtube8m_torch.parallel.mesh import create_mesh
from efficientvideoclassification_youtube8m_torch.parallel.sequence_parallel import (
    build_sequence_parallel_state_fn,
)
from efficientvideoclassification_youtube8m_torch.train.step import (
    _model_apply_kwargs,
    forward_student,
    forward_teacher,
    preprocess_batch,
)
from efficientvideoclassification_youtube8m_torch.train.checkpoint import (
    latest_checkpoint,
    restore_subtree,
)
from efficientvideoclassification_youtube8m_torch.train.state import (
    DistillState,
    StudentState,
    init_model,
)
from efficientvideoclassification_youtube8m_torch.weights import load_jax_params
from efficientvideoclassification_youtube8m_torch.utils.config import TrainConfig


class Predictor:
    def __init__(self, cfg: TrainConfig, params_or_module, tower: str = "student",
                 serve_batch: int = 256, device="cuda", fetch_depth: int = 4,
                 mesh=None, sequence_parallel: bool = False,
                 quantize: str = "none"):
        if tower not in ("student", "teacher"):
            raise ValueError(f"tower must be 'student' or 'teacher', got {tower!r}")
        if quantize not in ("none", "int8"):
            raise ValueError(f"quantize must be 'none' or 'int8', got {quantize!r}")
        if quantize == "int8" and sequence_parallel:
            raise ValueError(
                "quantize='int8' + sequence_parallel is not supported")
        if sequence_parallel and cfg.model != "HierarchicalLstmModel":
            raise ValueError(
                "sequence-parallel serving requires HierarchicalLstmModel")
        self.cfg = cfg
        self.tower = tower
        self.serve_batch = serve_batch
        # in-flight dispatch depth of predict()'s chunk ring (lag-N)
        self.fetch_depth = fetch_depth
        self.device = torch.device(device)
        # student requests are strided on the HOST (predict below), so
        # only 1/every_n of the uint8 bytes cross the host->device edge
        self._host_stride = cfg.every_n if tower == "student" else 1
        self.model = self.qparams = None
        if quantize == "int8":
            self._init_int8(cfg, params_or_module, tower)
        elif isinstance(params_or_module, nn.Module):
            self.model = params_or_module.to(self.device).eval()
        else:
            self.model = load_jax_params(init_model(cfg, device=self.device),
                                         params_or_module).eval()
        self._state_fn = None
        if sequence_parallel:
            self.mesh = mesh if mesh is not None else create_mesh(device=self.device)
            self._init_sequence_parallel(cfg, tower)
        else:
            # data-parallel rows only where there is more than one data index
            self.mesh = mesh if mesh is not None and mesh.data > 1 else None
            if self.mesh is not None and serve_batch % self.mesh.data:
                raise ValueError(f"serve_batch {serve_batch} not divisible by "
                                 f"the data axis {self.mesh.data}")

    def _init_sequence_parallel(self, cfg: TrainConfig, tower: str):
        """The chunk-axis-split state (parallel/sequence_parallel.py) with
        the single-device routing of the recurrences; the head runs on
        every rank."""
        kw = _model_apply_kwargs(cfg, self.device, inference=True)
        self._state_fn = build_sequence_parallel_state_fn(
            cfg, self.mesh,
            num_chunks=(cfg.num_inputs_L1 if tower == "student"
                        else cfg.num_inputs_to_lstm))
        self._head_kw = {k: kw[k] for k in ("compute_dtype", "num_mixtures",
                                             "num_hidden_units") if k in kw}

    def _init_int8(self, cfg: TrainConfig, params_or_module, tower: str):
        """int8 weight+activation forward: both LSTM product sites and the
        MoE head run int8 x int8 -> int32; gate math stays f32. The
        weights are quantized ONCE here (per-channel scales) and live on
        the device as int8."""
        if (cfg.model != "HierarchicalLstmModel"
                or cfg.video_level_classifier_model != "MoeModel"):
            raise ValueError(
                "quantize='int8' covers the flagship "
                "HierarchicalLstmModel + MoeModel configuration")
        self._num_chunks = (cfg.num_inputs_L1 if tower == "student"
                            else cfg.num_inputs_to_lstm)
        self.qparams = quantize_hierarchical_params(
            params_or_module, cfg.total_feature_size, cfg.lstm_cells,
            cfg.lstm_layers, device=self.device)
        # the JAX rule with "tpu" read as "cuda"; like it, independent of
        # compute_dtype
        self._use_kernel = (cfg.use_pallas_inference
                            and self.device.type == "cuda")

    @classmethod
    def from_checkpoint(cls, train_dir: str, cfg: Optional[TrainConfig] = None,
                        tower: str = "student", serve_batch: int = 256,
                        device="cuda", **kwargs) -> "Predictor":
        """Serve the latest checkpoint of a finetune or distillation
        train_dir (this package's or the JAX package's). Finetune
        checkpoints carry only the student: asking one for the teacher
        raises ValueError."""
        cfg = cfg or TrainConfig()
        if tower not in ("student", "teacher"):
            raise ValueError(f"tower must be 'student' or 'teacher', got {tower!r}")
        ckpt = latest_checkpoint(train_dir)
        if ckpt is None:
            raise IOError(f"no checkpoint in {train_dir}")
        model = init_model(cfg, device=device)
        if tower == "teacher":
            template = DistillState(teacher=model, student=model, opt_teacher={},
                                    opt_student={}, global_step=0,
                                    dropout_keep_prob=cfg.dropout)
            try:
                restore_subtree(ckpt, template, ["params_teacher"])
            except (KeyError, ValueError) as e:
                raise ValueError(
                    f"{ckpt} is a student-only checkpoint; no teacher tower") from e
        else:
            restore_subtree(ckpt, StudentState(student=model, opt_student={},
                                               global_step=0,
                                               dropout_keep_prob=cfg.dropout),
                            ["params_student"])
        return cls(cfg, model, tower, serve_batch, device=device, **kwargs)

    def _rows(self, x: np.ndarray) -> np.ndarray:
        """This rank's data index's rows of a padded chunk (all of them
        without a data-parallel mesh)."""
        if self.mesh is None or self._state_fn is not None:
            return x
        n = x.shape[0] // self.mesh.data
        return x[self.mesh.data_index * n:(self.mesh.data_index + 1) * n]

    def _gather_rows(self, preds: torch.Tensor) -> torch.Tensor:
        """The data indices' rows of a chunk, in order, on every rank."""
        if self.mesh is None or self._state_fn is not None:
            return preds
        parts = [torch.empty_like(preds) for _ in range(self.mesh.data)]
        dist.all_gather(parts, preds.contiguous(), group=self.mesh.group)
        return torch.cat(parts)

    @torch.inference_mode()
    def _fwd(self, features_u8: np.ndarray, num_frames: np.ndarray
             ) -> torch.Tensor:
        cfg = self.cfg
        feats = torch.from_numpy(self._rows(features_u8)).to(self.device,
                                                             non_blocking=True)
        nf = torch.from_numpy(self._rows(num_frames)).to(self.device,
                                                         non_blocking=True)
        if self.tower == "student":
            # features arrive host-strided to every_n already
            nf = student_num_frames(nf, cfg.every_n, cfg.max_num_frames)
        xs = preprocess_batch(cfg, feats, nf)
        if self._state_fn is not None:
            state = self._state_fn(self.model.rnn_l1, self.model.rnn_l2, xs, nf)
            return self.model.classifier(state, **self._head_kw)["predictions"]
        if self.qparams is not None:
            preds = quantized_hierarchical_forward(
                self.qparams, xs, nf, self._num_chunks, cfg.num_classes,
                cfg.moe_num_mixtures, use_kernel=self._use_kernel)
        else:
            forward = forward_student if self.tower == "student" else forward_teacher
            preds = forward(cfg, self.model, xs, nf, inference=True)["predictions"]
        return self._gather_rows(preds)

    def predict(self, features_u8: np.ndarray, num_frames: np.ndarray
                ) -> np.ndarray:
        """features_u8 [B, max_frames, D] uint8, num_frames [B] ->
        probabilities [B, vocab] float32. Requests are cut into chunks of
        serve_batch rows, the last padded with num_frames=0.

        Chunks go through a lag-N ring: up to `fetch_depth` chunks stay
        launched on the device and only the oldest result is copied to
        the host, so host work on the next chunk overlaps device compute.
        FIFO drain keeps the output order."""
        B = features_u8.shape[0]
        if self._host_stride > 1:
            features_u8 = host_subsample(features_u8, self._host_stride)
        num_frames = np.asarray(num_frames)
        out = []
        ring: deque = deque()  # (device preds, valid row count)
        depth = max(1, self.fetch_depth)
        for start in range(0, B, self.serve_batch):
            chunk = np.ascontiguousarray(features_u8[start : start + self.serve_batch])
            nf = np.ascontiguousarray(num_frames[start : start + self.serve_batch])
            n = chunk.shape[0]
            if n < self.serve_batch:
                pad = self.serve_batch - n
                chunk = np.concatenate(
                    [chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)])
                nf = np.concatenate([nf, np.zeros(pad, nf.dtype)])
            ring.append((self._fwd(chunk, nf), n))
            # pop only when MORE than `depth` are in flight
            if len(ring) > depth:
                preds, rows = ring.popleft()
                out.append(preds[:rows].cpu().numpy())
        while ring:
            preds, rows = ring.popleft()
            out.append(preds[:rows].cpu().numpy())
        return np.concatenate(out, axis=0) if out else np.zeros(
            (0, self.cfg.num_classes), np.float32)

    def predict_topk(self, features_u8, num_frames, k: int = 20
                     ) -> Tuple[np.ndarray, np.ndarray]:
        probs = self.predict(features_u8, num_frames)
        idx = np.argpartition(probs, -k, axis=1)[:, -k:]
        rows = np.arange(probs.shape[0])[:, None]
        vals = probs[rows, idx]
        order = np.argsort(-vals, axis=1)
        return vals[rows, order], idx[rows, order]
