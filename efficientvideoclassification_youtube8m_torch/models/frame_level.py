"""Frame-level models (port of the JAX package's models/frame_level.py):
the flagship `HierarchicalLstmModel`, `FrameLevelLogisticModel`,
`DbofModel` (with batch norm), `NetVLADModel` and `NeXtVLADModel`, and
the frame samplers and pooling they use; and three the port has and the
JAX package does not: `LstmModel`, the YouTube-8M starter's flat LSTM
baseline, `NeXtVLADGatedModel`, the published NeXtVLAD, and
`GatedNetVLADModel`, the 2017 challenge winner's Gated NetVLAD.
Each takes [B, T, D] frames and `num_frames` [B], and swallows the
keywords it does not read (the LSTM kernel switches among them).

The flagship: the reference runs one `dynamic_rnn` per chunk of frames sharing one
2-layer LSTM, stacks the chunk final states, and runs a second 2-layer
LSTM over them. Here the chunks are folded into the batch axis —
[B, T, D] -> [B*C, T/C, D] — so L1 is one scan whose recurrent product
has batch B*C, and L2 is one scan over the C stacked chunk states.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, Optional, Sequence

import torch
from torch import nn

from efficientvideoclassification_youtube8m_torch.models.base import (
    Params,
    dense,
    dense_init,
    dropout,
    gather_classes,
    get_model,
    glorot_uniform,
    head_input,
    l2_loss,
    linear,
    register_model,
)
from efficientvideoclassification_youtube8m_torch.ops import prng
from efficientvideoclassification_youtube8m_torch.ops.collectives import all_reduce_sum
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
from efficientvideoclassification_youtube8m_torch.utils import profiling


def _check_classifier(model: nn.Module, classifier: Optional[str]) -> None:
    if classifier is not None and classifier != model.classifier.name:
        raise ValueError(f"the module's classifier is a "
                         f"{model.classifier.name}, not {classifier}")


def lstm_scan_fn(use_kernel: bool = False, use_kernel_train: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
    """The stacked-LSTM scan of both levels: the differentiable train
    kernels (`use_kernel_train`), the forward-only bf16 kernel
    (`use_kernel`), or the plain scan in `compute_dtype`. Returns
    fn(layers, xs [B, T, D], seq_len [B]) -> final state."""
    if use_kernel_train:
        return multi_lstm_scan_train_fused
    if use_kernel:
        return multi_lstm_scan_fused
    return functools.partial(multi_lstm_scan, compute_dtype=compute_dtype)


@register_model("HierarchicalLstmModel", frame_level=True)
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
                 key: Optional[prng.Key] = None, device=None,
                 **_):
        super().__init__()
        state_dim = lstm_layers * 2 * lstm_cells
        self.vocab_size = vocab_size
        k1, k2, k3 = prng.split(key or prng.prng_key(0), 3)
        self.rnn_l1 = init_multi_lstm(k1, input_size, lstm_cells,
                                      lstm_layers, device)
        self.rnn_l2 = init_multi_lstm(k2, state_dim, lstm_cells,
                                      lstm_layers, device)
        self.classifier = get_model(classifier)(
            state_dim, vocab_size, key=k3, device=device,
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
        `compute_dtype`. The other keywords (`labels`,
        `dropout_keep_prob`, `rng`, the head's sizes) go to the head."""
        _check_classifier(self, classifier)
        B, T, D = model_input.shape
        if T % num_chunks:
            raise ValueError(f"{T} frames do not split into {num_chunks} chunks")
        chunk_len = T // num_chunks

        scan_fn = lstm_scan_fn(use_kernel, use_kernel_train, compute_dtype)

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
        l2_input = l1_state.reshape(B, num_chunks, -1).to(
            torch.promote_types(l1_state.dtype, torch.float32))
        seq_l2 = torch.ceil(
            num_frames.to(torch.float32) / float(chunk_len)).to(torch.int32)
        state = scan_fn(self.rnn_l2, l2_input, seq_l2)

        result = self.classifier(state, compute_dtype=compute_dtype,
                                 **classifier_kwargs)
        result["state"] = state
        return result


@register_model("LstmModel", frame_level=True)
class LstmModel(nn.Module):
    """The YouTube-8M starter code's frame-level LSTM baseline (Abu-El-Haija
    et al., arXiv:1609.08675; google/youtube-8m `frame_level_models.py`
    `LstmModel`): a `MultiRNNCell` of `lstm_layers` TF1
    `BasicLSTMCell(lstm_cells, forget_bias=1.0)` run by `dynamic_rnn` over
    every frame with `sequence_length=num_frames` (the state frozen past
    it), its final state into the video-level classifier. The state is the
    TF1.x starter's `state_is_tuple=False` layout, [c0, h0, c1, h1, ...]
    (layers x 2 x cells wide), which `HierarchicalLstmModel` inherits; later
    starter versions feed the top layer's h alone.

    One scan over the whole clip, no chunks: T dependent steps a layer.
    Returns {"state", "predictions", "regularization_loss"} like
    `HierarchicalLstmModel`, whose keywords it takes; it swallows
    `num_chunks`. Parameters: ``rnn.<layer>.{kernel,bias}``,
    ``classifier...``. Spans: `lstm.scan` around the stack (each layer's
    projection and scan), `lstm.head` around the classifier; on the
    forward-only kernel route the scan's wrapper counts its steps
    (`lstm.step_launches`, T a layer)."""

    def __init__(self, input_size: int, vocab_size: int,
                 lstm_cells: int = 1024, lstm_layers: int = 2,
                 classifier: str = "MoeModel",
                 classifier_kwargs: Optional[dict] = None,
                 key: Optional[prng.Key] = None, device=None, **_):
        super().__init__()
        k1, k2 = prng.split(key or prng.prng_key(0))
        self.rnn = init_multi_lstm(k1, input_size, lstm_cells, lstm_layers, device)
        self.classifier = get_model(classifier)(
            lstm_layers * 2 * lstm_cells, vocab_size, key=k2, device=device,
            **(classifier_kwargs or {}))

    def forward(self, model_input: torch.Tensor,  # [B, T, D]
                num_frames: torch.Tensor,  # [B]
                num_chunks: Optional[int] = None,
                classifier: Optional[str] = None,
                compute_dtype: torch.dtype = torch.float32,
                use_kernel: bool = False,
                use_kernel_train: bool = False,
                **classifier_kwargs) -> Dict[str, Any]:
        """The scans of `HierarchicalLstmModel.forward` (`lstm_scan_fn`):
        the train kernels (`use_kernel_train`), the forward-only bf16
        kernel (`use_kernel`), or the plain scan in `compute_dtype`. The
        other keywords go to the head."""
        _check_classifier(self, classifier)
        scan_fn = lstm_scan_fn(use_kernel, use_kernel_train, compute_dtype)
        with profiling.annotate("lstm.scan"):
            state = scan_fn(self.rnn, model_input, num_frames.to(torch.int32))
        with profiling.annotate("lstm.head"):
            result = self.classifier(state, compute_dtype=compute_dtype,
                                     **classifier_kwargs)
        result["state"] = state
        return result


@register_model("FrameLevelLogisticModel", frame_level=True)
class FrameLevelLogisticModel(nn.Module):
    """Mean-pool over the true frames -> sigmoid FC
    (frame_level_models.py:50-83); column-parallel under tensor
    parallelism, as the MoE head."""

    column_parallel = True

    def __init__(self, input_size: int, vocab_size: int,
                 key: Optional[prng.Key] = None, device=None, **_):
        super().__init__()
        self.fc = dense_init(input_size, vocab_size, key, device)

    def forward(self, model_input, num_frames, l2_penalty: float = 1e-8, **_):
        avg_pooled = (torch.sum(head_input(self, model_input), dim=1)
                      / num_frames.to(torch.float32)[:, None])
        out = torch.sigmoid(linear(self.fc, avg_pooled))
        out, l2 = gather_classes(self, out, l2_loss(self.fc.w))
        return {"predictions": out, "regularization_loss": l2_penalty * l2}


def _take_frames(model_input: torch.Tensor, frame_index: torch.Tensor):
    """model_input[b, frame_index[b, s]] -> [B, S, D]."""
    index = frame_index.to(torch.int64)[:, :, None]
    return torch.gather(model_input, 1,
                        index.expand(-1, -1, model_input.shape[2]))


def sample_random_frames(model_input, num_frames, num_samples: int,
                         rng: prng.Key):
    """Uniform random frame indices below num_frames
    (model_utils.py:39-58), drawn from `rng` as the JAX sampler draws."""
    u = prng.batch_uniform(rng, (model_input.shape[0], num_samples), 0.0, 1.0,
                           device=model_input.device)
    frame_index = (u * num_frames.to(torch.float32)[:, None]).to(torch.int32)
    return _take_frames(model_input, frame_index)


def sample_random_sequence(model_input, num_frames, num_samples: int,
                           rng: prng.Key):
    """A random contiguous window of num_samples frames
    (model_utils.py:11-36)."""
    nf = num_frames.to(torch.int32)
    offsets = torch.arange(num_samples, dtype=torch.int32,
                           device=model_input.device)[None, :]
    max_start = torch.clamp(nf - num_samples, min=0)
    u = prng.batch_uniform(rng, (model_input.shape[0], 1), 0.0, 1.0,
                           device=model_input.device)
    start = (u * (max_start + 1).to(torch.float32)[:, None]).to(torch.int32)
    frame_index = torch.minimum(start + offsets, nf[:, None] - 1)
    return _take_frames(model_input, frame_index)


def sample_even_frames(model_input, num_frames, num_samples: int):
    """Deterministic evenly spaced frame indices strictly below
    num_frames: the eval-time counterpart of sample_random_frames, which
    never reaches the padding rows (they stop being zero after batch
    norm and would enter DBoF's pooling)."""
    u = ((torch.arange(num_samples, dtype=torch.float32,
                       device=model_input.device) + 0.5) / num_samples)
    frame_index = (u[None, :] * num_frames.to(torch.float32)[:, None]
                   ).to(torch.int32)
    return _take_frames(model_input, frame_index)


def frame_pooling(frames: torch.Tensor, method: str) -> torch.Tensor:
    """average / max / none pooling over the frame axis
    (model_utils.py:60-83). `max` spreads its gradient evenly over ties,
    as the JAX reduction does."""
    if method == "average":
        return torch.mean(frames, dim=1)
    if method == "max":
        return torch.amax(frames, dim=1)
    if method == "none":
        return frames.reshape(-1, frames.shape[2])
    raise ValueError(f"Unrecognized pooling method: {method}")


def _bn_init(dim: int, device=None) -> Params:
    """slim.batch_norm's variables. The moving statistics are parameters,
    as they are leaves of the JAX params tree (with optimizer slots, in
    the checkpoints): they get a zero gradient and the train steps write
    the forward's new values over them after the update."""
    return Params(scale=torch.ones(dim, device=device),
                  offset=torch.zeros(dim, device=device),
                  moving_mean=torch.zeros(dim, device=device),
                  moving_var=torch.ones(dim, device=device))


def _bn_apply(p: Params, x: torch.Tensor, is_training: bool,
              momentum: float = 0.999, eps: float = 1e-3, group=None):
    """slim.batch_norm: the batch's mean and population variance in
    training (the moving averages decayed by `momentum` toward them),
    the moving statistics at inference. Returns (normalized, the new
    moving statistics by name, detached; empty at inference).

    With `group` (synced batch norm across data-parallel ranks, the JAX
    `axis_name`), the batch moments are averaged over the ranks inside
    the forward, in one differentiable all-reduce, so the normalization,
    its gradients and the moving averages are those of one program over
    the global batch (the ranks' batches are equal in size)."""
    if is_training:
        if group is not None:
            moments = torch.cat([torch.mean(x, dim=0),
                                 torch.mean(torch.square(x), dim=0)])
            moments = all_reduce_sum(moments, group) / torch.distributed.get_world_size(group)
            mean, mean_sq = moments.chunk(2)
            var = mean_sq - torch.square(mean)
        else:
            mean = torch.mean(x, dim=0)
            var = torch.var(x, dim=0, correction=0)
        new = {"moving_mean": momentum * p.moving_mean + (1 - momentum) * mean,
               "moving_var": momentum * p.moving_var + (1 - momentum) * var}
        new = {name: value.detach() for name, value in new.items()}
    else:
        mean, var, new = p.moving_mean, p.moving_var, {}
    inv = torch.rsqrt(var + eps)
    return (x - mean) * inv * p.scale + p.offset, new


@register_model("DbofModel", frame_level=True)
class DbofModel(nn.Module):
    """Deep Bag-of-Frames (frame_level_models.py:85-195): sample frames,
    BN -> cluster FC -> relu6 -> frame pooling -> hidden FC -> BN ->
    relu6 -> video-level classifier. In training the forward returns the
    batch-norm moving statistics it computed under "updated_stats"
    ({"input_bn.moving_mean": ..., ...}). The trunk runs in float32; the
    head gets `compute_dtype` and the other keywords."""

    def __init__(self, input_size: int, vocab_size: int,
                 cluster_size: int = 8192, hidden_size: int = 1024,
                 classifier: str = "MoeModel", add_batch_norm: bool = True,
                 classifier_kwargs: Optional[dict] = None,
                 key: Optional[prng.Key] = None, device=None, **_):
        super().__init__()
        k1, k2, k3, k4, k5 = prng.split(key or prng.prng_key(0), 5)
        self.add_batch_norm = add_batch_norm
        self.cluster = Params(w=(1.0 / math.sqrt(input_size)) * prng.normal(
            k1, (input_size, cluster_size), device))
        self.hidden1 = Params(w=(1.0 / math.sqrt(cluster_size)) * prng.normal(
            k2, (cluster_size, hidden_size), device))
        self.classifier = get_model(classifier)(
            hidden_size, vocab_size, key=k3, device=device,
            **(classifier_kwargs or {}))
        if add_batch_norm:
            self.input_bn = _bn_init(input_size, device)
            self.cluster_bn = _bn_init(cluster_size, device)
            self.hidden1_bn = _bn_init(hidden_size, device)
        else:
            # the no-BN variant (frame_level_models.py:150-162,175-187):
            # biases replace the norms, with the reference's stddevs
            self.cluster.register_parameter("b", nn.Parameter(
                (1.0 / math.sqrt(input_size)) * prng.normal(k4, (cluster_size,), device)))
            self.hidden1.register_parameter("b", nn.Parameter(
                0.01 * prng.normal(k5, (hidden_size,), device)))

    def forward(self, model_input, num_frames=None, iterations: int = 30,
                sample_random: bool = True, pooling_method: str = "max",
                classifier: Optional[str] = None,
                add_batch_norm: Optional[bool] = None,
                is_training: bool = True, rng: Optional[prng.Key] = None,
                bn_group=None, **classifier_kwargs) -> Dict[str, Any]:
        _check_classifier(self, classifier)
        if add_batch_norm is not None and add_batch_norm != self.add_batch_norm:
            raise ValueError(f"the module was built with add_batch_norm="
                             f"{self.add_batch_norm}")
        # the head gets its own dropout key; the sampling stream stays on
        # `rng` (JAX frame_level.py:333)
        cls_rng = None if rng is None else prng.fold_in(rng, 1)
        if rng is not None:
            sampler = sample_random_frames if sample_random else sample_random_sequence
            model_input = sampler(model_input, num_frames, iterations, rng)
        elif num_frames is not None:
            # eval: deterministic, still strictly below num_frames
            model_input = sample_even_frames(model_input, num_frames, iterations)
        max_frames, feature_size = model_input.shape[1], model_input.shape[2]
        x = model_input.reshape(-1, feature_size)

        updated = {}

        def norm(name, value):
            value, new = _bn_apply(getattr(self, name), value, is_training,
                                   group=bn_group)
            updated.update({f"{name}.{k}": v for k, v in new.items()})
            return value

        if self.add_batch_norm:
            x = norm("input_bn", x)
        act = linear(self.cluster, x)
        if self.add_batch_norm:
            act = norm("cluster_bn", act)
        act = torch.clamp(act, 0.0, 6.0)  # relu6
        act = frame_pooling(act.reshape(-1, max_frames, act.shape[-1]),
                            pooling_method)
        act = linear(self.hidden1, act)
        if self.add_batch_norm:
            act = norm("hidden1_bn", act)
        act = torch.clamp(act, 0.0, 6.0)
        result = self.classifier(act, rng=cls_rng, **classifier_kwargs)
        if updated:
            result["updated_stats"] = updated
        return result


def _frame_mask(num_frames, T: int, device=None) -> torch.Tensor:
    """[B, T, 1] float mask of the true frames."""
    t = torch.arange(T, dtype=torch.int32, device=device)[None, :]
    return (t < num_frames.to(torch.int32)[:, None]).to(torch.float32)[:, :, None]


def _l2_rows(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x * rsqrt(max(sum(x^2), 1e-12)) along `dim`."""
    return x * torch.rsqrt(torch.clamp(torch.sum(x * x, dim=dim, keepdim=True),
                                       min=1e-12))


def _vlad_tail(model: nn.Module, vlad: torch.Tensor, classifier_kwargs,
               reg_weights, l2_penalty: float) -> Dict[str, Any]:
    """Intra-normalize the [B, K, d] code per cluster, flatten, l2, hidden
    FC with relu, the head; the head's regularization plus the trunk's."""
    flat = _l2_rows(_l2_rows(vlad, 2).reshape(vlad.shape[0], -1), 1)
    act = torch.relu(linear(model.hidden, flat))
    result = model.classifier(act, **classifier_kwargs)
    result["regularization_loss"] = (
        result.get("regularization_loss", 0.0)
        + l2_penalty * sum(l2_loss(w) for w in reg_weights))
    return result


@register_model("NetVLADModel", frame_level=True)
class NetVLADModel(nn.Module):
    """NetVLAD aggregation (the reference stubs it,
    frame_level_models.py:341-347): soft-assign each true frame to K
    clusters, aggregate the assignment-weighted residuals to the cluster
    centers, intra-normalize per cluster, flatten, l2-normalize, hidden
    FC, video-level classifier. The trunk runs in float32 and consumes
    `l2_penalty` (the head keeps its own default)."""

    def __init__(self, input_size: int, vocab_size: int,
                 vlad_clusters: int = 64, hidden_size: int = 1024,
                 classifier: str = "MoeModel",
                 classifier_kwargs: Optional[dict] = None,
                 key: Optional[prng.Key] = None, device=None, **_):
        super().__init__()
        k1, k2, k3, k4 = prng.split(key or prng.prng_key(0), 4)
        self.assign = dense_init(input_size, vlad_clusters, k1, device)
        self.centers = nn.Parameter((1.0 / math.sqrt(input_size)) * prng.normal(
            k2, (vlad_clusters, input_size), device))
        self.hidden = dense_init(vlad_clusters * input_size, hidden_size, k3, device)
        self.classifier = get_model(classifier)(
            hidden_size, vocab_size, key=k4, device=device,
            **(classifier_kwargs or {}))

    def forward(self, model_input, num_frames, classifier: Optional[str] = None,
                l2_penalty: float = 1e-8, **classifier_kwargs) -> Dict[str, Any]:
        _check_classifier(self, classifier)
        T = model_input.shape[1]
        mask = _frame_mask(num_frames, T, model_input.device)  # [B, T, 1]
        assign = torch.softmax(linear(self.assign, model_input), dim=-1) * mask
        # vlad[b,k,d] = sum_t a[b,t,k] x[b,t,d] - (sum_t a[b,t,k]) c[k,d]
        weighted = torch.einsum("btk,btd->bkd", assign, model_input)
        a_sum = torch.sum(assign, dim=1)  # [B, K]
        vlad = weighted - a_sum[:, :, None] * self.centers[None]
        return _vlad_tail(self, vlad, classifier_kwargs,
                          (self.assign.w, self.hidden.w), l2_penalty)


@register_model("NeXtVLADModel", frame_level=True)
class NeXtVLADModel(nn.Module):
    """NeXtVLAD (Lin et al. 2018), a grouped, attention-gated NetVLAD
    (the reference stubs it, frame_level_models.py:349-355): expand D to
    expansion*D, split into G groups, a sigmoid attention per (frame,
    group), one soft assignment over K clusters shared by the groups
    (its logits [B, T, G, K], group-major, as the JAX weight columns
    are), grouped residuals aggregated into a [K, expansion*D/G] code,
    then as NetVLAD."""

    def __init__(self, input_size: int, vocab_size: int,
                 vlad_clusters: int = 64, expansion: int = 2, groups: int = 8,
                 hidden_size: int = 1024, classifier: str = "MoeModel",
                 classifier_kwargs: Optional[dict] = None,
                 key: Optional[prng.Key] = None, device=None, **_):
        super().__init__()
        if (expansion * input_size) % groups:
            raise ValueError(f"expansion {expansion} x input {input_size} does "
                             f"not split into {groups} groups")
        k1, k2, k3, k4, k5, k6 = prng.split(key or prng.prng_key(0), 6)
        expanded = expansion * input_size
        group_dim = expanded // groups
        self.groups = groups
        self.expand = dense_init(input_size, expanded, k1, device)
        self.attention = dense_init(expanded, groups, k2, device)
        self.assign = dense_init(expanded, groups * vlad_clusters, k3, device)
        self.centers = nn.Parameter((1.0 / math.sqrt(group_dim)) * prng.normal(
            k4, (vlad_clusters, group_dim), device))
        self.hidden = dense_init(vlad_clusters * group_dim, hidden_size, k5, device)
        self.classifier = get_model(classifier)(
            hidden_size, vocab_size, key=k6, device=device,
            **(classifier_kwargs or {}))

    def forward(self, model_input, num_frames, groups: Optional[int] = None,
                classifier: Optional[str] = None, l2_penalty: float = 1e-8,
                **classifier_kwargs) -> Dict[str, Any]:
        _check_classifier(self, classifier)
        if groups is not None and groups != self.groups:
            raise ValueError(f"the module has {self.groups} groups, not {groups}")
        B, T, _ = model_input.shape
        K, G = self.centers.shape[0], self.groups
        mask = _frame_mask(num_frames, T, model_input.device)  # [B, T, 1]
        x = linear(self.expand, model_input)  # [B, T, E]
        attn = torch.sigmoid(linear(self.attention, x)) * mask  # [B, T, G]
        assign = torch.softmax(linear(self.assign, x).reshape(B, T, G, K), dim=-1)
        a = assign * attn[:, :, :, None]  # [B, T, G, K]
        xg = x.reshape(B, T, G, x.shape[-1] // G)
        weighted = torch.einsum("btgk,btgd->bkd", a, xg)
        a_sum = torch.sum(a, dim=(1, 2))  # [B, K]
        vlad = weighted - a_sum[:, :, None] * self.centers[None]
        return _vlad_tail(self, vlad, classifier_kwargs,
                          (self.expand.w, self.assign.w, self.hidden.w), l2_penalty)


def _matmul(x: torch.Tensor, w: torch.Tensor, compute_dtype: torch.dtype
            ) -> torch.Tensor:
    """``x @ w`` (batched as `torch.matmul` batches) with a float32 result:
    float32 operands as `dense` multiplies them; otherwise both operands
    in `compute_dtype`, multiplied there (float32 accumulation, the
    product rounded to `compute_dtype`) and widened."""
    if compute_dtype == torch.float32:
        return dense(w, x)
    return torch.matmul(x.to(compute_dtype), w.to(compute_dtype)).to(torch.float32)


class _NeXtVLADBranch(nn.Module):
    """One feature's NeXtVLAD block (Lin, Xiao & Fan 2018, the authors'
    `NeXtVLAD.forward`): expand D to expansion*D, a sigmoid attention per
    (frame, group) masked to the true frames, batch-normed cluster logits
    [T, G*K] (no bias) softmaxed over K within each group, the
    assignment-weighted sum of each group's slice of the expanded frame
    less the cluster centers [F, K] times the summed weights, l2 over F
    for each cluster, flattened as [F, K] and batch-normed."""

    def __init__(self, feature_size: int, clusters: int, groups: int,
                 expansion: int, key: prng.Key, device=None):
        super().__init__()
        wide = expansion * feature_size
        if wide % groups:
            raise ValueError(f"expansion {expansion} x feature {feature_size} "
                             f"does not split into {groups} groups")
        k1, k2, k3, k4 = prng.split(key, 4)
        self.groups, self.clusters = groups, clusters
        self.code_size = wide // groups * clusters
        self.expand = dense_init(feature_size, wide, k1, device)
        self.attention = dense_init(wide, groups, k2, device)
        self.cluster = dense_init(wide, groups * clusters, k3, device, use_bias=False)
        self.cluster_bn = _bn_init(groups * clusters, device)
        self.centers = nn.Parameter(glorot_uniform((wide // groups, clusters), k4, device))
        self.vlad_bn = _bn_init(self.code_size, device)

    def forward(self, x, mask, norm: Callable, name: str,
                compute_dtype: torch.dtype) -> torch.Tensor:
        """x [B, T, D], mask [B, T, 1] -> the code [B, F*K]; `norm(path,
        value)` applies the batch norm at `path` (`name.cluster_bn`, ...)."""
        B, T, _ = x.shape
        G, K = self.groups, self.clusters
        wide = (_matmul(x, self.expand.w, compute_dtype) + self.expand.b).to(compute_dtype)
        attn = torch.sigmoid(_matmul(wide, self.attention.w, compute_dtype)
                             + self.attention.b) * mask  # [B, T, G]
        logits = norm(f"{name}.cluster_bn",
                      _matmul(wide, self.cluster.w, compute_dtype).reshape(B * T, G * K))
        assign = (torch.softmax(logits.reshape(B, T * G, K), dim=-1)
                  * attn.reshape(B, T * G, 1))
        # v[f, k] = sum_{t,g} a[t,g,k] wide[t,g,f] - c[f, k] sum_{t,g} a[t,g,k]
        vlad = _matmul(assign.transpose(1, 2), wide.reshape(B, T * G, -1),
                       compute_dtype).transpose(1, 2)  # [B, F, K]
        vlad = vlad - torch.sum(assign, dim=1)[:, None, :] * self.centers
        return norm(f"{name}.vlad_bn", _l2_rows(vlad, 1).reshape(B, -1))


@register_model("NeXtVLADGatedModel", frame_level=True)
class NeXtVLADGatedModel(nn.Module):
    """The published NeXtVLAD (Lin, Xiao & Fan, ECCV 2018 Workshops,
    arXiv:1811.05014; the authors' `NeXtVLADModel`): one `_NeXtVLADBranch`
    for each of the two features (the first with `vlad_clusters` clusters
    and `groups` groups, the second with half of each), their codes
    concatenated, dropout of `drop_rate` in training, a hidden FC (no
    bias) with batch norm, SE context gating (an FC down by
    `gating_reduction` with batch norm and relu, an FC back up, a
    sigmoid, the product), then the video-level classifier. The defaults
    are the authors' published widths. The trunk adds no regularization
    loss (the authors' variables have no regularizer).

    Every product, the aggregation included, multiplies its operands in
    `compute_dtype`; sigmoids, softmaxes, batch norms and l2 norms run in
    float32. In training the batch norms use the batch's moments (the
    cluster logits' over every frame row, padding included, as the
    authors' code does) and the forward returns the new moving
    statistics under "updated_stats"; at inference they use the moving
    statistics."""

    def __init__(self, input_size: int, vocab_size: int,
                 feature_sizes: Optional[Sequence[int]] = None,
                 vlad_clusters: int = 128, groups: int = 8, expansion: int = 2,
                 hidden_size: int = 2048, gating_reduction: int = 8,
                 drop_rate: float = 0.5, classifier: str = "MoeModel",
                 classifier_kwargs: Optional[dict] = None,
                 key: Optional[prng.Key] = None, device=None, **_):
        super().__init__()
        sizes = list(feature_sizes or ())
        if len(sizes) != 2 or sum(sizes) != input_size:
            raise ValueError(f"NeXtVLADGatedModel needs two features (video, audio) "
                             f"summing to {input_size}, got {feature_sizes}")
        kv, ka, kh, kg1, kg2, kc = prng.split(key or prng.prng_key(0), 6)
        self.feature_sizes = tuple(sizes)
        self.drop_rate = drop_rate
        self.video = _NeXtVLADBranch(sizes[0], vlad_clusters, groups, expansion, kv, device)
        self.audio = _NeXtVLADBranch(sizes[1], vlad_clusters // 2, groups // 2, expansion,
                                     ka, device)
        squeezed = hidden_size // gating_reduction
        self.hidden = dense_init(self.video.code_size + self.audio.code_size, hidden_size,
                                 kh, device, use_bias=False)
        self.hidden_bn = _bn_init(hidden_size, device)
        self.gate1 = dense_init(hidden_size, squeezed, kg1, device, use_bias=False)
        self.gate_bn = _bn_init(squeezed, device)
        self.gate2 = dense_init(squeezed, hidden_size, kg2, device, use_bias=False)
        self.classifier = get_model(classifier)(
            hidden_size, vocab_size, key=kc, device=device,
            **(classifier_kwargs or {}))

    def forward(self, model_input, num_frames, classifier: Optional[str] = None,
                compute_dtype: torch.dtype = torch.float32, is_training: bool = True,
                rng: Optional[prng.Key] = None, **classifier_kwargs) -> Dict[str, Any]:
        """`rng` (training) draws the dropout mask; the head gets a key of
        its own."""
        _check_classifier(self, classifier)
        mask = _frame_mask(num_frames, model_input.shape[1], model_input.device)
        updated: Dict[str, torch.Tensor] = {}

        def norm(path, value):
            value, new = _bn_apply(self.get_submodule(path), value, is_training)
            updated.update({f"{path}.{k}": v for k, v in new.items()})
            return value

        split = self.feature_sizes[0]
        with profiling.annotate("nextvlad.video"):
            video = self.video(model_input[:, :, :split], mask, norm, "video", compute_dtype)
        with profiling.annotate("nextvlad.audio"):
            audio = self.audio(model_input[:, :, split:], mask, norm, "audio", compute_dtype)
        vlad = torch.cat([video, audio], dim=1)
        cls_rng = None
        if rng is not None:
            drop_rng, cls_rng = prng.split(rng)
            if is_training and self.drop_rate > 0:
                vlad = dropout(vlad, 1.0 - self.drop_rate, drop_rng)
        with profiling.annotate("nextvlad.gate"):
            act = self._gate(norm("hidden_bn", _matmul(vlad, self.hidden.w, compute_dtype)),
                             norm, compute_dtype)
        result = self.classifier(act, rng=cls_rng, compute_dtype=compute_dtype,
                                 is_training=is_training, **classifier_kwargs)
        if updated:
            result["updated_stats"] = updated
        return result

    def _gate(self, act, norm: Callable, compute_dtype: torch.dtype) -> torch.Tensor:
        """SE context gating: act sigmoid(relu(BN(act W_g1)) W_g2)."""
        gates = torch.relu(norm("gate_bn", _matmul(act, self.gate1.w, compute_dtype)))
        return act * torch.sigmoid(_matmul(gates, self.gate2.w, compute_dtype))


class _NetVLADBranch(nn.Module):
    """One feature's NetVLAD block (Willow's `NetVLAD.forward`,
    github.com/antoine77340/Youtube-8M-WILLOW `frame_level_models.py`):
    batch-normed cluster logits x W [T, K] (no bias) softmaxed over K and
    masked to the true frames, the assignment-weighted sum of the frames
    less the cluster centers [D, K] times the summed weights, l2 over D
    for each cluster, flattened as [D, K] and l2-normalised whole. The
    weights are drawn as Willow draws them: normal, stddev 1/sqrt(D)."""

    def __init__(self, feature_size: int, clusters: int, key: prng.Key, device=None):
        super().__init__()
        k1, k2 = prng.split(key)
        std = 1.0 / math.sqrt(feature_size)
        self.cluster = Params(w=std * prng.normal(k1, (feature_size, clusters), device))
        self.cluster_bn = _bn_init(clusters, device)
        self.centers = nn.Parameter(std * prng.normal(k2, (feature_size, clusters), device))
        self.code_size = feature_size * clusters

    def forward(self, x, mask, norm: Callable, name: str,
                compute_dtype: torch.dtype) -> torch.Tensor:
        """x [B, T, D] (after the input batch norm), mask [B, T, 1] -> the
        code [B, D*K]; `norm(path, value)` applies the batch norm at
        `path`."""
        B, T, _ = x.shape
        K = self.centers.shape[1]
        x = x.to(compute_dtype)  # one cast for both products
        logits = norm(f"{name}.cluster_bn",
                      _matmul(x, self.cluster.w, compute_dtype).reshape(B * T, K))
        assign = torch.softmax(logits, dim=-1).reshape(B, T, K) * mask
        # v[d, k] = sum_t a[t, k] x[t, d] - c[d, k] sum_t a[t, k]
        vlad = _matmul(assign.transpose(1, 2), x, compute_dtype).transpose(1, 2)
        vlad = vlad - torch.sum(assign, dim=1)[:, None, :] * self.centers
        return _l2_rows(_l2_rows(vlad, 1).reshape(B, -1), 1)


@register_model("GatedNetVLADModel", frame_level=True)
class GatedNetVLADModel(nn.Module):
    """Gated NetVLAD (Miech, Laptev & Sivic, Learnable pooling with Context
    Gating for video classification, arXiv:1706.06905; Willow's
    `NetVLADModelLF` with `willow_MoeModel`, the 2017 YouTube-8M
    challenge's winning single model): an input batch norm over every
    frame's features, one `_NetVLADBranch` for each of the two features
    (the first with `vlad_clusters` clusters, the second with half),
    their codes concatenated, a hidden FC with a bias (Willow's
    `netvlad_relu` False: no batch norm, no relu6), context gating
    (Willow's `gating`: act sigmoid(BN(act W_g))), the video-level
    classifier, and probability gating of its predictions
    (`moe_prob_gating`: p sigmoid(BN(p W_p))); both gates are always on.
    The classifier's input is the distillation "state" (`cli.validate`'s
    L_REP). The defaults are the published widths (the README's Gated
    NetVLAD command; `add_batch_norm` at Willow's default, True). The
    trunk adds no regularization loss.

    One departure: Willow draws `iterations` frames uniformly with
    replacement at eval too; here eval sums over every true frame, masked.
    The sum over the true frames is the expectation of the sum over the
    draws, up to a factor a video that the intra-normalisation removes,
    and it is deterministic. In training (`is_training` with `rng`) the
    forward draws `iterations` frames as Willow does
    (`sample_random_frames`; the step passes `--iterations`, which the
    README's command sets to 300), and the batch norms use the batch's
    moments over those rows (over every frame row, padding included,
    without `rng`) and return the new moving statistics under
    "updated_stats".

    Every product, the aggregation included, multiplies its operands in
    `compute_dtype`; softmaxes, sigmoids, batch norms and l2 norms run in
    float32."""

    def __init__(self, input_size: int, vocab_size: int,
                 feature_sizes: Optional[Sequence[int]] = None,
                 vlad_clusters: int = 256, hidden_size: int = 1024,
                 classifier: str = "MoeModel", classifier_kwargs: Optional[dict] = None,
                 key: Optional[prng.Key] = None, device=None, **_):
        super().__init__()
        sizes = list(feature_sizes or ())
        if len(sizes) != 2 or sum(sizes) != input_size:
            raise ValueError(f"GatedNetVLADModel needs two features (video, audio) "
                             f"summing to {input_size}, got {feature_sizes}")
        kv, ka, kh, kb, kg, kp, kc = prng.split(key or prng.prng_key(0), 7)
        self.feature_sizes = tuple(sizes)
        self.input_bn = _bn_init(input_size, device)
        self.video = _NetVLADBranch(sizes[0], vlad_clusters, kv, device)
        self.audio = _NetVLADBranch(sizes[1], vlad_clusters // 2, ka, device)
        codes = self.video.code_size + self.audio.code_size
        # Willow's initialisers: normal, these stddevs
        self.hidden = Params(
            w=(1.0 / math.sqrt(vlad_clusters)) * prng.normal(kh, (codes, hidden_size), device),
            b=0.01 * prng.normal(kb, (hidden_size,), device))
        self.gate = Params(w=(1.0 / math.sqrt(hidden_size)) * prng.normal(
            kg, (hidden_size, hidden_size), device))
        self.gate_bn = _bn_init(hidden_size, device)
        self.classifier = get_model(classifier)(
            hidden_size, vocab_size, key=kc, device=device, **(classifier_kwargs or {}))
        self.prob_gate = Params(w=(1.0 / math.sqrt(vocab_size)) * prng.normal(
            kp, (vocab_size, vocab_size), device))
        self.prob_gate_bn = _bn_init(vocab_size, device)

    def forward(self, model_input, num_frames, classifier: Optional[str] = None,
                compute_dtype: torch.dtype = torch.float32, is_training: bool = True,
                rng: Optional[prng.Key] = None, iterations: int = 300,
                **classifier_kwargs) -> Dict[str, Any]:
        """`rng` (training) draws `iterations` frames; the head gets a key
        of its own."""
        _check_classifier(self, classifier)
        cls_rng = None
        if rng is not None:
            sample_rng, cls_rng = prng.split(rng)
            if is_training:
                model_input = sample_random_frames(model_input, num_frames,
                                                   iterations, sample_rng)
                num_frames = torch.full_like(num_frames, iterations)
        B, T, D = model_input.shape
        mask = _frame_mask(num_frames, T, model_input.device)
        updated: Dict[str, torch.Tensor] = {}

        def norm(path, value):
            value, new = _bn_apply(self.get_submodule(path), value, is_training)
            updated.update({f"{path}.{k}": v for k, v in new.items()})
            return value

        split = self.feature_sizes[0]
        with profiling.annotate("gnetvlad.video"):
            x = norm("input_bn", model_input.reshape(B * T, D)).reshape(B, T, D)
            video = self.video(x[:, :, :split], mask, norm, "video", compute_dtype)
        with profiling.annotate("gnetvlad.audio"):
            audio = self.audio(x[:, :, split:], mask, norm, "audio", compute_dtype)
        with profiling.annotate("gnetvlad.hidden"):
            act = _matmul(torch.cat([video, audio], dim=1), self.hidden.w,
                          compute_dtype) + self.hidden.b
            act = act * self._gate("gate", act, norm, compute_dtype)
        with profiling.annotate("gnetvlad.head"):
            result = self.classifier(act, rng=cls_rng, compute_dtype=compute_dtype,
                                     is_training=is_training, **classifier_kwargs)
            p = result["predictions"]
            result["predictions"] = p * self._gate("prob_gate", p, norm, compute_dtype)
        result["state"] = act
        if updated:
            result["updated_stats"] = updated
        return result

    def _gate(self, name: str, act, norm: Callable, compute_dtype: torch.dtype
              ) -> torch.Tensor:
        """Willow's gates: sigmoid(BN(act W)), W and BN at `name`,
        `name`_bn."""
        w = getattr(self, name).w
        return torch.sigmoid(norm(f"{name}_bn", _matmul(act, w, compute_dtype)))
