"""The single-process subset of the JAX package's parallel/distributed.py
(which imports jax, so it is ported, not imported): the multi-host guard,
the eval loops' host-pack decoding (`unpack_host_pack`) and their
per-batch row assembly (`gather_eval_rows`, `gather_step_outputs`).
Multi-host runs are ROADMAP Queue 1 item 13.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np


def _tf_config_processes() -> int:
    """The number of processes the reference's TF_CONFIG cluster spec
    names (train.py:710-718): its masters plus workers; 1 without one."""
    raw = os.environ.get("TF_CONFIG")
    if not raw:
        return 1
    cluster = json.loads(raw).get("cluster", {})
    return len(cluster.get("master", []) + cluster.get("worker", [])) or 1


def initialize() -> None:
    """The JAX package brings up its multi-host runtime here from
    TF_CONFIG or JAX's coordinator variables; the port runs one process
    and raises when the environment names a cluster."""
    if _tf_config_processes() > 1 or "JAX_COORDINATOR_ADDRESS" in os.environ:
        raise NotImplementedError(
            "multi-host runs (a TF_CONFIG cluster or JAX_COORDINATOR_ADDRESS) "
            "come with the parallel port (ROADMAP Queue 1 item 13)")


def _paired_k(m: int):
    """The k with k + ceil(k/2) == m (the paired-index pack's index+value
    lane count), or None. At most one k matches."""
    k = (2 * m) // 3
    for cand in (k, k + 1):
        if cand > 0 and cand + (cand + 1) // 2 == m:
            return cand
    return None


def unpack_host_pack(pack: np.ndarray, labels) -> Dict[str, Any]:
    """Split one packed eval buffer (train/step.py:_pack_host_outputs)
    back into its fields, as the JAX package's `unpack_host_pack` does.
    Self-describing across the two layouts:
      * paired: [B, k + ceil(k/2) + 2], two indices per f32 lane, sign bit
        set (a wide pack's index lanes are non-negative floats);
      * wide: [B, 2k + 2], one float-encoded index per lane."""
    m = pack.shape[1] - 2
    k = _paired_k(m)
    if k is not None:
        h = (k + 1) // 2
        words = np.ascontiguousarray(pack[:, k:k + h]).view(np.int32)
        if words.size and words[0, 0] >= 0:
            k = None  # a wide pack whose lane count aliases a paired one
        else:
            words = words & np.int32(0x3FFFFFFF)  # drop the marker bits
            idx = np.empty((pack.shape[0], 2 * h), np.int32)
            idx[:, 0::2] = words & 0xFFFF
            idx[:, 1::2] = words >> 16
            idx = idx[:, :k]
    if k is None:
        k = m // 2
        idx = pack[:, k:2 * k].astype(np.int32)
    return {
        "topk_val": pack[:, :k],
        "topk_idx": idx,
        "per_example_loss": pack[:, m],
        "perr_precision": pack[:, m + 1],
        "labels": labels,
    }


def gather_eval_rows(arrays: Dict[str, Any], pad: int) -> Dict[str, np.ndarray]:
    """The eval rows of one batch without its `pad` trailing padding rows
    (the single-process case of the JAX package's cross-host gather)."""
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    if pad:
        arrays = {k: v[: v.shape[0] - pad] for k, v in arrays.items()}
    return arrays


def gather_step_outputs(out: Dict[str, Any], labels, pad: int
                        ) -> Dict[str, np.ndarray]:
    """The eval binaries' per-batch assembly: the step's packed host
    bundle crosses to the host in ONE transfer and is unpacked, and the
    padding rows are dropped."""
    pack = out["host_pack"].cpu().numpy()
    return gather_eval_rows(unpack_host_pack(pack, labels), pad)
