"""Checkpoint inspector (port of the JAX package's
cli/inspect_checkpoint.py).

Rebuild of the reference's `inspect_checkpoint_myfile.py`
(`print_tensors_in_checkpoint_file`): prints every tensor path, shape,
dtype and optionally values — from msgpack checkpoints (read by
`train/msgpack_io.py`, no flax) and from the reference's TF-V2 bundles
(read by `data/tf_checkpoint.py`, no TensorFlow). Orbax directories are
not ported and raise.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from efficientvideoclassification_youtube8m_torch.data.tf_checkpoint import (
    TFCheckpointReader,
    is_tf_checkpoint,
)
from efficientvideoclassification_youtube8m_torch.train import msgpack_io


def print_tensors_in_tf_checkpoint(
    prefix: str, tensor_name: str = "", all_tensors: bool = False
):
    """The reference tool's exact use case (inspect_checkpoint_myfile.py:
    21-34): enumerate a TF checkpoint, or dump one tensor by name."""
    if prefix.endswith(".index"):
        prefix = prefix[: -len(".index")]
    reader = TFCheckpointReader(prefix)
    for name, shape, dtype in reader.list_variables():
        if tensor_name and tensor_name not in name:
            continue
        print(f"tensor_name: {name}  shape: {list(shape)}  dtype: {dtype}")
        if all_tensors or tensor_name:
            print(reader.get_tensor(name))


def print_tensors_in_checkpoint_file(
    file_name: str, tensor_name: str = "", all_tensors: bool = False
):
    if is_tf_checkpoint(file_name):
        print_tensors_in_tf_checkpoint(file_name, tensor_name, all_tensors)
        return
    if os.path.isdir(file_name):
        raise NotImplementedError(
            f"{file_name} is an orbax checkpoint; orbax is not ported yet "
            "(ROADMAP Queue 1, parallel and orbax)")
    raw = msgpack_io.load(file_name)

    def walk(node, path=""):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}/{k}" if path else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")
        else:
            arr = np.asarray(node)
            if tensor_name and tensor_name not in path:
                return
            print(f"tensor_name: {path}  shape: {list(arr.shape)}  "
                  f"dtype: {arr.dtype}")
            if all_tensors or tensor_name:
                print(arr)

    walk(raw)


def main(argv=None):
    parser = argparse.ArgumentParser("Inspect a msgpack checkpoint")
    parser.add_argument("--file_name", required=True)
    parser.add_argument("--tensor_name", default="")
    parser.add_argument("--all_tensors", action="store_true")
    args = parser.parse_args(argv)
    print_tensors_in_checkpoint_file(
        args.file_name, args.tensor_name, args.all_tensors
    )


if __name__ == "__main__":
    main(sys.argv[1:])
