"""The JAX package's random numbers in torch: `jax.random.PRNGKey`,
`split` and `uniform` of the default threefry2x32 implementation (with
`jax_threefry_partitionable`, the default since JAX 0.5), bit for bit.

The port draws its initial weights from these, so that a `--seed` gives
the same init in both packages and a run of the port can be held
against the JAX package's from the same weights.

A key is a pair of Python ints, the two uint32 words of the JAX key
array. The hash runs on int64 tensors masked to 32 bits, on the device
the result is wanted on.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

Key = Tuple[int, int]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# values hashed at a time, to bound the int64 temporaries
_CHUNK = 1 << 24


def prng_key(seed: int) -> Key:
    """`jax.random.PRNGKey(seed)` for a seed in int32 range: the high
    word is the seed's bits above 32 (none), the low word the seed."""
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is outside int32")
    return (0, seed & _MASK)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(key: Key, x0: torch.Tensor, x1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of the count pairs (x0, x1) (int64 tensors
    holding uint32 values) under `key`, 20 rounds, as JAX lowers it."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def split(key: Key, num: int = 2) -> List[Key]:
    """`jax.random.split(key, num)`: key i hashes the count pair (0, i)."""
    b0, b1 = threefry2x32(key, torch.zeros(num, dtype=torch.int64),
                          torch.arange(num, dtype=torch.int64))
    return list(zip(b0.tolist(), b1.tolist()))


def uniform(key: Key, shape: Sequence[int], minval: float, maxval: float,
            device=None) -> torch.Tensor:
    """`jax.random.uniform(key, shape, float32, minval, maxval)`: 32 random
    bits per value (element i hashes the count pair (i >> 32, i), and
    the two words are xored), the top 23 as the mantissa of a float in
    [1, 2), minus 1, scaled by (maxval - minval), plus minval, and
    clamped below at minval. XLA fuses the scale and the shift into one
    fused multiply-add; here the product is exact in float64 and the sum
    is rounded once there and once to float32."""
    n = math.prod(shape)
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    span = torch.tensor(maxval, dtype=torch.float32, device=device) - lo
    out = torch.empty(n, dtype=torch.float32, device=device)
    for start in range(0, n, _CHUNK):
        count = torch.arange(start, min(start + _CHUNK, n),
                             dtype=torch.int64, device=device)
        b0, b1 = threefry2x32(key, count >> 32, count & _MASK)
        one_two = (((b0 ^ b1) >> 9) | 0x3F800000).to(torch.int32)
        floats = one_two.view(torch.float32) - 1.0
        scaled = (floats.double() * span.double() + lo.double()).float()
        out[start:start + count.numel()] = torch.maximum(scaled, lo)
    return out.reshape(tuple(shape))
