"""The JAX package's random numbers in torch: `jax.random.PRNGKey`,
`split`, `fold_in`, `uniform`, `bernoulli` and `normal` of the default
threefry2x32 implementation (with `jax_threefry_partitionable`, the
default since JAX 0.5).

The port draws its initial weights, its dropout masks and DBoF's frame
samples from these, so that a `--seed` gives the same init and the same
masks in both packages and a run of the port can be held against the
JAX package's. Keys, splits, folds and uniform draws are bit for bit;
`normal` evaluates XLA's single-precision ErfInv polynomial and agrees
with `jax.random.normal` to 3 ulp (bit for bit on about 99.5% of draws;
the rest is the rounding of `log`).

A key is a pair of Python ints, the two uint32 words of the JAX key
array, or a pair of 0-d int64 tensors holding them when it was folded
with a tensor (`fold_in` of a device value): such a key stays on its
device and draws there without a host sync. The hash runs on int64
tensors masked to 32 bits, on the device the result is wanted on.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any, List, Sequence, Tuple, Union

import torch

Key = Tuple[Any, Any]  # two ints, or two 0-d int64 tensors

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


def threefry2x32(key: Key, x0, x1):
    """The Threefry-2x32 hash of the count pairs (x0, x1) (int64 tensors
    holding uint32 values, or Python ints) under `key`, 20 rounds, as JAX
    lowers it."""
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


def _key_device(key: Key, device=None):
    """The device a tensor key lives on (else `device`)."""
    return key[0].device if isinstance(key[0], torch.Tensor) else device


def split(key: Key, num: int = 2) -> List[Key]:
    """`jax.random.split(key, num)`: key i hashes the count pair (0, i).
    A tensor key splits into tensor keys on its device; an int key is
    hashed in Python ints (no tensor work on the host per train step)."""
    if not isinstance(key[0], torch.Tensor):
        return [threefry2x32(key, 0, i) for i in range(num)]
    device = key[0].device
    b0, b1 = threefry2x32(key, torch.zeros(num, dtype=torch.int64, device=device),
                          torch.arange(num, dtype=torch.int64, device=device))
    return list(zip(b0.unbind(), b1.unbind()))


def fold_in(key: Key, data: Union[int, torch.Tensor]) -> Key:
    """`jax.random.fold_in(key, data)`: the hash of the count pair
    (0, uint32(data)), which is also key `data` of a partitionable split.
    `data` is an int or a 0-d integer tensor. With a tensor (or a tensor
    key) the key is a pair of 0-d tensors on its device, so a value the
    device computed (the eval keys fold in `sum(num_frames)`) needs no
    host sync."""
    if not (isinstance(data, torch.Tensor) or isinstance(key[0], torch.Tensor)):
        return threefry2x32(key, 0, int(data) & _MASK)
    device = data.device if isinstance(data, torch.Tensor) else key[0].device
    word = torch.as_tensor(data, device=device).to(torch.int64).reshape(()) & _MASK
    return threefry2x32(key, torch.zeros_like(word), word)


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
    device = _key_device(key, device)
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


def bernoulli(key: Key, p, shape: Sequence[int], device=None) -> torch.Tensor:
    """`jax.random.bernoulli(key, p, shape)` for a float32 `p` (a float or
    a 0-d tensor): ``uniform(key, shape, 0, 1) < p``."""
    return uniform(key, shape, 0.0, 1.0, device) < p


# (index, count) while a rank's rows are slice `index` of `count` equal
# slices of the global batch (`global_batch_rows`)
_ROWS: contextvars.ContextVar = contextvars.ContextVar("prng_rows", default=None)


@contextlib.contextmanager
def global_batch_rows(index: int, count: int):
    """Inside, `batch_uniform` draws for the global batch of `count`
    equal slices and returns slice `index`: the masks and frame samples a
    tensor-parallel step draws, as the JAX package's GSPMD program draws
    them for its whole batch (no device index folded in)."""
    token = _ROWS.set((index, count))
    try:
        yield
    finally:
        _ROWS.reset(token)


def batch_uniform(key: Key, shape: Sequence[int], minval: float, maxval: float,
                  device=None) -> torch.Tensor:
    """`uniform` of a draw whose first axis is the batch: the draw itself,
    or inside `global_batch_rows` this rank's rows of the global batch's
    draw."""
    rows = _ROWS.get()
    if rows is None:
        return uniform(key, shape, minval, maxval, device)
    index, count = rows
    b = shape[0]
    full = uniform(key, (b * count, *shape[1:]), minval, maxval, device)
    return full[index * b:(index + 1) * b]


# XLA's single-precision ErfInv (M. Giles, "Approximating the erfinv
# function"): a polynomial in w - 2.5 where w = -log1p(-x*x) < 5, else in
# sqrt(w) - 3, Horner's rule with fused multiply-adds.
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)
# XLA's log1p below sqrt(2) - 1 (the Cephes rational form); log(1 + x) above
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)


def _fma(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """float32 a*b + c rounded once, as a fused multiply-add: the product
    of two float32 values is exact in float64."""
    return (a.double() * b.double() + c).float()


def _log1p(x: torch.Tensor) -> torch.Tensor:
    num = torch.zeros_like(x)
    den = torch.zeros_like(x)
    for cn, cd in zip(_LOG1P_NUM, _LOG1P_DEN):
        num, den = _fma(num, x, cn), _fma(den, x, cd)
    x2 = x * x
    small = x + _fma(torch.full_like(x, -0.5), x2, (x * x2) * (num / den))
    return torch.where(x.abs() < 0.41421356237309504880, small, torch.log(x + 1.0))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ErfInv (within 2 ulp of it; `torch.erfinv` is
    another approximation, up to 64 ulp away)."""
    w = -_log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_W_LT_5[0], _ERFINV_W_GE_5[0])
    for a, b in zip(_ERFINV_W_LT_5[1:], _ERFINV_W_GE_5[1:]):
        p = _fma(p, w, torch.where(lt, a, b).double())
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key: Key, shape: Sequence[int], device=None) -> torch.Tensor:
    """`jax.random.normal(key, shape, float32)`: ``sqrt(2) * erfinv(u)``
    with u uniform in [nextafter(-1, 0), 1)."""
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    u = uniform(key, shape, lo, 1.0, device)
    return torch.tensor(math.sqrt(2.0), dtype=torch.float32) * erf_inv(u)
