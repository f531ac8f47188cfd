"""Counter-based random numbers, bit-equal to the JAX package's streams.

The tree path draws its bootstrap and its feature subsets, and the MLP
path its Glorot init, its epoch shuffles and its stochastic rounding,
through ``jax.random`` (threefry2x32 with ``jax_threefry_partitionable``
on, the default of the JAX the reference runs). ``torch.Generator`` cannot
give those streams, and the same fits need the same draws, so this module
is the port's explicit key-passing counterpart of the calls the paths make:

- ``PRNGKey(seed)``, ``fold_in(key, data)``, ``split(key, num)``;
- ``bits(key, shape)`` (the uint32 words of ``jax.random.bits``), and
  ``random_bits_each(keys, shapes)`` (several keys' draws in one pass);
- ``uniform(key, shape, minval, maxval)`` (f32 in [minval, maxval));
- ``randint(key, shape, minval, maxval)`` (int32, ``maxval`` may be a
  tensor, e.g. one bound per lane);
- ``permutation(key, n)`` (a shuffled ``arange(n)``).

A key is an int64 tensor of shape ``[..., 2]`` holding two 32-bit words;
leading dimensions batch independent keys. torch has few uint32
operations, so every word lives in int64 and is masked back to 32 bits
after each add and shift. Everything runs on the device of its inputs.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Union

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Key = torch.Tensor
IntLike = Union[int, torch.Tensor]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block cipher, 20 rounds (``jax._src.prng``'s
    ``_threefry2x32_lowering``), elementwise over broadcast int64 words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x1 + ks[0]) & _MASK
    x1 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def PRNGKey(seed: int, device=None) -> Key:
    """``jax.random.PRNGKey(seed)`` for a non-negative int seed."""
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"seed must be non-negative, got {seed}")
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK], dtype=torch.int64,
                        device=device)


def _words(key: Key):
    return key[..., 0], key[..., 1]


def _counter(shape: Sequence[int], device) -> torch.Tensor:
    """Row-major flat index of every element of ``shape`` (its low word;
    the high word is 0 for any shape this path draws)."""
    size = 1
    for s in shape:
        size *= int(s)
    return torch.arange(size, dtype=torch.int64, device=device).reshape(tuple(shape))


def fold_in(key: Key, data: IntLike) -> Key:
    """``jax.random.fold_in``: ``data`` may be an int or an integer tensor,
    which batches the result (``[*data.shape, 2]``)."""
    k1, k2 = _words(key)
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _MASK
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(d), d)
    return torch.stack([b1, b2], dim=-1)


def split(key: Key, num: int = 2) -> Key:
    """``jax.random.split`` (the partitionable layout): ``[..., num, 2]``."""
    k1, k2 = (w[..., None] for w in _words(key))
    lo = _counter((num,), key.device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: Key, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element (``threefry_random_bits``, partitionable
    form): ``[*key.shape[:-1], *shape]`` int64 in [0, 2^32)."""
    lead = key.shape[:-1]
    k1, k2 = (w.reshape(*lead, *([1] * len(shape))) for w in _words(key))
    lo = _counter(shape, key.device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return b1 ^ b2


def random_bits_each(keys: Key, shapes: Sequence[Sequence[int]]) -> List[torch.Tensor]:
    """``random_bits(keys[j], shapes[j])`` for every j, in one threefry pass
    over the concatenated counters (a key's counters are the flat indices
    of its own shape), so a step that draws for several tensors issues one
    pass instead of one each."""
    sizes = [math.prod(int(x) for x in s) for s in shapes]
    dev = keys.device
    owner = torch.repeat_interleave(torch.arange(len(sizes), device=dev),
                                    torch.tensor(sizes, device=dev))
    lo = torch.cat([torch.arange(n, dtype=torch.int64, device=dev) for n in sizes])
    b1, b2 = threefry2x32(keys[owner, 0], keys[owner, 1], torch.zeros_like(lo), lo)
    return [part.reshape(tuple(s)) for part, s in zip(torch.split(b1 ^ b2, sizes), shapes)]


def bits(key: Key, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``: the words of
    ``random_bits``, as int64 in [0, 2^32)."""
    return random_bits(key, shape)


def uniform(key: Key, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the top
    23 bits as the mantissa of a float in [1, 2), minus one, then JAX's
    affine map ``f * (maxval - minval) + minval`` floored at ``minval``.
    ``minval`` / ``maxval`` are rounded to f32 first, as JAX does. XLA fuses
    the map into one multiply-add rounded once; the product of two f32
    values and the sum are exact in f64, so one rounding of the f64 result
    to f32 gives the same bits."""
    word = (random_bits(key, shape) >> 9) | 0x3F800000
    floats = word.to(torch.int32).view(torch.float32) - 1.0
    if float(minval) == 0.0 and float(maxval) == 1.0:
        return floats  # the map is the identity on [0, 1)
    lo = torch.tensor(float(minval), dtype=torch.float32, device=floats.device)
    span = torch.tensor(float(maxval), dtype=torch.float32, device=floats.device) - lo
    mapped = (floats.double() * span.double() + lo.double()).float()
    return torch.maximum(lo, mapped)


def permutation(key: Key, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: JAX's ``_shuffle`` of
    ``arange(n)`` (int64 here). ``ceil(3 ln n / ln(2^32 - 1))`` rounds,
    each a ``split``, 32-bit sort keys from ``random_bits`` and a stable
    sort by key (``lax.sort_key_val`` is stable): 1 round up to n = 1,625,
    2 up to n = 2,642,245."""
    n = int(n)
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(_MASK)))
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    for _ in range(rounds):
        key, sub = split(key).unbind(-2)
        order = torch.sort(random_bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x


def randint(key: Key, shape: Sequence[int], minval: IntLike, maxval: IntLike) -> torch.Tensor:
    """``jax.random.randint`` for int32: two 32-bit draws folded modulo the
    span (JAX's construction, biased exactly as JAX's is). ``minval`` and
    ``maxval`` broadcast against ``shape``; a ``[L, 1]`` maxval gives one
    bound per lane over a shared stream."""
    k_hi, k_lo = split(key).unbind(-2)
    hi, lo = random_bits(k_hi, shape), random_bits(k_lo, shape)
    minval = torch.as_tensor(minval, dtype=torch.int64, device=key.device)
    maxval = torch.as_tensor(maxval, dtype=torch.int64, device=key.device)
    span = (maxval - minval) & _MASK
    span = torch.where(maxval <= minval, torch.ones_like(span), span)
    # uint32 products wrap: past a span of 2^16 the multiplier is 0
    mult = ((65536 % span) ** 2 & _MASK) % span
    offset = (((hi % span) * mult & _MASK) + lo % span) & _MASK
    return (minval + offset % span).to(torch.int32)
