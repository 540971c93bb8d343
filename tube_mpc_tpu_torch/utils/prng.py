"""jax.random's threefry2x32 draws, as the JAX package makes them, on tensors (a copy of
what the package calls from jax/_src/prng.py and jax/_src/random.py: ``PRNGKey``,
``split``, ``uniform``, and the hash ``threefry_2x32``; JAX 0.9.0, whose
jax_threefry_partitionable flag is on by default).

A key is an int64 tensor [..., 2] holding two unsigned 32-bit words. A leading batch of
keys draws what jax.vmap over those keys draws, in one call. Every word is held in int64
and every sum and shift is masked back to 32 bits (torch's uint32 has no shifts on the
CPU). Draws are made on the key's device; they are integer arithmetic up to one bitcast,
a subtraction of 1 and the affine map to [minval, maxval), so they are bitwise the same on
every device.
"""
from __future__ import annotations

import math
from typing import Tuple, Union

import torch
from torch import Tensor

from ..device import DeviceLike

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA                              # threefry's key-schedule constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Shape = Union[int, Tuple[int, ...]]


def PRNGKey(seed: int, device: DeviceLike = None) -> Tensor:
    """jax.random.PRNGKey(seed) -> [2]: the seed's 64 bits as (high word, low word), a
    negative seed in two's complement (JAX's threefry_seed on a 64-bit seed; a seed in
    [0, 2**31) gives the same key with or without jax_enable_x64)."""
    seed = int(seed)
    if not -2 ** 63 <= seed < 2 ** 63:
        raise OverflowError(f"PRNGKey takes a 64-bit seed, not {seed}")
    return torch.tensor([(seed >> 32) & MASK32, seed & MASK32], dtype=torch.int64,
                        device=device)


def _hash(k1: Tensor, k2: Tensor, x0: Tensor, x1: Tensor) -> Tuple[Tensor, Tensor]:
    """The threefry2x32 block (20 rounds, five key injections) of the words (x0, x1) under
    the key words (k1, k2), all broadcast together (jax/_src/prng.py's
    _threefry2x32_lowering, unrolled)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    x0, x1 = torch.broadcast_tensors(x0, x1)
    x0, x1 = x0.contiguous(), x1.contiguous()
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(MASK32)
            x1 = ((x1 << r) | (x1 >> (32 - r))).bitwise_and_(MASK32).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(MASK32)
        x1.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(MASK32)
    return x0, x1


def _key_words(key: Tensor, rank: int) -> Tuple[Tensor, Tensor]:
    """A key batch's two words, shaped to broadcast against `rank` trailing dims."""
    lead = key.shape[:-1] + (1,) * rank
    return key[..., 0].reshape(lead), key[..., 1].reshape(lead)


def _shape(num: Shape) -> Tuple[int, ...]:
    return (int(num),) if isinstance(num, int) else tuple(int(n) for n in num)


def _words(key: Tensor, shape: Tuple[int, ...]) -> Tuple[Tensor, Tensor]:
    """The partitionable path's two hashed words for each element of `shape`: the hash of
    (high, low) word of the element's flat index (jax/_src/prng.py's iota_2x32_shape)
    -> two int64 tensors [*key.shape[:-1], *shape]."""
    index = torch.arange(math.prod(shape), dtype=torch.int64, device=key.device).reshape(shape)
    return _hash(*_key_words(key, len(shape)), index >> 32, index & MASK32)


def threefry_2x32(key: Tensor, count: Tensor) -> Tensor:
    """jax._src.prng.threefry_2x32(key, count): the hash of the flat counts' first half
    against their second half (padded with a 0 to an even size), concatenated
    -> [*key.shape[:-1], *count.shape] words."""
    flat = count.reshape(-1).to(torch.int64)
    n = flat.numel()
    if n % 2:
        flat = torch.cat([flat, flat.new_zeros(1)])
    x0, x1 = flat.to(key.device).chunk(2)
    y0, y1 = _hash(*_key_words(key, 1), x0, x1)
    return torch.cat([y0, y1], dim=-1)[..., :n].reshape(key.shape[:-1] + tuple(count.shape))


def split(key: Tensor, num: Shape = 2) -> Tensor:
    """jax.random.split(key, num) -> [*key.shape[:-1], *num, 2]: key i is the hash of
    i's two words (the partitionable _threefry_split)."""
    return torch.stack(_words(key, _shape(num)), dim=-1)


def uniform(key: Tensor, shape: Shape = (), dtype: torch.dtype = torch.float32,
            minval=0.0, maxval=1.0) -> Tensor:
    """jax.random.uniform(key, shape, dtype, minval, maxval) for float32 and float64
    -> [*key.shape[:-1], *shape]: the high mantissa bits of 32 random bits (the two words
    xor'ed) or of 64 (the two words joined) under the exponent of 1.0, minus 1, then
    max(minval, u * (maxval - minval) + minval), each operation rounded on its own. (XLA's
    CPU compiler fuses that product and sum into one multiply-add inside the jitted
    jax.random.uniform; the two agree where maxval - minval is a power of two, as for the
    default [0, 1).)"""
    shape = _shape(shape)
    y0, y1 = _words(key, shape)
    if dtype == torch.float32:
        bits = ((y0 ^ y1) >> 9) | 0x3F800000                     # 23 mantissa bits
        floats = bits.to(torch.int32).view(torch.float32)
    elif dtype == torch.float64:
        bits = (y0 << 20) | (y1 >> 12) | 0x3FF0000000000000      # 52 mantissa bits
        floats = bits.view(torch.float64)
    else:
        raise TypeError(f"uniform draws float32 or float64, not {dtype}")
    floats = floats - 1.0
    lo = torch.as_tensor(minval, dtype=dtype, device=key.device)
    hi = torch.as_tensor(maxval, dtype=dtype, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)
