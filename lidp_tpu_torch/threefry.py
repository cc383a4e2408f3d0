"""The counter-based random stream of jax.random (threefry2x32, the
partitionable layout) in torch: the stream the JAX package's fix langevin
and fix temp/csld draw from, so the port gives the same trajectories.

A key is a pair of 32-bit words (k1, k2), held as Python ints: the keys of
a run (PRNGKey(seed), fold_in(key, step)) are derived on the host and cost
no device work.  The bits of a draw are computed on the caller's device, on
int64 tensors masked to 32 bits, the element at flat index i from the
counter pair (i >> 32, i & 0xFFFFFFFF) as jax's iota_2x32_shape lays it
out; a 32-bit draw is the xor of the two output words, a 64-bit draw the
first word above the second.  A float draw takes the top mantissa bits of
its width with the exponent of 1.0 and subtracts 1 (jax.random._uniform),
so the bits and the uniforms agree with jax.random's bit for bit on any
device.  normal goes through torch.erfinv, which differs from XLA's
erf_inv by at most ~3e-13 (float64) and ~6e-6 (float32) relative.
"""

from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, d):
    return ((x << d) | (x >> (32 - d))) & MASK32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash of 20 rounds (jax's _threefry2x32_lowering)
    of the key (k1, k2) on the counters (x1, x2): Python ints or int64
    tensors holding values in [0, 2^32).  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x1, x2


def prng_key(seed: int):
    """jax.random.PRNGKey(seed): the 64-bit seed's high and low words (a
    uint32 or non-negative int32 seed has high word 0; a negative int64
    seed is taken as its two's complement)."""
    seed = int(seed) % (1 << 64)
    return (seed >> 32, seed & MASK32)


def fold_in(key, data: int):
    """jax.random.fold_in(key, data), data taken as uint32: the hash of
    the counters (0, data)."""
    return threefry2x32(key[0], key[1], 0, int(data) & MASK32)


def split(key, num: int = 2):
    """jax.random.split(key, num) (the partitionable, fold-like split):
    key i is the hash of the counters (i >> 32, i & MASK32)."""
    out = []
    for i in range(num):
        out.append(threefry2x32(key[0], key[1], i >> 32, i & MASK32))
    return out


def _words(key, shape, device):
    """The two output words of every element of a draw of `shape`, as
    int64 tensors of that shape."""
    shape = tuple(int(s) for s in shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(key[0], key[1], idx >> 32, idx & MASK32)
    return b1.reshape(shape), b2.reshape(shape)


def random_bits(key, bit_width: int, shape, device="cpu"):
    """jax.random.bits(key, shape, uint32 | uint64) as an int64 tensor:
    the 32-bit values, or the 64-bit patterns in two's complement."""
    b1, b2 = _words(key, shape, device)
    if bit_width == 32:
        return b1 ^ b2
    if bit_width == 64:
        hi = b1 - ((b1 >> 31) << 32)      # the signed high word
        return (hi << 32) | b2
    raise ValueError(f"bit_width {bit_width}: 32 or 64")


def _unit_floats(key, shape, dtype, device):
    """The floats in [0, 1) of jax.random._uniform before its scaling:
    the draw's top nmant bits under the exponent of 1.0, less 1."""
    b1, b2 = _words(key, shape, device)
    if dtype == torch.float32:
        bits = ((b1 ^ b2) >> 9) | 0x3F800000
        f = bits.to(torch.int32).view(torch.float32)
    elif dtype == torch.float64:
        # the 64-bit draw (b1 << 32 | b2) shifted right by 12
        bits = (b1 << 20) | (b2 >> 12) | 0x3FF0000000000000
        f = bits.view(torch.float64)
    else:
        raise TypeError(f"uniform takes float32 or float64, not {dtype}")
    return f - 1.0


def uniform(key, shape, dtype=torch.float64, device="cpu", minval=0.0,
            maxval=1.0):
    """jax.random.uniform(key, shape, dtype, minval, maxval), bit for
    bit."""
    lo = torch.tensor(minval, dtype=dtype, device=device)
    hi = torch.tensor(maxval, dtype=dtype, device=device)
    f = _unit_floats(key, shape, dtype, device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def normal(key, shape, dtype=torch.float64, device="cpu"):
    """jax.random.normal(key, shape, dtype): sqrt(2) erfinv(u) of the
    uniform on (nextafter(-1, 0), 1)."""
    lo = torch.nextafter(torch.tensor(-1.0, dtype=dtype),
                         torch.tensor(0.0, dtype=dtype)).item()
    u = uniform(key, shape, dtype, device, minval=lo, maxval=1.0)
    return torch.erfinv(u) * torch.tensor(math.sqrt(2.0), dtype=dtype,
                                          device=device)
