"""JAX's threefry-2x32 random stream in integer torch ops.

The RANSAC gate draws its hypotheses with
``jax.random.uniform(fold_in(PRNGKey(seed), next_id), (K, N), float32)``.
End-to-end parity with ``eqvio_tpu`` needs the same hypotheses, so this
module reproduces those bits exactly: the Threefry-2x32 hash (20 rounds,
key schedule with parity constant 0x1BD11BDA), ``threefry_seed``,
``fold_in``, the partitionable ``random_bits`` layout (the default of the
jax 0.9 line: counts are the flat index split into high and low 32-bit
words, bits = hash_hi ^ hash_lo) and the float32 mantissa trick.

uint32 values are carried in int64 tensors and masked with ``& 0xFFFFFFFF``
(torch's uint32 lacks most arithmetic).  A key is an int64 tensor ``[2]``.
"""

from __future__ import annotations

import functools

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash of the counter pair ``(x1, x2)`` under key ``(k1, k2)``."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


@functools.cache
def prng_key(seed: int, device) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32- or 64-bit unsigned seed, built
    once per ``(seed, device)``: a frame step folds the device-side counter
    into it without a host-to-device copy.  Callers never write to it."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _M32, seed & _M32], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: hash the counter pair ``(0, data)`` (threefry_seed of a uint32)."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & _M32
    h1, h2 = threefry2x32(key[0], key[1], torch.zeros_like(data), data)
    return torch.stack([h1, h2])


def random_bits32(key: torch.Tensor, shape) -> torch.Tensor:
    """Partitionable 32-bit random bits of ``shape`` (int64 holding uint32)."""
    n = 1
    for s in shape:
        n *= int(s)
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[0], key[1], idx >> 32, idx & _M32)
    return (b1 ^ b2).reshape(tuple(shape))


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` in [0, 1).

    JAX bitcasts ``(bits >> 9) | 0x3F800000`` to a float in [1, 2) and
    subtracts 1; ``m * 2^-23`` with ``m = bits >> 9`` (23 bits, exact in
    float32) is that difference bit for bit, without the bitcast, which has
    no batching rule under ``torch.func.vmap`` in some torch releases."""
    bits = random_bits32(key, shape)
    return (bits >> 9).to(torch.float32) * (2.0 ** -23)
