"""JAX's threefry PRNG in PyTorch: the keys and draws of `jax.random`.

The JAX package draws its RANSAC samples from `jax.random` with the
threefry2x32 generator under `jax_threefry_partitionable=True` (JAX's
default) and 64-bit seeds (it enables x64). These functions reproduce
those bits exactly, so the port samples the same hypotheses as the JAX
package from the same `RansacConfig.seed`:

- `prng_key(seed)`: `jax.random.PRNGKey(seed)`, the pair
  [seed >> 32, seed & 0xFFFFFFFF] of the 64-bit seed;
- `split(key, n)`: `jax.random.split(key, n)`;
- `random_bits(key, shape)`: 32-bit `jax.random.bits`;
- `randint(key, shape, lo, hi)`: `jax.random.randint(..., dtype=int32)`,
  with `_randint`'s two-key higher/lower-bits construction and its
  clipping of the bounds.

A key is an int64 tensor whose last axis holds the two uint32 words;
`random_bits` hands out uint32 values in int64 as well (PyTorch's
uint32 lacks arithmetic on some backends). The hash itself runs on
int32 tensors holding the uint32 bit patterns: int32 add and left shift
wrap modulo 2^32 as uint32 arithmetic does, and a right shift is made
logical with a mask, so the chain moves 4 bytes a word. Keys are tiny
and stay on the host; the draws themselves are made on the device the
caller names, as a chain of elementwise ops over the output (the JAX
package computes them in XLA, not in a Pallas kernel).
"""

from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
I32_MIN, I32_MAX = -(2**31), 2**31 - 1


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """jax.random.PRNGKey(seed) for a 64-bit seed: (2,) int64 words."""
    s = int(seed) & (2**64 - 1)
    return torch.tensor([s >> 32, s & MASK], dtype=torch.int64, device=device)


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor):
    """The threefry2x32 hash of the counter pairs (x1, x2) under the key
    (k1, k2): 20 rounds with a key injection after every four
    (jax/_src/prng.py, _threefry2x32_lowering). k1, k2 are int64 tensors
    of uint32 values and x1, x2 int32 tensors of uint32 bit patterns, all
    broadcasting together; returns two int32 tensors of the broadcast
    shape holding the hash's uint32 bit patterns."""
    ks = [k.to(torch.int32) for k in (k1, k2, k1 ^ k2 ^ _KS_PARITY)]
    y0, y1 = torch.broadcast_tensors(x1 + ks[0], x2 + ks[1])
    y0, y1 = y0.contiguous(), y1.contiguous()
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            y0.add_(y1)
            high = torch.bitwise_right_shift(y1, 32 - r).bitwise_and_((1 << r) - 1)
            y1.bitwise_left_shift_(r).bitwise_or_(high)
            y1.bitwise_xor_(y0)
        y0.add_(ks[(i + 1) % 3])
        y1.add_(ks[(i + 2) % 3] + (i + 1))
    return y0, y1


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns as the int64 uint32 values they stand for."""
    return x.to(torch.int64).bitwise_and_(MASK)


def _iota_2x32(shape, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The row-major flat index of every element of `shape`, as its high
    and low 32-bit words in int32 (jax/_src/prng.py, iota_2x32_shape)."""
    flat = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    return (flat >> 32).to(torch.int32).reshape(shape), flat.to(torch.int32).reshape(shape)


def _words(key: torch.Tensor):
    if key.shape[-1:] != (2,) or key.dtype != torch.int64:
        raise ValueError(f"prng: a key is an int64 tensor (..., 2), got {key.dtype} {tuple(key.shape)}")
    return key[..., 0], key[..., 1]


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """jax.random.split(key, n): (n, 2) keys on the key's device."""
    k1, k2 = _words(key)
    hi, lo = _iota_2x32((n,), key.device)
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return torch.stack([_u32(b1), _u32(b2)], dim=-1)


def _bits_of_keys(keys: torch.Tensor, shape, device) -> torch.Tensor:
    """32-bit random bits of `shape` for each of the (K, 2) keys, in one
    hash over (K,) + shape: bits1 ^ bits2 of the threefry of the flat
    index (jax/_src/prng.py, _threefry_random_bits_partitionable), as
    int32 bit patterns."""
    hi, lo = _iota_2x32(shape, device)
    words = keys.to(device).reshape((keys.shape[0],) + (1,) * len(shape) + (2,))
    b1, b2 = threefry2x32(words[..., 0], words[..., 1], hi, lo)
    return b1.bitwise_xor_(b2)


def random_bits(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """jax.random.bits(key, shape) (uint32) as int64 values on `device`
    (default: the key's)."""
    shape = tuple(shape)
    return _u32(_bits_of_keys(key.reshape(1, 2), shape, device or key.device)[0])


def randint(key: torch.Tensor, shape, lo: int, hi: int, device=None) -> torch.Tensor:
    """jax.random.randint(key, shape, lo, hi, dtype=int32) on `device`
    (default: the key's): int32 values in [lo, hi).

    jax/_src/random.py _randint: two keys from split(key) give the
    higher and lower 32 random bits of each value; with span = hi - lo
    (1 where hi <= lo; one more where hi lies beyond int32, whose range
    is then taken up to its end) and m = (2^16 mod span)^2 mod span, in
    uint32 arithmetic, the value is lo + ((higher mod span) * m + lower
    mod span) mod span."""
    shape = tuple(shape)
    device = device or key.device
    out_of_range = hi > I32_MAX
    lo_c, hi_c = min(max(lo, I32_MIN), I32_MAX), min(max(hi, I32_MIN), I32_MAX)
    span = (hi_c - lo_c) & MASK
    if hi_c <= lo_c:
        span = 1
    elif out_of_range:
        span = (span + 1) & MASK
    if span == 0:
        raise ValueError("prng.randint: the full 32-bit range is not supported")
    mult = (2**16) % span
    mult = ((mult * mult) & MASK) % span
    bits = _bits_of_keys(split(key), shape, device)
    higher, lower = _u32(bits[0]), _u32(bits[1])
    off = higher.remainder_(span).mul_(mult).add_(lower.remainder_(span))
    off = off.bitwise_and_(MASK).remainder_(span)
    return off.add_(lo_c).to(torch.int32)
