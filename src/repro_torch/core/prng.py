"""Counter-based random numbers: the ``jax.random`` calls the reference makes.

The reference draws its §4.4 noise from ``jax.random`` keys (threefry2x32).
The port reproduces those draws from the same keys, so a noisy stack given
the reference's key perturbs the same codes and seeds the same ADC-noise
field. This module is the port's own copy of what that takes, from
``jax/_src/prng.py`` and ``jax/_src/random.py`` (jax 0.9, 32-bit mode, with
``jax_threefry_partitionable`` on, its default):

  * :func:`threefry2x32`: 20 rounds, rotations (13, 15, 26, 6) and
    (17, 29, 16, 24), a key injection every 4 rounds;
  * :func:`PRNGKey`: ``[0, seed mod 2^32]``, as ``jax.random.PRNGKey`` gives
    it with 64-bit mode off (the seed is taken as a 32-bit integer);
  * :func:`split`, :func:`bits`: the partitionable ("foldlike") scheme:
    element i of the output hashes the 64-bit counter i, split into its
    (hi, lo) words; ``split`` keeps both output words as the new key,
    ``bits`` their xor;
  * :func:`fold_in`: the hash of the counter pair (0, data);
  * :func:`randint`: int32 draws in [minval, maxval) from 64 bits a draw
    (the bits of both halves of a split key), reduced modulo the span as
    jax 0.9's ``_randint`` does it in uint32 arithmetic;
  * :func:`uniform`: the mantissa trick, ``(bits >> 9) | 0x3F800000`` read
    as a float in [1, 2), minus 1, scaled, then ``max(lo, .)``;
  * :func:`normal`: ``sqrt(2) * erfinv(uniform(nextafter(-1, 0), 1))``,
    with :func:`erfinv`, the single-precision polynomial of M. Giles
    ("Approximating the erfinv function", GPU Computing Gems, 2011) that
    XLA's ``erf_inv`` lowers to for float32.

Keys are int64 tensors of shape (2,) holding two uint32 words (a split
gives (n, 2)); there is no global generator state. Every uint32 value is
held in int64 and masked with ``0xFFFFFFFF`` after each add and shift:
PyTorch has no CPU ``>>`` on uint32. Bits, keys and uniforms are bit-exact
with ``jax.random`` on any device. Normals are not: torch's ``log1p``
and sums are not XLA's, so about 5% of the float32 draws differ, by at
most a few ulp (``torch.special.erfinv`` is further off: about 60% differ,
by up to ~2e-5). Callers that round normals to codes count the codes that
differ (ROADMAP, Queue C).
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_CHUNK = 1 << 22          # counters hashed per pass (bounds the temporaries)

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def threefry2x32(key: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor):
    """The threefry2x32 block cipher of counter words (x0, x1) under
    ``key``; all int64 tensors of uint32 values. Returns (y0, y1)."""
    k0, k1 = key[0], key[1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(M32)
            left = x1 << r
            x1.bitwise_right_shift_(32 - r).bitwise_or_(left) \
                .bitwise_and_(M32).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(M32)
        x1.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(M32)
    return x0, x1


def _hash_iota(key: torch.Tensor, n: int):
    """threefry2x32 of the 64-bit counters 0 .. n-1 as (hi, lo) words:
    (y0, y1), each (n,) int64. Hashed in chunks of ``_CHUNK`` counters."""
    y0 = torch.empty(n, dtype=torch.int64, device=key.device)
    y1 = torch.empty_like(y0)
    for start in range(0, n, _CHUNK):
        c = torch.arange(start, min(start + _CHUNK, n), dtype=torch.int64,
                         device=key.device)
        a, b = threefry2x32(key, c >> 32, c & M32)
        y0[start:start + c.numel()] = a
        y1[start:start + c.numel()] = b
    return y0, y1


def PRNGKey(seed: int, *, device=None) -> torch.Tensor:
    """The key ``jax.random.PRNGKey(seed)`` gives: [0, seed mod 2^32]."""
    if not isinstance(seed, (int, np.integer)) or isinstance(seed, bool):
        raise TypeError(f"PRNGKey takes an integer seed, got {seed!r}")
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64,
                        device=device)


def check_key(key: torch.Tensor) -> None:
    if (not isinstance(key, torch.Tensor) or key.dtype != torch.int64
            or key.shape != (2,)):
        raise ValueError("a key is a (2,) int64 tensor of uint32 words, got "
                         f"{getattr(key, 'dtype', type(key))} "
                         f"{tuple(getattr(key, 'shape', ()))}")


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: (num, 2) keys."""
    check_key(key)
    y0, y1 = _hash_iota(key, num)
    return torch.stack([y0, y1], dim=1)


def layer_keys(rng, n: int):
    """One key per layer: the rows of ``split(rng, n)``, or n Nones when
    ``rng`` is None (the clean path)."""
    return list(split(rng, n)) if rng is not None else [None] * n


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the hash of the counter (0, data)."""
    check_key(key)
    pair = torch.tensor([[0], [int(data) & M32]], dtype=torch.int64,
                        device=key.device)
    y0, y1 = threefry2x32(key, pair[0], pair[1])
    return torch.cat([y0, y1])


def bits(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``, as int64 values in
    [0, 2^32)."""
    check_key(key)
    shape = _shape(shape)
    y0, y1 = _hash_iota(key, math.prod(shape))
    return (y0 ^ y1).reshape(shape)


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod 2^32 of uint32 values held in int64: ``a`` split into its
    16-bit halves, so no partial product reaches 2^63."""
    lo = (a & 0xFFFF) * b
    hi = (((a >> 16) * b) & 0xFFFF) << 16
    return (lo + hi) & M32


def randint(key: torch.Tensor, shape: Shape, minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32), bit for
    bit, as int64 values: the two halves of ``split(key)`` give the high
    and low 32 bits of each draw, which is reduced modulo the span in
    uint32 arithmetic (the multiplier 2^32 mod span taken as
    (2^16 mod span)^2 mod span, the square wrapping at 2^32 as jax's does
    for spans past 2^16); maxval <= minval gives minval. Both
    bounds must be int32 values."""
    check_key(key)
    i32 = np.iinfo(np.int32)
    for v in (minval, maxval):
        if not i32.min <= int(v) <= i32.max:
            raise ValueError(f"randint: bound {v} is not an int32 value")
    shape = _shape(shape)
    span = (int(maxval) - int(minval)) & M32 if maxval > minval else 1
    mult = ((2 ** 16 % span) ** 2 & M32) % span
    k1, k2 = split(key)
    higher, lower = bits(k1, shape), bits(k2, shape)
    offset = (_mul32(higher % span, torch.full_like(higher, mult))
              + lower % span) & M32
    out = (int(minval) + offset % span) & M32
    return torch.where(out > i32.max, out - (1 << 32), out)


def uniform(key: torch.Tensor, shape: Shape = (), lo=0.0,
            hi=1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, lo, hi)``, bit for bit."""
    shape = _shape(shape)
    dev = key.device
    lo = torch.as_tensor(lo, dtype=torch.float32, device=dev)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=dev)
    mant = (bits(key, shape) >> 9) | 0x3F800000
    floats = mant.to(torch.int32).view(torch.float32) - 1.0
    return torch.maximum(lo, floats * (hi - lo) + lo)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


# Giles' coefficients, highest power first: w < 5 and w >= 5
_ERFINV_CENTRAL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                   -4.39150654e-06, 0.00021858087, -0.00125372503,
                   -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_TAIL = (-0.000200214257, 0.000100950558, 0.00134934322,
                -0.00367342844, 0.00573950773, -0.0076224613,
                0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 erfinv on (-1, 1): w = -log1p(-x^2); p(w - 2.5) for w < 5,
    else q(sqrt(w) - 3), each by Horner; times x."""
    w = -torch.log1p(-x * x)

    def horner(coefs, t):
        p = torch.full_like(t, coefs[0])
        for c in coefs[1:]:
            p = p * t + c
        return p

    # the sqrt correctly rounded on every device: torch's CPU sqrt calls
    # MKL's vmsSqrt, whose accuracy has depended on the state of its first
    # call in the process, so the CPU takes numpy's (the IEEE instruction)
    root = (torch.from_numpy(np.sqrt(w.numpy())) if w.device.type == "cpu"
            else torch.sqrt(w))
    p = torch.where(w < 5.0, horner(_ERFINV_CENTRAL, w - 2.5),
                    horner(_ERFINV_TAIL, root - 3.0))
    return p * x


def normal(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: the same uniforms, then
    ``sqrt(2) * erfinv(u)``."""
    u = uniform(key, shape, _NORMAL_LO, 1.0)
    return erfinv(u) * np.float32(np.sqrt(2))
