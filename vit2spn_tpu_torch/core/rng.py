"""Seeded random streams (stands in for `vit2spn_tpu/core/rng.py`).

The JAX package folds one root key with (epoch, step, ...) so that every
draw is a function of the seed and where it happens. Here `fold` mixes the
seed and those integers into one 64-bit seed with splitmix64, and
`generator` makes a `torch.Generator` on the device from it. The draws are
other bits than JAX's, by design: tests that compare the two packages
switch the random parts off or feed both the same numbers.
"""

from __future__ import annotations

import torch

_MASK = (1 << 64) - 1

# what a stream is for, folded in last
AUGMENT = 0
DROPOUT = 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return x ^ (x >> 31)


def fold(seed: int, *data: int) -> int:
    """A 63-bit seed that depends on `seed` and every integer in `data`, in
    order."""
    h = _splitmix64(seed & _MASK)
    for d in data:
        h = _splitmix64(h ^ (d & _MASK))
    return h >> 1


def generator(device, seed: int, *data: int) -> torch.Generator:
    """A generator on `device` seeded from (seed, *data)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(fold(seed, *data))
    return gen
