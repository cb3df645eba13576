"""Seeds derived from a run's ``--seed``, one stream a purpose, so that the
same seed gives the same inputs whatever else a run draws."""

from __future__ import annotations

import numpy as np


def derive(seed: int, *purpose) -> int:
    """A 63-bit seed for ``purpose`` (strings and ints) under ``seed``,
    which may be any whole number, negative or past 64 bits."""
    words = [int(seed) % (1 << 64) >> 32, int(seed) % (1 << 32)]
    for p in purpose:
        if isinstance(p, str):
            words += list(p.encode())
        else:
            words.append(int(p) % (1 << 32))
    hi, lo = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(hi) << 31) ^ int(lo)


def numpy_rng(seed: int, *purpose) -> np.random.Generator:
    return np.random.default_rng(derive(seed, *purpose))
