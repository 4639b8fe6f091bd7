"""Seeds of the run's parts, each drawn from the run's `--seed` and a key."""

from __future__ import annotations

import zlib

import numpy as np


def derive(seed: int, *keys) -> int:
    """A seed below 2**62 for (seed, keys); strings are keyed by CRC-32."""
    words = [int(seed) % (1 << 64)]
    words += [zlib.crc32(k.encode()) if isinstance(k, str) else int(k) % (1 << 32) for k in keys]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 30) ^ int(state[1])
