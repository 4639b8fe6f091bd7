"""Chunk plans of one denoising pass, drawn from a numpy generator.

A frozen copy of TC-Light's `get_chunks` (VidToMe generate_utils): the frame
list is cut into chunks of `chunk_size` after a random first chunk of 1 to
`chunk_size` frames, reversed with probability 1/2, and ordered by
`chunk_ord` ("mix-k": a random 1/k of the chunks first, the rest in order).
Every plan has the same number of slots; a short chunk repeats its last
frame, and a slot past the last chunk is empty (frame 0, nothing valid).
The draws are made in this order from `rng`, so the same seed gives the
same plans as the program's sampler.
"""

from __future__ import annotations

import math

import numpy as np


def n_slots(n: int, chunk: int) -> int:
    return 1 if n <= 1 else 1 + math.ceil((n - 1) / chunk)


def chunk_plan(n: int, chunk: int, rng: np.random.Generator, chunk_ord: str,
               merge_global: bool) -> tuple[np.ndarray, np.ndarray]:
    """(indices, valid), both (slots, chunk)."""
    first = int(rng.integers(0, chunk)) + 1
    ids = list(range(n))
    chunks = [ids[:first]] + [ids[i:i + chunk] for i in range(first, n, chunk)]
    chunks = [c for c in chunks if c]
    if rng.random() > 0.5:
        chunks = chunks[::-1]
    if merge_global and chunk_ord != "seq":
        k = len(chunks)
        if chunk_ord == "rand":
            order = list(rng.permutation(k))
        else:
            div = float(chunk_ord.split("-")[1]) if "-" in chunk_ord else 3.0
            perm = list(rng.permutation(k))
            n_rand = int(k / div)
            tail = sorted(perm[n_rand:])
            if n_rand > 0:
                head = perm[:n_rand]
                if tail and abs(tail[-1] - head[-1]) < abs(tail[0] - head[-1]):
                    tail = tail[::-1]
                order = head + tail
            else:
                order = tail
        chunks = [chunks[i] for i in order]
    slots = n_slots(n, chunk)
    indices = np.zeros((slots, chunk), np.int64)
    valid = np.zeros((slots, chunk), bool)
    for s, c in enumerate(chunks):
        indices[s] = c + [c[-1]] * (chunk - len(c))
        valid[s, :len(c)] = True
    return indices, valid


def step_draws(n: int, chunk: int, rng: np.random.Generator, chunk_ord: str,
               merge_global: bool, global_rand: float):
    """One pass's plan and its per-slot draws: (indices, valid, randfs,
    flips)."""
    indices, valid = chunk_plan(n, chunk, rng, chunk_ord, merge_global)
    randfs = rng.integers(0, 4, size=len(indices))
    flips = rng.random(len(indices)) <= global_rand
    return indices, valid, randfs, flips


def yt_windows(n: int, win_size: int) -> tuple[int, list[int], list[int]]:
    """Overlapping temporal windows of the yt pass: (length, starts,
    overlap of each window with the one before)."""
    win = min(win_size, n)
    k = math.ceil((n - 1) / (win - 1)) if win > 1 else 1
    if k <= 1:
        return win, [0], [0]
    total = k * win - n
    ov = total // (k - 1)
    overlaps = [ov] * (k - 2) + [ov + total % (k - 1)]
    cum = np.cumsum(overlaps)
    return win, [0] + [(i + 1) * win - int(cum[i]) for i in range(k - 1)], overlaps
