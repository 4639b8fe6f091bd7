"""Chunk-plan scheduler: the reference's random chunk layout as precomputed
fixed-shape index arrays (the port's own copy of
tclight_tpu/pipeline/chunks.py, so the same `np.random.default_rng(seed)`
gives the same plans, dst-frame choices and flips).

Rebuilds `get_chunks` (utils/VidToMe/generate_utils.py:174-205): per
denoising step the frame list is split into chunks of `chunk_size` with a
random first-chunk length, randomly reversed, then ordered seq/rand/mix.
Chunks are not ragged: every chunk is padded to
`chunk_size` (repeating its last frame) with a validity mask, and every step
uses the same fixed number of chunk slots — the same *distribution* of merge
patterns with fully static shapes (SURVEY §7.1).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["ChunkPlan", "make_chunk_plan"]


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    """One step's chunk layout.

    indices: (n_slots, chunk_size) int32 — frame ids, padded by repetition.
    valid:   (n_slots, chunk_size) bool — False on padding / empty slots.
    """

    indices: np.ndarray
    valid: np.ndarray

    @property
    def n_slots(self) -> int:
        return self.indices.shape[0]


def n_chunk_slots(n_frames: int, chunk_size: int) -> int:
    """Fixed slot count covering the worst-case split (rand_first=1)."""
    if n_frames <= 1:
        return 1
    return 1 + int(np.ceil((n_frames - 1) / chunk_size))


def _order_chunks(chunks: list[np.ndarray], chunk_ord: str, rng: np.random.Generator,
                  merge_global: bool) -> list[np.ndarray]:
    if not merge_global:
        return chunks
    n = len(chunks)
    if chunk_ord == "rand":
        order = rng.permutation(n)
    elif chunk_ord.startswith("mix"):
        perm_div = float(chunk_ord.split("-")[1]) if "-" in chunk_ord else 3.0
        randord = list(rng.permutation(n))
        rand_len = int(n / perm_div)
        seqord = sorted(randord[rand_len:])
        if rand_len > 0:
            randord = randord[:rand_len]
            if seqord and abs(seqord[-1] - randord[-1]) < abs(seqord[0] - randord[-1]):
                seqord = seqord[::-1]
            order = randord + seqord
        else:
            order = seqord
    else:  # "seq"
        order = list(range(n))
    return [chunks[i] for i in order]


def make_chunk_plan(
    n_frames: int,
    chunk_size: int,
    rng: np.random.Generator,
    chunk_ord: str = "mix-4",
    merge_global: bool = True,
) -> ChunkPlan:
    ids = np.arange(n_frames)
    rand_first = int(rng.integers(0, chunk_size)) + 1
    rest = ids[rand_first:]
    chunks = [ids[:rand_first]] + [
        rest[i : i + chunk_size] for i in range(0, len(rest), chunk_size)
    ]
    chunks = [c for c in chunks if len(c)]
    if rng.random() > 0.5:
        chunks = chunks[::-1]
    chunks = _order_chunks(chunks, chunk_ord, rng, merge_global)

    n_slots = n_chunk_slots(n_frames, chunk_size)
    indices = np.zeros((n_slots, chunk_size), np.int32)
    valid = np.zeros((n_slots, chunk_size), bool)
    for s, c in enumerate(chunks):
        indices[s, : len(c)] = c
        indices[s, len(c) :] = c[-1]  # pad by repeating the last frame
        valid[s, : len(c)] = True
    # empty slots keep index 0 / valid False
    return ChunkPlan(indices=indices, valid=valid)

