"""Benchmark corpora, generated from a seed (nothing is downloaded).

* ``mixed_corpus``: text / low-entropy / random / RLE blocks in equal
  parts — the headline decode unit.
* ``markdown_corpus``: the repository's own ``SURVEY.md`` tiled, with a
  unique tag per block so blocks do not repeat: real prose, many short
  matches, no RAW or RLE blocks.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

SURVEY = Path(__file__).resolve().parents[2] / "SURVEY.md"


def mixed_corpus(nblocks: int, block: int, seed: int = 2026) -> bytes:
    rng = np.random.default_rng(seed)
    parts = []
    for i in range(nblocks):
        k = i % 4
        if k == 0:
            p = (b"The quick brown fox jumps over the lazy dog %d. " % i) * (
                block // 47 + 1)
        elif k == 1:
            p = rng.integers(0, 16, block, dtype=np.uint8).tobytes()
        elif k == 2:
            p = rng.integers(0, 256, block, dtype=np.uint8).tobytes()
        else:
            p = bytes([i & 0xFF]) * block
        parts.append(p[:block])
    return b"".join(parts)


def markdown_corpus(nblocks: int, block: int) -> bytes:
    base = SURVEY.read_bytes()
    reps = -(-(nblocks * block) // len(base))
    buf = bytearray((base * reps)[:nblocks * block])
    for i in range(nblocks):
        tag = b"[[blk %06d]]" % i
        buf[i * block:i * block + len(tag)] = tag
    return bytes(buf)
