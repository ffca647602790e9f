"""Fused shuffle + decode over the 8-way virtual mesh.

``distributed_step`` is the one multi-device decode: each device stages
its compressed slot rows, the all_to_all shuffle delivers them to their
hash-partitioned destination, and every destination runs the sequence
executor on what it received.
"""

import numpy as np
import pytest

from bitar_tpu.ops.cpu import native
from bitar_tpu.ops.decode import TABLE_KEYS, pad_tables
from bitar_tpu.parallel import (
    distributed_step,
    make_mesh,
    plan_shuffle,
    prepare_distributed_step,
)

BLOCK = 16 * 1024


def make_wire(rng, nblocks, codec="lz4"):
    """Mixed corpus -> (raw blocks, slot rows, tables, nseq, sizes); RAW
    rows where the codec does not shrink the block (engine semantics)."""
    datas, rows, tables = [], np.zeros((nblocks, BLOCK), np.uint8), []
    for i in range(nblocks):
        k = i % 4
        if k == 0:
            x = ((b"dist step %d " % i) * (BLOCK // 11 + 1))[:BLOCK]
        elif k == 1:
            x = rng.integers(0, 8, BLOCK, dtype=np.uint8).tobytes()
        elif k == 2:
            x = bytes([i]) * BLOCK
        else:
            x = rng.integers(0, 256, BLOCK, np.uint8).tobytes()
        c = np.asarray(native.lz4_compress(x, min_match=6) if codec == "lz4"
                       else native.snappy_compress(x, min_match=6))
        if len(c) >= BLOCK:
            c = np.frombuffer(x, np.uint8)
            t = {key: np.zeros(1, np.int32) for key in TABLE_KEYS}
            t["lit_len"][0] = BLOCK
        else:
            t = native.parse_sequences(c, codec)
        rows[i, :len(c)] = c
        datas.append(x)
        tables.append(t)
    t, nseq = pad_tables(tables)
    sizes = np.array([int((r != 0).sum()) for r in rows], np.int64)
    return datas, rows, t, nseq, sizes


@pytest.mark.parametrize("codec", ["lz4", "snappy"])
def test_fused_step_bit_exact(codec, rng):
    d, nblocks = 8, 16
    mesh = make_mesh(d)
    datas, rows, tables, nseq, sizes = make_wire(rng, nblocks, codec)
    splan = plan_shuffle(nblocks, d, sizes=sizes)
    args, kwargs = prepare_distributed_step(mesh, splan, rows, tables, nseq,
                                            BLOCK)
    out = np.asarray(distributed_step(*args, **kwargs))
    checked = 0
    for pos, b in enumerate(splan.recv_block.reshape(-1)):
        if b >= 0:
            assert out[pos].tobytes() == datas[b], f"block {b} at {pos}"
            checked += 1
    assert checked == nblocks
