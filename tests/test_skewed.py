"""Skewed block-size distributions (BASELINE config 4): non-uniform
manifests end to end — compress with explicit sizes, serialize, import,
decode on every path, bit-exact.
"""

import numpy as np
import pytest

import bitar_tpu as bt
from bitar_tpu.manifest import BlockManifest, CompressedBuffers
from bitar_tpu.status import StatusError


def make_skewed(rng, nblocks, max_size, min_size=64):
    sizes = np.minimum(
        max_size,
        np.exp2(rng.uniform(np.log2(min_size), np.log2(max_size),
                            nblocks)).astype(np.int64))
    parts = []
    for i, n in enumerate(sizes):
        k = i % 3
        n = int(n)
        if k == 0:
            parts.append(((b"skew %d " % i) * (n // 6 + 1))[:n])
        elif k == 1:
            parts.append(rng.integers(0, 64, n, dtype=np.uint8).tobytes())
        else:
            parts.append(bytes([i & 0xFF]) * n)
    return b"".join(parts), [int(s) for s in sizes]


@pytest.mark.parametrize("device", [False, True])
def test_skewed_roundtrip(rng, device):
    block = 16384 if device else 2048
    data, sizes = make_skewed(rng, 10, block)
    cfg = bt.EngineConfig(codec=bt.Codec.LZ4, block_size=block, burst_size=4,
                          max_pool_slots=64, use_device_kernels=device,
                          checksum=bt.Checksum.CRC32)
    with bt.Engine(cfg) as eng:
        unit = eng.compress(data, sizes=sizes)
        assert not unit.manifest.uniform
        assert unit.manifest.raw_len.tolist() == sizes
        out = eng.decompress(unit)
        assert out.tobytes() == data
        blob = unit.to_host().to_bytes()
        eng.recycle(unit)
    # container round-trip preserves the skewed framing
    cb = CompressedBuffers.from_bytes(blob)
    assert not cb.manifest.uniform
    assert cb.manifest.raw_len.tolist() == sizes
    with bt.Engine(cfg) as eng:
        unit = eng.import_unit(cb)
        out = eng.decompress(unit)
        assert out.tobytes() == data
        eng.recycle(unit)


def test_skewed_sizes_validation():
    with pytest.raises(StatusError):
        BlockManifest.plan_sizes([100, 5000], 2048)   # block over max
    with pytest.raises(StatusError):
        BlockManifest.plan_sizes([], 2048)
    m = BlockManifest.plan_sizes([2048, 2048, 100], 2048)
    assert m.uniform                                   # uniform-shaped input
    m2 = BlockManifest.plan_sizes([100, 2048, 50], 2048)
    assert not m2.uniform


def test_compress_sizes_must_sum(rng):
    cfg = bt.EngineConfig(codec=bt.Codec.LZ4, block_size=2048, burst_size=4,
                          max_pool_slots=64, use_device_kernels=False)
    with bt.Engine(cfg) as eng:
        with pytest.raises(StatusError):
            eng.compress(b"x" * 1000, sizes=[512, 512, 512])
