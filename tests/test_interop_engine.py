"""Engine-level standard-format interop: data compressed by FOREIGN
implementations (pyarrow's reference LZ4/Snappy) flows through import ->
arena -> device decode executor bit-exactly, and our engine's output feeds
foreign decoders.  The round-trip oracle of the reference demo app,
extended across implementations.
"""

import numpy as np
import pytest

import bitar_tpu as bt
from bitar_tpu.manifest import BlockManifest, CompressedBuffers, codec_id

pa = pytest.importorskip("pyarrow")

BLOCK = 16 * 1024


def foreign_container(data: bytes, codec: bt.Codec) -> CompressedBuffers:
    """Build a .btpu container whose blocks were compressed by pyarrow."""
    arrow_codec = pa.Codec("lz4_raw" if codec == bt.Codec.LZ4 else "snappy")
    m = BlockManifest.plan(len(data), BLOCK)
    blocks = []
    for i in range(m.nblocks):
        o, ln = int(m.raw_off[i]), int(m.raw_len[i])
        comp = bytes(arrow_codec.compress(data[o:o + ln]))
        m.comp_len[i] = len(comp)
        m.codec_ids[i] = codec_id(codec)
        blocks.append(np.frombuffer(comp, np.uint8))
    return CompressedBuffers(manifest=m, packed=np.concatenate(blocks))


@pytest.mark.parametrize("codec", [bt.Codec.LZ4, bt.Codec.SNAPPY])
@pytest.mark.parametrize("path", ["decompress", "resident"])
def test_foreign_blocks_through_device_decode(codec, path, rng):
    data = ((b"foreign interop " * (BLOCK // 10))[:BLOCK]
            + bytes(rng.integers(0, 64, BLOCK, dtype=np.uint8))
            + b"\x55" * (BLOCK // 2))
    cfg = bt.EngineConfig(codec=codec, block_size=BLOCK, burst_size=4,
                          max_pool_slots=32, use_device_kernels=True)
    with bt.Engine(cfg) as eng:
        unit = eng.import_unit(foreign_container(data, codec))
        if path == "resident":      # device-resident bursts, no readout
            rows = np.concatenate([np.asarray(b) for b in
                                   eng.decompress_device(unit)])
            out = rows[:unit.nblocks].reshape(-1)[:len(data)]
        else:
            out = eng.decompress(unit)
        assert out.tobytes() == data
        assert eng.stats.host_decode_bursts == 0
        eng.recycle(unit)


def test_our_blocks_through_foreign_decoder(rng):
    data = (b"outbound interop " * 3000)[:2 * BLOCK + 500]
    cfg = bt.EngineConfig(codec=bt.Codec.LZ4, block_size=BLOCK, burst_size=4,
                          max_pool_slots=32, use_device_kernels=False)
    with bt.Engine(cfg) as eng:
        unit = eng.compress(data)
        cb = unit.to_host()
        lz4 = pa.Codec("lz4_raw")
        for i in range(cb.manifest.nblocks):
            o, ln = int(cb.manifest.raw_off[i]), int(cb.manifest.raw_len[i])
            assert bytes(lz4.decompress(cb.block(i).tobytes(), ln)) == \
                data[o:o + ln], f"block {i}"
        eng.recycle(unit)
