"""Hostile-input hardening tests (round-2 advisor findings).

The reference treats untrusted compressed data as a first-class threat
surface only implicitly (hardware validates streams); this build's native
walks and the device decode path must refuse malformed containers
explicitly.
"""

import numpy as np
import pytest

from bitar_tpu.config import Codec, EngineConfig
from bitar_tpu.engine.device import Engine
from bitar_tpu.manifest import MAGIC, BlockManifest, CompressedBuffers
from bitar_tpu.ops.cpu import native
from bitar_tpu.status import StatusError


def test_snappy_negative_literal_length_rejected():
    # tag 0xFC declares a 4-extra-byte literal length; bytes 00 00 00 80
    # decode to 2^31, which overflowed int and slipped past the bounds
    # checks as a negative memcpy size before the int64 accumulation fix.
    evil = bytes([10, 0xFC, 0x00, 0x00, 0x00, 0x80])
    with pytest.raises(StatusError):
        native.snappy_decompress(evil, dst_cap=64)
    with pytest.raises(StatusError):
        native.parse_sequences(evil, codec="snappy")


def test_snappy_huge_literal_length_rejected():
    # A large positive 32-bit length must also be refused (exceeds src).
    evil = bytes([10, 0xFC, 0xFF, 0xFF, 0xFF, 0x7F])
    with pytest.raises(StatusError):
        native.snappy_decompress(evil, dst_cap=64)


def test_device_path_lying_manifest_raw_len():
    # A manifest that over-states a block's raw_len: the table build
    # refuses the block (its decoded extent disagrees), the device
    # executor never runs past the real output, and the block is named.
    data = bytes(np.random.default_rng(1).integers(97, 110, 4096,
                                                   dtype=np.uint8))
    cfg = EngineConfig(codec=Codec.LZ4, block_size=2048, burst_size=4,
                       max_pool_slots=32, use_device_kernels=False)
    with Engine(cfg) as eng:
        unit = eng.compress(data)
        cb = unit.to_host()
        eng.recycle(unit)
    raw_len = cb.manifest.raw_len.copy()
    raw_len[0] -= 7
    lying = BlockManifest(
        block_size=cb.manifest.block_size, total_raw=int(raw_len.sum()),
        raw_len=raw_len, comp_len=cb.manifest.comp_len,
        codec_ids=cb.manifest.codec_ids, checksums=cb.manifest.checksums)
    bad = CompressedBuffers(manifest=lying, packed=cb.packed)
    with Engine(cfg.replace(use_device_kernels=True)) as eng:
        unit = eng.import_unit(bad)
        _, status = eng.decompress_status(unit)
        assert status[0] < 0 and (status[1:] == 0).all(), status.tolist()
        assert eng.stats.host_decode_bursts == 0


def test_manifest_rejects_oversized_last_block():
    m = BlockManifest.plan(1024, 512)
    m.raw_len[-1] = 4096     # lies: larger than block_size
    m.total_raw = int(m.raw_len.sum())
    assert not m.validate().ok()


def test_manifest_from_bytes_hostile_nblocks():
    # A header claiming a huge nblocks over a tiny body must fail cleanly
    # (StatusError), not allocate gigabytes or raise a raw ValueError.
    m = BlockManifest.plan(1024, 512)
    blob = bytearray(m.to_bytes())
    # nblocks lives at offset 8 (<HH then I); forge it and redo the CRC.
    import struct
    import zlib
    blob[8:12] = struct.pack("<I", 0x0FFFFFFF)
    body = bytes(blob[:-4])
    blob[-4:] = struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF)
    with pytest.raises(StatusError):
        BlockManifest.from_bytes(bytes(blob))


def test_manifest_truncated_columns():
    m = BlockManifest.plan(4096, 1024)
    blob = m.to_bytes()
    import struct
    import zlib
    cut = blob[: 4 + 24 + 4]          # drop most of the column data
    forged = cut + struct.pack("<I", zlib.crc32(cut) & 0xFFFFFFFF)
    with pytest.raises(StatusError):
        BlockManifest.from_bytes(forged)


@pytest.fixture
def cpu_engine_config():
    return EngineConfig(codec=Codec.LZ4, block_size=1024, burst_size=8,
                        max_pool_slots=64, use_device_kernels=False)


def test_import_lying_manifest_raw_len(cpu_engine_config):
    # Container whose manifest under-states raw_len: the host path
    # reports the real size disagreement (not a crash).
    data = bytes(np.random.default_rng(0).integers(97, 110, 4096, dtype=np.uint8))
    with Engine(cpu_engine_config) as eng:
        unit = eng.compress(data)
        cb = unit.to_host()
        eng.recycle(unit)
    lying = BlockManifest(
        block_size=cb.manifest.block_size,
        total_raw=cb.manifest.total_raw - 1,
        raw_len=cb.manifest.raw_len.copy(),
        comp_len=cb.manifest.comp_len,
        codec_ids=cb.manifest.codec_ids,
        checksums=cb.manifest.checksums,
    )
    lying.raw_len[-1] -= 1
    bad = CompressedBuffers(manifest=lying, packed=cb.packed)
    with Engine(cpu_engine_config) as eng:
        unit = eng.import_unit(bad)
        with pytest.raises(StatusError):
            eng.decompress(unit)


def test_manifest_magic_check():
    with pytest.raises(StatusError):
        BlockManifest.from_bytes(b"NOPE" + b"\0" * 40)
    assert MAGIC == b"BTPU"
