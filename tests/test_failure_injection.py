"""Failure injection + per-block status surfacing.

The reference walks every op's status at dequeue and reports the lot
(``device.cc:512-520``) and polls device error counters for silent
failures (``device.cc:84-110``).  These tests corrupt blocks mid-unit and
check that (a) good neighbors still decode, (b) every bad block is named,
(c) counters accumulate, and (d) mixed-codec units split per block
instead of falling back wholesale.
"""

import numpy as np
import pytest

import bitar_tpu as bt
from bitar_tpu.manifest import BlockManifest, CompressedBuffers, checksum_of, codec_id
from bitar_tpu.status import StatusError

BLOCK = 2048


def cfg(**kw):
    base = dict(codec=bt.Codec.LZ4, block_size=BLOCK, burst_size=8,
                max_pool_slots=64, use_device_kernels=False,
                checksum=bt.Checksum.CRC32)
    base.update(kw)
    return bt.EngineConfig(**base)


def make_unit_bytes(config, data):
    with bt.Engine(config) as eng:
        unit = eng.compress(data)
        cb = unit.to_host()
        eng.recycle(unit)
    return cb


def test_corrupt_block_mid_unit_reports_all_bad_blocks(rng):
    data = bytes(rng.integers(97, 110, 8 * BLOCK, dtype=np.uint8))
    c = cfg()
    cb = make_unit_bytes(c, data)
    # Corrupt blocks 2 and 5 in the packed payload.
    for k in (2, 5):
        off = int(cb.manifest.comp_off[k])
        cb.packed[off + 3] ^= 0xA5
    with bt.Engine(c) as eng:
        unit = eng.import_unit(cb)
        out, status = eng.decompress_status(unit)
        bad = np.flatnonzero(status < 0)
        assert set(bad.tolist()) == {2, 5}, status.tolist()
        # good neighbors decoded bit-exactly
        for i in range(8):
            if i in (2, 5):
                continue
            o = int(cb.manifest.raw_off[i])
            ln = int(cb.manifest.raw_len[i])
            assert out[o:o + ln].tobytes() == data[o:o + ln], f"block {i}"
        assert eng.error_count() >= 2
        # the raising API names every failed block
        with pytest.raises(StatusError) as ei:
            eng.decompress(unit)
        assert "2" in str(ei.value) and "5" in str(ei.value)
        eng.recycle(unit)


def test_corrupt_block_device_path(rng):
    # Same injection through the device decode path: the corrupt block's
    # framing fails to parse, it is named in the status, and its
    # neighbors still decode on the device (no whole-unit fallback).
    data = bytes(rng.integers(97, 110, 4 * 16384, dtype=np.uint8))
    c = cfg(use_device_kernels=True, block_size=16384)
    cb = make_unit_bytes(c, data)
    off = int(cb.manifest.comp_off[1])
    cb.packed[off + 2] ^= 0xFF
    with bt.Engine(c) as eng:
        unit = eng.import_unit(cb)
        out, status = eng.decompress_status(unit)
        assert status[1] < 0
        assert (status[np.arange(4) != 1] == 0).all()
        for i in (0, 2, 3):
            o, ln = int(cb.manifest.raw_off[i]), int(cb.manifest.raw_len[i])
            assert out[o:o + ln].tobytes() == data[o:o + ln], f"block {i}"
        assert eng.stats.host_decode_bursts == 0
        eng.recycle(unit)


def test_corrupt_slot_after_table_build_is_named(rng):
    # The device decoder executes tables parsed at build time; bytes
    # corrupted in the arena AFTER that build must still surface as real
    # per-block status (the decode-time framing walk; reference
    # device.cc:512-520).
    import jax.numpy as jnp

    data = (b"table path payload %d " % 7) * (8 * BLOCK // 21)
    data = data[:8 * BLOCK]
    c = cfg(use_device_kernels=True, checksum=bt.Checksum.NONE)
    with bt.Engine(c) as eng:
        unit = eng.compress(data)
        eng.ensure_tables(unit)
        assert unit.tables is not None
        assert int(unit.manifest.comp_len[3]) < BLOCK, "block 3 must be LZ4"
        # corrupt block 3's slot in place (post-table-build)
        slot = unit.refs[3].slot
        row = np.asarray(eng.arena.gather_burst([slot]))[0].copy()
        row[0] ^= 0xFF                 # first token byte: breaks framing
        eng.arena.write_burst([slot], jnp.asarray(row[None]))
        out, status = eng.decompress_status(unit)
        assert status[3] < 0, status.tolist()
        assert (status[np.arange(8) != 3] == 0).all(), status.tolist()
        for i in range(8):
            if i == 3:
                continue
            o, ln = int(unit.manifest.raw_off[i]), int(unit.manifest.raw_len[i])
            assert out[o:o + ln].tobytes() == data[o:o + ln], f"block {i}"
        eng.recycle(unit)


def test_table_path_validation_is_generation_cached(rng, monkeypatch):
    # The decode-time framing walk is O(bytes); repeat decompresses of
    # untouched slots must skip it (generation-gated cache), while a slot
    # rewritten afterwards still re-validates and is named.
    import jax.numpy as jnp

    from bitar_tpu.ops.cpu import native as native_mod

    data = (b"cache the framing walk %d " % 3) * (8 * BLOCK // 26)
    data = data[:8 * BLOCK]
    c = cfg(use_device_kernels=True, checksum=bt.Checksum.NONE)
    with bt.Engine(c) as eng:
        unit = eng.compress(data)
        eng.ensure_tables(unit)
        assert unit.tables is not None
        out, status = eng.decompress_status(unit)
        assert (status == 0).all()
        # Second decompress: no parse_sequences calls (cache hit).
        calls = []
        real = native_mod.parse_sequences

        def counting(*a, **kw):
            calls.append(1)
            return real(*a, **kw)

        monkeypatch.setattr(native_mod, "parse_sequences", counting)
        out, status = eng.decompress_status(unit)
        assert (status == 0).all()
        assert not calls, f"cached validation re-walked {len(calls)} blocks"
        # Rewrite one slot: exactly that block re-validates and is named.
        slot = unit.refs[2].slot
        row = np.asarray(eng.arena.gather_burst([slot]))[0].copy()
        row[0] ^= 0xFF
        eng.arena.write_burst([slot], jnp.asarray(row[None]))
        out, status = eng.decompress_status(unit)
        assert status[2] < 0 and (status[np.arange(8) != 2] == 0).all()
        assert len(calls) == 1, f"expected 1 re-walk, got {len(calls)}"
        eng.recycle(unit)


def test_mixed_codec_unit_splits_per_block(rng):
    # LZ4 + zstd blocks in ONE unit: every block rides the device
    # executor (zstd via its entropy-decoded literal stream) — no host
    # fallback.
    pytest.importorskip("zstandard")
    import zstandard

    from bitar_tpu.ops.cpu import native

    bs = 16384
    blocks = [
        (b"lz4 block %d " % i) * (bs // 12) for i in range(3)
    ] + [b"zstd block content " * (bs // 18)]
    blocks = [b[:bs] for b in blocks]
    comp = [np.asarray(native.lz4_compress(b)) for b in blocks[:3]]
    comp.append(np.frombuffer(
        zstandard.ZstdCompressor(level=3).compress(blocks[3]), np.uint8))
    ids = [codec_id(bt.Codec.LZ4)] * 3 + [codec_id(bt.Codec.ZSTD)]

    m = BlockManifest.plan_sizes([len(b) for b in blocks], bs)
    m.comp_len = np.array([len(c) for c in comp], np.int32)
    m.codec_ids = np.array(ids, np.int32)
    m.checksum_kind = bt.Checksum.CRC32
    for i, b in enumerate(blocks):
        m.checksums[i] = checksum_of(bt.Checksum.CRC32, b)
    cb = CompressedBuffers(manifest=m, packed=np.concatenate(comp))

    c = cfg(use_device_kernels=True, block_size=bs)
    with bt.Engine(c) as eng:
        unit = eng.import_unit(cb)
        out = eng.decompress(unit)
        assert out.tobytes() == b"".join(blocks)
        assert (unit.table_status == 0).all()
        assert eng.stats.host_decode_bursts == 0
        # the zstd block decodes on device from its literal stream
        assert list(unit.lit_rows) == [3]
        eng.recycle(unit)


def test_status_api_zero_on_clean_unit(rng):
    data = bytes(rng.integers(97, 122, 3 * BLOCK + 77, dtype=np.uint8))
    c = cfg()
    with bt.Engine(c) as eng:
        unit = eng.compress(data)
        out, status = eng.decompress_status(unit)
        assert (status == 0).all()
        assert out.tobytes() == data
        assert eng.error_count() == 0
        eng.recycle(unit)


def test_container_mutation_fuzz(rng):
    # Randomized byte mutations over a serialized container must never
    # crash, hang, or silently return wrong bytes: every outcome is
    # either a clean StatusError (CRC/parse/validate) or a per-block
    # status naming the damage.  The reference's entire error model is
    # status propagation (util.h:157-207) — no hostile input may escape
    # it.
    data = (b"fuzz me gently " * 4000)[:24 * BLOCK] \
        + rng.integers(0, 256, 4 * BLOCK, np.uint8).tobytes()
    blob = bytes(make_unit_bytes(cfg(), data).to_bytes())
    with bt.Engine(cfg()) as eng:
        for trial in range(60):
            bad = bytearray(blob)
            for _ in range(int(rng.integers(1, 4))):
                bad[int(rng.integers(0, len(bad)))] ^= int(
                    rng.integers(1, 256))
            try:
                unit = eng.import_unit(CompressedBuffers.from_bytes(
                    bytes(bad)))
            except StatusError:
                continue                      # rejected at import: fine
            try:
                out, status = eng.decompress_status(unit)
                if (status == 0).all():
                    # Everything decoded "cleanly": bytes must be right
                    # (possible when the mutation hit container padding).
                    assert out.tobytes() == data, f"trial {trial}: silent corruption"
            except StatusError:
                pass                          # raised cleanly: fine
            finally:
                eng.recycle(unit)


def test_device_decode_failure_raises(rng):
    # A failure of the device decode itself (compile, launch, runtime)
    # surfaces from Engine.decompress: there is no silent host fallback,
    # so a device-decode result can never be a host result.
    from unittest.mock import patch

    data = (b"no fallback payload " * 4000)[:12 * BLOCK]
    config = cfg(block_size=16 * 1024, use_device_kernels=True)
    with bt.Engine(config) as eng:
        unit = eng.compress(data)
        with patch("bitar_tpu.engine.device.decode_blocks",
                   side_effect=RuntimeError("device launch failed")):
            with pytest.raises(RuntimeError, match="device launch failed"):
                eng.decompress(unit)
        assert eng.stats.host_decode_bursts == 0
        # the unit is intact: the real executor decodes it afterwards
        assert eng.decompress(unit).tobytes() == data
        eng.recycle(unit)
