"""Native host codec tests: round-trip, interop vs independent oracle
(pyarrow's bundled reference LZ4/Snappy), sequence tables, batch API, and
malformed-input rejection.

This is the unit-test layer the reference entirely lacks (survey §4): its
only oracle was the demo app's memcmp round-trip on live DPU hardware.
"""

import numpy as np
import pytest

from bitar_tpu.ops.cpu import native
from bitar_tpu.status import StatusError

pa = pytest.importorskip("pyarrow")

LZ4_ORACLE = pa.Codec("lz4_raw")
SNAPPY_ORACLE = pa.Codec("snappy")


@pytest.mark.parametrize("codec", ["lz4", "snappy"])
def test_roundtrip_corpus(codec, corpus):
    comp = native.lz4_compress if codec == "lz4" else native.snappy_compress
    dec = native.lz4_decompress if codec == "lz4" else native.snappy_decompress
    for data in corpus:
        c = comp(data)
        d = dec(c, len(data) + 1) if codec == "lz4" else dec(c)
        assert d.tobytes() == data


def test_lz4_interop_both_directions(corpus):
    for data in corpus:
        if not data:
            continue
        ours = native.lz4_compress(data)
        assert bytes(LZ4_ORACLE.decompress(ours.tobytes(), len(data))) == data
        theirs = np.frombuffer(LZ4_ORACLE.compress(data), dtype=np.uint8)
        assert native.lz4_decompress(theirs, len(data) + 1).tobytes() == data


def test_snappy_interop_both_directions(corpus):
    for data in corpus:
        ours = native.snappy_compress(data)
        assert bytes(SNAPPY_ORACLE.decompress(ours.tobytes(), len(data))) == data
        theirs = np.frombuffer(SNAPPY_ORACLE.compress(data), dtype=np.uint8)
        assert native.snappy_decompress(theirs).tobytes() == data


@pytest.mark.parametrize("codec", ["lz4", "snappy"])
def test_sequence_table_covers_output(codec, corpus):
    comp = native.lz4_compress if codec == "lz4" else native.snappy_compress
    for data in corpus:
        if not data:
            continue
        c = comp(data)
        t = native.parse_sequences(c, codec)
        assert int(t["lit_len"].sum() + t["mlen"].sum()) == len(data)
        # out_pos must be the running prefix of produced bytes
        produced = np.concatenate([[0], np.cumsum(t["lit_len"] + t["mlen"])[:-1]])
        np.testing.assert_array_equal(t["out_pos"], produced.astype(np.int32))
        # matches never reference before the start of output
        match_rows = t["mlen"] > 0
        assert (t["off"][match_rows] <= t["out_pos"][match_rows] + t["lit_len"][match_rows]).all()


def test_sequence_table_reconstructs(corpus):
    """Replaying the sequence table in numpy reproduces the input — the
    same contract the device executor implements."""
    for data in corpus:
        if not data:
            continue
        c = native.lz4_compress(data)
        t = native.parse_sequences(c, "lz4")
        out = np.zeros(len(data), dtype=np.uint8)
        comp_arr = np.frombuffer(c.tobytes(), dtype=np.uint8)
        for lp, ll, off, ml, op in zip(
                t["lit_ptr"], t["lit_len"], t["off"], t["mlen"], t["out_pos"]):
            out[op:op + ll] = comp_arr[lp:lp + ll]
            base = op + ll
            for k in range(ml):  # byte loop handles overlap
                out[base + k] = out[base + k - off]
        assert out.tobytes() == data


def test_malformed_inputs_rejected():
    with pytest.raises(StatusError):
        native.lz4_decompress(np.array([0xFF, 0xFF], dtype=np.uint8), 100)
    with pytest.raises(StatusError):
        # offset beyond written output
        native.lz4_decompress(np.array([0x10, 0x41, 0xFF, 0x00], dtype=np.uint8), 100)
    with pytest.raises(StatusError):
        native.snappy_decompress(np.array([0xFF] * 6, dtype=np.uint8))
    with pytest.raises(StatusError):  # truncated snappy preamble
        native.snappy_decompress(np.array([0x80], dtype=np.uint8))


def test_capacity_errors():
    data = b"x" * 1000
    with pytest.raises(StatusError):
        native.lz4_decompress(native.lz4_compress(data), 10)


def test_batch_roundtrip(rng):
    nblocks = 37
    block = 8192
    raw = rng.integers(0, 5, nblocks * block, dtype=np.uint8).astype(np.uint8)
    src_off = np.arange(nblocks, dtype=np.int64) * block
    src_len = np.full(nblocks, block, dtype=np.int32)
    slot = 2 * block
    comp = np.zeros(nblocks * slot, dtype=np.uint8)
    dst_off = np.arange(nblocks, dtype=np.int64) * slot
    caps = np.full(nblocks, slot, dtype=np.int32)

    clen, st = native.batch_run(True, "lz4", raw, src_off, src_len, comp, dst_off, caps)
    assert (st == 0).all()
    assert (clen > 0).all() and (clen < block).all()  # compressible data

    out = np.zeros(nblocks * block, dtype=np.uint8)
    out_caps = np.full(nblocks, block, dtype=np.int32)
    dlen, st2 = native.batch_run(False, "lz4", comp, dst_off, clen, out, src_off, out_caps)
    assert (st2 == 0).all()
    assert (dlen == block).all()
    np.testing.assert_array_equal(out, raw)


def test_batch_mixed_codecs(rng):
    block = 4096
    raws = [rng.integers(0, 3, block, dtype=np.uint8) for _ in range(6)]
    src = np.concatenate(raws)
    src_off = np.arange(6, dtype=np.int64) * block
    src_len = np.full(6, block, dtype=np.int32)
    slot = 2 * block
    comp = np.zeros(6 * slot, dtype=np.uint8)
    dst_off = np.arange(6, dtype=np.int64) * slot
    caps = np.full(6, slot, dtype=np.int32)
    ids = np.array([0, 1, 3, 0, 1, 3], dtype=np.int32)  # lz4, snappy, raw

    clen, st = native.batch_run(True, "lz4", src, src_off, src_len,
                                comp, dst_off, caps, codec_ids=ids)
    assert (st == 0).all()
    assert clen[2] == block  # raw stores verbatim

    out = np.zeros(6 * block, dtype=np.uint8)
    out_caps = np.full(6, block, dtype=np.int32)
    dlen, st2 = native.batch_run(False, "lz4", comp, dst_off, clen,
                                 out, src_off, out_caps, codec_ids=ids)
    assert (st2 == 0).all() and (dlen == block).all()
    np.testing.assert_array_equal(out, src)


def test_batch_reports_per_block_errors(rng):
    # One corrupt block must not poison the others (per-op status walk,
    # reference device.cc:512-520).
    block = 1024
    raw = rng.integers(0, 3, 3 * block, dtype=np.uint8)
    src_off = np.arange(3, dtype=np.int64) * block
    src_len = np.full(3, block, dtype=np.int32)
    slot = 2 * block
    comp = np.zeros(3 * slot, dtype=np.uint8)
    dst_off = np.arange(3, dtype=np.int64) * slot
    caps = np.full(3, slot, dtype=np.int32)
    clen, st = native.batch_run(True, "lz4", raw, src_off, src_len, comp, dst_off, caps)
    assert (st == 0).all()
    # corrupt middle block's compressed bytes
    comp[dst_off[1]:dst_off[1] + clen[1]] = 0xFF
    out = np.zeros(3 * block, dtype=np.uint8)
    out_caps = np.full(3, block, dtype=np.int32)
    dlen, st2 = native.batch_run(False, "lz4", comp, dst_off, clen, out, src_off, out_caps)
    assert st2[0] == 0 and st2[2] == 0
    assert st2[1] < 0
    np.testing.assert_array_equal(out[:block], raw[:block])
    np.testing.assert_array_equal(out[2 * block:], raw[2 * block:])
