"""Device decode executor tests (``ops/decode.py``).

The executor is plain XLA, so JAX's CPU backend runs the same program a
GPU compiles.  Every case is checked byte for byte against the input and
against the native host decoder (the memcmp oracle of the reference demo
app, ``demo_app.cc:534-543``).
"""

from pathlib import Path

import numpy as np
import pytest

from bitar_tpu.ops.cpu import native
from bitar_tpu.ops.decode import (
    TABLE_KEYS,
    decode_blocks,
    decode_blocks_ref,
    pad_tables,
    table_capacity,
)

KEYS = TABLE_KEYS
CODECS = ["lz4", "snappy", "zstd", "raw"]
SURVEY = Path(__file__).resolve().parent.parent / "SURVEY.md"


def encode(codec: str, data: bytes):
    """(source row, sequence table) of one block, after checking that the
    native decoder restores it."""
    if codec == "raw":
        t = {k: np.zeros(1, np.int32) for k in KEYS}
        t["lit_len"][0] = len(data)
        return np.frombuffer(data, np.uint8), t
    if codec == "lz4":
        comp = native.lz4_compress(data)
        assert native.lz4_decompress(comp, len(data)).tobytes() == data
    elif codec == "snappy":
        comp = native.snappy_compress(data)
        assert native.snappy_decompress(comp).tobytes() == data
    else:
        comp = native.zstd_compress(data)
        assert native.zstd_decompress(comp, len(data)).tobytes() == data
        t, lits = native.zstd_parse(comp, max_seq=len(data) + 16,
                                    lit_cap=max(64, len(data)))
        return lits, t
    return comp, native.parse_sequences(comp, codec)


def run_decode(codec: str, datas: list[bytes], block: int) -> np.ndarray:
    srcs, tables = zip(*(encode(codec, d) for d in datas))
    width = max(128, -(-max(len(s) for s in srcs) // 128) * 128)
    src = np.zeros((len(datas), width), np.uint8)
    for i, s in enumerate(srcs):
        src[i, :len(s)] = s
    t, nseq = pad_tables(list(tables))
    out = np.asarray(decode_blocks(src, nseq, *(t[k] for k in KEYS),
                                   block_size=block))
    assert out.shape == (len(datas), block) and out.dtype == np.uint8
    return out


def check(codec: str, datas: list[bytes], block: int) -> None:
    out = run_decode(codec, datas, block)
    for i, d in enumerate(datas):
        assert out[i, :len(d)].tobytes() == d, f"{codec} block {i}"
        assert not out[i, len(d):].any(), f"{codec} block {i}: tail not zero"


def corpus(kind: str, n: int, rng) -> bytes:
    if kind == "text":
        return ((b"the quick brown fox jumps over the lazy dog %d " % n)
                * (n // 40 + 1))[:n]
    if kind == "low-entropy":
        return rng.integers(0, 4, n, dtype=np.uint8).tobytes()
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == "rle":
        return b"\xab" * n
    if kind == "records16":
        rec = np.zeros((n // 16 + 1, 16), np.uint8)
        rec[:, 0] = np.arange(rec.shape[0]) & 0xFF
        rec[:, 5] = 7
        return rec.tobytes()[:n]
    assert kind == "markdown"
    return SURVEY.read_bytes()[:n]


def test_lz4_decode_mixed_blocks(rng):
    block = 384
    datas = [
        (b"hello world! hello hello " * 40)[:block],
        bytes(rng.integers(0, 256, block, dtype=np.uint8)),  # pure literal
        b"\x07" * block,                                     # off=1 RLE
        (b"abcdefgh" * 60)[:block],                          # off=8 overlap
        (b"ab" * 200)[:block],                               # off=2 overlap
    ]
    check("lz4", datas, block)


def test_lz4_decode_ragged_tail(rng):
    # Blocks of different raw lengths in one batch (the manifest's ragged
    # tail case): decode fills only each block's raw_len bytes.
    block = 256
    check("lz4", [(b"abcabcabc" * 50)[:block], (b"xyz" * 30)[:77]], block)


def test_snappy_tables_same_kernel(rng):
    # Snappy parses into the same SoA row shape; one executor runs both.
    block = 320
    check("snappy", [(b"snappy snappy snap " * 30)[:block],
                     bytes(rng.integers(0, 3, block, dtype=np.uint8)),
                     b"\xff" * block], block)


def test_lz4_oracle_cross_check(rng):
    # Executor output must match the native decoder byte for byte.
    block = 300
    data = bytes(rng.integers(0, 8, block, dtype=np.uint8))
    comp = native.lz4_compress(data)
    out = run_decode("lz4", [data], block)
    assert out[0].tobytes() == native.lz4_decompress(comp, block).tobytes() \
        == data


@pytest.mark.parametrize("pattern_len", [1, 2, 3, 5, 8, 16, 127, 128, 129])
def test_overlap_offsets(pattern_len):
    # Every overlap regime: offsets shorter than, equal to and longer
    # than the match (chains that pointer doubling must resolve).
    block = 256
    check("lz4", [(bytes(range(pattern_len)) * (block // pattern_len + 1))[:block]],
          block)


@pytest.mark.parametrize("codec", ["snappy", "zstd"])
@pytest.mark.parametrize("pattern_len", [1, 2, 3, 5, 8, 16, 127, 128, 129])
def test_overlap_offsets_codecs(codec, pattern_len):
    block = 1024
    check(codec, [(bytes(range(pattern_len)) * (block // pattern_len + 1))[:block]],
          block)


@pytest.mark.parametrize("kind", ["text", "low-entropy", "random", "rle",
                                  "records16", "markdown"])
@pytest.mark.parametrize("codec", CODECS)
def test_codec_corpus(codec, kind, rng):
    block = 32 * 1024
    check(codec, [corpus(kind, block, rng), corpus(kind, block - 1000, rng)],
          block)


@pytest.mark.parametrize("block", [4 << 10, 64 << 10, 1 << 20])
@pytest.mark.parametrize("codec", ["lz4", "snappy", "zstd"])
def test_block_sizes_ragged(codec, block, rng):
    text = corpus("markdown", 40000, rng)
    full = (text * (block // len(text) + 1))[:block]
    ragged = corpus("low-entropy", block - 333, rng)
    check(codec, [full, ragged, b"\x11" * (block // 3)], block)


@pytest.mark.parametrize("size", [0, 1])
def test_empty_and_one_byte_blocks(size):
    data = b"z" * size
    for codec in CODECS:
        check(codec, [data, b"q" * 100], 128)


def test_numpy_reference_matches_executor(rng):
    # The sequential numpy executor (decode_blocks_ref) and the device
    # executor agree on the same tables for every codec.
    block = 4096
    for codec in ("lz4", "snappy", "zstd"):
        datas = [corpus(k, block, rng) for k in ("text", "low-entropy", "rle")]
        srcs, tables = zip(*(encode(codec, d) for d in datas))
        src = np.zeros((3, 2 * block), np.uint8)
        for i, s in enumerate(srcs):
            src[i, :len(s)] = s
        t, nseq = pad_tables(list(tables))
        ref = decode_blocks_ref(src, t, nseq, block)
        got = np.asarray(decode_blocks(src, nseq, *(t[k] for k in KEYS),
                                       block_size=block))
        assert (ref == got).all(), codec


def test_malformed_tables_terminate():
    # Hostile tables (offset reaching before the block, a self-reference,
    # literals past the source row) decode to unspecified bytes but must
    # terminate with the right shape; validation is the host's job.
    t = {k: np.zeros((1, 128), np.int32) for k in KEYS}
    t["lit_len"][0, :3] = [4, 0, 2]
    t["lit_ptr"][0, :3] = [0, 0, 1000]
    t["out_pos"][0, :3] = [0, 4, 20]
    t["off"][0, :3] = [50, 0, 0]
    t["mlen"][0, :3] = [8, 8, 0]
    out = decode_blocks(np.zeros((1, 128), np.uint8), np.array([3], np.int32),
                        *(t[k] for k in KEYS), block_size=64)
    assert np.asarray(out).shape == (1, 64)


def test_pad_tables():
    t1 = {k: np.arange(3, dtype=np.int32) for k in KEYS}
    t2 = {k: np.arange(200, dtype=np.int32) for k in KEYS}
    t, nseq = pad_tables([t1, t2])
    assert nseq.tolist() == [3, 200]
    assert t["off"].shape == (2, 256)  # power-of-two capacity
    assert t["off"][0, 2] == 2 and t["off"][0, 3] == 0


def test_table_capacity():
    assert table_capacity(0) == 128 and table_capacity(128) == 128
    assert table_capacity(129) == 256 and table_capacity(5000) == 8192
