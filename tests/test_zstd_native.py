"""From-scratch native zstd codec (ops/cpu/zstd.cc) + its device decode path.

Decoder AND encoder are validated against the environment's ``zstandard``
module (the upstream reference implementation) across entropy classes,
levels, checksummed frames and multi-block frames; ``bt_zstd_parse``
feeds the device executor with literals from a host-entropy-decoded
stream, so zstd sequence execution happens on device like LZ4/Snappy.
"""

import numpy as np
import pytest

import bitar_tpu as bt
from bitar_tpu.manifest import CompressedBuffers
from bitar_tpu.ops.cpu import native
from bitar_tpu.status import StatusError

zstandard = pytest.importorskip("zstandard")


def corpus(rng):
    out = []
    for n in (1, 17, 1000, 40000, 131072):
        out.append(("text%d" % n, (b"native zstd %d " % n) * (n // 12 + 1)))
        out.append(("rand%d" % n, rng.integers(0, 256, n, dtype=np.uint8).tobytes()))
        out.append(("low%d" % n, rng.integers(0, 7, n, dtype=np.uint8).tobytes()))
        out.append(("rle%d" % n, b"\x42" * n))
    return [(k, v[:131072]) for k, v in out]


def test_decoder_vs_reference(rng):
    for level in (1, 3, 9, 19):
        for name, data in corpus(rng):
            comp = zstandard.ZstdCompressor(level=level).compress(data)
            out = native.zstd_decompress(comp, len(data) + 16)
            assert out.tobytes() == data, f"{name} lvl{level}"


def test_decoder_checksummed_and_empty(rng):
    data = bytes(rng.integers(0, 50, 50000, dtype=np.uint8))
    comp = zstandard.ZstdCompressor(level=6, write_checksum=True).compress(data)
    assert native.zstd_decompress(comp, len(data)).tobytes() == data
    empty = zstandard.ZstdCompressor().compress(b"")
    assert native.zstd_decompress(empty, 8).tobytes() == b""


def test_decoder_rejects_garbage():
    with pytest.raises(StatusError):
        native.zstd_decompress(b"\x00" * 20, 100)
    data = b"corrupt me " * 500
    comp = bytearray(zstandard.ZstdCompressor(level=3).compress(data))
    comp[len(comp) // 2] ^= 0xFF
    try:
        out = native.zstd_decompress(bytes(comp), len(data) + 16)
        assert out.tobytes() != data   # silent success on corruption is a bug
    except StatusError:
        pass                           # clean refusal preferred


def test_parse_reconstruction(rng):
    for name, data in corpus(rng)[:8]:
        comp = zstandard.ZstdCompressor(level=5).compress(data)
        t, lits = native.zstd_parse(comp)
        out = np.zeros(len(data) + 8, np.uint8)
        pos = 0
        for i in range(t["lit_ptr"].shape[0]):
            lp, ll, off, ml = (int(t[k][i]) for k in ("lit_ptr", "lit_len",
                                                      "off", "mlen"))
            assert int(t["out_pos"][i]) == pos
            out[pos:pos + ll] = lits[lp:lp + ll]
            pos += ll
            for k in range(ml):
                out[pos + k] = out[pos - off + k]
            pos += ml
        assert pos == len(data) and out[:pos].tobytes() == data, name


def test_engine_zstd_device_path(rng):
    # codec=ZSTD end to end: native compression (zstd.cc encoder), decode
    # through the device executor sourcing the decoded literal stream.
    bs = 16384
    data = ((b"zstd on the device! " * 900)[:bs]
            + bytes(rng.integers(0, 9, bs, dtype=np.uint8))
            + b"\x00" * bs)
    cfg = bt.EngineConfig(codec=bt.Codec.ZSTD, block_size=bs, burst_size=4,
                          max_pool_slots=64, use_device_kernels=True, level=3,
                          checksum=bt.Checksum.CRC32)
    with bt.Engine(cfg) as eng:
        unit = eng.compress(data)
        out = eng.decompress(unit)
        assert out.tobytes() == data
        assert (unit.table_status == 0).all()
        assert eng.stats.host_decode_bursts == 0
        assert len(unit.lit_rows) >= 1
        blob = unit.to_host().to_bytes()
        eng.recycle(unit)
    with bt.Engine(cfg) as eng:
        unit = eng.import_unit(CompressedBuffers.from_bytes(blob))
        out = eng.decompress(unit)
        assert out.tobytes() == data
        eng.recycle(unit)


def test_encoder_roundtrip_vs_reference(rng):
    # Native encoder output must decode bit-exactly with BOTH the upstream
    # module (wire-format conformance) and our own decoder.
    dctx = zstandard.ZstdDecompressor()
    for name, data in corpus(rng):
        comp = native.zstd_compress(data)
        assert dctx.decompress(comp, max_output_size=len(data) + 64) == data, name
        assert native.zstd_decompress(comp, len(data) + 16).tobytes() == data, name


def test_encoder_multiblock_and_boundary_matches(rng):
    # Frames > 128 KiB split into multiple zstd blocks; matches that
    # straddle or end exactly at the block cut exercised the encoder's
    # pending-match continuation and the near-boundary min-match guard.
    dctx = zstandard.ZstdDecompressor()
    cases = []
    base = rng.integers(0, 256, 1000, dtype=np.uint8).tobytes()
    cases.append(("periodic1k", (base * 400)[: 3 * 131072 + 77]))
    cases.append(("rle_long", b"\x55" * (2 * 131072 + 1)))
    # match ends exactly at / just before the 128 KiB cut
    blk = 131072
    for delta in (-5, -4, -3, -1, 0, 1, 4):
        d = bytearray(rng.integers(0, 256, blk + 200, dtype=np.uint8).tobytes())
        d[blk + delta - 64 : blk + delta] = d[100:164]  # 64-byte match into the cut
        cases.append((f"cutmatch{delta}", bytes(d)))
    for name, data in cases:
        comp = native.zstd_compress(data)
        assert dctx.decompress(comp, max_output_size=len(data) + 64) == data, name
        assert native.zstd_decompress(comp, len(data) + 16).tobytes() == data, name


def test_encoder_edges():
    dctx = zstandard.ZstdDecompressor()
    assert dctx.decompress(native.zstd_compress(b""), max_output_size=8) == b""
    one = native.zstd_compress(b"x")
    assert dctx.decompress(one, max_output_size=8) == b"x"
    # incompressible input falls back to raw blocks within the 1.1x bound
    rnd = np.random.default_rng(3).integers(0, 256, 131072, np.uint8).tobytes()
    comp = native.zstd_compress(rnd)
    assert len(comp) <= len(rnd) + len(rnd) // 10
    with pytest.raises(StatusError):
        native.zstd_compress(b"hello world" * 100, dst_cap=4)


def test_engine_zstd_host_backend(rng):
    # use_device_kernels=False: the native decoder serves the batch path.
    data = bytes(rng.integers(97, 123, 30000, dtype=np.uint8))
    cfg = bt.EngineConfig(codec=bt.Codec.ZSTD, block_size=2048, burst_size=8,
                          max_pool_slots=64, use_device_kernels=False, level=5)
    with bt.Engine(cfg) as eng:
        unit = eng.compress(data)
        out = eng.decompress(unit)
        assert out.tobytes() == data
        eng.recycle(unit)
