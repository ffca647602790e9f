"""Engine integration tests: the EvaluateSync behavior of the reference
demo app (``demo_app.cc:487-546``) as an automated suite — compress,
decompress, memcmp against the original, recycle-count assertions — plus
the state machine and error paths.

Runs on CPU: most cases use the host codec path
(``use_device_kernels=False``); the device-decode cases run the sequence
executor on JAX's CPU backend, the same program a GPU runs.
"""

import numpy as np
import pytest

import bitar_tpu as bt


def small_config(**kw) -> bt.EngineConfig:
    base = dict(codec=bt.Codec.LZ4, block_size=1024, burst_size=8,
                max_pool_slots=64, use_device_kernels=False)
    base.update(kw)
    return bt.EngineConfig(**base)


@pytest.fixture
def engine():
    eng = bt.Engine(small_config()).initialize()
    yield eng
    eng.release()


def make_data(rng, n=10_000):
    parts = [
        (b"engine test payload " * 200)[:n // 3],
        bytes(rng.integers(0, 256, n // 3, dtype=np.uint8)),
        b"\x42" * (n - 2 * (n // 3)),
    ]
    return b"".join(parts)


def test_sync_roundtrip_bit_exact(engine, rng):
    data = make_data(rng)
    unit = engine.compress(data)
    assert unit.nblocks == -(-len(data) // 1024)
    out = engine.decompress(unit)
    assert out.tobytes() == data  # the memcmp oracle (demo_app.cc:534-543)
    assert engine.recycle(unit) == unit.nblocks  # recycle-count assert
    assert engine.stats.bytes_compressed == len(data)
    assert engine.stats.bytes_decompressed == len(data)


@pytest.mark.parametrize("codec", [bt.Codec.LZ4, bt.Codec.SNAPPY,
                                   bt.Codec.ZSTD, bt.Codec.RAW])
def test_all_codecs_roundtrip(codec, rng):
    with bt.Engine(small_config(codec=codec)) as eng:
        data = make_data(rng, 5000)
        unit = eng.compress(data)
        out = eng.decompress(unit)
        assert out.tobytes() == data
        eng.recycle(unit)


def test_device_kernel_path(rng):
    # Full engine flow through the device sequence executor.
    cfg = small_config(block_size=256, use_device_kernels=True, burst_size=4)
    with bt.Engine(cfg) as eng:
        data = (b"device path! " * 60)[:700]
        unit = eng.compress(data)
        out = eng.decompress(unit)
        # tables are built lazily at the first decode
        assert unit.tables is not None
        assert out.tobytes() == data
        assert eng.stats.device_decode_bursts > 0
        assert eng.stats.host_decode_bursts == 0
        eng.recycle(unit)


BLOCK = 16 * 1024


def device_engine(**kw):
    base = dict(codec=bt.Codec.LZ4, block_size=BLOCK, burst_size=4,
                max_pool_slots=32, use_device_kernels=True)
    base.update(kw)
    return bt.Engine(bt.EngineConfig(**base)).initialize()


def test_engine_planned_path_roundtrip(rng):
    # Multi-burst unit with a ragged tail through the device path.
    with device_engine() as eng:
        data = (b"engine device path " * 2000)[:2 * BLOCK + 777]
        unit = eng.compress(data)
        eng.ensure_tables(unit)
        assert unit.tables is not None and (unit.table_status == 0).all()
        out = eng.decompress(unit)
        assert out.tobytes() == data
        eng.recycle(unit)


def test_engine_planned_mixed_entropy(rng):
    with device_engine() as eng:
        data = (rng.integers(0, 256, BLOCK, dtype=np.uint8).tobytes()
                + b"\x00" * BLOCK
                + (b"abcabcabc" * (BLOCK // 9 + 1))[:BLOCK])
        unit = eng.compress(data)
        out = eng.decompress(unit)
        assert out.tobytes() == data
        eng.recycle(unit)


def test_engine_small_blocks_decode_on_device(rng):
    # 1 KiB blocks ride the same executor (no block-size floor of its own).
    with device_engine(block_size=1024, burst_size=4) as eng:
        data = (b"small blocks " * 300)[:2500]
        unit = eng.compress(data)
        out = eng.decompress(unit)
        assert out.tobytes() == data
        assert eng.stats.host_decode_bursts == 0
        eng.recycle(unit)


def test_decompress_device_planned(rng):
    import jax
    with device_engine() as eng:
        data = (b"device resident " * (BLOCK // 15 + 1))[:BLOCK] + b"\x44" * BLOCK
        unit = eng.compress(data)
        bursts = eng.decompress_device(unit)
        jax.block_until_ready(bursts)
        host = np.concatenate([np.asarray(b) for b in bursts])
        assert host.shape[1] == BLOCK
        got = b"".join(host[i].tobytes()[:int(unit.manifest.raw_len[i])]
                       for i in range(unit.nblocks))
        assert got == data
        eng.recycle(unit)


def test_prepare_device_decode_relaunches(rng):
    # The staged whole-unit launch is repeatable and matches decompress.
    with device_engine(codec=bt.Codec.ZSTD) as eng:
        data = (b"resident relaunch " * (3 * BLOCK // 18 + 1))[:3 * BLOCK - 5]
        unit = eng.compress(data)
        launch = eng.prepare_device_decode(unit)
        first, second = np.asarray(launch()), np.asarray(launch())
        assert (first == second).all() and first.shape == (3, BLOCK)
        assert first.reshape(-1)[:len(data)].tobytes() == data
        eng.recycle(unit)


def test_incompressible_fallback_to_raw(engine, rng):
    data = bytes(rng.integers(0, 256, 4096, dtype=np.uint8))
    unit = engine.compress(data)
    # random bytes expand under LZ4 -> stored RAW, never bigger than input
    raw_id = bt.manifest.codec_id(bt.Codec.RAW)
    assert (unit.manifest.codec_ids == raw_id).all()
    assert (unit.manifest.comp_len == unit.manifest.raw_len).all()
    assert engine.decompress(unit).tobytes() == data
    engine.recycle(unit)


def test_checksum_verification(rng):
    cfg = small_config(checksum=bt.Checksum.CRC32)
    with bt.Engine(cfg) as eng:
        data = make_data(rng, 3000)
        unit = eng.compress(data)
        assert (unit.manifest.checksums != 0).any()
        out = eng.decompress(unit)
        assert out.tobytes() == data
        # corrupt a checksum -> decompress must fail loudly
        unit.manifest.checksums[0] ^= 0xFF
        with pytest.raises(bt.StatusError):
            eng.decompress(unit)
        eng.recycle(unit)


def test_caller_provided_output_buffer(engine, rng):
    # The ResizableBuffer contract (device.cc:241-318): caller buffer may be
    # larger; returned view is exact.
    data = make_data(rng, 2500)
    unit = engine.compress(data)
    buf = np.zeros(10_000, dtype=np.uint8)
    out = engine.decompress(unit, out=buf)
    assert out.shape[0] == len(data)
    assert out.tobytes() == data
    with pytest.raises(bt.StatusError):  # too-small buffer rejected
        engine.decompress(unit, out=np.zeros(10, dtype=np.uint8))
    engine.recycle(unit)


def test_state_machine(rng):
    eng = bt.Engine(small_config())
    with pytest.raises(bt.StatusError):  # not started
        eng.compress(b"x" * 100)
    eng.initialize()
    with pytest.raises(bt.StatusError):  # double init
        eng.initialize()
    unit = eng.compress(b"y" * 100)
    eng.recycle(unit)
    eng.release()
    with pytest.raises(bt.StatusError):  # released
        eng.compress(b"z" * 100)


def test_double_recycle_rejected(engine, rng):
    unit = engine.compress(b"w" * 500)
    engine.recycle(unit)
    with pytest.raises(bt.StatusError):
        engine.recycle(unit)
    with pytest.raises(bt.StatusError):  # and decompress of recycled unit
        engine.decompress(unit)


def test_cross_engine_unit_rejected(rng):
    with bt.Engine(small_config()) as e1, bt.Engine(small_config()) as e2:
        unit = e1.compress(b"q" * 300)
        with pytest.raises(bt.StatusError):
            e2.decompress(unit)
        e1.recycle(unit)


def test_export_import_host_roundtrip(engine, rng):
    # Device-resident unit -> host container -> re-imported -> decompressed.
    data = make_data(rng, 6000)
    unit = engine.compress(data)
    cb = unit.to_host()
    blob = cb.to_bytes()
    engine.recycle(unit)

    cb2 = bt.CompressedBuffers.from_bytes(blob)
    unit2 = engine.import_unit(cb2)
    out = engine.decompress(unit2)
    assert out.tobytes() == data
    engine.recycle(unit2)


def test_pool_exhaustion_is_capacity_error(rng):
    cfg = small_config(max_pool_slots=20)
    with bt.Engine(cfg) as eng:
        data = bytes(rng.integers(0, 256, 30 * 1024, dtype=np.uint8))  # 30 blocks
        with pytest.raises(bt.StatusError) as ei:
            eng.compress(data)
        assert ei.value.status.code == bt.StatusCode.CAPACITY_ERROR


def test_driver_discovery():
    drv = bt.Driver.instance()
    assert drv is bt.Driver.instance()
    devs = drv.list_available_devices()
    assert len(devs) == 8  # virtual CPU mesh from conftest
    info = drv.describe()
    assert info["process_count"] == 1
    engines = drv.get_engines(small_config(), device_ids=[0, 1])
    assert len(engines) == 2
    placed = bt.Driver.place_streams(5, engines)
    assert [e.device_index for e in placed] == [0, 1, 0, 1, 0]
    for e in engines:
        e.release()


def test_import_rejects_block_size_mismatch(engine, rng):
    # A container built at a different block size must be rejected —
    # decoding it with this engine's plans/layouts would corrupt output.
    data = b"m" * 5000
    other = bt.Engine(small_config(block_size=2048)).initialize()
    try:
        unit = other.compress(data)
        cb = unit.to_host()
        other.recycle(unit)
        with pytest.raises(bt.StatusError) as ei:
            engine.import_unit(cb)
        assert "block_size" in str(ei.value)
    finally:
        other.release()


def test_batched_multi_stream_decode():
    """prepare_batched_decode merges mixed-codec units into one launch
    and stays bit-exact per stream (the one-device answer to the
    reference's async fan-out, demo_app.cc:548-693)."""
    import bitar_tpu as bt
    from bitar_tpu.engine.device import prepare_batched_decode

    block = 16 * 1024
    items, datas = [], []
    for s_i, codec in enumerate([bt.Codec.LZ4, bt.Codec.ZSTD,
                                 bt.Codec.SNAPPY]):
        cfg = bt.EngineConfig(codec=codec, block_size=block, burst_size=16,
                              max_pool_slots=64, commit="deferred",
                              use_device_kernels=True)
        eng = bt.Engine(cfg).initialize()
        rng = np.random.default_rng(40 + s_i)
        parts = []
        for i in range(5):
            k = i % 3
            if k == 0:
                parts.append(((b"stream %d " % s_i) * (block // 9 + 1))[:block])
            elif k == 1:
                parts.append(rng.integers(0, 8, block, np.uint8).tobytes())
            else:
                parts.append(rng.integers(0, 256, block, np.uint8).tobytes())
        d = b"".join(parts)
        items.append((eng, eng.compress(d)))
        datas.append(d)
    launch, slices = prepare_batched_decode(items)
    out = np.asarray(launch())
    for (lo, hi), d in zip(slices, datas):
        assert out[lo:hi].reshape(-1).tobytes() == d
    for eng, unit in items:
        eng.recycle(unit)
        eng.release()
