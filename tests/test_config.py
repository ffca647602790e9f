import pytest

from bitar_tpu.config import (
    CPU,
    GPU,
    Codec,
    EngineConfig,
    capabilities_for_device,
    capabilities_for_platform,
    compress_bound,
    lz4_compress_bound,
    next_power_of_two,
)
from bitar_tpu.status import StatusError


def test_next_power_of_two():
    assert next_power_of_two(0) == 1
    assert next_power_of_two(1) == 1
    assert next_power_of_two(2) == 2
    assert next_power_of_two(3) == 4
    assert next_power_of_two(128 * 1024) == 128 * 1024
    assert next_power_of_two(128 * 1024 + 1) == 256 * 1024


def test_slot_size_rule():
    # Reference rule (config.cc:60-73): next pow2 >= 2*block when sane,
    # else 1.1x head-room; never below the codec's true compress bound.
    cfg = EngineConfig(codec=Codec.LZ4, block_size=128 * 1024)
    assert cfg.slot_size >= lz4_compress_bound(128 * 1024)
    assert cfg.slot_size % 128 == 0
    assert cfg.slot_size == 256 * 1024  # pow2 path

    cfg = EngineConfig(codec=Codec.LZ4, block_size=100)
    assert cfg.slot_size >= lz4_compress_bound(100)


def test_compress_bounds_monotone():
    for codec in Codec:
        assert compress_bound(codec, 0) > 0
        assert compress_bound(codec, 1 << 20) > (1 << 20)


def test_validate_ok():
    assert EngineConfig().validate(GPU).ok()
    assert EngineConfig(codec=Codec.ZSTD, level=9).validate(GPU).ok()


@pytest.mark.parametrize("kw,frag", [
    (dict(block_size=16), "block_size"),
    (dict(block_size=1 << 24), "block_size"),
    (dict(burst_size=0), "burst_size"),
    (dict(burst_size=10_000), "burst_size"),
    (dict(max_pool_slots=3), "max_pool_slots"),
    (dict(window_log=30), "window_log"),
    (dict(codec=Codec.LZ4, window_log=20), "LZ4 window_log"),
    (dict(level=99), "level"),
])
def test_validate_rejects(kw, frag):
    st = EngineConfig(**kw).validate(GPU)
    assert not st.ok()
    assert frag in st.message


def test_validate_cpu_class_allows_small_blocks():
    assert EngineConfig(block_size=64).validate(CPU).ok()
    assert not EngineConfig(block_size=64).validate(GPU).ok()


@pytest.mark.parametrize("platform,caps", [("gpu", GPU), ("cpu", CPU),
                                           ("GPU", GPU)])
def test_platform_maps_to_record(platform, caps):
    assert capabilities_for_platform(platform) is caps


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron", ""])
def test_unknown_platform_raises(platform):
    with pytest.raises(StatusError):
        capabilities_for_platform(platform)


def test_device_memory_limit_sets_arena_budget():
    class FakeGpu:
        platform = "gpu"

        def memory_stats(self):
            return {"bytes_limit": 100 << 30}

    class FakeCpu:
        platform = "cpu"

        def memory_stats(self):
            return None

    assert capabilities_for_device(FakeGpu()).hbm_budget_bytes == 50 << 30
    assert capabilities_for_device(FakeCpu()) is CPU
    # the bench's arena (1056 x 256 KiB slots) fits the static GPU record
    cfg = EngineConfig(block_size=128 * 1024, burst_size=1024,
                       max_pool_slots=1056)
    assert cfg.validate(GPU).ok()


def test_zstd_level_knob(rng=None):
    import numpy as np

    import bitar_tpu as bt
    rng = np.random.default_rng(4)
    data = (b"level knob " * 500) + bytes(rng.integers(0, 4, 4000, dtype=np.uint8))
    sizes = {}
    for level in (1, 9):
        cfg = bt.EngineConfig(codec=bt.Codec.ZSTD, block_size=8192,
                              max_pool_slots=32, level=level,
                              use_device_kernels=False)
        with bt.Engine(cfg) as eng:
            unit = eng.compress(data)
            sizes[level] = unit.manifest.total_comp
            assert eng.decompress(unit).tobytes() == data
            eng.recycle(unit)
    # zstd levels are not strictly monotone on small inputs; both must
    # round-trip and stay in the same ballpark.
    assert abs(sizes[9] - sizes[1]) < 0.2 * sizes[1]


def test_adler32_checksum_roundtrip():
    import bitar_tpu as bt
    cfg = bt.EngineConfig(codec=bt.Codec.SNAPPY, block_size=1024,
                          max_pool_slots=32, checksum=bt.Checksum.ADLER32,
                          use_device_kernels=False)
    with bt.Engine(cfg) as eng:
        data = b"adler " * 700
        unit = eng.compress(data)
        assert (unit.manifest.checksums != 0).any()
        assert eng.decompress(unit).tobytes() == data
        eng.recycle(unit)
