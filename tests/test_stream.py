"""Async stream tests: the EvaluateAsync semantics of the reference demo
app (``demo_app.cc:548-693``) — N parallel streams, busy rejection,
callback result delivery, join-and-harvest — as an automated suite.
"""

import threading
import time

import numpy as np
import pytest

import bitar_tpu as bt


def small_config(**kw) -> bt.EngineConfig:
    base = dict(codec=bt.Codec.LZ4, block_size=1024, burst_size=8,
                max_pool_slots=128, use_device_kernels=False)
    base.update(kw)
    return bt.EngineConfig(**base)


@pytest.fixture
def engine():
    eng = bt.Engine(small_config()).initialize()
    yield eng
    eng.release()


def test_async_compress_decompress_roundtrip(engine, rng):
    data = bytes(rng.integers(0, 7, 20_000, dtype=np.uint8))
    stream = bt.Stream(engine=engine, stream_id=0)
    results = {}

    def on_compress(s, result):
        results["unit"] = result.value()
        return bt.ASYNC_RETURN_OK

    st = stream.compress_async(bt.CompressParam(
        engine=engine, data=data, result_callback=on_compress))
    assert st.ok()
    assert stream.wait() == bt.ASYNC_RETURN_OK
    unit = results["unit"]

    def on_decompress(s, result):
        results["out"] = result.value()
        return bt.ASYNC_RETURN_OK

    st = stream.decompress_async(bt.DecompressParam(
        engine=engine, unit=unit, result_callback=on_decompress))
    assert st.ok()
    assert stream.wait() == bt.ASYNC_RETURN_OK
    assert results["out"].tobytes() == data
    engine.recycle(unit)
    stream.close()


def test_busy_stream_rejected(engine):
    # -EBUSY analog (util.h:218-221): a stream with an outstanding op
    # rejects new submissions instead of queueing.
    stream = bt.Stream(engine=engine, stream_id=0)
    gate = threading.Event()

    def slow_callback(s, result):
        gate.wait(timeout=10)
        return bt.ASYNC_RETURN_OK

    st = stream.compress_async(bt.CompressParam(
        engine=engine, data=b"a" * 5000, result_callback=slow_callback))
    assert st.ok()
    time.sleep(0.05)
    st2 = stream.compress_async(bt.CompressParam(engine=engine, data=b"b" * 100))
    assert not st2.ok()
    assert "busy" in st2.message
    gate.set()
    assert stream.wait() == bt.ASYNC_RETURN_OK
    stream.close()


def test_multi_stream_fanout(rng):
    # The async benchmark shape (demo_app.cc:548-693): split input evenly,
    # one stream per segment round-robined over engines, join all, verify
    # per-segment bit-exactness.
    drv = bt.Driver.instance()
    engines = drv.get_engines(small_config(), device_ids=[0, 1])
    try:
        num_streams = 6
        data = bytes(rng.integers(0, 32, 60_000, dtype=np.uint8))
        seg = len(data) // num_streams
        segments = [data[i * seg:(i + 1) * seg] for i in range(num_streams - 1)]
        segments.append(data[(num_streams - 1) * seg:])

        streams = bt.make_streams(engines, num_streams)
        units: dict[int, bt.CompressedUnit] = {}

        def make_cb(i):
            def cb(s, result):
                units[i] = result.value()
                return bt.ASYNC_RETURN_OK
            return cb

        for i, s in enumerate(streams):
            assert s.compress_async(bt.CompressParam(
                engine=s.engine, data=segments[i],
                result_callback=make_cb(i))).ok()
        assert bt.wait_all(streams) == [bt.ASYNC_RETURN_OK] * num_streams

        outs: dict[int, np.ndarray] = {}

        def make_dcb(i):
            def cb(s, result):
                outs[i] = result.value()
                return bt.ASYNC_RETURN_OK
            return cb

        for i, s in enumerate(streams):
            assert s.decompress_async(bt.DecompressParam(
                engine=s.engine, unit=units[i],
                result_callback=make_dcb(i))).ok()
        assert bt.wait_all(streams) == [bt.ASYNC_RETURN_OK] * num_streams

        for i in range(num_streams):
            assert outs[i].tobytes() == segments[i], f"segment {i}"
            assert units[i].engine.recycle(units[i]) == units[i].nblocks
        for s in streams:
            s.close()
    finally:
        for e in engines:
            e.release()


def test_error_delivered_through_callback(engine):
    # A failing operation delivers Result.error to the callback; the
    # callback's return is harvested by wait (negative status bridge).
    stream = bt.Stream(engine=engine, stream_id=0)
    seen = {}

    recycled = engine.compress(b"x" * 100)
    engine.recycle(recycled)  # now invalid for decompress

    def cb(s, result):
        seen["ok"] = result.is_ok()
        return result.status.to_int() if not result.is_ok() else bt.ASYNC_RETURN_OK

    st = stream.decompress_async(bt.DecompressParam(
        engine=engine, unit=recycled, result_callback=cb))
    assert st.ok()
    rc = stream.wait()
    assert seen["ok"] is False
    assert rc < 0
    stream.close()


def test_wait_on_idle_stream(engine):
    stream = bt.Stream(engine=engine, stream_id=0)
    assert stream.wait() == 0
    assert not stream.busy()
    stream.close()


def test_recycle_reuse_stress_concurrent_streams(rng):
    # Arena ABA stress: two streams hammer compress -> decompress ->
    # recycle against ONE engine with a pool tight enough that every
    # round reuses slots the other stream just returned.  Any stale-slot
    # aliasing (a unit reading a slot that was recycled and rewritten)
    # breaks bit-exactness.
    eng = bt.Engine(small_config(max_pool_slots=48)).initialize()
    payloads = [
        bytes(rng.integers(0, 256, 1024 * 18, dtype=np.uint8)),
        (b"stream stress %d " % 7) * 1200,
    ]
    errors: list[str] = []
    rounds = 12

    def hammer(tag: int) -> None:
        data = payloads[tag]
        try:
            for r in range(rounds):
                unit = eng.compress(data)
                out = eng.decompress(unit)
                if out.tobytes() != data:
                    errors.append(f"stream {tag} round {r}: mismatch")
                    return
                eng.recycle(unit)
        except bt.StatusError as e:            # pool pressure is a fail too
            errors.append(f"stream {tag}: {e}")

    threads = [threading.Thread(target=hammer, args=(t,)) for t in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert eng.arena.pool.in_use() == 0        # every slot went back
    eng.release()
