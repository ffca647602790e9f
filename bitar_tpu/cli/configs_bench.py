"""BASELINE-config coverage harness: runs configs 1-3 and records one
artifact tying every BASELINE.json config to a runnable command and a
measured result (configs 4 and 5 have their own harnesses: ``cli.demo --mode skewed`` and
``cli.multihost_bench``).  It needs a GPU and exits with status 2 without
one; every record names the device it ran on.

  1. 64 MiB Parquet file, synchronous LZ4 round-trip, bit-exact verify
     (reference: demo_app sync suite, ``demo_app.cc:487-546``).
  2. 1 GiB raw buffer in 128 KiB blocks, LZ4 compress+decompress on one
     GPU, burst-pipelined launches (``demo_app.cc:157-318`` hot loop).
  3. 8 concurrent streams, mixed LZ4+Zstd engines, one host, bit-exact
     per stream (reference async suite, ``demo_app.cc:548-693``).

Usage::

    python -m bitar_tpu.cli.configs_bench [--out CONFIGS.json] [--gib 1.0]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import jax
import numpy as np

from ..utils.compile_cache import configure_compile_cache
from ..utils.device_info import device_record, require_gpu

def _engine_knobs() -> dict:
    """commit="deferred" is the reference contract: Compress ends when
    output reaches pool memory (device.cc:157-238); the arena upload is
    decode-side DMA and lands in the decode prep."""
    return dict(burst_size=256, commit="deferred")


def _mixed_buffer(nbytes: int, seed: int = 11) -> bytes:
    rng = np.random.default_rng(seed)
    parts = []
    chunk = 1 << 20
    kinds = 4
    for i in range(-(-nbytes // chunk)):
        k = i % kinds
        if k == 0:
            parts.append((b"config bench text %d " % i) * (chunk // 19 + 1))
        elif k == 1:
            parts.append(rng.integers(0, 16, chunk, np.uint8).tobytes())
        elif k == 2:
            parts.append(rng.integers(0, 256, chunk, np.uint8).tobytes())
        else:
            parts.append(bytes([i & 0xFF]) * chunk)
    return b"".join(p[:chunk] for p in parts)[:nbytes]


def config1_parquet_sync(tmpdir: str) -> dict:
    """64 MiB Parquet -> Arrow IPC bytes -> sync LZ4 round-trip."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    import bitar_tpu as bt
    from .demo import read_data

    rng = np.random.default_rng(3)
    n = 2_000_000                     # ~64 MiB across mixed-type columns
    table = pa.table({
        "id": pa.array(np.arange(n, dtype=np.int64)),
        "bucket": pa.array(rng.integers(0, 50, n, np.int32)),
        "value": pa.array(np.round(rng.normal(size=n), 3)),
        "tag": pa.array(np.char.add("tag-", rng.integers(
            0, 1000, n).astype(str))),
    })
    path = f"{tmpdir}/config1.parquet"
    pq.write_table(table, path)
    data = read_data(path)            # Parquet -> Arrow IPC stream bytes
    cfg = bt.EngineConfig(
        codec=bt.Codec.LZ4, block_size=128 * 1024,
        max_pool_slots=-(-len(data) // (128 * 1024)) + 32,
        **_engine_knobs())
    eng = bt.Engine(cfg).initialize()
    best_c = best_d = float("inf")
    unit = None
    for _ in range(3):
        if unit is not None:
            eng.recycle(unit)
        t0 = time.perf_counter()
        unit = eng.compress(data)
        best_c = min(best_c, time.perf_counter() - t0)
    ok = eng.decompress(unit).tobytes() == data   # bit-exact gate (untimed)
    for _ in range(3):
        best_d = min(best_d, _device_decode_time(eng, unit, len(data)))
    ratio = round(unit.manifest.ratio(), 3)
    eng.recycle(unit)
    eng.release()
    return dict(
        config=1, input="64 MiB Parquet -> Arrow IPC stream",
        bytes=len(data), ratio=ratio,
        compress_GBps=round(len(data) / best_c / 1e9, 3),
        decompress_GBps=round(len(data) / best_d / 1e9, 3),
        bit_exact=bool(ok))


def config2_one_gib(gib: float) -> dict:
    """Large-buffer single-GPU pipeline at 128 KiB blocks."""
    import bitar_tpu as bt

    nbytes = int(gib * (1 << 30))
    data = _mixed_buffer(nbytes)
    nblocks = -(-len(data) // (128 * 1024))
    cfg = bt.EngineConfig(
        codec=bt.Codec.LZ4, block_size=128 * 1024,
        max_pool_slots=nblocks + 32, **_engine_knobs())
    eng = bt.Engine(cfg).initialize()
    # Best-of-3 like the reference (kNumTests=3, demo_app.h:45).  The
    # first run additionally pays the host's first-touch page faults;
    # steady state is the engine's rate, cold is reported alongside.
    t_cold = best_c = float("inf")
    unit = None
    for run in range(3):
        if unit is not None:
            eng.recycle(unit)
        t0 = time.perf_counter()
        unit = eng.compress(data)
        dt = time.perf_counter() - t0
        if run == 0:
            t_cold = dt
        best_c = min(best_c, dt)
    ok = eng.decompress(unit).tobytes() == data   # bit-exact gate (untimed)
    t_d = min(_device_decode_time(eng, unit, nbytes) for _ in range(2))
    ratio = round(unit.manifest.ratio(), 3)
    eng.recycle(unit)
    eng.release()
    return dict(
        config=2, input=f"{gib} GiB mixed buffer, {nblocks} x 128 KiB",
        bytes=nbytes, ratio=ratio,
        compress_GBps=round(nbytes / best_c / 1e9, 3),
        compress_cold_GBps=round(nbytes / t_cold / 1e9, 3),
        decompress_GBps=round(nbytes / t_d / 1e9, 3),
        bit_exact=bool(ok))


def _device_decode_time(eng, unit, nbytes: int) -> float:
    """Time a device-resident decode of the whole unit (the production
    contract: decoded blocks feed further device compute; ``decompress``
    adds a host readout)."""
    t0 = time.perf_counter()
    jax.block_until_ready(eng.decompress_device(unit))
    return time.perf_counter() - t0


def _run_streams(datas: list[bytes], codecs: list, reps: int = 2) -> float:
    """Round-trip ``len(datas)`` concurrent streams (one engine each);
    returns the best wall time.  Timed work per stream = compress +
    table build + device-resident decode; full-output verify runs
    untimed afterwards."""
    import bitar_tpu as bt

    engines = []
    for s, codec in enumerate(codecs):
        knobs = dict(_engine_knobs(), burst_size=64)
        cfg = bt.EngineConfig(
            codec=codec, block_size=128 * 1024,
            max_pool_slots=len(datas[s]) // (128 * 1024) + 16, **knobs)
        engines.append(bt.Engine(cfg).initialize())

    best = float("inf")
    units: dict[int, object] = {}
    for _ in range(reps):
        for s, eng in enumerate(engines):
            if s in units:
                eng.recycle(units.pop(s))
        streams = []
        t0 = time.perf_counter()
        for s, eng in enumerate(engines):
            stream = bt.Stream(engine=eng, stream_id=s)

            def cb(st, result, s=s, eng=eng):
                if not result.is_ok():
                    return result.status.to_int()
                unit = result.value()
                jax.block_until_ready(eng.decompress_device(unit))
                units[s] = unit
                return bt.ASYNC_RETURN_OK

            stream.compress_async(bt.CompressParam(
                engine=eng, data=datas[s],
                result_callback=cb)).raise_if_error()
            streams.append(stream)
        rcs = [s.wait() for s in streams]
        best = min(best, time.perf_counter() - t0)
        assert all(rc == bt.ASYNC_RETURN_OK for rc in rcs), rcs
        for s in streams:
            s.close()
    ok = True
    for s, eng in enumerate(engines):
        if s in units:
            out = eng.decompress(units[s])     # untimed full verify
            ok = ok and out.tobytes() == datas[s]
            eng.recycle(units[s])
        eng.release()
    if not ok:
        raise AssertionError("stream round-trip not bit-exact")
    return best


def _decode_scaling(datas: list[bytes], codecs: list, reps: int = 3) -> float:
    """Device-resident decode wall time for N concurrent streams: units
    are compressed, committed, and given tables UNTIMED; the timed region
    dispatches every stream's decode launches (jax async — they pipeline
    on the one device) and joins them all."""
    import bitar_tpu as bt

    engines, units = [], []
    for s, codec in enumerate(codecs):
        knobs = dict(_engine_knobs(), burst_size=64)
        cfg = bt.EngineConfig(
            codec=codec, block_size=128 * 1024,
            max_pool_slots=len(datas[s]) // (128 * 1024) + 16, **knobs)
        eng = bt.Engine(cfg).initialize()
        unit = eng.compress(datas[s])
        eng.ensure_tables(unit)                # commits + builds tables
        assert eng.decompress(unit).tobytes() == datas[s]  # verify, warm
        engines.append(eng)
        units.append(unit)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready([eng.decompress_device(unit)
                               for eng, unit in zip(engines, units)])
        best = min(best, time.perf_counter() - t0)
    for eng, unit in zip(engines, units):
        eng.recycle(unit)
        eng.release()
    return best


def _decode_scaling_batched(datas: list[bytes], codecs: list,
                            reps: int = 3) -> float:
    """N streams' decodes merged into ONE dispatch chain
    (``prepare_batched_decode``): one launch with one fixed dispatch
    cost instead of N small launches.  Units compress untimed; the timed
    region is the batched launch + join.  Output verified bit-exact per
    stream (untimed)."""
    import bitar_tpu as bt
    from bitar_tpu.engine.device import prepare_batched_decode

    engines, units = [], []
    for s, codec in enumerate(codecs):
        knobs = dict(_engine_knobs(), burst_size=64)
        cfg = bt.EngineConfig(
            codec=codec, block_size=128 * 1024,
            max_pool_slots=len(datas[s]) // (128 * 1024) + 16, **knobs)
        eng = bt.Engine(cfg).initialize()
        unit = eng.compress(datas[s])
        engines.append(eng)
        units.append(unit)
    launch, slices = prepare_batched_decode(list(zip(engines, units)))
    host = np.asarray(launch())                      # warm + verify
    for (lo, hi), d in zip(slices, datas):
        got = host[lo:hi].reshape(-1).tobytes()[:len(d)]
        assert got == d, "batched stream decode not bit-exact"
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        launch().block_until_ready()
        best = min(best, time.perf_counter() - t0)
    for eng, unit in zip(engines, units):
        eng.recycle(unit)
        eng.release()
    return best


def config3_mixed_streams() -> dict:
    """8 concurrent streams (4 LZ4 + 4 Zstd engines) — the reference
    async suite's scaling question (``demo_app.cc:548-693``) answered
    per phase on one GPU:

    * ``decode_*``: device-resident decode only.
      ``decode_stream_scaling`` compares CODEC-MATCHED arms: 8
      concurrent mixed streams vs the sum of one 32 MiB LZ4 run and one
      32 MiB Zstd run over the same bytes (an all-LZ4 baseline is kept
      as ``decode_one_stream_GBps``).
    * ``round_trip_*``: compress + staging + decode.
    """
    import bitar_tpu as bt

    per_stream = 8 * (1 << 20)
    datas = [_mixed_buffer(per_stream, seed=100 + s) for s in range(8)]
    total = 8 * per_stream
    codecs8 = [bt.Codec.LZ4 if s % 2 == 0 else bt.Codec.ZSTD
               for s in range(8)]

    dec8 = _decode_scaling(datas, codecs8)
    dec8b = _decode_scaling_batched(datas, codecs8)
    lz4_bytes = b"".join(datas[s] for s in range(8) if s % 2 == 0)
    zstd_bytes = b"".join(datas[s] for s in range(8) if s % 2 == 1)
    dec_lz4 = _decode_scaling([lz4_bytes], [bt.Codec.LZ4])
    dec_zstd = _decode_scaling([zstd_bytes], [bt.Codec.ZSTD])
    dec1 = _decode_scaling([b"".join(datas)], [bt.Codec.LZ4])
    wall8 = _run_streams(datas, codecs8)
    wall1 = _run_streams([b"".join(datas)], [bt.Codec.LZ4])
    return dict(
        config=3, input="8 streams x 8 MiB (4 LZ4 + 4 Zstd)",
        bytes=total,
        decode_GBps=round(total / dec8 / 1e9, 3),
        decode_batched_GBps=round(total / dec8b / 1e9, 3),
        decode_one_stream_GBps=round(total / dec1 / 1e9, 3),
        decode_matched_serial_GBps=round(total / (dec_lz4 + dec_zstd) / 1e9, 3),
        decode_stream_scaling=round((dec_lz4 + dec_zstd) / dec8, 2),
        decode_batched_scaling=round((dec_lz4 + dec_zstd) / dec8b, 2),
        round_trip_GBps=round(total / wall8 / 1e9, 3),
        round_trip_one_stream_GBps=round(total / wall1 / 1e9, 3),
        bit_exact=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--gib", type=float, default=1.0)
    ap.add_argument("--configs", default="1,2,3")
    args = ap.parse_args(argv)
    require_gpu("configs_bench")
    configure_compile_cache()

    import tempfile

    runs = []
    todo = {int(c) for c in args.configs.split(",")}
    if 1 in todo:
        with tempfile.TemporaryDirectory() as td:
            runs.append(config1_parquet_sync(td))
        print(json.dumps(runs[-1]), file=sys.stderr)
    if 2 in todo:
        runs.append(config2_one_gib(args.gib))
        print(json.dumps(runs[-1]), file=sys.stderr)
    if 3 in todo:
        runs.append(config3_mixed_streams())
        print(json.dumps(runs[-1]), file=sys.stderr)

    artifact = dict(
        note=("BASELINE.json configs 1-3; config 4 -> cli.demo --mode "
              "skewed, config 5 -> cli.multihost_bench"),
        device=device_record(), runs=runs)
    blob = json.dumps(artifact, indent=1)
    print(blob)
    if args.out:
        with open(args.out, "w") as f:
            f.write(blob + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
