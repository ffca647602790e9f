"""Demo / benchmark CLI.

The rebuild of the reference demo app (``apps/demo_app.cc``): ingest a
file (raw bytes, or Parquet/Feather serialized to an Arrow IPC stream),
run the synchronous and asynchronous benchmark suites 3x each, print
duration + GB/s per phase, and verify decompressed output memcmp-equal to
the original input (``demo_app.cc:487-546`` sync, ``:548-693`` async).

Config tiers mirror the reference's three (``README.md:80-82``):
EAL flags -> environment (JAX_PLATFORMS etc.), app flags -> this CLI,
programmatic -> EngineConfig.

Usage::

    python -m bitar_tpu.cli.demo --file data.parquet --codec lz4
    python -m bitar_tpu.cli.demo --file big.bin --bytes 1000000 --mode sync
"""

from __future__ import annotations

import argparse
import signal
import sys
import time

import jax
import numpy as np

from ..config import Checksum, Codec, EngineConfig
from ..engine.device import Engine
from ..engine.driver import Driver
from ..engine.stream import (
    ASYNC_RETURN_OK,
    CompressParam,
    DecompressParam,
    make_streams,
    wait_all,
)
from ..status import StatusError
from ..utils.compile_cache import configure_compile_cache
from ..utils.logging import get_logger
from ..utils.timing import NUM_BENCH_RUNS, PhaseTiming, time_phase

logger = get_logger("cli.demo")


def cleanup_and_exit(code: int, message: str = "") -> None:
    """Fatal-path exit (reference ``CleanupAndExit`` -> ``rte_exit``,
    ``common.h:33-39``); jax cleans its runtime atexit."""
    if message:
        print(message, file=sys.stderr)
    sys.exit(code)


def install_signal_handlers() -> None:
    """SIGINT/SIGTERM -> orderly exit (reference ``app_common.cc:54-63``)."""

    def handler(signum, frame):
        cleanup_and_exit(128 + signum, f"caught signal {signum}, exiting")

    signal.signal(signal.SIGINT, handler)
    signal.signal(signal.SIGTERM, handler)


# ---------------------------------------------------------------------------
# Ingest (reference ReadData, demo_app.cc:297-330)


def read_data(path: str, nbytes: int | None = None) -> bytes:
    """Read benchmark input: Parquet/Feather -> Arrow IPC stream bytes
    (serialization timed 3x like the reference's SerializeTable,
    ``demo_app.cc:144-193``), anything else -> raw bytes."""
    lower = path.lower()
    if lower.endswith((".parquet", ".feather", ".arrow")):
        data = _read_arrow_table(path)
    else:
        with open(path, "rb") as f:
            data = f.read()
    if nbytes is not None:
        if nbytes > len(data):
            reps = -(-nbytes // max(1, len(data)))
            data = (data * reps)[:nbytes]
        else:
            data = data[:nbytes]
    return data


def _read_arrow_table(path: str) -> bytes:
    try:
        import pyarrow as pa
    except ImportError:
        cleanup_and_exit(2, "pyarrow unavailable; pass a raw file instead")
    import pyarrow.ipc

    if path.lower().endswith(".parquet"):
        import pyarrow.parquet as pq
        table = pq.read_table(path)
    else:
        import pyarrow.feather as pf
        table = pf.read_table(path)

    out = None
    for run in range(NUM_BENCH_RUNS):
        t0 = time.perf_counter()
        sink = pa.BufferOutputStream()
        with pa.ipc.new_stream(sink, table.schema) as writer:
            writer.write_table(table)
        out = sink.getvalue()
        dt = time.perf_counter() - t0
        logger.info("serialize table run %d: %.0f us (%.3f GB/s)",
                    run, dt * 1e6, out.size / dt / 1e9)
    return out.to_pybytes()


# ---------------------------------------------------------------------------
# Sync benchmark (reference EvaluateSync, demo_app.cc:487-546)


def evaluate_sync(engine: Engine, data: bytes) -> list[PhaseTiming]:
    timings = []
    state = {}

    def compress_once():
        if "unit" in state:
            engine.recycle(state["unit"])
        state["unit"] = engine.compress(data)
        return None

    t = time_phase("sync compress", len(data), compress_once)
    timings.append(t)
    unit = state["unit"]
    print(t.report(), f" ratio={unit.manifest.ratio():.3f}")

    out_buf = np.empty(unit.manifest.total_raw, dtype=np.uint8)
    state_out = {}

    def decompress_once():
        state_out["out"] = engine.decompress(unit, out=out_buf)
        return None

    t = time_phase("sync decompress", len(data), decompress_once)
    timings.append(t)
    print(t.report())

    out = state_out["out"]
    if out.tobytes() != data:
        cleanup_and_exit(3, "VERIFY FAILED: sync round-trip not bit-exact")
    print(f"sync verify OK ({len(data):,} bytes bit-exact)")
    recycled = engine.recycle(unit)
    assert recycled == unit.nblocks, (recycled, unit.nblocks)
    return timings


# ---------------------------------------------------------------------------
# Async benchmark (reference EvaluateAsync, demo_app.cc:548-693)


def evaluate_async(engines: list[Engine], data: bytes, num_streams: int
                   ) -> list[PhaseTiming]:
    seg = len(data) // num_streams
    segments = [data[i * seg:(i + 1) * seg] for i in range(num_streams - 1)]
    segments.append(data[(num_streams - 1) * seg:])
    streams = make_streams(engines, num_streams)
    timings = []
    try:
        units: dict[int, object] = {}
        for run in range(NUM_BENCH_RUNS):
            for u in units.values():
                u.engine.recycle(u)
            units.clear()
            done_at = {}

            def make_cb(i):
                def cb(s, result):
                    units[i] = result.value()
                    done_at[i] = time.perf_counter()
                    return ASYNC_RETURN_OK
                return cb

            t0 = time.perf_counter()
            for i, s in enumerate(streams):
                st = s.compress_async(CompressParam(
                    engine=s.engine, data=segments[i],
                    result_callback=make_cb(i)))
                if not st.ok():
                    cleanup_and_exit(4, f"stream {i} submit failed: {st}")
            rcs = wait_all(streams)
            t1 = max(done_at.values())
            if rcs != [ASYNC_RETURN_OK] * num_streams:
                cleanup_and_exit(4, f"async compress rc={rcs}")
            timings.append(PhaseTiming(
                "async compress", len(data), [t1 - t0]))
            print(timings[-1].report(), f"(run {run}, {num_streams} streams)")

        outs: dict[int, np.ndarray] = {}
        for run in range(NUM_BENCH_RUNS):
            outs.clear()
            done_at = {}

            def make_dcb(i):
                def cb(s, result):
                    outs[i] = result.value()
                    done_at[i] = time.perf_counter()
                    return ASYNC_RETURN_OK
                return cb

            t0 = time.perf_counter()
            for i, s in enumerate(streams):
                st = s.decompress_async(DecompressParam(
                    engine=s.engine, unit=units[i],
                    result_callback=make_dcb(i)))
                if not st.ok():
                    cleanup_and_exit(4, f"stream {i} submit failed: {st}")
            rcs = wait_all(streams)
            t1 = max(done_at.values())
            if rcs != [ASYNC_RETURN_OK] * num_streams:
                cleanup_and_exit(4, f"async decompress rc={rcs}")
            timings.append(PhaseTiming(
                "async decompress", len(data), [t1 - t0]))
            print(timings[-1].report(), f"(run {run})")

        # Per-stream latency distribution (the p99 block-latency metric of
        # the skewed-size benchmark config).
        lats = sorted((done_at[i] - t0) * 1e3 for i in done_at)
        if lats:
            p50 = lats[len(lats) // 2]
            p99 = lats[min(len(lats) - 1, int(len(lats) * 0.99))]
            print(f"async stream latency: p50={p50:.1f}ms p99={p99:.1f}ms "
                  f"max={lats[-1]:.1f}ms")

        # Per-segment verification (demo_app.cc:666-691).
        total = sum(o.shape[0] for o in outs.values())
        if total != len(data):
            cleanup_and_exit(3, f"VERIFY FAILED: total {total} != {len(data)}")
        for i in range(num_streams):
            if outs[i].tobytes() != segments[i]:
                cleanup_and_exit(3, f"VERIFY FAILED: segment {i} differs")
        print(f"async verify OK ({num_streams} segments bit-exact)")
        for u in units.values():
            recycled = u.engine.recycle(u)
            assert recycled == u.nblocks
    finally:
        for s in streams:
            s.close()
    return timings


# ---------------------------------------------------------------------------
# Skewed block-size benchmark (BASELINE config 4): per-block latency
# distribution under a 4 KiB..block_size log-uniform size mix.


def make_skewed_input(block_size: int, nblocks: int, min_size: int = 4096,
                      seed: int = 11) -> tuple[bytes, list[int]]:
    """Log-uniform skewed sizes + mixed-entropy payloads."""
    rng = np.random.default_rng(seed)
    lo, hi = np.log2(min(min_size, block_size)), np.log2(block_size)
    sizes = np.minimum(
        block_size,
        np.exp2(rng.uniform(lo, hi, nblocks)).astype(np.int64)).tolist()
    parts = []
    for i, n in enumerate(sizes):
        k = i % 3
        if k == 0:
            parts.append(((b"skewed %d " % i) * (n // 8 + 1))[:n])
        elif k == 1:
            parts.append(rng.integers(0, 32, n, dtype=np.uint8).tobytes())
        else:
            parts.append(bytes([i & 0xFF]) * n)
    return b"".join(parts), [int(s) for s in sizes]


def evaluate_skewed(engine: Engine, nblocks: int) -> dict:
    """Compress a skewed unit, decode burst-by-burst, and report the
    per-block latency distribution (latency := block's burst completion
    relative to first submit — the reference async suite's
    first-launch-to-callback window at block granularity,
    ``demo_app.cc:548-693``)."""
    data, sizes = make_skewed_input(engine.config.block_size, nblocks)
    unit = engine.compress(data, sizes=sizes)
    m = unit.manifest
    print(f"skewed: {nblocks} blocks, sizes {min(sizes):,}..{max(sizes):,} B, "
          f"ratio={m.ratio():.3f}")

    # Warm-up + verify (also builds the decode sidecar).
    out = engine.decompress(unit)
    if out.tobytes() != data:
        cleanup_and_exit(3, "VERIFY FAILED: skewed round-trip not bit-exact")

    t0 = time.perf_counter()
    bursts = engine.decompress_device(unit)
    lat = np.zeros(m.nblocks)
    burst = engine.config.burst_size
    done = []
    for k, arr in enumerate(bursts):
        # Per-burst completion: block_until_ready joins this burst only
        # (no host readout), so with small bursts over hundreds of blocks
        # the p50/p99 below are a real distribution, not 3 samples.
        arr.block_until_ready()
        done.append(time.perf_counter() - t0)
        lo = k * burst
        lat[lo:min(lo + burst, m.nblocks)] = done[-1]
    total = done[-1]
    order = np.sort(lat * 1e3)

    def pct(q):
        return round(float(order[int(q * (len(order) - 1))]), 2)

    # Device throughput: same launches, ONE join at the end (launches
    # pipeline on the device; the loop above joins each burst).
    dev_best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(engine.decompress_device(unit))
        dev_best = min(dev_best, time.perf_counter() - t0)

    stats = {
        "blocks": int(m.nblocks),
        "bursts": len(done),
        "burst_size": int(burst),
        "bytes": len(data),
        "total_ms": round(total * 1e3, 2),
        "GBps": round(len(data) / total / 1e9, 3),
        "device_GBps": round(len(data) / dev_best / 1e9, 3),
        "lat_p10_ms": pct(0.10), "lat_p25_ms": pct(0.25),
        "lat_p50_ms": pct(0.50), "lat_p75_ms": pct(0.75),
        "lat_p90_ms": pct(0.90), "lat_p99_ms": pct(0.99),
        "lat_max_ms": round(float(order[-1]), 2),
        # per-burst completion samples (ms) — the raw distribution
        "burst_lat_ms": [round(x * 1e3, 2) for x in done],
    }
    print("skewed latency:", {k: v for k, v in stats.items()
                              if k != "burst_lat_ms"})
    engine.recycle(unit)
    return stats


# ---------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bitar-tpu-demo",
        description="Block compression benchmark (bitar demo_app rebuild)")
    p.add_argument("--file", default=None,
                   help="input file (raw/parquet/feather); optional for "
                        "--mode skewed")
    p.add_argument("--bytes", type=int, default=None,
                   help="truncate or repeat input to this many bytes")
    p.add_argument("--mode",
                   choices=["all", "sync", "async", "skewed",
                            "compress", "decompress"],
                   default="all",
                   help="benchmark suites (skewed = per-block latency "
                        "distribution over a 4KiB..block log-uniform size "
                        "mix, BASELINE config 4), or one-shot file "
                        "compress/decompress (container format)")
    p.add_argument("--blocks", type=int, default=256,
                   help="block count for --mode skewed")
    p.add_argument("--output", default=None,
                   help="output path for compress/decompress modes")
    p.add_argument("--codec", choices=[c.value for c in Codec], default="lz4")
    p.add_argument("--block-size", type=int, default=128 * 1024)
    p.add_argument("--burst-size", type=int, default=32)
    p.add_argument("--streams", type=int, default=4)
    p.add_argument("--backend", choices=["device", "host"], default="device",
                   help="decompress path: the device sequence executor or "
                        "the native host codecs")
    p.add_argument("--platform", choices=["auto", "cpu", "gpu"], default="auto",
                   help="jax platform override (the EAL-flag tier of the "
                        "reference, README.md:80-82; 'cpu' needs no "
                        "accelerator)")
    p.add_argument("--checksum", choices=[c.value for c in Checksum],
                   default="none")
    p.add_argument("--min-match", type=int, default=6,
                   help="smallest LZ4/Snappy match emitted (4 = max ratio; "
                        "6 keeps barely-compressible blocks literal-only, "
                        "with far fewer sequences to decode)")
    p.add_argument("--pool-slots", type=int, default=None,
                   help="arena slots (default: sized to input like the "
                        "reference, app_common.cc:92-100)")
    return p


def run_compress_file(engine: Engine, data: bytes, out_path: str) -> None:
    """One-shot: file -> .btpu container (manifest + packed blocks)."""
    unit = engine.compress(data)
    blob = unit.to_host().to_bytes()
    with open(out_path, "wb") as f:
        f.write(blob)
    print(f"compressed {len(data):,} -> {len(blob):,} bytes "
          f"(ratio {unit.manifest.ratio():.3f}, {unit.nblocks} blocks) "
          f"-> {out_path}")
    engine.recycle(unit)


def run_decompress_file(engine: Engine, raw: bytes, out_path: str) -> None:
    """One-shot: .btpu container -> original bytes (checksum-verified)."""
    from ..manifest import CompressedBuffers

    cb = CompressedBuffers.from_bytes(raw)
    unit = engine.import_unit(cb)
    out = engine.decompress(unit)
    with open(out_path, "wb") as f:
        f.write(out.tobytes())
    print(f"decompressed {len(raw):,} -> {out.shape[0]:,} bytes -> {out_path}")
    engine.recycle(unit)


def main(argv: list[str] | None = None) -> int:
    install_signal_handlers()
    args = build_parser().parse_args(argv)
    if args.platform != "auto":
        # Must happen before any jax backend initializes.
        jax.config.update("jax_platforms", args.platform)
    configure_compile_cache()
    if args.file is None and args.mode != "skewed":
        cleanup_and_exit(2, "--file is required for this mode")
    if args.mode == "skewed":
        data = b""
        nblocks = args.blocks
    elif args.mode == "decompress":
        with open(args.file, "rb") as f:
            data = f.read()
        # The container records its own block size; the engine must match.
        # Pool sizing must come from the manifest's block count (raw-size
        # derived) — the container byte length underestimates it for any
        # well-compressed input and import_unit would hit CapacityError.
        from ..manifest import CompressedBuffers
        m = CompressedBuffers.from_bytes(data).manifest
        args.block_size = m.block_size
        nblocks = m.nblocks
    else:
        data = read_data(args.file, args.bytes)
        nblocks = -(-len(data) // args.block_size)
    print(f"input: {len(data):,} bytes, codec={args.codec}, "
          f"block={args.block_size}, mode={args.mode}")

    pool = args.pool_slots or max(64, nblocks + args.burst_size)
    cfg = EngineConfig(
        codec=Codec(args.codec), block_size=args.block_size,
        burst_size=args.burst_size, checksum=Checksum(args.checksum),
        max_pool_slots=pool, use_device_kernels=(args.backend == "device"),
        min_match=args.min_match)

    driver = Driver.instance()
    print("topology:", driver.describe())
    engines = driver.get_engines(cfg)
    try:
        if args.mode == "compress":
            run_compress_file(engines[0], data,
                              args.output or args.file + ".btpu")
        elif args.mode == "decompress":
            out_path = args.output or (
                args.file[:-5] if args.file.endswith(".btpu")
                else args.file + ".out")
            run_decompress_file(engines[0], data, out_path)
        elif args.mode == "skewed":
            stats = evaluate_skewed(engines[0], args.blocks)
            if args.output:
                import json
                with open(args.output, "w") as f:
                    json.dump(stats, f, indent=1)
        else:
            if args.mode in ("all", "sync"):
                evaluate_sync(engines[0], data)
            if args.mode in ("all", "async"):
                evaluate_async(engines, data, args.streams)
    except StatusError as e:
        cleanup_and_exit(1, f"FAILED: {e.status}")
    finally:
        for e in engines:
            e.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
