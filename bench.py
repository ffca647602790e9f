"""GPU benchmark: one JSON line with the headline metric.

Measures block decompress and compress on one GPU: 1024 x 128 KiB blocks
of the mixed corpus (text / low-entropy / random / RLE in equal parts) in
LZ4, Snappy and Zstd, plus the markdown corpus in LZ4, with a full engine
round trip checked byte for byte before any timing (the reference demo
app's memcmp oracle, ``demo_app.cc:534-543``).

Decompress is the device-resident decode (``Engine.prepare_device_decode``:
inputs staged on the device once, output left there — the reference's
contract, whose ``Decompress`` aliases device memzones).  Each timed
window chains REPS launches and ends in ``block_until_ready``; the best of
three windows is reported.  Compress is the host engine (native C++
matcher), with the arena upload deferred to first decode (the reference
contract); an eager-commit compress is reported alongside.

Needs a GPU: without one it exits with status 2 and prints no result.
The LAST stdout line is the JSON record; ``value`` is LZ4 decompress GB/s
(decoded bytes per second).  The record names the device it ran on.
"""

from __future__ import annotations

import json
import os
import sys
import time

BLOCK = 128 * 1024
NBLOCKS = int(os.environ.get("BENCH_NBLOCKS", "1024"))
REPS = int(os.environ.get("BENCH_REPS", "8"))
NORTH_STAR_GBPS = 10.0      # BASELINE.json decompress target


def best_of(fn, runs: int = 3) -> float:
    best = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def decode_seconds(eng, unit) -> float:
    """Warm seconds per whole-unit device decode."""
    launch = eng.prepare_device_decode(unit)
    launch().block_until_ready()                 # compile + warm

    def window():
        out = None
        for _ in range(REPS):
            out = launch()
        out.block_until_ready()

    return best_of(window) / REPS


def codec_phase(bt, cfg, data: bytes, label: str) -> tuple[float, float]:
    """(compress GB/s of one run, warm decompress GB/s) for one unit."""
    eng = bt.Engine(cfg).initialize()
    t0 = time.perf_counter()
    unit = eng.compress(data)
    comp = len(data) / (time.perf_counter() - t0) / 1e9
    assert eng.decompress(unit).tobytes() == data, \
        f"{label} round trip not bit-exact"
    assert eng.stats.host_decode_bursts == 0
    dec = len(data) / decode_seconds(eng, unit) / 1e9
    print(f"bench: {label} compress {comp:.3f} GB/s, decompress "
          f"{dec:.3f} GB/s (ratio {unit.manifest.ratio():.3f})",
          file=sys.stderr)
    eng.recycle(unit)
    eng.release()
    return comp, dec


def main() -> int:
    from bitar_tpu.utils.device_info import device_record, require_gpu

    require_gpu("bench")
    import bitar_tpu as bt
    from bitar_tpu.utils.compile_cache import configure_compile_cache
    from bitar_tpu.utils.corpus import markdown_corpus, mixed_corpus
    from bitar_tpu.utils.profiling import annotate, device_trace

    configure_compile_cache()
    device = device_record()
    print(f"bench: device {device}", file=sys.stderr)
    data = mixed_corpus(NBLOCKS, BLOCK)
    cfg = bt.EngineConfig(
        codec=bt.Codec.LZ4, block_size=BLOCK, burst_size=NBLOCKS,
        max_pool_slots=NBLOCKS + 32, commit="deferred")

    # --- LZ4 compress, best of 3 like the reference's kNumTests.
    eng = bt.Engine(cfg).initialize()
    units = []

    def compress_once():
        if units:
            eng.recycle(units.pop())
        with annotate("bench.compress"):
            units.append(eng.compress(data))

    comp_s = best_of(compress_once)
    unit = units[0]
    t0 = time.perf_counter()
    eng.ensure_tables(unit)                      # commit upload + parse
    tables_ms = (time.perf_counter() - t0) * 1e3
    assert eng.decompress(unit).tobytes() == data, "round trip not bit-exact"
    assert eng.stats.host_decode_bursts == 0
    print(f"bench: ratio={unit.manifest.ratio():.3f} compress "
          f"{comp_s * 1e3:.1f} ms, commit+tables {tables_ms:.1f} ms",
          file=sys.stderr)
    with device_trace():                         # BITAR_TPU_TRACE_DIR
        dec_s = decode_seconds(eng, unit)
    eng.recycle(unit)
    eng.release()

    eeng = bt.Engine(cfg.replace(commit="eager")).initialize()
    eager = []

    def eager_once():
        if eager:
            eeng.recycle(eager.pop())
        eager.append(eeng.compress(data))

    eager_s = best_of(eager_once, runs=2)
    eeng.recycle(eager.pop())
    eeng.release()

    snappy_comp, snappy_dec = codec_phase(
        bt, cfg.replace(codec=bt.Codec.SNAPPY), data, "snappy")
    zstd_comp, zstd_dec = codec_phase(
        bt, cfg.replace(codec=bt.Codec.ZSTD, level=3), data, "zstd")
    _, text_dec = codec_phase(bt, cfg, markdown_corpus(NBLOCKS, BLOCK),
                              "markdown lz4")

    dec_gbps = len(data) / dec_s / 1e9
    print(json.dumps({
        "metric": "lz4_decompress_GBps_128KiB_blocks",
        "value": dec_gbps,
        "unit": "GB/s",
        "vs_baseline": dec_gbps / NORTH_STAR_GBPS,
        "compress_GBps": len(data) / comp_s / 1e9,
        "compress_eager_GBps": len(data) / eager_s / 1e9,
        "combined_GBps": len(data) / (dec_s + comp_s) / 1e9,
        "commit_and_tables_ms": tables_ms,
        "snappy_decompress_GBps": snappy_dec,
        "snappy_compress_GBps": snappy_comp,
        "zstd_decompress_GBps": zstd_dec,
        "zstd_compress_GBps": zstd_comp,
        "text_decompress_GBps": text_dec,
        "device": device,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
