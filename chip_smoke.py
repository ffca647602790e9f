"""GPU smoke run: the quickest proof that the engine runs on a GPU.

Drives the main path through ``Engine`` at the benchmark's full width and
checks every byte:

1. the card (``nvidia-smi``, read by a child process that stays off JAX)
   and the device as JAX reports it;
2. the native host library build (set-up time);
3. five units, each compressed, decompressed on the device, and compared
   byte for byte with the input and with the native host decoder (the
   independent reference): the mixed corpus as 1024 x 128 KiB blocks in
   LZ4, Snappy and Zstd level 3, the markdown corpus in LZ4, and 128 x
   1 MiB LZ4 blocks.  Every unit must decode on the device only
   (``device_decode_bursts > 0``, ``host_decode_bursts == 0``);
4. compile time and ``memory_analysis`` of the decode step, warm decode
   times ending in ``block_until_ready``, a large device-to-device copy
   timed in the same process (the executor's share of what the memory
   system delivers), and ``peak_bytes_in_use``.

``--chips 4`` runs only the multi-device path instead: a Zipf-skewed
unit hash-partitioned over four GPUs by the all_to_all shuffle, decoded
where it lands, and compared with the host decoder.

Usage::

    python chip_smoke.py             # one GPU
    python chip_smoke.py --chips 4   # four GPUs of one host

Without a GPU it exits with status 2 and prints no result.  The last line
of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

BLOCK = 128 * 1024
NBLOCKS = 1024
BIG_BLOCK = 1 << 20
BIG_NBLOCKS = 128


def log(msg: str) -> None:
    print(msg, flush=True)


def host_reference(unit) -> np.ndarray:
    """The unit decoded by the native host codecs (independent of the
    device executor and of its sequence tables)."""
    from bitar_tpu.ops import registry

    m = unit.manifest
    cb = unit.to_host()
    out = np.zeros(m.total_raw, np.uint8)
    dst_len, status = registry.host_decompress_batch(
        unit.engine.config.codec, cb.packed, m.comp_off, m.comp_len, out,
        m.raw_off, m.raw_len.astype(np.int32), codec_ids=m.codec_ids)
    assert (status == 0).all() and (dst_len == m.raw_len).all(), \
        "native reference decode failed"
    return out


def check_unit(bt, name: str, codec, data: bytes, block: int) -> dict:
    """Compress, decode on the device, compare; time the warm decode."""
    nblocks = -(-len(data) // block)
    cfg = bt.EngineConfig(codec=codec, block_size=block, burst_size=nblocks,
                          max_pool_slots=nblocks + 32, level=3)
    eng = bt.Engine(cfg).initialize()
    t0 = time.perf_counter()
    unit = eng.compress(data)
    compress_s = time.perf_counter() - t0
    reference = host_reference(unit)      # before tables drop the staging
    t0 = time.perf_counter()
    out = eng.decompress(unit)
    first_s = time.perf_counter() - t0
    raw = np.frombuffer(data, np.uint8)
    assert np.array_equal(out, raw), f"{name}: device output != input"
    assert np.array_equal(out, reference), f"{name}: device != native"
    st = eng.stats
    assert st.device_decode_bursts > 0, f"{name}: no device decode"
    assert st.host_decode_bursts == 0, f"{name}: host decode used"

    launch = eng.prepare_device_decode(unit)
    dev = launch().block_until_ready()
    assert np.array_equal(np.asarray(dev)[:, :block].reshape(-1)[:len(data)],
                          raw), f"{name}: resident decode != input"
    warm = []
    for _ in range(5):
        t0 = time.perf_counter()
        launch().block_until_ready()
        warm.append(time.perf_counter() - t0)
    res = dict(name=name, bytes=len(data), blocks=nblocks,
               ratio=unit.manifest.ratio(), compress_s=compress_s,
               first_decompress_s=first_s, warm_decode_s=min(warm),
               warm_decode_GBps=len(data) / min(warm) / 1e9,
               comp_bytes=int(unit.manifest.total_comp),
               seq_cap=int(unit.tables["lit_ptr"].shape[1]),
               device_decode_bursts=st.device_decode_bursts,
               host_decode_bursts=st.host_decode_bursts)
    log(f"unit {name}: byte-exact vs input and native decoder; "
        f"device_decode_bursts={st.device_decode_bursts} "
        f"host_decode_bursts={st.host_decode_bursts}; ratio "
        f"{res['ratio']:.3f}; warm decode {res['warm_decode_s'] * 1e3:.3f} ms "
        f"= {res['warm_decode_GBps']:.3f} GB/s")
    eng.recycle(unit)
    eng.release()
    return res


def compile_report(block: int, nblocks: int, slot: int, cap: int) -> dict:
    """AOT-compile the decode step at a unit's shapes: compile seconds and
    XLA's memory analysis."""
    import jax
    from bitar_tpu.ops.decode import decode_blocks

    i32 = lambda *s: jax.ShapeDtypeStruct(s, np.int32)  # noqa: E731
    args = (jax.ShapeDtypeStruct((nblocks, slot), np.uint8), i32(nblocks),
            *(i32(nblocks, cap) for _ in range(5)))
    # A true compile: the persistent cache may already hold this shape.
    jax.config.update("jax_enable_compilation_cache", False)
    t0 = time.perf_counter()
    compiled = decode_blocks.lower(*args, block_size=block).compile()
    compile_s = time.perf_counter() - t0
    jax.config.update("jax_enable_compilation_cache", True)
    ma = compiled.memory_analysis()
    mem = {k: int(getattr(ma, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")
        if ma is not None and hasattr(ma, k)}
    return dict(compile_s=compile_s, memory_analysis=mem)


def copy_rate() -> float:
    """Bytes moved per second (read + write) by a 4 GiB device copy."""
    import jax
    import jax.numpy as jnp

    x = jnp.zeros((1 << 30,), jnp.uint32)
    step = jax.jit(lambda v: v ^ jnp.uint32(1))
    step(x).block_until_ready()
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        step(x).block_until_ready()
        best = min(best, time.perf_counter() - t0)
    return 2 * x.nbytes / best


def single_device(bt) -> None:
    from bitar_tpu.utils.corpus import markdown_corpus, mixed_corpus

    mixed = mixed_corpus(NBLOCKS, BLOCK)
    units = [
        check_unit(bt, "mixed-lz4", bt.Codec.LZ4, mixed, BLOCK),
        check_unit(bt, "mixed-snappy", bt.Codec.SNAPPY, mixed, BLOCK),
        check_unit(bt, "mixed-zstd3", bt.Codec.ZSTD, mixed, BLOCK),
        check_unit(bt, "markdown-lz4", bt.Codec.LZ4,
                   markdown_corpus(NBLOCKS, BLOCK), BLOCK),
        check_unit(bt, "mixed-lz4-1MiB", bt.Codec.LZ4,
                   mixed_corpus(BIG_NBLOCKS, BIG_BLOCK), BIG_BLOCK),
    ]
    lz4 = units[0]
    slot = bt.EngineConfig(block_size=BLOCK).slot_size
    comp = compile_report(BLOCK, NBLOCKS, slot, lz4["seq_cap"])
    log(f"decode step compile {comp['compile_s']:.3f} s at "
        f"[{NBLOCKS} x {BLOCK}], seq_cap {lz4['seq_cap']}; memory_analysis "
        f"{comp['memory_analysis']}")
    import jax
    peak = jax.devices()[0].memory_stats().get("peak_bytes_in_use")
    log(f"peak_bytes_in_use {peak} (all units, before the copy test)")
    rate = copy_rate()
    log(f"device copy: {rate / 1e9:.1f} GB/s moved (read + write, 4 GiB)")
    for u in units:
        moved = u["bytes"] + u["comp_bytes"]
        log(f"  {u['name']}: executor moves >= {moved / u['warm_decode_s'] / 1e9:.1f}"
            f" GB/s of input + output = {moved / u['warm_decode_s'] / rate:.4f}"
            f" of the copy rate")
    log("results " + json.dumps(dict(units=units, compile=comp,
                                     copy_Bps=rate, peak_bytes_in_use=peak)))


def zipf_unit(nblocks: int, block: int, seed: int = 5):
    """Blocks of Zipf-distributed sizes (BASELINE config 4/5 skew): raw
    blocks, LZ4 slot rows (RAW where LZ4 does not shrink), tables, sizes."""
    from bitar_tpu.ops.cpu import native
    from bitar_tpu.ops.decode import TABLE_KEYS, pad_tables

    rng = np.random.default_rng(seed)
    sizes = np.minimum(block, 4096 * rng.zipf(1.3, nblocks))
    datas, tables = [], []
    rows = np.zeros((nblocks, block), np.uint8)
    comp_len = np.zeros(nblocks, np.int64)
    for i, n in enumerate(sizes):
        kind = i % 3
        if kind == 0:
            x = ((b"zipf block %d " % i) * (n // 12 + 1))[:n]
        elif kind == 1:
            x = rng.integers(0, 16, n, dtype=np.uint8).tobytes()
        else:
            x = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        c = np.asarray(native.lz4_compress(x, min_match=6))
        if len(c) >= n:
            c = np.frombuffer(x, np.uint8)
            t = {k: np.zeros(1, np.int32) for k in TABLE_KEYS}
            t["lit_len"][0] = n
        else:
            t = native.parse_sequences(c, "lz4")
        rows[i, :len(c)] = c
        comp_len[i] = len(c)
        datas.append(x)
        tables.append(t)
    t, nseq = pad_tables(tables)
    return datas, rows, t, nseq, comp_len


def multi_device(n_devices: int, nblocks: int, block: int) -> dict:
    """Shuffle + decode over an n-device mesh, checked against the host
    decoder; returns timings."""
    import jax
    from bitar_tpu.ops.cpu import native
    from bitar_tpu.parallel import (
        distributed_step,
        make_mesh,
        plan_shuffle,
        prepare_distributed_step,
    )

    mesh = make_mesh(n_devices)
    datas, rows, tables, nseq, comp_len = zipf_unit(nblocks, block)
    splan = plan_shuffle(nblocks, n_devices, sizes=comp_len)
    args, kwargs = prepare_distributed_step(mesh, splan, rows, tables, nseq,
                                            block)
    t0 = time.perf_counter()
    out = distributed_step(*args, **kwargs).block_until_ready()
    first_s = time.perf_counter() - t0
    host = np.asarray(out)
    checked = 0
    for pos, b in enumerate(splan.recv_block.reshape(-1)):
        if b < 0:
            continue
        n = len(datas[b])
        if comp_len[b] < n:
            ref = native.lz4_decompress(rows[b, :comp_len[b]], n).tobytes()
        else:
            ref = datas[b]
        assert ref == datas[b], f"host decoder disagrees on block {b}"
        assert host[pos, :n].tobytes() == ref, f"block {b} at {pos}"
        checked += 1
    assert checked == nblocks, (checked, nblocks)
    warm = []
    for _ in range(5):
        t0 = time.perf_counter()
        distributed_step(*args, **kwargs).block_until_ready()
        warm.append(time.perf_counter() - t0)
    raw_bytes = int(sum(len(d) for d in datas))
    return dict(devices=n_devices, blocks=nblocks, raw_bytes=raw_bytes,
                rows_per_pair=splan.rows_per_pair, first_step_s=first_s,
                warm_step_s=min(warm),
                warm_GBps=raw_bytes / min(warm) / 1e9, checked=checked,
                devices_seen=[str(d) for d in jax.devices()[:n_devices]])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=[1, 4],
                    help="4: run only the four-GPU shuffle + decode path")
    args = ap.parse_args(argv)

    import jax

    import bitar_tpu as bt
    from bitar_tpu.ops.cpu import native
    from bitar_tpu.utils.compile_cache import configure_compile_cache
    from bitar_tpu.utils.device_info import nvidia_smi_lines, require_gpu

    require_gpu("chip_smoke")
    devices = jax.devices()
    if len(devices) < args.chips:
        print(f"chip_smoke: --chips {args.chips} but JAX sees "
              f"{len(devices)} device(s)", file=sys.stderr)
        return 2
    for line in nvidia_smi_lines():
        log(f"card: {line}")
    log(f"jax: platform={devices[0].platform} "
        f"device_kind={devices[0].device_kind} count={len(devices)}")

    t0 = time.perf_counter()

    cache = configure_compile_cache()
    native.load()
    log(f"setup: native library {native.library_path().name} ready in "
        f"{time.perf_counter() - t0:.2f} s; compile cache {cache}")

    if args.chips == 4:
        res = multi_device(4, nblocks=4096, block=BLOCK)
        log(f"4-device shuffle + decode: {res['checked']} Zipf-sized blocks "
            f"byte-exact vs the host decoder; warm step "
            f"{res['warm_step_s'] * 1e3:.3f} ms = {res['warm_GBps']:.3f} GB/s "
            f"(first step {res['first_step_s']:.3f} s)")
        log("results " + json.dumps(res))
        count = 4
    else:
        single_device(bt)
        count = len(devices)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
