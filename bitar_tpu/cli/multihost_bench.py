"""Multi-process harness for the fused shuffle+decode step, on CPU devices.

The reference's topology ceiling is one process with lcores sharing an
address space (``driver.cc:100-158``); the multi-host story here is one
process per host joined by ``jax.distributed``, a global mesh spanning
every process's devices, and the block shuffle riding the mesh
collectives.  This harness runs that shape on one machine: N processes on
localhost, each owning ``--devices-per-process`` virtual CPU devices,
driving ``distributed_step`` over the global mesh.  It checks the
cross-process path end to end; its times are CPU times, reported under
``cpu_*`` names, and say nothing about a GPU.

Efficiency is WEAK-scaling: the 1-process baseline runs ``blocks / N``
blocks on its ``1/N``-size mesh, so both arms execute identical
per-device shapes and the ratio isolates the cross-process collective +
coordination cost.

Launch (spawns workers, waits, writes the artifact)::

    python -m bitar_tpu.cli.multihost_bench --launch 2 --out MULTIHOST.json

Worker mode (used internally)::

    python -m bitar_tpu.cli.multihost_bench --processes 2 --process-id 0 \
        --coordinator localhost:9911
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

BLOCK = 16 * 1024
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_batch(nblocks: int):
    """Deterministic corpus: (raw blocks, slot rows, tables, nseq)."""
    import numpy as np

    from bitar_tpu.ops.cpu import native
    from bitar_tpu.ops.decode import TABLE_KEYS, pad_tables

    rng = np.random.default_rng(7)
    datas, comps, tables = [], [], []
    for i in range(nblocks):
        k = i % 4
        if k == 0:
            x = ((b"multihost block %d " % i) * (BLOCK // 17 + 1))[:BLOCK]
        elif k == 1:
            x = rng.integers(0, 8, BLOCK, dtype=np.uint8).tobytes()
        elif k == 2:
            x = bytes([i & 0xFF]) * BLOCK
        else:
            x = rng.integers(0, 256, BLOCK, np.uint8).tobytes()
        datas.append(x)
        c = np.asarray(native.lz4_compress(x, min_match=6))
        if len(c) >= BLOCK:               # engine RAW fallback semantics
            c = np.frombuffer(x, np.uint8)
            t = {k: np.zeros(1, np.int32) for k in TABLE_KEYS}
            t["lit_len"][0] = BLOCK
        else:
            t = native.parse_sequences(c, "lz4")
        comps.append(c)
        tables.append(t)
    rows = np.zeros((nblocks, BLOCK + BLOCK // 8), np.uint8)
    for i, c in enumerate(comps):
        rows[i, :len(c)] = c
    t, nseq = pad_tables(tables)
    sizes = np.array([len(c) for c in comps], np.int64)
    return datas, rows, t, nseq, sizes


def worker(args) -> int:
    # Platform setup must precede any jax backend use.
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", args.devices_per_process)
    if args.processes > 1:
        jax.distributed.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.processes,
            process_id=args.process_id)

    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from bitar_tpu.parallel import (
        BLOCKS_AXIS,
        distributed_step,
        make_mesh,
        plan_shuffle,
        prepare_distributed_step,
    )

    d = jax.device_count()
    assert d == args.processes * args.devices_per_process, (
        d, args.processes, args.devices_per_process)
    mesh = make_mesh(d)
    pc, pi = args.processes, args.process_id

    nblocks = args.blocks
    datas, rows, tables, nseq, sizes = build_batch(nblocks)
    shard_cfg = None
    if args.skew_bucket_log > 0:
        from bitar_tpu.config import ShardingConfig
        shard_cfg = ShardingConfig(data_axis=BLOCKS_AXIS, mesh_shape=(d,),
                                   skew_bucket_log=args.skew_bucket_log)
    splan = plan_shuffle(nblocks, d, sizes=sizes, config=shard_cfg)
    sharding = NamedSharding(mesh, P(BLOCKS_AXIS))

    def put(a):
        """Globally-sharded array from this process's local rows."""
        a = np.ascontiguousarray(a)
        if pc == 1:
            return jax.device_put(a, sharding)
        per = a.shape[0] // pc
        return jax.make_array_from_process_local_data(
            sharding, a[pi * per:(pi + 1) * per])

    dev_args, kwargs = prepare_distributed_step(
        mesh, splan, rows, tables, nseq, BLOCK, put=put)
    out = jax.block_until_ready(distributed_step(*dev_args, **kwargs))

    # Verify this process's local shards bit-exactly.
    flat = splan.recv_block.reshape(-1)
    checked = 0
    for shard in out.addressable_shards:
        lo = shard.index[0].start or 0
        host = np.asarray(shard.data)
        for j in range(host.shape[0]):
            b = flat[lo + j]
            if b >= 0:
                assert host[j].tobytes() == datas[b], f"block {b}"
                checked += 1
    print(f"proc {pi}: verified {checked} received blocks bit-exact",
          file=sys.stderr)

    best = float("inf")
    for _ in range(args.reps):
        t0 = time.perf_counter()
        jax.block_until_ready(distributed_step(*dev_args, **kwargs))
        best = min(best, time.perf_counter() - t0)

    print(json.dumps(dict(
        platform="cpu", processes=pc, devices=d, blocks=nblocks,
        cpu_step_ms=best * 1e3, cpu_blocks_per_s=nblocks / best,
        verified_blocks=checked)))
    return 0


def launch(args) -> int:
    """Spawn the workers, then run the 1-process baseline and compute
    weak-scaling efficiency; writes the artifact."""
    ncores = os.cpu_count() or 1
    per_proc_cores = max(1, ncores // args.launch)

    def pin(pid):
        """taskset prefix giving each process a disjoint core set, so the
        measurement is not fighting core oversubscription (each XLA CPU
        runtime otherwise spawns threads for EVERY core)."""
        if not args.pin_cores:
            return []
        lo = pid * per_proc_cores
        return ["taskset", "-c", f"{lo}-{lo + per_proc_cores - 1}"]

    def cmd(pid, processes, blocks, port):
        return pin(pid) + [
            sys.executable, "-m", "bitar_tpu.cli.multihost_bench",
            "--processes", str(processes), "--process-id", str(pid),
            "--coordinator", f"localhost:{port}",
            "--devices-per-process", str(args.devices_per_process),
            "--blocks", str(blocks), "--reps", str(args.reps),
            "--skew-bucket-log", str(args.skew_bucket_log)]

    def run(cmds):
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, cwd=REPO)
                 for c in cmds]
        outs = []
        for pid, p in enumerate(procs):
            so, se = p.communicate(timeout=args.timeout)
            if p.returncode != 0:
                print(se.decode()[-2000:], file=sys.stderr)
                raise SystemExit(f"worker {pid} failed rc={p.returncode}")
            outs.append(json.loads(so.decode().strip().splitlines()[-1]))
        return outs[0]

    # Baseline: same per-process device count and core budget, blocks/N,
    # so every device in BOTH arms runs the identical per-device shape.
    base_blocks = max(args.devices_per_process, args.blocks // args.launch)
    multi = base = None
    for r in range(max(1, args.rounds)):
        m = run([cmd(pid, args.launch, args.blocks, args.port + r)
                 for pid in range(args.launch)])
        b = run([cmd(0, 1, base_blocks, args.port + r)])
        if multi is None or m["cpu_step_ms"] < multi["cpu_step_ms"]:
            multi = m
        if base is None or b["cpu_step_ms"] < base["cpu_step_ms"]:
            base = b

    artifact = dict(
        config="BASELINE config 5: multi-process fused shuffle+decode",
        platform="cpu", multi=multi, single=base,
        cpu_scaling_efficiency=(multi["cpu_blocks_per_s"]
                                / base["cpu_blocks_per_s"]) / args.launch,
        note=("virtual CPU devices: exercises jax.distributed + the global "
              "mesh + cross-process collectives; not a GPU measurement"))
    blob = json.dumps(artifact, indent=1)
    print(blob)
    if args.out:
        with open(args.out, "w") as f:
            f.write(blob + "\n")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bitar-tpu-multihost-bench")
    p.add_argument("--launch", type=int, default=0,
                   help="spawn N worker processes and report scaling")
    p.add_argument("--processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--coordinator", default="localhost:9911")
    p.add_argument("--port", type=int, default=9911)
    p.add_argument("--devices-per-process", type=int, default=4)
    p.add_argument("--blocks", type=int, default=32)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--rounds", type=int, default=1,
                   help="repeat the (multi, single) pair N times; the "
                        "artifact keeps each arm's fastest run")
    p.add_argument("--timeout", type=int, default=600)
    p.add_argument("--pin-cores", action="store_true",
                   help="give each worker (and the baseline) a disjoint, "
                        "equal core set via taskset")
    p.add_argument("--skew-bucket-log", type=int, default=0,
                   help="coarsen LPT shuffle ordering: bucket block sizes "
                        "by log2(size) >> K before the balance sort "
                        "(ShardingConfig.skew_bucket_log); 0 = exact sizes")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if args.launch:
        return launch(args)
    return worker(args)


if __name__ == "__main__":
    sys.exit(main())
