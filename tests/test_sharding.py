"""Multi-device tests on the 8-way virtual CPU mesh: sharded decode,
hash-partitioned shuffle with skew balancing, and the combined
shuffle-then-decode pipeline step (BASELINE.json config 5 in miniature).
"""

import numpy as np
import pytest

import bitar_tpu as bt
from bitar_tpu.ops.cpu import native
from bitar_tpu.parallel import shuffle as shf
from bitar_tpu.parallel import sharding as shd


def make_blocks(rng, nblocks, block):
    datas = []
    for i in range(nblocks):
        k = i % 3
        if k == 0:
            datas.append((b"mesh decode %d " % i) * (block // 13 + 1))
        elif k == 1:
            datas.append(rng.integers(0, 6, block, dtype=np.uint8).tobytes())
        else:
            datas.append(bytes([i & 0xFF]) * block)
    return [d[:block] for d in datas]


def test_make_mesh():
    mesh = shd.make_mesh()
    assert mesh.devices.shape == (8,)
    mesh4 = shd.make_mesh(4)
    assert mesh4.devices.shape == (4,)
    with pytest.raises(bt.StatusError):
        shd.make_mesh(99)


def test_sharded_decode_bit_exact(rng):
    block = 256
    mesh = shd.make_mesh()
    datas = make_blocks(rng, 16, block)
    comps = [np.asarray(native.lz4_compress(d)) for d in datas]
    tables = [native.parse_sequences(c, "lz4") for c in comps]
    slot = 512
    full, real_n = shd.prepare_sharded_batch(comps[:13], tables[:13], slot, 8)
    assert real_n == 13 and full["src"].shape == (16, slot)
    out = shd.sharded_decode(
        full["src"], full["nseq"], full["lit_ptr"], full["lit_len"],
        full["off"], full["mlen"], full["out_pos"],
        mesh=mesh, block_size=block)
    host = np.asarray(out)
    assert not host[13:].any()              # idle padding blocks
    datas = datas[:13]
    for i, d in enumerate(datas):
        assert host[i].tobytes() == d, f"block {i}"


def test_hash_partition_deterministic_and_spread():
    ids = np.arange(1024)
    d1 = shf.hash_partition(ids, 8)
    d2 = shf.hash_partition(ids, 8)
    np.testing.assert_array_equal(d1, d2)
    counts = np.bincount(d1, minlength=8)
    assert counts.min() > 60  # roughly uniform

def test_plan_shuffle_balances_counts():
    n, d = 64, 8
    sizes = np.ones(n, dtype=np.int64)
    plan = shf.plan_shuffle(n, d, sizes=sizes, balance=True)
    counts = np.bincount(plan.dest, minlength=d)
    assert counts.max() == counts.min() == n // d  # perfectly smoothed
    # every block appears exactly once in send_order
    sent = plan.send_order[plan.send_order >= 0]
    assert sorted(sent.tolist()) == list(range(n))


def test_plan_shuffle_byte_skew_bounded(rng):
    n, d = 64, 8
    sizes = rng.integers(1, 1000, n).astype(np.int64)
    plan = shf.plan_shuffle(n, d, sizes=sizes, balance=True)
    loads = np.zeros(d, dtype=np.int64)
    for i, dest in enumerate(plan.dest):
        loads[dest] += sizes[i]
    assert loads.max() < 2.5 * loads.mean()  # LPT keeps byte skew bounded


def test_plan_shuffle_rejects_ragged():
    with pytest.raises(bt.StatusError):
        shf.plan_shuffle(63, 8)


def test_execute_shuffle_delivers_blocks(rng):
    n, d, slot = 32, 8, 256
    mesh = shd.make_mesh()
    rows = rng.integers(0, 256, (n, slot), dtype=np.uint8)
    plan = shf.plan_shuffle(n, d, sizes=np.full(n, 100, np.int64))
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    rows_dev = jax.device_put(rows, NamedSharding(mesh, P(shd.BLOCKS_AXIS)))
    out = np.asarray(shf.execute_shuffle(mesh, plan, rows_dev))
    # verify each destination received exactly its plan.recv_block rows
    out = out.reshape(d, d, plan.rows_per_pair, slot)
    for dst in range(d):
        for src in range(d):
            for j in range(plan.rows_per_pair):
                b = plan.recv_block[dst, src, j]
                if b >= 0:
                    np.testing.assert_array_equal(
                        out[dst, src, j], rows[b],
                        err_msg=f"dst={dst} src={src} j={j} block={b}")


def test_shuffle_then_decode_pipeline(rng):
    # The full distributed step: compressed slot rows are hash-shuffled
    # across the mesh, then each destination decodes what it received.
    block, slot, d = 256, 512, 8
    n = 16
    mesh = shd.make_mesh()
    datas = make_blocks(rng, n, block)
    comps = [np.asarray(native.lz4_compress(x)) for x in datas]
    sizes = np.array([c.shape[0] for c in comps], np.int64)
    plan = shf.plan_shuffle(n, d, sizes=sizes)

    rows = np.zeros((n, slot), dtype=np.uint8)
    for i, c in enumerate(comps):
        rows[i, :c.shape[0]] = c
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    rows_dev = jax.device_put(rows, NamedSharding(mesh, P(shd.BLOCKS_AXIS)))
    shuffled = np.asarray(shf.execute_shuffle(mesh, plan, rows_dev))

    # After the exchange, decode every delivered block (host-side check
    # that the shuffled bytes decode bit-exactly).
    out_map = {}
    flat_recv = plan.recv_block.reshape(d, -1)
    for dst in range(d):
        base = dst * d * plan.rows_per_pair
        for j, b in enumerate(flat_recv[dst]):
            if b >= 0:
                got = native.lz4_decompress(
                    shuffled[base + j][:sizes[b]], block + 1)
                out_map[int(b)] = got.tobytes()
    for i, dat in enumerate(datas):
        assert out_map[i] == dat, f"block {i}"


def test_sharding_config_wires_mesh_and_shuffle():
    from bitar_tpu.config import ShardingConfig
    from bitar_tpu.parallel import make_mesh, plan_shuffle
    import numpy as np

    cfg = ShardingConfig(data_axis="blocks", mesh_shape=(4,), skew_bucket_log=2)
    mesh = make_mesh(config=cfg)
    assert mesh.devices.size == 4
    assert mesh.axis_names == ("blocks",)
    sizes = np.array([100, 5000, 120, 4800, 90, 5100, 110, 4900], np.int64)
    p1 = plan_shuffle(8, 4, sizes=sizes, config=cfg)
    # jittered sizes in the same log-buckets produce the identical plan
    p2 = plan_shuffle(8, 4, sizes=sizes + 7, config=cfg)
    assert (p1.send_order == p2.send_order).all()
    assert (p1.dest == p2.dest).all()
