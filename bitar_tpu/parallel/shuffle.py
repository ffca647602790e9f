"""Distributed compressed-block shuffle with skew handling.

The multi-device replacement for the reference's enqueue/dequeue-burst
pipeline: compressed blocks are hash-partitioned across devices and
exchanged with ``all_to_all`` inside ``shard_map`` (NCCL over NVLink
between the GPUs of a host), so downstream decompress
runs where the data is wanted (BASELINE.json config 5).

Skew handling: real block streams have skewed *compressed* sizes (4 KiB -
1 MiB configs).  Slots are fixed-size, so wire cost per block is uniform,
but naive hash partitioning still skews block *counts* per destination.
``plan_shuffle`` balances counts: blocks are bucketed by destination, and
the per-destination surplus beyond the uniform quota is re-assigned
round-robin to under-full destinations (deterministically, recorded in the
plan so the receiver can restore manifest order).

The exchange itself moves equal-sized slot rows — ``counts_max`` rows per
(src, dst) pair, padded — which is exactly the shape ``all_to_all`` wants;
the plan's permutation carries the raggedness, not the collective.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..status import Status, StatusError
from .sharding import BLOCKS_AXIS


def hash_partition(block_ids: np.ndarray, num_devices: int) -> np.ndarray:
    """Destination shard per block id (splitmix-style integer hash — the
    'hash-partitioned blocks' contract)."""
    x = block_ids.astype(np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x = x ^ (x >> np.uint64(31))
    return (x % np.uint64(num_devices)).astype(np.int32)


@dataclass
class ShufflePlan:
    """Deterministic exchange plan for one block batch."""

    num_devices: int
    rows_per_pair: int            # padded row count per (src, dst) cell
    send_order: np.ndarray        # [D, rows_per_pair * D] block index (or -1)
    dest: np.ndarray              # [nblocks] final destination of each block
    recv_block: np.ndarray        # [D, D, rows_per_pair] global block id (or -1)

    @property
    def wire_rows(self) -> int:
        return self.num_devices * self.rows_per_pair


def plan_shuffle(nblocks: int, num_devices: int,
                 sizes: np.ndarray | None = None,
                 balance: bool = True, config=None) -> ShufflePlan:
    """Build the skew-balanced exchange plan.

    Blocks are assumed currently sharded contiguously: block ``i`` lives on
    source shard ``i // (nblocks / D)``.  Destinations come from
    ``hash_partition``; with ``balance`` the count skew is smoothed to the
    uniform quota.  ``sizes`` (compressed lengths) orders the balancing so
    the largest blocks move first to the emptiest destinations (greedy LPT),
    keeping per-destination *byte* skew bounded too.

    ``config`` (a ``bitar_tpu.config.ShardingConfig``): its
    ``skew_bucket_log`` coarsens the LPT ordering — sizes are bucketed by
    ``log2(size) >> skew_bucket_log`` before the sort, so plans stay
    stable under small size jitter between otherwise-identical batches
    (deterministic re-planning across hosts).
    """
    if config is not None and sizes is not None and config.skew_bucket_log > 0:
        lg = np.zeros_like(sizes)
        nz = sizes > 0
        lg[nz] = np.ceil(np.log2(sizes[nz].astype(np.float64))).astype(
            sizes.dtype)
        sizes = (lg >> config.skew_bucket_log).astype(sizes.dtype)
    if nblocks % num_devices:
        raise StatusError(Status.Invalid(
            f"nblocks {nblocks} must be padded to a multiple of {num_devices}"))
    per_src = nblocks // num_devices
    ids = np.arange(nblocks)
    dest = hash_partition(ids, num_devices)

    if balance:
        quota = -(-nblocks // num_devices)
        counts = np.bincount(dest, minlength=num_devices)
        order = np.argsort(-(sizes if sizes is not None else np.ones(nblocks)),
                           kind="stable")
        byte_load = np.zeros(num_devices, dtype=np.int64)
        for i in order:
            d = dest[i]
            if counts[d] > quota:
                # re-assign to the least-loaded under-quota destination
                cands = np.flatnonzero(counts < quota)
                d2 = cands[np.argmin(byte_load[cands])]
                counts[d] -= 1
                counts[d2] += 1
                dest[i] = d2
                d = d2
            byte_load[d] += int(sizes[i]) if sizes is not None else 1

    # Per (src, dst) cell membership, padded to the max cell size.
    cells: list[list[list[int]]] = [
        [[] for _ in range(num_devices)] for _ in range(num_devices)]
    for i in ids:
        src = i // per_src
        cells[src][int(dest[i])].append(int(i))
    rows_per_pair = max(1, max(len(c) for row in cells for c in row))

    send_order = np.full((num_devices, num_devices * rows_per_pair), -1,
                         dtype=np.int32)
    recv_block = np.full((num_devices, num_devices, rows_per_pair), -1,
                         dtype=np.int32)
    for s in range(num_devices):
        for d in range(num_devices):
            for j, b in enumerate(cells[s][d]):
                send_order[s, d * rows_per_pair + j] = b
                recv_block[d, s, j] = b
    return ShufflePlan(num_devices=num_devices, rows_per_pair=rows_per_pair,
                       send_order=send_order, dest=dest, recv_block=recv_block)


def execute_shuffle(mesh: Mesh, plan: ShufflePlan, slot_rows: jax.Array
                    ) -> jax.Array:
    """Run the all_to_all exchange of slot rows.

    ``slot_rows``: [nblocks, slot_size] uint8, sharded on blocks.
    Returns [D * wire_rows, slot_size] sharded rows where shard ``d`` holds
    ``plan.recv_block[d]``-ordered rows (pad rows where id is -1).
    """
    d = plan.num_devices
    per_src = slot_rows.shape[0] // d
    slot = slot_rows.shape[1]
    # Per-source staging metadata, sharded along the same axis as the rows:
    # shard s sees its own row of send_order (local index + validity).
    send_idx = jnp.asarray((plan.send_order % max(1, per_src)).reshape(d, 1, -1))
    valid = jnp.asarray((plan.send_order >= 0).reshape(d, 1, -1))

    def local(rows_l, send_idx_l, valid_l):
        # rows_l: [per_src, slot] -> staged [D, rows_per_pair, slot]
        staged = rows_l[send_idx_l[0, 0]] * valid_l[0, 0][:, None].astype(rows_l.dtype)
        staged = staged.reshape(d, plan.rows_per_pair, slot)
        # split dim 0 across devices, concat received chunks on dim 0:
        # cell (s, d) rides the link s->d.
        recv = jax.lax.all_to_all(staged, BLOCKS_AXIS, split_axis=0,
                                  concat_axis=0)
        return recv.reshape(d * plan.rows_per_pair, slot)

    spec = P(BLOCKS_AXIS)
    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(spec, spec, spec), out_specs=spec,
        check_vma=False,
    )(slot_rows, send_idx, valid)
