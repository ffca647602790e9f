"""The distributed pipeline step: shuffle + decode in one program.

One jitted ``shard_map`` program per step: each device stages its
compressed slot rows, exchanges them with every other device
(``all_to_all``), and runs the sequence executor on what it received, so
the exchange of burst k can overlap the decode of burst k-1 under XLA's
scheduler.  This is bitar's "enqueue next burst while the device works on
the previous one" loop (``device.cc:197-226``) lifted to a multi-device
mesh (BASELINE.json config 5).
"""

from __future__ import annotations

import functools

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.decode import TABLE_KEYS, decode_blocks
from .sharding import BLOCKS_AXIS
from .shuffle import ShufflePlan


def reorder_tables_for_recv(plan: ShufflePlan,
                            tables: dict[str, np.ndarray],
                            nseq: np.ndarray) -> tuple[dict[str, np.ndarray], np.ndarray]:
    """Arrange per-block sequence tables in post-shuffle receive order.

    Wire position ``dst * (D * rpp) + src * rpp + j`` holds global block
    ``plan.recv_block[dst, src, j]`` (or an idle row, nseq=0).
    """
    d, rpp = plan.num_devices, plan.rows_per_pair
    n_wire = d * d * rpp
    cap = tables[TABLE_KEYS[0]].shape[1]
    out = {k: np.zeros((n_wire, cap), np.int32) for k in TABLE_KEYS}
    out_nseq = np.zeros(n_wire, np.int32)
    flat = plan.recv_block.reshape(-1)
    live = flat >= 0
    idx = flat[live]
    for k in TABLE_KEYS:
        out[k][live] = tables[k][idx]
    out_nseq[live] = nseq[idx]
    return out, out_nseq


@functools.partial(
    jax.jit, static_argnames=("mesh", "rows_per_pair", "block_size"))
def distributed_step(slot_rows, send_idx, valid, nseq, lit_ptr, lit_len,
                     off, mlen, out_pos, *, mesh: Mesh, rows_per_pair: int,
                     block_size: int):
    """One fused shuffle + decode step over the mesh.

    Args (all leading dims sharded on the blocks axis):
      slot_rows: [nblocks, slot]   uint8 source rows (pre-shuffle): the
                 compressed block, or the decoded literals of a Zstd block
      send_idx:  [D, 1, D*rpp]     per-source local staging indices
      valid:     [D, 1, D*rpp]     per-source staging validity
      nseq/tables: [D * D*rpp, ...] in *receive* order (see
                   ``reorder_tables_for_recv``)

    Returns [D * D*rpp, block_size] uint8, sharded: shard d's rows are the
    decoded blocks it received.
    """
    d = mesh.devices.size
    slot = slot_rows.shape[1]

    def local(rows_l, send_idx_l, valid_l, nseq_l, lp, ll, of, ml, op):
        staged = rows_l[send_idx_l[0, 0]] * valid_l[0, 0][:, None].astype(rows_l.dtype)
        staged = staged.reshape(d, rows_per_pair, slot)
        recv = jax.lax.all_to_all(staged, BLOCKS_AXIS, split_axis=0,
                                  concat_axis=0)
        recv = recv.reshape(d * rows_per_pair, slot)
        return decode_blocks(recv, nseq_l, lp, ll, of, ml, op,
                             block_size=block_size)

    spec = P(BLOCKS_AXIS)
    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(spec,) * 9, out_specs=spec,
        check_vma=False,
    )(slot_rows, send_idx, valid, nseq, lit_ptr, lit_len, off, mlen, out_pos)


def prepare_distributed_step(
        mesh: Mesh, plan: ShufflePlan, slot_rows: np.ndarray,
        tables: dict[str, np.ndarray], nseq: np.ndarray, block_size: int,
        put=None):
    """Host-side prep for ``distributed_step``: shard the inputs and
    receive-order the tables.

    ``put`` places one host array on the mesh (default: ``device_put``
    with the blocks-axis sharding; multi-process callers pass a function
    that builds the global array from this process's rows).
    Returns (device_args tuple, static kwargs dict)."""
    d, rpp = plan.num_devices, plan.rows_per_pair
    per_src = slot_rows.shape[0] // d
    recv_tables, recv_nseq = reorder_tables_for_recv(plan, tables, nseq)
    if put is None:
        sharding = NamedSharding(mesh, P(BLOCKS_AXIS))
        put = lambda a: jax.device_put(a, sharding)  # noqa: E731
    args = (
        put(slot_rows),
        put((plan.send_order % max(1, per_src)).reshape(d, 1, -1).astype(np.int32)),
        put((plan.send_order >= 0).reshape(d, 1, -1)),
        put(recv_nseq),
        *(put(recv_tables[k]) for k in TABLE_KEYS),
    )
    kwargs = dict(mesh=mesh, rows_per_pair=rpp, block_size=block_size)
    return args, kwargs
