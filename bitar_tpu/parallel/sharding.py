"""Multi-device sharding: block-parallel codec execution over a device mesh.

The reference's only parallelism is data-parallel block streams: input split
into per-(device, queue-pair) segments, each on its own lcore
(``demo_app.cc:577-596``, ``driver.cc:100-158``).  Here that topology is a
``jax.sharding.Mesh``:

* the *blocks* axis shards the batch of independent blocks across devices
  (the dp analog — each device runs the same sequence executor on its
  shard),
* collectives run under ``shard_map`` (``all_to_all`` for the
  compressed-block shuffle), which XLA hands to NCCL on GPUs,
* multi-host jobs extend the same mesh across processes
  (``jax.distributed.initialize``; the mesh axis spans all global devices).

The mesh is 1-D over ``jax.devices()``: every GPU of a host reaches every
other at the same NVLink rate, so the layout follows the algorithm alone.
Tests and the dry run drive it on virtual CPU devices.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.decode import TABLE_KEYS, decode_blocks, pad_tables
from ..status import Status, StatusError

BLOCKS_AXIS = "blocks"


def make_mesh(num_devices: int | None = None, axis: str | None = None,
              config=None) -> Mesh:
    """A mesh over the first ``num_devices`` devices (default all).

    ``config`` (a ``bitar_tpu.config.ShardingConfig``) supplies the axis
    name and an optional multi-dim ``mesh_shape`` whose product selects
    the device count; explicit arguments win.  The discovery analog of
    the reference's lcore enumeration (``driver.cc:215-218``)."""
    if config is not None:
        if axis is None:
            axis = config.data_axis
        if num_devices is None and config.mesh_shape:
            num_devices = int(np.prod(config.mesh_shape))
    if axis is None:
        axis = BLOCKS_AXIS
    devs = jax.devices()
    if num_devices is not None:
        if num_devices > len(devs):
            raise StatusError(Status.Invalid(
                f"requested {num_devices} devices, only {len(devs)} visible"))
        devs = devs[:num_devices]
    return Mesh(np.array(devs), (axis,))


def shard_blocks(mesh: Mesh, *arrays, axis: str = BLOCKS_AXIS):
    """Place arrays with their leading (block) dim sharded over the mesh."""
    sharding = NamedSharding(mesh, P(axis))
    return tuple(jax.device_put(a, sharding) for a in arrays)


@functools.partial(jax.jit, static_argnames=("mesh", "block_size"))
def sharded_decode(src, nseq, lit_ptr, lit_len, off, mlen, out_pos, *,
                   mesh: Mesh, block_size: int):
    """Decode a block batch sharded over the mesh's blocks axis.

    Each device runs the sequence executor on its local shard; no
    communication — blocks are independent (the whole point of
    block-level compression).  Output stays sharded the same way.
    """
    spec = P(BLOCKS_AXIS)

    def local_decode(*args):
        return decode_blocks(*args, block_size=block_size)

    return jax.shard_map(
        local_decode, mesh=mesh,
        in_specs=(spec,) * 7, out_specs=spec,
        check_vma=False,
    )(src, nseq, lit_ptr, lit_len, off, mlen, out_pos)


def pad_block_count(n: int, num_devices: int) -> int:
    """Blocks per batch must divide evenly across the mesh; pad with idle
    blocks (nseq=0) to the next multiple."""
    return -(-n // num_devices) * num_devices


def prepare_sharded_batch(comps: list[np.ndarray],
                          tables: list[dict[str, np.ndarray]],
                          slot_size: int, num_devices: int):
    """Host-side batch prep: source rows + padded tables, block count
    padded to the mesh width with idle blocks (no sequences).  Returns
    ``(arrays dict, real_n)``; ``arrays["src"]`` is ``[n, slot_size]``
    uint8."""
    real_n = len(comps)
    n = pad_block_count(real_n, num_devices)
    t, nseq = pad_tables(list(tables) + [
        {k: np.zeros(0, np.int32) for k in TABLE_KEYS}] * (n - real_n))
    src = np.zeros((n, slot_size), dtype=np.uint8)
    for i, c in enumerate(comps):
        src[i, :c.shape[0]] = c
    return {"src": src, "nseq": nseq, **t}, real_n
