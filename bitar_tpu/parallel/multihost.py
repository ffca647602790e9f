"""Multi-host process topology.

The reference is strictly single-process (survey §2: lcores share one
address space; the only transport is PCIe DMA).  The multi-host
equivalent here: one process per host, connected by ``jax.distributed``,
with the global mesh spanning all processes' devices and block batches
partitioned by process before the device shuffle.

A multi-host launcher starts one python per host and passes the
coordinator address, process count and process id to ``initialize``; in
tests and single-host runs everything degrades to process_count == 1.
"""

from __future__ import annotations

import jax
import numpy as np

from ..status import Status, StatusError
from ..utils.logging import get_logger

logger = get_logger("parallel.multihost")

_initialized = False


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> dict:
    """Join the multi-host job (idempotent).

    Without a coordinator address or a process count above one this is a
    single-process run and nothing is initialized.  Returns the topology
    description."""
    global _initialized
    if not _initialized and (coordinator_address is not None
                             or num_processes not in (None, 1)):
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id)
        _initialized = True
    topo = describe()
    logger.info("multihost topology: %s", topo)
    return topo


def describe() -> dict:
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_device_count": jax.local_device_count(),
        "global_device_count": jax.device_count(),
    }


def partition_blocks(nblocks: int, process_count: int | None = None,
                     process_index: int | None = None) -> tuple[int, int]:
    """[start, stop) of the block range this process stages.

    Host-level split preceding the device-level shuffle: each process
    ingests and compresses its contiguous share, then the mesh-wide
    ``all_to_all`` redistributes compressed blocks between devices (host
    networking never carries block payloads — the reference's PCIe-only
    transport discipline lifted to many hosts)."""
    pc = process_count if process_count is not None else jax.process_count()
    pi = process_index if process_index is not None else jax.process_index()
    if not (0 <= pi < pc):
        raise StatusError(Status.Invalid(f"process {pi} outside [0, {pc})"))
    per = -(-nblocks // pc)
    return min(pi * per, nblocks), min((pi + 1) * per, nblocks)


def process_spans(nblocks: int, process_count: int | None = None
                  ) -> np.ndarray:
    """All processes' [start, stop) spans as an [pc, 2] array."""
    pc = process_count if process_count is not None else jax.process_count()
    return np.array([partition_blocks(nblocks, pc, i) for i in range(pc)],
                    dtype=np.int64)
