"""Device-memory slot arena: preallocated compressed-output pool with take/put/recycle.

A redesign of the reference's two memory engines:

* ``DeviceMemory`` (reference ``src/memory.cc:121-235``): a mutex-guarded
  pool of preallocated fixed-size memzones used as compression destination
  buffers, with a critical-path allocation fallback and a rate-limited
  pool-pressure warning.  Here the pool is ONE device-resident
  ``[num_slots, slot_size]`` uint8 array allocated at engine init (the
  memzone preallocation), and slots are rows.  Writes land via donated
  ``dynamic_update_slice`` so XLA updates the arena in place — the
  zero-copy analog of attaching external buffers to mbufs.
* ``RtememzoneAllocatorTracker`` (reference ``src/memory_pool.cc:295-319``):
  the address->memzone map that lets a raw pointer be returned to its pool.
  Here ``CompressedBlockRef`` carries its slot id explicitly, and the
  tracker maps ref identity -> slot for ``recycle``.

Semantics preserved from the reference:

* >= ``MIN_POOL_SLOTS`` slots required at preallocation
  (``kMinPreallocateMemzones``, ``memory.h:51``).
* ``take`` beyond the preallocated pool succeeds up to ``max_slots`` via
  "critical-path growth" with a rate-limited warning
  (``memory.cc:161-189``); beyond that it is a CapacityError.
* ``put``/``recycle`` return slots in any order; double-put is an error
  (the reference's occupied-set check, ``memory.cc:192-209``).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MIN_POOL_SLOTS
from ..status import Status, StatusError
from ..utils.logging import get_logger

logger = get_logger("memory.arena")


@dataclass
class ArenaStats:
    """Allocation statistics, mirroring arrow::MemoryPool's stats surface
    (reference ``memory_pool.cc:267-279``) plus pool-pressure counters."""

    bytes_reserved: int = 0
    max_in_use: int = 0
    num_takes: int = 0
    num_puts: int = 0
    num_recycles: int = 0
    critical_growths: int = 0

    def snapshot(self) -> dict:
        return dict(self.__dict__)


@dataclass(frozen=True)
class CompressedBlockRef:
    """A handle to one compressed block living in an arena slot.

    The analog of an ``arrow::Buffer`` aliasing pool memory in the
    reference's ``BufferVector`` — but with the slot id explicit, so
    recycling needs no address lookup."""

    slot: int
    length: int
    codec_id: int = 0
    checksum: int = 0


class SlotPool:
    """Thread-safe free-list of slot indices with occupied-set checking.

    Pure host bookkeeping (the device array itself never moves); the
    direct analog of DeviceMemory's ``Take``/``Put`` stack + occupied set
    (reference ``memory.cc:161-209``)."""

    _WARN_INTERVAL_S = 5.0

    def __init__(self, preallocated: int, max_slots: int, slot_size: int):
        if preallocated < MIN_POOL_SLOTS:
            raise StatusError(Status.Invalid(
                f"preallocated slots {preallocated} < minimum {MIN_POOL_SLOTS} "
                f"(reference kMinPreallocateMemzones)"))
        if max_slots < preallocated:
            raise StatusError(Status.Invalid(
                f"max_slots {max_slots} < preallocated {preallocated}"))
        self._lock = threading.Lock()
        self._free: list[int] = list(range(preallocated - 1, -1, -1))
        self._occupied: set[int] = set()
        self._high_water = preallocated   # slots ever made available
        self._max_slots = max_slots
        self._last_warn = 0.0
        self.stats = ArenaStats(bytes_reserved=preallocated * slot_size)
        self._slot_size = slot_size

    @property
    def capacity(self) -> int:
        return self._high_water

    @property
    def num_free(self) -> int:
        with self._lock:
            return len(self._free)

    def take(self, n: int = 1) -> list[int]:
        """Pop n slots, growing past the preallocation (with a rate-limited
        warning) up to max_slots; CapacityError beyond."""
        with self._lock:
            got: list[int] = []
            while len(got) < n and self._free:
                got.append(self._free.pop())
            grow = n - len(got)
            if grow > 0:
                if self._high_water + grow > self._max_slots:
                    # undo partial take
                    self._free.extend(reversed(got))
                    raise StatusError(Status.CapacityError(
                        f"arena exhausted: want {grow} more slots, "
                        f"high-water {self._high_water}, max {self._max_slots}"))
                now = time.monotonic()
                if now - self._last_warn > self._WARN_INTERVAL_S:
                    logger.warning(
                        "arena growing on the critical path: +%d slots "
                        "(high-water %d -> %d); consider a larger preallocation",
                        grow, self._high_water, self._high_water + grow)
                    self._last_warn = now
                got.extend(range(self._high_water, self._high_water + grow))
                self._high_water += grow
                self.stats.critical_growths += 1
                self.stats.bytes_reserved = self._high_water * self._slot_size
            self._occupied.update(got)
            self.stats.num_takes += n
            self.stats.max_in_use = max(self.stats.max_in_use, len(self._occupied))
            return got

    def put(self, slots: list[int] | int) -> None:
        if isinstance(slots, int):
            slots = [slots]
        with self._lock:
            for s in slots:
                if s not in self._occupied:
                    raise StatusError(Status.Invalid(
                        f"slot {s} returned to pool but not taken (double put?)"))
                self._occupied.remove(s)
                self._free.append(s)
            self.stats.num_puts += len(slots)

    def in_use(self) -> int:
        with self._lock:
            return len(self._occupied)


class DeviceArena:
    """The device-resident compressed-block pool for one engine.

    Holds one ``[max_slots, slot_size]`` uint8 jax array on the target
    device.  ``write_burst`` scatters a burst of compressed rows into taken
    slots in place (donated buffer); ``gather_burst`` pulls slot rows back
    out for decompression or host readout.
    """

    def __init__(self, slot_size: int, preallocated: int, max_slots: int,
                 device=None):
        self.slot_size = int(slot_size)
        self.pool = SlotPool(preallocated, max_slots, slot_size)
        self.device = device
        with jax.default_device(device) if device is not None else _nullcontext():
            # Allocate the full ceiling once: the reference preallocates its
            # memzone budget up front (app_common.cc:92-100) precisely to
            # keep allocation off the critical path.
            self._buf = jnp.zeros((max_slots, slot_size), dtype=jnp.uint8)
        self._tracker: dict[int, int] = {}  # id(ref) -> slot
        self._write = jax.jit(_scatter_rows, donate_argnums=(0,))
        self._gather = jax.jit(_gather_rows)
        # Per-slot write generation: bumped on every write_burst.  Lets
        # decode-side validators cache per-block results and re-walk only
        # slots whose bytes could have changed (reference contrast: the
        # DPU re-reads host memzones on every op, device.cc:465-535; here
        # a host re-walk is O(bytes), so it is generation-gated).
        self._slot_gen = np.zeros(max_slots, np.int64)
        # Data-plane mutex: writes donate the pool buffer in place, so two
        # concurrent streams must not race on the handle (the reference
        # guards its shared DeviceMemory pool the same way, memory.cc:162).
        self._buf_lock = threading.Lock()

    # -- data plane ----------------------------------------------------
    def write_burst(self, slot_ids: list[int], rows: jax.Array) -> None:
        """Store ``rows[i]`` into slot ``slot_ids[i]`` (in-place on device).

        ``rows`` may be narrower than ``slot_size`` (a used-prefix write):
        the device zero-fills the remainder, so the host->device wire
        carries only the used bytes — on a thin link the transfer, not
        the scatter, is the cost.  Callers should quantize the width
        (compress does: slot/8 steps) so the jitted scatter compiles a
        bounded set of shapes."""
        assert rows.ndim == 2 and rows.shape[1] <= self.slot_size, rows.shape
        idx = jnp.asarray(np.asarray(slot_ids, dtype=np.int32))
        with self._buf_lock:
            self._slot_gen[np.asarray(slot_ids, dtype=np.int64)] += 1
            self._buf = self._write(self._buf, rows, idx)

    def slot_generations(self, slot_ids: list[int]) -> np.ndarray:
        """Current write-generation per slot (validation-cache key)."""
        with self._buf_lock:
            return self._slot_gen[np.asarray(slot_ids, dtype=np.int64)].copy()

    def gather_burst(self, slot_ids: list[int]) -> jax.Array:
        idx = jnp.asarray(np.asarray(slot_ids, dtype=np.int32))
        with self._buf_lock:
            return self._gather(self._buf, idx)

    def read_host(self, ref: CompressedBlockRef) -> np.ndarray:
        with self._buf_lock:
            row = np.asarray(self._buf[ref.slot])
        return row[:ref.length]

    # -- control plane -------------------------------------------------
    def take_refs(self, lengths: list[int], codec_ids: list[int] | None = None
                  ) -> list[CompressedBlockRef]:
        slots = self.pool.take(len(lengths))
        refs = []
        for i, (s, ln) in enumerate(zip(slots, lengths)):
            ref = CompressedBlockRef(
                slot=s, length=ln,
                codec_id=codec_ids[i] if codec_ids else 0)
            self._tracker[id(ref)] = s
            refs.append(ref)
        return refs

    def recycle(self, refs: list[CompressedBlockRef]) -> int:
        """Return compressed blocks to the pool; returns count recycled.

        The analog of ``CompressDevice::Recycle`` (reference
        ``device.cc:321-327``) — the demo app asserts the count matches
        what it handed in (``demo_app.cc:500,530``)."""
        slots = []
        for ref in refs:
            slot = self._tracker.pop(id(ref), None)
            if slot is None:
                raise StatusError(Status.Invalid(
                    f"recycled ref (slot {ref.slot}) unknown to this arena"))
            slots.append(slot)
        self.pool.put(slots)
        self.pool.stats.num_recycles += len(slots)
        return len(slots)

    @property
    def stats(self) -> ArenaStats:
        return self.pool.stats


class _nullcontext:
    def __enter__(self):
        return None

    def __exit__(self, *a):
        return False


def _scatter_rows(buf: jax.Array, rows: jax.Array, idx: jax.Array) -> jax.Array:
    if rows.shape[1] < buf.shape[1]:    # prefix write: zero-fill device-side
        rows = jnp.pad(rows, ((0, 0), (0, buf.shape[1] - rows.shape[1])))
    return buf.at[idx].set(rows)


def _gather_rows(buf: jax.Array, idx: jax.Array) -> jax.Array:
    return buf[idx]
