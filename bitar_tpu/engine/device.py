"""Engine: the per-device compression runtime.

The analog of ``CompressDevice`` (reference ``src/device.cc`` +
``src/include/device.h``): one engine owns one accelerator device, validates
its configuration against device capabilities at ``initialize``, walks a
state machine (CREATED -> STARTED -> RELEASED, reference ``device.h:64-68``),
runs the synchronous ``compress``/``decompress`` burst loops, and recycles
compressed output back to its arena.

Mapping of the reference hot loop (``device.cc:157-318``):

* assemble burst   -> stage a burst of blocks (host codec batch, or arena
                      gather + sequence tables, all device-side)
* enqueue burst    -> dispatch the device sequence executor / host batch
* dequeue burst    -> jax async dispatch join / thread join; per-block
                      status walk
* Recycle          -> ``recycle`` returns arena slots (``device.cc:321-327``)

Compression executes on the host (multithreaded native C++), with output
staged device-resident in the arena — the reference likewise offloads
codec work to a foreign engine (the DPU) and keeps results in DMA-reachable
pool memory.  Decompression executes on the device for every codec: the
host parses each block's framing into a sequence table once, and
``ops.decode.decode_blocks`` executes the tables of a whole burst.  There
is one device decode path and no silent host fallback: a device failure
raises, and per-block data errors come back in the status vector.
"""

from __future__ import annotations

import concurrent.futures
import enum
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..config import (
    Checksum,
    Codec,
    DeviceCapabilities,
    EngineConfig,
    capabilities_for_device,
)
from ..manifest import BlockManifest, CompressedBuffers, checksum_of, codec_from_id, codec_id
from ..memory.arena import CompressedBlockRef, DeviceArena
from ..memory.host_pool import PoolBackend, get_memory_pool
from ..ops import registry
from ..ops.cpu import native
from ..ops.decode import TABLE_KEYS, decode_blocks, pad_tables
from ..status import Status, StatusError
from ..utils.logging import get_logger

logger = get_logger("engine.device")

_RAW_ID = codec_id(Codec.RAW)
_IO_ERROR = Status.IOError("").to_int()


class EngineState(enum.Enum):
    """Reference device state machine (``device.h:64-68``)."""

    CREATED = "created"
    STARTED = "started"
    RELEASED = "released"


@dataclass
class EngineStats:
    """Counter surface mirroring ``rte_compressdev_stats_get``
    (consulted by the reference's silent-failure heuristic,
    ``device.cc:84-110``)."""

    enqueued_blocks: int = 0
    dequeued_blocks: int = 0
    enqueue_err_blocks: int = 0
    dequeue_err_blocks: int = 0
    bytes_compressed: int = 0
    bytes_decompressed: int = 0
    device_decode_bursts: int = 0
    host_decode_bursts: int = 0


@dataclass
class _BurstInputs:
    """Device-resident executor inputs of one decode burst."""

    start: int
    stop: int
    slots: list[int]
    tables: tuple            # 5 x [burst, cap] int32, TABLE_KEYS order
    nseq: jax.Array          # [burst] int32
    lit_idx: jax.Array | None = None    # rows whose source is literals
    lit_rows: jax.Array | None = None   # [k, slot] uint8 decoded literals


@dataclass
class CompressedUnit:
    """A compressed buffer set: manifest + device-resident arena slots +
    the sequence-table sidecar for the device decoder.

    The analog of the reference's returned ``BufferVector`` (aliasing pool
    memzones) plus the framing the reference kept implicit."""

    manifest: BlockManifest
    refs: list[CompressedBlockRef]
    engine: "Engine"
    tables: dict[str, np.ndarray] | None = None   # [nblocks, cap] SoA
    nseq: np.ndarray | None = None                # [nblocks]
    #: Zstd blocks' host-entropy-decoded literal streams, by block index:
    #: the executor's source row for those blocks.
    lit_rows: dict[int, np.ndarray] = field(default_factory=dict)
    #: Per-block status of the table build (0, or the parse error of a
    #: block whose framing does not walk; such blocks get empty tables).
    table_status: np.ndarray | None = None
    recycled: bool = field(default=False)
    #: Host copy of the staged slot rows, kept by compress/import so the
    #: table build never pays a device readback; dropped once tables exist.
    _staging: np.ndarray | None = field(default=None, repr=False)
    _staging_buf: object | None = field(default=None, repr=False)
    #: False while compressed bytes live only in host staging (deferred
    #: commit); Engine._ensure_committed uploads them before any arena
    #: read.
    _committed: bool = field(default=True, repr=False)
    #: Device-resident executor inputs per burst, uploaded once.
    _bursts: list[_BurstInputs] | None = field(default=None, repr=False)
    #: Validation cache: per-block (arena write generation, status) as of
    #: the last framing walk.  Blocks whose slot generation is unchanged
    #: skip the O(bytes) host re-walk on later decompresses.
    _val_gen: np.ndarray | None = field(default=None, repr=False)
    _val_status: np.ndarray | None = field(default=None, repr=False)

    @property
    def nblocks(self) -> int:
        return self.manifest.nblocks

    def to_host(self) -> CompressedBuffers:
        """Materialize the packed compressed bytes on host (from the
        staging copy when present — a deferred-commit unit's bytes may
        not have reached the arena yet)."""
        self._check_live()
        rows = self.engine._staging_rows(self)
        packed = np.concatenate([
            rows[i, :int(self.manifest.comp_len[i])] for i in range(self.nblocks)])
        return CompressedBuffers(manifest=self.manifest, packed=packed)

    def _drop_staging(self) -> None:
        self._staging = None
        if self._staging_buf is not None:
            self._staging_buf.free()
            self._staging_buf = None

    def _check_live(self) -> None:
        if self.recycled:
            raise StatusError(Status.Invalid("compressed unit already recycled"))


class Engine:
    """One device's compression/decompression runtime."""

    def __init__(self, config: EngineConfig, device=None, device_index: int = 0):
        self.config = config
        self.device = device
        self.device_index = device_index
        self.state = EngineState.CREATED
        self.caps: DeviceCapabilities | None = None
        self.arena: DeviceArena | None = None
        self.stats = EngineStats()

    # ------------------------------------------------------------------
    def initialize(self) -> "Engine":
        """Validate config against device capabilities and preallocate the
        arena (reference ``Initialize``, ``device.cc:115-154``)."""
        if self.state != EngineState.CREATED:
            raise StatusError(Status.Invalid(
                f"initialize called in state {self.state.value}"))
        if self.device is None:
            self.device = jax.devices()[0]
        self.caps = capabilities_for_device(self.device)
        self.config.validate(self.caps).with_context(
            f"Engine(device={self.device})").raise_if_error()
        self.arena = DeviceArena(
            slot_size=self.config.slot_size,
            preallocated=self.config.max_pool_slots,
            max_slots=self.config.max_pool_slots,
            device=self.device)
        self.state = EngineState.STARTED
        logger.info("engine started on %s: codec=%s block=%d slot=%d pool=%d",
                    self.device, self.config.codec.value, self.config.block_size,
                    self.config.slot_size, self.config.max_pool_slots)
        return self

    def release(self) -> None:
        """Teardown by state (reference dtor, ``device.cc:330-343``)."""
        self.arena = None
        self.state = EngineState.RELEASED

    def __enter__(self) -> "Engine":
        return self.initialize() if self.state == EngineState.CREATED else self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def _entry_guard(self) -> None:
        """Reject calls on a non-started engine (reference ``EntryGuard``,
        ``device.cc:444-462``; the busy-queue check lives in Stream)."""
        if self.state != EngineState.STARTED:
            raise StatusError(Status.Invalid(
                f"engine not started (state={self.state.value})"))

    def _put(self, x) -> jax.Array:
        return jax.device_put(x, self.device)

    # ------------------------------------------------------------------
    def compress(self, data, sizes=None) -> CompressedUnit:
        """Synchronous compress of one buffer into device-resident blocks.

        The analog of ``CompressDevice::Compress`` (``device.cc:157-238``):
        split into blocks, run codec bursts, land output in arena slots,
        return the unit (caller recycles it when done).

        ``sizes``: optional explicit per-block split (a skewed
        distribution, BASELINE config 4); every entry must be within
        ``block_size`` (which sizes slots) and sum to ``len(data)``.
        Default: uniform ``block_size`` split with a ragged tail."""
        self._entry_guard()
        raw = np.frombuffer(data, dtype=np.uint8) if isinstance(
            data, (bytes, bytearray, memoryview)) else np.ascontiguousarray(data, np.uint8)
        cfg = self.config
        if sizes is None:
            manifest = BlockManifest.plan(raw.shape[0], cfg.block_size)
        else:
            manifest = BlockManifest.plan_sizes(sizes, cfg.block_size)
            if manifest.total_raw != raw.shape[0]:
                raise StatusError(Status.Invalid(
                    f"sizes sum {manifest.total_raw} != data length "
                    f"{raw.shape[0]}"))
        manifest.checksum_kind = cfg.checksum
        n = manifest.nblocks
        slot = cfg.slot_size

        # Staging comes from the pooled host allocator (the reference's
        # Rtememzone ingest pool, memory_pool.cc:321-350): page-aligned
        # buffers reused across bursts, no per-call zero fill (every
        # consumer slices to per-block lengths).
        staging_buf = get_memory_pool(PoolBackend.ALIGNED).allocate(n * slot)
        staging = staging_buf.view().reshape(n, slot)
        dst_off = np.arange(n, dtype=np.int64) * slot
        caps = np.full(n, slot, dtype=np.int32)
        self.stats.enqueued_blocks += n
        codec_ids = np.full(n, codec_id(cfg.codec), dtype=np.int32)
        dst_len = np.zeros(n, np.int32)
        refs: list[CompressedBlockRef] = []
        # Quantized used-prefix uploads: the wire carries only the burst's
        # compressed bytes (rounded to slot/8 so the scatter compiles at
        # most 8 shapes); the arena zero-fills the slot tails device-side.
        wstep = max(128, cfg.slot_size // 8)

        def _match(s: int, e: int):
            return registry.host_compress_batch(
                cfg.codec, cfg.level, raw, manifest.raw_off[s:e],
                manifest.raw_len[s:e], staging.reshape(-1),
                dst_off[s:e], caps[s:e], min_match=cfg.min_match)

        def _land(s: int, e: int, dl, st):
            """Per-chunk dequeue: status walk, incompressible->RAW
            fallback (the reference sizes slots 1.1x for exactly this
            data; config.cc:60-73 — we go further and skip the codec),
            slot take, used-prefix upload."""
            bad = np.flatnonzero(st < 0)
            if bad.size:
                self.stats.enqueue_err_blocks += int(bad.size)
                raise StatusError(Status.from_int(
                    int(st[bad[0]]),
                    f"compress failed on blocks {(s + bad).tolist()[:8]}"))
            dst_len[s:e] = dl
            for j in np.flatnonzero(dl >= manifest.raw_len[s:e]):
                i = s + int(j)
                ln = int(manifest.raw_len[i])
                o = int(manifest.raw_off[i])
                staging[i, :ln] = raw[o:o + ln]
                dst_len[i] = ln
                codec_ids[i] = _RAW_ID
            chunk_refs = self.arena.take_refs(
                [int(x) for x in dst_len[s:e]],
                [int(c) for c in codec_ids[s:e]])
            refs.extend(chunk_refs)
            if cfg.commit == "deferred":
                return       # bytes stay in pool staging until first use
            w = int(dst_len[s:e].max(initial=1))
            w = min(cfg.slot_size, -(-w // wstep) * wstep)
            self.arena.write_burst(
                [r.slot for r in chunk_refs],
                self._put(np.ascontiguousarray(staging[s:e, :w])))

        try:
            # Matcher/upload pipeline: the native matcher chews chunk k+1
            # on its own threads (ctypes releases the GIL) while this
            # thread stages chunk k — the reference's enqueue-while-dequeue
            # hot loop (device.cc:197-226) applied to compression.
            step = min(cfg.burst_size, 64)
            with concurrent.futures.ThreadPoolExecutor(1) as ex:
                fut = ex.submit(_match, 0, min(step, n))
                for s in range(0, n, step):
                    e = min(s + step, n)
                    dl, st = fut.result()
                    if e < n:
                        fut = ex.submit(_match, e, min(e + step, n))
                    _land(s, e, dl, st)
        except Exception:
            if refs:
                self.arena.recycle(refs)
            raise

        manifest.comp_len = dst_len.astype(np.int32)
        manifest.codec_ids = codec_ids
        if cfg.checksum != Checksum.NONE:
            for i in range(n):
                o, ln = int(manifest.raw_off[i]), int(manifest.raw_len[i])
                manifest.checksums[i] = checksum_of(cfg.checksum, raw[o:o + ln])
        self.stats.dequeued_blocks += n
        self.stats.bytes_compressed += int(manifest.total_raw)
        return CompressedUnit(manifest=manifest, refs=refs, engine=self,
                              _staging=staging, _staging_buf=staging_buf,
                              _committed=(cfg.commit == "eager"))

    # ------------------------------------------------------------------
    def _parse_block(self, cid: int, comp: np.ndarray, raw_len: int):
        """One block's sequence table (+ decoded literals for Zstd).

        Raises StatusError when the framing does not walk or decodes to
        another length than the manifest's ``raw_len`` (a foreign block
        decoding past its extent would otherwise write past its row)."""
        codec = codec_from_id(cid)
        if codec == Codec.RAW:
            if comp.shape[0] != raw_len:
                raise StatusError(Status.IOError(
                    f"RAW block of {comp.shape[0]}B != raw_len {raw_len}"))
            one = lambda v: np.array([v], np.int32)  # noqa: E731
            return {"lit_ptr": one(0), "lit_len": one(raw_len), "off": one(0),
                    "mlen": one(0), "out_pos": one(0)}, None
        if codec == Codec.ZSTD:
            t, lits = native.zstd_parse(comp, max_seq=raw_len + 16,
                                        lit_cap=max(64, raw_len))
        else:
            t, lits = native.parse_sequences(comp, codec.value), None
        ends = t["out_pos"] + t["lit_len"] + t["mlen"]
        total = int(ends[-1]) if ends.shape[0] else 0
        if total != raw_len or (ends.shape[0] and int(ends.max()) > raw_len):
            raise StatusError(Status.IOError(
                f"parsed decode size {total} != raw_len {raw_len}"))
        return t, lits

    def _build_tables(self, unit: CompressedUnit, staging: np.ndarray) -> None:
        """Parse every block's sequence table into the unit's sidecar.

        A block whose framing does not walk gets an empty table and its
        error in ``unit.table_status``; the other blocks still decode on
        the device (the reference decodes each op independently,
        ``device.cc:512-520``)."""
        m = unit.manifest
        per_block, lit_rows = [], {}
        status = np.zeros(m.nblocks, np.int32)
        empty = {k: np.zeros(0, np.int32) for k in TABLE_KEYS}
        for i in range(m.nblocks):
            comp = staging[i, :int(m.comp_len[i])]
            try:
                t, lits = self._parse_block(int(m.codec_ids[i]), comp,
                                            int(m.raw_len[i]))
            except StatusError as e:
                logger.warning("block %d: %s; reported in its status", i,
                               e.status)
                t, lits = empty, None
                status[i] = e.status.to_int()
            per_block.append(t)
            if lits is not None:
                lit_rows[i] = lits
        unit.tables, unit.nseq = pad_tables(per_block)
        unit.lit_rows = lit_rows
        unit.table_status = status

    def _ensure_committed(self, unit: CompressedUnit) -> None:
        """Upload a deferred-commit unit's compressed bytes to the arena
        before any device read (the decode-side DMA the reference's
        device performs on host memzones)."""
        if unit._committed:
            return
        if unit._staging is None:
            raise StatusError(Status.Invalid(
                "uncommitted unit has no staging bytes"))
        m, cfg = unit.manifest, self.config
        wstep = max(128, cfg.slot_size // 8)
        for s in range(0, m.nblocks, cfg.burst_size):
            e = min(m.nblocks, s + cfg.burst_size)
            w = int(m.comp_len[s:e].max(initial=1))
            w = min(cfg.slot_size, -(-w // wstep) * wstep)
            self.arena.write_burst(
                [r.slot for r in unit.refs[s:e]],
                self._put(np.ascontiguousarray(unit._staging[s:e, :w])))
        unit._committed = True

    def ensure_tables(self, unit: CompressedUnit) -> None:
        """Build the unit's decode sidecar on first use (one attempt),
        commit its bytes to the arena, and drop the host staging copy."""
        self._entry_guard()
        unit._check_live()
        if unit.tables is not None:
            return
        staging = self._staging_rows(unit)
        self._ensure_committed(unit)
        self._build_tables(unit, staging)
        unit._drop_staging()

    # ------------------------------------------------------------------
    def decompress(self, unit: CompressedUnit, out: np.ndarray | None = None
                   ) -> np.ndarray:
        """Synchronous decompress of a unit back to raw bytes.

        Mirrors ``CompressDevice::Decompress`` (``device.cc:241-318``):
        caller may provide an output buffer of at least ``total_raw`` bytes
        (the ResizableBuffer contract); the returned view is sized exactly.
        Raises on any block failure, naming EVERY failed block (the
        reference walks all ops before reporting, ``device.cc:512-520``);
        use :meth:`decompress_status` for the non-raising per-block form."""
        out, status = self.decompress_status(unit, out)
        bad = np.flatnonzero(status < 0)
        if bad.size:
            raise StatusError(Status.from_int(
                int(status[bad[0]]),
                f"decompress failed on {bad.size}/{status.shape[0]} blocks "
                f"{bad.tolist()[:16]} "
                f"(statuses {status[bad].tolist()[:16]})"))
        return out

    def decompress_status(self, unit: CompressedUnit,
                          out: np.ndarray | None = None
                          ) -> tuple[np.ndarray, np.ndarray]:
        """Decompress with per-block status reporting (never raises for
        data errors; a failure of the device itself raises).

        Returns ``(out_view, status)`` where ``status[i]`` is 0 for a
        byte-verified block and a negative StatusCode for a failed one —
        the analog of the reference's per-op status walk at dequeue
        (``device.cc:512-520``).  Good blocks land in ``out`` even when
        neighbors fail."""
        self._entry_guard()
        unit._check_live()
        if unit.engine is not self:
            raise StatusError(Status.Invalid(
                "unit was produced by a different engine"))
        m = unit.manifest
        if out is None:
            out = np.empty(m.total_raw, dtype=np.uint8)
        elif out.shape[0] < m.total_raw:
            raise StatusError(Status.CapacityError(
                f"output buffer {out.shape[0]} < total_raw {m.total_raw}"))

        if self.config.use_device_kernels:
            status = self._decompress_device(unit, out)
        else:
            status = self._decompress_host(unit, out)

        if m.checksum_kind != Checksum.NONE:
            for i in range(m.nblocks):
                if status[i] < 0:
                    continue
                o, ln = int(m.raw_off[i]), int(m.raw_len[i])
                got = checksum_of(m.checksum_kind, out[o:o + ln])
                if got != int(m.checksums[i]):
                    status[i] = _IO_ERROR
        bad = int((status < 0).sum())
        if bad:
            self.stats.dequeue_err_blocks += bad
            # Silent-failure heuristic (reference GetErrorCount polling,
            # device.cc:84-110): surface accumulated error counters even
            # on the non-raising path.
            logger.warning(
                "decompress: %d/%d blocks failed (engine error count now "
                "%d)", bad, m.nblocks, self.error_count())
        self.stats.bytes_decompressed += int(m.total_raw)
        return out[:m.total_raw], status

    def error_count(self) -> int:
        """Accumulated per-block error counters (the reference's
        ``rte_compressdev_stats_get`` enqueue/dequeue error sum consulted
        by its silent-failure heuristic, ``device.cc:84-110``)."""
        return self.stats.enqueue_err_blocks + self.stats.dequeue_err_blocks

    # ------------------------------------------------------------------
    def _stage(self, tables: dict[str, np.ndarray], nseq: np.ndarray,
               lit_rows: dict[int, np.ndarray], start: int, stop: int,
               slots: list[int], rows: int, width: int = 0) -> _BurstInputs:
        """Upload one launch's executor inputs: table rows
        ``[start, stop)`` zero-padded to ``rows`` (idle rows have no
        sequences, so every dispatch of a unit reuses one compiled
        program), and the decoded-literal rows of the Zstd blocks among
        them, keyed by their row in the launch, ``width`` (default: this
        engine's slot) bytes wide like the slot rows they replace."""
        def padded(a: np.ndarray) -> jax.Array:
            out = np.zeros((rows,) + a.shape[1:], np.int32)
            out[:stop - start] = a[start:stop]
            return self._put(out)

        b = _BurstInputs(start, stop, slots,
                         tuple(padded(tables[k]) for k in TABLE_KEYS),
                         padded(nseq))
        if lit_rows:
            lit = np.zeros((len(lit_rows), width or self.config.slot_size),
                           np.uint8)
            for r, row in enumerate(lit_rows.values()):
                lit[r, :row.shape[0]] = row
            b.lit_idx = self._put(np.fromiter(lit_rows, np.int32))
            b.lit_rows = self._put(lit)
        return b

    def _burst_inputs(self, unit: CompressedUnit) -> list[_BurstInputs]:
        """The unit's executor inputs, one entry per ``burst_size`` blocks,
        uploaded once and reused by every later decode."""
        if unit._bursts is None:
            self.ensure_tables(unit)
            burst, n = self.config.burst_size, unit.nblocks
            unit._bursts = []
            for start in range(0, n, burst):
                stop = min(n, start + burst)
                slots = [r.slot for r in unit.refs[start:stop]]
                slots += [slots[-1]] * (burst - len(slots))
                lits = {i - start: row for i, row in unit.lit_rows.items()
                        if start <= i < stop}
                unit._bursts.append(self._stage(
                    unit.tables, unit.nseq, lits, start, stop, slots, burst))
        return unit._bursts

    def _launch(self, b: _BurstInputs, rows: jax.Array) -> jax.Array:
        """Dispatch the executor on one burst's gathered slot rows."""
        if b.lit_idx is not None:
            rows = rows.at[b.lit_idx].set(b.lit_rows)
        self.stats.device_decode_bursts += 1
        return decode_blocks(rows, b.nseq, *b.tables,
                             block_size=self.config.block_size)

    def _check_tables(self, unit: CompressedUnit) -> None:
        """Device-resident decodes carry no status vector: refuse units
        with blocks whose framing did not parse."""
        bad = np.flatnonzero(unit.table_status)
        if bad.size:
            raise StatusError(Status.from_int(
                int(unit.table_status[bad[0]]),
                f"blocks {bad.tolist()[:16]} have malformed framing; use "
                f"decompress_status for per-block results"))

    def decompress_device(self, unit: CompressedUnit) -> list[jax.Array]:
        """Decompress entirely on device: returns per-burst
        ``[burst_size, block_size]`` uint8 device arrays, in block order,
        with no host readout (the tail burst has idle padding rows).

        This is the production-shaped path: decompressed blocks normally
        feed further device compute (the zero-copy contract).
        ``decompress`` wraps the same launches with readout + reassembly."""
        self._entry_guard()
        unit._check_live()
        bursts = self._burst_inputs(unit)
        self._check_tables(unit)
        return [self._launch(b, self.arena.gather_burst(b.slots))
                for b in bursts]

    def prepare_device_decode(self, unit: CompressedUnit):
        """Stage a unit for repeated device-resident decode.

        Returns a zero-argument ``launch`` callable: each call dispatches
        ONE whole-unit decode on device-committed inputs (slot rows,
        tables and Zstd literal rows staged once here) and returns the
        ``[nblocks, block_size]`` uint8 device array, with no host
        transfers on the hot path."""
        self._entry_guard()
        unit._check_live()
        self.ensure_tables(unit)
        self._check_tables(unit)
        n = unit.nblocks
        rows = self.arena.gather_burst([r.slot for r in unit.refs])
        b = self._stage(unit.tables, unit.nseq, unit.lit_rows, 0, n, [], n)
        return lambda: self._launch(b, rows)

    def _decompress_device(self, unit: CompressedUnit, out: np.ndarray
                           ) -> np.ndarray:
        """Device decode of every burst; each burst's bytes land in
        ``out`` as its readback completes (the reference dequeues
        whichever ops finish first, ``device.cc:492-535``).

        Status is REAL per-block (the reference's per-op status walk,
        ``device.cc:512-520``): while the launches are in flight the
        current arena bytes of every block are re-walked host-side —
        the tables the executor runs were parsed at build time, so
        corruption landing in a slot *after* the build would otherwise
        decode garbage silently."""
        m = unit.manifest
        bursts = self._burst_inputs(unit)
        status = unit.table_status.copy()
        with concurrent.futures.ThreadPoolExecutor(3) as ex:
            vfut = ex.submit(self._validate_unit, unit, status)
            launched = [(b, self._launch(b, self.arena.gather_burst(b.slots)))
                        for b in bursts]
            self.stats.enqueued_blocks += m.nblocks
            pending = {ex.submit(np.asarray, dev): b for b, dev in launched}
            for done in concurrent.futures.as_completed(pending):
                b = pending[done]
                host = done.result()                   # [burst, block] u8
                for i in range(b.start, b.stop):
                    o, ln = int(m.raw_off[i]), int(m.raw_len[i])
                    out[o:o + ln] = host[i - b.start, :ln]
                self.stats.dequeued_blocks += b.stop - b.start
            vfut.result()
        return status

    def _validate_unit(self, unit: CompressedUnit,
                       status: np.ndarray) -> None:
        """Decode-time framing validation: re-parse each block's CURRENT
        compressed bytes and check the decoded extent against the
        manifest; a block whose slot bytes no longer walk cleanly is
        named in ``status``.

        GENERATION-GATED: the walk is O(bytes) per block, so its result
        caches per block keyed by the arena slot's write generation —
        repeat decompresses of untouched slots do O(1) host work, while
        a slot rewritten after the table build (the corruption the walk
        exists to catch) re-validates."""
        m = unit.manifest
        all_slots = [r.slot for r in unit.refs]
        # Capture generations BEFORE reading bytes: a write racing the
        # gather bumps the gen, so the stale validation can't stick.
        gens = self.arena.slot_generations(all_slots)
        if unit._val_gen is None:
            stale = np.arange(m.nblocks)
            unit._val_status = np.zeros(m.nblocks, np.int32)
        else:
            stale = np.flatnonzero(gens != unit._val_gen)
        burst = self.config.burst_size
        for start in range(0, stale.shape[0], burst):
            idx = stale[start:start + burst]
            rows = np.asarray(self.arena.gather_burst(
                [all_slots[int(i)] for i in idx]))
            for j, ii in enumerate(idx):
                i = int(ii)
                try:
                    self._parse_block(int(m.codec_ids[i]),
                                      rows[j, :int(m.comp_len[i])],
                                      int(m.raw_len[i]))
                    unit._val_status[i] = 0
                except StatusError as e:
                    unit._val_status[i] = e.status.to_int()
        unit._val_gen = gens
        bad = unit._val_status < 0
        status[bad] = unit._val_status[bad]

    def _decompress_host(self, unit: CompressedUnit, out: np.ndarray
                         ) -> np.ndarray:
        """Host codec path (``use_device_kernels=False``): the native
        multithreaded decoders, the engine's independent reference."""
        m = unit.manifest
        comp = unit.to_host()
        caps = m.raw_len.astype(np.int32)
        dst_len, status = registry.host_decompress_batch(
            self.config.codec, comp.packed, m.comp_off, m.comp_len,
            out, m.raw_off, caps, codec_ids=m.codec_ids)
        status = status.copy()
        status[(status == 0) & (dst_len != m.raw_len)] = _IO_ERROR
        self.stats.host_decode_bursts += 1
        self.stats.enqueued_blocks += m.nblocks
        self.stats.dequeued_blocks += m.nblocks
        return status

    # ------------------------------------------------------------------
    def import_unit(self, cb: CompressedBuffers) -> CompressedUnit:
        """Stage foreign compressed data (standard LZ4/Snappy/Zstd blocks)
        into the arena; the decode sidecar is built at first decode."""
        self._entry_guard()
        m = cb.manifest
        if m.block_size != self.config.block_size:
            raise StatusError(Status.Invalid(
                f"container block_size {m.block_size} != engine "
                f"block_size {self.config.block_size}; create the engine "
                f"with the container's block size"))
        if int(m.comp_len.max(initial=0)) > self.config.slot_size:
            raise StatusError(Status.CapacityError(
                f"block of {int(m.comp_len.max())}B exceeds slot "
                f"{self.config.slot_size}B"))
        n = m.nblocks
        staging_buf = get_memory_pool(PoolBackend.ALIGNED).allocate(
            n * self.config.slot_size)
        staging = staging_buf.view().reshape(n, self.config.slot_size)
        for i in range(n):
            o, ln = int(m.comp_off[i]), int(m.comp_len[i])
            staging[i, :ln] = cb.packed[o:o + ln]
            staging[i, ln:] = 0
        refs = self.arena.take_refs(
            [int(x) for x in m.comp_len], [int(c) for c in m.codec_ids])
        for start in range(0, n, self.config.burst_size):
            stop = min(n, start + self.config.burst_size)
            self.arena.write_burst([r.slot for r in refs[start:stop]],
                                   self._put(staging[start:stop]))
        return CompressedUnit(manifest=m, refs=refs, engine=self,
                              _staging=staging, _staging_buf=staging_buf)

    def _staging_rows(self, unit: CompressedUnit) -> np.ndarray:
        """Host view of the unit's slot rows (cached copy or arena gather)."""
        if unit._staging is not None:
            return unit._staging
        return np.asarray(self.arena.gather_burst([r.slot for r in unit.refs]))

    def recycle(self, unit: CompressedUnit) -> int:
        """Return a unit's arena slots; returns the recycled count
        (reference ``Recycle``, ``device.cc:321-327``)."""
        self._entry_guard()
        unit._check_live()
        count = self.arena.recycle(unit.refs)
        unit._drop_staging()
        unit._bursts = None
        unit.recycled = True
        return count


def prepare_batched_decode(items):
    """Merge several units' decodes into ONE dispatch.

    ``items``: list of ``(engine, unit)`` pairs — possibly different
    engines (mixed codecs) on one device, same ``block_size``.  Returns
    ``(launch, slices)``: ``launch()`` dispatches a single executor run
    over EVERY unit's blocks and returns ``[total_blocks, block_size]``
    uint8 device rows; ``slices[i]`` is unit i's ``(start, stop)`` row
    range.

    One device adds throughput for many streams by making the batch
    bigger: N streams' blocks share one launch and its fixed dispatch
    cost, where the reference gives each stream its own queue pair +
    lcore (``demo_app.cc:548-693``)."""
    if not items:
        raise StatusError(Status.Invalid("prepare_batched_decode: no units"))
    eng0 = items[0][0]
    block_size, slot = eng0.config.block_size, 0
    for eng, unit in items:
        if eng.config.block_size != block_size:
            raise StatusError(Status.Invalid(
                "prepare_batched_decode: mixed block sizes"))
        eng._entry_guard()
        unit._check_live()
        eng.ensure_tables(unit)
        eng._check_tables(unit)
        slot = max(slot, eng.config.slot_size)

    cap = max(u.tables[TABLE_KEYS[0]].shape[1] for _, u in items)
    cols = {k: [] for k in TABLE_KEYS}
    nseq, rows, lits, slices = [], [], {}, []
    start = 0
    for eng, unit in items:
        for k in TABLE_KEYS:
            t = unit.tables[k]
            cols[k].append(np.pad(t, ((0, 0), (0, cap - t.shape[1]))))
        nseq.append(unit.nseq)
        r = eng.arena.gather_burst([x.slot for x in unit.refs])
        if r.shape[1] < slot:
            r = jnp.pad(r, ((0, 0), (0, slot - r.shape[1])))
        rows.append(eng0._put(r))
        lits.update({start + j: row for j, row in unit.lit_rows.items()})
        slices.append((start, start + unit.nblocks))
        start += unit.nblocks

    tables = {k: np.concatenate(v) for k, v in cols.items()}
    b = eng0._stage(tables, np.concatenate(nseq), lits, 0, start, [], start,
                    width=slot)
    all_rows = jnp.concatenate(rows, axis=0)
    return (lambda: eng0._launch(b, all_rows)), slices
