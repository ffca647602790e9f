"""Engine configuration and capability validation.

The analog of the reference config layer (``src/include/config.h`` +
``src/config.cc``): one frozen dataclass of tuning knobs per *device class*,
validated against live device capabilities at engine initialization
(reference ``Configuration`` ``config.h:64-153``, ``ValidateConfiguration``
``device.cc:353-415``).

Knob mapping (reference -> here):

* ``burst_size``            -> ``burst_size``    (blocks per pipelined device step)
* ``decompressed_seg_size`` -> ``block_size``    (bytes of raw data per block)
* ``compressed_seg_size``   -> ``slot_size``     (derived; HBM arena slot bytes)
* ``max_sgl_segs``          -> gone: blocks are flat device-memory ranges,
                               scatter-gather chaining has no analog
* ``window_size``/``huffman_enc``/``checksum_type`` -> ``window_log``,
  ``level``, ``checksum`` (codec-level knobs)
* ``max_preallocate_memzones`` -> ``max_pool_slots`` (arena budget)

The compressed-slot sizing rule keeps the reference's worst-case math
(``config.cc:60-73``): slot = next power of two >= 2*block when that still
fits the class's slot ceiling, else ``ceil(1.1 * block)`` head-room for
incompressible data — additionally clamped up to the codec's true compress
bound so a slot can always hold a maximally-expanded block.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from dataclasses import dataclass, field

from .status import Status, StatusError


class Codec(enum.Enum):
    """Block codecs the engine speaks.

    The reference hardware path implements DEFLATE only
    (``RTE_COMP_ALGO_DEFLATE``, reference ``config.cc:87,96``); this engine
    generalizes to the block-level codec menu of this engine.
    """

    LZ4 = "lz4"          # LZ4 block format (raw, no frame)
    SNAPPY = "snappy"    # Snappy raw format
    ZSTD = "zstd"        # Zstandard frame
    RAW = "raw"          # stored/passthrough (incompressible fallback)


class Checksum(enum.Enum):
    """Optional integrity checksum recorded in the block manifest.

    Mirrors the reference's NONE/CRC32/ADLER32 menu
    (``config.h:169-177``).
    """

    NONE = "none"
    CRC32 = "crc32"
    ADLER32 = "adler32"


def next_power_of_two(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def lz4_compress_bound(n: int) -> int:
    """Worst-case LZ4 block output for n input bytes (spec formula)."""
    return n + n // 255 + 16


def snappy_compress_bound(n: int) -> int:
    """Worst-case Snappy output (format max expansion)."""
    return 32 + n + n // 6


def zstd_compress_bound(n: int) -> int:
    """Worst-case Zstandard frame size (ZSTD_compressBound formula)."""
    margin = (n >> 8) + (64 if n < (128 << 10) else 0)
    return n + margin + 12 + 8  # + frame header/footer head-room


_COMPRESS_BOUNDS = {
    Codec.LZ4: lz4_compress_bound,
    Codec.SNAPPY: snappy_compress_bound,
    Codec.ZSTD: zstd_compress_bound,
    Codec.RAW: lambda n: n + 8,
}


def compress_bound(codec: Codec, n: int) -> int:
    return _COMPRESS_BOUNDS[codec](n)


@dataclass(frozen=True, slots=True)
class DeviceCapabilities:
    """What a device class can do; checked at Engine.initialize.

    The analog of the queried ``rte_compressdev_info`` capability record the
    reference validates against (``device.cc:353-415``).
    """

    name: str
    codecs: tuple[Codec, ...]
    min_block_size: int          # reference kMinSegSize analog (config.h:41-48)
    max_block_size: int
    max_burst_size: int
    max_inflight_bursts: int     # reference kMaxInflightOps=512 analog (memory.h:50)
    hbm_budget_bytes: int        # arena ceiling
    supports_async: bool = True


_ALL_CODECS = (Codec.LZ4, Codec.SNAPPY, Codec.ZSTD, Codec.RAW)

# A CUDA GPU.  Blocks below 1 KiB are refused: per-block table and launch
# overheads would dominate their decode.  The arena ceiling is replaced at
# Engine.initialize by half of the device's own memory limit
# (``memory_stats()["bytes_limit"]``); the other half stays free for the
# decode executor's per-burst temporaries.
GPU = DeviceCapabilities(
    name="gpu",
    codecs=_ALL_CODECS,
    min_block_size=1 << 10,
    max_block_size=1 << 20,
    max_burst_size=4096,
    max_inflight_bursts=512,
    hbm_budget_bytes=8 << 30,
)

# The CPU backend: tests and host-only runs.
CPU = DeviceCapabilities(
    name="cpu",
    codecs=_ALL_CODECS,
    min_block_size=64,
    max_block_size=1 << 20,
    max_burst_size=4096,
    max_inflight_bursts=16,
    hbm_budget_bytes=4 << 30,
)

_PLATFORMS = {"gpu": GPU, "cpu": CPU}


def capabilities_for_platform(platform: str) -> DeviceCapabilities:
    """Map a jax device platform string to a capability record.

    The analog of the reference's PCI-id -> device-class dispatch
    (``driver.cc:75-98``, ``device.h:57-63``).  An unknown platform is an
    error, not a default.
    """
    caps = _PLATFORMS.get(platform.lower())
    if caps is None:
        raise StatusError(Status.NotImplemented(
            f"no device class for platform {platform!r} (supported: gpu, cpu)"))
    return caps


def capabilities_for_device(device) -> DeviceCapabilities:
    """The platform's record with the arena ceiling read from the device's
    own memory limit where it reports one."""
    caps = capabilities_for_platform(device.platform)
    stats = device.memory_stats() or {}
    if "bytes_limit" in stats:
        caps = dataclasses.replace(
            caps, hbm_budget_bytes=int(stats["bytes_limit"]) // 2)
    return caps


# Default knob values; reference defaults at config.h:146-152 (burst 32,
# seg 2048).  The headline benchmark config is 128 KiB blocks
# (BASELINE.json).
DEFAULT_BURST_SIZE = 32
DEFAULT_BLOCK_SIZE = 128 * 1024
MIN_POOL_SLOTS = 20              # reference kMinPreallocateMemzones (memory.h:51)


@dataclass(frozen=True, slots=True)
class EngineConfig:
    """Tuning knobs for one engine instance (one device).

    Frozen after validation, exactly like the reference configuration that
    is copied into the device at ``Initialize`` (``device.cc:115-154``).
    """

    codec: Codec = Codec.LZ4
    block_size: int = DEFAULT_BLOCK_SIZE
    burst_size: int = DEFAULT_BURST_SIZE
    level: int = 1                      # codec effort (zstd level; lz4/snappy ignore)
    min_match: int = 6                  # smallest LZ4/Snappy match emitted.
                                        # 4 = max ratio; the default 6 drops only
                                        # marginal hash-collision matches, so
                                        # barely-compressible blocks go
                                        # literal-only and carry far fewer
                                        # sequence-table rows to decode.
    window_log: int = 16                # match window log2; LZ4 format caps at 16
    checksum: Checksum = Checksum.NONE
    max_pool_slots: int = 4096          # arena slot budget (memzone budget analog)
    use_device_kernels: bool = True     # False -> host (native C++) codec path
    commit: str = "eager"               # when compressed bytes reach the
                                        # device arena: "eager" (during
                                        # compress, pipelined with the
                                        # matcher) or "deferred" (at first
                                        # device decode / explicit commit).
                                        # Deferred is the reference
                                        # contract — Compress ends when
                                        # output sits in POOL memory
                                        # (device.cc:157-238); the DPU
                                        # DMAs host memzones on demand.

    # ------------------------------------------------------------------
    @property
    def slot_size(self) -> int:
        """Bytes per compressed-output arena slot (derived).

        Keeps the reference sizing rule (``config.cc:60-73``): prefer the
        next power of two >= 2*block; if that exceeds 4x the block (i.e. the
        rule would waste memory) fall back to 1.1x head-room.  Always at
        least the codec's true compress bound, rounded up to 128 bytes (so
        the arena's used-prefix uploads quantize to whole 128-byte rows).
        """
        pow2 = next_power_of_two(2 * self.block_size)
        candidate = pow2 if pow2 <= 4 * self.block_size else math.ceil(1.1 * self.block_size)
        bound = compress_bound(self.codec, self.block_size)
        return _round_up(max(candidate, bound), 128)

    def validate(self, caps: DeviceCapabilities) -> Status:
        """Validate knobs against device capabilities.

        Mirrors ``ValidateConfiguration`` (reference ``device.cc:353-415``):
        codec support, block-size bounds, burst bounds, pool budget floor,
        and window-size range.
        """
        if self.codec not in caps.codecs:
            return Status.Invalid(
                f"codec {self.codec.value} unsupported by device class {caps.name}")
        if not (caps.min_block_size <= self.block_size <= caps.max_block_size):
            return Status.Invalid(
                f"block_size {self.block_size} outside device range "
                f"[{caps.min_block_size}, {caps.max_block_size}]")
        if not (1 <= self.burst_size <= caps.max_burst_size):
            return Status.Invalid(
                f"burst_size {self.burst_size} outside [1, {caps.max_burst_size}]")
        if self.max_pool_slots < MIN_POOL_SLOTS:
            return Status.Invalid(
                f"max_pool_slots {self.max_pool_slots} < minimum {MIN_POOL_SLOTS} "
                f"(reference kMinPreallocateMemzones)")
        if self.max_pool_slots * self.slot_size > caps.hbm_budget_bytes:
            return Status.CapacityError(
                f"arena budget {self.max_pool_slots * self.slot_size} exceeds HBM "
                f"budget {caps.hbm_budget_bytes}")
        if self.codec == Codec.LZ4 and self.window_log > 16:
            return Status.Invalid("LZ4 window_log caps at 16 (64 KiB format window)")
        if not (8 <= self.window_log <= 27):
            return Status.Invalid(f"window_log {self.window_log} outside [8, 27]")
        if self.level < 0 or self.level > 22:
            return Status.Invalid(f"level {self.level} outside [0, 22]")
        if not (4 <= self.min_match <= 512):
            return Status.Invalid(f"min_match {self.min_match} outside [4, 512]")
        if self.commit not in ("eager", "deferred"):
            return Status.Invalid(
                f"commit {self.commit!r} not in (eager, deferred)")
        return Status.OK()

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass(frozen=True, slots=True)
class ShardingConfig:
    """Multi-chip / multi-host layout knobs (no reference analog: the
    reference is single-process, its only topology being the queue-pair ->
    lcore round-robin map, ``driver.cc:100-158``)."""

    data_axis: str = "blocks"
    mesh_shape: tuple[int, ...] = field(default_factory=tuple)  # () -> all devices, 1D
    skew_bucket_log: int = 2      # blocks binned by ceil(log2(size)) / this for shuffle balance
