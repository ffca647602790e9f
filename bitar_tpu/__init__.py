"""bitar-tpu: a block compression/decompression execution engine on JAX.

Capability-parity rebuild of ljishen/bitar (a DPU DEFLATE offload library):
block-level LZ4/Snappy/Zstd with explicit manifests, a device-memory slot
arena, sync + async streams, device-side decode on a GPU, and multi-device
sharding.  See ARCHITECTURE.md for the layer map.

Quick start::

    import bitar_tpu as bt

    engine = bt.Engine(bt.EngineConfig(codec=bt.Codec.LZ4)).initialize()
    unit = engine.compress(data)             # device-resident blocks
    out = engine.decompress(unit)            # bit-exact bytes
    engine.recycle(unit)                     # return arena slots
"""

from .config import (
    Checksum,
    Codec,
    DeviceCapabilities,
    EngineConfig,
    ShardingConfig,
    capabilities_for_platform,
    compress_bound,
)
from .engine.device import (CompressedUnit, Engine, EngineState,
                            EngineStats, prepare_batched_decode)
from .engine.driver import Driver
from .engine.stream import (
    ASYNC_RETURN_OK,
    CompressParam,
    DecompressParam,
    Stream,
    make_streams,
    wait_all,
)
from .manifest import BlockManifest, CompressedBuffers
from .memory.arena import ArenaStats, CompressedBlockRef, DeviceArena
from .memory.host_pool import HostMemoryPool, PoolBackend, get_memory_pool
from .status import Result, Status, StatusCode, StatusError

__version__ = "0.1.0"

__all__ = [
    "ASYNC_RETURN_OK",
    "ArenaStats",
    "BlockManifest",
    "Checksum",
    "Codec",
    "CompressedBlockRef",
    "CompressedBuffers",
    "CompressedUnit",
    "CompressParam",
    "DecompressParam",
    "DeviceArena",
    "DeviceCapabilities",
    "Driver",
    "Engine",
    "prepare_batched_decode",
    "EngineConfig",
    "EngineState",
    "EngineStats",
    "HostMemoryPool",
    "PoolBackend",
    "Result",
    "ShardingConfig",
    "Status",
    "StatusCode",
    "StatusError",
    "Stream",
    "capabilities_for_platform",
    "compress_bound",
    "get_memory_pool",
    "make_streams",
    "wait_all",
]
