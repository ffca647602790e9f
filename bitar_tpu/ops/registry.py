"""Host codec entry points: one batch API over the native library.

The analog of the reference's capability table: the hardware advertises
DEFLATE via ``rte_compressdev_info`` and the device validates against it
(``device.cc:353-415``).  Here every codec — LZ4, Snappy, Zstd (the
from-scratch RFC 8878 codec in ``ops/cpu/zstd.cc``, fuzz-validated against
the zstandard module) and RAW — runs both ways inside the multithreaded
C++ batch engine, and every codec except RAW parses to the sequence-table
shape the device decoder executes (``ops/decode.py``).
"""

from __future__ import annotations

import numpy as np

from ..config import Codec, compress_bound
from .cpu import native


# ---------------------------------------------------------------------------
# Host batch entry points (route native vs python-module codecs)


def host_compress_batch(codec: Codec, level: int, src: np.ndarray,
                        src_off: np.ndarray, src_len: np.ndarray,
                        dst: np.ndarray, dst_off: np.ndarray,
                        dst_cap: np.ndarray, nthreads: int = 0,
                        codec_ids: np.ndarray | None = None,
                        min_match: int = 4
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Compress a batch of blocks on the host; returns (lengths, statuses).

    All codecs (zstd included) run in the multithreaded C++ batch engine;
    ``level`` is accepted for API parity (the native zstd encoder is a
    single greedy strategy, the analog of module level 1).
    ``min_match``: smallest match length the LZ4/Snappy encoders emit —
    the decode-cost lever (EngineConfig.min_match).
    """
    del level  # single native strategy; kept for call-site compatibility
    if codec_ids is None:
        codec_ids = np.full(src_len.shape[0], _codec_int(codec), dtype=np.int32)
    dst_len, status = native.batch_run(
        True, "lz4", src, src_off, src_len, dst, dst_off, dst_cap,
        nthreads=nthreads, codec_ids=codec_ids, min_match=min_match)
    return dst_len, status


def host_decompress_batch(codec: Codec, src: np.ndarray, src_off: np.ndarray,
                          src_len: np.ndarray, dst: np.ndarray,
                          dst_off: np.ndarray, dst_cap: np.ndarray,
                          nthreads: int = 0,
                          codec_ids: np.ndarray | None = None
                          ) -> tuple[np.ndarray, np.ndarray]:
    if codec_ids is None:
        codec_ids = np.full(src_len.shape[0], _codec_int(codec), dtype=np.int32)
    # All codecs decompress natively (zstd included: ops/cpu/zstd.cc).
    dst_len, status = native.batch_run(
        False, "lz4", src, src_off, src_len, dst, dst_off, dst_cap,
        nthreads=nthreads, codec_ids=codec_ids)
    return dst_len, status


def _codec_int(codec: Codec) -> int:
    from ..manifest import codec_id
    return codec_id(codec)


def slot_bound(codec: Codec, block_size: int) -> int:
    return compress_bound(codec, block_size)
