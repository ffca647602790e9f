"""Device block decode: execute LZ77 sequence tables in plain XLA.

Decompression splits into a *parse* stage (compressed bytes -> sequence
table) and an *execute* stage (table -> output bytes).  Parsing is a
sequential byte walk and runs in the native host library
(``native.parse_sequences`` / ``native.zstd_parse``); execution runs here,
on the device, for every block of a burst at once.

LZ4, Snappy, Zstd and RAW blocks all lower to the same table shape, one row
per sequence::

    lit_ptr  index of the sequence's first literal in the block's source row
    lit_len  literal count
    off      match offset (distance back into the output)
    mlen     match length
    out_pos  output position of the sequence's first literal

The source row is the compressed block itself for LZ4/Snappy (literals are
stored verbatim), the stored bytes for RAW (one literal-only sequence), and
the host-entropy-decoded literal stream for Zstd.

Execution gives every output byte ``p`` exactly one source and resolves
match chains by pointer doubling:

1. ``seq[p]``: scatter each sequence id at its ``out_pos`` and take a
   running maximum along the block.
2. A literal byte points at source index ``lit_ptr + (p - out_pos)``; a
   match byte points at the earlier output byte ``p - off``.
3. A match byte whose target is itself a match byte inherits the target's
   pointer.  Each round doubles the distance followed, so after at most
   ``ceil(log2 block_size)`` rounds every byte points at a literal.
4. One gather from the source rows produces the output.

Nothing here depends on on-chip memory size, so any block size decodes.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

TABLE_KEYS = ("lit_ptr", "lit_len", "off", "mlen", "out_pos")


def table_capacity(nseq_max: int) -> int:
    """Padded sequence-table width: a power of two >= 128, so units of
    similar shape share one compiled executor."""
    return max(128, 1 << max(0, int(nseq_max) - 1).bit_length())


def pad_tables(tables: list[dict[str, np.ndarray]], cap: int | None = None
               ) -> tuple[dict[str, np.ndarray], np.ndarray]:
    """Stack per-block tables into ``{key: [n, cap] int32}`` + ``nseq [n]``.

    Rows past a block's ``nseq`` are zero and never executed."""
    nseq = np.array([t[TABLE_KEYS[0]].shape[0] for t in tables], np.int32)
    if cap is None:
        cap = table_capacity(int(nseq.max(initial=1)))
    out = {k: np.zeros((len(tables), cap), np.int32) for k in TABLE_KEYS}
    for i, t in enumerate(tables):
        m = int(nseq[i])
        for k in TABLE_KEYS:
            out[k][i, :m] = t[k]
    return out, nseq


def decode_blocks_ref(src: np.ndarray, tables: dict[str, np.ndarray],
                      nseq: np.ndarray, block_size: int) -> np.ndarray:
    """Sequential numpy executor of the same tables: the plain reference
    the device executor is checked against (byte-at-a-time copies, the
    way a scalar LZ77 decoder runs)."""
    n = src.shape[0]
    out = np.zeros((n, block_size), np.uint8)
    for i in range(n):
        row = out[i]
        for s in range(int(nseq[i])):
            p = int(tables["out_pos"][i, s])
            lp, ll = int(tables["lit_ptr"][i, s]), int(tables["lit_len"][i, s])
            row[p:p + ll] = src[i, lp:lp + ll]
            p += ll
            o = int(tables["off"][i, s])
            for j in range(int(tables["mlen"][i, s])):
                row[p + j] = row[p + j - o]
    return out


@functools.partial(jax.jit, static_argnames=("block_size",))
def decode_blocks(src, nseq, lit_ptr, lit_len, off, mlen, out_pos, *,
                  block_size: int):
    """Decode a batch of blocks on the device.

    Args:
      src:      [n, W] uint8 source rows (compressed bytes, or decoded
                literals for Zstd blocks)
      nseq:     [n] int32 live sequence count per block
      lit_ptr, lit_len, off, mlen, out_pos: [n, S] int32 tables
      block_size: output row width (static)

    Returns [n, block_size] uint8; bytes past a block's decoded length
    are zero.  Malformed tables (an offset reaching before the block, a
    literal past the source row) decode to unspecified bytes but always
    terminate; the engine validates framing on the host and reports such
    blocks in its per-block status.
    """
    n, cap = lit_ptr.shape
    width = src.shape[1]
    sid = jnp.arange(cap, dtype=jnp.int32)[None, :]
    live = sid < nseq[:, None]
    pos = jnp.arange(block_size, dtype=jnp.int32)[None, :]

    # 1. The sequence that owns each output byte.
    rows = jnp.arange(n, dtype=jnp.int32)[:, None]
    first = jnp.full((n, block_size), -1, jnp.int32).at[
        jnp.broadcast_to(rows, (n, cap)),
        jnp.where(live, out_pos, block_size)].max(
            jnp.broadcast_to(sid, (n, cap)), mode="drop")
    seq = lax.cummax(first, axis=1)
    take = functools.partial(jnp.take_along_axis, indices=jnp.maximum(seq, 0),
                             axis=1)
    end = jnp.max(jnp.where(live, out_pos + lit_len + mlen, 0), axis=1)
    inside = (seq >= 0) & (pos < end[:, None])

    # 2. One source per byte: ref >= 0 copies output byte ref, ref < 0 is
    # the literal at source index -1 - ref.
    rel = pos - take(out_pos)
    is_lit = rel < take(lit_len)
    back = pos - take(off)
    lit_ref = -1 - jnp.clip(take(lit_ptr) + rel, 0, width - 1)
    ok_match = (back >= 0) & (back < pos)
    ref = jnp.where(is_lit, lit_ref, jnp.where(ok_match, back, -1))
    ref = jnp.where(inside, ref, -1)

    # 3. Pointer doubling over match chains.
    max_rounds = max(1, math.ceil(math.log2(max(2, block_size))))

    def unresolved(state):
        r, k = state
        return jnp.any(r >= 0) & (k < max_rounds)

    def jump(state):
        r, k = state
        nxt = jnp.take_along_axis(r, jnp.maximum(r, 0), axis=1)
        return jnp.where(r >= 0, nxt, r), k + 1

    ref, _ = lax.while_loop(unresolved, jump, (ref, jnp.int32(0)))

    # 4. One gather from the source rows.
    out = jnp.take_along_axis(src, jnp.clip(-1 - ref, 0, width - 1), axis=1)
    return jnp.where(inside, out, jnp.uint8(0))
