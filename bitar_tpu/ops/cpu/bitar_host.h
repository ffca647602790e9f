/* C ABI of the bitar-tpu native host codec library.
 *
 * The engine's host-side runtime: reference CPU codecs used as
 * (a) the bit-exactness oracle for the device decoder, (b) the
 * multithreaded host ingest/verify path, and (c) the sequence-table
 * extractor feeding the device decode executor.
 *
 * Error convention matches bitar_tpu.status: >= 0 on success (byte count),
 * negative arrow-style StatusCode on failure (reference encodes the same
 * way in src/include/util.h:157-175).
 */
#ifndef BITAR_HOST_H_
#define BITAR_HOST_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* StatusCode bridge values (negated on return). */
enum {
  BT_OK = 0,
  BT_ERR_OOM = -1,
  BT_ERR_INVALID = -4,
  BT_ERR_IO = -5,
  BT_ERR_CAPACITY = -6,
  BT_ERR_INDEX = -7,
  BT_ERR_NOT_IMPLEMENTED = -10,
};

/* Codec ids shared with bitar_tpu.manifest. */
enum { BT_CODEC_LZ4 = 0, BT_CODEC_SNAPPY = 1, BT_CODEC_ZSTD = 2, BT_CODEC_RAW = 3 };

/* ---- LZ4 block format (no frame) ---------------------------------- */

/* Greedy LZ4 block compress; returns compressed length or negative code. */
int bt_lz4_compress(const uint8_t* src, int src_len, uint8_t* dst, int dst_cap);

/* As bt_lz4_compress with a minimum emitted match length (>= 4).  Larger
 * values keep marginal matches as literals: the stream stays LZ4
 * wire-compatible and barely grows, while the device decoder's sequence
 * tables shrink on barely-compressible data (each tiny match costs one
 * more sequence-table row). */
int bt_lz4_compress_mm(const uint8_t* src, int src_len, uint8_t* dst,
                       int dst_cap, int min_match);

/* LZ4 block decompress; returns decompressed length or negative code. */
int bt_lz4_decompress(const uint8_t* src, int src_len, uint8_t* dst, int dst_cap);

/* Parse an LZ4 block into a sequence table (SoA). For sequence s:
 *   lit_ptr[s]  byte offset in src of the first literal byte
 *   lit_len[s]  number of literal bytes
 *   off[s]      match offset (0 for the final literals-only sequence)
 *   mlen[s]     match length (0 for the final sequence)
 *   out_pos[s]  output position where the literals of s land
 * Returns the number of sequences, or negative code (BT_ERR_CAPACITY if
 * more than max_seq sequences). */
int bt_lz4_parse(const uint8_t* src, int src_len, int max_seq,
                 int32_t* lit_ptr, int32_t* lit_len, int32_t* off,
                 int32_t* mlen, int32_t* out_pos);

/* ---- Snappy raw format -------------------------------------------- */

int bt_snappy_compress(const uint8_t* src, int src_len, uint8_t* dst, int dst_cap);

/* As bt_snappy_compress with a minimum emitted match length (>= 4; see
 * bt_lz4_compress_mm for the decode-cost rationale). */
int bt_snappy_compress_mm(const uint8_t* src, int src_len, uint8_t* dst,
                          int dst_cap, int min_match);

int bt_snappy_decompress(const uint8_t* src, int src_len, uint8_t* dst, int dst_cap);
/* Decoded length from the preamble varint, or negative code. */
int bt_snappy_uncompressed_len(const uint8_t* src, int src_len);

/* Parse a Snappy body into the same SoA sequence-table shape as LZ4
 * (literal run + optional copy per row). */
int bt_snappy_parse(const uint8_t* src, int src_len, int max_seq,
                    int32_t* lit_ptr, int32_t* lit_len, int32_t* off,
                    int32_t* mlen, int32_t* out_pos);

/* ---- Zstandard (RFC 8878), from-scratch codec (zstd.cc) ------------ */

/* Compress into a standard single-segment zstd frame (greedy LZ matching,
 * raw literals, predefined-FSE sequence coding, per-block raw fallback).
 * Returns compressed length or negative code. */
int bt_zstd_compress(const uint8_t* src, int src_len, uint8_t* dst,
                     int dst_cap);

/* Decode a standard zstd frame; returns decompressed length or negative
 * code.  Dictionaries unsupported; frame checksums skipped (the engine's
 * manifest checksums cover content integrity). */
int bt_zstd_decompress(const uint8_t* src, int src_len, uint8_t* dst,
                       int dst_cap);

/* Parse a zstd frame into the SoA sequence-table shape.  Literals are
 * entropy-decoded into lit_buf (lit_ptr indexes THAT buffer, not src) —
 * the sidecar that lets zstd sequence execution run on the device.
 * Returns nseq or negative code; *lit_used receives the literal count. */
int bt_zstd_parse(const uint8_t* src, int src_len, int max_seq,
                  uint8_t* lit_buf, int lit_cap, int32_t* lit_used,
                  int32_t* lit_ptr, int32_t* lit_len, int32_t* off,
                  int32_t* mlen, int32_t* out_pos);

/* ---- Batched, multithreaded block APIs ----------------------------- *
 * The host analog of the reference's burst enqueue across worker lcores
 * (src/device.cc:465-535 + util.h:209-236): nblocks independent blocks,
 * dispatched over nthreads worker threads.
 *
 * dst_len[i] carries the per-block destination capacity on input and the
 * produced length on output.  status[i] receives 0 or a negative code.
 * codec may be BT_CODEC_LZ4 / BT_CODEC_SNAPPY / BT_CODEC_RAW; per-block
 * codec override via codec_ids (may be NULL -> use `codec` for all).
 */
/* min_match: smallest match length the LZ4/Snappy encoders emit
 * (clamped to >= 4; other codecs ignore it — see bt_lz4_compress_mm). */
void bt_batch_compress(int codec, const int32_t* codec_ids, int nthreads,
                       int nblocks, const uint8_t* src, const int64_t* src_off,
                       const int32_t* src_len, uint8_t* dst,
                       const int64_t* dst_off, int32_t* dst_len,
                       int32_t* status, int min_match);

void bt_batch_decompress(int codec, const int32_t* codec_ids, int nthreads,
                         int nblocks, const uint8_t* src, const int64_t* src_off,
                         const int32_t* src_len, uint8_t* dst,
                         const int64_t* dst_off, int32_t* dst_len,
                         int32_t* status);

/* Library version for the ctypes loader to sanity-check. */
int bt_abi_version(void);

#ifdef __cplusplus
}
#endif

#endif /* BITAR_HOST_H_ */
