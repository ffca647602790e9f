// Snappy raw-format codec, written from scratch against the public format
// description (https://github.com/google/snappy/blob/main/format_description.txt).
//
// Same role as lz4.cc: oracle, host path, and sequence-table extractor.

#include "bitar_host.h"

#include <cstring>

namespace {

constexpr int kHashLog = 14;
constexpr int kHashSize = 1 << kHashLog;
// Miss-skip acceleration (see lz4.cc): scan step grows after 2^6
// consecutive hash misses so incompressible input stays near memcpy speed.
constexpr int kSkipTrigger = 6;

inline uint32_t Read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint32_t Hash4(uint32_t v) { return (v * 2654435761u) >> (32 - kHashLog); }

// Writes the uncompressed-length preamble varint; returns new cursor or
// negative status.
int WriteVarint(uint8_t* dst, int cap, int d, uint32_t v) {
  while (v >= 0x80) {
    if (d >= cap) return BT_ERR_CAPACITY;
    dst[d++] = static_cast<uint8_t>(v | 0x80);
    v >>= 7;
  }
  if (d >= cap) return BT_ERR_CAPACITY;
  dst[d++] = static_cast<uint8_t>(v);
  return d;
}

// Reads the preamble varint into *out; returns bytes consumed or negative.
int ReadVarint(const uint8_t* src, int n, uint32_t* out) {
  uint32_t v = 0;
  int shift = 0;
  for (int i = 0; i < n && i < 5; ++i) {
    v |= static_cast<uint32_t>(src[i] & 0x7F) << shift;
    if (!(src[i] & 0x80)) {
      *out = v;
      return i + 1;
    }
    shift += 7;
  }
  return BT_ERR_IO;
}

int EmitLiteral(uint8_t* dst, int cap, int d, const uint8_t* lits, int len) {
  if (len <= 0) return d;
  const int n = len - 1;
  if (n < 60) {
    if (d >= cap) return BT_ERR_CAPACITY;
    dst[d++] = static_cast<uint8_t>(n << 2);
  } else {
    int extra = (n < (1 << 8)) ? 1 : (n < (1 << 16)) ? 2 : (n < (1 << 24)) ? 3 : 4;
    if (d + 1 + extra > cap) return BT_ERR_CAPACITY;
    dst[d++] = static_cast<uint8_t>((59 + extra) << 2);
    for (int k = 0; k < extra; ++k) dst[d++] = static_cast<uint8_t>((n >> (8 * k)) & 0xFF);
  }
  if (d + len > cap) return BT_ERR_CAPACITY;
  std::memcpy(dst + d, lits, static_cast<size_t>(len));
  return d + len;
}

// One copy element, 4 <= len <= 64, 1 <= offset <= 65535.
int EmitCopy(uint8_t* dst, int cap, int d, int offset, int len) {
  if (len >= 4 && len <= 11 && offset < 2048) {
    if (d + 2 > cap) return BT_ERR_CAPACITY;
    dst[d++] = static_cast<uint8_t>(1 | ((len - 4) << 2) | ((offset >> 8) << 5));
    dst[d++] = static_cast<uint8_t>(offset & 0xFF);
    return d;
  }
  if (d + 3 > cap) return BT_ERR_CAPACITY;
  dst[d++] = static_cast<uint8_t>(2 | ((len - 1) << 2));
  dst[d++] = static_cast<uint8_t>(offset & 0xFF);
  dst[d++] = static_cast<uint8_t>(offset >> 8);
  return d;
}

}  // namespace

// min_match: smallest match length emitted (>= 4; see bt_lz4_compress_mm
// for the decode-cost rationale).  Wire-compatible with any decoder.
extern "C" int bt_snappy_compress_mm(const uint8_t* src, int src_len,
                                     uint8_t* dst, int dst_cap,
                                     int min_match) {
  if (src_len < 0 || dst_cap < 0 || (src == nullptr && src_len > 0) ||
      dst == nullptr || min_match < 4) {
    return BT_ERR_INVALID;
  }
  int d = WriteVarint(dst, dst_cap, 0, static_cast<uint32_t>(src_len));
  if (d < 0) return d;

  int32_t table[kHashSize];
  std::memset(table, 0xFF, sizeof(table));

  int i = 0;
  int anchor = 0;
  const int limit = src_len - 4;  // last position where a 4-byte match fits
  int misses = 0;
  while (i <= limit) {
    const uint32_t seq = Read32(src + i);
    const uint32_t h = Hash4(seq);
    const int cand = table[h];
    table[h] = i;
    if (cand < 0 || (i - cand) > 65535 || Read32(src + cand) != seq) {
      i += 1 + (misses++ >> kSkipTrigger);
      continue;
    }
    int mlen = 4;
    while (i + mlen < src_len && src[cand + mlen] == src[i + mlen]) ++mlen;
    if (mlen < min_match) {            // marginal match: keep as literals
      i += 1 + (misses++ >> kSkipTrigger);
      continue;
    }
    misses = 0;
    const int offset = i - cand;
    d = EmitLiteral(dst, dst_cap, d, src + anchor, i - anchor);
    if (d < 0) return d;
    // Break long matches into <=64-byte copies, keeping the final >=4.
    int rem = mlen;
    while (rem > 64) {
      const int c = (rem - 64 < 4) ? 60 : 64;
      d = EmitCopy(dst, dst_cap, d, offset, c);
      if (d < 0) return d;
      rem -= c;
    }
    d = EmitCopy(dst, dst_cap, d, offset, rem);
    if (d < 0) return d;
    i += mlen;
    anchor = i;
  }
  d = EmitLiteral(dst, dst_cap, d, src + anchor, src_len - anchor);
  return d;
}

extern "C" int bt_snappy_compress(const uint8_t* src, int src_len,
                                  uint8_t* dst, int dst_cap) {
  return bt_snappy_compress_mm(src, src_len, dst, dst_cap, 4);
}

extern "C" int bt_snappy_uncompressed_len(const uint8_t* src, int src_len) {
  if (src == nullptr || src_len <= 0) return BT_ERR_INVALID;
  uint32_t v = 0;
  const int used = ReadVarint(src, src_len, &v);
  if (used < 0) return used;
  if (v > (1u << 30)) return BT_ERR_IO;
  return static_cast<int>(v);
}

namespace {

// Shared walk for decompress and parse.  When `dst` is non-null the data is
// materialized; when tables are non-null the element list is recorded in the
// LZ4-compatible SoA shape (literal row: mlen=0; copy row: lit_len=0).
int SnappyWalk(const uint8_t* src, int src_len, uint8_t* dst, int dst_cap,
               int max_seq, int32_t* lit_ptr, int32_t* lit_len_out,
               int32_t* off_out, int32_t* mlen_out, int32_t* out_pos,
               int* nseq_out) {
  uint32_t expect = 0;
  int s = ReadVarint(src, src_len, &expect);
  if (s < 0) return s;
  int d = 0;
  int n = 0;
  const bool record = lit_ptr != nullptr;
  while (s < src_len) {
    const uint8_t tag = src[s++];
    const int type = tag & 3;
    if (type == 0) {  // literal
      int len = (tag >> 2) + 1;
      if (len > 60) {
        const int extra = len - 60;
        if (s + extra > src_len) return BT_ERR_IO;
        // Accumulate in 64 bits: 4 extra bytes can encode up to 2^32-1,
        // which overflows (wraps negative) in int and would then slip
        // through the `s + len > src_len` guard below.
        int64_t wide = 0;
        for (int k = 0; k < extra; ++k) {
          wide |= static_cast<int64_t>(src[s + k]) << (8 * k);
        }
        wide += 1;
        if (wide <= 0 || wide > src_len) return BT_ERR_IO;
        len = static_cast<int>(wide);
        s += extra;
      }
      if (len <= 0 || s + len > src_len) return BT_ERR_IO;
      if (dst != nullptr) {
        if (d + len > dst_cap) return BT_ERR_CAPACITY;
        std::memcpy(dst + d, src + s, static_cast<size_t>(len));
      }
      if (record) {
        if (n >= max_seq) return BT_ERR_CAPACITY;
        lit_ptr[n] = s;
        lit_len_out[n] = len;
        off_out[n] = 0;
        mlen_out[n] = 0;
        out_pos[n] = d;
        ++n;
      }
      d += len;
      s += len;
      continue;
    }
    int len;
    int offset;
    if (type == 1) {
      if (s >= src_len) return BT_ERR_IO;
      len = ((tag >> 2) & 7) + 4;
      offset = ((tag >> 5) << 8) | src[s++];
    } else if (type == 2) {
      if (s + 2 > src_len) return BT_ERR_IO;
      len = (tag >> 2) + 1;
      offset = src[s] | (src[s + 1] << 8);
      s += 2;
    } else {
      if (s + 4 > src_len) return BT_ERR_IO;
      len = (tag >> 2) + 1;
      uint32_t o;
      std::memcpy(&o, src + s, 4);
      if (o > (1u << 30)) return BT_ERR_IO;
      offset = static_cast<int>(o);
      s += 4;
    }
    if (offset == 0 || offset > d) return BT_ERR_IO;
    if (dst != nullptr) {
      if (d + len > dst_cap) return BT_ERR_CAPACITY;
      if (offset >= 8) {
        int k = 0;
        for (; k + 8 <= len; k += 8) std::memcpy(dst + d + k, dst + d - offset + k, 8);
        for (; k < len; ++k) dst[d + k] = dst[d - offset + k];
      } else {
        for (int k = 0; k < len; ++k) dst[d + k] = dst[d - offset + k];
      }
    }
    if (record) {
      if (n >= max_seq) return BT_ERR_CAPACITY;
      lit_ptr[n] = 0;
      lit_len_out[n] = 0;
      off_out[n] = offset;
      mlen_out[n] = len;
      out_pos[n] = d;
      ++n;
    }
    d += len;
  }
  if (static_cast<uint32_t>(d) != expect) return BT_ERR_IO;
  if (nseq_out != nullptr) *nseq_out = n;
  return d;
}

}  // namespace

extern "C" int bt_snappy_decompress(const uint8_t* src, int src_len,
                                    uint8_t* dst, int dst_cap) {
  if (src == nullptr || dst == nullptr || src_len <= 0 || dst_cap < 0) {
    return BT_ERR_INVALID;
  }
  return SnappyWalk(src, src_len, dst, dst_cap, 0, nullptr, nullptr, nullptr,
                    nullptr, nullptr, nullptr);
}

extern "C" int bt_snappy_parse(const uint8_t* src, int src_len, int max_seq,
                               int32_t* lit_ptr, int32_t* lit_len,
                               int32_t* off, int32_t* mlen, int32_t* out_pos) {
  if (src == nullptr || src_len <= 0) return BT_ERR_INVALID;
  int n = 0;
  const int rc = SnappyWalk(src, src_len, nullptr, 0, max_seq, lit_ptr, lit_len,
                            off, mlen, out_pos, &n);
  if (rc < 0) return rc;
  return n;
}
