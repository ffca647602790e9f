// LZ4 block-format codec, written from scratch against the public format
// spec (https://github.com/lz4/lz4/blob/dev/doc/lz4_Block_format.md).
//
// Role in the engine: host-side oracle + ingest path + sequence-table
// extractor for the device decode executor.  The reference accesses a
// hardware DEFLATE engine instead (bitar src/device.cc); this library is the
// "software PMD" the reference never had (survey §4).

#include "bitar_host.h"

#include <cstring>

namespace {

constexpr int kHashLog = 14;
constexpr int kHashSize = 1 << kHashLog;
constexpr int kMinMatch = 4;

// Encoder end-of-block rules from the format spec: the last 5 bytes are
// always literals; the last match must start at least 12 bytes before the
// end of the block.
constexpr int kMfLimitDist = 12;
constexpr int kLastLiterals = 5;
// Miss-skip acceleration: after 2^kSkipTrigger consecutive hash misses the
// scan step grows by one, so incompressible regions cost O(n / step) probes
// instead of one probe per byte (the standard greedy-LZ trick; without it
// random data crawls at ~30 MB/s while text runs at ~400 MB/s).
constexpr int kSkipTrigger = 6;

inline uint32_t Read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint32_t Hash4(uint32_t v) { return (v * 2654435761u) >> (32 - kHashLog); }

// Emits one sequence (token, literals, offset, matchlen).  A negative
// `mlen` means the final literals-only sequence.  Returns new dst cursor or
// negative status.
inline int EmitSequence(uint8_t* dst, int cap, int d, const uint8_t* lits,
                        int lit_len, int offset, int mlen) {
  const int token_pos = d++;
  if (d > cap) return BT_ERR_CAPACITY;
  int token_lit;
  if (lit_len >= 15) {
    token_lit = 15;
    int rest = lit_len - 15;
    while (rest >= 255) {
      if (d >= cap) return BT_ERR_CAPACITY;
      dst[d++] = 255;
      rest -= 255;
    }
    if (d >= cap) return BT_ERR_CAPACITY;
    dst[d++] = static_cast<uint8_t>(rest);
  } else {
    token_lit = lit_len;
  }
  if (d + lit_len > cap) return BT_ERR_CAPACITY;
  std::memcpy(dst + d, lits, static_cast<size_t>(lit_len));
  d += lit_len;

  if (mlen < 0) {  // final sequence: literals only, no offset
    dst[token_pos] = static_cast<uint8_t>(token_lit << 4);
    return d;
  }

  if (d + 2 > cap) return BT_ERR_CAPACITY;
  dst[d++] = static_cast<uint8_t>(offset & 0xFF);
  dst[d++] = static_cast<uint8_t>(offset >> 8);
  int ml = mlen - kMinMatch;
  int token_m;
  if (ml >= 15) {
    token_m = 15;
    int rest = ml - 15;
    while (rest >= 255) {
      if (d >= cap) return BT_ERR_CAPACITY;
      dst[d++] = 255;
      rest -= 255;
    }
    if (d >= cap) return BT_ERR_CAPACITY;
    dst[d++] = static_cast<uint8_t>(rest);
  } else {
    token_m = ml;
  }
  dst[token_pos] = static_cast<uint8_t>((token_lit << 4) | token_m);
  return d;
}

}  // namespace

// min_match: smallest match length the encoder emits (>= kMinMatch).
// Wire-compatible with any LZ4 decoder; larger values skip marginal
// matches (4-byte hash hits on barely-compressible data cost ~1 byte of
// ratio each but add one sequence-table row per match for the device
// decoder).
extern "C" int bt_lz4_compress_mm(const uint8_t* src, int src_len,
                                  uint8_t* dst, int dst_cap, int min_match) {
  if (src_len < 0 || dst_cap < 0 || (src == nullptr && src_len > 0) ||
      dst == nullptr || min_match < kMinMatch) {
    return BT_ERR_INVALID;
  }
  int32_t table[kHashSize];
  std::memset(table, 0xFF, sizeof(table));  // all -1

  const int mflimit = src_len - kMfLimitDist;
  const int matchlimit = src_len - kLastLiterals;
  int i = 0;
  int anchor = 0;
  int d = 0;

  int misses = 0;
  while (i < mflimit) {
    const uint32_t seq = Read32(src + i);
    const uint32_t h = Hash4(seq);
    const int cand = table[h];
    table[h] = i;
    if (cand < 0 || (i - cand) > 65535 || Read32(src + cand) != seq) {
      i += 1 + (misses++ >> kSkipTrigger);
      continue;
    }
    // Extend forward (match may end no later than matchlimit).
    int mlen = kMinMatch;
    while (i + mlen < matchlimit && src[cand + mlen] == src[i + mlen]) ++mlen;
    // Extend backward over pending literals (offset is unchanged).
    int mstart = i;
    int cstart = cand;
    while (mstart > anchor && cstart > 0 && src[mstart - 1] == src[cstart - 1]) {
      --mstart;
      --cstart;
      ++mlen;
    }
    if (mlen < min_match) {            // marginal match: keep as literals
      i += 1 + (misses++ >> kSkipTrigger);
      continue;
    }
    misses = 0;
    d = EmitSequence(dst, dst_cap, d, src + anchor, mstart - anchor,
                     mstart - cstart, mlen);
    if (d < 0) return d;
    i = mstart + mlen;
    anchor = i;
  }
  // Final literals.
  d = EmitSequence(dst, dst_cap, d, src + anchor, src_len - anchor, 0, -1);
  return d;
}

extern "C" int bt_lz4_compress(const uint8_t* src, int src_len, uint8_t* dst,
                               int dst_cap) {
  return bt_lz4_compress_mm(src, src_len, dst, dst_cap, kMinMatch);
}

extern "C" int bt_lz4_decompress(const uint8_t* src, int src_len, uint8_t* dst,
                                 int dst_cap) {
  if (src_len <= 0 || dst_cap < 0 || src == nullptr || dst == nullptr) {
    return BT_ERR_INVALID;
  }
  int s = 0;
  int d = 0;
  while (s < src_len) {
    const uint8_t token = src[s++];
    int lit_len = token >> 4;
    if (lit_len == 15) {
      while (s < src_len && src[s] == 255) {
        lit_len += 255;
        ++s;
      }
      if (s >= src_len) return BT_ERR_IO;
      lit_len += src[s++];
    }
    if (s + lit_len > src_len) return BT_ERR_IO;
    if (d + lit_len > dst_cap) return BT_ERR_CAPACITY;
    std::memcpy(dst + d, src + s, static_cast<size_t>(lit_len));
    d += lit_len;
    s += lit_len;
    if (s >= src_len) break;  // final literals-only sequence

    if (s + 2 > src_len) return BT_ERR_IO;
    const int offset = src[s] | (src[s + 1] << 8);
    s += 2;
    if (offset == 0 || offset > d) return BT_ERR_IO;
    int mlen = token & 0x0F;
    if (mlen == 15) {
      while (s < src_len && src[s] == 255) {
        mlen += 255;
        ++s;
      }
      if (s >= src_len) return BT_ERR_IO;
      mlen += src[s++];
    }
    mlen += kMinMatch;
    if (d + mlen > dst_cap) return BT_ERR_CAPACITY;
    if (offset >= 8) {
      // Wild-copy in 8-byte strides (no overlap hazard within a stride).
      int k = 0;
      for (; k + 8 <= mlen; k += 8) std::memcpy(dst + d + k, dst + d - offset + k, 8);
      for (; k < mlen; ++k) dst[d + k] = dst[d - offset + k];
    } else {
      for (int k = 0; k < mlen; ++k) dst[d + k] = dst[d - offset + k];
    }
    d += mlen;
  }
  return d;
}

extern "C" int bt_lz4_parse(const uint8_t* src, int src_len, int max_seq,
                            int32_t* lit_ptr, int32_t* lit_len_out,
                            int32_t* off_out, int32_t* mlen_out,
                            int32_t* out_pos) {
  if (src_len <= 0 || src == nullptr) return BT_ERR_INVALID;
  int s = 0;
  int d = 0;
  int n = 0;
  while (s < src_len) {
    const uint8_t token = src[s++];
    int lit_len = token >> 4;
    if (lit_len == 15) {
      while (s < src_len && src[s] == 255) {
        lit_len += 255;
        ++s;
      }
      if (s >= src_len) return BT_ERR_IO;
      lit_len += src[s++];
    }
    if (s + lit_len > src_len) return BT_ERR_IO;
    if (n >= max_seq) return BT_ERR_CAPACITY;
    lit_ptr[n] = s;
    lit_len_out[n] = lit_len;
    out_pos[n] = d;
    d += lit_len;
    s += lit_len;
    if (s >= src_len) {  // final sequence
      off_out[n] = 0;
      mlen_out[n] = 0;
      ++n;
      return n;
    }
    if (s + 2 > src_len) return BT_ERR_IO;
    const int offset = src[s] | (src[s + 1] << 8);
    s += 2;
    if (offset == 0 || offset > d) return BT_ERR_IO;
    int mlen = token & 0x0F;
    if (mlen == 15) {
      while (s < src_len && src[s] == 255) {
        mlen += 255;
        ++s;
      }
      if (s >= src_len) return BT_ERR_IO;
      mlen += src[s++];
    }
    mlen += kMinMatch;
    off_out[n] = offset;
    mlen_out[n] = mlen;
    d += mlen;
    ++n;
  }
  // Stream ended exactly after a match (no final literal run) — legal for
  // decoders to accept even though encoders never produce it.
  return n;
}
