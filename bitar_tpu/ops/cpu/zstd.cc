// From-scratch Zstandard frame decoder (RFC 8878), C++17, no deps.
//
// Scope: single-segment decompression of standard zstd frames as produced
// by any compliant encoder (raw/RLE/compressed blocks; Huffman literals
// with FSE-compressed or direct weights, 1- and 4-stream; FSE sequence
// coding with predefined/RLE/compressed/repeat table modes; repeat
// offsets; multi-block frames with cross-block window references).
// Dictionaries are not supported (the engine compresses each block as an
// independent frame); frame checksums are skipped, content is instead
// verified by the engine's per-block manifest checksums.
//
// The walk is factored like SnappyWalk (snappy.cc): one pass that can
// (a) materialize output bytes and/or (b) record the LZ77 sequence table
// in the engine's SoA shape with literal pointers into a caller-provided
// DECODED-LITERALS buffer — the hook that lets zstd blocks ride the
// device sequence executor with literals sourced from a host-entropy-
// decoded stream (sequence execution is codec-agnostic).
//
// Reference for capability parity: bitar executes its codec on a foreign
// engine (DPU DEFLATE, src/device.cc:157-318); this library is the host
// member of this engine's codec set.

#include "bitar_host.h"

#include <algorithm>
#include <cmath>
#include <cstring>
#include <cstdio>
#include <vector>

namespace {

// ---------------------------------------------------------------------
// Backward bit reader: zstd entropy payloads are written forward but read
// from the END; the final byte carries a 1-bit terminator at its highest
// set bit position.
struct BackBits {
  const uint8_t* base = nullptr;
  int64_t bitpos = 0;  // bits remaining below the cursor

  // Returns false on malformed stream (empty or zero last byte).
  bool Init(const uint8_t* p, int len) {
    if (len <= 0) return false;
    base = p;
    const uint8_t last = p[len - 1];
    if (last == 0) return false;
    int top = 7;
    while (!(last & (1 << top))) --top;
    bitpos = static_cast<int64_t>(len - 1) * 8 + top;
    return true;
  }

  // Read n bits (0..32) below the cursor, moving down.  Reads below bit 0
  // return zero-padded values (the spec allows states to consume padding
  // at stream end; overrun is detected by the caller via Exhausted()).
  uint32_t Read(int n) {
    if (n == 0) return 0;
    bitpos -= n;
    if (bitpos + n <= 0) return 0;        // fully below the stream: padding
    const int64_t lo = bitpos < 0 ? 0 : bitpos;
    // Gather bits [lo, bitpos + n) little-endian-from-bottom.
    uint64_t acc = 0;
    const int64_t byte0 = lo >> 3;
    for (int k = 0; k < 8; ++k) {
      const int64_t b = byte0 + k;
      if (b * 8 >= bitpos + n) break;
      acc |= static_cast<uint64_t>(base[b]) << (8 * k);
    }
    acc >>= (lo & 7);
    uint32_t v = static_cast<uint32_t>(acc & ((n >= 32 ? ~0u : ((1u << n) - 1))));
    if (bitpos < 0) v <<= 0;  // low zero-padding is implicit (acc shifted)
    if (bitpos < 0) {
      // Bits below zero read as 0: shift value up by the underrun amount.
      v = static_cast<uint32_t>((acc & ((1ull << (n + bitpos)) - 1))
                                << (-bitpos));
    }
    return v;
  }

  bool Exhausted() const { return bitpos < 0; }
};

// ---------------------------------------------------------------------
// FSE decoding table.
struct FseEntry {
  uint8_t symbol;
  uint8_t nbits;
  uint16_t base;
};

struct FseTable {
  int accuracy = 0;  // log2(size)
  std::vector<FseEntry> t;

  // Build from normalized counts (sum 2^accuracy; -1 = "less than one").
  bool Build(const int16_t* counts, int nsym, int accuracy_log) {
    if (accuracy_log < 0 || accuracy_log > 12) return false;
    accuracy = accuracy_log;
    const int size = 1 << accuracy_log;
    t.assign(size, FseEntry{0, 0, 0});
    std::vector<int> next(nsym);

    int hi = size - 1;
    for (int s = 0; s < nsym; ++s) {
      if (counts[s] == -1) {
        t[hi--].symbol = static_cast<uint8_t>(s);
        next[s] = 1;
      }
    }
    const int step = (size >> 1) + (size >> 3) + 3;
    const int mask = size - 1;
    int pos = 0;
    for (int s = 0; s < nsym; ++s) {
      for (int c = 0; c < counts[s]; ++c) {
        t[pos].symbol = static_cast<uint8_t>(s);
        do {
          pos = (pos + step) & mask;
        } while (pos > hi);
      }
      if (counts[s] > 0) next[s] = counts[s];
    }
    if (pos != 0) return false;
    for (int i = 0; i < size; ++i) {
      const int s = t[i].symbol;
      const int n = next[s]++;
      const int nb = accuracy_log - (31 - __builtin_clz(static_cast<unsigned>(n)));
      t[i].nbits = static_cast<uint8_t>(nb);
      t[i].base = static_cast<uint16_t>((n << nb) - size);
    }
    return true;
  }
};

// Read an FSE table description (normalized counts) from a FORWARD
// little-endian bitstream (upstream FSE_readNCount algorithm).  Returns
// bytes consumed, or -1.
int ReadFseDescription(const uint8_t* p, int len, int max_accuracy,
                       int max_sym, FseTable* out) {
  if (len < 1) return -1;
  int bitpos = 0;
  auto peek = [&](int n) -> uint32_t {
    uint64_t acc = 0;
    const int byte0 = bitpos >> 3;
    for (int k = 0; k < 8 && byte0 + k < len; ++k) {
      acc |= static_cast<uint64_t>(p[byte0 + k]) << (8 * k);
    }
    acc >>= (bitpos & 7);
    return static_cast<uint32_t>(acc & ((n >= 32 ? ~0u : ((1u << n) - 1))));
  };

  const int accuracy = static_cast<int>(peek(4)) + 5;
  bitpos += 4;
  if (accuracy > max_accuracy) return -1;
  const int size = 1 << accuracy;
  int remaining = size + 1;
  int threshold = size;
  int nb_bits = accuracy + 1;
  std::vector<int16_t> counts;
  bool prev_zero = false;
  while (remaining > 1 && static_cast<int>(counts.size()) <= max_sym) {
    if (prev_zero) {
      const uint32_t rep = peek(2);
      bitpos += 2;
      for (uint32_t r = 0; r < rep; ++r) counts.push_back(0);
      if (rep == 3) continue;
      prev_zero = false;
      continue;
    }
    const int max = (2 * threshold - 1) - remaining;
    const uint32_t bits = peek(nb_bits);
    int count;
    if (static_cast<int>(bits & (threshold - 1)) < max) {
      count = static_cast<int>(bits & (threshold - 1));
      bitpos += nb_bits - 1;
    } else {
      count = static_cast<int>(bits & (2 * threshold - 1));
      if (count >= threshold) count -= max;
      bitpos += nb_bits;
    }
    --count;                                   // -1 = "less than 1"
    remaining -= count < 0 ? -count : count;
    counts.push_back(static_cast<int16_t>(count));
    if (count == 0) prev_zero = true;
    while (remaining < threshold && remaining > 1) {
      --nb_bits;
      threshold >>= 1;
    }
    if ((bitpos + 7) / 8 > len) return -1;
  }
  if (remaining != 1 || static_cast<int>(counts.size()) > max_sym + 1) {
    return -1;
  }
  while (static_cast<int>(counts.size()) <= max_sym) counts.push_back(0);
  if (!out->Build(counts.data(), static_cast<int>(counts.size()), accuracy)) {
    return -1;
  }
  return (bitpos + 7) / 8;
}

// ---------------------------------------------------------------------
// Huffman decoding (single-level table).
struct HufTable {
  int max_bits = 0;
  std::vector<uint8_t> sym;    // 2^max_bits entries
  std::vector<uint8_t> len;

  bool BuildFromWeights(const uint8_t* w, int nw) {
    // weights: symbol s has weight w[s]; the LAST symbol's weight is
    // implied.  nbBits = maxBits + 1 - weight (weight > 0).
    uint64_t total = 0;
    for (int s = 0; s < nw; ++s) {
      if (w[s] > 11) return false;
      if (w[s]) total += 1ull << (w[s] - 1);
    }
    if (total == 0) return false;
    // max_bits = highest_set_bit(total) + 1; the leftover to the next
    // power of two is the implied last symbol's weight share and must
    // itself be a power of two.
    const int max_w = (63 - __builtin_clzll(total)) + 1;
    const uint64_t left = (1ull << max_w) - total;
    if (left == 0 || (left & (left - 1))) return false;
    const int last_w = (63 - __builtin_clzll(left)) + 1;
    std::vector<uint8_t> weights(w, w + nw);
    weights.push_back(static_cast<uint8_t>(last_w));
    max_bits = max_w;
    if (max_bits > 11 || max_bits < 1) return false;
    const int size = 1 << max_bits;
    sym.assign(size, 0);
    len.assign(size, 0);
    // canonical: ranked by weight ascending, codes assigned from 0 up.
    int pos = 0;
    for (int weight = 1; weight <= max_bits; ++weight) {
      const int nbits = max_bits + 1 - weight;
      const int span = 1 << (weight - 1);
      for (int s = 0; s < static_cast<int>(weights.size()); ++s) {
        if (weights[s] != weight) continue;
        for (int k = 0; k < span; ++k) {
          sym[pos] = static_cast<uint8_t>(s);
          len[pos] = static_cast<uint8_t>(nbits);
          ++pos;
        }
      }
    }
    return pos == size;
  }
};

// Read a Huffman tree description.  Returns bytes consumed or -1.
int ReadHufDescription(const uint8_t* p, int len, HufTable* out) {
  if (len < 1) return -1;
  const int hbyte = p[0];
  std::vector<uint8_t> weights;
  int used = 1;
  if (hbyte < 128) {
    // FSE-compressed weights: hbyte = compressed size.
    if (1 + hbyte > len) return -1;
    FseTable wt;
    const int fse_used = ReadFseDescription(p + 1, hbyte, 6, 255, &wt);
#ifdef DEBUG_ZSTD
    fprintf(stderr, "huf fse weights: hbyte=%d fse_used=%d acc=%d\n",
            hbyte, fse_used, wt.accuracy);
#endif
    if (fse_used < 0 || fse_used > hbyte) return -1;
    BackBits bb;
    if (!bb.Init(p + 1 + fse_used, hbyte - fse_used)) return -1;
    uint32_t s0 = bb.Read(wt.accuracy);
    uint32_t s1 = bb.Read(wt.accuracy);
    // Canonical interleaved 2-state FSE decompression: emit + update each
    // state in turn; when an update runs past the stream start, flush the
    // OTHER state's final symbol and stop.
    for (;;) {
      weights.push_back(wt.t[s0].symbol);
      s0 = wt.t[s0].base + bb.Read(wt.t[s0].nbits);
      if (bb.bitpos < 0) {
        weights.push_back(wt.t[s1].symbol);
        break;
      }
      weights.push_back(wt.t[s1].symbol);
      s1 = wt.t[s1].base + bb.Read(wt.t[s1].nbits);
      if (bb.bitpos < 0) {
        weights.push_back(wt.t[s0].symbol);
        break;
      }
      if (weights.size() > 255) return -1;
    }
    used += hbyte;
  } else {
    // Direct 4-bit weights for hbyte-127 symbols.
    const int nw = hbyte - 127;
    const int nbytes = (nw + 1) / 2;
    if (1 + nbytes > len) return -1;
    for (int i = 0; i < nw; ++i) {
      const uint8_t b = p[1 + i / 2];
      weights.push_back(i % 2 == 0 ? (b >> 4) : (b & 0xF));
    }
    used += nbytes;
  }
  if (weights.size() > 255) return -1;
  const bool built = out->BuildFromWeights(
      weights.data(), static_cast<int>(weights.size()));
#ifdef DEBUG_ZSTD
  fprintf(stderr, "huf build: nweights=%zu built=%d\n", weights.size(), built);
#endif
  if (!built) return -1;
  return used;
}

// Decode one Huffman bitstream into dst (exactly want bytes).
bool HufDecodeStream(const HufTable& h, const uint8_t* p, int len,
                     uint8_t* dst, int want) {
  BackBits bb;
  if (!bb.Init(p, len)) return false;
  for (int i = 0; i < want; ++i) {
    // Peek max_bits (zero-padded at stream end per spec).
    const int64_t save = bb.bitpos;
    uint32_t idx = bb.Read(h.max_bits);
    const int nb = h.len[idx];
    dst[i] = h.sym[idx];
    bb.bitpos = save - nb;
    if (bb.bitpos < -h.max_bits) return false;
  }
  return true;
}

// ---------------------------------------------------------------------
// Sequence code tables (RFC 8878 §3.1.1.3.2.1).
constexpr uint32_t kLLBase[36] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15,
    16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048,
    4096, 8192, 16384, 32768, 65536};
constexpr uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                                 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37, 39, 41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195,
    16387, 32771, 65539};
constexpr uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                                 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

constexpr int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                    2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                    2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
constexpr int16_t kMLDefault[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    -1, -1, -1, -1, -1, -1, -1};
constexpr int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2,  2,  2,  1,
                                    1, 1, 1, 1, 1, 1, 1,  1,  1,  1,
                                    1, 1, 1, 1, -1, -1, -1, -1, -1};

struct FrameState {
  HufTable huf;        // persists for treeless literal blocks
  bool huf_valid = false;
  FseTable ll, of, ml;
  bool ll_valid = false, of_valid = false, ml_valid = false;
  uint32_t rep[3] = {1, 4, 8};
};

// Recorder for the SoA sequence table (optional).
struct SeqRecorder {
  int32_t* lit_ptr = nullptr;
  int32_t* lit_len = nullptr;
  int32_t* off = nullptr;
  int32_t* mlen = nullptr;
  int32_t* out_pos = nullptr;
  uint8_t* lit_buf = nullptr;   // decoded literals land here
  int lit_cap = 0;
  int lit_used = 0;
  int max_seq = 0;
  int nseq = 0;

  bool active() const { return lit_ptr != nullptr; }
  bool Push(int32_t lp, int32_t ll_, int32_t of_, int32_t ml_, int32_t op) {
    if (nseq >= max_seq) return false;
    lit_ptr[nseq] = lp;
    lit_len[nseq] = ll_;
    off[nseq] = of_;
    mlen[nseq] = ml_;
    out_pos[nseq] = op;
    ++nseq;
    return true;
  }
};

// Decode literals section.  Returns bytes consumed, fills lit/lit_len
// (pointing into scratch when decoded, or into src for raw).  -1 on error.
int DecodeLiterals(const uint8_t* p, int len, FrameState* fs,
                   std::vector<uint8_t>* scratch, const uint8_t** lit,
                   int* lit_len) {
  if (len < 1) return -1;
  const int type = p[0] & 3;
  const int size_fmt = (p[0] >> 2) & 3;
  if (type == 0 || type == 1) {               // Raw / RLE
    int rsize, hdr;
    if (size_fmt == 0 || size_fmt == 2) {
      rsize = p[0] >> 3;
      hdr = 1;
    } else if (size_fmt == 1) {
      if (len < 2) return -1;
      rsize = (p[0] >> 4) | (p[1] << 4);
      hdr = 2;
    } else {
      if (len < 3) return -1;
      rsize = (p[0] >> 4) | (p[1] << 4) | (p[2] << 12);
      hdr = 3;
    }
    if (rsize < 0 || rsize > (1 << 20)) return -1;
    if (type == 0) {
      if (hdr + rsize > len) return -1;
      *lit = p + hdr;
      *lit_len = rsize;
      return hdr + rsize;
    }
    if (hdr + 1 > len) return -1;
    scratch->assign(rsize, p[hdr]);
    *lit = scratch->data();
    *lit_len = rsize;
    return hdr + 1;
  }
  // Compressed (2) / Treeless (3)
  int rsize, csize, hdr, streams;
  if (size_fmt == 0 || size_fmt == 1) {
    if (len < 3) return -1;
    streams = size_fmt == 0 ? 1 : 4;
    rsize = (p[0] >> 4) | ((p[1] & 0x3F) << 4);
    csize = (p[1] >> 6) | (p[2] << 2);
    hdr = 3;
  } else if (size_fmt == 2) {
    if (len < 4) return -1;
    streams = 4;
    rsize = (p[0] >> 4) | (p[1] << 4) | ((p[2] & 3) << 12);
    csize = (p[2] >> 2) | (p[3] << 6);
    hdr = 4;
  } else {
    if (len < 5) return -1;
    streams = 4;
    rsize = (p[0] >> 4) | (p[1] << 4) | ((p[2] & 0x3F) << 12);
    csize = (p[2] >> 6) | (p[3] << 2) | (p[4] << 10);
    hdr = 5;
  }
  if (csize <= 0 || hdr + csize > len || rsize < 0 || rsize > (1 << 20)) {
    return -1;
  }
  const uint8_t* body = p + hdr;
  int body_len = csize;
#ifdef DEBUG_ZSTD
  fprintf(stderr, "lit: type=%d fmt=%d rsize=%d csize=%d streams=%d\n",
          type, size_fmt, rsize, csize, streams);
#endif
  if (type == 2) {
    const int tused = ReadHufDescription(body, body_len, &fs->huf);
#ifdef DEBUG_ZSTD
    fprintf(stderr, "huf desc used=%d max_bits=%d\n", tused,
            fs->huf.max_bits);
#endif
    if (tused < 0) return -1;
    fs->huf_valid = true;
    body += tused;
    body_len -= tused;
  } else if (!fs->huf_valid) {
    return -1;
  }
  scratch->assign(static_cast<size_t>(rsize), 0);
  if (streams == 1) {
    if (!HufDecodeStream(fs->huf, body, body_len, scratch->data(), rsize)) {
#ifdef DEBUG_ZSTD
      fprintf(stderr, "huf 1-stream decode failed\n");
#endif
      return -1;
    }
  } else {
    if (body_len < 6) return -1;
    const int s1 = body[0] | (body[1] << 8);
    const int s2 = body[2] | (body[3] << 8);
    const int s3 = body[4] | (body[5] << 8);
    const int s4 = body_len - 6 - s1 - s2 - s3;
    if (s1 <= 0 || s2 <= 0 || s3 <= 0 || s4 <= 0) return -1;
    const int r123 = (rsize + 3) / 4;
    const int r4 = rsize - 3 * r123;
    if (r4 < 0) return -1;
    const uint8_t* sp = body + 6;
    if (!HufDecodeStream(fs->huf, sp, s1, scratch->data(), r123)) return -1;
    if (!HufDecodeStream(fs->huf, sp + s1, s2, scratch->data() + r123, r123))
      return -1;
    if (!HufDecodeStream(fs->huf, sp + s1 + s2, s3,
                         scratch->data() + 2 * r123, r123))
      return -1;
    if (!HufDecodeStream(fs->huf, sp + s1 + s2 + s3, s4,
                         scratch->data() + 3 * r123, r4))
      return -1;
  }
  *lit = scratch->data();
  *lit_len = rsize;
  return hdr + csize;
}

// Build a sequence-code table per the 2-bit mode.
int SetupTable(const uint8_t** pp, int* plen, int mode, const int16_t* def,
               int ndef, int def_acc, int max_acc, int max_sym,
               FseTable* table, bool* valid) {
  const uint8_t* p = *pp;
  int len = *plen;
  switch (mode) {
    case 0:  // predefined
      if (!table->Build(def, ndef, def_acc)) return -1;
      *valid = true;
      return 0;
    case 1: {  // RLE: single symbol, 1 byte
      if (len < 1) return -1;
      const int s = p[0];
      if (s > max_sym) return -1;
      std::vector<int16_t> counts(max_sym + 1, 0);
      counts[s] = 1;
      if (!table->Build(counts.data(), max_sym + 1, 0)) return -1;
      *valid = true;
      *pp = p + 1;
      *plen = len - 1;
      return 0;
    }
    case 2: {  // FSE-compressed description
      const int used = ReadFseDescription(p, len, max_acc, max_sym, table);
      if (used < 0) return -1;
      *valid = true;
      *pp = p + used;
      *plen = len - used;
      return 0;
    }
    case 3:  // repeat
      return *valid ? 0 : -1;
  }
  return -1;
}

// Decode + execute the sequences section of one block.
// dst window: [dst, dst+cap), current position *dpos.
int DecodeSequences(const uint8_t* p, int len, FrameState* fs,
                    const uint8_t* lit, int lit_len, uint8_t* dst,
                    int dst_cap, int* dpos, SeqRecorder* rec) {
  if (len < 1) return -1;
  int nseq;
  int hdr;
  if (p[0] < 128) {
    nseq = p[0];
    hdr = 1;
  } else if (p[0] < 255) {
    if (len < 2) return -1;
    nseq = ((p[0] - 128) << 8) + p[1];
    hdr = 2;
  } else {
    if (len < 3) return -1;
    nseq = p[1] + (p[2] << 8) + 0x7F00;
    hdr = 3;
  }
  const uint8_t* q = p + hdr;
  int qlen = len - hdr;
  int lpos = 0;
  int d = *dpos;

  if (nseq > 0) {
    if (qlen < 1) return -1;
    const int modes = q[0];
    ++q;
    --qlen;
    int rcT;
    rcT = SetupTable(&q, &qlen, (modes >> 6) & 3, kLLDefault, 36, 6, 9, 35,
                     &fs->ll, &fs->ll_valid);
#ifdef DEBUG_ZSTD
    fprintf(stderr, "LL setup mode=%d rc=%d\n", (modes >> 6) & 3, rcT);
#endif
    if (rcT < 0) return -1;
    rcT = SetupTable(&q, &qlen, (modes >> 4) & 3, kOFDefault, 29, 5, 8, 31,
                     &fs->of, &fs->of_valid);
#ifdef DEBUG_ZSTD
    fprintf(stderr, "OF setup mode=%d rc=%d\n", (modes >> 4) & 3, rcT);
#endif
    if (rcT < 0) return -1;
    rcT = SetupTable(&q, &qlen, (modes >> 2) & 3, kMLDefault, 53, 6, 9, 52,
                     &fs->ml, &fs->ml_valid);
#ifdef DEBUG_ZSTD
    fprintf(stderr, "ML setup mode=%d rc=%d\n", (modes >> 2) & 3, rcT);
#endif
    if (rcT < 0) return -1;

    BackBits bb;
    if (!bb.Init(q, qlen)) return -1;
    uint32_t sll = bb.Read(fs->ll.accuracy);
    uint32_t sof = bb.Read(fs->of.accuracy);
    uint32_t sml = bb.Read(fs->ml.accuracy);
#ifdef DEBUG_ZSTD
    fprintf(stderr, "nseq=%d states ll=%u of=%u ml=%u bits_left=%lld\n",
            nseq, sll, sof, sml, (long long)bb.bitpos);
#endif

    for (int i = 0; i < nseq; ++i) {
      const int of_code = fs->of.t[sof].symbol;
      const int ml_code = fs->ml.t[sml].symbol;
      const int ll_code = fs->ll.t[sll].symbol;
#ifdef DEBUG_ZSTD
      fprintf(stderr, "seq %d: codes of=%d ml=%d ll=%d\n", i, of_code, ml_code, ll_code);
#endif
      if (of_code > 31 || ml_code > 52 || ll_code > 35) return -1;
      // Offset_Value = (1 << of_code) + readBits(of_code); code 0 -> 1.
      const uint32_t of_value = (1u << of_code) + bb.Read(of_code);
      const uint32_t ml = kMLBase[ml_code] + bb.Read(kMLBits[ml_code]);
      const uint32_t ll = kLLBase[ll_code] + bb.Read(kLLBits[ll_code]);
#ifdef DEBUG_ZSTD
      fprintf(stderr, "  of_value=%u ml=%u ll=%u bits_left=%lld\n", of_value, ml, ll, (long long)bb.bitpos);
#endif

      uint32_t offset;
      if (of_value > 3) {
        offset = of_value - 3;
        fs->rep[2] = fs->rep[1];
        fs->rep[1] = fs->rep[0];
        fs->rep[0] = offset;
      } else {
        // Repeat offsets: index shifts by one when literal length is 0.
        const uint32_t idx = of_value - 1 + (ll == 0 ? 1 : 0);
        if (idx == 0) {
          offset = fs->rep[0];
        } else if (idx == 1) {
          offset = fs->rep[1];
          fs->rep[1] = fs->rep[0];
          fs->rep[0] = offset;
        } else if (idx == 2) {
          offset = fs->rep[2];
          fs->rep[2] = fs->rep[1];
          fs->rep[1] = fs->rep[0];
          fs->rep[0] = offset;
        } else {  // idx == 3: rep[0] - 1
          if (fs->rep[0] <= 1) return -1;
          offset = fs->rep[0] - 1;
          fs->rep[2] = fs->rep[1];
          fs->rep[1] = fs->rep[0];
          fs->rep[0] = offset;
        }
      }

      // literals copy
      if (ll > static_cast<uint32_t>(lit_len - lpos)) return -1;
      if (d + static_cast<int>(ll + ml) > dst_cap) return -1;
      if (rec && rec->active()) {
        if (rec->lit_used + static_cast<int>(ll) > rec->lit_cap) return -1;
        std::memcpy(rec->lit_buf + rec->lit_used, lit + lpos, ll);
        if (!rec->Push(rec->lit_used, ll, static_cast<int32_t>(offset),
                       static_cast<int32_t>(ml), d)) return -1;
        rec->lit_used += static_cast<int>(ll);
      }
      if (dst != nullptr) {
        std::memcpy(dst + d, lit + lpos, ll);
      }
      lpos += static_cast<int>(ll);
      d += static_cast<int>(ll);
      // match copy
      if (ml > 0) {
        if (offset > static_cast<uint32_t>(d)) return -1;
        if (dst != nullptr) {
          for (uint32_t k = 0; k < ml; ++k) dst[d + k] = dst[d - offset + k];
        }
        d += static_cast<int>(ml);
      }

      if (i + 1 < nseq) {
        const FseEntry& ell = fs->ll.t[sll];
        sll = ell.base + bb.Read(ell.nbits);
        const FseEntry& eml = fs->ml.t[sml];
        sml = eml.base + bb.Read(eml.nbits);
        const FseEntry& eof = fs->of.t[sof];
        sof = eof.base + bb.Read(eof.nbits);
      }
    }
    if (bb.bitpos != 0) return -1;   // stream must end exactly
  }

  // trailing literals
  const int rest = lit_len - lpos;
  if (rest > 0) {
    if (d + rest > dst_cap) return -1;
    if (rec && rec->active()) {
      if (rec->lit_used + rest > rec->lit_cap) return -1;
      std::memcpy(rec->lit_buf + rec->lit_used, lit + lpos, rest);
      if (!rec->Push(rec->lit_used, rest, 0, 0, d)) return -1;
      rec->lit_used += rest;
    }
    if (dst != nullptr) std::memcpy(dst + d, lit + lpos, rest);
    d += rest;
  }
  *dpos = d;
  return 0;
}

// Full frame walk.  dst may be null when only recording.
int ZstdWalk(const uint8_t* src, int src_len, uint8_t* dst, int dst_cap,
             SeqRecorder* rec) {
  if (src == nullptr || src_len < 4) return BT_ERR_INVALID;
  int s = 0;
  // Skippable frames
  while (s + 8 <= src_len) {
    uint32_t magic;
    std::memcpy(&magic, src + s, 4);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      uint32_t sz;
      std::memcpy(&sz, src + s + 4, 4);
      s += 8 + static_cast<int>(sz);
      continue;
    }
    break;
  }
  if (s + 4 > src_len) return BT_ERR_IO;
  uint32_t magic;
  std::memcpy(&magic, src + s, 4);
  if (magic != 0xFD2FB528u) return BT_ERR_IO;
  s += 4;
  if (s >= src_len) return BT_ERR_IO;
  const uint8_t fhd = src[s++];
  const int fcs_flag = fhd >> 6;
  const bool single_seg = fhd & 0x20;
  const bool checksum = fhd & 0x04;
  const int did_size = (fhd & 3) == 0 ? 0 : (1 << ((fhd & 3) - 1));
  if (!single_seg) ++s;                       // window descriptor
  s += did_size;                              // dictionary id (ignored)
  int fcs_size = fcs_flag == 0 ? (single_seg ? 1 : 0)
                               : (fcs_flag == 1 ? 2 : (fcs_flag == 2 ? 4 : 8));
  uint64_t content_size = ~0ull;
  if (fcs_size) {
    if (s + fcs_size > src_len) return BT_ERR_IO;
    content_size = 0;
    for (int k = 0; k < fcs_size; ++k) {
      content_size |= static_cast<uint64_t>(src[s + k]) << (8 * k);
    }
    if (fcs_size == 2) content_size += 256;
    s += fcs_size;
  }

  FrameState fs;
  std::vector<uint8_t> lit_scratch;
  int d = 0;
  for (;;) {
    if (s + 3 > src_len) return BT_ERR_IO;
    const uint32_t bh = src[s] | (src[s + 1] << 8) | (src[s + 2] << 16);
    s += 3;
    const bool last = bh & 1;
    const int btype = (bh >> 1) & 3;
    const int bsize = static_cast<int>(bh >> 3);
    if (btype == 0) {                          // raw block
      if (s + bsize > src_len || d + bsize > dst_cap) return BT_ERR_IO;
      if (rec && rec->active()) {
        if (rec->lit_used + bsize > rec->lit_cap) return BT_ERR_CAPACITY;
        std::memcpy(rec->lit_buf + rec->lit_used, src + s, bsize);
        if (!rec->Push(rec->lit_used, bsize, 0, 0, d)) return BT_ERR_CAPACITY;
        rec->lit_used += bsize;
      }
      if (dst != nullptr) std::memcpy(dst + d, src + s, bsize);
      d += bsize;
      s += bsize;
    } else if (btype == 1) {                   // RLE block
      if (s + 1 > src_len || d + bsize > dst_cap) return BT_ERR_IO;
      if (rec && rec->active()) {
        // one literal byte + an overlapping match reproduces the run
        if (rec->lit_used + 1 > rec->lit_cap) return BT_ERR_CAPACITY;
        rec->lit_buf[rec->lit_used] = src[s];
        if (bsize == 1) {
          if (!rec->Push(rec->lit_used, 1, 0, 0, d)) return BT_ERR_CAPACITY;
        } else {
          if (!rec->Push(rec->lit_used, 1, 1, bsize - 1, d))
            return BT_ERR_CAPACITY;
        }
        rec->lit_used += 1;
      }
      if (dst != nullptr) std::memset(dst + d, src[s], bsize);
      d += bsize;
      s += 1;
    } else if (btype == 2) {                   // compressed block
      if (s + bsize > src_len) return BT_ERR_IO;
      const uint8_t* lit = nullptr;
      int lit_len = 0;
      const int lused = DecodeLiterals(src + s, bsize, &fs, &lit_scratch,
                                       &lit, &lit_len);
#ifdef DEBUG_ZSTD
      fprintf(stderr, "block: bsize=%d lused=%d lit_len=%d\n", bsize, lused, lit_len);
#endif
      if (lused < 0) return BT_ERR_IO;
      if (DecodeSequences(src + s + lused, bsize - lused, &fs, lit, lit_len,
                          dst, dst_cap, &d, rec) < 0) {
        return BT_ERR_IO;
      }
      s += bsize;
    } else {
      return BT_ERR_IO;
    }
    if (last) break;
  }
  if (checksum) s += 4;                        // not validated (engine
                                               // checksums cover content)
  if (content_size != ~0ull && content_size != static_cast<uint64_t>(d)) {
    return BT_ERR_IO;
  }
  return d;
}

// =====================================================================
// From-scratch Zstandard COMPRESSOR (RFC 8878 encoder side).
//
// Strategy: greedy hash-4 LZ matching over the full window (the frame is
// single-segment, so any back-reference to the start of the input is
// legal), raw (uncompressed) literals, and sequences entropy-coded with
// the PREDEFINED FSE distributions (Predefined_Mode for all three
// channels).  Every compressed block is therefore self-describing with
// zero table payload; blocks that do not shrink fall back to Raw_Block.
// This mirrors the library's lz4.cc matcher structure and interops with
// any compliant decoder (fuzz-validated against the zstandard module and
// the decoder above).
//
// Reference for capability parity: bitar's device executes both
// directions of its codec (src/device.cc:157-318); this makes zstd a
// full native member of the host codec set rather than riding the
// Python zstandard module.

namespace {

// Forward bit writer: zstd entropy payloads are written forward,
// low-bits-first per byte, and read backward from a final 1-terminator.
struct FwdBits {
  uint8_t* p;
  uint8_t* lim;
  uint64_t acc = 0;
  int n = 0;
  bool overflow = false;

  FwdBits(uint8_t* dst, uint8_t* limit) : p(dst), lim(limit) {}

  void Add(uint32_t v, int nb) {
    if (nb <= 0) return;
    const uint32_t mask = nb >= 32 ? ~0u : ((1u << nb) - 1);
    acc |= static_cast<uint64_t>(v & mask) << n;
    n += nb;
    while (n >= 8) {
      if (p >= lim) { overflow = true; n = 0; acc = 0; return; }
      *p++ = static_cast<uint8_t>(acc);
      acc >>= 8;
      n -= 8;
    }
  }

  // Terminator bit + pad; returns false on overflow.
  bool Close() {
    Add(1, 1);
    if (n > 0) {
      if (p >= lim) return false;
      *p++ = static_cast<uint8_t>(acc);
      acc = 0;
      n = 0;
    }
    return !overflow;
  }
};

// FSE encoding table (upstream FSE_buildCTable construction) built from
// the same normalized counts and symbol spread as the decoder's FseTable
// — the spread loop below must stay bit-identical to FseTable::Build.
struct FseCTable {
  int log = 0;
  std::vector<uint16_t> next_state;   // indexed by cumulative symbol rank
  std::vector<uint32_t> delta_nbbits;
  std::vector<int32_t> delta_fs;

  bool Build(const int16_t* counts, int nsym, int accuracy_log) {
    log = accuracy_log;
    const int size = 1 << accuracy_log;
    std::vector<uint8_t> spread(size, 0);

    int hi = size - 1;
    for (int s = 0; s < nsym; ++s) {
      if (counts[s] == -1) spread[hi--] = static_cast<uint8_t>(s);
    }
    const int step = (size >> 1) + (size >> 3) + 3;
    const int mask = size - 1;
    int pos = 0;
    for (int s = 0; s < nsym; ++s) {
      for (int c = 0; c < counts[s]; ++c) {
        spread[pos] = static_cast<uint8_t>(s);
        do {
          pos = (pos + step) & mask;
        } while (pos > hi);
      }
    }
    if (pos != 0) return false;

    // cumul[s] = first state-table rank of symbol s.
    std::vector<int> cumul(nsym + 1, 0);
    for (int s = 0; s < nsym; ++s) {
      cumul[s + 1] = cumul[s] + (counts[s] == -1 ? 1 : counts[s]);
    }
    if (cumul[nsym] != size) return false;
    next_state.assign(size, 0);
    for (int u = 0; u < size; ++u) {
      const int s = spread[u];
      next_state[cumul[s]++] = static_cast<uint16_t>(size + u);
    }

    delta_nbbits.assign(nsym, 0);
    delta_fs.assign(nsym, 0);
    int total = 0;
    for (int s = 0; s < nsym; ++s) {
      const int c = counts[s] == -1 ? 1 : counts[s];
      if (c == 0) continue;
      if (c == 1) {
        delta_nbbits[s] = (static_cast<uint32_t>(accuracy_log) << 16) -
                          (1u << accuracy_log);
        delta_fs[s] = total - 1;
        total += 1;
      } else {
        const int max_bits =
            accuracy_log - (31 - __builtin_clz(static_cast<unsigned>(c - 1)));
        const uint32_t min_state_plus = static_cast<uint32_t>(c) << max_bits;
        delta_nbbits[s] = (static_cast<uint32_t>(max_bits) << 16) -
                          min_state_plus;
        delta_fs[s] = total - c;
        total += c;
      }
    }
    return total == size;
  }
};

struct CState {
  uint32_t value = 0;

  // First symbol: state loaded without emitting bits (FSE_initCState2).
  void Init(const FseCTable& t, int sym) {
    const uint32_t nb = (t.delta_nbbits[sym] + (1u << 15)) >> 16;
    const uint32_t v = (nb << 16) - t.delta_nbbits[sym];
    value = t.next_state[(v >> nb) + t.delta_fs[sym]];
  }

  void Encode(FwdBits& b, const FseCTable& t, int sym) {
    const uint32_t nb = (value + t.delta_nbbits[sym]) >> 16;
    b.Add(value, static_cast<int>(nb));
    value = t.next_state[(value >> nb) + t.delta_fs[sym]];
  }

  void Flush(FwdBits& b, const FseCTable& t) { b.Add(value, t.log); }
};

// Predefined-mode encoding tables, built once.
struct PredefCTables {
  FseCTable ll, of, ml;
  bool ok;
  PredefCTables() {
    ok = ll.Build(kLLDefault, 36, 6) && of.Build(kOFDefault, 29, 5) &&
         ml.Build(kMLDefault, 53, 6);
  }
};

const PredefCTables& Ctables() {
  static const PredefCTables t;
  return t;
}

inline int HighBit(uint32_t v) { return 31 - __builtin_clz(v); }

// Sequence code mappings (RFC 8878 §3.1.1.3.2.1), inverse of kLLBase etc.
inline int LLCode(uint32_t ll) {
  if (ll < 16) return static_cast<int>(ll);
  int c = 35;
  while (kLLBase[c] > ll) --c;
  return c;
}

inline int MLCode(uint32_t ml) {    // ml is the actual match length (>= 3)
  if (ml < 35) return static_cast<int>(ml - 3);
  int c = 52;
  while (kMLBase[c] > ml) --c;
  return c;
}

struct EncSeq {
  const uint8_t* lit;   // literal bytes preceding the match (in src)
  uint32_t ll;
  uint32_t off;         // actual match offset (repeat mapping at encode)
  uint32_t ml;          // actual match length (>= 3)
};

// ---------------------------------------------------------------------
// Huffman literal encoding (canonical code, decoder-compatible weight
// ordering; RFC 8878 §4.2.1).  Code lengths are limited to 11 bits with
// the zlib bl_count overflow repair, which preserves Kraft equality —
// required because the decoder infers the implied last weight from the
// power-of-two completion.

struct HufCTable {
  uint16_t code[256];
  uint8_t nbits[256];
  uint8_t weight[256];
  int last_sym = 0;     // highest present symbol; its weight is implied
  int max_bits = 0;

  bool Build(const uint32_t* hist) {
    int syms[256];
    int n = 0;
    for (int s = 0; s < 256; ++s) {
      if (hist[s]) syms[n++] = s;
    }
    if (n < 2) return false;  // single-symbol alphabets use RLE literals
    std::sort(syms, syms + n,
              [&](int a, int b) { return hist[a] < hist[b]; });

    // Two-queue Huffman: leaves (sorted asc) + internal nodes (created in
    // nondecreasing frequency order).
    uint64_t freq[512];
    int parent[512];
    for (int k = 0; k < n; ++k) freq[k] = hist[syms[k]];
    int nnodes = n;
    int li = 0;        // next leaf
    int qi = n;        // next internal to consume
    for (int made = 0; made < n - 1; ++made) {
      int a, b;
      // smallest
      if (qi >= nnodes || (li < n && freq[li] <= freq[qi])) a = li++;
      else a = qi++;
      if (qi >= nnodes || (li < n && freq[li] <= freq[qi])) b = li++;
      else b = qi++;
      freq[nnodes] = freq[a] + freq[b];
      parent[a] = nnodes;
      parent[b] = nnodes;
      ++nnodes;
    }
    int depth[256];
    for (int k = 0; k < n; ++k) {
      int d = 0;
      for (int v = k; v != nnodes - 1; v = parent[v]) ++d;
      depth[k] = d;
    }

    // Length-limit to 11 via bl_count repair (zlib gen_bitlen scheme).
    constexpr int kMaxLen = 11;
    int bl_count[kMaxLen + 2] = {0};
    int overflow = 0;
    for (int k = 0; k < n; ++k) {
      if (depth[k] > kMaxLen) {
        ++overflow;
        ++bl_count[kMaxLen];
      } else {
        ++bl_count[depth[k]];
      }
    }
    while (overflow > 0) {
      int bits = kMaxLen - 1;
      while (bl_count[bits] == 0) --bits;
      --bl_count[bits];
      bl_count[bits + 1] += 2;
      --bl_count[kMaxLen];
      overflow -= 2;
    }
    // Reassign lengths: longest codes to the least frequent symbols
    // (syms[] is frequency-ascending).
    int len[256];
    int k = 0;
    for (int d = kMaxLen; d >= 1; --d) {
      for (int c = 0; c < bl_count[d]; ++c) len[k++] = d;
    }
    if (k != n) return false;

    int maxlen = len[0];
    std::memset(weight, 0, sizeof(weight));
    last_sym = 0;
    for (int j = 0; j < n; ++j) {
      weight[syms[j]] = static_cast<uint8_t>(maxlen + 1 - len[j]);
      if (syms[j] > last_sym) last_sym = syms[j];
    }
    max_bits = maxlen;

    // Canonical assignment mirroring HufTable::BuildFromWeights: ranked
    // by weight ascending then symbol ascending; a symbol's code is the
    // top nbits of its first table slot.
    std::memset(nbits, 0, sizeof(nbits));
    int pos = 0;
    for (int w = 1; w <= max_bits; ++w) {
      for (int s = 0; s <= last_sym; ++s) {
        if (weight[s] != w) continue;
        nbits[s] = static_cast<uint8_t>(max_bits + 1 - w);
        code[s] = static_cast<uint16_t>(pos >> (w - 1));
        pos += 1 << (w - 1);
      }
    }
    return pos == (1 << max_bits);
  }

  int64_t PayloadBits(const uint32_t* hist) const {
    int64_t bits = 0;
    for (int s = 0; s <= last_sym; ++s) {
      bits += static_cast<int64_t>(hist[s]) * nbits[s];
    }
    return bits;
  }
};

// FSE-compressed Huffman weights (RFC 8878 §4.2.1.2): normalized-count
// table description (the exact inverse of ReadFseDescription's walk)
// followed by a two-state interleaved FSE stream, upstream flush order
// (C2 then C1) so the decoder's s0 picks up even-index weights.
// Returns payload bytes (the headerByte value) or -1 when FSE doesn't
// apply (too few weights / single distinct symbol / overflow).
int WriteHufWeightsFse(const uint8_t* w, int nw, uint8_t* dst, int cap) {
  if (nw < 4 || cap < 4) return -1;
  uint32_t cnt[16] = {0};
  int maxs = 0;
  for (int i = 0; i < nw; ++i) {
    ++cnt[w[i]];
    if (w[i] > maxs) maxs = w[i];
  }
  int distinct = 0;
  for (int s = 0; s <= maxs; ++s) distinct += cnt[s] > 0;
  if (distinct < 2) return -1;

  // Normalize counts to 2^acc.  The description stores acc-5 in 4 bits
  // and weight tables cap at 6, so acc is 5 or 6.
  const int acc = (16 >= distinct && 16 >= nw) ? 5 : 6;
  const int size = 1 << acc;
  int16_t norm[16] = {0};
  int sum = 0;
  for (int s = 0; s <= maxs; ++s) {
    if (!cnt[s]) continue;
    int v = static_cast<int>((static_cast<uint64_t>(cnt[s]) * size + nw / 2) / nw);
    if (v < 1) v = 1;
    norm[s] = static_cast<int16_t>(v);
    sum += v;
  }
  while (sum != size) {
    int best = -1;
    for (int s = 0; s <= maxs; ++s) {
      if (norm[s] > (sum > size ? 1 : 0) &&
          (best < 0 || norm[s] > norm[best])) {
        best = s;
      }
    }
    if (best < 0) return -1;
    if (sum > size) { --norm[best]; --sum; }
    else { ++norm[best]; ++sum; }
  }
  // A count occupying the whole table breaks termination (0-bit states).
  for (int s = 0; s <= maxs; ++s) {
    if (norm[s] >= size) return -1;
  }

  FseCTable ct;
  if (!ct.Build(norm, maxs + 1, acc)) return -1;

  // --- Table description: forward LSB-first bitstream, byte-padded.
  uint8_t* p = dst;
  uint64_t bacc = static_cast<uint64_t>(acc - 5);
  int bn = 4;
  auto put = [&](uint32_t v, int nb2) {
    bacc |= static_cast<uint64_t>(v & ((1u << nb2) - 1)) << bn;
    bn += nb2;
    while (bn >= 8) {
      if (p >= dst + cap) { bn = -1; return; }
      *p++ = static_cast<uint8_t>(bacc);
      bacc >>= 8;
      bn -= 8;
    }
  };
  {
    int remaining = size + 1;
    int threshold = size;
    int nb = acc + 1;
    int s = 0;
    while (remaining > 1) {
      if (s > maxs) return -1;
      const int count = norm[s++];
      const int maxv = 2 * threshold - 1 - remaining;
      const int v = count + 1;
      if (v < maxv) {
        put(static_cast<uint32_t>(v), nb - 1);
      } else {
        put(static_cast<uint32_t>(v < threshold ? v : v + maxv), nb);
      }
      if (bn < 0) return -1;
      remaining -= count;
      while (remaining < threshold && remaining > 1) {
        --nb;
        threshold >>= 1;
      }
      if (count == 0 && remaining > 1) {
        int z = 0;
        while (s + z <= maxs && norm[s + z] == 0) ++z;
        int zz = z;
        while (zz >= 3) {
          put(3, 2);
          zz -= 3;
        }
        put(static_cast<uint32_t>(zz), 2);
        if (bn < 0) return -1;
        s += z;
      }
    }
    if (bn > 0) {
      if (p >= dst + cap) return -1;
      *p++ = static_cast<uint8_t>(bacc);
    }
  }

  // --- Weight payload: two interleaved states, symbols written backward.
  FwdBits bits(p, dst + cap);
  CState c1, c2;  // c1 carries even indices (decoder s0), c2 odd
  int ip = nw;
  if (nw & 1) {
    c1.Init(ct, w[--ip]);
    c2.Init(ct, w[--ip]);
    c1.Encode(bits, ct, w[--ip]);
  } else {
    c2.Init(ct, w[--ip]);
    c1.Init(ct, w[--ip]);
  }
  while (ip > 0) {
    c2.Encode(bits, ct, w[--ip]);
    c1.Encode(bits, ct, w[--ip]);
  }
  c2.Flush(bits, ct);
  c1.Flush(bits, ct);
  if (!bits.Close()) return -1;
  return static_cast<int>(bits.p - dst);
}

// One Huffman stream: symbols written in reverse so the backward reader
// sees them in order; returns bytes or -1 on overflow.
int EncodeHufStream(const HufCTable& h, const uint8_t* lit, int n,
                    uint8_t* dst, int cap) {
  FwdBits b(dst, dst + cap);
  for (int i = n - 1; i >= 0; --i) b.Add(h.code[lit[i]], h.nbits[lit[i]]);
  if (!b.Close()) return -1;
  return static_cast<int>(b.p - dst);
}

// Encode the literals section at dst: RLE when uniform, Huffman-compressed
// (direct 4-bit weights; 1 stream <= 1023 bytes, else 4 streams) when it
// saves space.  Returns bytes written, 0 when a raw section is the better
// choice, -1 on cap overflow.
int EncodeLiteralsSection(const uint8_t* lits, int L, uint8_t* dst, int cap) {
  if (L >= 1) {
    bool uniform = true;
    for (int i = 1; i < L; ++i) {
      if (lits[i] != lits[0]) { uniform = false; break; }
    }
    if (uniform && L >= 2) {  // RLE_Literals_Block
      if (L < 32) {
        if (cap < 2) return -1;
        dst[0] = static_cast<uint8_t>(1 | (L << 3));
        dst[1] = lits[0];
        return 2;
      }
      if (L < 4096) {
        if (cap < 3) return -1;
        dst[0] = static_cast<uint8_t>(1 | (1 << 2) | ((L & 0xF) << 4));
        dst[1] = static_cast<uint8_t>(L >> 4);
        dst[2] = lits[0];
        return 3;
      }
      if (cap < 4) return -1;
      dst[0] = static_cast<uint8_t>(1 | (3 << 2) | ((L & 0xF) << 4));
      dst[1] = static_cast<uint8_t>((L >> 4) & 0xFF);
      dst[2] = static_cast<uint8_t>(L >> 12);
      dst[3] = lits[0];
      return 4;
    }
  }
  if (L < 64 || L >= (1 << 18)) return 0;

  uint32_t hist[256] = {0};
  for (int i = 0; i < L; ++i) ++hist[lits[i]];
  HufCTable h;
  if (!h.Build(hist)) return 0;
  // Weight serialization: FSE-compressed when smaller (and the only
  // option for alphabets whose top symbol exceeds 128 — the direct form
  // lists at most 128 nibbles), else direct 4-bit nibbles.
  const int nw = h.last_sym;
  uint8_t wdesc[160];
  int fse_n = WriteHufWeightsFse(h.weight, nw, wdesc + 1,
                                 static_cast<int>(sizeof(wdesc)) - 1);
  if (fse_n >= 128 || (nw <= 128 && fse_n >= 1 + (nw + 1) / 2)) fse_n = -1;
  if (fse_n < 0 && nw > 128) return 0;
  const int desc = fse_n > 0 ? 1 + fse_n : 1 + (nw + 1) / 2;
  const int streams = L <= 1023 ? 1 : 4;
  const int hdr = streams == 1 ? 3 : (L <= 16383 ? 4 : 5);
  const int64_t est = hdr + desc + (streams == 4 ? 6 : 0) +
                      h.PayloadBits(hist) / 8 + streams + 4;
  const int raw_cost = (L < 32 ? 1 : (L < 4096 ? 2 : 3)) + L;
  if (est >= raw_cost) return 0;

  // Payload: tree description + (jump table) + streams.
  thread_local std::vector<uint8_t> payload;
  payload.resize(static_cast<size_t>(desc) + 6 +
                 static_cast<size_t>(L) + 64);
  uint8_t* q = payload.data();
  if (fse_n > 0) {
    wdesc[0] = static_cast<uint8_t>(fse_n);
    std::memcpy(q, wdesc, desc);
  } else {
    q[0] = static_cast<uint8_t>(127 + nw);
    for (int i = 0; i < nw; i += 2) {
      const uint8_t hi = h.weight[i];
      const uint8_t lo = i + 1 < nw ? h.weight[i + 1] : 0;
      q[1 + i / 2] = static_cast<uint8_t>((hi << 4) | lo);
    }
  }
  int plen = desc;
  if (streams == 1) {
    const int n1 = EncodeHufStream(h, lits, L, q + plen,
                                   static_cast<int>(payload.size()) - plen);
    if (n1 < 0) return 0;
    plen += n1;
  } else {
    const int r123 = (L + 3) / 4;
    const int r4 = L - 3 * r123;
    if (r4 <= 0) return 0;
    uint8_t* jump = q + plen;
    plen += 6;
    int sizes[4];
    const uint8_t* parts[4] = {lits, lits + r123, lits + 2 * r123,
                               lits + 3 * r123};
    const int want[4] = {r123, r123, r123, r4};
    for (int s = 0; s < 4; ++s) {
      const int ns = EncodeHufStream(h, parts[s], want[s], q + plen,
                                     static_cast<int>(payload.size()) - plen);
      if (ns < 0) return 0;
      sizes[s] = ns;
      plen += ns;
    }
    for (int s = 0; s < 3; ++s) {
      if (sizes[s] > 0xFFFF) return 0;
      jump[2 * s] = static_cast<uint8_t>(sizes[s]);
      jump[2 * s + 1] = static_cast<uint8_t>(sizes[s] >> 8);
    }
  }
  const int csize = plen;
  if (csize + 5 >= raw_cost) return 0;  // re-check with exact size

  // Section header (type 2, Compressed_Literals_Block).
  int d;
  if (streams == 1) {
    if (csize > 1023) return 0;
    if (cap < 3 + csize) return -1;
    dst[0] = static_cast<uint8_t>(2 | (0 << 2) | ((L & 0xF) << 4));
    dst[1] = static_cast<uint8_t>((L >> 4) | ((csize & 3) << 6));
    dst[2] = static_cast<uint8_t>(csize >> 2);
    d = 3;
  } else if (L <= 16383 && csize <= 16383) {
    if (cap < 4 + csize) return -1;
    dst[0] = static_cast<uint8_t>(2 | (2 << 2) | ((L & 0xF) << 4));
    dst[1] = static_cast<uint8_t>((L >> 4) & 0xFF);
    dst[2] = static_cast<uint8_t>(((L >> 12) & 3) | ((csize & 0x3F) << 2));
    dst[3] = static_cast<uint8_t>(csize >> 6);
    d = 4;
  } else {
    if (cap < 5 + csize) return -1;
    dst[0] = static_cast<uint8_t>(2 | (3 << 2) | ((L & 0xF) << 4));
    dst[1] = static_cast<uint8_t>((L >> 4) & 0xFF);
    dst[2] = static_cast<uint8_t>(((L >> 12) & 0x3F) | ((csize & 3) << 6));
    dst[3] = static_cast<uint8_t>((csize >> 2) & 0xFF);
    dst[4] = static_cast<uint8_t>(csize >> 10);
    d = 5;
  }
  std::memcpy(dst + d, payload.data(), csize);
  return d + csize;
}

// Encode one compressed block's content (literals section + sequences
// section) at dst; trailing literals [tlit, tlit+tll) follow the
// sequences.  rep[3] is the frame's repeat-offset state: it is updated
// in place ONLY on success — the caller must snapshot/restore it when it
// discards the encoded block for a raw fallback.  Returns content size
// or -1 on overflow/cap.
int EncodeBlockContent(const std::vector<EncSeq>& seqs, const uint8_t* tlit,
                       int tll, uint8_t* dst, int cap, uint32_t rep[3]) {
  const PredefCTables& ct = Ctables();
  if (!ct.ok) return -1;
  int64_t lit_total = tll;
  for (const EncSeq& s : seqs) lit_total += s.ll;
  if (lit_total > (1 << 20) - 1) return -1;
  const int L = static_cast<int>(lit_total);

  // Assemble the literal stream, then entropy-code it when profitable.
  thread_local std::vector<uint8_t> litbuf;
  litbuf.resize(static_cast<size_t>(L));
  {
    int lp = 0;
    for (const EncSeq& s : seqs) {
      std::memcpy(litbuf.data() + lp, s.lit, s.ll);
      lp += static_cast<int>(s.ll);
    }
    if (tll > 0) std::memcpy(litbuf.data() + lp, tlit, tll);
  }
  int d = EncodeLiteralsSection(litbuf.data(), L, dst, cap);
  if (d < 0) return -1;
  if (d == 0) {
    // Raw_Literals_Block.
    if (L < 32) {
      if (cap < 1) return -1;
      dst[d++] = static_cast<uint8_t>(L << 3);
    } else if (L < 4096) {
      if (cap < 2) return -1;
      dst[d++] = static_cast<uint8_t>((1 << 2) | ((L & 0xF) << 4));
      dst[d++] = static_cast<uint8_t>(L >> 4);
    } else {
      if (cap < 3) return -1;
      dst[d++] = static_cast<uint8_t>((3 << 2) | ((L & 0xF) << 4));
      dst[d++] = static_cast<uint8_t>((L >> 4) & 0xFF);
      dst[d++] = static_cast<uint8_t>(L >> 12);
    }
    if (d + L > cap) return -1;
    std::memcpy(dst + d, litbuf.data(), L);
    d += L;
  }

  // Repeat-offset mapping must walk sequences FORWARD (the bitstream is
  // written in reverse): mirror of the decoder's rep update rules.
  thread_local std::vector<uint32_t> offbases;
  offbases.resize(seqs.size());
  uint32_t r0 = rep[0], r1 = rep[1], r2 = rep[2];
  for (size_t i = 0; i < seqs.size(); ++i) {
    const uint32_t off = seqs[i].off;
    uint32_t ob;
    if (seqs[i].ll > 0) {
      if (off == r0) {
        ob = 1;
      } else if (off == r1) {
        ob = 2; r1 = r0; r0 = off;
      } else if (off == r2) {
        ob = 3; r2 = r1; r1 = r0; r0 = off;
      } else {
        ob = off + 3; r2 = r1; r1 = r0; r0 = off;
      }
    } else {
      if (off == r1) {
        ob = 1; r1 = r0; r0 = off;
      } else if (off == r2) {
        ob = 2; r2 = r1; r1 = r0; r0 = off;
      } else if (r0 > 1 && off == r0 - 1) {
        ob = 3; r2 = r1; r1 = r0; r0 = off;
      } else {
        ob = off + 3; r2 = r1; r1 = r0; r0 = off;
      }
    }
    offbases[i] = ob;
  }

  // Sequences section: count, modes, FSE bitstream.
  const int nseq = static_cast<int>(seqs.size());
  if (nseq < 128) {
    if (d + 1 > cap) return -1;
    dst[d++] = static_cast<uint8_t>(nseq);
  } else if (nseq < 0x7F00) {
    if (d + 2 > cap) return -1;
    dst[d++] = static_cast<uint8_t>(128 + (nseq >> 8));
    dst[d++] = static_cast<uint8_t>(nseq & 0xFF);
  } else {
    if (d + 3 > cap) return -1;
    dst[d++] = 255;
    dst[d++] = static_cast<uint8_t>((nseq - 0x7F00) & 0xFF);
    dst[d++] = static_cast<uint8_t>((nseq - 0x7F00) >> 8);
  }
  if (nseq == 0) return d;
  if (d + 1 > cap) return -1;
  dst[d++] = 0;  // all channels Predefined_Mode

  // The bitstream is written forward and read backward: encode sequences
  // last-to-first so the decoder's forward walk sees them in order
  // (canonical FSE encoder structure).
  FwdBits bits(dst + d, dst + cap);
  const EncSeq& last = seqs[nseq - 1];
  const int ll_c0 = LLCode(last.ll);
  const int ml_c0 = MLCode(last.ml);
  const int of_c0 = HighBit(offbases[nseq - 1]);
  CState sml, sof, sll;
  sml.Init(ct.ml, ml_c0);
  sof.Init(ct.of, of_c0);
  sll.Init(ct.ll, ll_c0);
  bits.Add(last.ll - kLLBase[ll_c0], kLLBits[ll_c0]);
  bits.Add(last.ml - kMLBase[ml_c0], kMLBits[ml_c0]);
  bits.Add(offbases[nseq - 1] - (1u << of_c0), of_c0);
  for (int i = nseq - 2; i >= 0; --i) {
    const EncSeq& s = seqs[i];
    const int ll_c = LLCode(s.ll);
    const int ml_c = MLCode(s.ml);
    const int of_c = HighBit(offbases[i]);
    sof.Encode(bits, ct.of, of_c);
    sml.Encode(bits, ct.ml, ml_c);
    sll.Encode(bits, ct.ll, ll_c);
    bits.Add(s.ll - kLLBase[ll_c], kLLBits[ll_c]);
    bits.Add(s.ml - kMLBase[ml_c], kMLBits[ml_c]);
    bits.Add(offbases[i] - (1u << of_c), of_c);
  }
  sml.Flush(bits, ct.ml);
  sof.Flush(bits, ct.of);
  sll.Flush(bits, ct.ll);
  if (!bits.Close()) return -1;
  rep[0] = r0; rep[1] = r1; rep[2] = r2;
  return d + static_cast<int>(bits.p - (dst + d));
}

constexpr int kZBlockMax = 128 * 1024;  // Block_Maximum_Size (window >= 128K)
constexpr int kZHashLog = 15;
constexpr int kZHashSize = 1 << kZHashLog;
constexpr int kZMinMatch = 4;           // hash-4 matcher (codes allow 3)

inline uint32_t ZHash4(uint32_t v) { return (v * 2654435761u) >> (32 - kZHashLog); }

int ZstdCompress(const uint8_t* src, int src_len, uint8_t* dst, int dst_cap) {
  int d = 0;
  // --- Frame header: magic + single-segment FHD + frame content size.
  const int fcs_flag = src_len <= 255 ? 0 : (src_len < 65536 + 256 ? 1 : 2);
  const int fcs_size = fcs_flag == 0 ? 1 : (fcs_flag == 1 ? 2 : 4);
  if (d + 5 + fcs_size > dst_cap) return BT_ERR_CAPACITY;
  const uint32_t magic = 0xFD2FB528u;
  std::memcpy(dst + d, &magic, 4);
  d += 4;
  dst[d++] = static_cast<uint8_t>((fcs_flag << 6) | 0x20);
  {
    uint64_t fcs = static_cast<uint64_t>(src_len);
    if (fcs_flag == 1) fcs -= 256;
    for (int k = 0; k < fcs_size; ++k) dst[d++] = static_cast<uint8_t>(fcs >> (8 * k));
  }
  if (src_len == 0) {
    if (d + 3 > dst_cap) return BT_ERR_CAPACITY;
    dst[d++] = 1;  // last, Raw_Block, size 0
    dst[d++] = 0;
    dst[d++] = 0;
    return d;
  }

  std::vector<int32_t> table(kZHashSize, -1);
  std::vector<EncSeq> seqs;
  seqs.reserve(1024);

  const int matchlimit = src_len - 5;   // keep the last bytes literal (hash-4
  const int mflimit = src_len - 12;     // + fast tail, as in lz4.cc)
  int i = 0;
  int anchor = 0;
  int pending_off = 0;  // match continuation across a block cut
  uint32_t rep[3] = {1, 4, 8};  // frame repeat-offset state (RFC 8878)
  uint32_t last_off = 1;        // previous accepted offset (== live rep0)

  for (int b0 = 0; b0 < src_len; b0 += kZBlockMax) {
    const int b1 = b0 < src_len - kZBlockMax ? b0 + kZBlockMax : src_len;
    seqs.clear();

    // Continue a match truncated at the previous block boundary.
    if (pending_off > 0 && i < matchlimit) {
      int ml = 0;
      const int lim = b1 < matchlimit ? b1 : matchlimit;
      while (i + ml < lim && src[i + ml] == src[i - pending_off + ml]) ++ml;
      if (ml >= 3) {
        seqs.push_back(EncSeq{src + anchor, 0,
                              static_cast<uint32_t>(pending_off),
                              static_cast<uint32_t>(ml)});
        last_off = static_cast<uint32_t>(pending_off);
        i += ml;
        anchor = i;
      }
    }
    pending_off = 0;

    // Sampled literal-entropy estimate (1/8-bit units per byte) for the
    // match-acceptance cost model: a match is only worth coding when the
    // sequence bits it costs beat the Huffman bits its bytes would take.
    int hbits8 = 64;
    {
      uint32_t shist[256] = {0};
      int scount = 0;
      for (int t = b0; t < b1; t += 4) {
        ++shist[src[t]];
        ++scount;
      }
      if (scount > 16) {
        double hsum = 0.0;
        for (int s2 = 0; s2 < 256; ++s2) {
          if (!shist[s2]) continue;
          const double p = static_cast<double>(shist[s2]) / scount;
          hsum -= p * std::log2(p);
        }
        hbits8 = static_cast<int>(hsum * 8.0 + 0.5);
        if (hbits8 < 1) hbits8 = 1;
      }
    }

    int misses = 0;
    while (i < b1 && i < mflimit) {
      uint32_t seq4;
      std::memcpy(&seq4, src + i, 4);
      const uint32_t h = ZHash4(seq4);
      const int cand = table[h];
      table[h] = i;
      uint32_t cand4 = ~seq4;
      if (cand >= 0) std::memcpy(&cand4, src + cand, 4);
      // The window cap keeps of_code <= 28 (the largest symbol in the
      // predefined offset distribution); engine blocks are far smaller.
      if (cand < 0 || i - cand >= (1 << 27) || cand4 != seq4) {
        i += 1 + (misses++ >> 6);
        continue;
      }
      const int off = i - cand;
      // Extend forward, capped at the block boundary (a sequence decodes
      // entirely within its block) and the frame match limit.
      const int lim = b1 < matchlimit ? b1 : matchlimit;
      if (i + kZMinMatch > lim) break;  // no room before the block cut
      int mlen = kZMinMatch;
      while (i + mlen < lim && src[cand + mlen] == src[i + mlen]) ++mlen;
      // Extend backward over pending literals of this block.
      int mstart = i;
      int cstart = cand;
      const int back_lim = anchor > b0 ? anchor : b0;
      while (mstart > back_lim && cstart > 0 &&
             src[mstart - 1] == src[cstart - 1]) {
        --mstart;
        --cstart;
        ++mlen;
      }
      // Marginal-match cost model: sequence bits (~12 predefined-FSE bits
      // for the ll/ml/of symbol triple + offset extra bits) must beat the
      // entropy-coded literal bits the match displaces.  On 4-bit/byte
      // data this rejects the len-4/5 match flood that both bloated the
      // stream and defeated the miss-skip acceleration (0.08 GB/s).
      const int cost8 = 8 * (12 + (static_cast<uint32_t>(off) == last_off
                                       ? 1
                                       : HighBit(static_cast<uint32_t>(off) + 3)));
      if (mlen * hbits8 <= cost8) {
        i += 1 + (misses++ >> 6);
        continue;
      }
      misses = 0;  // reset only on ACCEPT so rejects feed skip acceleration
      seqs.push_back(EncSeq{src + anchor,
                            static_cast<uint32_t>(mstart - anchor),
                            static_cast<uint32_t>(off),
                            static_cast<uint32_t>(mlen)});
      last_off = static_cast<uint32_t>(off);
      i = mstart + mlen;
      anchor = i;
      if (i == b1 && i + 3 <= matchlimit &&
          src[i] == src[i - off] && src[i + 1] == src[i + 1 - off] &&
          src[i + 2] == src[i + 2 - off]) {
        pending_off = off;  // match continues into the next block
      }
    }

    // --- Flush block [b0, b1): header + content, raw fallback.
    const int decoded = b1 - b0;
    const bool last = b1 == src_len;
    if (d + 3 > dst_cap) return BT_ERR_CAPACITY;
    const int tll = b1 - anchor;          // trailing literals
    int csize = -1;
    // EncodeBlockContent commits rep on encode success; a raw fallback
    // below must see the pre-block state (raw blocks don't touch rep).
    const uint32_t rep_snap[3] = {rep[0], rep[1], rep[2]};
    if (!seqs.empty() || tll >= 64) {
      const int budget = (d + 3 + decoded <= dst_cap ? decoded
                                                     : dst_cap - d - 3) - 1;
      if (budget > 0) {
        csize = EncodeBlockContent(seqs, src + anchor, tll, dst + d + 3,
                                   budget, rep);
      }
    }
    if (csize > 0 && csize < decoded) {
      const uint32_t bh = static_cast<uint32_t>(last ? 1 : 0) | (2u << 1) |
                          (static_cast<uint32_t>(csize) << 3);
      dst[d] = static_cast<uint8_t>(bh);
      dst[d + 1] = static_cast<uint8_t>(bh >> 8);
      dst[d + 2] = static_cast<uint8_t>(bh >> 16);
      d += 3 + csize;
    } else {
      if (d + 3 + decoded > dst_cap) return BT_ERR_CAPACITY;
      const uint32_t bh = static_cast<uint32_t>(last ? 1 : 0) | (0u << 1) |
                          (static_cast<uint32_t>(decoded) << 3);
      dst[d] = static_cast<uint8_t>(bh);
      dst[d + 1] = static_cast<uint8_t>(bh >> 8);
      dst[d + 2] = static_cast<uint8_t>(bh >> 16);
      std::memcpy(dst + d + 3, src + b0, decoded);
      d += 3 + decoded;
      pending_off = 0;
      rep[0] = rep_snap[0]; rep[1] = rep_snap[1]; rep[2] = rep_snap[2];
      last_off = rep[0];
    }
    if (anchor < b1) anchor = b1;
    if (i < b1) i = b1;
  }
  return d;
}

}  // namespace

}  // namespace

extern "C" {

int bt_zstd_compress(const uint8_t* src, int src_len, uint8_t* dst,
                     int dst_cap) {
  if (src_len < 0 || dst_cap < 0 || (src == nullptr && src_len > 0) ||
      dst == nullptr) {
    return BT_ERR_INVALID;
  }
  return ZstdCompress(src, src_len, dst, dst_cap);
}

int bt_zstd_decompress(const uint8_t* src, int src_len, uint8_t* dst,
                       int dst_cap) {
  if (dst == nullptr || dst_cap < 0) return BT_ERR_INVALID;
  return ZstdWalk(src, src_len, dst, dst_cap, nullptr);
}

// Parse a zstd frame into the engine's SoA sequence-table shape.  Unlike
// lz4/snappy, zstd literals are entropy-coded: the decoded literal stream
// is written to lit_buf (lit_cap bytes) and lit_ptr indexes into IT, not
// into src.  Returns nseq (>= 0; *lit_used receives the literal byte
// count), or a negative status.
int bt_zstd_parse(const uint8_t* src, int src_len, int max_seq,
                  uint8_t* lit_buf, int lit_cap, int32_t* lit_used,
                  int32_t* lit_ptr, int32_t* lit_len, int32_t* off,
                  int32_t* mlen, int32_t* out_pos) {
  SeqRecorder rec;
  rec.lit_ptr = lit_ptr;
  rec.lit_len = lit_len;
  rec.off = off;
  rec.mlen = mlen;
  rec.out_pos = out_pos;
  rec.lit_buf = lit_buf;
  rec.lit_cap = lit_cap;
  rec.max_seq = max_seq;
  const int rc = ZstdWalk(src, src_len, nullptr, 1 << 30, &rec);
  if (rc < 0) return rc;
  *lit_used = rec.lit_used;
  return rec.nseq;
}

}  // extern "C"
