// snappy_tpu native host codec (L7, SURVEY.md §7.6).
//
// Where the reference drives native helpers (cgo islands + shelled-out
// binaries, SURVEY.md §2.2), this framework is native here: a C++
// implementation of the reference Snappy block codec (exactly the greedy
// hash-table emission our L0 oracle defines), hardware CRC-32C
// (SSE4.2 with a slice-by-8 fallback), and multithreaded framed-stream
// encode/decode for the host path.  Exposed via a plain C ABI for
// ctypes binding (no pybind11 in this image).
//
// Error codes mirror snappy_tpu.errors (0 ok; negative = error class).

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#if defined(__SSE4_2__)
#include <nmmintrin.h>
#endif

extern "C" {

// ---------------------------------------------------------------------
// error codes (keep in sync with snappy_tpu/native/__init__.py)
enum {
  SN_OK = 0,
  SN_ERR_CORRUPT = -1,
  SN_ERR_TOO_LARGE = -2,
  SN_ERR_CHECKSUM = -3,
  SN_ERR_UNSUPPORTED = -4,
  SN_ERR_BUFFER = -5,
};

// ---------------------------------------------------------------------
// CRC-32C
static uint32_t crc_table[8][256];

static void crc_init_tables() {
  for (uint32_t n = 0; n < 256; n++) {
    uint32_t c = n;
    for (int k = 0; k < 8; k++) c = (c >> 1) ^ (0x82F63B78u & (~((c & 1) - 1)));
    crc_table[0][n] = c;
  }
  for (uint32_t n = 0; n < 256; n++) {
    uint32_t c = crc_table[0][n];
    for (int k = 1; k < 8; k++) {
      c = crc_table[0][c & 0xff] ^ (c >> 8);
      crc_table[k][n] = c;
    }
  }
}

static struct CrcInit {
  CrcInit() { crc_init_tables(); }
} crc_init_once;

uint32_t sn_crc32c(const uint8_t* data, uint64_t n, uint32_t crc) {
  uint64_t i = 0;
  crc = ~crc;
#if defined(__SSE4_2__)
  uint64_t c = crc;
  while (i + 8 <= n) {
    uint64_t word;
    memcpy(&word, data + i, 8);
    c = _mm_crc32_u64(c, word);
    i += 8;
  }
  while (i < n) c = _mm_crc32_u8((uint32_t)c, data[i++]);
  return ~(uint32_t)c;
#else
  while (i + 8 <= n) {
    uint32_t lo, hi;
    memcpy(&lo, data + i, 4);
    memcpy(&hi, data + i + 4, 4);
    uint32_t c0 = crc ^ lo;
    crc = crc_table[7][c0 & 0xff] ^ crc_table[6][(c0 >> 8) & 0xff] ^
          crc_table[5][(c0 >> 16) & 0xff] ^ crc_table[4][c0 >> 24] ^
          crc_table[3][hi & 0xff] ^ crc_table[2][(hi >> 8) & 0xff] ^
          crc_table[1][(hi >> 16) & 0xff] ^ crc_table[0][hi >> 24];
    i += 8;
  }
  while (i < n) crc = crc_table[0][(crc ^ data[i++]) & 0xff] ^ (crc >> 8);
  return ~crc;
#endif
}

static inline uint32_t mask_crc(uint32_t c) {
  return (uint32_t)(((c >> 15) | (c << 17)) + 0xa282ead8u);
}

// ---------------------------------------------------------------------
// block format helpers

static inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;  // little-endian hosts only (x86/arm64)
}
static inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}

static inline void store64(uint8_t* p, uint64_t v) { memcpy(p, &v, 8); }

extern "C++" {  // templates cannot carry C linkage
// Shared validating tag walk over one block element's payload.  The
// fast loop decodes each tag from a single unaligned 64-bit load
// (s + 8 <= n makes every tag's extra bytes readable without per-byte
// bounds checks); the tail falls back to the byte-careful loop.  Sink
// supplies the data movement:
//   bool lit(uint64_t d, uint64_t s, uint64_t len)   src[s:s+len) -> out[d]
//   bool copy(uint64_t d, uint64_t off, uint64_t len) out[d-off:..) -> out[d]
//   bool finish()
// false aborts with SN_ERR_BUFFER (planner budget overflow).
template <class Sink>
static int walk_stream(const uint8_t* src, uint64_t n, uint64_t s,
                       uint64_t dst_len, Sink& sink) {
  uint64_t d = 0;
  while (s + 8 <= n) {
    uint64_t w8 = load64(src + s);
    uint32_t c = (uint32_t)w8 & 0xff;
    uint64_t length, offset;
    if ((c & 3) == 0) {
      uint32_t x = c >> 2;
      if (__builtin_expect(x < 60, 1)) {
        length = (uint64_t)x + 1;
        s += 1;
      } else {
        uint32_t nb = x - 59;  // 1..4 extra length bytes
        uint64_t ex =
            (w8 >> 8) & ((nb == 4) ? 0xffffffffull : ((1ull << (8 * nb)) - 1));
        length = ex + 1;
        s += 1 + nb;
      }
      if (length > dst_len - d || length > n - s) return SN_ERR_CORRUPT;
      if (!sink.lit(d, s, length)) return SN_ERR_BUFFER;
      s += length;
      d += length;
      continue;
    } else if ((c & 3) == 1) {
      length = 4 + ((c >> 2) & 7);
      offset = ((uint64_t)(c & 0xe0) << 3) | ((w8 >> 8) & 0xff);
      s += 2;
    } else if ((c & 3) == 2) {
      length = 1 + (c >> 2);
      offset = (w8 >> 8) & 0xffff;
      s += 3;
    } else {
      length = 1 + (c >> 2);
      offset = (w8 >> 8) & 0xffffffffull;
      s += 5;
    }
    if (offset == 0 || d < offset) return SN_ERR_CORRUPT;
    if (length > dst_len - d) return SN_ERR_CORRUPT;
    if (!sink.copy(d, offset, length)) return SN_ERR_BUFFER;
    d += length;
  }
  // byte-careful tail (identical validation to the classic walk)
  while (s < n) {
    uint32_t tag = src[s] & 3;
    uint64_t length, offset;
    if (tag == 0) {
      uint32_t x = src[s] >> 2;
      if (x < 60) {
        s += 1;
      } else if (x == 60) {
        s += 2;
        if (s > n) return SN_ERR_CORRUPT;
        x = src[s - 1];
      } else if (x == 61) {
        s += 3;
        if (s > n) return SN_ERR_CORRUPT;
        x = src[s - 2] | ((uint32_t)src[s - 1] << 8);
      } else if (x == 62) {
        s += 4;
        if (s > n) return SN_ERR_CORRUPT;
        x = src[s - 3] | ((uint32_t)src[s - 2] << 8) |
            ((uint32_t)src[s - 1] << 16);
      } else {
        s += 5;
        if (s > n) return SN_ERR_CORRUPT;
        x = src[s - 4] | ((uint32_t)src[s - 3] << 8) |
            ((uint32_t)src[s - 2] << 16) | ((uint32_t)src[s - 1] << 24);
      }
      length = (uint64_t)x + 1;
      if (length > dst_len - d || length > n - s) return SN_ERR_CORRUPT;
      if (!sink.lit(d, s, length)) return SN_ERR_BUFFER;
      s += length;
      d += length;
      continue;
    } else if (tag == 1) {
      s += 2;
      if (s > n) return SN_ERR_CORRUPT;
      length = 4 + ((src[s - 2] >> 2) & 7);
      offset = ((uint64_t)(src[s - 2] & 0xe0) << 3) | src[s - 1];
    } else if (tag == 2) {
      s += 3;
      if (s > n) return SN_ERR_CORRUPT;
      length = 1 + (src[s - 3] >> 2);
      offset = src[s - 2] | ((uint64_t)src[s - 1] << 8);
    } else {
      s += 5;
      if (s > n) return SN_ERR_CORRUPT;
      length = 1 + (src[s - 5] >> 2);
      offset = src[s - 4] | ((uint64_t)src[s - 3] << 8) |
               ((uint64_t)src[s - 2] << 16) | ((uint64_t)src[s - 1] << 24);
    }
    if (offset == 0 || d < offset) return SN_ERR_CORRUPT;
    if (length > dst_len - d) return SN_ERR_CORRUPT;
    if (!sink.copy(d, offset, length)) return SN_ERR_BUFFER;
    d += length;
  }
  if (d != dst_len) return SN_ERR_CORRUPT;
  if (!sink.finish()) return SN_ERR_BUFFER;
  return SN_OK;
}
}  // extern "C++"

// Overlap-safe copy expansion with wide stores and slop.  Establishes
// a store distance >= 8 that is a multiple of the period (byte phase
// for offsets < 8), doubles the distance with full-period word writes
// until >= 32, then streams 32-byte chunks.  Every word write copies
// from exactly -dist, so bytes inside [start, end) are always correct;
// garbage lands only in the <= 31-byte slop past the write frontier and
// is overwritten by the next round or left past `end`.  Caller
// guarantees end + 31 stays inside the allocation.
static inline void copy_pattern_slop(uint8_t* dp, uint64_t offset,
                                     uint64_t len) {
  uint8_t* end = dp + len;
  if (offset < 8) {
    uint8_t* stop = dp + (len < 16 ? len : 16);
    while (dp < stop) {
      *dp = *(dp - offset);
      dp++;
    }
    if (dp == end) return;
    offset *= (8 + offset - 1) / offset;  // smallest multiple >= 8
  }
  const uint8_t* sp = dp - offset;
  while ((uint64_t)(dp - sp) < 32) {
    uint64_t dist = (uint64_t)(dp - sp);
    for (uint64_t i = 0; i < dist; i += 8) store64(dp + i, load64(sp + i));
    dp += dist;
    if (dp >= end) return;
  }
  while (dp < end) {
    store64(dp, load64(sp));
    store64(dp + 8, load64(sp + 8));
    store64(dp + 16, load64(sp + 16));
    store64(dp + 24, load64(sp + 24));
    dp += 32;
    sp += 32;
  }
}

static const int kMaxBlockSize = 65536;
static const int kInputMargin = 15;
static const int kMinNonLiteralBlockSize = 18;

static inline uint32_t hash32(uint32_t u, uint32_t shift) {
  return (u * 0x1e35a7bdu) >> shift;
}

static uint8_t* emit_literal(uint8_t* dst, const uint8_t* lit, int len) {
  int n = len - 1;
  if (n < 60) {
    *dst++ = (uint8_t)(n << 2);
  } else if (n < (1 << 8)) {
    *dst++ = 60 << 2;
    *dst++ = (uint8_t)n;
  } else if (n < (1 << 16)) {
    *dst++ = 61 << 2;
    *dst++ = (uint8_t)n;
    *dst++ = (uint8_t)(n >> 8);
  } else if (n < (1 << 24)) {
    *dst++ = 62 << 2;
    *dst++ = (uint8_t)n;
    *dst++ = (uint8_t)(n >> 8);
    *dst++ = (uint8_t)(n >> 16);
  } else {
    *dst++ = 63 << 2;
    *dst++ = (uint8_t)n;
    *dst++ = (uint8_t)(n >> 8);
    *dst++ = (uint8_t)(n >> 16);
    *dst++ = (uint8_t)((uint32_t)n >> 24);
  }
  memcpy(dst, lit, (size_t)len);
  return dst + len;
}

static uint8_t* emit_copy(uint8_t* dst, int offset, int length) {
  while (length >= 68) {
    *dst++ = (63 << 2) | 2;
    *dst++ = (uint8_t)offset;
    *dst++ = (uint8_t)(offset >> 8);
    length -= 64;
  }
  if (length > 64) {
    *dst++ = (59 << 2) | 2;
    *dst++ = (uint8_t)offset;
    *dst++ = (uint8_t)(offset >> 8);
    length -= 60;
  }
  if (length >= 12 || offset >= 2048) {
    *dst++ = (uint8_t)(((length - 1) << 2) | 2);
    *dst++ = (uint8_t)offset;
    *dst++ = (uint8_t)(offset >> 8);
  } else {
    *dst++ = (uint8_t)(((offset >> 8) << 5) | ((length - 4) << 2) | 1);
    *dst++ = (uint8_t)offset;
  }
  return dst;
}

// Reference greedy hash-table encoder for one block (the exact algorithm
// of our L0 oracle, spec/reference.py encode_block).  r4 tuning (same
// decisions, same emission byte-for-byte): thread_local table instead of
// a per-call zeroed vector, and 64-bit XOR/ctz match extension instead
// of the byte loop — measured 0.35 -> ~0.5+ GB/s/core on the corpus
// (upstream C++ snappy context: 0.59 here).
static uint8_t* encode_block(uint8_t* dst, const uint8_t* src, int len) {
  if (len < kMinNonLiteralBlockSize) return emit_literal(dst, src, len);

  uint32_t shift = 32 - 8;
  int table_size = 1 << 8;
  while (table_size < (1 << 14) && table_size < len) {
    shift--;
    table_size *= 2;
  }
  static thread_local std::vector<uint16_t> table_tls;
  if ((int)table_tls.size() < table_size) table_tls.resize(1 << 14);
  uint16_t* table = table_tls.data();
  memset(table, 0, (size_t)table_size * sizeof(uint16_t));

  int s_limit = len - kInputMargin;
  int next_emit = 0;
  int s = 1;
  uint32_t next_hash = hash32(load32(src + s), shift);

  for (;;) {
    int skip = 32;
    int next_s = s;
    int candidate = 0;
    for (;;) {
      s = next_s;
      int bytes_between = skip >> 5;
      next_s = s + bytes_between;
      skip += bytes_between;
      if (next_s > s_limit) goto emit_remainder;
      candidate = table[next_hash];
      table[next_hash] = (uint16_t)s;
      next_hash = hash32(load32(src + next_s), shift);
      if (load32(src + s) == load32(src + candidate)) break;
    }
    dst = emit_literal(dst, src + next_emit, s - next_emit);

    for (;;) {
      int base = s;
      s += 4;
      int i = candidate + 4;
      // 64-bit match extension (i < s always, so src[i..i+8) is readable
      // whenever src[s..s+8) is); identical match lengths to the byte loop
      while (s + 8 <= len) {
        uint64_t x = load64(src + i) ^ load64(src + s);
        if (x) {
          int adv = (int)(__builtin_ctzll(x) >> 3);
          s += adv;
          i += adv;
          goto ext_done;
        }
        s += 8;
        i += 8;
      }
      while (s < len && src[i] == src[s]) {
        i++;
        s++;
      }
    ext_done:
      dst = emit_copy(dst, base - candidate, s - base);
      next_emit = s;
      if (s >= s_limit) goto emit_remainder;
      uint64_t x = load64(src + s - 1);
      uint32_t prev_hash = hash32((uint32_t)x, shift);
      table[prev_hash] = (uint16_t)(s - 1);
      uint32_t curr_hash = hash32((uint32_t)(x >> 8), shift);
      candidate = table[curr_hash];
      table[curr_hash] = (uint16_t)s;
      if ((uint32_t)(x >> 8) != load32(src + candidate)) {
        next_hash = hash32((uint32_t)(x >> 16), shift);
        s++;
        break;
      }
    }
  }
emit_remainder:
  if (next_emit < len) dst = emit_literal(dst, src + next_emit, len - next_emit);
  return dst;
}

extern "C++" {
// TWO-BLOCK INTERLEAVED matcher (the encode study's winning variant,
// tools/enc_study.py).  Blocks are
// independent (separate tables, separate dst), so running two as
// round-robin lanes puts two independent dependency chains in the OoO
// window — the single-block loop is latency-bound (~5 cyc/B measured),
// not throughput-bound; measured +32% at 4 threads on this box.
// Byte-identical per block to encode_block: each lane replicates the
// exact probe/store/emit sequence (enc_study asserts; tests anchor
// sn_compress_batch to sn_compress row-for-row).
struct Lane {
  const uint8_t* src;
  uint8_t* d;
  uint16_t* tab;
  int len, s_limit, next_emit, s, next_s, skip, candidate;
  uint32_t next_hash, shift;
  int state;  // 0 = skip/probe loop, 1 = copy loop, 2 = done
};

static inline void lane_init(Lane& L, const uint8_t* src, uint8_t* dst,
                             int len, uint16_t* tab) {
  L.src = src;
  L.d = dst;
  L.tab = tab;
  L.len = len;
  L.next_emit = 0;
  if (len < kMinNonLiteralBlockSize) {
    L.d = emit_literal(L.d, src, len);
    L.state = 2;
    return;
  }
  L.shift = 32 - 8;
  int table_size = 1 << 8;
  while (table_size < (1 << 14) && table_size < len) {
    L.shift--;
    table_size *= 2;
  }
  memset(tab, 0, (size_t)table_size * sizeof(uint16_t));
  L.s_limit = len - kInputMargin;
  L.s = 1;
  L.next_hash = hash32(load32(src + 1), L.shift);
  L.skip = 32;
  L.next_s = 1;
  L.candidate = 0;
  L.state = 0;
}

static inline void lane_finish(Lane& L) {
  if (L.next_emit < L.len)
    L.d = emit_literal(L.d, L.src + L.next_emit, L.len - L.next_emit);
  L.state = 2;
}

// One probe (state 0) or one copy iteration (state 1).
static inline void lane_step(Lane& L) {
  if (L.state == 0) {
    L.s = L.next_s;
    int bytes_between = L.skip >> 5;
    L.next_s = L.s + bytes_between;
    L.skip += bytes_between;
    if (L.next_s > L.s_limit) {
      lane_finish(L);
      return;
    }
    L.candidate = L.tab[L.next_hash];
    L.tab[L.next_hash] = (uint16_t)L.s;
    L.next_hash = hash32(load32(L.src + L.next_s), L.shift);
    if (load32(L.src + L.s) == load32(L.src + L.candidate)) {
      L.d = emit_literal(L.d, L.src + L.next_emit, L.s - L.next_emit);
      L.state = 1;
    }
    return;
  }
  // state 1: one copy-loop iteration (extension + emit + transition)
  const uint8_t* src = L.src;
  int len = L.len;
  int base = L.s;
  int s = L.s + 4;
  int i = L.candidate + 4;
  while (s + 8 <= len) {
    uint64_t x = load64(src + i) ^ load64(src + s);
    if (x) {
      int adv = (int)(__builtin_ctzll(x) >> 3);
      s += adv;
      i += adv;
      goto ext_done;
    }
    s += 8;
    i += 8;
  }
  while (s < len && src[i] == src[s]) {
    i++;
    s++;
  }
ext_done:
  L.d = emit_copy(L.d, base - L.candidate, s - base);
  L.next_emit = s;
  if (s >= L.s_limit) {
    lane_finish(L);
    return;
  }
  {
    uint64_t x = load64(src + s - 1);
    uint32_t prev_hash = hash32((uint32_t)x, L.shift);
    L.tab[prev_hash] = (uint16_t)(s - 1);
    uint32_t curr_hash = hash32((uint32_t)(x >> 8), L.shift);
    L.candidate = L.tab[curr_hash];
    L.tab[curr_hash] = (uint16_t)s;
    if ((uint32_t)(x >> 8) != load32(src + L.candidate)) {
      L.next_hash = hash32((uint32_t)(x >> 16), L.shift);
      L.s = s + 1;
      L.skip = 32;
      L.next_s = L.s;
      L.state = 0;
    } else {
      L.s = s;  // stay in the copy loop with the new candidate
    }
  }
}

// Encode a PAIR of blocks in lockstep; returns each end pointer.
static inline void encode_pair_interleaved(
    const uint8_t* srcA, int lenA, uint8_t* dstA, uint8_t** endA,
    const uint8_t* srcB, int lenB, uint8_t* dstB, uint8_t** endB) {
  static thread_local std::vector<uint16_t> tA, tB;
  if (tA.size() < (1u << 14)) tA.resize(1 << 14);
  if (tB.size() < (1u << 14)) tB.resize(1 << 14);
  Lane A, B;
  lane_init(A, srcA, dstA, lenA, tA.data());
  lane_init(B, srcB, dstB, lenB, tB.data());
  while (A.state != 2 && B.state != 2) {
    lane_step(A);
    lane_step(B);
  }
  while (A.state != 2) lane_step(A);
  while (B.state != 2) lane_step(B);
  *endA = A.d;
  *endB = B.d;
}

}  // extern "C++"

uint64_t sn_max_compressed_length(uint64_t n) { return 32 + n + n / 6; }

// A/B seam for the interleaved matcher (tools/enc_study.py): set
// SN_ENC_PAIR=0 to force the plain per-block path everywhere.
static bool sn_pair_enabled() {
  static const bool on = [] {
    const char* e = getenv("SN_ENC_PAIR");
    return !(e && e[0] == '0');
  }();
  return on;
}

static uint8_t* put_uvarint(uint8_t* dst, uint64_t v) {
  while (v >= 0x80) {
    *dst++ = (uint8_t)(v) | 0x80;
    v >>= 7;
  }
  *dst++ = (uint8_t)v;
  return dst;
}

int64_t sn_compress(const uint8_t* src, uint64_t n, uint8_t* dst) {
  if (n > 0xffffffffull) return SN_ERR_TOO_LARGE;
  uint8_t* d = put_uvarint(dst, n);
  uint64_t pos = 0;
  // 64 KiB fragments are self-contained (fresh table each), so
  // consecutive PAIRS run through the interleaved matcher (+12%
  // single-thread, byte-identical); lane B emits into a thread_local
  // scratch (its dst offset depends on A's length) and is memcpy'd
  // into place — ~1 extra byte move per ~3 output bytes.
  static thread_local std::vector<uint8_t> scratchB;
  while (sn_pair_enabled() && pos + 2 * (uint64_t)kMaxBlockSize <= n) {
    if (scratchB.size() < sn_max_compressed_length(kMaxBlockSize))
      scratchB.resize(sn_max_compressed_length(kMaxBlockSize));
    uint8_t *eA, *eB;
    encode_pair_interleaved(src + pos, kMaxBlockSize, d, &eA,
                            src + pos + kMaxBlockSize, kMaxBlockSize,
                            scratchB.data(), &eB);
    size_t lenB = (size_t)(eB - scratchB.data());
    memcpy(eA, scratchB.data(), lenB);
    d = eA + lenB;
    pos += 2 * (uint64_t)kMaxBlockSize;
  }
  while (pos < n) {
    int blk = (int)((n - pos < (uint64_t)kMaxBlockSize) ? (n - pos) : kMaxBlockSize);
    d = encode_block(d, src + pos, blk);
    pos += blk;
  }
  return (int64_t)(d - dst);
}

int sn_uncompressed_length(const uint8_t* src, uint64_t n, uint64_t* out) {
  uint64_t v = 0;
  int shift = 0;
  for (int i = 0; i < 5; i++) {
    if ((uint64_t)i >= n) return SN_ERR_CORRUPT;
    uint8_t b = src[i];
    v |= (uint64_t)(b & 0x7f) << shift;
    if (!(b & 0x80)) {
      if (v > 0xffffffffull) return SN_ERR_TOO_LARGE;
      *out = v;
      return i + 1;  // header length
    }
    shift += 7;
  }
  return SN_ERR_CORRUPT;
}

// Strict validating decoder (reference error surface).
// Pure-decode sink: wide copies with slop confined to THIS element's
// output span (framed chunks decode concurrently into one buffer, so
// slop must never cross into a neighbor's region).
struct DecodeSink {
  uint8_t* dst;
  const uint8_t* src;
  uint64_t dst_len, src_len;
  inline bool lit(uint64_t d, uint64_t s, uint64_t L) {
    if (d + L + 31 < dst_len && s + L + 31 < src_len) {
      uint8_t* dp = dst + d;
      const uint8_t* sp = src + s;
      uint64_t i = 0;
      do {
        memcpy(dp + i, sp + i, 32);
        i += 32;
      } while (i < L);
    } else {
      memcpy(dst + d, src + s, (size_t)L);
    }
    return true;
  }
  inline bool copy(uint64_t d, uint64_t off, uint64_t L) {
    if (d + L + 31 < dst_len) {
      if (off >= 32) {
        uint8_t* dp = dst + d;
        const uint8_t* sp = dp - off;
        uint64_t i = 0;
        do {
          memcpy(dp + i, sp + i, 32);
          i += 32;
        } while (i < L);
      } else {
        copy_pattern_slop(dst + d, off, L);
      }
    } else if (off >= 8 && L <= off) {
      memcpy(dst + d, dst + d - off, (size_t)L);
    } else {
      for (uint64_t k = 0, p = d; k < L; k++, p++) dst[p] = dst[p - off];
    }
    return true;
  }
  inline bool finish() { return true; }
};

int sn_decode_block(const uint8_t* src, uint64_t n, uint64_t s, uint8_t* dst,
                    uint64_t dst_len) {
  DecodeSink sink{dst, src, dst_len, n};
  return walk_stream(src, n, s, dst_len, sink);
}

// Tag pre-parse for the hybrid device decoder: walk the element stream
// once (validating), emitting one fixed-width record per element:
//   rec[4*k+0] = kind        (0 literal, 1 copy)
//   rec[4*k+1] = out_len
//   rec[4*k+2] = offset      (copies) / literal byte position in src (lits)
//   rec[4*k+3] = out_start   (exclusive scan of out_len)
// Returns the element count, or a negative error.  The device kernel
// then skips tag-boundary discovery entirely (SURVEY.md §7.3.1).
extern "C++" {
struct TagRecordSink {
  int32_t* rec;
  uint64_t k, max_tags;
  inline bool lit(uint64_t d, uint64_t s, uint64_t L) {
    if (k >= max_tags) return false;
    int32_t* r = rec + 4 * k++;
    r[0] = 0;
    r[1] = (int32_t)L;
    r[2] = (int32_t)s;
    r[3] = (int32_t)d;
    return true;
  }
  inline bool copy(uint64_t d, uint64_t off, uint64_t L) {
    if (k >= max_tags) return false;
    int32_t* r = rec + 4 * k++;
    r[0] = 1;
    r[1] = (int32_t)L;
    r[2] = (int32_t)off;
    r[3] = (int32_t)d;
    return true;
  }
  inline bool finish() { return true; }
};
}  // extern "C++"

int64_t sn_parse_tags(const uint8_t* src, uint64_t n, uint64_t s,
                      uint64_t dst_len, int32_t* rec, uint64_t max_tags) {
  TagRecordSink sink{rec, 0, max_tags};
  int rc = walk_stream(src, n, s, dst_len, sink);
  if (rc != SN_OK) return rc;
  return (int64_t)sink.k;
}

int sn_decompress(const uint8_t* src, uint64_t n, uint8_t* dst, uint64_t dst_len) {
  uint64_t want = 0;
  int hdr = sn_uncompressed_length(src, n, &want);
  if (hdr < 0) return hdr;
  if (want != dst_len) return SN_ERR_BUFFER;
  return sn_decode_block(src, n, (uint64_t)hdr, dst, dst_len);
}

// ---------------------------------------------------------------------
// framed format (multithreaded over chunks)

static const uint8_t kStreamId[10] = {0xff, 0x06, 0x00, 0x00,
                                      's',  'N',  'a',  'P', 'p', 'Y'};

int64_t sn_framed_max_length(uint64_t n, uint64_t chunk) {
  if (chunk == 0 || chunk > 65536) return SN_ERR_BUFFER;
  uint64_t chunks = (n + chunk - 1) / chunk;
  return 10 + (uint64_t)(n + chunks * (8 + 8) + 64);
}

// Shared body of sn_compress_framed / sn_compress_framed_crc.
// crcs: optional per-chunk RAW CRC-32C values (e.g. computed on the
// device before the bytes left device memory) — masked here; when null the
// host computes them.  rec_lens: optional per-chunk framed-record
// lengths (header+crc+body) so callers can split the concatenated
// output back into records (the multi-host assembly contract).
// write_id: emit the 10-byte stream identifier (0 lets per-batch
// calls concatenate into one stream — framed chunks are independent).
static int64_t compress_framed_impl(const uint8_t* src, uint64_t n,
                                    uint8_t* dst, uint64_t chunk_size,
                                    int threads, const uint32_t* crcs,
                                    uint64_t* rec_lens, int write_id) {
  if (chunk_size == 0 || chunk_size > 65536) return SN_ERR_BUFFER;
  uint64_t nchunks = n ? (n + chunk_size - 1) / chunk_size : 0;
  uint64_t hdr = 0;
  if (write_id) {
    memcpy(dst, kStreamId, 10);
    hdr = 10;
  }
  if (!nchunks) return (int64_t)hdr;

  // worst case per chunk body: 8 hdr + max_compressed(chunk)
  uint64_t per = 8 + sn_max_compressed_length(chunk_size);
  std::vector<uint64_t> out_len(nchunks, 0);
  // uninitialized on purpose: a value-initialized vector memsets
  // ~76 KiB/chunk (≈8% of the whole call at 256 MB) for bytes the
  // workers overwrite anyway
  std::unique_ptr<uint8_t[]> scratch_owner(new uint8_t[per * nchunks]);
  uint8_t* const scratch = scratch_owner.get();

  int nt = threads > 0 ? threads : (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  std::atomic<uint64_t> next(0);
  // finalize one chunk: incompressible fallback + header write
  auto finish = [&](uint64_t c, uint64_t off, uint64_t len,
                    int64_t comp, uint32_t crc) {
    uint8_t* out = scratch + c * per;
    uint8_t type = 0x00;
    uint64_t body;
    if (comp < 0 || (uint64_t)comp >= len - len / 8) {
      type = 0x01;
      memcpy(out + 8, src + off, len);
      body = len + 4;
    } else {
      body = (uint64_t)comp + 4;
    }
    out[0] = type;
    out[1] = (uint8_t)body;
    out[2] = (uint8_t)(body >> 8);
    out[3] = (uint8_t)(body >> 16);
    out[4] = (uint8_t)crc;
    out[5] = (uint8_t)(crc >> 8);
    out[6] = (uint8_t)(crc >> 16);
    out[7] = (uint8_t)(crc >> 24);
    out_len[c] = 4 + body;
  };
  // Workers take chunk PAIRS: the two bodies land in independent scratch
  // slots, so the interleaved matcher runs with no scratch copy
  // (byte-identical emission; see encode_pair_interleaved).
  const bool pair_on = sn_pair_enabled();
  auto worker = [&]() {
    for (;;) {
      uint64_t c = next.fetch_add(2);
      if (c >= nchunks) break;
      uint64_t c2 = c + 1;
      uint64_t off = c * chunk_size;
      uint64_t len = (n - off < chunk_size) ? (n - off) : chunk_size;
      if (pair_on && c2 < nchunks) {
        uint64_t off2 = c2 * chunk_size;
        uint64_t len2 =
            (n - off2 < chunk_size) ? (n - off2) : chunk_size;
        if (len >= 1 && len <= (uint64_t)kMaxBlockSize && len2 >= 1 &&
            len2 <= (uint64_t)kMaxBlockSize) {
          uint8_t* outA = scratch + c * per + 8;
          uint8_t* outB = scratch + c2 * per + 8;
          uint32_t crcA = mask_crc(crcs ? crcs[c]
                                        : sn_crc32c(src + off, len, 0));
          uint32_t crcB = mask_crc(crcs ? crcs[c2]
                                        : sn_crc32c(src + off2, len2, 0));
          uint8_t* bA = put_uvarint(outA, len);
          uint8_t* bB = put_uvarint(outB, len2);
          uint8_t *eA, *eB;
          encode_pair_interleaved(src + off, (int)len, bA, &eA,
                                  src + off2, (int)len2, bB, &eB);
          finish(c, off, len, (int64_t)(eA - outA), crcA);
          finish(c2, off2, len2, (int64_t)(eB - outB), crcB);
          continue;
        }
      }
      for (uint64_t cc = c; cc <= c2 && cc < nchunks; cc++) {
        uint64_t o = cc * chunk_size;
        uint64_t l = (n - o < chunk_size) ? (n - o) : chunk_size;
        uint8_t* out = scratch + cc * per;
        uint32_t crc = mask_crc(crcs ? crcs[cc]
                                     : sn_crc32c(src + o, l, 0));
        int64_t comp = sn_compress(src + o, l, out + 8);
        finish(cc, o, l, comp, crc);
      }
    }
  };
  std::vector<std::thread> ths;
  for (int t = 0; t < nt - 1; t++) ths.emplace_back(worker);
  worker();
  for (auto& t : ths) t.join();

  // ordered assembly: offsets by prefix sum, then the compaction
  // memcpys run threaded (disjoint destinations) — serially this copy
  // was ~15% of the call on incompressible data
  std::vector<uint64_t> offs(nchunks + 1);
  offs[0] = 0;
  for (uint64_t c = 0; c < nchunks; c++) {
    offs[c + 1] = offs[c] + out_len[c];
    if (rec_lens) rec_lens[c] = out_len[c];
  }
  uint8_t* base = dst + hdr;
  if (nchunks >= 64 && nt > 1) {
    std::atomic<uint64_t> cnext(0);
    auto copier = [&]() {
      for (;;) {
        uint64_t c = cnext.fetch_add(16);
        if (c >= nchunks) break;
        uint64_t e = c + 16 < nchunks ? c + 16 : nchunks;
        for (uint64_t i = c; i < e; i++)
          memcpy(base + offs[i], scratch + i * per, out_len[i]);
      }
    };
    std::vector<std::thread> cths;
    for (int t = 0; t < nt - 1; t++) cths.emplace_back(copier);
    copier();
    for (auto& t : cths) t.join();
  } else {
    for (uint64_t c = 0; c < nchunks; c++)
      memcpy(base + offs[c], scratch + c * per, out_len[c]);
  }
  return (int64_t)(hdr + offs[nchunks]);
}

int64_t sn_compress_framed(const uint8_t* src, uint64_t n, uint8_t* dst,
                           uint64_t chunk_size, int threads) {
  return compress_framed_impl(src, n, dst, chunk_size, threads, nullptr,
                              nullptr, 1);
}

// From-device assembly entry: same framed output as sn_compress_framed
// but with per-chunk CRCs supplied by the caller (raw, unmasked — the
// device CRC graph's values) and the stream id optional so per-batch calls
// concatenate.  rec_lens (optional) receives each chunk's framed
// record length for record-oriented callers (multi-host pwrite
// assembly).
int64_t sn_compress_framed_crc(const uint8_t* src, uint64_t n,
                               uint8_t* dst, uint64_t chunk_size,
                               int threads, const uint32_t* crcs,
                               uint64_t* rec_lens, int write_id) {
  return compress_framed_impl(src, n, dst, chunk_size, threads, crcs,
                              rec_lens, write_id);
}

// Header-only scan: total uncompressed length of a framed stream
// (chunk headers carry decoded sizes — the same property the
// zero-collective multi-host decode rides).  Lets callers allocate
// the EXACT destination (e.g. an uninitialized PyBytes the decoder
// fills in place, eliding the wrapper's output copy) instead of
// guess-and-grow.  Validates what the decode scan validates; the
// decode itself re-validates everything it touches.
int64_t sn_framed_uncompressed_length(const uint8_t* src, uint64_t n,
                                      uint64_t* out_len) {
  if (n < 10 || memcmp(src, kStreamId, 10) != 0) return SN_ERR_CORRUPT;
  uint64_t pos = 10, out = 0;
  while (pos < n) {
    if (n - pos < 4) return SN_ERR_CORRUPT;
    uint8_t type = src[pos];
    uint64_t body = src[pos + 1] | ((uint64_t)src[pos + 2] << 8) |
                    ((uint64_t)src[pos + 3] << 16);
    pos += 4;
    if (n - pos < body) return SN_ERR_CORRUPT;
    if (type == 0xff) {
      if (body != 6 || memcmp(src + pos, "sNaPpY", 6) != 0)
        return SN_ERR_CORRUPT;
      pos += body;
      continue;
    }
    if (type == 0xfe || (type >= 0x80 && type <= 0xfd)) {
      pos += body;
      continue;
    }
    if (type >= 0x02 && type <= 0x7f) return SN_ERR_UNSUPPORTED;
    if (body < 4) return SN_ERR_CORRUPT;
    uint64_t payload_off = pos + 4, payload_len = body - 4;
    if (type == 0x00) {
      uint64_t want;
      int hdr = sn_uncompressed_length(src + payload_off, payload_len,
                                       &want);
      if (hdr < 0) return hdr;
      if (want > 65536) return SN_ERR_CORRUPT;
      out += want;
    } else {
      if (payload_len > 65536) return SN_ERR_CORRUPT;
      out += payload_len;
    }
    pos += body;
  }
  *out_len = out;
  return SN_OK;
}

// Two-phase framed decode: scan chunk headers (cheap), then decode
// chunks in parallel.
int64_t sn_decompress_framed(const uint8_t* src, uint64_t n, uint8_t* dst,
                             uint64_t dst_cap, int verify, int threads) {
  if (n < 10 || memcmp(src, kStreamId, 10) != 0) return SN_ERR_CORRUPT;
  struct Chunk {
    uint64_t src_off, src_len, dst_off, dst_len;
    uint8_t type;
    uint32_t crc;
  };
  std::vector<Chunk> chunks;
  uint64_t pos = 10, out = 0;
  while (pos < n) {
    if (n - pos < 4) return SN_ERR_CORRUPT;
    uint8_t type = src[pos];
    uint64_t body = src[pos + 1] | ((uint64_t)src[pos + 2] << 8) |
                    ((uint64_t)src[pos + 3] << 16);
    pos += 4;
    if (n - pos < body) return SN_ERR_CORRUPT;
    if (type == 0xff) {
      if (body != 6 || memcmp(src + pos, "sNaPpY", 6) != 0) return SN_ERR_CORRUPT;
      pos += body;
      continue;
    }
    if (type == 0xfe || (type >= 0x80 && type <= 0xfd)) {
      pos += body;
      continue;
    }
    if (type >= 0x02 && type <= 0x7f) return SN_ERR_UNSUPPORTED;
    if (body < 4) return SN_ERR_CORRUPT;
    uint32_t crc = src[pos] | ((uint32_t)src[pos + 1] << 8) |
                   ((uint32_t)src[pos + 2] << 16) | ((uint32_t)src[pos + 3] << 24);
    uint64_t payload_off = pos + 4, payload_len = body - 4;
    uint64_t dlen;
    if (type == 0x00) {
      uint64_t want;
      int hdr = sn_uncompressed_length(src + payload_off, payload_len, &want);
      if (hdr < 0) return hdr;
      if (want > 65536) return SN_ERR_CORRUPT;
      dlen = want;
    } else {
      if (payload_len > 65536) return SN_ERR_CORRUPT;
      dlen = payload_len;
    }
    if (out + dlen > dst_cap) return SN_ERR_BUFFER;
    chunks.push_back({payload_off, payload_len, out, dlen, type, crc});
    out += dlen;
    pos += body;
  }

  std::atomic<uint64_t> next(0);
  std::atomic<int> err(SN_OK);
  int nt = threads > 0 ? threads : (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  auto worker = [&]() {
    for (;;) {
      uint64_t c = next.fetch_add(1);
      if (c >= chunks.size() || err.load() != SN_OK) break;
      const Chunk& ch = chunks[c];
      if (ch.type == 0x00) {
        int rc = sn_decompress(src + ch.src_off, ch.src_len, dst + ch.dst_off,
                               ch.dst_len);
        if (rc != SN_OK) {
          err.store(rc);
          break;
        }
      } else {
        memcpy(dst + ch.dst_off, src + ch.src_off, ch.dst_len);
      }
      if (verify) {
        uint32_t got = mask_crc(sn_crc32c(dst + ch.dst_off, ch.dst_len, 0));
        if (got != ch.crc) {
          err.store(SN_ERR_CHECKSUM);
          break;
        }
      }
    }
  };
  std::vector<std::thread> ths;
  for (int t = 0; t < nt - 1; t++) ths.emplace_back(worker);
  worker();
  for (auto& t : ths) t.join();
  if (err.load() != SN_OK) return err.load();
  return (int64_t)out;
}

// Identity staging: a chunk decodes straight into a staging row of
// kPatRows x kVec bytes (one 64 KiB output image), so the device graph
// is a row slice plus the CRC and needs no plan.
namespace flatplan {
static const int kVec = 128;
static const int kPatRows = 512;

// Wide replay copies: unconditional 32-byte chunks with slop.  Bytes
// written past d+L stay inside the allocation (guarded by the callers'
// dec_cap/comp_len margins) and are either overwritten by a later tag
// or zeroed by the stager; only [0, dst_len) of the image is output.
// Tail tags without margin take the exact-length memcpy path.
static inline void replay_fwd(uint8_t* dp, const uint8_t* sp, int64_t L,
                              bool margin) {
  if (margin) {
    int64_t i = 0;
    do {
      memcpy(dp + i, sp + i, 32);
      i += 32;
    } while (i < L);
  } else {
    memcpy(dp, sp, (size_t)L);
  }
}

// One tag's LZ replay into the image at dec[d] (kind 0 = literal from
// comp[arg], kind 1 = copy at distance arg), used by the segmented
// identity stager.
static inline void replay_tag(uint8_t* dec, int64_t dec_cap,
                              const uint8_t* comp, int64_t comp_len,
                              int64_t kind, int64_t L, int64_t arg,
                              int64_t d) {
  if (kind == 0) {
    replay_fwd(dec + d, comp + arg, L,
               d + L + 32 <= dec_cap && arg + L + 32 <= comp_len);
  } else if (arg >= 32 && arg >= L) {
    // non-overlapping at wide stride: slop reads land on already-
    // written image bytes or in-allocation garbage, both fine
    replay_fwd(dec + d, dec + d - arg, L, d + L + 32 <= dec_cap);
  } else if (d + L + 31 < dec_cap) {
    copy_pattern_slop(dec + d, arg, L);
  } else if (arg >= L) {
    memcpy(dec + d, dec + d - arg, (size_t)L);
  } else {
    // overlapping copy: extend the period-arg pattern by doubling;
    // each memcpy starts at a multiple of arg, so phases line up
    uint8_t* base = dec + d - arg;
    int64_t have = arg, done = 0;
    while (done < L) {
      int64_t t2 = have < L - done ? have : L - done;
      memcpy(dec + d + done, base, (size_t)t2);
      done += t2;
      have += t2;
    }
  }
}
}  // namespace flatplan

extern "C++" {
// Segmented resume walk over one RAW stream (the identity seg
// stager's parser): decodes exactly seg_len output bytes,
// resuming and re-saving straddling literal/copy state.  Sink
// supplies the data movement:
//   bool lit(int64_t take, int64_t src_pos, int64_t drel)
//   bool copy(int64_t take, int64_t off, int64_t drel)
// (false aborts with SN_ERR_BUFFER).
// Copy offsets past the 64 KiB carry are format-legal but not
// plannable per segment -> SN_ERR_BUFFER (host decoder instead).
//   state: int64[6] = {s, d, lit_src, lit_rem, copy_off, copy_rem}
// On SN_OK the state is advanced past the segment.
template <class S>
static int walk_seg(const uint8_t* src, uint64_t n, uint64_t dst_total,
                    int64_t* state, int64_t seg_len, S& sink) {
  uint64_t s = (uint64_t)state[0];
  int64_t d0 = state[1];
  int64_t lit_src = state[2], lit_rem = state[3];
  int64_t copy_off = state[4], copy_rem = state[5];

  int64_t drel = 0;
  // resume a straddling copy (continues the same period; the replay
  // source reaches into the carry)
  if (copy_rem > 0) {
    int64_t take = copy_rem < seg_len ? copy_rem : seg_len;
    if (!sink.copy(take, copy_off, 0)) return SN_ERR_BUFFER;
    copy_rem -= take;
    drel = take;
  }
  // resume a straddling literal
  if (copy_rem == 0 && lit_rem > 0 && drel < seg_len) {
    int64_t take = lit_rem < seg_len - drel ? lit_rem : seg_len - drel;
    if (!sink.lit(take, lit_src, drel)) return SN_ERR_BUFFER;
    lit_src += take;
    lit_rem -= take;
    drel += take;
  }
  while (drel < seg_len) {
    if (s >= n) return SN_ERR_CORRUPT;
    uint32_t tag = src[s] & 3;
    uint64_t length, offset;
    if (tag == 0) {
      uint32_t x = src[s] >> 2;
      if (x < 60) {
        s += 1;
      } else if (x == 60) {
        s += 2;
        if (s > n) return SN_ERR_CORRUPT;
        x = src[s - 1];
      } else if (x == 61) {
        s += 3;
        if (s > n) return SN_ERR_CORRUPT;
        x = src[s - 2] | ((uint32_t)src[s - 1] << 8);
      } else if (x == 62) {
        s += 4;
        if (s > n) return SN_ERR_CORRUPT;
        x = src[s - 3] | ((uint32_t)src[s - 2] << 8) |
            ((uint32_t)src[s - 1] << 16);
      } else {
        s += 5;
        if (s > n) return SN_ERR_CORRUPT;
        x = src[s - 4] | ((uint32_t)src[s - 3] << 8) |
            ((uint32_t)src[s - 2] << 16) | ((uint32_t)src[s - 1] << 24);
      }
      length = (uint64_t)x + 1;
      if (length > dst_total - (uint64_t)(d0 + drel)) return SN_ERR_CORRUPT;
      if (length > n - s) return SN_ERR_CORRUPT;
      int64_t take = (int64_t)length;
      if (drel + take > seg_len) {
        take = seg_len - drel;
        lit_src = (int64_t)s + take;
        lit_rem = (int64_t)length - take;
      }
      if (!sink.lit(take, (int64_t)s, drel)) return SN_ERR_BUFFER;
      s += length;
      drel += take;
      continue;
    } else if (tag == 1) {
      s += 2;
      if (s > n) return SN_ERR_CORRUPT;
      length = 4 + ((src[s - 2] >> 2) & 7);
      offset = ((uint64_t)(src[s - 2] & 0xe0) << 3) | src[s - 1];
    } else if (tag == 2) {
      s += 3;
      if (s > n) return SN_ERR_CORRUPT;
      length = 1 + (src[s - 3] >> 2);
      offset = src[s - 2] | ((uint64_t)src[s - 1] << 8);
    } else {
      s += 5;
      if (s > n) return SN_ERR_CORRUPT;
      length = 1 + (src[s - 5] >> 2);
      offset = src[s - 4] | ((uint64_t)src[s - 3] << 8) |
               ((uint64_t)src[s - 2] << 16) | ((uint64_t)src[s - 1] << 24);
    }
    if (offset == 0 || (uint64_t)(d0 + drel) < offset) return SN_ERR_CORRUPT;
    // offsets past the 64 KiB carry are format-legal (no real encoder
    // emits them): not plannable per segment — host decoder instead
    if (offset > 65536) return SN_ERR_BUFFER;
    if (length > dst_total - (uint64_t)(d0 + drel)) return SN_ERR_CORRUPT;
    int64_t take = (int64_t)length;
    if (drel + take > seg_len) {
      take = seg_len - drel;
      copy_off = (int64_t)offset;
      copy_rem = (int64_t)length - take;
    }
    if (!sink.copy(take, (int64_t)offset, drel)) return SN_ERR_BUFFER;
    drel += take;
  }
  state[0] = (int64_t)s;
  state[1] = d0 + seg_len;
  state[2] = lit_src;
  state[3] = lit_rem;
  state[4] = copy_off;
  state[5] = copy_rem;
  return SN_OK;
}
}  // extern "C++"

// Identity sink (raw streams): pure LZ replay into the segment image,
// no pieces, no payload slice — the staged row IS the output.
struct SegIdSink {
  uint8_t* dec;
  int64_t dec_cap;
  const uint8_t* comp;
  int64_t comp_len;
  inline bool lit(int64_t take, int64_t s, int64_t drel) {
    flatplan::replay_tag(dec, dec_cap, comp, comp_len, 0, take, s, drel);
    return true;
  }
  inline bool copy(int64_t take, int64_t off, int64_t drel) {
    flatplan::replay_tag(dec, dec_cap, comp, comp_len, 1, take, off, drel);
    return true;
  }
};

// Identity seg STAGE (raw streams, decompress-to-device): the resume
// walk decodes the segment straight into the carry image, and the
// staged row IS the output
// segment (b_row[0, seg_len), tail zeroed).  The device graph is a
// pure slice/concat, so this is the staging half of the raw
// decompress-to-device path (H2D carries exactly the decompressed
// bytes).  Copy offsets past the 64 KiB carry return SN_ERR_BUFFER
// (host decoder instead); state may be advanced on error returns
// (callers abandon the stream to the host decoder then).
int sn_stage_flat_dec_id_seg(const uint8_t* src, uint64_t n,
                             uint64_t dst_total, int64_t* state,
                             uint8_t* img, int64_t seg_len, int64_t rb,
                             uint8_t* b_row) {
  using namespace flatplan;
  if (seg_len > (int64_t)kPatRows * kVec) return SN_ERR_BUFFER;
  if (rb * (int64_t)kVec < seg_len) return SN_ERR_BUFFER;
  uint8_t* dec = img + 65536;
  SegIdSink sink{dec, seg_len + 64, src, (int64_t)n};
  int rc = walk_seg(src, n, dst_total, state, seg_len, sink);
  if (rc != SN_OK) return rc;
  memcpy(b_row, dec, (size_t)seg_len);
  memset(b_row + seg_len, 0, (size_t)(rb * (int64_t)kVec - seg_len));
  return SN_OK;
}

// Identity STAGE ("id" path): the validating walk decodes the element
// DIRECTLY into the staging row — no tag records, no plan, no payload
// copy.  The staged row IS the output image (bytes [0, 64Ki) of a
// 520-row panel; the 8 guard rows absorb the wide-copy slop), so the
// device decode graph is a row slice + the fused CRC, and H2D ships
// 1.016 B per output byte (docs/architecture.md).
// Returns SN_OK or SN_ERR_CORRUPT (id staging has no caps to overflow;
// SN_ERR_BUFFER only for a caller rb too small for image + slop).
int sn_stage_flat_dec_id(const uint8_t* src, uint64_t n, uint64_t s,
                         uint64_t dst_len, int64_t rb, uint8_t* b_row) {
  using flatplan::kPatRows;
  using flatplan::kVec;
  const int64_t cap = rb * (int64_t)kVec;
  if ((int64_t)dst_len > (int64_t)kPatRows * kVec) return SN_ERR_BUFFER;
  if (cap < (int64_t)kPatRows * kVec + 32) return SN_ERR_BUFFER;
  DecodeSink sink{b_row, src, (uint64_t)cap, n};
  int rc = walk_stream(src, n, s, dst_len, sink);
  if (rc != SN_OK) return rc;
  // zero the tail (short blocks) + slop/guard rows: every byte the
  // device graph slices (rows [0, 512)) is stager-written, and the
  // DMA'd guard rows are deterministic
  memset(b_row + dst_len, 0, (size_t)(cap - (int64_t)dst_len));
  return SN_OK;
}

int64_t sn_stage_flat_dec_id_batch(
    const uint8_t* elems, const int64_t* offs, const int64_t* lens,
    const int64_t* hdrs, const int64_t* dst_lens, int64_t B, int64_t rb,
    uint8_t* b_rows, int64_t* rc_out, int64_t n_threads) {
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= B) return;
      rc_out[i] = sn_stage_flat_dec_id(
          elems + offs[i], (uint64_t)lens[i], (uint64_t)hdrs[i],
          (uint64_t)dst_lens[i], rb, b_rows + i * rb * 128);
    }
  };
  if (n_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> ts;
    for (int64_t t = 0; t < n_threads; t++) ts.emplace_back(worker);
    for (auto& t : ts) t.join();
  }
  int64_t bad = 0;
  for (int64_t i = 0; i < B; i++)
    if (rc_out[i] < 0) bad++;
  return bad;
}

// Threaded block compressor (the encode half of the id path): per-row
// full elements at elem_out + i*elem_cap, clen/hdr per row.  The
// device's encode-side job is the chunk CRC-32C (GF(2) matmul) over
// the uncompressed blocks — the emission stays host-side, so nothing
// else needs staging.  rc_out rows: SN_OK or the row's SN_ERR_*.
int64_t sn_compress_batch(const uint8_t* blocks, int64_t block_stride,
                          const int64_t* lens, int64_t B,
                          uint8_t* elem_out, int64_t elem_cap,
                          int64_t* clens_out, int64_t* hdrs_out,
                          int64_t* rc_out, int64_t n_threads) {
  std::atomic<int64_t> next(0);
  auto one = [&](int64_t i) {
    uint8_t* dst = elem_out + i * elem_cap;
    if ((int64_t)sn_max_compressed_length((uint64_t)lens[i]) > elem_cap) {
      rc_out[i] = SN_ERR_BUFFER;
      return;
    }
    int64_t clen = sn_compress(blocks + i * block_stride,
                               (uint64_t)lens[i], dst);
    if (clen < 0) {
      rc_out[i] = clen;
      return;
    }
    uint64_t want = 0;
    int hdr = sn_uncompressed_length(dst, (uint64_t)clen, &want);
    if (hdr < 0) {
      rc_out[i] = hdr;
      return;
    }
    clens_out[i] = clen;
    hdrs_out[i] = hdr;
    rc_out[i] = SN_OK;
  };
  // Workers grab PAIRS and run the two-block interleaved matcher
  // (byte-identical emission; study finding: +32% under a GIL-pooled
  // caller and +6% single-thread — the loop is latency-bound and two
  // lanes fill the OoO window — but ~0% under saturated C++ threads
  // on this SMT box; kept because single-thread and partially-loaded
  // callers win and it never loses.  SN_ENC_PAIR=0 disables (A/B
  // seam).  Rows that don't fit the single-fragment fast path (len 0
  // or > 64 KiB, tight caps) take the plain per-row path.
  const bool pair_enabled = sn_pair_enabled();
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(2);
      if (i >= B) return;
      int64_t j = i + 1 < B ? i + 1 : -1;
      bool pair =
          pair_enabled &&
          j >= 0 && lens[i] > 0 && lens[i] <= kMaxBlockSize &&
          lens[j] > 0 && lens[j] <= kMaxBlockSize &&
          (int64_t)sn_max_compressed_length((uint64_t)lens[i]) <=
              elem_cap &&
          (int64_t)sn_max_compressed_length((uint64_t)lens[j]) <=
              elem_cap;
      if (!pair) {
        one(i);
        if (j >= 0) one(j);
        continue;
      }
      uint8_t* di = elem_out + i * elem_cap;
      uint8_t* dj = elem_out + j * elem_cap;
      uint8_t* bi = put_uvarint(di, (uint64_t)lens[i]);
      uint8_t* bj = put_uvarint(dj, (uint64_t)lens[j]);
      uint8_t *ei, *ej;
      encode_pair_interleaved(
          blocks + i * block_stride, (int)lens[i], bi, &ei,
          blocks + j * block_stride, (int)lens[j], bj, &ej);
      clens_out[i] = (int64_t)(ei - di);
      hdrs_out[i] = (int64_t)(bi - di);
      clens_out[j] = (int64_t)(ej - dj);
      hdrs_out[j] = (int64_t)(bj - dj);
      rc_out[i] = SN_OK;
      rc_out[j] = SN_OK;
    }
  };
  if (n_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> ts;
    for (int64_t t = 0; t < n_threads; t++) ts.emplace_back(worker);
    for (auto& t : ts) t.join();
  }
  int64_t bad = 0;
  for (int64_t i = 0; i < B; i++)
    if (rc_out[i] < 0) bad++;
  return bad;
}

// ---------------------------------------------------------------------
// Encode-rate study (the per-core ceiling of the matcher).  Variant
// clones of encode_block used ONLY by tools/enc_study.py; variant 0
// must stay byte-identical to encode_block (the tool asserts it), and
// any variant that changes table handling must preserve the exact
// probe/store sequence so the emitted bytes cannot drift.
//
//   0  baseline clone (identity anchor + clone-overhead check)
//   1  no-emit: identical control flow + table traffic, dst writes
//      suppressed (isolates emission/memcpy cost)
//   2  epoch-tagged u32 table: no per-block memset (stale entries read
//      as candidate 0, exactly the zeroed-table semantics)
//   9  stats: counts probes / copies / literal+copy bytes / extension
//      steps (separate variant so the hot variants stay clean)

extern "C++" {
namespace encstudy {

template <bool EMIT>
static inline uint8_t* st_emit_literal(uint8_t* dst, const uint8_t* lit,
                                       int len) {
  if (EMIT) return emit_literal(dst, lit, len);
  int n = len - 1;
  return dst + len + (n < 60 ? 1 : n < 256 ? 2 : n < 65536 ? 3 : 4);
}

template <bool EMIT>
static inline uint8_t* st_emit_copy(uint8_t* dst, int offset, int length) {
  if (EMIT) return emit_copy(dst, offset, length);
  while (length >= 68) {
    dst += 3;
    length -= 64;
  }
  if (length > 64) {
    dst += 3;
    length -= 60;
  }
  dst += (length >= 12 || offset >= 2048) ? 3 : 2;
  return dst;
}

// EPOCH=false: thread_local u16 table + per-block memset (baseline).
// EPOCH=true: u32 entries (epoch<<16 | pos); a stale epoch reads as
// candidate 0 — identical decisions, zero per-block clearing.
template <bool EMIT, bool EPOCH, bool STATS>
static uint8_t* encode_block_study(uint8_t* dst, const uint8_t* src,
                                   int len, uint32_t epoch,
                                   uint64_t* st) {
  if (len < kMinNonLiteralBlockSize)
    return st_emit_literal<EMIT>(dst, src, len);

  uint32_t shift = 32 - 8;
  int table_size = 1 << 8;
  while (table_size < (1 << 14) && table_size < len) {
    shift--;
    table_size *= 2;
  }
  static thread_local std::vector<uint16_t> t16;
  static thread_local std::vector<uint32_t> t32;
  uint16_t* tab16 = nullptr;
  uint32_t* tab32 = nullptr;
  const uint32_t etag = epoch << 16;
  if (EPOCH) {
    if (t32.size() < (1u << 14)) t32.assign(1 << 14, 0);
    if (epoch == 0) std::fill(t32.begin(), t32.end(), 0u);  // wrap
    tab32 = t32.data();
  } else {
    if (t16.size() < (1u << 14)) t16.resize(1 << 14);
    tab16 = t16.data();
    memset(tab16, 0, (size_t)table_size * sizeof(uint16_t));
  }
  auto tload = [&](uint32_t h) -> int {
    if (EPOCH) {
      uint32_t e = tab32[h];
      return (e & 0xFFFF0000u) == etag ? (int)(e & 0xFFFFu) : 0;
    }
    return tab16[h];
  };
  auto tstore = [&](uint32_t h, int pos) {
    if (EPOCH)
      tab32[h] = etag | (uint32_t)pos;
    else
      tab16[h] = (uint16_t)pos;
  };

  int s_limit = len - kInputMargin;
  int next_emit = 0;
  int s = 1;
  uint32_t next_hash = hash32(load32(src + s), shift);

  for (;;) {
    int skip = 32;
    int next_s = s;
    int candidate = 0;
    for (;;) {
      s = next_s;
      int bytes_between = skip >> 5;
      next_s = s + bytes_between;
      skip += bytes_between;
      if (next_s > s_limit) goto emit_remainder;
      candidate = tload(next_hash);
      tstore(next_hash, s);
      next_hash = hash32(load32(src + next_s), shift);
      if (STATS) st[0]++;
      if (load32(src + s) == load32(src + candidate)) break;
    }
    if (STATS) {
      st[3]++;
      st[4] += (uint64_t)(s - next_emit);
    }
    dst = st_emit_literal<EMIT>(dst, src + next_emit, s - next_emit);

    for (;;) {
      int base = s;
      s += 4;
      int i = candidate + 4;
      while (s + 8 <= len) {
        uint64_t x = load64(src + i) ^ load64(src + s);
        if (STATS) st[5]++;
        if (x) {
          int adv = (int)(__builtin_ctzll(x) >> 3);
          s += adv;
          i += adv;
          goto ext_done;
        }
        s += 8;
        i += 8;
      }
      while (s < len && src[i] == src[s]) {
        i++;
        s++;
        if (STATS) st[5]++;
      }
    ext_done:
      dst = st_emit_copy<EMIT>(dst, base - candidate, s - base);
      if (STATS) {
        st[1]++;
        st[2] += (uint64_t)(s - base);
      }
      next_emit = s;
      if (s >= s_limit) goto emit_remainder;
      uint64_t x = load64(src + s - 1);
      uint32_t prev_hash = hash32((uint32_t)x, shift);
      tstore(prev_hash, s - 1);
      uint32_t curr_hash = hash32((uint32_t)(x >> 8), shift);
      candidate = tload(curr_hash);
      tstore(curr_hash, s);
      if (STATS) st[0]++;
      if ((uint32_t)(x >> 8) != load32(src + candidate)) {
        next_hash = hash32((uint32_t)(x >> 16), shift);
        s++;
        break;
      }
    }
  }
emit_remainder:
  if (next_emit < len) {
    if (STATS) {
      st[3]++;
      st[4] += (uint64_t)(len - next_emit);
    }
    dst = st_emit_literal<EMIT>(dst, src + next_emit, len - next_emit);
  }
  return dst;
}

}  // namespace encstudy
}  // extern "C++"

// Run `variant` over nb blocks (stride-spaced, lens[] bytes each);
// writes each block's compressed length to out_lens, the emission to
// dst rows (dst_stride apart; untouched for no-emit variants), and for
// variant 9 accumulates counters into stats[8].  Returns total
// compressed bytes (computed sizes for no-emit).  GIL-free via ctypes.
int64_t sn_enc_study(const uint8_t* blocks, int64_t nb, int64_t stride,
                     const int64_t* lens, uint8_t* dst,
                     int64_t dst_stride, int64_t* out_lens,
                     int64_t variant, uint64_t* stats) {
  using namespace encstudy;
  int64_t total = 0;
  if (variant == 3) {  // two-block interleaved lanes
    int64_t b = 0;
    for (; b + 1 < nb; b += 2) {
      uint8_t *eA, *eB;
      encode_pair_interleaved(
          blocks + b * stride, (int)lens[b], dst + b * dst_stride, &eA,
          blocks + (b + 1) * stride, (int)lens[b + 1],
          dst + (b + 1) * dst_stride, &eB);
      out_lens[b] = (int64_t)(eA - (dst + b * dst_stride));
      out_lens[b + 1] = (int64_t)(eB - (dst + (b + 1) * dst_stride));
      total += out_lens[b] + out_lens[b + 1];
    }
    if (b < nb) {  // odd tail: baseline
      uint8_t* d = dst + b * dst_stride;
      uint8_t* end = encode_block_study<true, false, false>(
          d, blocks + b * stride, (int)lens[b], 0, nullptr);
      out_lens[b] = (int64_t)(end - d);
      total += out_lens[b];
    }
    return total;
  }
  for (int64_t b = 0; b < nb; b++) {
    const uint8_t* src = blocks + b * stride;
    uint8_t* d = dst + b * dst_stride;
    int len = (int)lens[b];
    uint8_t* end;
    switch (variant) {
      case 1:
        end = encode_block_study<false, false, false>(d, src, len, 0,
                                                      nullptr);
        break;
      case 2:
        end = encode_block_study<true, true, false>(
            d, src, len, (uint32_t)((b & 0xFFFF) ? (b & 0xFFFF) : 0),
            nullptr);
        break;
      case 9:
        end = encode_block_study<true, false, true>(d, src, len, 0,
                                                    (uint64_t*)stats);
        break;
      default:
        end = encode_block_study<true, false, false>(d, src, len, 0,
                                                     nullptr);
    }
    out_lens[b] = (int64_t)(end - d);
    total += out_lens[b];
  }
  return total;
}

}  // extern "C"
