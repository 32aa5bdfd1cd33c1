// A zstd frame decoder (RFC 8878) and crc32c / XXH64 for the host, in C++17.
//
// Built at first use by msfno_torch/utils/zstd.py with g++ and bound with
// ctypes.  It reads what Orbax / tensorstore write into a checkpoint
// directory: the OCDBT manifests and b-tree nodes, and the zarr chunks.
//
// Covered: several frames one after another and skippable frames; the frame
// header with or without a content size, a window descriptor or a single
// segment; Raw, RLE and Compressed blocks up to 128 KiB; literals that are
// Raw, RLE, Huffman-compressed (its weights direct or FSE-compressed) or
// treeless, in one or four streams; sequence tables predefined, RLE,
// FSE-compressed or repeated; the three repeat offsets; the optional XXH64
// content checksum, which is verified.  A dictionary ID is an error.
//
// The C interface returns 0 on success and -1 on a malformed input, with a
// message in the caller's buffer.

#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct DecodeError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const char* fmt, ...) {
  char buf[256];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw DecodeError(buf);
}

inline uint32_t le16(const uint8_t* p) { return uint32_t(p[0]) | uint32_t(p[1]) << 8; }
inline uint32_t le24(const uint8_t* p) { return le16(p) | uint32_t(p[2]) << 16; }
inline uint32_t le32(const uint8_t* p) { uint32_t v; memcpy(&v, p, 4); return v; }
inline uint64_t le64(const uint8_t* p) { uint64_t v; memcpy(&v, p, 8); return v; }
inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

constexpr size_t kMaxBlock = 128 * 1024;

// ------------------------------------------------------------------ XXH64

constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
inline uint64_t xmerge(uint64_t acc, uint64_t v) { return (acc ^ xround(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t len, uint64_t seed) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    for (; p + 32 <= end; p += 32) {
      v1 = xround(v1, le64(p));
      v2 = xround(v2, le64(p + 8));
      v3 = xround(v3, le64(p + 16));
      v4 = xround(v4, le64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
  } else {
    h = seed + P5;
  }
  h += len;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, le64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ uint64_t(le32(p)) * P1, 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ *p * P5, 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  return h ^ (h >> 32);
}

// ----------------------------------------------------------------- crc32c

struct Crc32cTables {
  uint32_t t[8][256];
  Crc32cTables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xff];
  }
};

uint32_t crc32c(const uint8_t* p, size_t n, uint32_t crc) {
  static const Crc32cTables tab;
  const auto& t = tab.t;
  crc = ~crc;
  for (; n >= 8; n -= 8, p += 8) {
    uint64_t v = le64(p) ^ crc;
    crc = t[7][v & 0xff] ^ t[6][(v >> 8) & 0xff] ^ t[5][(v >> 16) & 0xff] ^
          t[4][(v >> 24) & 0xff] ^ t[3][(v >> 32) & 0xff] ^ t[2][(v >> 40) & 0xff] ^
          t[1][(v >> 48) & 0xff] ^ t[0][v >> 56];
  }
  for (; n; --n, ++p) crc = (crc >> 8) ^ t[0][(crc ^ *p) & 0xff];
  return ~crc;
}

// ------------------------------------------------------------ bit readers

// Forward, least significant bit first: the FSE table descriptions.
struct ForwardBits {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;  // in bits
  uint32_t peek(int nb) const {
    uint64_t v = 0;
    size_t byte = pos >> 3;
    if (byte + 8 <= n) v = le64(p + byte);
    else if (byte < n) memcpy(&v, p + byte, n - byte);
    return uint32_t((v >> (pos & 7)) & ((1ull << nb) - 1));
  }
  void skip(int nb) { pos += nb; }
  uint32_t read(int nb) { uint32_t v = peek(nb); skip(nb); return v; }
  size_t bytes() const { return (pos + 7) >> 3; }
};

// Backward, from the last byte's end marker towards the first byte: the
// Huffman streams, the FSE-compressed weights and the sequences.  Bits
// below the start read as zeros; `pos` < 0 then says the stream overran.
struct BackwardBits {
  const uint8_t* p = nullptr;
  size_t n = 0;
  int64_t pos = 0;  // bits not yet read
  void init(const uint8_t* src, size_t size) {
    if (size == 0) fail("empty bitstream");
    if (src[size - 1] == 0) fail("bitstream without its end marker");
    p = src;
    n = size;
    pos = int64_t(size) * 8 - 8 + highbit(src[size - 1]);
  }
  uint64_t get(int64_t at, int nb) const {  // bits [at, at + nb), nb <= 56
    if (nb == 0) return 0;
    if (at < 0) {
      int keep = nb + int(at);
      return keep <= 0 ? 0 : get(0, keep) << (-at);
    }
    size_t byte = size_t(at >> 3);
    uint64_t v = 0;
    if (byte + 8 <= n) v = le64(p + byte);
    else memcpy(&v, p + byte, n - byte);
    return (v >> (at & 7)) & ((1ull << nb) - 1);
  }
  uint64_t peek(int nb) const { return get(pos - nb, nb); }
  void skip(int nb) { pos -= nb; }
  uint64_t read(int nb) { pos -= nb; return get(pos, nb); }
};

// -------------------------------------------------------------------- FSE

struct FseEntry {
  uint16_t base;  // next state = base + the next `nbits` bits
  uint8_t symbol;
  uint8_t nbits;
};

struct FseTable {
  int log = 0;
  std::vector<FseEntry> t;
  bool valid = false;
};

// RFC 8878 4.1.1: the normalized counts of a table description.  Returns
// the bytes it took; `max_sym` comes in as the largest symbol allowed and
// goes out as the largest one described.
size_t read_ncount(const uint8_t* src, size_t n, int16_t* norm, int& max_sym, int& log,
                   int max_log) {
  if (n == 0) fail("FSE table description: no bytes");
  ForwardBits b{src, n};
  log = int(b.read(4)) + 5;
  if (log > max_log) fail("FSE accuracy log %d above its limit %d", log, max_log);
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1, sym = 0;
  while (remaining > 1) {
    if (sym > max_sym) fail("FSE table description: more than %d symbols", max_sym + 1);
    int maxv = (2 * threshold - 1) - remaining;
    int count;
    int low = int(b.peek(nbits - 1));
    if (low < maxv) {
      count = low;
      b.skip(nbits - 1);
    } else {
      count = int(b.peek(nbits));
      if (count >= threshold) count -= maxv;
      b.skip(nbits);
    }
    count -= 1;
    remaining -= count < 0 ? -count : count;
    norm[sym++] = int16_t(count);
    if (count == 0) {
      for (;;) {
        int r = int(b.read(2));
        for (int i = 0; i < r; ++i) {
          if (sym > max_sym) fail("FSE table description: zeros past symbol %d", max_sym);
          norm[sym++] = 0;
        }
        if (r != 3) break;
      }
    }
    while (remaining < threshold) {
      --nbits;
      threshold >>= 1;
    }
    if (b.bytes() > n) fail("FSE table description truncated");
  }
  if (remaining != 1) fail("FSE table description: the probabilities overflow the table");
  max_sym = sym - 1;
  return b.bytes();
}

// RFC 8878 4.1.1, "FSE Table": the symbol spread and each state's update.
void build_fse(FseTable& tb, const int16_t* norm, int max_sym, int log) {
  const uint32_t size = 1u << log;
  tb.log = log;
  tb.t.assign(size, FseEntry{0, 0, 0});
  std::vector<uint32_t> next(size_t(max_sym) + 1);
  int64_t high = int64_t(size) - 1;
  for (int s = 0; s <= max_sym; ++s) {
    if (norm[s] == -1) {
      if (high < 0) fail("FSE table: too many symbols of probability below one");
      tb.t[size_t(high--)].symbol = uint8_t(s);
      next[s] = 1;
    } else {
      next[s] = uint32_t(norm[s]);
    }
  }
  const uint32_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  uint32_t pos = 0;
  for (int s = 0; s <= max_sym; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      tb.t[pos].symbol = uint8_t(s);
      do pos = (pos + step) & mask; while (int64_t(pos) > high);
    }
  }
  if (pos != 0) fail("FSE table: the symbol spread does not close");
  for (uint32_t u = 0; u < size; ++u) {
    uint32_t s = tb.t[u].symbol, ns = next[s]++;
    if (ns == 0) fail("FSE table: a state of a symbol without probability");
    int nb = log - highbit(ns);
    tb.t[u].nbits = uint8_t(nb);
    tb.t[u].base = uint16_t((ns << nb) - size);
  }
  tb.valid = true;
}

void build_rle(FseTable& tb, uint8_t symbol) {
  tb.log = 0;
  tb.t.assign(1, FseEntry{0, symbol, 0});
  tb.valid = true;
}

// ---------------------------------------------------------------- Huffman

struct HufTable {
  int log = 0;
  std::vector<uint16_t> t;  // symbol << 8 | bits
  bool valid = false;
};

// RFC 8878 4.2.1: the tree description.  Returns the bytes it took.
size_t read_huffman(const uint8_t* src, size_t n, HufTable& h) {
  if (n == 0) fail("Huffman tree description: no bytes");
  uint8_t w[256];
  int nw = 0;
  size_t used;
  const uint32_t header = src[0];
  if (header >= 128) {
    nw = int(header) - 127;
    size_t nbytes = (size_t(nw) + 1) / 2;
    if (1 + nbytes > n) fail("Huffman weights truncated");
    for (int i = 0; i < nw; ++i) {
      uint8_t b = src[1 + i / 2];
      w[i] = (i & 1) ? (b & 15) : (b >> 4);
    }
    used = 1 + nbytes;
  } else {
    size_t cs = header;
    if (cs == 0 || 1 + cs > n) fail("FSE-compressed Huffman weights truncated");
    const uint8_t* p = src + 1;
    int16_t norm[256];
    int max_sym = 255, log = 0;
    size_t th = read_ncount(p, cs, norm, max_sym, log, 6);
    if (th >= cs) fail("FSE-compressed Huffman weights: no bitstream");
    FseTable ft;
    build_fse(ft, norm, max_sym, log);
    BackwardBits b;
    b.init(p + th, cs - th);
    uint32_t s1 = uint32_t(b.read(log)), s2 = uint32_t(b.read(log));
    for (;;) {
      if (nw >= 254) fail("Huffman weights: more than 255 symbols");
      const FseEntry& e1 = ft.t[s1];
      w[nw++] = e1.symbol;
      s1 = e1.base + uint32_t(b.read(e1.nbits));
      if (b.pos < 0) {
        w[nw++] = ft.t[s2].symbol;
        break;
      }
      const FseEntry& e2 = ft.t[s2];
      w[nw++] = e2.symbol;
      s2 = e2.base + uint32_t(b.read(e2.nbits));
      if (b.pos < 0) {
        w[nw++] = ft.t[s1].symbol;
        break;
      }
    }
    used = 1 + cs;
  }
  uint32_t sum = 0;
  for (int i = 0; i < nw; ++i) {
    if (w[i] > 11) fail("Huffman weight %d above 11", int(w[i]));
    if (w[i]) sum += 1u << (w[i] - 1);
  }
  if (sum == 0) fail("Huffman weights all zero");
  const int maxbits = highbit(sum) + 1;
  if (maxbits > 11) fail("Huffman code longer than 11 bits");
  const uint32_t rest = (1u << maxbits) - sum;
  if (rest & (rest - 1)) fail("Huffman weights do not complete a power of two");
  if (nw >= 256) fail("Huffman weights: more than 256 symbols");
  w[nw++] = uint8_t(highbit(rest) + 1);
  h.log = maxbits;
  h.t.assign(size_t(1) << maxbits, 0);
  uint32_t count[13] = {0}, start[13] = {0};
  for (int i = 0; i < nw; ++i) count[w[i]]++;
  for (int wt = 1, next = 0; wt <= maxbits; ++wt) {
    start[wt] = uint32_t(next);
    next += int(count[wt] << (wt - 1));
  }
  for (int s = 0; s < nw; ++s) {
    int wt = w[s];
    if (!wt) continue;
    uint16_t e = uint16_t(s << 8 | (maxbits + 1 - wt));
    uint32_t len = 1u << (wt - 1);
    for (uint32_t k = 0; k < len; ++k) h.t[start[wt] + k] = e;
    start[wt] += len;
  }
  h.valid = true;
  return used;
}

void huffman_stream(const HufTable& h, const uint8_t* src, size_t n, uint8_t* out,
                    size_t count) {
  BackwardBits b;
  b.init(src, n);
  const int log = h.log;
  for (size_t i = 0; i < count; ++i) {
    uint16_t e = h.t[b.peek(log)];
    out[i] = uint8_t(e >> 8);
    b.skip(e & 0xff);
  }
  if (b.pos != 0) fail("Huffman stream: %lld bits left over", (long long)b.pos);
}

// -------------------------------------------------------------- sequences

const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

const uint32_t kLLBase[36] = {0,  1,  2,  3,  4,  5,  6,   7,   8,   9,    10,   11,
                              12, 13, 14, 15, 16, 18, 20,  22,  24,  28,   32,   40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384,
                              32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16,
                              17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30,
                              31, 32, 33, 34, 35, 37, 39, 41, 43, 47, 51, 59, 67, 83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771,
                              65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  1,  1,  1,  1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

// --------------------------------------------------------------- decoding

// Where the decoded bytes go: the caller's buffer, or one that grows.
struct Sink {
  uint8_t* out = nullptr;
  size_t cap = 0;
  size_t pos = 0;
  bool grow = false;
  void reserve(size_t n) {
    if (pos + n <= cap) return;
    if (!grow) fail("the decoded data exceed the %zu-byte buffer", cap);
    size_t nc = cap * 2 > pos + n ? cap * 2 : pos + n;
    if (nc < 4096) nc = 4096;
    auto* q = static_cast<uint8_t*>(realloc(out, nc));
    if (!q) fail("out of memory growing the output to %zu bytes", nc);
    out = q;
    cap = nc;
  }
};

struct FrameState {
  HufTable huf;
  FseTable ll, of, ml;
  uint64_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> lits;
};

// RFC 8878 3.1.1.3.1: returns the literals section's size.
size_t decode_literals(const uint8_t* src, size_t n, FrameState& f, const uint8_t*& lit,
                       size_t& nlit) {
  if (n == 0) fail("literals section missing");
  const int type = src[0] & 3, sf = (src[0] >> 2) & 3;
  if (type <= 1) {  // Raw or RLE
    size_t hs, regen;
    if (sf == 0 || sf == 2) {
      hs = 1;
      regen = src[0] >> 3;
    } else if (sf == 1) {
      if (n < 2) fail("literals header truncated");
      hs = 2;
      regen = (src[0] >> 4) + (size_t(src[1]) << 4);
    } else {
      if (n < 3) fail("literals header truncated");
      hs = 3;
      regen = (src[0] >> 4) + (size_t(src[1]) << 4) + (size_t(src[2]) << 12);
    }
    if (regen > kMaxBlock) fail("literals of %zu bytes exceed a block", regen);
    if (type == 0) {
      if (hs + regen > n) fail("raw literals truncated");
      lit = src + hs;
      nlit = regen;
      return hs + regen;
    }
    if (hs + 1 > n) fail("RLE literals truncated");
    f.lits.assign(regen, src[hs]);
    lit = f.lits.data();
    nlit = regen;
    return hs + 1;
  }
  size_t hs, regen, csize;
  if (sf <= 1) {
    if (n < 3) fail("literals header truncated");
    hs = 3;
    uint32_t v = le24(src);
    regen = (v >> 4) & 0x3ff;
    csize = (v >> 14) & 0x3ff;
  } else if (sf == 2) {
    if (n < 4) fail("literals header truncated");
    hs = 4;
    uint32_t v = le32(src);
    regen = (v >> 4) & 0x3fff;
    csize = (v >> 18) & 0x3fff;
  } else {
    if (n < 5) fail("literals header truncated");
    hs = 5;
    uint64_t v = le32(src) | uint64_t(src[4]) << 32;
    regen = (v >> 4) & 0x3ffff;
    csize = (v >> 22) & 0x3ffff;
  }
  if (regen > kMaxBlock) fail("literals of %zu bytes exceed a block", regen);
  if (hs + csize > n) fail("compressed literals truncated");
  const uint8_t* p = src + hs;
  size_t cn = csize;
  if (type == 2) {
    size_t th = read_huffman(p, cn, f.huf);
    if (th > cn) fail("Huffman tree description past the literals");
    p += th;
    cn -= th;
  } else if (!f.huf.valid) {
    fail("treeless literals without an earlier Huffman table");
  }
  f.lits.resize(regen);
  uint8_t* out = f.lits.data();
  if (sf == 0) {
    huffman_stream(f.huf, p, cn, out, regen);
  } else {
    if (cn < 6) fail("four-stream literals without their jump table");
    size_t s1 = le16(p), s2 = le16(p + 2), s3 = le16(p + 4);
    if (6 + s1 + s2 + s3 > cn) fail("four-stream literals: the jump table overruns");
    size_t s4 = cn - 6 - s1 - s2 - s3, seg = (regen + 3) / 4;
    if (3 * seg > regen) fail("four-stream literals shorter than four segments");
    const uint8_t* q = p + 6;
    huffman_stream(f.huf, q, s1, out, seg);
    huffman_stream(f.huf, q + s1, s2, out + seg, seg);
    huffman_stream(f.huf, q + s1 + s2, s3, out + 2 * seg, seg);
    huffman_stream(f.huf, q + s1 + s2 + s3, s4, out + 3 * seg, regen - 3 * seg);
  }
  lit = out;
  nlit = regen;
  return hs + csize;
}

size_t sequence_table(int mode, FseTable& t, const int16_t* def, int def_max, int def_log,
                      int max_sym, int max_log, const uint8_t* p, size_t n, const char* what) {
  switch (mode) {
    case 0:
      build_fse(t, def, def_max, def_log);
      return 0;
    case 1:
      if (n < 1) fail("%s: RLE symbol missing", what);
      if (p[0] > max_sym) fail("%s: RLE symbol %d above %d", what, int(p[0]), max_sym);
      build_rle(t, p[0]);
      return 1;
    case 2: {
      int16_t norm[256];
      int ms = max_sym, log = 0;
      size_t used = read_ncount(p, n, norm, ms, log, max_log);
      build_fse(t, norm, ms, log);
      return used;
    }
    default:
      if (!t.valid) fail("%s: repeat mode without an earlier table", what);
      return 0;
  }
}

void decode_compressed_block(const uint8_t* src, size_t n, FrameState& f, Sink& sink,
                             size_t frame_start) {
  const uint8_t *lit, *p = src, *end = src + n;
  size_t nlit;
  p += decode_literals(p, n, f, lit, nlit);
  if (p >= end) fail("sequences section missing");
  uint32_t nseq = p[0];
  if (nseq < 128) {
    p += 1;
  } else if (nseq < 255) {
    if (end - p < 2) fail("sequence count truncated");
    nseq = ((nseq - 128) << 8) + p[1];
    p += 2;
  } else {
    if (end - p < 3) fail("sequence count truncated");
    nseq = p[1] + (uint32_t(p[2]) << 8) + 0x7F00;
    p += 3;
  }
  if (nseq == 0) {
    if (p != end) fail("bytes after an empty sequences section");
    sink.reserve(nlit);
    memcpy(sink.out + sink.pos, lit, nlit);
    sink.pos += nlit;
    return;
  }
  if (p >= end) fail("sequence modes missing");
  const uint8_t modes = *p++;
  if (modes & 3) fail("reserved bits set in the sequence modes");
  p += sequence_table(modes >> 6, f.ll, kLLDefault, 35, 6, 35, 9, p, size_t(end - p),
                      "literal lengths");
  p += sequence_table((modes >> 4) & 3, f.of, kOFDefault, 28, 5, 31, 8, p, size_t(end - p),
                      "offsets");
  p += sequence_table((modes >> 2) & 3, f.ml, kMLDefault, 52, 6, 52, 9, p, size_t(end - p),
                      "match lengths");
  if (p >= end) fail("sequences bitstream missing");
  BackwardBits b;
  b.init(p, size_t(end - p));
  uint32_t sll = uint32_t(b.read(f.ll.log)), sof = uint32_t(b.read(f.of.log)),
           sml = uint32_t(b.read(f.ml.log));
  const uint8_t* lend = lit + nlit;
  for (uint32_t i = 0; i < nseq; ++i) {
    const FseEntry &el = f.ll.t[sll], &eo = f.of.t[sof], &em = f.ml.t[sml];
    const uint32_t ofc = eo.symbol, llc = el.symbol, mlc = em.symbol;
    if (ofc > 31 || llc > 35 || mlc > 52) fail("sequence code out of range");
    const uint64_t ov = (uint64_t(1) << ofc) + b.read(int(ofc));
    const size_t ml = kMLBase[mlc] + b.read(kMLBits[mlc]);
    const size_t ll = kLLBase[llc] + b.read(kLLBits[llc]);
    uint64_t off;
    if (ov > 3) {
      off = ov - 3;
      f.rep[2] = f.rep[1];
      f.rep[1] = f.rep[0];
      f.rep[0] = off;
    } else {
      const int idx = int(ov) - 1 + (ll == 0 ? 1 : 0);
      if (idx == 0) {
        off = f.rep[0];
      } else {
        off = idx == 3 ? f.rep[0] - 1 : f.rep[idx];
        if (idx > 1) f.rep[2] = f.rep[1];
        f.rep[1] = f.rep[0];
        f.rep[0] = off;
      }
    }
    if (i + 1 < nseq) {
      sll = el.base + uint32_t(b.read(el.nbits));
      sml = em.base + uint32_t(b.read(em.nbits));
      sof = eo.base + uint32_t(b.read(eo.nbits));
    }
    if (b.pos < 0) fail("sequences bitstream overrun");
    if (ll > size_t(lend - lit)) fail("a sequence takes more literals than remain");
    sink.reserve(ll + ml);
    memcpy(sink.out + sink.pos, lit, ll);
    sink.pos += ll;
    lit += ll;
    if (off == 0 || off > sink.pos - frame_start)
      fail("match offset %llu beyond the %zu bytes decoded", (unsigned long long)off,
           sink.pos - frame_start);
    uint8_t* d = sink.out + sink.pos;
    const uint8_t* s = d - off;
    if (off >= ml) {
      memcpy(d, s, ml);
    } else {
      for (size_t k = 0; k < ml; ++k) d[k] = s[k];
    }
    sink.pos += ml;
  }
  if (b.pos != 0) fail("sequences bitstream: %lld bits left over", (long long)b.pos);
  const size_t rest = size_t(lend - lit);
  sink.reserve(rest);
  memcpy(sink.out + sink.pos, lit, rest);
  sink.pos += rest;
}

// One frame starting at src (its magic already checked); returns its size.
size_t decode_frame(const uint8_t* src, size_t n, Sink& sink) {
  const uint8_t* p = src + 4;
  const uint8_t* end = src + n;
  if (p >= end) fail("frame header truncated");
  const uint8_t fhd = *p++;
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1,
            dict_flag = fhd & 3;
  if (fhd & 0x08) fail("reserved bit set in the frame header");
  uint64_t window = 0;
  if (!single) {
    if (p >= end) fail("frame header truncated");
    const uint8_t wd = *p++;
    const uint64_t base = uint64_t(1) << (10 + (wd >> 3));
    window = base + (base / 8) * (wd & 7);
  }
  static const int kDictBytes[4] = {0, 1, 2, 4};
  const int db = kDictBytes[dict_flag];
  if (end - p < db) fail("frame header truncated");
  uint32_t dict_id = 0;
  for (int i = 0; i < db; ++i) dict_id |= uint32_t(p[i]) << (8 * i);
  p += db;
  if (dict_id != 0) fail("dictionary ID %u: frames that need a dictionary are not supported",
                         dict_id);
  const int fcs_bytes = fcs_flag == 0 ? single : (1 << fcs_flag);
  if (end - p < fcs_bytes) fail("frame header truncated");
  uint64_t fcs = 0;
  for (int i = 0; i < fcs_bytes; ++i) fcs |= uint64_t(p[i]) << (8 * i);
  if (fcs_bytes == 2) fcs += 256;
  p += fcs_bytes;
  if (single) window = fcs;
  const size_t block_max = window < kMaxBlock ? size_t(window) : kMaxBlock;
  // a block of 4 bytes (an RLE block) decodes to at most 128 KiB
  if (fcs_bytes && fcs / kMaxBlock > n)
    fail("frame content size %llu beyond what %zu bytes can hold", (unsigned long long)fcs, n);
  const size_t frame_start = sink.pos;
  if (fcs_bytes) sink.reserve(size_t(fcs));
  FrameState f;
  for (;;) {
    if (end - p < 3) fail("block header truncated");
    const uint32_t bh = le24(p);
    p += 3;
    const int last = bh & 1, type = (bh >> 1) & 3;
    const size_t size = bh >> 3;
    if (type == 3) fail("reserved block type");
    if (size > block_max) fail("block of %zu bytes above the frame's maximum %zu", size,
                               block_max);
    if (type == 1) {
      if (p >= end) fail("RLE block truncated");
      sink.reserve(size);
      memset(sink.out + sink.pos, *p, size);
      sink.pos += size;
      p += 1;
    } else {
      if (size_t(end - p) < size) fail("block truncated: %zu of %zu bytes", size_t(end - p),
                                       size);
      if (type == 0) {
        sink.reserve(size);
        memcpy(sink.out + sink.pos, p, size);
        sink.pos += size;
      } else {
        const size_t before = sink.pos;
        decode_compressed_block(p, size, f, sink, frame_start);
        if (sink.pos - before > block_max) fail("a block decodes past the frame's maximum");
      }
      p += size;
    }
    if (last) break;
  }
  const size_t produced = sink.pos - frame_start;
  if (fcs_bytes && produced != fcs)
    fail("frame decodes to %zu bytes, its header says %llu", produced,
         (unsigned long long)fcs);
  if (checksum) {
    if (end - p < 4) fail("content checksum truncated");
    const uint32_t want = le32(p);
    const uint32_t got = uint32_t(xxh64(sink.out + frame_start, produced, 0));
    if (want != got) fail("content checksum mismatch: %08x, the data give %08x", want, got);
    p += 4;
  }
  return size_t(p - src);
}

void decode_all(const uint8_t* src, size_t n, Sink& sink) {
  if (n == 0) fail("no zstd frame in an empty input");
  size_t pos = 0;
  while (pos < n) {
    if (n - pos < 4) fail("trailing %zu bytes are not a frame", n - pos);
    const uint32_t magic = le32(src + pos);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      if (n - pos < 8) fail("skippable frame truncated");
      const uint32_t sz = le32(src + pos + 4);
      if (sz > n - pos - 8) fail("skippable frame truncated");
      pos += 8 + size_t(sz);
      continue;
    }
    if (magic != 0xFD2FB528u) fail("not a zstd frame: magic %08x at byte %zu", magic, pos);
    pos += decode_frame(src + pos, n - pos, sink);
  }
}

int report(const std::exception& e, char* err, size_t errcap) {
  if (err && errcap) snprintf(err, errcap, "%s", e.what());
  return -1;
}

}  // namespace

extern "C" {

// Decode every frame of src into dst (cap bytes); *written is set to the
// bytes decoded.
int msfno_zstd_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap,
                          size_t* written, char* err, size_t errcap) {
  Sink sink;
  sink.out = dst;
  sink.cap = cap;
  try {
    decode_all(src, n, sink);
  } catch (const std::exception& e) {
    return report(e, err, errcap);
  }
  *written = sink.pos;
  return 0;
}

// Decode every frame of src into a buffer of its own (free it with
// msfno_zstd_free).
int msfno_zstd_decompress_alloc(const uint8_t* src, size_t n, uint8_t** out, size_t* written,
                                char* err, size_t errcap) {
  Sink sink;
  sink.grow = true;
  try {
    decode_all(src, n, sink);
  } catch (const std::exception& e) {
    free(sink.out);
    return report(e, err, errcap);
  }
  *out = sink.out;
  *written = sink.pos;
  return 0;
}

void msfno_zstd_free(uint8_t* p) { free(p); }

uint32_t msfno_crc32c(const uint8_t* p, size_t n, uint32_t crc) { return crc32c(p, n, crc); }

}  // extern "C"
