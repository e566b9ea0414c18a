// Native host codecs of wiser_tpu_torch (the port's copy of the parts of
// wiser_tpu/native/wiser_native.cpp it calls): libbloom's murmur2
// (libbloom/murmur2/MurmurHash2.c) with the bloom-column key hashing of
// the index builder, fixed-width bit packing of 128-value blocks (the
// reference's LittleIntPacker analog), the varint codec of the oracle
// dump, the LZ4 block codec of the doc store and the linedoc chunk
// assembler of data/scale_corpus.py.
//
// Build: native/lib.py (g++ -O3 -shared -fPIC into .kernel_build/).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// murmur2 (32-bit, little-endian): MurmurHash2 by Austin Appleby, the
// variant libbloom uses (seed mixing, m=0x5bd1e995, r=24).
// ---------------------------------------------------------------------------

uint32_t wiser_murmur2(const void* key, int len, uint32_t seed) {
  const uint32_t m = 0x5bd1e995;
  const int r = 24;
  uint32_t h = seed ^ (uint32_t)len;
  const unsigned char* data = (const unsigned char*)key;
  while (len >= 4) {
    uint32_t k;
    memcpy(&k, data, 4);
    k *= m;
    k ^= k >> r;
    k *= m;
    h *= m;
    h ^= k;
    data += 4;
    len -= 4;
  }
  switch (len) {
    case 3: h ^= (uint32_t)data[2] << 16; [[fallthrough]];
    case 2: h ^= (uint32_t)data[1] << 8;  [[fallthrough]];
    case 1: h ^= data[0]; h *= m;
  }
  h ^= h >> 13;
  h *= m;
  h ^= h >> 15;
  return h;
}

// Batch murmur2 over n keys blob[starts[i], ends[i]) with one seed.
void wiser_murmur2_batch(const uint8_t* blob, const int64_t* starts,
                         const int64_t* ends, int64_t n, uint32_t seed,
                         uint32_t* out) {
  for (int64_t i = 0; i < n; i++) {
    out[i] = wiser_murmur2(blob + starts[i], (int)(ends[i] - starts[i]), seed);
  }
}

// Per-key seeds: libbloom's double hash needs b = murmur2(key, a), where a
// is the key's first hash (bloom.c:57-58).
void wiser_murmur2_batch_seeded(const uint8_t* blob, const int64_t* starts,
                                const int64_t* ends, int64_t n,
                                const uint32_t* seeds, uint32_t* out) {
  for (int64_t i = 0; i < n; i++) {
    out[i] = wiser_murmur2(blob + starts[i], (int)(ends[i] - starts[i]),
                           seeds[i]);
  }
}

// One chunk's phrase-neighbor column (the per-doc columns joined): groups
// end with '!', one group per token entry; the keys of a group are
// separated by ' ' (Python's str.split(" ") semantics: an empty key
// between two spaces is a key); a trailing empty piece after the last '!'
// is not a group. For every key writes a = murmur2(key, seed_a),
// b = murmur2(key, a) and entry_base + its group index. Returns the key
// count, -1 if more than `cap` keys, -2 if the group count is not
// n_entries.
int64_t wiser_bloom_col_hash(const uint8_t* col, int64_t n, int64_t n_entries,
                             int32_t entry_base, uint32_t seed_a, int64_t cap,
                             uint32_t* a, uint32_t* b, int32_t* entry_of) {
  int64_t n_keys = 0, g = 0, gs = 0;
  auto emit = [&](int64_t s, int64_t e) -> bool {
    if (n_keys >= cap) return false;
    uint32_t ha = wiser_murmur2(col + s, (int)(e - s), seed_a);
    a[n_keys] = ha;
    b[n_keys] = wiser_murmur2(col + s, (int)(e - s), ha);
    entry_of[n_keys] = entry_base + (int32_t)g;
    n_keys++;
    return true;
  };
  auto group = [&](int64_t s, int64_t e) -> bool {
    if (s == e) return true;  // an empty group has no keys
    int64_t ks = s;
    for (int64_t i = s; i < e; i++) {
      if (col[i] == ' ') {
        if (!emit(ks, i)) return false;
        ks = i + 1;
      }
    }
    return emit(ks, e);
  };
  for (int64_t i = 0; i < n; i++) {
    if (col[i] == '!') {
      if (!group(gs, i)) return -1;
      g++;
      gs = i + 1;
    }
  }
  if (gs < n) {  // a last group without its closing '!'
    if (!group(gs, n)) return -1;
    g++;
  }
  return g == n_entries ? n_keys : -2;
}

// Set every key's bloom bits in its posting's filter row: bit
// x_i = (uint32)(a + i*b) % bits for i < n_hashes (bloom.c:57-66), in the
// little-endian uint32 row `rows + row[k] * n_words`.
void wiser_bloom_set_bits(const uint32_t* a, const uint32_t* b,
                          const int64_t* row, int64_t n_keys, int n_hashes,
                          uint32_t bits, int n_words, uint32_t* rows) {
  for (int64_t k = 0; k < n_keys; k++) {
    uint32_t* r = rows + row[k] * n_words;
    for (int i = 0; i < n_hashes; i++) {
      uint32_t x = (a[k] + (uint32_t)i * b[k]) % bits;
      r[x >> 5] |= 1u << (x & 31);
    }
  }
}

// ---------------------------------------------------------------------------
// Fixed-width bit packing of 128-value blocks: value i occupies bits
// [i*width, (i+1)*width) of a little-endian bit stream of 4*width words.
// ---------------------------------------------------------------------------

void wiser_pack128(const uint32_t* vals, int width, uint32_t* out /*4*width*/) {
  memset(out, 0, sizeof(uint32_t) * 4 * width);
  uint64_t bitpos = 0;
  for (int i = 0; i < 128; i++, bitpos += width) {
    uint64_t w = bitpos >> 5;
    uint32_t off = (uint32_t)(bitpos & 31);
    uint64_t v = (uint64_t)vals[i] << off;
    out[w] |= (uint32_t)(v & 0xFFFFFFFFu);
    if (off + width > 32) out[w + 1] |= (uint32_t)(v >> 32);
  }
}

void wiser_unpack128(const uint32_t* words, int width, uint32_t* out /*128*/) {
  uint64_t bitpos = 0;
  uint32_t mask = (width == 32) ? 0xFFFFFFFFu : ((1u << width) - 1);
  for (int i = 0; i < 128; i++, bitpos += width) {
    uint64_t w = bitpos >> 5;
    uint32_t off = (uint32_t)(bitpos & 31);
    uint64_t lo = words[w] >> off;
    uint64_t hi = (off == 0) ? 0 : ((uint64_t)words[w + 1] << (32 - off));
    out[i] = (uint32_t)((lo | hi) & mask);
  }
}

// Pack n blocks at per-block widths; out sized 4*sum(widths). Returns
// words written.
int64_t wiser_pack_blocks(const uint32_t* vals, const uint8_t* widths,
                          int64_t n_blocks, uint32_t* out) {
  uint32_t* p = out;
  for (int64_t b = 0; b < n_blocks; b++) {
    wiser_pack128(vals + b * 128, widths[b], p);
    p += 4 * widths[b];
  }
  return p - out;
}

int64_t wiser_unpack_blocks(const uint32_t* words, const uint8_t* widths,
                            int64_t n_blocks, uint32_t* out) {
  const uint32_t* p = words;
  for (int64_t b = 0; b < n_blocks; b++) {
    wiser_unpack128(p, widths[b], out + b * 128);
    p += 4 * widths[b];
  }
  return p - words;
}

// ---------------------------------------------------------------------------
// varint (LEB128) codec over uint32 arrays: the oracle dump's posting
// stream.
// ---------------------------------------------------------------------------

// Returns the encoded byte count; out holds >= 5*n bytes.
int64_t wiser_varint_encode(const uint32_t* vals, int64_t n, uint8_t* out) {
  uint8_t* p = out;
  for (int64_t i = 0; i < n; i++) {
    uint32_t v = vals[i];
    while (v >= 0x80) {
      *p++ = (uint8_t)(v | 0x80);
      v >>= 7;
    }
    *p++ = (uint8_t)v;
  }
  return p - out;
}

// Decodes n values; returns the bytes consumed, or -1 on a truncated or
// over-long value.
int64_t wiser_varint_decode(const uint8_t* buf, int64_t buf_len, int64_t n,
                            uint32_t* out) {
  const uint8_t* p = buf;
  const uint8_t* end = buf + buf_len;
  for (int64_t i = 0; i < n; i++) {
    uint32_t v = 0;
    int shift = 0;
    while (true) {
      if (p >= end) return -1;
      uint8_t b = *p++;
      v |= (uint32_t)(b & 0x7F) << shift;
      if (!(b & 0x80)) break;
      shift += 7;
      if (shift > 31) return -1;
    }
    out[i] = v;
  }
  return p - buf;
}

// ---------------------------------------------------------------------------
// LZ4 block format (the public spec): the doc store's chunk codec. The
// same greedy single-hash matcher as the JAX package's, so both write the
// same bytes and each reads the other's stores.
// ---------------------------------------------------------------------------

static const int kMinMatch = 4;
static const int kHashLog = 16;

static inline uint32_t lz4_hash(uint32_t seq) {
  return (seq * 2654435761u) >> (32 - kHashLog);
}

static inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}

// Compress src[0..n) into dst; returns the compressed size, or -1 if
// dst_cap is too small (the worst case needs n + n/255 + 16 bytes).
int64_t wiser_lz4_compress(const uint8_t* src, int64_t n, uint8_t* dst,
                           int64_t dst_cap) {
  if (n == 0) return 0;
  std::vector<int32_t> table(1 << kHashLog, -1);
  const uint8_t* ip = src;
  const uint8_t* iend = src + n;
  // the last match starts at least 12 bytes before the end; the final 5
  // bytes are always literals
  const uint8_t* mflimit = (n >= 13) ? iend - 12 : src;
  const uint8_t* anchor = src;
  uint8_t* op = dst;
  uint8_t* oend = dst + dst_cap;

  auto emit = [&](const uint8_t* lit, int64_t lit_len, int64_t match_len,
                  int64_t offset) -> bool {
    int64_t need = 1 + lit_len + lit_len / 255 + 2 + match_len / 255 + 2;
    if (op + need > oend) return false;
    uint8_t* token = op++;
    if (lit_len >= 15) {
      *token = 0xF0;
      int64_t rest = lit_len - 15;
      while (rest >= 255) { *op++ = 255; rest -= 255; }
      *op++ = (uint8_t)rest;
    } else {
      *token = (uint8_t)(lit_len << 4);
    }
    memcpy(op, lit, lit_len);
    op += lit_len;
    if (offset == 0) return true;  // the final, literals-only sequence
    op[0] = (uint8_t)(offset & 0xFF);
    op[1] = (uint8_t)(offset >> 8);
    op += 2;
    int64_t ml = match_len - kMinMatch;
    if (ml >= 15) {
      *token |= 0x0F;
      int64_t rest = ml - 15;
      while (rest >= 255) { *op++ = 255; rest -= 255; }
      *op++ = (uint8_t)rest;
    } else {
      *token |= (uint8_t)ml;
    }
    return true;
  };

  while (ip < mflimit) {
    uint32_t h = lz4_hash(read32(ip));
    int32_t cand = table[h];
    table[h] = (int32_t)(ip - src);
    if (cand >= 0 && (ip - src) - cand <= 0xFFFF &&
        read32(src + cand) == read32(ip)) {
      const uint8_t* match = src + cand;
      const uint8_t* mend = iend - 5;  // keep the last 5 bytes literal
      int64_t len = kMinMatch;
      while (ip + len < mend && match[len] == ip[len]) len++;
      if (!emit(anchor, ip - anchor, len, ip - match)) return -1;
      ip += len;
      anchor = ip;
    } else {
      ip++;
    }
  }
  if (!emit(anchor, iend - anchor, 0, 0)) return -1;
  return op - dst;
}

// Decompress into dst, which must come out exactly dst_len bytes; returns
// dst_len, or -1 on a malformed block.
int64_t wiser_lz4_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                             int64_t dst_len) {
  const uint8_t* ip = src;
  const uint8_t* iend = src + n;
  uint8_t* op = dst;
  uint8_t* oend = dst + dst_len;
  while (ip < iend) {
    uint8_t token = *ip++;
    int64_t lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        lit += b;
      } while (b == 255);
    }
    if (ip + lit > iend || op + lit > oend) return -1;
    memcpy(op, ip, lit);
    ip += lit;
    op += lit;
    if (ip >= iend) break;  // the final sequence has no match part
    if (ip + 2 > iend) return -1;
    int64_t offset = ip[0] | ((int64_t)ip[1] << 8);
    ip += 2;
    if (offset == 0 || op - dst < offset) return -1;
    int64_t ml = token & 0x0F;
    if (ml == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        ml += b;
      } while (b == 255);
    }
    ml += kMinMatch;
    if (op + ml > oend) return -1;
    const uint8_t* match = op - offset;
    for (int64_t i = 0; i < ml; i++) op[i] = match[i];  // overlap-safe
    op += ml;
  }
  return (op == oend) ? dst_len : -1;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Linedoc chunk assembler: one chunk's flat token ids -> canonical
// WITH_POSITIONS rows (body, first-occurrence-unique tokenized column,
// ";"-grouped offsets and positions) and, with_blooms, the two
// WITH_BI_BLOOM neighbor columns (per term, the sorted unique following /
// preceding words, "!"-terminated), byte-identical to the JAX package's
// generator for the same draws.
// ---------------------------------------------------------------------------

namespace {

struct TermGroup {
  std::vector<int32_t> pos;
  std::vector<int64_t> off_start, off_end;
  std::vector<int32_t> ends_set, begins_set;  // neighbor term ids (unsorted)
};

inline void append_int(std::string& s, int64_t v) {
  char buf[24];
  int n = snprintf(buf, sizeof buf, "%lld", (long long)v);
  s.append(buf, n);
}

}  // namespace

extern "C" {

// vocab_blob/vocab_offs: concatenated word bytes + int64[n_vocab+1] offsets.
// ids: int64[total] flat token ids; bounds: int64[n_docs+1] doc boundaries.
// out/out_cap: destination buffer; returns bytes written, or -1 if the
// buffer is too small (the caller grows it and retries).
int64_t wiser_linedoc_chunk(const uint8_t* vocab_blob, const int64_t* vocab_offs,
                            int64_t n_vocab, const int64_t* ids,
                            const int64_t* bounds, int64_t n_docs,
                            int with_blooms, uint8_t* out, int64_t out_cap) {
  std::string row;
  std::vector<TermGroup> groups;
  std::vector<int32_t> uniq;
  std::vector<int32_t> slot_of(n_vocab, -1);
  std::vector<const char*> wptr(n_vocab);
  std::vector<int32_t> wlen(n_vocab);
  for (int64_t t = 0; t < n_vocab; t++) {
    wptr[t] = (const char*)vocab_blob + vocab_offs[t];
    wlen[t] = (int32_t)(vocab_offs[t + 1] - vocab_offs[t]);
  }
  int64_t written = 0;
  std::vector<std::string> neigh;  // scratch: one group's neighbor words
  for (int64_t d = 0; d < n_docs; d++) {
    const int64_t* tok = ids + bounds[d];
    int64_t n = bounds[d + 1] - bounds[d];
    row.clear();
    row += "d\t";
    // body + per-token char starts (start_i = sum of len+1 of previous)
    std::vector<int64_t> starts(n);
    int64_t cur = 0;
    for (int64_t i = 0; i < n; i++) {
      int32_t t = (int32_t)tok[i];
      starts[i] = cur;
      row.append(wptr[t], wlen[t]);
      cur += wlen[t] + 1;
      if (i + 1 < n) row += ' ';
    }
    row += '\t';
    // group by term in first-occurrence order
    uniq.clear();
    for (int64_t i = 0; i < n; i++) {
      int32_t t = (int32_t)tok[i];
      int32_t s = slot_of[t];
      if (s < 0) {
        s = (int32_t)uniq.size();
        slot_of[t] = s;
        uniq.push_back(t);
        if ((size_t)s == groups.size()) groups.emplace_back();
      }
      TermGroup& g = groups[s];
      g.pos.push_back((int32_t)i);
      g.off_start.push_back(starts[i]);
      g.off_end.push_back(starts[i] + wlen[t] - 1);  // inclusive
      if (with_blooms) {
        if (i + 1 < n) g.ends_set.push_back((int32_t)tok[i + 1]);
        if (i > 0) g.begins_set.push_back((int32_t)tok[i - 1]);
      }
    }
    // tokenized column
    for (size_t u = 0; u < uniq.size(); u++) {
      if (u) row += ' ';
      row.append(wptr[uniq[u]], wlen[uniq[u]]);
    }
    row += '\t';
    // offsets column: "a,b;c,d;." per group
    for (size_t u = 0; u < uniq.size(); u++) {
      TermGroup& g = groups[u];
      for (size_t j = 0; j < g.pos.size(); j++) {
        if (j) row += ';';
        append_int(row, g.off_start[j]);
        row += ',';
        append_int(row, g.off_end[j]);
      }
      row += ";.";
    }
    row += '\t';
    // positions column: "p1;p2;." per group
    for (size_t u = 0; u < uniq.size(); u++) {
      TermGroup& g = groups[u];
      for (size_t j = 0; j < g.pos.size(); j++) {
        if (j) row += ';';
        append_int(row, g.pos[j]);
      }
      row += ";.";
    }
    if (with_blooms) {
      for (int side = 0; side < 2; side++) {
        row += '\t';
        for (size_t u = 0; u < uniq.size(); u++) {
          TermGroup& g = groups[u];
          std::vector<int32_t>& ids_set = side ? g.begins_set : g.ends_set;
          std::sort(ids_set.begin(), ids_set.end());
          ids_set.erase(std::unique(ids_set.begin(), ids_set.end()),
                        ids_set.end());
          neigh.clear();
          for (int32_t t : ids_set) neigh.emplace_back(wptr[t], wlen[t]);
          std::sort(neigh.begin(), neigh.end());
          for (size_t j = 0; j < neigh.size(); j++) {
            if (j) row += ' ';
            row += neigh[j];
          }
          row += '!';
        }
      }
    }
    row += '\n';
    if (written + (int64_t)row.size() > out_cap) return -1;
    memcpy(out + written, row.data(), row.size());
    written += row.size();
    // reset per-doc state (only the slots used; the group vectors keep
    // their capacity)
    for (int32_t t : uniq) slot_of[t] = -1;
    for (size_t u = 0; u < uniq.size(); u++) {
      TermGroup& g = groups[u];
      g.pos.clear();
      g.off_start.clear();
      g.off_end.clear();
      g.ends_set.clear();
      g.begins_set.clear();
    }
  }
  return written;
}

}  // extern "C"
