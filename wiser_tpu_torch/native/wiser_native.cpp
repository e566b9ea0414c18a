// Native host codecs of wiser_tpu_torch (the port's copy of the parts of
// wiser_tpu/native/wiser_native.cpp it calls): fixed-width bit packing of
// 128-value blocks (the reference's LittleIntPacker analog) and the
// linedoc chunk assembler of data/scale_corpus.py.
//
// Build: native/lib.py (g++ -O3 -shared -fPIC into .kernel_build/).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

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

}  // extern "C"

// ---------------------------------------------------------------------------
// Linedoc chunk assembler: one chunk's flat token ids -> canonical
// WITH_POSITIONS rows (body, first-occurrence-unique tokenized column,
// ";"-grouped offsets and positions), byte-identical to the JAX
// package's generator for the same draws.
// ---------------------------------------------------------------------------

namespace {

struct TermGroup {
  std::vector<int32_t> pos;
  std::vector<int64_t> off_start, off_end;
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
                            uint8_t* out, int64_t out_cap) {
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
    }
  }
  return written;
}

}  // extern "C"
