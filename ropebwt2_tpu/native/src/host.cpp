// Native host runtime for ropebwt2_tpu: sequence input, preprocessing,
// batching, and the serial output codecs.  These are the pieces the
// reference implements in C (kseq.h, main.c preprocessing, rld0.c, rle.h,
// crlf.c); this framework keeps them native for speed and exposes them
// to Python over a C ABI (ctypes).
//
// Implemented fresh from the formats' specifications; see the matching
// Python modules (io/seqio.py, io/preprocess.py, io/fmd.py, io/rle_codec.py,
// io/crlf.py) for the executable spec each function must agree with.

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <memory>
#include <thread>
#include <vector>
#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// nt6 alphabet
// ---------------------------------------------------------------------------

static uint8_t nt6_tab[256];
static bool nt6_init_done = false;
static void nt6_init() {
  if (nt6_init_done) return;
  memset(nt6_tab, 5, 256);
  nt6_tab[0] = 0;  // seq_nt6_table[0] == 0 (reference main.c:17)
  const char *bases = "ACGT";
  for (int i = 0; i < 4; ++i) {
    nt6_tab[(uint8_t)bases[i]] = (uint8_t)(i + 1);
    nt6_tab[(uint8_t)(bases[i] + 32)] = (uint8_t)(i + 1);
  }
  nt6_init_done = true;
}

// ---------------------------------------------------------------------------
// buffered gz line reader + FASTA/FASTQ records (kseq-equivalent)
// ---------------------------------------------------------------------------

struct Reader {
  gzFile fp = nullptr;
  std::string pending;   // pushed-back header line
  bool has_pending = false;
  bool eof = false;
  int line_mode = 0;
  std::string seq, qual; // current record scratch
  std::string carry_seq, carry_qual;  // record that overflowed last batch
  bool has_carry = false;
  // kstream-quirk emulation state (see next_record)
  int64_t nbytes = 0;    // decompressed bytes consumed
  bool last_nl = false;  // stream (so far) ends with a newline
  bool phantom_done = false;
};

static bool read_line(Reader *r, std::string *out) {
  if (r->has_pending) {
    *out = r->pending;
    r->has_pending = false;
    return true;
  }
  out->clear();
  char buf[65536];
  for (;;) {
    char *s = gzgets(r->fp, buf, sizeof(buf));
    if (s == nullptr) return !out->empty();
    size_t got = strlen(s);
    r->nbytes += (int64_t)got;
    r->last_nl = got > 0 && s[got - 1] == '\n';
    out->append(s);
    if (!out->empty() && out->back() == '\n') {
      out->pop_back();
      if (!out->empty() && out->back() == '\r') out->pop_back();
      return true;
    }
  }
}

void *rb2_open(const char *path, int line_mode) {
  nt6_init();
  Reader *r = new Reader();
  r->line_mode = line_mode;
  r->fp = (path == nullptr || strcmp(path, "-") == 0)
              ? gzdopen(0, "rb")
              : gzopen(path, "rb");
  if (r->fp == nullptr) {
    delete r;
    return nullptr;
  }
  return r;
}

void rb2_close(void *h) {
  Reader *r = (Reader *)h;
  if (r->fp) gzclose(r->fp);
  delete r;
}

// read one record into r->seq / r->qual; returns 0 at EOF, 1 otherwise
static int next_record(Reader *r) {
  std::string line;
  if (r->eof) return 0;
  r->seq.clear();
  r->qual.clear();
  if (r->line_mode) {
    if (!read_line(r, &line)) {
      // kstream boundary quirk of the reference (kseq.h:91-141): a stream
      // whose decompressed length is an exact multiple of the 16384-byte
      // kseq buffer (or an empty stream) yields ONE phantom empty line in
      // line mode — ropebwt2 inserts a lone sentinel for it.
      if (!r->phantom_done && r->nbytes % 16384 == 0 &&
          (r->nbytes == 0 || r->last_nl)) {
        r->phantom_done = true;
        return 1;  // r->seq is already clear: empty read
      }
      return 0;
    }
    size_t end = line.size();
    for (size_t i = 0; i < line.size(); ++i) {
      unsigned char ch = line[i];
      if (!isalpha(ch)) { end = i; break; }
    }
    r->seq.assign(line, 0, end);
    return 1;
  }
  // fasta/fastq
  for (;;) {  // find header
    if (!read_line(r, &line)) return 0;
    if (!line.empty() && (line[0] == '>' || line[0] == '@')) break;
  }
  bool fastq = false;
  for (;;) {
    if (!read_line(r, &line)) break;
    if (!line.empty() && (line[0] == '>' || line[0] == '@')) {
      r->pending = line;
      r->has_pending = true;
      break;
    }
    if (!line.empty() && line[0] == '+') { fastq = true; break; }
    r->seq.append(line);
  }
  if (fastq) {
    // kseq semantics (kseq.h:197-208): always consume at least one quality
    // line, then keep reading until length matches; a length mismatch is a
    // fatal parse error (kseq returns -2) and input processing stops.
    do {
      if (!read_line(r, &line)) break;
      r->qual.append(line);
    } while (r->qual.size() < r->seq.size());
    if (r->qual.size() != r->seq.size()) {
      r->eof = true;
      return 0;
    }
  }
  return 1;
}

static inline bool is_rev_same(const uint8_t *s, int64_t l) {
  if (l & 1) return false;
  for (int64_t i = 0; i < l / 2; ++i)
    if (s[i] + s[l - 1 - i] != 5) return false;
  return true;
}

// Preprocess one record (already nt6-encoded, reversed in `work`) per the
// reference pipeline; append insertion-oriented NUL-terminated strings to
// out. Returns bytes appended.
static int64_t emit_record(std::vector<uint8_t> &work, int min_cut_len,
                           int cut_n, int trim_pal, int fwd, int rev,
                           uint8_t *out, int64_t out_cap, int64_t out_len) {
  int64_t l = (int64_t)work.size();
  if (cut_n) {
    int64_t k = 0, b = 0;
    for (int64_t i = 0; i <= l; ++i) {
      if (i == l || work[i] == 5) {
        int64_t seg = i - b;
        if (seg >= min_cut_len) {
          if (trim_pal && seg == 0) {
            // reference: is_rev_same is vacuously true for an empty segment
            // and its --k then overwrites the previous NUL — the empty
            // segment vanishes (main.c:210)
            b = i + 1;
            continue;
          }
          if (trim_pal && is_rev_same(&work[k - seg], seg)) --k;
          work[k++] = 0;
        } else {
          k -= seg;
        }
        b = i + 1;
      } else {
        work[k++] = work[i];
      }
    }
    if (--k <= 0) return 0;
    work.resize(k);
    l = k;
  }
  if (trim_pal && is_rev_same(work.data(), l)) {
    work.resize(--l);
  }
  int64_t appended = 0;
  if (fwd) {
    if (out_len + appended + l + 1 > out_cap) return -1;
    memcpy(out + out_len + appended, work.data(), l);
    out[out_len + appended + l] = 0;
    appended += l + 1;
  }
  if (rev) {
    // in-place second-strand transform: reverse + complement
    for (int64_t i = 0; i < l / 2; ++i) {
      uint8_t a = work[i], b2 = work[l - 1 - i];
      a = (a >= 1 && a <= 4) ? (uint8_t)(5 - a) : a;
      b2 = (b2 >= 1 && b2 <= 4) ? (uint8_t)(5 - b2) : b2;
      work[i] = b2;
      work[l - 1 - i] = a;
    }
    if (l & 1) {
      uint8_t a = work[l / 2];
      work[l / 2] = (a >= 1 && a <= 4) ? (uint8_t)(5 - a) : a;
    }
    if (out_len + appended + l + 1 > out_cap) return -1;
    memcpy(out + out_len + appended, work.data(), l);
    out[out_len + appended + l] = 0;
    appended += l + 1;
  }
  return appended;
}

// Fill `out` with preprocessed NUL-terminated strings until >= min_fill
// bytes or EOF. Returns bytes written (0 = EOF, -1 = record too big).
int64_t rb2_next_batch(void *h, uint8_t *out, int64_t out_cap,
                       int64_t min_fill, int min_q, int skip_n, int cut_n,
                       int min_cut_len, int trim_pal, int fwd, int rev) {
  Reader *r = (Reader *)h;
  int64_t out_len = 0;
  std::vector<uint8_t> work;
  while (out_len < min_fill) {
    if (r->has_carry) {
      r->seq = r->carry_seq;
      r->qual = r->carry_qual;
      r->has_carry = false;
    } else if (!next_record(r)) {
      break;
    }
    const std::string &seq = r->seq;
    int64_t l = (int64_t)seq.size();
    work.resize(l);
    for (int64_t i = 0; i < l; ++i)
      work[i] = ((uint8_t)seq[i] < 128) ? nt6_tab[(uint8_t)seq[i]] : 5;
    if (min_q > 0 && !r->qual.empty()) {
      for (int64_t i = 0; i < l && i < (int64_t)r->qual.size(); ++i)
        if ((int)((uint8_t)r->qual[i]) - 33 < min_q) work[i] = 5;
    }
    if (skip_n) {
      bool has_n = false;
      for (int64_t i = 0; i < l; ++i)
        if (work[i] == 5) { has_n = true; break; }
      if (has_n) continue;
    }
    for (int64_t i = 0; i < l / 2; ++i)
      std::swap(work[i], work[l - 1 - i]);  // reverse (insertion orientation)
    int64_t app = emit_record(work, min_cut_len, cut_n, trim_pal, fwd, rev,
                              out, out_cap, out_len);
    if (app < 0) {  // doesn't fit: stash the record for the next attempt
      r->carry_seq = r->seq;
      r->carry_qual = r->qual;
      r->has_carry = true;
      if (out_len == 0) return -1;  // buffer too small even empty: grow+retry
      break;
    }
    out_len += app;
  }
  return out_len;
}

// ---------------------------------------------------------------------------
// run extraction: flat int8 BWT -> (sym, len) run arrays
// ---------------------------------------------------------------------------

int64_t rb2_count_runs(const int8_t *bwt, int64_t n) {
  if (n == 0) return 0;
  int64_t r = 1;
  for (int64_t i = 1; i < n; ++i) r += (bwt[i] != bwt[i - 1]);
  return r;
}

int64_t rb2_extract_runs(const int8_t *bwt, int64_t n, uint8_t *sym,
                         int64_t *len) {
  if (n == 0) return 0;
  int64_t r = 0;
  int8_t cur = bwt[0];
  int64_t cl = 1;
  for (int64_t i = 1; i < n; ++i) {
    if (bwt[i] == cur) {
      ++cl;
    } else {
      sym[r] = (uint8_t)cur;
      len[r++] = cl;
      cur = bwt[i];
      cl = 1;
    }
  }
  sym[r] = (uint8_t)cur;
  len[r++] = cl;
  return r;
}

// ---------------------------------------------------------------------------
// FMD (rld0) streaming encoder — see io/fmd.py for the format spec
// ---------------------------------------------------------------------------

struct FmdEnc {
  static constexpr int64_t LSIZE = 1 << 23;
  int asize = 6, asize1 = 7, abits = 3, sbits = 3, ssize = 8;
  int offset0[3];
  std::vector<std::vector<uint64_t>> supers;
  uint64_t *words;
  int64_t shead = 0, p = 0, stail = 0;
  int r = 64;
  uint64_t cnt[7] = {0}, mcnt[7] = {0};
  int pc = -1;
  int64_t pl = 0;
  uint64_t n_bytes = 0, n_frames = 0;
  int ibits = 0;
  std::vector<uint64_t> frame;

  FmdEnc() {
    offset0[0] = (asize1 * 16 + 63) / 64;
    offset0[1] = (asize1 * 32 + 63) / 64;
    offset0[2] = asize1;
    supers.emplace_back(LSIZE, 0);
    words = supers.back().data();
    p = offset0[0];
    set_stail();
  }
  void set_stail() {
    stail = shead + ssize - ((shead + ssize == LSIZE) ? 2 : 1);
  }
  void next_block() {
    if (stail + 2 == LSIZE) {
      supers.emplace_back(LSIZE, 0);
      words = supers.back().data();
      shead = 0;
    } else {
      shead += ssize;
    }
    uint64_t marg[7];
    for (int i = 0; i < 7; ++i) marg[i] = cnt[i] - mcnt[i];
    int type;
    if (marg[0] < 0x4000) {
      type = 0;
      for (int i = 0; i < 7; ++i)
        words[shead + (i * 16) / 64] |= marg[i] << ((i * 16) % 64);
    } else if (marg[0] < 0x40000000) {
      type = 1;
      for (int i = 0; i < 7; ++i)
        words[shead + (i * 32) / 64] |= marg[i] << ((i * 32) % 64);
    } else {
      type = 2;
      for (int i = 0; i < 7; ++i) words[shead + i] = marg[i];
    }
    words[shead] |= (uint64_t)type << 62;
    p = shead + offset0[type];
    set_stail();
    r = 64;
    memcpy(mcnt, cnt, sizeof(cnt));
  }
  static inline int ilog2_64(uint64_t v) { return 63 - __builtin_clzll(v); }
  void enc1(int64_t l, int c) {
    int y = ilog2_64((uint64_t)l);
    int z = (y + 1) ? ilog2_64((uint64_t)(y + 1)) : 0;
    int w = (z << 1) + 1 + y + abits;
    uint64_t val = (((uint64_t)l ^ ((uint64_t)1 << y)) |
                    ((uint64_t)(y + 1) << y));
    uint64_t x = val << abits | (uint64_t)c;
    if (w >= r && p == stail) next_block();
    if (w > r) {
      w -= r;
      words[p++] |= x >> w;
      r = 64 - w;
      words[p] = x << r;
    } else {
      r -= w;
      words[p] |= x << r;
    }
    cnt[0] += (uint64_t)l;
    cnt[c + 1] += (uint64_t)l;
  }
  void enc(int64_t l, int c) {
    if (l == 0) return;
    if (pc != c) {
      if (pl) enc1(pl, pc);
      pl = l;
      pc = c;
    } else {
      pl += l;
    }
  }
  uint64_t word_at(uint64_t k) const {
    return supers[k >> 23][k & (LSIZE - 1)];
  }
  void finish() {
    if (pl) enc1(pl, pc);
    next_block();
    n_bytes = (((uint64_t)(supers.size() - 1) * LSIZE) + (uint64_t)p) * 8;
    build_frames();
  }
  void build_frames() {
    uint64_t n_blks = n_bytes * 8 / 64 / (uint64_t)ssize + 1;
    uint64_t last = (n_bytes >> 3) >> sbits << sbits;
    uint64_t avg = mcnt[0] / n_blks;
    ibits = (avg ? ilog2_64(avg) : -1) + 4;
    n_frames = ((mcnt[0] + ((uint64_t)1 << ibits) - 1) >> ibits) + 1;
    frame.assign(n_frames * asize1, 0);
    uint64_t c[6] = {0};
    uint64_t k = 1;
    for (uint64_t i = (uint64_t)ssize; i <= last; i += ssize) {
      uint64_t w0 = word_at(i);
      int type = (int)(w0 >> 62);
      if (type == 0) {
        for (int j = 1; j < 7; ++j)
          c[j - 1] += (word_at(i + (j * 16) / 64) >> ((j * 16) % 64)) & 0xFFFF;
      } else if (type == 1) {
        for (int j = 1; j < 7; ++j)
          c[j - 1] += (word_at(i + (j * 32) / 64) >> ((j * 32) % 64)) &
                      0x3FFFFFFFULL;
      } else {
        for (int j = 1; j < 7; ++j) c[j - 1] += word_at(i + j);
      }
      uint64_t sum = 0;
      for (int j = 0; j < 6; ++j) sum += c[j];
      while (sum >= (k << ibits)) ++k;
      if (k < n_frames) {
        uint64_t x = k * asize1;
        frame[x] = i;
        for (int j = 0; j < 6; ++j) frame[x + j + 1] = c[j];
      }
    }
    for (uint64_t f = 1; f < n_frames; ++f) {
      uint64_t x = f * asize1;
      if (frame[x] == 0)
        for (int j = 0; j < asize1; ++j) frame[x + j] = frame[x - asize1 + j];
    }
  }
  int dump(FILE *fp) const {
    uint32_t a = (uint32_t)asize << 16 | (uint32_t)sbits;
    uint64_t zero = 0;
    fwrite("RLD\3", 1, 4, fp);
    fwrite(&a, 4, 1, fp);
    fwrite(&zero, 8, 1, fp);
    fwrite(&n_bytes, 8, 1, fp);
    fwrite(&n_frames, 8, 1, fp);
    fwrite(mcnt + 1, 8, 6, fp);
    uint64_t nw = n_bytes / 8;
    for (size_t i = 0; i < supers.size() && nw; ++i) {
      uint64_t take = nw < (uint64_t)LSIZE ? nw : (uint64_t)LSIZE;
      fwrite(supers[i].data(), 8, take, fp);
      nw -= take;
    }
    fwrite(frame.data(), 8 * asize1, n_frames, fp);
    return 0;
  }
};

// Encode runs and write an FMD file. Returns 0 ok. Also exposes marginal
// counts via mcnt_out[7].
int rb2_fmd_write(const uint8_t *sym, const int64_t *len, int64_t n_runs,
                  const char *path, uint64_t *mcnt_out) {
  FmdEnc e;
  for (int64_t i = 0; i < n_runs; ++i) e.enc(len[i], sym[i]);
  e.finish();
  if (mcnt_out) memcpy(mcnt_out, e.mcnt, sizeof(e.mcnt));
  FILE *fp = (path == nullptr || strcmp(path, "-") == 0)
                 ? stdout
                 : fopen(path, "wb");
  if (!fp) return -1;
  e.dump(fp);
  if (fp != stdout) fclose(fp);
  else fflush(fp);
  return 0;
}

// ---------------------------------------------------------------------------
// FMR writer (rope dump) — see io/fmr.py for the format spec
// ---------------------------------------------------------------------------

static int enc_rle1(uint8_t *p, int c, int64_t l) {
  if (l < 1 << 4) {
    p[0] = (uint8_t)(l << 3 | c);
    return 1;
  } else if (l < 1 << 8) {
    p[0] = (uint8_t)(0xC0 | (l >> 6) << 3 | c);
    p[1] = (uint8_t)(0x80 | (l & 0x3F));
    return 2;
  } else if (l < 1 << 19) {
    p[0] = (uint8_t)(0xE0 | (l >> 18) << 3 | c);
    p[1] = (uint8_t)(0x80 | (l >> 12 & 0x3F));
    p[2] = (uint8_t)(0x80 | (l >> 6 & 0x3F));
    p[3] = (uint8_t)(0x80 | (l & 0x3F));
    return 4;
  }
  p[0] = (uint8_t)(0xF0 | (l >> 42) << 3 | c);
  int shift = 36;
  for (int i = 1; i < 8; ++i, shift -= 6)
    p[i] = (uint8_t)(0x80 | (l >> shift & 0x3F));
  return 8;
}

struct FmrLeaf {
  std::vector<uint8_t> payload;
  int64_t c[6] = {0};
};

// write one rope (one partition's runs) in the reference dump layout
static void write_rope(FILE *fp, const uint8_t *sym, const int64_t *len,
                       int64_t n_runs, int block_len, int max_nodes) {
  int32_t mn = max_nodes, bl = block_len;
  fwrite(&mn, 4, 1, fp);
  fwrite(&bl, 4, 1, fp);
  const int64_t cap = block_len - 18;  // RLE_MIN_SPACE headroom
  const int64_t maxlen = ((int64_t)1 << 43) - 1;
  std::vector<FmrLeaf> leaves;
  leaves.emplace_back();
  uint8_t tmp[8];
  for (int64_t i = 0; i < n_runs; ++i) {
    int64_t l = len[i];
    int c = sym[i];
    while (l > 0) {
      int64_t step = l < maxlen ? l : maxlen;
      int nb = enc_rle1(tmp, c, step);
      FmrLeaf *leaf = &leaves.back();
      if ((int64_t)leaf->payload.size() + nb > cap &&
          !leaf->payload.empty()) {
        leaves.emplace_back();
        leaf = &leaves.back();
      }
      leaf->payload.insert(leaf->payload.end(), tmp, tmp + nb);
      leaf->c[c] += step;
      l -= step;
    }
  }
  // bottom nodes: groups of <= max_nodes leaves; then internal levels
  int64_t n_leaves = (int64_t)leaves.size();
  int64_t n_bottom = (n_leaves + max_nodes - 1) / max_nodes;
  // count nodes per level upward
  std::vector<int64_t> level_counts{n_bottom};
  while (level_counts.back() > 1)
    level_counts.push_back((level_counts.back() + max_nodes - 1) / max_nodes);
  // emit preorder, recursively
  struct Emit {
    FILE *fp;
    const std::vector<FmrLeaf> &leaves;
    int max_nodes;
    int64_t n_bottom;
    void bottom(int64_t g) {
      int64_t beg = g * max_nodes;
      int64_t end = std::min<int64_t>(beg + max_nodes, (int64_t)leaves.size());
      uint8_t ib = 1;
      int16_t n = (int16_t)(end - beg);
      fwrite(&ib, 1, 1, fp);
      fwrite(&n, 2, 1, fp);
      for (int64_t i = beg; i < end; ++i) {
        fwrite(leaves[i].c, 8, 6, fp);
        uint16_t nptr = (uint16_t)leaves[i].payload.size();
        fwrite(&nptr, 2, 1, fp);
        fwrite(leaves[i].payload.data(), 1, nptr, fp);
      }
    }
    // node covering bottom groups [beg, end) at given level (0 = bottom)
    void node(int level, int64_t beg, int64_t end) {
      if (level == 0) {
        bottom(beg);
        return;
      }
      // children at level-1 each cover max_nodes^(level-1) bottom groups
      int64_t span = 1;
      for (int i = 0; i < level - 1; ++i) span *= max_nodes;
      int64_t n_children = (end - beg + span - 1) / span;
      uint8_t ib = 0;
      int16_t n = (int16_t)n_children;
      fwrite(&ib, 1, 1, fp);
      fwrite(&n, 2, 1, fp);
      for (int64_t b = beg; b < end; b += span)
        node(level - 1, b, std::min(b + span, end));
    }
  } em{fp, leaves, max_nodes, n_bottom};
  em.node((int)level_counts.size() - 1, 0, n_bottom);
}

// runs are the concatenated six partitions; part_runs[b] = #runs of
// partition b (must sum to n_runs)
int rb2_fmr_write(const uint8_t *sym, const int64_t *len,
                  const int64_t *part_runs, int so, const char *path,
                  int block_len, int max_nodes) {
  // rope_init's clamps (rope.c:59-61); the reference dump always carries
  // the clamped values
  if (block_len < 32) block_len = 32;
  block_len = (block_len + 7) >> 3 << 3;
  max_nodes = (max_nodes + 1) >> 1 << 1;
  FILE *fp = (path == nullptr || strcmp(path, "-") == 0)
                 ? stdout
                 : fopen(path, "wb");
  if (!fp) return -1;
  fwrite("RB\2", 1, 3, fp);
  uint8_t so8 = (uint8_t)so;
  fwrite(&so8, 1, 1, fp);
  int64_t off = 0;
  for (int b = 0; b < 6; ++b) {
    write_rope(fp, sym + off, len + off, part_runs[b], block_len, max_nodes);
    off += part_runs[b];
  }
  if (fp != stdout) fclose(fp);
  else fflush(fp);
  return 0;
}

// ---------------------------------------------------------------------------
// CRLF writer
// ---------------------------------------------------------------------------

int rb2_crlf_write(const uint8_t *sym, const int64_t *len, int64_t n_runs,
                   const int64_t counts[6], const char *path) {
  FILE *fp = (path == nullptr || strcmp(path, "-") == 0)
                 ? stdout
                 : fopen(path, "wb");
  if (!fp) return -1;
  fwrite("CRL\1", 1, 4, fp);
  uint8_t nsym = 6;
  fwrite(&nsym, 1, 1, fp);
  for (uint32_t x = 0; x < 256; ++x) {
    uint32_t d = (x >> 3) << 8 | (x & 7);
    fwrite(&d, 4, 1, fp);
  }
  uint32_t n_tags = 1;
  fwrite(&n_tags, 4, 1, fp);
  uint64_t tl = 48;
  fwrite("MC", 1, 2, fp);
  fwrite(&tl, 8, 1, fp);
  fwrite(counts, 8, 6, fp);
  // merge adjacent equal runs, RL53 emission; always flush a final run
  int mc = 0;
  int64_t ml = 0;
  std::vector<uint8_t> buf;
  buf.reserve(1 << 16);
  auto emit = [&](int c, int64_t l) {
    while (l > 31) {
      buf.push_back((uint8_t)(31 << 3 | c));
      l -= 31;
    }
    buf.push_back((uint8_t)(l << 3 | c));
    if (buf.size() > (1 << 16) - 64) {
      fwrite(buf.data(), 1, buf.size(), fp);
      buf.clear();
    }
  };
  for (int64_t i = 0; i < n_runs; ++i) {
    if (len[i] == 0) continue;
    if (ml > 0 && sym[i] != mc) {
      emit(mc, ml);
      mc = sym[i];
      ml = len[i];
    } else if (ml > 0) {
      ml += len[i];
    } else {
      mc = sym[i];
      ml = len[i];
    }
  }
  emit(mc, ml);
  fwrite(buf.data(), 1, buf.size(), fp);
  if (fp != stdout) fclose(fp);
  else fflush(fp);
  return 0;
}

// ---------------------------------------------------------------------------
// text BWT writer
// ---------------------------------------------------------------------------

int rb2_text_write(const int8_t *bwt, int64_t n, const char *path) {
  FILE *fp = (path == nullptr || strcmp(path, "-") == 0)
                 ? stdout
                 : fopen(path, "wb");
  if (!fp) return -1;
  static const char tab[] = "$ACGTN?";
  std::vector<char> buf(1 << 20);
  int64_t i = 0;
  while (i < n) {
    int64_t chunk = std::min<int64_t>(n - i, (int64_t)buf.size());
    for (int64_t j = 0; j < chunk; ++j) buf[j] = tab[(uint8_t)bwt[i + j]];
    fwrite(buf.data(), 1, chunk, fp);
    i += chunk;
  }
  fputc('\n', fp);
  if (fp != stdout) fclose(fp);
  else fflush(fp);
  return 0;
}

// ---------------------------------------------------------------------------
// FMD bulk decoder — the native streaming-restore path (the counterpart of
// FmdEnc above; format math dictated by rld_dec0/rld_restore,
// /root/reference/rld0.h:79-96, rld0.c:269-306).  Decodes the whole
// run-length payload of a mapped FMD file into (sym, len) arrays at memory
// bandwidth, merging adjacent equal-symbol runs.  Input is the FILE bytes
// (header included).  Returns the TOTAL run count; writes only the first
// out_cap runs (callers retry once with the exact size if the guess was
// short).  Returns -2 on a bad magic/header.
// ---------------------------------------------------------------------------

struct FmdGeom {
  const uint64_t *d;
  int asize, abits;
  int64_t ssize, offset0[3], last;
};

static bool fmd_geom(const uint8_t *file, int64_t file_bytes, FmdGeom *g) {
  if (file_bytes < 80) return false;
  const uint64_t *w = (const uint64_t *)file;
  if ((uint32_t)(w[0] & 0xffffffffu) != 0x03444c52u) return false;
  uint32_t a = (uint32_t)(w[0] >> 32);
  g->asize = (int)(a >> 16);
  int sbits = (int)(a & 0xffff);
  int asize1 = g->asize + 1;
  g->abits = 0;
  for (int v = g->asize; v; v >>= 1) ++g->abits;
  g->ssize = 1LL << sbits;
  int64_t n_bytes = (int64_t)w[2];
  const int64_t HDR = 10;
  if (HDR * 8 + n_bytes > file_bytes) return false;
  g->d = w + HDR;
  g->offset0[0] = (asize1 * 16 + 63) / 64;
  g->offset0[1] = (asize1 * 32 + 63) / 64;
  g->offset0[2] = asize1;
  g->last = ((n_bytes >> 3) >> sbits) << sbits;
  return true;
}

// decode small blocks [sh_lo, sh_hi) (word offsets into the data region,
// multiples of ssize) into sym/len, merging within the range.  Returns
// the run count; writes only the first cap runs.
static int64_t fmd_decode_range(const FmdGeom &g, int64_t sh_lo,
                                int64_t sh_hi, uint8_t *sym_out,
                                int64_t *len_out, int64_t cap) {
  static constexpr uint64_t WTAB = 0x333333335555779BULL;
  static constexpr int64_t LSIZE = 1 << 23;  // words per superblock
  const uint64_t *d = g.d;
  const int asize = g.asize, abits = g.abits;
  const int64_t ssize = g.ssize;
  int64_t nr = 0;
  int last_c = -1;
  for (int64_t shead = sh_lo; shead != sh_hi; shead += ssize) {
    int type = (int)(d[shead] >> 62);
    int64_t p = shead + g.offset0[type];
    int64_t stail =
        shead + ssize - ((((shead + ssize) & (LSIZE - 1)) == 0) ? 2 : 1);
    int r = 64;
    for (;;) {
      uint64_t x = d[p] << (64 - r);
      if (p != stail && r != 64) x |= d[p + 1] >> r;
      int wd, c;
      uint64_t y;
      if (!(x >> 63)) {
        wd = (int)((WTAB >> ((x >> 59) << 2)) & 0xF);
        if (wd == 0xB && !(x >> 58)) break;  // end-of-block padding
        int lb = (int)((x >> (64 - wd)) - 1);
        y = lb ? ((x << wd) >> (64 - lb)) | (1ULL << lb) : 1ULL;
        wd += lb;
      } else {
        wd = 1;
        y = 1;
      }
      c = (int)((x << wd) >> (64 - abits));
      wd += abits;
      if (c > asize) break;
      if (r > wd) {
        r -= wd;
      } else {
        p += 1;
        r = 64 + r - wd;
      }
      if (p > stail) break;
      if (c == last_c) {
        if (nr <= cap) len_out[nr - 1] += (int64_t)y;
      } else {
        if (nr < cap) {
          sym_out[nr] = (uint8_t)c;
          len_out[nr] = (int64_t)y;
        }
        last_c = c;
        ++nr;
      }
    }
  }
  return nr;
}

int64_t rb2_fmd_decode(const uint8_t *file, int64_t file_bytes,
                       uint8_t *sym_out, int64_t *len_out,
                       int64_t out_cap) {
  FmdGeom g;
  if (!fmd_geom(file, file_bytes, &g)) return -2;
  int T = (int)std::thread::hardware_concurrency();
  if (T < 1) T = 1;
  if (T > 16) T = 16;
  int64_t n_sblocks = g.last / g.ssize;
  if (T == 1 || n_sblocks < 4 * T) {
    return fmd_decode_range(g, 0, g.last, sym_out, len_out, out_cap);
  }
  // parallel in WAVES of T bounded chunks; per-thread scratch allocated
  // once (default-initialized, not zeroed) and sized by the HARD bound
  // of 2 runs/byte (every run costs >= 4 bits), so no overflow path is
  // needed.  Stitch = boundary merge + memcpy per chunk, in order.
  const int64_t CHUNK_WORDS = 4LL << 20;  // 32 MB of file per chunk
  int64_t chunk = ((CHUNK_WORDS + g.ssize - 1) / g.ssize) * g.ssize;
  int64_t cap = 2 * chunk * 8 + 16;
  std::vector<std::unique_ptr<uint8_t[]>> ssym(T);
  std::vector<std::unique_ptr<int64_t[]>> slen(T);
  for (int t = 0; t < T; ++t) {
    ssym[t].reset(new uint8_t[cap]);
    slen[t].reset(new int64_t[cap]);
  }
  std::vector<int64_t> cnt(T);
  int64_t nr = 0;
  int last_c = -1;
  for (int64_t base = 0; base < g.last; base += (int64_t)T * chunk) {
    std::vector<std::thread> th;
    int used = 0;
    for (int t = 0; t < T; ++t) {
      int64_t sh_lo = base + t * chunk;
      if (sh_lo >= g.last) break;
      int64_t sh_hi = sh_lo + chunk < g.last ? sh_lo + chunk : g.last;
      ++used;
      th.emplace_back([&, t, sh_lo, sh_hi]() {
        cnt[t] = fmd_decode_range(g, sh_lo, sh_hi, ssym[t].get(),
                                  slen[t].get(), cap);
      });
    }
    for (auto &x : th) x.join();
    for (int t = 0; t < used; ++t) {
      int64_t n = cnt[t];
      if (!n) continue;
      int64_t off = 0;
      if (last_c >= 0 && ssym[t][0] == (uint8_t)last_c) {
        if (nr <= out_cap) len_out[nr - 1] += slen[t][0];
        off = 1;
      }
      int64_t take = n - off;
      int64_t room = out_cap - nr;
      if (room > 0) {
        int64_t m = take < room ? take : room;
        memcpy(sym_out + nr, ssym[t].get() + off, (size_t)m);
        memcpy(len_out + nr, slen[t].get() + off, (size_t)m * 8);
      }
      nr += take;
      last_c = ssym[t][n - 1];
    }
  }
  return nr;
}

}  // extern "C"
