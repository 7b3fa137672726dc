// Native AIRR Rearrangement TSV parser.
//
// Semantics mirror the reference's streaming reader
// (/root/reference/src/db.cc:172-900) and the Python implementation in
// compairr_tpu/io/airr.py: header column discovery, per-line
// validation, residue encoding, per-file repertoire interning and
// session-wide V/J gene interning, -u/-e/-f/-g behaviours. The design
// is different from both: the file is mmap'd and parsed in place by
// N shards (one per thread, split at line boundaries), each with its
// own output arenas and open-addressing interners; an order-preserving
// merge concatenates the arenas and renumbers intern ids by global
// first-occurrence, so the result is bit-identical for every thread
// count — the analogue of the reference's -t option
// (/root/reference/src/threads.h) applied to its serial db_read.
//
// Exposed as a C ABI for ctypes. Errors are reported as (kind, lineno,
// character) tuples; the Python wrapper renders the exact reference
// message strings so formatting lives in one place.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <memory>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Interner {
  std::unordered_map<std::string, int32_t> map;
  std::vector<std::string> names;

  int32_t intern(const char* s, size_t len) {
    std::string key(s, len);
    auto it = map.find(key);
    if (it != map.end()) return it->second;
    int32_t no = static_cast<int32_t>(names.size());
    names.push_back(key);
    map.emplace(std::move(key), no);
    return no;
  }
};

// Open-addressing interner keyed on the raw token bytes — no string
// construction per lookup (the std::unordered_map<std::string, ...>
// lookup allocated on every row, ~3 allocations/row across
// repertoire/V/J in the old design).
struct TokMap {
  std::vector<int32_t> slot_id;    // -1 = empty
  std::vector<uint64_t> slot_hash;
  std::vector<std::string> names;
  uint64_t mask = 63;

  TokMap() {
    slot_id.assign(64, -1);
    slot_hash.assign(64, 0);
  }

  static uint64_t hash(const char* s, size_t len) {
    uint64_t h = 1469598103934665603ULL;
    for (size_t i = 0; i < len; i++)
      h = (h ^ (uint64_t)(uint8_t)s[i]) * 1099511628211ULL;
    return h;
  }

  void grow() {
    uint64_t nmask = mask * 2 + 1;
    std::vector<int32_t> nid(nmask + 1, -1);
    std::vector<uint64_t> nh(nmask + 1, 0);
    for (size_t j = 0; j <= mask; j++) {
      int32_t id = slot_id[j];
      if (id < 0) continue;
      uint64_t k = slot_hash[j] & nmask;
      while (nid[k] >= 0) k = (k + 1) & nmask;
      nid[k] = id;
      nh[k] = slot_hash[j];
    }
    slot_id.swap(nid);
    slot_hash.swap(nh);
    mask = nmask;
  }

  int32_t intern(const char* s, size_t len) {
    uint64_t h = hash(s, len);
    for (uint64_t j = h & mask;; j = (j + 1) & mask) {
      int32_t id = slot_id[j];
      if (id < 0) {
        int32_t no = (int32_t)names.size();
        names.emplace_back(s, len);
        slot_id[j] = no;
        slot_hash[j] = h;
        if (names.size() * 2 > mask) grow();
        return no;
      }
      if (slot_hash[j] == h && names[(size_t)id].size() == len &&
          memcmp(names[(size_t)id].data(), s, len) == 0)
        return id;
    }
  }
};

// error kinds understood by the Python wrapper
enum ErrKind : int32_t {
  ERR_NONE = 0,
  ERR_OPEN = 1,
  ERR_MISSING_COLUMNS = 2,
  ERR_ILLEGAL_CHAR = 3,
  ERR_ILLEGAL_CHAR_NONPRINT = 4,
  ERR_EMPTY_SEQ = 5,
  ERR_MISSING_SEQUENCE_ID = 6,
  ERR_BAD_DUP_COUNT = 7,
  ERR_MISSING_DUP_COUNT = 8,
  ERR_MISSING_V = 9,
  ERR_MISSING_J = 10,
  ERR_MISSING_SEQ_VALUE = 11,
  ERR_READ = 12,
};

struct Session {
  Interner v_genes;
  Interner j_genes;
};

struct StringArena {
  std::vector<int64_t> offsets{0};
  std::string blob;

  void push(const char* s, size_t len) {
    blob.append(s, len);
    offsets.push_back(static_cast<int64_t>(blob.size()));
  }
  void push_missing() { offsets.push_back(offsets.back()); }
};

struct Result {
  int32_t status = ERR_NONE;
  int64_t err_lineno = 0;
  int32_t err_char = 0;
  std::string err_detail;  // e.g. the offending duplicate_count token
  uint8_t missing_cols = 0;  // bitmask, see wrapper

  int64_t n = 0;
  std::string residues;  // flat encoded residues (pack_padded == 0)
  // pack_padded == 1: the merge writes the padded [n, lmax] row matrix
  // directly (uninitialised alloc, rows memcpy'd from the shard
  // arenas) — the consumer's separate packing pass disappears
  std::unique_ptr<char[]> packed;
  int64_t packed_lmax = -1;
  std::vector<uint64_t> row_hash;  // FNV-1a over encoded residues
  std::vector<int32_t> lengths;
  std::vector<int64_t> counts;
  std::vector<int32_t> rep_no, v_no, j_no;
  std::vector<uint8_t> has_sequence_id;
  StringArena sequence_ids;
  StringArena keeps;
  // uint32 offset tables used instead of the arenas' int64 ones when
  // the blob fits 4 GB (halves the dominant offset memory; the int64
  // vectors are then left empty and the *_offsets getters return null)
  std::vector<uint32_t> sid_off32, keep_off32;
  Interner repertoires;
  std::vector<uint8_t> keep_missing_mask;  // per keep column: 1 if absent

  int64_t ignored_unknown = 0, ignored_empty = 0;
  int64_t total_dup = 0;
  int32_t shortest = INT32_MAX, longest = 0;
};

struct Options {
  bool nucleotides, cdr3, ignore_counts, ignore_genes, ignore_unknown,
      ignore_empty, require_sequence_id;
};

void build_map(signed char* tab, bool nt) {
  memset(tab, -1, 256);
  if (nt) {
    const char* chars = "acgt";
    for (int i = 0; i < 4; i++) {
      tab[(unsigned char)chars[i]] = (signed char)i;
      tab[(unsigned char)toupper(chars[i])] = (signed char)i;
    }
    tab[(unsigned char)'u'] = 3;
    tab[(unsigned char)'U'] = 3;
  } else {
    const char* chars = "ACDEFGHIKLMNPQRSTVWY";
    for (int i = 0; i < 20; i++) {
      tab[(unsigned char)chars[i]] = (signed char)i;
      tab[(unsigned char)tolower(chars[i])] = (signed char)i;
    }
  }
}

struct Columns {
  // 1-based column numbers, 0 = absent (like db.cc:159-168)
  int repertoire_id = 0, sequence_id = 0, duplicate_count = 0;
  int v_call = 0, j_call = 0;
  int junction = 0, junction_aa = 0, cdr3 = 0, cdr3_aa = 0;
  int seq_col = 0;  // resolved active sequence column
  std::vector<int> keep;
};

// split line into tab-separated token views
struct Tok {
  const char* p;
  size_t len;
};

size_t split(const char* line, size_t len, std::vector<Tok>& out) {
  out.clear();
  const char* start = line;
  const char* end = line + len;
  for (const char* q = line; q <= end; q++) {
    if (q == end || *q == '\t') {
      out.push_back({start, (size_t)(q - start)});
      start = q + 1;
    }
  }
  return out.size();
}

bool tok_eq(const Tok& t, const char* s) {
  size_t n = strlen(s);
  return t.len == n && memcmp(t.p, s, n) == 0;
}

// strtol-style duplicate_count parse: leading whitespace, optional
// sign, digits to end, value >= 1 (db.cc:545-559)
bool parse_count(const Tok& t, int64_t* out) {
  const char* p = t.p;
  const char* end = t.p + t.len;
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r' ||
                     *p == '\v' || *p == '\f'))
    p++;
  bool neg = false;
  if (p < end && (*p == '+' || *p == '-')) {
    neg = (*p == '-');
    p++;
  }
  if (p >= end) return false;
  int64_t v = 0;
  for (; p < end; p++) {
    if (*p < '0' || *p > '9') return false;
    v = v * 10 + (*p - '0');
    if (v > (int64_t)1 << 62) return false;
  }
  if (neg) v = -v;
  if (v < 1) return false;
  *out = v;
  return true;
}

// per-shard parse output (local interners, local line numbers)
struct Shard {
  int32_t status = ERR_NONE;
  int64_t err_lineno = 0;  // local to the shard's chunk
  int32_t err_char = 0;
  std::string err_detail;

  int64_t lines = 0;  // lines consumed in this chunk
  int64_t n = 0;
  std::string residues;
  std::vector<uint64_t> row_hash;
  std::vector<int32_t> lengths;
  std::vector<int64_t> counts;
  std::vector<int32_t> rep_no, v_no, j_no;  // LOCAL intern ids
  std::vector<uint8_t> has_sequence_id;
  StringArena sequence_ids;
  StringArena keeps;
  TokMap reps, vs, js;

  int64_t ignored_unknown = 0, ignored_empty = 0;
  int64_t total_dup = 0;
  int32_t shortest = INT32_MAX, longest = 0;
};

// bytes parsed so far across all shards of the in-flight parse; the
// Python side polls airr_parse_progress() from a helper thread to
// drive the interactive progress display (~200 redraws per phase,
// like the reference's util.cc:32-70). Relaxed ordering: the value is
// monotone and only read for display.
static std::atomic<int64_t> g_parse_progress{0};

// parse the body lines in [p, end) into the shard; stops at the first
// error (recording the local line number)
void parse_chunk(const char* p, const char* end, const Columns& cols,
                 const Options& opt, const signed char* map,
                 const char* default_rep, size_t default_rep_len,
                 int n_keep, Shard* sh) {
  std::vector<Tok> toks;
  toks.reserve(16);
  std::string joined;
  // progressively release parsed file pages (clean MAP_PRIVATE
  // read-only pages; never revisited) so the mapping doesn't stack on
  // top of the growing output arenas in peak RSS
  const size_t kDropStride = 32u << 20;
  uintptr_t drop_from = ((uintptr_t)p + 4095) & ~(uintptr_t)4095;
  const char* prog_mark = p;  // flushed to g_parse_progress per ~1 MB
  while (p < end) {
    if ((size_t)(p - prog_mark) >= (1u << 20)) {
      g_parse_progress.fetch_add(p - prog_mark,
                                 std::memory_order_relaxed);
      prog_mark = p;
    }
    if ((uintptr_t)p >= drop_from + kDropStride) {
      uintptr_t upto = (uintptr_t)p & ~(uintptr_t)4095;
      madvise((void*)drop_from, upto - drop_from, MADV_DONTNEED);
      drop_from = upto;
    }
    const char* nl = (const char*)memchr(p, '\n', (size_t)(end - p));
    const char* le = nl ? nl : end;
    size_t len = (size_t)(le - p);
    if (len > 0 && le[-1] == '\r') len--;
    const char* line = p;
    p = nl ? nl + 1 : end;
    sh->lines++;

    split(line, len, toks);
    size_t ntok = toks.size();
    auto get = [&](int col) -> const Tok* {
      return (col >= 1 && (size_t)col <= ntok) ? &toks[(size_t)col - 1]
                                               : nullptr;
    };

    const Tok* raw_seq = get(cols.seq_col);

    // scan & encode (db.cc:408-469); the FNV-1a running hash feeds
    // the native exact-grouping passes so they never re-read rows
    size_t start = sh->residues.size();
    int32_t seqlen = 0;
    uint64_t rowh = 1469598103934665603ULL;
    bool ignore_seq = false;
    bool fail = false;
    if (raw_seq) {
      for (size_t i = 0; i < raw_seq->len; i++) {
        unsigned char c = (unsigned char)raw_seq->p[i];
        signed char m = map[c];
        if (m >= 0) {
          sh->residues.push_back((char)m);
          rowh = (rowh ^ (uint64_t)(uint8_t)m) * 1099511628211ULL;
          seqlen++;
        } else if (c >= 32 && c <= 126) {
          if (opt.ignore_unknown) {
            ignore_seq = true;
            sh->ignored_unknown++;
          } else {
            sh->status = ERR_ILLEGAL_CHAR;
            sh->err_lineno = sh->lines;
            sh->err_char = (int32_t)c;
            fail = true;
            break;
          }
        } else {
          sh->status = ERR_ILLEGAL_CHAR_NONPRINT;
          sh->err_lineno = sh->lines;
          sh->err_char = (int32_t)c;
          fail = true;
          break;
        }
      }
    }
    if (fail) return;

    if (seqlen == 0) {
      if (opt.ignore_empty) {
        ignore_seq = true;
        sh->ignored_empty++;
      } else {
        sh->status = ERR_EMPTY_SEQ;
        sh->err_lineno = sh->lines;
        return;
      }
    }

    if (ignore_seq) {
      sh->residues.resize(start);
      continue;
    }

    if (seqlen > sh->longest) sh->longest = seqlen;
    if (seqlen < sh->shortest) sh->shortest = seqlen;

    // repertoire_id (db.cc:503-520)
    const Tok* rep = get(cols.repertoire_id);
    int32_t rep_id;
    if (rep)
      rep_id = sh->reps.intern(rep->p, rep->len);
    else
      rep_id = sh->reps.intern(default_rep, default_rep_len);

    // sequence_id (db.cc:523-540)
    const Tok* sid = get(cols.sequence_id);
    if (sid && sid->len > 0) {
      sh->sequence_ids.push(sid->p, sid->len);
      sh->has_sequence_id.push_back(1);
    } else if (opt.require_sequence_id) {
      sh->status = ERR_MISSING_SEQUENCE_ID;
      sh->err_lineno = sh->lines;
      return;
    } else {
      sh->sequence_ids.push_missing();
      sh->has_sequence_id.push_back(0);
    }

    // duplicate_count (db.cc:543-573)
    const Tok* dc = get(cols.duplicate_count);
    int64_t count;
    if (dc && dc->len > 0) {
      if (!parse_count(*dc, &count)) {
        sh->status = ERR_BAD_DUP_COUNT;
        sh->err_lineno = sh->lines;
        sh->err_detail.assign(dc->p, dc->len);
        return;
      }
    } else if (opt.ignore_counts) {
      count = 1;
    } else {
      sh->status = ERR_MISSING_DUP_COUNT;
      sh->err_lineno = sh->lines;
      return;
    }
    sh->total_dup += count;

    // v_call / j_call (db.cc:576-631)
    const Tok* v = get(cols.v_call);
    if (!opt.ignore_genes && (!v || v->len == 0)) {
      sh->status = ERR_MISSING_V;
      sh->err_lineno = sh->lines;
      return;
    }
    const Tok* j = get(cols.j_call);
    if (!opt.ignore_genes && (!j || j->len == 0)) {
      sh->status = ERR_MISSING_J;
      sh->err_lineno = sh->lines;
      return;
    }
    int32_t vno = v ? sh->vs.intern(v->p, v->len) : sh->vs.intern("", 0);
    int32_t jno = j ? sh->js.intern(j->p, j->len) : sh->js.intern("", 0);

    // sequence field must have been present & non-empty (db.cc:634-668)
    if (!raw_seq || raw_seq->len == 0) {
      sh->status = ERR_MISSING_SEQ_VALUE;
      sh->err_lineno = sh->lines;
      return;
    }

    // keep columns (db.cc:671-701)
    if (n_keep > 0) {
      joined.clear();
      for (int k = 0; k < n_keep; k++) {
        if (k) joined.push_back('\t');
        const Tok* kv = get(cols.keep[(size_t)k]);
        if (kv) joined.append(kv->p, kv->len);
      }
      sh->keeps.push(joined.data(), joined.size());
    }

    sh->row_hash.push_back(rowh);
    sh->lengths.push_back(seqlen);
    sh->counts.push_back(count);
    sh->rep_no.push_back(rep_id);
    sh->v_no.push_back(vno);
    sh->j_no.push_back(jno);
    sh->n++;
  }
  if (p > prog_mark)
    g_parse_progress.fetch_add(p - prog_mark, std::memory_order_relaxed);
}

template <typename T>
void concat(std::vector<T>& dst, std::vector<Shard>& shards,
            std::vector<T> Shard::*member) {
  size_t total = 0;
  for (const Shard& s : shards) total += (s.*member).size();
  dst.reserve(total);
  for (Shard& s : shards) {
    dst.insert(dst.end(), (s.*member).begin(), (s.*member).end());
    std::vector<T>().swap(s.*member);  // destructive: bound co-residency
  }
}

}  // namespace

extern "C" {

void* airr_session_new() { return new Session(); }

void airr_session_free(void* s) { delete static_cast<Session*>(s); }

// parse one file with up to n_threads shards; returns a Result* handle
// (inspect via getters). Results are bit-identical for any n_threads.
//
// range_k/range_n select the k-th of n deterministic line-aligned byte
// chunks of the body — the per-host input sharding for multi-host runs
// (each host derives identical boundaries from the file size alone,
// the automation of the reference README's manual split-and-merge
// advice).
// range_n <= 1 reads the whole file.
void* airr_parse(void* session_ptr, const char* filename,
                 int nucleotides, int cdr3, int ignore_counts,
                 int ignore_genes, int ignore_unknown, int ignore_empty,
                 int require_sequence_id, const char* default_repertoire_id,
                 const char** keep_names, int n_keep, int n_threads,
                 int range_k, int range_n, int pack_padded) {
  Session* session = static_cast<Session*>(session_ptr);
  Options opt{(bool)nucleotides, (bool)cdr3,         (bool)ignore_counts,
              (bool)ignore_genes, (bool)ignore_unknown, (bool)ignore_empty,
              (bool)require_sequence_id};
  g_parse_progress.store(0, std::memory_order_relaxed);
  Result* r = new Result();

  int fd = open(filename, O_RDONLY);
  if (fd < 0) {
    r->status = ERR_OPEN;
    return r;
  }
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size <= 0) {
    close(fd);
    r->status = ERR_READ;  // empty/unreadable: "no lines"
    return r;
  }
  size_t fsize = (size_t)st.st_size;
  const char* buf = (const char*)mmap(nullptr, fsize, PROT_READ,
                                      MAP_PRIVATE, fd, 0);
  close(fd);
  if (buf == MAP_FAILED) {
    r->status = ERR_READ;
    return r;
  }
  madvise((void*)buf, fsize, MADV_SEQUENTIAL);

  signed char map[256];
  build_map(map, opt.nucleotides);

  // ---- header discovery (comment lines skipped, db.cc:172-296) ----
  Columns cols;
  cols.keep.assign((size_t)n_keep, 0);
  const char* p = buf;
  const char* end = buf + fsize;
  int64_t header_lines = 0;  // lines consumed incl. comments + header
  bool have_header = false;
  std::vector<Tok> toks;
  while (p < end && !have_header) {
    const char* nl = (const char*)memchr(p, '\n', (size_t)(end - p));
    const char* le = nl ? nl : end;
    size_t len = (size_t)(le - p);
    if (len > 0 && le[-1] == '\r') len--;
    const char* line = p;
    p = nl ? nl + 1 : end;
    header_lines++;
    if (len > 0 && (line[0] == '#' || line[0] == '@')) continue;

    split(line, len, toks);
    for (size_t i = 0; i < toks.size(); i++) {
      int no = (int)i + 1;
      const Tok& t = toks[i];
      if (tok_eq(t, "repertoire_id")) cols.repertoire_id = no;
      else if (tok_eq(t, "sequence_id")) cols.sequence_id = no;
      else if (tok_eq(t, "duplicate_count")) cols.duplicate_count = no;
      else if (tok_eq(t, "v_call")) cols.v_call = no;
      else if (tok_eq(t, "j_call")) cols.j_call = no;
      else if (tok_eq(t, "junction")) cols.junction = no;
      else if (tok_eq(t, "junction_aa")) cols.junction_aa = no;
      else if (tok_eq(t, "cdr3")) cols.cdr3 = no;
      else if (tok_eq(t, "cdr3_aa")) cols.cdr3_aa = no;
      for (int k = 0; k < n_keep; k++)
        if (tok_eq(t, keep_names[k])) cols.keep[(size_t)k] = no;
    }
    uint8_t missing = 0;
    if (opt.require_sequence_id && !cols.sequence_id) missing |= 1;
    if (!opt.ignore_counts && !cols.duplicate_count) missing |= 2;
    if (!opt.ignore_genes && !cols.v_call) missing |= 4;
    if (!opt.ignore_genes && !cols.j_call) missing |= 8;
    cols.seq_col = opt.cdr3 ? (opt.nucleotides ? cols.cdr3 : cols.cdr3_aa)
                            : (opt.nucleotides ? cols.junction
                                               : cols.junction_aa);
    if (!cols.seq_col) missing |= 16;
    if (missing) {
      r->status = ERR_MISSING_COLUMNS;
      r->missing_cols = missing;
      munmap((void*)buf, fsize);
      return r;
    }
    r->keep_missing_mask.assign((size_t)n_keep, 0);
    for (int k = 0; k < n_keep; k++)
      if (cols.keep[(size_t)k] < 1) r->keep_missing_mask[(size_t)k] = 1;
    have_header = true;
  }
  if (!have_header) {
    // comment-only file: empty result, NOT an error (matches the
    // sequential reader: it never saw a header or a data line)
    munmap((void*)buf, fsize);
    return r;
  }

  // ---- optional multi-host range: k-th of n line-aligned chunks ----
  if (range_n > 1) {
    if (range_k < 0 || range_k >= range_n) {
      r->status = ERR_READ;
      munmap((void*)buf, fsize);
      return r;
    }
    size_t whole = (size_t)(end - p);
    std::vector<const char*> rb;
    rb.push_back(p);
    for (int t = 1; t < range_n; t++) {
      const char* q = p + whole * (size_t)t / (size_t)range_n;
      if (q < rb.back()) q = rb.back();
      const char* nl = (const char*)memchr(q, '\n', (size_t)(end - q));
      rb.push_back(nl ? nl + 1 : end);
    }
    rb.push_back(end);
    const char* rlo = rb[(size_t)range_k];
    const char* rhi = rb[(size_t)range_k + 1];
    // global line numbers for errors: count the skipped prefix lines
    for (const char* q = p; q < rlo;) {
      const char* nl = (const char*)memchr(q, '\n', (size_t)(rlo - q));
      if (!nl) break;
      header_lines++;
      q = nl + 1;
    }
    p = rlo;
    end = rhi;
  }

  // ---- shard the body at line boundaries ----
  size_t body = (size_t)(end - p);
  int T = n_threads < 1 ? 1 : (n_threads > 256 ? 256 : n_threads);
  if (body < (size_t)1 << 20) T = 1;  // small file: no thread payoff
  std::vector<const char*> bounds;
  bounds.push_back(p);
  for (int t = 1; t < T; t++) {
    const char* q = p + body * (size_t)t / (size_t)T;
    const char* prev = bounds.back();
    if (q < prev) q = prev;
    const char* nl = (const char*)memchr(q, '\n', (size_t)(end - q));
    bounds.push_back(nl ? nl + 1 : end);
  }
  bounds.push_back(end);
  T = (int)bounds.size() - 1;

  std::vector<Shard> shards((size_t)T);
  const char* drep = default_repertoire_id;
  size_t drep_len = strlen(drep);
  {
    std::vector<std::thread> threads;
    for (int t = 1; t < T; t++)
      threads.emplace_back(parse_chunk, bounds[(size_t)t],
                           bounds[(size_t)t + 1], std::cref(cols),
                           std::cref(opt), map, drep, drep_len, n_keep,
                           &shards[(size_t)t]);
    parse_chunk(bounds[0], bounds[1], cols, opt, map, drep, drep_len,
                n_keep, &shards[0]);
    for (auto& th : threads) th.join();
  }

  // the merge below reads only the shard arenas — release the file
  // mapping first so it never stacks on the merged copies in peak RSS
  munmap((void*)buf, fsize);
  buf = nullptr;

  // ---- first (in file order) error wins; earlier shards that
  // errored mask later ones (sequential semantics) ----
  for (int t = 0; t < T; t++) {
    Shard& s = shards[(size_t)t];
    if (s.status != ERR_NONE) {
      int64_t lineno = header_lines;
      for (int u = 0; u < t; u++) lineno += shards[(size_t)u].lines;
      r->status = s.status;
      r->err_lineno = lineno + s.err_lineno;
      r->err_char = s.err_char;
      r->err_detail = s.err_detail;
      return r;
    }
  }

  // ---- order-preserving merge with intern renumbering ----
  int64_t total_n = 0;
  size_t total_res = 0;
  for (const Shard& s : shards) {
    total_n += s.n;
    total_res += s.residues.size();
    r->ignored_unknown += s.ignored_unknown;
    r->ignored_empty += s.ignored_empty;
    r->total_dup += s.total_dup;
    if (s.n) {
      if (s.longest > r->longest) r->longest = s.longest;
      if (s.shortest < r->shortest) r->shortest = s.shortest;
    }
  }
  r->n = total_n;
  if (pack_padded && total_n) {
    // fused pack: write padded [n, lmax] rows straight from the shard
    // arenas (one pass instead of arena-concat + a later pack pass)
    int64_t lmax = r->longest;
    char padc = (char)(nucleotides ? 4 : 20);
    r->packed.reset(new char[(size_t)(total_n * lmax)]);
    r->packed_lmax = lmax;
    char* dst = r->packed.get();
    for (Shard& s : shards) {
      const char* src = s.residues.data();
      for (int64_t i = 0; i < s.n; i++) {
        int32_t len = s.lengths[(size_t)i];
        memcpy(dst, src, (size_t)len);
        memset(dst + len, padc, (size_t)(lmax - len));
        src += len;
        dst += lmax;
      }
      std::string().swap(s.residues);
    }
  } else {
    r->residues.reserve(total_res);
    for (Shard& s : shards) {
      r->residues.append(s.residues);
      std::string().swap(s.residues);
    }
  }
  concat(r->row_hash, shards, &Shard::row_hash);
  concat(r->lengths, shards, &Shard::lengths);
  concat(r->counts, shards, &Shard::counts);
  concat(r->has_sequence_id, shards, &Shard::has_sequence_id);

  // string arenas: blob concat + offset rebase (uint32 offsets when
  // the blob fits 4 GB — halves the dominant offset table)
  for (StringArena Shard::*m : {&Shard::sequence_ids, &Shard::keeps}) {
    bool is_sid = (m == &Shard::sequence_ids);
    StringArena& dst = is_sid ? r->sequence_ids : r->keeps;
    std::vector<uint32_t>& dst32 = is_sid ? r->sid_off32 : r->keep_off32;
    size_t blob_total = 0, noff = 0;
    for (const Shard& s : shards) {
      blob_total += (s.*m).blob.size();
      noff += (s.*m).offsets.size() - 1;
    }
    bool narrow = blob_total < ((size_t)1 << 32);
    dst.blob.reserve(blob_total);
    if (narrow) {
      dst32.reserve(noff + 1);
      dst32.push_back(0);
    } else {
      dst.offsets.reserve(noff + 1);
    }
    for (Shard& s : shards) {
      int64_t base = (int64_t)dst.blob.size();
      dst.blob.append((s.*m).blob);
      const auto& offs = (s.*m).offsets;
      for (size_t i = 1; i < offs.size(); i++) {
        if (narrow)
          dst32.push_back((uint32_t)(base + offs[i]));
        else
          dst.offsets.push_back(base + offs[i]);
      }
      std::string().swap((s.*m).blob);
      std::vector<int64_t>().swap((s.*m).offsets);
    }
  }

  // intern renumbering: walk rows in file order, assigning global ids
  // on first occurrence — identical numbering to a sequential parse
  r->rep_no.resize((size_t)total_n);
  r->v_no.resize((size_t)total_n);
  r->j_no.resize((size_t)total_n);
  int64_t base = 0;
  for (Shard& s : shards) {
    std::vector<int32_t> rmap(s.reps.names.size(), -1);
    std::vector<int32_t> vmap(s.vs.names.size(), -1);
    std::vector<int32_t> jmap(s.js.names.size(), -1);
    for (int64_t i = 0; i < s.n; i++) {
      int32_t lr = s.rep_no[(size_t)i];
      if (rmap[(size_t)lr] < 0) {
        const std::string& nm = s.reps.names[(size_t)lr];
        rmap[(size_t)lr] = r->repertoires.intern(nm.data(), nm.size());
      }
      r->rep_no[(size_t)(base + i)] = rmap[(size_t)lr];
      int32_t lv = s.v_no[(size_t)i];
      if (vmap[(size_t)lv] < 0) {
        const std::string& nm = s.vs.names[(size_t)lv];
        vmap[(size_t)lv] = session->v_genes.intern(nm.data(), nm.size());
      }
      r->v_no[(size_t)(base + i)] = vmap[(size_t)lv];
      int32_t lj = s.j_no[(size_t)i];
      if (jmap[(size_t)lj] < 0) {
        const std::string& nm = s.js.names[(size_t)lj];
        jmap[(size_t)lj] = session->j_genes.intern(nm.data(), nm.size());
      }
      r->j_no[(size_t)(base + i)] = jmap[(size_t)lj];
    }
    base += s.n;
    // free the whole shard as we go (halves peak during merge; every
    // other field was already concatenated into the result above)
    s = Shard();
  }

  return r;
}

// ---- result getters ----

// bytes parsed by the in-flight airr_parse call (monotone; resets at
// each parse start). Polled concurrently with the blocking parse.
int64_t airr_parse_progress() {
  return g_parse_progress.load(std::memory_order_relaxed);
}

// pre-parse reset for the poller: without it, a poll racing ahead of
// airr_parse's own reset could report the PREVIOUS file's byte count
// (jumping the progress bar to 100% and suppressing real updates)
void airr_parse_progress_reset() {
  g_parse_progress.store(0, std::memory_order_relaxed);
}

int32_t airr_status(void* rp) { return static_cast<Result*>(rp)->status; }
int64_t airr_err_lineno(void* rp) {
  return static_cast<Result*>(rp)->err_lineno;
}
int32_t airr_err_char(void* rp) { return static_cast<Result*>(rp)->err_char; }
const char* airr_err_detail(void* rp) {
  return static_cast<Result*>(rp)->err_detail.c_str();
}
int32_t airr_missing_cols(void* rp) {
  return static_cast<Result*>(rp)->missing_cols;
}
int64_t airr_n(void* rp) { return static_cast<Result*>(rp)->n; }
int64_t airr_residues_size(void* rp) {
  Result* r = static_cast<Result*>(rp);
  if (r->packed_lmax >= 0) return r->n * r->packed_lmax;
  return (int64_t)r->residues.size();
}
const uint64_t* airr_row_hash(void* rp) {
  return static_cast<Result*>(rp)->row_hash.data();
}
const char* airr_residues(void* rp) {
  Result* r = static_cast<Result*>(rp);
  return r->packed_lmax >= 0 ? r->packed.get() : r->residues.data();
}
// >= 0 when the merge produced the padded [n, lmax] matrix directly
// (airr_residues then points at it, size n*lmax)
int64_t airr_packed_lmax(void* rp) {
  return static_cast<Result*>(rp)->packed_lmax;
}
const int32_t* airr_lengths(void* rp) {
  return static_cast<Result*>(rp)->lengths.data();
}
const int64_t* airr_counts(void* rp) {
  return static_cast<Result*>(rp)->counts.data();
}
const int32_t* airr_rep_no(void* rp) {
  return static_cast<Result*>(rp)->rep_no.data();
}
const int32_t* airr_v_no(void* rp) {
  return static_cast<Result*>(rp)->v_no.data();
}
const int32_t* airr_j_no(void* rp) {
  return static_cast<Result*>(rp)->j_no.data();
}
const uint8_t* airr_has_sequence_id(void* rp) {
  return static_cast<Result*>(rp)->has_sequence_id.data();
}
const int64_t* airr_sequence_id_offsets(void* rp) {
  Result* r = static_cast<Result*>(rp);
  return r->sid_off32.empty() ? r->sequence_ids.offsets.data() : nullptr;
}
const uint32_t* airr_sequence_id_offsets32(void* rp) {
  Result* r = static_cast<Result*>(rp);
  return r->sid_off32.empty() ? nullptr : r->sid_off32.data();
}
const char* airr_sequence_id_blob(void* rp) {
  return static_cast<Result*>(rp)->sequence_ids.blob.data();
}
const int64_t* airr_keep_offsets(void* rp) {
  Result* r = static_cast<Result*>(rp);
  return r->keep_off32.empty() ? r->keeps.offsets.data() : nullptr;
}
const uint32_t* airr_keep_offsets32(void* rp) {
  Result* r = static_cast<Result*>(rp);
  return r->keep_off32.empty() ? nullptr : r->keep_off32.data();
}
const char* airr_keep_blob(void* rp) {
  return static_cast<Result*>(rp)->keeps.blob.data();
}
const uint8_t* airr_keep_missing(void* rp) {
  return static_cast<Result*>(rp)->keep_missing_mask.data();
}
int64_t airr_ignored_unknown(void* rp) {
  return static_cast<Result*>(rp)->ignored_unknown;
}
int64_t airr_ignored_empty(void* rp) {
  return static_cast<Result*>(rp)->ignored_empty;
}
int64_t airr_total_dup(void* rp) {
  return static_cast<Result*>(rp)->total_dup;
}
int32_t airr_shortest(void* rp) {
  Result* r = static_cast<Result*>(rp);
  return r->n ? r->shortest : 0;
}
int32_t airr_longest(void* rp) { return static_cast<Result*>(rp)->longest; }

int32_t airr_rep_count(void* rp) {
  return (int32_t)static_cast<Result*>(rp)->repertoires.names.size();
}
const char* airr_rep_name(void* rp, int32_t i) {
  return static_cast<Result*>(rp)->repertoires.names[(size_t)i].c_str();
}

int32_t airr_v_count(void* sp) {
  return (int32_t)static_cast<Session*>(sp)->v_genes.names.size();
}
const char* airr_v_name(void* sp, int32_t i) {
  return static_cast<Session*>(sp)->v_genes.names[(size_t)i].c_str();
}
int32_t airr_j_count(void* sp) {
  return (int32_t)static_cast<Session*>(sp)->j_genes.names.size();
}
const char* airr_j_name(void* sp, int32_t i) {
  return static_cast<Session*>(sp)->j_genes.names[(size_t)i].c_str();
}

void airr_result_free(void* rp) { delete static_cast<Result*>(rp); }

// shed the parser's residue arena once the packed [n, lmax] matrix has
// adopted the data — the arena would otherwise double-store every
// residue for the lifetime of the result (peak-RSS item)
void airr_drop_residues(void* rp) {
  Result* r = static_cast<Result*>(rp);
  r->residues.clear();
  r->residues.shrink_to_fit();
  r->packed.reset();
  r->packed_lmax = -1;
}

// release the row-hash arena once no remaining path reads it
// (approximate matching never does; SeqDB.drop_row_hash)
void airr_drop_row_hash(void* rp) {
  std::vector<uint64_t>().swap(static_cast<Result*>(rp)->row_hash);
}

}  // extern "C"
