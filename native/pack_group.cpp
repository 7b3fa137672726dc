// Ragged-to-padded packing and exact-duplicate grouping.
//
// pack_rows materialises fixed-width [n, lmax] rows from the parser's
// flat residue arena — the analogue of the reference's "Indexing" pass
// (/root/reference/src/db.cc:891-900), which only builds pointers; we
// need dense rows for device upload.
//
// group_rows assigns every row a group id by first-occurrence order,
// where two rows share a group iff their residues and meta columns are
// identical — the duplicate criterion of hash_insert
// (/root/reference/src/overlap.cc:63-128) and dedup's process()
// (/root/reference/src/dedup.cc:60-132). Open addressing with linear
// probing, like the reference's hashtable.cc, but keyed on the actual
// bytes (no Zobrist needed: we never enumerate variants).

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <mutex>
#include <thread>
#include <vector>

#include <sys/mman.h>

// Rows processed by the grouping passes since the last reset — polled
// from Python (~20 Hz) during the GIL-released ctypes call to drive
// interactive progress redraws, like airr_parser.cpp's byte counter
// (reference granularity: ~200 updates/phase, util.cc:28).
static std::atomic<int64_t> g_group_progress{0};

namespace {

inline void progress_add(int64_t rows) {
  g_group_progress.fetch_add(rows, std::memory_order_relaxed);
}

inline uint64_t mix64(uint64_t x) {
  // splitmix64 finaliser
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

// MADV_HUGEPAGE cuts first-touch faults 512x when the kernel promotes
// cheaply, but on some hosts (e.g. microVM kernels with
// defrag=madvise) every 2 MB fault takes a synchronous-compaction
// path measured 140x SLOWER than 4 KB faults. Probe once per process:
// first-touch one hugepage-advised 2 MB region and only keep advising
// if that is actually fast. COMPAIRR_HUGEPAGES=1/0 skips the probe
// and forces the choice.
bool hugepages_ok() {
  static std::atomic<int> cached{-1};
  int c = cached.load(std::memory_order_relaxed);
  if (c >= 0) return c != 0;
  int ok = 0;
  const char* env = getenv("COMPAIRR_HUGEPAGES");
  if (env && *env) {
    ok = (*env != '0');
  } else {
    size_t sz = 2u << 20;  // one hugepage
    void* p = mmap(nullptr, sz, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    if (p != MAP_FAILED) {
      madvise(p, sz, MADV_HUGEPAGE);
      timespec t0, t1;
      clock_gettime(CLOCK_MONOTONIC, &t0);
      memset(p, 1, sz);
      clock_gettime(CLOCK_MONOTONIC, &t1);
      munmap(p, sz);
      double s = (double)(t1.tv_sec - t0.tv_sec) +
                 1e-9 * (double)(t1.tv_nsec - t0.tv_nsec);
      ok = s < 0.010;  // healthy THP first-touch is ~1 ms for 2 MB
    }
  }
  cached.store(ok, std::memory_order_relaxed);
  return ok != 0;
}

inline void advise_hugepage(void* mem, size_t bytes) {
  if (hugepages_ok()) madvise(mem, bytes, MADV_HUGEPAGE);
}

// Process-lifetime slot-table arena. Every grouping pass needs a
// zeroed power-of-2 table sized ~1.5x its row count; mmap/munmap per
// call re-faults hundreds of MB of anonymous pages each pass, which
// on ballooned-VM hosts intermittently runs ~100x slower than memory
// speed. Keeping the largest table mapped and re-zeroing it on reuse
// (rewrite-speed memset) makes every pass after the first immune to
// that pathology. Peak RSS is unchanged: the retained arena is the
// same table the next pass would have mapped anyway.
// COMPAIRR_ARENA=0 restores per-call mmap/munmap.
struct Arena {
  uint64_t* slots = nullptr;  // zeroed to `bytes` on acquire
  size_t bytes = 0;           // requested size
  size_t cap = 0;             // mapped size (>= bytes)
};

std::mutex g_arena_mu;
void* g_arena_p = nullptr;
size_t g_arena_cap = 0;

inline bool arena_enabled() {
  const char* env = getenv("COMPAIRR_ARENA");
  return !(env && *env == '0');
}

Arena arena_acquire(size_t bytes) {
  Arena a;
  a.bytes = bytes;
  if (arena_enabled()) {
    std::lock_guard<std::mutex> lk(g_arena_mu);
    if (g_arena_p && g_arena_cap >= bytes) {
      a.slots = (uint64_t*)g_arena_p;
      a.cap = g_arena_cap;
      g_arena_p = nullptr;
      g_arena_cap = 0;
    }
  }
  if (a.slots) {
    memset(a.slots, 0, bytes);  // reused pages re-zero at memory speed
    return a;
  }
  void* p = mmap(nullptr, bytes, PROT_READ | PROT_WRITE,
                 MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
  if (p == MAP_FAILED) return a;  // slots == nullptr signals failure
  advise_hugepage(p, bytes);
  a.slots = (uint64_t*)p;
  a.cap = bytes;
  return a;
}

void arena_release(Arena& a) {
  if (!a.slots) return;
  void* drop = a.slots;
  size_t drop_cap = a.cap;
  if (arena_enabled()) {
    std::lock_guard<std::mutex> lk(g_arena_mu);
    if (g_arena_cap < a.cap) {
      drop = g_arena_p;
      drop_cap = g_arena_cap;
      g_arena_p = a.slots;
      g_arena_cap = a.cap;
    }
  }
  if (drop) munmap(drop, drop_cap);
  a.slots = nullptr;
}

inline uint64_t hash_row(const int8_t* seq, int64_t row_bytes,
                         const int32_t* meta, int32_t m) {
  uint64_t h = 0x2545F4914F6CDD1DULL;
  int64_t k = 0;
  for (; k + 8 <= row_bytes; k += 8) {
    uint64_t w;
    memcpy(&w, seq + k, 8);
    h = mix64(h ^ w);
  }
  if (k < row_bytes) {
    uint64_t w = 0;
    memcpy(&w, seq + k, (size_t)(row_bytes - k));
    h = mix64(h ^ w);
  }
  for (int32_t c = 0; c < m; ++c) {
    h = mix64(h ^ (uint64_t)(uint32_t)meta[c]);
  }
  return h;
}

// Multithreaded exact grouping: threads claim row ranges and insert
// into a shared lock-free open-addressing table with CAS (one 8-byte
// slot per bucket, same tag layout as the sequential path). Each row
// records a leader (the group member that won the slot); a cheap
// sequential pass renumbers groups by global first occurrence, so the
// result is bit-identical to the sequential grouping for any thread
// count — this build's equivalent of the reference's -t option
// applied to its hashing phases.
template <class HashFn, class EqFn>
int64_t group_mt(int64_t n, int n_threads, HashFn&& hf, EqFn&& eq,
                 int64_t* group_out) {
  if (n == 0) return 0;
  if (n >= (int64_t)1 << 31) return -1;

  uint64_t size = 1;
  while ((int64_t)size < n || (double)n > 0.7 * (double)size) size <<= 1;
  const uint64_t mask = size - 1;
  size_t bytes = (size_t)size * sizeof(uint64_t);
  Arena arena = arena_acquire(bytes);
  if (!arena.slots) return -1;
  auto* slots = reinterpret_cast<std::atomic<uint64_t>*>(arena.slots);

  std::vector<int32_t> leader((size_t)n);
  auto worker = [&](int64_t lo, int64_t hi) {
    int64_t since = 0;
    for (int64_t i = lo; i < hi; ++i) {
      if (++since == 4096) { progress_add(since); since = 0; }
      uint64_t h = hf(i);
      const uint64_t tag = h & 0xffffffff00000000ULL;
      const uint64_t entry = tag | (uint64_t)(uint32_t)(i + 1);
      uint64_t j = h & mask;
      for (;;) {
        uint64_t s = slots[j].load(std::memory_order_acquire);
        if (s == 0) {
          uint64_t expected = 0;
          if (slots[j].compare_exchange_strong(
                  expected, entry, std::memory_order_acq_rel)) {
            leader[(size_t)i] = (int32_t)i;
            break;
          }
          s = expected;  // lost the race; inspect the winner
        }
        if ((s & 0xffffffff00000000ULL) == tag) {
          int64_t other = (int64_t)(uint32_t)s - 1;
          if (eq(i, other)) {
            leader[(size_t)i] = (int32_t)other;
            break;
          }
        }
        j = (j + 1) & mask;
      }
    }
    progress_add(since);
  };

  int T = n_threads < 1 ? 1 : n_threads;
  if ((int64_t)T > n) T = (int)n;
  {
    std::vector<std::thread> threads;
    for (int t = 1; t < T; t++)
      threads.emplace_back(worker, n * t / T, n * (t + 1) / T);
    worker(0, n / T);
    for (auto& th : threads) th.join();
  }
  arena_release(arena);

  // renumber by global first occurrence (leaders are self-leaders)
  std::vector<int32_t> gid((size_t)n, -1);
  int64_t n_groups = 0;
  for (int64_t i = 0; i < n; ++i) {
    int32_t l = leader[(size_t)i];
    if (gid[(size_t)l] < 0) gid[(size_t)l] = (int32_t)n_groups++;
    group_out[i] = gid[(size_t)l];
  }
  return n_groups;
}

}  // namespace

extern "C" {

// Stable counting sort by the (v,j,length) bucket key — the host half
// of the GPU pack (engine.pack_keys). The key domain is
// tiny ((v*nj+j) * (lmax+1) + len, tens of thousands of bins for real
// gene tables), so one O(n) count pass + one O(n) stable scatter
// replaces numpy's 24M-row key-build temporaries and radix argsort
// (~9-16 s of a Keck device-path run's critical wall, dominated by
// first-touch page faults on this host). by_vjl=0 sorts by length
// alone (ignore_genes). Writes order[n] (int32) and the sorted real
// keys keys64[n] ((vj<<16)|len, matching the numpy path bit-exactly);
// returns 0, or -1 when the bin table would be degenerate
// (vj/length out of the expected range) so the caller falls back.
int pack_keys_vjl(const int32_t* v, const int32_t* j,
                  const int32_t* len, int64_t n, int64_t nj,
                  int by_vjl, int32_t* order, int64_t* keys64) {
  if (n <= 0) return 0;
  int64_t lmax = 0, vjmax = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (len[i] < 0 || len[i] > 0xFFFF) return -1;
    if (len[i] > lmax) lmax = len[i];
  }
  if (by_vjl) {
    for (int64_t i = 0; i < n; ++i) {
      int64_t vj = (int64_t)v[i] * nj + j[i];
      if (vj < 0 || vj > (1 << 14)) return -1;
      if (vj > vjmax) vjmax = vj;
    }
  }
  const int64_t lbins = lmax + 1;
  const int64_t nbins = (vjmax + 1) * lbins;
  // cap the bin table (pathological gene-table x length combinations
  // could otherwise allocate GBs); callers fall back to numpy
  if (nbins > (int64_t)1 << 24) return -1;
  int64_t* cnt = (int64_t*)calloc((size_t)nbins + 1, sizeof(int64_t));
  if (!cnt) return -1;
  for (int64_t i = 0; i < n; ++i) {
    int64_t vj = by_vjl ? (int64_t)v[i] * nj + j[i] : 0;
    cnt[vj * lbins + len[i] + 1]++;
  }
  for (int64_t b = 1; b <= nbins; ++b) cnt[b] += cnt[b - 1];
  for (int64_t i = 0; i < n; ++i) {
    int64_t vj = by_vjl ? (int64_t)v[i] * nj + j[i] : 0;
    int64_t key = by_vjl ? ((vj << 16) | len[i]) : (int64_t)len[i];
    int64_t p = cnt[vj * lbins + len[i]]++;
    order[p] = (int32_t)i;
    keys64[p] = key;
  }
  free(cnt);
  return 0;
}

int64_t group_progress() {
  return g_group_progress.load(std::memory_order_relaxed);
}

void group_progress_reset() {
  g_group_progress.store(0, std::memory_order_relaxed);
}

void pack_rows(const int8_t* flat, const int32_t* lens, int64_t n,
               int64_t lmax, int8_t pad, int8_t* out) {
  const int8_t* src = flat;
  int8_t* dst = out;
  for (int64_t i = 0; i < n; ++i) {
    int32_t len = lens[i];
    memcpy(dst, src, (size_t)len);
    memset(dst + len, pad, (size_t)(lmax - len));  // tail pad only
    src += len;
    dst += lmax;
  }
}

// 5-bit residue packing for device upload (the host half of
// ops/derive._pack_residues): six residues per int32 word.
// Output is [m, nw]; row i < n takes its residues from seqs[i]
// (columns >= w read as pad, matching the pad-extended staging
// buffer), rows >= n are all-pad sentinels. Residue codes (aa 0..20
// incl. pad, nt 0..4) fit 5 bits. Columns >= lpad pack as zero.
void pack5_rows(const int8_t* seqs, int64_t n, int64_t w, int64_t m,
                int64_t lpad, int64_t nw, int8_t pad, int32_t* out) {
  // precompute the all-pad sentinel row once
  int32_t sentinel[64];
  if (nw > 64) return;
  for (int64_t k = 0; k < nw; ++k) {
    uint32_t word = 0;
    for (int64_t j = 0; j < 6; ++j) {
      int64_t c = k * 6 + j;
      uint32_t r = (c < lpad) ? (uint32_t)(uint8_t)pad : 0u;
      word |= (r & 31u) << (5 * j);
    }
    sentinel[k] = (int32_t)word;
  }
  for (int64_t i = 0; i < n; ++i) {
    const int8_t* row = seqs + i * w;
    int32_t* o = out + i * nw;
    for (int64_t k = 0; k < nw; ++k) {
      uint32_t word = 0;
      for (int64_t j = 0; j < 6; ++j) {
        int64_t c = k * 6 + j;
        uint32_t r;
        if (c < w)
          r = (uint32_t)(uint8_t)row[c];
        else if (c < lpad)
          r = (uint32_t)(uint8_t)pad;
        else
          r = 0;
        word |= (r & 31u) << (5 * j);
      }
      o[k] = (int32_t)word;
    }
  }
  for (int64_t i = n; i < m; ++i)
    memcpy(out + i * nw, sentinel, (size_t)nw * sizeof(int32_t));
}

// seqs: [n, row_bytes] contiguous; meta: [n, m] contiguous int32
// (v/j/rep columns under the active criterion). Writes group ids
// (first-occurrence numbering) to group_out[n]; returns the number of
// groups, or -1 on allocation failure.
int64_t group_rows_pre(const int8_t* seqs, int64_t n, int64_t row_bytes,
                       const int32_t* meta, int32_t m,
                       const uint64_t* prehash, int64_t* group_out);

int64_t group_rows(const int8_t* seqs, int64_t n, int64_t row_bytes,
                   const int32_t* meta, int32_t m, int64_t* group_out) {
  return group_rows_pre(seqs, n, row_bytes, meta, m, nullptr, group_out);
}

// Like group_rows, but `prehash` (when non-null) carries a per-row
// content hash computed during parsing (airr_parser.cpp) — the rows
// are then never re-read for hashing, only for the exact memcmp
// verification of same-tag occupants.
int64_t group_rows_pre(const int8_t* seqs, int64_t n, int64_t row_bytes,
                       const int32_t* meta, int32_t m,
                       const uint64_t* prehash, int64_t* group_out) {
  if (n == 0) return 0;
  if (n >= (int64_t)1 << 31) return -1;  // slot packs idx into 32 bits

  uint64_t size = 1;
  while ((int64_t)size < n || (double)n > 0.7 * (double)size) size <<= 1;
  const uint64_t mask = size - 1;

  // one 8-byte slot per bucket: high 32 bits = hash tag, low 32 bits =
  // row index + 1 (0 = empty). One cache line touched per probe; the
  // tag rejects nearly all non-matching occupants without dereferencing
  // the row, and a memcmp verifies the rare survivors exactly.
  // mmap so we can ask for huge pages: the probe pattern is uniform
  // random over the table, and at Keck scale the table far exceeds
  // what 4 KiB TLB entries cover.
  size_t bytes = (size_t)size * sizeof(uint64_t);
  Arena arena = arena_acquire(bytes);
  if (!arena.slots) return -1;
  uint64_t* slots = arena.slots;

  // the insert loop is bound by one random slot access per row;
  // hashing a batch ahead and prefetching each home slot keeps many
  // of those misses in flight instead of serialising them (same
  // pattern as variant_join's build, measured 2.3x there)
  int64_t n_groups = 0;
  constexpr int64_t kBatch = 16;
  uint64_t hbuf[kBatch];
  for (int64_t base = 0; base < n; base += kBatch) {
    const int64_t bn = base + kBatch <= n ? kBatch : n - base;
    for (int64_t k = 0; k < bn; ++k) {
      const int64_t i = base + k;
      uint64_t h;
      if (prehash) {
        const int32_t* me = meta + i * m;
        h = mix64(prehash[i]);
        for (int32_t c = 0; c < m; ++c)
          h = mix64(h ^ (uint64_t)(uint32_t)me[c]);
      } else {
        h = hash_row(seqs + i * row_bytes, row_bytes, meta + i * m, m);
      }
      hbuf[k] = h;
      __builtin_prefetch(&slots[h & mask], 1);
    }
    for (int64_t k = 0; k < bn; ++k) {
      const int64_t i = base + k;
      const int8_t* row = seqs + i * row_bytes;
      const int32_t* me = meta + i * m;
      const uint64_t h = hbuf[k];
      const uint64_t tag = h & 0xffffffff00000000ULL;
      uint64_t j = h & mask;
      for (;;) {
        uint64_t s = slots[j];
        if (s == 0) {
          slots[j] = tag | (uint64_t)(uint32_t)(i + 1);
          group_out[i] = n_groups++;
          break;
        }
        if ((s & 0xffffffff00000000ULL) == tag) {
          int64_t other = (int64_t)(uint32_t)s - 1;
          if (memcmp(seqs + other * row_bytes, row,
                     (size_t)row_bytes) == 0 &&
              (m == 0 || memcmp(meta + other * m, me,
                                (size_t)m * sizeof(int32_t)) == 0)) {
            group_out[i] = group_out[other];
            break;
          }
        }
        j = (j + 1) & mask;
      }
    }
    progress_add(bn);
  }

  arena_release(arena);
  return n_groups;
}

// Thread-capable twin of group_rows_pre: identical results for any
// n_threads (CAS inserts + first-occurrence renumbering, group_mt).
int64_t group_rows_pre_mt(const int8_t* seqs, int64_t n,
                          int64_t row_bytes, const int32_t* meta,
                          int32_t m, const uint64_t* prehash,
                          int32_t n_threads, int64_t* group_out) {
  if (n_threads <= 1)
    return group_rows_pre(seqs, n, row_bytes, meta, m, prehash, group_out);
  auto hf = [&](int64_t i) -> uint64_t {
    const int32_t* me = meta + i * m;
    if (prehash) {
      uint64_t h = mix64(prehash[i]);
      for (int32_t c = 0; c < m; ++c)
        h = mix64(h ^ (uint64_t)(uint32_t)me[c]);
      return h;
    }
    return hash_row(seqs + i * row_bytes, row_bytes, me, m);
  };
  auto eq = [&](int64_t i, int64_t other) -> bool {
    return memcmp(seqs + other * row_bytes, seqs + i * row_bytes,
                  (size_t)row_bytes) == 0 &&
           (m == 0 || memcmp(meta + other * m, meta + i * m,
                             (size_t)m * sizeof(int32_t)) == 0);
  };
  return group_mt(n, n_threads, hf, eq, group_out);
}

// Pigeonhole piece grouping fused with extraction: groups rows by
// (piece residues, meta) where the piece is the length-proportional
// range [len*p/pieces, len*(p+1)/pieces). meta must include the
// length (plus v/j under the gene criterion) so only equal-length
// rows — whose piece bounds agree — can share a group. Avoids
// materialising the [n, w] piece matrix the numpy path gathers.
int64_t group_pieces(const int8_t* seqs, int64_t n, int64_t row_bytes,
                     const int32_t* lengths, const int32_t* meta,
                     int32_t m, int32_t piece, int32_t pieces,
                     int64_t* group_out) {
  if (n == 0) return 0;
  if (n >= (int64_t)1 << 31) return -1;
  if (m < 1) return -1;  // meta must carry the length column

  uint64_t size = 1;
  while ((int64_t)size < n || (double)n > 0.7 * (double)size) size <<= 1;
  const uint64_t mask = size - 1;
  size_t bytes = (size_t)size * sizeof(uint64_t);
  Arena arena = arena_acquire(bytes);
  if (!arena.slots) return -1;
  uint64_t* slots = arena.slots;

  // batched hashing + home-slot prefetch, as in group_rows_pre
  int64_t n_groups = 0;
  constexpr int64_t kBatch = 16;
  uint64_t hbuf[kBatch];
  for (int64_t base = 0; base < n; base += kBatch) {
    const int64_t bn = base + kBatch <= n ? kBatch : n - base;
    for (int64_t k = 0; k < bn; ++k) {
      const int64_t i = base + k;
      int64_t len = lengths[i];
      int64_t s = (len * piece) / pieces;
      int64_t e = (len * (piece + 1)) / pieces;
      const int8_t* pc = seqs + i * row_bytes + s;
      const int32_t* me = meta + i * m;
      uint64_t h = 1469598103934665603ULL;
      for (int64_t q = s; q < e; ++q)
        h = (h ^ (uint64_t)(uint8_t)*pc++) * 1099511628211ULL;
      h = mix64(h);
      for (int32_t c = 0; c < m; ++c)
        h = mix64(h ^ (uint64_t)(uint32_t)me[c]);
      hbuf[k] = h;
      __builtin_prefetch(&slots[h & mask], 1);
    }
    for (int64_t k = 0; k < bn; ++k) {
    const int64_t i = base + k;
    int64_t len = lengths[i];
    int64_t s = (len * piece) / pieces;
    int64_t e = (len * (piece + 1)) / pieces;
    const int8_t* pc = seqs + i * row_bytes + s;
    int64_t plen = e - s;
    const int32_t* me = meta + i * m;
    const uint64_t h = hbuf[k];
    const uint64_t tag = h & 0xffffffff00000000ULL;
    uint64_t j = h & mask;
    for (;;) {
      uint64_t sl = slots[j];
      if (sl == 0) {
        slots[j] = tag | (uint64_t)(uint32_t)(i + 1);
        group_out[i] = n_groups++;
        break;
      }
      if ((sl & 0xffffffff00000000ULL) == tag) {
        int64_t other = (int64_t)(uint32_t)sl - 1;
        // meta equality implies equal length, hence identical piece
        // bounds for both rows
        int64_t os = ((int64_t)lengths[other] * piece) / pieces;
        if (memcmp(meta + other * m, me,
                   (size_t)m * sizeof(int32_t)) == 0 &&
            memcmp(seqs + other * row_bytes + os, pc, (size_t)plen) ==
                0) {
          group_out[i] = group_out[other];
          break;
        }
      }
      j = (j + 1) & mask;
    }
    }
    progress_add(bn);
  }

  arena_release(arena);
  return n_groups;
}

// Asymmetric d=1 substitution join (the native heart of existence
// queries): build the open-addressing table over the BIG set's rows
// keyed on (sequence FNV, meta) — reusing the parser's per-row hashes
// when given — with per-group member chains, then probe every
// single-substitution variant of every small-set row against it,
// materialising each variant only in a W-byte scratch buffer. Emits
// all (seed, big row) candidate pairs — duplicate-free, because the
// identity is probed once and a == orig substitutions are skipped,
// so each big row is reachable from a seed by exactly one probe
// string — and writes the big rows'
// (sequence, meta) group ids — which refine into the duplicate-count
// warning for free. This replaces the reference's per-seed Zobrist
// variant hashing (/root/reference/src/variants.cc:280-293,
// overlap.cc:253-284) with one bulk build + bulk probe.
// Returns the pair count, -1 on allocation failure, -2 when pairs_cap
// would overflow (caller falls back), and sets *n_groups_out.
int64_t variant_join(const int8_t* small_seqs, int64_t ns,
                     const int32_t* small_lens, const int32_t* small_meta,
                     const int8_t* big_seqs, int64_t nb,
                     const int32_t* big_lens, const int32_t* big_meta,
                     const int32_t* big_rep, const uint64_t* big_prehash,
                     int32_t m, int64_t row_bytes, int32_t alphabet,
                     int64_t* big_group_out, int64_t* pairs_out,
                     int64_t pairs_cap, int64_t* n_groups_out,
                     int64_t* n_group_reps_out) {
  *n_groups_out = 0;
  *n_group_reps_out = 0;
  if (nb == 0 || ns == 0) return 0;
  if (nb >= (int64_t)1 << 31) return -1;

  uint64_t size = 1;
  while ((int64_t)size < nb || (double)nb > 0.7 * (double)size)
    size <<= 1;
  const uint64_t mask = size - 1;
  size_t bytes = (size_t)size * sizeof(uint64_t);
  // second half: exact (leader row, repertoire) distinct-pair table —
  // each slot stores the packed pair itself, so membership tests need
  // no verification reads. Its count is the big set's duplicate
  // warning (n rows - distinct (sequence,genes,repertoire)).
  Arena arena = arena_acquire(bytes * 2);
  if (!arena.slots) return -1;
  uint64_t* slots = arena.slots;
  uint64_t* rep_slots = slots + size;

  int32_t* head = (int32_t*)malloc((size_t)nb * 2 * sizeof(int32_t));
  if (!head) {
    arena_release(arena);
    return -1;
  }
  int32_t* nxt = head + nb;
  int64_t n_group_reps = 0;
  // rep_slots holds packed (leader+1, rep) distinct-pair keys, but is
  // only ever touched for DUPLICATE rows: a fresh group necessarily
  // starts a fresh pair, so it is counted without an insert, and the
  // leader's own pair is materialised lazily when the group first
  // sees a second member. Duplicate-free sets (the common case) thus
  // never pay the second random table access per row.
  auto rep_insert = [&](uint64_t key, bool count) {
    uint64_t j = mix64(key) & mask;
    for (;;) {
      uint64_t s = rep_slots[j];
      if (s == 0) {
        rep_slots[j] = key;
        if (count) n_group_reps++;
        return;
      }
      if (s == key) return;
      j = (j + 1) & mask;
    }
  };
  auto note_group_rep = [&](int64_t leader, int64_t i) {
    uint64_t lkey = ((uint64_t)(uint32_t)big_rep[leader] << 32) |
                    (uint64_t)(uint32_t)(leader + 1);
    rep_insert(lkey, false);  // counted when the group was created
    uint64_t key = ((uint64_t)(uint32_t)big_rep[i] << 32) |
                   (uint64_t)(uint32_t)(leader + 1);
    rep_insert(key, true);
  };

  auto fnv = [](const int8_t* p, int64_t len) -> uint64_t {
    uint64_t h = 1469598103934665603ULL;
    for (int64_t k = 0; k < len; ++k)
      h = (h ^ (uint64_t)(uint8_t)p[k]) * 1099511628211ULL;
    return h;
  };
  auto with_meta = [](uint64_t h, const int32_t* me, int32_t m) {
    h = mix64(h);
    for (int32_t c = 0; c < m; ++c)
      h = mix64(h ^ (uint64_t)(uint32_t)me[c]);
    return h;
  };

  // build: insert big rows, chaining duplicates under the
  // representative so probes can enumerate every member. Hashes are
  // (nearly) free — the parser's per-row FNV plus a few mixes — so the
  // build is bound by one random slot access per row; batching the
  // hash computation and software-prefetching the home slots keeps
  // many of those misses in flight instead of serialising them.
  int64_t n_groups = 0;
  constexpr int64_t kBatch = 16;
  uint64_t hbuf[kBatch];
  for (int64_t base = 0; base < nb; base += kBatch) {
    const int64_t bn = base + kBatch <= nb ? kBatch : nb - base;
    for (int64_t k = 0; k < bn; ++k) {
      const int64_t i = base + k;
      uint64_t h = big_prehash ? big_prehash[i]
                               : fnv(big_seqs + i * row_bytes,
                                     big_lens[i]);
      h = with_meta(h, big_meta + i * m, m);
      hbuf[k] = h;
      __builtin_prefetch(&slots[h & mask], 1);
    }
    for (int64_t k = 0; k < bn; ++k) {
      const int64_t i = base + k;
      const int8_t* row = big_seqs + i * row_bytes;
      const int32_t* me = big_meta + i * m;
      const uint64_t h = hbuf[k];
      const uint64_t tag = h & 0xffffffff00000000ULL;
      uint64_t j = h & mask;
      for (;;) {
        uint64_t s = slots[j];
        if (s == 0) {
          slots[j] = tag | (uint64_t)(uint32_t)(i + 1);
          big_group_out[i] = n_groups++;
          head[i] = (int32_t)i;
          nxt[i] = -1;
          // fresh group => fresh (group, rep) pair; counted lazily
          // (see rep_insert) without touching rep_slots
          if (big_rep) n_group_reps++;
          break;
        }
        if ((s & 0xffffffff00000000ULL) == tag) {
          int64_t other = (int64_t)(uint32_t)s - 1;
          if (memcmp(big_seqs + other * row_bytes, row,
                     (size_t)row_bytes) == 0 &&
              (m == 0 || memcmp(big_meta + other * m, me,
                                (size_t)m * sizeof(int32_t)) == 0)) {
            big_group_out[i] = big_group_out[other];
            nxt[i] = head[other];
            head[other] = (int32_t)i;
            if (big_rep) note_group_rep(other, i);
            break;
          }
        }
        j = (j + 1) & mask;
      }
    }
  }
  *n_groups_out = n_groups;
  *n_group_reps_out = n_group_reps;

  // probe: the seed itself (exact matches) plus every non-identity
  // single-substitution variant. Skipping a == orig makes every probe
  // string distinct — each big row at Hamming distance exactly 1 is
  // found by exactly one variant, and distance 0 only by the identity
  // probe — so the emitted pair list is duplicate-free by
  // construction. Variant hashes are precomputed per seed with their
  // home slots prefetched, overlapping the table's cache misses.
  int8_t* scratch = (int8_t*)malloc((size_t)row_bytes);
  uint64_t* vh =
      (uint64_t*)malloc((size_t)row_bytes * (size_t)alphabet *
                        sizeof(uint64_t));
  if (!scratch || !vh) {
    free(vh);
    free(scratch);
    free(head);
    arena_release(arena);
    return -1;
  }
  int64_t n_pairs = 0;
  auto probe = [&](const int8_t* qrow, const int32_t* me,
                   uint64_t h, int64_t s_i) -> int {
    const uint64_t tag = h & 0xffffffff00000000ULL;
    uint64_t j = h & mask;
    for (;;) {
      uint64_t s = slots[j];
      if (s == 0) return 0;
      if ((s & 0xffffffff00000000ULL) == tag) {
        int64_t other = (int64_t)(uint32_t)s - 1;
        if (memcmp(big_seqs + other * row_bytes, qrow,
                   (size_t)row_bytes) == 0 &&
            (m == 0 || memcmp(big_meta + other * m, me,
                              (size_t)m * sizeof(int32_t)) == 0)) {
          for (int32_t b = head[other]; b >= 0; b = nxt[b]) {
            if (n_pairs >= pairs_cap) return -1;
            pairs_out[n_pairs * 2] = s_i;
            pairs_out[n_pairs * 2 + 1] = b;
            n_pairs++;
          }
          return 0;
        }
      }
      j = (j + 1) & mask;
    }
  };
  for (int64_t s_i = 0; s_i < ns; ++s_i) {
    const int8_t* srow = small_seqs + s_i * row_bytes;
    const int32_t* me = small_meta + s_i * m;
    int64_t len = small_lens[s_i];
    memcpy(scratch, srow, (size_t)row_bytes);
    // pass 1: hash the identity and every variant, prefetching slots
    uint64_t ih = with_meta(fnv(srow, len), me, m);
    __builtin_prefetch(&slots[ih & mask], 0);
    int64_t nv = 0;
    for (int64_t p = 0; p < len; ++p) {
      const int8_t orig = srow[p];
      for (int32_t a = 0; a < alphabet; ++a) {
        if ((int8_t)a == orig) continue;
        scratch[p] = (int8_t)a;
        uint64_t h = with_meta(fnv(scratch, len), me, m);
        vh[nv++] = h;
        __builtin_prefetch(&slots[h & mask], 0);
      }
      scratch[p] = orig;
    }
    // pass 2: probe (same variant order as pass 1)
    if (probe(srow, me, ih, s_i) < 0) goto overflow;
    nv = 0;
    for (int64_t p = 0; p < len; ++p) {
      const int8_t orig = srow[p];
      for (int32_t a = 0; a < alphabet; ++a) {
        if ((int8_t)a == orig) continue;
        scratch[p] = (int8_t)a;
        if (probe(scratch, me, vh[nv++], s_i) < 0) goto overflow;
      }
      scratch[p] = orig;
    }
  }

  free(vh);
  free(scratch);
  free(head);
  arena_release(arena);
  return n_pairs;

overflow:
  free(vh);
  free(scratch);
  free(head);
  arena_release(arena);
  return -2;
}

// Thread-capable twin of group_pieces (same bit-identical guarantee).
int64_t group_pieces_mt(const int8_t* seqs, int64_t n, int64_t row_bytes,
                        const int32_t* lengths, const int32_t* meta,
                        int32_t m, int32_t piece, int32_t pieces,
                        int32_t n_threads, int64_t* group_out) {
  if (n_threads <= 1)
    return group_pieces(seqs, n, row_bytes, lengths, meta, m, piece,
                        pieces, group_out);
  if (m < 1) return -1;  // meta must carry the length column
  auto hf = [&](int64_t i) -> uint64_t {
    int64_t len = lengths[i];
    int64_t s = (len * piece) / pieces;
    int64_t e = (len * (piece + 1)) / pieces;
    const int8_t* pc = seqs + i * row_bytes + s;
    const int32_t* me = meta + i * m;
    uint64_t h = 1469598103934665603ULL;
    for (int64_t k = 0; k < e - s; ++k)
      h = (h ^ (uint64_t)(uint8_t)pc[k]) * 1099511628211ULL;
    h = mix64(h);
    for (int32_t c = 0; c < m; ++c)
      h = mix64(h ^ (uint64_t)(uint32_t)me[c]);
    return h;
  };
  auto eq = [&](int64_t i, int64_t other) -> bool {
    // meta equality implies equal length, hence identical piece
    // bounds for both rows
    if (memcmp(meta + other * m, meta + i * m,
               (size_t)m * sizeof(int32_t)) != 0)
      return false;
    int64_t len = lengths[i];
    int64_t s = (len * piece) / pieces;
    int64_t e = (len * (piece + 1)) / pieces;
    int64_t os = ((int64_t)lengths[other] * piece) / pieces;
    return memcmp(seqs + other * row_bytes + os,
                  seqs + i * row_bytes + s, (size_t)(e - s)) == 0;
  };
  return group_mt(n, n_threads, hf, eq, group_out);
}

}  // extern "C"
