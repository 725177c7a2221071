// Native data-pipeline kernels for the recsys_tpu recommender framework.
//
// The reference's L1 is pandas/sklearn (SURVEY.md §2.3) — single-threaded
// Python that becomes the bottleneck once the device step is a few ms.  This
// library provides the hot host-side paths as a C ABI consumed via ctypes
// (recsys_tpu/data/native.py):
//
//   * criteo CSV/TSV parsing: label + 13 dense ints + 26 categorical tokens
//     hashed to int64 (streaming, multithread-friendly chunk API)
//   * feature hashing (FNV-1a 64) matching the Python fallback bit-for-bit
//   * uniform negative sampling with per-user exclusion sets (the NCF /
//     SASRec protocol: n true negatives per positive, never a positive —
//     fixes reference bug §2.6.11)
//   * Fisher-Yates batch shuffling with a seeded PCG32 (deterministic)
//
// Build: `make -C native` (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <unordered_set>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- hashing
static inline uint64_t fnv1a64(const char* s, size_t n) {
  uint64_t h = 1469598103934665603ULL;
  for (size_t i = 0; i < n; ++i) {
    h ^= (uint64_t)(unsigned char)s[i];
    h *= 1099511628211ULL;
  }
  return h;
}

// hash a batch of NUL-separated tokens into [0, num_buckets)
void hash_tokens(const char* buf, const int64_t* offsets, int64_t n,
                 int64_t num_buckets, int32_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    const char* s = buf + offsets[i];
    const char* e = buf + offsets[i + 1];
    uint64_t h = fnv1a64(s, (size_t)(e - s));
    out[i] = (int32_t)(h % (uint64_t)num_buckets);
  }
}

// ------------------------------------------------------------- csv parsing
// Parse criteo rows: "label,I1..I13,C1..C26" (sep ',' or '\t').  Missing
// dense -> dense_fill; missing cat -> hash of "" bucket.  Returns rows
// parsed.  dense is min-max-scaled LATER (two-pass handled by caller);
// here raw float values are emitted.
int64_t parse_criteo(const char* path, char sep, int64_t max_rows,
                     int64_t cat_buckets, int skip_header,
                     float* labels, float* dense /* (rows,13) */,
                     int32_t* sparse /* (rows,26) */) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char* line = nullptr;
  size_t cap = 0;
  int64_t row = 0;
  if (skip_header) {
    if (getline(&line, &cap, f) < 0) {
      fclose(f);
      free(line);
      return 0;
    }
  }
  while (row < max_rows) {
    ssize_t len = getline(&line, &cap, f);
    if (len < 0) break;
    char* p = line;
    char* end = line + len;
    // strip newline
    while (end > p && (end[-1] == '\n' || end[-1] == '\r')) --end;
    int field = 0;
    char* tok = p;
    for (char* q = p; q <= end && field < 40; ++q) {
      if (q == end || *q == sep) {
        size_t tl = (size_t)(q - tok);
        if (field == 0) {
          labels[row] = tl ? (float)atof(tok) : 0.f;
        } else if (field <= 13) {
          dense[row * 13 + (field - 1)] = tl ? (float)atof(tok) : 0.f;
        } else {
          uint64_t h = fnv1a64(tok, tl);
          sparse[row * 26 + (field - 14)] =
              (int32_t)(h % (uint64_t)cat_buckets);
        }
        ++field;
        tok = q + 1;
      }
    }
    if (field >= 14) ++row;  // tolerate truncated cat tail, skip junk lines
  }
  free(line);
  fclose(f);
  return row;
}

// Chunked criteo parsing — the out-of-core ingestion primitive.  Resumes
// at byte *start_offset* (0 = file start; the header is skipped only
// then), parses up to max_rows rows, and writes the next read offset so
// the caller can stream a larger-than-RAM file through a fixed-size
// buffer.  Returns rows parsed (0 at EOF, -1 on open/seek failure).
int64_t parse_criteo_chunk(const char* path, char sep, int64_t start_offset,
                           int64_t max_rows, int64_t cat_buckets,
                           int skip_header, float* labels,
                           float* dense /* (rows,13) */,
                           int32_t* sparse /* (rows,26) */,
                           int64_t* next_offset) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  if (start_offset > 0 && fseek(f, (long)start_offset, SEEK_SET) != 0) {
    fclose(f);
    return -1;
  }
  char* line = nullptr;
  size_t cap = 0;
  int64_t row = 0;
  if (skip_header && start_offset == 0) {
    if (getline(&line, &cap, f) < 0) {
      *next_offset = ftell(f);
      fclose(f);
      free(line);
      return 0;
    }
  }
  while (row < max_rows) {
    ssize_t len = getline(&line, &cap, f);
    if (len < 0) break;
    char* p = line;
    char* end = line + len;
    while (end > p && (end[-1] == '\n' || end[-1] == '\r')) --end;
    int field = 0;
    char* tok = p;
    for (char* q = p; q <= end && field < 40; ++q) {
      if (q == end || *q == sep) {
        size_t tl = (size_t)(q - tok);
        if (field == 0) {
          labels[row] = tl ? (float)atof(tok) : 0.f;
        } else if (field <= 13) {
          dense[row * 13 + (field - 1)] = tl ? (float)atof(tok) : 0.f;
        } else {
          uint64_t h = fnv1a64(tok, tl);
          sparse[row * 26 + (field - 14)] =
              (int32_t)(h % (uint64_t)cat_buckets);
        }
        ++field;
        tok = q + 1;
      }
    }
    if (field >= 14) ++row;
  }
  *next_offset = ftell(f);
  free(line);
  fclose(f);
  return row;
}

// --------------------------------------------------------------- PCG32 rng
struct Pcg32 {
  uint64_t state, inc;
};
static inline uint32_t pcg32_next(Pcg32* r) {
  uint64_t old = r->state;
  r->state = old * 6364136223846793005ULL + r->inc;
  uint32_t xorshifted = (uint32_t)(((old >> 18u) ^ old) >> 27u);
  uint32_t rot = (uint32_t)(old >> 59u);
  return (xorshifted >> rot) | (xorshifted << ((-rot) & 31));
}
static inline uint32_t pcg32_below(Pcg32* r, uint32_t bound) {
  uint32_t threshold = (uint32_t)(-bound) % bound;
  for (;;) {
    uint32_t x = pcg32_next(r);
    if (x >= threshold) return x % bound;
  }
}

// ------------------------------------------------------ negative sampling
// For each of n_queries, draw n_neg uniform items from [lo, hi) that are
// NOT in that query's exclusion list.  Exclusion lists are CSR:
// excl_ids[excl_off[i] .. excl_off[i+1]).  out is (n_queries, n_neg).
void sample_negatives(int64_t n_queries, int32_t n_neg, int32_t lo,
                      int32_t hi, const int32_t* excl_ids,
                      const int64_t* excl_off, uint64_t seed,
                      int32_t* out) {
  for (int64_t i = 0; i < n_queries; ++i) {
    Pcg32 rng{seed + (uint64_t)i * 0x9E3779B97F4A7C15ULL, 0xDA3E39CB94B95BDBULL | 1};
    std::unordered_set<int32_t> excl(excl_ids + excl_off[i],
                                     excl_ids + excl_off[i + 1]);
    uint32_t range = (uint32_t)(hi - lo);
    for (int32_t j = 0; j < n_neg; ++j) {
      int32_t cand;
      do {
        cand = lo + (int32_t)pcg32_below(&rng, range);
      } while (excl.count(cand));
      out[i * n_neg + j] = cand;
    }
  }
}

// -------------------------------------------- leave-last-2 sequence builder
// SASRec-protocol dataset construction (mirrors the Python builder in
// recsys_tpu/data/movielens.py::build_sasrec_dataset; the per-user Python
// loop is the slowest L1 path on large ratings files).
//
// items: remapped 1-based ids (0 = pad), grouped by user in CSR form
// (user_off[u] .. user_off[u+1]).  Users with < 3 interactions are skipped.
// Exploded mode (all_positions = 0): one train row per position t in
// [1, len-3]; hist = front-padded seq[:t], pos = seq[t], one negative.
// all_positions = 1: one train row per user with len >= 4; hist =
// pad(seq[:-3]) inputs, pos = pad(seq[1:-2]) per-position targets, one
// negative per real position (pad positions 0).
// val: hist = pad(seq[:-2]), pos = seq[-2]; test: hist = pad(seq[:-1]),
// pos = seq[-1]; test_neg negatives each, never in the user's history.
// Writes row counts to out_counts = {n_train, n_eval}.
static void pad_write(const int32_t* seq, int64_t len, int32_t maxlen,
                      int32_t* dst) {
  int64_t take = len < maxlen ? len : maxlen;
  int64_t padn = maxlen - take;
  for (int64_t i = 0; i < padn; ++i) dst[i] = 0;
  memcpy(dst + padn, seq + (len - take), (size_t)take * sizeof(int32_t));
}

void build_seq_leave_last2(
    const int32_t* items, const int64_t* user_off, int64_t n_users,
    int32_t maxlen, int32_t num_items, int32_t test_neg, uint64_t seed,
    int all_positions, int32_t* tr_hist, int32_t* tr_pos, int32_t* tr_neg,
    int32_t* va_hist, int32_t* va_pos, int32_t* va_neg, int32_t* te_hist,
    int32_t* te_pos, int32_t* te_neg, int64_t* out_counts) {
  int64_t n_train = 0, n_eval = 0;
  uint32_t range = (uint32_t)(num_items - 1);  // candidates in [1, num_items)
  for (int64_t u = 0; u < n_users; ++u) {
    const int32_t* seq = items + user_off[u];
    int64_t len = user_off[u + 1] - user_off[u];
    if (len < 3) continue;
    std::unordered_set<int32_t> excl(seq, seq + len);
    Pcg32 rng{seed + (uint64_t)u * 0x9E3779B97F4A7C15ULL,
              0xDA3E39CB94B95BDBULL | 1};
    auto draw = [&]() {
      int32_t cand;
      do {
        cand = 1 + (int32_t)pcg32_below(&rng, range);
      } while (excl.count(cand));
      return cand;
    };
    if (all_positions) {
      int64_t tlen = len - 2;  // train_seq = seq[:-2]
      if (tlen >= 2) {
        pad_write(seq, tlen - 1, maxlen, tr_hist + n_train * maxlen);
        pad_write(seq + 1, tlen - 1, maxlen, tr_pos + n_train * maxlen);
        int32_t* neg = tr_neg + n_train * maxlen;
        const int32_t* tgt = tr_pos + n_train * maxlen;
        for (int32_t j = 0; j < maxlen; ++j)
          neg[j] = tgt[j] > 0 ? draw() : 0;
        ++n_train;
      }
    } else {
      for (int64_t t = 1; t <= len - 3; ++t) {
        pad_write(seq, t, maxlen, tr_hist + n_train * maxlen);
        tr_pos[n_train] = seq[t];
        tr_neg[n_train] = draw();
        ++n_train;
      }
    }
    pad_write(seq, len - 2, maxlen, va_hist + n_eval * maxlen);
    va_pos[n_eval] = seq[len - 2];
    for (int32_t j = 0; j < test_neg; ++j)
      va_neg[n_eval * test_neg + j] = draw();
    pad_write(seq, len - 1, maxlen, te_hist + n_eval * maxlen);
    te_pos[n_eval] = seq[len - 1];
    for (int32_t j = 0; j < test_neg; ++j)
      te_neg[n_eval * test_neg + j] = draw();
    ++n_eval;
  }
  out_counts[0] = n_train;
  out_counts[1] = n_eval;
}

// -------------------------------------------- fused-update host prep
// Sort/bucket one table group's vocab ids for the fused streaming update
// kernel (recsys_tpu/train/streaming_embed.py semantics, bit-exact with
// the numpy host_prep_group): counting sort by physical row (stable),
// chunk-aligned per-block segments at the STATIC chunk count
// nc_max = n/ch + nb.  O(n + vp) single pass — replaces a per-table
// np.argsort on the Trainer's prefetch thread.
//
// shards > 1 (model-axis row-sharded tables, vp % shards == 0): block
// fences align to shard boundaries — shard s owns rows [s*vs, (s+1)*vs)
// in nb_s = ceil(vs/block) blocks, nb = shards*nb_s total, so each model
// shard consumes cptr[s*nb_s .. (s+1)*nb_s] against its local table.
void fused_prep(const int32_t* ids, int64_t n, int32_t pack, int32_t vp,
                int32_t block, int32_t ch, int32_t shards,
                int32_t* ids2d /* (nc_max, ch) */,
                int32_t* idx /* (nc_max*ch,) */,
                int32_t* cptr /* (nb+1,) */) {
  if (shards < 1 || vp % shards) return;  // caller validates; never scatter
                                          // past the buffers on bad shards
  int32_t vs = vp / shards;
  int32_t nb_s = (vs + block - 1) / block;
  int32_t nb = shards * nb_s;
  int64_t nc_max = n / ch + nb;
  int32_t sentinel = nb * block * pack;
  for (int64_t i = 0; i < nc_max * ch; ++i) {
    ids2d[i] = sentinel;
    idx[i] = 0;
  }
  std::vector<int64_t> start((size_t)vp + 1, 0);
  for (int64_t i = 0; i < n; ++i) start[(size_t)(ids[i] / pack) + 1]++;
  for (int64_t p = 0; p < vp; ++p) start[p + 1] += start[p];
  std::vector<int64_t> seg_start((size_t)nb, 0);
  cptr[0] = 0;
  for (int32_t k = 0; k < nb; ++k) {
    int32_t s = k / nb_s;
    int64_t lo = (int64_t)s * vs + (int64_t)(k - s * nb_s) * block;
    int64_t shard_hi = (int64_t)(s + 1) * vs;
    int64_t hi = lo + block < shard_hi ? lo + block : shard_hi;
    seg_start[k] = start[lo];
    int64_t seg = start[hi] - start[lo];
    cptr[k + 1] = cptr[k] + (int32_t)((seg + ch - 1) / ch);
  }
  cptr[nb] = (int32_t)nc_max;  // padding chunks absorbed by the last block
  std::vector<int64_t> cur(start.begin(), start.end() - 1);
  for (int64_t i = 0; i < n; ++i) {
    int32_t p = ids[i] / pack;
    int64_t s = cur[p]++;
    int32_t sh = p / vs;
    int32_t k = sh * nb_s + (p - sh * vs) / block;
    int64_t dst = (int64_t)cptr[k] * ch + (s - seg_start[k]);
    ids2d[dst] = ids[i];
    idx[dst] = (int32_t)i;
  }
}

// ------------------------------------------------------------- shuffling
// Deterministic Fisher-Yates permutation of [0, n).
void shuffle_indices(int64_t n, uint64_t seed, int64_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = i;
  Pcg32 rng{seed, 0xDA3E39CB94B95BDBULL | 1};
  for (int64_t i = n - 1; i > 0; --i) {
    int64_t j = (int64_t)pcg32_below(&rng, (uint32_t)(i + 1));
    int64_t t = out[i];
    out[i] = out[j];
    out[j] = t;
  }
}

}  // extern "C"
