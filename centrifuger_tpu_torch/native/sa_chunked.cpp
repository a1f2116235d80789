// Port of centrifuger_tpu/native/sa_chunked.cpp (host code, no accelerator);
// its chunk sort places positions in the caller's buffer (no per-batch copies).
// Memory-bounded, multi-threaded, chunked suffix-array construction.
//
// The reference builds large suffix arrays blockwise under a --build-mem
// budget (compactds/SuffixArrayGenerator.hpp, compactds/FMBuilder.hpp:444-811):
// a difference-cover sample bounds every suffix comparison, and chunks of at
// most ~bmax suffixes are sorted independently so peak memory stays at
// text + DC sample + threads * bmax. This file is an independent design with
// the same capability:
//
//   * chunks are k-mer prefix ranges (integer compare classification instead
//     of the reference's LCP-accelerated cut-suffix compares),
//   * the difference cover uses the square construction D = {0..r-1} u {j*r}
//     for period v = r^2, giving delta(i,j) in O(1),
//   * the DC sample is sorted by multikey quicksort to depth v, then
//     Larsson-Sadakane style doubling with step v,
//   * each chunk is sorted by multikey quicksort that falls back to the O(1)
//     DC rank comparison at depth v.
//
// Suffix order semantics match fm/suffix_array.py: no sentinel, a shorter
// suffix sorts before any suffix it prefixes (virtual -1 past the end).
//
// Exposed C API (driven from Python via ctypes; the Python side plans chunk
// ranges from a k-mer histogram, accumulates BWT/aux arrays, and handles
// checkpoint/resume):
//   sac_create / sac_destroy
//   sac_dc_init(threads)            -- sample sort (the big offline step)
//   sac_dc_save / sac_dc_load       -- checkpoint the sample ranks
//   sac_kmer_hist(k, out[4^k])      -- one text scan
//   sac_sort_chunks(k, lo[], hi[], nchunks, threads, out, cap, offsets[])

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <algorithm>
#include <atomic>
#include <thread>
#include <vector>

namespace {

struct Sac {
  const uint8_t* codes = nullptr;  // caller-owned
  int64_t n = 0;
  int32_t sigma = 0;
  int32_t bits = 2;        // bits per char in k-mer keys (log2ceil sigma)
  int32_t v = 0;           // DC period (perfect square r*r)
  int32_t r = 0;
  int32_t m = 0;           // |D| = 2r - 1
  std::vector<int32_t> didx;     // residue -> compact index in D, or -1
  std::vector<int64_t> dc_rank;  // cidx -> rank  (the sample ISA)
  bool dc_ready = false;

  inline int32_t chr(int64_t p) const {
    return p < n ? (int32_t)codes[p] : -1;
  }
  inline int64_t cidx(int64_t p) const {
    return (p / v) * m + didx[p % v];
  }
  // smallest d >= 0 with (i+d) % v and (j+d) % v both in D
  inline int64_t delta(int64_t i, int64_t j) const {
    int64_t di = i % v, dj = j % v;
    int64_t d = dj - di; if (d < 0) d += v;
    int64_t a = d / r, b = d % r;
    int64_t x = (b == 0) ? 0 : (r - b);
    int64_t dd = x - di; if (dd < 0) dd += v;
    return dd;
  }
  // full suffix comparison: first delta chars, then DC ranks (valid only when
  // both suffixes have >= v characters, which delta < v then guarantees)
  inline bool suf_less_dc(int64_t i, int64_t j) const {
    int64_t dd = delta(i, j);
    for (int64_t t = 0; t < dd; t++) {
      int32_t a = chr(i + t), b = chr(j + t);
      if (a != b) return a < b;
    }
    return dc_rank[cidx(i + dd)] < dc_rank[cidx(j + dd)];
  }
};

// ---------------------------------------------------------------- mkqsort

// ternary-split multikey quicksort of suffix positions by characters from
// `depth`, switching to the DC comparison once depth reaches v
void mkq_sort(const Sac& S, int64_t* a, int64_t len, int64_t depth,
              int64_t dc_depth) {
  while (true) {
    if (len <= 1) return;
    if (depth >= dc_depth) {
      if (!S.dc_ready) return;  // initial sample sort: v-prefix ties keep
                                // arbitrary order (ranks re-check equality)
      // all suffixes share >= v chars -> O(1) compare via DC ranks
      std::sort(a, a + len, [&S](int64_t x, int64_t y) {
        return S.suf_less_dc(x, y);
      });
      return;
    }
    if (len < 12) {  // insertion sort on (char-at-depth..) suffix compare
      for (int64_t i = 1; i < len; i++) {
        int64_t x = a[i];
        int64_t j = i;
        while (j > 0) {
          int64_t y = a[j - 1];
          // compare suffixes x, y from `depth`
          bool less = false;
          for (int64_t t = depth; ; t++) {
            if (t >= dc_depth) {
              less = S.dc_ready ? S.suf_less_dc(x, y) : false;
              break;
            }
            int32_t cx = S.chr(x + t), cy = S.chr(y + t);
            if (cx != cy) { less = cx < cy; break; }
            if (cx < 0) { less = false; break; }  // equal ends
          }
          if (!less) break;
          a[j] = y; j--;
        }
        a[j] = x;
      }
      return;
    }
    // median-of-three pivot char at `depth`
    int32_t c1 = S.chr(a[0] + depth), c2 = S.chr(a[len / 2] + depth),
            c3 = S.chr(a[len - 1] + depth);
    int32_t pv = std::max(std::min(c1, c2), std::min(std::max(c1, c2), c3));
    int64_t lt = 0, gt = len, i = 0;
    while (i < gt) {
      int32_t c = S.chr(a[i] + depth);
      if (c < pv) std::swap(a[lt++], a[i++]);
      else if (c > pv) std::swap(a[--gt], a[i]);
      else i++;
    }
    // recurse smaller sides, iterate the largest (bounded stack)
    mkq_sort(S, a, lt, depth, dc_depth);
    mkq_sort(S, a + gt, len - gt, depth, dc_depth);
    if (pv < 0) {
      // the == group are suffixes that END at depth: all equal (at most one
      // real element; duplicates impossible)
      return;
    }
    a += lt; len = gt - lt; depth += 1;  // == group, next char
  }
}

// ------------------------------------------------------------ DC sample sort

void dc_sample_sort(Sac& S, int32_t threads) {
  const int64_t n = S.n, v = S.v, m = S.m;
  // collect sample positions
  std::vector<int64_t> pos;
  pos.reserve((n / v + 1) * m);
  for (int64_t blk = 0; blk * v < n; blk++) {
    int64_t base = blk * v;
    for (int32_t t = 0; t < S.r && base + t < n; t++) pos.push_back(base + t);
    for (int32_t j2 = 1; j2 < S.r; j2++) {
      int64_t p = base + (int64_t)j2 * S.r;
      if (p < n) pos.push_back(p);
    }
  }
  std::sort(pos.begin(), pos.end());
  const int64_t s = (int64_t)pos.size();

  // initial order: multikey quicksort by the first v characters, in parallel
  // over top-level char buckets
  std::vector<int64_t> order = pos;
  {
    // bucket by first char to parallelize
    std::vector<std::vector<int64_t>> buckets(S.sigma + 1);
    for (int64_t i = 0; i < s; i++) {
      int32_t c = S.chr(order[i]);
      buckets[c < 0 ? 0 : c + 1].push_back(order[i]);
    }
    int64_t off = 0;
    std::vector<std::pair<int64_t, int64_t>> spans;
    for (auto& b : buckets) {
      std::copy(b.begin(), b.end(), order.begin() + off);
      if (b.size() > 1) spans.push_back({off, (int64_t)b.size()});
      off += (int64_t)b.size();
    }
    std::atomic<size_t> next(0);
    auto work = [&]() {
      size_t w;
      while ((w = next.fetch_add(1)) < spans.size()) {
        mkq_sort(S, order.data() + spans[w].first, spans[w].second, 1,
                 /*dc_depth=*/v);  // dc not ready: depth cap v never consults
      }
    };
    std::vector<std::thread> ts;
    for (int32_t t = 0; t < threads; t++) ts.emplace_back(work);
    for (auto& t : ts) t.join();
  }

  // initial ranks: equal first-v-chars groups share a rank
  std::vector<int64_t>& rank = S.dc_rank;
  rank.assign((n / v + 1) * m, -1);
  {
    int64_t rk = 0;
    rank[S.cidx(order[0])] = 0;
    for (int64_t i = 1; i < s; i++) {
      // equal iff neither suffix ends within v chars and chars match
      int64_t x = order[i - 1], y = order[i];
      bool eq = true;
      for (int64_t t = 0; t < v; t++) {
        int32_t a = S.chr(x + t), b = S.chr(y + t);
        if (a != b || a < 0) { eq = (a == b); break; }
      }
      if (!eq) rk = i;
      rank[S.cidx(y)] = rk;
    }
  }

  // Larsson-Sadakane style doubling with step v (prefix v*2^t)
  std::vector<int64_t> key2(s);
  for (int64_t h = v;; h *= 2) {
    auto rank_at = [&](int64_t p) -> int64_t {
      return p < n ? rank[S.cidx(p)] : -1;
    };
    // sort by (rank[i], rank[i+h]) -- parallel merge not needed; std::sort
    std::sort(order.begin(), order.end(), [&](int64_t x, int64_t y) {
      int64_t rx = rank[S.cidx(x)], ry = rank[S.cidx(y)];
      if (rx != ry) return rx < ry;
      return rank_at(x + h) < rank_at(y + h);
    });
    // re-rank
    std::vector<int64_t> nr(s);
    nr[0] = 0;
    bool all_distinct = true;
    for (int64_t i = 1; i < s; i++) {
      int64_t x = order[i - 1], y = order[i];
      bool eq = rank[S.cidx(x)] == rank[S.cidx(y)] &&
                rank_at(x + h) == rank_at(y + h);
      nr[i] = eq ? nr[i - 1] : i;
      if (eq) all_distinct = false;
    }
    for (int64_t i = 0; i < s; i++) rank[S.cidx(order[i])] = nr[i];
    if (all_distinct) break;
    if (h > 2 * n) break;  // safety; cannot happen for distinct suffixes
  }
  S.dc_ready = true;
}

}  // namespace

extern "C" {

void* sac_create(const uint8_t* codes, int64_t n, int32_t sigma,
                 int32_t dcv) {
  Sac* S = new Sac();
  S->codes = codes;
  S->n = n;
  S->sigma = sigma;
  S->bits = 1;
  while ((1 << S->bits) < sigma) S->bits++;
  // round dcv up to a perfect square r*r with r >= 2
  int32_t r = 2;
  while (r * r < dcv) r++;
  S->r = r;
  S->v = r * r;
  S->m = 2 * r - 1;
  S->didx.assign(S->v, -1);
  int32_t c = 0;
  for (int32_t t = 0; t < r; t++) S->didx[t] = c++;
  for (int32_t j = 1; j < r; j++) S->didx[(int64_t)j * r] = c++;
  // note {0..r-1} and {j*r} overlap only at 0 -> m = 2r - 1 compact slots
  return S;
}

int32_t sac_v(void* h) { return ((Sac*)h)->v; }

void sac_destroy(void* h) { delete (Sac*)h; }

int sac_dc_init(void* h, int32_t threads) {
  Sac* S = (Sac*)h;
  if (S->n == 0) { S->dc_ready = true; return 0; }
  dc_sample_sort(*S, threads < 1 ? 1 : threads);
  return 0;
}

int64_t sac_dc_size(void* h) { return (int64_t)((Sac*)h)->dc_rank.size(); }

void sac_dc_save(void* h, int64_t* out) {
  Sac* S = (Sac*)h;
  std::memcpy(out, S->dc_rank.data(), S->dc_rank.size() * sizeof(int64_t));
}

void sac_dc_load(void* h, const int64_t* in, int64_t sz) {
  Sac* S = (Sac*)h;
  S->dc_rank.assign(in, in + sz);
  S->dc_ready = true;
}

// k-mer histogram over all suffixes (short suffixes use zero-padded keys)
void sac_kmer_hist(void* h, int32_t k, int64_t* out /* size (1<<bits*k) */) {
  Sac* S = (Sac*)h;
  const int64_t n = S->n;
  const int32_t bits = S->bits;
  const uint64_t size = 1ull << ((uint64_t)bits * k);
  std::memset(out, 0, size * sizeof(int64_t));
  uint64_t key = 0;
  for (int64_t p = n - 1; p >= 0; p--) {
    key = ((uint64_t)S->codes[p] << (bits * (k - 1))) | (key >> bits);
    out[key]++;
  }
}

// classify every suffix into the batch's consecutive k-mer ranges
// [lo[i], hi[i]) and sort each chunk. Results packed into `out` with
// offsets[i]..offsets[i+1] per chunk. Returns total count, or -1 if cap
// exceeded. Two scans of the text (count, then place) put every position
// straight into `out`, so a batch needs no memory beyond `out` itself.
int64_t sac_sort_chunks(void* h, int32_t k, const uint64_t* lo,
                        const uint64_t* hi, int32_t nchunks, int32_t threads,
                        int64_t* out, int64_t cap, int64_t* offsets) {
  Sac* S = (Sac*)h;
  const int64_t n = S->n;
  const int32_t bits = S->bits;
  const uint64_t LO = lo[0], HI = hi[nchunks - 1];
  if (threads < 1) threads = 1;
  const int64_t per = (n + threads - 1) / threads;

  // each thread walks a text range backward, seeding the rolling key from
  // beyond its range; place == false counts into next[t][i], place == true
  // writes each position at next[t][i]++
  std::vector<std::vector<int64_t>> next(threads,
                                         std::vector<int64_t>(nchunks, 0));
  auto scan = [&](bool place) {
    std::vector<std::thread> ts;
    for (int32_t t = 0; t < threads; t++) {
      ts.emplace_back([&, t, place]() {
        int64_t beg = (int64_t)t * per;
        int64_t end = std::min(n, beg + per);
        if (beg >= end) return;
        int64_t* mine = next[t].data();
        uint64_t key = 0;
        for (int64_t p = std::min(n, end + k) - 1; p >= end; p--)
          key = ((uint64_t)S->codes[p] << (bits * (k - 1))) | (key >> bits);
        for (int64_t p = end - 1; p >= beg; p--) {
          key = ((uint64_t)S->codes[p] << (bits * (k - 1))) | (key >> bits);
          if (key < LO || key >= HI) continue;
          // chunk = first i with key < hi[i]
          int32_t i = (int32_t)(std::upper_bound(hi, hi + nchunks, key) - hi);
          if (place) out[mine[i]++] = p;
          else mine[i]++;
        }
      });
    }
    for (auto& t : ts) t.join();
  };
  scan(false);

  // chunk i holds thread 0's positions, then thread 1's, ...
  int64_t total = 0;
  for (int32_t i = 0; i < nchunks; i++) {
    offsets[i] = total;
    for (int32_t t = 0; t < threads; t++) {
      int64_t c = next[t][i];
      next[t][i] = total;
      total += c;
    }
  }
  offsets[nchunks] = total;
  if (total > cap) return -1;
  scan(true);

  // concurrent chunk sorts, in place
  {
    std::atomic<int32_t> nx(0);
    auto work = [&]() {
      int32_t i;
      while ((i = nx.fetch_add(1)) < nchunks) {
        mkq_sort(*S, out + offsets[i], offsets[i + 1] - offsets[i], 0, S->v);
      }
    };
    std::vector<std::thread> ts;
    for (int32_t t = 0; t < threads; t++) ts.emplace_back(work);
    for (auto& t : ts) t.join();
  }
  return total;
}

}  // extern "C"
