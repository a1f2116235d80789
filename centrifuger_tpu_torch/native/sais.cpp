// SA-IS suffix array construction (linear time, induced sorting).
//
// Native replacement for the reference's blockwise difference-cover sorter
// (compactds/SuffixArrayGenerator.hpp) on the offline index-build path: the
// TPU framework builds indexes host-side, so a single fast linear-time SA over
// the packed text replaces the memory-bounded chunked sort for databases that
// fit in RAM.  Exposed via a C ABI for ctypes.
//
// Ordering convention: caller appends a unique smallest sentinel, giving the
// reference's sentinel-free "shorter suffix sorts first" order
// (compactds/FixedSizeElemArray.hpp SubrangeCompare) after dropping SA[0].

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

typedef int64_t idx_t;

// Generic SA-IS over an integer alphabet [0, K). s[n-1] must be the unique
// minimum (sentinel).
void sais_core(const idx_t* s, idx_t* sa, idx_t n, idx_t K,
               std::vector<idx_t>& workspace) {
  if (n == 1) {
    sa[0] = 0;
    return;
  }
  std::vector<bool> is_s(n);
  is_s[n - 1] = true;
  for (idx_t i = n - 2; i >= 0; --i)
    is_s[i] = (s[i] < s[i + 1]) || (s[i] == s[i + 1] && is_s[i + 1]);

  auto is_lms = [&](idx_t i) { return i > 0 && is_s[i] && !is_s[i - 1]; };

  std::vector<idx_t> bkt(K + 1);
  auto make_buckets = [&](bool ends) {
    std::fill(bkt.begin(), bkt.end(), 0);
    for (idx_t i = 0; i < n; ++i) ++bkt[s[i] + 1];
    for (idx_t i = 1; i <= K; ++i) bkt[i] += bkt[i - 1];
    // bkt[c] = start of bucket c; for ends we need one past the last
    if (ends) {
      // compute end positions: cum counts
      std::fill(bkt.begin(), bkt.end(), 0);
      for (idx_t i = 0; i < n; ++i) ++bkt[s[i]];
      idx_t sum = 0;
      for (idx_t i = 0; i < K; ++i) {
        sum += bkt[i];
        bkt[i] = sum;  // end (exclusive) of bucket i
      }
    }
  };

  auto induce = [&](const std::vector<idx_t>& lms) {
    std::fill(sa, sa + n, -1);
    // place LMS suffixes at bucket ends (in reverse order)
    make_buckets(true);
    for (idx_t i = (idx_t)lms.size() - 1; i >= 0; --i) {
      idx_t p = lms[i];
      sa[--bkt[s[p]]] = p;
    }
    // induce L-type from left to right
    make_buckets(false);
    for (idx_t i = 0; i < n; ++i) {
      idx_t p = sa[i];
      if (p > 0 && !is_s[p - 1]) sa[bkt[s[p - 1]]++] = p - 1;
    }
    // induce S-type from right to left
    make_buckets(true);
    for (idx_t i = n - 1; i >= 0; --i) {
      idx_t p = sa[i];
      if (p > 0 && is_s[p - 1]) sa[--bkt[s[p - 1]]] = p - 1;
    }
  };

  // 1) induce with unsorted LMS positions (text order)
  std::vector<idx_t> lms;
  lms.reserve(n / 2 + 1);
  for (idx_t i = 1; i < n; ++i)
    if (is_lms(i)) lms.push_back(i);
  induce(lms);

  // 2) name LMS substrings in SA order
  idx_t nl = (idx_t)lms.size();
  std::vector<idx_t> name_of(n, -1);
  idx_t names = 0;
  idx_t prev = -1;
  for (idx_t i = 0; i < n; ++i) {
    idx_t p = sa[i];
    if (p <= 0 || !is_lms(p)) continue;
    if (prev == -1) {
      name_of[p] = names++;
    } else {
      // compare LMS substrings at prev and p
      bool same = true;
      for (idx_t d = 0;; ++d) {
        if (prev + d >= n || p + d >= n) { same = false; break; }
        if (s[prev + d] != s[p + d] || is_s[prev + d] != is_s[p + d]) {
          same = false;
          break;
        }
        if (d > 0 && (is_lms(prev + d) || is_lms(p + d))) {
          same = is_lms(prev + d) && is_lms(p + d);
          break;
        }
      }
      if (!same) ++names;
      name_of[p] = names - 1;
    }
    prev = p;
  }

  // 3) recurse if names are not unique
  std::vector<idx_t> s1(nl), sa1(nl);
  {
    idx_t j = 0;
    for (idx_t i = 1; i < n; ++i)
      if (is_lms(i)) s1[j++] = name_of[i];
  }
  if (names < nl) {
    sais_core(s1.data(), sa1.data(), nl, names, workspace);
  } else {
    for (idx_t i = 0; i < nl; ++i) sa1[s1[i]] = i;
  }

  // 4) final induce with sorted LMS order
  std::vector<idx_t> lms_sorted(nl);
  for (idx_t i = 0; i < nl; ++i) lms_sorted[i] = lms[sa1[i]];
  induce(lms_sorted);
}

}  // namespace

extern "C" {

// codes: n bytes with values in [0, sigma); writes n entries into sa_out.
// Ordering: shorter-suffix-first (sentinel-free reference convention).
int sais_u8(const uint8_t* codes, int64_t n, int32_t sigma, int64_t* sa_out) {
  if (n <= 0) return 0;
  std::vector<idx_t> s(n + 1);
  for (idx_t i = 0; i < n; ++i) s[i] = (idx_t)codes[i] + 1;
  s[n] = 0;  // sentinel, unique minimum
  std::vector<idx_t> sa(n + 1);
  std::vector<idx_t> ws;
  sais_core(s.data(), sa.data(), n + 1, (idx_t)sigma + 1, ws);
  // sa[0] == n (sentinel); drop it
  std::memcpy(sa_out, sa.data() + 1, sizeof(idx_t) * n);
  return 0;
}
}
