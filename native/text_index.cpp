// Native full-text dictionary: word -> postings (doc -> positions+masks),
// stem tree, per-doc token store — the ingest/query hot path of the text
// engine (reference: src/indexes/text/{text_index,posting}.{h,cc} — rax +
// C++ postings; the Python tier keeps only the radix trees for structure
// walks, updated from this module's word-birth/death events).
//
// Thread-safety: every entry point locks the index mutex; ctypes releases
// the GIL around calls, so writer threads indexing different engines (or
// shards) run truly parallel (reference writer pool, P2).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

extern "C" int lexer_tokenize(void* h, const char* text, int len, char* out,
                              int out_cap);

namespace {

using std::string;

struct Posting {
  // Packed flat postings (reference: posting.cc / flat_position_map.cc
  // keep per-word compressed position maps; the round-1 design here —
  // unordered_map<doc, vector<pair>> + a parallel agg map — cost ~136
  // bytes per (doc,pos) in node/alloc overhead, ~5x the reference's
  // published 6.6-8.2 B/word, docs/full-text/space-consumption.md:20-45).
  //
  // One entry = doc<<32 | pos<<8 | mask8, kept sorted by (doc, pos):
  // 8 bytes per position, span lookups by binary search, and fresh docs
  // (monotonically increasing ids — the ingest common case) append in
  // O(1). Field bits >= 8 or positions >= 2^24 go to `wide`; a (doc,pos)
  // lives in exactly ONE of base/wide (a wide add migrates any base
  // entry), so counts stay exact and reads need no cross-dedup.
  std::vector<uint64_t> base;
  std::unordered_map<int32_t, std::vector<std::pair<int32_t, uint64_t>>> wide;
  int64_t position_count = 0;
  int32_t doc_count = 0;  // distinct docs across base+wide

  static uint64_t pack(int32_t doc, int32_t pos, uint64_t m8) {
    return ((uint64_t)(uint32_t)doc << 32) | ((uint64_t)(uint32_t)pos << 8) |
           m8;
  }
  static int32_t edoc(uint64_t e) { return (int32_t)(e >> 32); }
  static int32_t epos(uint64_t e) { return (int32_t)((e >> 8) & 0xFFFFFF); }
  static uint64_t emask(uint64_t e) { return e & 0xFF; }

  // [lo, hi) span of doc in base
  std::pair<size_t, size_t> span(int32_t doc) const {
    const uint64_t k0 = pack(doc, 0, 0);
    const uint64_t k1 = k0 + (1ull << 32);
    auto lo = std::lower_bound(base.begin(), base.end(), k0);
    auto hi = std::lower_bound(lo, base.end(), k1);
    return {(size_t)(lo - base.begin()), (size_t)(hi - base.begin())};
  }

  bool in_wide(int32_t doc) const {
    return !wide.empty() && wide.count(doc) > 0;
  }

  void add(int32_t doc, int32_t pos, uint64_t bit) {
    if (bit < 256 && (uint32_t)pos < (1u << 24)) {
      // a mixed-mask (doc,pos) already migrated to wide keeps accruing there
      if (!wide.empty()) {
        auto wit = wide.find(doc);
        if (wit != wide.end()) {
          for (auto& pm : wit->second) {
            if (pm.first == pos) {
              pm.second |= bit;
              return;
            }
          }
        }
      }
      const uint64_t key = pack(doc, pos, 0);
      if (base.empty() || key > (base.back() & ~0xFFull)) {
        if ((base.empty() || edoc(base.back()) != doc) && !in_wide(doc))
          ++doc_count;
        base.push_back(key | bit);
        ++position_count;
        return;
      }
      auto it = std::lower_bound(base.begin(), base.end(), key);
      if (it != base.end() && ((*it) & ~0xFFull) == key) {
        *it |= bit;
        return;
      }
      bool has_doc =
          (it != base.end() && edoc(*it) == doc) ||
          (it != base.begin() && edoc(*(it - 1)) == doc) || in_wide(doc);
      if (!has_doc) ++doc_count;
      base.insert(it, key | bit);
      ++position_count;
      return;
    }
    // wide path: high field bits or huge positions
    auto [lo, hi] = span(doc);
    bool had_doc = lo != hi || in_wide(doc);
    auto& v = wide[doc];
    for (auto& pm : v) {
      if (pm.first == pos) {
        pm.second |= bit;
        return;
      }
    }
    // migrate an existing base entry for this (doc,pos) so the pair has
    // one home (keeps remove/read/count logic single-sourced)
    uint64_t extra = 0;
    if ((uint32_t)pos < (1u << 24)) {
      const uint64_t key = pack(doc, pos, 0);
      auto it = std::lower_bound(base.begin() + lo, base.begin() + hi, key);
      if (it != base.begin() + hi && ((*it) & ~0xFFull) == key) {
        extra = emask(*it);
        base.erase(it);
        --position_count;
      }
    }
    v.emplace_back(pos, bit | extra);
    ++position_count;
    if (!had_doc) ++doc_count;
  }

  // drop one field's contribution for a doc
  void remove_field(int32_t doc, uint64_t bit) {
    auto [lo, hi] = span(doc);
    bool had_doc = lo != hi;
    if (bit < 256 && lo != hi) {
      size_t w = lo;
      for (size_t i = lo; i < hi; ++i) {
        const uint64_t m = emask(base[i]) & ~bit;
        if (m) {
          base[w++] = (base[i] & ~0xFFull) | m;
        } else {
          --position_count;
        }
      }
      base.erase(base.begin() + w, base.begin() + hi);
      hi = w;
    }
    auto wit = wide.find(doc);
    if (wit != wide.end()) {
      had_doc = true;
      auto& v = wit->second;
      size_t w = 0;
      for (size_t i = 0; i < v.size(); ++i) {
        const uint64_t m = v[i].second & ~bit;
        if (m) {
          v[w++] = {v[i].first, m};
        } else {
          --position_count;
        }
      }
      v.resize(w);
      if (v.empty()) wide.erase(wit);
    }
    if (had_doc && lo == hi && !in_wide(doc)) --doc_count;
  }

  // OR of all field masks for doc (the old agg-map lookup)
  uint64_t doc_mask(int32_t doc) const {
    uint64_t m = 0;
    auto [lo, hi] = span(doc);
    for (size_t i = lo; i < hi; ++i) m |= emask(base[i]);
    if (!wide.empty()) {
      auto wit = wide.find(doc);
      if (wit != wide.end())
        for (const auto& pm : wit->second) m |= pm.second;
    }
    return m;
  }

  bool empty() const { return base.empty() && wide.empty(); }
};

struct TextIndex {
  void* lexer = nullptr;  // borrowed lexer handle (lexer_create owner frees)
  std::mutex mu;
  std::unordered_map<string, int32_t> word_ids;
  std::vector<string> word_names;
  std::vector<std::unique_ptr<Posting>> postings;  // by word id
  // stem id -> {word id -> refcount}; stems interned in the same table
  std::unordered_map<int32_t, std::unordered_map<int32_t, int32_t>> stems;
  // word id -> its stem id (set when first linked; stem(word) is a pure
  // function so the mapping never changes while the word is alive)
  std::unordered_map<int32_t, int32_t> stem_of;
  // (doc << 6 | field bit index) -> token word-ids in position order
  // The forward index exists only so a field update/removal can find the
  // words whose postings reference it (reference: per-key text indexes,
  // text_index.h) — order and multiplicity are irrelevant, so store the
  // UNIQUE word-id set as sorted delta-varints (~1-2 B per distinct word
  // per field instead of 4 B per token).
  std::unordered_map<int64_t, std::vector<uint8_t>> doc_tokens;
  // reusable doc-id bitmap for posting unions (guarded by mu); doc ids
  // are dense interner ids, so a bitset beats sort-and-unique by ~10x on
  // wide fuzzy/wildcard expansions over hot words
  std::vector<uint64_t> union_bits;

  static void encode_wids(const std::vector<int32_t>& sorted_uniq,
                          std::vector<uint8_t>& out) {
    uint32_t prev = 0;
    for (int32_t id : sorted_uniq) {
      uint32_t d = (uint32_t)id - prev;
      prev = (uint32_t)id;
      while (d >= 0x80) {
        out.push_back((uint8_t)(d | 0x80));
        d >>= 7;
      }
      out.push_back((uint8_t)d);
    }
  }
  static void decode_wids(const std::vector<uint8_t>& in,
                          std::vector<int32_t>& out) {
    uint32_t prev = 0;
    size_t i = 0;
    while (i < in.size()) {
      uint32_t d = 0;
      int shift = 0;
      while (in[i] & 0x80) {
        d |= (uint32_t)(in[i++] & 0x7F) << shift;
        shift += 7;
      }
      d |= (uint32_t)in[i++] << shift;
      prev += d;
      out.push_back((int32_t)prev);
    }
  }
  std::vector<char> tokbuf;

  // Ids are never recycled: an id may outlive its posting (a dropped
  // word can still be a live stem, and doc_tokens/stems reference ids) —
  // the string table grows with the all-time vocabulary, which is modest.
  // Ordered vocabulary views for native matcher expansion (reference
  // radix_tree.h:14-56 prefix walks; the rax equivalent here is a pair of
  // std::maps — lexicographic range walks over forward and reversed
  // spellings). Dead words (posting dropped) stay in the maps and are
  // skipped by a postings-liveness check at walk time, mirroring how ids
  // outlive postings everywhere else in this struct.
  std::map<string, int32_t> sorted_words;
  std::map<string, int32_t> sorted_rev;

  int32_t intern(const string& w) {
    auto it = word_ids.find(w);
    if (it != word_ids.end()) return it->second;
    int32_t id = (int32_t)word_names.size();
    word_names.push_back(w);
    postings.emplace_back(nullptr);
    word_ids.emplace(w, id);
    sorted_words.emplace(w, id);
    sorted_rev.emplace(string(w.rbegin(), w.rend()), id);
    return id;
  }

  int32_t lookup(const char* w) const {
    auto it = word_ids.find(w);
    return it == word_ids.end() ? -1 : it->second;
  }

  string last_events;  // EventOut scratch (see tix_last_events)

  void stem_link(int32_t stem_id, int32_t word_id, int delta) {
    auto& bag = stems[stem_id];
    int32_t n = (bag.count(word_id) ? bag[word_id] : 0) + delta;
    if (n > 0) {
      bag[word_id] = n;
    } else {
      bag.erase(word_id);
      if (bag.empty()) stems.erase(stem_id);
    }
  }
};

// event blob writer: '+word\0' new dictionary word, '-word\0' dropped word,
// first byte is the result code ('A' added / 'M' modified / 'R' removed /
// 'S' skipped). Events accumulate in a heap string owned by the index so a
// caller whose buffer is too small can fetch them afterwards via
// tix_last_events — the mutation must NOT be re-executed on retry (the
// first execution already created the postings, so a re-run would emit no
// '+word' births and the Python dictionary mirror would silently miss
// those words forever).
struct EventOut {
  string& buf;
  explicit EventOut(string& b) : buf(b) { buf.clear(); }
  void put(char tag, const string& word) {
    buf += tag;
    buf += word;
    buf += '\0';
  }
  void code(char c) { buf += c; }
  // copy into the caller's buffer; -(needed) when it does not fit
  int finish(char* out, int out_cap) const {
    const int n = (int)buf.size();
    if (n > out_cap) return -n;
    std::memcpy(out, buf.data(), n);
    return n;
  }
};

// Bounded Levenshtein (early-exit banded DP): matches the Python radix
// fuzzy walk's distance definition (text/radix.py DP-row tree walk).
bool lev_within(const string& a, const string& b, int maxd) {
  const int la = (int)a.size(), lb = (int)b.size();
  if (la - lb > maxd || lb - la > maxd) return false;
  std::vector<int> prev(lb + 1), cur(lb + 1);
  for (int j = 0; j <= lb; ++j) prev[j] = j;
  for (int i = 1; i <= la; ++i) {
    cur[0] = i;
    int rowmin = cur[0];
    for (int j = 1; j <= lb; ++j) {
      int c = std::min(
          std::min(prev[j] + 1, cur[j - 1] + 1),
          prev[j - 1] + (a[i - 1] != b[j - 1] ? 1 : 0));
      cur[j] = c;
      if (c < rowmin) rowmin = c;
    }
    if (rowmin > maxd) return false;
    std::swap(prev, cur);
  }
  return prev[lb] <= maxd;
}

// Matcher expansion over the ordered vocabulary. kinds: 0=prefix,
// 1=suffix, 2=infix, 3=fuzzy(dist). Emits LIVE word ids in the same order
// the Python tier's radix walks produce (lexicographic; suffix walks
// lexicographic-by-reversed), so the max_exp cap selects the same words.
// Smallest string strictly greater than every string with prefix `p`
// (byte-wise successor); false when p is all-0xFF (no successor).
static bool next_prefix(string& p) {
  while (!p.empty()) {
    const unsigned char c = (unsigned char)p.back();
    if (c != 0xFF) {
      p.back() = (char)(c + 1);
      return true;
    }
    p.pop_back();
  }
  return false;
}

void collect_expansion(TextIndex* ix, int kind, const char* term_c, int dist,
                       int max_exp, std::vector<int32_t>& out) {
  const string term(term_c);
  if (kind == 0) {  // prefix
    for (auto it = ix->sorted_words.lower_bound(term);
         it != ix->sorted_words.end() && (int)out.size() < max_exp; ++it) {
      if (it->first.compare(0, term.size(), term) != 0) break;
      if (ix->postings[it->second]) out.push_back(it->second);
    }
  } else if (kind == 1) {  // suffix
    const string rev(term.rbegin(), term.rend());
    for (auto it = ix->sorted_rev.lower_bound(rev);
         it != ix->sorted_rev.end() && (int)out.size() < max_exp; ++it) {
      if (it->first.compare(0, rev.size(), rev) != 0) break;
      if (ix->postings[it->second]) out.push_back(it->second);
    }
  } else if (kind == 2) {  // infix
    for (const auto& [w, id] : ix->sorted_words) {
      if ((int)out.size() >= max_exp) break;
      if (ix->postings[id] && w.find(term) != string::npos)
        out.push_back(id);
    }
  } else {  // fuzzy: incremental Levenshtein automaton over the ordered
    // vocabulary. DP rows are shared across the common prefix of
    // consecutive words, and a prefix whose whole DP row exceeds `dist`
    // prunes its entire subtree (row minima are non-decreasing along the
    // word, so no extension can recover). The flat per-word DP this
    // replaces re-scored every vocab word per cold query (~4ms at 20k
    // words, dist=2 — the r4 fuzzy2 tail).
    const int m = (int)term.size();
    std::vector<std::vector<int32_t>> rows;
    rows.emplace_back(m + 1);
    for (int j = 0; j <= m; ++j) rows[0][j] = j;
    string prev;
    auto it = ix->sorted_words.begin();
    while (it != ix->sorted_words.end() && (int)out.size() < max_exp) {
      const string& w = it->first;
      size_t common = 0;
      const size_t clim = std::min(prev.size(), w.size());
      while (common < clim && prev[common] == w[common]) ++common;
      rows.resize(common + 1);
      size_t prune_at = string::npos;
      for (size_t i = common; i < w.size(); ++i) {
        {
          const auto& pr = rows[i];
          int32_t mn = pr[0];
          for (int j = 1; j <= m; ++j) mn = std::min(mn, pr[j]);
          if (mn > dist) {
            prune_at = i;
            break;
          }
        }
        rows.emplace_back(m + 1);  // may reallocate: re-take refs below
        auto& nr = rows[i + 1];
        const auto& pr = rows[i];
        nr[0] = (int32_t)i + 1;
        const char c = w[i];
        for (int j = 1; j <= m; ++j) {
          int32_t v = std::min(pr[j] + 1, nr[j - 1] + 1);
          v = std::min(v, pr[j - 1] + (c == term[j - 1] ? 0 : 1));
          nr[j] = v;
        }
      }
      if (prune_at != string::npos) {
        string pref = w.substr(0, prune_at);
        prev = pref;  // rows[0..prune_at] stay valid for this prefix
        if (!next_prefix(pref)) break;
        it = ix->sorted_words.lower_bound(pref);
        continue;
      }
      if (rows[w.size()][m] <= dist && ix->postings[it->second])
        out.push_back(it->second);
      prev = w;
      ++it;
    }
  }
}

// Sorted unique doc-id union over a word-id list.
void union_docs_vec(TextIndex* ix, const std::vector<int32_t>& wids,
                    uint64_t mask, std::vector<int64_t>& ids) {
  ids.clear();
  if (wids.size() > 1) {
    // bitmap union: doc ids are dense interner ids, so one bitset pass +
    // an ordered sweep replaces concat-sort-unique (profiled 10x on wide
    // fuzzy expansions over hot words). Bounded to
    // 16M doc-id space (2 MiB scratch); beyond that the sort path below
    // still works.
    int32_t max_doc = -1;
    bool small = true;
    for (int32_t wid : wids) {
      Posting* post = ix->postings[wid].get();
      if (!post) continue;
      if (!post->base.empty())
        max_doc = std::max(max_doc, Posting::edoc(post->base.back()));
      for (const auto& [doc, v] : post->wide) {
        (void)v;
        max_doc = std::max(max_doc, doc);
      }
      if (max_doc >= (1 << 24)) {
        small = false;
        break;
      }
    }
    if (small && max_doc >= 0) {
      auto& bits = ix->union_bits;
      const size_t nw = (size_t)(max_doc / 64) + 1;
      bits.assign(nw, 0);  // assign keeps capacity: no realloc churn
      for (int32_t wid : wids) {
        Posting* post = ix->postings[wid].get();
        if (!post) continue;
        for (uint64_t e : post->base)
          if (Posting::emask(e) & mask) {
            const uint32_t doc = (uint32_t)Posting::edoc(e);
            bits[doc >> 6] |= 1ull << (doc & 63);
          }
        for (const auto& [doc, v] : post->wide)
          for (const auto& pm : v)
            if (pm.second & mask) {
              bits[(uint32_t)doc >> 6] |= 1ull << ((uint32_t)doc & 63);
              break;
            }
      }
      for (size_t w = 0; w < nw; ++w) {
        uint64_t b = bits[w];
        while (b) {
          const int t = __builtin_ctzll(b);
          ids.push_back((int64_t)(w * 64 + (size_t)t));
          b &= b - 1;
        }
      }
      return;
    }
  }
  for (int32_t wid : wids) {
    Posting* post = ix->postings[wid].get();
    if (!post) continue;
    // base is (doc,pos)-sorted: one pass, emit each matching doc once
    int64_t last = INT64_MIN;
    for (uint64_t e : post->base) {
      const int32_t doc = Posting::edoc(e);
      if (doc != last && (Posting::emask(e) & mask)) {
        ids.push_back(doc);
        last = doc;
      }
    }
    for (const auto& [doc, v] : post->wide)
      for (const auto& pm : v)
        if (pm.second & mask) {
          ids.push_back(doc);
          break;
        }
  }
  std::sort(ids.begin(), ids.end());
  ids.erase(std::unique(ids.begin(), ids.end()), ids.end());
}

// Copy-out with the -(needed) grow protocol (shared by tix_docs_union
// and tix_docs_union_expand).
int64_t union_ids(TextIndex* ix, const std::vector<int32_t>& wids,
                  uint64_t mask, int64_t* out, int64_t cap) {
  std::vector<int64_t> ids;
  union_docs_vec(ix, wids, mask, ids);
  if ((int64_t)ids.size() > cap) return -(int64_t)ids.size();
  std::memcpy(out, ids.data(), ids.size() * sizeof(int64_t));
  return (int64_t)ids.size();
}

// ---- phrase / SLOP / INORDER verification (reference: the proximity
// iterators, src/indexes/text/text_iterator.cc — semantics mirrored from
// the Python tier in text/text_index.py::_phrase_positions_ok*) ----------

// Sorted unique positions of `doc` under one field bit, merged over a
// slot's word variants (stem-expanded spellings of one phrase slot).
void slot_positions(TextIndex* ix, const std::vector<int32_t>& wids,
                    int32_t doc, uint64_t bit, std::vector<int32_t>& out) {
  out.clear();
  for (int32_t wid : wids) {
    Posting* post = ix->postings[wid].get();
    if (!post) continue;
    auto [lo, hi] = post->span(doc);
    for (size_t i = lo; i < hi; ++i)
      if (Posting::emask(post->base[i]) & bit)
        out.push_back(Posting::epos(post->base[i]));
    if (!post->wide.empty()) {
      auto wit = post->wide.find(doc);
      if (wit != post->wide.end())
        for (const auto& [pos, m] : wit->second)
          if (m & bit) out.push_back(pos);
    }
  }
  std::sort(out.begin(), out.end());
  out.erase(std::unique(out.begin(), out.end()), out.end());
}

// Ordered existence: greedy min-next per start (exact for INORDER).
bool phrase_ordered_ok(const std::vector<std::vector<int32_t>>& pls,
                       int slop) {
  const int n = (int)pls.size();
  if (n == 2) {  // the dominant shape: one linear merge, no binary search
    const auto& A = pls[0];
    const auto& B = pls[1];
    size_t j = 0;
    for (int32_t a : A) {
      while (j < B.size() && B[j] <= a) ++j;
      if (j == B.size()) return false;
      if (B[j] - a - 1 <= slop) return true;
    }
    return false;
  }
  for (int32_t p0 : pls[0]) {
    int32_t t = p0;
    bool ok = true;
    for (int i = 1; i < n; ++i) {
      auto it = std::upper_bound(pls[i].begin(), pls[i].end(), t);
      if (it == pls[i].end()) {
        ok = false;
        break;
      }
      t = *it;
    }
    if (ok && (t - p0) - (n - 1) <= slop) return true;
  }
  return false;
}

// Can each slot pick a distinct position from its window list?
// Backtracking on slots sorted by fewest options (windows are tiny).
bool distinct_assignment(std::vector<std::vector<int32_t>>& window) {
  const int n = (int)window.size();
  std::vector<int> order(n);
  for (int i = 0; i < n; ++i) order[i] = i;
  std::sort(order.begin(), order.end(), [&](int a, int b) {
    return window[a].size() < window[b].size();
  });
  std::vector<int32_t> used;
  std::function<bool(int)> rec = [&](int k) -> bool {
    if (k == n) return true;
    for (int32_t p : window[order[k]]) {
      if (std::find(used.begin(), used.end(), p) == used.end()) {
        used.push_back(p);
        if (rec(k + 1)) return true;
        used.pop_back();
      }
    }
    return false;
  };
  return rec(0);
}

// Unordered: a width-(n+slop) window containing one distinct position
// per slot.
bool phrase_unordered_ok(const std::vector<std::vector<int32_t>>& pls,
                         int slop) {
  const int n = (int)pls.size();
  if (n == 2) {  // distinct positions within a width-(2+slop) window
    const auto& A = pls[0];
    const auto& B = pls[1];
    size_t i = 0, j = 0;
    while (i < A.size() && j < B.size()) {
      const int32_t a = A[i], b = B[j];
      if (a == b) {
        // same position twice needs a second distinct one in-window
        if ((i + 1 < A.size() && A[i + 1] - b <= slop + 1) ||
            (j + 1 < B.size() && B[j + 1] - a <= slop + 1))
          return true;
        ++i;
        ++j;
      } else if ((a < b ? b - a : a - b) <= slop + 1) {
        return true;
      } else if (a < b) {
        ++i;
      } else {
        ++j;
      }
    }
    return false;
  }
  std::vector<int32_t> events;
  for (const auto& l : pls)
    events.insert(events.end(), l.begin(), l.end());
  std::sort(events.begin(), events.end());
  events.erase(std::unique(events.begin(), events.end()), events.end());
  const int width = n + slop;
  std::vector<std::vector<int32_t>> window(n);
  for (int32_t start : events) {
    bool all = true;
    for (int i = 0; i < n; ++i) {
      window[i].clear();
      for (int32_t p : pls[i])
        if (p >= start && p < start + width) window[i].push_back(p);
      if (window[i].empty()) {
        all = false;
        break;
      }
    }
    if (all && distinct_assignment(window)) return true;
  }
  return false;
}

// One doc: does the phrase land inside a single field of `mask`?
// (Position spaces are per-field, so the check runs per field bit.)
bool phrase_doc_ok(TextIndex* ix,
                   const std::vector<std::vector<int32_t>>& slots,
                   int32_t doc, uint64_t mask, int slop, bool inorder,
                   std::vector<std::vector<int32_t>>& pls) {
  const int n = (int)slots.size();
  for (int b = 0; b < 64; ++b) {
    const uint64_t bit = 1ull << b;
    if (!(mask & bit)) continue;
    bool all = true;
    for (int s = 0; s < n; ++s) {
      slot_positions(ix, slots[s], doc, bit, pls[s]);
      if (pls[s].empty()) {
        all = false;
        break;
      }
    }
    if (!all) continue;
    if (inorder ? phrase_ordered_ok(pls, slop)
                : phrase_unordered_ok(pls, slop))
      return true;
  }
  return false;
}

// ---- merge-driven phrase intersection (hot path) --------------------------
// The r4 pipeline (per-slot full doc unions -> sort -> set_intersection ->
// per-candidate re-binary-search for positions) walked every position of
// every hot word THREE times; profiled at 93% of phrase latency on a
// zipf corpus (hot x hot phrase: ~150k packed entries re-touched per
// query). Postings are (doc,pos)-sorted packed arrays, so one galloping
// k-way merge intersects the slots AND lands each cursor on the doc's
// position span for free. Wide entries (field bit >= 8 / pos >= 2^24) are
// rare by design; any wide posting routes to the general fallback below.

struct SlotCursor {
  const std::vector<uint64_t>* base;
  size_t i = 0;

  int32_t doc() const {
    return i < base->size() ? Posting::edoc((*base)[i]) : INT32_MAX;
  }

  void seek(int32_t d) {  // gallop to the first entry with doc >= d
    const uint64_t key = Posting::pack(d, 0, 0);
    const size_t n = base->size();
    if (i >= n || (*base)[i] >= key) return;
    size_t lo = i, step = 1;
    while (lo + step < n && (*base)[lo + step] < key) {
      lo += step;
      step <<= 1;
    }
    const size_t hi = std::min(n, lo + step + 1);
    i = (size_t)(std::lower_bound(base->begin() + (long)lo,
                                  base->begin() + (long)hi, key) -
                 base->begin());
  }
};

// Intersect slots by doc and positionally verify, in one merge pass.
// Preconditions: n_slots >= 2, no slot variant has wide entries.
void phrase_docs_merge(TextIndex* ix,
                       const std::vector<std::vector<int32_t>>& slots,
                       uint64_t mask, int slop, bool inorder,
                       std::vector<int64_t>& result) {
  const int n = (int)slots.size();
  std::vector<std::vector<SlotCursor>> curs(n);
  for (int s = 0; s < n; ++s)
    for (int32_t wid : slots[s])
      curs[s].push_back(SlotCursor{&ix->postings[wid]->base, 0});
  // scratch buffers reused across docs
  std::vector<std::vector<std::pair<int32_t, uint64_t>>> raw(n);
  std::vector<std::vector<int32_t>> pls(n);
  int32_t cur = 0;
  for (;;) {
    // leapfrog: align every slot's min doc on `cur`
    bool aligned = true;
    for (int s = 0; s < n; ++s) {
      int32_t d = INT32_MAX;
      for (auto& c : curs[s]) {
        c.seek(cur);
        d = std::min(d, c.doc());
      }
      if (d == INT32_MAX) return;
      if (d > cur) {
        cur = d;
        aligned = false;
        break;
      }
    }
    if (!aligned) continue;
    // gather this doc's (pos, mask) pairs per slot; cursors stay put
    // (the ++cur re-seek advances them past the doc next round)
    uint64_t docmask = mask;
    for (int s = 0; s < n && docmask; ++s) {
      raw[s].clear();
      uint64_t present = 0;
      for (const auto& c : curs[s]) {
        const auto& b = *c.base;
        for (size_t j = c.i; j < b.size() && Posting::edoc(b[j]) == cur;
             ++j) {
          const uint64_t m = Posting::emask(b[j]) & mask;
          if (m) {
            raw[s].emplace_back(Posting::epos(b[j]), m);
            present |= m;
          }
        }
      }
      docmask &= present;
      if (curs[s].size() > 1)  // variants interleave: restore pos order
        std::sort(raw[s].begin(), raw[s].end());
    }
    // verify per field bit common to every slot (positions are per-field)
    for (int b = 0; docmask; ++b, docmask >>= 1) {
      if (!(docmask & 1)) continue;
      const uint64_t bit = 1ull << b;
      bool all = true;
      for (int s = 0; s < n; ++s) {
        pls[s].clear();
        int32_t last = INT32_MIN;
        for (const auto& [pos, m] : raw[s])
          if ((m & bit) && pos != last) {
            pls[s].push_back(pos);
            last = pos;
          }
        if (pls[s].empty()) {
          all = false;
          break;
        }
      }
      if (all && (inorder ? phrase_ordered_ok(pls, slop)
                          : phrase_unordered_ok(pls, slop))) {
        result.push_back(cur);
        break;
      }
    }
    if (cur == INT32_MAX) return;
    ++cur;
  }
}

// Resolve NUL-separated words into per-slot live word-id lists. Returns
// false when any slot has no live word (the phrase cannot match).
bool resolve_slots(TextIndex* ix, const char* words,
                   const int32_t* slot_counts, int n_slots,
                   std::vector<std::vector<int32_t>>& slots) {
  slots.assign(n_slots, {});
  const char* p = words;
  bool any_empty = false;
  for (int s = 0; s < n_slots; ++s) {
    for (int i = 0; i < slot_counts[s]; ++i) {
      string w(p);
      p += w.size() + 1;
      auto it = ix->word_ids.find(w);
      if (it != ix->word_ids.end() && ix->postings[it->second])
        slots[s].push_back(it->second);
    }
    if (slots[s].empty()) any_empty = true;
  }
  return !any_empty;
}
}  // namespace

extern "C" {

void* tix_create(void* lexer) {
  auto* ix = new TextIndex();
  ix->lexer = lexer;
  ix->tokbuf.resize(1 << 16);
  return ix;
}

void tix_free(void* h) { delete (TextIndex*)h; }

// Index one field of one document. Tokenizes with the shared lexer,
// replaces the doc's previous tokens for this field, maintains postings +
// stem links, and writes the event blob (result code + word birth/death
// events) into out. Returns bytes written into out, or -1 when out (or the
// internal token buffer) is too small.
static int tix_index_blob(TextIndex* ix, int32_t doc, int bit_index,
                          int nostem, const char* blob, int n, char* out,
                          int out_cap) {
  EventOut ev(ix->last_events);
  const int64_t key = ((int64_t)doc << 6) | bit_index;
  const bool existed = ix->doc_tokens.count(key) > 0;
  ev.code(existed ? 'M' : 'A');

  // remove previous tokens of this field (including their stem links)
  {
    auto it = ix->doc_tokens.find(key);
    if (it != ix->doc_tokens.end()) {
      const uint64_t bit = 1ull << bit_index;
      std::vector<int32_t> uniq;
      TextIndex::decode_wids(it->second, uniq);
      if (!nostem) {
        for (int32_t wid : uniq) {
          // stems are only linked when stem != word; the link recorded
          // the interned stem id at index time (stem_of)
          auto sit = ix->stem_of.find(wid);
          if (sit != ix->stem_of.end())
            ix->stem_link(sit->second, wid, -1);
        }
      }
      for (int32_t wid : uniq) {
        Posting* p = ix->postings[wid].get();
        if (!p) continue;
        p->remove_field(doc, bit);
        if (p->empty()) {
          ev.put('-', ix->word_names[wid]);
          ix->postings[wid] = nullptr;
        }
      }
      ix->doc_tokens.erase(it);
    }
  }

  // walk token blob: token '\0' stem '\0' (stem empty when same)
  const uint64_t bit = 1ull << bit_index;
  std::unordered_set<int32_t> seen;
  std::unordered_set<int32_t> linked;
  const char* p = blob;
  const char* end = p + n;
  int32_t pos = 0;
  while (p < end) {
    string word(p);
    p += word.size() + 1;
    string stem(p);
    p += stem.size() + 1;
    int32_t wid = ix->intern(word);
    if (!ix->postings[wid]) {
      // word (re)enters the dictionary — Python mirrors it into the
      // radix/suffix trees on this event
      ix->postings[wid] = std::make_unique<Posting>();
      ev.put('+', word);
    }
    ix->postings[wid]->add(doc, pos, bit);
    if (!nostem && !stem.empty() && stem != word &&
        linked.insert(wid).second) {
      // link once per unique word per call (Python stem_map is a set of
      // words per stem)
      int32_t sid = ix->intern(stem);
      ix->stem_of[wid] = sid;
      ix->stem_link(sid, wid, +1);
    }
    seen.insert(wid);
    ++pos;
  }
  std::vector<int32_t> uniq(seen.begin(), seen.end());
  std::sort(uniq.begin(), uniq.end());
  std::vector<uint8_t> enc;
  TextIndex::encode_wids(uniq, enc);
  enc.shrink_to_fit();
  ix->doc_tokens.emplace(key, std::move(enc));
  return ev.finish(out, out_cap);
}

// Tokenize with the shared lexer (ASCII path), then index.
int tix_update_field(void* h, int32_t doc, int bit_index, int nostem,
                     const char* text, int len, char* out, int out_cap) {
  auto* ix = (TextIndex*)h;
  std::lock_guard<std::mutex> g(ix->mu);
  if ((size_t)(len * 2 + 64) > ix->tokbuf.size())
    ix->tokbuf.resize((size_t)len * 2 + 64);
  int n = lexer_tokenize(ix->lexer, text, len, ix->tokbuf.data(),
                         (int)ix->tokbuf.size());
  while (n < 0 && ix->tokbuf.size() < (1u << 26)) {
    // token output (word\0stem\0 pairs) outgrew the heuristic bound —
    // grow here so the caller never has to distinguish this from an
    // event-buffer overflow (whose retry must NOT re-run the mutation)
    ix->tokbuf.resize(ix->tokbuf.size() * 2);
    n = lexer_tokenize(ix->lexer, text, len, ix->tokbuf.data(),
                       (int)ix->tokbuf.size());
  }
  if (n < 0) return INT32_MIN;
  return tix_index_blob(ix, doc, bit_index, nostem, ix->tokbuf.data(), n,
                        out, out_cap);
}

// Index pre-tokenized text (word '\0' stem '\0' pairs) — the non-ASCII
// fallback where Python runs its own tokenizer with identical semantics.
int tix_update_field_tokens(void* h, int32_t doc, int bit_index, int nostem,
                            const char* blob, int blob_len, char* out,
                            int out_cap) {
  auto* ix = (TextIndex*)h;
  std::lock_guard<std::mutex> g(ix->mu);
  return tix_index_blob(ix, doc, bit_index, nostem, blob, blob_len, out,
                        out_cap);
}

int tix_remove_field(void* h, int32_t doc, int bit_index, int nostem,
                     char* out, int out_cap) {
  auto* ix = (TextIndex*)h;
  std::lock_guard<std::mutex> g(ix->mu);
  EventOut ev(ix->last_events);
  const int64_t key = ((int64_t)doc << 6) | bit_index;
  auto it = ix->doc_tokens.find(key);
  if (it == ix->doc_tokens.end()) {
    ev.code('S');
    return ev.finish(out, out_cap);
  }
  ev.code('R');
  const uint64_t bit = 1ull << bit_index;
  std::vector<int32_t> uniq;
  TextIndex::decode_wids(it->second, uniq);
  for (int32_t wid : uniq) {
    // stem links are only ADDED for stemmed fields (tix_index_blob gates
    // on !nostem both when adding and when removing prior tokens); a
    // NOSTEM removal must not eat a refcount another field added, or the
    // stem->word mapping dies while stemmed docs still hold the word
    if (!nostem) {
      auto sit = ix->stem_of.find(wid);
      if (sit != ix->stem_of.end()) ix->stem_link(sit->second, wid, -1);
    }
    Posting* p = ix->postings[wid].get();
    if (!p) continue;
    p->remove_field(doc, bit);
    if (p->empty()) {
      ev.put('-', ix->word_names[wid]);
      ix->postings[wid] = nullptr;
    }
  }
  ix->doc_tokens.erase(it);
  return ev.finish(out, out_cap);
}

// Fetch the event blob of the LAST mutating call (update/remove) — used
// when that call returned -(needed) because the caller's buffer was too
// small. Returns bytes written or -(needed) if still too small.
int tix_last_events(void* h, char* out, int out_cap) {
  auto* ix = (TextIndex*)h;
  std::lock_guard<std::mutex> g(ix->mu);
  const int n = (int)ix->last_events.size();
  if (n > out_cap) return -n;
  std::memcpy(out, ix->last_events.data(), n);
  return n;
}

// Union of doc ids over words (null-separated blob), filtered by mask.
// Writes sorted unique ids into out; returns the count, or -(needed) when
// cap is too small (caller retries with a bigger buffer).
int64_t tix_docs_union(void* h, const char* words, int n_words, uint64_t mask,
                       int64_t* out, int64_t cap) {
  auto* ix = (TextIndex*)h;
  std::lock_guard<std::mutex> g(ix->mu);
  std::vector<int32_t> wids;
  const char* p = words;
  for (int i = 0; i < n_words; ++i) {
    string w(p);
    p += w.size() + 1;
    auto it = ix->word_ids.find(w);
    if (it != ix->word_ids.end()) wids.push_back(it->second);
  }
  return union_ids(ix, wids, mask, out, cap);
}

// Native matcher expansion: the word list one wide matcher touches
// (reference term.h / fuzzy.h radix WordIterator walks). Returns
// '\0'-joined words ( -(needed) if the buffer is too small ).
int tix_expand(void* h, int kind, const char* term, int dist, int max_exp,
               char* out, int cap) {
  auto* ix = (TextIndex*)h;
  std::lock_guard<std::mutex> g(ix->mu);
  std::vector<int32_t> wids;
  collect_expansion(ix, kind, term, dist, max_exp, wids);
  int need = 0;
  for (int32_t id : wids) need += (int)ix->word_names[id].size() + 1;
  if (need > cap) return -need;
  char* p = out;
  for (int32_t id : wids) {
    const string& w = ix->word_names[id];
    std::memcpy(p, w.data(), w.size());
    p += w.size();
    *p++ = '\0';
  }
  return need;
}

// Fused expansion + posting union: ONE call resolves a wide matcher
// (prefix/suffix/infix/fuzzy) to its sorted unique doc-id set — the text
// query hot path never walks Python-side trees or re-crosses the ctypes
// boundary per word.
int64_t tix_docs_union_expand(void* h, int kind, const char* term, int dist,
                              int max_exp, uint64_t mask, int64_t* out,
                              int64_t cap) {
  auto* ix = (TextIndex*)h;
  std::lock_guard<std::mutex> g(ix->mu);
  std::vector<int32_t> wids;
  collect_expansion(ix, kind, term, dist, max_exp, wids);
  return union_ids(ix, wids, mask, out, cap);
}

int tix_contains(void* h, const char* word, int32_t doc, uint64_t mask) {
  auto* ix = (TextIndex*)h;
  std::lock_guard<std::mutex> g(ix->mu);
  int32_t id = ix->lookup(word);
  if (id < 0 || !ix->postings[id]) return 0;
  return (ix->postings[id]->doc_mask(doc) & mask) ? 1 : 0;
}

// Sorted positions of word in doc under mask; returns count or -(needed).
int tix_positions(void* h, const char* word, int32_t doc, uint64_t mask,
                  int32_t* out, int cap) {
  auto* ix = (TextIndex*)h;
  std::lock_guard<std::mutex> g(ix->mu);
  int32_t id = ix->lookup(word);
  if (id < 0 || !ix->postings[id]) return 0;
  Posting* post = ix->postings[id].get();
  std::vector<int32_t> ps;
  auto [lo, hi] = post->span(doc);
  for (size_t i = lo; i < hi; ++i)  // span is already pos-sorted
    if (Posting::emask(post->base[i]) & mask)
      ps.push_back(Posting::epos(post->base[i]));
  if (!post->wide.empty()) {
    auto wit = post->wide.find(doc);
    if (wit != post->wide.end())
      for (const auto& [pos, m] : wit->second)
        if (m & mask) ps.push_back(pos);
  }
  std::sort(ps.begin(), ps.end());
  if ((int)ps.size() > cap) return -(int)ps.size();
  std::memcpy(out, ps.data(), ps.size() * sizeof(int32_t));
  return (int)ps.size();
}

// Phrase query in one call: per-slot variant unions -> candidate-doc
// intersection -> positional SLOP/INORDER verification (reference:
// proximity/phrase iterators over postings; Python-tier mirror:
// text/text_index.py::_phrase_docs, kept as the differential oracle).
// words: sum(slot_counts) NUL-separated words in slot order. Writes the
// sorted matching doc ids; returns the count or -(needed) when out is
// too small.
int64_t tix_phrase_docs(void* h, const char* words,
                        const int32_t* slot_counts, int n_slots,
                        uint64_t mask, int slop, int inorder, int64_t* out,
                        int64_t cap) {
  auto* ix = (TextIndex*)h;
  std::lock_guard<std::mutex> g(ix->mu);
  if (n_slots <= 0) return 0;
  std::vector<std::vector<int32_t>> slots;
  if (!resolve_slots(ix, words, slot_counts, n_slots, slots)) return 0;
  if (n_slots >= 2) {
    bool any_wide = false;
    for (const auto& sl : slots)
      for (int32_t wid : sl)
        any_wide |= !ix->postings[wid]->wide.empty();
    if (!any_wide) {
      std::vector<int64_t> result;
      phrase_docs_merge(ix, slots, mask, slop, inorder != 0, result);
      if ((int64_t)result.size() > cap) return -(int64_t)result.size();
      std::memcpy(out, result.data(), result.size() * sizeof(int64_t));
      return (int64_t)result.size();
    }
  }
  // candidate docs: intersect per-slot unions, smallest first
  std::vector<std::vector<int64_t>> unions(n_slots);
  for (int s = 0; s < n_slots; ++s) {
    union_docs_vec(ix, slots[s], mask, unions[s]);
    if (unions[s].empty()) return 0;
  }
  std::sort(unions.begin(), unions.end(),
            [](const auto& a, const auto& b) { return a.size() < b.size(); });
  std::vector<int64_t> cand = std::move(unions[0]);
  std::vector<int64_t> tmp;
  for (int s = 1; s < n_slots && !cand.empty(); ++s) {
    tmp.clear();
    std::set_intersection(cand.begin(), cand.end(), unions[s].begin(),
                          unions[s].end(), std::back_inserter(tmp));
    cand.swap(tmp);
  }
  std::vector<int64_t> result;
  if (n_slots == 1) {
    result = std::move(cand);  // single slot: a plain term union
  } else {
    std::vector<std::vector<int32_t>> pls(n_slots);
    for (int64_t doc : cand)
      if (phrase_doc_ok(ix, slots, (int32_t)doc, mask, slop,
                        inorder != 0, pls))
        result.push_back(doc);
  }
  if ((int64_t)result.size() > cap) return -(int64_t)result.size();
  std::memcpy(out, result.data(), result.size() * sizeof(int64_t));
  return (int64_t)result.size();
}

// Per-row phrase re-verification (content resolution calls this once per
// result row): does ONE doc contain the phrase?
int tix_phrase_check(void* h, const char* words, const int32_t* slot_counts,
                     int n_slots, int32_t doc, uint64_t mask, int slop,
                     int inorder) {
  auto* ix = (TextIndex*)h;
  std::lock_guard<std::mutex> g(ix->mu);
  if (n_slots <= 0) return 0;
  std::vector<std::vector<int32_t>> slots;
  if (!resolve_slots(ix, words, slot_counts, n_slots, slots)) return 0;
  if (n_slots == 1) {
    std::vector<int32_t> pls0;
    slot_positions(ix, slots[0], doc, mask, pls0);
    return pls0.empty() ? 0 : 1;
  }
  std::vector<std::vector<int32_t>> pls(n_slots);
  return phrase_doc_ok(ix, slots, doc, mask, slop, inorder != 0, pls) ? 1
                                                                      : 0;
}

int32_t tix_key_count(void* h, const char* word) {
  auto* ix = (TextIndex*)h;
  std::lock_guard<std::mutex> g(ix->mu);
  int32_t id = ix->lookup(word);
  return (id >= 0 && ix->postings[id]) ? ix->postings[id]->doc_count : 0;
}

int64_t tix_position_count(void* h, const char* word) {
  auto* ix = (TextIndex*)h;
  std::lock_guard<std::mutex> g(ix->mu);
  int32_t id = ix->lookup(word);
  return (id >= 0 && ix->postings[id]) ? ix->postings[id]->position_count : 0;
}

// Parent words of a stem (the stem tree), null-separated into out.
int tix_stem_parents(void* h, const char* stem, char* out, int cap) {
  auto* ix = (TextIndex*)h;
  std::lock_guard<std::mutex> g(ix->mu);
  auto sit = ix->word_ids.find(stem);
  if (sit == ix->word_ids.end()) return 0;
  auto bag = ix->stems.find(sit->second);
  if (bag == ix->stems.end()) return 0;
  // pre-size: -(needed) when the caller's buffer is too small (read-only
  // query, so a grown retry is safe — unlike the mutating calls above)
  int need = 0;
  for (const auto& [wid, cnt] : bag->second) {
    (void)cnt;
    need += (int)ix->word_names[wid].size() + 1;
  }
  if (need > cap) return -need;
  int w = 0;
  for (const auto& [wid, cnt] : bag->second) {
    (void)cnt;
    const string& word = ix->word_names[wid];
    std::memcpy(out + w, word.data(), word.size());
    w += (int)word.size();
    out[w++] = '\0';
  }
  return w;
}

int32_t tix_doc_count(void* h) {
  auto* ix = (TextIndex*)h;
  std::lock_guard<std::mutex> g(ix->mu);
  std::unordered_set<int64_t> docs;
  for (const auto& [k, v] : ix->doc_tokens) {
    (void)v;
    docs.insert(k >> 6);
  }
  return (int32_t)docs.size();
}

int32_t tix_stem_count(void* h) {
  auto* ix = (TextIndex*)h;
  std::lock_guard<std::mutex> g(ix->mu);
  return (int32_t)ix->stems.size();
}

int64_t tix_total_positions(void* h) {
  auto* ix = (TextIndex*)h;
  std::lock_guard<std::mutex> g(ix->mu);
  int64_t total = 0;
  for (const auto& p : ix->postings)
    if (p) total += p->position_count;
  return total;
}

// Rough resident bytes for the memory-accounting INFO pool (reference
// text_index.h:50-55 MemoryPools / malloc interposition).
int64_t tix_bytes(void* h) {
  auto* ix = (TextIndex*)h;
  std::lock_guard<std::mutex> g(ix->mu);
  int64_t b = 0;
  for (const auto& up : ix->postings) {
    if (!up) continue;
    b += 40;                                  // Posting object + vector hdr
    b += (int64_t)up->base.capacity() * 8;    // packed entries
    for (const auto& [d, v] : up->wide) {
      (void)d;
      b += 72 + (int64_t)v.capacity() * 16;   // rare wide nodes
    }
  }
  for (const auto& [k, v] : ix->doc_tokens) {
    (void)k;
    b += 64 + (int64_t)v.capacity();  // map node + varint blob
  }
  for (const auto& [k, w] : ix->word_ids) b += 48 + (int64_t)k.size();
  // ordered vocabulary views (two rb-tree nodes per all-time word)
  b += (int64_t)(ix->sorted_words.size() + ix->sorted_rev.size()) * 56;
  for (const auto& [k, w] : ix->sorted_rev) {
    (void)w;
    b += (int64_t)k.size();
  }
  return b;
}

}  // extern "C"
