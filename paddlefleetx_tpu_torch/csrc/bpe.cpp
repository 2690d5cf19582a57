// Byte-level BPE merge engine — C-ABI module consumed via ctypes.
//
// TPU-native analogue of the reference's native data tooling
// (fast_index_map_helpers.cpp): the per-word greedy merge loop is the hot
// path when tokenizing pretraining corpora (tools/preprocess_data.py); the
// GPT-2 regex word split and caching stay in Python.  Byte-level BPE is
// isomorphic under the byte->unicode display map, so this module works on
// RAW UTF-8 BYTES and never touches unicode: a vocab token and a merge
// side are byte strings.
//
// Wire format (all length-prefixed, little-endian int32):
//   vocab blob:  n, then n x { len, bytes }            (index == token id)
//   merge blob:  m, then m x { lenA, bytesA, lenB, bytesB }  (index == rank)
//
// Entry points:
//   bpe_new(vocab, vocab_len, merges, merges_len) -> handle (0 on error)
//   bpe_encode_word(handle, word, len, out_ids, max_out) -> n ids (-1 err)
//   bpe_free(handle)

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct PairHash {
  size_t operator()(const std::pair<std::string, std::string>& p) const {
    std::hash<std::string> h;
    size_t a = h(p.first), b = h(p.second);
    return a ^ (b + 0x9e3779b97f4a7c15ULL + (a << 6) + (a >> 2));
  }
};

struct Bpe {
  std::unordered_map<std::string, int32_t> vocab;
  std::unordered_map<std::pair<std::string, std::string>, int32_t, PairHash> ranks;
};

const uint8_t* read_i32(const uint8_t* p, const uint8_t* end, int32_t* out) {
  if (p + 4 > end) return nullptr;
  std::memcpy(out, p, 4);
  return p + 4;
}

const uint8_t* read_str(const uint8_t* p, const uint8_t* end, std::string* out) {
  int32_t n;
  p = read_i32(p, end, &n);
  if (!p || n < 0 || p + n > end) return nullptr;
  out->assign(reinterpret_cast<const char*>(p), n);
  return p + n;
}

}  // namespace

extern "C" {

void* bpe_new(const uint8_t* vocab_blob, int64_t vocab_len,
              const uint8_t* merge_blob, int64_t merge_len) {
  auto* bpe = new (std::nothrow) Bpe();
  if (!bpe) return nullptr;
  {
    const uint8_t* p = vocab_blob;
    const uint8_t* end = vocab_blob + vocab_len;
    int32_t n;
    p = read_i32(p, end, &n);
    if (!p || n < 0) { delete bpe; return nullptr; }
    bpe->vocab.reserve(n * 2);
    std::string tok;
    for (int32_t i = 0; i < n; ++i) {
      p = read_str(p, end, &tok);
      if (!p) { delete bpe; return nullptr; }
      bpe->vocab.emplace(tok, i);
    }
  }
  {
    const uint8_t* p = merge_blob;
    const uint8_t* end = merge_blob + merge_len;
    int32_t m;
    p = read_i32(p, end, &m);
    if (!p || m < 0) { delete bpe; return nullptr; }
    bpe->ranks.reserve(m * 2);
    std::string a, b;
    for (int32_t i = 0; i < m; ++i) {
      p = read_str(p, end, &a);
      if (p) p = read_str(p, end, &b);
      if (!p) { delete bpe; return nullptr; }
      bpe->ranks.emplace(std::make_pair(a, b), i);
    }
  }
  return bpe;
}

void bpe_free(void* handle) { delete static_cast<Bpe*>(handle); }

// Greedy lowest-rank pair merging (the standard GPT-2 loop), then vocab
// lookup per final symbol.  Returns the id count, or -1 on unknown symbol /
// overflow / bad handle.
int32_t bpe_encode_word(void* handle, const uint8_t* word, int32_t len,
                        int32_t* out_ids, int32_t max_out) {
  if (!handle || len < 0) return -1;
  const Bpe& bpe = *static_cast<Bpe*>(handle);

  std::vector<std::string> syms;
  syms.reserve(len);
  for (int32_t i = 0; i < len; ++i)
    syms.emplace_back(reinterpret_cast<const char*>(word) + i, 1);

  while (syms.size() > 1) {
    int32_t best_rank = INT32_MAX;
    size_t best_i = 0;
    for (size_t i = 0; i + 1 < syms.size(); ++i) {
      auto it = bpe.ranks.find({syms[i], syms[i + 1]});
      if (it != bpe.ranks.end() && it->second < best_rank) {
        best_rank = it->second;
        best_i = i;
      }
    }
    if (best_rank == INT32_MAX) break;
    // merge every non-overlapping occurrence of the best pair (left-to-
    // right), matching the Python reference loop
    const std::string a = syms[best_i], b = syms[best_i + 1];
    std::vector<std::string> merged;
    merged.reserve(syms.size());
    for (size_t i = 0; i < syms.size();) {
      if (i + 1 < syms.size() && syms[i] == a && syms[i + 1] == b) {
        merged.emplace_back(a + b);
        i += 2;
      } else {
        merged.emplace_back(syms[i]);
        i += 1;
      }
    }
    syms.swap(merged);
  }

  if (static_cast<int32_t>(syms.size()) > max_out) return -1;
  for (size_t i = 0; i < syms.size(); ++i) {
    auto it = bpe.vocab.find(syms[i]);
    if (it == bpe.vocab.end()) return -1;
    out_ids[i] = it->second;
  }
  return static_cast<int32_t>(syms.size());
}

}  // extern "C"
