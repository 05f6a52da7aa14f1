// The tokenizer's byte-pair merge loop.
//
// The port's own copy of the JAX package's native merge (the reference's
// byte_pair_encoder, include/metalchat/text/bpe.h:114-176). The Python layer
// owns the vocabulary; it hands the (token bytes -> rank) pairs over once,
// into a hash map behind an opaque handle, then calls mc_bpe_encode for each
// pre-split piece. Greedy lowest-rank-first merging, the same as
// text/bpe.py's `_merge` in tiktoken mode: a merge is legal when the
// concatenation is in the vocabulary, and its rank is its id.
//
// C interface only, loaded with ctypes.

#include <cstdint>
#include <string>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

struct Ranks {
  std::unordered_map<std::string, int64_t> vocab;
};

}  // namespace

extern "C" {

// A rank table from flattened token bytes: `blob` holds the tokens one after
// the other, `offsets` their n + 1 boundaries, `ids` their n ids (= ranks).
// The first of two equal tokens keeps its id, as a Python dict would.
Ranks* mc_bpe_create(const uint8_t* blob, const uint64_t* offsets,
                     const int64_t* ids, uint64_t n) {
  auto* r = new Ranks();
  r->vocab.reserve(n * 2);
  for (uint64_t i = 0; i < n; ++i) {
    r->vocab.emplace(
        std::string(reinterpret_cast<const char*>(blob + offsets[i]),
                    offsets[i + 1] - offsets[i]),
        ids[i]);
  }
  return r;
}

void mc_bpe_destroy(Ranks* r) { delete r; }

// Encode one piece into ids. Returns the number written to `out` (the caller
// gives room for `len` ids: merging never grows the count), or -1 when a
// symbol left after merging is not in the vocabulary (the caller then takes
// the Python path, whose byte-fallback handling decides).
int64_t mc_bpe_encode(const Ranks* r, const uint8_t* piece, uint64_t len,
                      int64_t* out) {
  if (len == 0) return 0;
  const auto& vocab = r->vocab;
  const char* text = reinterpret_cast<const char*>(piece);

  auto whole = vocab.find(std::string(text, len));
  if (whole != vocab.end()) {
    out[0] = whole->second;
    return 1;
  }

  // parts[i] = [start, end) over `piece`.
  std::vector<std::pair<uint32_t, uint32_t>> parts;
  parts.reserve(len);
  for (uint32_t i = 0; i < len; ++i) parts.emplace_back(i, i + 1);

  auto rank_of = [&](uint32_t a, uint32_t b) -> int64_t {
    auto it = vocab.find(std::string(text + a, b - a));
    return it == vocab.end() ? -1 : it->second;
  };

  while (parts.size() > 1) {
    int64_t best_rank = -1;
    size_t best_i = 0;
    for (size_t i = 0; i + 1 < parts.size(); ++i) {
      int64_t rk = rank_of(parts[i].first, parts[i + 1].second);
      if (rk >= 0 && (best_rank < 0 || rk < best_rank)) {
        best_rank = rk;
        best_i = i;
      }
    }
    if (best_rank < 0) break;
    parts[best_i].second = parts[best_i + 1].second;
    parts.erase(parts.begin() + best_i + 1);
  }

  for (size_t i = 0; i < parts.size(); ++i) {
    int64_t rk = rank_of(parts[i].first, parts[i].second);
    if (rk < 0) return -1;
    out[i] = rk;
  }
  return static_cast<int64_t>(parts.size());
}

}  // extern "C"
