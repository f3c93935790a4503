// Greedy longest-substring BPE encoder (the reference runtime's semantics,
// common.cpp:282-339) as a native component with a C ABI for ctypes.
//
// The vocab arrives pre-parsed from Python as a packed blob:
//   repeated records: u32 id | u32 len | bytes[len]
// Word splitting is done in Python (std::regex and Python re can disagree
// on lookahead corner cases; one splitter keeps the planes identical) —
// this module encodes one word per call batch, already split.

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Tok {
  std::unordered_map<std::string, int32_t> vocab;
  size_t max_len = 0;
};

}  // namespace

extern "C" {

void* tok_create(const uint8_t* blob, uint64_t blob_len) {
  Tok* t = new Tok();
  uint64_t pos = 0;
  while (pos + 8 <= blob_len) {
    uint32_t id, len;
    std::memcpy(&id, blob + pos, 4);
    std::memcpy(&len, blob + pos + 4, 4);
    pos += 8;
    if (pos + len > blob_len) break;
    std::string key(reinterpret_cast<const char*>(blob + pos), len);
    pos += len;
    t->vocab[key] = static_cast<int32_t>(id);
    if (key.size() > t->max_len) t->max_len = key.size();
  }
  return t;
}

void tok_free(void* handle) { delete static_cast<Tok*>(handle); }

// Encode one pre-split word with greedy longest-substring matching;
// unknown single characters are dropped (common.cpp:318-336).
// Takes an explicit byte length (a NUL-terminated API silently truncated
// words containing embedded NULs, diverging from the pure-Python plane).
// Returns the number of ids written.
int32_t tok_encode_word(void* handle, const char* word_c, int32_t word_len,
                        int32_t* out, int32_t max_out) {
  Tok* t = static_cast<Tok*>(handle);
  const std::string word(word_c, static_cast<size_t>(word_len));
  std::string key;  // probe buffer reused across positions/lengths —
                    // word.substr per probe paid an allocation each
  int32_t n = 0;
  size_t i = 0;
  while (i < word.size() && n < max_out) {
    size_t longest = std::min(word.size() - i, t->max_len);
    bool matched = false;
    key.assign(word, i, longest);
    for (size_t l = longest; l >= 1; --l) {
      key.resize(l);
      auto it = t->vocab.find(key);
      if (it != t->vocab.end()) {
        out[n++] = it->second;
        i += l;
        matched = true;
        break;
      }
    }
    if (!matched) ++i;  // skip unknown character
  }
  return n;
}

}  // extern "C"
