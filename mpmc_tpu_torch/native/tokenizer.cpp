// Batch WordPiece tokenizer — C++ host runtime component.
//
// The reference delegates tokenization to HF's Rust `tokenizers` behind
// AutoTokenizer/encode_plus (e.g. Multimodal_example_task2C.py:273-289),
// re-tokenizing every sample every epoch inside Dataset.__getitem__.  This is
// the native batch equivalent for the host pipeline: one call tokenizes a
// whole split into the fixed-shape int32 [N, L] id/mask arrays the model
// consumes.  Semantics mirror mpmc_tpu_torch.text.wordpiece (the Python
// correctness oracle, itself pinned against transformers.BertTokenizer):
// BERT basic tokenization (control strip, whitespace/punct/CJK split,
// optional ASCII lowercase) + greedy longest-match WordPiece with "##"
// continuations, [CLS]/[SEP] framing, truncation and padding.
//
// Threading: encode_batch releases no Python state (pure C++), so the ctypes
// caller runs it off the GIL; internally it shards the batch over a small
// thread pool.
//
// Build: mpmc_tpu_torch/native_lib.py compiles it with g++ at first use
// into mpmc_tpu_torch/_build/ (loaded via ctypes from
// mpmc_tpu_torch/text/native.py).  A copy of native/tokenizer.cpp.

#include <cstdint>
#include <cstring>
#include <fstream>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Vocab {
  std::unordered_map<std::string, int32_t> table;
  int32_t cls_id = -1, sep_id = -1, pad_id = -1, unk_id = -1;
  bool lower = false;
};

// ---------- UTF-8 ----------
// Decode next codepoint; advances i. Invalid bytes yield U+FFFD.
uint32_t utf8_next(const std::string& s, size_t& i) {
  unsigned char c = s[i];
  if (c < 0x80) { i += 1; return c; }
  if ((c >> 5) == 0x6 && i + 1 < s.size()) {
    uint32_t cp = ((c & 0x1F) << 6) | (s[i + 1] & 0x3F);
    i += 2; return cp;
  }
  if ((c >> 4) == 0xE && i + 2 < s.size()) {
    uint32_t cp = ((c & 0x0F) << 12) | ((s[i + 1] & 0x3F) << 6) |
                  (s[i + 2] & 0x3F);
    i += 3; return cp;
  }
  if ((c >> 3) == 0x1E && i + 3 < s.size()) {
    uint32_t cp = ((c & 0x07) << 18) | ((s[i + 1] & 0x3F) << 12) |
                  ((s[i + 2] & 0x3F) << 6) | (s[i + 3] & 0x3F);
    i += 4; return cp;
  }
  i += 1;
  return 0xFFFD;
}

void utf8_append(std::string& out, uint32_t cp) {
  if (cp < 0x80) {
    out.push_back(static_cast<char>(cp));
  } else if (cp < 0x800) {
    out.push_back(static_cast<char>(0xC0 | (cp >> 6)));
    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else if (cp < 0x10000) {
    out.push_back(static_cast<char>(0xE0 | (cp >> 12)));
    out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else {
    out.push_back(static_cast<char>(0xF0 | (cp >> 18)));
    out.push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
    out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  }
}

// ---------- character classes (BERT BasicTokenizer semantics) ----------
bool is_whitespace(uint32_t cp) {
  if (cp == ' ' || cp == '\t' || cp == '\n' || cp == '\r') return true;
  // Unicode Zs
  switch (cp) {
    case 0x00A0: case 0x1680: case 0x2000: case 0x2001: case 0x2002:
    case 0x2003: case 0x2004: case 0x2005: case 0x2006: case 0x2007:
    case 0x2008: case 0x2009: case 0x200A: case 0x202F: case 0x205F:
    case 0x3000:
      return true;
  }
  return false;
}

bool is_control(uint32_t cp) {
  if (cp == '\t' || cp == '\n' || cp == '\r') return false;
  if (cp < 0x20 || cp == 0x7F) return true;            // C0 + DEL
  if (cp >= 0x80 && cp <= 0x9F) return true;           // C1
  // Format chars commonly hit in tweets (Cf): ZWJ/ZWNJ/LRM/RLM, BOM,
  // Arabic letter mark, directional marks.
  switch (cp) {
    case 0x00AD: case 0x061C: case 0x200B: case 0x200C: case 0x200D:
    case 0x200E: case 0x200F: case 0x202A: case 0x202B: case 0x202C:
    case 0x202D: case 0x202E: case 0x2060: case 0xFEFF:
      return true;
  }
  return false;
}

bool is_punctuation(uint32_t cp) {
  // ASCII symbol blocks (BERT convention)
  if ((cp >= 33 && cp <= 47) || (cp >= 58 && cp <= 64) ||
      (cp >= 91 && cp <= 96) || (cp >= 123 && cp <= 126))
    return true;
  // General punctuation + supplemental + CJK symbols
  if ((cp >= 0x2010 && cp <= 0x2027) || (cp >= 0x2030 && cp <= 0x205E) ||
      (cp >= 0x3001 && cp <= 0x3011) || (cp >= 0xFE50 && cp <= 0xFE6B) ||
      (cp >= 0xFF01 && cp <= 0xFF0F) || (cp >= 0xFF1A && cp <= 0xFF20) ||
      (cp >= 0xFF3B && cp <= 0xFF40) || (cp >= 0xFF5B && cp <= 0xFF65))
    return true;
  // Arabic punctuation
  switch (cp) {
    case 0x060C: case 0x060D: case 0x061B: case 0x061E: case 0x061F:
    case 0x066A: case 0x066B: case 0x066C: case 0x066D: case 0x06D4:
    case 0x00AB: case 0x00BB: case 0x00A1: case 0x00A7: case 0x00B6:
    case 0x00B7: case 0x00BF:
      return true;
  }
  return false;
}

bool is_cjk(uint32_t cp) {
  return (cp >= 0x4E00 && cp <= 0x9FFF) || (cp >= 0x3400 && cp <= 0x4DBF) ||
         (cp >= 0x20000 && cp <= 0x2A6DF) || (cp >= 0x2A700 && cp <= 0x2B73F) ||
         (cp >= 0x2B740 && cp <= 0x2B81F) || (cp >= 0x2B820 && cp <= 0x2CEAF) ||
         (cp >= 0xF900 && cp <= 0xFAFF) || (cp >= 0x2F800 && cp <= 0x2FA1F);
}

// ---------- tokenization ----------
void basic_tokenize(const Vocab& v, const std::string& text,
                    std::vector<std::string>& words) {
  std::string current;
  size_t i = 0;
  auto flush = [&]() {
    if (!current.empty()) {
      words.push_back(current);
      current.clear();
    }
  };
  while (i < text.size()) {
    uint32_t cp = utf8_next(text, i);
    if (cp == 0 || cp == 0xFFFD || is_control(cp)) continue;
    if (is_whitespace(cp)) { flush(); continue; }
    if (is_punctuation(cp) || is_cjk(cp)) {
      flush();
      std::string one;
      utf8_append(one, cp);
      words.push_back(one);
      continue;
    }
    if (v.lower && cp < 0x80 && cp >= 'A' && cp <= 'Z') cp += 32;
    utf8_append(current, cp);
  }
  flush();
}

void wordpiece(const Vocab& v, const std::string& word,
               std::vector<int32_t>& out) {
  // codepoint boundaries
  std::vector<size_t> bounds;
  size_t i = 0;
  while (i < word.size()) {
    bounds.push_back(i);
    utf8_next(word, i);
  }
  bounds.push_back(word.size());
  size_t n = bounds.size() - 1;
  if (n > 100) { out.push_back(v.unk_id); return; }

  std::vector<int32_t> ids;
  size_t start = 0;
  while (start < n) {
    size_t end = n;
    int32_t cur = -1;
    while (start < end) {
      std::string sub = word.substr(bounds[start],
                                    bounds[end] - bounds[start]);
      if (start > 0) sub = "##" + sub;
      auto it = v.table.find(sub);
      if (it != v.table.end()) { cur = it->second; break; }
      --end;
    }
    if (cur < 0) { out.push_back(v.unk_id); return; }
    ids.push_back(cur);
    start = end;
  }
  out.insert(out.end(), ids.begin(), ids.end());
}

void encode_one(const Vocab& v, const char* text, int32_t max_len,
                int32_t* ids, int32_t* mask) {
  std::vector<std::string> words;
  basic_tokenize(v, std::string(text), words);
  std::vector<int32_t> body;
  for (const auto& w : words) {
    wordpiece(v, w, body);
    if (static_cast<int32_t>(body.size()) >= max_len - 2) break;
  }
  int32_t keep = std::min<int32_t>(body.size(), max_len - 2);
  int32_t pos = 0;
  ids[pos] = v.cls_id; mask[pos] = 1; ++pos;
  for (int32_t j = 0; j < keep; ++j) { ids[pos] = body[j]; mask[pos] = 1; ++pos; }
  ids[pos] = v.sep_id; mask[pos] = 1; ++pos;
  for (; pos < max_len; ++pos) { ids[pos] = v.pad_id; mask[pos] = 0; }
}

}  // namespace

extern "C" {

void* wp_create(const char* vocab_path, int do_lower) {
  auto* v = new Vocab();
  v->lower = do_lower != 0;
  std::ifstream f(vocab_path);
  if (!f) { delete v; return nullptr; }
  std::string line;
  int32_t idx = 0;
  while (std::getline(f, line)) {
    if (!line.empty() && line.back() == '\r') line.pop_back();
    if (line.empty()) { ++idx; continue; }
    v->table.emplace(line, idx);
    if (line == "[CLS]") v->cls_id = idx;
    else if (line == "[SEP]") v->sep_id = idx;
    else if (line == "[PAD]") v->pad_id = idx;
    else if (line == "[UNK]") v->unk_id = idx;
    ++idx;
  }
  if (v->cls_id < 0 || v->sep_id < 0 || v->pad_id < 0 || v->unk_id < 0) {
    delete v;
    return nullptr;
  }
  return v;
}

void wp_destroy(void* handle) { delete static_cast<Vocab*>(handle); }

// texts: array of n UTF-8 strings; out_ids/out_mask: int32 [n * max_len].
void wp_encode_batch(void* handle, const char** texts, int32_t n,
                     int32_t max_len, int32_t* out_ids, int32_t* out_mask,
                     int32_t num_threads) {
  const Vocab& v = *static_cast<Vocab*>(handle);
  if (num_threads <= 1 || n < 4) {
    for (int32_t i = 0; i < n; ++i)
      encode_one(v, texts[i], max_len, out_ids + i * max_len,
                 out_mask + i * max_len);
    return;
  }
  std::vector<std::thread> pool;
  int32_t chunk = (n + num_threads - 1) / num_threads;
  for (int32_t t = 0; t < num_threads; ++t) {
    int32_t lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back([&, lo, hi]() {
      for (int32_t i = lo; i < hi; ++i)
        encode_one(v, texts[i], max_len, out_ids + i * max_len,
                   out_mask + i * max_len);
    });
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
