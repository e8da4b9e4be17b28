// WordPiece tokenizer core, C++ host library of the PyTorch port.
//
// The port's own copy of the JAX package's native/wordpiece.cc (same code,
// same C interface). The hot path runs here, multithreaded over rows:
// per-character basic tokenization (cleanup, lowercasing, accent folding,
// punctuation/CJK splitting) followed by greedy longest-match WordPiece.
// Batch assembly (specials, truncation, padding to [N, L]) stays in numpy
// on the Python side (data/wordpiece.py), shared with the Python twin.
//
// API surface (C, for ctypes): build a tokenizer from a newline-separated
// vocab, then tokenize batches of UTF-8 texts into per-row token streams:
// ids + word index + code-point offsets. Semantics match HF BertTokenizer
// (do_basic_tokenize=True). Built by ops/_build.py (build_host) with g++
// into build/host/ and bound in data/native.py; tests/test_torch_native.py
// holds it against the Python twin and the JAX package's library.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// UTF-8 + Unicode tables
// ---------------------------------------------------------------------------

// Decode one UTF-8 code point at s[i]; advances i. Invalid bytes decode as
// U+FFFD and advance by one (matches Python's surrogateescape-free reading
// of already-valid str data; invalid input only arises from foreign bytes).
inline uint32_t decode_utf8(const unsigned char* s, size_t len, size_t& i) {
  unsigned char c = s[i];
  if (c < 0x80) { i += 1; return c; }
  if ((c >> 5) == 0x6 && i + 1 < len) {
    uint32_t cp = ((c & 0x1F) << 6) | (s[i + 1] & 0x3F);
    i += 2; return cp;
  }
  if ((c >> 4) == 0xE && i + 2 < len) {
    uint32_t cp = ((c & 0x0F) << 12) | ((s[i + 1] & 0x3F) << 6) | (s[i + 2] & 0x3F);
    i += 3; return cp;
  }
  if ((c >> 3) == 0x1E && i + 3 < len) {
    uint32_t cp = ((c & 0x07) << 18) | ((s[i + 1] & 0x3F) << 12) |
                  ((s[i + 2] & 0x3F) << 6) | (s[i + 3] & 0x3F);
    i += 4; return cp;
  }
  i += 1; return 0xFFFD;
}

inline void encode_utf8(uint32_t cp, std::string& out) {
  if (cp < 0x80) { out.push_back((char)cp); }
  else if (cp < 0x800) {
    out.push_back((char)(0xC0 | (cp >> 6)));
    out.push_back((char)(0x80 | (cp & 0x3F)));
  } else if (cp < 0x10000) {
    out.push_back((char)(0xE0 | (cp >> 12)));
    out.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back((char)(0x80 | (cp & 0x3F)));
  } else {
    out.push_back((char)(0xF0 | (cp >> 18)));
    out.push_back((char)(0x80 | ((cp >> 12) & 0x3F)));
    out.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back((char)(0x80 | (cp & 0x3F)));
  }
}

inline bool is_whitespace(uint32_t cp) {
  // HF _is_whitespace: \t \n \r space + Zs category.
  if (cp == ' ' || cp == '\t' || cp == '\n' || cp == '\r') return true;
  switch (cp) {
    case 0x00A0: case 0x1680: case 0x202F: case 0x205F: case 0x3000: return true;
    default: return cp >= 0x2000 && cp <= 0x200A;
  }
}

inline bool is_control(uint32_t cp) {
  // HF _is_control: C* categories except \t \n \r (those are whitespace).
  if (cp == '\t' || cp == '\n' || cp == '\r') return false;
  if (cp < 0x20) return true;
  if (cp >= 0x7F && cp <= 0x9F) return true;
  // Cf (format) chars — full category (Unicode 15), so the Python twin
  // (unicodedata-based) and this core agree on every input.
  if (cp == 0x00AD || cp == 0x061C || cp == 0x06DD || cp == 0x070F ||
      cp == 0x08E2 || cp == 0x180E || cp == 0xFEFF || cp == 0x110BD ||
      cp == 0x110CD)
    return true;
  if (cp >= 0x0600 && cp <= 0x0605) return true;
  if (cp >= 0x0890 && cp <= 0x0891) return true;
  if (cp >= 0x200B && cp <= 0x200F) return true;
  if (cp >= 0x202A && cp <= 0x202E) return true;
  if (cp >= 0x2060 && cp <= 0x2064) return true;
  if (cp >= 0x2066 && cp <= 0x206F) return true;
  if (cp >= 0xFFF9 && cp <= 0xFFFB) return true;
  if (cp >= 0x13430 && cp <= 0x1343F) return true;
  if (cp >= 0x1BCA0 && cp <= 0x1BCA3) return true;
  if (cp >= 0x1D173 && cp <= 0x1D17A) return true;
  if (cp == 0xE0001 || (cp >= 0xE0020 && cp <= 0xE007F)) return true;
  return false;
}

inline bool is_punctuation(uint32_t cp) {
  // HF _is_punctuation: the four ASCII ranges (which include $ + < = > ^ ` | ~,
  // i.e. some S-category chars) plus Unicode P*. P* is approximated by the
  // blocks that occur in practice; the ASCII ranges are exact.
  if ((cp >= 33 && cp <= 47) || (cp >= 58 && cp <= 64) ||
      (cp >= 91 && cp <= 96) || (cp >= 123 && cp <= 126))
    return true;
  if (cp >= 0x2010 && cp <= 0x2027) return true;   // hyphens, quotes, daggers
  if (cp >= 0x2030 && cp <= 0x205E) return true;   // per-mille ... punctuation
  if (cp >= 0x3001 && cp <= 0x3003) return true;   // CJK comma/stop
  if (cp >= 0x3008 && cp <= 0x3011) return true;   // CJK brackets
  if (cp == 0x3014 || cp == 0x3015 || cp == 0x301C) return true;
  if (cp >= 0xFF01 && cp <= 0xFF0F) return true;   // fullwidth ! ... /
  if (cp >= 0xFF1A && cp <= 0xFF20) return true;   // fullwidth : ... @
  if (cp >= 0xFF3B && cp <= 0xFF40) return true;
  if (cp >= 0xFF5B && cp <= 0xFF65) return true;
  if (cp == 0x00A1 || cp == 0x00A7 || cp == 0x00AB || cp == 0x00B6 ||
      cp == 0x00B7 || cp == 0x00BB || cp == 0x00BF)
    return true;
  return false;
}

inline bool is_cjk(uint32_t cp) {
  // HF _is_chinese_char ranges (BasicTokenizer._tokenize_chinese_chars).
  return (cp >= 0x4E00 && cp <= 0x9FFF) || (cp >= 0x3400 && cp <= 0x4DBF) ||
         (cp >= 0x20000 && cp <= 0x2A6DF) || (cp >= 0x2A700 && cp <= 0x2B73F) ||
         (cp >= 0x2B740 && cp <= 0x2B81F) || (cp >= 0x2B820 && cp <= 0x2CEAF) ||
         (cp >= 0xF900 && cp <= 0xFAFF) || (cp >= 0x2F800 && cp <= 0x2FA1F);
}

inline bool is_combining_mark(uint32_t cp) {
  // Mn category approximation: combining diacritics blocks. After the
  // accent fold below, these are what NFD normalization would leave.
  return (cp >= 0x0300 && cp <= 0x036F) || (cp >= 0x1AB0 && cp <= 0x1AFF) ||
         (cp >= 0x1DC0 && cp <= 0x1DFF) || (cp >= 0x20D0 && cp <= 0x20FF) ||
         (cp >= 0xFE20 && cp <= 0xFE2F);
}

// Lowercase a code point (str.lower() for the scripts BERT vocabs cover:
// ASCII, Latin-1, Latin Extended-A, Greek, Cyrillic).
inline uint32_t to_lower(uint32_t cp) {
  if (cp >= 'A' && cp <= 'Z') return cp + 0x20;
  if (cp >= 0x00C0 && cp <= 0x00DE && cp != 0x00D7) return cp + 0x20;
  // İ (U+0130) lowercases to i + combining-dot (which NFD strips): NOT
  // to dotless ı — the cp|1 pairing below would silently produce ı and
  // break parity with Python's 'İ'.lower() + strip-Mn
  if (cp == 0x0130) return 'i';
  if (cp >= 0x0100 && cp <= 0x0137) return (cp | 1);
  if (cp >= 0x0139 && cp <= 0x0148) return ((cp - 1) | 1) + 1;
  if (cp >= 0x014A && cp <= 0x0177) return (cp | 1);
  if (cp == 0x0178) return 0x00FF;
  if (cp >= 0x0179 && cp <= 0x017E) return ((cp - 1) | 1) + 1;
  if (cp >= 0x0391 && cp <= 0x03A9 && cp != 0x03A2) return cp + 0x20;
  if (cp >= 0x0410 && cp <= 0x042F) return cp + 0x20;
  if (cp >= 0x0400 && cp <= 0x040F) return cp + 0x50;
  return cp;
}

// Strip accent: NFD-decompose-and-drop-Mn, folded into a single table for
// the Latin ranges (é→e, ñ→n, ç→c, ř→r, ...). Returns the base letter, or
// the input unchanged. Applied after lowercasing, so only lowercase forms
// need entries.
inline uint32_t fold_accent(uint32_t cp) {
  if (cp < 0x00C0) return cp;
  // Latin-1 supplement lowercase
  if (cp >= 0x00E0 && cp <= 0x00E5) return 'a';
  if (cp == 0x00E7) return 'c';
  if (cp >= 0x00E8 && cp <= 0x00EB) return 'e';
  if (cp >= 0x00EC && cp <= 0x00EF) return 'i';
  if (cp == 0x00F1) return 'n';
  if (cp >= 0x00F2 && cp <= 0x00F6) return 'o';
  if (cp >= 0x00F9 && cp <= 0x00FC) return 'u';
  if (cp == 0x00FD || cp == 0x00FF) return 'y';
  // Latin Extended-A lowercase (odd code points pair with base letters)
  if (cp >= 0x0100 && cp <= 0x0105) return 'a';
  if (cp >= 0x0106 && cp <= 0x010D) return 'c';
  // Ranges keep ONLY code points with a canonical NFD decomposition —
  // stroke/bar/eng/dotless letters (Đđ Ħħ ı ĸ Ŀŀ Łł ŉ Ŋŋ Ŧŧ) do not
  // decompose, so HF's NFD+strip-Mn (and our Python twin) keep them;
  // folding them here would break the C++/Python/HF parity contract.
  if (cp >= 0x010E && cp <= 0x010F) return 'd';
  if (cp >= 0x0112 && cp <= 0x011B) return 'e';
  if (cp >= 0x011C && cp <= 0x0123) return 'g';
  if (cp >= 0x0124 && cp <= 0x0125) return 'h';
  if (cp >= 0x0128 && cp <= 0x012F) return 'i';  // 0x130 handled in to_lower
  if (cp >= 0x0134 && cp <= 0x0135) return 'j';
  if (cp >= 0x0136 && cp <= 0x0137) return 'k';
  if (cp >= 0x0139 && cp <= 0x013E) return 'l';
  if (cp >= 0x0143 && cp <= 0x0148) return 'n';
  if (cp >= 0x014C && cp <= 0x0151) return 'o';
  if (cp >= 0x0154 && cp <= 0x0159) return 'r';
  if (cp >= 0x015A && cp <= 0x0161) return 's';
  if (cp >= 0x0162 && cp <= 0x0165) return 't';
  if (cp >= 0x0168 && cp <= 0x0173) return 'u';
  if (cp >= 0x0174 && cp <= 0x0175) return 'w';
  if (cp >= 0x0176 && cp <= 0x0177) return 'y';
  if (cp >= 0x0179 && cp <= 0x017E) return 'z';
  return cp;
}

// ---------------------------------------------------------------------------
// Tokenizer
// ---------------------------------------------------------------------------

struct Tokenizer {
  std::unordered_map<std::string, int32_t> vocab;
  bool lowercase;
  int32_t unk_id;
  size_t max_word_chars = 100;  // HF max_input_chars_per_word
};

struct Word {
  std::string text;   // cleaned (lowercased/folded) word text
  int32_t start, end; // code-point offsets into the ORIGINAL input text
  int32_t word_index; // index of the source whitespace-word
};

// Basic tokenization: clean + lowercase/fold + split whitespace, then split
// punctuation / CJK into standalone words. Offsets are code-point positions
// in the raw input (for QA span mapping, HF offset_mapping semantics).
void basic_tokenize(const Tokenizer& tok, const unsigned char* text, size_t len,
                    std::vector<Word>& words) {
  std::string cur;
  int32_t cur_start = -1;
  int32_t word_index = -1;      // index of current whitespace-delimited word
  bool in_space = true;         // are we between whitespace-words?
  int32_t cp_index = 0;         // code-point position in the original text
  int32_t last_cp = 0;

  auto flush = [&](int32_t end_cp) {
    if (!cur.empty()) {
      words.push_back({cur, cur_start, end_cp, word_index});
      cur.clear();
    }
    cur_start = -1;
  };

  for (size_t i = 0; i < len;) {
    uint32_t cp = decode_utf8(text, len, i);
    int32_t pos = cp_index++;
    if (cp == 0 || cp == 0xFFFD || is_control(cp)) continue;
    if (is_whitespace(cp)) {
      flush(pos);
      in_space = true;
      continue;
    }
    if (in_space) { word_index++; in_space = false; }
    if (tok.lowercase) {
      cp = fold_accent(to_lower(cp));
      if (is_combining_mark(cp)) continue;  // NFD residue: drop
    }
    if (is_punctuation(cp) || is_cjk(cp)) {
      flush(pos);
      std::string s;
      encode_utf8(cp, s);
      words.push_back({s, pos, pos + 1, word_index});
      continue;
    }
    if (cur.empty()) cur_start = pos;
    encode_utf8(cp, cur);
    last_cp = pos;
    (void)last_cp;
  }
  flush(cp_index);
}

// Greedy longest-match WordPiece over one basic word. Emits (id, start, end,
// word_index) tuples; a word with no match emits a single UNK spanning it.
// Offsets of sub-pieces are char positions within the CLEANED word mapped
// back proportionally — exact per-piece raw offsets are not recoverable
// after folding, so pieces share the word's [start, end) like HF's slow
// tokenizer unless chars map 1:1 (the common ASCII case, handled exactly).
template <typename Emit>
void wordpiece(const Tokenizer& tok, const Word& w, Emit emit) {
  // count code points + record byte offset of each code point in w.text
  std::vector<size_t> cp_byte;  // byte index of each code point
  const unsigned char* s = (const unsigned char*)w.text.data();
  size_t blen = w.text.size();
  for (size_t i = 0; i < blen;) {
    cp_byte.push_back(i);
    decode_utf8(s, blen, i);
  }
  size_t n_cp = cp_byte.size();
  cp_byte.push_back(blen);
  if (n_cp > tok.max_word_chars) {
    emit(tok.unk_id, w.start, w.end, w.word_index);
    return;
  }
  // 1:1 raw-offset mapping only valid when cleaned length == raw span length
  bool exact = (int32_t)n_cp == (w.end - w.start);

  size_t start = 0;
  std::vector<std::tuple<int32_t, size_t, size_t>> pieces;  // id, cp_start, cp_end
  while (start < n_cp) {
    size_t end = n_cp;
    int32_t found = -1;
    std::string probe;
    while (end > start) {
      probe.assign(start == 0 ? "" : "##");
      probe.append(w.text, cp_byte[start], cp_byte[end] - cp_byte[start]);
      auto it = tok.vocab.find(probe);
      if (it != tok.vocab.end()) { found = it->second; break; }
      end--;
    }
    if (found < 0) {
      emit(tok.unk_id, w.start, w.end, w.word_index);
      return;
    }
    pieces.emplace_back(found, start, end);
    start = end;
  }
  for (auto& [id, s_cp, e_cp] : pieces) {
    int32_t rs = exact ? w.start + (int32_t)s_cp : w.start;
    int32_t re = exact ? w.start + (int32_t)e_cp : w.end;
    emit(id, rs, re, w.word_index);
  }
}

void tokenize_one(const Tokenizer& tok, const unsigned char* text, size_t len,
                  int32_t cap, int32_t* ids, int32_t* word_ids,
                  int32_t* starts, int32_t* ends, int32_t* count) {
  std::vector<Word> words;
  words.reserve(len / 4 + 4);
  basic_tokenize(tok, text, len, words);
  int32_t n = 0;
  for (const Word& w : words) {
    if (n >= cap) break;
    wordpiece(tok, w, [&](int32_t id, int32_t s, int32_t e, int32_t wi) {
      if (n >= cap) return;
      ids[n] = id;
      if (word_ids) word_ids[n] = wi;
      if (starts) starts[n] = s;
      if (ends) ends[n] = e;
      n++;
    });
  }
  *count = n;
}

}  // namespace

extern "C" {

// vocab: newline-separated token strings; token id = line index.
void* wp_new(const char* vocab_bytes, int64_t vocab_len, int lowercase,
             int32_t unk_id) {
  auto* t = new Tokenizer();
  t->lowercase = lowercase != 0;
  t->unk_id = unk_id;
  const char* p = vocab_bytes;
  const char* end = vocab_bytes + vocab_len;
  int32_t id = 0;
  while (p < end) {
    const char* nl = (const char*)memchr(p, '\n', end - p);
    size_t n = nl ? (size_t)(nl - p) : (size_t)(end - p);
    if (n > 0 && p[n - 1] == '\r') n--;
    t->vocab.emplace(std::string(p, n), id++);
    if (!nl) break;
    p = nl + 1;
  }
  return t;
}

void wp_free(void* t) { delete (Tokenizer*)t; }

int32_t wp_vocab_size(void* t) { return (int32_t)((Tokenizer*)t)->vocab.size(); }

int32_t wp_token_id(void* t, const char* token) {
  auto& v = ((Tokenizer*)t)->vocab;
  auto it = v.find(token);
  return it == v.end() ? -1 : it->second;
}

// Tokenize n texts (concatenated UTF-8 `texts`, row r = bytes
// [offsets[r], offsets[r+1])) into per-row streams of at most `cap` tokens.
// Outputs are [n, cap] row-major; counts is [n]. word_ids/starts/ends may be
// NULL. Multithreaded over rows.
void wp_tokenize_batch(void* tptr, const char* texts, const int64_t* offsets,
                       int32_t n, int32_t cap, int32_t n_threads,
                       int32_t* ids, int32_t* word_ids,
                       int32_t* starts, int32_t* ends, int32_t* counts) {
  const Tokenizer& tok = *(Tokenizer*)tptr;
  n_threads = std::max(1, std::min<int32_t>(n_threads, n));
  std::atomic<int32_t> next(0);
  auto work = [&]() {
    for (;;) {
      int32_t r = next.fetch_add(1);
      if (r >= n) return;
      const unsigned char* p = (const unsigned char*)texts + offsets[r];
      size_t len = (size_t)(offsets[r + 1] - offsets[r]);
      tokenize_one(tok, p, len, cap,
                   ids + (int64_t)r * cap,
                   word_ids ? word_ids + (int64_t)r * cap : nullptr,
                   starts ? starts + (int64_t)r * cap : nullptr,
                   ends ? ends + (int64_t)r * cap : nullptr,
                   counts + r);
    }
  };
  if (n_threads == 1) { work(); return; }
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int32_t i = 0; i < n_threads; i++) threads.emplace_back(work);
  for (auto& th : threads) th.join();
}

}  // extern "C"
