// avdn_host — host-side preprocessing of the PyTorch port: the INTER_AREA
// resampler of map tiles (data/maps.py:load_map_image), the BGR -> RGB
// channel swap, and the WordPiece encoder behind data/tokenizer.py's
// static-shape batches. The port's own copy of the JAX package's host
// library, built by ops/build.py with the host compiler (-O3 -fPIC
// -std=c++17 -shared) and loaded with ctypes by data/native.py.
//
// area_resize_u8 implements INTER_AREA semantics: each destination pixel
// averages the exact (fractional) source-pixel coverage of its footprint.
// Its doubles are rounded once per product and per sum: the library is
// built without -march and without -ffast-math, so the compiler emits no
// fused multiply-add, and data/resample.py (numpy, the same order of
// operations) is bit-equal to it.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

// src: (sh, sw, ch) uint8 row-major; dst: (dh, dw, ch).
void area_resize_u8(const uint8_t* src, int sh, int sw, int ch,
                    uint8_t* dst, int dh, int dw) {
  const double sy = static_cast<double>(sh) / dh;
  const double sx = static_cast<double>(sw) / dw;

  // Precompute horizontal coverage spans: for each dst column, the list of
  // (src column, weight) pairs.
  struct Span {
    int begin;
    int count;
  };
  std::vector<Span> xspan(dw);
  std::vector<double> xw;  // flattened weights
  std::vector<int> xi;     // flattened indices
  for (int dx = 0; dx < dw; ++dx) {
    double x0 = dx * sx;
    double x1 = std::min(x0 + sx, static_cast<double>(sw));
    int ix0 = static_cast<int>(x0);
    int ix1 = std::min(static_cast<int>(std::ceil(x1)), sw);
    xspan[dx].begin = static_cast<int>(xw.size());
    for (int x = ix0; x < ix1; ++x) {
      double cover = std::min<double>(x + 1, x1) - std::max<double>(x, x0);
      if (cover <= 0) continue;
      xi.push_back(x);
      xw.push_back(cover);
    }
    xspan[dx].count = static_cast<int>(xw.size()) - xspan[dx].begin;
  }

  std::vector<double> row_acc(static_cast<size_t>(dw) * ch);
  std::vector<double> col_acc(static_cast<size_t>(dw) * ch);

  for (int dy = 0; dy < dh; ++dy) {
    double y0 = dy * sy;
    double y1 = std::min(y0 + sy, static_cast<double>(sh));
    int iy0 = static_cast<int>(y0);
    int iy1 = std::min(static_cast<int>(std::ceil(y1)), sh);
    std::fill(col_acc.begin(), col_acc.end(), 0.0);
    double total_h = 0.0;
    for (int y = iy0; y < iy1; ++y) {
      double cover_y = std::min<double>(y + 1, y1) - std::max<double>(y, y0);
      if (cover_y <= 0) continue;
      total_h += cover_y;
      const uint8_t* srow = src + (static_cast<size_t>(y) * sw) * ch;
      // horizontal pass for this source row
      std::fill(row_acc.begin(), row_acc.end(), 0.0);
      for (int dx = 0; dx < dw; ++dx) {
        double* out = &row_acc[static_cast<size_t>(dx) * ch];
        for (int k = 0; k < xspan[dx].count; ++k) {
          int idx = xspan[dx].begin + k;
          const uint8_t* px = srow + static_cast<size_t>(xi[idx]) * ch;
          double w = xw[idx];
          for (int c = 0; c < ch; ++c) out[c] += w * px[c];
        }
      }
      for (size_t j = 0; j < col_acc.size(); ++j)
        col_acc[j] += cover_y * row_acc[j];
    }
    uint8_t* drow = dst + (static_cast<size_t>(dy) * dw) * ch;
    for (int dx = 0; dx < dw; ++dx) {
      double norm_x = 0.0;
      for (int k = 0; k < xspan[dx].count; ++k)
        norm_x += xw[xspan[dx].begin + k];
      double inv = 1.0 / (total_h * norm_x);
      const double* acc = &col_acc[static_cast<size_t>(dx) * ch];
      for (int c = 0; c < ch; ++c) {
        double v = acc[c] * inv;
        drow[static_cast<size_t>(dx) * ch + c] =
            static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v + 0.5));
      }
    }
  }
}

// In-place channel reversal (BGR <-> RGB).
void swap_rb_u8(uint8_t* img, int h, int w) {
  size_t n = static_cast<size_t>(h) * w;
  for (size_t i = 0; i < n; ++i) {
    std::swap(img[i * 3], img[i * 3 + 2]);
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// WordPiece tokenizer (bert-base-uncased semantics, ASCII fast path).
//
// Plays the role HuggingFace's native (Rust) tokenizer plays in the
// reference (src/xview_et/agent.py:125). Mirrors the pure-Python
// implementation in data/tokenizer.py exactly for ASCII input —
// texts containing any non-ASCII byte are flagged for the Python encoder
// (BERT's NFD accent stripping needs full Unicode tables). Two modes:
//   * real vocab: greedy longest-match WordPiece over a loaded vocab.txt;
//   * hashed vocabulary (hash_size > 0): whole-token ids via
//     1000 + crc32(token) % (hash_size - 1000), matching
//     WordPieceTokenizer.fallback()'s zlib.crc32 scheme.
// ---------------------------------------------------------------------------

namespace {

struct WpTokenizer {
  std::unordered_map<std::string, int32_t> vocab;  // empty in hashed mode
  int hash_size = 0;  // > 0 => hashed-fallback mode
  bool lowercase = true;
  int32_t pad_id = 0, unk_id = 100, cls_id = 101, sep_id = 102;
  size_t max_chars_per_word = 100;
};

uint32_t g_crc_table[256];
bool g_crc_ready = false;

void crc32_build_table() {
  if (g_crc_ready) return;
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k)
      c = (c & 1u) ? (0xEDB88320u ^ (c >> 1)) : (c >> 1);
    g_crc_table[i] = c;
  }
  g_crc_ready = true;
}

// zlib-compatible CRC-32 (what Python's zlib.crc32 computes).
uint32_t crc32_of(const std::string& s) {
  crc32_build_table();
  uint32_t c = 0xFFFFFFFFu;
  for (unsigned char ch : s) c = g_crc_table[(c ^ ch) & 0xFFu] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// ASCII subset of BERT's _is_punctuation (the unicodedata branch adds
// nothing within ASCII: every ASCII punctuation char is in these ranges).
inline bool ascii_punct(uint8_t c) {
  return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
         (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

// Append the WordPiece ids of one basic token. Mirrors
// tokenizer.py:wordpiece + the __call__ vocab lookup.
void wp_encode_word(const WpTokenizer& t, const std::string& word,
                    std::vector<int32_t>* out) {
  if (word.size() > t.max_chars_per_word) {
    out->push_back(t.unk_id);
    return;
  }
  if (t.hash_size > 0) {
    // hashed fallback: whole token -> stable id (specials like "[CLS]"
    // cannot appear here: basic tokenization splits the brackets off)
    out->push_back(1000 + static_cast<int32_t>(
        crc32_of(word) % static_cast<uint32_t>(t.hash_size - 1000)));
    return;
  }
  size_t start = 0;
  std::string key;
  size_t first = out->size();
  while (start < word.size()) {
    size_t end = word.size();
    int32_t cur = -1;
    while (start < end) {
      key.assign(start > 0 ? "##" : "");
      key.append(word, start, end - start);
      auto it = t.vocab.find(key);
      if (it != t.vocab.end()) {
        cur = it->second;
        break;
      }
      --end;
    }
    if (cur < 0) {  // un-encodable word -> single [UNK]
      out->resize(first);
      out->push_back(t.unk_id);
      return;
    }
    out->push_back(cur);
    start = end;
  }
}

}  // namespace

extern "C" {

// vocab_buf: '\n'-separated vocab.txt content (real-vocab mode), or NULL
// with hash_size > 0 for the hashed vocabulary. Returns NULL if the
// vocab is missing any special token (the caller then encodes in Python).
void* wp_create(const char* vocab_buf, long long vocab_len, int lowercase,
                int hash_size) {
  WpTokenizer* t = new WpTokenizer();
  t->lowercase = lowercase != 0;
  t->hash_size = hash_size;
  if (hash_size > 0) {
    if (hash_size <= 1000) {
      delete t;
      return nullptr;
    }
    return t;  // fixed special ids (tokenizer.py:fallback)
  }
  if (vocab_buf == nullptr) {
    delete t;
    return nullptr;
  }
  int32_t idx = 0;
  const char* p = vocab_buf;
  const char* endp = vocab_buf + vocab_len;
  while (p < endp) {
    const char* nl = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(endp - p)));
    const char* line_end = nl ? nl : endp;
    t->vocab.emplace(std::string(p, line_end), idx++);
    p = nl ? nl + 1 : endp;
  }
  auto need = [&](const char* tok, int32_t* slot) {
    auto it = t->vocab.find(tok);
    if (it == t->vocab.end()) return false;
    *slot = it->second;
    return true;
  };
  if (!need("[PAD]", &t->pad_id) || !need("[UNK]", &t->unk_id) ||
      !need("[CLS]", &t->cls_id) || !need("[SEP]", &t->sep_id)) {
    delete t;
    return nullptr;
  }
  return t;
}

void wp_destroy(void* h) { delete static_cast<WpTokenizer*>(h); }

// Batch encode. texts: concatenated UTF-8 bytes; offsets: n+1 cumulative
// byte offsets. Writes (n, pad_to) int32 ids + mask rows ([CLS] pieces
// [SEP], truncated to max_length tokens total like tokenizer.py.__call__).
// Any text containing a non-ASCII byte gets need_fallback[i] = 1 and its
// row untouched (caller encodes it in Python). Returns 0 on success.
int wp_encode_batch(void* h, const char* texts, const long long* offsets,
                    int n, int max_length, int pad_to, int32_t* out_ids,
                    int32_t* out_mask, uint8_t* need_fallback) {
  const WpTokenizer& t = *static_cast<WpTokenizer*>(h);
  if (max_length < 2 || pad_to < 1) return -1;
  const size_t piece_cap = static_cast<size_t>(max_length) - 2;
  std::vector<int32_t> pieces;
  std::string word;
  for (int i = 0; i < n; ++i) {
    const char* s = texts + offsets[i];
    const size_t len = static_cast<size_t>(offsets[i + 1] - offsets[i]);
    need_fallback[i] = 0;
    bool ascii = true;
    for (size_t j = 0; j < len; ++j) {
      if (static_cast<uint8_t>(s[j]) >= 0x80u) {
        ascii = false;
        break;
      }
    }
    if (!ascii) {
      need_fallback[i] = 1;
      continue;
    }
    pieces.clear();
    word.clear();
    // basic tokenization (tokenizer.py:basic_tokenize, ASCII subset):
    // control chars vanish WITHOUT splitting the word; whitespace splits;
    // punctuation splits and is its own token; letters lowercase.
    for (size_t j = 0; j <= len && pieces.size() < piece_cap; ++j) {
      uint8_t c = j < len ? static_cast<uint8_t>(s[j]) : ' ';
      if (c == ' ' || c == '\t' || c == '\n' || c == '\r') {
        if (!word.empty()) {
          wp_encode_word(t, word, &pieces);
          word.clear();
        }
      } else if (c < 0x20u || c == 0x7Fu) {
        // ASCII control (category Cc): dropped, word continues
      } else if (ascii_punct(c)) {
        if (!word.empty()) {
          wp_encode_word(t, word, &pieces);
          word.clear();
        }
        if (pieces.size() < piece_cap) {
          std::string p1(1, static_cast<char>(c));
          wp_encode_word(t, p1, &pieces);
        }
      } else {
        word.push_back(static_cast<char>(
            t.lowercase && c >= 'A' && c <= 'Z' ? c + 32 : c));
      }
    }
    if (pieces.size() > piece_cap) pieces.resize(piece_cap);
    // row: [CLS] pieces [SEP], truncated to pad_to, padded with pad_id
    int32_t* ids_row = out_ids + static_cast<size_t>(i) * pad_to;
    int32_t* mask_row = out_mask + static_cast<size_t>(i) * pad_to;
    size_t seq_len = std::min<size_t>(pieces.size() + 2,
                                      static_cast<size_t>(pad_to));
    size_t k = 0;
    if (k < seq_len) ids_row[k++] = t.cls_id;
    for (size_t p = 0; p < pieces.size() && k < seq_len; ++p)
      ids_row[k++] = pieces[p];
    if (k < seq_len) ids_row[k++] = t.sep_id;
    for (size_t j = 0; j < static_cast<size_t>(pad_to); ++j) {
      mask_row[j] = j < seq_len ? 1 : 0;
      if (j >= seq_len) ids_row[j] = t.pad_id;
    }
  }
  return 0;
}

}  // extern "C"
