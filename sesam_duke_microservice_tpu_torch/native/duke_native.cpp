// Native host hot path: batched string comparators.
//
// The reference's hot loop is per-pair per-property Comparator.compare inside
// the Duke 1.2 jar (driven at App.java:1005/1159; SURVEY.md section 3.2 "hot
// loops").  In this framework the TPU scores candidate blocks, but host paths
// still burn CPU on scalar string comparison — the host reference engine
// (engine/processor.py) and the device matcher's host-exact finalization both
// dispatch through core/comparators.py, whose Levenshtein/JaroWinkler/
// WeightedLevenshtein route here via the SCALAR entry points at the bottom of
// this file.  The *_batch entry points are the library's bulk API (one call,
// many pairs — amortizes the FFI boundary ~10x over scalar) for tooling and
// bulk rescoring; tests/test_native.py pins both shapes to the pure-Python
// oracles.  Levenshtein is Myers/Hyyro bit-parallel for patterns <= 64
// codepoints with a plain-DP fallback.
//
// Strings cross the boundary as UTF-32 codepoints (uint32) in one contiguous
// buffer with an int64 offsets array: pair i is a[a_off[i]:a_off[i+1]] vs
// b[b_off[i]:b_off[i+1]].  Pure C ABI for ctypes.

#include <algorithm>
#include <cstdint>
#include <cmath>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Levenshtein distance, exact.  Myers bit-parallel O(n) per text char for
// patterns up to 64 codepoints (Hyyro's formulation); banded-free plain DP
// rows otherwise.  Both return the exact distance.

int64_t lev_plain(const uint32_t* s1, int64_t n1, const uint32_t* s2,
                  int64_t n2) {
    std::vector<int64_t> prev(n2 + 1), cur(n2 + 1);
    for (int64_t j = 0; j <= n2; ++j) prev[j] = j;
    for (int64_t i = 1; i <= n1; ++i) {
        cur[0] = i;
        const uint32_t c1 = s1[i - 1];
        for (int64_t j = 1; j <= n2; ++j) {
            const int64_t cost = (c1 == s2[j - 1]) ? 0 : 1;
            cur[j] = std::min({prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost});
        }
        std::swap(prev, cur);
    }
    return prev[n2];
}

int64_t lev_myers64(const uint32_t* pat, int64_t m, const uint32_t* text,
                    int64_t n) {
    // peq: ASCII fast path in a flat table, map for the rest
    uint64_t peq_ascii[128];
    std::memset(peq_ascii, 0, sizeof(peq_ascii));
    std::unordered_map<uint32_t, uint64_t> peq_other;
    for (int64_t i = 0; i < m; ++i) {
        const uint32_t c = pat[i];
        if (c < 128) peq_ascii[c] |= 1ULL << i;
        else peq_other[c] |= 1ULL << i;
    }
    uint64_t pv = ~0ULL, mv = 0;
    int64_t score = m;
    const uint64_t high = 1ULL << (m - 1);
    for (int64_t j = 0; j < n; ++j) {
        const uint32_t c = text[j];
        uint64_t eq;
        if (c < 128) {
            eq = peq_ascii[c];
        } else {
            auto it = peq_other.find(c);
            eq = (it == peq_other.end()) ? 0 : it->second;
        }
        const uint64_t xv = eq | mv;
        const uint64_t xh = (((eq & pv) + pv) ^ pv) | eq;
        uint64_t ph = mv | ~(xh | pv);
        uint64_t mh = pv & xh;
        if (ph & high) ++score;
        if (mh & high) --score;
        ph = (ph << 1) | 1;
        mh = mh << 1;
        pv = mh | ~(xv | ph);
        mv = ph & xv;
    }
    return score;
}

int64_t lev_distance(const uint32_t* s1, int64_t n1, const uint32_t* s2,
                     int64_t n2) {
    if (n1 == 0) return n2;
    if (n2 == 0) return n1;
    // pattern = shorter string for the bit-parallel path
    const uint32_t* pat = s1;
    int64_t m = n1;
    const uint32_t* text = s2;
    int64_t n = n2;
    if (m > n) { std::swap(pat, text); std::swap(m, n); }
    if (m <= 64) return lev_myers64(pat, m, text, n);
    return lev_plain(pat, m, text, n);
}

// Duke Levenshtein similarity semantics (core/comparators.py Levenshtein):
// equal -> 1; empty shorter -> 0; length-ratio early exit -> 0;
// sim = 1 - min(dist, shorter)/shorter.
double lev_sim(const uint32_t* a, int64_t na, const uint32_t* b, int64_t nb) {
    if (na == nb && std::memcmp(a, b, na * sizeof(uint32_t)) == 0) return 1.0;
    const int64_t shorter = std::min(na, nb);
    const int64_t longer = std::max(na, nb);
    if (shorter == 0) return 0.0;
    if ((longer - shorter) * 2 > shorter) return 0.0;
    const int64_t dist = std::min(lev_distance(a, na, b, nb), shorter);
    return 1.0 - static_cast<double>(dist) / static_cast<double>(shorter);
}

// ---------------------------------------------------------------------------
// Jaro-Winkler (core/comparators.py _jaro/JaroWinkler parity).

double jaro(const uint32_t* s1, int64_t n1, const uint32_t* s2, int64_t n2,
            std::vector<uint8_t>& matched2, std::vector<uint32_t>& m1) {
    if (n1 == 0 || n2 == 0) return 0.0;
    const int64_t window = std::max<int64_t>(std::max(n1, n2) / 2 - 1, 0);
    matched2.assign(n2, 0);
    m1.clear();
    int64_t matches = 0;
    for (int64_t i = 0; i < n1; ++i) {
        const uint32_t c = s1[i];
        const int64_t lo = std::max<int64_t>(0, i - window);
        const int64_t hi = std::min(n2, i + window + 1);
        for (int64_t j = lo; j < hi; ++j) {
            if (!matched2[j] && s2[j] == c) {
                matched2[j] = 1;
                ++matches;
                m1.push_back(c);
                break;
            }
        }
    }
    if (matches == 0) return 0.0;
    int64_t transpositions = 0;
    int64_t k = 0;
    for (int64_t j = 0; j < n2; ++j) {
        if (matched2[j]) {
            if (m1[k] != s2[j]) ++transpositions;
            ++k;
        }
    }
    transpositions /= 2;
    const double m = static_cast<double>(matches);
    return (m / n1 + m / n2 + (m - transpositions) / m) / 3.0;
}

double jaro_winkler(const uint32_t* a, int64_t na, const uint32_t* b,
                   int64_t nb, double prefix_scale, double boost_threshold,
                   int64_t max_prefix, std::vector<uint8_t>& matched2,
                   std::vector<uint32_t>& m1) {
    if (na == nb && std::memcmp(a, b, na * sizeof(uint32_t)) == 0) return 1.0;
    const double j = jaro(a, na, b, nb, matched2, m1);
    if (j < boost_threshold) return j;
    int64_t prefix = 0;
    const int64_t lim = std::min(na, nb);
    for (int64_t i = 0; i < lim; ++i) {
        if (a[i] != b[i] || prefix == max_prefix) break;
        ++prefix;
    }
    return j + prefix * prefix_scale * (1.0 - j);
}

// ---------------------------------------------------------------------------
// Weighted Levenshtein (core/comparators.py WeightedLevenshtein parity):
// per-character class weights; substitution costs max(w1, w2).

double wl_weight(uint32_t c, double dw, double lw, double ow) {
    // ASCII classes only, matching Python str.isdigit/isalpha for the ASCII
    // range the comparator is used on (id-ish fields); non-ASCII letters are
    // classed by a conservative alpha check
    if (c >= '0' && c <= '9') return dw;
    if ((c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z')) return lw;
    if (c >= 128) return lw;  // treat non-ASCII as letters (Python isalpha-ish)
    return ow;
}

double weighted_lev_sim(const uint32_t* a, int64_t na, const uint32_t* b,
                       int64_t nb, double dw, double lw, double ow) {
    if (na == nb && std::memcmp(a, b, na * sizeof(uint32_t)) == 0) return 1.0;
    const int64_t shorter = std::min(na, nb);
    if (shorter == 0) return 0.0;
    std::vector<double> prev(nb + 1), cur(nb + 1);
    prev[0] = 0.0;
    for (int64_t j = 1; j <= nb; ++j)
        prev[j] = prev[j - 1] + wl_weight(b[j - 1], dw, lw, ow);
    for (int64_t i = 1; i <= na; ++i) {
        const double w1 = wl_weight(a[i - 1], dw, lw, ow);
        cur[0] = prev[0] + w1;
        for (int64_t j = 1; j <= nb; ++j) {
            const double w2 = wl_weight(b[j - 1], dw, lw, ow);
            const double sub = (a[i - 1] == b[j - 1]) ? 0.0 : std::max(w1, w2);
            cur[j] = std::min({prev[j] + w1, cur[j - 1] + w2, prev[j - 1] + sub});
        }
        std::swap(prev, cur);
    }
    const double dist = std::min(prev[nb], static_cast<double>(shorter));
    return 1.0 - dist / shorter;
}

// -- hashed-n-gram record embeddings (ops/encoder.py parity) ----------------
// Trigram window hashing with the exact constants of the Python/numpy path
// (ops.encoder._H_MULT/_FM1/_FM2): one odd multiplier per window position,
// xor'd with a per-(property)-salt, then a murmur3-style finalizer.  The
// Python implementation is the parity oracle (tests/test_native.py).

constexpr uint64_t kEmbMult0 = 0x9E3779B97F4A7C15ULL;
constexpr uint64_t kEmbMult1 = 0xC2B2AE3D27D4EB4FULL;
constexpr uint64_t kEmbMult2 = 0x165667B19E3779F9ULL;
constexpr uint64_t kEmbFm1 = 0xFF51AFD7ED558CCDULL;
constexpr uint64_t kEmbFm2 = 0xC4CEB9FE1A85EC53ULL;

inline uint64_t emb_fmix(uint64_t h) {
    h ^= h >> 33;
    h *= kEmbFm1;
    h ^= h >> 29;
    h *= kEmbFm2;
    h ^= h >> 32;
    return h;
}

}  // namespace

extern "C" {

// One embedding per record.  cp_buf holds the concatenated (already padded
// + lowercased, see ops.encoder) codepoints of every value; val_off[v] /
// val_off[v+1] bound value v; salts[v] is its property salt; rec_off[r]
// bounds record r's value range.  out is (n_rec, dim) float32, L2
// normalized per row.
void duke_embed_batch(const uint32_t* cp_buf, const int64_t* val_off,
                      const uint64_t* salts, const int64_t* rec_off,
                      int64_t n_rec, int64_t dim, float* out) {
    std::unordered_map<uint64_t, int64_t> counts;
    std::vector<uint32_t> tiny;
    for (int64_t r = 0; r < n_rec; ++r) {
        counts.clear();
        for (int64_t v = rec_off[r]; v < rec_off[r + 1]; ++v) {
            const uint32_t* cp = cp_buf + val_off[v];
            int64_t len = val_off[v + 1] - val_off[v];
            if (len < 3) {  // zero-pad to one window (numpy np.pad parity)
                tiny.assign(3, 0);
                for (int64_t i = 0; i < len; ++i) tiny[i] = cp[i];
                cp = tiny.data();
                len = 3;
            }
            const uint64_t salt = salts[v];
            for (int64_t i = 0; i + 2 < len; ++i) {
                uint64_t h = salt;
                h ^= static_cast<uint64_t>(cp[i]) * kEmbMult0;
                h ^= static_cast<uint64_t>(cp[i + 1]) * kEmbMult1;
                h ^= static_cast<uint64_t>(cp[i + 2]) * kEmbMult2;
                ++counts[emb_fmix(h)];
            }
        }
        float* vec = out + r * dim;
        std::fill(vec, vec + dim, 0.0f);
        double sq = 0.0;
        for (const auto& kv : counts) {
            const uint64_t h = kv.first;
            const int64_t bucket = static_cast<int64_t>(h % static_cast<uint64_t>(dim));
            const float sign = ((h >> 32) & 1ULL) ? 1.0f : -1.0f;
            vec[bucket] += sign * std::sqrt(static_cast<float>(kv.second));
        }
        for (int64_t d = 0; d < dim; ++d) sq += static_cast<double>(vec[d]) * vec[d];
        if (sq > 0.0) {
            const float inv = static_cast<float>(1.0 / std::sqrt(sq));
            for (int64_t d = 0; d < dim; ++d) vec[d] *= inv;
        }
    }
}

void duke_lev_sim_batch(const uint32_t* a_buf, const int64_t* a_off,
                        const uint32_t* b_buf, const int64_t* b_off,
                        int64_t n, double* out) {
    for (int64_t i = 0; i < n; ++i) {
        out[i] = lev_sim(a_buf + a_off[i], a_off[i + 1] - a_off[i],
                         b_buf + b_off[i], b_off[i + 1] - b_off[i]);
    }
}

void duke_jaro_winkler_batch(const uint32_t* a_buf, const int64_t* a_off,
                             const uint32_t* b_buf, const int64_t* b_off,
                             int64_t n, double prefix_scale,
                             double boost_threshold, int64_t max_prefix,
                             double* out) {
    std::vector<uint8_t> matched2;
    std::vector<uint32_t> m1;
    for (int64_t i = 0; i < n; ++i) {
        out[i] = jaro_winkler(a_buf + a_off[i], a_off[i + 1] - a_off[i],
                              b_buf + b_off[i], b_off[i + 1] - b_off[i],
                              prefix_scale, boost_threshold, max_prefix,
                              matched2, m1);
    }
}

void duke_weighted_lev_batch(const uint32_t* a_buf, const int64_t* a_off,
                             const uint32_t* b_buf, const int64_t* b_off,
                             int64_t n, double digit_weight,
                             double letter_weight, double other_weight,
                             double* out) {
    for (int64_t i = 0; i < n; ++i) {
        out[i] = weighted_lev_sim(a_buf + a_off[i], a_off[i + 1] - a_off[i],
                                  b_buf + b_off[i], b_off[i + 1] - b_off[i],
                                  digit_weight, letter_weight, other_weight);
    }
}

int64_t duke_lev_distance(const uint32_t* a, int64_t na, const uint32_t* b,
                          int64_t nb) {
    return lev_distance(a, na, b, nb);
}

// Bulk q-gram set extraction (ops.features GRAM_SET): for each value
// (UTF-32 codepoint range), hash every q-codepoint window — the whole
// value when shorter than q — with FNV-1a64 over the window's UTF-8
// encoding, fold to int32 ((h ^ h>>32) low word, two's complement),
// dedupe + sort ascending (signed), truncate to max_grams.  out_grams is
// (n, max_grams) prefilled with the SET_PAD sentinel; bit-identical to
// the Python path (qgrams + fnv1a64_batch + sorted(set(...))) —
// differential-tested in tests/test_native.py.
void duke_gram_set_batch(const uint32_t* buf, const int64_t* off, int64_t n,
                         int64_t q, int64_t max_grams, int32_t* out_grams,
                         int32_t* out_counts) {
    constexpr uint64_t kOffset = 0xCBF29CE484222325ULL;
    constexpr uint64_t kPrime = 0x100000001B3ULL;
    std::vector<int32_t> ids;
    for (int64_t i = 0; i < n; ++i) {
        const uint32_t* cp = buf + off[i];
        const int64_t len = off[i + 1] - off[i];
        out_counts[i] = 0;
        if (len == 0) continue;
        const int64_t win = len < q ? len : q;
        const int64_t n_win = len < q ? 1 : len - q + 1;
        ids.clear();
        for (int64_t w = 0; w < n_win; ++w) {
            uint64_t h = kOffset;
            for (int64_t j = 0; j < win; ++j) {
                // inline UTF-8 encoding of one codepoint (surrogatepass:
                // D800-DFFF take the normal 3-byte form, matching
                // str.encode("utf-8", "surrogatepass"))
                const uint32_t c = cp[w + j];
                if (c < 0x80) {
                    h = (h ^ c) * kPrime;
                } else if (c < 0x800) {
                    h = (h ^ (0xC0 | (c >> 6))) * kPrime;
                    h = (h ^ (0x80 | (c & 0x3F))) * kPrime;
                } else if (c < 0x10000) {
                    h = (h ^ (0xE0 | (c >> 12))) * kPrime;
                    h = (h ^ (0x80 | ((c >> 6) & 0x3F))) * kPrime;
                    h = (h ^ (0x80 | (c & 0x3F))) * kPrime;
                } else {
                    h = (h ^ (0xF0 | (c >> 18))) * kPrime;
                    h = (h ^ (0x80 | ((c >> 12) & 0x3F))) * kPrime;
                    h = (h ^ (0x80 | ((c >> 6) & 0x3F))) * kPrime;
                    h = (h ^ (0x80 | (c & 0x3F))) * kPrime;
                }
            }
            ids.push_back(static_cast<int32_t>(
                static_cast<uint32_t>((h ^ (h >> 32)) & 0xFFFFFFFFULL)));
        }
        std::sort(ids.begin(), ids.end());
        ids.erase(std::unique(ids.begin(), ids.end()), ids.end());
        const int64_t count = static_cast<int64_t>(ids.size()) < max_grams
                                  ? static_cast<int64_t>(ids.size())
                                  : max_grams;
        int32_t* row = out_grams + i * max_grams;
        for (int64_t g = 0; g < count; ++g) row[g] = ids[g];
        out_counts[i] = static_cast<int32_t>(count);
    }
}

// Bulk FNV-1a64 over UTF-8 byte ranges: the ingest hot path hashes every
// value plus every q-gram/token per record (ops.features), and even the
// vectorized numpy fold costs ~45 us per KB of grouped padding work.
// buf/off follow the batch packing convention (off has n+1 entries).
// Bit-identical to ops.features.fnv1a64 (differential-tested).
void duke_fnv1a64_batch(const uint8_t* buf, const int64_t* off, int64_t n,
                        uint64_t* out) {
    constexpr uint64_t kOffset = 0xCBF29CE484222325ULL;
    constexpr uint64_t kPrime = 0x100000001B3ULL;
    for (int64_t i = 0; i < n; ++i) {
        uint64_t h = kOffset;
        for (int64_t p = off[i]; p < off[i + 1]; ++p) {
            h ^= buf[p];
            h *= kPrime;
        }
        out[i] = h;
    }
}

// Scalar entry points for the per-pair comparator dispatch: take the raw
// UTF-32 byte buffers straight from str.encode() so the Python side skips
// numpy packing (the batch functions amortize that cost; a scalar call
// cannot).

double duke_lev_sim(const uint32_t* a, int64_t na, const uint32_t* b,
                    int64_t nb) {
    return lev_sim(a, na, b, nb);
}

double duke_jaro_winkler(const uint32_t* a, int64_t na, const uint32_t* b,
                         int64_t nb, double prefix_scale,
                         double boost_threshold, int64_t max_prefix) {
    std::vector<uint8_t> matched2;
    std::vector<uint32_t> m1;
    return jaro_winkler(a, na, b, nb, prefix_scale, boost_threshold,
                        max_prefix, matched2, m1);
}

double duke_weighted_lev(const uint32_t* a, int64_t na, const uint32_t* b,
                         int64_t nb, double digit_weight,
                         double letter_weight, double other_weight) {
    return weighted_lev_sim(a, na, b, nb, digit_weight, letter_weight,
                            other_weight);
}

}  // extern "C"
