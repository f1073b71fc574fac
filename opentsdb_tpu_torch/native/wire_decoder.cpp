// Native wire decoder: the host-side ingest hot loop of the PyTorch port.
//
// A copy of the JAX package's native/wire_decoder.cpp (the same grammar,
// error text and C entry points), built by
// opentsdb_tpu_torch/utils/nativeext.py at first use and loaded with
// ctypes by opentsdb_tpu_torch/server/wire.py.
//
// Parses batches of telnet-protocol lines
//     put <metric> <timestamp> <value> <tag=value> [<tag=value> ...]
// into columnar arrays (timestamp, value-or-int, is_float, series id) plus
// a deduplicated series table "metric tag=v tag=v..." with tags sorted by
// name — exactly the canonical form the Python layer feeds to
// TSDB.add_batch. This replaces the reference's per-line Java parsing
// (WordSplitter + PutDataPointRpc + Tags.parse) with one C++ pass so the
// Python/device pipeline sees only arrays (SURVEY.md §7 "hard parts":
// host->device feed rate must not bottleneck at 1M dps/s).
//
// Exposed as a C ABI for ctypes. No dependencies beyond the C++17
// standard library.

#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>
#include <algorithm>
#include <charconv>
#include <cstdlib>

namespace {

struct Arena {
    std::vector<int64_t> timestamps;
    std::vector<double> fvalues;
    std::vector<int64_t> ivalues;
    std::vector<uint8_t> is_float;
    std::vector<int32_t> sid;
    std::vector<std::string> series;              // sid -> canonical name
    std::unordered_map<std::string, int32_t> series_ids;
    std::vector<std::string> errors;              // per bad line
    size_t consumed = 0;                          // bytes of complete lines
};

bool is_space(char c) { return c == ' '; }

// Parse a base-10 int64; returns false on junk/overflow.
bool parse_i64(std::string_view s, int64_t* out) {
    if (s.empty()) return false;
    size_t i = 0;
    bool neg = false;
    if (s[0] == '+' || s[0] == '-') { neg = s[0] == '-'; i = 1; }
    if (i >= s.size()) return false;
    uint64_t v = 0;
    for (; i < s.size(); i++) {
        char c = s[i];
        if (c < '0' || c > '9') return false;
        uint64_t d = c - '0';
        if (v > (UINT64_MAX - d) / 10) return false;
        v = v * 10 + d;
    }
    if (neg) {
        if (v > (uint64_t)INT64_MAX + 1) return false;
        *out = (int64_t)(0 - v);
    } else {
        if (v > (uint64_t)INT64_MAX) return false;
        *out = (int64_t)v;
    }
    return true;
}

bool looks_like_integer(std::string_view s) {
    if (s.empty()) return false;
    size_t i = (s[0] == '+' || s[0] == '-') ? 1 : 0;
    if (i >= s.size()) return false;
    for (; i < s.size(); i++)
        if (s[i] < '0' || s[i] > '9') return false;
    return true;
}

// [+-]?(digits[.digits*] | .digits)([eE][+-]?digits)? — the shared wire
// grammar for non-integer values.
bool strict_float_grammar(std::string_view s) {
    size_t i = 0;
    if (i < s.size() && (s[i] == '+' || s[i] == '-')) i++;
    size_t int_digits = 0, frac_digits = 0;
    while (i < s.size() && s[i] >= '0' && s[i] <= '9') { i++; int_digits++; }
    if (i < s.size() && s[i] == '.') {
        i++;
        while (i < s.size() && s[i] >= '0' && s[i] <= '9') {
            i++;
            frac_digits++;
        }
    }
    if (int_digits == 0 && frac_digits == 0) return false;
    if (i < s.size() && (s[i] == 'e' || s[i] == 'E')) {
        i++;
        if (i < s.size() && (s[i] == '+' || s[i] == '-')) i++;
        size_t exp_digits = 0;
        while (i < s.size() && s[i] >= '0' && s[i] <= '9') {
            i++;
            exp_digits++;
        }
        if (exp_digits == 0) return false;
    }
    return i == s.size();
}

bool valid_name(std::string_view s) {
    if (s.empty()) return false;
    for (char c : s) {
        if (!((c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
              (c >= '0' && c <= '9') || c == '-' || c == '_' ||
              c == '.' || c == '/'))
            return false;
    }
    return true;
}

void split_words(std::string_view line, std::vector<std::string_view>* out) {
    out->clear();
    size_t i = 0;
    while (i < line.size()) {
        while (i < line.size() && is_space(line[i])) i++;
        size_t start = i;
        while (i < line.size() && !is_space(line[i])) i++;
        if (i > start) out->push_back(line.substr(start, i - start));
    }
}

void parse_line(std::string_view line, Arena* a,
                std::vector<std::string_view>* words,
                std::vector<std::pair<std::string_view,
                                      std::string_view>>* tags) {
    split_words(line, words);
    if (words->empty()) return;
    if ((*words)[0] != "put") {
        a->errors.push_back("unknown command: " +
                            std::string((*words)[0]));
        return;
    }
    if (words->size() < 5) {
        a->errors.push_back("not enough arguments: " + std::string(line));
        return;
    }
    std::string_view metric = (*words)[1];
    if (!valid_name(metric)) {
        a->errors.push_back("invalid metric: " + std::string(metric));
        return;
    }
    int64_t ts;
    if (!parse_i64((*words)[2], &ts) || ts <= 0 ||
        (uint64_t)ts > 0xFFFFFFFFull) {
        a->errors.push_back("invalid timestamp: " +
                            std::string((*words)[2]));
        return;
    }
    std::string_view value = (*words)[3];

    tags->clear();
    for (size_t w = 4; w < words->size(); w++) {
        std::string_view t = (*words)[w];
        size_t eq = t.find('=');
        if (eq == std::string_view::npos || eq == 0 ||
            eq == t.size() - 1) {
            a->errors.push_back("invalid tag: " + std::string(t));
            return;
        }
        std::string_view k = t.substr(0, eq), v = t.substr(eq + 1);
        if (!valid_name(k) || !valid_name(v)) {
            a->errors.push_back("invalid tag: " + std::string(t));
            return;
        }
        tags->emplace_back(k, v);
    }
    std::sort(tags->begin(), tags->end());
    for (size_t i = 1; i < tags->size(); i++) {
        if ((*tags)[i].first == (*tags)[i - 1].first) {
            if ((*tags)[i].second != (*tags)[i - 1].second) {
                a->errors.push_back("duplicate tag: " +
                                    std::string((*tags)[i].first));
                return;
            }
        }
    }

    double fval = 0;
    int64_t ival = 0;
    uint8_t isf;
    if (looks_like_integer(value)) {
        if (!parse_i64(value, &ival)) {
            a->errors.push_back("invalid value: " + std::string(value));
            return;
        }
        fval = (double)ival;
        isf = 0;
    } else {
        // Strict decimal grammar, matching the Python fallback exactly:
        // [+-]?(digits[.digits*] | .digits)[eE[+-]digits]. No hex, no
        // underscores, no nan/inf. std::from_chars is locale-independent
        // (strtod is not).
        if (!strict_float_grammar(value)) {
            a->errors.push_back("invalid value: " + std::string(value));
            return;
        }
        std::string_view num = value;
        bool neg = false;
        if (!num.empty() && (num[0] == '+' || num[0] == '-')) {
            neg = num[0] == '-';
            num.remove_prefix(1);
        }
        auto res = std::from_chars(num.data(), num.data() + num.size(),
                                   fval);
        if (res.ec != std::errc() || res.ptr != num.data() + num.size() ||
            fval != fval || fval == __builtin_inf()) {
            a->errors.push_back("invalid value: " + std::string(value));
            return;
        }
        if (neg) fval = -fval;
        isf = 1;
    }

    // Canonical series name: "metric k=v k=v" with sorted, deduped tags.
    std::string canon(metric);
    std::string_view last_k;
    for (auto& kv : *tags) {
        if (kv.first == last_k) continue;
        last_k = kv.first;
        canon.push_back(' ');
        canon.append(kv.first);
        canon.push_back('=');
        canon.append(kv.second);
    }
    int32_t sid;
    auto it = a->series_ids.find(canon);
    if (it == a->series_ids.end()) {
        sid = (int32_t)a->series.size();
        a->series_ids.emplace(canon, sid);
        a->series.push_back(std::move(canon));
    } else {
        sid = it->second;
    }

    a->timestamps.push_back(ts);
    a->fvalues.push_back(fval);
    a->ivalues.push_back(ival);
    a->is_float.push_back(isf);
    a->sid.push_back(sid);
}

}  // namespace

extern "C" {

// Parse every complete line in buf[0..len). Returns an opaque arena.
// Incomplete trailing data (no '\n') is left unconsumed; query the
// consumed byte count to carry the remainder into the next call.
void* tsd_parse(const char* buf, size_t len) {
    Arena* a = new Arena();
    std::vector<std::string_view> words;
    std::vector<std::pair<std::string_view, std::string_view>> tags;
    size_t start = 0;
    while (start < len) {
        const char* nl = (const char*)memchr(buf + start, '\n',
                                             len - start);
        if (!nl) break;
        size_t end = nl - buf;
        size_t line_end = end;
        if (line_end > start && buf[line_end - 1] == '\r') line_end--;
        parse_line(std::string_view(buf + start, line_end - start), a,
                   &words, &tags);
        start = end + 1;
    }
    a->consumed = start;
    return a;
}

size_t tsd_npoints(void* arena) {
    return ((Arena*)arena)->timestamps.size();
}
size_t tsd_nseries(void* arena) {
    return ((Arena*)arena)->series.size();
}
size_t tsd_nerrors(void* arena) {
    return ((Arena*)arena)->errors.size();
}
size_t tsd_consumed(void* arena) {
    return ((Arena*)arena)->consumed;
}

// Copy columnar results into caller-provided buffers (sized npoints).
void tsd_copy_points(void* arena, int64_t* ts, double* fvals,
                     int64_t* ivals, uint8_t* is_float, int32_t* sid) {
    Arena* a = (Arena*)arena;
    size_t n = a->timestamps.size();
    memcpy(ts, a->timestamps.data(), n * sizeof(int64_t));
    memcpy(fvals, a->fvalues.data(), n * sizeof(double));
    memcpy(ivals, a->ivalues.data(), n * sizeof(int64_t));
    memcpy(is_float, a->is_float.data(), n * sizeof(uint8_t));
    memcpy(sid, a->sid.data(), n * sizeof(int32_t));
}

const char* tsd_series_name(void* arena, size_t i) {
    Arena* a = (Arena*)arena;
    return i < a->series.size() ? a->series[i].c_str() : "";
}

const char* tsd_error(void* arena, size_t i) {
    Arena* a = (Arena*)arena;
    return i < a->errors.size() ? a->errors[i].c_str() : "";
}

void tsd_free(void* arena) { delete (Arena*)arena; }

}  // extern "C"
