// fastgraph: native host-side data plumbing for smore-tpu.
//
// Covers the host-bound pieces the reference implements in C++ and that
// are too slow in pure Python at millions-of-edges scale:
//   - edge-list parsing + string interning + CSR construction
//     (role of proNet::LoadEdgeList + the 30M-slot hash,
//      /root/reference/src/proNet.cpp:41-236 — re-implemented from
//      scratch around std::unordered_map + a custom tokenizer)
//   - Walker/Vose alias-table construction, flat and CSR-segmented
//     (role of proNet::AliasMethod, proNet.cpp:544-620)
//
// Exposed as a C ABI consumed via ctypes (see fastgraph.py). All compute
// stays on the device; this file is strictly load-time data preparation.

#include <charconv>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <string>
#include <vector>
#include <unordered_map>

namespace {

struct EdgeListHandle {
    std::vector<int64_t> indptr;
    std::vector<int32_t> indices;
    std::vector<double> weights;
    std::vector<double> out_degree;
    std::vector<double> in_degree;
    std::string names;      // '\0'-joined vertex names
    int64_t n_vertices = 0;
    int64_t n_edges = 0;
};

// Parse "src dst [weight]" lines from one file into parallel edge arrays,
// interning names on the fly.
static void parse_file(const char* path, bool undirected,
                       std::unordered_map<std::string, int64_t>& name2id,
                       std::vector<std::string>& names,
                       std::vector<int64_t>& src, std::vector<int64_t>& dst,
                       std::vector<double>& w) {
    FILE* f = fopen(path, "rb");
    if (!f) return;
    // Read whole file (edge lists are at most a few GB; stream in chunks).
    const size_t CHUNK = 1 << 24;
    std::string buf;
    buf.reserve(CHUNK + 256);
    std::string carry;
    std::vector<char> tmp(CHUNK);
    auto intern = [&](const char* s, size_t len) -> int64_t {
        std::string key(s, len);
        auto it = name2id.find(key);
        if (it != name2id.end()) return it->second;
        int64_t id = (int64_t)names.size();
        name2id.emplace(std::move(key), id);
        names.emplace_back(s, len);
        return id;
    };
    auto process_line = [&](char* line, char* end) {
        // tokenize on whitespace
        char* p = line;
        auto skip_ws = [&]() { while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p; };
        auto token = [&](char*& t0, size_t& tl) -> bool {
            skip_ws();
            if (p >= end) return false;
            t0 = p;
            while (p < end && *p != ' ' && *p != '\t' && *p != '\r') ++p;
            tl = (size_t)(p - t0);
            return tl > 0;
        };
        char *a, *b, *c;
        size_t la, lb, lc;
        if (!token(a, la)) return;          // blank line
        if (!token(b, lb)) return;          // malformed: single token
        double weight = 1.0;
        if (token(c, lc)) {
            char save = c[lc];
            c[lc] = '\0';
            char* endp = nullptr;
            weight = strtod(c, &endp);
            c[lc] = save;
            if (endp != c + lc) return;     // malformed weight -> skip line
        }
        int64_t ia = intern(a, la);
        int64_t ib = intern(b, lb);
        src.push_back(ia); dst.push_back(ib); w.push_back(weight);
        if (undirected) { src.push_back(ib); dst.push_back(ia); w.push_back(weight); }
    };

    while (true) {
        size_t got = fread(tmp.data(), 1, CHUNK, f);
        if (got == 0) break;
        size_t start = 0;
        for (size_t i = 0; i < got; ++i) {
            if (tmp[i] == '\n') {
                if (!carry.empty()) {
                    carry.append(tmp.data() + start, i - start);
                    process_line(&carry[0], &carry[0] + carry.size());
                    carry.clear();
                } else {
                    process_line(tmp.data() + start, tmp.data() + i);
                }
                start = i + 1;
            }
        }
        if (start < got) carry.append(tmp.data() + start, got - start);
    }
    if (!carry.empty()) process_line(&carry[0], &carry[0] + carry.size());
    fclose(f);
}

}  // namespace

extern "C" {

// paths: '\n'-separated list of files.
void* fg_load_edgelist(const char* paths, int undirected, int /*reserved*/) {
    std::unordered_map<std::string, int64_t> name2id;
    std::vector<std::string> names;
    std::vector<int64_t> src, dst;
    std::vector<double> w;

    const char* p = paths;
    while (*p) {
        const char* q = strchr(p, '\n');
        size_t len = q ? (size_t)(q - p) : strlen(p);
        std::string path(p, len);
        if (!path.empty()) {
            parse_file(path.c_str(), undirected != 0, name2id, names, src, dst, w);
        }
        if (!q) break;
        p = q + 1;
    }

    auto* h = new EdgeListHandle();
    int64_t n = (int64_t)names.size();
    int64_t e = (int64_t)src.size();
    h->n_vertices = n;
    h->n_edges = e;

    // counting-sort by src into CSR (stable, one pass)
    std::vector<int64_t> counts(n + 1, 0);
    for (int64_t i = 0; i < e; ++i) counts[src[i] + 1]++;
    for (int64_t v = 0; v < n; ++v) counts[v + 1] += counts[v];
    h->indptr = counts;  // copy of prefix sums = final indptr
    std::vector<int64_t> cursor(counts.begin(), counts.end() - 1);
    h->indices.resize(e);
    h->weights.resize(e);
    h->out_degree.assign(n, 0.0);
    h->in_degree.assign(n, 0.0);
    for (int64_t i = 0; i < e; ++i) {
        int64_t pos = cursor[src[i]]++;
        h->indices[pos] = (int32_t)dst[i];
        h->weights[pos] = w[i];
        h->out_degree[src[i]] += w[i];
        h->in_degree[dst[i]] += w[i];
    }

    size_t total = 0;
    for (auto& s : names) total += s.size() + 1;
    h->names.reserve(total);
    for (auto& s : names) { h->names += s; h->names += '\0'; }
    return h;
}

int64_t fg_n_vertices(void* h) { return ((EdgeListHandle*)h)->n_vertices; }
int64_t fg_n_edges(void* h) { return ((EdgeListHandle*)h)->n_edges; }
int64_t fg_names_size(void* h) { return (int64_t)((EdgeListHandle*)h)->names.size(); }

void fg_export(void* hv, int64_t* indptr, int32_t* indices, double* weights,
               double* out_degree, double* in_degree, char* names) {
    auto* h = (EdgeListHandle*)hv;
    memcpy(indptr, h->indptr.data(), sizeof(int64_t) * (h->n_vertices + 1));
    memcpy(indices, h->indices.data(), sizeof(int32_t) * h->n_edges);
    memcpy(weights, h->weights.data(), sizeof(double) * h->n_edges);
    memcpy(out_degree, h->out_degree.data(), sizeof(double) * h->n_vertices);
    memcpy(in_degree, h->in_degree.data(), sizeof(double) * h->n_vertices);
    memcpy(names, h->names.data(), h->names.size());
}

void fg_free(void* h) { delete (EdgeListHandle*)h; }

// Vose alias build over probabilities pre-scaled to mean 1.
// norm_prob is clobbered. alias[i] = -1 for prob==1 slots.
void fg_build_alias(double* norm_prob, int64_t n, double* prob, int64_t* alias) {
    std::vector<int64_t> small, large;
    small.reserve(n); large.reserve(n);
    for (int64_t i = 0; i < n; ++i) {
        prob[i] = 1.0;
        alias[i] = -1;
        if (norm_prob[i] < 1.0) small.push_back(i); else large.push_back(i);
    }
    while (!small.empty() && !large.empty()) {
        int64_t s = small.back(); small.pop_back();
        int64_t l = large.back(); large.pop_back();
        prob[s] = norm_prob[s];
        alias[s] = l;
        norm_prob[l] += norm_prob[s] - 1.0;
        if (norm_prob[l] < 1.0) small.push_back(l); else large.push_back(l);
    }
}

// Per-CSR-segment alias build over (weights^power); alias indices LOCAL to
// the segment. Matches the reference's concatenated per-vertex context
// tables (proNet.cpp:512-541).
void fg_build_alias_segmented(const double* weights, const int64_t* indptr,
                              int64_t nseg, double power,
                              double* prob, int64_t* alias) {
    std::vector<double> np_buf;
    std::vector<int64_t> small, large;
    for (int64_t v = 0; v < nseg; ++v) {
        int64_t lo = indptr[v], hi = indptr[v + 1];
        int64_t d = hi - lo;
        if (d <= 0) continue;
        np_buf.resize(d);
        double sum = 0.0;
        for (int64_t i = 0; i < d; ++i) {
            double x = weights[lo + i];
            np_buf[i] = (power == 1.0 || x <= 0.0) ? x : pow(x, power);
            sum += np_buf[i];
        }
        if (sum <= 0.0) {
            for (int64_t i = 0; i < d; ++i) { prob[lo + i] = 1.0; alias[lo + i] = -1; }
            continue;
        }
        double scale = (double)d / sum;
        small.clear(); large.clear();
        for (int64_t i = 0; i < d; ++i) {
            np_buf[i] *= scale;
            prob[lo + i] = 1.0;
            alias[lo + i] = -1;
            if (np_buf[i] < 1.0) small.push_back(i); else large.push_back(i);
        }
        while (!small.empty() && !large.empty()) {
            int64_t s = small.back(); small.pop_back();
            int64_t l = large.back(); large.pop_back();
            prob[lo + s] = np_buf[s];
            alias[lo + s] = l;
            np_buf[l] += np_buf[s] - 1.0;
            if (np_buf[l] < 1.0) small.push_back(l); else large.push_back(l);
        }
    }
}

// ------------------------- embedding text IO ---------------------------
// The reference dumps/loads embeddings as "N dim\nname v1..vd\n" from C++
// (SaveWeights e.g. src/model/LINE.cpp:13-47, LoadPreTrain
// src/proNet.cpp:238-286). A per-value Python format loop is ~40s at
// 1.1M x 64; these native paths bring save/warm-start to ~1-2s.

// Write the interchange text format with 6-significant-digit values.
// names_blob: '\0'-joined n names. Returns 0 on success, -1 on open error.
int fg_save_embeddings(const char* path, const char* names_blob,
                       const float* table, int64_t n, int64_t dim) {
    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    std::vector<char> iobuf(1 << 22);
    setvbuf(f, iobuf.data(), _IOFBF, iobuf.size());
    fprintf(f, "%lld %lld\n", (long long)n, (long long)dim);
    const char* nm = names_blob;
    std::vector<char> line;
    line.reserve(32 * (size_t)dim + 256);
    for (int64_t i = 0; i < n; ++i) {
        size_t nl = strlen(nm);
        line.assign(nm, nm + nl);
        nm += nl + 1;
        char buf[48];
        for (int64_t j = 0; j < dim; ++j) {
            // %.6g of the value promoted to double == the Python
            // fallback's f"{v:.6g}" on the same float32. Prefer
            // std::to_chars (~10x faster than snprintf) where the
            // floating-point overload exists (libstdc++ from GCC >= 11);
            // fall back to snprintf on older toolchains so the whole
            // native layer doesn't silently vanish there.
            buf[0] = ' ';
#if defined(__cpp_lib_to_chars) && __cpp_lib_to_chars >= 201611L
            auto r = std::to_chars(buf + 1, buf + sizeof buf,
                                   (double)table[i * dim + j],
                                   std::chars_format::general, 6);
            char* endp = r.ptr;
#else
            int len = snprintf(buf + 1, sizeof buf - 1, "%.6g",
                               (double)table[i * dim + j]);
            char* endp = buf + 1 + (len > 0 ? len : 0);
#endif
            line.insert(line.end(), buf, endp);
        }
        line.push_back('\n');
        fwrite(line.data(), 1, line.size(), f);
    }
    int rc = ferror(f) ? -1 : 0;
    fclose(f);
    return rc;
}

// Warm start (LoadPreTrain semantics): stream a saved model file and
// overwrite rows of table (n x dim float32) whose line-name matches a
// caller name; lines whose value count != dim are skipped. Returns the
// number of rows overwritten, or -1 on open error.
int64_t fg_warm_start(const char* path, const char* names_blob, int64_t n,
                      int64_t dim, float* table) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    // Map each name to EVERY row bearing it, so duplicate names all get
    // overwritten — matching the Python fallback, which walks all rows.
    std::unordered_map<std::string, std::vector<int64_t>> idx;
    idx.reserve((size_t)n * 2);
    const char* nm = names_blob;
    for (int64_t i = 0; i < n; ++i) {
        size_t nl = strlen(nm);
        idx[std::string(nm, nl)].push_back(i);
        nm += nl + 1;
    }
    int64_t matched = 0;
    bool first = true;  // header line
    std::vector<float> vals((size_t)dim);
    auto process_line = [&](char* line, char* end) {
        if (first) { first = false; return; }  // "N dim" header
        char* p = line;
        auto skip_ws = [&]() { while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p; };
        skip_ws();
        if (p >= end) return;
        char* t0 = p;
        while (p < end && *p != ' ' && *p != '\t' && *p != '\r') ++p;
        auto it = idx.find(std::string(t0, (size_t)(p - t0)));
        int64_t cnt = 0;
        bool ok = true;
        while (true) {
            skip_ws();
            if (p >= end) break;
            char* v0 = p;
            while (p < end && *p != ' ' && *p != '\t' && *p != '\r') ++p;
            if (cnt >= dim) { ok = false; break; }  // too many values
            char save = *p;  // end points one past the buffer's last char
            *p = '\0';
            char* endp = nullptr;
            float v = strtof(v0, &endp);
            *p = save;
            if (endp != p) { ok = false; break; }
            vals[(size_t)cnt++] = v;
        }
        if (!ok || cnt != dim) return;  // dim mismatch -> skip (proNet.cpp:262)
        if (it == idx.end()) return;
        for (int64_t row : it->second) {
            memcpy(table + row * dim, vals.data(), sizeof(float) * (size_t)dim);
            ++matched;
        }
    };
    const size_t CHUNK = 1 << 24;
    std::vector<char> tmp(CHUNK + 1);
    std::string carry;
    while (true) {
        size_t got = fread(tmp.data(), 1, CHUNK, f);
        if (got == 0) break;
        size_t start = 0;
        for (size_t i = 0; i < got; ++i) {
            if (tmp[i] == '\n') {
                if (!carry.empty()) {
                    carry.append(tmp.data() + start, i - start);
                    carry.push_back('\0');
                    process_line(&carry[0], &carry[0] + carry.size() - 1);
                    carry.clear();
                } else {
                    tmp[i] = '\0';
                    process_line(tmp.data() + start, tmp.data() + i);
                }
                start = i + 1;
            }
        }
        if (start < got) carry.append(tmp.data() + start, got - start);
    }
    if (!carry.empty()) {
        carry.push_back('\0');
        process_line(&carry[0], &carry[0] + carry.size() - 1);
    }
    fclose(f);
    return matched;
}

}  // extern "C"
