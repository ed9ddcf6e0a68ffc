// Native host runtime: columnar result-file writer/reader.
//
// The host-side equivalent of the reference's fileio layer
// (filesaver.{h,cc}:51-66 TEXT/BINARY row writers, fileloader.{h,cc}
// readers, filebase.h mode constants). The engine streams fixed-width rows
// of doubles at IMU rate (nav output, IMU_ERR.bin) and per keyframe
// (statistics, trajectory); this keeps that host IO off the Python
// interpreter. Formats are byte-compatible with the Python classes of
// engine/fileio.py: TEXT rows are space-separated "%.9f", BINARY rows
// packed little-endian float64.
//
// C API (ctypes-friendly).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kText = 0;
constexpr int kBinary = 1;

struct FileSaver {
    FILE* f = nullptr;
    int64_t columns = 0;
    int mode = kText;
    std::vector<char> linebuf;  // reused TEXT formatting buffer
};

struct FileLoader {
    FILE* f = nullptr;
    int64_t columns = 0;
    int mode = kText;
};

}  // namespace

extern "C" {

// ---- writer ----

void* filesaver_create(const char* path, int64_t columns, int mode) {
    if (columns <= 0 || (mode != kText && mode != kBinary)) return nullptr;
    FILE* f = std::fopen(path, mode == kText ? "w" : "wb");
    if (!f) return nullptr;
    auto* s = new FileSaver();
    s->f = f;
    s->columns = columns;
    s->mode = mode;
    // worst-case "%.9f" of a double is ~330 chars; pad generously
    s->linebuf.resize(static_cast<size_t>(columns) * 352 + 2);
    return s;
}

// Returns rows written (n) or -1 on error. data is row-major [n][columns].
int64_t filesaver_dumpn(void* handle, const double* data, int64_t n) {
    auto* s = static_cast<FileSaver*>(handle);
    if (!s || !s->f || n < 0) return -1;
    if (s->mode == kBinary) {
        size_t total = static_cast<size_t>(n) * s->columns;
        if (total && std::fwrite(data, sizeof(double), total, s->f) != total)
            return -1;
        return n;
    }
    for (int64_t r = 0; r < n; ++r) {
        char* p = s->linebuf.data();
        char* end = p + s->linebuf.size();
        for (int64_t c = 0; c < s->columns; ++c) {
            int k = std::snprintf(p, end - p, c ? " %.9f" : "%.9f",
                                  data[r * s->columns + c]);
            if (k < 0 || p + k >= end) return -1;
            p += k;
        }
        *p++ = '\n';
        size_t len = p - s->linebuf.data();
        if (std::fwrite(s->linebuf.data(), 1, len, s->f) != len) return -1;
    }
    return n;
}

int filesaver_flush(void* handle) {
    auto* s = static_cast<FileSaver*>(handle);
    if (!s || !s->f) return -1;
    return std::fflush(s->f);
}

void filesaver_close(void* handle) {
    auto* s = static_cast<FileSaver*>(handle);
    if (!s) return;
    if (s->f) std::fclose(s->f);
    delete s;
}

// ---- reader ----

void* fileloader_open(const char* path, int64_t columns, int mode) {
    if (columns <= 0 || (mode != kText && mode != kBinary)) return nullptr;
    FILE* f = std::fopen(path, mode == kText ? "r" : "rb");
    if (!f) return nullptr;
    auto* l = new FileLoader();
    l->f = f;
    l->columns = columns;
    l->mode = mode;
    return l;
}

// Reads up to max_rows rows into out (row-major). Returns rows read,
// or -1 on a malformed row (wrong column count).
int64_t fileloader_read(void* handle, double* out, int64_t max_rows) {
    auto* l = static_cast<FileLoader*>(handle);
    if (!l || !l->f || max_rows < 0) return -1;
    if (l->mode == kBinary) {
        size_t want = static_cast<size_t>(max_rows) * l->columns;
        size_t got = want ? std::fread(out, sizeof(double), want, l->f) : 0;
        return static_cast<int64_t>(got / l->columns);  // drop partial rows
    }
    int64_t rows = 0;
    std::string line;
    int ch;
    while (rows < max_rows) {
        line.clear();
        while ((ch = std::fgetc(l->f)) != EOF && ch != '\n')
            line.push_back(static_cast<char>(ch));
        if (line.empty() && ch == EOF) break;
        // strip '#' comments (parity with engine/fileio.py)
        size_t hash = line.find('#');
        if (hash != std::string::npos) line.resize(hash);
        const char* p = line.c_str();
        int64_t c = 0;
        while (true) {
            char* next = nullptr;
            double v = std::strtod(p, &next);
            if (next == p) break;  // no more numbers
            if (c >= l->columns) return -1;
            out[rows * l->columns + c++] = v;
            p = next;
        }
        if (c == 0) {
            if (ch == EOF) break;
            continue;  // blank/comment-only line
        }
        if (c != l->columns) return -1;
        ++rows;
        if (ch == EOF) break;
    }
    return rows;
}

void fileloader_close(void* handle) {
    auto* l = static_cast<FileLoader*>(handle);
    if (!l) return;
    if (l->f) std::fclose(l->f);
    delete l;
}

}  // extern "C"
