// Native host runtime: fast numeric table parser for dataset ingest.
//
// The host-side equivalent of the reference's sensor ingest path (the ROS
// callbacks fusion_ros.cc:130-249 deserialize rosbag messages in C++).
// This environment replays KAIST-layout CSV exports instead
// (data/kaist.py); a 2000 s urban sequence is ~400k IMU rows x 17 cols,
// which np.loadtxt parses in tens of seconds — this streaming strtod
// parser does it in a fraction of one.
//
// Handles ',' / whitespace delimiters, '#' comments, CRLF, ragged trailing
// blanks. Two-call protocol: csv_scan sizes the table, csv_load fills a
// caller-allocated row-major buffer.
//
// C API (ctypes-friendly).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

// Read an entire file into a string (with one NUL terminator for strtod).
bool read_file(const char* path, std::string& out) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    std::fseek(f, 0, SEEK_END);
    long n = std::ftell(f);
    if (n < 0) {
        std::fclose(f);
        return false;
    }
    std::fseek(f, 0, SEEK_SET);
    out.resize(static_cast<size_t>(n));
    size_t got = n ? std::fread(&out[0], 1, static_cast<size_t>(n), f) : 0;
    std::fclose(f);
    return got == static_cast<size_t>(n);
}

// Parse one line's numbers into vals (cap = capacity, 0 = just count).
// Returns the count; delimiters are ',', ' ', '\t', ';'.
int64_t parse_line(const char* p, const char* end, double* vals, int64_t cap) {
    int64_t c = 0;
    while (p < end) {
        while (p < end && (*p == ',' || *p == ' ' || *p == '\t' ||
                           *p == ';' || *p == '\r'))
            ++p;
        if (p >= end || *p == '#') break;
        char* next = nullptr;
        double v = std::strtod(p, &next);
        if (next == p) break;  // non-numeric token: stop this line
        if (vals && c < cap) vals[c] = v;
        ++c;
        p = next;
    }
    return c;
}

}  // namespace

extern "C" {

// Scan the file: *rows = numeric row count, *cols = column count of the
// first numeric row. Returns 0 on success, -1 on IO error, -2 on ragged
// rows (a row whose count differs from *cols).
int csv_scan(const char* path, int64_t* rows, int64_t* cols) {
    std::string buf;
    if (!read_file(path, buf)) return -1;
    *rows = 0;
    *cols = 0;
    const char* p = buf.data();
    const char* end = p + buf.size();
    while (p < end) {
        const char* nl = static_cast<const char*>(
            std::memchr(p, '\n', static_cast<size_t>(end - p)));
        const char* le = nl ? nl : end;
        int64_t c = parse_line(p, le, nullptr, 0);
        if (c > 0) {
            if (*cols == 0)
                *cols = c;
            else if (c != *cols)
                return -2;
            ++*rows;
        }
        p = nl ? nl + 1 : end;
    }
    return 0;
}

// Fill out (row-major [rows][cols], as sized by csv_scan). Returns rows
// stored, or negative on error/shape mismatch.
int64_t csv_load(const char* path, double* out, int64_t rows, int64_t cols) {
    std::string buf;
    if (!read_file(path, buf)) return -1;
    const char* p = buf.data();
    const char* end = p + buf.size();
    int64_t r = 0;
    while (p < end && r < rows) {
        const char* nl = static_cast<const char*>(
            std::memchr(p, '\n', static_cast<size_t>(end - p)));
        const char* le = nl ? nl : end;
        int64_t c = parse_line(p, le, out + r * cols, cols);
        if (c > 0) {
            if (c != cols) return -2;
            ++r;
        }
        p = nl ? nl + 1 : end;
    }
    return r;
}

}  // extern "C"
