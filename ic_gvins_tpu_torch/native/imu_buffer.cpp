// Native host runtime: IMU ring buffer with time-ordered slice extraction.
//
// This is the host-side hot path of the engine (200 Hz ingest + one slice
// per time node), the host-side equivalent of the reference's in-memory
// IMU window management (ic_gvins.cc:188-218 ingest with gap repair,
// misc.cc:286-384 interpolation/slicing). The device never sees this code;
// it fills padded fixed-shape buffers that feed the preintegration and
// mechanization scans.
//
// C API (ctypes-friendly); all doubles, row-major [n][3] arrays.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct ImuSample {
    double time;
    double dt;
    double dtheta[3];
    double dvel[3];
};

struct ImuBuffer {
    std::vector<ImuSample> samples;  // time-ordered
    double nominal_dt = 0.005;
};

}  // namespace

extern "C" {

void* imu_buffer_create(double nominal_dt) {
    auto* b = new ImuBuffer();
    b->nominal_dt = nominal_dt;
    return b;
}

void imu_buffer_destroy(void* h) { delete static_cast<ImuBuffer*>(h); }

int64_t imu_buffer_size(void* h) {
    return static_cast<int64_t>(static_cast<ImuBuffer*>(h)->samples.size());
}

// Append one increment sample. Repairs gaps by repeating the last sample at
// nominal dt (parity ic_gvins.cc:191-203). Returns number of samples added.
int64_t imu_buffer_append(void* h, double time, double dt, const double* dtheta,
                          const double* dvel) {
    auto* b = static_cast<ImuBuffer*>(h);
    int64_t added = 0;
    if (!b->samples.empty()) {
        const ImuSample& last = b->samples.back();
        double gap = time - last.time;
        // fill lost samples with copies of the last one at nominal rate
        while (gap > 1.5 * b->nominal_dt + dt) {
            ImuSample fill = last;
            fill.time = last.time + b->nominal_dt * (added + 1);
            fill.dt = b->nominal_dt;
            b->samples.push_back(fill);
            gap -= b->nominal_dt;
            ++added;
        }
    }
    ImuSample s;
    s.time = time;
    s.dt = dt;
    std::memcpy(s.dtheta, dtheta, sizeof s.dtheta);
    std::memcpy(s.dvel, dvel, sizeof s.dvel);
    b->samples.push_back(s);
    return added + 1;
}

// Export all stored samples (for checkpointing). Returns the number of
// samples written, or -1 if max_n is too small.
int64_t imu_buffer_export(void* h, int64_t max_n, double* out_time,
                          double* out_dt, double* out_dtheta,
                          double* out_dvel) {
    auto* b = static_cast<ImuBuffer*>(h);
    int64_t n = static_cast<int64_t>(b->samples.size());
    if (n > max_n) return -1;
    for (int64_t i = 0; i < n; ++i) {
        const ImuSample& s = b->samples[i];
        out_time[i] = s.time;
        out_dt[i] = s.dt;
        std::memcpy(out_dtheta + 3 * i, s.dtheta, sizeof s.dtheta);
        std::memcpy(out_dvel + 3 * i, s.dvel, sizeof s.dvel);
    }
    return n;
}

void imu_buffer_drop_before(void* h, double t) {
    auto* b = static_cast<ImuBuffer*>(h);
    auto it = std::lower_bound(
        b->samples.begin(), b->samples.end(), t,
        [](const ImuSample& s, double v) { return s.time < v; });
    // keep one predecessor for coning terms
    if (it != b->samples.begin()) --it;
    b->samples.erase(b->samples.begin(), it);
}

double imu_buffer_last_time(void* h) {
    auto* b = static_cast<ImuBuffer*>(h);
    return b->samples.empty() ? -1.0 : b->samples.back().time;
}

// Extract the padded series covering (t0, t1]: leading zero seed at t0,
// boundary interpolation (misc.cc:311-328), zero padding to n_pad.
// out_* arrays must hold n_pad entries (out_time/out_dt: n_pad doubles,
// out_dtheta/out_dvel: n_pad*3). Returns the number of real samples
// (including the seed), or -1 if n_pad is too small.
int64_t imu_buffer_slice(void* h, double t0, double t1, int64_t n_pad,
                         double min_dt, double* out_time, double* out_dt,
                         double* out_dtheta, double* out_dvel) {
    auto* b = static_cast<ImuBuffer*>(h);
    const auto& v = b->samples;

    int64_t n = 0;
    auto push = [&](double t, double dt, const double* th, const double* dv) {
        if (n >= n_pad) return false;
        out_time[n] = t;
        out_dt[n] = dt;
        std::memcpy(out_dtheta + 3 * n, th, 3 * sizeof(double));
        std::memcpy(out_dvel + 3 * n, dv, 3 * sizeof(double));
        ++n;
        return true;
    };

    const double zero3[3] = {0, 0, 0};
    if (!push(t0, 0.0, zero3, zero3)) return -1;

    auto lo = std::lower_bound(
        v.begin(), v.end(), t0 + min_dt,
        [](const ImuSample& s, double val) { return s.time < val; });
    for (auto it = lo; it != v.end() && it->time <= t1 + min_dt; ++it) {
        double frac_head = 1.0, frac_tail = 1.0;
        double t_start = it->time - it->dt;
        double t_lo = t_start, t_hi = it->time;
        // clip the increment interval to (t0, t1]
        if (t_start < t0 - min_dt) {
            frac_head = (it->time - t0) / it->dt;
            t_lo = t0;
        }
        double t_end = std::min(it->time, t1);
        if (it->time > t1 + min_dt) {
            frac_tail = (t1 - t_start) / it->dt;
            t_hi = t1;
        }
        double frac = std::min(frac_head, frac_tail);
        if (frac <= 0) continue;
        double th[3], dv[3];
        for (int k = 0; k < 3; ++k) {
            th[k] = it->dtheta[k] * frac;
            dv[k] = it->dvel[k] * frac;
        }
        if (!push(t_hi, t_hi - t_lo, th, dv)) return -1;
    }
    // handle a tail increment crossing t1 when the loop exited before it
    auto hi = std::lower_bound(
        v.begin(), v.end(), t1 + min_dt,
        [](const ImuSample& s, double val) { return s.time < val; });
    if (hi != v.end() && hi->time > t1 + min_dt) {
        double t_start = hi->time - hi->dt;
        if (t_start < t1 - min_dt && t_start >= t0 - min_dt) {
            double frac = (t1 - t_start) / hi->dt;
            double th[3], dv[3];
            for (int k = 0; k < 3; ++k) {
                th[k] = hi->dtheta[k] * frac;
                dv[k] = hi->dvel[k] * frac;
            }
            if (!push(t1, t1 - t_start, th, dv)) return -1;
        }
    }
    out_time[n - 1] = t1;  // stamp the end exactly (misc.cc:381)

    // zero-pad (a dt == 0 sample is a no-op of every scan kernel)
    for (int64_t k = n; k < n_pad; ++k) {
        out_time[k] = t1;
        out_dt[k] = 0.0;
        std::memset(out_dtheta + 3 * k, 0, 3 * sizeof(double));
        std::memset(out_dvel + 3 * k, 0, 3 * sizeof(double));
    }
    return n;
}

}  // extern "C"
