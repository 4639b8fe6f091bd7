// Host-side pixel-track machinery of the PyTorch port: a copy of
// tclight_tpu/native/flowid.cpp, so that both packages number tracks the
// same way. Flow-id propagation (the frame-sequential loop of
// ops/flow.py:get_flowid), unique + inverse over track ids, and a
// per-track scatter-mean.
//
// Built with g++ at first use by tclight_torch/native/__init__.py into
// build/tclight_torch/; plain C functions over raw pointers, bound with
// ctypes.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>
#include <numeric>

extern "C" {

// Propagate integer track ids along forward flow.
//   frames:    N*H*W*C float32 RGB in [0,1]
//   flows:     N*H*W*2 float32 (dx, dy); flows[i] maps frame i -> i+1
//   masks:     N*H*W float32 backward-consistency masks (frame i vs i-1)
//   ids_out:   N*H*W int32 output
// Returns the total number of ids assigned.
int64_t tcl_flowid_propagate(
    const float* frames, const float* flows, const float* masks,
    int32_t* ids_out,
    int64_t n, int64_t h, int64_t w, int64_t c,
    float rgb_threshold)
{
    const int64_t hw = h * w;

    // frame 0: identity ids
    for (int64_t p = 0; p < hw; ++p) ids_out[p] = static_cast<int32_t>(p);
    int64_t last_id = hw;

    // global max for the photometric cutoff (reference: frames.max())
    float fmax = 0.f;
    {
        const int64_t total = n * hw * c;
        for (int64_t i = 0; i < total; ++i) fmax = std::max(fmax, frames[i]);
    }
    const float diff_threshold = fmax * rgb_threshold;

    std::vector<int32_t> cur(hw);
    for (int64_t t = 1; t < n; ++t) {
        std::fill(cur.begin(), cur.end(), -1);
        const float* flow_prev = flows + (t - 1) * hw * 2;
        const float* frame_prev = frames + (t - 1) * hw * c;
        const float* frame_cur = frames + t * hw * c;
        const float* mask_cur = masks + t * hw;
        const int32_t* prev_ids = ids_out + (t - 1) * hw;

        for (int64_t y = 0; y < h; ++y) {
            for (int64_t x = 0; x < w; ++x) {
                const int64_t p = y * w + x;
                const int64_t tx = static_cast<int64_t>(
                    std::lround(static_cast<double>(x) + flow_prev[p * 2 + 0]));
                const int64_t ty = static_cast<int64_t>(
                    std::lround(static_cast<double>(y) + flow_prev[p * 2 + 1]));
                if (tx < 0 || tx >= w || ty < 0 || ty >= h) continue;
                const int64_t q = ty * w + tx;
                // reference masks at the *source* grid position
                if (mask_cur[p] <= 0.5f) continue;
                // photometric cutoff: target color vs source color
                float maxdiff = 0.f;
                for (int64_t ch = 0; ch < c; ++ch) {
                    const float d = std::fabs(
                        frame_cur[q * c + ch] - frame_prev[p * c + ch]);
                    maxdiff = std::max(maxdiff, d);
                }
                if (maxdiff >= diff_threshold) continue;
                cur[q] = prev_ids[p];  // duplicates: last write wins
            }
        }
        int32_t* out = ids_out + t * hw;
        for (int64_t p = 0; p < hw; ++p) {
            if (cur[p] < 0) {
                out[p] = static_cast<int32_t>(last_id++);
            } else {
                out[p] = cur[p];
            }
        }
    }
    return last_id;
}

// Unique + inverse over int32 ids: inv_out[i] = rank of ids[i] among the
// sorted unique values. Returns the number of unique values.
int64_t tcl_unique_inverse(
    const int32_t* ids, int32_t* inv_out, int64_t count)
{
    std::vector<int64_t> order(count);
    std::iota(order.begin(), order.end(), 0);
    std::sort(order.begin(), order.end(),
              [&](int64_t a, int64_t b) { return ids[a] < ids[b]; });
    int64_t n_unique = 0;
    int32_t prev = 0;
    bool first = true;
    for (int64_t i = 0; i < count; ++i) {
        const int64_t idx = order[i];
        if (first || ids[idx] != prev) {
            prev = ids[idx];
            first = false;
            ++n_unique;
        }
        inv_out[idx] = static_cast<int32_t>(n_unique - 1);
    }
    return n_unique;
}

// Per-track scatter-mean of colors: out[track] = mean of vals over pixels
// with inv == track. vals: count*c; out: n_unique*c (pre-zeroed by caller
// or here).
void tcl_segment_mean(
    const float* vals, const int32_t* inv, float* out,
    int64_t count, int64_t c, int64_t n_unique)
{
    std::vector<int64_t> cnt(n_unique, 0);
    std::memset(out, 0, sizeof(float) * n_unique * c);
    for (int64_t i = 0; i < count; ++i) {
        const int32_t t = inv[i];
        ++cnt[t];
        for (int64_t ch = 0; ch < c; ++ch) out[t * c + ch] += vals[i * c + ch];
    }
    for (int64_t t = 0; t < n_unique; ++t) {
        const float d = cnt[t] > 0 ? static_cast<float>(cnt[t]) : 1.f;
        for (int64_t ch = 0; ch < c; ++ch) out[t * c + ch] /= d;
    }
}

}  // extern "C"
