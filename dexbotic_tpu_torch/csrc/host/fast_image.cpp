// Fused image preprocessing for the host data path: batched uint8 HWC RGB ->
// pad-to-square + resample + rescale + normalize float32 HWC, multi-threaded.
//
// The reference leans on native third-party decode/aug (decord, cv2,
// albumentations; SURVEY.md §2.9 item 5) and preprocesses frames with HF
// image processors, whose resize is PIL's filter-based resampler.  This is
// our own native component for the hottest host op in serving/training, and
// it matches PIL semantics exactly (ImagingResampleHorizontal/Vertical):
// separable two-pass filtering, bicubic a=-0.5 / triangle (bilinear)
// kernels, support scaled by the downscale factor (proper antialiasing, the
// thing cv2's fixed 4-tap INTER_CUBIC gets wrong on downscale), window
// clipped to the image and weights renormalized at the borders.
//
// interp: 0 = bilinear (PIL BILINEAR), 1 = bicubic (PIL BICUBIC).
//
// Built with:  g++ -O3 -march=native -shared -fPIC -o libfastimage.so fast_image.cpp -lpthread
// Exposed via ctypes (dexbotic_tpu/data/fast_image.py).

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <cmath>
#include <functional>
#include <thread>
#include <vector>

namespace {

inline float bicubic_w(float x) {  // PIL's bicubic filter, a = -0.5
    const float a = -0.5f;
    x = std::fabs(x);
    if (x < 1.f) return ((a + 2.f) * x - (a + 3.f)) * x * x + 1.f;
    if (x < 2.f) return (((x - 5.f) * x + 8.f) * x - 4.f) * a;
    return 0.f;
}

inline float bilinear_w(float x) {
    x = std::fabs(x);
    return x < 1.f ? 1.f - x : 0.f;
}

struct Taps {
    std::vector<int> bounds;   // [out_n * 2]: xmin, count
    std::vector<float> wt;     // [out_n * ksize]
    int ksize = 0;
};

// PIL precompute_coeffs: window = filter support scaled by the downscale
// factor, clipped to [0, in_n), weights normalized over the clipped window.
Taps make_taps(int out_n, int in_n, int interp) {
    const float support0 = interp == 1 ? 2.f : 1.f;
    const float scale = float(in_n) / float(out_n);
    const float filterscale = std::max(scale, 1.f);
    const float support = support0 * filterscale;
    Taps t;
    t.ksize = (int)std::ceil(support) * 2 + 1;
    t.bounds.resize((size_t)out_n * 2);
    t.wt.assign((size_t)out_n * t.ksize, 0.f);
    for (int x = 0; x < out_n; ++x) {
        const float center = (x + 0.5f) * scale;
        int xmin = (int)(center - support + 0.5f);
        if (xmin < 0) xmin = 0;
        int xmax = (int)(center + support + 0.5f);
        if (xmax > in_n) xmax = in_n;
        float* wp = t.wt.data() + (size_t)x * t.ksize;
        float total = 0.f;
        for (int k = 0; k < xmax - xmin; ++k) {
            const float w = interp == 1
                ? bicubic_w((xmin + k + 0.5f - center) / filterscale)
                : bilinear_w((xmin + k + 0.5f - center) / filterscale);
            wp[k] = w;
            total += w;
        }
        if (total != 0.f)
            for (int k = 0; k < xmax - xmin; ++k) wp[k] /= total;
        t.bounds[(size_t)x * 2] = xmin;
        t.bounds[(size_t)x * 2 + 1] = xmax - xmin;
    }
    return t;
}

// One image on a virtual canvas (side x side for the padded case, ih x iw
// otherwise): the original frame sits at offset (top, left); everything
// outside reads as `fill`.  Separable two-pass resample straight off the
// uint8 source (no padded intermediate), fused normalize on the second pass.
void preprocess_canvas(const uint8_t* src, int ih, int iw,
                       int ch, int cw, int top, int left, const uint8_t* fill,
                       float* dst, int oh, int ow,
                       const float* mean, const float* inv_std, int interp,
                       const Taps& tx, const Taps& ty, int swap_channels) {
    const float rescale = 1.0f / 255.0f;
    const float fillf[3] = {float(fill[0]), float(fill[1]), float(fill[2])};

    // pass 1: horizontal, canvas rows -> temp [ch, ow, 3].  The source row
    // is widened to float once (it is re-read ~ksize times by overlapping
    // windows), with the fill borders materialized, so the gather loop is
    // pure float FMAs.  swap_channels folds a BGR->RGB reorder into this
    // conversion (cv2.imdecode output) for free — fill/mean/std stay RGB.
    std::vector<float> temp((size_t)ch * ow * 3);
    std::vector<float> fillrow((size_t)ow * 3);
    for (int x = 0; x < ow; ++x)
        for (int c = 0; c < 3; ++c) fillrow[(size_t)x * 3 + c] = fillf[c];
    std::vector<float> frow((size_t)cw * 3);
    for (int x = 0; x < cw; ++x)
        for (int c = 0; c < 3; ++c)
            if (x < left || x >= left + iw) frow[(size_t)x * 3 + c] = fillf[c];
    for (int y = 0; y < ch; ++y) {
        float* trow = temp.data() + (size_t)y * ow * 3;
        if (y < top || y >= top + ih) {
            std::memcpy(trow, fillrow.data(), fillrow.size() * sizeof(float));
            continue;
        }
        const uint8_t* srow = src + (size_t)(y - top) * iw * 3;
        float* fr = frow.data() + (size_t)left * 3;
        if (swap_channels) {
            for (int x = 0; x < iw; ++x)
                for (int c = 0; c < 3; ++c)
                    fr[x * 3 + c] = srow[x * 3 + (2 - c)];
        } else {
            for (int j = 0; j < iw * 3; ++j) fr[j] = srow[j];
        }
        for (int x = 0; x < ow; ++x) {
            const int xmin = tx.bounds[(size_t)x * 2];
            const int cnt = tx.bounds[(size_t)x * 2 + 1];
            const float* wp = tx.wt.data() + (size_t)x * tx.ksize;
            const float* px = frow.data() + (size_t)xmin * 3;
            float a0 = 0.f, a1 = 0.f, a2 = 0.f;
            for (int k = 0; k < cnt; ++k) {
                const float w = wp[k];
                a0 += w * px[k * 3];
                a1 += w * px[k * 3 + 1];
                a2 += w * px[k * 3 + 2];
            }
            // PIL's horizontal pass rounds + saturates to uint8
            // (Resample.c clip8); match it so bicubic overshoot composes
            // identically across the two passes
            trow[(size_t)x * 3] = std::min(std::max(std::round(a0), 0.f), 255.f);
            trow[(size_t)x * 3 + 1] = std::min(std::max(std::round(a1), 0.f), 255.f);
            trow[(size_t)x * 3 + 2] = std::min(std::max(std::round(a2), 0.f), 255.f);
        }
    }

    // pass 2: vertical + fused clamp/rescale/normalize.  k-outer, contiguous
    // j-inner FMAs over the whole row — auto-vectorizes.
    std::vector<float> rowacc((size_t)ow * 3);
    for (int y = 0; y < oh; ++y) {
        const int ymin = ty.bounds[(size_t)y * 2];
        const int cnt = ty.bounds[(size_t)y * 2 + 1];
        const float* wp = ty.wt.data() + (size_t)y * ty.ksize;
        const int n = ow * 3;
        {
            const float w = wp[0];
            const float* trow = temp.data() + (size_t)ymin * n;
            for (int j = 0; j < n; ++j) rowacc[j] = w * trow[j];
        }
        for (int k = 1; k < cnt; ++k) {
            const float w = wp[k];
            const float* trow = temp.data() + (size_t)(ymin + k) * n;
            for (int j = 0; j < n; ++j) rowacc[j] += w * trow[j];
        }
        float* orow = dst + (size_t)y * n;
        for (int x = 0; x < ow; ++x)
            for (int c = 0; c < 3; ++c) {
                // PIL's vertical pass also rounds + saturates to uint8
                const float v = std::min(
                    std::max(std::round(rowacc[(size_t)x * 3 + c]), 0.f), 255.f);
                orow[(size_t)x * 3 + c] = (v * rescale - mean[c]) * inv_std[c];
            }
    }
}

void run_batch(int b, int num_threads, const std::function<void(int)>& body) {
    if (num_threads <= 1 || b == 1) {
        for (int i = 0; i < b; ++i) body(i);
        return;
    }
    std::vector<std::thread> threads;
    const int nt = std::min(num_threads, b);
    for (int t = 0; t < nt; ++t)
        threads.emplace_back([&, t]() { for (int i = t; i < b; i += nt) body(i); });
    for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Batched resample+normalize: B images of identical input size, threaded.
void preprocess_batch(const uint8_t* src, int b, int ih, int iw,
                      float* dst, int oh, int ow,
                      const float* mean, const float* std_, int num_threads,
                      int interp, int swap_channels) {
    float inv_std[3] = {1.0f / std_[0], 1.0f / std_[1], 1.0f / std_[2]};
    const uint8_t fill[3] = {0, 0, 0};
    const size_t in_stride = (size_t)ih * iw * 3;
    const size_t out_stride = (size_t)oh * ow * 3;
    const Taps tx = make_taps(ow, iw, interp);
    const Taps ty = make_taps(oh, ih, interp);
    run_batch(b, num_threads, [=, &tx, &ty](int i) {
        preprocess_canvas(src + i * in_stride, ih, iw, ih, iw, 0, 0, fill,
                          dst + i * out_stride, oh, ow, mean, inv_std, interp,
                          tx, ty, swap_channels);
    });
}

// Fused centered pad-to-square + resample + normalize (no intermediate
// padded frame): the serving path's expand2square -> processor in one pass
// (dexbotic_arch.py:516-529 + HF CLIP/SigLIP preprocess semantics).
void pad_preprocess_batch(const uint8_t* src, int b, int ih, int iw,
                          float* dst, int oh, int ow,
                          const float* mean, const float* std_,
                          const uint8_t* fill, int num_threads, int interp,
                          int swap_channels) {
    float inv_std[3] = {1.0f / std_[0], 1.0f / std_[1], 1.0f / std_[2]};
    const int side = std::max(ih, iw);
    const int top = (side - ih) / 2, left = (side - iw) / 2;
    const size_t in_stride = (size_t)ih * iw * 3;
    const size_t out_stride = (size_t)oh * ow * 3;
    const Taps tx = make_taps(ow, side, interp);
    const Taps ty = make_taps(oh, side, interp);
    run_batch(b, num_threads, [=, &tx, &ty](int i) {
        preprocess_canvas(src + i * in_stride, ih, iw, side, side, top, left,
                          fill, dst + i * out_stride, oh, ow, mean, inv_std,
                          interp, tx, ty, swap_channels);
    });
}

// Centered pad-to-square into a caller-provided buffer (uint8 HWC).
void expand2square_u8(const uint8_t* src, int h, int w,
                      uint8_t* dst, int side, const uint8_t* fill) {
    for (int y = 0; y < side; ++y)
        for (int x = 0; x < side; ++x)
            std::memcpy(dst + (y * side + x) * 3, fill, 3);
    const int top = (side - h) / 2;
    const int left = (side - w) / 2;
    for (int y = 0; y < h; ++y)
        std::memcpy(dst + ((top + y) * side + left) * 3, src + y * w * 3,
                    (size_t)w * 3);
}

}  // extern "C"
