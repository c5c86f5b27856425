// Native host-side image ops for the port's data pipeline.
//
// The reference delegates augmentation to OpenCV's C++ kernels
// (utils.py:315-358); this library is the equivalent native layer of the
// port's host pipeline.  It computes the same functions as the numpy path
// of deeplab_tpu_torch/data/augment.py (which follows cv2): bit for bit on
// the integer paths (nearest resize, flips, LUT) and to rounding on the
// float paths.  A plain C ABI, bound with ctypes by data/native.py, which
// builds it with g++ at first use (no nvcc, no pybind11).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <cfenv>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- resize ----

// cv2 INTER_LINEAR semantics: half-pixel centers.
void resize_bilinear_u8(const uint8_t* src, int h, int w, int c,
                        uint8_t* dst, int oh, int ow) {
    std::vector<int> x0(ow), x1(ow);
    std::vector<float> fx(ow);
    const double sx = (double)w / ow, sy = (double)h / oh;
    for (int j = 0; j < ow; ++j) {
        double s = (j + 0.5) * sx - 0.5;
        int lo = (int)std::floor(s);
        fx[j] = (float)(s - lo);
        x0[j] = std::min(std::max(lo, 0), w - 1);
        x1[j] = std::min(std::max(lo + 1, 0), w - 1);
    }
    for (int i = 0; i < oh; ++i) {
        double s = (i + 0.5) * sy - 0.5;
        int lo = (int)std::floor(s);
        float fy = (float)(s - lo);
        int y0 = std::min(std::max(lo, 0), h - 1);
        int y1 = std::min(std::max(lo + 1, 0), h - 1);
        const uint8_t* r0 = src + (size_t)y0 * w * c;
        const uint8_t* r1 = src + (size_t)y1 * w * c;
        uint8_t* out = dst + (size_t)i * ow * c;
        for (int j = 0; j < ow; ++j) {
            for (int k = 0; k < c; ++k) {
                float top = r0[x0[j] * c + k] * (1 - fx[j])
                          + r0[x1[j] * c + k] * fx[j];
                float bot = r1[x0[j] * c + k] * (1 - fx[j])
                          + r1[x1[j] * c + k] * fx[j];
                float v = top * (1 - fy) + bot * fy;
                out[j * c + k] = (uint8_t)std::min(255.f,
                                                   std::max(0.f, std::nearbyint(v)));
            }
        }
    }
}

// cv2 INTER_NEAREST semantics: src = floor(dst * scale).
void resize_nearest_u8(const uint8_t* src, int h, int w, int c,
                       uint8_t* dst, int oh, int ow) {
    std::vector<int> xs(ow);
    const double sx = (double)w / ow, sy = (double)h / oh;
    for (int j = 0; j < ow; ++j)
        xs[j] = std::min((int)std::floor(j * sx), w - 1);
    for (int i = 0; i < oh; ++i) {
        int y = std::min((int)std::floor(i * sy), h - 1);
        const uint8_t* row = src + (size_t)y * w * c;
        uint8_t* out = dst + (size_t)i * ow * c;
        for (int j = 0; j < ow; ++j)
            std::memcpy(out + j * c, row + xs[j] * c, c);
    }
}

// ----------------------------------------------------------------- flips ----

void flip_u8(const uint8_t* src, int h, int w, int c, int axis, uint8_t* dst) {
    for (int i = 0; i < h; ++i) {
        int si = (axis == 0) ? (h - 1 - i) : i;
        const uint8_t* row = src + (size_t)si * w * c;
        uint8_t* out = dst + (size_t)i * w * c;
        if (axis == 1) {
            for (int j = 0; j < w; ++j)
                std::memcpy(out + j * c, row + (w - 1 - j) * c, c);
        } else {
            std::memcpy(out, row, (size_t)w * c);
        }
    }
}

// ------------------------------------------------------------------- LUT ----

void lut_u8(const uint8_t* src, int64_t n, const uint8_t* table,
            uint8_t* dst) {
    for (int64_t i = 0; i < n; ++i) dst[i] = table[src[i]];
}

// ----------------------------------------------------------- affine warp ----

// cv2.warpAffine: M maps src->dst (2x3, row-major); constant-0 border.
void warp_affine_u8(const uint8_t* src, int h, int w, int c,
                    const double* M, uint8_t* dst, int oh, int ow,
                    int nearest) {
    // invert [M; 0 0 1]
    double a = M[0], b = M[1], tx = M[2], d = M[3], e = M[4], ty = M[5];
    double det = a * e - b * d;
    double ia = e / det, ib = -b / det, id = -d / det, ie = a / det;
    double itx = -(ia * tx + ib * ty), ity = -(id * tx + ie * ty);
    for (int i = 0; i < oh; ++i) {
        uint8_t* out = dst + (size_t)i * ow * c;
        for (int j = 0; j < ow; ++j) {
            double sxf = ia * j + ib * i + itx;
            double syf = id * j + ie * i + ity;
            if (nearest) {
                long jx = (long)std::nearbyint(sxf), iy = (long)std::nearbyint(syf);
                if (jx < 0 || jx >= w || iy < 0 || iy >= h) {
                    std::memset(out + j * c, 0, c);
                } else {
                    std::memcpy(out + j * c,
                                src + ((size_t)iy * w + jx) * c, c);
                }
                continue;
            }
            int x0 = (int)std::floor(sxf), y0 = (int)std::floor(syf);
            float fx = (float)(sxf - x0), fy = (float)(syf - y0);
            for (int k = 0; k < c; ++k) {
                auto sample = [&](int yy, int xx) -> float {
                    if (xx < 0 || xx >= w || yy < 0 || yy >= h) return 0.f;
                    return src[((size_t)yy * w + xx) * c + k];
                };
                float v = sample(y0, x0) * (1 - fx) * (1 - fy)
                        + sample(y0, x0 + 1) * fx * (1 - fy)
                        + sample(y0 + 1, x0) * (1 - fx) * fy
                        + sample(y0 + 1, x0 + 1) * fx * fy;
                out[j * c + k] = (uint8_t)std::min(255.f,
                                                   std::max(0.f, std::nearbyint(v)));
            }
        }
    }
}

// --------------------------------------------------------- Gaussian blur ----

static void gaussian_taps(int ksize, std::vector<float>& k) {
    // cv2 fixed small kernels for sigma<=0
    static const float k3[] = {0.25f, 0.5f, 0.25f};
    static const float k5[] = {0.0625f, 0.25f, 0.375f, 0.25f, 0.0625f};
    static const float k7[] = {0.03125f, 0.109375f, 0.21875f, 0.28125f,
                               0.21875f, 0.109375f, 0.03125f};
    if (ksize == 3) { k.assign(k3, k3 + 3); return; }
    if (ksize == 5) { k.assign(k5, k5 + 5); return; }
    if (ksize == 7) { k.assign(k7, k7 + 7); return; }
    double sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8;
    k.resize(ksize);
    double sum = 0;
    for (int i = 0; i < ksize; ++i) {
        double x = i - (ksize - 1) / 2.0;
        k[i] = (float)std::exp(-x * x / (2 * sigma * sigma));
        sum += k[i];
    }
    for (auto& v : k) v = (float)(v / sum);
}

static inline int reflect101(int i, int n) {
    if (n == 1) return 0;
    while (i < 0 || i >= n) {
        if (i < 0) i = -i;
        if (i >= n) i = 2 * n - 2 - i;
    }
    return i;
}

void gaussian_blur_u8(const uint8_t* src, int h, int w, int c, int ksize,
                      uint8_t* dst) {
    std::vector<float> k;
    gaussian_taps(ksize, k);
    int r = ksize / 2;
    std::vector<float> tmp((size_t)h * w * c);
    for (int i = 0; i < h; ++i)           // horizontal pass
        for (int j = 0; j < w; ++j)
            for (int ch = 0; ch < c; ++ch) {
                float acc = 0;
                for (int t = -r; t <= r; ++t)
                    acc += k[t + r] *
                           src[((size_t)i * w + reflect101(j + t, w)) * c + ch];
                tmp[((size_t)i * w + j) * c + ch] = acc;
            }
    for (int i = 0; i < h; ++i)           // vertical pass
        for (int j = 0; j < w; ++j)
            for (int ch = 0; ch < c; ++ch) {
                float acc = 0;
                for (int t = -r; t <= r; ++t)
                    acc += k[t + r] *
                           tmp[((size_t)reflect101(i + t, h) * w + j) * c + ch];
                dst[((size_t)i * w + j) * c + ch] =
                    (uint8_t)std::min(255.f, std::max(0.f, std::nearbyint(acc)));
            }
}

// -------------------------------------------------------- color + CLAHE ----

void bgr2yuv_u8(const uint8_t* src, int64_t npx, uint8_t* dst) {
    for (int64_t i = 0; i < npx; ++i) {
        double b = src[i * 3], g = src[i * 3 + 1], r = src[i * 3 + 2];
        double y = 0.299 * r + 0.587 * g + 0.114 * b;
        double u = 0.492 * (b - y) + 128.0;
        double v = 0.877 * (r - y) + 128.0;
        dst[i * 3] = (uint8_t)std::min(255.0, std::max(0.0, std::nearbyint(y)));
        dst[i * 3 + 1] = (uint8_t)std::min(255.0, std::max(0.0, std::nearbyint(u)));
        dst[i * 3 + 2] = (uint8_t)std::min(255.0, std::max(0.0, std::nearbyint(v)));
    }
}

void yuv2bgr_u8(const uint8_t* src, int64_t npx, uint8_t* dst) {
    for (int64_t i = 0; i < npx; ++i) {
        double y = src[i * 3], u = src[i * 3 + 1] - 128.0,
               v = src[i * 3 + 2] - 128.0;
        double r = y + 1.140 * v;
        double g = y - 0.395 * u - 0.581 * v;
        double b = y + 2.032 * u;
        dst[i * 3] = (uint8_t)std::min(255.0, std::max(0.0, std::nearbyint(b)));
        dst[i * 3 + 1] = (uint8_t)std::min(255.0, std::max(0.0, std::nearbyint(g)));
        dst[i * 3 + 2] = (uint8_t)std::min(255.0, std::max(0.0, std::nearbyint(r)));
    }
}

void clahe_u8(const uint8_t* src, int h, int w, double clip_limit,
              int th, int tw, uint8_t* dst) {
    // pad (reflect) so tiles divide evenly
    int ph = (th - h % th) % th, pw = (tw - w % tw) % tw;
    int H = h + ph, W = w + pw;
    std::vector<uint8_t> img((size_t)H * W);
    for (int i = 0; i < H; ++i) {
        int si = (h == 1) ? 0 : reflect101(i, h);
        for (int j = 0; j < W; ++j) {
            int sj = (w == 1) ? 0 : reflect101(j, w);
            img[(size_t)i * W + j] = src[(size_t)si * w + sj];
        }
    }
    int tile_h = H / th, tile_w = W / tw, n_px = tile_h * tile_w;
    int clip = std::max((int)(clip_limit * n_px / 256), 1);
    std::vector<double> luts((size_t)th * tw * 256);
    std::vector<int64_t> hist(256);
    for (int ti = 0; ti < th; ++ti)
        for (int tj = 0; tj < tw; ++tj) {
            std::fill(hist.begin(), hist.end(), 0);
            for (int i = 0; i < tile_h; ++i)
                for (int j = 0; j < tile_w; ++j)
                    hist[img[(size_t)(ti * tile_h + i) * W + tj * tile_w + j]]++;
            int64_t excess = 0;
            for (int b = 0; b < 256; ++b)
                if (hist[b] > clip) { excess += hist[b] - clip; hist[b] = clip; }
            int64_t add = excess / 256, rem = excess % 256;
            for (int b = 0; b < 256; ++b) hist[b] += add;
            if (rem) {
                int step = std::max((int)(256 / rem), 1);
                for (int b = 0, cnt = 0; b < 256 && cnt < rem; b += step, ++cnt)
                    hist[b] += 1;
            }
            double cdf = 0;
            double* lut = &luts[((size_t)ti * tw + tj) * 256];
            for (int b = 0; b < 256; ++b) {
                cdf += hist[b];
                lut[b] = std::min(255.0, std::max(0.0,
                            std::nearbyint(cdf * 255.0 / n_px)));
            }
        }
    // bilinear interpolation between tile LUTs
    for (int i = 0; i < h; ++i) {
        double ty = (i - tile_h / 2.0) / tile_h;
        int y0 = std::min(std::max((int)std::floor(ty), 0), th - 1);
        int y1 = std::min(y0 + 1, th - 1);
        double fy = std::min(std::max(ty - y0, 0.0), 1.0);
        for (int j = 0; j < w; ++j) {
            double tx = (j - tile_w / 2.0) / tile_w;
            int x0 = std::min(std::max((int)std::floor(tx), 0), tw - 1);
            int x1 = std::min(x0 + 1, tw - 1);
            double fx = std::min(std::max(tx - x0, 0.0), 1.0);
            uint8_t v = img[(size_t)i * W + j];
            double out =
                luts[((size_t)y0 * tw + x0) * 256 + v] * (1 - fy) * (1 - fx) +
                luts[((size_t)y0 * tw + x1) * 256 + v] * (1 - fy) * fx +
                luts[((size_t)y1 * tw + x0) * 256 + v] * fy * (1 - fx) +
                luts[((size_t)y1 * tw + x1) * 256 + v] * fy * fx;
            dst[(size_t)i * w + j] =
                (uint8_t)std::min(255.0, std::max(0.0, std::nearbyint(out)));
        }
    }
}

}  // extern "C"
