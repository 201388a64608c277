// Fused host-side image preprocessing — native runtime component.
//
// The reference's only native code is its CUDA sLSTM kernel (JIT-compiled at
// import, xlstm/blocks/slstm/src/cuda_init.py); its host data path chains
// cv2.resize -> numpy pad -> float cast -> /255 with an intermediate copy at
// every step. This library fuses the whole letterbox + pad + normalize +
// batch-assemble into ONE pass per output pixel (bilinear sample straight
// into the float32 NHWC batch buffer), multithreaded across images.
//
// Exposed C ABI (ctypes):
//   letterbox_batch(srcs, src_hs, src_ws, n, imgsz, out, metas, n_threads)
//     srcs:  array of n pointers to HWC uint8 RGB images
//     out:   (n, imgsz, imgsz, 3) float32, pre-zeroed NOT required
//     metas: (n, 3) float32 -> (scale_ratio, pad_x, pad_y) per image
//
// Build: g++ -O3 -march=native -shared -fPIC -pthread imgproc.cpp -o imgproc.so

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr float kPadValue = 114.0f / 255.0f;

// Separable bilinear letterbox: precomputed per-column sample tables, a
// horizontal pass into two row buffers, then a vertical blend — the inner
// loops are straight-line FMA chains gcc auto-vectorizes.
void letterbox_one(const uint8_t* src, int sh, int sw, int imgsz, float* dst,
                   float* meta, int scaleup) {
  float r = std::min(static_cast<float>(imgsz) / sh, static_cast<float>(imgsz) / sw);
  if (!scaleup) r = std::min(r, 1.0f);
  int nh = static_cast<int>(std::round(sh * r));
  int nw = static_cast<int>(std::round(sw * r));
  int top = (imgsz - nh) / 2;
  int left = (imgsz - nw) / 2;
  meta[0] = r;
  meta[1] = static_cast<float>(left);
  meta[2] = static_cast<float>(top);

  // per-output-column source x and weight (half-pixel convention, clamped)
  std::vector<int> x0(nw), x1(nw);
  std::vector<float> ax(nw);
  for (int x = 0; x < nw; ++x) {
    float fx = (x + 0.5f) / r - 0.5f;
    fx = std::min(std::max(fx, 0.0f), static_cast<float>(sw - 1));
    x0[x] = static_cast<int>(fx);
    x1[x] = std::min(x0[x] + 1, sw - 1);
    ax[x] = fx - x0[x];
  }

  std::vector<float> row_a(nw * 3), row_b(nw * 3);
  int cached_a = -1, cached_b = -1;
  const float inv255 = 1.0f / 255.0f;

  auto hresize = [&](int sy, float* out_row) {
    const uint8_t* srow = src + static_cast<long>(sy) * sw * 3;
    for (int x = 0; x < nw; ++x) {
      const uint8_t* p0 = srow + x0[x] * 3;
      const uint8_t* p1 = srow + x1[x] * 3;
      float a = ax[x];
      out_row[x * 3 + 0] = p0[0] + a * (p1[0] - p0[0]);
      out_row[x * 3 + 1] = p0[1] + a * (p1[1] - p0[1]);
      out_row[x * 3 + 2] = p0[2] + a * (p1[2] - p0[2]);
    }
  };

  for (int y = 0; y < imgsz; ++y) {
    float* row = dst + static_cast<long>(y) * imgsz * 3;
    if (y < top || y >= top + nh) {
      for (int i = 0; i < imgsz * 3; ++i) row[i] = kPadValue;
      continue;
    }
    float fy = (y - top + 0.5f) / r - 0.5f;
    fy = std::min(std::max(fy, 0.0f), static_cast<float>(sh - 1));
    int y0 = static_cast<int>(fy);
    int y1 = std::min(y0 + 1, sh - 1);
    float ay = fy - y0;
    if (cached_a != y0) { hresize(y0, row_a.data()); cached_a = y0; }
    if (cached_b != y1) { hresize(y1, row_b.data()); cached_b = y1; }
    for (int i = 0; i < left * 3; ++i) row[i] = kPadValue;
    float* mid = row + left * 3;
    const float* ra = row_a.data();
    const float* rb = row_b.data();
    for (int i = 0; i < nw * 3; ++i) {
      mid[i] = (ra[i] + ay * (rb[i] - ra[i])) * inv255;
    }
    for (int i = (left + nw) * 3; i < imgsz * 3; ++i) row[i] = kPadValue;
  }
}

}  // namespace

extern "C" {

void letterbox_batch(const uint8_t** srcs, const int* src_hs, const int* src_ws,
                     int n, int imgsz, float* out, float* metas, int n_threads,
                     int scaleup) {
  const long per_img = static_cast<long>(imgsz) * imgsz * 3;
  n_threads = std::max(1, std::min(n_threads, n));
  if (n_threads == 1) {
    for (int i = 0; i < n; ++i) {
      letterbox_one(srcs[i], src_hs[i], src_ws[i], imgsz, out + i * per_img,
                    metas + i * 3, scaleup);
    }
    return;
  }
  std::vector<std::thread> workers;
  std::atomic<int> next{0};
  for (int t = 0; t < n_threads; ++t) {
    workers.emplace_back([&]() {
      while (true) {
        int i = next.fetch_add(1);
        if (i >= n) break;
        letterbox_one(srcs[i], src_hs[i], src_ws[i], imgsz, out + i * per_img,
                      metas + i * 3, scaleup);
      }
    });
  }
  for (auto& w : workers) w.join();
}

// HSV gain jitter in-place on a uint8 RGB image (the other per-pixel host op
// in the train path; reference data/augment.py:1303 does 3 cv2 LUT passes).
void hsv_inplace(uint8_t* img, int h, int w, float hgain, float sgain, float vgain) {
  const int n = h * w;
  for (int i = 0; i < n; ++i) {
    uint8_t* p = img + i * 3;
    float r = p[0] / 255.0f, g = p[1] / 255.0f, b = p[2] / 255.0f;
    float mx = std::max({r, g, b});
    float mn = std::min({r, g, b});
    float d = mx - mn;
    float hh = 0.0f;
    if (d > 1e-6f) {
      if (mx == r) hh = std::fmod((g - b) / d, 6.0f);
      else if (mx == g) hh = (b - r) / d + 2.0f;
      else hh = (r - g) / d + 4.0f;
      hh *= 60.0f;
      if (hh < 0) hh += 360.0f;
    }
    float s = mx <= 0 ? 0.0f : d / mx;
    float v = mx;
    hh = std::fmod(hh * hgain, 360.0f);
    s = std::min(std::max(s * sgain, 0.0f), 1.0f);
    v = std::min(std::max(v * vgain, 0.0f), 1.0f);
    float c = v * s;
    float xx = c * (1 - std::fabs(std::fmod(hh / 60.0f, 2.0f) - 1));
    float m = v - c;
    float rr = 0, gg = 0, bb = 0;
    int sector = static_cast<int>(hh / 60.0f) % 6;
    switch (sector) {
      case 0: rr = c; gg = xx; break;
      case 1: rr = xx; gg = c; break;
      case 2: gg = c; bb = xx; break;
      case 3: gg = xx; bb = c; break;
      case 4: rr = xx; bb = c; break;
      default: rr = c; bb = xx; break;
    }
    p[0] = static_cast<uint8_t>((rr + m) * 255.0f + 0.5f);
    p[1] = static_cast<uint8_t>((gg + m) * 255.0f + 0.5f);
    p[2] = static_cast<uint8_t>((bb + m) * 255.0f + 0.5f);
  }
}

}  // extern "C"
