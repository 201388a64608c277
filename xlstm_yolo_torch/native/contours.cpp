// External contours of a binary mask, as OpenCV's
// findContours(mask, RETR_EXTERNAL, CHAIN_APPROX_SIMPLE) gives them:
// Suzuki-Abe border following over the mask framed by a 1-pixel zero
// border, a raster scan that starts a contour at a 0 -> 1 step unless the
// last border pixel met on the row is the left border of an object already
// traced (then the new one lies inside it), OpenCV's direction order
// (0 = +x, counter-clockwise in image coordinates, y down) and its marks
// (a pixel whose right side is outside gets the "right bound" mark), and
// the simple chain approximation (a point where the direction changes).
// Contours come out in the reverse order of their discovery, as OpenCV
// lists them.
//
// Plain C interface, bound with ctypes (native/__init__.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const int kDx[8] = {1, 1, 0, -1, -1, -1, 0, 1};
const int kDy[8] = {0, -1, -1, -1, 0, 1, 1, 1};
const int8_t kNbd = 2;
const int8_t kRight = (int8_t)(2 | -128);  // nbd with the "right bound" bit

void fetch_contour(int8_t* img, int step, int8_t* i0, int px, int py, std::vector<int>& out) {
  int deltas[16];
  for (int k = 0; k < 8; k++) deltas[k] = deltas[k + 8] = kDx[k] + kDy[k] * step;
  int s, s_end;
  s_end = s = 4;
  int8_t* i1;
  do {
    s = (s - 1) & 7;
    i1 = i0 + deltas[s];
  } while (*i1 == 0 && s != s_end);
  if (s == s_end) {  // a single pixel
    *i0 = kRight;
    out.push_back(px);
    out.push_back(py);
    return;
  }
  int8_t* i3 = i0;
  int8_t* i4 = nullptr;
  int prev_s = s ^ 4;
  for (;;) {
    s_end = s;
    s = std::min(s, 15);
    while (s < 15) {
      i4 = i3 + deltas[++s];
      if (*i4 != 0) break;
    }
    s &= 7;
    if ((unsigned)(s - 1) < (unsigned)s_end)
      *i3 = kRight;
    else if (*i3 == 1)
      *i3 = kNbd;
    if (s != prev_s) {
      out.push_back(px);
      out.push_back(py);
      prev_s = s;
    }
    px += kDx[s];
    py += kDy[s];
    if (i4 == i0 && i3 == i1) break;
    i3 = i4;
    s = (s + 4) & 7;
  }
  (void)img;
}

}  // namespace

extern "C" {

// mask: h * w bytes, nonzero = object. Writes the contours' (x, y) points
// one after another into pts and their point counts into lens; returns
// the number of contours, or -1 when cap_pts or cap_contours is too small.
long find_external_contours(const uint8_t* mask, int h, int w, int* pts, long cap_pts, int* lens,
                            long cap_contours) {
  int W = w + 2, H = h + 2;
  std::vector<int8_t> img((size_t)W * H, 0);
  for (int y = 0; y < h; y++)
    for (int x = 0; x < w; x++) img[(size_t)(y + 1) * W + x + 1] = mask[(size_t)y * w + x] != 0;
  std::vector<std::vector<int>> found;
  for (int y = 1; y < H - 1; y++) {
    int8_t* row = &img[(size_t)y * W];
    int lnbd_x = 0;
    int prev = row[0];
    for (int x = 1; x < W - 1; x++) {
      int p = row[x];
      if (p == prev) continue;
      if (prev == 0 && p == 1 && row[lnbd_x] <= 0) {
        std::vector<int> c;
        fetch_contour(img.data(), W, row + x, x - 1, y - 1, c);
        found.push_back(std::move(c));
        lnbd_x = x;
        prev = row[x];
        continue;
      }
      prev = p;
      if (p & -2) lnbd_x = x;
    }
  }
  long total = 0;
  for (auto& c : found) total += (long)c.size();
  if ((long)found.size() > cap_contours || total > cap_pts) return -1;
  long k = 0, i = 0;
  for (auto it = found.rbegin(); it != found.rend(); ++it, ++i) {
    lens[i] = (int)(it->size() / 2);
    std::memcpy(pts + k, it->data(), it->size() * sizeof(int));
    k += (long)it->size();
  }
  return (long)found.size();
}

}  // extern "C"
