// Polygon rasterization for the dataset ETL hot loop.
//
// The reference's ETL spends its time in per-polygon skimage.draw.polygon
// rasterization under a multiprocessing pool (road_project/setup/
// process.py:111-119, 154-157 — SURVEY.md §3.5 "hot loop"). This native
// scanline even-odd filler removes the Python/numpy overhead; the port loads
// it via ctypes (masklab_tpu_torch/native/__init__.py); the ETL prefers
// cv2.fillPoly where cv2 is present. A copy of masklab_tpu/native/.
//
// Semantics: even-odd fill sampled at pixel centers (y + 0.5, x + 0.5),
// which matches cv2.fillPoly to within boundary-pixel differences.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// Fill one polygon into mask[h][w] with `value`.
// pts: n pairs of (x, y) doubles.
void fill_polygon(uint8_t *mask, int h, int w, const double *pts, int n,
                  uint8_t value) {
  if (n < 3) return;
  double ymin = pts[1], ymax = pts[1];
  for (int i = 1; i < n; ++i) {
    ymin = std::min(ymin, pts[2 * i + 1]);
    ymax = std::max(ymax, pts[2 * i + 1]);
  }
  int y0 = std::max(0, (int)ymin);
  int y1 = std::min(h - 1, (int)ymax + 1);
  std::vector<double> xs;
  xs.reserve(16);
  for (int y = y0; y <= y1; ++y) {
    double fy = y + 0.5;
    xs.clear();
    for (int i = 0; i < n; ++i) {
      int j = (i + 1) % n;
      double x0 = pts[2 * i], ya = pts[2 * i + 1];
      double x1e = pts[2 * j], yb = pts[2 * j + 1];
      if ((ya <= fy && yb > fy) || (yb <= fy && ya > fy)) {
        double t = (fy - ya) / (yb - ya);
        xs.push_back(x0 + t * (x1e - x0));
      }
    }
    std::sort(xs.begin(), xs.end());
    for (size_t k = 0; k + 1 < xs.size(); k += 2) {
      int xa = std::max(0, (int)std::ceil(xs[k] - 0.5));
      int xb = std::min(w - 1, (int)std::floor(xs[k + 1] - 0.5));
      if (xa > xb) continue;
      std::fill(mask + (size_t)y * w + xa, mask + (size_t)y * w + xb + 1,
                value);
    }
  }
}

// Rasterize a batch of polygons into one mask (union).
// offsets: m+1 prefix offsets into pts (in points, not doubles).
void fill_polygons(uint8_t *mask, int h, int w, const double *pts,
                   const int64_t *offsets, int m, uint8_t value) {
  for (int p = 0; p < m; ++p) {
    int64_t start = offsets[p], stop = offsets[p + 1];
    fill_polygon(mask, h, w, pts + 2 * start, (int)(stop - start), value);
  }
}

// Row-wise min/max x of nonzero pixels: the my_road edge scan used by the
// road-width fit (misc.py:680-694). Writes -1 where a row is empty.
void row_extents(const uint8_t *mask, int h, int w, int32_t *x_min,
                 int32_t *x_max) {
  for (int y = 0; y < h; ++y) {
    const uint8_t *row = mask + (size_t)y * w;
    int lo = -1, hi = -1;
    for (int x = 0; x < w; ++x) {
      if (row[x]) { lo = x; break; }
    }
    if (lo >= 0) {
      for (int x = w - 1; x >= 0; --x) {
        if (row[x]) { hi = x; break; }
      }
    }
    x_min[y] = lo;
    x_max[y] = hi;
  }
}

}  // extern "C"
