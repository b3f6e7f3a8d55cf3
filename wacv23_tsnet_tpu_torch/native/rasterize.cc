// Native rasterizer hot loops of the port's host data pipeline (the
// port's own copy of the JAX package's native/rasterize.cc).
//
// The per-edge work of keypoint rasterization -- the quadratic
// least-squares fit, unit-step sampling and brush stamping -- as C++
// behind a C ABI, bound through ctypes (native/build.py).
//
// Semantics follow data/rasterize.py's numpy tier: closed-form
// 2nd/1st-order LSQ fit == np.polyfit, |a|>1 quadratic rejection,
// endpoint ordering, int casts, border clamping, square brush with
// optional radius-2bw endpoint dots. The fit's float order differs from
// numpy's, so an int cast at a tie can move a stroke pixel.
//
// Build: native/build.py (the host's c++ -O3 -shared), at first use.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// Fit v = poly(t) (degree 2 if n >= 3 else 1), sample t at unit steps.
// Returns the number of samples written (<= max_out), 0 for degenerate
// fits (matching the numpy tier returning None), -1 if max_out is too
// small.
int tsnet_fit_axis(const double* t, const double* v, int n,
                   double* out_t, double* out_v, int max_out) {
  double c0 = 0.0, c1 = 0.0, c2 = 0.0;  // v = c2*t^2 + c1*t + c0
  if (n < 2) return 0;
  if (n < 3) {
    // least-squares line through the points
    double st = 0, sv = 0, stt = 0, stv = 0;
    for (int i = 0; i < n; ++i) {
      st += t[i]; sv += v[i]; stt += t[i] * t[i]; stv += t[i] * v[i];
    }
    const double det = n * stt - st * st;
    if (std::fabs(det) < 1e-12) return 0;
    c1 = (n * stv - st * sv) / det;
    c0 = (sv - c1 * st) / n;
  } else {
    // normal equations for the quadratic LSQ fit
    double s0 = n, s1 = 0, s2 = 0, s3 = 0, s4 = 0;
    double b0 = 0, b1 = 0, b2 = 0;
    for (int i = 0; i < n; ++i) {
      const double ti = t[i], ti2 = ti * ti;
      s1 += ti; s2 += ti2; s3 += ti2 * ti; s4 += ti2 * ti2;
      b0 += v[i]; b1 += v[i] * ti; b2 += v[i] * ti2;
    }
    // solve [[s4,s3,s2],[s3,s2,s1],[s2,s1,s0]] [c2,c1,c0] = [b2,b1,b0]
    const double det = s4 * (s2 * s0 - s1 * s1) - s3 * (s3 * s0 - s1 * s2) +
                       s2 * (s3 * s1 - s2 * s2);
    if (std::fabs(det) < 1e-9) return 0;
    c2 = (b2 * (s2 * s0 - s1 * s1) - s3 * (b1 * s0 - b0 * s1) +
          s2 * (b1 * s1 - b0 * s2)) / det;
    c1 = (s4 * (b1 * s0 - b0 * s1) - b2 * (s3 * s0 - s2 * s1) +
          s2 * (s3 * b0 - s2 * b1)) / det;
    c0 = (s4 * (s2 * b0 - s1 * b1) - s3 * (s3 * b0 - s2 * b1) +
          b2 * (s3 * s1 - s2 * s2)) / det;
    if (std::fabs(c2) > 1.0) return 0;  // reject wild quadratics
    if (!std::isfinite(c0) || !std::isfinite(c1) || !std::isfinite(c2))
      return 0;
  }
  double t0 = t[0], t1 = t[n - 1];
  if (t0 > t1) std::swap(t0, t1);
  const int num = static_cast<int>(std::ceil(t1 - t0));
  if (num <= 0) return 0;
  if (num > max_out) return -1;
  const double step = (num == 1) ? 0.0 : (t1 - t0) / (num - 1);
  for (int i = 0; i < num; ++i) {
    const double ti = t0 + step * i;
    out_t[i] = ti;
    out_v[i] = (c2 * ti + c1) * ti + c0;
  }
  return num;
}

// Stamp an integer pixel curve with a (2bw)^2 square brush; optional
// radius-2bw endpoint disks. img is HxWxC uint8 (C = 1 or 3).
void tsnet_stamp_edge(uint8_t* img, int h, int w, int c,
                      const int32_t* xs, const int32_t* ys, int n, int bw,
                      const uint8_t* color, int endpoints) {
  if (n <= 0) return;
  for (int k = 0; k < n; ++k) {
    for (int dy = -bw; dy < bw; ++dy) {
      const int yy = std::min(h - 1, std::max(0, ys[k] + dy));
      for (int dx = -bw; dx < bw; ++dx) {
        const int xx = std::min(w - 1, std::max(0, xs[k] + dx));
        uint8_t* px = img + (static_cast<int64_t>(yy) * w + xx) * c;
        for (int ch = 0; ch < c; ++ch) px[ch] = color[ch];
      }
    }
  }
  if (endpoints) {
    const int ends[2] = {0, n - 1};
    for (int e = 0; e < 2; ++e) {
      const int ex = xs[ends[e]], ey = ys[ends[e]];
      for (int dy = -2 * bw; dy < 2 * bw; ++dy) {
        for (int dx = -2 * bw; dx < 2 * bw; ++dx) {
          if (dy * dy + dx * dx >= 4 * bw * bw) continue;
          const int yy = std::min(h - 1, std::max(0, ey + dy));
          const int xx = std::min(w - 1, std::max(0, ex + dx));
          uint8_t* px = img + (static_cast<int64_t>(yy) * w + xx) * c;
          for (int ch = 0; ch < c; ++ch) px[ch] = color[ch];
        }
      }
    }
  }
}

// Fit + sample + stamp one edge in a single call (the common case):
// fits along the dominant axis like the Python tier. Returns the number
// of curve samples stamped (0 = degenerate fit, nothing drawn).
int tsnet_draw_edge(uint8_t* img, int h, int w, int c,
                    const double* x, const double* y, int n, int bw,
                    const uint8_t* color, int endpoints) {
  constexpr int kMax = 1 << 14;
  double bt[kMax], bv[kMax];
  int32_t xs[kMax], ys[kMax];

  double dx_max = 0, dy_max = 0;
  for (int i = 0; i + 1 < n; ++i) {
    dx_max = std::max(dx_max, std::fabs(x[i] - x[i + 1]));
    dy_max = std::max(dy_max, std::fabs(y[i] - y[i + 1]));
  }
  int num;
  if (dx_max < dy_max) {
    num = tsnet_fit_axis(y, x, n, bt, bv, kMax);  // sample along y
    if (num <= 0) return 0;
    for (int i = 0; i < num; ++i) {
      xs[i] = static_cast<int32_t>(bv[i]);
      ys[i] = static_cast<int32_t>(bt[i]);
    }
  } else {
    num = tsnet_fit_axis(x, y, n, bt, bv, kMax);
    if (num <= 0) return 0;
    for (int i = 0; i < num; ++i) {
      xs[i] = static_cast<int32_t>(bt[i]);
      ys[i] = static_cast<int32_t>(bv[i]);
    }
  }
  tsnet_stamp_edge(img, h, w, c, xs, ys, num, bw, color, endpoints);
  return num;
}

}  // extern "C"
