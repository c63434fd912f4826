// Fused Atari observation kernel: two-frame max + RGB->grayscale
// (BT.601) + bilinear resize (align_corners=false) + clip + uint8 cast,
// in one pass over the pixels. This is the actor-side CPU hot loop (one
// call per env step, SURVEY.md §3.2); the Python reference path in
// envs/atari.py (grayscale() + bilinear_resize()) materializes three
// intermediate float arrays per frame.
//
// Numerics mirror the numpy path bit-for-bit so the two are
// interchangeable mid-run: grayscale accumulates in double and rounds
// once to float (numpy: float64 expression then .astype(np.float32));
// resize weights/indices follow the same align_corners=false formulas
// in double with float weights; the interpolation itself is float
// arithmetic in the same operation order; the final cast truncates like
// numpy's .astype(np.uint8). envs/native.py compiles this with
// -ffp-contract=off — a fused multiply-add would round differently
// from numpy's discrete float ops.

#include <cstdint>
#include <vector>

namespace {

struct ResizeTables {
  std::vector<int64_t> y0, y1, x0, x1;
  std::vector<float> wy, wx;
};

// align_corners=false source coordinates, matching
// envs/atari.py bilinear_resize's cached tables.
void fill_axis(uint64_t in_n, uint64_t out_n, std::vector<int64_t>& i0,
               std::vector<int64_t>& i1, std::vector<float>& w) {
  i0.resize(out_n);
  i1.resize(out_n);
  w.resize(out_n);
  for (uint64_t i = 0; i < out_n; ++i) {
    double s = ((i + 0.5) * (double)in_n) / (double)out_n - 0.5;
    int64_t lo = (int64_t)s;
    if (s < 0) lo = (int64_t)s - 1;  // floor for negatives
    if (lo < 0) lo = 0;
    if (lo > (int64_t)in_n - 1) lo = (int64_t)in_n - 1;
    int64_t hi = lo + 1 < (int64_t)in_n ? lo + 1 : (int64_t)in_n - 1;
    double frac = s - (double)lo;
    if (frac < 0.0) frac = 0.0;
    if (frac > 1.0) frac = 1.0;
    i0[i] = lo;
    i1[i] = hi;
    w[i] = (float)frac;
  }
}

}  // namespace

namespace {

// Per-channel grayscale contributions as uint8-indexed tables: numpy's
// (0.299*r + 0.587*g) + 0.114*b in float64 becomes three exact-double
// lookups and two adds per pixel — same values, same addition order,
// ~3x the scalar multiply version's throughput.
struct GrayTables {
  double r[256], g[256], b[256];
  GrayTables() {
    for (int i = 0; i < 256; ++i) {
      r[i] = 0.299 * i;
      g[i] = 0.587 * i;
      b[i] = 0.114 * i;
    }
  }
};
const GrayTables kGray;

}  // namespace

extern "C" {

// f0, f1: uint8 [h, w, 3] RGB frames; f1 may be null (single frame, no
// max-pool). out: uint8 [oh, ow] grayscale observation.
void apex_preproc(const uint8_t* f0, const uint8_t* f1, uint64_t h,
                  uint64_t w, uint8_t* out, uint64_t oh, uint64_t ow) {
  thread_local std::vector<float> gray;
  gray.resize(h * w);
  const uint64_t n = h * w;
  if (f1) {
    for (uint64_t i = 0; i < n; ++i) {
      const uint8_t* a = f0 + 3 * i;
      const uint8_t* q = f1 + 3 * i;
      uint8_t r = a[0] > q[0] ? a[0] : q[0];
      uint8_t g = a[1] > q[1] ? a[1] : q[1];
      uint8_t b = a[2] > q[2] ? a[2] : q[2];
      gray[i] = (float)((kGray.r[r] + kGray.g[g]) + kGray.b[b]);
    }
  } else {
    for (uint64_t i = 0; i < n; ++i) {
      const uint8_t* a = f0 + 3 * i;
      gray[i] = (float)((kGray.r[a[0]] + kGray.g[a[1]]) + kGray.b[a[2]]);
    }
  }

  // tables are call-invariant per shape (the numpy path caches them in
  // _RESIZE_CACHE for the same reason); shapes are fixed per run, so a
  // one-entry thread_local cache eliminates the per-step rebuild
  thread_local ResizeTables t;
  thread_local uint64_t cached[4] = {0, 0, 0, 0};
  if (cached[0] != h || cached[1] != w || cached[2] != oh ||
      cached[3] != ow) {
    fill_axis(h, oh, t.y0, t.y1, t.wy);
    fill_axis(w, ow, t.x0, t.x1, t.wx);
    cached[0] = h;
    cached[1] = w;
    cached[2] = oh;
    cached[3] = ow;
  }

  for (uint64_t y = 0; y < oh; ++y) {
    const float* r0 = gray.data() + t.y0[y] * w;
    const float* r1 = gray.data() + t.y1[y] * w;
    const float wy = t.wy[y];
    uint8_t* row = out + y * ow;
    for (uint64_t x = 0; x < ow; ++x) {
      const float wx = t.wx[x];
      float top = r0[t.x0[x]] * (1.0f - wx) + r0[t.x1[x]] * wx;
      float bot = r1[t.x0[x]] * (1.0f - wx) + r1[t.x1[x]] * wx;
      float v = top * (1.0f - wy) + bot * wy;
      if (v < 0.0f) v = 0.0f;
      if (v > 255.0f) v = 255.0f;
      row[x] = (uint8_t)v;
    }
  }
}

}  // extern "C"
