// Exact Euclidean distance transform, Felzenszwalb & Huttenlocher's O(n)
// lower-envelope algorithm per axis ("Distance Transforms of Sampled
// Functions", Theory of Computing 2012).  Host-side map preprocessing for
// the collision path: the reference queries a supereight octree per sample
// (nonlinear_impl.h:1920-2043); the batched build preprocesses the map ONCE
// into a dense ESDF (models/esdf.py) and this kernel is the big-map
// (e.g. 512^3) builder -- the in-graph XLA min-plus reduction is exact too
// but O(n^2) per axis with an (..., n, n) broadcast, which blows up in
// memory/FLOPs at pod-scale maps.
//
// Independent implementation (no reference analogue: the reference has no
// EDT; its dormant ESDF path loads precomputed fields).
//
// Layout: C-contiguous (nx, ny, nz) float32.  Output is SQUARED distance in
// voxel units; the Python side does sqrt/sign/resolution scaling.

#include <cstdint>
#include <cstdlib>
#include <limits>
#include <vector>

namespace {

const float kInf = std::numeric_limits<float>::infinity();

// 1-D squared-distance transform of f into d (both length n), Felzenszwalb
// lower envelope of the parabolas j -> f[j] + (i - j)^2.  v/z are scratch
// (length n and n + 1).
void dt1d(const float* f, float* d, int* v, float* z, int n) {
  // Seed the envelope with the first FINITE parabola; +inf parabolas never
  // contribute to the lower envelope and are skipped outright (they arise
  // from rows with no feature voxel yet after earlier axis passes).
  int q0 = 0;
  while (q0 < n && f[q0] == kInf) ++q0;
  if (q0 == n) {               // no finite input anywhere in this row
    for (int i = 0; i < n; ++i) d[i] = kInf;
    return;
  }
  int k = 0;
  v[0] = q0;
  z[0] = -kInf;
  z[1] = kInf;
  for (int q = q0 + 1; q < n; ++q) {
    if (f[q] == kInf) continue;
    float s;
    for (;;) {
      int p = v[k];
      s = ((f[q] + q * (float)q) - (f[p] + p * (float)p)) / (2.0f * (q - p));
      if (s > z[k]) break;
      if (--k < 0) break;
    }
    if (k < 0) {
      k = 0;
      v[0] = q;
      z[0] = -kInf;
    } else {
      ++k;
      v[k] = q;
      z[k] = s;
    }
    z[k + 1] = kInf;
  }
  int j = 0;
  for (int i = 0; i < n; ++i) {
    while (z[j + 1] < i) ++j;
    int p = v[j];
    d[i] = (i - p) * (float)(i - p) + f[p];
  }
}

// Apply dt1d along an axis with the given stride over `count` rows whose
// starting offsets are enumerated by (outer, inner) loops on the caller
// side; here we take explicit row start offsets.
void transform_axis(float* grid, int64_t n_rows, const int64_t* row_starts,
                    int64_t stride, int n) {
#pragma omp parallel
  {
    std::vector<float> f(n), d(n), z(n + 1);
    std::vector<int> v(n);
#pragma omp for schedule(static)
    for (int64_t r = 0; r < n_rows; ++r) {
      float* base = grid + row_starts[r];
      for (int i = 0; i < n; ++i) f[i] = base[i * stride];
      dt1d(f.data(), d.data(), v.data(), z.data(), n);
      for (int i = 0; i < n; ++i) base[i * stride] = d[i];
    }
  }
}

}  // namespace

extern "C" {

// Squared EDT (voxel units) to the nearest TRUE voxel of mask (nx, ny, nz),
// written into out (float32, same shape).  Returns 0 on success.
int mtg_edt_sq(int nx, int ny, int nz, const uint8_t* mask, float* out) {
  // C-contiguous (nx, ny, nz): index (x, y, z) = x*ny*nz + y*nz + z.
  const int64_t nyz = (int64_t)ny * nz;
  const int64_t total = (int64_t)nx * nyz;
  for (int64_t i = 0; i < total; ++i) out[i] = mask[i] ? 0.0f : kInf;

  // Axis z: contiguous rows, one per (x, y).
  {
    std::vector<int64_t> starts((int64_t)nx * ny);
    for (int64_t r = 0; r < (int64_t)nx * ny; ++r) starts[r] = r * nz;
    transform_axis(out, (int64_t)nx * ny, starts.data(), 1, nz);
  }
  // Axis y: stride nz, rows indexed by (x, z).
  {
    std::vector<int64_t> starts((int64_t)nx * nz);
    int64_t r = 0;
    for (int64_t x = 0; x < nx; ++x)
      for (int64_t zi = 0; zi < nz; ++zi) starts[r++] = x * nyz + zi;
    transform_axis(out, r, starts.data(), nz, ny);
  }
  // Axis x: stride ny*nz, rows indexed by (y, z).
  {
    std::vector<int64_t> starts(nyz);
    for (int64_t r = 0; r < nyz; ++r) starts[r] = r;
    transform_axis(out, nyz, starts.data(), nyz, nx);
  }
  return 0;
}

}  // extern "C"
