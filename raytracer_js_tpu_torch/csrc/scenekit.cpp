// scenekit — native host-side scene tooling for raytracer_js_tpu_torch.
//
// Host C++, no CUDA: the octree's fine-grid CSR build (the per-primitive
// insertion pass re-expressed as a batch scatter; a per-primitive Python
// loop is the scene-build bottleneck at a million primitives), the
// covering-level pass, and an OBJ mesh loader feeding the triangle tables.
//
// Build: raytracer_js_tpu_torch/native.py compiles this file at first use
// with g++ -O3 -fPIC -shared -std=c++17 (no -march flag, so the library
// runs on any x86-64 host) into build/scenekit/ at the root of the
// checkout. ABI: plain C, driven from Python via ctypes. Every entry has a
// NumPy fallback in native.py that specifies its output bit for bit.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// Octree fine-grid CSR build.
//
// For each primitive p in [0, P) with AABB (lo[p], hi[p]) and fine_mask[p],
// emit (linear cell, prim id) pairs for every RxRxR grid cell its AABB
// overlaps, then counting-sort into CSR (cell_offsets [R^3+1], cell_ids).
//
// Two-phase: count_pairs returns the total pair count so the caller can
// allocate exactly; fill_csr writes offsets and ids. Both are O(pairs).
// ---------------------------------------------------------------------------

static inline void cell_range(const float* lo, const float* hi,
                              const float* root_lo, float cell_sz, int R,
                              int* c_lo, int* c_hi) {
  for (int a = 0; a < 3; ++a) {
    float flo = std::floor((lo[a] - root_lo[a]) / cell_sz);
    float fhi = std::floor((hi[a] - root_lo[a]) / cell_sz - 1e-9f);
    int il = (int)flo, ih = (int)fhi;
    if (il < 0) il = 0; if (il > R - 1) il = R - 1;
    if (ih < 0) ih = 0; if (ih > R - 1) ih = R - 1;
    c_lo[a] = il; c_hi[a] = ih;
  }
}

// Returns total (cell, prim) pair count for fine-masked prims.
int64_t sk_count_pairs(const float* lo, const float* hi, const uint8_t* fine,
                       int64_t n_prims, const float* root_lo, float root_size,
                       int depth) {
  const int R = 1 << depth;
  const float cell_sz = root_size / (float)R;
  int64_t total = 0;
  for (int64_t p = 0; p < n_prims; ++p) {
    if (!fine[p]) continue;
    int cl[3], ch[3];
    cell_range(lo + 3 * p, hi + 3 * p, root_lo, cell_sz, R, cl, ch);
    total += (int64_t)(ch[0] - cl[0] + 1) * (ch[1] - cl[1] + 1) *
             (ch[2] - cl[2] + 1);
  }
  return total;
}

// Fills cell_offsets [R^3 + 1] (int32) and cell_ids [total_pairs] (int32).
// Returns max prims per cell (for the traversal's static inner bound),
// or -1 on overflow of int32 offsets.
int32_t sk_fill_csr(const float* lo, const float* hi, const uint8_t* fine,
                    int64_t n_prims, const float* root_lo, float root_size,
                    int depth, int32_t* cell_offsets, int32_t* cell_ids,
                    int64_t total_pairs) {
  const int R = 1 << depth;
  const int64_t n_cells = (int64_t)R * R * R;
  const float cell_sz = root_size / (float)R;
  if (total_pairs > INT32_MAX) return -1;

  // pass 1: counts
  std::vector<int32_t> count(n_cells, 0);
  for (int64_t p = 0; p < n_prims; ++p) {
    if (!fine[p]) continue;
    int cl[3], ch[3];
    cell_range(lo + 3 * p, hi + 3 * p, root_lo, cell_sz, R, cl, ch);
    for (int x = cl[0]; x <= ch[0]; ++x)
      for (int y = cl[1]; y <= ch[1]; ++y)
        for (int z = cl[2]; z <= ch[2]; ++z)
          count[((int64_t)x * R + y) * R + z]++;
  }
  // prefix sum
  int32_t max_per_cell = 0;
  int64_t acc = 0;
  cell_offsets[0] = 0;
  for (int64_t c = 0; c < n_cells; ++c) {
    if (count[c] > max_per_cell) max_per_cell = count[c];
    acc += count[c];
    cell_offsets[c + 1] = (int32_t)acc;
  }
  // pass 2: scatter (stable in prim order per cell)
  std::vector<int32_t> cursor(cell_offsets, cell_offsets + n_cells);
  for (int64_t p = 0; p < n_prims; ++p) {
    if (!fine[p]) continue;
    int cl[3], ch[3];
    cell_range(lo + 3 * p, hi + 3 * p, root_lo, cell_sz, R, cl, ch);
    for (int x = cl[0]; x <= ch[0]; ++x)
      for (int y = cl[1]; y <= ch[1]; ++y)
        for (int z = cl[2]; z <= ch[2]; ++z)
          cell_ids[cursor[((int64_t)x * R + y) * R + z]++] = (int32_t)p;
  }
  return max_per_cell;
}

// ---------------------------------------------------------------------------
// Covering levels (the get_covering_node_for_entity invariant,
// octree_entity.ts:60-79): deepest level whose aligned cell fully contains
// the AABB. Writes level [P] (int32) and cell [P,3] (int32).
// ---------------------------------------------------------------------------
void sk_covering_levels(const float* lo, const float* hi, int64_t n_prims,
                        const float* root_lo, float root_size, int max_depth,
                        int32_t* level, int32_t* cell) {
  for (int64_t p = 0; p < n_prims; ++p) {
    int best = 0;
    int best_cell[3] = {0, 0, 0};
    for (int l = max_depth; l >= 0; --l) {
      const int n = 1 << l;
      const float sz = root_size / (float)n;
      bool fits = true;
      int c[3];
      for (int a = 0; a < 3; ++a) {
        float rl = lo[3 * p + a] - root_lo[a];
        float rh = hi[3 * p + a] - root_lo[a];
        int ci = (int)std::floor(rl / sz);
        if (ci < 0) ci = 0; if (ci > n - 1) ci = n - 1;
        c[a] = ci;
        if (rh > (ci + 1) * sz + 1e-7f * root_size) { fits = false; break; }
      }
      if (fits) { best = l; best_cell[0] = c[0]; best_cell[1] = c[1];
                  best_cell[2] = c[2]; break; }
    }
    level[p] = best;
    cell[3 * p] = best_cell[0];
    cell[3 * p + 1] = best_cell[1];
    cell[3 * p + 2] = best_cell[2];
  }
}

// ---------------------------------------------------------------------------
// OBJ loader: v / f lines (triangulates polygon faces as a fan; 1-based and
// negative indices per the OBJ spec). Two-phase like the CSR build.
// Returns 0 on success.
// ---------------------------------------------------------------------------
int sk_obj_counts(const char* path, int64_t* n_verts, int64_t* n_tris) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  char line[4096];
  int64_t nv = 0, nt = 0;
  while (std::fgets(line, sizeof line, f)) {
    if (line[0] == 'v' && (line[1] == ' ' || line[1] == '\t')) nv++;
    else if (line[0] == 'f' && (line[1] == ' ' || line[1] == '\t')) {
      int corners = 0;
      char* s = line + 1;
      while (*s) {
        while (*s == ' ' || *s == '\t') ++s;
        if (*s == '\0' || *s == '\n' || *s == '\r') break;
        ++corners;
        while (*s && *s != ' ' && *s != '\t' && *s != '\n' && *s != '\r') ++s;
      }
      if (corners >= 3) nt += corners - 2;
    }
  }
  std::fclose(f);
  *n_verts = nv;
  *n_tris = nt;
  return 0;
}

int sk_obj_load(const char* path, float* verts /*[n_verts,3]*/,
                int32_t* faces /*[n_tris,3]*/, int64_t n_verts,
                int64_t n_tris) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  char line[4096];
  int64_t vi = 0, ti = 0;
  std::vector<int64_t> poly;
  while (std::fgets(line, sizeof line, f)) {
    if (line[0] == 'v' && (line[1] == ' ' || line[1] == '\t')) {
      if (vi >= n_verts) { std::fclose(f); return 2; }
      float x = 0, y = 0, z = 0;
      std::sscanf(line + 1, "%f %f %f", &x, &y, &z);
      verts[3 * vi] = x; verts[3 * vi + 1] = y; verts[3 * vi + 2] = z;
      ++vi;
    } else if (line[0] == 'f' && (line[1] == ' ' || line[1] == '\t')) {
      poly.clear();
      char* s = line + 1;
      while (*s) {
        while (*s == ' ' || *s == '\t') ++s;
        if (*s == '\0' || *s == '\n' || *s == '\r') break;
        long idx = std::strtol(s, &s, 10);      // vertex index before any '/'
        if (idx < 0) idx = vi + idx; else idx -= 1;   // negative = relative
        poly.push_back(idx);
        while (*s && *s != ' ' && *s != '\t' && *s != '\n' && *s != '\r') ++s;
      }
      for (size_t k = 2; k < poly.size(); ++k) {
        if (ti >= n_tris) { std::fclose(f); return 2; }
        faces[3 * ti] = (int32_t)poly[0];
        faces[3 * ti + 1] = (int32_t)poly[k - 1];
        faces[3 * ti + 2] = (int32_t)poly[k];
        ++ti;
      }
    }
  }
  std::fclose(f);
  return (vi == n_verts && ti == n_tris) ? 0 : 3;
}

}  // extern "C"
