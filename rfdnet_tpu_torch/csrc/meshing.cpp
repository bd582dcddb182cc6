// Host meshing of rfdnet_tpu_torch: the port's own copy of the marching
// cubes, the marching tetrahedra, the MISE octree, the sparse-replay
// marching cubes, the surface voxelizer and the ray-parity containment
// test `points_in_mesh` of rfdnet_tpu/meshing/src/meshing.cpp (same case
// table, scan order and vertex numbering, so both libraries give identical
// arrays on identical inputs when built with the same flags). Plain C
// interface, loaded with ctypes (rfdnet_tpu_torch/meshing/native.py).
// Vertices come back in grid-index space, welded along shared edges.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <limits>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct V3 {
  double x, y, z;
};

// ---------------------------------------------------------------- MC core
// True marching cubes. The 256 case tessellations are
// built programmatically instead of hard-coding the Lorensen tables:
// for every face, contiguous runs of inside vertices along the (outward-
// oriented) face cycle produce one directed surface segment from the run's
// entry crossing to its exit crossing; following the segments stitches the
// per-cube intersection loops, which are fan-triangulated. Per-face run
// pairing resolves the ambiguous (diagonal) faces identically for the two
// cubes sharing the face, so the result is watertight by construction —
// unlike the classic asymmetric table, which can leave pinholes there.
//
// Cube vertex encoding: v = dx*4 + dy*2 + dz over the unit cube.

namespace mc {

// 12 edges as vertex pairs
static const int EDGE_V[12][2] = {
    {0, 1}, {0, 2}, {0, 4}, {1, 3}, {1, 5}, {2, 3},
    {2, 6}, {3, 7}, {4, 5}, {4, 6}, {5, 7}, {6, 7}};

// faces as outward-CCW vertex cycles (normal points out of the cube)
static const int FACE_C[6][4] = {
    {0, 1, 3, 2},   // x = 0
    {4, 6, 7, 5},   // x = 1
    {0, 4, 5, 1},   // y = 0
    {2, 3, 7, 6},   // y = 1
    {0, 2, 6, 4},   // z = 0
    {1, 5, 7, 3}};  // z = 1

inline int edge_id(int a, int b) {
  for (int e = 0; e < 12; ++e)
    if ((EDGE_V[e][0] == a && EDGE_V[e][1] == b) ||
        (EDGE_V[e][0] == b && EDGE_V[e][1] == a))
      return e;
  return -1;
}

// per-mask loops of edge ids (built once, cached)
struct CaseTable {
  std::vector<std::vector<int>> loops[256];
};

// thread-safe lazy init (C++11 magic static): mc_extract may be called
// from several host threads at once (per-proposal extraction fan-out)
static const CaseTable &case_table() {
  static const CaseTable g_table = [] {
  CaseTable g_table;
  for (int mask = 1; mask < 255; ++mask) {
    int next_edge[12];
    bool has_seg[12] = {false};
    for (int e = 0; e < 12; ++e) next_edge[e] = -1;
    auto inside = [&](int v) { return (mask >> v) & 1; };
    for (int f = 0; f < 6; ++f) {
      const int *c = FACE_C[f];
      for (int i = 0; i < 4; ++i) {
        // run start: c[i] inside, c[i-1] outside
        if (!inside(c[i]) || inside(c[(i + 3) & 3])) continue;
        int entry = edge_id(c[(i + 3) & 3], c[i]);
        int j = i;
        while (inside(c[(j + 1) & 3])) j = (j + 1) & 3;
        int exit = edge_id(c[j], c[(j + 1) & 3]);
        next_edge[entry] = exit;  // directed segment entry -> exit
        has_seg[entry] = true;
      }
    }
    for (int e0 = 0; e0 < 12; ++e0) {
      if (!has_seg[e0]) continue;
      std::vector<int> loop;
      int e = e0;
      while (has_seg[e]) {
        loop.push_back(e);
        has_seg[e] = false;
        e = next_edge[e];
      }
      if (loop.size() >= 3) g_table.loops[mask].push_back(std::move(loop));
    }
  }
  return g_table;
  }();
  return g_table;
}

inline int edge_axis_of(int a, int b) {
  int d = a ^ b;           // cube-local corners differ in exactly one bit
  return d == 4 ? 0 : (d == 2 ? 1 : 2);  // v = dx*4 + dy*2 + dz
}

}  // namespace mc

// ------------------------------------------------------------- fast MC core
// Single-thread-speed machinery of the extractors:
//  - a direct-addressed edge->vertex cache (edges are (min corner, axis),
//    so the lookup is an O(1) array read, where a hash map would dominate
//    tessellation-heavy meshes),
//  - epoch stamps so the cache never needs clearing between proposals,
//  - bit-packed corner signs (one uint64 spans 64 lattice points along z)
//    with word-level uniform-cell skipping: a cell whose 8 corners agree
//    is eliminated 64 cells at a time instead of via 8 scalar loads.
// Cells are scanned in lexicographic order and vertices numbered at first
// encounter, which fixes the output arrays exactly.
namespace fastmc {

struct Scratch {
  std::vector<int32_t> edge_vid;
  std::vector<uint32_t> edge_epoch;
  uint32_t epoch = 0;
  std::vector<uint64_t> sgn;
  std::vector<float> val;    // MISE lattice values
  std::vector<uint8_t> kn;   // MISE known flags

  void begin(size_t n_edges) {
    if (edge_vid.size() < n_edges) {
      edge_vid.resize(n_edges);
      edge_epoch.assign(n_edges, 0);
      epoch = 0;
    }
    if (++epoch == 0) {  // stamp wraparound: clear once every 2^32 calls
      std::fill(edge_epoch.begin(), edge_epoch.end(), 0);
      epoch = 1;
    }
  }
};

static thread_local Scratch g_scratch;

struct Acc {
  std::vector<double> verts;
  std::vector<int> tris;
  Scratch *scr;

  // key = node_key(min corner) * 3 + axis
  inline int edge_vertex(size_t key, const V3 &pa, const V3 &pb, double va,
                         double vb, double iso) {
    if (scr->edge_epoch[key] == scr->epoch) return scr->edge_vid[key];
    double t = (iso - va) / (vb - va);
    if (!(t >= 0.0)) t = 0.0;
    if (!(t <= 1.0)) t = 1.0;
    int idx = (int)(verts.size() / 3);
    verts.push_back(pa.x + t * (pb.x - pa.x));
    verts.push_back(pa.y + t * (pb.y - pa.y));
    verts.push_back(pa.z + t * (pb.z - pa.z));
    scr->edge_epoch[key] = scr->epoch;
    scr->edge_vid[key] = idx;
    return idx;
  }
};

// per-edge (min local corner, axis), precomputed from mc::EDGE_V
struct EdgeMeta {
  int vmin[12];
  int axis[12];
  EdgeMeta() {
    for (int e = 0; e < 12; ++e) {
      int a = mc::EDGE_V[e][0], b = mc::EDGE_V[e][1];
      vmin[e] = a & b;  // corners differ in one bit -> AND is the min corner
      axis[e] = mc::edge_axis_of(a, b);
    }
  }
};
static const EdgeMeta g_edge_meta;

// Tessellate one mixed cell at (x, y, z) of a lattice with row strides
// (sy = side of y, sz = side of z). cv holds the 8 corner values in the
// dx*4+dy*2+dz order; the caller computed cmask.
inline void tess_cell(Acc &acc, int x, int y, int z, int ny, int nz,
                      const double cv[8], int cmask, double iso) {
  static const int CO[8][3] = {{0,0,0},{0,0,1},{0,1,0},{0,1,1},
                               {1,0,0},{1,0,1},{1,1,0},{1,1,1}};
  const auto &mc_table = mc::case_table();
  for (const auto &loop : mc_table.loops[cmask]) {
    int first = -1, prev = -1;
    for (size_t i = 0; i < loop.size(); ++i) {
      int e = loop[i];
      int a = mc::EDGE_V[e][0], b = mc::EDGE_V[e][1];
      int m = g_edge_meta.vmin[e];
      size_t corner_key =
          ((size_t)(x + CO[m][0]) * ny + (y + CO[m][1])) * nz + (z + CO[m][2]);
      size_t key = corner_key * 3 + g_edge_meta.axis[e];
      V3 pa{(double)(x + CO[a][0]), (double)(y + CO[a][1]),
            (double)(z + CO[a][2])};
      V3 pb{(double)(x + CO[b][0]), (double)(y + CO[b][1]),
            (double)(z + CO[b][2])};
      int vid = acc.edge_vertex(key, pa, pb, cv[a], cv[b], iso);
      if (i == 0) {
        first = vid;
      } else if (i >= 2) {
        acc.tris.push_back(first);
        acc.tris.push_back(prev);
        acc.tris.push_back(vid);
      }
      prev = vid;
    }
  }
}

// Scan all (nx-1, ny-1, nz-1) cells of a packed sign field, invoking
// `emit(x, y, z)` only on mixed-sign cells, in exact lexicographic order.
// sgn layout: (nx, ny, W) words, W = ceil(nz / 64), bit z of word z/64.
template <class Emit>
inline void scan_mixed(const uint64_t *sgn, int nx, int ny, int nz,
                       Emit &&emit) {
  const int W = (nz + 63) >> 6;
  for (int x = 0; x < nx - 1; ++x)
    for (int y = 0; y < ny - 1; ++y) {
      const uint64_t *r00 = sgn + ((size_t)x * ny + y) * W;
      const uint64_t *r01 = r00 + W;
      const uint64_t *r10 = r00 + (size_t)ny * W;
      const uint64_t *r11 = r10 + W;
      for (int w = 0; w < W; ++w) {
        int ncell = nz - 1 - (w << 6);  // valid cell bits in this word
        if (ncell <= 0) break;
        uint64_t o = r00[w] | r01[w] | r10[w] | r11[w];
        uint64_t a = r00[w] & r01[w] & r10[w] & r11[w];
        uint64_t o1, a1;
        if (w + 1 < W) {
          uint64_t on = r00[w + 1] | r01[w + 1] | r10[w + 1] | r11[w + 1];
          uint64_t an = r00[w + 1] & r01[w + 1] & r10[w + 1] & r11[w + 1];
          o1 = (o >> 1) | (on << 63);
          a1 = (a >> 1) | (an << 63);
        } else {
          o1 = o >> 1;
          a1 = a >> 1;
        }
        uint64_t mixed = ~((a & a1) | (~o & ~o1));
        if (ncell < 64) mixed &= ((uint64_t)1 << ncell) - 1;
        while (mixed) {
          int z = (w << 6) + __builtin_ctzll(mixed);
          mixed &= mixed - 1;
          emit(x, y, z);
        }
      }
    }
}

// Work-stealing parallel for over proposals. Thread count =
// RFDNET_MESH_THREADS env or hardware_concurrency, clamped to the job
// count — on a 1-core host this degrades to the plain serial loop with
// zero thread spawns. Each worker uses its own thread_local Scratch.
static int n_threads(int njobs) {
  const char *env = getenv("RFDNET_MESH_THREADS");
  int n = env ? atoi(env) : (int)std::thread::hardware_concurrency();
  if (n < 1) n = 1;
  if (n > njobs) n = njobs;
  return n;
}

template <class Fn>
static void parallel_for(int njobs, Fn &&fn) {
  int nt = n_threads(njobs);
  if (nt <= 1) {
    for (int i = 0; i < njobs; ++i) fn(i);
    return;
  }
  std::atomic<int> next{0};
  std::vector<std::thread> ts;
  ts.reserve(nt);
  for (int t = 0; t < nt; ++t)
    ts.emplace_back([&] {
      int i;
      while ((i = next.fetch_add(1)) < njobs) fn(i);
    });
  for (auto &t : ts) t.join();
}

// Batch result: per-proposal meshes kept in their Acc storage (no
// concatenation memcpy); the caller reads each proposal's buffers
// through batch_mesh_get and frees the whole thing once.
struct BatchResult {
  std::vector<Acc> accs;
};

}  // namespace fastmc

// ------------------------------------------------------------------- MISE
// Multi-resolution iso-surface extraction octree (the role of the
// reference's libmise). The Python lock-step loop (meshing/mise.py,
// `mise_value_grids`) owns one handle per proposal; the bookkeeping
// (frontier advance, ancestor fill) runs here.
// Semantics are identical to the Python MISE class: query() returns the
// unknown lattice points in lexicographic order (matching np.unique), a
// voxel subdivides iff all 8 corners are known and their signs are mixed,
// and to_dense() fills unknowns from the coarsest known floor-aligned
// ancestor, level by level.

struct MiseTree {
  int res0, depth, R, level;
  double threshold;
  std::vector<double> values;  // (R+1)^3, NaN = unknown
  std::vector<int64_t> pending;  // flat lattice ids, ascending

  inline size_t id(int64_t x, int64_t y, int64_t z) const {
    return ((size_t)x * (R + 1) + y) * (R + 1) + z;
  }
  inline bool known(size_t i) const { return !std::isnan(values[i]); }

  MiseTree(int r0, int d, double thr)
      : res0(r0), depth(d), R(r0 << d), level(0), threshold(thr),
        values(((size_t)R + 1) * (R + 1) * (R + 1),
               std::numeric_limits<double>::quiet_NaN()) {
    int64_t step = (int64_t)1 << depth;
    for (int64_t x = 0; x <= R; x += step)
      for (int64_t y = 0; y <= R; y += step)
        for (int64_t z = 0; z <= R; z += step)
          pending.push_back((int64_t)id(x, y, z));
  }

  void advance() {
    if (level >= depth) {
      pending.clear();
      return;
    }
    int64_t s = (int64_t)1 << (depth - level);  // voxel edge at this level
    int64_t n = R / s, h = s / 2;
    std::vector<int64_t> next;
    for (int64_t i = 0; i < n; ++i)
      for (int64_t j = 0; j < n; ++j)
        for (int64_t k = 0; k < n; ++k) {
          int occ = 0, kn = 0;
          for (int dx = 0; dx <= 1; ++dx)
            for (int dy = 0; dy <= 1; ++dy)
              for (int dz = 0; dz <= 1; ++dz) {
                size_t c = id((i + dx) * s, (j + dy) * s, (k + dz) * s);
                if (known(c)) {
                  ++kn;
                  if (values[c] >= threshold) ++occ;
                }
              }
          if (kn == 8 && occ > 0 && occ < 8) {
            // queue the unknown points of the voxel's 3x3x3 half-stride
            // child lattice
            for (int64_t a = 0; a <= 2; ++a)
              for (int64_t b = 0; b <= 2; ++b)
                for (int64_t c = 0; c <= 2; ++c) {
                  size_t p =
                      id(i * s + a * h, j * s + b * h, k * s + c * h);
                  if (!known(p)) next.push_back((int64_t)p);
                }
          }
        }
    std::sort(next.begin(), next.end());
    next.erase(std::unique(next.begin(), next.end()), next.end());
    pending.swap(next);
    ++level;
    if (pending.empty() && level < depth) advance();
  }

  void to_dense(float *out) const {
    std::vector<double> v(values);
    for (int lvl = 0; lvl < depth; ++lvl) {
      int64_t s = (int64_t)1 << (depth - lvl), h = s / 2;
      for (int64_t x = 0; x <= R; x += h)
        for (int64_t y = 0; y <= R; y += h)
          for (int64_t z = 0; z <= R; z += h) {
            size_t p = id(x, y, z);
            if (std::isnan(v[p]))
              v[p] = v[id(x / s * s, y / s * s, z / s * s)];
          }
    }
    for (size_t i = 0; i < v.size(); ++i) out[i] = (float)v[i];
  }
};

// One dense grid, implicitly padded with pad_val (no padded copy),
// marching cubes into `acc`; vertices in padded index space.
void mc_one_padded(const float *grid, int nx, int ny, int nz, double iso,
                   float pad_val, fastmc::Acc &acc) {
  const int PX = nx + 2, PY = ny + 2, PZ = nz + 2;
  fastmc::Scratch &scr = fastmc::g_scratch;
  acc.scr = &scr;
  scr.begin((size_t)PX * PY * PZ * 3);
  const int W = (PZ + 63) >> 6;
  const bool pad_in = (double)pad_val > iso;
  std::vector<uint64_t> pad_word(W);
  for (int w = 0; w < W; ++w) {
    int nbits = PZ - (w << 6);
    uint64_t m = nbits >= 64 ? ~(uint64_t)0
                             : (((uint64_t)1 << (nbits < 0 ? 0 : nbits)) - 1);
    pad_word[w] = pad_in ? m : 0;
  }
  scr.sgn.assign((size_t)PX * PY * W, 0);
  for (int x = 0; x < PX; x += PX - 1)
    for (int y = 0; y < PY; ++y) {
      uint64_t *out = &scr.sgn[((size_t)x * PY + y) * W];
      for (int w = 0; w < W; ++w) out[w] = pad_word[w];
    }
  for (int y = 0; y < PY; y += PY - 1)
    for (int x = 1; x < PX - 1; ++x) {
      uint64_t *out = &scr.sgn[((size_t)x * PY + y) * W];
      for (int w = 0; w < W; ++w) out[w] = pad_word[w];
    }
  for (int x = 0; x < nx; ++x)
    for (int y = 0; y < ny; ++y) {
      const float *row = grid + ((size_t)x * ny + y) * nz;
      uint64_t *out = &scr.sgn[((size_t)(x + 1) * PY + (y + 1)) * W];
      if (pad_in) {
        out[0] |= 1;
        out[(PZ - 1) >> 6] |= (uint64_t)1 << ((PZ - 1) & 63);
      }
      for (int z = 0; z < nz; ++z)
        if ((double)row[z] > iso) {
          int bit = z + 1;
          out[bit >> 6] |= (uint64_t)1 << (bit & 63);
        }
    }
  auto val_at = [&](int x, int y, int z) -> double {
    if (x == 0 || y == 0 || z == 0 || x == PX - 1 || y == PY - 1 ||
        z == PZ - 1)
      return (double)pad_val;
    return (double)grid[((size_t)(x - 1) * ny + (y - 1)) * nz + (z - 1)];
  };
  mc::case_table();
  static const int CO[8][3] = {{0,0,0},{0,0,1},{0,1,0},{0,1,1},
                               {1,0,0},{1,0,1},{1,1,0},{1,1,1}};
  fastmc::scan_mixed(
      scr.sgn.data(), PX, PY, PZ, [&](int x, int y, int z) {
        double cv[8];
        int cmask = 0;
        for (int c = 0; c < 8; ++c) {
          cv[c] = val_at(x + CO[c][0], y + CO[c][1], z + CO[c][2]);
          if (cv[c] > iso) cmask |= 1 << c;
        }
        fastmc::tess_cell(acc, x, y, z, PY, PZ, cv, cmask, iso);
      });
}

// One proposal's sparse-replay marching cubes into `acc` (see
// mise_mc_extract's contract). The final ancestor-fill level (h=1, which
// visits every lattice point) is FUSED with the packed-sign build so the
// lattice is swept once instead of twice.
void mise_one(const float *lvl0, int res0, int steps, const int32_t *idx,
              const float *vals, const int32_t *level_counts, double iso,
              float pad_val, fastmc::Acc &acc) {
  const int R = res0 << steps;
  const int R1 = R + 1;
  const size_t n_lat = (size_t)R1 * R1 * R1;
  fastmc::Scratch &scr = fastmc::g_scratch;
  acc.scr = &scr;
  std::vector<float> &val = scr.val;
  std::vector<uint8_t> &kn = scr.kn;
  val.resize(n_lat);
  kn.assign(n_lat, 0);
  auto lat = [R1](int x, int y, int z) {
    return ((size_t)x * R1 + y) * R1 + z;
  };

  // ---- scatter level 0
  const int n01 = res0 + 1;
  for (int x = 0; x <= res0; ++x)
    for (int y = 0; y <= res0; ++y) {
      float *row = &val[lat(x << steps, y << steps, 0)];
      uint8_t *krow = &kn[lat(x << steps, y << steps, 0)];
      const float *src = lvl0 + ((size_t)x * n01 + y) * n01;
      for (int z = 0; z <= res0; ++z) {
        row[(size_t)z << steps] = src[z];
        krow[(size_t)z << steps] = 1;
      }
    }

  // ---- scatter refinement levels
  const int32_t *idx_l = idx;
  const float *vals_l = vals;
  for (int l = 0; l < steps; ++l) {
    const int s = 1 << (steps - l), h = s >> 1;
    const int off[3] = {0, h, s};
    const int64_t n = (int64_t)res0 << l;
    const int m = level_counts[l];
    for (int e = 0; e < m; ++e) {
      int64_t v = idx_l[e];
      int bi = (int)(v / (n * n)) * s;
      int bj = (int)((v / n) % n) * s;
      int bk = (int)(v % n) * s;
      const float *w = vals_l + (size_t)e * 27;
      int q = 0;
      for (int a = 0; a <= 2; ++a)
        for (int b = 0; b <= 2; ++b)
          for (int c = 0; c <= 2; ++c, ++q) {
            size_t p = lat(bi + off[a], bj + off[b], bk + off[c]);
            val[p] = w[q];
            kn[p] = 1;
          }
    }
    idx_l += m;
    vals_l += (size_t)m * 27;
  }

  // ---- packed corner signs over the padded lattice
  const int P = R + 3;  // padded lattice side
  scr.begin((size_t)P * P * P * 3);
  const int W = (P + 63) >> 6;
  const bool pad_in = (double)pad_val > iso;
  std::vector<uint64_t> pad_word(W);
  for (int w = 0; w < W; ++w) {
    int nbits = P - (w << 6);
    uint64_t m = nbits >= 64 ? ~(uint64_t)0
                             : (((uint64_t)1 << (nbits < 0 ? 0 : nbits)) - 1);
    pad_word[w] = pad_in ? m : 0;
  }
  scr.sgn.assign((size_t)P * P * W, 0);
  // pad boundary rows (x or y on the pad layer): whole row = pad sign
  for (int x = 0; x < P; x += P - 1)
    for (int y = 0; y < P; ++y) {
      uint64_t *out = &scr.sgn[((size_t)x * P + y) * W];
      for (int w = 0; w < W; ++w) out[w] = pad_word[w];
    }
  for (int y = 0; y < P; y += P - 1)
    for (int x = 1; x < P - 1; ++x) {
      uint64_t *out = &scr.sgn[((size_t)x * P + y) * W];
      for (int w = 0; w < W; ++w) out[w] = pad_word[w];
    }

  // ---- ancestor fill (exact replay of the device to_dense rule; the
  // stride floors are masks since s is a power of two). Levels before
  // the last touch sub-lattices; the LAST level (h=1) visits every
  // point, so the packed-sign build rides the same sweep.
  for (int l = 0; l + 1 < steps; ++l) {
    const int s = 1 << (steps - l), h = s >> 1;
    const int m = ~(s - 1);
    for (int x = 0; x <= R; x += h) {
      const size_t ax = lat(x & m, 0, 0);
      for (int y = 0; y <= R; y += h) {
        const size_t axy = ax + (size_t)(y & m) * R1;
        float *row = &val[lat(x, y, 0)];
        uint8_t *krow = &kn[lat(x, y, 0)];
        const float *arow = &val[axy];
        for (int z = 0; z <= R; z += h)
          if (!krow[z]) {
            row[z] = arow[z & m];
            krow[z] = 1;
          }
      }
    }
  }
  if (steps >= 1) {
    // last fill level (s=2) fused with sign packing; kn stores skipped
    // (nothing reads kn afterwards)
    for (int x = 0; x <= R; ++x) {
      const size_t ax = lat(x & ~1, 0, 0);
      for (int y = 0; y <= R; ++y) {
        float *row = &val[lat(x, y, 0)];
        const uint8_t *krow = &kn[lat(x, y, 0)];
        const float *arow = &val[ax + (size_t)(y & ~1) * R1];
        uint64_t *out = &scr.sgn[((size_t)(x + 1) * P + (y + 1)) * W];
        if (pad_in) {
          out[0] |= 1;
          out[(P - 1) >> 6] |= (uint64_t)1 << ((P - 1) & 63);
        }
        for (int z = 0; z <= R; ++z) {
          float v = krow[z] ? row[z] : (row[z] = arow[z & ~1]);
          if ((double)v > iso) {
            int bit = z + 1;
            out[bit >> 6] |= (uint64_t)1 << (bit & 63);
          }
        }
      }
    }
  } else {
    // steps == 0: the lattice is fully known; pack directly
    for (int x = 0; x <= R; ++x)
      for (int y = 0; y <= R; ++y) {
        const float *row = &val[lat(x, y, 0)];
        uint64_t *out = &scr.sgn[((size_t)(x + 1) * P + (y + 1)) * W];
        if (pad_in) {
          out[0] |= 1;
          out[(P - 1) >> 6] |= (uint64_t)1 << ((P - 1) & 63);
        }
        for (int z = 0; z <= R; ++z)
          if ((double)row[z] > iso) {
            int bit = z + 1;
            out[bit >> 6] |= (uint64_t)1 << (bit & 63);
          }
      }
  }

  // ---- marching cubes over the padded cells, lexicographic order
  auto val_at = [&](int x, int y, int z) -> double {
    if (x == 0 || y == 0 || z == 0 || x == P - 1 || y == P - 1 ||
        z == P - 1)
      return (double)pad_val;
    return (double)val[lat(x - 1, y - 1, z - 1)];
  };
  mc::case_table();
  static const int CO[8][3] = {{0,0,0},{0,0,1},{0,1,0},{0,1,1},
                               {1,0,0},{1,0,1},{1,1,0},{1,1,1}};
  fastmc::scan_mixed(
      scr.sgn.data(), P, P, P, [&](int x, int y, int z) {
        double cv[8];
        int cmask = 0;
        for (int c = 0; c < 8; ++c) {
          cv[c] = val_at(x + CO[c][0], y + CO[c][1], z + CO[c][2]);
          if (cv[c] > iso) cmask |= 1 << c;
        }
        fastmc::tess_cell(acc, x, y, z, P, P, cv, cmask, iso);
      });
}

// ---------------------------------------------------------------- MT core
struct MeshAcc {
  std::vector<double> verts;
  std::vector<int> tris;
  std::unordered_map<uint64_t, int> edge_cache;

  int edge_vertex(uint64_t key_a, uint64_t key_b, const V3 &pa, const V3 &pb,
                  double va, double vb, double iso) {
    uint64_t key = key_a < key_b ? (key_a << 32) | key_b : (key_b << 32) | key_a;
    auto it = edge_cache.find(key);
    if (it != edge_cache.end()) return it->second;
    double t = (iso - va) / (vb - va);
    if (!(t >= 0.0)) t = 0.0;
    if (!(t <= 1.0)) t = 1.0;
    int idx = (int)(verts.size() / 3);
    verts.push_back(pa.x + t * (pb.x - pa.x));
    verts.push_back(pa.y + t * (pb.y - pa.y));
    verts.push_back(pa.z + t * (pb.z - pa.z));
    edge_cache.emplace(key, idx);
    return idx;
  }
};

inline uint64_t node_key(int x, int y, int z, int ny, int nz) {
  return ((uint64_t)x * ny + y) * nz + z;
}

void do_tetra(MeshAcc &acc, const uint64_t keys[4], const V3 pos[4],
              const double val[4], double iso) {
  int mask = 0;
  for (int i = 0; i < 4; ++i)
    if (val[i] > iso) mask |= 1 << i;
  if (mask == 0 || mask == 15) return;

  auto ev = [&](int a, int b) {
    return acc.edge_vertex(keys[a], keys[b], pos[a], pos[b], val[a], val[b], iso);
  };
  auto tri = [&](int a, int b, int c) {
    acc.tris.push_back(a);
    acc.tris.push_back(b);
    acc.tris.push_back(c);
  };

  switch (mask) {
    case 1: tri(ev(0,1), ev(0,2), ev(0,3)); break;
    case 14: tri(ev(0,1), ev(0,3), ev(0,2)); break;
    case 2: tri(ev(1,0), ev(1,3), ev(1,2)); break;
    case 13: tri(ev(1,0), ev(1,2), ev(1,3)); break;
    case 4: tri(ev(2,0), ev(2,1), ev(2,3)); break;
    case 11: tri(ev(2,0), ev(2,3), ev(2,1)); break;
    case 8: tri(ev(3,0), ev(3,2), ev(3,1)); break;
    case 7: tri(ev(3,0), ev(3,1), ev(3,2)); break;
    case 3:  // 0,1 inside
      tri(ev(0,2), ev(1,3), ev(0,3));
      tri(ev(0,2), ev(1,2), ev(1,3));
      break;
    case 12:
      tri(ev(0,2), ev(0,3), ev(1,3));
      tri(ev(0,2), ev(1,3), ev(1,2));
      break;
    case 5:  // 0,2 inside
      tri(ev(0,1), ev(0,3), ev(2,3));
      tri(ev(0,1), ev(2,3), ev(2,1));
      break;
    case 10:
      tri(ev(0,1), ev(2,3), ev(0,3));
      tri(ev(0,1), ev(2,1), ev(2,3));
      break;
    case 9:  // 0,3 inside
      tri(ev(0,1), ev(1,3), ev(2,3));
      tri(ev(0,1), ev(2,3), ev(0,2));
      break;
    case 6:
      tri(ev(0,1), ev(2,3), ev(1,3));
      tri(ev(0,1), ev(0,2), ev(2,3));
      break;
  }
}

}  // namespace

extern "C" {

// Table-based marching cubes over a dense (nx, ny, nz) float32 grid
// (C order, z fastest). Vertices in index space; shared-edge vertex dedup
// through the edge cache, so the output is vertex-welded.
int mc_extract(const float *grid, int nx, int ny, int nz, float iso,
               double **out_verts, int **out_tris, int *out_nv, int *out_nt) {
  mc::case_table();  // materialize before any cells emit
  fastmc::Scratch &scr = fastmc::g_scratch;
  scr.begin((size_t)nx * ny * nz * 3);
  fastmc::Acc acc;
  acc.scr = &scr;
  // packed corner signs: one uint64 covers 64 lattice points along z
  const int W = (nz + 63) >> 6;
  scr.sgn.assign((size_t)nx * ny * W, 0);
  for (int x = 0; x < nx; ++x)
    for (int y = 0; y < ny; ++y) {
      const float *row = grid + ((size_t)x * ny + y) * nz;
      uint64_t *out = &scr.sgn[((size_t)x * ny + y) * W];
      for (int z = 0; z < nz; ++z)
        if ((double)row[z] > iso) out[z >> 6] |= (uint64_t)1 << (z & 63);
    }
  static const int CO[8][3] = {{0,0,0},{0,0,1},{0,1,0},{0,1,1},
                               {1,0,0},{1,0,1},{1,1,0},{1,1,1}};
  fastmc::scan_mixed(
      scr.sgn.data(), nx, ny, nz, [&](int x, int y, int z) {
        double cv[8];
        int cmask = 0;
        for (int c = 0; c < 8; ++c) {
          cv[c] = (double)grid[((size_t)(x + CO[c][0]) * ny + (y + CO[c][1]))
                                   * nz + (z + CO[c][2])];
          if (cv[c] > iso) cmask |= 1 << c;
        }
        fastmc::tess_cell(acc, x, y, z, ny, nz, cv, cmask, iso);
      });
  *out_nv = (int)(acc.verts.size() / 3);
  *out_nt = (int)(acc.tris.size() / 3);
  double *v = new double[acc.verts.size()];
  int *t = new int[acc.tris.size()];
  std::memcpy(v, acc.verts.data(), acc.verts.size() * sizeof(double));
  std::memcpy(t, acc.tris.data(), acc.tris.size() * sizeof(int));
  *out_verts = v;
  *out_tris = t;
  return 0;
}

// Marching tetrahedra over a dense (nx, ny, nz) float32 grid (C order,
// z fastest). Vertices come back in index space [0, n-1]. Two-call-free
// interface: the library owns the buffers until mesh_free.
int mt_extract(const float *grid, int nx, int ny, int nz, float iso,
               double **out_verts, int **out_tris, int *out_nv, int *out_nt) {
  MeshAcc acc;
  auto val_at = [&](int x, int y, int z) {
    return (double)grid[((size_t)x * ny + y) * nz + z];
  };
  // corner offsets in c = dx*4 + dy*2 + dz encoding
  static const int CO[8][3] = {{0,0,0},{0,0,1},{0,1,0},{0,1,1},
                               {1,0,0},{1,0,1},{1,1,0},{1,1,1}};
  // 6-tetra split of the cube around main diagonal 0-7
  static const int TET[6][4] = {
      {0,7,3,1},{0,7,1,5},{0,7,5,4},{0,7,4,6},{0,7,6,2},{0,7,2,3}};
  for (int x = 0; x < nx - 1; ++x)
    for (int y = 0; y < ny - 1; ++y)
      for (int z = 0; z < nz - 1; ++z) {
        double cv[8];
        uint64_t ck[8];
        V3 cp[8];
        bool any_in = false, any_out = false;
        for (int c = 0; c < 8; ++c) {
          int cx = x + CO[c][0], cy = y + CO[c][1], cz = z + CO[c][2];
          cv[c] = val_at(cx, cy, cz);
          ck[c] = node_key(cx, cy, cz, ny, nz);
          cp[c] = V3{(double)cx, (double)cy, (double)cz};
          (cv[c] > iso ? any_in : any_out) = true;
        }
        if (!any_in || !any_out) continue;
        for (int t = 0; t < 6; ++t) {
          uint64_t keys[4];
          V3 pos[4];
          double val[4];
          for (int i = 0; i < 4; ++i) {
            keys[i] = ck[TET[t][i]];
            pos[i] = cp[TET[t][i]];
            val[i] = cv[TET[t][i]];
          }
          do_tetra(acc, keys, pos, val, iso);
        }
      }
  *out_nv = (int)(acc.verts.size() / 3);
  *out_nt = (int)(acc.tris.size() / 3);
  double *v = new double[acc.verts.size()];
  int *t = new int[acc.tris.size()];
  std::memcpy(v, acc.verts.data(), acc.verts.size() * sizeof(double));
  std::memcpy(t, acc.tris.data(), acc.tris.size() * sizeof(int));
  *out_verts = v;
  *out_tris = t;
  return 0;
}

void mesh_free(double *verts, int *tris) {
  delete[] verts;
  delete[] tris;
}

// Batched padded marching cubes over n dense (nx, ny, nz) grids: each is
// conceptually padded with one pad_val layer per side (the -1e6 boundary
// close of `Generator3D`) without materializing the padded copy; vertices
// come back in padded index space, byte-identical to mc_extract over
// np.pad(grid, 1, constant_values=pad_val). Proposals fan out over the
// worker pool (fastmc::parallel_for, serial on a 1-core host); invalid proposals (valid=NULL or (n,) uint8) produce empty meshes.
// Returns a handle: read each proposal's buffers with batch_mesh_get
// (zero-copy views into the result), free once with batch_result_free.
void *mc_extract_batch(const float *grids, int n, int nx, int ny, int nz,
                       float iso, float pad_val, const uint8_t *valid,
                       int32_t *nv_per, int32_t *nt_per) {
  mc::case_table();
  auto *res = new fastmc::BatchResult;
  res->accs.resize(n);
  fastmc::parallel_for(n, [&](int i) {
    if (valid && !valid[i]) return;
    mc_one_padded(grids + (size_t)i * nx * ny * nz, nx, ny, nz, iso,
                  pad_val, res->accs[i]);
  });
  for (int i = 0; i < n; ++i) {
    nv_per[i] = (int32_t)(res->accs[i].verts.size() / 3);
    nt_per[i] = (int32_t)(res->accs[i].tris.size() / 3);
  }
  return res;
}

// Single-proposal implicitly-padded marching cubes (the per-proposal
// fast path on 1-core hosts: no np.pad copy, warm allocator reuse —
// batching keeps 64 growing result vectors live at once, whose cold
// first-touch pages cost more than the saved call overhead there).
int mc_extract_padded(const float *grid, int nx, int ny, int nz, float iso,
                      float pad_val, double **out_verts, int **out_tris,
                      int *out_nv, int *out_nt) {
  fastmc::Acc acc;
  mc_one_padded(grid, nx, ny, nz, iso, pad_val, acc);
  *out_nv = (int)(acc.verts.size() / 3);
  *out_nt = (int)(acc.tris.size() / 3);
  double *ov = new double[acc.verts.size()];
  int *ot = new int[acc.tris.size()];
  std::memcpy(ov, acc.verts.data(), acc.verts.size() * sizeof(double));
  std::memcpy(ot, acc.tris.data(), acc.tris.size() * sizeof(int));
  *out_verts = ov;
  *out_tris = ot;
  return 0;
}

// Worker-pool width the batch entries would use (lets the caller pick
// batch vs per-proposal dispatch).
int mesh_threads(int njobs) { return fastmc::n_threads(njobs); }

// Zero-copy views into one proposal's mesh inside a batch result.
void batch_mesh_get(void *h, int i, double **verts, int **tris) {
  auto &acc = ((fastmc::BatchResult *)h)->accs[i];
  *verts = acc.verts.data();
  *tris = acc.tris.data();
}

void batch_result_free(void *h) { delete (fastmc::BatchResult *)h; }

// ------------------------------------------------------------ voxelizer
// Triangle/AABB SAT overlap (the tribox2.h test of `external/libvoxelize`,
// reimplemented from the separating-axis theorem).
static bool tri_box_overlap(const double c[3], const double h[3],
                            const double tv[3][3]) {
  // tolerance against rounding on exactly-touching geometry (axis-aligned
  // faces landing on voxel boundaries reject by ~1e-17 otherwise)
  const double eps = 1e-9 * (h[0] + h[1] + h[2]);
  double v[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) v[i][j] = tv[i][j] - c[j];
  double e[3][3];
  for (int j = 0; j < 3; ++j) {
    e[0][j] = v[1][j] - v[0][j];
    e[1][j] = v[2][j] - v[1][j];
    e[2][j] = v[0][j] - v[2][j];
  }
  // 9 cross-product axes
  for (int i = 0; i < 3; ++i) {
    for (int a = 0; a < 3; ++a) {
      int a1 = (a + 1) % 3, a2 = (a + 2) % 3;
      // axis = cross(unit_a, e_i) -> components: axis[a]=0,
      // axis[a1]=-e[i][a2], axis[a2]=e[i][a1]
      double p0 = -e[i][a2] * v[0][a1] + e[i][a1] * v[0][a2];
      double p1 = -e[i][a2] * v[1][a1] + e[i][a1] * v[1][a2];
      double p2 = -e[i][a2] * v[2][a1] + e[i][a1] * v[2][a2];
      double mn = std::min(p0, std::min(p1, p2));
      double mx = std::max(p0, std::max(p1, p2));
      double rad = h[a1] * std::fabs(e[i][a2]) + h[a2] * std::fabs(e[i][a1]);
      if (mn > rad + eps || mx < -rad - eps) return false;
    }
  }
  // box face normals
  for (int j = 0; j < 3; ++j) {
    double mn = std::min(v[0][j], std::min(v[1][j], v[2][j]));
    double mx = std::max(v[0][j], std::max(v[1][j], v[2][j]));
    if (mn > h[j] + eps || mx < -h[j] - eps) return false;
  }
  // triangle normal
  double n[3] = {e[0][1] * e[1][2] - e[0][2] * e[1][1],
                 e[0][2] * e[1][0] - e[0][0] * e[1][2],
                 e[0][0] * e[1][1] - e[0][1] * e[1][0]};
  double d = -(n[0] * v[0][0] + n[1] * v[0][1] + n[2] * v[0][2]);
  double r = h[0] * std::fabs(n[0]) + h[1] * std::fabs(n[1]) +
             h[2] * std::fabs(n[2]);
  double s = n[0] * 0 + n[1] * 0 + n[2] * 0 + d;  // plane at box center
  return std::fabs(s) <= r + eps;
}

// Surface-voxelize a triangle mesh into a (nx, ny, nz) uint8 grid.
// Cell (i,j,k) spans origin + [i,i+1)*voxel_size etc.
void voxelize_surface(const double *verts, int nv, const int *tris, int nt,
                      const double *origin, double voxel_size, int nx, int ny,
                      int nz, uint8_t *out) {
  (void)nv;
  for (int t = 0; t < nt; ++t) {
    double tv[3][3];
    double mn[3] = {1e30, 1e30, 1e30}, mx[3] = {-1e30, -1e30, -1e30};
    for (int i = 0; i < 3; ++i) {
      const double *p = verts + 3 * tris[3 * t + i];
      for (int j = 0; j < 3; ++j) {
        tv[i][j] = p[j];
        mn[j] = std::min(mn[j], p[j]);
        mx[j] = std::max(mx[j], p[j]);
      }
    }
    int lo[3], hi[3];
    const int dims[3] = {nx, ny, nz};
    for (int j = 0; j < 3; ++j) {
      lo[j] = std::max(0, (int)std::floor((mn[j] - origin[j]) / voxel_size));
      hi[j] = std::min(dims[j] - 1,
                       (int)std::floor((mx[j] - origin[j]) / voxel_size));
    }
    double hs[3] = {voxel_size / 2, voxel_size / 2, voxel_size / 2};
    for (int i = lo[0]; i <= hi[0]; ++i)
      for (int j = lo[1]; j <= hi[1]; ++j)
        for (int k = lo[2]; k <= hi[2]; ++k) {
          size_t idx = ((size_t)i * ny + j) * nz + k;
          if (out[idx]) continue;
          double c[3] = {origin[0] + (i + 0.5) * voxel_size,
                         origin[1] + (j + 0.5) * voxel_size,
                         origin[2] + (k + 0.5) * voxel_size};
          if (tri_box_overlap(c, hs, tv)) out[idx] = 1;
        }
  }
}

// Mark interior cells: flood-fill the exterior from the boundary through
// non-surface cells; everything not reached and not surface is interior.
void fill_interior(const uint8_t *surface, int nx, int ny, int nz,
                   uint8_t *interior) {
  size_t n = (size_t)nx * ny * nz;
  std::vector<uint8_t> outside(n, 0);
  std::deque<int64_t> queue;
  auto idx_of = [&](int x, int y, int z) {
    return ((int64_t)x * ny + y) * nz + z;
  };
  auto push = [&](int x, int y, int z) {
    if (x < 0 || y < 0 || z < 0 || x >= nx || y >= ny || z >= nz) return;
    int64_t i = idx_of(x, y, z);
    if (outside[i] || surface[i]) return;
    outside[i] = 1;
    queue.push_back(i);
  };
  for (int x = 0; x < nx; ++x)
    for (int y = 0; y < ny; ++y) {
      push(x, y, 0);
      push(x, y, nz - 1);
    }
  for (int x = 0; x < nx; ++x)
    for (int z = 0; z < nz; ++z) {
      push(x, 0, z);
      push(x, ny - 1, z);
    }
  for (int y = 0; y < ny; ++y)
    for (int z = 0; z < nz; ++z) {
      push(0, y, z);
      push(nx - 1, y, z);
    }
  while (!queue.empty()) {
    int64_t i = queue.front();
    queue.pop_front();
    int z = (int)(i % nz), y = (int)((i / nz) % ny), x = (int)(i / ((int64_t)ny * nz));
    push(x + 1, y, z);
    push(x - 1, y, z);
    push(x, y + 1, z);
    push(x, y - 1, z);
    push(x, y, z + 1);
    push(x, y, z - 1);
  }
  for (size_t i = 0; i < n; ++i)
    interior[i] = (!outside[i] && !surface[i]) ? 1 : 0;
}

// Point-in-mesh by +z ray-crossing parity, with a 2D cell grid over (x, y)
// of max(8, sqrt(nt)) cells a side (at most 512) holding each triangle's
// (x, y) box. The point is jittered by (3.1e-7, 1.7e-7) so that a ray
// through a lattice-aligned point misses shared edges and vertices, which
// would otherwise count one crossing twice.
void points_in_mesh(const double *verts, int nv, const int *tris, int nt,
                    const double *points, int np, uint8_t *out) {
  (void)nv;
  double mn[2] = {1e30, 1e30}, mx[2] = {-1e30, -1e30};
  for (int t = 0; t < nt; ++t)
    for (int i = 0; i < 3; ++i) {
      const double *p = verts + 3 * tris[3 * t + i];
      for (int j = 0; j < 2; ++j) {
        mn[j] = std::min(mn[j], p[j]);
        mx[j] = std::max(mx[j], p[j]);
      }
    }
  int res = std::max(8, (int)std::sqrt((double)nt));
  res = std::min(res, 512);
  double sx = (mx[0] - mn[0]) / res + 1e-12, sy = (mx[1] - mn[1]) / res + 1e-12;
  std::vector<std::vector<int>> cells((size_t)res * res);
  auto cell_of = [&](double x, double y, int &cx, int &cy) {
    cx = (int)((x - mn[0]) / sx);
    cy = (int)((y - mn[1]) / sy);
  };
  for (int t = 0; t < nt; ++t) {
    double tmn[2] = {1e30, 1e30}, tmx[2] = {-1e30, -1e30};
    for (int i = 0; i < 3; ++i) {
      const double *p = verts + 3 * tris[3 * t + i];
      for (int j = 0; j < 2; ++j) {
        tmn[j] = std::min(tmn[j], p[j]);
        tmx[j] = std::max(tmx[j], p[j]);
      }
    }
    int c0x, c0y, c1x, c1y;
    cell_of(tmn[0], tmn[1], c0x, c0y);
    cell_of(tmx[0], tmx[1], c1x, c1y);
    for (int cx = std::max(0, c0x); cx <= std::min(res - 1, c1x); ++cx)
      for (int cy = std::max(0, c0y); cy <= std::min(res - 1, c1y); ++cy)
        cells[(size_t)cx * res + cy].push_back(t);
  }
  for (int p = 0; p < np; ++p) {
    double x = points[3 * p] + 3.1e-7, y = points[3 * p + 1] + 1.7e-7,
           z = points[3 * p + 2];
    out[p] = 0;
    if (x < mn[0] || x > mx[0] || y < mn[1] || y > mx[1]) continue;
    int cx, cy;
    cell_of(x, y, cx, cy);
    if (cx < 0 || cy < 0 || cx >= res || cy >= res) continue;
    int crossings = 0;
    for (int t : cells[(size_t)cx * res + cy]) {
      const double *a = verts + 3 * tris[3 * t];
      const double *b = verts + 3 * tris[3 * t + 1];
      const double *c = verts + 3 * tris[3 * t + 2];
      // 2D barycentric test in (x, y)
      double d = (b[1] - c[1]) * (a[0] - c[0]) + (c[0] - b[0]) * (a[1] - c[1]);
      if (std::fabs(d) < 1e-30) continue;
      double l1 = ((b[1] - c[1]) * (x - c[0]) + (c[0] - b[0]) * (y - c[1])) / d;
      double l2 = ((c[1] - a[1]) * (x - c[0]) + (a[0] - c[0]) * (y - c[1])) / d;
      double l3 = 1.0 - l1 - l2;
      if (l1 < 0 || l2 < 0 || l3 < 0) continue;
      double tz = l1 * a[2] + l2 * b[2] + l3 * c[2];
      if (tz > z) crossings++;
    }
    out[p] = (uint8_t)(crossings & 1);
  }
}

void *mise_create(int resolution_0, int depth, double threshold) {
  return new MiseTree(resolution_0, depth, threshold);
}

void mise_destroy(void *h) { delete (MiseTree *)h; }

// Write up to `cap` pending lattice points (x,y,z triples, ascending
// lexicographic) into out_pts; returns the number pending. Pending points
// are by construction unknown (update() only queues unknowns).
int mise_query(void *h, int64_t *out_pts, int cap) {
  MiseTree &t = *(MiseTree *)h;
  int n = (int)t.pending.size();
  int m = n < cap ? n : cap;
  int64_t r1 = t.R + 1;
  for (int i = 0; i < m; ++i) {
    int64_t f = t.pending[i];
    out_pts[3 * i + 2] = f % r1;
    out_pts[3 * i + 1] = (f / r1) % r1;
    out_pts[3 * i] = f / (r1 * r1);
  }
  return n;
}

// Store values for the given lattice points and advance the frontier.
void mise_update(void *h, const int64_t *pts, const double *vals, int n) {
  MiseTree &t = *(MiseTree *)h;
  for (int i = 0; i < n; ++i)
    t.values[t.id(pts[3 * i], pts[3 * i + 1], pts[3 * i + 2])] = vals[i];
  t.advance();
}

void mise_to_dense(void *h, float *out) { ((MiseTree *)h)->to_dense(out); }

// Marching cubes directly from the device octree's sparse outputs for ONE
// proposal (meshing/mise_device.py) — no dense grid crosses to the host.
// Produces BYTE-IDENTICAL vertices/triangles to `mc_extract` over the
// -1e6-padded dense reconstruction (mise_device.reconstruct_dense ->
// Generator3D.extract_mesh): the lattice is rebuilt
// here (scatter + the exact ancestor-fill replay of the device
// to_dense rule), a one-byte sign is precomputed per padded lattice
// point, and every padded cell is scanned in the dense loop's
// lexicographic order — uniform-sign cells cost an 8-byte check, mixed
// cells run the same welded tessellation — so vertex ids come out
// equal, not merely equivalent. (A one-ring candidate heuristic is NOT
// sound here: ancestor fill at finer levels floors odd coordinates
// back onto decoded face values, propagating them up to 2^steps-1
// cells beyond a refined block and creating crossings outside any
// fixed-margin ring.)
//
// Inputs: lvl0 = (res0+1)^3 f32 corner lattice (C order); idx/vals =
// per-level refined-voxel linear ids (over the (res0*2^l)^3 voxel grid)
// and their 27-point child-lattice values, levels concatenated with
// level_counts[l] entries each; vals in the (0,h,s)^3 a-major offset
// order of mise_device._offsets. iso in logit units; pad_val the
// boundary closing value (-1e6). Vertices in PADDED index space.
int mise_mc_extract(const float *lvl0, int res0, int steps,
                    const int32_t *idx, const float *vals,
                    const int32_t *level_counts, float iso, float pad_val,
                    double **out_verts, int **out_tris,
                    int *out_nv, int *out_nt) {
  fastmc::Acc acc;
  mise_one(lvl0, res0, steps, idx, vals, level_counts, iso, pad_val, acc);
  *out_nv = (int)(acc.verts.size() / 3);
  *out_nt = (int)(acc.tris.size() / 3);
  double *ov = new double[acc.verts.size()];
  int *ot = new int[acc.tris.size()];
  std::memcpy(ov, acc.verts.data(), acc.verts.size() * sizeof(double));
  std::memcpy(ot, acc.tris.data(), acc.tris.size() * sizeof(int));
  *out_verts = ov;
  *out_tris = ot;
  return 0;
}

// Batched mise_mc_extract over n proposals in ONE call (one ctypes call
// a scene, not one a proposal), with
// a gated worker pool across proposals (fastmc::parallel_for — serial on
// a 1-core host). Layout: level_counts (n, steps) row-major; idx/vals
// concatenated in (proposal, level) order; valid=NULL or (n,) uint8 —
// invalid proposals produce empty meshes. Returns a handle: read each
// proposal's buffers with batch_mesh_get (zero-copy views into the
// result), free once with batch_result_free.
void *mise_mc_extract_batch(const float *lvl0s, int n, int res0, int steps,
                            const int32_t *idx, const float *vals,
                            const int32_t *level_counts, float iso,
                            float pad_val, const uint8_t *valid,
                            int32_t *nv_per, int32_t *nt_per) {
  const size_t lvl0_sz =
      (size_t)(res0 + 1) * (res0 + 1) * (res0 + 1);
  // per-proposal offsets into idx/vals
  std::vector<size_t> off(n + 1, 0);
  for (int i = 0; i < n; ++i) {
    size_t c = 0;
    for (int l = 0; l < steps; ++l) c += (size_t)level_counts[i * steps + l];
    off[i + 1] = off[i] + c;
  }
  mc::case_table();  // build once before threads fan out
  auto *res = new fastmc::BatchResult;
  res->accs.resize(n);
  fastmc::parallel_for(n, [&](int i) {
    if (valid && !valid[i]) return;
    mise_one(lvl0s + (size_t)i * lvl0_sz, res0, steps, idx + off[i],
             vals + off[i] * 27, level_counts + (size_t)i * steps, iso,
             pad_val, res->accs[i]);
  });
  for (int i = 0; i < n; ++i) {
    nv_per[i] = (int32_t)(res->accs[i].verts.size() / 3);
    nt_per[i] = (int32_t)(res->accs[i].tris.size() / 3);
  }
  return res;
}

}  // extern "C"
