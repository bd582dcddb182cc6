// Host marching cubes of rfdnet_tpu_torch: the port's own copy of the
// marching-cubes part of rfdnet_tpu/meshing/src/meshing.cpp (same case
// table, scan order and vertex numbering, so both libraries give identical
// arrays on identical grids). Plain C interface, loaded with ctypes
// (rfdnet_tpu_torch/meshing/native.py). Vertices come back in grid-index
// space, welded along shared edges.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
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

}  // extern "C"
