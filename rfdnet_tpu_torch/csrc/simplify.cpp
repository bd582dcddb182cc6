// Quadric-error-metric mesh simplification of rfdnet_tpu_torch: the port's
// own copy of `simplify_qem` and `prep_free` of
// rfdnet_tpu/meshing/src/prep.cpp (edge collapses ranked by the summed
// plane quadrics of the two end points, tried at the end points and the
// midpoint; a collapse that flips or slivers a neighbouring face is
// skipped). Same iteration order and arithmetic, so both libraries give
// identical arrays on identical inputs when built with the same flags.
// Plain C interface, loaded with ctypes (rfdnet_tpu_torch/meshing/native.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ------------------------------------------------------------------- QEM
// Symmetric 4x4 quadric, 10 coefficients.
struct Quadric {
  double m[10];
  Quadric() { std::memset(m, 0, sizeof(m)); }
  void add(const Quadric &o) {
    for (int i = 0; i < 10; ++i) m[i] += o.m[i];
  }
  static Quadric plane(double a, double b, double c, double d) {
    Quadric q;
    q.m[0] = a * a; q.m[1] = a * b; q.m[2] = a * c; q.m[3] = a * d;
    q.m[4] = b * b; q.m[5] = b * c; q.m[6] = b * d;
    q.m[7] = c * c; q.m[8] = c * d;
    q.m[9] = d * d;
    return q;
  }
  double eval(double x, double y, double z) const {
    return m[0] * x * x + 2 * m[1] * x * y + 2 * m[2] * x * z +
           2 * m[3] * x + m[4] * y * y + 2 * m[5] * y * z + 2 * m[6] * y +
           m[7] * z * z + 2 * m[8] * z + m[9];
  }
};

struct SVert {
  double p[3];
  Quadric q;
  bool border = false;
  int tstart = 0, tcount = 0;
};

struct STri {
  int v[3];
  double err[4];
  bool deleted = false, dirty = false;
  double n[3];
};

struct SRef {
  int tid, tvertex;
};

struct Simplifier {
  std::vector<SVert> verts;
  std::vector<STri> tris;
  std::vector<SRef> refs;

  void compute_normal(STri &t) {
    const double *p0 = verts[t.v[0]].p, *p1 = verts[t.v[1]].p,
                 *p2 = verts[t.v[2]].p;
    double e1[3] = {p1[0] - p0[0], p1[1] - p0[1], p1[2] - p0[2]};
    double e2[3] = {p2[0] - p0[0], p2[1] - p0[1], p2[2] - p0[2]};
    double n[3] = {e1[1] * e2[2] - e1[2] * e2[1],
                   e1[2] * e2[0] - e1[0] * e2[2],
                   e1[0] * e2[1] - e1[1] * e2[0]};
    double l = std::sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
    if (l < 1e-30) l = 1.0;
    t.n[0] = n[0] / l; t.n[1] = n[1] / l; t.n[2] = n[2] / l;
  }

  // error of collapsing edge (a, b); best position out in pr
  double calc_error(int a, int b, double pr[3]) {
    Quadric q = verts[a].q;
    q.add(verts[b].q);
    // try midpoint / endpoints (robust; skips the 4x4 solve of the full
    // algorithm — quality difference is negligible at our targets)
    const double *pa = verts[a].p, *pb = verts[b].p;
    double cand[3][3] = {
        {pa[0], pa[1], pa[2]},
        {pb[0], pb[1], pb[2]},
        {(pa[0] + pb[0]) / 2, (pa[1] + pb[1]) / 2, (pa[2] + pb[2]) / 2}};
    double best = 1e300;
    for (auto &c : cand) {
      double e = q.eval(c[0], c[1], c[2]);
      if (e < best) {
        best = e;
        pr[0] = c[0]; pr[1] = c[1]; pr[2] = c[2];
      }
    }
    return best;
  }

  bool flipped(const double p[3], int i0, int i1, SVert &v0,
               std::vector<bool> &deleted_mark) {
    for (int k = 0; k < v0.tcount; ++k) {
      STri &t = tris[refs[v0.tstart + k].tid];
      if (t.deleted) continue;
      int s = refs[v0.tstart + k].tvertex;
      int id1 = t.v[(s + 1) % 3], id2 = t.v[(s + 2) % 3];
      if (id1 == i1 || id2 == i1) {  // triangle vanishes
        deleted_mark[k] = true;
        continue;
      }
      double d1[3] = {verts[id1].p[0] - p[0], verts[id1].p[1] - p[1],
                      verts[id1].p[2] - p[2]};
      double d2[3] = {verts[id2].p[0] - p[0], verts[id2].p[1] - p[1],
                      verts[id2].p[2] - p[2]};
      double l1 = std::sqrt(d1[0]*d1[0]+d1[1]*d1[1]+d1[2]*d1[2]);
      double l2 = std::sqrt(d2[0]*d2[0]+d2[1]*d2[1]+d2[2]*d2[2]);
      if (l1 < 1e-30 || l2 < 1e-30) return true;
      for (int j = 0; j < 3; ++j) { d1[j] /= l1; d2[j] /= l2; }
      double dot = d1[0]*d2[0]+d1[1]*d2[1]+d1[2]*d2[2];
      if (std::fabs(dot) > 0.999) return true;  // degenerate sliver
      double n[3] = {d1[1]*d2[2]-d1[2]*d2[1], d1[2]*d2[0]-d1[0]*d2[2],
                     d1[0]*d2[1]-d1[1]*d2[0]};
      double ln = std::sqrt(n[0]*n[0]+n[1]*n[1]+n[2]*n[2]);
      if (ln < 1e-30) return true;
      for (int j = 0; j < 3; ++j) n[j] /= ln;
      if (n[0]*t.n[0]+n[1]*t.n[1]+n[2]*t.n[2] < 0.2) return true;  // flip
    }
    return false;
  }

  void update_triangles(int i0, SVert &v, std::vector<bool> &deleted_mark,
                        int &deleted_tris) {
    double pr[3];
    for (int k = 0; k < v.tcount; ++k) {
      SRef &r = refs[v.tstart + k];
      STri &t = tris[r.tid];
      if (t.deleted) continue;
      if (deleted_mark[k]) {
        t.deleted = true;
        ++deleted_tris;
        continue;
      }
      t.v[r.tvertex] = i0;
      t.dirty = true;
      t.err[0] = calc_error(t.v[0], t.v[1], pr);
      t.err[1] = calc_error(t.v[1], t.v[2], pr);
      t.err[2] = calc_error(t.v[2], t.v[0], pr);
      t.err[3] = std::min(t.err[0], std::min(t.err[1], t.err[2]));
      refs.push_back(r);
    }
    // caller re-points v0's ref block at the newly-pushed refs
  }

  void update_mesh(int iteration) {
    if (iteration > 0) {  // compact triangle list
      size_t dst = 0;
      for (size_t i = 0; i < tris.size(); ++i)
        if (!tris[i].deleted) tris[dst++] = tris[i];
      tris.resize(dst);
    }
    for (auto &v : verts) { v.tstart = 0; v.tcount = 0; }
    for (auto &t : tris)
      for (int j = 0; j < 3; ++j) ++verts[t.v[j]].tcount;
    int tstart = 0;
    for (auto &v : verts) { v.tstart = tstart; tstart += v.tcount; v.tcount = 0; }
    refs.resize(tris.size() * 3);
    for (size_t i = 0; i < tris.size(); ++i)
      for (int j = 0; j < 3; ++j) {
        SVert &v = verts[tris[i].v[j]];
        refs[v.tstart + v.tcount] = {(int)i, j};
        ++v.tcount;
      }
    if (iteration == 0) {
      // initial quadrics + borders + edge errors
      for (auto &t : tris) {
        compute_normal(t);
        const double *p0 = verts[t.v[0]].p;
        double d = -(t.n[0]*p0[0] + t.n[1]*p0[1] + t.n[2]*p0[2]);
        Quadric q = Quadric::plane(t.n[0], t.n[1], t.n[2], d);
        for (int j = 0; j < 3; ++j) verts[t.v[j]].q.add(q);
      }
      // border detection: count directed edges
      std::vector<int> vcount, vids;
      for (auto &v : verts) {
        vcount.clear(); vids.clear();
        for (int k = 0; k < v.tcount; ++k) {
          STri &t = tris[refs[v.tstart + k].tid];
          for (int j = 0; j < 3; ++j) {
            int id = t.v[j];
            if (id == (&v - verts.data())) continue;
            size_t f;
            for (f = 0; f < vids.size(); ++f)
              if (vids[f] == id) break;
            if (f == vids.size()) { vids.push_back(id); vcount.push_back(1); }
            else ++vcount[f];
          }
        }
        for (size_t f = 0; f < vids.size(); ++f)
          if (vcount[f] == 1) { v.border = true; verts[vids[f]].border = true; }
      }
      double pr[3];
      for (auto &t : tris) {
        t.err[0] = calc_error(t.v[0], t.v[1], pr);
        t.err[1] = calc_error(t.v[1], t.v[2], pr);
        t.err[2] = calc_error(t.v[2], t.v[0], pr);
        t.err[3] = std::min(t.err[0], std::min(t.err[1], t.err[2]));
      }
    }
  }

  void simplify(int target_count, double aggressiveness) {
    for (auto &t : tris) t.deleted = false;
    int deleted_tris = 0;
    int tri_count = (int)tris.size();
    std::vector<bool> del0, del1;
    for (int iteration = 0; iteration < 100; ++iteration) {
      if (tri_count - deleted_tris <= target_count) break;
      if (iteration % 5 == 0) update_mesh(iteration);
      for (auto &t : tris) t.dirty = false;
      double threshold = 1e-9 * std::pow(iteration + 3.0, aggressiveness);
      for (auto &t : tris) {
        if (t.err[3] > threshold || t.deleted || t.dirty) continue;
        for (int j = 0; j < 3; ++j) {
          if (t.err[j] > threshold) continue;
          int i0 = t.v[j], i1 = t.v[(j + 1) % 3];
          SVert &v0 = verts[i0];
          SVert &v1 = verts[i1];
          if (v0.border != v1.border) continue;
          double p[3];
          calc_error(i0, i1, p);
          del0.assign(v0.tcount, false);
          del1.assign(v1.tcount, false);
          if (flipped(p, i0, i1, v0, del0)) continue;
          if (flipped(p, i1, i0, v1, del1)) continue;
          // collapse i1 -> i0 at p
          v0.p[0] = p[0]; v0.p[1] = p[1]; v0.p[2] = p[2];
          v0.q.add(v1.q);
          int tstart = (int)refs.size();
          update_triangles(i0, v0, del0, deleted_tris);
          update_triangles(i0, v1, del1, deleted_tris);
          int tcount = (int)refs.size() - tstart;
          if (tcount <= v0.tcount) {
            if (tcount)
              std::memmove(&refs[v0.tstart], &refs[tstart],
                           tcount * sizeof(SRef));
          } else {
            v0.tstart = tstart;
          }
          v0.tcount = tcount;
          break;
        }
        if (tri_count - deleted_tris <= target_count) break;
      }
    }
    // compact output
    size_t dst = 0;
    for (size_t i = 0; i < tris.size(); ++i)
      if (!tris[i].deleted) tris[dst++] = tris[i];
    tris.resize(dst);
    std::vector<int> remap(verts.size(), -1);
    std::vector<SVert> nv;
    for (auto &t : tris)
      for (int j = 0; j < 3; ++j) {
        if (remap[t.v[j]] < 0) {
          remap[t.v[j]] = (int)nv.size();
          nv.push_back(verts[t.v[j]]);
        }
        t.v[j] = remap[t.v[j]];
      }
    verts.swap(nv);
  }
};

}  // namespace

extern "C" {

// QEM simplification. Returns library-owned buffers; free with
// prep_free.
int simplify_qem(const double *in_verts, int nv, const int *in_tris, int nt,
                 int target_faces, double aggressiveness, double **out_verts,
                 int **out_tris, int *out_nv, int *out_nt) {
  Simplifier s;
  s.verts.resize(nv);
  for (int i = 0; i < nv; ++i)
    for (int j = 0; j < 3; ++j) s.verts[i].p[j] = in_verts[3 * i + j];
  s.tris.resize(nt);
  for (int i = 0; i < nt; ++i)
    for (int j = 0; j < 3; ++j) s.tris[i].v[j] = in_tris[3 * i + j];
  s.simplify(target_faces, aggressiveness);
  *out_nv = (int)s.verts.size();
  *out_nt = (int)s.tris.size();
  double *v = new double[s.verts.size() * 3];
  int *t = new int[s.tris.size() * 3];
  for (size_t i = 0; i < s.verts.size(); ++i)
    for (int j = 0; j < 3; ++j) v[3 * i + j] = s.verts[i].p[j];
  for (size_t i = 0; i < s.tris.size(); ++i)
    for (int j = 0; j < 3; ++j) t[3 * i + j] = s.tris[i].v[j];
  *out_verts = v;
  *out_tris = t;
  return 0;
}

void prep_free(double *v, int *t) {
  delete[] v;
  delete[] t;
}

}  // extern "C"
