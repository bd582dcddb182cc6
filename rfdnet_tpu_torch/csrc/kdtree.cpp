// 3-D KD-tree of rfdnet_tpu_torch: the port's own copy of `kdtree_build`,
// `kdtree_query` and `kdtree_free` of rfdnet_tpu/meshing/src/prep.cpp
// (the `pykdtree` role: median split on x, y, z in turn, an implicit
// balanced layout, k nearest neighbours through a bounded max-heap). Same
// build order and arithmetic, so both libraries give identical indices and
// squared distances on identical inputs. Queries are independent of each
// other and are spread over the host's threads. Plain C interface, loaded
// with ctypes (rfdnet_tpu_torch/meshing/native.py).

#include <algorithm>
#include <cstdlib>
#include <thread>
#include <utility>
#include <vector>

namespace {

struct KDTreeImpl {
  std::vector<double> pts;  // (n, 3)
  std::vector<int> idx;     // permutation, tree in in-order layout
  int n = 0;

  void build(const double *p, int count) {
    n = count;
    pts.assign(p, p + 3 * (size_t)count);
    idx.resize(count);
    for (int i = 0; i < count; ++i) idx[i] = i;
    build_rec(0, count, 0);
  }

  void build_rec(int lo, int hi, int axis) {
    if (hi - lo <= 1) return;
    int mid = (lo + hi) / 2;
    std::nth_element(
        idx.begin() + lo, idx.begin() + mid, idx.begin() + hi,
        [&](int a, int b) { return pts[3 * a + axis] < pts[3 * b + axis]; });
    build_rec(lo, mid, (axis + 1) % 3);
    build_rec(mid + 1, hi, (axis + 1) % 3);
  }

  void knn(const double *q, int k, double *out_d2, int *out_i) const {
    std::vector<std::pair<double, int>> heap;
    heap.reserve(k + 1);
    query_rec(q, k, 0, n, 0, heap);
    std::sort_heap(heap.begin(), heap.end());
    for (int i = 0; i < k; ++i) {
      if (i < (int)heap.size()) {
        out_d2[i] = heap[i].first;
        out_i[i] = heap[i].second;
      } else {
        out_d2[i] = 1e300;
        out_i[i] = -1;
      }
    }
  }

  void query_rec(const double *q, int k, int lo, int hi, int axis,
                 std::vector<std::pair<double, int>> &heap) const {
    if (lo >= hi) return;
    int mid = (lo + hi) / 2;
    int id = idx[mid];
    double dx = q[0] - pts[3 * id], dy = q[1] - pts[3 * id + 1],
           dz = q[2] - pts[3 * id + 2];
    double d2 = dx * dx + dy * dy + dz * dz;
    if ((int)heap.size() < k) {
      heap.emplace_back(d2, id);
      std::push_heap(heap.begin(), heap.end());
    } else if (d2 < heap.front().first) {
      std::pop_heap(heap.begin(), heap.end());
      heap.back() = {d2, id};
      std::push_heap(heap.begin(), heap.end());
    }
    double delta = q[axis] - pts[3 * id + axis];
    int next = (axis + 1) % 3;
    if (delta < 0) {
      query_rec(q, k, lo, mid, next, heap);
      if ((int)heap.size() < k || delta * delta < heap.front().first)
        query_rec(q, k, mid + 1, hi, next, heap);
    } else {
      query_rec(q, k, mid + 1, hi, next, heap);
      if ((int)heap.size() < k || delta * delta < heap.front().first)
        query_rec(q, k, lo, mid, next, heap);
    }
  }
};

int query_threads(int nq) {
  const char *env = getenv("RFDNET_MESH_THREADS");
  int n = env ? atoi(env) : (int)std::thread::hardware_concurrency();
  n = std::min(n, nq / 1024 + 1);  // a thread is worth ~1k queries
  return std::max(n, 1);
}

}  // namespace

extern "C" {

void *kdtree_build(const double *pts, int n) {
  auto *t = new KDTreeImpl();
  t->build(pts, n);
  return t;
}

void kdtree_query(void *tree, const double *queries, int nq, int k,
                  double *out_d2, int *out_idx) {
  const auto *t = (const KDTreeImpl *)tree;
  int nth = query_threads(nq);
  auto run = [&](int th) {
    for (int i = th; i < nq; i += nth)
      t->knn(queries + 3 * (size_t)i, k, out_d2 + (size_t)i * k,
             out_idx + (size_t)i * k);
  };
  std::vector<std::thread> pool;
  for (int th = 1; th < nth; ++th) pool.emplace_back(run, th);
  run(0);
  for (auto &th : pool) th.join();
}

void kdtree_free(void *tree) { delete (KDTreeImpl *)tree; }

}  // extern "C"
