// Native tet-grid topology builders (the port's copy of
// deftet_tpu/native/topology.cpp: the same C functions, the same output
// order).
//
// Counterparts of the original DefTet's ctypes C++ helpers
// (utils/lib/tet_point_adj, tet_face_adj, tet_adj_share, colaps_v) and its
// python face builder.  One compilation unit of extern "C" entry points,
// loaded with ctypes by native/topology.py; every output is a dense index
// array of the kind tetgrid.topology builds with numpy (no sparse
// matrices).
//
// Design: sort-based grouping on 64-bit keys (face key = sorted vertex
// triple packed into 64 bits; edge key = lo * N + hi).  O(n log n), no
// hash-map allocations in the hot loop.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct FaceRec {
  uint64_t key;
  int32_t tet;
  int32_t slot;
  int32_t v0, v1, v2;  // original (oriented) vertex order
};

// Local face ordering must match tetgrid.topology.FACE_IDX.
constexpr int kFaceIdx[4][3] = {{0, 1, 2}, {1, 0, 3}, {2, 3, 0}, {3, 2, 1}};
constexpr int kTetEdges[6][2] = {{0, 1}, {0, 2}, {0, 3},
                                 {1, 2}, {1, 3}, {2, 3}};

inline uint64_t face_key(int32_t a, int32_t b, int32_t c, uint64_t n) {
  int32_t x = a, y = b, z = c;
  if (x > y) std::swap(x, y);
  if (y > z) std::swap(y, z);
  if (x > y) std::swap(x, y);
  return (uint64_t(x) * n + uint64_t(y)) * n + uint64_t(z);
}

}  // namespace

extern "C" {

// Enumerate unique faces of a tet list.
//   tets:      (T*4) int32
//   outputs (caller-allocated):
//     face_v        (2T*3)  interior face vertices (first-owner order)
//     face_tet      (2T*2)  owning tets
//     face_slot     (2T*2)  local slots
//     hull_v        (4T*3)  boundary faces
//   returns interior count via *n_interior, hull count via *n_hull.
//   Return value: 0 ok, 1 invalid mesh (face shared by >2 tets).
int build_faces(const int32_t* tets, int64_t n_tets, int64_t n_point,
                int32_t* face_v, int32_t* face_tet, int32_t* face_slot,
                int32_t* hull_v, int64_t* n_interior, int64_t* n_hull) {
  std::vector<FaceRec> recs(size_t(n_tets) * 4);
  const uint64_t n = uint64_t(n_point);
  for (int64_t t = 0; t < n_tets; ++t) {
    const int32_t* tet = tets + t * 4;
    for (int s = 0; s < 4; ++s) {
      int32_t a = tet[kFaceIdx[s][0]];
      int32_t b = tet[kFaceIdx[s][1]];
      int32_t c = tet[kFaceIdx[s][2]];
      FaceRec& r = recs[size_t(t) * 4 + s];
      r.key = face_key(a, b, c, n);
      r.tet = int32_t(t);
      r.slot = s;
      r.v0 = a; r.v1 = b; r.v2 = c;
    }
  }
  // stable sort by key keeps first-occurrence (lowest tet) order within
  // groups — the same orientation convention as the numpy builder.
  std::stable_sort(recs.begin(), recs.end(),
                   [](const FaceRec& x, const FaceRec& y) {
                     return x.key < y.key;
                   });
  int64_t ni = 0, nh = 0;
  size_t i = 0;
  const size_t total = recs.size();
  while (i < total) {
    size_t j = i + 1;
    while (j < total && recs[j].key == recs[i].key) ++j;
    const size_t cnt = j - i;
    if (cnt == 1) {
      hull_v[nh * 3 + 0] = recs[i].v0;
      hull_v[nh * 3 + 1] = recs[i].v1;
      hull_v[nh * 3 + 2] = recs[i].v2;
      ++nh;
    } else if (cnt == 2) {
      face_v[ni * 3 + 0] = recs[i].v0;
      face_v[ni * 3 + 1] = recs[i].v1;
      face_v[ni * 3 + 2] = recs[i].v2;
      face_tet[ni * 2 + 0] = recs[i].tet;
      face_tet[ni * 2 + 1] = recs[i + 1].tet;
      face_slot[ni * 2 + 0] = recs[i].slot;
      face_slot[ni * 2 + 1] = recs[i + 1].slot;
      ++ni;
    } else {
      return 1;
    }
    i = j;
  }
  *n_interior = ni;
  *n_hull = nh;
  return 0;
}

// Row-normalized vertex adjacency as padded neighbor lists.
//   adj_idx (n_point * max_degree) int32, adj_mask same shape float32,
//   degree (n_point) int32.  max_degree is computed by a first pass and
//   must be queried via vertex_adjacency_max_degree first.
int64_t vertex_adjacency_max_degree(const int32_t* tets, int64_t n_tets,
                                    int64_t n_point) {
  std::vector<uint64_t> keys;
  keys.reserve(size_t(n_tets) * 12);
  const uint64_t n = uint64_t(n_point);
  for (int64_t t = 0; t < n_tets; ++t) {
    const int32_t* tet = tets + t * 4;
    for (const auto& e : kTetEdges) {
      uint64_t a = uint64_t(tet[e[0]]), b = uint64_t(tet[e[1]]);
      keys.push_back(a * n + b);
      keys.push_back(b * n + a);
    }
  }
  std::sort(keys.begin(), keys.end());
  keys.erase(std::unique(keys.begin(), keys.end()), keys.end());
  std::vector<int64_t> deg(size_t(n_point), 0);
  for (uint64_t k : keys) ++deg[size_t(k / n)];
  int64_t m = 0;
  for (int64_t d : deg) m = std::max(m, d);
  return m;
}

void build_vertex_adjacency(const int32_t* tets, int64_t n_tets,
                            int64_t n_point, int64_t max_degree,
                            int32_t* adj_idx, float* adj_mask,
                            int32_t* degree) {
  std::vector<uint64_t> keys;
  keys.reserve(size_t(n_tets) * 12);
  const uint64_t n = uint64_t(n_point);
  for (int64_t t = 0; t < n_tets; ++t) {
    const int32_t* tet = tets + t * 4;
    for (const auto& e : kTetEdges) {
      uint64_t a = uint64_t(tet[e[0]]), b = uint64_t(tet[e[1]]);
      keys.push_back(a * n + b);
      keys.push_back(b * n + a);
    }
  }
  std::sort(keys.begin(), keys.end());
  keys.erase(std::unique(keys.begin(), keys.end()), keys.end());
  std::memset(adj_idx, 0, sizeof(int32_t) * size_t(n_point) * max_degree);
  std::memset(adj_mask, 0, sizeof(float) * size_t(n_point) * max_degree);
  std::memset(degree, 0, sizeof(int32_t) * size_t(n_point));
  for (uint64_t k : keys) {
    const int64_t src = int64_t(k / n);
    const int32_t dst = int32_t(k % n);
    const int64_t pos = degree[src]++;
    adj_idx[src * max_degree + pos] = dst;
    adj_mask[src * max_degree + pos] = 1.0f;
  }
}

// Tet neighbor per local face slot (-1 at hull) from build_faces outputs.
void build_tet_neighbors(const int32_t* face_tet, const int32_t* face_slot,
                         int64_t n_faces, int64_t n_tets, int32_t* nbr) {
  for (int64_t i = 0; i < n_tets * 4; ++i) nbr[i] = -1;
  for (int64_t f = 0; f < n_faces; ++f) {
    const int32_t t0 = face_tet[f * 2], t1 = face_tet[f * 2 + 1];
    const int32_t s0 = face_slot[f * 2], s1 = face_slot[f * 2 + 1];
    nbr[int64_t(t0) * 4 + s0] = t1;
    nbr[int64_t(t1) * 4 + s1] = t0;
  }
}

// Pairs of interior faces sharing an undirected edge (the C4 edge-pair
// adjacency).  Two-phase: call with pair_a == nullptr to count.
int64_t build_edge_face_pairs(const int32_t* face_v, int64_t n_faces,
                              int64_t n_point, int32_t* pair_a,
                              int32_t* pair_b) {
  struct EdgeRec { uint64_t key; int32_t face; };
  std::vector<EdgeRec> recs(size_t(n_faces) * 3);
  const uint64_t n = uint64_t(n_point);
  for (int64_t f = 0; f < n_faces; ++f) {
    const int32_t* v = face_v + f * 3;
    const int32_t e[3][2] = {{v[0], v[1]}, {v[1], v[2]}, {v[2], v[0]}};
    for (int k = 0; k < 3; ++k) {
      uint64_t lo = uint64_t(std::min(e[k][0], e[k][1]));
      uint64_t hi = uint64_t(std::max(e[k][0], e[k][1]));
      recs[size_t(f) * 3 + k] = {lo * n + hi, int32_t(f)};
    }
  }
  std::stable_sort(recs.begin(), recs.end(),
                   [](const EdgeRec& x, const EdgeRec& y) {
                     return x.key < y.key;
                   });
  int64_t count = 0;
  size_t i = 0;
  const size_t total = recs.size();
  while (i < total) {
    size_t j = i + 1;
    while (j < total && recs[j].key == recs[i].key) ++j;
    const size_t m = j - i;
    if (pair_a != nullptr) {
      for (size_t a = i; a < j; ++a) {
        for (size_t b = a + 1; b < j; ++b) {
          pair_a[count] = recs[a].face;
          pair_b[count] = recs[b].face;
          ++count;
        }
      }
    } else {
      count += int64_t(m * (m - 1) / 2);
    }
    i = j;
  }
  return count;
}

// Deduplicate vertices by quantized coordinates (colaps_v equivalent,
// utils/lib/colaps_v/run.cpp: 5-decimal rounding).  Writes remap (old ->
// new index) and returns the number of unique vertices; unique vertex
// coordinates are written to out_verts (caller-allocated n_vert * 3).
int64_t collapse_vertices(const double* verts, int64_t n_vert,
                          double decimals, int32_t* remap,
                          double* out_verts) {
  struct VRec { int64_t qx, qy, qz; int32_t idx; };
  const double scale = decimals;
  const size_t nv = size_t(n_vert);
  std::vector<VRec> recs(nv);
  for (int64_t i = 0; i < n_vert; ++i) {
    recs[i] = {int64_t(std::llround(verts[i * 3 + 0] * scale)),
               int64_t(std::llround(verts[i * 3 + 1] * scale)),
               int64_t(std::llround(verts[i * 3 + 2] * scale)),
               int32_t(i)};
  }
  std::stable_sort(recs.begin(), recs.end(),
                   [](const VRec& a, const VRec& b) {
                     if (a.qx != b.qx) return a.qx < b.qx;
                     if (a.qy != b.qy) return a.qy < b.qy;
                     return a.qz < b.qz;
                   });
  int64_t n_unique = 0;
  size_t i = 0;
  while (i < recs.size()) {
    size_t j = i + 1;
    while (j < recs.size() && recs[j].qx == recs[i].qx &&
           recs[j].qy == recs[i].qy && recs[j].qz == recs[i].qz)
      ++j;
    // representative: first original index in the group
    int32_t rep = recs[i].idx;
    for (size_t a = i; a < j; ++a)
      rep = std::min(rep, recs[a].idx);
    out_verts[n_unique * 3 + 0] = verts[int64_t(rep) * 3 + 0];
    out_verts[n_unique * 3 + 1] = verts[int64_t(rep) * 3 + 1];
    out_verts[n_unique * 3 + 2] = verts[int64_t(rep) * 3 + 2];
    for (size_t a = i; a < j; ++a) remap[recs[a].idx] = int32_t(n_unique);
    ++n_unique;
    i = j;
  }
  return n_unique;
}

}  // extern "C"
