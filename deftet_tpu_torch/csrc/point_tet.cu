// point_tet: the first (lowest-index) tet containing each query point, or
// -1, by a bounding-box bin grid instead of a scan of every tet.
//
// The answer is that of the plain PyTorch scan (ops/point_tet.py,
// points_in_tets_plain) bit for bit: a query is inside a tet when all four
// same-side tests pass, each with the plain version's expressions in its
// order, every product and sum rounded on its own (-fmad=false):
//   e1 = p2 - p1, e2 = p3 - p1, n = (e1y e2z - e1z e2y, e1z e2x - e1x e2z,
//   e1x e2y - e1y e2x), ref = ((p4-p1)x nx + (p4-p1)y ny) + (p4-p1)z nz,
//   off = (p1x nx + p1y ny) + p1z nz, qd = ((qx nx + qy ny) + qz nz) - off,
//   pass: qd * ref >= 0,
// for the planes (a,b,c | d), (a,b,d | c), (a,c,d | b), (b,c,d | a).
//
// Replaces no TPU kernel: the JAX package runs this scan in XLA
// (deftet_tpu/ops/point_tet.py:28, _points_in_tets_single), and the port's
// eager chunked scan took 97 % of the res-50 inference step on the H100
// (4 x 20,000 queries against 750,000 tets: 6.0e10 pairs, ~90,000
// launches).  Bound on the H100: bytes, one read of the corners
// (12 floats a tet) and the queries and one write of the answers; 0.04 ms
// at the evaluation's shape, where a call takes 1.08 ms on an H100 80GB
// HBM3 (the corners are read three times, PERF.md), against 6,558 ms for
// the plain scan.
//
// Design, per batch element, on PyTorch's stream; the wrapper allocates all
// scratch (deftet_point_tet_workspace_bytes) and reads one number, the
// entry count, between the two C entries (6 kernels and 2 memsets a call):
// 1. extent_kernel: the box of the finite corners and the sum of the tets'
//    box widths per axis.  grid_kernel: a uniform grid over that box whose
//    cell side is kCellOverBox times the mean tet box width per axis, capped
//    at cmax cells and with each axis' count (when 8 or more) made prime to
//    2, 3 and 5, so that the cells do not line up with a lattice's planes.
//    The cell of a coordinate is cell_of below, one monotone expression
//    clamped to the grid, used alike for boxes and queries.
// 2. bin_kernel<false>, claim_kernel, bin_kernel<true>: each tet's corner
//    box, padded (tet_cells), is counted into every cell it covers, each
//    cell claims its range of the entry array (one atomic a warp, cells in
//    any order), the tet ids are filled in by atomics in any order, and
//    the fill keeps each binned tet's padded box.
// 3. A tet goes instead to its batch element's overflow slot, which every
//    query scans, when it covers more than kMaxCells cells, or when its
//    padding cannot be proved to hold every point that its float tests can
//    accept (a flat tet accepts every point: ref is 0).
// 4. query_kernel: one thread a query scans its cell's candidates and the
//    overflow slot, skipping ids not below its best; a cell's candidate is
//    first tested against its padded box (one 32-byte read, which rejects
//    most), then with the four tests, early out at the first failing one;
//    the least id that passes wins.  The planes are computed per candidate;
//    no plane array is written.
//
// Why the bins lose no answer.  A tet's box is padded by
// pad_t = max(grid pad, excess) with excess a bound, computed in double
// from the tet's floats, on how far outside its corner box a query that
// passes the four float tests can lie.  With u = 2^-24, U = 2^-149 and
// fl(x o y) = (x o y)(1 + d) + h, |d| <= u, |h| <= U/2 (h = 0 for + and -):
// - each computed normal n differs from the exact N = (p2-p1) x (p3-p1)
//   by E_k <= 4.1u (|e1y e2z| + |e1z e2y|) + 2U (and cyclically);
// - ref differs from rho = N.(p4-p1) by at most
//   err = 4.1u sum|d'_k n_k| + 1.01 sum|d'_k| E_k + 2U (d' = fl(p4-p1));
//   a tet binned needs err <= |ref| / 2 on all four planes, so that
//   sign(ref) = sign(rho) != 0 and |rho| >= rl = |ref| - err;
// - fl(qd * ref) >= 0 then gives s N.(q-p1) >= -(a + b r), s = sign(rho),
//   r = |q - c|inf around the box centre c, with
//   a = U/|ref| + 4U + 3.1u sum|n_k| (|c_k| + |p1_k|) + sum E_k |c_k - p1_k|
//   and b = 3.1u sum|n_k| + sum E_k (the products' and sums' rounding,
//   an underflowing qd * ref, and the normal's error);
// - so each barycentric coordinate of q is >= -(a_i + b_i r) / rl_i, their
//   negative parts sum to L <= A + B r (A, B: the sums over the planes),
//   q lies within L * W of the corner box on each axis (W its widest
//   side), and r <= H (1 + 2L) (H = W / 2): L <= (A + B H) / (1 - 2 B H)
//   where 2 B H <= 1/2, and excess = L W (times 1 + 1e-6 for the double
//   arithmetic).
// The padded box is rounded outward (nextafterf), and cell_of is monotone,
// so the query's cell lies in the tet's cell range.  This holds for any
// finite query with |q| <= 2^80 against a tet whose coordinates and
// normals are at most 2^40, where no test overflows; every other tet goes
// to the overflow slot, a query with a NaN coordinate fails every test
// (-1), and a query with an infinite or larger coordinate scans all tets.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCells = 64;            // cells a binned tet may cover
constexpr double kCellOverBox = 1.5;     // cell side / mean tet box width
constexpr int kMaxAxisCells = 4096;
constexpr float kPadShare = 1.0f / 4096; // grid pad / the grid's scale
constexpr float kCoordBig = 1099511627776.f;           // 2^40
constexpr float kQueryBig = 1.2089258196146292e24f;    // 2^80
constexpr double kU = 5.9604644775390625e-08;          // 2^-24
constexpr double kTiny = 1.401298464324817e-45;        // 2^-149
constexpr int kStats = 8;

// planes (p1, p2, p3 | p4) of the four tests as corner indices, two bits
// each, a byte a plane: (a,b,c | d), (a,b,d | c), (a,c,d | b), (b,c,d | a)
constexpr unsigned kFaces = 0x3978B4E4u;

__host__ __device__ constexpr int corner(int f, int j) {
  return (int)((kFaces >> (8 * f + 2 * j)) & 3u);
}

struct Corners {          // corner k, axis c of tet t, batch b:
  const float* p[12];     // p[3k + c][b * stride[3k + c] + t]
  long long stride[12];
};

struct Grid {
  float origin[3];
  float inv[3];
  int n[3];
  float pad;
};

// workspace, from its start: sum of box widths (3B double), extent keys
// (6B unsigned: 3B maxima of ~key of the minima, 3B maxima of the key),
// counts (slots int), all zeroed by one memset; then the grids (B Grid)
struct Workspace {
  double* wsum;
  unsigned* kmin;
  unsigned* kmax;
  int* counts;
  Grid* grids;
  size_t zero_bytes;
};

size_t zero_bytes(int batch, long long slots) {
  return 48 * (size_t)batch + 4 * (size_t)slots;
}

Workspace workspace(void* base, int batch, long long slots) {
  Workspace w;
  char* p = static_cast<char*>(base);
  w.wsum = reinterpret_cast<double*>(p);
  w.kmin = reinterpret_cast<unsigned*>(p + 24 * (size_t)batch);
  w.kmax = w.kmin + 3 * (size_t)batch;
  w.counts = reinterpret_cast<int*>(w.kmax + 3 * (size_t)batch);
  w.zero_bytes = zero_bytes(batch, slots);
  w.grids = reinterpret_cast<Grid*>(p + w.zero_bytes);
  return w;
}

// float -> unsigned with the same order (finite values)
__device__ __forceinline__ unsigned key_of(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float float_of(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The cell of coordinate x on one axis: monotone in x, clamped to
// [0, n - 1], NaN to 0 (ops/point_tet.py bin_cells mirrors it).
__device__ __forceinline__ int cell_of(float x, float origin, float inv,
                                       int n) {
  const float t = floorf((x - origin) * inv);
  return (int)fminf(fmaxf(t, 0.f), (float)(n - 1));
}

__device__ __forceinline__ void load_tet(const Corners& cs, int b, long long t,
                                         float v[4][3]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      v[k][c] = __ldg(cs.p[3 * k + c] + b * cs.stride[3 * k + c] + t);
}

// The plane of face f as the plain version computes it (n and ref).
__device__ __forceinline__ void plane(const float v[4][3], int f, float n[3],
                                      float e1[3], float e2[3], float d[3],
                                      float& ref) {
  const float* p1 = v[corner(f, 0)];
  const float* p2 = v[corner(f, 1)];
  const float* p3 = v[corner(f, 2)];
  const float* p4 = v[corner(f, 3)];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    e1[c] = p2[c] - p1[c];
    e2[c] = p3[c] - p1[c];
    d[c] = p4[c] - p1[c];
  }
  n[0] = e1[1] * e2[2] - e1[2] * e2[1];
  n[1] = e1[2] * e2[0] - e1[0] * e2[2];
  n[2] = e1[0] * e2[1] - e1[1] * e2[0];
  ref = d[0] * n[0] + d[1] * n[1] + d[2] * n[2];
}

// The four same-side tests of query q against a tet, in the plain
// version's order; false at the first that fails.
__device__ __forceinline__ bool inside(const float v[4][3], float qx, float qy,
                                       float qz) {
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    float n[3], e1[3], e2[3], d[3], ref;
    plane(v, f, n, e1, e2, d, ref);
    const float* p1 = v[corner(f, 0)];
    const float off = p1[0] * n[0] + p1[1] * n[1] + p1[2] * n[2];
    const float qd = qx * n[0] + qy * n[1] + qz * n[2] - off;
    if (!(qd * ref >= 0.f)) return false;
  }
  return true;
}

// The padded box of tet v (box_lo, box_hi) and its cell range on grid g,
// or false where the tet goes to the overflow slot (see the proof at the
// top).
__device__ bool tet_cells(const float v[4][3], const Grid& g, float box_lo[3],
                          float box_hi[3], int lo[3], int hi[3]) {
  float blo[3], bhi[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    blo[c] = bhi[c] = v[0][c];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!(fabsf(v[k][c]) <= kCoordBig)) return false;  // NaN too
      blo[c] = fminf(blo[c], v[k][c]);
      bhi[c] = fmaxf(bhi[c], v[k][c]);
    }
  }
  double cen[3], half = 0.0;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    cen[c] = 0.5 * ((double)blo[c] + (double)bhi[c]);
    half = fmax(half, 0.5 * ((double)bhi[c] - (double)blo[c]));
  }
  double sa = 0.0, sb = 0.0;
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    float n[3], e1[3], e2[3], d[3], ref;
    plane(v, f, n, e1, e2, d, ref);
    const float* p1 = v[corner(f, 0)];
    double e[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (!(fabsf(n[c]) <= kCoordBig)) return false;
      const int i = (c + 1) % 3, j = (c + 2) % 3;
      e[c] = 4.1 * kU * (fabs((double)e1[i] * e2[j]) +
                         fabs((double)e1[j] * e2[i])) + 2.0 * kTiny;
    }
    const double aref = fabs((double)ref);
    double err = 2.0 * kTiny, a = kTiny / aref + 4.0 * kTiny, b = 0.0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const double an = fabs((double)n[c]);
      err += 4.1 * kU * fabs((double)d[c]) * an + 1.01 * fabs((double)d[c]) * e[c];
      a += 3.1 * kU * an * (fabs(cen[c]) + fabs((double)p1[c])) +
           e[c] * fabs(cen[c] - (double)p1[c]);
      b += 3.1 * kU * an + e[c];
    }
    if (!(err <= 0.5 * aref)) return false;  // ref's sign unproved
    const double rl = aref - err;
    sa += a / rl;
    sb += b / rl;
  }
  if (!(2.0 * sb * half <= 0.5)) return false;
  const double excess =
      (sa + sb * half) / (1.0 - 2.0 * sb * half) * (2.0 * half) * (1.0 + 1e-6);
  const float pad = fmaxf(g.pad, __double2float_ru(excess));
  long long cells = 1;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    box_lo[c] = nextafterf(blo[c] - pad, -INFINITY);
    box_hi[c] = nextafterf(bhi[c] + pad, INFINITY);
    lo[c] = cell_of(box_lo[c], g.origin[c], g.inv[c], g.n[c]);
    hi[c] = cell_of(box_hi[c], g.origin[c], g.inv[c], g.n[c]);
    cells *= hi[c] - lo[c] + 1;
  }
  return cells <= kMaxCells;
}

__device__ __forceinline__ float warp_min(float x) {
  for (int o = 16; o; o >>= 1) x = fminf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}

__device__ __forceinline__ double warp_sum(double x) {
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

// Box of the finite corners (|x| <= 2^40) and the sum of the tets' corner
// box widths, per axis; grid (blocks, B).
__global__ void __launch_bounds__(kThreads)
    extent_kernel(Corners cs, Workspace w, int T) {
  const int b = blockIdx.y;
  float lo[3] = {INFINITY, INFINITY, INFINITY};
  float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  double ws[3] = {0.0, 0.0, 0.0};
  for (long long t = blockIdx.x * (long long)kThreads + threadIdx.x; t < T;
       t += (long long)gridDim.x * kThreads) {
    float v[4][3];
    load_tet(cs, b, t, v);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float tl = INFINITY, th = -INFINITY;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (fabsf(v[k][c]) <= kCoordBig) {
          tl = fminf(tl, v[k][c]);
          th = fmaxf(th, v[k][c]);
        }
      }
      lo[c] = fminf(lo[c], tl);
      hi[c] = fmaxf(hi[c], th);
      if (th >= tl) ws[c] += (double)th - (double)tl;
    }
  }
  const int lane = threadIdx.x & 31;
  for (int c = 0; c < 3; ++c) {
    const float l = warp_min(lo[c]), h = warp_max(hi[c]);
    const double s = warp_sum(ws[c]);
    if (lane == 0) {
      if (l <= h) {
        atomicMax(w.kmin + 3 * b + c, ~key_of(l));
        atomicMax(w.kmax + 3 * b + c, key_of(h));
      }
      if (s > 0.0) atomicAdd(w.wsum + 3 * b + c, s);
    }
  }
}

// One thread a batch element: the bin grid (see the top of the file).
__global__ void grid_kernel(Workspace w, int batch, int T, long long cmax) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  Grid g;
  for (int c = 0; c < 3; ++c) {
    g.origin[c] = 0.f;
    g.inv[c] = 0.f;
    g.n[c] = 1;
  }
  g.pad = 0.f;
  if (w.kmax[3 * b] && w.kmax[3 * b + 1] && w.kmax[3 * b + 2]) {
    // a finite corner coordinate on every axis
    float lo[3], wd[3], scale = 0.f, wmax = 0.f;
    for (int c = 0; c < 3; ++c) {
      lo[c] = float_of(~w.kmin[3 * b + c]);
      const float hi = float_of(w.kmax[3 * b + c]);
      wd[c] = hi - lo[c];
      wmax = fmaxf(wmax, wd[c]);
      scale = fmaxf(scale, fmaxf(fmaxf(fabsf(lo[c]), fabsf(hi)), wd[c]));
      g.origin[c] = lo[c];
    }
    g.pad = scale * kPadShare;
    if (wmax > 0.f) {
      double n[3];
      for (int c = 0; c < 3; ++c) {
        const double side = fmax(kCellOverBox * w.wsum[3 * b + c] / T,
                                 (double)wmax / kMaxAxisCells);
        n[c] = fmin(fmax(floor(wd[c] / side), 1.0), (double)kMaxAxisCells);
      }
      while (n[0] * n[1] * n[2] > (double)cmax) {
        const double f = cbrt((double)cmax / (n[0] * n[1] * n[2]));
        for (int c = 0; c < 3; ++c) n[c] = fmax(floor(n[c] * f), 1.0);
      }
      for (int c = 0; c < 3; ++c) {
        int k = (int)n[c];
        while (k >= 8 && (k % 2 == 0 || k % 3 == 0 || k % 5 == 0)) --k;
        g.n[c] = k;
        g.inv[c] = wd[c] > 0.f ? (float)(k / (double)wd[c]) : 0.f;
      }
    }
  }
  w.grids[b] = g;
}

__device__ __forceinline__ long long slot_of(const Grid& g, int b,
                                             long long per_batch, int x,
                                             int y, int z) {
  return b * per_batch + ((long long)x * g.n[1] + y) * g.n[2] + z;
}

// Counts (fill = false) or fills (fill = true) the cell entries of every
// tet; the fill also writes each binned tet's padded box (two float4, lo
// and hi) for the queries' first test.  Grid (ceil(T / kThreads), B).
template <bool kFill>
__global__ void __launch_bounds__(kThreads)
    bin_kernel(Corners cs, Workspace w, unsigned long long* __restrict__ ends,
               int* __restrict__ entries, float4* __restrict__ boxes, int T,
               long long per_batch) {
  const int b = blockIdx.y;
  const long long t = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (t >= T) return;
  const Grid g = w.grids[b];
  float v[4][3];
  load_tet(cs, b, t, v);
  float blo[3], bhi[3];
  int lo[3], hi[3];
  if (!tet_cells(v, g, blo, bhi, lo, hi)) {
    const long long s = b * per_batch + per_batch - 1;
    if (kFill)
      entries[atomicAdd(ends + s, 1ULL)] = (int)t;
    else
      atomicAdd(w.counts + s, 1);
    return;
  }
  if (kFill) {
    boxes[2 * (b * (long long)T + t)] = make_float4(blo[0], blo[1], blo[2], 0.f);
    boxes[2 * (b * (long long)T + t) + 1] =
        make_float4(bhi[0], bhi[1], bhi[2], 0.f);
  }
  for (int x = lo[0]; x <= hi[0]; ++x)
    for (int y = lo[1]; y <= hi[1]; ++y)
      for (int z = lo[2]; z <= hi[2]; ++z) {
        const long long s = slot_of(g, b, per_batch, x, y, z);
        if (kFill)
          entries[atomicAdd(ends + s, 1ULL)] = (int)t;
        else
          atomicAdd(w.counts + s, 1);
      }
}

// One thread a slot: claims the slot's range of the entry array by one
// atomic a warp on the running total stats[0], in no order of the slots
// (a slot needs only its own range), and sets ends[slot] to the range's
// start, which the fill's atomics advance to its end.  stats[1] gets the
// overflow tets.
__global__ void __launch_bounds__(kThreads)
    claim_kernel(const int* __restrict__ counts,
                 unsigned long long* __restrict__ ends,
                 unsigned long long* __restrict__ stats, long long n,
                 long long per_batch) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const long long c = i < n ? counts[i] : 0;
  long long inc = c;
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(~0u, inc, o);
    if (lane >= o) inc += y;
  }
  unsigned long long base = 0;
  if (lane == 31 && inc) base = atomicAdd(stats, (unsigned long long)inc);
  base = __shfl_sync(~0u, base, 31);
  if (i < n) ends[i] = base + (unsigned long long)(inc - c);
  long long over = i < n && i % per_batch == per_batch - 1 ? c : 0;
  for (int o = 16; o; o >>= 1) over += __shfl_xor_sync(~0u, over, o);
  if (lane == 0 && over) atomicAdd(stats + 1, (unsigned long long)over);
}

// One thread a query: the least id among its cell's candidates and the
// overflow slot that pass the four tests, or -1.  stats[2] candidates
// tested or skipped, [3] their maximum, [4] queries, [5] found, [6] queries
// that scanned every tet.
__global__ void __launch_bounds__(kThreads)
    query_kernel(Corners cs, Workspace w, const float* __restrict__ q,
                 const unsigned long long* __restrict__ ends,
                 const int* __restrict__ entries,
                 const float4* __restrict__ boxes, int* __restrict__ out,
                 unsigned long long* __restrict__ stats, int batch, int P,
                 int T, long long per_batch) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  const bool live = i < (long long)batch * P;
  int best = 0x7fffffff;
  long long cand = 0;
  int brute = 0;
  if (live) {
    const int b = (int)(i / P);
    const float qx = q[3 * i], qy = q[3 * i + 1], qz = q[3 * i + 2];
    if (isnan(qx) || isnan(qy) || isnan(qz)) {
      // every test reads NaN: no tet
    } else if (!(fabsf(qx) <= kQueryBig && fabsf(qy) <= kQueryBig &&
                 fabsf(qz) <= kQueryBig)) {
      brute = 1;  // outside what the bins prove: scan every tet
      for (long long t = 0; t < T; ++t) {
        float v[4][3];
        load_tet(cs, b, t, v);
        if (inside(v, qx, qy, qz)) {
          best = (int)t;
          break;
        }
      }
      cand = T;
    } else {
      const Grid g = w.grids[b];
      const long long s = slot_of(g, b, per_batch,
                                  cell_of(qx, g.origin[0], g.inv[0], g.n[0]),
                                  cell_of(qy, g.origin[1], g.inv[1], g.n[1]),
                                  cell_of(qz, g.origin[2], g.inv[2], g.n[2]));
      const long long so = b * per_batch + per_batch - 1;
      // the cell's tets, each first against its padded box, which
      // holds every point its tests accept; then the overflow tets
      for (int part = 0; part < 2; ++part) {
        const long long s0 = part ? so : s;
        const long long e1 = (long long)ends[s0];
        const long long e0 = e1 - w.counts[s0];
        for (long long e = e0; e < e1; ++e) {
          const int t = __ldg(entries + e);
          if (t >= best) continue;
          if (!part) {
            const long long k = 2 * (b * (long long)T + t);
            const float4 lo = __ldg(boxes + k), hi = __ldg(boxes + k + 1);
            if (qx < lo.x || qx > hi.x || qy < lo.y || qy > hi.y ||
                qz < lo.z || qz > hi.z)
              continue;
          }
          float v[4][3];
          load_tet(cs, b, t, v);
          if (inside(v, qx, qy, qz)) best = t;
        }
        cand += e1 - e0;
      }
    }
    out[i] = best == 0x7fffffff ? -1 : best;
  }
  // warp totals into the stats
  long long c_sum = cand, c_max = cand;
  int found = live && best != 0x7fffffff, n_live = live;
  for (int o = 16; o; o >>= 1) {
    c_sum += __shfl_xor_sync(~0u, c_sum, o);
    const long long m = __shfl_xor_sync(~0u, c_max, o);
    c_max = m > c_max ? m : c_max;
    found += __shfl_xor_sync(~0u, found, o);
    n_live += __shfl_xor_sync(~0u, n_live, o);
    brute += __shfl_xor_sync(~0u, brute, o);
  }
  if ((threadIdx.x & 31) == 0 && n_live) {
    atomicAdd(stats + 2, (unsigned long long)c_sum);
    atomicMax(stats + 3, (unsigned long long)c_max);
    atomicAdd(stats + 4, (unsigned long long)n_live);
    if (found) atomicAdd(stats + 5, (unsigned long long)found);
    if (brute) atomicAdd(stats + 6, (unsigned long long)brute);
  }
}

Corners corners_of(const void* const* ptrs, const long long* strides) {
  Corners cs;
  for (int k = 0; k < 12; ++k) {
    cs.p[k] = static_cast<const float*>(ptrs[k]);
    cs.stride[k] = strides[k];
  }
  return cs;
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

}  // namespace

// Bytes of the workspace for batch B and slots = B * (cmax + 1), or -1
// past 2^31 - 1.
extern "C" int deftet_point_tet_workspace_bytes(int batch, long long slots) {
  const size_t bytes = zero_bytes(batch, slots) + sizeof(Grid) * (size_t)batch;
  return bytes > 0x7fffffffULL ? -1 : (int)bytes;
}

// First entry: extent, grid, the counts and each slot's range.  corners: a
// host array of 12 device pointers (corner k, axis c at 3k + c; each
// (B, T) float32 with unit stride along T) and their batch strides; cmax:
// cells a batch element at most; ws: the workspace; ends: B * (cmax + 1)
// int64; stats: 8 int64.  stats[0] is then the entry count.
extern "C" int deftet_point_tet_bin(const void* const* corners,
                                    const long long* strides, void* ws,
                                    void* ends, void* stats, int batch, int T,
                                    long long cmax, void* stream) {
  if (batch <= 0 || T <= 0 || cmax <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long per_batch = cmax + 1, slots = batch * per_batch;
  const Workspace w = workspace(ws, batch, slots);
  const Corners cs = corners_of(corners, strides);
  cudaError_t err = cudaMemsetAsync(ws, 0, w.zero_bytes, s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(stats, 0, kStats * sizeof(long long), s);
  if (err != cudaSuccess) return (int)err;
  const long long tblocks = (T + kThreads - 1) / kThreads;
  const long long eblocks = tblocks < 4LL * sm_count() ? tblocks
                                                       : 4LL * sm_count();
  extent_kernel<<<dim3((unsigned)eblocks, batch), kThreads, 0, s>>>(cs, w, T);
  grid_kernel<<<(batch + 31) / 32, 32, 0, s>>>(w, batch, T, cmax);
  bin_kernel<false><<<dim3((unsigned)tblocks, batch), kThreads, 0, s>>>(
      cs, w, nullptr, nullptr, nullptr, T, per_batch);
  claim_kernel<<<(unsigned)((slots + kThreads - 1) / kThreads), kThreads, 0,
                 s>>>(w.counts, static_cast<unsigned long long*>(ends),
                      static_cast<unsigned long long*>(stats), slots,
                      per_batch);
  return (int)cudaGetLastError();
}

// Second entry: fill the entries (stats[0] int32) and the padded boxes
// (B * T * 8 float32), and answer the queries q (B, P, 3) float32 into out
// (B, P) int32.
extern "C" int deftet_point_tet_query(const void* const* corners,
                                      const long long* strides, void* ws,
                                      void* ends, int* entries, void* boxes,
                                      const float* q, int* out, void* stats,
                                      int batch, int P, int T, long long cmax,
                                      void* stream) {
  if (batch <= 0 || T <= 0 || P < 0 || cmax <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long per_batch = cmax + 1;
  const Workspace w = workspace(ws, batch, batch * per_batch);
  const Corners cs = corners_of(corners, strides);
  unsigned long long* e = static_cast<unsigned long long*>(ends);
  float4* bx = static_cast<float4*>(boxes);
  const long long tblocks = (T + kThreads - 1) / kThreads;
  bin_kernel<true><<<dim3((unsigned)tblocks, batch), kThreads, 0, s>>>(
      cs, w, e, entries, bx, T, per_batch);
  const long long qblocks = ((long long)batch * P + kThreads - 1) / kThreads;
  if (qblocks > 0)
    query_kernel<<<(unsigned)qblocks, kThreads, 0, s>>>(
        cs, w, q, e, entries, bx, out,
        static_cast<unsigned long long*>(stats), batch, P, T, per_batch);
  return (int)cudaGetLastError();
}

extern "C" const char* deftet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
