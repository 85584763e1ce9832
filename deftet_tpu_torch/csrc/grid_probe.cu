// grid_probe: the occupancy decoder's input rows in one pass.  Every level
// of a voxel-feature pyramid is sampled at each point by border-clamped
// trilinear interpolation, the point's xyz is appended, and the row is
// written once, rounded to the output dtype (float32 or bfloat16).
//
// The answer is that of the plain PyTorch version (ops/grid_probe.py,
// grid_probe_plain: cat([sample_grid_features(p, pyramid), p], -1).to(dtype))
// bit for bit.  Each product and sum is rounded on its own (-fmad=false and
// the _rn intrinsics), in the plain version's order:
//   coords = clamp((p + 0.5) * r, 0, r - 1), i0 = floor(coords),
//   frac = coords - i0, i1 = min(i0 + 1, r - 1),
//   w = (wx * wy) * wz with wx = frac or 1 - frac per axis,
//   out = ((+0 + v000 w000) + v001 w001) + ... + v111 w111,
// corners in the order (sx, sy, sz) with x outermost, the sum started from
// +0.0 as the plain 0.0 + ... starts it (so -0.0 products agree), then one
// round-to-nearest-even to the output dtype; the xyz columns are the
// float32 points rounded the same way.
//
// Replaces no TPU kernel: the JAX package's probe is XLA code
// (deftet_tpu/nn/model.py:34, sample_grid_features, over
// deftet_tpu/ops/voxelize.py:61, trilinear_devoxelize).  In the port the
// probe ran as ATen ops: for each level and corner a gather of (B, n, C),
// a float32 multiply and a float32 add, then two concatenations and a cast
// to bf16.  At the res-50 evaluation (8 chunks of 4 x 100,000 tet centres,
// a pyramid of 64 channels at 32^3, 128 at 16^3 twice and 512 at 8^3) that
// wrote and read ~480 GB a step, about 225 ms on the H100.
//
// Bound on the H100: bytes, one write of the rows (835 bf16 a row, 5.0 GB a
// res-50 evaluation step) and one read of the pyramid (13.6 MB a batch
// element, L2-resident) and of the points: 1.64 ms a step at 3.35 TB/s,
// where the step's 8 calls take 5.4-5.5 ms on an H100 80GB HBM3 (30 %),
// against 234 ms for the ATen probe (PERF.md).  The corners are what
// threatens that bound: 8 corner rows of 832 float32 a row are 26.6 KB,
// 80 GB a step if every row fetched its own from L2.
//
// Design.  A block of 512 threads takes a tile of consecutive rows (32 for
// a 2-byte output, 16 for float32: ~53 KB of 835 columns).  The evaluation
// hands the rows in the grid's order (type-major tets, z fastest), so the
// rows of a tile lie along a line and share most of their corners: a tile
// of 32 res-50 rows reads ~130 KB of distinct corner rows where its 32 x 8
// corners would be 850 KB, and the repeats come from L1 (read-only loads);
// rows in a random order take ~1.5x the time (PERF.md).
// 1. For each (row, level) one thread computes the 8 corner offsets and
//    weights into shared memory, once for all channels; the xyz columns
//    go straight into the staged tile.
// 2. Level by level, consecutive threads take consecutive channel vectors
//    of one row (float4 where the level's rows are 16-byte aligned), so
//    each corner-row read is coalesced; each thread reads its row's
//    offsets and weights as four 16-byte vectors, its 8 corners, sums,
//    rounds and stores the result into the tile in shared memory (bf16
//    pairs as 32-bit stores), laid out exactly as the output rows.
// 3. The tile (rows x columns, contiguous in the output and 16-byte
//    aligned, since a tile holds a multiple of the rows that make 16
//    bytes) is copied out with 16-byte streaming stores.
// The kernel is correct for points in any order; it is fast when
// neighbouring rows are neighbouring points.  No gradient.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxLevels = 16;
constexpr int kTileBytes = 64 * 1024;  // staged output a block, at most
constexpr int kMaxTileRows = 64;
constexpr int kMaxSmem = 200 * 1024;

struct Level {
  const float* data;       // (r^3, C) rows of batch element 0, unit stride
  long long batch_stride;  // elements between batch elements (0: expanded)
  int r;
  int c;
  int col;  // first output column
  int vec;  // floats a load: 4, 2 or 1
};

struct Probe {
  Level level[kMaxLevels];
  const float* points;
  long long ps_b, ps_n, ps_c;  // point strides, elements
  long long rows;              // B * n
  int n;
  int n_levels;
  int ncols;
  int append;
  int tile_rows;
};

template <typename T>
__device__ __forceinline__ T round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 round_to<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int V>
struct Vec;
template <>
struct Vec<4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
};
template <>
struct Vec<2> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = x.x; v[1] = x.y;
  }
};
template <>
struct Vec<1> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    v[0] = __ldg(p);
  }
};

// torch.clamp(x, 0, hi): NaN stays NaN
__device__ __forceinline__ float clamp_to(float x, float hi) {
  x = x < 0.f ? 0.f : x;
  return x > hi ? hi : x;
}

// Stores a thread's V results into the staged tile; bfloat16 pairs that
// fall on a 4-byte boundary go as one 32-bit store.
template <int V, typename T>
__device__ __forceinline__ void stage(T* dst, const float* acc) {
#pragma unroll
  for (int j = 0; j < V; ++j) dst[j] = round_to<T>(acc[j]);
}
template <>
__device__ __forceinline__ void stage<4, __nv_bfloat16>(__nv_bfloat16* dst,
                                                        const float* acc) {
  if ((reinterpret_cast<uintptr_t>(dst) & 3) == 0) {
    __nv_bfloat162* d2 = reinterpret_cast<__nv_bfloat162*>(dst);
    d2[0] = __floats2bfloat162_rn(acc[0], acc[1]);
    d2[1] = __floats2bfloat162_rn(acc[2], acc[3]);
  } else {
    dst[0] = __float2bfloat16_rn(acc[0]);
    *reinterpret_cast<__nv_bfloat162*>(dst + 1) =
        __floats2bfloat162_rn(acc[1], acc[2]);
    dst[3] = __float2bfloat16_rn(acc[3]);
  }
}

// One level's channels for every row of the tile: item it = row * nv + v,
// v the vector of V channels; (row, v) advance with it, no division.
template <int V, typename T>
__device__ void probe_level(const Level& lv, int l, int n_levels, int rows,
                            const int* rowb, const int4* cidx,
                            const float4* cw, T* tile, int ncols) {
  const int nv = lv.c / V;
  const int items = rows * nv;
  const int step_rows = blockDim.x / nv, step_v = blockDim.x % nv;
  int row = threadIdx.x / nv, v = threadIdx.x % nv;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const float* base = lv.data + rowb[row] * lv.batch_stride + v * V;
    const int4 c0 = cidx[(row * n_levels + l) * 2],
               c1 = cidx[(row * n_levels + l) * 2 + 1];
    const float4 w0 = cw[(row * n_levels + l) * 2],
                 w1 = cw[(row * n_levels + l) * 2 + 1];
    const int ci[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
    const float wk[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    float val[8][V];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      Vec<V>::load(base + (long long)ci[k] * lv.c, val[k]);
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
#pragma unroll
      for (int j = 0; j < V; ++j)
        acc[j] = __fadd_rn(acc[j], __fmul_rn(val[k][j], wk[k]));
    }
    stage<V>(tile + (long long)row * ncols + lv.col + v * V, acc);
    row += step_rows;
    v += step_v;
    if (v >= nv) {
      v -= nv;
      ++row;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    grid_probe_kernel(const Probe p, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  // the levels in shared memory, read by static indices: a dynamic index
  // into the kernel's parameters would copy them to local memory
  __shared__ Level levels[kMaxLevels];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) levels[l] = p.level[l];
  }
  const int R = p.tile_rows, L = p.n_levels;
  const long long row0 = (long long)blockIdx.x * R;
  const int rows = (int)min((long long)R, p.rows - row0);
  // shared memory: the tile, then per (row, level) 8 corner offsets and
  // 8 weights (32 bytes each, read as two 16-byte vectors), then each
  // row's batch element
  T* tile = reinterpret_cast<T*>(smem);
  const size_t tile_bytes =
      ((size_t)R * p.ncols * sizeof(T) + 15) / 16 * 16;
  int* cidx = reinterpret_cast<int*>(smem + tile_bytes);
  float* cw = reinterpret_cast<float*>(cidx + R * L * 8);
  int* rowb = reinterpret_cast<int*>(cw + R * L * 8);

  __syncthreads();

  // 1. the batch element of each row, its xyz columns, and per (row,
  //    level) the corner offsets and weights
  for (int row = threadIdx.x; row < rows; row += blockDim.x) {
    const long long g = row0 + row;
    const long long b = g / p.n;
    rowb[row] = (int)b;
    if (p.append) {
      const float* pt = p.points + b * p.ps_b + (g - b * p.n) * p.ps_n;
      T* dst = tile + (long long)row * p.ncols + p.ncols - 3;
#pragma unroll
      for (int a = 0; a < 3; ++a) dst[a] = round_to<T>(pt[a * p.ps_c]);
    }
  }
  for (int i = threadIdx.x; i < rows * L; i += blockDim.x) {
    const int row = i / L, l = i - row * L;
    const long long g = row0 + row;
    const long long b = g / p.n;
    const float* pt = p.points + b * p.ps_b + (g - b * p.n) * p.ps_n;
    const int r = levels[l].r;
    const float rf = (float)r, hi = (float)(r - 1);
    int i0[3], i1[3];
    float w0[3], w1[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      // sample_grid_features clamps, then trilinear_devoxelize again
      const float scaled = __fmul_rn(__fadd_rn(pt[a * p.ps_c], 0.5f), rf);
      const float c = clamp_to(clamp_to(scaled, hi), hi);
      const float f = floorf(c);
      const float frac = __fsub_rn(c, f);
      i0[a] = (int)f;
      i1[a] = min(i0[a] + 1, r - 1);
      w0[a] = __fsub_rn(1.f, frac);
      w1[a] = frac;
    }
    int* ci = cidx + i * 8;
    float* wk = cw + i * 8;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int sx = k >> 2, sy = (k >> 1) & 1, sz = k & 1;
      const int ix = sx ? i1[0] : i0[0], iy = sy ? i1[1] : i0[1],
                iz = sz ? i1[2] : i0[2];
      ci[k] = (ix * r + iy) * r + iz;
      wk[k] = __fmul_rn(__fmul_rn(sx ? w1[0] : w0[0], sy ? w1[1] : w0[1]),
                        sz ? w1[2] : w0[2]);
    }
  }
  __syncthreads();

  // 2. the levels' columns, staged in the tile
  const int4* c4 = reinterpret_cast<const int4*>(cidx);
  const float4* w4 = reinterpret_cast<const float4*>(cw);
  for (int l = 0; l < L; ++l) {
    const Level& lv = levels[l];
    if (lv.vec == 4)
      probe_level<4>(lv, l, L, rows, rowb, c4, w4, tile, p.ncols);
    else if (lv.vec == 2)
      probe_level<2>(lv, l, L, rows, rowb, c4, w4, tile, p.ncols);
    else
      probe_level<1>(lv, l, L, rows, rowb, c4, w4, tile, p.ncols);
  }
  __syncthreads();

  // 3. the tile out: contiguous rows, 16-byte aligned at its start
  const size_t elems = (size_t)rows * p.ncols;
  T* dst = out + row0 * p.ncols;
  const size_t n16 = elems * sizeof(T) / 16;
  const int4* s4 = reinterpret_cast<const int4*>(tile);
  int4* d4 = reinterpret_cast<int4*>(dst);
  for (size_t i = threadIdx.x; i < n16; i += blockDim.x)
    __stcs(d4 + i, s4[i]);
  for (size_t i = n16 * 16 / sizeof(T) + threadIdx.x; i < elems;
       i += blockDim.x)
    dst[i] = tile[i];
}

// Rows a tile: the most, up to kTileBytes of output and kMaxTileRows, that
// is a multiple of the rows whose output makes 16 bytes; 0 if even those
// do not fit in shared memory.
int tile_rows_for(int ncols, int esize, int n_levels, size_t* smem) {
  const long long row_bytes = (long long)ncols * esize;
  int unit = 1;
  while ((row_bytes * unit) % 16 != 0) unit *= 2;
  int rows = (int)(kTileBytes / row_bytes) / unit * unit;
  if (rows > kMaxTileRows) rows = kMaxTileRows / unit * unit;
  if (rows < unit) rows = unit;
  *smem = ((size_t)rows * row_bytes + 15) / 16 * 16 +
          (size_t)rows * sizeof(int) * (1 + 8 * n_levels) +
          (size_t)rows * sizeof(float) * 8 * n_levels;
  return *smem > (size_t)kMaxSmem ? 0 : rows;
}

template <typename T>
cudaError_t launch(const Probe& p0, void* out, cudaStream_t s) {
  Probe p = p0;
  size_t smem = 0;
  p.tile_rows = tile_rows_for(p.ncols, (int)sizeof(T), p.n_levels, &smem);
  if (p.tile_rows == 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      grid_probe_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (p.rows + p.tile_rows - 1) / p.tile_rows;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  grid_probe_kernel<T><<<(unsigned)blocks, kThreads, smem, s>>>(
      p, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// out (B, n, ncols) of out_kind (0 float32, 1 bfloat16), contiguous and
// 16-byte aligned; for each level l the host arrays give its data
// (float32, (r^3, C) rows of unit stride from batch element 0), batch
// stride, r, C, first column and floats a load; points (B, n, 3) float32
// with strides point_strides (elements); with ``append`` the last three
// columns are xyz.  Returns cudaErrorInvalidValue where the rows of ncols
// columns cannot be staged in shared memory.
extern "C" int deftet_grid_probe(const void* const* level_data,
                                 const long long* level_batch_stride,
                                 const int* level_r, const int* level_c,
                                 const int* level_col, const int* level_vec,
                                 int n_levels, const void* points,
                                 const long long* point_strides, int batch,
                                 int n, int ncols, int append, int out_kind,
                                 void* out, void* stream) {
  if (n_levels < 0 || n_levels > kMaxLevels || batch < 0 || n < 0 ||
      ncols <= 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)batch * n == 0) return 0;
  Probe p = {};
  for (int l = 0; l < n_levels; ++l) {
    const int vec = level_vec[l];
    if (level_r[l] <= 0 || level_c[l] <= 0 ||
        (vec != 1 && vec != 2 && vec != 4) || level_c[l] % vec != 0)
      return (int)cudaErrorInvalidValue;
    p.level[l] = Level{static_cast<const float*>(level_data[l]),
                       level_batch_stride[l], level_r[l], level_c[l],
                       level_col[l], vec};
  }
  p.points = static_cast<const float*>(points);
  p.ps_b = point_strides[0];
  p.ps_n = point_strides[1];
  p.ps_c = point_strides[2];
  p.rows = (long long)batch * n;
  p.n = n;
  p.n_levels = n_levels;
  p.ncols = ncols;
  p.append = append;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_kind) {
    case 0: return (int)launch<float>(p, out, s);
    case 1: return (int)launch<__nv_bfloat16>(p, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* deftet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
