// K1: 14-offset lattice stencil (row-normalized neighbour mean on the Kuhn
// vertex lattice).
//
//   out[b, v, c] = scale[v] * sum_{o} r(x[b, v + off_o, c] * in_scale[v + off_o])
//
// over the n^3 vertex lattice in i*n^2 + j*n + k order; reads outside the
// lattice are zero; r() rounds to the storage type.  Accumulation is f32 in
// offset order, storage is the input type (float or bfloat16).  A null
// scale or in_scale means unit scale; the backward passes in_scale = 1/deg
// (its cotangent pre-scale) and no scale.
//
// Replaces deftet_tpu/ops/stencil_pallas.py:_stencil3d_kernel (reached via
// stencil_sum / lattice_neighbor_mean).  That kernel shipped three
// zero-padded (JP, KP, CB) row planes per grid step into VMEM, and its
// backward pre-scaled the cotangent in a separate XLA pass; here that
// pre-scale is read inside the kernel.
//
// Bound on the H100: memory bytes.  The minimum traffic is one read of x
// (and of the scales) and one write of out.  Two paths:
//
// - Tiled (16-byte channel packs, the GCN's C = 256 bf16): a block owns
//   `rows` whole rows j of the (j, k) plane and a chunk of kChunkPacks
//   16-byte packs of channels, and marches along i over one segment of
//   the planes.  Each plane's rows, with one halo row on either side and
//   one zero column at either end of every row, are staged once into
//   shared memory by cp.async (zero filled outside the lattice) in a ring
//   of kRing planes: planes i - 1, i, i + 1 are read while the next
//   kDepth planes are in flight, and the ring is deep enough that one
//   barrier per plane suffices.  The 14 neighbour reads of an element then
//   come from shared memory at fixed distances, with no bounds test and
//   no branch; each thread's staged and output addresses are computed
//   once, and each offset's shared-memory base once per plane.  in_scale
//   is applied in place by the thread that staged the pack, before the
//   barrier, from scales loaded a plane ahead.  Rows per block and
//   segments along i are sized from the kernel's occupancy.  A shape of
//   16-byte packs whose ring does not fit (n above 199 on the H100) is
//   refused, not run another way.
// - Simple (packs under 16 bytes, such as the Laplacian's C = 3 float):
//   one thread per (b, v, pack of channels), neighbour reads through
//   L1/L2, bounds checked in the index arithmetic.
//
// The offset table lives in __constant__ memory (a warp reads the same
// entry: one broadcast).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxOffsets = 27;
constexpr int kMaxDevices = 64;
constexpr int kThreads = 256;

// Tiled path: threads per block; 16-byte channel packs per block (32
// bytes of a vertex, one DRAM sector); output packs and staged packs per
// thread and plane; staged planes per block, of which kDepth are in flight
// beyond the three being read; blocks per SM the shared memory is sized for.
constexpr int kTiledThreads = 256;
constexpr int kChunkPacks = 2;
constexpr int kItems = 4;
constexpr int kStage = 6;
constexpr int kRing = 6;
constexpr int kDepth = kRing - 3;
constexpr int kBlocksPerSm = 2;

__constant__ int c_offsets[kMaxOffsets * 3];

// Host copy of what each device's c_offsets holds, so the table is copied
// only when it changes (a blocking copy: no launch can see a half-written
// table), and each device's opt-in shared-memory limit.
int g_host_offsets[kMaxDevices][kMaxOffsets * 3];
int g_host_count[kMaxDevices];
bool g_host_valid[kMaxDevices];
int g_smem_optin[kMaxDevices];

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// ------------------------------------------------------------ simple path
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    stencil_kernel(const T* __restrict__ x, T* __restrict__ out,
                   const float* __restrict__ scale,
                   const float* __restrict__ in_scale, int n_off, int n,
                   int channels, long long total) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= total) return;
  const int packs = channels / VEC;
  const int c0 = (int)(tid % packs) * VEC;
  const long long row = tid / packs;  // b * n^3 + v
  const long long n3 = (long long)n * n * n;
  const int v = (int)(row % n3);
  const long long batch_base = (row - v) * channels;
  const int i = v / (n * n);
  const int j = (v / n) % n;
  const int k = v % n;

  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;

  for (int o = 0; o < n_off; ++o) {
    const int ii = i + c_offsets[3 * o];
    const int jj = j + c_offsets[3 * o + 1];
    const int kk = k + c_offsets[3 * o + 2];
    if ((unsigned)ii < (unsigned)n && (unsigned)jj < (unsigned)n &&
        (unsigned)kk < (unsigned)n) {
      const int src_v = (ii * n + jj) * n + kk;
      const long long src = batch_base + (long long)src_v * channels + c0;
      const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(x + src);
      if (in_scale != nullptr) {
        const float si = in_scale[src_v];
#pragma unroll
        for (int e = 0; e < VEC; ++e)  // rounded product: no contraction
          acc[e] += to_float<T>(from_float<T>(__fmul_rn(to_float<T>(p.v[e]), si)));
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] += to_float<T>(p.v[e]);
      }
    }
  }

  const float s = scale != nullptr ? scale[v] : 1.f;
  Pack<T, VEC> res;
#pragma unroll
  for (int e = 0; e < VEC; ++e) res.v[e] = from_float<T>(acc[e] * s);
  *reinterpret_cast<Pack<T, VEC>*>(out + row * channels + c0) = res;
}

// ------------------------------------------------------------- tiled path
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// acc[0..VEC) += the 16-byte pack's values, widened exactly to f32.
__device__ __forceinline__ void add_pack(float* acc, const uint4& w,
                                         float /*tag*/) {
  acc[0] += __uint_as_float(w.x);
  acc[1] += __uint_as_float(w.y);
  acc[2] += __uint_as_float(w.z);
  acc[3] += __uint_as_float(w.w);
}

__device__ __forceinline__ void add_pack(float* acc, const uint4& w,
                                         __nv_bfloat16 /*tag*/) {
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {  // a bf16 is the high half of its f32
    acc[2 * q] += __uint_as_float(u[q] << 16);
    acc[2 * q + 1] += __uint_as_float(u[q] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 lds128(unsigned addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

template <typename T, bool IN_SCALE>
__global__ void __launch_bounds__(kTiledThreads)
    stencil_kernel_tiled(const T* __restrict__ x, T* __restrict__ out,
                         const float* __restrict__ scale,
                         const float* __restrict__ in_scale, int n_off, int n,
                         int channels, int rows, int segs, int seg_len) {
  constexpr int VEC = 16 / sizeof(T);
  using P = Pack<T, VEC>;
  extern __shared__ uint4 s_ring[];
  // Per plane (two, by parity): byte offset in the ring of each offset's
  // neighbour of output row 0, column 0 (never negative: a shared address
  // is split into this uniform part and the thread's own part).
  __shared__ int s_base[2][kMaxOffsets];
  const int t = threadIdx.x;
  const int n2 = n * n;
  const int np = n + 2;  // a staged row holds k = -1 .. n
  const int row_packs = np * kChunkPacks;
  const int plane_packs = (rows + 2) * row_packs;
  const int j0 = blockIdx.x * rows;
  const int pc0 = blockIdx.y * kChunkPacks;
  const int i_begin = (blockIdx.z % segs) * seg_len;
  const int i_end = min(n, i_begin + seg_len);
  const int packs = channels / VEC;
  const long long xb = (long long)(blockIdx.z / segs) * n2 * n * channels;
  const unsigned ring = static_cast<unsigned>(__cvta_generic_to_shared(s_ring));
  int off_di = 0, off_rel = 0;  // offset t, for the per-plane table
  if (t < n_off) {
    off_di = c_offsets[3 * t];
    off_rel = ((c_offsets[3 * t + 1] + 1) * np + c_offsets[3 * t + 2] + 1) *
              kChunkPacks;
  }

  // The packs this thread stages, the same in every plane: staged slot
  // t + q * kTiledThreads is row j0 - 1 + r, column k (-1 .. n), pack c;
  // its vertex in the plane, or -1 where the lattice has none (zero fill).
  int st_v[kStage], st_src[kStage];
#pragma unroll
  for (int q = 0; q < kStage; ++q) {
    const int e = t + q * kTiledThreads;
    const int r = e / row_packs, rem = e % row_packs;
    const int j = j0 - 1 + r, k = rem / kChunkPacks - 1;
    const int c = pc0 + rem % kChunkPacks;
    const bool ok = e < plane_packs && j >= 0 && j < n && k >= 0 && k < n &&
                    c < packs;
    st_v[q] = ok ? j * n + k : -1;
    st_src[q] = ok ? (j * n + k) * channels + c * VEC : 0;
  }
  // The output packs this thread computes in every plane: byte offset of
  // the vertex's staged slot from that of output row 0, column 0; its
  // vertex in the plane (-1: none, computed at offset 0 and dropped); its
  // element offset in the plane.
  int it_s[kItems], it_v[kItems], it_o[kItems];
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const int e = t + q * kTiledThreads;
    const int r = e / (n * kChunkPacks), rem = e % (n * kChunkPacks);
    const int k = rem / kChunkPacks, cp = rem % kChunkPacks;
    const bool ok = r < rows && j0 + r < n && pc0 + cp < packs;
    it_s[q] = ok ? ((r * np + k) * kChunkPacks + cp) * 16 : 0;
    it_v[q] = ok ? (j0 + r) * n + k : -1;
    it_o[q] = ok ? ((j0 + r) * n + k) * channels + (pc0 + cp) * VEC : 0;
  }

  auto slot = [&](int plane) {
    return ((plane - i_begin + 1) % kRing) * plane_packs;
  };
  auto issue = [&](int plane) {  // zero filled outside the lattice
    if (plane <= i_end) {
      uint4* dst = s_ring + slot(plane);
      const bool live = plane >= 0 && plane < n;
      const T* src = x + xb + (long long)plane * n2 * channels;
#pragma unroll
      for (int q = 0; q < kStage; ++q) {
        const int e = t + q * kTiledThreads;
        if (e < plane_packs) {
          const bool ok = live && st_v[q] >= 0;
          cp_async16(dst + e, ok ? src + st_src[q] : x, ok ? 16 : 0);
        }
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
  // in_scale of this thread's staged packs of one plane, loaded a plane
  // ahead of its use so that the load's latency is off the critical path.
  float si[kStage];
  auto load_scale = [&](int plane) {
#pragma unroll
    for (int q = 0; q < kStage; ++q)
      si[q] = plane >= 0 && plane < n && st_v[q] >= 0
                  ? in_scale[(long long)plane * n2 + st_v[q]]
                  : 1.f;
  };
  auto rescale = [&](int plane) {  // in place, on this thread's own packs
    if (plane < 0 || plane >= n) return;
    uint4* buf = s_ring + slot(plane);
#pragma unroll
    for (int q = 0; q < kStage; ++q) {
      if (st_v[q] < 0) continue;
      P p = *reinterpret_cast<const P*>(buf + t + q * kTiledThreads);
#pragma unroll
      for (int w = 0; w < VEC; ++w)
        p.v[w] = from_float<T>(__fmul_rn(to_float<T>(p.v[w]), si[q]));
      *reinterpret_cast<P*>(buf + t + q * kTiledThreads) = p;
    }
  };

  for (int d = -1; d < kDepth; ++d) issue(i_begin + d);
  for (int i = i_begin; i < i_end; ++i) {
    issue(i + kDepth);
    cp_async_wait<kDepth - 1>();  // own copies of planes <= i + 1 landed
    if (IN_SCALE) {
      if (i == i_begin) {
        for (int p = i - 1; p <= i + 1; ++p) {
          load_scale(p);
          rescale(p);
        }
      } else {
        rescale(i + 1);  // its scales were loaded in the last iteration
      }
    }
    if (t < n_off) s_base[i & 1][t] = (slot(i + off_di) + off_rel) * 16;
    __syncthreads();
    float acc[kItems][VEC];
#pragma unroll
    for (int q = 0; q < kItems; ++q)
#pragma unroll
      for (int w = 0; w < VEC; ++w) acc[q][w] = 0.f;
    for (int o = 0; o < n_off; ++o) {
      const unsigned base = ring + s_base[i & 1][o];
      uint4 w[kItems];
#pragma unroll
      for (int q = 0; q < kItems; ++q) w[q] = lds128(base + it_s[q]);
#pragma unroll
      for (int q = 0; q < kItems; ++q) add_pack(acc[q], w[q], T());
    }
    const long long plane_off = (long long)i * n2;
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      if (it_v[q] < 0) continue;
      const float s = scale != nullptr ? scale[plane_off + it_v[q]] : 1.f;
      P res;
#pragma unroll
      for (int w = 0; w < VEC; ++w) res.v[w] = from_float<T>(acc[q][w] * s);
      *reinterpret_cast<P*>(out + xb + plane_off * channels + it_o[q]) = res;
    }
    if (IN_SCALE) load_scale(i + 2);
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------- launch
template <typename T, int VEC>
cudaError_t launch_simple(const void* x, void* out, const float* scale,
                          const float* in_scale, int n_off, int batch, int n,
                          int channels, cudaStream_t stream) {
  const long long total =
      (long long)batch * n * n * n * (long long)(channels / VEC);
  if (total == 0) return cudaSuccess;
  const long long blocks = (total + kThreads - 1) / kThreads;
  stencil_kernel<T, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), scale, in_scale, n_off,
      n, channels, total);
  return cudaGetLastError();
}

// Tile rows, i segments and shared memory of a tiled launch; rows == 0
// when the shape does not fit the tiled path.
struct TiledPlan {
  int rows = 0, segs = 1, seg_len = 0;
  size_t smem = 0;
};

// One cached plan per kernel instance and device (the main path calls
// each instance at one shape).
struct PlanCache {
  int dynamic_max = -1;  // opt-in limit less the static shared memory
  int key[3] = {-1, -1, -1};  // n, channels, batch
  TiledPlan plan;
};

template <typename T, bool IN_SCALE>
cudaError_t plan_tiled(int dev, int n, int channels, int batch, int optin,
                       TiledPlan* out) {
  static PlanCache cache[kMaxDevices];
  PlanCache& c = cache[dev];
  const int key[3] = {n, channels, batch};
  if (c.key[0] == n && c.key[1] == channels && c.key[2] == batch) {
    *out = c.plan;
    return cudaSuccess;
  }
  auto kernel = stencil_kernel_tiled<T, IN_SCALE>;
  if (c.dynamic_max < 0) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    const int limit = optin - (int)attr.sharedSizeBytes;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    if (err != cudaSuccess) return err;
    c.dynamic_max = limit;
  }
  TiledPlan p;
  const int vec = 16 / (int)sizeof(T);
  const int packs = channels / vec;
  // Rows per block: at most kItems output packs per thread, kStage staged
  // packs per thread, and a ring small enough for kBlocksPerSm blocks.
  const long long row_bytes = (long long)(n + 2) * kChunkPacks * 16;
  long long rows_max = (long long)kItems * kTiledThreads / (n * kChunkPacks);
  const long long stage_rows =
      (long long)kStage * kTiledThreads * 16 / row_bytes - 2;
  const long long smem_rows =
      (long long)c.dynamic_max / kBlocksPerSm / (kRing * row_bytes) - 2;
  if (stage_rows < rows_max) rows_max = stage_rows;
  if (smem_rows < rows_max) rows_max = smem_rows;
  if (rows_max >= 1 && (long long)n * n * channels < (1ll << 31)) {
    const int tiles = (int)((n + rows_max - 1) / rows_max);
    p.rows = (n + tiles - 1) / tiles;
    p.smem = (size_t)kRing * (p.rows + 2) * row_bytes;
  }
  if (p.rows > 0 && p.smem <= (size_t)c.dynamic_max) {
    // Segments along i: the fewest waves of resident blocks times the
    // planes each block stages (its segment plus two halo planes).
    int sms = 0, per_sm = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kTiledThreads, p.smem);
    if (err != cudaSuccess) return err;
    const long long slots = (long long)sms * (per_sm > 0 ? per_sm : 1);
    const long long base = (long long)((n + p.rows - 1) / p.rows) *
                           ((packs + kChunkPacks - 1) / kChunkPacks) * batch;
    long long best = -1;
    for (int sg = 1; sg <= (n + 3) / 4 && (long long)sg * batch <= 65535;
         ++sg) {
      const int len = (n + sg - 1) / sg;
      const int used = (n + len - 1) / len;
      const long long waves = (base * used + slots - 1) / slots;
      const long long cost = waves * (len + 2);
      if (best < 0 || cost < best) {
        best = cost;
        p.segs = used;
        p.seg_len = len;
      }
    }
    if (best < 0) p.rows = 0;
  } else {
    p.rows = 0;
  }
  for (int e = 0; e < 3; ++e) c.key[e] = key[e];
  c.plan = p;
  *out = p;
  return cudaSuccess;
}

template <typename T, bool IN_SCALE>
cudaError_t launch_tiled(const TiledPlan& p, const void* x, void* out,
                         const float* scale, const float* in_scale,
                         int n_off, int batch, int n, int channels,
                         cudaStream_t stream) {
  const int packs = channels / (16 / (int)sizeof(T));
  dim3 grid((n + p.rows - 1) / p.rows,
            (packs + kChunkPacks - 1) / kChunkPacks, batch * p.segs);
  stencil_kernel_tiled<T, IN_SCALE><<<grid, kTiledThreads, p.smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), scale, in_scale, n_off,
      n, channels, p.rows, p.segs, p.seg_len);
  return cudaGetLastError();
}

// Launches the tiled path; cudaErrorNotSupported if the shape does not
// fit it.
template <typename T>
cudaError_t run_tiled(int dev, int optin, const void* x, void* out,
                      const float* scale, const float* in_scale, int n_off,
                      int batch, int n, int channels, cudaStream_t stream) {
  TiledPlan p;
  cudaError_t err =
      in_scale != nullptr
          ? plan_tiled<T, true>(dev, n, channels, batch, optin, &p)
          : plan_tiled<T, false>(dev, n, channels, batch, optin, &p);
  if (err != cudaSuccess) return err;
  if (p.rows <= 0) return cudaErrorNotSupported;
  return in_scale != nullptr
             ? launch_tiled<T, true>(p, x, out, scale, in_scale, n_off,
                                     batch, n, channels, stream)
             : launch_tiled<T, false>(p, x, out, scale, in_scale, n_off,
                                      batch, n, channels, stream);
}

cudaError_t prepare_device(const int* offsets, int n_off, int* dev_out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  *dev_out = dev;
  if (g_smem_optin[dev] == 0) {
    err = cudaDeviceGetAttribute(&g_smem_optin[dev],
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
  }
  bool same = g_host_valid[dev] && g_host_count[dev] == n_off;
  for (int e = 0; same && e < 3 * n_off; ++e)
    same = g_host_offsets[dev][e] == offsets[e];
  if (same) return cudaSuccess;
  err = cudaMemcpyToSymbol(c_offsets, offsets, sizeof(int) * 3 * n_off);
  if (err != cudaSuccess) return err;
  for (int e = 0; e < 3 * n_off; ++e) g_host_offsets[dev][e] = offsets[e];
  g_host_count[dev] = n_off;
  g_host_valid[dev] = true;
  return cudaSuccess;
}

}  // namespace

// x, out: (batch, n^3, channels) contiguous, float (is_bf16 = 0) or
// bfloat16 (is_bf16 = 1); scale, in_scale: (n^3,) float or null; offsets:
// host array of 3 * n_off ints in {-1, 0, 1}; vec: channels per pack
// (divides channels; packs of 16 bytes need 16-byte aligned x and out,
// and take the tiled path, which refuses a shape whose ring does not fit
// in shared memory).
extern "C" int deftet_stencil(const void* x, void* out, const float* scale,
                              const float* in_scale, const int* offsets,
                              int n_off, int batch, int n, int channels,
                              int is_bf16, int vec, void* stream) {
  if (n_off < 0 || n_off > kMaxOffsets || vec <= 0 || channels % vec != 0 ||
      batch > 65535)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = prepare_device(offsets, n_off, &dev);
  if (err != cudaSuccess) return (int)err;
  if ((long long)batch * n * channels == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int optin = g_smem_optin[dev];
  if (vec * (is_bf16 ? 2 : 4) == 16)  // whole 16-byte packs
    return (int)(is_bf16 ? run_tiled<__nv_bfloat16>(dev, optin, x, out, scale,
                                                    in_scale, n_off, batch, n,
                                                    channels, s)
                         : run_tiled<float>(dev, optin, x, out, scale,
                                            in_scale, n_off, batch, n,
                                            channels, s));
  if (is_bf16) {
    switch (vec) {
      case 4: return (int)launch_simple<__nv_bfloat16, 4>(x, out, scale, in_scale, n_off, batch, n, channels, s);
      case 2: return (int)launch_simple<__nv_bfloat16, 2>(x, out, scale, in_scale, n_off, batch, n, channels, s);
      case 1: return (int)launch_simple<__nv_bfloat16, 1>(x, out, scale, in_scale, n_off, batch, n, channels, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (vec) {
    case 2: return (int)launch_simple<float, 2>(x, out, scale, in_scale, n_off, batch, n, channels, s);
    case 1: return (int)launch_simple<float, 1>(x, out, scale, in_scale, n_off, batch, n, channels, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* deftet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
