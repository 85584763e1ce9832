// K1: 14-offset lattice stencil (row-normalized neighbour mean on the Kuhn
// vertex lattice).
//
//   out[b, v, c] = scale[v] * sum_{o} x[b, v + off_o, c]
//
// over the n^3 vertex lattice in i*n^2 + j*n + k order; reads outside the
// lattice are zero.  Accumulation is f32, storage is the input type
// (float or bfloat16).  scale == nullptr means unit scale (the backward).
//
// Replaces deftet_tpu/ops/stencil_pallas.py:_stencil3d_kernel (reached via
// stencil_sum / lattice_neighbor_mean).  That kernel shipped three
// zero-padded (JP, KP, CB) row planes per grid step into VMEM; here the
// lattice bounds are checked in the index arithmetic, so no padded copy of
// x is ever made.
//
// Bound on the H100: memory bytes.  The minimum traffic is one read of x
// and one write of out (14 neighbour reads per element otherwise).  Design:
// one thread per (b, v, pack of channels), channels innermost, so a warp
// reads a contiguous run of each neighbour row with 16-byte vector loads;
// the neighbour rows of one i-plane are n^2*C elements apart, a few MB, so
// the 14x re-reads hit L2 and DRAM sees about one pass over x.  The offset
// table lives in __constant__ memory (a warp reads the same entry: one
// broadcast).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxOffsets = 27;
constexpr int kMaxDevices = 64;
constexpr int kThreads = 256;

__constant__ int c_offsets[kMaxOffsets * 3];

// Host copy of what each device's c_offsets holds, so the table is copied
// only when it changes (a blocking copy: no launch can see a half-written
// table).
int g_host_offsets[kMaxDevices][kMaxOffsets * 3];
int g_host_count[kMaxDevices];
bool g_host_valid[kMaxDevices];

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

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    stencil_kernel(const T* __restrict__ x, T* __restrict__ out,
                   const float* __restrict__ scale, int n_off, int n,
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
      const long long src =
          batch_base + ((long long)(ii * n + jj) * n + kk) * channels + c0;
      const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(x + src);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] += to_float<T>(p.v[e]);
    }
  }

  const float s = scale != nullptr ? scale[v] : 1.f;
  Pack<T, VEC> res;
#pragma unroll
  for (int e = 0; e < VEC; ++e) res.v[e] = from_float<T>(acc[e] * s);
  *reinterpret_cast<Pack<T, VEC>*>(out + row * channels + c0) = res;
}

template <typename T, int VEC>
cudaError_t launch(const void* x, void* out, const float* scale, int n_off,
                   int batch, int n, int channels, cudaStream_t stream) {
  const long long total =
      (long long)batch * n * n * n * (long long)(channels / VEC);
  if (total == 0) return cudaSuccess;
  const long long blocks = (total + kThreads - 1) / kThreads;
  stencil_kernel<T, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), scale, n_off, n,
      channels, total);
  return cudaGetLastError();
}

cudaError_t set_offsets(const int* offsets, int n_off) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
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
// bfloat16 (is_bf16 = 1); scale: (n^3,) float or null; offsets: host array
// of 3 * n_off ints in {-1, 0, 1}; vec: channels per thread (divides
// channels; 16-byte loads need 16-byte aligned x and out).
extern "C" int deftet_stencil(const void* x, void* out, const float* scale,
                              const int* offsets, int n_off, int batch, int n,
                              int channels, int is_bf16, int vec,
                              void* stream) {
  if (n_off < 0 || n_off > kMaxOffsets || vec <= 0 || channels % vec != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = set_offsets(offsets, n_off);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    switch (vec) {
      case 8: return (int)launch<__nv_bfloat16, 8>(x, out, scale, n_off, batch, n, channels, s);
      case 4: return (int)launch<__nv_bfloat16, 4>(x, out, scale, n_off, batch, n, channels, s);
      case 2: return (int)launch<__nv_bfloat16, 2>(x, out, scale, n_off, batch, n, channels, s);
      case 1: return (int)launch<__nv_bfloat16, 1>(x, out, scale, n_off, batch, n, channels, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (vec) {
    case 4: return (int)launch<float, 4>(x, out, scale, n_off, batch, n, channels, s);
    case 2: return (int)launch<float, 2>(x, out, scale, n_off, batch, n, channels, s);
    case 1: return (int)launch<float, 1>(x, out, scale, n_off, batch, n, channels, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* deftet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
