// K2: brute-force nearest neighbour (squared distance + argmin).
//
// For each query q of batch b: the nearest of the first n_valid[b]
// reference points by direct difference sum((r - q)^2) (not the
// |a|^2 + |b|^2 - 2ab expansion), ties to the lowest index, distance
// clamped >= 0.  With no valid reference the result is (1e30, 0).  Queries
// in 512-query tiles that lie wholly past n_queries[b] write (0, 0) and
// skip the scan (the unused tail of a compacted sample budget).  Forward
// only: the gradient is a gather recompute in ops/nearest.py.
//
// Replaces deftet_tpu/ops/nearest_pallas.py:_nn_kernel (reached via
// nn_pallas_single / _nn_single_scan_refs / nearest_neighbor_pallas).  That
// kernel held the whole reference cloud in VMEM, which capped it at 16,384
// points; here references stream through shared memory in chunks, so any
// count works.
//
// Bound on the H100: f32 arithmetic on the CUDA cores (~4e9 pair distances
// per res-50 train step, 8 flops each).  Design: one thread per query with
// its coordinates in registers, a block of 256 queries, and references
// staged once per block as float4 in shared memory, so each pair costs one
// broadcast 16-byte shared load and a handful of FP32 instructions; the
// device memory traffic is one read of each cloud per block.  Built with
// -fmad=false so the rounding matches the plain PyTorch version exactly.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;  // queries per block, one per thread
constexpr int kChunk = 2048;  // references per shared-memory pass (32 KB)
constexpr int kTile = 512;    // query-tile granularity of the skip rule
constexpr float kBig = 1.0e30f;
static_assert(kTile % kBlock == 0, "a block must lie inside one query tile");

__global__ void __launch_bounds__(kBlock)
    nearest_kernel(const float* __restrict__ q, const float* __restrict__ r,
                   const int* __restrict__ n_valid,
                   const int* __restrict__ n_queries, float* __restrict__ d_out,
                   int* __restrict__ i_out, int P, int M) {
  __shared__ float4 s_ref[kChunk];
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kBlock;
  const int p = q0 + threadIdx.x;
  const long long ob = (long long)b * P;

  if ((q0 / kTile) * kTile >= n_queries[b]) {  // uniform over the block
    if (p < P) {
      d_out[ob + p] = 0.f;
      i_out[ob + p] = 0;
    }
    return;
  }

  const int nv = min(max(n_valid[b], 0), M);
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (p < P) {
    const float* qp = q + (ob + p) * 3;
    qx = qp[0];
    qy = qp[1];
    qz = qp[2];
  }
  const float* rb = r + (long long)b * M * 3;
  float best = kBig;
  int best_i = 0;
  for (int s = 0; s < nv; s += kChunk) {
    const int cnt = min(kChunk, nv - s);
    __syncthreads();
    for (int t = threadIdx.x; t < cnt; t += kBlock) {
      const float* rp = rb + (long long)(s + t) * 3;
      s_ref[t] = make_float4(rp[0], rp[1], rp[2], 0.f);
    }
    __syncthreads();
    for (int t = 0; t < cnt; ++t) {
      const float4 rv = s_ref[t];
      const float dx = rv.x - qx;
      const float dy = rv.y - qy;
      const float dz = rv.z - qz;
      const float d = dx * dx + dy * dy + dz * dz;
      if (d < best) {  // strict: the lowest index wins a tie
        best = d;
        best_i = s + t;
      }
    }
  }
  if (p < P) {
    d_out[ob + p] = fmaxf(best, 0.f);
    i_out[ob + p] = best_i;
  }
}

}  // namespace

// q: (batch, P, 3) float; r: (batch, M, 3) float; n_valid, n_queries:
// (batch,) int on the device; d_out (batch, P) float; i_out (batch, P) int.
extern "C" int deftet_nearest(const float* q, const float* r,
                              const int* n_valid, const int* n_queries,
                              float* d_out, int* i_out, int batch, int P,
                              int M, void* stream) {
  if (batch <= 0 || P <= 0) return (int)cudaSuccess;
  if (batch > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((P + kBlock - 1) / kBlock, batch);
  nearest_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      q, r, n_valid, n_queries, d_out, i_out, P, M);
  return (int)cudaGetLastError();
}

extern "C" const char* deftet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
