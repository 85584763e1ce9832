// K3: point-to-triangle-soup argmin.
//
// For each point p of batch b: the index of the unmasked triangle with the
// least squared point-to-triangle distance, by the region-based closest
// point (Ericson, Real-Time Collision Detection 5.1.5) in the region order
// and with the guarded division of deftet_tpu/ops/tri_distance_pallas.py
// (safe_div eps 1e-20); ties to the lowest index; 0 when every face is
// masked.  Faces at or past n_active[b] (1 + index of the last unmasked
// face) are not scanned.  Returns the index only: the differentiable
// distance is recomputed on the chosen face in ops/tri_distance.py.
//
// Replaces deftet_tpu/ops/tri_distance_pallas.py:_tri_kernel (reached via
// tri_argmin_pallas_single / tri_argmin_pallas).
//
// Bound on the H100: f32 arithmetic on the CUDA cores (~4e8 point-triangle
// pairs per res-50 train step at ~100 flops each).  Design: one thread per
// point with its coordinates in registers; faces staged through shared
// memory as nine coordinate rows plus the mask, so every thread of a warp
// reads the same face (one broadcast per operand) and runs the branchy
// region test on registers; the scan stops at n_active, so only the real
// prefix of a compacted face budget is touched.  Built with -fmad=false so
// the rounding matches the plain PyTorch version exactly.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;  // points per block, one per thread
constexpr int kChunk = 256;  // faces per shared-memory pass (10 KB)
constexpr float kBig = 1.0e30f;
constexpr float kEps = 1.0e-20f;

__device__ __forceinline__ float safe_div(float x, float y) {
  return x / (fabsf(y) < kEps ? 1.f : y);
}

__device__ __forceinline__ float point_tri_d2(float px, float py, float pz,
                                              float ax, float ay, float az,
                                              float bx, float by, float bz,
                                              float cx, float cy, float cz) {
  const float abx = bx - ax, aby = by - ay, abz = bz - az;
  const float acx = cx - ax, acy = cy - ay, acz = cz - az;
  const float apx = px - ax, apy = py - ay, apz = pz - az;
  const float d1 = abx * apx + aby * apy + abz * apz;
  const float d2 = acx * apx + acy * apy + acz * apz;
  const float bpx = px - bx, bpy = py - by, bpz = pz - bz;
  const float d3 = abx * bpx + aby * bpy + abz * bpz;
  const float d4 = acx * bpx + acy * bpy + acz * bpz;
  const float cpx = px - cx, cpy = py - cy, cpz = pz - cz;
  const float d5 = abx * cpx + aby * cpy + abz * cpz;
  const float d6 = acx * cpx + acy * cpy + acz * cpz;
  const float va = d3 * d6 - d5 * d4;
  const float vb = d5 * d2 - d1 * d6;
  const float vc = d1 * d4 - d3 * d2;

  float qx, qy, qz;
  // Highest-priority region first: the Pallas kernel applies its where()
  // cascade in the reverse order, so the last region it applies wins.
  if (d1 <= 0.f && d2 <= 0.f) {
    qx = ax; qy = ay; qz = az;
  } else if (d3 >= 0.f && d4 <= d3) {
    qx = bx; qy = by; qz = bz;
  } else if (d6 >= 0.f && d5 <= d6) {
    qx = cx; qy = cy; qz = cz;
  } else if (vc <= 0.f && d1 >= 0.f && d3 <= 0.f) {
    const float v_ab = safe_div(d1, d1 - d3);
    qx = ax + v_ab * abx; qy = ay + v_ab * aby; qz = az + v_ab * abz;
  } else if (vb <= 0.f && d2 >= 0.f && d6 <= 0.f) {
    const float w_ac = safe_div(d2, d2 - d6);
    qx = ax + w_ac * acx; qy = ay + w_ac * acy; qz = az + w_ac * acz;
  } else if (va <= 0.f && d4 - d3 >= 0.f && d5 - d6 >= 0.f) {
    const float w_bc = safe_div(d4 - d3, (d4 - d3) + (d5 - d6));
    qx = bx + w_bc * (cx - bx);
    qy = by + w_bc * (cy - by);
    qz = bz + w_bc * (cz - bz);
  } else {
    const float denom = va + vb + vc;
    const float v_in = safe_div(vb, denom);
    const float w_in = safe_div(vc, denom);
    qx = ax + v_in * abx + w_in * acx;
    qy = ay + v_in * aby + w_in * acy;
    qz = az + v_in * abz + w_in * acz;
  }
  const float dx = px - qx, dy = py - qy, dz = pz - qz;
  return dx * dx + dy * dy + dz * dz;
}

__global__ void __launch_bounds__(kBlock)
    tri_argmin_kernel(const float* __restrict__ pts,
                      const float* __restrict__ tri,
                      const float* __restrict__ mask,
                      const int* __restrict__ n_active,
                      int* __restrict__ idx_out, int P, int F) {
  __shared__ float s_tri[9][kChunk];
  __shared__ float s_mask[kChunk];
  const int b = blockIdx.y;
  const int p = blockIdx.x * kBlock + threadIdx.x;
  const long long ob = (long long)b * P;

  float px = 0.f, py = 0.f, pz = 0.f;
  if (p < P) {
    const float* pp = pts + (ob + p) * 3;
    px = pp[0];
    py = pp[1];
    pz = pp[2];
  }
  const int na = min(max(n_active[b], 0), F);
  const float* tb = tri + (long long)b * F * 9;
  const float* mb = mask + (long long)b * F;
  float best = kBig;
  int best_i = 0;
  for (int s = 0; s < na; s += kChunk) {
    const int cnt = min(kChunk, na - s);
    __syncthreads();
    for (int e = threadIdx.x; e < cnt * 9; e += kBlock)
      s_tri[e % 9][e / 9] = tb[(long long)s * 9 + e];
    for (int f = threadIdx.x; f < cnt; f += kBlock) s_mask[f] = mb[s + f];
    __syncthreads();
    for (int f = 0; f < cnt; ++f) {
      if (!(s_mask[f] > 0.f)) continue;  // uniform over the block
      const float d = point_tri_d2(
          px, py, pz, s_tri[0][f], s_tri[1][f], s_tri[2][f], s_tri[3][f],
          s_tri[4][f], s_tri[5][f], s_tri[6][f], s_tri[7][f], s_tri[8][f]);
      if (d < best) {  // strict: the lowest index wins a tie
        best = d;
        best_i = s + f;
      }
    }
  }
  if (p < P) idx_out[ob + p] = best_i;
}

}  // namespace

// pts: (batch, P, 3) float; tri: (batch, F, 3, 3) float; mask: (batch, F)
// float; n_active: (batch,) int on the device; idx_out: (batch, P) int.
extern "C" int deftet_tri_argmin(const float* pts, const float* tri,
                                 const float* mask, const int* n_active,
                                 int* idx_out, int batch, int P, int F,
                                 void* stream) {
  if (batch <= 0 || P <= 0) return (int)cudaSuccess;
  if (batch > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((P + kBlock - 1) / kBlock, batch);
  tri_argmin_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      pts, tri, mask, n_active, idx_out, P, F);
  return (int)cudaGetLastError();
}

extern "C" const char* deftet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
