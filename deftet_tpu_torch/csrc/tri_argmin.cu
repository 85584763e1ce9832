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
// Bound on the H100: f32 arithmetic on the CUDA cores.  The res-50 train
// step scans 4e8 point-triangle pairs.  The least work of a pair depends on
// its closest-point region, taken in priority order with an early exit
// (vertex a 18 flops, b 31, c 44; edge ab 58, ac 61, bc 66; interior 74),
// plus 9 per face for b - a, c - a, c - b.  On that step's inputs 96 % of
// the pairs fall at a vertex, 32.4 flops per pair on average: 0.19 ms at
// the 67 TFLOP/s float32 peak (chip_smoke.py counts the regions).  That
// peak counts a fused multiply-add as two flops; this file is built with
// -fmad=false (every product and sum rounded as the plain PyTorch version
// rounds it), so no instruction does two flops and the ceiling is half
// the peak: about 0.39 ms.
//
// Design:
// - The grid is (point tiles, face splits, batch), with as many splits as
//   fill one wave of resident blocks (several per SM).  Each thread holds
//   kPts points in registers, so one face read from shared memory serves
//   all of them.
// - Faces are staged per chunk in shared memory with the face-only
//   differences (b - a, c - a, c - b) precomputed, five float4 per face;
//   every thread of a block reads the same face (broadcast loads).
// - The region cascade has no divergent branch: the region tests select
//   the operands of one closing formula q = o + s * u, with s one guarded
//   division (0 at a vertex); only the interior adds t * (c - a), behind a
//   warp-uniform branch that a warp rarely takes.  Each region's q keeps
//   the plain version's expression, so distances are bit-identical.
// - Splits merge exactly: d >= +0, so its float bits order as an unsigned
//   int, and the packed key (bits(d) << 32 | face index) orders by d, then
//   by index.  Each thread's best of its split goes into a per-point
//   64-bit atomicMax of the complemented key, over a scratch zeroed by the
//   launcher (0 = no face found, so index 0).  The last block of each point
//   tile to finish (a per-tile counter) writes the int32 indices.  One
//   call is one memset (keys and counters) and one kernel launch.
// What holds it back now is instruction issue: every pair takes the whole
// branch-free path, about 140 instructions (78 flops, 15 region tests,
// about 20 selects, the guarded division) where a vertex pair needs about
// 30, so it stays near 18 % of the -fmad=false ceiling.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;                  // threads per block
constexpr int kPts = 4;                        // points per thread
constexpr int kTile = kThreads * kPts;         // points per block
constexpr int kChunk = 128;                    // faces per shared pass
constexpr int kFaceF4 = 5;                     // float4 per staged face
constexpr float kBig = 1.0e30f;
constexpr float kEps = 1.0e-20f;

__device__ __forceinline__ float safe_div(float x, float y) {
  return x / (fabsf(y) < kEps ? 1.f : y);
}

// A staged face: corners and the face-only differences b-a, c-a, c-b.
struct Face {
  float ax, ay, az, bx, by, bz, cx, cy, cz;
  float abx, aby, abz, acx, acy, acz, cbx, cby, cbz;
};

// Squared distance from a point to a staged face, rounded exactly as
// ops/tri_distance.py:_tri_d2 rounds it.
__device__ __forceinline__ float point_tri_d2(float px, float py, float pz,
                                              const Face& f) {
  const float apx = px - f.ax, apy = py - f.ay, apz = pz - f.az;
  const float d1 = f.abx * apx + f.aby * apy + f.abz * apz;
  const float d2 = f.acx * apx + f.acy * apy + f.acz * apz;
  const float bpx = px - f.bx, bpy = py - f.by, bpz = pz - f.bz;
  const float d3 = f.abx * bpx + f.aby * bpy + f.abz * bpz;
  const float d4 = f.acx * bpx + f.acy * bpy + f.acz * bpz;
  const float cpx = px - f.cx, cpy = py - f.cy, cpz = pz - f.cz;
  const float d5 = f.abx * cpx + f.aby * cpy + f.abz * cpz;
  const float d6 = f.acx * cpx + f.acy * cpy + f.acz * cpz;
  const float va = d3 * d6 - d5 * d4;
  const float vb = d5 * d2 - d1 * d6;
  const float vc = d1 * d4 - d3 * d2;
  const float d43 = d4 - d3, d56 = d5 - d6;

  // Regions in priority order (the Pallas kernel's where() cascade
  // applied last-wins): vertices a, b, c, edges ab, ac, bc, interior.
  const bool r_a = d1 <= 0.f && d2 <= 0.f;
  const bool r_b = d3 >= 0.f && d4 <= d3;
  const bool r_c = d6 >= 0.f && d5 <= d6;
  const bool r_ab = vc <= 0.f && d1 >= 0.f && d3 <= 0.f;
  const bool r_ac = vb <= 0.f && d2 >= 0.f && d6 <= 0.f;
  const bool r_bc = va <= 0.f && d43 >= 0.f && d56 >= 0.f;
  const bool vertex = r_a || r_b || r_c;
  const bool edge_ab = !vertex && r_ab;
  const bool edge_ac = !vertex && !r_ab && r_ac;
  const bool edge_bc = !vertex && !r_ab && !r_ac && r_bc;
  const bool inside = !vertex && !r_ab && !r_ac && !r_bc;

  // q = o + s * u:  ab: a + v_ab*(b-a);  ac: a + w_ac*(c-a);
  // bc: b + w_bc*(c-b);  interior: (a + v_in*(b-a)) + w_in*(c-a);
  // vertex: o + 0*u, which equals o up to the sign of a zero (and so
  // gives the same squared distance).
  const float denom = (va + vb) + vc;
  const float num = edge_ab ? d1 : edge_ac ? d2 : edge_bc ? d43 : vb;
  const float den = edge_ab ? d1 - d3 : edge_ac ? d2 - d6 :
                    edge_bc ? d43 + d56 : denom;
  const bool use_b = (!r_a && r_b) || edge_bc;
  const bool use_c = !r_a && !r_b && r_c;
  const float ox = use_b ? f.bx : use_c ? f.cx : f.ax;
  const float oy = use_b ? f.by : use_c ? f.cy : f.ay;
  const float oz = use_b ? f.bz : use_c ? f.cz : f.az;
  const float ux = edge_bc ? f.cbx : edge_ac ? f.acx : f.abx;
  const float uy = edge_bc ? f.cby : edge_ac ? f.acy : f.aby;
  const float uz = edge_bc ? f.cbz : edge_ac ? f.acz : f.abz;
  // One division for every lane (a warp nearly always holds a non-vertex
  // lane, so branching around it only adds reconvergence work).
  const float sd = safe_div(num, den);
  const float s = vertex ? 0.f : sd;
  float qx = ox + s * ux, qy = oy + s * uy, qz = oz + s * uz;
  if (__any_sync(0xffffffffu, inside)) {  // a warp-uniform branch
    const float t = safe_div(vc, denom);
    if (inside) {
      qx = qx + t * f.acx;
      qy = qy + t * f.acy;
      qz = qz + t * f.acz;
    }
  }
  const float dx = px - qx, dy = py - qy, dz = pz - qz;
  return dx * dx + dy * dy + dz * dz;
}

__global__ void __launch_bounds__(kThreads)
    tri_argmin_kernel(const float* __restrict__ pts,
                      const float* __restrict__ tri,
                      const float* __restrict__ mask,
                      const int* __restrict__ n_active,
                      unsigned long long* __restrict__ keys,
                      unsigned long long* __restrict__ done,
                      int* __restrict__ idx_out, int P, int F,
                      int face_split) {
  __shared__ float4 s_face[kChunk * kFaceF4];
  __shared__ float s_mask[kChunk];
  __shared__ bool s_last;
  const int b = blockIdx.z;
  const int tile = blockIdx.x;
  const int p0 = tile * kTile + threadIdx.x;
  const long long ob = (long long)b * P;

  float px[kPts], py[kPts], pz[kPts], best[kPts];
  int best_i[kPts];
#pragma unroll
  for (int r = 0; r < kPts; ++r) {
    const int p = p0 + r * kThreads;
    px[r] = py[r] = pz[r] = 0.f;
    if (p < P) {
      const float* pp = pts + (ob + p) * 3;
      px[r] = pp[0];
      py[r] = pp[1];
      pz[r] = pp[2];
    }
    best[r] = kBig;
    best_i[r] = 0;
  }

  const int na = min(max(n_active[b], 0), F);
  const int f_begin = blockIdx.y * face_split;
  const int f_end = min(f_begin + face_split, na);
  const float* tb = tri + (long long)b * F * 9;
  const float* mb = mask + (long long)b * F;
  for (int s = f_begin; s < f_end; s += kChunk) {
    const int cnt = min(kChunk, f_end - s);
    __syncthreads();
    for (int e = threadIdx.x; e < cnt; e += kThreads) {
      const float* t = tb + (long long)(s + e) * 9;
      const float ax = t[0], ay = t[1], az = t[2];
      const float bx = t[3], by = t[4], bz = t[5];
      const float cx = t[6], cy = t[7], cz = t[8];
      float4* o = s_face + e * kFaceF4;
      o[0] = make_float4(ax, ay, az, bx);
      o[1] = make_float4(by, bz, cx, cy);
      o[2] = make_float4(cz, bx - ax, by - ay, bz - az);
      o[3] = make_float4(cx - ax, cy - ay, cz - az, cx - bx);
      o[4] = make_float4(cy - by, cz - bz, 0.f, 0.f);
      s_mask[e] = mb[s + e];
    }
    __syncthreads();
    for (int e = 0; e < cnt; ++e) {
      if (!(s_mask[e] > 0.f)) continue;  // uniform over the block
      const float4* o = s_face + e * kFaceF4;
      const float4 f0 = o[0], f1 = o[1], f2 = o[2], f3 = o[3], f4 = o[4];
      const Face f{f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w, f2.x,
                   f2.y, f2.z, f2.w, f3.x, f3.y, f3.z, f3.w, f4.x, f4.y};
#pragma unroll
      for (int r = 0; r < kPts; ++r) {
        const float d = point_tri_d2(px[r], py[r], pz[r], f);
        if (d < best[r]) {
          best[r] = d;
          best_i[r] = s + e;
        }
      }
    }
  }

  // Merge this split into the per-point keys (complemented, so that a
  // zeroed scratch means "none found" and atomicMax keeps the least key).
#pragma unroll
  for (int r = 0; r < kPts; ++r) {
    const int p = p0 + r * kThreads;
    if (p < P && best[r] < kBig) {
      const unsigned long long key =
          ((unsigned long long)__float_as_uint(best[r]) << 32) |
          (unsigned int)best_i[r];
      atomicMax(keys + ob + p, ~key);
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned long long seen =
        atomicAdd(done + (long long)b * gridDim.x + tile, 1ull);
    s_last = seen == gridDim.y - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
#pragma unroll
  for (int r = 0; r < kPts; ++r) {
    const int p = p0 + r * kThreads;
    if (p < P) {
      const unsigned long long k = __ldcg(keys + ob + p);
      idx_out[ob + p] = k == 0 ? 0 : (int)(unsigned int)(~k & 0xffffffffull);
    }
  }
}

// Faces per split: as many splits as fill one wave of resident blocks
// (the occupancy of this kernel on the current device), so that no short
// last wave is left; any count works, the chunk loop takes the remainder.
constexpr int kMaxDevices = 64;
int g_slots[kMaxDevices];  // resident blocks on each device, once known

cudaError_t plan_split(int batch, int P, int F, int* face_split) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (g_slots[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, tri_argmin_kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    g_slots[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long tiles = (P + kTile - 1) / kTile;
  const long long slots = g_slots[dev];
  long long splits = slots / (tiles * batch);
  if (splits < 1) splits = 1;
  if (splits > F) splits = F > 0 ? F : 1;
  if (splits > 65535) splits = 65535;
  *face_split = (int)((F + splits - 1) / splits);
  if (*face_split < 1) *face_split = 1;
  return cudaSuccess;
}

}  // namespace

// pts: (batch, P, 3) float; tri: (batch, F, 3, 3) float; mask: (batch, F)
// float; n_active: (batch,) int on the device; idx_out: (batch, P) int;
// scratch: at least batch * (P + ceil(P / 512)) 64-bit words on the
// device (keys, then one counter per point tile; 2 * batch * P always
// suffices).
extern "C" int deftet_tri_argmin(const float* pts, const float* tri,
                                 const float* mask, const int* n_active,
                                 int* idx_out, void* scratch,
                                 long long scratch_words, int batch, int P,
                                 int F, void* stream) {
  if (batch <= 0 || P <= 0) return (int)cudaSuccess;
  if (batch > 65535 || F < 0) return (int)cudaErrorInvalidValue;
  int face_split = 0;
  cudaError_t err = plan_split(batch, P, F, &face_split);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (P + kTile - 1) / kTile;
  const int splits = F > 0 ? (F + face_split - 1) / face_split : 1;
  const long long n_keys = (long long)batch * P;
  const long long words = n_keys + (long long)batch * tiles;
  if (scratch_words < words) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* keys = static_cast<unsigned long long*>(scratch);
  err = cudaMemsetAsync(keys, 0, sizeof(*keys) * words, s);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(tiles, splits, batch);
  tri_argmin_kernel<<<grid, kThreads, 0, s>>>(pts, tri, mask, n_active, keys,
                                              keys + n_keys, idx_out, P, F,
                                              face_split);
  return (int)cudaGetLastError();
}

extern "C" const char* deftet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
