// raster_hit: the hit pass of the depth-peeled rasterizer.
//
// For each pixel p (NDC xy, z range [lo, hi]): the ids and camera z of
// the k nearest faces that cover it, z descending (nearest first), and
// the exact number of covering faces.  A face covers p when all three
// barycentric weights are >= 0 and the interpolated z lies in [lo, hi].
// The expressions are those of the plain PyTorch version
// (render/raster.py: barycentric_2d and the hit scan), in its order:
//   denom = edge(a, b, c), 1 where |denom| < 1e-12
//   w2 = edge(a, b, p) / denom,  w0 = edge(b, c, p) / denom,
//   w1 = (1 - w0) - w2,  z = (w0 z0 + w1 z1) + w2 z2,
// with edge(a, b, p) = (bx - ax)(py - ay) - (by - ay)(px - ax).  Built
// with -fmad=false, every product and sum is rounded as the plain version
// rounds it, so ids, z and counts agree with it bit for bit.  Faces are
// taken in candidate-list order and a hit is placed after every kept hit
// of equal or greater z (a stable merge), so equal z keeps list order:
// with ascending lists, the lower face id first.  Unused slots hold
// id -1 and z -1e10.
//
// Replaces the hit pass of deftet_tpu/render/raster.py:_hit_topk_ids
// (:89, XLA: a scan over face chunks merging a (pixels, k + chunk) top-k);
// the reference's CUDA original is kaolin's deftet_sparse_render.
//
// Pixels come in consecutive tiles of tile_pixels (the last may be
// short); tile t scans the candidate list cand[offsets[t], offsets[t+1])
// (CSR; entries of -1 are skipped, so -1-padded lists of one width are
// CSR with uniform offsets, and an unbinned call is one tile holding
// every pixel with the list 0..F-1).
//
// Bound on the H100: f32 arithmetic on the CUDA cores, 19 flops a
// (pixel, candidate) pair once the face-only terms are hoisted (two
// edge functions at 5 each, two divisions, w1 2, z 5), at the float32
// rate without FMA (-fmad=false).  The output rows (k ids and z a pixel)
// are the bytes side.
//
// Design (simple first):
// - One block of 256 threads per 256 pixels of a tile, one thread per
//   pixel; a tile wider than 256 pixels spreads over several blocks that
//   read the same list.
// - Candidate faces are staged through shared memory, 256 at a time, as
//   9 floats (36 bytes: z0 z1 z2 and the three image corners) plus the id;
//   every thread reads the same face (broadcast loads).
// - Each thread keeps its hit count and the fill of its k-deep row in
//   registers; the row lives in global memory (the output itself) and a
//   hit is insertion-sorted into it from the tail.  A hit at or below the
//   k-th kept z, once the row is full, only counts.
// - The tail of the row (past its fill) is written with the fill values at
//   the end, so the outputs need no memset.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // pixels (threads) per block
constexpr int kChunk = 256;    // candidate faces staged per pass
constexpr float kEmptyZ = -1.0e10f;

__device__ __forceinline__ float edge(float ax, float ay, float bx, float by,
                                      float px, float py) {
  return (bx - ax) * (py - ay) - (by - ay) * (px - ax);
}

__global__ void __launch_bounds__(kThreads) raster_hit_kernel(
    const float* __restrict__ pix, const float* __restrict__ ranges,
    const float* __restrict__ face_z, const float* __restrict__ face_img,
    const int* __restrict__ cand, const long long* __restrict__ offsets,
    int* __restrict__ out_id, float* __restrict__ out_z,
    int* __restrict__ out_count, long long n_pix, long long tile_pixels,
    int blocks_per_tile, int k) {
  __shared__ float s_z[3][kChunk];
  __shared__ float s_xy[6][kChunk];
  __shared__ int s_id[kChunk];

  const long long tile = blockIdx.x / blocks_per_tile;
  const long long local =
      (long long)(blockIdx.x % blocks_per_tile) * kThreads + threadIdx.x;
  const long long p = tile * tile_pixels + local;
  const bool active = local < tile_pixels && p < n_pix;

  float px = 0.f, py = 0.f, lo = 0.f, hi = 0.f;
  if (active) {
    px = pix[2 * p];
    py = pix[2 * p + 1];
    lo = ranges[2 * p];
    hi = ranges[2 * p + 1];
  }
  int* row_id = out_id + (active ? p : 0) * (long long)k;
  float* row_z = out_z + (active ? p : 0) * (long long)k;
  int count = 0;
  int fill = 0;

  const long long begin = offsets[tile];
  const long long end = offsets[tile + 1];
  for (long long base = begin; base < end; base += kChunk) {
    const int n = (int)min((long long)kChunk, end - base);
    __syncthreads();  // the previous chunk has been read by every thread
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int id = cand[base + i];
      s_id[i] = id;
      if (id >= 0) {
        const float* z3 = face_z + 3LL * id;
        const float* xy6 = face_img + 6LL * id;
#pragma unroll
        for (int c = 0; c < 3; ++c) s_z[c][i] = z3[c];
#pragma unroll
        for (int c = 0; c < 6; ++c) s_xy[c][i] = xy6[c];
      }
    }
    __syncthreads();
    if (!active) continue;
    for (int i = 0; i < n; ++i) {
      const int id = s_id[i];
      if (id < 0) continue;  // the same for every thread of the block
      const float ax = s_xy[0][i], ay = s_xy[1][i];
      const float bx = s_xy[2][i], by = s_xy[3][i];
      const float cx = s_xy[4][i], cy = s_xy[5][i];
      float denom = edge(ax, ay, bx, by, cx, cy);
      if (fabsf(denom) < 1e-12f) denom = 1.0f;
      const float w2 = edge(ax, ay, bx, by, px, py) / denom;
      const float w0 = edge(bx, by, cx, cy, px, py) / denom;
      const float w1 = 1.0f - w0 - w2;
      if (!(w0 >= 0.f && w1 >= 0.f && w2 >= 0.f)) continue;
      const float z = w0 * s_z[0][i] + w1 * s_z[1][i] + w2 * s_z[2][i];
      if (!(z >= lo && z <= hi)) continue;
      ++count;
      int j;
      if (fill < k) {
        j = fill++;
      } else {
        if (k == 0 || !(z > row_z[k - 1])) continue;
        j = k - 1;  // the k-th kept hit drops out
      }
      while (j > 0) {
        const float zj = row_z[j - 1];
        if (zj >= z) break;
        row_z[j] = zj;
        row_id[j] = row_id[j - 1];
        --j;
      }
      row_z[j] = z;
      row_id[j] = id;
    }
  }
  if (active) {
    for (int j = fill; j < k; ++j) {
      row_z[j] = kEmptyZ;
      row_id[j] = -1;
    }
    out_count[p] = count;
  }
}

}  // namespace

// pix, ranges (P, 2) f32; face_z (F, 3), face_img (F, 3, 2) f32; cand (N,)
// int32 face ids (-1 skipped); offsets (n_tiles + 1,) int64 into cand;
// outputs ids (P, k) int32, z (P, k) f32, counts (P,) int32.  Requires
// n_tiles == ceil(P / tile_pixels).
extern "C" int deftet_raster_hit(const float* pix, const float* ranges,
                                 const float* face_z, const float* face_img,
                                 const int* cand, const long long* offsets,
                                 int* out_id, float* out_z, int* out_count,
                                 long long n_pix, long long n_tiles,
                                 long long tile_pixels, int k, void* stream) {
  if (n_pix <= 0) return (int)cudaSuccess;
  if (tile_pixels <= 0 || k < 0 ||
      n_tiles != (n_pix + tile_pixels - 1) / tile_pixels)
    return (int)cudaErrorInvalidValue;
  const long long per_tile = (tile_pixels + kThreads - 1) / kThreads;
  const long long blocks = n_tiles * per_tile;
  if (per_tile > 0x7fffffffLL || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  raster_hit_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      pix, ranges, face_z, face_img, cand, offsets, out_id, out_z, out_count,
      n_pix, tile_pixels, (int)per_tile, k);
  return (int)cudaGetLastError();
}

extern "C" const char* deftet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
