// K2: brute-force nearest neighbour (squared distance + argmin).
//
// For each query q of batch b: the nearest of the first n_valid[b]
// reference points by direct difference sum((r - q)^2), summed x, y, z in
// order (not the |a|^2 + |b|^2 - 2ab expansion), ties to the lowest index,
// distance clamped >= 0.  With no valid reference the result is (1e30, 0).
// Queries in 512-query tiles that lie wholly past n_queries[b] write (0, 0)
// and are not scanned (the unused tail of a compacted sample budget).  Any
// reference count works.  A distance that is NaN is never taken (as the
// Pallas kernel's `d < best` never takes it).  Forward only: the gradient
// is a gather recompute in ops/nearest.py.
//
// Replaces deftet_tpu/ops/nearest_pallas.py:_nn_kernel (reached via
// nn_pallas_single / _nn_single_scan_refs / nearest_neighbor_pallas).
//
// Bound on the H100: f32 arithmetic on the CUDA cores.  A pair costs 8
// flops (3 sub, 3 mul, 2 add): 4.0e9 pairs per res-50 train step (4 x
// 200,000 queries against 5,000 references) are 0.48 ms at the 67 TFLOP/s
// float32 peak, and 1.0e10 pairs at the eval metrics' shape (100,000
// against 100,000) 1.19 ms.  That peak counts a fused multiply-add as two
// flops.  This file is built with -fmad=false, so that every product and
// sum is rounded as the plain PyTorch version rounds it and the indices
// and distances agree with it bit for bit; no instruction then does two
// flops, and the ceiling is half the peak (0.96 ms and 2.39 ms).  The
// tensor cores do not serve: they compute the expansion, which rounds
// differently.  So the kernel is bound by instruction issue, and the design
// spends as few issue slots per pair as it can beside the 8 flops:
// - Register tiling: each thread holds kQ = 12 queries, so one broadcast
//   shared load of a reference serves 12 pairs.  References are staged as
//   three planes x[], y[], z[], and three 16-byte loads bring 4 references.
// - Deferred argmin: the inner loop keeps only the running minimum of each
//   query, half an instruction per pair (min3 below takes two distances):
//   8.5 instructions per pair in all.  At the end of each sub-tile of
//   kSub = 32 references, a query whose minimum fell strictly below its
//   value before that sub-tile records the sub-tile's start.  After the
//   scan, the warp rescans that one sub-tile per query, one reference per
//   lane, with the same instruction sequence, and takes the first lane
//   whose distance equals the minimum.  This is exact: the strict test
//   keeps the earliest sub-tile that reaches the minimum, and the
//   recomputed distance is bit-identical, so the first equal index in it is
//   the lowest overall.
// - Staging: each block stages its split of the references through a ring
//   of kStages slots of kStage references in dynamic shared memory, by
//   4-byte cp.async copies issued kStages - 1 chunks ahead of the compute,
//   one barrier per chunk.  The (B, M, 3) rows are 12 bytes and are
//   repacked into the three planes on the way (a copy per float: the
//   staging is read by 3,072 queries, so its cost is negligible); the tail
//   of a chunk is padded to a whole sub-tile with NaN, which is never taken.
//   When a split's references fit in the ring (up to 5,120) they stay
//   resident and the rescan reads shared memory; otherwise it reads device
//   memory, which the L2 holds.
// - Filling the card: a block holds 3,072 queries (8 warps of 384
//   contiguous queries), 2 blocks per SM (128 registers a thread).  Where
//   the query blocks of a call fill the resident block slots badly, the
//   reference axis is split over blocks: plan() picks the split count that
//   minimises the number of waves per unit of work, from the occupancy API.
//   Each split runs its own deferred argmin; splits merge exactly by a
//   64-bit atomicMax of the complemented (distance bits, global index) key,
//   since the float bits of d >= +0 order as integers; the last block of
//   each query block to finish (a counter per query block) writes the
//   outputs.  At the main shape the plan keeps one split (4 x 66 query
//   blocks fill the 264 slots of 132 SMs); at the eval shape it splits 33
//   query blocks 8 ways (12,512 references each).
// - The 512-query skip is decided per query: a warp whose queries all lie
//   in dead tiles scans nothing, a block whose queries all do returns at
//   once, and dead queries in a warp that scans write (0, 0).
// One call is one kernel launch, plus one memset of the merge scratch when
// the plan splits the references.
// On the card (NVIDIA H100 80GB HBM3, 1980 MHz) the inner loop issues the
// 8.5 instructions per pair and little else, yet runs at about 78 % of that
// issue rate: 1.30 ms at the main shape, where 8.5 instructions per pair
// would take 1.02 ms (PERF.md).

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kWarps = 8;                      // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 2;                  // resident blocks per SM aimed at
constexpr int kQ = 12;                         // queries per thread
constexpr int kWarpQ = 32 * kQ;                // contiguous queries per warp
constexpr int kBlockQ = kWarps * kWarpQ;       // queries per block
constexpr int kSub = 32;                       // references per sub-tile
constexpr int kStage = 1024;                   // references per ring slot
constexpr int kStages = 5;                     // ring slots
constexpr int kTile = 512;                     // query tile of the skip rule
constexpr int kMinSplit = 1024;                // fewest references per split
constexpr float kBig = 1.0e30f;
constexpr size_t kSmemBytes = sizeof(float) * 3 * kStage * kStages;
static_assert(kSub == 32, "the rescan gives each lane one reference");
static_assert(kStage % kSub == 0, "a sub-tile must not straddle two slots");
static_assert(kStages >= 2, "the ring needs a slot to fill beside one read");

__device__ __forceinline__ float sq_dist(float rx, float ry, float rz,
                                         float qx, float qy, float qz) {
  const float dx = rx - qx, dy = ry - qy, dz = rz - qz;
  return dx * dx + dy * dy + dz * dz;
}

// min(m, d0, d1) in one instruction (VIMNMX3), on the float bits as
// unsigned integers: a distance is +0 or more (a sum of squares is never
// -0), and those bits order as the values do; a NaN of either sign orders
// above +inf, so it is never taken, as with fminf.
__device__ __forceinline__ float min3(float m, float d0, float d1) {
  return __uint_as_float(__vimin3_u32(__float_as_uint(m), __float_as_uint(d0),
                                      __float_as_uint(d1)));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage references [s, s + cnt) of one batch (rows of 3 floats at rb) into
// a ring slot as planes x, y, z, and pad the last sub-tile with NaN.
__device__ __forceinline__ void stage_chunk(float* slot, const float* rb,
                                            int s, int cnt) {
  for (int t = threadIdx.x; t < cnt; t += kThreads) {
    const float* src = rb + 3ll * (s + t);
    cp_async4(slot + t, src);
    cp_async4(slot + kStage + t, src + 1);
    cp_async4(slot + 2 * kStage + t, src + 2);
  }
  const int padded = (cnt + kSub - 1) / kSub * kSub;
  for (int t = cnt + threadIdx.x; t < padded; t += kThreads) {
    const float nan = __int_as_float(0x7fffffff);
    slot[t] = nan;
    slot[kStage + t] = nan;
    slot[2 * kStage + t] = nan;
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    nearest_kernel(const float* __restrict__ q, const float* __restrict__ r,
                   const int* __restrict__ n_valid,
                   const int* __restrict__ n_queries,
                   float* __restrict__ d_out, int* __restrict__ i_out,
                   unsigned long long* __restrict__ keys,
                   unsigned long long* __restrict__ done, int P, int M,
                   int split_len) {
  extern __shared__ float4 s_ring4[];
  float* const ring = reinterpret_cast<float*>(s_ring4);
  __shared__ bool s_last;
  const int b = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int block_q0 = blockIdx.x * kBlockQ;
  const int warp_q0 = block_q0 + (threadIdx.x >> 5) * kWarpQ;
  const long long ob = (long long)b * P;
  const int nq = n_queries[b];

  if ((block_q0 / kTile) * kTile >= nq) {  // every tile dead: block-uniform
    if (blockIdx.y == 0) {
      for (int t = threadIdx.x; t < kBlockQ; t += kThreads) {
        const int p = block_q0 + t;
        if (p < P) {
          d_out[ob + p] = 0.f;
          i_out[ob + p] = 0;
        }
      }
    }
    return;
  }

  float qx[kQ], qy[kQ], qz[kQ], best[kQ];
  int sub[kQ];
  bool any_live = false;
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const int p = warp_q0 + 32 * i + lane;
    qx[i] = qy[i] = qz[i] = 0.f;
    if (p < P) {
      const float* qp = q + 3 * (ob + p);
      qx[i] = qp[0];
      qy[i] = qp[1];
      qz[i] = qp[2];
    }
    best[i] = kBig;
    sub[i] = 0;
    any_live |= p < P && (p / kTile) * kTile < nq;
  }
  const bool warp_live = __any_sync(0xffffffffu, any_live);

  // This block's split of the valid references: [s0, s1).
  const int nv = min(max(n_valid[b], 0), M);
  const int s0 = blockIdx.y * split_len;
  const int n_refs = s0 < nv ? min(split_len, nv - s0) : 0;
  const int s1 = s0 + n_refs;
  const int n_chunks = (n_refs + kStage - 1) / kStage;
  const float* const rb = r + 3ll * b * M;

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_chunks)
      stage_chunk(ring + c * 3 * kStage, rb, s0 + c * kStage,
                  min(kStage, n_refs - c * kStage));
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c is in; every warp is done with chunk c - 1
    const int nc = c + kStages - 1;
    if (nc < n_chunks)
      stage_chunk(ring + (nc % kStages) * 3 * kStage, rb, s0 + nc * kStage,
                  min(kStage, n_refs - nc * kStage));
    cp_async_commit();
    if (!warp_live) continue;
    const float* const sx = ring + (c % kStages) * 3 * kStage;
    const float* const sy = sx + kStage;
    const float* const sz = sy + kStage;
    const int cnt = min(kStage, n_refs - c * kStage);
    for (int t0 = 0; t0 < cnt; t0 += kSub) {
      float run[kQ];
#pragma unroll
      for (int i = 0; i < kQ; ++i) run[i] = best[i];
#pragma unroll 1
      for (int t = t0; t < t0 + kSub; t += 4) {
        const float4 x = *reinterpret_cast<const float4*>(sx + t);
        const float4 y = *reinterpret_cast<const float4*>(sy + t);
        const float4 z = *reinterpret_cast<const float4*>(sz + t);
#pragma unroll
        for (int i = 0; i < kQ; ++i) {
          run[i] = min3(run[i], sq_dist(x.x, y.x, z.x, qx[i], qy[i], qz[i]),
                        sq_dist(x.y, y.y, z.y, qx[i], qy[i], qz[i]));
          run[i] = min3(run[i], sq_dist(x.z, y.z, z.z, qx[i], qy[i], qz[i]),
                        sq_dist(x.w, y.w, z.w, qx[i], qy[i], qz[i]));
        }
      }
      const int st = s0 + c * kStage + t0;
#pragma unroll
      for (int i = 0; i < kQ; ++i) {
        if (run[i] < best[i]) sub[i] = st;  // strict: the earliest sub-tile
        best[i] = run[i];
      }
    }
  }

  // Rescan the recorded sub-tile of each found query, a lane a reference,
  // then write the query's result (one split) or merge it into its key
  // (complemented, so that a zeroed scratch means "none found" and
  // atomicMax keeps the least key).
  const bool resident = n_chunks <= kStages;
  const bool one_split = gridDim.y == 1;
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const int p = warp_q0 + 32 * i + lane;
    const bool live = p < P && (p / kTile) * kTile < nq;
    const bool found = live && best[i] < kBig;
    int idx = 0;
    unsigned pending = warp_live ? __ballot_sync(0xffffffffu, found) : 0u;
    while (pending) {
      const int src = __ffs(pending) - 1;
      pending &= pending - 1;
      const float m = __shfl_sync(0xffffffffu, best[i], src);
      const int st = __shfl_sync(0xffffffffu, sub[i], src);
      const float px = __shfl_sync(0xffffffffu, qx[i], src);
      const float py = __shfl_sync(0xffffffffu, qy[i], src);
      const float pz = __shfl_sync(0xffffffffu, qz[i], src);
      const int j = st + lane;
      bool hit = false;
      if (j < s1) {
        float rx, ry, rz;
        if (resident) {
          const int o = j - s0;
          const float* sp = ring + (o / kStage) * 3 * kStage + o % kStage;
          rx = sp[0];
          ry = sp[kStage];
          rz = sp[2 * kStage];
        } else {
          const float* rp = rb + 3ll * j;
          rx = rp[0];
          ry = rp[1];
          rz = rp[2];
        }
        hit = sq_dist(rx, ry, rz, px, py, pz) == m;
      }
      const unsigned hits = __ballot_sync(0xffffffffu, hit);
      if (lane == src) idx = st + __ffs(hits) - 1;
    }
    if (one_split) {
      if (p < P) {
        d_out[ob + p] = live ? fmaxf(best[i], 0.f) : 0.f;
        i_out[ob + p] = live ? idx : 0;
      }
    } else if (found) {
      const unsigned long long key =
          ((unsigned long long)__float_as_uint(best[i]) << 32) |
          (unsigned int)idx;
      atomicMax(keys + ob + p, ~key);
    }
  }
  if (one_split) return;

  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned long long seen =
        atomicAdd(done + (long long)b * gridDim.x + blockIdx.x, 1ull);
    s_last = seen == gridDim.y - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const int p = warp_q0 + 32 * i + lane;
    if (p >= P) continue;
    float d = 0.f;
    int k = 0;
    if ((p / kTile) * kTile < nq) {
      const unsigned long long key = ~__ldcg(keys + ob + p);
      const bool found = key != ~0ull;
      d = found ? fmaxf(__uint_as_float((unsigned int)(key >> 32)), 0.f)
                : kBig;
      k = found ? (int)(unsigned int)(key & 0xffffffffull) : 0;
    }
    d_out[ob + p] = d;
    i_out[ob + p] = k;
  }
}

// Resident blocks per SM and SM count, per device, once known.
constexpr int kMaxDevices = 64;
int g_slots[kMaxDevices];
int g_per_sm[kMaxDevices];

struct Plan {
  int blocks_q;   // query blocks per batch (grid x)
  int splits;     // reference splits (grid y)
  int split_len;  // references per split
  int per_sm;     // resident blocks per SM at this kernel's occupancy
  long long scratch_words;  // 64-bit words of merge scratch (0: one split)
};

cudaError_t plan(int batch, int P, int M, Plan* out) {
  if (batch <= 0 || batch > 65535 || P <= 0 || P > (1 << 30) || M < 0 ||
      M > (1 << 30))
    return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (g_slots[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(nearest_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemBytes);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, nearest_kernel, kThreads, kSmemBytes);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorNotSupported;  // cannot be resident
    g_per_sm[dev] = per_sm;
    g_slots[dev] = sms * per_sm;
  }
  const long long blocks_q = (P + (long long)kBlockQ - 1) / kBlockQ;
  const long long blocks = blocks_q * batch;
  const long long slots = g_slots[dev];
  // Split count: the fewest waves per unit of work (ceil(blocks * s /
  // slots) / s), the smallest s on a tie; at most 4 waves' worth of
  // blocks and at least kMinSplit references per split.
  long long max_s = (4 * slots + blocks - 1) / blocks;
  max_s = std::min(max_s, (M + (long long)kMinSplit - 1) / kMinSplit);
  max_s = std::max(std::min(max_s, 65535ll), 1ll);
  long long best_s = 1, best_waves = (blocks + slots - 1) / slots;
  for (long long s = 2; s <= max_s; ++s) {
    const long long waves = (blocks * s + slots - 1) / slots;
    if (waves * best_s < best_waves * s) {
      best_s = s;
      best_waves = waves;
    }
  }
  long long len = (M + best_s - 1) / best_s;
  len = std::max((len + kSub - 1) / kSub * kSub, (long long)kSub);
  const long long splits = M > 0 ? (M + len - 1) / len : 1;
  out->blocks_q = (int)blocks_q;
  out->splits = (int)splits;
  out->split_len = (int)len;
  out->per_sm = g_per_sm[dev];
  out->scratch_words = splits > 1 ? (long long)batch * (P + blocks_q) : 0;
  return cudaSuccess;
}

}  // namespace

// The launch plan of a (batch, P, M) call on the current device: plan_out
// gets {query blocks per batch, reference splits, references per split,
// resident blocks per SM, 64-bit words of scratch the call needs}.
extern "C" int deftet_nearest_plan(int batch, int P, int M,
                                   long long* plan_out) {
  Plan p{};
  const cudaError_t err = plan(batch, P, M, &p);
  if (err != cudaSuccess) return (int)err;
  plan_out[0] = p.blocks_q;
  plan_out[1] = p.splits;
  plan_out[2] = p.split_len;
  plan_out[3] = p.per_sm;
  plan_out[4] = p.scratch_words;
  return (int)cudaSuccess;
}

// q: (batch, P, 3) float; r: (batch, M, 3) float; n_valid, n_queries:
// (batch,) int on the device; d_out (batch, P) float; i_out (batch, P) int;
// scratch: the plan's scratch words on the device (none for one split).
extern "C" int deftet_nearest(const float* q, const float* r,
                              const int* n_valid, const int* n_queries,
                              float* d_out, int* i_out, void* scratch,
                              long long scratch_words, int batch, int P,
                              int M, void* stream) {
  Plan p{};
  cudaError_t err = plan(batch, P, M, &p);
  if (err != cudaSuccess) return (int)err;
  if (scratch_words < p.scratch_words) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* keys = nullptr;
  unsigned long long* done = nullptr;
  if (p.scratch_words > 0) {  // keys, then one counter per query block
    keys = static_cast<unsigned long long*>(scratch);
    done = keys + (long long)batch * P;
    err = cudaMemsetAsync(keys, 0, sizeof(*keys) * p.scratch_words, s);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(p.blocks_q, p.splits, batch);
  nearest_kernel<<<grid, kThreads, kSmemBytes, s>>>(
      q, r, n_valid, n_queries, d_out, i_out, keys, done, P, M,
      p.split_len);
  return (int)cudaGetLastError();
}

extern "C" const char* deftet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
