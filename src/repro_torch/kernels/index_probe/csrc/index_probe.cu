// Learned-index probe for Hopper (sm_90a): predecessor ranks in sorted
// float32 keys.
//
// Replaces the TPU kernel src/repro/kernels/index_probe/kernel.py:24
// (`_probe_kernel`, launched by `probe_pallas`).  That kernel answers, for
// each valid query grouped under a sorted power-of-two key tile, the count
// of tile keys <= q by a branchless bisection of log2(tile) steps plus one
// correction step.  Two entries port that function:
//
//   probe_tiles        probe_pallas's exact contract: grouped [T, qcap]
//                      queries, -1 on invalid slots.  One block per tile
//                      stages the tile's keys in shared memory; one thread
//                      per query bisects them.  Used by `batched_lookup`.
//   predecessor_ranks  route, then bisect, straight from keys [n] and
//                      queries [m] to global ranks (searchsorted right).
//                      One thread per query bisects the tile boundary keys
//                      keys[0], keys[tile], ..., then bisects inside the
//                      tile.  Any n >= 1: the last tile may be short, and
//                      its slots at n and beyond count as above every
//                      query.  Used by `predecessor_positions`: the
//                      reference reaches it through `batched_lookup` with
//                      qcap = m, which builds [n/tile, m] grouped buffers
//                      that are almost all padding.
//
// Bound: memory latency.  Each query makes log2(n) + 1 dependent loads;
// the arithmetic is one compare each.  The top levels of the boundary
// search are shared by every query and stay in L1/L2; the rest are
// scattered single-word reads.  A simple correct kernel: caching the
// boundary keys in shared memory and warp-cooperative search are later
// work.
//
// Both entries are bitwise equal to their plain versions (`probe_ref`,
// `torch.searchsorted(right=True)`) on sorted keys, ties and +-inf
// included: the bisection counts keys <= q exactly.
//
// The C entries launch on the caller's stream, allocate nothing and return
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Count of keys <= q in a sorted tile of power-of-two length 2^log2_tile
// whose first `len` slots hold keys (probe_pallas's arithmetic).  Slots at
// `len` and beyond count as above q, so the predicate stays a prefix and
// the count never exceeds len.  After the loop lo = min(count, tile - 1);
// the correction step adds the last key.
__device__ __forceinline__ int tile_count_le(const float* keys, int len,
                                             int log2_tile, float q) {
  int lo = 0;
  int width = 1 << log2_tile;
  for (int s = 0; s < log2_tile; ++s) {
    width >>= 1;
    const int mid = lo + width;
    if (mid - 1 < len && keys[mid - 1] <= q) lo = mid;
  }
  if (lo < len && keys[lo] <= q) lo += 1;
  return lo;
}

__global__ void probe_tiles_kernel(const float* __restrict__ key_tiles,
                                   const float* __restrict__ queries,
                                   const int32_t* __restrict__ valid,
                                   int32_t* __restrict__ out, int tile,
                                   int log2_tile, int qcap) {
  extern __shared__ float s_keys[];
  const float* keys = key_tiles + static_cast<size_t>(blockIdx.x) * tile;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) s_keys[i] = keys[i];
  __syncthreads();
  const size_t row = static_cast<size_t>(blockIdx.x) * qcap;
  for (int j = blockIdx.y * blockDim.x + threadIdx.x; j < qcap;
       j += gridDim.y * blockDim.x) {
    const int r = tile_count_le(s_keys, tile, log2_tile, queries[row + j]);
    out[row + j] = valid[row + j] > 0 ? r : -1;
  }
}

__global__ void predecessor_ranks_kernel(const float* __restrict__ keys,
                                         const float* __restrict__ queries,
                                         int32_t* __restrict__ ranks, int n,
                                         int n_tiles, int tile, int log2_tile,
                                         int m) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const float q = queries[i];
  // route: lo = #(tile boundary keys <= q); the query's tile is the last
  // one whose first key is <= q (tile 0 when q is below every key)
  int lo = 0;
  int hi = n_tiles;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[static_cast<size_t>(mid) * tile] <= q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int t = lo > 0 ? lo - 1 : 0;
  const int start = t * tile;
  const int len = n - start < tile ? n - start : tile;
  ranks[i] = start + tile_count_le(keys + start, len, log2_tile, q);
}

}  // namespace

extern "C" int probe_tiles(const void* key_tiles, const void* queries,
                           const void* valid, void* out, int n_tiles, int tile,
                           int log2_tile, int qcap, void* stream) {
  const int blocks_y = (qcap + kThreads - 1) / kThreads;
  const dim3 grid(n_tiles, blocks_y < 65535 ? blocks_y : 65535);
  probe_tiles_kernel<<<grid, kThreads, tile * sizeof(float),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(key_tiles), static_cast<const float*>(queries),
      static_cast<const int32_t*>(valid), static_cast<int32_t*>(out), tile,
      log2_tile, qcap);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int predecessor_ranks(const void* keys, const void* queries,
                                 void* ranks, int n, int tile, int log2_tile,
                                 int m, void* stream) {
  const int n_tiles = n / tile + (n % tile != 0);
  const int blocks = (m + kThreads - 1) / kThreads;
  predecessor_ranks_kernel<<<blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(keys), static_cast<const float*>(queries),
      static_cast<int32_t*>(ranks), n, n_tiles, tile, log2_tile, m);
  return static_cast<int>(cudaGetLastError());
}
