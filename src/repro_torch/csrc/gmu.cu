// K3: GMU level 2's adder for Hopper (sm_90a): one row-scan kernel, two
// epilogues.
//
// Replaces repro/kernels/gmu.py::block_cumsum (the Pallas
// _block_cumsum_kernel), an inclusive prefix sum over the rows of an (M, G)
// float32 tensor, and the run reduction around it in segment_merge: on the
// TPU the grid runs in order and carries each 256-row block's last row to
// the next in scratch memory, and GMU level 2 then scatters +pref at each
// run end and -pref_excl at each run start of the rows sorted by Gaussian
// id.  One pair of launches here does either:
//
//   scan   the prefix sum (block_cumsum): writes the (M, G) prefix;
//   merge  GMU level 2 (merge_runs): gathers the sorted rows through the
//          sort's order (and, for the WSU schedule's slot-order gradients,
//          a map from tile to slot row) from the gradients' own
//          (tiles, G, K) layout, and
//          adds +pref at each valid run end and -(pref - v) at each valid
//          run start into a zeroed (B, N, G) output.  It writes no (M, G)
//          prefix, has no dump row and skips padding rows.  An output row
//          gets at most one end add and one start add; 0 + a is exact and
//          float addition commutes, so the order the atomics land in cannot
//          change a bit.  B views are merged in one launch pair, each with
//          its own prefix, as if merged one at a time.
//
// The order of the additions is the first port's, so the plain versions
// and earlier results stay bit for bit: thread r of a 256-thread block owns
// row r; per column a log-step warp scan, then the earlier warps' totals
// added in turn; then the block's carry, the exclusive scan of the block
// totals taken 32 blocks at a time (a log-step warp scan in each group of
// 32) plus the sum of the earlier groups' totals, added in turn.  Hopper
// blocks run in no order, so in pass 1 the last block to arrive in a group
// scans the group's totals, and the last group to arrive in a view sums the
// group totals; what they compute does not depend on which blocks they are.
//
//   pass 1 (k3_totals): every block scans its rows (all G columns at once:
//          G independent shuffle chains and one barrier) and writes its
//          totals; then the group and view steps above.  A merge gathers
//          its rows here, once, and keeps them in sorted order in scratch;
//          a block of padding only skips its scan (its totals are zeros);
//   pass 2 (k3_rows): every block scans its rows again, adds its carry and
//          runs its epilogue.
//
// What bounds it on the H100: bytes.  A scan at (307200, 10) reads 12.3 MB
// and writes 12.3 MB; pass 2 reads the rows again, mostly from the 50 MB
// L2.  Rows in order are staged in shared memory with 16-byte loads and
// stores.  A merge reads the valid rows (one 4-byte gather per value, the
// costly part), their keys and order, fills (B, N, G) with zeros and adds
// 2 G floats per unique Gaussian; its pass 2 reads the sorted rows that
// pass 1 kept, in order.  Blocks that hold only padding (the sort puts it
// last) skip their loads and stores.
//
// Pass 1's arrival counters live in a buffer the caller zeroes once; the
// blocks that read a counter's last arrival set it back to 0, so launches
// that share the buffer must not overlap (one stream).

#include <cassert>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;
constexpr int WARPS = BLOCK / 32;
constexpr int GROUP = 32;  // blocks per carry group
constexpr int MAX_G = 32;
constexpr unsigned FULL = 0xffffffffu;

struct Rows {
  const float* vals;       // scan: (views * rows, G); merge: (tiles, G, K)
  float* sorted;           // merge: the rows in sorted order, (views * blocks * 256, G)
  const long long* order;  // merge: sorted position -> row q = t K + k
  const long long* tile_rows;  // merge: tile t's row of vals, or nullptr for t
  const int* keys;         // merge: sorted keys; view v's lie in [v (N + 1), v (N + 1) + N]
  int views;
  int rows;                // rows per view
  int frags;               // merge: K (row q, column c at tile_rows[q / K] G K + c K + q % K)
  int tiles;               // merge: tiles of vals
  int num_g;
  int segments;            // merge: N; key v (N + 1) + N marks padding
  int blocks;              // blocks per view
  int groups;              // carry groups per view
};

__device__ __forceinline__ float warp_inclusive_scan(float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(FULL, v, off);
    if (lane >= off) v += up;
  }
  return v;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The block's 256 rows in order from `src` into shared memory (16-byte
// loads where the rows are aligned), then row threadIdx.x into x.
template <int W>
__device__ __forceinline__ void load_rows(const float* __restrict__ src, int num_g,
                                          float* s_rows, float (&x)[W]) {
  const int n = BLOCK * num_g;
  if (aligned16(src)) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(s_rows);
    for (int j = threadIdx.x; j < n / 4; j += BLOCK) d4[j] = __ldg(s4 + j);
  } else {
    for (int j = threadIdx.x; j < n; j += BLOCK) s_rows[j] = __ldg(src + j);
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < W; ++c) {
    x[c] = c < num_g ? s_rows[threadIdx.x * num_g + c] : 0.f;
  }
}

// Row threadIdx.x's values x into shared memory, then the block's 256 rows
// out to `dst` (16-byte stores where aligned).  Only this thread read its
// row of s_rows, before the caller's last barrier.
template <int W>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, int num_g,
                                           float* s_rows, const float (&x)[W]) {
#pragma unroll
  for (int c = 0; c < W; ++c) {
    if (c < num_g) s_rows[threadIdx.x * num_g + c] = x[c];
  }
  __syncthreads();
  const int n = BLOCK * num_g;
  if (aligned16(dst)) {
    const float4* s4 = reinterpret_cast<const float4*>(s_rows);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int j = threadIdx.x; j < n / 4; j += BLOCK) d4[j] = s4[j];
  } else {
    for (int j = threadIdx.x; j < n; j += BLOCK) dst[j] = s_rows[j];
  }
}

// Merge: the segment of sorted row threadIdx.x of block `blk` of `view`,
// or -1 for padding; `key` is its sort key.
__device__ __forceinline__ int row_segment(const Rows& a, int view, int blk, int& key) {
  const int r = blk * BLOCK + threadIdx.x;
  key = 0;
  if (r >= a.rows) return -1;
  key = __ldg(a.keys + static_cast<size_t>(view) * a.rows + r);
  const long long local = key - static_cast<long long>(view) * (a.segments + 1);
  return local >= 0 && local < a.segments ? static_cast<int>(local) : -1;
}

// Merge: the values of sorted row threadIdx.x of block `blk` of `view`
// with segment `seg`, gathered through the order (zeros for padding).
template <int W>
__device__ __forceinline__ void gather_row(const Rows& a, int view, int blk, int seg,
                                           float (&x)[W]) {
#pragma unroll
  for (int c = 0; c < W; ++c) x[c] = 0.f;
  if (seg < 0) return;
  const size_t pos = static_cast<size_t>(view) * a.rows + blk * BLOCK + threadIdx.x;
  const long long q = __ldg(a.order + pos);
  const long long t = a.tile_rows ? __ldg(a.tile_rows + q / a.frags) : q / a.frags;
  assert(t >= 0 && t < a.tiles);
  const float* src = a.vals + t * a.num_g * a.frags + q % a.frags;
#pragma unroll
  for (int c = 0; c < W; ++c) {
    if (c < a.num_g) x[c] = __ldg(src + static_cast<size_t>(c) * a.frags);
  }
}

// x holds row threadIdx.x of the block; on return its prefix within the
// block, in the order of the note above.
template <int W>
__device__ __forceinline__ void block_scan(float (&x)[W], int num_g,
                                           float (*s_warp)[W]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
    for (int c = 0; c < W; ++c) {
      if (c < num_g) {
        const float up = __shfl_up_sync(FULL, x[c], off);
        if (lane >= off) x[c] += up;
      }
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int c = 0; c < W; ++c) s_warp[warp][c] = x[c];
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < W; ++c) {
    float before = 0.f;
    for (int w = 0; w < warp; ++w) before += s_warp[w][c];
    x[c] = before + x[c];
  }
}

// Pass 1.  totals (views * blocks, G): each block's totals, which the
// group's last block turns into in-group exclusive parts (incl - total);
// group_sums (views * groups, G): each group's total, which the view's last
// group turns into the sum of the earlier groups' totals (its run).  Both
// tails stage their operands in shared memory with one round of loads.
template <bool MERGE, int W>
__global__ void __launch_bounds__(BLOCK)
k3_totals(Rows a, float* __restrict__ totals, float* __restrict__ group_sums,
          unsigned* __restrict__ arrivals) {
  __shared__ __align__(16) float s_rows[BLOCK * W];
  __shared__ float s_warp[WARPS][W];
  __shared__ bool s_last;
  const int view = blockIdx.x / a.blocks, blk = blockIdx.x % a.blocks;
  const int g = a.num_g;
  const size_t first = static_cast<size_t>(blockIdx.x) * BLOCK * g;
  float x[W];
  if constexpr (MERGE) {
    int key;
    const int seg = row_segment(a, view, blk, key);
    if (__syncthreads_or(seg >= 0)) {
      gather_row<W>(a, view, blk, seg, x);
      store_rows<W>(a.sorted + first, g, s_rows, x);
      block_scan<W>(x, g, s_warp);
    } else {
#pragma unroll
      for (int c = 0; c < W; ++c) x[c] = 0.f;
    }
  } else {
    load_rows<W>(a.vals + first, g, s_rows, x);
    block_scan<W>(x, g, s_warp);
  }

  const int group = blk / GROUP;
  const int in_group = min(GROUP, a.blocks - group * GROUP);
  unsigned* group_arrivals = arrivals + static_cast<size_t>(view) * a.groups + group;
  unsigned* view_arrivals = arrivals + static_cast<size_t>(a.views) * a.groups + view;
  if (threadIdx.x == BLOCK - 1) {
    float* t = totals + static_cast<size_t>(blockIdx.x) * g;
#pragma unroll
    for (int c = 0; c < W; ++c) {
      if (c < g) t[c] = x[c];
    }
    __threadfence();
    s_last = atomicAdd(group_arrivals, 1u) == static_cast<unsigned>(in_group - 1);
  }
  __syncthreads();
  if (!s_last) return;

  // The group's last block: its exclusive scan, in place.  s_rows holds
  // the group's 32 x G totals (zeros past the view's last block).
  __threadfence();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float* gt = totals + (static_cast<size_t>(view) * a.blocks + group * GROUP) * g;
  float* gs = group_sums + static_cast<size_t>(view) * a.groups * g;
  for (int j = threadIdx.x; j < GROUP * g; j += BLOCK) {
    s_rows[j] = j < in_group * g ? __ldcg(gt + j) : 0.f;
  }
  __syncthreads();
  for (int c = warp; c < g; c += WARPS) {
    const float t = s_rows[lane * g + c];
    const float incl = warp_inclusive_scan(t, lane);
    if (lane < in_group) gt[lane * g + c] = incl - t;
    if (lane == 31) gs[group * g + c] = incl;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    *group_arrivals = 0u;
    s_last = atomicAdd(view_arrivals, 1u) == static_cast<unsigned>(a.groups - 1);
  }
  __syncthreads();
  if (!s_last) return;

  // The view's last group: each group's run, the earlier groups' totals
  // in turn, through s_rows a chunk of groups at a time.
  __threadfence();
  const int chunk = BLOCK * W / g;  // groups per chunk
  float run = 0.f;
  for (int i0 = 0; i0 < a.groups; i0 += chunk) {
    const int n = min(chunk, a.groups - i0) * g;
    for (int j = threadIdx.x; j < n; j += BLOCK) s_rows[j] = __ldcg(gs + i0 * g + j);
    __syncthreads();
    if (threadIdx.x < g) {
      for (int j = threadIdx.x; j < n; j += g) {
        const float t = s_rows[j];
        s_rows[j] = run;
        run += t;
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += BLOCK) gs[i0 * g + j] = s_rows[j];
    __syncthreads();
  }
  if (threadIdx.x == 0) *view_arrivals = 0u;
}

// Pass 2: prefix = local + (run + part), then the epilogue.
template <bool MERGE, int W>
__global__ void __launch_bounds__(BLOCK)
k3_rows(Rows a, const float* __restrict__ parts, const float* __restrict__ runs,
        float* __restrict__ out) {
  __shared__ __align__(16) float s_rows[BLOCK * W];
  __shared__ float s_warp[WARPS][W];
  const int view = blockIdx.x / a.blocks, blk = blockIdx.x % a.blocks;
  const int g = a.num_g;
  const size_t first = static_cast<size_t>(blockIdx.x) * BLOCK * g;
  float x[W], v[W];
  int seg = -1, key = 0;
  if constexpr (MERGE) {
    seg = row_segment(a, view, blk, key);
    if (!__syncthreads_or(seg >= 0)) return;  // padding only from here on
    load_rows<W>(a.sorted + first, g, s_rows, x);
  } else {
    load_rows<W>(a.vals + first, g, s_rows, x);
  }
#pragma unroll
  for (int c = 0; c < W; ++c) v[c] = x[c];
  block_scan<W>(x, g, s_warp);
  const float* part = parts + static_cast<size_t>(blockIdx.x) * g;
  const float* run = runs + (static_cast<size_t>(view) * a.groups + blk / GROUP) * g;
#pragma unroll
  for (int c = 0; c < W; ++c) {
    if (c < g) x[c] = x[c] + (__ldg(run + c) + __ldg(part + c));
  }

  if constexpr (MERGE) {
    if (seg < 0) return;
    const int r = blk * BLOCK + threadIdx.x;
    const size_t pos = static_cast<size_t>(view) * a.rows + r;
    const bool start = r == 0 || __ldg(a.keys + pos - 1) != key;
    const bool end = r == a.rows - 1 || __ldg(a.keys + pos + 1) != key;
    float* o = out + (static_cast<size_t>(view) * a.segments + seg) * g;
    if (end) {
#pragma unroll
      for (int c = 0; c < W; ++c) {
        if (c < g) atomicAdd(o + c, x[c]);
      }
    }
    if (start) {
#pragma unroll
      for (int c = 0; c < W; ++c) {
        if (c < g) atomicAdd(o + c, -(x[c] - v[c]));
      }
    }
  } else {
    store_rows<W>(out + first, g, s_rows, x);
  }
}

template <bool MERGE, int W>
int launch_width(Rows a, float* scratch, unsigned* arrivals, float* out,
                 cudaStream_t stream) {
  const int grid = a.views * a.blocks;
  float* totals = scratch;
  float* group_sums = totals + static_cast<size_t>(grid) * a.num_g;
  if (MERGE) {  // 16-byte aligned after the group sums
    const size_t used = (static_cast<size_t>(grid) + static_cast<size_t>(a.views) * a.groups) *
                        a.num_g;
    a.sorted = scratch + ((used + 3) & ~static_cast<size_t>(3));
  }
  k3_totals<MERGE, W><<<grid, BLOCK, 0, stream>>>(a, totals, group_sums, arrivals);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  k3_rows<MERGE, W><<<grid, BLOCK, 0, stream>>>(a, totals, group_sums, out);
  return static_cast<int>(cudaGetLastError());
}

template <bool MERGE>
int launch(Rows a, float* scratch, unsigned* arrivals, float* out,
           cudaStream_t stream) {
  a.blocks = (a.rows + BLOCK - 1) / BLOCK;
  a.groups = (a.blocks + GROUP - 1) / GROUP;
  if (a.blocks == 0 || a.views == 0) return 0;
  // Registers hold W columns a row: 10 for GMU level 2's gradient rows.
  return a.num_g <= 10 ? launch_width<MERGE, 10>(a, scratch, arrivals, out, stream)
                       : launch_width<MERGE, 32>(a, scratch, arrivals, out, stream);
}

}  // namespace

// Scratch for `views` views of `rows` rows: views * (blocks + groups) * G
// floats, for a merge 3 + views * blocks * 256 * G more, and views * (groups
// + 1) arrival counters (zeroed before the first launch; every launch leaves
// them zero), where blocks = ceil(rows / 256) and groups = ceil(blocks / 32).

// Scan: vals and out (rows, G) f32, rows % 256 == 0, 1 <= G <= 32.  Two
// launches on `stream`; returns the first cudaError_t (0 = success).
extern "C" int block_cumsum(const float* vals, float* out, float* scratch,
                            unsigned* arrivals, int rows, int num_g,
                            cudaStream_t stream) {
  if (rows < 0 || rows % BLOCK != 0 || num_g < 1 || num_g > MAX_G) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Rows a{vals, nullptr, nullptr, nullptr, nullptr, 1, rows, 1, 0, num_g, 0, 0, 0};
  return launch<false>(a, scratch, arrivals, out, stream);
}

// Merge: vals (tiles, G, K) f32; tile_rows (views * rows / K,) i64 rows of
// vals in [0, tiles), or nullptr with views * rows == tiles * K; order
// (views * rows,) i64 and keys (views * rows,) i32, the stable sort of
// view v's keys (its Gaussian ids, padding as N) offset by v (N + 1); out
// (views, N, G) f32, zeroed.  Two launches on `stream`; returns the first
// cudaError_t (0 = success).
extern "C" int merge_runs(const float* vals, const long long* tile_rows,
                          const long long* order, const int* keys, float* out,
                          float* scratch, unsigned* arrivals, int tiles,
                          int views, int rows, int frags, int num_g, int segments,
                          cudaStream_t stream) {
  if (tiles < 0 || views < 0 || rows < 0 || frags < 1 || num_g < 1 || num_g > MAX_G ||
      segments < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Rows a{vals, nullptr, order, tile_rows, keys, views, rows, frags, tiles,
               num_g, segments, 0, 0};
  return launch<true>(a, scratch, arrivals, out, stream);
}
