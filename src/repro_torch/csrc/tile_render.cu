// K1 and K4: forward tile rasterizer with the R&B alpha stash, for Hopper
// (sm_90a).
//
// K1 replaces repro/kernels/tile_render.py::tile_render_fwd (the Pallas
// _fwd_kernel and its helpers _chunk_alphas, _blend_chunk, _fwd_tile_loop).
// K4 replaces repro/kernels/tile_render.py::tile_render_fwd_sched (the
// Pallas _sched_fwd_kernel): K1 under a WSU schedule, one cluster per
// balanced pair of slots running slot 2p (the heavy tile) and then slot
// 2p+1, each bounded by its own trip count, outputs in slot order.  Both
// call one per-tile device function, render_tile, so K4 equals K1 bit for
// bit by construction.  They compute the same function as the TPU kernels,
// not the same blocks:
//
//   * a thread a pixel: a 16x16 tile runs on one block of 256 threads
//     where the grid has at least two tiles (K1) or pairs (K4) per SM, and
//     on fewer (RTGS's 70-tile tracking grid, or 280 tiles' 140 pairs) its
//     pixels are split over a thread-block cluster of two 128-thread
//     blocks (the wrapper picks the size).  Rows of a stacked multi-view
//     call are tiles of their view (tile = row % tiles);
//   * a block stages its tile's fragments below the trip count as two
//     float4 and a float2 each (three shared loads a fragment in place of
//     eleven): the first 64 before the first chunk and the rest when a
//     chunk first needs them, so a tile that saturates early reads no more
//     of its row.  A block holds at most WINDOW fragments; a wider row is
//     staged a window at a time, each window starting at the chunk that
//     would overflow the last;
//   * the chunk vote: a chunk below its row's trips runs iff some pixel of
//     the tile is alive at its start.  Transmittance never rises, so the
//     chunks that run are a prefix of the tile's, and its length is the
//     largest of the prefixes its blocks' own pixels keep alive.  Each
//     block votes over its own pixels, stops when they are done, and the
//     cluster's blocks exchange their prefixes once, at the end, through
//     distributed shared memory;
//   * the stash holds the raw alpha of every pixel of every processed chunk
//     and zeros elsewhere, each element written exactly once (no memset):
//     rows as the block runs them, rows that only another block's pixels
//     kept alive after the exchange, and the zero rows last as 16-byte
//     stores;
//   * the alpha and the blend keep the operation order of _chunk_alphas
//     and _blend_chunk, and the build uses -fmad=false so no multiply-add
//     is contracted.
//
// A slot whose perm entry is outside [0, rows) or whose trips are outside
// [0, K / chunk] is never read out of bounds: it runs as a pad slot (or with
// its trips clamped) and sets a bit of the fault word the wrapper reads.
//
// What bounds them on the H100.  A processed (pixel, fragment) pair costs
// ~43 issued instructions (three shared loads, the quadratic form, expf,
// the clamps, the store and the blend step, without contraction) and 4
// bytes of stash; every (pixel, fragment) slot costs its 4 bytes.  With
// 1200 or more tiles at K = 256 (a 640x480 view or a stacked window) both
// bind: one view writes a 315 MB stash (1200 * 256 * 256 * 4 B), ~94 us at
// 3.35 TB/s, and issues ~2.5G thread instructions, ~80 us at one warp
// instruction per cycle on each of the 528 schedulers.  On RTGS's 280-tile
// grid the stash (73 MB, ~22 us) still dominates: a launch that only
// writes zeros takes ~30 us of the ~40.  On the 70-tile grid one block a
// tile leaves 62 SMs idle, and a warp's serial chain (256 fragments of its
// 32 pixels, ~11K instructions) sets the time: there a cluster spreads a
// tile over two SMs, a warp to a scheduler.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr int NUM_ATTRS = 12;
constexpr int MAX_CHUNK = 64;
constexpr int WINDOW = 1024;  // the most fragments a block holds staged
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float TERM_EPS = 1e-4f;
// A block stages the first FIRST_STAGE fragments of its row (whole chunks)
// before its first chunk, and the rest below the trip count when a chunk
// first needs them.
constexpr int FIRST_STAGE = 64;

constexpr int FAULT_PERM = 1;   // a perm entry outside [0, rows)
constexpr int FAULT_TRIPS = 2;  // a trip count outside [0, K / chunk]

// Fragments a block holds staged for a row of `capacity` in chunks of
// `chunk`: the whole row, or the whole chunks that fit in WINDOW.
__host__ __device__ inline int window_frags(int capacity, int chunk) {
  return capacity <= WINDOW ? capacity : WINDOW / chunk * chunk;
}

// Staged fragments a block has room for, a multiple of 4 (16-byte aligned
// arrays).
__host__ __device__ inline int staged_stride(int capacity, int chunk) {
  return (window_frags(capacity, chunk) + 3) & ~3;
}

// A block's dynamic shared memory: the staged fragments, two float4 and a
// float2 each (at most 40 KB).
__host__ __device__ inline size_t smem_bytes(int capacity, int chunk) {
  return static_cast<size_t>(staged_stride(capacity, chunk)) *
         (2 * sizeof(float4) + sizeof(float2));
}

// A fragment as the kernels read it: v0 = (mean x, mean y, conic a,
// 2 * conic b), v1 = (conic c, opacity or 0 where absent, r, g),
// v2 = (b, depth).  Doubling b and zeroing an absent fragment's opacity
// here changes no rounding: 2 * b is the product the reference's q forms
// first, and a zero opacity gives alpha 0, which fails ALPHA_MIN as the
// reference's presence test does.
struct Staged {
  float4* v0;
  float4* v1;
  float2* v2;
};

__device__ __forceinline__ Staged staged(float* smem, int capacity, int chunk) {
  const int ks = staged_stride(capacity, chunk);
  float4* v0 = reinterpret_cast<float4*>(smem);
  return {v0, v0 + ks, reinterpret_cast<float2*>(v0 + 2 * ks)};
}

// Fragments [k0, k0 + n) of the (12, capacity) attrs row `a` into the
// window that starts at fragment `base`, one coalesced read of each
// attribute, then a block barrier.
__device__ void stage_frags(const float* __restrict__ a, Staged s, int capacity,
                            int base, int k0, int n) {
#pragma unroll 2
  for (int k = k0 + threadIdx.x; k < k0 + n; k += blockDim.x) {
    const float* c = a + k;
    const float present = c[10 * capacity];
    s.v0[k - base] = make_float4(c[0], c[capacity], c[2 * capacity], 2.0f * c[3 * capacity]);
    s.v1[k - base] = make_float4(c[4 * capacity], present > 0.5f ? c[8 * capacity] : 0.0f,
                                 c[5 * capacity], c[6 * capacity]);
    s.v2[k - base] = make_float2(c[7 * capacity], c[9 * capacity]);
  }
  __syncthreads();
}

// The raw alpha of a staged fragment at pixel centre (px, py), in the
// operation order of the reference's _chunk_alphas.
__device__ __forceinline__ float alpha_of(float4 v0, float4 v1, float px, float py) {
  const float dx = px - v0.x;
  const float dy = py - v0.y;
  const float q = v0.z * dx * dx + v0.w * dx * dy + v1.x * dy * dy;
  const float gauss = expf(-0.5f * fmaxf(q, 0.0f));
  const float alpha = fminf(v1.y * gauss, ALPHA_MAX);
  return alpha >= ALPHA_MIN ? alpha : 0.0f;
}

// One blend step of _blend_chunk.  `am` is alpha times the 0/1 include
// factor as a select: alpha is 0 or in [ALPHA_MIN, ALPHA_MAX], so the
// product is alpha or +0 exactly.
struct Blend {
  float r = 0.f, g = 0.f, b = 0.f, d = 0.f, trans = 1.f;
  __device__ __forceinline__ void add(float alpha, float4 v1, float2 v2) {
    const float am = trans > TERM_EPS ? alpha : 0.0f;
    const float w = trans * am;
    r += w * v1.z;
    g += w * v1.w;
    b += w * v2.x;
    d += w * v2.y;
    trans = trans * (1.0f - am);
  }
};

// The cluster's opening barrier: each block marks its exchange slots empty
// (-1) and arrives (a release, cheap before any store); a block waits on it
// before its first write into another block's shared memory.
__device__ __forceinline__ void cluster_open(int* s_done, int n) {
  if (threadIdx.x < n) s_done[threadIdx.x] = -1;
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// One tile's pixels [rank * P, (rank + 1) * P), a thread each, P = 256 /
// CLUSTER: `a` is its (12, capacity) attrs row, the outputs are its rows of
// color (3, 256), depth (256), final_T (256) and stash (capacity, 256).
// Every thread of the block calls it with the same arguments.  `s_done` is
// this slot's exchange array of the cluster (CLUSTER entries); `first`
// says whether it is the block's first exchange (which waits for the
// kernel's opening cluster barrier).
template <int CLUSTER>
__device__ void render_tile(const float* __restrict__ a, float* __restrict__ col,
                            float* __restrict__ dep, float* __restrict__ ft,
                            float* __restrict__ st, int capacity, int chunk,
                            int tile_id, int grid_w, int trips, int rank,
                            float* smem, int* s_done, bool first) {
  constexpr int P = PIX / CLUSTER;  // pixels of this block
  const int t = threadIdx.x;
  const int pix0 = rank * P, pix = pix0 + t;
  const float px = static_cast<float>((tile_id % grid_w) * TILE + pix % TILE) + 0.5f;
  const float py = static_cast<float>((tile_id / grid_w) * TILE + pix / TILE) + 0.5f;
  const Staged s = staged(smem, capacity, chunk);
  const int win = window_frags(capacity, chunk);

  // The staged fragments are [base, end), whole chunks.  A chunk at `end`
  // is staged with those after it up to `limit`, into the window as it is
  // or, where the chunk would overflow it, into a window starting there.
  // Block-uniform; a block barrier separates it from the window's reads.
  int base = 0;
  int end = min(min(trips, (FIRST_STAGE + chunk - 1) / chunk) * chunk, win);
  stage_frags(a, s, capacity, 0, 0, end);
  auto stage_from = [&](int k0, int limit) {
    if (k0 + chunk > base + win) base = k0;
    end = min(limit, base + win);
    stage_frags(a, s, capacity, base, k0, end - k0);
  };

  Blend acc;
  int done = 0;  // leading chunks some pixel of the block ran
  for (; done < trips; ++done) {
    if (!__syncthreads_or(acc.trans > TERM_EPS)) break;  // the chunk vote
    const int k0 = done * chunk;
    if (k0 == end) stage_from(k0, trips * chunk);
#pragma unroll 8
    for (int k = k0; k < k0 + chunk; ++k) {
      const float4 v1 = s.v1[k - base];
      const float alpha = alpha_of(s.v0[k - base], v1, px, py);
      st[static_cast<size_t>(k) * PIX + pix] = alpha;
      acc.add(alpha, v1, s.v2[k - base]);
    }
  }

  // The tile's processed chunks: the largest of its blocks' prefixes.  Each
  // block writes its prefix into slot `rank` of every block and waits until
  // its own slots are full: no cluster barrier, whose release would wait
  // for the block's stash stores to drain.
  int total = done;
  if constexpr (CLUSTER > 1) {
    if (first) cluster_wait();  // every block's slots are marked empty
    if (t < CLUSTER) {
      volatile int* slot = cg::this_cluster().map_shared_rank(s_done, t) + rank;
      *slot = done;
    }
    for (int r = 0; r < CLUSTER; ++r) {
      int v;
      while ((v = *static_cast<volatile int*>(&s_done[r])) < 0) {
      }
      total = max(total, v);
    }
  }
  // Rows that only other blocks' pixels kept running (block-uniform).
  for (int k0 = done * chunk; k0 < total * chunk; k0 += chunk) {
    if (k0 == end) {
      __syncthreads();  // the window's reads are done
      stage_from(k0, total * chunk);
    }
    for (int k = k0; k < k0 + chunk; ++k) {
      st[static_cast<size_t>(k) * PIX + pix] = alpha_of(s.v0[k - base], s.v1[k - base], px, py);
    }
  }
  // Zero rows of the chunks no pixel ran, as 16-byte stores.
  constexpr int Q = P / 4;
  const int z0 = total * chunk;
  const int nz = (capacity - z0) * Q;
  float4* st4 = reinterpret_cast<float4*>(st);
  for (int j = t; j < nz; j += P) {
    st4[(static_cast<size_t>(z0 + j / Q) * PIX + pix0) / 4 + j % Q] =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }

  col[pix] = acc.r;
  col[PIX + pix] = acc.g;
  col[2 * PIX + pix] = acc.b;
  dep[pix] = acc.d;
  ft[pix] = acc.trans;
}

__device__ __forceinline__ int block_rank() {
  return static_cast<int>(cg::this_cluster().block_rank());
}

// The launch bounds ask ptxas for one resident block per SM: it then keeps
// more fragments in flight, which runs faster than capping the registers
// for more resident blocks (tools/fwd_variants.py).
template <int CLUSTER>
__global__ void __launch_bounds__(PIX / CLUSTER, 1)
tile_render_fwd_kernel(const float* __restrict__ attrs,
                       const int* __restrict__ count,
                       float* __restrict__ color, float* __restrict__ depth,
                       float* __restrict__ finalt, float* __restrict__ stash,
                       int capacity, int chunk, int tiles, int grid_w) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_done[CLUSTER];
  if constexpr (CLUSTER > 1) cluster_open(s_done, CLUSTER);
  const int row = blockIdx.x / CLUSTER;
  const int n_chunks = capacity / chunk;
  const int trips = min(max((count[row] + chunk - 1) / chunk, 0), n_chunks);
  render_tile<CLUSTER>(
      attrs + static_cast<size_t>(row) * NUM_ATTRS * capacity,
      color + static_cast<size_t>(row) * 3 * PIX,
      depth + static_cast<size_t>(row) * PIX,
      finalt + static_cast<size_t>(row) * PIX,
      stash + static_cast<size_t>(row) * capacity * PIX, capacity, chunk,
      row % tiles, grid_w, trips, CLUSTER > 1 ? block_rank() : 0, smem, s_done, true);
}

template <int CLUSTER>
__global__ void __launch_bounds__(PIX / CLUSTER, 1)
tile_render_fwd_sched_kernel(const float* __restrict__ attrs,
                             const int* __restrict__ perm,
                             const int* __restrict__ trips,
                             float* __restrict__ color,
                             float* __restrict__ depth,
                             float* __restrict__ finalt,
                             float* __restrict__ stash, int* fault, int rows,
                             int capacity, int chunk, int tiles, int grid_w) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_done[2][CLUSTER];
  if constexpr (CLUSTER > 1) cluster_open(&s_done[0][0], 2 * CLUSTER);
  const int pair = blockIdx.x / CLUSTER;
  const int n_chunks = capacity / chunk;
#pragma unroll 1
  for (int j = 0; j < 2; ++j) {
    const int slot = 2 * pair + j;
    int row = perm[slot];
    int tr = trips[slot];
    if (row < 0 || row >= rows) {  // block-uniform guard: run as a pad slot
      if (threadIdx.x == 0) atomicOr(fault, FAULT_PERM);
      row = 0;
      tr = 0;
    }
    if (tr < 0 || tr > n_chunks) {
      if (threadIdx.x == 0) atomicOr(fault, FAULT_TRIPS);
      tr = tr < 0 ? 0 : n_chunks;
    }
    if (j == 1) __syncthreads();  // slot 2p is done with shared memory
    render_tile<CLUSTER>(
        attrs + static_cast<size_t>(row) * NUM_ATTRS * capacity,
        color + static_cast<size_t>(slot) * 3 * PIX,
        depth + static_cast<size_t>(slot) * PIX,
        finalt + static_cast<size_t>(slot) * PIX,
        stash + static_cast<size_t>(slot) * capacity * PIX, capacity, chunk,
        row % tiles, grid_w, tr, CLUSTER > 1 ? block_rank() : 0, smem, s_done[j], j == 0);
  }
}

bool bad_shape(int capacity, int chunk) {
  return chunk < 1 || chunk > MAX_CHUNK || capacity % chunk != 0;
}

// Launch `kernel` on `blocks` clusters of CLUSTER blocks of 256 / CLUSTER
// threads.
template <int CLUSTER, typename... Params, typename... Args>
int launch(void (*kernel)(Params...), int blocks, int capacity, int chunk,
           cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks * CLUSTER);
  cfg.blockDim = dim3(PIX / CLUSTER);
  cfg.dynamicSmemBytes = smem_bytes(capacity, chunk);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = CLUSTER > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <int CLUSTER>
int launch_fwd(const float* attrs, const int* count, float* color, float* depth,
               float* finalt, float* stash, int rows, int capacity, int chunk,
               int tiles, int grid_w, cudaStream_t stream) {
  return launch<CLUSTER>(tile_render_fwd_kernel<CLUSTER>, rows, capacity, chunk, stream,
                         attrs, count, color, depth, finalt, stash, capacity, chunk,
                         tiles, grid_w);
}

template <int CLUSTER>
int launch_sched(const float* attrs, const int* perm, const int* trips, float* color,
                 float* depth, float* finalt, float* stash, int* fault, int rows,
                 int slots, int capacity, int chunk, int tiles, int grid_w,
                 cudaStream_t stream) {
  return launch<CLUSTER>(tile_render_fwd_sched_kernel<CLUSTER>, slots / 2, capacity, chunk,
                         stream, attrs, perm, trips, color, depth, finalt, stash, fault,
                         rows, capacity, chunk, tiles, grid_w);
}

}  // namespace

// Dynamic shared memory of one block of K1 or K4 (0 for a shape the
// kernels do not take).
extern "C" int tile_render_fwd_smem(int capacity, int chunk) {
  return bad_shape(capacity, chunk) ? 0 : static_cast<int>(smem_bytes(capacity, chunk));
}

// K1.  attrs (rows, 12, K) f32, count (rows,) i32; outputs color
// (rows, 3, 256), depth (rows, 256), final_T (rows, 256), stash
// (rows, K, 256), all f32; `cluster` blocks per tile (1 or 2).  Returns the
// launch's cudaError_t (0 = success).
extern "C" int tile_render_fwd(const float* attrs, const int* count,
                               float* color, float* depth, float* finalt,
                               float* stash, int rows, int capacity, int chunk,
                               int tiles, int grid_w, cudaStream_t stream,
                               int cluster) {
  if (bad_shape(capacity, chunk)) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  switch (cluster) {
    case 1: return launch_fwd<1>(attrs, count, color, depth, finalt, stash, rows,
                                 capacity, chunk, tiles, grid_w, stream);
    case 2: return launch_fwd<2>(attrs, count, color, depth, finalt, stash, rows,
                                 capacity, chunk, tiles, grid_w, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K4.  attrs (rows, 12, K) f32, perm and trips (slots,) i32 with slots even;
// outputs in slot order: color (slots, 3, 256), depth (slots, 256), final_T
// (slots, 256), stash (slots, K, 256), all f32.  `fault` is one i32 that
// collects FAULT_* bits; `cluster` blocks per pair of slots (1 or 2).
// Returns the launch's cudaError_t.
extern "C" int tile_render_fwd_sched(const float* attrs, const int* perm,
                                     const int* trips, float* color,
                                     float* depth, float* finalt, float* stash,
                                     int* fault, int rows, int slots,
                                     int capacity, int chunk, int tiles,
                                     int grid_w, cudaStream_t stream, int cluster) {
  if (bad_shape(capacity, chunk) || slots % 2 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (slots == 0) return 0;
  switch (cluster) {
    case 1: return launch_sched<1>(attrs, perm, trips, color, depth, finalt, stash, fault,
                                   rows, slots, capacity, chunk, tiles, grid_w, stream);
    case 2: return launch_sched<2>(attrs, perm, trips, color, depth, finalt, stash, fault,
                                   rows, slots, capacity, chunk, tiles, grid_w, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
