// A design variant of K1/K4 (src/repro_torch/csrc/tile_render.cu) kept for
// tools/fwd_variants.py, which builds it with its launches edited onto the
// split path below: blocks of 256 threads in a cluster of 2-8, or one block
// of 512 or 1024 threads a tile, some threads blending while the others
// evaluate the next group of chunks' alphas into shared memory, with its
// group-size and store variants.  It lost to a thread a pixel on every
// grid (PERF.md).  The program does not build it; it refuses
// K > 1024.
//
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
//     blocks (the wrapper picks the size; 4 and 8 are also built).  Rows
//     of a stacked multi-view call are tiles of their view
//     (tile = row % tiles);
//   * a block stages its tile's fragments below the trip count as two
//     float4 and a float2 each (three shared loads a fragment in place of
//     eleven): the first 64 before the first chunk and the rest when a
//     chunk first needs them, so a tile that saturates early reads no more
//     of its row;
//   * the chunk vote: a chunk below its row's trips runs iff some pixel of
//     the tile is alive at its start.  Transmittance never rises, so the
//     chunks that run are a prefix of the tile's, and its length is the
//     largest of the prefixes its blocks' own pixels keep alive.  Each
//     block votes over its own pixels (a warp vote where the block is one
//     warp), stops when they are done, and the cluster's blocks exchange
//     their prefixes once, at the end, through distributed shared memory;
//   * the stash holds the raw alpha of every pixel of every processed chunk
//     and zeros elsewhere, each element written exactly once (no memset):
//     rows as the block runs them, rows that only another block's pixels
//     kept alive after the exchange, and the zero rows last as 16-byte
//     stores;
//   * the alpha and the blend keep the operation order of _chunk_alphas
//     and _blend_chunk, and the build uses -fmad=false so no multiply-add
//     is contracted.
//
// render_tile also has a split path, which no launch here takes: blocks of
// 256 threads in a cluster, of which 256 / cluster blend while the others
// evaluate the next group of chunks' alphas into shared memory (more warps
// than the block has pixels) and store the rows the blend shows processed.
// tools/fwd_variants.py builds it by editing the launches, with its store
// and group-size variants: it lost to a thread a pixel on every grid.
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
constexpr int MAX_STAGED_K = 1024;  // the widest attrs row a block stages
constexpr int GROUP_PAIRS = 2048;   // (fragment, pixel) alphas per group of the split path
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float TERM_EPS = 1e-4f;
constexpr unsigned FULL = 0xffffffffu;
// A thread a pixel: a block stages the first FIRST_STAGE fragments of its
// row (whole chunks) before its first chunk, and the rest below the trip
// count when a chunk first needs it.  The split path stages the row up
// front: its evaluating threads run a group ahead.
constexpr int FIRST_STAGE = 64;

// How a block's threads share its pixels (render_tile's PATH).
constexpr int ONE = 0;    // a thread a pixel
constexpr int SPLIT = 1;  // blending threads and evaluating threads (the split path)

constexpr int FAULT_PERM = 1;   // a perm entry outside [0, rows)
constexpr int FAULT_TRIPS = 2;  // a trip count outside [0, K / chunk]

// Fragments per group of the split path: the multiple of chunk nearest
// below GROUP_PAIRS / p (at least one chunk).
__host__ __device__ inline int group_frags(int p, int chunk) {
  const int g = GROUP_PAIRS / p / chunk;
  return chunk * (g > 1 ? g : 1);
}

// Staged fragments per row, a multiple of 4 (16-byte aligned arrays).
__host__ __device__ inline int staged_stride(int capacity) {
  return (capacity + 3) & ~3;
}

// A block's dynamic shared memory: the staged fragments (two float4 and a
// float2 each) and, on the split path, two groups' alphas.
__host__ __device__ inline size_t smem_bytes(int capacity, int chunk, int p, bool split) {
  return static_cast<size_t>(staged_stride(capacity)) * (2 * sizeof(float4) + sizeof(float2)) +
         (split ? 2 * sizeof(float) * group_frags(p, chunk) * p : 0);
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

__device__ __forceinline__ Staged staged(float* smem, int capacity) {
  const int ks = staged_stride(capacity);
  float4* v0 = reinterpret_cast<float4*>(smem);
  return {v0, v0 + ks, reinterpret_cast<float2*>(v0 + 2 * ks)};
}

// Fragments [k0, k0 + n) of the (12, capacity) attrs row `a`, one
// coalesced read of each attribute, then a block barrier.
__device__ void stage_frags(const float* __restrict__ a, Staged s, int capacity,
                            int k0, int n) {
#pragma unroll 2
  for (int k = k0 + threadIdx.x; k < k0 + n; k += blockDim.x) {
    const float* c = a + k;
    const float present = c[10 * capacity];
    s.v0[k] = make_float4(c[0], c[capacity], c[2 * capacity], 2.0f * c[3 * capacity]);
    s.v1[k] = make_float4(c[4 * capacity], present > 0.5f ? c[8 * capacity] : 0.0f,
                          c[5 * capacity], c[6 * capacity]);
    s.v2[k] = make_float2(c[7 * capacity], c[9 * capacity]);
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

// mbarriers of the split path's two alpha buffers (full: the evaluating
// threads arrive; empty: the blending threads arrive).
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// Some pixel of the block is alive: a block vote, or a warp vote where
// the block is one warp.
template <int T>
__device__ __forceinline__ bool block_any(bool v) {
  if constexpr (T == 32) {
    return __any_sync(FULL, v);
  } else {
    return __syncthreads_or(v);
  }
}

// One tile's pixels [rank * P, (rank + 1) * P): `a` is its (12, capacity)
// attrs row, the outputs are its rows of color (3, 256), depth (256),
// final_T (256) and stash (capacity, 256).  Every thread of the block calls
// it with the same arguments.  On PATH ONE each thread owns a pixel and
// evaluates and blends its fragments in one pass.  On SPLIT the first P
// threads blend, and the other T - P evaluate groups of chunks' alphas into
// two shared buffers, one group ahead of the blend, and store the rows the
// blend shows processed (16-byte stores); `s_bar` holds the buffers' four
// mbarriers.  `s_done` is this slot's exchange array of the cluster
// (CLUSTER entries); `first` says whether it is the block's first exchange
// (which waits for the kernel's opening cluster barrier).
template <int CLUSTER, int T, int PATH>
__device__ void render_tile(const float* __restrict__ a, float* __restrict__ col,
                            float* __restrict__ dep, float* __restrict__ ft,
                            float* __restrict__ st, int capacity, int chunk,
                            int tile_id, int grid_w, int trips, int rank,
                            float* smem, int* s_live, int* s_done,
                            unsigned long long* s_bar, bool first) {
  constexpr int P = PIX / CLUSTER;  // pixels of this block
  constexpr int F = T / P;          // threads a pixel
  static_assert(P % 32 == 0 && T % P == 0, "whole warps of pixels");
  static_assert(PATH == ONE ? F == 1 : F > 1, "threads a pixel");
  const int t = threadIdx.x;
  // The thread's pixel, and which of the pixel's F threads it is (0 blends
  // and writes the outputs; on SPLIT the others evaluate).
  const int p = t % P, lane_f = t / P;
  const int pix0 = rank * P, pix = pix0 + p;
  const float px = static_cast<float>((tile_id % grid_w) * TILE + pix % TILE) + 0.5f;
  const float py = static_cast<float>((tile_id / grid_w) * TILE + pix / TILE) + 0.5f;
  const Staged s = staged(smem, capacity);

  if constexpr (PATH == SPLIT) {
    if (t == 0) {
      mbar_init(&s_bar[0], T - P);  // full: the evaluating threads arrive
      mbar_init(&s_bar[1], T - P);
      mbar_init(&s_bar[2], P);      // empty: the blending threads arrive
      mbar_init(&s_bar[3], P);
    }
  }
  int staged_end = PATH == SPLIT ? trips * chunk
                                 : min(trips, (FIRST_STAGE + chunk - 1) / chunk) * chunk;
  stage_frags(a, s, capacity, 0, staged_end);

  Blend px_acc;
  int done = 0;  // leading chunks some pixel of the block ran
  if constexpr (PATH == ONE) {
    for (; done < trips; ++done) {
      if (!block_any<T>(px_acc.trans > TERM_EPS)) break;  // the chunk vote
      const int k0 = done * chunk;
      if (k0 == staged_end) {  // block-uniform
        staged_end = trips * chunk;
        stage_frags(a, s, capacity, k0, staged_end - k0);
      }
#pragma unroll 8
      for (int k = k0; k < k0 + chunk; ++k) {
        const float4 v1 = s.v1[k];
        const float alpha = alpha_of(s.v0[k], v1, px, py);
        st[static_cast<size_t>(k) * PIX + pix] = alpha;
        px_acc.add(alpha, v1, s.v2[k]);
      }
    }
  } else {
    constexpr int E = T - P;     // evaluating threads
    constexpr int Q = P / 4;     // float4 of a stash row's pixels
    const int gf = group_frags(P, chunk), gc = gf / chunk;
    const int groups = (trips + gc - 1) / gc;
    float* buf = reinterpret_cast<float*>(s.v2 + staged_stride(capacity));
    unsigned long long* full = s_bar;
    unsigned long long* empty = s_bar + 2;
    // Chunk starts (and the group's end) at which some pixel of the block
    // is alive, in group g: the largest of the blending warps' counts.
    auto live_of = [&](int g) {
      int n = 0;
      for (int w = 0; w < P / 32; ++w) n = max(n, s_live[(g & 1) * (P / 32) + w]);
      return n;
    };
    if (t >= P) {  // evaluate group g, store the processed rows of group g - 2
      const int e = t - P;
      for (int g = 0; g < groups + 2; ++g) {
        if (g >= 2) {
          const int c0 = (g - 2) * gc, nc = min(gc, trips - c0);
          mbar_wait(&empty[g & 1], ((g - 2) >> 1) & 1);
          const int n = live_of(g);
          const float4* src = reinterpret_cast<const float4*>(buf + (g & 1) * gf * P);
          float4* dst = reinterpret_cast<float4*>(st + static_cast<size_t>(c0) * chunk * PIX + pix0);
          for (int j = e; j < min(n, nc) * chunk * Q; j += E) {
            dst[j / Q * (PIX / 4) + j % Q] = src[j];
          }
          done = c0 + min(n, nc);
          if (n <= nc) break;  // the block's pixels are all done
        }
        if (g < groups) {
          // The buffer's rows of group g - 2 are out before any thread
          // overwrites them.
          if (g >= 2) asm volatile("bar.sync 2, %0;\n" ::"n"(E) : "memory");
          const int k0 = g * gf, nf = min(gf, trips * chunk - k0);
          float* out = buf + (g & 1) * gf * P;
#pragma unroll 4
          for (int f = lane_f - 1; f < nf; f += F - 1) {
            out[f * P + p] = alpha_of(s.v0[k0 + f], s.v1[k0 + f], px, py);
          }
          mbar_arrive(&full[g & 1]);
        }
      }
    } else {  // blend group g in fragment order
      for (int g = 0; g < groups; ++g) {
        const int c0 = g * gc, nc = min(gc, trips - c0), k0 = c0 * chunk;
        mbar_wait(&full[g & 1], (g >> 1) & 1);
        const float* in = buf + (g & 1) * gf * P;
        int live = 0;
        for (int c = 0; c < nc; ++c) {
          const bool alive = px_acc.trans > TERM_EPS;
          live += alive;
          if (!__any_sync(FULL, alive)) break;  // warp-uniform
#pragma unroll 4
          for (int i = c * chunk; i < (c + 1) * chunk; ++i) {
            px_acc.add(in[i * P + p], s.v1[k0 + i], s.v2[k0 + i]);
          }
        }
        live += px_acc.trans > TERM_EPS;
        live = __reduce_max_sync(FULL, live);
        if (t % 32 == 0) s_live[(g & 1) * (P / 32) + t / 32] = live;
        if constexpr (P > 32) {
          asm volatile("bar.sync 1, %0;\n" ::"n"(P) : "memory");
        } else {
          __syncwarp();
        }
        const int n = live_of(g);
        mbar_arrive(&empty[g & 1]);
        done = c0 + min(n, nc);
        if (n <= nc) break;
      }
    }
    __syncthreads();
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
  // Rows that only other blocks' pixels kept running.
  if (done < total) {  // block-uniform
    if (total * chunk > staged_end) {
      __syncthreads();
      stage_frags(a, s, capacity, staged_end, total * chunk - staged_end);
    }
    for (int k = done * chunk + lane_f; k < total * chunk; k += F) {
      st[static_cast<size_t>(k) * PIX + pix] = alpha_of(s.v0[k], s.v1[k], px, py);
    }
  }
  // Zero rows of the chunks no pixel ran, as 16-byte stores.
  constexpr int Q = P / 4;
  const int z0 = total * chunk;
  const int nz = (capacity - z0) * Q;
  float4* st4 = reinterpret_cast<float4*>(st);
  for (int j = t; j < nz; j += T) {
    st4[(static_cast<size_t>(z0 + j / Q) * PIX + pix0) / 4 + j % Q] =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }

  if (lane_f == 0) {
    col[pix] = px_acc.r;
    col[PIX + pix] = px_acc.g;
    col[2 * PIX + pix] = px_acc.b;
    dep[pix] = px_acc.d;
    ft[pix] = px_acc.trans;
  }
}

__device__ __forceinline__ int block_rank() {
  return static_cast<int>(cg::this_cluster().block_rank());
}

// The launch bounds ask ptxas for one resident block per SM: it then keeps
// more fragments in flight (78 registers for K1, 88 for K4), which runs
// faster than capping the registers for more resident blocks
// (tools/fwd_variants.py).
template <int CLUSTER, int T, int PATH>
__global__ void __launch_bounds__(T, 1)
tile_render_fwd_kernel(const float* __restrict__ attrs,
                       const int* __restrict__ count,
                       float* __restrict__ color, float* __restrict__ depth,
                       float* __restrict__ finalt, float* __restrict__ stash,
                       int capacity, int chunk, int tiles, int grid_w) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_live[16];  // two groups, up to 8 blending warps
  __shared__ int s_done[CLUSTER];
  __shared__ unsigned long long s_bar[4];
  if constexpr (CLUSTER > 1) cluster_open(s_done, CLUSTER);
  const int row = blockIdx.x / CLUSTER;
  const int n_chunks = capacity / chunk;
  const int trips = min(max((count[row] + chunk - 1) / chunk, 0), n_chunks);
  render_tile<CLUSTER, T, PATH>(
      attrs + static_cast<size_t>(row) * NUM_ATTRS * capacity,
      color + static_cast<size_t>(row) * 3 * PIX,
      depth + static_cast<size_t>(row) * PIX,
      finalt + static_cast<size_t>(row) * PIX,
      stash + static_cast<size_t>(row) * capacity * PIX, capacity, chunk,
      row % tiles, grid_w, trips, CLUSTER > 1 ? block_rank() : 0, smem, s_live,
      s_done, s_bar, true);
}

template <int CLUSTER, int T, int PATH>
__global__ void __launch_bounds__(T, 1)
tile_render_fwd_sched_kernel(const float* __restrict__ attrs,
                             const int* __restrict__ perm,
                             const int* __restrict__ trips,
                             float* __restrict__ color,
                             float* __restrict__ depth,
                             float* __restrict__ finalt,
                             float* __restrict__ stash, int* fault, int rows,
                             int capacity, int chunk, int tiles, int grid_w) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_live[16];  // two groups, up to 8 blending warps
  __shared__ int s_done[2][CLUSTER];
  __shared__ unsigned long long s_bar[2][4];
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
    render_tile<CLUSTER, T, PATH>(
        attrs + static_cast<size_t>(row) * NUM_ATTRS * capacity,
        color + static_cast<size_t>(slot) * 3 * PIX,
        depth + static_cast<size_t>(slot) * PIX,
        finalt + static_cast<size_t>(slot) * PIX,
        stash + static_cast<size_t>(slot) * capacity * PIX, capacity, chunk,
        row % tiles, grid_w, tr, CLUSTER > 1 ? block_rank() : 0, smem, s_live,
        s_done[j], s_bar[j], j == 0);
  }
}

bool bad_shape(int capacity, int chunk) {
  return chunk < 1 || chunk > MAX_CHUNK || capacity % chunk != 0 ||
         capacity > MAX_STAGED_K;
}

// Launch `kernel` on `blocks` blocks of T threads in clusters of CLUSTER.
template <int CLUSTER, int T, typename... Params, typename... Args>
int launch(void (*kernel)(Params...), int blocks, size_t smem,
           cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks * CLUSTER);
  cfg.blockDim = dim3(T);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = CLUSTER > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <int CLUSTER, int T, int PATH>
int launch_fwd(const float* attrs, const int* count, float* color, float* depth,
               float* finalt, float* stash, int rows, int capacity, int chunk,
               int tiles, int grid_w, cudaStream_t stream) {
  return launch<CLUSTER, T>(tile_render_fwd_kernel<CLUSTER, T, PATH>, rows,
                            smem_bytes(capacity, chunk, PIX / CLUSTER, PATH == SPLIT),
                            stream,
                            attrs, count, color, depth, finalt, stash, capacity,
                            chunk, tiles, grid_w);
}

template <int CLUSTER, int T, int PATH>
int launch_sched(const float* attrs, const int* perm, const int* trips,
                 float* color, float* depth, float* finalt, float* stash,
                 int* fault, int rows, int slots, int capacity, int chunk,
                 int tiles, int grid_w, cudaStream_t stream) {
  return launch<CLUSTER, T>(tile_render_fwd_sched_kernel<CLUSTER, T, PATH>, slots / 2,
                            smem_bytes(capacity, chunk, PIX / CLUSTER, PATH == SPLIT),
                            stream,
                            attrs, perm, trips, color, depth, finalt, stash,
                            fault, rows, capacity, chunk, tiles, grid_w);
}

}  // namespace

// Dynamic shared memory of one block of K1 or K4 in clusters of `cluster`
// blocks per tile (0 for a shape the kernels do not take).
extern "C" int tile_render_fwd_smem(int capacity, int chunk, int cluster) {
  if (bad_shape(capacity, chunk) || (cluster != 1 && cluster != 2 && cluster != 4 &&
                                     cluster != 8)) {
    return 0;
  }
  return static_cast<int>(smem_bytes(capacity, chunk, PIX / cluster, false));
}

// K1.  attrs (rows, 12, K) f32, count (rows,) i32; outputs color
// (rows, 3, 256), depth (rows, 256), final_T (rows, 256), stash
// (rows, K, 256), all f32; `cluster` blocks per tile (1, 2, 4 or 8).
// Returns the launch's cudaError_t (0 = success).
extern "C" int tile_render_fwd(const float* attrs, const int* count,
                               float* color, float* depth, float* finalt,
                               float* stash, int rows, int capacity, int chunk,
                               int tiles, int grid_w, cudaStream_t stream,
                               int cluster) {
  if (bad_shape(capacity, chunk)) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  switch (cluster) {
    case 1: return launch_fwd<1, PIX / 1, ONE>(attrs, count, color, depth, finalt, stash,
                                          rows, capacity, chunk, tiles, grid_w, stream);
    case 2: return launch_fwd<2, PIX / 2, ONE>(attrs, count, color, depth, finalt, stash,
                                          rows, capacity, chunk, tiles, grid_w, stream);
    case 4: return launch_fwd<4, PIX / 4, ONE>(attrs, count, color, depth, finalt, stash,
                                          rows, capacity, chunk, tiles, grid_w, stream);
    case 8: return launch_fwd<8, PIX / 8, ONE>(attrs, count, color, depth, finalt, stash,
                                          rows, capacity, chunk, tiles, grid_w, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K4.  attrs (rows, 12, K) f32, perm and trips (slots,) i32 with slots even;
// outputs in slot order: color (slots, 3, 256), depth (slots, 256), final_T
// (slots, 256), stash (slots, K, 256), all f32.  `fault` is one i32 that
// collects FAULT_* bits; `cluster` blocks per pair of slots.  Returns the
// launch's cudaError_t.
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
    case 1: return launch_sched<1, PIX / 1, ONE>(attrs, perm, trips, color, depth, finalt,
                                            stash, fault, rows, slots, capacity, chunk,
                                            tiles, grid_w, stream);
    case 2: return launch_sched<2, PIX / 2, ONE>(attrs, perm, trips, color, depth, finalt,
                                            stash, fault, rows, slots, capacity, chunk,
                                            tiles, grid_w, stream);
    case 4: return launch_sched<4, PIX / 4, ONE>(attrs, perm, trips, color, depth, finalt,
                                            stash, fault, rows, slots, capacity, chunk,
                                            tiles, grid_w, stream);
    case 8: return launch_sched<8, PIX / 8, ONE>(attrs, perm, trips, color, depth, finalt,
                                            stash, fault, rows, slots, capacity, chunk,
                                            tiles, grid_w, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
