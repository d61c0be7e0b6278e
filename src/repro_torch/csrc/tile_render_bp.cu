// K2 and K5: backward tile rasterizer replaying the R&B stash, for Hopper
// (sm_90a).
//
// K2 replaces repro/kernels/tile_render_bp.py::tile_render_bwd (the Pallas
// _bwd_kernel and its helpers _pass_a_chunk, _pass_b_chunk,
// _bwd_tile_loops).  Same function, redesigned for the card:
//
//   * one 256-thread block per tile, one thread per pixel, as in K1;
//   * pass A replays the blend from the stash with multiplies only (no exp,
//     no alpha recompute) and gives each pixel sum(w * s) and its final T;
//   * pass B gives dL/dalpha = T * s - (suffix + T_final * g_T) / (1 - am)
//     per fragment, chained to mu, conic and opacity (with the clip mask)
//     and to color and depth;
//   * GMU level 1: each of the 10 per-pixel gradients is summed over the
//     tile's 256 pixels inside the block — warp shuffles, then the 8 warp
//     partials of a whole chunk in shared memory, then one thread per
//     (gradient, fragment) writes grads[tile, :, k].  No atomics;
//   * chunk skips are block votes replaying K1's, and every output element
//     is written exactly once (zeros for skipped chunks).
//
// K5 replaces repro/kernels/tile_render_bp.py::tile_render_bwd_sched (the
// Pallas _sched_bwd_kernel): K2 replaying a WSU schedule.  One block per
// balanced pair runs slot 2p and then slot 2p+1; the stash, cotangent and
// gradient rows are indexed by slot, the attrs row by perm[slot], and each
// slot's loops are bounded by its own trips (so every vote stays uniform
// across the block).  K2 and K5 call one per-tile device function,
// backward_tile, so K5 equals K2 bit for bit by construction; K5 guards its
// perm and trips as K4 does.
//
// What bounds it on the H100: bytes.  It reads the 315 MB stash of a view
// twice (once per pass) and does ~60 flops per (pixel, fragment) — about
// 4.7 GFLOP against 630 MB, far below the card's 20 flop/byte fp32 ridge.
// Stash loads are coalesced (a warp reads 32 neighbouring pixels of one
// fragment row); the in-block reduction keeps the 256x larger per-pixel
// gradients out of device memory.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr int WARPS = PIX / 32;
constexpr int NUM_ATTRS = 12;
constexpr int NUM_GRADS = 10;
constexpr int MAX_CHUNK = 64;
constexpr float ALPHA_MAX = 0.99f;
constexpr float TERM_EPS = 1e-4f;

constexpr int FAULT_PERM = 1;   // a perm entry outside [0, rows)
constexpr int FAULT_TRIPS = 2;  // a trip count outside [0, K / chunk]

// One tile: `a` is its (12, capacity) attrs row, `st` its (capacity, 256)
// stash row, `gc` / `gd` / `gt` its cotangent rows (3 x 256, 256, 256) and
// `gr` its (10, capacity) gradient row.  Every thread of the block calls it
// with the same tile and trips.
__device__ __forceinline__ void backward_tile(
    const float* __restrict__ a, const float* __restrict__ st,
    const float* __restrict__ gc, const float* __restrict__ gd,
    const float* __restrict__ gt, float* __restrict__ gr, int capacity,
    int chunk, int tile_id, int grid_w, int trips,
    float (*s_attr)[MAX_CHUNK], float (*s_part)[NUM_GRADS][WARPS]) {
  const int pix = threadIdx.x;
  const int lane = pix % 32, warp = pix / 32;
  const float px = static_cast<float>((tile_id % grid_w) * TILE + pix % TILE) + 0.5f;
  const float py = static_cast<float>((tile_id / grid_w) * TILE + pix / TILE) + 0.5f;
  const float g_r = gc[pix];
  const float g_g = gc[PIX + pix];
  const float g_b = gc[2 * PIX + pix];
  const float g_d = gd[pix];
  const float g_t = gt[pix];
  const int n_chunks = capacity / chunk;

  // ---- pass A: total sum(w * s) and final T (multiply-only replay) -------
  float trans = 1.f, total_ws = 0.f;
  for (int c = 0; c < trips; ++c) {
    const int start = c * chunk;
    if (!__syncthreads_or(trans > TERM_EPS)) break;  // block-uniform
    for (int j = pix; j < NUM_ATTRS * chunk; j += PIX) {
      const int r = j / chunk, i = j % chunk;
      s_attr[r][i] = a[r * capacity + start + i];
    }
    __syncthreads();
    for (int i = 0; i < chunk; ++i) {
      const float al = st[static_cast<size_t>(start + i) * PIX + pix];
      const float include = trans > TERM_EPS ? 1.0f : 0.0f;
      const float am = al * include;
      const float w = trans * am;
      const float s = g_r * s_attr[5][i] + g_g * s_attr[6][i]
                      + g_b * s_attr[7][i] + g_d * s_attr[9][i];
      total_ws += w * s;
      trans = trans * (1.0f - am);
    }
    __syncthreads();
  }
  const float ft_gt = trans * g_t;

  // ---- pass B: fragment gradients, merged over pixels (GMU level 1) ------
  trans = 1.f;
  float prefix = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const int start = c * chunk;
    bool live = false;
    if (c < trips) {  // block-uniform: every thread reaches the vote
      live = __syncthreads_or(trans > TERM_EPS);
    }
    if (!live) {
      for (int j = pix; j < NUM_GRADS * chunk; j += PIX) {
        gr[(j / chunk) * capacity + start + j % chunk] = 0.f;
      }
      continue;
    }
    for (int j = pix; j < NUM_ATTRS * chunk; j += PIX) {
      const int r = j / chunk, i = j % chunk;
      s_attr[r][i] = a[r * capacity + start + i];
    }
    __syncthreads();
    for (int i = 0; i < chunk; ++i) {
      const float al = st[static_cast<size_t>(start + i) * PIX + pix];
      const float include = trans > TERM_EPS ? 1.0f : 0.0f;
      const float am = al * include;
      const float w = trans * am;
      const float s = g_r * s_attr[5][i] + g_g * s_attr[6][i]
                      + g_b * s_attr[7][i] + g_d * s_attr[9][i];
      prefix += w * s;
      const float suffix = total_ws - prefix;
      const float dam = trans * s - (suffix + ft_gt) / (1.0f - am);
      const float da = dam * include;

      const float o = s_attr[8][i];
      const float clip = al < ALPHA_MAX ? 1.0f : 0.0f;
      const float dq = da * (-0.5f * al) * clip;
      const float dx = px - s_attr[0][i];
      const float dy = py - s_attr[1][i];
      const float ca = s_attr[2][i], cb = s_attr[3][i], cc = s_attr[4][i];

      float v[NUM_GRADS];
      v[0] = dq * (-2.0f) * (ca * dx + cb * dy);
      v[1] = dq * (-2.0f) * (cb * dx + cc * dy);
      v[2] = dq * dx * dx;
      v[3] = dq * 2.0f * dx * dy;
      v[4] = dq * dy * dy;
      v[5] = w * g_r;
      v[6] = w * g_g;
      v[7] = w * g_b;
      v[8] = da * (al / fmaxf(o, 1e-12f)) * clip;
      v[9] = w * g_d;
#pragma unroll
      for (int g = 0; g < NUM_GRADS; ++g) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          v[g] += __shfl_down_sync(0xffffffffu, v[g], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int g = 0; g < NUM_GRADS; ++g) s_part[i][g][warp] = v[g];
      }
      trans = trans * (1.0f - am);
    }
    __syncthreads();
    for (int j = pix; j < NUM_GRADS * chunk; j += PIX) {
      const int g = j / chunk, i = j % chunk;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) sum += s_part[i][g][w];
      gr[g * capacity + start + i] = sum;
    }
    __syncthreads();  // the next chunk overwrites s_attr and s_part
  }
}

__global__ void __launch_bounds__(PIX)
tile_render_bwd_kernel(const float* __restrict__ attrs,
                       const int* __restrict__ count,
                       const float* __restrict__ stash,
                       const float* __restrict__ g_color,
                       const float* __restrict__ g_depth,
                       const float* __restrict__ g_finalt,
                       float* __restrict__ grads,
                       int capacity, int chunk, int tiles, int grid_w) {
  __shared__ float s_attr[NUM_ATTRS][MAX_CHUNK];
  __shared__ float s_part[MAX_CHUNK][NUM_GRADS][WARPS];
  const int row = blockIdx.x;
  backward_tile(attrs + static_cast<size_t>(row) * NUM_ATTRS * capacity,
                stash + static_cast<size_t>(row) * capacity * PIX,
                g_color + static_cast<size_t>(row) * 3 * PIX,
                g_depth + static_cast<size_t>(row) * PIX,
                g_finalt + static_cast<size_t>(row) * PIX,
                grads + static_cast<size_t>(row) * NUM_GRADS * capacity,
                capacity, chunk, row % tiles, grid_w,
                (count[row] + chunk - 1) / chunk, s_attr, s_part);
}

__global__ void __launch_bounds__(PIX)
tile_render_bwd_sched_kernel(const float* __restrict__ attrs,
                             const int* __restrict__ perm,
                             const int* __restrict__ trips,
                             const float* __restrict__ stash,
                             const float* __restrict__ g_color,
                             const float* __restrict__ g_depth,
                             const float* __restrict__ g_finalt,
                             float* __restrict__ grads, int* fault, int rows,
                             int capacity, int chunk, int tiles, int grid_w) {
  __shared__ float s_attr[NUM_ATTRS][MAX_CHUNK];
  __shared__ float s_part[MAX_CHUNK][NUM_GRADS][WARPS];
  const int n_chunks = capacity / chunk;
  for (int j = 0; j < 2; ++j) {
    const int slot = 2 * blockIdx.x + j;
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
    if (j == 1) __syncthreads();  // slot 2p is done with s_attr and s_part
    backward_tile(attrs + static_cast<size_t>(row) * NUM_ATTRS * capacity,
                  stash + static_cast<size_t>(slot) * capacity * PIX,
                  g_color + static_cast<size_t>(slot) * 3 * PIX,
                  g_depth + static_cast<size_t>(slot) * PIX,
                  g_finalt + static_cast<size_t>(slot) * PIX,
                  grads + static_cast<size_t>(slot) * NUM_GRADS * capacity,
                  capacity, chunk, row % tiles, grid_w, tr, s_attr, s_part);
  }
}

bool bad_chunk(int capacity, int chunk) {
  return chunk < 1 || chunk > MAX_CHUNK || capacity % chunk != 0;
}

}  // namespace

// K2.  attrs (rows, 12, K), count (rows,) i32, stash (rows, K, 256), g_color
// (rows, 3, 256), g_depth (rows, 256), g_finalt (rows, 256); output grads
// (rows, 10, K), all f32.  Returns the launch's cudaError_t (0 = success).
extern "C" int tile_render_bwd(const float* attrs, const int* count,
                               const float* stash, const float* g_color,
                               const float* g_depth, const float* g_finalt,
                               float* grads, int rows, int capacity, int chunk,
                               int tiles, int grid_w, cudaStream_t stream) {
  if (bad_chunk(capacity, chunk)) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  tile_render_bwd_kernel<<<rows, PIX, 0, stream>>>(
      attrs, count, stash, g_color, g_depth, g_finalt, grads, capacity, chunk,
      tiles, grid_w);
  return static_cast<int>(cudaGetLastError());
}

// K5.  attrs (rows, 12, K), perm and trips (slots,) i32 with slots even;
// stash (slots, K, 256), g_color (slots, 3, 256), g_depth and g_finalt
// (slots, 256) in slot order; output grads (slots, 10, K) in slot order,
// all f32.  `fault` is one i32 that collects FAULT_* bits.  Returns the
// launch's cudaError_t.
extern "C" int tile_render_bwd_sched(const float* attrs, const int* perm,
                                     const int* trips, const float* stash,
                                     const float* g_color, const float* g_depth,
                                     const float* g_finalt, float* grads,
                                     int* fault, int rows, int slots,
                                     int capacity, int chunk, int tiles,
                                     int grid_w, cudaStream_t stream) {
  if (bad_chunk(capacity, chunk) || slots % 2 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (slots == 0) return 0;
  tile_render_bwd_sched_kernel<<<slots / 2, PIX, 0, stream>>>(
      attrs, perm, trips, stash, g_color, g_depth, g_finalt, grads, fault, rows,
      capacity, chunk, tiles, grid_w);
  return static_cast<int>(cudaGetLastError());
}
