// K1 and K4: forward tile rasterizer with the R&B alpha stash, for Hopper
// (sm_90a).
//
// K1 replaces repro/kernels/tile_render.py::tile_render_fwd (the Pallas
// _fwd_kernel and its helpers _chunk_alphas, _blend_chunk, _fwd_tile_loop).
// It computes the same function, not the same blocks:
//
//   * one 256-thread block per 16x16 tile (one thread per pixel); rows of a
//     stacked multi-view call are tiles of their view (tile = row % tiles);
//   * the loop over ceil(count / chunk) chunks stages the chunk's 12 x C
//     attributes in shared memory;
//   * the chunk skip is a block vote (__syncthreads_or(trans > TERM_EPS)) in
//     place of the TPU kernel's jnp.max(trans);
//   * the stash holds the raw alpha of every pixel of every processed chunk
//     and zeros elsewhere, each element written exactly once (no memset);
//   * the blend keeps the operation order of _blend_chunk, and the build
//     uses -fmad=false so no multiply-add is contracted.
//
// K4 replaces repro/kernels/tile_render.py::tile_render_fwd_sched (the
// Pallas _sched_fwd_kernel): K1 under a WSU schedule.  One 256-thread block
// per balanced pair runs slot 2p (the heavy tile) and then slot 2p+1 (the
// light one), each slot's chunk loop bounded by its own trip count, with
// the outputs in slot order.  Both kernels call one per-tile device
// function, render_tile, so K4 equals K1 bit for bit by construction.  A
// slot whose perm entry is outside [0, rows) or whose trips are outside
// [0, K / chunk] is never read out of bounds: it runs as a pad slot (or with
// its trips clamped) and sets a bit of the fault word the wrapper reads.
//
// What bounds both on the H100: bytes.  At the slice's shapes (1200 tiles,
// K = 256) one view writes a 315 MB stash (1200 * 256 * 256 * 4 B) against
// ~78M exp evaluations; at 3.35 TB/s the stash alone takes ~94 us while
// the exps take a few us of the SM's special-function units.  The design
// answers with fully coalesced stash stores (a warp writes 32 neighbouring
// pixels of one fragment row) and no second pass over the stash.  K4's
// pair blocks are half as many as K1's tile blocks (600 at B=1), which at
// ~6 resident blocks per SM fit in one wave.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr int NUM_ATTRS = 12;
constexpr int MAX_CHUNK = 64;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float TERM_EPS = 1e-4f;

constexpr int FAULT_PERM = 1;   // a perm entry outside [0, rows)
constexpr int FAULT_TRIPS = 2;  // a trip count outside [0, K / chunk]

// One tile: `a` is its (12, capacity) attrs row, the outputs are its rows of
// color (3, 256), depth (256), final_T (256) and stash (capacity, 256).
// Every thread of the block calls it with the same tile and trips.
__device__ __forceinline__ void render_tile(
    const float* __restrict__ a, float* __restrict__ col,
    float* __restrict__ dep, float* __restrict__ ft, float* __restrict__ st,
    int capacity, int chunk, int tile_id, int grid_w, int trips,
    float (*s_attr)[MAX_CHUNK]) {
  const int pix = threadIdx.x;
  const float px = static_cast<float>((tile_id % grid_w) * TILE + pix % TILE) + 0.5f;
  const float py = static_cast<float>((tile_id / grid_w) * TILE + pix / TILE) + 0.5f;
  const int n_chunks = capacity / chunk;

  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_d = 0.f, trans = 1.f;
  for (int c = 0; c < n_chunks; ++c) {
    const int start = c * chunk;
    bool live = false;
    if (c < trips) {  // block-uniform: every thread reaches the vote
      live = __syncthreads_or(trans > TERM_EPS);
    }
    if (!live) {
      for (int i = 0; i < chunk; ++i) {
        st[static_cast<size_t>(start + i) * PIX + pix] = 0.f;
      }
      continue;
    }
    for (int j = pix; j < NUM_ATTRS * chunk; j += PIX) {
      const int r = j / chunk, i = j % chunk;
      s_attr[r][i] = a[r * capacity + start + i];
    }
    __syncthreads();
    for (int i = 0; i < chunk; ++i) {
      const float dx = px - s_attr[0][i];
      const float dy = py - s_attr[1][i];
      const float ca = s_attr[2][i], cb = s_attr[3][i], cc = s_attr[4][i];
      const float q = ca * dx * dx + 2.0f * cb * dx * dy + cc * dy * dy;
      const float gauss = expf(-0.5f * fmaxf(q, 0.0f));
      float alpha = fminf(s_attr[8][i] * gauss, ALPHA_MAX);
      alpha = (alpha >= ALPHA_MIN && s_attr[10][i] > 0.5f) ? alpha : 0.0f;
      st[static_cast<size_t>(start + i) * PIX + pix] = alpha;

      const float include = trans > TERM_EPS ? 1.0f : 0.0f;
      const float am = alpha * include;
      const float w = trans * am;
      acc_r += w * s_attr[5][i];
      acc_g += w * s_attr[6][i];
      acc_b += w * s_attr[7][i];
      acc_d += w * s_attr[9][i];
      trans = trans * (1.0f - am);
    }
    __syncthreads();  // the next chunk overwrites s_attr
  }

  col[pix] = acc_r;
  col[PIX + pix] = acc_g;
  col[2 * PIX + pix] = acc_b;
  dep[pix] = acc_d;
  ft[pix] = trans;
}

__global__ void __launch_bounds__(PIX)
tile_render_fwd_kernel(const float* __restrict__ attrs,
                       const int* __restrict__ count,
                       float* __restrict__ color, float* __restrict__ depth,
                       float* __restrict__ finalt, float* __restrict__ stash,
                       int capacity, int chunk, int tiles, int grid_w) {
  __shared__ float s_attr[NUM_ATTRS][MAX_CHUNK];
  const int row = blockIdx.x;
  render_tile(attrs + static_cast<size_t>(row) * NUM_ATTRS * capacity,
              color + static_cast<size_t>(row) * 3 * PIX,
              depth + static_cast<size_t>(row) * PIX,
              finalt + static_cast<size_t>(row) * PIX,
              stash + static_cast<size_t>(row) * capacity * PIX,
              capacity, chunk, row % tiles, grid_w,
              (count[row] + chunk - 1) / chunk, s_attr);
}

__global__ void __launch_bounds__(PIX)
tile_render_fwd_sched_kernel(const float* __restrict__ attrs,
                             const int* __restrict__ perm,
                             const int* __restrict__ trips,
                             float* __restrict__ color,
                             float* __restrict__ depth,
                             float* __restrict__ finalt,
                             float* __restrict__ stash, int* fault, int rows,
                             int capacity, int chunk, int tiles, int grid_w) {
  __shared__ float s_attr[NUM_ATTRS][MAX_CHUNK];
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
    if (j == 1) __syncthreads();  // slot 2p is done with s_attr
    render_tile(attrs + static_cast<size_t>(row) * NUM_ATTRS * capacity,
                color + static_cast<size_t>(slot) * 3 * PIX,
                depth + static_cast<size_t>(slot) * PIX,
                finalt + static_cast<size_t>(slot) * PIX,
                stash + static_cast<size_t>(slot) * capacity * PIX,
                capacity, chunk, row % tiles, grid_w, tr, s_attr);
  }
}

bool bad_chunk(int capacity, int chunk) {
  return chunk < 1 || chunk > MAX_CHUNK || capacity % chunk != 0;
}

}  // namespace

// K1.  attrs (rows, 12, K) f32, count (rows,) i32; outputs color
// (rows, 3, 256), depth (rows, 256), final_T (rows, 256), stash
// (rows, K, 256), all f32.  Returns the launch's cudaError_t (0 = success).
extern "C" int tile_render_fwd(const float* attrs, const int* count,
                               float* color, float* depth, float* finalt,
                               float* stash, int rows, int capacity, int chunk,
                               int tiles, int grid_w, cudaStream_t stream) {
  if (bad_chunk(capacity, chunk)) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  tile_render_fwd_kernel<<<rows, PIX, 0, stream>>>(
      attrs, count, color, depth, finalt, stash, capacity, chunk, tiles, grid_w);
  return static_cast<int>(cudaGetLastError());
}

// K4.  attrs (rows, 12, K) f32, perm and trips (slots,) i32 with slots even;
// outputs in slot order: color (slots, 3, 256), depth (slots, 256), final_T
// (slots, 256), stash (slots, K, 256), all f32.  `fault` is one i32 that
// collects FAULT_* bits.  Returns the launch's cudaError_t.
extern "C" int tile_render_fwd_sched(const float* attrs, const int* perm,
                                     const int* trips, float* color,
                                     float* depth, float* finalt, float* stash,
                                     int* fault, int rows, int slots,
                                     int capacity, int chunk, int tiles,
                                     int grid_w, cudaStream_t stream) {
  if (bad_chunk(capacity, chunk) || slots % 2 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (slots == 0) return 0;
  tile_render_fwd_sched_kernel<<<slots / 2, PIX, 0, stream>>>(
      attrs, perm, trips, color, depth, finalt, stash, fault, rows, capacity,
      chunk, tiles, grid_w);
  return static_cast<int>(cudaGetLastError());
}
