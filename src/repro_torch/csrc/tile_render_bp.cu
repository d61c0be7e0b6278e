// K2 and K5: backward tile rasterizer replaying the R&B stash, for Hopper
// (sm_90a).
//
// K2 replaces repro/kernels/tile_render_bp.py::tile_render_bwd (the Pallas
// _bwd_kernel and its helpers _pass_a_chunk, _pass_b_chunk,
// _bwd_tile_loops).  Same function, redesigned for the card:
//
//   * one 256-thread block per tile, one thread per pixel, as in K1;
//   * ONE pass over the stash.  The reference's pass A (a replay that gives
//     each pixel sum(w * s) and its final T) is gone: with s = gC . c + gD d,
//     sum(w * s) = gC . C + gD D, where C and D are the color and depth the
//     forward (K1 / K4) wrote, and the final T is the forward's final_T,
//     computed by the same operations.  So the forward's tile outputs are
//     operands, and each element of a processed chunk's stash row is read
//     once;
//   * dL/dalpha = T * s - (suffix + T_final * g_T) / (1 - am) per fragment,
//     chained to mu, conic and opacity (with the clip mask) and to color and
//     depth;
//   * GMU level 1 by a warp reduce-scatter: each warp sums the 10 per-pixel
//     gradients of a group of GROUP fragments over its 32 lanes by halving
//     exchanges (xor 16, 8, ...: each lane keeps one half and adds the
//     partner's copy of it), then a butterfly over the lanes left; each lane
//     ends with the sums of one fragment and stores some of them.  About 11
//     shuffles per fragment at GROUP = 8, against 50 for one 5-step tree per
//     gradient.  Whatever GROUP is, each sum adds lanes 16, 8, 4, 2 and 1
//     apart in that order, which the plain version (_pixel_sum) repeats bit
//     for bit.  The 8 warp partials of a chunk are then added in shared
//     memory in a fixed order, one thread per (gradient, fragment), and each
//     gradient element is written once.  No atomics;
//   * a warp whose lanes draw none of a group's fragments (every lane has
//     terminated, or every alpha of the group is 0) stores zero partials and
//     skips the group's arithmetic and shuffles; inside a group, a fragment
//     no lane draws skips its arithmetic.  Such a fragment leaves T and the
//     prefix sum unchanged bit for bit (T * (1 - 0), prefix + 0), so the
//     skips change no result.  The votes are warp-uniform (__all_sync,
//     __any_sync);
//   * registers: the exchange levels of a group wait in registers, except
//     the top level's 10 sums, which wait in shared memory (each lane its
//     own row), so that both kernels fit 3 blocks per SM without spills;
//   * a group's GROUP stash loads are issued together before its arithmetic
//     (they do not depend on T), and the chunk's attributes are staged in
//     shared memory as one 48-byte row per fragment (three 16-byte loads),
//     with 1 / opacity in its pad slot: the opacity gradient is
//     da * (alpha * (1 / o)), one division per fragment instead of one per
//     pixel (the reference divides per pixel; the two differ by rounding);
//   * chunk skips are block votes replaying K1's, and every output element
//     is written exactly once (zeros for skipped chunks).
//
// K5 replaces repro/kernels/tile_render_bp.py::tile_render_bwd_sched (the
// Pallas _sched_bwd_kernel): K2 replaying a WSU schedule.  One block per
// balanced pair runs slot 2p and then slot 2p+1; the stash, forward-output,
// cotangent and gradient rows are indexed by slot, the attrs row by
// perm[slot], and each slot's loops are bounded by its own trips (so every
// vote stays uniform across the block).  K2 and K5 call one per-tile device
// function, backward_tile, so K5 equals K2 bit for bit by construction; K5
// guards its perm and trips as K4 does.
//
// What bounds it on the H100: bytes, by the count of one read of the stash
// of the chunks that run (~173 MB of a 315 MB near-tile view) — against ~60
// flops per (pixel, fragment).  In practice the per-fragment instruction
// stream (the arithmetic, doubled by -fmad=false, and the shuffles) is what
// the design trims; stash loads are coalesced (a warp reads 32 neighbouring
// pixels of one fragment row) and the per-pixel gradients never reach
// device memory.

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
constexpr unsigned FULL = 0xffffffffu;

// Fragments per warp reduce-scatter.  A group keeps 10 * log2(GROUP)
// partial sums pending: the top level's in shared memory (each lane its own
// row, so no barrier), the others in registers.  8 is the fastest of 4, 8
// and 16 that fits 3 blocks per SM without spills (tools/bwd_variants.py,
// PERF.md).
constexpr int GROUP = 8;
constexpr int LOG_GROUP = GROUP == 4 ? 2 : GROUP == 8 ? 3 : 4;
static_assert(GROUP == 4 || GROUP == 8 || GROUP == 16, "GROUP is 4, 8 or 16");
// Lanes that end up holding the same fragment's sums (the butterfly's).
constexpr int SHARERS = 32 / GROUP;
// Row stride of the warp partials, padded so that their stores and the
// final per-(gradient, fragment) sums fall in distinct banks.
constexpr int PART_STRIDE = MAX_CHUNK + 1;

constexpr int FAULT_PERM = 1;   // a perm entry outside [0, rows)
constexpr int FAULT_TRIPS = 2;  // a trip count outside [0, K / chunk]

__device__ constexpr int trailing_ones(int s) {
  int n = 0;
  while (s & 1) {
    ++n;
    s >>= 1;
  }
  return n;
}

// One reduce-scatter step over lanes `off` apart: a lane without the `off`
// bit keeps the earlier fragments' values (`early`), one with it the later
// ones (`v`), and each adds its partner's copy.  The result is left in `v`.
__device__ __forceinline__ void exchange(const float (&early)[NUM_GRADS],
                                         float (&v)[NUM_GRADS], int off,
                                         bool upper) {
#pragma unroll
  for (int g = 0; g < NUM_GRADS; ++g) {
    const float send = upper ? early[g] : v[g];
    const float mine = upper ? v[g] : early[g];
    v[g] = mine + __shfl_xor_sync(FULL, send, off);
  }
}

// One tile: `a` is its (12, capacity) attrs row, `st` its (capacity, 256)
// stash row, `col` / `dep` / `ft` the forward's color (3 x 256), depth
// (256) and final T (256) of the tile, `gc` / `gd` / `gt` its cotangent
// rows (3 x 256, 256, 256) and `gr` its (10, capacity) gradient row.  Every
// thread of the block calls it with the same tile and trips.
__device__ __forceinline__ void backward_tile(
    const float* __restrict__ a, const float* __restrict__ st,
    const float* __restrict__ col, const float* __restrict__ dep,
    const float* __restrict__ ft, const float* __restrict__ gc,
    const float* __restrict__ gd, const float* __restrict__ gt,
    float* __restrict__ gr, int capacity, int chunk, int tile_id, int grid_w,
    int trips, float (*s_attr)[NUM_ATTRS],
    float (*s_part)[WARPS][PART_STRIDE], float (*s_top)[NUM_GRADS][32]) {
  const int pix = threadIdx.x;
  const int lane = pix % 32, warp = pix / 32;
  const float px = static_cast<float>((tile_id % grid_w) * TILE + pix % TILE) + 0.5f;
  const float py = static_cast<float>((tile_id / grid_w) * TILE + pix / TILE) + 0.5f;
  const float g_r = gc[pix];
  const float g_g = gc[PIX + pix];
  const float g_b = gc[2 * PIX + pix];
  const float g_d = gd[pix];
  const int n_chunks = capacity / chunk;

  // What the reference's pass A replayed: sum(w * s) and the final T.
  const float total_ws = g_r * col[pix] + g_g * col[PIX + pix]
                         + g_b * col[2 * PIX + pix] + g_d * dep[pix];
  const float ft_gt = ft[pix] * gt[pix];

  // The group slot whose sums this lane holds after the exchanges (lane bit
  // 4 - l picks slot bit l), and its rank among the lanes holding them.
  int my_slot = 0;
#pragma unroll
  for (int l = 0; l < LOG_GROUP; ++l) my_slot |= ((lane >> (4 - l)) & 1) << l;
  const int sharer = lane % SHARERS;

  float trans = 1.f, prefix = 0.f;
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
    // The pad attribute (row 11) is staged as 1 / max(opacity, 1e-12), so
    // that the opacity gradient takes a multiply, not a division, per pixel.
    for (int j = pix; j < NUM_ATTRS * chunk; j += PIX) {
      const int r = j / chunk, i = j % chunk;
      s_attr[i][r] = r == NUM_ATTRS - 1
          ? 1.0f / fmaxf(a[8 * capacity + start + i], 1e-12f)
          : a[r * capacity + start + i];
    }
    __syncthreads();
    for (int base = 0; base < chunk; base += GROUP) {
      float al[GROUP];
      bool idle = !(trans > TERM_EPS);
#pragma unroll
      for (int s = 0; s < GROUP; ++s) {
        al[s] = base + s < chunk ? st[static_cast<size_t>(start + base + s) * PIX + pix]
                                 : 0.f;
      }
      if (!idle) {
        idle = true;
#pragma unroll
        for (int s = 0; s < GROUP; ++s) idle = idle && al[s] == 0.f;
      }
      float v[NUM_GRADS];
      if (__all_sync(FULL, idle)) {
        // No lane draws a fragment of the group: zero partials, and T and
        // the prefix sum stay as they are.
#pragma unroll
        for (int g = 0; g < NUM_GRADS; ++g) v[g] = 0.f;
      } else {
        float pend[LOG_GROUP - 1][NUM_GRADS];  // levels below the top
#pragma unroll
        for (int s = 0; s < GROUP; ++s) {
          const float al_s = al[s];
          const float include = trans > TERM_EPS ? 1.0f : 0.0f;
          const float am = al_s * include;
          if (__any_sync(FULL, am != 0.f)) {
            const int i = base + s;
            const float4* fa = reinterpret_cast<const float4*>(s_attr[i]);
            // (mu_x, mu_y, conic a, conic b), (conic c, r, g, b),
            // (opacity, depth, present, 1 / opacity)
            const float4 p0 = fa[0], p1 = fa[1], p2 = fa[2];
            const float w = trans * am;
            const float sw = g_r * p1.y + g_g * p1.z + g_b * p1.w + g_d * p2.y;
            prefix += w * sw;
            const float suffix = total_ws - prefix;
            const float dam = trans * sw - (suffix + ft_gt) / (1.0f - am);
            const float da = dam * include;

            const float clip = al_s < ALPHA_MAX ? 1.0f : 0.0f;
            const float dq = da * (-0.5f * al_s) * clip;
            const float dx = px - p0.x;
            const float dy = py - p0.y;
            const float ca = p0.z, cb = p0.w, cc = p1.x;

            v[0] = dq * (-2.0f) * (ca * dx + cb * dy);
            v[1] = dq * (-2.0f) * (cb * dx + cc * dy);
            v[2] = dq * dx * dx;
            v[3] = dq * 2.0f * dx * dy;
            v[4] = dq * dy * dy;
            v[5] = w * g_r;
            v[6] = w * g_g;
            v[7] = w * g_b;
            v[8] = da * (al_s * p2.w) * clip;
            v[9] = w * g_d;
            trans = trans * (1.0f - am);
          } else {  // no lane draws it: exact zeros, T unchanged
#pragma unroll
            for (int g = 0; g < NUM_GRADS; ++g) v[g] = 0.f;
          }
          // Carry up the exchange levels: slot s meets the parked values of
          // slots s - 1, s - 3, ... at levels 0, 1, ... (its trailing ones),
          // then parks at the next level.  All indices are compile-time.
#pragma unroll
          for (int l = 0; l < LOG_GROUP; ++l) {
            if (l >= trailing_ones(s)) continue;
            if (l < LOG_GROUP - 1) {
              exchange(pend[l], v, 16 >> l, (lane >> (4 - l)) & 1);
            } else {
              float top[NUM_GRADS];
#pragma unroll
              for (int g = 0; g < NUM_GRADS; ++g) top[g] = s_top[warp][g][lane];
              exchange(top, v, 16 >> l, (lane >> (4 - l)) & 1);
            }
          }
#pragma unroll
          for (int l = 0; l < LOG_GROUP; ++l) {
            if (l != trailing_ones(s)) continue;
#pragma unroll
            for (int g = 0; g < NUM_GRADS; ++g) {
              if (l < LOG_GROUP - 1) {
                pend[l][g] = v[g];
              } else {
                s_top[warp][g][lane] = v[g];
              }
            }
          }
        }
        // The lanes left share one slot: a butterfly gives each the sums.
#pragma unroll
        for (int off = SHARERS / 2; off > 0; off >>= 1) {
#pragma unroll
          for (int g = 0; g < NUM_GRADS; ++g) v[g] += __shfl_xor_sync(FULL, v[g], off);
        }
      }
      if (base + my_slot < chunk) {
#pragma unroll
        for (int g = 0; g < NUM_GRADS; ++g) {
          if (g % SHARERS == sharer) s_part[g][warp][base + my_slot] = v[g];
        }
      }
    }
    __syncthreads();
    for (int j = pix; j < NUM_GRADS * chunk; j += PIX) {
      const int g = j / chunk, i = j % chunk;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) sum += s_part[g][w][i];
      gr[g * capacity + start + i] = sum;
    }
    __syncthreads();  // the next chunk overwrites s_attr and s_part
  }
}

__global__ void __launch_bounds__(PIX)
tile_render_bwd_kernel(const float* __restrict__ attrs,
                       const int* __restrict__ count,
                       const float* __restrict__ color,
                       const float* __restrict__ depth,
                       const float* __restrict__ finalt,
                       const float* __restrict__ stash,
                       const float* __restrict__ g_color,
                       const float* __restrict__ g_depth,
                       const float* __restrict__ g_finalt,
                       float* __restrict__ grads,
                       int capacity, int chunk, int tiles, int grid_w) {
  __shared__ __align__(16) float s_attr[MAX_CHUNK][NUM_ATTRS];
  __shared__ float s_part[NUM_GRADS][WARPS][PART_STRIDE];
  __shared__ float s_top[WARPS][NUM_GRADS][32];
  const int row = blockIdx.x;
  backward_tile(attrs + static_cast<size_t>(row) * NUM_ATTRS * capacity,
                stash + static_cast<size_t>(row) * capacity * PIX,
                color + static_cast<size_t>(row) * 3 * PIX,
                depth + static_cast<size_t>(row) * PIX,
                finalt + static_cast<size_t>(row) * PIX,
                g_color + static_cast<size_t>(row) * 3 * PIX,
                g_depth + static_cast<size_t>(row) * PIX,
                g_finalt + static_cast<size_t>(row) * PIX,
                grads + static_cast<size_t>(row) * NUM_GRADS * capacity,
                capacity, chunk, row % tiles, grid_w,
                (count[row] + chunk - 1) / chunk, s_attr, s_part, s_top);
}

// K5's operands, passed as one parameter.
struct SchedOperands {
  const float* attrs;
  const int* perm;
  const int* trips;
  const float* color;
  const float* depth;
  const float* finalt;
  const float* stash;
  const float* g_color;
  const float* g_depth;
  const float* g_finalt;
  float* grads;
  int* fault;
  int rows, capacity, chunk, tiles, grid_w;
};

__global__ void __launch_bounds__(PIX)
tile_render_bwd_sched_kernel(const SchedOperands o) {
  __shared__ __align__(16) float s_attr[MAX_CHUNK][NUM_ATTRS];
  __shared__ float s_part[NUM_GRADS][WARPS][PART_STRIDE];
  __shared__ float s_top[WARPS][NUM_GRADS][32];
#pragma unroll 1
  for (int j = 0; j < 2; ++j) {
    if (j == 1) __syncthreads();  // slot 2p is done with s_attr and s_part
    const int n_chunks = o.capacity / o.chunk;
    const int slot = 2 * blockIdx.x + j;
    int row = o.perm[slot];
    int tr = o.trips[slot];
    if (row < 0 || row >= o.rows) {  // block-uniform guard: run as a pad slot
      if (threadIdx.x == 0) atomicOr(o.fault, FAULT_PERM);
      row = 0;
      tr = 0;
    }
    if (tr < 0 || tr > n_chunks) {
      if (threadIdx.x == 0) atomicOr(o.fault, FAULT_TRIPS);
      tr = tr < 0 ? 0 : n_chunks;
    }
    const int cap = o.capacity;
    backward_tile(o.attrs + static_cast<size_t>(row) * NUM_ATTRS * cap,
                  o.stash + static_cast<size_t>(slot) * cap * PIX,
                  o.color + static_cast<size_t>(slot) * 3 * PIX,
                  o.depth + static_cast<size_t>(slot) * PIX,
                  o.finalt + static_cast<size_t>(slot) * PIX,
                  o.g_color + static_cast<size_t>(slot) * 3 * PIX,
                  o.g_depth + static_cast<size_t>(slot) * PIX,
                  o.g_finalt + static_cast<size_t>(slot) * PIX,
                  o.grads + static_cast<size_t>(slot) * NUM_GRADS * cap,
                  cap, o.chunk, row % o.tiles, o.grid_w, tr, s_attr, s_part,
                  s_top);
  }
}

bool bad_chunk(int capacity, int chunk) {
  return chunk < 1 || chunk > MAX_CHUNK || capacity % chunk != 0;
}

}  // namespace

// K2.  attrs (rows, 12, K), count (rows,) i32, the forward's color
// (rows, 3, 256), depth (rows, 256), final_T (rows, 256) and stash
// (rows, K, 256), g_color (rows, 3, 256), g_depth (rows, 256), g_finalt
// (rows, 256); output grads (rows, 10, K), all f32.  Returns the launch's
// cudaError_t (0 = success).
extern "C" int tile_render_bwd(const float* attrs, const int* count,
                               const float* color, const float* depth,
                               const float* finalt, const float* stash,
                               const float* g_color, const float* g_depth,
                               const float* g_finalt, float* grads, int rows,
                               int capacity, int chunk, int tiles, int grid_w,
                               cudaStream_t stream) {
  if (bad_chunk(capacity, chunk)) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  tile_render_bwd_kernel<<<rows, PIX, 0, stream>>>(
      attrs, count, color, depth, finalt, stash, g_color, g_depth, g_finalt,
      grads, capacity, chunk, tiles, grid_w);
  return static_cast<int>(cudaGetLastError());
}

// K5.  attrs (rows, 12, K), perm and trips (slots,) i32 with slots even;
// the forward's color (slots, 3, 256), depth and final_T (slots, 256) and
// stash (slots, K, 256), g_color (slots, 3, 256), g_depth and g_finalt
// (slots, 256), all in slot order; output grads (slots, 10, K) in slot
// order, all f32.  `fault` is one i32 that collects FAULT_* bits.  Returns
// the launch's cudaError_t.
extern "C" int tile_render_bwd_sched(const float* attrs, const int* perm,
                                     const int* trips, const float* color,
                                     const float* depth, const float* finalt,
                                     const float* stash, const float* g_color,
                                     const float* g_depth,
                                     const float* g_finalt, float* grads,
                                     int* fault, int rows, int slots,
                                     int capacity, int chunk, int tiles,
                                     int grid_w, cudaStream_t stream) {
  if (bad_chunk(capacity, chunk) || slots % 2 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (slots == 0) return 0;
  const SchedOperands ops{attrs,   perm,    trips,    color, depth,
                          finalt,  stash,   g_color,  g_depth, g_finalt,
                          grads,   fault,   rows,     capacity, chunk,
                          tiles,   grid_w};
  tile_render_bwd_sched_kernel<<<slots / 2, PIX, 0, stream>>>(ops);
  return static_cast<int>(cudaGetLastError());
}
