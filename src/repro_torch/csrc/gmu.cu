// K3: blocked inclusive prefix sum along axis 0, for Hopper (sm_90a).
//
// Replaces repro/kernels/gmu.py::block_cumsum (the Pallas
// _block_cumsum_kernel): the pipelined adder of GMU level 2, an inclusive
// prefix sum over the rows of an (M, G) float32 tensor, M a multiple of the
// block of 256 rows.  On the TPU the grid runs in order and carries each
// block's last row to the next block in scratch memory.  Hopper blocks run
// in no order and carry nothing, so the carry becomes a second pass:
//
//   1. block_totals: one 256-thread block per 256-row block scans its rows
//      (thread r owns row r; per column a warp shuffle scan, then the 8 warp
//      totals in shared memory) and writes the block's column totals;
//   2. scan_totals: one block, one warp per column, turns the totals into
//      exclusive carries, 32 blocks per step (warp scan plus a running sum);
//   3. block_scan: every block scans its rows again the same way and writes
//      local prefix + carry.
//
// Passes 1 and 3 read the input and pass 3 writes the output, each with
// coalesced accesses through the rows staged in shared memory.  What
// bounds it on the H100: bytes.  At the slice's shapes (M = 1200 * 256 = 307200 rows,
// G = 10) one read and one write of the tensor are 24.6 MB, 7.3 us at
// 3.35 TB/s; the three passes read it twice.  The sums run in another order
// than the TPU kernel's log-step scan and the sequential carry, so results
// agree to rounding, not bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;
constexpr int WARPS = BLOCK / 32;
constexpr int MAX_G = 32;

__device__ __forceinline__ float warp_inclusive_scan(float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += up;
  }
  return v;
}

// Inclusive scan of column g over the block's 256 rows staged in s_rows
// (row-major, G columns); thread r gets row r's prefix.
__device__ __forceinline__ float block_column_scan(const float* s_rows, int g,
                                                   int num_g,
                                                   float* s_warp) {
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  float v = warp_inclusive_scan(s_rows[t * num_g + g], lane);
  if (lane == 31) s_warp[warp] = v;
  __syncthreads();
  float before = 0.f;
  for (int w = 0; w < warp; ++w) before += s_warp[w];
  __syncthreads();  // s_warp is reused by the next column
  return before + v;
}

__device__ __forceinline__ void stage_rows(const float* __restrict__ vals,
                                           float* s_rows, int num_g) {
  const float* src = vals + static_cast<size_t>(blockIdx.x) * BLOCK * num_g;
  for (int j = threadIdx.x; j < BLOCK * num_g; j += BLOCK) s_rows[j] = src[j];
  __syncthreads();
}

__global__ void __launch_bounds__(BLOCK)
block_totals(const float* __restrict__ vals, float* __restrict__ totals,
             int num_g) {
  __shared__ float s_rows[BLOCK * MAX_G];
  __shared__ float s_warp[WARPS];
  stage_rows(vals, s_rows, num_g);
  for (int g = 0; g < num_g; ++g) {
    const float p = block_column_scan(s_rows, g, num_g, s_warp);
    if (threadIdx.x == BLOCK - 1) {
      totals[static_cast<size_t>(blockIdx.x) * num_g + g] = p;
    }
  }
}

// One warp per column: carries[b, g] = sum of totals[:b, g].
__global__ void scan_totals(const float* __restrict__ totals,
                            float* __restrict__ carries, int blocks,
                            int num_g) {
  const int lane = threadIdx.x % 32, g = threadIdx.x / 32;
  if (g >= num_g) return;
  float run = 0.f;
  for (int base = 0; base < blocks; base += 32) {
    const int b = base + lane;
    const float x = b < blocks ? totals[static_cast<size_t>(b) * num_g + g] : 0.f;
    const float incl = warp_inclusive_scan(x, lane);
    if (b < blocks) carries[static_cast<size_t>(b) * num_g + g] = run + (incl - x);
    run += __shfl_sync(0xffffffffu, incl, 31);
  }
}

__global__ void __launch_bounds__(BLOCK)
block_scan(const float* __restrict__ vals, const float* __restrict__ carries,
           float* __restrict__ out, int num_g) {
  __shared__ float s_rows[BLOCK * MAX_G];
  __shared__ float s_warp[WARPS];
  stage_rows(vals, s_rows, num_g);
  const float* carry = carries + static_cast<size_t>(blockIdx.x) * num_g;
  for (int g = 0; g < num_g; ++g) {
    const float p = block_column_scan(s_rows, g, num_g, s_warp);
    // Only this thread reads element (t, g), and it already has: the
    // result can replace it, to leave the block in one coalesced store.
    s_rows[threadIdx.x * num_g + g] = p + carry[g];
  }
  __syncthreads();
  float* dst = out + static_cast<size_t>(blockIdx.x) * BLOCK * num_g;
  for (int j = threadIdx.x; j < BLOCK * num_g; j += BLOCK) dst[j] = s_rows[j];
}

}  // namespace

// vals and out (rows, G) f32 with rows % 256 == 0 and 1 <= G <= 32;
// totals and carries (rows / 256, G) f32 scratch.  Three launches on
// `stream`; returns the first cudaError_t (0 = success).
extern "C" int block_cumsum(const float* vals, float* out, float* totals,
                            float* carries, int rows, int num_g,
                            cudaStream_t stream) {
  if (rows % BLOCK != 0 || num_g < 1 || num_g > MAX_G) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = rows / BLOCK;
  if (blocks == 0) return 0;
  block_totals<<<blocks, BLOCK, 0, stream>>>(vals, totals, num_g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_totals<<<1, 32 * num_g, 0, stream>>>(totals, carries, blocks, num_g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  block_scan<<<blocks, BLOCK, 0, stream>>>(vals, carries, out, num_g);
  return static_cast<int>(cudaGetLastError());
}
