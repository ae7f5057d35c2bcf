// All-pairs softened gravity (B1), its near-list form for the treecodes' near
// pass, and pairwise potential energy (B2) for Hopper (sm_90a), with a plain
// C interface bound from Python by ctypes
// (nbody_tpu_torch/ops/build.py, nbody_tpu_torch/ops/pairwise.py).
//
// Every entry point launches on the caller's stream, does not synchronise and
// allocates nothing: the Python wrapper allocates outputs and scratch. Each
// returns cudaGetLastError() after its launches, so a launch the device
// refuses is reported to the wrapper, which raises.
//
// Sources arrive packed as float4 [x, y, z, m] (the wrapper builds that copy
// from the (N, 3) positions and (N,) masses); targets stay (N, 3) row-major.

#include <climits>
#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------- B1: force
//
// Replaces nbody_tpu/ops/pairwise.py::_force_kernel (Pallas, TPU):
//
//   a_i = G * sum_j m_j (r_j - r_i) * rsqrt(max(|r_j - r_i|^2 + eps^2, 1e-18))^3
//
// No self mask: a coincident pair has dx == dy == dz == 0, so it adds an exact
// zero, and the 1e-18 floor keeps rsqrt finite even at eps == 0. Zero-mass
// sources (the ragged tail of the last tile) add exact zeros too.
//
// What bounds it: FP32 issue. Per pair the kernel does 3 subtractions,
// 3 FMAs for d2, a max, one MUFU rsqrt, 3 multiplies for w and 3 FMAs into the
// accumulators: about 13 FP32 instructions (~20 flops), with the rsqrt on the
// quarter-rate MUFU pipe. Global memory is not a limit: each source is read
// once per block into shared memory and then used by all of the block's rows.
//
// Design: FORCE_ROWS targets per block, FORCE_SPLIT threads per target. The
// block stages FORCE_TILE sources in shared memory (one float4 per thread);
// lane s of a target takes every FORCE_SPLIT-th source of the tile, so the
// FORCE_SPLIT lanes read FORCE_SPLIT consecutive float4s (one 128-byte
// shared-memory wavefront, broadcast to the other rows of the warp). Splitting
// a target over several threads gives FORCE_SPLIT times more blocks than one
// thread per target, which matters at the 10^4-body scale where one thread
// per row would leave most SMs idle. The lanes' partial sums meet in a fixed
// butterfly of warp shuffles, so the result is deterministic. Coordinate
// differences are exact (no |a|^2 + |b|^2 - 2ab expansion) and there are no
// tensor cores: the TPU kernel's matrix-unit form lost ~1e-4 relative accuracy
// to cancellation (nbody_tpu/ops/pairwise.py:93-96).
constexpr int FORCE_ROWS = 32;
constexpr int FORCE_SPLIT = 8;
constexpr int FORCE_THREADS = FORCE_ROWS * FORCE_SPLIT;
constexpr int FORCE_TILE = FORCE_THREADS;
constexpr float D2_FLOOR = 1e-18f;

static_assert(32 % FORCE_SPLIT == 0, "a target's lanes must share a warp");

// The one pair of both forms of B1: the source s = [x, y, z, m] pulls the
// target (xi, yi, zi); adds m (r_s - r_i) / (|r_s - r_i|^2 + eps^2)^{3/2},
// without the factor G.
__device__ __forceinline__ void pair_pull(const float4 s, float xi, float yi,
                                          float zi, float eps2, float& ax,
                                          float& ay, float& az) {
  const float dx = s.x - xi;
  const float dy = s.y - yi;
  const float dz = s.z - zi;
  const float d2 = fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, eps2)));
  const float inv = rsqrtf(fmaxf(d2, D2_FLOOR));
  const float w = s.w * inv * inv * inv;
  ax = fmaf(w, dx, ax);
  ay = fmaf(w, dy, ay);
  az = fmaf(w, dz, az);
}

// The staged tile on this thread's target: lane s takes every
// FORCE_SPLIT-th source.
__device__ __forceinline__ void pull_tile(const float4* tile, int lane, float xi,
                                          float yi, float zi, float eps2,
                                          float& ax, float& ay, float& az) {
#pragma unroll 8
  for (int t = lane; t < FORCE_TILE; t += FORCE_SPLIT)
    pair_pull(tile[t], xi, yi, zi, eps2, ax, ay, az);
}

// The lanes' partial sums in a fixed butterfly; lane 0 writes G * a.
__device__ __forceinline__ void finish(float ax, float ay, float az, int lane,
                                       bool live, float g, float* out) {
  for (int off = FORCE_SPLIT / 2; off > 0; off >>= 1) {
    ax += __shfl_xor_sync(0xffffffffu, ax, off);
    ay += __shfl_xor_sync(0xffffffffu, ay, off);
    az += __shfl_xor_sync(0xffffffffu, az, off);
  }
  if (lane == 0 && live) {
    out[0] = g * ax;
    out[1] = g * ay;
    out[2] = g * az;
  }
}

__global__ void __launch_bounds__(FORCE_THREADS)
force_kernel(const float* __restrict__ pos_i, const float4* __restrict__ src,
             int ni, int nj, float g, float eps2, float* __restrict__ acc) {
  __shared__ float4 tile[FORCE_TILE];
  const int lane = threadIdx.x % FORCE_SPLIT;
  const int row = blockIdx.x * FORCE_ROWS + threadIdx.x / FORCE_SPLIT;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  if (row < ni) {
    xi = pos_i[3 * row];
    yi = pos_i[3 * row + 1];
    zi = pos_i[3 * row + 2];
  }
  float ax = 0.f, ay = 0.f, az = 0.f;
  for (int base = 0; base < nj; base += FORCE_TILE) {
    const int j = base + threadIdx.x;
    tile[threadIdx.x] = j < nj ? src[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    pull_tile(tile, lane, xi, yi, zi, eps2, ax, ay, az);
    __syncthreads();
  }
  finish(ax, ay, az, lane, row < ni, g, acc + 3 * (size_t)row);
}

// ------------------------------------------------ B1, near-list form
//
// Replaces the near pass of nbody_tpu/ops/treeforce.py (bh, bh2: :484-489;
// bh3: :1081-1085), where jax.vmap(pallas_partial_accelerations) runs B1 once
// per receiver block over its gathered candidates. Here one launch covers all
// receiver blocks: group g's `rows` targets (rows g * rows .. of q) see the
// `list` source blocks near[g, :], each `src_block` consecutive rows of the
// packed sources, read by id (no gathered (groups, list * src_block) copy).
// Candidate c of a group is row c % src_block of block near[g, c / src_block],
// and a target's sum runs over c in order, as B1's runs over its sources: the
// same pair function, tile, lane split and butterfly, so the result is what
// the vmapped B1 computes on the gathered candidates. An id outside
// [0, n_src_blocks) reads as a zero-mass source. Bound: FP32 throughput,
// ~20 flops and one MUFU rsqrt per pair, as B1.
__global__ void __launch_bounds__(FORCE_THREADS)
near_force_kernel(const float* __restrict__ q, const float4* __restrict__ src,
                  const int* __restrict__ near, int rows, int list, int src_block,
                  int n_src_blocks, int tiles, float g, float eps2,
                  float* __restrict__ acc) {
  __shared__ float4 tile[FORCE_TILE];
  const int grp = blockIdx.x / tiles;
  const int lane = threadIdx.x % FORCE_SPLIT;
  const int row = (blockIdx.x % tiles) * FORCE_ROWS + threadIdx.x / FORCE_SPLIT;
  const size_t qrow = (size_t)grp * rows + row;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  if (row < rows) {
    xi = q[3 * qrow];
    yi = q[3 * qrow + 1];
    zi = q[3 * qrow + 2];
  }
  const int* ids = near + (size_t)grp * list;
  const int ncand = list * src_block;
  float ax = 0.f, ay = 0.f, az = 0.f;
  for (int base = 0; base < ncand; base += FORCE_TILE) {
    const int c = base + threadIdx.x;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < ncand) {
      const int j = ids[c / src_block];
      if (j >= 0 && j < n_src_blocks) s = src[(size_t)j * src_block + c % src_block];
    }
    tile[threadIdx.x] = s;
    __syncthreads();
    pull_tile(tile, lane, xi, yi, zi, eps2, ax, ay, az);
    __syncthreads();
  }
  finish(ax, ay, az, lane, row < rows, g, acc + 3 * qrow);
}

// --------------------------------------------------------------- B2: energy
//
// Replaces nbody_tpu/ops/pairwise.py::_energy_kernel (Pallas, TPU):
//
//   U = -G * sum_{pairs} m_i m_j / max(|r_i - r_j| + eps, 1e-30)
//
// eps is added to the distance, not in quadrature, as the reference does.
// masked != 0: one set (targets == sources), strict upper triangle on global
// indices, so each unordered pair counts once. masked == 0: every (i, j) pair
// of two disjoint sets (the cross term of a block-triangle decomposition).
//
// What bounds it: FP32 issue again, now about 25-30 instructions per pair: an
// IEEE sqrtf and an IEEE division each expand to a MUFU approximation plus
// Newton fix-ups. Memory traffic is one float4 per source per block.
//
// Design: a 2-D grid of (ENERGY_ROWS x ENERGY_TILE) tiles, one target per
// thread. In the masked variant a tile wholly on or below the diagonal writes
// a zero partial and returns before any arithmetic, which halves the work.
// Each thread sums m_j / d over its tile in f32; the block reduces m_i * sum
// over its threads in f64 with a fixed tree, and writes one partial per tile.
// A second kernel of one block reduces the partials in f64, in a fixed order.
// No float atomics anywhere, so the result is the same on every run.
constexpr int ENERGY_ROWS = 256;
constexpr int ENERGY_TILE = 256;
constexpr int REDUCE_THREADS = 1024;
constexpr float DIST_FLOOR = 1e-30f;

__global__ void __launch_bounds__(ENERGY_ROWS)
energy_partials_kernel(const float* __restrict__ pos_i,
                       const float* __restrict__ mass_i, int ni,
                       const float4* __restrict__ src, int nj, float eps,
                       int masked, double* __restrict__ partials) {
  __shared__ float4 tile[ENERGY_TILE];
  __shared__ double red[ENERGY_ROWS];
  const int row0 = blockIdx.x * ENERGY_ROWS;
  const int col0 = blockIdx.y * ENERGY_TILE;
  double* out = partials + (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  if (masked && col0 + ENERGY_TILE - 1 <= row0) {
    // every pair of this tile has col <= row: nothing above the diagonal
    if (threadIdx.x == 0) *out = 0.0;
    return;
  }
  const int j = col0 + threadIdx.x;
  tile[threadIdx.x] = j < nj ? src[j] : make_float4(0.f, 0.f, 0.f, 0.f);
  const int row = row0 + threadIdx.x;
  float xi = 0.f, yi = 0.f, zi = 0.f, mi = 0.f;
  if (row < ni) {
    xi = pos_i[3 * row];
    yi = pos_i[3 * row + 1];
    zi = pos_i[3 * row + 2];
    mi = mass_i[row];
  }
  __syncthreads();
  float s = 0.f;
  for (int t = 0; t < ENERGY_TILE; ++t) {
    const float4 q = tile[t];
    const float dx = q.x - xi;
    const float dy = q.y - yi;
    const float dz = q.z - zi;
    const float dist =
        fmaxf(sqrtf(fmaf(dx, dx, fmaf(dy, dy, dz * dz))) + eps, DIST_FLOOR);
    const float term = q.w / dist;
    if (!masked || col0 + t > row) s += term;
  }
  red[threadIdx.x] = (double)mi * (double)s;
  __syncthreads();
  for (int w = ENERGY_ROWS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = -red[0];
}

__global__ void __launch_bounds__(REDUCE_THREADS)
reduce_kernel(const double* __restrict__ partials, long long n,
              double* __restrict__ out) {
  __shared__ double red[REDUCE_THREADS];
  double s = 0.0;
  for (long long k = threadIdx.x; k < n; k += REDUCE_THREADS) s += partials[k];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int w = REDUCE_THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = red[0];
}

long long energy_grid(int ni, int nj, dim3* grid) {
  const unsigned gx = (unsigned)((ni + ENERGY_ROWS - 1) / ENERGY_ROWS);
  const unsigned gy = (unsigned)((nj + ENERGY_TILE - 1) / ENERGY_TILE);
  if (grid) *grid = dim3(gx, gy);
  return (long long)gx * gy;
}

}  // namespace

extern "C" {

// acc (ni, 3) = forces on pos_i (ni, 3) from the packed sources src (nj float4).
int nbody_force(const float* pos_i, const void* src, int ni, int nj, float g,
                float eps, float* acc, void* stream) {
  if (ni <= 0 || nj < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((ni + FORCE_ROWS - 1) / FORCE_ROWS);
  force_kernel<<<grid, FORCE_THREADS, 0, (cudaStream_t)stream>>>(
      pos_i, (const float4*)src, ni, nj, g, eps * eps, acc);
  return (int)cudaGetLastError();
}

// acc (groups, rows, 3) = forces on q (groups, rows, 3) from the source
// blocks near[g, :] (groups, list) of the packed sources src
// (n_src_blocks * src_block float4), for every group g.
int nbody_near_force(const float* q, const void* src, const int* near, int groups,
                     int rows, int list, int src_block, int n_src_blocks, float g,
                     float eps, float* acc, void* stream) {
  if (groups <= 0 || rows <= 0 || list < 0 || src_block <= 0 || n_src_blocks < 0 ||
      (long long)list * src_block > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int tiles = (rows + FORCE_ROWS - 1) / FORCE_ROWS;
  if ((long long)groups * tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  near_force_kernel<<<groups * tiles, FORCE_THREADS, 0, (cudaStream_t)stream>>>(
      q, (const float4*)src, near, rows, list, src_block, n_src_blocks, tiles, g,
      eps * eps, acc);
  return (int)cudaGetLastError();
}

// Number of f64 partials nbody_energy needs as scratch for (ni, nj).
long long nbody_energy_num_partials(int ni, int nj) {
  return energy_grid(ni, nj, nullptr);
}

// *out (one f64) = -sum m_i m_j / max(d + eps, 1e-30), without the factor G.
int nbody_energy(const float* pos_i, const float* mass_i, int ni,
                 const void* src, int nj, float eps, int masked,
                 double* partials, long long n_partials, double* out,
                 void* stream) {
  dim3 grid;
  if (ni <= 0 || nj <= 0 || n_partials != energy_grid(ni, nj, &grid) ||
      grid.y > 65535u)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  energy_partials_kernel<<<grid, ENERGY_ROWS, 0, s>>>(
      pos_i, mass_i, ni, (const float4*)src, nj, eps, masked, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_kernel<<<1, REDUCE_THREADS, 0, s>>>(partials, n_partials, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
