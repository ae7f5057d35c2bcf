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
// 3 FMAs for d2, the floor's max, one MUFU rsqrt, 3 multiplies for w and
// 3 FMAs into the accumulators: about 14 instructions (~20 flops), every one
// an issue slot of its warp scheduler. Global memory is not a limit: each
// source is read once per block into shared memory and then used by all of
// the block's rows.
//
// Design: FORCE_ROWS targets per block, SPLIT threads per group of TPT
// targets, the TPT targets in registers. The block stages TILE sources in
// shared memory (one float4 per thread); lane s of a group takes every
// SPLIT-th source of the tile, so the SPLIT lanes read SPLIT consecutive
// float4s (one 128-byte shared-memory wavefront, broadcast to the other
// groups of the warp), and one load feeds TPT pairs. The rsqrt is
// rsqrt.approx.ftz: d2 >= 1e-18 is never subnormal, so it gives rsqrtf's
// value without rsqrtf's guard for subnormal inputs (three instructions a
// pair). Coordinate differences are exact (no |a|^2 + |b|^2 - 2ab
// expansion) and there are no tensor cores: the TPU kernel's matrix-unit form
// lost ~1e-4 relative accuracy to cancellation (nbody_tpu/ops/pairwise.py:
// 93-96).
//
// Summation order, as the reference's (nbody_tpu/ops/pairwise.py:97-106: a
// tile's sum, then the running total): each thread sums its TILE / SPLIT
// sources of a tile into fresh accumulators and adds that partial to its
// running total; the SPLIT lanes' totals meet in a fixed butterfly of warp
// shuffles. So a float32 chain adds TILE / SPLIT pairs or one partial a tile
// (3,907 at 10^6 sources, fewer in chunks): one chain over a lane's 125,000
// sources of 10^6 drifts ~1e-4 of max |a| from the float64 sum, over the
// 2e-5 bar (tests/test_forces.py:56,65).
//
// Sources split over blocks: where the target tiles alone leave the card
// short of blocks (few targets, as the 4096 audit receivers over 1M
// sources), the wrapper cuts the sources into `chunk`-sized pieces
// (ops/pairwise.py, force_chunk): grid (target tiles, chunks), each block
// writes its chunk's partial sums, and force_chunks_kernel adds them in chunk
// order and scales by G. One chunk: the first kernel writes G * a itself,
// one launch (every N <= 500 shape of the datagen). No float atomics: the
// same bits on every run.
constexpr int SPLIT = 8;                        // lanes a target group
constexpr int FORCE_THREADS = 256;
constexpr int TILE = FORCE_THREADS;             // sources staged a step
constexpr int GROUPS = FORCE_THREADS / SPLIT;   // target groups a block
constexpr int TPT = 4;                          // B1: targets a group (a thread)
constexpr int FORCE_ROWS = GROUPS * TPT;        // B1: targets a block
constexpr int NEAR_ROWS = GROUPS;               // near list: one target a group
constexpr int SUM_THREADS = 256;
constexpr float D2_FLOOR = 1e-18f;

static_assert(32 % SPLIT == 0, "a group's lanes must share a warp");

__device__ __forceinline__ float rsqrt_ftz(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The one pair of both forms of B1: the source s = [x, y, z, m] pulls the
// target (xi, yi, zi); adds m (r_s - r_i) / max(|r_s - r_i|^2 + eps^2,
// 1e-18)^{3/2}, without the factor G.
__device__ __forceinline__ void pair_pull(const float4 s, float xi, float yi,
                                          float zi, float eps2, float& ax,
                                          float& ay, float& az) {
  const float dx = s.x - xi;
  const float dy = s.y - yi;
  const float dz = s.z - zi;
  const float d2 = fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, eps2)));
  const float inv = rsqrt_ftz(fmaxf(d2, D2_FLOOR));
  const float w = s.w * inv * inv * inv;
  ax = fmaf(w, dx, ax);
  ay = fmaf(w, dy, ay);
  az = fmaf(w, dz, az);
}

// The lanes' sums in a fixed butterfly: every lane ends with the same bits.
__device__ __forceinline__ void lane_sum(float& ax, float& ay, float& az) {
#pragma unroll
  for (int off = SPLIT / 2; off > 0; off >>= 1) {
    ax += __shfl_xor_sync(0xffffffffu, ax, off);
    ay += __shfl_xor_sync(0xffffffffu, ay, off);
    az += __shfl_xor_sync(0xffffffffu, az, off);
  }
}

// Block (tile x, chunk y): targets x * FORCE_ROWS .. of pos_i against the
// sources y * chunk .. min(nj, (y + 1) * chunk). One chunk: out = G * a
// (ni, 3); several: out = chunk y's sum, unscaled, at (y * ni + i) * 3.
__global__ void __launch_bounds__(FORCE_THREADS)
force_kernel(const float* __restrict__ pos_i, const float4* __restrict__ src,
             int ni, int nj, int chunk, float g, float eps2, float* __restrict__ out) {
  __shared__ float4 tile[TILE];
  const int lane = threadIdx.x % SPLIT;
  const int row0 = blockIdx.x * FORCE_ROWS + (threadIdx.x / SPLIT) * TPT;
  float xi[TPT], yi[TPT], zi[TPT], ax[TPT], ay[TPT], az[TPT];
#pragma unroll
  for (int u = 0; u < TPT; ++u) {
    const int r = row0 + u;
    xi[u] = r < ni ? pos_i[3 * (size_t)r] : 0.f;
    yi[u] = r < ni ? pos_i[3 * (size_t)r + 1] : 0.f;
    zi[u] = r < ni ? pos_i[3 * (size_t)r + 2] : 0.f;
    ax[u] = ay[u] = az[u] = 0.f;
  }
  const int j0 = blockIdx.y * chunk;
  const int j1 = min(nj, j0 + chunk);
  for (int base = j0; base < j1; base += TILE) {
    const int j = base + threadIdx.x;
    tile[threadIdx.x] = j < j1 ? src[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    float px[TPT], py[TPT], pz[TPT];  // this tile's partial
#pragma unroll
    for (int u = 0; u < TPT; ++u) px[u] = py[u] = pz[u] = 0.f;
#pragma unroll 8
    for (int t = lane; t < TILE; t += SPLIT) {
      const float4 s = tile[t];
#pragma unroll
      for (int u = 0; u < TPT; ++u)
        pair_pull(s, xi[u], yi[u], zi[u], eps2, px[u], py[u], pz[u]);
    }
#pragma unroll
    for (int u = 0; u < TPT; ++u) {
      ax[u] += px[u];
      ay[u] += py[u];
      az[u] += pz[u];
    }
    __syncthreads();
  }
  const bool one = gridDim.y == 1;
  const float scale = one ? g : 1.f;
  float* dst = out + (one ? 0 : (size_t)blockIdx.y * ni * 3);
#pragma unroll
  for (int u = 0; u < TPT; ++u) {
    lane_sum(ax[u], ay[u], az[u]);
    const int r = row0 + u;
    if (lane == u && r < ni) {  // every lane has the sums: TPT lanes write
      dst[3 * (size_t)r] = scale * ax[u];
      dst[3 * (size_t)r + 1] = scale * ay[u];
      dst[3 * (size_t)r + 2] = scale * az[u];
    }
  }
}

// acc (n floats) = G * the chunks' partial sums (chunks, n), added in chunk
// order.
__global__ void __launch_bounds__(SUM_THREADS)
force_chunks_kernel(const float* __restrict__ part, int chunks, long long n, float g,
                    float* __restrict__ acc) {
  const long long i = (long long)blockIdx.x * SUM_THREADS + threadIdx.x;
  if (i >= n) return;
  float s = part[i];
  for (int c = 1; c < chunks; ++c) s += part[(size_t)c * n + i];
  acc[i] = g * s;
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
// and a target's sum runs over c in order: B1's pair function (with the
// floor), tile, lane split and butterfly, one target a lane group, each lane
// summing its share of a list (a few thousand candidates) in one running
// total. An id outside [0, n_src_blocks) reads as a zero-mass source. Bound:
// FP32 throughput, ~20 flops and one MUFU rsqrt per pair, as B1.
__global__ void __launch_bounds__(FORCE_THREADS)
near_force_kernel(const float* __restrict__ q, const float4* __restrict__ src,
                  const int* __restrict__ near, int rows, int list, int src_block,
                  int n_src_blocks, int tiles, float g, float eps2,
                  float* __restrict__ acc) {
  __shared__ float4 tile[TILE];
  const int grp = blockIdx.x / tiles;
  const int lane = threadIdx.x % SPLIT;
  const int row = (blockIdx.x % tiles) * NEAR_ROWS + threadIdx.x / SPLIT;
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
  for (int base = 0; base < ncand; base += TILE) {
    const int c = base + threadIdx.x;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < ncand) {
      const int j = ids[c / src_block];
      if (j >= 0 && j < n_src_blocks) s = src[(size_t)j * src_block + c % src_block];
    }
    tile[threadIdx.x] = s;
    __syncthreads();
#pragma unroll 8
    for (int t = lane; t < TILE; t += SPLIT)
      pair_pull(tile[t], xi, yi, zi, eps2, ax, ay, az);
    __syncthreads();
  }
  lane_sum(ax, ay, az);
  if (lane == 0 && row < rows) {
    acc[3 * qrow] = g * ax;
    acc[3 * qrow + 1] = g * ay;
    acc[3 * qrow + 2] = g * az;
  }
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

// acc (ni, 3) = forces on pos_i (ni, 3) from the packed sources src (nj
// float4), the sources cut into chunks of `chunk` (a multiple of the tile, or
// >= nj for one chunk). Several chunks need `partial`, (chunks, ni, 3) floats
// of scratch, and a second launch that adds them in chunk order.
int nbody_force(const float* pos_i, const void* src, int ni, int nj, int chunk, float g,
                float eps, float* partial, float* acc, void* stream) {
  if (ni <= 0 || nj < 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
  const long long chunks = nj > chunk ? ((long long)nj + chunk - 1) / chunk : 1;
  if (chunks > 1 && (chunk % TILE != 0 || partial == nullptr || chunks > 65535))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((ni + FORCE_ROWS - 1) / FORCE_ROWS, (unsigned)chunks);
  const cudaStream_t s = (cudaStream_t)stream;
  force_kernel<<<grid, FORCE_THREADS, 0, s>>>(pos_i, (const float4*)src, ni, nj, chunk, g,
                                              eps * eps, chunks > 1 ? partial : acc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return (int)err;
  const long long n = 3LL * ni;
  force_chunks_kernel<<<(unsigned)((n + SUM_THREADS - 1) / SUM_THREADS), SUM_THREADS, 0, s>>>(
      partial, (int)chunks, n, g, acc);
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
  const int tiles = (rows + NEAR_ROWS - 1) / NEAR_ROWS;
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
