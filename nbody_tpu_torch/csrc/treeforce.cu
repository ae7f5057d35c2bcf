// Block-multipole far field of the treecodes for Hopper (sm_90a): B9, the
// pull of every block of a table on every receiver, and B10, the pull of a
// per-group list of blocks on that group's receivers. Plain C interface bound
// from Python by ctypes (nbody_tpu_torch/ops/build.py,
// nbody_tpu_torch/ops/treeforce.py).
//
// Every entry point launches on the caller's stream, does not synchronise and
// allocates nothing. Each returns cudaGetLastError() after its launch, so a
// launch the device refuses is reported to the wrapper, which raises.
//
// A block is one row of a (K, 10) float32 table:
//   [com_x, com_y, com_z, msum, Qxx, Qyy, Qzz, Qxy, Qxz, Qyz]
// (centre of mass, mass, traceless quadrupole about the centre of mass).
// Receivers are (P, 3) row-major positions. The pull of one block on one
// receiver at r = q - com, s^2 = |r|^2 + eps^2 floored at 1e-10, is
//
//   a = G [ -m r / s^3 + Q r / s^5 - 2.5 (r^T Q r) r / s^7 ].
//
// A zero-mass, zero-Q row (padding, an empty block) adds an exact zero.
//
// Replaces nbody_tpu/ops/treeforce.py::_multipole_kernel (B9) and
// ::_grouped_multipole_kernel (B10), Pallas on a TPU, whose shared body
// _multipole_tile is the formula above. The TPU kernels take receivers as
// (3, P) coordinate planes, a layout workaround for the TPU's (8, 128)
// operand tiling; here receivers stay (P, 3).
//
// What bounds both: FP32 throughput. Per receiver-block pair about 45 flops
// (the JAX cost estimate) and one MUFU rsqrt; the bytes are a few per pair,
// since every staged block row serves all receivers of the thread block.
//
// Design: MP_ROWS receivers per thread block, MP_SPLIT lanes per receiver.
// The block stages up to MP_TILE table rows in shared memory; lane s of a
// receiver takes every MP_SPLIT-th staged row, in table (or list) order, and
// the lanes' partial sums meet in a fixed butterfly of warp shuffles. So each
// receiver's sum has one order on every run: deterministic, no atomics. B10
// gathers its group's rows by id into the same tile (one row per thread), so
// no (G, S, 10) gathered copy exists in device memory. Full FP32, no tensor
// cores: the near pass subtracts exactly this expansion for the near blocks,
// and the two must cancel at rounding level.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int ROW = 10;  // floats per block row
constexpr int MP_ROWS = 64;
constexpr int MP_SPLIT = 4;
constexpr int MP_THREADS = MP_ROWS * MP_SPLIT;
constexpr int MP_TILE = MP_THREADS;  // rows staged per pass (10 KB)
constexpr float MP_D2_FLOOR = 1e-10f;

static_assert(32 % MP_SPLIT == 0, "a receiver's lanes must share a warp");

// The one copy of the expansion, shared by B9 and B10: adds the pull of the
// block row b on the receiver (qx, qy, qz), without the factor G.
__device__ __forceinline__ void multipole_pull(const float* b, float qx, float qy,
                                               float qz, float eps2, float& ax,
                                               float& ay, float& az) {
  const float rx = qx - b[0];
  const float ry = qy - b[1];
  const float rz = qz - b[2];
  const float s2 = rx * rx + ry * ry + rz * rz + eps2;
  const float inv = rsqrtf(fmaxf(s2, MP_D2_FLOOR));
  const float inv2 = inv * inv;
  const float inv3 = inv * inv2;
  const float inv5 = inv3 * inv2;
  const float inv7 = inv5 * inv2;
  const float qrx = b[4] * rx + b[7] * ry + b[8] * rz;
  const float qry = b[7] * rx + b[5] * ry + b[9] * rz;
  const float qrz = b[8] * rx + b[9] * ry + b[6] * rz;
  const float rqr = qrx * rx + qry * ry + qrz * rz;
  const float cr = -b[3] * inv3 - 2.5f * rqr * inv7;  // radial coefficient
  ax += cr * rx + inv5 * qrx;
  ay += cr * ry + inv5 * qry;
  az += cr * rz + inv5 * qrz;
}

// The n staged rows on this thread's receiver, then the butterfly.
__device__ __forceinline__ void pull_tile(const float* tile, int n, int lane,
                                          float qx, float qy, float qz,
                                          float eps2, float& ax, float& ay,
                                          float& az) {
  for (int t = lane; t < n; t += MP_SPLIT)
    multipole_pull(tile + t * ROW, qx, qy, qz, eps2, ax, ay, az);
}

__device__ __forceinline__ void finish(float ax, float ay, float az, int lane,
                                       bool live, float g, float* out) {
  for (int off = MP_SPLIT / 2; off > 0; off >>= 1) {
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

// ------------------------------------------------------------ B9: far field
__global__ void __launch_bounds__(MP_THREADS)
multipole_far_kernel(const float* __restrict__ q, const float* __restrict__ table,
                     int p, int k, float g, float eps2, float* __restrict__ acc) {
  __shared__ float tile[MP_TILE * ROW];
  const int lane = threadIdx.x % MP_SPLIT;
  const int row = blockIdx.x * MP_ROWS + threadIdx.x / MP_SPLIT;
  const bool live = row < p;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    qx = q[3 * (size_t)row];
    qy = q[3 * (size_t)row + 1];
    qz = q[3 * (size_t)row + 2];
  }
  float ax = 0.f, ay = 0.f, az = 0.f;
  for (int base = 0; base < k; base += MP_TILE) {
    const int n = min(MP_TILE, k - base);
    const float* src = table + (size_t)base * ROW;
    for (int i = threadIdx.x; i < n * ROW; i += MP_THREADS) tile[i] = src[i];
    __syncthreads();
    pull_tile(tile, n, lane, qx, qy, qz, eps2, ax, ay, az);
    __syncthreads();
  }
  finish(ax, ay, az, lane, live, g, acc + 3 * (size_t)row);
}

// ---------------------------------------------------------- B10: per group
// Receivers of group gr are rows gr * p .. gr * p + p - 1 of q; they see the
// s rows ids[gr, :] of the table. An id outside [0, k) reads as a zero row.
__global__ void __launch_bounds__(MP_THREADS)
multipole_grouped_kernel(const float* __restrict__ q, const float* __restrict__ table,
                         const int* __restrict__ ids, int p, int s, int k,
                         int tiles, float g, float eps2, float* __restrict__ acc) {
  __shared__ float tile[MP_TILE * ROW];
  const int grp = blockIdx.x / tiles;
  const int lane = threadIdx.x % MP_SPLIT;
  const int row = (blockIdx.x % tiles) * MP_ROWS + threadIdx.x / MP_SPLIT;
  const bool live = row < p;
  const size_t qrow = (size_t)grp * p + row;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    qx = q[3 * qrow];
    qy = q[3 * qrow + 1];
    qz = q[3 * qrow + 2];
  }
  const int* list = ids + (size_t)grp * s;
  float ax = 0.f, ay = 0.f, az = 0.f;
  for (int base = 0; base < s; base += MP_TILE) {
    const int n = min(MP_TILE, s - base);
    if (threadIdx.x < n) {
      const int j = list[base + threadIdx.x];
      float* dst = tile + threadIdx.x * ROW;
      if (j >= 0 && j < k) {
        const float* src = table + (size_t)j * ROW;
#pragma unroll
        for (int c = 0; c < ROW; ++c) dst[c] = src[c];
      } else {
#pragma unroll
        for (int c = 0; c < ROW; ++c) dst[c] = 0.f;
      }
    }
    __syncthreads();
    pull_tile(tile, n, lane, qx, qy, qz, eps2, ax, ay, az);
    __syncthreads();
  }
  finish(ax, ay, az, lane, live, g, acc + 3 * qrow);
}

}  // namespace

extern "C" {

// acc (p, 3) = pull of all k rows of table (k, 10) on q (p, 3).
int multipole_far(const float* q, const float* table, int p, int k, float g,
                  float eps2, float* acc, void* stream) {
  if (p <= 0 || k < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((p + MP_ROWS - 1) / MP_ROWS);
  multipole_far_kernel<<<grid, MP_THREADS, 0, (cudaStream_t)stream>>>(
      q, table, p, k, g, eps2, acc);
  return (int)cudaGetLastError();
}

// acc (groups, p, 3) = pull of table rows ids[gr, :] (s of them) on the p
// receivers q[gr] (groups, p, 3), for every group gr.
int multipole_grouped(const float* q, const float* table, const int* ids,
                      int groups, int p, int s, int k, float g, float eps2,
                      float* acc, void* stream) {
  if (groups <= 0 || p <= 0 || s < 0 || k < 0) return (int)cudaErrorInvalidValue;
  const int tiles = (p + MP_ROWS - 1) / MP_ROWS;
  if ((long long)groups * tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  multipole_grouped_kernel<<<groups * tiles, MP_THREADS, 0, (cudaStream_t)stream>>>(
      q, table, ids, p, s, k, tiles, g, eps2, acc);
  return (int)cudaGetLastError();
}

}  // extern "C"
