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
// What bounds both: FP32 issue. multipole_pull compiles to 37 instructions
// a (receiver, block) pair (45 flops, the JAX cost estimate; one MUFU
// rsqrt; the sum's order leaves nine for the three accumulations and four
// for s^2), few of them FMAs, so the SM's issue rate (4 schedulers x 32
// lanes a clock), and not the FP32 peak of the bound, is the floor: 0.85 ms
// for the 1M bh3 refinement's 7.7e8 pairs at 1.98 GHz, against 0.52 ms at
// 67 TFLOP/s. The bytes are a few a pair, since every staged block row
// serves all receivers of the thread block.
//
// Staged layout, both kernels: a row is three float4s in shared memory
// (ROW_PAD floats, the last two zero), so a lane reads it with three 16-byte
// loads and rows 48 bytes apart fall on distinct banks for any 8 lanes.
// Rows are copied from device memory by consecutive threads, float by float.
// The rsqrt is rsqrt.approx.ftz: s^2 >= 1e-10 is never subnormal, so it
// gives rsqrtf's value without rsqrtf's subnormal guard.
//
// Both kernels run one receiver loop (pull_receivers): MP_RPT receivers a
// thread, `LANES` lanes a receiver group (4, or 8 for groups under 256
// receivers: a template argument the wrapper picks from the group size,
// ops/treeforce.py::grouped_plan), so one shared-memory read of a row feeds
// MP_RPT pulls and a block holds MP_THREADS / LANES * MP_RPT receivers of
// one group; the lanes' sums meet in a fixed butterfly of warp shuffles.
// B9 is that loop over one group, all P receivers, and the table's rows in
// order (no id list): 256 receivers a block, 391 blocks at 100k bodies (one
// wave at 3 blocks an SM), 3,907 at 1M. At 4 lanes lane s takes staged rows
// s, s + 4, ... of each tile, the order of the one-receiver-a-thread B9
// this replaces, and B9 equals B10 given the list 0 .. K - 1 bit for bit.
// Its bits differ from that kernel's in about one element in 10^3 (by under
// 1e-10 of max |a|): the compiler fused the radial coefficient's monopole
// product into an FMA in the four-receiver loop and its quadrupole product
// in the one-receiver loop; B9 and B10 now fuse it alike. B10: 256
// receivers a block for the 2048-receiver groups of the bh3 refinement (8
// blocks stage a group's list), 128 for the 128-receiver groups of bh3's
// near pass (one block a group). A B10 block stages a tile's ids first (one
// a thread, an id outside [0, k) as -1), then copies the rows. No (G, S, 10)
// gathered copy exists in device memory. B9 keeps a kernel of its own name
// (multipole_far_kernel), which a profiler tells from B10's.
//
// Scenes: a group of S scenes of equal shape (a treecode scene group:
// jax.vmap of the whole rollout in nbody_tpu/data/generate.py:216-262 puts a
// scene axis on both Pallas calls) is one launch of either kernel, the scene
// on blockIdx.y and q, table, ids and acc offset by the scene. An id is
// checked against its own scene's k, so an id outside [0, k) still reads as
// a zero row and never as a row of the next scene. Each scene keeps the
// launch plan of a call on it alone (grouped_plan depends on p only), so
// scene s gets the bits of that call.
//
// Each receiver's sum has one order on every run: deterministic, no atomics.
// Full FP32, no tensor cores: the near pass subtracts exactly this expansion
// for the near blocks, and the two must cancel at rounding level.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int ROW = 10;      // floats of a table row
constexpr int ROW_PAD = 12;  // floats of a staged row: three float4s
constexpr int MP_THREADS = 256;
constexpr int MP_TILE = 256;  // rows staged a pass (12 KiB)
constexpr int MP_RPT = 4;     // receivers a thread
// blocks an SM the registers must allow (at most 85 a thread). With a
// launch bound of threads alone the compiler held 64 registers and spilled.
constexpr int MP_BLOCKS_PER_SM = 3;
constexpr float MP_D2_FLOOR = 1e-10f;

static_assert(MP_TILE <= MP_THREADS, "one thread stages one id");

__device__ __forceinline__ float rsqrt_ftz(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The one copy of the expansion, shared by B9 and B10: adds the pull of the
// staged block row (b0, b1, b2) = ([com, m], [Qxx, Qyy, Qzz, Qxy], [Qxz,
// Qyz, 0, 0]) on the receiver (qx, qy, qz), without the factor G, in
// _multipole_tile's order.
__device__ __forceinline__ void multipole_pull(const float4 b0, const float4 b1,
                                               const float4 b2, float qx, float qy,
                                               float qz, float eps2, float& ax,
                                               float& ay, float& az) {
  const float rx = qx - b0.x;
  const float ry = qy - b0.y;
  const float rz = qz - b0.z;
  const float s2 = rx * rx + ry * ry + rz * rz + eps2;
  const float inv = rsqrt_ftz(fmaxf(s2, MP_D2_FLOOR));
  const float inv2 = inv * inv;
  const float inv3 = inv * inv2;
  const float inv5 = inv3 * inv2;
  const float inv7 = inv5 * inv2;
  const float qrx = b1.x * rx + b1.w * ry + b2.x * rz;
  const float qry = b1.w * rx + b1.y * ry + b2.y * rz;
  const float qrz = b2.x * rx + b2.y * ry + b1.z * rz;
  const float rqr = qrx * rx + qry * ry + qrz * rz;
  const float cr = -b0.w * inv3 - 2.5f * rqr * inv7;  // radial coefficient
  ax += cr * rx + inv5 * qrx;
  ay += cr * ry + inv5 * qry;
  az += cr * rz + inv5 * qrz;
}

// Copies n table rows into the staged layout: staged row t is table row
// sid[t] (zeros where that is negative) or, without sid, row base + t;
// consecutive threads copy consecutive floats.
__device__ __forceinline__ void stage_rows(float4* tile, const float* __restrict__ table,
                                           int n, const int* sid, int base) {
  float* dst = reinterpret_cast<float*>(tile);
  for (int f = threadIdx.x; f < n * ROW_PAD; f += MP_THREADS) {
    const int t = f / ROW_PAD, c = f % ROW_PAD;
    const int j = sid ? sid[t] : base + t;
    dst[f] = c < ROW && j >= 0 ? table[(size_t)j * ROW + c] : 0.f;
  }
}

// The lanes' sums in a fixed butterfly over LANES lanes.
template <int LANES>
__device__ __forceinline__ void lane_sum(float& ax, float& ay, float& az) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1) {
    ax += __shfl_xor_sync(0xffffffffu, ax, off);
    ay += __shfl_xor_sync(0xffffffffu, ay, off);
    az += __shfl_xor_sync(0xffffffffu, az, off);
  }
}

// ------------------------------------------------- B9 and B10: one body
// The receiver loop of both kernels, for MP_THREADS / LANES * MP_RPT
// receivers of one group, r0 the first of this thread's MP_RPT: rows of q
// from qg, forces to out, both holding the group's p receivers. LISTED
// (B10): the group sees the s table rows list[0 .. s), an id outside [0, k)
// read as a zero row; else (B9): table rows 0 .. s. Lane `lane` of a
// receiver group takes staged rows lane, lane + LANES, ... of each tile, so
// a receiver's sum has one order for a given LANES, with or without a list.
template <int LANES, bool LISTED>
__device__ __forceinline__ void pull_receivers(const float* __restrict__ qg,
                                               const float* __restrict__ table,
                                               const int* __restrict__ list, int p, int s,
                                               int k, int r0, int lane, float g, float eps2,
                                               float* __restrict__ out) {
  static_assert(32 % LANES == 0, "a receiver group's lanes must share a warp");
  __shared__ float4 tile[MP_TILE * 3];
  float qx[MP_RPT], qy[MP_RPT], qz[MP_RPT], ax[MP_RPT], ay[MP_RPT], az[MP_RPT];
#pragma unroll
  for (int u = 0; u < MP_RPT; ++u) {
    const int r = r0 + u;
    qx[u] = r < p ? qg[3 * (size_t)r] : 0.f;
    qy[u] = r < p ? qg[3 * (size_t)r + 1] : 0.f;
    qz[u] = r < p ? qg[3 * (size_t)r + 2] : 0.f;
    ax[u] = ay[u] = az[u] = 0.f;
  }
  for (int base = 0; base < s; base += MP_TILE) {
    const int n = min(MP_TILE, s - base);
    if constexpr (LISTED) {
      __shared__ int sid[MP_TILE];
      if ((int)threadIdx.x < n) {
        const int j = list[base + threadIdx.x];
        sid[threadIdx.x] = j >= 0 && j < k ? j : -1;
      }
      __syncthreads();
      stage_rows(tile, table, n, sid, 0);
    } else {
      stage_rows(tile, table, n, nullptr, base);
    }
    __syncthreads();
#pragma unroll 1
    for (int t = lane; t < n; t += LANES) {
      const float4 b0 = tile[3 * t], b1 = tile[3 * t + 1], b2 = tile[3 * t + 2];
#pragma unroll
      for (int u = 0; u < MP_RPT; ++u)
        multipole_pull(b0, b1, b2, qx[u], qy[u], qz[u], eps2, ax[u], ay[u], az[u]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < MP_RPT; ++u) {
    lane_sum<LANES>(ax[u], ay[u], az[u]);
    const int r = r0 + u;
    if (lane == u % LANES && r < p) {
      out[3 * (size_t)r] = g * ax[u];
      out[3 * (size_t)r + 1] = g * ay[u];
      out[3 * (size_t)r + 2] = g * az[u];
    }
  }
}

// B9: the pull of table rows 0 .. k on the p receivers of q; block (x, y)
// holds receivers x * RECV .. of scene y, whose q, table and acc follow the
// scenes before it. A kernel of its own name, so that a profiler tells B9's
// time from B10's.
template <int LANES>
__global__ void __launch_bounds__(MP_THREADS, MP_BLOCKS_PER_SM)
multipole_far_kernel(const float* __restrict__ q, const float* __restrict__ table, int p,
                     int k, float g, float eps2, float* __restrict__ acc) {
  constexpr int RECV = MP_THREADS / LANES * MP_RPT;
  const size_t scene = blockIdx.y;
  const int r0 = blockIdx.x * RECV + (threadIdx.x / LANES) * MP_RPT;
  pull_receivers<LANES, false>(q + scene * p * 3, table + scene * k * ROW, nullptr, p, k, k,
                               r0, threadIdx.x % LANES, g, eps2, acc + scene * p * 3);
}

// B10: receivers of group gr of scene y are rows gr * p .. gr * p + p - 1 of
// that scene's q; they see the s rows ids[y, gr, :] of that scene's table
// (an id is checked against the scene's own k). Block (x, y) holds
// receivers (x % tiles) * RECV .. of group x / tiles of scene y.
template <int LANES>
__global__ void __launch_bounds__(MP_THREADS, MP_BLOCKS_PER_SM)
multipole_grouped_kernel(const float* __restrict__ q, const float* __restrict__ table,
                         const int* __restrict__ ids, int p, int s, int k,
                         int tiles, float g, float eps2, float* __restrict__ acc) {
  constexpr int RECV = MP_THREADS / LANES * MP_RPT;
  const size_t grp = (size_t)blockIdx.y * (gridDim.x / tiles) + blockIdx.x / tiles;
  const int r0 = (blockIdx.x % tiles) * RECV + (threadIdx.x / LANES) * MP_RPT;
  pull_receivers<LANES, true>(q + grp * p * 3, table + (size_t)blockIdx.y * k * ROW,
                              ids + grp * s, p, s, k, r0, threadIdx.x % LANES, g, eps2,
                              acc + grp * p * 3);
}

// B10 over `groups` groups a scene where `listed`, else B9 (one group of all
// k rows), for each of `scenes` scenes (the grid's y): every scene keeps the
// blocks, lanes and order of a call on it alone.
template <int LANES>
cudaError_t launch_grouped(bool listed, const float* q, const float* table, const int* ids,
                           int groups, int p, int s, int k, float g, float eps2, float* acc,
                           int scenes, cudaStream_t stream) {
  constexpr int RECV = MP_THREADS / LANES * MP_RPT;
  const int tiles = (p + RECV - 1) / RECV;
  if ((long long)groups * tiles > INT_MAX || scenes <= 0 || scenes > 65535)
    return cudaErrorInvalidValue;
  if (!listed)
    multipole_far_kernel<LANES><<<dim3(tiles, scenes), MP_THREADS, 0, stream>>>(
        q, table, p, k, g, eps2, acc);
  else
    multipole_grouped_kernel<LANES><<<dim3(groups * tiles, scenes), MP_THREADS, 0, stream>>>(
        q, table, ids, p, s, k, tiles, g, eps2, acc);
  return cudaGetLastError();
}

int launch_lanes(int lanes, bool listed, const float* q, const float* table, const int* ids,
                 int groups, int p, int s, int k, float g, float eps2, float* acc,
                 int scenes, cudaStream_t st) {
  switch (lanes) {
    case 4: return (int)launch_grouped<4>(listed, q, table, ids, groups, p, s, k, g, eps2, acc,
                                          scenes, st);
    case 8: return (int)launch_grouped<8>(listed, q, table, ids, groups, p, s, k, g, eps2, acc,
                                          scenes, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// acc (scenes, p, 3) = pull of all k rows of each scene's table (scenes, k,
// 10) on its q (scenes, p, 3), `lanes` (4 or 8) lanes a receiver group;
// 1 <= scenes <= 65535 (the grid's y).
int multipole_far(const float* q, const float* table, int scenes, int p, int k, int lanes,
                  float g, float eps2, float* acc, void* stream) {
  if (p <= 0 || k < 0) return (int)cudaErrorInvalidValue;
  return launch_lanes(lanes, false, q, table, nullptr, 1, p, k, k, g, eps2, acc, scenes,
                      (cudaStream_t)stream);
}

// acc (scenes, groups, p, 3) = pull of table rows ids[sc, gr, :] (s of them)
// of scene sc's table (scenes, k, 10) on its p receivers q[sc, gr] (scenes,
// groups, p, 3), for every scene sc and group gr, `lanes` (4 or 8) lanes a
// receiver group; 1 <= scenes <= 65535 (the grid's y).
int multipole_grouped(const float* q, const float* table, const int* ids, int scenes,
                      int groups, int p, int s, int k, int lanes, float g, float eps2,
                      float* acc, void* stream) {
  if (groups <= 0 || p <= 0 || s < 0 || k < 0) return (int)cudaErrorInvalidValue;
  return launch_lanes(lanes, true, q, table, ids, groups, p, s, k, g, eps2, acc, scenes,
                      (cudaStream_t)stream);
}

}  // extern "C"
