// Morton-curve neighbour search kernels for Hopper (sm_90a): the windowed
// select (B7) and the cross-copy merge (B8), with a plain C interface bound
// from Python by ctypes (nbody_tpu_torch/ops/build.py,
// nbody_tpu_torch/ops/spatial.py).
//
// Every entry point launches on the caller's stream, does not synchronise and
// allocates nothing: the Python wrapper allocates outputs. Each returns
// cudaGetLastError() after its launch, so a refused launch reaches the
// wrapper, which raises.
//
// Both kernels select by a packed key: the non-negative f32 distance, clamped
// below at 2^-100 (so a zero distance keeps its column bits: a denormal key
// would be flushed to zero), with its low `nbits` mantissa bits replaced by
// the candidate's column. As unsigned integers these keys order exactly as
// the distances do, and they are unique per column, so ties break by column
// and the selection is the same on every run. The plain-torch twins in
// ops/spatial.py build the same keys and take the same k smallest.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t INF_BITS = 0x7F7FFFFFu;  // bits of FLT_MAX
constexpr uint32_t EMPTY = 0xFFFFFFFFu;     // above every packed key
constexpr float TINY = 7.888609052210118e-31f;  // 2^-100
constexpr float BAD_D2 = 1e29f;

__device__ __forceinline__ uint32_t pack_key(float d2, uint32_t col,
                                             uint32_t colmask) {
  return (__float_as_uint(fmaxf(d2, TINY)) & ~colmask) | col;
}

// --------------------------------------------------------------- B7: select
//
// Replaces nbody_tpu/ops/spatial.py::_select_kernel (Pallas, TPU).
//
// For one curve copy c and one block i of b queries in curve order: the k
// smallest packed keys over the 3b candidates of blocks i-1, i and i+1 (the
// candidate array is padded by one block of _BIG sentinels at each end, so
// block i's window starts at candidate row i*b and its query row r is
// candidate column b + r). d2 >= 1e29 (a sentinel) becomes FLT_MAX; the
// query's own column is excluded unless include_self.
//
// d2 = (dx*dx + dy*dy) + dz*dz with exact coordinate differences and each
// operation rounded on its own (__fsub_rn/__fmul_rn/__fadd_rn: no FMA
// contraction), which is what the twin's separate torch ops compute; the two
// agree bit for bit.
//
// What bounds it: about 3b * (12 + insertion) instructions per query row in
// registers, so instruction throughput; memory traffic is one 16-byte candidate
// per thread per block plus the (k ids, k distances) written per row.
//
// Design: one block per (query block, copy), one thread per query row. The
// block stages its 3b candidates as float4 [x, y, z, gid bits] in shared
// memory (12 KB at b = 256); every thread walks them in the same order, so
// the reads broadcast. Each thread keeps its K smallest keys sorted in
// registers (K a compile-time 16 or 32 >= k) with a branch-free
// min/max insertion network, entered only when a key beats the current K-th.
template <int K>
__global__ void select_kernel(const float4* __restrict__ cand, int L, int b,
                              int k, int include_self, uint32_t colmask,
                              int* __restrict__ ids, float* __restrict__ d2s) {
  extern __shared__ float4 win[];
  const int i = blockIdx.x;       // query block
  const int c = blockIdx.y;       // curve copy
  const int nb = gridDim.x;
  const float4* src = cand + (size_t)c * L + (size_t)i * b;
  for (int t = threadIdx.x; t < 3 * b; t += blockDim.x) win[t] = src[t];
  __syncthreads();
  const int r = threadIdx.x;
  if (r >= b) return;
  const float4 q = win[b + r];
  uint32_t top[K];
#pragma unroll
  for (int j = 0; j < K; ++j) top[j] = EMPTY;
  for (int col = 0; col < 3 * b; ++col) {
    const float4 p = win[col];
    const float dx = __fsub_rn(p.x, q.x);
    const float dy = __fsub_rn(p.y, q.y);
    const float dz = __fsub_rn(p.z, q.z);
    float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                         __fmul_rn(dz, dz));
    const bool bad = d2 >= BAD_D2 || (!include_self && col == b + r);
    d2 = bad ? __uint_as_float(INF_BITS) : fmaxf(d2, 0.f);
    const uint32_t key = pack_key(d2, (uint32_t)col, colmask);
    if (key < top[K - 1]) {
#pragma unroll
      for (int j = K - 1; j > 0; --j) top[j] = min(top[j], max(top[j - 1], key));
      top[0] = min(top[0], key);
    }
  }
  const size_t row = ((size_t)c * nb + i) * b + r;
  for (int j = 0; j < k; ++j) {
    const uint32_t key = top[j];
    ids[row * k + j] = __float_as_int(win[key & colmask].w);
    d2s[row * k + j] = __uint_as_float(key & ~colmask);
  }
}

// ---------------------------------------------------------------- B8: merge
//
// Replaces nbody_tpu/ops/spatial.py::_merge_kernel (Pallas, TPU).
//
// Per row: the k nearest unique ids among the w = C*k candidates of all curve
// copies. Each of k passes takes the smallest packed key, sums the ids of the
// slots holding that key (exactly one slot while candidates remain), and sets
// every slot holding the picked id to FLT_MAX, which removes its duplicates
// from the other copies. Once a row is exhausted every slot holds FLT_MAX, the
// "id" is the wrapped int32 sum of all slots and the value is FLT_MAX: the
// caller's d2 < 1e29 test marks it invalid. The twin computes the same sum.
//
// What bounds it: k passes of a 5-step warp shuffle reduction (min, then sum)
// over at most 4 slots a lane: latency of the shuffles, not memory (each row
// is read once, 8 bytes a slot).
//
// Design: one warp per row, lane l holding slots l, l+32, l+64, l+96 (w <=
// 128) in registers; unused slots hold a key above every packed key and never
// match. Eight rows per 256-thread block.
constexpr int MERGE_WARPS = 8;
constexpr int MERGE_SLOTS = 4;

__global__ void __launch_bounds__(MERGE_WARPS * 32)
merge_kernel(const int* __restrict__ cand, const float* __restrict__ d2,
             int n, int w, int k, uint32_t colmask, int* __restrict__ ids,
             float* __restrict__ vals) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * MERGE_WARPS + (threadIdx.x >> 5);
  if (row >= n) return;  // whole warps leave together
  uint32_t key[MERGE_SLOTS];
  int cc[MERGE_SLOTS];
#pragma unroll
  for (int s = 0; s < MERGE_SLOTS; ++s) {
    const int col = lane + 32 * s;
    if (col < w) {
      const size_t at = (size_t)row * w + col;
      cc[s] = cand[at];
      key[s] = pack_key(fmaxf(d2[at], 0.f), (uint32_t)col, colmask);
    } else {
      cc[s] = 0;
      key[s] = EMPTY;
    }
  }
  for (int j = 0; j < k; ++j) {
    uint32_t mn = key[0];
#pragma unroll
    for (int s = 1; s < MERGE_SLOTS; ++s) mn = min(mn, key[s]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    uint32_t pid = 0;
#pragma unroll
    for (int s = 0; s < MERGE_SLOTS; ++s)
      pid += key[s] == mn ? (uint32_t)cc[s] : 0u;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      pid += __shfl_xor_sync(0xffffffffu, pid, off);
#pragma unroll
    for (int s = 0; s < MERGE_SLOTS; ++s)
      if (key[s] != EMPTY && cc[s] == (int)pid) key[s] = INF_BITS;
    if (lane == 0) {
      ids[(size_t)row * k + j] = (int)pid;
      vals[(size_t)row * k + j] = __uint_as_float(mn & ~colmask);
    }
  }
}

}  // namespace

extern "C" {

// ids, d2s (C, nb*b, k) = the k smallest packed keys of every query row.
// cand: (C, L) float4 [x, y, z, gid bits] with L == (nb + 2) * b.
int morton_select(const void* cand, int n_copies, int nb, int b, int k,
                  int include_self, int nbits, int* ids, float* d2s,
                  void* stream) {
  if (n_copies <= 0 || nb <= 0 || b <= 0 || b > 1024 || k <= 0 || k > 32 ||
      k > 3 * b || nbits <= 0 || (1 << nbits) < 3 * b || n_copies > 65535)
    return (int)cudaErrorInvalidValue;
  const int L = (nb + 2) * b;
  const uint32_t colmask = (1u << nbits) - 1u;
  const size_t smem = (size_t)3 * b * sizeof(float4);
  const dim3 grid(nb, n_copies);
  const cudaStream_t s = (cudaStream_t)stream;
  if (k <= 16)
    select_kernel<16><<<grid, b, smem, s>>>((const float4*)cand, L, b, k,
                                            include_self, colmask, ids, d2s);
  else
    select_kernel<32><<<grid, b, smem, s>>>((const float4*)cand, L, b, k,
                                            include_self, colmask, ids, d2s);
  return (int)cudaGetLastError();
}

// ids, vals (n, k) = the k nearest unique ids of each row of cand/d2 (n, w).
int morton_merge(const int* cand, const float* d2, int n, int w, int k,
                 int nbits, int* ids, float* vals, void* stream) {
  if (n <= 0 || w <= 0 || w > 32 * MERGE_SLOTS || k <= 0 || nbits <= 0 ||
      (1 << nbits) < w)
    return (int)cudaErrorInvalidValue;
  const uint32_t colmask = (1u << nbits) - 1u;
  const dim3 grid((n + MERGE_WARPS - 1) / MERGE_WARPS);
  merge_kernel<<<grid, MERGE_WARPS * 32, 0, (cudaStream_t)stream>>>(
      cand, d2, n, w, k, colmask, ids, vals);
  return (int)cudaGetLastError();
}

}  // extern "C"
