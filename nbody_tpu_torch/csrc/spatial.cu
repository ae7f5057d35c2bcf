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
// What bounds it: instruction issue, in two parts. The scan costs ~13
// instructions a (query, candidate): a broadcast LDS.128, 8 FP operations
// for d2, a compare and a branch, one dependent chain a candidate. The
// selection costs a 2K-instruction min/max insertion network a key that
// enters a query's sorted list; a warp runs it whenever any of its 32 lanes
// inserts, so what counts is inserts per warp, not per query. Memory
// traffic is one 16-byte candidate per thread per block plus the (k ids, k
// distances) written per row.
//
// Design: one block per (query block, copy), one thread per query row, the
// 3b candidates staged once as float4 [x, y, z, gid bits] in shared memory.
// The keys are unique, so the k smallest do not depend on the order in which
// a lane visits the candidates, and the kernel picks the order that makes
// inserts rare: every warp walks the window in chunks of 32 columns, its own
// chunk (its queries' own columns) first, then outward, right and left in
// turn. All lanes of a warp read the same column (a broadcast). A lane keeps
// K sorted keys in registers (K = 8, 16 or 32 >= k): K - k zeros, below
// every packed key, then its k smallest keys, so its k-th key is always
// top[K - 1] (a register array indexed only by constants stays in
// registers). Its threshold thr is top[K - 1] at the last merge: a
// candidate whose d2 is above thr's distance is dropped after one compare;
// one below is packed and, if its key is below thr, appended to the lane's
// queue in shared memory (32 slots, one chunk's worth). After each chunk the
// warp merges: as many insertion rounds as the fullest queue of the warp
// holds, so lanes that insert at different columns share a round. Keys
// dropped against a stale threshold are above the k smallest seen so far,
// so the list's k keys are exact throughout. A warp skips a chunk whose
// bounding box (computed once a block) is farther from each of its lanes'
// queries than the lane's threshold distance: the box's distance is
// computed with the operations and rounding of d2, each of them monotonic,
// so it is at most the d2 of every candidate in the box, and none of them
// would pass the compare.
constexpr int CHUNK = 32;  // columns a warp scans between merges
constexpr int MAX_BLOCK = 682;  // 3b columns fit the packed keys' 11 bits
constexpr int MAX_CHUNKS = (3 * MAX_BLOCK + CHUNK - 1) / CHUNK;
constexpr int BOX_BYTES = MAX_CHUNKS * 6 * sizeof(float);  // static shared memory

template <int K>
__device__ __forceinline__ void insert_key(uint32_t (&top)[K], uint32_t key) {
#pragma unroll
  for (int j = K - 1; j > 0; --j) top[j] = min(top[j], max(top[j - 1], key));
  top[0] = min(top[0], key);
}

template <int K>
__global__ void select_kernel(const float4* __restrict__ cand, int L, int b,
                              int k, int include_self, uint32_t colmask,
                              int* __restrict__ ids, float* __restrict__ d2s) {
  extern __shared__ float4 win[];  // 3b candidates, then the queues
  __shared__ float box[MAX_CHUNKS][6];  // per chunk: min x, y, z, max x, y, z
  const int nt = blockDim.x;       // b rounded up to whole warps
  uint32_t* queue = reinterpret_cast<uint32_t*>(win + 3 * b);  // [slot][thread]
  const int i = blockIdx.x;        // query block
  const int c = blockIdx.y;        // curve copy
  const int nb = gridDim.x;
  const int ncol = 3 * b;
  const int nchunk = (ncol + CHUNK - 1) / CHUNK;
  const float4* src = cand + (size_t)c * L + (size_t)i * b;
  for (int t = threadIdx.x; t < ncol; t += nt) win[t] = src[t];
  __syncthreads();
  const int lane = threadIdx.x % 32;
  for (int ch = threadIdx.x / 32; ch < nchunk; ch += nt / 32) {  // a warp a chunk
    const float4 p = win[min(ch * CHUNK + lane, ncol - 1)];
    float lo[3] = {p.x, p.y, p.z}, hi[3] = {p.x, p.y, p.z};
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        lo[a] = fminf(lo[a], __shfl_xor_sync(0xffffffffu, lo[a], off));
        hi[a] = fmaxf(hi[a], __shfl_xor_sync(0xffffffffu, hi[a], off));
      }
    // a NaN coordinate (which fminf would pass over) makes the box infinite
    const bool nan = __any_sync(0xffffffffu, p.x != p.x || p.y != p.y || p.z != p.z);
    if (lane < 3) {
      box[ch][lane] = nan ? -__int_as_float(0x7F800000) : lo[lane];
      box[ch][lane + 3] = nan ? __int_as_float(0x7F800000) : hi[lane];
    }
  }
  __syncthreads();
  const int r = threadIdx.x;
  const bool live = r < b;  // the last warp may run past the block
  const int self = b + r;
  const float4 q = win[live ? self : b];
  const uint32_t flt_max_key = INF_BITS & ~colmask;  // keys at or above: d2 == FLT_MAX
  uint32_t top[K];
#pragma unroll
  for (int j = 0; j < K; ++j) top[j] = j < K - k ? 0u : EMPTY;
  uint32_t thr = live ? EMPTY : 0u;  // a lane past the block never appends
  float thr_d2 = live ? __int_as_float(0x7F800000) : -1.f;  // d2 <= this to be a candidate
  const int own = (b + CHUNK * (r / 32)) / CHUNK;
  int left = own, right = own + 1;
  for (int step = 0; step < nchunk; ++step) {
    int ch;
    if (step == 0) {
      ch = own;
    } else if (right < nchunk && (left == 0 || (step & 1))) {
      ch = right++;
    } else {
      ch = --left;
    }
    // the chunk's box distance, in d2's operations: <= d2 of each candidate
    const float* bx = box[ch];
    const float gx = fmaxf(fmaxf(__fsub_rn(bx[0], q.x), __fsub_rn(q.x, bx[3])), 0.f);
    const float gy = fmaxf(fmaxf(__fsub_rn(bx[1], q.y), __fsub_rn(q.y, bx[4])), 0.f);
    const float gz = fmaxf(fmaxf(__fsub_rn(bx[2], q.z), __fsub_rn(q.z, bx[5])), 0.f);
    const float lb = __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)),
                               __fmul_rn(gz, gz));
    if (__all_sync(0xffffffffu, lb > thr_d2)) continue;  // no lane would keep a candidate
    const int c0 = ch * CHUNK;
    const int c1 = min(c0 + CHUNK, ncol);
    uint32_t n = 0;
#pragma unroll 8
    for (int col = c0; col < c1; ++col) {
      const float4 p = win[col];
      const float dx = __fsub_rn(p.x, q.x);
      const float dy = __fsub_rn(p.y, q.y);
      const float dz = __fsub_rn(p.z, q.z);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      if (!(d2 > thr_d2)) {  // a NaN goes on, as max(NaN, 0) = 0 below
        const bool bad = d2 >= BAD_D2 || (!include_self && col == self);
        const uint32_t key =
            pack_key(bad ? __uint_as_float(INF_BITS) : fmaxf(d2, 0.f), (uint32_t)col, colmask);
        if (key < thr) queue[n++ * nt + r] = key;
      }
    }
    const uint32_t rounds = __reduce_max_sync(0xffffffffu, n);  // the same in every lane
    for (uint32_t s = 0; s < rounds; ++s) insert_key<K>(top, s < n ? queue[s * nt + r] : EMPTY);
    if (rounds > 0 && live) {
      thr = top[K - 1];
      // key < thr needs d2 <= the largest distance of thr's class; a
      // threshold of FLT_MAX's class (or an unfilled list) lets every d2 in
      thr_d2 = thr >= flt_max_key ? __int_as_float(0x7F800000) : __uint_as_float(thr | colmask);
    }
  }
  if (!live) return;
  const size_t row = ((size_t)c * nb + i) * b + r;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int at = j - (K - k);
    if (at >= 0) {
      const uint32_t key = top[j];
      ids[row * k + at] = __float_as_int(win[key & colmask].w);
      d2s[row * k + at] = __uint_as_float(key & ~colmask);
    }
  }
}

template <int K>
int launch_select(const float4* cand, int n_copies, int nb, int b, int k, int include_self,
                  uint32_t colmask, int* ids, float* d2s, cudaStream_t s) {
  const int nt = (b + 31) / 32 * 32;
  const size_t smem = (size_t)3 * b * sizeof(float4) + (size_t)CHUNK * nt * sizeof(uint32_t);
  if (smem + BOX_BYTES > 48 * 1024) {  // above the default: ask for it
    const cudaError_t e = cudaFuncSetAttribute(
        select_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  select_kernel<K><<<dim3(nb, n_copies), nt, smem, s>>>(cand, (nb + 2) * b, b, k, include_self,
                                                        colmask, ids, d2s);
  return (int)cudaGetLastError();
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
  if (n_copies <= 0 || nb <= 0 || b <= 0 || b > MAX_BLOCK || k <= 0 || k > 32 ||
      k > 3 * b || nbits <= 0 || (1 << nbits) < 3 * b || n_copies > 65535)
    return (int)cudaErrorInvalidValue;
  const uint32_t colmask = (1u << nbits) - 1u;
  const float4* c4 = (const float4*)cand;
  const cudaStream_t s = (cudaStream_t)stream;
  if (k <= 8)
    return launch_select<8>(c4, n_copies, nb, b, k, include_self, colmask, ids, d2s, s);
  if (k <= 16)
    return launch_select<16>(c4, n_copies, nb, b, k, include_self, colmask, ids, d2s, s);
  return launch_select<32>(c4, n_copies, nb, b, k, include_self, colmask, ids, d2s, s);
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
