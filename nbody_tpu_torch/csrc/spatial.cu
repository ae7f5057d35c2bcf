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
//
// k above 32 (SLABS): the walk runs once for each slab of 32 outputs, the
// candidates staged once. A slab keeps only keys above the last key of the
// slab before it (its lane's top[K - 1]), so it selects the next 32 smallest
// of the 3b unique keys, and the slabs' lists, written one after another,
// are the k smallest in order: the plain version's top-k.
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

template <int K, bool SLABS>
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
  const int own = (b + CHUNK * (r / 32)) / CHUNK;
  const size_t row = ((size_t)c * nb + i) * b + r;
  uint32_t floor_key = 0u;  // SLABS: keys at or below it were selected before
  // one slab of at most K outputs, j0 the first (without SLABS: k <= K, one)
  for (int j0 = 0; j0 < (SLABS ? k : 1); j0 += K) {
    const int ks = SLABS ? min(K, k - j0) : k;
    uint32_t top[K];
#pragma unroll
    for (int j = 0; j < K; ++j) top[j] = j < K - ks ? 0u : EMPTY;
    uint32_t thr = live ? EMPTY : 0u;  // a lane past the block never appends
    float thr_d2 = live ? __int_as_float(0x7F800000) : -1.f;  // d2 <= this to be a candidate
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
          if (key < thr && (!SLABS || key > floor_key)) queue[n++ * nt + r] = key;
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
    if (live) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int at = j - (K - ks);
        if (at >= 0) {
          const uint32_t key = top[j];
          ids[row * k + j0 + at] = __float_as_int(win[key & colmask].w);
          d2s[row * k + j0 + at] = __uint_as_float(key & ~colmask);
        }
      }
    }
    floor_key = top[K - 1];
  }
}

template <int K, bool SLABS = false>
int launch_select(const float4* cand, int n_copies, int nb, int b, int k, int include_self,
                  uint32_t colmask, int* ids, float* d2s, cudaStream_t s) {
  const int nt = (b + 31) / 32 * 32;
  const size_t smem = (size_t)3 * b * sizeof(float4) + (size_t)CHUNK * nt * sizeof(uint32_t);
  if (smem + BOX_BYTES > 48 * 1024) {  // above the default: ask for it
    const cudaError_t e = cudaFuncSetAttribute(
        select_kernel<K, SLABS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  select_kernel<K, SLABS><<<dim3(nb, n_copies), nt, smem, s>>>(
      cand, (nb + 2) * b, b, k, include_self, colmask, ids, d2s);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- B8: merge
//
// Replaces nbody_tpu/ops/spatial.py::_merge_kernel (Pallas, TPU).
//
// Per row: the k nearest unique ids among its w candidate slots (the C*k of
// all curve copies; w <= 2048, the packed keys' 11 column bits, as JAX's
// _pack_d2_cols asserts). Each of k passes takes the smallest packed key,
// sums the ids of the slots holding that key, sets every slot holding the
// picked id to INF_BITS (removing its duplicates from the other copies),
// and emits the id and the key with its column bits cleared. This is the
// plain version's definition (ops/spatial.py::morton_merge_torch) on any
// input without a NaN distance, not only on B7's output: rows with
// duplicates, unsorted copies, fewer than k unique ids.
//
// The id without a sum: a key that is not INF_BITS is held by one slot,
// whose column is its low bits (keys are unique per column, and a masked
// slot holds INF_BITS), so the id is read from the row's staged ids at that
// column. Only a minimum of INF_BITS can be held by several slots: every
// slot of a row that ran out of unique ids, and a sentinel (d2 >= FLT_MAX)
// in column colmask, whose packed key is INF_BITS when w is a power of two.
// A pass in which any row of the warp meets such a minimum sums the ids of
// every hit over the row's lanes instead (the same id where one slot hits).
//
// What bounds it: bytes at 1M rows, k = 8 (w = 32): each row read once, 8
// bytes a slot, and written once, 8 bytes an output. At w = 128, k = 32 the
// integer pipe: a pass is ~117 instructions a warp (the built SASS), two a
// slot for the mask (compare, select) and a half for the min (Hopper's
// three-input VIMNMX3), nearly all integer, which an SM issues at 64 lanes
// a clock, half its issue rate. A predicated move in place of the select
// builds to the same select.
//
// Design: MERGE_LANES (4) lanes a row, so a warp serves 8 rows and the min
// is a 2-step shuffle butterfly (8 lanes a row measured 9-39% slower at the
// path shapes). Lane l holds slots l, l + LANES, ... (S of them, S =
// ceil(w / LANES) rounded up to even: a template argument) as keys and ids
// in registers. A block of MERGE_ROWS rows first copies its rows,
// contiguous in device memory, to shared memory with consecutive threads
// (keys packed on the way; 16 bytes a load where w is a multiple of 4 and
// the rows are aligned), at a row stride = LANES mod 32 (and a multiple of
// 4), so the lanes' loads of their slots meet no bank conflict. Empty slots
// (columns at or past w) hold the key EMPTY, above every packed key, and
// the id 0: a mask can make one INF_BITS only once the row holds a live
// INF_BITS slot, so it is never the minimum alone, and in a sum it adds 0.
// Lane 0 of a row puts each pass's id and value in shared memory; the block
// writes them out after MERGE_OUT passes or the last, by consecutive
// threads (for k <= MERGE_OUT the block's outputs are one contiguous
// range).
//
// Rows wider than MERGE_MAX_W (k above 32 with 4 copies) take
// merge_wide_kernel: a warp a row, MERGE_WIDE_ROWS rows a block, the row's
// keys and ids staged in shared memory and left there; a pass is each
// lane's min over its slots (l, l + 32, ...), a warp-wide min, the id read
// at the minimum's column (the wrapped sum of every hit's id where the
// minimum is INF_BITS, as above), and each lane masking its slots that hold
// the id. It makes the same picks in the same order as merge_kernel and the
// plain version, each pass reading the row from shared memory twice.
constexpr int MERGE_LANES = 4;   // lanes a row
constexpr int MERGE_ROWS = 32;   // rows a block
constexpr int MERGE_OUT = 32;    // passes a block buffers before it writes them
constexpr int MERGE_MAX_W = 128;
constexpr int MERGE_WIDE_ROWS = 8;     // wide rows: rows (warps) a block
constexpr int MERGE_MAX_WIDE = 2048;   // wide rows: the widest, 11 column bits

__host__ __device__ constexpr int merge_stride(int w, int lanes) {
  return (w + 31) / 32 * 32 + lanes;
}
// staged keys and ids and the buffered outputs fit the default 48 KiB
static_assert(4 * MERGE_ROWS * (2 * merge_stride(MERGE_MAX_W, MERGE_LANES) + 2 * MERGE_OUT) <=
                  48 * 1024,
              "B8's shared memory");

template <int S>
__global__ void __launch_bounds__(MERGE_ROWS * MERGE_LANES)
merge_kernel(const int* __restrict__ cand, const float* __restrict__ d2,
             int n, int w, int k, uint32_t colmask, int* __restrict__ ids,
             float* __restrict__ vals) {
  constexpr int LANES = MERGE_LANES;
  static_assert(32 % LANES == 0 && S % 2 == 0, "a row's lanes share a warp");
  extern __shared__ uint32_t smem[];
  constexpr int NT = MERGE_ROWS * LANES;
  const int stride = merge_stride(w, LANES);
  const int kc = min(k, MERGE_OUT);
  uint32_t* skey = smem;                                      // [MERGE_ROWS][stride]
  int* sid = reinterpret_cast<int*>(skey + MERGE_ROWS * stride);  // [MERGE_ROWS][stride]
  int* oid = sid + MERGE_ROWS * stride;                      // [MERGE_ROWS][kc]
  float* oval = reinterpret_cast<float*>(oid + MERGE_ROWS * kc);
  const int row0 = blockIdx.x * MERGE_ROWS;
  const int nr = min(MERGE_ROWS, n - row0);
  // the block's rows, one contiguous range, to shared memory: 16 bytes a
  // load where rows are whole quads and the range is aligned, else 4
  const int* crows = cand + (size_t)row0 * w;
  const float* drows = d2 + (size_t)row0 * w;
  if ((w & 3) == 0 && ((reinterpret_cast<uintptr_t>(crows) |
                        reinterpret_cast<uintptr_t>(drows)) & 15) == 0) {
    const int wq = w / 4, dr = NT / wq, dc = NT % wq;
    int r = threadIdx.x / wq, q = threadIdx.x % wq;
#pragma unroll 4
    for (int e = threadIdx.x; e < nr * wq; e += NT) {
      const int4 i4 = reinterpret_cast<const int4*>(crows)[e];
      const float4 f4 = reinterpret_cast<const float4*>(drows)[e];
      const uint32_t c = 4 * q;
      *reinterpret_cast<uint4*>(skey + r * stride + c) = make_uint4(
          pack_key(fmaxf(f4.x, 0.f), c, colmask), pack_key(fmaxf(f4.y, 0.f), c + 1, colmask),
          pack_key(fmaxf(f4.z, 0.f), c + 2, colmask), pack_key(fmaxf(f4.w, 0.f), c + 3, colmask));
      *reinterpret_cast<int4*>(sid + r * stride + c) = i4;
      q += dc;
      r += dr;
      if (q >= wq) {
        q -= wq;
        ++r;
      }
    }
  } else {
    const int dr = NT / w, dc = NT % w;
    int r = threadIdx.x / w, c = threadIdx.x % w;
    for (int e = threadIdx.x; e < nr * w; e += NT) {
      skey[r * stride + c] = pack_key(fmaxf(drows[e], 0.f), (uint32_t)c, colmask);
      sid[r * stride + c] = crows[e];
      c += dc;
      r += dr;
      if (c >= w) {
        c -= w;
        ++r;
      }
    }
  }
  __syncthreads();
  const int g = threadIdx.x / LANES;  // the block's row this lane serves
  const int lane = threadIdx.x % LANES;
  const bool live = g < nr;
  uint32_t key[S];
  int cc[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int col = s * LANES + lane;
    const bool in = live && col < w;
    key[s] = in ? skey[g * stride + col] : EMPTY;
    cc[s] = in ? sid[g * stride + col] : 0;
  }
  for (int j0 = 0; j0 < k; j0 += kc) {
    const int nj = min(kc, k - j0);
    for (int jj = 0; jj < nj; ++jj) {
      uint32_t t[S];
#pragma unroll
      for (int s = 0; s < S; ++s) t[s] = key[s];
#pragma unroll
      for (int h = 1; h < S; h *= 2)
#pragma unroll
        for (int s = 0; s + h < S; s += 2 * h) t[s] = min(t[s], t[s + h]);
      uint32_t mn = t[0];
#pragma unroll
      for (int off = LANES / 2; off > 0; off >>= 1)
        mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
      int pid;
      if (__any_sync(0xffffffffu, mn == INF_BITS)) {  // rare: sum every hit
        uint32_t sum = 0;
#pragma unroll
        for (int s = 0; s < S; ++s) sum += key[s] == mn ? (uint32_t)cc[s] : 0u;
#pragma unroll
        for (int off = LANES / 2; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        pid = (int)sum;
      } else {
        pid = live ? sid[g * stride + (mn & colmask)] : 0;
      }
      if (live) {  // a row past the block's end keeps its empty slots
#pragma unroll
        for (int s = 0; s < S; ++s)
          if (cc[s] == pid) key[s] = INF_BITS;
      }
      if (lane == 0) {
        oid[g * kc + jj] = pid;
        oval[g * kc + jj] = __uint_as_float(mn & ~colmask);
      }
    }
    __syncthreads();
    if (nj == k) {  // all passes at once: the block's outputs are contiguous
      int* gi = ids + (size_t)row0 * k;
      float* gv = vals + (size_t)row0 * k;
      for (int e = threadIdx.x; e < nr * k; e += NT) {
        gi[e] = oid[e];
        gv[e] = oval[e];
      }
    } else {
      for (int e = threadIdx.x; e < nr * nj; e += NT) {
        const int r = e / nj, jj = e - r * nj;
        const size_t o = (size_t)(row0 + r) * k + j0 + jj;
        ids[o] = oid[r * kc + jj];
        vals[o] = oval[r * kc + jj];
      }
    }
    __syncthreads();
  }
}

// Rows of w > MERGE_MAX_W slots: a warp a row (see above). Shared memory:
// MERGE_WIDE_ROWS x (keys, ids) of `stride` = round4(w) words.
__global__ void __launch_bounds__(MERGE_WIDE_ROWS * 32)
merge_wide_kernel(const int* __restrict__ cand, const float* __restrict__ d2, int n, int w,
                  int k, uint32_t colmask, int* __restrict__ ids, float* __restrict__ vals) {
  extern __shared__ uint32_t wide_smem[];
  const int stride = (w + 3) & ~3;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * MERGE_WIDE_ROWS + warp;
  if (row >= n) return;  // the whole warp; no block-wide barrier below
  uint32_t* skey = wide_smem + (size_t)warp * 2 * stride;
  int* sid = reinterpret_cast<int*>(skey + stride);
  for (int c = lane; c < w; c += 32) {
    skey[c] = pack_key(fmaxf(d2[(size_t)row * w + c], 0.f), (uint32_t)c, colmask);
    sid[c] = cand[(size_t)row * w + c];
  }
  __syncwarp();
  for (int j = 0; j < k; ++j) {
    uint32_t mn = EMPTY;
    for (int c = lane; c < w; c += 32) mn = min(mn, skey[c]);
    mn = __reduce_min_sync(0xffffffffu, mn);
    int pid;
    if (mn == INF_BITS) {  // rare: sum every hit
      uint32_t sum = 0;
      for (int c = lane; c < w; c += 32) sum += skey[c] == mn ? (uint32_t)sid[c] : 0u;
      pid = (int)__reduce_add_sync(0xffffffffu, sum);
    } else {
      pid = sid[mn & colmask];
    }
    __syncwarp();  // every lane has read the slots before any is masked
    for (int c = lane; c < w; c += 32)
      if (sid[c] == pid) skey[c] = INF_BITS;
    __syncwarp();
    if (lane == 0) {
      ids[(size_t)row * k + j] = pid;
      vals[(size_t)row * k + j] = __uint_as_float(mn & ~colmask);
    }
  }
}

int launch_merge_wide(const int* cand, const float* d2, int n, int w, int k, uint32_t colmask,
                      int* ids, float* vals, cudaStream_t st) {
  const size_t smem = sizeof(uint32_t) * MERGE_WIDE_ROWS * 2 * ((w + 3) & ~3);
  if (smem > 48 * 1024) {  // above the default: ask for it
    const cudaError_t e = cudaFuncSetAttribute(
        merge_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  merge_wide_kernel<<<(n + MERGE_WIDE_ROWS - 1) / MERGE_WIDE_ROWS, MERGE_WIDE_ROWS * 32, smem,
                      st>>>(cand, d2, n, w, k, colmask, ids, vals);
  return (int)cudaGetLastError();
}

// S, the slots a lane, the fewest even count with w <= MERGE_LANES * S
template <int S = 2>
int launch_merge(const int* cand, const float* d2, int n, int w, int k, uint32_t colmask,
                 int* ids, float* vals, cudaStream_t st) {
  if constexpr (MERGE_LANES * S < MERGE_MAX_W) {
    if (w > MERGE_LANES * S)
      return launch_merge<S + 2>(cand, d2, n, w, k, colmask, ids, vals, st);
  }
  const int kc = k < MERGE_OUT ? k : MERGE_OUT;
  const size_t smem =
      sizeof(uint32_t) * MERGE_ROWS * (2 * merge_stride(w, MERGE_LANES) + 2 * kc);
  merge_kernel<S><<<(n + MERGE_ROWS - 1) / MERGE_ROWS, MERGE_ROWS * MERGE_LANES, smem, st>>>(
      cand, d2, n, w, k, colmask, ids, vals);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ids, d2s (C, nb*b, k) = the k smallest packed keys of every query row,
// k <= 3b (above 32 in slabs of 32). cand: (C, L) float4 [x, y, z, gid bits]
// with L == (nb + 2) * b.
int morton_select(const void* cand, int n_copies, int nb, int b, int k,
                  int include_self, int nbits, int* ids, float* d2s,
                  void* stream) {
  if (n_copies <= 0 || nb <= 0 || b <= 0 || b > MAX_BLOCK || k <= 0 || k > 3 * b ||
      nbits <= 0 || (1 << nbits) < 3 * b || n_copies > 65535)
    return (int)cudaErrorInvalidValue;
  const uint32_t colmask = (1u << nbits) - 1u;
  const float4* c4 = (const float4*)cand;
  const cudaStream_t s = (cudaStream_t)stream;
  if (k <= 8)
    return launch_select<8>(c4, n_copies, nb, b, k, include_self, colmask, ids, d2s, s);
  if (k <= 16)
    return launch_select<16>(c4, n_copies, nb, b, k, include_self, colmask, ids, d2s, s);
  if (k <= 32)
    return launch_select<32>(c4, n_copies, nb, b, k, include_self, colmask, ids, d2s, s);
  return launch_select<32, true>(c4, n_copies, nb, b, k, include_self, colmask, ids, d2s, s);
}

// ids, vals (n, k) = the k nearest unique ids of each row of cand/d2 (n, w),
// w <= 2048.
int morton_merge(const int* cand, const float* d2, int n, int w, int k,
                 int nbits, int* ids, float* vals, void* stream) {
  if (n <= 0 || w <= 0 || w > MERGE_MAX_WIDE || k <= 0 || nbits <= 0 || nbits > 11 ||
      (1 << nbits) < w)
    return (int)cudaErrorInvalidValue;
  const uint32_t colmask = (1u << nbits) - 1u;
  if (w > MERGE_MAX_W)
    return launch_merge_wide(cand, d2, n, w, k, colmask, ids, vals, (cudaStream_t)stream);
  return launch_merge(cand, d2, n, w, k, colmask, ids, vals, (cudaStream_t)stream);
}

}  // extern "C"
