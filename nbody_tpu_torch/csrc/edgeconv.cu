// EdgeConv message sum for Hopper (sm_90a): B11, with a plain C interface
// bound from Python by ctypes (nbody_tpu_torch/ops/build.py,
// nbody_tpu_torch/ops/edgeconv_kernel.py).
//
// The entry point launches on the caller's stream, does not synchronise and
// allocates nothing: the Python wrapper allocates the output. It returns
// cudaGetLastError() after its launch, so a refused launch reaches the
// wrapper, which raises.
//
// Replaces attic/edgeconv_kernel.py::_windowed_kernel (Pallas, TPU).
//
//   out[i, :] = sum_k take(i, k) * tanh(u[i, :] + g(i, k))
//   g(i, k)   = v[idx[i, k] + off, :], bfloat16-rounded where round(i, k)
//   in_win(i, k) = 0 <= idx[i, k] - tile * (i / tile) + half < tile + 2 * half
//
// Two modes of one kernel:
// - windowed (windowed_tanh_sum, the TPU kernel's semantics): v is vpad,
//   off = half, take = mask & in_win, and in bfloat16 mode every taken
//   gather is rounded;
// - owned (edge_message_sum): v is v itself, off = 0, take = mask | mask2
//   (the window plan's in-window edges and its taken fallback edges), and in
//   bfloat16 mode only the in-window gathers are rounded, so a fallback edge
//   reads unrounded v as in the JAX function. The window test decides only
//   the rounding here. One launch sums every edge the plan keeps.
// A gathered row outside [0, rows_v) reads as zeros, as the zero pad rows
// of the TPU kernel's vpad read.
//
// The TPU kernel copies each tile's window into on-chip memory and gathers
// from it with a one-hot matrix product, because a row gather costs the TPU
// an instruction per row. Neither is carried over: on this card a row of d
// floats is a coalesced read, which with rows in Morton order mostly hits
// the L2 cache, so rows are read straight from global memory as 16-byte
// vectors, and no window is needed to reach a sender.
//
// What bounds it. At 1M rows, k = 8, d = 64 its bytes bound is 0.24 ms. In
// the SASS of the first port (a thread a row and 4 channels, 32 registers)
// a taken edge cost a thread ~101 instructions for its 4 channels: the
// 64-bit window test and address, a branch behind the mask load, and
// tanhf's ~16 instructions (branch-free, two MUFU operations: ex2, rcp). At
// ~750 instructions a thread it was issue-bound: an issue floor of ~0.36 ms
// against 0.49 measured. Here a thread issues ~880 instructions for 8 edges
// of 8 channels, ~14 an (edge, channel) (an edge's 8 tanh sums 73, its
// decision, address and two 16-byte loads ~25, the prologue ~70), and 1.5
// MUFU operations a tanh: at the phase-10a input the issue floor is ~0.21
// ms and the MUFU floor (16 a clock an SM) ~0.18 ms, both under the bytes
// bound. It runs at ~0.32 ms, nearest the bytes bound: ~66% of the issue
// rate with 32 warps an SM, latency-limited between its gathers and its
// MUFU chains (PERF.md, section 6).
//
// Design:
// - a thread owns one receiver row and NV adjacent float4s of it (NV = 2
//   where 8 divides d); a 2-D block of 128 threads, so the row and channel
//   come from block indices, with one 32-bit division a thread for the row's
//   tile; index math in 32 bits, addresses by one 32 x 32 -> 64-bit multiply;
// - at most 64 registers (__launch_bounds__ with 8 blocks an SM): the same
//   loop at 108 registers (chunks of 8 edges, 16 warps an SM) ran 0.59 ms;
//   occupancy decides more than the instruction count here;
// - the row's idx and mask are read by each of its threads (broadcast
//   loads), and the edge decisions of a chunk of EDGES edges are kept as bit
//   masks; all the chunk's gathers are issued before its first tanh;
// - tanh without a branch and with 1.5 MUFU operations: e = 2^(-2|x| log2 e)
//   by ex2.approx, tanh|x| = (1 - e) / (1 + e), the reciprocals of two
//   channels' 1 + e (both in [1, 2]) from one rcp.approx of their product,
//   the sign copied back; within ~2e-7 of tanh over the whole float range,
//   a tenth of the 2e-6 bar (tanh.approx's 2^-11 misses it; an odd
//   polynomial below |x| = 0.6 bought ulps the bar does not need for ~20%
//   more time);
// - k summed in slot order, one writer per output element, no atomics: the
//   same bits on every run. With bfloat16 rounding the gathered values are
//   rounded to bfloat16 (nearest even) before the add; u and the sum stay
//   float32 (the TPU kernel's mxu_dtype=bfloat16 mode).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int MIN_BLOCKS = 8;  // blocks an SM: at most 64 registers a thread
constexpr int EDGES = 4;       // gathers issued together before their tanh

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// a, b <- tanh(a), tanh(b): one reciprocal for both.
__device__ __forceinline__ void tanh2(float& a, float& b) {
  const float ea = ex2_approx(fabsf(a) * -2.88539008f);  // e^{-2|a|} in [0, 1]
  const float eb = ex2_approx(fabsf(b) * -2.88539008f);
  const float da = 1.0f + ea, db = 1.0f + eb;
  const float r = rcp_approx(da * db);
  const float qa = db * r, qb = da * r;  // 1 / da, 1 / db
  a = copysignf(fmaf(-ea, qa, qa), a);
  b = copysignf(fmaf(-eb, qb, qb), b);
}

__device__ __forceinline__ float4 round_bf16(float4 a) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a.x, a.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(a.z, a.w);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
}

__device__ __forceinline__ void add_tanh(float4& acc, const float4& u, const float4& g) {
  float x = u.x + g.x, y = u.y + g.y, z = u.z + g.z, w = u.w + g.w;
  tanh2(x, y);
  tanh2(z, w);
  acc.x += x;
  acc.y += y;
  acc.z += z;
  acc.w += w;
}

struct Args {
  const float4* u;       // (n, d)
  const float4* v;       // (rows_v, d)
  const int* idx;        // (n, k)
  const uint8_t* mask;   // (n, k)
  const uint8_t* mask2;  // (n, k), owned mode only
  float4* out;           // (n, d)
  int n, rows_v, off, lanes, k, tile, half;
  unsigned w, row_bytes;  // tile + 2 half; 4 d
};

// blockDim = (lanes of a row, rows), grid = (row blocks, lane blocks).
template <int NV, bool BF16, bool OWNED>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
windowed_tanh_sum_kernel(const Args a) {
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  const int c = (blockIdx.y * blockDim.x + threadIdx.x) * NV;
  if (row >= a.n || c >= a.lanes * NV) return;
  // the window [lo, lo + w) of the row's tile, wrapping in 32 bits: the
  // wrapper keeps n + tile + 2 half below 2^31
  const unsigned lo = (unsigned)(row - row % a.tile) - (unsigned)a.half;
  const float4* urow = (const float4*)((const char*)a.u + (size_t)row * a.row_bytes) + c;
  float4 ui[NV], acc[NV];
#pragma unroll
  for (int s = 0; s < NV; ++s) {
    ui[s] = urow[s];
    acc[s] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int* irow = a.idx + (size_t)row * a.k;
  const uint8_t* mrow = a.mask + (size_t)row * a.k;
  const uint8_t* m2row = OWNED ? a.mask2 + (size_t)row * a.k : nullptr;
  const float4* vc = a.v + c;
  for (int e0 = 0; e0 < a.k; e0 += EDGES) {
    float4 g[EDGES][NV];
    unsigned take = 0, rnd = 0;  // bit i: edge e0 + i
#pragma unroll
    for (int i = 0; i < EDGES; ++i) {
      const int e = e0 + i;
      const bool in = e < a.k;
      const int j = in ? irow[e] : 0;
      const bool m = in && (mrow[e] | (OWNED ? m2row[e] : 0));
      const bool in_win = (unsigned)j - lo < a.w;
      const bool t = OWNED ? m : m && in_win;
      const unsigned jr = (unsigned)j + (unsigned)a.off;
      const bool load = t && jr < (unsigned)a.rows_v;
      take |= (unsigned)t << i;
      if (BF16 && (!OWNED || in_win)) rnd |= 1u << i;
      const float4* p = (const float4*)((const char*)vc + (size_t)(load ? jr : 0u) * a.row_bytes);
#pragma unroll
      for (int s = 0; s < NV; ++s) g[i][s] = load ? p[s] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < EDGES; ++i) {
      if (take >> i & 1u) {
#pragma unroll
        for (int s = 0; s < NV; ++s)
          add_tanh(acc[s], ui[s], BF16 && (rnd >> i & 1u) ? round_bf16(g[i][s]) : g[i][s]);
      }
    }
  }
  float4* orow = (float4*)((char*)a.out + (size_t)row * a.row_bytes) + c;
#pragma unroll
  for (int s = 0; s < NV; ++s) orow[s] = acc[s];
}

template <int NV>
cudaError_t launch(const Args& a, bool bf16, bool owned, cudaStream_t s) {
  const int bx = a.lanes < THREADS ? a.lanes : THREADS;
  const int by = THREADS / bx;
  const dim3 block(bx, by);
  const dim3 grid((a.n + by - 1) / by, (a.lanes + bx - 1) / bx);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  if (owned) {
    if (bf16) windowed_tanh_sum_kernel<NV, true, true><<<grid, block, 0, s>>>(a);
    else windowed_tanh_sum_kernel<NV, false, true><<<grid, block, 0, s>>>(a);
  } else {
    if (bf16) windowed_tanh_sum_kernel<NV, true, false><<<grid, block, 0, s>>>(a);
    else windowed_tanh_sum_kernel<NV, false, false><<<grid, block, 0, s>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out (n, d) = the tanh sums above; u (n, d), v (rows_v, d), idx (n, k)
// int32, mask and mask2 (n, k) bytes. mask2 null: the windowed mode (v is
// vpad, off = half); mask2 set: the owned mode (off = 0). d must be a
// multiple of 4 and n + tile + 2 half below 2^31; a shape the kernel cannot
// take returns an error code.
int edgeconv_windowed_tanh_sum(const void* u, const void* v, const int* idx,
                               const uint8_t* mask, const uint8_t* mask2, int n,
                               int rows_v, int off, int d, int k, int tile,
                               int half, int bf16, void* out, void* stream) {
  if (n <= 0 || rows_v <= 0 || off < 0 || d <= 0 || d % 4 || k <= 0 || tile <= 0 ||
      half < 0 || (long long)n + tile + 2LL * half > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const int nv = d % 8 == 0 ? 2 : 1;
  const Args a{(const float4*)u, (const float4*)v, idx, mask, mask2, (float4*)out,
               n, rows_v, off, d / (4 * nv), k, tile, half,
               (unsigned)tile + 2u * (unsigned)half, 4u * (unsigned)d};
  cudaStream_t s = (cudaStream_t)stream;
  const bool owned = mask2 != nullptr;
  return (int)(nv == 2 ? launch<2>(a, bf16 != 0, owned, s) : launch<1>(a, bf16 != 0, owned, s));
}

}  // extern "C"
