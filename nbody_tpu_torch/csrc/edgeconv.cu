// Windowed EdgeConv message sum for Hopper (sm_90a): B11, with a plain C
// interface bound from Python by ctypes (nbody_tpu_torch/ops/build.py,
// nbody_tpu_torch/ops/edgeconv_kernel.py).
//
// The entry point launches on the caller's stream, does not synchronise and
// allocates nothing: the Python wrapper allocates the output. It returns
// cudaGetLastError() after its launch, so a refused launch reaches the
// wrapper, which raises.
//
// Replaces attic/edgeconv_kernel.py::_windowed_kernel (Pallas, TPU).
//
//   out[i, :] = sum_k mask[i, k] * [0 <= r < W] * tanh(u[i, :] + vpad[idx[i, k] + half, :])
//   r = idx[i, k] - tile * (i / tile) + half,   W = tile + 2 * half
//
// u (n, d) carries the receiver's term with the edge bias folded in, vpad
// (n + 2 * half, d) the senders' term with `half` zero rows at each end, both
// in the Morton-sorted row space that idx (n, k) points into. An edge counts
// only if its mask is set and its sender lies in the receiver tile's window;
// the caller sums the other edges itself (ops/edgeconv_kernel.py).
//
// The TPU kernel copies each tile's whole window into on-chip memory and
// gathers from it with a one-hot matrix product, because a row gather costs
// the TPU an instruction per row. Neither is carried over: at tile 256, half
// 384 and d = 64 the window is 256 KB, more than the 227 KB of shared memory
// a block can have, and on this card a row of d floats is a coalesced read
// that, with rows in Morton order, mostly hits the L2 cache. So rows are read
// straight from global memory as 16-byte vectors.
//
// What bounds it: bytes. Per receiver row it reads k sender rows of 4 d bytes
// (from L2 when the tile's neighbours are close in row order, each vpad row
// from device memory once), reads u and idx, and writes d floats: at n = 1M,
// k = 8, d = 64 about 0.81 GB against 0.5 G tanhf evaluations.
//
// Design: one thread per (receiver row, 4 channels), d / 4 neighbouring
// threads on one row, so a row's read is one coalesced 4 d-byte segment and
// its idx and mask reads broadcast. The loop over k runs in slot order and
// each output element has one writer: no atomics, the same bits on every
// run. tanhf is the full-precision one (the file is built without
// --use_fast_math). With round_bf16 the gathered values are rounded to
// bfloat16 (nearest even) before the add, u and the sum stay float32: the
// TPU kernel's mxu_dtype=bfloat16 mode.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool BF16>
__global__ void windowed_tanh_sum_kernel(
    const float4* __restrict__ u, const float4* __restrict__ vpad,
    const int* __restrict__ idx, const uint8_t* __restrict__ mask,
    long long total, int d4, int k, int tile, int half,
    float4* __restrict__ out) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= total) return;
  const long long row = t / d4;
  const int c = (int)(t - row * d4);
  const long long tile_start = (row / tile) * tile;
  const long long w = (long long)tile + 2LL * half;
  const float4 ui = u[t];
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const int* irow = idx + row * k;
  const uint8_t* mrow = mask + row * k;
  for (int e = 0; e < k; ++e) {
    const long long j = irow[e];
    const long long r = j - tile_start + half;
    if (!mrow[e] || r < 0 || r >= w) continue;
    float4 v = vpad[(j + half) * d4 + c];
    if (BF16) {
      v.x = round_bf16(v.x);
      v.y = round_bf16(v.y);
      v.z = round_bf16(v.z);
      v.w = round_bf16(v.w);
    }
    acc.x += tanhf(ui.x + v.x);
    acc.y += tanhf(ui.y + v.y);
    acc.z += tanhf(ui.z + v.z);
    acc.w += tanhf(ui.w + v.w);
  }
  out[t] = acc;
}

}  // namespace

extern "C" {

// out (n, d) = the masked in-window tanh sums; u (n, d), vpad (n + 2 * half,
// d), idx (n, k) int32, mask (n, k) bytes. d must be a multiple of 4 and n of
// tile (the wrapper checks both; here they return an error code).
int edgeconv_windowed_tanh_sum(const void* u, const void* vpad, const int* idx,
                               const uint8_t* mask, int n, int d, int k,
                               int tile, int half, int bf16, void* out,
                               void* stream) {
  if (n <= 0 || d <= 0 || d % 4 || k <= 0 || tile <= 0 || half < 0 || n % tile)
    return (int)cudaErrorInvalidValue;
  const int d4 = d / 4;
  const long long total = (long long)n * d4;
  const long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    windowed_tanh_sum_kernel<true><<<(unsigned)blocks, THREADS, 0, s>>>(
        (const float4*)u, (const float4*)vpad, idx, mask, total, d4, k, tile,
        half, (float4*)out);
  else
    windowed_tanh_sum_kernel<false><<<(unsigned)blocks, THREADS, 0, s>>>(
        (const float4*)u, (const float4*)vpad, idx, mask, total, d4, k, tile,
        half, (float4*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
