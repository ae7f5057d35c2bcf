// Continuous-convolution collect (B3) for Hopper (sm_90a), with a plain C
// interface bound from Python by ctypes (nbody_tpu_torch/ops/build.py,
// nbody_tpu_torch/ops/contconv_kernel.py).
//
// Replaces nbody_tpu/ops/contconv_kernel.py::_collect_kernel (Pallas, TPU):
//
//   out[m, :] = sum_e window[m, e] * feat_j[m, e, :] @ T(F at (gx, gy, gz)[m, e])
//
// where T is the trilinear interpolation of the (D^3, ci, co) filter bank F at
// the edge's grid coordinates, clamped to [0, D-1] (the lower corner is
// min(floor(c), D-2), as in ops/interpolate.py). Sum over the k edges; the
// caller divides by the edge count for a mean. Because interpolation and the
// sum are linear, the kernel first collects every receiver's window- and
// corner-weighted features into bins g[m, cell, :] and then multiplies g by F,
// which is what the plain-torch twin (ops/contconv_kernel.py) computes with a
// one-hot einsum and one matrix product. It does not copy the TPU kernel's
// tent-factorised blocking.
//
// What bounds it: the product, N * D^3 * ci * co FP32 FMAs a layer (3.5e11 at
// N = 100k, D = 6, ci = co = 128; 1.0e11 at D = 4), computed in registers with
// both operands in shared memory. Each block reads the rows of F for the
// cells its edges touch (at most the whole 14.2 MB D = 6 bank, which the 50 MB
// L2 holds), so L2 traffic is at most (N / T) * |F|; the gathered features
// are read once for each of an edge's 8 corner cells. Tensor cores are not
// used: the contract is full FP32, and TF32 keeps about three decimal digits.
//
// Design: one block of 256 threads per tile of T = 64 receivers; the filter
// bank is walked one cell (ci consecutive rows of F) at a time.
//   0. Once per tile: each edge's descriptor (lower corner, fractions,
//      window) and the list, in cell order, of the cells any edge of the tile
//      touches (an edge touches its 8 corner cells). Edges with window == 0
//      (padding, outside the radius) add nothing and are dropped here.
//   1. Per touched cell, the cell's F rows are copied into shared memory with
//      cp.async, double-buffered: the next cell's copy runs during this
//      cell's work.
//   2. Each warp marks, by ballot, which edges of its receivers touch the
//      cell; thread (t, c) then sums w * wx * wy * wz * feat_j[t, e, c] over
//      receiver t's touching edges in edge order and stores the bin g[t, c].
//      Every bin has one writer: no atomics, the same sums on every run. The
//      feature loads (L2 or device memory: a tile's rows, 1 MB, are read
//      again for each corner cell) go out 8 edges at a time, so that
//      their latencies overlap.
//   3. Every thread accumulates an 8-receiver x 4-column register tile of
//      out over the cell's ci rows: bins as 16-byte broadcasts, F as one
//      16-byte read of 4 consecutive columns a lane.
// T = 64 is what fits: the two F buffers (128 KB at ci = co = 128), the bins
// (32 KB) and the edge descriptors (40 KB at k = 32) take ~201 KB of the
// 227 KB a block may use. The 8 x 4 tile makes each shared-memory read feed
// 8 FMAs, so the product is bound by FMA throughput, not by shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CT = 64;        // receivers per block
constexpr int THREADS = 256;  // 8 warps
constexpr int T_PER = 8;      // receivers per thread in the product
constexpr int MAX_K = 64;     // two 32-bit touch words per receiver
constexpr int MAX_CO = 128;   // one float4 of columns a lane
constexpr int MAX_D = 10;     // cell flags and list in shared memory
constexpr int BATCH = 8;      // feature loads in flight per thread
constexpr int MAX_SMEM = 232448;  // bytes a block may use on sm_90

static_assert(CT == T_PER * (THREADS / 32), "one receiver group per warp");

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

struct Layout {  // byte offsets of the dynamic shared memory
  size_t fs, g, dfw, dxyz, touch, cells, flags, total;
  __host__ __device__ Layout(int d, int ci, int co, int k) {
    const int gs = round4(ci), cp = round4(co), kw = (k + 31) / 32;
    const int nc = d * d * d;
    fs = 0;                                          // 2 x (gs, cp) F rows
    g = fs + (size_t)2 * gs * cp * sizeof(float);    // (T, gs) bins
    dfw = g + (size_t)CT * gs * sizeof(float);       // (T*k) fx fy fz w
    dxyz = dfw + (size_t)CT * k * sizeof(float4);    // (T*k) lower corner
    touch = dxyz + (size_t)CT * k * sizeof(int);     // (T, kw) masks
    cells = touch + (size_t)CT * kw * sizeof(uint32_t);  // count + list
    flags = cells + (size_t)(nc + 1) * sizeof(int);
    total = flags + (size_t)nc;
  }
};

__device__ __forceinline__ void copy16_async(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void load_cell_async(float* dst, const float* F,
                                                int cell, int ci, int cp) {
  const float* src = F + (size_t)cell * ci * cp;
  for (int q = threadIdx.x; q < ci * cp / 4; q += THREADS)
    copy16_async(dst + 4 * q, src + 4 * q);
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ float lerp_w(int at, int lo, float f) {
  return at == lo ? 1.f - f : f;
}

__global__ void __launch_bounds__(THREADS)
collect_kernel(const float* __restrict__ gx, const float* __restrict__ gy,
               const float* __restrict__ gz, const float* __restrict__ win,
               const float* __restrict__ feat, const float* __restrict__ F,
               int M, int k, int ci, int co, int d, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  unsigned char* base = (unsigned char*)smem4;
  const Layout L(d, ci, co, k);
  const int GS = round4(ci), CP = round4(co), KW = (k + 31) / 32;
  const int NC = d * d * d;
  float* fs = (float*)(base + L.fs);
  float* g = (float*)(base + L.g);
  float4* dfw = (float4*)(base + L.dfw);
  int* dxyz = (int*)(base + L.dxyz);
  uint32_t* touch = (uint32_t*)(base + L.touch);
  int* cells = (int*)(base + L.cells);  // cells[0] = count, then the list
  unsigned char* flags = base + L.flags;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.x * CT;
  const float hi = (float)(d - 1);

  // zero the cell flags, the bins' pad columns and the F buffers' pad rows
  for (int i = tid; i < NC; i += THREADS) flags[i] = 0;
  for (int i = tid; i < CT * (GS - ci); i += THREADS)
    g[(i / (GS - ci)) * GS + ci + i % (GS - ci)] = 0.f;
  for (int i = tid; i < 2 * (GS - ci) * CP; i += THREADS) {
    const int b = i / ((GS - ci) * CP), r = i % ((GS - ci) * CP);
    fs[(size_t)b * GS * CP + (size_t)ci * CP + r] = 0.f;
  }
  __syncthreads();

  // 0. edge descriptors: lower corner x | y << 8 | z << 16 (-1: adds
  // nothing) and (fx, fy, fz, window); flag the 8 corner cells
  for (int e = tid; e < CT * k; e += THREADS) {
    int xyz = -1;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m0 + e / k < M) {
      const size_t at = (size_t)m0 * k + e;
      const float w = win[at];
      if (w != 0.f) {
        const float cx = fminf(fmaxf(gx[at], 0.f), hi);
        const float cy = fminf(fmaxf(gy[at], 0.f), hi);
        const float cz = fminf(fmaxf(gz[at], 0.f), hi);
        const float x0 = fminf(floorf(cx), (float)(d - 2));
        const float y0 = fminf(floorf(cy), (float)(d - 2));
        const float z0 = fminf(floorf(cz), (float)(d - 2));
        const int ix = (int)x0, iy = (int)y0, iz = (int)z0;
        xyz = ix | (iy << 8) | (iz << 16);
        v = make_float4(cx - x0, cy - y0, cz - z0, w);
        for (int o = 0; o < 8; ++o)  // the same value from every writer
          flags[((ix + (o >> 2)) * d + iy + ((o >> 1) & 1)) * d + iz + (o & 1)] = 1;
      }
    }
    dxyz[e] = xyz;
    dfw[e] = v;
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int c = 0; c < NC; ++c)
      if (flags[c]) cells[1 + n++] = c;
    cells[0] = n;
  }
  __syncthreads();
  const int ncell = cells[0];

  float acc[T_PER][4];
#pragma unroll
  for (int i = 0; i < T_PER; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  if (ncell > 0) load_cell_async(fs, F, cells[1], ci, CP);
  for (int n = 0; n < ncell; ++n) {
    const int cell = cells[1 + n];
    const float* fb = fs + (size_t)(n & 1) * GS * CP;
    if (n + 1 < ncell)  // the other buffer was last read before the barrier
      load_cell_async(fs + (size_t)((n + 1) & 1) * GS * CP, F, cells[2 + n], ci, CP);
    const int x = cell / (d * d), y = (cell / d) % d, z = cell % d;

    // 2a. which edges touch this cell
    for (int t = warp; t < CT; t += THREADS / 32) {
      for (int w = 0; w < KW; ++w) {
        const int e = w * 32 + lane;
        bool hit = false;
        if (e < k) {
          const int xyz = dxyz[t * k + e];
          if (xyz >= 0) {
            const int x0 = xyz & 255, y0 = (xyz >> 8) & 255, z0 = xyz >> 16;
            hit = (unsigned)(x - x0) <= 1u && (unsigned)(y - y0) <= 1u &&
                  (unsigned)(z - z0) <= 1u;
          }
        }
        const uint32_t bits = __ballot_sync(0xffffffffu, hit);
        if (lane == 0) touch[t * KW + w] = bits;
      }
    }
    __syncthreads();

    // 2b. bins g[t, c] of this cell, one writer each
    for (int p = tid; p < CT * ci; p += THREADS) {
      const int t = p / ci;
      const int c = p - t * ci;
      const float* ft = feat + (size_t)(m0 + t) * k * ci + c;
      float s = 0.f;
      for (int w = 0; w < KW; ++w) {
        uint32_t bits = touch[t * KW + w];
        while (bits) {
          // up to BATCH edges at a time: their feature loads are independent
          // and in flight together
          int es[BATCH];
          float fv[BATCH];
#pragma unroll
          for (int u = 0; u < BATCH; ++u) {
            es[u] = bits ? w * 32 + __ffs(bits) - 1 : -1;
            bits &= bits - 1u;
          }
#pragma unroll
          for (int u = 0; u < BATCH; ++u)
            fv[u] = es[u] >= 0 ? ft[(size_t)es[u] * ci] : 0.f;
#pragma unroll
          for (int u = 0; u < BATCH; ++u) {
            if (es[u] < 0) break;
            const int xyz = dxyz[t * k + es[u]];
            const float4 v = dfw[t * k + es[u]];
            const float wt = v.w * lerp_w(x, xyz & 255, v.x) *
                             lerp_w(y, (xyz >> 8) & 255, v.y) *
                             lerp_w(z, xyz >> 16, v.z);
            s = fmaf(wt, fv[u], s);  // in edge order
          }
        }
      }
      g[t * GS + c] = s;
    }
    if (n + 1 < ncell)
      asm volatile("cp.async.wait_group 1;\n" ::);
    else
      asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();

    // 3. out[t, :] += g[t, :] @ F[cell rows, :]
    const float* gw = g + warp * T_PER * GS;
    const bool on = 4 * lane < CP;
    for (int r = 0; r < GS; r += 4) {
      float4 gv[T_PER];
#pragma unroll
      for (int i = 0; i < T_PER; ++i) gv[i] = *(const float4*)(gw + i * GS + r);
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const float4 f = on ? *(const float4*)(fb + (size_t)(r + rr) * CP + 4 * lane)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int i = 0; i < T_PER; ++i) {
          const float gi = rr == 0 ? gv[i].x : rr == 1 ? gv[i].y
                         : rr == 2 ? gv[i].z : gv[i].w;
          acc[i][0] = fmaf(gi, f.x, acc[i][0]);
          acc[i][1] = fmaf(gi, f.y, acc[i][1]);
          acc[i][2] = fmaf(gi, f.z, acc[i][2]);
          acc[i][3] = fmaf(gi, f.w, acc[i][3]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < T_PER; ++i) {
    const int m = m0 + warp * T_PER + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 4 * lane + j;
      if (col < co) out[(size_t)m * co + col] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// out (M, co) = the collect of gx, gy, gz, win (M, k), feat (M, k, ci) and the
// filter bank F (d^3 * ci, round4(co)) with zero pad columns, all float32 and
// contiguous; F 16-byte aligned. Returns cudaErrorInvalidValue, and launches
// nothing, for a shape outside the limits or above MAX_SMEM shared bytes.
int contconv_collect(const float* gx, const float* gy, const float* gz,
                     const float* win, const float* feat, const float* F,
                     int M, int k, int ci, int co, int d, float* out,
                     void* stream) {
  if (M <= 0 || k <= 0 || k > MAX_K || ci <= 0 || co <= 0 || co > MAX_CO ||
      d < 2 || d > MAX_D || ((uintptr_t)F & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = Layout(d, ci, co, k).total;
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      collect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + CT - 1) / CT);
  collect_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      gx, gy, gz, win, feat, F, M, k, ci, co, d, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
