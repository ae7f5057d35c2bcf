// Continuous-convolution collect (B3) and its backward (B4 filters, B5
// features, B6 geometry) for Hopper (sm_90a), with a plain C interface bound
// from Python by ctypes (nbody_tpu_torch/ops/build.py,
// nbody_tpu_torch/ops/contconv_kernel.py).
//
// B3 replaces nbody_tpu/ops/contconv_kernel.py::_collect_kernel (Pallas, TPU):
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
//
// The backward (the Pallas _bwd_filters_kernel, _bwd_feat_kernel and
// _bwd_geom_kernel, the custom VJP of contconv_collect) reuses steps 0-3. It
// saves nothing from the forward: each kernel rebuilds the edge descriptors
// and weights of its tile from the inputs, as the JAX VJP does.
//
// B4, dF[cell] = sum_m g[m, cell, :]^T dout[m, :]: one block per (cell, chunk
//   of receiver tiles, 128-row slab of ci). For each tile of its chunk the
//   block rebuilds the descriptors (step 0), marks and fills the bins of its
//   one cell (step 2, skipping tiles that do not touch it), stages the
//   tile's dout rows and adds g^T dout to a (128 x 128) tile of dF held in
//   registers, 8 x 8 a thread. Chunks write partial banks and a second
//   kernel sums them in chunk order: deterministic, no float atomics. Bound:
//   the same FMAs as B3, plus a re-read of the tile's geometry and dout for
//   every cell (D^3 times); partial banks (at most ~1056 blocks' worth,
//   71 MB at D = 6 or 4) are sized by the wrapper.
// B5, dfeat[m, e] = window * sum_corners w * (F_cell @ dout[m]): B3's walk
//   over touched cells with the roles of the operands swapped. The block
//   stages its tile's dout rows once, streams F^T (co rows of ci columns a
//   cell, transposed by the wrapper) with the same double-buffered cp.async,
//   and step 3 leaves dG[t, cell, :] = F_cell @ dout[t] in registers (8
//   receivers x 4 columns a thread). Each thread then adds w * dG to the
//   dfeat rows of its receivers' touching edges: every dfeat element has
//   one writer, and the cells are walked in a fixed order.
// B6, the geometry cotangents: B5's walk over cells (zero-window edges kept:
//   d(out)/d(window) does not vanish there), then per touching edge and
//   corner s = feat_j[m, e] . dG_cell[m], a warp-wide dot reduced by a
//   fixed shuffle butterfly, and lane 0 of the receiver's warp adds
//   dwin += w s, dgx += window * dwx * wy * wz * s (dgy, dgz alike). tent' is
//   JAX's _dtent: -sign(u) on |u| < 1, so 0 at integer grid coordinates and
//   on the clamped edges, which is JAX's clip mask as well.

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
constexpr int SLAB = 128;     // B4: rows (of ci) and columns (co) of a dF tile

static_assert(CT == T_PER * (THREADS / 32), "one receiver group per warp");
static_assert(THREADS == (SLAB / 8) * (SLAB / 8), "B4: an 8 x 8 dF tile a thread");

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// Byte offsets of the dynamic shared memory of B3, B5 and B6: the left
// operand of step 3 is (T, round4(rows)) (B3: the bins, rows = ci; B5/B6: the
// tile's dout rows, rows = co) and F is streamed as `rows` rows of `cols`
// columns a cell (B3: F, cols = co; B5/B6: F^T, cols = ci).
struct Layout {
  size_t fs, g, dfw, dxyz, touch, cells, flags, total;
  __host__ __device__ Layout(int d, int rows, int cols, int k) {
    const int gs = round4(rows), cp = round4(cols), kw = (k + 31) / 32;
    const int nc = d * d * d;
    fs = 0;                                          // 2 x (gs, cp) F rows
    g = fs + (size_t)2 * gs * cp * sizeof(float);    // (T, gs) left operand
    dfw = g + (size_t)CT * gs * sizeof(float);       // (T*k) fx fy fz w
    dxyz = dfw + (size_t)CT * k * sizeof(float4);    // (T*k) lower corner
    touch = dxyz + (size_t)CT * k * sizeof(int);     // (T, kw) masks
    cells = touch + (size_t)CT * kw * sizeof(uint32_t);  // count + list
    flags = cells + (size_t)(nc + 1) * sizeof(int);
    total = flags + (size_t)nc;
  }
};

// B4's shared memory: bins and dout rows of one tile, its edge descriptors.
struct LayoutF {
  size_t g, dout, dfw, dxyz, touch, total;
  __host__ __device__ LayoutF(int k) {
    const int kw = (k + 31) / 32;
    g = 0;                                            // (T, SLAB) bins
    dout = g + (size_t)CT * SLAB * sizeof(float);     // (T, SLAB) dout rows
    dfw = dout + (size_t)CT * SLAB * sizeof(float);
    dxyz = dfw + (size_t)CT * k * sizeof(float4);
    touch = dxyz + (size_t)CT * k * sizeof(int);
    total = touch + (size_t)CT * kw * sizeof(uint32_t);
  }
};

__device__ __forceinline__ void copy16_async(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// the `rows` rows (of cp floats) of one cell of a row-blocked bank
__device__ __forceinline__ void load_cell_async(float* dst, const float* F,
                                                int cell, int rows, int cp) {
  const float* src = F + (size_t)cell * rows * cp;
  for (int q = threadIdx.x; q < rows * cp / 4; q += THREADS)
    copy16_async(dst + 4 * q, src + 4 * q);
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ float lerp_w(int at, int lo, float f) {
  return at == lo ? 1.f - f : f;
}

// d(lerp_w)/d(coordinate), JAX's _dtent: 0 where the fraction is 0 or 1
__device__ __forceinline__ float lerp_dw(int at, int lo, float f) {
  if (!(f > 0.f && f < 1.f)) return 0.f;
  return at == lo ? -1.f : 1.f;
}

// 0. Edge descriptors of the tile at m0: lower corner x | y << 8 | z << 16
// (-1: adds nothing) and (fx, fy, fz, window); flags the 8 corner cells when
// `flags` is given. Zero-window edges are dropped unless keep_zero.
__device__ void build_edges(const float* __restrict__ gx, const float* __restrict__ gy,
                            const float* __restrict__ gz, const float* __restrict__ win,
                            int M, int k, int d, int m0, int* dxyz, float4* dfw,
                            unsigned char* flags, bool keep_zero) {
  const float hi = (float)(d - 1);
  for (int e = threadIdx.x; e < CT * k; e += THREADS) {
    int xyz = -1;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m0 + e / k < M) {
      const size_t at = (size_t)m0 * k + e;
      const float w = win[at];
      if (w != 0.f || keep_zero) {
        const float cx = fminf(fmaxf(gx[at], 0.f), hi);
        const float cy = fminf(fmaxf(gy[at], 0.f), hi);
        const float cz = fminf(fmaxf(gz[at], 0.f), hi);
        const float x0 = fminf(floorf(cx), (float)(d - 2));
        const float y0 = fminf(floorf(cy), (float)(d - 2));
        const float z0 = fminf(floorf(cz), (float)(d - 2));
        const int ix = (int)x0, iy = (int)y0, iz = (int)z0;
        xyz = ix | (iy << 8) | (iz << 16);
        v = make_float4(cx - x0, cy - y0, cz - z0, w);
        if (flags)
          for (int o = 0; o < 8; ++o)  // the same value from every writer
            flags[((ix + (o >> 2)) * d + iy + ((o >> 1) & 1)) * d + iz + (o & 1)] = 1;
      }
    }
    dxyz[e] = xyz;
    dfw[e] = v;
  }
}

// the touched cells in cell order: cells[0] = count, then the list
__device__ void list_cells(const unsigned char* flags, int* cells, int nc) {
  if (threadIdx.x == 0) {
    int n = 0;
    for (int c = 0; c < nc; ++c)
      if (flags[c]) cells[1 + n++] = c;
    cells[0] = n;
  }
}

// 2a. which edges of each receiver touch cell (x, y, z), one bit an edge;
// returns whether any edge of this warp's receivers does
__device__ bool mark_touch(int x, int y, int z, const int* dxyz, uint32_t* touch,
                           int k, int kw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bool any = false;
  for (int t = warp; t < CT; t += THREADS / 32) {
    for (int w = 0; w < kw; ++w) {
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
      if (lane == 0) touch[t * kw + w] = bits;
      any = any || bits != 0u;
    }
  }
  return any;
}

// the trilinear weight (times the window) of cell (x, y, z) for an edge
__device__ __forceinline__ float edge_weight(int x, int y, int z, int xyz, float4 v) {
  return v.w * lerp_w(x, xyz & 255, v.x) * lerp_w(y, (xyz >> 8) & 255, v.y) *
         lerp_w(z, xyz >> 16, v.z);
}

// 2b. bins g[t, c] (row stride gs) of cell (x, y, z) for feature columns
// c0 .. c0 + nc, one writer each, summed in edge order
__device__ void fill_bins(int x, int y, int z, const float* __restrict__ feat, int m0,
                          int k, int ci, int c0, int nc, int gs, const int* dxyz,
                          const float4* dfw, const uint32_t* touch, int kw, float* g) {
  for (int p = threadIdx.x; p < CT * nc; p += THREADS) {
    const int t = p / nc;
    const int c = p - t * nc;
    const float* ft = feat + (size_t)(m0 + t) * k * ci + c0 + c;
    float s = 0.f;
    for (int w = 0; w < kw; ++w) {
      uint32_t bits = touch[t * kw + w];
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
          const float wt = edge_weight(x, y, z, dxyz[t * k + es[u]], dfw[t * k + es[u]]);
          s = fmaf(wt, fv[u], s);  // in edge order
        }
      }
    }
    g[t * gs + c] = s;
  }
}

// 3. acc[i][:] += left[i, :] @ fb[:, 4 lane .. 4 lane + 3] over the gs rows
// of fb (row stride cp) for this warp's 8 receivers (left row stride gs)
__device__ __forceinline__ void product(float (&acc)[T_PER][4], const float* gw,
                                        const float* fb, int gs, int cp) {
  const int lane = threadIdx.x & 31;
  const bool on = 4 * lane < cp;
  for (int r = 0; r < gs; r += 4) {
    float4 gv[T_PER];
#pragma unroll
    for (int i = 0; i < T_PER; ++i) gv[i] = *(const float4*)(gw + i * gs + r);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const float4 f = on ? *(const float4*)(fb + (size_t)(r + rr) * cp + 4 * lane)
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
}

__device__ __forceinline__ void zero_acc(float (&acc)[T_PER][4]) {
#pragma unroll
  for (int i = 0; i < T_PER; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
}

__device__ __forceinline__ void wait_cell(bool more) {
  if (more)
    asm volatile("cp.async.wait_group 1;\n" ::);
  else
    asm volatile("cp.async.wait_group 0;\n" ::);
}

// Shared set-up of B5 and B6: zero the flags and F's pad rows, stage the
// tile's dout rows (zero-padded), build the descriptors and the cell list.
__device__ int setup_dout_walk(const float* gx, const float* gy, const float* gz,
                               const float* win, const float* __restrict__ dout,
                               int M, int k, int ci, int co, int d, bool keep_zero,
                               unsigned char* base, const Layout& L) {
  const int GS = round4(co), CP = round4(ci), NC = d * d * d;
  const int tid = threadIdx.x, m0 = blockIdx.x * CT;
  float* fs = (float*)(base + L.fs);
  float* g = (float*)(base + L.g);
  int* cells = (int*)(base + L.cells);
  unsigned char* flags = base + L.flags;
  for (int i = tid; i < NC; i += THREADS) flags[i] = 0;
  for (int i = tid; i < 2 * (GS - co) * CP; i += THREADS) {
    const int b = i / ((GS - co) * CP), r = i % ((GS - co) * CP);
    fs[(size_t)b * GS * CP + (size_t)co * CP + r] = 0.f;
  }
  for (int i = tid; i < CT * GS; i += THREADS) {
    const int t = i / GS, r = i - t * GS;
    g[i] = (m0 + t < M && r < co) ? dout[(size_t)(m0 + t) * co + r] : 0.f;
  }
  __syncthreads();
  build_edges(gx, gy, gz, win, M, k, d, m0, (int*)(base + L.dxyz),
              (float4*)(base + L.dfw), flags, keep_zero);
  __syncthreads();
  list_cells(flags, cells, NC);
  __syncthreads();
  return cells[0];
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
  int* cells = (int*)(base + L.cells);
  unsigned char* flags = base + L.flags;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.x * CT;

  // zero the cell flags, the bins' pad columns and the F buffers' pad rows
  for (int i = tid; i < NC; i += THREADS) flags[i] = 0;
  for (int i = tid; i < CT * (GS - ci); i += THREADS)
    g[(i / (GS - ci)) * GS + ci + i % (GS - ci)] = 0.f;
  for (int i = tid; i < 2 * (GS - ci) * CP; i += THREADS) {
    const int b = i / ((GS - ci) * CP), r = i % ((GS - ci) * CP);
    fs[(size_t)b * GS * CP + (size_t)ci * CP + r] = 0.f;
  }
  __syncthreads();

  build_edges(gx, gy, gz, win, M, k, d, m0, dxyz, dfw, flags, false);
  __syncthreads();
  list_cells(flags, cells, NC);
  __syncthreads();
  const int ncell = cells[0];

  float acc[T_PER][4];
  zero_acc(acc);

  if (ncell > 0) load_cell_async(fs, F, cells[1], ci, CP);
  for (int n = 0; n < ncell; ++n) {
    const int cell = cells[1 + n];
    const float* fb = fs + (size_t)(n & 1) * GS * CP;
    if (n + 1 < ncell)  // the other buffer was last read before the barrier
      load_cell_async(fs + (size_t)((n + 1) & 1) * GS * CP, F, cells[2 + n], ci, CP);
    const int x = cell / (d * d), y = (cell / d) % d, z = cell % d;

    mark_touch(x, y, z, dxyz, touch, k, KW);
    __syncthreads();
    fill_bins(x, y, z, feat, m0, k, ci, 0, ci, GS, dxyz, dfw, touch, KW, g);
    wait_cell(n + 1 < ncell);
    __syncthreads();
    product(acc, g + warp * T_PER * GS, fb, GS, CP);  // out += g @ F_cell
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

// B4: one (cell, chunk, ci slab) a block; dF tile rows {4 ty + i, 64 + 4 ty +
// i} and columns {4 tx + j, 64 + 4 tx + j} a thread
__global__ void __launch_bounds__(THREADS)
bwd_filters_kernel(const float* __restrict__ gx, const float* __restrict__ gy,
                   const float* __restrict__ gz, const float* __restrict__ win,
                   const float* __restrict__ feat, const float* __restrict__ dout,
                   int M, int k, int ci, int co, int d, int nchunk,
                   float* __restrict__ dst) {
  extern __shared__ float4 smem4[];
  unsigned char* base = (unsigned char*)smem4;
  const LayoutF L(k);
  const int KW = (k + 31) / 32, NC = d * d * d;
  float* g = (float*)(base + L.g);
  float* ds = (float*)(base + L.dout);
  float4* dfw = (float4*)(base + L.dfw);
  int* dxyz = (int*)(base + L.dxyz);
  uint32_t* touch = (uint32_t*)(base + L.touch);

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int cell = blockIdx.x, chunk = blockIdx.y;
  const int c0 = blockIdx.z * SLAB, nc = min(SLAB, ci - c0);
  const int x = cell / (d * d), y = (cell / d) % d, z = cell % d;
  const int ntiles = (M + CT - 1) / CT;
  const int t0 = (int)((long long)chunk * ntiles / nchunk);
  const int t1 = (int)((long long)(chunk + 1) * ntiles / nchunk);

  for (int i = tid; i < CT * (SLAB - nc); i += THREADS)  // bins' pad columns
    g[(i / (SLAB - nc)) * SLAB + nc + i % (SLAB - nc)] = 0.f;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int tile = t0; tile < t1; ++tile) {
    const int m0 = tile * CT;
    build_edges(gx, gy, gz, win, M, k, d, m0, dxyz, dfw, nullptr, false);
    __syncthreads();
    if (!__syncthreads_or(mark_touch(x, y, z, dxyz, touch, k, KW))) continue;
    fill_bins(x, y, z, feat, m0, k, ci, c0, nc, SLAB, dxyz, dfw, touch, KW, g);
    for (int i = tid; i < CT * SLAB; i += THREADS) {
      const int t = i / SLAB, c = i - t * SLAB;
      ds[i] = (m0 + t < M && c < co) ? dout[(size_t)(m0 + t) * co + c] : 0.f;
    }
    __syncthreads();
    for (int t = 0; t < CT; ++t) {  // acc += g[t, rows]^T dout[t, cols]
      const float4 ga = *(const float4*)(g + t * SLAB + 4 * ty);
      const float4 gb = *(const float4*)(g + t * SLAB + 64 + 4 * ty);
      const float4 da = *(const float4*)(ds + t * SLAB + 4 * tx);
      const float4 db = *(const float4*)(ds + t * SLAB + 64 + 4 * tx);
      const float gr[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
      const float dc[8] = {da.x, da.y, da.z, da.w, db.x, db.y, db.z, db.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(gr[i], dc[j], acc[i][j]);
    }
    __syncthreads();
  }

  // dst: the chunk's partial bank (nchunk > 1) or dF itself, (NC, ci, co)
  float* bank = dst + (size_t)chunk * NC * ci * co;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = c0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (r >= ci) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4;
      if (col < co) bank[((size_t)cell * ci + r) * co + col] = acc[i][j];
    }
  }
}

// dF = the partial banks summed in chunk order
__global__ void sum_banks_kernel(const float* __restrict__ part, int nchunk, size_t n,
                                 float* __restrict__ out) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int j = 0; j < nchunk; ++j) s += part[(size_t)j * n + i];
    out[i] = s;
  }
}

// B5: dfeat (M, k, ci); FT (d^3 * co, round4(ci)) zero-padded columns
__global__ void __launch_bounds__(THREADS)
bwd_feat_kernel(const float* __restrict__ gx, const float* __restrict__ gy,
                const float* __restrict__ gz, const float* __restrict__ win,
                const float* __restrict__ dout, const float* __restrict__ FT,
                int M, int k, int ci, int co, int d, float* __restrict__ dfeat) {
  extern __shared__ float4 smem4[];
  unsigned char* base = (unsigned char*)smem4;
  const Layout L(d, co, ci, k);
  const int GS = round4(co), CP = round4(ci), KW = (k + 31) / 32;
  float* fs = (float*)(base + L.fs);
  const float* g = (const float*)(base + L.g);
  const float4* dfw = (const float4*)(base + L.dfw);
  const int* dxyz = (const int*)(base + L.dxyz);
  uint32_t* touch = (uint32_t*)(base + L.touch);
  const int* cells = (const int*)(base + L.cells);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = blockIdx.x * CT;
  // 16-byte row updates need ci % 4 == 0 and a 16-byte aligned base
  const bool vec = (ci & 3) == 0 && ((uintptr_t)dfeat & 15u) == 0;

  // every dfeat element of this thread starts at 0 (zero-window edges stay so)
#pragma unroll
  for (int i = 0; i < T_PER; ++i) {
    const int m = m0 + warp * T_PER + i;
    if (m >= M) continue;
    for (int e = 0; e < k; ++e)
      for (int j = 0; j < 4; ++j)
        if (4 * lane + j < ci) dfeat[((size_t)m * k + e) * ci + 4 * lane + j] = 0.f;
  }
  const int ncell = setup_dout_walk(gx, gy, gz, win, dout, M, k, ci, co, d, false,
                                    base, L);

  float acc[T_PER][4];
  if (ncell > 0) load_cell_async(fs, FT, cells[1], co, CP);
  for (int n = 0; n < ncell; ++n) {
    const int cell = cells[1 + n];
    const float* fb = fs + (size_t)(n & 1) * GS * CP;
    if (n + 1 < ncell)
      load_cell_async(fs + (size_t)((n + 1) & 1) * GS * CP, FT, cells[2 + n], co, CP);
    const int x = cell / (d * d), y = (cell / d) % d, z = cell % d;
    mark_touch(x, y, z, dxyz, touch, k, KW);
    wait_cell(n + 1 < ncell);
    __syncthreads();
    zero_acc(acc);
    product(acc, g + warp * T_PER * GS, fb, GS, CP);  // dG = dout @ F_cell^T

#pragma unroll
    for (int i = 0; i < T_PER; ++i) {
      const int t = warp * T_PER + i, m = m0 + t;
      if (m >= M) continue;
      for (int w = 0; w < KW; ++w) {
        uint32_t bits = touch[t * KW + w];
        while (bits) {
          const int e = w * 32 + __ffs(bits) - 1;
          bits &= bits - 1u;
          const float wt = edge_weight(x, y, z, dxyz[t * k + e], dfw[t * k + e]);
          float* p = dfeat + ((size_t)m * k + e) * ci + 4 * lane;
          if (vec) {
            if (4 * lane < ci) {
              float4 a = *(float4*)p;
              a.x = fmaf(wt, acc[i][0], a.x);
              a.y = fmaf(wt, acc[i][1], a.y);
              a.z = fmaf(wt, acc[i][2], a.z);
              a.w = fmaf(wt, acc[i][3], a.w);
              *(float4*)p = a;
            }
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (4 * lane + j < ci) p[j] = fmaf(wt, acc[i][j], p[j]);
          }
        }
      }
    }
    __syncthreads();
  }
}

// B6: dgx, dgy, dgz, dwin (M, k)
__global__ void __launch_bounds__(THREADS)
bwd_geom_kernel(const float* __restrict__ gx, const float* __restrict__ gy,
                const float* __restrict__ gz, const float* __restrict__ win,
                const float* __restrict__ feat, const float* __restrict__ dout,
                const float* __restrict__ FT, int M, int k, int ci, int co, int d,
                float* __restrict__ dgx, float* __restrict__ dgy,
                float* __restrict__ dgz, float* __restrict__ dwin) {
  extern __shared__ float4 smem4[];
  unsigned char* base = (unsigned char*)smem4;
  const Layout L(d, co, ci, k);
  const int GS = round4(co), CP = round4(ci), KW = (k + 31) / 32;
  float* fs = (float*)(base + L.fs);
  const float* g = (const float*)(base + L.g);
  const float4* dfw = (const float4*)(base + L.dfw);
  const int* dxyz = (const int*)(base + L.dxyz);
  uint32_t* touch = (uint32_t*)(base + L.touch);
  const int* cells = (const int*)(base + L.cells);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = blockIdx.x * CT;
  // 16-byte feature reads need ci % 4 == 0 and a 16-byte aligned base
  const bool vec = (ci & 3) == 0 && ((uintptr_t)feat & 15u) == 0;

  for (int e = threadIdx.x; e < CT * k; e += THREADS) {
    if (m0 + e / k >= M) break;
    const size_t at = (size_t)m0 * k + e;
    dgx[at] = dgy[at] = dgz[at] = dwin[at] = 0.f;
  }  // visible to lane 0 of every warp after the set-up's barriers
  const int ncell = setup_dout_walk(gx, gy, gz, win, dout, M, k, ci, co, d, true,
                                    base, L);

  float acc[T_PER][4];
  if (ncell > 0) load_cell_async(fs, FT, cells[1], co, CP);
  for (int n = 0; n < ncell; ++n) {
    const int cell = cells[1 + n];
    const float* fb = fs + (size_t)(n & 1) * GS * CP;
    if (n + 1 < ncell)
      load_cell_async(fs + (size_t)((n + 1) & 1) * GS * CP, FT, cells[2 + n], co, CP);
    const int x = cell / (d * d), y = (cell / d) % d, z = cell % d;
    mark_touch(x, y, z, dxyz, touch, k, KW);
    wait_cell(n + 1 < ncell);
    __syncthreads();
    zero_acc(acc);
    product(acc, g + warp * T_PER * GS, fb, GS, CP);  // dG = dout @ F_cell^T

#pragma unroll
    for (int i = 0; i < T_PER; ++i) {
      const int t = warp * T_PER + i, m = m0 + t;
      if (m >= M) continue;
      for (int w = 0; w < KW; ++w) {
        uint32_t bits = touch[t * KW + w];
        while (bits) {
          const int e = w * 32 + __ffs(bits) - 1;
          bits &= bits - 1u;
          const size_t at = (size_t)m * k + e;
          const float* fr = feat + at * ci + 4 * lane;
          float s = 0.f;
          if (vec) {
            if (4 * lane < ci) {
              const float4 f = *(const float4*)fr;
              s = f.x * acc[i][0];
              s = fmaf(f.y, acc[i][1], s);
              s = fmaf(f.z, acc[i][2], s);
              s = fmaf(f.w, acc[i][3], s);
            }
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (4 * lane + j < ci) s = fmaf(fr[j], acc[i][j], s);
          }
          // a fixed butterfly: every lane ends with the same bits
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
          if (lane == 0) {
            const int xyz = dxyz[t * k + e];
            const float4 v = dfw[t * k + e];
            const int x0 = xyz & 255, y0 = (xyz >> 8) & 255, z0 = xyz >> 16;
            const float wx = lerp_w(x, x0, v.x), wy = lerp_w(y, y0, v.y),
                        wz = lerp_w(z, z0, v.z);
            const float vs = v.w * s;
            dwin[at] += wx * wy * wz * s;
            dgx[at] += lerp_dw(x, x0, v.x) * wy * wz * vs;
            dgy[at] += wx * lerp_dw(y, y0, v.y) * wz * vs;
            dgz[at] += wx * wy * lerp_dw(z, z0, v.z) * vs;
          }
        }
      }
    }
    __syncthreads();
  }
}

bool bad_shape(int M, int k, int ci, int co, int d) {
  return M <= 0 || k <= 0 || k > MAX_K || ci <= 0 || co <= 0 || co > MAX_CO ||
         d < 2 || d > MAX_D;
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
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
  if (bad_shape(M, k, ci, co, d) || ((uintptr_t)F & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = Layout(d, ci, co, k).total;
  const int err = set_smem(collect_kernel, smem);
  if (err) return err;
  collect_kernel<<<(M + CT - 1) / CT, THREADS, smem, (cudaStream_t)stream>>>(
      gx, gy, gz, win, feat, F, M, k, ci, co, d, out);
  return (int)cudaGetLastError();
}

// B4: dF (d^3, ci, co) from gx, gy, gz, win (M, k), feat (M, k, ci) and dout
// (M, co). nchunk >= 1 chunks of receiver tiles; for nchunk > 1, `partial`
// holds (nchunk, d^3, ci, co) floats of scratch.
int contconv_bwd_filters(const float* gx, const float* gy, const float* gz,
                         const float* win, const float* feat, const float* dout,
                         int M, int k, int ci, int co, int d, int nchunk,
                         float* partial, float* dF, void* stream) {
  if (bad_shape(M, k, ci, co, d) || nchunk < 1 || nchunk > (M + CT - 1) / CT ||
      (nchunk > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = LayoutF(k).total;
  const int err = set_smem(bwd_filters_kernel, smem);
  if (err) return err;
  const int nc = d * d * d;
  const dim3 grid(nc, nchunk, (ci + SLAB - 1) / SLAB);
  bwd_filters_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      gx, gy, gz, win, feat, dout, M, k, ci, co, d, nchunk, nchunk > 1 ? partial : dF);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nchunk == 1) return (int)e;
  const size_t n = (size_t)nc * ci * co;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  sum_banks_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(partial, nchunk, n, dF);
  return (int)cudaGetLastError();
}

// B5: dfeat (M, k, ci) from gx, gy, gz, win (M, k), dout (M, co) and F^T
// (d^3 * co, round4(ci)) with zero pad columns, 16-byte aligned; ci <= 128.
int contconv_bwd_feat(const float* gx, const float* gy, const float* gz,
                      const float* win, const float* dout, const float* FT,
                      int M, int k, int ci, int co, int d, float* dfeat, void* stream) {
  if (bad_shape(M, k, ci, co, d) || ci > MAX_CO || ((uintptr_t)FT & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = Layout(d, co, ci, k).total;
  const int err = set_smem(bwd_feat_kernel, smem);
  if (err) return err;
  bwd_feat_kernel<<<(M + CT - 1) / CT, THREADS, smem, (cudaStream_t)stream>>>(
      gx, gy, gz, win, dout, FT, M, k, ci, co, d, dfeat);
  return (int)cudaGetLastError();
}

// B6: dgx, dgy, dgz, dwin (M, k) from the inputs of B5 and feat (M, k, ci),
// which may lie at any 4-byte offset.
int contconv_bwd_geom(const float* gx, const float* gy, const float* gz,
                      const float* win, const float* feat, const float* dout,
                      const float* FT, int M, int k, int ci, int co, int d,
                      float* dgx, float* dgy, float* dgz, float* dwin, void* stream) {
  if (bad_shape(M, k, ci, co, d) || ci > MAX_CO || ((uintptr_t)FT & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = Layout(d, co, ci, k).total;
  const int err = set_smem(bwd_geom_kernel, smem);
  if (err) return err;
  bwd_geom_kernel<<<(M + CT - 1) / CT, THREADS, smem, (cudaStream_t)stream>>>(
      gx, gy, gz, win, feat, dout, FT, M, k, ci, co, d, dgx, dgy, dgz, dwin);
  return (int)cudaGetLastError();
}

}  // extern "C"
