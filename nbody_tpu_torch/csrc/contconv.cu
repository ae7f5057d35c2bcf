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
// caller divides by the edge count for a mean. Interpolation and the sum are
// linear, so the work is: bins g[m, cell, :] of window- and corner-weighted
// features, then g @ F. B4 replaces _bwd_filters_kernel: dF[cell] =
// g[:, cell, :]^T dout. B5 replaces _bwd_feat_kernel: dfeat[m, e] = window *
// sum over the edge's live corners of w * dG[m, cell], dG[m, cell] = F_cell
// @ dout[m].
//
// What bounds B3-B5 on this card. The TPU kernels multiply dense (tile,
// cell) blocks: a 128 x 128 matrix unit and tens of MB of VMEM make the zero
// bins cheap there. Here the product runs as FP32 FMAs on 132 SMs (tensor
// cores are not used: the contract is full FP32, and TF32 keeps about three
// decimal digits), and a receiver's live edges touch a small part of the
// D^3 cells (27 of 216 on average on the 100k-body radius graph), so a dense
// product does several times the needed operations. The needed ones are
// 2 ci co per touched (receiver, cell) pair, which is what bounds the
// kernels (operations); their bytes are the features read once and the
// compacted bins written and read once.
//
// Design: one pair plan shared by B3, B4 and B5 (and B6, whose plan keeps the
// edges of zero window), then memory-bound passes a warp a receiver (bins,
// B5's unbins, B6's geometry pass) and grouped products over cells. Any k
// (live edges in 64-bit words), any ci and co (128-wide slabs and K chunks),
// any d whose d^3 cells fit the plan's 16 bits and whose tables fit a warp's
// shared memory.
//   plan   plan_masks_kernel: a warp a receiver decodes each edge once and
//          ORs the cells of its live corners into a D^3-bit mask (integer
//          atomicOr in shared memory; the result does not depend on order)
//          and counts them. An edge is live when its window is non-zero (for
//          B6's plan, always), a corner when each of its three axis weights
//          is non-zero; a lane takes every 32nd mask word, so any d. The
//          wrapper prefix-sums the counts (the receivers' first rows) and
//          sizes the scratch. Above a few thousand receivers it reads the
//          total P on the host (one synchronising read a launch; B4 in a
//          backward takes the rows from its forward): the worst case
//          min(8k, D^3) M is 8 times P at 100k bodies and would cost the
//          memory as much. Below, the worst case is small, the launches are
//          short, and a wait would leave the card idle while the host
//          catches up: the lists get worst-case rows and the spare ones stay
//          unused. plan_cell_counts_kernel then counts each cell's pairs
//          (mask words read once, a shared-memory histogram of the d^3 cells
//          a block, integer atomics only), and plan_cells_kernel, a block a cell, walks the
//          receivers in ascending order and gives every pair of its cell the
//          next row of the cell: the cell-major order, receivers ascending
//          inside a cell, with the cells' offsets and first work items. No
//          sort and no torch index arithmetic: the plan is four launches,
//          which is what the small, host-bound shapes pay for.
//   bins   bins_kernel: a warp a receiver, a lane 4 channels. The receiver's
//          rows live in shared memory; each live edge's feature row is read
//          once from device memory (512 B, coalesced; several edges' loads
//          in flight) and added, times window * wx * wy * wz, to the rows of
//          its live corners, edges in edge order, one writer per element.
//          Rows then go to their cell-major place in g (P, round4(ci)), the
//          places read ahead in one coalesced load. A
//          receiver with more pairs than the warp's rows takes more passes.
//          The geometry is decoded here a second time (once per edge, from
//          16 B) rather than stored by the plan (20 B an edge).
//   items  The cells' row counts are far from even (every self edge touches
//          the 8 centre cells: 29% of the pairs at 100k bodies, D = 6), so
//          the products run over work items: a cell's rows cut into pieces of
//          at most R rows, R chosen by the wrapper so that the card gets
//          about 16 waves of blocks. A block finds its cell by a binary
//          search over the cells' first items.
//   B3     pair_product_kernel<false>: a block a (work item, 128-column slab).
//          It keeps F_cell (up to 128 x 128, 64 KB) in shared memory and
//          streams 128-row tiles of the item's contiguous bin rows through a
//          double-buffered cp.async ring; 8 x 8 FP32 register tile a thread;
//          writes y (P, round4(co)). row_sum_kernel then adds each
//          receiver's rows of y in cell order into out[m], 128 columns at a
//          time: one writer, fixed order. ci above 128 runs in K chunks of
//          128 with F reloaded per chunk.
//   B4     bwd_filters_kernel: grid (work item, 128-row slab of ci, 128-column
//          slab of co). The
//          transposed grouped product dF[cell] = G_cell^T dout[receivers of
//          the cell's pairs]: 64 pair rows a step, bins copied as they lie,
//          dout rows gathered by the pair's receiver id (L2-resident), both
//          by cp.async into a two-stage ring; 8 x 8 register tile of dF a
//          thread. Each item writes a partial bank and sum_banks_kernel adds
//          a cell's banks in item order: no float atomics, the same bits on
//          every run.
//   B5     pair_product_kernel<true>: the same grouped product with its rows
//          gathered, dG[s] = dout[recv_of[s]] @ F_cell^T (the bank
//          transposed by the wrapper, (D^3 * co, round4(ci))), 128-column
//          slabs of ci a block, so any ci: 2 ci co operations a touched
//          pair (dense 64-receiver tiles over every cell would do 7.3 times
//          as many at 100k bodies, D = 6). Then unbins_kernel, the bins pass
//          run backwards: a warp a receiver copies its pairs' dG rows into
//          shared memory and writes each edge's dfeat row once (window * w *
//          dG over its live corners in corner order; zeros for a dead edge),
//          so no dfeat row is read back or written once per corner cell.
//          Bytes: dG read once, dfeat written once. In a backward that runs
//          B4 too, dG goes into the buffer of B4's bins once B4 has read
//          them.
// Scratch (masks, plan, g or dG, y, partial banks) is allocated by the
// wrapper.
//
//   B6     bwd_geom_kernel, the geometry cotangents, over a plan that keeps
//          the edges of zero window (plan_masks_kernel with all_edges:
//          d(out)/d(window) = sum over the live corners of w (feat . dG) does
//          not vanish where window = 0) and B5's dG rows
//          (pair_product_kernel<true>, any ci). In a backward that runs B5
//          too, one plan and one dG buffer serve both. A warp a receiver
//          copies its pairs' dG rows into shared memory (cp.async, as the
//          unbin pass); per edge, dead ones included, the warp forms s =
//          feat_j[m, e] . dG[pair] for each live corner: a lane 4 channels of
//          each 128, the feature row read once from device memory (a group
//          of 8 edges' loads in flight; a dead corner reads a row of zeros
//          after the staged rows, so a group runs without a branch and its
//          edges' chains interleave), the 8 corners' partial dots reduced
//          together in 9 shuffles, after which lane l holds corner l / 4's
//          s. Lane 4 c + j then forms corner c's term of cotangent j (dwin:
//          w s; dgx: dtent_x wy wz window s, and so for y and z) and 3 more
//          shuffles add the corners: lanes 0-3 hold the edge's four
//          cotangents, which go to shared memory and, a receiver's at a time,
//          to dgx, dgy, dgz and dwin by consecutive lanes. One writer per
//          element, no atomics, the same bits on every run. A receiver with
//          more pairs than the warp's rows takes more passes; an edge with no
//          corner in a pass is not read in it. tent' is JAX's _dtent: -sign(u)
//          on |u| < 1, so 0 at integer grid coordinates and on the clamped
//          edges, which is JAX's clip mask as well. A corner with a zero axis
//          weight is skipped: its fraction on that axis is 0 or 1, where
//          tent' is 0 for both corners of the axis, so the corner's weight
//          and each of its three derivative products hold a zero factor, and
//          the corner adds nothing to any of the four cotangents.
//          What bounds B6 here: operations, 2 ci co a pair of that plan for
//          dG (shared with B5 where both run) and 2 ci an (edge, live corner)
//          for the dots; its bytes are the geometry, feat_j read once, dout,
//          the bank and the four cotangents. The dG product is B5's; the
//          geometry pass adds the dots, which are a small part of the
//          operations, and reads each feature row once and each dG row once
//          a receiver, so it is bound by those bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int MAX_CELLS = 32767;  // d^3: the plan keeps a cell in 16 bits
constexpr int BATCH = 8;      // bins: feature rows in flight per lane
constexpr int BIN_WARPS = 16; // bins, unbins: most warps of a block
constexpr int GEOM_WARPS = 8; // B6's geometry pass: most warps of a block
constexpr int GEOM_EDGES = 8; // B6's geometry pass: edges a lane reads at once
constexpr int MAX_SMEM = 232448;  // bytes a block may use on sm_90
constexpr size_t DEFAULT_SMEM = 48 * 1024;  // bytes a block may use unasked
constexpr int SLAB = 128;     // B4: rows (of ci) and columns (co) of a dF tile
constexpr int PW = 8;         // plan, row sum: warps (receivers) per block
constexpr int PT = 128;       // B3, B5: pair rows of a product tile
constexpr int KC = 128;       // B3, B5: rows of F_cell in shared memory at a time
constexpr int AS = KC + 4;    // B3, B5: A-tile row stride (rows 4 apart, other banks)
constexpr int KT = 64;        // B4: pair rows of one step
constexpr int COUNT_WORDS = 8;      // plan: mask words a thread of the count kernel
constexpr int CELL_THREADS = 1024;  // plan: receivers a round of a cell's block

static_assert(THREADS == (SLAB / 8) * (SLAB / 8), "an 8 x 8 register tile a thread");
static_assert(PW * ((MAX_CELLS + 31) / 32) * 4 <= DEFAULT_SMEM, "the plan's masks");

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// One warp's share of the bins kernel's shared memory: `rows` bin rows of gs
// floats, per edge its 8 corner weights and 8 row numbers, the rows'
// cell-major places, the receiver's cell -> row table and its live edges,
// one bit an edge in 64-bit words.
struct BinLayout {
  size_t rows, ww, jj, slot, lut, live, per_warp;
  __host__ __device__ BinLayout(int d, int k, int gs, int nrows) {
    rows = 0;
    ww = rows + (size_t)nrows * gs * sizeof(float);
    jj = ww + (size_t)k * 8 * sizeof(float);
    slot = jj + (size_t)k * 8 * sizeof(uint16_t);
    lut = slot + (size_t)nrows * sizeof(int);
    live = (lut + (size_t)d * d * d * sizeof(uint16_t) + 7) & ~(size_t)7;
    per_warp = (live + (size_t)(k + 63) / 64 * sizeof(unsigned long long) + 15) & ~(size_t)15;
  }
};

// One warp's share of B6's geometry pass: `rows` dG rows of gs floats and a
// row of zeros after them (what a dead corner reads), per edge its
// fractions and window (a float4), its four cotangents, its 8 corners' rows,
// the rows' cell-major places and the cell -> row table.
struct GeomLayout {
  size_t rows, fw, res, jj, slot, lut, per_warp;
  __host__ __device__ GeomLayout(int d, int k, int gs, int nrows) {
    rows = 0;
    fw = rows + (size_t)(nrows + 1) * gs * sizeof(float);
    res = fw + (size_t)k * sizeof(float4);
    jj = res + (size_t)4 * k * sizeof(float);
    slot = jj + (size_t)k * 8 * sizeof(uint16_t);
    lut = slot + (size_t)nrows * sizeof(int);
    per_warp = (lut + (size_t)d * d * d * sizeof(uint16_t) + 15) & ~(size_t)15;
  }
};

__device__ __forceinline__ void copy16_async(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void commit_copies() {
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

// An edge's lower corner and fractions: coordinates clamped to [0, d-1], the
// lower corner min(floor(c), d-2).
struct Corner {
  int x, y, z;
  float fx, fy, fz;
};

__device__ __forceinline__ Corner decode_edge(float gx, float gy, float gz, int d) {
  const float hi = (float)(d - 1), top = (float)(d - 2);
  const float cx = fminf(fmaxf(gx, 0.f), hi);
  const float cy = fminf(fmaxf(gy, 0.f), hi);
  const float cz = fminf(fmaxf(gz, 0.f), hi);
  const float x0 = fminf(floorf(cx), top);
  const float y0 = fminf(floorf(cy), top);
  const float z0 = fminf(floorf(cz), top);
  return {(int)x0, (int)y0, (int)z0, cx - x0, cy - y0, cz - z0};
}

// whether the lower (o = 0) or upper (o = 1) corner along one axis has a
// non-zero weight (1 - f or f)
__device__ __forceinline__ bool axis_live(int o, float f) {
  return o ? f != 0.f : f != 1.f;
}

// all copies but, with `more`, the newest group have landed
__device__ __forceinline__ void wait_cell(bool more) {
  if (more)
    asm volatile("cp.async.wait_group 1;\n" ::);
  else
    asm volatile("cp.async.wait_group 0;\n" ::);
}

// ---- the pair plan ----------------------------------------------------------

// A warp a receiver: the D^3-bit mask of the cells its live corners touch,
// masks (M, nw) with nw = ceil(D^3 / 32), and their number, counts[1 + m];
// counts[0] = 0, so that the inclusive prefix sum of counts (M + 1) gives
// the receivers' first rows. Also zeroes cell_counts (D^3). With all_edges
// an edge of zero window counts as live (B6's plan). The warps' masks are
// PW x nw words of dynamic shared memory, a lane every 32nd word.
__global__ void __launch_bounds__(PW * 32)
plan_masks_kernel(const float* __restrict__ gx, const float* __restrict__ gy,
                  const float* __restrict__ gz, const float* __restrict__ win,
                  int M, int k, int d, int all_edges, uint32_t* __restrict__ masks,
                  int* __restrict__ counts, int* __restrict__ cell_counts) {
  extern __shared__ uint32_t mask_words[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (d * d * d + 31) / 32;
  const int m = blockIdx.x * PW + warp;
  if (blockIdx.x == 0)  // for plan_cell_counts_kernel, the next launch
    for (int i = threadIdx.x; i < d * d * d; i += blockDim.x) cell_counts[i] = 0;
  if (m >= M) return;  // the whole warp; no block-wide barrier below
  uint32_t* mine = mask_words + (size_t)warp * nw;
  for (int w = lane; w < nw; w += 32) mine[w] = 0u;
  __syncwarp();
  for (int e = lane; e < k; e += 32) {
    const size_t at = (size_t)m * k + e;
    if (!all_edges && win[at] == 0.f) continue;
    const Corner c = decode_edge(gx[at], gy[at], gz[at], d);
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      const int ox = o >> 2, oy = (o >> 1) & 1, oz = o & 1;
      if (axis_live(ox, c.fx) && axis_live(oy, c.fy) && axis_live(oz, c.fz)) {
        const int cell = ((c.x + ox) * d + c.y + oy) * d + c.z + oz;
        atomicOr(&mine[cell >> 5], 1u << (cell & 31));
      }
    }
  }
  __syncwarp();
  int n = 0;
  for (int w = lane; w < nw; w += 32) {
    const uint32_t b = mine[w];
    masks[(size_t)m * nw + w] = b;
    n += __popc(b);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) n += __shfl_xor_sync(0xffffffffu, n, off);
  if (lane == 0) {
    counts[1 + m] = n;
    if (m == 0) counts[0] = 0;
  }
}

// cell_counts[c] += the receivers whose mask has bit c, over the M * nw mask
// words: a histogram of the z cells a block in dynamic shared memory, then
// one integer add a cell.
__global__ void __launch_bounds__(THREADS)
plan_cell_counts_kernel(const uint32_t* __restrict__ masks, long long nwords, int nw,
                        int z, int* __restrict__ cell_counts) {
  extern __shared__ int hist[];
  for (int i = threadIdx.x; i < z; i += THREADS) hist[i] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * (THREADS * COUNT_WORDS);
  for (int u = 0; u < COUNT_WORDS; ++u) {
    const long long i = base + (long long)u * THREADS + threadIdx.x;
    if (i >= nwords) break;
    uint32_t b = masks[i];
    const int first = (int)(i % nw) * 32;
    while (b) {
      atomicAdd(&hist[first + __ffs(b) - 1], 1);
      b &= b - 1u;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < z; i += THREADS)
    if (hist[i]) atomicAdd(&cell_counts[i], hist[i]);
}

// A block a cell c: coff[c] and istart[c] (the rows and the work items of at
// most `rows` rows of the cells before c; block z - 1 also writes the totals
// coff[z], istart[z]), then the cell's pairs in receiver order: the pair of
// receiver m lies at the receiver-major row r = rstart[m] + (cells of m below
// c) and gets the cell-major row `at`, the next of the cell: cell_r[r] = c,
// slot_of[r] = at, recv_of[at] = m.
__global__ void __launch_bounds__(CELL_THREADS)
plan_cells_kernel(const uint32_t* __restrict__ masks, const int* __restrict__ rstart,
                  const int* __restrict__ cell_counts, int M, int nw, int z, int rows,
                  int16_t* __restrict__ cell_r, int* __restrict__ slot_of,
                  int* __restrict__ recv_of, int* __restrict__ coff,
                  int* __restrict__ istart) {
  __shared__ int part[2][32];
  __shared__ int head[2];
  const int c = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int rows_before = 0, items_before = 0;
  for (int i = tid; i < c; i += CELL_THREADS) {
    const int n = cell_counts[i];
    rows_before += n;
    items_before += (n + rows - 1) / rows;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    rows_before += __shfl_xor_sync(0xffffffffu, rows_before, off);
    items_before += __shfl_xor_sync(0xffffffffu, items_before, off);
  }
  if (lane == 0) {
    part[0][warp] = rows_before;
    part[1][warp] = items_before;
  }
  __syncthreads();
  if (warp == 0) {
    int a = part[0][lane], b = part[1][lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, off);
      b += __shfl_xor_sync(0xffffffffu, b, off);
    }
    if (lane == 0) {
      head[0] = a;
      head[1] = b;
    }
  }
  __syncthreads();
  const int first = head[0], mine = cell_counts[c];
  if (tid == 0) {
    coff[c] = first;
    istart[c] = head[1];
    if (c == z - 1) {
      coff[z] = first + mine;
      istart[z] = head[1] + (mine + rows - 1) / rows;
    }
  }
  if (mine == 0) return;  // the whole block

  const int word = c >> 5;
  const uint32_t bit = 1u << (c & 31);
  int done = 0;
  for (int m0 = 0; m0 < M && done < mine; m0 += CELL_THREADS) {
    const int m = m0 + tid;
    uint32_t wv = 0u;
    if (m < M) wv = masks[(size_t)m * nw + word];
    const bool hit = (wv & bit) != 0u;
    const uint32_t votes = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) part[0][warp] = __popc(votes);
    __syncthreads();
    // the hits of the warps before this one, and of the round
    const int v = part[0][lane];
    int upto = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, upto, off);
      if (lane >= off) upto += t;
    }
    const int total = __shfl_sync(0xffffffffu, upto, 31);
    const int before = __shfl_sync(0xffffffffu, upto - v, warp);
    if (hit) {
      const int at = first + done + before + __popc(votes & ((1u << lane) - 1u));
      int r = rstart[m] + __popc(wv & (bit - 1u));
      for (int w = 0; w < word; ++w) r += __popc(masks[(size_t)m * nw + w]);
      cell_r[r] = (int16_t)c;
      slot_of[r] = at;
      recv_of[at] = m;
    }
    done += total;
    __syncthreads();  // part is written again in the next round
  }
}

// ---- the bins ---------------------------------------------------------------

// 4 channels of a feature row from column c on; columns from ci on read as 0
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int c, int ci,
                                        bool vec) {
  if (vec) return *(const float4*)(row + c);  // c + 3 < ci: ci is a multiple of 4
  return make_float4(c < ci ? row[c] : 0.f, c + 1 < ci ? row[c + 1] : 0.f,
                     c + 2 < ci ? row[c + 2] : 0.f, c + 3 < ci ? row[c + 3] : 0.f);
}

// One warp, receiver m: per edge e its 8 corners' rows among the receiver's
// pairs (jj[8 e + o], through the receiver's cell -> row table lut; 0xffff:
// adds nothing) and weights window * wx * wy * wz (ww[8 e + o]); the edges
// with a live corner, one bit an edge, in live[e / 64] (any k). Ends with
// __syncwarp.
__device__ __forceinline__ void edge_corner_rows(
    const float* __restrict__ gx, const float* __restrict__ gy, const float* __restrict__ gz,
    const float* __restrict__ win, int m, int k, int d, const uint16_t* lut, uint16_t* jj,
    float* ww, unsigned long long* live) {
  const int lane = threadIdx.x & 31;
  for (int e0 = 0; e0 < k; e0 += 32) {
    const int e = e0 + lane;
    bool on = false;
    if (e < k) {
      const size_t at = (size_t)m * k + e;
      const float w = win[at];
      if (w != 0.f) {
        const Corner c = decode_edge(gx[at], gy[at], gz[at], d);
#pragma unroll
        for (int o = 0; o < 8; ++o) {
          const int ox = o >> 2, oy = (o >> 1) & 1, oz = o & 1;
          const bool lv = axis_live(ox, c.fx) && axis_live(oy, c.fy) && axis_live(oz, c.fz);
          const int cell = ((c.x + ox) * d + c.y + oy) * d + c.z + oz;
          jj[e * 8 + o] = lv ? lut[cell] : (uint16_t)0xffffu;
          ww[e * 8 + o] = w * lerp_w(ox, 0, c.fx) * lerp_w(oy, 0, c.fy) * lerp_w(oz, 0, c.fz);
          on = on || lv;
        }
      }
    }
    const unsigned long long bits = __ballot_sync(0xffffffffu, on);
    if (lane == 0) live[e0 >> 6] = (e0 & 63) ? live[e0 >> 6] | bits << 32 : bits;
  }
  __syncwarp();
}

// g (P, gs): the bins of every (receiver, cell) pair at its cell-major row.
// A warp a receiver (grid-stride), a lane 4 channels of each 128; `nrows`
// rows of shared memory a warp, BinLayout.
__global__ void __launch_bounds__(BIN_WARPS * 32)
bins_kernel(const float* __restrict__ gx, const float* __restrict__ gy,
            const float* __restrict__ gz, const float* __restrict__ win,
            const float* __restrict__ feat, const int* __restrict__ rstart,
            const int16_t* __restrict__ cell_r, const int* __restrict__ slot_of,
            int M, int k, int ci, int d, int nrows, float* __restrict__ g) {
  extern __shared__ float4 smem4[];
  const int gs = round4(ci);
  const BinLayout L(d, k, gs, nrows);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarp = blockDim.x >> 5;
  unsigned char* base = (unsigned char*)smem4 + (size_t)warp * L.per_warp;
  float* rows = (float*)(base + L.rows);
  float* ww = (float*)(base + L.ww);
  uint16_t* jj = (uint16_t*)(base + L.jj);
  int* slot = (int*)(base + L.slot);
  uint16_t* lut = (uint16_t*)(base + L.lut);
  unsigned long long* live = (unsigned long long*)(base + L.live);
  const int kw = (k + 63) / 64;
  // 16-byte feature reads need ci % 4 == 0 and a 16-byte aligned base
  const bool vec = (ci & 3) == 0 && ((uintptr_t)feat & 15u) == 0;

  for (int m = blockIdx.x * nwarp + warp; m < M; m += gridDim.x * nwarp) {
    const int r0 = rstart[m], n = rstart[m + 1] - r0;
    if (n == 0) continue;
    for (int j = lane; j < n; j += 32) lut[cell_r[r0 + j]] = (uint16_t)j;
    __syncwarp();

    edge_corner_rows(gx, gy, gz, win, m, k, d, lut, jj, ww, live);

    for (int b0 = 0; b0 < n; b0 += nrows) {  // one pass unless n > nrows
      const int nr = min(nrows, n - b0);
      // the rows' places, one coalesced read: the stores at the end do not
      // wait on a read each
      for (int j = lane; j < nr; j += 32) slot[j] = slot_of[r0 + b0 + j];
      for (int i = lane; i < nr * gs / 4; i += 32)
        ((float4*)rows)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      __syncwarp();
      for (int c0 = 4 * lane; c0 < gs; c0 += 128) {
        for (int w = 0; w < kw; ++w) {  // edges in edge order, 64 a word
          unsigned long long bits = live[w];
          while (bits) {
            // up to BATCH edges at a time: their feature loads are independent
            // and in flight together
            int es[BATCH];
            float4 fv[BATCH];
#pragma unroll
            for (int u = 0; u < BATCH; ++u) {
              es[u] = bits ? 64 * w + __ffsll((long long)bits) - 1 : -1;
              bits &= bits - 1ull;
            }
#pragma unroll
            for (int u = 0; u < BATCH; ++u)
              fv[u] = es[u] >= 0 ? load4(feat + ((size_t)m * k + es[u]) * ci, c0, ci, vec)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int u = 0; u < BATCH; ++u) {
              if (es[u] < 0) break;
              const uint4 j8 = *(const uint4*)(jj + es[u] * 8);
              const float4 wa = *(const float4*)(ww + es[u] * 8);
              const float4 wb = *(const float4*)(ww + es[u] * 8 + 4);
              const unsigned js[8] = {j8.x & 0xffffu, j8.x >> 16, j8.y & 0xffffu, j8.y >> 16,
                                      j8.z & 0xffffu, j8.z >> 16, j8.w & 0xffffu, j8.w >> 16};
              const float ws[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
              const float4 f = fv[u];
              // an edge's 8 corners are 8 different rows: their reads go out
              // together, ahead of the writes; edges stay in edge order
              float4 a[8];
#pragma unroll
              for (int o = 0; o < 8; ++o) {
                const unsigned r = js[o] - (unsigned)b0;
                if (r < (unsigned)nr) a[o] = *(const float4*)(rows + (size_t)r * gs + c0);
              }
#pragma unroll
              for (int o = 0; o < 8; ++o) {
                const unsigned r = js[o] - (unsigned)b0;
                if (r < (unsigned)nr) {
                  a[o].x = fmaf(ws[o], f.x, a[o].x);
                  a[o].y = fmaf(ws[o], f.y, a[o].y);
                  a[o].z = fmaf(ws[o], f.z, a[o].z);
                  a[o].w = fmaf(ws[o], f.w, a[o].w);
                  *(float4*)(rows + (size_t)r * gs + c0) = a[o];
                }
              }
            }
          }
        }
      }
      __syncwarp();
      for (int j = 0; j < nr; ++j) {
        float4* dst = (float4*)(g + (size_t)slot[j] * gs);
        for (int i = lane; i < gs / 4; i += 32) dst[i] = ((const float4*)(rows + (size_t)j * gs))[i];
      }
      __syncwarp();
    }
  }
}

// ---- B5: the unbin pass ------------------------------------------------------

// dfeat (M, k, ci) from dG (P, gs), the bins kernel run backwards: a warp a
// receiver (grid-stride), a lane 4 channels of each 128. The receiver's dG
// rows (its pairs' cell-major rows) are copied into the warp's shared memory
// (cp.async, all in flight together); each edge's dfeat row is then the sum,
// over its live corners in corner order, of window * w * dG[corner's row],
// written once (512 B a warp, coalesced; zeros for an edge without a live
// corner). A receiver with more pairs than the warp's `nrows` rows takes more
// passes in order: the first writes, the later ones add their corners.
__global__ void __launch_bounds__(BIN_WARPS * 32)
unbins_kernel(const float* __restrict__ gx, const float* __restrict__ gy,
              const float* __restrict__ gz, const float* __restrict__ win,
              const float* __restrict__ dg, const int* __restrict__ rstart,
              const int16_t* __restrict__ cell_r, const int* __restrict__ slot_of,
              int M, int k, int ci, int d, int nrows, float* __restrict__ dfeat) {
  extern __shared__ float4 smem4[];
  const int gs = round4(ci);
  const BinLayout L(d, k, gs, nrows);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarp = blockDim.x >> 5;
  unsigned char* base = (unsigned char*)smem4 + (size_t)warp * L.per_warp;
  float* rows = (float*)(base + L.rows);
  float* ww = (float*)(base + L.ww);
  uint16_t* jj = (uint16_t*)(base + L.jj);
  int* slot = (int*)(base + L.slot);
  uint16_t* lut = (uint16_t*)(base + L.lut);
  unsigned long long* live = (unsigned long long*)(base + L.live);
  // 16-byte row writes need ci % 4 == 0 and a 16-byte aligned base
  const bool vec = (ci & 3) == 0 && ((uintptr_t)dfeat & 15u) == 0;

  for (int m = blockIdx.x * nwarp + warp; m < M; m += gridDim.x * nwarp) {
    const int r0 = rstart[m], n = rstart[m + 1] - r0;
    for (int j = lane; j < n; j += 32) lut[cell_r[r0 + j]] = (uint16_t)j;
    __syncwarp();
    edge_corner_rows(gx, gy, gz, win, m, k, d, lut, jj, ww, live);

    for (int b0 = 0; b0 == 0 || b0 < n; b0 += nrows) {  // one pass unless n > nrows
      const int nr = min(nrows, n - b0), gq = gs / 4;
      for (int j = lane; j < nr; j += 32) slot[j] = slot_of[r0 + b0 + j];
      __syncwarp();
      for (int q = lane; q < nr * gq; q += 32) {
        const int j = q / gq, i = q - j * gq;
        copy16_async(rows + (size_t)j * gs + 4 * i, dg + (size_t)slot[j] * gs + 4 * i);
      }
      commit_copies();
      asm volatile("cp.async.wait_group 0;\n" ::);
      __syncwarp();
      for (int c0 = 4 * lane; c0 < gs; c0 += 128) {
        for (int e = 0; e < k; ++e) {
          float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
          bool any = false;
          if ((live[e >> 6] >> (e & 63)) & 1ull) {
            const uint4 j8 = *(const uint4*)(jj + e * 8);
            const float4 wa = *(const float4*)(ww + e * 8);
            const float4 wb = *(const float4*)(ww + e * 8 + 4);
            const unsigned js[8] = {j8.x & 0xffffu, j8.x >> 16, j8.y & 0xffffu, j8.y >> 16,
                                    j8.z & 0xffffu, j8.z >> 16, j8.w & 0xffffu, j8.w >> 16};
            const float ws[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
            for (int o = 0; o < 8; ++o) {
              const unsigned r = js[o] - (unsigned)b0;
              if (r < (unsigned)nr) {
                const float4 v = *(const float4*)(rows + (size_t)r * gs + c0);
                s.x = fmaf(ws[o], v.x, s.x);
                s.y = fmaf(ws[o], v.y, s.y);
                s.z = fmaf(ws[o], v.z, s.z);
                s.w = fmaf(ws[o], v.w, s.w);
                any = true;
              }
            }
          }
          if (b0 > 0 && !any) continue;  // a later pass adds only its own corners
          float* p = dfeat + ((size_t)m * k + e) * ci + c0;
          if (vec) {
            if (b0 > 0) {
              const float4 q = *(const float4*)p;
              s.x += q.x;
              s.y += q.y;
              s.z += q.z;
              s.w += q.w;
            }
            *(float4*)p = s;
          } else {
            const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (c0 + j < ci) p[j] = b0 > 0 ? p[j] + sv[j] : sv[j];
          }
        }
      }
      __syncwarp();
    }
  }
}

// ---- B6: the geometry pass ---------------------------------------------------

// 8 values a lane, each summed over the warp: 9 shuffles where one warp-wide
// sum a value would take 40. Each step sends half of a lane's values to its
// partner and keeps the other half; lane l ends with the sum of value l / 4
// over all 32 lanes (the same bits in the 4 lanes of a group).
__device__ __forceinline__ float sum8_over_warp(const float (&v)[8], int lane) {
  const bool h4 = lane & 16, h3 = lane & 8, h2 = lane & 4;
  float a[4], b[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = (h4 ? v[i + 4] : v[i]) + __shfl_xor_sync(0xffffffffu, h4 ? v[i] : v[i + 4], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    b[i] = (h3 ? a[i + 2] : a[i]) + __shfl_xor_sync(0xffffffffu, h3 ? a[i] : a[i + 2], 8);
  float c = (h2 ? b[1] : b[0]) + __shfl_xor_sync(0xffffffffu, h2 ? b[0] : b[1], 4);
  c += __shfl_xor_sync(0xffffffffu, c, 2);
  return c + __shfl_xor_sync(0xffffffffu, c, 1);
}

// One edge's share of the geometry pass once its dots are formed: s[o] is
// lane's partial of corner o. Reduces them (lane l: corner l / 4), forms
// lane 4 c + j's term of cotangent j for corner c (masked where the corner
// is dead or outside the pass), adds the corners and, with `write`, adds the
// edge's four sums to res (lanes 0-3).
__device__ __forceinline__ void geom_terms(const float (&s)[8], int lane, float4 f,
                                           const uint16_t* jj8, int b0, int nr, bool write,
                                           float* res_e, int k) {
  const int oc = lane >> 2, cj = lane & 3;
  const int ox = oc >> 2, oy = (oc >> 1) & 1, oz = oc & 1;
  const float sc = sum8_over_warp(s, lane);  // s of corner oc
  const bool in_pass = write && (unsigned)jj8[oc] - (unsigned)b0 < (unsigned)nr;
  const float wx = lerp_w(ox, 0, f.x), wy = lerp_w(oy, 0, f.y), wz = lerp_w(oz, 0, f.z);
  const float vs = f.w * sc;
  float t = cj == 0   ? wx * wy * wz * sc
            : cj == 1 ? lerp_dw(ox, 0, f.x) * wy * wz * vs
            : cj == 2 ? wx * lerp_dw(oy, 0, f.y) * wz * vs
                      : wx * wy * lerp_dw(oz, 0, f.z) * vs;
  t = in_pass ? t : 0.f;
  // over the corners: ((c0 + c1) + (c2 + c3)) + ((c4 + c5) + (c6 + c7))
  t += __shfl_xor_sync(0xffffffffu, t, 4);
  t += __shfl_xor_sync(0xffffffffu, t, 8);
  t += __shfl_xor_sync(0xffffffffu, t, 16);
  if (lane < 4 && write) res_e[lane * k] += t;
}

// s[o] += f . (4 channels at c0 of the row of corner o in this pass, or of
// the row of zeros after the staged rows)
__device__ __forceinline__ void corner_dots(float (&s)[8], float4 f, const uint16_t* jj8,
                                            const float* rows, int gs, int c0, int b0, int nr,
                                            int nrows) {
  const uint4 j8 = *(const uint4*)jj8;
  const unsigned js[8] = {j8.x & 0xffffu, j8.x >> 16, j8.y & 0xffffu, j8.y >> 16,
                          j8.z & 0xffffu, j8.z >> 16, j8.w & 0xffffu, j8.w >> 16};
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    const unsigned r = js[o] - (unsigned)b0;
    const float4 v = *(const float4*)(rows + (size_t)(r < (unsigned)nr ? r : nrows) * gs + c0);
    float t = fmaf(f.x, v.x, s[o]);
    t = fmaf(f.y, v.y, t);
    t = fmaf(f.z, v.z, t);
    s[o] = fmaf(f.w, v.w, t);
  }
}

// the edges e0 .. e0 + GEOM_EDGES - 1 with a corner among this pass's rows,
// one bit an edge (the same in every lane)
__device__ __forceinline__ unsigned edges_in_pass(const uint16_t* jj, int e0, int k, int b0,
                                                  int nr) {
  unsigned here = 0u;
#pragma unroll
  for (int u = 0; u < GEOM_EDGES; ++u) {
    if (e0 + u >= k) break;
    const uint4 j8 = *(const uint4*)(jj + (e0 + u) * 8);
    const unsigned js[8] = {j8.x & 0xffffu, j8.x >> 16, j8.y & 0xffffu, j8.y >> 16,
                            j8.z & 0xffffu, j8.z >> 16, j8.w & 0xffffu, j8.w >> 16};
#pragma unroll
    for (int o = 0; o < 8; ++o)
      if (js[o] - (unsigned)b0 < (unsigned)nr) here |= 1u << u;
  }
  return here;
}

// dgx, dgy, dgz, dwin (M, k) from dG (P, gs) at the plan's cell-major rows: a
// warp a receiver (grid-stride), a lane 4 channels of each 128, the
// receiver's dG rows in the warp's shared memory (GeomLayout, `nrows` rows;
// a receiver with more pairs takes more passes, in order). Per edge, those of
// zero window included: s[o] = feat_j[m, e] . dG[row of corner o] for its live
// corners, then the four cotangents' terms a corner, added over the corners.
// Edges go in groups of GEOM_EDGES whose feature loads are in flight
// together, and a group's dots run over the row's 128-channel chunks. No
// branch inside a group: an edge outside the pass (or past k) reads zero
// features, a corner outside it the row of zeros, and their terms are
// masked, so the group's loads, dots and shuffle chains interleave.
__global__ void __launch_bounds__(GEOM_WARPS * 32)
bwd_geom_kernel(const float* __restrict__ gx, const float* __restrict__ gy,
                const float* __restrict__ gz, const float* __restrict__ win,
                const float* __restrict__ feat, const float* __restrict__ dg,
                const int* __restrict__ rstart, const int16_t* __restrict__ cell_r,
                const int* __restrict__ slot_of, int M, int k, int ci, int d, int nrows,
                float* __restrict__ dgx, float* __restrict__ dgy, float* __restrict__ dgz,
                float* __restrict__ dwin) {
  extern __shared__ float4 smem4[];
  const int gs = round4(ci);
  const GeomLayout L(d, k, gs, nrows);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarp = blockDim.x >> 5;
  unsigned char* base = (unsigned char*)smem4 + (size_t)warp * L.per_warp;
  float* rows = (float*)(base + L.rows);
  float4* fw = (float4*)(base + L.fw);
  float* res = (float*)(base + L.res);
  uint16_t* jj = (uint16_t*)(base + L.jj);
  int* slot = (int*)(base + L.slot);
  uint16_t* lut = (uint16_t*)(base + L.lut);
  // 16-byte feature reads need ci % 4 == 0 and a 16-byte aligned base
  const bool vec = (ci & 3) == 0 && ((uintptr_t)feat & 15u) == 0;
  for (int i = lane; i < gs / 4; i += 32)
    ((float4*)(rows + (size_t)nrows * gs))[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int m = blockIdx.x * nwarp + warp; m < M; m += gridDim.x * nwarp) {
    const int r0 = rstart[m], n = rstart[m + 1] - r0;
    for (int j = lane; j < n; j += 32) lut[cell_r[r0 + j]] = (uint16_t)j;
    __syncwarp();
    // every edge: fractions and window, its live corners' rows, zero sums
    for (int e = lane; e < k; e += 32) {
      const size_t at = (size_t)m * k + e;
      const Corner c = decode_edge(gx[at], gy[at], gz[at], d);
      fw[e] = make_float4(c.fx, c.fy, c.fz, win[at]);
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        const int px = o >> 2, py = (o >> 1) & 1, pz = o & 1;
        const bool lv = axis_live(px, c.fx) && axis_live(py, c.fy) && axis_live(pz, c.fz);
        jj[e * 8 + o] = lv ? lut[((c.x + px) * d + c.y + py) * d + c.z + pz] : (uint16_t)0xffffu;
      }
      res[e] = res[k + e] = res[2 * k + e] = res[3 * k + e] = 0.f;
    }
    __syncwarp();
    const float* frow = feat + (size_t)m * k * ci;

    for (int b0 = 0; b0 == 0 || b0 < n; b0 += nrows) {  // one pass unless n > nrows
      const int nr = min(nrows, n - b0), gq = gs / 4;
      for (int j = lane; j < nr; j += 32) slot[j] = slot_of[r0 + b0 + j];
      __syncwarp();
      for (int q = lane; q < nr * gq; q += 32) {
        const int j = q / gq, i = q - j * gq;
        copy16_async(rows + (size_t)j * gs + 4 * i, dg + (size_t)slot[j] * gs + 4 * i);
      }
      commit_copies();
      asm volatile("cp.async.wait_group 0;\n" ::);
      __syncwarp();
      for (int e0 = 0; e0 < k; e0 += GEOM_EDGES) {
        const unsigned here = edges_in_pass(jj, e0, k, b0, nr);
        if (!here) continue;
        float s[GEOM_EDGES][8];
#pragma unroll
        for (int u = 0; u < GEOM_EDGES; ++u)
#pragma unroll
          for (int o = 0; o < 8; ++o) s[u][o] = 0.f;
        for (int c0 = 4 * lane; c0 < gs; c0 += 128) {
          float4 fv[GEOM_EDGES];
#pragma unroll
          for (int u = 0; u < GEOM_EDGES; ++u)
            fv[u] = (here >> u) & 1u ? load4(frow + (size_t)(e0 + u) * ci, c0, ci, vec)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int u = 0; u < GEOM_EDGES; ++u)
            corner_dots(s[u], fv[u], jj + min(e0 + u, k - 1) * 8, rows, gs, c0, b0, nr, nrows);
        }
#pragma unroll
        for (int u = 0; u < GEOM_EDGES; ++u) {
          const int e = min(e0 + u, k - 1);
          geom_terms(s[u], lane, fw[e], jj + e * 8, b0, nr, (here >> u) & 1u, res + e, k);
        }
      }
      __syncwarp();
    }
    float* outs[4] = {dwin, dgx, dgy, dgz};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      for (int e = lane; e < k; e += 32) outs[j][(size_t)m * k + e] = res[j * k + e];
    __syncwarp();
  }
}

// ---- B3: the grouped product and the row sum --------------------------------

// The grouped products run over work items: cell c's pair rows are cut into
// istart[c + 1] - istart[c] items of at most `rows` rows, so that a cell with
// many pairs (the centre cells, which every self edge touches) takes many
// blocks and the blocks' work is even. The cell of an item: istart[cell] <=
// item < istart[cell + 1] (cells without pairs have no item).
__device__ __forceinline__ int cell_of_item(const int* __restrict__ istart, int ncell,
                                            int item) {
  int lo = 0, hi = ncell;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (istart[mid] <= item) lo = mid; else hi = mid;
  }
  return lo;
}

// rows {4 ty + i, 64 + 4 ty + i} and columns {4 tx + j, 64 + 4 tx + j} of a
// 128 x 128 tile a thread
__device__ __forceinline__ int tile_at(int t, int i) {
  return i < 4 ? 4 * t + i : 64 + 4 * t + i - 4;
}

// The grouped product over the plan's cell-major pair rows s: y[s] (round4(nd)
// floats a row) = A[s] (round4(kd) floats, pad columns zero) times F_cell, the
// (kd, nd) block of F (d^3 * kd, round4(nd)) of the cell of s. GATHER: A[s] is
// row recv_of[s] of a (B5's dG: the dout row of the pair's receiver, F = the
// bank transposed); else row s (B3: the bins). A block a (work item, 128-column
// slab of y), in tiles of PT rows; kd above 128 runs in K chunks of 128 with
// F reloaded per chunk.
template <bool GATHER>
__global__ void __launch_bounds__(THREADS)
pair_product_kernel(const float* __restrict__ a, const int* __restrict__ recv_of,
                    const float* __restrict__ F, const int* __restrict__ coff,
                    const int* __restrict__ istart, int kd, int nd, int ncell, int rows,
                    float* __restrict__ y) {
  extern __shared__ float4 smem4[];
  float* fs = (float*)smem4;             // (KC, 128) rows of F_cell
  float* as = fs + (size_t)KC * SLAB;    // 2 x (PT, AS) A tiles
  const int ka = round4(kd), np = round4(nd);
  const int n0 = blockIdx.y * SLAB, ns = min(SLAB, np - n0);  // this slab's columns
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int item = blockIdx.x;
  if (item >= istart[ncell]) return;
  const int cell = cell_of_item(istart, ncell, item);
  const int c0 = coff[cell] + (item - istart[cell]) * rows;
  const int c1 = min(coff[cell + 1], c0 + rows);
  const int nkc = (ka + KC - 1) / KC;
  const int nsteps = (c1 - c0 + PT - 1) / PT * nkc;

  // the A tile of a step: rows of tile step / nkc, columns of K chunk
  // step % nkc
  auto load_a = [&](int step) {
    const int row0 = c0 + step / nkc * PT, k0 = (step % nkc) * KC;
    const int nr = min(PT, c1 - row0), kq = min(KC, ka - k0) / 4;
    float* dst = as + (size_t)(step & 1) * PT * AS;
    for (int q = tid; q < nr * kq; q += THREADS) {
      const int r = q / kq, c = q - r * kq;
      const size_t src = GATHER ? (size_t)recv_of[row0 + r] : (size_t)(row0 + r);
      copy16_async(dst + r * AS + 4 * c, a + src * ka + k0 + 4 * c);
    }
    commit_copies();
  };
  // K chunk kc of F_cell's slab, rows from kd on zero
  auto load_f = [&](int kc) {
    const int k0 = kc * KC, kl = min(KC, ka - k0), cq = ns / 4;
    for (int q = tid; q < kl * cq; q += THREADS) {
      const int r = q / cq, c = q - r * cq;
      if (k0 + r < kd)
        copy16_async(fs + r * SLAB + 4 * c,
                     F + ((size_t)cell * kd + k0 + r) * np + n0 + 4 * c);
      else
        *(float4*)(fs + r * SLAB + 4 * c) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    commit_copies();
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  if (nkc == 1) load_f(0);  // resident for every tile of the block
  load_a(0);
  for (int step = 0; step < nsteps; ++step) {
    const int kc = step % nkc;
    if (step + 1 < nsteps) load_a(step + 1);  // its buffer was read before the barrier
    wait_cell(step + 1 < nsteps);
    __syncthreads();
    if (nkc > 1) {
      load_f(kc);
      wait_cell(false);
      __syncthreads();
    }
    const float* ab = as + (size_t)(step & 1) * PT * AS;
    const int kl = min(KC, ka - kc * KC);
    for (int kk = 0; kk < kl; kk += 4) {
      float4 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = *(const float4*)(ab + tile_at(ty, i) * AS + kk);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 ba = *(const float4*)(fs + (kk + r) * SLAB + 4 * tx);
        const float4 bb = *(const float4*)(fs + (kk + r) * SLAB + 64 + 4 * tx);
        const float bc[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av_r = r == 0 ? av[i].x : r == 1 ? av[i].y : r == 2 ? av[i].z : av[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av_r, bc[j], acc[i][j]);
        }
      }
    }
    if (kc == nkc - 1) {  // the tile's rows of y
      const int row0 = c0 + step / nkc * PT;
      const int nr = min(PT, c1 - row0);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = tile_at(ty, i);
        if (r < nr) {
          float* yr = y + (size_t)(row0 + r) * np + n0;
          if (4 * tx < ns)
            *(float4*)(yr + 4 * tx) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          if (64 + 4 * tx < ns)
            *(float4*)(yr + 64 + 4 * tx) =
                make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      }
    }
    __syncthreads();
  }
}

// out[m, :] = the receiver's rows of y, added in cell order; a warp a
// receiver, a lane a float4 of each 128 columns
__global__ void __launch_bounds__(PW * 32)
row_sum_kernel(const float* __restrict__ y, const int* __restrict__ rstart,
               const int* __restrict__ slot_of, int M, int co, float* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = blockIdx.x * PW + warp;
  if (m >= M) return;
  const int cp = round4(co);
  const int r0 = rstart[m], r1 = rstart[m + 1];
  const bool vec = (co & 3) == 0 && ((uintptr_t)out & 15u) == 0;
  for (int c = 4 * lane; c < cp; c += 128) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = r0; r < r1; r += 4) {  // 4 rows' loads in flight, added in order
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[u] = r + u < r1 ? *(const float4*)(y + (size_t)slot_of[r + u] * cp + c)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        s.x += v[u].x;
        s.y += v[u].y;
        s.z += v[u].z;
        s.w += v[u].w;
      }
    }
    float* o = out + (size_t)m * co + c;
    if (vec) {
      *(float4*)o = s;
    } else {
      const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < co) o[j] = sv[j];
    }
  }
}

// ---- B4 ---------------------------------------------------------------------

// One (work item, ci slab, co slab) a block: acc (128 x 128, 8 x 8 a
// thread) += g[s, ci slab]^T dout[recv_of[s], co slab] over the item's pair
// rows s, written into the item's partial bank part[item] (ci, co).
__global__ void __launch_bounds__(THREADS)
bwd_filters_kernel(const float* __restrict__ g, const float* __restrict__ dout,
                   const int* __restrict__ coff, const int* __restrict__ recv_of,
                   const int* __restrict__ istart, int ci, int co, int ncell, int rows,
                   float* __restrict__ part) {
  extern __shared__ float4 smem4[];
  float* gsm = (float*)smem4;                 // 2 x (KT, SLAB) bin rows
  float* dsm = gsm + (size_t)2 * KT * SLAB;   // 2 x (KT, SLAB) dout rows
  const int gs = round4(ci);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int item = blockIdx.x;
  if (item >= istart[ncell]) return;
  const int cell = cell_of_item(istart, ncell, item);
  const int s0 = blockIdx.y * SLAB, gq = min(SLAB, gs - s0) / 4;
  const int t0 = blockIdx.z * SLAB, nco = min(SLAB, co - t0);  // this block's columns
  const int a0 = coff[cell] + (item - istart[cell]) * rows;
  const int a1 = min(coff[cell + 1], a0 + rows);
  const int nsteps = (a1 - a0 + KT - 1) / KT;
  // 16-byte dout reads need co % 4 == 0 and a 16-byte aligned base
  const bool dvec = (co & 3) == 0 && ((uintptr_t)dout & 15u) == 0;

  auto load = [&](int step) {
    const int row0 = a0 + step * KT, nr = min(KT, a1 - row0);
    float* gb = gsm + (size_t)(step & 1) * KT * SLAB;
    float* db = dsm + (size_t)(step & 1) * KT * SLAB;
    for (int q = tid; q < nr * gq; q += THREADS) {
      const int r = q / gq, c = q - r * gq;
      copy16_async(gb + r * SLAB + 4 * c, g + (size_t)(row0 + r) * gs + s0 + 4 * c);
    }
    if (dvec) {
      const int dq = nco / 4;
      for (int q = tid; q < nr * dq; q += THREADS) {
        const int r = q / dq, c = q - r * dq;
        copy16_async(db + r * SLAB + 4 * c,
                     dout + (size_t)recv_of[row0 + r] * co + t0 + 4 * c);
      }
    } else {
      for (int q = tid; q < nr * nco; q += THREADS) {
        const int r = q / nco, c = q - r * nco;
        db[r * SLAB + c] = dout[(size_t)recv_of[row0 + r] * co + t0 + c];
      }
    }
    commit_copies();
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  if (nsteps > 0) load(0);
  for (int step = 0; step < nsteps; ++step) {
    if (step + 1 < nsteps) load(step + 1);  // its buffers were read before the barrier
    wait_cell(step + 1 < nsteps);
    __syncthreads();
    const float* gb = gsm + (size_t)(step & 1) * KT * SLAB;
    const float* db = dsm + (size_t)(step & 1) * KT * SLAB;
    const int nr = min(KT, a1 - a0 - step * KT);
    for (int t = 0; t < nr; ++t) {  // acc += g[t, rows]^T dout[t, cols]
      const float4 ga = *(const float4*)(gb + t * SLAB + 4 * ty);
      const float4 gc = *(const float4*)(gb + t * SLAB + 64 + 4 * ty);
      const float4 da = *(const float4*)(db + t * SLAB + 4 * tx);
      const float4 dc = *(const float4*)(db + t * SLAB + 64 + 4 * tx);
      const float gr[8] = {ga.x, ga.y, ga.z, ga.w, gc.x, gc.y, gc.z, gc.w};
      const float dv[8] = {da.x, da.y, da.z, da.w, dc.x, dc.y, dc.z, dc.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(gr[i], dv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* bank = part + (size_t)item * ci * co;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = s0 + tile_at(ty, i);
    if (r >= ci) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = tile_at(tx, j);
      if (col < nco) bank[(size_t)r * co + t0 + col] = acc[i][j];
    }
  }
}

// dF[cell] = the partial banks of the cell's items, added in item order
// (zero for a cell without pairs); n = ci * co elements a bank
__global__ void sum_banks_kernel(const float* __restrict__ part,
                                 const int* __restrict__ istart, int ncell, int n,
                                 float* __restrict__ out) {
  const size_t total = (size_t)ncell * n;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int cell = (int)(i / n), e = (int)(i - (size_t)cell * n);
    float s = 0.f;
    for (int j = istart[cell]; j < istart[cell + 1]; ++j) s += part[(size_t)j * n + e];
    out[i] = s;
  }
}

// d^3 within the plan's 16-bit cells (which also keeps a receiver's rows,
// at most d^3, below the 0xffff that marks a dead corner)
bool bad_shape(int M, int k, int ci, int co, int d) {
  return M <= 0 || k <= 0 || ci <= 0 || co <= 0 || d < 2 || d * d * d > MAX_CELLS;
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

// The launch of a warp-per-receiver pass over the plan (bins_kernel,
// unbins_kernel with BinLayout, bwd_geom_kernel with GeomLayout): rows a
// warp all a receiver can have, or what fits with 8 warps a block (fewer
// where a warp's tables alone do not fit: large d); small shapes take more
// warps a block, up to `most_warps`; as many blocks as stay resident.
// Returns 0 or a CUDA error.
template <typename Lay, typename K>
int bin_launch(K kernel, int most_warps, int M, int k, int ci, int d, int* nrows,
               int* nwarp, int* blocks, size_t* smem) {
  const int gs = round4(ci), most = 8 * k < d * d * d ? 8 * k : d * d * d;
  const size_t fixed = Lay(d, k, gs, 0).per_warp, row = (size_t)gs * sizeof(float) + sizeof(int);
  *nwarp = 8;
  while (*nwarp > 1 && (size_t)MAX_SMEM / *nwarp < fixed + 16 + row) *nwarp /= 2;
  if ((size_t)MAX_SMEM / *nwarp < fixed + 16 + row) return (int)cudaErrorInvalidValue;
  const size_t fit = ((size_t)MAX_SMEM / *nwarp - fixed - 16) / row;
  *nrows = fit < (size_t)most ? (int)fit : most;
  const size_t per_warp = Lay(d, k, gs, *nrows).per_warp;
  while (*nwarp < most_warps && 2 * *nwarp * per_warp <= (size_t)MAX_SMEM / 2) *nwarp *= 2;
  *smem = *nwarp * per_warp;
  int err = set_smem(kernel, *smem);
  if (err) return err;
  int dev = 0, sms = 0, resident = 0;
  if ((err = (int)cudaGetDevice(&dev)) != 0) return err;
  if ((err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != 0)
    return err;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, *nwarp * 32,
                                                           *smem);
  if (err) return err;
  if (resident < 1) return (int)cudaErrorInvalidValue;
  const long long need = ((long long)M + *nwarp - 1) / *nwarp;
  const long long most_blocks = (long long)sms * resident;
  *blocks = (int)(need < most_blocks ? need : most_blocks);
  return 0;
}

}  // namespace

extern "C" {

// The plan's first half: masks (M, ceil(d^3 / 32)) and counts (M + 1: a
// leading 0, then each receiver's) of the cells each receiver's live corners
// touch, from gx, gy, gz, win (M, k); zeroes cell_counts (d^3) for the second
// half. all_edges: an edge of zero window counts as live (B6's plan).
int contconv_plan_masks(const float* gx, const float* gy, const float* gz,
                        const float* win, int M, int k, int d, int all_edges,
                        uint32_t* masks, int* counts, int* cell_counts, void* stream) {
  if (bad_shape(M, k, 1, 1, d)) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)PW * ((d * d * d + 31) / 32) * sizeof(uint32_t);
  plan_masks_kernel<<<(M + PW - 1) / PW, PW * 32, smem, (cudaStream_t)stream>>>(
      gx, gy, gz, win, M, k, d, all_edges, masks, counts, cell_counts);
  return (int)cudaGetLastError();
}

// The plan's second half, from the masks, rstart (M + 1; the counts' prefix
// sum) and the zeroed cell_counts (d^3): the receiver-major cell_r and
// slot_of, the cell-major recv_of (each with room for every pair), the
// cells' offsets coff (d^3 + 1) and their first work items istart (d^3 + 1)
// for items of at most `rows` rows.
int contconv_plan_cells(const uint32_t* masks, const int* rstart, int M, int d, int rows,
                        int* cell_counts, int16_t* cell_r, int* slot_of, int* recv_of,
                        int* coff, int* istart, void* stream) {
  if (bad_shape(M, 1, 1, 1, d) || rows < 1) return (int)cudaErrorInvalidValue;
  const int z = d * d * d, nw = (z + 31) / 32;
  const long long nwords = (long long)M * nw, per_block = THREADS * COUNT_WORDS;
  const size_t smem = (size_t)z * sizeof(int);
  if (smem > DEFAULT_SMEM) {
    const int err = set_smem(plan_cell_counts_kernel, smem);
    if (err) return err;
  }
  plan_cell_counts_kernel<<<(unsigned)((nwords + per_block - 1) / per_block), THREADS, smem,
                            (cudaStream_t)stream>>>(masks, nwords, nw, z, cell_counts);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  plan_cells_kernel<<<z, CELL_THREADS, 0, (cudaStream_t)stream>>>(
      masks, rstart, cell_counts, M, nw, z, rows, cell_r, slot_of, recv_of, coff, istart);
  return (int)cudaGetLastError();
}

// g (P, round4(ci)), 16-byte aligned: the bins of every pair of the plan
// (rstart (M + 1), cell_r (P), slot_of (P)) at its cell-major row, pad
// columns zero; feat (M, k, ci) at any 4-byte offset.
int contconv_pair_bins(const float* gx, const float* gy, const float* gz,
                       const float* win, const float* feat, const int* rstart,
                       const int16_t* cell_r, const int* slot_of, int M, int k, int ci,
                       int d, float* g, void* stream) {
  if (bad_shape(M, k, ci, 1, d) || ((uintptr_t)g & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  int nrows, nwarp, blocks;
  size_t smem;
  const int err = bin_launch<BinLayout>(bins_kernel, BIN_WARPS, M, k, ci, d, &nrows, &nwarp,
                                        &blocks, &smem);
  if (err) return err;
  bins_kernel<<<blocks, nwarp * 32, smem, (cudaStream_t)stream>>>(
      gx, gy, gz, win, feat, rstart, cell_r, slot_of, M, k, ci, d, nrows, g);
  return (int)cudaGetLastError();
}

// B5's last pass: dfeat (M, k, ci), 16-byte rows where ci % 4 == 0, from dG
// (P, round4(ci)), 16-byte aligned, at the plan's cell-major rows.
int contconv_pair_unbins(const float* gx, const float* gy, const float* gz,
                         const float* win, const float* dg, const int* rstart,
                         const int16_t* cell_r, const int* slot_of, int M, int k, int ci,
                         int d, float* dfeat, void* stream) {
  if (bad_shape(M, k, ci, 1, d) || ((uintptr_t)dg & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  int nrows, nwarp, blocks;
  size_t smem;
  const int err = bin_launch<BinLayout>(unbins_kernel, BIN_WARPS, M, k, ci, d, &nrows,
                                        &nwarp, &blocks, &smem);
  if (err) return err;
  unbins_kernel<<<blocks, nwarp * 32, smem, (cudaStream_t)stream>>>(
      gx, gy, gz, win, dg, rstart, cell_r, slot_of, M, k, ci, d, nrows, dfeat);
  return (int)cudaGetLastError();
}

// B6's geometry pass: dgx, dgy, dgz, dwin (M, k) from dG (P, round4(ci)),
// 16-byte aligned, at the cell-major rows of a plan that keeps the edges of
// zero window (rstart, cell_r, slot_of), gx, gy, gz, win (M, k) and feat (M,
// k, ci) at any 4-byte offset.
int contconv_pair_geom(const float* gx, const float* gy, const float* gz,
                       const float* win, const float* feat, const float* dg,
                       const int* rstart, const int16_t* cell_r, const int* slot_of, int M,
                       int k, int ci, int d, float* dgx, float* dgy, float* dgz,
                       float* dwin, void* stream) {
  if (bad_shape(M, k, ci, 1, d) || ((uintptr_t)dg & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  int nrows, nwarp, blocks;
  size_t smem;
  const int err = bin_launch<GeomLayout>(bwd_geom_kernel, GEOM_WARPS, M, k, ci, d, &nrows,
                                         &nwarp, &blocks, &smem);
  if (err) return err;
  bwd_geom_kernel<<<blocks, nwarp * 32, smem, (cudaStream_t)stream>>>(
      gx, gy, gz, win, feat, dg, rstart, cell_r, slot_of, M, k, ci, d, nrows, dgx, dgy, dgz,
      dwin);
  return (int)cudaGetLastError();
}

// The grouped product of B3 and B5 over the plan's cell-major rows: y (P,
// round4(nd)) = A times the pair's cell of F (d^3 * kd, round4(nd)), pad
// columns zero, where A's row s is a (round4(kd) floats a row, pad columns
// zero) at row recv_of[s] (B5's dG; recv_of (P)) or, with recv_of null, at
// row s (B3). coff (d^3 + 1) the cells' row offsets; a, F and y 16-byte
// aligned. istart (d^3 + 1) cuts the cells into work items of at most `rows`
// rows, at most `nitems` in all.
int contconv_pair_product(const float* a, const int* recv_of, const float* F,
                          const int* coff, const int* istart, int kd, int nd, int d,
                          int rows, int nitems, float* y, void* stream) {
  if (bad_shape(1, 1, kd, nd, d) || rows < 1 || nitems < 1 ||
      (((uintptr_t)a | (uintptr_t)F | (uintptr_t)y) & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)KC * SLAB + (size_t)2 * PT * AS) * sizeof(float);
  const dim3 grid(nitems, (round4(nd) + SLAB - 1) / SLAB);
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  int err;
  if (recv_of) {
    if ((err = set_smem(pair_product_kernel<true>, smem)) != 0) return err;
    pair_product_kernel<true><<<grid, THREADS, smem, s>>>(a, recv_of, F, coff, istart, kd,
                                                          nd, d * d * d, rows, y);
  } else {
    if ((err = set_smem(pair_product_kernel<false>, smem)) != 0) return err;
    pair_product_kernel<false><<<grid, THREADS, smem, s>>>(a, nullptr, F, coff, istart, kd,
                                                           nd, d * d * d, rows, y);
  }
  return (int)cudaGetLastError();
}

// B3's last pass: out (M, co) = each receiver's rows of y (P, round4(co)),
// at slot_of[rstart[m] ..], added in that order.
int contconv_row_sum(const float* y, const int* rstart, const int* slot_of, int M,
                     int co, float* out, void* stream) {
  if (M <= 0 || co <= 0 || ((uintptr_t)y & 15u) != 0) return (int)cudaErrorInvalidValue;
  row_sum_kernel<<<(M + PW - 1) / PW, PW * 32, 0, (cudaStream_t)stream>>>(
      y, rstart, slot_of, M, co, out);
  return (int)cudaGetLastError();
}

// B4: dF (d^3, ci, co) from the bins g (P, round4(ci)), dout (M, co) and the
// plan's coff (d^3 + 1) and recv_of (P). istart (d^3 + 1) cuts the cells into
// work items of at most `rows` rows, at most `nitems` in all; `partial` holds
// (nitems, ci, co) floats of scratch.
int contconv_bwd_filters(const float* g, const float* dout, const int* coff,
                         const int* recv_of, const int* istart, int ci, int co, int d,
                         int rows, int nitems, float* partial, float* dF, void* stream) {
  if (bad_shape(1, 1, ci, co, d) || rows < 1 || nitems < 1 || partial == nullptr ||
      (ci + SLAB - 1) / SLAB > 65535 || (co + SLAB - 1) / SLAB > 65535 ||
      ((uintptr_t)g & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)4 * KT * SLAB * sizeof(float);
  const int err = set_smem(bwd_filters_kernel, smem);
  if (err) return err;
  const int nc = d * d * d;
  const dim3 grid(nitems, (ci + SLAB - 1) / SLAB, (co + SLAB - 1) / SLAB);
  bwd_filters_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      g, dout, coff, recv_of, istart, ci, co, nc, rows, partial);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t n = (size_t)nc * ci * co;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  sum_banks_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(partial, istart, nc, ci * co, dF);
  return (int)cudaGetLastError();
}

}  // extern "C"
