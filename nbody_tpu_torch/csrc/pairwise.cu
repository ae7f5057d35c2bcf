// All-pairs softened gravity (B1), its near-list form for the treecodes' near
// pass, and pairwise potential energy (B2) for Hopper (sm_90a), with a plain
// C interface bound from Python by ctypes
// (nbody_tpu_torch/ops/build.py, nbody_tpu_torch/ops/pairwise.py).
//
// Every entry point launches on the caller's stream, does not synchronise and
// allocates nothing: the Python wrapper allocates outputs and scratch. Each
// returns cudaGetLastError() after its launches, so a launch the device
// refuses is reported to the wrapper, which raises.
//
// B1's sources arrive packed as float4 [x, y, z, m] (the wrapper builds that
// copy from the (N, 3) positions and (N,) masses); targets stay (N, 3)
// row-major. B2 reads the (N, 3) positions and (N,) masses as they are.

#include <climits>
#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------- B1: force
//
// Replaces nbody_tpu/ops/pairwise.py::_force_kernel (Pallas, TPU):
//
//   a_i = G * sum_j m_j (r_j - r_i) * rsqrt(max(|r_j - r_i|^2 + eps^2, 1e-18))^3
//
// No self mask: a coincident pair has dx == dy == dz == 0, so it adds an exact
// zero, and the 1e-18 floor keeps rsqrt finite even at eps == 0. Zero-mass
// sources (the ragged tail of the last tile) add exact zeros too.
//
// What bounds it: FP32 issue. Per pair the kernel does 3 subtractions,
// 3 FMAs for d2, the floor's max, one MUFU rsqrt, 3 multiplies for w and
// 3 FMAs into the accumulators: about 14 instructions (~20 flops), every one
// an issue slot of its warp scheduler. Global memory is not a limit: each
// source is read once per block into shared memory and then used by all of
// the block's rows.
//
// Design: FORCE_ROWS targets per block, SPLIT threads per group of TPT
// targets, the TPT targets in registers. The block stages TILE sources in
// shared memory (one float4 per thread); lane s of a group takes every
// SPLIT-th source of the tile, so the SPLIT lanes read SPLIT consecutive
// float4s (one 128-byte shared-memory wavefront, broadcast to the other
// groups of the warp), and one load feeds TPT pairs. The rsqrt is
// rsqrt.approx.ftz: d2 >= 1e-18 is never subnormal, so it gives rsqrtf's
// value without rsqrtf's guard for subnormal inputs (three instructions a
// pair). Coordinate differences are exact (no |a|^2 + |b|^2 - 2ab
// expansion) and there are no tensor cores: the TPU kernel's matrix-unit form
// lost ~1e-4 relative accuracy to cancellation (nbody_tpu/ops/pairwise.py:
// 93-96).
//
// Summation order, as the reference's (nbody_tpu/ops/pairwise.py:97-106: a
// tile's sum, then the running total): each thread sums its TILE / SPLIT
// sources of a tile into fresh accumulators and adds that partial to its
// running total; the SPLIT lanes' totals meet in a fixed butterfly of warp
// shuffles. So a float32 chain adds TILE / SPLIT pairs or one partial a tile
// (3,907 at 10^6 sources, fewer in chunks): one chain over a lane's 125,000
// sources of 10^6 drifts ~1e-4 of max |a| from the float64 sum, over the
// 2e-5 bar (tests/test_forces.py:56,65).
//
// Sources split over blocks: where the target tiles alone leave the card
// short of blocks (few targets, as the 4096 audit receivers over 1M
// sources), the wrapper cuts the sources into `chunk`-sized pieces
// (ops/pairwise.py, force_chunk): grid (target tiles, chunks), each block
// writes its chunk's partial sums, and force_chunks_kernel adds them in chunk
// order and scales by G. One chunk: the first kernel writes G * a itself,
// one launch (every N <= 500 shape of the datagen). No float atomics: the
// same bits on every run.
//
// Scenes: a group of S scenes of equal shape (the datagen's seed-only
// groups, jax.vmap of the Pallas call in nbody_tpu/data/generate.py:243-256)
// is one launch, the scene on blockIdx.z and every operand offset by its
// scene. Each scene keeps the single-scene call's chunk (the wrapper sizes
// it from one scene's shape), tiles and order, so scene s of a group gives
// the bits of a call on scene s alone.
constexpr int SPLIT = 8;                        // lanes a target group
constexpr int FORCE_THREADS = 256;
constexpr int TILE = FORCE_THREADS;             // sources staged a step
constexpr int GROUPS = FORCE_THREADS / SPLIT;   // target groups a block
constexpr int TPT = 4;                          // targets a group (a thread)
constexpr int FORCE_ROWS = GROUPS * TPT;        // targets a block, both forms
constexpr int NEAR_IDS = 1024;                  // near list: ids staged a segment
constexpr int SUM_THREADS = 256;
constexpr float D2_FLOOR = 1e-18f;

static_assert(32 % SPLIT == 0, "a group's lanes must share a warp");
static_assert(NEAR_IDS % TILE == 0, "a segment's candidates end on a tile boundary");

__device__ __forceinline__ float rsqrt_ftz(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The one pair of both forms of B1: the source s = [x, y, z, m] pulls the
// target (xi, yi, zi); adds m (r_s - r_i) / max(|r_s - r_i|^2 + eps^2,
// 1e-18)^{3/2}, without the factor G.
__device__ __forceinline__ void pair_pull(const float4 s, float xi, float yi,
                                          float zi, float eps2, float& ax,
                                          float& ay, float& az) {
  const float dx = s.x - xi;
  const float dy = s.y - yi;
  const float dz = s.z - zi;
  const float d2 = fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, eps2)));
  const float inv = rsqrt_ftz(fmaxf(d2, D2_FLOOR));
  const float w = s.w * inv * inv * inv;
  ax = fmaf(w, dx, ax);
  ay = fmaf(w, dy, ay);
  az = fmaf(w, dz, az);
}

// The lanes' sums in a fixed butterfly: every lane ends with the same bits.
__device__ __forceinline__ void lane_sum(float& ax, float& ay, float& az) {
#pragma unroll
  for (int off = SPLIT / 2; off > 0; off >>= 1) {
    ax += __shfl_xor_sync(0xffffffffu, ax, off);
    ay += __shfl_xor_sync(0xffffffffu, ay, off);
    az += __shfl_xor_sync(0xffffffffu, az, off);
  }
}

// The tile body of both forms of B1: the TILE staged sources on a thread's
// TPT targets (x, y, z), lane `lane` taking every SPLIT-th, summed into a
// fresh partial that is then added to the running totals (ax, ay, az).
__device__ __forceinline__ void add_tile(const float4* __restrict__ tile, int lane,
                                         const float (&x)[TPT], const float (&y)[TPT],
                                         const float (&z)[TPT], float eps2, float (&ax)[TPT],
                                         float (&ay)[TPT], float (&az)[TPT]) {
  float px[TPT], py[TPT], pz[TPT];
#pragma unroll
  for (int u = 0; u < TPT; ++u) px[u] = py[u] = pz[u] = 0.f;
#pragma unroll 8
  for (int t = lane; t < TILE; t += SPLIT) {
    const float4 s = tile[t];
#pragma unroll
    for (int u = 0; u < TPT; ++u) pair_pull(s, x[u], y[u], z[u], eps2, px[u], py[u], pz[u]);
  }
#pragma unroll
  for (int u = 0; u < TPT; ++u) {
    ax[u] += px[u];
    ay[u] += py[u];
    az[u] += pz[u];
  }
}

// Rows row0 .. row0 + TPT - 1 of pos (n rows) into (x, y, z), rows past n
// as the origin, and zero totals.
__device__ __forceinline__ void load_targets(const float* __restrict__ pos, int row0, int n,
                                             float (&x)[TPT], float (&y)[TPT], float (&z)[TPT],
                                             float (&ax)[TPT], float (&ay)[TPT],
                                             float (&az)[TPT]) {
#pragma unroll
  for (int u = 0; u < TPT; ++u) {
    const int r = row0 + u;
    x[u] = r < n ? pos[3 * (size_t)r] : 0.f;
    y[u] = r < n ? pos[3 * (size_t)r + 1] : 0.f;
    z[u] = r < n ? pos[3 * (size_t)r + 2] : 0.f;
    ax[u] = ay[u] = az[u] = 0.f;
  }
}

// The lanes' butterfly, then scale * the totals into rows row0 + u < n of
// dst (n, 3): TPT lanes write, one target each.
__device__ __forceinline__ void write_targets(float* __restrict__ dst, int row0, int n, int lane,
                                              float scale, float (&ax)[TPT], float (&ay)[TPT],
                                              float (&az)[TPT]) {
#pragma unroll
  for (int u = 0; u < TPT; ++u) {
    lane_sum(ax[u], ay[u], az[u]);
    const int r = row0 + u;
    if (lane == u && r < n) {  // every lane has the sums: TPT lanes write
      dst[3 * (size_t)r] = scale * ax[u];
      dst[3 * (size_t)r + 1] = scale * ay[u];
      dst[3 * (size_t)r + 2] = scale * az[u];
    }
  }
}

// Block (tile x, chunk y, scene z): targets x * FORCE_ROWS .. of scene z's
// pos_i against its sources y * chunk .. min(nj, (y + 1) * chunk). One
// chunk: out = G * a (scenes, ni, 3); several: out = chunk y's sum,
// unscaled, at ((z * chunks + y) * ni + i) * 3.
__global__ void __launch_bounds__(FORCE_THREADS)
force_kernel(const float* __restrict__ pos_i, const float4* __restrict__ src,
             int ni, int nj, int chunk, float g, float eps2, float* __restrict__ out) {
  __shared__ float4 tile[TILE];
  pos_i += (size_t)blockIdx.z * ni * 3;
  src += (size_t)blockIdx.z * nj;
  const int lane = threadIdx.x % SPLIT;
  const int row0 = blockIdx.x * FORCE_ROWS + (threadIdx.x / SPLIT) * TPT;
  float xi[TPT], yi[TPT], zi[TPT], ax[TPT], ay[TPT], az[TPT];
  load_targets(pos_i, row0, ni, xi, yi, zi, ax, ay, az);
  const int j0 = blockIdx.y * chunk;
  const int j1 = min(nj, j0 + chunk);
  for (int base = j0; base < j1; base += TILE) {
    const int j = base + threadIdx.x;
    tile[threadIdx.x] = j < j1 ? src[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    add_tile(tile, lane, xi, yi, zi, eps2, ax, ay, az);
    __syncthreads();
  }
  const bool one = gridDim.y == 1;
  const float scale = one ? g : 1.f;
  float* dst = out + ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * ni * 3;
  write_targets(dst, row0, ni, lane, scale, ax, ay, az);
}

// acc (scenes, n floats) = G * each scene's chunk sums (scenes, chunks, n),
// added in chunk order; total = scenes * n.
__global__ void __launch_bounds__(SUM_THREADS)
force_chunks_kernel(const float* __restrict__ part, int chunks, long long n, long long total,
                    float g, float* __restrict__ acc) {
  const long long i = (long long)blockIdx.x * SUM_THREADS + threadIdx.x;
  if (i >= total) return;
  const long long scene = i / n;
  const float* p = part + scene * chunks * n + (i - scene * n);
  float s = p[0];
  for (int c = 1; c < chunks; ++c) s += p[(size_t)c * n];
  acc[i] = g * s;
}

// ------------------------------------------------ B1, near-list form
//
// Replaces the near pass of nbody_tpu/ops/treeforce.py (bh, bh2: :484-489;
// bh3: :1081-1085), where jax.vmap(pallas_partial_accelerations) runs B1 once
// per receiver block over its gathered candidates. Here one launch covers all
// receiver blocks: group g's `rows` targets (rows g * rows .. of q) see the
// `list` source blocks near[g, :], each `src_block` consecutive rows of the
// packed sources, read by id (no gathered (groups, list * src_block) copy).
// Candidate c of a group is row c % src_block of block near[g, c / src_block].
// An id outside [0, n_src_blocks) reads as zero-mass sources at the origin,
// which add exact zeros.
//
// Bound: FP32 issue, ~20 flops and one MUFU rsqrt a pair, as B1. So the
// design is B1's: FORCE_ROWS targets a block, TPT a thread over SPLIT lanes,
// and the tile body itself (add_tile), so one shared-memory load feeds
// TPT pairs and a target sums a fresh partial a tile of TILE candidates,
// tiles at multiples of TILE of c: the same order, and the same bits, as
// force_kernel on the gathered candidates in one chunk. What the near list
// adds is the addressing. The block stages its group's ids in shared memory
// once (NEAR_IDS a segment; a segment's candidates end on a tile boundary,
// so segments do not move the tiles), each as its first source row
// j * src_block, or -1; a thread then walks its candidate c = base +
// threadIdx.x as (k, r) = (c / src_block, c % src_block), divided once and
// advanced a tile by (TILE / src_block, TILE % src_block) with one carry, so
// no runtime divide a candidate for any src_block.
//
// Scenes: a treecode scene group (S scenes of equal shape) is one launch,
// the scene on blockIdx.y: q, near and acc hold each scene's groups after
// the scenes before it, src each scene's n_src_blocks blocks. An id is
// checked against its own scene's block count, so an id outside [0,
// n_src_blocks) reads as zero-mass sources and never as a block of the next
// scene; each group keeps add_tile's order, so each scene the bits of a call
// on it alone.
__global__ void __launch_bounds__(FORCE_THREADS)
near_force_kernel(const float* __restrict__ q, const float4* __restrict__ src,
                  const int* __restrict__ near, int rows, int list, int src_block,
                  int n_src_blocks, int tiles, float g, float eps2,
                  float* __restrict__ acc) {
  __shared__ float4 tile[TILE];
  __shared__ int first[NEAR_IDS];  // a staged id's first source row, or -1
  // this block's group among all scenes' groups, and its scene's sources
  const size_t grp = (size_t)blockIdx.y * (gridDim.x / tiles) + blockIdx.x / tiles;
  src += (size_t)blockIdx.y * n_src_blocks * src_block;
  const int lane = threadIdx.x % SPLIT;
  const int row0 = (blockIdx.x % tiles) * FORCE_ROWS + (threadIdx.x / SPLIT) * TPT;
  float xi[TPT], yi[TPT], zi[TPT], ax[TPT], ay[TPT], az[TPT];
  load_targets(q + grp * rows * 3, row0, rows, xi, yi, zi, ax, ay, az);
  const int* ids = near + grp * list;
  const int k0 = threadIdx.x / src_block, r0 = threadIdx.x % src_block;
  const int dk = TILE / src_block, dr = TILE % src_block;
  for (int seg = 0; seg < list; seg += NEAR_IDS) {
    const int nk = min(NEAR_IDS, list - seg);
    __syncthreads();  // the last segment's tiles are read
    for (int i = threadIdx.x; i < nk; i += FORCE_THREADS) {
      const int j = ids[seg + i];
      first[i] = j >= 0 && j < n_src_blocks ? j * src_block : -1;
    }
    const int ncand = nk * src_block;
    int k = k0, r = r0;
    for (int base = 0; base < ncand; base += TILE) {
      __syncthreads();  // ids staged; the last tile read
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k < nk) {
        const int f = first[k];
        if (f >= 0) s = src[(size_t)f + r];
      }
      tile[threadIdx.x] = s;
      __syncthreads();
      add_tile(tile, lane, xi, yi, zi, eps2, ax, ay, az);
      k += dk;
      r += dr;
      if (r >= src_block) {
        r -= src_block;
        ++k;
      }
    }
  }
  write_targets(acc + grp * rows * 3, row0, rows, lane, g, ax, ay, az);
}

// --------------------------------------------------------------- B2: energy
//
// Replaces nbody_tpu/ops/pairwise.py::_energy_kernel (Pallas, TPU):
//
//   U = -G * sum_{pairs} m_i m_j / max(|r_i - r_j| + eps, 1e-30)
//
// eps is added to the distance, not in quadrature, as the reference does.
// masked != 0: one set (targets == sources), strict upper triangle on global
// indices, so each unordered pair counts once. masked == 0: every (i, j) pair
// of two disjoint sets (the cross term of a block-triangle decomposition).
//
// What bounds it: the multi-function unit and issue. Per pair: 3
// subtractions, a multiply and 2 FMAs for d2, sqrt.approx, the add of eps,
// the floor's max, rcp.approx and one FMA into the sum, about 11
// instructions of which two are MUFU operations. At 16 MUFU results a clock
// an SM the two take 16 cycles of a warp's pair where the other nine take
// nine, so at 20k bodies (2e8 pairs) the floor is ~0.1 ms; replacing a
// MUFU operation by FMA iterations moves the work to issue without gain.
// Memory traffic is a few MB.
//
// Design: one launch a call. The (rows x sources) plane is cut into square
// E_ROWS x E_TILE tiles; masked, only the tiles on or above the diagonal
// exist (the "items"), and only the diagonal ones test j > i. The items are
// numbered row-major and each of `gridDim.x` blocks (a function of the shape
// and the SM count, ops/pairwise.py::energy_tiles) walks one contiguous range
// of them, so no block exits empty. Per item the block stages E_TILE sources
// from the (N, 3) positions and (N,) masses; a group of E_SPLIT lanes holds
// E_TPT targets, each lane takes every E_SPLIT-th source (one shared-memory
// load feeds E_TPT pairs). A lane sums its 32 pairs of a target in float32
// into a fresh partial, then adds m_i * partial in float64: no float32
// chain spans more than one tile. The block reduces its float64 sum
// in a fixed order and writes one partial; the last block to finish (an
// integer ticket, no float atomics) adds the partials in block order in
// float64, writes -G * U as float32 to the 0-d output and resets the
// ticket. So the result has the same bits on every run on one card.
//
// Scratch (tickets and partials) belongs to one (device, stream): calls on
// one stream run one after another, so the next call starts after the last
// block of this one has reset the ticket; calls on two streams get two
// scratch buffers (ops/pairwise.py::_energy_scratch). Its tickets must be
// zeroed once when they are made.
//
// Scenes: a group of S scenes of equal shape is one launch of (blocks, S)
// blocks, the scene on blockIdx.y, each scene with its own ticket, its own
// run of `blocks` partial slots and its own output. A scene's blocks walk
// the items of a single-scene call and its last block adds its partials in
// block order, so scene s of a group gives the bits of a call on scene s
// alone.
constexpr int E_THREADS = 256;
constexpr int E_SPLIT = 4;                       // lanes a target group
constexpr int E_TPT = 2;                         // targets a group (a thread)
constexpr int E_ROWS = E_THREADS / E_SPLIT * E_TPT;  // targets a tile
constexpr int E_TILE = E_ROWS;                   // sources a tile (square tiles)
constexpr int E_BLOCKS_PER_SM = 8;              // resident an SM (launch bound), launched at most
constexpr float DIST_FLOOR = 1e-30f;

static_assert(32 % E_SPLIT == 0, "a group's lanes must share a warp");
static_assert(E_TILE <= E_THREADS, "one thread stages one source");

__device__ __forceinline__ float sqrt_ftz(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_ftz(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Items (row tile t, column tile c) before row tile t: t * ct for the cross
// form; masked, row s holds ct - s items (c = s .. ct - 1).
__host__ __device__ __forceinline__ long long items_before(long long t, long long ct,
                                                          int masked) {
  return masked ? t * ct - t * (t - 1) / 2 : t * ct;
}

// One tile: each thread's E_TPT targets (rows i0 .. i0 + E_TPT - 1) against
// its share of the staged sources (columns j0 + lane, j0 + lane + E_SPLIT,
// ...); p[u] = sum m_j / max(d + eps, 1e-30). MASK keeps j > i only.
template <bool MASK>
__device__ __forceinline__ void energy_tile(const float4* tile, int lane, int i0, int j0,
                                            const float (&xi)[E_TPT], const float (&yi)[E_TPT],
                                            const float (&zi)[E_TPT], float eps,
                                            float (&p)[E_TPT]) {
#pragma unroll
  for (int u = 0; u < E_TPT; ++u) p[u] = 0.f;
#pragma unroll 4
  for (int t = lane; t < E_TILE; t += E_SPLIT) {
    const float4 s = tile[t];
#pragma unroll
    for (int u = 0; u < E_TPT; ++u) {
      const float dx = s.x - xi[u];
      const float dy = s.y - yi[u];
      const float dz = s.z - zi[u];
      const float d2 = fmaf(dx, dx, fmaf(dy, dy, dz * dz));
      const float term = s.w * rcp_ftz(fmaxf(sqrt_ftz(d2) + eps, DIST_FLOOR));
      if (MASK) {
        p[u] += j0 + t > i0 + u ? term : 0.f;
      } else {
        p[u] += term;
      }
    }
  }
}

// Sum of v over the block in a fixed order (a butterfly a warp, then the
// warps in order); the result is valid in thread 0.
__device__ __forceinline__ double block_sum(double v, double* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < E_THREADS / 32; ++w) s += red[w];
  return s;
}

__global__ void __launch_bounds__(E_THREADS, E_BLOCKS_PER_SM)
energy_kernel(const float* __restrict__ pos_i, const float* __restrict__ mass_i, int ni,
              const float* __restrict__ pos_j, const float* __restrict__ mass_j, int nj,
              double g, float eps, int masked, unsigned int* __restrict__ ticket,
              double* __restrict__ partials, float* __restrict__ out) {
  __shared__ float4 tile[E_TILE];
  __shared__ double red[E_THREADS / 32];
  __shared__ bool last;
  const unsigned int scene = blockIdx.y;
  pos_i += (size_t)scene * ni * 3;
  mass_i += (size_t)scene * ni;
  pos_j += (size_t)scene * nj * 3;
  mass_j += (size_t)scene * nj;
  ticket += scene;
  partials += (size_t)scene * gridDim.x;
  out += scene;
  const int lane = threadIdx.x % E_SPLIT;
  const int grp = threadIdx.x / E_SPLIT;
  const long long rt = (ni + E_ROWS - 1) / E_ROWS;
  const long long ct = (nj + E_TILE - 1) / E_TILE;
  const long long items = items_before(rt, ct, masked);
  const long long lo = blockIdx.x * items / gridDim.x;
  const long long hi = (blockIdx.x + 1) * items / gridDim.x;
  // the item lo -> (t, c): t the last row tile that starts at or before lo
  long long t = 0, c = 0;
  if (masked) {
    long long a = 0, b = rt - 1;
    while (a < b) {
      const long long mid = (a + b + 1) / 2;
      if (items_before(mid, ct, masked) <= lo) a = mid; else b = mid - 1;
    }
    t = a;
    c = t + (lo - items_before(t, ct, masked));
  } else {
    t = lo / ct;
    c = lo % ct;
  }
  double acc = 0.0;
  float xi[E_TPT], yi[E_TPT], zi[E_TPT], mi[E_TPT];
  long long loaded = -1;
  for (long long it = lo; it < hi; ++it) {
    const int i0 = (int)(t * E_ROWS) + grp * E_TPT;
    if (t != loaded) {  // this row tile's targets, into registers
#pragma unroll
      for (int u = 0; u < E_TPT; ++u) {
        const int i = i0 + u;
        xi[u] = i < ni ? pos_i[3 * (size_t)i] : 0.f;
        yi[u] = i < ni ? pos_i[3 * (size_t)i + 1] : 0.f;
        zi[u] = i < ni ? pos_i[3 * (size_t)i + 2] : 0.f;
        mi[u] = i < ni ? mass_i[i] : 0.f;
      }
      loaded = t;
    }
    const int j0 = (int)(c * E_TILE);
    if (threadIdx.x < E_TILE) {
      const int j = j0 + threadIdx.x;
      tile[threadIdx.x] = j < nj ? make_float4(pos_j[3 * (size_t)j], pos_j[3 * (size_t)j + 1],
                                               pos_j[3 * (size_t)j + 2], mass_j[j])
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    float p[E_TPT];
    if (masked && t == c)
      energy_tile<true>(tile, lane, i0, j0, xi, yi, zi, eps, p);
    else
      energy_tile<false>(tile, lane, i0, j0, xi, yi, zi, eps, p);
#pragma unroll
    for (int u = 0; u < E_TPT; ++u) acc += (double)mi[u] * (double)p[u];
    __syncthreads();
    if (++c == ct) {
      ++t;
      c = masked ? t : 0;
    }
  }
  const double mine = block_sum(acc, red);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = mine;
    __threadfence();  // the partial is visible before the ticket is taken
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double s = 0.0;
  for (int blk = threadIdx.x; blk < (int)gridDim.x; blk += E_THREADS) s += __ldcg(partials + blk);
  __syncthreads();  // red is reused
  const double total = block_sum(s, red);
  if (threadIdx.x == 0) {
    *out = (float)(-g * total);
    *ticket = 0u;
  }
}

}  // namespace

extern "C" {

// acc (scenes, ni, 3) = forces on each scene's pos_i (ni, 3) from its packed
// sources src (nj float4), the sources cut into chunks of `chunk` (a multiple
// of the tile, or >= nj for one chunk). Several chunks need `partial`,
// (scenes, chunks, ni, 3) floats of scratch, and a second launch that adds
// them in chunk order. 1 <= scenes <= 65535 (the grid's z).
int nbody_force(const float* pos_i, const void* src, int scenes, int ni, int nj, int chunk,
                float g, float eps, float* partial, float* acc, void* stream) {
  if (ni <= 0 || nj < 0 || chunk <= 0 || scenes <= 0 || scenes > 65535)
    return (int)cudaErrorInvalidValue;
  const long long chunks = nj > chunk ? ((long long)nj + chunk - 1) / chunk : 1;
  if (chunks > 1 && (chunk % TILE != 0 || partial == nullptr || chunks > 65535))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((ni + FORCE_ROWS - 1) / FORCE_ROWS, (unsigned)chunks, (unsigned)scenes);
  const cudaStream_t s = (cudaStream_t)stream;
  force_kernel<<<grid, FORCE_THREADS, 0, s>>>(pos_i, (const float4*)src, ni, nj, chunk, g,
                                              eps * eps, chunks > 1 ? partial : acc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return (int)err;
  const long long n = 3LL * ni, total = n * scenes;
  force_chunks_kernel<<<(unsigned)((total + SUM_THREADS - 1) / SUM_THREADS), SUM_THREADS, 0,
                        s>>>(partial, (int)chunks, n, total, g, acc);
  return (int)cudaGetLastError();
}

// acc (scenes, groups, rows, 3) = forces on q (scenes, groups, rows, 3)
// from the source blocks near[s, g, :] (scenes, groups, list) of scene s's
// packed sources src (scenes, n_src_blocks * src_block float4), for every
// scene s and group g; 1 <= scenes <= 65535 (the grid's y).
int nbody_near_force(const float* q, const void* src, const int* near, int scenes,
                     int groups, int rows, int list, int src_block, int n_src_blocks,
                     float g, float eps, float* acc, void* stream) {
  if (groups <= 0 || rows <= 0 || list < 0 || src_block <= 0 || n_src_blocks < 0 ||
      scenes <= 0 || scenes > 65535 || (long long)list * src_block > INT_MAX ||
      (long long)n_src_blocks * src_block > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int tiles = (rows + FORCE_ROWS - 1) / FORCE_ROWS;
  if ((long long)groups * tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  near_force_kernel<<<dim3(groups * tiles, scenes), FORCE_THREADS, 0, (cudaStream_t)stream>>>(
      q, (const float4*)src, near, rows, list, src_block, n_src_blocks, tiles, g,
      eps * eps, acc);
  return (int)cudaGetLastError();
}

// out[s] (float32) = -g * sum m_i m_j / max(d + eps, 1e-30) of scene s, for
// each of `scenes` scenes (1 <= scenes <= 65535; each scene's pos_i (ni, 3),
// mass_i (ni), pos_j (nj, 3), mass_j (nj) follow the last), in one launch of
// `blocks` blocks a scene (1 <= blocks <= the tile items; ops/pairwise.py::
// energy_tiles). tickets: `scenes` counters of this stream, zero between
// calls; partials: scenes * blocks doubles.
int nbody_energy(const float* pos_i, const float* mass_i, int ni, const float* pos_j,
                 const float* mass_j, int nj, double g, float eps, int masked, int scenes,
                 int blocks, unsigned int* tickets, double* partials, float* out,
                 void* stream) {
  const long long rt = (ni + E_ROWS - 1) / E_ROWS;
  const long long ct = (nj + E_TILE - 1) / E_TILE;
  if (ni <= 0 || nj <= 0 || (masked && ni != nj) || blocks <= 0 ||
      blocks > items_before(rt, ct, masked) || scenes <= 0 || scenes > 65535)
    return (int)cudaErrorInvalidValue;
  energy_kernel<<<dim3(blocks, scenes), E_THREADS, 0, (cudaStream_t)stream>>>(
      pos_i, mass_i, ni, pos_j, mass_j, nj, g, eps, masked, tickets, partials, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
