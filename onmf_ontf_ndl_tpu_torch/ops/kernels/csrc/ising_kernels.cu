// Hopper (sm_90a) red/black heat-bath sweeps of the 2-D Ising model.
//
// Replaces the Pallas TPU kernel checkerboard_sweeps_pallas
// (onmf_ontf_ndl_tpu/ops/pallas/ising_kernel.py:64), which runs every sweep
// of a call with the lattice on chip. A colour's update reads only the other
// colour, so the int8 lattice is updated in place (torus wrap-around) with
// one barrier between the colours. Any even n works.
//
// Randomness: Philox4x32-10 keyed by (seed, 0). The sites of a colour are
// numbered q = i (n / 2) + jj (row i, the jj-th site of the colour in the
// row: column 2 jj + ((i + colour) & 1)); the call with counter
// (q >> 2, sweep, colour, 0) serves the four sites 4 (q >> 2) .. + 3, site q
// taking word q & 3; u24 is the top 24 bits of the word. A site flips when
// u24 < thr[k], k = 5 (s + 1) / 2 + (sn + 4) / 2, the 24-bit acceptance
// thresholds of sigmoid(-dE / T) that the caller computes once. The plain
// PyTorch version computes the same bits, so the two agree site for site.
//
// What bounds it: integer instructions. A Philox call is 20 wide multiplies
// and 20 three-input xors, 5 + 5 a site now that all four words are used
// (one call a site before: 20 + 20), against one byte read and written per
// site and sweep. What the design does about it:
//   * a thread owns 4 or 8 consecutive sites of the colour in a row (8 or
//     16 columns, read as one 8- or 16-byte vector from its row and the
//     rows above and below) and draws one Philox call per four sites; the
//     neighbour counts are byte arithmetic on the packed words (the row's
//     parity a template argument: constant shifts), and the 10 thresholds
//     sit in shared memory (10 banks: no conflict, no local memory).
//     Threads form (items, rows) blocks, so no index is divided. Lattices
//     with n % 8 != 0, whose Philox calls straddle rows, take a
//     site-at-a-time path: one thread per call, byte loads;
//   * three routes, chosen by the caller from (n, nsweeps) alone:
//     resident, one CTA: the lattice in shared memory, every sweep in one
//       launch, __syncthreads() between the colours;
//     resident, a thread block cluster of up to 8 CTAs: each holds a band
//       of rows in its shared memory, reads the row above and the row below
//       its band from its neighbours through distributed shared memory, and
//       the cluster barrier stands between the colours;
//     device memory: one launch per colour and sweep over the whole card,
//       the lattice (inside the 50 MB L2 up to n ~ 5000) updated in place.
//   * a device-seed entry (onmf_checkerboard_sweeps_at) takes the seed as
//     a device int64 that each kernel reads as it starts, so a CUDA graph
//     replays it with a seed drawn on the device;
//   * a banded entry (onmf_checkerboard_band_half) runs the device-memory
//     kernel on one row band of a lattice sharded over processes, with the
//     halo rows that the neighbours sent; the global row index keys the
//     counters, so the bands together equal the whole lattice site for site.
//
// A word that one thread rewrites may be read by another as a neighbour
// row in the same half-sweep: only its bytes of the colour change, and a
// reader uses only the bytes of the other colour, which every writer
// stores back unchanged.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_util.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int RES_THREADS = 1024;        // threads of a resident CTA
constexpr int RES_MAX_CLUSTER = 8;       // portable cluster size
constexpr int RES_HEAD_BYTES = 64;       // thresholds, before the rows
constexpr size_t RES_SMEM_BYTES = 232448;  // 227 KB a CTA
constexpr int HALF_THREADS = 256;        // threads of a device-memory block

struct Thresholds {
  uint32_t t[10];
};

// The two words of a 32 x 32 -> 64 product. Written as mul.wide.u32 and an
// unpacking move: the C form ((uint64_t)a * b, then the halves) compiles
// to the same multiply followed by a register move per product.
__device__ __forceinline__ void mulhilo(uint32_t a, uint32_t b, uint32_t& hi,
                                        uint32_t& lo) {
#ifdef __CUDACC__
  asm("{\n\t.reg .u64 p;\n\tmul.wide.u32 p, %2, %3;\n\t"
      "mov.b64 {%0, %1}, p;\n\t}"
      : "=r"(lo), "=r"(hi)
      : "r"(a), "r"(b));
#else
  const uint64_t p = (uint64_t)a * b;
  hi = (uint32_t)(p >> 32);
  lo = (uint32_t)p;
#endif
}

// Philox4x32-10 (Salmon et al., SC'11), all four output words.
__device__ __forceinline__ void philox4x32_10(uint32_t c0, uint32_t c1,
                                              uint32_t c2, uint32_t c3,
                                              uint32_t k0, uint32_t k1,
                                              uint32_t (&out)[4]) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    uint32_t hi0, lo0, hi1, lo1;
    mulhilo(0xD2511F53u, c0, hi0, lo0);
    mulhilo(0xCD9E8D57u, c2, hi1, lo1);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  out[0] = c0;
  out[1] = c1;
  out[2] = c2;
  out[3] = c3;
}

// The rows a block can reach: `count` rows from row `first` of the lattice
// at `base` (row stride n), the row above the first (`above`) and the row
// below the last (`below`), which on the cluster route lie in a neighbour's
// shared memory.
struct Rows {
  int8_t* base;
  const int8_t* above;
  const int8_t* below;
  int first, count, n;
  __device__ __forceinline__ int8_t* own(int i) const {
    return base + (size_t)(i - first) * n;
  }
  __device__ __forceinline__ const int8_t* up(int i) const {
    return i == first ? above : base + (size_t)(i - first - 1) * n;
  }
  __device__ __forceinline__ const int8_t* down(int i) const {
    return i == first + count - 1 ? below
                                  : base + (size_t)(i - first + 1) * n;
  }
};

template <int kWords>
struct Vec;
template <>
struct Vec<1> {
  using type = uint64_t;
};
template <>
struct Vec<2> {
  using type = ulonglong2;
};

template <int kWords>
__device__ __forceinline__ void load_words(const int8_t* p,
                                           uint64_t (&w)[kWords]) {
  if constexpr (kWords == 1) {
    w[0] = *reinterpret_cast<const uint64_t*>(p);
  } else {
    const ulonglong2 v = *reinterpret_cast<const ulonglong2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  }
}

template <int kWords>
__device__ __forceinline__ void store_words(int8_t* p,
                                            const uint64_t (&w)[kWords]) {
  if constexpr (kWords == 1) {
    *reinterpret_cast<uint64_t*>(p) = w[0];
  } else {
    *reinterpret_cast<ulonglong2*>(p) = make_ulonglong2(w[0], w[1]);
  }
}

// Eight columns of a row as one little-endian word (column c in byte c):
// the four sites of the colour at bytes 2 t + kP, one Philox word each.
// Bit 1 of an int8 spin is set exactly for -1, so the packed sum of the
// four neighbours' bit 1 counts each byte's -1 neighbours (0..4); adding
// five times the site's own bit gives, per byte, the index of its
// threshold in the kernels' table: tab[count + 5 [s = -1]] = thr[k],
// k = 5 (s + 1) / 2 + (sn + 4) / 2 = 9 - 5 [s = -1] - count. `left` and
// `right` are the bytes beside the word. A flip is s ^ 0xFE (0x01 <->
// 0xFF). The parity kP is a template argument, so every shift is constant.
template <int kP>
__device__ __forceinline__ uint64_t update_word(uint64_t own, uint64_t up,
                                                uint64_t down, uint32_t left,
                                                uint32_t right,
                                                const uint32_t (&rnd)[4],
                                                const uint32_t* tab) {
  const uint64_t ones = 0x0101010101010101ull;
  const uint64_t m = (own >> 1) & ones;
  const uint64_t idx = ((up >> 1) & ones) + ((down >> 1) & ones) +
                       ((m << 8) | (uint64_t)((left >> 1) & 1u)) +
                       ((m >> 8) | ((uint64_t)((right >> 1) & 1u) << 56)) +
                       m + (m << 2);
  const uint32_t half[2] = {(uint32_t)idx, (uint32_t)(idx >> 32)};
  uint32_t flip[2] = {0u, 0u};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int sh = 8 * ((2 * t + kP) & 3);
    const uint32_t k = (half[t >> 1] >> sh) & 0xFu;
    if ((rnd[t] >> 8) < tab[k]) flip[t >> 1] |= 0xFEu << sh;
  }
  return own ^ ((uint64_t)flip[0] | ((uint64_t)flip[1] << 32));
}

// Item `item` of row i (`row`, with `up` above and `down` below it):
// kWords words from column 8 kWords item (n % (8 kWords) == 0, so a Philox
// call never leaves the row: the call of word w has counter i (n / 8) + w).
template <int kWords, int kP>
__device__ __forceinline__ void update_item(int8_t* row, const int8_t* up_row,
                                            const int8_t* down_row, int n,
                                            uint32_t call0, int item,
                                            uint32_t seed, uint32_t sweep,
                                            uint32_t colour,
                                            const uint32_t* tab) {
  const int c0 = 8 * kWords * item;
  uint64_t own[kWords], up[kWords], down[kWords], out[kWords];
  load_words<kWords>(row + c0, own);
  load_words<kWords>(up_row + c0, up);
  load_words<kWords>(down_row + c0, down);
  const uint32_t left = (uint8_t)row[c0 == 0 ? n - 1 : c0 - 1];
  const uint32_t right =
      (uint8_t)row[c0 + 8 * kWords == n ? 0 : c0 + 8 * kWords];
#pragma unroll
  for (int v = 0; v < kWords; ++v) {
    uint32_t rnd[4];
    philox4x32_10(call0 + (uint32_t)(kWords * item + v), sweep, colour, 0u,
                  seed, 0u, rnd);
    const uint32_t l =
        v == 0 ? left : (uint32_t)(own[v == 0 ? 0 : v - 1] >> 56);
    const uint32_t r =
        v == kWords - 1 ? right
                        : (uint32_t)(own[v == kWords - 1 ? v : v + 1] & 0xFFu);
    out[v] = update_word<kP>(own[v], up[v], down[v], l, r, rnd, tab);
  }
  store_words<kWords>(row + c0, out);
}

// The site-at-a-time path (any even n): Philox call g serves the sites
// q = 4 g .. 4 g + 3 of the colour, of which this block updates those in
// [q_lo, q_hi) (its own rows); a call may straddle two rows.
__device__ __forceinline__ void update_group(const Rows& rows, long long g,
                                             long long q_lo, long long q_hi,
                                             uint32_t seed, uint32_t sweep,
                                             uint32_t colour,
                                             const uint32_t* tab) {
  const int n = rows.n, half = n >> 1;
  uint32_t rnd[4];
  philox4x32_10((uint32_t)g, sweep, colour, 0u, seed, 0u, rnd);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const long long q = 4 * g + t;
    if (q < q_lo || q >= q_hi) continue;
    const int i = (int)(q / half);
    const int j = 2 * (int)(q - (long long)i * half) + ((i + (int)colour) & 1);
    int8_t* row = rows.own(i);
    const int s = row[j];
    const int sn = rows.up(i)[j] + rows.down(i)[j] +
                   row[j == 0 ? n - 1 : j - 1] + row[j == n - 1 ? 0 : j + 1];
    const int k = ((1 - s) >> 1) * 5 + ((4 - sn) >> 1);
    if ((rnd[t] >> 8) < tab[k]) row[j] = (int8_t)(-s);
  }
}

// One colour of the block's rows. The word paths take a block of
// (items, rows) threads: thread (x, y) walks the rows y, y + ny, ... of the
// block and the items x, x + nx, ... of a row, so a warp stays in one row
// (nx is a multiple of 32) and branches on its parity as one. kWords = 0,
// the site-at-a-time path: thread `tid` of `nthreads` takes every
// nthreads-th Philox call.
template <int kWords>
__device__ __forceinline__ void update_colour(const Rows& rows, int x, int nx,
                                              int y, int ny, long long tid,
                                              long long nthreads,
                                              uint32_t seed, uint32_t sweep,
                                              uint32_t colour,
                                              const uint32_t* tab) {
  if constexpr (kWords == 0) {
    const long long half = rows.n >> 1;
    const long long q_lo = rows.first * half,
                    q_hi = (long long)(rows.first + rows.count) * half;
    for (long long g = (q_lo >> 2) + tid; 4 * g < q_hi; g += nthreads)
      update_group(rows, g, q_lo, q_hi, seed, sweep, colour, tab);
  } else {
    const int n = rows.n, per_row = n / (8 * kWords);
    for (int l = y; l < rows.count; l += ny) {
      const int i = rows.first + l;
      int8_t* row = rows.own(i);
      const int8_t* up = rows.up(i);
      const int8_t* down = rows.down(i);
      const uint32_t call0 = (uint32_t)i * (uint32_t)(n >> 3);
      if ((i + (int)colour) & 1) {
        for (int it = x; it < per_row; it += nx)
          update_item<kWords, 1>(row, up, down, n, call0, it, seed, sweep,
                                 colour, tab);
      } else {
        for (int it = x; it < per_row; it += nx)
          update_item<kWords, 0>(row, up, down, n, call0, it, seed, sweep,
                                 colour, tab);
      }
    }
  }
}

// The kernels' table in shared memory: tab[count + 5 [s = -1]].
__device__ __forceinline__ void stage_table(uint32_t* tab, int tid,
                                            const Thresholds thr) {
  // constant indices: a dynamic index into the parameter struct would copy
  // it to local memory
  if (tid < 10) {
    uint32_t v = thr.t[0];
#pragma unroll
    for (int k = 1; k < 10; ++k) v = tid == k ? thr.t[k] : v;
    tab[tid] = v;
  }
}

// Copy `bytes` bytes (a whole number of rows) in the widest vectors that
// the path's row length allows.
template <int kWords>
__device__ __forceinline__ void copy_rows(int8_t* dst, const int8_t* src,
                                          size_t bytes, int tid,
                                          int nthreads) {
  if constexpr (kWords == 0) {
    for (size_t x = tid; x < bytes; x += nthreads) dst[x] = src[x];
  } else {
    using V = typename Vec<kWords>::type;
    const size_t nv = bytes / sizeof(V);
    for (size_t x = tid; x < nv; x += nthreads)
      reinterpret_cast<V*>(dst)[x] = reinterpret_cast<const V*>(src)[x];
  }
}

// The barrier between the colours of a resident route.
template <bool kCluster>
__device__ __forceinline__ void resident_barrier() {
  if constexpr (kCluster)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// The resident routes: every sweep of the call in one launch, the lattice
// in the shared memory of one CTA (kCluster = false) or in bands of
// `band` rows over the CTAs of a cluster.
template <int kWords, bool kCluster>
__global__ void __launch_bounds__(RES_THREADS, 1)
    checkerboard_resident_kernel(int8_t* lat, int n, int band, int nsweeps,
                                 uint32_t seed, const long long* seed_at,
                                 Thresholds thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (seed_at) seed = (uint32_t)*seed_at;
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem);
  int8_t* base = reinterpret_cast<int8_t*>(smem + RES_HEAD_BYTES);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  int ctas = 1, rank = 0;
  if constexpr (kCluster) {
    ctas = (int)cg::this_cluster().num_blocks();
    rank = (int)cg::this_cluster().block_rank();
  }
  Rows rows;
  rows.n = n;
  rows.first = rank * band;
  rows.count = min(band, n - rows.first);
  rows.base = base;
  rows.above = base + (size_t)(n - 1) * n;
  rows.below = base;
  if constexpr (kCluster) {
    const int prev = rank == 0 ? ctas - 1 : rank - 1;
    const int next = rank == ctas - 1 ? 0 : rank + 1;
    const int prev_count = min(band, n - prev * band);
    rows.above = cg::this_cluster().map_shared_rank(base, prev) +
                 (size_t)(prev_count - 1) * n;
    rows.below = cg::this_cluster().map_shared_rank(base, next);
  }
  stage_table(tab, tid, thr);
  int8_t* mine = lat + (size_t)rows.first * n;
  copy_rows<kWords>(base, mine, (size_t)rows.count * n, tid, nthreads);
  resident_barrier<kCluster>();
  for (int sweep = 0; sweep < nsweeps; ++sweep)
    for (uint32_t colour = 0; colour < 2; ++colour) {
      update_colour<kWords>(rows, threadIdx.x, blockDim.x, threadIdx.y,
                            blockDim.y, tid, nthreads, seed, (uint32_t)sweep,
                            colour, tab);
      // the last one: no CTA leaves while a neighbour reads its rows
      resident_barrier<kCluster>();
    }
  copy_rows<kWords>(mine, base, (size_t)rows.count * n, tid, nthreads);
}

// The device-memory route: one colour of one sweep over `count` rows from
// row `first` of the lattice, held at `lat` (row stride n), with `above` the
// row before the first and `below` the row after the last (the whole
// lattice: first 0, count n, its last and first rows; a band of a sharded
// lattice: the halo rows its neighbours sent). Philox counters and parities
// follow the global row index, so a band computes its sites' bits exactly
// as the whole lattice does. A grid of (items, rows) blocks for the word
// paths.
template <int kWords>
__global__ void __launch_bounds__(HALF_THREADS)
    checkerboard_half_kernel(int8_t* lat, const int8_t* above,
                             const int8_t* below, int n, int first, int count,
                             uint32_t seed, const long long* seed_at,
                             uint32_t sweep, uint32_t colour,
                             Thresholds thr) {
  __shared__ uint32_t tab[10];
  if (seed_at) seed = (uint32_t)*seed_at;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  stage_table(tab, tid, thr);
  __syncthreads();
  Rows rows;
  rows.n = n;
  rows.first = first;
  rows.count = count;
  rows.base = lat;
  rows.above = above;
  rows.below = below;
  update_colour<kWords>(
      rows, blockIdx.x * blockDim.x + threadIdx.x, gridDim.x * blockDim.x,
      blockIdx.y * blockDim.y + threadIdx.y, gridDim.y * blockDim.y,
      (long long)blockIdx.x * nthreads + tid, (long long)gridDim.x * nthreads,
      seed, sweep, colour, tab);
}

// A block of `threads` threads as (items, rows): as many item columns as a
// row has items, a power of two from 32 to 256.
template <int kWords>
dim3 block_shape(int n, int threads) {
  if (kWords == 0) return dim3(threads);
  const int per_row = n / (8 * (kWords == 0 ? 1 : kWords));
  int nx = 32;
  while (nx < per_row && nx < 256) nx *= 2;
  return dim3(nx, threads / nx);
}

template <int kWords>
int launch_resident(int8_t* lat, int n, int nsweeps, uint32_t seed,
                    const long long* seed_at, const Thresholds& th, int ctas,
                    cudaStream_t stream) {
  const int band = (n + ctas - 1) / ctas;
  if ((ctas - 1) * band >= n) return (int)cudaErrorInvalidValue;
  const size_t smem = RES_HEAD_BYTES + (size_t)band * n;
  if (smem > RES_SMEM_BYTES) return (int)cudaErrorInvalidValue;
  const dim3 block = block_shape<kWords>(n, RES_THREADS);
  if (ctas == 1) {
    int e = launch_smem(
        (const void*)checkerboard_resident_kernel<kWords, false>, smem);
    if (e) return e;
    checkerboard_resident_kernel<kWords, false>
        <<<1, block, smem, stream>>>(lat, n, band, nsweeps, seed, seed_at,
                                     th);
    return (int)cudaGetLastError();
  }
  int e = launch_smem(
      (const void*)checkerboard_resident_kernel<kWords, true>, smem);
  if (e) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = (int)cudaLaunchKernelEx(&cfg, checkerboard_resident_kernel<kWords, true>,
                              lat, n, band, nsweeps, seed, seed_at, th);
  if (e) {
    cudaGetLastError();
    return e;
  }
  return (int)cudaGetLastError();
}

// One launch of checkerboard_half_kernel over `count` rows from `first`.
template <int kWords>
int launch_half(int8_t* lat, const int8_t* above, const int8_t* below, int n,
                int first, int count, uint32_t seed,
                const long long* seed_at, uint32_t sweep, uint32_t colour,
                const Thresholds& th, cudaStream_t stream) {
  const dim3 block = block_shape<kWords>(n, HALF_THREADS);
  dim3 grid;
  if (kWords == 0) {
    // the Philox calls that serve the rows' sites, the partial first and
    // last ones included
    const long long half = n / 2;
    const long long calls = ((first + count) * half + 3) / 4 -
                            ((long long)first * half) / 4;
    grid = dim3((unsigned int)((calls + HALF_THREADS - 1) / HALF_THREADS));
  } else {
    const int per_row = n / (8 * (kWords == 0 ? 1 : kWords));
    const int rows = (count + (int)block.y - 1) / (int)block.y;
    grid = dim3((per_row + block.x - 1) / block.x,
                rows < 65535 ? rows : 65535);
  }
  checkerboard_half_kernel<kWords><<<grid, block, 0, stream>>>(
      lat, above, below, n, first, count, seed, seed_at, sweep, colour, th);
  return (int)cudaGetLastError();
}

template <int kWords>
int launch_halves(int8_t* lat, int n, int nsweeps, uint32_t seed,
                  const long long* seed_at, const Thresholds& th,
                  cudaStream_t stream) {
  for (int sw = 0; sw < nsweeps; ++sw)
    for (uint32_t colour = 0; colour < 2; ++colour) {
      const int e = launch_half<kWords>(lat, lat + (size_t)(n - 1) * n, lat,
                                        n, 0, n, seed, seed_at, (uint32_t)sw,
                                        colour, th, stream);
      if (e) return e;
    }
  return 0;
}

// The kernels' table: by count of -1 neighbours + 5 [s = -1] = 9 - k.
Thresholds kernel_table(const unsigned int* thr) {
  Thresholds th;
  for (int k = 0; k < 10; ++k) th.t[9 - k] = thr[k];
  return th;
}

// The sweeps of onmf_checkerboard_sweeps and onmf_checkerboard_sweeps_at:
// the seed is `seed`, or where `seed_at` is given the low 32 bits of the
// device int64 it points to, read by each kernel as it starts.
int checkerboard_sweeps(int8_t* lat, int n, int nsweeps, uint32_t seed,
                        const long long* seed_at, const unsigned int* thr,
                        int ctas, cudaStream_t s) {
  if (n < 2 || n % 2 || ctas < 0 || ctas > RES_MAX_CLUSTER)
    return (int)cudaErrorInvalidValue;
  const Thresholds th = kernel_table(thr);
  const int words = n % 16 == 0 ? 2 : n % 8 == 0 ? 1 : 0;
  if (ctas == 0) {
    if (words == 2)
      return launch_halves<2>(lat, n, nsweeps, seed, seed_at, th, s);
    if (words == 1)
      return launch_halves<1>(lat, n, nsweeps, seed, seed_at, th, s);
    return launch_halves<0>(lat, n, nsweeps, seed, seed_at, th, s);
  }
  // a band with fewer 16-byte items than threads takes 8-byte items: one
  // Philox call a thread, not two in a row, where latency is the cost
  if (words == 2 && (long long)((n + ctas - 1) / ctas) * (n / 16) >=
                        RES_THREADS)
    return launch_resident<2>(lat, n, nsweeps, seed, seed_at, th, ctas, s);
  if (words >= 1)
    return launch_resident<1>(lat, n, nsweeps, seed, seed_at, th, ctas, s);
  return launch_resident<0>(lat, n, nsweeps, seed, seed_at, th, ctas, s);
}

}  // namespace

extern "C" {

// Shared memory of a resident CTA that holds `band` rows of n columns.
size_t onmf_checkerboard_smem(int band, int n) {
  return RES_HEAD_BYTES + (size_t)band * n;
}

// nsweeps full sweeps (colour 0, then colour 1) of the (n, n) int8 lattice,
// in place. thr: the 10 acceptance thresholds (host memory). ctas = 0: the
// device-memory route, two launches a sweep; 1: the resident route on one
// CTA; 2..8: on a cluster of that many, each with ceil(n / ctas) rows; one
// launch for the call.
int onmf_checkerboard_sweeps(int8_t* lat, int n, int nsweeps,
                             unsigned int seed, const unsigned int* thr,
                             int ctas, void* stream) {
  return checkerboard_sweeps(lat, n, nsweeps, seed, nullptr, thr, ctas,
                             (cudaStream_t)stream);
}

// The same with the seed in device memory: the low 32 bits of the int64 at
// `seed_at`, read at launch, so that a CUDA graph can replay the call with
// a seed drawn on the device (the Ising learner's rounds).
int onmf_checkerboard_sweeps_at(int8_t* lat, int n, int nsweeps,
                                const long long* seed_at,
                                const unsigned int* thr, int ctas,
                                void* stream) {
  return checkerboard_sweeps(lat, n, nsweeps, 0u, seed_at, thr, ctas,
                             (cudaStream_t)stream);
}

// One colour of one sweep on a band of a row-sharded (n, n) lattice, in
// place: `count` rows from global row `first` at `band` (row stride n),
// `above` and `below` the halo rows (the row before the band's first and
// the row after its last, from the neighbouring bands). One launch of the
// device-memory kernel. The packed paths need their rows aligned to their
// vector (16 or 8 bytes); other pointers take the site-at-a-time path,
// which computes the same bits.
int onmf_checkerboard_band_half(int8_t* band, const int8_t* above,
                                const int8_t* below, int n, int first,
                                int count, unsigned int seed,
                                unsigned int sweep, unsigned int colour,
                                const unsigned int* thr, void* stream) {
  if (n < 2 || n % 2 || first < 0 || count < 1 || first > n - count ||
      colour > 1)
    return (int)cudaErrorInvalidValue;
  const Thresholds th = kernel_table(thr);
  cudaStream_t s = (cudaStream_t)stream;
  const uintptr_t any =
      (uintptr_t)band | (uintptr_t)above | (uintptr_t)below;
  const int words = n % 16 == 0 && any % 16 == 0  ? 2
                    : n % 8 == 0 && any % 8 == 0 ? 1
                                                 : 0;
  if (words == 2)
    return launch_half<2>(band, above, below, n, first, count, seed,
                          nullptr, sweep, colour, th, s);
  if (words == 1)
    return launch_half<1>(band, above, below, n, first, count, seed,
                          nullptr, sweep, colour, th, s);
  return launch_half<0>(band, above, below, n, first, count, seed, nullptr,
                        sweep, colour, th, s);
}

}  // extern "C"
