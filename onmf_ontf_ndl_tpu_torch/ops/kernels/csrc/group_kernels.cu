// Hopper (sm_90a) kernels for the grouping of a network reconstruction's
// paints by directed node pair (apps/network.py::_group_painted and the
// dense canvas of reconstruct_network).
//
// No Pallas kernel stands behind them: the JAX package groups with lax.sort
// and sums (onmf_ontf_ndl_tpu/apps/network.py::_group_painted). A
// reconstruction paints M samples x k^2 slots (q, r) of its k-node motif:
// slot (q, r) of sample m paints vals_T[q * k + r, m] onto the pair
// (embs[m, q], embs[m, r]). The grouping is the sum and the number of the
// paints of each pair, in ascending pair order:
//   onmf_group_sort  <- the keys and the sort: group_emit_kernel writes each
//                       paint's key i * n + j (uint32 where n^2 <= 2^32,
//                       else uint64) and value in the flat order
//                       t = s * M + m (slot s: (q, r) in row order; the
//                       self slots q = r left out where asked), then cub's
//                       DeviceRadixSort sorts the (key, value) pairs stably
//                       over the key's significant bits alone,
//                       [0, bit_length(n^2 - 1)): 24 bits, three passes, at
//                       n = 4039;
//   onmf_group_heads <- the sparse form's run offsets: the runs that start
//                       in each tile of the sorted keys, then one block's
//                       scan of them over the tiles;
//   onmf_group_sum   <- the run sum: group_sum_kernel sums each tile's runs
//                       (a segmented warp-shuffle scan of the threads'
//                       sequential sums, then one over the block's warps)
//                       and writes the runs that end inside the tile;
//                       group_cross_kernel finishes the runs that cross a
//                       tile boundary from the tiles' boundary partials, in
//                       tile order. The dense form writes each run's mean
//                       and count straight into the two zeroed (n, n)
//                       canvases at the key (the key is the canvas's flat
//                       index); the sparse form writes the compact
//                       (ii, jj, sums, cnt) at each run's rank.
// Plain C entry points, bound from Python with ctypes; each returns
// cudaGetLastError() after its launches (0 = success).
//
// What bounds them on this card: bytes. At M = 100,096 and k = 21 the
// grouping reads the 177 MB of values and writes 44.1M (key, value) pairs
// of 8 bytes; the sort reads and writes them once a pass; the run sum
// reads them once and writes two 65 MB canvases. What the design does about
// it:
//   - the key is no wider than n needs and the sort passes no more bits
//     than n^2 - 1 has: 8 bytes a pair and three 8-bit passes in place of
//     an int64 key with an int64 index (16 bytes a pair) over 64 bits;
//   - the emission reads the values once, in their own layout, and writes
//     keys and values once, coalesced (a block's threads take consecutive
//     samples of one motif node q); no index gather follows the sort;
//   - the run sum's cost is per pair, not per run: a tile of TILE sorted
//     pairs a block, staged in shared memory (padded: no bank conflicts),
//     each thread summing SUM_ITEMS consecutive pairs;
//   - the dense form needs no count of the runs, so nothing is read back to
//     the host; the sparse form reads the number of runs once.
//
// Order: the sort is stable, so each pair's paints stay in ascending flat
// order. Each run's sum is taken in an order fixed by the number of pairs
// and the tiling alone (a thread's pairs in sequence, the scans' fixed
// trees, then the crossing tiles' partials in tile order), with no atomics:
// two runs on the same input give the same bits, and round(mean) > 0 does
// not depend on the order in which blocks run.

#include <cuda_runtime.h>
#include <stddef.h>

#include <cub/device/device_radix_sort.cuh>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int EMIT_THREADS = 256;     // samples a block of the emission
constexpr int SUM_THREADS = 256;      // threads of a run-sum block
constexpr int SUM_ITEMS = 8;          // consecutive sorted pairs a thread
constexpr int TILE = SUM_THREADS * SUM_ITEMS;   // sorted pairs a block
constexpr int SUM_WARPS = SUM_THREADS / 32;
constexpr int PADDED = TILE + TILE / 32;        // one spare word every 32
constexpr int SCAN_THREADS = 1024;    // the offsets' single block
constexpr int CROSS_THREADS = 128;
constexpr long long MAX_ITEMS = 2147483647LL;   // cub's item count: an int

// Shared-memory index of a tile's pair i: a thread's SUM_ITEMS consecutive
// pairs then fall on distinct banks across its warp.
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// The open run of a part of a tile: the sum and number of its pairs since
// the part's last head (first pair of a run), and whether the part holds a
// head. Parts join left to right.
struct Seg {
  float sum;
  int cnt;
  int head;
};

__device__ __forceinline__ Seg seg_join(Seg a, Seg b) {
  if (b.head) return b;
  return Seg{a.sum + b.sum, a.cnt + b.cnt, a.head};
}

__device__ __forceinline__ Seg seg_shfl_up(Seg s, int d) {
  return Seg{__shfl_up_sync(FULL, s.sum, d), __shfl_up_sync(FULL, s.cnt, d),
             __shfl_up_sync(FULL, s.head, d)};
}

// What a tile leaves for group_cross_kernel: its lead (the pairs before its
// first head, which continue a run of an earlier tile; none where the tile
// opens with a head), whether it holds a head, and its tail (the last run
// that starts in it, where that run goes on into the next tile; tail_cnt 0
// where it ends inside).
struct Parts {
  float* lead_sum;
  int* lead_cnt;
  int* has_head;
  float* tail_sum;
  int* tail_cnt;
};

Parts parts_of(int* base, long long tiles) {
  return Parts{(float*)base, base + tiles, base + 2 * tiles,
               (float*)(base + 3 * tiles), base + 4 * tiles};
}

// Where the runs go: the dense canvases (recon, count: (n, n) row-major,
// indexed by the key) or the sparse form's arrays, indexed by the run's
// rank among all runs.
struct Out {
  float* recon;
  float* count;
  long long* ii;
  long long* jj;
  float* sums;
  float* cnt;
};

template <typename K>
__device__ __forceinline__ void put_run(const Out& o, K key, float sum,
                                        long long cnt, long long slot,
                                        unsigned long long n) {
  const float c = (float)cnt;
  if (o.recon) {
    o.recon[key] = __fdiv_rn(sum, c);
    o.count[key] = c;
  } else {
    o.ii[slot] = (long long)((unsigned long long)key / n);
    o.jj[slot] = (long long)((unsigned long long)key % n);
    o.sums[slot] = sum;
    o.cnt[slot] = c;
  }
}

// Block (x, q): the samples m of a grid-stride over x, motif node q; the
// thread writes its sample's slots (q, r), r ascending (r != q where
// skip_self), at t = (q * per + c) * M + m.
template <typename K>
__global__ void __launch_bounds__(EMIT_THREADS)
group_emit_kernel(const long long* __restrict__ embs,
                  const float* __restrict__ vals, long long samples, int k,
                  int skip_self, unsigned long long n, K* __restrict__ keys,
                  float* __restrict__ out) {
  const int q = blockIdx.y;
  const int per = skip_self ? k - 1 : k;
  for (long long m = (long long)blockIdx.x * EMIT_THREADS + threadIdx.x;
       m < samples; m += (long long)gridDim.x * EMIT_THREADS) {
    const long long* row = embs + m * k;
    const unsigned long long i = (unsigned long long)row[q] * n;
    for (int c = 0; c < per; ++c) {
      const int r = skip_self ? c + (c >= q) : c;
      const long long t = ((long long)q * per + c) * samples + m;
      keys[t] = (K)(i + (unsigned long long)row[r]);
      out[t] = vals[((long long)q * k + r) * samples + m];
    }
  }
}

// Runs that start in each tile of the sorted keys.
template <typename K>
__global__ void __launch_bounds__(SUM_THREADS)
group_heads_kernel(const K* __restrict__ keys, long long items,
                   int* __restrict__ tile_heads) {
  __shared__ int warp_heads[SUM_WARPS];
  const long long base = (long long)blockIdx.x * TILE;
  int h = 0;
  for (int i = threadIdx.x; i < TILE; i += SUM_THREADS) {
    const long long g = base + i;
    if (g < items && (g == 0 || keys[g] != keys[g - 1])) ++h;
  }
  h = __reduce_add_sync(FULL, h);
  if ((threadIdx.x & 31) == 0) warp_heads[threadIdx.x >> 5] = h;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < SUM_WARPS; ++w) total += warp_heads[w];
    tile_heads[blockIdx.x] = total;
  }
}

// One block: tile_offset[b] = the runs that start before tile b,
// tile_offset[tiles] = all runs.
__global__ void __launch_bounds__(SCAN_THREADS)
group_offsets_kernel(const int* __restrict__ tile_heads, long long tiles,
                     long long* __restrict__ tile_offset) {
  __shared__ long long warp_sums[SCAN_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long carry = 0;
  for (long long b0 = 0; b0 < tiles; b0 += SCAN_THREADS) {
    const long long b = b0 + threadIdx.x;
    const long long v = b < tiles ? tile_heads[b] : 0;
    long long inc = v;
    for (int d = 1; d < 32; d <<= 1) {
      const long long o = __shfl_up_sync(FULL, inc, d);
      if (lane >= d) inc += o;
    }
    if (lane == 31) warp_sums[warp] = inc;
    __syncthreads();
    if (warp == 0) {
      long long w = warp_sums[lane];
      for (int d = 1; d < 32; d <<= 1) {
        const long long o = __shfl_up_sync(FULL, w, d);
        if (lane >= d) w += o;
      }
      warp_sums[lane] = w;
    }
    __syncthreads();
    inc += warp ? warp_sums[warp - 1] : 0;
    if (b < tiles) tile_offset[b] = carry + inc - v;
    carry += warp_sums[SCAN_THREADS / 32 - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) tile_offset[tiles] = carry;
}

// One block a tile of TILE sorted pairs: each thread's SUM_ITEMS
// consecutive pairs summed in sequence (its Seg), a segmented inclusive
// scan of the Segs over each warp's lanes, the warps' totals joined in warp
// order, then each thread walks its pairs again from the open run before
// it and writes every run that ends in the tile and starts in it; the
// tile's lead and tail go to `parts`. tile_offset (sparse form): the runs
// before each tile.
template <typename K>
__global__ void __launch_bounds__(SUM_THREADS)
group_sum_kernel(const K* __restrict__ keys, const float* __restrict__ vals,
                 long long items, unsigned long long n,
                 const long long* __restrict__ tile_offset, Parts parts,
                 Out out) {
  __shared__ K skey[PADDED];
  __shared__ float sval[PADDED];
  __shared__ Seg warp_seg[SUM_WARPS];
  __shared__ int warp_heads[SUM_WARPS];
  const int b = blockIdx.x;
  const long long base = (long long)b * TILE;
  const int len = (int)min((long long)TILE, items - base);
  for (int i = threadIdx.x; i < len; i += SUM_THREADS) {
    skey[pad(i)] = keys[base + i];
    sval[pad(i)] = vals[base + i];
  }
  __syncthreads();
  // the tile's first pair opens a run unless the previous tile ends with
  // its key; its last pair closes one unless the next tile starts with it
  const bool opens = base == 0 || keys[base - 1] != skey[0];
  const bool closes =
      base + len == items || keys[base + len] != skey[pad(len - 1)];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lo = threadIdx.x * SUM_ITEMS;
  const int hi = min(lo + SUM_ITEMS, len);
  unsigned heads = 0, ends = 0;   // bit j: pair lo + j opens / closes a run
  Seg agg{0.f, 0, 0};
  for (int i = lo; i < hi; ++i) {
    const K key = skey[pad(i)];
    const bool h = i == 0 ? opens : key != skey[pad(i - 1)];
    const bool e = i == len - 1 ? closes : key != skey[pad(i + 1)];
    heads |= (unsigned)h << (i - lo);
    ends |= (unsigned)e << (i - lo);
    const float v = sval[pad(i)];
    agg = h ? Seg{v, 1, 1} : Seg{agg.sum + v, agg.cnt + 1, agg.head};
  }
  // segmented scan of the Segs, and a plain one of the head counts
  Seg inc = agg;
  int hinc = __popc(heads);
  for (int d = 1; d < 32; d <<= 1) {
    const Seg o = seg_shfl_up(inc, d);
    const int oh = __shfl_up_sync(FULL, hinc, d);
    if (lane >= d) {
      inc = seg_join(o, inc);
      hinc += oh;
    }
  }
  if (lane == 31) {
    warp_seg[warp] = inc;
    warp_heads[warp] = hinc;
  }
  __syncthreads();
  Seg run{0.f, 0, 0};
  int before = 0;
  for (int w = 0; w < warp; ++w) {
    run = seg_join(run, warp_seg[w]);
    before += warp_heads[w];
  }
  Seg ex = seg_shfl_up(inc, 1);
  int hex = __shfl_up_sync(FULL, hinc, 1);
  if (lane == 0) {
    ex = Seg{0.f, 0, 0};
    hex = 0;
  }
  run = seg_join(run, ex);
  long long slot = (tile_offset ? tile_offset[b] : 0) + before + hex - 1;
  for (int i = lo; i < hi; ++i) {
    const int j = i - lo;
    const float v = sval[pad(i)];
    if ((heads >> j) & 1u) {
      run = Seg{v, 1, 1};
      ++slot;
    } else {
      run.sum += v;
      run.cnt += 1;
    }
    const bool e = (ends >> j) & 1u, last = i == len - 1;
    if (!e && !last) continue;
    if (!run.head) {
      parts.lead_sum[b] = run.sum;
      parts.lead_cnt[b] = run.cnt;
    } else if (e) {
      put_run(out, skey[pad(i)], run.sum, run.cnt, slot, n);
    }
    if (last) {
      parts.has_head[b] = run.head;
      parts.tail_sum[b] = run.sum;
      parts.tail_cnt[b] = run.head && !e ? run.cnt : 0;
    }
  }
  if (threadIdx.x == 0 && opens) {
    parts.lead_sum[b] = 0.f;
    parts.lead_cnt[b] = 0;
  }
}

// A thread a tile whose last run goes on past it: that run's tail, then the
// leads of the tiles that follow, in tile order, up to the tile where it
// ends.
template <typename K>
__global__ void __launch_bounds__(CROSS_THREADS)
group_cross_kernel(const K* __restrict__ keys, long long tiles,
                   unsigned long long n,
                   const long long* __restrict__ tile_offset, Parts parts,
                   Out out) {
  const long long b = (long long)blockIdx.x * CROSS_THREADS + threadIdx.x;
  if (b >= tiles || parts.tail_cnt[b] == 0) return;
  float sum = parts.tail_sum[b];
  long long cnt = parts.tail_cnt[b];
  for (long long u = b + 1; u < tiles && parts.lead_cnt[u]; ++u) {
    sum += parts.lead_sum[u];
    cnt += parts.lead_cnt[u];
    if (parts.has_head[u]) break;
  }
  const long long slot = tile_offset ? tile_offset[b + 1] - 1 : 0;
  put_run(out, keys[(b + 1) * TILE - 1], sum, cnt, slot, n);
}

template <typename K>
int sort_pairs(void* temp, size_t* bytes, void* keys, void* keys_alt,
               float* vals, float* vals_alt, long long items, int end_bit,
               cudaStream_t s, int* selected) {
  cub::DoubleBuffer<K> dk((K*)keys, (K*)keys_alt);
  cub::DoubleBuffer<float> dv(vals, vals_alt);
  size_t b = *bytes;
  const cudaError_t e = cub::DeviceRadixSort::SortPairs(
      temp, b, dk, dv, (int)items, 0, end_bit, s);
  *bytes = b;
  if (e != cudaSuccess) return (int)e;
  if (dk.selector != dv.selector) return (int)cudaErrorUnknown;
  if (selected) *selected = dk.selector;
  return 0;
}

template <typename K>
int launch_sum(const void* keys, const float* vals, long long items,
               unsigned long long n, const long long* tile_offset,
               int* parts, const Out& out, cudaStream_t s) {
  const long long tiles = (items + TILE - 1) / TILE;
  const Parts p = parts_of(parts, tiles);
  group_sum_kernel<K><<<(unsigned)tiles, SUM_THREADS, 0, s>>>(
      (const K*)keys, vals, items, n, tile_offset, p, out);
  const int e = (int)cudaGetLastError();
  if (e) return e;
  group_cross_kernel<K>
      <<<(unsigned)((tiles + CROSS_THREADS - 1) / CROSS_THREADS),
         CROSS_THREADS, 0, s>>>((const K*)keys, tiles, n, tile_offset, p,
                                out);
  return (int)cudaGetLastError();
}

// A 32-bit key holds every pair of n nodes where n^2 <= 2^32.
bool key_fits(int wide, long long n) { return wide || n <= 65536; }

}  // namespace

extern "C" {

int onmf_group_tile(void) { return TILE; }

// The bytes of cub's temporary storage for sorting `items` pairs of a
// 32-bit (wide = 0) or 64-bit key over bits [0, end_bit), into *bytes (0
// where there is nothing to sort).
int onmf_group_sort_bytes(long long items, int wide, int end_bit,
                          size_t* bytes) {
  *bytes = 0;
  if (items < 0 || items > MAX_ITEMS || end_bit < 0 ||
      end_bit > (wide ? 64 : 32))
    return (int)cudaErrorInvalidValue;
  if (items == 0 || end_bit == 0) return 0;
  return wide ? sort_pairs<unsigned long long>(nullptr, bytes, nullptr,
                                               nullptr, nullptr, nullptr,
                                               items, end_bit, 0, nullptr)
              : sort_pairs<unsigned>(nullptr, bytes, nullptr, nullptr,
                                     nullptr, nullptr, items, end_bit, 0,
                                     nullptr);
}

// The keys and values of the paints of embs (samples, k) int64 and vals
// (k * k, samples) float32 into keys / out (each samples * k * per, per =
// k - 1 with skip_self, else k), then the sort, which may leave its
// result in keys_alt / out_alt: *selected is 0 where it is in keys / out,
// 1 where it is in the others. temp: temp_bytes of
// onmf_group_sort_bytes.
int onmf_group_sort(const long long* embs, const float* vals,
                    long long samples, int k, int skip_self, long long n,
                    int wide, int end_bit, void* keys, void* keys_alt,
                    float* out, float* out_alt, void* temp,
                    size_t temp_bytes, int* selected, void* stream) {
  const long long per = skip_self ? k - 1 : k;
  const long long items = samples * k * per;
  if (samples < 1 || k < 1 || k > 65535 || per < 1 || n < 1 ||
      items > MAX_ITEMS || !key_fits(wide, n) || end_bit < 0 ||
      end_bit > (wide ? 64 : 32) || (end_bit > 0 && temp == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long blocks = (samples + EMIT_THREADS - 1) / EMIT_THREADS;
  const dim3 grid((unsigned)(blocks < 65535 ? blocks : 65535), (unsigned)k);
  if (wide)
    group_emit_kernel<unsigned long long><<<grid, EMIT_THREADS, 0, s>>>(
        embs, vals, samples, k, skip_self, (unsigned long long)n,
        (unsigned long long*)keys, out);
  else
    group_emit_kernel<unsigned><<<grid, EMIT_THREADS, 0, s>>>(
        embs, vals, samples, k, skip_self, (unsigned long long)n,
        (unsigned*)keys, out);
  int e = (int)cudaGetLastError();
  if (e) return e;
  *selected = 0;
  if (end_bit == 0) return 0;   // one node: every key is 0
  size_t b = temp_bytes;
  e = wide ? sort_pairs<unsigned long long>(temp, &b, keys, keys_alt, out,
                                            out_alt, items, end_bit, s,
                                            selected)
           : sort_pairs<unsigned>(temp, &b, keys, keys_alt, out, out_alt,
                                  items, end_bit, s, selected);
  if (e) return e;
  return (int)cudaGetLastError();
}

// The sparse form's offsets: tile_heads (tiles,) int32 the runs that start
// in each tile of TILE sorted keys, tile_offset (tiles + 1,) int64 the runs
// before each tile and, last, all runs.
int onmf_group_heads(const void* keys, long long items, int wide,
                     int* tile_heads, long long* tile_offset,
                     void* stream) {
  if (items < 1 || items > MAX_ITEMS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long tiles = (items + TILE - 1) / TILE;
  if (wide)
    group_heads_kernel<unsigned long long><<<(unsigned)tiles, SUM_THREADS,
                                             0, s>>>(
        (const unsigned long long*)keys, items, tile_heads);
  else
    group_heads_kernel<unsigned><<<(unsigned)tiles, SUM_THREADS, 0, s>>>(
        (const unsigned*)keys, items, tile_heads);
  const int e = (int)cudaGetLastError();
  if (e) return e;
  group_offsets_kernel<<<1, SCAN_THREADS, 0, s>>>(tile_heads, tiles,
                                                  tile_offset);
  return (int)cudaGetLastError();
}

// The run sum of `items` sorted (key, value) pairs. parts: 5 * tiles int32
// of scratch. Dense form (recon, count: (n, n) float32, zero where no run
// writes): recon[key] = the run's sum / its count, count[key] = its count.
// Sparse
// form (tile_offset of onmf_group_heads; ii, jj int64, sums, cnt float32,
// one slot a run): the run of rank s at slot s, its key as (key / n,
// key % n).
int onmf_group_sum(const void* keys, const float* vals, long long items,
                   int wide, long long n, const long long* tile_offset,
                   int* parts, float* recon, float* count, long long* ii,
                   long long* jj, float* sums, float* cnt, void* stream) {
  const bool dense = recon != nullptr;
  if (items < 1 || items > MAX_ITEMS || n < 1 || !key_fits(wide, n) ||
      (dense ? count == nullptr
             : (tile_offset == nullptr || ii == nullptr || jj == nullptr ||
                sums == nullptr || cnt == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Out out{recon, count, ii, jj, sums, cnt};
  return wide ? launch_sum<unsigned long long>(keys, vals, items,
                                               (unsigned long long)n,
                                               tile_offset, parts, out, s)
              : launch_sum<unsigned>(keys, vals, items,
                                     (unsigned long long)n, tile_offset,
                                     parts, out, s);
}

}  // extern "C"
