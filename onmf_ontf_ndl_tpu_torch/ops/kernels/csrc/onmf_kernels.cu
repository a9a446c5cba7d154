// Hopper (sm_90a) kernels for the coders and the dictionary update of
// online NMF.
//
// Replace the Pallas TPU kernels of onmf_ontf_ndl_tpu/ops/pallas/coder_kernel.py:
//   onmf_coder_sweeps            <- coder_sweeps            (:192)
//   onmf_coder_sweeps_earlystop  <- coder_sweeps_earlystop  (:455)
//   onmf_fista_sweeps            <- fista_sweeps            (:579)
//   onmf_dict_update_sweep       <- dict_update_sweep       (:629)
// Plain C entry points, bound from Python with ctypes. Each returns
// cudaGetLastError() after its launch (0 = success). All arrays are float32,
// row-major and contiguous; the caller allocates every output and workspace.
//
// Each coder has a form in shared memory and a workspace form, chosen by
// the wrapper from the rank alone:
//   shared: A and the tiles (with a stop, the (r, r) Grams too) in one
//     block's shared memory or registers, one block per tile of TN columns
//     (the small ranks: they must fit 227 KB): coder_lanes_kernel,
//     fista_tiled_kernel and, for the early stop, coder_es_lanes_kernel;
//   workspace (the wide kernels): one block of 512 threads per tile and
//     SM, the grid striding over the tiles, A's table at the head of a
//     device workspace (6 MiB at the JAX kernels' largest rank) staged
//     through shared memory by cp.async in chunks, and where they do not
//     fit an SM the tiles, the Grams and the power vectors in the block's
//     slice of the workspace (one slice per SM: it stays in L2).
//     coder_wide_kernel runs the Gauss-Seidel sweeps in direct form, each
//     column's rows in the registers of the 8 to 32 lanes that share it,
//     with the early stop or without it; fista_wide_kernel runs FISTA as a
//     register-tiled product
//     (the tile of Y in shared memory or, past FW_RESIDENT_MAX_RANK, in the
//     workspace). Both take their Grams and the stop decision from
//     wide_tile_grams and ft_stop_decision.
// The dictionary update runs dict_update_kernel on one CTA or a cluster,
// or dict_update_single_kernel past the cluster's shared memory, chosen by
// the wrapper from (d, r) alone.
//
// Each entry point's main kernel counts its own runs on the device
// (count_run), so that a run replayed from a CUDA graph counts too; the
// Gauss-Seidel coders with the stop and FISTA in both of its modes count
// their work, each into slots of their own (count_columns, count_sweeps):
// onmf_read_runs and onmf_reset_runs read and zero the counts,
// onmf_snapshot_runs queues a copy of them on a stream.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "launch_util.cuh"

namespace cg = cooperative_groups;

namespace {

// Columns per block. For the early-stop kernel the block is the stopping
// tile: the relative-change rule is decided on these TN columns together.
constexpr int TN = 128;
// Row stride of the early-stop kernel's shared (r, TN) tiles. The odd pad
// keeps the Gram loop (lanes on different rows, same column) off one bank.
// Workspace tiles use TN: their Gram loop reads along rows.
constexpr int HS = TN + 1;
// Largest rank of the shared-memory FISTA kernel with fixed iterations: one
// thread per 4 x 8 outputs of a tile is 512 threads at r = 128.
constexpr int FISTA_MAX_RANK = 128;

// Counts since onmf_reset_runs: the runs of each entry point's main
// kernel, in the order of the entry points (coder_sweeps,
// coder_sweeps_earlystop, fista_sweeps, dict_update_sweep); then the work
// of the Gauss-Seidel coders with the stop (shared and wide): each tile's
// sweeps times its columns, summed (ES_COLUMN_SWEEPS), and the columns
// coded (ES_COLUMNS); last the columns that the early-stop coder coded in
// its cluster form (ES_CLUSTER_COLUMNS); then the columns of the
// dictionary update's column step (DICT_COLUMNS) and the rank-k updates of
// G of its panel form (DICT_PANEL_UPDATES); then FISTA's work, with the
// stop or fixed iterations, in both of its kernels: each tile's iterations
// times its columns (FISTA_COLUMN_ITERS) and the columns coded
// (FISTA_COLUMNS).
enum {
  RUN_CODER, RUN_CODER_ES, RUN_FISTA, RUN_DICT, ES_COLUMN_SWEEPS,
  ES_COLUMNS, ES_CLUSTER_COLUMNS, DICT_COLUMNS, DICT_PANEL_UPDATES,
  FISTA_COLUMN_ITERS, FISTA_COLUMNS, RUN_KINDS
};
__device__ unsigned long long g_runs[RUN_KINDS];

__device__ __forceinline__ bool grid_first_thread() {
  return (blockIdx.x | blockIdx.y | blockIdx.z | threadIdx.x | threadIdx.y |
          threadIdx.z) == 0;
}

// One thread of the grid's first block adds one run of `kind`.
__device__ __forceinline__ void count_run(int kind) {
  if (grid_first_thread()) atomicAdd(&g_runs[kind], 1ull);
}

// A launch's n columns into `slot` (ES_COLUMNS, FISTA_COLUMNS), added by
// one thread of the grid.
__device__ __forceinline__ void count_columns(int slot, int n) {
  if (grid_first_thread())
    atomicAdd(&g_runs[slot], (unsigned long long)n);
}

// A tile's sweeps (FISTA: iterations) times its columns into `slot`
// (ES_COLUMN_SWEEPS, FISTA_COLUMN_ITERS), added by the block's first
// thread as the tile leaves its loop (`sweeps` the same in every thread).
__device__ __forceinline__ void count_sweeps(int slot, int sweeps,
                                             size_t tile0, int n) {
  if (threadIdx.x == 0) {
    const size_t left = (size_t)n - tile0;
    const size_t cols = left < (size_t)TN ? left : (size_t)TN;
    atomicAdd(&g_runs[slot], (unsigned long long)sweeps * cols);
  }
}

// A tile's columns coded by a cluster, added by the block's first thread.
__device__ __forceinline__ void count_cluster_columns(size_t tile0, int n) {
  if (threadIdx.x == 0) {
    const size_t left = (size_t)n - tile0;
    atomicAdd(&g_runs[ES_CLUSTER_COLUMNS],
              (unsigned long long)(left < (size_t)TN ? left : (size_t)TN));
  }
}

// The dictionary update's columns and its rank-k updates of G, added by
// one thread of the grid.
__device__ __forceinline__ void count_dict(int columns, int panel_updates) {
  if (grid_first_thread()) {
    atomicAdd(&g_runs[DICT_COLUMNS], (unsigned long long)columns);
    atomicAdd(&g_runs[DICT_PANEL_UPDATES], (unsigned long long)panel_updates);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int m = 16; m > 0; m >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, m));
  return x;
}

// The cluster barrier, split in two: arrive (release) and wait (acquire).
// Every thread of every CTA of the cluster takes both halves, in turn.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// The shared-memory early-stop coder, r <= ES_MAX_RANK: coder_es_lanes_kernel.
//
// Replaces coder_sweeps_earlystop (pallas/coder_kernel.py:455) with the same
// function: the tile of TN columns, the step 1 / sqrt(i + 10), the certified
// bounds first and pi_iters warm power steps only in the band between them,
// a converged tile left as it is. What bounds it: the sweep's r^2
// multiply-adds per column and sweep, and as many for the two Grams (10
// sweeps at r = 25, n = 131,109: 3.3 GFLOP, ~50 us at 67 TFLOP/s f32); but
// shared memory delivers 32 floats a clock to an SM, a quarter of its FMA
// rate, so a multiply-add that takes a fresh shared operand runs at a
// quarter of the peak. Each coordinate step is a sequential dependency
// within a column, and the stop decision's power steps a sequential chain
// per tile. What the design does about it:
//   * L lanes per column group (2 up to r = 32, else 4), each lane owning
//     Q consecutive rows of the residual g = A h - b of ES_COLS columns in
//     registers. At
//     coordinate k the owner forms h_k' and delta for each column, one
//     shuffle per column hands delta to the group's lanes, and each lane
//     adds A[i, k] delta to its Q rows of each column: every A value read
//     from shared memory feeds ES_COLS multiply-adds, and none of them is
//     on an r-long dependent dot product. A is kept transposed
//     (At[k][i] = A[i][k]) so that a lane's rows are consecutive (float4
//     loads when Q is a multiple of 4). Past r = 32, g is formed anew from
//     A h - b at the start of every sweep, so that float32 rounding does
//     not build up over the r rank-1 updates of each sweep (at r = 100 it
//     reached 3.8e-5 against the plain version after ten sweeps); up to
//     r = 32 it is formed once per tile (5e-6 after ten sweeps at r = 25).
//     Every lane repeats its column's candidate step, so the lanes are kept
//     few: the kernel is bound by issued instructions, not by latency.
//   * The two Grams (the step delta's and the old iterate's) in one pass
//     over 4x4 blocks of the upper triangle, each summed over interleaved
//     columns by ES_GRAM_LANES neighbouring lanes and reduced by shuffles:
//     16 shared loads feed 32 multiply-adds. With the tiles' row stride HS
//     = TN + 1, the rows 4 apart that a warp's blocks read fall
//     ES_GRAM_LANES banks apart: no bank conflicts.
//   * The stop decision runs on two warps at once, one per Gram (the two
//     power iterations are independent until the decision compares them),
//     with no block barrier inside the power steps; each reads its
//     symmetric Gram by columns, so that the lanes' loads are consecutive.
//     The decision is the reference's: v += 0.05 v0, one warm power step
//     for Rayleigh lower bounds, min(trace, Gershgorin) upper bounds, and
//     pi_iters more steps only in the band between them.
//   * kCluster, where the tiles are too few to fill the card (the wrapper's
//     coder_es_cluster: past r = 32, e.g. 8 tiles at n = 1000, r = 100, on
//     132 SMs): a tile on a thread block cluster of S = 4 or 8 CTAs. One
//     CTA a tile ran all of its work on one SM (the Grams' 2 r^2
//     multiply-adds a column alone ~23 us a sweep at r = 100). The tile
//     still stops as one, on its Grams over all TN columns; only the work
//     inside it is spread. Every exchange between the CTAs is a store into
//     another CTA's shared memory (distributed shared memory) before a
//     cluster barrier, never a load across one: summing rows of the Grams
//     by remote loads, a round trip each, took ~7 us a sweep.
//     - each CTA holds TN / S of the columns, 16 or 32 lanes of
//       ES_CLUSTER_ROWS rows a pair of them (es_cluster_lanes), its tiles
//       column by column. A block of an owner's coordinates runs on a
//       copy of the owner's rows of g, then their deltas go to every lane
//       at once, so the shuffles leave the chain; a lane keeps the steps
//       of its own rows. Each row's multiply-adds come in the same order,
//       so H is the one-CTA kernel's bit for bit when the sweeps agree; g
//       is formed anew every sweep past r = 32, as there;
//     - the decision's products come from the columns: w = G v is the sum
//       over the CTAs of D_j (D_j^T v), D_j a CTA's columns (O_j for Gh).
//       Each CTA stores its part in every CTA, with, at the first product,
//       its part of both Grams' diagonals; every CTA sums the parts in
//       rank order and runs the one-CTA decision's arithmetic on them, so
//       all reach the same decision bit for bit. The traces and the
//       largest diagonal entries decide where they can; otherwise each
//       CTA forms the upper 4x4 blocks of both Grams over its columns and
//       stores each with its block row's owner (es_block_owner), which
//       sums its rows in rank order, and their absolute sums give the
//       Gershgorin bounds (es_cluster_decision). Two cluster barriers a
//       sweep, two more where the bounds need the Grams, one a power step
//       in the band. The sums come in another order than one CTA's, so a
//       tile within rounding of the threshold may stop a sweep apart from
//       the one-CTA kernel;
//     - a last cluster barrier before any CTA leaves; the tile's counts
//       once, by rank 0.
// Shared memory: r RP + 2 Rg (TN + 1) + 2 r^2 + 3 r floats (RP = L Q, Rg =
// r rounded up to 4): at r = 100 within the old kernel's 3 r^2 +
// 2 r (TN + 1) + 5 r. The cluster form: es_cluster_smem_floats.
constexpr int ES_COLS = 2;
constexpr int ES_MAX_RANK = 100;
constexpr int ES_GRAM_LANES = 4;
// The cluster form: 4 to ES_MAX_CLUSTER CTAs a tile, the portable cluster
// size (16 CTAs ran slower than 8 at every shape measured on an H100:
// at r = 40, n = 293 0.150-0.157 ms a launch against 0.135; at r = 100,
// n = 1000, where the card holds 7 clusters of 16, 0.288 against 0.152),
// ES_CLUSTER_ROWS rows a lane and 16 or 32 lanes a pair of columns
// (es_cluster_lanes), so a CTA of TN / S / ES_COLS times that many
// threads, at most ES_CLUSTER_THREADS: 8 CTAs past r = 64 (es_cluster_min).
// At 512 threads a thread has 128 registers and the form spilled; at 1024
// (S = 2) it ran slower than one CTA.
constexpr int ES_MAX_CLUSTER = 8;
constexpr int ES_CLUSTER_ROWS = 4;
constexpr int ES_CLUSTER_THREADS = 256;

// Lanes per column group and rows per lane at rank r (Q a multiple of 4,
// read as float4, up to r = 64).
__host__ __device__ inline int es_lanes(int r) { return r <= 32 ? 2 : 4; }

__host__ __device__ inline int es_rows_per_lane(int r) {
  return r <= 16 ? 8 : r <= 32 ? 16 : r <= 64 ? 16 : 25;
}

// Rows of the shared tiles: r rounded up to the Gram blocks' 4.
__host__ __device__ inline int es_tile_rows(int r) { return (r + 3) & ~3; }

__host__ __device__ inline size_t es_lanes_smem_floats(int r) {
  const size_t rp = (size_t)es_lanes(r) * es_rows_per_lane(r);
  return (size_t)r * rp + 2 * (size_t)es_tile_rows(r) * HS
         + 2 * (size_t)r * r + 3 * (size_t)r;
}

// The cluster form: lanes a pair of columns (ES_CLUSTER_ROWS rows each);
// row blocks of 4 a CTA owns at most; the floats of an exchanged part:
// both Grams' w, then both Grams' diagonals or rows' absolute sums, each
// half to a multiple of 4.
__host__ __device__ inline int es_cluster_lanes(int r) {
  return r <= 64 ? 16 : 32;
}

// The fewest CTAs a tile at rank r, as many as keep a CTA within
// ES_CLUSTER_THREADS (4; 8 past r = 64); 0 where the form is not built: up
// to r = 32, where one CTA a tile is the faster (its short chains and small
// Grams save less than a sweep's exchanges across the cluster cost), and
// past ES_MAX_RANK.
__host__ __device__ inline int es_cluster_min(int r) {
  if (r <= 32 || r > ES_MAX_RANK) return 0;
  return TN / ES_COLS * es_cluster_lanes(r) / ES_CLUSTER_THREADS;
}

__host__ __device__ inline int es_cluster_blocks(int r, int S) {
  return ((es_tile_rows(r) >> 2) + S - 1) / S;
}

__host__ __device__ inline int es_cluster_part(int r) {
  return 2 * ((2 * r + 3) & ~3);
}

// A cluster-form CTA's shared floats: At (Rg rows); the tiles of its TN / S
// columns (column by column, Rg rows); the Gram blocks each CTA stores
// here and their sums (this CTA's row blocks); vd, vh, the steps; the
// products' parts each CTA stores here (two parities), this CTA's part,
// their sum; D^T v and O^T v.
__host__ __device__ inline size_t es_cluster_smem_floats(int r, int S) {
  const size_t Rg = es_tile_rows(r), ct = TN / S;
  const size_t nbl = es_cluster_blocks(r, S), part = es_cluster_part(r);
  return Rg * es_cluster_lanes(r) * ES_CLUSTER_ROWS
         + 2 * ct * Rg + 2 * 4 * nbl * Rg * (S + 1) + 3 * Rg
         + part * (2 * S + 2) + 2 * ct;
}

// Gd = D D^T and Gh = O O^T over the tile's TN columns, D = P - O (shared
// tiles of row stride HS; rows r..Rg-1 hold 0). Upper-triangle 4x4
// blocks: S neighbouring lanes sum columns s, s + S, ... of a block and
// reduce across each other; the first writes the block and its mirror.
__device__ void es_tile_grams(const float* P, const float* O, float* Gd,
                              float* Gh, int r) {
  constexpr int S = ES_GRAM_LANES;
  const int nb = es_tile_rows(r) >> 2, blocks = nb * (nb + 1) / 2;
  for (int base = 0; base < blocks * S; base += blockDim.x) {
    const int item = base + threadIdx.x;
    const bool valid = item < blocks * S;
    const int s = item % S;
    int kb = 0, rem = valid ? item / S : 0;
    while (rem >= nb - kb) { rem -= nb - kb; ++kb; }
    const int lb = kb + rem;
    float gd[4][4] = {}, gh[4][4] = {};
    if (valid) {
      const float* pk = P + 4 * kb * HS;
      const float* ok = O + 4 * kb * HS;
      const float* pl = P + 4 * lb * HS;
      const float* ol = O + 4 * lb * HS;
      for (int c = s; c < TN; c += S) {
        float dk[4], okv[4], dl[4], olv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          okv[a] = ok[a * HS + c];
          dk[a] = pk[a * HS + c] - okv[a];
          olv[a] = ol[a * HS + c];
          dl[a] = pl[a * HS + c] - olv[a];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            gd[a][b] = fmaf(dk[a], dl[b], gd[a][b]);
            gh[a][b] = fmaf(okv[a], olv[b], gh[a][b]);
          }
      }
    }
    for (int m = S >> 1; m > 0; m >>= 1)
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          gd[a][b] += __shfl_xor_sync(0xffffffffu, gd[a][b], m);
          gh[a][b] += __shfl_xor_sync(0xffffffffu, gh[a][b], m);
        }
    if (valid && s == 0)
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int k = 4 * kb + a, l = 4 * lb + b;
          if (k < r && l < r) {
            Gd[k * r + l] = gd[a][b];
            Gd[l * r + k] = gd[a][b];
            Gh[k * r + l] = gh[a][b];
            Gh[l * r + k] = gh[a][b];
          }
        }
  }
}
// One Gram's warm power steps (the TPU kernel's _lambda_max_warm_pair for
// one matrix), by one warp: `iters` normalised steps from v (updated in
// place), then the Rayleigh quotient. G is symmetric: row k is read as
// column k, the lanes on consecutive addresses. With ub, the first product
// also gives the certified upper bound min(trace, max absolute row sum).
__device__ float warp_power_steps(const float* G, float* v, float* w, int r,
                                  int iters, float* ub) {
  const int lane = threadIdx.x & 31;
  for (int it = 0;; ++it) {
    float ss = 0.f, tr = 0.f, rowmax = 0.f;
    for (int k = lane; k < r; k += 32) {
      float a[4] = {}, s[4] = {};
      int l = 0;
      for (; l + 4 <= r; l += 4)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float gv = G[(l + q) * r + k];
          a[q] = fmaf(gv, v[l + q], a[q]);
          s[q] += fabsf(gv);
        }
      for (; l < r; ++l) {
        const float gv = G[l * r + k];
        a[0] = fmaf(gv, v[l], a[0]);
        s[0] += fabsf(gv);
      }
      const float wk = (a[0] + a[1]) + (a[2] + a[3]);
      w[k] = wk;
      ss += wk * wk;
      tr += G[k * r + k];
      rowmax = fmaxf(rowmax, (s[0] + s[1]) + (s[2] + s[3]));
    }
    if (ub && it == 0) *ub = fminf(warp_sum(tr), warp_max(rowmax));
    __syncwarp();
    if (it == iters) break;
    const float nrm = fmaxf(sqrtf(warp_sum(ss)), 1e-30f);
    for (int k = lane; k < r; k += 32) v[k] = w[k] / nrm;
    __syncwarp();
  }
  float q = 0.f, p = 0.f;
  for (int k = lane; k < r; k += 32) {
    q += v[k] * w[k];
    p += v[k] * v[k];
  }
  return warp_sum(q) / fmaxf(warp_sum(p), 1e-30f);
}

// The per-tile stop (_stopping_update) with one warp per Gram: warp 0 on
// Gd (vectors vd, wd), warp 1 on Gh (vh, wh; wd and wh are scratch); the
// bounds meet in xch. Call after a barrier;
// returns the same decision (1 = converged) in every thread, after at most
// two block barriers.
__device__ int es_stop_decision(const float* Gd, const float* Gh, float* vd,
                                float* vh, float* wd, float* wh, float* xch,
                                int r, float stop2, int pi_iters) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < 2) {
    const float* G = warp ? Gh : Gd;
    float* v = warp ? vh : vd;
    float* w = warp ? wh : wd;
    for (int k = lane; k < r; k += 32)
      v[k] += 0.05f * (0.5f + (float)((k * 40503) % 65536) / 65536.0f);
    __syncwarp();
    float ub;
    const float lb = warp_power_steps(G, v, w, r, 1, &ub);
    if (lane == 0) {
      xch[2 * warp] = lb;
      xch[2 * warp + 1] = ub;
    }
  }
  __syncthreads();
  const float lb_d = xch[0], ub_d = xch[1], lb_h = xch[2], ub_h = xch[3];
  const bool conv_certain = ub_d <= stop2 * lb_h;
  const bool notconv_certain = lb_d > stop2 * ub_h;
  if (conv_certain || notconv_certain) return conv_certain;
  __syncthreads();  // every thread has read xch
  if (warp < 2) {
    const float lam = warp_power_steps(warp ? Gh : Gd, warp ? vh : vd,
                                       warp ? wh : wd, r, pi_iters, nullptr);
    if (lane == 0) xch[warp] = lam;
  }
  __syncthreads();
  return xch[0] <= stop2 * xch[1];
}

// The cluster barrier for the early-stop coder's cluster form, taken by
// every thread after code in which the warp's lanes parted.
__device__ __forceinline__ void es_cluster_sync() {
  __syncwarp();
  cluster_arrive();
  cluster_wait();
}

// Row k, column col of a tile: row-major at stride HS in one CTA; column by
// column at stride Rg in a cluster, so that a column's rows are
// consecutive (float4 loads in the Grams and the products).
template <bool kCluster>
__device__ __forceinline__ int es_tix(int k, int col, int Rg) {
  if constexpr (kCluster)
    return col * Rg + k;
  else
    return k * HS + col;
}

// The owner of the Grams' row block kb in a cluster of S, and the kbl-th
// row block of rank `rank`: dealt in rounds of S, every other round in
// reverse, so that the long rows at the top and the short ones at the
// bottom even out.
__device__ __forceinline__ int es_block_owner(int kb, int S) {
  const int round = kb / S, pos = kb - round * S;
  return round & 1 ? S - 1 - pos : pos;
}

__device__ __forceinline__ int es_owned_block(int rank, int kbl, int S) {
  return kbl * S + (kbl & 1 ? S - 1 - rank : rank);
}

// A cluster-form CTA's view of its shared memory (es_cluster_smem_floats).
struct EsCluster {
  float* Hs;   // (CT, Rg) iterate, column by column
  float* Os;   // (CT, Rg) iterate before the sweep
  float* GS;   // [2 Grams][S ranks][nbl][4][Rg]: the blocks each rank stores
  float* Gm;   // [2][nbl][4][Rg]: their sums, this CTA's row blocks
  float* vd;   // (Rg) the carried vectors, 0 past r
  float* vh;
  float* PV;   // [2 parities][S ranks][part]: the parts each rank stores
  float* loc;  // (part) this CTA's part
  float* wf;   // (part) the parts summed: w of both, row sums, traces
  float* uu;   // (2, CT) D^T v, O^T v
  int r, Rg, S, rank, CT, nb, nbl, W, part;  // W: half a part
};

// The upper 4x4 blocks (kb, lb >= kb) of Gd = D D^T and Gh = O O^T over
// this CTA's columns (D = P - O; rows r..Rg-1 hold 0), one thread a block,
// the columns in turn; each block's rows stored in the owner of row block
// kb (es_block_owner: the row blocks dealt in rounds of S, every other
// round reversed), in its slot for this rank.
__device__ void es_cluster_blocks(const EsCluster& c) {
  cg::cluster_group cluster = cg::this_cluster();
  const int nb = c.nb, blocks = nb * (nb + 1) / 2;
  for (int item = threadIdx.x; item < blocks; item += blockDim.x) {
    int kb = 0, rem = item;
    while (rem >= nb - kb) { rem -= nb - kb; ++kb; }
    const int lb = kb + rem;
    float gd[4][4] = {}, gh[4][4] = {};
    for (int col = 0; col < c.CT; ++col) {
      const float* P = c.Hs + col * c.Rg;
      const float* O = c.Os + col * c.Rg;
      const float4 pk = *reinterpret_cast<const float4*>(P + 4 * kb);
      const float4 ok = *reinterpret_cast<const float4*>(O + 4 * kb);
      const float4 pl = *reinterpret_cast<const float4*>(P + 4 * lb);
      const float4 ol = *reinterpret_cast<const float4*>(O + 4 * lb);
      const float okv[4] = {ok.x, ok.y, ok.z, ok.w};
      const float olv[4] = {ol.x, ol.y, ol.z, ol.w};
      const float dk[4] = {pk.x - ok.x, pk.y - ok.y, pk.z - ok.z, pk.w - ok.w};
      const float dl[4] = {pl.x - ol.x, pl.y - ol.y, pl.z - ol.z, pl.w - ol.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          gd[a][b] = fmaf(dk[a], dl[b], gd[a][b]);
          gh[a][b] = fmaf(okv[a], olv[b], gh[a][b]);
        }
    }
    float* slot = cluster.map_shared_rank(c.GS, es_block_owner(kb, c.S))
                  + ((c.rank * c.nbl + kb / c.S) * 4) * c.Rg + 4 * lb;
    const size_t gram = (size_t)c.S * c.nbl * 4 * c.Rg;
#pragma unroll
    for (int a = 0; a < 4; ++a)
      if (4 * kb + a < c.r) {
        *reinterpret_cast<float4*>(slot + a * c.Rg) =
            make_float4(gd[a][0], gd[a][1], gd[a][2], gd[a][3]);
        *reinterpret_cast<float4*>(slot + gram + a * c.Rg) =
            make_float4(gh[a][0], gh[a][1], gh[a][2], gh[a][3]);
      }
  }
}

// This CTA's rows of both Grams: the blocks (kb, lb >= kb) of its row
// blocks (es_owned_block), each summed over the ranks' slots in rank
// order, into Gm.
__device__ void es_cluster_sum_blocks(const EsCluster& c) {
  const int rows = 2 * c.nbl * 4;  // (Gram, kbl, a)
  const int slot4 = c.nbl * c.Rg;  // one rank's slot, in float4
  for (int x = threadIdx.x; x < rows * c.nb; x += blockDim.x) {
    const int row = x / c.nb, lb = x - row * c.nb;
    const int g = row / (4 * c.nbl), kbl = (row >> 2) - g * c.nbl;
    const int kb = es_owned_block(c.rank, kbl, c.S);
    if (kb >= c.nb || lb < kb || 4 * kb + (row & 3) >= c.r) continue;
    const int at = ((kbl * 4) + (row & 3)) * c.Rg + 4 * lb;
    const float4* src = reinterpret_cast<const float4*>(
        c.GS + (size_t)g * c.S * c.nbl * 4 * c.Rg + at);
    float4 v[ES_MAX_CLUSTER];
#pragma unroll
    for (int j = 0; j < ES_MAX_CLUSTER; ++j)
      if (j < c.S) v[j] = src[j * slot4];
    float4 acc = v[0];
#pragma unroll
    for (int j = 1; j < ES_MAX_CLUSTER; ++j)
      if (j < c.S) {
        acc.x += v[j].x;
        acc.y += v[j].y;
        acc.z += v[j].z;
        acc.w += v[j].w;
      }
    *reinterpret_cast<float4*>(c.Gm + g * c.nbl * 4 * c.Rg + at) = acc;
  }
}

// This CTA's part of w = G v for both Grams, D_j (D_j^T v) and
// O_j (O_j^T v), into loc[0 .. 2 r): D^T v and O^T v by 8 lanes a column
// (the block's threads, a multiple of 32 dividing 16 CT, in turns), then
// a thread a row.
__device__ void es_cluster_part_product(const EsCluster& c) {
  const int t = threadIdx.x;
  for (int slot = t; slot < 16 * c.CT; slot += blockDim.x) {
    const int item = slot >> 3, part = slot & 7;
    const int g = item >= c.CT, col = item - g * c.CT;
    const float* v = g ? c.vh : c.vd;
    const float* P = c.Hs + col * c.Rg;
    const float* O = c.Os + col * c.Rg;
    float acc[4] = {};
    for (int k = 4 * part; k < c.Rg; k += 32) {
      const float4 o = *reinterpret_cast<const float4*>(O + k);
      const float4 vv = *reinterpret_cast<const float4*>(v + k);
      float4 x = o;
      if (!g) {
        const float4 p = *reinterpret_cast<const float4*>(P + k);
        x = make_float4(p.x - o.x, p.y - o.y, p.z - o.z, p.w - o.w);
      }
      acc[0] = fmaf(x.x, vv.x, acc[0]);
      acc[1] = fmaf(x.y, vv.y, acc[1]);
      acc[2] = fmaf(x.z, vv.z, acc[2]);
      acc[3] = fmaf(x.w, vv.w, acc[3]);
    }
    float u = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    u += __shfl_xor_sync(0xffffffffu, u, 4);
    u += __shfl_xor_sync(0xffffffffu, u, 2);
    u += __shfl_xor_sync(0xffffffffu, u, 1);
    if (part == 0) c.uu[item] = u;
  }
  __syncthreads();
  for (int x = t; x < 2 * c.r; x += blockDim.x) {
    const int g = x >= c.r, m = x - g * c.r;
    const float* u = c.uu + g * c.CT;
    float acc = 0.f;
    for (int col = 0; col < c.CT; ++col) {
      const float o = c.Os[col * c.Rg + m];
      acc = fmaf(g ? o : c.Hs[col * c.Rg + m] - o, u[col], acc);
    }
    c.loc[x] = acc;
  }
}

// This CTA's part of both Grams' diagonals, into loc[W + g r + k]: each
// entry as es_cluster_blocks forms it (its columns in turn, fused), so
// that the summed diagonal is the summed Grams' bit for bit.
__device__ void es_cluster_part_diag(const EsCluster& c) {
  for (int x = threadIdx.x; x < 2 * c.r; x += blockDim.x) {
    const int g = x >= c.r, k = x - g * c.r;
    float acc = 0.f;
    for (int col = 0; col < c.CT; ++col) {
      const float o = c.Os[col * c.Rg + k];
      const float d = g ? o : c.Hs[col * c.Rg + k] - o;
      acc = fmaf(d, d, acc);
    }
    c.loc[c.W + x] = acc;
  }
}

// This CTA's part of each row's absolute sum of both Grams, into
// loc[W + g r + l]: for its own rows their entries from the diagonal
// block on, for the others the transposed entries of its blocks above
// them.
__device__ void es_cluster_part_bounds(const EsCluster& c) {
  for (int x = threadIdx.x; x < 2 * c.r; x += blockDim.x) {
    const int g = x >= c.r, l = x - g * c.r, lb = l >> 2;
    float acc = 0.f;
    for (int kbl = 0; kbl < c.nbl; ++kbl) {
      const int kb = es_owned_block(c.rank, kbl, c.S);
      if (kb >= c.nb || kb > lb) break;
      const float* G = c.Gm + (g * c.nbl + kbl) * 4 * c.Rg;
      if (kb < lb) {
        for (int a = 0; a < 4 && 4 * kb + a < c.r; ++a)
          acc += fabsf(G[a * c.Rg + l]);
      } else {  // its own row, a float4 at a time from the diagonal block
        const float* row = G + (l - 4 * kb) * c.Rg;
        float s4[4] = {};
        for (int m = 4 * kb; m < c.Rg; m += 4) {
          const float4 e = *reinterpret_cast<const float4*>(row + m);
          s4[0] += fabsf(e.x);
          s4[1] += m + 1 < c.r ? fabsf(e.y) : 0.f;
          s4[2] += m + 2 < c.r ? fabsf(e.z) : 0.f;
          s4[3] += m + 3 < c.r ? fabsf(e.w) : 0.f;
        }
        acc += (s4[0] + s4[1]) + (s4[2] + s4[3]);
      }
    }
    c.loc[c.W + x] = acc;
  }
}

// Floats lo..lo+n-1 of this CTA's staged part (multiples of 4) stored in
// its slot of parity `par` in every CTA of the cluster, then the cluster
// barrier, then the S parts summed in rank order into wf. A slot is
// stored again two exchanges later, after the next one's barrier, which
// every reader of it has passed only once it has summed.
__device__ void es_cluster_exchange(const EsCluster& c, int par, int lo,
                                    int n) {
  cg::cluster_group cluster = cg::this_cluster();
  __syncthreads();  // loc is staged
  const int n4 = n >> 2;
  for (int x = threadIdx.x; x < c.S * n4; x += blockDim.x) {
    const int dst = x / n4, i = (lo >> 2) + x - dst * n4;
    float* slot = cluster.map_shared_rank(c.PV, dst)
                  + (par * c.S + c.rank) * c.part;
    reinterpret_cast<float4*>(slot)[i] =
        reinterpret_cast<const float4*>(c.loc)[i];
  }
  es_cluster_sync();
  const float* parts = c.PV + par * c.S * c.part;
  for (int x = lo + threadIdx.x; x < lo + n; x += blockDim.x) {
    float p[ES_MAX_CLUSTER];
#pragma unroll
    for (int j = 0; j < ES_MAX_CLUSTER; ++j)
      if (j < c.S) p[j] = parts[j * c.part + x];
    float acc = p[0];
#pragma unroll
    for (int j = 1; j < ES_MAX_CLUSTER; ++j)
      if (j < c.S) acc += p[j];
    c.wf[x] = acc;
  }
  __syncthreads();
}

// v = w / |w| by one warp, in warp_power_steps' order.
__device__ void es_normalise(float* v, const float* w, int r) {
  const int lane = threadIdx.x & 31;
  float ss = 0.f;
  for (int k = lane; k < r; k += 32) ss += w[k] * w[k];
  const float nrm = fmaxf(sqrtf(warp_sum(ss)), 1e-30f);
  for (int k = lane; k < r; k += 32) v[k] = w[k] / nrm;
}

// The Rayleigh quotient v.w / v.v by one warp, in warp_power_steps' order.
__device__ float es_rayleigh(const float* v, const float* w, int r) {
  const int lane = threadIdx.x & 31;
  float q = 0.f, p = 0.f;
  for (int k = lane; k < r; k += 32) {
    q += v[k] * w[k];
    p += v[k] * v[k];
  }
  return warp_sum(q) / fmaxf(warp_sum(p), 1e-30f);
}

// es_stop_decision on the tile's cluster, after its sweep (the tiles
// written, a block barrier passed). The first product's parts go with the
// diagonals' (one barrier), the second product's alone (one barrier); v
// = w / |w| and the Rayleigh quotients in between, warps 0 and 1 a Gram
// each (one warp both, where the CTA has one). The traces and the largest
// diagonal entries decide where they can, as the one-CTA decision would:
// a trace bound at most stop^2 lb_h converges; the Gershgorin bound of Gd
// is at least its largest diagonal entry (a float sum of nonnegative
// terms is at least each), so a diagonal entry above stop^2 lb_h with lb_d
// above stop^2 tr_h is certain not to. Otherwise the Grams' blocks go to
// their owners (one barrier), and the rows' absolute sums (one barrier)
// give the Gershgorin bounds; then the one-CTA decision, and in the band
// one exchange a power step. The same in every thread of every CTA.
// `products` counts the launch's exchanges (their slots' parity).
__device__ int es_cluster_decision(const EsCluster& c, float* xch,
                                   float stop2, int pi_iters,
                                   int& products) {
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, r = c.r;
  const int nwarps = blockDim.x >> 5;
  for (int x = t; x < 2 * r; x += blockDim.x) {
    const int k = x - (x >= r) * r;
    (x < r ? c.vd : c.vh)[k] +=
        0.05f * (0.5f + (float)((k * 40503) % 65536) / 65536.0f);
  }
  __syncthreads();
  es_cluster_part_product(c);
  es_cluster_part_diag(c);
  es_cluster_exchange(c, products++ & 1, 0, 2 * c.W);
  for (int gram = warp; gram < 2; gram += nwarps) {
    const float* dg = c.wf + c.W + gram * r;
    float tr = 0.f, md = 0.f;
    for (int k = lane; k < r; k += 32) {
      tr += dg[k];
      md = fmaxf(md, dg[k]);
    }
    tr = warp_sum(tr);
    md = warp_max(md);
    es_normalise(gram ? c.vh : c.vd, c.wf + gram * r, r);
    if (lane == 0) {
      xch[4 + gram] = tr;
      xch[6 + gram] = md;
    }
  }
  __syncthreads();
  es_cluster_part_product(c);
  es_cluster_exchange(c, products++ & 1, 0, c.W);
  for (int gram = warp; gram < 2; gram += nwarps) {
    const float lb = es_rayleigh(gram ? c.vh : c.vd, c.wf + gram * r, r);
    if (lane == 0) xch[2 * gram] = lb;
  }
  __syncthreads();
  const float lb_d = xch[0], lb_h = xch[2], tr_d = xch[4], tr_h = xch[5];
  if (tr_d <= stop2 * lb_h) return 1;
  if (xch[6] > stop2 * lb_h && lb_d > stop2 * tr_h) return 0;
  es_cluster_blocks(c);
  es_cluster_sync();  // the blocks are stored
  es_cluster_sum_blocks(c);
  __syncthreads();
  es_cluster_part_bounds(c);
  es_cluster_exchange(c, products++ & 1, c.W, c.W);
  for (int gram = warp; gram < 2; gram += nwarps) {
    float rowmax = 0.f;
    for (int k = lane; k < r; k += 32)
      rowmax = fmaxf(rowmax, c.wf[c.W + gram * r + k]);
    rowmax = warp_max(rowmax);
    if (lane == 0) xch[2 * gram + 1] = fminf(xch[4 + gram], rowmax);
  }
  __syncthreads();
  const float ub_d = xch[1], ub_h = xch[3];
  const bool conv_certain = ub_d <= stop2 * lb_h;
  const bool notconv_certain = lb_d > stop2 * ub_h;
  if (conv_certain || notconv_certain) return conv_certain;
  __syncthreads();  // every thread has read xch
  // the band: pi_iters more steps (the first product of the one-CTA
  // kernel's second call is the last product again, so it is not formed)
  for (int it = 0; it < pi_iters; ++it) {
    for (int gram = warp; gram < 2; gram += nwarps)
      es_normalise(gram ? c.vh : c.vd, c.wf + gram * r, r);
    __syncthreads();
    es_cluster_part_product(c);
    es_cluster_exchange(c, products++ & 1, 0, c.W);
  }
  for (int gram = warp; gram < 2; gram += nwarps) {
    const float lam = es_rayleigh(gram ? c.vh : c.vd, c.wf + gram * r, r);
    if (lane == 0) xch[gram] = lam;
  }
  __syncthreads();
  return xch[0] <= stop2 * xch[1];
}

// A lane's Q consecutive rows of a column of At (float4 loads when Q is a
// multiple of 4; the rows start 16-byte aligned then).
template <int Q>
__device__ __forceinline__ void load_rows(const float* a, float* out) {
  if constexpr (Q % 4 == 0) {
#pragma unroll
    for (int q = 0; q < Q; q += 4) {
      const float4 v = *reinterpret_cast<const float4*>(a + q);
      out[q] = v.x;
      out[q + 1] = v.y;
      out[q + 2] = v.z;
      out[q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < Q; ++q) out[q] = a[q];
  }
}

template <int L, int Q, bool kCluster>
__global__ void __launch_bounds__(kCluster ? ES_CLUSTER_THREADS
                                           : TN / ES_COLS * L,
                                  kCluster ? 1 : (L == 2 ? 4 : 1))
    coder_es_lanes_kernel(const float* __restrict__ A,
                          const float* __restrict__ B,
                          const float* __restrict__ H0,
                          float* __restrict__ H, int r, int n, float alpha,
                          float stop, int sub_iter, int pi_iters) {
  count_run(RUN_CODER_ES);
  count_columns(ES_COLUMNS, n);
  extern __shared__ float smem[];
  constexpr int C = ES_COLS, RP = L * Q;
  constexpr bool kReform = L * Q > 32;  // g formed anew every sweep: r > 32
  const int Rg = es_tile_rows(r);
  // in a cluster: this CTA's rank of S and its CT of the tile's columns
  int S = 1, rank = 0;
  if constexpr (kCluster) {
    S = (int)cg::this_cluster().num_blocks();
    rank = (int)cg::this_cluster().block_rank();
  }
  const int CT = kCluster ? TN / S : TN;
  const unsigned tile0 = (kCluster ? blockIdx.x / S : blockIdx.x) * TN;
  const unsigned c0 = tile0 + rank * CT;  // this CTA's first column
  float* At = smem;             // (r, RP): At[k * RP + i] = A[i, k]; 0 past r
                                // (a cluster: (Rg, RP), rows past r 0)
  float* Hs = At + (kCluster ? Rg : r) * RP;  // (Rg, HS) iterate (a
                                // cluster: (CT, Rg))
  float* Os = Hs + (kCluster ? CT * Rg : Rg * HS);  // iterate before the
                                // sweep; after the Grams, the power steps'
                                // scratch (one CTA)
  float* Gd = nullptr;          // (r, r) delta Gram (one CTA)
  float* Gh = nullptr;          // (r, r) iterate Gram (one CTA)
  float* vd;                    // (r) carried eigenvector estimates
  float* vh;
  float* step;                  // (r) this sweep's rs / (A_kk + 1)
  EsCluster ec = {};
  if constexpr (kCluster) {
    ec.r = r;
    ec.Rg = Rg;
    ec.S = S;
    ec.rank = rank;
    ec.CT = CT;
    ec.nb = Rg >> 2;
    ec.nbl = es_cluster_blocks(r, S);
    ec.part = es_cluster_part(r);
    ec.W = ec.part >> 1;
    ec.Hs = Hs;
    ec.Os = Os;
    ec.GS = Os + CT * Rg;
    ec.Gm = ec.GS + 2 * S * ec.nbl * 4 * Rg;
    vd = ec.vd = ec.Gm + 2 * ec.nbl * 4 * Rg;
    vh = ec.vh = vd + Rg;
    step = vh + Rg;
    ec.PV = step + Rg;
    ec.loc = ec.PV + 2 * S * ec.part;
    ec.wf = ec.loc + ec.part;
    ec.uu = ec.wf + ec.part;
  } else {
    Gd = Os + Rg * HS;
    Gh = Gd + r * r;
    vd = Gh + r * r;
    vh = vd + r;
    step = vh + r;
  }
  __shared__ float xch[kCluster ? 8 : 4];

  // this thread: lane ell of the group of columns cc[u] = grp + u CT / C
  const int t = threadIdx.x, grp = t / L, ell = t % L;
  const int group = (t & 31) & ~(L - 1);  // the group's first lane
  int cc[C];
  bool active[C];
#pragma unroll
  for (int u = 0; u < C; ++u) {
    cc[u] = grp + u * (CT / C);
    active[u] = c0 + cc[u] < n;
  }
  // A^T and the tile of H0, eight global loads in flight per thread
  const int at_rows = kCluster ? Rg : r;
  for (int x0 = t; x0 < at_rows * RP; x0 += 8 * blockDim.x) {
    float v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int x = x0 + q * blockDim.x, k = x / RP, i = x % RP;
      v[q] = x < at_rows * RP && i < r && k < r ? A[i * r + k] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (x0 + q * blockDim.x < at_rows * RP) At[x0 + q * blockDim.x] = v[q];
  }
  for (int x0 = t; x0 < Rg * CT; x0 += 8 * blockDim.x) {
    float v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int x = x0 + q * blockDim.x, k = x / CT, col = x % CT;
      const int cl = c0 + col;
      v[q] = x < Rg * CT && k < r && cl < n ? H0[(size_t)k * n + cl] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int x = x0 + q * blockDim.x, k = x / CT, col = x % CT;
      if (x < Rg * CT) {
        Hs[es_tix<kCluster>(k, col, Rg)] = v[q];
        Os[es_tix<kCluster>(k, col, Rg)] = 0.f;
      }
    }
  }
  if constexpr (kCluster) {
    for (int k = t; k < Rg; k += blockDim.x) {
      vd[k] = vh[k] = k < r ? 0.5f + (float)((k * 40503) % 65536) / 65536.0f
                            : 0.f;
      step[k] = k < r ? 1.0f / sqrtf(10.0f) / (A[k * r + k] + 1.0f) : 0.f;
    }
  } else {
    for (int k = t; k < r; k += blockDim.x) {
      vd[k] = vh[k] = 0.5f + (float)((k * 40503) % 65536) / 65536.0f;
      step[k] = 1.0f / sqrtf(10.0f) / (A[k * r + k] + 1.0f);
    }
  }
  __syncthreads();

  // rows ell * Q + q of each column, and of its g = A h - b
  float h[C][Q], g[C][Q];
#pragma unroll
  for (int u = 0; u < C; ++u)
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int k = ell * Q + q;
      h[u][q] = k < r ? Hs[es_tix<kCluster>(k, cc[u], Rg)] : 0.f;
    }
  const float stop2 = stop * stop;
  int swept = sub_iter, products = 0;
  for (int i = 0; i < sub_iter; ++i) {
    if (kReform || i == 0) {
#pragma unroll
      for (int u = 0; u < C; ++u)
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int k = ell * Q + q;
          g[u][q] = k < r && active[u]
              ? -__ldg(B + (size_t)k * n + c0 + cc[u]) : 0.f;
        }
      if constexpr (kCluster) {  // four h_m a float4; At and h are 0 past r
        for (int m = 0; m < Rg; m += 4) {
          float a[4][Q];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            load_rows<Q>(At + (m + j) * RP + ell * Q, a[j]);
#pragma unroll
          for (int u = 0; u < C; ++u) {
            const float4 h4 =
                *reinterpret_cast<const float4*>(Hs + cc[u] * Rg + m);
            const float hm[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int q = 0; q < Q; ++q)
                g[u][q] = fmaf(a[j][q], hm[j], g[u][q]);
          }
        }
      } else {
        for (int m = 0; m < r; ++m) {
          float a[Q];
          load_rows<Q>(At + m * RP + ell * Q, a);
#pragma unroll
          for (int u = 0; u < C; ++u) {
            const float hm = Hs[m * HS + cc[u]];
#pragma unroll
            for (int q = 0; q < Q; ++q) g[u][q] = fmaf(a[q], hm, g[u][q]);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < C; ++u)
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int k = ell * Q + q;
        if (k < r) Os[es_tix<kCluster>(k, cc[u], Rg)] = h[u][q];
      }
    if constexpr (kCluster) {
      // Each owner's Q coordinates first, on a copy of its rows of g (its
      // own deltas only; every lane forms the same, the owner's are
      // taken), then their deltas to every lane, all shuffles at once, in
      // coordinate order: the chain stays within an owner's rows. A lane
      // keeps the steps of its own rows, the only ones whose candidates are
      // taken, and 0 for a column past n and a row past r: h, g and b are
      // 0 there, so the candidate is h again and the delta 0, with no test
      // in the loop (the tests and a prefetch of the next block's A took
      // ~40% of the chain); a zero delta and At's zero rows past r add 0.
      float st[C][Q];
#pragma unroll
      for (int u = 0; u < C; ++u)
#pragma unroll
        for (int q = 0; q < Q; ++q)
          st[u][q] = active[u] && ell * Q + q < r ? step[ell * Q + q] : 0.f;
      for (int l0 = 0; l0 * Q < r; ++l0) {
        float a[Q][Q];  // a[q0]: A[this lane's rows, coordinate l0 Q + q0]
#pragma unroll
        for (int q0 = 0; q0 < Q; ++q0)
          load_rows<Q>(At + (l0 * Q + q0) * RP + ell * Q, a[q0]);
        float d[C][Q];
#pragma unroll
        for (int u = 0; u < C; ++u) {
          float gg[Q];
#pragma unroll
          for (int q = 0; q < Q; ++q) gg[q] = g[u][q];
#pragma unroll
          for (int q0 = 0; q0 < Q; ++q0) {
            const float hn =
                fmaxf(h[u][q0] - st[u][q0] * (gg[q0] + alpha), 0.f);
            d[u][q0] = hn - h[u][q0];
            if (ell == l0) h[u][q0] = hn;
#pragma unroll
            for (int q = q0 + 1; q < Q; ++q)
              gg[q] = fmaf(a[q0][q], d[u][q0], gg[q]);
          }
        }
        float delta[C][Q];
#pragma unroll
        for (int q0 = 0; q0 < Q; ++q0)
#pragma unroll
          for (int u = 0; u < C; ++u)
            delta[u][q0] = __shfl_sync(0xffffffffu, d[u][q0], group + l0);
#pragma unroll
        for (int q0 = 0; q0 < Q; ++q0)
#pragma unroll
          for (int u = 0; u < C; ++u)
#pragma unroll
            for (int q = 0; q < Q; ++q)
              g[u][q] = fmaf(a[q0][q], delta[u][q0], g[u][q]);
      }
    } else {
      for (int l0 = 0; l0 < L; ++l0) {
#pragma unroll
        for (int q0 = 0; q0 < Q; ++q0) {
          const int k = l0 * Q + q0;
          if (k >= r) break;
          const float st = step[k];
          float a[Q];
          load_rows<Q>(At + k * RP + ell * Q, a);
#pragma unroll
          for (int u = 0; u < C; ++u) {
            // every lane forms its own row's candidate; the owner's is
            // taken
            const float hn =
                fmaxf(h[u][q0] - st * (g[u][q0] + alpha), 0.f);
            float delta =
                __shfl_sync(0xffffffffu, hn - h[u][q0], group + l0);
            if (!active[u]) delta = 0.f;
            if (ell == l0 && active[u]) h[u][q0] = hn;
#pragma unroll
            for (int q = 0; q < Q; ++q) g[u][q] = fmaf(a[q], delta, g[u][q]);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < C; ++u)
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int k = ell * Q + q;
        if (k < r) Hs[es_tix<kCluster>(k, cc[u], Rg)] = h[u][q];
      }
    __syncthreads();
    int cv;
    if constexpr (kCluster) {
      cv = es_cluster_decision(ec, xch, stop2, pi_iters, products);
    } else {
      es_tile_grams(Hs, Os, Gd, Gh, r);
      __syncthreads();
      cv = es_stop_decision(Gd, Gh, vd, vh, Os, Os + r, xch, r, stop2,
                            pi_iters);
    }
    if (cv) {  // the same in every thread (of every CTA of a cluster)
      swept = i + 1;
      break;
    }
    for (int k = t; k < r; k += blockDim.x)
      step[k] = 1.0f / sqrtf((float)i + 11.0f) / (At[k * RP + k] + 1.0f);
    __syncthreads();  // the steps, and xch, Os and the vectors next sweep
  }
  if constexpr (kCluster) {
    cluster_arrive();  // this CTA is done with the others' shared memory
    if (rank == 0) {   // the tile's counts, once
      count_sweeps(ES_COLUMN_SWEEPS, swept, tile0, n);
      count_cluster_columns(tile0, n);
    }
  } else {
    count_sweeps(ES_COLUMN_SWEEPS, swept, (size_t)blockIdx.x * TN, n);
  }
  __syncthreads();
  for (int x = t; x < r * CT; x += blockDim.x) {
    const int k = x / CT, col = x % CT, cl = c0 + col;
    if (cl < n) H[(size_t)k * n + cl] = Hs[es_tix<kCluster>(k, col, Rg)];
  }
  // no CTA leaves while another may still use its shared memory
  if constexpr (kCluster) cluster_wait();
}

// ---------------------------------------------------------------------------
// The shared-memory fixed-sweep coder, r <= CS_MAX_RANK: coder_lanes_kernel.
//
// Replaces coder_sweeps (pallas/coder_kernel.py:192): exactly sub_iter
// Gauss-Seidel sweeps, step 1 / sqrt(i + 10) / (A_kk + 1). What bounds it:
// the sub_iter r^2 multiply-adds per column on the CUDA cores (10 sweeps at
// r = 25, n = 131,109: 1.6 GFLOP, ~25 us at 67 TFLOP/s f32) against ~39 MB
// of B, H0 and H (~12 us); and within a column the r coordinate steps of a
// sweep are a sequential chain. One thread per column with the column in
// shared memory paid two shared loads per multiply-add on an r-long
// dependent dot product. What the design does about it, carried over from
// coder_es_lanes_kernel without the stop:
//   * L lanes per pair of columns (2 up to r = 32, else 4), each lane
//     holding Q consecutive rows of h and of the residual g = A h - b of
//     both columns in registers. Coordinate k: the owner's candidate
//     h_k' = max(0, h_k - step_k (g_k + alpha)), one shuffle per column of
//     delta = h_k' - h_k, then g += A[:, k] delta as Q independent
//     multiply-adds per column. Each A value (float4 loads of the
//     transposed, zero-padded A^T) serves both columns; nothing but the
//     candidate and the shuffle is on the dependent chain.
//   * No tiles, Grams, power vectors or barriers after the load: h and g
//     live in registers from H0 to H, shared memory holds only A^T
//     (r L Q floats: 3.2 KB at r = 25), so several blocks share an SM.
//     g is first formed by the same shuffle-and-update pass over H0.
//   * float32 rounding of a carried g builds up over the r rank-1 updates
//     of a sweep. g is formed anew from A h - b every CS_REFORM sweeps up
//     to r = 32 (carried over 50 sweeps it stays 7e-6 from the plain
//     version) and every sweep past it (carried over ten sweeps at r = 128
//     it drifts 5e-5, past the tolerance's atol 2e-5).
//   * B, H0 and H are touched once each, a warp's loads of a row covering
//     32 / L consecutive columns (whole 32-byte sectors).
// Small n (n = 500: four blocks) gains from the short chain alone.
constexpr int CS_COLS = 2;
constexpr int CS_MAX_RANK = 128;
constexpr int CS_REFORM = 16;

// Rows per lane at rank r (lanes as es_lanes: 2 up to r = 32, else 4).
__host__ __device__ inline int cs_rows_per_lane(int r) {
  return r <= 16 ? 8 : r <= 32 ? 16 : r <= 64 ? 16 : r <= 100 ? 25 : 32;
}

template <int L, int Q>
__global__ void __launch_bounds__(TN / CS_COLS * L, L == 2 ? 4 : 1)
    coder_lanes_kernel(const float* __restrict__ A,
                       const float* __restrict__ B,
                       const float* __restrict__ H0, float* __restrict__ H,
                       int r, int n, float alpha, int sub_iter) {
  count_run(RUN_CODER);
  extern __shared__ float smem[];
  constexpr int C = CS_COLS, RP = L * Q;
  constexpr int kReform = RP > 32 ? 1 : CS_REFORM;  // sweeps per fresh g
  float* At = smem;  // (r, RP): At[k * RP + i] = A[i, k]; 0 past r

  // this thread: lane ell of the group of columns cc[u] = grp + u TN / C
  const int t = threadIdx.x, grp = t / L, ell = t % L;
  const int group = (t & 31) & ~(L - 1);  // the group's first lane
  size_t col[C];
  bool active[C];
#pragma unroll
  for (int u = 0; u < C; ++u) {
    col[u] = (size_t)blockIdx.x * TN + grp + u * (TN / C);
    active[u] = col[u] < (size_t)n;
  }
  // rows ell * Q + q of each column (0 past r and past n), loaded while
  // A^T is on its way
  float h[C][Q], g[C][Q];
#pragma unroll
  for (int u = 0; u < C; ++u)
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int k = ell * Q + q;
      h[u][q] = k < r && active[u] ? __ldg(H0 + (size_t)k * n + col[u]) : 0.f;
    }
  for (int x0 = t; x0 < r * RP; x0 += 8 * blockDim.x) {
    float v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int x = x0 + q * blockDim.x, k = x / RP, i = x % RP;
      v[q] = x < r * RP && i < r ? A[i * r + k] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (x0 + q * blockDim.x < r * RP) At[x0 + q * blockDim.x] = v[q];
  }
  __syncthreads();

  for (int i = 0; i < sub_iter; ++i) {
    if (i % kReform == 0) {
      // g = A h - b: row m of h from its owner, as a coordinate step does
#pragma unroll
      for (int u = 0; u < C; ++u)
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int k = ell * Q + q;
          g[u][q] = k < r && active[u]
              ? -__ldg(B + (size_t)k * n + col[u]) : 0.f;
        }
      for (int l0 = 0; l0 < L; ++l0) {
#pragma unroll
        for (int q0 = 0; q0 < Q; ++q0) {
          const int m = l0 * Q + q0;
          if (m >= r) break;
          float a[Q];
          load_rows<Q>(At + m * RP + ell * Q, a);
#pragma unroll
          for (int u = 0; u < C; ++u) {
            const float hm = __shfl_sync(0xffffffffu, h[u][q0], group + l0);
#pragma unroll
            for (int q = 0; q < Q; ++q) g[u][q] = fmaf(a[q], hm, g[u][q]);
          }
        }
      }
    }
    // this sweep's steps of the lane's own rows
    const float rs = 1.0f / sqrtf((float)i + 10.0f);
    float st[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int k = ell * Q + q;
      st[q] = rs / ((k < r ? At[k * RP + k] : 0.f) + 1.0f);
    }
    for (int l0 = 0; l0 < L; ++l0) {
#pragma unroll
      for (int q0 = 0; q0 < Q; ++q0) {
        const int k = l0 * Q + q0;
        if (k >= r) break;
        float a[Q];
        load_rows<Q>(At + k * RP + ell * Q, a);
#pragma unroll
        for (int u = 0; u < C; ++u) {
          // every lane forms its own row's candidate; the owner's is taken
          const float hn = fmaxf(h[u][q0] - st[q0] * (g[u][q0] + alpha), 0.f);
          const float delta =
              __shfl_sync(0xffffffffu, hn - h[u][q0], group + l0);
          if (ell == l0) h[u][q0] = hn;
#pragma unroll
          for (int q = 0; q < Q; ++q) g[u][q] = fmaf(a[q], delta, g[u][q]);
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < C; ++u)
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int k = ell * Q + q;
      if (k < r && active[u]) H[(size_t)k * n + col[u]] = h[u][q];
    }
}

// The FISTA step inv_L = 1 / (1.02 lambda_max(A) + 1e-12), lambda_max the
// Rayleigh quotient after `iters` normalised power steps from the fixed
// start (_lambda_max). The 17 products A v are a sequential chain, so the
// kernel is latency, not work: one block of one thread per row (whole
// warps, up to STEP_MAX_THREADS), A copied into shared memory once
// (in_smem) with an odd row stride, so that a warp's threads, each on its
// own row, fall on distinct banks and a row's sum needs no shuffle. It is
// A v that is formed, row by row, as _lambda_max does: an A that is not
// exactly symmetric gives the plain version's step. Past
// STEP_SMEM_MAX_RANK A is read from device memory, one warp per row with
// its lanes along the row (consecutive loads). The fewer the
// warps, the cheaper the two barriers a step (one warp up to r = 32 needs
// none across warps). One warp taking four rows a lane from device memory
// took ~0.15 ms at r = 100. The sweep kernel that follows is let onto the
// card at once (programmatic dependent launch): it loads its tiles while
// the chain runs and waits for inv_L only before its first step.
constexpr int STEP_MAX_THREADS = 1024;
constexpr int STEP_SMEM_MAX_RANK = 192;  // r (r | 1) + 2 r floats in 227 KB

__global__ void __launch_bounds__(STEP_MAX_THREADS)
    fista_step_size_kernel(const float* __restrict__ A, int r, int iters,
                           int in_smem, float* __restrict__ inv_L) {
  extern __shared__ float smem[];
  float* v = smem;    // (r) the iterate
  float* w = v + r;   // (r) A v
  float* As = w + r;  // (r, RA) when in_smem
  const int t = threadIdx.x, lane = t & 31;
  const int RA = r | 1;
  asm volatile("griddepcontrol.launch_dependents;");
  for (int k = t; k < r; k += blockDim.x)
    v[k] = 0.5f + (float)((k * 40503) % 65536) / 65536.0f;
  if (in_smem)
    for (int x0 = t; x0 < r * r; x0 += 8 * blockDim.x) {
      float a[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        a[q] = x0 + q * blockDim.x < r * r ? A[x0 + q * blockDim.x] : 0.f;
      int row = x0 / r, col = x0 - row * r;  // one division per eight
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (x0 + q * blockDim.x < r * r) As[row * RA + col] = a[q];
        for (col += blockDim.x; col >= r; col -= r) ++row;
      }
    }
  __syncthreads();
  for (int it = 0;; ++it) {
    if (in_smem) {
      for (int k = t; k < r; k += blockDim.x) {
        const float* row = As + k * RA;
        float a[4] = {};
        int l = 0;
        for (; l + 4 <= r; l += 4)
#pragma unroll
          for (int q = 0; q < 4; ++q) a[q] = fmaf(row[l + q], v[l + q], a[q]);
        for (; l < r; ++l) a[0] = fmaf(row[l], v[l], a[0]);
        w[k] = (a[0] + a[1]) + (a[2] + a[3]);
      }
    } else {
      for (int k = t >> 5; k < r; k += blockDim.x >> 5) {
        const float* row = A + (size_t)k * r;
        float a = 0.f;
        for (int l = lane; l < r; l += 32) a = fmaf(__ldg(row + l), v[l], a);
        a = warp_sum(a);
        if (lane == 0) w[k] = a;
      }
    }
    __syncthreads();
    if (it == iters) break;
    float ss = 0.f;  // every warp sums the same terms in the same order
    for (int k = lane; k < r; k += 32) ss = fmaf(w[k], w[k], ss);
    const float nrm = fmaxf(sqrtf(warp_sum(ss)), 1e-30f);
    for (int k = t; k < r; k += blockDim.x) v[k] = w[k] / nrm;
    __syncthreads();
  }
  if (t < 32) {
    float q = 0.f, p = 0.f;
    for (int k = lane; k < r; k += 32) {
      q = fmaf(v[k], w[k], q);
      p = fmaf(v[k], v[k], p);
    }
    q = warp_sum(q);
    p = warp_sum(p);
    if (lane == 0) *inv_L = 1.f / (q / fmaxf(p, 1e-30f) * 1.02f + 1e-12f);
  }
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A transposed into (r, R4) rows (R4 = r rounded up to a multiple of 4,
// zero padded), bf16-rounded when kBf16: the layout the FISTA kernel reads.
// The wide FISTA kernel stages it from device memory; the tiled one builds
// the same table in shared memory itself.
template <bool kBf16>
__device__ __forceinline__ void fill_At(const float* __restrict__ A,
                                        float* At, int r, int begin,
                                        int step) {
  const int R4 = (r + 3) & ~3;
  for (int i = begin; i < r * R4; i += step) {
    const int j = i / R4, k = i % R4;
    const float a = k < r ? A[k * r + j] : 0.f;
    At[i] = kBf16 ? bf16_round(a) : a;
  }
}

template <bool kBf16>
__global__ void fista_prep_kernel(const float* __restrict__ A, int r,
                                  float* __restrict__ At) {
  fill_At<kBf16>(A, At, r, blockIdx.x * blockDim.x + threadIdx.x,
                 gridDim.x * blockDim.x);
}

// ---------------------------------------------------------------------------
// The shared-memory FISTA kernel, r <= FISTA_MAX_RANK (FISTA_STOP_MAX_RANK
// with the stop): fista_tiled_kernel.
//
// Replaces fista_sweeps (pallas/coder_kernel.py:579): on one tile of TN
// columns,
//   Hn = max(0, Y - inv_L (A Y - B + alpha)),  t' = (1 + sqrt(1 + 4 t^2)) / 2,
//   Y  = Hn + (t - 1) / t' (Hn - H),
// exactly sub_iter times, or with use_stopping until the tile meets the
// early-stop kernel's rule on the Grams of the step delta and of the old H
// (the tile is the unit of the stop and of the momentum, which stops with
// it; the step applies in the iteration that converges too). kBf16 rounds A
// and Y to bf16 before the multiply-add and accumulates in f32, each output
// summed over j in order. What bounds it: r^2 multiply-adds per column and
// iteration, and with the stop as many again for the two Grams, on the CUDA
// cores, fed by shared memory at a quarter of their rate: one thread per
// column took a shared load per four multiply-adds and ran a one-tile call
// on four warps. What the design does about it:
//   * The (r, TN) product A Y is formed by the whole block as a
//     register-tiled matrix product: a thread owns FT_ROWS = 4 rows by 8
//     columns of the output (columns 4 cb..4 cb + 3 and 64 more on, so that
//     a warp's float4 loads of a row of Y are consecutive), and each step
//     over j takes one float4 of A^T (a broadcast) and two of Y for 32
//     multiply-adds. The block has one thread per output block: 16 threads
//     per four rows (r = 25: 128 threads, r = 100: 416), so a one-tile call
//     fills an SM's schedulers.
//   * Y lives in shared memory row-major (the product's layout), H
//     transposed (TN, RS) so that a thread's four rows of a column are one
//     float4; B's entries of the thread's outputs stay in registers. One
//     barrier separates the product from the update of Y, one the update
//     from the next product. (Rotating the transposed tiles' four-row
//     blocks by column, so that a row block's 16 threads fall on distinct
//     banks, gained 4% at r = 25 and cost 50% at r = 100, where the kernel
//     has no registers to spare for the offsets: not kept.)
//   * The tile of H0 and A^T are loaded eight global loads in flight per
//     thread, after B's entries are on their way: at r = 25 a tile's ten
//     iterations are short enough that one load at a time took as long.
//   * With the stop, the step delta D = Hn - H is written, transposed, over
//     the spent Y, and both Grams Gd = D D^T and Gh = H H^T come from one
//     pass over 4 x 4 blocks of the upper triangle: per column two float4
//     of each tile feed 32 multiply-adds, a warp's lanes on neighbouring
//     blocks (distinct banks) or, where the blocks are fewer than the
//     threads, on up to four interleaved columns reduced by shuffles. The
//     row stride RS is a multiple of 4 with RS / 4 odd, so that
//     neighbouring columns fall on distinct banks. Hn stays in the
//     product's registers over the Grams.
//   * The decision (ft_stop_decision: es_stop_decision's logic and order)
//     gives each Gram half of the block's warps, one thread per row of a
//     power step's product, with block barriers between the steps: one
//     warp per Gram took four rows a lane, and in the band between the
//     certified bounds its 13 products were most of an iteration at
//     r = 100.
//   * The kernel is launched while the step-size kernel still runs and
//     waits for inv_L only before its first step (griddepcontrol.wait), so
//     the tile loads hide that kernel's latency chain.
//   * Shared memory: r R4 + 2 TN RS floats, and with the stop 2 r^2 + 6 r
//     more: 225 KB at r = 100, one block per SM.
constexpr int FT_ROWS = 4;
constexpr int FT_COLS = 8;
constexpr int FT_COL_GROUPS = TN / FT_COLS;  // threads per four rows
constexpr int FISTA_STOP_MAX_RANK = 100;

// Row stride of the transposed tiles: r rounded up to a multiple of 4 whose
// quarter is odd.
__host__ __device__ inline int ft_row_stride(int r) {
  const int R4 = (r + 3) & ~3;
  return (R4 >> 2) & 1 ? R4 : R4 + 4;
}

// One thread per 4 x 8 output block, in whole warps; at least the two
// warps of the stop decision.
__host__ __device__ inline int ft_threads(int r) {
  const int threads = (((r + 3) >> 2) * FT_COL_GROUPS + 31) / 32 * 32;
  return threads < 64 ? 64 : threads;
}

__host__ __device__ inline size_t ft_smem_floats(int r, int use_stopping) {
  size_t floats =
      (size_t)r * ((r + 3) & ~3) + 2 * (size_t)TN * ft_row_stride(r);
  if (use_stopping) floats += 2 * (size_t)r * r + 6 * (size_t)r;
  return floats;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float x, float y, float z,
                                    float w) {
  *reinterpret_cast<float4*>(p) = make_float4(x, y, z, w);
}

// Gd = D D^T and Gh = O O^T over the tile's TN columns from the transposed
// tiles Dt, Ot (TN, RS; rows past r hold 0).
// Upper-triangle 4 x 4 blocks; S neighbouring lanes (1, 2 or 4) sum columns
// s, s + S, ... of a block and reduce across each other; the first writes
// the block and its mirror.
template <int S>
__device__ void ft_tile_grams(const float* Dt, const float* Ot, float* Gd,
                              float* Gh, int r, int RS) {
  const int nb = (r + 3) >> 2, blocks = nb * (nb + 1) / 2;
  for (int base = 0; base < blocks * S; base += blockDim.x) {
    const int item = base + threadIdx.x;
    const bool valid = item < blocks * S;
    const int s = item % S;
    int kb = 0, rem = valid ? item / S : 0;
    while (rem >= nb - kb) { rem -= nb - kb; ++kb; }
    const int lb = kb + rem;
    float gd[4][4] = {}, gh[4][4] = {};
    if (valid) {
      const float* dk = Dt + 4 * kb;
      const float* dl = Dt + 4 * lb;
      const float* ok = Ot + 4 * kb;
      const float* ol = Ot + 4 * lb;
#pragma unroll 2
      for (int c = s; c < TN; c += S) {
        const float4 vdk = ld4(dk + c * RS), vdl = ld4(dl + c * RS);
        const float4 vok = ld4(ok + c * RS), vol = ld4(ol + c * RS);
        const float pk[4] = {vdk.x, vdk.y, vdk.z, vdk.w};
        const float pl[4] = {vdl.x, vdl.y, vdl.z, vdl.w};
        const float qk[4] = {vok.x, vok.y, vok.z, vok.w};
        const float ql[4] = {vol.x, vol.y, vol.z, vol.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            gd[a][b] = fmaf(pk[a], pl[b], gd[a][b]);
            gh[a][b] = fmaf(qk[a], ql[b], gh[a][b]);
          }
      }
    }
#pragma unroll
    for (int m = S >> 1; m > 0; m >>= 1)
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          gd[a][b] += __shfl_xor_sync(0xffffffffu, gd[a][b], m);
          gh[a][b] += __shfl_xor_sync(0xffffffffu, gh[a][b], m);
        }
    if (valid && s == 0)
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int k = 4 * kb + a, l = 4 * lb + b;
          if (k < r && l < r) {
            Gd[k * r + l] = gd[a][b];
            Gd[l * r + k] = gd[a][b];
            Gh[k * r + l] = gh[a][b];
            Gh[l * r + k] = gh[a][b];
          }
        }
  }
}

// w = G v for a symmetric (r, r) G of row stride gs, one thread per row
// (threads ti, ti + nth, ... of this Gram's half of the block); row k is
// read as column k, a warp's loads consecutive. With ab, the rows'
// absolute sums too.
__device__ __forceinline__ void ft_matvec(const float* G, const float* v,
                                          float* w, float* ab, int r, int gs,
                                          int ti, int nth) {
  for (int k = ti; k < r; k += nth) {
    float a[4] = {}, s[4] = {};
    int l = 0;
    for (; l + 4 <= r; l += 4)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float gv = G[(l + q) * gs + k];
        a[q] = fmaf(gv, v[l + q], a[q]);
        s[q] += fabsf(gv);
      }
    for (; l < r; ++l) {
      const float gv = G[l * gs + k];
      a[0] = fmaf(gv, v[l], a[0]);
      s[0] += fabsf(gv);
    }
    w[k] = (a[0] + a[1]) + (a[2] + a[3]);
    if (ab) ab[k] = (s[0] + s[1]) + (s[2] + s[3]);
  }
}

// v = w / max(|w|, 1e-30) on this Gram's threads; every warp sums the same
// terms in the same order.
__device__ __forceinline__ void ft_normalise(float* v, const float* w, int r,
                                             int ti, int nth) {
  float ss = 0.f;
  for (int k = threadIdx.x & 31; k < r; k += 32) ss = fmaf(w[k], w[k], ss);
  const float nrm = fmaxf(sqrtf(warp_sum(ss)), 1e-30f);
  for (int k = ti; k < r; k += nth) v[k] = w[k] / nrm;
}

// The Rayleigh quotient v . w / v . v (w = G v), by one warp.
__device__ __forceinline__ float ft_rayleigh(const float* v, const float* w,
                                             int r) {
  float q = 0.f, p = 0.f;
  for (int k = threadIdx.x & 31; k < r; k += 32) {
    q = fmaf(v[k], w[k], q);
    p = fmaf(v[k], v[k], p);
  }
  return warp_sum(q) / fmaxf(warp_sum(p), 1e-30f);
}

// es_stop_decision on the whole block: the lower half of the warps on Gd
// (vectors vd, wd, scratch ad), the upper on Gh (vh, wh, ah); the bounds
// meet in xch. The Grams' row stride is gs. Call after a barrier, from
// every thread of at least two warps; returns the same decision (1 =
// converged) in every thread.
__device__ int ft_stop_decision(const float* Gd, const float* Gh, float* vd,
                                float* vh, float* wd, float* wh, float* ad,
                                float* ah, float* xch, int r, int gs,
                                float stop2, int pi_iters) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nd = (int)(blockDim.x >> 6);  // warps on Gd
  const bool second = warp >= nd;
  const float* G = second ? Gh : Gd;
  float* v = second ? vh : vd;
  float* w = second ? wh : wd;
  float* ab = second ? ah : ad;
  const int wi = second ? warp - nd : warp;
  const int nth = 32 * (second ? (int)(blockDim.x >> 5) - nd : nd);
  const int ti = 32 * wi + lane;
  for (int k = ti; k < r; k += nth)
    v[k] += 0.05f * (0.5f + (float)((k * 40503) % 65536) / 65536.0f);
  __syncthreads();
  ft_matvec(G, v, w, ab, r, gs, ti, nth);
  __syncthreads();
  if (wi == 0) {  // min(trace, max absolute row sum)
    float tr = 0.f, rowmax = 0.f;
    for (int k = lane; k < r; k += 32) {
      tr += G[k * gs + k];
      rowmax = fmaxf(rowmax, ab[k]);
    }
    tr = warp_sum(tr);
    rowmax = warp_max(rowmax);
    if (lane == 0) xch[2 * second + 1] = fminf(tr, rowmax);
  }
  ft_normalise(v, w, r, ti, nth);
  __syncthreads();
  ft_matvec(G, v, w, nullptr, r, gs, ti, nth);
  __syncthreads();
  if (wi == 0) {
    const float lb = ft_rayleigh(v, w, r);
    if (lane == 0) xch[2 * second] = lb;
  }
  __syncthreads();
  const float lb_d = xch[0], ub_d = xch[1], lb_h = xch[2], ub_h = xch[3];
  const bool conv_certain = ub_d <= stop2 * lb_h;
  const bool notconv_certain = lb_d > stop2 * ub_h;
  if (conv_certain || notconv_certain) return conv_certain;
  // the band: pi_iters more steps from the vectors as they stand (w = G v)
  __syncthreads();  // every thread has read xch
  for (int it = 0; it < pi_iters; ++it) {
    ft_normalise(v, w, r, ti, nth);
    __syncthreads();
    ft_matvec(G, v, w, nullptr, r, gs, ti, nth);
    __syncthreads();
  }
  if (wi == 0) {
    const float lam = ft_rayleigh(v, w, r);
    if (lane == 0) xch[second] = lam;
  }
  __syncthreads();
  return xch[0] <= stop2 * xch[1];
}

template <bool kBf16>
__global__ void __launch_bounds__(512)
    fista_tiled_kernel(const float* __restrict__ A,
                       const float* __restrict__ B,
                       const float* __restrict__ H0, float* __restrict__ H,
                       int r, int n, float alpha, const float* inv_L_ptr,
                       float stop, int sub_iter, int use_stopping,
                       int pi_iters) {
  count_run(RUN_FISTA);
  count_columns(FISTA_COLUMNS, n);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int R4 = (r + 3) & ~3, RS = ft_row_stride(r), nb = R4 >> 2;
  float* At = smem;           // (r, R4): At[j * R4 + k] = A[k, j]; 0 past r
  float* Ys = At + r * R4;    // (R4, TN) extrapolated point, row-major;
                              // during the stop test Dt (TN, RS), the delta
  float* Ht = Ys + TN * RS;   // (TN, RS) iterate, transposed
  float* Gd = Ht + TN * RS;   // stop mode only: (r, r) delta Gram,
  float* Gh = Gd + r * r;     // (r, r) iterate Gram,
  float* vd = Gh + r * r;     // carried eigenvector estimates
  float* vh = vd + r;
  float* wd = vh + r;         // and the power steps' products
  float* wh = wd + r;
  float* ad = wh + r;         // and absolute row sums
  float* ah = ad + r;
  __shared__ float xch[4];

  const int t = threadIdx.x;
  const size_t tile0 = (size_t)blockIdx.x * TN;
  // this thread's outputs: rows k0..k0 + 3 of columns cbase + 64 h + i
  const bool live = t < nb * FT_COL_GROUPS;
  const int k0 = FT_ROWS * (t / FT_COL_GROUPS);
  const int cbase = 4 * (t % FT_COL_GROUPS);
  // which of them lie in the batch: rows k0..k0 + nrow - 1, columns by bit
  const int nrow = live ? min(FT_ROWS, r - k0) : 0;
  unsigned cmask = 0;
#pragma unroll
  for (int e = 0; e < FT_COLS; ++e)
    if (tile0 + cbase + 64 * (e >> 2) + (e & 3) < (size_t)n) cmask |= 1u << e;
  // B at the outputs. Outside the batch (rows past r, columns past n) it
  // is -inf: there Y and A Y are 0, so the step max(0, Y - inv_L (A Y - B
  // + alpha)) gives max(0, -inf) = 0 without a mask, whatever alpha
  float bb[FT_ROWS][FT_COLS];
#pragma unroll
  for (int a = 0; a < FT_ROWS; ++a)
#pragma unroll
    for (int e = 0; e < FT_COLS; ++e) {
      const size_t cl = tile0 + cbase + 64 * (e >> 2) + (e & 3);
      bb[a][e] = a < nrow && (cmask >> e & 1)
          ? __ldg(B + (size_t)(k0 + a) * n + cl)
          : __int_as_float(0xff800000);  // -inf
    }
  // A^T and the tile of H0, eight global loads in flight per thread
  for (int x0 = t; x0 < r * R4; x0 += 8 * blockDim.x) {
    float v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int x = x0 + q * blockDim.x, j = x / R4, k = x % R4;
      v[q] = x < r * R4 && k < r ? A[k * r + j] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (x0 + q * blockDim.x < r * R4)
        At[x0 + q * blockDim.x] = kBf16 ? bf16_round(v[q]) : v[q];
  }
  for (int x0 = t; x0 < R4 * TN; x0 += 8 * blockDim.x) {
    float v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int x = x0 + q * blockDim.x, k = x / TN, c = x % TN;
      v[q] = x < R4 * TN && k < r && tile0 + c < (size_t)n
          ? H0[(size_t)k * n + tile0 + c] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int x = x0 + q * blockDim.x, k = x / TN, c = x % TN;
      if (x < R4 * TN) {
        Ys[x] = v[q];
        Ht[c * RS + k] = v[q];
      }
    }
  }
  if (use_stopping)
    for (int k = t; k < r; k += blockDim.x)
      vd[k] = vh[k] = 0.5f + (float)((k * 40503) % 65536) / 65536.0f;
  // the step-size kernel may still be running (programmatic dependent
  // launch): wait for it, and for its inv_L, only now
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const float inv_L = *reinterpret_cast<const volatile float*>(inv_L_ptr);
  const float stop2 = stop * stop;
  float tmom = 1.f;
  __syncthreads();

  int swept = sub_iter;
  for (int it = 0; it < sub_iter; ++it) {
    const float tn = 0.5f * (1.f + sqrtf(1.f + 4.f * tmom * tmom));
    const float mom = (tmom - 1.f) / tn;
    tmom = tn;
    float acc[FT_ROWS][FT_COLS] = {};
    if (live) {
#pragma unroll 4
      for (int j = 0; j < r; ++j) {
        const float4 av = ld4(At + j * R4 + k0);
        const float4 y0 = ld4(Ys + j * TN + cbase);
        const float4 y1 = ld4(Ys + j * TN + cbase + 64);
        const float a4[4] = {av.x, av.y, av.z, av.w};
        float y[FT_COLS] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
        if constexpr (kBf16) {
#pragma unroll
          for (int e = 0; e < FT_COLS; ++e) y[e] = bf16_round(y[e]);
        }
#pragma unroll
        for (int a = 0; a < FT_ROWS; ++a)
#pragma unroll
          for (int e = 0; e < FT_COLS; ++e)
            acc[a][e] = fmaf(a4[a], y[e], acc[a][e]);
      }
      // the new iterate, in the product's registers
#pragma unroll
      for (int a = 0; a < FT_ROWS; ++a) {
        const float4 y0 = ld4(Ys + (k0 + a) * TN + cbase);
        const float4 y1 = ld4(Ys + (k0 + a) * TN + cbase + 64);
        const float y[FT_COLS] = {y0.x, y0.y, y0.z, y0.w,
                                  y1.x, y1.y, y1.z, y1.w};
#pragma unroll
        for (int e = 0; e < FT_COLS; ++e)
          acc[a][e] =
              fmaxf(y[e] - inv_L * (acc[a][e] - bb[a][e] + alpha), 0.f);
      }
    }
    __syncthreads();  // every product has read Y
    int cv = 0;
    if (use_stopping) {
      if (live) {
#pragma unroll
        for (int e = 0; e < FT_COLS; ++e) {
          const int c = cbase + 64 * (e >> 2) + (e & 3);
          const float4 h = ld4(Ht + c * RS + k0);
          st4(Ys + c * RS + k0, acc[0][e] - h.x, acc[1][e] - h.y,
              acc[2][e] - h.z, acc[3][e] - h.w);
        }
      }
      __syncthreads();
      // as many lanes per block of the Grams as the threads allow
      const int blocks = nb * (nb + 1) / 2;
      if (4 * blocks <= (int)blockDim.x)
        ft_tile_grams<4>(Ys, Ht, Gd, Gh, r, RS);
      else if (2 * blocks <= (int)blockDim.x)
        ft_tile_grams<2>(Ys, Ht, Gd, Gh, r, RS);
      else
        ft_tile_grams<1>(Ys, Ht, Gd, Gh, r, RS);
      __syncthreads();
      cv = ft_stop_decision(Gd, Gh, vd, vh, wd, wh, ad, ah, xch, r, r, stop2,
                            pi_iters);
    }
    // H = Hn, Y = Hn + mom (Hn - H): in the iteration that converges too
    if (live) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float yn[FT_ROWS][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = 4 * half + i, c = cbase + 64 * half + i;
          const float4 h = ld4(Ht + c * RS + k0);
          yn[0][i] = acc[0][e] + mom * (acc[0][e] - h.x);
          yn[1][i] = acc[1][e] + mom * (acc[1][e] - h.y);
          yn[2][i] = acc[2][e] + mom * (acc[2][e] - h.z);
          yn[3][i] = acc[3][e] + mom * (acc[3][e] - h.w);
          st4(Ht + c * RS + k0, acc[0][e], acc[1][e], acc[2][e], acc[3][e]);
        }
#pragma unroll
        for (int a = 0; a < FT_ROWS; ++a)
          st4(Ys + (k0 + a) * TN + cbase + 64 * half, yn[a][0], yn[a][1],
              yn[a][2], yn[a][3]);
      }
    }
    __syncthreads();
    if (cv) {  // the same in every thread
      swept = it + 1;
      break;
    }
  }
  count_sweeps(FISTA_COLUMN_ITERS, swept, tile0, n);
  for (int x = t; x < r * TN; x += blockDim.x) {
    const int k = x / TN, c = x % TN;
    if (tile0 + c < (size_t)n) H[(size_t)k * n + tile0 + c] = Ht[c * RS + k];
  }
}

// ---------------------------------------------------------------------------
// The wide FISTA kernel, past the shared-memory kernel's ranks (r > 128, or
// r > 100 with the stop) up to the JAX kernels' 1248: fista_wide_kernel.
//
// Replaces fista_sweeps (pallas/coder_kernel.py:579) at those ranks with
// fista_tiled_kernel's function: the tile of TN columns, the per-tile
// momentum and stop, the step applied in the iteration that converges,
// each output of A Y summed over j in order (A and Y bf16-rounded first
// with kBf16). What bounds it: r^2 multiply-adds per column and iteration,
// and with the stop as many again for the two Grams, on the CUDA cores: at
// r = 256, n = 131,109 and ten iterations 2.6 ms at 67e12/s, against
// 0.12 ms for its bytes. Neither A (256 KB at r = 256) nor the tiles fit
// one SM's shared memory with A's table beside them. One thread per column
// with A read through L1/L2 (fista_ws_kernel) took one L1 load per four
// multiply-adds, kept H, Y and the new columns in a workspace of eight
// slices per SM (~415 MB at r = 256, so Y's loads went to device memory)
// and decided the stop on one warp: 4.5% of the bound. What the design
// does about it:
//   * One block per tile, one block per SM, the grid (one block per SM)
//     striding over the tiles, so the workspace is one slice per SM and
//     stays in L2 (34 MB at r = 256).
//   * The product is fista_tiled_kernel's register tiling: a thread owns
//     4 rows x 8 columns of A Y and each step over j takes one float4 of
//     A^T (a broadcast) and two of Y for 32 multiply-adds. The block's
//     threads cover at most FW_ROW_BLOCKS row blocks (128 rows); the rest
//     of the rows are further passes over the same Y. A^T comes from the
//     table fista_prep_kernel writes to the head of the workspace, in
//     chunks of FW_CHUNK rows j and the pass's rows k, staged into shared
//     memory by cp.async, two buffers, so the next chunk's copy overlaps
//     this one's multiply-adds. Each output is still summed over j in
//     order, across chunks, in one accumulator.
//   * Two regimes from r alone (fw_config): up to FW_RESIDENT_MAX_RANK the
//     tile of Y lives in shared memory ("resident", 192 KB at r = 384);
//     past it Y lives in the workspace slice and each chunk of A^T comes
//     with its FW_CHUNK rows of Y ("streamed").
//   * A pass writes its new columns Hn to the workspace slice (each thread
//     its own outputs), so Y stays whole until every pass has read it; one
//     barrier, then H = Hn and Y = Hn + mom (Hn - H) element by element.
//   * With the stop (a kernel of its own, kStop, so that the fixed
//     iterations do not carry the Grams' registers), the Grams Gd = D D^T
//     (D = Hn - H) and Gh = H H^T come from register blocks of their upper
//     triangles over the tile staged transposed in shared memory (over Y
//     and the chunk buffers, free between the product and the update), in
//     column chunks of gram_cols columns, each entry summed over the
//     columns in order and carried from chunk to chunk. The blocks are
//     4 x 4 (two float4 loads a column for 16 multiply-adds) or, where
//     those would take the threads more than two rounds, 8 x 8 (four for
//     64); a block and its mirror are stored as float4 row segments (4 x 4
//     blocks and scalar stores, the mirror's each to a sector of its own,
//     took twice as long a call at r = 512 on an H100).
//     The decision is fista_tiled_kernel's (ft_stop_decision: each Gram's
//     power steps on half of the block's warps, one thread per row). Up to
//     r = 136 the Grams and the power vectors fit shared memory beside the
//     staged tile and stay there; past it they go to the slice, and the
//     decision's power steps read them from L2 or device memory.
//   * The loops over a tile in device memory (H0's tile, the staging of
//     the Grams' tiles, the update, the store) keep eight loads in flight
//     a thread: one at a time, each waited for its latency.
//   * The kernel is launched while the step-size kernel still runs and
//     waits for inv_L before its first step (griddepcontrol.wait).
constexpr int FW_MAX_THREADS = 512;
constexpr int FW_ROW_BLOCKS = FW_MAX_THREADS / FT_COL_GROUPS;  // 32 a pass
constexpr int FW_CHUNK = 32;               // rows j of a staged chunk
constexpr int FW_RESIDENT_MAX_RANK = 384;  // Y in shared memory up to here
constexpr int FW_SMEM_FLOATS = 57344;      // 224 KB: r = 384's Y and chunks

// The wide kernel's shape at rank r, from r and the mode alone (twin:
// coder_kernel.fista_wide_config): Y resident or streamed, threads (16
// per row block of a pass, in whole warps), passes over the row blocks,
// rows a pass; with the stop, the side of the Grams' register blocks (4,
// or 8 where 4 x 4 blocks would take the block's threads more than two
// rounds), the Grams' rows and row stride (r to a multiple of the block
// side), the transposed tile's row stride (at least that, with an odd
// quarter), the columns of a Gram chunk (the largest power of two up to TN
// whose transposed tile fits FW_SMEM_FLOATS), whether the Grams and the
// power vectors fit shared memory beside a Gram chunk (fw_vec_floats
// floats of vectors first, then the Grams); and the shared floats.
struct FwConfig {
  int resident, threads, passes, rows, gram_block, gram_rows, gram_stride,
      gram_cols, gram_smem;
  size_t smem_floats;
};

__host__ __device__ inline size_t fw_vec_floats(int r) {
  return (6 * (size_t)r + 3) & ~(size_t)3;
}

__host__ __device__ inline FwConfig fw_config(int r, int use_stopping) {
  FwConfig c;
  const int nb = (r + 3) >> 2;
  c.passes = (nb + FW_ROW_BLOCKS - 1) / FW_ROW_BLOCKS;
  const int rb = (nb + c.passes - 1) / c.passes;
  c.rows = 4 * rb;
  c.threads = (rb * FT_COL_GROUPS + 31) / 32 * 32;
  c.resident = r <= FW_RESIDENT_MAX_RANK;
  const size_t product = 2 * (size_t)FW_CHUNK * (c.rows + (c.resident ? 0 : TN))
                         + (c.resident ? (size_t)r * TN : 0);
  c.gram_block = nb * (nb + 1) / 2 > 2 * c.threads ? 8 : 4;
  c.gram_rows = (r + c.gram_block - 1) / c.gram_block * c.gram_block;
  c.gram_stride = (c.gram_rows >> 2) & 1 ? c.gram_rows : c.gram_rows + 4;
  c.gram_cols = TN;
  while (c.gram_cols > 1
         && (size_t)c.gram_cols * c.gram_stride > FW_SMEM_FLOATS)
    c.gram_cols >>= 1;
  const size_t staged = (size_t)c.gram_cols * c.gram_stride;
  const size_t grams = 2 * (size_t)c.gram_rows * c.gram_rows;
  c.gram_smem = use_stopping
      && fw_vec_floats(r) + grams + staged <= FW_SMEM_FLOATS;
  c.smem_floats = product;
  if (c.gram_smem) {
    c.smem_floats = fw_vec_floats(r)
                    + (product > grams + staged ? product : grams + staged);
  } else if (use_stopping && staged > product) {
    c.smem_floats = staged;
  }
  return c;
}

// The FISTA workspace: the (r, R4) table of A^T first, then one slice per
// block: H and the new columns (and streamed, Y) as (r, TN) tiles, and
// with the stop, where they do not fit shared memory, both Grams and six
// r-vectors; a slice is a whole number of 128-byte lines.
__host__ __device__ inline size_t fista_head_floats(int r) {
  return (size_t)r * ((r + 3) & ~3);
}

__host__ __device__ inline size_t fw_slice_floats(int r, int use_stopping) {
  size_t floats = (r <= FW_RESIDENT_MAX_RANK ? 2 : 3) * (size_t)r * TN;
  const FwConfig c = fw_config(r, use_stopping);
  if (use_stopping && !c.gram_smem)
    floats += 2 * (size_t)c.gram_rows * c.gram_rows + fw_vec_floats(r);
  return (floats + 31) & ~(size_t)31;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool copy) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  // src-size 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(copy ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage chunk j0..j0 + FW_CHUNK - 1 of A^T's rows, columns kp..kp + P - 1
// (as (FW_CHUNK, P)), and when streamed the same rows of Y (as
// (FW_CHUNK, TN)), into shared memory: one commit group.
template <bool kRes>
__device__ __forceinline__ void fw_stage(float* Ab, float* Yb,
                                         const float* At, const float* Yw,
                                         int r, int R4, int P, int j0,
                                         int kp) {
  const int q4 = P >> 2;
  for (int s = threadIdx.x; s < FW_CHUNK * q4; s += blockDim.x) {
    const int jj = s / q4, q = s - jj * q4;
    const int j = j0 + jj, k = kp + 4 * q;
    const bool ok = j < r && k < R4;
    cp_async16(Ab + jj * P + 4 * q, ok ? At + (size_t)j * R4 + k : At, ok);
  }
  if (!kRes)
    for (int s = threadIdx.x; s < FW_CHUNK * (TN / 4); s += blockDim.x) {
      const int jj = s / (TN / 4), q = s % (TN / 4);
      const int j = j0 + jj;
      cp_async16(Yb + jj * TN + 4 * q, j < r ? Yw + (size_t)j * TN + 4 * q : Yw,
                 j < r);
    }
  cp_async_commit();
}

// One column chunk of M M^T into G (gram_rows rows of stride gs): the
// upper triangle's S x S blocks over the block's threads, each summed over
// the chunk's `cols` columns of the transposed tile Mt (cols, RS; rows
// past r hold 0) in order, from the sums of the chunks before (carry) or
// from 0, and written with its mirror, a float4 a row segment. (An 8 x 8
// block summed as two 4 x 8 halves, 32 accumulators in place of 64 and
// three float4 loads a column for 32 multiply-adds, was slower at r = 256
// and 512 on an H100.)
template <int S>
__device__ void fw_gram_chunk(const float* Mt, float* G, int r, int RS,
                              int gs, int cols, bool carry) {
  const int nb = (r + S - 1) / S, blocks = nb * (nb + 1) / 2;
  int kb = 0, rem = threadIdx.x;  // item = (kb, lb), lb = kb + rem
  for (int item = threadIdx.x; item < blocks;
       item += blockDim.x, rem += blockDim.x) {
    while (rem >= nb - kb) {
      rem -= nb - kb;
      ++kb;
    }
    const int lb = kb + rem;
    float* gk = G + (size_t)S * kb * gs + S * lb;  // the block's first row
    float g[S][S];
#pragma unroll
    for (int a = 0; a < S; ++a)
#pragma unroll
      for (int q = 0; q < S; q += 4) {
        const float4 v = carry ? ld4(gk + (size_t)a * gs + q)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
        g[a][q] = v.x;
        g[a][q + 1] = v.y;
        g[a][q + 2] = v.z;
        g[a][q + 3] = v.w;
      }
    const float* mk = Mt + S * kb;
    const float* ml = Mt + S * lb;
#pragma unroll 2
    for (int c = 0; c < cols; ++c) {
      float pk[S], pl[S];
#pragma unroll
      for (int q = 0; q < S; q += 4) {
        const float4 vk = ld4(mk + c * RS + q), vl = ld4(ml + c * RS + q);
        pk[q] = vk.x, pk[q + 1] = vk.y, pk[q + 2] = vk.z, pk[q + 3] = vk.w;
        pl[q] = vl.x, pl[q + 1] = vl.y, pl[q + 2] = vl.z, pl[q + 3] = vl.w;
      }
#pragma unroll
      for (int a = 0; a < S; ++a)
#pragma unroll
        for (int b = 0; b < S; ++b) g[a][b] = fmaf(pk[a], pl[b], g[a][b]);
    }
#pragma unroll
    for (int a = 0; a < S; ++a)
#pragma unroll
      for (int q = 0; q < S; q += 4)
        st4(gk + (size_t)a * gs + q, g[a][q], g[a][q + 1], g[a][q + 2],
            g[a][q + 3]);
    if (kb != lb) {  // the mirror block; a diagonal block is whole already
      float* gl = G + (size_t)S * lb * gs + S * kb;
#pragma unroll
      for (int b = 0; b < S; ++b)
#pragma unroll
        for (int q = 0; q < S; q += 4)
          st4(gl + (size_t)b * gs + q, g[q][b], g[q + 1][b], g[q + 2][b],
              g[q + 3][b]);
    }
  }
}

// Both Grams of a tile held row-major (r, TN) in device memory: Gd = D D^T
// with D = X - O and Gh = O O^T (O the iterate before the step, X after
// it), each staged transposed into Mt in column chunks of TC columns
// (eight loads in flight a thread; rows r..RG-1 hold 0) and summed by
// fw_gram_chunk in S x S blocks (S = gram_block). The wide kernels' Grams;
// call from every thread, after a barrier.
__device__ void wide_tile_grams(const float* O, const float* X, float* Mt,
                                float* Gd, float* Gh, int r, int RG, int MS,
                                int TC, int gram_block) {
  const int tc_shift = __ffs(TC) - 1;
  for (int gi = 0; gi < 2; ++gi) {
    for (int c0 = 0; c0 < TN; c0 += TC) {
      for (int x0 = threadIdx.x; x0 < RG * TC; x0 += 8 * blockDim.x) {
        float v[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int x = x0 + q * blockDim.x;
          const int k = x >> tc_shift, cc = x & (TC - 1);
          v[q] = 0.f;
          if (x < RG * TC && k < r) {
            const float h = O[(size_t)k * TN + c0 + cc];
            v[q] = gi ? h : X[(size_t)k * TN + c0 + cc] - h;
          }
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int x = x0 + q * blockDim.x;
          if (x < RG * TC) Mt[(x & (TC - 1)) * MS + (x >> tc_shift)] = v[q];
        }
      }
      __syncthreads();
      if (gram_block == 8)
        fw_gram_chunk<8>(Mt, gi ? Gh : Gd, r, MS, RG, TC, c0 > 0);
      else
        fw_gram_chunk<4>(Mt, gi ? Gh : Gd, r, MS, RG, TC, c0 > 0);
      __syncthreads();
    }
  }
}

// kStop: with the stop (a kernel of its own, so that the fixed-iteration
// kernels keep the Grams' registers out of the product's).
template <bool kBf16, bool kRes, bool kStop>
__global__ void __launch_bounds__(FW_MAX_THREADS, 1)
    fista_wide_kernel(const float* __restrict__ B,
                      const float* __restrict__ H0, float* __restrict__ H,
                      int r, int n, float alpha, const float* inv_L_ptr,
                      float stop, int sub_iter, int pi_iters,
                      float* __restrict__ ws) {
  count_run(RUN_FISTA);
  count_columns(FISTA_COLUMNS, n);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int use_stopping = kStop;
  const FwConfig cfg = fw_config(r, use_stopping);
  const int R4 = (r + 3) & ~3, nb = R4 >> 2;
  const int P = cfg.rows, TC = cfg.gram_cols;
  // a Gram's rows and row stride; the transposed tile chunk's row stride
  const int RG = cfg.gram_rows, MS = cfg.gram_stride;
  const int nchunks = (r + FW_CHUNK - 1) / FW_CHUNK;
  const float* At = ws;  // (r, R4): At[j * R4 + k] = A[k, j]; 0 past r
  float* Hs = ws + fista_head_floats(r)
              + (size_t)blockIdx.x * fw_slice_floats(r, use_stopping);
  float* Xs = Hs + (size_t)r * TN;  // (r, TN) the new columns Hn
  float* Yw = Xs + (size_t)r * TN;  // streamed: (r, TN) Y
  // shared: with the Grams in shared memory, the six power vectors first;
  // then resident, Y (r, TN) and two (FW_CHUNK, P) chunks of A^T, or
  // streamed, two chunks of A^T and two (FW_CHUNK, TN) of Y; with the stop
  // (between the product and the update) over them the Grams, where they
  // fit, and the transposed tile chunk (TC, MS)
  float* sm = smem + (cfg.gram_smem ? fw_vec_floats(r) : 0);
  float* Y = kRes ? sm : Yw;
  float* Abuf = kRes ? sm + (size_t)r * TN : sm;
  float* Ybuf = Abuf + 2 * FW_CHUNK * P;
  float* Gd = cfg.gram_smem ? sm : Xs + (size_t)(kRes ? 1 : 2) * r * TN;
  float* Gh = Gd + (size_t)RG * RG;  // (RG, RG) Grams, row stride RG
  float* vd = cfg.gram_smem ? smem : Gh + (size_t)RG * RG;
  float* vh = vd + r;              // carried eigenvector estimates,
  float* wd = vh + r;              // the power steps' products
  float* wh = wd + r;
  float* ad = wh + r;              // and absolute row sums
  float* ah = ad + r;
  float* Mt = cfg.gram_smem ? sm + 2 * (size_t)RG * RG : sm;
  __shared__ float xch[4];

  const int t = threadIdx.x;
  const int rbl = t / FT_COL_GROUPS;  // this thread's row block in a pass
  const int cbase = 4 * (t % FT_COL_GROUPS);
  const float stop2 = stop * stop;
  float inv_L = 0.f;
  const int tiles = (n + TN - 1) / TN;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const size_t tile0 = (size_t)tile * TN;
    // the tile of H0, eight loads in flight a thread
    for (int x0 = t; x0 < r * TN; x0 += 8 * blockDim.x) {
      float h[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int x = x0 + q * blockDim.x, c = x % TN;
        h[q] = x < r * TN && tile0 + c < (size_t)n
            ? H0[(size_t)(x / TN) * n + tile0 + c] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int x = x0 + q * blockDim.x;
        if (x < r * TN) {
          Hs[x] = h[q];
          Y[x] = h[q];
        }
      }
    }
    if (kStop)
      for (int k = t; k < r; k += blockDim.x)
        vd[k] = vh[k] = 0.5f + (float)((k * 40503) % 65536) / 65536.0f;
    if (tile == (int)blockIdx.x) {
      // the step-size kernel may still be running (programmatic dependent
      // launch): wait for it, and for its inv_L, only now
      asm volatile("griddepcontrol.wait;" ::: "memory");
      inv_L = *reinterpret_cast<const volatile float*>(inv_L_ptr);
    }
    float tmom = 1.f;
    __syncthreads();

    int swept = sub_iter;
    for (int it = 0; it < sub_iter; ++it) {
      const float tn = 0.5f * (1.f + sqrtf(1.f + 4.f * tmom * tmom));
      const float mom = (tmom - 1.f) / tn;
      tmom = tn;
      for (int p = 0; p < cfg.passes; ++p) {
        const int kp = p * P, kb = (kp >> 2) + rbl;
        const bool live = 4 * rbl < P && kb < nb;
        float acc[FT_ROWS][FT_COLS] = {};
        fw_stage<kRes>(Abuf, Ybuf, At, Yw, r, R4, P, 0, kp);
        for (int ch = 0; ch < nchunks; ++ch) {
          const int buf = ch & 1;
          if (ch + 1 < nchunks) {
            fw_stage<kRes>(Abuf + (buf ^ 1) * FW_CHUNK * P,
                           Ybuf + (buf ^ 1) * FW_CHUNK * TN, At, Yw, r, R4, P,
                           (ch + 1) * FW_CHUNK, kp);
            cp_async_wait<1>();
          } else {
            cp_async_wait<0>();
          }
          __syncthreads();  // the chunk is in
          const float* Ab = Abuf + buf * FW_CHUNK * P + 4 * rbl;
          const float* Yc = kRes ? Y + (size_t)ch * FW_CHUNK * TN
                                 : Ybuf + buf * FW_CHUNK * TN;
          const int jn = min(FW_CHUNK, r - ch * FW_CHUNK);
          if (live) {
#pragma unroll 4
            for (int jj = 0; jj < jn; ++jj) {
              const float4 av = ld4(Ab + jj * P);
              const float4 y0 = ld4(Yc + jj * TN + cbase);
              const float4 y1 = ld4(Yc + jj * TN + cbase + 64);
              const float a4[4] = {av.x, av.y, av.z, av.w};
              float y[FT_COLS] = {y0.x, y0.y, y0.z, y0.w,
                                  y1.x, y1.y, y1.z, y1.w};
              if constexpr (kBf16) {
#pragma unroll
                for (int e = 0; e < FT_COLS; ++e) y[e] = bf16_round(y[e]);
              }
#pragma unroll
              for (int a = 0; a < FT_ROWS; ++a)
#pragma unroll
                for (int e = 0; e < FT_COLS; ++e)
                  acc[a][e] = fmaf(a4[a], y[e], acc[a][e]);
            }
          }
          __syncthreads();  // the buffer is refilled two chunks on
        }
        if (live) {
          // this pass's new columns; zero outside the batch
#pragma unroll
          for (int a = 0; a < FT_ROWS; ++a) {
            const int k = 4 * kb + a;
            if (k >= r) break;
            const float4 y0 = ld4(Y + (size_t)k * TN + cbase);
            const float4 y1 = ld4(Y + (size_t)k * TN + cbase + 64);
            const float y[FT_COLS] = {y0.x, y0.y, y0.z, y0.w,
                                      y1.x, y1.y, y1.z, y1.w};
            float hn[FT_COLS];
#pragma unroll
            for (int e = 0; e < FT_COLS; ++e) {
              const size_t cl = tile0 + cbase + 64 * (e >> 2) + (e & 3);
              hn[e] = cl < (size_t)n
                  ? fmaxf(y[e] - inv_L * (acc[a][e]
                                          - __ldg(B + (size_t)k * n + cl)
                                          + alpha), 0.f)
                  : 0.f;
            }
            st4(Xs + (size_t)k * TN + cbase, hn[0], hn[1], hn[2], hn[3]);
            st4(Xs + (size_t)k * TN + cbase + 64, hn[4], hn[5], hn[6],
                hn[7]);
          }
        }
      }
      __syncthreads();  // every new column is in; Y has been read
      int cv = 0;
      if constexpr (kStop) {
        wide_tile_grams(Hs, Xs, Mt, Gd, Gh, r, RG, MS, TC, cfg.gram_block);
        cv = ft_stop_decision(Gd, Gh, vd, vh, wd, wh, ad, ah, xch, r, RG,
                              stop2, pi_iters);
      }
      // H = Hn, Y = Hn + mom (Hn - H): in the iteration that converges
      // too; four float4 loads of each tile in flight a thread
      for (int x0 = 4 * t; x0 < r * TN; x0 += 16 * blockDim.x) {
        float4 hn[4], h[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int x = x0 + 4 * q * blockDim.x;
          if (x < r * TN) {
            hn[q] = ld4(Xs + x);
            h[q] = ld4(Hs + x);
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int x = x0 + 4 * q * blockDim.x;
          if (x < r * TN) {
            st4(Hs + x, hn[q].x, hn[q].y, hn[q].z, hn[q].w);
            st4(Y + x, hn[q].x + mom * (hn[q].x - h[q].x),
                hn[q].y + mom * (hn[q].y - h[q].y),
                hn[q].z + mom * (hn[q].z - h[q].z),
                hn[q].w + mom * (hn[q].w - h[q].w));
          }
        }
      }
      __syncthreads();
      if (cv) {  // the same in every thread
        swept = it + 1;
        break;
      }
    }
    count_sweeps(FISTA_COLUMN_ITERS, swept, tile0, n);
    for (int x0 = t; x0 < r * TN; x0 += 8 * blockDim.x) {
      float h[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int x = x0 + q * blockDim.x;
        h[q] = x < r * TN ? Hs[x] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int x = x0 + q * blockDim.x, c = x % TN;
        if (x < r * TN && tile0 + c < (size_t)n)
          H[(size_t)(x / TN) * n + tile0 + c] = h[q];
      }
    }
    __syncthreads();  // the tiles are reused by the next tile
  }
}

// ---------------------------------------------------------------------------
// The wide Gauss-Seidel coder, past the shared-memory kernels' ranks (r > 100
// with the stop, r > 128 without) up to the JAX kernels' 1248:
// coder_wide_kernel.
//
// Replaces coder_sweeps_earlystop (pallas/coder_kernel.py:455, its kernel
// _coder_es_kernel :400) at those ranks with coder_es_lanes_kernel's
// function: the tile of TN columns, the step 1 / sqrt(i + 10) / (A_kk + 1),
// the certified bounds first and pi_iters warm power steps only in the band,
// the vectors carried from sweep to sweep, a converged tile left as it is;
// without the stop (kStop false), coder_sweeps (:192) past r = 128. What
// bounds it: a sweep is r^2 multiply-adds a column and the two Grams as many
// again, on the CUDA cores (r = 256, n = 131,109, ten sweeps: 5.1 ms at
// 67e12/s, against 0.16 ms for its bytes); and within a column the r
// coordinate steps of a sweep are a dependent chain. Neither A (256 KB at
// r = 256) nor the tile (128 KB) fits an SM beside the other. What the
// design does:
//   * The sweep in direct form, the plain version's own: at coordinate k,
//     g = A[k, :] h - b_k + alpha, then h_k = max(0, h_k - step_k g). L lanes
//     share a column (8 up to r = 256, 16 up to 512, 32 past it), each
//     holding C = 2 columns' rows 4 (ell + L m) + s (float4 slot m of
//     lane ell) in registers; each lane sums its slots into four
//     accumulators (one per float4 component), adds them as
//     (a0 + a1) + (a2 + a3), and a butterfly of log2 L shuffles gives every
//     lane the whole dot product; the lane that holds row k takes the step.
//     Each float4 of A's row (the lanes of a group on consecutive float4s,
//     every group of the warp on the same ones: no bank conflict) feeds
//     eight multiply-adds. The residual form of coder_es_lanes_kernel (g
//     carried in registers, one shuffle a step) needs g formed anew every
//     sweep, 2 r^2 multiply-adds a column, and its float32 rank-1 updates
//     put it 1.3e-5 (r = 256) and 3.9e-5 (r = 512) from the plain version
//     after ten sweeps on the smoke's inputs in a host emulation, where the
//     direct form stays within 7e-7 (the plain version is 7e-7 from float64
//     itself).
//   * A's rows are needed in step order: a table of A with rows zero-padded
//     to 4 L slots columns (coder_wide_prep_kernel, at the head of the
//     workspace) is staged by cp.async in chunks of CW_CHUNK rows into two
//     buffers, with the same rows of B's columns beside them, so that the
//     next chunk's copy overlaps this one's steps.
//   * One block of CW_THREADS per tile and SM, the grid striding over the
//     tiles, one workspace slice per block (stays in L2). 512 threads cover
//     512 C / L columns: the tile's 128 up to r = 256, in 2 (r <= 512)
//     or 4 passes past it, each pass sweeping its columns with A streamed
//     again; the column's rows stay in registers through the sweep
//     (2 x 4 x 8 floats a thread up to r = 512, 2 x 4 x 10 past it).
//   * With the stop, each pass loads its columns from the slice and writes
//     the swept ones to the slice's other tile; the Grams of the step delta
//     and of the old iterate and the decision are fista_wide_kernel's
//     (wide_tile_grams, ft_stop_decision), in shared memory up to r = 136
//     (coder_wide_config's gram_smem) and in the slice past it. Without it
//     each pass keeps its columns in registers from H0 to H over every
//     sweep, and the kernel has no slice.
constexpr int CW_THREADS = 512;
constexpr int CW_CHUNK = 16;  // rows k of A and of B's columns a staged chunk
// The regimes by rank: the largest r, lanes a column, columns a thread and
// float4 slots a lane (a lane holds 4 slots rows of each of its columns;
// A's table is zero-padded to 4 lanes slots columns, so that every step
// runs the same unrolled loop: on an H100 a guard on each slot cost 15% of
// the fixed sweeps' time at r = 256 and 512).
struct CwRegime {
  int max_rank, lanes, cols, slots;
};
constexpr int CW_NREGIMES = 5;

__host__ __device__ constexpr CwRegime cw_regime(int i) {
  return i == 0   ? CwRegime{128, 8, 2, 4}
         : i == 1 ? CwRegime{192, 8, 2, 6}
         : i == 2 ? CwRegime{256, 8, 2, 8}
         : i == 3 ? CwRegime{512, 16, 2, 8}
                  : CwRegime{1280, 32, 2, 10};
}

// The wide coder's shape at rank r, from r and the mode alone (twin:
// coder_kernel.coder_wide_config): lanes per column, float4 slots per lane,
// A's padded row stride (4 lanes slots), columns a pass and passes; with the
// stop, the Grams' block side, rows and row stride, the columns of a staged
// Gram chunk and its row stride, and whether the Grams and power vectors
// fit shared memory (fw_config's rules at CW_THREADS threads); the sweep's
// shared floats (two chunks of A and of B, the steps) and the block's.
struct CwConfig {
  int regime, lanes, cols, slots, row_stride, cols_pass, passes, gram_block,
      gram_rows, gram_stride, gram_cols, gram_smem;
  size_t sweep_floats, smem_floats;
};

__host__ __device__ inline CwConfig cw_config(int r, int use_stopping) {
  CwConfig c;
  c.regime = 0;
  while (c.regime + 1 < CW_NREGIMES && r > cw_regime(c.regime).max_rank)
    ++c.regime;
  c.lanes = cw_regime(c.regime).lanes;
  c.cols = cw_regime(c.regime).cols;
  c.slots = cw_regime(c.regime).slots;
  c.row_stride = 4 * c.lanes * c.slots;
  c.cols_pass = CW_THREADS * c.cols / c.lanes;
  c.passes = TN / c.cols_pass;
  c.sweep_floats = 2 * (size_t)CW_CHUNK * (c.row_stride + c.cols_pass)
                   + ((r + 3) & ~3);
  const int nb = (r + 3) >> 2;
  c.gram_block = nb * (nb + 1) / 2 > 2 * CW_THREADS ? 8 : 4;
  c.gram_rows = (r + c.gram_block - 1) / c.gram_block * c.gram_block;
  c.gram_stride = (c.gram_rows >> 2) & 1 ? c.gram_rows : c.gram_rows + 4;
  c.gram_cols = TN;
  while (c.gram_cols > 1
         && (size_t)c.gram_cols * c.gram_stride > FW_SMEM_FLOATS)
    c.gram_cols >>= 1;
  const size_t staged = (size_t)c.gram_cols * c.gram_stride;
  const size_t grams = 2 * (size_t)c.gram_rows * c.gram_rows;
  c.gram_smem = use_stopping
      && fw_vec_floats(r) + grams + staged <= FW_SMEM_FLOATS;
  c.smem_floats = c.sweep_floats;
  if (c.gram_smem) {
    c.smem_floats = fw_vec_floats(r) + (c.sweep_floats > grams + staged
                                            ? c.sweep_floats
                                            : grams + staged);
  } else if (use_stopping && staged > c.sweep_floats) {
    c.smem_floats = staged;
  }
  return c;
}

// The wide coder's workspace: the (r, row_stride) table of A first, then
// with the stop one slice per block: the iterate and the swept iterate as
// (r, TN) tiles, and where they do not fit shared memory both Grams and six
// r-vectors; a slice is a whole number of 128-byte lines.
__host__ __device__ inline size_t cw_head_floats(int r) {
  return (size_t)r * cw_config(r, 0).row_stride;
}

__host__ __device__ inline size_t cw_slice_floats(int r, int use_stopping) {
  if (!use_stopping) return 0;
  const CwConfig c = cw_config(r, 1);
  size_t floats = 2 * (size_t)r * TN;
  if (!c.gram_smem)
    floats += 2 * (size_t)c.gram_rows * c.gram_rows + fw_vec_floats(r);
  return (floats + 31) & ~(size_t)31;
}

__global__ void coder_wide_prep_kernel(const float* __restrict__ A, int r,
                                       int RP, float* __restrict__ Ap) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < r * RP;
       i += gridDim.x * blockDim.x) {
    const int k = i / RP, j = i - k * RP;
    Ap[i] = j < r ? A[(size_t)k * r + j] : 0.f;
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool copy) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(copy ? 4 : 0)
               : "memory");
}

// Stage chunk c: rows c CW_CHUNK.. of A's table (as (CW_CHUNK, RP)) and of
// B's columns col0..col0 + PC - 1 (as (CW_CHUNK, PC); B's rows need not be
// 16-byte aligned, so four bytes a copy), zeros past r and n: one commit
// group.
__device__ __forceinline__ void cw_stage(float* Ab, float* Bb,
                                         const float* Ap, const float* B,
                                         size_t col0, int r, int n, int RP,
                                         int PC, int c) {
  const int k0 = c * CW_CHUNK, q4 = RP >> 2;
  for (int x = threadIdx.x; x < CW_CHUNK * q4; x += blockDim.x) {
    const int kk = x / q4, j = x - kk * q4;
    const bool ok = k0 + kk < r;
    cp_async16(Ab + kk * RP + 4 * j,
               ok ? Ap + (size_t)(k0 + kk) * RP + 4 * j : Ap, ok);
  }
  for (int x = threadIdx.x; x < CW_CHUNK * PC; x += blockDim.x) {
    const int kk = x / PC, cc = x - kk * PC;
    const bool ok = k0 + kk < r && col0 + cc < (size_t)n;
    cp_async4(Bb + kk * PC + cc,
              ok ? B + (size_t)(k0 + kk) * n + col0 + cc : B, ok);
  }
  cp_async_commit();
}

// A thread's rows 4 (ell + L m) + s of its columns cc[u] from src (row
// stride ld; 0 past r and for an inactive column), or into dst (for the
// columns that `store` marks).
template <int L, int C, int QM>
__device__ __forceinline__ void cw_load(float (&h)[C][QM][4],
                                        const float* src, size_t ld,
                                        const size_t (&cc)[C],
                                        const bool (&active)[C],
                                        int r) {
  const int ell = threadIdx.x % L;
#pragma unroll
  for (int u = 0; u < C; ++u)
#pragma unroll
    for (int m = 0; m < QM; ++m)
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int k = 4 * (ell + L * m) + s;
        h[u][m][s] = k < r && active[u] ? src[(size_t)k * ld + cc[u]] : 0.f;
      }
}

template <int L, int C, int QM>
__device__ __forceinline__ void cw_store(const float (&h)[C][QM][4],
                                         float* dst, size_t ld,
                                         const size_t (&cc)[C],
                                         const bool (&store)[C],
                                         int r) {
  const int ell = threadIdx.x % L;
#pragma unroll
  for (int u = 0; u < C; ++u)
#pragma unroll
    for (int m = 0; m < QM; ++m)
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int k = 4 * (ell + L * m) + s;
        if (k < r && store[u]) dst[(size_t)k * ld + cc[u]] = h[u][m][s];
      }
}

// One Gauss-Seidel sweep of the pass's columns (col0.., this thread's at
// pass offsets pc[u]) held in h, step rs / (A_kk + 1): the chunks of A and
// B staged two ahead of use, the coordinates in order. Every thread calls
// it; it starts and ends with a barrier's worth of ordering on the shared
// buffers (the steps are written before the first chunk's barrier).
template <int L, int C, int QM>
__device__ __forceinline__ void cw_sweep(float (&h)[C][QM][4],
                                         const bool (&active)[C],
                                         const int (&pc)[C],
                                         const float* Ap, const float* B,
                                         size_t col0, int r, int n,
                                         float alpha, float rs, float* Abuf,
                                         float* Bbuf, float* stp) {
  constexpr int RP = 4 * L * QM, PC = CW_THREADS * C / L;
  const int ell = threadIdx.x % L;
  const int nch = (r + CW_CHUNK - 1) / CW_CHUNK;
  for (int k = threadIdx.x; k < r; k += blockDim.x)
    stp[k] = rs / (Ap[(size_t)k * RP + k] + 1.0f);
  cw_stage(Abuf, Bbuf, Ap, B, col0, r, n, RP, PC, 0);
  int c = 0;
#pragma unroll
  for (int m = 0; m < QM; ++m) {
    // chunks c = m L / 4 .. hold the row groups e + L m, e < L: the rows
    // of slot m
    for (int ec = 0; ec < L / 4 && c < nch; ++ec, ++c) {
      if (c + 1 < nch) {
        cw_stage(Abuf + ((c + 1) & 1) * CW_CHUNK * RP,
                 Bbuf + ((c + 1) & 1) * CW_CHUNK * PC, Ap, B, col0, r, n, RP,
                 PC, c + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // the chunk (and the steps) are in
      const float* Ac = Abuf + (c & 1) * CW_CHUNK * RP + 4 * ell;
      const float* Bc = Bbuf + (c & 1) * CW_CHUNK * PC;
      for (int e4 = 0; e4 < 4; ++e4) {
        const int e = 4 * ec + e4;  // the row group's lane
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int kk = 4 * e4 + s, k = c * CW_CHUNK + kk;
          if (k >= r) break;
          const float* a = Ac + kk * RP;
          float acc[C][4] = {};
#pragma unroll
          for (int mm = 0; mm < QM; ++mm) {
            const float4 av = ld4(a + 4 * L * mm);
#pragma unroll
            for (int u = 0; u < C; ++u) {
              acc[u][0] = fmaf(av.x, h[u][mm][0], acc[u][0]);
              acc[u][1] = fmaf(av.y, h[u][mm][1], acc[u][1]);
              acc[u][2] = fmaf(av.z, h[u][mm][2], acc[u][2]);
              acc[u][3] = fmaf(av.w, h[u][mm][3], acc[u][3]);
            }
          }
          const float st = stp[k];
#pragma unroll
          for (int u = 0; u < C; ++u) {
            float x = (acc[u][0] + acc[u][1]) + (acc[u][2] + acc[u][3]);
#pragma unroll
            for (int o = L / 2; o > 0; o >>= 1)
              x += __shfl_xor_sync(0xffffffffu, x, o);
            const float g = (x - Bc[kk * PC + pc[u]]) + alpha;
            const float hn = fmaxf(h[u][m][s] - st * g, 0.f);
            if (ell == e && active[u]) h[u][m][s] = hn;
          }
        }
      }
      __syncthreads();  // the buffer is refilled two chunks on
    }
  }
}

template <int L, int C, int QM, bool kStop>
__global__ void __launch_bounds__(CW_THREADS, 1)
    coder_wide_kernel(const float* __restrict__ B,
                      const float* __restrict__ H0, float* __restrict__ H,
                      int r, int n, float alpha, float stop, int sub_iter,
                      int pi_iters, float* __restrict__ ws) {
  count_run(kStop ? RUN_CODER_ES : RUN_CODER);
  if constexpr (kStop) count_columns(ES_COLUMNS, n);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int G = CW_THREADS / L;  // column groups: a pass's columns / C
  constexpr int RP = 4 * L * QM, PC = G * C;  // cfg.row_stride, cols_pass
  const CwConfig cfg = cw_config(r, kStop);
  const int RG = cfg.gram_rows, MS = cfg.gram_stride, TC = cfg.gram_cols;
  const float* Ap = ws;  // (r, RP): A's rows, zero past r
  float* slice = ws + (size_t)r * RP
                 + (size_t)blockIdx.x * cw_slice_floats(r, kStop);
  // shared: with the Grams in shared memory, the six power vectors first;
  // then two chunks of A, two of B and the steps, and with the stop (after
  // a sweep) over them the Grams where they fit and the staged Gram chunk
  float* sm = smem + (cfg.gram_smem ? fw_vec_floats(r) : 0);
  float* Abuf = sm;
  float* Bbuf = Abuf + 2 * CW_CHUNK * RP;
  float* stp = Bbuf + 2 * CW_CHUNK * PC;
  float* Gd = cfg.gram_smem ? sm : slice + 2 * (size_t)r * TN;
  float* Gh = Gd + (size_t)RG * RG;  // (RG, RG) Grams, row stride RG
  float* vd = cfg.gram_smem ? smem : Gh + (size_t)RG * RG;
  float* vh = vd + r;  // carried eigenvector estimates,
  float* wd = vh + r;  // the power steps' products
  float* wh = wd + r;
  float* ad = wh + r;  // and absolute row sums
  float* ah = ad + r;
  float* Mt = cfg.gram_smem ? sm + 2 * (size_t)RG * RG : sm;
  __shared__ float xch[4];

  const int t = threadIdx.x, grp = t / L;
  int pc[C];  // this thread's columns within a pass
#pragma unroll
  for (int u = 0; u < C; ++u) pc[u] = grp + u * G;
  const float stop2 = stop * stop;
  const int tiles = (n + TN - 1) / TN;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const size_t tile0 = (size_t)tile * TN;
    if constexpr (!kStop) {
      // each pass's columns in registers from H0 to H over every sweep
      for (int p = 0; p < cfg.passes; ++p) {
        const size_t col0 = tile0 + (size_t)p * PC;
        size_t cc[C];
        bool active[C];
#pragma unroll
        for (int u = 0; u < C; ++u) {
          cc[u] = col0 + pc[u];
          active[u] = cc[u] < (size_t)n;
        }
        float h[C][QM][4];
        cw_load<L, C, QM>(h, H0, n, cc, active, r);
        for (int i = 0; i < sub_iter; ++i)
          cw_sweep<L, C, QM>(h, active, pc, Ap, B, col0, r, n, alpha,
                             1.0f / sqrtf((float)i + 10.0f), Abuf, Bbuf,
                             stp);
        cw_store<L, C, QM>(h, H, n, cc, active, r);
      }
    } else {
      float* Ht[2] = {slice, slice + (size_t)r * TN};  // (r, TN) tiles
      // the tile of H0, eight loads in flight a thread
      for (int x0 = t; x0 < r * TN; x0 += 8 * blockDim.x) {
        float v[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int x = x0 + q * blockDim.x, c = x % TN;
          v[q] = x < r * TN && tile0 + c < (size_t)n
              ? H0[(size_t)(x / TN) * n + tile0 + c] : 0.f;
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int x = x0 + q * blockDim.x;
          if (x < r * TN) Ht[0][x] = v[q];
        }
      }
      for (int k = t; k < r; k += blockDim.x)
        vd[k] = vh[k] = 0.5f + (float)((k * 40503) % 65536) / 65536.0f;
      __syncthreads();
      int cur = 0, swept = sub_iter;
      for (int i = 0; i < sub_iter; ++i) {
        for (int p = 0; p < cfg.passes; ++p) {
          const size_t col0 = tile0 + (size_t)p * PC;
          size_t cc[C];
          bool active[C];
#pragma unroll
          for (int u = 0; u < C; ++u) {
            cc[u] = (size_t)p * PC + pc[u];
            active[u] = col0 + pc[u] < (size_t)n;
          }
          float h[C][QM][4];
          cw_load<L, C, QM>(h, Ht[cur], TN, cc, active, r);
          cw_sweep<L, C, QM>(h, active, pc, Ap, B, col0, r, n, alpha,
                             1.0f / sqrtf((float)i + 10.0f), Abuf, Bbuf,
                             stp);
          // every column, the batch's padding as its zeros: the Grams
          // read them
          bool all[C];
#pragma unroll
          for (int u = 0; u < C; ++u) all[u] = true;
          cw_store<L, C, QM>(h, Ht[cur ^ 1], TN, cc, all, r);
        }
        __syncthreads();  // every swept column is in the slice
        wide_tile_grams(Ht[cur], Ht[cur ^ 1], Mt, Gd, Gh, r, RG, MS, TC,
                        cfg.gram_block);
        const int cv = ft_stop_decision(Gd, Gh, vd, vh, wd, wh, ad, ah, xch,
                                        r, RG, stop2, pi_iters);
        cur ^= 1;  // the swept iterate, in the sweep that converges too
        if (cv) {  // the same in every thread
          swept = i + 1;
          break;
        }
      }
      count_sweeps(ES_COLUMN_SWEEPS, swept, tile0, n);
      for (int x0 = t; x0 < r * TN; x0 += 8 * blockDim.x) {
        float v[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int x = x0 + q * blockDim.x;
          v[q] = x < r * TN ? Ht[cur][x] : 0.f;
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int x = x0 + q * blockDim.x, c = x % TN;
          if (x < r * TN && tile0 + c < (size_t)n)
            H[(size_t)(x / TN) * n + tile0 + c] = v[q];
        }
      }
      __syncthreads();  // the slice is reused by the next tile
    }
  }
}

// The route past the cluster's shared memory (dict_route "single"; no path
// of the repo reaches it): one block, sequential over the r columns,
// threads over the d rows, W in device memory; each thread owns rows tid,
// tid + blockDim, ... of W, so only the column norm needs the whole block.
// A[:, j] is read by column, as dict_update_bcd does.
__global__ void dict_update_single_kernel(const float* __restrict__ W_in,
                                          const float* __restrict__ A,
                                          const float* __restrict__ B,
                                          float* __restrict__ W, int d,
                                          int r) {
  count_run(RUN_DICT);
  count_dict(r, 0);
  __shared__ float red[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  for (int i = threadIdx.x; i < d; i += blockDim.x)
    for (int l = 0; l < r; ++l) W[(size_t)i * r + l] = W_in[(size_t)i * r + l];
  for (int j = 0; j < r; ++j) {
    const float ajj1 = __ldg(A + j * r + j) + 1.0f;
    float ss = 0.f;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float* w = W + (size_t)i * r;
      float g = 0.f;
      for (int l = 0; l < r; ++l) g = fmaf(w[l], __ldg(A + l * r + j), g);
      g = g - B[(size_t)j * d + i];
      const float col = fmaxf(w[j] - g / ajj1, 0.f);
      W[(size_t)i * r + j] = col;
      ss += col * col;
    }
    ss = warp_sum(ss);
    if (lane == 0) red[warp] = ss;
    __syncthreads();
    float tot = 0.f;
    for (int w = 0; w < nwarps; ++w) tot += red[w];
    const float scale = fmaxf(sqrtf(tot), 1.0f);
    for (int i = threadIdx.x; i < d; i += blockDim.x)
      W[(size_t)i * r + j] = W[(size_t)i * r + j] / scale;
    __syncthreads();  // red[] is reused by the next column
  }
}

// ---------------------------------------------------------------------------
// dict_update_kernel: one column-BCD pass in residual form, the columns in
// panels.
//
// Replaces dict_update_sweep (pallas/coder_kernel.py:629): for j = 0..r-1,
//   col = max(0, W[:, j] - (W A[:, j] - B[j, :]) / (A_jj + 1)),
//   W[:, j] = col / max(1, |col|),
// with W A[:, j] over the already-updated earlier columns, so any A,
// symmetric or not, matches dict_update_bcd. What bounds it: not the
// roofline (d r^2 multiply-adds and ~100 KB at d = 300, r = 25: tens of
// nanoseconds) but the r sequential column steps, each needing the whole
// column's norm: one warp's shuffle sum (five shuffles, ~150 cycles on the
// H100) and one exchange of the warps' partial sums. The residual form
// before this one spent ~1475 cycles a column at (300, 25) on one CTA:
// ~640 on the rank-1 update of G before the barrier (dependent
// shared-memory read-modify-writes), ~320 reading the partial sums behind
// it, ~210 updating and reading the next column's element of G, 158 on the
// shuffles; on a cluster of 4 at (400, 100) ~2720, a third of it the
// cluster barrier's arrival (PERF.md). The design keeps the column step in
// registers:
//   * G = W_in A (d, r) is formed once, in shared memory, in register
//     blocks of 4 rows by 8 columns from W_in staged transposed (a float4
//     of 4 rows and two of A's row feed 32 multiply-adds); W_in and A come
//     in by cp.async, all copies in flight at once;
//   * one thread a row; the columns go in panels of DICT_PANEL. At a
//     panel's start each thread holds in registers its row's G over the
//     panel less B's rows there (prefetched a panel ahead), the panel's old
//     columns of W, the 1 / (A_jj + 1) and the panel's block of A above its
//     diagonal. A column's delta_i = w'_ij - W_in[i, j] reaches the
//     panel's later columns by one multiply-add each, in registers, and the
//     next panel's G by eight more (A's row loaded while the partial sums
//     travel); after the panel one rank-DICT_PANEL update brings the rest
//     of the row's G up to date, a float4 of G read and written once a
//     panel, not once a column;
//   * the exchange: in a CTA alone each warp writes its partial sum and
//     the column's warps meet at one named barrier; in a cluster (the rows
//     split over up to DICT_MAX_CLUSTER CTAs) each warp's partial sum goes
//     to every CTA by st.async, which completes that CTA's mbarrier (two,
//     by column parity, each armed for the column after next once waited
//     on), so a CTA waits on its own barrier alone, with no cluster
//     barrier a column. Every thread sums the same partial sums in the
//     same order, so every CTA takes the same norm;
//   * W stays in shared memory only transposed, for G and the old columns;
//     the new column replaces the old there and goes out coalesced at the
//     end. At least DICT_MIN_WARPS warps a CTA form G; past the rows' warps
//     they wait out the column step.
// A column step then measured ~900 cycles on 4 CTAs at (300, 25) (shuffles
// ~150, the mbarrier's wait and the read ~310), a call 15.5 us (33.8
// before), and 57 us at (400, 100) on 8 CTAs (180 before); dict_route's
// CTAs come from such timings. The residual sums in another order than
// dict_update_bcd, and the reciprocals round once more: the kernel matches
// it to float32 tolerance.
constexpr int DICT_MAX_THREADS = 448;
constexpr int DICT_MIN_WARPS = 8;
constexpr int DICT_MAX_CLUSTER = 8;
constexpr int DICT_MAX_PARTS = 128;  // past DICT_MAX_CLUSTER CTAs of 14 warps
constexpr int DICT_PANEL = 8;

__host__ __device__ inline int dict_round(int n, int m) {
  return (n + m - 1) / m * m;
}

// A row stride of at least n floats, = 4 (mod 32): a float4 of a warp's
// rows falls on distinct banks, and every row is 16-byte aligned.
__host__ __device__ inline int dict_stride(int n) {
  return n + (((4 - n) % 32) + 32) % 32;
}

// One thread a row, at least DICT_MIN_WARPS warps.
__host__ __device__ inline int dict_threads(int rows, int r) {
  const int warps = (rows + 31) / 32;
  return 32 * (warps > DICT_MIN_WARPS ? warps : DICT_MIN_WARPS);
}

// Shared floats of one CTA of `rows` rows: two buffers of partial sums and
// two barriers, 1 / (A_jj + 1), A padded to whole panels, the rows of W
// transposed and the rows of G.
__host__ __device__ inline size_t dict_smem_floats(int rows, int r) {
  const int ra = dict_round(r, DICT_PANEL);
  return 2 * (size_t)DICT_MAX_PARTS + 4 + ra + (size_t)ra * ra +
         (size_t)r * dict_stride(rows) +
         (size_t)rows * dict_stride(dict_round(r, 4));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

// The barrier's one arrival of its phase, which then waits for `bytes`.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned a = smem_u32(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// v into `dst` of the cluster's CTA `rank`, completing 4 bytes of that
// CTA's barrier `bar` (both given by their addresses in this CTA).
__device__ __forceinline__ void st_async(float* dst, unsigned long long* bar,
                                         int rank, float v) {
  unsigned rd, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rd) : "r"(smem_u32(dst)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rb) : "r"(smem_u32(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];\n" ::"r"(rd), "f"(v), "r"(rb)
      : "memory");
}

// x / n for 0 <= x < 2^32 / n, by m = dict_divisor(n) = 2^32 / n rounded
// up: one multiply.
__device__ __forceinline__ unsigned long long dict_divisor(unsigned n) {
  return ((1ull << 32) + n - 1) / n;
}

__device__ __forceinline__ int dict_div(int x, unsigned long long m) {
  return (int)(((unsigned long long)(unsigned)x * m) >> 32);
}

// The column's partial sums read whole, summed in the same order in every
// thread of every CTA.
__device__ __forceinline__ float dict_total(const float* part, int parts) {
  float tot = 0.f;
#pragma unroll 4
  for (int x = 0; x < parts; x += 4) {
    const float4 v = *reinterpret_cast<const float4*>(part + x);
    tot += (v.x + v.y) + (v.z + v.w);
  }
  return tot;
}

template <bool kCluster>
__global__ void __launch_bounds__(DICT_MAX_THREADS)
    dict_update_kernel(const float* __restrict__ W_in,
                       const float* __restrict__ A,
                       const float* __restrict__ B, float* __restrict__ W,
                       int d, int r, int rows) {
  constexpr int K = DICT_PANEL;
  count_run(RUN_DICT);
  count_dict(r, (r - 1) / K);
  extern __shared__ __align__(16) float smem[];
  const int RA = dict_round(r, K), R4 = dict_round(r, 4);
  const int GS = dict_stride(R4), WTS = dict_stride(rows);
  float* red = smem;  // 2 x DICT_MAX_PARTS partial sums, by column parity
  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(red + 2 * DICT_MAX_PARTS);
  float* rinv = red + 2 * DICT_MAX_PARTS + 4;  // (RA) 1 / (A_jj + 1)
  float* As = rinv + RA;                       // (RA, RA) A, zero-padded
  float* Wt = As + (size_t)RA * RA;            // (r, WTS) the rows of W
  float* G = Wt + (size_t)r * WTS;             // (rows, GS) W_in A
  int ctas = 1, rank = 0;
  if constexpr (kCluster) {
    ctas = (int)cg::this_cluster().num_blocks();
    rank = (int)cg::this_cluster().block_rank();
  }
  const int t = threadIdx.x, T = blockDim.x, lane = t & 31, warp = t >> 5;
  const int chain = (rows + 31) >> 5, parts = ctas * chain;
  const int row0 = rank * rows, own = max(0, min(rows, d - row0));
  const unsigned long long by_r = dict_divisor(r), by_ra = dict_divisor(RA);
  for (int x = t; x < 2 * DICT_MAX_PARTS; x += T) red[x] = 0.f;
  if (kCluster && t == 0) {
    mbar_init(bars);
    mbar_init(bars + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(bars, 4 * parts);
    if (r > 1) mbar_expect(bars + 1, 4 * parts);
  }
  for (int x = t; x < RA * RA; x += T) {
    const int m = dict_div(x, by_ra), l = x - m * RA;
    const bool in = m < r && l < r;
    cp_async4(As + x, A + (in ? m * r + l : 0), in);
  }
  const float* Wr = W_in + (size_t)row0 * r;
  for (int x = t; x < own * r; x += T) {
    const int i = dict_div(x, by_r);
    cp_async4(Wt + (x - i * r) * WTS + i, Wr + x, true);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  for (int x = t; x < r; x += T) rinv[x] = 1.0f / (As[x * RA + x] + 1.0f);
  // G = W_in A in blocks of rows 4b..4b+3 by columns l0..l0+7
  const int nb4 = (own + 3) / 4, items = nb4 * (RA / 8);
  for (int it = t; it < items; it += T) {
    const int b = it % nb4, l0 = 8 * (it / nb4);
    float acc[4][8] = {};
    const float* wt = Wt + 4 * b;
    const float* a = As + l0;
#pragma unroll 4
    for (int m = 0; m < r; ++m) {
      const float4 w4 = *reinterpret_cast<const float4*>(wt + (size_t)m * WTS);
      const float4 a0 = *reinterpret_cast<const float4*>(a + m * RA);
      const float4 a1 = *reinterpret_cast<const float4*>(a + m * RA + 4);
      const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[k][q] = fmaf(wv[k], av[q], acc[k][q]);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (4 * b + k >= own) continue;
      float* g = G + (size_t)(4 * b + k) * GS + l0;
      if (l0 < R4)
        *reinterpret_cast<float4*>(g) =
            make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
      if (l0 + 4 < R4)
        *reinterpret_cast<float4*>(g + 4) =
            make_float4(acc[k][4], acc[k][5], acc[k][6], acc[k][7]);
    }
  }
  const bool live = t < own;
  const float* Bi = B + row0 + t;  // B[l, row0 + t] at Bi[l * d]
  float bn[K];                     // B's rows of a coming panel at this row
#pragma unroll
  for (int q = 0; q < K; ++q)
    bn[q] = live && q < r ? __ldg(Bi + (size_t)q * d) : 0.f;
  if constexpr (kCluster) {
    cluster_arrive();  // G, and every CTA's barriers before remote stores
    cluster_wait();
  } else {
    __syncthreads();
  }
  if (warp < chain) {
    float* gi = G + (size_t)t * GS;
    float gp[K], gn[K], wold[K], rv[K], ab[K][K], dl[K];
#pragma unroll
    for (int q = 0; q < K; q += 4) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live && q < R4) v = *reinterpret_cast<const float4*>(gi + q);
      gn[q] = v.x - bn[q];
      gn[q + 1] = v.y - bn[q + 1];
      gn[q + 2] = v.z - bn[q + 2];
      gn[q + 3] = v.w - bn[q + 3];
    }
#pragma unroll
    for (int q = 0; q < K; ++q)
      bn[q] = live && K + q < r ? __ldg(Bi + (size_t)(K + q) * d) : 0.f;
    for (int j0 = 0; j0 < r; j0 += K) {
      const int j1 = j0 + K;
      // the panel: its G (less B's rows, plus the last panel's part), the
      // old columns of W, 1 / (A_jj + 1), A's block above its diagonal
#pragma unroll
      for (int q = 0; q < K; ++q) {
        gp[q] = gn[q];
        wold[q] = live && j0 + q < r ? Wt[(j0 + q) * WTS + t] : 0.f;
        rv[q] = rinv[j0 + q];
#pragma unroll
        for (int q2 = 0; q2 < K; q2 += 4) {
          if (q2 + 3 > q) {
            const float4 a = *reinterpret_cast<const float4*>(
                As + (size_t)(j0 + q) * RA + j0 + q2);
            ab[q][q2] = a.x;
            ab[q][q2 + 1] = a.y;
            ab[q][q2 + 2] = a.z;
            ab[q][q2 + 3] = a.w;
          }
        }
      }
      // the next panel's G, which the last panel's rank-K update reached
#pragma unroll
      for (int q = 0; q < K; q += 4) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (live && j1 + q < R4)
          v = *reinterpret_cast<const float4*>(gi + j1 + q);
        gn[q] = v.x - bn[q];
        gn[q + 1] = v.y - bn[q + 1];
        gn[q + 2] = v.z - bn[q + 2];
        gn[q + 3] = v.w - bn[q + 3];
      }
#pragma unroll
      for (int q = 0; q < K; ++q) {
        bn[q] = live && j1 + K + q < r
                    ? __ldg(Bi + (size_t)(j1 + K + q) * d) : 0.f;
        dl[q] = 0.f;
      }
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const int j = j0 + q;
        if (j >= r) break;
        const float col =
            live ? fmaxf(fmaf(-gp[q], rv[q], wold[q]), 0.f) : 0.f;
        const float ss = warp_sum(col * col);
        float* part = red + (j & 1) * DICT_MAX_PARTS;
        if constexpr (kCluster) {
          if (lane < ctas)
            st_async(part + rank * chain + warp, bars + (j & 1), lane, ss);
        } else {
          if (lane == 0) part[warp] = ss;
        }
        // A's row j over the next panel, while the partial sums travel
        const float* an = As + (size_t)j * RA + (j1 < RA ? j1 : 0);
        const float4 an0 = *reinterpret_cast<const float4*>(an);
        const float4 an1 = *reinterpret_cast<const float4*>(an + 4);
        if constexpr (kCluster)
          mbar_wait(bars + (j & 1), (j >> 1) & 1);
        else
          asm volatile("bar.sync 1, %0;\n" ::"r"(chain * 32) : "memory");
        const float tot = dict_total(part, parts);
        if (kCluster && t == 0 && j + 2 < r)
          mbar_expect(bars + (j & 1), 4 * parts);
        const float wn = col * (tot > 1.0f ? rsqrtf(tot) : 1.0f);
        dl[q] = wn - wold[q];
        if (live) Wt[j * WTS + t] = wn;
#pragma unroll
        for (int q2 = q + 1; q2 < K; ++q2)
          gp[q2] = fmaf(dl[q], ab[q][q2], gp[q2]);
        const float av[8] = {an0.x, an0.y, an0.z, an0.w,
                             an1.x, an1.y, an1.z, an1.w};
#pragma unroll
        for (int q2 = 0; q2 < K; ++q2) gn[q2] = fmaf(dl[q], av[q2], gn[q2]);
      }
      // the panel's rank-K update of the row's G past the next panel
      if (live) {
        const float* ap = As + (size_t)j0 * RA;
        for (int l = j1 + K; l < R4; l += 4) {
          float4 g = *reinterpret_cast<const float4*>(gi + l);
#pragma unroll
          for (int m = 0; m < K; ++m) {
            const float4 a = *reinterpret_cast<const float4*>(ap + m * RA + l);
            g.x = fmaf(dl[m], a.x, g.x);
            g.y = fmaf(dl[m], a.y, g.y);
            g.z = fmaf(dl[m], a.z, g.z);
            g.w = fmaf(dl[m], a.w, g.w);
          }
          *reinterpret_cast<float4*>(gi + l) = g;
        }
      }
    }
  }
  if constexpr (kCluster) cluster_arrive();  // no store to another CTA left
  __syncthreads();
  float* Wo = W + (size_t)row0 * r;
  for (int x = t; x < own * r; x += T) {
    const int i = dict_div(x, by_r);
    Wo[x] = Wt[(x - i * r) * WTS + i];
  }
  if constexpr (kCluster) cluster_wait();
}

template <bool kBf16>
int launch_fista(const float* A, const float* B, const float* H0, float* H,
                 int r, int n, float alpha, const float* inv_L, float stop,
                 int sub_iter, int use_stopping, int pi_iters, float* ws,
                 int blocks, cudaStream_t stream);

template <int L, int Q>
int launch_coder_lanes(const float* A, const float* B, const float* H0,
                       float* H, int r, int n, float alpha, int sub_iter,
                       cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)r * L * Q;
  int e = launch_smem((const void*)coder_lanes_kernel<L, Q>, smem);
  if (e) return e;
  coder_lanes_kernel<L, Q><<<(n + TN - 1) / TN, TN / CS_COLS * L, smem,
                             stream>>>(A, B, H0, H, r, n, alpha, sub_iter);
  return (int)cudaGetLastError();
}

// A's padded table into the head of ws, then coder_wide_kernel in the
// regime of r.
template <bool kStop>
int launch_coder_wide(const float* A, const float* B, const float* H0,
                      float* H, int r, int n, float alpha, float stop,
                      int sub_iter, int pi_iters, float* ws, int blocks,
                      cudaStream_t stream) {
  if (r > cw_regime(CW_NREGIMES - 1).max_rank)
    return (int)cudaErrorInvalidValue;
  const CwConfig c = cw_config(r, kStop);
  const int cells = r * c.row_stride;
  coder_wide_prep_kernel<<<(cells + 255) / 256, 256, 0, stream>>>(
      A, r, c.row_stride, ws);
  int e = (int)cudaGetLastError();
  if (e) return e;
#define CW_KERNEL(i)                                                    \
  coder_wide_kernel<cw_regime(i).lanes, cw_regime(i).cols, cw_regime(i).slots, \
                    kStop>
  auto kernel = c.regime == 0   ? CW_KERNEL(0)
                : c.regime == 1 ? CW_KERNEL(1)
                : c.regime == 2 ? CW_KERNEL(2)
                : c.regime == 3 ? CW_KERNEL(3)
                                : CW_KERNEL(4);
#undef CW_KERNEL
  const size_t smem = sizeof(float) * c.smem_floats;
  e = launch_smem((const void*)kernel, smem);
  if (e) return e;
  kernel<<<blocks, CW_THREADS, smem, stream>>>(B, H0, H, r, n, alpha, stop,
                                                sub_iter, pi_iters, ws);
  return (int)cudaGetLastError();
}

template <int L, int Q>
int launch_es_lanes(const float* A, const float* B, const float* H0, float* H,
                    int r, int n, float alpha, float stop, int sub_iter,
                    int pi_iters, cudaStream_t stream) {
  const size_t smem = sizeof(float) * es_lanes_smem_floats(r);
  int e = launch_smem((const void*)coder_es_lanes_kernel<L, Q, false>, smem);
  if (e) return e;
  coder_es_lanes_kernel<L, Q, false><<<(n + TN - 1) / TN, TN / ES_COLS * L,
                                       smem, stream>>>(
      A, B, H0, H, r, n, alpha, stop, sub_iter, pi_iters);
  return (int)cudaGetLastError();
}

// Each tile on a cluster of S CTAs (es_cluster_min(r)..ES_MAX_CLUSTER, a
// power of two; none up to r = 32), es_cluster_lanes(r) lanes a pair of
// columns.
int launch_es_cluster(const float* A, const float* B, const float* H0,
                      float* H, int r, int n, float alpha, float stop,
                      int sub_iter, int pi_iters, int S,
                      cudaStream_t stream) {
  const int least = es_cluster_min(r);
  if (!least || S < least || S > ES_MAX_CLUSTER || (S & (S - 1)))
    return (int)cudaErrorInvalidValue;
  const auto kernel = es_cluster_lanes(r) == 16
                          ? coder_es_lanes_kernel<16, ES_CLUSTER_ROWS, true>
                          : coder_es_lanes_kernel<32, ES_CLUSTER_ROWS, true>;
  const size_t smem = sizeof(float) * es_cluster_smem_floats(r, S);
  int e = launch_smem((const void*)kernel, smem);
  if (e) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + TN - 1) / TN * S);
  cfg.blockDim = dim3(TN / S / ES_COLS * es_cluster_lanes(r));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = (int)cudaLaunchKernelEx(&cfg, kernel, A, B, H0, H, r, n, alpha, stop,
                              sub_iter, pi_iters);
  if (e) {
    cudaGetLastError();
    return e;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory bytes each shared-memory coder kernel needs at rank r.
size_t onmf_coder_sweeps_smem(int r) {
  return sizeof(float) * (size_t)r * es_lanes(r) * cs_rows_per_lane(r);
}

size_t onmf_coder_sweeps_earlystop_smem(int r) {
  return sizeof(float) * es_lanes_smem_floats(r);
}

// The early-stop coder's cluster form: the fewest CTAs of a tile at rank
// r (0 where there is none) and the most; the wrapper's route is checked
// against them when the library is loaded.
int onmf_coder_es_cluster_min(int r) { return es_cluster_min(r); }

int onmf_coder_es_max_cluster() { return ES_MAX_CLUSTER; }

// Shared floats of one dict_update_kernel CTA of `rows` rows.
size_t onmf_dict_smem_floats(int rows, int r) {
  return dict_smem_floats(rows, r);
}

size_t onmf_fista_sweeps_smem(int r, int use_stopping) {
  return sizeof(float) * ft_smem_floats(r, use_stopping);
}

// Workspace floats of the wide FISTA kernel: the A^T table, then one slice
// per block.
size_t onmf_fista_head_floats(int r) { return fista_head_floats(r); }

size_t onmf_fista_slice_floats(int r, int use_stopping) {
  return fw_slice_floats(r, use_stopping);
}

// fista_wide_kernel's shape at rank r (fw_config) into out[0..8]: Y
// resident (1) or streamed (0), threads, passes, rows a pass, rows j a
// chunk, the side of a Gram block, columns a Gram chunk, the Grams in
// shared memory (1) or the workspace (0), shared bytes.
void onmf_fista_wide_config(int r, int use_stopping, int* out) {
  const FwConfig c = fw_config(r, use_stopping);
  const int v[9] = {c.resident, c.threads, c.passes, c.rows, FW_CHUNK,
                    c.gram_block, c.gram_cols, c.gram_smem,
                    (int)(sizeof(float) * c.smem_floats)};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
}

// coder_wide_kernel's shape at rank r (cw_config) into out[0..9]: lanes per
// column, float4 slots per lane, passes, rows k a chunk, the side of a Gram
// block, columns a Gram chunk, the Grams in shared memory (1) or the
// workspace (0), shared bytes, and the workspace's floats: A's table, and
// one slice per block.
void onmf_coder_wide_config(int r, int use_stopping, int* out) {
  const CwConfig c = cw_config(r, use_stopping);
  const int v[10] = {c.lanes, c.slots, c.passes, CW_CHUNK, c.gram_block,
                     c.gram_cols, c.gram_smem,
                     (int)(sizeof(float) * c.smem_floats),
                     (int)cw_head_floats(r),
                     (int)cw_slice_floats(r, use_stopping)};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
}

int onmf_tile_columns(void) { return TN; }

// The counts (g_runs) into out[0..RUN_KINDS - 1], after every launch
// before it on any stream has finished; onmf_reset_runs zeroes them.
int onmf_read_runs(unsigned long long* out) {
  int e = (int)cudaDeviceSynchronize();
  if (e) return e;
  return (int)cudaMemcpyFromSymbol(out, g_runs, sizeof(g_runs));
}

// A copy of the counts into out[0..RUN_KINDS - 1] (host memory, pinned
// for the copy to be asynchronous), queued on `stream` behind the work
// already queued there; nothing waits for it.
int onmf_snapshot_runs(unsigned long long* out, void* stream) {
  return (int)cudaMemcpyFromSymbolAsync(out, g_runs, sizeof(g_runs), 0,
                                        cudaMemcpyDeviceToHost,
                                        (cudaStream_t)stream);
}

int onmf_run_slots(void) { return RUN_KINDS; }

int onmf_reset_runs(void) {
  int e = (int)cudaDeviceSynchronize();
  if (e) return e;
  const unsigned long long zero[RUN_KINDS] = {};
  return (int)cudaMemcpyToSymbol(g_runs, zero, sizeof(g_runs));
}

const char* onmf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// ws == NULL: coder_lanes_kernel, one block per tile; otherwise (past
// CS_MAX_RANK) the wide kernel without the stop on `blocks` blocks, ws
// holding A's table (onmf_coder_wide_config).
int onmf_coder_sweeps(const float* A, const float* B, const float* H0,
                      float* H, int r, int n, float alpha, int sub_iter,
                      float* ws, int blocks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (ws ? r <= CS_MAX_RANK : r > CS_MAX_RANK)
    return (int)cudaErrorInvalidValue;
  if (ws)
    return launch_coder_wide<false>(A, B, H0, H, r, n, alpha, 0.f, sub_iter,
                                    0, ws, blocks, st);
  if (r <= 16)
    return launch_coder_lanes<2, 8>(A, B, H0, H, r, n, alpha, sub_iter, st);
  if (r <= 32)
    return launch_coder_lanes<2, 16>(A, B, H0, H, r, n, alpha, sub_iter, st);
  if (r <= 64)
    return launch_coder_lanes<4, 16>(A, B, H0, H, r, n, alpha, sub_iter, st);
  if (r <= 100)
    return launch_coder_lanes<4, 25>(A, B, H0, H, r, n, alpha, sub_iter, st);
  return launch_coder_lanes<4, 32>(A, B, H0, H, r, n, alpha, sub_iter, st);
}

// ws == NULL: the shared-memory kernel, one block per tile (cluster 1) or
// a cluster of `cluster` CTAs per tile; otherwise (past ES_MAX_RANK) the
// wide kernel on `blocks` blocks, ws holding A's table and one slice per
// block (onmf_coder_wide_config).
int onmf_coder_sweeps_earlystop(const float* A, const float* B,
                                const float* H0, float* H, int r, int n,
                                float alpha, float stop, int sub_iter,
                                int pi_iters, int cluster, float* ws,
                                int blocks, void* stream) {
  if (ws ? r <= ES_MAX_RANK || cluster != 1 : r > ES_MAX_RANK)
    return (int)cudaErrorInvalidValue;
  if (ws)
    return launch_coder_wide<true>(A, B, H0, H, r, n, alpha, stop, sub_iter,
                                   pi_iters, ws, blocks,
                                   (cudaStream_t)stream);
  if (cluster != 1)
    return launch_es_cluster(A, B, H0, H, r, n, alpha, stop, sub_iter,
                             pi_iters, cluster, (cudaStream_t)stream);
  if (r <= 16)
    return launch_es_lanes<2, 8>(A, B, H0, H, r, n, alpha, stop, sub_iter,
                                 pi_iters, (cudaStream_t)stream);
  if (r <= 32)
    return launch_es_lanes<2, 16>(A, B, H0, H, r, n, alpha, stop, sub_iter,
                                  pi_iters, (cudaStream_t)stream);
  if (r <= 64)
    return launch_es_lanes<4, 16>(A, B, H0, H, r, n, alpha, stop, sub_iter,
                                  pi_iters, (cudaStream_t)stream);
  return launch_es_lanes<4, 25>(A, B, H0, H, r, n, alpha, stop, sub_iter,
                                pi_iters, (cudaStream_t)stream);
}

// The step size into inv_L (one float of device scratch, from
// lipschitz_iters power steps), then the sweeps, which read it. ws == NULL:
// the shared-memory kernel, one block per tile; otherwise (past the
// shared-memory ranks) the A^T table is written to the head of ws first and
// the wide kernel runs on `blocks` blocks, one slice of ws each.
int onmf_fista_sweeps(const float* A, const float* B, const float* H0,
                      float* H, int r, int n, float alpha, float* inv_L,
                      int lipschitz_iters, float stop, int sub_iter,
                      int use_stopping, int pi_iters, int bf16_matmul,
                      float* ws, int blocks, void* stream) {
  const int max_smem_rank = use_stopping ? FISTA_STOP_MAX_RANK
                                         : FISTA_MAX_RANK;
  if (ws ? r <= max_smem_rank : r > max_smem_rank)
    return (int)cudaErrorInvalidValue;
  if (ws) {
    const int cells = r * ((r + 3) & ~3);
    if (bf16_matmul)
      fista_prep_kernel<true><<<(cells + 255) / 256, 256, 0,
                                (cudaStream_t)stream>>>(A, r, ws);
    else
      fista_prep_kernel<false><<<(cells + 255) / 256, 256, 0,
                                 (cudaStream_t)stream>>>(A, r, ws);
    const int e = (int)cudaGetLastError();
    if (e) return e;
  }
  const int in_smem = r <= STEP_SMEM_MAX_RANK;
  const size_t step_smem =
      sizeof(float) * (2 * (size_t)r + (in_smem ? (size_t)r * (r | 1) : 0));
  int e = launch_smem((const void*)fista_step_size_kernel, step_smem);
  if (e) return e;
  // a thread per row in shared memory; a warp per row from device memory
  const int step_threads = in_smem ? (r + 31) / 32 * 32 : STEP_MAX_THREADS;
  fista_step_size_kernel<<<1, step_threads, step_smem,
                           (cudaStream_t)stream>>>(A, r, lipschitz_iters,
                                                   in_smem, inv_L);
  e = (int)cudaGetLastError();
  if (e) return e;
  if (bf16_matmul)
    return launch_fista<true>(A, B, H0, H, r, n, alpha, inv_L, stop,
                              sub_iter, use_stopping, pi_iters, ws, blocks,
                              (cudaStream_t)stream);
  return launch_fista<false>(A, B, H0, H, r, n, alpha, inv_L, stop, sub_iter,
                             use_stopping, pi_iters, ws, blocks,
                             (cudaStream_t)stream);
}

// ctas = 0: the single-block kernel (the route past the cluster); 1: one
// CTA of dict_update_kernel; 2..DICT_MAX_CLUSTER: a cluster of that many,
// each with ceil(d / ctas) rows.
int onmf_dict_update_sweep(const float* W_in, const float* A, const float* B,
                           float* W, int d, int r, int ctas, void* stream) {
  if (ctas <= 0) {
    int threads = ((d + 31) / 32) * 32;
    threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
    dict_update_single_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
        W_in, A, B, W, d, r);
    return (int)cudaGetLastError();
  }
  if (ctas > DICT_MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  const int rows = (d + ctas - 1) / ctas;
  const int threads = dict_threads(rows, r);
  if (threads > DICT_MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * dict_smem_floats(rows, r);
  if (ctas == 1) {
    int e = launch_smem((const void*)dict_update_kernel<false>, smem);
    if (e) return e;
    dict_update_kernel<false><<<1, threads, smem, (cudaStream_t)stream>>>(
        W_in, A, B, W, d, r, rows);
    return (int)cudaGetLastError();
  }
  int e = launch_smem((const void*)dict_update_kernel<true>, smem);
  if (e) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = (int)cudaLaunchKernelEx(&cfg, dict_update_kernel<true>, W_in, A, B, W,
                              d, r, rows);
  if (e) {
    cudaGetLastError();
    return e;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

namespace {

// Launch `kernel` while the step-size kernel before it in the stream still
// runs (programmatic dependent launch); the kernel waits for it before it
// reads inv_L.
template <typename... KArgs, typename... Args>
int launch_after_step_size(void (*kernel)(KArgs...), int blocks, int threads,
                           size_t smem, cudaStream_t stream, Args... args) {
  int e = launch_smem((const void*)kernel, smem);
  if (e) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = (int)cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e) {
    cudaGetLastError();
    return e;
  }
  return (int)cudaGetLastError();
}

template <bool kBf16>
int launch_fista(const float* A, const float* B, const float* H0, float* H,
                 int r, int n, float alpha, const float* inv_L, float stop,
                 int sub_iter, int use_stopping, int pi_iters, float* ws,
                 int blocks, cudaStream_t stream) {
  if (ws) {
    const FwConfig c = fw_config(r, use_stopping);
    auto kernel = c.resident
        ? (use_stopping ? fista_wide_kernel<kBf16, true, true>
                        : fista_wide_kernel<kBf16, true, false>)
        : (use_stopping ? fista_wide_kernel<kBf16, false, true>
                        : fista_wide_kernel<kBf16, false, false>);
    return launch_after_step_size(kernel, blocks, c.threads,
                                  sizeof(float) * c.smem_floats, stream, B,
                                  H0, H, r, n, alpha, inv_L, stop, sub_iter,
                                  pi_iters, ws);
  }
  return launch_after_step_size(
      fista_tiled_kernel<kBf16>, (n + TN - 1) / TN, ft_threads(r),
      onmf_fista_sweeps_smem(r, use_stopping), stream, A, B, H0, H, r, n,
      alpha, inv_L, stop, sub_iter, use_stopping, pi_iters);
}

}  // namespace
