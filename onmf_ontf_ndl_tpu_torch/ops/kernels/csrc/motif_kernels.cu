// Hopper (sm_90a) kernels for the moves of the motif chains of network
// dictionary learning (samplers/motif.py).
//
// No Pallas kernel stands behind them: the JAX package runs its chains as
// one jitted program (onmf_ontf_ndl_tpu/samplers/motif.py:653-700, a
// lax.scan over the moves, vmapped over the chains), and these kernels are
// what stands for that program's arithmetic on this card. Each launch runs
// a block of M consecutive moves of every chain, in place on the (C, k)
// int64 embeddings, and writes the state after move s of chain c to
// trail[c, s, :] of the block's (C, M, k) int64 trail (no trail: the moves
// alone):
//   onmf_chain_glauber <- glauber_update (k > 1): a warp per chain, or a
//                         team of 2, 4 or 8 warps per chain where chains
//                         are few;
//   onmf_chain_pivot   <- rw_update, pivot_update and tree_sample: the
//                         Metropolis-Hastings walk of the root (or not),
//                         a thread per chain, then the regrowth of every
//                         move's tree, a thread per (chain, move).
// Plain C entry points, bound from Python with ctypes; each returns
// cudaGetLastError() after its launch (0 = success).
//
// Draws: the random numbers come from torch's generator, drawn by the
// caller in the plain moves' order (motif.py's draw functions) into (M, ...)
// tensors, row s for move s, so that a kernel's chains equal the plain
// moves' bit for bit. The kernels repeat the plain move's float32
// arithmetic exactly: `(u * d).long()` is __fmul_rn of the uniform and the
// int64 converted to float with rounding to nearest, then truncation; the
// acceptance `u < dx / dy` is __fdiv_rn. Both are written as intrinsics so
// that no contraction into an FMA changes a rounding; the library builds
// without --use_fast_math.
//
// Graphs, in the three representations of data/graphs.py, with rows that
// ascend in all three: dense (adj (N, N) bool, nbr (N, cols) int64 padded
// with 0), CSR (nbr_flat, offsets, deg; membership by a lower-bound binary
// search of the row) and bitset (the CSR arrays and the (N, words) uint32
// rows of bits; membership is one bit test).
//
// What bounds them on this card: the latency of dependent loads, not bytes
// or operations, and (before this design) each launch's fixed cost. A
// Glauber move reads its chain's constraint images, the candidate row of
// the first valid constraint and, per candidate, a test against each other
// constraint (a binary search: log2(deg) dependent loads); the pivot's
// regrowth is a chain of k - 1 dependent pairs of loads (the parent's
// degree, then its neighbour). What the design does about it:
//   - one launch runs M moves, so its fixed cost and the chains' loads and
//     stores are paid once a block, not once a move; a Glauber chain stays
//     in shared memory across the block, and only the trail rows go out (a
//     warp writes its chain's row, k consecutive int64, in one store);
//   - the draws of later moves are in flight while a move runs: a Glauber
//     warp's lanes load the draws of the next 32 moves into registers and
//     __shfl_sync hands a move its three; a walking thread loads its next
//     step's;
//   - a pivot move carries only its root to the next move, so the walk
//     runs first (a thread per chain, M steps of three dependent loads)
//     and the M trees of the block, which depend on their roots alone,
//     are then regrown side by side by every thread of the block, the
//     chains spread over the SMs (chain_pivot_chains);
//   - where the graph is small enough (chain_staged in motif_kernel.py:
//     N * 4 bytes dense, N * 8 CSR or bitset, up to STAGE_BYTES) the degree
//     vector, and the CSR row starts, are staged in shared memory as int32,
//     so that a regrown node or a binary search waits on one device load in
//     place of two;
//   - a Glauber move spreads its candidate row over the lanes of a warp (a
//     hub of the smoke's Barabasi-Albert graph has ~800 neighbours), counts
//     the valid candidates in row order with __ballot_sync and __popc, keeps
//     the first KEPT_CHUNKS chunks' ballots in shared memory and picks the
//     target-th valid candidate with a warp scan of their counts. Where
//     chains are few (chain_glauber_warps), a chain takes a team of warps:
//     the row's chunks are dealt over the warps, their counts summed in
//     shared memory, and the first warp picks.
//
// Each kernel counts its runs on the device (count_chain_run) with a
// counter of this source's own: onmf_chain_read_runs and
// onmf_chain_reset_runs read and zero it. A run replayed from a CUDA graph
// counts too.

#include <cuda_runtime.h>
#include <stddef.h>

#include "launch_util.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int GLAUBER_WARPS = 4;      // chains (warps) per block, a warp each
constexpr int MAX_TEAM = 8;           // warps of one chain's team, at most
constexpr int KEPT_CHUNKS = 64;       // ballots a chain keeps: 2048 candidates
constexpr int PIVOT_THREADS = 128;    // threads (chains at most) per block
constexpr long long STAGE_BYTES = 96 * 1024;  // the staged graph, at most
constexpr size_t MAX_SMEM = 232448;   // a block's shared memory on sm_90

enum { REP_DENSE = 0, REP_CSR = 1, REP_BITSET = 2 };

// The graph tensors a move reads; the pointers a representation does not
// have are null. sdeg and soff point at the staged copies in shared memory
// (or are null).
struct GraphView {
  int rep;
  long long n;                  // nodes
  const unsigned char* adj;     // dense: (n, n) bool
  const long long* nbr;         // dense: (n, nbr_cols), ascending rows
  long long nbr_cols;
  const long long* nbr_flat;    // CSR, bitset: ascending rows
  const long long* offsets;     // CSR, bitset: (n,) row starts
  const long long* deg;         // (n,)
  const unsigned int* bits;     // bitset: (n, words)
  long long words;
  const int* sdeg;              // staged deg, int32
  const int* soff;              // staged offsets, int32 (CSR, bitset)
};

__device__ unsigned long long g_chain_runs;

// One thread of the grid's first block adds one run.
__device__ __forceinline__ void count_chain_run() {
  if ((blockIdx.x | threadIdx.x) == 0) atomicAdd(&g_chain_runs, 1ull);
}

// Bytes of the staged graph in shared memory (16-byte aligned): the
// degrees, and for CSR and bitset the row starts, as int32.
__host__ __device__ inline size_t staged_bytes(int stage, int rep,
                                               long long n) {
  if (!stage) return 0;
  return ((size_t)n * 4 * (rep == REP_DENSE ? 1 : 2) + 15) & ~(size_t)15;
}

// Stage the graph (all threads of the block; the caller synchronises).
// Every staged value fits in int32: n * (4 or 8) <= STAGE_BYTES, so an
// offset is below n^2 < 2^31.
__device__ __forceinline__ void stage_graph(GraphView& g, int stage,
                                            int* smem) {
  g.sdeg = g.soff = nullptr;
  if (!stage) return;
  for (long long i = threadIdx.x; i < g.n; i += blockDim.x)
    smem[i] = (int)g.deg[i];
  g.sdeg = smem;
  if (g.rep != REP_DENSE) {
    for (long long i = threadIdx.x; i < g.n; i += blockDim.x)
      smem[g.n + i] = (int)g.offsets[i];
    g.soff = smem + g.n;
  }
}

__device__ __forceinline__ long long deg_of(const GraphView& g, long long x) {
  return g.sdeg ? (long long)g.sdeg[x] : g.deg[x];
}

__device__ __forceinline__ long long off_of(const GraphView& g, long long x) {
  return g.soff ? (long long)g.soff[x] : g.offsets[x];
}

// min(trunc(u * float(d)), d - 1) for d >= 1: the plain move's
// torch.minimum((u * d).long(), d - 1), in float32 as torch computes it.
__device__ __forceinline__ long long scaled_index(float u, long long d) {
  const long long i = __float2ll_rz(__fmul_rn(u, __ll2float_rn(d)));
  return i < d - 1 ? i : d - 1;
}

// Neighbour i of node x (0 <= i < deg[x]).
__device__ __forceinline__ long long row_at(const GraphView& g, long long x,
                                            long long i) {
  return g.rep == REP_DENSE ? g.nbr[x * g.nbr_cols + i]
                            : g.nbr_flat[off_of(g, x) + i];
}

// Whether (r, v) is an edge: a dense lookup, one bit test, or a
// lower-bound binary search of v in r's ascending CSR row.
__device__ __forceinline__ bool has_edge(const GraphView& g, long long r,
                                         long long v) {
  if (g.rep == REP_DENSE) return g.adj[r * g.n + v] != 0;
  if (g.rep == REP_BITSET)
    return (g.bits[r * g.words + (v >> 5)] >> (v & 31)) & 1u;
  const long long* row = g.nbr_flat + off_of(g, r);
  const long long d = deg_of(g, r);
  long long lo = 0, hi = d;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (row[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo < d && row[lo] == v;
}

// The neighbour of x that the uniform u picks, x itself where x is
// isolated: the plain move's _neighbor_at.
__device__ __forceinline__ long long neighbor_at(const GraphView& g,
                                                 long long x, float u) {
  const long long d = deg_of(g, x);
  if (d <= 0) return x;
  return row_at(g, x, scaled_index(u, d));
}

// Whether candidate slot i of the row of u0 (d0 long) is a common
// neighbour of every valid constraint but the first: e holds the chain's
// embedding, sel the S constraint slots of the moving node (-1: none).
__device__ __forceinline__ bool candidate_ok(const GraphView& g,
                                             const long long* e,
                                             const long long* sel, int S,
                                             int first, long long u0,
                                             long long d0, long long i) {
  if (i >= d0) return false;
  const long long v = row_at(g, u0, i);
  for (int s = 0; s < S; ++s) {
    const long long m = sel[s];
    if (s != first && m >= 0 && !has_edge(g, e[m], v)) return false;
  }
  return true;
}

template <int TEAM>
__device__ __forceinline__ void team_sync() {
  if (TEAM == 1)
    __syncwarp();
  else
    __syncthreads();
}

// The new image of the moving node of one Glauber move, on the warp of
// rank 0 of the chain's team (the other warps return 0): the target-th
// valid candidate, target = min(trunc(u total) + 1, total), or fb where
// none is valid (no valid constraint, or no common neighbour). sel: the
// node's S constraint slots; e: the chain in shared memory; kept: the
// chain's KEPT_CHUNKS ballots; counts: TEAM partial counts.
template <int TEAM>
__device__ __forceinline__ long long glauber_pick(
    const GraphView& g, const long long* e, const long long* sel, int S,
    float u, long long fb, unsigned* kept, long long* counts, int rank,
    int lane) {
  int first = -1;
  for (int s = 0; s < S; ++s)
    if (sel[s] >= 0) {
      first = s;
      break;
    }
  if (first < 0) return fb;  // the same on the whole team
  const long long u0 = e[sel[first]];
  const long long d0 = deg_of(g, u0);
  const long long chunks = (d0 + 31) >> 5;
  long long total = 0;
  for (long long t = rank; t < chunks; t += TEAM) {
    const unsigned m = __ballot_sync(
        FULL, candidate_ok(g, e, sel, S, first, u0, d0, 32 * t + lane));
    if (t < KEPT_CHUNKS && lane == 0) kept[t] = m;
    total += __popc(m);
  }
  if (TEAM > 1) {
    if (lane == 0) counts[rank] = total;
    __syncthreads();
    total = 0;
    for (int w = 0; w < TEAM; ++w) total += counts[w];
  } else {
    __syncwarp();
  }
  if (total == 0) return fb;
  if (rank != 0) return 0;
  long long target =
      __float2ll_rz(__fmul_rn(u, __ll2float_rn(total))) + 1;
  if (target > total) target = total;
  // the kept ballots in row order, 32 chunks a step: a warp scan of their
  // counts finds the chunk that holds the target-th valid candidate
  const long long held = chunks < KEPT_CHUNKS ? chunks : KEPT_CHUNKS;
  long long before = 0;
  for (long long t0 = 0; t0 < held; t0 += 32) {
    const unsigned m = t0 + lane < held ? kept[t0 + lane] : 0u;
    int incl = __popc(m);
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += v;
    }
    const unsigned hit = __ballot_sync(FULL, before + incl >= target);
    if (hit) {  // the same on every lane
      const int at = __ffs(hit) - 1;
      unsigned mm = __shfl_sync(FULL, m, at);
      const long long below = __shfl_sync(FULL, incl, at) - __popc(mm);
      for (long long r = target - before - below; r > 1; --r) mm &= mm - 1;
      return row_at(g, u0, 32 * (t0 + at) + __ffs(mm) - 1);
    }
    before += __shfl_sync(FULL, incl, 31);
  }
  // past the kept chunks: each chunk's ballot again, in row order
  for (long long t = held; t < chunks; ++t) {
    unsigned m = __ballot_sync(
        FULL, candidate_ok(g, e, sel, S, first, u0, d0, 32 * t + lane));
    const int count = __popc(m);
    if (before + count >= target) {
      for (long long r = target - before; r > 1; --r) m &= m - 1;
      return row_at(g, u0, 32 * t + __ffs(m) - 1);
    }
    before += count;
  }
  return fb;  // not reached: target <= total
}

// The draws of one Glauber move of chain c, move s of M (zeros past M).
struct GlauberDraws {
  long long j;
  float u;
  long long fb;
};

__device__ __forceinline__ GlauberDraws glauber_draws(
    const long long* jd, const float* ud, const long long* fbd, int C,
    long long c, int s, int M) {
  GlauberDraws d{0, 0.f, 0};
  if (s < M) {
    const long long i = (long long)s * C + c;
    d.j = jd[i];
    d.u = ud[i];
    d.fb = fbd[i];
  }
  return d;
}

// Shared memory of a Glauber block: the staged graph, then each chain's
// embedding (k int64), the team's counts (TEAM int64) and each chain's
// kept ballots.
template <int TEAM>
__host__ __device__ inline size_t glauber_smem(size_t staged, int k) {
  const int chains = TEAM == 1 ? GLAUBER_WARPS : 1;
  return staged + (size_t)chains * k * 8 + (size_t)TEAM * 8 +
         (size_t)chains * KEPT_CHUNKS * 4;
}

// M Glauber moves of each chain (k > 1): move s sets motif node j[s, c] of
// chain c to glauber_pick's node, from u[s, c] and fb[s, c]. A warp per
// chain (TEAM == 1, GLAUBER_WARPS chains a block) or a block of TEAM warps
// per chain.
template <int TEAM>
__global__ void __launch_bounds__(MAX_TEAM * 32)
    chain_glauber_kernel(long long* __restrict__ emb, int C, int k, int M,
                         const long long* __restrict__ jd,
                         const float* __restrict__ ud,
                         const long long* __restrict__ fbd,
                         const long long* __restrict__ tbl, int S,
                         long long* __restrict__ trail, int stage,
                         GraphView g) {
  count_chain_run();
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int CHAINS = TEAM == 1 ? GLAUBER_WARPS : 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = TEAM == 1 ? warp : 0;       // the chain in the block
  const int rank = TEAM == 1 ? 0 : warp;       // the warp in the team
  const int tt = TEAM == 1 ? lane : threadIdx.x;   // the thread in the team
  stage_graph(g, stage, (int*)smem);
  unsigned char* own = smem + staged_bytes(stage, g.rep, g.n);
  long long* e = (long long*)own + (size_t)slot * k;
  long long* counts = (long long*)own + (size_t)CHAINS * k;
  unsigned* kept =
      (unsigned*)(counts + TEAM) + (size_t)slot * KEPT_CHUNKS;
  __syncthreads();  // the staged graph
  const long long c = (long long)blockIdx.x * CHAINS + slot;
  if (c >= C) return;  // a whole warp, and no block barrier follows
  for (int i = tt; i < k; i += TEAM * 32) e[i] = emb[c * k + i];
  team_sync<TEAM>();
  GlauberDraws next = glauber_draws(jd, ud, fbd, C, c, lane, M);
  for (int s0 = 0; s0 < M; s0 += 32) {
    const GlauberDraws cur = next;
    // the next 32 moves' draws load while these 32 run
    next = glauber_draws(jd, ud, fbd, C, c, s0 + 32 + lane, M);
    const int moves = M - s0 < 32 ? M - s0 : 32;
    for (int q = 0; q < moves; ++q) {
      const long long j = __shfl_sync(FULL, cur.j, q);
      const float u = __shfl_sync(FULL, cur.u, q);
      const long long fb = __shfl_sync(FULL, cur.fb, q);
      const long long y = glauber_pick<TEAM>(g, e, tbl + j * S, S, u, fb,
                                             kept, counts, rank, lane);
      team_sync<TEAM>();  // every read of the chain is done
      if (tt == 0) e[j] = y;
      team_sync<TEAM>();
      if (trail) {
        long long* row = trail + (c * M + s0 + q) * k;
        for (int i = tt; i < k; i += TEAM * 32) row[i] = e[i];
      }
    }
  }
  for (int i = tt; i < k; i += TEAM * 32) emb[c * k + i] = e[i];
}

// Shared memory of a pivot block: the staged graph, then each thread's
// tree (k int64, row-major by thread so that a row's accesses fall in
// distinct banks), then the block's chains' last roots.
__host__ __device__ inline size_t pivot_smem(size_t staged, int k) {
  return staged + (size_t)PIVOT_THREADS * (8 * (size_t)k + 8);
}

// M moves of the G chains of a block (G = chains_per_block). A pivot move
// carries only the root from one move to the next: the tree is regrown
// from the new root alone. So the block runs in two phases:
//   1. a thread per chain walks its root M steps (with walk != 0: one
//      Metropolis-Hastings step a move from u_nb, u_acc and jump (M, C);
//      with walk == 0 the root stays emb[c, 0], tree_sample), writing move
//      s's root to trail[c, s, 0];
//   2. every thread of the block regrows trees: one (chain, move) pair at
//      a time, motif nodes 1 .. grow in order, node i the neighbour of its
//      parent's image that u_tree[s, i - 1, c] picks, or, without a
//      parent, the next of the P rows of roots[s, :, c]; the row goes to
//      trail[c, s, 1 ..] and move M - 1's also to emb[c]. Without a
//      trail only move M - 1's tree is regrown.
// The regrowths of a block are independent of each other, so its threads
// (and the blocks of the grid) run M * G dependent chains of loads side by
// side, where a thread a chain ran M of them one after another.
__global__ void __launch_bounds__(PIVOT_THREADS)
    chain_pivot_kernel(long long* __restrict__ emb, int C, int k, int M,
                       int walk, int grow, int P, int chains_per_block,
                       const float* __restrict__ u_nb,
                       const float* __restrict__ u_acc,
                       const long long* __restrict__ jump,
                       const float* __restrict__ u_tree,
                       const long long* __restrict__ roots,
                       const long long* __restrict__ parents,
                       long long* __restrict__ trail, int stage,
                       GraphView g) {
  count_chain_run();
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int N = PIVOT_THREADS;
  const int tid = threadIdx.x;
  const int G = chains_per_block;
  stage_graph(g, stage, (int*)smem);
  long long* el = (long long*)(smem + staged_bytes(stage, g.rep, g.n));
  long long* last = el + (size_t)k * N;         // the chains' last roots
  __syncthreads();  // the staged graph
  const long long c0 = (long long)blockIdx.x * G;
  // 1. the walks
  if (tid < G && c0 + tid < C) {
    const long long c = c0 + tid;
    long long x = emb[c * k];
    float un = 0.f, ua = 0.f;
    long long jp = 0;
    if (walk) {
      un = u_nb[c];
      ua = u_acc[c];
      jp = jump[c];
    }
    for (int s = 0; s < M; ++s) {
      if (walk) {
        const float u1 = un, u2 = ua;
        const long long j1 = jp;
        if (s + 1 < M) {  // the next step's draws load while this one runs
          const long long o = (long long)(s + 1) * C + c;
          un = u_nb[o];
          ua = u_acc[o];
          jp = jump[o];
        }
        const long long dx = deg_of(g, x);
        long long y = neighbor_at(g, x, u1);
        const long long dy = deg_of(g, y);
        const float ratio =
            __fdiv_rn(__ll2float_rn(dx), __ll2float_rn(dy > 1 ? dy : 1));
        if (!(u2 < ratio)) y = x;
        x = dx > 0 ? y : j1;
      }
      if (trail) trail[(c * M + s) * k] = x;
    }
    last[tid] = x;
    emb[c * k] = x;
  }
  __syncthreads();  // the roots
  // 2. the trees
  const int first = trail ? 0 : M - 1;
  const int per = M - first;
  const long long pairs =
      (grow > 0 || (trail && k > 1)) ? (long long)G * per : 0;
#define E(i) el[(size_t)(i) * N + tid]
  for (long long pq = tid; pq < pairs; pq += N) {
    const int gi = (int)(pq / per);
    const int s = first + (int)(pq % per);
    const long long c = c0 + gi;
    if (c >= C) continue;
    long long* row = trail ? trail + (c * M + s) * k : nullptr;
    E(0) = row ? row[0] : last[gi];
    int q = 0;  // rows of roots taken
    for (int i = 1; i <= grow; ++i) {
      const long long p = parents[i - 1];
      E(i) = p < 0 ? roots[((long long)s * P + q++) * C + c]
                   : neighbor_at(g, E(p),
                                 u_tree[((long long)s * grow + i - 1) * C +
                                        c]);
    }
    if (row)
      for (int i = 1; i < k; ++i) row[i] = i <= grow ? E(i) : emb[c * k + i];
    if (s == M - 1)
      for (int i = 1; i <= grow; ++i) emb[c * k + i] = E(i);
  }
#undef E
}

GraphView graph_view(int rep, long long n, const unsigned char* adj,
                     const long long* nbr, long long nbr_cols,
                     const long long* nbr_flat, const long long* offsets,
                     const long long* deg, const unsigned int* bits,
                     long long words) {
  GraphView g;
  g.rep = rep;
  g.n = n;
  g.adj = adj;
  g.nbr = nbr;
  g.nbr_cols = nbr_cols;
  g.nbr_flat = nbr_flat;
  g.offsets = offsets;
  g.deg = deg;
  g.bits = bits;
  g.words = words;
  g.sdeg = g.soff = nullptr;
  return g;
}

// Whether the graph may be staged: the rule of chain_staged in
// motif_kernel.py.
bool stage_fits(int rep, long long n) {
  return n * (rep == REP_DENSE ? 4 : 8) <= STAGE_BYTES;
}

template <int TEAM>
int launch_glauber(long long* emb, int C, int k, int M, const long long* j,
                   const float* u, const long long* fb, const long long* tbl,
                   int S, long long* trail, int stage, const GraphView& g,
                   cudaStream_t stream) {
  constexpr int CHAINS = TEAM == 1 ? GLAUBER_WARPS : 1;
  const size_t smem =
      glauber_smem<TEAM>(staged_bytes(stage, g.rep, g.n), k);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const int e = launch_smem((const void*)chain_glauber_kernel<TEAM>, smem);
  if (e) return e;
  const int blocks = (C + CHAINS - 1) / CHAINS;
  chain_glauber_kernel<TEAM><<<blocks, (TEAM == 1 ? GLAUBER_WARPS : TEAM) * 32,
                               smem, stream>>>(emb, C, k, M, j, u, fb, tbl,
                                               S, trail, stage, g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// M Glauber moves of each of C chains, k > 1, in place on emb (C, k): j, u
// and fallback are the moves' draws (M, C) (int64, float32, int64), tbl the
// (k, slots) int64 motif neighbour table padded with -1; with a trail
// (C, M, k) int64, move s's state goes to row s. warps: 1 (a warp per
// chain), 2, 4 or 8 (a team per chain); stage: the graph staged in shared
// memory (where stage_fits). The graph as in GraphView (rep 0 dense, 1 CSR,
// 2 bitset).
int onmf_chain_glauber(long long* emb, int chains, int k, int moves,
                       const long long* j, const float* u,
                       const long long* fallback, const long long* tbl,
                       int slots, long long* trail, int warps, int stage,
                       int rep, long long n, const unsigned char* adj,
                       const long long* nbr, long long nbr_cols,
                       const long long* nbr_flat, const long long* offsets,
                       const long long* deg, const unsigned int* bits,
                       long long words, void* stream) {
  if (chains < 1 || k < 2 || moves < 1 || slots < 1 || rep < REP_DENSE ||
      rep > REP_BITSET || (stage && !stage_fits(rep, n)))
    return (int)cudaErrorInvalidValue;
  const GraphView g = graph_view(rep, n, adj, nbr, nbr_cols, nbr_flat,
                                 offsets, deg, bits, words);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (warps) {
    case 1:
      return launch_glauber<1>(emb, chains, k, moves, j, u, fallback, tbl,
                               slots, trail, stage, g, s);
    case 2:
      return launch_glauber<2>(emb, chains, k, moves, j, u, fallback, tbl,
                               slots, trail, stage, g, s);
    case 4:
      return launch_glauber<4>(emb, chains, k, moves, j, u, fallback, tbl,
                               slots, trail, stage, g, s);
    case 8:
      return launch_glauber<8>(emb, chains, k, moves, j, u, fallback, tbl,
                               slots, trail, stage, g, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// M moves of each of C chains, in place on emb (C, k): with walk != 0, one
// walk step of the root (u_nb, u_acc, jump: (M, C)); then motif nodes
// 1 .. grow regrown from u_tree (M, grow, C) float32 and roots (M, P, C)
// int64 (the parentless nodes in node order), parents (grow,) int64 (-1:
// none), grow < k. chains_per_block: the chains of a block (the chains
// spread over the SMs: chain_pivot_chains in motif_kernel.py). Trail and
// stage as in onmf_chain_glauber.
int onmf_chain_pivot(long long* emb, int chains, int k, int moves, int walk,
                     int grow, int roots_per_move, int chains_per_block,
                     const float* u_nb, const float* u_acc,
                     const long long* jump, const float* u_tree,
                     const long long* roots, const long long* parents,
                     long long* trail, int stage, int rep, long long n,
                     const unsigned char* adj, const long long* nbr,
                     long long nbr_cols, const long long* nbr_flat,
                     const long long* offsets, const long long* deg,
                     const unsigned int* bits, long long words,
                     void* stream) {
  if (chains < 1 || k < 1 || moves < 1 || grow < 0 || grow >= k ||
      roots_per_move < 0 || roots_per_move > grow || chains_per_block < 1 ||
      chains_per_block > PIVOT_THREADS || rep < REP_DENSE ||
      rep > REP_BITSET || (stage && !stage_fits(rep, n)))
    return (int)cudaErrorInvalidValue;
  const GraphView g = graph_view(rep, n, adj, nbr, nbr_cols, nbr_flat,
                                 offsets, deg, bits, words);
  const size_t smem = pivot_smem(staged_bytes(stage, rep, n), k);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const int e = launch_smem((const void*)chain_pivot_kernel, smem);
  if (e) return e;
  const int blocks = (chains + chains_per_block - 1) / chains_per_block;
  chain_pivot_kernel<<<blocks, PIVOT_THREADS, smem, (cudaStream_t)stream>>>(
      emb, chains, k, moves, walk, grow, roots_per_move, chains_per_block,
      u_nb, u_acc, jump, u_tree, roots, parents, trail, stage, g);
  return (int)cudaGetLastError();
}

// Runs of the two kernels since onmf_chain_reset_runs, once every launch
// before it on any stream has finished.
int onmf_chain_read_runs(unsigned long long* out) {
  int e = (int)cudaDeviceSynchronize();
  if (e) return e;
  return (int)cudaMemcpyFromSymbol(out, g_chain_runs, sizeof(g_chain_runs));
}

int onmf_chain_reset_runs(void) {
  int e = (int)cudaDeviceSynchronize();
  if (e) return e;
  const unsigned long long zero = 0;
  return (int)cudaMemcpyToSymbol(g_chain_runs, &zero, sizeof(zero));
}

}  // extern "C"
