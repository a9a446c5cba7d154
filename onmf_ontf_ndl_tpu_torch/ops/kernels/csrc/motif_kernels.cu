// Hopper (sm_90a) kernels for the moves of the motif chains of network
// dictionary learning (samplers/motif.py).
//
// No Pallas kernel stands behind them: the JAX package runs its chains as
// one jitted program (onmf_ontf_ndl_tpu/samplers/motif.py:653-700, a
// lax.scan over the moves, vmapped over the chains), and these kernels are
// what stands for that program's arithmetic on this card. Each launch
// moves every chain once, in place on the (C, k) int64 embeddings:
//   onmf_chain_glauber <- glauber_update (k > 1): one warp per chain;
//   onmf_chain_pivot   <- rw_update, pivot_update and tree_sample: the
//                         Metropolis-Hastings walk of the root (or not),
//                         then the regrowth of the tree, one thread per
//                         chain.
// Plain C entry points, bound from Python with ctypes; each returns
// cudaGetLastError() after its launch (0 = success).
//
// Draws: the random numbers come from torch's generator, drawn by the
// caller in the plain move's order (motif.py's draw functions), so that a
// kernel's chains equal the plain moves' bit for bit. The kernels repeat
// the plain move's float32 arithmetic exactly: `(u * d).long()` is
// __fmul_rn of the uniform and the int64 converted to float with rounding
// to nearest, then truncation; the acceptance `u < dx / dy` is __fdiv_rn.
// Both are written as intrinsics so that no contraction into an FMA
// changes a rounding; the library builds without --use_fast_math.
//
// Graphs, in the three representations of data/graphs.py, with rows that
// ascend in all three: dense (adj (N, N) bool, nbr (N, cols) int64 padded
// with 0), CSR (nbr_flat, offsets, deg; membership by a lower-bound binary
// search of the row) and bitset (the CSR arrays and the (N, words) uint32
// rows of bits; membership is one bit test).
//
// What bounds them on this card: the latency of dependent loads, not bytes
// or operations. A Glauber move reads its chain's constraint images, the
// candidate row of the first valid constraint and, per candidate, a test
// against each other constraint (a binary search: log2(deg) dependent
// loads); the pivot's regrowth is a chain of k - 1 dependent pairs of
// loads (the parent's degree, then its neighbour). What the design does
// about it: a Glauber move spreads its candidate row over the 32 lanes of
// a warp (a hub of the smoke's Barabasi-Albert graph has ~800 neighbours;
// one thread scanning it would set the move's time), counts the valid
// candidates in row order with __ballot_sync and __popc, keeps the first
// 32 chunks' ballots in the lanes' registers so that the rank-select reads
// them back without testing again, and picks the target-th valid
// candidate from the ballot of its chunk. The pivot's regrowth is
// sequential in the tree, so it takes one thread per chain and many
// chains per block.
//
// Each kernel counts its runs on the device (count_chain_run) with a
// counter of this source's own: onmf_chain_read_runs and
// onmf_chain_reset_runs read and zero it. A run replayed from a CUDA graph
// counts too.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int GLAUBER_WARPS = 4;      // chains (warps) per block
constexpr int PIVOT_THREADS = 128;    // chains per block

enum { REP_DENSE = 0, REP_CSR = 1, REP_BITSET = 2 };

// The graph tensors a move reads; the pointers a representation does not
// have are null.
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
};

__device__ unsigned long long g_chain_runs;

// One thread of the grid's first block adds one run.
__device__ __forceinline__ void count_chain_run() {
  if ((blockIdx.x | threadIdx.x) == 0) atomicAdd(&g_chain_runs, 1ull);
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
                            : g.nbr_flat[g.offsets[x] + i];
}

// Whether (r, v) is an edge: a dense lookup, one bit test, or a
// lower-bound binary search of v in r's ascending CSR row.
__device__ __forceinline__ bool has_edge(const GraphView& g, long long r,
                                         long long v) {
  if (g.rep == REP_DENSE) return g.adj[r * g.n + v] != 0;
  if (g.rep == REP_BITSET)
    return (g.bits[r * g.words + (v >> 5)] >> (v & 31)) & 1u;
  const long long* row = g.nbr_flat + g.offsets[r];
  const long long d = g.deg[r];
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
  const long long d = g.deg[x];
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

// One Glauber move of each chain (k > 1), a warp per chain: motif node
// j = jd[c] takes the target-th valid candidate, target =
// min(trunc(u total) + 1, total), or the fallback fb[c] where none is
// valid (no valid constraint, or no common neighbour).
__global__ void __launch_bounds__(GLAUBER_WARPS * 32)
    chain_glauber_kernel(long long* __restrict__ emb, int C, int k,
                         const long long* __restrict__ jd,
                         const float* __restrict__ ud,
                         const long long* __restrict__ fbd,
                         const long long* __restrict__ tbl, int S,
                         GraphView g) {
  count_chain_run();
  const int lane = threadIdx.x & 31;
  const long long c =
      (long long)blockIdx.x * GLAUBER_WARPS + (threadIdx.x >> 5);
  if (c >= C) return;  // the whole warp
  long long* e = emb + c * k;
  const long long j = jd[c];
  const long long* sel = tbl + j * S;
  int first = -1;
  for (int s = 0; s < S; ++s)
    if (sel[s] >= 0) {
      first = s;
      break;
    }
  long long total = 0, y = 0;
  if (first >= 0) {
    const long long u0 = e[sel[first]];
    const long long d0 = g.deg[u0];
    const long long chunks = (d0 + 31) >> 5;
    unsigned kept = 0;  // lane t keeps the ballot of chunk t < 32
    for (long long t = 0; t < chunks; ++t) {
      const unsigned m = __ballot_sync(
          FULL, candidate_ok(g, e, sel, S, first, u0, d0, 32 * t + lane));
      if (t == lane) kept = m;
      total += __popc(m);
    }
    if (total > 0) {
      long long target =
          __float2ll_rz(__fmul_rn(ud[c], __ll2float_rn(total))) + 1;
      if (target > total) target = total;
      long long before = 0;
      for (long long t = 0; t < chunks; ++t) {
        unsigned m =
            t < 32 ? __shfl_sync(FULL, kept, (int)t)
                   : __ballot_sync(FULL, candidate_ok(g, e, sel, S, first,
                                                      u0, d0, 32 * t + lane));
        const int count = __popc(m);
        if (before + count >= target) {  // the same on every lane
          for (long long r = target - before; r > 1; --r) m &= m - 1;
          y = row_at(g, u0, 32 * t + __ffs(m) - 1);
          break;
        }
        before += count;
      }
    }
  }
  if (lane == 0) e[j] = total > 0 ? y : fbd[c];
}

// One walk step of each chain's root (walk != 0), then the regrowth of
// motif nodes 1 .. grow in order, a thread per chain: node i takes the
// neighbour of its parent's image that u_tree[i - 1, c] picks, or, where
// it has no parent, the next row of roots. With walk == 0 the root is
// emb[c, 0] as it stands (tree_sample).
__global__ void __launch_bounds__(PIVOT_THREADS)
    chain_pivot_kernel(long long* __restrict__ emb, int C, int k, int walk,
                       int grow, const float* __restrict__ u_nb,
                       const float* __restrict__ u_acc,
                       const long long* __restrict__ jump,
                       const float* __restrict__ u_tree,
                       const long long* __restrict__ roots,
                       const long long* __restrict__ parents, GraphView g) {
  count_chain_run();
  const long long c = (long long)blockIdx.x * PIVOT_THREADS + threadIdx.x;
  if (c >= C) return;
  long long* e = emb + c * k;
  if (walk) {
    const long long x = e[0];
    const long long dx = g.deg[x];
    long long y = neighbor_at(g, x, u_nb[c]);
    const long long dy = g.deg[y];
    const float ratio =
        __fdiv_rn(__ll2float_rn(dx), __ll2float_rn(dy > 1 ? dy : 1));
    if (!(u_acc[c] < ratio)) y = x;
    e[0] = dx > 0 ? y : jump[c];
  }
  long long q = 0;  // rows of roots taken
  for (int i = 1; i <= grow; ++i) {
    const long long p = parents[i - 1];
    e[i] = p < 0 ? roots[(q++) * C + c]
                 : neighbor_at(g, e[p], u_tree[(long long)(i - 1) * C + c]);
  }
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
  return g;
}

}  // namespace

extern "C" {

// One Glauber move of each of C chains, k > 1, in place on emb (C, k):
// j, u and fallback are the move's draws (C,) (int64, float32, int64), tbl
// the (k, slots) int64 motif neighbour table padded with -1; the graph as
// in GraphView (rep 0 dense, 1 CSR, 2 bitset).
int onmf_chain_glauber(long long* emb, int chains, int k, const long long* j,
                       const float* u, const long long* fallback,
                       const long long* tbl, int slots, int rep, long long n,
                       const unsigned char* adj, const long long* nbr,
                       long long nbr_cols, const long long* nbr_flat,
                       const long long* offsets, const long long* deg,
                       const unsigned int* bits, long long words,
                       void* stream) {
  if (chains < 1 || k < 2 || slots < 1 || rep < REP_DENSE ||
      rep > REP_BITSET)
    return (int)cudaErrorInvalidValue;
  const GraphView g = graph_view(rep, n, adj, nbr, nbr_cols, nbr_flat,
                                 offsets, deg, bits, words);
  const int blocks = (chains + GLAUBER_WARPS - 1) / GLAUBER_WARPS;
  chain_glauber_kernel<<<blocks, GLAUBER_WARPS * 32, 0,
                         (cudaStream_t)stream>>>(emb, chains, k, j, u,
                                                 fallback, tbl, slots, g);
  return (int)cudaGetLastError();
}

// With walk != 0, one walk step of the root of each of C chains (u_nb,
// u_acc, jump: the step's draws, (C,)); then motif nodes 1 .. grow regrown
// from u_tree (grow, C) float32 and roots (parentless nodes, C) int64,
// parents (grow,) int64 (-1: none). In place on emb (C, k), grow < k.
int onmf_chain_pivot(long long* emb, int chains, int k, int walk, int grow,
                     const float* u_nb, const float* u_acc,
                     const long long* jump, const float* u_tree,
                     const long long* roots, const long long* parents,
                     int rep, long long n, const unsigned char* adj,
                     const long long* nbr, long long nbr_cols,
                     const long long* nbr_flat, const long long* offsets,
                     const long long* deg, const unsigned int* bits,
                     long long words, void* stream) {
  if (chains < 1 || k < 1 || grow < 0 || grow >= k || rep < REP_DENSE ||
      rep > REP_BITSET)
    return (int)cudaErrorInvalidValue;
  const GraphView g = graph_view(rep, n, adj, nbr, nbr_cols, nbr_flat,
                                 offsets, deg, bits, words);
  const int blocks = (chains + PIVOT_THREADS - 1) / PIVOT_THREADS;
  chain_pivot_kernel<<<blocks, PIVOT_THREADS, 0, (cudaStream_t)stream>>>(
      emb, chains, k, walk, grow, u_nb, u_acc, jump, u_tree, roots, parents,
      g);
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
