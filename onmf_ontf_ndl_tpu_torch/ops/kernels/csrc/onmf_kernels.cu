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
// Each coder kernel comes in two instantiations of the same device code,
// chosen by the wrapper from the rank alone:
//   kGlobal = false: A, the (r, TN) tiles and the (r, r) Grams in one block's
//     shared memory, one block per tile (the small ranks: the tiles and Grams
//     must fit 227 KB);
//   kGlobal = true: A read from device memory (through L2: 6 MiB at the
//     JAX kernels' largest rank), the tiles, the Grams and the power vectors
//     in a device workspace, one slice per resident block, the grid striding
//     over the tiles. coder_sweeps keeps each column in the output itself.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

// Columns per block. For the early-stop kernel the block is the stopping
// tile: the relative-change rule is decided on these TN columns together.
constexpr int TN = 128;
// Row stride of the shared (r, TN) tiles. The odd pad keeps the Gram loop
// (lanes on different rows, same column) off one bank. Workspace tiles use
// TN: their Gram loop reads along rows.
constexpr int HS = TN + 1;
// Largest rank of the shared-memory FISTA kernel: its thread-local new
// column hn[] (the workspace kernel keeps that column in its slice).
constexpr int FISTA_MAX_RANK = 128;

__device__ __forceinline__ float warp_sum(float x) {
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int m = 16; m > 0; m >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, m));
  return x;
}

// One Gauss-Seidel sweep of the nonnegative-LASSO rows over one column:
//   h[k] <- max(0, h[k] - rs / (A_kk + 1) * (A[k, :] h - b[k] + alpha)).
// h: the column, element k at h[k * stride] (shared memory or device
// memory); A in shared or device memory (every thread reads the same
// A[k, j]: a broadcast); b[k] at bcol[k * n] in device memory.
template <typename Stride>
__device__ __forceinline__ void sweep_column(const float* __restrict__ As,
                                             const float* __restrict__ bcol,
                                             float* h, Stride stride, int r,
                                             int n, float alpha, float rs) {
  for (int k = 0; k < r; ++k) {
    const float* a = As + (size_t)k * r;
    float g = 0.f;
    for (int j = 0; j < r; ++j) g = fmaf(a[j], h[j * stride], g);
    g = g - __ldg(bcol + (size_t)k * n) + alpha;
    const float step = rs / (a[k] + 1.0f);
    h[k * stride] = fmaxf(h[k * stride] - step * g, 0.f);
  }
}

// kGlobal: A is read from device memory and each column is swept in place
// in the output H (consecutive threads, consecutive columns: coalesced).
template <bool kGlobal>
__global__ void coder_sweeps_kernel(const float* __restrict__ A,
                                    const float* __restrict__ B,
                                    const float* __restrict__ H0,
                                    float* __restrict__ H, int r, int n,
                                    float alpha, int sub_iter) {
  extern __shared__ float smem[];
  const int t = threadIdx.x;
  const int c = blockIdx.x * TN + t;
  if constexpr (kGlobal) {
    if (c >= n) return;
    float* h = H + c;
    for (int k = 0; k < r; ++k) h[(size_t)k * n] = H0[(size_t)k * n + c];
    for (int i = 0; i < sub_iter; ++i)
      sweep_column(A, B + c, h, (size_t)n, r, n, alpha,
                   1.0f / sqrtf((float)i + 10.0f));
  } else {
    float* As = smem;          // (r, r)
    float* Hs = As + r * r;    // (r, TN): column t at Hs[k * TN + t]
    for (int i = t; i < r * r; i += blockDim.x) As[i] = A[i];
    __syncthreads();
    if (c >= n) return;  // no barrier below: columns are independent
    float* h = Hs + t;
    for (int k = 0; k < r; ++k) h[k * TN] = H0[(size_t)k * n + c];
    for (int i = 0; i < sub_iter; ++i)
      sweep_column(As, B + c, h, TN, r, n, alpha,
                   1.0f / sqrtf((float)i + 10.0f));
    for (int k = 0; k < r; ++k) H[(size_t)k * n + c] = h[k * TN];
  }
}

// Warm power iteration on both Grams at once (one warp), `iters` steps from
// the vectors in vd/vh (updated in place), then their Rayleigh quotients.
// Mirrors _lambda_max_warm_pair of the TPU kernel.
__device__ void warm_pair(const float* Gd, const float* Gh, float* vd,
                          float* vh, float* wd, float* wh, int r, int iters,
                          float* lam_d, float* lam_h) {
  const int lane = threadIdx.x & 31;
  for (int it = 0; it < iters; ++it) {
    float sd = 0.f, sh = 0.f;
    for (int k = lane; k < r; k += 32) {
      float ad = 0.f, ah = 0.f;
      for (int l = 0; l < r; ++l) {
        ad = fmaf(Gd[k * r + l], vd[l], ad);
        ah = fmaf(Gh[k * r + l], vh[l], ah);
      }
      wd[k] = ad;
      wh[k] = ah;
      sd += ad * ad;
      sh += ah * ah;
    }
    sd = warp_sum(sd);
    sh = warp_sum(sh);
    const float nd = fmaxf(sqrtf(sd), 1e-30f);
    const float nh = fmaxf(sqrtf(sh), 1e-30f);
    __syncwarp();
    for (int k = lane; k < r; k += 32) {
      vd[k] = wd[k] / nd;
      vh[k] = wh[k] / nh;
    }
    __syncwarp();
  }
  float qd = 0.f, pd = 0.f, qh = 0.f, ph = 0.f;
  for (int k = lane; k < r; k += 32) {
    float ad = 0.f, ah = 0.f;
    for (int l = 0; l < r; ++l) {
      ad = fmaf(Gd[k * r + l], vd[l], ad);
      ah = fmaf(Gh[k * r + l], vh[l], ah);
    }
    qd += vd[k] * ad;
    pd += vd[k] * vd[k];
    qh += vh[k] * ah;
    ph += vh[k] * vh[k];
  }
  *lam_d = warp_sum(qd) / fmaxf(warp_sum(pd), 1e-30f);
  *lam_h = warp_sum(qh) / fmaxf(warp_sum(ph), 1e-30f);
}

// Certified upper bound on lambda_max of a PSD matrix: min(trace, max
// absolute row sum). One warp.
__device__ float psd_lambda_ub(const float* G, int r) {
  const int lane = threadIdx.x & 31;
  float tr = 0.f, rowmax = 0.f;
  for (int k = lane; k < r; k += 32) {
    tr += G[k * r + k];
    float s = 0.f;
    for (int l = 0; l < r; ++l) s += fabsf(G[k * r + l]);
    rowmax = fmaxf(rowmax, s);
  }
  return fminf(warp_sum(tr), warp_max(rowmax));
}

// Grams over one tile's TN columns, upper triangle (k <= l) mirrored:
// Gd = D D^T and Gh = O O^T, with D = P - O when kDiff and D = P otherwise.
// Columns outside the batch hold 0 in P and O.
// kGlobal = false (shared tiles, row stride HS): one pair per thread, the
// thread summing over the columns. kGlobal = true (workspace tiles, row
// stride TN): one pair per warp, the lanes over the columns, so that each
// load is one contiguous row segment.
template <bool kDiff, bool kGlobal>
__device__ void tile_grams(const float* P, const float* O, float* Gd,
                           float* Gh, int r) {
  if constexpr (kGlobal) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    for (int k = 0; k < r; ++k)
      for (int l = k + warp; l < r; l += nwarps) {
        float gd = 0.f, gh = 0.f;
        for (int cc = lane; cc < TN; cc += 32) {
          const float ok = O[k * TN + cc], ol = O[l * TN + cc];
          const float dk = kDiff ? P[k * TN + cc] - ok : P[k * TN + cc];
          const float dl = kDiff ? P[l * TN + cc] - ol : P[l * TN + cc];
          gd = fmaf(dk, dl, gd);
          gh = fmaf(ok, ol, gh);
        }
        gd = warp_sum(gd);
        gh = warp_sum(gh);
        if (lane == 0) {
          Gd[k * r + l] = gd;
          Gd[l * r + k] = gd;
          Gh[k * r + l] = gh;
          Gh[l * r + k] = gh;
        }
      }
  } else {
    int k = 0, l = threadIdx.x;
    while (k < r && l >= r) { l = l - r + k + 1; ++k; }
    while (k < r) {
      float gd = 0.f, gh = 0.f;
      for (int cc = 0; cc < TN; ++cc) {
        const float ok = O[k * HS + cc], ol = O[l * HS + cc];
        const float dk = kDiff ? P[k * HS + cc] - ok : P[k * HS + cc];
        const float dl = kDiff ? P[l * HS + cc] - ol : P[l * HS + cc];
        gd = fmaf(dk, dl, gd);
        gh = fmaf(ok, ol, gh);
      }
      Gd[k * r + l] = gd;
      Gd[l * r + k] = gd;
      Gh[k * r + l] = gh;
      Gh[l * r + k] = gh;
      l += blockDim.x;
      while (k < r && l >= r) { l = l - r + k + 1; ++k; }
    }
  }
}

// The per-tile stop (_stopping_update), decided by one warp:
// sigma(delta)^2 <= stop^2 sigma(H_old)^2, certified bounds first. One warm
// power step gives Rayleigh lower bounds, trace/Gershgorin give upper
// bounds; only in the band between them do pi_iters more warm steps decide.
// vd/vh carry the eigenvector estimates from sweep to sweep. Every lane
// returns the same decision (1 = converged).
__device__ int stop_decision(const float* Gd, const float* Gh, const float* v0,
                             float* vd, float* vh, float* wd, float* wh,
                             int r, float stop2, int pi_iters) {
  for (int k = threadIdx.x & 31; k < r; k += 32) {
    vd[k] += 0.05f * v0[k];
    vh[k] += 0.05f * v0[k];
  }
  __syncwarp();
  float lb_d, lb_h;
  warm_pair(Gd, Gh, vd, vh, wd, wh, r, 1, &lb_d, &lb_h);
  const float ub_d = psd_lambda_ub(Gd, r);
  const float ub_h = psd_lambda_ub(Gh, r);
  const bool conv_certain = ub_d <= stop2 * lb_h;
  const bool notconv_certain = lb_d > stop2 * ub_h;
  int cv = conv_certain;
  if (!conv_certain && !notconv_certain) {
    float num, den;
    warm_pair(Gd, Gh, vd, vh, wd, wh, r, pi_iters, &num, &den);
    cv = num <= stop2 * den;
  }
  return cv;
}

// Start vectors of the power steps: _fixed_start, an unstructured positive
// vector, in v0, vd and vh.
__device__ void init_power_vectors(float* v0, float* vd, float* vh, int r) {
  for (int k = threadIdx.x; k < r; k += blockDim.x) {
    v0[k] = 0.5f + (float)((k * 40503) % 65536) / 65536.0f;
    vd[k] = v0[k];
    vh[k] = v0[k];
  }
}

// Floats of one block's workspace slice in the kGlobal coder_es_kernel:
// the iterate and old-iterate tiles, both Grams and five r-vectors.
__host__ __device__ size_t es_slice_floats(int r) {
  return 2 * (size_t)r * TN + 2 * (size_t)r * r + 5 * (size_t)r;
}

template <bool kGlobal>
__global__ void coder_es_kernel(const float* __restrict__ A,
                                const float* __restrict__ B,
                                const float* __restrict__ H0,
                                float* __restrict__ H, int r, int n,
                                float alpha, float stop, int sub_iter,
                                int pi_iters, float* __restrict__ ws) {
  extern __shared__ float smem[];
  constexpr int S = kGlobal ? TN : HS;  // tile row stride
  const float* As;
  float* Hs;                 // (r, S) iterate, column t at Hs[k * S + t]
  if constexpr (kGlobal) {
    As = A;
    Hs = ws + (size_t)blockIdx.x * es_slice_floats(r);
  } else {
    As = smem;               // (r, r)
    Hs = smem + r * r;
    for (int i = threadIdx.x; i < r * r; i += blockDim.x) smem[i] = A[i];
  }
  float* Os = Hs + r * S;    // (r, S) iterate before the current sweep
  float* Gd = Os + r * S;    // (r, r) delta Gram
  float* Gh = Gd + r * r;    // (r, r) iterate Gram
  float* v0 = Gh + r * r;    // (r) fixed start vector
  float* vd = v0 + r;        // (r) carried eigenvector estimates
  float* vh = vd + r;
  float* wd = vh + r;        // (r) scratch
  float* wh = wd + r;
  __shared__ int conv;

  const int t = threadIdx.x;
  const float stop2 = stop * stop;
  const int tiles = (n + TN - 1) / TN;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int c = tile * TN + t;
    const bool active = c < n;
    for (int k = 0; k < r; ++k) {
      Hs[k * S + t] = active ? H0[(size_t)k * n + c] : 0.f;
      Os[k * S + t] = Hs[k * S + t];
    }
    init_power_vectors(v0, vd, vh, r);
    if (t == 0) conv = 0;
    __syncthreads();

    for (int i = 0; i < sub_iter; ++i) {
      if (conv) break;  // read after a barrier: uniform over the block
      if (active) {
        float* h = Hs + t;
        for (int k = 0; k < r; ++k) Os[k * S + t] = h[k * S];
        sweep_column(As, B + c, h, S, r, n, alpha,
                     1.0f / sqrtf((float)i + 10.0f));
      }
      __syncthreads();
      tile_grams<true, kGlobal>(Hs, Os, Gd, Gh, r);
      __syncthreads();
      if (t < 32) {
        const int cv = stop_decision(Gd, Gh, v0, vd, vh, wd, wh, r, stop2,
                                     pi_iters);
        if (t == 0) conv = cv;
      }
      __syncthreads();
    }
    if (active)
      for (int k = 0; k < r; ++k) H[(size_t)k * n + c] = Hs[k * S + t];
    __syncthreads();  // conv and the tiles are reused by the next tile
  }
}

// The FISTA step inv_L = 1 / (1.02 lambda_max(A) + 1e-12), lambda_max from
// `iters` power steps from the fixed start (_lambda_max), by one warp.
// warm_pair runs the chain twice on A; only one result is kept.
__global__ void fista_step_size_kernel(const float* __restrict__ A, int r,
                                       int iters, float* __restrict__ inv_L) {
  extern __shared__ float smem[];
  float* v0 = smem;  // five (r) vectors, as the stop decision lays them out
  float* vd = v0 + r;
  float* vh = vd + r;
  float* wd = vh + r;
  float* wh = wd + r;
  init_power_vectors(v0, vd, vh, r);
  __syncwarp();
  float lam, unused;
  warm_pair(A, A, vd, vh, wd, wh, r, iters, &lam, &unused);
  if (threadIdx.x == 0) *inv_L = 1.f / (lam * 1.02f + 1e-12f);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A transposed into (r, R4) rows (R4 = r rounded up to a multiple of 4,
// zero padded), bf16-rounded when kBf16: the layout the FISTA kernel reads.
// The workspace FISTA kernel reads it from device memory; the shared one
// builds the same table in shared memory itself.
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

// Floats of the kGlobal FISTA workspace: the shared (r, R4) table of A^T
// first, then one slice per block (the H, Y and new-column tiles, and with
// use_stopping both Grams and five r-vectors).
__host__ __device__ size_t fista_head_floats(int r) {
  return (size_t)r * ((r + 3) & ~3);
}

__host__ __device__ size_t fista_slice_floats(int r, int use_stopping) {
  size_t floats = 3 * (size_t)r * TN;
  if (use_stopping) floats += 2 * (size_t)r * r + 5 * (size_t)r;
  return floats;
}

// FISTA on one tile of TN columns, one thread per column:
//   Hn = max(0, Y - inv_L (A Y - B + alpha)),  t' = (1 + sqrt(1 + 4 t^2)) / 2,
//   Y  = Hn + (t - 1) / t' (Hn - H).
// A (transposed, rows padded to R4 = a multiple of 4), H and Y live in
// shared memory (kGlobal: A^T in device memory, H and Y in the block's
// workspace slice); a thread reads A by broadcast and only its own columns
// of H and Y. It forms four rows of A Y at a time: one float4 of A^T and one
// element of Y per four multiply-adds, each row summed over j in order. The
// new column is formed in hn[] (thread-local; kGlobal: a third tile of the
// slice) because every row of the product needs the whole old Y column.
// kBf16 rounds A and Y to bf16 before the multiply-add (accumulation stays
// f32). With use_stopping the tile stops as coder_es_kernel does, on the
// Grams of the step delta (kept in the spent Y slot) and of the old H; the
// momentum t is per tile and stops with it. What bounds it: r^2
// multiply-adds per column and iteration, each with a shared-memory (kGlobal:
// L1) load, in CUDA cores; the product is a real (r, r) x (r, TN) matrix
// product, so tensor cores (mma/wgmma) are the next step.
template <bool kBf16, bool kGlobal>
__global__ void fista_kernel(const float* __restrict__ A,
                             const float* __restrict__ B,
                             const float* __restrict__ H0,
                             float* __restrict__ H, int r, int n,
                             float alpha, const float* __restrict__ inv_L_ptr,
                             float stop, int sub_iter, int use_stopping,
                             int pi_iters, float* __restrict__ ws) {
  extern __shared__ float smem[];
  constexpr int S = kGlobal ? TN : HS;  // tile row stride
  const int R4 = (r + 3) & ~3;
  const int t = threadIdx.x;
  const float* At;           // (r, R4): At[j * R4 + k] = A[k, j]
  float* Hs;                 // (r, S) iterate
  float* hn;                 // the new column, element k at hn[k * HN]
  constexpr int HN = kGlobal ? TN : 1;
  float hn_local[kGlobal ? 1 : FISTA_MAX_RANK];
  if constexpr (kGlobal) {
    At = ws;
    Hs = ws + fista_head_floats(r)
         + (size_t)blockIdx.x * fista_slice_floats(r, use_stopping);
  } else {
    fill_At<kBf16>(A, smem, r, t, blockDim.x);
    At = smem;
    Hs = smem + r * R4;
  }
  float* Ys = Hs + r * S;    // (r, S) extrapolated point; the step delta
                             // during the stop test
  float* Gd;                 // stop mode only: (r, r) delta Gram,
  if constexpr (kGlobal) {
    hn = Ys + r * S + t;     // (r, TN) new columns
    Gd = Ys + 2 * r * S;
  } else {
    hn = hn_local;
    Gd = Ys + r * S;
  }
  float* Gh = Gd + r * r;    // (r, r) iterate Gram,
  float* v0 = Gh + r * r;    // and five (r) vectors as in coder_es_kernel
  float* vd = v0 + r;
  float* vh = vd + r;
  float* wd = vh + r;
  float* wh = wd + r;
  __shared__ int conv;

  const float inv_L = *inv_L_ptr;
  const float stop2 = stop * stop;
  const int tiles = (n + TN - 1) / TN;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int c = tile * TN + t;
    const bool active = c < n;
    for (int k = 0; k < r; ++k) {
      const float h = active ? H0[(size_t)k * n + c] : 0.f;
      Hs[k * S + t] = h;
      Ys[k * S + t] = h;
    }
    if (use_stopping) init_power_vectors(v0, vd, vh, r);
    if (t == 0) conv = 0;
    float tmom = 1.f;
    __syncthreads();

    for (int i = 0; i < sub_iter; ++i) {
      if (conv) break;  // set only in stop mode, read after a barrier
      const float tn = 0.5f * (1.f + sqrtf(1.f + 4.f * tmom * tmom));
      const float mom = (tmom - 1.f) / tn;
      tmom = tn;
      if (active) {
        const float* y = Ys + t;
        for (int k0 = 0; k0 < r; k0 += 4) {
          float g[4] = {0.f, 0.f, 0.f, 0.f};
          for (int j = 0; j < r; ++j) {
            const float yj = kBf16 ? bf16_round(y[j * S]) : y[j * S];
            const float4 a =
                *reinterpret_cast<const float4*>(At + j * R4 + k0);
            g[0] = fmaf(a.x, yj, g[0]);
            g[1] = fmaf(a.y, yj, g[1]);
            g[2] = fmaf(a.z, yj, g[2]);
            g[3] = fmaf(a.w, yj, g[3]);
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int k = k0 + q;
            if (k < r)
              hn[k * HN] = fmaxf(
                  y[k * S] - inv_L * (g[q] - __ldg(B + (size_t)k * n + c)
                                      + alpha), 0.f);
          }
        }
      }
      if (!use_stopping) {  // columns are independent: no barrier
        if (active)
          for (int k = 0; k < r; ++k) {
            const float h = Hs[k * S + t];
            Hs[k * S + t] = hn[k * HN];
            Ys[k * S + t] = hn[k * HN] + mom * (hn[k * HN] - h);
          }
        continue;
      }
      for (int k = 0; k < r; ++k)
        Ys[k * S + t] = active ? hn[k * HN] - Hs[k * S + t] : 0.f;
      __syncthreads();
      tile_grams<false, kGlobal>(Ys, Hs, Gd, Gh, r);
      __syncthreads();
      if (t < 32) {
        const int cv = stop_decision(Gd, Gh, v0, vd, vh, wd, wh, r, stop2,
                                     pi_iters);
        if (t == 0) conv = cv;
      }
      // the step applies in the sweep that converges too
      if (active)
        for (int k = 0; k < r; ++k) {
          const float d = Ys[k * S + t];
          Hs[k * S + t] = hn[k * HN];
          Ys[k * S + t] = hn[k * HN] + mom * d;
        }
      __syncthreads();
    }
    if (active)
      for (int k = 0; k < r; ++k) H[(size_t)k * n + c] = Hs[k * S + t];
    __syncthreads();  // conv and the tiles are reused by the next tile
  }
}

// One block. Sequential over the r columns, threads over the d rows; each
// thread owns rows tid, tid + blockDim, ... of W, so only the column norm
// needs the whole block. A[:, j] is read by column, as dict_update_bcd does.
__global__ void dict_update_kernel(const float* __restrict__ W_in,
                                   const float* __restrict__ A,
                                   const float* __restrict__ B,
                                   float* __restrict__ W, int d, int r) {
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

int launch_smem(const void* fn, size_t smem) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch check reports it
      return (int)e;
    }
  }
  return 0;
}

template <bool kBf16>
int launch_fista(const float* A, const float* B, const float* H0, float* H,
                 int r, int n, float alpha, const float* inv_L, float stop,
                 int sub_iter, int use_stopping, int pi_iters, float* ws,
                 int blocks, cudaStream_t stream);

}  // namespace

extern "C" {

// Shared memory bytes each shared-memory coder kernel needs at rank r.
size_t onmf_coder_sweeps_smem(int r) {
  return sizeof(float) * ((size_t)r * r + (size_t)r * TN);
}

size_t onmf_coder_sweeps_earlystop_smem(int r) {
  return sizeof(float) * (3 * (size_t)r * r + 2 * (size_t)r * HS + 5 * (size_t)r);
}

size_t onmf_fista_sweeps_smem(int r, int use_stopping) {
  size_t floats = (size_t)r * ((r + 3) & ~3) + 2 * (size_t)r * HS;
  if (use_stopping) floats += 2 * (size_t)r * r + 5 * (size_t)r;
  return sizeof(float) * floats;
}

// Workspace floats of the kGlobal kernels: one slice per block (and for
// FISTA the A^T table before the slices).
size_t onmf_earlystop_slice_floats(int r) { return es_slice_floats(r); }

size_t onmf_fista_head_floats(int r) { return fista_head_floats(r); }

size_t onmf_fista_slice_floats(int r, int use_stopping) {
  return fista_slice_floats(r, use_stopping);
}

int onmf_tile_columns(void) { return TN; }

const char* onmf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// use_global != 0: the kGlobal kernel (A from device memory, columns swept
// in place in H).
int onmf_coder_sweeps(const float* A, const float* B, const float* H0,
                      float* H, int r, int n, float alpha, int sub_iter,
                      int use_global, void* stream) {
  const int blocks = (n + TN - 1) / TN;
  if (use_global) {
    coder_sweeps_kernel<true><<<blocks, TN, 0, (cudaStream_t)stream>>>(
        A, B, H0, H, r, n, alpha, sub_iter);
    return (int)cudaGetLastError();
  }
  const size_t smem = onmf_coder_sweeps_smem(r);
  int e = launch_smem((const void*)coder_sweeps_kernel<false>, smem);
  if (e) return e;
  coder_sweeps_kernel<false><<<blocks, TN, smem, (cudaStream_t)stream>>>(
      A, B, H0, H, r, n, alpha, sub_iter);
  return (int)cudaGetLastError();
}

// ws == NULL: the shared-memory kernel, one block per tile; otherwise the
// kGlobal kernel on `blocks` blocks, each with its slice of ws
// (onmf_earlystop_slice_floats floats).
int onmf_coder_sweeps_earlystop(const float* A, const float* B,
                                const float* H0, float* H, int r, int n,
                                float alpha, float stop, int sub_iter,
                                int pi_iters, float* ws, int blocks,
                                void* stream) {
  if (ws) {
    coder_es_kernel<true><<<blocks, TN, 0, (cudaStream_t)stream>>>(
        A, B, H0, H, r, n, alpha, stop, sub_iter, pi_iters, ws);
    return (int)cudaGetLastError();
  }
  const size_t smem = onmf_coder_sweeps_earlystop_smem(r);
  int e = launch_smem((const void*)coder_es_kernel<false>, smem);
  if (e) return e;
  coder_es_kernel<false><<<(n + TN - 1) / TN, TN, smem,
                           (cudaStream_t)stream>>>(
      A, B, H0, H, r, n, alpha, stop, sub_iter, pi_iters, nullptr);
  return (int)cudaGetLastError();
}

// The step size into inv_L (one float of device scratch, from
// lipschitz_iters power steps), then the sweeps, which read it. ws == NULL:
// the shared-memory kernel, one block per tile; otherwise the A^T table is
// written to the head of ws and the kGlobal kernel runs on `blocks` blocks.
int onmf_fista_sweeps(const float* A, const float* B, const float* H0,
                      float* H, int r, int n, float alpha, float* inv_L,
                      int lipschitz_iters, float stop, int sub_iter,
                      int use_stopping, int pi_iters, int bf16_matmul,
                      float* ws, int blocks, void* stream) {
  if (!ws && r > FISTA_MAX_RANK) return (int)cudaErrorInvalidValue;
  fista_step_size_kernel<<<1, 32, 5 * r * sizeof(float),
                           (cudaStream_t)stream>>>(A, r, lipschitz_iters,
                                                   inv_L);
  int e = (int)cudaGetLastError();
  if (e) return e;
  if (bf16_matmul)
    return launch_fista<true>(A, B, H0, H, r, n, alpha, inv_L, stop,
                              sub_iter, use_stopping, pi_iters, ws, blocks,
                              (cudaStream_t)stream);
  return launch_fista<false>(A, B, H0, H, r, n, alpha, inv_L, stop, sub_iter,
                             use_stopping, pi_iters, ws, blocks,
                             (cudaStream_t)stream);
}

int onmf_dict_update_sweep(const float* W_in, const float* A, const float* B,
                           float* W, int d, int r, void* stream) {
  int threads = ((d + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  dict_update_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(W_in, A, B, W,
                                                              d, r);
  return (int)cudaGetLastError();
}

}  // extern "C"

namespace {

template <bool kBf16>
int launch_fista(const float* A, const float* B, const float* H0, float* H,
                 int r, int n, float alpha, const float* inv_L, float stop,
                 int sub_iter, int use_stopping, int pi_iters, float* ws,
                 int blocks, cudaStream_t stream) {
  if (ws) {
    const int cells = r * ((r + 3) & ~3);
    fista_prep_kernel<kBf16><<<(cells + 255) / 256, 256, 0, stream>>>(A, r,
                                                                      ws);
    int e = (int)cudaGetLastError();
    if (e) return e;
    fista_kernel<kBf16, true><<<blocks, TN, 0, stream>>>(
        A, B, H0, H, r, n, alpha, inv_L, stop, sub_iter, use_stopping,
        pi_iters, ws);
    return (int)cudaGetLastError();
  }
  const size_t smem = onmf_fista_sweeps_smem(r, use_stopping);
  int e = launch_smem((const void*)fista_kernel<kBf16, false>, smem);
  if (e) return e;
  fista_kernel<kBf16, false><<<(n + TN - 1) / TN, TN, smem, stream>>>(
      A, B, H0, H, r, n, alpha, inv_L, stop, sub_iter, use_stopping,
      pi_iters, nullptr);
  return (int)cudaGetLastError();
}

}  // namespace
