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
// row-major and contiguous; the caller allocates every output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

// Columns per block. For the early-stop kernel the block is the stopping
// tile: the relative-change rule is decided on these TN columns together.
constexpr int TN = 128;
// Row stride of the early-stop kernel's shared (r, TN) tiles. The odd pad
// keeps the Gram loop (lanes on different rows, same column) off one bank.
constexpr int HS = TN + 1;
// Largest rank of the FISTA kernel: the thread-local new column hn[].
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
// h: the column in shared memory, element k at h[k * stride]; A in shared
// memory (every thread reads the same A[k, j]: a broadcast); b[k] at
// bcol[k * n] in device memory.
__device__ __forceinline__ void sweep_column(const float* __restrict__ As,
                                             const float* __restrict__ bcol,
                                             float* h, int stride, int r,
                                             int n, float alpha, float rs) {
  for (int k = 0; k < r; ++k) {
    const float* a = As + k * r;
    float g = 0.f;
    for (int j = 0; j < r; ++j) g = fmaf(a[j], h[j * stride], g);
    g = g - __ldg(bcol + (size_t)k * n) + alpha;
    const float step = rs / (a[k] + 1.0f);
    h[k * stride] = fmaxf(h[k * stride] - step * g, 0.f);
  }
}

__global__ void coder_sweeps_kernel(const float* __restrict__ A,
                                    const float* __restrict__ B,
                                    const float* __restrict__ H0,
                                    float* __restrict__ H, int r, int n,
                                    float alpha, int sub_iter) {
  extern __shared__ float smem[];
  float* As = smem;          // (r, r)
  float* Hs = As + r * r;    // (r, TN): column t at Hs[k * TN + t]
  for (int i = threadIdx.x; i < r * r; i += blockDim.x) As[i] = A[i];
  __syncthreads();
  const int t = threadIdx.x;
  const int c = blockIdx.x * TN + t;
  if (c >= n) return;  // no barrier below: columns are independent
  float* h = Hs + t;
  for (int k = 0; k < r; ++k) h[k * TN] = H0[(size_t)k * n + c];
  for (int i = 0; i < sub_iter; ++i)
    sweep_column(As, B + c, h, TN, r, n, alpha, 1.0f / sqrtf((float)i + 10.0f));
  for (int k = 0; k < r; ++k) H[(size_t)k * n + c] = h[k * TN];
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

// Grams over one tile's TN columns (row stride HS), upper triangle (k <= l)
// mirrored: Gd = D D^T and Gh = O O^T, with D = P - O when kDiff and D = P
// otherwise. Columns outside the batch hold 0 in P and O.
template <bool kDiff>
__device__ void tile_grams(const float* P, const float* O, float* Gd,
                           float* Gh, int r) {
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

__global__ void coder_es_kernel(const float* __restrict__ A,
                                const float* __restrict__ B,
                                const float* __restrict__ H0,
                                float* __restrict__ H, int r, int n,
                                float alpha, float stop, int sub_iter,
                                int pi_iters) {
  extern __shared__ float smem[];
  float* As = smem;          // (r, r)
  float* Hs = As + r * r;    // (r, HS) iterate, column t at Hs[k * HS + t]
  float* Os = Hs + r * HS;   // (r, HS) iterate before the current sweep
  float* Gd = Os + r * HS;   // (r, r) delta Gram
  float* Gh = Gd + r * r;    // (r, r) iterate Gram
  float* v0 = Gh + r * r;    // (r) fixed start vector
  float* vd = v0 + r;        // (r) carried eigenvector estimates
  float* vh = vd + r;
  float* wd = vh + r;        // (r) scratch
  float* wh = wd + r;
  __shared__ int conv;

  const int t = threadIdx.x;
  const int c = blockIdx.x * TN + t;
  const bool active = c < n;
  for (int i = t; i < r * r; i += blockDim.x) As[i] = A[i];
  for (int k = 0; k < r; ++k) {
    Hs[k * HS + t] = active ? H0[(size_t)k * n + c] : 0.f;
    Os[k * HS + t] = Hs[k * HS + t];
  }
  init_power_vectors(v0, vd, vh, r);
  if (t == 0) conv = 0;
  const float stop2 = stop * stop;
  __syncthreads();

  for (int i = 0; i < sub_iter; ++i) {
    if (conv) break;  // read after a barrier: uniform over the block
    if (active) {
      float* h = Hs + t;
      for (int k = 0; k < r; ++k) Os[k * HS + t] = h[k * HS];
      sweep_column(As, B + c, h, HS, r, n, alpha,
                   1.0f / sqrtf((float)i + 10.0f));
    }
    __syncthreads();
    tile_grams<true>(Hs, Os, Gd, Gh, r);
    __syncthreads();
    if (t < 32) {
      const int cv = stop_decision(Gd, Gh, v0, vd, vh, wd, wh, r, stop2,
                                   pi_iters);
      if (t == 0) conv = cv;
    }
    __syncthreads();
  }
  if (active)
    for (int k = 0; k < r; ++k) H[(size_t)k * n + c] = Hs[k * HS + t];
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

// FISTA on one tile of TN columns, one thread per column:
//   Hn = max(0, Y - inv_L (A Y - B + alpha)),  t' = (1 + sqrt(1 + 4 t^2)) / 2,
//   Y  = Hn + (t - 1) / t' (Hn - H).
// A (transposed, rows padded to R4 = a multiple of 4), H and Y live in
// shared memory; a thread reads A by broadcast and only its own columns of
// H and Y. It forms four rows of A Y at a time: one float4 of A^T and one
// element of Y per four multiply-adds, each row summed over j in order. The
// new column is formed in hn[] (thread-local) because every row of the
// product needs the whole old Y column. kBf16
// rounds A and Y to bf16 before the multiply-add (accumulation stays f32).
// With use_stopping the tile stops as coder_es_kernel does, on the Grams of
// the step delta (kept in the spent Y slot) and of the old H; the momentum t
// is per tile and stops with it. What bounds it: r^2 multiply-adds per column
// and iteration, each with a shared-memory load, in CUDA cores; the product
// is a real (r, r) x (r, TN) matrix product, so tensor cores (mma/wgmma) are
// the next step.
template <bool kBf16>
__global__ void fista_kernel(const float* __restrict__ A,
                             const float* __restrict__ B,
                             const float* __restrict__ H0,
                             float* __restrict__ H, int r, int n,
                             float alpha, const float* __restrict__ inv_L_ptr,
                             float stop, int sub_iter, int use_stopping,
                             int pi_iters) {
  extern __shared__ float smem[];
  const int R4 = (r + 3) & ~3;
  float* At = smem;          // (r, R4): At[j * R4 + k] = A[k, j]
  float* Hs = At + r * R4;   // (r, HS) iterate
  float* Ys = Hs + r * HS;   // (r, HS) extrapolated point; the step delta
                             // during the stop test
  float* Gd = Ys + r * HS;   // stop mode only: (r, r) delta Gram,
  float* Gh = Gd + r * r;    // (r, r) iterate Gram,
  float* v0 = Gh + r * r;    // and five (r) vectors as in coder_es_kernel
  float* vd = v0 + r;
  float* vh = vd + r;
  float* wd = vh + r;
  float* wh = wd + r;
  __shared__ int conv;

  const int t = threadIdx.x;
  const int c = blockIdx.x * TN + t;
  const bool active = c < n;
  const float inv_L = *inv_L_ptr;
  for (int i = t; i < r * R4; i += blockDim.x) {
    const int j = i / R4, k = i % R4;
    const float a = k < r ? A[k * r + j] : 0.f;
    At[i] = kBf16 ? bf16_round(a) : a;
  }
  for (int k = 0; k < r; ++k) {
    const float h = active ? H0[(size_t)k * n + c] : 0.f;
    Hs[k * HS + t] = h;
    Ys[k * HS + t] = h;
  }
  if (use_stopping) init_power_vectors(v0, vd, vh, r);
  if (t == 0) conv = 0;
  const float stop2 = stop * stop;
  float tmom = 1.f;
  float hn[FISTA_MAX_RANK];
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
          const float yj = kBf16 ? bf16_round(y[j * HS]) : y[j * HS];
          const float4 a = *reinterpret_cast<const float4*>(At + j * R4 + k0);
          g[0] = fmaf(a.x, yj, g[0]);
          g[1] = fmaf(a.y, yj, g[1]);
          g[2] = fmaf(a.z, yj, g[2]);
          g[3] = fmaf(a.w, yj, g[3]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = k0 + q;
          if (k < r)
            hn[k] = fmaxf(y[k * HS] - inv_L * (g[q] - __ldg(B + (size_t)k * n + c)
                                              + alpha), 0.f);
        }
      }
    }
    if (!use_stopping) {  // columns are independent: no barrier
      if (active)
        for (int k = 0; k < r; ++k) {
          const float h = Hs[k * HS + t];
          Hs[k * HS + t] = hn[k];
          Ys[k * HS + t] = hn[k] + mom * (hn[k] - h);
        }
      continue;
    }
    for (int k = 0; k < r; ++k)
      Ys[k * HS + t] = active ? hn[k] - Hs[k * HS + t] : 0.f;
    __syncthreads();
    tile_grams<false>(Ys, Hs, Gd, Gh, r);
    __syncthreads();
    if (t < 32) {
      const int cv = stop_decision(Gd, Gh, v0, vd, vh, wd, wh, r, stop2,
                                   pi_iters);
      if (t == 0) conv = cv;
    }
    // the step applies in the sweep that converges too
    if (active)
      for (int k = 0; k < r; ++k) {
        const float d = Ys[k * HS + t];
        Hs[k * HS + t] = hn[k];
        Ys[k * HS + t] = hn[k] + mom * d;
      }
    __syncthreads();
  }
  if (active)
    for (int k = 0; k < r; ++k) H[(size_t)k * n + c] = Hs[k * HS + t];
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

}  // namespace

extern "C" {

// Shared memory bytes each coder kernel needs at rank r (the wrapper
// checks them against the card's per-block limit).
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

int onmf_tile_columns(void) { return TN; }

const char* onmf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int onmf_coder_sweeps(const float* A, const float* B, const float* H0,
                      float* H, int r, int n, float alpha, int sub_iter,
                      void* stream) {
  const size_t smem = onmf_coder_sweeps_smem(r);
  int e = launch_smem((const void*)coder_sweeps_kernel, smem);
  if (e) return e;
  coder_sweeps_kernel<<<(n + TN - 1) / TN, TN, smem, (cudaStream_t)stream>>>(
      A, B, H0, H, r, n, alpha, sub_iter);
  return (int)cudaGetLastError();
}

int onmf_coder_sweeps_earlystop(const float* A, const float* B,
                                const float* H0, float* H, int r, int n,
                                float alpha, float stop, int sub_iter,
                                int pi_iters, void* stream) {
  const size_t smem = onmf_coder_sweeps_earlystop_smem(r);
  int e = launch_smem((const void*)coder_es_kernel, smem);
  if (e) return e;
  coder_es_kernel<<<(n + TN - 1) / TN, TN, smem, (cudaStream_t)stream>>>(
      A, B, H0, H, r, n, alpha, stop, sub_iter, pi_iters);
  return (int)cudaGetLastError();
}

// Two launches: the step size into inv_L (one float of device scratch,
// from lipschitz_iters power steps), then the sweeps, which read it.
int onmf_fista_sweeps(const float* A, const float* B, const float* H0,
                      float* H, int r, int n, float alpha, float* inv_L,
                      int lipschitz_iters, float stop, int sub_iter,
                      int use_stopping, int pi_iters, int bf16_matmul,
                      void* stream) {
  if (r > FISTA_MAX_RANK) return (int)cudaErrorInvalidValue;
  fista_step_size_kernel<<<1, 32, 5 * r * sizeof(float),
                           (cudaStream_t)stream>>>(A, r, lipschitz_iters,
                                                   inv_L);
  int e = (int)cudaGetLastError();
  if (e) return e;
  const size_t smem = onmf_fista_sweeps_smem(r, use_stopping);
  const void* fn = bf16_matmul ? (const void*)fista_kernel<true>
                               : (const void*)fista_kernel<false>;
  e = launch_smem(fn, smem);
  if (e) return e;
  const int blocks = (n + TN - 1) / TN;
  if (bf16_matmul)
    fista_kernel<true><<<blocks, TN, smem, (cudaStream_t)stream>>>(
        A, B, H0, H, r, n, alpha, inv_L, stop, sub_iter, use_stopping,
        pi_iters);
  else
    fista_kernel<false><<<blocks, TN, smem, (cudaStream_t)stream>>>(
        A, B, H0, H, r, n, alpha, inv_L, stop, sub_iter, use_stopping,
        pi_iters);
  return (int)cudaGetLastError();
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
