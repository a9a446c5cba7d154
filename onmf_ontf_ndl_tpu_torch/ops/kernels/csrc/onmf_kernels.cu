// Hopper (sm_90a) kernels for the sequential sweeps of online NMF.
//
// Replace the Pallas TPU kernels of onmf_ontf_ndl_tpu/ops/pallas/coder_kernel.py:
//   onmf_coder_sweeps            <- coder_sweeps            (:192)
//   onmf_coder_sweeps_earlystop  <- coder_sweeps_earlystop  (:455)
//   onmf_dict_update_sweep       <- dict_update_sweep       (:629)
// Plain C entry points, bound from Python with ctypes. Each returns
// cudaGetLastError() after its launch (0 = success). All arrays are float32,
// row-major and contiguous; the caller allocates every output.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

// Columns per block. For the early-stop kernel the block is the stopping
// tile: the relative-change rule is decided on these TN columns together.
constexpr int TN = 128;
// Row stride of the early-stop kernel's shared (r, TN) tiles. The odd pad
// keeps the Gram loop (lanes on different rows, same column) off one bank.
constexpr int HS = TN + 1;

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
  for (int k = t; k < r; k += blockDim.x) {
    // _fixed_start: an unstructured positive start for the power steps
    v0[k] = 0.5f + (float)((k * 40503) % 65536) / 65536.0f;
    vd[k] = v0[k];
    vh[k] = v0[k];
  }
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
    // Grams of the sweep delta and of the old iterate over the tile's
    // columns; upper triangle (k <= l), mirrored. Inactive columns are 0.
    {
      int k = 0, l = t;
      while (k < r && l >= r) { l = l - r + k + 1; ++k; }
      while (k < r) {
        float gd = 0.f, gh = 0.f;
        for (int cc = 0; cc < TN; ++cc) {
          const float ok = Os[k * HS + cc], ol = Os[l * HS + cc];
          const float dk = Hs[k * HS + cc] - ok, dl = Hs[l * HS + cc] - ol;
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
    __syncthreads();
    if (t < 32) {
      // sigma(delta)^2 <= stop^2 sigma(H_old)^2, certified bounds first
      // (_stopping_update): one warm power step gives Rayleigh lower
      // bounds, trace/Gershgorin give upper bounds; only in the band
      // between them do pi_iters more warm steps decide.
      for (int k = t; k < r; k += 32) {
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
      if (t == 0) conv = cv;
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

int onmf_dict_update_sweep(const float* W_in, const float* A, const float* B,
                           float* W, int d, int r, void* stream) {
  int threads = ((d + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  dict_update_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(W_in, A, B, W,
                                                              d, r);
  return (int)cudaGetLastError();
}

}  // extern "C"
