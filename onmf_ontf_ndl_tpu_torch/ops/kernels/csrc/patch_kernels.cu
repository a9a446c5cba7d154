// Hopper (sm_90a) kernel for the overlap average of a regular patch grid
// (ops/patches.py::overlap_average_grid on a float32 CUDA tensor): the
// paint of an image reconstruction (apps/image.py::reconstruct).
//
// No Pallas kernel stands behind it: the JAX package's overlap_average_grid
// (onmf_ontf_ndl_tpu/ops/patches.py:175) pads and adds k^2 shifted slices.
// The grid has ni x nj patches of k x k pixels, patch (pi, pj) at
// (pi * s, pj * s). Its values are a (d, ni * nj) matrix, d = k * k * C,
// in the layout W @ H writes: row (kh * k + kw) * C + c, column
// pi * nj + pj. Each pixel (y, x) of the (H, W, C) canvas is, channel by
// channel, the sum of the values of the patches that cover it, in
// ascending (kh, kw), over their number
//   cnt(y, x) = n_i(y) * n_j(x),  n_i(y) = #{pi < ni : pi s <= y < pi s + k}
// (n_j alike), taken in closed form; a pixel that no patch covers is 0.
//   onmf_overlap_average <- overlap_average_kernel: a thread a pixel,
//                           gathering its <= k^2 C values.
// Plain C entry point, bound from Python with ctypes; it returns
// cudaGetLastError() after its launch (0 = success).
//
// What bounds it on this card: bytes. Every value of the matrix covers
// exactly one pixel, so the least traffic is one read of it (1.23 GB at
// the image app's stride-1 grid of 1,028,196 patches, d = 300: ~0.37 ms
// at 3.35e12 B/s) and one write of the canvas (12.6 MB). What the design
// does about it:
//   - gather, not scatter: a pixel sums its own values in registers and
//     writes itself once; no atomics, no zeroed or padded copy, no fold
//     of ones, no permute;
//   - coalesced reads at every stride: a block takes pixels of one row y
//     and one phase x = phi (mod s), a thread the pixel x = phi + s * u.
//     Its values at offset kw = phi + s * m lie in column (.., u - m), so
//     a warp's 32 lanes read 32 consecutive columns of one row, 128 bytes;
//     the neighbouring warps of the block read the neighbouring columns,
//     so the sector a misaligned read shares with them comes from L1;
//   - loads in flight: the loop over kw is unrolled by 4 and the C
//     channels of one (kh, kw) are read together (CB = 3 where C is a
//     multiple of 3): 12 loads a thread, 48 registers, 5 blocks of 256
//     threads an SM (0.461 ms at the image app's grid, 81% of the byte
//     bound, on an H100 80GB HBM3 at 700 W);
//   - 64-bit offsets: the matrices of the cells hold 3.1e8 values, and an
//     image of 2048 x 2048 passes 2^31.
//
// Order: each channel's sum runs over (kh, kw) ascending, with no atomics,
// so two runs on the same input give the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int PAINT_THREADS = 256;   // pixels of one row and phase a block

// The covering offsets of one axis for the pixel at q * s + phase: the
// offsets kh (kw) = phase + s * m, m in [lo, hi], of patches p = q - m
// in [0, np). Empty where lo > hi.
struct Span {
  int lo;
  int hi;
};

__device__ __forceinline__ Span covering(int q, int phase, int k, int s,
                                         int np) {
  const int offsets = phase < k ? (k - phase + s - 1) / s : 0;
  return Span{max(0, q - (np - 1)), min(offsets - 1, q)};
}

// CB channels summed together (1, or 3 where C is a multiple of 3).
template <int CB>
__global__ void __launch_bounds__(PAINT_THREADS)
overlap_average_kernel(const float* __restrict__ vals, float* __restrict__ out,
                       int H, int W, int C, int k, int s, int ni, int nj,
                       int chunks) {
  const long long b = blockIdx.x;
  const int chunk = (int)(b % chunks);
  const long long row_phase = b / chunks;
  const int phi = (int)(row_phase % s);
  const int y = (int)(row_phase / s);
  const int u = chunk * PAINT_THREADS + (int)threadIdx.x;
  const int x = phi + s * u;
  if (x >= W) return;
  const int qy = y / s;
  const Span rows = covering(qy, y - qy * s, k, s, ni);
  const Span cols = covering(u, phi, k, s, nj);
  const int n_i = max(0, rows.hi - rows.lo + 1);
  const int n_j = max(0, cols.hi - cols.lo + 1);
  const float cnt = (float)max(n_i * n_j, 1);
  const long long n = (long long)ni * nj;
  // from (kh, kw) to (kh, kw + s): s rows of C further, one column back
  const long long kw_step = (long long)s * C * n - 1;
  float* dst = out + ((long long)y * W + x) * C;
  for (int c0 = 0; c0 < C; c0 += CB) {
    float acc[CB];
#pragma unroll
    for (int c = 0; c < CB; ++c) acc[c] = 0.0f;
    for (int mi = rows.lo; mi <= rows.hi; ++mi) {
      const int kh = y - (qy - mi) * s;
      const float* p = vals +
                       ((long long)(kh * k + phi + s * cols.lo) * C + c0) * n +
                       (long long)(qy - mi) * nj + (u - cols.lo);
#pragma unroll 4
      for (int m = cols.lo; m <= cols.hi; ++m, p += kw_step) {
#pragma unroll
        for (int c = 0; c < CB; ++c) acc[c] += p[c * n];
      }
    }
#pragma unroll
    for (int c = 0; c < CB; ++c) dst[c0 + c] = __fdiv_rn(acc[c], cnt);
  }
}

}  // namespace

extern "C" {

// The overlap average of the (k * k * C, ni * nj) float32 matrix `vals`
// (row-major) into the (H, W, C) float32 canvas `out` (contiguous), every
// pixel written. Patches at stride s; the grid must lie inside the canvas
// ((ni - 1) * s + k <= H where ni > 0, likewise nj and W).
int onmf_overlap_average(const float* vals, float* out, int H, int W, int C,
                         int k, int s, int ni, int nj, cudaStream_t stream) {
  if (H < 0 || W < 0 || C < 1 || k < 1 || s < 1 || ni < 0 || nj < 0 ||
      (ni > 0 && (long long)(ni - 1) * s + k > H) ||
      (nj > 0 && (long long)(nj - 1) * s + k > W))
    return (int)cudaErrorInvalidValue;
  const int per_phase = (W + s - 1) / s;
  const int chunks = (per_phase + PAINT_THREADS - 1) / PAINT_THREADS;
  const long long blocks = (long long)H * s * chunks;
  if (blocks == 0) return 0;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  if (C % 3 == 0)
    overlap_average_kernel<3><<<(unsigned)blocks, PAINT_THREADS, 0, stream>>>(
        vals, out, H, W, C, k, s, ni, nj, chunks);
  else
    overlap_average_kernel<1><<<(unsigned)blocks, PAINT_THREADS, 0, stream>>>(
        vals, out, H, W, C, k, s, ni, nj, chunks);
  return (int)cudaGetLastError();
}

}  // extern "C"
