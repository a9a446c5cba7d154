// Hopper (sm_90a) red/black heat-bath sweeps of the 2-D Ising model.
//
// Replaces the Pallas TPU kernel checkerboard_sweeps_pallas
// (onmf_ontf_ndl_tpu/ops/pallas/ising_kernel.py:64). One launch per
// half-sweep: a colour's update reads only the other colour, so the int8
// lattice is updated in place in device memory (torus wrap-around), and the
// launch boundary is the barrier between the colours. Any even n works; the
// Pallas kernel's VMEM cap (n <= ~1500) does not apply.
//
// Randomness: Philox4x32-10 keyed by (seed, 0), counter (site, sweep,
// colour, 0); u24 is the top 24 bits of its first word. A site flips when
// u24 < thr[k], k = 5 (s + 1) / 2 + (sn + 4) / 2, the 24-bit acceptance
// thresholds of sigmoid(-dE / T) that the caller computes once. The plain
// PyTorch version computes the same bits, so the two agree site for site.
//
// What bounds it: one byte read per site and four neighbour reads (mostly
// cached), ~40 integer multiply instructions of Philox per updated site; at
// n = 4096 a half-sweep moves ~17 MB. The design keeps the lattice int8 and
// computes the random bits in registers, so nothing but the lattice crosses
// device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Thresholds {
  uint32_t t[10];
};

// Philox4x32-10 (Salmon et al., SC'11), first output word.
__device__ __forceinline__ uint32_t philox_word0(uint32_t c0, uint32_t c1,
                                                 uint32_t c2, uint32_t c3,
                                                 uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

// One thread per site of the colour: row i, column 2 jj + ((i + colour) & 1).
__global__ void checkerboard_half_kernel(int8_t* __restrict__ lat, int n,
                                         uint32_t seed, uint32_t sweep,
                                         uint32_t colour, Thresholds thr) {
  const int half = n >> 1;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n * half) return;
  const int i = (int)(idx / half);
  const int j = 2 * (int)(idx % half) + ((i + (int)colour) & 1);
  const int up = i == 0 ? n - 1 : i - 1, down = i == n - 1 ? 0 : i + 1;
  const int left = j == 0 ? n - 1 : j - 1, right = j == n - 1 ? 0 : j + 1;
  const size_t site = (size_t)i * n + j;
  const int s = lat[site];
  const int sn = lat[(size_t)up * n + j] + lat[(size_t)down * n + j] +
                 lat[(size_t)i * n + left] + lat[(size_t)i * n + right];
  const uint32_t u24 =
      philox_word0((uint32_t)site, sweep, colour, 0u, seed, 0u) >> 8;
  // a select over the 10 entries keeps the table in registers (a dynamic
  // index into the parameter struct would copy it to local memory)
  const int k = ((s + 1) >> 1) * 5 + ((sn + 4) >> 1);
  uint32_t th = 0;
#pragma unroll
  for (int q = 0; q < 10; ++q) th = q == k ? thr.t[q] : th;
  if (u24 < th) lat[site] = (int8_t)(-s);
}

}  // namespace

extern "C" {

// nsweeps full sweeps (colour 0, then colour 1) of the (n, n) int8 lattice,
// in place. thr: the 10 acceptance thresholds (host memory).
int onmf_checkerboard_sweeps(int8_t* lat, int n, int nsweeps,
                             unsigned int seed, const unsigned int* thr,
                             void* stream) {
  Thresholds th;
  for (int k = 0; k < 10; ++k) th.t[k] = thr[k];
  const long long sites = (long long)n * (n / 2);
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((sites + threads - 1) / threads);
  for (int sw = 0; sw < nsweeps; ++sw)
    for (uint32_t colour = 0; colour < 2; ++colour) {
      checkerboard_half_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
          lat, n, seed, (uint32_t)sw, colour, th);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
  return 0;
}

}  // extern "C"
