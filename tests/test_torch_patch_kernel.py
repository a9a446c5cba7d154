"""The overlap average's gather kernel (``csrc/patch_kernels.cu``) on the
CPU, and the dispatch of ``ops/patches.py::overlap_average_grid``.

The kernel's source is plain C++ but for its CUDA keywords, builtins and
launch, so g++ runs it here: a stub ``cuda_runtime.h`` defines them away,
``blockIdx``/``threadIdx`` become globals, and the launch becomes a loop
over every thread of the grid in turn (the kernel has no barrier and no
shared memory). That holds the source's index map, its closed-form counts
and its edge cases against the ``F.fold`` form in float64, at the float32
tolerance (a float32 sum of at most k^2 C values), on every grid the card
tests run but the two cells' full-size ones, which run here at 128 x 128.
The card tests (``tests/test_torch_cuda.py``, ``-m cuda``) hold the
compiled kernel itself.
"""

import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from onmf_ontf_ndl_tpu_torch.ops import patches
from onmf_ontf_ndl_tpu_torch.ops.kernels import _lib, patch_kernel

TOL = dict(rtol=2e-4, atol=2e-5)

STUB = r"""
#pragma once
#include <algorithm>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct Dim3 { unsigned x = 0, y = 0, z = 0; };
inline Dim3 blockIdx, threadIdx;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline float __fdiv_rn(float a, float b) { return a / b; }
using std::max;
using std::min;
template <class F, class... A>
void launch_kernel(F f, unsigned grid, int threads, A... a) {
  for (unsigned b = 0; b < grid; ++b)
    for (int t = 0; t < threads; ++t) {
      blockIdx.x = b;
      threadIdx.x = t;
      f(a...);
    }
}
"""

MAIN = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
// H W C k s ni nj values.bin canvas.bin: the canvas, every entry first -1
int main(int argc, char** argv) {
  if (argc != 10) return 2;
  int H = atoi(argv[1]), W = atoi(argv[2]), C = atoi(argv[3]);
  int k = atoi(argv[4]), s = atoi(argv[5]), ni = atoi(argv[6]);
  int nj = atoi(argv[7]);
  size_t n = (size_t)k * k * C * ni * nj;
  std::vector<float> v(n + 1), o((size_t)H * W * C, -1.0f);
  FILE* f = fopen(argv[8], "rb");
  if (!f || fread(v.data(), 4, n, f) != n) return 3;
  fclose(f);
  int err = onmf_overlap_average(v.data(), o.data(), H, W, C, k, s, ni, nj,
                                 nullptr);
  if (err) return 10 + err;
  f = fopen(argv[9], "wb");
  fwrite(o.data(), 4, o.size(), f);
  fclose(f);
  return 0;
}
"""

# (name, H, W, C, k, stride, inclusive), as tests/test_torch_cuda.py's
# PAINT_CASES but for the two cells' shapes at 128 x 128
CASES = [(f"k{k}_s{s}_c{c}", 37, 45, c, k, s, False)
         for k in (1, 3, 10, 20) for s in (1, 2, 3, 5) for c in (1, 3)]
CASES += [
    ("inclusive_k1_c1", 37, 45, 1, 1, 1, True),
    ("inclusive_k3_c1", 37, 45, 1, 3, 1, True),
    ("inclusive_k10_c3", 37, 45, 3, 10, 1, True),
    ("inclusive_k20_c3", 37, 45, 3, 20, 1, True),
    ("k_h_minus_1", 21, 30, 3, 20, 1, False),
    ("k_h_minus_1_inclusive", 21, 30, 1, 20, 1, True),
    ("tall_s3", 61, 17, 3, 5, 3, False),
    ("empty", 10, 12, 3, 10, 1, False),
    ("image_recon_128", 128, 128, 3, 10, 1, False),
    ("tensor_recon_128", 128, 128, 3, 20, 2, False),
    ("four_channels", 29, 23, 4, 4, 2, False),
    ("stride_past_k", 40, 33, 3, 3, 5, False),
]


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The kernel's source built with g++ for the host (see the module
    docstring); the path of the program."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    src = (_lib._CSRC / "patch_kernels.cu").read_text()
    src, launches = re.subn(
        r"(\w+<\d+>)<<<([^,]+),\s*(\w+),\s*0,\s*stream>>>\(",
        r"launch_kernel(\1, \2, \3, ", src)
    assert launches == 2 and "<<<" not in src
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_runtime.h"')
    root = tmp_path_factory.mktemp("patch_kernel")
    (root / "cuda_runtime.h").write_text(STUB)
    (root / "host.cpp").write_text(src + MAIN)
    exe = root / "host"
    subprocess.run([gxx, "-std=c++20", "-O2", "-Wno-unknown-pragmas", "-o",
                    str(exe), str(root / "host.cpp")], check=True,
                   capture_output=True)
    return exe


@pytest.mark.parametrize("name,H,W,C,k,stride,inclusive", CASES,
                         ids=[c[0] for c in CASES])
def test_host_kernel_equals_the_fold(host_kernel, tmp_path, name, H, W, C, k,
                                     stride, inclusive):
    """Every pixel written (none left at the program's -1), and within the
    float32 tolerance of the float64 fold; 0 where no patch covers it."""
    shape = (H, W, C) if C > 1 else (H, W)
    s = 1 if inclusive else stride
    ni, nj = patches._grid_counts(shape, k, s, inclusive)
    vals = np.random.default_rng(len(name)).random(
        (k * k * C, ni * nj), dtype=np.float32)
    vals.tofile(tmp_path / "values.bin")
    subprocess.run([str(host_kernel), *map(str, (H, W, C, k, s, ni, nj)),
                    str(tmp_path / "values.bin"), str(tmp_path / "out.bin")],
                   check=True)
    got = torch.from_numpy(np.fromfile(tmp_path / "out.bin",
                                       dtype=np.float32).reshape(shape))
    want = patches.overlap_average_grid(torch.from_numpy(vals).double(), k,
                                        stride, shape, inclusive=inclusive)
    assert bool((got >= 0).all())
    torch.testing.assert_close(got.double(), want, **TOL)
    assert torch.equal(got == 0, want == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("inclusive", [False, True])
def test_cpu_overlap_average_grid_folds_and_launches_nothing(dtype,
                                                            inclusive):
    """On the CPU the grid form is the fold, equal to the corner form;
    the kernel's count stays."""
    shape, k, stride = (23, 19, 3), 4, 2
    s = 1 if inclusive else stride
    ni, nj = patches._grid_counts(shape, k, s, inclusive)
    vals = torch.rand((k * k * 3, ni * nj), dtype=dtype,
                      generator=torch.Generator().manual_seed(5))
    corners = (patches.all_patch_corners(shape, k, device="cpu")
               if inclusive else
               patches.grid_patch_corners(shape, k, s, device="cpu"))
    _lib.reset_launches()
    got = patches.overlap_average_grid(vals, k, stride, shape,
                                       inclusive=inclusive)
    assert _lib.LAUNCHES["overlap_average"] == 0
    torch.testing.assert_close(
        got, patches.overlap_average(vals, corners, k, shape))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_refuses_a_cpu_or_float64_tensor(dtype):
    with pytest.raises(TypeError, match="float32 CUDA"):
        patch_kernel.overlap_average(torch.zeros((48, 4), dtype=dtype), 4, 1,
                                     2, 2, (5, 5, 3))
