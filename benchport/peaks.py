"""The yardstick's arithmetic: the card's published peaks, and the
operations and bytes of the kernels and steps that the metrics divide by
device time. Computed from shapes alone, so the CPU tests pin them.

Peaks: NVIDIA's H100 SXM datasheet, dense rates, at the card's full 700 W
power limit (the run prints the limit it found): device memory bytes/s,
float32 operations/s outside the tensor cores, bf16 operations/s on them.
The port's products run in float32 with TF32 off, so a float32 step is
held to the float32 peak.
"""

from __future__ import annotations

PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12
PEAK_BF16_OPS = 989e12


def bound(nbytes: float, ops: float, bf16_ops: float = 0.0):
    """``(seconds, "bytes" or "operations")``: the least time for moving
    ``nbytes`` and doing ``ops`` float32 operations and ``bf16_ops``
    operations of a bf16 product at the card's peaks."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = ops / PEAK_OPS + bf16_ops / PEAK_BF16_OPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def coder_fixed_bound(r: int, n: int, sweeps: int):
    """The fixed-sweep Gauss-Seidel coder's bound at (r, n): the Gram A
    (r, r), the projection B and H0 (r, n) read and H written once; 2 r^2
    operations a column and sweep."""
    return bound(4 * (r * r + 3 * r * n), 2 * r * r * n * sweeps)


def dict_bound(d: int, r: int):
    """The dictionary update's bound: W, A and B read and W written once;
    ``W A[:, j]`` for every column, 2 d r^2 operations."""
    return bound(4 * (2 * d * r + r * r + r * d), 2 * d * r * r)


def flops_per_patch(d: int, r: int, sub_iter: int) -> int:
    """Model operations of one training step per patch column: the
    projection W^T X (2dr), ``sub_iter`` Gauss-Seidel sweeps (2r^2 each),
    the aggregates H H^T (2r^2) and H X^T (2dr). The per-batch terms
    (W^T W and the dictionary pass, O(d r^2)) are left out."""
    return 4 * d * r + 2 * (sub_iter + 1) * r * r


def recon_flops_per_patch(d: int, r: int, sub_iter: int) -> int:
    """Model operations of a reconstruction per patch: the projection
    W^T X (2dr), ``sub_iter`` sweeps (2r^2 each) and W H (2dr)."""
    return 2 * d * r + 2 * sub_iter * r * r + 2 * d * r


def image_grid_patches(height: int, width: int, k: int, stride: int) -> int:
    """Patches of a colour reconstruction's exclusive strided grid: the
    starts ``range(0, H - k, stride)`` by ``range(0, W - k, stride)``."""
    return -(-(height - k) // stride) * -(-(width - k) // stride)
