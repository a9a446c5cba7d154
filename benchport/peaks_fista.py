"""Operations and bytes of FISTA at fixed iterations
(``csrc/onmf_kernels.cu``: the step size's ``fista_step_size_kernel``,
then ``fista_tiled_kernel`` or, past its ranks, ``fista_wide_kernel``
with its ``fista_prep_kernel``), which FISTA's roofline divides by their
device time. The work the method requires, whatever implements it, from
the counts the kernels keep of their own work: per column and iteration
the gradient's product ``G Y`` (2 r^2) and the elementwise update of its
r entries (:data:`UPDATE_OPS` each: less P, plus alpha, times 1 / L, from
Y, the clamp, the step ``Hn - H`` and the extrapolation's multiply-add);
per call, the step size's power steps and its Rayleigh quotient
(:data:`POWER_STEPS` + 1 products of 2 r^2). Bytes: per call G read, and
per column P and the start read and the code written once. The stop's
work (the Grams of each tile's step and start) is not counted: no cell
reads FISTA's share with the stop."""

from __future__ import annotations

from benchport.peaks import bound

POWER_STEPS = 16
UPDATE_OPS = 8


def fista_bound(r: int, columns: int, column_iters: int, calls: int):
    """``(seconds, "bytes" or "operations")``: the least time of
    ``calls`` FISTA calls at rank r that coded ``columns`` columns in
    ``column_iters`` column-iterations (each tile's iterations times its
    columns)."""
    ops = column_iters * (2 * r * r + UPDATE_OPS * r) \
        + calls * (POWER_STEPS + 1) * 2 * r * r
    return bound(4 * (calls * r * r + 3 * r * columns), ops)
