"""Operations and bytes of the Ising sampler's kernels
(``csrc/ising_kernels.cu``: ``checkerboard_resident_kernel``,
``checkerboard_half_kernel``), which the checkerboard's roofline divides
by their device time. Computed from shapes alone, so the CPU tests pin
them.

What bounds the sampler is integer instructions, not bytes. A
Philox4x32-10 call is 10 rounds of two 32 x 32 -> 64 multiplies and two
three-input xors (the key schedule is the same for every site and is not
counted), and serves four sites of a colour. A site then takes its 24
bits (a shift), sums its four neighbours (3 adds), forms the threshold's
index (1), compares (1) and flips (1). The integer rate: the H100 SXM's
132 SMs, 64 INT32 lanes each, at its 1.98 GHz boost clock, for the
multiplies and the other instructions alike.
"""

from __future__ import annotations

from benchport.peaks import bound

PEAK_INT_OPS = 132 * 64 * 1.98e9
PHILOX_MULS, PHILOX_ALU, SITE_ALU = 20, 20, 7


def checkerboard_bound(n: int, nsweeps: int):
    """``(seconds, "bytes" or "operations")``: the least time of one
    sampler call of ``nsweeps`` sweeps on an (n, n) int8 lattice, the same
    for every route: the lattice read and written once; one Philox call
    per four sites of a colour and the site updates, the multiplies and
    the other integer instructions each at the integer rate."""
    calls = 2 * nsweeps * -(-n * (n // 2) // 4)
    sites = n * n * nsweeps
    t_bytes, _ = bound(2 * n * n, 0)
    t_ops = max(PHILOX_MULS * calls,
                PHILOX_ALU * calls + SITE_ALU * sites) / PEAK_INT_OPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
