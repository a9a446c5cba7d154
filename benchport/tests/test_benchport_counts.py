"""The yardstick's operation and byte counts at the cells' shapes, pinned
on the CPU: d = 300 (10x10x3 patches) and d = 441 (the 21-node motif),
r = 25; training at n = 16384 (image) and 504 (network), reconstruction
at 1,028,196 (a 1024x1024 image at stride 1) and 100,096 patches."""

from __future__ import annotations

import pytest

from toy_root import REPO  # noqa: F401  (puts the repository on the path)

from benchport import peaks


def test_training_flops_per_patch():
    # 4 d r + 2 (sub_iter + 1) r^2 = 30,000 + 13,750
    assert peaks.flops_per_patch(300, 25, 10) == 43_750


def test_image_reconstruction_flops():
    assert peaks.image_grid_patches(1024, 1024, 10, 1) == 1_028_196
    per = peaks.recon_flops_per_patch(300, 25, 10)
    assert per == 2 * 300 * 25 + 10 * 2 * 25 * 25 + 2 * 300 * 25 == 42_500
    assert per * 1_028_196 == 43_698_330_000


def test_network_reconstruction_flops():
    assert peaks.recon_flops_per_patch(441, 25, 30) * 100_096 \
        == 8_167_833_600


@pytest.mark.parametrize("d, nbytes", [(300, 4 * (2 * 300 * 25 + 625
                                                  + 25 * 300)),
                                       (441, 4 * (2 * 441 * 25 + 625
                                                  + 25 * 441))])
def test_dict_bound_is_set_by_bytes(d, nbytes):
    seconds, by = peaks.dict_bound(d, 25)
    assert by == "bytes"
    assert seconds == pytest.approx(nbytes / 3.35e12, rel=1e-12)
    assert nbytes == {300: 92_500, 441: 134_800}[d]


@pytest.mark.parametrize("n, sweeps, ops", [
    (16_384, 10, 204_800_000),
    (1_028_196, 10, 12_852_450_000),
    (100_096, 30, 3_753_600_000),
])
def test_fixed_coder_bound_is_set_by_operations(n, sweeps, ops):
    assert 2 * 25 * 25 * n * sweeps == ops
    seconds, by = peaks.coder_fixed_bound(25, n, sweeps)
    assert by == "operations"
    assert seconds == pytest.approx(ops / 67e12, rel=1e-12)


def test_peaks_are_the_h100_sxm_datasheet():
    assert (peaks.PEAK_OPS, peaks.PEAK_BF16_OPS, peaks.PEAK_BYTES) == \
        (67e12, 989e12, 3.35e12)
