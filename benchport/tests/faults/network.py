"""Faults of the network app's cells."""

from __future__ import annotations

import torch

from .step import half_batch, stale_weights, unchanged_state


def altered_graph(monkeypatch):
    """One painted pair's mean altered where the paints are grouped. The
    dense reconstruction has the grouping write its two canvases
    (``canvas=``: ``(recon, count)`` returned); the sparse and chunked
    ones take ``(ii, jj, sums, cnt)``."""
    from onmf_ontf_ndl_tpu_torch.apps import network

    orig = network._group_painted

    def group(*a, **k):
        if k.get("canvas") is not None:
            recon, count = orig(*a, **k)
            # the first painted pair, found on the device: no host read
            at = torch.argmax((count.reshape(-1) > 0).to(torch.int32))
            recon.view(-1).index_add_(0, at.reshape(1), torch.full(
                (1,), 0.25, dtype=recon.dtype, device=recon.device))
            return recon, count
        ii, jj, sums, cnt = orig(*a, **k)
        sums = sums.clone()
        sums[len(sums) // 2] += cnt[len(sums) // 2]
        return ii, jj, sums, cnt

    monkeypatch.setattr(network, "_group_painted", group)


CPU = {"train": [unchanged_state, half_batch], "recon": [altered_graph]}
CARD = {"train": [stale_weights]}
