"""CUDA graph capture and replay of a step function on static buffers.

The port's counterpart of a jitted ``lax.scan``: a loop whose step reads
and writes buffers in place is captured once as a CUDA graph and replayed
for every step. The training step (``models/onmf.py::_train_loop``), a
block of the motif chain's moves (``samplers/motif.py::run_chains``) and
an app's whole training round (``models/onmf.py::_run_rounds``) run
through here; each keeps its own cache of graphs and its own key.

Draws: a capture records the Philox offsets of its random calls, so each
generator that a step draws from has a generator of the graph's own,
registered with it. Each takes its caller's state before the replays and
gives it back after, so the replays draw what the eager loop draws and
leave the caller's generators where the eager loop leaves them.

Each capture and replay is counted by its cache (``"step"``, ``"round"``,
``"chain"``) in the program's trace record while a profiler session is
active (``utils/profiling.py::count``: ``graph.<cache>.captures``,
``graph.<cache>.replays``), beside the kernel launches that every replay
adds to ``_lib.LAUNCHES``.
"""

from __future__ import annotations

import functools

import torch

from onmf_ontf_ndl_tpu_torch.utils import profiling

__all__ = ["side_stream", "capture_step", "replay", "tensor_at"]


def tensor_at(t: torch.Tensor) -> tuple:
    """What a graph that reads ``t`` in place bakes in of it: its address,
    shape, strides and dtype (a cache key's part)."""
    return t.data_ptr(), tuple(t.shape), t.stride(), t.dtype


@functools.cache
def side_stream(device: torch.device):
    """The stream that captures run their first step and capture on, one
    per device: cuBLAS and the allocator set up once for it."""
    return torch.cuda.Stream(device)


def capture_step(step, gens: tuple, device: torch.device,
                 cache: str = "step"):
    """Run ``step(*gens)`` once on the device's side stream (which also sets
    up cuBLAS and the kernels on the stream the capture uses), then
    capture ``step`` there, drawing from generators of the graph's own, one
    for each of ``gens`` (distinct generators). The captured step does not
    run until the graph is replayed.

    Returns ``(graph, generators, launches)``: ``launches`` are the kernel
    launches one replay makes, as the wrappers of ``ops/kernels`` count
    them (:func:`~onmf_ontf_ndl_tpu_torch.ops.kernels._lib.
    captured_launches`). A capture that fails raises."""
    from onmf_ontf_ndl_tpu_torch.ops.kernels._lib import (
        captured_launches, launch_counts)

    owns = tuple(torch.Generator(device=device) for _ in gens)
    graph = torch.cuda.CUDAGraph()
    for own in owns:
        graph.register_generator_state(own)
    side = side_stream(device)
    side.wait_stream(torch.cuda.current_stream())
    # capture_begin itself, not torch.cuda.graph, whose entry empties the
    # allocator's cache at every capture
    with torch.cuda.stream(side):
        step(*gens)
        before = launch_counts()
        graph.capture_begin()
        try:
            step(*owns)
        finally:
            graph.capture_end()
    launches = captured_launches(before)
    torch.cuda.current_stream().wait_stream(side)
    profiling.count(f"graph.{cache}.captures")
    return graph, owns, launches


def replay(graph, owns: tuple, gens: tuple, times: int, launches: dict,
           each=None, cache: str = "step") -> None:
    """Replay ``graph`` ``times`` times on the current stream, replay i
    followed by ``each(i)`` where given, its generators ``owns`` taking
    the states of ``gens`` (one each) before and giving them back after;
    count each replay's ``launches``, and the replays of ``cache``."""
    from onmf_ontf_ndl_tpu_torch.ops.kernels._lib import add_launches

    for own, gen in zip(owns, gens):
        own.set_state(gen.get_state())
    for i in range(times):
        graph.replay()
        if each is not None:
            each(i)
    add_launches(launches, times)
    profiling.count(f"graph.{cache}.replays", times)
    for own, gen in zip(owns, gens):
        gen.set_state(own.get_state())
