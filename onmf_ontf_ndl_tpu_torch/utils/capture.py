"""CUDA graph capture and replay of a step function on static buffers.

The port's counterpart of a jitted ``lax.scan``: a loop whose step reads
and writes buffers in place is captured once as a CUDA graph and replayed
for every step. The training step (``models/onmf.py::_train_loop``), a
block of the motif chain's moves (``samplers/motif.py::run_chains``) and
an app's whole training round (``models/onmf.py::_run_rounds``) run
through one cache class (:class:`GraphCache`), an instance each
(``_GRAPHS``, ``_ROUND_GRAPHS``, ``_CHAIN_GRAPHS``), each call site
keeping only its key, its buffers, their refill and its step function.

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

import collections
import contextlib
import dataclasses
import functools

import torch

from onmf_ontf_ndl_tpu_torch.utils import profiling

__all__ = ["GraphCache", "side_stream", "capture_step", "replay",
           "tensor_at"]


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


@dataclasses.dataclass
class _Entry:
    """A cached graph: the graph, the caller's buffers it reads and writes,
    the generators registered with it, the kernel launches of one replay,
    what it reads in place (:meth:`GraphCache.run`'s ``reads``: the tensors
    held, or their :func:`tensor_at`) and the replays made."""

    graph: object
    buffers: object
    gens: tuple
    launches: dict
    reads: tuple
    replays: int = 0


class GraphCache(collections.OrderedDict):
    """The graphs of one replayed loop by cache key, the least recently
    used dropped first past ``size``: each holds its buffers and a memory
    pool of its step's intermediates. ``name`` counts its captures and
    replays (``graph.<name>.*``); ``spans``, where given, names the spans
    of its captures and replays (``<spans>.capture``, ``<spans>.replay``,
    the latter with its device time).

    The tensors a graph reads in place (``reads``) are baked into it by
    address, so a replay must find them where the capture found them:

    - held (``hold=True``): the caller's key carries each one's
      :func:`tensor_at` and the entry holds the tensors, so that no
      replay reads freed memory. A round's and a chain block's reads (the
      image, the frames, the graph's tensors, the motif's tables and the
      patch pairs' index tables) are the app's for as long as it trains,
      but a cache of tables may drop its copy while a graph still reads
      it (``samplers/motif.py::_pair_tables``), and a tensor made anew at
      another address gets a key of its own;
    - not held (``hold=False``): the entry keeps each one's
      :func:`tensor_at`, and a hit that finds one moved drops the entry and
      captures anew under the same key. A training step's large X (the
      headline pool, 157 MB) must be freed when its caller drops it, and a
      new X at another address must not leave the old entry in the cache
      beside the new one.
    """

    def __init__(self, name: str, size: int, spans: str | None = None):
        super().__init__()
        self.name, self.size, self.spans = name, size, spans

    def _span(self, what: str, on=None):
        if self.spans is None:
            return contextlib.nullcontext()
        return profiling.span(f"{self.spans}.{what}", on=on)

    def run(self, key, device, gens: tuple, times: int, new, fill, step, *,
            reads: tuple = (), hold: bool = True, each=None):
        """``times`` runs of ``step(buffers, *gens)`` on the graph of
        ``key`` on ``device``: on a miss ``new()`` makes the buffers, filled
        from the call, and the first run is the one that
        :func:`capture_step` runs before it captures; on a hit
        ``fill(buffers)`` copies the call's inputs into the entry's; the
        replays (:func:`replay`) make the rest. Run i of the
        call is followed by ``each(buffers, i)`` where given. Returns the
        buffers, which the next call of ``key`` overwrites. A capture that
        fails raises and leaves no entry of ``key``."""
        with torch.cuda.device(device):
            entry = self.pop(key, None)
            if entry is not None and not hold \
                    and entry.reads != tuple(map(tensor_at, reads)):
                entry = None            # a read has moved: capture anew
            done = 0
            if entry is None:
                while len(self) >= self.size:
                    self.popitem(last=False)
                buffers = new()
                with self._span("capture"):
                    graph, owns, launches = capture_step(
                        functools.partial(step, buffers), gens, device,
                        cache=self.name)
                entry = _Entry(graph, buffers, owns, launches, tuple(
                    reads if hold else map(tensor_at, reads)))
                if each is not None:
                    each(buffers, 0)
                done = 1
            else:
                buffers = entry.buffers
                fill(buffers)
            self[key] = entry
            with self._span("replay", on=device):
                replay(entry.graph, entry.gens, gens, times - done,
                       entry.launches, None if each is None
                       else lambda i: each(buffers, done + i),
                       cache=self.name)
            entry.replays += times - done
            return buffers
