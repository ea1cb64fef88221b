"""A Python loop of small device steps, replayed from CUDA graphs.

The plain twins of the antidiagonal kernels (:mod:`.dp_ad`,
:mod:`.walk`) loop over antidiagonals in Python, a few dozen PyTorch
operations on small tensors a step.  On a CUDA device the host's
dispatch of each operation, not the card, sets the time of such a
step, and a genome-length chain of ~10^6 steps would take many minutes.
:func:`run_steps` runs the first chunk of steps as written, captures the
next chunk once into a CUDA graph, with the step index held in a device
counter, and replays the graph for every later whole chunk: the same
operations on the same tensors, in the same order, launched by the card
from the graph instead of one by one from Python.  On the CPU it is the
plain loop.
"""

from __future__ import annotations

from collections import deque

import torch

__all__ = ["run_steps", "take", "put", "add_at", "GRAPH_CHUNK"]

# steps captured into one CUDA graph (a multiple of 4: a step may read
# its index's residue mod 4 as a Python int)
GRAPH_CHUNK = 128
# (event, graph): graphs a call no longer needs, kept with their memory
# until the replays queued before the event have run
_RETIRED = deque()


def take(x: torch.Tensor, i):
    """``x[i]`` for an int or a one-element index tensor."""
    return x[i] if isinstance(i, int) else x.index_select(0, i)[0]


def put(x: torch.Tensor, i, value: torch.Tensor):
    """``x[i] = value`` for an int or a one-element index tensor."""
    if isinstance(i, int):
        x[i] = value
    else:
        x.index_copy_(0, i, value[None].to(x.dtype))


def add_at(x: torch.Tensor, i, value: torch.Tensor):
    """``x[i] += value`` for an int or a one-element index tensor."""
    if isinstance(i, int):
        x[i] += value
    else:
        x.index_add_(0, i, value[None].to(x.dtype))


def run_steps(step, state, steps: range, graphs=None):
    """``state = step(a, a_now, state)`` for every ``a`` of ``steps``, in
    order; returns the last state.

    ``state`` is a tuple of tensors on one device, and ``step`` returns
    a tuple of the same shapes and types.  ``step`` may use the Python
    int ``a`` only through ``a % 4`` (its parities); everything else it
    computes from ``a`` it computes from ``a_now``, which is ``a`` itself
    or, inside a CUDA graph, a one-element int64 tensor holding ``a``
    (index with :func:`take`, :func:`put` and :func:`add_at`).  It may
    write tensors it closes over, and must not copy from the host.

    ``graphs``: a dict the caller keeps across calls of the same ``step``
    over the same closed-over tensors (windows of one sweep).  The graph
    captured by the first call is kept there, keyed by the first step's
    residue mod 4, and later calls replay it from their first step
    instead of running a chunk as written and capturing again.
    """
    state = tuple(state)
    chunk = GRAPH_CHUNK
    key = (steps.start % 4, steps.step)
    cached = graphs.get(key) if graphs is not None else None
    if (state[0].device.type != "cuda" or len(steps) < chunk
            or (cached is None and len(steps) < 2 * chunk)):
        for a in steps:
            state = step(a, a, state)
        return state
    if cached is None:
        # the first chunk as written: it also makes every operation's
        # first use, which a graph capture must not be
        for a in steps[:chunk]:
            state = step(a, a, state)
        rest = steps[chunk:]
        static = tuple(x.clone() for x in state)
        counter = torch.full((1,), rest[0], dtype=torch.int64,
                             device=state[0].device)
        # captured on a side stream without torch.cuda.graph's device
        # synchronise: the host never waits for the card here
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(torch.cuda.Stream(state[0].device)):
            graph.capture_begin()
            try:
                st = static
                for c in range(chunk):
                    st = step(rest[c], counter + c * steps.step, st)
                for x, y in zip(static, st):
                    x.copy_(y)
                counter.add_(chunk * steps.step)
            finally:
                graph.capture_end()
        if graphs is not None:
            graphs[(rest[0] % 4, steps.step)] = (graph, static, counter)
    else:
        graph, static, counter = cached
        for x, y in zip(static, state):
            x.copy_(y)
        counter.fill_(steps.start)
        rest = steps
    n_graphed = len(rest) // chunk * chunk
    for _ in range(n_graphed // chunk):
        graph.replay()
    if graphs is None:
        _retire(graph)
        state = static
    else:
        # the kept graph's inputs are overwritten by the next call
        state = tuple(x.clone() for x in static)
    for a in rest[n_graphed:]:
        state = step(a, a, state)
    return state


def _retire(graph):
    """Release ``graph`` (and the memory of its intermediates) once the
    replays queued so far have run, without waiting for them: it is kept
    with an event, and dropped by a later call that finds the event
    completed."""
    while _RETIRED and _RETIRED[0][0].query():
        _RETIRED.popleft()
    event = torch.cuda.Event()
    event.record()
    _RETIRED.append((event, graph))
