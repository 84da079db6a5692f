"""Device time of a call on the card, for the port's measurement scripts."""

from __future__ import annotations

import torch


def graph_ms(fn, iters: int = 20, reps: int = 10) -> float:
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph and replayed ``reps`` times between CUDA events, so no host time
    sits between the launches (a wrapper's Python can take longer to enqueue
    a call than the card takes to run it). ``fn`` must be capturable: no
    host sync, launches on the current stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * reps)
