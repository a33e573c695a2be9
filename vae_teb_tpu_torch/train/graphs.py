"""A train step captured as a CUDA graph: the port's counterpart of the JAX
package's K-step `lax.scan` dispatch (`Trainer.train_multi_step`).

One eager step runs thousands of kernel launches, and the host's cost of
issuing them is most of a step's time on the card. A CUDA graph records
the step's launches once; each replay launches them all with one host call.
`capture_step` records one step of a trainer whose eager steps at the same
shapes have already run (they create the optimizer's moments and fill the
kernels' shape caches), and `StepGraph.replay` runs it on new inputs.

What makes the step replayable, in the modules it runs: the optimizer's
count, bias corrections and scheduled lr, and the loss's beta, are device
tensors that the step updates or reads in place; the wavefront launches
read no host value a replay would freeze; the trainer's normalization
statistics and the LSTM's lvec are copied to the device once; the noise
comes from the trainer's generator, which is registered with the graph so
that each replay draws what an eager step would. The graph allocates from
a memory pool shared by all the trainer's graphs: every state that lives
across steps (parameters, moments, accumulated gradients, BatchNorm
statistics, the count) was made by the eager steps, outside the pool, so
a graph's scratch memory may be reused by another graph.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..kernels import add_launch_counts, launch_counts
from ..utils import profiling


class StepGraph:
    """One captured train step.

    inputs: the flat static buffer the step reads its fields (and eps)
    from, one row of `flat_rows`; out: the (n_metrics,) vector the replay
    writes, `metrics` its names; launches: the wavefront kernel launches
    one replay makes, by `kernels.launch_counts` key; stages: the step's
    stage marks, recorded into the graph (`utils.profiling.Stages`, or None
    when the step body opened none), which every replay records again.
    """

    def __init__(self, graph: "torch.cuda.CUDAGraph", inputs: torch.Tensor,
                 out: torch.Tensor, metrics: Sequence[str],
                 launches: Counter,
                 stages: Optional[profiling.Stages] = None):
        self.graph, self.inputs, self.out = graph, inputs, out
        self.metrics = tuple(metrics)
        self.launches = launches
        self.stages = stages
        self.replays = 0

    def replay(self, row: torch.Tensor) -> torch.Tensor:
        """Copy `row` (one step's fields, flattened) into the static
        buffer, replay the step and return a copy of its metrics; all on
        the current stream, with no host synchronisation. The replay's
        kernel launches are added to the wrappers' counts, and its stage
        marks become the latest step's (`utils.profiling.snapshot`). The
        span `graph.launch` covers the launch alone, which waits while
        the card's queue of work is full."""
        self.inputs.copy_(row)
        with profiling.span("graph.launch"):
            self.graph.replay()
        add_launch_counts(self.launches)
        profiling.replayed(self.stages)
        self.replays += 1
        return self.out.clone()


def flat_rows(fields: Sequence[torch.Tensor]) -> torch.Tensor:
    """(K, F): each step's fields, flattened and joined, one row a step, so
    that a replay copies its inputs into place with one copy."""
    K = fields[0].shape[0]
    return torch.cat([f.reshape(K, -1) for f in fields], 1)


def capture_step(step: Callable[..., Dict[str, torch.Tensor]],
                 shapes: Sequence[Tuple[int, ...]],
                 generator: torch.Generator, pool,
                 device: torch.device) -> StepGraph:
    """Capture `step(*inputs)` (the trainer's step body: fields, then eps
    or None when shapes has four entries) as a CUDA graph reading its
    inputs from one static buffer of the `shapes` (each step's field
    shapes, without the K axis). `pool`: the memory pool the trainer's
    graphs share (`torch.cuda.graph_pool_handle()`).

    Capturing runs nothing: the parameters, moments, statistics, count,
    generator and the kernels' launch counts are as they were before. The
    caller keeps every other host-side state the step body changes (the
    accumulation's micro-step). Raises if this PyTorch cannot register a
    generator with a graph, or if the capture fails (an operation that
    synchronises with the host or copies from it, a kernel that cannot be
    recorded), with the error of the operation that failed."""
    graph = torch.cuda.CUDAGraph()
    if not hasattr(graph, "register_generator_state"):
        raise RuntimeError(
            f"torch {torch.__version__} has no CUDAGraph."
            "register_generator_state: a graph of the step cannot draw its "
            "noise from the trainer's generator")
    graph.register_generator_state(generator)
    sizes = [torch.Size(s).numel() for s in shapes]
    inputs = torch.zeros(sum(sizes), dtype=torch.float32, device=device)
    views = [v.view(s) for v, s in zip(inputs.split(sizes), shapes)]
    if len(views) == 4:
        views.append(None)
    before = launch_counts()
    try:
        with torch.cuda.graph(graph, pool=pool):
            metrics = step(*views)
            out = torch.stack([metrics[k].float() for k in metrics])
    finally:   # the capture recorded its launches, it made none
        launches = launch_counts() - before
        add_launch_counts(launches, -1)
    return StepGraph(graph, inputs, out, list(metrics), launches,
                     profiling.captured_stages())
