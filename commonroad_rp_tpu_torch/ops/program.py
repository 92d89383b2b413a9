"""A step captured once as a CUDA graph and replayed: the port's counterpart
of ``jax.jit``.

A step is a function of no arguments that reads static buffers (tensors
whose storage lives as long as the program) and writes static buffers or
returns its outputs.  :class:`CapturedStep` runs it three ways:

* on a CUDA device (``graph=True``, the default): the first run executes
  one warm-up step on a side stream (it builds the kernels and raises their
  shared-memory limits, which a capture cannot do), then captures one step
  as a CUDA graph in the graph's own memory pool; every run replays the
  graph.  A capture or a replay that fails raises: nothing falls back to
  eager execution;
* on a CUDA device with ``graph=False``: the same step eagerly, one
  dispatch per op (the twin the captured step is held against);
* on the CPU, whatever ``graph`` says: eagerly (``graph`` is then False).

The callers are the replanning scans (``parallel.replanning_scan``) and the
level programs (``ops.level_program``).
"""

from __future__ import annotations

import torch


class CapturedStep:
    """``step()`` run eagerly or replayed from one capture.

    ``outputs`` holds what the last step returned: on a graph, the captured
    step's outputs, which every replay rewrites in place; ``replays`` counts
    the replays."""

    def __init__(self, step, device, graph: bool = True):
        self.step = step
        self.device = torch.device(device)
        self.graph = bool(graph) and self.device.type == "cuda"
        self.replays = 0
        self.outputs = None
        self._graph = None

    def capture(self) -> bool:
        """On a graph's first call: one warm-up step on a side stream, then
        the capture of one step (recorded, not run).  True when this call
        captured, so that a caller whose step advances state (a scan's
        carry) can load it again; False otherwise."""
        if not self.graph or self._graph is not None:
            return False
        with torch.cuda.device(self.device):
            current = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                self.step()
            current.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self.outputs = self.step()
        self._graph = graph
        return True

    @property
    def pool_bytes(self):
        """The device memory the captured graph's pool holds (the caching
        allocator's segments of that pool); None before a capture."""
        if self._graph is None:
            return None
        pool = tuple(self._graph.pool())
        return sum(segment["total_size"]
                   for segment in torch.cuda.memory_snapshot()
                   if tuple(segment.get("segment_pool_id", ())) == pool)

    def __call__(self):
        """One step: a replay of the captured graph (capturing it first on
        the first call), or the step eagerly.  Returns ``outputs``."""
        if not self.graph:
            self.outputs = self.step()
            return self.outputs
        self.capture()
        with torch.cuda.device(self.device):
            self._graph.replay()
        self.replays += 1
        return self.outputs
