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

:class:`ScanProgram` runs a scan's cycle ``n_cycles`` times as such a
step, its carry (and a rollout's scene) in :class:`StaticBuffers`: the
counterpart of a jitted ``lax.scan``.  The callers are the replanning scans
(``parallel.replanning_scan``), the XLA fleet rollout (``parallel.fleet``)
and the level programs (``ops.level_program``).
"""

from __future__ import annotations

import time

import torch

from commonroad_rp_tpu_torch.utils import profiling


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
        carry) can load it again; False otherwise.  A capture adds 1 to the
        counter ``captured_step.captures`` and its host wall (warm-up and
        capture) to ``captured_step.capture_ns`` (``utils.profiling``)."""
        if not self.graph or self._graph is not None:
            return False
        t0 = time.perf_counter_ns()
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
        profiling.count("captured_step.captures")
        profiling.count("captured_step.capture_ns",
                        time.perf_counter_ns() - t0)
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


def _leaves(value, prefix=""):
    """(name, tensor) of every tensor of a NamedTuple, nested NamedTuples
    flattened with dotted names (``ref.s``)."""
    for name, x in zip(value._fields, value):
        if hasattr(x, "_fields"):
            yield from _leaves(x, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", x


def _empty_like(value, device):
    """A NamedTuple (nested NamedTuples too) of uninitialised tensors shaped
    like ``value``'s, on ``device``."""
    return type(value)(*(_empty_like(x, device) if hasattr(x, "_fields")
                         else torch.empty_like(x, device=device)
                         for x in value))


class StaticBuffers:
    """A static copy of a NamedTuple of tensors (nested NamedTuples too):
    the memory a captured step reads in place of its argument.

    ``load(value)`` copies ``value`` in, allocating the buffers at its first
    call; a later value whose field differs in shape or dtype raises
    ``ValueError`` (a graph keeps the addresses and shapes it captured).
    ``value`` is the static copy, None before the first load; ``what`` names
    the argument in the error (``carry``, ``scene``)."""

    def __init__(self, what: str, device):
        self.what = what
        self.device = torch.device(device)
        self.value = None

    def load(self, value):
        if self.value is None:
            self.value = _empty_like(value, self.device)
        for (name, static), (_, x) in zip(_leaves(self.value), _leaves(value)):
            if x.shape != static.shape or x.dtype != static.dtype:
                raise ValueError(
                    f"{self.what} field {name}: {tuple(x.shape)} {x.dtype}, "
                    f"the program was built for {tuple(static.shape)} "
                    f"{static.dtype}")
            static.copy_(x)


class ScanProgram:
    """``run(carry, *args) -> (carry, metrics)``: ``n_cycles`` cycles of a
    scan in buffered form, the counterpart of the JAX package's jitted
    ``lax.scan`` (pallas_fleet.py:135-136, :354-382, :737-738; fleet.py:
    268-274).

    ``cycle(carry) -> (new carry, metrics)`` reads the static carry
    buffers; each step writes every metric into its preallocated
    [n_cycles, ...] buffer at a device-side cycle counter (``index_copy_``
    at a 0-d index), copies the new carry into the static buffers and
    advances the counter, so that steps chain without the host.  The same
    step runs three ways:

    * on a CUDA device (``graph=True``, the default): the first call runs
      one warm-up step and captures one step (:class:`CapturedStep`); every
      call replays the graph ``n_cycles`` times (``replays`` counts them).
      A capture or a replay that fails raises: nothing falls back to the
      eager loop;
    * on a CUDA device with ``graph=False``: the same steps eagerly, one
      dispatch per op (the twin the captured scan is held against);
    * on the CPU, whatever ``graph`` says: eagerly (``self.graph`` is then
      False).

    Each call copies the caller's carry into the static buffers, runs
    ``prepare(*args)`` (the facade scan writes its desired speed into its
    scalar row there; the XLA fleet rollout loads its scene into static
    buffers) and resets the counter; it returns clones, so the caller never
    holds memory that the next call overwrites.  Metrics come back as the
    cycle's type (a NamedTuple such as ``parallel.fleet.CycleMetrics``, or
    a tuple).  ``keep`` holds tensors a cycle reads that nothing else keeps
    alive for the graph's life (the grids' cached constants).

    ``observe``, where a call gives it, is called after every cycle with
    the carry that cycle wrote: the static buffers themselves, which the
    next cycle overwrites, so an observer copies what it keeps.  That is
    the public per-cycle read of a scan's carry; the replays are the same.

    Traced (``utils.profiling``): the span ``scan_program.stage`` holds the
    carry's load and ``prepare`` (the XLA rollout's scene copy), the span
    ``scan_program.replays`` the host loop of the cycles' launches, and the
    counter ``scan_program.cycles`` adds ``n_cycles`` once per call.
    """

    def __init__(self, cycle, n_cycles: int, device, graph: bool = True,
                 keep=(), prepare=None):
        device = torch.device(device)
        self.cycle = cycle
        self.n_cycles = n_cycles
        self.device = device
        self._program = CapturedStep(self._step, device, graph)
        self.graph = self._program.graph
        self._keep = tuple(keep)
        self._prepare = prepare
        self._carry = StaticBuffers("carry", device)
        self._outputs = None
        self._metrics_type = tuple
        self._counter = torch.zeros((), dtype=torch.int64, device=device)

    @property
    def replays(self) -> int:
        """Replays of the captured cycle so far."""
        return self._program.replays

    @property
    def pool_bytes(self):
        """The device memory of the captured graph's pool
        (:attr:`CapturedStep.pool_bytes`); None before a capture."""
        return self._program.pool_bytes

    def _load(self, carry):
        """The caller's carry into the static buffers, the counter to 0."""
        self._carry.load(carry)
        self._counter.zero_()

    def _step(self):
        carry = self._carry.value
        new_carry, metrics = self.cycle(carry)
        if self._outputs is None:
            self._outputs = tuple(m.new_empty((self.n_cycles,) + m.shape)
                                  for m in metrics)
            self._metrics_type = getattr(type(metrics), "_make", tuple)
        for out, m in zip(self._outputs, metrics):
            out.index_copy_(0, self._counter, m.unsqueeze(0))
        for name, static, new in zip(new_carry._fields, carry, new_carry):
            if new.shape != static.shape or new.dtype != static.dtype:
                raise ValueError(
                    f"the cycle turns carry field {name} into "
                    f"{tuple(new.shape)} {new.dtype}, from "
                    f"{tuple(static.shape)} {static.dtype}")
            static.copy_(new)
        self._counter.add_(1)

    def __call__(self, carry, *args, observe=None):
        with profiling.span("scan_program.stage"):
            self._load(carry)
            if self._prepare is not None:
                self._prepare(*args)
        final = lambda: type(carry)(*(x.clone() for x in self._carry.value))
        if self.n_cycles == 0:
            return final(), ()
        if self._program.capture():
            # the warm-up cycle advanced the carry and the counter
            self._load(carry)
        with profiling.span("scan_program.replays"):
            for _ in range(self.n_cycles):
                self._program()
                if observe is not None:
                    observe(self._carry.value)
        profiling.count("scan_program.cycles", self.n_cycles)
        return final(), self._metrics_type(out.clone()
                                           for out in self._outputs)
