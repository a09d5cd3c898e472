"""A frame step over static buffers, captured once as a CUDA graph.

Shared by the fused real-data path (``app/run_opt.py``) and the simulation
runner (``runner.py``): both advance a carry of tensors by one frame per
call, and on the card each call replays the one captured graph.
"""

from __future__ import annotations

import gc

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from . import cost
from .stamps import host_ns

WARMUP_STEPS = 2  # eager steps on a side stream before capture (library handles, allocator)


def select(valid: torch.Tensor, a, b):
    """``a`` where ``valid`` (a 0-dim bool tensor), else ``b``, leaf by leaf."""
    la, spec = tree_flatten(a)
    lb, _ = tree_flatten(b)
    return tree_unflatten([torch.where(valid, x, y) for x, y in zip(la, lb)], spec)


def broadcast_lanes(tree, lanes: int):
    """``tree`` with a leading lane axis: ``lanes`` copies of every leaf."""
    return tree_map(lambda a: a.expand(lanes, *a.shape).clone(), tree)


class GraphStep:
    """``fn(carry, *inputs) -> (new carry, outputs)`` over static buffers.

    The carry (a pytree of tensors) and the inputs live in buffers of fixed
    address; a call copies its inputs in, runs the step, and the step
    copies the new carry back over the old one.  On ``cuda`` the step is
    captured once, at the first call, as a CUDA graph and each call replays
    it; the outputs are then the graph's own tensors, which the next replay
    overwrites, so callers copy them out first.  On ``cpu`` each call runs
    the step directly.  A capture that fails raises: there is no eager
    fallback on the card.
    """

    def __init__(self, fn, carry, inputs, device: torch.device):
        leaves, self._spec = tree_flatten(carry)
        self.carry = [x.clone() for x in leaves]
        self.inputs = [x.clone() for x in inputs]
        self._fn = fn
        self.device = device
        self.graph = None
        self._out = None
        # host clock (stamps.host_ns) at the start and end of the whole
        # capture: warm-up steps, capture and instantiation
        self.build_ns = None
        self.capture_s = None  # seconds of the capture and instantiation alone, on the same clock
        self.pool_bytes = None  # device memory the capture reserved for the graph's pool
        self.replays = 0  # graph launches

    def _body(self):
        new, out = self._fn(tree_unflatten(self.carry, self._spec), *self.inputs)
        for dst, src in zip(self.carry, tree_flatten(new)[0]):
            dst.copy_(src)
        return out

    def _capture(self):
        t_build = host_ns()
        saved = self.snapshot()
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self._body()
        cur.wait_stream(side)
        self.restore(saved)  # the warm-up must not advance the carry
        torch.cuda.synchronize(self.device)
        # Dead reference cycles may hold earlier graphs, whose destruction is a
        # CUDA call that invalidates a capture in progress: collect them now,
        # and keep the collector from running until the capture has ended.
        gc.collect()
        torch.cuda.empty_cache()  # as the capture does first, so the difference is the pool's
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = host_ns()
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                out = self._body()
        finally:
            if collecting:
                gc.enable()
        torch.cuda.synchronize(self.device)
        self.build_ns = (t_build, host_ns())
        self.capture_s = (self.build_ns[1] - t0) * 1e-9
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.graph, self._out = graph, out

    def __call__(self, *inputs):
        for buf, x in zip(self.inputs, inputs):
            buf.copy_(x)
        if self.device.type != "cuda":
            return self._body()
        if self.graph is None:
            self._capture()
        self.graph.replay()
        self.replays += 1
        return self._out

    def cost_analysis(self) -> dict:
        """:func:`cost.count` of one step, run eagerly (outside any capture)
        on copies of the carry and the inputs: the operations and bytes of
        one step, under XLA's key names.  On the card the step's kernels run
        once more; the carry does not advance."""
        carry = tree_unflatten(self.snapshot(), self._spec)
        return cost.count(self._fn, carry, *[x.clone() for x in self.inputs])

    def load(self, carry) -> None:
        self.restore(tree_flatten(carry)[0])

    def value(self):
        """The carry as its pytree (views of the static buffers)."""
        return tree_unflatten(self.carry, self._spec)

    def snapshot(self) -> list:
        return [x.clone() for x in self.carry]

    def restore(self, saved: list) -> None:
        for dst, src in zip(self.carry, saved):
            dst.copy_(src)
