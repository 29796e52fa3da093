"""Steps as CUDA graphs (counterpart: the ``jax.jit`` of JAX's steps,
``challenge_tpu/train/state.py:132-172``, ``parallel/train.py:232-270``).

JAX compiles a step once and dispatches it as one program. The port
captures a step as one CUDA graph and replays it, so that a step costs the
host one replay instead of some thousands of launches. One scheme serves
the iterator-mode train and eval steps (``train.state``) and the fused
train and eval steps (``parallel.train``), on one card and on a
data-parallel mesh whose collectives can be captured (NCCL,
:func:`capturable`), in :class:`StepGraphs`:

* the first call of a batch signature runs the step eagerly on a side
  stream, which lets cuDNN pick its algorithms, the optimizer make its
  slots and the kernels load, then captures the same step (the capture
  runs nothing) and returns the eager step's metrics;
* the generators the step draws from (the fused steps' phase generator,
  the stochastic-depth one) are registered with the graph, so a replay
  draws what the eager step would draw from their state, and reseeding
  them (``manual_seed``) between replays holds;
* the synthesis kernels' launches while capturing are counted apart
  (``cuda.capture_launches``), and each replay adds them to
  ``cuda.LAUNCHES``;
* the batch, a tensor or a (nested) tuple of tensors, is flattened and
  copied into the graph's own buffers at each call; one graph is kept a
  shape and dtype signature of it, as JAX traces once a signature;
* the outputs (the metrics) are cloned after each replay, and
  ``state.step`` advances by what the captured call advanced it.

On a mesh the step's collectives (``parallel.mesh``: the gradient
all-reduce, AGC's broadcast, cross-replica BatchNorm's all-reduces in the
forward and the backward, the metrics' all-reduce) run in the eager step;
the capture records them, the backward's too (autograd runs it on the
capturing stream), and executes none; each replay executes them once.
So a call that captures executes the same collectives, in the same
order, as a call that replays: the eager step's. A rank that drops a
stale graph and captures anew stays in step with ranks that replay.

A graph reads the state's tensors by address: the module's parameters and
buffers, each optimizer group's device ``lr`` and ``step`` and every
optimizer slot. The port's write paths keep those addresses (``set_weights``,
``restore_train_state``, ``optim.set_learning_rate``). A call checks them,
and the state, banks and generators the graphs were captured with: if any
differs, every graph of the step is dropped and the call captures anew.
No graph is ever replayed on tensors it was not captured with.

There is no fallback: a failed capture or replay raises. On the CPU and
on a gloo mesh the caller runs the step eagerly.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, Optional, Tuple

import torch

from challenge_tpu_torch.ops import cuda


def flatten(batch) -> Tuple[list, object]:
    """(the tensors of ``batch`` in order, its structure): a tensor, or a
    tuple or list of batches; None stands for no batch."""
    if batch is None:
        return [], None
    if isinstance(batch, torch.Tensor):
        return [batch], '*'
    leaves, trees = [], []
    for item in batch:
        sub, tree = flatten(item)
        leaves += sub
        trees.append(tree)
    return leaves, tuple(trees)


def unflatten(tree, leaves: list):
    """The inverse of :func:`flatten`."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if t == '*':
            return next(it)
        return tuple(build(s) for s in t)
    return build(tree)


def state_tensors(state):
    """Every tensor a captured step reads or writes by address: the
    module's parameters and buffers, each optimizer group's device ``lr``
    and ``step`` and every optimizer slot."""
    module, optimizer = state.module, state.optimizer
    groups = (group.get(k) for group in optimizer.param_groups
              for k in ('lr', 'step'))
    slots = (v for s in optimizer.state.values() for v in s.values())
    return (t for t in itertools.chain(module.parameters(), module.buffers(),
                                       groups, slots)
            if isinstance(t, torch.Tensor))


def state_addresses(state) -> tuple:
    """The ``data_ptr`` of each of :func:`state_tensors`, in order."""
    return tuple(t.data_ptr() for t in state_tensors(state))


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    inputs: list                  # the buffers the batch is copied into
    outputs: Dict[str, torch.Tensor]
    launches: dict                # kernel launches a replay makes
    steps: int                    # what a replay adds to state.step


class StepGraphs:
    """A step ``fn(state, batch, *refs) -> metrics`` run as CUDA graphs, one
    a batch signature (the module docstring): ``graphs(fn, state, batch,
    *refs)``. ``refs`` are what the step reads besides the batch (banks,
    generators); ``generators(refs)`` names the ones to register. All
    graphs of one object are bound to the state, the refs and the state's
    tensor addresses of their capture. ``fn`` is passed at each call and
    kept by no graph, so an owner holding this object makes no cycle."""

    def __init__(self, generators: Callable = lambda refs: ()):
        self.generators = generators
        self.graphs: Dict[object, _Graph] = {}
        self.captures = 0             # graphs captured, recaptures included
        self._bound: Optional[tuple] = None

    def reset(self) -> None:
        """Drop every graph; the next call captures anew."""
        self.graphs.clear()
        self._bound = None

    def __call__(self, fn: Callable, state, batch, *refs):
        leaves, tree = flatten(batch)
        bound = (state, *refs, state_addresses(state))
        if self._bound is not None and (
                len(bound) != len(self._bound)
                or any(a is not b for a, b in zip(bound[:-1],
                                                  self._bound[:-1]))
                or bound[-1] != self._bound[-1]):
            self.reset()                 # stale: capture anew
        key = (tree, tuple((tuple(t.shape), t.dtype) for t in leaves))
        g = self.graphs.get(key)
        if g is None:
            return self._capture(fn, key, state, batch, leaves, tree, refs)
        return self._replay(g, state, leaves)

    @staticmethod
    def _replay(g: _Graph, state, leaves) -> dict:
        for buf, x in zip(g.inputs, leaves):
            buf.copy_(x)
        g.graph.replay()
        state.step += g.steps
        cuda.LAUNCHES.update(g.launches)
        return {k: v.clone() for k, v in g.outputs.items()}

    def _capture(self, fn, key, state, batch, leaves, tree, refs):
        device = leaves[0].device if leaves else next(
            state.module.parameters()).device
        stream = torch.cuda.Stream(device=device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            metrics = fn(state, batch, *refs)
            inputs = [x.clone() for x in leaves]
        torch.cuda.current_stream(device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators(refs):
            if gen is not None:
                graph.register_generator_state(gen)
        step = state.step
        with cuda.capture_launches() as launches, \
                torch.cuda.graph(graph, stream=stream):
            outputs = fn(state, unflatten(tree, inputs), *refs)
        steps, state.step = state.step - step, step   # the capture ran nothing
        self.graphs[key] = _Graph(graph, inputs, outputs, launches, steps)
        self.captures += 1
        # after the eager step, which may have made the optimizer's slots
        self._bound = (state, *refs, state_addresses(state))
        return metrics


def on_cuda(state) -> bool:
    """Whether the state's module lives on a CUDA device."""
    return next(state.module.parameters()).device.type == 'cuda'


def capturable(mesh) -> bool:
    """Whether a step over ``mesh`` (None: one device) can be captured:
    alone, or on a mesh whose collectives can be (NCCL,
    ``Mesh.capturable``)."""
    return mesh is None or mesh.capturable
