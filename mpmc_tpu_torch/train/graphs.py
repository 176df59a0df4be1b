"""K steps in one dispatch (port of ``make_scan_train_step``,
``make_packed_gather_scan_train_step``, ``make_scan_eval_step`` and
``make_gather_scan_eval_step`` in ``mpmc_tpu/train/step.py``, and of the
corpus MLM and SimCLR stages' scans), and a greedy decode in one dispatch
(:class:`GraphedCall`, the counterpart of the ``lax.scan`` in the
captioners' ``generate``).

The JAX package runs a group of K train (or eval) steps as one
``lax.scan`` dispatch.  Its counterpart here is a CUDA graph of K calls of
the step: :class:`GroupedSteps` keeps static input buffers ``[K, ...]``,
filled by one copy per group, and replays the graph, whose K steps read
step ``j``'s slice of the buffers.  The first group of each input shape
runs eagerly as real work (the warm-up: lazy set-up, the kernels' one-time
attributes, cuBLAS workspaces, the optimizer's scratch), and the graph is
captured after it; capture does no work, so it advances neither the
optimizer's count nor a generator.  A generator of the step is registered
with the graph, so every replay draws fresh numbers that continue the
eager stream: K steps replayed equal K steps run one by one.  The outputs
(per-step loss and grad norm ``[K]``, or eval probabilities and losses
``[K, B]``) are copied out of the graph's static outputs before the next
replay can overwrite them.  All graphs of a run share one memory pool.
Both classes warm up with :func:`warm` and capture, count and replay
through :class:`CapturedGraph`; they differ only in when they capture.

A capture that fails raises; nothing falls back to eager steps.  On the
CPU there are no graphs: a group is K eager calls of the same step.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch import nn

from mpmc_tpu_torch.ops import build

Batch = Dict[str, torch.Tensor]


def warm(stream: torch.cuda.Stream, fn: Callable[..., Batch], *args
         ) -> Batch:
    """``fn(*args)`` run eagerly (real work) on the capture ``stream``,
    after the current stream's work and before its next: the warm-up that
    precedes a capture."""
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        out = fn(*args)
    current.wait_stream(stream)
    for v in out.values():
        v.record_stream(current)
    return out


class CapturedGraph:
    """``fn(inputs) -> {name: tensor}`` captured once as a CUDA graph over
    static device copies of ``inputs`` (on ``stream``, into ``pool`` or a
    private pool, with ``generators`` registered), the kernel launches
    inside it counted into ``tally``.  Capture does no work.
    :meth:`replay` copies new values into the static inputs, replays, adds
    ``tally`` to the launch counts and returns a copy of the outputs (the
    next replay overwrites them).  A capture that fails raises."""

    def __init__(self, fn: Callable[[Batch], Batch], inputs: Batch,
                 stream: torch.cuda.Stream, pool=None,
                 generators: Sequence[torch.Generator] = ()):
        self.inputs = {n: torch.empty(v.shape, dtype=v.dtype,
                                      device=stream.device)
                       for n, v in inputs.items()}
        for n, buf in self.inputs.items():
            buf.copy_(inputs[n], non_blocking=True)
        torch.cuda.synchronize(stream.device)
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            self.graph.register_generator_state(gen)
        with build.capturing() as tally, torch.cuda.graph(
                self.graph, pool=pool, stream=stream):
            self.outputs = fn(self.inputs)
        self.tally = dict(tally)
        self.replays = 0

    def replay(self, values: Batch) -> Batch:
        for n, buf in self.inputs.items():
            buf.copy_(values[n], non_blocking=True)
        self.graph.replay()
        build.add_launches(self.tally)
        self.replays += 1
        return {n: v.clone() for n, v in self.outputs.items()}


class GroupedSteps:
    """``run(group) -> {name: [K, ...]}`` for a group of K batches stacked
    on a leading axis (host or device tensors): ``step`` K times, each on
    the next slice, as one CUDA graph replay on a CUDA ``device``.

    ``step(batch) -> {name: tensor}`` must keep every piece of state it
    updates at a fixed address (in place) and read nothing back from the
    device.  ``generators`` are the step's random generators.  ``counter``
    (the optimizer) has a host mirror ``count`` of a step count that the
    step advances on the device: it is restored after the capture and
    advanced by K at each replay, and its ``ensure_steps`` makes its
    per-step tables cover the group before the capture and each replay.
    ``pool`` is the run's shared graph memory pool (a
    ``torch.cuda.graph_pool_handle``)."""

    def __init__(self, step: Callable[[Batch], Batch], k: int,
                 device: torch.device,
                 generators: Sequence[torch.Generator] = (),
                 counter=None, pool=None):
        if k < 2:
            raise ValueError(f"a group needs K >= 2 steps, got {k}")
        self.step, self.k, self.device = step, k, torch.device(device)
        self.generators = list(generators)
        self.counter = counter
        self.pool = pool
        self.graphs: Dict[tuple, CapturedGraph] = {}
        self._tables: Dict[tuple, object] = {}
        self.replays = 0
        self.captures = 0
        self._stream = None

    def _eager(self, group: Batch) -> Batch:
        outs: List[Batch] = []
        for j in range(self.k):
            outs.append(self.step({n: v[j].to(self.device, non_blocking=True)
                                   for n, v in group.items()}))
        return {n: torch.stack([o[n] for o in outs]) for n in outs[0]}

    def _steps(self, inputs: Batch) -> Batch:
        """The K steps as captured: step ``j`` reads slice ``j``."""
        outs = [self.step({n: v[j] for n, v in inputs.items()})
                for j in range(self.k)]
        return {n: torch.stack([o[n] for o in outs]) for n in outs[0]}

    def __call__(self, group: Batch) -> Batch:
        lead = {int(v.shape[0]) for v in group.values()}
        if lead != {self.k}:
            raise ValueError(f"a group of {self.k} steps, got leading dims "
                             f"{sorted(lead)}")
        if self.device.type != "cuda":
            return self._eager(group)
        key = tuple((n, tuple(v.shape), v.dtype)
                    for n, v in sorted(group.items()))
        entry = self.graphs.get(key)
        if entry is None:
            return self._warm_and_capture(key, group)
        if self.counter is not None:
            self.counter.ensure_steps(self.counter.count + self.k)
            if self.counter.tables is not self._tables[key]:
                raise RuntimeError("the optimizer's per-step tables grew "
                                   "after the graph was captured")
        out = entry.replay(group)
        self.replays += 1
        if self.counter is not None:
            self.counter.count += self.k
        return out

    def _warm_and_capture(self, key: tuple, group: Batch) -> Batch:
        """The group's K steps eagerly on the capture stream, then the
        graph of K steps over static inputs of this shape."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        result = warm(self._stream, self._eager, group)
        count = None
        if self.counter is not None:
            self.counter.ensure_steps(self.counter.count + self.k)
            count = self.counter.count
        self.graphs[key] = CapturedGraph(self._steps, group, self._stream,
                                         self.pool, self.generators)
        if self.counter is not None:
            self.counter.count = count
            self._tables[key] = self.counter.tables
        self.captures += 1
        return result


class GraphedCall:
    """``fn(*tensors, **static) -> tensor`` as one CUDA graph replay per
    input shape on a CUDA device: the captioners' greedy ``generate`` (the
    image encoder and every decoder pass), which the JAX package runs as
    one jitted ``lax.scan``.

    The first call of each key (the tensors' shapes and types, and the
    ``static`` keyword values) runs ``fn`` eagerly as real work, on the
    capture stream.  The second captures ``fn`` over static copies of the
    inputs (a :class:`CapturedGraph` in a private memory pool), then
    replays; every later call replays.  ``module``'s parameters and
    buffers are read at their addresses: if one has moved since the
    capture (``.to``, ``load_state_dict(assign=True)``), a replay raises.
    Everything runs under ``torch.inference_mode``.  A capture that fails
    raises; nothing falls back to the eager call.  On the CPU every call
    is ``fn``."""

    def __init__(self, fn: Callable[..., torch.Tensor], module: nn.Module):
        self.fn, self.module = fn, module
        self.graphs: Dict[tuple, CapturedGraph] = {}
        self._addresses_at: Dict[tuple, tuple] = {}
        self.seen = set()
        self.replays = 0
        self.captures = 0
        self._stream = None

    def _addresses(self) -> tuple:
        return tuple(t.data_ptr() for t in (*self.module.parameters(),
                                            *self.module.buffers()))

    def __call__(self, *tensors: torch.Tensor, **static) -> torch.Tensor:
        device = tensors[0].device
        if device.type != "cuda":
            return self.fn(*tensors, **static)
        key = (tuple((tuple(t.shape), t.dtype, t.device) for t in tensors),
               tuple(sorted(static.items())))
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        values = {f"arg{i}": t for i, t in enumerate(tensors)}

        def call(inputs: Batch) -> Batch:
            return {"out": self.fn(*inputs.values(), **static)}

        with torch.inference_mode():
            if key not in self.seen:
                self.seen.add(key)
                return warm(self._stream, call, values)["out"]
            entry = self.graphs.get(key)
            if entry is None:
                entry = self.graphs[key] = CapturedGraph(call, values,
                                                         self._stream)
                self._addresses_at[key] = self._addresses()
                self.captures += 1
            if self._addresses() != self._addresses_at[key]:
                raise RuntimeError("the module's weights moved after the "
                                   "decode graph was captured")
            out = entry.replay(values)["out"]
            self.replays += 1
            return out


def make_scan_train_step(train_step, k: int, pool=None) -> GroupedSteps:
    """K optimizer steps of a ``TrainStep`` (or a fold-parallel one) a
    dispatch: its dropout and augmentation generator registered with the
    graph, its optimizer's count restored after capture and advanced at
    replay.  The batch is any of the step's layouts: row indices and
    ``valid`` into the resident store, packed rows and ``img_idx``, or
    host-fed packed rows."""
    return GroupedSteps(train_step, k, train_step.optimizer.device,
                        generators=[train_step.generator],
                        counter=train_step.optimizer, pool=pool)


def make_scan_eval_step(eval_step, k: int, device: torch.device,
                        pool=None) -> GroupedSteps:
    """K eval batches a dispatch: ``{"probs", "loss"}`` ``[K, B]``."""

    def step(batch: Batch) -> Batch:
        probs, loss = eval_step(batch)
        return {"probs": probs, "loss": loss}

    return GroupedSteps(step, k, device, pool=pool)


def graph_pool(device: torch.device) -> Optional[object]:
    """One memory pool for all of a run's graphs (train and eval, one per
    shape): they replay one at a time on one stream.  None on the CPU."""
    return (torch.cuda.graph_pool_handle()
            if torch.device(device).type == "cuda" else None)
