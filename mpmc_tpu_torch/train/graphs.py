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

A step or eval batch outside a full group (the rest of an eval interval,
or of an eval pass, after its groups of K) goes through
:meth:`GroupedSteps.single`: a CUDA graph of one step, captured per input
shape in the same way after an eager first call, and replayed after.

A capture that fails raises; nothing falls back to eager steps.  On the
CPU there are no graphs: a group is K eager calls of the same step, and a
single step the step itself.

Each boundary is a ``utils.profiling`` span, named by the group's role
(``train`` or ``eval``) and with the steps it runs as ``k`` (1 for a
single step): ``mpmc.<role>.warm`` (the eager first call of a shape),
``mpmc.graph.capture``, ``mpmc.<role>.replay``, ``mpmc.<role>.eager`` (on
the CPU) and ``mpmc.h2d`` (the copies of the inputs).  The counter
``graph.<role>.single`` counts the single-step replays.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn

from mpmc_tpu_torch.ops import build
from mpmc_tpu_torch.train.step import gather_batch
from mpmc_tpu_torch.utils.profiling import count, h2d, span

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
    next replay overwrites them).  A capture that fails raises.  The
    capture, instantiation included, is the span ``mpmc.graph.capture``
    with its ``role``."""

    def __init__(self, fn: Callable[[Batch], Batch], inputs: Batch,
                 stream: torch.cuda.Stream, pool=None,
                 generators: Sequence[torch.Generator] = (), *, role: str):
        with span("mpmc.graph.capture", role=role):
            self.inputs = {n: torch.empty(v.shape, dtype=v.dtype,
                                          device=stream.device)
                           for n, v in inputs.items()}
            with h2d(inputs.values()):
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
        with h2d(values.values()):
            for n, buf in self.inputs.items():
                buf.copy_(values[n], non_blocking=True)
        self.graph.replay()
        build.add_launches(self.tally)
        self.replays += 1
        return {n: v.clone() for n, v in self.outputs.items()}


class GroupedSteps:
    """``run(group) -> {name: [K, ...]}`` for a group of K batches stacked
    on a leading axis (host or device tensors): ``step`` K times, each on
    the next slice, as one CUDA graph replay on a CUDA ``device``
    (``graphed``).  :meth:`single` runs one batch the same way, as the
    replay of a graph of one step.  Graphs are keyed by the number of
    steps and the inputs' names, shapes and dtypes, so resident ``idx [K,
    B]`` groups and host-fed groups of rows (pixels ``[K, B, H, W, C]``
    included) each get their own.  :meth:`with_store` gives the same step
    over a device-resident store.

    ``step(batch) -> {name: tensor}`` must keep every piece of state it
    updates at a fixed address (in place) and read nothing back from the
    device.  ``generators`` are the step's random generators.  ``counter``
    (the optimizer) has a host mirror ``count`` of a step count that the
    step advances on the device: it is restored after a capture and
    advanced by the graph's steps at each replay, and its ``ensure_steps``
    makes its per-step tables cover them before the capture and each
    replay.  ``pool`` is the run's shared graph memory pool (a
    ``torch.cuda.graph_pool_handle``).  ``role`` (``train`` or ``eval``)
    names the spans.  ``replays`` counts the replays of whole groups,
    ``single_replays`` those of single steps, ``captures`` both kinds'
    captures."""

    def __init__(self, step: Callable[[Batch], Batch], k: int,
                 device: torch.device,
                 generators: Sequence[torch.Generator] = (),
                 counter=None, pool=None, role: str = "train"):
        if k < 2:
            raise ValueError(f"a group needs K >= 2 steps, got {k}")
        self.step, self.k, self.device = step, k, torch.device(device)
        self.graphed = self.device.type == "cuda"
        self.role = role
        self.warm_span, self.replay_span, self.eager_span = (
            f"mpmc.{role}.{w}" for w in ("warm", "replay", "eager"))
        self.generators = list(generators)
        self.counter = counter
        self.pool = pool
        self.graphs: Dict[tuple, CapturedGraph] = {}
        self._tables: Dict[tuple, object] = {}
        self._stores: Dict[tuple, "GroupedSteps"] = {}
        self.replays = 0
        self.single_replays = 0
        self.captures = 0
        self._stream = None

    def with_store(self, store: Batch) -> "GroupedSteps":
        """The K steps of ``step(batch, store)`` (a step that gathers its
        batch's ``idx`` rows from the device-resident ``store``): a
        :class:`GroupedSteps` made once per store (by its arrays'
        addresses), with this one's generators, counter and memory pool
        and graphs of its own."""
        key = tuple((n, v.data_ptr()) for n, v in sorted(store.items()))
        bound = self._stores.get(key)
        if bound is None:
            step = self.step
            bound = self._stores[key] = GroupedSteps(
                lambda batch: step(batch, store), self.k, self.device,
                self.generators, self.counter, self.pool, self.role)
        return bound

    def _one(self, batch: Batch) -> Batch:
        """One step, its batch copied to the device first."""
        with h2d(batch.values()):
            batch = {n: v.to(self.device, non_blocking=True)
                     for n, v in batch.items()}
        return self.step(batch)

    def _eager(self, group: Batch) -> Batch:
        outs = [self._one({n: v[j] for n, v in group.items()})
                for j in range(self.k)]
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
        if not self.graphed:
            with span(self.eager_span, k=self.k):
                return self._eager(group)
        return self._run(self.k, group, self._eager, self._steps)

    def single(self, batch: Batch) -> Batch:
        """``step(batch)`` for one batch (no leading K axis, host or device
        tensors), as the replay of a graph of one step on a CUDA device;
        its outputs as ``step`` gives them."""
        if not self.graphed:
            with span(self.eager_span, k=1):
                return self._one(batch)
        return self._run(1, batch, self._one, self.step)

    def _run(self, steps: int, inputs: Batch,
             eager: Callable[[Batch], Batch],
             captured: Callable[[Batch], Batch]) -> Batch:
        """Replay the graph of ``steps`` steps (``captured`` over static
        inputs) for ``inputs``' key; the key's first call runs ``eager``
        and captures it."""
        key = (steps,) + tuple((n, tuple(v.shape), v.dtype)
                               for n, v in sorted(inputs.items()))
        entry = self.graphs.get(key)
        if entry is None:
            return self._warm_and_capture(key, steps, inputs, eager,
                                          captured)
        with span(self.replay_span, k=steps):
            if self.counter is not None:
                self.counter.ensure_steps(self.counter.count + steps)
                if self.counter.tables is not self._tables[key]:
                    raise RuntimeError("the optimizer's per-step tables "
                                       "grew after the graph was captured")
            out = entry.replay(inputs)
        if steps == self.k:
            self.replays += 1
        else:
            self.single_replays += 1
            count(f"graph.{self.role}.single", 1)
        if self.counter is not None:
            self.counter.count += steps
        return out

    def _warm_and_capture(self, key: tuple, steps: int, inputs: Batch,
                          eager: Callable[[Batch], Batch],
                          captured: Callable[[Batch], Batch]) -> Batch:
        """``eager(inputs)`` on the capture stream (real work), then the
        graph of ``captured`` over static inputs of this key."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        with span(self.warm_span, k=steps):
            result = warm(self._stream, eager, inputs)
        mirror = None
        if self.counter is not None:
            self.counter.ensure_steps(self.counter.count + steps)
            mirror = self.counter.count
        self.graphs[key] = CapturedGraph(captured, inputs, self._stream,
                                         self.pool, self.generators,
                                         role=self.role)
        if self.counter is not None:
            self.counter.count = mirror
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
                entry = self.graphs[key] = CapturedGraph(
                    call, values, self._stream, role="decode")
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
    ``valid`` into the resident store, packed rows and ``img_idx``,
    host-fed packed rows with their pixels, or host-fed rows."""
    return GroupedSteps(train_step, k, train_step.optimizer.device,
                        generators=[train_step.generator],
                        counter=train_step.optimizer, pool=pool,
                        role="train")


def make_scan_eval_step(eval_step, k: int, device: torch.device,
                        pool=None) -> GroupedSteps:
    """K eval batches a dispatch: ``{"probs", "loss"}`` ``[K, B]``; its
    ``with_store(arrays)`` (a device-resident split's) takes batches of
    ``idx`` rows and gathers them there (``train.step.gather_batch``)."""

    def step(batch: Batch, store: Optional[Batch] = None) -> Batch:
        probs, loss = eval_step(batch if store is None
                                else gather_batch(batch, store))
        return {"probs": probs, "loss": loss}

    return GroupedSteps(step, k, device, pool=pool, role="eval")


def graph_pool(device: torch.device) -> Optional[object]:
    """One memory pool for all of a run's graphs (train and eval, one per
    shape): they replay one at a time on one stream.  None on the CPU."""
    return (torch.cuda.graph_pool_handle()
            if torch.device(device).type == "cuda" else None)
