"""K steps in one dispatch (port of ``make_scan_train_step``,
``make_packed_gather_scan_train_step``, ``make_scan_eval_step`` and
``make_gather_scan_eval_step`` in ``mpmc_tpu/train/step.py``).

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

A capture that fails raises; nothing falls back to eager steps.  On the
CPU there are no graphs: a group is K eager calls of the same step.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from mpmc_tpu_torch.ops import build

Batch = Dict[str, torch.Tensor]


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
        self.graphs: Dict[tuple, dict] = {}
        self.replays = 0
        self.captures = 0
        self._stream = None

    def _eager(self, group: Batch) -> Batch:
        outs: List[Batch] = []
        for j in range(self.k):
            outs.append(self.step({n: v[j].to(self.device, non_blocking=True)
                                   for n, v in group.items()}))
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
            if self.counter.tables is not entry["tables"]:
                raise RuntimeError("the optimizer's per-step tables grew "
                                   "after the graph was captured")
        for n, buf in entry["inputs"].items():
            buf.copy_(group[n], non_blocking=True)
        entry["graph"].replay()
        build.add_launches(entry["tally"])
        entry["replays"] += 1
        self.replays += 1
        if self.counter is not None:
            self.counter.count += self.k
        return {n: v.clone() for n, v in entry["outputs"].items()}

    def _warm_and_capture(self, key: tuple, group: Batch) -> Batch:
        """The group's K steps eagerly on the capture stream, then the
        graph of K steps over static inputs of this shape."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        stream, current = self._stream, torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            result = self._eager(group)
        current.wait_stream(stream)
        if self.counter is not None:
            self.counter.ensure_steps(self.counter.count + self.k)
        inputs = {n: torch.empty(v.shape, dtype=v.dtype, device=self.device)
                  for n, v in group.items()}
        for n, buf in inputs.items():
            buf.copy_(group[n], non_blocking=True)
        torch.cuda.synchronize(self.device)
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        count = self.counter.count if self.counter is not None else None
        with build.capturing() as tally, torch.cuda.graph(
                graph, pool=self.pool, stream=stream):
            outs = [self.step({n: v[j] for n, v in inputs.items()})
                    for j in range(self.k)]
            outputs = {n: torch.stack([o[n] for o in outs]) for n in outs[0]}
        if self.counter is not None:
            self.counter.count = count
        self.graphs[key] = {"graph": graph, "inputs": inputs,
                            "outputs": outputs, "tally": dict(tally),
                            "replays": 0,
                            "tables": (self.counter.tables
                                       if self.counter is not None else None)}
        self.captures += 1
        return result


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
