"""Faults planted in the system under test, to show that the check catches
them.  Each is a context manager that breaks one part of the timed path:

* ``frozen_state``: the optimizer step leaves every parameter and slot as
  it was (a step that returns its state unchanged);
* ``half_batch``: the training loss weighs only the first half of the
  batch's valid rows (of a packed batch's filled slots), the mean over the
  rest;
* ``half_scored``: the eval step scores the first half of each batch and
  gives the other half their mean;
* ``answer_altered``: the most confident probability of each scored
  manifest is replaced by its complement, where ``run_eval`` produces it.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def frozen_state():
    from mpmc_tpu_torch.train import step as step_mod

    def no_update(self, grads, grad_norm):
        self.count_t.add_(1)
        self.count += 1

    return _patched(step_mod.Optimizer, "step", no_update)


def half_batch():
    from mpmc_tpu_torch.train import step as step_mod
    real = step_mod.loss_from_outputs

    def loss(outputs, labels, valid, cfg, soft=None, weight=None):
        half = (torch.cumsum(valid, -1)
                <= valid.sum(-1, keepdim=True) / 2).to(valid.dtype)
        return real(outputs, labels, valid * half, cfg, soft, weight)

    return _patched(step_mod, "loss_from_outputs", loss)


def half_scored():
    from mpmc_tpu_torch.train import step as step_mod
    real = step_mod.make_eval_step

    def make(*args, **kwargs):
        inner = real(*args, **kwargs)

        def step(batch):
            probs, loss = inner(batch)
            half = probs.shape[0] // 2
            rest = probs[:half].mean().expand(probs.shape[0] - half)
            return torch.cat([probs[:half], rest]), loss

        return step

    return _patched(step_mod, "make_eval_step", make)


def answer_altered():
    from mpmc_tpu_torch.train import loop as loop_mod
    real = loop_mod.run_eval

    def run_eval(*args, **kwargs):
        res = real(*args, **kwargs)
        j = int(abs(res.probs - 0.5).argmax())
        res.probs[j] = 1.0 - res.probs[j]
        return res

    return _patched(loop_mod, "run_eval", run_eval)


FAULTS = {"frozen_state": frozen_state, "half_batch": half_batch,
          "half_scored": half_scored, "answer_altered": answer_altered}
# The faults each driver's cells can have.
BY_DRIVER = {"train": ("frozen_state", "half_batch"),
             "predict": ("half_scored", "answer_altered")}
