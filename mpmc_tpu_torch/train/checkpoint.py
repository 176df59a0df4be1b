"""Checkpoint and exact-state resume (port of ``mpmc_tpu/train/checkpoint.py``
on ``torch.save`` and ``torch.load(weights_only=True)``).

The contract of the JAX package's orbax ``CheckpointManager`` setup:

* saves are step-addressed, ``<directory>/<step>/state.pt``, and a step at
  or below the newest kept one is skipped (orbax's ``should_save``);
* best-k retention: after a save, the ``max_to_keep`` checkpoints with the
  highest ``test_f1`` (0 without one) stay, ties kept in favour of the
  newer step;
* the ``ckpt_meta.json`` sidecar records each saved step's metrics, which
  ``fit`` reads back on resume (the best F1 and its threshold);
* ``restore_latest`` loads the newest kept checkpoint into its target;
* saves are asynchronous, as orbax's: ``save`` copies the state to host
  memory and a background thread writes it (into ``<step>.tmp``, renamed
  to ``<step>`` when complete, so a crash mid-write leaves the previous
  checkpoint as the newest); ``wait`` blocks until it is on disk and
  raises its error.  One save is in flight at a time, and every read
  waits for it first.

The state is what :meth:`mpmc_tpu_torch.train.step.TrainStep.state_dict`
gives: the model's weights and buffers, the optimizer's state and step,
and the generator's state.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
from typing import Any, Dict, List, Optional

import torch

log = logging.getLogger(__name__)

STATE_FILE = "state.pt"
META_FILE = "ckpt_meta.json"


def to_host(state):
    """A copy of ``state`` (nested dicts of tensors and numbers) in host
    memory, which later steps do not touch."""
    if isinstance(state, dict):
        return {k: to_host(v) for k, v in state.items()}
    if isinstance(state, torch.Tensor):
        return state.detach().to("cpu", copy=True)
    return state


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 2):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def all_steps(self) -> List[int]:
        """The kept checkpoints' steps, ascending."""
        self.wait()
        return self._kept()

    def _kept(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.exists(
                          os.path.join(self.directory, n, STATE_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _read_meta(self) -> Dict[str, Dict]:
        path = os.path.join(self.directory, META_FILE)
        if not os.path.exists(path):
            return {}
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def save(self, state: Dict, step: int,
             metrics: Optional[Dict] = None) -> None:
        """Save ``state`` as step ``step`` with its ``metrics``: the copy
        to host memory happens now, the write (then dropping all but the
        best ``max_to_keep``) in the background.  The sidecar records the
        metrics even when the step is skipped, as the JAX package's
        does."""
        clean = {k: float(v) for k, v in (metrics or {}).items()}
        latest = self.latest_step()
        meta = self._read_meta()
        meta[str(step)] = clean
        with open(os.path.join(self.directory, META_FILE), "w") as f:
            json.dump(meta, f)
        if latest is not None and latest >= step:
            log.warning("checkpoint step %d not saved: step %d is newer",
                        step, latest)
            return
        self._writer = threading.Thread(
            target=self._write, args=(to_host(state), step, meta),
            name=f"checkpoint-{step}")
        self._writer.start()
        log.info("checkpoint saving @ step %d (%s)", step, metrics)

    def _write(self, state: Dict, step: int, meta: Dict[str, Dict]) -> None:
        try:
            final = os.path.join(self.directory, str(step))
            tmp = final + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(state, os.path.join(tmp, STATE_FILE))
            os.replace(tmp, final)
            self._retain(meta)
        except Exception as err:     # raised again by wait()
            self._error = err

    def _retain(self, meta: Dict[str, Dict]) -> None:
        steps = self._kept()
        if len(steps) <= self.max_to_keep:
            return
        ranked = sorted(steps, key=lambda s: meta.get(str(s), {}).get(
            "test_f1", 0.0))
        for step in ranked[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(step)))

    def latest_metrics(self) -> Optional[Dict]:
        """Metrics recorded with the newest kept checkpoint (or None)."""
        step = self.latest_step()
        if step is None:
            return None
        return self._read_meta().get(str(step))

    def restore_latest(self, target) -> Any:
        """Load the newest kept checkpoint into ``target`` (an object with
        ``load_state_dict``, e.g. a ``TrainStep``) and return it; ``target``
        is returned unchanged when there is none."""
        step = self.latest_step()
        if step is None:
            return target
        state = torch.load(os.path.join(self.directory, str(step),
                                        STATE_FILE),
                           map_location="cpu", weights_only=True)
        target.load_state_dict(state)
        log.info("restored checkpoint @ step %d", step)
        return target

    def wait(self) -> None:
        """Block until the save in flight is on disk; raise its error."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
