"""Sparse (lazy) row-Adam for the word-embedding tables (port of
``mpmc_tpu/train/sparse_opt.py``; ``--embedding-optimizer sparse``).

A step's gradient on a ``[V, H]`` table is nonzero only on the rows of the
batch's tokens.  Instead of Adam's full-table read-modify-write, the rows
are updated lazily, as torch's ``SparseAdam`` does:

* the touched rows are the ``K`` largest by the L1 norm of their gradient
  row (``torch.topk``), those with a norm above 0; ``K`` is the driver's
  per-step support bound (the batch's token count), so no touched row is
  skipped;
* Adam's exact update (global-step bias correction, the same b1, b2, eps)
  runs on those rows through the dense optimizer's own arithmetic
  (``train.step.adam_updates``), so a touched row is bit-equal to dense
  Adam's;
* untouched rows are frozen: no momentum decay, no parameter drift (dense
  Adam keeps moving a row on its decaying momentum).

Selected slots without gradient (fewer touched rows than ``K``) are
masked: they write back the values they read, so they change neither the
moments nor the parameters.  ``topk``'s indices are distinct, so no two
slots write one row.  The state is a full f32 ``mu`` and ``nu`` per table,
beside the optimizer's step count.  Nothing is read back from the
device, so a CUDA graph can capture the update.
"""

from __future__ import annotations

from typing import Dict

import torch


@torch.no_grad()
def sparse_adam_rows(param: torch.Tensor, grad: torch.Tensor,
                     state: Dict[str, torch.Tensor], neg_lr, bc1, bc2,
                     support_rows: int) -> None:
    """Lazy Adam in place on one ``[V, H]`` table ``param`` and its f32
    ``state["mu"]``, ``state["nu"]``, with the step's negated learning
    rate ``neg_lr`` and Adam's bias corrections ``bc1``, ``bc2`` (0-dim
    device tensors, or floats), on at most ``support_rows`` rows, those
    whose ``grad`` row is nonzero, largest L1 norm first."""
    from mpmc_tpu_torch.train.step import adam_updates
    k = min(int(support_rows), grad.shape[0])
    g = grad.to(torch.float32)
    vals, idx = torch.topk(g.abs().sum(dim=1), k)
    valid = (vals > 0)[:, None]
    mu, nu = state["mu"], state["nu"]
    mu_rows, nu_rows = mu.index_select(0, idx), nu.index_select(0, idx)
    rows = {"mu": mu_rows.clone(), "nu": nu_rows.clone()}
    update = adam_updates([g.index_select(0, idx)], [rows], bc1, bc2)[0]
    update.mul_(neg_lr)
    p_rows = param.index_select(0, idx)
    mu.index_copy_(0, idx, torch.where(valid, rows["mu"], mu_rows))
    nu.index_copy_(0, idx, torch.where(valid, rows["nu"], nu_rows))
    param.index_copy_(0, idx, torch.where(valid, p_rows + update, p_rows))
