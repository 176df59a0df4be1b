"""The process mesh (port of ``mpmc_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``jax.sharding.Mesh``; here each
process of a launched world (``parallel/distributed.py``) is one device,
and :func:`make_mesh` arranges the world as a
``torch.distributed.device_mesh.DeviceMesh`` with the JAX package's axis
names and layouts: ``(fold, data)`` for fold-parallel training, ``(data,
model)``, ``(data, stage)`` or ``(data, seq)`` when one of those axes is
sharded, else ``(data,)``.  :func:`mesh_shape` holds JAX's rules and
errors; the extents must multiply to the world size, and a data extent of
1 is unspecified and takes what the other axis leaves.

:class:`Layout` is one rank's view of the mesh: the process group, extent
and coordinate of each axis.  In place of JAX's ``batch_sharding`` and
``stacked_batch_sharding`` each rank feeds its rows of every global batch
(``train.step.GradSync.rows``, ``distributed.host_local_batch_slice``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from mpmc_tpu_torch.config import MeshConfig


def mesh_shape(cfg: MeshConfig, n: int) -> Tuple[Tuple[int, ...],
                                                   Tuple[str, ...]]:
    """The mesh shape and axis names the JAX ``make_mesh`` gives ``cfg``
    over ``n`` devices, with its errors.  JAX leaves devices beyond a
    requested data extent idle; :func:`make_mesh` refuses that."""
    exclusive = [("tensor-parallel", cfg.num_model_shards),
                 ("pipeline-parallel", cfg.num_stage_shards),
                 ("sequence-parallel", cfg.num_seq_shards)]
    active = [name for name, extent in exclusive if extent > 1]
    if len(active) > 1 or (active and cfg.is_fold_parallel):
        raise ValueError(
            "mutually exclusive parallelism modes requested: "
            + ", ".join(active + (["fold-parallel"]
                                  if cfg.is_fold_parallel else [])))
    if cfg.is_fold_parallel:
        if n % cfg.num_fold_shards:
            raise ValueError(
                f"{n} devices not divisible by {cfg.num_fold_shards} folds")
        return ((cfg.num_fold_shards, n // cfg.num_fold_shards),
                cfg.axis_names())
    for extent, label in ((cfg.num_model_shards, "num_model_shards="),
                          (cfg.num_stage_shards, "pipeline stages"),
                          (cfg.num_seq_shards, "sequence shards")):
        if extent > 1:
            if cfg.num_data_shards > 1:
                dp = cfg.num_data_shards
            else:
                if n % extent:
                    what = (f"{label}{extent}" if label.endswith("=")
                            else f"{extent} {label}")
                    raise ValueError(
                        f"{n} devices not divisible by {what}")
                dp = n // extent
            if n < dp * extent:
                what = "model" if label.endswith("=") else label
                raise ValueError(f"{n} devices < data x {what} = "
                                 f"{dp * extent}")
            return (dp, extent), cfg.axis_names()
    if cfg.num_data_shards > 1:
        if n < cfg.num_data_shards:
            raise ValueError(
                f"{n} devices < num_data_shards={cfg.num_data_shards}")
        n = cfg.num_data_shards
    return (n,), (cfg.data_axis,)


def torchrun_line(processes: int) -> str:
    return (f"torchrun --nproc-per-node {processes} -m "
            "mpmc_tpu_torch.cli.main train ...")


def wants_mesh(cfg: MeshConfig) -> bool:
    """True when ``cfg`` asks for more than one process."""
    return max(cfg.num_fold_shards, cfg.num_data_shards,
               cfg.num_model_shards, cfg.num_stage_shards,
               cfg.num_seq_shards) > 1


def make_mesh(cfg: Optional[MeshConfig] = None,
              world: Optional[int] = None, device_type: str = "cpu"):
    """The ``DeviceMesh`` of ``cfg`` over the launched world of ``world``
    processes (default: the current one).  Raises, naming the ``torchrun``
    line to use, when no world was launched or when the extents do not
    multiply to its size."""
    from torch.distributed.device_mesh import init_device_mesh

    cfg = cfg or MeshConfig()
    if not dist.is_initialized():
        need = math.prod(mesh_shape(cfg, _requested(cfg))[0])
        raise ValueError(
            f"the mesh asks for {need} processes but no world was "
            f"launched; run: {torchrun_line(need)}")
    world = world or dist.get_world_size()
    shape, names = mesh_shape(cfg, world)
    if math.prod(shape) != world:
        raise ValueError(
            f"mesh {dict(zip(names, shape))} holds {math.prod(shape)} "
            f"processes, not the world's {world}; run: "
            f"{torchrun_line(math.prod(shape))}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def _requested(cfg: MeshConfig) -> int:
    """The world size ``cfg``'s explicit extents add up to."""
    other = max(cfg.num_model_shards, cfg.num_stage_shards,
                cfg.num_seq_shards)
    lead = cfg.num_fold_shards if cfg.is_fold_parallel else 1
    return lead * max(cfg.num_data_shards, 1) * other


class Layout:
    """This rank's place in ``mesh`` (a ``DeviceMesh`` of ``cfg``)."""

    def __init__(self, cfg: MeshConfig, mesh):
        self.cfg, self.mesh = cfg, mesh
        self.names: Tuple[str, ...] = tuple(mesh.mesh_dim_names)
        self.shape: Dict[str, int] = {n: mesh.size(i)
                                      for i, n in enumerate(self.names)}

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        return self.mesh.get_local_rank(axis) if axis in self.shape else 0

    def group(self, axis: str):
        return self.mesh.get_group(axis) if axis in self.shape else None

    @property
    def data_size(self) -> int:
        return self.size(self.cfg.data_axis)

    @property
    def data_rank(self) -> int:
        return self.coord(self.cfg.data_axis)

    @property
    def data_group(self):
        return self.group(self.cfg.data_axis)

    @property
    def inner(self) -> Optional[str]:
        """The sharded axis beside ``data`` (model, stage or seq), if any."""
        inner = [n for n in self.names
                 if n not in (self.cfg.data_axis, self.cfg.fold_axis)]
        return inner[0] if inner else None


def fold_data_model_layout(fold: int, model: int,
                           device: torch.device) -> Layout:
    """The rank's :class:`Layout` in JAX's 3-D ``(fold, data, model)``
    composition (``tests/test_tensor_parallel.py``'s
    ``test_tp_composes_with_fold_parallel_3d_mesh``): fold groups, each
    fold's batch over ``data`` (what ``fold`` x ``model`` leaves of the
    world) and each fold's transformer weights over ``model``.  Reached
    through the library (``parallel/fold_parallel.py``, ``model_group=``)
    only: :func:`make_mesh` refuses fold parallelism with model shards,
    as JAX's ``make_mesh`` does."""
    from torch.distributed.device_mesh import init_device_mesh
    cfg = MeshConfig(fold_parallel=True)
    world = dist.get_world_size()
    if world % (fold * model):
        raise ValueError(f"a world of {world} processes does not split into "
                         f"fold {fold} x model {model}")
    names = (cfg.fold_axis, cfg.data_axis, cfg.model_axis)
    mesh = init_device_mesh(torch.device(device).type,
                            (fold, world // (fold * model), model),
                            mesh_dim_names=names)
    return Layout(cfg, mesh)


def make_layout(cfg: MeshConfig, device: torch.device) -> Optional[Layout]:
    """The rank's :class:`Layout` in a launched world, None outside one
    when ``cfg`` needs a single process (raises when it needs more)."""
    if not dist.is_initialized():
        if wants_mesh(cfg):
            make_mesh(cfg)              # raises with the torchrun line
        return None
    return Layout(cfg, make_mesh(cfg, device_type=torch.device(device).type))
