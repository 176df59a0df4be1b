"""The port's process mesh (``parallel/mesh.py``) and the command line's
mesh flags, without spawning: the mesh shapes, axis names and errors of
the JAX ``make_mesh`` for the same ``MeshConfig``s; the refusals outside a
launched world; the recipe's ``plain`` rule and ``--pack-rows`` defaults;
every flag of the JAX ``train`` parser, with its default."""

import argparse
import types

import jax
import pytest

from mpmc_tpu.cli.main import _resolve_recipe as j_resolve_recipe
from mpmc_tpu.cli.main import build_parser as j_build_parser
from mpmc_tpu.config import MeshConfig as JMeshConfig
from mpmc_tpu.parallel.mesh import make_mesh as j_make_mesh
from mpmc_tpu_torch.cli.experiments import _check_layout
from mpmc_tpu_torch.cli.main import _resolve_recipe, build_parser
from mpmc_tpu_torch.config import DataConfig, MeshConfig, TrainConfig
from mpmc_tpu_torch.parallel import distributed
from mpmc_tpu_torch.parallel.mesh import make_layout, make_mesh, mesh_shape

MESHES = [
    ({}, 8), ({}, 1), ({"num_data_shards": 4}, 8),
    ({"num_data_shards": 8}, 4),
    ({"num_fold_shards": 2}, 8), ({"num_fold_shards": 5}, 5),
    ({"fold_parallel": True}, 4), ({"num_fold_shards": 3}, 8),
    ({"num_model_shards": 2}, 8), ({"num_model_shards": 2,
                                    "num_data_shards": 2}, 8),
    ({"num_model_shards": 3}, 8), ({"num_model_shards": 4,
                                    "num_data_shards": 4}, 8),
    ({"num_stage_shards": 4}, 8), ({"num_stage_shards": 3}, 8),
    ({"num_seq_shards": 2, "num_data_shards": 2}, 4),
    ({"num_seq_shards": 4, "num_data_shards": 4}, 8),
    ({"num_seq_shards": 2, "num_model_shards": 2}, 8),
    ({"num_stage_shards": 2, "num_fold_shards": 2}, 8),
    ({"num_seq_shards": 2, "fold_parallel": True}, 8),
]


def _outcome(fn):
    try:
        return fn()
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("fields,n", MESHES,
                         ids=[f"{f}-{n}" for f, n in MESHES])
def test_mesh_shapes_and_errors_match_jax(fields, n):
    def jax_side():
        mesh = j_make_mesh(JMeshConfig(**fields), jax.devices()[:n])
        return tuple(mesh.devices.shape), tuple(mesh.axis_names)

    want = _outcome(jax_side)
    got = _outcome(lambda: mesh_shape(MeshConfig(**fields), n))
    assert got == want
    if want[0] != "error":
        assert got[1] == MeshConfig(**fields).axis_names()


def test_mesh_needs_a_launched_world_that_it_fills():
    assert not distributed.initialize("cpu")          # nothing launched
    assert make_layout(MeshConfig(), "cpu") is None
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4 "):
        make_layout(MeshConfig(num_data_shards=4), "cpu")
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 8 "):
        make_mesh(MeshConfig(num_seq_shards=2, num_data_shards=4))
    with pytest.raises(ValueError, match="mutually exclusive"):
        make_mesh(MeshConfig(num_stage_shards=2, num_seq_shards=2))


@pytest.mark.parametrize("flags", [
    [], ["--data-shards", "2"], ["--pipeline-stages", "2"],
    ["--seq-shards", "2"], ["--model-shards", "2"], ["--fold-shards", "5"],
    ["--fold-parallel"], ["--recipe", "reference"],
    ["--seq-shards", "2", "--pack-rows", "4"]])
@pytest.mark.parametrize("subtask", ["2a", "2c"])
def test_recipe_packs_as_jax_under_the_mesh_flags(flags, subtask):
    argv = ["train", "--subtask", subtask, "-tr", "a", "-te", "b", *flags]
    args = build_parser().parse_args(argv)
    jargs = j_build_parser().parse_args(argv)
    _resolve_recipe(args)
    j_resolve_recipe(jargs)
    assert args.pack_rows == jargs.pack_rows
    assert args.scan_steps == jargs.scan_steps


def _train_actions(parser: argparse.ArgumentParser):
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {a.dest: (set(a.option_strings), a.default)
            for a in sub.choices["train"]._actions if a.dest != "help"}


def test_train_parser_takes_every_jax_flag_with_its_default():
    want = _train_actions(j_build_parser())
    got = _train_actions(build_parser())
    # The JAX parser defaults the two manifests to files of its host;
    # the port requires them.
    for dest in ("train_file_path", "dev_file_path"):
        assert want.pop(dest)[0] == got.pop(dest)[0]
    missing = sorted(set(want) - set(got))
    assert not missing, missing
    for dest, (options, default) in want.items():
        assert options <= got[dest][0], dest
        assert got[dest][1] == default, dest


def test_recipe_keeps_4_2a_rows_and_8_data_ranks_are_refused():
    """A layout never changes what is trained: at --data-shards 8 the
    recipe keeps JAX's 4 packed 2A rows, and the driver refuses them (not
    divisible by the data extent), naming the flag, as the JAX driver
    does."""
    argv = ["train", "--subtask", "2a", "-tr", "a", "-te", "b",
            "--data-shards", "8"]
    args = build_parser().parse_args(argv)
    jargs = j_build_parser().parse_args(argv)
    _resolve_recipe(args)
    j_resolve_recipe(jargs)
    assert args.pack_rows == jargs.pack_rows == 4
    cfg = TrainConfig(data=DataConfig(batch_size=16, pack_rows=4))
    layout = types.SimpleNamespace(data_size=8, inner=None)
    with pytest.raises(ValueError, match="--pack-rows=4 not divisible by "
                                         "the data-axis extent 8"):
        _check_layout(cfg, layout, "text")


def test_a_world_that_cannot_form_raises(monkeypatch):
    """No quiet fallback to one process: a launched world whose process
    has no rank is refused."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("MPMC_PROCESS_ID", raising=False)
    with pytest.raises(RuntimeError, match="has no RANK"):
        distributed.initialize("cpu")
