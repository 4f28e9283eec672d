"""The port's parallel/ against the JAX package's, with no process group.

What needs no rank: the config -> mesh rule, the pipeline's block split and
stage entries, the tensor-parallel shards (leaf for leaf against JAX's
spin_tp_specs on the same converted weights, the layout transposed), the
expert stacking, the data-axis helpers, the estimator's layout checks and
the CLI's flags. JAX runs on the virtual 8-device CPU mesh of
tests/conftest.py. The spawned gloo ranks are tests/test_torch_parallel_ranks.py.
"""

import types

import jax
import numpy as np
import pytest
import torch

from poserisk_release_tpu_torch import cli
from poserisk_release_tpu_torch.body.smpl import SMPLFamily
from poserisk_release_tpu_torch.config import default_config
from poserisk_release_tpu_torch.models.convert import spin_state_dict_to_flax
from poserisk_release_tpu_torch.models.spin import init_spin_params, load_mean_params
from poserisk_release_tpu_torch.parallel import distributed, expert, mesh, pipeline, spmd
from poserisk_release_tpu_torch.pipeline import PoseEstimator
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def weights():
    """A seeded HMR state_dict and the same weights as a Flax tree."""
    sd = init_spin_params(torch.Generator().manual_seed(3), load_mean_params(""))
    return sd, spin_state_dict_to_flax(sd)


LAYOUTS = [{"model": 4}, {"num_devices": 1}, {"num_devices": 2, "model": 4},
           {"stage": 4, "num_devices": 2, "stage_microbatches": 2},
           {"expert": 4, "num_devices": 2}, {"expert": 4}, {"stage": 2, "model": 2}]


@pytest.mark.parametrize("parallel", LAYOUTS)
def test_mesh_shape_matches_jax(parallel):
    """The axis order and sizes of the JAX mesh_from_config on 8 devices
    (test_mesh_from_config_shapes's layouts and the product layouts)."""
    from poserisk_release_tpu.config import default_config as jax_default_config
    from poserisk_release_tpu.parallel import spmd as jax_spmd

    pcfg = default_config().replace(PARALLEL=parallel).PARALLEL
    jcfg = jax_default_config().replace(PARALLEL=parallel).PARALLEL
    assert spmd.model_axes_from_config(pcfg) == jax_spmd.model_axes_from_config(jcfg)
    want = jax_spmd.mesh_from_config(jcfg)
    got = spmd.mesh_shape_from_config(pcfg, len(jax.devices()))
    if want is None:
        assert got is None
    else:
        assert list(got.items()) == list(dict(want.shape).items())


@pytest.mark.parametrize("n_stages", [2, 3, 4])
def test_balanced_split_and_stage_entries_match_jax(weights, n_stages):
    from poserisk_release_tpu.parallel import pipeline as jax_pipeline

    sd, flax = weights
    split = pipeline.balanced_split(sd, n_stages)
    assert split == jax_pipeline.balanced_split(flax, n_stages)
    jax_entries, _sizes = jax_pipeline.stage_param_entries(flax, split)
    for stage, entries in enumerate(pipeline.stage_param_entries(sd, split)):
        # Leaf for leaf: the stage's state_dict slice, through the weight
        # bridge, is JAX's stage slice of the same tree.
        got = {k: np.asarray(v) for k, v in flatten(spin_state_dict_to_flax(entries)).items()}
        want = {tuple(keys): shape for keys, _off, shape, _dtype in jax_entries[stage]}
        assert set(got) == set(want)
        for keys, shape in want.items():
            assert got[keys].shape == tuple(shape)
            np.testing.assert_array_equal(got[keys], leaf(flax, keys))


def flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def leaf(tree, keys):
    for k in keys:
        tree = tree[k]
    return np.asarray(tree)


def test_stage_shapes_match_jax():
    from poserisk_release_tpu.parallel import pipeline as jax_pipeline

    for hw in (64, 224):
        assert pipeline.hmr_stage_shapes(hw) == jax_pipeline.hmr_stage_shapes(hw)
        for b0 in range(len(pipeline._BLOCKS) + 1):
            assert pipeline.stage_input_shape(hw, b0) == jax_pipeline.stage_input_shape(hw, b0)


def test_stage_modules_compose_to_the_hmr(weights):
    """The stages, run one after another on their entries, are the HMR."""
    from poserisk_release_tpu_torch.models.spin import HMR

    sd, _ = weights
    model = HMR()
    model.load_state_dict(sd)
    model.eval()
    crops = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    split = pipeline.balanced_split(sd, 3)
    x = crops
    with torch.inference_mode():
        want = model(crops)
        for s, entries in enumerate(pipeline.stage_param_entries(sd, split)):
            stage = pipeline.PipelineStage(split[s], split[s + 1], s == 2)
            stage.load_state_dict(entries)
            x = stage.eval()(x)
    for w, g in zip(want, x):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("size", [2, 4])
def test_tp_shards_match_jax_specs(weights, size):
    """Every leaf's shard on every model rank is JAX's spin_tp_specs slice
    of the same leaf (conv OIHW dim 0 == HWIO dim 3, fc2's columns == its
    kernel's rows)."""
    from poserisk_release_tpu.parallel.spmd import spin_tp_specs

    sd, flax = weights
    specs = flatten(spin_tp_specs(flax))
    n_sharded = 0
    for index in range(size):
        shard = flatten(spin_state_dict_to_flax(spmd.tp_shard_state_dict(sd, size, index)))
        assert set(shard) == set(specs)
        for keys, spec in specs.items():
            want = leaf(flax, keys)
            for dim, axis in enumerate(tuple(spec)):
                if axis == "model":
                    want = np.split(want, size, axis=dim)[index]
                    n_sharded += 1
            np.testing.assert_array_equal(np.asarray(shard[keys]), want)
    assert n_sharded > 200 * size
    with pytest.raises(ValueError, match="divide 64"):
        spmd.tp_shard_state_dict(sd, 3, 0)


def test_stack_expert_trees_matches_jax():
    from poserisk_release_tpu.parallel.expert import stack_expert_trees as jax_stack
    from poserisk_release_tpu.parallel.spmd import make_axes_mesh

    rng = np.random.default_rng(4)
    trees = [{"a": rng.random((3, 2), dtype=np.float32), "b": rng.random(5, dtype=np.float32)}
             for _ in range(3)]
    want = jax_stack(trees, make_axes_mesh({"expert": 4}))
    got = expert.stack_expert_trees([{k: torch.from_numpy(v) for k, v in t.items()}
                                     for t in trees], 4)
    for key in ("a", "b"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    with pytest.raises(ValueError) as jax_err:
        jax_stack(trees, make_axes_mesh({"expert": 2}))
    with pytest.raises(ValueError) as err:
        expert.stack_expert_trees([{"a": torch.zeros(1)}] * 3, 2)
    assert str(err.value) == str(jax_err.value)
    family = SMPLFamily(default_config().SPIN.smpl_model_dir)
    stacked = expert.stack_gender_experts(family, 4)
    assert stacked["v_template"].shape[0] == 4
    torch.testing.assert_close(stacked["v_template"][3], stacked["v_template"][0])


def test_pad_to_multiple_and_global_batch_slice():
    from poserisk_release_tpu.parallel import distributed as jax_distributed
    from poserisk_release_tpu.parallel import mesh as jax_mesh

    x = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
    for n, multiple in ((10, 4), (10, 5), (7, 8), (1, 3), (10, 1)):
        want, want_n = jax_mesh.pad_to_multiple(x[:n], multiple)
        got, got_n = mesh.pad_to_multiple(x[:n], multiple)
        tgot, tn = mesh.pad_to_multiple(torch.from_numpy(x[:n]), multiple)
        assert got_n == tn == want_n
        np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(tgot.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="empty"):
        mesh.pad_to_multiple(np.zeros((0, 3)), 4)
    with pytest.raises(ValueError, match="empty"):
        mesh.pad_to_multiple(torch.zeros(0, 3), 4)
    assert distributed.global_batch_slice(64) == jax_distributed.global_batch_slice(64)


def test_initialize_distributed_is_a_single_process_noop():
    import torch.distributed as dist

    info = distributed.initialize_distributed()
    assert info == {"process_index": 0, "process_count": 1, "local_devices": 1,
                    "global_devices": 1}
    assert not dist.is_initialized()
    # Without a mesh the helpers are identities.
    x = torch.arange(6)
    assert mesh.shard_rows(x, None) is x and mesh.gather_rows(x, None) is x
    assert mesh.axis_size(None, "data") == 1


def test_estimator_layout_errors():
    """JAX's ValueErrors, raised before any process group is needed (pp
    with tp, sp or ep; int8 with tp), and a mesh needing a group."""
    cfg = default_config()
    family = SMPLFamily(cfg.SPIN.smpl_model_dir)
    with pytest.raises(ValueError, match="lack the configured data axis"):
        PoseEstimator(cfg, family, device="cpu",
                      mesh=types.SimpleNamespace(mesh_dim_names=("model",)))
    with pytest.raises(ValueError, match="cannot combine"):
        PoseEstimator(cfg.replace(PARALLEL={"stage": 4, "model": 2, "num_devices": 1}),
                      family, device="cpu")
    with pytest.raises(ValueError, match="cannot combine"):
        PoseEstimator(cfg.replace(PARALLEL={"stage": 2, "expert": 3}), family, device="cpu")
    with pytest.raises(ValueError, match="spin_int8"):
        PoseEstimator(cfg.replace(PARALLEL={"model": 4, "num_devices": 2}), family,
                      spin_int8=True, device="cpu")
    with pytest.raises(ValueError, match="cannot combine"):
        PoseEstimator(cfg.replace(PARALLEL={"stage": 2, "spatial": 2}), family, device="cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        PoseEstimator(cfg.replace(PARALLEL={"num_devices": 2}), family, device="cpu")


def test_streaming_under_a_mesh_without_a_group_raises():
    """The streaming scorer takes the mesh PARALLEL describes, which needs
    the process group the ranks join (tests/test_torch_parallel_ranks.py
    streams on gloo ranks); it never falls back to one device."""
    from poserisk_release_tpu_torch.streaming import StreamingScorer

    for parallel in ({"num_devices": 2}, {"model": 2}, {"spatial": 2}):
        with pytest.raises(RuntimeError, match="no process group"):
            StreamingScorer(cfg=default_config().replace(PARALLEL=parallel), device="cpu")


@pytest.mark.parametrize("argv,parallel", [
    (["--num_devices", "2"], {"num_devices": 2}),
    (["--tp", "2", "--num_devices", "2"], {"model": 2, "num_devices": 2}),
    (["--pp", "2", "--pp_microbatches", "2"], {"stage": 2, "stage_microbatches": 2}),
    (["--ep", "4"], {"expert": 4}),
    (["--sp", "2"], {"spatial": 2}),
    (["--streaming", "--num_devices", "2"], {"num_devices": 2}),
])
def test_cli_flags_reach_the_config_and_spawn_the_world(argv, parallel, monkeypatch, tmp_path):
    """The mesh flags map onto cfg.PARALLEL as in the JAX CLI, and without a
    launcher the CLI spawns num_devices (one on the CPU) times the model
    axes ranks on gloo with --cpu, --streaming included."""
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    for key, value in parallel.items():
        assert getattr(cfg.PARALLEL, key) == value
    spawned = {}

    def fake_run_ranks(fn, world, backend, init_method, args=(), timeout=None):
        spawned.update(world=world, backend=backend, init=init_method, cfg=args[1])

    monkeypatch.setattr(cli, "run_ranks", fake_run_ranks)
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert cli.main(["--cpu", "--input", str(tmp_path / "v.mp4")] + argv) == 0
    p = cfg.PARALLEL
    n_model = p.model * p.stage * p.expert * p.spatial
    dp = p.num_devices or 1
    assert spawned["world"] == dp * n_model and spawned["backend"] == "gloo"
    assert spawned["init"].startswith("file://")
    assert spawned["cfg"].PARALLEL.num_devices == dp
