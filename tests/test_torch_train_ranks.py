"""The port's training step under a mesh, on gloo ranks on the CPU.

The port's counterpart of tests/test_parallelism.py::
test_train_step_tensor_parallel: one world of 4 ranks (spawned, a file://
init under tmp_path, one thread per rank) runs one SGD step in each layout
on the batch of tests/test_torch_train.py (8 crops of 64x64, lr 1e-3, remat
on under dp 2 x tp 2):

  * dp 2 x tp 2: the data axis splits the batch, the model axis Megatron-
    shards the HMR through its differentiable forward;
  * dp 2, with a second axis ('stage') that the training step does not
    shard: JAX's TrainState.create replicates the parameters over such an
    axis and does not split the batch along it, and so does the port;
  * dp 4.

Each layout's loss and gathered parameters are held against the
single-process step: loss within 1e-4 relative, parameters within 5e-4
absolute (the JAX test's class: the reduction order differs), and the
update itself, leaf by leaf, within 1e-3 of the reference update's largest
element (assert_update_matches), every trained leaf having moved. The tp
shards of the parameters, and of the optimizer's momentum, are those of
parallel/spmd.tp_shard_state_dict. A batch the data axis does not divide
raises ValueError.
"""

import os.path as osp

import numpy as np
import pytest
import torch

from poserisk_release_tpu_torch.body.smpl import SMPLFamily
from poserisk_release_tpu_torch.config import default_config
from poserisk_release_tpu_torch.models.spin import init_spin_params, load_mean_params
from poserisk_release_tpu_torch.parallel.distributed import run_ranks
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

LAYOUTS = {"dp2_tp2": {"data": 2, "model": 2}, "dp2": {"data": 2, "stage": 2},
           "dp4": {"data": 4}}
WORLD = 4
FROZEN = ("running_mean", "running_var", "num_batches_tracked")

# SGD's update is -lr * grad. At lr 1e-3 the largest update of this batch is
# 2.6e-5 and a BN scale's is 5 f32 ulps of the scale, so neither the
# parameters' 5e-4 nor a relative limit on the update could see a wrong
# gradient. At lr 10 every leaf's update is thousands of ulps of its
# parameters, and the update compares to 1e-3 of its own size.
STEP_LR = 10.0
UPDATE_RTOL = 1e-3


def assert_update_matches(before, got, want, keys):
    """For each key, the update after - before (in f64 from the f32
    values) of `got` within UPDATE_RTOL * max|update of want| of `want`'s,
    and want's update not zero (every trained leaf moved). Returns the
    worst ratio and the largest reference update, for a failure message."""
    worst, largest = 0.0, 0.0
    for key in keys:
        b = np.asarray(before[key], np.float64)
        d_want = np.asarray(want[key], np.float64) - b
        d_got = np.asarray(got[key], np.float64) - b
        scale = np.abs(d_want).max()
        assert scale > 0, f"{key} did not move"
        ratio = np.abs(d_got - d_want).max() / scale
        assert ratio <= UPDATE_RTOL, f"{key}: update off by {ratio:.3g} of its max {scale:.3g}"
        worst, largest = max(worst, ratio), max(largest, scale)
    return worst, largest


def batch(n=8, seed=11):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 64, 64, 3).astype(np.float32),
            (rng.randn(n, 24, 3) * 0.1).astype(np.float32))


def port_cfg():
    return default_config().replace(MODEL={"input_shape": (64, 64)})


def rank_main(rank, root):
    from torch.distributed.device_mesh import init_device_mesh

    from poserisk_release_tpu_torch.parallel.spmd import tp_shard_state_dict
    from poserisk_release_tpu_torch.train.step import TrainState, model_tensors

    torch.set_num_threads(1)
    sd = torch.load(osp.join(root, "weights.pt"))
    family = SMPLFamily(port_cfg().SPIN.smpl_model_dir)
    out = {}
    for name, axes in LAYOUTS.items():
        mesh = init_device_mesh("cpu", tuple(axes.values()), mesh_dim_names=tuple(axes))
        state = TrainState.create(port_cfg(), family, variables=sd, optimizer_name="sgd",
                                  lr=STEP_LR, remat=name == "dp2_tp2", mesh=mesh, device="cpu")
        rec = {"param_bytes": state.param_bytes}
        if "model" in axes:
            shard = tp_shard_state_dict(sd, 2, mesh.get_local_rank("model"))
            rec["shards_equal"] = all(torch.equal(v, shard[k])
                                      for k, v in model_tensors(state.model).items())
        state, rec["loss"] = state.step(*batch())
        if "model" in axes:
            shapes = [(tuple(p.shape), tuple(state.optimizer.state[p]["momentum_buffer"].shape))
                      for g in state.optimizer.param_groups for p in g["params"]]
            rec["moments_on_shards"] = all(a == b for a, b in shapes)
        whole = state.state_dict()  # a collective under tp: every rank calls it
        if rank == 0:
            rec["state_dict"] = whole
        try:
            state.step(*batch(5))
            rec["indivisible_raises"] = False
        except ValueError:
            rec["indivisible_raises"] = True
        out[name] = rec
    torch.save(out, osp.join(root, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The single-process step and the 4-rank world's results."""
    from poserisk_release_tpu_torch.train.step import TrainState

    root = tmp_path_factory.mktemp("train_ranks")
    sd = init_spin_params(torch.Generator().manual_seed(3), load_mean_params(""))
    torch.save(sd, root / "weights.pt")
    single = TrainState.create(port_cfg(), SMPLFamily(port_cfg().SPIN.smpl_model_dir),
                               variables=sd, optimizer_name="sgd", lr=STEP_LR, remat=False,
                               device="cpu")
    single, loss = single.step(*batch())
    run_ranks(rank_main, WORLD, "gloo", f"file://{root / 'init'}", args=(str(root),),
              timeout=240)
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return sd, loss, single.state_dict(), ranks


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_mesh_step_matches_single_process(case, name):
    sd, loss, want, ranks = case
    for r in ranks:
        np.testing.assert_allclose(r[name]["loss"], loss, rtol=1e-4)
    got = ranks[0][name]["state_dict"]
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), atol=5e-4, err_msg=key)
    assert_update_matches(sd, got, want, [k for k in sd if not k.endswith(FROZEN)])
    assert all(r[name]["indivisible_raises"] for r in ranks)


def test_tp_shards_are_tp_shard_state_dict(case):
    """Under dp 2 x tp 2 every rank holds its tp_shard_state_dict shard,
    its momentum takes the same shapes, and it holds half of the sharded
    entries' bytes (the heads and init_* stay whole)."""
    sd, _loss, _want, ranks = case
    whole = sum(v.numel() * v.element_size() for k, v in sd.items()
                if not k.endswith("num_batches_tracked"))
    for r in ranks:
        rec = r["dp2_tp2"]
        assert rec["shards_equal"] and rec["moments_on_shards"]
        assert whole // 2 < rec["param_bytes"] < 0.52 * whole
        assert r["dp4"]["param_bytes"] == r["dp2"]["param_bytes"]
