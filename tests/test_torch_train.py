"""The port's training side (train/*) against the JAX package's.

Losses and their gradients against jax.grad, each optimizer name against
optax over three updates, the schedules, checkpoints written by one package
and read by the other, and the single-device training step against JAX's
TrainState.step on 8 crops of 64x64 (SGD, remat off: SGD's update is linear
in the gradient, so the parameters compare at a fixed tolerance). Every
input is drawn from a generator seeded in its test.

Tolerances: losses and gradients 1e-5 relative in f32; optimizer states
1e-6 relative (the same f32 arithmetic in another order); the training step
loss 1e-4 relative and every updated parameter 5e-4 absolute, the class of
tests/test_parallelism.py::test_train_step_tensor_parallel, and each trained
leaf's update within 1e-3 of its largest element (at SGD lr 10, so that the
update stands far above the parameters' f32 rounding: see
tests/test_torch_train_ranks.py).
"""

import dataclasses
import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from poserisk_release_tpu_torch.body.smpl import SMPLFamily
from poserisk_release_tpu_torch.config import default_config
from poserisk_release_tpu_torch.models.convert import flatten_tree, spin_state_dict_to_flax
from poserisk_release_tpu_torch.models.spin import init_spin_params, load_mean_params
from poserisk_release_tpu_torch.train import datasets, losses, optim
from poserisk_release_tpu_torch.train.step import TrainState
from tests.test_torch_train_ranks import STEP_LR, assert_update_matches
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

FROZEN = ("running_mean", "running_var", "num_batches_tracked")


def t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


# -- losses -------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_case():
    rng = np.random.RandomState(5)
    verts = rng.normal(size=(2, 30, 3)).astype(np.float32)
    target = verts + rng.normal(scale=0.05, size=verts.shape).astype(np.float32)
    faces = np.stack([np.arange(28), np.arange(1, 29), np.arange(2, 30)], axis=1).astype(np.int32)
    return verts, target, faces


def _loss_pair(name, verts, target, faces, valid=None):
    """(port loss fn of verts, JAX loss fn of verts) for one loss."""
    from poserisk_release_tpu.train import losses as jl

    table, mask, _ = losses.build_laplacian_neighbors(faces, verts.shape[1])
    return {
        "coord": (lambda v: losses.coord_loss(v, t(target), None if valid is None else t(valid)),
                  lambda v: jl.coord_loss(v, target, valid)),
        "laplacian": (lambda v: losses.laplacian_loss(v, table, mask),
                      lambda v: jl.laplacian_loss(v, table, mask)),
        "laplacian_avg": (lambda v: losses.laplacian_loss(v, table, mask, average=True),
                          lambda v: jl.laplacian_loss(v, table, mask, average=True)),
        "normal": (lambda v: losses.normal_vector_loss(v, t(target), faces),
                   lambda v: jl.normal_vector_loss(v, jnp.asarray(target), faces)),
        "edge": (lambda v: losses.edge_length_loss(v, t(target), faces),
                 lambda v: jl.edge_length_loss(v, jnp.asarray(target), faces)),
    }[name]


@pytest.mark.parametrize("name", ["coord", "coord_masked", "laplacian", "laplacian_avg",
                                  "normal", "edge"])
def test_loss_and_gradient_match_jax(mesh_case, name):
    verts, target, faces = mesh_case
    valid = None
    if name == "coord_masked":
        valid = (np.random.RandomState(6).rand(2, 30, 1) > 0.5).astype(np.float32)
        name = "coord"
    port_fn, jax_fn = _loss_pair(name, verts, target, faces, valid)
    v = t(verts, grad=True)
    got = port_fn(v)
    got.backward()
    want, want_grad = jax.value_and_grad(jax_fn)(jnp.asarray(verts))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-7)


def test_laplacian_neighbors_and_loss_tuple_match_jax(mesh_case):
    from poserisk_release_tpu.train import losses as jl

    _, _, faces = mesh_case
    for got, want in zip(losses.build_laplacian_neighbors(faces, 30),
                         jl.build_laplacian_neighbors(faces, 30)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="truncate"):
        losses.build_laplacian_neighbors(faces, 30, max_degree=1)
    port, jax_tuple = losses.get_loss(faces), jl.get_loss(faces)
    assert len(port) == len(jax_tuple) == 5
    assert port[0] is port[3] is port[4] is losses.coord_loss


# -- optimizers, schedules, checkpoints ---------------------------------------

OPTIMIZERS = [("sgd", {}), ("sgd", {"weight_decay": 1e-2, "nesterov": True}),
              ("rmsprop", {}), ("adam", {}), ("adamw", {})]


@pytest.mark.parametrize("name,kwargs", OPTIMIZERS,
                         ids=["sgd", "sgd_wd_nesterov", "rmsprop", "adam", "adamw"])
def test_optimizer_matches_optax_over_three_updates(name, kwargs):
    from poserisk_release_tpu.train import optim as jo

    rng = np.random.RandomState(7)
    tree = {"w": rng.randn(3, 4).astype(np.float32), "b": rng.randn(4).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in tree.items()}
             for _ in range(3)]
    lr = 0.05

    params = {k: torch.tensor(v) for k, v in tree.items()}
    opt = optim.get_optimizer(name, lr, **kwargs)(list(params.values()))
    jopt = jo.get_optimizer(name, lr, **kwargs)
    jparams = {k: jnp.asarray(v) for k, v in tree.items()}
    jstate = jopt.init(jparams)
    for g in grads:
        for k, p in params.items():
            p.grad = torch.tensor(g[k])
        opt.step()
        updates, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)
    for k in tree:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(jparams[k]), rtol=1e-6,
                                   atol=1e-7)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer: lion"):
        optim.get_optimizer("lion", lr=0.1)


def test_rmsprop_is_not_torch_default():
    """optax's rmsprop (decay 0.9, eps inside the root) differs from
    torch.optim.RMSprop's defaults: the port keeps optax's."""
    p = torch.tensor([1.0, -2.0])
    q = p.clone()
    opt = optim.get_optimizer("rmsprop", 0.1)([p])
    ref = torch.optim.RMSprop([q], lr=0.1)
    for x in (p, q):
        x.grad = torch.tensor([1e-4, 0.5])
    opt.step()
    ref.step()
    assert not torch.allclose(p, q)


def test_schedules_match_jax():
    from poserisk_release_tpu.train import optim as jo

    sched, jsched = optim.step_schedule(0.5, [10, 20], 0.1), jo.step_schedule(0.5, [10, 20], 0.1)
    for count in (0, 9, 10, 15, 20, 25):
        assert sched(count) == pytest.approx(float(jsched(count)), rel=1e-6)
    metrics = [1.0, 0.9, 0.95, 0.95, 0.95, 0.8999, 0.7, 0.71, 0.72, 0.73]
    plateau = optim.PlateauScheduler(lr=1.0, factor=0.5, patience=1)
    jplateau = jo.PlateauScheduler(lr=1.0, factor=0.5, patience=1)
    assert [plateau.step(m) for m in metrics] == [jplateau.step(m) for m in metrics]
    assert (dataclasses.asdict(optim.get_scheduler("platue", 2.0, gamma=0.5))
            == dataclasses.asdict(jo.get_scheduler("platue", 2.0, gamma=0.5)))
    assert optim.get_scheduler("cosine", 1.0) is None and optim.get_scheduler(None, 1.0) is None
    assert optim.get_scheduler("step", 1.0, [10])(15) == pytest.approx(0.1)
    assert optim.lr_warmup(0.4, 3, 4) == jo.lr_warmup(0.4, 3, 4)


def test_lr_check_prints_like_jax(capsys):
    from poserisk_release_tpu.train import optim as jo

    assert optim.lr_check(optim.step_schedule(1.0, [2], 0.1), epoch=5) == pytest.approx(0.1)
    port = capsys.readouterr().out
    jo.lr_check(jo.step_schedule(1.0, [2], 0.1), epoch=5)
    assert port == capsys.readouterr().out


def test_checkpoints_load_in_the_other_package(tmp_path):
    from poserisk_release_tpu.train import optim as jo

    rng = np.random.RandomState(8)
    tree = {"params": {"fc1": {"kernel": rng.randn(3, 2).astype(np.float32)}},
            "opt": {"count": np.asarray(7.0, np.float32)}}
    jpath = jo.save_checkpoint(tree, epoch=3, checkpoint_dir=str(tmp_path / "jax"))
    ppath = optim.save_checkpoint(
        {"params": {"fc1": {"kernel": torch.tensor(tree["params"]["fc1"]["kernel"])}},
         "opt": {"count": torch.tensor(7.0)}},
        epoch=3, checkpoint_dir=str(tmp_path / "port"), is_best=True)
    assert osp.basename(jpath) == osp.basename(ppath) == "epoch_3.npz"
    assert osp.isfile(tmp_path / "port" / "best.npz")
    for loaded in (optim.load_checkpoint(jpath), jo.load_checkpoint(ppath)):
        got, want = flatten_tree(loaded), flatten_tree(tree)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    with np.load(ppath) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files) and int(a["__epoch__"]) == 3
    final = optim.save_checkpoint(tree, epoch=5, checkpoint_dir=str(tmp_path), end_epoch=5)
    assert final.endswith("final.npz")
    with pytest.raises(ValueError, match="No checkpoint exists"):
        optim.load_checkpoint(str(tmp_path / "none.npz"))


# -- datasets -----------------------------------------------------------------

def test_datasets_match_jax():
    from poserisk_release_tpu.train import datasets as jd

    a, b = list(range(10)), list(range(100, 103))
    assert ([datasets.MultipleDatasets([a, b], seed=4)[i] for i in range(20)]
            == [jd.MultipleDatasets([a, b], seed=4)[i] for i in range(20)])
    mix = datasets.MultipleDatasets([a, b], make_same_len=False)
    assert [mix[i] for i in range(len(mix))] == a + b
    assert datasets.sequence_windows(20, 16) == jd.sequence_windows(20, 16)
    feats = np.random.RandomState(9).normal(size=(20, 4))
    for w in ((2, 17), (3, 3)):
        np.testing.assert_array_equal(datasets.gather_window(feats, w, 16),
                                      jd.gather_window(feats, w, 16))
    vids = np.array(["a"] * 18 + ["b"] * 4 + ["c"] * 2)
    for kw in ({"seqlen": 4, "stride": 4}, {"seqlen": 4, "stride": 2},
               {"seqlen": 4, "stride": 2, "is_train": False},
               {"seqlen": 4, "stride": 2, "match_vibe": False}):
        assert datasets.split_into_chunks(vids, **kw) == jd.split_into_chunks(vids, **kw)
    data = [np.full((2,), i) for i in range(7)]
    for drop in (False, True):
        got = list(datasets.BatchIterator(data, 3, drop_last=drop))
        want = list(jd.BatchIterator(data, 3, drop_last=drop))
        assert len(got) == len(want) == len(datasets.BatchIterator(data, 3, drop_last=drop))
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)


def test_training_plots_write_the_jax_files(tmp_path):
    from poserisk_release_tpu_torch.train.plots import plot_joint_error, save_plot

    out = save_plot([3.0, 2.0, 1.5, 1.8], epoch=4, graph_dir=str(tmp_path))
    assert osp.basename(out) == "train_loss.pdf" and osp.getsize(out) > 0
    p1, p2 = plot_joint_error(np.linspace(40, 20, 60), np.linspace(5, 2, 60),
                              np.linspace(9, 4, 59), str(tmp_path))
    assert (osp.basename(p1), osp.basename(p2)) == ("mpjpe.jpg", "mpjve_&_mpjae.jpg")
    assert osp.isfile(p1) and osp.isfile(p2)


# -- the training step --------------------------------------------------------

def batch(n=8, seed=11):
    """tests/test_parallelism.py::test_train_step_tensor_parallel's batch."""
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 64, 64, 3).astype(np.float32),
            (rng.randn(n, 24, 3) * 0.1).astype(np.float32))


def port_cfg():
    return default_config().replace(MODEL={"input_shape": (64, 64)})


@pytest.fixture(scope="module")
def weights():
    return init_spin_params(torch.Generator().manual_seed(3), load_mean_params(""))


@pytest.fixture(scope="module")
def family():
    return SMPLFamily(port_cfg().SPIN.smpl_model_dir)


@pytest.fixture(scope="module")
def jax_step(weights):
    """JAX's TrainState (SGD at STEP_LR, remat off) on the port's weights,
    after one step on batch(): (loss, flattened variables)."""
    from poserisk_release_tpu.body.smpl import SMPLFamily as JaxSMPLFamily
    from poserisk_release_tpu.config import default_config as jax_default_config
    from poserisk_release_tpu.train.step import TrainState as JaxTrainState

    jcfg = jax_default_config().replace(MODEL={"input_shape": (64, 64)})
    state = JaxTrainState.create(jcfg, JaxSMPLFamily(jcfg.SPIN.smpl_model_dir),
                                 variables=spin_state_dict_to_flax(weights),
                                 optimizer_name="sgd", lr=STEP_LR, remat=False)
    state, loss = state.step(*batch())
    return loss, flatten_tree(jax.tree_util.tree_map(np.asarray, state.variables()))


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_matches_jax(weights, family, jax_step, remat):
    """One SGD step: the loss within 1e-4 relative and every updated
    parameter within 5e-4 of JAX's; the update of every JAX parameter (BN
    scale/bias and init_* included) within 1e-3 of JAX's update, each
    having moved; the BN running statistics unchanged."""
    state = TrainState.create(port_cfg(), family, variables=weights, optimizer_name="sgd",
                              lr=STEP_LR, remat=remat, device="cpu")
    assert not state.model.training
    state, loss = state.step(*batch())
    want_loss, want = jax_step
    np.testing.assert_allclose(loss, want_loss, rtol=1e-4)
    got = flatten_tree(state.variables())
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=5e-4, err_msg=key)
    assert_update_matches(flatten_tree(spin_state_dict_to_flax(weights)), got, want,
                          [k for k in want if k.startswith("params/")])
    after = state.state_dict()
    for key, before in weights.items():
        if key.endswith(FROZEN):
            assert torch.equal(after[key], before), key


def test_remat_gives_the_same_step(weights, family):
    """Whole-backbone remat (one checkpoint segment) recomputes the same
    forward: the same loss and parameters as without it, bit for bit on the
    CPU."""
    out = []
    for remat in (False, True):
        state = TrainState.create(port_cfg(), family, variables=weights, optimizer_name="adam",
                                  lr=1e-4, remat=remat, device="cpu")
        for _ in range(2):
            state, loss = state.step(*batch(4))
        out.append((loss, state.state_dict()))
    assert out[0][0] == out[1][0]
    for key in out[0][1]:
        assert torch.equal(out[0][1][key], out[1][1][key]), key


def test_bf16_compute_dtype_tracks_the_f32_step(weights, family):
    """make_train_step(compute_dtype=bfloat16) runs the backbone under
    autocast (the JAX HMR's dtype argument): its loss is within bf16's
    1e-2 of the f32 step's, and its SGD update points the same way."""
    from poserisk_release_tpu_torch.train.step import make_train_step, trainable_tensors

    parents = np.asarray(family["neutral"].kintree_parents).copy()
    parents[0] = 0
    crops, targets = (torch.as_tensor(x) for x in batch(4))
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        state = TrainState.create(port_cfg(), family, variables=weights, optimizer_name="sgd",
                                  lr=1e-3, remat=False, device="cpu")
        step = make_train_step(3, tuple(int(p) for p in parents), state.optimizer,
                               remat=False, compute_dtype=dtype)
        loss = step(state.model, state.smpl_params, crops, targets)
        out[dtype] = (float(loss), trainable_tensors(state.model)["fc1.weight"].detach()
                      - weights["fc1.weight"])
    (l32, d32), (l16, d16) = out[torch.float32], out[torch.bfloat16]
    np.testing.assert_allclose(l16, l32, rtol=1e-2)
    assert float(torch.nn.functional.cosine_similarity(d16.flatten(), d32.flatten(), dim=0)) > 0.9


def test_step_rejects_another_ief_count(weights, family):
    """make_train_step's n_iter (JAX's signature) must be the model's own:
    the head runs the model's iterations, so a mismatch raises."""
    from poserisk_release_tpu_torch.train.step import make_train_step

    state = TrainState.create(port_cfg(), family, variables=weights, optimizer_name="sgd",
                              lr=1e-3, remat=False, device="cpu")
    step = make_train_step(state.model.n_iter - 1, tuple(range(24)), state.optimizer)
    crops, targets = (torch.as_tensor(x) for x in batch(2))
    with pytest.raises(ValueError, match="IEF iterations"):
        step(state.model, state.smpl_params, crops, targets)


def test_zero_joint_valid_gives_zero_loss_and_loss_decreases(weights, family):
    """Masked joints contribute zero but keep the mean's denominator (an
    all-zero mask gives 0.0); four adam steps on one batch lower the loss
    and leave the parameters finite."""
    crops, targets = batch(4, seed=12)
    state = TrainState.create(port_cfg(), family, variables=weights, optimizer_name="adam",
                              lr=1e-3, device="cpu")
    _, zero = state.step(crops, targets, joint_valid=np.zeros((4, 24, 1), np.float32))
    assert zero == 0.0
    seen = [state.step(crops, targets)[1] for _ in range(4)]
    assert all(np.isfinite(seen)) and seen[-1] < seen[0]
    assert all(torch.isfinite(v).all() for v in state.state_dict().values())


def test_variables_feed_the_jax_estimator(weights, family, tmp_path):
    """TrainState.variables() is the JAX tree layout: a checkpoint of it
    loads back into the port's PoseEstimator, and JAX's PoseEstimator takes
    it unchanged and computes the same poses as the port's."""
    from poserisk_release_tpu.body.smpl import SMPLFamily as JaxSMPLFamily
    from poserisk_release_tpu.config import default_config as jax_default_config
    from poserisk_release_tpu.pipeline import PoseEstimator as JaxPoseEstimator
    from poserisk_release_tpu_torch.models.convert import flax_to_state_dict
    from poserisk_release_tpu_torch.pipeline import PoseEstimator

    state = TrainState.create(port_cfg(), family, variables=weights, optimizer_name="sgd",
                              lr=1e-2, remat=False, device="cpu")
    state, _ = state.step(*batch(4))
    path = optim.save_checkpoint(state.variables(), epoch=1, checkpoint_dir=str(tmp_path))
    restored = flax_to_state_dict(optim.load_checkpoint(path))
    est = PoseEstimator(port_cfg(), family, variables=restored, device="cpu")
    crops = batch(4, seed=13)[0]
    with torch.no_grad():
        trained = state.model(torch.as_tensor(crops))
        loaded = est.model(torch.as_tensor(crops))
    for a, b in zip(trained, loaded):
        assert torch.equal(a, b)

    jcfg = jax_default_config().replace(MODEL={"input_shape": (64, 64)},
                                        PARALLEL={"frames_per_step": 4})
    jest = JaxPoseEstimator(jcfg, JaxSMPLFamily(jcfg.SPIN.smpl_model_dir),
                            variables=state.variables())
    want = [np.asarray(x) for x in jest.run(crops)]
    got = est.run(crops)
    np.testing.assert_allclose(got[0], want[0], atol=1e-2)  # deg: tests/test_torch_pose.py
    np.testing.assert_allclose(got[1], want[1], atol=1e-2)  # mm


def test_train_state_without_device_raises_when_cuda_absent(monkeypatch, family):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TrainState.create(port_cfg(), family)
