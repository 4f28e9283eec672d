"""The strict-f32 HMR's folded NCHW chain (a BN-folded f32 backbone through
models/resnet_int8.resnet50_forward, one epilogue a conv) and its conv
epilogue (ops/epilogue, csrc/conv_epilogue.cu), and which backbone the pose
estimator runs.

On the CPU: the chain, which runs the epilogue's plain version there,
against the HMR module and against the JAX package's folded f32 ResNet-50
and HMR, on seeded weights with non-trivial BatchNorm statistics; the plain
epilogue's three forms; the estimator's choice of backbone, and the chain
driven through the estimator where the choice is forced on the CPU. The
`cuda` tests (skipped here) hold the kernel bit for bit to its plain version
at the 64-row chunk's shapes, the estimator's strict step on the card to the
module's, a profiled pose step to no BatchNorm or layout-transpose kernel
and 53 epilogue launches, and the server's bucket graphs to 53 recorded
epilogues each. On the card:

    python -m pytest tests/test_torch_epilogue.py -q -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from poserisk_release_tpu_torch import pipeline
from poserisk_release_tpu_torch.body.smpl import SMPLFamily
from poserisk_release_tpu_torch.config import default_config
from poserisk_release_tpu_torch.models import resnet_int8
from poserisk_release_tpu_torch.models.spin import (
    HMR,
    hmr_forward_quant,
    init_spin_params,
    load_mean_params,
)
from poserisk_release_tpu_torch.ops import epilogue
from poserisk_release_tpu_torch.ops.epilogue import conv_epilogue, conv_epilogue_plain
from poserisk_release_tpu_torch.pipeline import PoseEstimator, runs_folded_chain
from poserisk_release_tpu_torch.throughput import make_pose_core
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

# The chain against the module, in f32: folding BatchNorm into the weights
# rounds each conv's weight and bias once more and reorders the sums, so the
# two differ by f32 rounding through 53 convs. Measured on the CPU (seeds
# 0-2, 64x64 crops): features within 1.1e-6 of their largest value, rotmat
# within 1.1e-5. The limits keep about 10x and 5x room; the rotmat limit is
# test_torch_spin's 5e-5 on the same outputs, and 5e-5 rad moves an Euler
# angle by 0.003 deg.
FEATURE_RTOL = 1e-5
ROTMAT_ATOL = 5e-5
N_CONVS = 53  # the stem, 16 bottlenecks x 3, 4 downsamples


def seeded_hmr_state(seed):
    """The port's seeded HMR init with non-trivial BatchNorm statistics:
    scales in [0.75, 1.25], shifts and means in +-0.2 and +-0.5, and
    variances in [0.75, 1.25] plus the benchmark's floor of 0.1 x their
    layer's mean."""
    g = torch.Generator().manual_seed(seed)
    state = init_spin_params(g, load_mean_params(""))
    for key in [k for k in state if k.endswith("running_var")]:
        bn, c = key[:-len("running_var")], state[key].numel()
        state[bn + "weight"] = 0.75 + 0.5 * torch.rand(c, generator=g)
        state[bn + "bias"] = 0.2 * (2 * torch.rand(c, generator=g) - 1)
        state[bn + "running_mean"] = 0.5 * (2 * torch.rand(c, generator=g) - 1)
        var = 0.75 + 0.5 * torch.rand(c, generator=g)
        state[key] = var + 0.1 * var.mean()
    return state


def _module(state):
    model = HMR()
    model.load_state_dict(state)
    return model.eval()


def _folded(state, device="cpu"):
    """The strict card's backbone, as the estimator builds it."""
    return resnet_int8.prepare_resnet50(resnet_int8.fold_resnet50_params(state), device)


def _count_epilogues(monkeypatch):
    """Counts conv_epilogue calls: [n], bumped on every call."""
    calls, real = [0], epilogue.conv_epilogue

    def counted(*args, **kw):
        calls[0] += 1
        return real(*args, **kw)

    monkeypatch.setattr(epilogue, "conv_epilogue", counted)
    return calls


@pytest.mark.parametrize("seed", [0, 1])
def test_folded_chain_matches_the_hmr_module(seed, monkeypatch):
    model = _module(seeded_hmr_state(seed))
    folded = _folded(model.state_dict())
    crops = torch.as_tensor(np.random.RandomState(seed).rand(2, 64, 64, 3).astype(np.float32))
    calls = _count_epilogues(monkeypatch)
    with torch.no_grad():
        want_f = model.features(crops.permute(0, 3, 1, 2))
        got_f = resnet_int8.resnet50_forward(folded, crops, torch.float32)
        assert calls[0] == N_CONVS  # one epilogue a conv, the walk adds and ReLUs nothing
        want, got = model(crops), hmr_forward_quant(folded, model, crops, torch.float32)
    assert got_f.shape == (2, 2048) and got_f.dtype == torch.float32
    scale = float(want_f.abs().max())
    assert float((got_f - want_f).abs().max()) <= FEATURE_RTOL * scale
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), atol=ROTMAT_ATOL)
    for g, w in zip(got[1:], want[1:]):  # betas, camera: the same head on those features
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ROTMAT_ATOL * 10)
    # OIHW-contiguous f32 weights, one float conv a layer.
    convs = {k: v for k, v in folded.items() if k != "__prepared__"}
    assert len(convs) == N_CONVS
    assert all(isinstance(c, resnet_int8._FloatConv) for c in convs.values())
    w = convs["layer4_2.conv3"].weight
    assert w.shape == (2048, 512, 1, 1) and w.is_contiguous() and w.dtype == torch.float32


# The port's chain against the JAX package's folded f32 ResNet-50 and its
# HMR, on the same weights and crops at 224x224 (the JAX int8 tests' size).
# Measured on the CPU (seeds 0-2): features within 3.2e-7 of their largest
# value, rotmat within 1.1e-5; the limits are test_torch_spin's 5e-5 on
# rotmat (the port's module against JAX) and 1e-5 on the features.
JAX_FEATURE_RTOL = 1e-5


@pytest.mark.parametrize("seed", [0, 1])
def test_folded_chain_matches_jax(seed):
    import jax
    import jax.numpy as jnp

    from poserisk_release_tpu.models import resnet_int8 as jax_resnet_int8
    from poserisk_release_tpu.models.spin import HMR as JaxHMR
    from poserisk_release_tpu_torch.models.convert import spin_state_dict_to_flax

    state = seeded_hmr_state(seed)
    variables = jax.tree_util.tree_map(np.asarray, spin_state_dict_to_flax(state))
    crops = np.random.RandomState(20 + seed).rand(2, 224, 224, 3).astype(np.float32)
    want_f = np.asarray(jax_resnet_int8.resnet50_forward(
        jax_resnet_int8.fold_resnet50_params(variables), jnp.asarray(crops), jnp.float32))
    want_rot = np.asarray(JaxHMR(n_iter=3).apply(variables, jnp.asarray(crops))[0])
    model, x = _module(state), torch.as_tensor(crops)
    with torch.no_grad():
        got_f = resnet_int8.resnet50_forward(_folded(state), x, torch.float32).numpy()
        got_rot = hmr_forward_quant(_folded(state), model, x, torch.float32)[0].numpy()
    assert float(np.abs(got_f - want_f).max()) <= JAX_FEATURE_RTOL * float(np.abs(want_f).max())
    np.testing.assert_allclose(got_rot, want_rot, rtol=0, atol=ROTMAT_ATOL)


@pytest.mark.parametrize("form", ["bias", "bias_relu", "bias_residual_relu"])
def test_plain_epilogue_forms(form):
    """Each form's f32 operations in order, out of place, equal the in-place
    pass bit for bit, at a 7x7 map (49 values a plane) and a 4x4 one."""
    rng = np.random.RandomState(3)
    for shape in [(2, 8, 7, 7), (3, 16, 4, 4)]:
        y = torch.as_tensor(rng.randn(*shape).astype(np.float32))
        b = torch.as_tensor(rng.randn(shape[1]).astype(np.float32))
        r = torch.as_tensor(rng.randn(*shape).astype(np.float32)) if "residual" in form else None
        want = y + b[None, :, None, None]
        if r is not None:
            want = want + r
        if form != "bias":
            want = torch.clamp_min(want, 0.0)
        got = conv_epilogue(y, b, r, relu=form != "bias")
        assert got.data_ptr() == y.data_ptr()  # in place
        assert torch.equal(got, want)


def test_plain_epilogue_keeps_nan_and_raises_off_cpu_and_cuda():
    y = torch.tensor([[[[float("nan"), -1.0, 2.0, -0.5]]]])
    conv_epilogue_plain(y, torch.zeros(1), relu=True)
    assert torch.isnan(y[0, 0, 0, 0]) and y[0, 0, 0, 1:].tolist() == [0.0, 2.0, 0.0]
    with pytest.raises(ValueError, match="no path"):
        conv_epilogue(torch.zeros((1, 1, 1, 1), device="meta"), torch.zeros(1, device="meta"))


@pytest.mark.parametrize("device,dtype,want", [
    ("cuda", torch.float32, True),    # strict f32 on the card: the folded NCHW chain
    ("cuda", torch.bfloat16, False),  # fast: the channels-last module (NHWC-native bf16)
    ("cpu", torch.float32, False),    # the CPU: the module (byte-equal pose_log checks)
])
def test_runs_folded_chain_reads_device_and_dtype(device, dtype, want):
    assert runs_folded_chain(torch.device(device), dtype) is want


def _estimator(state, **kw):
    cfg = default_config().replace(PARALLEL={"frames_per_step": 4},
                                   MODEL={"input_shape": (64, 64)})
    return PoseEstimator(cfg, SMPLFamily(cfg.SPIN.smpl_model_dir), variables=state,
                         device="cpu", **kw)


def _crops(n=4, seed=5):
    return np.random.RandomState(seed).rand(n, 64, 64, 3).astype(np.float32)


def _is_folded_f32(backbone) -> bool:
    convs = [v for k, v in backbone.items() if k != "__prepared__"]
    return len(convs) == N_CONVS and all(isinstance(c, resnet_int8._FloatConv) for c in convs)


@pytest.mark.parametrize("path", ["strict", "fast", "spin_int8"])
def test_estimator_backbone_on_the_cpu(path):
    """CPU f32 runs the module, fast the channels-last bf16 module, and
    spin_int8 its quantized backbone once calibrated: none folds."""
    est = _estimator(seeded_hmr_state(0), fast=path == "fast", spin_int8=path == "spin_int8")
    assert not est._folds
    est.run(_crops())
    if path == "spin_int8":
        assert est._quant_backbone is not None and est.quant_params is not None
        assert any("qkernel" in layer for layer in est.quant_params.values())
        return
    assert est._quant_backbone is None
    want = torch.bfloat16 if path == "fast" else torch.float32
    assert est.model.conv1.weight.dtype == want
    assert est.model.conv1.weight.is_contiguous(memory_format=torch.channels_last)


def test_estimator_runs_the_folded_chain_where_chosen(monkeypatch):
    """With the choice forced on the CPU, the estimator folds at its first
    pose step, and its own steps and its whole-row step (the server's) run
    the folded chain and agree with the module's; param_bytes still counts
    the module alone, a loaded quantized backbone still wins, and
    spin_int8 does not fold."""
    state = seeded_hmr_state(1)
    module_est = _estimator(state)
    monkeypatch.setattr(pipeline, "runs_folded_chain", lambda device, dtype: True)
    est = _estimator(state)
    assert est._folds and est._quant_backbone is None  # nothing folded before a pose step
    crops = _crops()
    want = module_est.run(crops)
    got = est.run(crops)
    assert _is_folded_f32(est._quant_backbone) and est.quant_params is None
    assert est.param_bytes == module_est.param_bytes
    assert not est.spin_needs_calibration
    for name, g, w, atol in zip(("euler", "joints", "aa"), got, want, (0.01, 0.05, 2e-4)):
        np.testing.assert_allclose(g, w, atol=atol, err_msg=name)
    # The chain, not the module, ran: the same core on the module alone
    # differs from it by the fold's rounding.
    t = torch.as_tensor(crops)
    with torch.no_grad():
        folded_rot = make_pose_core(est.parents, quant_backbone=_folded(state))(
            est.model, est.smpl_params, t)[2]
        module_rot = make_pose_core(est.parents)(est.model, est.smpl_params, t)[2]
    assert np.array_equal(got[2], folded_rot.numpy()) and not np.array_equal(got[2],
                                                                                module_rot.numpy())
    frames = (np.random.RandomState(2).rand(4, 80, 96, 3) * 255).astype(np.uint8)
    boxes = np.tile(np.float32([[48.0, 40.0, 50.0, 60.0]]), (4, 1))
    calls = _count_epilogues(monkeypatch)
    with torch.no_grad():
        row = est.whole_row_step()(torch.as_tensor(frames), torch.as_tensor(boxes))
        assert calls[0] == N_CONVS
        ref = make_pose_core(est.parents, quant_backbone=est._quant_backbone)(
            est.model, est.smpl_params, est._crop(torch.as_tensor(frames),
                                                  torch.as_tensor(boxes)))
    for g, w in zip(row, ref):
        assert torch.equal(g, w)

    qparams = resnet_int8.fold_resnet50_params(state)
    est.load_quant_backbone(qparams)
    assert est.quant_params is qparams and est._quant_backbone is not None
    calibrating = _estimator(state, spin_int8=True)
    assert not calibrating._folds
    calibrating.run(crops)
    assert any("qkernel" in layer for layer in calibrating.quant_params.values())


def test_training_state_folds_nothing(monkeypatch):
    """train/step.TrainState borrows an estimator's module: even where the
    fold is chosen, it folds no backbone it would never run."""
    from poserisk_release_tpu_torch.train.step import TrainState

    monkeypatch.setattr(pipeline, "runs_folded_chain", lambda device, dtype: True)

    def no_fold(state):
        raise AssertionError("folded a backbone for training")

    monkeypatch.setattr(resnet_int8, "fold_resnet50_params", no_fold)
    cfg = default_config().replace(MODEL={"input_shape": (64, 64)})
    state = TrainState.create(cfg, SMPLFamily(cfg.SPIN.smpl_model_dir),
                              variables=seeded_hmr_state(0), device="cpu")
    crops = _crops(2)
    _, loss = state.step(crops, np.zeros((2, 24, 3), np.float32))
    assert np.isfinite(loss)


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the conv epilogue kernel runs only there")
    return torch.device("cuda")


# The conv outputs of a 64-crop chunk at 224x224, one a stage (and the 7x7
# maps, whose 49-value planes put vectors across two channels), then a
# 3-value plane and an unaligned view, which take the scalar kernel.
CARD_SHAPES = [(64, 64, 112, 112), (64, 256, 56, 56), (64, 128, 28, 28), (64, 1024, 14, 14),
               (64, 2048, 7, 7), (64, 512, 7, 7), (5, 6, 3, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["bias", "bias_relu", "bias_residual_relu"])
def test_kernel_bit_equal_to_plain(cuda_device, form):
    from poserisk_release_tpu_torch.ops.epilogue import conv_epilogue_cuda

    g = torch.Generator(device=cuda_device).manual_seed(0)
    for shape in CARD_SHAPES + ["unaligned"]:
        if shape == "unaligned":
            y = torch.randn(2 * 32 * 5 * 5 + 1, device=cuda_device, generator=g)[1:]
            y = y.view(2, 32, 5, 5)
        else:
            y = torch.randn(shape, device=cuda_device, generator=g)
        b = torch.randn(y.shape[1], device=cuda_device, generator=g)
        r = torch.randn(y.shape, device=cuda_device, generator=g) if "residual" in form else None
        want = conv_epilogue_plain(y.clone(), b, r, relu=form != "bias")
        n0 = conv_epilogue_cuda.launches
        got = conv_epilogue_cuda(y, b, r, relu=form != "bias")
        torch.cuda.synchronize()
        assert conv_epilogue_cuda.launches == n0 + 1 and got.data_ptr() == y.data_ptr()
        assert torch.equal(got, want), (form, shape)


def _card_estimator(device, state):
    cfg = default_config().replace(PARALLEL={"frames_per_step": 64})
    return PoseEstimator(cfg, SMPLFamily(cfg.SPIN.smpl_model_dir), variables=state,
                         device=device)


@pytest.mark.cuda
def test_strict_step_on_the_card_matches_the_module(cuda_device):
    est = _card_estimator(cuda_device, seeded_hmr_state(0))
    assert est._folds
    g = torch.Generator(device=cuda_device).manual_seed(9)
    crops = torch.rand((64, 224, 224, 3), device=cuda_device, generator=g)
    with torch.inference_mode():
        got = est._pose_step(crops)
        assert _is_folded_f32(est._quant_backbone)
        want = make_pose_core(est.parents)(est.model, est.smpl_params, crops)
        rot_got = hmr_forward_quant(est._quant_backbone, est.model, crops, torch.float32)[0]
        rot_want = est.model(crops)[0]
    assert float((rot_got - rot_want).abs().max()) <= ROTMAT_ATOL
    for name, g, w, atol in zip(("euler", "joints", "aa"), got, want, (0.01, 0.05, 2e-4)):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), atol=atol, err_msg=name)


@pytest.mark.cuda
def test_profiled_pose_step_has_no_batchnorm_or_transpose(cuda_device):
    from torch.profiler import ProfilerActivity, profile

    from poserisk_release_tpu_torch.ops.epilogue import conv_epilogue_cuda

    est = _card_estimator(cuda_device, seeded_hmr_state(0))
    frames = torch.randint(0, 256, (64, 450, 800, 3), dtype=torch.uint8, device=cuda_device)
    boxes = torch.tensor([[400.0, 225.0, 220.0, 300.0]], device=cuda_device).repeat(64, 1)
    with torch.inference_mode():
        est._pose_step_from_frames(frames, boxes)  # warm-up: build and load the kernels
        torch.cuda.synchronize()
        n0 = conv_epilogue_cuda.launches
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            est._pose_step_from_frames(frames, boxes)
            torch.cuda.synchronize()
    assert conv_epilogue_cuda.launches - n0 == N_CONVS
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    for banned in ("bn_fw_inf", "nhwcToNchw", "nchwToNhwc"):
        assert not [n for n in names if banned in n], banned
    # torch.profiler on this card may drop a kernel record now and then.
    assert N_CONVS - 1 <= sum("epilogue_" in n for n in names) <= N_CONVS


@pytest.mark.cuda
def test_server_bucket_graphs_record_the_epilogue(cuda_device):
    from poserisk_release_tpu_torch.ops.epilogue import conv_epilogue_cuda
    from poserisk_release_tpu_torch.serving import PoseScoringServer

    cfg = default_config().replace(MODEL={"input_shape": (64, 64)},
                                   PARALLEL={"frames_per_step": 4})
    captured = conv_epilogue_cuda.captured
    with PoseScoringServer(cfg=cfg, batch_sizes=(1, 4), frame_hw=(64, 96), warm=True,
                           max_delay_ms=0.0, spin_variables=seeded_hmr_state(0),
                           device=cuda_device) as srv:
        assert conv_epilogue_cuda.captured - captured == 2 * N_CONVS
        frames = torch.randint(0, 256, (4, 64, 96, 3), dtype=torch.uint8).numpy()
        boxes = np.tile(np.float32([[48.0, 32.0, 40.0, 50.0]]), (4, 1))
        for b in (1, 4):
            assert srv._steps[b].epilogue_per_replay == N_CONVS
            launches = conv_epilogue_cuda.launches
            srv._run_bucket(frames[:b], boxes[:b])
            assert conv_epilogue_cuda.launches == launches + N_CONVS
