"""The port's int8 YOLOv3 detector (PTQ) against the JAX package's, on the CPU.

Weights: the seed-0 init of both packages, BN-folded (the same numpy draws),
and for decoded boxes the BN-calibrated copy of tests/test_torch_detector.py
(the plain init saturates its head logits). Calibration frames: seeded
uint8 53x80 frames, letterboxed onto the 96 canvas.

Tolerances, and why:
  * weight quantization (qkernel, w_scale, in_scale, the quantized set, the
    handoff edges) is the same host numpy arithmetic on the same inputs:
    exact;
  * calibration absmax: the float towers sum in another order (XLA's
    convolution against PyTorch's), 1e-5 relative;
  * one int8 conv: the integer sums are exact on both sides (float64 here,
    int32 in XLA); the epilogue is the same f32 operations, within 2 f32 ulp;
    a quantized activation may differ by 1 only where x * (1 / in_scale)
    lies within an ulp of a .5 boundary (XLA's f32 division on the CPU is
    not correctly rounded);
  * the whole int8 tower on JAX's quantized params: every int8 conv is
    exact and every bf16 elementwise op rounds the same, so the raw heads
    differ only through the three float bf16 head convs, whose f32 sums are
    rounded to bf16 once in each framework: 2**-7 of each head's scale
    (2 bf16 ulp) bounds it;
  * kept boxes after the decode: on the calibrated weights the head logits
    are O(10), so a 2**-7-relative logit error moves a centre by < 0.5 px,
    and scores by < 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poserisk_release_tpu.models import detector as jd
from poserisk_release_tpu.ops.crop import letterbox_device_rect as jax_letterbox_rect
from poserisk_release_tpu_torch.models import detector as td
from poserisk_release_tpu_torch.models.convert import (
    state_dict_to_yolo_params,
    yolo_params_to_state_dict,
)
from poserisk_release_tpu_torch.ops.crop import letterbox_device_rect
from poserisk_release_tpu_torch.ops.qconv import QConv2d, int_conv_plain, quantize
from tests.test_torch_detector import _frames as _smooth_frames
from tests.test_torch_detector import calibrated, port_init  # noqa: F401 (fixtures)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CANVAS = 96


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _calib_frames():
    return np.random.RandomState(3).randint(0, 200, (2, 53, 80, 3)).astype(np.uint8)


def _frames(rng, n=8, h=96, w=128, lo=0, hi=255):
    return rng.randint(lo, hi, (n, h, w, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def folded(port_init):  # noqa: F811
    """(JAX folded params, port folded state_dict) of the seed-0 init."""
    return _np_tree(jd.fold_bn_params(jd.init_yolo_params(0))), td.fold_bn_params(port_init)


@pytest.fixture(scope="module")
def jax_absmax(folded):
    letter = jax_letterbox_rect(jnp.asarray(_calib_frames()), CANVAS)
    return jd.calibrate_yolo_activations(folded[0], letter)


@pytest.fixture(scope="module")
def jax_q(folded, jax_absmax):
    return _np_tree(jd.quantize_yolo_params(folded[0], jax_absmax))


def _assert_same_sd(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_calibration_absmax_matches_jax(folded, jax_absmax):
    model = td.YoloV3.from_state_dict(folded[1])
    got = td.calibrate_yolo_activations(
        model, letterbox_device_rect(torch.as_tensor(_calib_frames()), CANVAS))
    assert set(got) == set(jax_absmax) == {f"conv_{i}" for i in td.conv_indices()}
    rel = max(abs(got[k] - jax_absmax[k]) / jax_absmax[k] for k in got)
    assert rel < 1e-5, rel


@pytest.mark.parametrize("kw, n_quantized", [({}, 72), ({"min_downsample": 8}, 62),
                                             ({"q8_handoff": True}, 72)])
def test_quantize_matches_jax_exactly(folded, jax_absmax, kw, n_quantized):
    want = yolo_params_to_state_dict(_np_tree(jd.quantize_yolo_params(folded[0], jax_absmax,
                                                                      **kw)))
    got = td.quantize_yolo_params(folded[1], jax_absmax, **kw)
    _assert_same_sd(got, want)
    assert sum(k.endswith(".qkernel") for k in got) == n_quantized
    assert td.is_quantized(got) and not td.is_quantized(folded[1])
    if kw.get("q8_handoff"):
        # Every handoff edge whose consumer is quantized (not a float head).
        assert {k.split(".")[0] for k in got if k.endswith("out_scale")} == {
            f"conv_{i}" for i in jd._q8_handoff_convs() if f"conv_{i + 1}.qkernel" in got}


def test_quantize_guards(folded, jax_absmax, port_init):  # noqa: F811
    with pytest.raises(ValueError, match="zero convs"):
        td.quantize_yolo_params(folded[1], jax_absmax, min_downsample=64)
    with pytest.raises(ValueError, match="BN-folded"):
        td.quantize_yolo_params(port_init, jax_absmax)


def test_spec_walks_match_jax():
    assert td.conv_input_downsample() == jd.conv_input_downsample()
    assert td._q8_handoff_convs() == jd._q8_handoff_convs()
    assert td.merge_absmax({}, {"a": 1.0}) == {"a": 1.0}
    assert td.merge_absmax({"a": 1.0, "b": 3.0}, {"a": 2.0, "b": 1.0}) == {"a": 2.0, "b": 3.0}


def test_int8_bridge_round_trips(jax_q):
    sd = yolo_params_to_state_dict(jax_q)
    assert sd["conv_0.qkernel"].dtype == np.int8
    back = state_dict_to_yolo_params(sd)
    assert sorted(back) == sorted(jax_q)
    for name in jax_q:
        _assert_same_sd(back[name], jax_q[name])


def _one_conv_layer(seed=0):
    rng = np.random.RandomState(seed)
    kernel = rng.randn(3, 3, 16, 32).astype(np.float32) * 0.1
    bias = rng.randn(32).astype(np.float32) * 0.01
    x = (rng.rand(2, 20, 20, 16).astype(np.float32) * 2 - 1)
    w_scale = (np.abs(kernel).max(axis=(0, 1, 2)) / 127.0).astype(np.float32)
    qlayer = {"qkernel": np.clip(np.round(kernel / w_scale), -127, 127).astype(np.int8),
              "w_scale": w_scale, "in_scale": np.float32(1.0 / 127.0), "q_bias_leaky": bias}
    return kernel, bias, x, qlayer


def test_one_int8_conv_block_matches_jax():
    _, _, x, qlayer = _one_conv_layer()
    entry = ("conv", 32, 3, 1, True)
    jl = {k: jnp.asarray(v) for k, v in qlayer.items()}
    want = np.asarray(jd._conv_block(jnp.asarray(x), jl, entry))  # f32 compute
    # The quantized activations: equal up to 1 where x * inv_s is a .5 tie
    # within an ulp.
    xq_j = np.asarray(jnp.clip(jnp.round(jnp.asarray(x) * (1.0 / jl["in_scale"])), -127, 127))
    x_t = torch.as_tensor(x).permute(0, 3, 1, 2)
    block = td.qconv_block(qlayer, 3)  # spec index 3: a 3x3 stride-1 leaky conv
    xq_t = quantize(x_t, block.inv_s).permute(0, 2, 3, 1).numpy().astype(np.float32)
    diff = np.abs(xq_t - xq_j)
    assert diff.max() <= 1
    scaled = np.abs(x * np.float32(127.0))
    assert np.all(np.abs(scaled[diff > 0] % 1.0 - 0.5) < 1e-4)
    # The integer sums, on the same quantized input: exact.
    xq = jnp.asarray(xq_j.astype(np.int8))
    acc_j = np.asarray(jax.lax.conv_general_dilated(
        xq, jl["qkernel"], (1, 1), ((1, 1), (1, 1)), dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    acc_t = int_conv_plain(torch.as_tensor(xq_j.astype(np.int8)).permute(0, 3, 1, 2),
                           block.qkernel, 1, 1).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(acc_t, acc_j.astype(np.float64))
    # The whole block: the epilogue within 2 f32 ulp where the inputs agree.
    got = block(x_t, torch.float32).permute(0, 2, 3, 1).numpy()
    if diff.max() == 0:
        np.testing.assert_array_max_ulp(got, want, maxulp=2)


def test_int8_single_layer_accuracy():
    """The JAX package's mechanism check on one conv: the int8 path
    reproduces the float conv within the quantization step bound."""
    kernel, bias, x, qlayer = _one_conv_layer()
    x_t = torch.as_tensor(x).permute(0, 3, 1, 2)
    want = torch.nn.functional.leaky_relu(torch.nn.functional.conv2d(
        x_t, torch.as_tensor(kernel).permute(3, 2, 0, 1), torch.as_tensor(bias), padding=1), 0.1)
    got = QConv2d(qlayer["qkernel"], qlayer["w_scale"], qlayer["in_scale"], bias, 1, 1,
                  "leaky")(x_t, torch.float32)
    assert float((got - want).abs().max()) < 0.05
    assert float((got - want).abs().mean()) < 0.01


@jax.jit
def _jax_int8_heads(params, x):
    heads, outputs = [], []
    for i, entry in enumerate(jd.YOLOV3_SPEC):
        kind = entry[0]
        if kind == "conv":
            x = jd._conv_block(x, params[f"conv_{i}"], entry, jnp.bfloat16)
        elif kind == "shortcut":
            x = x + outputs[i + entry[1]]
        elif kind == "route":
            parts = [outputs[r if r >= 0 else i + r] for r in entry[1]]
            x = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=-1)
        elif kind == "upsample":
            B, H, W, C = x.shape
            x = jnp.broadcast_to(x[:, :, None, :, None, :], (B, H, 2, W, 2, C)).reshape(
                B, H * 2, W * 2, C)
        elif kind == "yolo":
            heads.append(x.astype(jnp.float32))
        outputs.append(x)
    return heads


def test_int8_tower_heads_match_jax(jax_q):
    frames = _calib_frames()
    x = letterbox_device_rect(torch.as_tensor(frames), CANVAS)
    want = _jax_int8_heads({k: {n: jnp.asarray(v) for n, v in layer.items()}
                            for k, layer in jax_q.items()}, jnp.asarray(x.numpy()))
    model = td.YoloV3.from_state_dict(yolo_params_to_state_dict(jax_q))
    assert model.quantized and model.compute_dtype == torch.bfloat16
    with torch.no_grad():
        got = model.heads(x.permute(0, 3, 1, 2).to(model.compute_dtype))
    for (raw, _), w in zip(got, want):
        raw, w = raw.float().permute(0, 2, 3, 1).numpy(), np.asarray(w)
        assert raw.shape == w.shape
        scale = float(np.abs(w).max())
        assert float(np.abs(raw - w).max()) <= 2.0 ** -7 * scale, scale


def test_int8_detector_boxes_match_jax(calibrated):  # noqa: F811
    """The int8 detector on JAX's quantized params of the BN-calibrated
    weights: the same kept boxes within 0.5 px, scores within 1e-2."""
    jp = jd.fold_bn_params(state_dict_to_yolo_params(calibrated))
    frames = _smooth_frames(3, (40, 160), 5)
    jax_det = jd.YoloDetector(params=jp, img_size=CANVAS, batch_size=2, rect=True, int8=True)
    jax_det.calibrate(frames)
    q = yolo_params_to_state_dict(_np_tree(jax_det.params))
    scores = np.asarray(jd.yolo_forward(jax_det.params, jax_letterbox_rect(
        jnp.asarray(frames), CANVAS), CANVAS, compute_dtype=jnp.bfloat16))[..., 4]
    # A threshold clear of every score by 1e-2, so that score rounding
    # cannot change which boxes pass it, with some boxes above it.
    thr = next(t for t in np.arange(0.5, 0.95, 0.01)
               if np.abs(scores - t).min() > 1e-2 and (scores > t).any())
    jax_det.detection_threshold = float(thr)
    want = jax_det(frames)
    port = td.YoloDetector(params=q, img_size=CANVAS, detection_threshold=float(thr),
                           batch_size=2, rect=True, int8=True, device="cpu")
    assert not port.needs_calibration
    got = port(frames)
    assert len(got) == len(want) == 3 and sum(len(w) for w in want) > 0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0, atol=0.5)
        np.testing.assert_allclose(g[:, 4], w[:, 4], rtol=0, atol=1e-2)


def test_int8_ptq_end_to_end(folded):
    """The port alone: calibrate + quantize + forward runs, stays finite, and
    nearly every anchor decodes as the float tower does (the few flips are
    random-weight sigmoid saturation, not PTQ error)."""
    letter = letterbox_device_rect(torch.as_tensor(_calib_frames()), CANVAS)
    fmodel = td.YoloV3.from_state_dict(folded[1])
    scales = td.calibrate_yolo_activations(fmodel, letter)
    qmodel = td.YoloV3.from_state_dict(td.quantize_yolo_params(folded[1], scales))
    out_f = td.yolo_forward(fmodel, letter).numpy()
    out_q = td.yolo_forward(qmodel, letter).numpy()
    assert np.isfinite(out_q).all()
    assert np.quantile(np.abs(out_f[..., 4] - out_q[..., 4]), 0.99) < 0.05


@jax.jit
def _jax_conv_inputs(params, x):
    """Every conv's input in the JAX package's f32 walk, by conv name."""
    taps = {}
    jd._yolo_graph(params, x, jnp.float32, tap=taps.__setitem__)
    return taps


def test_bias_correct_yolo_matches_jax(calibrated):  # noqa: F811
    """On the BN-calibrated weights (unit-scale activations). Given the same
    float inputs (the JAX walk's), each conv's correction, a mean of
    y_f - y_q over every output position, agrees within 2e-4 of the layer's
    largest: the float halves differ by f32 summation order, and the int8
    halves are exact except where an input lies at a .5 tie within an ulp
    and flips (XLA's f32 reciprocal of in_scale is not correctly rounded);
    one flip in a 1x1 conv on the 6x6 grid moves a channel's mean by ~5e-5
    of the layer's largest. End to end each package walks its own float tower,
    whose inputs differ by ~1e-6 relative, and a handful of quantized
    inputs flip at .5 ties (one flip moves a 3x3 conv's corrections by
    ~3e-5): held to 3e-2 of each layer's largest correction (measured 1.5%)."""
    sd = td.fold_bn_params(calibrated)
    jp = _np_tree(jd.fold_bn_params(state_dict_to_yolo_params(calibrated)))
    letter = letterbox_device_rect(torch.as_tensor(_calib_frames()), CANVAS)
    jl = jnp.asarray(letter.numpy())
    jq = _np_tree(jd.quantize_yolo_params(jp, jd.calibrate_yolo_activations(jp, jl)))
    q = yolo_params_to_state_dict(jq)
    want = yolo_params_to_state_dict(_np_tree(jd.bias_correct_yolo(jp, jq, jl)))
    recorded = {n: torch.as_tensor(np.array(v)).permute(0, 3, 1, 2)
                for n, v in _jax_conv_inputs(jp, jl).items()}
    corr = td.yolo_bias_corrections(sd, q, recorded)
    got = td.bias_correct_yolo(sd, q, letter)
    assert sorted(got) == sorted(want) and len(corr) == 72
    for name, c in corr.items():
        k = f"{name}.q_bias_leaky"
        corr_w = want[k] - q[k]
        scale = float(np.abs(corr_w).max())
        np.testing.assert_allclose(c, corr_w, rtol=0, atol=2e-4 * scale, err_msg=name)
        np.testing.assert_allclose(got[k] - q[k], corr_w, rtol=0, atol=3e-2 * scale,
                                   err_msg=name)
    for k in want:
        if not k.endswith("q_bias_leaky"):
            np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# The YoloDetector int8 lifecycle (the JAX package's tests of it, on the port).
# ---------------------------------------------------------------------------
def _detector(folded_sd, **kw):
    args = dict(img_size=64, int8=True, batch_size=8, device="cpu")
    args.update(kw)
    return td.YoloDetector(params=dict(folded_sd), **args)


def _in_scales(det):
    return {k: float(v) for k, v in det.params.items() if k.endswith(".in_scale")}


def test_first_call_calibrates_then_runs_int8(folded):
    d = _detector(folded[1], img_size=96, detection_threshold=0.5, rect=True)
    assert d.needs_calibration
    frames = np.random.RandomState(5).randint(0, 255, (2, 30, 60, 3)).astype(np.uint8)
    out = d(frames)  # float walk + calibration over every chunk
    assert len(out) == 2 and all(r.shape[1] == 5 for r in out)
    assert not d.needs_calibration and d.model.quantized
    out2, out3 = d(frames), d(frames)
    for a, b in zip(out2, out3):
        np.testing.assert_array_equal(a, b)


def test_empty_first_call_stays_unquantized(folded):
    d = _detector(folded[1], img_size=96, detection_threshold=0.5, rect=True)
    assert d(np.zeros((0, 30, 60, 3), np.uint8)) == []
    assert d.needs_calibration and not d.model.quantized
    d(np.random.RandomState(5).randint(0, 255, (2, 30, 60, 3)).astype(np.uint8))
    assert not d.needs_calibration


def test_explicit_calibrate_is_source_determined_and_once(folded):
    rng = np.random.RandomState(6)
    bright, dark = _frames(rng, lo=100, hi=255), _frames(rng, lo=0, hi=12)
    a, b, c = _detector(folded[1]), _detector(folded[1]), _detector(folded[1])
    a.calibrate(bright)
    b.calibrate(bright.copy())
    c.calibrate(dark)
    assert _in_scales(a) == _in_scales(b) and _in_scales(a) != _in_scales(c)
    assert _in_scales(c)["conv_0.in_scale"] < _in_scales(a)["conv_0.in_scale"]
    params, model = a.params, a.model
    a.calibrate(dark)  # a no-op once quantized
    assert a.params is params and a.model is model
    a(_frames(rng, lo=0, hi=10))  # a dark video start does not move the scales
    assert _in_scales(a) == _in_scales(b)


def test_reset_calibration_rederives_scales(folded):
    rng = np.random.RandomState(7)
    d = _detector(folded[1])
    d.reset_calibration()  # nothing quantized yet: a no-op
    assert d.needs_calibration
    d.calibrate(_frames(rng, lo=100, hi=255))
    s1 = _in_scales(d)
    d.reset_calibration()
    assert d.needs_calibration and not d.model.quantized
    d.calibrate(_frames(rng, lo=0, hi=12))
    s2 = _in_scales(d)
    assert s1 != s2 and s2["conv_0.in_scale"] < s1["conv_0.in_scale"]


def test_int8_needs_folded_weights(port_init):  # noqa: F811
    d = _detector(port_init)
    with pytest.raises(ValueError, match="BN-folded"):
        d.calibrate(_frames(np.random.RandomState(8), n=2))
    with pytest.raises(ValueError, match="requires int8"):
        _detector(port_init, int8=False).calibrate(_frames(np.random.RandomState(8), n=2))
