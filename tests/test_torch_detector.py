"""The port's YOLOv3 detector against the JAX package's, on the CPU.

Weights: the seed-0 random init of both packages (the same numpy draws)
and, for the comparisons of decoded boxes, the same init with each BN
layer's running statistics set to the batch statistics of its conv output
on a calibration batch. The plain init has BN at identity, so activations
grow through the 75 convs and the head logits reach the thousands: the
decoded sigmoids saturate and exp(w, h) turns float rounding of a large
logit into a visible box change. The calibrated copy keeps every layer at
unit scale, as trained weights are, so decoded values are well conditioned.

Tolerances. Both towers run in f32 and differ only in summation order
(XLA's convolution against PyTorch's on the CPU), which over 75 convs
accumulates to about 1e-5 of each head's largest logit (measured 1.0e-5 on
the calibrated weights): raw head logits are held to 5e-5 of that scale.
Decoded, a logit error e moves a sigmoid by at most e/4 and scales exp(w, h)
by 1 + e: on the calibrated weights (logits up to ~30) centres are held to
1e-2 canvas px, widths and heights to 1e-3 relative, scores to 1e-4. The
detector's kept boxes, after the unmap, clip and NMS, are held to 1e-2 px
plus 1e-3 relative, on frames whose scores lie at least 1e-3 from the
threshold (checked), so the same boxes are kept. The bridge, the darknet
loader, the BN fold, top-k and NMS are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poserisk_release_tpu.models import detector as jd
from poserisk_release_tpu_torch.models import detector as td
from poserisk_release_tpu_torch.models.convert import (
    state_dict_to_yolo_params,
    yolo_params_to_state_dict,
)
from poserisk_release_tpu_torch.ops.crop import letterbox_device, letterbox_device_rect
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_same_dict(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


@pytest.fixture(scope="module")
def jax_init():
    return jd.init_yolo_params(0)


@pytest.fixture(scope="module")
def port_init():
    return td.init_yolo_params(0)


def _frames(n, hw, seed):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]].astype(np.float64)
    out = []
    for _ in range(n):
        fx, fy, ph = rng.uniform(8, 30), rng.uniform(8, 30), rng.uniform(0, 6, 3)
        img = np.stack([128 + 100 * np.sin(xx / fx + ph[c]) * np.cos(yy / fy - ph[c])
                        for c in range(3)], axis=-1)
        out.append(np.round(img).astype(np.uint8))
    return np.stack(out)


@pytest.fixture(scope="module")
def calibrated(port_init):
    """port_init with every BN's running statistics set, layer by layer, to
    its conv output's batch statistics on letterboxed calibration frames."""
    model = td.YoloV3.from_state_dict(port_init)
    x = letterbox_device(torch.as_tensor(_frames(4, (90, 160), 0)), 64).permute(0, 3, 1, 2)
    saved = {}
    with torch.no_grad():
        for i, entry in enumerate(td.YOLOV3_SPEC):
            kind = entry[0]
            if kind == "conv":
                block = model.blocks[f"conv_{i}"]
                if block.bn is not None:
                    y = block.conv(x)
                    block.bn.running_mean.copy_(y.mean(dim=(0, 2, 3)))
                    block.bn.running_var.copy_(y.var(dim=(0, 2, 3), unbiased=False))
                x = block(x)
            elif kind == "shortcut":
                x = x + saved[i + entry[1]]
            elif kind == "route":
                parts = [saved[r if r >= 0 else i + r] for r in entry[1]]
                x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
            elif kind == "upsample":
                x = torch.nn.functional.interpolate(x, scale_factor=2, mode="nearest")
            saved[i] = x
    return {k: v.numpy().copy() for k, v in model.blocks.state_dict().items()
            if not k.endswith("num_batches_tracked")}


@pytest.fixture(scope="module")
def calibrated_folded(calibrated):
    """(JAX params, port state_dict), both BN-folded, of the calibrated weights."""
    return (jd.fold_bn_params(state_dict_to_yolo_params(calibrated)),
            td.fold_bn_params(calibrated))


def test_spec_and_constants_match_jax():
    assert td.YOLOV3_SPEC == jd.YOLOV3_SPEC
    assert len(td.conv_indices()) == 75
    assert (td.ANCHORS, td.NUM_CLASSES, td.PERSON_CLASS, td.BN_EPS, td.LEAKY_SLOPE) == (
        jd.ANCHORS, jd.NUM_CLASSES, jd.PERSON_CLASS, jd.BN_EPS, jd.LEAKY_SLOPE)


def test_init_draws_and_bridge_match_jax(jax_init, port_init):
    _assert_same_dict(yolo_params_to_state_dict(jax_init), port_init)
    _assert_same_dict(td.fold_bn_params(port_init),
                      yolo_params_to_state_dict(_np_tree(jd.fold_bn_params(jax_init))))


@pytest.mark.parametrize("folded", [False, True])
def test_bridge_round_trips(jax_init, folded):
    params = _np_tree(jd.fold_bn_params(jax_init)) if folded else jax_init
    sd = yolo_params_to_state_dict(params)
    back = state_dict_to_yolo_params(sd)
    assert sorted(back) == sorted(params)
    for name in params:
        _assert_same_dict(back[name], params[name])
    _assert_same_dict(yolo_params_to_state_dict(back), sd)


def test_bn_fold_matches_jax(jax_init, calibrated):
    # Exact: the same f32 elementwise arithmetic on both sides.
    want = yolo_params_to_state_dict(_np_tree(jd.fold_bn_params(
        state_dict_to_yolo_params(calibrated))))
    _assert_same_dict(td.fold_bn_params(calibrated), want)


def test_darknet_weight_roundtrip(port_init, tmp_path):
    """A darknet binary written from the port's weights (the file holds
    OIHW, the port's layout) loads back unchanged in the port, and the JAX
    loader reads the same numbers."""
    chunks = [np.zeros(5, np.int32).tobytes()]
    for i in td.conv_indices():
        p = f"conv_{i}."
        names = ("bn.bias", "bn.weight", "bn.running_mean", "bn.running_var") \
            if td.YOLOV3_SPEC[i][4] else ("conv.bias",)
        chunks += [port_init[p + n].tobytes() for n in names]
        chunks.append(port_init[p + "conv.weight"].tobytes())
    path = tmp_path / "yolov3.weights"
    path.write_bytes(b"".join(chunks))
    _assert_same_dict(td.load_darknet_weights(str(path)), port_init)
    _assert_same_dict(yolo_params_to_state_dict(jd.load_darknet_weights(str(path))), port_init)


def _jax_heads(params, x):
    """The JAX package's graph walk (_yolo_graph), returning the raw heads."""
    outputs, heads = [], []
    for i, entry in enumerate(jd.YOLOV3_SPEC):
        kind = entry[0]
        if kind == "conv":
            x = jd._conv_block(x, params[f"conv_{i}"], entry, jnp.float32)
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
            heads.append(np.asarray(x))
        outputs.append(x)
    return heads


# (frame size, img_size) per canvas: at these sizes the rect canvas of a
# 40x160 frame is 32x96 (head grids 1x3, 2x6, 4x12), not square.
CANVAS = {False: ((90, 160), 64), True: ((40, 160), 96)}


def _letterboxed(rect):
    hw, size = CANVAS[rect]
    frames = torch.as_tensor(_frames(2, hw, 1))
    return (letterbox_device_rect if rect else letterbox_device)(frames, size)


@pytest.mark.parametrize("weights", ["init", "calibrated"])
@pytest.mark.parametrize("rect", [False, True])
def test_raw_heads_match_jax(jax_init, port_init, calibrated, weights, rect):
    sd = td.fold_bn_params(port_init if weights == "init" else calibrated)
    jp = state_dict_to_yolo_params(sd)
    x = _letterboxed(rect)
    want = _jax_heads(jp, jnp.asarray(x.numpy()))
    with torch.no_grad():
        got = td.YoloV3.from_state_dict(sd).heads(x.permute(0, 3, 1, 2))
    assert len(got) == len(want) == 3
    for (raw, _), w in zip(got, want):
        raw = raw.permute(0, 2, 3, 1).numpy()
        assert raw.shape == w.shape
        scale = float(np.abs(w).max())
        assert float(np.abs(raw - w).max()) <= 5e-5 * scale, (weights, rect, scale)


def test_decode_head_matches_jax_on_a_rect_grid():
    raw = np.random.RandomState(2).normal(0, 3, (2, 255, 3, 5)).astype(np.float32)
    want = np.asarray(jd._decode_head(jnp.asarray(raw.transpose(0, 2, 3, 1)), 1, 16))
    got = td._decode_head(torch.as_tensor(raw), 1, 16).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("rect", [False, True])
def test_yolo_forward_matches_jax(calibrated_folded, rect):
    jp, sd = calibrated_folded
    x = _letterboxed(rect)
    want = np.asarray(jd.yolo_forward(jp, jnp.asarray(x.numpy())))
    got = td.yolo_forward(td.YoloV3.from_state_dict(sd), x).numpy()
    # 3 anchors per cell: grids 1x3 + 2x6 + 4x12 (rect), 2x2 + 4x4 + 8x8.
    assert got.shape == want.shape == (2, 189 if rect else 252, 5)
    np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=0, atol=1e-2)
    np.testing.assert_allclose(got[..., 2:4], want[..., 2:4], rtol=1e-3, atol=0)
    np.testing.assert_allclose(got[..., 4], want[..., 4], rtol=0, atol=1e-4)


def test_topk_select_breaks_ties_by_lower_index():
    scores = np.array([[0.5, 0.9, 0.5, 0.9, 0.1, 0.9, 0.5, 0.0],
                       [0.2, 0.2, 0.2, 0.7, 0.7, 0.2, 0.2, 0.2]], np.float32)
    det = np.concatenate([np.random.RandomState(3).rand(2, 8, 4).astype(np.float32),
                          scores[..., None]], axis=-1)
    for k in (4, 6, 8, 20):
        want = np.asarray(jd._topk_select(jnp.asarray(det), k))
        got = td._topk_select(torch.as_tensor(det), k).numpy()
        np.testing.assert_array_equal(got, want)


def test_nms_matches_jax():
    rng = np.random.RandomState(4)
    xy = rng.uniform(0, 100, (60, 2))
    wh = rng.uniform(5, 40, (60, 2))
    boxes = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    scores = np.round(rng.rand(60), 1).astype(np.float32)  # many ties
    for thr in (0.3, 0.45, 0.7):
        np.testing.assert_array_equal(td.nms_xyxy(boxes, scores, thr),
                                      jd.nms_xyxy(boxes, scores, thr))


@pytest.mark.parametrize("rect, k", [(False, 256), (True, 256), (False, 0), (True, 4)])
def test_detector_boxes_match_jax(calibrated_folded, rect, k):
    jp, sd = calibrated_folded
    hw, size = CANVAS[rect]
    frames = _frames(3, hw, 5)
    kw = dict(img_size=size, detection_threshold=0.5, batch_size=2, rect=rect,
              max_device_dets=k)
    jax_det = jd.YoloDetector(params=jp, **kw)
    # The threshold must lie clear of every score, so float rounding
    # cannot change which boxes pass it.
    from poserisk_release_tpu.ops.crop import letterbox_device as jl, letterbox_device_rect as jr

    scores = np.asarray(jd.yolo_forward(jp, (jr if rect else jl)(jnp.asarray(frames), size)))[..., 4]
    assert np.abs(scores - 0.5).min() > 1e-3
    want = jax_det(frames)
    got = td.YoloDetector(params=sd, device="cpu", **kw)(frames)
    assert len(got) == len(want) == 3
    assert sum(len(w) for w in want) > 0
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=1e-3, atol=1e-2)
        np.testing.assert_allclose(g[:, 4], w[:, 4], rtol=0, atol=1e-4)


def test_stub_detector_matches_jax():
    frames = np.zeros((3, 40, 60, 3), np.uint8)
    scripted = [np.array([1, 2, 30, 40, 0.9]), np.zeros((0, 5)),
                np.array([[0, 0, 10, 10, 0.5], [5, 5, 20, 20, 0.7]])]
    for kwargs in ({}, {"scripted": scripted}):
        got, want = td.StubDetector(**kwargs)(frames), jd.StubDetector(**kwargs)(frames)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)


def test_int8_detector_is_a_later_slice(port_init):
    """The int8 detector is in the port now (tests/test_torch_detector_int8.py):
    an int8 detector starts float and awaits calibration."""
    det = td.YoloDetector(params=td.fold_bn_params(port_init), int8=True, device="cpu")
    assert det.int8 and det.needs_calibration and not det.model.quantized
