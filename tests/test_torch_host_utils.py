"""The port's host modules against the JAX package's: io/images,
io/keypoints, ops/sampling, utils/profiling, the render extras and
tools/data_preprocessing.

Every input is drawn from a generator seeded in its test. Tolerances: the
bbox crops go through the port's crop (its plain version here; kernel K1 on
the card) and the JAX package's matmul resample, which agree within 1.25e-4
of full scale on pixel noise (ops/crop.py); the sampling matches
grid_sample within 1e-5; the keypoint, denormalisation and cv2 drawing
functions are the same numpy/cv2 code and match exactly.
"""

import os
import os.path as osp

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from poserisk_release_tpu_torch.body.smpl import SKELETON
from poserisk_release_tpu_torch.io import images, keypoints
from poserisk_release_tpu_torch.ops.sampling import count_parameters, sample_image_feature
from poserisk_release_tpu_torch.outputs import render
from poserisk_release_tpu_torch.utils import profiling
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CROP_VS_JAX = 1.25e-4  # ops/crop.py: the port's crop vs the JAX resample on noise


# -- io/images ----------------------------------------------------------------

@pytest.fixture()
def jpg(tmp_path):
    import cv2

    img = np.random.RandomState(21).randint(0, 256, (60, 80, 3)).astype(np.uint8)
    path = tmp_path / "img.jpg"
    cv2.imwrite(str(path), img, [cv2.IMWRITE_JPEG_QUALITY, 100])
    return str(path)


def test_image_readers_match_jax(jpg):
    from poserisk_release_tpu.io import images as jimages

    np.testing.assert_array_equal(images.get_image(jpg), jimages.get_image(jpg))
    np.testing.assert_array_equal(images.read_image(jpg, 96), jimages.read_image(jpg, 96))
    img = np.random.RandomState(22).randint(0, 256, (4, 5, 3)).astype(np.uint8)
    np.testing.assert_array_equal(images.convert_cvimg_to_tensor(img),
                                  jimages.convert_cvimg_to_tensor(img))
    with pytest.raises(FileNotFoundError):
        images.get_image(jpg + ".missing")


def test_single_image_crops_match_jax():
    from poserisk_release_tpu.io import images as jimages

    rng = np.random.RandomState(23)
    img = rng.randint(0, 256, (100, 120, 3)).astype(np.uint8)
    bbox = [60.0, 50.0, 40.0, 44.0]
    kp = np.array([[60.0, 50.0, 1.0], [70.0, 55.0, 0.5], [41.0, 77.0, 1.0]])
    got = images.get_single_image_crop(img, bbox, crop_size=64, device="cpu")
    want = jimages.get_single_image_crop(img, bbox, crop_size=64)
    assert got.shape == (64, 64, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=CROP_VS_JAX)

    crop, raw, kp_out = images.get_single_image_crop_demo(img, bbox, kp.copy(), device="cpu")
    jcrop, jraw, jkp = jimages.get_single_image_crop_demo(img, bbox, kp.copy())
    np.testing.assert_allclose(crop, jcrop, atol=CROP_VS_JAX)
    assert raw.dtype == np.uint8 and np.abs(raw.astype(int) - jraw.astype(int)).max() <= 1
    np.testing.assert_allclose(kp_out, jkp, atol=1e-9)
    np.testing.assert_allclose(kp_out[0, :2], [112.0, 112.0], atol=1e-6)


def test_image_crops_keep_the_axis_quirk_and_match_jax(jpg):
    from poserisk_release_tpu.io import images as jimages

    boxes = [[10, 20, 50, 60], [0, 0, 59, 79]] + [[5, 5, 40, 30]] * 8  # two 8-box chunks
    got = images.get_image_crops(jpg, boxes, device="cpu")
    want = jimages.get_image_crops(jpg, boxes)
    assert got.shape == (10, 224, 224, 3)
    np.testing.assert_allclose(got, want, atol=CROP_VS_JAX)
    assert images.get_image_crops(jpg, [], device="cpu").shape == (0, 224, 224, 3)


def test_denormalizers_match_jax():
    from poserisk_release_tpu.io import images as jimages

    rng = np.random.RandomState(24)
    chw = rng.randn(3, 8, 6).astype(np.float32)
    np.testing.assert_array_equal(images.imagenet_denormalize(chw),
                                  jimages.imagenet_denormalize(chw))
    vid = rng.randn(2, 3, 3, 4, 5).astype(np.float32)
    np.testing.assert_array_equal(images.video_denormalize(vid), jimages.video_denormalize(vid))


def test_image_crop_without_device_raises_when_cuda_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        images.get_single_image_crop(np.zeros((8, 8, 3), np.uint8), [4, 4, 4, 4])


# -- io/keypoints -------------------------------------------------------------

def _person(cx, cy, h):
    return np.array([[cx, cy - h / 2, 1.0], [cx - h / 8, cy, 1.0], [cx + h / 8, cy, 1.0],
                     [cx, cy + h / 2, 1.0], [cx, cy, 0.2]])


def test_keypoint_functions_match_jax():
    from poserisk_release_tpu.io import keypoints as jkp

    rng = np.random.RandomState(25)
    seq = [_person(10 * i, 5 * i, 150 + rng.rand() * 10) for i in range(24)]
    seq[3] = seq[4] = None
    seq[0] = None
    for fn, args in ((keypoints.get_all_bbox_params, (seq, 0.3)),
                     (keypoints.get_smooth_bbox_params, (seq, 0.3)),
                     (keypoints.bboxes_from_joints2d, (seq, 0.3))):
        got, want = fn(*args), getattr(jkp, fn.__name__)(*args)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    pts = rng.uniform(0, 200, (7, 2))
    np.testing.assert_array_equal(keypoints.get_bbox_from_kp2d(pts), jkp.get_bbox_from_kp2d(pts))
    batched = rng.uniform(0, 200, (3, 7, 2))
    np.testing.assert_array_equal(keypoints.get_bbox_from_kp2d(batched),
                                  jkp.get_bbox_from_kp2d(batched))
    for inv in (False, True):
        np.testing.assert_array_equal(keypoints.normalize_2d_kp(pts, 224, inv),
                                      jkp.normalize_2d_kp(pts, 224, inv))
    args = (pts, 77.0, 51.0, 60.0, 80.0, 224, 224, 1.2, 25.0)
    np.testing.assert_array_equal(keypoints.transform_keypoints(*args),
                                  jkp.transform_keypoints(*args))
    assert keypoints.transfrom_keypoints is keypoints.transform_keypoints
    assert keypoints.kp_to_bbox_param(None, 0.3) is None
    with pytest.raises(ValueError, match="no visible keypoints"):
        keypoints.bboxes_from_joints2d([None, None])


# -- ops/sampling -------------------------------------------------------------

def test_sample_image_feature_matches_jax_and_grid_sample():
    """Inside points and the one-pixel border band, where one bilinear tap
    is still inside (tests/test_sampling_misc.py pins it for JAX), and
    points far outside (zero padding)."""
    from poserisk_release_tpu.ops.sampling import sample_image_feature as jax_sample

    rng = np.random.RandomState(26)
    feat = rng.normal(size=(8, 14, 14)).astype(np.float32)
    xy = np.concatenate([
        rng.uniform(5, 219, size=(16, 2)),
        [[-10.0, 50.0], [50.0, -10.0], [-5.0, -5.0], [230.0, 50.0], [50.0, 230.0],
         [0.0, 0.0], [224.0, 224.0], [-17.0, 230.0], [-500.0, -500.0], [1e4, 1e4]],
    ]).astype(np.float32)
    got = sample_image_feature(torch.as_tensor(feat), torch.as_tensor(xy), 224.0, 224.0)
    want = np.asarray(jax_sample(jnp.asarray(feat), jnp.asarray(xy), 224.0, 224.0))
    assert got.shape == (26, 8)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(got.numpy()[-2:], 0.0, atol=1e-6)


def test_count_parameters_matches_jax():
    from poserisk_release_tpu.ops.sampling import count_parameters as jax_count

    tree = {"a": np.zeros((3, 4)), "b": {"c": np.zeros(7)}}
    assert count_parameters(tree) == jax_count(tree) == 19
    assert count_parameters({"a": torch.zeros(3, 4), "b": {"c": torch.zeros(7)}}) == 19
    assert count_parameters(torch.nn.Linear(4, 3)) == 15


# -- utils/profiling ----------------------------------------------------------

def test_stage_timer_and_device_sync_match_jax():
    from poserisk_release_tpu.utils import profiling as jprof

    timers = [profiling.StageTimer(), jprof.StageTimer()]
    for timer in timers:
        with timer.stage("decode"):
            pass
        timer.acc.update({"decode": 1.5, "pose": 0.5})
        timer.counts["pose"] = 2
    assert timers[0].report() == timers[1].report()
    rng = np.random.RandomState(27)
    a, b = rng.rand(4, 5).astype(np.float32), rng.rand(3).astype(np.float32)
    assert profiling.device_sync(torch.as_tensor(a), torch.as_tensor(b)) == pytest.approx(
        jprof.device_sync(jnp.asarray(a), jnp.asarray(b)), rel=1e-6)
    assert profiling.device_sync() == 0.0


def test_trace_writes_a_chrome_trace_and_raises_the_body_failure(tmp_path):
    with profiling.trace(str(tmp_path / "t")):
        torch.ones(4).sum()
    assert osp.getsize(tmp_path / "t" / "trace.json") > 0
    with pytest.raises(KeyError):
        with profiling.trace(str(tmp_path / "u")):
            raise KeyError("body")


def test_persistent_cache_is_the_kernel_build_dir(tmp_path, monkeypatch):
    from poserisk_release_tpu_torch import _build

    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    assert profiling.enable_persistent_cache() == _build.BUILD_DIR
    assert profiling.enable_persistent_cache(str(tmp_path)) == str(tmp_path)
    assert _build.library_path("crop").startswith(str(tmp_path) + os.sep)


# -- render extras ------------------------------------------------------------

def test_keypoint_overlays_match_jax(tmp_path):
    from poserisk_release_tpu.outputs import render as jrender

    rng = np.random.RandomState(28)
    img = rng.randint(0, 255, size=(100, 120, 3)).astype(np.uint8)
    kps = rng.uniform(10, 90, size=(10, 2))
    kps3 = np.vstack([rng.uniform(10, 90, size=(2, 24)), rng.rand(1, 24)])
    np.testing.assert_array_equal(render.vis_keypoints(img, kps), jrender.vis_keypoints(img, kps))
    np.testing.assert_array_equal(render.vis_keypoints_with_skeleton(img, kps3, SKELETON),
                                  jrender.vis_keypoints_with_skeleton(img, kps3, SKELETON))
    np.testing.assert_array_equal(
        render.vis_coco_skeleton(img, kps3, SKELETON, given_color=(1, 0.5, 0), alpha=0.7),
        jrender.vis_coco_skeleton(img, kps3, SKELETON, given_color=(1, 0.5, 0), alpha=0.7))
    assert render.COCO_PART_COLORS == jrender.COCO_PART_COLORS

    import cv2

    pred = rng.uniform(10, 90, size=(24, 2))
    paths = [mod.vis_2d_pose(pred, img, SKELETON, str(tmp_path / name), prefix="p")
             for mod, name in ((render, "port"), (jrender, "jax"))]
    for p in paths:
        assert osp.basename(p).startswith("p_") and p.endswith("_2d_joint.jpg")
    np.testing.assert_array_equal(cv2.imread(paths[0]), cv2.imread(paths[1]))


def test_joint_cam_video_matches_jax(tmp_path):
    import cv2

    from poserisk_release_tpu.outputs import render as jrender

    jc = np.random.RandomState(29).normal(scale=300, size=(3, 24, 3))
    outs = []
    for mod, name in ((render, "port"), (jrender, "jax")):
        (tmp_path / name).mkdir()
        outs.append(mod.render_joint_cam_video(jc, np.arange(3), SKELETON,
                                               str(tmp_path / name), fps=5.0))
    frames = []
    for out in outs:
        assert osp.basename(out) == "estimation_result.mp4"
        cap = cv2.VideoCapture(out)
        got = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            got.append(frame)
        cap.release()
        frames.append(np.stack(got))
    assert len(frames[0]) == 3
    np.testing.assert_array_equal(frames[0], frames[1])


# -- tools/data_preprocessing -------------------------------------------------

def _read_all(path):
    import cv2

    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(frame)
    cap.release()
    return np.stack(out)


def test_data_preprocessing_main_writes_what_jax_writes(tmp_path):
    """tests/test_multiperson_tools.py's clip (20 frames at 2 fps: one
    16-frame chunk of MIN_SEC = 8 s), each package with its own full-frame
    tracker. The same tracks, the same mp4 and jpg names; the uint8 images
    within one level of JAX's and the written files within a fraction of a
    level of JAX's on average.

    Why not bit-equal: both tools TRUNCATE crop * 255 to uint8 (the
    reference's mp4 rule). On the clip's flat regions the port's crop gives
    exactly 20/255 and the JAX matmul resample 19.999998/255, so about 3%
    of the values truncate one level apart; the lossy jpg and mp4 encoders
    then spread those single levels (jpg at most 3 levels, mp4 more, both
    around 0.05 on average). What the port writes is checked exactly: its
    jpgs and mp4 decode to what cv2 makes of its own uint8 images."""
    import cv2

    from poserisk_release_tpu.io.video import write_video
    from poserisk_release_tpu.models.detector import StubDetector as JaxStubDetector
    from poserisk_release_tpu.ops.crop import crop_batch as jax_crop_batch
    from poserisk_release_tpu.tools.data_preprocessing import main as jax_main
    from poserisk_release_tpu.tracking.mpt import MultiPersonTracker as JaxTracker
    from poserisk_release_tpu_torch.models.detector import StubDetector
    from poserisk_release_tpu_torch.ops.crop import crop_batch
    from poserisk_release_tpu_torch.tools import data_preprocessing as dp
    from poserisk_release_tpu_torch.tracking.mpt import MultiPersonTracker

    frames = []
    for i in range(20):
        img = np.full((120, 160, 3), 20, np.uint8)
        cv2.rectangle(img, (40 + i, 20), (90 + i, 110), (150, 150, 150), -1)
        frames.append(img)
    roots = {}
    for name in ("port", "jax"):
        src = tmp_path / name / "videos" / "train" / "siteA"
        src.mkdir(parents=True)
        write_video(frames, fps=2.0, file_path=str(src / "clipA.mp4"))
        roots[name] = tmp_path / name
    written = dp.main(str(roots["port"] / "videos" / "train"),
                      tracker=MultiPersonTracker(StubDetector()), device="cpu")
    jax_written = jax_main(str(roots["jax"] / "videos" / "train"),
                           tracker=JaxTracker(JaxStubDetector()))
    assert [osp.relpath(p, roots["port"]) for p in written] == [
        osp.relpath(p, roots["jax"]) for p in jax_written] == [
        osp.join("processed_videos", "train", "siteA", "clipA_0.mp4")]

    # The in-memory images, each package's crop of its own tracks.
    decoded = _read_all(str(roots["port"] / "videos" / "train" / "siteA" / "clipA.mp4"))
    rgb = decoded[..., ::-1].copy()
    tracks = MultiPersonTracker(StubDetector())(rgb)
    jax_tracks = JaxTracker(JaxStubDetector())(rgb)
    (chunk,) = list(dp.person_chunks(rgb, 2.0, tracks, device="cpu"))
    jt = next(iter(jax_tracks.values()))
    np.testing.assert_array_equal(chunk["frames"], jt["frames"][:16])
    np.testing.assert_array_equal(chunk["bbox"], jt["bbox"][:16].astype(np.float32))
    jcrops = np.asarray(jax_crop_batch(jnp.asarray(rgb[chunk["frames"]]),
                                       jnp.asarray(chunk["bbox"]), scale=dp.BBOX_SCALE))
    crops = crop_batch(torch.as_tensor(rgb[chunk["frames"]]), torch.as_tensor(chunk["bbox"]),
                       scale=dp.BBOX_SCALE).numpy()
    np.testing.assert_allclose(crops, jcrops, atol=CROP_VS_JAX)
    levels = chunk["images_bgr"].astype(int) - (jcrops[..., ::-1] * 255).astype(np.uint8)
    assert np.abs(levels).max() <= 1

    # The files: the port's are cv2's encoding of its own images; JAX's are
    # within a fraction of a level on average.
    mp4 = _read_all(written[0])
    writer_check = str(tmp_path / "check.mp4")
    write_video(list(chunk["images_bgr"]), fps=2.0, file_path=writer_check)
    np.testing.assert_array_equal(mp4, _read_all(writer_check))
    assert np.abs(mp4.astype(float) - _read_all(jax_written[0])).mean() < 0.25
    rel = osp.join("images", "train", "siteA", "clipA", "0")
    names = sorted(os.listdir(roots["port"] / rel))
    assert names == sorted(os.listdir(roots["jax"] / rel)) and len(names) == 16
    for i, n in enumerate(names):
        got, want = cv2.imread(str(roots["port"] / rel / n)), cv2.imread(str(roots["jax"] / rel / n))
        own = cv2.imdecode(cv2.imencode(".jpg", chunk["images_bgr"][i])[1], cv2.IMREAD_COLOR)
        np.testing.assert_array_equal(got, own, err_msg=n)
        assert np.abs(got.astype(float) - want).mean() < 0.25, n


def test_person_chunks_crop_like_the_plain_crop():
    """The in-memory half: tracks shorter than MIN_SEC are dropped, longer
    ones cut into MIN_SEC * fps chunks, and the uint8 BGR images are the
    port's plain crop of the tracked frames, * 255 truncated."""
    from poserisk_release_tpu_torch.ops.crop import crop_batch_plain
    from poserisk_release_tpu_torch.tools import data_preprocessing as dp

    rng = np.random.RandomState(30)
    frames = rng.randint(0, 256, (40, 48, 64, 3)).astype(np.uint8)
    tracks = {1: {"frames": np.arange(3, 40), "bbox": np.tile([[30.0, 24.0, 20.0, 30.0]], (37, 1))},
              2: {"frames": np.arange(0, 10), "bbox": np.tile([[10.0, 10.0, 8.0, 8.0]], (10, 1))}}
    chunks = list(dp.person_chunks(frames, 2.0, tracks, crop_size=32, device="cpu"))
    assert [c["frames"].tolist() for c in chunks] == [list(range(3, 19)), list(range(19, 35))]
    for c in chunks:
        want = crop_batch_plain(torch.as_tensor(frames[c["frames"]]), torch.as_tensor(c["bbox"]),
                                dp.BBOX_SCALE, 32).numpy()
        np.testing.assert_array_equal(c["images_bgr"],
                                      (want[..., ::-1] * 255).astype(np.uint8))
