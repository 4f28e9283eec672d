"""Three host paths of the port held against the JAX package, with the
JAX tests' own inputs (CPU only: they need cv2, which a card's machine
may lack):

* the motion-adaptive detection stride (--adaptive_stride,
  tracking/mpt.adaptive_window_detections): tests/test_detection_stride.py's
  PixelDetector on its static scene and its sharp reversal. The frames
  probed, the track ids and the boxes (float64 numpy on both sides) must be
  exactly equal, and so must the validation errors;
* the parallel decode (DATASET.decode_workers, io/video.iter_windows_parallel
  and read_video_parallel): tests/test_parallel_decode.py's clips. The
  decoded frames must be equal byte for byte, and the fallbacks (frameless
  source, guard mismatch, a seek that lands late, a capture constructor
  that raises, an abandoned consumer) must behave as JAX's;
* the JPEG round-trip ingest (--jpeg_ingest, io/video.jpeg_roundtrip and
  the Predictor's switch): tests/test_jpeg_ingest.py's textured frames.
  The round-tripped bytes and the Predictor's result txts must be equal.
"""

import filecmp
import threading
import time
import warnings

import numpy as np
import pytest

from poserisk_release_tpu.io import video as jax_video
from poserisk_release_tpu.tracking.mpt import MultiPersonTracker as JaxTracker
from poserisk_release_tpu_torch.io import video
from poserisk_release_tpu_torch.tracking.mpt import MultiPersonTracker
from tests.test_detection_stride import PixelDetector, make_reversing_clip
from tests.test_jpeg_ingest import _textured_frames
from tests.test_parallel_decode import _collect, _FramelessCapture, _make_video
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

# -- adaptive detection stride -------------------------------------------------


def _static_scene():
    frames = np.zeros((32, 120, 160, 3), np.uint8)
    frames[:, 20:80, 40:70] = 200
    return frames


def _assert_same_tracks(got, want):
    assert list(got) == list(want)  # track ids, in order
    for tid in want:
        assert sorted(got[tid]) == sorted(want[tid])
        np.testing.assert_array_equal(got[tid]["frames"], want[tid]["frames"])
        assert got[tid]["bbox"].dtype == want[tid]["bbox"].dtype == np.float64
        np.testing.assert_array_equal(got[tid]["bbox"], want[tid]["bbox"])


@pytest.mark.parametrize("scene, kw", [
    ("static", {"detection_stride": 8, "adaptive": True}),
    ("reversing", {"detection_stride": 8, "adaptive": True, "adaptive_tol": 0.1}),
    ("reversing", {"detection_stride": 8, "adaptive": False}),
    ("reversing", {"detection_stride": 4, "adaptive": True}),
], ids=["static_adaptive", "reversing_adaptive", "reversing_fixed", "reversing_stride4"])
def test_tracker_matches_jax(scene, kw):
    frames = _static_scene() if scene == "static" else make_reversing_clip()[0]
    det, jax_det = PixelDetector(), PixelDetector()
    got = MultiPersonTracker(det, **kw)(frames)
    want = JaxTracker(jax_det, **kw)(frames)
    assert det.seen == jax_det.seen  # the frames probed, batch by batch
    _assert_same_tracks(got, want)
    if scene == "static":
        assert sum(det.seen) == 4  # frames 0, 8, 16, 24 only


def test_adaptive_validation_matches_jax():
    from poserisk_release_tpu.config import default_config as jax_default_config
    from poserisk_release_tpu_torch.config import default_config

    messages = []
    for tracker, cfg in ((MultiPersonTracker, default_config),
                         (JaxTracker, jax_default_config)):
        with pytest.raises(ValueError, match="adaptive") as tracker_err:
            tracker(PixelDetector(), adaptive=True)
        with pytest.raises(ValueError, match="adaptive_stride") as cfg_err:
            cfg().replace(DETECTOR={"adaptive_stride": True})
        messages.append((str(tracker_err.value), str(cfg_err.value)))
    assert messages[0] == messages[1]


def test_adaptive_streaming_matches_batch_tracker_same_windows(tmp_path):
    """The port's streaming track pass under adaptive_stride equals its own
    batch tracker fed the same windows (the schedule is window-local)."""
    from poserisk_release_tpu_torch.config import default_config
    from poserisk_release_tpu_torch.streaming import StreamingScorer

    frames, _ = make_reversing_clip(n=28)
    path = str(tmp_path / "v.mp4")
    video.write_video(list(frames[..., ::-1]), fps=10.0, file_path=path)
    decoded = video.read_video(path).frames
    cfg = default_config().replace(DETECTOR={"detection_stride": 4, "adaptive_stride": True})
    scorer = StreamingScorer(cfg=cfg, detector=PixelDetector(), window=7, device="cpu")
    stream_tracks, total, _fps = scorer._track_pass(path, None)
    windows = [(s, decoded[s:s + 7]) for s in range(0, len(decoded), 7)]
    batch_tracks = MultiPersonTracker(PixelDetector(), detection_stride=4,
                                      adaptive=True).track_windows(windows)
    assert total == 28 and len(batch_tracks) == 1
    _assert_same_tracks(stream_tracks, batch_tracks)


# -- parallel decode ----------------------------------------------------------

def _assert_same_stream(got, want):
    (fps, windows, end), (wfps, wwindows, wend) = got, want
    assert (fps, end) == (wfps, wend)
    assert [s for s, _ in windows] == [s for s, _ in wwindows]
    for (_, a), (_, b) in zip(windows, wwindows):
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("n_frames, window, workers", [
    (53, 8, 1), (53, 8, 2), (53, 8, 4), (32, 8, 2), (5, 2, 8)],
    ids=["workers1", "workers2", "workers4", "exact_window_multiple", "tiny_clip"])
def test_window_stream_matches_jax(tmp_path, n_frames, window, workers):
    path = _make_video(tmp_path, n_frames=n_frames)
    got = _collect(video.iter_windows_parallel(path, window, workers))
    _assert_same_stream(got, _collect(jax_video.iter_windows_parallel(path, window, workers)))
    _assert_same_stream(got, _collect(video._window_stream(path, window, None)))  # serial
    assert got[2] == n_frames
    if n_frames % window == 0:
        assert all(len(f) == window for _, f in got[1])


@pytest.mark.parametrize("n_frames, kw", [
    (37, {"workers": 4, "window": 6}), (40, {"workers": 3, "window": 4, "max_frames": 21}),
    (9, {"workers": 1})], ids=["workers4", "max_frames", "workers1"])
def test_read_video_parallel_matches_jax_read_video(tmp_path, n_frames, kw):
    path = _make_video(tmp_path, n_frames=n_frames)
    got = video.read_video_parallel(path, **kw)
    want = jax_video.read_video(path, max_frames=kw.get("max_frames"))
    assert got.fps == want.fps
    assert got.frames.dtype == np.uint8 and np.array_equal(got.frames, want.frames)
    assert np.array_equal(got.frames, jax_video.read_video_parallel(path, **kw).frames)


def test_missing_file_raises_like_jax():
    for module in (video, jax_video):
        with pytest.raises(FileNotFoundError):
            _collect(module.iter_windows_parallel("/nonexistent/clip.mp4", 8, 2))


def test_frameless_source_matches_jax(monkeypatch):
    """An openable but frameless file: ('end', 0) after fps 0.0 and a
    warning that parallel decode did not happen."""
    import cv2

    monkeypatch.setattr(cv2, "VideoCapture", _FramelessCapture)
    for module in (video, jax_video):
        with pytest.warns(RuntimeWarning, match="no frame count"):
            assert _collect(module.iter_windows_parallel("fake.mp4", 8, 4)) == (0.0, [], 0)


class _ShiftySeekCapture:
    """tests/test_parallel_decode.py's lying-seek backend: it echoes the
    requested position but lands one frame late, on a clip whose frames 11
    and 12 are equal (so a one-frame guard would pass)."""

    frames = None

    def __init__(self, path):
        self.pos = 0
        self.reported = 0.0

    def isOpened(self):
        return True

    def get(self, prop):
        import cv2

        return {
            cv2.CAP_PROP_FPS: 10.0,
            cv2.CAP_PROP_FRAME_COUNT: float(len(self.frames)),
            cv2.CAP_PROP_FRAME_WIDTH: float(self.frames.shape[2]),
            cv2.CAP_PROP_FRAME_HEIGHT: float(self.frames.shape[1]),
            cv2.CAP_PROP_POS_FRAMES: self.reported,
        }.get(prop, 0.0)

    def set(self, prop, val):
        self.reported = float(int(val))
        self.pos = int(val) + 1
        return True

    def read(self):
        if self.pos >= len(self.frames):
            return False, None
        bgr = self.frames[self.pos].copy()
        self.pos += 1
        return True, bgr

    def grab(self):
        ok, _ = self.read()
        return ok

    def release(self):
        pass


@pytest.mark.parametrize("fault", ["guard_mismatch", "lying_seek", "capture_raises"])
def test_integrity_fallback_matches_jax(tmp_path, monkeypatch, fault):
    """Each fault warns, falls back to the serial tail, and still yields the
    serial decode's bytes, in both packages."""
    import cv2

    path = "fake.mp4"
    kw = {"workers": 3, "window": 4}
    if fault == "lying_seek":
        rng = np.random.RandomState(3)
        frames = rng.randint(0, 255, (24, 120, 160, 3)).astype(np.uint8)
        frames[12] = frames[11]
        monkeypatch.setattr(_ShiftySeekCapture, "frames", frames)
        monkeypatch.setattr(cv2, "VideoCapture", _ShiftySeekCapture)
        kw["workers"] = 2
    else:
        path = _make_video(tmp_path, n_frames=41 if fault == "guard_mismatch" else 30)
    serial = video.read_video(path)
    if fault == "capture_raises":
        real_capture, main = cv2.VideoCapture, threading.main_thread()

        class _RaisesInWorkers:
            def __new__(cls, p):
                if threading.current_thread() is not main:
                    raise RuntimeError("backend init failed")
                return real_capture(p)

        monkeypatch.setattr(cv2, "VideoCapture", _RaisesInWorkers)
    results = []
    for module in (video, jax_video):
        with monkeypatch.context() as m:
            if fault == "guard_mismatch":
                m.setattr(module.np, "array_equal", lambda a, b: False)
            with pytest.warns(RuntimeWarning, match="integrity check failed"):
                results.append(module.read_video_parallel(path, **kw))
    for clip in results:
        assert clip.fps == serial.fps and np.array_equal(clip.frames, serial.frames)


@pytest.mark.parametrize("module", [video, jax_video], ids=["port", "jax"])
def test_abandoned_consumer_releases_threads(tmp_path, module):
    path = _make_video(tmp_path, n_frames=48)
    before = threading.active_count()
    gen = module.iter_windows_parallel(path, 4, 3)
    next(gen)  # meta
    next(gen)  # first window
    gen.close()
    deadline = time.monotonic() + 5.0
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_decode_workers_validation_and_cli_match_jax():
    from poserisk_release_tpu.cli import build_parser as jax_build_parser
    from poserisk_release_tpu.config import default_config as jax_default_config
    from poserisk_release_tpu_torch import cli
    from poserisk_release_tpu_torch.config import default_config

    messages = []
    for cfg in (default_config, jax_default_config):
        with pytest.raises(ValueError, match="decode_workers") as err:
            cfg().replace(DATASET={"decode_workers": 0})
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    argv = ["--decode_workers", "4", "--input", "x.mp4"]
    args = cli.build_parser().parse_args(argv)
    assert args.decode_workers == jax_build_parser().parse_args(argv).decode_workers == 4
    assert cli.config_from_args(args).DATASET.decode_workers == 4


# -- JPEG round-trip ingest ---------------------------------------------------

def test_jpeg_roundtrip_matches_jax_by_both_routes(tmp_path):
    clip = video.VideoClip(frames=_textured_frames(), fps=10.0)
    jclip = jax_video.VideoClip(frames=clip.frames, fps=10.0)
    got = {"disk": video.jpeg_roundtrip(clip, tmp_path=str(tmp_path / "port")),
           "memory": video.jpeg_roundtrip(clip)}
    want = {"disk": jax_video.jpeg_roundtrip(jclip, tmp_path=str(tmp_path / "jax")),
            "memory": jax_video.jpeg_roundtrip(jclip)}
    for route in ("disk", "memory"):
        assert got[route].fps == want[route].fps == 10.0
        assert got[route].frames.dtype == np.uint8
        np.testing.assert_array_equal(got[route].frames, want[route].frames, err_msg=route)
        np.testing.assert_array_equal(got[route].frames, got["disk"].frames)
    assert not np.array_equal(got["disk"].frames, clip.frames)  # lossy: the mode does something


@pytest.fixture(scope="module")
def jpeg_clip(tmp_path_factory):
    """tests/test_jpeg_ingest.py's Predictor clip: 10 frames of 120x160."""
    import cv2

    root = tmp_path_factory.mktemp("jpeg_ingest")
    frames = []
    for i in range(10):
        img = np.full((120, 160, 3), 25, np.uint8)
        cv2.rectangle(img, (40 + i, 20), (90 + i, 110), (180, 150, 130), -1)
        frames.append(img)
    video.write_video(frames, fps=10.0, file_path=str(root / "clip.mp4"))
    return root


def test_predictor_jpeg_ingest_matches_jax(jpeg_clip):
    """DATASET.jpeg_ingest routes both Predictors through the disk round
    trip (and removes its tmp tree); on the same frames, StubDetector and
    SPIN weights their result txts are the same bytes."""
    import torch

    from poserisk_release_tpu.config import default_config as jax_default_config
    from poserisk_release_tpu.models.detector import StubDetector as JaxStubDetector
    from poserisk_release_tpu.pipeline import Predictor as JaxPredictor
    from poserisk_release_tpu_torch.config import default_config
    from poserisk_release_tpu_torch.models.convert import spin_state_dict_to_flax
    from poserisk_release_tpu_torch.models.detector import StubDetector
    from poserisk_release_tpu_torch.models.spin import init_spin_params, load_mean_params
    from poserisk_release_tpu_torch.pipeline import Predictor

    over = {"DATASET": {"jpeg_ingest": True}, "MODEL": {"input_shape": (64, 64)},
            "PARALLEL": {"frames_per_step": 8}}
    sd = init_spin_params(torch.Generator().manual_seed(5), load_mean_params(""))
    port = Predictor(cfg=default_config().replace(**over), detector=StubDetector(),
                     visualize=False, spin_variables=sd, device="cpu")
    jax_pred = JaxPredictor(cfg=jax_default_config().replace(**over),
                            detector=JaxStubDetector(), visualize=False,
                            spin_variables=spin_state_dict_to_flax(sd))
    path = str(jpeg_clip / "clip.mp4")
    summary = port(path, "/nonexistent.json", str(jpeg_clip / "port"))
    jax_pred(path, "/nonexistent.json", str(jpeg_clip / "jax"))
    assert "decode" in port.timings  # the round-trip branch, not the overlapped ingest
    assert "REBA" in summary and "RULA" in summary
    for side in ("port", "jax"):
        assert not (jpeg_clip / side / "tmp").exists()
    for name in ("reba_result.txt", "rula_result.txt"):
        assert filecmp.cmp(jpeg_clip / "jax" / name, jpeg_clip / "port" / name,
                           shallow=False), name


def test_preprocessing_crops_the_round_tripped_frames(tmp_path, monkeypatch):
    """process_video(jpeg_ingest=True) hands person_chunks the round-tripped
    frames (JAX's jpeg_roundtrip bytes), and its files hold their crops."""
    import cv2

    from poserisk_release_tpu_torch.models.detector import StubDetector
    from poserisk_release_tpu_torch.tools import data_preprocessing as dp

    frames = []
    for i in range(20):
        img = np.full((120, 160, 3), 20, np.uint8)
        cv2.rectangle(img, (40 + i, 20), (90 + i, 110), (150, 150, 150), -1)
        img[::2, ::3] += np.uint8(40)  # texture, so the JPEG round trip changes pixels
        frames.append(img)
    path = str(tmp_path / "clipA.mp4")
    video.write_video(frames, fps=2.0, file_path=path)
    decoded = video.read_video(path)

    seen, real_person_chunks = [], dp.person_chunks

    def recording(frames_rgb, *args, **kwargs):
        seen.append(frames_rgb)
        for chunk in real_person_chunks(frames_rgb, *args, **kwargs):
            seen.append(chunk)
            yield chunk

    monkeypatch.setattr(dp, "person_chunks", recording)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        written = dp.process_video(path, str(tmp_path / "images"), str(tmp_path / "processed"),
                                   MultiPersonTracker(StubDetector()), jpeg_ingest=True,
                                   device="cpu")
    want = jax_video.jpeg_roundtrip(jax_video.VideoClip(frames=decoded.frames, fps=2.0)).frames
    np.testing.assert_array_equal(seen[0], want)
    assert not np.array_equal(seen[0], decoded.frames)
    (chunk,) = seen[1:]
    assert len(written) == 1 and len(chunk["frames"]) == 16
    own = cv2.imdecode(cv2.imencode(".jpg", chunk["images_bgr"][0])[1], cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "images" / "clipA" / "0" /
                                                 "000000.jpg")), own)
