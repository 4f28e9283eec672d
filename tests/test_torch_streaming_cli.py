"""The port's --streaming CLI against the JAX package's, the streamed
annotated video, the port's streaming scorer against its own batch
Predictor, and the scorer's run-time contracts, on the CPU.

The clips, detectors and SPIN weights are tests/test_torch_streaming.py's.
The two CLIs read the same weights from one `.flax.npz` cache beside a
checkpoint path named in a YAML override, run with --streaming_window 8,
and must write the same bytes: reba_result.txt, rula_result.txt and
stream_summary.json, under --multi_person in the same person_<id>/
directories.

Where the port is held against itself, it crops 64x64 (SMALL). Against
the port's batch Predictor the per-frame scores are exactly equal
at pose_stride 1 and 2 and under contention, and the streamed
REBA_video.mp4 decodes to the frames of the batch render_result_video. The
contracts: a tensor frame source gives the numpy source's bits; a
mid-clip decode failure raises RuntimeError and a missing video
FileNotFoundError; score_all refuses the online mode; no tracks raises;
an unmatched video_types warns and skips rendering; and the number of
decode windows alive at once does not grow with the clip.
"""

import filecmp
import os
import weakref

import numpy as np
import pytest
import torch

from poserisk_release_tpu_torch import cli, streaming
from poserisk_release_tpu_torch.config import default_config
from poserisk_release_tpu_torch.models.convert import save_flax_variables, spin_state_dict_to_flax
from poserisk_release_tpu_torch.models.detector import StubDetector
from poserisk_release_tpu_torch.models.spin import init_spin_params, load_mean_params
from poserisk_release_tpu_torch.pipeline import Predictor
from poserisk_release_tpu_torch.streaming import StreamingScorer, StreamResult
from tests.test_torch_streaming import (  # noqa: F401  (clips, weights: fixtures)
    INFO,
    OUTPUT_FILES,
    WINDOW,
    ScriptedDetector,
    _cfgs,
    clips,
    contention_dets,
    strided_dets,
    two_survivor_dets,
    weights,
)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


# The port held against itself crops 64x64: what these tests check does not
# depend on the crop size, and ResNet-50 costs a twelfth of 224x224's.
SMALL = {"MODEL": {"input_shape": (64, 64)}}


@pytest.fixture(scope="module")
def override(tmp_path_factory):
    """A YAML override naming a checkpoint path whose `.flax.npz` cache holds
    the shared weights (the checkpoint itself is absent: both packages then
    load the cache)."""
    root = tmp_path_factory.mktemp("stream_cli")
    ckpt = root / "model_checkpoint.pt"
    save_flax_variables(spin_state_dict_to_flax(
        init_spin_params(torch.Generator().manual_seed(0), load_mean_params(""))),
        str(ckpt) + ".flax.npz")
    (root / "override.yaml").write_text(f"SPIN:\n  checkpoint: {ckpt}\n")
    return str(root / "override.yaml")


@pytest.mark.parametrize("multi_person", [False, True])
def test_cli_streaming_writes_the_jax_files(clips, override, tmp_path, monkeypatch,
                                            multi_person):
    from poserisk_release_tpu import cli as jax_cli

    clip = clips["two_person" if multi_person else "long"]
    if multi_person:
        monkeypatch.setattr("poserisk_release_tpu.pipeline.build_detector",
                            lambda cfg: ScriptedDetector(two_survivor_dets()))
        monkeypatch.setattr("poserisk_release_tpu_torch.pipeline.build_detector",
                            lambda cfg, device: ScriptedDetector(two_survivor_dets()))
    argv = ["--cpu", "--streaming", "--streaming_window", "8", "--no_visualize",
            "--input", clip, "--info", "missing.json", "--cfg", override]
    argv += ["--multi_person"] if multi_person else []
    assert jax_cli.main(argv + ["--num_devices", "1", "--output", str(tmp_path / "jax")]) == 0
    assert cli.main(argv + ["--output", str(tmp_path / "port")]) == 0
    dirs = [""]
    if multi_person:
        dirs = sorted(d for d in os.listdir(tmp_path / "jax") if d.startswith("person_"))
        assert len(dirs) == 2
        assert sorted(d for d in os.listdir(tmp_path / "port") if d.startswith("person_")) == dirs
    for d in dirs:
        for name in OUTPUT_FILES:
            assert filecmp.cmp(tmp_path / "jax" / d / name, tmp_path / "port" / d / name,
                               shallow=False), (d, name)
        assert not (tmp_path / "port" / d / "REBA_video.mp4").exists()


class Recording:
    """Wraps a Predictor's scorer and keeps its per-frame scores."""

    def __init__(self, scorer):
        self._scorer, self.scores = scorer, None

    def __call__(self, poses, joint_cams, add_info):
        results = self._scorer(poses, joint_cams, add_info)
        self.scores = [r["score"] for r in results]
        return results

    def __getattr__(self, name):
        return getattr(self._scorer, name)


def _decoded_video(path):
    import cv2

    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return np.stack(frames)


def test_streamed_video_is_frame_exact_vs_batch_renderer(clips, weights, tmp_path):
    """The target is tracked in frames 0..29 only, so the tail takes the
    renderer's 'Not detected target' branch and the full-clip decode. The
    per-frame scores are the batch Predictor's too (pose_stride 1)."""
    dets = [[[30.0, 20.0, 80.0, 110.0, 0.9]] if i < 30 else [] for i in range(40)]
    cfg = _cfgs(**SMALL)[1]
    pred = Predictor(cfg=cfg, detector=ScriptedDetector(dets), visualize=True,
                     spin_variables=weights[1], device="cpu")
    pred.reba, pred.rula = Recording(pred.reba), Recording(pred.rula)
    pred(clips["long"], "/nonexistent.json", str(tmp_path / "batch"))
    scorer = StreamingScorer(cfg=cfg, detector=ScriptedDetector(dets), window=WINDOW,
                             spin_variables=weights[1], device="cpu")
    res = scorer(clips["long"], INFO, video_output=str(tmp_path / "stream"), video_types="REBA")
    assert res.frames == list(range(30))
    assert res.reba_scores == pred.reba.scores and res.rula_scores == pred.rula.scores
    batch = _decoded_video(tmp_path / "batch" / "REBA_video.mp4")
    stream = _decoded_video(tmp_path / "stream" / "REBA_video.mp4")
    assert batch.shape == stream.shape and batch.shape[0] == 40
    np.testing.assert_array_equal(stream, batch)
    assert not (tmp_path / "stream" / "RULA_video.mp4").exists()


BATCH_CASES = {
    "pose_stride_2": ("long", lambda: strided_dets(40, 1), {"SPIN": {"pose_stride": 2}}),
    "contention": ("contention", contention_dets, {}),
}


@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_streaming_equals_the_ports_batch_predictor(case, clips, weights, tmp_path):
    clip, dets, over = BATCH_CASES[case]
    cfg = _cfgs(**over, **SMALL)[1]
    sd = weights[1]

    stream = StreamingScorer(cfg=cfg, detector=ScriptedDetector(dets()), window=WINDOW,
                             spin_variables=sd, device="cpu")(clips[clip], INFO)
    pred = Predictor(cfg=cfg, detector=ScriptedDetector(dets()), visualize=False,
                     spin_variables=sd, device="cpu")
    pred.reba, pred.rula = Recording(pred.reba), Recording(pred.rula)
    summary = pred(clips[clip], "/nonexistent.json", str(tmp_path / "batch"))
    assert stream.reba_scores == pred.reba.scores
    assert stream.rula_scores == pred.rula.scores
    assert stream.stats("reba") == summary["REBA"][0]
    assert stream.stats("rula") == summary["RULA"][0]
    if case == "contention":
        assert min(stream.frames) == 2 and max(stream.frames) == 39  # person B


@pytest.mark.parametrize("pose_stride", [1, 2])
def test_tensor_source_equals_numpy_source(weights, pose_stride):
    """run_from_frames on a tensor source gathers and pads on the tensor's
    device and gives the numpy source's bits; 11 frames in chunks of 4 pad
    the last chunk."""
    from poserisk_release_tpu_torch.body.smpl import SMPLFamily
    from poserisk_release_tpu_torch.pipeline import PoseEstimator

    cfg = default_config().replace(SPIN={"pose_stride": pose_stride}, **SMALL)
    est = PoseEstimator(cfg, SMPLFamily(cfg.SPIN.smpl_model_dir), variables=weights[1],
                        device="cpu")
    rs = np.random.RandomState(5)
    frames = rs.randint(0, 256, (14, 48, 64, 3)).astype(np.uint8)
    ids = rs.permutation(14)[:11]
    boxes = np.column_stack([rs.uniform(20, 44, 11), rs.uniform(15, 33, 11),
                             rs.uniform(10, 40, 11), rs.uniform(10, 40, 11)])
    want = est.run_from_frames(frames, ids, boxes, chunk=4)
    got = est.run_from_frames(torch.as_tensor(frames), ids, boxes, chunk=4)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (11, 24, 3)
        np.testing.assert_array_equal(g, w)


def test_mid_clip_decode_failure_and_missing_video_raise(clips, weights, monkeypatch):
    import poserisk_release_tpu_torch.io.video as video_mod

    scorer = StreamingScorer(cfg=default_config().replace(**SMALL), detector=StubDetector(),
                             window=8, spin_variables=weights[1], device="cpu")
    with pytest.raises(FileNotFoundError, match="cannot open video"):
        scorer("/nonexistent/clip.mp4", INFO)
    real = video_mod._decoded_rgb

    def dying(cap, width, height, max_frames=None):
        for idx, rgb in real(cap, width, height, max_frames=max_frames):
            if idx == 19:
                raise MemoryError("synthetic mid-clip decode failure")
            yield idx, rgb

    monkeypatch.setattr(video_mod, "_decoded_rgb", dying)
    with pytest.raises(RuntimeError, match="decode failed after frame"):
        scorer(clips["long"], INFO)


class NothingDetector:
    def __call__(self, frames_rgb):
        return [np.zeros((0, 5), np.float32) for _ in range(len(frames_rgb))]


@pytest.mark.parametrize("selection", ["reference", "online"])
def test_no_tracks_and_refused_modes_raise(clips, weights, selection):
    """No tracks raises in both modes, as the batch path does; score_all
    refuses the online mode, and the online mode refuses to render."""
    scorer = StreamingScorer(detector=NothingDetector(), window=16, spin_variables=weights[1],
                             selection=selection, device="cpu")
    with pytest.raises(ValueError, match="no person tracks"):
        scorer(clips["long"], INFO)
    if selection == "online":
        with pytest.raises(ValueError, match="two-pass"):
            scorer.score_all(clips["long"], INFO)
        with pytest.raises(ValueError, match="two-pass"):
            scorer(clips["long"], INFO, video_output="/nonexistent/out")
    else:
        assert scorer.score_all(clips["long"], INFO) == {}


def test_unmatched_video_types_warn_and_skip_rendering(clips, weights, tmp_path):
    scorer = StreamingScorer(cfg=default_config().replace(**SMALL), detector=StubDetector(),
                             window=16, spin_variables=weights[1], device="cpu")
    with pytest.warns(UserWarning, match="neither REBA nor RULA"):
        res = scorer(clips["long"], INFO, max_frames=16, video_output=str(tmp_path / "x"),
                     video_types="NONSENSE")
    assert len(res.reba_scores) == 16
    assert not (tmp_path / "x").exists()


@pytest.mark.parametrize("selection, over", [
    ("reference", {}), ("online", {"DETECTOR": {"detection_stride": 3}}),
])
def test_live_windows_do_not_grow_with_the_clip(weights, monkeypatch, selection, over):
    """Bounded memory: an in-memory window stream tracks every window it
    yields by weakref; the most windows alive at once is the same for a
    24-frame and a 48-frame stream at window 8."""
    cfg = default_config().replace(PARALLEL={"frames_per_step": 8}, **over, **SMALL)

    def peak_live_windows(n_frames):
        live, peak = [], [0]

        def stream(video_path, window, max_frames, workers=1):
            total = n_frames if max_frames is None else min(n_frames, max_frames)
            yield ("meta", 10.0)
            for start in range(0, total, window):
                n = min(window, total - start)
                frames = np.random.RandomState(start).randint(
                    0, 256, (n, 32, 48, 3)).astype(np.uint8)
                live.append(weakref.ref(frames))
                peak[0] = max(peak[0], sum(r() is not None for r in live))
                yield ("window", start, frames)
                del frames
            yield ("end", total)

        monkeypatch.setattr(streaming, "_window_stream", stream)
        scorer = StreamingScorer(cfg=cfg, detector=StubDetector(), window=8,
                                 spin_variables=weights[1], selection=selection, device="cpu")
        res = scorer("clip.mp4", INFO)
        assert len(res.frames) == n_frames - (2 if selection == "online" else 0)
        return peak[0]

    assert peak_live_windows(24) == peak_live_windows(48)


def test_track_chunk_scorer_copies_anchor_pixels(weights):
    cfg = default_config().replace(SPIN={"pose_stride": 2})
    scorer = StreamingScorer(cfg=cfg, detector=StubDetector(), window=8,
                             spin_variables=weights[1], device="cpu")
    reba, rula = scorer._scorers()
    acc = streaming._TrackChunkScorer(scorer, INFO, reba, rula, StreamResult(),
                                      streaming._SpinCalibrator(scorer.estimator))
    window = np.zeros((8, 32, 32, 3), np.uint8)
    acc.add(window, np.arange(4), np.zeros((4, 4), np.float64), 0)
    assert acc._anchor_px and not any(np.shares_memory(a, window) for a in acc._anchor_px)
