"""The port's StreamingScorer against the JAX package's, on the CPU.

Clips: the recipes of tests/test_streaming.py (40 frames of 120x160 with a
moving block; the contention clip, where a large person present for 10
frames competes with a smaller one tracked to the end; the two-person clip,
where both survive the min-frames filter), written with the port's
write_video. Both packages get the same SPIN weights: the port's seeded
init, handed to the JAX package as its Flax tree
(models/convert.spin_state_dict_to_flax) and back to the port through
flax_to_state_dict. frames_per_step = window = 16.

What must agree with the JAX scorer, in the two-pass mode at pose_stride 1
and 2, the online mode at detection_stride 1 and 3, and score_all:
  * the scored frames, the boxes every run_from_frames call receives,
    total_frames and fps, exactly;
  * the per-frame REBA and RULA scores. A frame may differ only where the
    JAX package's scorer, applied to the port's Euler angles, gives the
    port's score (tests/test_torch_pipeline.py's rule); the angles agree
    within 0.05 degrees;
  * the bytes of reba_result.txt, rula_result.txt and stream_summary.json.

The online target tracker gives the JAX tracker's frames and boxes on its
own. tests/test_torch_streaming_cli.py holds the CLI, the annotated video,
the port's batch Predictor and the run-time contracts.
"""

import filecmp
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poserisk_release_tpu.config import default_config as jax_default_config
from poserisk_release_tpu.scoring.reba import REBAScorer as JaxREBAScorer
from poserisk_release_tpu.scoring.rula import RULAScorer as JaxRULAScorer
from poserisk_release_tpu.streaming import OnlineTargetTracker as JaxOnlineTargetTracker
from poserisk_release_tpu.streaming import StreamingScorer as JaxStreamingScorer
from poserisk_release_tpu_torch import streaming
from poserisk_release_tpu_torch.config import default_config
from poserisk_release_tpu_torch.io.video import write_video
from poserisk_release_tpu_torch.models.convert import flax_to_state_dict, spin_state_dict_to_flax
from poserisk_release_tpu_torch.models.spin import init_spin_params, load_mean_params
from poserisk_release_tpu_torch.streaming import StreamingScorer, StreamResult
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

WINDOW = 16
OUTPUT_FILES = ("reba_result.txt", "rula_result.txt", "stream_summary.json")
INFO = json.load(open(streaming.__file__.replace("streaming.py", "default_information.json")))


class ScriptedDetector:
    """Cursor-scripted detector: serves per-frame detection lists across
    window-sized calls (tests/test_streaming.py's _ScriptedStreamDetector)."""

    def __init__(self, per_frame_dets):
        self.dets = [np.asarray(d, np.float32).reshape(-1, 5) for d in per_frame_dets]
        self.pos = 0

    def __call__(self, frames):
        out = self.dets[self.pos:self.pos + len(frames)]
        self.pos += len(frames)
        return [d.copy() for d in out]


def contention_dets(n_frames=40):
    """Person B (smaller) from frame 2 to the end; person A (larger) only in
    frames 0..9, below the min-frames filter."""
    dets = []
    for i in range(n_frames):
        frame = []
        if i >= 2:
            frame.append([30.0 + i, 20.0, 80.0 + i, 110.0, 0.9])
        if i < 10:
            frame.append([90.0, 5.0, 160.0, 118.0, 0.95])
        dets.append(frame)
    return dets


def two_survivor_dets(n_frames=40):
    """A in frames 0..24, B in 2..39: both pass the min-frames filter."""
    dets = []
    for i in range(n_frames):
        frame = []
        if i >= 2:
            frame.append([30.0 + i, 20.0, 80.0 + i, 110.0, 0.9])
        if i < 25:
            frame.append([90.0, 5.0, 160.0, 118.0, 0.95])
        dets.append(frame)
    return dets


def strided_dets(n_frames, stride, missing=()):
    """One detection list per stride-th frame, a box moving every frame;
    steps at the global indices in `missing` see nobody."""
    return [[] if g in missing else [[20.0 + g, 15.0, 70.0 + g, 105.0, 0.9]]
            for g in range(0, n_frames, stride)]


def _write_clip(path, second_box_until=0, x0=40):
    import cv2

    frames = []
    for i in range(40):
        img = np.full((120, 160, 3), 25, np.uint8)
        cv2.rectangle(img, (x0 + i, 20), (x0 + 50 + i, 110), (180, 150, 130), -1)
        if i < second_box_until:
            cv2.rectangle(img, (90, 5), (160, 118), (90, 200, 90), -1)
        frames.append(img)
    write_video(frames, fps=10.0, file_path=str(path))
    return str(path)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_stream")
    return {"long": _write_clip(root / "long.mp4"),
            "contention": _write_clip(root / "contention.mp4", 10, x0=30),
            "two_person": _write_clip(root / "two_person.mp4", 25, x0=30)}


@pytest.fixture(scope="module")
def weights():
    variables = spin_state_dict_to_flax(
        init_spin_params(torch.Generator().manual_seed(0), load_mean_params("")))
    return jax.tree_util.tree_map(jnp.asarray, variables), flax_to_state_dict(variables)


def _cfgs(**over):
    common = dict(PARALLEL={"frames_per_step": 16}, **over)
    return jax_default_config().replace(**common), default_config().replace(**common)


@pytest.fixture(scope="module")
def jax_scorers(weights):
    """One JAX scorer per pose stride, shared by the parity cases so that
    its jitted steps compile once per module (a case sets its own config,
    detector and selection mode)."""
    return {stride: JaxStreamingScorer(cfg=_cfgs(SPIN={"pose_stride": stride})[0],
                                       window=WINDOW, spin_variables=weights[0])
            for stride in (1, 2)}


def _jax_scorer(jax_scorers, jcfg, detector, selection="reference"):
    scorer = jax_scorers[jcfg.SPIN.pose_stride]
    scorer.cfg, scorer.detector, scorer.selection = jcfg, detector, selection
    return scorer


class Probe:
    """Records a scorer's run_from_frames calls (f32 boxes, f64 Euler
    angles) and files each under the StreamResult it fed."""

    def __init__(self, scorer):
        self.calls, self.by_result = [], {}
        run = type(scorer.estimator).run_from_frames.__get__(scorer.estimator)
        score_window = type(scorer)._score_window.__get__(scorer)

        def run_from_frames(frames, ids, boxes, chunk=0):
            out = run(frames, ids, boxes, chunk=chunk)
            self.calls.append((np.asarray(boxes, np.float32), np.asarray(out[0], np.float64)))
            return out

        def spy(*args, **kwargs):
            n = len(self.calls)
            score_window(*args, **kwargs)
            self.by_result.setdefault(id(args[7]), []).extend(self.calls[n:])

        scorer.estimator.run_from_frames = run_from_frames
        scorer._score_window = spy

    def angles(self, result=None):
        calls = self.calls if result is None else self.by_result[id(result)]
        return np.concatenate([e for _, e in calls])


def assert_same_result(jres, pres, jax_angles, port_angles):
    assert pres.frames == jres.frames
    assert (pres.total_frames, pres.fps) == (jres.total_frames, jres.fps)
    assert port_angles.shape == jax_angles.shape == (len(pres.frames), 24, 3)
    d = np.abs(port_angles - jax_angles)
    assert np.minimum(d, 360.0 - d).max() < 0.05
    for name, jax_scorer in (("reba", JaxREBAScorer), ("rula", JaxRULAScorer)):
        got = np.asarray(getattr(pres, f"{name}_scores"))
        want = np.asarray(getattr(jres, f"{name}_scores"))
        assert got.shape == want.shape
        for i in np.flatnonzero(got != want):
            excuse = jax_scorer()(port_angles[i:i + 1], None, INFO)[0]["score"]
            assert int(excuse) == got[i], f"{name} frame {pres.frames[i]}: {got[i]} vs {want[i]}"


def assert_same_files(jax_dir, port_dir):
    for name in OUTPUT_FILES:
        assert filecmp.cmp(jax_dir / name, port_dir / name, shallow=False), name


# (clip, detections or None for the full-frame stub, config overrides, selection)
CASES = {
    "two_pass_pose_stride_1": ("contention", contention_dets, {}, "reference"),
    "two_pass_pose_stride_2": ("long", lambda: strided_dets(40, 1),
                               {"SPIN": {"pose_stride": 2}}, "reference"),
    "online_detection_stride_1": ("contention", contention_dets, {}, "online"),
    "online_detection_stride_3": ("long", lambda: strided_dets(40, 3, missing={15}),
                                  {"DETECTOR": {"detection_stride": 3}}, "online"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_single_target_matches_jax(case, clips, weights, jax_scorers, tmp_path):
    clip, dets, over, selection = CASES[case]
    jcfg, pcfg = _cfgs(**over)
    jax_s = _jax_scorer(jax_scorers, jcfg, ScriptedDetector(dets()), selection)
    port_s = StreamingScorer(cfg=pcfg, detector=ScriptedDetector(dets()), window=WINDOW,
                             spin_variables=weights[1], selection=selection, device="cpu")
    jp, pp = Probe(jax_s), Probe(port_s)
    jres, pres = jax_s(clips[clip], INFO), port_s(clips[clip], INFO)
    assert len(pp.calls) == len(jp.calls)
    for (pb, _), (jb, _) in zip(pp.calls, jp.calls):
        np.testing.assert_array_equal(pb, jb)
    assert_same_result(jres, pres, jp.angles(), pp.angles())
    jax_s.write_outputs(jres, str(tmp_path / "jax"))
    port_s.write_outputs(pres, str(tmp_path / "port"))
    assert_same_files(tmp_path / "jax", tmp_path / "port")
    if case.startswith("online_detection_stride_3"):
        # Every frame between the first and last detection is scored.
        assert pres.frames == list(range(40))


def test_score_all_matches_jax(clips, weights, jax_scorers, tmp_path):
    jcfg, pcfg = _cfgs()
    jax_s = _jax_scorer(jax_scorers, jcfg, ScriptedDetector(two_survivor_dets()))
    port_s = StreamingScorer(cfg=pcfg, detector=ScriptedDetector(two_survivor_dets()),
                             window=WINDOW, spin_variables=weights[1], device="cpu")
    jp, pp = Probe(jax_s), Probe(port_s)
    seen = []
    run = port_s.estimator._run_chunked

    def run_chunked(num_items, host_chunk, step_fn, chunk=0):
        seen.append(host_chunk(0, 1)[0])
        return run(num_items, host_chunk, step_fn, chunk)

    port_s.estimator._run_chunked = run_chunked
    jres = jax_s.score_all(clips["two_person"], INFO)
    pres = port_s.score_all(clips["two_person"], INFO)
    assert list(pres) == list(jres) and len(pres) == 2
    for (pb, _), (jb, _) in zip(pp.calls, jp.calls):
        np.testing.assert_array_equal(pb, jb)
    assert len(pp.calls) == len(jp.calls)
    for pid in pres:
        assert_same_result(jres[pid], pres[pid], jp.angles(jres[pid]), pp.angles(pres[pid]))
        jax_s.write_outputs(jres[pid], str(tmp_path / "jax" / f"person_{pid}"))
        port_s.write_outputs(pres[pid], str(tmp_path / "port" / f"person_{pid}"))
        assert_same_files(tmp_path / "jax" / f"person_{pid}", tmp_path / "port" / f"person_{pid}")
    # Windows where both people are tracked share one upload of the union of
    # their frames: a tensor on the estimator's device reaches _run_chunked.
    assert any(isinstance(s, torch.Tensor) and s.device == port_s.device for s in seen)


def test_online_target_tracker_matches_jax():
    """The online policy (lock-on, re-lock, interpolated, held and
    anchor-hold boxes, copy_pending) gives the JAX tracker's frames and
    boxes on a scripted sequence with a gap longer than the ring and an
    identity switch."""
    rs = np.random.RandomState(2)
    frames = rs.randint(0, 256, (40, 4, 4, 3)).astype(np.uint8)
    seq = []
    for g in range(40):
        if g % 3:
            seq.append(None)
        elif g in (12, 15):
            seq.append(np.zeros((0, 5)))
        elif g < 21:
            seq.append(np.array([[20.0 + g, 15.0, 70.0 + g, 105.0, 0.9]]))
        else:
            seq.append(np.array([[100.0, 15.0, 150.0, 105.0, 0.9]]))
    for kw in ({"ring_capacity": 4}, {"ring_capacity": 16, "copy_pending": True},
               {"ring_capacity": 4, "backfill": False}):
        port, ref = streaming.OnlineTargetTracker(**kw), JaxOnlineTargetTracker(**kw)
        got, want = [], []
        for g in range(40):
            got += port.observe(g, frames[g], seq[g])
            want += ref.observe(g, frames[g], seq[g])
        assert [g for g, _, _ in got] == [g for g, _, _ in want]
        for (_, prgb, pbox), (_, jrgb, jbox) in zip(got, want):
            np.testing.assert_array_equal(prgb, jrgb)
            np.testing.assert_array_equal(pbox, jbox)
        assert got and (port.target_id, len(port.pending)) == (ref.target_id, len(ref.pending))
        if kw.get("copy_pending"):
            assert not any(np.shares_memory(p, frames) for _, p in port.pending)


def test_stats_share_the_one_implementation():
    from poserisk_release_tpu_torch.outputs.stats import final_scores_stats

    scores = [2, 2, 8, 8, 5, 3, 7, 1, 9, 4]
    assert StreamResult(reba_scores=list(scores)).stats("reba") == final_scores_stats(scores)
    with pytest.raises(ValueError, match="no scored frames"):
        StreamResult().stats("reba")
