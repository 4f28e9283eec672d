"""The PyTorch port stands alone: no jax, no JAX package, no silent CPU.

Every module of poserisk_release_tpu_torch is imported in a fresh
interpreter, which must end with neither jax nor poserisk_release_tpu (or
any of its submodules) loaded; a source scan backs that up for code paths
an import does not execute. The entry points must refuse to run when no
device is given and CUDA is absent, instead of falling back to the CPU.
"""

import os
import os.path as osp
import re
import subprocess
import sys

import pytest
import torch

from poserisk_release_tpu_torch import cli
from poserisk_release_tpu_torch.body.smpl import SMPLFamily
from poserisk_release_tpu_torch.config import default_config
from poserisk_release_tpu_torch.pipeline import PoseEstimator, Predictor

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
PKG = osp.join(REPO, "poserisk_release_tpu_torch")


def _port_modules():
    mods = []
    for root, _, files in os.walk(PKG):
        for name in sorted(files):
            if name.endswith(".py"):
                rel = osp.relpath(osp.join(root, name), REPO)[:-3].replace(os.sep, ".")
                mods.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    return sorted(mods)


def test_importing_every_module_loads_no_jax():
    """...and creates no process group: importing parallel/* (or anything
    else) must not join or start a torch.distributed group."""
    mods = _port_modules()
    for mod in ("ops.resample", "ops.skin", "ops.lbs", "models.detector", "throughput",
                "ops.qconv", "ops.yolo_stage", "models.resnet_int8", "tools.exp_fused_stage",
                "tools.exp_window_crop", "streaming", "serving", "parallel", "parallel.mesh",
                "parallel.distributed", "parallel.collectives", "parallel.spmd",
                "parallel.pipeline", "parallel.expert", "train", "train.losses", "train.optim",
                "train.step", "train.datasets", "train.plots", "io.images", "io.keypoints",
                "ops.sampling", "utils.profiling", "tools.data_preprocessing", "bench",
                "tools.profile_stages", "tools.roofline_detector", "tools.roofline_spin",
                "tools.bench_e2e", "graft_entry", "tools.ab", "tools.exp_resample",
                "tools.exp_det_stride", "tools.exp_pose_stride", "tools.exp_mixed_int8",
                "tools.exp_spin_mixed", "tools.exp_int8_glue", "tools.exp_spin_early",
                "tools.smoke_stream_session", "tools.soak_streaming",
                "tools.bench_reference_hotloop", "tools.reference_rules",
                "tools.validate_real_assets"):
        assert f"poserisk_release_tpu_torch.{mod}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'poserisk_release_tpu' or m.startswith('poserisk_release_tpu.')]\n"
        "print(sorted(bad))\n"
        "import torch.distributed as dist\n"
        "print(dist.is_available() and dist.is_initialized())\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]", "False"]


SOURCES = ["chip_smoke.py"] + sorted(
    osp.relpath(osp.join(root, f), REPO)
    for root, _, files in os.walk(PKG) for f in files if f.endswith(".py"))


@pytest.mark.parametrize("path", SOURCES)
def test_sources_name_no_jax(path):
    text = open(osp.join(REPO, path)).read()
    assert not re.search(r"^\s*(import jax|from jax)\b", text, re.M), path
    assert not re.search(r"poserisk_release_tpu\.", text), path
    assert not re.search(r"\bimport poserisk_release_tpu\b(?!_torch)", text), path


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_pose_estimator_without_device_raises_when_cuda_absent(no_cuda):
    cfg = default_config()
    smpl = SMPLFamily(cfg.SPIN.smpl_model_dir)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PoseEstimator(cfg, smpl)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PoseEstimator(cfg, smpl, device="cuda")


def test_predictor_and_cli_without_device_raise_when_cuda_absent(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--input", str(tmp_path / "none.mp4"), "--output", str(tmp_path)])


@pytest.mark.parametrize("argv", [
    ["--streaming", "--tp", "2"], ["--streaming", "--num_devices", "2"],
    ["--streaming", "--pp", "2"], ["--sp", "2"], ["--streaming", "--sp", "2"],
    ["--streaming", "--ep", "3"],
])
def test_cli_runs_sp_and_streaming_under_a_mesh(argv, monkeypatch, tmp_path):
    """--sp, and --streaming under any mesh, reach cfg.PARALLEL and spawn
    the world's ranks (gloo with --cpu); nothing is refused."""
    spawned = {}

    def fake_run_ranks(fn, world, backend, init_method, args=(), timeout=None):
        spawned.update(world=world, backend=backend, args=args[0], cfg=args[1])

    monkeypatch.setattr(cli, "run_ranks", fake_run_ranks)
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert cli.main(["--cpu", "--input", str(tmp_path / "v.mp4")] + argv) == 0
    p = spawned["cfg"].PARALLEL
    assert spawned["world"] == p.num_devices * p.model * p.stage * p.expert * p.spatial > 1
    assert spawned["backend"] == "gloo"
    assert spawned["args"].streaming == ("--streaming" in argv)
    flag, size = argv[-2:]
    axis = {"--tp": "model", "--pp": "stage", "--ep": "expert", "--sp": "spatial",
            "--num_devices": "num_devices"}[flag]
    assert getattr(p, axis) == int(size)


def test_streaming_without_device_raises_when_cuda_absent(no_cuda, tmp_path):
    """The streaming scorer and --streaming follow resolve_device: CUDA
    unless the CPU is named, never a quiet CPU default."""
    from poserisk_release_tpu_torch.streaming import StreamingScorer

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamingScorer()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamingScorer(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--streaming", "--input", str(tmp_path / "none.mp4"),
                  "--output", str(tmp_path)])


def test_serving_without_device_raises_when_cuda_absent(no_cuda):
    """The server follows resolve_device: CUDA unless the CPU is named."""
    from poserisk_release_tpu_torch.serving import PoseScoringServer

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PoseScoringServer(warm=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PoseScoringServer(warm=False, device="cuda")


def test_tools_and_int8_entry_points_without_device_raise_when_cuda_absent(no_cuda):
    from poserisk_release_tpu_torch.models.detector import (
        YoloDetector,
        fold_bn_params,
        init_yolo_params,
    )
    from poserisk_release_tpu_torch.tools import exp_fused_stage, exp_window_crop

    cfg = default_config()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PoseEstimator(cfg, SMPLFamily(cfg.SPIN.smpl_model_dir), spin_int8=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        YoloDetector(params=fold_bn_params(init_yolo_params(0)), int8=True, rect=True)
    for tool in (exp_fused_stage, exp_window_crop):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tool.main([])


@pytest.mark.parametrize("scorer", ["REBA", "RULA"])
def test_scorers_without_device_raise_when_cuda_absent(no_cuda, scorer):
    """The scorers follow the entry points' rule (resolve_device): CUDA
    unless the CPU is named, never a quiet CPU default."""
    import numpy as np

    from poserisk_release_tpu_torch import pipeline
    from poserisk_release_tpu_torch.device import resolve_device
    from poserisk_release_tpu_torch.scoring import reba, rula
    from poserisk_release_tpu_torch.scoring.common import frame_scores_chunked

    module = {"REBA": reba, "RULA": rula}[scorer]
    cls = getattr(module, f"{scorer}Scorer")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cls()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cls(debug=True, device="cuda")
    assert cls(device="cpu").device == torch.device("cpu")
    engine = getattr(module, f"{scorer.lower()}_frame_scores")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        frame_scores_chunked(engine, np.zeros((1, 24, 3)), np.zeros(1, np.int32))
    assert pipeline.resolve_device is resolve_device


def test_smpl_params_without_device_raise_when_cuda_absent(no_cuda):
    """The SMPL tables follow resolve_device too: no quiet CPU default."""
    from poserisk_release_tpu_torch.body.smpl import SMPLModel, synthetic_smpl_arrays
    from poserisk_release_tpu_torch.ops.lbs import smpl_params_to_torch

    model = SMPLModel.from_arrays(synthetic_smpl_arrays(seed=0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        smpl_params_to_torch(model)
    params = smpl_params_to_torch(model, device="cpu")
    assert {t.device.type for t in params.values()} == {"cpu"}


def test_cli_accepts_debug_frame(monkeypatch, tmp_path):
    """--debug_frame is in the port now: it reaches the Predictor."""
    from poserisk_release_tpu_torch import pipeline

    seen = {}

    class FakePredictor:
        def __init__(self, **kwargs):
            seen.update(kwargs)
            self.timings = {}

        def __call__(self, video, info, out):
            seen["called"] = (video, out)

    monkeypatch.setattr(pipeline, "Predictor", FakePredictor)
    video = str(tmp_path / "clip.mp4")
    assert cli.main(["--cpu", "--debug", "--debug_frame", "3", "--input", video,
                     "--output", str(tmp_path / "out")]) == 0
    assert seen["debug_frame"] == 3 and seen["debug"] and seen["device"] == "cpu"
    assert seen["called"] == (video, str(tmp_path / "out"))


def test_debug_frame_and_detector_weights_raise(tmp_path, monkeypatch):
    """What raised before the detector, mesh and int8 slices now runs:
    detector weights give the YOLOv3 detector with the config's settings,
    DETECTOR.int8 an int8 one awaiting calibration, and a Predictor takes
    debug_frame."""
    from poserisk_release_tpu_torch.models import detector
    from poserisk_release_tpu_torch.pipeline import build_detector

    weights = tmp_path / "yolov3.weights"
    weights.write_bytes(b"\0")
    cfg = default_config().replace(DETECTOR={
        "weights": str(weights), "img_size": 320, "detection_threshold": 0.3,
        "nms_threshold": 0.5, "batch_size": 4, "rect_letterbox": True,
        "max_device_dets": 32})
    loaded, params = [], detector.init_yolo_params(0)  # folding copies: one draw serves both

    def fake_load(path):
        loaded.append(path)
        return params

    monkeypatch.setattr(detector, "load_darknet_weights", fake_load)
    det = build_detector(cfg, "cpu")
    assert loaded == [str(weights)]
    assert isinstance(det, detector.YoloDetector) and det.model.folded
    assert (det.img_size, det.detection_threshold, det.nms_threshold, det.batch_size,
            det.rect, det.max_device_dets, det.device.type) == (
        320, 0.3, 0.5, 4, True, 32, "cpu")
    int8 = build_detector(cfg.replace(DETECTOR={"int8": True, "int8_min_downsample": 8}), "cpu")
    assert int8.int8 and int8.int8_min_downsample == 8 and int8.needs_calibration

    pred = Predictor(debug=True, debug_frame=0, device="cpu", detector=detector.StubDetector())
    assert pred.debug_frame == 0
