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
    mods = _port_modules()
    assert "poserisk_release_tpu_torch.ops.resample" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'poserisk_release_tpu' or m.startswith('poserisk_release_tpu.')]\n"
        "print(sorted(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


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
    ["--spin_int8"], ["--fast_detector"], ["--tp", "2"], ["--num_devices", "2"],
    ["--streaming"], ["--debug_frame", "3"], ["--calibration", "x.npz"],
])
def test_cli_rejects_later_slice_flags(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["--cpu"] + argv)
    assert exc.value.code == 2
    assert "ROADMAP" in capsys.readouterr().err


def test_debug_frame_and_detector_weights_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="K4"):
        Predictor(debug=True, debug_frame=0, device="cpu")
    weights = tmp_path / "yolov3.weights"
    weights.write_bytes(b"\0")
    cfg = default_config().replace(DETECTOR={"weights": str(weights)})
    from poserisk_release_tpu_torch.pipeline import build_detector

    with pytest.raises(NotImplementedError, match="YOLOv3"):
        build_detector(cfg)
