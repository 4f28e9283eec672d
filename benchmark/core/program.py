"""The system under test, built from a configuration file and the seeded weights.

Only this module and the runners import the program
(poserisk_release_tpu_torch). It builds the objects each cell's window
drives, as the program's own entry points build them: the YOLOv3 detector
from darknet weights with BatchNorm folded at load (what
YoloDetector.from_weights does), the strict f32 PoseEstimator over the
neutral SMPL model, the REBA/RULA scorers, and the scoring server.
"""

from __future__ import annotations

import json
import os
import os.path as osp
from typing import Dict

import numpy as np

from benchmark.core import weights
from benchmark.core.harness import BENCH_DIR, WORK_DIR


def info(config: Dict) -> Dict:
    with open(osp.join(BENCH_DIR, "data", config["info"])) as f:
        return json.load(f)


def smpl_dir(seed: int) -> str:
    """Writes the seed's neutral SMPL model where the program's SMPLFamily
    looks for it; one fixed directory, rewritten by every run."""
    path = osp.join(WORK_DIR, "smpl")
    os.makedirs(path, exist_ok=True)
    tmp = osp.join(path, "SMPL_NEUTRAL.tmp.npz")
    np.savez_compressed(tmp, **weights.smpl_arrays(seed))
    os.replace(tmp, osp.join(path, "SMPL_NEUTRAL.npz"))
    return path


def port_config(config: Dict, smpl_path: str, chunk: int):
    from poserisk_release_tpu_torch.config import default_config

    return default_config().replace(
        SPIN={"smpl_model_dir": smpl_path, "ief_iters": int(config["regressor"]["ief_iters"]),
              "pose_stride": 1},
        DATASET={"bbox_scale": float(config["bbox_scale"])},
        MODEL={"input_shape": (int(config["crop_size"]), int(config["crop_size"]))},
        PARALLEL={"frames_per_step": int(chunk)})


def pose_estimator(config: Dict, hmr_params, smpl_path: str, chunk: int, device):
    from poserisk_release_tpu_torch.body.smpl import SMPLFamily
    from poserisk_release_tpu_torch.pipeline import PoseEstimator

    cfg = port_config(config, smpl_path, chunk)
    return PoseEstimator(cfg, SMPLFamily(smpl_path), variables=hmr_params, device=device)


def detector(config: Dict, yolo_params, device, img_size=None):
    from poserisk_release_tpu_torch.models.detector import YoloDetector, fold_bn_params

    d = config["detector"]
    host = {k: v.detach().cpu().numpy() for k, v in yolo_params.items()}
    return YoloDetector(params=fold_bn_params(host), img_size=img_size or int(d["img_size"]),
                        detection_threshold=float(d["threshold"]),
                        nms_threshold=float(d["nms_threshold"]), batch_size=int(d["batch_size"]),
                        rect=bool(d["rect"]), max_device_dets=int(d["max_device_dets"]),
                        device=device)


def scorers(device):
    from poserisk_release_tpu_torch.scoring.reba import REBAScorer
    from poserisk_release_tpu_torch.scoring.rula import RULAScorer

    return REBAScorer(device=device), RULAScorer(device=device)


def server(config: Dict, mix: Dict, hmr_params, smpl_path: str, add_info: Dict, device):
    from poserisk_release_tpu_torch.serving import PoseScoringServer

    cfg = port_config(config, smpl_path, int(mix["buckets"][-1]))
    return PoseScoringServer(cfg, add_info=add_info, batch_sizes=tuple(mix["buckets"]),
                             max_delay_ms=float(mix["max_delay_ms"]),
                             frame_hw=tuple(mix["frame_hw"]), spin_variables=hmr_params,
                             warm=True, device=device)
