"""The weight bridges between the JAX package's trees and the port.

SPIN below; the YOLOv3 detector's BN fold and params bridge at the end.

The port's HMR (models/spin.py) carries nkolot/SPIN's module names, so a
torch checkpoint loads into it directly. The JAX package keeps SPIN weights
as a Flax variables tree and caches converted checkpoints as a flattened
`.flax.npz` (with a source stamp of the checkpoint it came from). This
module converts between the two, in both directions, and reads and writes
that cache format itself (own copy of the flatten/unflatten/stamp helpers),
so either package can reuse a cache the other wrote.

Layout rules (torch <-> flax):
  conv   (O, I, kh, kw)              <-> kernel (kh, kw, I, O)
  linear (O, I)                      <-> kernel (I, O)
  batchnorm weight / bias            <-> params .../scale, .../bias
  batchnorm running_mean / var       <-> batch_stats .../mean, .../var
  conv1, bn1                         <-> backbone/conv1, backbone/bn1
  layer{s}.{i}.conv{k} / bn{k}       <-> backbone/layer{s}_{i}/conv{k}, bn{k}
  layer{s}.{i}.downsample.0 / .1     <-> backbone/layer{s}_{i}/downsample_conv, _bn
  fc1, fc2, decpose, decshape, deccam <-> same names at the top level
  init_pose / init_shape / init_cam buffers <-> top-level params
"""

from __future__ import annotations

import os
import re
from typing import Dict, Mapping

import numpy as np
import torch


def _to_np(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _set(tree: Dict, path: tuple, value) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = np.asarray(value, np.float32)


_HEADS = ("fc1", "fc2", "decpose", "decshape", "deccam")
_TORCH_SUB = {"downsample.0": "downsample_conv", "downsample.1": "downsample_bn"}
_FLAX_SUB = {v: k for k, v in _TORCH_SUB.items()}
_BN_FLAX = {"weight": ("params", "scale"), "bias": ("params", "bias"),
            "running_mean": ("batch_stats", "mean"),
            "running_var": ("batch_stats", "var")}
_BN_TORCH = {"scale": "weight", "bias": "bias", "mean": "running_mean",
             "var": "running_var"}


def _flax_module_path(module: str):
    """torch module path -> flax module path (tuple), or None if unknown."""
    if module in ("conv1", "bn1"):
        return ("backbone", module)
    if module in _HEADS:
        return (module,)
    m = re.fullmatch(r"layer(\d+)\.(\d+)\.(conv\d|bn\d|downsample\.[01])", module)
    if m:
        return ("backbone", f"layer{m.group(1)}_{m.group(2)}",
                _TORCH_SUB.get(m.group(3), m.group(3)))
    return None


def _torch_module_path(path) -> str:
    """flax module path (without the leaf) -> torch module path."""
    path = list(path[1:] if path[0] == "backbone" else path)
    m = re.fullmatch(r"layer(\d+)_(\d+)", path[0])
    if m:
        path = [f"layer{m.group(1)}.{m.group(2)}"] + [_FLAX_SUB.get(p, p) for p in path[1:]]
    return ".".join(path)


def spin_state_dict_to_flax(state: Mapping[str, object]) -> Dict:
    """SPIN hmr state_dict (tensor or ndarray values) -> Flax variables
    {'params': ..., 'batch_stats': ...}. A 'module.' prefix (DataParallel
    checkpoints) is stripped; unknown keys (num_batches_tracked, a bundled
    smpl sub-module, ...) are dropped, mirroring the reference's
    strict=False load."""
    variables: Dict = {"params": {}, "batch_stats": {}}
    for key, raw in state.items():
        if key.startswith("module."):
            key = key[len("module."):]
        value = _to_np(raw)
        if key in ("init_pose", "init_shape", "init_cam"):
            _set(variables["params"], (key,), value.reshape(1, -1))
            continue
        module, _, leaf = key.rpartition(".")
        path = _flax_module_path(module)
        if path is None:
            continue
        if path[-1].startswith("bn") or path[-1] == "downsample_bn":
            if leaf in _BN_FLAX:
                coll, name = _BN_FLAX[leaf]
                _set(variables[coll], path + (name,), value)
        elif leaf == "weight" and value.ndim == 4:
            _set(variables["params"], path + ("kernel",), np.transpose(value, (2, 3, 1, 0)))
        elif leaf == "weight" and value.ndim == 2:
            _set(variables["params"], path + ("kernel",), value.T)
        elif leaf == "bias":
            _set(variables["params"], path + ("bias",), value)
    return variables


def flax_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Flax SPIN variables (numpy or array-like leaves) -> the port's HMR
    state_dict: kernels HWIO -> OIHW, Dense (in, out) -> (out, in), BN
    scale/bias/mean/var -> weight/bias/running_mean/running_var, init_* as
    buffers, plus the num_batches_tracked counters torch's BatchNorm keeps,
    so HMR.load_state_dict(strict=True) takes it."""
    flat = flatten_tree(dict(variables))
    state: Dict[str, torch.Tensor] = {}
    bn_modules = set()
    for key, value in flat.items():
        coll, *path = key.split("/")
        value = np.asarray(value, np.float32)
        if path[-1] in ("init_pose", "init_shape", "init_cam"):
            state[path[-1]] = torch.from_numpy(value.reshape(1, -1).copy())
            continue
        module, leaf = _torch_module_path(path[:-1]), path[-1]
        if leaf == "kernel":
            value = np.transpose(value, (3, 2, 0, 1)) if value.ndim == 4 else value.T
            name = "weight"
        else:
            name = _BN_TORCH[leaf]
            if leaf != "bias" or coll == "batch_stats":
                bn_modules.add(module)
        state[f"{module}.{name}"] = torch.from_numpy(np.array(value))
    for module in sorted(bn_modules):
        state[f"{module}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return state


def load_spin_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """torch.load a SPIN checkpoint ({'model': state_dict} as SPIN saves it,
    or a bare state_dict) and return its state_dict."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    return blob.get("model", blob) if isinstance(blob, dict) else blob


def flatten_tree(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> flat {'a/b/c': ndarray} mapping (npz layout)."""
    flat: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(flatten_tree(dict(value), path))
        else:
            flat[path] = np.asarray(value)
    return flat


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for key, value in flat.items():
        _set(tree, tuple(key.split("/")), value)
    return tree


_SOURCE_STAMP_KEY = "__source_stamp__"


def source_stamp(path: str) -> np.ndarray:
    """(size_bytes, mtime_ns) identity of a converted checkpoint, stored
    INSIDE the npz cache, so a replacement checkpoint installed with a
    timestamp-preserving tool (cp -p, rsync -a, tar) is still noticed."""
    st = os.stat(path)
    return np.asarray([st.st_size, st.st_mtime_ns], np.int64)


def save_flax_variables(variables: Dict, path: str, source: str | None = None) -> None:
    """Flatten-and-save Flax-layout variables to npz; `source` is the
    checkpoint they came from, whose source_stamp is embedded."""
    flat = flatten_tree(variables)
    if source is not None:
        flat[_SOURCE_STAMP_KEY] = source_stamp(source)
    np.savez(path, **flat)


def load_flax_variables(path: str) -> Dict:
    with np.load(path) as data:
        return unflatten_tree({key: data[key] for key in data.files
                               if key != _SOURCE_STAMP_KEY})


def cached_source_stamp(path: str) -> np.ndarray | None:
    """The source_stamp stored in an npz cache, or None for caches written
    without one."""
    with np.load(path) as data:
        if _SOURCE_STAMP_KEY in data.files:
            return data[_SOURCE_STAMP_KEY]
    return None


# ---------------------------------------------------------------------------
# YOLOv3: the BN fold and the bridge to the JAX package's params tree.
#
# The port keeps detector weights as the YoloV3 module's state_dict
# (models/detector.py): conv_{i}.conv.weight OIHW, conv_{i}.conv.bias, and
# for unfolded layers conv_{i}.bn.{weight,bias,running_mean,running_var}.
# The JAX package keeps {conv_{i}: {kernel HWIO, folded_bias_leaky |
# conv_bias | scale, bias, mean, var}}; whether a bias is followed by leaky
# ReLU is the spec's batch_norm flag on both sides.
# ---------------------------------------------------------------------------
BN_EPS = 1e-5  # torch BatchNorm default; both conv towers use it
_YOLO_BN = {"scale": "bn.weight", "bias": "bn.bias", "mean": "bn.running_mean",
            "var": "bn.running_var"}
_YOLO_BN_INV = {v: k for k, v in _YOLO_BN.items()}


def fold_bn_kernel_bias(kernel, bn_scale, bn_bias, bn_mean, bn_var, eps: float = BN_EPS):
    """Eval-mode BN fold, host-side f32: kernel' = kernel * gamma/sqrt(var+
    eps) per output channel, bias' = beta - mean * that scale. kernel is OIHW
    (torch); the arithmetic is the JAX package's, element for element."""
    inv = 1.0 / np.sqrt(np.asarray(bn_var, np.float32) + eps)
    mul = inv * np.asarray(bn_scale, np.float32)
    bias = np.asarray(bn_bias, np.float32) - np.asarray(bn_mean, np.float32) * mul
    return np.asarray(kernel, np.float32) * mul[:, None, None, None], bias


_YOLO_INT8 = ("qkernel", "w_scale", "in_scale", "q_bias_leaky", "out_scale")


def yolo_params_to_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """The JAX package's YOLO params (numpy or array-like leaves: unfolded
    BN, fold_bn_params' folded_bias_leaky / conv_bias, or
    quantize_yolo_params' int8 layers) -> the port's YoloV3 state_dict,
    numpy. Float leaves are f32; int8 layers keep their names and the HWIO
    int8 qkernel under the conv's prefix (conv_{i}.qkernel, ...)."""
    sd: Dict[str, np.ndarray] = {}
    for name, layer in params.items():
        for key, value in layer.items():
            value = _to_np(value)
            if key == "qkernel":
                sd[f"{name}.qkernel"] = np.asarray(value, np.int8)
                continue
            value = np.asarray(value, np.float32)
            if key == "kernel":
                sd[f"{name}.conv.weight"] = np.ascontiguousarray(np.transpose(value, (3, 2, 0, 1)))
            elif key in ("folded_bias_leaky", "conv_bias"):
                sd[f"{name}.conv.bias"] = value
            elif key in _YOLO_BN:
                sd[f"{name}.{_YOLO_BN[key]}"] = value
            elif key in _YOLO_INT8:
                sd[f"{name}.{key}"] = value
            else:
                raise KeyError(f"{name}/{key} is not a YOLO parameter")
    return sd


def state_dict_to_yolo_params(sd: Mapping) -> Dict[str, Dict[str, np.ndarray]]:
    """The inverse of yolo_params_to_state_dict: a YoloV3 state_dict (float
    or int8) -> the JAX package's params tree (kernels HWIO), numpy."""
    from poserisk_release_tpu_torch.models.detector import YOLOV3_SPEC

    params: Dict[str, Dict[str, np.ndarray]] = {}
    for key, value in sd.items():
        name, rest = key.split(".", 1)
        if rest.endswith("num_batches_tracked"):
            continue
        layer = params.setdefault(name, {})
        value = _to_np(value)
        if rest == "qkernel":
            layer[rest] = np.asarray(value, np.int8)
            continue
        value = np.asarray(value, np.float32)
        if rest == "conv.weight":
            layer["kernel"] = np.ascontiguousarray(np.transpose(value, (2, 3, 1, 0)))
        elif rest == "conv.bias":
            leaky = YOLOV3_SPEC[int(name.split("_")[1])][4]
            layer["folded_bias_leaky" if leaky else "conv_bias"] = value
        elif rest in _YOLO_INT8:
            layer[rest] = value
        else:
            layer[_YOLO_BN_INV[rest]] = value
    return params


# ---------------------------------------------------------------------------
# SPIN's folded / int8 ResNet-50 (models/resnet_int8.py). The port keeps the
# JAX package's flat dict: {conv name: {kernel HWIO, bias}} folded, or
# {qkernel HWIO int8, w_scale, in_scale, bias} quantized, with the same conv
# names (conv1, layer{s}_{b}.conv{k}, layer{s}_{b}.downsample).
# ---------------------------------------------------------------------------
_RESNET_KEYS = {"kernel": np.float32, "bias": np.float32, "qkernel": np.int8,
                "w_scale": np.float32, "in_scale": np.float32}


def resnet_params_from_jax(params: Mapping) -> Dict[str, Dict[str, np.ndarray]]:
    """The JAX package's fold_resnet50_params / quantize_resnet50 dict
    (numpy or array-like leaves) -> the port's (numpy, the same names and
    layouts). Raises on an unknown leaf."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for name, layer in params.items():
        out[name] = {}
        for key, value in layer.items():
            if key not in _RESNET_KEYS:
                raise KeyError(f"{name}/{key} is not a folded or int8 ResNet parameter")
            out[name][key] = np.asarray(_to_np(value), _RESNET_KEYS[key])
    return out
