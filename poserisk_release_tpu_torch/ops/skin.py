"""Kernel K4 on Hopper: SMPL vertex skinning as a hand-written CUDA kernel.

Replaces skin_vertices_pallas (poserisk_release_tpu/ops/lbs_pallas.py:74):
shape blend + pose correctives + linear blend skinning of every vertex of
every frame in one pass over the big per-vertex tables. The CUDA source is
csrc/skin.cu (its header states the design and the bound); it builds with
nvcc at first use (_build.py) and is bound through ctypes. The plain version
is skin_vertices_plain below, the vertex part of ops/lbs._lbs_impl.

skin_vertices_cuda.launches counts the kernel launches of this process.
"""

from __future__ import annotations

import ctypes

import torch


def skin_vertices_plain(eff_betas, pose_map, affines, v_template, shapedirs, posedirs, weights):
    """The plain version of K4 on any device: (B, V, 3) vertices.

    eff_betas (B, 10) after the template fallback, pose_map (B, 9(J-1))
    rotmats minus identity, affines (B, J, 12) world [R | t] with the rest
    joint removed, v_template (V, 3), shapedirs (V*3, 10) and posedirs
    (V*3, 9(J-1)) with vertex-major rows, weights (V, J)."""
    B, V = eff_betas.shape[0], v_template.shape[0]
    v_shaped = v_template[None] + torch.matmul(eff_betas, shapedirs.T).reshape(B, V, 3)
    v_posed = v_shaped + torch.matmul(pose_map, posedirs.T).reshape(B, V, 3)
    M = torch.einsum("vj,bjk->bvk", weights, affines)
    Rv = M[..., :9].reshape(B, V, 3, 3)
    return torch.einsum("bvij,bvj->bvi", Rv, v_posed) + M[..., 9:]


def _lib():
    from poserisk_release_tpu_torch import _build

    lib = _build.load("skin")
    if lib.skin_vertices_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.skin_vertices_launch.argtypes = [p] * 8 + [i] * 5 + [p]
        lib.skin_vertices_launch.restype = ctypes.c_int
        lib.skin_error_string.argtypes = [ctypes.c_int]
        lib.skin_error_string.restype = ctypes.c_char_p
    return lib


def skin_vertices_cuda(eff_betas, pose_map, affines, v_template, shapedirs, posedirs, weights):
    """(B, V, 3) f32 vertices from K4, launched on the current stream. Every
    input must be a contiguous f32 CUDA tensor of the shapes
    skin_vertices_plain names; raises otherwise and on a refused launch."""
    B, NB = (int(s) for s in eff_betas.shape)
    V, J = (int(s) for s in weights.shape)
    P = int(pose_map.shape[1])
    shapes = {"eff_betas": (eff_betas, (B, NB)), "pose_map": (pose_map, (B, P)),
              "affines": (affines, (B, J, 12)), "v_template": (v_template, (V, 3)),
              "shapedirs": (shapedirs, (V * 3, NB)), "posedirs": (posedirs, (V * 3, P)),
              "weights": (weights, (V, J))}
    for name, (t, shape) in shapes.items():
        if t.device.type != "cuda" or t.device != eff_betas.device:
            raise ValueError(f"skin_vertices_cuda needs CUDA tensors, {name} is on {t.device}")
        if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 {shape}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    out = torch.empty((B, V, 3), dtype=torch.float32, device=eff_betas.device)
    if B == 0:
        return out
    lib = _lib()
    with torch.cuda.device(eff_betas.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.skin_vertices_launch(
            eff_betas.data_ptr(), pose_map.data_ptr(), affines.data_ptr(),
            v_template.data_ptr(), shapedirs.data_ptr(), posedirs.data_ptr(),
            weights.data_ptr(), out.data_ptr(), B, V, NB, P, J, stream)
    if code != 0:
        raise RuntimeError(f"skin kernel launch failed: {lib.skin_error_string(code).decode()}")
    skin_vertices_cuda.launches += 1
    return out


skin_vertices_cuda.launches = 0


def skin_vertices(eff_betas, pose_map, affines, v_template, shapedirs, posedirs, weights):
    """K4 on a CUDA device, its plain version on the CPU; any other device
    raises. There is no fallback from the kernel to the plain version."""
    args = (eff_betas, pose_map, affines, v_template, shapedirs, posedirs, weights)
    if eff_betas.device.type == "cuda":
        return skin_vertices_cuda(*(a.contiguous() for a in args))
    if eff_betas.device.type == "cpu":
        return skin_vertices_plain(*args)
    raise ValueError(f"skin_vertices has no path for device {eff_betas.device}")
