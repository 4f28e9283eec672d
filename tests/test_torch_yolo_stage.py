"""Kernel K5, the fused int8 residual stage: pack, plain version and kernel.

The plain version (ops/yolo_stage.fused_residual_stage_plain) is held
against the JAX package's fused_residual_stage in Pallas interpret mode on
the C256 stage (spec index 13, 8 blocks) at (2, 6, 8, 256), with the
quantized params of the seed-0 detector calibrated on seeded frames, handed
to the port through the weight bridge. The JAX test holds the kernel to
atol 1e-4 against its f32-stream conv chain; the port's plain version takes
the int32 sums exactly and every f32 operation in the kernel's order, and
measures 0 against the interpret-mode kernel, so the same 1e-4 is a loose
bound here. pack_yolo_stage is exact: the same host arithmetic.

The CUDA kernel runs only on a card; its comparison with the plain version
(bit-equal) is marked `cuda` and skips here. The JAX package is imported
only by the tests that use it, so on a card's machine without jax:

    python -m pytest tests/test_torch_yolo_stage.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from poserisk_release_tpu_torch.ops.yolo_stage import (
    fused_residual_stage,
    fused_residual_stage_cuda,
    fused_residual_stage_plain,
    pack_yolo_stage,
)

STAGE_START, STAGE_BLOCKS = 13, 8


def _frames():
    return np.random.RandomState(3).randint(0, 200, (2, 53, 80, 3)).astype(np.uint8)


def _stream(shape=(2, 6, 8, 256), seed=0):
    return np.random.RandomState(seed).uniform(-0.5, 2.0, shape).astype(np.float32)


@pytest.fixture(scope="module")
def jax_qparams():
    import jax
    import jax.numpy as jnp

    from poserisk_release_tpu.models import detector as jd
    from poserisk_release_tpu.ops.crop import letterbox_device_rect

    folded = jd.fold_bn_params(jd.init_yolo_params(seed=0))
    letter = letterbox_device_rect(jnp.asarray(_frames()), 96)
    qp = jd.quantize_yolo_params(folded, jd.calibrate_yolo_activations(folded, letter))
    return jax.tree_util.tree_map(np.asarray, qp)


@pytest.fixture(scope="module")
def port_qparams(jax_qparams):
    from poserisk_release_tpu_torch.models.convert import yolo_params_to_state_dict

    return yolo_params_to_state_dict(jax_qparams)


def test_pack_matches_jax_exactly(jax_qparams, port_qparams):
    from poserisk_release_tpu.ops.yolo_stage_pallas import pack_yolo_stage as jax_pack

    want = jax_pack(jax_qparams, STAGE_START, STAGE_BLOCKS)
    got = pack_yolo_stage(port_qparams, STAGE_START, STAGE_BLOCKS)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_pack_shapes(port_qparams):
    pack = pack_yolo_stage(port_qparams, STAGE_START, STAGE_BLOCKS)
    n, C, half = STAGE_BLOCKS, 256, 128
    assert pack["qk1"].shape == (n, C, half) and pack["qk3"].shape == (n, 9 * half, C)
    assert pack["qk1"].dtype == np.int8 and pack["qk3"].dtype == np.int8
    assert pack["d1"].shape == (n, 1, half) and pack["b3"].shape == (n, 1, C)
    assert pack["inv_s"].shape == (n, 2) and pack["inv_s"].dtype == np.float32


def test_pack_requires_quantized_tower():
    from poserisk_release_tpu_torch.models.detector import fold_bn_params, init_yolo_params

    with pytest.raises(ValueError, match="whole-tower int8"):
        pack_yolo_stage(fold_bn_params(init_yolo_params(0)), STAGE_START, STAGE_BLOCKS)


def test_plain_matches_jax_interpret_kernel(jax_qparams, port_qparams):
    import jax.numpy as jnp

    from poserisk_release_tpu.ops.yolo_stage_pallas import fused_residual_stage as jax_stage
    from poserisk_release_tpu.ops.yolo_stage_pallas import pack_yolo_stage as jax_pack

    h = _stream()
    want = np.asarray(jax_stage(jnp.asarray(h), jax_pack(jax_qparams, STAGE_START, STAGE_BLOCKS),
                                STAGE_BLOCKS, interpret=True))
    pack = pack_yolo_stage(port_qparams, STAGE_START, STAGE_BLOCKS)
    got = fused_residual_stage(torch.as_tensor(h), pack, STAGE_BLOCKS).numpy()
    assert got.shape == want.shape == (2, 6, 8, 256)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_preserves_input_dtype_and_refuses_cpu_launch(port_qparams, dtype):
    pack = pack_yolo_stage(port_qparams, STAGE_START, STAGE_BLOCKS)
    h = torch.zeros((1, 6, 8, 256), dtype=dtype)
    assert fused_residual_stage(h, pack, STAGE_BLOCKS).dtype == dtype
    before = fused_residual_stage_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        fused_residual_stage_cuda(h, pack, STAGE_BLOCKS)
    assert fused_residual_stage_cuda.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused stage kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("blocks", [1, STAGE_BLOCKS])
def test_kernel_matches_plain_version(cuda_device, dtype, blocks):
    """Bit-equal: integer sums are exact on both sides and every float
    operation is rounded once, in the same order. The quantized params come
    from the port alone (the seed-0 init calibrated on the card)."""
    from poserisk_release_tpu_torch.tools.exp_fused_stage import calibrated_qparams

    qparams = calibrated_qparams(_frames(), cuda_device)
    pack = pack_yolo_stage(qparams, STAGE_START, blocks)
    h = torch.as_tensor(_stream((3, 7, 9, 256), seed=1), device=cuda_device).to(dtype)
    before = fused_residual_stage_cuda.launches
    got = fused_residual_stage(h, pack, blocks)
    torch.cuda.synchronize()
    assert fused_residual_stage_cuda.launches == before + 2 * blocks
    want = fused_residual_stage_plain(h, pack, blocks)
    assert got.dtype == dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)
