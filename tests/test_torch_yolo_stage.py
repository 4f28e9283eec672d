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

The CUDA kernel runs only on a card; its comparisons with the plain version
(bit-equal at every stage width, on ragged and full stage shapes, in bf16
and f32, at one block and the stage's full count) are marked `cuda` and
skip here. The JAX package is imported
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
from poserisk_release_tpu_torch.tools.exp_fused_stage import STAGE_GEOM, stage_bound, stage_floor
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

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


def test_stage_floor_and_bound_at_batch_64():
    """The design's byte floor per stage (the bf16 input read twice and the
    output written once, the f32 stream between blocks, q written and read
    once a block, aq once: 82 bytes an element over 8 blocks; the weights
    once) and the operations bound, at the rect canvas, B = 64. The floor
    is never below the bound, at B = 64 or B = 1."""
    floors = {c: stage_floor(64, h, w, c, n, 2) for c, (_, n, h, w) in STAGE_GEOM.items()}
    assert floors[256][1] == floors[512][1] == "bytes" and floors[1024][1] == "operations"
    m_c, weights = 64 * 36 * 52 * 256, 8 * (5 * 256 * 256 + 12 * 256 + 8)
    np.testing.assert_allclose(floors[256][0], (82 * m_c + weights) / 3.35e12 * 1e3, rtol=1e-9)
    np.testing.assert_allclose([floors[c][0] for c in (256, 512, 1024)],
                               [0.7515, 0.3785, 0.1587], rtol=1e-3)
    bound = sum(stage_bound(64, h, w, c, n, 2)[0] for c, (_, n, h, w) in STAGE_GEOM.items())
    np.testing.assert_allclose(bound, 0.794, rtol=1e-3)
    for c, (_, n, h, w) in STAGE_GEOM.items():
        for b in (1, 64):
            assert stage_floor(b, h, w, c, n, 2)[0] >= stage_bound(b, h, w, c, n, 2)[0]


@pytest.fixture(scope="module")
def card_qparams():
    """The seed-0 detector calibrated on the card, quantized whole tower."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused stage kernel has no CPU mode")
    from poserisk_release_tpu_torch.tools.exp_fused_stage import calibrated_qparams

    return calibrated_qparams(_frames(), torch.device("cuda"))


# Per stage width: a small shape whose M = B*H*W is a multiple of no tile,
# and the stage's own H x W on the rect canvas at B = 2.
STAGE_SHAPES = [(3, 7, 9, 256), (2, 36, 52, 256), (2, 5, 7, 512), (2, 18, 26, 512),
                (1, 3, 5, 1024), (2, 9, 13, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("full", [False, True], ids=["1block", "allblocks"])
@pytest.mark.parametrize("shape", STAGE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain_version(card_qparams, shape, full, dtype):
    """Bit-equal: integer sums are exact on both sides and every float
    operation is rounded once, in the same order. The quantized params come
    from the port alone (the seed-0 init calibrated on the card), with the
    stage's spec start from STAGE_GEOM; one block or the stage's count."""
    C = shape[-1]
    start, n, _, _ = STAGE_GEOM[C]
    blocks = n if full else 1
    pack = pack_yolo_stage(card_qparams, start, blocks)
    h = torch.as_tensor(_stream(shape, seed=C), device="cuda").to(dtype)
    before = fused_residual_stage_cuda.launches
    got = fused_residual_stage(h, pack, blocks)
    torch.cuda.synchronize()
    # The quantize launch of the first block's q, then the 1x1 and the 3x3
    # of each block.
    assert fused_residual_stage_cuda.launches == before + 2 * blocks + 1
    want = fused_residual_stage_plain(h, pack, blocks)
    assert got.dtype == dtype and got.shape == h.shape
    torch.testing.assert_close(got, want, rtol=0, atol=0)

