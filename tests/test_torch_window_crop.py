"""Kernel K3, the windowed crop: guard, plain version, dispatch and kernel.

The plain version (ops/crop.crop_batch_windowed_plain) is held against the
JAX package's crop_batch_pallas_windowed in Pallas interpret mode (f32) on
the boxes of tests/test_resample_pallas.py, inside crop_window_fits, and on
the lossy box of its regression test at window 256, where both drop the
same tap (> 0.1 from the full crop).

Tolerance: as for K1 (tests/test_torch_crop.py), the JAX sample positions
are not the correctly rounded ones (XLA's f32 division on the CPU), which
moves a crop value by the position error times the image gradient. On
these larger boxes (steps up to 2 px) the port's K1 itself lies 2.5e-5
(smooth content) and 6.3e-5 (pixel noise) from the JAX K1, while the JAX
windowed kernel lies within 1.8e-7 of the JAX K1: so the windowed crop is
held to the K1 class at these boxes, 5e-5 on smooth content and 1.25e-4 on
noise. Inside the guard the plain version equals K1's bit for bit.

The CUDA kernel runs only on a card; its comparisons are marked `cuda` and
skip here:

    python -m pytest tests/test_torch_window_crop.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from poserisk_release_tpu_torch.ops.crop import (
    crop_batch,
    crop_batch_plain,
    crop_batch_windowed,
    crop_batch_windowed_plain,
    crop_window_fits,
)
from poserisk_release_tpu_torch.ops.resample import (
    crop_batch_cuda,
    crop_batch_multi_cuda,
    crop_batch_windowed_cuda,
)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

FIT_BOXES = np.array([[400.0, 225.0, 200.0, 380.0], [60.0, 200.0, 180.0, 300.0],
                      [770.0, 225.0, 190.0, 400.0], [420.0, 100.0, 150.0, 150.0]], np.float32)
LOSSY_BOX = np.array([[192.4, 225.0, 127.0 / 1.2, 300.0]], np.float32)


def _noise(n, seed=13, hw=(450, 800)):
    return np.random.RandomState(seed).randint(0, 256, (n,) + hw + (3,)).astype(np.uint8)


def _smooth(n, seed=13, hw=(450, 800)):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]].astype(np.float64)
    out = []
    for _ in range(n):
        fx, fy, ph = rng.uniform(20, 60), rng.uniform(20, 60), rng.uniform(0, 6, 3)
        img = np.stack([128 + 100 * np.sin(xx / fx + ph[c]) * np.cos(yy / fy - ph[c])
                        for c in range(3)], axis=-1)
        out.append(np.round(img).astype(np.uint8))
    return np.stack(out)


def _jax_windowed(frames, boxes, window):
    import jax.numpy as jnp

    from poserisk_release_tpu.ops.resample_pallas import crop_batch_pallas_windowed

    return np.asarray(crop_batch_pallas_windowed(
        jnp.asarray(frames), jnp.asarray(boxes), window=window, compute_dtype=jnp.float32,
        interpret=True))


@pytest.mark.parametrize("content, atol", [("smooth", 5e-5), ("noise", 1.25e-4)])
def test_plain_matches_jax_inside_the_guard(content, atol):
    frames = (_smooth if content == "smooth" else _noise)(4)
    assert crop_window_fits(FIT_BOXES, window=384)
    got = crop_batch_windowed(torch.as_tensor(frames), torch.as_tensor(FIT_BOXES), window=384,
                              out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, _jax_windowed(frames, FIT_BOXES, 384), rtol=0, atol=atol)
    # Inside the guard no tap is dropped: K1's plain version, bit for bit.
    full = crop_batch_plain(torch.as_tensor(frames), torch.as_tensor(FIT_BOXES)).numpy()
    np.testing.assert_array_equal(got, full)


def test_lossy_window_reproduces_jax():
    """Outside the guard the windowed crop loses the same tap as the JAX
    kernel: it reproduces the loss, it does not repair it."""
    frames = np.random.default_rng(5).integers(0, 256, (1, 450, 800, 3), dtype=np.uint8)
    assert not crop_window_fits(LOSSY_BOX, window=256)
    got = crop_batch_windowed(torch.as_tensor(frames), torch.as_tensor(LOSSY_BOX), window=256,
                              out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, _jax_windowed(frames, LOSSY_BOX, 256), rtol=0,
                               atol=1.25e-4)
    full = crop_batch_plain(torch.as_tensor(frames), torch.as_tensor(LOSSY_BOX)).numpy()
    assert np.abs(got - full).max() > 0.1
    assert crop_window_fits(LOSSY_BOX, window=384)
    exact = crop_batch_windowed(torch.as_tensor(frames), torch.as_tensor(LOSSY_BOX),
                                window=384, out_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(exact, full)


@pytest.mark.parametrize("boxes, window", [
    (np.array([[400.0, 225.0, 220.0, 300.0]], np.float32), 384),
    (np.array([[400.0, 225.0, 220.0, 300.0]], np.float32), 512),
    (np.zeros((0, 4), np.float32), 384),
    (LOSSY_BOX, 256), (LOSSY_BOX, 384), (FIT_BOXES, 384), (FIT_BOXES, 256),
])
def test_crop_window_fits_matches_jax(boxes, window):
    from poserisk_release_tpu.ops.resample_pallas import crop_window_fits as jax_fits

    assert crop_window_fits(boxes, window=window) == jax_fits(boxes, window=window)


def test_whole_width_window_is_the_full_crop():
    frames = torch.as_tensor(_noise(2, seed=5, hw=(128, 256)))
    boxes = torch.as_tensor(np.array([[128.0, 64.0, 80.0, 90.0], [40.0, 30.0, 50.0, 60.0]],
                                     np.float32))
    got = crop_batch_windowed(frames, boxes, window=256, out_dtype=torch.float32)
    torch.testing.assert_close(got, crop_batch(frames, boxes), rtol=0, atol=0)
    with pytest.raises(ValueError, match="multiple of 128"):
        crop_batch_windowed(frames, boxes, window=200)


def test_dispatch_on_cpu_is_the_plain_version_and_kernel_refuses_cpu():
    frames = torch.as_tensor(_noise(2, seed=4))
    boxes = torch.as_tensor(FIT_BOXES[:2])
    torch.testing.assert_close(crop_batch_windowed(frames, boxes),
                               crop_batch_windowed_plain(frames, boxes), rtol=0, atol=0)
    before = crop_batch_windowed_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        crop_batch_windowed_cuda(frames, boxes)
    assert crop_batch_windowed_cuda.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the windowed crop kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window, boxes", [(384, FIT_BOXES), (256, LOSSY_BOX), (512, FIT_BOXES)])
def test_kernel_matches_plain_version(cuda_device, out_dtype, window, boxes):
    frames = torch.as_tensor(_noise(len(boxes)), device=cuda_device)
    bb = torch.as_tensor(boxes, device=cuda_device)
    before = crop_batch_windowed_cuda.launches
    got = crop_batch_windowed(frames, bb, window=window, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert crop_batch_windowed_cuda.launches == before + 1
    want = crop_batch_windowed_plain(frames, bb, window=window, out_dtype=out_dtype)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    if crop_window_fits(boxes, window=window):
        torch.testing.assert_close(got, crop_batch(frames, bb, out_dtype=out_dtype), rtol=0,
                                   atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fpb", [2, 4])
def test_frames_per_block_probe_equals_k1(cuda_device, fpb, out_dtype):
    """K1m, the frames-per-block probe: bit-equal to the plain crop and to K1."""
    frames = torch.as_tensor(_noise(4), device=cuda_device)
    bb = torch.as_tensor(FIT_BOXES, device=cuda_device)
    before = crop_batch_multi_cuda.launches
    got = crop_batch_multi_cuda(frames, bb, fpb, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert crop_batch_multi_cuda.launches == before + 1
    torch.testing.assert_close(got, crop_batch_plain(frames, bb, out_dtype=out_dtype), rtol=0,
                               atol=0)
    torch.testing.assert_close(got, crop_batch_cuda(frames, bb, out_dtype=out_dtype), rtol=0,
                               atol=0)


def test_frames_per_block_probe_refuses_cpu():
    frames = torch.as_tensor(_noise(2, seed=4, hw=(64, 96)))
    boxes = torch.as_tensor(np.tile(np.array([[48.0, 32.0, 40.0, 50.0]], np.float32), (2, 1)))
    before = crop_batch_multi_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        crop_batch_multi_cuda(frames, boxes, 2)
    assert crop_batch_multi_cuda.launches == before
