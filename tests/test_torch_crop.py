"""The crop of the pose path: plain version, dispatch, and kernel K1.

The plain version (ops/crop.crop_batch_plain) is held against the JAX
package's crop_batch (the strict path's crop) and crop_batch_pallas in
interpret mode (K1, the TPU kernel), on the boxes of
tests/test_resample_pallas.py: centred, small off-centre, straddling the
right/bottom border, and partly outside the frame.

Tolerance, and why there are two: the port evaluates the sample positions
(dst - out/2) * (size * scale / out) + centre in f32 with every operation
correctly rounded. XLA's f32 division on the CPU is not correctly rounded
(it misses the IEEE quotient for most box sizes), so the JAX crops sample
up to 2 ulp away -- 1.22e-4 px for coordinates below 1024. The crop value
moves by that distance times the local image gradient: on smooth content
(gradients of a few grey levels per pixel) the two agree within 1e-5, the
bound tests/test_resample_pallas.py holds K1 to; on pixel noise (gradients
up to 255 grey levels, one full scale, per pixel) within 1.25e-4.
Against an exact float64 bilinear oracle the plain version agrees to 1e-6.

The kernel itself runs only on a CUDA card: its comparison with the plain
version is marked `cuda` and skips here. The JAX package is imported only
by the tests that use it, so on a card's machine without jax the kernel
cases run alone:

    python -m pytest tests/test_torch_crop.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from poserisk_release_tpu_torch.ops.crop import crop_batch, crop_batch_plain
from poserisk_release_tpu_torch.ops.resample import crop_batch_cuda
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

BBOXES = np.array(
    [
        [400.0, 225.0, 220.0, 220.0],
        [100.0, 80.0, 60.0, 120.0],
        [780.0, 440.0, 100.0, 50.0],
        [-20.0, 10.0, 80.0, 80.0],
    ],
    np.float32,
)


def _noise_frames(n, hw=(450, 800), seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n,) + hw + (3,)).astype(np.uint8)


def _smooth_frames(n, hw=(450, 800), seed=0):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]].astype(np.float64)
    out = []
    for _ in range(n):
        fx, fy, ph = rng.uniform(20, 60), rng.uniform(20, 60), rng.uniform(0, 6, 3)
        img = np.stack([128 + 100 * np.sin(xx / fx + ph[c]) * np.cos(yy / fy - ph[c])
                        for c in range(3)], axis=-1)
        out.append(np.round(img).astype(np.uint8))
    return np.stack(out)


def _jax_crops(frames, bboxes):
    import jax.numpy as jnp

    from poserisk_release_tpu.ops.crop import crop_batch as jax_crop_batch
    from poserisk_release_tpu.ops.resample_pallas import crop_batch_pallas

    f, b = jnp.asarray(frames), jnp.asarray(bboxes)
    return (np.asarray(jax_crop_batch(f, b)),
            np.asarray(crop_batch_pallas(f, b, compute_dtype=jnp.float32, interpret=True)))


def _oracle(frames, bboxes, scale=1.2, out=224):
    """Exact float64 bilinear sampling with the port's f32 sample positions."""
    from poserisk_release_tpu_torch.ops.crop import crop_coords

    ys, xs = (c.numpy().astype(np.float64) for c in crop_coords(torch.as_tensor(bboxes), scale, out))
    B, H, W = frames.shape[:3]
    res = np.zeros((B, out, out, 3))
    for b in range(B):
        img = frames[b].astype(np.float64)
        y0, x0 = np.floor(ys[b]).astype(int), np.floor(xs[b]).astype(int)
        fy, fx = ys[b] - y0, xs[b] - x0
        for dy, wy in ((0, 1 - fy), (1, fy)):
            for dx, wx in ((0, 1 - fx), (1, fx)):
                yi, xi = y0 + dy, x0 + dx
                vy, vx = (yi >= 0) & (yi < H), (xi >= 0) & (xi < W)
                px = img[np.clip(yi, 0, H - 1)][:, np.clip(xi, 0, W - 1)]
                res[b] += ((wy * vy)[:, None] * (wx * vx)[None, :])[..., None] * px
    return res / 255.0


@pytest.mark.parametrize("hw", [(450, 800), (240, 320)])
@pytest.mark.parametrize("content, atol", [("smooth", 1e-5), ("noise", 1.25e-4)])
def test_plain_matches_jax_crop_and_pallas_kernel(hw, content, atol):
    frames = (_smooth_frames if content == "smooth" else _noise_frames)(4, hw)
    got = crop_batch_plain(torch.as_tensor(frames), torch.as_tensor(BBOXES)).numpy()
    want, want_pallas = _jax_crops(frames, BBOXES)
    assert got.shape == want.shape == (4, 224, 224, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=atol)
    np.testing.assert_allclose(got, want_pallas, atol=atol)


def test_plain_matches_exact_bilinear_oracle():
    frames = _noise_frames(4, seed=2)
    got = crop_batch_plain(torch.as_tensor(frames), torch.as_tensor(BBOXES)).numpy()
    np.testing.assert_allclose(got, _oracle(frames, BBOXES), atol=1e-6)
    # Zero border: the box at (-20, 10) samples outside the frame on the left.
    assert got[3, :, :20].max() == 0.0


def test_bf16_output_within_quantization_tolerance():
    frames = torch.as_tensor(_noise_frames(2, seed=3))
    bb = torch.as_tensor(BBOXES[:2])
    f32 = crop_batch_plain(frames, bb)
    bf16 = crop_batch_plain(frames, bb, out_dtype=torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
    # One bf16 rounding of values in [0, 1] is at most 2**-9; the JAX bf16
    # class (tests/test_resample_pallas.py) is 4/255.
    assert float((bf16.float() - f32).abs().max()) <= 2.0 ** -9


def test_dispatch_on_cpu_is_the_plain_version_and_kernel_refuses_cpu():
    frames = torch.as_tensor(_noise_frames(2, (64, 96), seed=4))
    bb = torch.as_tensor(np.array([[48, 32, 40, 40], [0, 0, 30, 30]], np.float32))
    torch.testing.assert_close(crop_batch(frames, bb.double()), crop_batch_plain(frames, bb),
                               rtol=0, atol=0)
    before = crop_batch_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        crop_batch_cuda(frames, bb)
    assert crop_batch_cuda.launches == before


# The training augmentation crop (rotation, flip, colour scale), held
# against the JAX package's crop_batch_affine on u8 and f32 frames with
# boxes partly outside them. The port reproduces how XLA compiles the JAX
# warp (a division by a constant as a multiply by its f32 reciprocal, the
# first multiply-add of each sample position as one FMA), so where both
# packages have the same cos and sin of the angle they agree to an ulp of
# the four taps: 2e-6. XLA's f32 cos and sin miss the correctly rounded
# value (the port's) for ~1-2% of angles, by an ulp; that can move a sample
# position by one f32 ulp (6.1e-5 px below 1024), and the crop by that
# times the image gradient, a full scale per pixel on pixel noise or at the
# frame's zero border, times the colour scale (<= 1.3): 1e-4 on such
# frames. Seed 0 draws one such angle (frame 5).
AUG_BOXES = np.array([[400, 225, 220, 220], [100, 80, 60, 120], [780, 440, 100, 50],
                      [-20, 10, 80, 80], [200, 300, 150, 90], [10, 430, 70, 70]], np.float32)


def _aug_inputs(seed=0):
    rng = np.random.RandomState(seed)
    n = len(AUG_BOXES)
    rots = rng.uniform(-60.0, 60.0, n).astype(np.float32)
    rots[0] = 0.0
    return (rng.uniform(1.2, 1.5, n).astype(np.float32), rots,
            np.array([False, True, False, True, True, False]),
            rng.uniform(0.7, 1.3, (n, 3)).astype(np.float32))


@pytest.mark.parametrize("content", ["smooth", "noise"])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_affine_crop_matches_jax(content, dtype):
    import jax.numpy as jnp

    from poserisk_release_tpu.ops.crop import crop_batch_affine as jax_crop_batch_affine
    from poserisk_release_tpu_torch.ops.crop import crop_batch_affine

    frames = (_smooth_frames if content == "smooth" else _noise_frames)(len(AUG_BOXES),
                                                                         (450, 800))
    if dtype == "float32":
        frames = (frames / 255.0).astype(np.float32)
    args = (AUG_BOXES,) + _aug_inputs()
    want = np.asarray(jax_crop_batch_affine(jnp.asarray(frames),
                                            *(jnp.asarray(a) for a in args), out_size=96))
    got = crop_batch_affine(torch.as_tensor(frames), *args, out_size=96).numpy()
    assert got.shape == want.shape == (6, 96, 96, 3) and got.dtype == np.float32
    rad = torch.as_tensor(args[2]) * (np.pi / 180.0)
    same_trig = np.array([
        np.asarray(jnp.cos(jnp.asarray(rad.numpy()))) == torch.cos(rad.double()).float().numpy(),
        np.asarray(jnp.sin(jnp.asarray(rad.numpy()))) == torch.sin(rad.double()).float().numpy(),
    ]).all(axis=0)
    assert list(same_trig) == [True] * 5 + [False]
    np.testing.assert_allclose(got[same_trig], want[same_trig], atol=2e-6)
    np.testing.assert_allclose(got[~same_trig], want[~same_trig], atol=1e-4)
    assert got.min() >= 0.0 and got.max() <= 1.0
    assert (got[3] == 0).all(axis=-1).mean() > 0.1  # the box at (-20, 10) reads the zero border


@pytest.mark.parametrize("aug", ["none", "defaults", "rotate_and_flip"])
def test_sample_augmentation_draws_like_jax(aug):
    """Equal seeds, equal draws, in the JAX package's order; the port reads
    its own config.AugConfig."""
    from poserisk_release_tpu.config import AugConfig as JaxAugConfig
    from poserisk_release_tpu.ops.crop import sample_augmentation as jax_sample_augmentation
    from poserisk_release_tpu_torch.config import AugConfig
    from poserisk_release_tpu_torch.ops.crop import sample_augmentation

    kw = {"none": None, "defaults": {}, "rotate_and_flip": {"flip": True, "rotate_factor": 30.0}}[aug]
    port_cfg, jax_cfg = (None, None) if kw is None else (AugConfig(**kw), JaxAugConfig(**kw))
    rng, jax_rng = np.random.RandomState(11), np.random.RandomState(11)
    draws = [sample_augmentation(rng, port_cfg, scale_factor=0.25) for _ in range(40)]
    want = [jax_sample_augmentation(jax_rng, jax_cfg, scale_factor=0.25) for _ in range(40)]
    for (s, r, f, c), (ws, wr, wf, wc) in zip(draws, want):
        assert (s, r, f) == (ws, wr, wf) and type(f) is type(wf) is bool
        assert c.dtype == wc.dtype == np.float32 and np.array_equal(c, wc)
    assert rng.randint(1 << 30) == jax_rng.randint(1 << 30)  # both streams at the same place
    flips = {f for _, _, f, _ in draws}
    assert flips == ({False, True} if aug == "rotate_and_flip" else {False})


def test_affine_crop_center_offset_matches_jax():
    from poserisk_release_tpu.ops.crop import crop_center_offset_reference_parity as jax_offset
    from poserisk_release_tpu_torch.ops.crop import crop_center_offset_reference_parity

    for out in (64, 224, 225):
        assert crop_center_offset_reference_parity(out) == jax_offset(out) == out * 0.5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the crop kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(cuda_device, out_dtype):
    frames = torch.as_tensor(_noise_frames(4), device=cuda_device)
    bb = torch.as_tensor(BBOXES, device=cuda_device)
    before = crop_batch_cuda.launches
    got = crop_batch(frames, bb, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert crop_batch_cuda.launches == before + 1
    want = crop_batch_plain(frames, bb, out_dtype=out_dtype)
    # The kernel repeats the plain version's operations in order, each
    # rounded once: bit-equal.
    torch.testing.assert_close(got, want, rtol=0, atol=0)
