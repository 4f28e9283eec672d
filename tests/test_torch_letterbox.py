"""The detector letterbox and kernel K2 (fused letterbox + crop) of the port.

The plain versions (ops/crop.letterbox_plain, ops/resample.
fused_letterbox_crop_plain) are held against the JAX package's
letterbox_device / letterbox_device_rect on the cases of
tests/test_letterbox.py, and against fused_letterbox_crop (K2, the TPU
kernel) in interpret mode on the cases of tests/test_resample_pallas.py and
the stride triples of tests/test_pose_stride.py.

Tolerances. The letterbox taps are host tables on both sides, computed in
float64 from the same formula; the sums differ only in order (the JAX
package divides by 255 before two matmuls, the port after a 2x2 gather), so
the two agree within 1e-5 of full scale on any content. The crop half
carries the K1 caveat of tests/test_torch_crop.py: XLA's f32 division on
the CPU is not correctly rounded and moves JAX's sample positions by up to
1.22e-4 px, so crops are compared on smooth content, where that is below
1e-5. bf16 outputs are held to 4/255, the bound the JAX package holds its
own bf16 kernel to.

K2's host-built block table (which bands of output rows each block takes,
and which source rows a letterbox band stages) is checked here on the CPU.
The kernel itself runs only on a CUDA card: its comparisons with the plain
version are marked `cuda` and skip here (on the card:
`python -m pytest tests/test_torch_letterbox.py -m cuda --noconftest`).
"""

import numpy as np
import pytest
import torch

from poserisk_release_tpu_torch.ops.crop import (
    GRAY,
    letterbox_device,
    letterbox_device_rect,
    letterbox_plain,
    rect_canvas_geometry,
)
from poserisk_release_tpu_torch.ops.resample import (
    K2_BANDS_PER_SM,
    K2_SMEM_BUDGET,
    fused_letterbox_crop,
    fused_letterbox_crop_cuda,
    fused_letterbox_crop_plain,
    k2_band_geometry,
    k2_band_rows,
    k2_block_table,
)
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
STRIDE_TRIPLES = [(2, 2, 1), (4, 1, 1), (2, 1, 2), (1, 4, 1), (1, 1, 8), (1, 2, 4), (2, 4, 1)]


def _noise(n, hw, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n,) + tuple(hw) + (3,)).astype(np.uint8)


def _smooth(n, hw, seed=0):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]].astype(np.float64)
    out = []
    for _ in range(n):
        fx, fy, ph = rng.uniform(20, 60), rng.uniform(20, 60), rng.uniform(0, 6, 3)
        img = np.stack([128 + 100 * np.sin(xx / fx + ph[c]) * np.cos(yy / fy - ph[c])
                        for c in range(3)], axis=-1)
        out.append(np.round(img).astype(np.uint8))
    return np.stack(out)


def _gradient_frames():
    yy, xx = np.mgrid[0:90, 0:160]
    base = ((yy * 2 + xx) % 256).astype(np.uint8)
    return np.stack([np.stack([base, 255 - base, base // 2], axis=-1)] * 2)


def _square_block():
    img = np.zeros((1, 64, 64, 3), np.uint8)
    img[0, 16:48, 16:48] = 200
    return img


SQUARE_CASES = {
    "noise_90x160": (lambda: _noise(2, (90, 160), 1234), 64),
    "gradient_90x160": (_gradient_frames, 64),
    "tall_160x90": (lambda: np.transpose(_gradient_frames(), (0, 2, 1, 3)).copy(), 64),
    "square_64": (_square_block, 64),
    "ingest_450x800": (lambda: _noise(2, (450, 800), 5), 416),
}


@pytest.mark.parametrize("case", sorted(SQUARE_CASES))
def test_square_letterbox_matches_jax(case):
    import jax.numpy as jnp

    from poserisk_release_tpu.ops.crop import letterbox_device as jax_letterbox

    make, size = SQUARE_CASES[case]
    frames = make()
    want = np.asarray(jax_letterbox(jnp.asarray(frames), img_size=size))
    got = letterbox_device(torch.as_tensor(frames), img_size=size).numpy()
    assert got.shape == want.shape == (frames.shape[0], size, size, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("hw, size", [((90, 160), 256), ((450, 800), 416), ((360, 640), 416),
                                      ((160, 90), 64)])
def test_rect_letterbox_matches_jax(hw, size):
    import jax.numpy as jnp

    from poserisk_release_tpu.ops.crop import letterbox_device_rect as jax_rect

    frames = _noise(2, hw, 7)
    want = np.asarray(jax_rect(jnp.asarray(frames), img_size=size))
    got = letterbox_device_rect(torch.as_tensor(frames), img_size=size).numpy()
    ch, cw = rect_canvas_geometry(hw[0], hw[1], size)[:2]
    assert got.shape == want.shape == (2, ch, cw, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_gray_border_and_unit_range():
    letter = letterbox_plain(torch.as_tensor(_noise(1, (450, 800), 7)), 416, rect=True).numpy()
    # 800x450 -> 416x234 content on a 416x288 canvas with pad_y 27.
    assert letter.shape == (1, 288, 416, 3)
    assert (letter[0, :27] == np.float32(GRAY)).all()
    assert (letter[0, 27 + 234:] == np.float32(GRAY)).all()
    assert letter.min() >= 0.0 and letter.max() <= 1.0 + 1e-6


def _jax_fused(frames, bboxes, **kw):
    import jax.numpy as jnp

    from poserisk_release_tpu.ops.resample_pallas import fused_letterbox_crop as jax_fused

    letter, crops = jax_fused(jnp.asarray(frames), jnp.asarray(bboxes), interpret=True, **kw)
    return np.asarray(letter, np.float32), np.asarray(crops, np.float32)


@pytest.mark.parametrize("hw", [(450, 800), (360, 640)])
def test_fused_plain_matches_jax_kernel_f32(hw):
    import jax.numpy as jnp

    frames = _smooth(4, hw)
    want_l, want_c = _jax_fused(frames, BBOXES, compute_dtype=jnp.float32)
    got_l, got_c = fused_letterbox_crop(torch.as_tensor(frames), torch.as_tensor(BBOXES))
    assert got_l.shape == want_l.shape and got_c.shape == want_c.shape
    np.testing.assert_allclose(got_l.numpy(), want_l, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=0, atol=1e-5)


def test_fused_plain_bf16_within_quantization_tolerance():
    import jax.numpy as jnp

    frames = _noise(2, (450, 800), 3)
    want_l, want_c = _jax_fused(frames, BBOXES[:2], compute_dtype=jnp.float32)
    got_l, got_c = fused_letterbox_crop(torch.as_tensor(frames), torch.as_tensor(BBOXES[:2]),
                                        out_dtype=torch.bfloat16)
    assert got_l.dtype == got_c.dtype == torch.bfloat16
    assert float(np.abs(got_l.float().numpy() - want_l).max()) < 4.0 / 255.0
    assert float(np.abs(got_c.float().numpy() - want_c).max()) < 4.0 / 255.0


@pytest.mark.parametrize("stride", [2, 3, 4])
def test_fused_det_stride_matches_jax_kernel(stride):
    import jax.numpy as jnp

    frames = _smooth(11, (90, 160), 2)
    bboxes = np.tile(np.array([[80.0, 45.0, 50.0, 50.0]], np.float32), (11, 1))
    want_l, want_c = _jax_fused(frames, bboxes, img_size=64, out_size=32,
                                compute_dtype=jnp.float32, det_stride=stride)
    got_l, got_c = fused_letterbox_crop(torch.as_tensor(frames), torch.as_tensor(bboxes),
                                        img_size=64, out_size=32, det_stride=stride)
    assert got_l.shape == want_l.shape == (-(-11 // stride), 64, 64, 3)
    np.testing.assert_allclose(got_l.numpy(), want_l, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=0, atol=1e-5)


@pytest.mark.parametrize("g, d, p", STRIDE_TRIPLES)
def test_fused_stride_triples_match_jax_kernel(g, d, p):
    import jax.numpy as jnp

    rng = np.random.RandomState(0)
    B = 16
    frames = _smooth(B, (96, 160), 4)
    bboxes = np.stack([np.full(B, 80.0), np.full(B, 48.0), rng.uniform(30, 60, B),
                       rng.uniform(40, 80, B)], 1).astype(np.float32)
    want_l, want_c = _jax_fused(frames, bboxes, img_size=64, compute_dtype=jnp.float32,
                                det_stride=d, frame_stride=g, crop_stride=p)
    got_l, got_c = fused_letterbox_crop(torch.as_tensor(frames), torch.as_tensor(bboxes),
                                        img_size=64, det_stride=d, crop_stride=p,
                                        frame_stride=g)
    n_sub = -(-B // g)
    assert got_l.shape[0] == want_l.shape[0] == -(-n_sub // d)
    assert got_c.shape[0] == want_c.shape[0] == -(-n_sub // p)
    np.testing.assert_allclose(got_l.numpy(), want_l, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=0, atol=1e-5)


def test_dispatch_on_cpu_is_the_plain_version_and_kernel_refuses_cpu():
    frames = torch.as_tensor(_noise(3, (90, 160), 9))
    bb = torch.as_tensor(np.tile([[80.0, 45.0, 50.0, 50.0]], (3, 1)).astype(np.float32))
    got = fused_letterbox_crop(frames, bb.double(), img_size=64, det_stride=2)
    want = fused_letterbox_crop_plain(frames, bb, img_size=64, det_stride=2)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    before = fused_letterbox_crop_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        fused_letterbox_crop_cuda(frames, bb)
    with pytest.raises(ValueError, match="CUDA"):
        fused_letterbox_crop_cuda(frames, None)
    assert fused_letterbox_crop_cuda.launches == before


TABLE_FRAMES = [(450, 800), (1080, 1920), (240, 320), (449, 797)]


@pytest.mark.parametrize("rect", [False, True])
@pytest.mark.parametrize("hw", TABLE_FRAMES)
@pytest.mark.parametrize("n_sub, d, p", [(16, 1, 1), (8, 2, 1), (16, 1, 8), (13, 2, 4), (11, 3, 0)])
def test_k2_block_table(hw, rect, n_sub, d, p):
    """Every output row of every active sub-frame is in exactly one band, in
    frame-major order; each letterbox band stages every row its taps read;
    the staged rows fit the shared-memory budget."""
    from poserisk_release_tpu_torch.ops.crop import letterbox_taps

    H, W = hw
    S = 224
    R, slot, staged = k2_band_geometry(W)
    assert 1 <= R <= 8 and slot % 16 == 0 and slot >= 3 * W + 24
    assert staged == 2 * R * slot <= K2_SMEM_BUDGET
    rows, _, CH, _ = letterbox_taps(H, W, 416, rect)
    table = k2_block_table(H, W, 416, rect, n_sub, d, p, S, R)
    sub, kind, row0, nrows, out, lo, n = (table[:, i] for i in range(7))
    assert (np.diff(sub) >= 0).all()
    assert all((np.diff(kind[sub == b]) >= 0).all() for b in range(n_sub))
    assert ((nrows >= 1) & (nrows <= R)).all()
    for k, stride, height in ((0, d, CH), (1, p, S)):
        active = [b for b in range(n_sub) if stride and b % stride == 0]
        sel = kind == k
        assert sorted(set(sub[sel])) == active
        assert (out[sel] == sub[sel] // max(stride, 1)).all()
        for b in active:
            covered = np.concatenate([np.arange(r, r + m) for r, m in
                                      zip(row0[sel & (sub == b)], nrows[sel & (sub == b)])])
            assert np.array_equal(np.sort(covered), np.arange(height))
    i0, i1, w0, w1 = rows
    for r, m, a, c in zip(row0[kind == 0], nrows[kind == 0], lo[kind == 0], n[kind == 0]):
        used = (w0[r:r + m] != 0) | (w1[r:r + m] != 0)
        read = np.concatenate([i0[r:r + m][used], i1[r:r + m][used]])
        if c == 0:
            assert not used.any()
        elif c > 0:
            assert c <= 2 * m and 0 <= a and a + c <= H
            assert ((read >= a) & (read < a + c)).all()
        else:
            assert c == -1 and read.max() - read.min() + 1 > 2 * m


@pytest.mark.parametrize("n_det, n_crop, want", [(64, 64, 8), (8, 8, 4), (64, 0, 8), (2, 0, 4)])
def test_k2_band_rows_halves_r_only_when_bands_would_not_fill_the_card(n_det, n_crop, want):
    """R = 8 at W = 800 unless that leaves fewer than K2_BANDS_PER_SM bands
    an SM (132 SMs); wide frames keep their smaller R."""
    assert k2_band_geometry(800)[0] == 8
    assert k2_band_rows(800, 288, 224, n_det, n_crop, 132) == want
    bands = n_det * -(-288 // want) + n_crop * -(-224 // want)
    assert (bands >= K2_BANDS_PER_SM * 132) == (want == 8)
    assert k2_band_rows(1920, 288, 224, 2, 2, 132) == k2_band_geometry(1920)[0] == 3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the letterbox+crop kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g, d, p", [(1, 1, 1)] + STRIDE_TRIPLES)
def test_kernel_matches_plain_version(cuda_device, out_dtype, g, d, p):
    frames = torch.as_tensor(_noise(16, (450, 800), 11), device=cuda_device)
    bb = torch.as_tensor(np.tile(BBOXES, (4, 1)), device=cuda_device)
    before = fused_letterbox_crop_cuda.launches
    got = fused_letterbox_crop(frames, bb, out_dtype=out_dtype, det_stride=d,
                               crop_stride=p, frame_stride=g)
    torch.cuda.synchronize()
    assert fused_letterbox_crop_cuda.launches == before + 1
    want = fused_letterbox_crop_plain(frames, bb, out_dtype=out_dtype, det_stride=d,
                                      crop_stride=p, frame_stride=g)
    # The kernel repeats the plain version's operations in order, each
    # rounded once: bit-equal.
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("rect", [False, True])
def test_letterbox_only_mode_matches_plain_version(cuda_device, rect):
    frames = torch.as_tensor(_noise(5, (450, 800), 12), device=cuda_device)
    fn = letterbox_device_rect if rect else letterbox_device
    before = fused_letterbox_crop_cuda.launches
    got = fn(frames[::2], 416)  # a batch slice: strided frames, no copy
    torch.cuda.synchronize()
    assert fused_letterbox_crop_cuda.launches == before + 1
    torch.testing.assert_close(got, letterbox_plain(frames[::2], 416, rect=rect),
                               rtol=0, atol=0)


def _edge_boxes(B, H, W, seed):
    """Tiny (upscaled crops), huge, partly and wholly outside the frame,
    then random boxes, cycled over B frames."""
    rng = np.random.RandomState(seed)
    edge = [[W / 2, H / 2, 3.0, 2.0], [W / 3, H / 4, 0.5, 0.7], [W / 2, H / 2, 4 * W, 3 * H],
            [-10.0, H + 5.0, 0.8 * W, 0.8 * H], [W - 5.0, 2.0, 90.0, 70.0],
            [-5 * W, H / 2, 40.0, 40.0], [W / 2, 4 * H, 60.0, 60.0]]
    rand = np.stack([rng.uniform(-60, W + 60, B), rng.uniform(-60, H + 60, B),
                     rng.uniform(2, 1.5 * W, B), rng.uniform(2, 1.5 * H, B)], 1)
    return np.concatenate([edge, rand])[:B].astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw", [(449, 797), (240, 320), (1080, 1920)])
def test_kernel_matches_plain_version_at_other_frame_sizes(cuda_device, hw, out_dtype):
    """Unaligned rows (449x797), upscaling (240x320) and a downscale past 2
    (1080x1920), with tiny, huge, partly and wholly outside boxes, in both
    letterbox modes and on a batch slice starting at an odd frame."""
    H, W = hw
    frames = torch.as_tensor(_noise(9, hw, 13), device=cuda_device)
    bb = torch.as_tensor(_edge_boxes(9, H, W, 14), device=cuda_device)
    for rect in (True, False):
        for f, b, g in ((frames, bb, 1), (frames[1::2], bb[1::2].contiguous(), 1),
                        (frames[1:], bb[1:].contiguous(), 2)):
            kw = dict(out_dtype=out_dtype, rect=rect, frame_stride=g)
            got = fused_letterbox_crop_cuda(f, b, **kw)
            only = fused_letterbox_crop_cuda(f, None, **kw)[0]
            torch.cuda.synchronize()
            want = fused_letterbox_crop_plain(f, b, **kw)
            for a, w in zip(got + (only,), want + (want[0],)):
                torch.testing.assert_close(a, w, rtol=0, atol=0)
