"""The port's measurement tools and compile-check entry against the JAX repo's.

poserisk_release_tpu_torch/tools/{profile_stages,roofline_detector,
roofline_spin,bench_e2e}.py and graft_entry.py, on the CPU at small sizes:
the shape tables and FLOP counts equal the JAX tools', the int8 arithmetic
they time equals the product's and the JAX tools', the entry's step equals
throughput.make_pose_and_score_step, and each refuses to run without a
card unless the CPU is named. The JAX tools are loaded by file path with
their persistent-cache call made a no-op (it would repoint this process's
JAX cache). The timings themselves run only on a card:

    python -m poserisk_release_tpu_torch.tools.profile_stages
"""

import ast
import importlib.util
import os.path as osp
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poserisk_release_tpu_torch import graft_entry, pipeline
from poserisk_release_tpu_torch.io import video
from poserisk_release_tpu_torch.models import detector
from poserisk_release_tpu_torch.ops.qconv import (
    QConv2d,
    int_conv_nhwc,
    int_conv_plain,
    leaky,
    quantize,
    quantize_kernel,
)
from poserisk_release_tpu_torch.tools import (
    bench_e2e,
    profile_stages,
    roofline_detector,
    roofline_spin,
    timing,
)
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture
def jax_tool(monkeypatch):
    """load(name) -> the JAX repo's tools/<name>.py as a fresh module."""
    import poserisk_release_tpu.utils.profiling as profiling

    monkeypatch.setattr(profiling, "enable_persistent_cache", lambda *a, **k: None)
    monkeypatch.setattr(sys, "path", list(sys.path))  # the tools insert the repo root

    def load(name):
        spec = importlib.util.spec_from_file_location(
            f"jax_tools_{name}", osp.join(REPO, "tools", f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    return load


def test_shape_classes_equal_jax(jax_tool):
    want = jax_tool("roofline_detector").shape_classes()
    got = roofline_detector.shape_classes()
    assert list(got.items()) == list(want.items())
    assert len(got) == 23 and "23 conv shape classes" in roofline_detector.shape_classes.__doc__
    assert sum(n for n, _ in got.values()) == len(detector.conv_indices()) == 75


def test_spin_stages_and_block_flops_equal_jax(jax_tool, monkeypatch, capsys):
    """STAGES equal; each stage's FLOPs per block equal the JAX tool's, read
    from its table with its timing replaced by a fixed 1e-6 ms (its TF/s
    column is then FLOPs * 1e-3, printed whole)."""
    jax_spin = jax_tool("roofline_spin")
    assert roofline_spin.STAGES == jax_spin.STAGES
    monkeypatch.setattr(jax_spin, "time_stage", lambda *a, **k: 1e-6)
    monkeypatch.setattr(sys, "argv", ["roofline_spin.py", "--no-int8"])
    jax_spin.main()
    rows = [line.split("|") for line in capsys.readouterr().out.splitlines()
            if re.match(r"\| \d+x\d+ \|", line)]
    assert len(rows) == len(roofline_spin.STAGES)
    for (h, w, c, _n), row in zip(roofline_spin.STAGES, rows):
        flops = roofline_spin.block_flops(h, w, c) * jax_spin.B
        assert row[5].strip() == f"{flops / (1e-6 / 1000) / 1e12:.0f}"
        q = c // 4  # the three convs' MACs, counted from their shapes
        assert roofline_spin.block_flops(h, w, c) == 2 * h * w * (c * q + 9 * q * q + q * c)


@pytest.mark.parametrize("stride", [1, 2])
def test_int8_conv_step_equals_product_qconv(jax_tool, stride):
    """The roofline's int8 step on a 9x13x16->32 3x3 conv at B = 2: the
    product block's QConv2d (qconv_block), its integer sums exact (the CPU's
    float64 product, torch._int_mm and an int64 numpy product agree), its
    f32 epilogue bit for bit, and the JAX tool's looped conv's sum."""
    key = (9, 13, 16, 32, 3, stride)
    fn, block, x = roofline_detector.int8_conv_step(key, 2, CPU)
    got = fn()
    kern, bias = roofline_detector.class_weights(16, 32, 3)
    qkernel, w_scale = quantize_kernel(kern)
    layer = {"qkernel": qkernel, "w_scale": w_scale, "in_scale": np.float32(1 / 127),
             "q_bias_leaky": bias}
    product = detector.qconv_block(layer, roofline_detector.spec_index(3, stride))
    assert isinstance(block, QConv2d) and (block.stride, block.pad, block.act) == (
        stride, 1, "leaky")
    assert torch.equal(got, product(x, torch.bfloat16))

    xq = quantize(x.to(torch.bfloat16), block.inv_s.to(torch.bfloat16))
    acc = int_conv_plain(xq, block.qkernel, stride, 1)
    acc_mm = int_conv_nhwc(xq.permute(0, 2, 3, 1).contiguous(), block.wmat, 3, 3, stride, 1)
    xp = np.pad(xq.permute(0, 2, 3, 1).numpy().astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    ho, wo = acc.shape[2:]
    ref = sum(np.einsum("bhwc,cn->bhwn",
                        xp[:, ky:ky + stride * ho:stride, kx:kx + stride * wo:stride],
                        qkernel[ky, kx].astype(np.int64)) for ky in range(3) for kx in range(3))
    assert np.array_equal(acc.permute(0, 2, 3, 1).numpy(), ref)
    assert np.array_equal(acc_mm.numpy(), ref)
    f32 = leaky(acc.float() * block.dq[:, None, None] + block.bias[:, None, None])
    assert torch.equal(got, f32.to(torch.bfloat16))

    jax_det = jax_tool("roofline_detector")
    x_nhwc = jnp.asarray(x.permute(0, 2, 3, 1).float().numpy()).astype(jnp.bfloat16)
    looped = jax.jit(jax_det._looped_int8(1), static_argnames=("stride", "pad"))
    want = float(looped(x_nhwc, jnp.asarray(qkernel), jnp.asarray(w_scale),
                        jnp.asarray(np.float32(1 / 127)), jnp.asarray(bias), stride=stride, pad=1))
    assert float(f32.sum()) == pytest.approx(want, rel=1e-5)  # f32 sums in two orders


def test_int8_bottleneck_block_equals_jax_chain(jax_tool):
    """roofline_spin's int8 block at depth 1 against the JAX tool's
    _chain_int8 block (its output caught on the way into the tool's sum),
    on a 7x7x64 stage at B = 2: equal within 1e-6 (f32 epilogues of the
    same integer sums; a flipped rounding would show as a whole step)."""
    jax_spin = jax_tool("roofline_spin")
    h, w, c = 7, 7, 64
    kernels = roofline_spin.stage_kernels(c)
    x = np.random.RandomState(3).uniform(-1, 1, (2, h, w, c)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    layers = []
    for k in kernels:
        w_s = np.maximum(np.abs(k).max(axis=(0, 1, 2)), 1e-12) / 127.0
        layers.append({"qk": jnp.asarray(np.clip(np.round(k / w_s), -127, 127).astype(np.int8)),
                       "w_s": jnp.asarray(w_s.astype(np.float32)),
                       "in_s": jnp.asarray(np.float32(1 / 127.0))})
    seen = []

    class CatchSum:
        def __getattr__(self, name):
            return getattr(jnp, name)

        def sum(self, a, *args, **kw):
            jax.debug.callback(lambda v: seen.append(np.asarray(v)), a)
            return jnp.sum(a, *args, **kw)

    jax_spin.jnp = CatchSum()
    total = float(jax_spin._chain_int8()(xb, *layers, 1, 1))
    jax.effects_barrier()
    (want,) = seen
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)
    got = roofline_spin.int8_block(roofline_spin.int8_layers(kernels, CPU),
                                   xt.permute(0, 3, 1, 2))
    got = got.float().permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, h, w, c)
    assert np.abs(got - want).max() <= 1e-6
    assert float(got.sum()) == pytest.approx(total, rel=1e-5)


def test_roofline_tables_run_on_the_cpu():
    """Each table's code path end to end at a small size (a rehearsal: the
    times are the CPU's)."""
    det = roofline_detector.classes_table(CPU, top=1, bf16=True, batch=1)
    assert det["classes"] == 23 and len(det["rows"]) == 1
    assert det["rows"][0]["key"] == [36, 52, 128, 256, 3, 1]  # the largest share
    chain = roofline_detector.chain_table(CPU, bf16=True, batch=2, stages=((9, 13, 32, 1),))
    spin = roofline_spin.stage_table(CPU, int8=True, batch=2, stages=[(7, 7, 64, 1)])
    for rec, keys in ((det, ("ms_int8", "ms_bf16")), (chain, ("ms_int8", "ms_pure", "ms_bf16")),
                      (spin, ("ms_bf16", "ms_int8"))):
        assert all(np.isfinite(r[k]) for r in rec["rows"] for k in keys)
        assert rec["max_memory_allocated"] is None


def _jax_source(name):
    with open(osp.join(REPO, "tools", f"{name}.py")) as f:
        return ast.parse(f.read())


def test_profile_stages_rows_follow_jax():
    """The JAX tool's row labels in its order, its XLA crop named as the
    port's ops/crop and its Pallas kernels as K2 and K1."""
    tree = _jax_source("profile_stages")
    labels = [n.args[0].value for n in ast.walk(tree)
              if isinstance(n, ast.Call) and getattr(n.func, "id", None) == "add"]
    port = {"crop 224 (bf16 jnp)": "crop 224 (bf16 ops/crop)",
            "fused letterbox+crop (pallas)": "fused letterbox+crop (K2)",
            "crop 224 (pallas)": "crop 224 (K1)"}
    assert profile_stages.STAGE_LABELS == tuple(port.get(s, s) for s in labels)
    assert profile_stages.SERVING_BATCHES == (1, 8, 32) and profile_stages.SERVING_STEPS == 16


def test_host_ms_reads_back_once_and_tf32_off_restores(monkeypatch):
    reads = []
    real = torch.Tensor.__float__
    monkeypatch.setattr(torch.Tensor, "__float__", lambda t: reads.append(1) or real(t))
    calls = []
    ms = profile_stages.host_ms(lambda: calls.append(1) or (torch.ones(3), torch.ones(2)), 4)
    assert ms > 0 and len(calls) == 1 + 2 * 4 and len(reads) == 3
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    with profile_stages.tf32_off():
        assert not (torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32)
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == saved


def test_graft_entry_matches_pose_and_score_step():
    """entry(device='cpu')'s fn at B = 2 equals the port's
    make_pose_and_score_step (held against JAX in test_torch_pipeline.py)
    with an estimator of the same default weights; outputs as
    __graft_entry__.entry()'s docstring states them."""
    import __graft_entry__

    from poserisk_release_tpu_torch.body.smpl import SMPLFamily
    from poserisk_release_tpu_torch.config import default_config
    from poserisk_release_tpu_torch.throughput import (
        default_packed_infos,
        make_pose_and_score_step,
    )

    fn, example_args = graft_entry.entry(device="cpu")
    (ex,) = example_args
    assert ex.shape == (8, 224, 224, 3) and ex.dtype == torch.float32
    assert ex.device == CPU and not ex.any()
    crops = torch.from_numpy(np.random.RandomState(4).rand(2, 224, 224, 3).astype(np.float32))
    got = fn(crops)
    cfg = default_config()
    est = pipeline.PoseEstimator(cfg, SMPLFamily(cfg.SPIN.smpl_model_dir), device="cpu")
    with torch.inference_mode():
        want = make_pose_and_score_step(est.parents)(
            est.model, est.smpl_params, crops, *map(torch.as_tensor, default_packed_infos()))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert max(float((g - w).abs().max()) for g, w in zip(got[2:], want[2:])) <= 1e-6
    contract = __graft_entry__.entry.__doc__
    for text in ("(B, 224, 224, 3)", "reba (B,)", "rula (B,)", "euler\n    (B, 24, 3)",
                 "joint_cam (B, 24, 3)"):
        assert text in contract
    assert [tuple(t.shape) for t in got] == [(2,), (2,), (2, 24, 3), (2, 24, 3)]
    assert not got[0].is_floating_point() and not got[1].is_floating_point()
    assert got[2].dtype == got[3].dtype == torch.float32
    assert 1 <= int(got[0].min()) and int(got[0].max()) <= 12
    assert 1 <= int(got[1].min()) and int(got[1].max()) <= 7


def test_synthetic_frames_equal_synth_video(jax_tool, monkeypatch):
    """bench_e2e's frames equal the JAX tool's synth_video pixels (caught
    where it hands them to its mp4 writer), and SyntheticStream yields them
    as a decoder would: RGB windows, then the total."""
    import poserisk_release_tpu.io.video as jax_video

    written = {}
    monkeypatch.setattr(jax_video, "write_video",
                        lambda frames, fps, file_path: written.update(frames=frames, fps=fps))
    jax_tool("bench_e2e").synth_video("unused.mp4", 45)
    ours = bench_e2e.synth_frames(45)
    assert ours.shape == (45, 450, 800, 3) and written["fps"] == 30.0
    assert np.array_equal(ours, np.stack(written["frames"]))
    items = list(bench_e2e.SyntheticStream(ours)("unused.mp4", 16, None))
    assert items[0] == ("meta", 30.0) and items[-1] == ("end", 45)
    assert [i[1] for i in items[1:-1]] == [0, 16, 32]
    assert np.array_equal(np.concatenate([i[2] for i in items[1:-1]]), ours[..., ::-1])


def test_bench_e2e_record_has_jax_keys_plus_decoder(monkeypatch):
    """The tool's plumbing with the models faked: the record carries the
    JAX tool's keys (read from its json.dumps call) and `decoder`; under
    --synthetic the Predictor's decoder yields the synthetic clip's RGB
    windows, --no_plots turns the plots off, and both are restored after."""
    tree = _jax_source("bench_e2e")
    dumps = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                 and getattr(n.func, "attr", None) == "dumps")
    jax_keys = {k.value for k in dumps.args[0].keys}

    class FakeYolo:
        def __init__(self, params, batch_size, rect, int8, device):
            assert (batch_size, rect, int8, device) == (64, True, True, CPU)
            self.calibrated = None

        def calibrate(self, frames):
            self.calibrated = frames.shape

        def __call__(self, frames):
            return []

    seen = []

    class FakePredictor:
        def __init__(self, cfg, detector, visualize, fast, device):
            assert fast and not visualize and device == CPU
            assert detector.yolo.calibrated == (8, 450, 800, 3)
            self.cfg, self.detector = cfg, detector
            self.reba = self.rula = lambda *a: None

        def __call__(self, path, info, out):
            from poserisk_release_tpu_torch.io.video import _window_stream

            frames = [it[2] for it in _window_stream(path, 64, None) if it[0] == "window"]
            boxes = self.detector(frames[0])
            seen.append((np.concatenate(frames), pipeline.post_process_scores, boxes[0]))
            self.timings = {"decode+track (overlapped)": 0.5, "pose": 0.25, "score": 0.125}

    plain_stream, plain_post = video._window_stream, pipeline.post_process_scores
    monkeypatch.setattr(detector, "YoloDetector", FakeYolo)
    monkeypatch.setattr(detector, "init_yolo_params", lambda: {})
    monkeypatch.setattr(detector, "fold_bn_params", lambda p: p)
    monkeypatch.setattr(pipeline, "Predictor", FakePredictor)
    record = bench_e2e.main(["--cpu", "--synthetic", "--no_plots", "--frames", "70"])
    assert set(record) == jax_keys | {"decoder"} and record["decoder"] == "synthetic"
    assert record["stage_timings_sec"] == {"decode+track (overlapped)": 0.5, "pose": 0.25,
                                           "score": 0.125}
    assert record["metric"] == "e2e_wallclock_fps" and record["value"] > 0
    assert "no plots" in record["unit"]
    (warm, warm_post, box), (clip, post, _) = seen
    assert len(warm) == 64 + 6 and len(clip) == 70
    assert np.array_equal(clip, bench_e2e.synth_frames(70)[..., ::-1])
    assert warm_post is not plain_post and post is not plain_post
    np.testing.assert_allclose(box, [[240, 45, 560, 427.5, 0.99]], rtol=1e-6)
    assert video._window_stream is plain_stream and pipeline.post_process_scores is plain_post


def test_bench_e2e_raises_without_its_sources(monkeypatch):
    """Without opencv and without --synthetic (or without matplotlib and
    without --no_plots) the tool raises before any work; it never picks
    another source by itself."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="needs cv2.*--synthetic"):
        bench_e2e.main(["--cpu", "--no_plots"])
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="needs matplotlib.*--no_plots"):
        bench_e2e.main(["--cpu", "--synthetic"])


@pytest.mark.parametrize("tool", ["profile_stages", "roofline_detector", "roofline_spin",
                                  "bench_e2e", "graft_entry"])
def test_tools_raise_without_a_card(monkeypatch, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run = {"profile_stages": lambda: profile_stages.main([]),
           "roofline_detector": lambda: roofline_detector.main([]),
           "roofline_spin": lambda: roofline_spin.main([]),
           "bench_e2e": lambda: bench_e2e.main(["--synthetic", "--no_plots"]),
           "graft_entry": graft_entry.entry}[tool]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run()


def test_card_peaks_live_in_timing_only():
    """The H100 peaks are tools/timing's; no other file of the port or
    chip_smoke.py spells one out."""
    assert (timing.BF16_FLOPS_PER_S, timing.INT8_OPS_PER_S, timing.FP32_FLOPS_PER_S,
            timing.HBM_BYTES_PER_S) == (989e12, 1979e12, 67e12, 3.35e12)
    from poserisk_release_tpu_torch.tools import exp_fused_stage

    assert exp_fused_stage.INT8_OPS_PER_S is timing.INT8_OPS_PER_S
    import glob

    files = [osp.join(REPO, "chip_smoke.py")] + glob.glob(
        osp.join(REPO, "poserisk_release_tpu_torch", "**", "*.py"), recursive=True)
    for path in files:
        if path.endswith(osp.join("tools", "timing.py")):
            continue
        text = open(path).read()
        assert not re.search(r"\b(989|1979|67|3\.35)e12\b", text), path
