"""The port's A/B tools, smokes, hot-loop bench and asset playbook against the JAX repo's tools.

poserisk_release_tpu_torch/tools/{exp_resample, exp_det_stride,
exp_pose_stride, exp_mixed_int8, exp_spin_mixed, exp_int8_glue,
exp_spin_early, smoke_stream_session, soak_streaming,
bench_reference_hotloop, validate_real_assets}.py on the CPU at small
sizes:

* each tool's configuration table (names, strides, min_stages,
  min_downsample / q8 pairs, knobs and JSON keys) equals the JAX tool's,
  read from its source with ast;
* exp_spin_early's s2d stem within 1e-5 of JAX's StemConv(s2d=True) on the
  same weights;
* exp_int8_glue's chain on YOLOv3's first residual stage (with a float head;
  seeded folded weights) against the JAX tool's make_chain_forward on the
  same folded params,
  scales and int8 input: every int8 tensor equal, the decoded detections
  within 1e-6 relative (a few f32 ulps: exp and sigmoid), the calibration
  absmax within 1e-5 relative, the chain parameters exactly;
* bench_reference_hotloop's numpy Rodrigues against cv2.Rodrigues (1e-12),
  its rule chains against tests/oracles/reference_scoring (exact), and the
  JAX tool's measure_reference smoke and batch-tail cases;
* the soak and session frames equal the JAX tools' opencv-drawn ones;
* validate_real_assets on synthetic assets: sections 2 and 3 run, 1, 4
  and 5 skip;
* every tool refuses to run without a card unless the CPU is named.

The JAX tools are loaded by file path with their persistent-cache call made
a no-op (as tests/test_torch_tools.py does). The timings run only on a card.
"""

import ast
import importlib.util
import os.path as osp
import sys

import numpy as np
import pytest
import torch

from poserisk_release_tpu_torch.tools import (
    ab,
    bench_reference_hotloop,
    exp_det_stride,
    exp_int8_glue,
    exp_mixed_int8,
    exp_pose_stride,
    exp_resample,
    exp_spin_early,
    exp_spin_mixed,
    reference_rules,
    smoke_stream_session,
    soak_streaming,
    validate_real_assets,
)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this module: its full-width models beside the
    other test processes must not oversubscribe the host."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def jax_tool(monkeypatch):
    """load(name) -> the JAX repo's tools/<name>.py as a fresh module."""
    import poserisk_release_tpu.utils.profiling as profiling

    monkeypatch.setattr(profiling, "enable_persistent_cache", lambda *a, **k: None)
    monkeypatch.setattr(sys, "path", list(sys.path))  # the tools insert the repo root
    monkeypatch.setattr(sys, "argv", ["tool.py"])  # some read a batch from argv[1]

    def load(name):
        spec = importlib.util.spec_from_file_location(
            f"jax_tools_{name}", osp.join(REPO, "tools", f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    return load


# -- the configuration tables, read from the JAX tools' sources -----------------

def _tree(name):
    with open(osp.join(REPO, "tools", f"{name}.py")) as f:
        return ast.parse(f.read())


def _assigned(tree, target):
    """The value node of the first assignment to `target`, anywhere."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == target for t in node.targets):
            return node.value
    raise KeyError(target)


def _env_knobs(tree, prefix):
    """{name: default} of every os.environ.get(name, default) call."""
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "get" and ast.unparse(node.func.value) == "os.environ"):
            name = node.args[0].value
            if name.startswith(prefix) and len(node.args) > 1:
                out[name] = node.args[1].value
    return out


def _json_dumps_keys(tree):
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and ast.unparse(node.func) == "json.dumps"
                and isinstance(node.args[0], ast.Dict)):
            return [k.value for k in node.args[0].keys]
    raise KeyError("json.dumps({...})")


def _returned_keys(module, function):
    """The keys of the dict literal a port tool's function returns: its
    JSON record."""
    with open(module.__file__) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == function)
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return)
               and isinstance(n.value, ast.Dict))
    return [k.value for k in ret.value.keys]


def _arg_defaults(tree):
    """{flag: default} of every add_argument call."""
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and ast.unparse(node.func).endswith("add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            default = (ast.literal_eval(kw["default"]) if "default" in kw
                       else (False if ast.unparse(kw.get("action", ast.Constant(""))) ==
                             "'store_true'" else None))
            out[node.args[0].value] = default
    return out


def _batch_measure(tree):
    b = _assigned(tree, "B")
    return (b.orelse.value if isinstance(b, ast.IfExp) else b.value,
            _assigned(tree, "MEASURE").value)


def _port_defaults(parser):
    return {a.option_strings[0]: a.default for a in parser._actions if a.option_strings
            and a.dest != "help"}


def check_exp_resample():
    assert _batch_measure(_tree("exp_resample")) == (ab.B, ab.MEASURE) == (128, 24)


def check_exp_det_stride():
    tree = _tree("exp_det_stride")
    assert ast.literal_eval(_assigned(tree, "STRIDES")) == exp_det_stride.STRIDES
    assert (_assigned(tree, "B").value, _assigned(tree, "MEASURE").value) == (ab.B, ab.MEASURE)
    assert ast.literal_eval(_assigned(tree, "FRAME_HW")) == ab.FRAME_HW
    src = ast.unparse(tree)
    assert "f'{s}/fused'" in src and "f'{s}/unfused'" in src and "if s > 1:" in src
    assert exp_det_stride.config_names() == [
        "1/fused", "2/fused", "2/unfused", "4/fused", "4/unfused", "8/fused", "8/unfused"]


def check_exp_pose_stride():
    tree = _tree("exp_pose_stride")
    steps = _assigned(tree, "steps")
    want = []
    for key, call in zip(steps.keys, steps.values):
        spin_q = any(k.arg == "spin_q" and k.value.value for k in call.keywords)
        det, pose = (a.value for a in call.args)
        want.append((key.value, det, pose, spin_q, key.value.endswith("/b512")))
    assert tuple(want) == exp_pose_stride.CONFIGS
    assert _assigned(tree, "B2").value == exp_pose_stride.B2 == 512


def check_exp_mixed_int8():
    tree = _tree("exp_mixed_int8")
    configs = _assigned(tree, "configs")
    want = {k.value: {kw.arg: kw.value.value for kw in v.keywords}
            for k, v in zip(configs.keys, configs.values)}
    assert want == exp_mixed_int8.CONFIGS and list(want) == list(exp_mixed_int8.CONFIGS)
    runs = _assigned(tree, "full_runs")
    assert tuple((e.elts[0].value, e.elts[1].slice.value) for e in runs.elts) == \
        exp_mixed_int8.FULL_STEP_RUNS
    assert "--skip-full-step" in _arg_defaults(tree)


def check_exp_spin_mixed():
    tree = _tree("exp_spin_mixed")
    want = ast.literal_eval(_assigned(tree, "configs"))
    assert want == exp_spin_mixed.CONFIGS and list(want) == list(exp_spin_mixed.CONFIGS)


def check_exp_int8_glue():
    assert _batch_measure(_tree("exp_int8_glue")) == (ab.B, ab.MEASURE)


def check_exp_spin_early():
    tree = _tree("exp_spin_early")
    assert _env_knobs(tree, "EXP_") == {"EXP_B": str(ab.B), "EXP_MEASURE": str(ab.MEASURE)}
    steps = _assigned(tree, "steps")
    names = [k.value for k in steps.keys] + [
        n.targets[0].slice.value for n in ast.walk(tree)
        if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Subscript)
        and ast.unparse(n.targets[0].value) == "steps"]
    assert tuple(names) == exp_spin_early.ROWS
    assert "range(3)" in ast.unparse(tree) and exp_spin_early.PASSES == 3
    assert "layers=(1, 4, 6, 3)" in ast.unparse(tree)
    from poserisk_release_tpu_torch.models.spin import HMR

    ablated = exp_spin_early.layer1_ablated(HMR())
    assert [len(getattr(ablated, f"layer{i}")) for i in range(1, 5)] == [1, 4, 6, 3]


def check_smoke_stream_session():
    tree = _tree("smoke_stream_session_tpu")
    assert _env_knobs(tree, "SESS_") == {**smoke_stream_session.KNOBS, "SESS_CPU": "0"}
    keys = _json_dumps_keys(tree)
    assert _returned_keys(smoke_stream_session, "run") == keys + ["device", "k1_launches"]
    assert ast.literal_eval(_assigned(tree, "HW")) == smoke_stream_session.HW


def check_soak_streaming():
    tree = _tree("soak_streaming_tpu")
    assert _env_knobs(tree, "SOAK_") == {**soak_streaming.KNOBS, "SOAK_CPU": "0"}
    keys = [k.value for k in _assigned(tree, "out").keys]
    assert _returned_keys(soak_streaming, "run") == keys + ["device", "max_memory_allocated",
                                                            "k1_launches"]


def check_bench_reference_hotloop():
    tree = _tree("bench_reference_hotloop")
    want = _arg_defaults(tree)
    got = _port_defaults(bench_reference_hotloop.parser())
    assert {k: got[k] for k in want} == want
    out = _assigned(tree, "out")
    assert [k.value for k in out.keys] == ["metric", "value", "frames", "stages_ms_per_frame"]
    stages = _assigned(tree, "stages")
    assert [k.value for k in stages.keys] == ["spin", "conversions", "joint_cam", "scoring"]


def check_validate_real_assets():
    tree = _tree("validate_real_assets")
    want = _arg_defaults(tree)
    got = _port_defaults(validate_real_assets.parser())
    assert {k: got[k] for k in want} == want
    titles = [n.args[0].value for n in ast.walk(tree) if isinstance(n, ast.Call)
              and ast.unparse(n.func) == "section"]
    assert [t.split(".")[0] for t in titles] == ["1", "2", "3", "4", "5"]


CHECKS = {name[len("check_"):]: fn for name, fn in sorted(globals().items())
          if name.startswith("check_")}


@pytest.mark.parametrize("tool", sorted(CHECKS))
def test_configuration_equals_the_jax_tool(tool):
    CHECKS[tool]()


# -- exp_spin_early: the space-to-depth stem ------------------------------------

@pytest.mark.parametrize("shape", [(2, 32, 48), (1, 224, 224)])
def test_s2d_stem_equals_jax_stemconv(shape):
    from poserisk_release_tpu.models.resnet import StemConv

    b, h, w = shape
    rng = np.random.RandomState(3)
    x = rng.rand(b, h, w, 3).astype(np.float32)
    kernel = (rng.randn(7, 7, 3, 64) * 0.1).astype(np.float32)
    want = np.asarray(StemConv(features=64, s2d=True).apply({"params": {"kernel": kernel}}, x))
    weight = torch.as_tensor(kernel).permute(3, 2, 0, 1)
    got = exp_spin_early.s2d_stem_conv(torch.as_tensor(x).permute(0, 3, 1, 2), weight)
    plain = torch.nn.functional.conv2d(torch.as_tensor(x).permute(0, 3, 1, 2), weight,
                                       stride=2, padding=3)
    assert got.shape == plain.shape == (b, 64, h // 2, w // 2)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5, rtol=0)


def test_s2d_stem_in_the_hmr_leaves_the_pose_as_it_was():
    from poserisk_release_tpu_torch.models.spin import HMR, init_spin_params, load_mean_params

    mean = load_mean_params("")
    model = HMR(mean_params=mean)
    model.load_state_dict(init_spin_params(torch.Generator().manual_seed(1), mean))
    model.eval()
    crops = torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = model(crops)[0]
        got = exp_spin_early.with_s2d_stem(model)(crops)[0]
    assert isinstance(exp_spin_early.with_s2d_stem(model).conv1, exp_spin_early.S2DStem)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


# -- exp_int8_glue: the int8 chain against the JAX tool's -----------------------

@pytest.fixture(scope="module")
def glue_case():
    """YOLOv3's first residual stage (spec entries 0-4: seeded folded
    kernels and biases at their spec shapes) and a float 255-channel head
    decoded at anchor set 0, in the JAX layout; and a 2 x 32 x 48
    letterbox."""
    from poserisk_release_tpu_torch.models.detector import YOLOV3_SPEC

    spec = list(YOLOV3_SPEC[:5]) + [("conv", 255, 1, 1, False), ("yolo", 0)]
    rng = np.random.RandomState(4)
    params, cin = {}, 3
    for i, (_, filters, k, _stride, bn) in enumerate(e for e in spec if e[0] == "conv"):
        i = i if i < 4 else 5
        kernel = (rng.randn(k, k, cin, filters) / np.sqrt(k * k * cin)).astype(np.float32)
        bias = (rng.randn(filters) * 0.1).astype(np.float32)
        params[f"conv_{i}"] = {"kernel": kernel, "folded_bias_leaky" if bn else "conv_bias": bias}
        cin = filters
    letter = rng.rand(2, 32, 48, 3).astype(np.float32)
    return spec, params, letter


def test_int8_chain_equals_the_jax_tools(glue_case, jax_tool, monkeypatch):
    import jax.numpy as jnp

    spec, params, letter = glue_case
    jt = jax_tool("exp_int8_glue")
    monkeypatch.setattr(jt, "YOLOV3_SPEC", spec)

    absmax = exp_int8_glue.calibrate_entry_outputs(params, torch.as_tensor(letter), spec=spec)
    want_absmax = jt.calibrate_entry_outputs(
        {k: {n: jnp.asarray(v) for n, v in layer.items()} for k, layer in params.items()},
        jnp.asarray(letter))
    assert set(absmax) == set(want_absmax)
    for k in absmax:
        assert abs(absmax[k] - want_absmax[k]) <= 1e-5 * max(1.0, want_absmax[k]), k

    chain, scales = exp_int8_glue.build_chain_params(params, absmax, spec=spec)
    want_chain, want_scales = jt.build_chain_params(params, absmax)
    assert scales == want_scales
    for name, layer in chain.items():
        assert set(layer) == set(want_chain[name])
        for key, value in layer.items():
            want = np.asarray(want_chain[name][key])
            assert value.dtype == want.dtype and np.array_equal(value, want), (name, key)

    letter_q8 = exp_int8_glue.sat8(torch.as_tensor(letter) * (1.0 / scales["input"]))
    jax_int8 = []
    real_sat8 = jt._sat8

    def recording_sat8(x):
        jax_int8.append(np.asarray(real_sat8(x)))
        return jax_int8[-1]

    monkeypatch.setattr(jt, "_sat8", recording_sat8)
    want_det = np.asarray(jt.make_chain_forward(want_scales)(
        {k: {n: jnp.asarray(v) for n, v in layer.items()} for k, layer in want_chain.items()},
        jnp.asarray(letter_q8.numpy())))
    port_int8 = []
    got_det = exp_int8_glue.make_chain_forward(scales, spec=spec)(
        exp_int8_glue.chain_params_to_device(chain, "cpu"), letter_q8,
        tap=lambda i, t: port_int8.append(t.numpy()))
    assert len(port_int8) == len(jax_int8) == 5  # four convs and the shortcut
    for got, want in zip(port_int8, jax_int8):
        assert got.dtype == want.dtype == np.int8 and np.array_equal(got, want)
    assert got_det.shape == want_det.shape == (2, 16 * 24 * 3, 5)
    np.testing.assert_allclose(got_det.numpy(), want_det, rtol=1e-6, atol=1e-7)


def test_int8_chain_gemm_branch_equals_the_plain_branch(glue_case):
    """The card's branch of the chain (im2col + torch._int_mm, the
    255-channel head's GEMM rows padded to 8 and sliced off), run here on
    the CPU's _int_mm, against the float64 branch: every int8 tensor equal,
    the detections within DET_RTOL. chip_smoke.py holds it on the card."""
    spec, params, letter = glue_case
    absmax = exp_int8_glue.calibrate_entry_outputs(params, torch.as_tensor(letter), spec=spec)
    chain, scales = exp_int8_glue.build_chain_params(params, absmax, spec=spec)
    letter_q8 = exp_int8_glue.sat8(torch.as_tensor(letter) * (1.0 / scales["input"]))
    out = exp_int8_glue.card_against_plain(chain, scales, letter_q8, spec=spec)
    assert out == {"int8_tensors": 5, "int8_tensors_plain": 5, "int8_elements_differing": 0,
                   "det_max_rel_err": out["det_max_rel_err"], "ok": True}
    assert out["det_max_rel_err"] <= exp_int8_glue.DET_RTOL


# -- bench_reference_hotloop ----------------------------------------------------

def _rotations(rng, n):
    """Axis-angles: random, tiny, zero, and near 180 degrees."""
    axes = rng.randn(n, 3)
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = np.concatenate([rng.uniform(0, np.pi, n - 4), [0.0, 1e-9, np.pi - 1e-7, np.pi]])
    return axes * angles[:, None]


def test_numpy_rodrigues_equals_cv2():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(5)
    for aa in _rotations(rng, 64):
        R = bench_reference_hotloop.rodrigues_vec_to_mat(aa)
        np.testing.assert_allclose(R, cv2.Rodrigues(aa)[0], atol=1e-12, rtol=0)
        got = bench_reference_hotloop.rodrigues_mat_to_vec(R)
        want = cv2.Rodrigues(R)[0].reshape(-1)
        np.testing.assert_allclose(got, want, atol=1e-9, rtol=0)


def test_rule_chains_equal_the_reference_oracle():
    from poserisk_release_tpu_torch.pipeline import load_add_info
    from poserisk_release_tpu_torch.config import default_config
    from tests.oracles import reference_scoring

    info = load_add_info(default_config(), "")
    rng = np.random.RandomState(6)
    poses = np.concatenate([rng.uniform(-180, 180, (150, 24, 3)),
                            rng.choice([-60, -20, -5, 0, 5, 10, 20, 45, 60, 90, 100],
                                       (150, 24, 3)).astype(np.float64)])
    for pose in poses:
        assert reference_rules.reba_frame(pose, info["REBA"]) == \
            reference_scoring.reba_frame(pose, info["REBA"])
        assert reference_rules.rula_frame(pose, info["RULA"]) == \
            reference_scoring.rula_frame(pose, info["RULA"])


def test_measure_reference_smoke():
    out = bench_reference_hotloop.measure_reference(frames=2, batch=2, seed=0)
    assert out["fps"] > 0 and out["elapsed_s"] > 0
    stages = out["stages_s"]
    assert set(stages) == {"spin", "conversions", "joint_cam", "scoring"}
    assert all(v > 0 for v in stages.values())
    assert out["elapsed_s"] >= sum(stages.values()) * 0.99


def test_measure_reference_batch_tail():
    out = bench_reference_hotloop.measure_reference(frames=3, batch=2, seed=1)
    assert out["fps"] > 0 and np.isfinite(out["fps"])


def test_measure_ours_on_the_named_cpu():
    out = bench_reference_hotloop.measure_ours(frames=2, seed=0, device=torch.device("cpu"),
                                               passes=1)
    assert out["fps"] > 0 and np.isfinite(out["fps"]) and out["warmup_s"] > 0
    assert out["device"] == "cpu"


# -- the soak and the session smoke: their frames -------------------------------

def test_soak_and_session_frames_equal_the_jax_tools(jax_tool):
    pytest.importorskip("cv2")
    soak, sess = jax_tool("soak_streaming_tpu"), jax_tool("smoke_stream_session_tpu")
    for i in (0, 1, 50, 107, 300):
        assert np.array_equal(soak_streaming.soak_frame(i, soak.H, soak.W), soak._frame(i))
    for stream, i in ((0, 0), (1, 5), (2, 23)):
        assert np.array_equal(smoke_stream_session.session_frame(stream, i),
                              sess._frame(stream, i))
    stream = soak_streaming.SoakStream(10, 18, 32)
    items = list(stream("unused.mp4", 4, None))
    assert items[0] == ("meta", 30.0) and items[-1] == ("end", 10)
    assert [(s, len(f)) for _, s, f in items[1:-1]] == [(0, 4), (4, 4), (8, 2)]
    assert np.array_equal(items[2][2][1], soak_streaming.soak_frame(5, 18, 32))


# -- validate_real_assets on synthetic assets -----------------------------------

def _darknet_bytes(sd):
    """The darknet binary of an unfolded YOLOv3 state_dict (the loader's
    order: a 5-int32 header, then per conv its BN or bias, then its OIHW
    kernel)."""
    from poserisk_release_tpu_torch.models.detector import conv_indices

    chunks = [np.zeros(5, np.int32).tobytes()]
    for i in conv_indices():
        p = f"conv_{i}."
        names = (("bn.bias", "bn.weight", "bn.running_mean", "bn.running_var")
                 if p + "bn.weight" in sd else ("conv.bias",))
        for name in names + ("conv.weight",):
            chunks.append(np.asarray(sd[p + name], np.float32).tobytes())
    return b"".join(chunks)


def test_validate_real_assets_on_synthetic_assets(tmp_path, capsys):
    from poserisk_release_tpu_torch.models.detector import init_yolo_params
    from poserisk_release_tpu_torch.models.spin import HMR, init_spin_params, load_mean_params

    mean = load_mean_params("")
    sd = init_spin_params(torch.Generator().manual_seed(3), mean)
    torch.save({"model": sd}, tmp_path / "model_checkpoint.pt")
    (tmp_path / "yolov3.weights").write_bytes(_darknet_bytes(init_yolo_params(0)))
    (tmp_path / "smpl").mkdir()
    out = validate_real_assets.main([
        "--cpu", "--smpl_dir", str(tmp_path / "smpl"),
        "--ckpt", str(tmp_path / "model_checkpoint.pt"),
        "--weights", str(tmp_path / "yolov3.weights"), "--img_size", "64",
        "--probe_hw", "96", "128", "--spin_crops", "4", "--crop_size", "64"])
    text = capsys.readouterr().out
    assert out["smpl"] is None and out["video"] == {}
    assert text.count("SKIP:") == 3 and "done." in text
    assert out["spin"]["keys_matched"] == len(HMR().state_dict())
    assert f"{len(HMR().state_dict())} matched the port's HMR, 0 missing" in text
    assert "--fast (bf16)" in text and "--spin_int8 (bias-corrected)" in text
    assert all(np.isfinite(out["spin"][k]["max"]) for k in ("bf16", "int8"))
    assert "detections at thr 0.1" in text and out["yolo"]["strict"] >= 0


# -- without a card -------------------------------------------------------------

@pytest.mark.parametrize("tool,argv,env", [
    (exp_resample, [], {}), (exp_det_stride, [], {}), (exp_pose_stride, [], {}),
    (exp_mixed_int8, [], {}), (exp_spin_mixed, [], {}), (exp_int8_glue, [], {}),
    (exp_spin_early, [], {}), (smoke_stream_session, [], {"SESS_CPU": "0"}),
    (soak_streaming, [], {"SOAK_CPU": "0"}), (bench_reference_hotloop, ["--with-ours"], {}),
    (validate_real_assets, [], {}),
], ids=lambda v: getattr(v, "__name__", "").rsplit(".", 1)[-1] or None)
def test_tools_raise_without_a_card_unless_the_cpu_is_named(tool, argv, env, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main(argv)
