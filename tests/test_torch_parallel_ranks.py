"""The port's mesh layouts on gloo ranks on the CPU, against the JAX package.

One spawn per world (module-scoped; torch.multiprocessing with a file://
init under tmp_path, so side-by-side test workers never race for a TCP
port; one thread per rank), whose ranks run its layouts in turn (each a
fresh estimator and DeviceMesh on the same group), checking everything for
each and handing the results back through files. The layouts are those of
tests/test_parallelism.py::test_config_driven_estimator_matches_single_device
at its sizes (64x64 crops, 8 frames of 64x96, frames_per_step 8), on worlds
of 4 ranks: dp 2 x tp 2 with tp 2 x sp 2, dp 2 x pp 2 (2 microbatches),
dp 1 x ep 4 with sp 4 (which leaves ranks 2 and 3 without a row of layer4)
and dp 4 with dp 2 x sp 2 (also fast, int8, a Predictor, the server and the
streaming scorer); plus dp 2 on 2 ranks, which also runs the
score-histogram reduction, a Predictor, the data-parallel server and the
streaming scorer. Every rank draws from generators seeded here.

Tolerances, per layout: the port against JAX agrees within 1e-2 deg of
Euler angle and 1e-2 mm of joint position (tests/test_torch_pose.py), and
JAX's own layouts agree with its single-device run within 5e-3 under tp and
sp and 1e-3 under pp and ep (tests/test_parallelism.py; reduction order and
per-rank convolution algorithms); the two add. dp takes the pp/ep class.
Scores (REBA and RULA, from each package's scorers) are exactly equal.
"""

import filecmp
import json
import os
import os.path as osp

import numpy as np
import pytest
import torch

from poserisk_release_tpu_torch.body.smpl import SMPLFamily, SMPLModel, synthetic_smpl_arrays
from poserisk_release_tpu_torch.config import default_config
from poserisk_release_tpu_torch.models.spin import init_spin_params, load_mean_params
from poserisk_release_tpu_torch.parallel.distributed import run_ranks
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

N, HW = 8, (64, 96)
PORT_VS_JAX = 1e-2  # deg and mm: tests/test_torch_pose.py
LAYOUTS = {
    # name: (PARALLEL, world, JAX layout tolerance)
    "dp2_tp2": ({"num_devices": 2, "model": 2}, 4, 5e-3),
    "dp2_pp2": ({"num_devices": 2, "stage": 2, "stage_microbatches": 2}, 4, 1e-3),
    "ep4": ({"num_devices": 1, "expert": 4}, 4, 1e-3),
    "dp4": ({"num_devices": 4}, 4, 1e-3),
    "dp2": ({"num_devices": 2}, 2, 1e-3),
    "sp4": ({"num_devices": 1, "spatial": 4}, 4, 5e-3),
    "dp2_sp2": ({"num_devices": 2, "spatial": 2}, 4, 5e-3),
    "tp2_sp2": ({"num_devices": 1, "model": 2, "spatial": 2}, 4, 5e-3),
}
# world (its fixture): the layouts its ranks run, in turn
WORLDS = {"dp2_tp2": ("dp2_tp2", "tp2_sp2"), "dp2_pp2": ("dp2_pp2",),
          "ep4": ("ep4", "sp4"), "dp4": ("dp4", "dp2_sp2"), "dp2": ("dp2",)}
WORLD_OF = {name: world for world, names in WORLDS.items() for name in names}
RESULT_FILES = ("reba_result.txt", "rula_result.txt", "debug/pose_log.csv",
                "debug/REBA_score_log.csv", "debug/REBA_eval_pose_log.csv",
                "debug/RULA_score_log.csv", "debug/RULA_eval_pose_log.csv")


def frames_case(seed=0, n=N):
    """tests/test_parallelism.py's frames and boxes."""
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 256, (n, *HW, 3)).astype(np.uint8)
    boxes = (np.tile(np.array([48.0, 32.0, 24.0, 24.0], np.float32), (n, 1))
             + rng.rand(n, 4).astype(np.float32))
    return frames, np.arange(n), boxes


def port_cfg(**parallel):
    return default_config().replace(MODEL={"input_shape": (64, 64)},
                                    PARALLEL={"frames_per_step": 8, **parallel})


def gendered_family():
    """Three SMPL models that differ per gender (the synthetic fallback
    gives every gender the same tables), so a routing error shows."""
    family = {}
    for i, g in enumerate(("neutral", "male", "female")):
        arrays = synthetic_smpl_arrays(seed=0)
        arrays["v_template"] = arrays["v_template"] * (1.0 + 0.05 * i)
        family[g] = SMPLModel.from_arrays(arrays, gender=g)
    return family


# -- what each rank runs -------------------------------------------------------

def rank_main(rank, world, root):
    import torch.distributed as dist

    from poserisk_release_tpu_torch.pipeline import PoseEstimator

    torch.set_num_threads(1)
    sd = torch.load(osp.join(root, "weights.pt"))
    family = SMPLFamily(default_config().SPIN.smpl_model_dir)
    outs = {}
    for name in WORLDS[world]:
        parallel = LAYOUTS[name][0]
        est = PoseEstimator(port_cfg(**parallel), family, variables=sd, device="cpu")
        out = {"result": est.run_from_frames(*frames_case()), "param_bytes": est.param_bytes,
               "chunk": est.production_chunk(), "world": dist.get_world_size()}
        extra = {"dp2_pp2": pp_checks, "ep4": ep_checks, "dp2": dp_checks,
                 "dp2_sp2": sp_checks}.get(name)
        if extra is not None:
            out.update(extra(rank, parallel, sd, family, root))
        outs[name] = out
    torch.save(outs, osp.join(root, f"rank{rank}.pt"))


def serve_one(parallel, sd, batch_sizes, rank):
    """A server on the layout's mesh: its rounded ladder, and on rank 0 the
    result of one request."""
    from poserisk_release_tpu_torch.serving import PoseScoringServer

    frames, _, boxes = frames_case(seed=8, n=1)
    with PoseScoringServer(cfg=port_cfg(**parallel), batch_sizes=batch_sizes, frame_hw=HW,
                           warm=True, spin_variables=sd, device="cpu") as srv:
        res = srv.score(frames[0], boxes[0], timeout=120) if rank == 0 else None
        return srv.batch_sizes, None if res is None else (res.reba, res.rula)


def pp_checks(rank, parallel, sd, family, root):
    """pp composes with pose_stride (production_chunk folds the
    microbatches into the quantum), and the server's ladder rounds to the
    quantum data x microbatches."""
    from poserisk_release_tpu_torch.pipeline import PoseEstimator

    stride = {"SPIN": {"pose_stride": 2}}
    est = PoseEstimator(port_cfg(**parallel).replace(**stride), family, variables=sd,
                        device="cpu")
    single = PoseEstimator(port_cfg().replace(**stride), family, variables=sd, device="cpu")
    frames, ids, boxes = frames_case(seed=2, n=16)
    return {"stride2": est.run_from_frames(frames, ids, boxes),
            "stride2_chunk": est.production_chunk(),
            "stride2_single": single.run_from_frames(frames, ids, boxes, chunk=16),
            "serving": serve_one(parallel, sd, (1, 4), rank)}


def ep_checks(rank, parallel, sd, family, root):
    """set_gender swaps the routing scalar (joints equal the single-device
    estimator built for that gender), the dense dispatch routes a mixed
    batch as per-gender serial joints do, and the ladder keeps its buckets
    (the data axis is 1)."""
    from poserisk_release_tpu_torch.ops.lbs import joints_only_from_rotmats, smpl_params_to_torch
    from poserisk_release_tpu_torch.ops.rotations import axis_angle_to_rotmat_smpl
    from poserisk_release_tpu_torch.parallel import mesh as pmesh
    from poserisk_release_tpu_torch.parallel.expert import GENDERS, make_expert_joints
    from poserisk_release_tpu_torch.pipeline import PoseEstimator

    fam = gendered_family()
    est = PoseEstimator(port_cfg(**parallel), fam, variables=sd, device="cpu")
    est.set_gender("male")
    male = est.run_from_frames(*frames_case(seed=5))
    male_single = PoseEstimator(port_cfg(), fam, variables=sd, gender="male",
                                device="cpu").run_from_frames(*frames_case(seed=5))
    try:
        est.set_gender("unknown")
        unknown_raises = False
    except ValueError:
        unknown_raises = True

    g = torch.Generator().manual_seed(3)
    rot = axis_angle_to_rotmat_smpl(torch.randn(8, 24, 3, generator=g) * 0.2)
    gid = torch.randint(0, 3, (8,), generator=g, dtype=torch.int32)
    trees = [smpl_params_to_torch(fam[x], "cpu") for x in GENDERS]
    e = pmesh.axis_index(est.mesh, "expert")
    routed = make_expert_joints(est.parents, pmesh.axis_group(est.mesh, "expert"), e)(
        trees[e] if e < 3 else trees[0], rot, gid)
    serial = torch.cat([joints_only_from_rotmats(trees[int(k)], rot[i:i + 1], est.parents)
                        for i, k in enumerate(gid)])
    return {"male": male, "male_single": male_single, "unknown_raises": unknown_raises,
            "routed": routed.numpy(), "serial": serial.numpy(),
            "serving": serve_one(parallel, sd, (1, 4), rank)}


def dp_checks(rank, parallel, sd, family, root):
    """The score histogram's all_reduce; a Predictor whose rank 0 alone
    writes, and on rank 0 the single-rank Predictor (at one thread and the
    same batch shapes, so its numbers are the ranks' own); the
    data-parallel server against a single-device one."""
    from poserisk_release_tpu_torch.models.detector import StubDetector
    from poserisk_release_tpu_torch.parallel import mesh as pmesh
    from poserisk_release_tpu_torch.pipeline import Predictor
    from poserisk_release_tpu_torch.serving import PoseScoringServer
    from poserisk_release_tpu_torch.throughput import score_histogram_psum

    pred = Predictor(cfg=port_cfg(**parallel), detector=StubDetector(), visualize=False,
                     spin_variables=sd, debug=True, debug_joints="Neck,L_Hip", device="cpu")
    summary = pred(osp.join(root, "input.mp4"), osp.join(root, "info.json"),
                   osp.join(root, f"predictor_rank{rank}"))
    single_summary = None
    if rank == 0:
        single = Predictor(cfg=port_cfg(), detector=StubDetector(), visualize=False,
                           spin_variables=sd, debug=True, debug_joints="Neck,L_Hip",
                           device="cpu")
        single_summary = single(osp.join(root, "input.mp4"), osp.join(root, "info.json"),
                                osp.join(root, "single"))
    scores = torch.as_tensor(np.random.default_rng(10 + rank).integers(1, 13, 16))
    hist = score_histogram_psum(scores, pmesh.axis_group(pred.pose_estimator.mesh, "data"))

    frames, _, boxes = frames_case(seed=7, n=4)
    served = []
    with PoseScoringServer(cfg=port_cfg(**parallel), batch_sizes=(1, 4), frame_hw=HW,
                           warm=False, spin_variables=sd, device="cpu") as dp:
        ladder = dp.batch_sizes
        if rank == 0:
            with PoseScoringServer(cfg=port_cfg(), batch_sizes=(2, 4), frame_hw=HW,
                                   warm=False, spin_variables=sd, device="cpu") as plain:
                for i in range(4):
                    a = plain.score(frames[i], boxes[i], timeout=120)
                    b = dp.score(frames[i], boxes[i], timeout=120)
                    served.append(((a.reba, a.rula), (b.reba, b.rula),
                                   float(np.abs(a.euler_deg - b.euler_deg).max()),
                                   a.euler_deg))
    return {"summary": summary, "single_summary": single_summary, "hist": hist.numpy(),
            "local_scores": scores.numpy(),
            "serving": (ladder, served), "streaming": stream_scores(parallel, sd, root)}


def stream_scores(parallel, sd, root):
    """A StreamingScorer on the layout's mesh over the edge clip: its
    frames and scores, and what its write_outputs left on this rank."""
    from poserisk_release_tpu_torch.models.detector import StubDetector
    from poserisk_release_tpu_torch.streaming import StreamingScorer

    scorer = StreamingScorer(cfg=port_cfg(**parallel), detector=StubDetector(), window=8,
                             spin_variables=sd, device="cpu")
    with open(osp.join(root, "info.json")) as f:
        res = scorer(osp.join(root, "edge.mp4"), json.load(f))
    import torch.distributed as dist

    out = osp.join(root, f"stream_rank{dist.get_rank()}")
    summary = scorer.write_outputs(res, out)
    return {"frames": res.frames, "reba": res.reba_scores, "rula": res.rula_scores,
            "total": res.total_frames, "summary": summary, "wrote": osp.exists(out)}


def sp_checks(rank, parallel, sd, family, root):
    """dp 2 x sp 2 at pose_stride 2, fast and int8 (rank 0 also runs the
    single-device estimator in each, int8 with the ranks' quantized
    backbone), a Predictor whose rank 0 alone writes, the server (on two of
    dp_checks' requests, which the dp2 world also sends to a single-device
    server), and the streaming scorer."""
    from poserisk_release_tpu_torch.models.detector import StubDetector
    from poserisk_release_tpu_torch.pipeline import PoseEstimator, Predictor
    from poserisk_release_tpu_torch.serving import PoseScoringServer

    out = {}
    stride = {"SPIN": {"pose_stride": 2}}
    est = PoseEstimator(port_cfg(**parallel).replace(**stride), family, variables=sd,
                        device="cpu")
    frames, ids, boxes = frames_case(seed=2, n=16)
    out["stride2"] = est.run_from_frames(frames, ids, boxes)
    out["stride2_single"] = None
    if rank == 0:
        out["stride2_single"] = PoseEstimator(port_cfg().replace(**stride), family,
                                              variables=sd, device="cpu").run_from_frames(
            frames, ids, boxes, chunk=16)
    for key, kw in (("fast", {"fast": True}), ("int8", {"spin_int8": True})):
        est = PoseEstimator(port_cfg(**parallel), family, variables=sd, device="cpu", **kw)
        got = est.run_from_frames(*frames_case(seed=4))
        want = None
        if rank == 0:
            single = PoseEstimator(port_cfg(), family, variables=sd, device="cpu", **kw)
            if est.quant_params is not None:
                single.load_quant_backbone(est.quant_params)
            want = single.run_from_frames(*frames_case(seed=4))
        out[key] = (got, want)
    pred = Predictor(cfg=port_cfg(**parallel), detector=StubDetector(), visualize=False,
                     spin_variables=sd, debug=True, debug_joints="Neck,L_Hip", device="cpu")
    out["summary"] = pred(osp.join(root, "input.mp4"), osp.join(root, "info.json"),
                          osp.join(root, f"predictor_rank{rank}"))
    frames, _, boxes = frames_case(seed=7, n=4)  # dp_checks' requests
    served = []
    with PoseScoringServer(cfg=port_cfg(**parallel), batch_sizes=(1, 4), frame_hw=HW,
                           warm=False, spin_variables=sd, device="cpu") as srv:
        ladder = srv.batch_sizes
        if rank == 0:
            for i in range(2):
                res = srv.score(frames[i], boxes[i], timeout=120)
                served.append(((res.reba, res.rula), res.euler_deg))
    out["serving"] = (ladder, served)
    out["streaming"] = stream_scores(parallel, sd, root)
    return out


# -- the parent ----------------------------------------------------------------

@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """Weights, the clip and the JAX single-device reference."""
    import jax

    from poserisk_release_tpu.body.smpl import SMPLFamily as JaxSMPLFamily
    from poserisk_release_tpu.config import default_config as jax_default_config
    from poserisk_release_tpu.pipeline import PoseEstimator as JaxPoseEstimator
    from poserisk_release_tpu_torch.io.video import write_video
    from poserisk_release_tpu_torch.models.convert import spin_state_dict_to_flax

    root = tmp_path_factory.mktemp("ranks")
    sd = init_spin_params(torch.Generator().manual_seed(3), load_mean_params(""))
    torch.save(sd, root / "weights.pt")
    jcfg = jax_default_config().replace(MODEL={"input_shape": (64, 64)},
                                        PARALLEL={"frames_per_step": 8})
    jest = JaxPoseEstimator(jcfg, JaxSMPLFamily(jcfg.SPIN.smpl_model_dir),
                            variables=spin_state_dict_to_flax(sd))
    ref = jax.tree_util.tree_map(np.asarray, jest.run_from_frames(*frames_case()))

    clip = []
    for i in range(12):
        img = np.full((96, 128, 3), 30, np.uint8)
        img[20:80, 30 + 2 * i:60 + 2 * i] = (180, 150, 120)
        clip.append(img)
    write_video(clip, fps=12.0, file_path=str(root / "input.mp4"))
    # tests/test_edge_integration.py's 12-frame clip, and the JAX package's
    # single-device StreamingScorer on it.
    edge = np.full((12, 120, 160, 3), 28, np.uint8)
    edge[:, 20:101, 60:111] = (180, 150, 130)
    write_video(list(edge), fps=6.0, file_path=str(root / "edge.mp4"))
    with open(osp.join(osp.dirname(__file__), "..", "poserisk_release_tpu_torch",
                       "default_information.json")) as f:
        (root / "info.json").write_text(f.read())
    from poserisk_release_tpu.models.detector import StubDetector as JaxStubDetector
    from poserisk_release_tpu.streaming import StreamingScorer as JaxStreamingScorer

    with open(root / "info.json") as f:
        jres = JaxStreamingScorer(cfg=jcfg, detector=JaxStubDetector(), window=8,
                                  spin_variables=spin_state_dict_to_flax(sd))(
            str(root / "edge.mp4"), json.load(f))
    stream_ref = {"frames": list(jres.frames), "reba": list(jres.reba_scores),
                  "rula": list(jres.rula_scores), "total": jres.total_frames}
    return root, sd, ref, stream_ref


def spawn(world, case):
    """Run the world's layouts on its ranks: (work dir, per rank {layout:
    results})."""
    root = case[0]
    work = root / world
    work.mkdir()
    for f in ("weights.pt", "input.mp4", "edge.mp4", "info.json"):
        os.link(root / f, work / f)
    n = LAYOUTS[world][1]
    run_ranks(rank_main, n, "gloo", f"file://{work / 'init'}", args=(world, str(work)),
              timeout=300)
    return work, [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(n)]


def layout(request, name):
    """(work dir, each rank's results) of one layout, from its world."""
    work, ranks = request.getfixturevalue(WORLD_OF[name])
    return work, [r[name] for r in ranks]


@pytest.fixture(scope="module")
def dp2_tp2(case):
    return spawn("dp2_tp2", case)


@pytest.fixture(scope="module")
def dp2_pp2(case):
    return spawn("dp2_pp2", case)


@pytest.fixture(scope="module")
def ep4(case):
    return spawn("ep4", case)


@pytest.fixture(scope="module")
def dp4(case):
    return spawn("dp4", case)


@pytest.fixture(scope="module")
def dp2(case):
    return spawn("dp2", case)


def scores(package, euler):
    """Per-frame (REBA, RULA) of each package's own scorers."""
    if package == "jax":
        from poserisk_release_tpu.scoring.reba import REBAScorer
        from poserisk_release_tpu.scoring.rula import RULAScorer

        kw = {}
    else:
        from poserisk_release_tpu_torch.scoring.reba import REBAScorer
        from poserisk_release_tpu_torch.scoring.rula import RULAScorer

        kw = {"device": "cpu"}
    with open(osp.join(osp.dirname(__file__), "..", "poserisk_release_tpu_torch",
                       "default_information.json")) as f:
        info = json.load(f)
    return [[int(r["score"]) for r in cls(**kw)(euler, None, info)]
            for cls in (REBAScorer, RULAScorer)]


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_layout_matches_jax_single_device(name, case, request):
    _root, _sd, (ref_euler, ref_joints, _ref_aa), _stream = case
    _work, ranks = layout(request, name)
    tol = PORT_VS_JAX + LAYOUTS[name][2]
    euler, joints, aa = ranks[0]["result"]
    assert euler.shape == joints.shape == aa.shape == (N, 24, 3)
    for other in ranks[1:]:  # every rank holds the same gathered chunk
        for a, b in zip(ranks[0]["result"], other["result"]):
            np.testing.assert_array_equal(a, b)
    assert scores("torch", euler) == scores("jax", ref_euler)
    d = np.abs(euler - ref_euler)
    np.testing.assert_array_less(np.minimum(d, 360.0 - d), tol)  # deg, +-180 wrap
    np.testing.assert_allclose(joints, ref_joints, atol=tol)  # mm
    n_data = LAYOUTS[name][0]["num_devices"]
    assert ranks[0]["chunk"] == 8 * n_data and ranks[0]["world"] == LAYOUTS[name][1]


def test_pp_stage_ranks_hold_their_stage(case, request):
    """Each stage rank's parameter bytes are at most total / S plus the
    largest block; the stages together hold the whole HMR once."""
    from poserisk_release_tpu_torch.parallel.pipeline import _BLOCKS

    sd = case[1]
    _work, ranks = layout(request, "dp2_pp2")
    total = sum(v.numel() * v.element_size() for v in sd.values())
    largest = max(sum(v.numel() * v.element_size() for k, v in sd.items()
                      if k.startswith(f"layer{L}.{i}.")) for L, i in _BLOCKS)
    per_rank = [r["param_bytes"] for r in ranks]
    assert all(b <= total / 2 + largest for b in per_rank), (per_rank, total, largest)
    assert per_rank[0] + per_rank[1] == total  # ranks 0, 1: stages 0, 1 of data rank 0


def test_pp_composes_with_pose_stride_and_rounds_buckets(request):
    _work, ranks = layout(request, "dp2_pp2")
    r = ranks[0]
    assert r["stride2_chunk"] % (2 * 2 * 2) == 0
    for got, want in zip(r["stride2"][:2], r["stride2_single"][:2]):
        assert got.shape == want.shape == (16, 24, 3)
        np.testing.assert_allclose(got, want, atol=1e-3)
    ladder, res = r["serving"]
    assert ladder == (4,) and all(1 <= s <= 12 for s in res)
    assert all(x["serving"][0] == (4,) for x in ranks)


def test_ep_gender_switch_and_dense_dispatch(request):
    _work, ranks = layout(request, "ep4")
    for r in ranks:
        np.testing.assert_allclose(r["male"][1], r["male_single"][1], atol=1e-3)
        assert r["unknown_raises"]
        np.testing.assert_allclose(r["routed"], r["serial"], atol=1e-6)
    # The gendered models differ, so the male joints are not the neutral ones.
    assert np.abs(ranks[0]["male"][1] - ranks[0]["result"][1]).max() > 1.0
    ladder, res = ranks[0]["serving"]
    assert ladder == (1, 4) and all(1 <= s <= 12 for s in res)


def test_dp_predictor_writes_from_rank_zero_only(request):
    """Rank 0's result txts and CSVs are byte-equal to a single-rank run's;
    rank 1 writes no file and returns the same summary."""
    work, ranks = layout(request, "dp2")
    want = ranks[0]["single_summary"]
    assert want is not None
    for name in RESULT_FILES:
        assert filecmp.cmp(work / "predictor_rank0" / name, work / "single" / name,
                           shallow=False), name
    assert not osp.exists(work / "predictor_rank1")
    assert ranks[0]["summary"] == ranks[1]["summary"] == want


def test_score_histogram_psum_matches_jax(request):
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from poserisk_release_tpu.parallel.spmd import make_axes_mesh
    from poserisk_release_tpu.throughput import score_histogram_psum as jax_psum

    _work, ranks = layout(request, "dp2")
    local = np.concatenate([r["local_scores"] for r in ranks]).astype(np.int32)
    mesh = make_axes_mesh({"data": 2})
    want = shard_map(lambda s: jax_psum(s, "data"), mesh=mesh, in_specs=P("data"),
                     out_specs=P(), check_vma=False)(jnp.asarray(local))
    for r in ranks:
        np.testing.assert_array_equal(r["hist"], np.asarray(jax.device_get(want)))
    assert ranks[0]["hist"].sum() == local.size


def test_dp_server_matches_single_device_server(request):
    """tests/test_serving.py::test_serving_data_parallel_buckets and the
    data axis's quantum (buckets 1, 4 round to 2, 4): scores equal, Euler
    within the sharded step's class (2e-3 deg, as there)."""
    _work, ranks = layout(request, "dp2")
    for r in ranks:
        assert r["serving"][0] == (2, 4)
    served = ranks[0]["serving"][1]
    assert len(served) == 4
    for plain, dp, d_euler, _euler in served:
        assert plain == dp
        assert d_euler < 2e-3


@pytest.mark.parametrize("key,tol", [("fast", 1e-3), ("int8", 5e-3)])
def test_sp_fast_and_int8_match_the_single_device_estimator(key, tol, request):
    """dp 2 x sp 2 in bf16, and with the int8 backbone (the single device
    given the ranks' quantized backbone): scores equal, Euler and joints
    within 1e-3 in bf16. The int8 backbone re-quantizes each conv's input,
    so a float conv summed in another order on a row window can move an
    activation across a rounding step (1e-4 to 2e-3 mm of joint seen on
    these frames): it takes the float layouts' 5e-3."""
    _work, ranks = layout(request, "dp2_sp2")
    (euler, joints, _aa), (w_euler, w_joints, _waa) = ranks[0][key]
    for other in ranks[1:]:
        for a, b in zip(ranks[0][key][0], other[key][0]):
            np.testing.assert_array_equal(a, b)
    assert scores("torch", euler) == scores("torch", w_euler)
    d = np.abs(euler - w_euler)
    np.testing.assert_array_less(np.minimum(d, 360.0 - d), tol)
    np.testing.assert_allclose(joints, w_joints, atol=tol)


def test_sp_composes_with_pose_stride(request):
    """pose_stride 2 under dp 2 x sp 2: the anchors' gather and slerp run
    over the data axis only (production_chunk folds data x stride), equal
    to the single device within the layout's tolerance."""
    _work, ranks = layout(request, "dp2_sp2")
    r = ranks[0]
    tol = PORT_VS_JAX + LAYOUTS["dp2_sp2"][2]
    for got, want in zip(r["stride2"][:2], r["stride2_single"][:2]):
        assert got.shape == want.shape == (16, 24, 3)
        np.testing.assert_allclose(got, want, atol=tol)
    for other in ranks[1:]:
        for a, b in zip(r["stride2"], other["stride2"]):
            np.testing.assert_array_equal(a, b)


def assert_csv_close(got_path, want_path, tol):
    """Two CSVs cell for cell: the same text around the numbers, integers
    equal, floats within tol."""
    import csv
    import re

    number = re.compile(r"-?\d+(?:\.\d*)?(?:[eE][-+]?\d+)?")
    with open(got_path) as f:
        got = list(csv.reader(f))
    with open(want_path) as f:
        want = list(csv.reader(f))
    assert len(got) == len(want)
    for g_row, w_row in zip(got, want):
        assert len(g_row) == len(w_row)
        for g, w in zip(g_row, w_row):
            assert number.sub("#", g) == number.sub("#", w), (g, w)
            for a, b in zip(number.findall(g), number.findall(w)):
                if re.fullmatch(r"-?\d+", a) and re.fullmatch(r"-?\d+", b):
                    assert a == b, (g, w)
                else:
                    assert abs(float(a) - float(b)) <= tol, (g, w)


def test_sp_predictor_writes_from_rank_zero_only(request):
    """dp 2 x sp 2: rank 0's result txts are byte-equal to the single-rank
    Predictor's (the dp2 world's, at the same batch shapes); in its debug
    CSVs the integer columns are equal and the floats, which row sharding
    moves, lie within the layout's tolerance; the other ranks write no file
    and return rank 0's summary."""
    work, ranks = layout(request, "dp2_sp2")
    single_work, single_ranks = layout(request, "dp2")
    tol = PORT_VS_JAX + LAYOUTS["dp2_sp2"][2]
    for name in RESULT_FILES:
        got, want = work / "predictor_rank0" / name, single_work / "single" / name
        if name.endswith(".txt"):
            assert filecmp.cmp(got, want, shallow=False), name
        else:
            assert_csv_close(got, want, tol)
    for r in range(1, 4):
        assert not osp.exists(work / f"predictor_rank{r}")
        assert ranks[r]["summary"] == ranks[0]["summary"]
    assert ranks[0]["summary"] == single_ranks[0]["single_summary"]


def test_sp_server_matches_single_device_server(request):
    """The server under dp 2 x sp 2: the spatial axis is a no-op on the
    bucket step (whole rows, as the JAX server); buckets round to the data
    axis; against the dp2 world's single-device server on the same
    requests, scores equal and Euler within the data-parallel server's
    2e-3."""
    _work, ranks = layout(request, "dp2_sp2")
    _work, single_ranks = layout(request, "dp2")
    for r in ranks:
        assert r["serving"][0] == (2, 4)
    served = ranks[0]["serving"][1]
    assert len(served) == 2
    for (scores_sp, euler_sp), (plain, _dp, _d, euler) in zip(served,
                                                             single_ranks[0]["serving"][1]):
        assert scores_sp == plain
        assert float(np.abs(euler_sp - euler).max()) < 2e-3


@pytest.mark.parametrize("name", ["dp2", "dp2_sp2"])
def test_streaming_under_a_mesh_matches_jax_single_device(name, case, request):
    """tests/test_edge_integration.py::test_streaming_on_mesh: the
    StreamingScorer on a mesh scores the edge clip as the JAX package's
    single-device scorer does, on every rank; rank 0 alone writes."""
    stream_ref = case[3]
    work, ranks = layout(request, name)
    for rank, r in enumerate(ranks):
        got = r["streaming"]
        assert got["total"] == stream_ref["total"] == 12
        assert got["frames"] == stream_ref["frames"]
        assert got["reba"] == stream_ref["reba"] and got["rula"] == stream_ref["rula"]
        assert got["summary"] == ranks[0]["streaming"]["summary"]
        assert got["wrote"] == (rank == 0)
    assert (work / "stream_rank0" / "reba_result.txt").is_file()
