"""The weight bridge between the JAX package's Flax SPIN tree and the port.

A Flax tree from the JAX package's init_spin_params converts to the port's
HMR state_dict and back without changing a value (float32, the dtype the
JAX HMR computes in); a torch checkpoint with nkolot/SPIN's names (the
randomized TorchHMR oracle) loads straight into the port's HMR; and
load_spin_variables resolves checkpoint -> npz cache exactly as the JAX
package does, writing a cache the JAX package reads back.
"""

import jax
import numpy as np
import pytest
import torch

from poserisk_release_tpu.models import convert as jax_convert
from poserisk_release_tpu.models.spin import init_spin_params as jax_init_spin
from poserisk_release_tpu.models.spin import load_mean_params as jax_mean
from poserisk_release_tpu_torch.config import default_config
from poserisk_release_tpu_torch.models import convert
from poserisk_release_tpu_torch.models.spin import HMR, init_spin_params, load_mean_params
from poserisk_release_tpu_torch.pipeline import load_spin_variables
from tests.oracles.torch_hmr import randomized_torch_hmr


@pytest.fixture(scope="module")
def flax_vars():
    return jax.tree_util.tree_map(np.asarray, jax_init_spin(jax.random.PRNGKey(0), jax_mean("")))


def test_flax_tree_round_trips_through_the_state_dict(flax_vars):
    state = convert.flax_to_state_dict(flax_vars)
    model = HMR()
    model.load_state_dict(state)  # strict: every key present, none extra
    back = convert.spin_state_dict_to_flax(model.state_dict())
    want, got = convert.flatten_tree(flax_vars), convert.flatten_tree(back)
    assert set(want) == set(got)
    for key in want:
        # The JAX tree may hold float64 leaves under x64 (the stem kernel's
        # default param dtype); the JAX HMR computes them in float32.
        np.testing.assert_array_equal(got[key], want[key].astype(np.float32), err_msg=key)


def test_layouts(flax_vars):
    state = convert.flax_to_state_dict(flax_vars)
    p, s = flax_vars["params"], flax_vars["batch_stats"]
    np.testing.assert_array_equal(
        state["layer2.0.conv2.weight"].numpy(),
        np.transpose(p["backbone"]["layer2_0"]["conv2"]["kernel"], (3, 2, 0, 1)))
    np.testing.assert_array_equal(state["fc1.weight"].numpy(), p["fc1"]["kernel"].T)
    np.testing.assert_array_equal(
        state["layer3.0.downsample.1.running_var"].numpy(),
        s["backbone"]["layer3_0"]["downsample_bn"]["var"])
    np.testing.assert_array_equal(state["init_pose"].numpy(), p["init_pose"])


def test_torch_checkpoint_loads_straight_into_hmr():
    mean = load_mean_params("")
    oracle = randomized_torch_hmr(mean, seed=3)
    model = HMR(mean_params=mean)
    model.load_state_dict(oracle.state_dict())
    model.eval()
    x = torch.as_tensor(np.random.RandomState(0).rand(2, 224, 224, 3).astype(np.float32))
    with torch.no_grad():
        want = oracle(x.permute(0, 3, 1, 2).contiguous())
        got = model(x)
    # Same weights and ops; only the conv input's memory layout differs
    # (the port feeds an NHWC view), which reorders f32 accumulation.
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5)


def test_load_spin_variables_converts_and_caches(tmp_path):
    mean = load_mean_params("")
    state = init_spin_params(torch.Generator().manual_seed(5), mean)
    ckpt = tmp_path / "model_checkpoint.pt"
    # SPIN saves {'model': state_dict}; DataParallel adds 'module.' and the
    # init_* buffers may be absent (filled from the mean params).
    torch.save({"model": {"module." + k: v for k, v in state.items()
                          if not k.startswith("init_")}}, ckpt)
    cfg = default_config().replace(SPIN={"checkpoint": str(ckpt)})

    loaded = load_spin_variables(cfg)
    assert set(loaded) == set(state)
    for key in state:
        torch.testing.assert_close(loaded[key], state[key], rtol=0, atol=0, msg=key)

    npz = str(ckpt) + ".flax.npz"
    jax_cached = jax_convert.load_flax_variables(npz)
    np.testing.assert_array_equal(jax_convert.cached_source_stamp(npz),
                                  convert.source_stamp(str(ckpt)))
    np.testing.assert_array_equal(
        jax_cached["params"]["backbone"]["conv1"]["kernel"],
        np.transpose(state["conv1.weight"].numpy(), (2, 3, 1, 0)))

    ckpt.unlink()  # the cache alone now serves the weights
    again = load_spin_variables(cfg)
    for key in state:
        torch.testing.assert_close(again[key], state[key], rtol=0, atol=0, msg=key)


def test_random_init_is_seeded():
    a = init_spin_params(torch.Generator().manual_seed(0), load_mean_params(""))
    b = init_spin_params(torch.Generator().manual_seed(0), load_mean_params(""))
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = init_spin_params(torch.Generator().manual_seed(1), load_mean_params(""))
    assert not torch.equal(a["conv1.weight"], c["conv1.weight"])
