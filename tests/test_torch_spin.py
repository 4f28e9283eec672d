"""The port's HMR (ResNet-50 + 3-step IEF) against the JAX package's HMR.

Both run the same weights (the JAX package's init_spin_params tree, through
the weight bridge) on the same two crops, in float32 on the CPU. The
outputs agree to 5e-5: both are f32 forward passes of 53 convolutions and
a 3-step regressor whose accumulation order differs between XLA and
PyTorch's CPU kernels; the measured difference is about 5e-6, and 5e-5 is
far below the 1e-3 rad that moves an Euler angle by 0.06 deg.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poserisk_release_tpu.models.spin import HMR as JaxHMR
from poserisk_release_tpu.models.spin import init_spin_params, load_mean_params
from poserisk_release_tpu_torch.models.convert import flax_to_state_dict
from poserisk_release_tpu_torch.models.spin import HMR


@pytest.fixture(scope="module")
def shared():
    variables = jax.tree_util.tree_map(
        np.asarray, init_spin_params(jax.random.PRNGKey(0), load_mean_params("")))
    crops = np.random.RandomState(7).rand(2, 224, 224, 3).astype(np.float32)
    model = HMR()
    model.load_state_dict(flax_to_state_dict(variables))
    model.eval()
    return variables, crops, model


def test_hmr_matches_jax(shared):
    variables, crops, model = shared
    want = JaxHMR(n_iter=3).apply(variables, jnp.asarray(crops))
    with torch.no_grad():
        got = model(torch.as_tensor(crops))
    for name, g, w in zip(("rotmat", "betas", "camera"), got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-5, err_msg=name)


def test_bf16_backbone_keeps_head_in_f32(shared):
    _, crops, model = shared
    fast = HMR()
    fast.load_state_dict(model.state_dict())
    fast.eval().cast_backbone(torch.bfloat16)
    assert fast.conv1.weight.dtype == torch.bfloat16
    assert fast.fc1.weight.dtype == torch.float32
    with torch.no_grad():
        rot_fast, _, _ = fast(torch.as_tensor(crops).to(torch.bfloat16))
        rot, _, _ = model(torch.as_tensor(crops))
    assert rot_fast.dtype == torch.float32
    # bf16 keeps ~3 significant digits through 53 convolutions; the rotation
    # entries stay within a few hundredths (the JAX package's fast path
    # makes the same trade).
    assert float((rot_fast - rot).abs().max()) < 0.05
