"""One torch intra-op thread for a test module of the PyTorch port.

The tier-1 run puts six xdist workers on the host's cores, and torch takes
a thread per core in each of them by default. Every port test file imports
the fixture below, which pins torch to one thread for that module and gives
the count back after it, so the JAX package's test files keep torch's
default:

    from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

The spawned ranks of tests/test_torch_*_ranks.py never run this fixture and
pin themselves in their rank_main.

tests/test_torch_pipeline.py alone does not import it.
test_outputs_byte_equal_to_jax and test_cli_writes_the_same_files compare
debug/pose_log.csv, whose angles are printed to 3 decimals, byte for byte
with the JAX package's. The two packages' angles differ by float rounding,
and the port's rounding depends on torch's thread count: the first op to
differ is the IEF head's fc1, a matrix product whose CPU kernel splits its
sums by thread, and at one thread two of the clip's angles print one last
digit off. So those checks hold at torch's default count only.
tests/test_torch_imports.py holds every other port test file to the import.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
