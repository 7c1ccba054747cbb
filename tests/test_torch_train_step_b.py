"""The port's train step against the JAX package's for the last five of the
ten smoke archs (the first five and the method: ``test_torch_train_step_a.py``)."""
import pytest

from repro_torch.configs import ARCHS
from test_torch_train_step_a import check_train_step

ARCHS_B = sorted(ARCHS)[5:]


@pytest.mark.parametrize("arch", ARCHS_B)
def test_train_step_matches_jax(arch):
    check_train_step(arch)
