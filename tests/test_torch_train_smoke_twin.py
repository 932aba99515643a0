"""One train step of the first half of ``ARCH_IDS`` under ``reduced``
against the reference's from the same state (ROADMAP A14b); the second
half, the tolerances and their reasons are in ``test_torch_train_smoke.py``
(split so that two test workers share the twins)."""
import pytest

from repro.configs import ARCH_IDS

from lm_twins import one_torch_thread  # noqa: F401  (autouse)
from test_torch_train_smoke import train_step_twin


@pytest.mark.parametrize("arch", ARCH_IDS[:len(ARCH_IDS) // 2])
def test_train_step_twin(arch):
    train_step_twin(arch)
