"""The port's training loss and gradients against ``jax.grad`` of the
reference for the other half of ``ARCH_IDS`` (MoE, frontends, Mamba), with
the tolerances of ``test_torch_train_grads.py``: the loss and metrics within
1e-5, every gradient leaf within 2e-5 of its max |value|, and Falcon-Mamba
with ``remat`` bitwise without it.  On the CPU Mamba trains through the
plain selective scan (K10's plain version), as the reference trains
through its associative scan."""
import pytest

from repro_torch.configs import ARCH_IDS
from test_torch_train_grads import ARCHS as FIRST_HALF
from test_torch_train_grads import check_arch

ARCHS = [a for a in ARCH_IDS if a not in FIRST_HALF]


def test_halves_cover_every_arch():
    assert sorted(ARCHS + FIRST_HALF) == sorted(ARCH_IDS)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    check_arch(arch, remat_too=arch == "falcon_mamba_7b")
