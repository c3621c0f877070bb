"""The port's flow-matching train step against ``fmdm_tpu.train.common``'s
on the CPU in f32: the reduced flagship topology, grad_accum 1 and 2, JAX's
noise and t injected (see ``test_torch_denoise_train.py``, whose check this
file runs for the flow-matching variant)."""

import pytest

from tests.test_torch_denoise_train import check_train_step_against_jax, few_torch_threads  # noqa: F401


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_flow_matching_train_step_matches_jax_over_two_steps(grad_accum):
    check_train_step_against_jax("flow_matching", grad_accum)
