"""The port's whole step against the JAX oracle on the physics matrix
(cases A-J of test_torch_common.CASES), CPU, f64, 2 steps each.

Both the plain step (ekpnp_torch.step) and the kernel-path step
(ekpnp_torch.kernels.step, whose fused step runs its plain version on CPU
tensors) must equal `ekpnp.step.step_jit` at rtol=1e-11, atol=1e-13, the
tolerance tests/test_pallas_fused.py holds the Pallas kernel to.
"""
import numpy as np
import pytest

from test_torch_common import (CASES, FIELDS, assert_fields_close, configs,
                               jax_steps, make_state_np, port_state, to_np)

STEPS = 2


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_steps_match_jax_oracle(case):
    from ekpnp_torch.kernels.step import multi_step as fused_multi_step
    from ekpnp_torch.step import multi_step

    jcfg, tcfg = configs(case)
    arrays = make_state_np(jcfg, seed=11)
    want = jax_steps(jcfg, arrays, STEPS)

    plain = multi_step(tcfg, port_state(tcfg, arrays), STEPS)
    assert_fields_close(want, {k: to_np(getattr(plain, k)) for k in FIELDS},
                        label=f"{case} plain step: ")
    fused = fused_multi_step(tcfg, port_state(tcfg, arrays), STEPS)
    assert_fields_close(want, {k: to_np(getattr(fused, k)) for k in FIELDS},
                        label=f"{case} kernel-path step: ")
    np.testing.assert_allclose(float(fused.t), STEPS * jcfg.dt, rtol=1e-15)

