"""The port's whole step against the JAX oracle on the physics matrix
(cases A-J of test_torch_common.CASES), CPU, f64, 2 steps each.

Every route of the port must equal `ekpnp.step.step_jit` at rtol=1e-11,
atol=1e-13, the tolerance tests/test_pallas_fused.py holds the Pallas
kernel to: the plain step (ekpnp_torch.step); the kernel-path step
(`kernels.step.step_fused`, whose fused step runs its plain version on CPU
tensors), which takes the hartley_x form wherever EK is on; and the
default kernel-path `multi_step`, which carries phi as psi_hx across the
chunk wherever the phi_hx gate holds.  One JAX run serves all three.
"""
import numpy as np
import pytest

from test_torch_common import (CASES, FIELDS, assert_fields_close, configs,
                               jax_steps, make_state_np, port_state, to_np)

STEPS = 2


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_steps_match_jax_oracle(case):
    from ekpnp_torch.kernels.fused_step import resolve_hartley_x
    from ekpnp_torch.kernels.step import (multi_step as fused_multi_step,
                                          phi_hx_capable, step_fused)
    from ekpnp_torch.step import multi_step

    jcfg, tcfg = configs(case)
    arrays = make_state_np(jcfg, seed=11)
    want = jax_steps(jcfg, arrays, STEPS)
    ek = tcfg.physics.enable_ek
    assert resolve_hartley_x(tcfg) == ek and phi_hx_capable(tcfg) == ek

    plain = multi_step(tcfg, port_state(tcfg, arrays), STEPS)
    assert_fields_close(want, {k: to_np(getattr(plain, k)) for k in FIELDS},
                        label=f"{case} plain step: ")
    st = port_state(tcfg, arrays)
    for _ in range(STEPS):
        st, _ = step_fused(tcfg, st)
    assert_fields_close(want, {k: to_np(getattr(st, k)) for k in FIELDS},
                        label=f"{case} kernel-path step (hartley_x={ek}): ")
    # last: multi_step donates the buffers of its input state
    fused = fused_multi_step(tcfg, port_state(tcfg, arrays), STEPS)
    assert_fields_close(want, {k: to_np(getattr(fused, k)) for k in FIELDS},
                        label=f"{case} kernel-path chunk (phi_hx={ek}): ")
    np.testing.assert_allclose(float(fused.t), STEPS * jcfg.dt, rtol=1e-15)
