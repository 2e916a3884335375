"""External ground truth on a small slice: scipy SLSQP (an independent
f64 SQP implementation) must agree with the repo's f64 ADMM+IPM on
verdicts and optima (round-2 VERDICT missing #1; the full 384-scenario
study lives in benchmarks/external_parity.py + its recorded json).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import sys
import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmarks.external_parity import (min_violation, scenario_tensors,
                                        solve_scipy)
import bench
from mav_tube_trajectory_generation.solver import ipm, linear, qcqp

pytestmark = pytest.mark.slow   # ~16 scipy solves + an f64 polished batch


def test_external_slsqp_agrees_on_slice():
    k, n = 10, 16
    (_, free, _, df, t, w, _, _) = bench.make_inputs(k, n, seed=9)
    df = np.array(df, np.float64)
    t = np.array(t, np.float64)
    w = np.array(w, np.float64)
    # 4 scenarios per radius bucket; scenario 0 forced infeasible.
    scale = np.repeat([0.6, 0.4, 0.2, 0.08], 4)
    radii = np.broadcast_to(scale[:, None, None], (n, k, 2)).copy()
    off = np.array([1.0, 0.0, 0.0])
    df[0, 0, :] += off * scale[0] * 5.0

    admm_cfg = qcqp.ADMMConfig(rho=0.005, n_stages=1, n_iters=48,
                               rho_tube_factor=0.125,
                               rho_half_factor=0.125, padded_lanes=False)
    gt = jax.jit(jax.vmap(lambda d1, d2, d3, d4: ipm.solve_qcqp_polished(
        free, d1, d2, d3, d4, admm_config=admm_cfg,
        ipm_config=ipm.IPMConfig(n_iters=30))))(
        jnp.asarray(df), jnp.asarray(t), jnp.asarray(w),
        jnp.asarray(radii))
    gt_feas = np.asarray(gt.max_violation) < 1e-4
    gt_inf = np.asarray(gt.infeasible) & ~gt_feas

    ws = jax.jit(jax.vmap(lambda d1, d2: linear.solve_free_derivatives(
        free, d1, d2)))(jnp.asarray(df), jnp.asarray(t))
    x0 = np.asarray(ws).reshape(n, -1)

    cost_sp = np.zeros(n)
    sp_feas = np.zeros(n, bool)
    for i in range(n):
        data = scenario_tensors(free, df[i], t[i], w[i], radii[i])
        x, _, viol, _ = solve_scipy(data, x0[i])
        sp_feas[i] = viol < 1e-6
        if sp_feas[i]:
            cost_sp[i] = float(linear.solve_linear_with_free(
                free, jnp.asarray(df[i]), jnp.asarray(x.reshape(-1, 3)),
                jnp.asarray(t[i])).cost)
        else:
            # External infeasibility confirmation: the feasibility
            # minimization's optimum stays positive.
            assert min_violation(data, x0[i]) > 1e-16, i

    # Verdicts agree wherever the repo's ground truth is determined.
    det = gt_feas | gt_inf
    assert det.sum() >= 12   # the slice is mostly determinate
    np.testing.assert_array_equal(sp_feas[det], gt_feas[det])
    assert sp_feas[1:].all() and not sp_feas[0]
    # Optima agree on both-feasible scenarios (full-cost convention).
    both = sp_feas & gt_feas
    gap = np.abs(np.asarray(gt.cost)[both] - cost_sp[both]) \
        / np.abs(cost_sp[both])
    assert np.median(gap) < 1e-6, gap
    assert gap.max() < 2e-3, gap
