"""Verdict router (solver/auto.solve_qcqp_auto): gate + selective IPM
escalation must reproduce the reference's Mosek-verdict semantics
(qcqp_impl.h:709-788) at every corridor width on a mixed batch.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mav_tube_trajectory_generation.solver import auto, ipm, linear, qcqp
from mav_tube_trajectory_generation.solver.structure import (
    free_interior_mask, make_structure)
from mav_tube_trajectory_generation.models.vertex import (
    segment_times_nfabian)

pytestmark = pytest.mark.slow  # ADMM batch + interpret lanes + f64 tier-2: minutes

K, N, D = 10, 10, 3


@pytest.fixture(scope="module")
def mixed_batch():
    """8 scenarios: generous corridors (pass the ADMM gate), tight ones
    (escalate, IPM-feasible), one structurally infeasible (escalates,
    certificate)."""
    rng = np.random.RandomState(5)
    b = 8
    waypoints = np.cumsum(rng.uniform(0.5, 2.0, size=(b, K + 1, 3)),
                          axis=1).astype(np.float32)
    free = make_structure(free_interior_mask(K + 1, N), D, N)
    values = np.zeros((b, K + 1, 5, 3), dtype=np.float32)
    values[:, :, 0, :] = waypoints
    times = np.asarray(segment_times_nfabian(waypoints, 3.0, 5.0),
                       dtype=np.float32)
    radii = np.full((b, K, 2), 0.8, dtype=np.float32)
    radii[2:5] = 0.12                      # tight: ADMM gate misses here
    df_clean = np.array(
        linear.extract_fixed_values(free, jnp.asarray(values)),
        dtype=np.float32)
    df = df_clean.copy()
    df[7, 0, :] += 5.0                     # start 5 units off the corridor
    radii[7] = 0.05
    return free, df, df_clean, times, waypoints, radii, values


def test_auto_routes_and_verdicts(mixed_batch):
    free, df, _, times, waypoints, radii, values = mixed_batch
    res = auto.solve_qcqp_auto(
        free, jnp.asarray(df), jnp.asarray(times), jnp.asarray(waypoints),
        jnp.asarray(radii), warmstart_values=jnp.asarray(values))
    # The generous-corridor rows pass the gate without escalation.
    assert not res.escalated[:2].any() and not res.escalated[5:7].any()
    # Tight corridors escalate and come back feasible by exhibition.
    assert res.escalated[2:5].all()
    assert (res.verdict[2:5] == auto.FEASIBLE).all(), res.verdict
    v = np.asarray(res.solution.max_violation)[2:5]
    assert (v < 1e-4).all(), v
    # The structurally infeasible row gets the certificate verdict.
    assert res.escalated[7]
    assert res.verdict[7] == auto.INFEASIBLE, res.verdict
    assert res.n_escalated == int(res.escalated.sum())


def test_auto_merged_solution_consistency(mixed_batch):
    """Escalated rows carry the IPM solution; non-escalated rows are the
    ADMM's (numerically identical -- the router jits the tier solve as one
    program, so fusion boundaries differ from a piecewise call and bitwise
    equality is not guaranteed)."""
    free, df, _, times, waypoints, radii, values = mixed_batch
    admm_cfg = qcqp.ADMMConfig(rho=0.005, n_stages=1, n_iters=48,
                               rho_tube_factor=0.125, rho_half_factor=0.125,
                               padded_lanes=True)
    a = qcqp.solve_qcqp_batch(free, jnp.asarray(df), jnp.asarray(times),
                              jnp.asarray(waypoints), jnp.asarray(radii),
                              config=admm_cfg,
                              warmstart_values=jnp.asarray(values),
                              scenario_block=4)
    res = auto.solve_qcqp_auto(
        free, jnp.asarray(df), jnp.asarray(times), jnp.asarray(waypoints),
        jnp.asarray(radii), admm_config=admm_cfg,
        warmstart_values=jnp.asarray(values))
    keep = ~res.escalated
    # Not bitwise: the router jits its tier solve as one program, and 48
    # f32 ADMM iterations amplify the fusion-boundary rounding differences
    # to the solver's own ~0.3% iteration-chaos level.  The contract is
    # same-quality ADMM solutions on the non-escalated rows.
    np.testing.assert_allclose(
        np.asarray(res.solution.cost)[keep], np.asarray(a.cost)[keep],
        rtol=2e-2)
    assert (np.asarray(res.solution.max_violation)[keep] < 1e-2).all()


def test_strict_router(mixed_batch):
    """solve_qcqp_strict: ADMM + snap tier-0 with IPM escalation at the
    1e-4 strict gate -- every feasible-corridor row ends under 1e-4, the
    infeasible row is certified, and verdicts are never false-feasible."""
    free, df, _, times, waypoints, radii, values = mixed_batch
    res = auto.solve_qcqp_strict(
        free, jnp.asarray(df), jnp.asarray(times), jnp.asarray(waypoints),
        jnp.asarray(radii), warmstart_values=jnp.asarray(values),
        tier2_f64=True)   # tight-corridor rows need the f64 tier on CPU
    v = np.asarray(res.solution.max_violation)
    feas_rows = [0, 1, 2, 3, 4, 5, 6]
    assert (res.verdict[feas_rows] == auto.FEASIBLE).all(), (res.verdict, v)
    assert (v[feas_rows] < 1e-4).all(), v
    assert res.verdict[7] == auto.INFEASIBLE, res.verdict


def test_auto_all_pass_no_escalation(mixed_batch):
    """A uniformly generous batch escalates nothing and returns the ADMM
    result object untouched."""
    free, _, df_clean, times, waypoints, radii, values = mixed_batch
    wide = np.full_like(radii, 0.8)
    res = auto.solve_qcqp_auto(
        free, jnp.asarray(df_clean), jnp.asarray(times),
        jnp.asarray(waypoints),
        jnp.asarray(wide), warmstart_values=jnp.asarray(values))
    assert res.n_escalated == 0
    assert (res.verdict == auto.FEASIBLE).all()
