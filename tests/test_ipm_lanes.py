"""Plane-layout IPM (solver/ipm_lanes) vs the row-layout reference backend.

The lanes path must reproduce the rows path's SOLUTIONS (not its float32
iteration chaos): near-identical optimal costs on feasible scenarios, and
violations in the same or better class.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mav_tube_trajectory_generation.solver import ipm, ipm_lanes, qcqp
from mav_tube_trajectory_generation.solver.structure import (
    free_interior_mask, make_structure)
from mav_tube_trajectory_generation.models.vertex import (
    segment_times_nfabian)


K, N, D = 10, 10, 3


@pytest.fixture(scope="module")
def scenario_batch():
    rng = np.random.RandomState(11)
    b = 8
    waypoints = np.cumsum(rng.uniform(0.5, 2.0, size=(b, K + 1, 3)),
                          axis=1).astype(np.float32)
    free = make_structure(free_interior_mask(K + 1, N), D, N)
    values = np.zeros((b, K + 1, 5, 3), dtype=np.float32)
    values[:, :, 0, :] = waypoints
    times = np.asarray(segment_times_nfabian(waypoints, 3.0, 5.0),
                       dtype=np.float32)
    radii = np.full((b, K, 2), 0.8, dtype=np.float32)
    from mav_tube_trajectory_generation.solver import linear
    df = np.asarray(linear.extract_fixed_values(free, jnp.asarray(values)),
                    dtype=np.float32)
    admm = qcqp.ADMMConfig(rho=0.005, n_stages=1, n_iters=48,
                           rho_tube_factor=0.125, rho_half_factor=0.125,
                           padded_lanes=True)
    a = qcqp.solve_qcqp_batch(free, df, jnp.asarray(times),
                              jnp.asarray(waypoints), jnp.asarray(radii),
                              config=admm, warmstart_values=values,
                              scenario_block=4)
    return (free, jnp.asarray(df), jnp.asarray(times),
            jnp.asarray(waypoints), jnp.asarray(radii), a)


@pytest.mark.slow
def test_lanes_matches_rows_solutions(scenario_batch):
    """Warm-started lanes IPM lands on the rows backend's optima: median
    cost within 0.1%, worst within 1% (both f32 endgames are chaotic -- the
    iterates differ, the optima must not)."""
    free, df, times, waypoints, radii, a = scenario_batch
    cfg = ipm.IPMConfig(n_iters=10)
    rows = jax.vmap(lambda *xs: ipm.solve_qcqp_ipm(
        free, xs[0], xs[1], xs[2], xs[3], config=cfg, x0=xs[4],
        lam0_ball=xs[5], lam0_half=xs[6]))(
        df, times, waypoints, radii, a.d_free, a.dual_ball, a.dual_half)
    lanes = ipm_lanes.solve_qcqp_ipm_lanes(
        free, df, times, waypoints, radii, config=cfg, x0=a.d_free,
        lam0_ball=a.dual_ball, lam0_half=a.dual_half, scenario_block=4)
    rel = np.abs(np.asarray(lanes.cost) - np.asarray(rows.cost)) \
        / np.asarray(rows.cost)
    assert np.median(rel) < 1e-3, rel
    assert rel.max() < 1e-2, rel
    # The polish must not give BACK feasibility vs the ADMM start.
    assert float(np.median(np.asarray(lanes.max_violation))) < \
        max(2.0 * float(np.median(np.asarray(a.max_violation))), 1e-4)


@pytest.mark.slow
def test_lanes_improves_admm_tail(scenario_batch):
    """The safeguarded lanes endgame keeps every scenario under the 1e-3
    class and the median in the 1e-4 class (the rows path relies on
    best-iterate luck and has a fatter tail on this seed)."""
    free, df, times, waypoints, radii, a = scenario_batch
    lanes = ipm_lanes.solve_qcqp_ipm_lanes(
        free, df, times, waypoints, radii, config=ipm.IPMConfig(n_iters=10),
        x0=a.d_free, lam0_ball=a.dual_ball, lam0_half=a.dual_half,
        scenario_block=4)
    v = np.asarray(lanes.max_violation)
    assert v.max() < 3e-3, v
    assert np.median(v) < 2e-4, v


@pytest.mark.slow
def test_lanes_cold_start_runs(scenario_batch):
    free, df, times, waypoints, radii, _ = scenario_batch
    lanes = ipm_lanes.solve_qcqp_ipm_lanes(
        free, df, times, waypoints, radii,
        config=ipm.IPMConfig(n_iters=25), scenario_block=4)
    v = np.asarray(lanes.max_violation)
    assert np.isfinite(np.asarray(lanes.cost)).all()
    assert np.median(v) < 1e-2, v


@pytest.mark.slow
def test_lanes_scenario_block_invariance(scenario_batch):
    """S-blocking is a layout choice, not a semantic one."""
    free, df, times, waypoints, radii, a = scenario_batch
    cfg = ipm.IPMConfig(n_iters=6)
    kw = dict(config=cfg, x0=a.d_free, lam0_ball=a.dual_ball,
              lam0_half=a.dual_half)
    s4 = ipm_lanes.solve_qcqp_ipm_lanes(
        free, df, times, waypoints, radii, scenario_block=4, **kw)
    s2 = ipm_lanes.solve_qcqp_ipm_lanes(
        free, df, times, waypoints, radii, scenario_block=2, **kw)
    np.testing.assert_allclose(np.asarray(s4.cost), np.asarray(s2.cost),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(s4.d_free), np.asarray(s2.d_free),
                               atol=1e-5)


@pytest.mark.slow
def test_lanes_static_infeasibility_certificate(scenario_batch):
    """A fixed start state far outside the corridor makes constant
    constraint rows violated: the static certificate must fire."""
    free, df, times, waypoints, radii, _ = scenario_batch
    df_bad = np.asarray(df).copy()
    # Push the start position 5 units off every axis: the early control
    # points depend only on fixed start derivatives.
    df_bad[:, 0, :] += 5.0
    tiny = np.full_like(np.asarray(radii), 0.05)
    lanes = ipm_lanes.solve_qcqp_ipm_lanes(
        free, jnp.asarray(df_bad), times, waypoints, jnp.asarray(tiny),
        config=ipm.IPMConfig(n_iters=8), scenario_block=4)
    assert bool(np.asarray(lanes.infeasible).all())


def test_finite_step_mask_catches_nan_directions():
    """A NaN Newton direction yields a *finite* alpha (NaN < 0 is False in
    the fraction-to-boundary ratios -> all inf -> alpha = 1.0), so the
    update gate must check the direction itself -- an isfinite(alpha) guard
    never fires (the advisor-verified failure mode)."""
    b, m = 3, 7
    ds = jnp.ones((b, m), jnp.float32)
    dlam = jnp.ones((b, m), jnp.float32)
    ds = ds.at[1].set(jnp.nan)           # scenario 1: blown-up direction
    dlam = dlam.at[2, 4].set(jnp.inf)    # scenario 2: one inf entry
    # Reproduce the alpha a NaN direction produces through max_step.
    v = jnp.full((b, m), 0.5, jnp.float32)
    ratio = jnp.where(ds < 0, -v / jnp.where(ds < 0, ds, -1.0), jnp.inf)
    alpha = jnp.minimum(1.0, 0.995 * jnp.min(ratio, axis=-1, keepdims=True))
    assert bool(jnp.isfinite(alpha).all())   # the old guard would pass NaNs
    upd = ipm_lanes._finite_step_mask(alpha, ds, dlam)
    np.testing.assert_array_equal(np.asarray(upd[:, 0]),
                                  [True, False, False])


@pytest.mark.slow
def test_lanes_internal_batch_padding(scenario_batch):
    """A batch that is not a scenario_block multiple is padded internally
    and the outputs sliced back -- same contract as solve_qcqp_batch."""
    free, df, times, waypoints, radii, a = scenario_batch
    cfg = ipm.IPMConfig(n_iters=4)
    kw = dict(config=cfg, x0=a.d_free, lam0_ball=a.dual_ball,
              lam0_half=a.dual_half)
    full = ipm_lanes.solve_qcqp_ipm_lanes(
        free, df, times, waypoints, radii, scenario_block=4, **kw)
    kw5 = dict(config=cfg, x0=a.d_free[:5], lam0_ball=a.dual_ball[:5],
               lam0_half=a.dual_half[:5])
    part = ipm_lanes.solve_qcqp_ipm_lanes(
        free, df[:5], times[:5], waypoints[:5], radii[:5],
        scenario_block=4, **kw5)
    assert part.cost.shape == (5,)
    np.testing.assert_allclose(np.asarray(part.cost),
                               np.asarray(full.cost[:5]), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(part.d_free),
                               np.asarray(full.d_free[:5]), atol=1e-5)


def _random_eval_inputs(s_blk=2, nfd=30, nb_p=128, nh_p=128, seed=0):
    rng = np.random.RandomState(seed)
    m_p = 3 * nb_p + nh_p
    f = lambda a: jnp.asarray(a.astype(np.float32))
    return dict(
        gt=f(rng.randn(s_blk, nfd, m_p)), b=f(rng.randn(s_blk, 1, m_p)),
        rb=f(rng.uniform(0.5, 2.0, (s_blk, 1, nb_p))),
        x=f(rng.randn(s_blk, nfd, 1)),
        s=f(rng.uniform(0.1, 2.0, (s_blk, 1, m_p))),
        lam=f(rng.uniform(0.0, 1.0, (s_blk, 1, m_p)))), nb_p


@pytest.mark.parametrize("phr", [False, True])
def test_gram_band_matches_full_eval_core_gram(phr):
    """ipm_eval_step's per-block Gram band equals the band sliced from the
    full weighted Gram that _eval_core's factors define, and its other
    outputs are _eval_core's."""
    from mav_tube_trajectory_generation.ops import ipm_eval
    args, nb_p = _random_eval_inputs()
    blk, n_ball = 15, 17
    y, c, jtwr2, jts, gd, gu = ipm_eval.ipm_eval_step(
        **args, nb_p=nb_p, n_ball=n_ball, band_block=blk, w_cap=1e6,
        phr=phr)
    y2, c2, jtwr22, jts2, lam_ball, aj, w_aj = ipm_eval._eval_core(
        *args.values(), nb_p=nb_p, n_ball=n_ball, w_cap=1e6, phr=phr)
    gt = np.asarray(args["gt"], np.float64)
    full = (np.einsum('snm,som->sno', gt * np.asarray(lam_ball), gt)
            + np.einsum('snm,som->sno', np.asarray(aj * w_aj),
                        np.asarray(aj)))
    m_blk = gt.shape[1] // blk
    assert gd.shape == (2, m_blk, blk, blk)
    assert gu.shape == (2, m_blk - 1, blk, blk)
    for i in range(m_blk):
        sl = slice(i * blk, (i + 1) * blk)
        np.testing.assert_allclose(np.asarray(gd[:, i]), full[:, sl, sl],
                                   rtol=1e-4, atol=1e-3)
        if i + 1 < m_blk:
            sl2 = slice((i + 1) * blk, (i + 2) * blk)
            np.testing.assert_allclose(np.asarray(gu[:, i]),
                                       full[:, sl, sl2],
                                       rtol=1e-4, atol=1e-3)
    for a, b_ in ((y, y2), (c, c2), (jtwr2, jtwr22), (jts, jts2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b_))


def test_lanes_snap_only_schedule():
    """n_iters=0 (the strict router's tier-0 snap): the scan path runs the
    snap sweeps alone, with the dynamic certificate off (no Newton
    history), and does not give back feasibility vs its start."""
    k = 4
    rng = np.random.RandomState(5)
    b = 4
    wp = np.cumsum(rng.uniform(0.5, 2.0, size=(b, k + 1, 3)),
                   axis=1).astype(np.float32)
    free = make_structure(free_interior_mask(k + 1, N), D, N)
    vals = np.zeros((b, k + 1, 5, 3), np.float32)
    vals[:, :, 0, :] = wp
    times = jnp.asarray(segment_times_nfabian(wp, 3.0, 5.0), jnp.float32)
    radii = jnp.full((b, k, 2), 0.8, jnp.float32)
    from mav_tube_trajectory_generation.solver import linear
    df = jnp.asarray(linear.extract_fixed_values(free, jnp.asarray(vals)),
                     jnp.float32)
    admm = qcqp.ADMMConfig(rho=0.005, n_stages=1, n_iters=24,
                           rho_tube_factor=0.125, rho_half_factor=0.125,
                           padded_lanes=True)
    a = qcqp.solve_qcqp_batch(free, df, times, jnp.asarray(wp), radii,
                              config=admm, warmstart_values=vals,
                              scenario_block=2)
    snap = ipm_lanes.solve_qcqp_polished_batch(
        free, df, times, jnp.asarray(wp), radii, admm_config=admm,
        ipm_config=ipm.IPMConfig(n_iters=0, snap_iters=2, sigma_min=0.3,
                                 corrector=False),
        warmstart_values=vals, scenario_block=2)
    v0 = np.asarray(a.max_violation)
    v = np.asarray(snap.max_violation)
    assert np.isfinite(np.asarray(snap.cost)).all()
    assert not np.asarray(snap.infeasible).any()
    assert (v <= np.maximum(v0, 0.0) + 1e-6).all(), (v, v0)
