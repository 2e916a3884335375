"""Fast-tier smoke coverage for the verdict router (solver/auto) -- the
flagship strict entry point must have signal in the DEFAULT test tier
(round-3 VERDICT weak #3: all of test_auto.py is slow-tier).

Small shapes (K=4, batch 8, XLA ADMM + interpret lanes with low iteration
counts) keep this in the seconds class while still driving the full router
pipeline: tier-0 gate, host gather/bucket, tier-1 escalation, the jitted
scatter-merge, and all three verdict codes.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mav_tube_trajectory_generation.solver import auto, linear, qcqp
from mav_tube_trajectory_generation.solver.ipm import IPMConfig
from mav_tube_trajectory_generation.solver.structure import (
    free_interior_mask, make_structure)
from mav_tube_trajectory_generation.models.vertex import (
    segment_times_nfabian)

K, N, D = 4, 10, 3


@pytest.fixture(scope="module")
def small_batch():
    """8 scenarios: generous corridors (gate-pass), tight ones (escalate),
    one structurally infeasible (escalate + certificate)."""
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
    radii[2:4] = 0.1                       # tight: the 24-iter gate misses
    df = np.array(linear.extract_fixed_values(free, jnp.asarray(values)),
                  dtype=np.float32)
    df[7, 0, :] += 5.0                     # start 5 units off the corridor
    radii[7] = 0.05
    return free, df, times, waypoints, radii, values


#: Light configs: enough ADMM for the generous rows to pass the 1e-2 gate,
#: few enough iterations that the tight rows escalate; XLA (use_pallas
#: =False) ADMM keeps the CPU path out of interpret-mode Pallas.
_ADMM = qcqp.ADMMConfig(rho=0.005, n_stages=1, n_iters=24,
                        rho_tube_factor=0.125, rho_half_factor=0.125,
                        padded_lanes=False)
_IPM = IPMConfig(n_iters=8, snap_iters=2, sigma_min=0.3, corrector=False)


def test_router_smoke_all_verdict_codes(small_batch):
    free, df, times, waypoints, radii, values = small_batch
    res = auto.solve_qcqp_auto(
        free, jnp.asarray(df), jnp.asarray(times), jnp.asarray(waypoints),
        jnp.asarray(radii), admm_config=_ADMM, ipm_config=_IPM,
        warmstart_values=jnp.asarray(values), tier2_f64=False)
    # Gate-pass rows: feasible without escalation.
    assert not res.escalated[:2].any() and not res.escalated[4:7].any()
    assert (res.verdict[[0, 1, 4, 5, 6]] == auto.FEASIBLE).all()
    # Tight rows escalate; the IPM pulls them under the strict gate
    # (FEASIBLE) or leaves them UNDETERMINED -- never INFEASIBLE (no
    # certificate exists for a nonempty corridor).
    assert res.escalated[2:4].all()
    assert (res.verdict[2:4] != auto.INFEASIBLE).all(), res.verdict
    # The structurally infeasible row is certified.
    assert res.escalated[7]
    assert res.verdict[7] == auto.INFEASIBLE, res.verdict
    assert res.n_escalated == int(res.escalated.sum())
    # Verdict/violation consistency: FEASIBLE-by-exhibition escalated rows
    # actually exhibit < strict_gate violation.
    v = np.asarray(res.solution.max_violation)
    esc_feas = res.escalated & (res.verdict == auto.FEASIBLE)
    assert (v[esc_feas] < 1e-4).all()


def test_router_merge_consistency(small_batch):
    """Non-escalated rows carry the tier-0 solution (same-quality, not
    bitwise -- jit fusion boundaries differ); escalated rows differ from
    the tier-0 result (they were re-solved)."""
    free, df, times, waypoints, radii, values = small_batch
    a = qcqp.solve_qcqp_batch(free, jnp.asarray(df), jnp.asarray(times),
                              jnp.asarray(waypoints), jnp.asarray(radii),
                              config=_ADMM,
                              warmstart_values=jnp.asarray(values),
                              scenario_block=4)
    res = auto.solve_qcqp_auto(
        free, jnp.asarray(df), jnp.asarray(times), jnp.asarray(waypoints),
        jnp.asarray(radii), admm_config=_ADMM, ipm_config=_IPM,
        warmstart_values=jnp.asarray(values), tier2_f64=False)
    keep = ~res.escalated
    np.testing.assert_allclose(np.asarray(res.solution.cost)[keep],
                               np.asarray(a.cost)[keep], rtol=2e-2)
    assert (np.asarray(res.solution.max_violation)[keep] < 1e-2).all()


def test_router_no_escalation_fastpath(small_batch):
    """A uniformly generous batch returns the tier-0 result untouched."""
    free, _, times, waypoints, radii, values = small_batch
    df = np.array(linear.extract_fixed_values(free, jnp.asarray(values)),
                  dtype=np.float32)
    wide = np.full_like(radii, 0.8)
    res = auto.solve_qcqp_auto(
        free, jnp.asarray(df), jnp.asarray(times), jnp.asarray(waypoints),
        jnp.asarray(wide), admm_config=_ADMM, ipm_config=_IPM,
        warmstart_values=jnp.asarray(values), tier2_f64=False)
    assert res.n_escalated == 0
    assert (res.verdict == auto.FEASIBLE).all()


def test_router_speculative_restart_fast(small_batch):
    """The fused speculative restart (tier1_spec, round-5 default path)
    compiles and preserves the verdict contract at small shapes: the
    top-k slice is re-solved INSIDE the tier-1 program and merged
    best-by-violation, so escalated rows can only improve on the plain
    tier-1 result."""
    free, df, times, waypoints, radii, values = small_batch
    kw = dict(admm_config=_ADMM, ipm_config=_IPM,
              warmstart_values=jnp.asarray(values), tier2_f64=False)
    res0 = auto.solve_qcqp_auto(
        free, jnp.asarray(df), jnp.asarray(times), jnp.asarray(waypoints),
        jnp.asarray(radii), tier1_spec=0, **kw)
    res2 = auto.solve_qcqp_auto(
        free, jnp.asarray(df), jnp.asarray(times), jnp.asarray(waypoints),
        jnp.asarray(radii), tier1_spec=2, **kw)
    # Same routing decisions (the gate precedes the speculation).
    np.testing.assert_array_equal(res0.escalated, res2.escalated)
    # Verdict contract unchanged: gate-pass rows feasible, the
    # structurally infeasible row certified, feasible escalated rows
    # exhibit < strict gate.
    assert (res2.verdict[[0, 1, 4, 5, 6]] == auto.FEASIBLE).all()
    assert res2.verdict[7] == auto.INFEASIBLE
    v2 = np.asarray(res2.solution.max_violation)
    assert (v2[res2.escalated & (res2.verdict == auto.FEASIBLE)]
            < 1e-4).all()


def test_tier2_f64_tiny_fast(small_batch):
    """Tier-2 semantics on a 2-row host-CPU f64 residue (fast-tier signal
    for the default-on production path, VERDICT r04 weak #6): exhibition
    outranks a certificate, and the f64 certificate REPLACES the f32 one."""
    free, df, times, waypoints, radii, values = small_batch
    a = qcqp.solve_qcqp_batch(free, jnp.asarray(df), jnp.asarray(times),
                              jnp.asarray(waypoints), jnp.asarray(radii),
                              config=_ADMM,
                              warmstart_values=jnp.asarray(values),
                              scenario_block=4)
    a_mask = tuple(af is not None for af in a)
    a_fields = [jnp.asarray(af) for m, af in zip(a_mask, a) if m]
    a_dtypes = tuple(af.dtype.name for af in a_fields)
    # Row 2: tight (r=0.1) but FEASIBLE corridor; row 7: structurally
    # infeasible.  Force both into tier-2 with a fabricated residue state:
    # row 2 additionally carries a FALSE-FIRED f32 infeasibility
    # certificate (the advisor-r04 scenario).
    idx = np.array([2, 7])
    t1_viol = np.array([1.0, 1.0], np.float32)
    t1_inf = np.array([True, False])
    merged = auto._run_tier2_f64(
        free, jnp.asarray(df), jnp.asarray(times), jnp.asarray(waypoints),
        jnp.asarray(radii), idx, t1_viol, t1_inf, a_fields, a_mask,
        a_dtypes, 1e-4)
    # The feasible row ends FEASIBLE by exhibition and the false f32
    # certificate is gone (replaced by the f64 IPM's).
    assert t1_viol[0] < 1e-4, t1_viol
    assert not t1_inf[0], "false f32 certificate must not survive tier-2"
    # The structurally infeasible row is certified by the f64 IPM.
    assert t1_inf[1], (t1_viol, t1_inf)
    # The merged solution row carries the f64 point (its violation).
    pos_mv = auto._sel_positions(a_mask)["max_violation"]
    assert float(np.asarray(merged[pos_mv])[2]) < 1e-4


def test_tier2_optimality_repair_chain_landed(small_batch):
    """Round-5 optimality repair: a row the f32 restart chain LANDED
    (feasible-by-exhibition but cost-suboptimal, tier_mark 2/3) joins the
    f64 stages anyway, and the f64 interior-point iterate REPLACES the
    repaired point once it is strictly feasible (Mosek returns the
    optimizer, not a repaired point -- qcqp_impl.h:777-786).  Without the
    chain mark the same feasible row is left untouched."""
    free, df, times, waypoints, radii, values = small_batch
    a = qcqp.solve_qcqp_batch(free, jnp.asarray(df), jnp.asarray(times),
                              jnp.asarray(waypoints), jnp.asarray(radii),
                              config=_ADMM,
                              warmstart_values=jnp.asarray(values),
                              scenario_block=4)
    a_mask = tuple(af is not None for af in a)
    a_dtypes = tuple(af.dtype.name for m, af in zip(a_mask, a) if m)
    pos = auto._sel_positions(a_mask)
    sel = [i for i, m in enumerate(a_mask) if m]
    pos["cost"] = sel.index(qcqp.QCQPSolution._fields.index("cost"))
    row = 2                     # tight (r=0.1) but feasible corridor

    def fabricate():
        """Full-batch merged fields with row 2 feasible-by-exhibition but
        carrying a 10x-inflated cost (a snap-repaired chain exhibit)."""
        fields = [jnp.asarray(af) for m, af in zip(a_mask, a) if m]
        fields[pos["cost"]] = fields[pos["cost"]].at[row].mul(10.0)
        fields[pos["max_violation"]] = (
            fields[pos["max_violation"]].at[row].set(1e-6))
        return fields

    args = (free, jnp.asarray(df), jnp.asarray(times),
            jnp.asarray(waypoints), jnp.asarray(radii), np.array([row]))
    inflated = float(np.asarray(fabricate()[pos["cost"]])[row])

    # No chain mark: the feasible row never enters tier-2 -- the inflated
    # point survives (the repair must not fire on tier-0/1-landed rows).
    t1_viol = np.array([1e-6], np.float32)
    t1_inf = np.array([False])
    kept = auto._run_tier2_f64(*args, t1_viol, t1_inf, fabricate(),
                               a_mask, a_dtypes, 1e-4)
    assert float(np.asarray(kept[pos["cost"]])[row]) == inflated

    # Chain mark (tier_mark 2 = restart #1): the row joins the f64 stages
    # and the near-optimal f64 point replaces the repaired one.
    t1_viol = np.array([1e-6], np.float32)
    t1_inf = np.array([False])
    mark = np.array([2], np.int8)
    merged = auto._run_tier2_f64(*args, t1_viol, t1_inf, fabricate(),
                                 a_mask, a_dtypes, 1e-4, tier_mark=mark)
    repaired_cost = float(np.asarray(merged[pos["cost"]])[row])
    assert repaired_cost < 0.5 * inflated, (repaired_cost, inflated)
    assert float(np.asarray(merged[pos["max_violation"]])[row]) < 1e-4
    assert t1_viol[0] < 1e-4 and not t1_inf[0]
    assert mark[0] == 4        # the row is now f64-landed


def test_strict_determinacy_contract(small_batch):
    """With tier2_f64=True EVERY verdict is determinate (+1/-1, never 0)
    -- the contract the strict entry ships and future throughput work must
    not silently trade away (VERDICT r04 #8)."""
    free, df, times, waypoints, radii, values = small_batch
    res = auto.solve_qcqp_auto(
        free, jnp.asarray(df), jnp.asarray(times), jnp.asarray(waypoints),
        jnp.asarray(radii), admm_config=_ADMM, ipm_config=_IPM,
        warmstart_values=jnp.asarray(values), gate=1e-4, strict_gate=1e-4,
        tier2_f64=True)
    assert (res.verdict != auto.UNDETERMINED).all(), res.verdict
    v = np.asarray(res.solution.max_violation)
    assert (v[res.verdict == auto.FEASIBLE] < 1e-4).all()
    # The structurally infeasible row stays certified INFEASIBLE.
    assert res.verdict[7] == auto.INFEASIBLE


def test_tier_cache_structural_keying():
    """_cached_jit keys on structural content, not object identity: an
    equal-content rebuild hits the cache; the LRU stays bounded."""
    auto._TIER_CACHE.clear()
    s1 = make_structure(free_interior_mask(K + 1, N), D, N)
    s2 = make_structure(free_interior_mask(K + 1, N), D, N)
    assert s1 is not s2 and s1 == s2 and hash(s1) == hash(s2)
    calls = []
    f1 = auto._cached_jit(("t", s1), lambda: calls.append(1) or (lambda: 0))
    f2 = auto._cached_jit(("t", s2), lambda: calls.append(1) or (lambda: 0))
    assert f1 is f2 and len(calls) == 1
    # A different family is a different key.
    s3 = make_structure(free_interior_mask(K + 2, N), D, N)
    auto._cached_jit(("t", s3), lambda: calls.append(1) or (lambda: 0))
    assert len(calls) == 2
    # LRU bound holds.
    for i in range(auto._TIER_CACHE_MAX + 8):
        auto._cached_jit(("fill", i), lambda: (lambda: 0))
    assert len(auto._TIER_CACHE) <= auto._TIER_CACHE_MAX
    auto._TIER_CACHE.clear()
