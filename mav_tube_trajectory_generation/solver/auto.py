"""Production verdict router: ADMM gate + selective IPM escalation.

The reference returns Mosek's interior-point verdict at every corridor
width (qcqp_impl.h:709-788).  The headline path (48-iteration warm-
started ADMM, solver/qcqp.solve_qcqp_batch) matches that verdict >=98% of
the time on generous corridors but is CONSERVATIVE on tight ones: the
fixed first-order iteration budget stops short of the 1e-2 feasibility
gate on scenarios an interior-point method solves fine (measured:
agreement 65% at radii 0.3-0.5, ~17% below 0.3 -- every disagreement a
gate MISS, never a false-feasible; benchmarks/verdict_parity_results.json).

``solve_qcqp_auto`` closes that gap the way a production deployment
should: every scenario gets the throughput ADMM solve, and ONLY the
scenarios failing the gate are re-solved by the plane-layout IPM polish
(solver/ipm_lanes), warm-started from their ADMM iterate.  On generous
corridors <1% escalate and the blended throughput is ~the headline's; on
tight corridors the verdict quality is the IPM's everywhere.

Escalation is a host-gathered second fixed-shape batch: the gate mask is
pulled to the host, failure indices gathered, padded to a power-of-two
bucket (a handful of compiled program shapes, no dynamic shapes inside
jit), solved, and scattered back.  This is the deliberate jit boundary --
the verdict decides a DIFFERENT PROGRAM per scenario, which is host
control flow by nature (the reference's analogue: the Mosek status switch,
qcqp_impl.h:715-770).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import ipm_lanes
from .ipm import IPMConfig
from .qcqp import ADMMConfig, QCQPSolution
from .structure import ProblemStructure

#: Verdict codes (int8): +1 feasible, -1 infeasible (certificate), 0
#: undetermined (neither a feasible point to tolerance nor a certificate --
#: near-degenerate corridors; the reference would surface Mosek's
#: MSK_SOL_STA_UNKNOWN here).
FEASIBLE = np.int8(1)
INFEASIBLE = np.int8(-1)
UNDETERMINED = np.int8(0)


class AutoResult(NamedTuple):
    solution: QCQPSolution        # merged batch (ADMM or escalated-IPM rows)
    verdict: np.ndarray           # (B,) int8: +1 / -1 / 0 (see module codes)
    escalated: np.ndarray         # (B,) bool: row was re-solved by the IPM
    n_escalated: int
    # (B,) int8 diagnostic: the LAST tier that re-ran each row (0 = tier-0
    # gate pass, 1 = tier-1 IPM -- including its fused speculative restart,
    # 2/3 = tier-1.5 restart #1/#2, 4 = tier-2 f64).  For FEASIBLE
    # escalated rows this is the tier that landed them (restarts only fire
    # on still-failing rows).
    tier: Optional[np.ndarray] = None


#: Cached jitted tier functions, keyed by (structure, configs, flags): the
#: tier solves run outside any caller jit (the router's gate/gather is host
#: control flow), so without this every call would dispatch the solver
#: graph op-by-op.  Configs are
#: frozen dataclasses (hashable); ProblemStructure hashes/compares by its
#: structural CONTENT (shapes + fixed-mask bytes, structure.py:105-116), so
#: a recycled object id can never alias a different family to a stale
#: compiled tier.  Bounded LRU: entries pin their closures (and the
#: structures inside) forever otherwise.
_TIER_CACHE: dict = {}
_TIER_CACHE_MAX = 64

#: _X64_NOTE -- the router pins the x64 flag PER TIER instead of relying on
#: process configuration, because the f32 tiers and the f64 tier share one
#: process: the f32 tiers trace under enable_x64(False), so a process that
#: enabled x64 globally still runs them in float32 (no Python scalar or
#: index silently widens their programs to 64 bits), and the f64 tier-2
#: traces under enable_x64(True), which makes the Mosek-grade endgame
#: reachable from ANY process -- no jax_enable_x64-at-startup requirement.
#: The x64 flag is part of jit cache keys, so the scoping composes with
#: _TIER_CACHE.


def _cached_jit(key, builder):
    fn = _TIER_CACHE.pop(key, None)
    if fn is None:
        fn = jax.jit(builder())
        while len(_TIER_CACHE) >= _TIER_CACHE_MAX:
            _TIER_CACHE.pop(next(iter(_TIER_CACHE)))
    _TIER_CACHE[key] = fn          # (re)insert at the MRU end
    return fn


def _bucket(n: int, block: int) -> int:
    """Escalation-batch bucket size >= n: power-of-two multiples of
    ``block`` up to 256 (tiny escalation sets on generous corridors), then
    multiples of 256 (a 1079-row set padded to a 2048 power-of-two bucket
    measurably halves blended throughput; 256-granularity keeps the
    compiled-shape count bounded at ~log2(256) + B/256 while wasting at
    most 255 rows of polish)."""
    b = block
    while b < min(n, 256):
        b *= 2
    if n <= b:
        return b
    return ((n + 255) // 256) * 256


def _sel_positions(a_mask):
    """Positions of the named QCQPSolution fields inside the mask-filtered
    merged-field list the tier programs carry."""
    fields_idx = QCQPSolution._fields
    sel = [i for i, m in enumerate(a_mask) if m]
    return {name: sel.index(fields_idx.index(name))
            for name in ("d_free", "dual_ball", "dual_half",
                         "max_violation")}


def _run_tier15_chain(structure, d32, t32, w32, r32, idx, t1_viol, t1_inf,
                      merged_fields, a_mask, a_dtypes, tier1_block,
                      strict_gate, mesh=None, shard_spec=None,
                      p_sh=None, tier_mark=None):
    """Tier 1.5: f32 RESTART chain on the residue (shared by the
    single-process and sharded routers; ``mesh`` switches the lanes solve
    to ``shard_map`` with bucket sizes quantized to the mesh).

    The rows tier-1 leaves above the strict gate are not f32-unresolvable
    (the round-3 assumption): a restarted endgame -- fresh factors,
    re-centered warm duals, a different iteration path -- lands them
    (measured: 7/7 bench-distribution residue rows for EVERY restart
    variant tried, benchmarks/residue_probe.py).  Two restarts with
    DIFFERENT rounding paths (Mehrotra corrector first -- it resolved the
    full residue ALONE on the bench distribution -- then single-direction
    + extra snaps), each warm-started from the current best iterate and
    firing only on what remains, push the f64 tier's firing rate to ~zero
    on generous corridors.

    Mutates ``t1_viol`` / ``t1_inf`` in place; returns the updated merged
    fields.  Certificates are REPLACED, not OR-ed: each restart
    re-examined the row with fresh factors, so its latest certificate
    supersedes an earlier (possibly false-fired) f32 one (advisor r04 #1).
    """
    pos = _sel_positions(a_mask)
    ndev = 1 if mesh is None else int(mesh.devices.size)
    quantum = tier1_block * ndev
    restart_cfgs = (
        IPMConfig(n_iters=10, snap_iters=4, sigma_min=0.3,
                  corrector=True),
        IPMConfig(n_iters=10, snap_iters=6, sigma_min=0.3,
                  corrector=False),
    )
    for restart_no, ipm15 in enumerate(restart_cfgs):
        need15 = (t1_viol >= strict_gate) & ~t1_inf
        if not need15.any():
            break
        sub15 = np.nonzero(need15)[0]
        n15 = int(sub15.size)
        nb15 = _bucket(n15, tier1_block)
        if mesh is not None:
            nb15 = ((max(nb15, quantum) + quantum - 1)
                    // quantum) * quantum
        sub15_pad = np.concatenate(
            [sub15, np.full(nb15 - n15, sub15[-1], dtype=sub15.dtype)])
        gidx15 = idx[sub15_pad]

        def _build_tier15(cfg=ipm15):
            def t15_local(df, t, w, r, x0_, lb, lh):
                return ipm_lanes.solve_qcqp_ipm_lanes(
                    structure, df, t, w, r, config=cfg, x0=x0_,
                    lam0_ball=lb, lam0_half=lh,
                    scenario_block=tier1_block)
            if mesh is None:
                t15 = t15_local
                con = lambda v: v
            else:
                t15 = jax.shard_map(t15_local, mesh=mesh,
                                    in_specs=(p_sh,) * 7, out_specs=p_sh)
                con = lambda v: jax.lax.with_sharding_constraint(
                    v, shard_spec)

            def run(df, t, w, r, gi, m_list):
                pol15 = t15(con(df[gi]), con(t[gi]), con(w[gi]),
                            con(r[gi]), con(m_list[pos["d_free"]][gi]),
                            con(m_list[pos["dual_ball"]][gi]),
                            con(m_list[pos["dual_half"]][gi]))
                p_sel = [pf for m, pf in zip(a_mask, pol15) if m]
                # Best-by-violation merge: a restart that REGRESSES a
                # still-failing row must not overwrite the better iterate
                # the verdict bookkeeping (np.minimum below) tracks --
                # solution and verdict stay consistent, and the next
                # restart warm-starts from the best point seen.
                keep = (pol15.max_violation
                        < m_list[pos["max_violation"]][gi])

                def _take(new, old):
                    k = keep.reshape(keep.shape + (1,) * (new.ndim - 1))
                    return jnp.where(k, new.astype(old.dtype), old)

                merged15 = [mf.at[gi].set(_take(pf, mf[gi]))
                            for mf, pf in zip(m_list, p_sel)]
                return pol15.max_violation, pol15.infeasible, merged15
            return run

        f15 = _cached_jit(
            ("tier15", structure, ipm15, tier1_block, nb15,
             a_mask, a_dtypes, mesh), _build_tier15)
        with jax.enable_x64(False):       # see _X64_NOTE
            v15, i15, merged_fields = f15(
                d32, t32, w32, r32, jnp.asarray(gidx15), merged_fields)
        v15, i15 = jax.device_get((v15, i15))                 # ONE sync
        t1_viol[sub15] = np.minimum(t1_viol[sub15],
                                    np.asarray(v15)[:n15])
        t1_inf[sub15] = np.asarray(i15)[:n15]
        if tier_mark is not None:
            tier_mark[sub15] = 2 + restart_no
    return merged_fields


def _run_tier2_f64(structure, d_fixed, times, waypoints, radii, idx,
                   t1_viol, t1_inf, merged_fields, a_mask, a_dtypes,
                   strict_gate, tier_mark=None):
    """Tier 2: f64 rows IPM on the default device for anything the f32
    tiers cannot settle (shared by both routers; on a mesh each process
    runs it on its addressable residue).

    Two-stage like the parity study's escalated ground truth: 30 f64
    iterations resolve the bulk; rows still above the strict gate after
    that get a 4x budget -- INCLUDING rows the 30-iter pass certified
    infeasible: a warm f64 certificate can false-fire exactly where a
    longer run exhibits a feasible point (measured: 41 conservative gate
    misses at r<0.1 in the 4096-study were stage-2 skips), and
    feasibility-by-exhibition always outranks a certificate -- the same
    precedence the ground truth applies.  Solves the caller's ORIGINAL
    (precision-unclipped) problem data -- Mosek's everything-in-doubles
    semantics (qcqp_impl.h:709-788).

    After the two cold-ADMM-warm stages, rows still UNDETERMINED get two
    RESTARTED f64 endgames (60 iterations each, warm-started from the
    best f64 iterate, fresh factors) -- the parity ground truth's 3rd
    escalation stage, mirrored here so the router's tier-2 cannot be
    outrun by the study it is scored against (round-5: the restart stage
    landed 43 rows the 120-iteration run left undetermined).

    Mutates ``t1_viol`` / ``t1_inf`` in place; returns the updated merged
    fields (single-device arrays on the default device once this tier
    fires).
    """
    from .ipm import solve_qcqp_ipm, solve_qcqp_polished
    pos = _sel_positions(a_mask)
    pos_mv = pos["max_violation"]
    f64 = jnp.float64
    warm = {}           # local-escalation-row -> (d_free, lb, lh) f64 warm
    d_np = np.asarray(d_fixed)
    t_np = np.asarray(times)
    w_np = np.asarray(waypoints)
    r_np = np.asarray(radii)
    # Optimality repair (round-5): rows the tier-1.5 restart chain LANDED
    # carry snap-repaired points -- feasible but up to ~74% above the
    # interior-point optimum at ultra-tight radii (cost_gap_probe r=[0.02,
    # 0.06]: tier-2/3-landed rows gap median 0.39, f64-landed 2e-9).  Mosek
    # returns the OPTIMIZER, not a repaired point (qcqp_impl.h:777-786), so
    # chain-repaired rows join the first f64 stage even when feasible: if
    # the f64 IPM exhibits a strictly feasible point it is preferred (near-
    # optimal); otherwise the f32 exhibition stands and the verdict is
    # unchanged.  At the bench distribution the chain lands ~0 rows (the
    # speculative tier-1 restart absorbs them), so the throughput line
    # does not pay for this.
    # ``pending`` tracks chain-repaired rows the f64 tier has not yet
    # landed with its own strictly feasible (near-optimal) point; they
    # ride along through every stage -- including the restarts -- until
    # an f64 exhibition replaces the repaired point or the stages run out
    # (then the f32 exhibition stands).
    pending = (np.isin(tier_mark, (2, 3)).copy()
               if tier_mark is not None
               else np.zeros_like(t1_inf, dtype=bool))

    def _merge_keep(pol64, gi, m_list):
        # Prefer the f64 interior-point iterate whenever it is strictly
        # feasible (it is the near-OPTIMAL point -- Mosek returns the
        # optimizer, not a repaired point, qcqp_impl.h:777-786);
        # otherwise best-by-violation so solution rows stay consistent
        # with the np.minimum verdict bookkeeping below.
        keep = ((pol64.max_violation < strict_gate) |
                (pol64.max_violation < m_list[pos_mv][gi]))

        def _take(new, old):
            k = keep.reshape(keep.shape + (1,) * (new.ndim - 1))
            return jnp.where(k, new.astype(old.dtype), old)

        p_sel = [pf for m, pf in zip(a_mask, pol64) if m]
        return [(mf if pf is None else mf.at[gi].set(_take(pf, mf[gi])))
                for mf, pf in zip(m_list, p_sel)]

    for stage, t2_iters in enumerate((30, 120, 60, 60)):
        restart = stage >= 2
        if restart:
            # Restart stages fire on UNDETERMINED rows only (the ground
            # truth's recipe: exhibition outranks certificates, so
            # certified rows rest; a restarted endgame re-examines rows
            # neither side could settle) -- plus still-pending
            # optimality-repair rows.
            need2 = ((t1_viol >= strict_gate) & ~t1_inf) | pending
        else:
            need2 = (t1_viol >= strict_gate) | pending
        if not need2.any():
            break
        sub = np.nonzero(need2)[0]
        n2 = int(sub.size)
        # Bucketed like tier 1 (a fresh jit per exact subset size would
        # be a fresh compile each); pad by repeating the last row --
        # duplicate rows solve to identical values, so the duplicate
        # scatter writes below cannot disagree.
        nb2 = _bucket(n2, 1)
        sub_pad = np.concatenate([sub, np.full(nb2 - n2, sub[-1],
                                               dtype=sub.dtype)])
        gidx = idx[sub_pad]

        if restart:
            def _build_tier2(n_it=t2_iters):
                def run(d1, d2, d3, d4, xw, lb, lh, gi, m_list):
                    pol64 = jax.vmap(
                        lambda a1, a2, a3, a4, a5, a6, a7: solve_qcqp_ipm(
                            structure, a1, a2, a3, a4,
                            config=IPMConfig(n_iters=n_it),
                            x0=a5, lam0_ball=a6, lam0_half=a7))(
                        d1, d2, d3, d4, xw, lb, lh)
                    merged2 = _merge_keep(pol64, gi, m_list)
                    return (pol64.max_violation, pol64.infeasible,
                            pol64.d_free, pol64.dual_ball,
                            pol64.dual_half, merged2)
                return run
        else:
            def _build_tier2(n_it=t2_iters):
                def run(d1, d2, d3, d4, gi, m_list):
                    pol64 = jax.vmap(
                        lambda a1, a2, a3, a4: solve_qcqp_polished(
                            structure, a1, a2, a3, a4,
                            ipm_config=IPMConfig(n_iters=n_it)))(
                        d1, d2, d3, d4)
                    merged2 = _merge_keep(pol64, gi, m_list)
                    return (pol64.max_violation, pol64.infeasible,
                            pol64.d_free, pol64.dual_ball,
                            pol64.dual_half, merged2)
                return run

        f2 = _cached_jit(
            ("tier2r" if restart else "tier2", structure, nb2, t2_iters,
             a_mask, a_dtypes, strict_gate), _build_tier2)
        # Tier-2 is the Mosek analogue -- an f64 solve on the default
        # device for the handful of rows the f32 tiers cannot settle.
        # Sharded merged fields are gathered onto that device first; the
        # merge scatter then runs there.
        dev = jax.local_devices()[0]
        with jax.enable_x64(True):
            gidx_dev = jnp.asarray(gidx)
            args = [jnp.asarray(d_np, f64)[gidx_dev],
                    jnp.asarray(t_np, f64)[gidx_dev],
                    jnp.asarray(w_np, f64)[gidx_dev],
                    jnp.asarray(r_np, f64)[gidx_dev]]
            if restart:
                args += [jnp.asarray(np.stack([warm[int(s)][1 + j]
                                               for s in sub_pad]))
                         for j in range(3)]
            v64, i64, xdf, xlb, xlh, merged_fields = f2(
                *args, gidx_dev,
                [jax.device_put(mf, dev) for mf in merged_fields])
        v64, i64 = jax.device_get((v64, i64))              # ONE sync
        v64 = np.asarray(v64)[:n2]
        # Track the best f64 iterate per row for the restart stages'
        # warm starts (best-by-F64-violation, the gt recipe; NOT the
        # merged min, which includes the f32 exhibition and would pin
        # pending optimality rows to their stage-1 iterate forever).
        xdf, xlb, xlh = (np.asarray(jax.device_get(a))[:n2]
                         for a in (xdf, xlb, xlh))
        for j, s in enumerate(sub):
            s_i = int(s)
            if s_i not in warm or v64[j] <= warm[s_i][0]:
                warm[s_i] = (v64[j], xdf[j], xlb[j], xlh[j])
        t1_viol[sub] = np.minimum(t1_viol[sub], v64)
        pending[sub] &= ~(v64 < strict_gate)
        if tier_mark is not None:
            tier_mark[sub] = 4
        # The f64 certificate REPLACES the accumulated f32 one for
        # every row this stage re-examined: only the f64 IPM may
        # assert INFEASIBLE on escalated residue rows -- an OR would
        # let a tier-1 f32 Farkas false-fire survive into a
        # determinate false-INFEASIBLE verdict (advisor r04 #1).
        t1_inf[sub] = np.asarray(i64)[:n2]
    return merged_fields


def solve_qcqp_auto(structure: ProblemStructure,
                    d_fixed: jnp.ndarray,
                    times: jnp.ndarray,
                    waypoints: jnp.ndarray,
                    radii: jnp.ndarray,
                    admm_config: Optional[ADMMConfig] = None,
                    ipm_config: Optional[IPMConfig] = None,
                    warmstart_values: Optional[jnp.ndarray] = None,
                    gate: float = 1e-2,
                    strict_gate: float = 1e-4,
                    scenario_block: int = 4,
                    tier0_snap: int = 0,
                    tier2_f64: bool = True,
                    tier1_block: Optional[int] = None,
                    tier0_config: Optional[IPMConfig] = None,
                    tier1_spec: int = 0) -> AutoResult:
    """Batched tube-QCQP solve with Mosek-grade verdicts at every corridor
    width (ALL array args carry a leading batch axis).

    Pipeline: throughput ADMM on the full batch; scenarios with
    ``max_violation >= gate`` are gathered and re-solved by the warm-started
    plane-layout IPM (ipm_lanes.solve_qcqp_ipm_lanes).  Per-scenario
    verdicts follow the parity study's semantics
    (benchmarks/verdict_parity.py): feasible by exhibition
    (violation < ``strict_gate`` after escalation, < ``gate`` from the ADMM
    gate), infeasible by the IPM's static/Farkas certificate, else
    undetermined.

    ``tier1_block``: scenario blocking for the tier-1 IPM (defaults to
    ``scenario_block``); escalation buckets are multiples of it.

    ``tier1_spec``: speculate the first tier-1.5 restart INSIDE the tier-1
    jitted program on the worst ``tier1_spec`` rows of the bucket (by
    violation, top_k).  The residue the restart chain would re-dispatch on
    (~tens of rows) is almost surely inside the worst slice, so landing it
    in-program skips the separate restart dispatches and their host syncs;
    the host chain stays as the backstop for anything the speculation
    misses.  0 disables.

    Returns an AutoResult; ``solution`` rows of escalated scenarios are the
    IPM's, everything else the ADMM's.
    """
    from . import qcqp as qcqp_mod
    if admm_config is None:
        admm_config = ADMMConfig(rho=0.005, n_stages=1, n_iters=48,
                                 rho_tube_factor=0.125,
                                 rho_half_factor=0.125, padded_lanes=True)
    if ipm_config is None:
        ipm_config = IPMConfig(n_iters=10, sigma_min=0.3, corrector=False)

    # The f32 tiers run in f32 regardless of the caller's precision; the
    # f64 tier-2 solves the caller's ORIGINAL data -- on near-degenerate
    # corridors the f32 ROUNDING OF THE PROBLEM ITSELF perturbs strict
    # 1e-4 feasibility margins, so an f64-input caller (e.g. the parity
    # study's distribution) gets Mosek's everything-in-doubles semantics
    # end-to-end while f32 callers see identical behavior.
    f32 = jnp.float32
    d_fixed32 = jnp.asarray(d_fixed, f32)
    times32 = jnp.asarray(times, f32)
    waypoints32 = jnp.asarray(waypoints, f32)
    radii32 = jnp.asarray(radii, f32)
    warmstart32 = (None if warmstart_values is None
                   else jnp.asarray(warmstart_values, f32))

    has_ws = warmstart_values is not None
    if tier0_snap:
        # Strict tier 0: ADMM + snap-only Gauss-Newton sweeps (one band
        # factor per sweep) -- pulls the ADMM's ~1e-4-class violations
        # under the strict gate for the bulk of the batch at a fraction of
        # the full polish's cost; the IPM escalation below handles the
        # rest.
        ipm0 = tier0_config if tier0_config is not None else IPMConfig(
            n_iters=0, snap_iters=tier0_snap, sigma_min=0.3,
            corrector=False)
        f0 = _cached_jit(
            ("tier0snap", structure, admm_config, ipm0, scenario_block,
             has_ws),
            lambda: (lambda df, t, w, r, ws=None:
                     ipm_lanes.solve_qcqp_polished_batch(
                         structure, df, t, w, r, admm_config=admm_config,
                         ipm_config=ipm0, warmstart_values=ws,
                         scenario_block=scenario_block)))
        with jax.enable_x64(False):   # see _X64_NOTE
            a = (f0(d_fixed32, times32, waypoints32, radii32, warmstart32)
                 if has_ws else f0(d_fixed32, times32, waypoints32,
                                   radii32))
    else:
        f0 = _cached_jit(
            ("tier0admm", structure, admm_config, scenario_block,
             has_ws),
            lambda: (lambda df, t, w, r, ws=None:
                     qcqp_mod.solve_qcqp_batch(
                         structure, df, t, w, r, config=admm_config,
                         warmstart_values=ws,
                         scenario_block=scenario_block)))
        with jax.enable_x64(False):   # see _X64_NOTE
            a = (f0(d_fixed32, times32, waypoints32, radii32, warmstart32)
                 if has_ws else f0(d_fixed32, times32, waypoints32,
                                   radii32))
    if tier1_block is None:
        tier1_block = scenario_block
    bsz = int(a.cost.shape[0])
    a_viol = np.asarray(a.max_violation)
    gate_ok = a_viol < gate

    verdict = np.where(gate_ok, FEASIBLE, UNDETERMINED).astype(np.int8)
    escalated = ~gate_ok
    idx = np.nonzero(escalated)[0]
    n_esc = int(idx.size)
    if n_esc == 0:
        return AutoResult(solution=a, verdict=verdict,
                          escalated=escalated, n_escalated=0,
                          tier=np.zeros(bsz, np.int8))

    # Fixed-shape escalation batch: pad the gathered indices to a bucketed
    # size by repeating the last failure (valid data; extra rows discarded).
    nb = _bucket(n_esc, tier1_block)
    idx_pad = np.concatenate([idx, np.full(nb - n_esc, idx[-1],
                                           dtype=idx.dtype)])
    # Pad rows of idx_pad all point at the last failure row, and `src`
    # re-gathers that row's solved values for them, so the duplicate
    # scatter writes below are identical and write order cannot matter.
    src = np.concatenate([np.arange(n_esc),
                          np.full(nb - n_esc, n_esc - 1)]).astype(np.int32)
    a_mask = tuple(af is not None for af in a)
    a_fields = [jnp.asarray(af) for m, af in zip(a_mask, a) if m]
    a_dtypes = tuple(af.dtype.name for af in a_fields)

    # Tier 1 + scatter-merge in ONE jitted program: the index gathers run
    # inside (one dispatch instead of seven eager gathers), and the
    # polished bucket is scattered back into the tier-0 fields before
    # leaving the program -- folding the merge in here saves a second
    # dispatch round trip.
    spec_rows = min(int(tier1_spec), nb)
    spec_cfg = IPMConfig(n_iters=10, snap_iters=4, sigma_min=0.3,
                         corrector=True)   # == restart_cfgs[0]: it resolved
    #                                        the full residue alone
    #                                        (benchmarks/residue_probe.py)
    fi_mv = QCQPSolution._fields.index("max_violation")
    fi_inf = QCQPSolution._fields.index("infeasible")

    def _build_tier1():
        def run(df, t, w, r, x0_, lb, lh, ip, sr, a_list):
            pol = ipm_lanes.solve_qcqp_ipm_lanes(
                structure, df[ip], t[ip], w[ip], r[ip],
                config=ipm_config, x0=x0_[ip], lam0_ball=lb[ip],
                lam0_half=lh[ip], scenario_block=tier1_block)
            if spec_rows:
                # Speculative first restart on the worst slice, fused into
                # this program: best-by-violation iterate merge, restart
                # certificate replaces (chain semantics).  top_k indices
                # are unique, so the scatters cannot collide.
                viol1 = pol.max_violation
                _, wi = jax.lax.top_k(viol1, spec_rows)
                ip_w = ip[wi]
                rs = ipm_lanes.solve_qcqp_ipm_lanes(
                    structure, df[ip_w], t[ip_w], w[ip_w], r[ip_w],
                    config=spec_cfg, x0=pol.d_free[wi],
                    lam0_ball=pol.dual_ball[wi],
                    lam0_half=pol.dual_half[wi],
                    scenario_block=tier1_block)
                keep = rs.max_violation < viol1[wi]

                def _mix(new, old):
                    k2 = keep.reshape(keep.shape + (1,) * (new.ndim - 1))
                    return jnp.where(k2, new.astype(old.dtype), old)

                fields = []
                for fi, (pf, nf_) in enumerate(zip(pol, rs)):
                    if pf is None:
                        fields.append(None)
                    elif fi == fi_inf:
                        fields.append(pf.at[wi].set(nf_))
                    else:
                        fields.append(pf.at[wi].set(_mix(nf_, pf[wi])))
                pol = QCQPSolution(*fields)
            pol_sel = [pf for m, pf in zip(a_mask, pol) if m]
            merged = [af.at[ip].set(pf[sr].astype(af.dtype))
                      for af, pf in zip(a_list, pol_sel)]
            return pol, merged
        return run

    f1 = _cached_jit(
        ("tier1m", structure, ipm_config, tier1_block, nb,
         a_mask, a_dtypes, spec_rows),
        _build_tier1)
    with jax.enable_x64(False):       # see _X64_NOTE
        polished, merged_fields = f1(
            d_fixed32, times32, waypoints32, radii32, a.d_free,
            a.dual_ball, a.dual_half, jnp.asarray(idx_pad),
            jnp.asarray(src), a_fields)

    # Tier 2: every row the f32 lanes polish leaves above the strict gate --
    # INCLUDING rows it certified infeasible.  On tight corridors the f32
    # endgame stalls where an f64 interior point converges (measured: f64
    # ADMM-warm-started rows IPM reaches <1e-4 on every r=0.12 fixture the
    # f32 path leaves at ~1e-2), and the f32 dynamic (lam-growth) Farkas
    # certificate can FALSE-FIRE in the same regime (the round-3 parity
    # study's 51 conservative misses at r<0.1 were exactly these).  The
    # f64 rows IPM (ipm.solve_qcqp_polished, the parity study's
    # ground-truth recipe) issues the final verdict for all of them --
    # Mosek's everything-in-doubles semantics (qcqp_impl.h:709-788).
    # Tier-2 enables x64 itself in a scoped context on the default
    # device (see _X64_NOTE); only tier2_f64=False keeps the tier-1
    # verdict (conservative: never false-feasible).
    t1_viol, t1_inf = jax.device_get((polished.max_violation,
                                      polished.infeasible))   # ONE sync
    t1_viol = np.asarray(t1_viol)[:n_esc].copy()
    t1_inf = np.asarray(t1_inf)[:n_esc].copy()

    # Tier 1.5 (f32 restart chain) + tier 2 (f64 rows IPM):
    # shared residue-tier helpers -- see _run_tier15_chain /
    # _run_tier2_f64 for the measured rationale.  Both mutate
    # t1_viol/t1_inf in place and return the updated merged fields.
    tier_esc = np.ones(n_esc, np.int8)
    merged_fields = _run_tier15_chain(
        structure, d_fixed32, times32, waypoints32, radii32, idx,
        t1_viol, t1_inf, merged_fields, a_mask, a_dtypes, tier1_block,
        strict_gate, tier_mark=tier_esc)
    if tier2_f64:
        merged_fields = _run_tier2_f64(
            structure, d_fixed, times, waypoints, radii, idx,
            t1_viol, t1_inf, merged_fields, a_mask, a_dtypes,
            strict_gate, tier_mark=tier_esc)

    it = iter(merged_fields)
    merged = QCQPSolution(*(next(it) if m else af
                            for m, af in zip(a_mask, a)))

    v_esc = np.where(t1_viol < strict_gate, FEASIBLE,
                     np.where(t1_inf, INFEASIBLE, UNDETERMINED)).astype(
        np.int8)
    verdict[idx] = v_esc
    tier = np.zeros(bsz, np.int8)
    tier[idx] = tier_esc
    return AutoResult(solution=merged, verdict=verdict,
                      escalated=escalated, n_escalated=n_esc, tier=tier)


def solve_qcqp_strict(structure: ProblemStructure,
                      d_fixed: jnp.ndarray,
                      times: jnp.ndarray,
                      waypoints: jnp.ndarray,
                      radii: jnp.ndarray,
                      warmstart_values: Optional[jnp.ndarray] = None,
                      scenario_block: int = 4,
                      tier2_f64: bool = True,
                      tier1_block: Optional[int] = None,
                      ipm_config: Optional[IPMConfig] = None,
                      tier1_spec: int = 128) -> AutoResult:
    """Mosek-grade strict-feasibility solve at router throughput.

    Tier 0: ADMM + 2 snap-only Gauss-Newton sweeps (one band factor each;
    a 3rd sweep measured costlier than the extra escalations it prevents
    once the restart chain recovers the tail, at identical quality);
    tier 1: rows still >= 1e-4 escalate to the warm-started plane-layout
    IPM polish; tier 1.5: f32 restart chain on the residue; tier 2 (f64
    rows IPM) for anything left.  Verdicts are feasibility-by-exhibition
    at the 1e-4 strict gate -- the per-solve semantics of the reference's
    Mosek backend (qcqp_impl.h:709-788) with the polish cost paid ONLY by
    the scenarios that need it.

    Default tier-1 schedule: it6s2 with a 128-row speculative in-program
    restart (``tier1_spec``).  The speculation recovers the short
    schedule's tail in-program (6144/6144 < 1e-4 on the bench
    distribution), so the separate restart dispatches do not fire there;
    the tier-1.5/2 chain remains the backstop for tighter regimes.
    """
    if ipm_config is None:
        ipm_config = IPMConfig(n_iters=6, sigma_min=0.3, corrector=False)
    return solve_qcqp_auto(structure, d_fixed, times, waypoints, radii,
                           warmstart_values=warmstart_values,
                           gate=1e-4, strict_gate=1e-4,
                           scenario_block=scenario_block,
                           tier0_snap=2, tier2_f64=tier2_f64,
                           tier1_block=tier1_block, ipm_config=ipm_config,
                           tier1_spec=tier1_spec)

def solve_qcqp_strict_sharded(structure: ProblemStructure,
                              d_fixed: jnp.ndarray,
                              times: jnp.ndarray,
                              waypoints: jnp.ndarray,
                              radii: jnp.ndarray,
                              *,
                              mesh,
                              warmstart_values: Optional[jnp.ndarray] = None,
                              admm_config: Optional[ADMMConfig] = None,
                              ipm_config: Optional[IPMConfig] = None,
                              gate: float = 1e-4,
                              strict_gate: float = 1e-4,
                              tier0_snap: int = 2,
                              scenario_block: int = 4,
                              tier1_block: Optional[int] = None,
                              tier2_f64: bool = True,
                              axis_name: Optional[str] = None):
    """The strict verdict router under a device mesh.

    Execution shape -- the one a multi-host deployment wants:

      * tier 0 (ADMM + snap sweeps) runs scenario-parallel via
        ``shard_map``: each device solves its local shard, no
        cross-scenario communication;
      * the gate mask is pulled ONCE to the host (single-controller: the
        global array is fully addressable; on multihost each process runs
        this router on its local shard -- see docs/MULTIHOST.md);
      * tier 1 + scatter-merge run in ONE jitted program: the bucket
        gather/scatter cross shards via XLA collectives, the IPM solve is
        shard_mapped over the same mesh, and the strict-feasibility count
        is reduced ON-DEVICE -- the returned ``n_strict`` scalar is the
        psum'd verdict count, replicated on every device;
      * the residue tiers run like the single-process router's -- tier-1.5
        f32 restarts shard_mapped over the mesh (bucket sizes quantized to
        ``tier1_block * n_devices``), tier-2 f64 on the default device for
        this process's addressable residue -- so the mesh path ends with the
        SAME determinate verdict set as ``solve_qcqp_strict``
        (qcqp_impl.h:715-770: a definitive status regardless of
        deployment shape).

    ``tier0_snap`` defaults to 2, the single-process strict entry's value
    (see ``solve_qcqp_strict``) -- the two entry points share the choice
    deliberately.

    Returns (AutoResult, n_strict_device) where n_strict_device counts
    ``max_violation < strict_gate`` over the FULL merged batch on-device.
    """
    from jax.sharding import NamedSharding, PartitionSpec
    from ..parallel import mesh as pmesh
    axis = axis_name or pmesh.DATA_AXIS
    p_sh = PartitionSpec(axis)
    shard_sp = NamedSharding(mesh, p_sh)
    ndev = int(mesh.devices.size)
    if admm_config is None:
        admm_config = ADMMConfig(rho=0.005, n_stages=1, n_iters=48,
                                 rho_tube_factor=0.125,
                                 rho_half_factor=0.125, padded_lanes=True)
    if ipm_config is None:
        # it10 here vs the single-process entry's it6: the short schedule
        # is only safe WITH the fused speculative restart (tier1_spec)
        # recovering its tail, and that speculation is not ported to the
        # shard_mapped tier-1 program (a cross-shard top-k gather); until
        # it is, the mesh path keeps the deeper schedule -- a deliberate,
        # quality-preserving divergence, not drift (tier0_snap=2 IS
        # shared, see the docstring).
        ipm_config = IPMConfig(n_iters=10, sigma_min=0.3, corrector=False)
    if tier1_block is None:
        tier1_block = scenario_block

    # The f32 tiers must see float32 regardless of the caller's precision
    # (jax.enable_x64(False) does NOT downcast already-committed f64 jax
    # Arrays).  Tier-2 solves the caller's ORIGINAL data, like the
    # single-process router.
    f32 = jnp.float32
    d_fixed32 = jnp.asarray(d_fixed, f32)
    times32 = jnp.asarray(times, f32)
    waypoints32 = jnp.asarray(waypoints, f32)
    radii32 = jnp.asarray(radii, f32)
    warmstart32 = (None if warmstart_values is None
                   else jnp.asarray(warmstart_values, f32))

    has_ws = warmstart_values is not None
    n_in = 5 if has_ws else 4
    ipm0 = IPMConfig(n_iters=0, snap_iters=tier0_snap, sigma_min=0.3,
                     corrector=False)

    def _build_tier0():
        def t0_local(df, t, w, r, ws=None):
            return ipm_lanes.solve_qcqp_polished_batch(
                structure, df, t, w, r, admm_config=admm_config,
                ipm_config=ipm0, warmstart_values=ws,
                scenario_block=scenario_block)
        return jax.shard_map(t0_local, mesh=mesh,
                             in_specs=(p_sh,) * n_in, out_specs=p_sh)

    f0 = _cached_jit(("tier0sh", structure, mesh, admm_config, ipm0,
                      scenario_block, has_ws), _build_tier0)
    with jax.enable_x64(False):           # see _X64_NOTE
        a = (f0(d_fixed32, times32, waypoints32, radii32, warmstart32)
             if has_ws else f0(d_fixed32, times32, waypoints32, radii32))

    a_viol = np.asarray(jax.device_get(a.max_violation))
    gate_ok = a_viol < gate
    verdict = np.where(gate_ok, FEASIBLE, UNDETERMINED).astype(np.int8)
    escalated = ~gate_ok
    idx = np.nonzero(escalated)[0]
    n_esc = int(idx.size)
    if n_esc == 0:
        mv = a.max_violation
        n_strict = jnp.sum((mv < strict_gate).astype(jnp.float32))
        return (AutoResult(solution=a, verdict=verdict,
                           escalated=escalated, n_escalated=0,
                           tier=np.zeros(len(gate_ok), np.int8)), n_strict)

    # Bucket to a multiple of (tier1_block * n_devices) so the shard_mapped
    # bucket divides the mesh evenly.
    quantum = tier1_block * ndev
    nb = max(_bucket(n_esc, tier1_block), quantum)
    nb = ((nb + quantum - 1) // quantum) * quantum
    idx_pad = np.concatenate([idx, np.full(nb - n_esc, idx[-1],
                                           dtype=idx.dtype)])
    src = np.concatenate([np.arange(n_esc),
                          np.full(nb - n_esc, n_esc - 1)]).astype(np.int32)
    a_mask = tuple(af is not None for af in a)
    a_fields = [jnp.asarray(af) for m, af in zip(a_mask, a) if m]
    a_dtypes = tuple(af.dtype.name for af in a_fields)
    sel_fields = [i for i, m in enumerate(a_mask) if m]
    mv_pos = sel_fields.index(QCQPSolution._fields.index("max_violation"))

    def _build_tier1():
        def t1_local(df, t, w, r, x0_, lb, lh):
            return ipm_lanes.solve_qcqp_ipm_lanes(
                structure, df, t, w, r, config=ipm_config, x0=x0_,
                lam0_ball=lb, lam0_half=lh, scenario_block=tier1_block)
        t1_sm = jax.shard_map(t1_local, mesh=mesh, in_specs=(p_sh,) * 7,
                              out_specs=p_sh)

        def run(df, t, w, r, x0_, lb, lh, ip, sr, a_list):
            con = lambda v: jax.lax.with_sharding_constraint(v, shard_sp)
            pol = t1_sm(con(df[ip]), con(t[ip]), con(w[ip]), con(r[ip]),
                        con(x0_[ip]), con(lb[ip]), con(lh[ip]))
            pol_sel = [pf for m, pf in zip(a_mask, pol) if m]
            merged = [af.at[ip].set(pf[sr].astype(af.dtype))
                      for af, pf in zip(a_list, pol_sel)]
            n_strict = jnp.sum(
                (merged[mv_pos] < strict_gate).astype(jnp.float32))
            return pol, merged, n_strict
        return run

    f1 = _cached_jit(("tier1sh", structure, mesh, ipm_config, tier1_block,
                      nb, a_mask, a_dtypes), _build_tier1)
    with jax.enable_x64(False):           # see _X64_NOTE
        polished, merged_fields, n_strict = f1(
            d_fixed32, times32, waypoints32, radii32, a.d_free,
            a.dual_ball, a.dual_half, jnp.asarray(idx_pad),
            jnp.asarray(src), a_fields)

    t1_viol, t1_inf = jax.device_get((polished.max_violation,
                                      polished.infeasible))
    t1_viol = np.asarray(t1_viol)[:n_esc].copy()
    t1_inf = np.asarray(t1_inf)[:n_esc].copy()

    # Residue tiers (shared helpers; same semantics as the single-process
    # router): tier-1.5 restarts shard_mapped over the mesh, tier-2 f64
    # on the default device.  Both mutate t1_viol/t1_inf in place.
    tier_esc = np.ones(n_esc, np.int8)
    merged_fields = _run_tier15_chain(
        structure, d_fixed32, times32, waypoints32, radii32, idx,
        t1_viol, t1_inf, merged_fields, a_mask, a_dtypes, tier1_block,
        strict_gate, mesh=mesh, shard_spec=shard_sp, p_sh=p_sh,
        tier_mark=tier_esc)
    tier2_fired = False
    if tier2_f64:
        need_before = bool((t1_viol >= strict_gate).any())
        merged_fields = _run_tier2_f64(
            structure, d_fixed, times, waypoints, radii, idx,
            t1_viol, t1_inf, merged_fields, a_mask, a_dtypes,
            strict_gate, tier_mark=tier_esc)
        tier2_fired = need_before

    it = iter(merged_fields)
    merged = QCQPSolution(*(next(it) if m else af
                            for m, af in zip(a_mask, a)))
    v_esc = np.where(t1_viol < strict_gate, FEASIBLE,
                     np.where(t1_inf, INFEASIBLE, UNDETERMINED)).astype(
        np.int8)
    verdict[idx] = v_esc

    # n_strict over the FINAL merged batch, reduced on-device and
    # replicated via the mesh.  Tier-1's in-program count is stale once a
    # residue tier modified rows; tier-2 additionally leaves the merged
    # fields on one device, so re-shard max_violation (a (B,) array --
    # cheap) over the mesh before counting.
    if tier2_fired or not np.array_equal(
            np.asarray(t1_viol),
            np.asarray(jax.device_get(polished.max_violation))[:n_esc]):
        def _build_count():
            return lambda mv: jnp.sum((mv < strict_gate).astype(
                jnp.float32))
        f_cnt = _cached_jit(("countsh", mesh, strict_gate), _build_count)
        pos_mv = _sel_positions(a_mask)["max_violation"]
        mv_dev = jax.device_put(
            np.asarray(jax.device_get(merged_fields[pos_mv]), np.float32),
            shard_sp)
        with jax.enable_x64(False):
            n_strict = f_cnt(mv_dev)
    tier = np.zeros(len(gate_ok), np.int8)
    tier[idx] = tier_esc
    return (AutoResult(solution=merged, verdict=verdict,
                       escalated=escalated, n_escalated=n_esc, tier=tier),
            n_strict)
