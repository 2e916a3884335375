"""Mosek-verdict parity study: headline ADMM gate vs interior-point ground
truth -- verdict agreement + cost-gap distribution (round-1 VERDICT weak #1).

The reference delegates the tube QCQP to Mosek's interior-point solver and
surfaces its feasibility verdict (qcqp_impl.h:709-770).  The headline
rides a 48-iteration f32 ADMM gated at max_violation < 1e-2.  This study
quantifies, over >= 10k random scenarios spanning generous-to-impossible
corridor radii, how often that gate agrees with a Mosek-grade ground truth:

  ground truth (CPU, f64): ADMM warm start + 30 Newton-step IPM polish
    (solve_qcqp_polished).  Verdicts:
      feasible    := max_violation < 1e-4   (feasibility BY EXHIBITION at
                     Mosek's feasibility-tolerance scale -- a point that
                     satisfies all constraints to 1e-4 proves feasibility)
      infeasible  := the IPM's Farkas-style certificate fired
      undetermined:= neither (near-degenerate corridor widths; reported
                     separately, excluded from the agreement rate)

  device path (f32, same arithmetic as the headline): 48-iter ADMM,
    gate = max_violation < 1e-2 (and a strict 1e-4 variant).

Also reports the cost-gap distribution (f32 ADMM cost vs f64 interior-point
optimum) on scenarios both deem feasible -- the optimality price of the
headline's first-order gate.

Usage: python benchmarks/verdict_parity.py [--total=12288] [--chunk=2048]
       [--ipm-iters=30] [--router] [--write]

--write: update the canonical benchmarks/*_results.json this study is
recorded under (bench.py reports those numbers); without it results go to
a *_scratch.json so debug runs can't clobber the recorded study.

--router: route the device path through solver/auto.solve_qcqp_auto (ADMM
gate + selective IPM escalation + f64 tier-2) instead of the bare gated
ADMM, and score the ROUTER's verdicts against the ground truth -- the
round-2 VERDICT's "production verdict routing" done-criterion (agreement
>= 95% in every radius bucket).  Writes
benchmarks/verdict_parity_router_results.json.

(Always runs on CPU with x64: this is a STUDY tool, not a throughput bench.)
"""

import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np


def main():
    total, chunk, n_ipm = 12288, 2048, 30
    router = "--router" in sys.argv
    for a in sys.argv[1:]:
        if a.startswith("--total="):
            total = int(a.split("=")[1])
        if a.startswith("--chunk="):
            chunk = int(a.split("=")[1])
        if a.startswith("--ipm-iters="):
            n_ipm = int(a.split("=")[1])
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import bench
    from mav_tube_trajectory_generation.solver import auto, ipm, qcqp

    k = 10
    admm_kw = dict(rho=0.005, n_stages=1, n_iters=48,
                   rho_tube_factor=0.125, rho_half_factor=0.125,
                   padded_lanes=False)
    admm_cfg = qcqp.ADMMConfig(**admm_kw)
    ipm_cfg = ipm.IPMConfig(n_iters=n_ipm)
    free = bench.make_inputs(k, 1, seed=0)[1]   # static problem family

    def ground_truth(df_free, times, waypoints, radii):
        p = jax.vmap(lambda d1, d2, d3, d4: ipm.solve_qcqp_polished(
            free, d1, d2, d3, d4, admm_config=admm_cfg,
            ipm_config=ipm_cfg))(df_free, times, waypoints, radii)
        return p.max_violation, p.infeasible, p.cost

    gt_f = jax.jit(ground_truth)

    def run_chunk(df_free, times, waypoints, radii, values):
        # Device path: f32, the headline arithmetic INCLUDING its
        # position-constrained warm start (bench.py's warmstart_values).
        a32 = qcqp.solve_qcqp_batch(
            free, df_free.astype(jnp.float32), times.astype(jnp.float32),
            waypoints.astype(jnp.float32), radii.astype(jnp.float32),
            config=admm_cfg, warmstart_values=values.astype(jnp.float32),
            scenario_block=4)
        return a32.max_violation, a32.cost

    dev_f = jax.jit(run_chunk)

    def f(df_free, times, waypoints, radii, values):
        if router:
            # Router device path: host control flow (gate -> gathered
            # escalation), so not jitted end-to-end.  The router gets the
            # ORIGINAL f64 problem data -- its chip tiers cast to f32
            # internally and the f64 tier-2 solves the true problem (the
            # f32-rounded DATA itself perturbs 1e-4 feasibility margins
            # on near-degenerate corridors).
            res = auto.solve_qcqp_auto(
                free, jnp.asarray(df_free), times,
                jnp.asarray(waypoints), jnp.asarray(radii),
                warmstart_values=jnp.asarray(values))
            a_feas = jnp.asarray(res.verdict == auto.FEASIBLE)
            a_cost = res.solution.cost
            f.n_escalated += res.n_escalated
        else:
            a_viol, a_cost = dev_f(df_free, times, waypoints, radii, values)
            a_feas = a_viol < 1e-2
        p_viol, p_inf, p_cost = gt_f(df_free, times, waypoints, radii)
        return a_feas, a_cost, p_viol, p_inf, p_cost
    f.n_escalated = 0

    rows = []
    scales = []
    forced = []
    inputs = []     # per-chunk (df_free, times, waypoints, radii) for the
    t_solve = 0.0   # adaptive ground-truth escalation below
    for c0 in range(0, total, chunk):
        seed = c0 // chunk
        (_, _, _, df_free, times, waypoints, _, values) = bench.make_inputs(
            k, chunk, seed=seed)
        df_free = np.asarray(df_free, np.float64)
        times = jnp.asarray(np.asarray(times, np.float64))
        waypoints = np.asarray(waypoints, np.float64)
        # Radii scale: log-uniform over [0.02, 0.8] -- generous corridors
        # down to near-degenerate ones (waypoint spacing ~0.5-2.0/axis).
        rng = np.random.RandomState(1000 + seed)
        scale = np.exp(rng.uniform(np.log(0.02), np.log(0.8),
                                   size=(chunk, 1, 1)))
        radii = np.broadcast_to(scale, (chunk, k, 2)).copy()
        # 1/8 of the chunk: STRUCTURALLY infeasible -- offset the fixed
        # start position several radii off the corridor axis.  The first
        # segment's leading control points are constants of the fixed start
        # state, so their tube constraints are constant-violated: no
        # feasible point exists, and the IPM's Farkas-style certificate
        # (ipm.py) must fire.  Validates the infeasible side of the verdict.
        n_bad = chunk // 8
        off = rng.randn(n_bad, 3)
        off /= np.linalg.norm(off, axis=1, keepdims=True)
        df_free = df_free.copy()
        df_free[:n_bad, 0, :] += off * scale[:n_bad, 0] * 5.0
        is_forced = np.zeros(chunk, bool)
        is_forced[:n_bad] = True

        t0 = time.perf_counter()
        out = f(jnp.asarray(df_free), times, jnp.asarray(waypoints),
                jnp.asarray(radii), values)
        jax.block_until_ready(out)
        t_solve += time.perf_counter() - t0
        rows.append([np.asarray(o) for o in out])
        scales.append(scale[:, 0, 0])
        forced.append(is_forced)
        inputs.append((df_free, np.asarray(times), waypoints, radii))
        print(f"[parity] chunk {seed}: {chunk} scenarios "
              f"({t_solve:.1f}s cumulative)", flush=True)

    admm_feas, a_cost, p_viol, p_inf, p_cost = (
        np.concatenate([r[i] for r in rows]) for i in range(5))
    scale_all = np.concatenate(scales)
    forced_all = np.concatenate(forced)

    ipm_feas = p_viol < 1e-4            # feasibility by exhibition
    ipm_infeas = p_inf & ~ipm_feas      # Farkas-style certificate
    undetermined = ~ipm_feas & ~ipm_infeas
    n_und_30 = int(np.sum(undetermined))

    # Adaptive ground-truth escalation (round-4 VERDICT task #3): the
    # 30-iter recipe leaves near-degenerate corridors undetermined where
    # Mosek would return a definitive status; re-solve those rows -- and
    # the certificate-only rows, whose warm dynamic certificate can
    # false-fire where a longer run exhibits a feasible point -- with a
    # 4x iteration budget; exhibition outranks the certificate.
    und_idx = np.nonzero(undetermined | ipm_infeas)[0]
    if und_idx.size:
        all_df = np.concatenate([i[0] for i in inputs])
        all_t = np.concatenate([i[1] for i in inputs])
        all_w = np.concatenate([i[2] for i in inputs])
        all_r = np.concatenate([i[3] for i in inputs])
        long_cfg = ipm.IPMConfig(n_iters=4 * n_ipm)
        gt_long = jax.jit(jax.vmap(lambda d1, d2, d3, d4:
                                   ipm.solve_qcqp_polished(
                                       free, d1, d2, d3, d4,
                                       admm_config=admm_cfg,
                                       ipm_config=long_cfg)))
        nb = 1
        while nb < und_idx.size:
            nb *= 2
        pad = np.concatenate([und_idx, np.full(nb - und_idx.size,
                                               und_idx[-1])])
        pl = gt_long(jnp.asarray(all_df[pad]), jnp.asarray(all_t[pad]),
                     jnp.asarray(all_w[pad]), jnp.asarray(all_r[pad]))
        lv = np.asarray(pl.max_violation)[:und_idx.size]
        li = np.asarray(pl.infeasible)[:und_idx.size]
        p_viol[und_idx] = np.minimum(p_viol[und_idx], lv)
        p_inf[und_idx] = p_inf[und_idx] | li
        p_cost[und_idx] = np.where(lv < 1e-4, np.asarray(pl.cost)[
            :und_idx.size], p_cost[und_idx])
        ipm_feas = p_viol < 1e-4
        ipm_infeas = p_inf & ~ipm_feas
        undetermined = ~ipm_feas & ~ipm_infeas
        print(f"[parity] ground-truth escalation: {n_und_30} undetermined "
              f"at {n_ipm} iters -> {int(np.sum(undetermined))} at "
              f"{4 * n_ipm}", flush=True)

        # 3rd stage (round-5): RESTARTED f64 endgames on whatever remains.
        # The router's tier-1.5 lesson transfers to the ground truth:
        # restarts with fresh factors and re-centered warm duals land rows
        # a longer single run stalls on.  Each restart warm-starts from
        # the best iterate so far; the latest certificate replaces.
        warm = {int(g): j for j, g in enumerate(und_idx)}
        wdf = np.asarray(pl.d_free).copy()
        wlb = np.asarray(pl.dual_ball).copy()
        wlh = np.asarray(pl.dual_half).copy()
        for n_it in (2 * n_ipm, 2 * n_ipm):
            ui3 = np.nonzero(~(p_viol < 1e-4) & ~p_inf)[0]
            if ui3.size == 0:
                break
            nb3 = 1
            while nb3 < ui3.size:
                nb3 *= 2
            pad3 = np.concatenate([ui3, np.full(nb3 - ui3.size, ui3[-1])])
            wp3 = np.array([warm[int(i)] for i in pad3])
            gt_rs = jax.jit(jax.vmap(
                lambda d1, d2, d3, d4, xw, lb, lh: ipm.solve_qcqp_ipm(
                    free, d1, d2, d3, d4,
                    config=ipm.IPMConfig(n_iters=n_it),
                    x0=xw, lam0_ball=lb, lam0_half=lh)))
            pr = gt_rs(jnp.asarray(all_df[pad3]), jnp.asarray(all_t[pad3]),
                       jnp.asarray(all_w[pad3]), jnp.asarray(all_r[pad3]),
                       jnp.asarray(wdf[wp3]), jnp.asarray(wlb[wp3]),
                       jnp.asarray(wlh[wp3]))
            rv = np.asarray(pr.max_violation)[:ui3.size]
            ri = np.asarray(pr.infeasible)[:ui3.size]
            improved = rv < p_viol[ui3]
            p_viol[ui3] = np.minimum(p_viol[ui3], rv)
            p_inf[ui3] = ri
            p_cost[ui3] = np.where(rv < 1e-4,
                                   np.asarray(pr.cost)[:ui3.size],
                                   p_cost[ui3])
            rdf = np.asarray(pr.d_free)
            rlb = np.asarray(pr.dual_ball)
            rlh = np.asarray(pr.dual_half)
            for jl, grow in enumerate(ui3):
                if improved[jl]:
                    wdf[warm[int(grow)]] = rdf[jl]
                    wlb[warm[int(grow)]] = rlb[jl]
                    wlh[warm[int(grow)]] = rlh[jl]
            ipm_feas = p_viol < 1e-4
            ipm_infeas = p_inf & ~ipm_feas
            undetermined = ~ipm_feas & ~ipm_infeas
            print(f"[parity] ground-truth restart ({n_it} iters on "
                  f"{ui3.size} rows): {int(np.sum(undetermined))} "
                  f"undetermined remain", flush=True)
    det = ~undetermined

    report = {
        "mode": "router" if router else "gate",
        "n_escalated": int(f.n_escalated) if router else None,
        "n_total": int(total),
        "n_forced_infeasible": int(np.sum(forced_all)),
        "n_ipm_feasible": int(np.sum(ipm_feas)),
        "n_ipm_infeasible": int(np.sum(ipm_infeas)),
        "n_undetermined": int(np.sum(undetermined)),
        "n_undetermined_pre_escalation": n_und_30,
        # Certificate recall on the structurally infeasible slice.
        "certificate_recall": round(float(
            np.mean(ipm_infeas[forced_all])), 4) if np.any(forced_all)
        else None,
        # The gate never claims feasibility of an infeasible problem:
        "false_feasible": int(np.sum(admm_feas & ipm_infeas)),
        # Gate misses: IPM-feasible scenarios the 48-iter gate rejects.
        "gate_miss": int(np.sum(~admm_feas & ipm_feas)),
    }
    # Agreement bucketed by corridor width (the deployed regime is the
    # generous bucket; the sweep shows where the 48-iteration gate's
    # conservatism sets in).
    for name, lo, hi in (("r>=0.5", 0.5, np.inf), ("0.3<=r<0.5", 0.3, 0.5),
                         ("0.1<=r<0.3", 0.1, 0.3), ("r<0.1", 0.0, 0.1)):
        sel = det & (scale_all >= lo) & (scale_all < hi)
        if np.any(sel):
            report[f"agreement[{name}]"] = round(float(
                np.mean(admm_feas[sel] == ipm_feas[sel])), 5)
            report[f"n[{name}]"] = int(np.sum(sel))
    both = admm_feas & ipm_feas
    gap = (a_cost[both] - p_cost[both]) / np.maximum(np.abs(p_cost[both]),
                                                     1e-12)
    report.update({
        "n_both_feasible": int(np.sum(both)),
        "cost_gap_median": float(np.median(gap)) if gap.size else None,
        "cost_gap_p95": (float(np.percentile(gap, 95))
                         if gap.size else None),
        "cost_gap_p99": (float(np.percentile(gap, 99))
                         if gap.size else None),
        "seconds": round(t_solve, 2),
    })
    print("[parity] " + json.dumps(report), flush=True)
    # The canonical results files are what bench.py reports as "recorded"
    # studies: only overwrite them on an explicit --write (debug runs at
    # reduced --total otherwise silently replace the recorded study).
    out = ("benchmarks/verdict_parity_router_results.json" if router
           else "benchmarks/verdict_parity_results.json")
    if "--write" not in sys.argv:
        out = out.replace("_results.json", "_scratch.json")
        print(f"[parity] (scratch run; pass --write to update the "
              f"recorded study) -> {out}", flush=True)
    with open(out, "w") as fh:
        json.dump(report, fh, indent=1)


if __name__ == "__main__":
    main()
