"""External ground-truth slice for the Mosek-verdict parity study.

Round-2 VERDICT missing #1: the 12k-scenario parity study's ground truth is
the repo's OWN f64 ADMM+IPM -- self-referential.  The reference's authority
is an external interior-point solver (Mosek, qcqp_impl.h:709-770).  This
study grounds the claim externally: scipy's SLSQP (an independent
sequential-least-squares QP implementation, f64; see solve_scipy for the
trust-constr comparison) solves the EXACT same QCQPs --
objective 0.5 x^T kron(R_pp, I3) x + q^T x, ball constraints
0.5(||A_i x + b_i||^2 - r_i^2) <= 0, half-space rows -- on a slice
stratified across the four corridor-radius buckets plus the
forced-infeasible slice, and we compare:

  * verdicts: scipy-feasible (constr_violation < 1e-6 at its optimum,
    feasibility by exhibition) vs the f64 IPM ground truth's verdict;
    for scenarios scipy leaves violated, a dedicated feasibility
    minimization (L-BFGS on sum max(c,0)^2) confirms no feasible point
    exists before calling them externally-infeasible.
  * optima: the IPM's polished point evaluated in scipy's objective vs
    scipy's optimum -- relative gap distribution (target <= 1e-6 median).

Usage: python benchmarks/external_parity.py [--per-bucket=96] [--out=...]
(CPU, x64; a STUDY tool -- wall time dominated by scipy, ~1-2 s/scenario.)
"""

import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np


def scenario_tensors(free, df, t, w, r):
    """NumPy QCQP data for one scenario: P (nfd,nfd), q (nfd,), ball
    (A (n_ball,3,nfd), b (n_ball,3), rad (n_ball,)), half (G (n_half,nfd),
    h (n_half,))."""
    import jax.numpy as jnp
    from mav_tube_trajectory_generation.solver import linear, qcqp
    nf = free.n_fixed
    rmat = np.asarray(linear.assemble_r(free, jnp.asarray(t)))
    r_pf, r_pp = rmat[nf:, :nf], rmat[nf:, nf:]
    nfree, dim = r_pp.shape[0], free.dimension
    nfd = nfree * dim
    p_mat = np.kron(r_pp, np.eye(dim))
    q = (r_pf @ df).reshape(nfd)
    cons = qcqp.build_constraints(free, jnp.asarray(t), jnp.asarray(df),
                                  jnp.asarray(w), jnp.asarray(r))
    a_ball = np.asarray(cons.g_ball).reshape(
        np.asarray(cons.g_ball).shape[0], 3, nfd)
    return (p_mat, q, a_ball, np.asarray(cons.b_ball),
            np.asarray(cons.r_ball), np.asarray(cons.g_half).reshape(
                np.asarray(cons.g_half).shape[0], nfd),
            np.asarray(cons.b_half))


def solve_scipy(data, x0):
    """SLSQP on one scenario (analytic objective + constraint jacobians;
    measured ~0.3 s/scenario at the flagship size vs ~700 s for
    trust-constr at the same accuracy -- both reach ~1e-13 violations).
    Returns (x, fun, max_violation, success)."""
    from scipy.optimize import minimize
    p_mat, q, a_ball, b_ball, rad, g_half, b_half = data

    def fun(x):
        return 0.5 * x @ p_mat @ x + q @ x

    def jac(x):
        return p_mat @ x + q

    def cons_f(x):
        # SLSQP convention: feasible = all >= 0.
        y = a_ball @ x + b_ball                       # (n_ball, 3)
        return np.concatenate([
            -0.5 * (np.sum(y * y, axis=1) - rad * rad),
            -(g_half @ x + b_half)])

    def cons_j(x):
        y = a_ball @ x + b_ball
        return -np.concatenate(
            [np.einsum('ic,icn->in', y, a_ball), g_half], axis=0)

    res = minimize(fun, x0, jac=jac, method="SLSQP",
                   constraints=[{"type": "ineq", "fun": cons_f,
                                 "jac": cons_j}],
                   options={"maxiter": 400, "ftol": 1e-12})
    viol = float(np.max(-cons_f(res.x), initial=-np.inf))
    return res.x, float(res.fun), viol, bool(res.status == 0)


def min_violation(data, x0):
    """Feasibility subproblem: min sum max(c,0)^2 via L-BFGS -- external
    confirmation that no feasible point exists (value stays positive)."""
    from scipy.optimize import minimize
    p_mat, q, a_ball, b_ball, rad, g_half, b_half = data

    def phi(x):
        y = a_ball @ x + b_ball
        cb = 0.5 * (np.sum(y * y, axis=1) - rad * rad)
        ch = g_half @ x + b_half
        vb, vh = np.maximum(cb, 0.0), np.maximum(ch, 0.0)
        g = (np.einsum('i,ic,icn->n', 2.0 * vb, y, a_ball)
             + 2.0 * vh @ g_half)
        return float(np.sum(vb * vb) + np.sum(vh * vh)), g

    best = None
    for seed in range(3):
        rng = np.random.RandomState(seed)
        xs = x0 + (0.0 if seed == 0 else rng.randn(x0.size))
        res = minimize(phi, xs, jac=True, method="L-BFGS-B",
                       options={"maxiter": 2000, "ftol": 1e-18,
                                "gtol": 1e-14})
        if best is None or res.fun < best:
            best = float(res.fun)
    return best


def main():
    per_bucket, out_path = 96, "benchmarks/external_parity_results.json"
    for a in sys.argv[1:]:
        if a.startswith("--per-bucket="):
            per_bucket = int(a.split("=")[1])
        if a.startswith("--out="):
            out_path = a.split("=")[1]
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import bench
    from mav_tube_trajectory_generation.solver import ipm, linear, qcqp

    k = 10
    buckets = [(0.5, 0.8), (0.3, 0.5), (0.1, 0.3), (0.02, 0.1)]
    n = per_bucket * len(buckets)
    n_forced = n // 8

    (_, free, _, df_all, t_all, w_all, _, v_all) = bench.make_inputs(
        k, n, seed=42)
    df_all = np.array(df_all, np.float64)
    t_all = np.array(t_all, np.float64)
    w_all = np.array(w_all, np.float64)
    rng = np.random.RandomState(7)
    scale = np.concatenate([
        np.exp(rng.uniform(np.log(lo), np.log(hi), per_bucket))
        for lo, hi in buckets])
    rng.shuffle(scale)
    radii = np.broadcast_to(scale[:, None, None], (n, k, 2)).copy()
    off = rng.randn(n_forced, 3)
    off /= np.linalg.norm(off, axis=1, keepdims=True)
    df_all[:n_forced, 0, :] += off * scale[:n_forced, None] * 5.0
    forced = np.zeros(n, bool)
    forced[:n_forced] = True

    # Repo ground truth: f64 ADMM + 30-step IPM polish (the same recipe the
    # 12k parity study trusts -- here it is the thing under test).
    admm_cfg = qcqp.ADMMConfig(rho=0.005, n_stages=1, n_iters=48,
                               rho_tube_factor=0.125, rho_half_factor=0.125,
                               padded_lanes=False)
    ipm_cfg = ipm.IPMConfig(n_iters=30)
    gt = jax.jit(jax.vmap(lambda d1, d2, d3, d4: ipm.solve_qcqp_polished(
        free, d1, d2, d3, d4, admm_config=admm_cfg, ipm_config=ipm_cfg)))(
        jnp.asarray(df_all), jnp.asarray(t_all), jnp.asarray(w_all),
        jnp.asarray(radii))
    gt_viol = np.asarray(gt.max_violation)
    gt_inf = np.asarray(gt.infeasible)
    gt_dfree = np.asarray(gt.d_free)
    ipm_feas = gt_viol < 1e-4
    ipm_infeas = gt_inf & ~ipm_feas

    # Warm start for scipy: the unconstrained linear solution (a neutral
    # start -- NOT the IPM point, so scipy walks its own path to the
    # optimum).
    del v_all
    ws = jax.jit(jax.vmap(lambda d1, d2: linear.solve_free_derivatives(
        free, d1, d2)))(jnp.asarray(df_all), jnp.asarray(t_all))
    x0_all = np.asarray(ws).reshape(n, -1)

    rows = []
    x_sp_all = np.zeros((n, x0_all.shape[1]))
    t0 = time.perf_counter()
    for i in range(n):
        data = scenario_tensors(free, df_all[i], t_all[i], w_all[i],
                                radii[i])
        x, f_sp, viol_sp, ok = solve_scipy(data, x0_all[i])
        x_sp_all[i] = x
        sp_feas = viol_sp < 1e-6
        phi_min = None
        if not sp_feas:
            phi_min = min_violation(data, x0_all[i])
        rows.append(dict(scale=float(scale[i]), forced=bool(forced[i]),
                         sp_feas=bool(sp_feas), sp_viol=viol_sp,
                         sp_fun=f_sp, sp_ok=ok, phi_min=phi_min,
                         ipm_feas=bool(ipm_feas[i]),
                         ipm_infeas=bool(ipm_infeas[i])))
        if (i + 1) % 32 == 0:
            print(f"[external] {i + 1}/{n} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)

    # Optimum comparison in the library's FULL cost convention (0.5 d^T R d
    # including the fixed block: positive, O(1)-scaled -- the raw QP value
    # drops a large constant, making relative gaps meaningless).
    d_free_sp = x_sp_all.reshape(n, -1, 3)
    cost_sp = np.asarray(jax.jit(jax.vmap(
        lambda d1, dfr, d2: linear.solve_linear_with_free(
            free, d1, dfr, d2).cost))(
        jnp.asarray(df_all), jnp.asarray(d_free_sp), jnp.asarray(t_all)))
    cost_ipm = np.asarray(gt.cost)
    for i, r in enumerate(rows):
        r["sp_cost"] = float(cost_sp[i])
        r["ipm_cost"] = float(cost_ipm[i])

    sp_feas_a = np.array([r["sp_feas"] for r in rows])
    ipm_feas_a = np.array([r["ipm_feas"] for r in rows])
    ipm_inf_a = np.array([r["ipm_infeas"] for r in rows])
    det = ipm_feas_a | ipm_inf_a
    agree = sp_feas_a == ipm_feas_a
    # Externally-confirmed infeasible: scipy violated AND the feasibility
    # minimization stayed positive (scaled threshold).
    ext_inf = np.array([
        (not r["sp_feas"]) and r["phi_min"] is not None
        and r["phi_min"] > (1e-8 * max(r["scale"], 1e-3)) ** 2
        for r in rows])
    both = sp_feas_a & ipm_feas_a
    f_sp = np.array([r["sp_cost"] for r in rows])
    f_ip = np.array([r["ipm_cost"] for r in rows])
    gap = np.abs(f_ip[both] - f_sp[both]) / np.maximum(np.abs(f_sp[both]),
                                                       1e-12)
    report = {
        "n_total": n, "n_forced": int(n_forced),
        "n_scipy_feasible": int(sp_feas_a.sum()),
        "n_ipm_feasible": int(ipm_feas_a.sum()),
        "n_ipm_infeasible": int(ipm_inf_a.sum()),
        "n_undetermined": int((~det).sum()),
        "verdict_agreement[det]": round(float(np.mean(agree[det])), 5),
        "false_feasible_vs_scipy": int(np.sum(ipm_feas_a & ext_inf)),
        "infeasible_confirmed_externally": int(
            np.sum(ipm_inf_a & ext_inf)),
        "infeasible_confirm_rate": (round(float(
            np.mean(ext_inf[ipm_inf_a])), 4) if ipm_inf_a.any() else None),
        "n_both_feasible": int(both.sum()),
        "cost_gap_median": float(np.median(gap)) if gap.size else None,
        "cost_gap_p95": (float(np.percentile(gap, 95)) if gap.size
                         else None),
        "cost_gap_max": float(gap.max()) if gap.size else None,
        "seconds": round(time.perf_counter() - t0, 1),
    }
    scale_a = np.array([r["scale"] for r in rows])
    for name, lo, hi in (("r>=0.5", 0.5, np.inf), ("0.3<=r<0.5", 0.3, 0.5),
                         ("0.1<=r<0.3", 0.1, 0.3), ("r<0.1", 0.0, 0.1)):
        sel = det & (scale_a >= lo) & (scale_a < hi)
        if sel.any():
            report[f"agreement[{name}]"] = round(float(
                np.mean(agree[sel])), 5)
            report[f"n[{name}]"] = int(sel.sum())
    print("[external] " + json.dumps(report), flush=True)
    with open(out_path, "w") as fh:
        json.dump({"report": report, "rows": rows}, fh, indent=1)


if __name__ == "__main__":
    main()
