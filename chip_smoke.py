"""Chip smoke test: the trajectory engine's main path once, on the GPU.

Runs in ONE process, at bench width (bench.make_inputs), through the entry
points a user calls, and checks every phase against the repo's plain
references, each computed on the host CPU device:

  1. linear    K in {2, 10, 50, 100}, B=2048, dense (solve_linear) and
               banded (solve_linear_banded) vs the f64 C++ oracle
               (native.solve_linear_cpp) on 16 rows; the same rows solved
               in f32 on the CPU bound the GPU's error (TF32 would show).
  2. headline  solve_qcqp_batch QP+QCQP, B=6144, K=10 (bench.py config):
               >= 6080/6144 under 1e-2; 64 rows vs the unpadded
               solve_qcqp scan path in f64 on the CPU, per derivative
               order (D_FREE_BOUNDS) and in cost.
  3. strict    solve_qcqp_strict, B=6144: every verdict determinate;
               32 escalated rows vs the parity study's f64 ground truth
               (ipm.solve_qcqp_polished, 120 Newton steps), which must
               decide every one of them.
  4. tight     solve_qcqp_strict on 256 rows at radii log-uniform in
               [0.05, 0.3]: tier 2 fires, compiles f64 programs and
               leaves its results on the GPU.
  5. extrema   solve + max_magnitude, B=6144, vs dense sampling; and
     nonlinear zoom L-BFGS time optimisation, B=1024: cost never rises.

``--four-cards`` runs solve_qcqp_strict_sharded on a 4-card mesh at B=6144
against solve_qcqp_strict on one card, on the whole batch and on its four
shares: verdicts and the strict count must equal the single-card router's,
and the rows the sharded tier 0 escalates must be the ones the single-card
router escalates on the shares.

One line per phase goes to stdout with its wall time (compilation
included); the card's name and power limit come first, and the last line is
one JSON object naming the device.  A platform other than ``gpu`` is an
error.  Any failed check exits non-zero.

Usage: python chip_smoke.py                # one card, phases 1-5
       python chip_smoke.py --four-cards   # four cards, the sharded router
"""

import dataclasses
import json
import logging
import subprocess
import sys
import time

import numpy as np

K = 10
BATCH = 6144


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def require_gpu(n_devices: int = 1):
    """The default backend's devices; raises unless they are GPUs and there
    are at least ``n_devices`` of them."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"chip_smoke needs a GPU; JAX found "
                           f"{devs[0].platform} ({devs[0].device_kind})")
    if len(devs) < n_devices:
        raise RuntimeError(f"need {n_devices} GPUs, found {len(devs)}")
    return devs


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60)
    return out.stdout.strip()


def _cpu():
    import jax
    return jax.devices("cpu")[0]


def _on_cpu(fn, *arrays, x64: bool):
    """Run ``fn`` jitted on the host CPU device, from host copies."""
    import jax
    import jax.numpy as jnp
    with jax.enable_x64(x64), jax.default_device(_cpu()):
        dt = jnp.float64 if x64 else jnp.float32
        args = [jnp.asarray(np.asarray(a), dt) for a in arrays]
        return jax.device_get(jax.jit(fn)(*args))


def _timed(fn, *args):
    """(seconds of the second call, output): the first call compiles."""
    import jax
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return time.perf_counter() - t0, out


def phase_linear(batch=2048, ks=(2, 10, 50, 100), n_ref=16):
    import jax
    from bench import make_inputs
    from mav_tube_trajectory_generation import native
    from mav_tube_trajectory_generation.solver import banded, linear
    parts = []
    for k in ks:
        std, _, dfk, _, tk, _, _, vals = make_inputs(k, batch, seed=1)
        solvers = {"dense": lambda a, b, s=std: linear.solve_linear(s, a, b),
                   "banded": lambda a, b, s=std: banded.solve_linear_banded(
                       s, a, b)}
        vals_np = np.asarray(vals, np.float64)
        t_np = np.asarray(tk, np.float64)
        cpp = np.stack([native.solve_linear_cpp(
            std.fixed_mask, vals_np[i], t_np[i], std.derivative_to_optimize,
            std.n_coefficients) for i in range(n_ref)])
        scale = np.abs(cpp).max(axis=(1, 2, 3)) + 1.0
        for name, solve in solvers.items():
            f = jax.jit(jax.vmap(solve))
            dt, sol = _timed(f, dfk, tk)
            coef = np.asarray(sol.coefficients)
            check(np.isfinite(coef).all(), f"linear {name} K={k}: non-finite")
            err_gpu = (np.abs(coef[:n_ref] - cpp).max(axis=(1, 2, 3))
                       / scale).max()
            coef_cpu = _on_cpu(jax.vmap(solve), dfk[:n_ref], tk[:n_ref],
                               x64=False).coefficients
            err_cpu = (np.abs(coef_cpu - cpp).max(axis=(1, 2, 3))
                       / scale).max()
            # f32 on either device; both sum in another order, so the GPU
            # may sit a small factor off the CPU -- TF32 (~1e-3 relative)
            # would sit orders of magnitude off.
            check(err_cpu < 1e-2 and err_gpu <= 10.0 * err_cpu + 1e-6,
                  f"linear {name} K={k}: rel err gpu {err_gpu:.2e} "
                  f"cpu-f32 {err_cpu:.2e}")
            parts.append(f"K={k} {name} {batch / dt:,.0f}/s "
                         f"err {err_gpu:.1e} (cpu-f32 {err_cpu:.1e})")
    return "; ".join(parts)


def _bench_admm():
    from mav_tube_trajectory_generation.solver import qcqp
    # bench.py's headline config.
    return qcqp.ADMMConfig(rho=0.005, n_stages=1, n_iters=48,
                           rho_tube_factor=0.125, rho_half_factor=0.125,
                           padded_lanes=True)


#: Headline reference bounds.  At the bench config (rho 0.005, 48
#: over-relaxed iterations, not converged) f32 rounding alone moves the
#: iterate well beyond rounding: on the CPU, over the 64 reference rows, f32
#: vs f64 differ by up to 1.2e-2 / 4.1e-2 / 7.1e-2 / 5.8e-2 / 2.0e-1 of each
#: derivative order's scale (position .. snap; padded and unpadded f32
#: paths, the larger of the two) and by 3.2e-3 in cost.  The bounds are
#: about 2.5x those readings.
D_FREE_BOUNDS = np.array([3e-2, 1e-1, 2e-1, 1.5e-1, 5e-1])
COST_BOUND = 1e-2


def d_free_order_errors(free, d_free, d_ref):
    """Largest error over rows of d_free against d_ref, per derivative
    order: in each row, each order's entries are measured against that
    order's largest |d_ref| (a velocity error is a fraction of the row's
    velocities, not of its positions).  Returns (n_orders,)."""
    order = np.asarray(free.free_cols)[:, 1]
    errs = []
    for o in np.unique(order):
        sel = order == o
        scale = np.abs(d_ref[:, sel]).max(axis=(1, 2))
        errs.append((np.abs(d_free[:, sel] - d_ref[:, sel]).max(axis=(1, 2))
                     / scale).max())
    return np.asarray(errs)


def phase_headline(inputs, n_ref=64, min_ok=6080):
    import jax
    from mav_tube_trajectory_generation.solver import qcqp
    (_, free, _, df_free, times, waypoints, radii, values) = inputs
    batch = int(df_free.shape[0])
    admm = _bench_admm()

    def full_solve(df, t, w, r, v):
        con = qcqp.solve_qcqp_batch(free, df, t, w, r, config=admm,
                                    warmstart_values=v, scenario_block=4)
        return con.cost, con.max_violation, con.d_free

    dt, (cost, viol, d_free) = _timed(jax.jit(full_solve), df_free, times,
                                      waypoints, radii, values)
    cost, viol, d_free = (np.asarray(a) for a in (cost, viol, d_free))
    n_ok = int(np.sum(np.isfinite(cost) & (viol < 1e-2)))
    # Reference: the unpadded reference-layout scan path, f64, same config
    # and iteration count.
    cfg_ref = dataclasses.replace(admm, padded_lanes=False)
    ref = _on_cpu(lambda df, t, w, r, v: qcqp.solve_qcqp_batch(
        free, df, t, w, r, config=cfg_ref, warmstart_values=v),
        df_free[:n_ref], times[:n_ref], waypoints[:n_ref], radii[:n_ref],
        values[:n_ref], x64=True)
    d_err = d_free_order_errors(free, d_free[:n_ref], np.asarray(ref.d_free))
    c_err = (np.abs(cost[:n_ref] - ref.cost) / np.abs(ref.cost)).max()
    readings = (f"{n_ok}/{batch} under 1e-2; median viol "
                f"{np.median(viol):.2e}; {n_ref} rows vs the f64 scan path: "
                f"d_free by derivative order "
                f"{'/'.join(f'{e:.1e}' for e in d_err)} of the order's "
                f"scale, cost {c_err:.1e}")
    check(n_ok >= min_ok, f"headline: {readings} (need {min_ok} under 1e-2)")
    check((d_err < D_FREE_BOUNDS).all() and c_err < COST_BOUND,
          f"headline: {readings} (bounds "
          f"{'/'.join(f'{b:g}' for b in D_FREE_BOUNDS)}, {COST_BOUND:g})")
    return f"{batch / dt:,.0f} solves/s ({dt * 1e3:.1f} ms/batch); {readings}"


def phase_strict(inputs, n_ref=32, **router_kw):
    import jax
    from mav_tube_trajectory_generation.solver import auto, ipm
    (_, free, _, df_free, times, waypoints, radii, values) = inputs
    batch = int(df_free.shape[0])

    def run():
        return auto.solve_qcqp_strict(free, df_free, times, waypoints, radii,
                                      warmstart_values=values, **router_kw)

    run()                                          # compile
    t0 = time.perf_counter()
    res = run()
    dt = time.perf_counter() - t0
    viol = np.asarray(res.solution.max_violation)
    n_det = int(np.sum(res.verdict != auto.UNDETERMINED))
    n_strict = int(np.sum(viol < 1e-4))
    check(n_det == batch, f"strict: {n_det}/{batch} determinate")
    check((viol[res.verdict == auto.FEASIBLE] < 1e-4).all(),
          "strict: a FEASIBLE verdict without a strict point")
    esc = np.nonzero(res.escalated)[0][:n_ref]
    check(esc.size > 0, "strict: no row escalated")
    # Reference: the parity study's f64 ground truth
    # (benchmarks/verdict_parity.py) -- unpadded ADMM warm start plus the
    # interior-point polish at its 4x budget of 120 Newton steps -- on the
    # CPU.  Every compared row must be decided by it.
    ref_admm = dataclasses.replace(_bench_admm(), padded_lanes=False)
    ref = _on_cpu(jax.vmap(lambda df, t, w, r: ipm.solve_qcqp_polished(
        free, df, t, w, r, admm_config=ref_admm,
        ipm_config=ipm.IPMConfig(n_iters=120))),
        df_free[esc], times[esc], waypoints[esc], radii[esc], x64=True)
    ref_feas = np.asarray(ref.max_violation) < 1e-4
    ref_inf = np.asarray(ref.infeasible) & ~ref_feas
    check((ref_feas | ref_inf).all(),
          f"strict: the f64 reference leaves "
          f"{int(np.sum(~(ref_feas | ref_inf)))}/{esc.size} rows undecided")
    ref_verdict = np.where(ref_feas, auto.FEASIBLE, auto.INFEASIBLE)
    check(np.array_equal(res.verdict[esc], ref_verdict),
          f"strict: {int(np.sum(res.verdict[esc] != ref_verdict))}/"
          f"{esc.size} verdicts differ from the f64 reference")
    # Cost gap on feasible rows: the recorded router parity study
    # (benchmarks/verdict_parity_router_results.json) has p99 5.2e-3; 1e-2
    # bounds it.
    cost = np.asarray(res.solution.cost)[esc][ref_feas]
    ref_cost = np.asarray(ref.cost)[ref_feas]
    gap = np.abs(cost - ref_cost) / np.abs(ref_cost)
    check(gap.size == 0 or gap.max() < 1e-2,
          f"strict: cost gap vs the f64 reference {gap.max():.2e}")
    return (f"{batch / dt:,.0f} solves/s ({dt * 1e3:.1f} ms/batch); "
            f"{res.n_escalated} escalated; {n_strict}/{batch} strict; "
            f"{n_det}/{batch} determinate; tiers(last) "
            f"{np.bincount(res.tier, minlength=5).tolist()}; {esc.size} "
            f"escalated rows vs the f64 reference: all decided "
            f"({int(ref_feas.sum())} feasible, {int(ref_inf.sum())} "
            f"infeasible), verdicts equal, cost gap "
            f"{gap.max() if gap.size else 0.0:.1e}")


class _CompileLog(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def phase_tight(batch=256, rmin=0.05, rmax=0.3):
    import jax
    import jax.numpy as jnp
    from bench import make_inputs
    from mav_tube_trajectory_generation.solver import auto
    (_, free, _, df_free, times, waypoints, _, values) = make_inputs(K, batch)
    rng = np.random.RandomState(7)             # benchmarks/strict_tight.py
    scale = np.exp(rng.uniform(np.log(rmin), np.log(rmax),
                               size=(batch, 1, 1)))
    radii = jnp.asarray(np.broadcast_to(scale, (batch, K, 2)).astype(
        np.float32).copy())
    # Every jit lowering logs "Compiling <fn> with global shapes and types
    # ..." at DEBUG; collect those records quietly for the f64 check.
    log = _CompileLog()
    lower_log = logging.getLogger("jax._src.interpreters.pxla")
    saved = (lower_log.level, lower_log.propagate)
    lower_log.addHandler(log)
    lower_log.setLevel(logging.DEBUG)
    lower_log.propagate = False
    try:
        t0 = time.perf_counter()
        res = auto.solve_qcqp_strict(free, df_free, times, waypoints, radii,
                                     warmstart_values=values)
        dt = time.perf_counter() - t0
    finally:
        lower_log.removeHandler(log)
        lower_log.setLevel(saved[0])
        lower_log.propagate = saved[1]
    n_t15 = int(np.sum(np.isin(res.tier, (2, 3))))
    n_t2 = int(np.sum(res.tier == 4))
    n_det = int(np.sum(res.verdict != auto.UNDETERMINED))
    check(n_t2 > 0, "tight: tier 2 did not fire")
    f64_progs = [m for m in log.messages
                 if m.startswith("Compiling") and "float64" in m]
    check(f64_progs, "tight: no f64 program was compiled for tier 2")
    platforms = {d.platform for d in res.solution.d_free.devices()}
    check(platforms == {jax.devices()[0].platform},
          f"tight: merged results on {platforms}")
    viol = np.asarray(res.solution.max_violation)
    check((viol[res.verdict == auto.FEASIBLE] < 1e-4).all(),
          "tight: a FEASIBLE verdict without a strict point")
    return (f"{dt:.1f} s for {batch} rows (compilation included); "
            f"{res.n_escalated} escalated; {n_t15} rows last ran tier 1.5; "
            f"{n_t2} rows reached tier 2 (f64 on {sorted(platforms)[0]}, "
            f"{len(f64_progs)} f64 programs compiled); "
            f"{n_det}/{batch} determinate")


def phase_extrema(inputs, n_ref=64, n_samples=4096):
    import jax
    import jax.numpy as jnp
    from mav_tube_trajectory_generation.models import trajectory as tj
    from mav_tube_trajectory_generation.solver import linear
    (std, _, df_std, _, times, _, _, _) = inputs
    batch = int(df_std.shape[0])

    def solve_and_check(df, t):
        sol = linear.solve_linear(std, df, t)
        traj = tj.Trajectory(sol.coefficients, sol.times)
        return (sol.coefficients, tj.max_magnitude(traj, 1, n_grid=64).value,
                tj.max_magnitude(traj, 2, n_grid=64).value)

    dt, (coef, vmax, amax) = _timed(jax.jit(jax.vmap(solve_and_check)),
                                    df_std, times)
    coef, vmax, amax = (np.asarray(a) for a in (coef, vmax, amax))
    check(np.isfinite(vmax).all() and np.isfinite(amax).all(),
          "extrema: non-finite")

    def sampled(c, t):
        traj = tj.Trajectory(c, t)
        ts = jnp.linspace(0.0, jnp.sum(t), n_samples)
        return (jnp.max(jnp.linalg.norm(tj.evaluate(traj, ts, 1), axis=-1)),
                jnp.max(jnp.linalg.norm(tj.evaluate(traj, ts, 2), axis=-1)))

    sv, sa = _on_cpu(jax.vmap(sampled), coef[:n_ref], times[:n_ref],
                     x64=True)
    for name, ext, smp in (("vmax", vmax[:n_ref], sv), ("amax", amax[:n_ref],
                                                        sa)):
        # Dense sampling can only under-read the true maximum; the root-
        # found extremum must sit at or just above it.
        check((ext >= smp * (1 - 1e-4) - 1e-4).all()
              and (ext <= smp * (1 + 1e-2) + 1e-3).all(),
              f"extrema: {name} disagrees with dense sampling")
    return (f"{batch / dt:,.0f} scenarios/s; median vmax "
            f"{np.median(vmax):.2f}, amax {np.median(amax):.2f}; {n_ref} rows "
            f"match {n_samples}-point sampling")


def phase_nonlinear(batch=1024, n_iters=5):
    import jax
    from bench import make_inputs
    from mav_tube_trajectory_generation.solver import nonlinear
    (std, _, df_std, _, times, _, _, _) = make_inputs(K, batch)
    params = nonlinear.NonlinearParameters(
        objective=nonlinear.Objective.TIME, max_iterations=n_iters,
        time_penalty=500.0, use_soft_constraints=False)   # zoom L-BFGS
    f = jax.jit(jax.vmap(lambda a, b: nonlinear.optimize_time_gradient(
        std, a, b, params, n_iters=n_iters)))
    dt, (t_opt, hist) = _timed(f, df_std, times)
    hist = np.asarray(hist)
    check(np.isfinite(hist).all() and np.isfinite(np.asarray(t_opt)).all(),
          "nonlinear: non-finite")
    check((hist[:, -1] <= hist[:, 0] * (1 + 1e-6)).all(),
          "nonlinear: cost rose")
    return (f"{batch / dt:,.0f} scenarios/s ({n_iters} zoom L-BFGS iters); "
            f"median cost {np.median(hist[:, 0]):.4g} -> "
            f"{np.median(hist[:, -1]):.4g}")


def _twice(fn):
    """(seconds of the first call, compilation included; seconds of the
    second; the second's output)."""
    t0 = time.perf_counter()
    fn()
    t1 = time.perf_counter()
    out = fn()
    return t1 - t0, time.perf_counter() - t1, out


def phase_four_cards(inputs, devices):
    from mav_tube_trajectory_generation.parallel import mesh as pmesh
    from mav_tube_trajectory_generation.solver import auto
    (_, free, _, df_free, times, waypoints, radii, values) = inputs
    batch = int(df_free.shape[0])
    n_cards = 4
    quarter = batch // n_cards
    mesh = pmesh.make_mesh(devices[:n_cards])

    def single(lo=0, hi=batch):
        return auto.solve_qcqp_strict(
            free, df_free[lo:hi], times[lo:hi], waypoints[lo:hi],
            radii[lo:hi], warmstart_values=values[lo:hi])

    cold4, warm4, (res4, n_strict4) = _twice(
        lambda: auto.solve_qcqp_strict_sharded(
            free, df_free, times, waypoints, radii, mesh=mesh,
            warmstart_values=values))
    # Each card's tier 0 is the single-card tier 0 on that card's share of
    # the batch: the same batch in n_cards single-card batches, no
    # sharding, must put the same rows through the gate.
    parts = [single(i * quarter, (i + 1) * quarter) for i in range(n_cards)]
    esc_parts = np.concatenate([r.escalated for r in parts])
    cold1, warm1, res1 = _twice(single)
    n_strict1 = int(np.sum(np.asarray(res1.solution.max_violation) < 1e-4))
    check(np.array_equal(res4.escalated, esc_parts),
          f"four-cards: gate membership differs from the single-card "
          f"router on the {n_cards} shares on "
          f"{int(np.sum(res4.escalated != esc_parts))} rows")
    # Tier-1 defaults differ between the sharded and the single-card
    # router (it10 vs it6 + the speculative restart), so iterates differ:
    # verdicts must not.
    for name, v in (("the single-card router", res1.verdict),
                    (f"its {n_cards} shares",
                     np.concatenate([r.verdict for r in parts]))):
        check(np.array_equal(res4.verdict, v),
              f"four-cards: {int(np.sum(res4.verdict != v))} verdicts "
              f"differ from {name}")
    check(int(n_strict4) == n_strict1,
          f"four-cards: n_strict {int(n_strict4)} vs {n_strict1}")
    # Against the whole batch on one card, gate membership moves with the
    # batch shape (f32 rounding through the unconverged ADMM); the check
    # above shows those rows are the shares' own.
    flip = int(np.sum(res4.escalated != res1.escalated))
    return (f"sharded {warm4 * 1e3:.1f} ms/batch ({cold4:.1f} s cold) vs "
            f"single-card {warm1 * 1e3:.1f} ms/batch ({cold1:.1f} s cold); "
            f"{res4.n_escalated} escalated, the same rows as the "
            f"single-card router on the {n_cards} shares "
            f"({sum(r.n_escalated for r in parts)}); {res1.n_escalated} "
            f"escalated on the whole batch ({flip} rows differ); n_strict "
            f"{int(n_strict4)}/{batch} on both; verdict vectors identical")


def main(argv):
    four_cards = "--four-cards" in argv
    import jax
    # The CPU device hosts the references; the GPU stays the default.
    jax.config.update("jax_platforms", "cuda,cpu")
    devices = require_gpu(4 if four_cards else 1)
    from mav_tube_trajectory_generation.utils import compile_cache
    compile_cache.enable()
    print(f"[chip_smoke] card: {card_line()}", flush=True)
    print(f"[chip_smoke] jax {jax.__version__}, {len(devices)} x "
          f"{devices[0].device_kind}", flush=True)

    from bench import make_inputs
    inputs = make_inputs(K, BATCH)

    def run(name, fn, *args, **kw):
        t0 = time.perf_counter()
        msg = fn(*args, **kw)
        print(f"[chip_smoke] {name}: ok in {time.perf_counter() - t0:.1f} s"
              f" -- {msg}", flush=True)

    if four_cards:
        run("four-cards", phase_four_cards, inputs, devices)
    else:
        run("linear", phase_linear)
        run("headline", phase_headline, inputs)
        run("strict", phase_strict, inputs, scenario_block=4, tier1_block=8)
        run("tight", phase_tight)
        run("extrema", phase_extrema, inputs)
        run("nonlinear", phase_nonlinear)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main(sys.argv[1:])
