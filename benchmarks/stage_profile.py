"""Device time of the plain ADMM stage and IPM eval step, from a trace.

Traces two programs at bench width (bench.make_inputs, B=6144, K=10) on the
GPU with ``jax.profiler``:

  * headline -- solve_qcqp_batch, the QP+QCQP pass (one ADMM stage of 48
    iterations per call);
  * tier0    -- the strict router's tier-0 program, ADMM + two snap-only
    Gauss-Newton sweeps (one ADMM stage and two IPM evaluations per call).

and reduces each trace to device time per name scope
(ops/admm_stage.SCOPE, ops/ipm_eval.SCOPE) by mapping every device event's
HLO instruction to the ``op_name`` metadata of the compiled module.  From
those times it reports the bytes each stage must move over the time, as a
share of the card's HBM bandwidth (PEAK_HBM below):

  * ADMM stage: 2 * B * nfd * m_p * 4 bytes per iteration (M1 and G^T each
    streamed once by the two matvecs);
  * IPM eval: B * nfd * m_p * 4 bytes (one stream of G^T, the least any
    implementation of the evaluation reads).

The script compiles with XLA's GPU command buffers and autotuning off
(XLA_FLAGS below): under command buffers the trace shows a whole graph of
kernels as one event with no HLO name to attribute, and the autotuner's
rewritten fusions carry no op_name of their own.  It exits non-zero when the
trace has no device plane or a scope reads zero time.

Usage: python benchmarks/stage_profile.py [--batch=6144] [--calls=3]
       [--out=chiprun_out/stage_profile.json]
"""

import glob
import json
import os
import re
import sys
import tempfile
import time

sys.path.insert(0, ".")

#: Read when the backend starts, so set before jax is imported.
TRACE_XLA_FLAGS = ("--xla_gpu_enable_command_buffer= "
                   "--xla_gpu_autotune_level=0")
os.environ["XLA_FLAGS"] = " ".join(
    f for f in (os.environ.get("XLA_FLAGS"), TRACE_XLA_FLAGS) if f)

#: Published HBM bandwidth by device_kind (NVIDIA H100 SXM data sheet).
PEAK_HBM = {"NVIDIA H100 80GB HBM3": 3.35e12}

_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.*)$")
_OPNAME = re.compile(r'op_name="([^"]*)"')
_CALLS = re.compile(r"calls=%?([\w.\-]+)")
_COMP = re.compile(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*\)\s*->.*\{\s*$")


def op_names(hlo_text: str) -> dict:
    """HLO instruction name -> op_name metadata.  A fusion (or any call)
    without metadata of its own takes its called computation's ROOT's."""
    own, calls, roots = {}, {}, {}
    comp = None
    for line in hlo_text.splitlines():
        m = _COMP.match(line)
        if m:
            comp = m.group(1)
            continue
        m = _INSTR.match(line)
        if not m:
            continue
        name, rest = m.group(1), m.group(2)
        on = _OPNAME.search(rest)
        if on:
            own[name] = on.group(1)
        c = _CALLS.search(rest)
        if c:
            calls[name] = c.group(1)
        if line.lstrip().startswith("ROOT") and comp is not None:
            roots[comp] = name
    out = dict(own)
    for name, comp_name in calls.items():
        if name in out:
            continue
        seen = set()
        while comp_name in roots and comp_name not in seen:
            seen.add(comp_name)
            root = roots[comp_name]
            if root in own:
                out[name] = own[root]
                break
            comp_name = calls.get(root)
    return out


def _union_ns(intervals):
    total, end = 0, -1
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def reduce_trace(xplane_path: str, hlo_text: str, scopes) -> dict:
    """Device time per scope (sum of event durations), device busy time
    (union of event intervals) and the window, in ns."""
    from jax.profiler import ProfileData
    names = op_names(hlo_text)
    prof = ProfileData.from_file(xplane_path)
    planes = [p for p in prof.planes if p.name.startswith("/device:")]
    if not planes:
        raise SystemExit(f"{xplane_path}: no /device plane in the trace")
    per_scope = {s: 0 for s in scopes}
    other = {}
    intervals, n_events = [], 0
    for plane in planes:
        lines = list(plane.lines)
        xla_ops = [ln for ln in lines if ln.name == "XLA Ops"]
        for line in (xla_ops or lines):
            for ev in line.events:
                st = dict(ev.stats)
                if "hlo_op" not in st:
                    continue
                n_events += 1
                dur = float(ev.duration_ns)
                intervals.append((float(ev.start_ns), float(ev.end_ns)))
                op = names.get(str(st["hlo_op"]), "")
                hit = [s for s in scopes if re.search(
                    rf"(^|[/(]){s}([)/]|$)", op)]
                if hit:
                    per_scope[hit[0]] += dur
                else:
                    key = (str(st["hlo_op"]), op)
                    other[key] = other.get(key, 0.0) + dur
    top = [[k[0], v, k[1]] for k, v in
           sorted(other.items(), key=lambda kv: -kv[1])[:15]]
    window = (max(e for _, e in intervals) - min(s for s, _ in intervals)
              if intervals else 0.0)
    return {"n_events": n_events, "scope_ns": per_scope,
            "busy_ns": _union_ns(intervals), "window_ns": window,
            "top_other_ns": top,
            "planes": [p.name for p in planes]}


def _trace(fn, args, calls: int, scopes):
    import jax
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(compiled(*args))               # warm
    t0 = time.perf_counter()
    for _ in range(calls):
        out = compiled(*args)
    jax.block_until_ready(out)
    wall = (time.perf_counter() - t0) / calls
    tdir = tempfile.mkdtemp(prefix="stage_profile_")
    with jax.profiler.trace(tdir):
        for _ in range(calls):
            out = compiled(*args)
        jax.block_until_ready(out)
    path = sorted(glob.glob(os.path.join(tdir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    red = reduce_trace(path, compiled.as_text(), scopes)
    red["wall_s_per_call"] = wall
    red["compile_s"] = compile_s
    return red


def main():
    batch, calls, out_path = 6144, 3, None
    for a in sys.argv[1:]:
        if a.startswith("--batch="):
            batch = int(a.split("=")[1])
        elif a.startswith("--calls="):
            calls = int(a.split("=")[1])
        elif a.startswith("--out="):
            out_path = a.split("=", 1)[1]
    import jax
    from bench import make_inputs
    from mav_tube_trajectory_generation.ops import admm_stage, ipm_eval
    from mav_tube_trajectory_generation.solver import ipm_lanes, qcqp
    from mav_tube_trajectory_generation.solver.ipm import IPMConfig
    from mav_tube_trajectory_generation.utils import compile_cache
    compile_cache.enable()
    dev = jax.devices()[0]

    (_, free, _, df, t, w, r, v) = make_inputs(10, batch)
    admm = qcqp.ADMMConfig(rho=0.005, n_stages=1, n_iters=48,
                           rho_tube_factor=0.125, rho_half_factor=0.125,
                           padded_lanes=True)
    snap = IPMConfig(n_iters=0, snap_iters=2, sigma_min=0.3,
                     corrector=False)
    layout = qcqp._flagship_layout(free)
    nfd = free.n_free * free.dimension
    g_bytes = batch * nfd * layout.m_p * 4           # one G^T stream
    scopes = (admm_stage.SCOPE, ipm_eval.SCOPE)

    progs = {
        "headline": (lambda *a: qcqp.solve_qcqp_batch(
            free, *a[:4], config=admm, warmstart_values=a[4],
            scenario_block=4).cost, 1, 0),
        "tier0": (lambda *a: ipm_lanes.solve_qcqp_polished_batch(
            free, *a[:4], admm_config=admm, ipm_config=snap,
            warmstart_values=a[4], scenario_block=4).max_violation, 1, 2),
    }
    peak = PEAK_HBM.get(dev.device_kind)
    report = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                         "count": len(jax.devices())},
              "batch": batch, "nfd": nfd, "m_p": layout.m_p,
              "calls": calls, "programs": {}}
    for name, (fn, n_stage, n_eval) in progs.items():
        red = _trace(fn, (df, t, w, r, v), calls, scopes)
        # A scope that reads zero was not attributed: None, not a time.
        stage_s = (red["scope_ns"][admm_stage.SCOPE] * 1e-9 / calls
                   / n_stage) or None
        red["admm_stage_s"] = stage_s
        red["admm_stage_bytes"] = 2 * g_bytes * admm.n_iters
        if n_eval:
            red["ipm_eval_s"] = (red["scope_ns"][ipm_eval.SCOPE] * 1e-9
                                 / calls / n_eval) or None
            red["ipm_eval_bytes"] = g_bytes
        if peak:
            red["admm_stage_hbm_share"] = (red["admm_stage_bytes"] / peak
                                           / stage_s) if stage_s else None
            if n_eval and red["ipm_eval_s"]:
                red["ipm_eval_hbm_share"] = (g_bytes / peak
                                             / red["ipm_eval_s"])
        red["idle_share"] = (1.0 - red["busy_ns"] / red["window_ns"]
                             if red["window_ns"] else None)
        report["programs"][name] = red
        line = {k: red.get(k) for k in (
            "compile_s", "wall_s_per_call", "admm_stage_s",
            "admm_stage_hbm_share", "ipm_eval_s", "ipm_eval_hbm_share",
            "idle_share", "n_events")}
        print(f"[stage_profile] {name}: {json.dumps(line)}", flush=True)
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as fh:
            json.dump(report, fh, indent=1, default=float)
    unread = [f"{name}/{scope}" for name, (_, n_stage, n_eval) in
              progs.items() for scope, n in ((admm_stage.SCOPE, n_stage),
                                             (ipm_eval.SCOPE, n_eval))
              if n and not report["programs"][name]["scope_ns"][scope]]
    if unread:
        raise SystemExit(f"no device time attributed to {unread}")
    if peak is None:
        raise SystemExit(f"no HBM peak for device_kind {dev.device_kind!r}")
    print(json.dumps(report["device"]))


if __name__ == "__main__":
    main()
