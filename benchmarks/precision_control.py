"""Precision control for the reference bounds of chip_smoke.py.

Runs the smoke's linear and headline phases with every full-float32 matmul
pin lowered to TF32: the solver entry points' ``linear.full_matmul_precision``
and the explicit ``Precision.HIGHEST`` of the ADMM stage, the block-Schur
inverse and the Gram band.  For each phase it prints whether the phase's
checks reject the run.  A bound that a TF32 run passes cannot tell a sound
run from one that lost precision.  The CPU references are unaffected: the
CPU computes float32 matmuls in full precision whatever the setting.

Exits 0 when both phases reject the control, 1 otherwise.

Usage: python benchmarks/precision_control.py      (needs a GPU)
"""

import contextlib
import sys
import time

sys.path.insert(0, ".")


def lower_pins():
    """Every full-f32 pin of the package becomes TF32 from here on."""
    import jax
    from mav_tube_trajectory_generation.ops import admm_stage

    class _TF32:     # read as jax.lax.Precision.HIGHEST at trace time
        HIGHEST = HIGH = DEFAULT = None

    jax.config.update("jax_default_matmul_precision", "tensorfloat32")
    jax.default_matmul_precision = lambda _: contextlib.nullcontext()
    jax.lax.Precision = _TF32
    admm_stage._HIGHEST = None


def main():
    import jax
    jax.config.update("jax_platforms", "cuda,cpu")
    import chip_smoke as cs
    cs.require_gpu()
    print(f"[precision_control] card: {cs.card_line()}", flush=True)
    from bench import make_inputs
    inputs = make_inputs(cs.K, cs.BATCH)
    lower_pins()
    rejected = {}
    for name, fn, args in (("linear", cs.phase_linear, ()),
                           ("headline", cs.phase_headline, (inputs,))):
        t0 = time.perf_counter()
        try:
            msg = fn(*args)
            rejected[name] = False
        except cs.SmokeFailure as e:
            msg = str(e)
            rejected[name] = True
        print(f"[precision_control] {name} "
              f"{'REJECTS' if rejected[name] else 'PASSES'} TF32 "
              f"({time.perf_counter() - t0:.1f} s) -- {msg}", flush=True)
    sys.exit(0 if all(rejected.values()) else 1)


if __name__ == "__main__":
    main()
