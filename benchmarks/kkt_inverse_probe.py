"""Block-Schur recursion vs library inverses for the solvers' SPD systems.

For the widths that recurse in ``ops/linalg.spd_inverse_schur`` -- 45 (the
K=10 linear solve's R_pp) and 135 (the unpadded ADMM KKT and the f64 tier's
dense systems) -- times three batched inverses of random SPD matrices at the
QCQP KKT's measured conditioning (2e2) on the default device:

  schur  linalg.spd_inverse_schur (recursion over library-LU leaves)
  lu     jnp.linalg.inv
  cho    jax.scipy.linalg.cho_solve(cho_factor(a), I)

and prints, per width and dtype, each one's compile time, wall time per
call (median of 5 synchronized calls) and worst residual max|A W - I|
(evaluated in float64).

Usage: python benchmarks/kkt_inverse_probe.py [--batch32=6144] [--batch64=256]
"""

import sys
import time

sys.path.insert(0, ".")


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from mav_tube_trajectory_generation.ops import linalg
    args = dict(a.lstrip("-").split("=") for a in sys.argv[1:])
    batch = {"float32": int(args.get("batch32", 6144)),
             "float64": int(args.get("batch64", 256))}
    eye_solve = lambda a: jax.scipy.linalg.cho_solve(
        jax.scipy.linalg.cho_factor(a), jnp.broadcast_to(
            jnp.eye(a.shape[-1], dtype=a.dtype), a.shape))
    methods = {"schur": linalg.spd_inverse_schur, "lu": jnp.linalg.inv,
               "cho": eye_solve}
    dev = jax.devices()[0]
    print(f"[kkt_inverse_probe] {dev.platform} {dev.device_kind}")
    hi = jax.lax.Precision.HIGHEST
    for dtype in ("float32", "float64"):
        with jax.enable_x64(True):
            for n in (45, 135):
                key = jax.random.PRNGKey(n)
                q, _ = jnp.linalg.qr(jax.random.normal(
                    key, (batch[dtype], n, n), jnp.float64))
                eig = jnp.logspace(0.0, np.log10(2e2), n)
                a64 = jnp.einsum("bij,j,bkj->bik", q, eig, q, precision=hi)
                a = a64.astype(dtype)
                for name, fn in methods.items():
                    t0 = time.perf_counter()
                    f = jax.jit(fn).lower(a).compile()
                    compile_s = time.perf_counter() - t0
                    w = jax.block_until_ready(f(a))
                    times = []
                    for _ in range(5):
                        t0 = time.perf_counter()
                        jax.block_until_ready(f(a))
                        times.append(time.perf_counter() - t0)
                    res = float(jnp.max(jnp.abs(jnp.matmul(
                        a64, w.astype(jnp.float64), precision=hi)
                        - jnp.eye(n))))
                    print(f"[kkt_inverse_probe] {dtype} n={n} "
                          f"B={batch[dtype]} {name}: compile "
                          f"{compile_s:.2f} s, {np.median(times) * 1e3:.3f} "
                          f"ms/call, residual {res:.2e}", flush=True)


if __name__ == "__main__":
    main()
