"""Tests for batched interval root-finding and extrema (ops.roots).

Mirrors the reference property-test pattern: analytic min/max vs brute-force
sampling oracle (test_polynomial.cpp:36-137) plus cross-checks against the
companion-matrix root oracle.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from mav_tube_trajectory_generation.ops import roots


def test_roots_in_interval_vs_companion():
    rng = np.random.RandomState(0)
    for trial in range(30):
        coeffs = rng.randn(8)
        t0, t1 = 0.0, 3.0
        r = roots.roots_in_interval(jnp.asarray(coeffs), t0, t1)
        ours = sorted(np.asarray(r.roots)[np.asarray(r.valid)])
        oracle = roots.roots_companion(coeffs)
        oracle_real = sorted(
            z.real for z in oracle
            if abs(z.imag) < 1e-9 and t0 - 1e-12 <= z.real <= t1 + 1e-12)
        # Every companion root that's a sign crossing must be found. Filter
        # tangential (even multiplicity) roots: check sign change around it.
        poly = np.polynomial.Polynomial(coeffs)
        crossing_roots = [
            x for x in oracle_real
            if np.sign(poly(x - 1e-7)) * np.sign(poly(x + 1e-7)) < 0
            and t0 + 1e-7 < x < t1 - 1e-7]
        assert len(ours) >= len(crossing_roots)
        for cr in crossing_roots:
            assert min(abs(cr - o) for o in ours) < 1e-8, (trial, cr, ours)


def test_minmax_vs_sampling_oracle():
    # 100 random polynomials x derivatives {0, 1, 2}, sampled oracle at 1e-3
    # resolution, 1e-2 tolerance -- the reference's exact protocol
    # (test_polynomial.cpp:36-137).
    rng = np.random.RandomState(1)
    n = 10
    coeffs = rng.uniform(-5, 5, size=(100, n))
    t0, t1 = 0.0, 2.5
    ts = np.arange(t0, t1 + 1e-3, 1e-3)
    for derivative in [0, 1, 2]:
        mm = roots.minmax_in_interval(jnp.asarray(coeffs), t0, t1, derivative)
        v_min = np.asarray(mm.v_min)
        v_max = np.asarray(mm.v_max)
        for i in range(100):
            vals = np.polynomial.Polynomial(coeffs[i]).deriv(derivative)(ts)
            assert v_min[i] == pytest.approx(vals.min(), abs=1e-2), i
            assert v_max[i] == pytest.approx(vals.max(), abs=1e-2), i


def test_magnitude_candidates_vs_sampling():
    # Vector-magnitude extrema candidates per segment
    # (test_polynomial_optimization.cpp:307-406 pattern).
    rng = np.random.RandomState(2)
    n, dim = 10, 3
    coeffs = rng.uniform(-2, 2, size=(20, n, dim))
    t1 = 2.0
    for derivative in [1, 2]:
        cand_t, valid = roots.magnitude_minmax_candidates(
            jnp.asarray(coeffs), derivative, 0.0, t1)
        cand_t = np.asarray(cand_t)
        valid = np.asarray(valid)
        ts = np.arange(0, t1 + 1e-4, 1e-4)
        for i in range(20):
            mags = np.zeros_like(ts)
            for d in range(dim):
                mags += np.polynomial.Polynomial(
                    coeffs[i, :, d]).deriv(derivative)(ts) ** 2
            mags = np.sqrt(mags)
            cand_vals = []
            for t, ok in zip(cand_t[i], valid[i]):
                if ok:
                    m = 0.0
                    for d in range(dim):
                        m += np.polynomial.Polynomial(
                            coeffs[i, :, d]).deriv(derivative)(t) ** 2
                    cand_vals.append(np.sqrt(m))
            # The sampled max/min must be attained among analytic candidates.
            assert max(cand_vals) == pytest.approx(mags.max(), abs=1e-2), i
            assert min(cand_vals) == pytest.approx(mags.min(), abs=1e-2), i


def test_constant_polynomial_no_roots():
    r = roots.roots_in_interval(jnp.asarray([3.0, 0.0, 0.0]), 0.0, 1.0)
    assert not np.any(np.asarray(r.valid))


def test_exact_gridpoint_root():
    # Root exactly at a grid node: p(t) = t - 0.5 with 256 cells on [0, 1]
    # puts 0.5 exactly on a node.
    r = roots.roots_in_interval(jnp.asarray([-0.5, 1.0]), 0.0, 1.0)
    found = np.asarray(r.roots)[np.asarray(r.valid)]
    assert len(found) == 1
    assert found[0] == pytest.approx(0.5, abs=1e-12)
