"""CPU-side checks of the chip smoke script and the compile-cache placement.

The smoke run itself needs the GPU (``python chip_smoke.py``); here only its
refusal to run elsewhere and the shared cache placement are checked.
"""

import os

import jax
import numpy as np
import pytest

import chip_smoke
from mav_tube_trajectory_generation.utils import compile_cache


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(env_set, monkeypatch, tmp_path):
    if env_set:
        monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path / "cc"))
        assert compile_cache.cache_dir() == str(tmp_path / "cc")
    else:
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
        want = os.path.join(compile_cache.CHECKOUT_ROOT, ".jax_cache")
        assert compile_cache.cache_dir() == want
        # A fixed path: the checkout root holds the package.
        assert os.path.isdir(os.path.join(compile_cache.CHECKOUT_ROOT,
                                          "mav_tube_trajectory_generation"))


def test_compile_cache_enable_defers_to_env(monkeypatch, tmp_path):
    """With the variable set, JAX reads it itself: enable() returns it and
    sets no cache directory in the config."""
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path / "cc"))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable() == str(tmp_path / "cc")
    assert jax.config.jax_compilation_cache_dir == before


def test_chip_smoke_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="needs a GPU"):
        chip_smoke.require_gpu()


def test_d_free_order_errors_scale_each_order():
    """Each derivative order's error is a fraction of that order's own
    largest |value| in the row, not of the row's positions."""
    from mav_tube_trajectory_generation.solver import structure as sm
    free = sm.make_structure(sm.free_interior_mask(3, 10), 3, 10)
    order = np.asarray(free.free_cols)[:, 1]
    d_ref = np.where(order[None, :, None] == 0, 10.0, 1.0) * np.ones(
        (2, free.n_free, 3))
    d = d_ref.copy()
    d[1, order == 1, 0] += 0.1            # velocity off by 0.1 in row 1
    d[0, order == 0, 2] -= 0.5            # position off by 0.5 in row 0
    errs = chip_smoke.d_free_order_errors(free, d, d_ref)
    want = np.zeros(errs.shape)
    want[0], want[1] = 0.05, 0.1
    np.testing.assert_allclose(errs, want, rtol=1e-12)
