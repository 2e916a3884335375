"""Test configuration: CPU backend with 8 virtual devices, float64 enabled.

Parity tests run against float64 NumPy oracles (the reference is C++ double);
the virtual 8-device mesh exercises the multi-device sharding paths without
accelerator hardware (SURVEY.md section 4, final paragraph).  The platform
is pinned through ``jax.config`` (honored at backend-init time), so the
suite runs on the CPU whatever the environment's default device.  Checks
that need the GPU are in ``chip_smoke.py``, run on the card.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
