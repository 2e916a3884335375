"""Scenario-parallel execution over device meshes.

The reference is strictly single-threaded, single-process
(SURVEY.md section 2 note); the batch/multi-host dimension is new
territory: thousands of independent waypoint-set scenarios are sharded over a
1-D ("data") device mesh with ``shard_map``.  Each scenario's QP/QCQP solves
entirely on one chip -- communication is only batch scatter/gather and
``psum`` metric reductions over the interconnect, so scaling is embarrassingly
parallel by construction (the >= 80% multi-host scaling target of
BASELINE.json).

Multi-host usage: call ``jax.distributed.initialize()`` once per host (see
``initialize_distributed``), build the mesh over ``jax.devices()``, and feed
per-host shards via ``jax.make_array_from_process_local_data``.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..solver import linear
from ..solver.structure import ProblemStructure

DATA_AXIS = "data"


def initialize_distributed(**kwargs) -> None:
    """Multi-host bring-up: jax.distributed.initialize passthrough.

    No-op when already initialized; any real bring-up error (bad
    coordinator address, unreachable peers, ...) propagates -- silently
    degrading to single-process on a misconfigured pod would corrupt
    every psum'd metric downstream.
    """
    if jax.distributed.is_initialized():
        return
    jax.distributed.initialize(**kwargs)


def make_mesh(devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """1-D scenario-parallel mesh over all (or the given) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (DATA_AXIS,))


def pad_batch(n: int, n_shards: int) -> int:
    """Smallest multiple of n_shards >= n (ragged-batch padding)."""
    return ((n + n_shards - 1) // n_shards) * n_shards


class BatchMetrics(NamedTuple):
    """Cross-device metric reductions (psum over the data axis)."""
    n_scenarios: jnp.ndarray
    n_finite: jnp.ndarray
    total_cost: jnp.ndarray
    max_cost: jnp.ndarray


def _shard_solve(structure: ProblemStructure, d_fixed, times):
    sol = jax.vmap(lambda df, t: linear.solve_linear(structure, df, t))(
        d_fixed, times)
    finite = jnp.isfinite(sol.cost)
    metrics = BatchMetrics(
        n_scenarios=jax.lax.psum(jnp.asarray(sol.cost.shape[0], jnp.float32),
                                 DATA_AXIS),
        n_finite=jax.lax.psum(jnp.sum(finite.astype(jnp.float32)), DATA_AXIS),
        total_cost=jax.lax.psum(jnp.sum(jnp.where(finite, sol.cost, 0.0)),
                                DATA_AXIS),
        max_cost=jax.lax.pmax(jnp.max(jnp.where(finite, sol.cost, -jnp.inf)),
                              DATA_AXIS),
    )
    return sol, metrics


def solve_linear_sharded(structure: ProblemStructure,
                         mesh: Mesh,
                         d_fixed: jnp.ndarray,
                         times: jnp.ndarray):
    """Batched linear solve sharded over the scenario axis.

    Args:
      structure: static problem family.
      mesh: 1-D mesh with axis ``"data"``.
      d_fixed: (B, n_fixed, D); B must be divisible by mesh size
        (use ``pad_batch``).
      times: (B, K).

    Returns:
      (LinearSolution with leading axis B sharded over the mesh,
       BatchMetrics replicated).
    """
    fn = jax.shard_map(
        functools.partial(_shard_solve, structure),
        mesh=mesh,
        in_specs=(P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=(P(DATA_AXIS),
                   BatchMetrics(P(), P(), P(), P())),
    )
    return fn(d_fixed, times)


def solve_qcqp_sharded(structure: ProblemStructure,
                       mesh: Mesh,
                       d_fixed: jnp.ndarray,
                       times: jnp.ndarray,
                       waypoints: jnp.ndarray,
                       radii: jnp.ndarray,
                       config=None,
                       x0: Optional[jnp.ndarray] = None,
                       scenario_block: int = 4):
    """Tube-QCQP batch sharded over the scenario axis (B divisible by mesh
    size; use ``pad_batch``).  Each shard runs the batch locally via
    ``qcqp.solve_qcqp_batch`` -- no cross-scenario communication; a
    psum'd feasibility count crosses the interconnect.

    Returns (QCQPSolution sharded over the data axis, n_feasible replicated).
    """
    from ..solver import qcqp as qcqp_mod
    if config is None:
        config = qcqp_mod.ADMMConfig()

    def shard(df, t, w, r, xx=None):
        sol = qcqp_mod.solve_qcqp_batch(structure, df, t, w, r,
                                        config=config, x0=xx,
                                        scenario_block=scenario_block)
        n_ok = jax.lax.psum(
            jnp.sum((sol.max_violation < 1e-2).astype(jnp.float32)),
            DATA_AXIS)
        return sol, n_ok

    # x0=None is not shardable, so the cold-start case gets its own
    # shard function: each shard then runs solve_qcqp_batch's OWN internal
    # cold start (the unconstrained minimum) -- identical behavior to the
    # unsharded API, instead of a silently different zeros start.
    n_args = 4 if x0 is None else 5
    fn = jax.shard_map(
        shard, mesh=mesh,
        in_specs=(P(DATA_AXIS),) * n_args,
        out_specs=(P(DATA_AXIS), P()))
    if x0 is None:
        return fn(d_fixed, times, waypoints, radii)
    return fn(d_fixed, times, waypoints, radii, x0)


def shard_scenarios(fn: Callable[..., Any], mesh: Mesh, n_args: int):
    """Wrap an arbitrary per-scenario function for scenario-parallel execution.

    ``fn`` maps a tuple of per-scenario-batch arrays (leading batch axis) to a
    pytree of arrays with leading batch axis; the wrapper shards all inputs
    and outputs over the data axis.
    """
    return jax.shard_map(
        fn, mesh=mesh,
        in_specs=tuple(P(DATA_AXIS) for _ in range(n_args)),
        out_specs=P(DATA_AXIS))
