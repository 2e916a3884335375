"""Vertex (waypoint) model, generators and segment-time heuristics.

Host-side mirror of the reference ``Vertex`` API
(/root/reference/include/mav_tube_trajectory_generation/vertex.h:42-174,
src/vertex.cpp) plus the bridge into the static/batched device representation:
``vertices_to_arrays`` converts a vertex list into the (fixed_mask,
vertex_values) pair consumed by ``solver.structure`` / ``solver.linear``.

The time-allocation heuristics (estimateSegmentTimes* / computeTimeVelocityRamp,
vertex.cpp:228-287) are provided both as host helpers and as batched jnp
functions over position arrays so scenario generation can stay on device.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import jax.numpy as jnp

from .. import motion_defines
from ..solver.structure import ProblemStructure, make_structure


class Vertex:
    """A waypoint holding a map {derivative order -> value (D,)}.

    Mirrors vertex.h:42-174.  This is a host-side builder object; the solver
    consumes the arrays produced by ``vertices_to_arrays``.
    """

    def __init__(self, dimension: int):
        self.dimension = int(dimension)
        self.constraints: Dict[int, np.ndarray] = {}

    def _coerce(self, value) -> np.ndarray:
        v = np.atleast_1d(np.asarray(value, dtype=np.float64))
        if v.shape != (self.dimension,):
            raise ValueError(
                f"Constraint value must have dimension {self.dimension}, "
                f"got shape {v.shape}.")
        return v

    def add_constraint(self, derivative_order: int, value) -> None:
        self.constraints[int(derivative_order)] = self._coerce(value)

    def remove_constraint(self, derivative_order: int) -> bool:
        return self.constraints.pop(int(derivative_order), None) is not None

    def make_start_or_end(self, position, up_to_derivative: int) -> None:
        """Pin position and zero derivatives 1..up_to_derivative (vertex.cpp:147-153)."""
        self.add_constraint(motion_defines.POSITION, position)
        for d in range(1, up_to_derivative + 1):
            self.constraints[d] = np.zeros(self.dimension)

    def has_constraint(self, derivative_order: int) -> bool:
        return int(derivative_order) in self.constraints

    def get_constraint(self, derivative_order: int) -> Optional[np.ndarray]:
        return self.constraints.get(int(derivative_order))

    def is_equal_tol(self, other: "Vertex", tol: float) -> bool:
        if set(self.constraints) != set(other.constraints):
            return False
        return all(np.all(np.abs(v - other.constraints[k]) <= tol)
                   for k, v in self.constraints.items())

    def get_subdimension(self, subdimensions: Sequence[int],
                         max_derivative_order: int) -> "Vertex":
        """Project onto a subset of spatial dimensions (vertex.cpp:184-207)."""
        sub = Vertex(len(subdimensions))
        for d, v in self.constraints.items():
            if d > max_derivative_order:
                continue
            sub.add_constraint(d, v[list(subdimensions)])
        return sub

    def __repr__(self):
        items = ", ".join(
            f"{motion_defines.position_derivative_to_string(k)}={v}"
            for k, v in sorted(self.constraints.items()))
        return f"Vertex(D={self.dimension}, {items})"


def vertices_to_arrays(vertices: Sequence[Vertex], n_coefficients: int = 10,
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Convert a vertex list to (fixed_mask (V, N/2), values (V, N/2, D)).

    Constraints of order > N/2 - 1 are dropped with the same semantics as the
    reference's setup sanitization (linear_impl.h:74-95).  Unconstrained
    entries get value 0 (ignored by the solver).
    """
    h = n_coefficients // 2
    v = len(vertices)
    if v < 2:
        raise ValueError("Need at least two vertices.")
    dim = vertices[0].dimension
    mask = np.zeros((v, h), dtype=bool)
    values = np.zeros((v, h, dim), dtype=np.float64)
    for i, vert in enumerate(vertices):
        if vert.dimension != dim:
            raise ValueError("All vertices must share the same dimension.")
        for d, val in vert.constraints.items():
            if d > h - 1:
                # warn-and-ignore semantics of linear_impl.h:82-88.
                warnings.warn(
                    f"Vertex {i}: ignoring constraint of derivative order "
                    f"{d} > N/2-1 = {h - 1} (not representable with "
                    f"N={n_coefficients} coefficients).", stacklevel=2)
                continue
            mask[i, d] = True
            values[i, d] = val
    return mask, values


def structure_from_vertices(vertices: Sequence[Vertex],
                            n_coefficients: int = 10,
                            derivative_to_optimize: Optional[int] = None
                            ) -> Tuple[ProblemStructure, np.ndarray]:
    """(ProblemStructure, vertex_values) from a vertex list."""
    mask, values = vertices_to_arrays(vertices, n_coefficients)
    structure = make_structure(mask, vertices[0].dimension, n_coefficients,
                               derivative_to_optimize)
    return structure, values


# ---------------------------------------------------------------------------
# Random/test vertex generators (vertex.cpp:27-128).
# ---------------------------------------------------------------------------

def create_random_vertices(maximum_derivative: int, n_segments: int,
                           pos_min: np.ndarray, pos_max: np.ndarray,
                           seed: int = 0) -> List[Vertex]:
    """Random waypoint chain with fully pinned endpoints (vertex.cpp:27-82)."""
    pos_min = np.asarray(pos_min, dtype=np.float64)
    pos_max = np.asarray(pos_max, dtype=np.float64)
    if pos_min.shape != pos_max.shape:
        raise ValueError("pos_min/pos_max must have equal size.")
    if np.linalg.norm(pos_max - pos_min) < 0.2:
        raise ValueError("Bounding box too small.")
    dim = pos_min.size
    rng = np.random.RandomState(seed)
    min_distance = 0.2

    def draw():
        return pos_min + rng.uniform(size=dim) * (pos_max - pos_min)

    last = draw()
    verts = [Vertex(dim)]
    verts[0].make_start_or_end(last, maximum_derivative)
    for _ in range(n_segments):
        while True:
            pos = draw()
            if np.linalg.norm(pos - last) > min_distance:
                break
        vtx = Vertex(dim)
        vtx.add_constraint(motion_defines.POSITION, pos)
        verts.append(vtx)
        last = pos
    verts[-1].make_start_or_end(last, maximum_derivative)
    return verts


def create_random_vertices_1d(maximum_derivative: int, n_segments: int,
                              pos_min: float, pos_max: float,
                              seed: int = 0) -> List[Vertex]:
    return create_random_vertices(maximum_derivative, n_segments,
                                  np.array([pos_min]), np.array([pos_max]), seed)


def create_square_vertices(maximum_derivative: int, center,
                           side_length: float, rounds: int) -> List[Vertex]:
    """Square loop path (vertex.cpp:84-120)."""
    center = np.asarray(center, dtype=np.float64)
    s = side_length / 2.0
    corners = [center + np.array([-s, -s, 0.0]),
               center + np.array([-s, s, 0.0]),
               center + np.array([s, s, 0.0]),
               center + np.array([s, -s, 0.0])]
    verts = [Vertex(3)]
    verts[0].make_start_or_end(corners[0], maximum_derivative)
    for _ in range(rounds):
        for c in corners[1:] + [corners[0]]:
            vtx = Vertex(3)
            vtx.add_constraint(motion_defines.POSITION, c)
            verts.append(vtx)
    verts[-1] = Vertex(3)
    verts[-1].make_start_or_end(corners[0], maximum_derivative)
    return verts


# ---------------------------------------------------------------------------
# Segment-time heuristics (vertex.cpp:228-287), host + batched device forms.
# ---------------------------------------------------------------------------

def _positions_from_vertices(vertices: Sequence[Vertex]) -> np.ndarray:
    pos = []
    for v in vertices:
        p = v.get_constraint(motion_defines.POSITION)
        if p is None:
            raise ValueError("All vertices need a position constraint for "
                             "time estimation.")
        pos.append(p)
    return np.stack(pos)


def estimate_segment_times(vertices: Sequence[Vertex], v_max: float,
                           a_max: float) -> np.ndarray:
    """Default heuristic == Nfabian (vertex.cpp:228-231)."""
    return estimate_segment_times_nfabian(vertices, v_max, a_max)


def estimate_segment_times_nfabian(vertices: Sequence[Vertex], v_max: float,
                                   a_max: float,
                                   magic_fabian_constant: float = 6.5
                                   ) -> np.ndarray:
    pos = _positions_from_vertices(vertices)
    return np.asarray(segment_times_nfabian(pos, v_max, a_max,
                                            magic_fabian_constant))


def estimate_segment_times_velocity_ramp(vertices: Sequence[Vertex],
                                         v_max: float, a_max: float,
                                         time_factor: float = 1.0
                                         ) -> np.ndarray:
    pos = _positions_from_vertices(vertices)
    return np.asarray(segment_times_velocity_ramp(pos, v_max, a_max)) * time_factor


def segment_times_nfabian(positions: jnp.ndarray, v_max: float, a_max: float,
                          magic_fabian_constant: float = 6.5) -> jnp.ndarray:
    """Batched Nfabian heuristic: t = 2 d/v (1 + 6.5 v/a e^{-2 d/v}).

    Args:
      positions: (..., V, D) waypoint positions.
    Returns:
      (..., V-1) segment times.  Reference: vertex.cpp:252-269.
    """
    positions = jnp.asarray(positions)
    d = jnp.linalg.norm(jnp.diff(positions, axis=-2), axis=-1)
    return (d / v_max * 2.0
            * (1.0 + magic_fabian_constant * v_max / a_max
               * jnp.exp(-d / v_max * 2.0)))


def segment_times_velocity_ramp(positions: jnp.ndarray, v_max: float,
                                a_max: float) -> jnp.ndarray:
    """Batched trapezoidal-ramp heuristic (vertex.cpp:233-250, 271-287)."""
    positions = jnp.asarray(positions)
    d = jnp.linalg.norm(jnp.diff(positions, axis=-2), axis=-1)
    acc_time = v_max / a_max
    acc_distance = 0.5 * v_max * acc_time
    short = 2.0 * jnp.sqrt(d / a_max)
    long = 2.0 * acc_time + (d - 2.0 * acc_distance) / v_max
    return jnp.where(d < 2.0 * acc_distance, short, long)
