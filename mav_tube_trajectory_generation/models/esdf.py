"""Dense Euclidean signed-distance field for collision costs (octree replacement).

The reference queries a supereight octree: stack traversal collecting occupied
voxels in a 20^3 bounding box, then a brute-force nearest-voxel scan per query
(findOccupiedVoxels / getDistanceOctree, nonlinear_impl.h:1920-2043) -- a
pointer-chasing, data-dependent workload that does not batch.  The
reference itself contains a dormant ESDF path (nonlinear_impl.h:2045-2141)
legitimizing the dense-grid equivalent.

Batched design: a dense occupancy grid is converted ONCE to an exact
Euclidean distance transform with a separable min-plus reduction (for each
axis: D[i] = min_j (A[j] + (i-j)^2) -- an O(n^2)-per-axis broadcasted
min-reduction that XLA vectorizes trivially and that is exact, unlike
sweeping approximations).  Queries are batched trilinear interpolation
(gather + lerp), fully differentiable for the collision-gradient path, which
replaces the reference's central-difference potential gradient
(getCostAndGradientPotentialOctree, nonlinear_impl.h:1782-1917).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class Esdf(NamedTuple):
    """Distance field: distance[i,j,k] = distance (meters) from the center of
    voxel (i,j,k) to the nearest occupied voxel."""
    distance: jnp.ndarray       # (X, Y, Z) float
    origin: jnp.ndarray         # (3,) world position of voxel (0,0,0) center
    resolution: jnp.ndarray     # () voxel edge length


def _minplus_1d(sq: jnp.ndarray, axis: int) -> jnp.ndarray:
    """D[i] = min_j (sq[j] + (i - j)^2) along ``axis`` (voxel units)."""
    n = sq.shape[axis]
    sq = jnp.moveaxis(sq, axis, -1)
    i = jnp.arange(n)
    pairwise = (i[:, None] - i[None, :]).astype(sq.dtype) ** 2   # (n, n)
    out = jnp.min(sq[..., None, :] + pairwise, axis=-1)
    return jnp.moveaxis(out, -1, axis)


def esdf_from_occupancy(occupancy: jnp.ndarray,
                        origin,
                        resolution: float,
                        dtype=jnp.float32,
                        signed: bool = True,
                        method: str = "auto") -> Esdf:
    """Exact (signed) EDT of an occupancy grid (True/1 = occupied).

    For free voxels: distance to the nearest occupied voxel center (the
    reference's getDistanceOctree semantics, nonlinear_impl.h:2031-2043).
    With ``signed=True`` (default), occupied voxels get MINUS the distance to
    the nearest free voxel -- a deliberate improvement over the reference,
    whose unsigned octree distance is 0 everywhere inside an obstacle,
    leaving the collision potential gradient-free exactly where the
    optimizer most needs a push outward (it papers over this with an
    is_collision abort, impl:1718-1724).  An all-free map gets a large
    finite distance everywhere.

    ``method``: "xla" = in-graph min-plus reduction (traceable, O(n^2) per
    axis -- fine to ~128^3); "native" = host C++ Felzenszwalb O(n) per axis
    (native/edt.cpp -- the pod-scale-map path, e.g. 512^3, where the XLA
    broadcast's (..., n, n) memory blows up); "auto" picks native for
    concrete 3-D grids above 64^3 voxels when the toolchain is available.
    Both are exact; outputs match to float32 rounding.
    """
    occ_is_concrete = not isinstance(occupancy, jax.core.Tracer)
    if method == "auto":
        use_native = False
        if occ_is_concrete:
            occ_np = np.asarray(occupancy, bool)
            if occ_np.ndim == 3 and occ_np.size > 64 ** 3:
                from .. import native
                use_native = native.edt_available()
        method = "native" if use_native else "xla"

    if method == "native":
        if not occ_is_concrete:
            raise ValueError("method='native' needs a concrete (host) grid, "
                             "not a tracer; use method='xla' under jit.")
        from .. import native
        occ_np = np.asarray(occupancy, bool)
        big = float(sum(s ** 2 for s in occ_np.shape) + 1)
        sq = np.nan_to_num(native.edt_squared_cpp(occ_np), posinf=big)
        dist = np.sqrt(sq, dtype=np.float32)
        if signed:
            sq_in = np.nan_to_num(native.edt_squared_cpp(~occ_np), posinf=big)
            dist = dist - np.sqrt(sq_in, dtype=np.float32)
        dist = jnp.asarray(dist * np.float32(resolution), dtype)
        return Esdf(distance=dist,
                    origin=jnp.asarray(origin, dtype),
                    resolution=jnp.asarray(resolution, dtype))
    if method != "xla":
        raise ValueError(f"method must be 'auto', 'xla' or 'native', "
                         f"got {method!r}")

    occ = jnp.asarray(occupancy, bool)
    big = jnp.asarray(float(sum(s ** 2 for s in occ.shape) + 1), dtype)

    def edt_sq(mask):
        sq = jnp.where(mask, jnp.asarray(0.0, dtype), big)
        for axis in range(occ.ndim):
            sq = _minplus_1d(sq, axis)
        return sq

    dist = jnp.sqrt(edt_sq(occ))
    if signed:
        dist = dist - jnp.sqrt(edt_sq(~occ))
    dist = dist * jnp.asarray(resolution, dtype)
    return Esdf(distance=dist,
                origin=jnp.asarray(origin, dtype),
                resolution=jnp.asarray(resolution, dtype))


def distance_at(esdf: Esdf, positions: jnp.ndarray) -> jnp.ndarray:
    """Trilinear-interpolated distance at world positions (..., 3).

    Out-of-map queries clamp to the border (the reference instead
    bounds-checks and treats out-of-map as collision,
    nonlinear_impl.h:1810-1840; border clamping composes better with hard
    position bounds handled at the optimizer level)."""
    grid = (jnp.asarray(positions) - esdf.origin) / esdf.resolution
    shape = esdf.distance.shape
    grid = jnp.clip(grid, 0.0,
                    jnp.asarray([s - 1 - 1e-6 for s in shape],
                                grid.dtype))
    lo = jnp.floor(grid).astype(jnp.int32)
    frac = grid - lo

    def gather(offset):
        idx = lo + jnp.asarray(offset, jnp.int32)
        idx = jnp.minimum(idx, jnp.asarray([s - 1 for s in shape]))
        return esdf.distance[idx[..., 0], idx[..., 1], idx[..., 2]]

    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    c000 = gather((0, 0, 0)); c100 = gather((1, 0, 0))
    c010 = gather((0, 1, 0)); c110 = gather((1, 1, 0))
    c001 = gather((0, 0, 1)); c101 = gather((1, 0, 1))
    c011 = gather((0, 1, 1)); c111 = gather((1, 1, 1))
    c00 = c000 * (1 - fx) + c100 * fx
    c10 = c010 * (1 - fx) + c110 * fx
    c01 = c001 * (1 - fx) + c101 * fx
    c11 = c011 * (1 - fx) + c111 * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def collision_potential(distance: jnp.ndarray,
                        epsilon: float,
                        robot_radius: float,
                        multiplier: float = 1.0) -> jnp.ndarray:
    """Hinge/quadratic potential c(d) (getCostPotential, impl:2659-2684):

        d' = d - robot_radius
        c  = multiplier * (-d') + eps/2          if d' <= 0   (in collision)
        c  = (d' - eps)^2 / (2 eps)              if 0 < d' <= eps
        c  = 0                                   otherwise
    """
    d = distance - robot_radius
    in_collision = d <= 0.0
    near = d <= epsilon
    c_coll = multiplier * (-d) + 0.5 * epsilon
    c_near = 0.5 / epsilon * (d - epsilon) ** 2
    return jnp.where(in_collision, c_coll, jnp.where(near, c_near, 0.0))


def is_in_collision(distance: jnp.ndarray, robot_radius: float) -> jnp.ndarray:
    return distance - robot_radius <= 0.0


def make_obstacle_grid(shape, origin, resolution, boxes=(), spheres=(),
                       dtype=np.float32) -> np.ndarray:
    """Host helper: rasterize axis-aligned boxes ((min_xyz, max_xyz)) and
    spheres ((center, radius)) into an occupancy grid for tests/demos."""
    shape = tuple(shape)
    origin = np.asarray(origin, dtype=np.float64)
    idx = np.stack(np.meshgrid(*[np.arange(s) for s in shape],
                               indexing="ij"), axis=-1)
    centers = origin + idx * resolution
    occ = np.zeros(shape, dtype=bool)
    for (mn, mx) in boxes:
        mn = np.asarray(mn); mx = np.asarray(mx)
        occ |= np.all((centers >= mn) & (centers <= mx), axis=-1)
    for (c, r) in spheres:
        occ |= np.linalg.norm(centers - np.asarray(c), axis=-1) <= r
    return occ
