"""Static problem structure: the batched replacement for the sparse
constraint-reordering matrix M.

The reference builds, per problem, a sparse 0/1 matrix ``constraint_reordering_``
that duplicates interior-vertex endpoint derivatives (continuity) and splits
them into fixed (d_f) and free (d_p) groups
(setupConstraintReorderingMatrix, linear_impl.h:171-252).

Here the same information is a **static integer gather map** computed once on
host: for segment k, row r (r < N/2: derivative r at the segment start =
vertex k; r >= N/2: derivative r - N/2 at the end = vertex k + 1),
``gather_idx[k, r]`` is the column of that endpoint derivative in the compact
vector ``[d_f; d_p]``.  Applying M is a gather; applying M^T .. M (the R
assembly) is a one-hot einsum; M^+ (the reference's row-normalized
pseudo-inverse, linear_impl.h:547-555) is a segment-mean scatter.  All shapes
are static per (N, K, fixed-mask) family, which is what lets the whole solve
jit once and vmap over scenarios.

Ordering parity with the reference: fixed columns are the constrained
(vertex, derivative) pairs sorted lexicographically, free columns likewise --
exactly the iteration order of the reference's ``std::set<Constraint>``
(Constraint::operator<, polynomial_optimization_linear.h:288-305).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ProblemStructure:
    """Static (compile-time) description of one problem family.

    Attributes:
      n_coefficients: N, number of polynomial coefficients per segment.
      dimension: D, spatial dimension.
      n_segments: K.
      derivative_to_optimize: d in the cost integral (default snap).
      fixed_mask: (V, N/2) bool; fixed_mask[v, j] == True iff derivative j of
        vertex v is a fixed constraint.
      gather_idx: (K, N) int32 gather map into [d_f; d_p] (see module doc).
      fixed_cols: (n_fixed, 2) int (vertex, derivative) per fixed column.
      free_cols: (n_free, 2) int (vertex, derivative) per free column.
    """

    n_coefficients: int
    dimension: int
    n_segments: int
    derivative_to_optimize: int
    fixed_mask: np.ndarray
    gather_idx: np.ndarray
    fixed_cols: np.ndarray
    free_cols: np.ndarray

    @property
    def n_vertices(self) -> int:
        return self.n_segments + 1

    @property
    def half_n(self) -> int:
        return self.n_coefficients // 2

    @property
    def n_fixed(self) -> int:
        return len(self.fixed_cols)

    @property
    def n_free(self) -> int:
        return len(self.free_cols)

    @property
    def n_total(self) -> int:
        return self.n_fixed + self.n_free

    @property
    def n_all_constraints(self) -> int:
        return self.n_segments * self.n_coefficients

    def one_hot_m(self) -> np.ndarray:
        """Dense one-hot M per segment: (K, N, n_total) float64.

        ``M[k] @ [d_f; d_p] = d_seg_k``; the reference's sparse
        constraint_reordering_ reshaped block-per-segment.
        """
        k, n = self.gather_idx.shape
        m = np.zeros((k, n, self.n_total), dtype=np.float64)
        rows = np.arange(n)
        for i in range(k):
            m[i, rows, self.gather_idx[i]] = 1.0
        m.setflags(write=False)
        return m

    def fixed_value_gather(self) -> np.ndarray:
        """Flat indices into values.reshape(V * N/2, D) for d_f extraction."""
        h = self.half_n
        return (self.fixed_cols[:, 0] * h + self.fixed_cols[:, 1]).astype(np.int32)

    def free_value_gather(self) -> np.ndarray:
        h = self.half_n
        return (self.free_cols[:, 0] * h + self.free_cols[:, 1]).astype(np.int32)

    def __hash__(self):
        return hash((self.n_coefficients, self.dimension, self.n_segments,
                     self.derivative_to_optimize,
                     self.fixed_mask.tobytes()))

    def __eq__(self, other):
        return (isinstance(other, ProblemStructure)
                and self.n_coefficients == other.n_coefficients
                and self.dimension == other.dimension
                and self.n_segments == other.n_segments
                and self.derivative_to_optimize == other.derivative_to_optimize
                and np.array_equal(self.fixed_mask, other.fixed_mask))


def make_structure(fixed_mask: np.ndarray,
                   dimension: int,
                   n_coefficients: int = 10,
                   derivative_to_optimize: Optional[int] = None) -> ProblemStructure:
    """Build a ProblemStructure from a (V, N/2) fixed-constraint mask."""
    n = int(n_coefficients)
    if n % 2 != 0:
        raise ValueError("The number of coefficients has to be even.")
    h = n // 2
    if derivative_to_optimize is None:
        derivative_to_optimize = h - 1
    if not (0 <= derivative_to_optimize <= h - 1):
        # Same contract as setupFromVertices (linear_impl.h:50-55).
        raise ValueError(
            f"Cannot optimize derivative {derivative_to_optimize} of position "
            f"on an order-{n} polynomial; max is {h - 1}.")
    fixed_mask = np.asarray(fixed_mask, dtype=bool)
    if fixed_mask.ndim != 2 or fixed_mask.shape[1] != h:
        raise ValueError(f"fixed_mask must be (n_vertices, {h}).")
    v = fixed_mask.shape[0]
    if v < 2:
        raise ValueError("Need at least two vertices.")
    k = v - 1

    fixed_cols = [(vi, j) for vi in range(v) for j in range(h) if fixed_mask[vi, j]]
    free_cols = [(vi, j) for vi in range(v) for j in range(h) if not fixed_mask[vi, j]]
    col = {vc: i for i, vc in enumerate(fixed_cols)}
    col.update({vc: len(fixed_cols) + i for i, vc in enumerate(free_cols)})

    gather = np.zeros((k, n), dtype=np.int32)
    for seg in range(k):
        for j in range(h):
            gather[seg, j] = col[(seg, j)]
            gather[seg, h + j] = col[(seg + 1, j)]
    gather.setflags(write=False)

    fixed_cols = np.asarray(fixed_cols, dtype=np.int64).reshape(-1, 2)
    free_cols = np.asarray(free_cols, dtype=np.int64).reshape(-1, 2)
    fixed_cols.setflags(write=False)
    free_cols.setflags(write=False)
    fm = fixed_mask.copy()
    fm.setflags(write=False)
    return ProblemStructure(
        n_coefficients=n,
        dimension=int(dimension),
        n_segments=k,
        derivative_to_optimize=int(derivative_to_optimize),
        fixed_mask=fm,
        gather_idx=gather,
        fixed_cols=fixed_cols,
        free_cols=free_cols,
    )


def standard_mask(n_vertices: int, n_coefficients: int = 10,
                  interior_fixed_derivatives: int = 1) -> np.ndarray:
    """The common pattern: endpoints fully fixed, interior vertices fix only
    derivatives 0..interior_fixed_derivatives-1 (default: position only)."""
    h = n_coefficients // 2
    mask = np.zeros((n_vertices, h), dtype=bool)
    mask[0] = True
    mask[-1] = True
    mask[1:-1, :interior_fixed_derivatives] = True
    return mask


def free_interior_mask(n_vertices: int, n_coefficients: int = 10) -> np.ndarray:
    """The constrained/QCQP pattern: endpoints fully fixed, interior vertices
    entirely free (position confined by sphere/tube constraints instead).
    Reference: setupConstraintReorderingMatrixkDim (qcqp_impl.h:19-118)."""
    return standard_mask(n_vertices, n_coefficients, interior_fixed_derivatives=0)
