"""Giant-K fast path: block-tridiagonal assembly + batched cyclic reduction.

The chain structure of a K-segment trajectory makes R block-tridiagonal in
vertex space: segment k's Hessian quadrants couple only vertices k and k+1
(the reason the reference uses sparse assembly, constructR,
linear_impl.h:306-335).  The generic solver densifies R (one-hot einsum +
dense Cholesky), which is fine to K ~ 25 but O(K^2..3) beyond.  This module
is the batched "scale the long axis" answer (SURVEY.md section 5.7):

  * R is assembled directly in block-banded storage -- each H_k's four
    N/2 x N/2 quadrants add into the (k, k), (k, k+1), (k+1, k+1) vertex
    blocks.  O(K N^2), no scatter, no dense intermediate.
  * The free-free system is solved by **block cyclic reduction**: odd-vertex
    unknowns are eliminated level by level (ceil(log2 K) levels, each a
    batch of tiny-matrix matmuls/inverses over the remaining blocks), then
    back-substituted.  Depth log K instead of a length-K recurrence, and
    every level is a batched dense op -- the banded analogue of a parallel
    scan, mapped to batched dense ops.

Applies when endpoints are fully fixed and all interior vertices share one
free-derivative pattern (the standard and free-interior families); the
generic solver covers everything else.
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import linalg, qmatrix
from .linear import (LinearSolution, cost_from_derivatives,
                     full_matmul_precision,
                     segment_derivatives)
from .structure import ProblemStructure


def uniform_interior_pattern(structure: ProblemStructure
                             ) -> Optional[np.ndarray]:
    """The shared free-derivative index set of interior vertices, or None if
    the banded fast path does not apply."""
    mask = structure.fixed_mask
    if not mask[0].all() or not mask[-1].all():
        return None
    if structure.n_vertices < 3:
        return None
    interior = mask[1:-1]
    if not (interior == interior[0]).all():
        return None
    free_idx = np.flatnonzero(~interior[0])
    if free_idx.size == 0:
        return None
    return free_idx


def block_tridiag_solve(d_blocks: jnp.ndarray,
                        u_blocks: jnp.ndarray,
                        rhs: jnp.ndarray) -> jnp.ndarray:
    """Solve an SPD block-tridiagonal system by cyclic reduction.

    Args:
      d_blocks: (m, b, b) diagonal blocks.
      u_blocks: (m-1, b, b) super-diagonal blocks (block i couples unknowns
        i and i+1; sub-diagonal = transpose).
      rhs: (m, b, R) right-hand sides.

    Returns:
      (m, b, R) solution.

    ceil(log2(m+1)) static levels; every level is a batch of b x b matmuls
    and inverses over the surviving blocks (the banded analogue of a
    parallel scan).
    """
    m, b, _ = d_blocks.shape
    nrhs = rhs.shape[-1]
    dtype = d_blocks.dtype

    # Pad to m' = 2^L - 1 with decoupled identity blocks (their x stays 0).
    levels = max(math.ceil(math.log2(m + 1)), 1)
    m_pad = 2 ** levels - 1
    eye = jnp.eye(b, dtype=dtype)
    d = jnp.concatenate(
        [d_blocks, jnp.tile(eye[None], (m_pad - m, 1, 1))], axis=0)
    # u padded to length m_pad (u[m_pad - 1] unused and zero).
    u = jnp.concatenate(
        [u_blocks, jnp.zeros((m_pad - (m - 1), b, b), dtype)], axis=0)
    f = jnp.concatenate([rhs, jnp.zeros((m_pad - m, b, nrhs), dtype)], axis=0)

    # Forward: eliminate even-indexed blocks each level, keep odd-indexed.
    stack = []
    while d.shape[0] > 1:
        d_e, d_k = d[0::2], d[1::2]           # eliminated / kept
        f_e, f_k = f[0::2], f[1::2]
        u_even = u[0::2]                      # U_{2j}:   even j  -> kept j
        u_odd = u[1::2]                       # U_{2j+1}: kept j -> even j+1
        n_k = d_k.shape[0]

        d_e_inv = linalg.spd_inverse_schur(d_e)
        a = jnp.swapaxes(u_even[:n_k], -1, -2) @ d_e_inv[:n_k]
        bq = u_odd[:n_k] @ d_e_inv[1:n_k + 1]
        d_new = (d_k - a @ u_even[:n_k]
                 - bq @ jnp.swapaxes(u_odd[:n_k], -1, -2))
        f_new = f_k - a @ f_e[:n_k] - bq @ f_e[1:n_k + 1]
        u_new = -(bq[:n_k - 1] @ u_even[1:n_k]) if n_k > 1 else \
            jnp.zeros((0, b, b), dtype)
        u_new = jnp.concatenate([u_new, jnp.zeros((1, b, b), dtype)], axis=0)

        stack.append((d_e_inv, u_even, u_odd, f_e))
        d, u, f = d_new, u_new, f_new

    x = (linalg.spd_inverse_schur(d[0]) @ f[0])[None]    # (1, b, R)

    # Back substitution: recover the eliminated (even) blocks.
    for d_e_inv, u_even, u_odd, f_e in reversed(stack):
        n_e = d_e_inv.shape[0]
        zeros = jnp.zeros((1, b, nrhs), dtype)
        # x_e[j] = Dinv_j (f_e[j] - U_{2j-1}^T x_k[j-1] - U_{2j} x_k[j]).
        u_odd_shift = jnp.concatenate(
            [jnp.zeros((1, b, b), dtype), u_odd], axis=0)[:n_e]
        xk_left = jnp.concatenate([zeros, x], axis=0)[:n_e]
        xk_right = jnp.concatenate([x, zeros], axis=0)[:n_e]
        x_e = d_e_inv @ (f_e
                         - jnp.swapaxes(u_odd_shift, -1, -2) @ xk_left
                         - u_even[:n_e] @ xk_right)
        total = n_e + x.shape[0]
        out = jnp.zeros((total, b, nrhs), dtype)
        out = out.at[0::2].set(x_e)
        out = out.at[1::2].set(x)
        x = out

    return x[:m]


def kkt_tridiag_block(structure: ProblemStructure):
    """Block size of the tube-QCQP KKT/Hessian's block-tridiagonal structure
    (in vertex-major free-column order), or None if it does not apply.

    kron(R_pp, I_D) + (constraint Gram) is EXACTLY block-tridiagonal:
    min-snap R_pp couples only vertices sharing a segment, and every
    tube/sphere/end-cap constraint row's support is one segment's two
    endpoint vertices (pinned by tests/test_banded.py).  Requires interior
    vertices sharing one free-derivative pattern and vertex-major columns.
    """
    fi = uniform_interior_pattern(structure)
    if fi is None or structure.n_vertices < 4:
        return None
    expect = [(v, int(d)) for v in range(1, structure.n_vertices - 1)
              for d in fi]
    if [tuple(map(int, c)) for c in structure.free_cols] != expect:
        return None
    return len(fi) * structure.dimension


def spd_block_tridiag_inverse(a: jnp.ndarray, block_size: int) -> jnp.ndarray:
    """Dense inverse of a batched SPD BLOCK-TRIDIAGONAL matrix via a
    sequential block-Thomas (LDL^T) sweep with an identity right-hand side.

    Built for the QCQP's stage KKT (P + rho G^T G + sigma I): min-snap R_pp
    and the tube/sphere/cap Gram both couple only ADJACENT interior
    vertices, so the 135x135 flagship KKT is exactly block-tridiagonal with
    (half_n * dim)=15-sized vertex blocks (verified off-band max 0.0).  The
    dense recursive-Schur inverse is a deep tree of small dispatches; this
    sweep is ~80 contiguous batched ops.

    (Rejected alternative on the first accelerator this ran on, worth
    re-measuring: routing this through ``block_tridiag_solve`` -- cyclic
    reduction with the identity RHS -- benched ~1.4x slower than the dense
    tree: the even/odd strided slices and back-substitution scatters
    relayout the (b, n) RHS panels every level.
    Thomas is sequential over m blocks but every op is contiguous, and at
    batch 6144 the 9-step chain is fully amortized.)

    Measured f32 residual on the real KKT (cond ~1.1e3): 4.7e-4, same order
    as the dense Schur tree's 3.8e-4 (per-step Schur complements are
    symmetrized -- the same load-bearing trick, see spd_inverse_schur).

    Args:
      a: (..., n, n) SPD, exactly block-tridiagonal with ``block_size``
        blocks (off-band entries are IGNORED -- caller guarantees zero).
    """
    n = a.shape[-1]
    bsz = block_size
    m = n // bsz
    if m * bsz != n:
        raise ValueError(f"n={n} not a multiple of block_size={bsz}")
    dblk = [a[..., i * bsz:(i + 1) * bsz, i * bsz:(i + 1) * bsz]
            for i in range(m)]
    ublk = [a[..., i * bsz:(i + 1) * bsz, (i + 1) * bsz:(i + 2) * bsz]
            for i in range(m - 1)]
    return spd_block_tridiag_inverse_blocks(dblk, ublk)


def spd_block_tridiag_factor(dblk, ublk):
    """Block LDL^T factorization A = (I+L) S (I+L)^T of an SPD
    block-tridiagonal matrix: returns (s_inv, t) with S_i^{-1} and the
    subdiagonal factors T_i = U_{i-1}^T S_{i-1}^{-1} (t[0] is None).

    Use with ``spd_block_tridiag_solve_factored`` when only a few solves
    against the factorization are needed (e.g. the IPM Newton direction,
    rhs is a single column): the full-inverse path assembles (b, n) identity
    panels that cost ~3x the factorization itself.
    """
    if not isinstance(dblk, (list, tuple)):
        dblk = [dblk[..., i, :, :] for i in range(dblk.shape[-3])]
    if not isinstance(ublk, (list, tuple)):
        ublk = [ublk[..., i, :, :] for i in range(ublk.shape[-3])]
    m = len(dblk)
    s_inv = [linalg.spd_inverse_schur(dblk[0])]
    t = [None]
    for i in range(1, m):
        ti = jnp.swapaxes(ublk[i - 1], -1, -2) @ s_inv[i - 1]
        s = dblk[i] - ti @ ublk[i - 1]
        s = 0.5 * (s + jnp.swapaxes(s, -1, -2))
        t.append(ti)
        s_inv.append(linalg.spd_inverse_schur(s))
    return s_inv, t


def spd_block_tridiag_solve_factored(s_inv, t, rhs) -> jnp.ndarray:
    """Solve A x = rhs from ``spd_block_tridiag_factor``'s (s_inv, t).

    rhs: (..., n, R) with n = m * b.  Forward (I+L) y = rhs, diagonal
    z = S^{-1} y, backward (I+L)^T x = z; every step is one contiguous
    batched (b, b) @ (b, R) matmul.
    """
    m = len(s_inv)
    bsz = s_inv[0].shape[-1]
    r = [rhs[..., i * bsz:(i + 1) * bsz, :] for i in range(m)]
    y = [r[0]]
    for i in range(1, m):
        y.append(r[i] - t[i] @ y[i - 1])
    z = [s_inv[i] @ y[i] for i in range(m)]
    x = [None] * m
    x[m - 1] = z[m - 1]
    for i in range(m - 2, -1, -1):
        x[i] = z[i] - jnp.swapaxes(t[i + 1], -1, -2) @ x[i + 1]
    return jnp.concatenate(x, axis=-2)


def spd_block_tridiag_inverse_blocks(dblk, ublk) -> jnp.ndarray:
    """Block-form entry point of ``spd_block_tridiag_inverse``: dense inverse
    from the m diagonal blocks ``dblk`` and m-1 super-diagonal blocks
    ``ublk`` (lists of (..., b, b), or stacked (..., m, b, b) arrays) --
    for callers that assemble the band directly and never materialize the
    dense matrix (the QCQP stage KKT)."""
    if not isinstance(dblk, (list, tuple)):
        dblk = [dblk[..., i, :, :] for i in range(dblk.shape[-3])]
    if not isinstance(ublk, (list, tuple)):
        ublk = [ublk[..., i, :, :] for i in range(ublk.shape[-3])]
    m = len(dblk)
    bsz = dblk[0].shape[-1]
    n = m * bsz
    a = dblk[0]
    # Factor: A = (I+L) S (I+L)^T, L block-bidiagonal with T_i at (i, i-1).
    s_inv = [linalg.spd_inverse_schur(dblk[0])]
    t = [None]
    for i in range(1, m):
        ti = jnp.swapaxes(ublk[i - 1], -1, -2) @ s_inv[i - 1]
        s = dblk[i] - ti @ ublk[i - 1]
        s = 0.5 * (s + jnp.swapaxes(s, -1, -2))
        t.append(ti)
        s_inv.append(linalg.spd_inverse_schur(s))
    # Apply to I: forward (I+L) Y = I, diagonal Z = S^-1 Y, backward
    # (I+L)^T X = Z.  Block rows of the identity are static constants.
    eye = jnp.eye(n, dtype=a.dtype)
    shape = a.shape[:-2]
    y = [jnp.broadcast_to(eye[0:bsz], shape + (bsz, n))]
    for i in range(1, m):
        bi = jnp.broadcast_to(eye[i * bsz:(i + 1) * bsz], shape + (bsz, n))
        y.append(bi - t[i] @ y[i - 1])
    z = [s_inv[i] @ y[i] for i in range(m)]
    x = [None] * m
    x[m - 1] = z[m - 1]
    for i in range(m - 2, -1, -1):
        x[i] = z[i] - jnp.swapaxes(t[i + 1], -1, -2) @ x[i + 1]
    return jnp.concatenate(x, axis=-2)


@full_matmul_precision
def solve_linear_banded(structure: ProblemStructure,
                        d_fixed: jnp.ndarray,
                        times: jnp.ndarray) -> LinearSolution:
    """O(K log K) linear solve for uniform-interior problem families.

    Same inputs/outputs as solver.linear.solve_linear; raises if the banded
    fast path does not apply (use ``uniform_interior_pattern`` to check).
    """
    free_idx = uniform_interior_pattern(structure)
    if free_idx is None:
        raise ValueError("Banded fast path requires fully fixed endpoints "
                         "and a uniform interior free pattern.")
    n = structure.n_coefficients
    h = structure.half_n
    k = structure.n_segments
    dim = structure.dimension
    dtype = jnp.result_type(d_fixed, times)
    d_fixed = jnp.asarray(d_fixed, dtype)
    times = jnp.asarray(times, dtype)

    hks = qmatrix.hessian_blocks(times, n, structure.derivative_to_optimize)
    h00 = hks[..., :h, :h]
    h01 = hks[..., :h, h:]
    h11 = hks[..., h:, h:]

    # Vertex-space banded R: D_v (V, h, h), U_v couples v to v+1 (K, h, h).
    zeros_h = jnp.zeros_like(h00[..., :1, :, :])
    d_vtx = (jnp.concatenate([h00, zeros_h], axis=-3)
             + jnp.concatenate([zeros_h, h11], axis=-3))     # (V, h, h)
    u_vtx = h01                                              # (K, h, h)

    # Dense vertex-space d_f embedding (free entries zero).
    v = structure.n_vertices
    flat_fix = structure.fixed_value_gather()
    d_embed = jnp.zeros((v * h, dim), dtype).at[jnp.asarray(flat_fix)].set(
        d_fixed).reshape(v, h, dim)

    # rhs_free = -(R @ d_embed) restricted to interior free rows.
    rd = (d_vtx @ d_embed
          + jnp.concatenate([u_vtx @ d_embed[1:], zeros_h[..., :dim]],
                            axis=-3)
          + jnp.concatenate([zeros_h[..., :dim],
                             jnp.swapaxes(u_vtx, -1, -2) @ d_embed[:-1]],
                            axis=-3))                        # (V, h, dim)
    fi = jnp.asarray(free_idx)
    rhs = -rd[1:-1][:, fi, :]                                # (V-2, f, dim)

    d_blocks = d_vtx[1:-1][:, fi][:, :, fi]                  # (V-2, f, f)
    # u_vtx[i] couples vertex i to i+1; interior-to-interior couplings are
    # i = 1 .. V-3.
    u_blocks = (u_vtx[1:v - 2][:, fi][:, :, fi] if v > 3 else
                jnp.zeros((0, fi.size, fi.size), dtype))

    # Jacobi equilibration (same float32 conditioning story as the dense
    # solver): unknowns scale as T^derivative-order powers.
    scale = jax.lax.rsqrt(jnp.diagonal(d_blocks, axis1=-2, axis2=-1))
    d_blocks = d_blocks * scale[:, :, None] * scale[:, None, :]
    u_blocks = u_blocks * scale[:-1][:, :, None] * scale[1:][:, None, :]
    rhs = rhs * scale[:, :, None]

    d_free_blocks = block_tridiag_solve(d_blocks, u_blocks, rhs)
    d_free_blocks = d_free_blocks * scale[:, :, None]
    d_free = d_free_blocks.reshape((v - 2) * fi.size, dim)

    d_seg = segment_derivatives(structure, d_fixed, d_free)
    coeffs = qmatrix.coefficients_from_endpoint_derivatives(d_seg, times)
    cost = cost_from_derivatives(structure, d_seg, times)
    return LinearSolution(coefficients=coeffs, times=times, d_fixed=d_fixed,
                          d_free=d_free, cost=cost)
