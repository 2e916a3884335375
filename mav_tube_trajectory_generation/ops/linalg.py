"""Batched dense linear algebra primitives for the solvers' small SPD
systems.

``spd_inverse_schur`` inverts by recursive block Schur complements over
small library-LU leaves; ``spd_inverse`` factors with Cholesky and
builds the triangular inverse out of matmuls:

    L = U D              (U unit-lower-triangular, D = diag(L))
    U = I - N            (N strictly lower triangular => nilpotent, N^s = 0)
    U^{-1} = (I + N)(I + N^2)(I + N^4) ... (I + N^(2^ceil(log2(s))-...))

-- the exact Neumann factorization of a nilpotent series, computed with
ceil(log2(n)) squarings + products.  Then A^{-1} = L^{-T} L^{-1} for
A = L L^T.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp


def _tri_lower_inverse_squaring(chol_lower: jnp.ndarray) -> jnp.ndarray:
    """Nilpotent-squaring triangular inverse: ~2 log2(n) full matmuls.

    L = U D with U = I - N (N strictly lower => nilpotent), and
    U^{-1} = (I + N)(I + N^2)(I + N^4)...  Used as the recursion base case.
    """
    n = chol_lower.shape[-1]
    dtype = chol_lower.dtype
    d = jnp.diagonal(chol_lower, axis1=-2, axis2=-1)
    unit = chol_lower / d[..., None, :]            # L = U D -> U = L D^{-1}
    eye = jnp.eye(n, dtype=dtype)
    nmat = eye - unit                              # strictly lower, nilpotent
    inv = eye + nmat
    power = nmat
    for _ in range(max(math.ceil(math.log2(n)) - 1, 0)):
        power = power @ power                      # N^(2^k)
        inv = inv + inv @ power
    return inv / d[..., :, None]                   # U^{-1} D^{-1}


def tri_lower_inverse(chol_lower: jnp.ndarray,
                      base_size: int = 32) -> jnp.ndarray:
    """Inverse of a (batched) lower-triangular matrix, matmul-only.

    Recursive 2x2 blocking: [[A, 0], [B, C]]^{-1} =
    [[A^{-1}, 0], [-C^{-1} B A^{-1}, C^{-1}]] -- O(n^3)-with-small-constant
    in pure matmuls (vs the ~2 n^3 log n of plain nilpotent squaring).
    Small diagonal blocks fall back to the squaring form.
    """
    n = chol_lower.shape[-1]
    if n <= base_size:
        return _tri_lower_inverse_squaring(chol_lower)
    h = n // 2
    a = chol_lower[..., :h, :h]
    b = chol_lower[..., h:, :h]
    c = chol_lower[..., h:, h:]
    ai = tri_lower_inverse(a, base_size)
    ci = tri_lower_inverse(c, base_size)
    lower_left = -(ci @ (b @ ai))
    top = jnp.concatenate(
        [ai, jnp.zeros(ai.shape[:-2] + (h, n - h), ai.dtype)], axis=-1)
    bottom = jnp.concatenate([lower_left, ci], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


#: Largest block the Schur recursion hands to the library LU inverse.
_LEAF = 16


def _spd_inverse_leaf(a: jnp.ndarray) -> jnp.ndarray:
    """Batched inverse of a small SPD block by LU with partial pivoting:
    a few library calls whatever the block size -- an element-by-element
    unrolled elimination instead grows the program by O(n^3) scalar ops per
    leaf, which dominated compile time on the GPU.  Pivoting keeps blocks
    that f32 rounding leaves slightly indefinite (the feasibility snap's
    stiff Hessians) finite, where a Cholesky factor returns NaN: measured
    58 vs 168 tier-0 escalations of 512 bench rows (CPU, f32)."""
    return jnp.linalg.inv(a)


def spd_inverse_schur(a: jnp.ndarray, newton_steps: int = 0,
                      symmetrize: bool = True) -> jnp.ndarray:
    """Batched SPD inverse: recursive 2x2 block Schur complement down to
    blocks of at most ``_LEAF`` rows, each inverted by ``_spd_inverse_leaf``.

        [[A, B^T], [B, C]]^-1 = [[Ai + W^T Si W, -W^T Si],
                                 [-Si W,          Si     ]],
        W = B Ai,  S = C - W B^T,  Si = S^-1 (recurse; SPD since S is the
        Schur complement of an SPD matrix).

    Numerically it is unpivoted block elimination -- exact for SPD inputs,
    with error growing with cond(a); the solvers equilibrate to unit
    diagonal first.  Newton-Schulz polish (W <- W(2I - A W)) is available
    but measured to *hurt* once the residual is already at the cond*eps
    floor (its own matmul rounding dominates), hence default 0.
    symmetrize=False skips the per-level 0.5 (S + S^T) and the final
    0.5 (W + W^T).  WARNING: the per-level symmetrization is LOAD-BEARING
    at f32 for n ~ 100+: on the QCQP's real stage KKT (n=135, cond ~1.1e3)
    the unsymmetrized recursion's residual explodes to ~4e7 (vs 3.8e-4
    symmetrized) -- asymmetry drift amplifies multiplicatively through the
    Schur levels.
    """
    n = a.shape[-1]
    hi = jax.lax.Precision.HIGHEST
    mm = lambda x, y: jnp.matmul(x, y, precision=hi)

    def sym(m):
        return 0.5 * (m + jnp.swapaxes(m, -1, -2)) if symmetrize else m

    def rec(m):
        k = m.shape[-1]
        if k <= _LEAF:
            return _spd_inverse_leaf(m)
        h = (k + 1) // 2
        top_left = m[..., :h, :h]
        bot_left = m[..., h:, :h]
        bot_right = m[..., h:, h:]
        ai = rec(top_left)
        w = mm(bot_left, ai)                                # (k-h, h)
        s = sym(bot_right - mm(w, jnp.swapaxes(bot_left, -1, -2)))
        si = rec(s)
        siw = mm(si, w)                                     # (k-h, h)
        ul = ai + mm(jnp.swapaxes(w, -1, -2), siw)
        ur = -jnp.swapaxes(siw, -1, -2)
        top = jnp.concatenate([ul, ur], axis=-1)
        bottom = jnp.concatenate([-siw, si], axis=-1)
        return jnp.concatenate([top, bottom], axis=-2)

    w = sym(rec(a))
    eye2 = 2.0 * jnp.eye(n, dtype=a.dtype)
    for _ in range(newton_steps):
        w = mm(w, eye2 - mm(a, w))
        w = 0.5 * (w + jnp.swapaxes(w, -1, -2))
    return w


def gram_band(a, g, blk: int):
    """Block-tridiagonal band of a @ g^T for (S, nfd, m_p) operands, in
    ``blk``-row vertex blocks: gd (S, m, blk, blk) diagonal blocks and
    gu (S, m-1, blk, blk) super-diagonal blocks, each block its own
    lane contraction (no full (nfd, nfd) product)."""
    lead = a.shape[:-2]
    m_blk = a.shape[-2] // blk
    a4 = a.reshape(lead + (m_blk, blk, a.shape[-1]))
    g4 = g.reshape(lead + (m_blk, blk, g.shape[-1]))
    gd = jnp.einsum('...ipm,...iqm->...ipq', a4, g4, precision=jax.lax.Precision.HIGHEST)
    gu = jnp.einsum('...ipm,...iqm->...ipq', a4[..., :-1, :, :],
                    g4[..., 1:, :, :], precision=jax.lax.Precision.HIGHEST)
    return gd, gu


def spd_inverse(a: jnp.ndarray, newton_steps: int = 1) -> jnp.ndarray:
    """Inverse of a (batched) SPD matrix: Cholesky + matmul-only triangular
    inverse (+ optional Newton-Schulz polish W <- W(2I - A W)).
    """
    chol = jnp.linalg.cholesky(a)
    linv = tri_lower_inverse(chol)
    w = jnp.einsum('...ji,...jk->...ik', linv, linv)
    eye2 = 2.0 * jnp.eye(a.shape[-1], dtype=a.dtype)
    for _ in range(newton_steps):
        w = w @ (eye2 - a @ w)
    return w


def spd_solve(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve SPD a @ x = b via the explicit inverse.

    Accuracy is that of an explicit-inverse multiply; for the equilibrated,
    well-conditioned systems of the solvers here that is well within
    float32 tolerance (property-tested against cho_solve).
    """
    inv = spd_inverse(a)
    return jnp.einsum('...ij,...j->...i', inv, b) if b.ndim == a.ndim - 1 \
        else inv @ b
