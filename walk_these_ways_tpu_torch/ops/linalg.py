"""Closed-form batched small-matrix inverses for the dynamics path.

Branch-free closed forms over the env batch, same formulas as the JAX
package's ops/linalg.py:

- `inv3`: 3x3 inverse by adjugate (9 cofactors + one reciprocal).
- `inv_spd6`: SPD 6x6 inverse via one level of 3x3 Schur complements.
- `mass_matrix_inverse`: SPD (6 + 3*L)x(6 + 3*L) inverse specialized to the
  "star of 3-dof chains" topology of a quadruped (4 legs x {hip, thigh,
  calf}): the joint-joint block D is block-diagonal per leg (legs couple
  only through the floating base), so

      M = [[A, B], [B^T, D]],   D = blockdiag(D_1..D_4)  (3x3 each)
      M^-1 via D^-1 (4 closed-form 3x3 inverses) + a 6x6 Schur complement.
"""
from __future__ import annotations

import torch


def inv3(m: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Batched 3x3 inverse by adjugate. m: (..., 3, 3)."""
    if eps:
        m = m + eps * torch.eye(3, dtype=m.dtype, device=m.device)
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    D = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    G = b * f - c * e
    H = -(a * f - c * d)
    I = a * e - b * d
    det = a * A + b * B + c * C
    inv_det = 1.0 / det
    adj = torch.stack([
        torch.stack([A, D, G], dim=-1),
        torch.stack([B, E, H], dim=-1),
        torch.stack([C, F, I], dim=-1),
    ], dim=-2)
    return adj * inv_det[..., None, None]


def inv_spd6(m: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Batched SPD 6x6 inverse via 3x3 block Schur. m: (..., 6, 6)."""
    P = m[..., :3, :3]
    Q = m[..., :3, 3:]
    R = m[..., 3:, 3:]
    Pinv = inv3(P, eps)
    # Schur complement of P
    S = R - torch.einsum("...ji,...jk,...kl->...il", Q, Pinv, Q)
    Sinv = inv3(S, eps)
    PiQ = torch.matmul(Pinv, Q)                             # (..., 3, 3)
    TL = Pinv + torch.einsum("...ij,...jk,...lk->...il", PiQ, Sinv, PiQ)
    TR = -torch.matmul(PiQ, Sinv)
    BL = TR.transpose(-1, -2)
    top = torch.cat([TL, TR], dim=-1)
    bot = torch.cat([BL, Sinv], dim=-1)
    return torch.cat([top, bot], dim=-2)


def mass_matrix_inverse(M: torch.Tensor, num_chains: int = 4,
                        chain_len: int = 3, eps: float = 1e-8) -> torch.Tensor:
    """Explicit inverse of the floating-base mass matrix.

    M: (N, 6 + num_chains*chain_len, 6 + num_chains*chain_len), SPD, with
    the joint-joint block D block-diagonal in chain_len-sized blocks.
    Returns (N, nv, nv).
    """
    C, L = num_chains, chain_len
    nj = C * L
    N = M.shape[0]
    A = M[..., :6, :6]
    B = M[..., :6, 6:]                              # (N, 6, nj)
    Dview = M[..., 6:, 6:].reshape(N, C, L, C, L)
    idx = torch.arange(C, device=M.device)
    Dblocks = Dview[:, idx, :, idx, :].permute(1, 0, 2, 3)   # (N, C, L, L)
    if L == 3:
        Dblocks_inv = inv3(Dblocks, eps)
    else:
        Dblocks_inv = torch.linalg.inv(
            Dblocks + eps * torch.eye(L, dtype=M.dtype, device=M.device))
    Dinv = torch.zeros(N, C, L, C, L, dtype=M.dtype, device=M.device)
    Dinv[:, idx, :, idx, :] = Dblocks_inv.permute(1, 0, 2, 3)
    Dinv = Dinv.reshape(N, nj, nj)

    BDinv = torch.matmul(B, Dinv)                           # (N, 6, nj)
    S = A - torch.einsum("nij,nkj->nik", BDinv, B)          # (N, 6, 6)
    Sinv = inv_spd6(S, eps)
    TR = -torch.matmul(Sinv, BDinv)                         # (N, 6, nj)
    BL = TR.transpose(-1, -2)
    BR = Dinv + torch.einsum("nji,njk,nkl->nil", BDinv, Sinv, BDinv)
    top = torch.cat([Sinv, TR], dim=-1)
    bot = torch.cat([BL, BR], dim=-1)
    return torch.cat([top, bot], dim=-2)
