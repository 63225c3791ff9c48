"""SO(3) machinery for equivariant GNNs (EquiformerV2 / eSCN)
(``repro/models/gnn/so3.py``).

* ``real_sph_harm`` — real spherical harmonics up to l_max (recurrences,
  orthonormal convention, m ordered -l..l, no Condon-Shortley phase).
* ``wigner_d_from_r`` — rotation matrices of the real SH basis computed
  from the 3x3 Cartesian rotation by the Ivanic & Ruedenberg (1996, + 1998
  erratum) recursion. All recursion indices/coefficients are static
  (numpy, built once per l), turned into tensors once per (l, device,
  dtype), so the per-edge computation is batched gathers and multiplies.
* ``rotation_to_z`` — the eSCN edge alignment: R with R @ u = e_z.

The properties (orthogonality, the homomorphism D(R1 R2) = D(R1) D(R2),
and Y(R r) = D(R) Y(r) for all l <= l_max) are held in the tests.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# real spherical harmonics
# ---------------------------------------------------------------------------

def real_sph_harm(vecs: torch.Tensor, l_max: int) -> torch.Tensor:
    """vecs (..., 3) unit vectors -> (..., (l_max+1)^2), m ordered -l..l."""
    x, y, z = vecs[..., 0], vecs[..., 1], vecs[..., 2]
    rxy2 = x * x + y * y
    rxy = torch.sqrt(rxy2 + 1e-30)
    ct = z                                 # cos(theta)
    st = rxy                               # sin(theta)
    cphi = torch.where(rxy > 1e-15, x / rxy, 1.0)
    sphi = torch.where(rxy > 1e-15, y / rxy, 0.0)

    # cos(m phi), sin(m phi) by recurrence
    cos_m = [torch.ones_like(cphi), cphi]
    sin_m = [torch.zeros_like(sphi), sphi]
    for m in range(2, l_max + 1):
        cos_m.append(2 * cphi * cos_m[-1] - cos_m[-2])
        sin_m.append(2 * cphi * sin_m[-1] - sin_m[-2])

    # associated Legendre P_l^m(ct) * st^m  (no Condon-Shortley), recurrences
    p = {}
    p[(0, 0)] = torch.ones_like(ct)
    for m in range(1, l_max + 1):
        p[(m, m)] = (2 * m - 1) * p[(m - 1, m - 1)] * st
    for m in range(0, l_max):
        p[(m + 1, m)] = (2 * m + 1) * ct * p[(m, m)]
    for m in range(0, l_max + 1):
        for l in range(m + 2, l_max + 1):
            p[(l, m)] = ((2 * l - 1) * ct * p[(l - 1, m)]
                         - (l + m - 1) * p[(l - 2, m)]) / (l - m)

    out = []
    for l in range(l_max + 1):
        for m in range(-l, l + 1):
            am = abs(m)
            k = float(np.sqrt((2 * l + 1) / (4 * np.pi)
                              * float(math.factorial(l - am))
                              / float(math.factorial(l + am))))
            if m == 0:
                out.append(k * p[(l, 0)])
            elif m > 0:
                out.append(math.sqrt(2.0) * k * p[(l, am)] * cos_m[am])
            else:
                out.append(math.sqrt(2.0) * k * p[(l, am)] * sin_m[am])
    return torch.stack(out, dim=-1)


# ---------------------------------------------------------------------------
# Wigner-D (real basis) — Ivanic-Ruedenberg recursion with static tables
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ivanic_tables(l: int):
    """Static coefficient/index tables for the D^(l-1) -> D^l step."""
    dim, prev = 2 * l + 1, 2 * l - 1
    ms = np.arange(-l, l + 1)

    # --- P-term column tables (depend on n) ---
    # P_i(mu, n) = a1*R1[i, c1]*Dp[mu, d1] + a2*R1[i, c2]*Dp[mu, d2]
    a1 = np.zeros(dim); c1 = np.zeros(dim, np.int64); d1 = np.zeros(dim, np.int64)
    a2 = np.zeros(dim); c2 = np.zeros(dim, np.int64); d2 = np.zeros(dim, np.int64)
    for j, n in enumerate(ms):
        if abs(n) < l:
            a1[j], c1[j], d1[j] = 1.0, 1, n + (l - 1)       # R1[:,0], Dp[:,n]
            a2[j] = 0.0
        elif n == l:
            a1[j], c1[j], d1[j] = 1.0, 2, (l - 1) + (l - 1)   # R1[:,1]*Dp[:,l-1]
            a2[j], c2[j], d2[j] = -1.0, 0, 0                  # -R1[:,-1]*Dp[:,-l+1]
        else:  # n == -l
            a1[j], c1[j], d1[j] = 1.0, 2, 0                   # R1[:,1]*Dp[:,-l+1]
            a2[j], c2[j], d2[j] = 1.0, 0, (l - 1) + (l - 1)   # R1[:,-1]*Dp[:,l-1]

    # --- row (m) tables: coefficients u,v,w and Dprev row indices ---
    u = np.zeros((dim, dim)); v = np.zeros((dim, dim)); w = np.zeros((dim, dim))
    mu_u = np.zeros(dim, np.int64)
    vmu1 = np.zeros(dim, np.int64); vs1 = np.zeros(dim)
    vmu2 = np.zeros(dim, np.int64); vs2 = np.zeros(dim)
    wmu1 = np.zeros(dim, np.int64); wmu2 = np.zeros(dim, np.int64)
    for i, m in enumerate(ms):
        for j, n in enumerate(ms):
            denom = float((l + n) * (l - n)) if abs(n) < l \
                else float(2 * l * (2 * l - 1))
            uu = np.sqrt((l + m) * (l - m) / denom) if (l + m) * (l - m) > 0 else 0.0
            dm0 = 1.0 if m == 0 else 0.0
            vv = 0.5 * np.sqrt((1 + dm0) * (l + abs(m) - 1) * (l + abs(m))
                               / denom) * (1 - 2 * dm0)
            ww_ = (l - abs(m) - 1) * (l - abs(m))
            ww = -0.5 * np.sqrt(ww_ / denom) * (1 - dm0) if ww_ > 0 else 0.0
            u[i, j], v[i, j], w[i, j] = uu, vv, ww
        # U row index (clamped; u=0 when out of range)
        mu_u[i] = int(np.clip(m, -(l - 1), l - 1)) + (l - 1)
        # V term structure
        if m == 0:
            vmu1[i], vs1[i] = 1 + (l - 1), 1.0        # P_1(1, n)
            vmu2[i], vs2[i] = -1 + (l - 1), 1.0       # P_-1(-1, n)
        elif m > 0:
            d1m = 1.0 if m == 1 else 0.0
            vmu1[i], vs1[i] = int(np.clip(m - 1, -(l - 1), l - 1)) + (l - 1), \
                np.sqrt(1 + d1m)
            vmu2[i], vs2[i] = int(np.clip(-m + 1, -(l - 1), l - 1)) + (l - 1), \
                -(1 - d1m)
        else:
            d1m = 1.0 if m == -1 else 0.0
            vmu1[i], vs1[i] = int(np.clip(m + 1, -(l - 1), l - 1)) + (l - 1), \
                (1 - d1m)
            vmu2[i], vs2[i] = int(np.clip(-m - 1, -(l - 1), l - 1)) + (l - 1), \
                np.sqrt(1 + d1m)
        # W term structure (w=0 already handles |m| >= l-1 rows)
        if m > 0:
            wmu1[i] = int(np.clip(m + 1, -(l - 1), l - 1)) + (l - 1)
            wmu2[i] = int(np.clip(-m - 1, -(l - 1), l - 1)) + (l - 1)
        elif m < 0:
            wmu1[i] = int(np.clip(m - 1, -(l - 1), l - 1)) + (l - 1)
            wmu2[i] = int(np.clip(-m + 1, -(l - 1), l - 1)) + (l - 1)

    return dict(a1=a1, c1=c1, d1=d1, a2=a2, c2=c2, d2=d2, u=u, v=v, w=w,
                mu_u=mu_u, vmu1=vmu1, vs1=vs1, vmu2=vmu2, vs2=vs2,
                wmu1=wmu1, wmu2=wmu2, w_sign_m=(ms > 0).astype(np.float64)
                - (ms < 0).astype(np.float64))


@functools.lru_cache(maxsize=None)
def _tables_on(l: int, device: torch.device, dtype: torch.dtype) -> dict:
    """``_ivanic_tables(l)`` as tensors on ``device``: the coefficients in
    ``dtype``, the indices int64; made once per (l, device, dtype)."""
    return {k: torch.as_tensor(v, device=device,
                               dtype=torch.int64 if v.dtype == np.int64
                               else dtype)
            for k, v in _ivanic_tables(l).items()}


def _wigner_step(r1: torch.Tensor, dprev: torch.Tensor, l: int
                 ) -> torch.Tensor:
    """D^(l-1) (..., 2l-1, 2l-1) -> D^l (..., 2l+1, 2l+1).

    r1 is the l=1 rotation in SH order (m = -1, 0, 1).
    """
    t = _tables_on(l, r1.device, r1.dtype)
    # P_i(mu, n) for i in {-1,0,1}: (..., 3, 2l-1, 2l+1)
    term1 = (r1[..., :, t["c1"]][..., :, None, :]
             * dprev[..., None, :, t["d1"]] * t["a1"])
    term2 = (r1[..., :, t["c2"]][..., :, None, :]
             * dprev[..., None, :, t["d2"]] * t["a2"])
    p = term1 + term2                                   # (..., i, mu, n)
    p_m1, p_0, p_p1 = p[..., 0, :, :], p[..., 1, :, :], p[..., 2, :, :]

    big_u = p_0[..., t["mu_u"], :]                      # (..., m, n)
    big_v = (p_p1[..., t["vmu1"], :] * t["vs1"][:, None]
             + p_m1[..., t["vmu2"], :] * t["vs2"][:, None])
    sgn = t["w_sign_m"]
    big_w = torch.where(sgn[:, None] > 0,
                        p_p1[..., t["wmu1"], :] + p_m1[..., t["wmu2"], :],
                        p_p1[..., t["wmu1"], :] - p_m1[..., t["wmu2"], :])
    big_w = big_w * torch.abs(sgn)[:, None]
    return t["u"] * big_u + t["v"] * big_v + t["w"] * big_w


_SH_ORDER = [1, 2, 0]     # real-SH order (m=-1,0,1) <-> cartesian (y, z, x)


def wigner_blocks(r: torch.Tensor, l_max: int) -> list:
    """Cartesian rotations (..., 3, 3) -> [D^0, D^1, ..., D^l_max]."""
    r1 = r[..., _SH_ORDER, :][..., :, _SH_ORDER]
    blocks = [torch.ones(r.shape[:-2] + (1, 1), dtype=r.dtype,
                         device=r.device), r1]
    for l in range(2, l_max + 1):
        blocks.append(_wigner_step(r1, blocks[-1], l))
    return blocks[: l_max + 1]


def wigner_d_from_r(r: torch.Tensor, l_max: int) -> torch.Tensor:
    """Block-diagonal (..., S, S), S = (l_max+1)^2: each block padded with
    zero columns to width S and the rows concatenated (no write into a
    tensor autograd saved)."""
    s = (l_max + 1) ** 2
    rows, off = [], 0
    for l, b in enumerate(wigner_blocks(r, l_max)):
        rows.append(F.pad(b, (off, s - off - (2 * l + 1))))
        off += 2 * l + 1
    return torch.cat(rows, dim=-2)


def rotation_to_z(u: torch.Tensor) -> torch.Tensor:
    """(..., 3) unit vectors -> R with R @ u = e_z (Rodrigues; the poles
    fall back to +/- identity-ish rotations)."""
    # v = u x e_z: the rotation axis times sin
    v0, v1, v2 = u[..., 1], -u[..., 0], torch.zeros_like(u[..., 0])
    c = u[..., 2:3]                            # cos(angle)
    s2 = (v0 * v0 + v1 * v1 + v2 * v2)[..., None]
    eye = torch.eye(3, dtype=u.dtype, device=u.device).expand(
        u.shape[:-1] + (3, 3))
    zero = torch.zeros_like(v0)
    vx = torch.stack([torch.stack([zero, -v2, v1], -1),
                      torch.stack([v2, zero, -v0], -1),
                      torch.stack([-v1, v0, zero], -1)], -2)
    coef = torch.where(s2 > 1e-12, (1.0 - c) / torch.clamp(s2, min=1e-12),
                       0.5)
    r = eye + vx + coef[..., None] * (vx @ vx)
    # u == -e_z: 180-degree rotation about x
    flip = torch.eye(3, dtype=u.dtype, device=u.device)
    flip[1:] = -flip[1:]
    near_neg = (c[..., 0] < -1.0 + 1e-6)[..., None, None]
    return torch.where(near_neg, flip.expand(r.shape), r)
