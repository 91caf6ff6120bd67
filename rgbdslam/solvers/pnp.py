"""PnP family: motion-only bundle adjustment + batched PnP RANSAC.

Batched equivalents of the reference's (off-live-path but shipped) absolute
-pose solvers (SURVEY.md §2.4):

- `motion_only_ba` = Solver/PnPSolver.cpp: g2o motion-only BA — one SE(3)
  vertex, per-match reprojection edges with Huber delta = sqrt(5.991), 4
  rounds of 10 LM iterations with chi^2 > 5.991 outlier demotion
  (Solver/PnPSolver.cpp:46-133). Here: fixed 4x10 damped Gauss-Newton
  rounds with outlier masking between rounds — one 6x6 solve per iteration,
  residuals/Jacobians batched over matches.

- `pnp_ransac` = Solver/PnPRansac.cpp (cv::solvePnPRansac semantics:
  iterations, pixel threshold, confidence-free fixed budget): batched
  hypotheses, each fit by 6-point DLT + polar-decomposition projection onto
  SE(3), scored by reprojection error, best refined with motion_only_ba.
  (The opengv KNEIP/GAO/EPNP selection in Solver/PnP.cpp collapses into this
  single batched minimal solver.)
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from rgbdslam.geometry import se3
from rgbdslam.geometry.camera import Camera

CHI2_TH = 5.991  # Solver/PnPSolver.cpp:97,121 (95% 2-DoF chi-square)


def _project(cam: Camera, pts_c: jnp.ndarray) -> jnp.ndarray:
    z = jnp.where(jnp.abs(pts_c[..., 2]) < 1e-9, 1e-9, pts_c[..., 2])
    u = cam.fx * pts_c[..., 0] / z + cam.cx
    v = cam.fy * pts_c[..., 1] / z + cam.cy
    return jnp.stack([u, v], axis=-1)


def reproj_residuals(cam: Camera, Tcw: jnp.ndarray, Xw: jnp.ndarray,
                     uv: jnp.ndarray) -> jnp.ndarray:
    """(..., N, 2) pixel residuals of world points under Tcw."""
    Xc = se3.transform_points(Tcw, Xw)
    return _project(cam, Xc) - uv


@functools.partial(jax.jit, static_argnums=(0, 5, 6))
def motion_only_ba(
    cam: Camera,
    Tcw_init: jnp.ndarray,
    Xw: jnp.ndarray,
    uv: jnp.ndarray,
    valid: jnp.ndarray,
    rounds: int = 4,
    iters_per_round: int = 10,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Motion-only BA with Huber + chi^2 outlier demotion between rounds.

    Returns (Tcw_opt, inlier_mask). Mirrors PnPSolver::compute
    (Solver/PnPSolver.cpp:102-133): demoted matches are excluded from later
    rounds; the last round drops the robust kernel (delta -> inf).
    """
    delta = jnp.sqrt(CHI2_TH)

    def gn_iter(T, inl, use_huber):
        def res_fn(xi):
            return reproj_residuals(cam, se3.exp(xi) @ T, Xw, uv)

        zero = jnp.zeros((6,), T.dtype)
        r = res_fn(zero)                      # (N, 2)
        J = jax.jacfwd(res_fn)(zero)          # (N, 2, 6)
        r_norm = jnp.linalg.norm(r, axis=-1)
        w_h = jnp.where(
            use_huber & (r_norm > delta),
            delta / jnp.maximum(r_norm, 1e-9),
            1.0,
        )
        w = w_h * inl.astype(T.dtype)
        H = jnp.einsum("nri,nrj,n->ij", J, J, w) + 1e-6 * jnp.eye(6, dtype=T.dtype)
        g = jnp.einsum("nri,nr,n->i", J, r, w)
        xi = -jnp.linalg.solve(H, g)
        return se3.exp(xi) @ T

    T = Tcw_init
    inl = valid
    for rd in range(rounds):
        use_huber = jnp.asarray(rd < rounds - 1)  # kernel removed last round
        T = jax.lax.fori_loop(
            0, iters_per_round, lambda i, Tc: gn_iter(Tc, inl, use_huber), T
        )
        r = reproj_residuals(cam, T, Xw, uv)
        chi2 = jnp.sum(r * r, axis=-1)
        inl = valid & (chi2 <= CHI2_TH)       # demotion (PnPSolver.cpp:117-124)
    return T, inl


# ---------------------------------------------------------------------------
# Batched minimal P3P (Grunert) — the batched analog of the reference's
# opengv KNEIP/GAO/EPNP minimal absolute-pose selection (Solver/PnP.cpp:14-127).
# A 3-point minimal sample makes RANSAC exponentially more outlier-tolerant
# than the 6-point DLT below (inlier^3 vs inlier^6 per-draw success).
# Closed-form: Grunert's distance quartic (Haralick et al. 1994 formulation),
# coefficients derived symbolically (sympy resultant of the two law-of-cosines
# constraints, eliminating u = s2/s1), roots by Ferrari in complex64 + Newton
# polish — XLA has no batched nonsymmetric eig for a companion-matrix
# approach on the accelerator.
# ---------------------------------------------------------------------------


def _one_cubic_root(a, b, c):
    """One complex root of m^3 + a m^2 + b m + c (Cardano, complex64)."""
    p = b - a * a / 3.0
    q = c - a * b / 3.0 + 2.0 * a ** 3 / 27.0
    s = jnp.sqrt((q / 2.0) ** 2 + (p / 3.0) ** 3)
    u3a = -q / 2.0 + s
    u3b = -q / 2.0 - s
    u3 = jnp.where(jnp.abs(u3a) >= jnp.abs(u3b), u3a, u3b)
    u3 = jnp.where(jnp.abs(u3) < 1e-20, jnp.complex64(1e-20), u3)
    u = u3 ** (1.0 / 3.0)
    return u - p / (3.0 * u) - a / 3.0


def _quartic_roots(b, c, d, e, newton: int = 3):
    """All four complex roots of x^4 + b x^3 + c x^2 + d x + e (Ferrari +
    `newton` polish steps — f32-grade coefficients need the polish)."""
    cb_, cc_, cd_, ce_ = (x.astype(jnp.complex64) for x in (b, c, d, e))
    p = cc_ - 3.0 * cb_ * cb_ / 8.0
    q = cd_ - cb_ * cc_ / 2.0 + cb_ ** 3 / 8.0
    r = (ce_ - cb_ * cd_ / 4.0 + cb_ * cb_ * cc_ / 16.0
         - 3.0 * cb_ ** 4 / 256.0)
    m = _one_cubic_root(p, p * p / 4.0 - r, -q * q / 8.0)
    s = jnp.sqrt(2.0 * m)
    s = jnp.where(jnp.abs(s) < 1e-10, jnp.complex64(1e-10), s)
    t1 = jnp.sqrt(-(2.0 * p + 2.0 * m + 2.0 * q / s))
    t2 = jnp.sqrt(-(2.0 * p + 2.0 * m - 2.0 * q / s))
    y = jnp.stack([(s + t1) / 2.0, (s - t1) / 2.0,
                   (-s + t2) / 2.0, (-s - t2) / 2.0])
    x = y - cb_ / 4.0
    for _ in range(newton):
        f = (((x + cb_) * x + cc_) * x + cd_) * x + ce_
        fp = ((4.0 * x + 3.0 * cb_) * x + 2.0 * cc_) * x + cd_
        fp = jnp.where(jnp.abs(fp) < 1e-12, jnp.complex64(1e-12), fp)
        x = x - f / fp
    return x


def _p3p_grunert(fs: jnp.ndarray, Pw: jnp.ndarray):
    """Minimal 3-point absolute pose. fs: (3, 3) unit bearing rays (camera
    frame), Pw: (3, 3) world points. Returns (Tcw (4,4,4), valid (4,)) — up
    to four solutions; invalid slots are identity/False. Disambiguation is
    left to the RANSAC consensus over all points (as opengv's ransac does
    around Solver/PnP.cpp's KNEIP)."""
    f1, f2, f3 = fs[0], fs[1], fs[2]
    P1, P2, P3 = Pw[0], Pw[1], Pw[2]
    a2 = jnp.sum((P2 - P3) ** 2)
    b2 = jnp.sum((P1 - P3) ** 2)
    c2 = jnp.sum((P1 - P2) ** 2)
    ca = jnp.dot(f2, f3)   # angle at camera between rays 2-3
    cb = jnp.dot(f1, f3)
    cg = jnp.dot(f1, f2)
    b2s = jnp.maximum(b2, 1e-12)
    p = a2 / b2s
    q = c2 / b2s
    # Grunert quartic in v = s3/s1 (sympy resultant of the two
    # law-of-cosines constraints over u = s2/s1; overall sign irrelevant)
    A4 = (-4.0 * ca ** 2 * q + p ** 2 - 2.0 * p * q - 2.0 * p
          + q ** 2 + 2.0 * q + 1.0)
    A3 = (8.0 * ca ** 2 * cb * q + 4.0 * ca * cg * p + 4.0 * ca * cg * q
          - 4.0 * ca * cg - 4.0 * cb * p ** 2 + 8.0 * cb * p * q
          + 4.0 * cb * p - 4.0 * cb * q ** 2 - 4.0 * cb * q)
    A2 = (-4.0 * ca ** 2 * q + 4.0 * ca ** 2 - 8.0 * ca * cb * cg * p
          - 8.0 * ca * cb * cg * q + 4.0 * cb ** 2 * p ** 2
          - 8.0 * cb ** 2 * p * q + 4.0 * cb ** 2 * q ** 2
          - 4.0 * cg ** 2 * p + 4.0 * cg ** 2 + 2.0 * p ** 2
          - 4.0 * p * q + 2.0 * q ** 2 - 2.0)
    A1 = (4.0 * ca * cg * p + 4.0 * ca * cg * q - 4.0 * ca * cg
          + 8.0 * cb * cg ** 2 * p - 4.0 * cb * p ** 2 + 8.0 * cb * p * q
          - 4.0 * cb * p - 4.0 * cb * q ** 2 + 4.0 * cb * q)
    A0 = (-4.0 * cg ** 2 * p + p ** 2 - 2.0 * p * q + 2.0 * p
          + q ** 2 - 2.0 * q + 1.0)
    A4s = jnp.where(jnp.abs(A4) < 1e-10, 1e-10, A4)
    roots = _quartic_roots(A3 / A4s, A2 / A4s, A1 / A4s, A0 / A4s)  # (4,)
    v = jnp.real(roots)
    real_ok = jnp.abs(jnp.imag(roots)) < 1e-3 * (1.0 + jnp.abs(v))
    # u from the linear combination (i)-(ii) that cancels u^2
    gb = 1.0 + v * v - 2.0 * v * cb
    den = 2.0 * (cg - v * ca)
    den = jnp.where(jnp.abs(den) < 1e-9, 1e-9, den)
    u = (1.0 - v * v + (p - q) * gb) / den

    # joint Newton polish of (u, v) on the ORIGINAL two law-of-cosines
    # constraints: the expanded quartic's f32 coefficients perturb its roots
    # by up to a few cm of pose; the original system's coefficients
    # (p, q, cosines) are f32-exact, so 3 Newton steps recover the true root
    for _ in range(3):
        g = 1.0 + v * v - 2.0 * v * cb
        F1 = u * u + v * v - 2.0 * u * v * ca - p * g
        F2 = 1.0 + u * u - 2.0 * u * cg - q * g
        J11 = 2.0 * u - 2.0 * v * ca
        J12 = 2.0 * v - 2.0 * u * ca - p * (2.0 * v - 2.0 * cb)
        J21 = 2.0 * u - 2.0 * cg
        J22 = -q * (2.0 * v - 2.0 * cb)
        det = J11 * J22 - J12 * J21
        det = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
        u = u - (J22 * F1 - J12 * F2) / det
        v = v - (-J21 * F1 + J11 * F2) / det

    gb = 1.0 + v * v - 2.0 * v * cb
    s1 = jnp.sqrt(b2s / jnp.maximum(gb, 1e-12))
    s2 = u * s1
    s3 = v * s1
    valid = real_ok & (s1 > 0) & (s2 > 0) & (s3 > 0) & (gb > 1e-9)
    # camera-frame points from the recovered ray depths
    Xc = jnp.stack([s1[:, None] * f1[None, :],
                    s2[:, None] * f2[None, :],
                    s3[:, None] * f3[None, :]], axis=1)     # (4, 3, 3)

    # exact triad alignment (correspondences are exact by construction —
    # the iterative Horn fit in solvers/kabsch.py is built for redundant
    # noisy sets and under-converges on an exact 3-point triad):
    # R = [camera triad] @ [world triad]^T, t = Xc1 - R P1
    def _triad(q1, q2):
        e1 = q1 / jnp.maximum(jnp.linalg.norm(q1, axis=-1, keepdims=True),
                              1e-12)
        q2p = q2 - jnp.sum(q2 * e1, axis=-1, keepdims=True) * e1
        e2 = q2p / jnp.maximum(jnp.linalg.norm(q2p, axis=-1, keepdims=True),
                               1e-12)
        e3 = jnp.cross(e1, e2)
        return jnp.stack([e1, e2, e3], axis=-1)             # (..., 3, 3)

    Ew = _triad(P2 - P1, P3 - P1)                           # (3, 3)
    Ec = _triad(Xc[:, 1] - Xc[:, 0], Xc[:, 2] - Xc[:, 0])   # (4, 3, 3)
    Rm = Ec @ Ew.T                                          # (4, 3, 3)
    t = Xc[:, 0] - jnp.einsum("hij,j->hi", Rm, P1)
    Tcw = se3.from_Rt(Rm, t)
    return Tcw, valid


# ---------------------------------------------------------------------------
# EPnP (Lepetit, Moreno-Noguer, Fua, IJCV 2009) — the >=4-point closed-form
# absolute-pose family of the reference's opengv EPNP option
# (Solver/PnP.cpp's KNEIP/GAO/EPNP algorithm enum). O(n): the unknown pose is
# expressed through 4 control points, every world point as fixed barycentric
# coordinates of them; the camera-frame control points live in the <=4-dim
# null space of a 2n x 12 system, the null-space mixing betas come from the
# inter-control-point distance constraints (3 closed-form seeds + a small
# Gauss-Newton), and the pose is a rigid fit world->camera. All fixed-shape
# (eigh of 12x12, 4x4/6x? normal solves) — batchable via vmap.
# ---------------------------------------------------------------------------

_EPNP_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _epnp_pose(Xw: jnp.ndarray, uv_n: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """EPnP pose from S >= 4 weighted correspondences. Xw: (S, 3) world
    points, uv_n: (S, 2) normalized image coords, w: (S,) nonnegative
    weights (0 = excluded; weight-aware throughout, so it doubles as the
    non-minimal consensus refit inside pnp_ransac). Returns Tcw (4, 4)."""
    S = Xw.shape[0]
    dtype = Xw.dtype
    wn = w / jnp.maximum(jnp.sum(w), 1e-12)

    # world control points: weighted centroid + principal axes (paper §3.1;
    # the eps floor keeps near-planar scenes solvable)
    c0 = jnp.sum(wn[:, None] * Xw, axis=0)
    Xc0 = Xw - c0
    cov = jnp.einsum("n,ni,nj->ij", wn, Xc0, Xc0)
    evals, evecs = jnp.linalg.eigh(cov)                 # ascending
    sc = jnp.sqrt(jnp.maximum(evals, 1e-8))
    Cw = jnp.stack([c0,
                    c0 + sc[2] * evecs[:, 2],
                    c0 + sc[1] * evecs[:, 1],
                    c0 + sc[0] * evecs[:, 0]])          # (4, 3)

    # barycentric coordinates: [Cw^T; 1] alpha = [X; 1]
    CT = jnp.concatenate([Cw.T, jnp.ones((1, 4), dtype)], axis=0)  # (4, 4)
    rhs = jnp.concatenate([Xw.T, jnp.ones((1, S), dtype)], axis=0)
    alphas = jnp.linalg.solve(CT, rhs).T                # (S, 4)

    # M^T M of the 2S x 12 projection system, built per point
    x, y = uv_n[:, 0], uv_n[:, 1]
    z3 = jnp.zeros_like(alphas)
    Mu = jnp.stack([alphas, z3, -alphas * x[:, None]],
                   axis=-1).reshape(S, 12)              # [a,0,-a*x] per ctrl
    Mv = jnp.stack([z3, alphas, -alphas * y[:, None]],
                   axis=-1).reshape(S, 12)
    MtM = (jnp.einsum("n,ni,nj->ij", w, Mu, Mu)
           + jnp.einsum("n,ni,nj->ij", w, Mv, Mv))
    _ev, V12 = jnp.linalg.eigh(MtM)
    V = V12[:, :4].T.reshape(4, 4, 3)                   # 4 null vecs as ctrl pts

    # inter-control-point difference vectors of each null vector + targets
    ia = jnp.array([p[0] for p in _EPNP_PAIRS])
    ib = jnp.array([p[1] for p in _EPNP_PAIRS])
    dv = V[:, ia] - V[:, ib]                            # (4, 6, 3)
    rho = jnp.sum((Cw[ia] - Cw[ib]) ** 2, axis=-1)      # (6,)

    def _ls(cols, prods_of_beta):
        """Solve L[:, cols] b = rho in least squares; return b."""
        A = jnp.stack(cols, axis=1)                     # (6, k)
        AtA = A.T @ A + 1e-9 * jnp.eye(A.shape[1], dtype=dtype)
        return jnp.linalg.solve(AtA, A.T @ rho)

    # L columns are dot products of the dv's: L_bij = dv_i . dv_j (x2 off-diag)
    def col(i, j):
        f = 1.0 if i == j else 2.0
        return f * jnp.sum(dv[i] * dv[j], axis=-1)      # (6,)

    def _safe_sqrt(v):
        return jnp.sqrt(jnp.maximum(v, 0.0))

    # seed 1: betas ~ [b11, b12, b13, b14] (the dominant null vector + cross
    # terms; opencv find_betas_approx_1)
    b4 = _ls([col(0, 0), col(0, 1), col(0, 2), col(0, 3)], None)
    s0 = jnp.where(b4[0] < 0, -1.0, 1.0)
    be1 = _safe_sqrt(s0 * b4[0])
    beta_a = jnp.stack([be1,
                        s0 * b4[1] / jnp.maximum(be1, 1e-9),
                        s0 * b4[2] / jnp.maximum(be1, 1e-9),
                        s0 * b4[3] / jnp.maximum(be1, 1e-9)])

    # seed 2: [b11, b12, b22] (opencv find_betas_approx_2)
    b3 = _ls([col(0, 0), col(0, 1), col(1, 1)], None)
    be1 = _safe_sqrt(jnp.abs(b3[0]))
    be2 = _safe_sqrt(jnp.abs(b3[2])) * jnp.where(b3[1] >= 0, 1.0, -1.0)
    beta_b = jnp.stack([be1, be2, jnp.zeros((), dtype), jnp.zeros((), dtype)])

    # seed 3: [b11, b12, b22, b13, b23] (opencv find_betas_approx_3)
    b5 = _ls([col(0, 0), col(0, 1), col(1, 1), col(0, 2), col(1, 2)], None)
    be1 = _safe_sqrt(jnp.abs(b5[0]))
    be2 = _safe_sqrt(jnp.abs(b5[2])) * jnp.where(b5[1] >= 0, 1.0, -1.0)
    be3 = b5[3] / jnp.maximum(be1, 1e-9)
    beta_c = jnp.stack([be1, be2, be3, jnp.zeros((), dtype)])

    def _gauss_newton(beta):
        """5 GN steps on ||sum_k beta_k dv_k[pair]||^2 = rho (paper §3.4)."""
        def step(_, b):
            cc = jnp.einsum("k,kpi->pi", b, dv)          # (6, 3)
            res = jnp.sum(cc * cc, axis=-1) - rho        # (6,)
            J = 2.0 * jnp.einsum("pi,kpi->pk", cc, dv)   # (6, 4)
            H = J.T @ J + 1e-9 * jnp.eye(4, dtype=dtype)
            return b - jnp.linalg.solve(H, J.T @ res)
        return jax.lax.fori_loop(0, 5, step, beta)

    def _pose_from_beta(beta):
        from rgbdslam.solvers.kabsch import weighted_rigid_transform

        Cc = jnp.einsum("k,kci->ci", beta, V)            # (4, 3)
        Xc = alphas @ Cc                                 # (S, 3)
        # cheirality: the null vector's sign is arbitrary
        zbar = jnp.sum(wn * Xc[:, 2])
        Xc = jnp.where(zbar < 0, -Xc, Xc)
        T = weighted_rigid_transform(Xw, Xc, w)
        pr = Xc[:, :2] / jnp.maximum(Xc[:, 2:3], 1e-9)
        err = jnp.sum(wn * jnp.sum((pr - uv_n) ** 2, axis=-1))
        return T, err

    best_T = jnp.eye(4, dtype=dtype)
    best_err = jnp.asarray(jnp.inf, dtype)
    for seed in (beta_a, beta_b, beta_c):
        T, err = _pose_from_beta(_gauss_newton(seed))
        take = err < best_err
        best_T = jnp.where(take, T, best_T)
        best_err = jnp.where(take, err, best_err)
    return best_T


def _dlt_pose(Xw: jnp.ndarray, uv_n: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """6+-point DLT for [R|t] from world points and *normalized* image coords,
    followed by polar-decomposition projection onto SO(3). Batched over
    leading dims. Xw: (..., S, 3), uv_n: (..., S, 2), w: (..., S)."""
    S = Xw.shape[-2]
    X = jnp.concatenate([Xw, jnp.ones(Xw.shape[:-1] + (1,), Xw.dtype)], axis=-1)
    zero = jnp.zeros_like(X)
    x, y = uv_n[..., 0:1], uv_n[..., 1:2]
    row_u = jnp.concatenate([X, zero, -x * X], axis=-1)     # (..., S, 12)
    row_v = jnp.concatenate([zero, X, -y * X], axis=-1)
    A = jnp.concatenate([row_u, row_v], axis=-2)            # (..., 2S, 12)
    ws = jnp.concatenate([w, w], axis=-1)[..., None]
    AtA = jnp.einsum("...ni,...nj->...ij", A * ws, A)       # (..., 12, 12)
    # null vector = smallest eigenvector
    evals, evecs = jnp.linalg.eigh(AtA)
    p = evecs[..., :, 0]
    P = p.reshape(p.shape[:-1] + (3, 4))
    M = P[..., :3]
    # fix sign: points must be in front (positive depth for centroid)
    cent = jnp.mean(Xw, axis=-2)
    zc = jnp.einsum("...ij,...j->...i", M, cent)[..., 2] + P[..., 2, 3]
    sign = jnp.where(zc < 0, -1.0, 1.0)[..., None, None]
    P = P * sign
    M = P[..., :3]
    t = P[..., 3]
    # scale: det(M)^(1/3) -> unit rotation
    det = jnp.linalg.det(M)
    scale = jnp.sign(det) * jnp.abs(det) ** (1.0 / 3.0)
    scale = jnp.where(jnp.abs(scale) < 1e-12, 1e-12, scale)
    M = M / scale[..., None, None]
    t = t / scale[..., None]
    # polar decomposition via Newton iteration: R <- (R + R^-T)/2
    R = M
    for _ in range(6):
        R = 0.5 * (R + jnp.linalg.inv(jnp.swapaxes(R, -1, -2)))
    return se3.from_Rt(R, t)


class PnPResult(NamedTuple):
    Tcw: jnp.ndarray
    inliers: jnp.ndarray
    num_inliers: jnp.ndarray
    success: jnp.ndarray


@functools.partial(jax.jit, static_argnums=(0, 5, 6, 7))
def pnp_ransac(
    cam: Camera,
    Xw: jnp.ndarray,
    uv: jnp.ndarray,
    valid: jnp.ndarray,
    key: jnp.ndarray,
    cfg=None,
    minimal: str = "p3p",
    refit: str = "ba",
) -> PnPResult:
    """Batched PnP RANSAC: minimal-solver hypotheses + reprojection scoring +
    motion-only BA refinement of the winner.

    minimal='p3p' (default): 3-point Grunert closed form, up to 4 poses per
    sample, all scored — the Solver/PnP.cpp:14-127 KNEIP/GAO class. A
    3-point sample succeeds per draw with probability inlier_ratio^3 vs the
    DLT's ^6, which dominates at high outlier rates (tests/test_pnp_icp.py).
    minimal='epnp': 4-point EPnP hypotheses (the opengv EPNP option of the
    Solver/PnP.cpp algorithm enum — the >=4-point closed-form family).
    minimal='dlt6': the 6-point DLT (kept for A/B and as the no-quartic
    fallback). Defaults mirror Solver/PnPRansac.cpp:14-56: pixel threshold
    3.0, hypothesis budget ~ its 500 iterations (H=256 independent samples,
    up to 4 scored poses each on the p3p path).

    refit='ba' (default): motion-only BA on the winner's consensus set.
    refit='epnp+ba': EPnP non-minimal refit over the consensus set first
    (the paper's intended all-inlier usage), then motion-only BA — the
    closed-form refit is immune to the local minima a GN-from-minimal-pose
    start can fall into when the winning sample was noisy.
    """
    H = 256
    px_th = 3.0
    min_inliers = 10

    n = Xw.shape[0]
    logits = jnp.where(valid, 0.0, -jnp.inf)
    any_valid = jnp.any(valid)
    logits = jnp.where(any_valid, logits, jnp.zeros_like(logits))

    uv_n = jnp.stack(
        [(uv[..., 0] - cam.cx) / cam.fx, (uv[..., 1] - cam.cy) / cam.fy], axis=-1
    )
    if minimal == "p3p":
        S = 3
        idx = jax.random.categorical(key, logits, shape=(H, S))
        rays = jnp.concatenate(
            [uv_n, jnp.ones(uv_n.shape[:-1] + (1,), uv_n.dtype)], axis=-1)
        rays = rays / jnp.linalg.norm(rays, axis=-1, keepdims=True)
        T_4, ok_4 = jax.vmap(_p3p_grunert)(rays[idx], Xw[idx])  # (H,4,4,4)
        T_h = T_4.reshape(-1, 4, 4)                              # (4H,4,4)
        hyp_ok = ok_4.reshape(-1)
    elif minimal == "epnp":
        S = 4
        idx = jax.random.categorical(key, logits, shape=(H, S))
        T_h = jax.vmap(_epnp_pose)(
            Xw[idx], uv_n[idx], valid[idx].astype(Xw.dtype))
        hyp_ok = jnp.ones((H,), bool)
    else:
        S = 6
        idx = jax.random.categorical(key, logits, shape=(H, S))
        T_h = _dlt_pose(Xw[idx], uv_n[idx], valid[idx].astype(Xw.dtype))
        hyp_ok = jnp.ones((H,), bool)

    # batched residuals: (H', N, 2)
    Xc = jnp.einsum("hij,nj->hni", T_h[:, :3, :3], Xw) + T_h[:, None, :3, 3]
    pr = _project(cam, Xc)
    err2 = jnp.sum((pr - uv[None]) ** 2, axis=-1)
    inl_h = (err2 <= px_th * px_th) & valid[None, :] & (Xc[..., 2] > 0.05)
    cnt_h = jnp.sum(inl_h, axis=-1) * hyp_ok
    best = jnp.argmax(cnt_h)

    T0 = T_h[best]
    inl0 = inl_h[best]
    if refit == "epnp+ba":
        # non-minimal closed-form consensus refit (EPnP over the winner's
        # inlier set) before the local BA polish
        w_inl = (inl0 & valid).astype(Xw.dtype)
        T_e = _epnp_pose(Xw, uv_n, w_inl)
        Xc_e = jnp.einsum("ij,nj->ni", T_e[:3, :3], Xw) + T_e[:3, 3]
        err2_e = jnp.sum((_project(cam, Xc_e) - uv) ** 2, axis=-1)
        inl_e = (err2_e <= px_th * px_th) & valid & (Xc_e[..., 2] > 0.05)
        take = jnp.sum(inl_e) >= jnp.sum(inl0)
        T0 = jnp.where(take, T_e, T0)
        inl0 = jnp.where(take, inl_e, inl0)
    T_ref, inl_ref = motion_only_ba(cam, T0, Xw, uv, inl0 & valid)
    cnt = jnp.sum(inl_ref)
    success = (cnt >= min_inliers) & any_valid
    return PnPResult(
        Tcw=jnp.where(success, T_ref, jnp.eye(4, dtype=T_ref.dtype)),
        inliers=inl_ref & success,
        num_inliers=cnt.astype(jnp.int32),
        success=success,
    )
