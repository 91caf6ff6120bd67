"""Pallas kernels for the GPU, written for the Triton route.

``gicp_refine_kernel`` runs the whole plane-to-plane Gauss-Newton loop of
the GICP polish in one program; its plain reference is the ``fori_loop`` in
solvers/icp.gicp_refine, which XLA compiles into ~40 launches per iteration.
A stage gets a kernel here only if it beats what XLA makes of the plain
form inside the VO step on the card (PERF.md, Findings).

Which implementation runs is decided in one place, ops/backend.py. Every
``pallas_call`` names its route; ``interpret=True`` is for tests on a host
without a GPU.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# ---------------------------------------------------------------------------
# GICP: the whole Gauss-Newton loop in one program
# ---------------------------------------------------------------------------
#
# At ~1k correspondences one GN round is ~20 small operations and a 6x6
# solve; compiled by XLA each is a kernel launch, so the loop is launch-bound.
# Here one CTA holds the per-point planes in registers for all rounds: the 27
# normal-equation sums are block reductions, and the damped 6x6 Cholesky and
# the SE(3) exp-compose run on scalars in-kernel.

_GICP_PLANES = 32   # 19 used: p1(3) p2(3) C1(6) C2(6) valid(1)


def _gicp_warps(n_pad: int) -> int:
    """Warps per CTA by padded point count. On an H100, 10 iterations:
    8 warps take 0.083 ms at 1024 points and 0.12 ms at 2048; at 4096 they
    spill registers (0.91 ms) and 16 warps take 0.35 ms (PERF.md)."""
    return 8 if n_pad <= 2048 else 16


def _sym(entries):
    def at(i, j):
        return entries[(i, j)] if i <= j else entries[(j, i)]
    return at


def _gicp_iteration(Rm, tv, p1, p2, c1, c2, vld, max_dist: float):
    """One plane-to-plane GN normal-equation build over per-point planes.

    Rm: 3x3 nested list of scalars; tv: 3-list of scalars.
    Returns (Hs: 21 upper-tri scalars, bs: 6 scalars, cost, count).
    """
    # q = R p1 + t; r = q - p2
    q = [Rm[i][0] * p1[0] + Rm[i][1] * p1[1] + Rm[i][2] * p1[2] + tv[i]
         for i in range(3)]
    r = [q[i] - p2[i] for i in range(3)]

    # S = R C1 R^T + C2 (6 unique planes)
    def s_entry(i, j):
        acc = None
        for k in range(3):
            for l in range(3):
                term = (Rm[i][k] * Rm[j][l]) * c1(k, l)
                acc = term if acc is None else acc + term
        return acc + c2(i, j)

    a = s_entry(0, 0)
    b_ = s_entry(0, 1)
    c_ = s_entry(0, 2)
    d_ = s_entry(1, 1)
    e_ = s_entry(1, 2)
    f_ = s_entry(2, 2)

    # W = S^-1 via adjugate/det (S symmetric positive definite)
    A11 = d_ * f_ - e_ * e_
    A12 = c_ * e_ - b_ * f_
    A13 = b_ * e_ - c_ * d_
    A22 = a * f_ - c_ * c_
    A23 = b_ * c_ - a * e_
    A33 = a * d_ - b_ * b_
    det = a * A11 + b_ * A12 + c_ * A13
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
    w = _sym({(0, 0): A11 * inv_det, (0, 1): A12 * inv_det,
              (0, 2): A13 * inv_det, (1, 1): A22 * inv_det,
              (1, 2): A23 * inv_det, (2, 2): A33 * inv_det})

    dist2 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2]
    gate = jnp.where(vld & (dist2 < max_dist * max_dist), 1.0, 0.0)

    # J = [I3 | -hat(q)]; -hat(q) = [[0, qz, -qy], [-qz, 0, qx], [qy, -qx, 0]]
    zero = jnp.zeros_like(q[0])
    one = jnp.full_like(q[0], 1.0)
    Jr = [[zero, q[2], -q[1]],
          [-q[2], zero, q[0]],
          [q[1], -q[0], zero]]

    def jcol(c):
        if c < 3:
            return [one if i == c else zero for i in range(3)]
        return [Jr[i][c - 3] for i in range(3)]

    cols = [jcol(c) for c in range(6)]
    Wcols = [[w(i, 0) * col[0] + w(i, 1) * col[1] + w(i, 2) * col[2]
              for i in range(3)] for col in cols]

    Hs = []
    for i in range(6):
        for j in range(i, 6):
            hij = (cols[i][0] * Wcols[j][0] + cols[i][1] * Wcols[j][1]
                   + cols[i][2] * Wcols[j][2])
            Hs.append(jnp.sum(hij * gate))
    bs = []
    for i in range(6):
        bi = (Wcols[i][0] * r[0] + Wcols[i][1] * r[1] + Wcols[i][2] * r[2])
        bs.append(jnp.sum(bi * gate))
    wr = [w(i, 0) * r[0] + w(i, 1) * r[1] + w(i, 2) * r[2] for i in range(3)]
    cost = jnp.sum((r[0] * wr[0] + r[1] * wr[1] + r[2] * wr[2]) * gate)
    return Hs, bs, cost, jnp.sum(gate)


def _chol6_solve_neg(Hs, bs, damping: float):
    """x = -(H + damping I)^-1 b on scalars: unrolled 6x6 Cholesky +
    forward/back substitution (Hs = 21 upper-triangular entries)."""
    A = [[None] * 6 for _ in range(6)]
    k = 0
    for i in range(6):
        for j in range(i, 6):
            A[i][j] = Hs[k]
            A[j][i] = Hs[k]
            k += 1
        A[i][i] = A[i][i] + damping

    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i + 1):
            s = A[i][j]
            for m in range(j):
                s = s - L[i][m] * L[j][m]
            if i == j:
                L[i][i] = jnp.sqrt(jnp.maximum(s, 1e-20))
            else:
                L[i][j] = s / L[j][j]
    # forward: L y = -b
    y = [None] * 6
    for i in range(6):
        s = -bs[i]
        for m in range(i):
            s = s - L[i][m] * y[m]
        y[i] = s / L[i][i]
    # back: L^T x = y
    x = [None] * 6
    for i in range(5, -1, -1):
        s = y[i]
        for m in range(i + 1, 6):
            s = s - L[m][i] * x[m]
        x[i] = s / L[i][i]
    return x


def _se3_exp_compose(xi, Rm, tv):
    """(R', t') = exp(xi) (R, t) on scalars — xi = [rho, phi], the same
    [rho | phi] left-increment convention as geometry/se3.exp."""
    rho = xi[:3]
    phi = xi[3:]
    th2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2]
    th = jnp.sqrt(th2)
    small = th2 < 1e-12
    safe_th = jnp.where(small, 1.0, th)
    safe_th2 = jnp.where(small, 1.0, th2)
    # series-safe coefficients
    A = jnp.where(small, 1.0 - th2 / 6.0, jnp.sin(th) / safe_th)
    B = jnp.where(small, 0.5 - th2 / 24.0, (1.0 - jnp.cos(th)) / safe_th2)
    C = jnp.where(small, 1.0 / 6.0 - th2 / 120.0,
                  (th - jnp.sin(th)) / (safe_th2 * safe_th))

    def hat_sq(i, j):
        # (hat(phi)^2)_ij = phi_i phi_j - delta_ij th2
        v = phi[i] * phi[j]
        return v - th2 if i == j else v

    hat = [[0.0, -phi[2], phi[1]],
           [phi[2], 0.0, -phi[0]],
           [-phi[1], phi[0], 0.0]]
    Re = [[(1.0 if i == j else 0.0) + A * hat[i][j] + B * hat_sq(i, j)
           for j in range(3)] for i in range(3)]
    V = [[(1.0 if i == j else 0.0) + B * hat[i][j] + C * hat_sq(i, j)
          for j in range(3)] for i in range(3)]
    te = [V[i][0] * rho[0] + V[i][1] * rho[1] + V[i][2] * rho[2]
          for i in range(3)]
    R_new = [[Re[i][0] * Rm[0][j] + Re[i][1] * Rm[1][j] + Re[i][2] * Rm[2][j]
              for j in range(3)] for i in range(3)]
    t_new = [Re[i][0] * tv[0] + Re[i][1] * tv[1] + Re[i][2] * tv[2] + te[i]
             for i in range(3)]
    return R_new, t_new


def _gicp_loop_kernel(rt_ref, planes_ref, out_ref, *, iters: int,
                      max_dist: float, damping: float):
    """`iters` rounds of (normal equations -> damped Cholesky -> SE(3)
    exp-compose) in one program.

    rt_ref: (16,) [R.ravel(9) | t(3) | 0]; planes_ref: (32, NP) per-point
    planes (see _pack_gicp_inputs). out_ref: (16,) [R.ravel(9) | t(3) |
    final cost | final gated count | 0 0].
    """
    rt = rt_ref[...]
    lane = jax.lax.broadcasted_iota(jnp.int32, rt.shape, 0)

    def scalar(k):
        return jnp.sum(jnp.where(lane == k, rt, 0.0))

    def plane(k):
        return planes_ref[k, :]

    p1 = (plane(0), plane(1), plane(2))
    p2 = (plane(3), plane(4), plane(5))
    c1 = _sym({(0, 0): plane(6), (0, 1): plane(7), (0, 2): plane(8),
               (1, 1): plane(9), (1, 2): plane(10), (2, 2): plane(11)})
    c2 = _sym({(0, 0): plane(12), (0, 1): plane(13), (0, 2): plane(14),
               (1, 1): plane(15), (1, 2): plane(16), (2, 2): plane(17)})
    vld = plane(18) != 0.0

    def body(_, carry):
        r9, t3, _cost, _cnt = carry
        Rm = [[r9[3 * i + j] for j in range(3)] for i in range(3)]
        Hs, bs, cost, cnt = _gicp_iteration(Rm, t3, p1, p2, c1, c2, vld,
                                            max_dist)
        xi = _chol6_solve_neg(Hs, bs, damping)
        Rm, t3 = _se3_exp_compose(xi, Rm, t3)
        return [Rm[i][j] for i in range(3) for j in range(3)], t3, cost, cnt

    zero = jnp.float32(0.0)
    init = ([scalar(k) for k in range(9)], [scalar(9 + i) for i in range(3)],
            zero, zero)
    r9, t3, cost, cnt = jax.lax.fori_loop(0, iters, body, init)

    out = jnp.zeros(rt.shape, jnp.float32)
    for k, val in enumerate(r9 + t3 + [cost, cnt]):
        out = jnp.where(lane == k, val, out)
    out_ref[...] = out


def _pack_gicp_inputs(T, p1, p2, C1, C2, valid):
    """rt (16,) + planes (32, NP), NP = N rounded up to a power of two;
    padding points are invalid and add nothing to any sum."""
    n = p1.shape[0]
    n_pad = max(16, 1 << (n - 1).bit_length())
    rt = jnp.concatenate(
        [T[:3, :3].reshape(9), T[:3, 3], jnp.zeros((4,), T.dtype)]
    ).astype(jnp.float32)

    def sym6(C):
        return jnp.stack([C[:, 0, 0], C[:, 0, 1], C[:, 0, 2],
                          C[:, 1, 1], C[:, 1, 2], C[:, 2, 2]])    # (6, N)

    planes = jnp.concatenate(
        [p1.T, p2.T, sym6(C1), sym6(C2), valid.astype(jnp.float32)[None, :]],
        axis=0,
    ).astype(jnp.float32)                                        # (19, N)
    planes = jnp.pad(planes, ((0, _GICP_PLANES - planes.shape[0]),
                              (0, n_pad - n)))
    return rt, planes


@functools.partial(jax.jit, static_argnums=(6, 7, 8, 9))
def gicp_refine_kernel(
    T_init: jnp.ndarray,
    p1: jnp.ndarray,
    p2: jnp.ndarray,
    C1: jnp.ndarray,
    C2: jnp.ndarray,
    valid: jnp.ndarray,
    iters: int,
    max_dist: float,
    damping: float = 1e-6,
    interpret: bool = False,
):
    """Complete plane-to-plane GN refinement in ONE kernel launch.

    Returns (T (4,4), final cost (), final gated count ()). Same math per
    round as the XLA fori_loop in solvers/icp.gicp_refine: normal equations
    -> damped Cholesky -> left-multiplied SE(3) update.
    """
    rt, planes = _pack_gicp_inputs(T_init, p1, p2, C1, C2, valid)
    out = pl.pallas_call(
        functools.partial(_gicp_loop_kernel, iters=int(iters),
                          max_dist=float(max_dist), damping=float(damping)),
        out_shape=jax.ShapeDtypeStruct((16,), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=_gicp_warps(planes.shape[1]), num_stages=1),
        interpret=interpret,
        name="gicp_refine",
    )(rt, planes)
    T = (jnp.eye(4, dtype=jnp.float32)
         .at[:3, :3].set(out[:9].reshape(3, 3)).at[:3, 3].set(out[9:12]))
    return T, out[12], out[13]
