"""Pose-graph optimisation: damped Gauss-Newton on SE(3).

Counterpart of ``atdn_vslam_tpu/geometry/pose_graph.py`` (the
reference has no geometric backend). State: N absolute poses, pose 0
held fixed (the gauge). Residual of an edge (i, j) with measured
relative transform Z: r = log(Z^-1 X_i^-1 X_j) in R^6, weighted by the
square root of the edge's weight. Each edge depends on two poses, so
its Jacobian is two (6, 6) blocks, taken by forward-mode AD over a
12-dim per-edge tangent (``torch.func.vmap`` of ``torch.func.jacfwd``),
and the normal equations are assembled by block scatter-adds. Two
linear solvers:

  * ``"dense"``: the (6N, 6N) normal matrix with the gauge block
    dropped, Marquardt damping (lam * diag(A) + lam * I), Cholesky;
  * ``"cg"``: matrix-free conjugate gradient on the same equations with
    a fixed iteration count, a block-Jacobi Cholesky preconditioner and
    block row 0 projected out; O(E) memory.

The solve runs in float32 with TF32 off for matmuls and convolutions
(the JAX package traces it under ``default_matmul_precision("highest")``:
reduced-precision products made its Cholesky fail).
"""

from __future__ import annotations

import torch

from atdn_vslam_torch.geometry.se3 import homogeneous, se3_inverse
from atdn_vslam_torch.utils.helpers import full_float32

_EPS = 1e-8

# Small-angle guards follow the "double-where" pattern: every ratio is
# computed from a smooth primitive (theta^2 as a polynomial of the
# inputs), with the singular branch's inputs replaced by safe constants
# *before* the nonlinearity, so derivatives stay finite at the identity,
# where a consistent graph's residuals sit.
_SMALL = 1e-8


def _skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrices."""
    zeros = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -v[..., 2], v[..., 1]], -1),
            torch.stack([v[..., 2], zeros, -v[..., 0]], -1),
            torch.stack([-v[..., 1], v[..., 0], zeros], -1),
        ],
        -2,
    )


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """max then min, as ``jnp.clip``: a tie splits the derivative in half
    on both sides, where ``torch.clamp`` passes it whole."""
    return torch.minimum(torch.maximum(x, torch.full_like(x, lo)), torch.full_like(x, hi))


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def _sincs(t2: torch.Tensor):
    """(sin th / th, (1 - cos th) / th^2, (th - sin th) / th^3) from
    theta^2, derivative-safe at 0."""
    small = t2 < _SMALL
    t2_safe = torch.where(small, torch.ones_like(t2), t2)
    theta = torch.sqrt(t2_safe)
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(theta)) / t2_safe)
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0, (theta - torch.sin(theta)) / (t2_safe * theta))
    return a, b, c


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) rotation vectors -> (..., 3, 3)."""
    t2 = torch.sum(w * w, dim=-1)[..., None, None]
    K = _skew(w)
    a, b, _ = _sincs(t2)
    return _eye3(K) + a * K + b * (K @ K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3) rotation vectors.

    Guarded at both singular regions: a Taylor branch near the identity,
    and near theta = pi, where the antisymmetric part vanishes, the axis
    from the dominant column of R + I (a closure edge with a ~180 degree
    residual must not give NaN in the solve)."""
    # (..., 1) throughout: under torch.func a 0-dim float32 value minus a
    # Python float came out float64
    trace = torch.diagonal(R, dim1=-2, dim2=-1).sum(-1, keepdim=True)
    cos = _clip((trace - 1.0) / 2.0, -1.0, 1.0)
    vee = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]], -1
    )
    near_id = cos > 1.0 - 1e-6
    near_pi = cos < -1.0 + 1e-4
    singular = near_id | near_pi
    theta = torch.arccos(torch.where(singular, torch.zeros_like(cos), cos))
    t2_small = 2.0 * (1.0 - cos)  # theta^2 as a polynomial near the identity
    scale = torch.where(
        near_id,
        0.5 + t2_small / 12.0,
        theta / (2.0 * torch.sin(torch.where(singular, torch.ones_like(theta), theta))),
    )
    main = scale * vee

    # near pi: R ~= 2 n n^T - I, so the axis is the largest column of R + I
    B = R + _eye3(R)
    k = torch.argmax(torch.linalg.norm(B, dim=-2), dim=-1)
    axis = torch.gather(B, -1, k[..., None, None].expand(*B.shape[:-1], 1))[..., 0]
    axis = axis / (torch.linalg.norm(axis, dim=-1, keepdim=True) + _EPS)
    theta_pi = torch.arccos(_clip(cos, -1.0 + 1e-7, 1.0))
    # orient consistently with the (tiny but signed) antisymmetric part
    dot = torch.sum(vee * axis, dim=-1, keepdim=True)
    sign = torch.where(dot < 0, -torch.ones_like(dot), torch.ones_like(dot))
    return torch.where(near_pi, theta_pi * axis * sign, main)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Twist (..., 6) = (rho, phi) -> (..., 4, 4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    t2 = torch.sum(phi * phi, dim=-1)[..., None, None]
    K = _skew(phi)
    _, b, c = _sincs(t2)
    V = _eye3(K) + b * K + c * (K @ K)
    t = (V @ rho[..., None])[..., 0]
    return homogeneous(torch.cat([R, t[..., None]], -1))


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> twist (..., 6) = (rho, phi), derivative-safe at I."""
    phi = so3_log(T[..., :3, :3])
    t2 = torch.sum(phi * phi, dim=-1)[..., None, None]
    K = _skew(phi)
    small = t2 < _SMALL
    t2_safe = torch.where(small, torch.ones_like(t2), t2)
    theta = torch.sqrt(t2_safe)
    # V^-1 = I - K / 2 + coef K^2 with coef = 1 / th^2 - (1 + cos th) /
    # (2 th sin th), written with the half angle, (1 + cos th) / sin th =
    # cos(th / 2) / sin(th / 2), which has no 0 / 0 at th = pi. (The JAX
    # package guards 2 th sin th < 1e-6 instead, which also catches
    # 1e-4 < th < 7e-4 and there gives a wrong V^-1.)
    half = 0.5 * theta
    coef = torch.where(
        small, 1.0 / 12.0 + t2 / 720.0, 1.0 / t2_safe - torch.cos(half) / (2.0 * theta * torch.sin(half))
    )
    v_inv = _eye3(K) - 0.5 * K + coef * (K @ K)
    rho = (v_inv @ T[..., :3, 3:])[..., 0]
    return torch.cat([rho, phi], -1)


def edge_residuals(
    poses: torch.Tensor, edges_i: torch.Tensor, edges_j: torch.Tensor, measurements: torch.Tensor
) -> torch.Tensor:
    """r_e = log(Z_e^-1 X_i^-1 X_j) for each edge -> (E, 6)."""
    pred = se3_inverse(poses[edges_i]) @ poses[edges_j]
    return se3_log(se3_inverse(measurements) @ pred)


def _pcg_solve(matvec, b: torch.Tensor, prec, iterations: int) -> torch.Tensor:
    """Preconditioned conjugate gradient with a fixed iteration count.

    Convergence freeze: once ||r||^2 falls below 1e-12 ||b||^2, further
    steps would divide near-zero rz / pAp and amplify rounding noise, so
    alpha and beta are held at 0 and the state stays a fixed point. All
    on the device: no step reads a value back to the host."""
    x = torch.zeros_like(b)
    r = b
    z = prec(r)
    p = z
    rz = torch.sum(r * z)
    bnorm2 = torch.clamp(torch.sum(b * b), min=1e-30)
    zero = torch.zeros_like(rz)
    one = torch.ones_like(rz)
    for _ in range(iterations):
        active = torch.sum(r * r) > 1e-12 * bnorm2
        ap = matvec(p)
        pap = torch.sum(p * ap)
        ok = active & (pap > 0)
        alpha = torch.where(ok, rz / torch.where(pap == 0, one, pap), zero)
        x = x + alpha * p
        r = r - alpha * ap
        z = prec(r)
        rz_new = torch.sum(r * z)
        beta = torch.where(ok, rz_new / torch.where(rz == 0, one, rz), zero)
        p = z + beta * p
        rz = torch.where(ok, rz_new, rz)
    return x


def _edge_residual(di, dj, xi, xj, z, sw):
    """One edge's weighted residual at poses X_i exp(di), X_j exp(dj)."""
    pred = se3_inverse(xi @ se3_exp(di)) @ (xj @ se3_exp(dj))
    return se3_log(se3_inverse(z) @ pred) * sw


#: the two (6, 6) blocks of every edge's Jacobian at di = dj = 0
_edge_jacobians = torch.func.vmap(
    torch.func.jacfwd(_edge_residual, argnums=(0, 1)), in_dims=(None, None, 0, 0, 0, 0)
)


def _block_outer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-edge a^T b: (E, 6, 6) x (E, 6, 6) -> (E, 6, 6)."""
    return torch.einsum("era,erb->eab", a, b)


def normal_equations(poses, edges_i, edges_j, measurements, sqrt_w):
    """The Gauss-Newton pieces at ``poses``: the weighted residuals
    (E, 6), the edge Jacobian blocks (E, 6, 6) twice and the right-hand
    side -J^T r as (N, 6)."""
    n = poses.shape[0]
    r0 = edge_residuals(poses, edges_i, edges_j, measurements) * sqrt_w
    zero6 = poses.new_zeros(6)
    ji, jj = _edge_jacobians(zero6, zero6, poses[edges_i], poses[edges_j], measurements, sqrt_w)
    rhs = poses.new_zeros((n, 6))
    rhs.index_add_(0, edges_i, -torch.einsum("era,er->ea", ji, r0))
    rhs.index_add_(0, edges_j, -torch.einsum("era,er->ea", jj, r0))
    return r0, ji, jj, rhs


def dense_normal_matrix(n: int, edges_i, edges_j, ji, jj) -> torch.Tensor:
    """J^T J as (N, 6, N, 6) by block scatter-add: block (a, b) of the
    edge's endpoints gets J_a^T J_b for (a, b) in {i, j}^2."""
    jtj = ji.new_zeros((n, 6, n, 6))
    ar = torch.arange(6, device=ji.device)
    rows, cols = ar[None, :, None], ar[None, None, :]
    for a_idx, b_idx, a, b in (
        (edges_i, edges_i, ji, ji), (edges_j, edges_j, jj, jj),
        (edges_i, edges_j, ji, jj), (edges_j, edges_i, jj, ji),
    ):
        jtj.index_put_((a_idx[:, None, None], rows, b_idx[:, None, None], cols),
                       _block_outer(a, b), accumulate=True)
    return jtj


def _dense_step(n, edges_i, edges_j, ji, jj, rhs, damping):
    # gauge: pose 0 fixed, its block row and column dropped. Marquardt
    # damping (lam * diag(A) + lam * I) keeps the smallest eigenvalue in
    # proportion to the matrix's scale, above its rounding noise
    m = (n - 1) * 6
    A = dense_normal_matrix(n, edges_i, edges_j, ji, jj).reshape(n * 6, n * 6)[6:, 6:]
    eye = torch.eye(m, dtype=A.dtype, device=A.device)
    A = A + damping * torch.diag_embed(torch.diagonal(A)) + damping * eye
    L = torch.linalg.cholesky(A)
    return torch.cholesky_solve(rhs.reshape(n * 6)[6:, None], L).reshape(n - 1, 6)


def _project(v: torch.Tensor) -> torch.Tensor:
    """Block row 0 (the gauge pose) set to zero."""
    return torch.cat([torch.zeros_like(v[:1]), v[1:]])


def _cg_step(n, edges_i, edges_j, ji, jj, rhs, damping, cg_iterations):
    # per-pose diagonal blocks; the same Marquardt damping as the dense path
    diag = ji.new_zeros((n, 6, 6))
    diag.index_add_(0, edges_i, _block_outer(ji, ji))
    diag.index_add_(0, edges_j, _block_outer(jj, jj))
    dvec = damping * (torch.diagonal(diag, dim1=-2, dim2=-1) + 1.0)

    def matvec(v):
        v = _project(v)
        u = torch.einsum("eab,eb->ea", ji, v[edges_i]) + torch.einsum("eab,eb->ea", jj, v[edges_j])
        out = torch.zeros_like(v)
        out.index_add_(0, edges_i, torch.einsum("eab,ea->eb", ji, u))
        out.index_add_(0, edges_j, torch.einsum("eab,ea->eb", jj, u))
        return _project(out + dvec * v)

    # block Jacobi: the damped 6x6 diagonal blocks, pose 0's the identity
    diag = diag + torch.diag_embed(dvec)
    diag = torch.cat([torch.eye(6, dtype=diag.dtype, device=diag.device)[None], diag[1:]])
    diag_chol = torch.linalg.cholesky(diag)

    def prec(r):
        return torch.cholesky_solve(_project(r)[..., None], diag_chol)[..., 0]

    return _pcg_solve(matvec, _project(rhs), prec, cg_iterations)[1:]


def optimize_pose_graph(
    poses: torch.Tensor,
    edges_i: torch.Tensor,
    edges_j: torch.Tensor,
    measurements: torch.Tensor,
    weights: torch.Tensor | None = None,
    iterations: int = 10,
    damping: float = 1e-6,
    solver: str = "dense",
    cg_iterations: int = 100,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Damped Gauss-Newton over a pose graph, on the device of ``poses``.

    :param poses: (N, 4, 4) initial absolute poses; pose 0 is held fixed.
    :param edges_i, edges_j: (E,) integer edge endpoints.
    :param measurements: (E, 4, 4) measured relative transforms
        X_i^-1 X_j (odometry steps, loop closures).
    :param weights: optional (E,) per-edge information weights.
    :param solver: ``"dense"`` (Cholesky of the (6N, 6N) normal matrix,
        for up to about a thousand poses) or ``"cg"`` (matrix-free
        block-Jacobi PCG, O(E) memory).
    :param cg_iterations: CG steps per Gauss-Newton iteration (``"cg"``).
    :return: (optimised (N, 4, 4) poses, final mean squared residual),
        the residual unweighted.
    """
    if solver not in ("dense", "cg"):
        raise ValueError(f"unknown solver {solver!r}")
    n = poses.shape[0]
    edges_i = edges_i.to(device=poses.device, dtype=torch.long)
    edges_j = edges_j.to(device=poses.device, dtype=torch.long)
    w = torch.ones(edges_i.shape[0], dtype=poses.dtype, device=poses.device) if weights is None else weights
    sqrt_w = torch.sqrt(w)[:, None]
    cur = poses
    with full_float32(), torch.no_grad():
        for _ in range(iterations):
            _r0, ji, jj, rhs = normal_equations(cur, edges_i, edges_j, measurements, sqrt_w)
            if solver == "dense":
                delta = _dense_step(n, edges_i, edges_j, ji, jj, rhs, damping)
            else:
                delta = _cg_step(n, edges_i, edges_j, ji, jj, rhs, damping, cg_iterations)
            cur = cur @ se3_exp(torch.cat([delta.new_zeros((1, 6)), delta]))
        final_r = edge_residuals(cur, edges_i, edges_j, measurements)
    return cur, torch.mean(final_r**2)


def odometry_edges(n: int, device: str | torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Consecutive-pose chain edges (0-1, 1-2, ...) on ``device``."""
    idx = torch.arange(n - 1, device=device)
    return idx, idx + 1
