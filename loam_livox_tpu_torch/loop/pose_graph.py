"""3-D pose-graph optimisation (reference `Ceres_pose_graph_3d`,
``source/ceres_pose_graph_3d.hpp:198-352``), the counterpart of
``loam_livox_tpu/loop/pose_graph.py``.

Nodes are SE(3) poses, edges measured relative poses; an edge's
residual is the 6-vector

    [ q_a⁻¹(p_b − p_a) − t̂_ab ;  2 · vec(q̂_ab ⊗ (q_a⁻¹ q_b)⁻¹) ]

(reference `PoseGraph3dErrorTerm::operator()`, :216-242); node 0 is held
fixed (:325-331) and the solve is damped Gauss-Newton with a fixed
number of iterations (accept or reject by ``torch.where``, so no host
read).  Three solvers, as in the JAX package:

* `optimize_pose_graph`: the dense (6E, 6N) Jacobian by
  ``torch.func.jacfwd`` (forward mode, as the JAX package's ``jacfwd``)
  and one (6N, 6N) solve an iteration; the loop service's solver;
* `optimize_pose_graph_cg`: per-edge (6, 12) Jacobians
  (``vmap(jacfwd)``) and matrix-free Jacobi-preconditioned CG;
* `optimize_pose_graph_chain`: block-Thomas over the odometry chain and
  a Woodbury update for the loop edges, exact and O(N) an iteration;

and `optimize_pose_graph_sharded`, the CG solve with the edges split
over a product mesh's ranks.

Linear solves go through ``solve_ex`` / ``inv_ex``, which do not read an
error flag on the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from ..core import se3


class PoseGraph(NamedTuple):
    q: torch.Tensor          # (N, 4) wxyz
    t: torch.Tensor          # (N, 3)
    node_mask: torch.Tensor  # (N,) bool
    edge_i: torch.Tensor     # (E,) int64: begin node
    edge_j: torch.Tensor     # (E,) int64: end node
    rel_q: torch.Tensor      # (E, 4) measured q_ab
    rel_t: torch.Tensor      # (E, 3) measured t_ab
    weight_t: torch.Tensor   # (E,) translation weight (square root of the information)
    weight_r: torch.Tensor   # (E,) rotation weight
    edge_mask: torch.Tensor  # (E,) bool


def _residual(qa, ta, qb, tb, rel_q, rel_t, wt, wr):
    """Weighted 6-residuals of edges (batched over a leading axis)."""
    qa_inv = se3.quat_conjugate(qa)
    p_ab = se3.quat_rotate(qa_inv, tb - ta)
    dq = se3.quat_multiply(rel_q, se3.quat_conjugate(se3.quat_multiply(qa_inv, qb)))
    # the sign that keeps the residual continuous near the identity
    dq = torch.where(dq[..., :1] < 0, -dq, dq)
    return torch.cat([(p_ab - rel_t) * wt[..., None], 2.0 * dq[..., 1:] * wr[..., None]],
                     dim=-1)


def edge_residuals(g: PoseGraph, q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(E, 6) weighted residuals, zero on masked edges (reference :216-242)."""
    r = _residual(q[g.edge_i], t[g.edge_i], q[g.edge_j], t[g.edge_j],
                  g.rel_q, g.rel_t, g.weight_t, g.weight_r)
    return torch.where(g.edge_mask[:, None], r, torch.zeros((), device=r.device))


def _apply_delta(q0, t0, d):
    """Left-multiplied rotation and additive translation steps, d (N, 6)."""
    return se3.quat_normalize(se3.quat_multiply(se3.quat_exp(d[:, :3]), q0)), t0 + d[:, 3:]


def _cost(g, q, t):
    r = edge_residuals(g, q, t)
    return 0.5 * (r * r).sum()


def _gn_update(g, q0, t0, lam, cost0, d):
    """Take the step d where it lowers the cost (λ × 0.3), else keep the
    poses (λ × 5)."""
    q_new, t_new = _apply_delta(q0, t0, d)
    cost_new = _cost(g, q_new, t_new)
    accept = cost_new < cost0
    return (torch.where(accept, q_new, q0), torch.where(accept, t_new, t0),
            torch.where(accept, lam * 0.3, lam * 5.0), torch.minimum(cost_new, cost0))


def _start(g):
    return g.q, g.t, torch.full((), 1e-4, device=g.q.device), _cost(g, g.q, g.t)


def optimize_pose_graph(g: PoseGraph, iterations: int = 25):
    """Damped GN with the dense Jacobian, node 0 fixed (reference
    :325-331; ≤ 200 Ceres iterations of SPARSE_NORMAL_CHOLESKY there).
    Returns (q (N, 4), t (N, 3), final cost)."""
    n = g.q.shape[0]
    dev = g.q.device
    fix = torch.arange(6, device=dev)
    eye = torch.eye(n * 6, device=dev)
    q, t, lam, cost = _start(g)
    for _ in range(iterations):
        def res_of_delta(delta, q0=q, t0=t):
            return edge_residuals(g, *_apply_delta(q0, t0, delta.reshape(n, 6))).reshape(-1)

        zero = torch.zeros(n * 6, device=dev)
        J = jacfwd(res_of_delta)(zero)                  # (6E, 6N)
        r = res_of_delta(zero)
        H = J.T @ J
        grad = J.T @ r
        # gauge: node 0's rows and columns become the identity, its gradient 0
        H = H.index_fill(0, fix, 0.0).index_fill(1, fix, 0.0)
        H = H + torch.diag(torch.zeros(n * 6, device=dev).index_fill(0, fix, 1.0))
        grad = grad.index_fill(0, fix, 0.0)
        damped = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye
        delta = torch.linalg.solve_ex(damped, -grad)[0]
        q, t, lam, cost = _gn_update(g, q, t, lam, cost, delta.reshape(n, 6))
    return q, t, cost


def edge_jacobians(g: PoseGraph, q: torch.Tensor, t: torch.Tensor):
    """(J_a, J_b): per-edge (E, 6, 6) Jacobians of the weighted residual
    with respect to the begin and end nodes' tangents (forward mode, one
    small Jacobian an edge under vmap); zero on masked edges."""
    def per_edge(qa, ta, qb, tb, rq, rt, wt, wr):
        def f(d):
            qa_d = se3.quat_multiply(se3.quat_exp(d[0:3]), qa)
            qb_d = se3.quat_multiply(se3.quat_exp(d[6:9]), qb)
            return _residual(qa_d, ta + d[3:6], qb_d, tb + d[9:12], rq, rt, wt, wr)
        return jacfwd(f)(torch.zeros(12, dtype=q.dtype, device=q.device))

    J = vmap(per_edge)(q[g.edge_i], t[g.edge_i], q[g.edge_j], t[g.edge_j],
                       g.rel_q, g.rel_t, g.weight_t, g.weight_r)
    J = torch.where(g.edge_mask[:, None, None], J, torch.zeros((), device=J.device))
    return J[:, :, :6], J[:, :, 6:]


def _gauge_project(x):
    """Zero node 0's tangent (the gauge, reference :325-331)."""
    return torch.cat([torch.zeros_like(x[:1]), x[1:]])


def _node_sum(g, n, a, b):
    """Per-node sums of per-edge rows: ``a`` at the begin nodes, ``b`` at
    the end nodes."""
    out = torch.zeros((n,) + a.shape[1:], dtype=a.dtype, device=a.device)
    return out.index_add(0, g.edge_i, a).index_add(0, g.edge_j, b)


def _assemble_b_diag(g, Ja, Jb, r, n):
    """Gradient Jᵀr (N, 6) and the diagonal of JᵀJ (N, 6)."""
    grad = _node_sum(g, n, torch.einsum("eij,ei->ej", Ja, r), torch.einsum("eij,ei->ej", Jb, r))
    diag = _node_sum(g, n, torch.einsum("eij,eij->ej", Ja, Ja),
                     torch.einsum("eij,eij->ej", Jb, Jb))
    return grad, diag


def _hvp(g, Ja, Jb, x):
    """(JᵀJ)·x without forming H, x (N, 6)."""
    jx = (torch.einsum("eij,ej->ei", Ja, x[g.edge_i])
          + torch.einsum("eij,ej->ei", Jb, x[g.edge_j]))
    return _node_sum(g, x.shape[0], torch.einsum("eij,ei->ej", Ja, jx),
                     torch.einsum("eij,ei->ej", Jb, jx))


def _cg(matvec, b, iters: int, precond):
    """Preconditioned conjugate gradients on the (N, 6) tangent space."""
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = (r * z).sum()
    for _ in range(iters):
        ap = matvec(p)
        alpha = rz / torch.clamp((p * ap).sum(), min=1e-20)
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz_new = (r * z).sum()
        p = z + rz_new / torch.clamp(rz, min=1e-20) * p
        rz = rz_new
    return x


def _node0(x):
    """x on node 0, zero elsewhere."""
    return torch.cat([x[:1], torch.zeros_like(x[1:])])


def optimize_pose_graph_cg(g: PoseGraph, iterations: int = 25, cg_iterations: int = 50):
    """Damped GN with matrix-free CG inner solves: the problem and gauge
    of `optimize_pose_graph` in O(E) memory.  Returns (q, t, cost)."""
    n = g.q.shape[0]
    q, t, lam, cost = _start(g)
    for _ in range(iterations):
        r = edge_residuals(g, q, t)
        Ja, Jb = edge_jacobians(g, q, t)
        grad, diag = _assemble_b_diag(g, Ja, Jb, r, n)
        b = _gauge_project(-grad)
        damp = lam * diag + 1e-9

        def matvec(x, Ja=Ja, Jb=Jb, damp=damp):
            x = _gauge_project(x)
            # the identity block on the fixed node keeps the operator definite
            return _gauge_project(_hvp(g, Ja, Jb, x) + damp * x) + _node0(x)

        pre = _gauge_project(diag + damp) + _node0(torch.ones_like(diag))
        delta = _cg(matvec, b, cg_iterations, lambda x, pre=pre: x / pre)
        q, t, lam, cost = _gn_update(g, q, t, lam, cost, _gauge_project(delta))
    return q, t, cost


def _chain_tridiag_factor(D, O):
    """Block-Thomas factorisation of the SPD block-tridiagonal matrix with
    diagonal blocks D (M, 6, 6) and super-diagonal blocks O (M-1, 6, 6):
    the inverses of the Schur-complement pivots, (M, 6, 6)."""
    s_inv = [torch.linalg.inv_ex(D[0])[0]]
    for d, o_prev in zip(D[1:], O):
        s_inv.append(torch.linalg.inv_ex(d - o_prev.T @ s_inv[-1] @ o_prev)[0])
    return torch.stack(s_inv)


def _chain_tridiag_solve(S_inv, O, b):
    """Solve T x = b with the factorisation; b (M, 6, R)."""
    y = [b[0]]
    for b_i, o_prev, s_prev_inv in zip(b[1:], O, S_inv[:-1]):
        y.append(b_i - o_prev.T @ (s_prev_inv @ y[-1]))
    x = [S_inv[-1] @ y[-1]]
    for y_i, o_i, s_inv_i in zip(reversed(y[:-1]), reversed(O), reversed(S_inv[:-1])):
        x.append(s_inv_i @ (y_i - o_i @ x[-1]))
    return torch.stack(x[::-1])


def optimize_pose_graph_chain(g: PoseGraph, iterations: int = 10):
    """Damped GN with an exact inner solve for graphs built by
    `build_odometry_chain` and `add_loop_edge`: edges 0..N-2 must be the
    consecutive chain; later slots are loop edges (masked slots add
    nothing).  O(N · 6³) an iteration plus a (6K, 6K) solve for K loop
    slots.  Returns (q, t, cost)."""
    n = g.q.shape[0]
    e = g.edge_i.shape[0]
    k = e - (n - 1)          # loop-edge slots
    if k < 0:
        raise ValueError("graph has fewer edges than a full odometry chain")
    dev = g.q.device
    q, t, lam, cost = _start(g)
    for _ in range(iterations):
        r = edge_residuals(g, q, t)
        Ja, Jb = edge_jacobians(g, q, t)
        grad, diag = _assemble_b_diag(g, Ja, Jb, r, n)
        damp = lam * diag + 1e-7

        # chain part over the free nodes 1..N-1 (block f = node - 1)
        ca, cb = Ja[:n - 1], Jb[:n - 1]
        D = torch.einsum("eij,eik->ejk", cb, cb)
        D = torch.cat([D[:n - 2] + torch.einsum("eij,eik->ejk", ca[1:], ca[1:]), D[n - 2:]])
        D = D + torch.diag_embed(damp[1:])
        O = torch.einsum("eij,eik->ejk", ca[1:], cb[1:])
        S_inv = _chain_tridiag_factor(D, O)

        rhs = _gauge_project(-grad)[1:, :, None]
        if k > 0:
            la, lb = Ja[n - 1:], Jb[n - 1:]
            li = g.edge_i[n - 1:] - 1
            lj = g.edge_j[n - 1:] - 1
            # U (N-1, 6, 6K): loop edge s puts J_aᵀ at its begin node and
            # J_bᵀ at its end node in columns 6s..6s+5; the fixed node
            # takes nothing
            U = torch.zeros((n - 1, 6, 6 * k), device=dev)
            cols = torch.arange(k, device=dev)[:, None, None] * 6 + torch.arange(6, device=dev)
            rows = torch.arange(6, device=dev)[None, :, None]
            va = torch.where((li >= 0)[:, None, None], la.transpose(1, 2), 0.0)
            vb = torch.where((lj >= 0)[:, None, None], lb.transpose(1, 2), 0.0)
            U = U.index_put((torch.clamp(li, min=0)[:, None, None].expand(k, 6, 6),
                             rows.expand(k, 6, 6), cols.expand(k, 6, 6)), va, accumulate=True)
            U = U.index_put((torch.clamp(lj, min=0)[:, None, None].expand(k, 6, 6),
                             rows.expand(k, 6, 6), cols.expand(k, 6, 6)), vb, accumulate=True)
            sol = _chain_tridiag_solve(S_inv, O, torch.cat([rhs, U], dim=-1))
            Tb, TU = sol[:, :, 0], sol[:, :, 1:]
            # capacitance I + Uᵀ T⁻¹ U, (6K, 6K)
            C = torch.eye(6 * k, device=dev) + torch.einsum("nir,nis->rs", U, TU)
            w = torch.linalg.solve_ex(C, torch.einsum("nir,ni->r", U, Tb))[0]
            x = Tb - torch.einsum("nir,r->ni", TU, w)
        else:
            x = _chain_tridiag_solve(S_inv, O, rhs)[:, :, 0]
        d = torch.cat([torch.zeros((1, 6), device=dev), x])
        q, t, lam, cost = _gn_update(g, q, t, lam, cost, d)
    return q, t, cost


def optimize_pose_graph_sharded(g: PoseGraph, mesh, iterations: int = 25,
                                cg_iterations: int = 50):
    """`optimize_pose_graph_cg` with the edge set split over a product
    mesh's ranks (`parallel.mesh.Mesh`): each rank holds E/size edges
    and their Jacobian blocks and builds partial gradients, diagonals,
    Hessian-vector products and costs; the node-space results are summed
    over the group (one (N, 6) vector a CG step).  Poses replicate.  The
    edge count must divide by the world size (pad with masked edges).
    Equal to `optimize_pose_graph_cg` up to the order of the sums."""
    import torch.distributed as dist

    from ..parallel.sharded import shard_rows

    def psum(x):
        dist.all_reduce(x)
        return x

    rows = shard_rows(g.edge_i.shape[0], mesh)
    gl = g._replace(node_mask=torch.ones_like(g.node_mask), edge_i=g.edge_i[rows],
                    edge_j=g.edge_j[rows], rel_q=g.rel_q[rows], rel_t=g.rel_t[rows],
                    weight_t=g.weight_t[rows], weight_r=g.weight_r[rows],
                    edge_mask=g.edge_mask[rows])
    n = g.q.shape[0]

    def cost(q, t):
        r = edge_residuals(gl, q, t)
        return 0.5 * psum((r * r).sum())

    q, t, lam = g.q, g.t, torch.full((), 1e-4, device=g.q.device)
    cost0 = cost(q, t)
    for _ in range(iterations):
        r = edge_residuals(gl, q, t)
        Ja, Jb = edge_jacobians(gl, q, t)
        grad, diag = _assemble_b_diag(gl, Ja, Jb, r, n)
        grad, diag = psum(grad), psum(diag)
        b = _gauge_project(-grad)
        damp = lam * diag + 1e-9

        def matvec(x, Ja=Ja, Jb=Jb, damp=damp):
            x = _gauge_project(x)
            return _gauge_project(psum(_hvp(gl, Ja, Jb, x)) + damp * x) + _node0(x)

        pre = _gauge_project(diag + damp) + _node0(torch.ones_like(diag))
        d = _gauge_project(_cg(matvec, b, cg_iterations, lambda x, pre=pre: x / pre))
        q_new, t_new = _apply_delta(q, t, d)
        cost_new = cost(q_new, t_new)
        accept = cost_new < cost0
        q, t = torch.where(accept, q_new, q), torch.where(accept, t_new, t)
        lam = torch.where(accept, lam * 0.3, lam * 5.0)
        cost0 = torch.minimum(cost_new, cost0)
    return q, t, cost0


def build_odometry_chain(qs: torch.Tensor, ts: torch.Tensor, weight_t: float = 1.0,
                         weight_r: float = 1.0, capacity_edges: int | None = None
                         ) -> PoseGraph:
    """A graph whose edges are the consecutive relative poses of a pose
    sequence (reference scene_alignment.hpp:97-129), padded with masked
    edges to ``capacity_edges``."""
    n = qs.shape[0]
    e = n - 1
    cap = capacity_edges or e
    dev = qs.device
    qa_inv = se3.quat_conjugate(qs[:-1])
    rel_q = se3.quat_multiply(qa_inv, qs[1:])
    rel_t = se3.quat_rotate(qa_inv, ts[1:] - ts[:-1])

    def pad(a, fill=0):
        return torch.cat([a, torch.full((cap - e,) + a.shape[1:], fill, dtype=a.dtype,
                                        device=dev)])

    return PoseGraph(
        q=qs, t=ts, node_mask=torch.ones((n,), dtype=torch.bool, device=dev),
        edge_i=pad(torch.arange(e, device=dev)),
        edge_j=pad(torch.arange(1, e + 1, device=dev)),
        rel_q=pad(rel_q), rel_t=pad(rel_t),
        weight_t=pad(torch.full((e,), weight_t, device=dev)),
        weight_r=pad(torch.full((e,), weight_r, device=dev)),
        edge_mask=pad(torch.ones((e,), dtype=torch.bool, device=dev)))


def add_loop_edge(g: PoseGraph, slot: int, i: int, j: int, rel_q, rel_t,
                  weight_t: float = 1.0, weight_r: float = 1.0) -> PoseGraph:
    """Write a loop-closure constraint into edge slot ``slot``."""
    def put(a, value):
        # a select, not an item write: writing a host scalar into a CUDA
        # tensor copies it through the host
        sel = torch.arange(a.shape[0], device=a.device) == slot
        return torch.where(sel.reshape((-1,) + (1,) * (a.dim() - 1)), value, a)

    return g._replace(edge_i=put(g.edge_i, i), edge_j=put(g.edge_j, j),
                      rel_q=put(g.rel_q, rel_q), rel_t=put(g.rel_t, rel_t),
                      weight_t=put(g.weight_t, weight_t), weight_r=put(g.weight_r, weight_r),
                      edge_mask=put(g.edge_mask, True))
