"""Essential-graph Sim(3) pose-graph optimisation.

Port of swarmmap_tpu/ops/pose_graph.py (reference spec:
Optimizer::OptimizeEssentialGraph, Optimizer.cc:743+ — g2o over one Sim3
vertex per keyframe with loop, spanning-tree and strong-covisibility
edges, identity information matrices, the loop keyframe fixed).

The graph is solved by damped Gauss-Newton: the per-edge 7x14 Jacobians
of the edge residual e = log(S_ji S_iw S_wj) are closed forms (the
inverse left Jacobian of sim(3) at e and two adjoints) where the JAX
package takes `vmap(jacfwd)`: torch's forward-mode AD runs Python
decompositions for scalar arithmetic, `where` and `solve_ex`, and costs
seconds on its first call.  They are assembled into one dense [7N, 7N]
system and solved with `solve_ex`.  The JAX package assembles with `.at[].add`; float atomics
would make two card runs differ, so the blocks are summed through one
presorted plan per call (`ba.segments`, as the BA's `segment_plan`): the
same bits on every run.  The steps run with no host sync.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import lie
from .ba import _segment_sum, segments


class Sim3Nodes(NamedTuple):
    R: torch.Tensor  # [N,3,3] world->node (Siw convention, like the reference)
    t: torch.Tensor  # [N,3]
    s: torch.Tensor  # [N]


def _edge_residual(Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
    """e = log(S_ji S_iw S_jw^-1) over any leading dims, and that product
    E = (R, t, s); measurement S_ji = (Rm, tm, sm)."""
    E = lie.sim3_mul(*lie.sim3_mul(Rm, tm, sm, Ri, ti, si), *lie.sim3_inv(Rj, tj, sj))
    return lie.sim3_log(*E), E


def _edges_r_and_j(Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
    """Every edge's residual [E,7] and its Jacobian [E,7,14] in the left
    perturbations of its two nodes, S_i <- exp(xi_i) S_i: with
    log(exp(a) E) = e + J^-1(e) a and S exp(xi) S^-1 = exp(Ad(S) xi),
    de/dxi_i = J^-1(e) Ad(S_ji) and de/dxi_j = -J^-1(e) Ad(E) (the JAX
    package differentiates the same residual with jacfwd;
    tests/test_torch_sim3.py holds the two together)."""
    e, E = _edge_residual(Ri, ti, si, Rj, tj, sj, Rm, tm, sm)
    Jinv = lie.sim3_left_jacobian_inv(e)
    return e, torch.cat([Jinv @ lie.sim3_adjoint(Rm, tm, sm),
                         -(Jinv @ lie.sim3_adjoint(*E))], -1)


class _Assembly(NamedTuple):
    """The normal equations' plan: the 4 blocks of every valid edge go to
    their unique (row node, column node) block, the 2 gradient pieces to
    their node."""
    blocks: object       # ba.Segments over the unique block keys
    block_keys: torch.Tensor   # [U] row * n + col of each unique block
    grad: object         # ba.Segments over the nodes


def _assembly(edge_i, edge_j, edge_valid, n: int) -> _Assembly:
    ei, ej = edge_i.cpu().numpy().astype(np.int64), edge_j.cpu().numpy().astype(np.int64)
    n_e = len(ei)
    rows = np.flatnonzero(edge_valid.cpu().numpy())
    rows4 = np.concatenate([rows + q * n_e for q in range(4)])
    keys = np.concatenate([ei * n + ei, ej * n + ej, ei * n + ej, ej * n + ei])
    uniq, inv = np.unique(keys[rows4], return_inverse=True)
    slot = np.zeros(4 * n_e, np.int64)
    slot[rows4] = inv
    dev = edge_i.device
    rows2 = np.concatenate([rows, rows + n_e])
    return _Assembly(segments(slot, rows4, len(uniq), dev),
                     torch.from_numpy(uniq).to(dev),
                     segments(np.concatenate([ei, ej]), rows2, n, dev))


def optimize_pose_graph(
    nodes: Sim3Nodes,
    edge_i: torch.Tensor,        # [E] int
    edge_j: torch.Tensor,        # [E] int
    meas_R: torch.Tensor,        # [E,3,3]  S_ji measurements
    meas_t: torch.Tensor,        # [E,3]
    meas_s: torch.Tensor,        # [E]
    edge_valid: torch.Tensor,    # [E] bool
    node_fixed: torch.Tensor,    # [N] bool
    node_valid: torch.Tensor,    # [N] bool
    iters: int = 20,
    fix_scale: bool = False,
) -> Sim3Nodes:
    """`iters` damped Gauss-Newton steps over the graph; a step is kept
    where it lowers the summed squared edge residual (lambda x0.5), else
    dropped (lambda x8).  Fixed and invalid nodes are anchored."""
    R, t, s = nodes
    n = R.shape[0]
    dtype, dev = R.dtype, R.device
    ei, ej = edge_i.long(), edge_j.long()
    plan = _assembly(ei, ej, edge_valid, n)
    w = edge_valid.to(dtype)
    anchored = node_fixed | ~node_valid
    eye7 = torch.eye(7, dtype=dtype, device=dev)
    ar = torch.arange(n, device=dev)
    keep = (~anchored).to(dtype)[:, None]
    if fix_scale:
        keep = keep * (1.0 - eye7[6])
    lam = torch.tensor(1e-6, dtype=dtype, device=dev)

    def total_cost(Rc, tc, sc):
        rr, _ = _edge_residual(Rc[ei], tc[ei], sc[ei], Rc[ej], tc[ej], sc[ej],
                               meas_R, meas_t, meas_s)
        return torch.sum(torch.sum(rr * rr, 1) * w)

    for _ in range(iters):
        r, J = _edges_r_and_j(R[ei], t[ei], s[ei], R[ej], t[ej], s[ej],
                              meas_R, meas_t, meas_s)              # [E,7], [E,7,14]
        Ji, Jj = J[:, :, :7], J[:, :, 7:]
        Hij = torch.einsum("eki,ekj->eij", Ji, Jj)
        blocks = torch.cat([torch.einsum("eki,ekj->eij", Ji, Ji),
                            torch.einsum("eki,ekj->eij", Jj, Jj),
                            Hij, Hij.transpose(1, 2)], 0)          # [4E,7,7]
        Hb = torch.zeros(n * n, 7, 7, dtype=dtype, device=dev)
        Hb.index_copy_(0, plan.block_keys, _segment_sum(blocks, plan.blocks))
        Hb = Hb.view(n, n, 7, 7)
        # anchor fixed / invalid nodes
        Hb[ar, ar] = Hb[ar, ar] + torch.where(anchored[:, None, None], 1e8 * eye7, lam * eye7)
        if fix_scale:
            # heavily damp all scale dofs
            Hb[ar, ar, 6, 6] = Hb[ar, ar, 6, 6] + 1e8
        grad = -torch.cat([torch.einsum("eki,ek->ei", Ji, r),
                           torch.einsum("eki,ek->ei", Jj, r)], 0)  # [2E,7]
        b = _segment_sum(grad, plan.grad)
        H = Hb.permute(0, 2, 1, 3).reshape(7 * n, 7 * n)
        dx = torch.linalg.solve_ex(H, b.reshape(-1))[0].reshape(n, 7) * keep
        dR, dt, ds = lie.sim3_exp(dx)
        R2, t2, s2 = lie.sim3_mul(dR, dt, ds, R, t, s)
        ok = total_cost(R2, t2, s2) < total_cost(R, t, s)
        R = torch.where(ok, R2, R)
        t = torch.where(ok, t2, t)
        s = torch.where(ok, s2, s)
        lam = torch.clamp(torch.where(ok, lam * 0.5, lam * 8.0), 1e-10, 1e6)
    return Sim3Nodes(R=R, t=t, s=s)
