"""Sequential-impulse rigid-body contact solver (port of the JAX ``core/contact.py``).

The reference resolves every contact regime (resting, impact, sliding with
friction, tumbling, drone-drone bumps) with Bullet's velocity-level solver
inside ``p.stepSimulation`` (BaseAviary.py:370). This is the replacement the
``contact_mode="impulse"`` configs select:

* contacts are detected on the pre-integration pose, impulses act on the
  force-integrated velocities, and positions integrate afterwards
  (``core/dynamics.substep_pyb``);
* a separated contact (d > 0, within the breaking distance) allows at most
  d/dt of approach speed (speculative contact); a penetrating one gets the
  Baumgarte bias erp*pen/dt beyond the slop;
* restitution 0, Coulomb friction box-clamped per tangent against
  mu * lambda_n, friction rows after all normal rows in each Gauss-Seidel
  iteration; mu_plane = 0.5, mu_pair = 0.25 (Bullet's multiplicative combine).

The collision cylinder is sampled at ``RIM_SAMPLES`` points per rim for the
plane; drones and obstacles are spheres of radius ``collision_r``.

Pair rows come in three regimes, as in the JAX package:

* N <= ``PAIR_GS_MAX_N``: the exact Bullet-order sweep over the upper
  triangle of pairs, with any leading batch axes;
* larger fleets of one world, or of independent envs (``env_batched``: the
  leading axes are envs, each a fleet of its own, as the JAX package's
  vmapped env step sees them): each drone's ``NBR_K`` nearest candidates,
  swept as K slot-coloured sub-passes a sweep, a pair owned by its smaller
  index. Candidates come from the dense build up to ``NBR_MAX_N`` and from
  the spatial hash grid above it;
* otherwise (a leading batch axis that is not an env axis, or the partners
  ``other_pos``): the normal-only Jacobi pass.

The Gauss-Seidel sweeps are Python loops over the contact axis in the JAX
scan's order; all drones and envs advance together at each contact. The
solver works on its own copies of the velocities and updates them in place.
A partner pushed by several owners in one sub-pass takes their impulses in
owner order on the CPU and on the card alike (``_scatter_add``), so a run
repeats itself bit for bit. Norms are ``sqrt(sum(x*x))`` in a fixed order
(``norm3``).
"""

import numpy as np
import torch

from gym_pybullet_drones_tpu_torch.core.collisions import obstacle_delta
from gym_pybullet_drones_tpu_torch.core.rotations import norm3, quat_to_matrix

# Solver constants (Bullet defaults).
N_ITER = 10          # btContactSolverInfo::m_numIterations
ERP = 0.2            # contact ERP (m_erp2)
SLOP = 0.001         # linear slop: penetration allowance before correction
BREAKING = 0.02      # gContactBreakingThreshold: contact generation distance
MU_PLANE = 0.5       # 1.0 (plane.urdf) x 0.5 (drone URDF default)
MU_PAIR = 0.25       # 0.5 x 0.5
RIM_SAMPLES = 8      # cylinder rim sample points per rim (x2 rims)
PAIR_GS_MAX_N = 16   # fleets above this use the neighbor-compacted rows
NBR_K = 8            # candidate partners per drone in neighbor pair mode
NBR_MAX_N = 16384    # above this the dense candidate build (an N x N distance
                     # matrix) gives way to the hash grid


def _cross(a, b):
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def _dot(a, b):
    """a . b over the trailing axis, keeping it (size 1)."""
    return (a * b).sum(-1, keepdim=True)


def _scatter_add(x, index, src):
    """``x[index[i]] += src[i]`` in the order of i. On the CPU ``index_add_``
    adds in that order (``index_put_`` may not, past its parallel grain); on
    the card ``index_add_`` adds by atomics in any order, and ``index_put_``
    with ``accumulate`` sorts the indices stably and adds each run in order."""
    if x.is_cuda:
        x.index_put_((index,), src, accumulate=True)
    else:
        x.index_add_(0, index, src)


def _matvec(M, v):
    """M @ v for (..., 3, 3) matrices and (..., 3) vectors."""
    return (M * v[..., None, :]).sum(-1)


def _world_inv_inertia(R, J_inv):
    """I_w^-1 = R J^-1 R^T for (..., N, 3, 3) rotations."""
    RJ = (R[..., :, :, None] * J_inv).sum(-2)
    return (RJ[..., :, None, :] * R[..., None, :, :]).sum(-1)


def _target_vn(d, dt, erp, slop):
    """Per-contact normal-velocity target (Bullet setupContactConstraint):
    separated (d_eff > 0), approach up to the gap per step; penetrating, the
    Baumgarte separating bias erp*pen/dt."""
    d_eff = d + slop
    return torch.where(d_eff > 0.0, -d_eff / dt, -erp * d_eff / dt)


def _plane_rim_points(params, dtype):
    """(2*RIM_SAMPLES, 3) body-frame sample points on the collision-cylinder
    rims (bottom rim at z_off - h/2, top rim at z_off + h/2). The angles are
    float64 numpy, cast afterwards, as in the JAX package."""
    th = 2.0 * np.pi * np.arange(RIM_SAMPLES) / RIM_SAMPLES
    device = params.collision_r.device
    unit = torch.as_tensor(np.stack([np.cos(th), np.sin(th)], -1), dtype=dtype, device=device)
    xy = unit * params.collision_r
    rims = []
    for s in (-1.0, 1.0):
        z = (params.collision_z_offset + s * params.collision_h / 2.0).to(dtype)
        rims.append(torch.cat([xy, z.expand(RIM_SAMPLES, 1)], -1))
    return torch.cat(rims, 0)  # (C, 3)


def _selection_band(radius, breaking, margin):
    return 2.0 * radius + breaking + margin


def build_pair_candidates(pos, radius, k=NBR_K, margin=0.05, breaking=BREAKING):
    """Per-drone K-nearest candidate partners for the neighbor pair rows:
    ``(idx (..., N, K) int64, in_band (..., N, K) bool)``, leading axes envs.

    Built from one pose and reused across the substeps of a control period:
    ``margin`` extends the selection band beyond the contact distance
    (2r + breaking), so pairs that close in during the period are already in
    the set. Candidates are in ascending build-time distance, exact ties by
    the lower drone index (a stable sort, the order of ``lax.top_k``). The
    squared distances are summed one component at a time, so the build holds
    (..., N, N) values and the sort's output, no (N, N, 3) differences."""
    n = pos.shape[-2]
    k = min(k, n - 1)
    d2 = None
    for axis in range(3):
        comp = pos[..., axis]
        term = (comp[..., :, None] - comp[..., None, :]).square_()
        d2 = term if d2 is None else d2.add_(term)
        del term
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    d2.masked_fill_(eye, float("inf"))
    srt, order = torch.sort(d2, dim=-1, stable=True)
    del d2
    dist = torch.sqrt(torch.clamp_min(srt[..., :k], 0.0))
    return order[..., :k].contiguous(), dist < _selection_band(radius, breaking, margin)


def build_pair_candidates_binned(pos, radius, k=NBR_K, margin=0.05, breaking=BREAKING,
                                 cap=16, table_mult=2):
    """The O(N*k) replacement for :func:`build_pair_candidates` at swarm scale
    (one world, ``pos`` (N, 3)): the same contract, from a spatial hash grid.

    The cell edge equals the selection band, so every in-band partner lies in
    the 27-cell neighborhood; candidates beyond the band may differ from the
    dense build's, but those rows are inert in the solver, so the solve is
    the same bit for bit whenever no bucket overflows. Each of the
    ``table_mult * N`` (a power of two) buckets holds ``cap`` drones; an
    overflowed drone stops being found as a partner (its own rows still
    solve). The hashes are int32 and wrap as the JAX package's do; the table
    is built by a stable sort of the bucket ids, so a bucket's slots, and
    through them the order of exact distance ties, are the JAX package's.
    """
    n = pos.shape[0]
    k = min(k, n - 1)
    device = pos.device
    if k <= 0:
        return (torch.zeros((n, 0), dtype=torch.long, device=device),
                torch.zeros((n, 0), dtype=torch.bool, device=device))
    band = _selection_band(radius, breaking, margin)
    cells = torch.floor(pos / band).to(torch.int32)  # (N, 3)
    n_buckets = max(64, 1 << int(np.ceil(np.log2(max(table_mult * n, 2)))))
    mask = n_buckets - 1
    primes = (73856093, 19349663, 83492791)
    hx, hy, hz = (cells[:, a] * primes[a] for a in range(3))

    # Build: sort by bucket, rank within the bucket's run, scatter ids into
    # bucket*cap + rank slots (rank >= cap drops into a spill slot no query reads).
    hb = (hx ^ hy ^ hz) & mask
    order = torch.argsort(hb, stable=True)
    hs = hb[order]
    rank = (torch.arange(n, dtype=torch.int32, device=device)
            - torch.searchsorted(hs, hs, side="left").to(torch.int32))
    slot = torch.where(rank < cap, hs * cap + rank,
                       torch.full_like(rank, n_buckets * cap)).long()
    table = torch.full((n_buckets * cap + 1,), -1, dtype=torch.long, device=device)
    table[slot] = order

    # Query: 27 neighbor cells -> buckets, a repeated bucket id in the stencil
    # read once (it would duplicate pair rows) -> cap ids each -> distances ->
    # the k nearest in ascending order. Everything stays (N, M).
    qb = torch.stack([(hx + dx * primes[0]) ^ (hy + dy * primes[1]) ^ (hz + dz * primes[2])
                      for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
                     dim=1) & mask  # (N, 27)
    ar = torch.arange(27, device=device)
    dup = ((qb[:, :, None] == qb[:, None, :])
           & (ar[None, :, None] > ar[None, None, :])).any(-1)  # (N, 27)
    slots = (torch.repeat_interleave(qb, cap, dim=1).long() * cap
             + torch.arange(cap, device=device).repeat(27)[None, :])
    cand = torch.where(torch.repeat_interleave(dup, cap, dim=1),
                       torch.full_like(slots, -1), table[slots])
    safe = torch.clamp_min(cand, 0)  # (N, M)
    d2 = torch.zeros(cand.shape, dtype=pos.dtype, device=device)
    for axis in range(3):
        comp = pos[:, axis]
        d2 = d2 + (comp[:, None] - comp[safe]) ** 2
    bad = (cand < 0) | (cand == torch.arange(n, device=device)[:, None])
    d2 = d2.masked_fill(bad, float("inf"))
    srt, sel = torch.sort(d2, dim=1, stable=True)
    idx = torch.clamp_min(torch.gather(cand, 1, sel[:, :k]), 0)
    dist = torch.sqrt(torch.clamp_min(srt[:, :k], 0.0))
    return idx, dist < band


def _orthonormal_tangents(n):
    """Two unit tangents orthogonal to n (..., 3); robust near n = ±z."""
    ez = n.new_tensor([0.0, 0.0, 1.0])
    ex = n.new_tensor([1.0, 0.0, 0.0])
    ref = torch.where(torch.abs(n[..., 2:3]) < 0.9, ez, ex)
    t1 = _cross(n, ref)
    t1 = t1 / torch.clamp_min(norm3(t1, keepdim=True), 1e-9)
    return t1, _cross(n, t1)


def _zeros(n, shape, like):
    return [torch.zeros(shape, dtype=like.dtype, device=like.device) for _ in range(n)]


def _row_terms(r, axis, I_inv_w, inv_m):
    """The velocity read-out and the impulse response of a row along ``axis``
    at lever arm ``r`` on one body, in the (v, w) state of six: the row's
    point velocity along the axis is ``S . H`` and an impulse a changes S by
    ``a * G``; also ``r x axis . I^-1 (r x axis)`` for the effective mass."""
    rx = _cross(r, axis)
    J = _matvec(I_inv_w, rx)
    H = torch.cat([axis.expand(rx.shape), rx], -1)
    G = torch.cat([axis.expand(rx.shape) * inv_m, J], -1)
    return H, G, _dot(rx, J)


class _BodyRows:
    """Rows between a drone and the static world, every drone (and env) at
    once per contact: the plane's rim samples or the obstacles. ``r``, the
    axes: (..., N, C, 3); ``d``: (..., N, C) separations."""

    def __init__(self, r, axes, d, I_inv_w, inv_m, dt, erp, slop, breaking, mu):
        act = (d < breaking).to(d.dtype)[..., None]
        tgt = _target_vn(d, dt, erp, slop)[..., None]
        Iw = I_inv_w[..., None, :, :]
        rows = {}
        for q, axis in axes.items():
            H, G, rJr = _row_terms(r, axis, Iw, inv_m)
            # (x * k) * act == x * (k * act) for act in {0, 1}
            kact = (1.0 / (inv_m + rJr)) * act
            rows[q] = (H, G, kact if q == "n" else -kact)
        self.mu = mu
        self.rows = [dict(tgt=tgt[..., c, :],
                          **{q: tuple(x[..., c, :] for x in rows[q]) for q in rows})
                     for c in range(d.shape[-1])]
        self.lam = {q: _zeros(len(self.rows), d.shape[:-1] + (1,), d) for q in axes}

    # S advances out of place (one kernel, as in place): torch.func.vmap, which
    # steps domain-randomized envs, has no batching rule for addcmul_.
    def normal(self, S):
        lams = self.lam["n"]
        for c, p in enumerate(self.rows):
            H, G, kact = p["n"]
            new = torch.clamp_min(torch.addcmul(lams[c], p["tgt"] - _dot(S, H), kact), 0.0)
            S = torch.addcmul(S, new - lams[c], G)
            lams[c] = new
        return S

    def friction(self, S):
        for c, p in enumerate(self.rows):
            limit = self.mu * self.lam["n"][c]
            neg = -limit
            for q in ("t1", "t2"):  # t2 re-reads the slip after t1's impulse
                H, G, nkact = p[q]
                lams = self.lam[q]
                new = torch.clamp(torch.addcmul(lams[c], _dot(S, H), nkact), min=neg, max=limit)
                S = torch.addcmul(S, new - lams[c], G)
                lams[c] = new
        return S


def _plane_rows(pos, R, I_inv_w, inv_m, params, dt, erp, slop, breaking, mu):
    """Cylinder rim samples against z = 0; normal z, tangents x then y."""
    pts = _plane_rim_points(params, pos.dtype)
    r = (R[..., None, :, :] * pts[:, None, :]).sum(-1)  # lever arms (..., N, C, 3)
    d = pos[..., 2][..., None] + r[..., 2]  # point height above the plane
    eye = torch.eye(3, dtype=pos.dtype, device=pos.device)
    axes = dict(n=eye[2], t1=eye[0], t2=eye[1])
    return _BodyRows(r, axes, d, I_inv_w, inv_m, dt, erp, slop, breaking, mu)


def _obstacle_rows(pos, I_inv_w, inv_m, radius, obstacles, dt, erp, slop, breaking, mu):
    """Drone spheres against static boxes and spheres (``ObstacleSet``). The
    normal runs from the closest point of the obstacle's core to the drone
    center; a center inside a box core takes the center direction at full
    depth (``obstacle_delta``)."""
    delta, inside = obstacle_delta(pos, obstacles)  # (..., N, M, 3)
    raw = norm3(delta)
    dist = torch.where(inside, torch.zeros_like(raw), raw)
    nrm = delta / torch.clamp_min(raw, 1e-9)[..., None]
    d = dist - (radius + obstacles.radius)
    t1, t2 = _orthonormal_tangents(nrm)
    r = -radius * nrm  # contact point on the drone sphere
    return _BodyRows(r, dict(n=nrm, t1=t1, t2=t2), d, I_inv_w, inv_m, dt, erp, slop,
                     breaking, mu)


def _pair_terms(delta, dist, Ii, Ij, inv_m, radius, dt, erp, slop, breaking):
    """Row terms of drone pairs (i, j) with ``delta = c_i - c_j``: the contact
    at the midpoint, normal toward i. Returns (rows by axis, tgt, d)."""
    nrm = delta / torch.clamp_min(dist, 1e-9)[..., None]
    d = dist - 2.0 * radius
    tgt = _target_vn(d, dt, erp, slop)[..., None]
    r_i, r_j = -0.5 * delta, 0.5 * delta  # midpoint - c_i, midpoint - c_j
    t1, t2 = _orthonormal_tangents(nrm)
    rows = {}
    for q, axis in (("n", nrm), ("t1", t1), ("t2", t2)):
        Hi, Gi, ki = _row_terms(r_i, axis, Ii, inv_m)
        Hj, Gj, kj = _row_terms(r_j, axis, Ij, inv_m)
        rows[q] = (Hi, Gi, Hj, Gj, 1.0 / (2.0 * inv_m + ki + kj))
    return rows, tgt, d


class _ExactPairRows:
    """The exact Bullet-order sweep over the upper triangle of drone pairs
    (N <= PAIR_GS_MAX_N), any leading batch axes."""

    def __init__(self, pos, I_inv_w, inv_m, radius, dt, erp, slop, breaking, mu):
        iu = np.triu_indices(pos.shape[-2], k=1)
        pi = torch.as_tensor(iu[0], device=pos.device)
        pj = torch.as_tensor(iu[1], device=pos.device)
        ci, cj = pos.index_select(-2, pi), pos.index_select(-2, pj)
        delta = ci - cj
        rows, tgt, d = _pair_terms(delta, norm3(delta), I_inv_w.index_select(-3, pi),
                                   I_inv_w.index_select(-3, pj), inv_m, radius, dt, erp,
                                   slop, breaking)
        act = (d < breaking).to(d.dtype)[..., None]
        self.mu = mu
        self.rows = []
        for p in range(len(iu[0])):
            row = dict(i=int(iu[0][p]), j=int(iu[1][p]), tgt=tgt[..., p, :])
            for q, (Hi, Gi, Hj, Gj, k) in rows.items():
                kact = k[..., p, :] * act[..., p, :]
                row[q] = (Hi[..., p, :], Gi[..., p, :], Hj[..., p, :], Gj[..., p, :],
                          kact if q == "n" else -kact)
            self.rows.append(row)
        self.lam = {q: _zeros(len(self.rows), d.shape[:-1] + (1,), d) for q in rows}

    def _solve(self, drones, p, q, lams, c, lo=None, hi=None):
        Hi, Gi, Hj, Gj, kact = p[q]
        i, j = p["i"], p["j"]
        u = _dot(drones[i], Hi) - _dot(drones[j], Hj)
        if lo is None:
            new = torch.clamp_min(torch.addcmul(lams[c], p["tgt"] - u, kact), 0.0)
        else:
            new = torch.clamp(torch.addcmul(lams[c], u, kact), min=lo, max=hi)
        a = new - lams[c]
        drones[i] = torch.addcmul(drones[i], a, Gi)
        drones[j] = torch.addcmul(drones[j], a, Gj, value=-1.0)
        lams[c] = new

    # A sweep advances each drone's (..., 6) slice of S out of place (one
    # kernel, as in place: torch.func.vmap has no batching rule for
    # addcmul_) and stacks them back once.
    def normal(self, S):
        drones = list(S.unbind(-2))
        for c, p in enumerate(self.rows):
            self._solve(drones, p, "n", self.lam["n"], c)
        return torch.stack(drones, -2)

    def friction(self, S):
        drones = list(S.unbind(-2))
        for c, p in enumerate(self.rows):
            limit = self.mu * self.lam["n"][c]
            neg = -limit
            for q in ("t1", "t2"):
                self._solve(drones, p, q, self.lam[q], c, neg, limit)
        return torch.stack(drones, -2)


class _NeighborRows:
    """Neighbor-compacted pair rows: each drone's K candidates, swept as K
    slot-coloured sub-passes. Sub-pass k solves every drone's k-th row at once
    from the freshest velocities; a contacting pair is owned by its smaller
    index. Leading axes are envs: drones are addressed in one flat (E*N)
    index space, a partner at its env's offset."""

    def __init__(self, pos, I_inv_w, inv_m, radius, dt, erp, slop, breaking, mu,
                 candidates):
        n = pos.shape[-2]
        idx = candidates.reshape(-1, n, candidates.shape[-1]).long()
        n_env, K = idx.shape[0], idx.shape[-1]
        flat = n_env * n
        off = (torch.arange(n_env, device=pos.device) * n)[:, None, None]
        jf = (idx + off).reshape(flat, K)
        pos_f = pos.reshape(flat, 3)
        I_f = I_inv_w.reshape(flat, 3, 3)
        delta = pos_f[:, None, :] - pos_f[jf]  # (F, K, 3): c_i - c_j
        dist = torch.sqrt(torch.clamp_min(_dot(delta, delta)[..., 0], 0.0))
        rows, tgt, d = _pair_terms(delta, dist, I_f[:, None, :, :], I_f[jf], inv_m, radius,
                                   dt, erp, slop, breaking)
        i_col = torch.arange(n, device=pos.device).repeat(n_env)[:, None]
        act = ((idx.reshape(flat, K) > i_col) & (d < breaking)).to(d.dtype)[..., None]
        self.mu, self.flat = mu, flat
        self.rows = []
        for s in range(K):
            row = dict(jk=jf[:, s], tgt=tgt[:, s])
            for q, (Hi, Gi, Hj, Gj, k) in rows.items():
                kact = k[:, s] * act[:, s]
                # the partner's share enters as -a * Gj
                row[q] = (Hi[:, s], Gi[:, s], Hj[:, s], -Gj[:, s],
                          kact if q == "n" else -kact)
            self.rows.append(row)
        self.lam = {q: _zeros(K, (flat, 1), d) for q in rows}

    def _solve(self, S, p, q, lams, s, lo=None, hi=None):
        Hi, Gi, Hj, nGj, kact = p[q]
        jk = p["jk"]
        u = _dot(S, Hi) - _dot(S[jk], Hj)
        if lo is None:
            new = torch.clamp_min(torch.addcmul(lams[s], p["tgt"] - u, kact), 0.0)
        else:
            new = torch.clamp(torch.addcmul(lams[s], u, kact), min=lo, max=hi)
        a = new - lams[s]
        S.addcmul_(a, Gi)
        _scatter_add(S, jk, a * nGj)
        lams[s] = new

    def normal(self, S):
        flat = S.view(self.flat, 6)
        for s, p in enumerate(self.rows):
            self._solve(flat, p, "n", self.lam["n"], s)
        return S

    def friction(self, S):
        flat = S.view(self.flat, 6)
        for s, p in enumerate(self.rows):
            limit = self.mu * self.lam["n"][s]
            neg = -limit
            for q in ("t1", "t2"):
                self._solve(flat, p, q, self.lam[q], s, neg, limit)
        return S


class _JacobiPairRows:
    """The normal-only Jacobi pass over every pair (or over the partners
    ``other_pos`` / ``other_vel``): all rows from one iterate, applied summed.
    Sphere contact at the midpoint has no angular term in the normal row."""

    def __init__(self, pos, inv_m, radius, dt, erp, slop, breaking, other_pos, other_vel):
        src_pos = pos if other_pos is None else other_pos
        delta = pos[..., :, None, :] - src_pos[..., None, :, :]  # (..., N, M, 3)
        dist = norm3(delta)
        self.n = delta / torch.clamp_min(dist, 1e-9)[..., None]
        d = dist - 2.0 * radius
        self.act = (d < breaking).to(pos.dtype) * (dist > 1e-9).to(pos.dtype)
        self.tgt = _target_vn(d, dt, erp, slop)
        self.kinv = 1.0 / (2.0 * inv_m)
        self.inv_m, self.other_vel = inv_m, other_vel
        self.lam = torch.zeros_like(d)

    def normal(self, S):
        vel = S[..., :3]
        v_src = vel if self.other_vel is None else self.other_vel
        u = vel[..., :, None, :] - v_src[..., None, :, :]
        dlam = (self.tgt - _dot(u, self.n)[..., 0]) * self.kinv * self.act
        new = torch.clamp_min(self.lam + dlam, 0.0)
        a = new - self.lam
        vel.add_((a[..., None] * self.n).sum(-2) * self.inv_m)
        self.lam = new
        return S

    def friction(self, S):
        return S  # normal rows only


def solve_contacts(
    pos,
    quat,
    vel,
    ang_v,
    params,
    dt,
    *,
    drone_drone=False,
    other_pos=None,
    other_vel=None,
    obstacles=None,
    pair_candidates=None,
    env_batched=False,
    n_iter=N_ITER,
    erp=ERP,
    slop=SLOP,
    breaking=BREAKING,
    mu_plane=MU_PLANE,
    mu_pair=MU_PAIR,
):
    """One Bullet-style sequential-impulse pass; returns (vel', ang_v').

    ``pos``/``quat``/``vel``/``ang_v``: (..., N, dim), the pre-integration pose
    with the force-integrated velocities. ``obstacles``: an ``ObstacleSet`` of
    static bodies. ``other_pos``/``other_vel``: partner drones of another
    shard for the pair rows (Jacobi only). ``pair_candidates``: a
    ``build_pair_candidates`` result from an earlier pose of the same control
    period (the row geometry is recomputed from the current pose).
    ``env_batched``: the leading axes are independent envs, so fleets above
    ``PAIR_GS_MAX_N`` take the neighbor rows per env (as the JAX package's
    vmapped env step does) instead of the Jacobi pass.
    """
    n = pos.shape[-2]
    R = quat_to_matrix(quat)
    inv_m = 1.0 / params.m
    I_inv_w = _world_inv_inertia(R, params.J_inv)  # (..., N, 3, 3)
    radius = params.collision_r
    geometry = (dt, erp, slop, breaking)

    families = [_plane_rows(pos, R, I_inv_w, inv_m, params, *geometry, mu_plane)]
    use_pairs = drone_drone and (n > 1 or other_pos is not None)
    pair_jacobi = n > PAIR_GS_MAX_N or other_pos is not None
    pair_nbr = (pair_jacobi and other_pos is None and (pos.ndim == 2 or env_batched)
                and (n <= NBR_MAX_N or pair_candidates is not None))
    if use_pairs and not pair_jacobi:
        families.append(_ExactPairRows(pos, I_inv_w, inv_m, radius, *geometry, mu_pair))
    elif use_pairs and pair_nbr:
        if pair_candidates is None:
            pair_candidates = build_pair_candidates(pos, radius)
        families.append(_NeighborRows(pos, I_inv_w, inv_m, radius, *geometry, mu_pair,
                                      pair_candidates[0]))
    elif use_pairs:
        families.append(_JacobiPairRows(pos, inv_m, radius, *geometry, other_pos, other_vel))
    if obstacles is not None:
        families.append(_obstacle_rows(pos, I_inv_w, inv_m, radius, obstacles, *geometry,
                                       mu_pair))

    # Each family of rows sweeps the (..., 6) state S = [vel, ang_v] and
    # keeps its own accumulated impulses.
    S = torch.cat([vel, ang_v], -1)
    for _ in range(n_iter):
        for rows in families:
            S = rows.normal(S)
        for rows in families:
            S = rows.friction(S)
    return S[..., :3], S[..., 3:]
