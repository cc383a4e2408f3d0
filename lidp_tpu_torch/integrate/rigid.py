"""fix rigid/nve — no-squish rigid-body integration (lidp_tpu/integrate/
rigid.py, the tstat=False, pstat=False branches).

In the reference, rigid/nve is FixRigidNH (fix_rigid_nve.h:27 subclasses
it): the symplectic NO-SQUISH quaternion integrator of Kamberaj et al.
(conjugate quaternion momentum + 5 permutation rotations, math_extra.cpp
no_squish_rotate, fix_rigid_nh.cpp:430-589,592-790), batched over bodies:

  * body setup (FixRigid::setup_bodies_static :1605-2118): per-body mass/
    COM, inertia diagonalization by numpy eigh, EPSILON zeroing of small
    principal moments (linear molecules), body-frame displacements.  This
    is host numpy, line for line the JAX package's: on a linear body the
    degenerate pair of moments leaves eigh a free basis in its plane, and
    only the same numpy call on the same float64 input gives the same
    basis, so the same quaternions;
  * per step: vcm half-kick, xcm drift, torque -> quaternion force, conjqm
    update, the no-squish 3-2-1-2-3 rotation sequence, atom x/v
    reconstruction (set_xv :1289, set_v :1465).  The per-body force/torque
    MPI_Allreduce (:1063) is a sum over each body's atoms, gathered through
    a (B, kmax) table of atom indices whose padding names a row of zeros:
    no atomics, so a repeated step gives the same bits, and each body's
    atoms are summed in index order.

The Nose-Hoover chains and the barostat (rigid/nvt, rigid/npt, rigid/nph)
are not ported; make_rigid_params(tstat=True) or pstat=True raises.

Rigid-atom coordinates stay unwrapped (x = R d + xcm); the panel engine's
minimum image and Ewald phases are periodic, so wrapped and unwrapped
coordinates are physically identical.  Massless virtual sites are
tolerated (the reference's "Bad principal moments" abort, :2090-2103, is
not enforced).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lidp_tpu_torch import resolve_device
from lidp_tpu_torch.state import System

EPSILON = 1.0e-7

_BREADTH = ("the rigid Nose-Hoover thermostat and barostat (rigid/nvt, "
            "rigid/npt, rigid/nph) are not ported (ROADMAP queue 1 item 5, "
            "breadth: integrate/rigid.py _nhc_integrate, _nhc_press_rigid, "
            "_nh_epsilon_dot, _remap_half, init_pstat)")


# ----------------------------- quaternion math -----------------------------

def q_to_matrix(q):
    """Rotation matrix with columns ex,ey,ez (math_extra q_to_exyz),
    batched (...,4)->(...,3,3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    ex = torch.stack([w * w + x * x - y * y - z * z,
                      2.0 * (x * y + w * z),
                      2.0 * (x * z - w * y)], dim=-1)
    ey = torch.stack([2.0 * (x * y - w * z),
                      w * w - x * x + y * y - z * z,
                      2.0 * (y * z + w * x)], dim=-1)
    ez = torch.stack([2.0 * (x * z + w * y),
                      2.0 * (y * z - w * x),
                      w * w - x * x - y * y + z * z], dim=-1)
    return torch.stack([ex, ey, ez], dim=-1)   # R[.., :, col]


def qnormalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def vecquat(a, b):
    """(0,a) (x) b quaternion product (math_extra vecquat), batched."""
    c0 = -(a[..., 0] * b[..., 1] + a[..., 1] * b[..., 2]
           + a[..., 2] * b[..., 3])
    c1 = b[..., 0] * a[..., 0] + (a[..., 1] * b[..., 3] - a[..., 2] * b[..., 2])
    c2 = b[..., 0] * a[..., 1] + (a[..., 2] * b[..., 1] - a[..., 0] * b[..., 3])
    c3 = b[..., 0] * a[..., 2] + (a[..., 0] * b[..., 2] - a[..., 1] * b[..., 1])
    return torch.stack([c0, c1, c2, c3], dim=-1)


def _omega_from_R(m, R, inertia):
    """omega = R diag(1/I) R^T m with zero-inertia components zeroed
    (angmom_to_omega / mq_to_omega)."""
    mbody = torch.einsum("...ij,...i->...j", R, m)        # R^T m
    pos = inertia > 0.0
    inv = torch.where(pos, 1.0 / torch.where(pos, inertia, 1.0), 0.0)
    wbody = mbody * inv
    return torch.einsum("...ij,...j->...i", R, wbody)


def richardson(q, m, w, inertia, dtq):
    """Quaternion full-step Richardson update (math_extra.cpp richardson),
    the plain `fix rigid` style's; rigid/nve uses no-squish below."""
    wq = vecquat(w, q)
    qfull = qnormalize(q + dtq * wq)
    qhalf = qnormalize(q + 0.5 * dtq * wq)
    Rh = q_to_matrix(qhalf)
    w2 = _omega_from_R(m, Rh, inertia)
    wq2 = vecquat(w2, qhalf)
    qhalf = qnormalize(qhalf + 0.5 * dtq * wq2)
    return qnormalize(2.0 * qhalf - qfull), w2


def quatvec(a, b):
    """c = a (x) (0,b): quaternion times pure-vector (math_extra.h:609)."""
    c0 = -a[..., 1] * b[..., 0] - a[..., 2] * b[..., 1] - a[..., 3] * b[..., 2]
    c1 = a[..., 0] * b[..., 0] + a[..., 2] * b[..., 2] - a[..., 3] * b[..., 1]
    c2 = a[..., 0] * b[..., 1] + a[..., 3] * b[..., 0] - a[..., 1] * b[..., 2]
    c3 = a[..., 0] * b[..., 2] + a[..., 1] * b[..., 1] - a[..., 2] * b[..., 0]
    return torch.stack([c0, c1, c2, c3], dim=-1)


def invquatvec(a, b):
    """c = vector part of conj(a) (x) b (math_extra.h:636)."""
    c0 = (-a[..., 1] * b[..., 0] + a[..., 0] * b[..., 1]
          + a[..., 3] * b[..., 2] - a[..., 2] * b[..., 3])
    c1 = (-a[..., 2] * b[..., 0] - a[..., 3] * b[..., 1]
          + a[..., 0] * b[..., 2] + a[..., 1] * b[..., 3])
    c2 = (-a[..., 3] * b[..., 0] + a[..., 2] * b[..., 1]
          - a[..., 1] * b[..., 2] + a[..., 0] * b[..., 3])
    return torch.stack([c0, c1, c2], dim=-1)


_SGN_FIX = {1: ((-1.0, 1), (1.0, 0), (1.0, 3), (-1.0, 2)),
            2: ((-1.0, 2), (-1.0, 3), (1.0, 0), (1.0, 1)),
            3: ((-1.0, 3), (1.0, 2), (-1.0, 1), (1.0, 0))}


def no_squish_rotate(k, p, q, inertia, dt):
    """Evolution operator on (conjqm, quat), Miller et al. 2002
    (math_extra.cpp no_squish_rotate), batched over bodies.

    k indexes the permutation (1..3); inertia components < 1e-6 freeze the
    rotation (phi = 0), matching the reference's linear-body handling."""
    sgn_fix = _SGN_FIX[k]
    kq = torch.stack([s * q[..., i] for s, i in sgn_fix], dim=-1)
    kp = torch.stack([s * p[..., i] for s, i in sgn_fix], dim=-1)
    phi = torch.sum(p * kq, dim=-1)
    inert = inertia[..., k - 1]
    frozen = torch.abs(inert) < 1e-6
    phi = torch.where(frozen, 0.0,
                      phi / torch.where(frozen, 1.0, 4.0 * inert))
    c = torch.cos(dt * phi)[..., None]
    s = torch.sin(dt * phi)[..., None]
    return c * p + s * kp, c * q + s * kq


# ------------------------------- body setup --------------------------------

@dataclasses.dataclass(frozen=True)
class RigidSetup:
    """Host-side static body data."""

    nbody: int
    body_of_atom: np.ndarray     # (N,) int32, -1 for non-rigid atoms
    masstotal: np.ndarray        # (B,)
    inertia: np.ndarray          # (B,3) principal moments (zeroed if tiny)
    displace: np.ndarray         # (N,3) body-frame coords (0 for non-rigid)
    xcm0: np.ndarray             # (B,3)
    quat0: np.ndarray            # (B,4)
    dof_removed: int             # dof removed from the full group temperature
    nlinear: int


def _exyz_to_q(R):
    """Quaternion from a rotation matrix with columns ex,ey,ez (host, one
    body)."""
    ex, ey, ez = R[:, 0], R[:, 1], R[:, 2]
    sq = np.array([
        1.0 + ex[0] + ey[1] + ez[2],
        1.0 + ex[0] - ey[1] - ez[2],
        1.0 - ex[0] + ey[1] - ez[2],
        1.0 - ex[0] - ey[1] + ez[2],
    ]) * 0.25
    i = int(np.argmax(sq))
    q = np.zeros(4)
    q[i] = np.sqrt(max(sq[i], 0.0))
    if i == 0:
        q[1] = (ey[2] - ez[1]) / (4.0 * q[0])
        q[2] = (ez[0] - ex[2]) / (4.0 * q[0])
        q[3] = (ex[1] - ey[0]) / (4.0 * q[0])
    elif i == 1:
        q[0] = (ey[2] - ez[1]) / (4.0 * q[1])
        q[2] = (ey[0] + ex[1]) / (4.0 * q[1])
        q[3] = (ex[2] + ez[0]) / (4.0 * q[1])
    elif i == 2:
        q[0] = (ez[0] - ex[2]) / (4.0 * q[2])
        q[1] = (ey[0] + ex[1]) / (4.0 * q[2])
        q[3] = (ez[1] + ey[2]) / (4.0 * q[2])
    else:
        q[0] = (ex[1] - ey[0]) / (4.0 * q[3])
        q[1] = (ex[2] + ez[0]) / (4.0 * q[3])
        q[2] = (ez[1] + ey[2]) / (4.0 * q[3])
    return q / np.linalg.norm(q)


def setup_bodies(x_unwrapped: np.ndarray, mass_atom: np.ndarray,
                 mol: np.ndarray, in_group: np.ndarray) -> RigidSetup:
    """Bodies = molecule ids of atoms in the fix group (fix rigid ...
    molecule, fix_rigid.cpp:126-160). Coordinates must be unwrapped
    (image-applied)."""
    mols = np.unique(mol[in_group])
    body_index = {int(m): i for i, m in enumerate(mols)}
    nb = len(mols)
    body = np.full(x_unwrapped.shape[0], -1, np.int32)
    for i in np.nonzero(in_group)[0]:
        body[i] = body_index[int(mol[i])]

    masstotal = np.zeros(nb)
    xcm = np.zeros((nb, 3))
    for i in np.nonzero(body >= 0)[0]:
        b = body[i]
        masstotal[b] += mass_atom[i]
        xcm[b] += mass_atom[i] * x_unwrapped[i]
    xcm /= masstotal[:, None]

    inertia = np.zeros((nb, 3))
    quat = np.zeros((nb, 4))
    Rall = np.zeros((nb, 3, 3))
    for b in range(nb):
        idx = np.nonzero(body == b)[0]
        d = x_unwrapped[idx] - xcm[b]
        m = mass_atom[idx]
        it = np.zeros((3, 3))
        it[0, 0] = np.sum(m * (d[:, 1] ** 2 + d[:, 2] ** 2))
        it[1, 1] = np.sum(m * (d[:, 0] ** 2 + d[:, 2] ** 2))
        it[2, 2] = np.sum(m * (d[:, 0] ** 2 + d[:, 1] ** 2))
        it[0, 1] = it[1, 0] = -np.sum(m * d[:, 0] * d[:, 1])
        it[0, 2] = it[2, 0] = -np.sum(m * d[:, 0] * d[:, 2])
        it[1, 2] = it[2, 1] = -np.sum(m * d[:, 1] * d[:, 2])
        evals, evecs = np.linalg.eigh(it)
        mx = float(np.max(evals))
        evals = np.where(np.abs(evals) < EPSILON * max(mx, 1e-300), 0.0, evals)
        evals = np.maximum(evals, 0.0)
        # right-handed basis (fix_rigid.cpp:1925-1931)
        if np.dot(np.cross(evecs[:, 0], evecs[:, 1]), evecs[:, 2]) < 0.0:
            evecs[:, 2] = -evecs[:, 2]
        inertia[b] = evals
        Rall[b] = evecs
        quat[b] = _exyz_to_q(evecs)

    displace = np.zeros_like(x_unwrapped)
    for i in np.nonzero(body >= 0)[0]:
        b = body[i]
        displace[i] = Rall[b].T @ (x_unwrapped[i] - xcm[b])

    nlinear = int(np.sum(np.any(inertia == 0.0, axis=1)))
    natoms_rigid = int(np.sum(body >= 0))
    dof_removed = 3 * natoms_rigid - 6 * nb + nlinear
    return RigidSetup(
        nbody=nb, body_of_atom=body, masstotal=masstotal, inertia=inertia,
        displace=displace, xcm0=xcm, quat0=quat,
        dof_removed=dof_removed, nlinear=nlinear,
    )


# ------------------------------ device params ------------------------------

@dataclasses.dataclass(frozen=True)
class RigidParams:
    dtv: torch.Tensor          # dt
    dtf: torch.Tensor          # 0.5*dt*ftm2v
    dtq: torch.Tensor          # 0.5*dt
    body: torch.Tensor         # (N,) int64, -1 -> nbody (in no body)
    in_body: torch.Tensor      # (N,) bool
    members: torch.Tensor      # (B, kmax) int64 atom indices, N = padding
    masstotal: torch.Tensor    # (B,)
    inertia: torch.Tensor      # (B,3)
    displace: torch.Tensor     # (N,3)
    quat0: torch.Tensor        # (B,4) initial orientation from body setup
    mass_atom: torch.Tensor    # (N,) per-atom mass (constraint-virial tally)
    nbody: int = 0


@dataclasses.dataclass(frozen=True)
class RigidState:
    xcm: torch.Tensor      # (B,3)
    vcm: torch.Tensor
    angmom: torch.Tensor
    quat: torch.Tensor     # (B,4)
    conjqm: torch.Tensor   # (B,4) conjugate quaternion momentum (no-squish)
    fcm: torch.Tensor
    torque: torch.Tensor
    virial: torch.Tensor   # (6,) constraint virial of the current step


def make_rigid_params(setup: RigidSetup, dt: float, ftm2v: float,
                      mass_atom=None, dtype=torch.float64, device="cuda", *,
                      tstat=False, pstat=False) -> RigidParams:
    """The integrator's parameters on `device` in `dtype` (the dtype of the
    System's x).  tstat or pstat raise: only rigid/nve is ported."""
    if tstat or pstat:
        raise NotImplementedError(_BREADTH)
    device = resolve_device(device)
    n = setup.body_of_atom.shape[0]
    body = np.where(setup.body_of_atom < 0, setup.nbody, setup.body_of_atom)
    if mass_atom is None:
        mass_atom = np.zeros(n)
    counts = np.bincount(setup.body_of_atom[setup.body_of_atom >= 0],
                         minlength=setup.nbody)
    members = np.full((setup.nbody, max(int(counts.max(initial=0)), 1)), n,
                      np.int64)
    fill = np.zeros(setup.nbody, np.int64)
    for i in np.nonzero(setup.body_of_atom >= 0)[0]:
        b = setup.body_of_atom[i]
        members[b, fill[b]] = i
        fill[b] += 1

    def t(a, d=dtype):
        return torch.as_tensor(np.asarray(a), dtype=d, device=device)

    return RigidParams(
        dtv=t(dt), dtf=t(0.5 * dt * ftm2v), dtq=t(0.5 * dt),
        body=t(body, torch.int64), in_body=t(setup.body_of_atom >= 0,
                                             torch.bool),
        members=t(members, torch.int64), masstotal=t(setup.masstotal),
        inertia=t(setup.inertia), displace=t(setup.displace),
        quat0=t(setup.quat0), mass_atom=t(mass_atom), nbody=setup.nbody)


def _body_sum(v, p: RigidParams):
    """Per-body sum of per-atom rows v (N, ...) -> (B, ...): each body's
    atoms gathered through `members` and summed in index order; atoms in no
    body take no part (jax.ops.segment_sum over ids with nbody dropped)."""
    vz = torch.cat([v, v.new_zeros((1,) + v.shape[1:])])
    return torch.sum(vz[p.members], dim=1)


def _of_atom(vb, p: RigidParams):
    """Per-body rows (B, ...) -> per-atom (N, ...), atoms in no body taking
    the last body's row (the JAX package's clip; they are masked after)."""
    return vb[torch.clamp(p.body, max=p.nbody - 1)]


def init_rigid_state(sys: System, f, p: RigidParams, mass_atom):
    """FixRigid::setup (:782) + FixRigidNH::setup (:323): vcm/angmom from
    atom velocities, fcm/torque from forces, conjqm = 2 q (x) (0, R^T L),
    then set_v projects atom velocities onto rigid motion.  Returns (sys,
    state)."""
    m = mass_atom[:, None] * p.in_body[:, None]
    xcm = _body_sum(m * sys.x, p) / p.masstotal[:, None]
    vcm = _body_sum(m * sys.v, p) / p.masstotal[:, None]
    d = sys.x - _of_atom(xcm, p)
    angmom = _body_sum(m * torch.linalg.cross(d, sys.v), p)
    fcm, torque = _force_torque(sys.x, f, xcm, p)

    quat = p.quat0
    R = q_to_matrix(quat)
    mbody = torch.einsum("bij,bi->bj", R, angmom)       # R^T L
    conjqm = 2.0 * quatvec(quat, mbody)

    w = _omega_from_R(angmom, R, p.inertia)
    d_space = torch.einsum("nij,nj->ni", _of_atom(R, p), p.displace)
    v_new = _of_atom(vcm, p) + torch.linalg.cross(_of_atom(w, p), d_space)
    inb = p.in_body[:, None]
    vir = 2.0 * _constraint_virial(sys.x, sys.v, v_new, f, p)
    sys = sys.replace(v=torch.where(inb, v_new, sys.v))

    st = RigidState(
        xcm=xcm, vcm=vcm, angmom=angmom, quat=quat, conjqm=conjqm,
        fcm=fcm, torque=torque, virial=vir)
    return sys, st


def _constraint_virial(x, v_old, v_new, f, p: RigidParams):
    """0.5 * sum_i x_i (x) fc_i with fc = m dv/dtf - f (set_xv/set_v
    tallies, fix_rigid.cpp:1383-1399, :1520-1545). Coordinates here are
    unwrapped."""
    inb = p.in_body[:, None]
    fc = torch.where(inb, p.mass_atom[:, None] * (v_new - v_old) / p.dtf - f,
                     0.0)
    return 0.5 * torch.stack([
        torch.sum(x[:, 0] * fc[:, 0]), torch.sum(x[:, 1] * fc[:, 1]),
        torch.sum(x[:, 2] * fc[:, 2]), torch.sum(x[:, 0] * fc[:, 1]),
        torch.sum(x[:, 0] * fc[:, 2]), torch.sum(x[:, 1] * fc[:, 2]),
    ])


def _force_torque(x, f, xcm, p: RigidParams):
    fcm = _body_sum(f, p)
    d = x - _of_atom(xcm, p)
    torque = _body_sum(torch.linalg.cross(d, f), p)
    return fcm, torque


def initial_integrate(sys: System, f, p: RigidParams, st: RigidState):
    """FixRigidNH::initial_integrate (:430-589), rigid/nve."""
    dtf2 = p.dtf * 2.0
    dtfm = (p.dtf / p.masstotal)[:, None]
    vcm = st.vcm + dtfm * st.fcm
    xcm = st.xcm + p.dtv * vcm

    R = q_to_matrix(st.quat)
    tbody = torch.einsum("bij,bi->bj", R, st.torque)
    fquat = quatvec(st.quat, tbody)
    conjqm = st.conjqm + dtf2 * fquat

    q = st.quat
    cq = conjqm
    cq, q = no_squish_rotate(3, cq, q, p.inertia, p.dtq)
    cq, q = no_squish_rotate(2, cq, q, p.inertia, p.dtq)
    cq, q = no_squish_rotate(1, cq, q, p.inertia, p.dtv)
    cq, q = no_squish_rotate(2, cq, q, p.inertia, p.dtq)
    cq, q = no_squish_rotate(3, cq, q, p.inertia, p.dtq)
    quat, conjqm = q, cq

    R = q_to_matrix(quat)
    mbody = invquatvec(quat, conjqm)
    angmom = 0.5 * torch.einsum("bij,bj->bi", R, mbody)
    w = _omega_from_R(angmom, R, p.inertia)

    # set_xv (:1289): x = R d + xcm (unwrapped), v = vcm + omega x (R d)
    d_space = torch.einsum("nij,nj->ni", _of_atom(R, p), p.displace)
    x_new = d_space + _of_atom(xcm, p)
    v_new = _of_atom(vcm, p) + torch.linalg.cross(_of_atom(w, p), d_space)
    inb = p.in_body[:, None]
    vir = _constraint_virial(sys.x, sys.v, v_new, f, p)
    sys = sys.replace(x=torch.where(inb, x_new, sys.x),
                      v=torch.where(inb, v_new, sys.v))
    return sys, dataclasses.replace(
        st, xcm=xcm, vcm=vcm, angmom=angmom, quat=quat, conjqm=conjqm,
        virial=vir)


def final_integrate(sys: System, f, p: RigidParams, st: RigidState):
    """FixRigidNH::final_integrate (:592-790), rigid/nve."""
    dtf2 = p.dtf * 2.0
    fcm, torque = _force_torque(sys.x, f, st.xcm, p)
    dtfm = (p.dtf / p.masstotal)[:, None]
    vcm = st.vcm + dtfm * fcm

    R = q_to_matrix(st.quat)
    tbody = torch.einsum("bij,bi->bj", R, torque)
    fquat = quatvec(st.quat, tbody)
    conjqm = st.conjqm + dtf2 * fquat

    mbody = invquatvec(st.quat, conjqm)
    angmom = 0.5 * torch.einsum("bij,bj->bi", R, mbody)
    w = _omega_from_R(angmom, R, p.inertia)

    # set_v (:1465)
    d_space = torch.einsum("nij,nj->ni", _of_atom(R, p), p.displace)
    v_new = _of_atom(vcm, p) + torch.linalg.cross(_of_atom(w, p), d_space)
    inb = p.in_body[:, None]
    vir = st.virial + _constraint_virial(sys.x, sys.v, v_new, f, p)
    sys = sys.replace(v=torch.where(inb, v_new, sys.v))
    return sys, dataclasses.replace(
        st, vcm=vcm, angmom=angmom, conjqm=conjqm, fcm=fcm, torque=torque,
        virial=vir)
