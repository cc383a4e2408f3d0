"""fix rigid/nve, rigid/nvt, rigid/npt and rigid/nph — no-squish
rigid-body integration with optional Nose-Hoover chains and the MTK
barostat (lidp_tpu/integrate/rigid.py).

In the reference, rigid/nve and rigid/nvt are FixRigidNH (fix_rigid_nve.h:27
and fix_rigid_nvt.h subclass it): the symplectic NO-SQUISH quaternion
integrator of Kamberaj et al. (conjugate quaternion momentum + 5
permutation rotations, math_extra.cpp no_squish_rotate,
fix_rigid_nh.cpp:430-589,592-790), batched over bodies:

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
    atoms are summed in index order;
  * rigid/nvt (tstat): Nose-Hoover chains on the translational and the
    rotational kinetic energy (nhc_temp_integrate, fix_rigid_nh.cpp:
    829-917) with Yoshida-Suzuki weights (t_order 3 or 5, :244-258), the
    chain masses of FixRigidNH::init (nf_t, nf_r, :225-237), vcm and
    conjqm scaled by exp(-dtq eta_dot[0]) in both halves and the chains
    advanced in initial_integrate only, as in the JAX package.

The chains run on the host.  A chain update is sequential scalar
arithmetic: at the SIFSIX example's `tparam 50 1 3` one call is 3 Yoshida
steps of about 2 x 49 link updates, ~7,700 operations, two calls a step.  As
0-d device tensors each would be an eager launch; instead initial_integrate
reduces akin_t and akin_r on the device and reads both in one transfer
(the one host read the thermostat adds to a step), the chains run on host
scalars of the run's dtype (Python float for float64, numpy float32
otherwise), and the scale factors multiply the device tensors as Python
scalars.  On the CPU in float64 this is the JAX package's arithmetic
operation for operation (exp may differ by an ulp).  Measured at
`tparam 50 1 3` on 256 bodies (chip_smoke.py path J, two runs on an
NVIDIA H100 80GB HBM3 at 700 W and its host): the chains take 0.32-0.54
ms a step and the rigid/nvt integrator 5.98-9.16 ms a step against
rigid/nve's 5.30-5.45, both bound by the eager launches of the
no-squish update.

rigid/npt and rigid/nph (pstat): the barostat half of FixRigidNH.  The
strain rate epsilon_dot and mtk_term2 are device tensors: the coupled
pressure (_press_current, the fix group's kinetic tensor and the force
virial with the set_xv/set_v constraint tallies) enters nh_epsilon_dot
(:1139-1165) in final_integrate and at setup (init_pstat); the box and
the body centres dilate about the box centre in two half remaps
(_remap_half, :1049-1103) around set_xv.  The barostat's own chain
(nhc_press_integrate, :891-965, with the reference's exp(-0.5 tmp)) runs
on the host as the thermostat's do: initial_integrate reads epsilon_dot
with akin_t and akin_r in its one transfer (rigid/nph reads epsilon_dot
alone), so a step of either style reads the device once.  The ramped
targets t_target and p_target are substituted per step by
driver.rigid_nve_integrator.  `dilate` other than all is not ported.

Rigid-atom coordinates stay unwrapped (x = R d + xcm); the panel engine's
minimum image and Ewald phases are periodic, so wrapped and unwrapped
coordinates are physically identical.  Massless virtual sites are
tolerated (the reference's "Bad principal moments" abort, :2090-2103, is
not enforced).
"""

from __future__ import annotations

import dataclasses
import math
from typing import ClassVar, Optional

import numpy as np
import torch

from lidp_tpu_torch import resolve_device
from lidp_tpu_torch.state import System

EPSILON = 1.0e-7

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
    # thermostat (fix rigid/nvt); tstat False -> plain no-squish NVE.  Host
    # scalars of the run's dtype (_host_scalar): the chains run on the host
    tstat: bool = False
    t_start: Optional[float] = None
    t_stop: Optional[float] = None
    t_freq: Optional[float] = None     # 1/Tdamp
    # current ramped target: rigid_nve_integrator substitutes ramp_target(
    # ..., step + 1) before each initial_integrate (FixRigidNH::
    # compute_temp_target, fix_rigid_nh.cpp:1107-1115); Simulation.run sets
    # the window to each run's first and last step
    t_target: Optional[float] = None
    ramp_begin: int = 0
    ramp_end: int = 0
    t_dtv: Optional[float] = None      # dtv and dtq as host scalars
    t_dtq: Optional[float] = None
    t_chain: int = 10
    t_iter: int = 1
    t_order: int = 3
    nf_t: float = 0.0
    nf_r: float = 0.0
    boltz: float = 1.0
    mvv2e: float = 1.0
    # barostat (fix rigid/npt + rigid/nph, FixRigidNH's pstat_flag path);
    # host scalars of the run's dtype, as the thermostat's.  p_target is
    # the current ramped target (rigid_nve_integrator substitutes it with
    # t_target), p_start and p_stop the run's ramp
    pstat: bool = False
    p_start: tuple = (0.0, 0.0, 0.0)
    p_stop: tuple = (0.0, 0.0, 0.0)
    p_target: tuple = (0.0, 0.0, 0.0)
    p_freq: tuple = (0.0, 0.0, 0.0)     # 1/Pdamp, 0 where Pdamp <= 0
    p_freq_max: float = 0.0
    p_chain: int = 10
    p_flag: tuple = (False, False, False)
    iso: bool = True
    nktv2p: float = 1.0
    dim: int = 3
    pflag: Optional[torch.Tensor] = None   # (3,) bool on the device
    # (3,) p_freq^2 on the device, 1 where p_freq is 0: the barostat
    # masses' denominators
    p_denom: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class RigidState:
    # the quantities relative to the body frame (RigidParams quat0 and
    # displace), which a new Simulation builds from the positions it
    # starts from: read_restart's setup keeps its own (utils/checkpoint)
    FRAME_FIELDS: ClassVar[tuple] = ("quat", "conjqm")

    xcm: torch.Tensor      # (B,3)
    vcm: torch.Tensor
    angmom: torch.Tensor
    quat: torch.Tensor     # (B,4)
    conjqm: torch.Tensor   # (B,4) conjugate quaternion momentum (no-squish)
    fcm: torch.Tensor
    torque: torch.Tensor
    virial: torch.Tensor   # (6,) constraint virial of the current step
    # (t_chain,) host numpy arrays of the run's dtype: the thermostat
    # velocities, translational and rotational
    eta_dot_t: Optional[np.ndarray] = None
    eta_dot_r: Optional[np.ndarray] = None
    # barostat state (pstat; None otherwise): the strain rate (3,) and
    # mtk_term2 () on the device, the barostat chain (p_chain,) a host
    # array of the run's dtype
    epsilon_dot: Optional[torch.Tensor] = None
    eta_dot_b: Optional[np.ndarray] = None
    mtk_term2: Optional[torch.Tensor] = None


def _host_scalar(dtype):
    """The host scalar type of a run's dtype for the chain arithmetic:
    Python float (IEEE double, the cheapest scalar) for float64, numpy
    float32 for float32 (numpy keeps float32 when a Python float joins)."""
    return float if dtype == torch.float64 else np.float32


def chain_dtype(dtype):
    """The numpy dtype of a run's chain velocities (host arrays)."""
    return np.float64 if dtype == torch.float64 else np.float32


def make_rigid_params(setup: RigidSetup, dt: float, ftm2v: float,
                      mass_atom=None, dtype=torch.float64, device="cuda", *,
                      tstat=False, t_start=0.0, t_stop=0.0, t_period=1.0,
                      t_chain=10, t_iter=1, t_order=3, boltz=1.0,
                      mvv2e=1.0, pstat=False, p_start=(0.0, 0.0, 0.0),
                      p_stop=(0.0, 0.0, 0.0), p_period=(1.0, 1.0, 1.0),
                      p_flag=(False, False, False), p_chain=10, iso=True,
                      nktv2p=1.0, dim=3) -> RigidParams:
    """The integrator's parameters on `device` in `dtype` (the dtype of the
    System's x).  tstat: the rigid/nvt chains (temp t_start t_stop
    t_period, tparam t_chain t_iter t_order).  pstat: the barostat
    (iso/aniso/x/y/z p_start p_stop p_period, p_flag the coupled
    dimensions, iso couple xyz, pchain p_chain)."""
    device = resolve_device(device)
    _yoshida_w(t_order)
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

    S = _host_scalar(dtype)
    # nf_t/nf_r per FixRigidNH::init (:225-237)
    nf_t = 3.0 * setup.nbody
    nf_r = 3.0 * setup.nbody - float(np.sum(np.abs(setup.inertia) < EPSILON))
    p_period = np.asarray(p_period, float)
    p_freq = np.where(p_period > 0.0, 1.0 / np.maximum(p_period, 1e-300),
                      0.0)
    return RigidParams(
        dtv=t(dt), dtf=t(0.5 * dt * ftm2v), dtq=t(0.5 * dt),
        body=t(body, torch.int64), in_body=t(setup.body_of_atom >= 0,
                                             torch.bool),
        members=t(members, torch.int64), masstotal=t(setup.masstotal),
        inertia=t(setup.inertia), displace=t(setup.displace),
        quat0=t(setup.quat0), mass_atom=t(mass_atom), nbody=setup.nbody,
        tstat=tstat, t_start=S(t_start), t_stop=S(t_stop),
        t_freq=S(1.0 / t_period if t_period else 0.0), t_target=S(t_start),
        t_dtv=S(dt), t_dtq=S(0.5 * dt), t_chain=t_chain, t_iter=t_iter,
        t_order=t_order, nf_t=nf_t, nf_r=nf_r, boltz=boltz, mvv2e=mvv2e,
        pstat=pstat, p_start=tuple(S(v) for v in p_start),
        p_stop=tuple(S(v) for v in p_stop),
        p_target=tuple(S(v) for v in p_start),
        p_freq=tuple(S(v) for v in p_freq), p_freq_max=S(np.max(p_freq)),
        p_chain=p_chain, p_flag=tuple(bool(b) for b in p_flag), iso=iso,
        nktv2p=nktv2p, dim=dim,
        pflag=t([bool(b) for b in p_flag], torch.bool),
        p_denom=t(np.where(p_freq > 0.0, p_freq * p_freq, 1.0)))


def _yoshida_w(order):
    if order == 3:
        w0 = 1.0 / (2.0 - 2.0 ** (1.0 / 3.0))
        return (w0, 1.0 - 2.0 * w0, w0)
    if order == 5:
        w0 = 1.0 / (4.0 - 4.0 ** (1.0 / 3.0))
        return (w0, w0, 1.0 - 4.0 * w0, w0, w0)
    raise ValueError("t_order must be 3 or 5 (fix_rigid_nh.cpp:244)")


def _maclaurin(x):
    x2 = x * x
    x4 = x2 * x2
    return (1.0 + x2 / 6.0 + x4 / 120.0 + x2 * x4 / 5040.0
            + x4 * x4 / 362880.0)


def _exp(x):
    """exp of a host scalar, keeping its type (math.exp for a Python float,
    numpy's for a numpy float32)."""
    return math.exp(x) if isinstance(x, float) else np.exp(x)


def _nhc_integrate(eta_dot, akin, nf, p: RigidParams):
    """One nhc_temp_integrate chain update (fix_rigid_nh.cpp:829-917) for
    one sub-thermostat (translational or rotational), on host scalars:
    eta_dot a (t_chain,) numpy array, akin a host scalar of its dtype.
    Returns the new eta_dot.  The chain's exp(-tmp) is the reference's;
    its barostat chain (_nhc_press_rigid) takes exp(-0.5 tmp)."""
    S = type(p.t_target)
    kt = p.boltz * p.t_target      # per-step ramped target
    gfkt = nf * kt
    t_mass = kt / (p.t_freq * p.t_freq)
    q = [nf * t_mass] + [t_mass] * (p.t_chain - 1)

    eta = [S(e) for e in eta_dot]
    f = [S(0.0)] * p.t_chain
    f[0] = (akin * p.mvv2e - gfkt) / q[0]
    for k in range(1, p.t_chain):
        f[k] = (q[k - 1] * eta[k - 1] * eta[k - 1] - kt) / q[k]

    w = _yoshida_w(p.t_order)
    C = p.t_chain
    for _ in range(p.t_iter):
        for j in range(p.t_order):
            wdti1 = w[j] * p.t_dtv / p.t_iter
            wdti2 = wdti1 / 2.0
            wdti4 = wdti1 / 4.0
            eta[C - 1] = eta[C - 1] + wdti2 * f[C - 1]
            for k in range(1, C):
                tmp = wdti4 * eta[C - k]
                s = _exp(-tmp)
                eta[C - k - 1] = eta[C - k - 1] * s * s + \
                    wdti2 * f[C - k - 1] * s * _maclaurin(tmp)
            for k in range(1, C):
                f[k] = (q[k - 1] * eta[k - 1] * eta[k - 1] - kt) / q[k]
            for k in range(0, C - 1):
                tmp = wdti4 * eta[k + 1]
                s = _exp(-tmp)
                eta[k] = eta[k] * s * s + wdti2 * f[k] * s * _maclaurin(tmp)
                f[k + 1] = (q[k] * eta[k] * eta[k] - kt) / q[k + 1]
            eta[C - 1] = eta[C - 1] + wdti2 * f[C - 1]
    return np.array(eta, dtype=eta_dot.dtype)

# --------------------------- barostat (npt/nph) ----------------------------

def _press_current(sys, virial, p: RigidParams):
    """Coupled current pressure (FixRigidNH couple, fix_rigid_nh.cpp:1019):
    per-dim (sum m v_d^2 * mvv2e + virial_d)/V * nktv2p over the fix
    group's atom velocities and the whole virial (the force field's and
    the set_xv/set_v constraint tallies); iso averages the dims."""
    m = torch.where(p.in_body, p.mass_atom, 0.0)
    ke3 = p.mvv2e * torch.sum(m[:, None] * sys.v * sys.v, dim=0)
    L = sys.box.lengths
    vol = L[0] * L[1] if p.dim == 2 else L[0] * L[1] * L[2]
    ptens = (ke3 + virial[:3]) / vol * p.nktv2p
    if p.iso:
        ptens = torch.mean(ptens).expand(3)
    return ptens, vol


def _p_hydro(p: RigidParams):
    """compute_press_target (:1121-1133): the hydrostatic target over the
    coupled dims, of the ramped p_target."""
    pdim = sum(p.p_flag)
    return sum(t for t, f in zip(p.p_target, p.p_flag) if f) / max(pdim, 1)


def _nhc_press_rigid(eta_dot_b, epsilon_dot, p: RigidParams):
    """nhc_press_integrate (fix_rigid_nh.cpp:891-965): the barostat's
    thermostat chain on host scalars (epsilon_dot a host list of 3).  The
    reference takes exp(-0.5 tmp) here where the temperature chain takes
    exp(-tmp); kept as it is."""
    S = type(p.t_target)
    kt = p.boltz * p.t_target
    pdim = max(sum(p.p_flag), 1)
    tb_mass = kt / (p.p_freq_max * p.p_freq_max)
    q = [p.dim * p.dim * tb_mass] + [tb_mass] * (p.p_chain - 1)
    # the barostat masses per dim, (nf_t + nf_r + dim) kT / p_freq^2 (1
    # where p_freq is 0)
    g = p.nf_t + p.nf_r + p.dim
    eps_mass = [g * kt / (f * f if f > 0.0 else 1.0) for f in p.p_freq]
    kecurrent = S(0.0)
    for d in range(3):
        if p.p_flag[d]:
            kecurrent = kecurrent + eps_mass[d] * epsilon_dot[d] \
                * epsilon_dot[d]
    kecurrent = kecurrent / pdim

    eta = [S(e) for e in eta_dot_b]
    f = [S(0.0)] * p.p_chain
    f[0] = (kecurrent - kt) / q[0]
    for k in range(1, p.p_chain):
        f[k] = (q[k - 1] * eta[k - 1] * eta[k - 1] - kt) / q[k]

    w = _yoshida_w(p.t_order)
    C = p.p_chain
    for _ in range(p.t_iter):
        for j in range(p.t_order):
            wdti1 = w[j] * p.t_dtv / p.t_iter
            wdti2 = wdti1 / 2.0
            wdti4 = wdti1 / 4.0
            eta[C - 1] = eta[C - 1] + wdti2 * f[C - 1]
            for k in range(1, C):
                tmp = wdti4 * eta[C - k]
                s = _exp(-0.5 * tmp)
                eta[C - k - 1] = eta[C - k - 1] * s * s + \
                    wdti2 * f[C - k - 1] * s * _maclaurin(tmp)
            for k in range(1, C):
                f[k] = (q[k - 1] * eta[k - 1] * eta[k - 1] - kt) / q[k]
            for k in range(0, C - 1):
                tmp = wdti4 * eta[k + 1]
                s = _exp(-0.5 * tmp)
                eta[k] = eta[k] * s * s + wdti2 * f[k] * s * _maclaurin(tmp)
                f[k + 1] = (q[k] * eta[k] * eta[k] - kt) / q[k + 1]
            eta[C - 1] = eta[C - 1] + wdti2 * f[C - 1]
    return np.array(eta, dtype=eta_dot_b.dtype)


def _nh_epsilon_dot(akin_t, akin_r, p_current, vol, st, p: RigidParams):
    """nh_epsilon_dot (fix_rigid_nh.cpp:1139-1165): the strain rate's
    half-step with the MTK correction and the barostat chain's damping
    scale (a host scalar); akin_t, akin_r, p_current and vol on the
    device."""
    g_f = p.nf_t + p.nf_r
    mtk_term1 = (akin_t + akin_r) * p.mvv2e / g_f
    scale = float(_exp(-p.t_dtq * st.eta_dot_b[0]))
    kt = p.boltz * p.t_target
    eps_mass = (g_f + p.dim) * float(kt) / p.p_denom
    f_eps = ((p_current - _p_hydro(p)) * vol / p.nktv2p
             + mtk_term1) / eps_mass
    eps_dot = torch.where(p.pflag, (st.epsilon_dot + p.dtq * f_eps) * scale,
                          st.epsilon_dot)
    mtk_term2 = torch.sum(torch.where(p.pflag, eps_dot, 0.0)) / g_f
    return dataclasses.replace(st, epsilon_dot=eps_dot, mtk_term2=mtk_term2)


def _remap_half(sys, st, p: RigidParams, xcm):
    """remap() (fix_rigid_nh.cpp:1049-1103): a half-step box dilation about
    the box centre; every atom and the body centres of mass ride in lamda
    coordinates (allremap, FixRigid::deform's xcm remap).  The System gets
    a new Box."""
    expfac = torch.where(p.pflag, torch.exp(p.dtq * st.epsilon_dot), 1.0)
    lo, hi = sys.box.lo, sys.box.hi
    ctr = 0.5 * (lo + hi)
    lo2 = (lo - ctr) * expfac + ctr
    hi2 = (hi - ctr) * expfac + ctr
    x2 = (sys.x - ctr) * expfac + ctr
    xcm2 = (xcm - ctr) * expfac + ctr
    box2 = dataclasses.replace(sys.box, lo=lo2, hi=hi2)
    return sys.replace(x=x2, box=box2), xcm2


def init_pstat(sys: System, virial, p: RigidParams, st: RigidState):
    """FixRigidNH::setup's tail (:420-422): the first compute_press_target
    and nh_epsilon_dot, so that step 1 sees a strain rate.  Called right
    after init_rigid_state with the setup's force virial."""
    akin_t = torch.sum(p.masstotal * torch.sum(st.vcm * st.vcm, dim=1))
    w = _omega_from_R(st.angmom, q_to_matrix(st.quat), p.inertia)
    akin_r = torch.sum(torch.sum(st.angmom * w, dim=1))
    p_cur, vol = _press_current(sys, virial + st.virial, p)
    return _nh_epsilon_dot(akin_t, akin_r, p_cur, vol, st, p)


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

    chain = np.zeros(p.t_chain, chain_dtype(sys.x.dtype))
    st = RigidState(
        xcm=xcm, vcm=vcm, angmom=angmom, quat=quat, conjqm=conjqm,
        fcm=fcm, torque=torque, virial=vir, eta_dot_t=chain,
        eta_dot_r=chain.copy())
    if p.pstat:
        st = dataclasses.replace(
            st, epsilon_dot=sys.x.new_zeros(3),
            eta_dot_b=np.zeros(p.p_chain, chain_dtype(sys.x.dtype)),
            mtk_term2=sys.x.new_zeros(()))
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


def _chain_scales(p: RigidParams, st: RigidState):
    """exp(-dtq eta_dot[0]) of the translational and rotational chains, as
    Python scalars (1.0 without a thermostat)."""
    if not p.tstat:
        return 1.0, 1.0
    return (float(_exp(-p.t_dtq * st.eta_dot_t[0])),
            float(_exp(-p.t_dtq * st.eta_dot_r[0])))


def _scales(p: RigidParams, st: RigidState):
    """The scale of vcm (a Python scalar, or a (3,) device tensor under the
    barostat) and of conjqm in either half: the chains' and, with pstat,
    exp(-dtq (epsilon_dot + mtk_term2)) and exp(-dtq pdim mtk_term2)."""
    scale_t, scale_r = _chain_scales(p, st)
    if p.pstat:
        pdim = sum(p.p_flag)
        scale_t = torch.exp(-p.dtq * (st.epsilon_dot + st.mtk_term2)) \
            * scale_t
        scale_r = torch.exp(-p.dtq * (pdim * st.mtk_term2)) * scale_r
    return scale_t, scale_r


def initial_integrate(sys: System, f, p: RigidParams, st: RigidState):
    """FixRigidNH::initial_integrate (:430-589): rigid/nve, rigid/nvt (vcm
    and conjqm scaled by the chains, then both chains advanced) and the
    barostat (scales and the drift of the strain rate, the barostat chain,
    the box and body centres remapped a half step before and after
    set_xv), after one read of akin_t, akin_r and epsilon_dot."""
    dtf2 = p.dtf * 2.0
    thermo = p.tstat or p.pstat
    scale_t, scale_r = _scales(p, st)
    dtfm = (p.dtf / p.masstotal)[:, None]
    vcm = st.vcm + dtfm * st.fcm
    if thermo:
        vcm = vcm * scale_t
    if p.pstat:
        tmp = p.dtq * st.epsilon_dot
        scale_v3 = p.dtv * torch.exp(tmp) * _maclaurin(tmp)
        xcm = st.xcm + scale_v3[None, :] * vcm
    else:
        xcm = st.xcm + p.dtv * vcm

    R = q_to_matrix(st.quat)
    tbody = torch.einsum("bij,bi->bj", R, st.torque)
    fquat = quatvec(st.quat, tbody)
    conjqm = st.conjqm + dtf2 * fquat
    if thermo:
        conjqm = conjqm * scale_r

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

    eta_dot_t, eta_dot_r = st.eta_dot_t, st.eta_dot_r
    st2 = st
    if thermo:
        # the integrator's one host read a step
        S = type(p.t_target)
        reads = []
        if p.tstat:
            akin_t = torch.sum(p.masstotal * torch.sum(vcm * vcm, dim=1))
            akin_r = torch.sum(torch.sum(angmom * w, dim=1))
            reads += [akin_t, akin_r]
        if p.pstat:
            reads += list(st.epsilon_dot.unbind(0))
        vals = [S(v) for v in torch.stack(reads).tolist()]
        if p.tstat:
            eta_dot_t = _nhc_integrate(eta_dot_t, vals[0], p.nf_t, p)
            eta_dot_r = _nhc_integrate(eta_dot_r, vals[1], p.nf_r, p)
            vals = vals[2:]
        st2 = dataclasses.replace(st, eta_dot_t=eta_dot_t,
                                  eta_dot_r=eta_dot_r)
        if p.pstat:
            # update_nhcb (nhc_press_integrate :891), then the first half
            # remap
            st2 = dataclasses.replace(
                st2, eta_dot_b=_nhc_press_rigid(st2.eta_dot_b, vals, p))
            sys, xcm = _remap_half(sys, st2, p, xcm)

    # set_xv (:1289): x = R d + xcm (unwrapped), v = vcm + omega x (R d)
    d_space = torch.einsum("nij,nj->ni", _of_atom(R, p), p.displace)
    x_new = d_space + _of_atom(xcm, p)
    v_new = _of_atom(vcm, p) + torch.linalg.cross(_of_atom(w, p), d_space)
    inb = p.in_body[:, None]
    vir = _constraint_virial(sys.x, sys.v, v_new, f, p)
    sys = sys.replace(x=torch.where(inb, x_new, sys.x),
                      v=torch.where(inb, v_new, sys.v))
    if p.pstat:
        # the second half remap after set_xv (the atoms ride along,
        # :582-586); the k-space terms read the new box at the next call
        sys, xcm = _remap_half(sys, st2, p, xcm)
    return sys, dataclasses.replace(
        st2, xcm=xcm, vcm=vcm, angmom=angmom, quat=quat, conjqm=conjqm,
        virial=vir)


def final_integrate(sys: System, f, p: RigidParams, st: RigidState,
                    res_virial=None):
    """FixRigidNH::final_integrate (:592-790): rigid/nve, rigid/nvt (vcm
    and conjqm scaled by the chains before the kick; the chains do not
    advance here) and the barostat (its scales, then nh_epsilon_dot from
    the pressure of the step's force virial res_virial and the
    constraint virial, :775-790)."""
    dtf2 = p.dtf * 2.0
    thermo = p.tstat or p.pstat
    scale_t, scale_r = _scales(p, st)
    fcm, torque = _force_torque(sys.x, f, st.xcm, p)
    dtfm = (p.dtf / p.masstotal)[:, None]
    vcm = st.vcm
    if thermo:
        vcm = vcm * scale_t
    vcm = vcm + dtfm * fcm

    R = q_to_matrix(st.quat)
    tbody = torch.einsum("bij,bi->bj", R, torque)
    fquat = quatvec(st.quat, tbody)
    if thermo:
        conjqm = scale_r * st.conjqm + dtf2 * fquat
    else:
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
    st2 = dataclasses.replace(
        st, vcm=vcm, angmom=angmom, conjqm=conjqm, fcm=fcm, torque=torque,
        virial=vir)
    if p.pstat:
        akin_t = torch.sum(p.masstotal * torch.sum(vcm * vcm, dim=1))
        akin_r = torch.sum(torch.sum(angmom * w, dim=1))
        total = vir if res_virial is None else res_virial + vir
        p_cur, vol = _press_current(sys, total, p)
        st2 = _nh_epsilon_dot(akin_t, akin_r, p_cur, vol, st2, p)
    return sys, st2
