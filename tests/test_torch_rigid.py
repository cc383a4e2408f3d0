"""The port's no-squish rigid/nve integrator (lidp_tpu_torch.integrate.rigid)
against the JAX package's (lidp_tpu.integrate.rigid), float64 on the CPU,
inputs from numpy seeds:

  * setup_bodies returns the same arrays (the same numpy on the same
    input): linear bodies (the synthetic fluid's H-O-H, whose degenerate
    moments leave eigh a free basis), bent bodies, a body with a massless
    site, and atoms in no body;
  * the quaternion helpers, no_squish_rotate (with a zero moment, which
    freezes its rotation) and richardson on random batches to 1e-13;
  * init_rigid_state and 10 initial_integrate/final_integrate pairs under a
    fixed position-dependent force to 1e-10 of each array's largest entry:
    xcm, vcm, angmom, quat, conjqm, the constraint virial, x and v; the
    state carried across by convert.rigid_state_from_numpy continues alike;
  * make_rigid_params(pstat=True) gives the JAX package's barostat
    fields (the barostat's integrator is held in tests/test_torch_npt.py,
    the thermostat, tstat=True, in tests/test_torch_thermostats.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from lidp_tpu.integrate import rigid as jr  # noqa: E402
from lidp_tpu_torch import convert  # noqa: E402
from lidp_tpu_torch.integrate import rigid as tr  # noqa: E402
from lidp_tpu_torch.models import polar_bench  # noqa: E402

DT, FTM2V = 0.5, 4.184e-4 / 1.0


def _bodies(kind, seed=0):
    """(x, mass, mol, in_group) numpy inputs of setup_bodies."""
    rng = np.random.RandomState(seed)
    if kind == "linear":
        s = polar_bench.synthetic_system(3, seed=seed)
        n = s["x"].shape[0]
        return s["x"], s["mass"], s["mol"], np.ones(n, bool)
    nb = 12
    x, mass, mol = [], [], []
    for b in range(nb):
        c = rng.uniform(0, 20, 3)
        k = 3 + b % 3
        x.append(c + rng.normal(0, 0.8, (k, 3)))
        mass.append(rng.uniform(1.0, 16.0, k))
        mol.append(np.full(k, b + 1))
    x, mass, mol = map(np.concatenate, (x, mass, mol))
    in_group = np.ones(x.shape[0], bool)
    if kind == "massless":
        mass[[0, 7, 11]] = 0.0           # virtual sites in bodies 1, 3, 4
    elif kind == "free":
        in_group[rng.choice(x.shape[0], 6, replace=False)] = False
        mol[~in_group & (rng.rand(x.shape[0]) < 0.5)] = 0
    return x, mass, mol, in_group


KINDS = ["linear", "bent", "massless", "free"]


@pytest.mark.parametrize("kind", KINDS)
def test_setup_bodies_matches_jax(kind):
    args = _bodies(kind)
    j = jr.setup_bodies(*args)
    t = tr.setup_bodies(*args)
    for f in dataclasses.fields(jr.RigidSetup):
        a, b = getattr(t, f.name), getattr(j, f.name)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), f.name)
    if kind == "linear":
        assert t.nlinear == t.nbody and t.dof_removed == 4 * t.nbody


def _rand(rng, *shape):
    return rng.normal(size=shape)


def _close(a, b, tol):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=tol * max(np.abs(b).max(), 1e-300))


def test_quaternion_helpers_match_jax():
    rng = np.random.RandomState(3)
    q = _rand(rng, 64, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    a3, b4, v3 = _rand(rng, 64, 3), _rand(rng, 64, 4), _rand(rng, 64, 3)
    inertia = rng.uniform(0.5, 5.0, (64, 3))
    inertia[::5, 1] = 0.0
    T, J = torch.as_tensor, jnp.asarray
    pairs = [
        (tr.q_to_matrix(T(q)), jr.q_to_matrix(J(q))),
        (tr.qnormalize(T(b4)), jr.qnormalize(J(b4))),
        (tr.vecquat(T(a3), T(b4)), jr.vecquat(J(a3), J(b4))),
        (tr.quatvec(T(b4), T(v3)), jr.quatvec(J(b4), J(v3))),
        (tr.invquatvec(T(q), T(b4)), jr.invquatvec(J(q), J(b4))),
        (tr._omega_from_R(T(v3), tr.q_to_matrix(T(q)), T(inertia)),
         jr._omega_from_R(J(v3), jr.q_to_matrix(J(q)), J(inertia))),
    ]
    w = _rand(rng, 64, 3)
    pairs += list(zip(tr.richardson(T(q), T(a3), T(w), T(inertia), 0.25),
                      jr.richardson(J(q), J(a3), J(w), J(inertia), 0.25)))
    for t, j in pairs:
        _close(t, j, 1e-13)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_no_squish_rotate_matches_jax(k):
    """Each permutation, with one body in five at a zero moment on the
    rotated axis (its rotation frozen: p and q come back unchanged)."""
    rng = np.random.RandomState(10 + k)
    q = _rand(rng, 50, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    p = _rand(rng, 50, 4)
    inertia = rng.uniform(0.5, 5.0, (50, 3))
    inertia[::5, k - 1] = 0.0
    tp, tq = tr.no_squish_rotate(k, torch.as_tensor(p), torch.as_tensor(q),
                                 torch.as_tensor(inertia), 0.3)
    jp, jq = jr.no_squish_rotate(k, jnp.asarray(p), jnp.asarray(q),
                                 jnp.asarray(inertia), 0.3)
    _close(tp, jp, 1e-13)
    _close(tq, jq, 1e-13)
    np.testing.assert_array_equal(tq.numpy()[::5], q[::5])
    np.testing.assert_array_equal(tp.numpy()[::5], p[::5])


def _force(x):
    """A fixed position-dependent force: a harmonic pull to a point plus a
    nonlinear term, so torques act and change with the orientation."""
    c = 6.0
    lib = torch if torch.is_tensor(x) else jnp
    return -0.05 * (x - c) + 0.3 * lib.sin(0.7 * x[:, [1, 2, 0]])


STATE = ("xcm", "vcm", "angmom", "quat", "conjqm", "virial")


def _trajectories(kind, nsteps=10):
    """JAX and port: init_rigid_state + nsteps initial/final pairs under
    _force; lists of dicts of numpy arrays (the state fields, x, v)."""
    from lidp_tpu.box import Box as JBox
    from lidp_tpu.state import make_system as jmake
    from lidp_tpu_torch.box import Box
    from lidp_tpu_torch.state import make_system

    x, mass, mol, in_group = _bodies(kind, seed=4)
    v = np.random.RandomState(5).normal(0, 0.01, x.shape)
    setup = jr.setup_bodies(x, mass, mol, in_group)
    lo, hi = np.zeros(3), np.full(3, 20.0)
    jp = jr.make_rigid_params(setup, DT, FTM2V, mass_atom=mass)
    tp = tr.make_rigid_params(tr.setup_bodies(x, mass, mol, in_group), DT,
                              FTM2V, mass_atom=mass, device="cpu")
    runs = []
    for mod, sys, p in (
            (jr, jmake(x, box=JBox.create(lo, hi, dtype=jnp.float64), v=v,
                       mol=mol, dtype=jnp.float64), jp),
            (tr, make_system(x, box=Box.create(lo, hi), v=v, mol=mol,
                             dtype=torch.float64, device="cpu"), tp)):
        m = jnp.asarray(mass) if mod is jr else torch.as_tensor(mass)
        sys, st = mod.init_rigid_state(sys, _force(sys.x), p, m)
        recs = []
        for k in range(nsteps + 1):
            if k:
                sys, st = mod.initial_integrate(sys, _force(sys.x), p, st)
                sys, st = mod.final_integrate(sys, _force(sys.x), p, st)
            recs.append({**{f: np.asarray(getattr(st, f)) for f in STATE},
                         "x": np.asarray(sys.x), "v": np.asarray(sys.v)})
        runs.append((recs, sys, st, p))
    return runs


@pytest.mark.parametrize("kind", KINDS)
def test_integrator_matches_jax(kind):
    (jrecs, _, jst, _), (trecs, tsys, tst, tp) = _trajectories(kind)
    for k, (j, t) in enumerate(zip(jrecs, trecs)):
        for name in j:
            np.testing.assert_allclose(
                t[name], j[name], rtol=0,
                atol=1e-10 * max(np.abs(j[name]).max(), 1e-300),
                err_msg=f"{kind} step {k} {name}")
    # the JAX state carried across continues as the port's own does
    moved = convert.rigid_state_from_numpy(
        {f.name: np.asarray(getattr(jst, f.name))
         for f in dataclasses.fields(tr.RigidState)}, device="cpu")
    a = tr.initial_integrate(tsys, _force(tsys.x), tp, moved)
    b = tr.initial_integrate(tsys, _force(tsys.x), tp, tst)
    for name in ("x", "v"):
        _close(getattr(a[0], name), getattr(b[0], name).numpy(), 1e-10)
    for name in STATE:
        _close(getattr(a[1], name), getattr(b[1], name).numpy(), 1e-10)


def test_rigid_setup_from_numpy_round_trips():
    j = jr.setup_bodies(*_bodies("free"))
    t = convert.rigid_setup_from_numpy(
        {f.name: np.asarray(getattr(j, f.name))
         for f in dataclasses.fields(jr.RigidSetup)})
    for f in dataclasses.fields(jr.RigidSetup):
        np.testing.assert_array_equal(np.asarray(getattr(t, f.name)),
                                      np.asarray(getattr(j, f.name)))


def test_body_sums_are_repeatable_and_skip_free_atoms():
    """The per-body sums gather through the members table: atoms in no
    body take no part, and a repeated call gives the same bits."""
    x, mass, mol, in_group = _bodies("free", seed=2)
    setup = tr.setup_bodies(x, mass, mol, in_group)
    p = tr.make_rigid_params(setup, DT, FTM2V, mass_atom=mass, device="cpu")
    v = torch.as_tensor(np.random.RandomState(1).normal(size=x.shape))
    s1, s2 = tr._body_sum(v, p), tr._body_sum(v, p)
    assert torch.equal(s1, s2)
    want = np.zeros((setup.nbody, 3))
    for i in np.nonzero(setup.body_of_atom >= 0)[0]:
        want[setup.body_of_atom[i]] += v[i].numpy()
    np.testing.assert_allclose(s1.numpy(), want, rtol=1e-15, atol=1e-15)


# the barostat fields of make_rigid_params and how they compare
BAROSTAT_FIELDS = ("pstat", "p_stop", "p_target", "p_freq", "p_freq_max",
                   "p_chain", "p_flag", "iso", "nktv2p", "dim")


def barostat_fields_match(t, j):
    """The port's RigidParams t against the JAX package's j, field by
    field, exactly; p_start is JAX's unramped p_target."""
    for name in BAROSTAT_FIELDS:
        a, b = getattr(t, name), getattr(j, name)
        if isinstance(a, tuple):
            a = np.asarray(a, np.asarray(b).dtype)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), name)
    np.testing.assert_array_equal(np.asarray(t.p_start),
                                  np.asarray(j.p_target))
    np.testing.assert_array_equal(t.pflag.numpy(), np.asarray(j.p_flag))


@pytest.mark.parametrize("flag", ["pstat"])
def test_thermostat_and_barostat_raise(flag):
    """The case once held the barostat's raise; the barostat is ported
    (tests/test_torch_npt.py), and make_rigid_params(pstat=True) now gives
    the JAX package's barostat fields: an unset dimension's zero period
    keeps p_freq 0, pchain and the coupling ride along."""
    kw = {flag: True, "p_start": (1.0, 2.0, 3.0), "p_stop": (4.0, 5.0, 6.0),
          "p_period": (100.0, 0.0, 300.0), "p_flag": (True, False, True),
          "p_chain": 4, "iso": False, "nktv2p": 68568.415,
          "t_start": 300.0, "t_stop": 310.0, "t_period": 1.0}
    j = jr.make_rigid_params(jr.setup_bodies(*_bodies("bent")), DT, FTM2V,
                             **kw)
    t = tr.make_rigid_params(tr.setup_bodies(*_bodies("bent")), DT, FTM2V,
                             device="cpu", **kw)
    assert t.pstat and not t.tstat
    barostat_fields_match(t, j)
    assert t.p_freq[1] == 0.0 and float(t.p_denom[1]) == 1.0


