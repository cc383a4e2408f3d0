"""The port's panel functions (lidp_tpu_torch/ops/panel.py) against the JAX
Pallas kernels (lidp_tpu/ops/pallas_panel.py, interpret mode on the CPU)
on the same numpy inputs, the port's float64 plain versions against dense
numpy float64 sums, and the f64-grade (`*_df`) functions against the JAX
package's XLA-f64 column-chunk functions, reached through the host phases
of a float64 panel="scan" build (per-row atol 1e-11*max, scalars rel
1e-11; the df32 interpret output holds only f32 grade on the CPU and is no
reference).

On the CPU the wrappers run their plain versions; the CUDA kernels are held
against those plain versions on the GPU by chip_smoke.py.

Tolerances: per-row outputs rtol 1e-4, atol 1e-5*max|ref| and scalars rel
5e-6 between the two float32 implementations (the same arithmetic summed
in a different order); u_dd rel 1e-4, a small difference of large terms.
The float64 plain versions agree with the numpy sums to 1e-12.
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from lidp_tpu.ops import pallas_panel  # noqa: E402
from lidp_tpu_torch.ops import panel  # noqa: E402
from lidp_tpu_torch.ops.pair import (A1, A2, A3, A4, A5, EWALD_F,  # noqa: E402
                                     EWALD_P)

PD = 2.1304
QQRD2E = 332.06371
G_EWALD = 0.29
CUT_COULSQ = 6.5**2


def _tabs():
    """(5, 3, 3) [lj3 lj4 offset cut_ljsq cutsq] of the synthetic fluid's
    LJ tables (types 1, 2; row/col 0 unused), uniform outer cutoff."""
    eps = np.zeros((3, 3))
    sig = np.zeros((3, 3))
    cut = np.zeros((3, 3))
    eps[1:, 1:] = [[0.1, 0.05], [0.05, 0.03]]
    sig[1:, 1:] = [[3.0, 2.7], [2.7, 2.5]]
    cut[1:, 1:] = 6.0
    s6 = sig**6
    return np.stack([4 * eps * s6 * s6, 4 * eps * s6, np.zeros((3, 3)),
                     cut**2, np.maximum(cut, 6.5)**2])


def _case(seed, n=300, npad=512, L=(20.0, 22.0, 24.0), lattice=True,
          with_sp=False):
    """Random atoms with alpha=0 sites, masked padding, a few molecules.
    lattice: jittered grid positions (no sub-2-A contacts, so LJ stays
    moderate); otherwise uniform positions as in test_pallas_panel.py."""
    rng = np.random.RandomState(seed)
    L = np.asarray(L)
    x = np.zeros((npad, 3))
    if lattice:
        g = np.stack(np.meshgrid(*[np.arange(7)] * 3, indexing="ij"),
                     -1).reshape(-1, 3)[:n]
        x[:n] = (g + 0.5) * (L / 7) + rng.uniform(-0.4, 0.4, (n, 3))
    else:
        x[:n] = rng.uniform(0, 1, (n, 3)) * L
    alpha = np.zeros(npad)
    alpha[:n] = rng.uniform(0.5, 2.0, n)
    alpha[:20] = 0.0                       # some non-polarizable atoms
    mu = np.zeros((npad, 3))
    mu[:n] = rng.normal(0, 1e-2, (n, 3))
    mu[alpha == 0.0] = 0.0
    q = np.zeros(npad)
    q[:n] = rng.normal(0, 0.5, n)
    mol = np.zeros(npad)
    mol[:n] = rng.randint(0, 40, n)        # mol 0: no molecule
    typ = np.zeros(npad)
    typ[:n] = rng.randint(1, 3, n)
    mask = np.zeros(npad)
    mask[:n] = 1.0
    c = dict(x=x, alpha=alpha, mu=mu, q=q, mol=mol, type=typ, mask=mask,
             L=L, n=n, npad=npad, sp=None)
    if with_sp:
        # each atom excludes its two nearest live neighbours (in range of
        # the LJ cutoff); unused slots hold n, a masked padded atom
        d = x[:n, None] - x[None, :n]
        d -= L * np.round(d / L)
        r = np.sqrt((d * d).sum(-1)) + np.eye(n) * 1e9
        sp = np.full((npad, 8), n, np.int32)
        sp[:n, :2] = np.argsort(r, axis=1)[:, :2]
        c["sp"] = sp
    return c


CASES = {
    # test_pallas_panel.py:58 eind case (uniform positions)
    "random": dict(seed=3, lattice=False),
    "lattice": dict(seed=11),
    "sp": dict(seed=7, with_sp=True),
}


STRIP = slice(128, 256)     # a row strip with a nonzero row0


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _close_rows(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    sc = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5 * sc)


def _close_scalar(got, ref, rel=5e-6):
    assert float(got) == pytest.approx(float(ref), rel=rel)


# ------------------------------- eind ----------------------------------

def _eind_args(c, conv):
    return (conv(c["x"]), conv(c["alpha"]), conv(c["mu"]), conv(c["L"]), PD)


@pytest.mark.parametrize("name", ["random", "lattice"])
@pytest.mark.parametrize("strip", [False, True])
def test_eind_matches_jax(name, strip):
    c = _case(**CASES[name])
    xj, aj, muj, Lj, pd = _eind_args(c, _j)
    xt, at, mut, Lt, _ = _eind_args(c, _t)
    if strip:
        s = STRIP
        ref = pallas_panel.eind_panel(xj[s], aj[s], muj[s], Lj, pd,
                                      cols=(xj, aj, muj), row0=s.start)
        got = panel.eind_panel(xt[s], at[s], mut[s], Lt, pd,
                               cols=(xt, at, mut), row0=s.start)
        full = panel.eind_panel(xt, at, mut, Lt, pd)
        np.testing.assert_array_equal(got.numpy(), full[s].numpy())
    else:
        ref = pallas_panel.eind_panel(xj, aj, muj, Lj, pd)
        got = panel.eind_panel(xt, at, mut, Lt, pd)
    _close_rows(got.numpy(), ref)


# ----------------------------- pair_wolf --------------------------------

def _pw_args(c, conv):
    return (conv(c["x"]), conv(c["q"]), conv(c["type"]), conv(c["mol"]),
            conv(c["mask"]), conv(_tabs()), conv(c["L"]), CUT_COULSQ,
            QQRD2E, G_EWALD)


def _check_pair_wolf(got, ref):
    f, ev, ec, vir, e0 = got
    rf, rev, rec, rvir, re0 = ref
    _close_rows(f.numpy(), rf)
    _close_rows(e0.numpy(), re0)
    _close_scalar(ev, rev)
    _close_scalar(ec, rec)
    # off-diagonal virial terms are sums that cancel to a small fraction of
    # the diagonal ones; hold them at rel 5e-6 of the diagonal scale
    vsc = np.abs(np.asarray(rvir)[:3]).max()
    np.testing.assert_allclose(vir.numpy(), np.asarray(rvir), rtol=5e-6,
                               atol=5e-6 * vsc)


@pytest.mark.parametrize("name", ["random", "lattice", "sp"])
@pytest.mark.parametrize("strip", [False, True])
def test_pair_wolf_matches_jax(name, strip):
    c = _case(**CASES[name])
    aj = _pw_args(c, _j)
    at = _pw_args(c, _t)
    spj = None if c["sp"] is None else jnp.asarray(c["sp"])
    spt = None if c["sp"] is None else torch.as_tensor(c["sp"])
    if strip:
        s = STRIP
        rows_j = [a[s] for a in aj[:5]]
        rows_t = [a[s] for a in at[:5]]
        ref = pallas_panel.pair_wolf_panel(
            *rows_j, *aj[5:], sp=None if spj is None else spj[s],
            cols=tuple(aj[:5]), row0=s.start)
        got = panel.pair_wolf_panel(
            *rows_t, *at[5:], sp=None if spt is None else spt[s],
            cols=tuple(at[:5]), row0=s.start)
    else:
        ref = pallas_panel.pair_wolf_panel(*aj, sp=spj)
        got = panel.pair_wolf_panel(*at, sp=spt)
    _check_pair_wolf(got, ref)


# ------------------------------ pair, wolf ------------------------------

def _pair_args(c, conv):
    return (conv(c["x"]), conv(c["q"]), conv(c["type"]), conv(c["mask"]),
            conv(_tabs()), conv(c["L"]), CUT_COULSQ, QQRD2E, G_EWALD)


@pytest.mark.parametrize("name", ["lattice", "sp"])
@pytest.mark.parametrize("coul", [True, False])
@pytest.mark.parametrize("strip", [False, True])
def test_pair_matches_jax(name, coul, strip):
    c = _case(**CASES[name])
    aj = _pair_args(c, _j)
    at = _pair_args(c, _t)
    spj = None if c["sp"] is None else jnp.asarray(c["sp"])
    spt = None if c["sp"] is None else torch.as_tensor(c["sp"])
    if strip:
        s = STRIP
        ref = pallas_panel.pair_panel(
            *[a[s] for a in aj[:4]], *aj[4:],
            sp=None if spj is None else spj[s], cols=tuple(aj[:4]),
            row0=s.start, coul=coul)
        got = panel.pair_panel(
            *[a[s] for a in at[:4]], *at[4:],
            sp=None if spt is None else spt[s], cols=tuple(at[:4]),
            row0=s.start, coul=coul)
        full = panel.pair_panel(*at, sp=spt, coul=coul)
        np.testing.assert_array_equal(got[0].numpy(), full[0][s].numpy())
    else:
        ref = pallas_panel.pair_panel(*aj, sp=spj, coul=coul)
        got = panel.pair_panel(*at, sp=spt, coul=coul)
    f, ev, ec, vir = got
    rf, rev, rec, rvir = ref
    _close_rows(f.numpy(), rf)
    _close_scalar(ev, rev)
    if coul:
        _close_scalar(ec, rec)
    else:
        assert float(ec) == 0.0 == float(rec)
    vsc = np.abs(np.asarray(rvir)[:3]).max()
    np.testing.assert_allclose(vir.numpy(), np.asarray(rvir), rtol=5e-6,
                               atol=5e-6 * vsc)


def test_pair_is_pair_wolf_without_the_field():
    c = _case(**CASES["sp"])
    sp = torch.as_tensor(c["sp"])
    pw = panel.pair_wolf_panel(*_pw_args(c, _t), sp=sp)
    pr = panel.pair_panel(*_pair_args(c, _t), sp=sp)
    for a, b in zip(pr, pw[:4]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _wolf_args(c, conv):
    return (conv(c["x"]), conv(c["q"]), conv(c["mol"]), conv(c["mask"]),
            conv(c["L"]), CUT_COULSQ)


@pytest.mark.parametrize("name", ["random", "lattice"])
@pytest.mark.parametrize("strip", [False, True])
def test_wolf_matches_jax(name, strip):
    c = _case(**CASES[name])
    aj = _wolf_args(c, _j)
    at = _wolf_args(c, _t)
    if strip:
        s = STRIP
        ref = pallas_panel.wolf_panel(*[a[s] for a in aj[:4]], *aj[4:],
                                      cols=tuple(aj[:4]), row0=s.start)
        got = panel.wolf_panel(*[a[s] for a in at[:4]], *at[4:],
                               cols=tuple(at[:4]), row0=s.start)
        full = panel.wolf_panel(*at)
        np.testing.assert_array_equal(got.numpy(), full[s].numpy())
    else:
        ref = pallas_panel.wolf_panel(*aj)
        got = panel.wolf_panel(*at)
    _close_rows(got.numpy(), ref)
    # the fused pass of pair_wolf_panel gives the same field
    e0 = panel.pair_wolf_panel(*_pw_args(c, _t))[4]
    _close_rows(e0.numpy(), panel.wolf_panel(*at).numpy())


# ------------------------------- dipole ---------------------------------

def _dp_args(c, conv):
    return (conv(c["x"]), conv(c["q"]), conv(c["mol"]),
            conv(c["alpha"] * c["mask"]), conv(c["mu"]), conv(c["mask"]),
            conv(c["L"]), PD, CUT_COULSQ, QQRD2E)


@pytest.mark.parametrize("name", ["random", "lattice"])
@pytest.mark.parametrize("strip", [False, True])
def test_dipole_matches_jax(name, strip):
    c = _case(**CASES[name])
    aj = _dp_args(c, _j)
    at = _dp_args(c, _t)
    if strip:
        s = STRIP
        ref = pallas_panel.dipole_panel(*[a[s] for a in aj[:6]], *aj[6:],
                                        cols=tuple(aj[:6]), row0=s.start)
        got = panel.dipole_panel(*[a[s] for a in at[:6]], *at[6:],
                                 cols=tuple(at[:6]), row0=s.start)
    else:
        ref = pallas_panel.dipole_panel(*aj)
        got = panel.dipole_panel(*at)
    f, u_ef, u_dd, vir = got
    rf, ru_ef, ru_dd, rvir = ref
    _close_rows(f.numpy(), rf)
    _close_scalar(u_ef, ru_ef)
    _close_scalar(u_dd, ru_dd, rel=1e-4)
    vsc = np.abs(np.asarray(rvir)[:3]).max()
    np.testing.assert_allclose(vir.numpy(), np.asarray(rvir), rtol=5e-6,
                               atol=5e-6 * vsc)


# ------------------- float64 plain vs dense numpy sums -------------------

def _np_geom(x, L):
    d = x[:, None, :] - x[None, :, :]
    d -= L * np.round(d / L)
    return d, (d * d).sum(-1)


def _np_eind(c):
    x, a, mu, L = c["x"], c["alpha"], c["mu"], c["L"]
    d, rsq = _np_geom(x, L)
    pm = (~np.eye(len(x), dtype=bool)) & (a[None, :] != 0) & (a[:, None] != 0)
    rsq = np.where(pm, rsq, 1.0)
    r = np.sqrt(rsq)
    e = np.exp(-PD * r)
    l1 = 1 - e * (1 + PD * r + 0.5 * PD**2 * rsq)
    l2 = l1 - e * PD**3 * rsq * r / 6
    r3inv = 1 / (rsq * r)
    mdotd = (mu[None, :, :] * d).sum(-1)
    a1 = np.where(pm, -3 * l2 * r3inv / rsq * mdotd, 0.0)
    a2 = np.where(pm, l1 * r3inv, 0.0)
    return -(a1[..., None] * d + a2[..., None] * mu[None, :, :]).sum(1)


def _np_erfc(x):
    t = 1 / (1 + EWALD_P * x)
    return t * (A1 + t * (A2 + t * (A3 + t * (A4 + t * A5)))) * np.exp(-x * x)


def _np_pair_wolf(c):
    x, q, mol, mask, L = c["x"], c["q"], c["mol"], c["mask"], c["L"]
    tabs = _tabs()
    ti = c["type"].astype(int)
    d, rsq = _np_geom(x, L)
    npad = len(x)
    pm = (~np.eye(npad, dtype=bool)) & (mask[None, :] != 0)
    rsq = np.where(pm, rsq, 1.0)
    lj3, lj4, off, cutlj = (tabs[k][ti[:, None], ti[None, :]]
                            for k in range(4))
    inr = pm & (rsq < tabs[4].max())
    ljm = inr & (rsq < cutlj)
    if c["sp"] is not None:
        for s in range(c["sp"].shape[1]):
            ljm &= c["sp"][:, s:s + 1] != np.arange(npad)[None, :]
    r6 = rsq**-3
    flj = np.where(ljm, r6 * (12 * lj3 * r6 - 6 * lj4), 0.0)
    evdwl = np.where(ljm, r6 * (lj3 * r6 - lj4) - off, 0.0)
    r = np.sqrt(rsq)
    cm = inr & (rsq < CUT_COULSQ)
    gr = G_EWALD * r
    pref = QQRD2E * q[:, None] * q[None, :] / r
    fc = np.where(cm, pref * (_np_erfc(gr) + EWALD_F * gr * np.exp(-gr**2)),
                  0.0)
    ecoul = np.where(cm, pref * _np_erfc(gr), 0.0)
    fpair = (fc + flj) / rsq
    p = fpair[..., None] * d
    vir = 0.5 * np.array([
        (p[..., 0] * d[..., 0]).sum(), (p[..., 1] * d[..., 1]).sum(),
        (p[..., 2] * d[..., 2]).sum(), (p[..., 0] * d[..., 1]).sum(),
        (p[..., 0] * d[..., 2]).sum(), (p[..., 1] * d[..., 2]).sum()])
    winc = pm & (rsq <= CUT_COULSQ) & ((mol[:, None] != mol[None, :])
                                       | (mol[:, None] == 0))
    efq = np.where(winc, (1 / rsq - 1 / CUT_COULSQ) / r, 0.0) * q[None, :]
    return (p.sum(1), 0.5 * evdwl.sum(), 0.5 * ecoul.sum(), vir,
            (efq[..., None] * d).sum(1))


def _np_dipole(c):
    x, q, mol, mask, L, mu = (c["x"], c["q"], c["mol"], c["mask"], c["L"],
                              c["mu"])
    a = c["alpha"] * mask
    d, rsq = _np_geom(x, L)
    npad = len(x)
    pm = (~np.eye(npad, dtype=bool)) & (mask[None, :] != 0)
    rsq = np.where(pm, rsq, 1.0)
    r = np.sqrt(rsq)
    sq = np.sqrt(QQRD2E)
    fs = -1 / CUT_COULSQ
    cd = pm & (rsq < CUT_COULSQ) & ((mol[:, None] != mol[None, :])
                                    | (mol[:, None] == 0))
    # shifted-force tensor M (3x3 per pair) applied to both dipoles
    eye = np.eye(3)
    dd_ = d[..., :, None] * d[..., None, :]
    M = (eye * rsq[..., None, None] - 3 * dd_) / rsq[..., None, None] \
        + fs * (eye * rsq[..., None, None] - dd_)
    r3 = 1 / (rsq * r)
    cf_j = np.where(cd, q[None, :] * sq * r3, 0.0)
    cf_i = np.where(cd, q[:, None] * sq * r3, 0.0)
    fcd = cf_j[..., None] * np.einsum("ijab,ib->ija", M, mu) \
        - cf_i[..., None] * np.einsum("ijab,jb->ija", M, mu)
    ef_t = np.where(cd, (1 / rsq + fs) / r * sq, 0.0) * q[None, :]
    u_ef = -(mu[:, None, :] * ef_t[..., None] * d).sum()
    dd = pm & (a[:, None] != 0) & (a[None, :] != 0)
    pdotp = mu @ mu.T
    pi = (mu[:, None, :] * d).sum(-1)
    pj = (mu[None, :, :] * d).sum(-1)
    t1 = np.exp(-PD * r)
    t2 = 1 + PD * r + 0.5 * PD**2 * rsq
    t3 = t2 + PD**3 * rsq * r / 6
    r5 = r3 / rsq
    r7 = r5 / rsq
    pre1 = 3 * r5 * pdotp * (1 - t1 * t2) - 15 * r7 * pi * pj * (1 - t1 * t3)
    pre1 += -pdotp * r3 * (-t1 * (PD / r + PD**2) + t1 * PD * t2 / r)
    pre1 += 3 * pi * pj * r5 * (-t1 * (PD / r + PD**2 + 0.5 * r * PD**3)
                                + t1 * PD * t3 / r)
    pre2 = 3 * r5 * pj * (1 - t1 * t3)
    pre3 = 3 * r5 * pi * (1 - t1 * t3)
    u_pair = r3 * pdotp * (1 - t1 * t2) - 3 * r5 * pi * pj * (1 - t1 * t3)
    fp = fcd + np.where(dd, pre1, 0.0)[..., None] * d \
        + np.where(dd, pre2, 0.0)[..., None] * mu[:, None, :] \
        + np.where(dd, pre3, 0.0)[..., None] * mu[None, :, :]
    u_dd = 0.5 * np.where(dd, u_pair, 0.0).sum()
    vir = 0.5 * np.array([
        (d[..., 0] * fp[..., 0]).sum(), (d[..., 1] * fp[..., 1]).sum(),
        (d[..., 2] * fp[..., 2]).sum(), (d[..., 0] * fp[..., 1]).sum(),
        (d[..., 0] * fp[..., 2]).sum(), (d[..., 1] * fp[..., 2]).sum()])
    return fp.sum(1), u_ef, u_dd, vir


def _close64(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=1e-12,
                               atol=1e-12 * max(np.abs(ref).max(), 1e-300))


@pytest.mark.parametrize("name", ["random", "sp"])
def test_plain_f64_vs_numpy(name):
    c = _case(**CASES[name])
    f64 = torch.float64
    conv = lambda a: _t(a, f64)  # noqa: E731
    got = panel.eind_panel_plain(*_eind_args(c, conv), chunk=200)
    _close64(got.numpy(), _np_eind(c))
    sp = None if c["sp"] is None else torch.as_tensor(c["sp"])
    got = panel.pair_wolf_panel_plain(*_pw_args(c, conv), sp=sp, chunk=200)
    for g, r in zip(got, _np_pair_wolf(c)):
        _close64(g.numpy(), r)
    got = panel.dipole_panel_plain(*_dp_args(c, conv), chunk=200)
    for g, r in zip(got, _np_dipole(c)):
        _close64(g.numpy(), r)


# ------- the f64-grade functions against the JAX XLA-f64 scan path -------

@pytest.fixture(scope="module", params=["random", "lattice"])
def scan64(request):
    """JAX host phases of a float64 panel="scan" build over the case's
    atoms (its _pair_chunk, _wolf_chunk, _tensor_apply_chunk and
    _dipole_chunk), no special lists, with the case itself."""
    import jax

    from lidp_tpu.forcefield import ForceField
    from lidp_tpu.ops import polarization as pol
    from lidp_tpu.ops.pair import make_pair_params
    from lidp_tpu.parallel import shard

    c = _case(**CASES[request.param])
    eps = np.zeros((3, 3))
    sig = np.zeros((3, 3))
    cut = np.zeros((3, 3))
    eps[1:, 1:] = [[0.1, 0.05], [0.05, 0.03]]
    sig[1:, 1:] = [[3.0, 2.7], [2.7, 2.5]]
    cut[1:, 1:] = 6.0
    pair = make_pair_params(eps, sig, cut, cut_coul=6.5, coul=True,
                            qqrd2e=QQRD2E, g_ewald=G_EWALD,
                            dtype=jnp.float64)
    s = pol.PolarizationSettings(damping_type=pol.DAMPING_EXPONENTIAL,
                                 polar_damp=PD)
    ff = ForceField(pair=pair, ewald=None, polar=s, qqrd2e=QQRD2E)
    make, bind_box, npad, _ = shard.build_sharded_polar_step(
        None, ff, s, n=c["n"], dt=1.0, ftm2v=1.0, dtype=jnp.float64,
        panel="scan")
    assert npad == c["npad"]
    bind_box(c["L"])
    tabs = np.stack([np.asarray(getattr(pair, k)) for k in
                     ("lj3", "lj4", "offset", "cut_ljsq", "cutsq")])
    j64 = lambda a: jnp.asarray(np.asarray(a, np.float64))  # noqa: E731
    ja = dict(x=j64(c["x"]), q=j64(c["q"]), alpha=j64(c["alpha"]),
              mu=j64(c["mu"]), type=jnp.asarray(c["type"].astype(np.int32)),
              mol=jnp.asarray(c["mol"].astype(np.int32)),
              mask=jnp.asarray(c["mask"] != 0))
    assert jax.config.jax_enable_x64
    return c, make.host_phases(1), ja, tabs


def _t64(a):
    return _t(a, torch.float64)


def _close_df_rows(got, ref):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=0,
                               atol=1e-11 * np.abs(ref).max())


def _close_df_scalar(got, ref):
    assert float(got) == pytest.approx(float(ref), rel=1e-11)


def test_eind_df_matches_jax_scan(scan64):
    c, ph, ja, _ = scan64
    ref = ph["eind"](ja["x"], ja["alpha"], ja["mask"], ja["mu"])
    ae = c["alpha"] * c["mask"]
    got = panel.eind_panel_df(_t64(c["x"]), _t64(ae), _t64(c["mu"]),
                              _t64(c["L"]), PD)
    _close_df_rows(got.numpy(), ref)
    s = STRIP
    strip = panel.eind_panel_df(
        _t64(c["x"])[s], _t64(ae)[s], _t64(c["mu"])[s], _t64(c["L"]), PD,
        cols=(_t64(c["x"]), _t64(ae), _t64(c["mu"])), row0=s.start)
    np.testing.assert_array_equal(strip.numpy(), got[s].numpy())


@pytest.mark.parametrize("with_mol", [False, True])
def test_pair_df_matches_jax_scan(scan64, with_mol):
    c, ph, ja, tabs = scan64
    rf, rev, rec, _, rvir = ph["pair_real"](ja["x"], ja["q"], ja["type"],
                                            ja["mask"])
    args = (_t64(c["x"]), _t64(c["q"]), _t64(c["type"]), _t64(c["mask"]),
            _t64(tabs), _t64(c["L"]), CUT_COULSQ, QQRD2E, G_EWALD)
    mol = _t64(c["mol"]) if with_mol else None
    got = panel.pair_panel_df(*args, mol=mol)
    assert len(got) == (5 if with_mol else 4)
    _close_df_rows(got[0].numpy(), rf)
    _close_df_scalar(got[1], rev)
    _close_df_scalar(got[2], rec)
    rvir = np.asarray(rvir)
    np.testing.assert_allclose(got[3].numpy(), rvir, rtol=1e-11,
                               atol=1e-11 * np.abs(rvir[:3]).max())
    s = STRIP
    cols = args[:4] + ((mol,) if with_mol else ())
    strip = panel.pair_panel_df(*[a[s] for a in args[:4]], *args[4:],
                                mol=None if mol is None else mol[s],
                                cols=cols, row0=s.start)
    np.testing.assert_array_equal(strip[0].numpy(), got[0][s].numpy())
    if with_mol:
        re0 = ph["wolf"](ja["x"], ja["q"], ja["mol"], ja["mask"])
        _close_df_rows(got[4].numpy() * np.sqrt(QQRD2E), re0)
        np.testing.assert_array_equal(strip[4].numpy(), got[4][s].numpy())
        _close_df_rows(panel.wolf_panel_plain(
            _t64(c["x"]), _t64(c["q"]), mol, _t64(c["mask"]), _t64(c["L"]),
            CUT_COULSQ).numpy() * np.sqrt(QQRD2E), re0)


def test_dipole_df_matches_jax_scan(scan64):
    c, ph, ja, _ = scan64
    rf, repol, _ = ph["dipole"](ja["x"], ja["q"], ja["mol"], ja["alpha"],
                                ja["mu"], ja["mask"])
    args = _dp_args(c, _t64)
    f, u_ef, u_dd, _ = panel.dipole_panel_df(*args)
    _close_df_rows(f.numpy(), rf)
    a = c["alpha"]
    u_self = 0.5 * np.sum((c["mu"] ** 2).sum(1)[a != 0] / a[a != 0])
    _close_df_scalar(u_self + float(u_ef) + float(u_dd), repol)
    s = STRIP
    strip = panel.dipole_panel_df(*[t[s] for t in args[:6]], *args[6:],
                                  cols=tuple(args[:6]), row0=s.start)
    np.testing.assert_array_equal(strip[0].numpy(), f[s].numpy())


# ------------------------------ the wrappers ------------------------------

def _all_calls(c, conv32, conv64):
    """One call of every wrapper on case c, by name."""
    tabs64 = conv64(_tabs())
    pa = _pair_args(c, conv64)
    return {
        "eind_panel": lambda: panel.eind_panel(*_eind_args(c, conv32)),
        "pair_wolf_panel": lambda: panel.pair_wolf_panel(
            *_pw_args(c, conv32)),
        "dipole_panel": lambda: panel.dipole_panel(*_dp_args(c, conv32)),
        "pair_panel": lambda: panel.pair_panel(*_pair_args(c, conv32)),
        "wolf_panel": lambda: panel.wolf_panel(*_wolf_args(c, conv32)),
        "eind_panel_df": lambda: panel.eind_panel_df(
            *_eind_args(c, conv64)),
        "pair_panel_df": lambda: panel.pair_panel_df(
            *pa[:4], tabs64, *pa[5:], mol=conv64(c["mol"])),
        "dipole_panel_df": lambda: panel.dipole_panel_df(
            *_dp_args(c, conv64)),
    }


def test_wrappers_run_plain_on_cpu_without_counting():
    c = _case(**CASES["lattice"])
    before = {k: w.launches for k, w in panel.WRAPPERS.items()}
    args = _eind_args(c, _t)
    np.testing.assert_array_equal(panel.eind_panel(*args).numpy(),
                                  panel.eind_panel_plain(*args).numpy())
    calls = _all_calls(c, _t, _t64)
    assert sorted(calls) == sorted(panel.WRAPPERS)
    for call in calls.values():
        call()
    assert {k: w.launches for k, w in panel.WRAPPERS.items()} == before


@pytest.mark.parametrize("name", sorted(panel.WRAPPERS))
def test_wrappers_never_fall_back_off_the_cpu(name):
    """A tensor on any device other than the CPU goes to the kernel or
    raises; the plain version is never a fallback."""
    c = _case(**CASES["lattice"], n=40, npad=64)
    meta32 = lambda a: _t(a).to("meta")  # noqa: E731
    meta64 = lambda a: _t64(a).to("meta")  # noqa: E731
    with pytest.raises(ValueError, match="no kernel"):
        _all_calls(c, meta32, meta64)[name]()
