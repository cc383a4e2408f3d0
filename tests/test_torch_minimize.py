"""The minimizers of lidp_tpu_torch/integrate/minimize.py against the JAX
package's (lidp_tpu/integrate/minimize.py), float64 on the CPU, both in one
process.

Each of fire, cg, sd and quickmin starts from the same numpy state and
runs 20 iterations (etol 0, ftol 1e-12, so no test stops them early):
the JAX function with the JAX package's compute_forces, the port's with
the port's, each force field built by its package's LammpsScript and
Simulation from one LAMMPS input:
  * 2d: the 72-atom sq2 case of tests/test_min_styles.py (displace_atoms
    random from a bit-exact RanPark stream, fix enforce2d);
  * 3d: 108 atoms of fcc LJ displaced by up to 0.2 sigma.
Both must take the same number of iterations; x agrees within 1e-9 and
the energy within rel 1e-10.  hftn is held so after quickmin (at ftol
1e-6) and, from the far start, to the same minimum: its iterates there
part by the two packages' rounding, amplified
(test_hftn_reaches_jax_minimum).  Also: the
Hessian-vector product that hftn takes from forward-mode AD against the
JAX package's jax.jvp, and the min styles' names.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
# one torch thread, for time, as the port's other parity files
torch.set_num_threads(1)

from lidp_tpu import forcefield as jff  # noqa: E402
from lidp_tpu import sim as jsim  # noqa: E402
from lidp_tpu.integrate import minimize as jmin  # noqa: E402
from lidp_tpu.io import script as jscript  # noqa: E402
from lidp_tpu_torch import convert  # noqa: E402
from lidp_tpu_torch import forcefield as tff  # noqa: E402
from lidp_tpu_torch import sim as tsim  # noqa: E402
from lidp_tpu_torch.integrate import minimize as tmin  # noqa: E402
from lidp_tpu_torch.io import script as tscript  # noqa: E402

X_TOL = 1e-9
E_REL = 1e-10
MAXITER = 20
FTOL = 1e-12

CASES = {
    "2d": """units lj
dimension 2
atom_style atomic
lattice sq2 0.8442
region box block 0 6 0 6 -0.1 0.1
create_box 1 box
create_atoms 1 box
mass 1 1.0
pair_style lj/cut 2.5
pair_coeff 1 1 1.0 1.0 2.5
pair_modify shift yes
displace_atoms all random 0.15 0.15 0 424242
fix 2 all enforce2d
""",
    "3d": """units lj
atom_style atomic
lattice fcc 0.8442
region box block 0 3 0 3 0 3
create_box 1 box
create_atoms 1 box
mass 1 1.0
pair_style lj/cut 2.5
pair_coeff 1 1 1.0 1.0 2.5
displace_atoms all random 0.1 0.1 0.1 87287
""",
}
STYLES = ("fire", "cg", "sd", "quickmin", "hftn")
# hftn: its ftol, above the force norm at which its Armijo test compares
# energies at their rounding (test_hftn_matches_jax), and its start, the
# state after this many quickmin iterations
HFTN_FTOL = 1e-6
QUICKMIN_START = 50


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """Both packages' Simulations of one case, their compute functions
    (forces and E_pair, as `minimize` evaluates them) and the start."""
    text = CASES[request.param].splitlines()
    js = jscript.LammpsScript(dtype=jnp.float64, log=lambda line: None)
    js.execute(text)
    ts = tscript.LammpsScript(dtype=torch.float64, device="cpu",
                              log=lambda line: None)
    ts.execute(text)
    jsm = jsim.Simulation.from_script(js)
    tsm = tsim.Simulation.from_script(ts)
    jff_, tff_ = jsm.runner.ff, tsm.runner.ff

    def jcompute(s):
        res = jff.compute_forces(s, jff_)
        return res.f, res.epair

    def tcompute(s):
        res = tff.compute_forces(s, tff_)
        return res.f, res.epair

    jsys = jsm.sys
    tsys = convert.system_from_numpy(
        dict({k: np.asarray(getattr(jsys, k)) for k in
              ("x", "v", "q", "type", "mol", "alpha", "mu", "image",
               "mask")}, box=dict(lo=np.asarray(jsys.box.lo),
                                  hi=np.asarray(jsys.box.hi))), device="cpu")
    mass = js.mass_type[js.type]
    return dict(name=request.param, jsys=jsys, tsys=tsys, jc=jcompute,
                tc=tcompute, mass=mass, dt=js.dt)


def _run(style, pkg, c, x0=None, ftol=FTOL, maxiter=MAXITER):
    mod, compute, sys_ = ((jmin, c["jc"], c["jsys"]) if pkg == "jax"
                          else (tmin, c["tc"], c["tsys"]))
    if x0 is not None:
        sys_ = sys_.replace(x=jnp.asarray(x0) if pkg == "jax"
                            else torch.as_tensor(x0))
    kw = dict(etol=0.0, ftol=ftol, maxiter=maxiter)
    mass = (jnp.asarray(c["mass"], jnp.float64) if pkg == "jax"
            else c["mass"])
    if style == "fire":
        fn = lambda s: mod.fire_minimize(s, compute, mass, **kw)  # noqa
    elif style == "quickmin":
        fn = lambda s: mod.quickmin_minimize(  # noqa: E731
            s, compute, mass, dt=c["dt"], dmax=0.1, ftm2v=1.0, **kw)
    elif style == "hftn":
        fn = lambda s: mod.hftn_minimize(s, compute, dmax=0.1, **kw)  # noqa
    else:
        fn = lambda s: mod.cg_minimize(  # noqa: E731
            s, compute, dmax=0.1, style=style, **kw)
    if pkg == "jax":
        fn = jax.jit(fn)
    sys2, e, it, conv = fn(sys_)
    return np.asarray(sys2.x), float(e), int(it), bool(conv)


@pytest.mark.parametrize("style", STYLES[:4])
def test_minimizer_matches_jax(case, style):
    jx, je, jit_, jconv = _run(style, "jax", case)
    tx, te, tit, tconv = _run(style, "torch", case)
    what = f"{case['name']} {style}"
    assert tit == jit_, what
    assert tconv == jconv, what
    err = float(np.abs(tx - jx).max())
    assert err <= X_TOL, f"{what}: x off by {err!r}"
    assert te == pytest.approx(je, rel=E_REL), what
    # it moved: the energy fell from the start's
    _, e0 = case["tc"](case["tsys"])
    assert te < float(e0), what
    if case["name"] == "2d":
        assert np.all(tx[:, 2] == 0.0), what


def test_hftn_matches_jax(case):
    """hftn after quickmin (the order of tests/test_min_styles.py): from
    the JAX quickmin's state after QUICKMIN_START iterations, 20 hftn
    iterations at most, ftol 1e-6: the same iteration count, converged, x
    within 1e-9, E at rel 1e-10.  Near the minimum the Armijo test
    compares energies at their rounding and the two packages'
    backtracking parts there, so a tight ftol would stop them after
    different counts; hence ftol 1e-6."""
    x0, _, _, _ = _run("quickmin", "jax", case, maxiter=QUICKMIN_START)
    jx, je, jit_, jconv = _run("hftn", "jax", case, x0, ftol=HFTN_FTOL)
    tx, te, tit, tconv = _run("hftn", "torch", case, x0, ftol=HFTN_FTOL)
    what = case["name"]
    assert tit == jit_ and tconv and jconv, (what, tit, jit_)
    assert 0 < tit < MAXITER, what
    assert float(np.abs(tx - jx).max()) <= X_TOL, what
    assert te == pytest.approx(je, rel=E_REL), what


def test_hftn_reaches_jax_minimum(case):
    """hftn from the far start, as the other styles run: its inner CG
    amplifies the two packages' rounding differences (XLA's fused
    arithmetic and its reduction order against torch's) where the
    Hessian is indefinite, with no decision near a tie, so the iterates
    are not held.  Both must converge (ftol 1e-8) to the same minimum: x
    within 1e-9 and E at rel 1e-10 (the iteration counts may differ,
    where an Armijo test backtracks at the energy's rounding)."""
    jx, je, jit_, jconv = _run("hftn", "jax", case, ftol=1e-8, maxiter=100)
    tx, te, tit, tconv = _run("hftn", "torch", case, ftol=1e-8,
                              maxiter=100)
    assert jconv and tconv and tit < 100 and jit_ < 100, (tit, jit_)
    assert float(np.abs(tx - jx).max()) <= X_TOL, case["name"]
    assert te == pytest.approx(je, rel=E_REL), case["name"]


def test_hvp_matches_jax_jvp(case):
    """hftn's H.d: the tangent of -f along d by torch's forward-mode AD
    through the port's dense route, against jax.jvp through the JAX
    package's, at the start and a random d."""
    d = np.random.default_rng(5).standard_normal(case["tsys"].x.shape)
    if case["name"] == "2d":
        d[:, 2] = 0.0
    jsys = case["jsys"]

    def grad_e(x):
        return -case["jc"](jsys.replace(x=x))[0]

    want = np.asarray(jax.jvp(grad_e, (jsys.x,), (jnp.asarray(d),))[1])
    got = tmin.hvp(case["tsys"], case["tc"], case["tsys"].x,
                   torch.as_tensor(d)).numpy()
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= 1e-10 * scale
    assert scale > 0.0


def test_min_styles_named():
    assert tscript.MIN_STYLES == STYLES
    s = tscript.LammpsScript(device="cpu")
    assert s._min_style == "cg"
    for style in STYLES:
        s.one(f"min_style {style}")
        assert s._min_style == style
    with pytest.raises(ValueError, match="unsupported min_style"):
        s.one("min_style fire/old")
