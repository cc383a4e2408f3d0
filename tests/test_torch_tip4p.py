"""The port's TIP4P styles (lidp_tpu_torch/ops/tip4p.py: make_tip4p_params,
charge_sites, redistribute, tip4p_coul_dense; the five tip4p pair styles
with pppm/tip4p and pppm/disp/tip4p from a script) against the JAX
package's, float64 on the CPU, both sides in one process:

  * charge_sites, redistribute and tip4p_coul_dense (modes long and cut,
    special factors 0 / 0 / 0.5 on the O-H and H-H pairs, one atom
    masked) on a seeded box of 27 flexible waters, the TIP4P parameters
    carried across by convert.tip4p_from_numpy: within 1e-12 of each
    output's largest entry; redistribute, the port's gather, gives the
    same bits twice and conserves the total force;
  * the five cases of tests/test_tip4p_cut.py (scripts/gen_tip4p_goldens
    .py's 8-molecule box, run 5, a row each step) and lj/cut/tip4p/long
    with pppm/tip4p on the same box: the port's rows within rel 1e-8 of
    max(1, |value|) of JAX's, final x and v within 1e-8; the five against
    the LAMMPS rows GOLDEN at that test's own tolerances;
  * TIP4P above the dense cap (mocked to 20 in both packages) raises the
    JAX package's NotImplementedError in both.
"""

import math

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
# one torch thread, for time: under pytest-xdist torch's threads spin on
# the cores the other workers use
torch.set_num_threads(1)

from lidp_tpu.box import Box as JBox  # noqa: E402
from lidp_tpu.ops import tip4p as jtip4p  # noqa: E402
from lidp_tpu_torch import convert  # noqa: E402
from lidp_tpu_torch import topology  # noqa: E402
from lidp_tpu_torch.box import Box  # noqa: E402
from lidp_tpu_torch.ops import tip4p as ttip4p  # noqa: E402
from scripts.gen_tip4p_goldens import (CASES, QDIST, R0, THETA0,  # noqa: E402
                                       make_input, write_water_data)
from tests.test_tip4p_cut import COLS, GOLDEN  # noqa: E402
from tests.torch_kspace_cases import close, run, rows_match  # noqa: E402

ALPHA = QDIST / (math.cos(0.5 * math.radians(THETA0)) * R0)


@pytest.fixture(scope="module")
def water():
    """27 waters on a jittered 3^3 grid in a 9.3 A box (O type 1, H type
    2, tags = index + 1, O then its two H), q -1.1128 / 0.5564."""
    rng = np.random.RandomState(5)
    L, nside = 9.3, 3
    th = math.radians(THETA0)
    h1 = np.array([R0 * math.sin(th / 2), R0 * math.cos(th / 2), 0.0])
    h2 = np.array([-R0 * math.sin(th / 2), R0 * math.cos(th / 2), 0.0])
    x, typ, q, bonds = [], [], [], []
    for m in range(nside ** 3):
        o = (np.array([m % 3, (m // 3) % 3, m // 9]) + 0.5) * (L / nside) \
            + rng.uniform(-0.3, 0.3, 3)
        a, b = rng.uniform(0, 2 * math.pi, 2)
        rz = np.array([[math.cos(a), -math.sin(a), 0],
                       [math.sin(a), math.cos(a), 0], [0, 0, 1]])
        rx = np.array([[1, 0, 0], [0, math.cos(b), -math.sin(b)],
                       [0, math.sin(b), math.cos(b)]])
        rot = rz @ rx
        x += [o, o + rot @ h1, o + rot @ h2]
        typ += [1, 2, 2]
        q += [-1.1128, 0.5564, 0.5564]
        bonds += [(3 * m, 3 * m + 1), (3 * m, 3 * m + 2)]
    x = np.array(x) % L
    n = len(x)
    mask = np.ones(n, bool)
    mask[-1] = False
    code = topology.special_codes_dense(n, np.array(bonds))
    return dict(x=x, type=np.array(typ), q=np.array(q), mask=mask, L=L,
                code=code, n=n)


@pytest.fixture(scope="module")
def params(water):
    w = water
    jp = jtip4p.make_tip4p_params(w["type"], np.arange(1, w["n"] + 1), 1, 2,
                                  ALPHA)
    tp = ttip4p.make_tip4p_params(w["type"], np.arange(1, w["n"] + 1), 1, 2,
                                  ALPHA)
    conv = convert.tip4p_from_numpy(
        {k: np.asarray(getattr(jp, k)) for k in ("h1", "h2", "is_o",
                                                 "alpha")}, device="cpu")
    for k in ("h1", "h2", "is_o", "o_of", "is_h"):
        assert torch.equal(getattr(tp, k), getattr(conv, k)), k
    assert tp.alpha == conv.alpha == ALPHA
    return jp, tp


def _boxes(L):
    return (JBox.create([0.0] * 3, [L] * 3, dtype=jnp.float64),
            Box.create([0.0] * 3, [L] * 3, dtype=torch.float64))


def test_charge_sites_match_jax(water, params):
    jp, tp = params
    jb, tb = _boxes(water["L"])
    want = np.asarray(jtip4p.charge_sites(jnp.asarray(water["x"]), jb, jp))
    got = ttip4p.charge_sites(torch.as_tensor(water["x"]), tb, tp)
    close(got, want, 1e-12, "sites")
    moved = np.abs(want - water["x"]).max(axis=1) > 0
    np.testing.assert_array_equal(moved, water["type"] == 1)


def test_redistribute_matches_jax(water, params):
    jp, tp = params
    f = np.random.RandomState(9).normal(size=(water["n"], 3))
    want = np.asarray(jtip4p.redistribute(jnp.asarray(f), jp))
    got = ttip4p.redistribute(torch.as_tensor(f), tp)
    close(got, want, 1e-12, "f")
    assert torch.equal(got, ttip4p.redistribute(torch.as_tensor(f), tp))
    np.testing.assert_allclose(got.sum(0).numpy(), f.sum(0), rtol=1e-12)


@pytest.mark.parametrize("mode", ["long", "cut"])
def test_tip4p_coul_dense_matches_jax(water, params, mode):
    jp, tp = params
    jb, tb = _boxes(water["L"])
    sc = [1.0, 0.0, 0.0, 0.5]
    g = 0.31 if mode == "long" else 0.0
    w = water
    fj, ej, vj = (np.asarray(v) for v in jtip4p.tip4p_coul_dense(
        jnp.asarray(w["x"]), jnp.asarray(w["q"]), jnp.asarray(w["code"]),
        jnp.asarray(w["mask"]), jb, 4.0**2, g, 332.06371, jnp.asarray(sc),
        jp, mode=mode))
    f, e, v = ttip4p.tip4p_coul_dense(
        torch.as_tensor(w["x"]), torch.as_tensor(w["q"]),
        torch.as_tensor(w["code"]), torch.as_tensor(w["mask"]), tb, 4.0**2,
        g, 332.06371, torch.tensor(sc, dtype=torch.float64), tp, mode=mode)
    close(f, fj, 1e-12, "f")
    assert abs(float(e) - float(ej)) <= 1e-12 * abs(float(ej))
    close(v, vj, 1e-12, "virial")
    assert abs(float(ej)) > 1.0


# ------------------------------ the scripts -------------------------------

@pytest.fixture(scope="module")
def waterbox(tmp_path_factory):
    d = tmp_path_factory.mktemp("tip4p")
    write_water_data(str(d / "data.tip4p"))
    return d


# the fifth style, lj/cut/tip4p/long, which the LAMMPS rows lack: JAX's
# rows alone
LJCUT_LONG = "ljcuttip4plong"


def _text(case, d):
    if case == LJCUT_LONG:
        text = make_input("tip4plong").replace(
            f"pair_style tip4p/long 1 2 1 1 {QDIST} 5.0\npair_coeff * *",
            "\n".join(CASES["ljtip4pcut"][:3]).replace(
                "lj/cut/tip4p/cut", "lj/cut/tip4p/long"))
        assert "lj/cut/tip4p/long" in text and "pppm/tip4p" in text
    else:
        text = make_input(case)
    return text.replace("read_data data.tip4p", f"read_data {d}/data.tip4p")


@pytest.fixture(scope="module")
def runs(waterbox):
    return {case: tuple(run(pkg, waterbox, _text(case, waterbox),
                            name=f"{case}.{pkg}")
                        for pkg in ("jax", "torch"))
            for case in sorted(GOLDEN) + [LJCUT_LONG]}


@pytest.mark.parametrize("case", sorted(GOLDEN) + [LJCUT_LONG])
def test_script_matches_jax(runs, case):
    js, ts = runs[case]
    ff = ts._sim.runner.ff
    assert ff.tip4p is not None and ts._sim.runner.neighbor_cfg is None
    assert ff.tip4p_cut == (case in ("tip4pcut", "ljtip4pcut"))
    assert ff.tip4p.alpha == pytest.approx(ALPHA, rel=1e-15)
    assert (ff.pppm_disp is not None) == (case == "ljlongtip4p_long")
    assert len(ts.thermo_rows) == 6
    rows_match(case, ts, js, cols=COLS)


@pytest.mark.parametrize("case", sorted(GOLDEN))
def test_script_matches_lammps(runs, case):
    """The port's rows against tests/test_tip4p_cut.py's LAMMPS rows at
    that test's tolerances (the mesh band for the k-space cases)."""
    _, ts = runs[case]
    got = {int(r["step"]): r for r in ts.thermo_rows}
    for ref in GOLDEN[case]:
        r = got[int(ref[0])]
        for name, g in zip(COLS, ref[1:]):
            tol = dict(rel=2e-5, abs=2e-6)
            if case in ("tip4plong", "ljlongtip4p_cut", "ljlongtip4p_long"):
                tol = (dict(rel=5e-2, abs=25.0) if name == "press"
                       else dict(rel=1e-3, abs=0.2))
            assert float(r[name]) == pytest.approx(g, **tol), (case, name)


def test_tip4p_above_the_cap_raises(waterbox):
    text = _text("tip4plong", waterbox)
    for pkg in ("jax", "torch"):
        with pytest.raises(NotImplementedError,
                           match=r"TIP4P pair styles run the dense path only "
                                 r"\(n <= 20\)"):
            run(pkg, waterbox, text, cap=20, name=f"cap.{pkg}")


def test_cases_cover_every_style():
    styles = {line.split()[1] for c in CASES.values() for line in c
              if line.startswith("pair_style")}
    assert styles | {"lj/cut/tip4p/long"} == {
        "tip4p/cut", "lj/cut/tip4p/cut", "tip4p/long", "lj/long/tip4p/long",
        "lj/cut/tip4p/long"}
