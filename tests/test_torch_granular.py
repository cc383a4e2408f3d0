"""The port's granular pieces (lidp_tpu_torch/ops/granular.py,
integrate/gran_runner.py's walls, pour.py) against the JAX package's
(lidp_tpu/ops/granular.py, integrate/gran_runner.py, pour.py), float64 on
the CPU, from numpy inputs made from a seed:

  * gran_cell_forces for gran/hooke, hooke/history and hertz/history on
    60 overlapping spheres in a periodic box (one open face in one case),
    with a frozen subset and an exclude group, the shear update on and
    off and need_ev's virial: forces, torques, the shear history and the
    virial within 1e-10 of their largest entry; on the same Cells (the
    grids' slots equal) and a history zero off the candidate pairs, which
    the pass and migrate_shear keep so;
  * migrate_shear across a rebuild that moves a third of the atoms;
  * wall_contact_force for the three kinds against a zplane, a zcylinder
    with a moving wall, and a wall/gran/region block and cylinder (their
    contact sources from each package's WallGranFix), and erotate_sphere;
  * PourFix.insert for both specs of tests/test_pour.py: the positions,
    radii, masses and velocities of the inserted atoms equal, draw for
    draw, and the next events;
  * no module of the port imports JAX or the JAX package.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
torch.set_num_threads(1)

from lidp_tpu import box as jbox  # noqa: E402
from lidp_tpu.integrate import gran_runner as jgr  # noqa: E402
from lidp_tpu.io import script as jscript  # noqa: E402
from lidp_tpu.ops import cells as jcells  # noqa: E402
from lidp_tpu.ops import granular as jgran  # noqa: E402
from lidp_tpu_torch import box as tbox  # noqa: E402
from lidp_tpu_torch.integrate import gran_runner as tgr  # noqa: E402
from lidp_tpu_torch.io import script as tscript  # noqa: E402
from lidp_tpu_torch.ops import cells as tcells  # noqa: E402
from lidp_tpu_torch.ops import granular as tgran  # noqa: E402

BAR = 1e-10
ARGS = ("2000.0", "NULL", "50.0", "NULL", "0.5", "1")
N = 60
L = (4.2, 4.5, 4.8)


def _spheres(seed, n=N, lengths=L):
    """n spheres of radius 0.35-0.55 at random in the box: many overlap."""
    rs = np.random.RandomState(seed)
    x = rs.uniform(0, 1, (n, 3)) * np.asarray(lengths)
    rad = rs.uniform(0.35, 0.55, n)
    return dict(x=x, v=rs.normal(0, 1, (n, 3)), w=rs.normal(0, 1, (n, 3)),
                rad=rad, m=4 / 3 * np.pi * rad ** 3 * rs.uniform(0.8, 1.2, n),
                frozen=rs.uniform(size=n) < 0.2, excl=rs.uniform(size=n) < 0.3,
                mask=np.arange(n) < n - 3)


def _boxes(periodic):
    jb = jbox.Box.create([0, 0, 0], list(L), dtype=jnp.float64,
                         periodic=periodic)
    tb = tbox.Box.create([0, 0, 0], list(L), dtype=torch.float64,
                         periodic=periodic)
    return jb, tb


def _cells(s, periodic):
    jb, tb = _boxes(periodic)
    cfg = jcells.CellConfig.for_box(L, 1.1 + 0.1, density=N / np.prod(L),
                                    cap_slack=5.0)
    tcfg = tcells.CellConfig(nbins=cfg.nbins, cap=cfg.cap,
                             cutneigh=cfg.cutneigh)
    jc = jcells.build_cells(jnp.asarray(s["x"]), jnp.asarray(s["mask"]), jb,
                            cfg)
    tc = tcells.build_cells(torch.as_tensor(s["x"]),
                            torch.as_tensor(s["mask"]), tb, tcfg)
    assert np.array_equal(np.asarray(jc.atom_of_slot),
                          tc.atom_of_slot.numpy())
    return jb, tb, jc, tc


def _close(name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    big = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(got - want).max())
    assert err <= BAR * big, (name, err, big)


def _params(s, kind, frozen, excl):
    fr = s["frozen"] if frozen else np.zeros(N, bool)
    ex = s["excl"] if excl else None
    jp = jgran.make_gran_params(ARGS, s["rad"], s["m"], fr, excl=ex,
                                dt=0.001, kind=kind)
    tp = tgran.make_gran_params(ARGS, s["rad"], s["m"], fr, excl=ex,
                                dt=0.001, kind=kind)
    return jp, tp


CASES = {
    # kind, frozen subset, exclude group, shear update, need_ev, periodic
    "hooke/history": ("hooke/history", True, True, True, True, True),
    "hooke/history setup": ("hooke/history", True, False, False, True, True),
    "hooke/history open z": ("hooke/history", False, True, True, False,
                             (True, True, False)),
    "hertz/history": ("hertz/history", True, True, True, True, True),
    "hertz/history setup": ("hertz/history", False, False, False, False,
                            True),
    "hooke": ("hooke", True, True, True, True, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_gran_cell_forces_match_jax(case):
    kind, frozen, excl, update, need_ev, per = CASES[case]
    per = (True,) * 3 if per is True else per
    s = _spheres(3)
    jb, tb, jc, tc = _cells(s, per)
    jp, tp = _params(s, kind, frozen, excl)
    # a history as the runner keeps one: zero off the candidate pairs
    pairs = tgran.candidate_pairs(tc, N, tp.excl)
    shear = np.random.RandomState(4).normal(
        0, 0.01, jgran.shear_shape(jc))
    shear.reshape(-1, 3)[_off(shear, pairs)] = 0.0
    jout = jgran.gran_cell_forces(
        jnp.asarray(s["x"]), jnp.asarray(s["v"]), jnp.asarray(s["w"]),
        jnp.asarray(s["mask"]), jc, jb, jp, jnp.asarray(shear),
        shear_update=update, need_ev=need_ev)
    tout = tgran.gran_cell_forces(
        torch.as_tensor(s["x"]), torch.as_tensor(s["v"]),
        torch.as_tensor(s["w"]), torch.as_tensor(s["mask"]), tc, tb, tp,
        torch.tensor(shear), pairs, shear_update=update, need_ev=need_ev)
    for name, t, j in zip(("f", "torque", "shear", "virial"), tout, jout):
        _close(f"{case} {name}", t.numpy(), j)
    f = tout[0].numpy()
    # contacts act, on the live atoms alone, and the frozen rule and the
    # exclusion change them
    assert np.abs(f).max() > 1.0 and not f[~s["mask"]].any()
    if need_ev:
        assert np.abs(tout[3].numpy()).max() > 0.0


def _off(shear, pairs):
    """(slot pairs,) bool: the rows of shear.reshape(-1, 3) off the
    candidate pairs."""
    off = np.ones(shear.size // 3, bool)
    off[pairs.flat.numpy()] = False
    return off


def test_candidate_pairs_and_history_off_them():
    """The candidate pairs are the live slot pairs of the half stencil,
    exclusions out; the history the contact pass writes in place stays
    zero off them, and so does its migration onto a rebuilt grid (the
    pass's precondition)."""
    s = _spheres(5)
    jb, tb, jc, tc = _cells(s, (True,) * 3)
    _, tp = _params(s, "hooke/history", True, True)
    pairs = tgran.candidate_pairs(tc, N, tp.excl)
    ex = s["excl"] & s["mask"]
    ai, aj = pairs.ai.numpy(), pairs.aj.numpy()
    assert s["mask"][ai].all() and s["mask"][aj].all()
    assert not (ex[ai] & ex[aj]).any() and (ai != aj).all()
    sh = torch.zeros(tgran.shear_shape(tc), dtype=torch.float64)
    for _ in range(2):
        _, _, out, _ = tgran.gran_cell_forces(
            torch.as_tensor(s["x"]), torch.as_tensor(s["v"]),
            torch.as_tensor(s["w"]), torch.as_tensor(s["mask"]), tc, tb, tp,
            sh, pairs)
        assert out is sh
    sh_np = sh.numpy()
    assert sh.abs().max() > 0
    assert not sh_np.reshape(-1, 3)[_off(sh_np, pairs)].any()
    moved = dict(s)
    rs = np.random.RandomState(8)
    x = s["x"].copy()
    sel = rs.uniform(size=N) < 0.33
    x[sel] = (x[sel] + rs.uniform(-0.8, 0.8, (sel.sum(), 3))) % np.asarray(L)
    moved["x"] = x
    _, _, _, tc2 = _cells(moved, (True,) * 3)
    kept = tgran.migrate_shear(sh, tc, tc2).numpy()
    assert 0 < np.count_nonzero(kept) < np.count_nonzero(sh.numpy())
    pairs2 = tgran.candidate_pairs(tc2, N, tp.excl)
    assert not kept.reshape(-1, 3)[_off(kept, pairs2)].any()


def test_migrate_shear_matches_jax():
    s = _spheres(6)
    jb, tb, jc, tc = _cells(s, (True,) * 3)
    rs = np.random.RandomState(7)
    moved = dict(s)
    x = s["x"].copy()
    sel = rs.uniform(size=N) < 0.33
    x[sel] = (x[sel] + rs.uniform(-0.8, 0.8, (sel.sum(), 3))) % np.asarray(L)
    moved["x"] = x
    _, _, jc2, tc2 = _cells(moved, (True,) * 3)
    shear = rs.normal(0, 1, jgran.shear_shape(jc))
    want = np.asarray(jgran.migrate_shear(jnp.asarray(shear), jc, jc2))
    got = tgran.migrate_shear(torch.as_tensor(shear), tc, tc2).numpy()
    assert np.array_equal(got, want)
    assert 0 < np.count_nonzero(got) < np.count_nonzero(shear)


def _walls(kind):
    """(name, JAX WallGranFix, port WallGranFix) of each source style."""
    js = jscript.LammpsScript(dtype=jnp.float64, log=lambda line: None)
    ts = tscript.LammpsScript(dtype=torch.float64, device="cpu",
                              log=lambda line: None)
    for sc in (js, ts):
        sc.one("region cage block 0.3 3.9 INF INF 0.4 4.4 units box")
        sc.one("region can cylinder z 2.1 2.25 1.9 0.5 4.3 units box")
    kn, kt, gn, gt, xmu = tgran.gran_coeffs(ARGS)
    common = dict(kind=kind, kn=kn, kt=kt, gamman=gn, gammat=gt, xmu=xmu)
    gm = np.arange(N) % 7 != 3
    out = []
    for name, kw in (
            ("zplane", dict(wallstyle="zplane", lo=0.45, hi=4.3,
                            wshear=True, axis=0, vshear=0.8)),
            ("zcylinder", dict(wallstyle="zcylinder", cylradius=2.0,
                               wshear=True, axis=0, vshear=0.5)),
            ("region block", dict(wallstyle="region")),
            ("region cylinder", dict(wallstyle="region"))):
        jkw, tkw = dict(kw), dict(kw)
        if kw["wallstyle"] == "region":
            from lidp_tpu.sim import _region_gran_contacts

            from lidp_tpu_torch.styles.gran_builders import \
                region_gran_contacts
            rname = "cage" if name.endswith("block") else "can"
            jkw["region_contacts"] = _region_gran_contacts(js, rname)
            tkw["region_contacts"] = region_gran_contacts(ts, rname)
        out.append((name, jgr.WallGranFix(gmask=jnp.asarray(gm), **common,
                                           **jkw),
                    tgr.WallGranFix(gmask=torch.as_tensor(gm), **common,
                                    **tkw)))
    return out


@pytest.mark.parametrize("kind", ["hooke", "hooke/history", "hertz/history"])
def test_wall_contact_force_matches_jax(kind):
    s = _spheres(8)
    # the zcylinder's axis is x = y = 0: the spheres centred on it
    x, x_c = s["x"], s["x"] - np.array([2.1, 2.25, 0.0])
    shear = np.random.RandomState(9).normal(0, 0.01, (N, 3))
    touched = 0
    for name, jw, tw in _walls(kind):
        xs = x_c if name == "zcylinder" else x
        jv, jsrc = jw.contact_sources(jnp.asarray(xs), jnp.asarray(s["rad"]),
                                      jnp.asarray(7), 0.001)
        tv, tsrc = tw.contact_sources(torch.as_tensor(xs),
                                      torch.as_tensor(s["rad"]), 7, 0.001)
        # the block's two infinite faces are no walls
        assert len(jsrc) == len(tsrc) == {"region block": 4,
                                          "region cylinder": 3}.get(name, 1)
        _close(f"{name} vwall", tv.numpy(), jv)
        for (jd, jr, jok), (td, tr, tok) in zip(jsrc, tsrc):
            _close(f"{name} d", td.numpy(), jd)
            assert np.array_equal(tok.numpy(), np.asarray(jok))
            assert (jr is None) == (tr is None)
            act = np.asarray(jok) & s["mask"]
            jout = jgran.wall_contact_force(
                jd, jnp.asarray(s["v"]), jnp.asarray(s["w"]),
                jnp.asarray(s["rad"]), jnp.asarray(s["m"]),
                jnp.asarray(shear), jv, jnp.asarray(act), jw.kn, jw.kt,
                jw.gamman, jw.gammat, jw.xmu, 0.001, kind, rwall=jr)
            tout = tgran.wall_contact_force(
                td, torch.as_tensor(s["v"]), torch.as_tensor(s["w"]),
                torch.as_tensor(s["rad"]), torch.as_tensor(s["m"]),
                torch.as_tensor(shear), tv, torch.as_tensor(act), tw.kn,
                tw.kt, tw.gamman, tw.gammat, tw.xmu, 0.001, kind, rwall=tr)
            for part, t, j in zip(("f", "torque", "shear"), tout, jout):
                if np.abs(np.asarray(j)).max() == 0.0:
                    assert not t.numpy().any(), (name, part)
                else:
                    _close(f"{name} {part}", t.numpy(), j)
            touched += int(np.abs(tout[0].numpy()).sum(1).astype(bool).sum())
    assert touched > 10


def test_erotate_sphere_matches_jax():
    s = _spheres(10)
    rad = s["rad"].copy()
    rad[:5] = 0.0
    want = float(jgran.erotate_sphere(
        jnp.asarray(s["w"]), jnp.asarray(rad), jnp.asarray(s["m"]),
        jnp.asarray(s["mask"]), mvv2e=1.5))
    got = float(tgran.erotate_sphere(
        torch.as_tensor(s["w"]), torch.as_tensor(rad),
        torch.as_tensor(s["m"]), torch.as_tensor(s["mask"]), mvv2e=1.5))
    assert abs(got - want) <= 1e-14 * abs(want) and want > 0


def _pour_fix(pkg, case, tmp_path):
    """Each package's PourFix of tests/test_pour.py's spec, parsed from
    its script (the lines before `run`)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from test_pour import BASE, DATA, POUR_LINE

    (tmp_path / "data.pour").write_text(DATA)
    pour = POUR_LINE[case][0]
    text = BASE.format(data=tmp_path / "data.pour", pour=pour, steps=0)
    lines = [ln for ln in text.splitlines() if not ln.startswith(("run",
                                                                  "thermo"))]
    if pkg == "jax":
        from lidp_tpu.pour import parse_pour

        s = jscript.LammpsScript(dtype=jnp.float64, log=lambda line: None)
        s.execute(lines)
        return parse_pour(s.fixes["ins"], s, None, 1.0, 1.0), s
    from lidp_tpu_torch.pour import parse_pour

    s = tscript.LammpsScript(dtype=torch.float64, device="cpu",
                             log=lambda line: None)
    s.execute(lines)
    return parse_pour(s.fixes["ins"], s, 1.0, 1.0), s


@pytest.mark.parametrize("case", ["one", "multi"])
def test_pour_insert_matches_jax(case, tmp_path):
    jp, js = _pour_fix("jax", case, tmp_path)
    tp, ts = _pour_fix("torch", case, tmp_path)
    for k in ("nfreq", "nper", "nfirst", "grav", "dt", "periodic", "box_lo",
              "box_hi", "radius_lo", "radius_hi", "density_lo", "vz"):
        assert getattr(tp, k) == getattr(jp, k), k
    npad = 2 + tp.ninsert
    arrays = []
    for pf, sc in ((jp, js), (tp, ts)):
        x = np.zeros((npad, 3))
        x[:2] = sc.x
        v, rad, m = np.zeros((npad, 3)), np.zeros(npad), np.ones(npad)
        rad[:2] = 0.5
        mask = np.arange(npad) < 2
        rows = []
        step = pf.next_event()
        while step is not None:
            rows.append(pf.insert(step, x, v, rad, m, mask,
                                  int(mask.sum())))
            step = pf.next_event()
        arrays.append((rows, x, v, rad, m, mask, pf.nevents))
    for got, want in zip(arrays[1], arrays[0]):
        if isinstance(got, np.ndarray):
            assert np.array_equal(got, want)
        else:
            assert got == want
    assert arrays[1][5].sum() == 2 + tp.ninsert
    assert arrays[1][6] == (1 if case == "one" else 5)


def test_granular_modules_import_no_jax():
    """The granular modules import neither JAX nor the JAX package."""
    code = ("import sys\n"
            "import lidp_tpu_torch.ops.granular, "
            "lidp_tpu_torch.integrate.gran_runner, lidp_tpu_torch.pour, "
            "lidp_tpu_torch.styles.gran_builders, lidp_tpu_torch.sim\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'lidp_tpu')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parent.parent)
    assert res.returncode == 0, res.stderr
