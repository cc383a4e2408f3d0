"""The port's structure computes and heat/flux (lidp_tpu_torch/computes.py
neighbor_table, centro_atom, cna_atom, orientorder_atom, hexorder_atom,
fragment_aggregate_atom, global_atom, eval_heat_flux; compute slice of
their arrays) against LAMMPS and the JAX package, float64 on the CPU:

  * LAMMPS's rows of tests/test_structure_computes.py (CENTRO_GOLDEN:
    centro/atom and cna/atom on an fcc melt with a vacancy; HF_GOLDEN:
    heat/flux; SLICE_GOLDEN) and tests/test_order_computes.py
    (ORIENT_GOLDEN, the hex lattice's hexorder rows, global/atom over a
    com/chunk array), at those tests' bars, each script through the JAX
    package too: the rows within rel 1e-10 of JAX's and every per-atom
    vector on the final state against JAX's eval_peratom (rel 1e-10 of
    its largest entry; the cna codes exactly);
  * ties: perfect lattices (fcc at 108 atoms, every atom a candidate;
    fcc at 500, where the port's candidates come from a cell grid; the 2-d
    hex lattice) with centro/atom bcc (8 of the 12 nearest), orientorder
    nnn 8 and hexorder nnn 4 (4 of 6) and cna, so that the nnn boundary
    falls inside a shell of equal distances: the port picks JAX's
    neighbours (rel 1e-10, where another pick moves the values by O(1));
  * fragment/atom and aggregate/atom on bead-spring chains written from a
    seed (chip_smoke.chain_script_case) with a group, their labels equal
    to JAX's; heat/flux of a group, global/atom of heat/flux and of a
    chunk array, orientorder components and nnn NULL;
  * api.lammps.extract_compute of heat/flux (its 6-vector), a one-column
    slice and temp/chunk's scalar against the JAX package's;
  * what the JAX package skips raises (centro/atom's axes), its ValueErrors
    (an unknown orientorder keyword) stay.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
torch.set_num_threads(1)

from lidp_tpu import computes as jcomputes  # noqa: E402
from lidp_tpu.io import script as jscript  # noqa: E402
from lidp_tpu_torch import computes as tcomputes  # noqa: E402
from lidp_tpu_torch.io import script as tscript  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
REL = 1e-10


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tests", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


S = _load("test_structure_computes")    # MELT, TAIL, the goldens
O = _load("test_order_computes")        # ORIENT_GOLDEN, HEX_HEAD

FCC3 = """units lj
atom_style atomic
boundary p p p
lattice fcc 0.8442
region box block 0 {n} 0 {n} 0 {n}
create_box 1 box
create_atoms 1 box
mass 1 1.0
velocity all create 1.44 87287 loop geom
pair_style lj/cut 2.5
pair_coeff 1 1 1.0 1.0
fix 1 all nve
"""
SCRIPTS = {
    "centro": S.MELT + """region hole sphere 2 2 2 0.4
delete_atoms region hole
velocity all create 0.05 87287 loop geom
fix 1 all nve
compute cc all centro/atom fcc
compute cn all cna/atom 1.4336
compute rc all reduce sum c_cc
compute rn all reduce sum c_cn
compute rmax all reduce max c_cc
thermo_style custom step temp c_rc c_rn c_rmax
""" + S.TAIL,
    "hf": S.MELT + """velocity all create 1.44 87287 loop geom
fix 1 all nve
compute myke all ke/atom
compute mype all pe/atom
compute myst all stress/atom NULL
compute hf all heat/flux myke mype myst
compute s all slice 2 6 2 c_hf
region half block 0 2 INF INF INF INF
group half region half
compute hfh half heat/flux myke mype myst
compute gh all global/atom c_myke c_hf
thermo_style custom step temp c_hf[1] c_hf[2] c_hf[3] c_hf[4] c_hf[5] \
c_hf[6] c_s[1] c_s[2] c_hfh[1] c_hfh[6]
""" + S.TAIL,
    "orient": FCC3.format(n=3) + """compute oo all orientorder/atom
compute q6 all orientorder/atom degrees 1 6 components 6 nnn 12 cutoff 1.8
compute q0 all orientorder/atom nnn NULL degrees 2 4 6 cutoff 1.3
compute r1 all reduce sum c_oo[1] c_oo[2] c_oo[5]
compute r2 all reduce sum c_q6[2] c_q6[8]
thermo 2
thermo_style custom step c_r1[1] c_r1[2] c_r1[3] c_r2[1] c_r2[2]
run 2
""",
    "hex": O.HEX_HEAD + """compute hx all hexorder/atom
compute hx4 all hexorder/atom degree 4 nnn 4 cutoff 1.5
compute rh all reduce sum c_hx[1] c_hx[2] c_hx4[1] c_hx4[2]
thermo 2
thermo_style custom step c_rh[1] c_rh[2] c_rh[3] c_rh[4]
run 2
""",
    "global": FCC3.format(n=3) + """compute cc all chunk/atom bin/1d x lower \
0.25 units reduced
compute vc all com/chunk cc
compute ga all global/atom c_cc c_vc[1] c_vc[2]
compute rg all reduce sum c_ga[1] c_ga[2]
thermo 2
thermo_style custom step c_rg[1] c_rg[2]
thermo_modify norm no
run 2
""",
}
# the per-atom vectors read on each script's final state (integers exact)
PERATOM = {"centro": ("cc", "cn"), "hf": ("gh",),
           "orient": ("oo", "q6", "q0"), "hex": ("hx", "hx4"),
           "global": ("cc", "ga")}
INTEGER = ("cn", "cc_global", "fr", "ag", "agh", "cn3", "cn5")


def _script(pkg, root):
    if pkg == "jax":
        s = jscript.LammpsScript(dtype=jnp.float64, log=lambda line: None)
    else:
        s = tscript.LammpsScript(dtype=torch.float64, device="cpu",
                                 log=lambda line: None)
    s.root = str(root)
    return s


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every script of SCRIPTS through both packages: {name: {pkg:
    script}}."""
    out = {}
    for name, text in SCRIPTS.items():
        out[name] = {}
        for pkg in ("jax", "torch"):
            s = _script(pkg, tmp_path_factory.mktemp(f"{name}_{pkg}"))
            s.execute(text.splitlines())
            out[name][pkg] = s
    return out


def _rows(s):
    return {int(r["step"]): r for r in s.thermo_rows}


def test_centro_cna_golden(runs):
    rows = _rows(runs["centro"]["torch"])
    for step, temp, rc, rn, rmax in S.CENTRO_GOLDEN:
        r = rows[step]
        assert r["temp"] == pytest.approx(temp, rel=1e-10)
        assert r["c_rc"] == pytest.approx(rc, rel=1e-8)
        assert r["c_rn"] == pytest.approx(rn, rel=1e-12)
        assert r["c_rmax"] == pytest.approx(rmax, rel=1e-8)


def test_heat_flux_golden(runs):
    rows = _rows(runs["hf"]["torch"])
    for row in S.HF_GOLDEN:
        r = rows[int(row[0])]
        assert r["temp"] == pytest.approx(row[1], rel=1e-10)
        for k in range(6):
            assert r[f"c_hf[{k + 1}]"] == pytest.approx(row[2 + k],
                                                        rel=2e-7)


def test_slice_golden(runs):
    rows = _rows(runs["hf"]["torch"])
    for step, temp, s1, s2 in S.SLICE_GOLDEN:
        assert rows[step]["c_s[1]"] == pytest.approx(s1, rel=2e-7)
        assert rows[step]["c_s[2]"] == pytest.approx(s2, rel=2e-7)


def test_orientorder_atom_golden(runs):
    rows = _rows(runs["orient"]["torch"])
    for step, q4, q6, q12, c2, c8 in O.ORIENT_GOLDEN:
        r = rows[step]
        assert r["c_r1[1]"] == pytest.approx(q4, rel=1e-10)
        assert r["c_r1[2]"] == pytest.approx(q6, rel=1e-10)
        assert r["c_r1[3]"] == pytest.approx(q12, rel=1e-10)
        assert r["c_r2[1]"] == pytest.approx(c2, rel=1e-8, abs=1e-12)
        assert r["c_r2[2]"] == pytest.approx(c8, rel=1e-8, abs=1e-12)


def test_hexorder_atom_golden(runs):
    rows = _rows(runs["hex"]["torch"])
    r0, r2 = rows[0], rows[2]
    assert r0["c_rh[1]"] == pytest.approx(1.0, rel=1e-12)
    assert r0["c_rh[2]"] == pytest.approx(0.0, abs=1e-12)
    assert r2["c_rh[1]"] == pytest.approx(0.998595202424, rel=1e-10)
    assert r2["c_rh[2]"] == pytest.approx(-1.59509088455e-05, rel=1e-8)
    assert r2["c_rh[3]"] == pytest.approx(0.00712479064708, rel=1e-8)
    assert r2["c_rh[4]"] == pytest.approx(0.0394258967726, rel=1e-8)


def test_global_atom_golden(runs):
    rows = _rows(runs["global"]["torch"])
    for step in (0, 2):
        assert rows[step]["c_rg[1]"] == pytest.approx(226.745485837,
                                                      rel=1e-10)
        assert rows[step]["c_rg[2]"] == pytest.approx(226.745485837,
                                                      rel=1e-10)


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_rows_match_jax(runs, name):
    js, ts = runs[name]["jax"], runs[name]["torch"]
    assert len(ts.thermo_rows) == len(js.thermo_rows) > 1
    for jr, tr in zip(js.thermo_rows, ts.thermo_rows):
        for k in ts.thermo_columns:
            assert abs(tr[k] - jr[k]) <= REL * max(1.0, abs(jr[k])), \
                (name, tr["step"], k, tr[k], jr[k])


def _peratom_agree(js, ts, cid, integer):
    want = np.asarray(jcomputes.eval_peratom(js._sim, cid), float)
    got = tcomputes.eval_peratom(ts._sim, cid).numpy()
    assert got.shape == want.shape, cid
    if integer:
        np.testing.assert_array_equal(got, want)
    else:
        big = max(1.0, np.abs(want).max())
        assert np.abs(got - want).max() <= REL * big, \
            (cid, np.abs(got - want).max())
    return got


@pytest.mark.parametrize("name,cid", [(n, c) for n, cids in PERATOM.items()
                                      for c in cids])
def test_peratom_vectors_match_jax(runs, name, cid):
    js, ts = runs[name]["jax"], runs[name]["torch"]
    integer = cid in INTEGER or (name == "global" and cid == "cc")
    got = _peratom_agree(js, ts, cid, integer)
    assert np.abs(got).max() > 0
    # bit for bit again on a fresh cache
    ts._sim._peratom = (None, None, {})
    assert np.array_equal(tcomputes.eval_peratom(ts._sim, cid).numpy(), got)


# perfect lattices, run 0: the nnn boundary inside a shell of equal
# distances (centro bcc takes 8 of fcc's 12 nearest, orientorder nnn 8,
# hexorder nnn 4 of the hex lattice's 6)
TIES = {
    "fcc108": FCC3.format(n=3) + """compute cb all centro/atom bcc
compute c10 all centro/atom 10
compute o8 all orientorder/atom nnn 8 degrees 3 4 6 8 components 4
compute cn3 all cna/atom 1.43
run 0
""",
    "fcc500": FCC3.format(n=5) + """compute cb all centro/atom bcc
compute o8 all orientorder/atom nnn 8 degrees 2 4 6 components 6
compute cn5 all cna/atom 1.43
run 0
""",
    "hex": O.HEX_HEAD + """compute hx4 all hexorder/atom degree 4 nnn 4 \
cutoff 1.5
compute hx3 all hexorder/atom degree 3 nnn 3
run 0
""",
}
TIE_CIDS = {"fcc108": ("cb", "c10", "o8", "cn3"),
            "fcc500": ("cb", "o8", "cn5"), "hex": ("hx4", "hx3")}


@pytest.fixture(scope="module")
def ties(tmp_path_factory):
    out = {}
    for name, text in TIES.items():
        out[name] = {}
        for pkg in ("jax", "torch"):
            s = _script(pkg, tmp_path_factory.mktemp(f"tie_{name}_{pkg}"))
            s.execute(text.splitlines())
            out[name][pkg] = s
    return out


@pytest.mark.parametrize("name,cid", [(n, c) for n, cids in TIE_CIDS.items()
                                      for c in cids])
def test_ties_pick_jax_neighbours(ties, name, cid):
    js, ts = ties[name]["jax"], ties[name]["torch"]
    got = _peratom_agree(js, ts, cid, cid in INTEGER)
    assert np.abs(got).max() > 0
    if cid.startswith("cn"):
        assert (got == 1.0).all()          # every atom fcc
    if name == "fcc500":
        # the box holds 3 cells of the cutoff a side: the port's pair
        # rows come from its cell grid, JAX's from every atom
        sim = ts._sim
        assert tcomputes._cell_candidates(
            sim.sys.x[:sim.natoms], sim.sys.box, 2.5) is not None


def test_ties_change_the_values(ties):
    """The pick matters: orientorder nnn 8 from the 12 nearest taken in
    the reverse order moves its Q_l by O(0.1)."""
    ts = ties["fcc108"]["torch"]
    sim = ts._sim
    cut = tcomputes._force_cutoff(sim)
    tab = tcomputes.neighbor_table(sim, cut)
    # one shell to the rounding of the positions, its r^2 tied exactly
    # across the 8th and 9th places for some atoms
    r12 = tab.rsq[:, :12]
    assert ((r12.max(1).values - r12.min(1).values)
            <= 1e-12 * r12.max(1).values).all()
    assert (tab.rsq[:, 7] == tab.rsq[:, 8]).any()
    assert (tab.rsq[:, 12] > 1.1 * tab.rsq[:, 11]).all()
    got = tcomputes.eval_peratom(sim, "o8")
    perm = list(range(11, -1, -1)) + list(range(12, tab.nbr.shape[1]))
    alt = tcomputes.NeighborTable(tab.nbr[:, perm], tab.vec[:, perm],
                                  tab.rsq[:, perm], tab.count)
    sim._peratom = (int(sim.sys.step), sim.res,
                    {("neighbors", float(cut)): alt})
    other = tcomputes.eval_peratom(sim, "o8")
    sim._peratom = (None, None, {})
    assert (other - got).abs().max() > 0.1


# bead-spring chains: fragment/atom, aggregate/atom (all and a group)
CHAINS = """units lj
atom_style bond
special_bonds lj 0.0 1.0 1.0
read_data data.chain
bond_style harmonic
bond_coeff 1 100.0 0.97
pair_style lj/cut 1.12
pair_modify shift yes
pair_coeff 1 1 1.0 1.0 1.12
group front molecule <= 4
compute fr all fragment/atom
compute ag all aggregate/atom 1.2
compute agh front aggregate/atom 1.5
compute frh front fragment/atom
compute rs all reduce sum c_fr c_ag c_agh c_frh
fix 1 all nve
thermo_style custom step temp pe c_rs[1] c_rs[2] c_rs[3] c_rs[4]
thermo 2
run 4
"""


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    import chip_smoke

    out = {}
    for pkg in ("jax", "torch"):
        work = tmp_path_factory.mktemp(f"frag_{pkg}")
        chip_smoke.chain_script_case(str(work), n_chains=8, n_beads=25)
        s = _script(pkg, work)
        s.execute(CHAINS.splitlines())
        out[pkg] = s
    return out


@pytest.mark.parametrize("cid", ["fr", "ag", "agh", "frh"])
def test_fragment_aggregate_match_jax(chains, cid):
    js, ts = chains["jax"], chains["torch"]
    got = _peratom_agree(js, ts, cid, True)
    labels = set(got[got > 0].tolist())
    if cid == "fr":
        assert labels == {1.0 + 25 * k for k in range(8)}
    if cid in ("agh", "frh"):
        assert (got[100:] == 0).all() and (got[:100] > 0).all()
    for jr, tr in zip(js.thermo_rows, ts.thermo_rows):
        for k in ts.thermo_columns:
            assert abs(tr[k] - jr[k]) <= REL * max(1.0, abs(jr[k]))


@pytest.mark.parametrize("line,exc", [
    ("compute c all centro/atom fcc axes yes", NotImplementedError),
    ("compute c all cna/atom 1.4 extra", NotImplementedError),
    ("compute c all aggregate/atom 1.2 x", NotImplementedError),
    ("compute c all orientorder/atom wl yes", ValueError),
    ("compute c all hexorder/atom components 6", ValueError),
    ("compute c all heat/flux a b c", ValueError),
    ("compute c all global/atom c_ka c_ka", ValueError),
])
def test_structure_arguments_raise(line, exc):
    s = _script("torch", ".")
    s.execute(FCC3.format(n=3).splitlines() + ["compute ka all ke/atom"])
    with pytest.raises(exc):
        s.one(line)


def test_api_extract_compute_matches_jax():
    from lidp_tpu import api as japi
    from lidp_tpu_torch import api as tapi

    text = FCC3.format(n=3) + """compute ka all ke/atom
compute pa all pe/atom
compute sa all stress/atom NULL
compute hf all heat/flux ka pa sa
compute s all slice 1 6 2 c_hf
compute cc all chunk/atom bin/1d z lower 0.5 units reduced
compute tch all temp/chunk cc cdof 1
run 3
"""
    out = {}
    for pkg, mod in (("jax", japi), ("torch", tapi)):
        L = mod.lammps(**({} if pkg == "jax" else dict(device="cpu")))
        L.commands_string(text)
        out[pkg] = [np.atleast_1d(np.asarray(L.extract_compute(c), float))
                    for c in ("hf", "s", "tch")]
        L.close()
    for got, want, shape in zip(out["torch"], out["jax"], (6, 3, 1)):
        assert got.shape == want.shape == (shape,)
        assert np.abs(got - want).max() <= REL * max(1.0, np.abs(want).max())
