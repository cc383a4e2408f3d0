"""Routes and refusals of the k-space breadth (lidp_tpu_torch forcefield
.pair_route, ops/cell_kernels.supported, ops/cells.cell_pair_forces with
the lj/long, buck/long and msm tables, convert.pair_from_numpy, the script
grammar), float64 and float32 on the CPU:

  * pair_route keeps the CUDA LJ kernel off every lj/long, buck/long and
    msm table: single type, float32, no special lists, which sends plain
    lj/cut to cell_pair_forces_lj, sends them to cell_pair_forces; the
    kernels' wrappers raise on such a table;
  * cell_pair_forces with lj/long and buck/long tables (one and two
    types, with and without the erfc or msm coulomb) against the JAX
    package's on the same Cells, the tables carried across by
    convert.pair_from_numpy: f within 1e-10 of max |f| in float64 (5e-6
    in float32), the energies and the virial likewise;
  * pair_from_numpy still refuses the fields that are not ported (other
    kinds, lj5 on an lj table), and carries the rest of the CHARMM family
    (charmm_fsw, the charmmfsh and charmm/implicit coulombs), whose cell
    pass equals the JAX package's;
  * the script: kspace_modify takes gewald, gewald/disp and cutoff/adjust
    and raises on every other keyword; the other coul/msm and */long
    variants raise naming ROADMAP queue 1 item 6.9; the compositions the
    port leaves to item 6.5 raise naming it; buck/long on the cell grid
    with special bonds raises naming ROADMAP queue 3 item 30; pe/atom on
    the lj/long fluid equals JAX's (queue 3 item 31).
"""

import dataclasses

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
# one torch thread, for time: under pytest-xdist torch's threads spin on
# the cores the other workers use
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
from lidp_tpu.ops import cells as jcells  # noqa: E402
from lidp_tpu.ops.pair import make_generic_pair_params  # noqa: E402
from lidp_tpu_torch import convert  # noqa: E402
from lidp_tpu_torch import forcefield as tff  # noqa: E402
from lidp_tpu_torch.io import script as tscript  # noqa: E402
from lidp_tpu_torch.ops import cell_kernels  # noqa: E402
from lidp_tpu_torch.ops import cells as tcells  # noqa: E402
from lidp_tpu_torch.ops import pair as tpair  # noqa: E402
from lidp_tpu_torch.state import make_system  # noqa: E402
from tests.test_torch_lj_cells import (  # noqa: E402
    GRIDS, _case, _close, _fields)
from tests.torch_kspace_cases import buck_long, fluid_long, run  # noqa: E402

G6 = 0.45


def _long_pair(kind, ntypes, coul, dtype, coul_kind="long"):
    """The JAX package's long-kind table (make_generic_pair_params, g6 in
    its lj5 table) of _case's eps/sigma/cut, and the port's through
    pair_from_numpy."""
    from tests.test_torch_lj_cells import _tables

    eps, sig, cut = _tables(ntypes)
    jd = jnp.float32 if dtype == np.float32 else jnp.float64
    td = torch.float32 if dtype == np.float32 else torch.float64
    s6 = sig ** 6
    if kind == "lj/long":
        tabs = (48.0 * eps * s6 * s6, 24.0 * eps * s6, 4.0 * eps * s6 * s6,
                4.0 * eps * s6)
    else:
        rhoinv = np.where(sig > 0, 1.0 / np.where(sig > 0, 0.3 * sig, 1.0),
                          0.0)
        tabs = (3000.0 * eps, rhoinv, 4.0 * eps * s6, np.zeros_like(eps))
    kw = dict(cut_lj=cut, coul=coul, dtype=jd, coul_kind=coul_kind)
    if coul:
        kw.update(cut_coul=2.6, qqrd2e=332.06371,
                  g_ewald=0.9 if coul_kind == "long" else 0.0)
    pj = make_generic_pair_params(kind, *tabs, np.full_like(eps, G6), **kw)
    if coul_kind == "msm":
        pj = dataclasses.replace(pj, msm_order=8)
    pt = convert.pair_from_numpy(_fields(pj), device="cpu", dtype=td)
    assert pt.kind == kind and pt.g6 == pytest.approx(G6)
    assert pt.coul_kind == (coul_kind if coul else "long")
    return pj, pt


CELL_CASES = {
    "lj_long": ("lj/long", 1, False, "long"),
    "lj_long_two_coul": ("lj/long", 2, True, "long"),
    "buck_long": ("buck/long", 1, False, "long"),
    "buck_long_two_coul": ("buck/long", 2, True, "long"),
    "lj_long_msm": ("lj/long", 2, True, "msm"),
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", list(CELL_CASES))
def test_cell_pass_long_kinds_match_jax(case, dtype):
    kind, ntypes, coul, ck = CELL_CASES[case]
    ji, ti, _ = _case(GRIDS["cubic"], dtype, ntypes=ntypes, coul=coul)
    pj, pt = _long_pair(kind, ntypes, coul, dtype, ck)
    ref = jcells.cell_pair_forces(ji["x"], ji["q"], ji["type"], ji["mask"],
                                  ji["cells"], ji["box"], pj)
    got = tcells.cell_pair_forces(ti["x"], ti["q"], ti["type"], ti["mask"],
                                  ti["cells"], ti["box"], pt)
    for what, a, b in zip(("f", "evdwl", "ecoul", "virial"), got, ref):
        if what != "ecoul" or coul:
            _close(a.numpy(), b, dtype, what)
    assert abs(float(ref[1])) > 1e-3


def _route_case(pair):
    _, ti, _ = _case(GRIDS["cubic"], np.float32)
    sys_t = make_system(ti["x"], box=ti["box"], q=ti["q"], type=ti["type"],
                        mask=ti["mask"], device="cpu")
    return sys_t, tff.ForceField(pair=pair), ti["cells"]


def _one_type_tables(kind):
    one = np.zeros((2, 2))
    one[1, 1] = 1.0
    if kind == "lj":
        return tpair.make_pair_params(one, one, 2.5 * one, coul=False,
                                      dtype=torch.float32)
    return tpair.make_long_pair_params(
        kind, 4.0 * one, 4.0 * one, 2.5 * one, coul=False, g6=G6,
        rhoinv=3.0 * one if kind == "buck/long" else None,
        dtype=torch.float32)


@pytest.mark.parametrize("table", ["lj", "lj/long", "buck/long", "msm",
                                   "msm_coul"])
def test_pair_route_keeps_the_lj_kernel_off(table):
    if table == "msm":
        pair = dataclasses.replace(_one_type_tables("lj"), coul_kind="msm")
    elif table == "msm_coul":
        one = np.zeros((2, 2))
        one[1, 1] = 1.0
        pair = tpair.make_pair_params(one, one, 2.5 * one, coul=True,
                                      cut_coul=2.5, coul_kind="msm",
                                      dtype=torch.float32)
    else:
        pair = _one_type_tables(table)
    sys_t, ff, cells = _route_case(pair)
    want = "cell_pair_forces_lj" if table == "lj" else "cell_pair_forces"
    assert tff.pair_route(sys_t, ff, cells) == want
    assert cell_kernels.supported(pair, False, pair.coul) == (table == "lj")
    res = tff.compute_forces(sys_t, ff, cells)
    assert bool(torch.isfinite(res.f).all())


@pytest.mark.parametrize("kind", ["lj/long", "buck/long"])
def test_lj_kernel_wrappers_refuse_long_tables(kind):
    pair = _one_type_tables(kind)
    sys_t, _, cells = _route_case(pair)
    with pytest.raises(ValueError, match=f"not the {kind} table"):
        cell_kernels.cell_pair_forces_lj(sys_t.x, sys_t.mask, cells,
                                         sys_t.box, pair)
    with pytest.raises(ValueError, match=f"not the {kind} table"):
        cell_kernels.slot_lj_forces([sys_t.x[:, 0]] * 3, sys_t.box, pair)


# the fields pair_from_numpy refuses since item 6.9 is ported: a kind the
# JAX package does not have, and an lj5 table on the lj kind, which the
# JAX package never builds; the rest of the CHARMM family, refused until
# item 6.6 was ported, is carried (err None: the keywords of the JAX
# make_pair_params whose table the port's cell pass takes as JAX's does)
REFUSED_FIELDS = {
    "coul_kind charmmfsh": (dict(coul_kind="charmmfsh"), None, None),
    "coul_kind charmm/implicit": (dict(coul_kind="charmm/implicit",
                                       cut_coul_inner=2.2, charmm=True,
                                       cut_lj_inner=2.0), None, None),
    "lj5 on lj": (dict(lj5=np.ones((2, 2))), ValueError, "lj5"),
    "charmm_fsw": (dict(charmm=True, charmm_fsw=True, cut_lj_inner=2.0),
                   None, None),
    "kind hbond": (dict(kind="hbond"), NotImplementedError, "kind"),
}


@pytest.mark.parametrize("name", list(REFUSED_FIELDS))
def test_pair_from_numpy_refuses_generic_fields(name):
    ji, ti, _ = _case(GRIDS["cubic"], np.float64, coul=True)
    fields, err, match = REFUSED_FIELDS[name]
    if err is None:
        from lidp_tpu.ops.pair import make_pair_params
        from tests.test_torch_lj_cells import _tables

        pj = make_pair_params(*_tables(1), coul=True, cut_coul=2.6,
                              qqrd2e=332.06371, **fields)
        pt = convert.pair_from_numpy(_fields(pj), device="cpu",
                                     dtype=torch.float64)
        ref = jcells.cell_pair_forces(ji["x"], ji["q"], ji["type"],
                                      ji["mask"], ji["cells"], ji["box"], pj)
        got = tcells.cell_pair_forces(ti["x"], ti["q"], ti["type"],
                                      ti["mask"], ti["cells"], ti["box"], pt)
        for g, r, what in zip(got, ref, ("f", "evdwl", "ecoul", "virial")):
            _close(g.numpy(), r, np.float64, f"{name} {what}")
        return
    with pytest.raises(err, match=match):
        convert.pair_from_numpy(dict(_fields(ji["p"]), **fields),
                                device="cpu")


# ------------------------------ the script --------------------------------

def test_kspace_modify_keywords():
    s = tscript.LammpsScript(device="cpu")
    s.one("kspace_modify gewald 0.3 gewald/disp 0.28 cutoff/adjust no")
    assert (s._gewald_override, s._gewald6_override,
            s._msm_cutoff_adjust) == (0.3, 0.28, False)
    for kw in ("mesh 8 8 8", "order 7", "slab 3.0", "mesh/disp 8 8 8"):
        with pytest.raises(NotImplementedError, match="queue 3 item 10"):
            s.one(f"kspace_modify {kw}")


@pytest.fixture(scope="module")
def fluid(tmp_path_factory):
    d = tmp_path_factory.mktemp("fluid")
    chip_smoke.fluid_script_case(str(d), n_side=3)
    return d


OTHER_PAIRS = ("coul/msm 6.0", "born/coul/msm 6.0", "buck/coul/msm 6.0",
               "coul/long 6.0", "buck/coul/long 6.0", "born/coul/long 6.0")


@pytest.mark.parametrize("style", OTHER_PAIRS)
def test_other_kspace_pair_styles_raise(fluid, style):
    """The coul/long and coul/msm styles of the generic dispatch (ported
    since item 6.9) raise, as the port's other k-space styles do, without
    a kspace_style (the JAX package runs them as coul/cut there)."""
    text = fluid_long(style).replace("kspace_style ewald/disp 1e-4\n", "")
    text = "\n".join(line for line in text.splitlines()
                     if not line.startswith("pair_coeff")) + "\n"
    with pytest.raises(ValueError, match="requires a KSpace style"):
        run("torch", fluid, text, nstep=0, name="nokspace")


COMPOSITIONS = {
    "coul/msm with ewald": fluid_long("lj/cut/coul/msm 6.0 6.5"),
    "coul/long with msm": fluid_long("lj/cut/coul/long 6.0 6.5",
                                     "msm 1e-4"),
    "lj/long with pppm": fluid_long("lj/long/coul/long long long 6.0 6.5",
                                    "pppm 1e-4"),
    "lj/long with pppm/tip4p": fluid_long(
        "lj/long/coul/long long long 6.0 6.5", "pppm/tip4p 1e-4"),
}


@pytest.mark.parametrize("name", list(COMPOSITIONS))
def test_compositions_left_to_item_6_5(fluid, name):
    with pytest.raises(NotImplementedError, match="queue 1 item 6.5"):
        run("torch", fluid, COMPOSITIONS[name], nstep=0, name="comp")


def test_buck_long_specials_on_cells_raise(tmp_path):
    chip_smoke.fluid_script_case(str(tmp_path), n_side=5)
    text = buck_long(extra="neighbor 0.1 bin\n")
    with pytest.raises(NotImplementedError, match="queue 3 item 30"):
        run("torch", tmp_path, text, nstep=0, cap=300, name="buckcells")


def test_pe_atom_long_kind_matches_jax(fluid):
    """compute pe/atom on the lj/long fluid: the port's pair_single takes
    factor_lj on the whole long-kind term as the JAX package's does, so
    the summed pe/atom equals JAX's and stands apart from the row's pe
    (ROADMAP queue 3 item 31)."""
    text = fluid_long("lj/long/coul/long long long 6.0 6.5").replace(
        "thermo_style custom", "compute pa all pe/atom\ncompute sp all "
        "reduce sum c_pa\nthermo_style custom c_sp")
    rows = [run(pkg, fluid, text, nstep=0, name=f"pa.{pkg}").thermo_rows[0]
            for pkg in ("jax", "torch")]
    assert rows[1]["c_sp"] == pytest.approx(rows[0]["c_sp"], rel=1e-10)
    assert abs(rows[1]["c_sp"] - rows[1]["pe"]) > 1.0


def test_pppm_tip4p_without_tip4p_runs_as_pppm(fluid):
    """pppm/tip4p with a pair style without TIP4P sites: the charge mesh
    on the atoms, the rows of pppm bit for bit (the JAX package runs it
    the same way)."""
    base = chip_smoke.point_charge_script()
    a = run("torch", fluid, base.replace("ewald/disp 1e-4", "pppm/tip4p 1e-4"),
            nstep=1, name="p4")
    b = run("torch", fluid, base.replace("ewald/disp 1e-4", "pppm 1e-4"),
            nstep=1, name="p")
    assert a._sim.runner.ff.tip4p is None
    assert a.thermo_rows == b.thermo_rows
