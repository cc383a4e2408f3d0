"""pair_style hybrid and hybrid/overlay in the port
(lidp_tpu_torch/styles/pair_builders.py _build_hybrid_pair: one masked
pass per sub-style; forcefield.compute_forces' extra_pairs on the dense
route and the cell grid) against the JAX package's, float64 on the CPU:

  * `pair_coeff I J none`, the mixing within a sub-style (an (i,j) pair
    assigned where the sub-style holds both diagonals), and a repeated
    sub-style with its index: each sub-style's exclusion table equal to
    JAX's, the rows at rel 1e-8 of max(1, |value|) of JAX's, final x and v
    within 1e-8 (tests/test_pair_breadth2.py's 64-atom box); none over
    van der Waals sub-styles (a mixing one gives the pair its zero row)
    equals the pair excluded by neigh_modify; where JAX keeps a pair none
    took out (a coul/* sub-style takes every pair: ROADMAP queue 3 item
    36) the port raises, and JAX's E_coul parts from the excluded one;
  * chip_smoke.py path AP's identity at the CPU's size: the NaCl melt
    (chip_smoke.nacl_layout, 4^3 rocksalt cells, 512 ions, the Tosi-Fumi
    Born-Mayer-Huggins tables, pppm 1e-5, fix nvt at 1100 K) as
    born/coul/long and as hybrid/overlay born + coul/long: rows equal at
    rel 1e-10 on the dense route and on the cell grid (cutoff 6 A,
    `neighbor 1.0 bin`, the dense cap mocked to 300 in both packages),
    and born/coul/long's rows equal JAX's on both routes.
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
# one torch thread, for time: under pytest-xdist torch's threads spin on
# the cores the other workers use
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
from lidp_tpu_torch.io.data_writer import write_data as twrite  # noqa: E402
from scripts.gen_breadth_goldens import write_data  # noqa: E402
from tests.test_torch_pair_scripts import _agree_with_jax, _run  # noqa: E402
from tests.torch_kspace_cases import run  # noqa: E402

HEAD = """units lj
atom_style charge
read_data data.breadth
"""
RUN = """velocity all create 1.0 87287 loop geom
timestep 0.005
fix 1 all nve
thermo 1
thermo_style custom step temp pe evdwl ecoul press
run 3
"""
# pair_coeff 1 2 none where the JAX package keeps the pair: a coul/*
# sub-style takes every pair
NONE_KEPT = {
    "dsf": ("pair_style hybrid/overlay morse 2.5 coul/dsf 0.5 2.5\n"
            "pair_coeff * * morse 0.3 1.5 1.3\n"
            "pair_coeff * * coul/dsf\npair_coeff 1 2 none\n"),
    "cut": ("pair_style hybrid/overlay lj/cut 2.5 coul/cut 2.5\n"
            "pair_coeff * * lj/cut 1.0 1.0\n"
            "pair_coeff * * coul/cut\npair_coeff 1 2 none\n"),
}
CASES = {
    # a mixing sub-style (lj/cut) gives the pair none took out its zero
    # row: no term, as LAMMPS
    "none_mixed": ("pair_style hybrid/overlay lj/cut 2.5 morse 2.5\n"
                   "pair_coeff * * lj/cut 1.0 1.0\n"
                   "pair_coeff * * morse 0.3 1.5 1.3\n"
                   "pair_coeff 1 2 none\n"),
    "none": ("pair_style hybrid/overlay morse 2.5 born 2.5\n"
             "pair_coeff * * morse 0.3 1.5 1.3\n"
             "pair_coeff * * born 0.9 0.45 1.05 1.0 0.5\n"
             "pair_coeff 1 2 none\n"),
    "mixing": ("pair_style hybrid lj/cut 2.5 born 2.5\n"
               "pair_coeff 1 1 lj/cut 1.0 1.0\n"
               "pair_coeff 2 2 lj/cut 0.8 1.1\n"
               "pair_coeff 1 2 born 0.9 0.45 1.05 1.0 0.5\n"),
    "repeated": ("pair_style hybrid/overlay lj/cut 2.5 lj/cut 2.0 "
                 "coul/dsf 0.5 2.5\n"
                 "pair_coeff * * lj/cut 1 1.0 1.0\n"
                 "pair_coeff 1 2 lj/cut 2 0.5 1.2\n"
                 "pair_coeff * * coul/dsf\n"),
}
# each case's (sub-style, type pair) -> excluded
EXCL = {"none_mixed": {(0, 1, 2): False, (1, 1, 2): True},
        "none": {(0, 1, 2): True, (1, 1, 2): True, (0, 1, 1): False,
                 (1, 2, 2): False},
        "mixing": {(0, 1, 2): False, (1, 1, 2): False, (1, 1, 1): True},
        "repeated": {(0, 1, 2): False, (1, 1, 2): False, (1, 1, 1): True,
                     (2, 1, 1): False}}


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    d = tmp_path_factory.mktemp("hyb")
    write_data(str(d / "data.breadth"))
    return d


@pytest.mark.parametrize("case", list(CASES))
def test_hybrid_matches_jax(box, case):
    text = HEAD + CASES[case] + RUN
    ts = _run("torch", box, text, case)
    js = _run("jax", box, text, case)
    _agree_with_jax(ts, js)
    tff, jff = ts._sim.runner.ff, js._sim.runner.ff
    tp = (tff.pair,) + tff.extra_pairs
    jp = (jff.pair,) + jff.extra_pairs
    assert len(tp) == len(jp)
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a.excl.numpy(), np.asarray(b.excl))
    for (k, i, j), excluded in EXCL[case].items():
        assert bool(tp[k].excl[i, j]) == excluded, (case, k, i, j)


@pytest.mark.parametrize("case", ["none", "none_mixed"])
def test_none_equals_an_excluded_type_pair(box, case):
    """`pair_coeff 1 2 none` over van der Waals sub-styles gives the rows
    of the same styles with the 1-2 pairs excluded by neigh_modify."""
    text = HEAD + CASES[case] + RUN
    excl = text.replace("pair_coeff 1 2 none\n",
                        "neigh_modify exclude type 1 2\n")
    a = _run("torch", box, text, "none")
    b = _run("torch", box, excl, "none_excl")
    chip_smoke.rows_agree("none", a.thermo_rows, b.thermo_rows,
                          [1e-12] * len(b.thermo_rows),
                          cols=("temp", "pe", "evdwl", "ecoul", "press"))


@pytest.mark.parametrize("case", list(NONE_KEPT))
def test_none_kept_by_jax_raises(box, case):
    """Where the JAX package keeps a pair that `pair_coeff I J none` took
    out (ROADMAP queue 3 item 36), the port raises; JAX's step-0 row there
    parts from the same styles with the pair excluded (LAMMPS's meaning
    of none)."""
    text = HEAD + NONE_KEPT[case] + RUN.replace("run 3", "run 0")
    with pytest.raises(NotImplementedError, match="queue 3 item 36"):
        _run("torch", box, text, "kept")
    js = _run("jax", box, text, "kept")
    jx = _run("jax", box, text.replace("pair_coeff 1 2 none\n",
                                       "neigh_modify exclude type 1 2\n"),
              "kept_excl")
    assert abs(js.thermo_rows[0]["ecoul"] - jx.thermo_rows[0]["ecoul"]) \
        > 1e-3


# ------------------------- path AP at the CPU's size ------------------------

@pytest.fixture(scope="module")
def nacl(tmp_path_factory):
    d = tmp_path_factory.mktemp("nacl")
    twrite(str(d / "nacl.data"), chip_smoke.nacl_layout(4))
    return d


def _nacl(pair, cells):
    text = chip_smoke.NACL_SCRIPT.format(data="nacl.data", pair=pair)
    if cells:
        text = text.replace("kspace_style", "neighbor 1.0 bin\nkspace_style")
    return text


@pytest.mark.parametrize("cells", [False, True], ids=["dense", "cells"])
def test_overlay_equals_born_coul_long(nacl, cells):
    cut = "6.0" if cells else chip_smoke.NACL_CUT
    cap = 300 if cells else None
    texts = {k: _nacl(chip_smoke.nacl_born_pair(k == "overlay", cut), cells)
             for k in ("born", "overlay")}
    ts = {k: run("torch", nacl, t, nstep=2, cap=cap, name=k)
          for k, t in texts.items()}
    for s in ts.values():
        assert (s._sim.runner.neighbor_cfg is not None) == cells
        assert len(s._sim.runner.ff.extra_pairs) == (s.pair.name !=
                                                     "born/coul/long")
    chip_smoke.rows_agree("AP", ts["overlay"].thermo_rows,
                          ts["born"].thermo_rows, [1e-10] * 3,
                          cols=chip_smoke.NACL_COLS)
    js = run("jax", nacl, texts["born"], nstep=2, cap=cap, name="jborn")
    chip_smoke.rows_agree("AO", ts["born"].thermo_rows, js.thermo_rows,
                          [1e-8] * 3, cols=chip_smoke.NACL_COLS)
    n = ts["born"]._sim.natoms
    np.testing.assert_allclose(ts["born"]._sim.sys.x[:n].numpy(),
                               np.asarray(js._sim.sys.x)[:n], rtol=0,
                               atol=1e-8 * 22.56)
