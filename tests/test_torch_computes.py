"""The port's computes (lidp_tpu_torch/computes.py and the compute wiring
of sim.py) against the JAX package and LAMMPS, float64 on the CPU:

  * scripts/gen_compute_goldens.py's SCRIPT (a 256-atom LJ melt with
    ke/atom, pe/atom, stress/atom, coord/atom, cluster/atom and
    displace/atom reduced by compute reduce and reduce/region, vacf,
    temp/ramp, temp/region, temp/profile; 4 nve steps, a row every 2)
    through both CLIs, `python -m lidp_tpu` and `python -m lidp_tpu_torch
    -device cpu`: every column of the port's logged rows within rel 1e-10
    of JAX's, and within 1e-8 of the column's scale of the rows LAMMPS
    printed (GOLDEN, copied from tests/test_compute_breadth.py:52-56,
    minted by that script from the rebuilt reference binary);
  * each per-atom style's vector (on the same melt after its 4 steps,
    with sub-group computes and property/atom, and on harmonic chains
    with special bonds, whose pe/atom tallies the bond halves and leaves
    the 1-2 pairs out) against the JAX package's eval_peratom: rel 1e-10
    of the vector's largest entry, the integer-valued ones exactly;
  * compute reduce's inputs and modes against JAX's eval_reduce.
"""

import importlib.util
import os
import subprocess
import sys

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
_spec = importlib.util.spec_from_file_location(
    "gen_compute_goldens",
    os.path.join(ROOT, "scripts", "gen_compute_goldens.py"))
_gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_gen)

COLS = ("step", "temp", "pe", "c_rk", "c_rp", "c_rs[1]", "c_rs[2]",
        "c_rc", "c_rcl", "c_rd", "c_rr", "c_vac[1]", "c_vac[4]", "c_tr",
        "c_treg", "c_tp")
HEADER = ("Step Temp PotEng c_rk c_rp c_rs[1] c_rs[2] c_rc c_rcl c_rd c_rr "
          "c_vac[1] c_vac[4] c_tr c_treg c_tp")
# tests/test_compute_breadth.py:52-56: LAMMPS's rows of the SCRIPT
GOLDEN = [
    [0.0, 1.44, -1733.98222163279, 550.8, -1733.98222163275, 1508.80009885537, 18.624455562878, 12.0, 1.0, 0.0, 351.107965223299, 1.49231603185803, 4.303125, 2.46774062430952, 1.47215079758197, 1.4439293822991],  # noqa: E501
    [2.0, 1.43088638838039, -1730.51201211474, 547.3140435555, -1730.51201211474, 1483.40084286785, 19.2894603640216, 12.0, 1.0, 0.033652954294526, 250.898146876965, 1.48756200406246, 4.28948145449566, 2.45382723018726, 1.46724062501149, 1.4342073562472],  # noqa: E501
    [4.0, 1.40164128098338, -1719.37323329849, 536.127789976143, -1719.37323329849, 1404.66757036162, 21.0434945058336, 12.0, 1.0, 0.0669976023997644, 245.730845301879, 1.4720851488003, 4.24532037845624, 2.41991275230278, 1.43702248714549, 1.40470199060461],  # noqa: E501
]

# the melt with sub-group per-atom computes and property/atom, read after
# the SCRIPT's run
PERATOM_EXTRA = """group low region half
compute kh low ke/atom
compute ph low pe/atom
compute sh low stress/atom NULL
compute clh low cluster/atom 1.3
compute crh low coord/atom cutoff 1.5
compute dh low displace/atom
compute pr low property/atom x vy fz type id mass
compute rmin all reduce min c_pa c_sa[3] x
compute rave low reduce ave c_ka c_crd c_pr[2]
compute rmax all reduce/region half max c_pa c_cl
"""
INTEGER = ("crd", "cl", "clh", "crh")

# harmonic chains with special bonds: the bond halves of pe/atom, and
# the 1-2 pairs (weight 0) out of the pair sum
CHAIN_TEXT = """units lj
atom_style bond
special_bonds lj 0.0 1.0 1.0
read_data data.chain
bond_style harmonic
bond_coeff 1 100.0 0.97
pair_style lj/cut 2.5
pair_coeff 1 1 1.0 1.0 2.5
compute pa all pe/atom
compute sa all stress/atom NULL
compute ka all ke/atom
compute rs all reduce sum c_pa c_sa[1] c_sa[6]
fix 1 all nve
thermo_style custom step pe ebond c_rs[1] c_rs[2] c_rs[3]
run 3
"""


def _cli(pkg, work):
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   filter(None, (ROOT, os.environ.get("PYTHONPATH")))))
    cmd = [sys.executable, "-m", pkg, "-in", "in.case", "-log", f"log.{pkg}"]
    if pkg == "lidp_tpu_torch":
        cmd += ["-device", "cpu"]
    return subprocess.Popen(cmd, cwd=work, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _log_rows(path):
    rows, grab = [], False
    with open(path) as fh:
        for line in fh:
            t = line.split()
            if line.strip() == HEADER:
                grab = True
            elif grab and t and t[0].isdigit():
                rows.append([float(v) for v in t])
            elif grab and t:
                grab = False
    return np.array(rows)


@pytest.fixture(scope="module")
def cli_rows(tmp_path_factory):
    """The SCRIPT's logged rows of both CLIs, run at once."""
    work = tmp_path_factory.mktemp("compute_cli")
    (work / "in.case").write_text(_gen.SCRIPT)
    procs = {pkg: _cli(pkg, str(work)) for pkg in ("lidp_tpu",
                                                    "lidp_tpu_torch")}
    out = {}
    for pkg, p in procs.items():
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
        out[pkg] = _log_rows(str(work / f"log.{pkg}"))
    return out


def _both(text, root=None, extra_files=()):
    out = []
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            s = jscript.LammpsScript(dtype=jnp.float64, log=lambda line: None)
        else:
            s = tscript.LammpsScript(dtype=torch.float64, device="cpu",
                                     log=lambda line: None)
        if root is not None:
            s.root = root
        s.execute(text.splitlines())
        out.append(s)
    return out


@pytest.fixture(scope="module")
def melt():
    """The SCRIPT's melt with PERATOM_EXTRA after its 4 steps, both
    packages (the per-atom computes are read on the final state)."""
    text = _gen.SCRIPT.replace("fix 1 all nve",
                               PERATOM_EXTRA + "fix 1 all nve")
    return _both(text)


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    import chip_smoke

    work = tmp_path_factory.mktemp("compute_chains")
    chip_smoke.chain_script_case(str(work), n_chains=8, n_beads=25)
    return _both(CHAIN_TEXT, root=str(work))


@pytest.mark.parametrize("col", COLS[1:])
def test_cli_rows_match_jax_and_lammps(cli_rows, col):
    trows, jrows = cli_rows["lidp_tpu_torch"], cli_rows["lidp_tpu"]
    gold = np.array(GOLDEN)
    assert trows.shape == jrows.shape == gold.shape
    assert (trows[:, 0] == gold[:, 0]).all()
    k = COLS.index(col)
    got, want = trows[:, k], jrows[:, k]
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max() + 1e-300, \
        (col, got, want)
    scale = max(1e-10, np.abs(gold[:, k]).max())
    assert np.abs(got - gold[:, k]).max() < 1e-8 * scale, (col, got,
                                                           gold[:, k])


def _peratom_ids(s):
    return [cid for cid, spec in s.computes.items()
            if spec[1] in tcomputes.PERATOM_STYLES]


@pytest.mark.parametrize("cid", ["ka", "pa", "sa", "crd", "cl", "dsp", "kh",
                                 "ph", "sh", "clh", "crh", "dh", "pr"])
def test_peratom_vectors_match_jax(melt, cid):
    js, ts = melt
    assert cid in _peratom_ids(ts)
    want = np.asarray(jcomputes.eval_peratom(js._sim, cid), float)
    got = tcomputes.eval_peratom(ts._sim, cid).numpy()
    assert got.shape == want.shape
    if cid in INTEGER:
        assert np.array_equal(got, want)
        assert got.max() > 0
    else:
        big = np.abs(want).max()
        assert big > 0
        assert np.abs(got - want).max() <= 1e-10 * big, cid
    # repeated evaluation (a fresh cache) gives the same bits
    ts._sim._peratom = (None, None, {})
    assert torch.equal(tcomputes.eval_peratom(ts._sim, cid),
                       torch.as_tensor(got))


@pytest.mark.parametrize("cid", ["rmin", "rave", "rmax", "rk", "rs", "rr"])
def test_reduce_matches_jax(melt, cid):
    js, ts = melt
    want = np.atleast_1d(np.asarray(jcomputes.eval_reduce(js._sim, cid),
                                    float))
    got = np.array([float(v) for v in tcomputes.eval_reduce(ts._sim, cid)])
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max() + 1e-300


@pytest.mark.parametrize("cid", ["pa", "sa", "ka"])
def test_bonded_peratom_matches_jax(chains, cid):
    js, ts = chains
    want = np.asarray(jcomputes.eval_peratom(js._sim, cid), float)
    got = tcomputes.eval_peratom(ts._sim, cid).numpy()
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max(), cid
    if cid == "pa":
        # the bond halves are in: pe/atom sums to the pair and bond energy
        sim = ts._sim
        total = float(sim.res.epair + sim.res.ebond)
        assert abs(got.sum() - total) <= 1e-10 * abs(total)


def test_chain_rows_match_jax(chains):
    js, ts = chains
    for jr, tr in zip(js.thermo_rows, ts.thermo_rows):
        for k in ("pe", "ebond", "c_rs[1]", "c_rs[2]", "c_rs[3]"):
            assert abs(tr[k] - jr[k]) <= 1e-10 * max(1.0, abs(jr[k])), k
