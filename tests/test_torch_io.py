"""The port's file I/O and expression engine (lidp_tpu_torch.io) against
the JAX package's (lidp_tpu.io), on the same inputs:

  * read_data: every array and count of the DataFile equal (atom_style
    full with image flags, Masses, Velocities and Bonds, as
    chip_smoke.fluid_script_case writes it, plain and wrapped; and a
    small atom_style charge file);
  * write_data: the port's file reads back to the arrays it was written
    from (positions to 1e-15 relative: %.16g), and its text equals JAX's
    write_data of the same state but for the title line;
  * expr.evaluate and expr.evaluate_boolean: the same value, bit for bit,
    on a list of expressions (precedence, functions, variable and thermo
    references, the time-family functions);
  * write_dump_frame, dump custom (every ported column) and dump atom,
    over a group that leaves atoms out, with positions outside the box:
    identical text.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import chip_smoke  # noqa: E402
from lidp_tpu.io import data_reader as jreader  # noqa: E402
from lidp_tpu.io import data_writer as jwriter  # noqa: E402
from lidp_tpu.io import dump as jdump  # noqa: E402
from lidp_tpu.io import expr as jexpr  # noqa: E402
from lidp_tpu.io import script as jscript  # noqa: E402
from lidp_tpu_torch.box import Box  # noqa: E402
from lidp_tpu_torch.io import data_reader as treader  # noqa: E402
from lidp_tpu_torch.io import data_writer as twriter  # noqa: E402
from lidp_tpu_torch.io import dump as tdump  # noqa: E402
from lidp_tpu_torch.io import expr as texpr  # noqa: E402
from lidp_tpu_torch.io import script as tscript  # noqa: E402
from lidp_tpu_torch.state import make_system  # noqa: E402

CHARGE_DATA = """charge-style data

4 atoms
2 atom types

-1.0 9.0 xlo xhi
0.0 10.0 ylo yhi
0.5 11.5 zlo zhi

Masses

1 12.011
2 1.008

Atoms # charge

3 2 0.25 1.5 2.5 3.5 0 1 -1
1 1 -0.5 0.1 9.9 5.0
4 2 0.25 8.5 0.5 10.0 1 0 0
2 1 0.0 4.0 4.0 4.0
"""


def _assert_same_data(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            assert va is not None and vb is not None, f.name
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
            assert np.asarray(va).dtype == np.asarray(vb).dtype, f.name
        else:
            assert va == vb, f.name


@pytest.mark.parametrize("case", ["fluid", "wrapped", "charge"])
def test_read_data_matches_jax(tmp_path, case):
    if case == "charge":
        path = tmp_path / "charge.data"
        path.write_text(CHARGE_DATA)
        style = "charge"
    else:
        path, _ = chip_smoke.fluid_script_case(str(tmp_path), n_side=3,
                                               wrapped=case == "wrapped")
        style = "full"
    a = treader.read_data(str(path), atom_style=style)
    b = jreader.read_data(str(path), atom_style=style)
    _assert_same_data(a, b)
    if case == "wrapped":
        assert np.abs(a.image).max() == 1
    if case == "charge":
        np.testing.assert_array_equal(a.image[2], [0, 1, -1])


def _read(pkg, path):
    if pkg == "jax":
        import jax.numpy as jnp

        s = jscript.LammpsScript(dtype=jnp.float64)
    else:
        s = tscript.LammpsScript(dtype=torch.float64, device="cpu")
    s.one("atom_style full")
    s.root = str(path.parent)
    s.one(f"read_data {path.name}")
    return s


def test_write_data_round_trip_and_text(tmp_path):
    from pathlib import Path

    data, _ = chip_smoke.fluid_script_case(str(tmp_path), n_side=3)
    data = Path(data)
    ts, js = _read("torch", data), _read("jax", data)
    twriter.write_data(str(tmp_path / "port.data"), ts)
    jwriter.write_data(str(tmp_path / "jax.data"), js)
    back = treader.read_data(str(tmp_path / "port.data"))
    orig = ts.data
    for k in ("q", "type", "mol", "bonds", "mass", "box_lo", "box_hi"):
        np.testing.assert_array_equal(getattr(back, k), getattr(orig, k), k)
    for k in ("x", "v"):
        np.testing.assert_allclose(getattr(back, k), getattr(orig, k),
                                   rtol=1e-15, atol=0, err_msg=k)
    tt = (tmp_path / "port.data").read_text().splitlines()
    jt = (tmp_path / "jax.data").read_text().splitlines()
    assert tt[0] != jt[0] and tt[1:] == jt[1:]


class _Ctx:
    """The expression engine's context, backed by fixed values."""

    natoms = 3
    step = 40
    dt = 0.5
    in_run = True
    run_begin = 0
    run_end = 100

    def thermo(self, word):
        return {"temp": 300.5, "pe": -12.25, "step": 40.0, "dt": 0.5,
                "lx": 20.0}.get(word)

    def var_ref(self, name, mode):
        return {"a": 2.5, "b": -3.0}[name]

    def atom_vec(self, word):
        return {"x": np.array([0.5, 1.5, 2.5])}[word]

    def group_mask(self, name):
        return np.ones(3, bool)


EXPRS = ("2^3^2", "-2^2", "1+2*3-4/8", "7 % 3", "sqrt(16)+ln(2)-log(100)",
         "exp(0.5)*abs(-2)", "sin(0.3)+cos(0.3)+tan(0.3)", "asin(0.5)",
         "acos(0.5)+atan(0.5)+atan2(1,2)", "floor(2.7)+ceil(1.2)+round(2.5)",
         "PI", "v_a*v_b", "temp/2+pe", "step*dt", "lx^3", "1 < 2 && 3 >= 3",
         "!(1 == 2) || 0", "2 != 2", "ramp(0,10)", "stride(0,100,10)",
         "vdisplace(1,2)", "swiggle(0,1,10)", "cwiggle(0,1,10)",
         "logfreq(10,3,10)", "stagger(50,10)", "yes+no+on+off+true+false",
         "(v_a+1)*(v_b-1)/(2^0.5)", "1e-3*5E2", "x[2]+x[1]")
BOOLS = ('"1 < 2"', '"abc == abc"', '"abc != abd"', '"2.5 >= 3"',
         '"1 && 0"', '"1 || 0"', '"!1"', '"yes"')


def test_expr_matches_jax():
    ctx = _Ctx()
    for e in EXPRS:
        a, b = texpr.evaluate(ctx, e), jexpr.evaluate(ctx, e)
        assert a == b or (np.isnan(a) and np.isnan(b)), e
    for e in BOOLS:
        t = e.strip('"')
        assert texpr.evaluate_boolean(t) == jexpr.evaluate_boolean(t), e


@pytest.mark.parametrize("style", ["custom", "atom"])
def test_dump_frame_matches_jax(tmp_path, style):
    rng = np.random.RandomState(3)
    n, lo, hi = 7, np.array([-1.0, 0.0, 0.5]), np.array([9.0, 10.0, 11.5])
    x = rng.uniform(-6, 16, (n, 3))
    v, mu, f = (rng.normal(size=(n, 3)) for _ in range(3))
    q = rng.normal(size=n)
    typ = rng.randint(1, 3, n).astype(np.int32)
    mol = np.arange(1, n + 1, dtype=np.int32)
    gmask = np.array([1, 0, 1, 1, 0, 1, 1], bool)
    cols = (list(tdump.COLUMNS) if style == "custom"
            else ["id", "type", "xs", "ys", "zs"])
    stub = types.SimpleNamespace(type=typ, mol=mol)
    tsys = make_system(x, box=Box.create(lo, hi, dtype=torch.float64),
                       v=v, q=q, type=typ, mol=mol, dtype=torch.float64,
                       device="cpu")
    tsys = tsys.replace(mu=torch.as_tensor(mu), step=40)
    jsys = types.SimpleNamespace(
        x=x, v=v, mu=mu, q=q, step=40,
        box=types.SimpleNamespace(lo=lo, hi=hi, periodic=(True,) * 3))
    for k, (mod, sys_, ff) in enumerate(((tdump, tsys, torch.as_tensor(f)),
                                         (jdump, jsys, f))):
        spec = tscript.DumpSpec(did="d", group="g", style=style, every=10,
                                path=str(tmp_path / f"dump{k}"),
                                columns=cols)
        for _ in range(2):              # a second frame appends
            mod.write_dump_frame(spec, sys_, stub, gmask, f=ff)
    a = (tmp_path / "dump0").read_text()
    b = (tmp_path / "dump1").read_text()
    assert a == b
    assert a.count("ITEM: TIMESTEP") == 2 and len(a.splitlines()) == 2 * (
        9 + int(gmask.sum()))
