"""The C++ host helpers of lidp_tpu_torch (native/lidp_native.cpp through
native/__init__.py) against the port's Python routines, bit for bit, and
against the JAX package's native library on the same inputs:

  * the build: keyed by a hash into its own directory, written under a
    name of the building process and renamed, so that processes building
    at once (pytest-xdist's workers) all load a whole library; a source
    that does not compile raises;
  * the Atoms section's parse (io/data_reader.py, native=True against
    native=False) in the full, atomic, charge, bond and molecular
    layouts, with comments, blank lines, image flags on some rows and
    rows out of order; files written by the port's write_data; malformed
    rows and ids out of range raise;
  * the special lists (topology.special_lists), the velocity stream
    (rng.RanPark) and the dump rows (io/dump.py's format_rows with
    native=False, and a whole dump custom file).
"""

import functools
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import chip_smoke
from lidp_tpu_torch import native, rng, topology
from lidp_tpu_torch.io import dump as dump_mod
from lidp_tpu_torch.io.data_reader import read_data
from lidp_tpu_torch.io.script import LammpsScript

REPO = Path(__file__).resolve().parent.parent
LAYOUTS = ("full", "atomic", "charge", "bond", "molecular")


def _jax_native():
    """The JAX package's library, built by its own loader (None where it
    cannot build)."""
    pytest.importorskip("jax")
    from lidp_tpu import native as jn

    if jn.get_lib() is None:
        pytest.skip("the JAX package's native library did not build")
    return jn


def test_build_keyed_and_atomic(tmp_path):
    """Four processes build into one empty directory at once: each gets
    the same library, which loads, and no partial file is left."""
    code = ("import sys; from pathlib import Path; "
            "import lidp_tpu_torch.native as n; n.BUILD = Path(sys.argv[1]);"
            " p = n.build(); n.library.cache_clear(); import ctypes; "
            "ctypes.CDLL(str(p)); print(p)")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        outs.append(out.strip())
    assert len(set(outs)) == 1
    lib = Path(outs[0])
    assert lib.parent.parent == tmp_path and lib.name == "liblidp_native.so"
    assert sorted(f.name for f in lib.parent.iterdir()) == [lib.name]
    assert lib.parent.name == native.lib_path().parent.name


def test_build_failure_raises(tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    with mock.patch.object(native, "SRC", bad), \
            mock.patch.object(native, "BUILD", tmp_path / "b"):
        with pytest.raises(RuntimeError, match="building bad.cpp failed"):
            native.build()


def _atoms_text(style, n, seed):
    """An Atoms section of n rows in `style`'s layout, ids shuffled, with
    comments, blank lines, image flags on some rows and odd float
    spellings."""
    r = np.random.default_rng(seed)
    spell = [lambda v: repr(float(v)), lambda v: "%.6e" % v,
             lambda v: "%.3E" % v, lambda v: "%g" % v]
    rows = []
    for i in r.permutation(n) + 1:
        w = [str(i)]
        if style in ("full", "bond", "molecular"):
            w.append(str(r.integers(0, 50)))
        w.append(str(r.integers(1, 4)))
        if style in ("full", "charge"):
            w.append(spell[r.integers(4)](r.normal()))
        w += [spell[r.integers(4)](v) for v in r.uniform(-5, 25, 3)]
        if r.uniform() < 0.5:
            w += [str(v) for v in r.integers(-3, 4, 3)]
        line = " ".join(w)
        if r.uniform() < 0.2:
            line += "  # a comment 1 2 3"
        rows.append(line)
        if r.uniform() < 0.1:
            rows.append("")
        if r.uniform() < 0.05:
            rows.append("# a comment line")
    return "\n".join(rows) + "\n"


def _data_file(path, style, n, seed):
    text = (f"a data file\n\n{n} atoms\n3 atom types\n\n0 20 xlo xhi\n"
            f"0 20 ylo yhi\n0 20 zlo zhi\n\nMasses\n\n1 1.0\n2 2.0\n3 3.0\n"
            f"\nAtoms # {style}\n\n" + _atoms_text(style, n, seed)
            + "\nVelocities\n\n" + "".join(
                f"{i} 0.{i} -0.{i} 1e-{i % 9}\n" for i in range(1, n + 1)))
    path.write_text(text)
    return path


def _same(a, b):
    for f in ("x", "q", "type", "mol", "image", "v", "mass", "box_lo",
              "box_hi"):
        u, w = getattr(a, f), getattr(b, f)
        assert u.dtype == w.dtype and np.array_equal(u, w), f


@pytest.mark.parametrize("style", LAYOUTS)
def test_parse_atoms_matches_python(tmp_path, style):
    path = _data_file(tmp_path / "d.data", style, 700, seed=len(style))
    _same(read_data(str(path), style, native=True),
          read_data(str(path), style, native=False))


def test_parse_atoms_full_matches_jax(tmp_path):
    jn = _jax_native()
    text = _atoms_text("full", 300, 11)
    got, _ = native.parse_atoms(text.encode(), 300, "full")
    ref = jn.parse_atoms_full(text, 300)
    for k in ("x", "q", "type", "mol", "image"):
        assert np.array_equal(got[k], ref[k]), k


def test_parse_atoms_refuses(tmp_path):
    with pytest.raises(ValueError, match="outside"):
        native.parse_atoms(b"1 1 0 0 0\n5 1 0 0 0\n", 2, "atomic")
    with pytest.raises(ValueError, match="malformed"):
        native.parse_atoms(b"1 1 0 0 0\n2 1.5 0 0 0\n", 2, "atomic")
    with pytest.raises(ValueError, match="malformed"):
        native.parse_atoms(b"1 1 0 0 0\nVelocities\n", 2, "atomic")


@pytest.mark.parametrize("style", ["atomic", "full"])
def test_written_data_reads_the_same(tmp_path, style):
    """The port's write_data output (in.lj's lattice; the water molecules
    for full) read by both parses: equal arrays, and the positions
    written."""
    s = LammpsScript(dtype=torch.float64, device="cpu",
                     log=lambda line: None)
    s.root = str(tmp_path)
    if style == "atomic":
        text = chip_smoke.LJ_SCRIPT.split("pair_style")[0]
        s.variables.update(x="0.4", y="0.4", z="0.4")
    else:
        (tmp_path / "wat.mol").write_text(chip_smoke.WATER_MOL)
        text = chip_smoke.water_script(3).split("pair_style")[0]
    s.execute(text.splitlines())
    s.one("write_data w.data")
    a = read_data(str(tmp_path / "w.data"), style, native=True)
    _same(a, read_data(str(tmp_path / "w.data"), style, native=False))
    np.testing.assert_allclose(a.x, s.x, rtol=1e-15, atol=1e-14)


def test_special_lists_match(tmp_path):
    r = np.random.RandomState(3)
    natoms = 300
    bonds = np.array([[i + 1, r.randint(max(1, i - 3), i + 1)]
                      for i in range(1, natoms)], np.int64)
    got = native.special_lists(natoms, bonds)
    ref = topology.special_lists(natoms, bonds)
    for u, w in zip(got, ref):
        assert u.dtype == w.dtype and np.array_equal(u, w)
    jn = _jax_native()
    for u, w in zip(got, jn.special_lists(natoms, bonds)):
        assert np.array_equal(u, w)


@pytest.mark.parametrize("dist", ["uniform", "gaussian"])
def test_velocity_stream_match(dist):
    n = 500
    got = native.velocity_stream(12345, n, dist)
    r = rng.RanPark(12345)
    ref = np.array([[r.uniform() - 0.5 for _ in range(3)]
                    if dist == "uniform" else
                    [r.gaussian() for _ in range(3)] for _ in range(n)])
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, _jax_native().velocity_stream(
        12345, n, dist))


def test_format_dump_rows_match():
    r = np.random.default_rng(5)
    vals = np.concatenate([
        np.arange(1, 401, dtype=float)[:, None],
        r.integers(1, 5, (400, 1)).astype(float),
        r.normal(size=(400, 3)) * 10.0 ** r.integers(-12, 12, (400, 3)),
        np.tile([0.0, -0.0, 1e300, 123456789.0, 1.5e-7], (400, 1))], 1)
    flags = [True, True] + [False] * 8
    got = dump_mod.format_rows(vals, flags)
    assert got == dump_mod.format_rows(vals, flags, native=False)
    jn = _jax_native()
    assert got.encode() == jn.format_dump_rows(vals, np.array(flags,
                                                              np.uint8))


def test_dump_file_matches_python_formatter(tmp_path):
    """A dump custom file of in.lj written through the C++ rows and through
    the Python loop: the same bytes."""
    out = []
    plain = dump_mod.format_rows
    for native_rows in (True, False):
        d = tmp_path / str(native_rows)
        d.mkdir()
        s = LammpsScript(dtype=torch.float64, device="cpu",
                         log=lambda line: None)
        s.variables.update(x="0.3", y="0.3", z="0.3")
        (d / "in.lj").write_text(chip_smoke.LJ_SCRIPT.replace(
            "run\t\t100", "dump 1 all custom 5 d.dump id type x y z vx fx\n"
            "run 10"))
        with mock.patch.object(dump_mod, "format_rows",
                               functools.partial(plain, native=native_rows)):
            s.file(str(d / "in.lj"))
        out.append((d / "d.dump").read_bytes())
    assert out[0] == out[1] and out[0].count(b"ITEM: TIMESTEP") == 3
