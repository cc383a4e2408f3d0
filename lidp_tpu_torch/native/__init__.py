"""The host helpers in C++ (lidp_tpu/native, an own copy): the Atoms
section's parse, the special lists, the velocity stream and the dump rows
(lidp_native.cpp).

The library is built with the host's C++ compiler ($CXX, else c++ or
g++) at its first use, into `lidp_tpu_torch/_build/native-<hash>/`, keyed
by a hash of the source, the flags and the compiler, as kernels/build.py
builds the CUDA sources: the compiler writes a name of its own process and
the finished library is renamed into place, so processes that build at
once (pytest-xdist's workers) never load a half-written file.  A build or
load failure raises; nothing falls back to Python behind the caller's
back.  The Python routines (io/data_reader.py's row loop, topology.py,
rng.py, io/dump.py's row formatter) stay as the plain versions, and the
tests hold the library to them bit for bit.

io/data_reader.py parses the Atoms rows with `parse_atoms`, and
io/dump.py formats dump custom and atom frames with `format_dump_rows`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "lidp_native.cpp"
BUILD = SRC.parent.parent / "_build"
# no FMA contraction: the stream's Box-Muller must round as Python's does
FLAGS = ["-O2", "-shared", "-fPIC", "-ffp-contract=off", "-std=c++17"]

# the Atoms layouts the library parses: (has_mol, has_q) by atom_style
ATOM_LAYOUTS = {"full": (1, 1), "atomic": (0, 0), "charge": (0, 1),
                "bond": (1, 0), "angle": (1, 0), "molecular": (1, 0)}

_P = ctypes.c_void_p
_L = ctypes.c_long


def _compiler() -> str:
    for cand in (os.environ.get("CXX"), "c++", "g++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    raise RuntimeError("no C++ compiler found ($CXX, c++ or g++): the "
                       "native helpers of lidp_tpu_torch need one")


def lib_path() -> Path:
    """Where the library of this source, these flags and this compiler
    lives."""
    cxx = _compiler()
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join([cxx] + FLAGS).encode())
    return BUILD / f"native-{h.hexdigest()[:16]}" / "liblidp_native.so"


def build() -> Path:
    """Compile the library unless it exists; returns its path."""
    path = lib_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".so.tmp{os.getpid()}")
    proc = subprocess.run([_compiler(), *FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SRC.name} failed:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, path)
    return path


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded library, built at the first call."""
    lib = ctypes.CDLL(str(build()))
    lib.parse_atoms.restype = _L
    lib.parse_atoms.argtypes = [ctypes.c_char_p, _L, _L, ctypes.c_int,
                                ctypes.c_int, _P, _P, _P, _P, _P, _P]
    lib.format_dump_rows.restype = _L
    lib.format_dump_rows.argtypes = [_L, ctypes.c_int, _P, _P, _P, _L]
    lib.build_special_lists.restype = ctypes.c_int
    lib.build_special_lists.argtypes = [ctypes.c_int, _L, _P, ctypes.c_int,
                                        _P, _P]
    lib.velocity_stream.restype = None
    lib.velocity_stream.argtypes = [ctypes.c_int, _L, ctypes.c_int, _P]
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_P)


def parse_atoms(text: bytes, natoms: int, atom_style: str):
    """The Atoms rows of `text` (the section's lines after its title) in
    `atom_style`'s layout: (dict of x (N,3), q (N,), type, mol (N,) int32,
    image (N,3) int32, the lines consumed)."""
    has_mol, has_q = ATOM_LAYOUTS[atom_style]
    x = np.zeros((natoms, 3))
    q = np.zeros(natoms)
    typ = np.zeros(natoms, np.int32)
    mol = np.zeros(natoms, np.int32)
    image = np.zeros((natoms, 3), np.int32)
    nlines = _L(0)
    got = library().parse_atoms(text, len(text), natoms, has_mol, has_q,
                                _ptr(x), _ptr(q), _ptr(typ), _ptr(mol),
                                _ptr(image), ctypes.byref(nlines))
    if got == -1:
        raise ValueError("Atoms section: an atom id outside 1..natoms")
    if got != natoms:
        raise ValueError(f"Atoms section: a malformed row or {got} rows "
                         f"of {natoms} ({atom_style} layout)")
    return dict(x=x, q=q, type=typ, mol=mol, image=image), nlines.value


def format_dump_rows(vals: np.ndarray, is_int) -> bytes:
    """The text rows of an (nrows, ncols) block: `%d` for the columns
    is_int marks, `%g` for the others (io/dump.py's Python formatter)."""
    vals = np.ascontiguousarray(vals, np.float64)
    flags = np.ascontiguousarray(is_int, np.uint8)
    nrows, ncols = vals.shape
    if flags.shape != (ncols,):
        raise ValueError(f"format_dump_rows: {flags.shape} flags for "
                         f"{ncols} columns")
    cap = nrows * ncols * 32 + 16
    out = ctypes.create_string_buffer(cap)
    w = library().format_dump_rows(nrows, ncols, _ptr(vals), _ptr(flags),
                                   ctypes.cast(out, _P), cap)
    if w < 0:
        raise RuntimeError("format_dump_rows: buffer too small")
    return out.raw[:w]


def special_lists(natoms: int, bonds: np.ndarray, pad_to_multiple: int = 8):
    """topology.special_lists in C++: (idx (N,S) int32 with `natoms` in
    the unused slots, level (N,S) int8)."""
    bonds = np.ascontiguousarray(np.asarray(bonds).reshape(-1, 2), np.int64)
    scap = 16
    while True:
        idx = np.full((natoms, scap), natoms, np.int32)
        lvl = np.zeros((natoms, scap), np.int8)
        maxs = library().build_special_lists(natoms, len(bonds), _ptr(bonds),
                                             scap, _ptr(idx), _ptr(lvl))
        if maxs < 0:
            raise ValueError("special lists: a bond atom id out of range")
        if maxs <= scap:
            S = -(-max(maxs, 1) // pad_to_multiple) * pad_to_multiple
            return idx[:, :S].copy(), lvl[:, :S].copy()
        scap = -(-maxs // pad_to_multiple) * pad_to_multiple


def velocity_stream(seed: int, natoms: int, dist: str) -> np.ndarray:
    """(natoms, 3) draws of one RanPark stream, three an atom: uniform - 0.5
    or gaussian (rng.RanPark's)."""
    out = np.zeros((natoms, 3))
    library().velocity_stream(int(seed), natoms,
                              0 if dist == "uniform" else 1, _ptr(out))
    return out
