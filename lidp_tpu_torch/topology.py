"""Bond topology -> special 1-2/1-3/1-4 exclusion lists (numpy).

Host-side equivalent of Special::build (reference special.cpp:55): BFS over
the bond graph gives each atom its 1-2, 1-3 and 1-4 neighbor sets, closer
relations winning.  Bond ids are 1-based, as in LAMMPS data files.
"""

from __future__ import annotations

import numpy as np


def special_lists(natoms: int, bonds: np.ndarray, pad_to_multiple: int = 8):
    """Padded per-atom special lists: (idx (N,S) int32, level (N,S) int8).

    Unused slots hold `natoms` / level 0.  S is the max special count padded
    up to a multiple of `pad_to_multiple`.
    """
    per_atom = _special_sets(natoms, bonds)
    S = max(1, max((len(a) + len(b) + len(c) for a, b, c in per_atom),
                   default=1))
    S = -(-S // pad_to_multiple) * pad_to_multiple
    idx = np.full((natoms, S), natoms, np.int32)
    lvl = np.zeros((natoms, S), np.int8)
    for i, (onetwo, onethree, onefour) in enumerate(per_atom):
        k = 0
        for level, group in ((1, onetwo), (2, onethree), (3, onefour)):
            for j in sorted(group):
                idx[i, k] = j
                lvl[i, k] = level
                k += 1
    return idx, lvl


def _special_sets(natoms: int, bonds: np.ndarray):
    """Per-atom (1-2, 1-3, 1-4) neighbor sets; closer relation wins
    (Special::build + find_special first-match semantics)."""
    adj = [[] for _ in range(natoms)]
    for a, b in bonds:
        a, b = int(a) - 1, int(b) - 1
        adj[a].append(b)
        adj[b].append(a)
    out = []
    for i in range(natoms):
        onetwo = set(adj[i])
        onethree = set()
        for j in onetwo:
            onethree.update(adj[j])
        onethree -= onetwo | {i}
        onefour = set()
        for j in onethree:
            onefour.update(adj[j])
        onefour -= onetwo | onethree | {i}
        out.append((onetwo, onethree, onefour))
    return out
