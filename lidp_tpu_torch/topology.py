"""Bond topology -> special 1-2/1-3/1-4 exclusion lists (numpy).

Host-side equivalent of Special::build (reference special.cpp:55): BFS over
the bond graph gives each atom its 1-2, 1-3 and 1-4 neighbor sets, closer
relations winning.  Bond ids are 1-based, as in LAMMPS data files.
`special_codes_dense` gives the same relations as an (N,N) code matrix
for the dense route.  `infer_image_flags` derives image flags from the
bond graph.
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


def special_codes_dense(natoms: int, bonds: np.ndarray) -> np.ndarray:
    """(N,N) int8 special-bond codes: 1, 2, 3 for the 1-2, 1-3, 1-4
    partners of each row's atom, 0 elsewhere.  bonds: (NB,2) 1-based atom
    ids."""
    code = np.zeros((natoms, natoms), np.int8)
    if np.asarray(bonds).size == 0:
        return code
    for i, sets in enumerate(_special_sets(natoms, bonds)):
        for level, group in enumerate(sets, start=1):
            for j in group:
                code[i, j] = level
    return code


def infer_image_flags(x, bonds, box_lo, box_hi, mol=None):
    """Derive periodic image flags from the bond graph.

    Molecular data files written without image flags (e.g. the
    polarization examples' pdb-derived restarts) leave through-boundary
    bonds ambiguous: `replicate` unmaps atoms via image flags
    (replicate.cpp:137-140 domain->unmap), so zero flags tear bonded
    frameworks apart at the seam — copies then see ~1 A nonbonded
    contacts that the original cell excluded as 1-2 specials.

    BFS over each bond-connected component: the first atom keeps image 0;
    every neighbor's flag is chosen so the bond vector is the minimum
    image (hops never exceed one cell).  Equivalent to the modern
    `reset_atoms image` command; returns an (N, 3) int array.
    """
    from collections import deque

    x = np.asarray(x, float)
    n = x.shape[0]
    L = np.asarray(box_hi, float) - np.asarray(box_lo, float)
    img = np.zeros((n, 3), np.int32)
    if bonds is None or len(bonds) == 0:
        return img
    b = np.asarray(bonds)
    if b.min() >= 1:
        b = b - 1                       # 1-based data-file ids
    adj = [[] for _ in range(n)]
    for i, j in b:
        adj[int(i)].append(int(j))
        adj[int(j)].append(int(i))
    seen = np.zeros(n, bool)
    for root in range(n):
        if seen[root] or not adj[root]:
            continue
        seen[root] = True
        dq = deque([root])
        while dq:
            i = dq.popleft()
            xu_i = x[i] + img[i] * L
            for j in adj[i]:
                if seen[j]:
                    continue
                seen[j] = True
                img[j] = np.round((xu_i - x[j]) / L).astype(np.int32)
                dq.append(j)
    if mol is not None:
        # bond-less members of a bonded molecule (e.g. the massless MOV
        # charge sites of the polarizable CH4 model — present in the data's
        # molecules but absent from its Bonds section) anchor to their
        # molecule's bonded component by minimum image.  Molecules with NO
        # bonds at all (the MOF framework, which spans the whole cell) are
        # left alone — min-image anchoring is only valid for compact
        # molecules, and wrapped positions are already equivalent for them.
        mol = np.asarray(mol)
        has_bonds_mol = set(np.unique(mol[seen])) - {0}
        anchor = {}
        for i in np.nonzero(seen)[0]:
            anchor.setdefault(int(mol[i]), i)
        for j in np.nonzero(~seen)[0]:
            m = int(mol[j])
            if m in has_bonds_mol:
                i = anchor[m]
                xu_i = x[i] + img[i] * L
                img[j] = np.round((xu_i - x[j]) / L).astype(np.int32)
    return img
