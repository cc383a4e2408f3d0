#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (lidp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure:
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. build every CUDA kernel from lidp_tpu_torch/csrc (nvcc, in parallel);
  3. kernel parity: each of the eight panel kernels against its plain
     PyTorch version on the card, on a random case at the main paths' shape
     (12,288 x 12,288) and on a ragged one (1,000 rows with masked atoms
     that keep their charge, alpha=0 atoms and special lists); pair_panel
     with and without coulomb, pair_panel_df with and without the fused
     Wolf field.  float32 kernels: per-row rtol 1e-4, atol 1e-5*max|ref|,
     scalars rel 1e-4 of the largest entry of their vector (float32 sums
     over ~1e8 pairs in another order; the line prints the scalars' worst
     ratio to that bar).  float64 (`*_df`) kernels: per-row rtol 1e-9,
     atol 1e-11*max|ref|; scalars rel 1e-10 (double sums in another order;
     a kernel at float32 grade anywhere misses this by four orders).  Every
     launch repeats bit-identically.  Median kernel and plain times (CUDA
     events around each call, the wrapper's host work included), the time
     per call of 20 calls queued back to back (ms_queued: the kernels alone
     while the host keeps ahead) and the bound (for the eind and dipole
     kernels the function's least arithmetic, EIND_FLOPS_PAIR,
     DIPOLE_FLOPS_*, PAIR_FLOPS_* and WOLF_FLOPS_FIELD, counted on the
     case, beside the CostEstimate's as bound_ms_cost_estimate).
     eind_panel{,_df}, dipole_panel{,_df}, pair_wolf_panel, pair_panel,
     pair_panel_df and wolf_panel run the whole-panel kernels (each pair
     once for both atoms); their [strip form] variants, cols = all atoms
     and row0 = 0, run the one-sided strip kernels on the same operands in
     the same call, their [no skip] variants the whole-panel kernels with
     the exact skips off (eind's damping skip by an infinite threshold,
     the dipole kernel's warp skips by DIPOLE_SKIP, the pair template's by
     PAIR_SKIP) and the pair template's (the pair kernels' and
     wolf_panel's) [no cull] variants without the tile-pair test
     (PAIR_CULL), which must give the same bits; eind and dipole each in
     the fluid's exponential damping and in damping none (the reference's
     default), pair_panel also LJ only, pair_panel_df also without the
     field.  Then ptxas's registers and spills, the share of warp votes in
     which the eind kernels skipped the damping exponential, the dipole
     kernels the charge-dipole and the dipole-dipole block and the pair
     template's kernels all their blocks, the share of tile pairs those
     dropped, and the partial buffers of the float64 whole kernels and of
     wolf_panel's with the device memory reserved over a call of each;
     then the pair kernels at the outer cutoff (cutoff_pairs_parity): a
     pair at exactly rsq == cutsq and one one ulp inside it, placed so
     that a rsq contracted into fused multiply-adds puts each on the other
     side; the strip kernel and the whole kernel, float32 and float64,
     give the rows that take a force and the field exactly as the plain
     version does; and the dipole kernels on the same pairs with dipoles
     (dipole_cutoff_parity): strip and whole kernel, float32 and float64,
     one polar atom (no dipole-dipole pair: only the charge-dipole force
     decides the rows, exactly rows 2 and 3) and all four polar, at the
     bars above;
  4. the main paths on the 10,125-atom synthetic fluid, every launch
     counter set to 0 just before each and read just after:
     A. float32 fused step through the kernels: initial forces + 20 steps
        (eind, dipole, pair and wolf: the whole-panel kernels, never the
        strip kernels, on every path A-D);
     B. float32 host phases (make_host_phases + HostPolarForces, pure CG):
        initial forces + 5 steps; step 0 against path A's step 0 (energies
        rel 1e-5, forces rtol 5e-4, atol 5e-5*max);
     C. float64 at polar_precision 1e-11, host phases with the
        mixed-precision solve: initial forces + 5 steps, converged at
        every step;
     D. float64 fused step, initial forces only: the pure float64 CG
        through eind_panel_df;
     then step 0 of each against the float64 plain path (panel="scan",
     pure CG at 1e-11) on the card: A energies rel 1e-4, epol abs 2e-2,
     forces rtol 5e-4, atol 5e-5*max; C and D evdwl/ecoul/elong rel 1e-10,
     epol rel 1e-8, forces and dipoles atol 1e-8*max; D's iteration count
     within 1 of the plain path's;
     G. the fluid as 3,375 rigid molecules (fix rigid/nve molecule:
        polar_bench.build_rigid, FastPolarRunner, fused, float32, CG at
        1e-6): setup + 20 steps timed as A, a thermo row a step (temp
        with the rigid dof, epol) and etotal's drift printed; every step
        finite, each body's intra-body distances at step 20 equal to
        setup's within 1e-4 relative, |q| within 1e-5 of 1, step 0
        against the float64 plain path at A's bars; then 10 more steps,
        each synchronised, with CUDA events around the rigid integrator's
        two halves and the force evaluation (the integrator's share); its
        displacements and quaternion changes over the first 3 steps
        within 1e-2 of their largest entry of G64's plain route's (the
        one gate that a wrong integrator fails: the ones above hold by
        construction);
     G64. the same bodies in float64 at 1e-11 in host mode
        (LIDP_FAST_POLAR_MODE=host: the mixed solve and the dipole
        predictor): setup + 3 steps through the kernels against the same
        through panel="scan" (the plain versions, which launch no kernel)
        on the card: thermo columns rel 1e-9 of max(1, |value|),
        positions, dipoles and quaternions 1e-8 of their largest entry;
     H. the same rigid fluid from a LAMMPS input and data file
        (fluid_script_case: FLUID_SCRIPT, the keywords of
        synthetic_forcefield) through the script front end in this
        process: LammpsScript(dtype=torch.float64) at precision 1e-11, 5
        steps, fused mode (eind_panel_df, pair_panel_df, dipole_panel_df);
        its launches equal those of build_rigid(float64, 1e-11) +
        setup_rigid + run_rigid(5) on the same card, and its 6 rows equal
        that route's, every thermo column within rel 1e-9 of max(1,
        |value|); steps_per_s_H from the run's Loop time line;
     H32. the CLI as a user runs it, in a process of its own: `python -m
        lidp_tpu_torch -in in.fluid -log log.h32 --f32 -var prec 1e-6 -var
        nstep 20` exits 0 and its 21 logged rows agree with path G's (the
        same system, float32, fused, 1e-6): step 0 rel 1e-6, steps 1-20
        rel 1e-5 of max(1, |value|); its Performance line;
     I. the dense route, the one the reference's own examples take (at
        most 4096 atoms without LIDP_FAST_POLAR): fluid_script_case at
        n_side 8 (1,536 atoms) through LammpsScript(dtype=torch.float64)
        in this process, precision 1e-11, 5 steps, fix rigid/nve
        molecule: the generic Runner on the unpadded System, every kernel
        counter 0; its 6 rows against the same script with
        LIDP_FAST_POLAR=1 (the panel engine, path H's route) on the card,
        every thermo column within rel 1e-9 of max(1, |value|) (the JAX
        package's bar between its two routes); steps_per_s_I from the
        Loop time line, the peak device memory, and each phase's ms a
        step by CUDA events over 2 more steps (pair, ewald, the Wolf
        field, T build, solve with its iterations, dipole forces), with
        the rigid/nve integrator's ms and host reads a step as path J
        reads its own;
     I-CLI. `python -m lidp_tpu_torch -in in.fluid -log log.i -var nstep
        5` in a process of its own without LIDP_FAST_POLAR: exit 0, its
        rows equal path I's at the printed precision;
     I-cap. fluid_script_case at n_side 11 (3,993 atoms, just under the
        cap), float64, setup + 3 steps on the dense route: counters 0,
        rows finite, every solve converged; steps/s, the phases' ms an
        evaluation and the peak memory;
     J. the Nose-Hoover thermostat of the reference's examples, on the
        dense route: thermostat_script("J", 8) (1,536 atoms, float64,
        precision 1e-11, 5 steps): `fix 1 moving rigid/nvt molecule temp
        300.0 350.0 50.0 tparam 50 1 3` on half the molecules (the SIFSIX
        example's form), the others at rest with no integrator, `compute
        movingtemp moving temp` and its c_movingtemp column: every counter
        0, the dense route's Runner, rows finite; its rows and final x, v,
        mu against its CPU twin (phase 10: the same script through the
        port on the CPU in float64, after the card's paths): rows within
        rel 1e-9 of max(1, |value|), x, v and mu
        within 1e-8 of their largest entry; steps/s by its Loop time line,
        the peak memory, and over 2 more steps the phases (DensePhases),
        the integrator's ms a step (IntegratorTimer: CUDA events around
        its halves, the host's chain arithmetic included, and the chain
        updates alone by the host clock) and the host reads a step
        (HostReads: the synchronizing CUDA operations), the integrator's
        and all;
     J-all. the same fix on all molecules, I's columns, 5 steps: step 0's
        row equals path I's; step 1's pe, evdwl, ecoul, elong and epol,
        and x after one step (a 1-step run of each form), equal I's bit
        for bit (the chain at rest in step 1's drift: exp(-dtq 0) = 1);
        ke and temp differ from I's at steps 1-5;
     K. `fix 1 all nvt temp 300.0 300.0 50.0` on the same 1,536 atoms, 5
        steps: as J, with its own CPU twin and readings;
     J-cap. J at n_side 11 (3,993 atoms, just under the cap), setup + 3
        steps: counters 0, rows finite, every solve converged, J's
        readings;
  5. the LJ melt of bench/in.lj on the cell engine (lj_melt.build), float32:
     kernel parity of slot_lj_forces and cell_pair_forces_lj against their
     plain versions at the melt's (11,11,11,40) grid (the melt after path
     E's 500 steps: on the lattice of step 0 the forces cancel to rounding),
     on a ragged (3,4,5) grid with masked atoms, an empty cell and a full
     one, on a (3,4,5) grid whose every slot holds an atom, and on the
     ragged grid with each cell's slots in a random order (its live slots
     no prefix of the cell), and on dense (3,3,3) grids at the caps where
     the kernels' launchers change tile (tile_caps; one cap past the
     narrow tile's last must raise), need_ev on and off: forces 5e-6 of
     max |f|, evdwl and virial rel 1e-5 (float32 sums in another order,
     and a pair across the periodic face sees x_j + L from one side and
     x_i - L from the other, each rounded at twice the box length; the bar
     of the JAX package's own slot-runner test), repeats bit-identical; at
     the melt's grid the times (by events around the call and queued) and
     the bound: the function's least arithmetic counted on the state timed
     (LJ_FLOPS_TEST per unordered live pair of the half stencil,
     LJ_FLOPS_FORCE per pair inside the cutoff), beside the TPU kernel's
     count; with
     and cell_pair_forces_lj on the ragged case at cap 12, which the full
     cell overflows (overflow_lj_case): its atoms without a slot take the
     force of the slot they share, as in the plain version;
     E. 32,000 atoms through SlotRunner: setup, 100 steps, a timed window
        of 400 more; step 0 against the reference log's temp 1.44, pe
        -6.7733681, etotal -4.6134356, press -5.0197073 (rel 1e-6, 1e-5,
        1e-5, 1e-4), step 100 etotal against -4.6223613 (rel 2e-4: float32
        on stale cells);
     F. the same melt through the generic Runner on cells, setup + 100
        steps: step 0 equal to E's (energies rel 1e-5, forces 5e-6), step
        100 etotal rel 1e-4, temp and pe 2e-3 of E's;
     step 0 of E against the float64 plain route (ops/cells.cell_pair_forces
     on the card): forces 1e-5, evdwl rel 1e-6; and
     E4. SlotRunner at scale 4 (2,048,000 atoms, grid 47^3 x 40): setup +
        100 steps, no overflow, finite; step 0 pe against the log's (rel
        1e-5: the lattice energy per atom does not depend on the size);
        step 100 etotal within rel 1e-3 of the log's -4.6223613 and within
        3e-3 of step 0 (the log itself moves 1.9e-3 over these 100 steps:
        the lattice melts under an unshifted cutoff); then slot_lj_forces
        against its plain version at this grid on the run's last state,
        need_ev off and on, at the bars above, repeats bit-identical, with
        the times and the bound as at the melt's grid.
     On the fcc lattice of step 0 the forces cancel to rounding, so force
     bars there are taken of max(max |f|, 1), the nearest-neighbour pair
     force being 2;
  6. the atomic inputs and the cell grid from a LAMMPS script
     (script_cell_paths), each path printing its route, its steps/s by its
     Loop time line and its peak device memory beside the nvidia-smi line:
     L. bench/in.lj verbatim (LJ_SCRIPT: 32,000 atoms, run 100) through
        the CLI's main() in this process with --f32: the cell grid, pair
        route cell_pair_forces_lj; step 0 against the reference log at
        path E's bars, step 100 TotEng within rel 2e-4 of -4.6223613;
        cell_pair_forces_lj launched, slot_lj_forces not; its Performance
        line beside path F's rate;
     L64. the same input in float64 through LammpsScript: the plain
        cell_pair_forces (JAX's gate), no launch; step 0 and step 100 at
        tests/test_lj_bench.py's bars;
     M. examples/melt/in.melt (MELT_SCRIPT: 4,000 atoms, the dense
        route, run cut to 100), float64, its dump atom: step 0 at
        tests/test_melt_example.py's bars (5e-8 absolute, Press 5e-7),
        steps 50 and 100 at rel 2e-3 and 2e-2; three dump frames;
     N. the point-charge fluid (point_charge_script on
        fluid_script_case(n_side=15), 10,125 atoms, above the cap), float64:
        at the default skin its 7^3 grid overfills and the run aborts with
        the JAX package's message; with `neighbor 1.0 bin` (CELL_SKIN) the
        cell grid with the special correction and Ewald: step 0's forces,
        virial and energies against dense_forces on the same state with
        special_codes_dense built directly, rel 1e-9 of max(1, |value|)
        plus CANCEL_REL of the magnitude the correction cancels
        (cancelled()); then 5 steps, rows finite, no overflow, no launch;
     N-pol. the polar fluid at n_side 12 (5,184 atoms) with
        LIDP_FAST_POLAR=0 and the same skin: cells, correction, Ewald and
        the dense polar term, 3 steps, no launch; its rows against the same
        input with LIDP_FAST_POLAR=1 (the panel engine) at rel 1e-9 plus
        CANCEL_REL of the cancelled magnitude;
  7. the mesh k-space and the barostats from a LAMMPS script
     (barostat_paths), each path printing its route, its steps/s by its
     Loop time line and its peak device memory; O, R, R-pppm and Q64
     have CPU twins (phase 10):
     O. path I's input with `kspace_style pppm 1e-4`, 1,536 atoms, the
        dense route, float64 at 1e-11, 5 steps: no launch, rows and
        final x, v, mu against the CPU twin; PPPM's grid and g_ewald
        beside ewald/disp's g_ewald and k-vector count; the phases
        (`pppm` among them), the integrator and host reads;
     R. path I's input with `fix 1 all rigid/npt molecule temp 300 300
        100 iso 1 1 1000` and ewald/disp (rescale_coeffs at every call),
        5 steps: no launch, every_step_ev, the volume moves, the CPU
        twin, the integrator's ms and host reads a step (IntegratorTimer,
        HostReads); R-pppm the same with pppm;
     Q. bench/in.lj with `fix 1 all npt temp 1.44 1.44 0.5 iso
        -5.0197073 -5.0197073 5.0` in place of fix nve (q_script), 32,000
        atoms, through the CLI's main() with --f32, 100 steps, a row
        every 10: cell_pair_forces_lj launched (under a box that moves
        each step), slot_lj_forces not; the volume moves; step 0 at path
        L's bars against the in.lj log (NPT leaves step 0 as it is); the
        npt integrator's ms and host reads a step; the smallest box edge
        over the run (BoxWatch) and its bin beside cut + skin;
     Q64. the same input in float64 through LammpsScript, 20 steps: no
        launch; Q's steps 10 and 20 within rel 2e-4 of Q64's in etotal,
        pe and vol; the CPU twin;
     P. the point-charge fluid (path N's, 10,125 atoms, neighbor 1.0 bin)
        with pppm 1e-4 on the cell grid, float64: step 0 against
        dense_forces as N is held (cells_step0_vs_dense); pppm_forces
        against ewald_forces on tests/test_pppm.py's case on the card
        (pppm_vs_ewald_case: elong rel 1e-4, f 1e-4 of max |f|); two
        evaluations of pppm_forces on one state and whether they agree
        bit for bit; then 5 steps, no launch, no overflow, PPPM's ms a
        call by CUDA events;
     P100. the same fluid at n_side 32 (98,304 atoms, L = 128 A), 3
        steps: one ewald_forces evaluation on the step-0 state at PPPM's
        g_ewald (its ms, k-vector count and elong beside PPPM's), PPPM's
        ms a call;
  8. flexible molecules from a LAMMPS script (flexible_paths):
     flexible_script_case's solute (N-methylacetamide: harmonic bonds,
     charmm angles with Urey-Bradley terms, charmm dihedrals with their
     1-4 term, harmonic impropers) in TIP3P-like water with
     examples/peptide's styles (lj/charmm/coul/long 8 10, pppm 1e-4,
     special_bonds charmm, timestep 2.0, thermo_style multi) and `fix
     shake` on the X-H bonds and the water; float64, 10 steps, a row
     each step; CPU twins of 2 steps (phase 10; T's on
     FLEX_T_TWIN_THREADS threads):
     S. examples/peptide's stack on the dense route: 1,920 atoms, `fix
        nvt temp 275 275 100 tchain 1`;
     T. bench/in.rhodo's stack on the cell grid: S's cell replicated 2 x
        2 x 4 (30,720 atoms), `fix npt temp 275 275 100 iso 1 1 1000 mtk
        no pchain 0 tchain 1`;
     each: no launch, its route, steps/s by its Loop time line and its
     peak memory; every row finite, and at every row each SHAKE bond and
     angle within the fix's tolerance (1e-4 relative) of its target
     (ConstraintWatch); rows 0-2 against the CPU twin at rel 1e-9 of
     max(1, |value|) plus CANCEL_REL of the cancelled magnitude on the
     cell grid; two evaluations of the bonded terms on one state and
     whether they agree bit for bit (index_add_'s float atomics); the ms
     a step of the bonded terms, SHAKE, the pair pass (and the cell
     grid's special correction) and PPPM by CUDA events over 2 more
     steps;
  9. bench/in.chain and the modifier fixes from a LAMMPS script
     (chain_paths, modifier_paths), each path printing its route, its
     steps/s by its Loop time line and its peak device memory, no launch:
     U. bench/in.chain verbatim (CHAIN_SCRIPT: atom_style bond,
        special_bonds fene, FENE bonds, lj/cut 1.12 shifted, fix nve and
        fix langevin) on chain_script_case (320 chains of 100 beads,
        32,000 atoms, 31,680 bonds, rho* 0.85) through the CLI's main()
        with --f32, 100 steps: the cell grid, its pair route the plain
        cell pass (the special lists keep the LJ kernel off, as JAX's
        _pallas_ok does), rows finite; then the same input in float32
        over U_PHASE_STEPS steps, the ms a step of the cell pass, the
        special correction, the FENE bonds, fix langevin's stream and its
        hook as a whole (stream and friction) by CUDA events;
     U64. the same input in float64 through LammpsScript, a row each
        step, 10 steps: U's step 0 within rel 2e-4 of U64's (Q's bar
        against Q64); rows 0-2 against the CPU twin at rel 1e-9 of
        max(1, |value|) plus CANCEL_REL of the cancelled magnitude (the
        noise is integer threefry, the same on both devices);
     V. path N's point-charge fluid (10,125 atoms, lj/cut/coul/long +
        Ewald, neighbor 1.0 bin, the cell grid) under fix nve with
        setforce, addforce, aveforce, viscous, efield, spring/self,
        spring tether and planeforce each on a group of its own (100
        molecules by ID), momentum, recenter and temp/berendsen, float64,
        10 steps: rows 0-2 against the CPU twin at N's bars;
     W. examples/melt (M's input, 4,000 atoms, the dense route) with
        temp/rescale, temp/csld and langevin on three groups, float64, 10
        steps: rows 0-2 against the CPU twin at rel 1e-9; threefry's bits
        and uniforms of one key equal on the card and the CPU;
 10. bench/in.eam and the setfl styles from a LAMMPS script (eam_paths),
     the potentials written by eam_funcfl_case and eam_setfl_case from
     closed forms (Cu_u3.eam is not in the repo), each path printing its
     route (pair_route: the plain EAM passes of ops/eam.py), the cell
     grid, its steps/s by its Loop time line and its peak device memory,
     no launch, rows finite:
     X. EAM_SCRIPT (bench/in.eam verbatim but for the potential's name:
        32,000 atoms, pair_style eam, run 100) through the CLI's main()
        with --f32: step 0's Temp 1600 within float32's rounding (rel
        1e-6); then the same input in float32 over X_PHASE_STEPS steps,
        the ms a step of the EAM term, its embedding and its force pass by
        CUDA events (the density pass the rest);
     X64. the same input in float64 through LammpsScript, a row each step,
        20 steps: step 0's Temp 1600 at rel 1e-9 (loop geom's RanPark
        draws are bit-exact), X's step 0 within rel 2e-4 of X64's (U's bar
        against U64), TotEng within EAM_CONSERVE (2e-4) relative of step
        0's at every step (JAX's tests/test_eam_bench.py bar); rows 0-2
        against the CPU twin at rel 1e-9 of max(1, |value|);
     Y. eam_alloy_script: pair_style eam/alloy on X's lattice with each
        atom made type 2 (the lighter metal) by `set type 1 type/fraction
        2 0.5 4987`, float64, 10 steps, rows 0-2 against the CPU twin;
     Z. the same under eam/fs (eam_setfl_case(fs=True)) at 4,000 atoms
        (Z_SCALE: a 10^3 region), float64, 10 steps, against the CPU twin;
 11. the CPU twins (CPU_TWIN: the same script through the port on the CPU
     in float64, in a process of its own) of J, K, O, R, R-pppm, Q64, S,
     T, U64, V, W, X64, Y and Z, after every path on the card, so that no
     timed path shares the host's cores with them (run_twins: as many at
     once as the cores take, the longest first);
 12. one JSON line {"kernels": [...]} with each of the ten kernels'
     launches (summed and by path, A-K, E-E4, L, L64, M, N, N-pol, O, R,
     R-pppm, Q, Q64, P, P100, S, T, U, U64, V, W, X, X64, Y, Z), times,
     ms_queued and bound, then the nvidia-smi line, then the device line
     last.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
NSTEPS = 20              # paths A and G
HOST_STEPS = 5           # paths B and C
G64_STEPS = 3            # path G64
H_STEPS = 5              # path H
I_SIDE, I_STEPS = 8, 5   # path I: 1,536 atoms on the dense route
ICAP_SIDE, ICAP_STEPS = 11, 3   # path I-cap: 3,993 atoms, below the cap
J_SIDE, J_STEPS = 8, 5   # paths J, J-all and K: 1,536 atoms, the dense route
JCAP_SIDE, JCAP_STEPS = 11, 3   # path J-cap: 3,993 atoms
M_STEPS = 100            # path M: in.melt's run cut from 250
N_SIDE, N_STEPS = 15, 5  # path N: 10,125 atoms on the cell grid
NPOL_SIDE, NPOL_STEPS = 12, 3   # path N-pol: 5,184 atoms
O_SIDE, O_STEPS = 8, 5   # path O: path I's input with pppm
P_SIDE, P_STEPS = 15, 5  # path P: path N's fluid with pppm
P100_SIDE, P100_STEPS = 32, 3   # path P100: 98,304 atoms, L = 128 A
Q_STEPS, Q_EVERY = 100, 10      # path Q: bench/in.lj under fix npt
Q64_STEPS = 20           # path Q64: the same in float64
R_SIDE, R_STEPS = 8, 5   # paths R and R-pppm: path I's input, rigid/npt
# the skin of paths N and N-pol: at real units' default 2.0 the fluid's 4 A
# lattice fills the 7^3 grid's cells unevenly (57 atoms in a cell of cap
# 56 at n_side 15) and the run aborts, as path N's first run shows
CELL_SKIN = "1.0"
SHARE_STEPS = 10         # path G's steps timed part by part
# thermo columns held between G64's kernel and plain routes
G64_COLS = ("etotal", "ke", "pe", "evdwl", "ecoul", "elong", "epol", "temp",
            "press")
FP32_PEAK = 67e12        # H100 SXM FP32 CUDA-core FLOP/s (data sheet, 700 W)
FP64_PEAK = 34e12        # H100 SXM FP64 CUDA-core FLOP/s (data sheet)
HBM_RATE = 3.35e12       # H100 SXM HBM3 bytes/s
# wrapper -> (TPU kernel it replaces, flops per pair: the Pallas
# CostEstimate of the f32 kernel, and for a *_df kernel that of its f32
# twin, float64?, values per row, values per column, values out per row)
KERNELS = {
    "eind_panel": ("lidp_tpu/ops/pallas_panel.py:194", 45, False, 4, 7, 3),
    "pair_wolf_panel": ("lidp_tpu/ops/pallas_panel.py:1386", 100, False,
                        6, 7, 6),
    "dipole_panel": ("lidp_tpu/ops/pallas_panel.py:1140", 140, False,
                     9, 10, 3),
    "pair_panel": ("lidp_tpu/ops/pallas_panel.py:1458", 70, False, 5, 6, 3),
    "wolf_panel": ("lidp_tpu/ops/pallas_panel.py:993", 30, False, 4, 6, 3),
    "eind_panel_df": ("lidp_tpu/ops/pallas_panel.py:359", 45, True, 4, 7, 3),
    "pair_panel_df": ("lidp_tpu/ops/pallas_panel.py:640", 100, True,
                      6, 7, 6),
    "dipole_panel_df": ("lidp_tpu/ops/pallas_panel.py:892", 140, True,
                        9, 10, 3),
}
PAIR_KERNELS = ("pair_wolf_panel", "pair_panel", "pair_panel_df")
# The eind kernels' bound counts the least arithmetic of the function: T_ij
# is symmetric, so one evaluation per unordered pair of polarizable atoms,
# 59 flops (geometry 12, rsq 5, r and u 2, r^-2, r^-3, r^-5 and c1 4, and 18
# for each of the two sides), and 12 more where the damping differs from 1
# (t2, l1, l2 and their products; the exp, on the SFU, is not counted):
# there u = pd*r < 25 in float32, 47 in float64 (the last u where it
# differs is 25.36 and 47.27, tests/test_torch_eind_symmetric.py).  The
# Pallas CostEstimate's 45 flops per ordered pair (npad^2 of them) stays
# beside it as bound_ms_cost_estimate.
EIND_FLOPS_PAIR, EIND_FLOPS_DAMPED = 59, 12
EIND_DAMPED_U = {False: 25.0, True: 47.0}
# The dipole kernels' bound counts the least arithmetic of the function in the
# whole kernel's expressions (csrc/dipole_panel.cuh), one evaluation per
# unordered pair in which a block can act: an unmasked atom on one side and
# either alpha_i, alpha_j != 0 or, between different molecules (or mol 0), one
# of q_j mu_i, q_i mu_j not zero (a padding atom, with q = alpha = mu = 0,
# gives and takes nothing).  Such a pair takes its geometry, 17 flops (3
# differences, the minimum image 9, rsq 5), since its distance decides the
# charge-dipole block; a pair that takes either block 30 more (r^-2, r^-3,
# mu_i.d and mu_j.d 12, the force added to one atom and taken from the other 6,
# the virial d (x) F 12); the dipole-dipole block (alpha_i, alpha_j != 0) 34
# (r^-5, mu_i.mu_j and (mu_i.d)(mu_j.d) 7, v1, v3 and pre1 6, b3, pre2 and pre3
# 3, u and its sum 3, the force 15), 21 more where t1 = exp(-pd r) is not 0 (r,
# pd r, t2 and t3 8, l1 and l3 into v1 and v3 6, the t1 term of pre1 7; the
# exp, on the SFU or a DFMA sequence, is not counted): pd*r below 104 in
# float32, 745 in float64; the charge-dipole block only where it can act inside
# cut_coul, 38 (w, h, e, the field factor g and sqrt_q r^-3 7, q_j mu_i - q_i
# mu_j 9, its d term 4, the force 12, u_ef 6); and F_cd + F_dd, 3, only for a
# pair that takes both blocks.  The Pallas CostEstimate's 140 flops per ordered
# pair (npad^2 of them) stays beside it as bound_ms_cost_estimate.
DIPOLE_FLOPS_GEOM, DIPOLE_FLOPS_PAIR = 17, 30
DIPOLE_FLOPS_DD, DIPOLE_FLOPS_DAMPED, DIPOLE_FLOPS_CD = 34, 21, 38
DIPOLE_FLOPS_BOTH = 3
DIPOLE_DAMPED_U = {False: 104.0, True: 745.0}
# The pair kernels' bound counts the least arithmetic of the function in the
# whole kernel's expressions (csrc/pair_panel.cuh), one evaluation per
# unordered pair: the geometry and the outer-cutoff test, 18 flops (3
# differences, the minimum image 9, rsq 5, the test 1), for each pair with
# an unmasked atom on one side (a padding pair takes nothing) -- where the
# tile-pair test is kept, only for the pairs of the tile pairs it keeps,
# since a box test of 8 flops a tile pair settles the others; a pair on
# which a force acts (LJ or coulomb on either side) 23 more (r^-2, the
# force scaled by it, its vector 3, added to one atom and taken from the
# other 6, the virial d (x) F 12); the LJ block where it acts (inside
# cut_lj, not excluded by the special list of a side that takes it) 10
# (r^-6 2, the force 4, the energy and its sum 4); the coulomb block where
# it acts (inside cut_coul, q_i q_j != 0) 21 (r and g r 2, the exponent 1,
# the A&S t and polynomial 8, the prefactor 3, force 4, energy and sum 2,
# the sum with LJ 1; rsqrt and exp, on the SFU, not counted); the Wolf
# block where it acts (r <= cut_coul between molecules, a charge on the
# other atom of a side that takes it) 16 (the factor 2, times the two
# charges 2, the field on both atoms 12).  wolf_panel's: the geometry of
# each pair with an unmasked atom (in the tile pairs the test keeps, with
# 8 flops a tile pair for the test) and the Wolf block with r^-2 (17); its
# count over all such pairs stays beside it as bound_ms_all_pairs.  The
# Pallas CostEstimate's flops per ordered pair (npad^2 of them) stay beside
# it as bound_ms_cost_estimate.
PAIR_FLOPS_GEOM, PAIR_FLOPS_FORCE = 18, 23
PAIR_FLOPS_LJ, PAIR_FLOPS_COUL, PAIR_FLOPS_WOLF = 10, 21, 16
WOLF_FLOPS_FIELD, TILE_BOX_FLOPS = 17, 8
# the LJ cell kernels: wrapper -> TPU kernel it replaces
CELL_KERNELS = {
    "slot_lj_forces": "lidp_tpu/ops/pallas_pair.py:314",
    "cell_pair_forces_lj": "lidp_tpu/ops/pallas_pair.py:433",
}
ALL_KERNELS = (*KERNELS, *CELL_KERNELS)
LJ_FLOPS_PER_PAIR = 25   # pallas_pair.py:321, per candidate pair
# the LJ cell kernels' least arithmetic, per unordered pair: the cutoff test
# (3 differences, 3 squares, 2 sums), and for a pair inside the cutoff its
# force on both atoms (the reciprocal, r^-6 2, fpair 4, the vector 3, added
# to one atom and taken from the other 6); with need_ev the energy (4 and
# its sum) and the virial (6 products, 6 sums)
LJ_FLOPS_TEST, LJ_FLOPS_FORCE, LJ_FLOPS_EV = 8, 16, 17
MELT_STEPS = 100         # paths E, F, E4
MELT_WINDOW = 400        # path E's timed window
# step 0 and step 100 of the reference log of bench/in.lj (32,000 atoms)
LJ_LOG0 = dict(temp=(1.44, 1e-6), pe=(-6.7733681, 1e-5),
               etotal=(-4.6134356, 1e-5), press=(-5.0197073, 1e-4))
LJ_LOG100_ETOTAL = (-4.6223613, 2e-4)
# path L64's bars: tests/test_lj_bench.py's, step 0 (rel) and step 100
LJ64_LOG0 = dict(temp=(1.44, 1e-9), pe=(-6.7733681, 1e-6),
                 etotal=(-4.6134356, 1e-6), press=(-5.0197073, 1e-5))
LJ64_LOG100 = dict(etotal=(-4.6223613, 2e-5), temp=(0.7574531, 2e-3),
                   pe=(-5.7585055, 2e-4))
# path M's: tests/test_melt_example.py's (log.5Oct16.melt.g++.1: temp,
# E_pair, TotEng, Press), step 0 absolute, steps 50 and 100 relative
MELT_GOLD = {0: (3.0, -6.7733681, -2.2744931, -3.7033504),
             50: (1.6758903, -4.7955425, -2.2823355, 5.670064),
             100: (1.6458363, -4.7492704, -2.2811332, 5.8691042)}
MELT_BAR0 = dict(temp=5e-8, epair=5e-8, etotal=5e-8, press=5e-7)
MELT_BARS = {50: 2e-3, 100: 2e-2}
SP_WIDTH = 8             # special-list slots of make_case and the fluid


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms_queued(fn, reps: int) -> float:
    """Time per call of `reps` calls queued back to back between two CUDA
    events, after one warm-up call."""
    import torch

    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median time of one call, by CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def make_case(n_live, npad, L, seed, n_masked=0, dev="cuda"):
    """Random panel operands on the GPU: jittered-lattice positions, random
    charges, types 1-2, 3-atom molecules, 5% alpha=0 atoms, small dipoles,
    `n_masked` live-range atoms masked out, padding masked, and special
    lists holding each atom's molecule partners (unused slots: n_live)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    f32 = torch.float32
    side = math.ceil(n_live ** (1 / 3))
    i = torch.arange(n_live, device=dev)
    grid = torch.stack([i // (side * side), (i // side) % side, i % side], 1)
    h = L / side
    x = torch.zeros((npad, 3), dtype=f32, device=dev)
    x[:n_live] = (grid + 0.5) * h + (torch.rand(
        (n_live, 3), generator=g, device=dev) - 0.5) * 0.4 * h

    def live(v, fill=0.0):
        out = torch.full((npad,) + v.shape[1:], fill, dtype=f32, device=dev)
        out[:n_live] = v
        return out

    mask = live(torch.ones(n_live, device=dev))
    if n_masked:
        drop = torch.randperm(n_live, generator=g, device=dev)[:n_masked]
        mask[drop] = 0.0
    alpha = live(0.5 + 1.5 * torch.rand(n_live, generator=g, device=dev))
    alpha[torch.rand(npad, generator=g, device=dev) < 0.05] = 0.0
    alpha = alpha * mask
    mu = live(0.01 * torch.randn((n_live, 3), generator=g, device=dev))
    mu = mu * (alpha != 0)[:, None]
    q = live(0.5 * torch.randn(n_live, generator=g, device=dev))
    typ = live(torch.randint(1, 3, (n_live,), generator=g,
                             device=dev).to(f32))
    mol = live((i // 3 + 1).to(f32))
    base = 3 * (torch.arange(npad, device=dev) // 3)
    sp = torch.full((npad, 8), n_live, dtype=torch.int32, device=dev)
    k = torch.arange(npad, device=dev) % 3
    sp[:, 0] = (base + (k + 1) % 3).to(torch.int32)
    sp[:, 1] = (base + (k + 2) % 3).to(torch.int32)
    sp[n_live:] = n_live
    sp = torch.where(sp < n_live, sp, n_live)
    Lt = torch.full((3,), L, dtype=f32, device=dev)
    return dict(x=x, q=q, type=typ, mol=mol, mask=mask, alpha=alpha, mu=mu,
                sp=sp.contiguous(), L=Lt)


def to_f64(c):
    """The same case in float64 (the float32 values exactly)."""
    return {k: (v.double() if v.is_floating_point() else v)
            for k, v in c.items()}


def tabs_for(ff_pair, dtype):
    import torch

    return torch.stack([ff_pair.lj3, ff_pair.lj4, ff_pair.offset,
                        ff_pair.cut_ljsq, ff_pair.cutsq]).to(dtype).contiguous()


# the fluid's outer cutoff: cutsq of every live type pair and cut_coulsq
# (6.5 A), exact in both dtypes
CUTOFF_SQ = 42.25


def _round_exact(fr, npt):
    """The Fraction fr correctly rounded to the numpy float type npt (ties
    to even)."""
    from fractions import Fraction

    import numpy as np

    ityp = np.int32 if npt is np.float32 else np.int64
    best = npt(float(fr))
    for g in (np.nextafter(best, npt(-np.inf)),
              np.nextafter(best, npt(np.inf))):
        db = abs(Fraction(float(best)) - fr)
        dg = abs(Fraction(float(g)) - fr)
        if dg < db or (dg == db and int(g.view(ityp)) % 2 == 0):
            best = g
    return best


def fused_rsq(d, npt):
    """rsq of the differences d (3,) in npt as a compiler that contracts
    dx*dx + dy*dy + dz*dz into fused multiply-adds forms it, in the two
    orders it may choose: fma(dz,dz,fma(dy,dy,dx*dx)) and
    fma(dz,dz,fma(dx,dx,dy*dy)), each fma rounded once."""
    from fractions import Fraction

    dx, dy, dz = (npt(v) for v in d)

    def fma(a, b, c):
        return _round_exact(Fraction(float(a)) * Fraction(float(b))
                            + Fraction(float(c)), npt)

    return fma(dz, dz, fma(dy, dy, dx * dx)), fma(dz, dz, fma(dx, dx, dy * dy))


def _cutoff_partner(npt, xi, target, fused_ok, seed):
    """A partner xj of atom xi at about 6.5 A whose rsq, each product and
    sum rounded on its own in npt, is `target`, and whose contracted forms
    (fused_rsq) both satisfy fused_ok: a deterministic search over random
    directions, stepping xj's x coordinate ulp by ulp."""
    import numpy as np

    rng = np.random.RandomState(seed)
    ityp = np.int32 if npt is np.float32 else np.int64
    for _ in range(4000):
        u = rng.uniform(0.4, 1.0, 3)
        u /= np.linalg.norm(u)
        xj0 = (xi.astype(np.float64) + 6.5 * u).astype(npt)
        xs = (xj0[0].view(ityp) + np.arange(-60, 61, dtype=ityp)).view(npt)
        dx, dy, dz = xi[0] - xs, xi[1] - xj0[1], xi[2] - xj0[2]
        rn = (dx * dx + dy * dy) + dz * dz
        for k in np.nonzero(rn == target)[0]:
            if all(fused_ok(f) for f in fused_rsq((dx[k], dy, dz), npt)):
                xj = xj0.copy()
                xj[0] = xs[k]
                return xj
    raise AssertionError("no cutoff partner found")


def cutoff_pairs_case(dtype, device="cuda"):
    """Two live pairs far apart (atoms 0-3) and two padding atoms at the
    origin (masked, no charge, type 0, mol 0) in a 60 A box, each pair
    placed by _cutoff_partner so that with rsq formed as the plain version
    forms it (each product and sum rounded on its own, csrc rsq_rn):
      pair (0, 1): rsq == CUTOFF_SQ exactly, outside the LJ/coulomb
        cutoff (rsq < cutsq), but inside it in both contracted forms;
      pair (2, 3): rsq one ulp below CUTOFF_SQ, inside, and outside in
        both contracted forms.
    A kernel that contracts rsq puts each of them on the other side of the
    cutoff.  LJ (cut 6 A) acts on neither; the shifted Wolf field of a pair
    at the cutoff is exactly zero, so only pair (2, 3) takes a force or a
    field.  Returns x q type mol mask L as tensors of `dtype` on `device`,
    and `force_rows`, the rows that take a coulomb force and the field."""
    import numpy as np
    import torch

    npt = np.float32 if dtype == torch.float32 else np.float64
    C = npt(CUTOFF_SQ)
    x = np.zeros((6, 3), npt)
    for k, (target, ok) in enumerate((
            (C, lambda f: f < C),
            (np.nextafter(C, npt(0)), lambda f: f >= C))):
        xi = np.array([3.0 + 20.0 * k, 30.0, 30.0], npt)
        x[2 * k], x[2 * k + 1] = xi, _cutoff_partner(npt, xi, target, ok,
                                                     seed=k + 1)
    t = lambda a: torch.as_tensor(np.asarray(a, npt), dtype=dtype,  # noqa
                                  device=device)
    return dict(x=t(x), q=t([0.5, -0.5, 0.4, -0.4, 0, 0]),
                type=t([1, 2, 1, 2, 0, 0]), mol=t([1, 2, 3, 4, 0, 0]),
                mask=t([1, 1, 1, 1, 0, 0]), L=t([60.0] * 3),
                force_rows=[2, 3])


def cutoff_pairs_parity(pair):
    """The pair kernels on cutoff_pairs_case: the strip kernel (cols = all
    atoms, row0 = 0) and the whole kernel against the plain version, in
    float32 (pair_wolf_panel, pair_panel) and float64 (pair_panel_df with
    the field): at compare's bars, and every pair decided alike: the same
    rows take a force and the field (exactly 0 elsewhere), rows 2 and 3
    only."""
    import torch

    from lidp_tpu_torch.ops import panel

    for dtype in (torch.float32, torch.float64):
        c = cutoff_pairs_case(dtype)
        tabs = tabs_for(pair, dtype)
        scal = (pair.cut_coulsq, pair.qqrd2e, pair.g_ewald)
        head = (c["x"], c["q"], c["type"])
        if dtype == torch.float32:
            wargs = (*head, c["mol"], c["mask"], tabs, c["L"], *scal)
            pargs = (*head, c["mask"], tabs, c["L"], *scal)
            forms = (("pair_wolf_panel", panel.pair_wolf_panel,
                      panel.pair_wolf_panel_plain, wargs, wargs[:5], {}),
                     ("pair_panel", panel.pair_panel,
                      panel.pair_panel_plain, pargs, pargs[:4], {}))
        else:
            pargs = (*head, c["mask"], tabs, c["L"], *scal)
            forms = (("pair_panel_df", panel.pair_panel_df,
                      panel.pair_panel_df_plain, pargs,
                      (*pargs[:4], c["mol"]), dict(mol=c["mol"])),)
        want = torch.zeros(6, dtype=torch.bool, device=c["x"].device)
        want[c["force_rows"]] = True
        for name, wrapper, plain, args, cols, kw in forms:
            ref = plain(*args, **kw)
            for form, extra in (("strip form", dict(cols=cols, row0=0)),
                                ("whole", {})):
                label = f"{name}[{form}, cutoff pairs]"
                got = wrapper(*args, **extra, **kw)
                torch.cuda.synchronize()
                err, scale = compare(label, got, ref, dtype == torch.float64)
                for k in (0, 4)[:len(got) - 3]:
                    acts = (got[k] != 0).any(1)
                    if not (torch.equal(acts, (ref[k] != 0).any(1))
                            and torch.equal(acts, want)):
                        raise AssertionError(
                            f"{label}: rows with a nonzero output {k} "
                            f"{acts.tolist()}, plain "
                            f"{(ref[k] != 0).any(1).tolist()}")
                print(f"parity {label} ok: rows with a force "
                      f"{torch.nonzero(acts).flatten().tolist()} as the "
                      f"plain version's, max abs err {err:.3e} of max |ref| "
                      f"{scale:.3e}")


def dipole_cutoff_case(dtype, device="cuda", polar="one"):
    """cutoff_pairs_case with induced dipoles: mu nonzero on atoms 0-3 (in
    four molecules) and alpha_eff nonzero on every atom of the pairs
    (polar="both") or on atom 2 alone (polar="one").  The charge-dipole
    block acts for rsq < cut_coulsq whatever alpha is, and at the cutoff
    its force does not vanish (the shifted tensor's e = 2/cut_coulsq), so
    a rsq contracted into fused multiply-adds moves pair (0, 1) in and
    pair (2, 3) out.  With polar="one" no pair takes the dipole-dipole
    block (it needs alpha on both sides, and has no cutoff), so exactly
    rows 2 and 3 take a force; with "both" every live row does, and the
    values tell."""
    import numpy as np
    import torch

    c = cutoff_pairs_case(dtype, device)
    npt = np.float32 if dtype == torch.float32 else np.float64
    mu = np.zeros((6, 3), npt)
    mu[:4] = [[0.03, -0.02, 0.05], [-0.04, 0.01, 0.02],
              [0.02, 0.05, -0.03], [0.01, -0.03, -0.04]]
    alpha = [1.1, 0.4, 1.1, 0.4, 0, 0] if polar == "both" \
        else [0, 0, 1.1, 0, 0, 0]
    t = lambda a: torch.as_tensor(np.asarray(a, npt), dtype=dtype,  # noqa
                                  device=device)
    return dict(c, mu=t(mu), alpha=t(alpha))


def dipole_cutoff_parity(pair, s):
    """The dipole kernels on dipole_cutoff_case, both polar variants: the
    strip kernel (cols = all atoms, row0 = 0) and the whole kernel against
    the plain version in float32 (dipole_panel) and float64
    (dipole_panel_df), at compare's bars; with one polar atom a pair the
    rows that take a force are exactly the plain version's, rows 2 and 3."""
    import torch

    from lidp_tpu_torch.ops import panel

    for dtype, name in ((torch.float32, "dipole_panel"),
                        (torch.float64, "dipole_panel_df")):
        wrapper = panel.WRAPPERS[name]
        plain = (panel.dipole_panel_plain if dtype == torch.float32
                 else panel.dipole_panel_df_plain)
        for polar in ("one", "both"):
            c = dipole_cutoff_case(dtype, polar=polar)
            args = (c["x"], c["q"], c["mol"], c["alpha"], c["mu"],
                    c["mask"], c["L"], s.polar_damp, pair.cut_coulsq,
                    pair.qqrd2e)
            kw = dict(damping_type=s.damping_type)
            ref = plain(*args, **kw)
            want = torch.zeros(6, dtype=torch.bool, device=c["x"].device)
            want[c["force_rows"] if polar == "one" else [0, 1, 2, 3]] = True
            for form, extra in (("strip form", dict(cols=args[:6], row0=0)),
                                ("whole", {})):
                label = f"{name}[{form}, cutoff pairs, {polar} polar]"
                got = wrapper(*args, **extra, **kw)
                torch.cuda.synchronize()
                err, scale = compare(label, got, ref, dtype == torch.float64)
                acts = (got[0] != 0).any(1)
                if not (torch.equal(acts, (ref[0] != 0).any(1))
                        and torch.equal(acts, want)):
                    raise AssertionError(
                        f"{label}: rows with a force {acts.tolist()}, plain "
                        f"{(ref[0] != 0).any(1).tolist()}")
                print(f"parity {label} ok: rows with a force "
                      f"{torch.nonzero(acts).flatten().tolist()} as the "
                      f"plain version's, max abs err {err:.3e} of max |ref| "
                      f"{scale:.3e}, scalars at "
                      f"{scalar_margin(got, ref, dtype == torch.float64):.3g}"
                      f" of their bar")


def kernel_calls(c, c64, pair, s):
    """{label: (kernel name, wrapper call, plain call, label of the call
    whose bits it must give or None, bound)} on case c (float32) and its
    float64 copy c64.  The label is the kernel's name for the form the main
    paths use, name[variant] for the other forms: [strip form] (cols = all
    atoms, row0 = 0: the strip kernel), [no skip] (the whole-panel kernel
    with its exact skips off: the same bits as the kernel with them),
    [no cull] (the pair kernel without its tile-pair test: the same bits),
    [damping none] (the reference's default damp_type), [no field] and
    [lj only] (pair_panel_df without mol, pair_panel with coul=False).
    bound() gives (ms, what binds it, pair counts) of the function's least
    arithmetic on the case, or None where only the CostEstimate's count
    is kept; it is computed once for a kernel's forms."""
    from lidp_tpu_torch.ops import panel

    pd, dmp = s.polar_damp, s.damping_type
    scal = (pair.cut_coulsq, pair.qqrd2e, pair.g_ewald)
    out = {}

    def add(label, name, plain, args, same_as=None, kern=None, bound=None,
            **kw):
        wrapper = panel.WRAPPERS[name]
        out[label] = (name, kern or (lambda: wrapper(*args, **kw)),
                      lambda: plain(*args, **kw), same_as, bound)

    def switched(name, args, flags, **kw):
        """The whole-panel kernel with its exact skips off: `flags` maps
        the ops/panel switches (EIND_SKIP_U of the dtype, DIPOLE_SKIP,
        PAIR_SKIP, PAIR_CULL) to the values that turn them off."""
        wrapper, dtype = panel.WRAPPERS[name], args[0].dtype

        def kern():
            saved = dict(panel.EIND_SKIP_U)
            old = {k: getattr(panel, k) for k in flags if k != "EIND"}
            if "EIND" in flags:
                panel.EIND_SKIP_U[dtype] = flags["EIND"]
            for k, v in flags.items():
                if k != "EIND":
                    setattr(panel, k, v)
            try:
                return wrapper(*args, **kw)
            finally:
                panel.EIND_SKIP_U.update(saved)
                for k, v in old.items():
                    setattr(panel, k, v)
        return kern

    def once(fn):
        memo = []

        def get():
            if not memo:
                memo.append(fn())
            return memo[0]
        return get

    def pair_forms(name, plain, args, cols, tag, bound, **kw):
        """A pair kernel's form (tag: "", "no field", "lj only") and its
        [strip form] (the strip kernel on `cols`, all atoms), [no skip]
        and [no cull] variants."""
        def lab(*parts):
            inner = ", ".join(filter(None, parts))
            return f"{name}[{inner}]" if inner else name
        base = lab(tag)
        add(base, name, plain, args, bound=bound, **kw)
        add(lab("strip form", tag), name, plain, args, cols=cols, row0=0,
            bound=bound, **kw)
        for form, flag in (("no skip", "PAIR_SKIP"), ("no cull",
                                                       "PAIR_CULL")):
            add(lab(form, tag), name, plain, args, same_as=base,
                kern=switched(name, args, {flag: False}, **kw), bound=bound,
                **kw)

    for d, suffix in ((c, ""), (c64, "_df")):
        tabs = tabs_for(pair, d["x"].dtype)
        eargs = (d["x"], d["alpha"], d["mu"], d["L"], pd)
        dargs = (d["x"], d["q"], d["mol"], d["alpha"], d["mu"], d["mask"],
                 d["L"], pd, pair.cut_coulsq, pair.qqrd2e)
        for name, plain, args, ncols in (
                ("eind_panel" + suffix, panel.eind_panel_plain, eargs, 3),
                ("dipole_panel" + suffix, panel.dipole_panel_plain, dargs,
                 6)):
            for dt, tag in ((dmp, ""), (panel.DAMP_NONE, "damping none")):
                damp = dict(damping_type=dt)
                base = f"{name}[{tag}]" if tag else name
                if name.startswith("eind"):
                    bound = once(lambda n=name, d=d: (*eind_bound_ms(
                        n, d["x"], d["alpha"], d["L"], pd), {}))
                    off = {"EIND": math.inf}
                else:
                    bound = once(lambda n=name, d=d, dt=dt: dipole_bound_ms(
                        n, d, pair.cut_coulsq, pd, dt))
                    off = {"DIPOLE_SKIP": False}
                add(base, name, plain, args, bound=bound, **damp)
                add(f"{name}[{', '.join(filter(None, ('strip form', tag)))}]",
                    name, plain, args, cols=args[:ncols], row0=0,
                    bound=bound, **damp)
                if tag and name.startswith("eind"):
                    continue      # without damping eind has no skip
                add(f"{name}[{', '.join(filter(None, ('no skip', tag)))}]",
                    name, plain, args, same_as=base,
                    kern=switched(name, args, off, **damp), bound=bound,
                    **damp)
        pargs = (d["x"], d["q"], d["type"], d["mask"], tabs, d["L"], *scal)

        def pbound(name, wolf, coul=True, d=d, tabs=tabs):
            return once(lambda: pair_bound_ms(name, d, tabs, pair.cut_coulsq,
                                              wolf, coul=coul))
        if suffix:
            # with the field the strip form's cols gain mol as a 5th
            pair_forms("pair_panel_df", panel.pair_panel_df_plain, pargs,
                       (*pargs[:4], d["mol"]), "",
                       pbound("pair_panel_df", True), sp=d["sp"],
                       mol=d["mol"])
            pair_forms("pair_panel_df", panel.pair_panel_df_plain, pargs,
                       pargs[:4], "no field", pbound("pair_panel_df", False),
                       sp=d["sp"])
        else:
            wargs = (d["x"], d["q"], d["type"], d["mol"], d["mask"], tabs,
                     d["L"], *scal)
            pair_forms("pair_wolf_panel", panel.pair_wolf_panel_plain, wargs,
                       wargs[:5], "", pbound("pair_wolf_panel", True),
                       sp=d["sp"])
            pair_forms("pair_panel", panel.pair_panel_plain, pargs, pargs[:4],
                       "", pbound("pair_panel", False), sp=d["sp"])
            pair_forms("pair_panel", panel.pair_panel_plain, pargs, pargs[:4],
                       "lj only", pbound("pair_panel", False, coul=False),
                       sp=d["sp"], coul=False)
            wolf = (d["x"], d["q"], d["mol"], d["mask"], d["L"],
                    pair.cut_coulsq)
            pair_forms("wolf_panel", panel.wolf_panel_plain, wolf, wolf[:4],
                       "", once(lambda d=d: wolf_bound_ms(
                           "wolf_panel", d, pair.cut_coulsq)))
    return out


def same_bits(got, ref):
    """Are two kernel results (a tensor or a tuple of them) equal bit for
    bit (torch.equal on each)?"""
    import torch

    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    return len(got) == len(ref) and all(torch.equal(a, b)
                                        for a, b in zip(got, ref))


def compare(name, got, ref, f64=False):
    """float32: per-row outputs rtol 1e-4, atol 1e-5*max|ref|; scalars rel
    1e-4.  float64: rtol 1e-9, atol 1e-11*max|ref|; scalars rel 1e-10.
    Returns the largest per-row absolute difference and the largest |ref|
    of the per-row outputs."""
    import torch

    rtol, atol, srel = (1e-9, 1e-11, 1e-10) if f64 else (1e-4, 1e-5, 1e-4)
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    if len(got) != len(ref):
        raise AssertionError(f"{name}: {len(got)} outputs, plain {len(ref)}")
    worst = scale = 0.0
    for g, r in zip(got, ref):
        if g.dtype != r.dtype or g.shape != r.shape:
            raise AssertionError(f"{name}: {g.dtype} {tuple(g.shape)} vs "
                                 f"plain {r.dtype} {tuple(r.shape)}")
        g, r = g.double(), r.double()
        if g.dim() == 2:
            err = (g - r).abs()
            tol = rtol * r.abs() + atol * r.abs().max()
            bad = int((err > tol).sum())
            if bad or not torch.isfinite(g).all():
                raise AssertionError(f"{name}: {bad} per-row values off, max "
                                     f"abs err {float(err.max()):.3e}")
            worst = max(worst, float(err.max()))
            scale = max(scale, float(r.abs().max()))
        else:
            err = (g - r).abs()
            tol = srel * r.abs().reshape(-1).max().clamp(min=1e-30)
            if (err > tol).any() or not torch.isfinite(g).all():
                raise AssertionError(f"{name}: scalar {g.tolist()} vs "
                                     f"{r.tolist()}")
    return worst, scale


def bound_ms(name, nrows, npad, flops_per_pair=None):
    """Least time on the card: the larger of the flops (the CostEstimate
    per pair) over the FP32 or FP64 CUDA-core peak and the operand bytes
    (each input read once, each output written once) over the HBM rate."""
    _, fl, f64, rows, cols, outs = KERNELS[name]
    flops = (flops_per_pair or fl) * nrows * npad
    item = 8 if f64 else 4
    nbytes = item * (rows * nrows + cols * npad + outs * nrows + 8)
    if name in PAIR_KERNELS:
        nbytes += 4 * SP_WIDTH * nrows
    t_ops = flops / (FP64_PEAK if f64 else FP32_PEAK)
    t_bytes = nbytes / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def eind_bound_ms(name, x, alpha, L, pd):
    """bound_ms of eind_panel / eind_panel_df on these operands: the
    flops of EIND_FLOPS_PAIR per unordered pair of atoms with alpha != 0
    and EIND_FLOPS_DAMPED more per such pair with pd*r < EIND_DAMPED_U, or
    the operand bytes, whichever takes longer."""
    import torch

    _, _, f64, rows, cols, outs = KERNELS[name]
    xl = x[alpha != 0].double()
    m = xl.shape[0]
    Ld = L.double()
    rcut = EIND_DAMPED_U[f64] / pd
    near = 0
    for i0 in range(0, m, 1024):
        d = xl[i0:i0 + 1024, None, :] - xl[None, :, :]
        d = d - Ld * torch.round(d / Ld)
        near += int(((d * d).sum(-1) < rcut * rcut).sum())
    near = (near - m) // 2                   # unordered, no self pairs
    flops = EIND_FLOPS_PAIR * m * (m - 1) // 2 + EIND_FLOPS_DAMPED * near
    npad, item = x.shape[0], 8 if f64 else 4
    t_ops = flops / (FP64_PEAK if f64 else FP32_PEAK)
    t_bytes = item * ((rows + cols + outs) * npad + 8) / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def dipole_bound_ms(name, c, cut_coulsq, pd, damping_type):
    """bound_ms of dipole_panel / dipole_panel_df on case c: the flops of
    the function's least arithmetic (DIPOLE_FLOPS_*) counted on its
    unordered pairs, or the operand bytes, whichever takes longer.  Also
    returns the pair counts: geometry_pairs (a block can act), active_pairs
    (one does), dd_pairs, damped_pairs, cd_pairs, both_pairs."""
    import torch

    _, _, f64, rows, cols, outs = KERNELS[name]
    x, L = c["x"].double(), c["L"].double()
    mol, live, pol = c["mol"], c["mask"] != 0, c["alpha"] != 0
    charged, polar = c["q"] != 0, (c["mu"] != 0).any(1)
    npad = x.shape[0]
    rdamp = DIPOLE_DAMPED_U[f64] / pd if damping_type else 0.0
    cnt = dict(geometry_pairs=0, active_pairs=0, dd_pairs=0, damped_pairs=0,
               cd_pairs=0, both_pairs=0)
    jj = torch.arange(npad, device=x.device)[None, :]
    for i0 in range(0, npad, 1024):
        sl = slice(i0, i0 + 1024)
        d = x[sl, None, :] - x[None, :, :]
        d = d - L * torch.round(d / L)
        rsq = (d * d).sum(-1)
        del d
        ii = torch.arange(i0, i0 + rsq.shape[0], device=x.device)[:, None]
        either = (live[sl, None] | live[None, :]) & (ii != jj)
        dd = either & pol[sl, None] & pol[None, :]
        moli = mol[sl, None]
        cd_can = (either & ((moli != mol[None, :]) | (moli == 0))
                  & ((charged[None, :] & polar[sl, None])
                     | (charged[sl, None] & polar[None, :])))
        cd = cd_can & (rsq < cut_coulsq)
        for key, v in (("geometry_pairs", dd | cd_can),
                       ("active_pairs", cd | dd), ("dd_pairs", dd),
                       ("damped_pairs", dd & (rsq < rdamp * rdamp)),
                       ("cd_pairs", cd), ("both_pairs", cd & dd)):
            cnt[key] += int(v.sum())
    cnt = {k: v // 2 for k, v in cnt.items()}       # unordered
    flops = (DIPOLE_FLOPS_GEOM * cnt["geometry_pairs"]
             + DIPOLE_FLOPS_PAIR * cnt["active_pairs"]
             + DIPOLE_FLOPS_DD * cnt["dd_pairs"]
             + DIPOLE_FLOPS_DAMPED * cnt["damped_pairs"]
             + DIPOLE_FLOPS_CD * cnt["cd_pairs"]
             + DIPOLE_FLOPS_BOTH * cnt["both_pairs"])
    item = 8 if f64 else 4
    t_ops = flops / (FP64_PEAK if f64 else FP32_PEAK)
    t_bytes = item * ((rows + cols + outs) * npad + 8) / HBM_RATE
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", cnt)


def far_tile_pairs(x, mask, L, tile, rc):
    """(nT, nT) bool: the tile pairs csrc/pair_panel.cuh far_tiles drops on
    atoms x (npad, 3) in tiles of `tile`: neither tile holds an unmasked
    atom, or on some axis the gap between the tiles' coordinate boxes by
    minimum image exceeds rc by the kernel's margin (in x's dtype, as the
    kernel computes it)."""
    import torch

    npad = x.shape[0]
    nT = -(-npad // tile)
    lo = torch.stack([x[t * tile:(t + 1) * tile].min(0).values
                      for t in range(nT)])
    hi = torch.stack([x[t * tile:(t + 1) * tile].max(0).values
                      for t in range(nT)])
    live = torch.stack([(mask[t * tile:(t + 1) * tile] != 0).any()
                        for t in range(nT)])
    c = 0.5 * (lo + hi)
    h = 0.5 * ((hi - lo)[:, None] + (hi - lo)[None, :])
    d = c[:, None] - c[None, :]
    gap = (d - L * torch.round(d * (1.0 / L))).abs() - h
    margin = 1e-3 * (rc + L + c.abs()[:, None] + c.abs()[None, :])
    far = (gap > rc + margin).any(-1)
    return far | (~live[:, None] & ~live[None, :])


def pair_bound_ms(name, c, tabs, cut_coulsq, wolf, coul=True, tile=None,
                  cull=None):
    """bound_ms of the pair kernels on case c (float32 for pair_wolf_panel
    and pair_panel, float64 for pair_panel_df), or of wolf_panel with
    `name` "wolf_panel": the flops of the function's least arithmetic
    (PAIR_FLOPS_*, WOLF_FLOPS_FIELD) counted on its unordered pairs (rsq
    in the case's dtype, term by term, as the kernels form it), or the
    operand bytes, whichever takes longer.  The geometry is counted for
    the pairs of the tile pairs the whole kernel keeps (tile: its tile,
    from the library unless given) when `cull` (ops/panel.PAIR_CULL unless
    given), with TILE_BOX_FLOPS a tile pair for the test.  Also returns
    the counts: geometry_pairs (an unmasked atom on one side), kept_pairs
    (those of the kept tile pairs), tile_pairs and kept_tile_pairs,
    force_pairs, lj_pairs, coul_pairs, wolf_pairs; for wolf_panel
    geometry_pairs, kept_pairs, wolf_pairs, the tile pairs and
    bound_ms_all_pairs, the bound with the geometry of every pair with an
    unmasked atom (no tile-pair test)."""
    import torch

    from lidp_tpu_torch.ops import panel

    field = name == "wolf_panel"
    f64 = c["x"].dtype == torch.float64
    x, L, q, mol = c["x"], c["L"], c["q"], c["mol"]
    live = c["mask"] != 0
    charged = q != 0
    typ, sp = c["type"].long(), c["sp"].long()
    npad = x.shape[0]
    cutsq_u = 0.0 if field else float(tabs[4].max())
    if cull is None:
        cull = panel.PAIR_CULL
    rc = math.sqrt(max(cutsq_u, cut_coulsq if wolf else 0.0))
    if cull:
        tile = tile or panel.whole_tile(name)
        keep = ~far_tile_pairs(x, c["mask"], L, tile, rc)
        tid = torch.arange(npad, device=x.device) // tile
    cnt = dict(geometry_pairs=0, kept_pairs=0, force_pairs=0, lj_pairs=0,
               coul_pairs=0, wolf_pairs=0)
    jj = torch.arange(npad, device=x.device)[None, :]
    Linv = 1.0 / L
    for i0 in range(0, npad, 1024):
        sl = slice(i0, i0 + 1024)
        d = x[sl, None, :] - x[None, :, :]
        d = d - L * torch.round(d * Linv)
        rsq = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
            + d[..., 2] * d[..., 2]
        del d
        ii = torch.arange(i0, i0 + rsq.shape[0], device=x.device)[:, None]
        oi = live[None, :] & (ii != jj)          # side i takes from j
        oj = live[sl, None] & (ii != jj)
        either = oi | oj
        moli = mol[sl, None]
        molok = (moli != mol[None, :]) | (moli == 0)
        wl = (rsq <= cut_coulsq) & molok & (
            (oi & charged[None, :]) | (oj & charged[sl, None]))
        terms = dict(geometry_pairs=either, wolf_pairs=wl)
        if not field:
            inr = rsq < cutsq_u
            lj = inr & (rsq < tabs[3][typ[sl, None], typ[None, :]])
            excl_i = (sp[sl][:, None, :] == jj[..., None]).any(-1)
            excl_j = (sp[None, :, :] == ii[..., None]).any(-1)
            lj = lj & ((oi & ~excl_i) | (oj & ~excl_j))
            del excl_i, excl_j
            cl = (inr & (rsq < cut_coulsq) & either & charged[sl, None]
                  & charged[None, :]) if coul else torch.zeros_like(lj)
            terms.update(lj_pairs=lj, coul_pairs=cl, force_pairs=lj | cl)
            if not wolf:
                terms["wolf_pairs"] = torch.zeros_like(lj)
        if cull:
            terms["kept_pairs"] = either & keep[tid[sl, None], tid[None, :]]
        for key, v in terms.items():
            cnt[key] += int(v.sum())
        del rsq, terms
    cnt = {k: v // 2 for k, v in cnt.items()}       # unordered
    nT = -(-npad // tile) if cull else 0
    cnt.update(tile_pairs=nT * (nT + 1) // 2,
               kept_tile_pairs=int(keep.triu().sum()) if cull else 0)
    geom = cnt["kept_pairs"] if cull else cnt["geometry_pairs"]
    peak = FP64_PEAK if f64 else FP32_PEAK
    if field:
        cnt = {k: cnt[k] for k in ("geometry_pairs", "kept_pairs",
                                   "wolf_pairs", "tile_pairs",
                                   "kept_tile_pairs")}
        flops = (PAIR_FLOPS_GEOM * geom + TILE_BOX_FLOPS * cnt["tile_pairs"]
                 + WOLF_FLOPS_FIELD * cnt["wolf_pairs"])
        # x, q, mol, mask in, e0 out
        nbytes = 4 * (9 * npad + 8)
        every = (PAIR_FLOPS_GEOM * cnt["geometry_pairs"]
                 + WOLF_FLOPS_FIELD * cnt["wolf_pairs"])
        cnt["bound_ms_all_pairs"] = 1e3 * max(every / peak,
                                              nbytes / HBM_RATE)
    else:
        flops = (PAIR_FLOPS_GEOM * geom + TILE_BOX_FLOPS * cnt["tile_pairs"]
                 + PAIR_FLOPS_FORCE * cnt["force_pairs"]
                 + PAIR_FLOPS_LJ * cnt["lj_pairs"]
                 + PAIR_FLOPS_COUL * cnt["coul_pairs"]
                 + PAIR_FLOPS_WOLF * cnt["wolf_pairs"])
        item = 8 if f64 else 4
        # x, q, type, mask (and mol) in, f (and e0) out, the lists
        nbytes = item * ((9 + 4 * wolf) * npad + 8) \
            + 4 * sp.shape[1] * npad
    t_ops = flops / peak
    t_bytes = nbytes / HBM_RATE
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", cnt)


def wolf_bound_ms(name, c, cut_coulsq, tile=None):
    """pair_bound_ms of wolf_panel: the geometry of each unordered pair with
    an unmasked atom on one side in the tile pairs the test keeps (at the
    radius sqrt(cut_coulsq); tile: the whole kernel's, from the library
    unless given), 8 flops a tile pair for the test, and the Wolf block
    with r^-2 (WOLF_FLOPS_FIELD) for the pairs where a side takes a field
    term."""
    return pair_bound_ms(name, c, None, cut_coulsq, True, tile=tile)


def scalar_margin(got, ref, f64):
    """The largest ratio of a scalar output's difference to compare()'s
    bar (srel of the largest |ref| of its vector): below 1 passes."""
    srel = 1e-10 if f64 else 1e-4
    worst = 0.0
    for g, r in zip(got, ref):
        if g.dim() < 2:
            g, r = g.double().reshape(-1), r.double().reshape(-1)
            tol = srel * float(r.abs().max().clamp(min=1e-30))
            worst = max(worst, float((g - r).abs().max()) / tol)
    return worst


def dipole_skip_share(tag, c, cut_coulsq, qqrd2e, pd, damping_type):
    """Print the share of the whole dipole kernel's warp votes that skipped
    each block (ops/panel.dipole_skip_share) on case c; returns it."""
    from lidp_tpu_torch.ops import panel

    votes, cd, dd = panel.dipole_skip_share(
        c["x"], c["q"], c["mol"], c["alpha"], c["mu"], c["mask"], c["L"],
        pd, cut_coulsq, qqrd2e, damping_type=damping_type)
    print(f"skip share dipole {tag}: charge-dipole {cd} of {votes} warp "
          f"votes = {cd / votes:.4f}, dipole-dipole {dd} = {dd / votes:.4f}")
    return dict(votes=votes, cd_skipped=cd, dd_skipped=dd)


def pair_skip_share(tag, c, pair, wolf, field_alone=False):
    """Print the shares of the whole pair kernel's warp votes that skipped
    and of its tile pairs dropped (ops/panel.pair_skip_share) on case c,
    with the Wolf field or without, or of wolf_panel's whole kernel
    (ops/panel.wolf_skip_share) with `field_alone`; returns them."""
    from lidp_tpu_torch.ops import panel

    if field_alone:
        votes, skipped, dropped, npairs = panel.wolf_skip_share(
            c["x"], c["q"], c["mol"], c["mask"], c["L"], pair.cut_coulsq)
    else:
        tabs = tabs_for(pair, c["x"].dtype)
        votes, skipped, dropped, npairs = panel.pair_skip_share(
            c["x"], c["q"], c["type"], c["mol"] if wolf else None,
            c["mask"], tabs, c["L"], pair.cut_coulsq, pair.qqrd2e,
            pair.g_ewald, sp=c["sp"])
    print(f"skip share {tag}: {dropped} of {npairs} tile pairs dropped = "
          f"{dropped / npairs:.4f}; {skipped} of {votes} warp votes in the "
          f"others skipped = {skipped / max(votes, 1):.4f}")
    return dict(votes=votes, skipped=skipped, tile_pairs_dropped=dropped,
                tile_pairs=npairs)


def partial_buffers(c, pair, pd, c32):
    """Print the partial buffers of the float64 whole-panel eind, dipole
    and pair (with the field) kernels on case c, and the device memory the
    caching allocator has reserved after a call of each and a second eind
    call, from an emptied cache: each wrapper takes its buffer per call
    and frees it on return; then wolf_panel's (float32, on c32) and the
    memory reserved over one call of it from an emptied cache."""
    import torch

    from lidp_tpu_torch.ops import panel

    n = c["x"].shape[0]
    size = {}
    for name, tile, comps in (
            ("eind_panel_df", panel.EIND_TILE, 3),
            ("dipole_panel_df", panel.whole_tile("dipole_panel_df"), 3),
            ("pair_panel_df", panel.whole_tile("pair_panel_df"), 6)):
        nT = -(-n // tile)
        size[name] = nT * (nT + 1) * comps * tile * 8 / 1e6
    tabs = tabs_for(pair, torch.float64)

    def eind():
        return panel.eind_panel_df(c["x"], c["alpha"], c["mu"], c["L"], pd)

    def dipole():
        return panel.dipole_panel_df(c["x"], c["q"], c["mol"], c["alpha"],
                                     c["mu"], c["mask"], c["L"], pd,
                                     pair.cut_coulsq, pair.qqrd2e)

    def pair_df():
        return panel.pair_panel_df(c["x"], c["q"], c["type"], c["mask"],
                                   tabs, c["L"], pair.cut_coulsq,
                                   pair.qqrd2e, pair.g_ewald, sp=c["sp"],
                                   mol=c["mol"])

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    r0 = torch.cuda.memory_reserved()
    grew = []
    for call in (eind, dipole, pair_df, eind):
        call()
        torch.cuda.synchronize()
        grew.append((torch.cuda.memory_reserved() - r0) / 1e6)
    bt = panel.whole_tile("wolf_panel")
    nT = -(-n // bt)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    r0 = torch.cuda.memory_reserved()
    panel.wolf_panel(c32["x"], c32["q"], c32["mol"], c32["mask"], c32["L"],
                     pair.cut_coulsq)
    torch.cuda.synchronize()
    print(f"partial buffers, float64, npad {n}: "
          + ", ".join(f"{k} {v:.1f} MB" for k, v in size.items())
          + "; reserved after eind, dipole, pair, eind again: "
          + ", ".join(f"+{g:.1f}" for g in grew) + " MB; wolf_panel "
          f"(float32) {nT * (nT + 1) * 3 * bt * 4 / 1e6:.1f} MB, reserved "
          f"+{(torch.cuda.memory_reserved() - r0) / 1e6:.1f} MB over a "
          f"call")


def skip_share(tag, x, alpha_eff, mu, L, pd, forms=("whole",)):
    """Print the share of the eind kernels' warp votes that skipped the
    exponential (ops/panel.eind_skip_share), per form."""
    from lidp_tpu_torch.ops import panel

    for form in forms:
        kw = {} if form == "whole" else dict(cols=(x, alpha_eff, mu), row0=0)
        votes, skipped = panel.eind_skip_share(x, alpha_eff, mu, L, pd, **kw)
        print(f"skip share {tag} [{form}]: {skipped} of {votes} warp votes "
              f"= {skipped / votes:.4f}")


def fluid_skip_share(tag, bench):
    """skip_share on a polar bench's current state, in its dtype, and for
    path C's inner solve in float32 as well; dipole_skip_share on it."""
    import torch

    a = bench.arrays
    ae = torch.where(a["mask"], a["alpha"], 0.0)
    L, pd = bench.step.box_lengths, bench.settings.polar_damp
    skip_share(f"eind {a['x'].dtype} fluid, {tag}", a["x"], ae, a["mu"], L,
               pd)
    if a["x"].dtype == torch.float64:
        f32 = [t.float() for t in (a["x"], ae, a["mu"], L)]
        skip_share(f"eind float32 fluid, {tag}", *f32, pd)
    dt = a["x"].dtype
    c = dict(x=a["x"], q=a["q"], mol=a["mol"].to(dt), alpha=ae, mu=a["mu"],
             mask=a["mask"].to(dt), L=L)
    dipole_skip_share(f"{dt} fluid, {tag}", c, bench.step.cut_coulsq,
                      bench.step.qqrd2e, pd, bench.settings.damping_type)


def energy_row(tag, en):
    import torch

    vals = [float(en[k]) for k in ("evdwl", "ecoul", "elong", "epol")]
    if not all(math.isfinite(v) for v in vals) or \
            not bool(torch.isfinite(en["virial"]).all()):
        raise AssertionError(f"{tag}: non-finite energies {vals}")
    print(f"{tag}: evdwl {vals[0]:.6f} ecoul {vals[1]:.4f} "
          f"elong {vals[2]:.4f} epol {vals[3]:.6f} "
          f"scf_iters {en['scf_iters']}")


def check_counts(path, got, want):
    """The launch counters of one path: `want` for the kernels it runs, 0
    for every other."""
    want = {name: want.get(name, 0) for name in ALL_KERNELS}
    print(f"path {path} launches: {got}")
    if got != want:
        raise AssertionError(f"path {path}: launch counts {got} do not "
                             f"match the path ({want})")


def check_finite(path, bench):
    import torch

    for name in ("x", "v", "mu", "f"):
        if not bool(torch.isfinite(bench.arrays[name]).all()):
            raise AssertionError(f"path {path}: non-finite {name}")


def thermo_line(tag, row):
    print(f"{tag}: " + " ".join(
        f"{k} {row[k]:.6f}" for k in ("etotal", "ke", "pe", "epol", "temp",
                                        "press")) + f" scf_iters "
          f"{row['scf_iters']}")


def check_rigid(path, bench, sys0, rows):
    """Path G's gates on the last state: every thermo row and every
    per-atom array finite; each body's three intra-body distances equal
    those at setup within 1e-4 relative; each quaternion's norm within
    1e-5 of 1."""
    import torch

    sys, res, st = bench.state
    if not all(math.isfinite(v) for r in rows for k, v in r.items()
               if isinstance(v, float)):
        raise AssertionError(f"path {path}: a non-finite thermo value")
    for name, t in (("x", sys.x), ("v", sys.v), ("mu", sys.mu),
                    ("f", res.f), ("quat", st.quat)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"path {path}: non-finite {name}")
    n = bench.natoms
    x0, x = (a[:n].double().reshape(-1, 3, 3) for a in (sys0.x, sys.x))
    worst = 0.0
    for i, j in ((0, 1), (0, 2), (1, 2)):
        d0 = (x0[:, i] - x0[:, j]).norm(dim=1)
        d = (x[:, i] - x[:, j]).norm(dim=1)
        worst = max(worst, float(((d - d0).abs() / d0).max()))
    qerr = float((st.quat.double().norm(dim=1) - 1.0).abs().max())
    moved = float((x - x0).norm(dim=2).max())
    print(f"path {path}: {bench.setup.nbody} bodies, intra-body distances "
          f"at step {sys.step} vs setup: max rel err {worst:.3e}; max "
          f"| |q| - 1 | {qerr:.3e}; atoms moved up to {moved:.4f} A")
    if not (worst <= 1e-4 and qerr <= 1e-5 and moved > 0):
        raise AssertionError(f"path {path}: bodies not rigid (distance "
                             f"{worst:.3e}, |q| {qerr:.3e}, moved {moved})")


def rigid_share(bench, steps):
    """Path G's step in its parts over `steps` more steps: the rigid
    integrator's initial half, the force evaluation (FastPolarRunner.
    forces: the panels, the Ewald sum, the CG) and the final half, in ms
    per step by the CUDA events of FastPolarRunner.run(part_ms=), each
    step synchronised; also the steps' host time."""
    import torch

    sys, res, st = bench.state
    parts = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sys, res, _, st = bench.runner.run(sys, res, None, st, steps,
                                       part_ms=parts)
    wall = 1e3 * (time.perf_counter() - t0) / steps
    bench.state = (sys, res, st)
    return {k: v / steps for k, v in parts.items()}, wall


def g64_compare(rows_k, rows_p, states_k, states_p, n):
    """Path G64's kernel route against its plain route, step by step: the
    thermo columns rel 1e-9 of max(1, |value|), positions, dipoles and
    quaternions 1e-8 of their largest entry (the JAX package's bars for
    this runner, tests/test_fast_polar.py:77,84)."""
    worst_row = worst_arr = 0.0
    for k, (rk, rp, sk, sp) in enumerate(zip(rows_k, rows_p, states_k,
                                             states_p)):
        for c in G64_COLS:
            rel = abs(rk[c] - rp[c]) / max(1.0, abs(rp[c]))
            worst_row = max(worst_row, rel / 1e-9)
            if rel > 1e-9:
                raise AssertionError(f"path G64 step {k} {c}: kernels "
                                     f"{rk[c]!r}, plain {rp[c]!r}")
        for name, a, b in (("x", sk[0].x[:n], sp[0].x[:n]),
                           ("mu", sk[0].mu[:n], sp[0].mu[:n]),
                           ("quat", sk[2].quat, sp[2].quat)):
            err = float((a - b).abs().max())
            big = float(b.abs().max())
            worst_arr = max(worst_arr, err / (1e-8 * big))
            if not err <= 1e-8 * big:
                raise AssertionError(f"path G64 step {k} {name}: max abs "
                                     f"err {err:.3e} above 1e-8 of "
                                     f"{big:.3e}")
    print(f"path G64 kernels vs plain route over {len(rows_k)} evaluations: "
          f"thermo columns at {worst_row:.3g} of their bar, x/mu/quat at "
          f"{worst_arr:.3g} of theirs")


# the cell route adds every special pair at full weight and subtracts it
# again (forcefield.compute_forces, as the JAX package does): on the fluid
# the O-H pairs' LJ term is ~1.4e6 a pair, so its float64 sums, in any
# order, carry ~sqrt(terms) * eps (~1e-14) of that magnitude.  Bars on the
# cell route add CANCEL_REL of it (cancelled) to their relative bar.
CANCEL_REL = 1e-13


def cancelled(sim):
    """The magnitudes the special-bond correction cancels on `sim`'s
    (a sim.Simulation's) current state, by thermo column: |E| of the
    special pairs' LJ and coulomb terms (thermo-normalized), the pressure
    of their virial; {} without special lists."""
    from lidp_tpu_torch.ops.bonded import special_correction_sparse

    ff = sim.runner.ff
    if getattr(ff, "sp_idx", None) is None:
        return {}
    s, tp = sim.sys, sim.thermo_params
    _, dev, dec, dvir = special_correction_sparse(
        s.x, s.q, s.type, ff.sp_idx, ff.sp_lvl, s.mask, s.box, ff.pair)
    norm = tp.natoms if tp.norm else 1.0
    ev, ec = abs(float(dev)) / norm, abs(float(dec)) / norm
    press = (float(dvir[:3].abs().sum()) / (3.0 * float(s.box.volume))
             * tp.nktv2p)
    return dict(evdwl=ev, ecoul=ec, pe=ev + ec, etotal=ev + ec, press=press)


def rows_agree(path, rows, ref, rels, cols=G64_COLS, cancel=None):
    """Thermo rows against reference rows, row k's `cols` within rels[k]
    of max(1, |value|), plus CANCEL_REL of `cancel`'s magnitude for the
    column (cancelled()) where given; raises on the first that is not.
    Returns the largest ratio of a difference to its bar."""
    if len(rows) != len(ref):
        raise AssertionError(f"path {path}: {len(rows)} rows, reference "
                             f"{len(ref)}")
    cancel = cancel or {}
    worst = 0.0
    for k, (r, g, rel) in enumerate(zip(rows, ref, rels)):
        for c in cols:
            bar = (rel * max(1.0, abs(g[c]))
                   + CANCEL_REL * cancel.get(c, 0.0))
            worst = max(worst, abs(r[c] - g[c]) / bar)
            if not abs(r[c] - g[c]) <= bar:
                raise AssertionError(f"path {path} row {k} {c}: {r[c]!r}, "
                                     f"reference {g[c]!r}")
    return worst


# the dense route's phases (forcefield.dense_forces), each timed by CUDA
# events around the module function it calls
DENSE_PHASES = (("pair", "pair", "dense_pair_forces"),
                ("ewald", "ewald", "ewald_forces"),
                ("pppm", "pppm", "pppm_forces_params"),
                ("field", "polarization", "static_field_wolf"),
                ("T build", "polarization", "dipole_field_tensor"),
                ("solve", "polarization", "scf_solve"),
                ("dipole forces", "polarization", "dipole_forces_energy"))


class DensePhases:
    """Within `with DensePhases():` every call of the dense route's phase
    functions (DENSE_PHASES, the module functions dense_forces calls; or
    `phases`, whose modules are named in full) is timed by CUDA events,
    and every solve's iterations and divergence flag kept; the functions
    are restored on exit."""

    def __init__(self, phases=DENSE_PHASES):
        self.phases = phases

    def __enter__(self):
        import importlib

        import torch

        self.events, self.solves, self._saved = [], [], []

        def timed(label, fn):
            def wrapped(*a, **kw):
                e0, e1 = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                e0.record()
                out = fn(*a, **kw)
                e1.record()
                self.events.append((label, e0, e1))
                if label == "solve":
                    self.solves.append((int(out[1]), out[2]))
                return out
            return wrapped

        for label, mod, name in self.phases:
            m = importlib.import_module(
                mod if mod.startswith("lidp_tpu_torch") else
                f"lidp_tpu_torch.ops.{mod}")
            self._saved.append((m, name, getattr(m, name)))
            setattr(m, name, timed(label, getattr(m, name)))
        return self

    def __exit__(self, *exc):
        for m, name, fn in self._saved:
            setattr(m, name, fn)
        return False

    def ms(self, per):
        """Device ms of each phase, summed and divided by `per`."""
        import torch

        torch.cuda.synchronize()
        out = {label: 0.0 for label, _, _ in self.phases}
        for label, e0, e1 in self.events:
            out[label] += e0.elapsed_time(e1) / per
        return out

    def iterations(self):
        return [it for it, _ in self.solves]

    def all_converged(self):
        return bool(self.solves) and not any(bool(d) for _, d in self.solves)


def phase_line(tag, ms, iters, unit):
    return (f"{tag} phases, ms {unit} by CUDA events: " + ", ".join(
        f"{k} {v:.4f}" for k, v in ms.items())
        + f"; CG iterations an evaluation {iters}")


def dense_run(in_fluid, steps, fast_polar=None, prec="1e-11"):
    """The script `in_fluid` through LammpsScript(dtype=torch.float64) on
    the card, LIDP_FAST_POLAR unset (the dense route below the cap) or set
    to `fast_polar`: (script, its log lines, seconds of the run, peak
    device memory in bytes)."""
    import torch

    from lidp_tpu_torch.io.script import LammpsScript

    old = os.environ.pop("LIDP_FAST_POLAR", None)
    if fast_polar is not None:
        os.environ["LIDP_FAST_POLAR"] = fast_polar
    try:
        log = []
        script = LammpsScript(dtype=torch.float64, log=log.append)
        script.variables.update(prec=prec, nstep=str(steps))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        script.file(in_fluid)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
    finally:
        os.environ.pop("LIDP_FAST_POLAR", None)
        if old is not None:
            os.environ["LIDP_FAST_POLAR"] = old
    return script, log, seconds, peak


def check_dense_runner(path, script, natoms):
    from lidp_tpu_torch.integrate.driver import Runner

    runner = script._sim.runner
    if type(runner) is not Runner or runner.neighbor_cfg is not None:
        raise AssertionError(f"path {path}: runner {type(runner).__name__} "
                             f"is not the dense route's Runner")
    if script._sim.sys.x.shape[0] != natoms:
        raise AssertionError(f"path {path}: the System is padded")


def check_rows_finite(path, rows, ncols=G64_COLS):
    for k, r in enumerate(rows):
        if not all(math.isfinite(r[c]) for c in ncols):
            raise AssertionError(f"path {path} row {k} not finite: {r}")


# a log's thermo header words -> thermo keywords (sim.Simulation._HEADER)
LOG_COLS = {"Step": "step", "TotEng": "etotal", "KinEng": "ke",
            "PotEng": "pe", "E_vdwl": "evdwl", "E_coul": "ecoul",
            "E_long": "elong", "E_pol": "epol", "Temp": "temp",
            "Press": "press", "E_pair": "epair", "E_mol": "emol",
            "Volume": "vol", "Lx": "lx", "Ly": "ly", "Lz": "lz",
            "E_bond": "ebond", "E_angle": "eangle", "E_dihed": "edihed",
            "E_impro": "eimp"}


def log_rows(lines):
    """The thermo rows of a log: the lines after a `Step ...` header up to
    the `Loop time` line, as dicts of thermo keywords."""
    rows, cols = [], None
    for line in lines:
        words = line.split()
        if words and words[0] == "Step":
            cols = [LOG_COLS.get(w, w) for w in words]
        elif line.startswith("Loop time"):
            cols = None
        elif cols and len(words) == len(cols):
            rows.append({c: float(w) for c, w in zip(cols, words)})
    return rows


def loop_seconds(lines, nsteps):
    """The seconds of the `Loop time of T on 1 procs for N steps` line of
    a log (N must be nsteps)."""
    for line in lines:
        words = line.split()
        if line.startswith("Loop time") and int(words[8]) == nsteps:
            return float(words[3])
    raise AssertionError(f"no Loop time line for {nsteps} steps")


def run_rigid_states(bench, steps):
    """polar_bench.setup_rigid + `steps` run_rigid steps one at a time:
    (rows, states, host seconds of the steps, the float64 residual passes
    and the float32 inner sweeps of host mode's mixed solves, summed over
    the evaluations)."""
    import torch

    from lidp_tpu_torch.models import polar_bench

    hpf = bench.runner._hpf
    rows = [polar_bench.setup_rigid(bench)]
    states = [bench.state]
    outer, inner = hpf.outer_passes, sum(hpf.inner_iters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        rows += polar_bench.run_rigid(bench, 1)
        states.append(bench.state)
        outer += hpf.outer_passes
        inner += sum(hpf.inner_iters)
    torch.cuda.synchronize()
    return rows, states, time.perf_counter() - t0, (outer, inner)


def rigid_xq(state, n):
    """Copies of a rigid state's atom positions and body quaternions."""
    return state[0].x[:n].clone(), state[2].quat.clone()


def check_rigid_motion(g0, g, p0, p):
    """Path G's integrator against G64's plain route over the same steps
    from the same setup: each atom's displacement and each quaternion's
    change (rigid_xq pairs), float32 fused kernels against float64 plain
    versions, within 1e-2 of the largest entry of the plain route's."""
    for name, ag0, ag, ap0, ap in zip(("x", "quat"), g0, g, p0, p):
        dg, dp = ag.double() - ag0.double(), ap - ap0
        err = float((dg - dp).abs().max())
        big = float(dp.abs().max())
        print(f"path G {name} change over {G64_STEPS} steps vs float64 "
              f"plain route: max abs err {err:.3e} of max {big:.3e} "
              f"({err / big:.3e})")
        if not (big > 0 and err <= 1e-2 * big):
            raise AssertionError(f"path G {name}: the integrator's "
                                 f"{G64_STEPS} steps disagree with the "
                                 f"plain route ({err:.3e} of {big:.3e})")


def check_f64_step0(path, n, f, mu, en, ref_f, ref_mu, ref_en):
    """Step 0 of a float64 kernel path against the float64 plain path:
    evdwl/ecoul/elong rel 1e-10, epol rel 1e-8, f and mu atol 1e-8*max."""
    for k, rel in (("evdwl", 1e-10), ("ecoul", 1e-10), ("elong", 1e-10),
                   ("epol", 1e-8)):
        a, b = float(en[k]), float(ref_en[k])
        print(f"path {path} step 0 {k}: kernels {a:.12f}, plain {b:.12f}")
        if abs(a - b) > rel * abs(b):
            raise AssertionError(f"path {path} step 0 {k}: {a!r} vs {b!r}")
    for tag, a, b in (("forces", f, ref_f), ("dipoles", mu, ref_mu)):
        err = float((a[:n] - b[:n]).abs().max())
        big = float(b[:n].abs().max())
        print(f"path {path} step 0 {tag} vs float64 plain: max abs err "
              f"{err:.3e} of max {big:.3e}")
        if not err <= 1e-8 * big:
            raise AssertionError(f"path {path} step 0 {tag}: max abs err "
                                 f"{err:.3e} above 1e-8 of {big:.3e}")


def lj_pair_counts(xs, live, L, cutsq):
    """(unordered pairs of live slots that the Newton half stencil holds,
    those of them inside the cutoff) on a slot state: xs (nbx,nby,nbz,cap,3)
    float32 coordinates, live the (nbx,nby,nbz,cap) slots that hold an
    atom, L the box lengths.  The neighbour takes the +-L shift by cell
    index as the kernels do, and rsq is rounded term by term."""
    import torch

    from lidp_tpu_torch.ops.cell_kernels import _wrap_shift
    from lidp_tpu_torch.ops.cells import _HALF_OFFSETS, _roll

    nb, cap, dev = xs.shape[:3], xs.shape[3], xs.device
    tri = torch.ones((cap, cap), dtype=torch.bool, device=dev).triu(1)
    n_live = n_cut = 0
    for o in [(0, 0, 0)] + _HALF_OFFSETS:
        both = live[..., :, None] & _roll(live, o, -1)[..., None, :]
        if o == (0, 0, 0):
            both = both & tri
        rsq = None
        for d in range(3):
            nbr = _roll(xs[..., d], o, -1)
            if o[d]:
                nbr = nbr + _wrap_shift(nb[d], o[d], d, dev) * L[d]
            dd = xs[..., d][..., :, None] - nbr[..., None, :]
            rsq = dd * dd if rsq is None else rsq + dd * dd
            del dd, nbr
        n_live += int(both.sum())
        n_cut += int((both & (rsq < cutsq)).sum())
        del both, rsq
    return n_live, n_cut


def cell_bound_ms(name, xs, live, L, cutsq, natoms, need_ev=False):
    """Least time of an LJ cell kernel on the card, counted on the state it
    is timed on: each unordered pair of live slots in the Newton half
    stencil tested against the cutoff (LJ_FLOPS_TEST), each pair inside it
    given its force on both atoms (LJ_FLOPS_FORCE, LJ_FLOPS_EV more with
    need_ev), over the FP32 peak, against the bytes it must move over the
    HBM rate (slot order: 3 grids in, 3 out; atom order: x, mask and
    atom_of_slot in, f out).  Returns (ms, what binds it, the TPU kernel's
    count in ms: cells*cap*cap*14 slot pairs at 25 flops, padding
    included; and the two pair counts)."""
    nbx, nby, nbz, cap = live.shape
    slots = nbx * nby * nbz * cap
    n_live, n_cut = lj_pair_counts(xs, live, L, cutsq)
    flops = n_live * LJ_FLOPS_TEST + n_cut * (
        LJ_FLOPS_FORCE + (LJ_FLOPS_EV if need_ev else 0))
    if name == "slot_lj_forces":
        nbytes = 24 * slots + 4 * 8
    else:
        nbytes = 25 * natoms + 4 * slots + 4 * 8
    t_ops, t_bytes = flops / FP32_PEAK, nbytes / HBM_RATE
    tpu_count = 1e3 * slots * cap * 14 * LJ_FLOPS_PER_PAIR / FP32_PEAK
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", tpu_count,
            dict(live_pairs=n_live, cutoff_pairs=n_cut))


def lj_compare(name, got, ref, need_ev, fscale=None):
    """(f, evdwl, virial) of an LJ cell kernel against its plain version:
    forces 5e-6 of max |f|, evdwl and virial rel 1e-5 of the largest entry
    (zeros when need_ev is off).  Returns (max abs force error, max |f|)."""
    import torch

    f, r = got[0].double(), ref[0].double()
    if f.shape != r.shape or got[0].dtype != ref[0].dtype:
        raise AssertionError(f"{name}: {got[0].dtype} {tuple(f.shape)} vs "
                             f"plain {ref[0].dtype} {tuple(r.shape)}")
    err, scale = float((f - r).abs().max()), float(r.abs().max())
    if not bool(torch.isfinite(f).all()) or \
            not err <= 5e-6 * (fscale or scale):
        raise AssertionError(f"{name}: forces max abs err {err:.3e} of max "
                             f"|f| {scale:.3e}")
    for tag, g, r in (("evdwl", got[1], ref[1]), ("virial", got[2], ref[2])):
        g, r = g.double().reshape(-1), r.double().reshape(-1)
        if need_ev:
            bad = bool(((g - r).abs() > 1e-5 * r.abs().max()).any())
        else:
            bad = bool(g.any())
        if bad or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name} {tag}: {g.tolist()} vs "
                                 f"{r.tolist()} (need_ev={need_ev})")
    return err, scale


# LAMMPS' bench/in.lj and examples/melt/in.melt, verbatim (the paths L,
# L64 and M; the repo's tests scale their regions down)
LJ_SCRIPT = """\
# 3d Lennard-Jones melt

variable\tx index 1
variable\ty index 1
variable\tz index 1

variable\txx equal 20*$x
variable\tyy equal 20*$y
variable\tzz equal 20*$z

units\t\tlj
atom_style\tatomic

lattice\t\tfcc 0.8442
region\t\tbox block 0 ${xx} 0 ${yy} 0 ${zz}
create_box\t1 box
create_atoms\t1 box
mass\t\t1 1.0

velocity\tall create 1.44 87287 loop geom

pair_style\tlj/cut 2.5
pair_coeff\t1 1 1.0 1.0 2.5

neighbor\t0.3 bin
neigh_modify\tdelay 0 every 20 check no

fix\t\t1 all nve

run\t\t100
"""

MELT_SCRIPT = """\
# 3d Lennard-Jones melt

units\t\tlj
atom_style\tatomic

lattice\t\tfcc 0.8442
region\t\tbox block 0 10 0 10 0 10
create_box\t1 box
create_atoms\t1 box
mass\t\t1 1.0

velocity\tall create 3.0 87287

pair_style\tlj/cut 2.5
pair_coeff\t1 1 1.0 1.0 2.5

neighbor\t0.3 bin
neigh_modify\tevery 20 delay 0 check no

fix\t\t1 all nve

dump\t\tid all atom 50 dump.melt

#dump\t\t2 all image 25 image.*.jpg type type &
#\t\taxes yes 0.8 0.02 view 60 -30
#dump_modify\t2 pad 3

#dump\t\t3 all movie 25 movie.mpg type type &
#\t\taxes yes 0.8 0.02 view 60 -30
#dump_modify\t3 pad 3

thermo\t\t50
run\t\t250
"""


# LAMMPS' bench/in.chain, verbatim (paths U and U64; its data.chain is
# written by chain_script_case)
CHAIN_SCRIPT = """\
# FENE beadspring benchmark

units\t\tlj
atom_style\tbond
special_bonds\tfene

read_data\tdata.chain

neighbor\t0.4 bin
neigh_modify\tevery 1 delay 1

bond_style      fene
bond_coeff\t1 30.0 1.5 1.0 1.0

pair_style\tlj/cut 1.12
pair_modify\tshift yes
pair_coeff\t1 1 1.0 1.0 1.12

fix\t\t1 all nve
fix\t\t2 all langevin 1.0 1.0 10.0 904297

thermo          100
timestep\t0.012

run\t\t100
"""
# data.chain's density and temperature (320 chains of 100 beads in a box
# of ~33.6 sigma a side; its Velocities at T* ~ 0.97)
CHAIN_RHO = 0.85
CHAIN_T = 0.97


def chain_script_case(directory, n_chains=320, n_beads=100, seed=0):
    """Write a bead-spring melt in data.chain's form (atom_style bond, one
    atom type of mass 1, one bond type, image flags, Velocities) and
    CHAIN_SCRIPT as `in.chain`, in place of the reference's data.chain.
    The beads sit on a simple-cubic lattice of m^3 >= n sites (m a side)
    in a cubic box at density CHAIN_RHO, walked as a boustrophedon along
    x, then y, then z, so that consecutive sites are neighbours; the first
    n_chains * n_beads sites are cut into chains of n_beads, each site
    jittered by up to +-0.05 sigma from the seed.  Every bond is then
    about one spacing (~1.05 sigma at the full size, under FENE's R0 of
    1.5) and every other pair at least ~0.93 sigma apart.  Velocities are
    normal from the seed, with zero net momentum, scaled to CHAIN_T on 3n
    - 3 dof.  Floats by repr, so the file reads back bit for bit.
    Returns the paths (data, script)."""
    import numpy as np

    n = n_chains * n_beads
    m = int(math.ceil(n ** (1.0 / 3.0) - 1e-9))
    L = (n / CHAIN_RHO) ** (1.0 / 3.0)
    a = L / m
    sites = []
    for iz in range(m):
        ys = range(m) if iz % 2 == 0 else range(m - 1, -1, -1)
        for k, iy in enumerate(ys):
            xs = range(m) if (iz * m + k) % 2 == 0 else range(m - 1, -1, -1)
            sites.extend((ix, iy, iz) for ix in xs)
    rng = np.random.default_rng(seed)
    x = (np.asarray(sites[:n], float) + 0.5) * a
    x = x + rng.uniform(-0.05, 0.05, size=x.shape)
    v = rng.standard_normal((n, 3))
    v -= v.mean(axis=0)
    v *= math.sqrt(CHAIN_T * (3 * n - 3) / float(np.sum(v * v)))
    mol = np.arange(n) // n_beads + 1
    bonds = [(i + 1, i + 2) for i in range(n) if (i + 1) % n_beads]

    def r(val):
        return repr(float(val))

    lines = ["LAMMPS data file: bead-spring chains in data.chain's form", "",
             f"{n} atoms", f"{len(bonds)} bonds", "1 atom types",
             "1 bond types", ""]
    lines += [f"0.0 {r(L)} {ax}lo {ax}hi" for ax in "xyz"]
    lines += ["", "Masses", "", "1 1.0", "", "Atoms # bond", ""]
    lines += [f"{i + 1} {mol[i]} 1 {r(x[i, 0])} {r(x[i, 1])} {r(x[i, 2])} "
              "0 0 0" for i in range(n)]
    lines += ["", "Velocities", ""]
    lines += [f"{i + 1} {r(v[i, 0])} {r(v[i, 1])} {r(v[i, 2])}"
              for i in range(n)]
    lines += ["", "Bonds", ""]
    lines += [f"{k + 1} 1 {i} {j}" for k, (i, j) in enumerate(bonds)]
    data = os.path.join(directory, "data.chain")
    script = os.path.join(directory, "in.chain")
    with open(data, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    with open(script, "w") as fh:
        fh.write(CHAIN_SCRIPT)
    return data, script


# LAMMPS' bench/in.eam, verbatim but for the potential file: pair_coeff
# names the synthetic funcfl file eam_funcfl_case writes (paths X, X64)
EAM_FILE = "Cu_synth.eam"
EAM_SCRIPT = """\
# bulk Cu lattice

variable\tx index 1
variable\ty index 1
variable\tz index 1

variable\txx equal 20*$x
variable\tyy equal 20*$y
variable\tzz equal 20*$z

units\t\tmetal
atom_style\tatomic

lattice\t\tfcc 3.615
region\t\tbox block 0 ${xx} 0 ${yy} 0 ${zz}
create_box\t1 box
create_atoms\t1 box

pair_style\team
pair_coeff\t1 1 Cu_synth.eam

velocity\tall create 1600.0 376847 loop geom

neighbor\t1.0 bin
neigh_modify    every 1 delay 5 check yes

fix\t\t1 all nve

timestep\t0.005
thermo\t\t50

run\t\t100
"""
# the synthetic potentials' tables (eam_funcfl_case, eam_setfl_case):
# Cu_u3.eam's grid (nr = nrho = 500, dr 0.01 A, cut 4.95 A) and a drho
# that puts the lattice's density (~12.7) a third of the way up the table
EAM_NR, EAM_DR, EAM_CUT = 500, 0.01, 4.95
EAM_NRHO, EAM_DRHO = 500, 0.08
# r_e, the nearest-neighbour distance of fcc at a = 3.615 A, and the start
# of the quintic switch that takes each r-function, its slope and its
# curvature to 0 at the cut
EAM_RE = 3.615 / math.sqrt(2.0)
EAM_RS = 4.0
# per element: name, atomic number, mass, lattice constant, and the closed
# forms' constants: rho(r) = fe exp(-beta (r/r_e - 1)) s(r), Z(r) = Z0
# exp(-alpha (r/r_e - 1)) s(r), F(rho) = -A sqrt(rho) + B rho^2.  Cu's
# lattice at 3.615 A is bound (-3.5625 eV an atom) and lower than at 3.50
# and at 3.75 A (tests/test_torch_eam.py holds both); the second, lighter
# metal is less bound
EAM_ELEMENTS = (
    dict(name="Cu", z=29, mass=63.55, a0=3.615, beta=5.0, alpha=2.5,
         z0=0.25, fe=1.0, A=1.66, B=0.0013),
    dict(name="Al", z=13, mass=26.98, a0=4.05, beta=5.0, alpha=2.5,
         z0=0.20, fe=0.8, A=1.2, B=0.002))
# eam/fs: the density amplitude of element i toward element j (rhor[i][j]
# of pair_eam_fs.cpp), asymmetric so that the table j -> i is not i -> j
EAM_FS_FE = ((1.0, 0.9), (0.7, 0.8))


def _eam_switch(r):
    import numpy as np

    t = np.clip((r - EAM_RS) / (EAM_CUT - EAM_RS), 0.0, 1.0)
    return 1.0 - t ** 3 * (10.0 - 15.0 * t + 6.0 * t * t)


def _eam_forms(el, fe=None):
    """An element's tabulated F(rho), Z(r) and rho(r) (amplitude `fe`,
    the element's own by default) on the tables' grids."""
    import numpy as np

    r = np.arange(EAM_NR) * EAM_DR
    rho = np.arange(EAM_NRHO) * EAM_DRHO
    s = _eam_switch(r)
    f = -el["A"] * np.sqrt(rho) + el["B"] * rho * rho
    z = el["z0"] * np.exp(-el["alpha"] * (r / EAM_RE - 1.0)) * s
    dens = (el["fe"] if fe is None else fe) * np.exp(
        -el["beta"] * (r / EAM_RE - 1.0)) * s
    return f, z, dens


def _eam_lines(values):
    """Floats by repr, five a line, so that the file reads back bit for
    bit."""
    vals = [repr(float(v)) for v in values]
    return [" ".join(vals[i:i + 5]) for i in range(0, len(vals), 5)]


def eam_funcfl_case(directory):
    """Write EAM_FILE, a single-element funcfl file in the form of LAMMPS'
    Cu_u3.eam (a comment line, `29 63.55 3.615 FCC`, `nrho drho nr dr
    cut`, then F(rho), Z(r) and rho(r)), tabulated from EAM_ELEMENTS[0]'s
    closed forms, in place of Cu_u3.eam, which is not in the repo.
    Returns its path."""
    el = EAM_ELEMENTS[0]
    f, z, dens = _eam_forms(el)
    lines = ["synthetic Cu: closed-form rho, Z and F in Cu_u3.eam's form",
             f"{el['z']} {el['mass']} {el['a0']} FCC",
             f"{EAM_NRHO} {EAM_DRHO!r} {EAM_NR} {EAM_DR!r} {EAM_CUT!r}"]
    for arr in (f, z, dens):
        lines += _eam_lines(arr)
    path = os.path.join(directory, EAM_FILE)
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


def eam_setfl_case(directory, fs=False):
    """Write the two elements of EAM_ELEMENTS (Cu and a lighter metal) as
    a setfl file (eam/alloy), or with fs=True its Finnis-Sinclair variant
    (eam/fs: each element block carries a density function toward each
    element, EAM_FS_FE's amplitudes).  The cross pair's r*phi is
    27.2*0.529*Z_Cu(r)*Z_Al(r), unlike either element's own.  Returns its
    path."""
    els = EAM_ELEMENTS
    forms = [_eam_forms(el) for el in els]
    lines = ["synthetic Cu-Al: closed-form tables", "#", "#",
             f"{len(els)} " + " ".join(el["name"] for el in els),
             f"{EAM_NRHO} {EAM_DRHO!r} {EAM_NR} {EAM_DR!r} {EAM_CUT!r}"]
    for i, el in enumerate(els):
        lines.append(f"{el['z']} {el['mass']} {el['a0']} fcc")
        lines += _eam_lines(forms[i][0])
        if fs:
            for j in range(len(els)):
                lines += _eam_lines(_eam_forms(el, EAM_FS_FE[i][j])[2])
        else:
            lines += _eam_lines(forms[i][2])
    for i in range(len(els)):
        for j in range(i + 1):
            lines += _eam_lines(27.2 * 0.529 * forms[i][1] * forms[j][1])
    path = os.path.join(directory, "CuAl_synth.eam." + ("fs" if fs
                                                        else "alloy"))
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


def eam_alloy_script(fs=False):
    """EAM_SCRIPT with two atom types: pair_style eam/alloy (or eam/fs) on
    eam_setfl_case's file, `pair_coeff * * <file> Cu Al`, and each atom
    made type 2 with probability 0.5 by `set type 1 type/fraction` (a
    RanPark draw per atom from the seed 4987 and its coordinates) before
    the velocities are drawn (paths Y and Z)."""
    style = "eam/fs" if fs else "eam/alloy"
    name = "CuAl_synth.eam." + ("fs" if fs else "alloy")
    return EAM_SCRIPT.replace("create_box\t1 box", "create_box\t2 box") \
        .replace("create_atoms\t1 box\n",
                 "create_atoms\t1 box\nset\t\ttype 1 type/fraction 2 0.5 "
                 "4987\n") \
        .replace(f"pair_style\team\npair_coeff\t1 1 {EAM_FILE}",
                 f"pair_style\t{style}\npair_coeff\t* * {name} Cu Al")


FLUID_SCRIPT = """\
variable prec index 1e-11
variable nstep index 20
units real
atom_style full
boundary p p p
read_data fluid.data
special_bonds lj/coul 0.0 0.0 0.0
set type 1 static_polarizability 1.1
set type 2 static_polarizability 0.4
pair_style lj/cut/coul/long/polarization 6.0 6.5 precision ${prec} \
damp_type exponential use_previous yes
pair_coeff 1 1 0.1 3.0
pair_coeff 1 2 0.05 2.7
pair_coeff 2 2 0.03 2.5
kspace_style ewald/disp 1e-4
timestep 0.5
fix 1 all rigid/nve molecule
thermo_style custom step etotal ke pe evdwl ecoul elong epol temp press
thermo 1
run ${nstep}
"""


def point_charge_script(text=FLUID_SCRIPT):
    """The point-charge fluid: `text` (FLUID_SCRIPT by default) without
    the static polarizabilities and with pair_style lj/cut/coul/long 6.0
    6.5 for the polarizable style (BASELINE.json config 2's styles with
    the fluid's ewald/disp and rigid molecules)."""
    out = []
    for line in text.splitlines():
        if "static_polarizability" in line:
            continue
        if line.startswith("pair_style lj/cut/coul/long/polarization"):
            line = "pair_style lj/cut/coul/long 6.0 6.5"
        out.append(line)
    return "\n".join(out) + "\n"


def fluid_script_case(directory, n_side=15, seed=0, wrapped=False):
    """Write polar_bench.synthetic_system(n_side, seed=seed) as a LAMMPS
    data file, `fluid.data` (atom_style full with image flags, Masses,
    Velocities, Bonds; floats by repr, so read back bit for bit), and the
    input `in.fluid` (FLUID_SCRIPT: the keywords of
    polar_bench.synthetic_forcefield, the molecules as rigid bodies, a
    thermo row a step; `-var prec` and `-var nstep` set the SCF precision
    and the steps).  wrapped: shift x by L/2 and wrap it into the box, so
    that molecules straddle the faces, with the image flags that unwrap
    them (topology.infer_image_flags on the bonds).  Returns the paths
    (data, script)."""
    import numpy as np

    from lidp_tpu_torch.models import polar_bench
    from lidp_tpu_torch.topology import infer_image_flags

    d = polar_bench.synthetic_system(n_side, seed=seed)
    x, L = d["x"], d["L"]
    n = x.shape[0]
    image = np.zeros((n, 3), np.int64)
    if wrapped:
        x = x + 0.5 * L
        x = x - np.floor(x / L) * L
        image = infer_image_flags(x, d["bonds"], np.zeros(3), L)
    mass = {1: 15.9994, 2: 1.008}

    def r(v):
        return repr(float(v))

    lines = ["LAMMPS data file: synthetic polarizable fluid", "",
             f"{n} atoms", f"{len(d['bonds'])} bonds", "2 atom types",
             "1 bond types", ""]
    lines += [f"0.0 {r(L[k])} {a}lo {a}hi" for k, a in enumerate("xyz")]
    lines += ["", "Masses", ""] + [f"{t} {r(m)}" for t, m in mass.items()]
    lines += ["", "Atoms # full", ""]
    lines += [f"{i + 1} {d['mol'][i]} {d['type'][i]} {r(d['q'][i])} "
              f"{r(x[i, 0])} {r(x[i, 1])} {r(x[i, 2])} "
              f"{image[i, 0]} {image[i, 1]} {image[i, 2]}"
              for i in range(n)]
    lines += ["", "Velocities", ""]
    lines += [f"{i + 1} {r(d['v'][i, 0])} {r(d['v'][i, 1])} "
              f"{r(d['v'][i, 2])}" for i in range(n)]
    lines += ["", "Bonds", ""]
    lines += [f"{k + 1} 1 {a} {b}" for k, (a, b) in enumerate(d["bonds"])]
    data = os.path.join(directory, "fluid.data")
    script = os.path.join(directory, "in.fluid")
    with open(data, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    with open(script, "w") as fh:
        fh.write(FLUID_SCRIPT)
    return data, script


# flexible molecules: examples/peptide's and bench/in.rhodo's stack
# (flexible_script_case)
FLEX_NVT = "nvt temp 275.0 275.0 100.0 tchain 1"
FLEX_NPT = "npt temp 275.0 275.0 100.0 iso 1.0 1.0 1000.0 mtk no pchain 0 " \
    "tchain 1"
# the X-H bonds (CT-H, N-H), the water O-H bonds and the water angle
FLEX_SHAKE = "shake 0.0001 10 100 b 1 5 7 a 10"

FLEX_SCRIPT = """\
variable nstep index 10
units real
atom_style full
pair_style {pair}
bond_style harmonic
angle_style charmm
dihedral_style charmm
improper_style harmonic
pair_modify mix arithmetic
{kspace}read_data flex.data
{replicate}pair_coeff 5 5 0.2 3.296 0.2 2.76
special_bonds charmm
neighbor 2.0 bin
neigh_modify delay 5
timestep 2.0
thermo_style multi
thermo 1
fix 1 all {fix}
fix 2 all {shake}
run ${{nstep}}
"""

# atom types: name, mass, Pair Coeffs (eps sigma eps14 sigma14)
FLEX_TYPES = (("CT", 12.011, (0.08, 3.671, 0.01, 3.385)),
              ("HA", 1.008, (0.022, 2.352, 0.022, 2.352)),
              ("C", 12.011, (0.11, 3.564, 0.11, 3.564)),
              ("O", 15.999, (0.12, 3.029, 0.12, 2.494)),
              ("N", 14.007, (0.2, 3.296, 0.2, 2.76)),
              ("HN", 1.008, (0.046, 0.4, 0.046, 0.4)),
              ("OW", 15.9994, (0.1521, 3.1507, 0.1521, 3.1507)),
              ("HW", 1.008, (0.046, 0.4, 0.046, 0.4)))
# bond types (K, r0): CT-H, CT-C, C=O, C-N, N-H, N-CT, OW-HW
FLEX_BONDS = ((322.0, 1.09), (250.0, 1.5), (620.0, 1.23), (370.0, 1.345),
              (440.0, 0.997), (320.0, 1.43), (450.0, 0.9572))
# angle types (K, theta0, K_ub, r_ub), keyed by (end type, centre type,
# end type) names, the ends sorted
FLEX_ANGLES = {("HA", "CT", "HA"): (35.5, 108.4, 5.4, 1.802),
               ("C", "CT", "HA"): (33.0, 109.5, 30.0, 2.163),
               ("HA", "CT", "N"): (51.5, 109.5, 0.0, 0.0),
               ("CT", "C", "O"): (80.0, 121.0, 0.0, 0.0),
               ("CT", "C", "N"): (80.0, 116.5, 0.0, 0.0),
               ("N", "C", "O"): (80.0, 122.5, 50.0, 2.37),
               ("C", "N", "HN"): (34.0, 123.0, 0.0, 0.0),
               ("C", "N", "CT"): (50.0, 120.0, 0.0, 0.0),
               ("CT", "N", "HN"): (35.0, 117.0, 0.0, 0.0),
               ("HW", "OW", "HW"): (55.0, 104.52, 0.0, 0.0)}
# dihedral types (K, n, d, weight) by the central bond's atom names
FLEX_DIHEDRALS = {("C", "CT"): (0.1, 3, 0, 1.0),
                  ("C", "N"): (2.5, 2, 180, 1.0),
                  ("CT", "N"): (0.05, 3, 0, 0.5)}
# improper types (K, chi0): on the carbonyl C and on the amide N
FLEX_IMPROPERS = ((120.0, 0.0), (20.0, 0.0))


def _nma():
    """N-methylacetamide (CH3-CO-NH-CH3), planar amide in the xy plane
    with tetrahedral methyls, no H along the plane's normal: (names,
    charges, (12,3) positions, bonds as 0-based pairs with their types)."""
    import numpy as np

    def at(r, deg, origin=(0.0, 0.0)):
        a = np.deg2rad(deg)
        return np.array([origin[0] + r * np.cos(a),
                         origin[1] + r * np.sin(a), 0.0])

    c = np.zeros(3)
    o, ct1, n = at(1.23, 90), at(1.5, 210), at(1.345, -30)
    ct2, hn = at(1.43, 30, n[:2]), at(0.997, 270, n[:2])

    def methyl(ct, nb):
        u = (nb - ct) / np.linalg.norm(nb - ct)
        e1 = np.array([0.0, 0.0, 1.0])
        e2 = np.cross(u, e1)
        return [ct + 1.09 * (-u / 3.0 + (2.0 * np.sqrt(2.0) / 3.0)
                             * (np.cos(p) * e1 + np.sin(p) * e2))
                for p in np.deg2rad([90.0, 210.0, 330.0])]

    pos = [ct1, *methyl(ct1, c), c, o, n, hn, ct2, *methyl(ct2, n)]
    names = ["CT", "HA", "HA", "HA", "C", "O", "N", "HN", "CT", "HA", "HA",
             "HA"]
    q = [-0.27, 0.09, 0.09, 0.09, 0.51, -0.51, -0.47, 0.31, -0.11, 0.09,
         0.09, 0.09]
    bonds = [(0, 1, 1), (0, 2, 1), (0, 3, 1), (0, 4, 2), (4, 5, 3),
             (4, 6, 4), (6, 7, 5), (6, 8, 6), (8, 9, 1), (8, 10, 1),
             (8, 11, 1)]
    return names, q, np.array(pos), bonds


def flexible_script_case(directory, n_side=(4, 4, 5), seed=0,
                         fix=FLEX_NVT, cut=(8.0, 10.0), replicate=None,
                         pair=None, kspace="pppm 1e-4"):
    """Write a box of flexible solute molecules and TIP3P-like waters at
    0.96 g/cm^3 as `flex.data` (atom_style full; Velocities; Bonds,
    Angles, Dihedrals, Impropers; the Pair, Bond, Angle, Dihedral and
    Improper Coeffs sections, as data.peptide carries them) and the input
    `in.flex` (FLEX_SCRIPT: examples/peptide's styles, lj/charmm/coul/long
    with mix arithmetic, harmonic bonds, charmm angles with Urey-Bradley
    terms, charmm dihedrals (multiplicity 2 and 3, weights 1.0 and 0.5)
    with their 1-4 term, harmonic impropers, pppm 1e-4, special_bonds
    charmm, neighbor 2.0 bin, neigh_modify delay 5, timestep 2.0,
    thermo_style multi, a row every step, `fix 1 all <fix>` and FLEX_SHAKE
    on the X-H and water bonds and the water angle; `-var nstep` sets the
    steps).

    The box is n_side = (nx, ny, nz) blocks of 6.3 A, each block a 2x2x2
    lattice of 3.15 A sites: one N-methylacetamide (12 atoms, neutral)
    along a diagonal of its lower layer (the diagonal alternating from
    block to block) and four waters (TIP3P geometry and charges) in its
    upper layer, each molecule displaced by up to 0.1 A and each water
    turned at random, the best of 20 turns (numpy seed `seed`);
    velocities from a Maxwell distribution less the centre-of-mass
    motion, at 275 K over the dof the constraints leave.  cut: the
    charmm inner and outer cutoffs; replicate: (a, b, c) adds `replicate a
    b c` after read_data (bench/in.rhodo's replication); pair: a pair_style
    line's arguments in place of lj/charmm/coul/long; kspace: the
    kspace_style arguments, None for none.  Returns the paths (data,
    script)."""
    import numpy as np

    nx, ny, nz = ((n_side,) * 3 if isinstance(n_side, int) else n_side)
    rng = np.random.RandomState(seed)
    tid = {name: k + 1 for k, (name, _, _) in enumerate(FLEX_TYPES)}
    mass = {k + 1: m for k, (_, m, _) in enumerate(FLEX_TYPES)}
    atoms, bonds, mols = [], [], 0      # atoms: (mol, type, q, xyz)
    names_all = []
    s = 3.15
    nma_names, nma_q, nma_x, nma_bonds = _nma()
    # the molecule's long axis (CT to CT) along a diagonal of its layer
    axis = nma_x[8] - nma_x[0]
    base = np.arctan2(axis[1], axis[0])
    th = np.deg2rad(104.52)
    L = 2.0 * s * np.array([nx, ny, nz], float)
    blocks = [2.0 * s * np.array([bx, by, bz], float) for bz in range(nz)
              for by in range(ny) for bx in range(nx)]
    for kb, corner in enumerate(blocks):
        mols += 1
        bx, by, bz = np.rint(corner / (2.0 * s)).astype(int)
        ang = np.deg2rad(45.0 if (bx + by + bz) % 2 == 0 else 135.0) - base
        rot = np.array([[np.cos(ang), -np.sin(ang), 0.0],
                        [np.sin(ang), np.cos(ang), 0.0], [0.0, 0.0, 1.0]])
        xm = (nma_x - nma_x.mean(0)) @ rot.T + corner + np.array(
            [s, s, 0.5 * s]) + rng.uniform(-0.1, 0.1, 3)
        first = len(atoms)
        for nm, qq, xx in zip(nma_names, nma_q, xm):
            atoms.append((mols, tid[nm], qq, xx))
            names_all.append(nm)
        bonds += [(first + a, first + b, t) for a, b, t in nma_bonds]
    # each water the best of 20 random orientations: the one whose atoms
    # lie farthest from the atoms placed before it
    hw = 0.9572 * np.array([[0.0, 0.0, 0.0],
                            [np.cos(th / 2), np.sin(th / 2), 0.0],
                            [np.cos(th / 2), -np.sin(th / 2), 0.0]])
    for corner in blocks:
        for wx in range(2):
            for wy in range(2):
                mols += 1
                o = (corner + s * np.array([wx + 0.5, wy + 0.5, 1.5])
                     + rng.uniform(-0.1, 0.1, 3))
                placed = np.array([a[3] for a in atoms])
                best, best_d = None, -1.0
                for _ in range(20):
                    qv = rng.normal(size=4)
                    a_, b_, c_, d_ = qv / np.linalg.norm(qv)
                    r = np.array([
                        [a_*a_+b_*b_-c_*c_-d_*d_, 2*(b_*c_-a_*d_),
                         2*(b_*d_+a_*c_)],
                        [2*(b_*c_+a_*d_), a_*a_-b_*b_+c_*c_-d_*d_,
                         2*(c_*d_-a_*b_)],
                        [2*(b_*d_-a_*c_), 2*(c_*d_+a_*b_),
                         a_*a_-b_*b_-c_*c_+d_*d_]])
                    xw = o + hw @ r.T
                    dd = xw[:, None, :] - placed[None]
                    dd = dd - L * np.round(dd / L)
                    dmin = float(np.sqrt((dd * dd).sum(-1)).min())
                    if dmin > best_d:
                        best, best_d = xw, dmin
                first = len(atoms)
                atoms += [(mols, tid["OW"], -0.834, best[0]),
                          (mols, tid["HW"], 0.417, best[1]),
                          (mols, tid["HW"], 0.417, best[2])]
                names_all += ["OW", "HW", "HW"]
                bonds += [(first, first + 1, 7), (first, first + 2, 7)]
    n = len(atoms)
    nbr = [[] for _ in range(n)]
    for a, b, _ in bonds:
        nbr[a].append(b)
        nbr[b].append(a)
    angles = []
    for j in range(n):
        for ia, i in enumerate(nbr[j]):
            for k in nbr[j][ia + 1:]:
                ends = sorted((names_all[i], names_all[k]))
                key = (ends[0], names_all[j], ends[1])
                angles.append((list(FLEX_ANGLES).index(key) + 1, i, j, k))
    dihedrals = []
    for a, b, _ in bonds:
        key = tuple(sorted((names_all[a], names_all[b])))
        if key not in FLEX_DIHEDRALS:
            continue
        t = list(FLEX_DIHEDRALS).index(key) + 1
        for i in nbr[a]:
            for l_ in nbr[b]:
                if i != b and l_ != a and i != l_:
                    dihedrals.append((t, i, a, b, l_))
    impropers = []
    for j in range(n):
        if names_all[j] == "C":
            ct, o_, nn = (nbr[j][[names_all[k] for k in nbr[j]].index(x)]
                          for x in ("CT", "O", "N"))
            impropers.append((1, j, ct, nn, o_))
        elif names_all[j] == "N":
            c_, ct, hn = (nbr[j][[names_all[k] for k in nbr[j]].index(x)]
                          for x in ("C", "CT", "HN"))
            impropers.append((2, j, c_, ct, hn))
    # Maxwell velocities (real units: A/fs) less the COM motion, scaled
    # to 275 K over the dof left by the constraints of FLEX_SHAKE (7 a
    # solute, 3 a water)
    m = np.array([mass[t] for _, t, _, _ in atoms])
    mvv2e = 2390.0573615334906
    kt = 0.0019872067 * 275.0
    v = rng.normal(size=(n, 3)) * np.sqrt(kt / (m * mvv2e))[:, None]
    v = v - (m[:, None] * v).sum(0) / m.sum()
    dof = 3 * n - 3 - len(blocks) * (7 + 4 * 3)
    v = v * np.sqrt(dof * kt / (mvv2e * float((m[:, None] * v * v).sum())))

    def r(val):
        return repr(float(val))

    lines = ["LAMMPS data file: flexible solute in water", "",
             f"{n} atoms", f"{len(bonds)} bonds", f"{len(angles)} angles",
             f"{len(dihedrals)} dihedrals", f"{len(impropers)} impropers",
             f"{len(FLEX_TYPES)} atom types",
             f"{len(FLEX_BONDS)} bond types",
             f"{len(FLEX_ANGLES)} angle types",
             f"{len(FLEX_DIHEDRALS)} dihedral types",
             f"{len(FLEX_IMPROPERS)} improper types", ""]
    lines += [f"0.0 {r(L[k])} {a}lo {a}hi" for k, a in enumerate("xyz")]
    lines += ["", "Masses", ""] + [f"{t} {r(mm)}" for t, mm in mass.items()]
    lines += ["", "Pair Coeffs", ""] + [
        f"{k + 1} " + " ".join(r(c) for c in co)
        for k, (_, _, co) in enumerate(FLEX_TYPES)]
    lines += ["", "Bond Coeffs", ""] + [
        f"{k + 1} {r(kk)} {r(r0)}" for k, (kk, r0) in enumerate(FLEX_BONDS)]
    lines += ["", "Angle Coeffs", ""] + [
        f"{k + 1} " + " ".join(r(c) for c in co)
        for k, co in enumerate(FLEX_ANGLES.values())]
    lines += ["", "Dihedral Coeffs", ""] + [
        f"{k + 1} {r(kk)} {nn} {dd} {r(w)}"
        for k, (kk, nn, dd, w) in enumerate(FLEX_DIHEDRALS.values())]
    lines += ["", "Improper Coeffs", ""] + [
        f"{k + 1} {r(kk)} {r(c0)}"
        for k, (kk, c0) in enumerate(FLEX_IMPROPERS)]
    lines += ["", "Atoms # full", ""]
    lines += [f"{i + 1} {mo} {t} {r(qq)} {r(x[0])} {r(x[1])} {r(x[2])}"
              for i, (mo, t, qq, x) in enumerate(atoms)]
    lines += ["", "Velocities", ""]
    lines += [f"{i + 1} {r(v[i, 0])} {r(v[i, 1])} {r(v[i, 2])}"
              for i in range(n)]
    for title, rows in (("Bonds", [(t, a, b) for a, b, t in bonds]),
                        ("Angles", angles), ("Dihedrals", dihedrals),
                        ("Impropers", impropers)):
        lines += ["", title, ""]
        lines += [f"{k + 1} {row[0]} " + " ".join(str(a + 1)
                                                   for a in row[1:])
                  for k, row in enumerate(rows)]
    data = os.path.join(directory, "flex.data")
    script = os.path.join(directory, "in.flex")
    with open(data, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    with open(script, "w") as fh:
        fh.write(flexible_script(fix, cut=cut, replicate=replicate,
                                 pair=pair, kspace=kspace))
    return data, script


def flexible_script(fix=FLEX_NVT, cut=(8.0, 10.0), replicate=None,
                    pair=None, kspace="pppm 1e-4", shake=FLEX_SHAKE):
    """FLEX_SCRIPT with `fix 1 all <fix>` and `fix 2 all <shake>` (the
    arguments of flexible_script_case)."""
    inner, outer = cut
    return FLEX_SCRIPT.format(
        pair=pair or f"lj/charmm/coul/long {inner:g} {outer:g}",
        kspace=f"kspace_style {kspace}\n" if kspace else "",
        replicate=("replicate {} {} {}\n".format(*replicate)
                   if replicate else ""),
        fix=fix, shake=shake)


# the Nose-Hoover paths' edits of FLUID_SCRIPT (thermostat_script)
RIGID_NVT = "rigid/nvt molecule temp 300.0 350.0 50.0 tparam 50 1 3"
NVT = "nvt temp 300.0 300.0 50.0"


def thermostat_script(kind, n_side):
    """FLUID_SCRIPT with its `fix 1 all rigid/nve molecule` replaced, for
    the fluid of fluid_script_case(n_side):
      J: the SIFSIX example's form: `group moving molecule <= M` with M
         half the molecules, the others' velocities zeroed and no
         integrator on them, `fix 1 moving rigid/nvt ... tparam 50 1 3`,
         `compute movingtemp moving temp` and its c_movingtemp column;
      J-all: the same thermostat on all molecules, I's columns;
      K: `fix 1 all nvt temp 300.0 300.0 50.0`."""
    t = FLUID_SCRIPT
    fix = "fix 1 all rigid/nve molecule\n"
    if kind == "J":
        half = n_side ** 3 // 2
        t = t.replace(fix, (
            f"group moving molecule <= {half}\n"
            f"group frozen molecule > {half}\n"
            "velocity frozen set 0.0 0.0 0.0\n"
            f"fix 1 moving {RIGID_NVT}\n"
            "compute movingtemp moving temp\n"))
        return t.replace("temp press\n", "temp press c_movingtemp\n")
    return t.replace(fix, f"fix 1 all {RIGID_NVT if kind == 'J-all' else NVT}"
                     "\n")


def ragged_lj_case(device="cuda", seed=3):
    """A small float32 LJ input that stresses the cell kernels' edges: an
    uneven (3,4,5) grid of cap 16 in a box (8.8, 11.7, 14.6), one cell
    filled to cap, one cell empty (its atoms are masked out), 10% of the
    other atoms masked.  Returns dict(x, mask, box, pair, cfg, n), tensors
    on `device`; not a physical state."""
    import numpy as np
    import torch

    from lidp_tpu_torch import resolve_device
    from lidp_tpu_torch.box import Box
    from lidp_tpu_torch.ops.cells import CellConfig
    from lidp_tpu_torch.ops.pair import make_pair_params

    device = resolve_device(device)
    rs = np.random.RandomState(seed)
    L = np.array([8.8, 11.7, 14.6])
    nb = (3, 4, 5)
    h = L / np.array(nb)
    g = np.stack(np.meshgrid(np.arange(6), np.arange(8), np.arange(10),
                             indexing="ij"), -1).reshape(-1, 3)
    x = (g + 0.5 + rs.uniform(-0.12, 0.12, g.shape)) * (L / [6, 8, 10])
    cell = np.floor(x / h).astype(int)
    full = np.all(cell == (0, 0, 0), axis=1)
    empty = np.all(cell == (1, 2, 3), axis=1)
    x = x[~full]
    mask = ~empty[~full] & (rs.rand(x.shape[0]) > 0.1)
    # 16 atoms about 1.02 apart fill cell (0,0,0)
    m = np.stack(np.meshgrid(np.arange(3), np.arange(3), np.arange(2),
                             indexing="ij"), -1).reshape(-1, 3)[:16]
    x = np.concatenate([x, 0.4 + 1.02 * m
                        + rs.uniform(-0.03, 0.03, m.shape)])
    mask = np.concatenate([mask, np.ones(16, bool)])
    one = np.zeros((2, 2))
    one[1, 1] = 1.0
    f32 = torch.float32
    return dict(
        x=torch.as_tensor(x, dtype=f32, device=device),
        mask=torch.as_tensor(mask, device=device),
        box=Box.create(np.zeros(3), L, dtype=f32, device=device),
        pair=make_pair_params(one, one, 2.5 * one, coul=False, dtype=f32,
                              device=device),
        cfg=CellConfig(nbins=nb, cap=16, cutneigh=2.8), n=x.shape[0])


def full_lj_case(device="cuda", seed=4):
    """A float32 LJ input whose every slot holds an atom: a (3,4,5) grid of
    cap 8, each cell of side 2.9 holding a jittered 2x2x2 block of atoms
    (nearest pairs about 1.2 apart), none masked.  Returns the dict of
    ragged_lj_case."""
    import numpy as np
    import torch

    from lidp_tpu_torch import resolve_device
    from lidp_tpu_torch.box import Box
    from lidp_tpu_torch.ops.cells import CellConfig
    from lidp_tpu_torch.ops.pair import make_pair_params

    device = resolve_device(device)
    rs = np.random.RandomState(seed)
    nb, h = (3, 4, 5), 2.9
    cell = np.stack(np.meshgrid(*[np.arange(k) for k in nb],
                                indexing="ij"), -1).reshape(-1, 1, 3)
    sub = np.stack(np.meshgrid(*[np.arange(2)] * 3, indexing="ij"),
                   -1).reshape(1, 8, 3)
    x = (cell + 0.25 + 0.5 * sub
         + rs.uniform(-0.07, 0.07, (cell.shape[0], 8, 3))) * h
    x = x.reshape(-1, 3)[rs.permutation(8 * cell.shape[0])]
    one = np.zeros((2, 2))
    one[1, 1] = 1.0
    f32 = torch.float32
    return dict(
        x=torch.as_tensor(x, dtype=f32, device=device),
        mask=torch.ones(x.shape[0], dtype=torch.bool, device=device),
        box=Box.create(np.zeros(3), h * np.array(nb), dtype=f32,
                       device=device),
        pair=make_pair_params(one, one, 2.5 * one, coul=False, dtype=f32,
                              device=device),
        cfg=CellConfig(nbins=nb, cap=8, cutneigh=2.8), n=x.shape[0])


def overflow_lj_case(device="cuda", seed=3):
    """ragged_lj_case on a grid of cap 12: the full cell's 16 atoms
    overflow it, so 4 of them find no slot and share the cell's last slot
    with the atom that holds it (build_cells).  Returns the dict of
    ragged_lj_case."""
    c = ragged_lj_case(device, seed)
    c["cfg"] = dataclasses.replace(c["cfg"], cap=12)
    return c


def overflow_lj_parity():
    """cell_pair_forces_lj on overflow_lj_case's grid against its plain
    version, need_ev off and on, at lj_compare's bars, repeats
    bit-identical: an atom that found no slot takes the force of the slot
    it shares, as in the plain version and the JAX function.  Prints how
    far a kernel that gave those atoms zero force (this kernel before the
    repair, ROADMAP queue 3) would miss: the largest plain force on them.
    Returns that and the kernel's error."""
    import torch

    from lidp_tpu_torch.ops import cell_kernels as ck
    from lidp_tpu_torch.ops.cells import build_cells

    c = overflow_lj_case()
    x, mask, box, pair = c["x"], c["mask"], c["box"], c["pair"]
    cells = build_cells(x, mask, box, c["cfg"])
    if not bool(cells.overflow):
        raise AssertionError("the overflow case does not overflow")
    aos = cells.atom_of_slot.reshape(-1).long()
    soa = cells.slot_of_atom.long().clamp(max=aos.numel() - 1)
    n = x.shape[0]
    noslot = mask & (aos[soa] != torch.arange(n, device=x.device))
    worst = 0.0
    for need_ev in (False, True):
        label = f"cell_pair_forces_lj[overflow, need_ev={need_ev}]"
        got = ck.cell_pair_forces_lj(x, mask, cells, box, pair,
                                     need_ev=need_ev)
        ref = ck.cell_pair_forces_lj_plain(x, mask, cells, box, pair,
                                           need_ev=need_ev)
        torch.cuda.synchronize()
        err, scale = lj_compare(label, (got[0], got[1], got[3]),
                                (ref[0], ref[1], ref[3]), need_ev)
        again = ck.cell_pair_forces_lj(x, mask, cells, box, pair,
                                       need_ev=need_ev)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{label}: a repeated launch differs")
        missed = float(ref[0][noslot].abs().max())
        if not (int(noslot.sum()) > 0 and missed > 0):
            raise AssertionError(f"{label}: no atom without a slot takes a "
                                 f"force")
        worst = max(worst, err)
        print(f"parity {label} ok on grid {tuple(cells.atom_of_slot.shape)}"
              f": max abs err {err:.3e} of max |f| {scale:.3e}, repeats "
              f"bit-identical; {int(noslot.sum())} atoms without a slot, "
              f"whose plain force a kernel giving them zero would miss by "
              f"up to {missed:.3e}")
    return worst, missed


def scatter_slots(cells, seed=5):
    """The same Cells with each cell's slots in a random order (one seeded
    permutation per cell), so that its live slots are no prefix of it."""
    import torch

    aos = cells.atom_of_slot
    g = torch.Generator(device="cpu").manual_seed(seed)
    perm = torch.argsort(torch.rand(aos.shape, generator=g),
                         dim=-1).to(aos.device)
    aos2 = torch.gather(aos, -1, perm).contiguous()
    flat = aos2.reshape(-1).long()
    n = cells.slot_of_atom.shape[0]
    live = flat < n
    soa = cells.slot_of_atom.clone()
    soa[flat[live]] = torch.arange(flat.numel(), device=aos.device)[
        live].to(soa.dtype)
    return dataclasses.replace(cells, atom_of_slot=aos2, slot_of_atom=soa)


def dense_lj_case(cap, device="cuda", seed=6):
    """A float32 LJ input on a (3,3,3) grid of cap `cap`: each cell of side
    2.9 holds a jittered m x m x m block of atoms, m^3 <= cap the largest
    cube (cap 522: 512 atoms a cell), sigma set so that nearest neighbours
    sit near the potential's minimum and the cutoff of 2.5 takes in ~900
    neighbours.  For the kernels' caps near their shared-memory limits.
    Returns the dict of ragged_lj_case."""
    import numpy as np
    import torch

    from lidp_tpu_torch import resolve_device
    from lidp_tpu_torch.box import Box
    from lidp_tpu_torch.ops.cells import CellConfig
    from lidp_tpu_torch.ops.pair import make_pair_params

    device = resolve_device(device)
    rs = np.random.RandomState(seed)
    m = int(round(cap ** (1 / 3)))
    m -= m ** 3 > cap
    nb, h = (3, 3, 3), 2.9
    cell = np.stack(np.meshgrid(*[np.arange(k) for k in nb],
                                indexing="ij"), -1).reshape(-1, 1, 3)
    sub = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"),
                   -1).reshape(1, -1, 3)
    x = (cell + (sub + 0.5 + rs.uniform(-0.05, 0.05,
                                        (cell.shape[0], m ** 3, 3))) / m) * h
    x = x.reshape(-1, 3)[rs.permutation(cell.shape[0] * m ** 3)]
    one = np.zeros((2, 2))
    one[1, 1] = 1.0
    f32 = torch.float32
    return dict(
        x=torch.as_tensor(x, dtype=f32, device=device),
        mask=torch.ones(x.shape[0], dtype=torch.bool, device=device),
        box=Box.create(np.zeros(3), h * np.array(nb), dtype=f32,
                       device=device),
        pair=make_pair_params(one, h / m / 1.12 * one, 2.5 * one, coul=False,
                              dtype=f32, device=device),
        cfg=CellConfig(nbins=nb, cap=cap, cutneigh=2.8), n=x.shape[0])


def tile_caps(name, device="cuda"):
    """(largest cap of the wide tile, largest of the narrow one) of LJ
    kernel `name` on this device, as its launcher chooses the tile
    (ops/cell_kernels.kernel_tile)."""
    import torch

    from lidp_tpu_torch.ops import cell_kernels as ck

    idx = torch.device(device).index or 0

    def last(tile):
        lo, hi = 1, 4096             # kernel_tile(lo) <= tile < (hi)
        while hi - lo > 1:
            mid = (lo + hi) // 2
            t = ck.kernel_tile(name, (3, 3, 3, mid), idx)[0]
            if t != 0 and t <= tile:
                lo = mid
            else:
                hi = mid
        return lo

    return last(1), last(2)


def slot_state(x, cells, box, pair):
    """The (nbx,nby,nbz,cap,3) float32 slot coordinates of x on `cells`,
    empty slots holding the sentinels, as SlotRunner._slotify slots them:
    for Cells that build_cells did not make (scatter_slots)."""
    import torch

    from lidp_tpu_torch.ops import cell_kernels as ck

    aos = cells.atom_of_slot
    n = x.shape[0]
    valid = aos < n
    amax = torch.clamp(aos, max=n - 1).long()
    sent = ck.slot_sentinels(box, pair, aos.shape)
    zero = torch.zeros_like(sent)
    return torch.where(valid[..., None], x.to(torch.float32)[amax],
                       torch.stack([sent, zero, zero], dim=-1))


def lj_kernel_calls(x, mask, box, pair, cfg, natoms, scatter=False):
    """{kernel name: (slot state, live slots, call(need_ev) of the wrapper,
    of the plain version, timed(need_ev))}, each call returning (f, evdwl,
    virial6): slot_lj_forces on SlotRunner's slot state of (x, mask),
    cell_pair_forces_lj on their Cells; with `scatter` each cell's slots
    in a random order (scatter_slots, slotted by slot_state).  `timed` is
    the call the runners make, with the kernel's scalars formed beforehand
    (`par=`), as SlotRunner does at setup; cell_pair_forces_lj forms its
    own once for each box (its wrapper's memo)."""
    import torch

    from lidp_tpu_torch.forcefield import ForceField
    from lidp_tpu_torch.integrate.slot_runner import SlotRunner
    from lidp_tpu_torch.ops import cell_kernels as ck
    from lidp_tpu_torch.ops.cells import build_cells

    cells = build_cells(x, mask, box, cfg)
    if bool(cells.overflow):
        raise AssertionError("the parity case overflows its cell grid")
    if scatter:
        cells = scatter_slots(cells)
        xs = slot_state(x, cells, box, pair)
    else:
        sr = SlotRunner(ff=ForceField(pair=pair), neighbor_cfg=cfg,
                        dt=0.005, ftm2v=1.0, n=natoms)
        n = x.shape[0]
        xs = sr._slotify(x, torch.zeros_like(x),
                         torch.ones(n, device=x.device),
                         torch.arange(n, dtype=torch.int32, device=x.device),
                         mask, box)[0]
    live = cells.atom_of_slot < x.shape[0]
    grids = [xs[..., d] for d in range(3)]

    def slot(fn, **kw):
        def call(need_ev):
            fg, ev, vir = fn(grids, box, pair, need_ev=need_ev, **kw)
            return torch.stack(list(fg), dim=-1), ev, vir
        return call

    def atom(fn, **kw):
        def call(need_ev):
            f, ev, _, vir = fn(x, mask, cells, box, pair, need_ev=need_ev,
                               **kw)
            return f, ev, vir
        return call

    par_s = ck.lj_par(box, pair, ck.sentinel_scalars(box, pair)[0])
    return {
        "slot_lj_forces": (
            xs, live, slot(ck.slot_lj_forces), slot(ck.slot_lj_forces_plain),
            slot(ck.slot_lj_forces, par=par_s)),
        "cell_pair_forces_lj": (
            xs, live, atom(ck.cell_pair_forces_lj),
            atom(ck.cell_pair_forces_lj_plain),
            atom(ck.cell_pair_forces_lj))}


def melt_row(tag, row):
    vals = [row[k] for k in ("temp", "pe", "etotal", "press")]
    if not all(math.isfinite(v) for v in vals):
        raise AssertionError(f"{tag}: non-finite thermo row {row}")
    print(f"{tag}: step {row['step']} temp {vals[0]:.7f} pe {vals[1]:.7f} "
          f"etotal {vals[2]:.7f} press {vals[3]:.7f}")


def check_rel(tag, got, want, rel):
    print(f"{tag}: {got:.9g} against {want:.9g} (rel "
          f"{abs(got - want) / abs(want):.2e}, bar {rel:g})")
    if not abs(got - want) <= rel * abs(want):
        raise AssertionError(f"{tag}: {got!r} is not within {rel:g} of "
                             f"{want!r}")


def dense_paths(launches, reset_counts, read_counts):
    """Paths I, I-CLI and I-cap: the dense route on the card (module
    docstring).  Each sets launches[path] to its counters, all 0.  Returns
    path I's rows."""
    import torch

    # path I: the dense route (the reference examples' sizes) from a LAMMPS
    # script on the card, without LIDP_FAST_POLAR: plain torch, no kernel
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        _, in_fluid = fluid_script_case(work, n_side=I_SIDE)
        nI = I_SIDE ** 3 * 3
        reset_counts()
        scriptI, logI, _, peakI = dense_run(in_fluid, I_STEPS)
        launches["I"] = read_counts()
        check_counts("I", launches["I"], {})
        check_dense_runner("I", scriptI, nI)
        rowsI = scriptI.thermo_rows
        check_rows_finite("I", rowsI)
        print(f"path I: {in_fluid} ({nI} atoms) through LammpsScript, "
              f"float64, precision 1e-11, {I_STEPS} steps on the dense "
              f"route; its log:")
        for line in logI:
            print(f"  I| {line}")
        steps_per_s_I = I_STEPS / loop_seconds(logI, I_STEPS)
        print(f"steps_per_s_I {steps_per_s_I:.4f} (Loop time); peak device "
              f"memory {peakI / 2**20:.1f} MiB "
              f"(torch.cuda.max_memory_allocated)")
        # the phases, on 2 more steps of the same run (not counted)
        sim = scriptI._sim
        with HostReads() as reads, IntegratorTimer(reads) as integ, \
                DensePhases() as ph:
            sim.runner.run(sim.sys, sim.res, None, sim.istate, 2)
            ims, ihost, ireads, _ = integ.per_step(2)
        print(phase_line("path I", ph.ms(2), ph.iterations(), "a step"))
        print(f"path I integrator (rigid/nve) over the same 2 steps: "
              f"{ims:.4f} ms a step by CUDA events ({ihost:.4f} ms of host "
              f"clock), its host reads a step {ireads:g}; host reads a "
              f"step in all {reads.count() / 2:g}")
        del scriptI, sim
        # the same script on the panel engine (path H's route), same card
        scriptP, _, _, _ = dense_run(in_fluid, I_STEPS, fast_polar="1")
        if type(scriptP._sim.runner).__name__ != "FastPolarRunner":
            raise AssertionError("path I: LIDP_FAST_POLAR=1 did not take "
                                 "the panel engine")
        worst = rows_agree("I", rowsI, scriptP.thermo_rows,
                           [1e-9] * len(rowsI))
        print(f"path I rows vs the panel engine's over {len(rowsI)} rows: "
              f"thermo columns at {worst:.3g} of their bar (rel 1e-9 of "
              f"max(1, |value|))")
        del scriptP
        torch.cuda.empty_cache()

        # path I-CLI: the CLI as a user runs it, in a process of its own
        cmd = [sys.executable, "-m", "lidp_tpu_torch", "-in", "in.fluid",
               "-log", "log.i", "-var", "nstep", str(I_STEPS)]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            filter(None, (ROOT, os.environ.get("PYTHONPATH")))))
        env.pop("LIDP_FAST_POLAR", None)
        t0 = time.perf_counter()
        res = subprocess.run(cmd, cwd=work, env=env, capture_output=True,
                             text=True, timeout=600)
        t_cli = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"path I-CLI: exit {res.returncode}\n"
                                 f"{res.stdout[-4000:]}\n{res.stderr[-4000:]}")
        with open(os.path.join(work, "log.i")) as fh:
            logC = fh.read().splitlines()
        rowsC = log_rows(logC)
        if len(rowsC) != len(rowsI) or any(
                float(f"{r[c]:.8g}") != g[c]
                for r, g in zip(rowsI, rowsC) for c in G64_COLS):
            raise AssertionError("path I-CLI: its rows differ from path "
                                 "I's at the printed precision")
        print(f"path I-CLI: `{' '.join(cmd[1:])}` exit 0 in {t_cli:.1f} s; "
              f"its {len(rowsC)} rows equal path I's at the printed "
              f"precision; " + next(line for line in logC
                                    if line.startswith("Performance:")))
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # path I-cap: the dense route just under the cap
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        _, in_fluid = fluid_script_case(work, n_side=ICAP_SIDE)
        nC = ICAP_SIDE ** 3 * 3
        reset_counts()
        with DensePhases() as ph:
            scriptC, logCap, _, peakC = dense_run(in_fluid, ICAP_STEPS)
        launches["I-cap"] = read_counts()
        check_counts("I-cap", launches["I-cap"], {})
        check_dense_runner("I-cap", scriptC, nC)
        check_rows_finite("I-cap", scriptC.thermo_rows)
        if not ph.all_converged():
            raise AssertionError(f"path I-cap: a solve did not converge "
                                 f"({ph.iterations()} iterations)")
        nev = len(ph.solves)
        print(f"path I-cap: {nC} atoms, float64, precision 1e-11, setup + "
              f"{ICAP_STEPS} steps on the dense route, rows finite, every "
              f"solve converged ({nev} evaluations)")
        for line in logCap:
            print(f"  I-cap| {line}")
        print(f"steps_per_s_I_cap "
              f"{ICAP_STEPS / loop_seconds(logCap, ICAP_STEPS):.4f} (Loop "
              f"time, setup included); peak device memory "
              f"{peakC / 2**20:.1f} MiB (torch.cuda.max_memory_allocated)")
        print(phase_line("path I-cap", ph.ms(nev), ph.iterations(),
                         "an evaluation"))
        del scriptC
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return rowsI


def script_peak(tag, log, steps, peak):
    """A path's steps/s by its Loop time line and its peak memory."""
    rate = steps / loop_seconds(log, steps)
    print(f"steps_per_s_{tag.replace('-', '_')} {rate:.4f} (Loop time); "
          f"peak device memory {peak / 2**20:.1f} MiB "
          f"(torch.cuda.max_memory_allocated); {smi_line()}")
    return rate


def script_route(script):
    """The route a script's Simulation takes: the dense route, or the
    cell grid with its pair route."""
    from lidp_tpu_torch.forcefield import pair_route

    sim = script._sim
    cfg = sim.runner.neighbor_cfg
    if cfg is None:
        return "dense route (Runner, nlist None)"
    return (f"cell grid {cfg.nbins} x cap {cfg.cap} (cutneigh "
            f"{cfg.cutneigh:g}, rebuild every {sim.runner.rebuild_every}, "
            f"check {sim.runner.check}), pair route "
            f"{pair_route(sim.sys, sim.runner.ff, sim.nlist.nlist)}")


def cells_step0_vs_dense(path, script, n):
    """Step 0 of a script on the cell grid (its Simulation set up) against
    dense_forces on the same state and force field, the special codes
    built directly in place of the special lists: f, virial and energies
    within rel 1e-9 of max(1, |value|) plus CANCEL_REL of the magnitude
    the correction cancels."""
    import torch

    from lidp_tpu_torch import topology
    from lidp_tpu_torch.forcefield import dense_forces
    from lidp_tpu_torch.ops.bonded import special_correction_sparse

    sim = script._sim
    ff_d = dataclasses.replace(
        sim.runner.ff, sp_idx=None, sp_lvl=None,
        sp_code=torch.as_tensor(topology.special_codes_dense(
            n, script._bonds), device=sim.sys.x.device))
    ref = dense_forces(sim.sys, ff_d)
    cancel = cancelled(sim)
    res = sim.res
    worst = 0.0
    for k in ("evdwl", "ecoul", "elong"):
        a, b = float(getattr(res, k)), float(getattr(ref, k))
        bar = 1e-9 * max(1.0, abs(b)) + CANCEL_REL * cancel.get(k, 0.0)
        worst = max(worst, abs(a - b) / bar)
        if not abs(a - b) <= bar:
            raise AssertionError(f"path {path} step 0 {k}: {a!r}, dense "
                                 f"{b!r}")
    s_ = sim.sys
    fc, _, _, dvir = special_correction_sparse(
        s_.x, s_.q, s_.type, sim.runner.ff.sp_idx, sim.runner.ff.sp_lvl,
        s_.mask, s_.box, sim.runner.ff.pair)
    for k, a, b, c in (("f", res.f, ref.f, fc.abs().max()),
                       ("virial", res.virial, ref.virial,
                        dvir.abs().max())):
        bar = 1e-9 * b.abs().clamp(min=1.0) + CANCEL_REL * float(c)
        ratio = float(((a - b).abs() / bar).max())
        worst = max(worst, ratio)
        if not ratio <= 1.0:
            raise AssertionError(f"path {path} step 0 {k} vs dense_forces: "
                                 f"{ratio:.3g} of the bar")
    print(f"path {path} step 0 vs dense_forces with special_codes_dense: f, "
          f"virial and energies at {worst:.3g} of their bar (rel 1e-9 of "
          f"max(1, |value|) + {CANCEL_REL:g} of the magnitude the "
          f"correction cancels: E_vdwl {cancel['evdwl']:.4g}, max |f| "
          f"{float(fc.abs().max()):.4g})")


def script_cell_paths(launches, reset_counts, read_counts, steps_per_s_F):
    """Paths L, L64, M, N and N-pol: the atomic inputs and the cell grid
    from a LAMMPS script (module docstring).  Each sets launches[path]."""
    import torch

    from lidp_tpu_torch.__main__ import main as cli
    from lidp_tpu_torch.io.script import LammpsScript

    route = script_route

    def fresh():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def check_row(tag, row, bars, absolute=False):
        for k, (want, bar) in bars.items():
            got = row[k]
            err = abs(got - want) if absolute else abs(got - want) / abs(want)
            print(f"{tag} {k}: {got!r} against {want!r} ("
                  f"{'abs' if absolute else 'rel'} {err:.2e}, bar {bar:g})")
            if not err <= bar:
                raise AssertionError(f"{tag} {k}: {got!r} against {want!r}")

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        # path L: bench/in.lj as published (32,000 atoms) through the CLI's
        # main() in this process, float32, so its launches are counted
        in_lj = os.path.join(work, "in.lj")
        with open(in_lj, "w") as fh:
            fh.write(LJ_SCRIPT)
        log_l = os.path.join(work, "log.lj")
        fresh()
        reset_counts()
        cli(["-in", in_lj, "-log", log_l, "--f32"])
        launches["L"] = read_counts()
        peak = torch.cuda.max_memory_allocated()
        with open(log_l) as fh:
            logL = fh.read().splitlines()
        rows = log_rows(logL)
        print(f"path L: `python -m lidp_tpu_torch -in in.lj --f32` (bench/"
              f"in.lj verbatim), {len(rows)} rows:")
        for line in logL:
            print(f"  L| {line}")
        if [int(r["step"]) for r in rows] != [0, 100]:
            raise AssertionError(f"path L: rows {rows}")
        rows[0]["pe"] = rows[0]["epair"]
        check_row("path L step 0", rows[0], LJ_LOG0)
        check_rel("path L step 100 etotal vs the reference log",
                  rows[1]["etotal"], *LJ_LOG100_ETOTAL)
        if not (launches["L"]["cell_pair_forces_lj"] > 0
                and launches["L"]["slot_lj_forces"] == 0):
            raise AssertionError(f"path L launches {launches['L']}")
        print(f"path L launches: {launches['L']}")
        rate_L = script_peak("L", logL, 100, peak)
        print(f"path L {next(x for x in logL if x.startswith('Performance'))}"
              f" beside path F's {steps_per_s_F:.4f} steps/s (lj_melt.build,"
              f" Runner on cells, this call): {rate_L / steps_per_s_F:.3f} "
              f"of F's rate by the Loop time line, setup included")

        # path L64: the same input in float64, in process
        logs = []
        fresh()
        reset_counts()
        script = LammpsScript(dtype=torch.float64, log=logs.append)
        script.file(in_lj)
        launches["L64"] = read_counts()
        peak = torch.cuda.max_memory_allocated()
        print(f"path L64: bench/in.lj, float64, LammpsScript: {route(script)}")
        if "pair route cell_pair_forces," not in route(script) + ",":
            raise AssertionError(f"path L64: {route(script)}")
        check_counts("L64", launches["L64"], {})
        rows = script.thermo_rows
        for r in rows:
            melt_row(f"L64 step {r['step']}", r)
        check_row("path L64 step 0", rows[0], LJ64_LOG0)
        check_row("path L64 step 100", rows[-1], LJ64_LOG100)
        if bool(script._sim.nlist.overflow):
            raise AssertionError("path L64: a cell overflowed")
        script_peak("L64", logs, 100, peak)
        del script

        # path M: examples/melt (4,000 atoms, the dense route), float64,
        # run 100, its dump atom into this directory
        in_melt = os.path.join(work, "in.melt")
        with open(in_melt, "w") as fh:
            fh.write(MELT_SCRIPT.replace("run\t\t250", f"run {M_STEPS}"))
        logs = []
        fresh()
        reset_counts()
        script = LammpsScript(dtype=torch.float64, log=logs.append)
        script.file(in_melt)
        launches["M"] = read_counts()
        peak = torch.cuda.max_memory_allocated()
        print(f"path M: examples/melt/in.melt (run {M_STEPS}), float64: "
              f"{route(script)}")
        check_counts("M", launches["M"], {})
        nM = script._sim.natoms
        check_dense_runner("M", script, 4000)
        rows = {int(r["step"]): r for r in script.thermo_rows}
        for step, (t, ep, et, p) in MELT_GOLD.items():
            r = rows[step]
            melt_row(f"M step {step}", r)
            if step == 0:
                check_row("path M step 0", r, {
                    k: (v, MELT_BAR0[k]) for k, v in zip(
                        ("temp", "epair", "etotal", "press"),
                        (t, ep, et, p))}, absolute=True)
            else:
                bar = MELT_BARS[step]
                check_row(f"path M step {step}", r, dict(
                    epair=(ep, bar), etotal=(et, bar)))
        with open(os.path.join(work, "dump.melt")) as fh:
            dump = fh.read()
        frames = dump.count("ITEM: TIMESTEP")
        if frames != M_STEPS // 50 + 1 or "ITEM: ATOMS id type xs ys zs" \
                not in dump or dump.count("\n") != frames * (9 + nM):
            raise AssertionError(f"path M: dump.melt has {frames} frames")
        print(f"path M: dump.melt {frames} frames of {nM} atoms (id type xs "
              f"ys zs)")
        script_peak("M", logs, M_STEPS, peak)
        del script
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # path N: the point-charge fluid above the cap, on the cell grid
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        fluid_script_case(work, n_side=N_SIDE)
        n = N_SIDE ** 3 * 3
        text = point_charge_script()
        with open(os.path.join(work, "in.pc2"), "w") as fh:
            fh.write(text)
        with open(os.path.join(work, "in.pc"), "w") as fh:
            fh.write(text.replace("read_data fluid.data\n",
                                  "read_data fluid.data\nneighbor "
                                  f"{CELL_SKIN} bin\n"))
        # at the default skin the grid overfills: the run aborts
        script = LammpsScript(dtype=torch.float64, log=lambda line: None)
        script.variables["nstep"] = "1"
        try:
            script.file(os.path.join(work, "in.pc2"))
        except RuntimeError as e:
            cfg = script._sim.runner.neighbor_cfg
            print(f"path N at the default skin 2.0: grid {cfg.nbins} x cap "
                  f"{cfg.cap}, the run aborts: {e}")
        else:
            raise AssertionError("path N: the overfilled grid did not abort")
        del script
        logs = []
        fresh()
        reset_counts()
        script = LammpsScript(dtype=torch.float64, log=logs.append)
        script.variables["nstep"] = "0"
        script.file(os.path.join(work, "in.pc"))
        sim = script._sim
        print(f"path N: the point-charge fluid ({n} atoms, lj/cut/coul/long "
              f"6.0 6.5, ewald/disp 1e-4, rigid/nve, neighbor {CELL_SKIN}), "
              f"float64: {route(script)}")
        if sim.runner.neighbor_cfg is None or sim.runner.ff.sp_idx is None:
            raise AssertionError("path N: not on the cell grid")
        cells_step0_vs_dense("N", script, n)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        script.execute([f"run {N_STEPS}"])
        launches["N"] = read_counts()
        peak = torch.cuda.max_memory_allocated()
        check_counts("N", launches["N"], {})
        rows = script.thermo_rows
        check_rows_finite("N", rows)
        if bool(script._sim.nlist.overflow):
            raise AssertionError("path N: a cell overflowed")
        for line in logs:
            print(f"  N| {line}")
        script_peak("N", logs, N_STEPS, peak)
        del script, sim
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # path N-pol: the polar fluid on the cell grid with the dense polar
    # term (LIDP_FAST_POLAR=0) against the panel engine on the same input
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        fluid_script_case(work, n_side=NPOL_SIDE)
        n = NPOL_SIDE ** 3 * 3
        in_npol = os.path.join(work, "in.npol")
        with open(in_npol, "w") as fh:
            fh.write(FLUID_SCRIPT.replace(
                "read_data fluid.data\n",
                f"read_data fluid.data\nneighbor {CELL_SKIN} bin\n"))
        reset_counts()
        scriptC, logC, _, peak = dense_run(in_npol, NPOL_STEPS,
                                           fast_polar="0")
        launches["N-pol"] = read_counts()
        check_counts("N-pol", launches["N-pol"], {})
        print(f"path N-pol: the polar fluid ({n} atoms, LIDP_FAST_POLAR=0, "
              f"neighbor {CELL_SKIN}), float64, precision 1e-11: "
              f"{route(scriptC)}; its log:")
        if scriptC._sim.runner.neighbor_cfg is None or \
                scriptC._sim.runner.ff.polar is None:
            raise AssertionError("path N-pol: not on the cell grid")
        for line in logC:
            print(f"  N-pol| {line}")
        script_peak("N-pol", logC, NPOL_STEPS, peak)
        cancel = cancelled(scriptC._sim)
        rowsC = scriptC.thermo_rows
        del scriptC
        scriptP, _, _, _ = dense_run(in_npol, NPOL_STEPS, fast_polar="1")
        if type(scriptP._sim.runner).__name__ != "FastPolarRunner":
            raise AssertionError("path N-pol: LIDP_FAST_POLAR=1 did not take "
                                 "the panel engine")
        worst = rows_agree("N-pol", rowsC, scriptP.thermo_rows,
                           [1e-9] * len(rowsC), cancel=cancel)
        print(f"path N-pol rows vs the panel engine's over {len(rowsC)} "
              f"rows: thermo columns at {worst:.3g} of their bar (rel 1e-9 "
              f"of max(1, |value|) + {CANCEL_REL:g} of the magnitude the "
              f"correction cancels)")
        del scriptP
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)


class HostReads:
    """Within `with HostReads():` every synchronizing CUDA operation (a
    read of a device value to the host: .item(), .tolist(), a copy to the
    CPU) is recorded through torch.cuda.set_sync_debug_mode("warn");
    `count` is the number so far."""

    def __enter__(self):
        import warnings

        import torch

        self._catch = warnings.catch_warnings(record=True)
        self._log = self._catch.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def count(self):
        return sum("synchroniz" in str(w.message) for w in self._log)

    def __exit__(self, *exc):
        import torch

        torch.cuda.set_sync_debug_mode("default")
        self._catch.__exit__(*exc)
        return False


# the integrators' halves timed by IntegratorTimer, and the chain updates
# they call (host arithmetic, timed by the host clock)
INTEGRATOR_HALVES = (("rigid", "initial_integrate"),
                     ("rigid", "final_integrate"),
                     ("nvt", "initial_integrate"),
                     ("nvt", "final_integrate"),
                     ("npt", "initial_integrate"),
                     ("npt", "final_integrate"))
CHAIN_UPDATES = (("rigid", "_nhc_integrate"), ("rigid", "_nhc_press_rigid"),
                 ("nvt", "_nhc"))


class IntegratorTimer:
    """Within `with IntegratorTimer(reads):` every call of the
    integrators' halves (INTEGRATOR_HALVES, the module functions the
    driver's integrators call) is timed by CUDA events (the device
    timeline from before the call's first launch to after its last, the
    host's chain arithmetic and its waits on a read included) and by the
    host clock, and the host reads inside it counted by `reads` (a live
    HostReads); each chain update (CHAIN_UPDATES) is timed by the host
    clock; the functions are restored on exit."""

    def __init__(self, reads):
        self.reads = reads

    def __enter__(self):
        import importlib

        import torch

        self.calls, self.chain, self._saved = [], [], []

        def timed(fn):
            def wrapped(*a, **kw):
                e0, e1 = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                n0 = self.reads.count()
                t0 = time.perf_counter()
                e0.record()
                out = fn(*a, **kw)
                e1.record()
                self.calls.append((e0, e1, time.perf_counter() - t0,
                                   self.reads.count() - n0))
                return out
            return wrapped

        def host_timed(fn):
            def wrapped(*a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                self.chain.append(time.perf_counter() - t0)
                return out
            return wrapped

        for names, wrap in ((INTEGRATOR_HALVES, timed),
                            (CHAIN_UPDATES, host_timed)):
            for mod, name in names:
                m = importlib.import_module(
                    f"lidp_tpu_torch.integrate.{mod}")
                self._saved.append((m, name, getattr(m, name)))
                setattr(m, name, wrap(getattr(m, name)))
        return self

    def __exit__(self, *exc):
        for m, name, fn in self._saved:
            setattr(m, name, fn)
        return False

    def per_step(self, nsteps):
        """(device-timeline ms, host ms, host reads, the chain updates'
        host ms) a step."""
        import torch

        torch.cuda.synchronize()
        ms = sum(e0.elapsed_time(e1) for e0, e1, _, _ in self.calls)
        host = sum(h for _, _, h, _ in self.calls)
        reads = sum(r for _, _, _, r in self.calls)
        return (ms / nsteps, 1e3 * host / nsteps, reads / nsteps,
                1e3 * sum(self.chain) / nsteps)


# the CPU twin: the same script through the port on the CPU in float64, in
# a process of its own on TWIN_THREADS torch threads (one but for T's, so
# that run_twins packs the host's cores; small tensors gain little from
# more), its rows and final state saved
CPU_TWIN = """\
import os, sys, time
import numpy as np
import torch
torch.set_num_threads(int(os.environ["TWIN_THREADS"]))
from lidp_tpu_torch.io.script import LammpsScript
s = LammpsScript(dtype=torch.float64, device="cpu", log=lambda line: None)
s.variables["nstep"] = sys.argv[3]
t0 = time.perf_counter()
s.file(sys.argv[2])
seconds = time.perf_counter() - t0
sim = s._sim
n = sim.natoms
cols = [c for c in s.thermo_rows[0] if c not in ("step", "atoms", "bonds")]
np.savez(sys.argv[1], x=sim.sys.x[:n].numpy(), v=sim.sys.v[:n].numpy(),
         mu=sim.sys.mu[:n].numpy(), cols=np.array(cols),
         rows=np.array([[r[c] for c in cols] for r in s.thermo_rows]),
         seconds=seconds)
assert "jax" not in sys.modules
"""
# the twins deferred until the card's paths are done (defer_twin), and the
# directory their inputs are copied to
TWINS = []
TWIN_ROOT = []
TWIN_TIMEOUT = 900


def start_cpu_twin(work, script, steps, out, threads=1):
    """Start the CPU twin of `script` (in directory `work`) in a process
    of its own on `threads` torch threads; returns the Popen."""
    env = dict(os.environ, OMP_NUM_THREADS=str(threads),
               TWIN_THREADS=str(threads), CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(
                   filter(None, (ROOT, os.environ.get("PYTHONPATH")))))
    env.pop("LIDP_FAST_POLAR", None)
    return subprocess.Popen(
        [sys.executable, "-c", CPU_TWIN, out, script, str(steps)],
        cwd=work, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def defer_twin(path, work, script, steps, check, threads=1, cost=60.0):
    """Queue path's CPU twin (CPU_TWIN on `script`, `steps` steps) to run
    after every path on the card (run_twins), so that no timed path shares
    the host's cores with it: the directory `work` (the input and its
    data) is copied aside now; check(twin), with twin the np.load of the
    twin's arrays, holds the path to it.  cost: the twin's expected
    seconds on its `threads`, so that run_twins starts the longest
    first."""
    import atexit

    if not TWIN_ROOT:
        TWIN_ROOT.append(tempfile.mkdtemp(prefix="chip_smoke_twins_"))
        atexit.register(shutil.rmtree, TWIN_ROOT[0], True)
    dst = os.path.join(TWIN_ROOT[0], path)
    shutil.copytree(work, dst)
    TWINS.append(dict(path=path, work=dst, script=script, steps=steps,
                      check=check, threads=threads, cost=cost))


def run_twins():
    """Run the queued CPU twins after the card's paths: as many at once as
    the host's cores take their threads, the most expensive first (a
    twin that does not fit waits for cores to free); each is checked as
    it ends.  Raises if one fails, disagrees or runs past TWIN_TIMEOUT
    seconds; every process started is stopped."""
    import numpy as np

    budget = os.cpu_count() or 1
    queue = sorted(TWINS, key=lambda t: -t["cost"])
    running = []
    t0 = time.perf_counter()
    try:
        while queue or running:
            used = sum(t["threads"] for t in running)
            for t in list(queue):
                if not running or used + t["threads"] <= budget:
                    t["out"] = os.path.join(t["work"], "twin.npz")
                    t["proc"] = start_cpu_twin(t["work"], t["script"],
                                               t["steps"], t["out"],
                                               t["threads"])
                    t["t0"] = time.perf_counter()
                    running.append(t)
                    queue.remove(t)
                    used += t["threads"]
            time.sleep(0.2)
            for t in [t for t in running if t["proc"].poll() is not None]:
                running.remove(t)
                _, err = t["proc"].communicate()
                if t["proc"].returncode != 0:
                    raise AssertionError(
                        f"path {t['path']}: the CPU twin exit "
                        f"{t['proc'].returncode}\n{err[-4000:]}")
                twin = np.load(t["out"])
                print(f"path {t['path']}: its CPU twin (the same script, "
                      f"the port on the CPU, float64, {t['threads']} "
                      f"thread(s)) took {float(twin['seconds']):.1f} s of "
                      f"its {time.perf_counter() - t['t0']:.1f} s process")
                t["check"](twin)
            for t in running:
                if time.perf_counter() - t["t0"] > TWIN_TIMEOUT:
                    raise AssertionError(f"path {t['path']}: the CPU twin "
                                         "did not finish")
    finally:
        for t in running:
            t["proc"].kill()
            t["proc"].communicate()
    print(f"CPU twins: {len(TWINS)} in {time.perf_counter() - t0:.1f} s of "
          f"wall time on {budget} cores, after every path on the card")


def run_state(script):
    """The rows of a script's runs and its final x, v, mu on the host."""
    sim = script._sim
    return script.thermo_rows, {
        name: getattr(sim.sys, name)[:sim.natoms].cpu().numpy()
        for name in ("x", "v", "mu")}


def twin_check(path, state, cols, cancel=None):
    """The check of a deferred twin (defer_twin) on path's rows and final
    x, v, mu (run_state): its first rows, as many as the twin ran, within
    rel 1e-9 of max(1, |value|) of the twin's (plus CANCEL_REL of `cancel`,
    cancelled()'s magnitudes); where the twin ran all of the path's steps,
    x, v and mu within 1e-8 of their largest entry."""
    import numpy as np

    rows, final = state

    def check(twin):
        ref = [dict(zip(twin["cols"].tolist(), r)) for r in twin["rows"]]
        worst = rows_agree(path, rows[:len(ref)], ref, [1e-9] * len(ref),
                           cols, cancel=cancel)
        line = (f"path {path} vs its CPU twin: rows 0-{len(ref) - 1} at "
                f"{worst:.3g} of their bar (rel 1e-9 of max(1, |value|)"
                + (f" + {CANCEL_REL:g} of the cancelled magnitude, "
                   f"{cancel.get('evdwl', 0.0):.4g} in E_vdwl)" if cancel
                   else ")"))
        if len(ref) < len(rows):
            print(line + f"; rows {len(ref)}-{len(rows) - 1} finite")
            return
        worst_arr = 0.0
        for name in ("x", "v", "mu"):
            got, want = final[name], twin[name]
            big = float(np.abs(want).max())
            err = float(np.abs(got - want).max())
            # an array of zeros (an atomic input's mu) must stay zeros
            worst_arr = max(worst_arr, err / (1e-8 * big) if big
                            else (0.0 if err == 0.0 else math.inf))
            if not err <= 1e-8 * big:
                raise AssertionError(f"path {path} final {name}: max abs "
                                     f"err {err:.3e} above 1e-8 of "
                                     f"{big:.3e}")
        print(line + f", final x/v/mu at {worst_arr:.3g} of theirs (1e-8 "
              "of max)")

    return check


EXTRA_STEPS = 2   # the steps after a path's run that its readings time


def thermostat_readings(path, script, log, steps, peak):
    """A Nose-Hoover path's log and readings: steps/s by the Loop time line
    of its run (the setup's evaluation included, as in every first run of
    a Simulation); then EXTRA_STEPS more steps of the same run (not
    counted), each phase's ms a step (DensePhases), the integrator's ms
    and host reads a step (IntegratorTimer), all host reads a step
    (HostReads); and the run's peak device memory."""
    for line in log:
        print(f"  {path}| {line}")
    rate = steps / loop_seconds(log, steps)
    sim = script._sim
    with HostReads() as reads, IntegratorTimer(reads) as integ, \
            DensePhases() as ph:
        sim.runner.run(sim.sys, sim.res, None, sim.istate, EXTRA_STEPS)
        ims, ihost, ireads, chain = integ.per_step(EXTRA_STEPS)
        nreads = reads.count() / EXTRA_STEPS
    print(f"steps_per_s_{path.replace('-', '_')} {rate:.4f} (Loop time: "
          f"setup and {steps} steps); peak device memory "
          f"{peak / 2**20:.1f} MiB "
          f"(torch.cuda.max_memory_allocated); over {EXTRA_STEPS} more "
          f"steps: integrator {ims:.4f} ms a step by CUDA events "
          f"({ihost:.4f} ms of host clock, of which the chain updates "
          f"{chain:.4f}), its host reads a step {ireads:g}; host reads a "
          f"step in all {nreads:g} (synchronizing CUDA operations, the "
          f"re-tally's included)")
    print(phase_line(f"path {path}", ph.ms(EXTRA_STEPS), ph.iterations(),
                     "a step"))


def thermostat_paths(launches, reset_counts, read_counts, rowsI):
    """Paths J, J-all, J-cap and K: the Nose-Hoover thermostats on the
    dense route (module docstring).  rowsI: path I's rows.  Each sets
    launches[path] to its counters, all 0."""
    import torch

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        fluid_script_case(work, n_side=J_SIDE)
        n = J_SIDE ** 3 * 3
        for kind in ("J", "J-all", "K"):
            with open(os.path.join(work, f"in.{kind}"), "w") as fh:
                fh.write(thermostat_script(kind, J_SIDE))

        # path J: rigid/nvt on half the molecules, tparam 50 1 3, c_ column
        reset_counts()
        scriptJ, logJ, _, peakJ = dense_run(os.path.join(work, "in.J"),
                                            J_STEPS)
        launches["J"] = read_counts()
        check_counts("J", launches["J"], {})
        check_dense_runner("J", scriptJ, n)
        rowsJ = scriptJ.thermo_rows
        check_rows_finite("J", rowsJ, G64_COLS + ("c_movingtemp",))
        print(f"path J: {n} atoms, `fix 1 moving {RIGID_NVT}` on "
              f"{J_SIDE ** 3 // 2} of {J_SIDE ** 3} molecules, compute "
              f"movingtemp, float64, precision 1e-11, {J_STEPS} steps on "
              f"the dense route; its log:")
        stateJ = run_state(scriptJ)
        thermostat_readings("J", scriptJ, logJ, J_STEPS, peakJ)

        # path J-all: the same thermostat on every molecule, against I
        reset_counts()
        scriptA, logA, _, _ = dense_run(os.path.join(work, "in.J-all"),
                                        J_STEPS)
        launches["J-all"] = read_counts()
        check_counts("J-all", launches["J-all"], {})
        check_dense_runner("J-all", scriptA, n)
        rowsA = scriptA.thermo_rows
        if rowsA[0] != rowsI[0]:
            raise AssertionError(f"path J-all: step 0 {rowsA[0]} is not "
                                 f"path I's {rowsI[0]}")
        same = ("pe", "evdwl", "ecoul", "elong", "epol")
        if any(rowsA[1][c] != rowsI[1][c] for c in same):
            raise AssertionError(f"path J-all: step 1's {same} are not path "
                                 f"I's bit for bit ({rowsA[1]} against "
                                 f"{rowsI[1]})")
        for k in range(1, J_STEPS + 1):
            if any(rowsA[k][c] == rowsI[k][c] for c in ("ke", "temp")):
                raise AssertionError(f"path J-all: step {k}'s ke or temp "
                                     f"equals path I's")
        # x at step 1: one step of each form, the chain at rest in step 1's
        # drift (exp(-dtq * 0) = 1 exactly)
        x1 = {}
        for kind, path_in in (("I", "in.fluid"), ("J-all", "in.J-all")):
            s1, _, _, _ = dense_run(os.path.join(work, path_in), 1)
            x1[kind] = s1._sim.sys.x.clone()
            del s1
        if not torch.equal(x1["I"], x1["J-all"]):
            raise AssertionError("path J-all: x at step 1 is not path I's "
                                 "bit for bit")
        print(f"path J-all: `fix 1 all {RIGID_NVT}`, {J_STEPS} steps: step "
              f"0's row equals path I's, step 1's x and pe, evdwl, ecoul, "
              f"elong, epol equal I's bit for bit, ke and temp differ from "
              f"I's at steps 1-{J_STEPS} (step {J_STEPS}: ke "
              f"{rowsA[-1]['ke']:.10g} against {rowsI[-1]['ke']:.10g}); "
              + next(line for line in logA if line.startswith("Performance")))
        del scriptA, x1

        # path K: fix nvt on every atom
        reset_counts()
        scriptK, logK, _, peakK = dense_run(os.path.join(work, "in.K"),
                                            J_STEPS)
        launches["K"] = read_counts()
        check_counts("K", launches["K"], {})
        check_dense_runner("K", scriptK, n)
        check_rows_finite("K", scriptK.thermo_rows)
        print(f"path K: {n} atoms, `fix 1 all {NVT}`, float64, precision "
              f"1e-11, {J_STEPS} steps on the dense route; its log:")
        stateK = run_state(scriptK)
        thermostat_readings("K", scriptK, logK, J_STEPS, peakK)

        del scriptJ, scriptK
        for kind, state, cols in (("J", stateJ, G64_COLS + ("c_movingtemp",)),
                                  ("K", stateK, G64_COLS)):
            defer_twin(kind, work, f"in.{kind}", J_STEPS,
                       twin_check(kind, state, cols))
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # path J-cap: J just under the cap
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        fluid_script_case(work, n_side=JCAP_SIDE)
        n = JCAP_SIDE ** 3 * 3
        with open(os.path.join(work, "in.J"), "w") as fh:
            fh.write(thermostat_script("J", JCAP_SIDE))
        reset_counts()
        with DensePhases() as ph:
            scriptC, logC, _, peakC = dense_run(
                os.path.join(work, "in.J"), JCAP_STEPS)
        launches["J-cap"] = read_counts()
        check_counts("J-cap", launches["J-cap"], {})
        check_dense_runner("J-cap", scriptC, n)
        check_rows_finite("J-cap", scriptC.thermo_rows,
                          G64_COLS + ("c_movingtemp",))
        if not ph.all_converged():
            raise AssertionError(f"path J-cap: a solve did not converge "
                                 f"({ph.iterations()} iterations)")
        print(f"path J-cap: {n} atoms, path J's fix on {JCAP_SIDE ** 3 // 2}"
              f" of {JCAP_SIDE ** 3} molecules, float64, precision 1e-11, "
              f"setup + {JCAP_STEPS} steps on the dense route, rows finite, "
              f"every solve converged ({len(ph.solves)} evaluations); its "
              f"log:")
        thermostat_readings("J-cap", scriptC, logC, JCAP_STEPS, peakC)
        del scriptC
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)

# the barostat paths' edits of FLUID_SCRIPT and LJ_SCRIPT
RIGID_NPT = "rigid/npt molecule temp 300 300 100 iso 1 1 1000"
LJ_NPT = "npt temp 1.44 1.44 0.5 iso -5.0197073 -5.0197073 5.0"


def kspace_script(text, kspace):
    return text.replace("kspace_style ewald/disp 1e-4",
                        f"kspace_style {kspace}")


def q_script(steps, every):
    """bench/in.lj with fix npt in place of fix nve, a row every `every`
    steps with the box's volume and edge, `run steps`."""
    return LJ_SCRIPT.replace("fix\t\t1 all nve", f"fix\t\t1 all {LJ_NPT}") \
        .replace("run\t\t100", f"thermo {every}\nthermo_style custom step "
                 f"temp epair emol etotal press pe vol lx\nrun {steps}")


class BoxWatch:
    """Within `with BoxWatch():` the box lengths after every barostat
    remap (integrate/npt._remap) are kept on the device; `smallest()`
    reads their least entry once."""

    def __enter__(self):
        from lidp_tpu_torch.integrate import npt

        self.lengths = []
        self._fn = npt._remap

        def wrapped(*a, **kw):
            sys_, st = self._fn(*a, **kw)
            self.lengths.append(sys_.box.lengths.min())
            return sys_, st
        npt._remap = wrapped
        return self

    def __exit__(self, *exc):
        from lidp_tpu_torch.integrate import npt

        npt._remap = self._fn
        return False

    def smallest(self):
        import torch

        return float(torch.stack(self.lengths).min())


def pppm_vs_ewald_case():
    """tests/test_pppm.py's random case on the card (40 charges in a 12 A
    box, accuracy 1e-6): PPPM at the Ewald setup's g_ewald against the
    port's ewald_forces; elong rel 1e-4, f 1e-4 of max |f|."""
    import numpy as np
    import torch

    from lidp_tpu_torch.ops import ewald, pppm

    rs = np.random.RandomState(3)
    L, n = 12.0, 40
    x = rs.uniform(0, L, (n, 3))
    q = rs.normal(size=n)
    q -= q.mean()
    es = ewald.setup_ewald_disp(accuracy_rel=1e-6, qqrd2e=1.0, q=q,
                                natoms=n, cutoff=5.0, box_lengths=[L] * 3)
    ew = ewald.EwaldParams.from_setup(es, 1.0, device="cuda")
    xt = torch.as_tensor(x, device="cuda")
    qt = torch.as_tensor(q, device="cuda")
    fe, ee, _ = ewald.ewald_forces(xt, qt, torch.tensor(L ** 3), ew)
    ps = pppm.setup_pppm(accuracy_rel=1e-6, qqrd2e=1.0, q=q, natoms=n,
                         cutoff=5.0, box_lengths=[L] * 3, g_ewald=es.g_ewald)
    fp, ep, _ = pppm.pppm_forces(xt, qt, torch.full((3,), L,
                                                    dtype=torch.float64,
                                                    device="cuda"),
                                 ps, 1.0, float((q ** 2).sum()),
                                 float(q.sum()))
    rel_e = abs(float(ep) - float(ee)) / abs(float(ee))
    rel_f = float((fp - fe).abs().max() / fe.abs().max())
    print(f"path P: pppm_forces against ewald_forces on tests/test_pppm.py's "
          f"case (grid {ps.grid}, g_ewald {es.g_ewald:.6g}, {len(es.hvecs)} "
          f"k-vectors), float64 on the card: elong {float(ep)!r} against "
          f"{float(ee)!r} (rel {rel_e:.3e}, bar 1e-4), f at {rel_f:.3e} of "
          f"max |f| (bar 1e-4)")
    if not (rel_e <= 1e-4 and rel_f <= 1e-4):
        raise AssertionError("path P: pppm_forces against ewald_forces")


def kspace_ms(sim):
    """One call of the k-space term on sim's state, by CUDA events after a
    warm-up: (ms, (f, elong, virial))."""
    from lidp_tpu_torch.ops.pppm import pppm_forces_params

    s_, ff = sim.sys, sim.runner.ff

    def call():
        return pppm_forces_params(s_.x - s_.box.lo, s_.q, s_.box.lengths,
                                  ff.pppm)
    return cuda_ms(call, reps=3, warmup=1), call()


def barostat_paths(launches, reset_counts, read_counts):
    """Paths O, P, P100, Q, Q64, R and R-pppm: the mesh k-space and the
    barostats from a LAMMPS script (module docstring).  Each sets
    launches[path]."""
    import torch

    from lidp_tpu_torch.__main__ import main as cli
    from lidp_tpu_torch.io.script import LammpsScript
    from lidp_tpu_torch.ops import ewald
    from lidp_tpu_torch.ops.pppm import setup_pppm

    def fresh():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def f64_script(text_path, nstep, log):
        script = LammpsScript(dtype=torch.float64, log=log.append)
        script.variables["nstep"] = str(nstep)
        script.file(text_path)
        return script

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        # the inputs of O, R, R-pppm (path I's fluid) and Q64
        fluid_script_case(work, n_side=O_SIDE)
        n = O_SIDE ** 3 * 3
        rigid = FLUID_SCRIPT.replace("fix 1 all rigid/nve molecule",
                                     f"fix 1 all {RIGID_NPT}")
        inputs = {"O": kspace_script(FLUID_SCRIPT, "pppm 1e-4"),
                  "R": rigid, "R-pppm": kspace_script(rigid, "pppm 1e-4"),
                  "Q64": q_script("${nstep}", Q_EVERY)}
        for kind, text in inputs.items():
            with open(os.path.join(work, f"in.{kind}"), "w") as fh:
                fh.write(text)

        # path O: path I's input with kspace_style pppm, the dense route
        reset_counts()
        scriptO, logO, _, peakO = dense_run(os.path.join(work, "in.O"),
                                            O_STEPS)
        launches["O"] = read_counts()
        check_counts("O", launches["O"], {})
        check_dense_runner("O", scriptO, n)
        check_rows_finite("O", scriptO.thermo_rows)
        sim = scriptO._sim
        pp = sim.runner.ff.pppm
        es = ewald.setup_ewald_disp(
            accuracy_rel=1e-4, qqrd2e=scriptO.units.qqr2e, q=scriptO.q,
            natoms=n, cutoff=scriptO.pair.cut_coul,
            box_lengths=scriptO.box_hi - scriptO.box_lo)
        print(f"path O: {n} atoms, `kspace_style pppm 1e-4` in path I's "
              f"input, float64, precision 1e-11, {O_STEPS} steps: "
              f"{script_route(scriptO)}; PPPM grid {pp.grid} order "
              f"{pp.order}, g_ewald {pp.g_ewald!r}, beside ewald/disp's "
              f"g_ewald {es.g_ewald!r} and {len(es.hvecs)} k-vectors on the "
              f"same script; its log:")
        stateO = run_state(scriptO)
        thermostat_readings("O", scriptO, logO, O_STEPS, peakO)
        del scriptO, sim
        fresh()

        # path R: rigid/npt with ewald/disp (rescale_coeffs every call);
        # R-pppm: the same with pppm
        stateR = {}
        for kind in ("R", "R-pppm"):
            reset_counts()
            scriptR, logR, _, peakR = dense_run(
                os.path.join(work, f"in.{kind}"), R_STEPS)
            launches[kind] = read_counts()
            check_counts(kind, launches[kind], {})
            check_dense_runner(kind, scriptR, n)
            check_rows_finite(kind, scriptR.thermo_rows)
            ff = scriptR._sim.runner.ff
            if not scriptR._sim.runner.every_step_ev or (
                    kind == "R" and not ff.kspace_dynamic) or (
                    kind == "R-pppm" and ff.pppm is None):
                raise AssertionError(f"path {kind}: not the barostat's "
                                     f"route ({ff.kspace_dynamic}, "
                                     f"{ff.pppm})")
            vols = [r["vol"] for r in scriptR.thermo_rows]
            if len(set(vols)) != len(vols):
                raise AssertionError(f"path {kind}: the volume did not move "
                                     f"({vols})")
            print(f"path {kind}: {n} atoms, `fix 1 all {RIGID_NPT}`, "
                  f"{'pppm' if ff.pppm else 'ewald/disp'} 1e-4, float64, "
                  f"precision 1e-11, {R_STEPS} steps: {script_route(scriptR)}"
                  f"; volume {vols[0]!r} -> {vols[-1]!r}; its log:")
            stateR[kind] = run_state(scriptR)
            thermostat_readings(kind, scriptR, logR, R_STEPS, peakR)
            del scriptR, ff
            fresh()

        # path Q: bench/in.lj under fix npt through the CLI, float32
        in_q = os.path.join(work, "in.Q")
        with open(in_q, "w") as fh:
            fh.write(q_script(Q_STEPS, Q_EVERY))
        log_q = os.path.join(work, "log.Q")
        fresh()
        reset_counts()
        with HostReads() as reads, IntegratorTimer(reads) as integ, \
                BoxWatch() as watch:
            cli(["-in", in_q, "-log", log_q, "--f32"])
            ims, ihost, ireads, _ = integ.per_step(Q_STEPS)
            nreads = reads.count() / Q_STEPS
        launches["Q"] = read_counts()
        peakQ = torch.cuda.max_memory_allocated()
        with open(log_q) as fh:
            logQ = fh.read().splitlines()
        rowsQ = log_rows(logQ)
        print(f"path Q: `python -m lidp_tpu_torch -in in.Q --f32` (bench/"
              f"in.lj, `fix 1 all {LJ_NPT}` in place of fix nve, a row every "
              f"{Q_EVERY}), {len(rowsQ)} rows:")
        for line in logQ:
            print(f"  Q| {line}")
        if [int(r["step"]) for r in rowsQ] != list(range(0, Q_STEPS + 1,
                                                         Q_EVERY)):
            raise AssertionError(f"path Q: rows {rowsQ}")
        if not (launches["Q"]["cell_pair_forces_lj"] > 0
                and launches["Q"]["slot_lj_forces"] == 0):
            raise AssertionError(f"path Q launches {launches['Q']}")
        print(f"path Q launches: {launches['Q']} (cell_pair_forces_lj "
              f"{launches['Q']['cell_pair_forces_lj']}, under a box that "
              f"moves each step)")
        vols = [r["vol"] for r in rowsQ]
        if len(set(vols)) != len(vols):
            raise AssertionError(f"path Q: the volume did not move ({vols})")
        for k, (want, bar) in LJ_LOG0.items():
            got = rowsQ[0][k]
            err = abs(got - want) / abs(want)
            print(f"path Q step 0 {k}: {got!r} against the in.lj log's "
                  f"{want!r} (rel {err:.2e}, bar {bar:g})")
            if not err <= bar:
                raise AssertionError(f"path Q step 0 {k}: {got!r}")
        smallest = watch.smallest()
        print(f"path Q: box volume {vols[0]!r} -> {vols[-1]!r}; integrator "
              f"(npt) {ims:.4f} ms a step by CUDA events ({ihost:.4f} ms of "
              f"host clock), its host reads a step {ireads:g}; host reads a "
              f"step in all {nreads:g} (the rows' reads included)")
        script_peak("Q", logQ, Q_STEPS, peakQ)

        # path Q64: the same input in float64, LammpsScript, 20 steps
        logs = []
        fresh()
        reset_counts()
        scriptQ = f64_script(os.path.join(work, "in.Q64"), Q64_STEPS, logs)
        launches["Q64"] = read_counts()
        peak = torch.cuda.max_memory_allocated()
        check_counts("Q64", launches["Q64"], {})
        print(f"path Q64: in.Q in float64 through LammpsScript, {Q64_STEPS} "
              f"steps: {script_route(scriptQ)}; its log:")
        for line in logs:
            print(f"  Q64| {line}")
        rows64 = scriptQ.thermo_rows
        for step in (10, 20):
            r32 = next(r for r in rowsQ if int(r["step"]) == step)
            r64 = next(r for r in rows64 if int(r["step"]) == step)
            for c in ("etotal", "pe", "vol"):
                check_rel(f"path Q step {step} {c} vs Q64", r32[c], r64[c],
                          2e-4)
        stateQ = run_state(scriptQ)
        cfg = scriptQ._sim.runner.neighbor_cfg
        print(f"path Q: the smallest box edge over its run {smallest!r}, so "
              f"its smallest bin {smallest / max(cfg.nbins)!r} on the "
              f"{cfg.nbins} grid fixed at setup, beside cut + skin "
              f"{cfg.cutneigh:g}")
        script_peak("Q64", logs, Q64_STEPS, peak)
        del scriptQ
        fresh()

        cols = G64_COLS + ("vol",)
        for kind, state in (("O", stateO), ("R", stateR["R"]),
                            ("R-pppm", stateR["R-pppm"]), ("Q64", stateQ)):
            q64 = kind == "Q64"
            defer_twin(kind, work, f"in.{kind}",
                       Q64_STEPS if q64 else O_STEPS,
                       twin_check(kind, state, (
                           "temp", "epair", "etotal", "press", "pe", "vol")
                           if q64 else cols), cost=120.0 if q64 else 60.0)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # paths P and P100: the point-charge fluid with pppm on the cell grid
    for tag, side, steps in (("P", P_SIDE, P_STEPS),
                             ("P100", P100_SIDE, P100_STEPS)):
        work = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            fluid_script_case(work, n_side=side)
            n = side ** 3 * 3
            with open(os.path.join(work, "in.pc"), "w") as fh:
                fh.write(kspace_script(point_charge_script(), "pppm 1e-4")
                         .replace("read_data fluid.data\n",
                                  "read_data fluid.data\nneighbor "
                                  f"{CELL_SKIN} bin\n"))
            logs = []
            fresh()
            reset_counts()
            script = f64_script(os.path.join(work, "in.pc"), 0, logs)
            sim = script._sim
            pp = sim.runner.ff.pppm
            print(f"path {tag}: the point-charge fluid ({n} atoms, L "
                  f"{float(sim.sys.box.lengths[0]):g} A, pppm 1e-4, "
                  f"rigid/nve, neighbor {CELL_SKIN}), float64: "
                  f"{script_route(script)}; PPPM grid {pp.grid}, g_ewald "
                  f"{pp.g_ewald!r}")
            if sim.runner.neighbor_cfg is None or pp is None:
                raise AssertionError(f"path {tag}: not the cell grid's pppm")
            ms_mesh, (f1, e1, v1) = kspace_ms(sim)
            if tag == "P":
                cells_step0_vs_dense("P", script, n)
                pppm_vs_ewald_case()
                _, (f2, e2, v2) = kspace_ms(sim)
                diff = max(float((f1 - f2).abs().max()),
                           abs(float(e1) - float(e2)),
                           float((v1 - v2).abs().max()))
                print(f"path P: two evaluations of pppm_forces on one state "
                      f"differ by at most {diff!r} (f, elong, virial): the "
                      f"spread (index_add_, float atomics) is "
                      f"{'' if diff == 0.0 else 'not '}bit-reproducible on "
                      f"the card")
            else:
                # one Ewald evaluation on the step-0 state at PPPM's g_ewald
                es = ewald.setup_ewald_disp(
                    accuracy_rel=1e-4, qqrd2e=script.units.qqr2e,
                    q=script.q, natoms=n, cutoff=script.pair.cut_coul,
                    box_lengths=script.box_hi - script.box_lo,
                    g_ewald=pp.g_ewald)
                ew = ewald.EwaldParams.from_setup(es, script.units.qqr2e,
                                                  device="cuda")
                s_ = sim.sys
                ms_ew = cuda_ms(lambda: ewald.ewald_forces(
                    s_.x, s_.q, s_.box.volume, ew), reps=1, warmup=1)
                _, e_ew, _ = ewald.ewald_forces(s_.x, s_.q, s_.box.volume,
                                                ew)
                print(f"path P100: one ewald_forces evaluation on the "
                      f"step-0 state at PPPM's g_ewald: {ms_ew:.3f} ms, "
                      f"{len(es.hvecs)} k-vectors, elong {float(e_ew)!r} "
                      f"beside PPPM's {float(e1)!r} (rel "
                      f"{abs(float(e1) - float(e_ew)) / abs(float(e_ew)):.3e}"
                      f"); PPPM {ms_mesh:.3f} ms a call ({smi_line()})")
                del ew
            del f1, v1
            fresh()
            with DensePhases() as ph:
                script.execute([f"run {steps}"])
                phases = ph.ms(1)
                calls = sum(1 for label, _, _ in ph.events
                            if label == "pppm")
            launches[tag] = read_counts()
            peak = torch.cuda.max_memory_allocated()
            check_counts(tag, launches[tag], {})
            rows = script.thermo_rows
            check_rows_finite(tag, rows)
            if bool(script._sim.nlist.overflow):
                raise AssertionError(f"path {tag}: a cell overflowed")
            for line in logs:
                print(f"  {tag}| {line}")
            print(f"path {tag}: PPPM {phases['pppm'] / calls:.4f} ms a "
                  f"force call by CUDA events over the run ({calls} calls: "
                  f"a step's and the row's re-tally; {ms_mesh:.4f} ms a call "
                  f"alone on step 0's state)")
            script_peak(tag, logs, steps, peak)
            del script, sim
            fresh()
        finally:
            shutil.rmtree(work, ignore_errors=True)


# paths S and T: flexible molecules (flexible_script_case), float64
FLEX_SIDE = (4, 4, 5)          # path S: 1,920 atoms, examples/peptide's size
FLEX_REPLICATE = (2, 2, 4)     # path T: S replicated, 30,720 atoms (in.rhodo)
FLEX_STEPS = 10
FLEX_TWIN_STEPS = 2            # the CPU twins' steps: rows 0-2 compared
# the T twin's torch threads: its cell pass on one thread takes ~500 s on
# the card's host, beyond the script's budget
FLEX_T_TWIN_THREADS = 4
FLEX_T_TWIN_COST = 190.0       # its seconds on them (PR 15, call 3)
FLEX_COLS = ("etotal", "ke", "temp", "pe", "ebond", "eangle", "edihed",
             "eimp", "evdwl", "ecoul", "elong", "press", "emol", "epair")
FLEX_TOL = 1e-4                # FLEX_SHAKE's tolerance
# the phases timed on S and T (DensePhases): label, module, function
FLEX_PHASES = (("bonded", "lidp_tpu_torch.forcefield", "bonded_terms"),
               ("shake", "lidp_tpu_torch.ops.shake", "shake_post_force"),
               ("pair", "lidp_tpu_torch.ops.pair", "dense_pair_forces"),
               ("pair cells", "lidp_tpu_torch.ops.cells",
                "cell_pair_forces"),
               ("special", "lidp_tpu_torch.ops.bonded",
                "special_correction_sparse"),
               ("pppm", "lidp_tpu_torch.ops.pppm", "pppm_forces_params"))


class ConstraintWatch:
    """Within `with ConstraintWatch():` every thermo row a Simulation
    emits also records the largest relative deviation of a fix shake
    constraint (bond or angle 1-3 distance) from its target on that row's
    positions (the clusters of fix_modifiers.shake_pre_pass)."""

    def __enter__(self):
        import numpy as np
        import torch

        from lidp_tpu_torch import sim as sim_mod
        from lidp_tpu_torch.box import minimum_image
        from lidp_tpu_torch.styles.fix_modifiers import shake_pre_pass

        self.errors, self._cls = [], sim_mod.Simulation
        self._emit = emit = sim_mod.Simulation._emit
        found = {}

        def watched(sim):
            s = sim.script
            if id(sim) not in found:
                at, cp, b2, cm = shake_pre_pass(
                    s, s.mass_type[s.type])[0][:4]
                dev = sim.sys.x.device
                pa = np.take_along_axis(np.maximum(at, 0),
                                        np.maximum(cp[:, :, 0], 0), 1)
                qa = np.take_along_axis(np.maximum(at, 0),
                                        np.maximum(cp[:, :, 1], 0), 1)
                found[id(sim)] = tuple(
                    torch.as_tensor(a, device=dev)
                    for a in (pa[cm], qa[cm], np.sqrt(b2[cm])))
            pa, qa, target = found[id(sim)]
            x = sim.sys.x
            d = minimum_image(x[pa] - x[qa], sim.sys.box.lengths)
            r = torch.sqrt(torch.sum(d * d, dim=1))
            self.errors.append(float(torch.max(torch.abs(r / target
                                                         - 1.0))))
            return emit(sim)

        sim_mod.Simulation._emit = watched
        return self

    def __exit__(self, *exc):
        self._cls._emit = self._emit
        return False


def flexible_paths(launches, reset_counts, read_counts):
    """Paths S and T: flexible molecules from a LAMMPS script (module
    docstring).  Each sets launches[path]."""
    import torch

    from lidp_tpu_torch.forcefield import bonded_terms
    from lidp_tpu_torch.io.script import LammpsScript

    work = tempfile.mkdtemp(prefix="chip_smoke_flex_")
    try:
        flexible_script_case(work, n_side=FLEX_SIDE)
        with open(os.path.join(work, "in.T"), "w") as fh:
            fh.write(flexible_script(FLEX_NPT, replicate=FLEX_REPLICATE))
        inputs = {"S": "in.flex", "T": "in.T"}
        for path in ("S", "T"):
            t_path = time.perf_counter()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            log = []
            reset_counts()
            with ConstraintWatch() as watch:
                script = LammpsScript(dtype=torch.float64, log=log.append)
                script.variables["nstep"] = str(FLEX_STEPS)
                script.file(os.path.join(work, inputs[path]))
            launches[path] = read_counts()
            peak = torch.cuda.max_memory_allocated()
            check_counts(path, launches[path], {})
            sim = script._sim
            ff = sim.runner.ff
            cells = sim.runner.neighbor_cfg is not None
            if cells != (path == "T") or (cells and bool(sim.nlist.overflow)):
                raise AssertionError(
                    f"path {path}: route {script_route(script)}")
            print(f"path {path}: flexible_script_case, {sim.natoms} atoms, "
                  f"`fix 1 all {FLEX_NPT if cells else FLEX_NVT}` and `fix 2 "
                  f"all {FLEX_SHAKE}`, lj/charmm/coul/long 8 10, pppm 1e-4, "
                  f"float64, {FLEX_STEPS} steps: {script_route(script)}; "
                  f"{len(ff.bond[0].idx)} bonds, "
                  f"{len(ff.angle[0].idx)} angles, "
                  f"{len(ff.dihedral[0].idx)} dihedrals, "
                  f"{len(ff.improper[0].idx)} impropers left to the bonded "
                  f"terms; its log:")
            for line in log:
                print(f"  {path}| {line}")
            rows = script.thermo_rows
            cols = FLEX_COLS + (("vol",) if cells else ())
            check_rows_finite(path, rows, cols)
            if len(watch.errors) != FLEX_STEPS + 1 or \
                    not max(watch.errors) <= FLEX_TOL:
                raise AssertionError(f"path {path}: the SHAKE constraints' "
                                     f"largest relative errors by row "
                                     f"{watch.errors}")
            print(f"path {path}: the SHAKE constraints' largest relative "
                  "error "
                  f"by row " + ", ".join(f"{e:.2e}" for e in watch.errors)
                  + f" (the fix's tolerance {FLEX_TOL:g})")
            script_peak(path, log, FLEX_STEPS, peak)
            cancel = dict(cancelled(sim))
            if cancel:
                cancel["epair"] = cancel["evdwl"] + cancel["ecoul"]
            # the bonded terms twice on one state: index_add_'s float atomics
            z = torch.zeros_like(sim.sys.x)
            e0 = sim.sys.x.new_zeros(())
            outs = [bonded_terms(sim.sys, ff, z, e0, e0, z.new_zeros(6))
                    for _ in range(2)]
            diff = max(max(float((a - b).abs().max()) for a, b in
                           zip(outs[0][:4], outs[1][:4])),
                       max(abs(float(outs[0][4][k]) - float(outs[1][4][k]))
                           for k in outs[0][4]))
            print(f"path {path}: two evaluations of bonded_terms on one state "
                  f"differ by at most {diff!r} (f, energies, virial): the "
                  f"index_add_ scatter is {'' if diff == 0.0 else 'not '}"
                  f"bit-reproducible on the card")
            with DensePhases(FLEX_PHASES) as ph:
                sim.sys, sim.res, sim.nlist, sim.istate = sim.runner.run(
                    sim.sys, sim.res, sim.nlist, sim.istate, EXTRA_STEPS)
                ms = {k: v for k, v in ph.ms(EXTRA_STEPS).items() if v}
            print(f"path {path} phases, ms a step by CUDA events over "
                  f"{EXTRA_STEPS} more steps: " + ", ".join(
                      f"{k} {v:.4f}" for k, v in ms.items())
                  + f" ({smi_line()})")
            defer_twin(path, work, inputs[path], FLEX_TWIN_STEPS,
                       twin_check(path, (rows, None), cols, cancel=cancel),
                       threads=FLEX_T_TWIN_THREADS if cells else 1,
                       cost=FLEX_T_TWIN_COST if cells else 10.0)
            print(f"path {path}: rows {FLEX_TWIN_STEPS + 1}-{FLEX_STEPS} "
                  f"finite; the path took "
                  f"{time.perf_counter() - t_path:.1f} s of wall time")
            del script, sim, ff, outs
    finally:
        shutil.rmtree(work, ignore_errors=True)


# paths U and U64: bench/in.chain (CHAIN_SCRIPT on chain_script_case)
U_STEPS = 100                  # in.chain's own run
U_PHASE_STEPS = 20             # the steps U's phases are timed over
U64_STEPS = 10                 # U64, a row each step
CHAIN_COLS = ("temp", "epair", "emol", "etotal", "press")
# the phases timed on U (DensePhases): the plain cell pass, the special
# lists' correction, the FENE bonds and fix langevin's stream (the hook as
# a whole is timed around the Runner's post_force)
CHAIN_PHASES = (("pair cells", "lidp_tpu_torch.ops.cells",
                 "cell_pair_forces"),
                ("special", "lidp_tpu_torch.ops.bonded",
                 "special_correction_sparse"),
                ("fene bonds", "lidp_tpu_torch.forcefield", "bonded_terms"),
                ("langevin stream", "lidp_tpu_torch.threefry", "uniform"))
# paths V and W: the modifier fixes; V's phases: the cell pass, the
# special correction and Ewald (W's are DENSE_PHASES)
V_STEPS = W_STEPS = 10
V_PHASES = CHAIN_PHASES[:2] + DENSE_PHASES[1:2]
MOD_TWIN_STEPS = 2             # their CPU twins' steps: rows 0-2 compared


def chain_text(every, run):
    """CHAIN_SCRIPT with a row every `every` steps and `run <run>`."""
    return CHAIN_SCRIPT.replace("thermo          100",
                                f"thermo {every}").replace(
                                    "run\t\t100", f"run {run}")


def id_group(name, first, last):
    """`group <name> id first ... last` (the port's group id takes a list
    of IDs)."""
    return f"group {name} id " + " ".join(
        str(i) for i in range(first, last + 1)) + "\n"


def modifier_script():
    """Path V's input: the point-charge fluid (point_charge_script) with
    `neighbor CELL_SKIN bin`, fix nve in place of rigid/nve, and every
    post_force modifier on a group of its own (100 molecules each, by atom
    ID), with momentum, recenter and temp/berendsen; a row each step."""
    fixes = ("setforce NULL NULL 0.0", "addforce 0.0 0.0 0.05",
             "aveforce NULL 0.0 NULL", "viscous 0.02",
             "efield 0.0 0.0 0.05", "spring/self 0.5",
             "spring tether 2.0 NULL NULL 30.0 0.0",
             "planeforce 0 0 1")
    lines = "".join(id_group(f"v{k}", 300 * k + 1, 300 * (k + 1))
                    for k in range(len(fixes) + 1))
    lines += "".join(f"fix m{k} v{k} {f}\n" for k, f in enumerate(fixes))
    lines += (f"fix m8 all momentum 5 linear 1 1 1\n"
              f"fix m9 v{len(fixes)} recenter INIT INIT INIT\n"
              "fix m10 all temp/berendsen 300.0 300.0 50.0\n")
    return point_charge_script().replace(
        "read_data fluid.data\n",
        f"read_data fluid.data\nneighbor {CELL_SKIN} bin\n").replace(
        "fix 1 all rigid/nve molecule\n", "fix 1 all nve\n" + lines)


def thermostat_melt_script():
    """Path W's input: examples/melt (MELT_SCRIPT, 4,000 atoms, no dump)
    with its atoms in three groups by ID, `fix temp/rescale` on the first,
    `fix temp/csld` on the second and `fix langevin` on the third; a row
    each step."""
    extra = (id_group("wa", 1, 1333) + id_group("wb", 1334, 2666)
             + id_group("wc", 2667, 4000)
             + "fix 2 wa temp/rescale 1 3.0 3.0 0.05 0.5\n"
             "fix 3 wb temp/csld 2.5 2.5 0.5 4567\n"
             "fix 4 wc langevin 2.0 2.0 0.5 904297\n")
    text = MELT_SCRIPT.replace("fix\t\t1 all nve\n",
                               "fix\t\t1 all nve\n" + extra)
    text = text.replace("dump\t\tid all atom 50 dump.melt\n", "")
    return text.replace("thermo\t\t50\nrun\t\t250",
                        "thermo 1\nrun ${nstep}")


def stream_on_both_devices():
    """threefry's bits and uniforms of one key on the card and on the CPU:
    equal bit for bit (the same integer arithmetic)."""
    import torch

    from lidp_tpu_torch import threefry

    key = threefry.fold_in(threefry.prng_key(904297), 12345)
    shape = (32_000, 3)
    for what, fn in (
            ("bits32", lambda d: threefry.random_bits(key, 32, shape, d)),
            ("bits64", lambda d: threefry.random_bits(key, 64, shape, d)),
            ("uniform float32", lambda d: threefry.uniform(
                key, shape, torch.float32, d).view(torch.int32)),
            ("uniform float64", lambda d: threefry.uniform(
                key, shape, torch.float64, d).view(torch.int64))):
        if not torch.equal(fn("cuda").cpu(), fn("cpu")):
            raise AssertionError(f"threefry {what}: the card's draw is not "
                                 "the CPU's")
    print(f"threefry: bits (32 and 64) and uniforms (float32, float64) of "
          f"one key, shape {shape}, equal bit for bit on the card and the "
          "CPU")


def fix_phases(sim, phases, steps):
    """Run `steps` more steps of a Simulation with the module functions
    `phases` (DensePhases) and the Runner's post_force and end_of_step
    (the fixes' hooks, composed) timed by CUDA events: ms a step of each,
    the hooks as "post_force" and "end_of_step"."""
    import torch

    runner, events = sim.runner, {}
    saved = {k: getattr(runner, k) for k in ("post_force", "end_of_step")}

    def timed(name, fn):
        def wrapped(*a):
            e0, e1 = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            e0.record()
            out = fn(*a)
            e1.record()
            events.setdefault(name, []).append((e0, e1))
            return out
        return wrapped

    for name, fn in saved.items():
        if fn is not None:
            setattr(runner, name, timed(name, fn))
    try:
        with DensePhases(phases) as ph:
            sim.sys, sim.res, sim.nlist, sim.istate = runner.run(
                sim.sys, sim.res, sim.nlist, sim.istate, steps)
            ms = {k: v for k, v in ph.ms(steps).items() if v}
    finally:
        for name, fn in saved.items():
            setattr(runner, name, fn)
    for name, evs in events.items():
        ms[name] = sum(a.elapsed_time(b) for a, b in evs) / steps
    return ms


def chain_paths(launches, reset_counts, read_counts):
    """Paths U and U64: bench/in.chain from a LAMMPS script (module
    docstring).  Each sets launches[path]."""
    import torch

    from lidp_tpu_torch.__main__ import main as cli
    from lidp_tpu_torch.io.script import LammpsScript

    work = tempfile.mkdtemp(prefix="chip_smoke_chain_")
    try:
        chain_script_case(work)
        in_u = os.path.join(work, "in.chain")
        # path U: as published, through the CLI's main() in this process
        log_u = os.path.join(work, "log.chain")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        cli(["-in", in_u, "-log", log_u, "--f32"])
        launches["U"] = read_counts()
        peak = torch.cuda.max_memory_allocated()
        check_counts("U", launches["U"], {})
        with open(log_u) as fh:
            logU = fh.read().splitlines()
        rowsU = log_rows(logU)
        print(f"path U: `python -m lidp_tpu_torch -in in.chain --f32` "
              f"(bench/in.chain verbatim on chain_script_case: 320 chains of "
              f"100 beads), {len(rowsU)} rows:")
        for line in logU:
            print(f"  U| {line}")
        if [int(r["step"]) for r in rowsU] != [0, U_STEPS]:
            raise AssertionError(f"path U: rows {rowsU}")
        check_rows_finite("U", rowsU, CHAIN_COLS)
        script_peak("U", logU, U_STEPS, peak)

        # U's phases: the same input in float32, set up, then timed steps
        with open(os.path.join(work, "in.u0"), "w") as fh:
            fh.write(chain_text(100, 0))
        script = LammpsScript(dtype=torch.float32, log=lambda line: None)
        script.file(os.path.join(work, "in.u0"))
        sim = script._sim
        route = script_route(script)
        print(f"path U: {sim.natoms} atoms, {len(script._bonds)} bonds, "
              f"float32: {route}")
        if not route.endswith("pair route cell_pair_forces"):
            raise AssertionError(f"path U: {route}")
        ms = fix_phases(sim, CHAIN_PHASES, U_PHASE_STEPS)
        print(f"path U phases, ms a step by CUDA events over "
              f"{U_PHASE_STEPS} steps: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in ms.items())
              + f" (post_force: fix langevin's hook, its stream and "
              f"friction; {smi_line()})")
        del script, sim
        torch.cuda.empty_cache()

        # path U64: float64, a row each step
        with open(os.path.join(work, "in.u64"), "w") as fh:
            fh.write(chain_text(1, "${nstep}"))
        logs = []
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        script = LammpsScript(dtype=torch.float64, log=logs.append)
        script.variables["nstep"] = str(U64_STEPS)
        script.file(os.path.join(work, "in.u64"))
        launches["U64"] = read_counts()
        peak = torch.cuda.max_memory_allocated()
        check_counts("U64", launches["U64"], {})
        print(f"path U64: in.chain in float64, a row each step, "
              f"{U64_STEPS} steps: {script_route(script)}; its log:")
        for line in logs:
            print(f"  U64| {line}")
        rows = script.thermo_rows
        check_rows_finite("U64", rows, CHAIN_COLS)
        script_peak("U64", logs, U64_STEPS, peak)
        worst = rows_agree("U step 0 vs U64", rowsU[:1], rows[:1],
                           [2e-4], CHAIN_COLS)
        print(f"path U step 0 (float32) vs U64's: {worst:.3g} of the bar "
              "(rel 2e-4 of max(1, |value|))")
        cancel = dict(cancelled(script._sim))
        cancel["epair"] = cancel["evdwl"] + cancel["ecoul"]
        defer_twin("U64", work, "in.u64", MOD_TWIN_STEPS,
                   twin_check("U64", (rows, None), CHAIN_COLS,
                              cancel=cancel), cost=40.0)
        del script
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)


def modifier_paths(launches, reset_counts, read_counts):
    """Paths V and W: the modifier fixes on the cell grid and the rescale
    thermostats and the stream on the dense route (module docstring).
    Each sets launches[path]."""
    import torch

    from lidp_tpu_torch.io.script import LammpsScript

    for path, nstep in (("V", V_STEPS), ("W", W_STEPS)):
        work = tempfile.mkdtemp(prefix="chip_smoke_mod_")
        try:
            if path == "V":
                fluid_script_case(work, n_side=N_SIDE)
                text = modifier_script()
            else:
                text = thermostat_melt_script()
            with open(os.path.join(work, f"in.{path}"), "w") as fh:
                fh.write(text)
            logs = []
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            script = LammpsScript(dtype=torch.float64, log=logs.append)
            script.variables["nstep"] = str(nstep)
            script.file(os.path.join(work, f"in.{path}"))
            launches[path] = read_counts()
            peak = torch.cuda.max_memory_allocated()
            check_counts(path, launches[path], {})
            sim = script._sim
            cells = sim.runner.neighbor_cfg is not None
            if cells != (path == "V") or (cells and bool(sim.nlist.overflow)):
                raise AssertionError(f"path {path}: {script_route(script)}")
            fixes = [f"{f.style} on {f.group}" for f in script.fixes.values()
                     if f.style != "nve"]
            print(f"path {path}: {sim.natoms} atoms, float64, {nstep} steps, "
                  f"fix nve with " + ", ".join(fixes) + f": "
                  f"{script_route(script)}; every_step_ev "
                  f"{sim.runner.every_step_ev}; its log:")
            for line in logs:
                print(f"  {path}| {line}")
            rows = script.thermo_rows
            cols = [c for c in script.thermo_columns if c != "step"]
            check_rows_finite(path, rows, cols)
            script_peak(path, logs, nstep, peak)
            ms = fix_phases(sim, V_PHASES if cells else DENSE_PHASES,
                            EXTRA_STEPS)
            print(f"path {path} phases, ms a step by CUDA events over "
                  f"{EXTRA_STEPS} more steps: " + ", ".join(
                      f"{k} {v:.4f}" for k, v in ms.items())
                  + f" (post_force, end_of_step: the fixes' hooks; "
                  f"{smi_line()})")
            cancel = dict(cancelled(sim)) if cells else None
            defer_twin(path, work, f"in.{path}", MOD_TWIN_STEPS,
                       twin_check(path, (rows, None), cols, cancel=cancel),
                       cost=60.0 if cells else 20.0)
            del script, sim
            torch.cuda.empty_cache()
        finally:
            shutil.rmtree(work, ignore_errors=True)
    stream_on_both_devices()


# paths X, X64, Y and Z: bench/in.eam (EAM_SCRIPT on eam_funcfl_case)
# and the setfl styles on eam_setfl_case
X_STEPS = 100                  # in.eam's own run
X_PHASE_STEPS = 20             # the steps X's phases are timed over
X64_STEPS = 20                 # X64, a row each step
YZ_STEPS = 10                  # Y and Z, a row each step
EAM_TWIN_STEPS = 2             # their CPU twins' steps: rows 0-2 compared
EAM_CONSERVE = 2e-4            # X64's TotEng bar (tests/test_eam_bench.py)
# the phases timed on X (DensePhases): the whole EAM term, the embedding
# and the force pass; the density pass is the rest of the whole
EAM_PHASES = (("eam", "eam", "eam_cell_forces"),
              ("embedding", "eam", "_embedding"),
              ("force pass", "eam", "_force_pass"))
# Z's region: in.eam's 20^3 scaled to 10^3 (4,000 atoms) by its index
# variables x, y and z, written into the script so that its CPU twin
# runs the same size
Z_SCALE = "0.5"


def eam_text(text, every, run, scale="1"):
    """An EAM script with a row every `every` steps, `run <run>` and its
    region scaled by `scale` (its x, y, z index variables)."""
    return text.replace("thermo\t\t50", f"thermo {every}").replace(
        "run\t\t100", f"run {run}").replace("index 1\n",
                                            f"index {scale}\n")


def eam_script_run(path, work, name, text, steps):
    """`text` (written to work/name, its `run ${nstep}`) through
    LammpsScript in float64 on the card for `steps` steps: (script, log
    lines, peak memory)."""
    import torch

    from lidp_tpu_torch.io.script import LammpsScript

    with open(os.path.join(work, name), "w") as fh:
        fh.write(text)
    logs = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    script = LammpsScript(dtype=torch.float64, log=logs.append)
    script.variables["nstep"] = str(steps)
    script.file(os.path.join(work, name))
    peak = torch.cuda.max_memory_allocated()
    print(f"path {path}: {script._sim.natoms} atoms, float64, {steps} "
          f"steps: {script_route(script)}; its log:")
    for line in logs:
        print(f"  {path}| {line}")
    check_rows_finite(path, script.thermo_rows, CHAIN_COLS)
    script_peak(path, logs, steps, peak)
    return script, logs, peak


def check_eam_route(path, script, route):
    from lidp_tpu_torch.forcefield import pair_route

    sim = script._sim
    got = pair_route(sim.sys, sim.runner.ff, sim.nlist.nlist)
    if got != route or sim.runner.ff.pair is not None \
            or bool(sim.nlist.overflow):
        raise AssertionError(f"path {path}: {script_route(script)}")


def eam_paths(launches, reset_counts, read_counts):
    """Paths X, X64, Y and Z: bench/in.eam and the setfl styles from a
    LAMMPS script (module docstring).  Each sets launches[path]."""
    import torch

    from lidp_tpu_torch.__main__ import main as cli
    from lidp_tpu_torch.io.script import LammpsScript

    work = tempfile.mkdtemp(prefix="chip_smoke_eam_")
    try:
        eam_funcfl_case(work)
        eam_setfl_case(work)
        eam_setfl_case(work, fs=True)
        in_x = os.path.join(work, "in.eam")
        with open(in_x, "w") as fh:
            fh.write(EAM_SCRIPT)
        # path X: as published, through the CLI's main() in this process
        log_x = os.path.join(work, "log.eam")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        cli(["-in", in_x, "-log", log_x, "--f32"])
        launches["X"] = read_counts()
        peak = torch.cuda.max_memory_allocated()
        check_counts("X", launches["X"], {})
        with open(log_x) as fh:
            logX = fh.read().splitlines()
        rowsX = log_rows(logX)
        print(f"path X: `python -m lidp_tpu_torch -in in.eam --f32` "
              f"(bench/in.eam verbatim but for the potential, "
              f"{EAM_FILE} from eam_funcfl_case), {len(rowsX)} rows:")
        for line in logX:
            print(f"  X| {line}")
        if [int(r["step"]) for r in rowsX] != [0, 50, X_STEPS]:
            raise AssertionError(f"path X: rows {rowsX}")
        check_rows_finite("X", rowsX, CHAIN_COLS)
        # loop geom draws bit-exact RanPark velocities on the host: Temp
        # 1600 at step 0, to float32's rounding here (path L's bar for
        # in.lj's temp) and at rel 1e-9 in X64
        check_rel("X step 0 temp", rowsX[0]["temp"], 1600.0, 1e-6)
        script_peak("X", logX, X_STEPS, peak)

        # X's phases: the same input in float32, set up, then timed steps
        with open(os.path.join(work, "in.x0"), "w") as fh:
            fh.write(eam_text(EAM_SCRIPT, 50, 0))
        script = LammpsScript(dtype=torch.float32, log=lambda line: None)
        script.file(os.path.join(work, "in.x0"))
        sim = script._sim
        check_eam_route("X", script, "eam_cell_forces")
        print(f"path X: {sim.natoms} atoms, float32: {script_route(script)}")
        ms = fix_phases(sim, EAM_PHASES, X_PHASE_STEPS)
        ms["density pass"] = ms["eam"] - ms["embedding"] - ms["force pass"]
        print(f"path X phases, ms a step by CUDA events over "
              f"{X_PHASE_STEPS} more steps: the EAM term {ms['eam']:.4f} "
              f"(density pass {ms['density pass']:.4f}, embedding "
              f"{ms['embedding']:.4f}, force pass {ms['force pass']:.4f}; "
              f"the density pass is the term less the other two); "
              f"{smi_line()}")
        del script, sim
        torch.cuda.empty_cache()

        # path X64: float64, a row each step
        reset_counts()
        script, logs, _ = eam_script_run(
            "X64", work, "in.x64", eam_text(EAM_SCRIPT, 1, "${nstep}"),
            X64_STEPS)
        launches["X64"] = read_counts()
        check_counts("X64", launches["X64"], {})
        check_eam_route("X64", script, "eam_cell_forces")
        rows = script.thermo_rows
        check_rel("X64 step 0 temp", rows[0]["temp"], 1600.0, 1e-9)
        worst = rows_agree("X step 0 vs X64", rowsX[:1], rows[:1], [2e-4],
                           CHAIN_COLS)
        print(f"path X step 0 (float32) vs X64's: {worst:.3g} of the bar "
              "(rel 2e-4 of max(1, |value|))")
        e0 = rows[0]["etotal"]
        drift = max(abs(r["etotal"] - e0) for r in rows) / abs(e0)
        print(f"path X64: TotEng within {drift:.3e} of step 0's, relative, "
              f"over {X64_STEPS} steps (bar {EAM_CONSERVE:g})")
        if not drift < EAM_CONSERVE:
            raise AssertionError(f"path X64: TotEng drift {drift}")
        defer_twin("X64", work, "in.x64", EAM_TWIN_STEPS,
                   twin_check("X64", (rows, None), CHAIN_COLS), threads=2,
                   cost=80.0)
        del script
        torch.cuda.empty_cache()

        # paths Y and Z: eam/alloy at X's size, eam/fs at 4,000 atoms
        for path, fs, scale in (("Y", False, "1"), ("Z", True, Z_SCALE)):
            reset_counts()
            script, _, _ = eam_script_run(
                path, work, f"in.{path}",
                eam_text(eam_alloy_script(fs=fs), 1, "${nstep}", scale),
                YZ_STEPS)
            launches[path] = read_counts()
            check_counts(path, launches[path], {})
            check_eam_route(path, script, "eam_alloy_cell_forces")
            types = script._sim.sys.type
            print(f"path {path}: {int((types == 2).sum())} of "
                  f"{script._sim.natoms} atoms of type 2 (Al) by `set "
                  f"type/fraction`")
            defer_twin(path, work, f"in.{path}", EAM_TWIN_STEPS,
                       twin_check(path, (script.thermo_rows, None),
                                  CHAIN_COLS),
                       threads=2 if path == "Y" else 1,
                       cost=100.0 if path == "Y" else 10.0)
            del script
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from lidp_tpu_torch.kernels import build
    from lidp_tpu_torch.models import lj_melt, polar_bench
    from lidp_tpu_torch.ops import cell_kernels, panel
    from lidp_tpu_torch.box import Box, wrap
    from lidp_tpu_torch.forcefield import pair_route
    from lidp_tpu_torch.ops.cells import build_cells, cell_pair_forces
    from lidp_tpu_torch.thermo import thermo_row

    smi = smi_line()
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, "
          f"device {torch.cuda.get_device_name(0)}")
    wrappers = {**panel.WRAPPERS, **cell_kernels.WRAPPERS}
    if sorted(ALL_KERNELS) != sorted(wrappers):
        raise AssertionError("the kernel table does not list every wrapper")

    # 2. build
    t0 = time.perf_counter()
    build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    print(build.report())

    # 3. kernel parity and timing
    sysd = polar_bench.synthetic_system()
    ff = polar_bench.synthetic_forcefield(sysd, torch.float32, "cuda")
    results = {}
    cases = {"main": make_case(10_125, 12_288, 60.0, seed=1),
             "ragged": make_case(1_000, 1_000, 28.0, seed=2, n_masked=50)}
    for cname, c in cases.items():
        npad = c["x"].shape[0]
        c64 = to_f64(c)
        calls = kernel_calls(c, c64, ff.pair, ff.polar)
        plain_ms = {}
        for label, (name, kern, plain, same_as, bound) in calls.items():
            f64 = KERNELS[name][2]
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            err, scale = compare(f"{label}[{cname}]", got, ref, f64)
            if not same_bits(got, kern()):
                raise AssertionError(f"{label}[{cname}]: a repeated launch "
                                     f"differs")
            if same_as is not None and \
                    not same_bits(got, calls[same_as][1]()):
                raise AssertionError(f"{label}[{cname}]: the exact skips "
                                     f"changed the result")
            line = (f"parity {label}[{cname}] ok: max abs err {err:.3e} "
                    f"of max |ref| {scale:.3e}, repeats bit-identical")
            if same_as is not None:
                line += f", same bits as {same_as}"
            if isinstance(got, tuple):
                line += (f", scalars at {scalar_margin(got, ref, f64):.3g} "
                         f"of their bar")
            del got, ref
            if cname == "main":
                ms = cuda_ms(kern, reps=20)
                qms = cuda_ms_queued(kern, reps=20)
                # a variant that must give its form's bits shares its plain
                # version, timed once
                pms = plain_ms.get(same_as) or cuda_ms(plain, reps=3,
                                                        warmup=1)
                plain_ms[label] = pms
                flops = {"pair_panel_df[no field]": 70}.get(
                    label.replace("strip form, ", "").replace(
                        "no skip, ", "").replace("no cull, ", ""))
                bms, by = bound_ms(name, npad, npad, flops)
                r = dict(max_abs_err=err, ms=ms, ms_queued=qms, plain_ms=pms,
                         bound_ms=bms, bound_by=by)
                if bound is not None:
                    r["bound_ms_cost_estimate"] = bms
                    bms, by, cnt = bound()
                    r.update(bound_ms=bms, bound_by=by, **cnt)
                if label == name:
                    results[name] = r
                else:
                    results[name].setdefault("variants", {})[label] = r
                line += (f", kernel {ms:.4f} ms ({qms:.4f} queued), plain "
                         f"{pms:.3f} ms, bound {bms:.4f} ms ({by})")
            print(line)
        for d in (c, c64):
            if cname == "main":
                skip_share(f"eind {d['x'].dtype} main case", d["x"],
                           d["alpha"], d["mu"], d["L"], ff.polar.polar_damp,
                           forms=("whole", "strip"))
            name = "dipole_panel_df" if d is c64 else "dipole_panel"
            share = dipole_skip_share(
                f"{d['x'].dtype} {cname} case", d, ff.pair.cut_coulsq,
                ff.pair.qqrd2e, ff.polar.polar_damp, ff.polar.damping_type)
            if cname == "main":
                results[name]["skip_share"] = share
            for name, wolf in ((("pair_panel_df", True),
                                ("pair_panel_df[no field]", False))
                               if d is c64 else
                               (("pair_wolf_panel", True),
                                ("pair_panel", False), ("wolf_panel", True))):
                share = pair_skip_share(f"{name} {cname} case", d, ff.pair,
                                        wolf, name == "wolf_panel")
                if cname == "main":
                    r = results[name.split("[")[0]]
                    if "[" in name:
                        r = r["variants"][name]
                    r["skip_share"] = share
        if cname == "main":
            partial_buffers(c64, ff.pair, ff.polar.polar_damp, c)
        del calls, c64
    del cases
    cutoff_pairs_parity(ff.pair)
    dipole_cutoff_parity(ff.pair, ff.polar)
    torch.cuda.empty_cache()

    # 4. the main paths: every counter to 0 just before, read just after
    whole_form = (panel.eind_panel, panel.eind_panel_df, panel.dipole_panel,
                  panel.dipole_panel_df, panel.pair_wolf_panel,
                  panel.pair_panel, panel.pair_panel_df, panel.wolf_panel)

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0
        for w in whole_form:
            w.launches_strip = 0
        torch.cuda.synchronize()

    def check_whole(path):
        """Paths A-D evaluate the whole block: the eind, dipole, pair and
        wolf wrappers launch their whole-panel kernels, never the strip
        kernels (so path B's wolf_panel launches, counted, are all of the
        whole kernel)."""
        strip = {w.__name__: w.launches_strip for w in whole_form}
        if any(strip.values()):
            raise AssertionError(f"path {path}: strip kernel launches "
                                 f"{strip}")
        print(f"path {path} strip-kernel launches: {strip}")

    def read_counts():
        torch.cuda.synchronize()
        return {name: wrappers[name].launches for name in ALL_KERNELS}

    launches = {}

    # path A: float32 fused step
    bench = polar_bench.build_synthetic()
    n = bench.natoms
    reset_counts()
    t0 = time.perf_counter()
    fA, enA = polar_bench.setup_forces(bench)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    fA = fA.clone()
    t0 = time.perf_counter()
    _, per_step = polar_bench.run(bench, NSTEPS)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches["A"] = read_counts()
    print(f"path A: {n} atoms (npad {bench.npad}), float32, fused step")
    energy_row("A step 0 (init)", enA)
    for k, en in enumerate(per_step, 1):
        energy_row(f"A step {k}", en)
    check_finite("A", bench)
    scf = [enA["scf_iters"]] + [en["scf_iters"] for en in per_step]
    check_counts("A", launches["A"], dict(
        eind_panel=sum(it + 1 for it in scf), pair_wolf_panel=NSTEPS + 1,
        dipole_panel=NSTEPS + 1))
    check_whole("A")
    steps_per_s = NSTEPS / t_run
    print(f"path A: init {t_init * 1e3:.1f} ms; {NSTEPS} steps in "
          f"{t_run:.3f} s = {steps_per_s:.3f} steps/s; mean scf_iters "
          f"{statistics.mean(scf[1:]):.2f}")
    per_step_ms = {name: results[name]["ms"] * cnt / (NSTEPS + 1)
                   for name, cnt in launches["A"].items() if cnt}
    print("path A kernel ms per step (kernel ms x launches / evaluations): "
          + ", ".join(f"{k} {v:.3f}" for k, v in per_step_ms.items())
          + f"; step {1e3 / steps_per_s:.3f} ms")
    fluid_skip_share("path A, step 20", bench)
    del bench, per_step

    # path B: float32 host phases, pure CG
    bench = polar_bench.build_synthetic()
    reset_counts()
    t0 = time.perf_counter()
    fB, enB = polar_bench.host_setup_forces(bench, mixed=False)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    fB = fB.clone()
    t0 = time.perf_counter()
    per_step = [polar_bench.host_cg_step(bench, mixed=False)[1]
                for _ in range(HOST_STEPS)]
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches["B"] = read_counts()
    print("path B: float32, host phases (HostPolarForces), pure CG")
    energy_row("B step 0 (init)", enB)
    for k, en in enumerate(per_step, 1):
        energy_row(f"B step {k}", en)
    check_finite("B", bench)
    evals = [enB] + per_step
    if not all(en["scf_converged"] for en in evals):
        raise AssertionError("path B: an SCF solve did not converge")
    scf = [en["scf_iters"] for en in evals]
    check_counts("B", launches["B"], dict(
        pair_panel=len(evals), wolf_panel=len(evals),
        eind_panel=sum(it + 1 for it in scf), dipole_panel=len(evals)))
    check_whole("B")
    steps_per_s_B = HOST_STEPS / t_run
    print(f"path B: init {t_init * 1e3:.1f} ms; {HOST_STEPS} steps in "
          f"{t_run:.3f} s = {steps_per_s_B:.3f} steps/s; scf_iters {scf}")
    for k in ("evdwl", "ecoul", "elong", "epol"):
        a, b = float(enB[k]), float(enA[k])
        print(f"path B step 0 {k}: host phases {a:.6f}, fused {b:.6f}")
        if abs(a - b) > 1e-5 * abs(b):
            raise AssertionError(f"path B step 0 {k}: {a} vs path A {b}")
    ferr = (fB[:n] - fA[:n]).abs()
    fmax = float(fA[:n].abs().max())
    if bool((ferr > 5e-4 * fA[:n].abs() + 5e-5 * fmax).any()):
        raise AssertionError(f"path B step 0 forces vs path A: max abs err "
                             f"{float(ferr.max()):.3e} (max |f| {fmax:.3e})")
    print(f"path B step 0 forces vs path A: max abs err "
          f"{float(ferr.max()):.3e} of max |f| {fmax:.3e}")
    print(f"steps_per_s_B {steps_per_s_B:.4f}")
    del bench, per_step, fB
    torch.cuda.empty_cache()

    # path C: float64 at 1e-11, host phases, mixed-precision solve
    kw64 = dict(dtype=torch.float64, precision=1e-11)
    bench = polar_bench.build_synthetic(**kw64)
    reset_counts()
    t0 = time.perf_counter()
    fC, enC = polar_bench.host_setup_forces(bench, mixed=True)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    fC, muC = fC.clone(), bench.arrays["mu"].clone()
    outer = [bench.hpf.outer_passes]
    inner = [sum(bench.hpf.inner_iters)]
    per_step = []
    t0 = time.perf_counter()
    for _ in range(HOST_STEPS):
        per_step.append(polar_bench.host_cg_step(bench, mixed=True)[1])
        outer.append(bench.hpf.outer_passes)
        inner.append(sum(bench.hpf.inner_iters))
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches["C"] = read_counts()
    print("path C: float64, polar_precision 1e-11, host phases, mixed "
          "solve")
    energy_row("C step 0 (init)", enC)
    for k, en in enumerate(per_step, 1):
        energy_row(f"C step {k}", en)
    check_finite("C", bench)
    evals = [enC] + per_step
    if not all(en["scf_converged"] for en in evals):
        raise AssertionError("path C: an SCF solve did not converge")
    scf = [en["scf_iters"] for en in evals]
    # outer and inner are the loops' own counts; scf_iters is held to them
    if scf != [k + 2 * o for k, o in zip(inner, outer)]:
        raise AssertionError(f"path C: scf_iters {scf} is not inner {inner} "
                             f"+ 2 x outer {outer}")
    check_counts("C", launches["C"], dict(
        pair_panel_df=len(evals), eind_panel_df=sum(outer),
        eind_panel=sum(inner), dipole_panel_df=len(evals)))
    check_whole("C")
    steps_per_s_C = HOST_STEPS / t_run
    print(f"path C: init {t_init * 1e3:.1f} ms; {HOST_STEPS} steps in "
          f"{t_run:.3f} s = {steps_per_s_C:.3f} steps/s; scf_iters {scf}, "
          f"outer float64 passes {outer}, inner float32 iterations {inner}; "
          f"host reads per step: {statistics.mean(inner[1:]):.1f} in the "
          f"inner CG + {statistics.mean(outer[1:]):.1f} outer")
    print(f"path C: mean scf_iters per step {statistics.mean(scf[1:]):.2f}")
    print(f"steps_per_s_C {steps_per_s_C:.4f}")
    fluid_skip_share("path C, step 5", bench)
    del bench, per_step
    torch.cuda.empty_cache()

    # path D: float64 fused step, initial forces only
    bench = polar_bench.build_synthetic(**kw64)
    reset_counts()
    t0 = time.perf_counter()
    fD, enD = polar_bench.setup_forces(bench)
    torch.cuda.synchronize()
    t_D = time.perf_counter() - t0
    launches["D"] = read_counts()
    muD = bench.arrays["mu"]
    energy_row("D step 0 (init)", enD)
    check_counts("D", launches["D"], dict(
        pair_panel_df=1, eind_panel_df=enD["scf_iters"] + 1,
        dipole_panel_df=1))
    check_whole("D")
    print(f"path D: float64 fused step, pure CG through eind_panel_df: "
          f"{t_D:.4f} s for the initial forces, scf_iters "
          f"{enD['scf_iters']}")
    print(f"seconds_D {t_D:.4f}")
    del bench

    # step 0 of A, C and D against the float64 plain path on the card
    ref = polar_bench.build_synthetic(panel="scan", **kw64)
    t0 = time.perf_counter()
    f64, en64 = polar_bench.setup_forces(ref)
    torch.cuda.synchronize()
    print(f"float64 plain path (panel='scan', pure CG at 1e-11): "
          f"{time.perf_counter() - t0:.3f} s, scf_iters "
          f"{en64['scf_iters']}")
    mu64 = ref.arrays["mu"]
    for k in ("evdwl", "ecoul", "elong", "epol"):
        a, b = float(enA[k]), float(en64[k])
        tol = 2e-2 if k == "epol" else 1e-4 * abs(b)
        print(f"path A step 0 {k}: f32 kernels {a:.6f}, f64 plain {b:.6f}")
        if abs(a - b) > tol:
            raise AssertionError(f"path A step 0 {k}: {a} vs float64 {b}")
    fref = f64[:n]
    ferr = (fA[:n].double() - fref).abs()
    fmax = float(fref.abs().max())
    if bool((ferr > 5e-4 * fref.abs() + 5e-5 * fmax).any()):
        raise AssertionError(f"path A step 0 forces vs float64: max abs err "
                             f"{float(ferr.max()):.3e} (max |f| {fmax:.3e})")
    print(f"path A step 0 forces vs float64 plain: max abs err "
          f"{float(ferr.max()):.3e} of max |f| {fmax:.3e}")
    check_f64_step0("C", n, fC, muC, enC, f64, mu64, en64)
    check_f64_step0("D", n, fD, muD, enD, f64, mu64, en64)
    if abs(enD["scf_iters"] - en64["scf_iters"]) > 1:
        raise AssertionError(f"path D scf_iters {enD['scf_iters']} vs plain "
                             f"{en64['scf_iters']}")
    print(f"steps_per_s {steps_per_s:.4f}")
    del fC, muC, fD, muD, fA
    torch.cuda.empty_cache()

    # path G: the fluid as 3,375 rigid molecules (fix rigid/nve molecule)
    # through FastPolarRunner, float32, fused
    bench = polar_bench.build_rigid()
    if bench.runner.mode != "fused":
        raise AssertionError(f"path G: runner mode {bench.runner.mode}")
    reset_counts()
    t0 = time.perf_counter()
    rowG0 = polar_bench.setup_rigid(bench)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    sysG0, resG0, _ = bench.state
    xqG0 = rigid_xq(bench.state, n)
    t0 = time.perf_counter()
    rowsG = polar_bench.run_rigid(bench, G64_STEPS)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    xqG3 = rigid_xq(bench.state, n)
    t0 = time.perf_counter()
    rowsG += polar_bench.run_rigid(bench, NSTEPS - G64_STEPS)
    torch.cuda.synchronize()
    t_run += time.perf_counter() - t0
    launches["G"] = read_counts()
    print(f"path G: {n} atoms as {bench.setup.nbody} rigid bodies (npad "
          f"{bench.npad}), float32, FastPolarRunner fused; thermo dof "
          f"{bench.thermo.dof:g}")
    for k, row in enumerate([rowG0] + rowsG):
        thermo_line(f"G step {k}", row)
    check_rigid("G", bench, sysG0, rowsG)
    scf = [rowG0["scf_iters"]] + [r["scf_iters"] for r in rowsG]
    check_counts("G", launches["G"], dict(
        eind_panel=sum(it + 1 for it in scf), pair_wolf_panel=NSTEPS + 1,
        dipole_panel=NSTEPS + 1))
    check_whole("G")
    steps_per_s_G = NSTEPS / t_run
    drift = rowsG[-1]["etotal"] - rowG0["etotal"]
    print(f"path G: init {t_init * 1e3:.1f} ms; {NSTEPS} steps in "
          f"{t_run:.3f} s = {steps_per_s_G:.3f} steps/s "
          f"({1e3 * t_run / NSTEPS:.3f} ms/step); etotal drift over "
          f"{NSTEPS} steps {drift:.6f} ({drift / abs(rowG0['etotal']):.3e} "
          f"of |etotal|)")
    enG = dict(evdwl=resG0.evdwl, ecoul=resG0.ecoul, elong=resG0.elong,
               epol=resG0.epol)
    for k in ("evdwl", "ecoul", "elong", "epol"):
        a, b = float(enG[k]), float(en64[k])
        tol = 2e-2 if k == "epol" else 1e-4 * abs(b)
        print(f"path G step 0 {k}: f32 kernels {a:.6f}, f64 plain {b:.6f}")
        if abs(a - b) > tol:
            raise AssertionError(f"path G step 0 {k}: {a} vs float64 {b}")
    fref = f64[:n]
    ferr = (resG0.f[:n].double() - fref).abs()
    fmax = float(fref.abs().max())
    if bool((ferr > 5e-4 * fref.abs() + 5e-5 * fmax).any()):
        raise AssertionError(f"path G step 0 forces vs float64: max abs err "
                             f"{float(ferr.max()):.3e} (max |f| {fmax:.3e})")
    print(f"path G step 0 forces vs float64 plain: max abs err "
          f"{float(ferr.max()):.3e} of max |f| {fmax:.3e}")
    parts, wall = rigid_share(bench, SHARE_STEPS)
    total = sum(parts.values())
    print(f"path G step parts by CUDA events ({SHARE_STEPS} steps, each "
          f"synchronised; {wall:.3f} ms/step by the host clock): "
          + ", ".join(f"{k} {v:.3f} ms ({100 * v / total:.1f}%)"
                      for k, v in parts.items())
          + f"; rigid integrator {parts['initial'] + parts['final']:.3f} "
          f"ms/step = {100 * (parts['initial'] + parts['final']) / total:.1f}"
          f"% of {total:.3f}")
    print(f"steps_per_s_G {steps_per_s_G:.4f}")
    rowsG_all = [rowG0] + rowsG
    del bench, sysG0, resG0, rowsG, ref, f64, mu64
    torch.cuda.empty_cache()

    # path G64: the same bodies in float64 at polar_precision 1e-11, host
    # mode (mixed solve, dipole predictor), against the plain route
    saved_mode = os.environ.get("LIDP_FAST_POLAR_MODE")
    os.environ["LIDP_FAST_POLAR_MODE"] = "host"
    try:
        bench = polar_bench.build_rigid(**kw64)
        plain = polar_bench.build_rigid(panel="scan", **kw64)
    finally:
        if saved_mode is None:
            os.environ.pop("LIDP_FAST_POLAR_MODE")
        else:
            os.environ["LIDP_FAST_POLAR_MODE"] = saved_mode
    if (bench.runner.mode, plain.runner.mode) != ("host", "host"):
        raise AssertionError("path G64: the runners are not in host mode")
    reset_counts()
    rowsK, statesK, t_run, (outer, inner) = run_rigid_states(bench,
                                                             G64_STEPS)
    launches["G64"] = read_counts()
    print(f"path G64: {n} atoms as {bench.setup.nbody} rigid bodies, "
          f"float64, polar_precision 1e-11, FastPolarRunner host mode "
          f"(mixed solve, predictor order "
          f"{os.environ.get('LIDP_PREDICT', '2')})")
    for k, row in enumerate(rowsK):
        thermo_line(f"G64 step {k}", row)
    scf = sum(r["scf_iters"] for r in rowsK)
    got = launches["G64"]
    # each mixed solve makes inner + 2 x outer scf_iters: one float32 eind
    # launch a sweep and one float64 residual a pass (the loops' counts)
    if not (scf == inner + 2 * outer and outer >= len(rowsK)):
        raise AssertionError(f"path G64: scf_iters {scf} is not inner "
                             f"{inner} + 2 x outer {outer}")
    check_counts("G64", got, dict(
        pair_panel_df=len(rowsK), dipole_panel_df=len(rowsK),
        eind_panel=inner, eind_panel_df=outer))
    check_whole("G64")
    reset_counts()
    rowsP, statesP, t_plain, _ = run_rigid_states(plain, G64_STEPS)
    if any(read_counts().values()):
        raise AssertionError("path G64: the plain route launched a kernel")
    g64_compare(rowsK, rowsP, statesK, statesP, n)
    check_rigid_motion(xqG0, xqG3, rigid_xq(statesP[0], n),
                       rigid_xq(statesP[G64_STEPS], n))
    check_rigid("G64", bench, statesK[0][0], rowsK[1:])
    steps_per_s_G64 = G64_STEPS / t_run
    print(f"path G64: {G64_STEPS} steps in {t_run:.3f} s = "
          f"{steps_per_s_G64:.3f} steps/s ({1e3 * t_run / G64_STEPS:.3f} "
          f"ms/step); plain route {1e3 * t_plain / G64_STEPS:.1f} ms/step")
    print(f"steps_per_s_G64 {steps_per_s_G64:.4f}")
    del bench, plain, statesK, statesP
    torch.cuda.empty_cache()

    # path H: the same fluid from a LAMMPS script and data file through the
    # script front end (io/script.py LammpsScript -> sim.py Simulation ->
    # FastPolarRunner), float64 at 1e-11, fused mode, in this process
    if os.environ.get("LIDP_FAST_POLAR_MODE", "fused") != "fused":
        raise AssertionError("path H runs in fused mode")
    from lidp_tpu_torch.io.script import LammpsScript

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        _, in_fluid = fluid_script_case(work)
        logH = []
        script = LammpsScript(dtype=torch.float64, log=logH.append)
        script.variables.update(prec="1e-11", nstep=str(H_STEPS))
        reset_counts()
        script.file(in_fluid)
        launches["H"] = read_counts()
        rowsH = script.thermo_rows
        print(f"path H: {in_fluid} through LammpsScript, float64, "
              f"precision 1e-11, {H_STEPS} steps; its log:")
        for line in logH:
            print(f"  H| {line}")
        runner = script._sim.runner
        if type(runner).__name__ != "FastPolarRunner" or \
                runner.mode != "fused":
            raise AssertionError(f"path H: runner {type(runner).__name__}")
        steps_per_s_H = H_STEPS / loop_seconds(logH, H_STEPS)
        del script, runner
        torch.cuda.empty_cache()
        # the same system through the Python builder, on the same card
        bench = polar_bench.build_rigid(**kw64)
        reset_counts()
        t0 = time.perf_counter()
        rowsB = [polar_bench.setup_rigid(bench)]
        rowsB += polar_bench.run_rigid(bench, H_STEPS)
        torch.cuda.synchronize()
        t_B = time.perf_counter() - t0
        want = read_counts()
        del bench
        torch.cuda.empty_cache()
        check_counts("H", launches["H"], want)
        if not all(launches["H"][k] for k in ("eind_panel_df",
                                              "pair_panel_df",
                                              "dipole_panel_df")):
            raise AssertionError(f"path H: a float64 kernel was not "
                                 f"launched: {launches['H']}")
        check_whole("H")
        worst = rows_agree("H", rowsH, rowsB, [1e-9] * len(rowsB))
        print(f"path H rows vs build_rigid's over {len(rowsB)} rows: thermo "
              f"columns at {worst:.3g} of their bar (rel 1e-9 of max(1, "
              f"|value|))")
        print(f"steps_per_s_H {steps_per_s_H:.4f} (Loop time); build_rigid "
              f"route {H_STEPS / t_B:.4f} steps/s with its setup "
              f"(host clock)")

        # path H32: the CLI as a user runs it, float32 at 1e-6, 20 steps,
        # in a process of its own, against path G's rows
        cmd = [sys.executable, "-m", "lidp_tpu_torch", "-in", "in.fluid",
               "-log", "log.h32", "--f32", "-var", "prec", "1e-6", "-var",
               "nstep", str(NSTEPS)]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            filter(None, (ROOT, os.environ.get("PYTHONPATH")))))
        t0 = time.perf_counter()
        res = subprocess.run(cmd, cwd=work, env=env, capture_output=True,
                             text=True, timeout=600)
        t_h32 = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"path H32: exit {res.returncode}\n"
                                 f"{res.stdout[-4000:]}\n{res.stderr[-4000:]}")
        with open(os.path.join(work, "log.h32")) as fh:
            logH32 = fh.read().splitlines()
        rowsH32 = log_rows(logH32)
        if len(rowsH32) != NSTEPS + 1:
            raise AssertionError(f"path H32: {len(rowsH32)} thermo rows")
        worst = rows_agree("H32", rowsH32, rowsG_all,
                           [1e-6] + [1e-5] * NSTEPS)
        same = all(f"{r[c]:.8g}" == f"{g[c]:.8g}"
                   for r, g in zip(rowsH32, rowsG_all) for c in G64_COLS)
        print(f"path H32: `{' '.join(cmd[1:])}` exit 0 in {t_h32:.1f} s; "
              f"{len(rowsH32)} logged rows vs path G's at {worst:.3g} of "
              f"their bar (step 0 rel 1e-6, steps 1-{NSTEPS} rel 1e-5 of "
              f"max(1, |value|)); "
              + ("the rows are identical to G's at the printed precision"
                 if same else "the rows differ from G's at the printed "
                 "precision"))
        print("path H32 " + next(line for line in logH32
                                 if line.startswith("Performance:")))
    finally:
        shutil.rmtree(work, ignore_errors=True)

    rowsI = dense_paths(launches, reset_counts, read_counts)
    thermostat_paths(launches, reset_counts, read_counts, rowsI)

    # 5. the LJ melt on the cell engine: path E, kernel parity on its last
    # state, then paths F and E4
    f32 = torch.float32
    melt = lj_melt.build(scale=1, dtype=f32, neighbor="slots")
    msys = melt.system

    # path E: the 32,000-atom melt through SlotRunner
    reset_counts()
    t0 = time.perf_counter()
    sysE, resE, nlE, carry = melt.runner.setup(msys)
    rowE0 = thermo_row(sysE, resE, melt.thermo)
    t_init = time.perf_counter() - t0
    fE0 = resE.f.clone()
    sysE, resE, nlE, carry = melt.runner.run(sysE, resE, nlE, carry,
                                             MELT_STEPS)
    rowE100 = thermo_row(sysE, resE, melt.thermo)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sysE, resE, nlE, carry = melt.runner.run(sysE, resE, nlE, carry,
                                             MELT_WINDOW)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches["E"] = read_counts()
    rowE500 = thermo_row(sysE, resE, melt.thermo)
    cfg = melt.runner.neighbor_cfg
    print(f"path E: {melt.natoms} atoms, float32, SlotRunner, grid "
          f"{cfg.nbins} x cap {cfg.cap}, rebuild every "
          f"{melt.runner.rebuild_every}")
    for tag, row in (("E step 0", rowE0), ("E step 100", rowE100),
                     (f"E step {MELT_STEPS + MELT_WINDOW}", rowE500)):
        melt_row(tag, row)
    if bool(nlE.overflow):
        raise AssertionError("path E: a cell overflowed its capacity")
    if rowE500["step"] != MELT_STEPS + MELT_WINDOW:
        raise AssertionError(f"path E: step {rowE500['step']}")
    for k, (want, rel) in LJ_LOG0.items():
        check_rel(f"path E step 0 {k} vs the reference log", rowE0[k], want,
                  rel)
    check_rel("path E step 100 etotal vs the reference log",
              rowE100["etotal"], *LJ_LOG100_ETOTAL)
    check_counts("E", launches["E"], dict(
        slot_lj_forces=1 + MELT_STEPS + 1 + MELT_WINDOW + 1))
    steps_per_s_E = MELT_WINDOW / t_run
    print(f"path E: setup + row {t_init * 1e3:.1f} ms; {MELT_WINDOW} steps "
          f"in {t_run:.4f} s = {steps_per_s_E:.1f} steps/s "
          f"({1e3 * t_run / MELT_WINDOW:.4f} ms/step)")
    print(f"steps_per_s_E {steps_per_s_E:.4f}")

    # kernel parity: on the melt after path E's steps (wrapped into the box,
    # as a rebuild leaves it), on the ragged case, on a grid whose every
    # slot holds an atom, on the ragged case with each cell's slots in a
    # random order, and on dense grids at the caps where the kernels'
    # launchers change tile: the wide tile's largest, the narrow tile's
    # smallest and largest, and the largest the kernels took before the
    # narrow tile (358)
    melted, _ = wrap(sysE.x, sysE.box, sysE.image)
    rag, full = ragged_lj_case(), full_lj_case()
    keys = ("x", "mask", "box", "pair", "cfg", "n")
    lj_cases = {
        "melt": ((melted, msys.mask, msys.box, melt.runner.ff.pair,
                  melt.runner.neighbor_cfg, melt.natoms), False),
        "ragged": (tuple(rag[k] for k in keys), False),
        "full": (tuple(full[k] for k in keys), False),
        "scattered": (tuple(rag[k] for k in keys), True)}
    caps = {name: tile_caps(name) for name in cell_kernels.WRAPPERS}
    print(f"LJ kernel tiles: largest cap of the wide and the narrow tile "
          f"{caps}")
    for name, (cw, cn) in caps.items():
        for cap in (cw, cw + 1, 358, cn):
            dense = dense_lj_case(cap)
            lj_cases[f"dense cap {cap}"] = (tuple(dense[k] for k in keys),
                                            False)
        over = build_cells(dense["x"], dense["mask"], dense["box"],
                           dataclasses.replace(dense["cfg"], cap=cn + 1))
        try:
            if name == "slot_lj_forces":
                cell_kernels.slot_lj_forces([over.atom_of_slot.float()] * 3,
                                            dense["box"], dense["pair"])
            else:
                cell_kernels.cell_pair_forces_lj(dense["x"], dense["mask"],
                                                 over, dense["box"],
                                                 dense["pair"])
        except ValueError as e:
            print(f"{name} at cap {cn + 1}: raises ValueError ({e})")
        else:
            raise AssertionError(f"{name} took cap {cn + 1}, beyond its "
                                 f"narrow tile's {cn}")
    for cname, (case, scatter) in lj_cases.items():
        box_c, pair_c = case[2], case[3]
        for name, (xs, live, kern, plain, timed) in \
                lj_kernel_calls(*case, scatter=scatter).items():
            shape = tuple(live.shape)
            for need_ev in (False, True):
                got, ref = kern(need_ev), plain(need_ev)
                torch.cuda.synchronize()
                label = f"{name}[{cname}, need_ev={need_ev}]"
                err, scale = lj_compare(label, got, ref, need_ev)
                again = kern(need_ev)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"{label}: a repeated launch "
                                         f"differs")
                line = (f"parity {label} ok on grid {shape}: max abs err "
                        f"{err:.3e} of max |f| {scale:.3e}")
                del got, ref, again
                if cname.startswith("dense"):
                    line += (f", kernel "
                             f"{cuda_ms(lambda: timed(need_ev), reps=5):.4f}"
                             f" ms")
                if cname == "melt":
                    ms = cuda_ms(lambda: timed(need_ev), reps=20)
                    qms = cuda_ms_queued(lambda: timed(need_ev), reps=20)
                    pms = cuda_ms(lambda: plain(need_ev), reps=3, warmup=1)
                    bms, by, tms, cnt = cell_bound_ms(
                        name, xs, live, box_c.lengths.float(),
                        float(pair_c.cut_ljsq[1, 1]), case[5], need_ev)
                    r = dict(max_abs_err=err, ms=ms, ms_queued=qms,
                             plain_ms=pms, bound_ms=bms, bound_by=by,
                             bound_ms_tpu_count=tms, **cnt)
                    if need_ev:
                        results[name]["variants"] = {f"{name}[need_ev]": r}
                    else:
                        results[name] = r
                    line += (f", kernel {ms:.4f} ms ({qms:.4f} queued), "
                             f"plain {pms:.3f} ms, bound {bms:.4f} ms "
                             f"({by}; {cnt['live_pairs']} live pairs, "
                             f"{cnt['cutoff_pairs']} inside the cutoff; "
                             f"the TPU kernel's count {tms:.4f} ms)")
                print(line)
    del lj_cases, rag, full, melted
    overflow_lj_parity()
    torch.cuda.empty_cache()

    # step 0 of E against the float64 plain route on the card
    x64 = msys.x.double()
    box64 = Box(lo=msys.box.lo.double(), hi=msys.box.hi.double())
    cells64 = build_cells(x64, msys.mask, box64, cfg)
    f64, ev64, _, _ = cell_pair_forces(
        x64, msys.q.double(), msys.type, msys.mask, cells64, box64,
        melt.runner.ff.pair)
    fscale = max(float(f64.abs().max()), 1.0)
    ferr = float((fE0.double() - f64).abs().max())
    print(f"path E step 0 forces vs float64 plain: max abs err {ferr:.3e} "
          f"of max(max |f|, 1) {fscale:.3e}")
    if not ferr <= 1e-5 * fscale:
        raise AssertionError(f"path E step 0 forces vs float64: {ferr:.3e}")
    check_rel("path E step 0 evdwl vs float64 plain", rowE0["evdwl"],
              float(ev64) / melt.natoms, 1e-6)
    del x64, cells64, f64, carry

    # path F: the same melt through the generic Runner on cells
    meltF = lj_melt.build(scale=1, dtype=f32, neighbor="cells")
    reset_counts()
    sysF, resF, nlF, ist = meltF.runner.setup(meltF.system)
    rowF0 = thermo_row(sysF, resF, meltF.thermo)
    fF0 = resF.f.clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sysF, resF, nlF, ist = meltF.runner.run(sysF, resF, nlF, ist, MELT_STEPS)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches["F"] = read_counts()
    rowF100 = thermo_row(sysF, resF, meltF.thermo)
    print(f"path F: {meltF.natoms} atoms, float32, Runner on cells, pair "
          f"route {pair_route(sysF, meltF.runner.ff, nlF.nlist)}")
    melt_row("F step 0", rowF0)
    melt_row("F step 100", rowF100)
    if bool(nlF.overflow):
        raise AssertionError("path F: a cell overflowed its capacity")
    check_counts("F", launches["F"], dict(
        cell_pair_forces_lj=1 + MELT_STEPS + 1))
    for k in ("temp", "pe", "etotal", "press"):
        check_rel(f"path F step 0 {k} vs path E", rowF0[k], rowE0[k], 1e-5)
    fscale = max(float(fE0.abs().max()), 1.0)
    ferr = float((fF0 - fE0).abs().max())
    print(f"path F step 0 forces vs path E: max abs err {ferr:.3e} of "
          f"max(max |f|, 1) {fscale:.3e}")
    if not ferr <= 5e-6 * fscale:
        raise AssertionError(f"path F step 0 forces vs path E: {ferr:.3e}")
    check_rel("path F step 100 etotal vs path E", rowF100["etotal"],
              rowE100["etotal"], 1e-4)
    for k in ("temp", "pe"):
        check_rel(f"path F step 100 {k} vs path E", rowF100[k], rowE100[k],
                  2e-3)
    steps_per_s_F = MELT_STEPS / t_run
    print(f"path F: {MELT_STEPS} steps in {t_run:.4f} s = "
          f"{steps_per_s_F:.1f} steps/s")
    print(f"steps_per_s_F {steps_per_s_F:.4f}")
    del meltF, sysF, resF, nlF, ist, melt, sysE, resE
    torch.cuda.empty_cache()

    # path E4: SlotRunner at scale 4
    t0 = time.perf_counter()
    melt4 = lj_melt.build(scale=4, dtype=f32, neighbor="slots")
    t_build = time.perf_counter() - t0
    cfg = melt4.runner.neighbor_cfg
    reset_counts()
    sys4, res4, nl4, carry = melt4.runner.setup(melt4.system)
    row0 = thermo_row(sys4, res4, melt4.thermo)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sys4, res4, nl4, carry = melt4.runner.run(sys4, res4, nl4, carry,
                                              MELT_STEPS)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches["E4"] = read_counts()
    row100 = thermo_row(sys4, res4, melt4.thermo)
    print(f"path E4: {melt4.natoms} atoms (scale 4), float32, SlotRunner, "
          f"grid {cfg.nbins} x cap {cfg.cap}; built on the host in "
          f"{t_build:.1f} s")
    melt_row("E4 step 0", row0)
    melt_row("E4 step 100", row100)
    if bool(nl4.overflow):
        raise AssertionError("path E4: a cell overflowed its capacity")
    check_counts("E4", launches["E4"], dict(
        slot_lj_forces=1 + MELT_STEPS + 1))
    check_rel("path E4 step 0 pe vs the reference log", row0["pe"],
              *LJ_LOG0["pe"])
    check_rel("path E4 step 100 etotal vs the reference log",
              row100["etotal"], LJ_LOG100_ETOTAL[0], 1e-3)
    check_rel("path E4 step 100 etotal vs step 0", row100["etotal"],
              row0["etotal"], 3e-3)
    # the slot kernel at this grid, on the run's last state: against its
    # plain version, need_ev off (the form the steps launch) and on
    pair4, box4 = melt4.runner.ff.pair, sys4.box
    par4 = cell_kernels.lj_par(
        box4, pair4, cell_kernels.sentinel_scalars(box4, pair4)[0])
    grids4 = [carry.x[..., d] for d in range(3)]
    shape4 = tuple(grids4[0].shape)
    live4 = carry.aid < melt4.natoms

    def slot4(fn, need_ev, **kw):
        fg, ev, vir = fn(grids4, box4, pair4, need_ev=need_ev, **kw)
        return torch.stack(list(fg), dim=-1), ev, vir

    for need_ev in (False, True):
        label = f"slot_lj_forces[scale 4, need_ev={need_ev}]"
        got = slot4(cell_kernels.slot_lj_forces, need_ev, par=par4)
        ref = slot4(cell_kernels.slot_lj_forces_plain, need_ev)
        torch.cuda.synchronize()
        err4, scale4 = lj_compare(label, got, ref, need_ev)
        del ref
        again = slot4(cell_kernels.slot_lj_forces, need_ev, par=par4)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{label}: a repeated launch differs")
        del got, again

        def kern4():
            return cell_kernels.slot_lj_forces(grids4, box4, pair4,
                                               need_ev=need_ev, par=par4)

        ms4 = cuda_ms(kern4, reps=10)
        qms4 = cuda_ms_queued(kern4, reps=20)
        pms4 = cuda_ms(lambda: cell_kernels.slot_lj_forces_plain(
            grids4, box4, pair4, need_ev=need_ev), reps=2, warmup=0)
        bms4, by4, tms4, cnt4 = cell_bound_ms(
            "slot_lj_forces", carry.x, live4, box4.lengths.float(),
            float(pair4.cut_ljsq[1, 1]), melt4.natoms, need_ev)
        key = "scale 4, need_ev" if need_ev else "scale 4"
        results["slot_lj_forces"]["variants"][f"slot_lj_forces[{key}]"] = \
            dict(max_abs_err=err4, ms=ms4, ms_queued=qms4, plain_ms=pms4,
                 bound_ms=bms4, bound_by=by4, bound_ms_tpu_count=tms4,
                 **cnt4)
        print(f"parity {label} ok on grid {shape4}: max abs err {err4:.3e} "
              f"of max |f| {scale4:.3e}, kernel {ms4:.4f} ms ({qms4:.4f} "
              f"queued), plain {pms4:.1f} ms, bound {bms4:.4f} ms ({by4}; "
              f"{cnt4['live_pairs']} live pairs, {cnt4['cutoff_pairs']} "
              f"inside the cutoff; the TPU kernel's count {tms4:.4f} ms)")
    torch.cuda.empty_cache()
    steps_per_s_E4 = MELT_STEPS / t_run
    print(f"path E4: {MELT_STEPS} steps in {t_run:.4f} s = "
          f"{steps_per_s_E4:.2f} steps/s "
          f"({1e3 * t_run / MELT_STEPS:.3f} ms/step)")
    print(f"steps_per_s_E4 {steps_per_s_E4:.4f}")
    del melt4, sys4, res4, nl4, carry, grids4, live4
    torch.cuda.empty_cache()

    script_cell_paths(launches, reset_counts, read_counts, steps_per_s_F)
    barostat_paths(launches, reset_counts, read_counts)
    flexible_paths(launches, reset_counts, read_counts)
    chain_paths(launches, reset_counts, read_counts)
    modifier_paths(launches, reset_counts, read_counts)
    eam_paths(launches, reset_counts, read_counts)
    run_twins()

    # 6. results
    total = {name: sum(launches[p][name] for p in launches)
             for name in ALL_KERNELS}
    never = [name for name, cnt in total.items() if cnt == 0]
    if never:
        raise AssertionError(f"kernels no path launched: {never}")
    out = []
    replaced = {**{k: v[0] for k, v in KERNELS.items()}, **CELL_KERNELS}
    for name, replaces in replaced.items():
        r = results[name]
        row = dict(name=name, route="cuda",
                   source=f"lidp_tpu_torch/csrc/{name}.cu",
                   replaces=replaces, launches=total[name],
                   launches_by_path={p: launches[p][name] for p in launches},
                   max_abs_err=r["max_abs_err"], ms=r["ms"],
                   plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                   bound_by=r["bound_by"], library_ms=None)
        for key in ("ms_queued", "bound_ms_cost_estimate",
                    "bound_ms_all_pairs",
                    "bound_ms_tpu_count", "live_pairs", "cutoff_pairs",
                    "geometry_pairs", "active_pairs", "dd_pairs",
                    "damped_pairs", "cd_pairs", "both_pairs", "kept_pairs",
                    "tile_pairs", "kept_tile_pairs", "force_pairs",
                    "lj_pairs", "coul_pairs", "wolf_pairs", "skip_share"):
            if key in r:
                row[key] = r[key]
        if "variants" in r:
            row["variants"] = r["variants"]
        out.append(row)
    print(json.dumps({"kernels": out}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
