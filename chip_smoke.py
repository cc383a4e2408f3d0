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
        mu against its CPU twin (phase 21: the same script through the
        port on the CPU in float64, beside the card's paths): rows within
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
     have CPU twins (phase 17):
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
     each step; CPU twins of 2 steps (phase 17; T's of 1 step, on
     FLEX_T_TWIN_THREADS threads):
     S. examples/peptide's stack on the dense route: 1,920 atoms, `fix
        nvt temp 275 275 100 tchain 1`;
     T. bench/in.rhodo's stack on the cell grid: S's cell replicated 2 x
        2 x 4 (30,720 atoms), `fix npt temp 275 275 100 iso 1 1 1000 mtk
        no pchain 0 tchain 1`;
     each: no launch, its route, steps/s by its Loop time line and its
     peak memory; every row finite, and at every row each SHAKE bond and
     angle within the fix's tolerance (1e-4 relative) of its target
     (ConstraintWatch); rows 0-2 (T's 0-1) against the CPU twin at rel
     1e-9 of max(1, |value|) plus CANCEL_REL of the cancelled magnitude
     on the cell grid; two evaluations of the bonded terms on one state and
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
 11. energy minimization and two dimensions from a LAMMPS script
     (minimize_paths: integrate/minimize.py through minimize, min_style,
     dimension 2, fix enforce2d, displace_atoms; the dense route, no
     launch), each minimize command timed under MinimizeTimer (its
     iterations, force evaluations, iterations/s, ms an evaluation and
     host reads an iteration, synchronized, by the host clock) with the
     path's peak device memory:
     AA. examples/min's in.min verbatim (MIN_SCRIPT: 800 atoms, 2d LJ,
        fix nve + fix enforce2d, run 1000, then minimize with the default
        cg) through the CLI's main(), float64: step 0 against LAMMPS's
        log.5Oct16.min.g++.1 at tests/test_min_example.py's bars, the
        minimized E_pair per atom under -2.6, steps/s by its Loop time
        line; then the same input through LammpsScript with the run and
        the minimization apart: the atoms planar after each (|z|, |v_z|
        under 1e-12), the rows and the minimize line the CLI's; then
        AA-100, in.min with its run cut to 100 steps (the liquid is
        chaotic: run 1000's rows part from another device's), whose rows,
        minimized E and x are held to the CPU twin;
     AB. tests/test_min_styles.py's 72 atoms (displace_atoms random):
        quickmin (500 iterations) and then hftn to that file's goldens
        (rel 1e-7, rel 1e-9), against the CPU twin (E rel 1e-9; hftn's
        iterations at its rounding-set tail not compared), a force
        evaluation and a Hessian-vector product timed warm; cg, sd and fire
        from the same start, 20 iterations each, against their twins
        (iterations equal, E rel 1e-10, x 1e-10 of its largest entry);
     AC. minimize on the polarizable fluid at path I's 1,536 atoms
        (float64, polar precision 1e-11): fire (6 iterations) then cg
        (3), the ms of a force evaluation at the minimized state by CUDA
        events, against the CPU twin;
 12. non-periodic boundaries, walls and regions from a LAMMPS script
     (nonperiodic_paths: LAMMPS's in.crack, in.flow.couette, in.flow.pois
     and in.obstacle as shipped, CRACK_SCRIPT, ..., their runs cut by
     cut_run), each path printing its route, its steps/s by its Loop time
     line, its peak device memory and, over NP_PHASE_STEPS more steps,
     the ms a step of its phases and of the fixes' hooks by CUDA events;
     no launch (the JAX gate refuses a non-periodic box and several atom
     types: the plain cell pass, or the dense route):
     AD. in.crack through the CLI's main(), run 200 (8,141 atoms, 2d,
        boundary s s p, float64, the cell grid): steps 0 and 200 against
        log.5Oct16.crack.g++.1 at tests/test_crack.py's bars, the count of
        its `Created` line, the box reset_box of the last rebuild's
        positions bit for bit (its x and y faces their extent -/+ small,
        z periodic); rows and final x, v against the CPU twin (rel 1e-9,
        1e-8 of max);
     AE. in.flow.couette and in.flow.pois through LammpsScript, run 100
        (420 atoms, boundary p s p, float64, the dense route): step 0
        against log.5Oct16.flow.couette.g++.1 at tests/test_flow.py's
        bars (Poiseuille's Temp and E_pair as that file holds them); rows
        and final x, v against the CPU twins at rel 1e-8;
     AF. in.obstacle through LammpsScript, run 100 (float64, dense): the
        count after delete_atoms in tests/test_obstacle.py's band and the
        twin's, no atom nearer an indenter's centre than 0.55 R (that
        file's bar; the count inside R printed), rows and final x, v
        against the twin at rel 1e-8;
     AG. in.crack on a 4x area (AG_REGION: 32,281 atoms) through the
        CLI's main() with --f32, run 100: the cell grid, the box as AD's
        (at float32's rounding), step 0 against a float64 CPU twin of
        the port at path E's bars (AG_BARS, of max(1, |value|));
 13. the computes and the output fixes through lidp_tpu_torch.api.lammps
     (compute_paths), each path printing its steps/s by its Loop time line
     and its peak device memory, then the time and peak of one sample step
     (the thermo row formed anew) and of its costliest computes, and its
     computes checked against the same evaluated on the CPU from the
     card's final state (cpu_clone: the thermo row's compute columns at
     rel 1e-9 of max(1, |value|), the rdf's pair counts exactly):
     AH. FLUID_SCRIPT's fluid at n_side 15 (10,125 atoms) in float32 at
        precision 1e-6 as H32 runs it (the panel engine, fused), 20 steps,
        thermo 1, with compute pe, ke, and com, gyration, msd and temp/com
        of half the molecules, group/group between the halves, ke/rigid,
        erotate/rigid, reduce max of ke/atom, rdf 100 (read after the run
        through extract_compute), fix ave/time 2 5 10 with a file, fix
        print 5, thermo c_ID, c_ID[i] and v_NAME columns: the kernels path
        G launches (and no strip launch counted apart), c_cpe the row's pe
        less its tail term, the H32 columns (as printed) within H32's bars
        of H32's rows, the ave/time file the means of the rows' values and
        the print lines the rows'; the time and peak of group/group and
        rdf;
     AI. bench/in.lj (LJ_SCRIPT, 32,000 atoms, float32, the cell grid)
        with ke/atom, pe/atom, stress/atom, coord/atom and displace/atom
        each reduced, msd, vacf, temp/ramp, temp/region, temp/profile, rdf
        100, fix ave/time, ave/atom, ave/histo, ave/correlate and vector,
        dump custom 50 with c_pa c_sa[1] f_avg[1] columns, thermo 10, run
        100: cell_pair_forces_lj launched, its ave/time file the means of
        the rows', fix vector's series the rows', the files' and frames'
        counts; the time and peak of the per-atom pair pass, coord/atom
        and rdf; step 0 (run 0) against a float64 CPU twin at path E's bars
        (the computes at 1e-5 of max(1, |value|), the reduced stresses
        1e-4), and against a float32 CPU twin (the same float32 state):
        the compute columns at 1e-6 of max(1, |value|), the dump frame's
        id and type exactly, its floats at 1e-6 of their column's
        largest;
 14. the k-space breadth from LAMMPS scripts (kspace_paths), float64,
     every launch counter 0 on each path, each printing its route, its
     log, its steps/s by the Loop time line and peak device memory, the
     ms a call of its pair term, TIP4P pass and k-space terms by CUDA
     events on its final state (ks_readings; for each mesh the difference
     between two calls on one state, the spread's index_add_), its
     compute_forces against the CPU's on the card's final state (f,
     energies and virial at rel 1e-9 of max(1, |value|), plus
     CANCEL_REL on the cell grid), and its rows 0-3 (AN's 0-1) against a
     CPU twin at rel 1e-9 (plus CANCEL_REL of the cancelled magnitude on
     cells):
     AJ. the point-charge fluid at n_side 15 (10,125 atoms, neighbor 1.0
        bin, rigid/nve) with lj/long/coul/long long long 6.0 6.5 and
        ewald/disp 1e-4 (the charge and dispersion sums), 20 steps, the
        cell grid;
     AK. AJ's input with pppm/disp 1e-4 (the charge and dispersion
        meshes);
     AN. the fluid with lj/cut/coul/msm 6.0 6.5 and msm 1e-4, its
        cutoff adjusted (18.06 A) and pushed into the pair table and the
        cell grid;
     then ewald_dipole_forces at AJ's final positions (seeded dipoles)
     against the same call on the CPU at rel 1e-10, its ms and peak;
     AL. 1,331 TIP4P/2005 waters (3,993 atoms, write_water_data's layout
        at nside 11 in a 34.1 A box, no jitter, written by the port's
        io/data_writer.py) with lj/cut/tip4p/long 1 2 1 1 0.1546 8.5,
        pppm/tip4p 1e-5, fix shake on the O-H bond and the H-O-H angle,
        fix nvt at 300 K, 2 fs, 20 steps, the dense route;
     AM. AL's water with lj/long/tip4p/long long long and pppm/disp/tip4p
        1e-5;
     then the LAMMPS rows of tests/test_tip4p_cut.py's five cases on the
     8-molecule box and of tests/test_msm.py's 32^3 case (golden_phases),
     at those tests' tolerances;
 15. the other pair styles from LAMMPS scripts (pair_style_paths),
     float64, every launch counter 0 on each path, each printing its
     route, its log's first rows and its last, its steps/s by the Loop
     time line, peak device memory and the ms a call of each pair pass
     (and the mesh) by CUDA events on its final state (pair_readings):
     AO. NaCl near its melting point: 16^3 rocksalt cells (32,768 ions,
        a = 5.64 A, written by the port's io/data_writer.py from
        nacl_layout, atom_style full), units metal, born/coul/long 9.0
        with the Tosi-Fumi Born-Mayer-Huggins tables (NACL_BORN), pppm
        1e-5, fix nvt at 1100 K, 2 fs, 20 steps, the cell grid through
        cell_pair_forces; compute_forces on the card's final state against
        the CPU's at rel 1e-9 of max(1, |value|) (ks_state_check); then
        the same at 10^3 cells (8,000 ions, still cells), one step, rows
        0-1 against its CPU twin at rel 1e-9;
     AP. AO's input as hybrid/overlay born 9.0 coul/long 9.0 (two masked
        passes), 5 steps: rows 0-5 equal AO's at rel 1e-10;
     AQ. examples/melt (path M's 4,000 atoms): pair_write 1 1 2000 r 0.8
        2.5 under lj/cut 2.5, then pair_style table linear 2000 reading
        it, 100 steps, the dense route: E_pair at step 0 within 2e-5 of
        lj/cut's and the forces on the final state within 1e-3 of max |f|
        (tests/test_pair_table.py's round trip); rows 0-2 against its CPU
        twin at rel 1e-9;
     AR. a Groot-Warren DPD fluid: 3,000 beads at rho 3 in a 10^3 box
        (dpd_layout), pair_style dpd 1.0 1.0 34387, a = 25, gamma = 4.5,
        comm_modify vel yes, dt 0.04, fix nve, 100 steps, the dense
        route: |sum of f| within 1e-10 of max |f| at every evaluation
        (theta_ij == theta_ji), rows 0-2 against its CPU twin at rel
        1e-9 (the twin draws the same threefry bits; torch's erfinv on
        the card and the CPU part in the last bits);
     then tests/test_pair_breadth2.py's 16 GOLDEN cases (its rows and
     scripts/gen_breadth_goldens.py's inputs copied: BREADTH_GOLDEN,
     BREADTH_CASES) at that test's bars (breadth_golden_phases);
 16. the rest of the CHARMM family, fix cmap and the DREIDING hydrogen
     bonds from LAMMPS scripts (charmm_family_paths), float64, the dense
     route, every launch counter 0 on each path, each printing its log's
     first rows and its last, its steps/s by the Loop time line, peak
     device memory and the ms a call by CUDA events on its final state of
     its pair passes, the mesh, the bonded terms, the crossterms and the
     hydrogen bonds (charmm_readings):
     AS. the CHARMM36 stack: flexible_script_case at n_side (8, 4, 5)
        (3,840 atoms, path S's fluid doubled along x) with
        lj/charmmfsw/coul/long 8 10, dihedral_style charmmfsw, pppm 1e-4,
        fix nvt and FLEX_SHAKE, fix cmap (one crossterm per
        N-methylacetamide over a methyl H, its C, the carbonyl C, N and
        the N-methyl C, the map type cycling 1-6; the seeded map file of
        write_cmap_file, the reference's charmm22.cmap not being in the
        repository) with fix_modify energy yes and f_cmap in the row, 10
        steps;
     AT. examples/cmap's stack on the same atoms: lj/charmmfsw/coul/
        charmmfsh 8 12 (dihedral charmmfsw's shifted 1-4 coulomb), fix
        cmap, no k-space;
     AU. the same atoms under lj/charmm/coul/charmm/implicit 8 10, no
        k-space;
     AV. 1,000 flexible waters (3,000 atoms at 1.0 g/cm^3, a 31.04 A box,
        hbond_water_layout) under hybrid/overlay lj/cut/coul/long 10.0
        with hbond/dreiding/lj 4 6.0 8.0 90 in tests/test_hbond.py's
        forms, pppm 1e-4, special_bonds lj/coul 0 0 0.5, fix nvt at 300
        K, 1 fs;
     each also at a small size (n_side (2, 2, 2), 192 atoms; 81 waters)
     for 2 steps, its rows 0-2 against its CPU twin at rel 1e-9; then
     the LAMMPS rows of tests/test_pair_breadth2.py's charmmfsw/
     charmmfsh, charmmfsw/coul/long + ewald and charmm/implicit cases and
     of tests/test_hbond.py's lj and morse cases (charmm_golden_phases)
     at those tests' bars;
 17. compute chunk/atom, the */chunk computes, fix ave/chunk, the
     structure computes and heat/flux from LAMMPS scripts
     (chunk_structure_paths), every launch counter 0 on each path, each
     printing its log's first rows and its last, its steps/s by the Loop
     time line, peak device memory, and on its final state the ms of a
     sample step and of each new compute by the host clock with the
     device's share by torch.profiler, each evaluated twice and equal bit
     for bit (compute_readings):
     AW. bench/in.lj (32,000 atoms, float32, the cell grid,
        cell_pair_forces_lj) with chunk/atom bin/1d z lower 0.05 units
        reduced and fix ave/chunk 10 5 100 of vx density/number temp to a
        file, a bin/3d chunking at 0.1 reduced (1,000 chunks) with
        com/vcm/temp/chunk through fix ave/time mode vector and a compute
        slice of one column in the row, centro/atom fcc, cna/atom 1.43,
        orientorder/atom, global/atom over the bin ids, heat/flux in the
        row and a dump custom of the per-atom columns; thermo 10, run
        100: the rows, frames and files as the script asks, step 0's
        cna codes all fcc;
     AX. bench/in.chain (chain_script_case: 32,000 beads in 320 chains,
        float32, the cell grid) with chunk/atom molecule, com, gyration,
        msd, inertia, omega and property/chunk through fix ave/time mode
        vector, fix ave/chunk by molecule, fragment/atom and
        aggregate/atom 1.2 in a dump: fragment/atom's label each chain's
        first bead, the chunk ids the molecule ids;
     each also at about 5,000 atoms in float64 (AW-5k: in.lj at 0.55;
     AX-5k: 50 chains) with a row, a dump frame and every output each
     step, 2 steps, against a float64 CPU twin: rows 0-2 at rel 1e-9, the
     dump's integer columns (chunk ids, cna codes, fragment labels)
     equal and the rest within 1e-9 of their column's largest, the files
     within 1e-9 or a last printed digit; and each full path's step 0
     against a float32 CPU twin of the same state (AW-f32, AX-f32): the
     row's compute columns within 1e-6 of max(1, |value|), the dump's
     frame 0 as above at 1e-6; then the LAMMPS rows of
     tests/test_chunk_computes.py (its 14 */chunk cases and two
     temp/chunk scalars in one script), tests/test_structure_computes.py
     (centro/atom and cna/atom, heat/flux, slice) and
     tests/test_order_computes.py (orientorder/atom, hexorder/atom,
     global/atom) at those tests' bars (chunk_structure_golden_phases);
 18. granular flow (granular_paths): atom_style sphere with pair gran/*,
     bench/in.chute's lines (CHUTE_SCRIPT) and a pour onto a bed
     (POUR_BED_SCRIPT), each script written from seeds and run through
     the CLI's main (python -m lidp_tpu_torch) in float64, every launch
     counter 0 on each path (the granular stack is plain torch), each
     printing its log's first rows and its last, its steps/s by the Loop
     time line, peak device memory, its rebuilds, candidate pairs and
     shear history's bytes, and on its final state the ms of a contact
     pass and of the walls' pass by CUDA events (gran_readings):
     AY. the chute at full width: chute_layout 40 x 20 x 40 (32,000
        grains, the bottom layer of 800 type 2), boundary p p fs,
        gran/hooke/history, neigh_modify exclude group bottom bottom,
        fix gravity chute 26, fix freeze on the base, nve/sphere on the
        rest, erotate/sphere, thermo 100, run 1000: 32,000 atoms in
        every row, the base's positions unchanged, the rows finite;
     AZ. a pour onto a bed: chute_layout 40 x 40 x 5 (8,000 grains) in a
        39.2 x 39.2 box, boundary p p f, gran/hertz/history with a
        hertz/history zplane wall, gravity vector 0 0 -1, nve/sphere, fix
        pour of 8,000 grains (diameter and density 0.9-1.1, vz -2) from
        a block 90 high over the whole footprint (one event at step 1:
        its count covers them all), contact/atom with reduce sum and max,
        temp/sphere, erotate/sphere/atom with reduce sum and
        erotate/sphere in the row, timestep 0.001, thermo 100, run 1000:
        8,000 atoms at step 0 and 16,000 after;
     and at 2,000 grains, each against its CPU twin (every row at rel
     1e-9 of max(1, |value|), the final x and v within 1e-8 of their
     largest entry): AY-2k (10 x 10 x 20, 20 steps, thermo 5),
     AY-nvt-2k (the same under nvt/sphere temp 1.0 1.0 0.01),
     AY-hooke-2k (under gran/hooke) and AZ-2k (a bed of 1,000 and a
     pour of 1,000, 50 steps); then the LAMMPS rows of
     tests/test_wall_gran.py (six cases), tests/test_pour.py (two) and
     tests/test_chute.py's contact/atom case at those tests' bars
     (granular_golden_phases);
 19. output and coupling (output_paths), every launch counter 0 just
     before each path and read just after:
     BA. path H's fluid (10,125 atoms, FLUID_SCRIPT, float64 at 1e-11,
        fused) run 10 steps through LammpsScript with dump custom every 2
        (id type x y z vx vy vz, sort id, %.17g), then the same setup
        with `rerun fluid.dump dump x y z vx vy vz` in place of the run:
        6 frames, each rebuilding the Simulation and evaluating `run 0`
        on the panel engine; each frame launches pair_panel_df,
        eind_panel_df and dipole_panel_df (the counters read after every
        frame), and each rerun row's PotEng, E_vdwl, E_coul, E_long and
        E_pol is within rel 1e-8 of max(1, |value|) of the run's row at
        that step; each frame's ms split into the rebuild and the
        evaluation (LammpsScript.rerun_timings);
     BB. bench/in.lj (32,000 atoms, float32, the cell grid with
        cell_pair_forces_lj, 1,000 steps) with compute pair/local (dist
        eng force) and property/local (patom1 patom2) under dump local,
        dump xyz and cfg, fix store/state 0 x y z dumped by f_ss[i],
        every 500 steps, dump dcd every 100, one dump image frame, and
        fix controller 10 on c_tt into the internal variable tcv (v_tcv
        in a thermo 100 row): the LJ kernel launched on every step; the
        last local frame's rows i < j in (i, j) order, as many as a dense
        pass counts inside the cutoff, their distances those of the final
        positions, the eng column's sum within rel 1e-4 of the float32
        run's E_pair x N; the xyz, cfg and dcd frames at the final
        positions, store/state's columns the setup positions, the PPM
        well formed (bb_checks); steps/s by the Loop time line, the peak
        memory, each local frame's rows, its device ms and its
        formatting ms, and every dump frame's ms (TimedWriters);
     BC. in.lj through lidp_tpu_torch.api.lammps, float32 (the cell grid),
        50 steps, thermo 10 (external_case): fix external pf/callback 1 1
        with a numpy callback -0.5 minimum-image(x - x0) fired on each
        of steps 0-50 with changing positions, its rows within rel 1e-6
        of max(1, |value|) of the same run under fix spring/self 0.5;
        pf/array with a uniform array against fix addforce at that bar;
        the LJ kernel launched on every step of each; steps/s by the Loop
        time line of the callback run against the plain in.lj run in
        this call (the host round trip);
     and BA-1k (the fluid at n_side 7, 1,029 atoms, the dense route, run
     and rerun in one script), BB-5k (BB's stack on in.lj at 0.55, 5,324
     atoms on the cell grid, float64, 100 steps, dumps every 50) and
     BC-5k (BC's callback run at 5,324 atoms, float64) against CPU twins
     (BC-5k's through the library, EXTERNAL_TWIN): every row within rel
     1e-9, the final x, v and mu within 1e-8 of their largest entry;
     BB-5k's files too (the local frames the same rows and (patom1,
     patom2) sequence, their values within rel 1e-9; xyz and cfg within
     1e-8 of the largest or one unit of the printed digit; dcd within
     that plus one float32 ulp) and BC-5k's callback steps equal;
 20. the rest of the modifier fixes and the integrators
     (fix_breadth_paths), every launch counter 0 just before each path
     and read just after:
     BD. bench/in.lj (32,000 atoms, float32, the cell grid with
        cell_pair_forces_lj) with fix nve/limit for 200 steps, then
        nve/noforce for 20 (one integrator fix at a time: both packages
        refuse two), under drag and spring/rg on a slab group, heat on
        it and ehex on a region, temp/csvr, store/force read by compute
        reduce max, a halt that is never met and dt/reset every 10
        steps: the LJ kernel launched on every step, the rows and steps
        counted, the gamma draws' tries printed;
     BE. in.lj under fix deform x, y and z scale 1.05 remap x with
        compute temp/deform in the row, and BE-ber under fix
        press/berendsen iso: the LJ kernel on every step, BE's Lx at
        the last row 1.05 times the lattice's within 1e-5, BE-ber's box
        moved;
     BF. the bead-spring chains (chain_script_case, 32,000 beads,
        float32, the plain cell pass) under fix tmd to a seeded target
        (tmd_target) with its statistics file, spring/chunk on molecule
        chunks and restrain bond/angle/dihedral: no kernel, tmd.out's
        rows counted;
     BG. test_sphere_nh's eight spheres written 10^3 times over
        (sphere_case, 8,000, float32, the LJ kernel) through nvt/sphere,
        npt/sphere and nph/sphere, 50 steps each;
     BH. a 32,000-atom fcc lattice under pair soft with fix adapt on a
        ramp variable (float64, the plain cell pass);
     each with its steps/s by the Loop time line and its peak memory;
     and BD-5k, BE-5k, BE-ber-5k (in.lj at 0.55, 5,324 atoms on the
     cell grid), BF-5k (54 chains, 5,400 beads), BG-1k (1,000 spheres,
     the dense route) and BH-5k (the lattice at 0.55), float64 on the
     card for 10 steps, against CPU twins: every row within rel 1e-9,
     the final x, v and mu within 1e-8 of their largest entry;
 21. the script front end (front_end_paths), every launch counter 0 just
     before each path and read just after:
     BI. bench/in.lj (32,000 atoms, float32, the cell grid with
        cell_pair_forces_lj) with balance 1.0 shift x 5 1.0, info system,
        timer full and restart 50 rs.a rs.b over 100 steps: the LJ
        kernel on every step, a row every 10 printed once across the two
        chunks, timer full's per-term ms (CUDA events), rs.b against the
        run's final System and integrator state bit for bit; then
        BI-resume, a second script that reads rs.a and runs 50 steps:
        its rows at 50-100 within rel 1e-4 of max(1, |value|) of the
        first run's;
     BJ. in.lj for 50 steps, change_box all x scale 1.05 y delta -0.5 0.5
        remap units box, reset_timestep 0, write_data and 50 more steps:
        Lx and Ly of the new box, the rows after change_box within rel
        1e-5 of a fresh script's from the written data (BJ-fresh); then
        clear (allocated memory before and after) and in.lj again in the
        same interpreter: its rows within 1e-5 of the first run's, the
        LJ kernel on every step of the four runs;
     BK. the three-site water template (WATER_MOL) placed by create_atoms
        0 box mol wat 4523 on lattice sc 0.05, 25 x 20 x 20 molecules
        (30,000 atoms), float64, lj/cut/coul/long with pppm and
        dielectric 2.0, harmonic bonds and angles, velocity create and
        scale, 4 steps, then delete_bonds all angle 1 and run 0
        (water_script): no kernel, the topology counted, E_angle 0 after;
     BL. a 256,000-atom in.lj data file written by the port's write_data,
        read by read_data's C++ Atoms parse and its Python one (timed,
        equal arrays), then 20 steps with the LJ kernel and dump custom
        every 10: the frames' rows, one frame formatted by the C++ rows
        and the Python loop (timed, the same text);
     each with its steps/s by the Loop time line and its peak memory;
     and BI-5k, BJ-5k (the whole script with its clear), BL-5k (in.lj at
     0.55, 5,324 atoms on the cell grid) and BK-1.7k (1,728 waters),
     float64 on the card for their scripts' steps, against CPU twins:
     every row within rel 1e-9, the final x, v and mu within 1e-8 of
     their largest entry;
 22. the CPU twins (CPU_TWIN: the same script through the port on the CPU
     in float64, in a process of its own; its rows, final state and each
     minimize's (E, iterations, converged)) of J, K, O, R, R-pppm, Q64, S,
     T, U64, V, W, X64, Y, Z, AA-100, AB (and AB's cg, sd, fire), AC, AD,
     AE-couette, AE-pois, AF, AG, AI, AI-f32 (AI's in float32, its
     setup state), AJ-AN, AO-8k, AQ, AR, AS-AV at 192 atoms (81
     waters), AW-5k, AX-5k, AW-f32, AX-f32, AY-2k, AY-nvt-2k,
     AY-hooke-2k, AZ-2k, BA-1k, BB-5k, BC-5k, BD-5k, BE-5k, BE-ber-5k,
     BF-5k, BG-1k, BH-5k, BI-5k, BJ-5k, BK-1.7k and BL-5k, each started
     as soon as its path has run, beside the card's later paths
     (TwinPool: forked by one parent that
     imported torch once, as many at once as the cores less
     HOST_CORES_KEPT take, the longest queued first; this process keeps
     HOST_CORES_KEPT torch threads meanwhile) and checked after the last
     (run_twins: every core then);
 23. one JSON line {"kernels": [...]} with each of the ten kernels'
     launches (summed and by path, A-K, E-E4, L, L64, M, N, N-pol, O, R,
     R-pppm, Q, Q64, P, P100, S, T, U, U64, V, W, X, X64, Y, Z, AA, AB,
     AC, AD, AE, AF, AG, AH, AI, AJ, AK, AN, AL, AM, AO, AP, AQ, AR, AS,
     AT, AU, AV, AW, AX, AY, AZ, BA, BB, BC, BC's plain, spring, array
     and addforce runs, BD, BE, BE-ber, BF, BG, BH, BI, BI-resume, BJ,
     BK and BL), times, ms_queued and bound, then the nvidia-smi line,
     then the device line last.

Phases 19, 20 and 21 run after 14 and before 15-18, so that their
costly twins run beside the card's later paths.  A `wall:` line after
each phase gives the seconds since the start and since the last such
line (the whole run must end within 1,200 s, the build included).

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


# a three-site water template (molecule.cpp's format): path BK's molecule
WATER_MOL = """# simple water-like molecule

3 atoms
2 bonds
1 angles

Coords

1 0.0 0.0 0.0
2 0.9 0.0 0.0
3 -0.25 0.87 0.0

Types

1 1
2 2
3 2

Charges

1 -0.8
2 0.4
3 0.4

Bonds

1 1 1 2
2 1 1 3

Angles

1 1 2 1 3
"""


def water_script(nx, ny=None, nz=None, seed=4523):
    """Path BK's input: WATER_MOL (the file wat.mol) placed by create_atoms
    0 box mol wat SEED on lattice sc 0.05, nx x ny x nz molecules (ny and
    nz default to nx), under lj/cut/coul/long 2.5 and pppm with dielectric
    2.0, harmonic bonds and angles, velocity create then scale, 4 steps of
    nve, then delete_bonds all angle 1 and a run 0.  The skin is 1.0: a
    cell grid of cutoff + 0.3 (cap 8) overflows where molecules bunch.
    """
    return f"""units lj
atom_style full
boundary p p p
lattice sc 0.05
region box block 0 {nx} 0 {ny or nx} 0 {nz or nx}
create_box 2 box bond/types 1 angle/types 1 extra/bond/per/atom 4 \
extra/special/per/atom 4
molecule wat wat.mol
create_atoms 0 box mol wat {seed}
mass 1 15.0
mass 2 1.0
pair_style lj/cut/coul/long 2.5
pair_coeff 1 1 0.2 1.5
pair_coeff 2 2 0.05 0.8
kspace_style pppm 1e-4
dielectric 2.0
bond_style harmonic
bond_coeff 1 60.0 0.9
angle_style harmonic
angle_coeff 1 30.0 104.0
special_bonds lj/coul 0.0 0.0 0.5
neighbor 1.0 bin
velocity all create 0.5 4928 loop geom
velocity all scale 0.6
fix 1 all nve
thermo 2
thermo_style custom step temp pe ebond eangle ecoul elong press
run 4
delete_bonds all angle 1
run 0
"""


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
dihedral_style {dihedral}
improper_style harmonic
pair_modify mix arithmetic
{kspace}{cmap}read_data flex.data{read_fix}
{replicate}pair_coeff 5 5 0.2 3.296 0.2 2.76
special_bonds charmm
neighbor 2.0 bin
neigh_modify delay 5
timestep 2.0
thermo_style {thermo}
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
                         pair=None, kspace="pppm 1e-4", dihedral="charmm",
                         cmap=None):
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
    kspace_style arguments, None for none; dihedral: the dihedral style
    (charmm or charmmfsw).  cmap: "yes" or "no" adds fix cmap (the
    examples/cmap form, flexible_script) with that fix_modify energy, the
    seeded map file CMAP_FILE (write_cmap_file) and one crossterm per
    N-methylacetamide (CMAP_ATOMS, the map type cycling 1-6) in the data
    file's CMAP section.  Returns the paths (data, script)."""
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

    # one crossterm per solute: its atoms CMAP_ATOMS of the 12, 1-based
    nma_first = [k * 12 for k in range(len(blocks))]
    crossterms = [(k % 6 + 1, *(f + a + 1 for a in CMAP_ATOMS))
                  for k, f in enumerate(nma_first)] if cmap else []
    lines = ["LAMMPS data file: flexible solute in water", "",
             f"{n} atoms", f"{len(bonds)} bonds", f"{len(angles)} angles",
             f"{len(dihedrals)} dihedrals", f"{len(impropers)} impropers"]
    if cmap:
        lines.append(f"{len(crossterms)} crossterms")
    lines += [f"{len(FLEX_TYPES)} atom types",
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
    if cmap:
        lines += ["", "CMAP", ""] + [
            f"{k + 1} " + " ".join(str(v) for v in row)
            for k, row in enumerate(crossterms)]
        write_cmap_file(os.path.join(directory, CMAP_FILE))
    data = os.path.join(directory, "flex.data")
    script = os.path.join(directory, "in.flex")
    with open(data, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    with open(script, "w") as fh:
        fh.write(flexible_script(fix, cut=cut, replicate=replicate,
                                 pair=pair, kspace=kspace,
                                 dihedral=dihedral, cmap=cmap))
    return data, script


def flexible_script(fix=FLEX_NVT, cut=(8.0, 10.0), replicate=None,
                    pair=None, kspace="pppm 1e-4", shake=FLEX_SHAKE,
                    dihedral="charmm", cmap=None):
    """FLEX_SCRIPT with `fix 1 all <fix>` and `fix 2 all <shake>` (the
    arguments of flexible_script_case); cmap "yes" or "no": examples/cmap's
    `fix cmap all cmap CMAP_FILE`, `fix_modify cmap energy <cmap>` and
    `read_data ... fix cmap crossterm CMAP`, with the thermo row of
    thermo_style multi and f_cmap."""
    inner, outer = cut
    cmap_lines = (f"fix cmap all cmap {CMAP_FILE}\nfix_modify cmap energy "
                  f"{cmap}\n" if cmap else "")
    return FLEX_SCRIPT.format(
        pair=pair or f"lj/charmm/coul/long {inner:g} {outer:g}",
        kspace=f"kspace_style {kspace}\n" if kspace else "",
        replicate=("replicate {} {} {}\n".format(*replicate)
                   if replicate else ""),
        fix=fix, shake=shake, dihedral=dihedral, cmap=cmap_lines,
        read_fix=" fix cmap crossterm CMAP" if cmap else "",
        thermo=("custom step " + " ".join(FLEX_MULTI) + " f_cmap" if cmap
                else "multi"))


# fix cmap on the flexible case: the map file, and each crossterm's five
# consecutively bonded atoms of _nma()'s twelve (a methyl H, its C, the
# carbonyl C, N, the N-methyl C)
CMAP_FILE = "seeded.cmap"
CMAP_ATOMS = (1, 0, 4, 6, 8)
# thermo_style multi's columns
FLEX_MULTI = ("etotal", "ke", "temp", "pe", "ebond", "eangle", "edihed",
              "eimp", "evdwl", "ecoul", "elong", "press")


def write_cmap_file(path, seed=23):
    """A CMAP file in charmm22.cmap's layout (the reference's examples/cmap
    file, which the repository does not hold): six 24x24 maps, phi down
    the rows and psi along them from -180 in steps of 15 degrees, each a
    `#` title line and 24 rows of 24 values in lines of 6; each map a
    seeded smooth periodic surface sum_kl a_kl cos(k phi + l psi +
    d_kl), k, l in 0..2, of about 1 kcal/mol."""
    import numpy as np

    rng = np.random.RandomState(seed)
    ang = np.deg2rad(-180.0 + 15.0 * np.arange(24))
    phi, psi = np.meshgrid(ang, ang, indexing="ij")
    lines = ["# a seeded CMAP file: six 24x24 maps in the reference's "
             "order"]
    for name in ("alanine", "alanine-proline", "proline",
                 "proline-proline", "glycine", "glycine-proline"):
        m = np.zeros((24, 24))
        for k in range(3):
            for l in range(3):
                m += rng.uniform(-0.4, 0.4) * np.cos(
                    k * phi + l * psi + rng.uniform(0.0, 2.0 * np.pi))
        lines += ["", f"# {name} map", ""]
        for row in m:
            lines += [" ".join(f"{v:.6f}" for v in row[c:c + 6])
                      for c in range(0, 24, 6)]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


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
# that the twin pool packs the host's cores; small tensors gain little from
# more), its rows and final state saved
CPU_TWIN = """\
import os, sys, time
import numpy as np
import torch
torch.set_num_threads(int(os.environ["TWIN_THREADS"]))
from lidp_tpu_torch.io.script import LammpsScript
s = LammpsScript(dtype=getattr(torch, os.environ["TWIN_DTYPE"]),
                 device="cpu", log=lambda line: None)
s.variables["nstep"] = sys.argv[3]
t0 = time.perf_counter()
s.file(sys.argv[2])
seconds = time.perf_counter() - t0
sim = s._sim
n = sim.natoms
rows = s.thermo_rows
cols = [c for c in rows[0] if c not in ("step", "atoms", "bonds")] \
    if rows else []
np.savez(sys.argv[1], x=sim.sys.x[:n].numpy(), v=sim.sys.v[:n].numpy(),
         mu=sim.sys.mu[:n].numpy(), cols=np.array(cols, dtype=str),
         root=s.root,
         rows=np.array([[r[c] for c in cols] for r in rows]),
         minimized=np.array(s.minimized, float).reshape(-1, 3),
         seconds=seconds)
assert "jax" not in sys.modules
"""
# the twins queued by defer_twin, the directory their inputs are copied to
# and the pool that runs them (TwinPool)
TWINS = []
TWIN_ROOT = []
TWIN_POOL = []
TWIN_TIMEOUT = 900
# the host's cores left to this process (its one thread that drives the card
# and its own torch threads) while the card's paths run beside the twins
HOST_CORES_KEPT = 2
# the twins' parent: it imports torch and the port once, on one torch thread
# (so that no OpenMP pool exists when it forks), then forks a child for each
# job line {"id", "work", "argv", "env", "code"} read from its standard
# input; the child runs the job's code in the job's directory with its
# output in twin.log there; the parent writes {"id", "pid"} when it forks and
# {"id", "rc"} when the child ends, and ends with the last child after its
# input closes
TWIN_PARENT = """\
import json, os, select, sys, time, traceback
import numpy
import torch
torch.set_num_threads(1)
import lidp_tpu_torch.io.script
running, buf, closed = {}, b"", False


def say(msg):
    sys.stdout.write(json.dumps(msg) + "\\n")
    sys.stdout.flush()


def child(job):
    code = 1
    try:
        os.chdir(job["work"])
        fd = os.open("twin.log", os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        os.dup2(fd, 1)
        os.dup2(fd, 2)
        os.environ.update(job["env"])
        sys.argv = ["-c", *job["argv"]]
        exec(compile(job["code"], "<twin>", "exec"), {"__name__": "__main__"})
        code = 0
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else 1
    except BaseException:
        traceback.print_exc()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


while running or not closed:
    if closed:
        time.sleep(0.05)
    elif select.select([0], [], [], 0.05)[0]:
        data = os.read(0, 1 << 16)
        closed = not data
        buf += data
        while b"\\n" in buf:
            line, buf = buf.split(b"\\n", 1)
            job = json.loads(line)
            pid = os.fork()
            if pid == 0:
                child(job)
            running[pid] = job["id"]
            say({"id": job["id"], "pid": pid})
    while running:
        pid, status = os.waitpid(-1, os.WNOHANG)
        if pid == 0:
            break
        say({"id": running.pop(pid), "rc": os.waitstatus_to_exitcode(status)})
"""


class TwinPool:
    """Runs the CPU twins beside the card's paths: as many at once as
    `budget` cores take their threads, the most expensive queued first (a
    twin that does not fit waits for cores to free), each forked by one
    TWIN_PARENT process, so that a twin pays no import of torch."""

    def __init__(self, budget):
        import threading

        env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       filter(None, (ROOT, os.environ.get("PYTHONPATH")))))
        env.pop("LIDP_FAST_POLAR", None)
        self.proc = subprocess.Popen(
            [sys.executable, "-c", TWIN_PARENT], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, env=env, text=True,
            start_new_session=True)
        self.budget = budget
        self.queue, self.running = [], {}
        self.lock = threading.Lock()
        self.t0 = time.perf_counter()
        threading.Thread(target=self._read, daemon=True).start()

    def add(self, t):
        with self.lock:
            t["id"] = len(TWINS) - 1
            self.queue.append(t)
            self._start()

    def _start(self):
        used = sum(t["threads"] for t in self.running.values())
        for t in sorted(self.queue, key=lambda t: -t["cost"]):
            if self.running and used + t["threads"] > self.budget:
                continue
            t["out"] = os.path.join(t["work"], "twin.npz")
            env = dict(OMP_NUM_THREADS=str(t["threads"]),
                       TWIN_THREADS=str(t["threads"]), TWIN_DTYPE=t["dtype"])
            job = dict(id=t["id"], work=t["work"], env=env, code=t["code"],
                       argv=[t["out"], t["script"], str(t["steps"])])
            t["t0"] = time.perf_counter()
            self.proc.stdin.write(json.dumps(job) + "\n")
            self.proc.stdin.flush()
            self.queue.remove(t)
            self.running[t["id"]] = t
            used += t["threads"]

    def _read(self):
        for line in self.proc.stdout:
            msg = json.loads(line)
            with self.lock:
                t = TWINS[msg["id"]]
                if "pid" in msg:
                    t["pid"] = msg["pid"]
                    continue
                t["rc"], t["t1"] = msg["rc"], time.perf_counter()
                del self.running[t["id"]]
                self._start()

    def wait(self, budget):
        """Let the twins take `budget` cores and wait for every one; raises
        if one runs past TWIN_TIMEOUT seconds or the parent dies."""
        with self.lock:
            self.budget = budget
            self._start()
        while True:
            with self.lock:
                if not self.queue and not self.running:
                    return
                late = [t["path"] for t in self.running.values()
                        if time.perf_counter() - t["t0"] > TWIN_TIMEOUT]
            if late:
                raise AssertionError(f"paths {late}: the CPU twin did not "
                                     "finish")
            if self.proc.poll() is not None:
                raise AssertionError(f"the twins' parent exit "
                                     f"{self.proc.returncode}")
            time.sleep(0.2)

    def close(self):
        import signal

        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.proc.wait()


def defer_twin(path, work, script, steps, check, threads=1, cost=60.0,
               dtype="float64", code=CPU_TWIN):
    """Queue path's CPU twin (CPU_TWIN on `script`, `steps` steps) on the
    twin pool, which runs it beside the card's paths on the cores this
    process leaves free (HOST_CORES_KEPT): the directory `work` (the input
    and its data) is copied aside now; check(twin), with twin the np.load
    of the twin's arrays, holds the path to it in run_twins.  cost: the
    twin's expected seconds on its `threads`, so that the pool starts the
    longest first."""
    import atexit

    import torch

    if not TWIN_ROOT:
        TWIN_ROOT.append(tempfile.mkdtemp(prefix="chip_smoke_twins_"))
        atexit.register(shutil.rmtree, TWIN_ROOT[0], True)
    if not TWIN_POOL:
        cores = os.cpu_count() or 1
        TWIN_POOL.append(TwinPool(max(1, cores - HOST_CORES_KEPT)))
        atexit.register(TWIN_POOL[0].close)
        torch.set_num_threads(max(1, min(HOST_CORES_KEPT, cores)))
    dst = os.path.join(TWIN_ROOT[0], path)
    shutil.copytree(work, dst)
    TWINS.append(dict(path=path, work=dst, script=script, steps=steps,
                      check=check, threads=threads, cost=cost, dtype=dtype,
                      code=code))
    TWIN_POOL[0].add(TWINS[-1])


def run_twins():
    """After the card's paths: give the twin pool every core, wait for the
    twins still queued or running and check each, in the order queued.
    Raises if one fails, disagrees or runs past TWIN_TIMEOUT seconds;
    every process started is stopped."""
    import numpy as np
    import torch

    if not TWIN_POOL:
        return
    pool = TWIN_POOL[0]
    cores = os.cpu_count() or 1
    t0 = time.perf_counter()
    left = len(pool.queue) + len(pool.running)
    torch.set_num_threads(cores)
    try:
        pool.wait(cores)
    finally:
        pool.close()
    for t in TWINS:
        if t["rc"] != 0:
            with open(os.path.join(t["work"], "twin.log")) as fh:
                err = fh.read()
            raise AssertionError(f"path {t['path']}: the CPU twin exit "
                                 f"{t['rc']}\n{err[-4000:]}")
        twin = np.load(t["out"])
        print(f"path {t['path']}: its CPU twin (the same script, the port "
              f"on the CPU, {t['dtype']}, {t['threads']} thread(s)) took "
              f"{float(twin['seconds']):.1f} s of its "
              f"{t['t1'] - t['t0']:.1f} s process")
        t["check"](twin)
    print(f"CPU twins: {len(TWINS)} in {time.perf_counter() - pool.t0:.1f} "
          f"s of wall time from the first, beside the card's paths on "
          f"{max(1, cores - HOST_CORES_KEPT)} cores; "
          f"{left} still queued or running when the card's paths ended, "
          f"done {time.perf_counter() - t0:.1f} s later on {cores} cores")


def run_state(script):
    """The rows of a script's runs and its final x, v, mu on the host."""
    sim = script._sim
    return script.thermo_rows, {
        name: getattr(sim.sys, name)[:sim.natoms].cpu().numpy()
        for name in ("x", "v", "mu")}


def twin_check(path, state, cols, cancel=None, rel=1e-9):
    """The check of a deferred twin (defer_twin) on path's rows and final
    x, v, mu (run_state): its first rows, as many as the twin ran, within
    rel (1e-9) of max(1, |value|) of the twin's (plus CANCEL_REL of `cancel`,
    cancelled()'s magnitudes); where the twin ran all of the path's steps,
    x, v and mu within 1e-8 of their largest entry."""
    import numpy as np

    rows, final = state

    def check(twin):
        ref = [dict(zip(twin["cols"].tolist(), r)) for r in twin["rows"]]
        worst = rows_agree(path, rows[:len(ref)], ref, [rel] * len(ref),
                           cols, cancel=cancel)
        line = (f"path {path} vs its CPU twin: rows 0-{len(ref) - 1} at "
                f"{worst:.3g} of their bar (rel {rel:g} of max(1, |value|)"
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
# T's twin: one step, rows 0-1 (two steps took 146.9-206.6 s on its
# threads on the card's host, the longest twin)
FLEX_T_TWIN_STEPS = 1
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
            twin_steps = FLEX_T_TWIN_STEPS if cells else FLEX_TWIN_STEPS
            defer_twin(path, work, inputs[path], twin_steps,
                       twin_check(path, (rows, None), cols, cancel=cancel),
                       threads=FLEX_T_TWIN_THREADS if cells else 1,
                       cost=FLEX_T_TWIN_COST if cells else 10.0)
            print(f"path {path}: rows {twin_steps + 1}-{FLEX_STEPS} "
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


# paths AA, AB and AC: energy minimization and two dimensions
# (integrate/minimize.py through the script commands minimize, min_style,
# min_modify, dimension 2, fix enforce2d, displace_atoms)
MIN_SCRIPT = """\
# 2d Lennard-Jones melt and subsequent energy minimization

units		lj
dimension	2
atom_style	atomic

lattice		sq2 0.8442
region		box block 0 20 0 20 -0.1 0.1
create_box	1 box
create_atoms	1 box
mass		1 1.0

velocity	all create 5.0 87287 loop geom

pair_style	lj/cut 2.5
pair_coeff	1 1 1.0 1.0 2.5
pair_modify	shift yes

neighbor	0.3 bin
neigh_modify	delay 0 every 1 check yes

fix		1 all nve
fix		2 all enforce2d

thermo		100

run		1000

minimize	1.0e-4 1.0e-6 100 1000
"""
MIN_STEPS = 1000               # in.min's run
# LAMMPS's log.5Oct16.min.g++.1, step 0, and the bars of
# tests/test_min_example.py:32-36
MIN_GOLD0 = dict(temp=5.0, epair=-2.461717, etotal=2.532033, press=5.0190509)
MIN_BARS0 = dict(temp=1e-10, epair=5e-7, etotal=5e-7, press=5e-7)
MIN_EPAIR = -2.6               # test_min_example.py's E_pair per atom bar
# tests/test_min_styles.py's 72-atom input and the rebuilt reference's
# minimized E_pair per atom, each with its bar
MIN_STYLES_HEAD = """\
units lj
dimension 2
atom_style atomic
lattice sq2 0.8442
region box block 0 6 0 6 -0.1 0.1
create_box 1 box
create_atoms 1 box
mass 1 1.0
pair_style lj/cut 2.5
pair_coeff 1 1 1.0 1.0 2.5
pair_modify shift yes
neighbor 0.3 bin
displace_atoms all random 0.15 0.15 0 424242
fix 2 all enforce2d
"""
MIN_GOLDS = (("quickmin", "minimize 0.0 1.0e-6 500 5000", -2.96612445689,
              1e-7),
             ("hftn", "minimize 0.0 1.0e-8 100 5000", -2.96613896543, 1e-9))
# AB's other styles from the same start, 20 iterations each
AB_OTHERS = ("cg", "sd", "fire")
AB_MIN = "minimize 0.0 1.0e-12 20 1000"
# path AC: the polar fluid at path I's size, fire then cg
AC_MIN = """\
min_style fire
minimize 0.0 1.0e-6 6 100
min_style cg
minimize 0.0 1.0e-6 3 100
"""


class MinimizeTimer:
    """Within `with MinimizeTimer():` each `minimize` command of the port's
    LammpsScript is timed (synchronized, the host clock) with its force
    evaluations (the compute_forces calls it makes) and its host reads
    (HostReads): `calls` holds (seconds, evaluations, host reads,
    iterations) for each."""

    def __enter__(self):
        import torch

        from lidp_tpu_torch import forcefield
        from lidp_tpu_torch.io import script as script_mod

        self.calls = []
        self._cls = script_mod.LammpsScript
        self._orig = self._cls.cmd_minimize
        self._ff = forcefield
        self._cf = forcefield.compute_forces
        evals = [0]

        def counted(*a, **kw):
            evals[0] += 1
            return self._cf(*a, **kw)

        def timed(script, a, _orig=self._orig):
            torch.cuda.synchronize()
            evals[0] = 0
            t0 = time.perf_counter()
            with HostReads() as reads:
                _orig(script, a)
                torch.cuda.synchronize()
                nreads = reads.count()
            self.calls.append((time.perf_counter() - t0, evals[0], nreads,
                               script.minimized[-1][1]))

        forcefield.compute_forces = counted
        self._cls.cmd_minimize = timed
        return self

    def __exit__(self, *exc):
        self._ff.compute_forces = self._cf
        self._cls.cmd_minimize = self._orig
        return False


def minimize_line(path, calls, peak):
    """A minimizing path's readings: for each minimize command its
    iterations, force evaluations, iterations/s, ms an evaluation and host
    reads an iteration by the host clock, and the peak device memory."""
    for k, (sec, evals, reads, its) in enumerate(calls):
        print(f"path {path} minimize {k + 1}: {its} iterations, {evals} "
              f"force evaluations in {sec:.4f} s: iterations_per_s_"
              f"{path.replace('-', '_')} {its / sec:.4f}, "
              f"{1e3 * sec / max(evals, 1):.4f} ms an evaluation, "
              f"{reads / max(its, 1):.2f} host reads an iteration "
              f"(synchronized, the host clock)")
    print(f"path {path}: peak device memory {peak / 2**20:.1f} MiB "
          f"(torch.cuda.max_memory_allocated); {smi_line()}")


def min_twin_check(path, script, cols=(), iterations=True, e_rel=1e-9,
                   x_tol=1e-8):
    """The check of a minimizing path's deferred twin (defer_twin): its
    rows as twin_check holds them, each minimize's energy within e_rel
    and its iteration count equal (where `iterations`), the final x within
    x_tol of its largest entry."""
    import numpy as np

    rows = script.thermo_rows
    mins = np.array(script.minimized, float).reshape(-1, 3)
    x = script._sim.sys.x[:script._sim.natoms].cpu().numpy()

    def check(twin):
        ref = [dict(zip(twin["cols"].tolist(), r)) for r in twin["rows"]]
        worst = rows_agree(path, rows, ref, [1e-9] * len(ref), cols) \
            if ref else 0.0
        tm = twin["minimized"]
        if tm.shape != mins.shape:
            raise AssertionError(f"path {path}: {len(mins)} minimizations, "
                                 f"the twin {len(tm)}")
        e_worst = float(np.max(np.abs(mins[:, 0] - tm[:, 0])
                               / (e_rel * np.abs(tm[:, 0]))))
        if not e_worst <= 1.0:
            raise AssertionError(f"path {path}: minimized E {mins[:, 0]}, "
                                 f"the twin's {tm[:, 0]}")
        if iterations and not np.array_equal(mins[:, 1], tm[:, 1]):
            raise AssertionError(f"path {path}: iterations {mins[:, 1]}, "
                                 f"the twin's {tm[:, 1]}")
        big = float(np.abs(twin["x"]).max())
        x_err = float(np.abs(x - twin["x"]).max())
        if not x_err <= x_tol * big:
            raise AssertionError(f"path {path}: final x off by {x_err:.3e}")
        print(f"path {path} vs its CPU twin: {len(ref)} rows at "
              f"{worst:.3g} of their bar (rel 1e-9 of max(1, |value|)), "
              f"minimized E at {e_worst:.3g} of theirs (rel {e_rel:g}), "
              f"iterations {mins[:, 1].astype(int).tolist()} against "
              f"{tm[:, 1].astype(int).tolist()}, final x at "
              f"{x_err / (x_tol * big):.3g} of theirs ({x_tol:g} of max)")

    return check


def check_planar(path, sys_):
    import torch

    z = float(torch.abs(sys_.x[:, 2]).max())
    vz = float(torch.abs(sys_.v[:, 2]).max())
    print(f"path {path}: max |z| {z:.3g}, max |v_z| {vz:.3g} (bars 1e-12)")
    if not (z < 1e-12 and vz < 1e-12):
        raise AssertionError(f"path {path}: the atoms left the plane")


def min_script_run(path, work, name, text):
    """`text` (written to work/name) through LammpsScript in float64 on
    the card under MinimizeTimer: (script, log lines, calls, peak)."""
    import torch

    from lidp_tpu_torch.io.script import LammpsScript

    with open(os.path.join(work, name), "w") as fh:
        fh.write(text)
    logs = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    script = LammpsScript(dtype=torch.float64, log=logs.append)
    with MinimizeTimer() as timer:
        script.file(os.path.join(work, name))
    peak = torch.cuda.max_memory_allocated()
    for line in logs:
        print(f"  {path}| {line}")
    return script, logs, timer.calls, peak


def minimize_paths(launches, reset_counts, read_counts):
    """Paths AA, AB and AC: energy minimization and two dimensions from a
    LAMMPS script (module docstring).  Each sets launches[path]."""
    import torch

    from lidp_tpu_torch.__main__ import main as cli
    from lidp_tpu_torch.forcefield import compute_forces
    from lidp_tpu_torch.integrate.minimize import hvp

    work = tempfile.mkdtemp(prefix="chip_smoke_min_")
    try:
        # path AA: examples/min's in.min verbatim through the CLI's main()
        in_min = os.path.join(work, "in.min")
        with open(in_min, "w") as fh:
            fh.write(MIN_SCRIPT)
        log_aa = os.path.join(work, "log.min")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with MinimizeTimer() as timer:
            cli(["-in", in_min, "-log", log_aa])
        peak = torch.cuda.max_memory_allocated()
        with open(log_aa) as fh:
            log = fh.read().splitlines()
        print("path AA: `python -m lidp_tpu_torch -in in.min` (examples/min "
              "verbatim: 800 atoms, 2d, fix nve + enforce2d, run 1000, "
              "then minimize with cg), the dense route; its log:")
        for line in log:
            print(f"  AA| {line}")
        rows = log_rows(log)
        if [int(r["step"]) for r in rows] != list(range(0, MIN_STEPS + 1,
                                                        100)):
            raise AssertionError(f"path AA: rows {rows}")
        check_rows_finite("AA", rows, CHAIN_COLS)
        for k, bar in MIN_BARS0.items():
            err = abs(rows[0][k] - MIN_GOLD0[k])
            print(f"path AA step 0 {k}: {rows[0][k]!r} against LAMMPS's "
                  f"{MIN_GOLD0[k]!r} (abs err {err:.2e}, bar {bar:g})")
            if not err < bar:
                raise AssertionError(f"path AA step 0 {k}: {rows[0][k]}")
        mline = [w for w in log if w.startswith("# minimize:")]
        e_aa = float(mline[0].split()[4]) / 800
        print(f"path AA: minimized E_pair {e_aa:.8g} per atom (bar "
              f"{MIN_EPAIR:g})")
        if not e_aa < MIN_EPAIR:
            raise AssertionError(f"path AA: minimized E_pair {e_aa}")
        script_peak("AA", log, MIN_STEPS, peak)
        minimize_line("AA", timer.calls, peak)

        # AA's state: the same input through LammpsScript, the run and the
        # minimization apart; rows and minimized E as the CLI printed them
        text = MIN_SCRIPT.split("minimize")
        script, logs, _, _ = min_script_run("AA-state", work, "in.aa",
                                            text[0])
        check_planar("AA after the run", script._sim.sys)
        script.one("minimize " + text[1].strip())
        if log_rows(logs) != rows or not logs[-1] == mline[0]:
            raise AssertionError("path AA: LammpsScript's rows or minimize "
                                 "line differ from the CLI's")
        sim = script._sim
        if sim.runner.neighbor_cfg is not None or sim.res is not None \
                or bool(torch.any(sim.sys.v)):
            raise AssertionError(f"path AA: {script_route(script)}")
        check_planar("AA after minimize", sim.sys)
        print("path AA: LammpsScript on in.min gives the CLI's rows and "
              f"minimize line; {script_route(script)}")
        del script, sim
        # the hot 2d liquid is chaotic: run 1000's rows part from another
        # device's after a few hundred steps, so the twin holds in.min
        # with its run cut to 100 steps, as tests/test_min_example.py
        # cuts it
        script, _, calls, peak = min_script_run(
            "AA-100", work, "in.aa100",
            MIN_SCRIPT.replace(f"run		{MIN_STEPS}", "run		100"))
        check_planar("AA-100", script._sim.sys)
        minimize_line("AA-100", calls, peak)
        defer_twin("AA-100", work, "in.aa100", 0,
                   min_twin_check("AA-100", script, CHAIN_COLS), threads=2,
                   cost=40.0)
        launches["AA"] = read_counts()
        check_counts("AA", launches["AA"], {})
        del script
        torch.cuda.empty_cache()

        # path AB: tests/test_min_styles.py's 72 atoms, quickmin then hftn
        # to its goldens; cg, sd and fire from the same start
        reset_counts()
        text = MIN_STYLES_HEAD + "".join(
            f"min_style {style}\n{cmd}\n" for style, cmd, _, _ in MIN_GOLDS)
        script, _, calls, peak = min_script_run("AB", work, "in.ab", text)
        for (style, _, gold, rel), (e, it, _) in zip(MIN_GOLDS,
                                                     script.minimized):
            check_rel(f"AB {style} E_pair per atom ({it} iterations)",
                      e / 72, gold, rel)
        check_planar("AB", script._sim.sys)
        minimize_line("AB", calls, peak)
        # hftn's cost, warm: a force evaluation against a Hessian-vector
        # product by forward-mode AD through it, at the minimized state
        sim = script._sim
        ff = sim.runner.ff
        d = torch.ones_like(sim.sys.x)

        def compute(sys_):
            res = compute_forces(sys_, ff)
            return res.f, res.epair

        ms = cuda_ms(lambda: compute(sim.sys), reps=5)
        ms_hvp = cuda_ms(lambda: hvp(sim.sys, compute, sim.sys.x, d), reps=5)
        print(f"path AB: at the minimized state, warm, a force evaluation "
              f"{ms:.4f} ms, a Hessian-vector product (hvp, forward-mode "
              f"AD through it) {ms_hvp:.4f} ms (medians of 5 by CUDA "
              "events)")
        del sim
        # hftn's iteration count is set by rounding at its tail, where its
        # Armijo test compares energies at their rounding
        defer_twin("AB", work, "in.ab", 0,
                   min_twin_check("AB", script, iterations=False),
                   cost=20.0)
        for style in AB_OTHERS:
            name = f"in.ab-{style}"
            script, _, calls, peak = min_script_run(
                f"AB-{style}", work, name,
                MIN_STYLES_HEAD + f"min_style {style}\n{AB_MIN}\n")
            minimize_line(f"AB-{style}", calls, peak)
            defer_twin(f"AB-{style}", work, name, 0,
                       min_twin_check(f"AB-{style}", script, e_rel=1e-10,
                                      x_tol=1e-10), cost=10.0)
        launches["AB"] = read_counts()
        check_counts("AB", launches["AB"], {})
        del script
        torch.cuda.empty_cache()

        # path AC: the polar fluid at path I's size, fire then cg
        fluid_script_case(work, n_side=I_SIDE)
        reset_counts()
        script, _, calls, peak = min_script_run(
            "AC", work, "in.ac", FLUID_SCRIPT.replace("run ${nstep}\n",
                                                      AC_MIN))
        launches["AC"] = read_counts()
        check_counts("AC", launches["AC"], {})
        sim = script._sim
        if sim.runner.neighbor_cfg is not None or len(script.minimized) != 2:
            raise AssertionError(f"path AC: {script_route(script)}")
        for e, it, _ in script.minimized:
            if not math.isfinite(e):
                raise AssertionError(f"path AC: E {e}")
        ff = sim.runner.ff
        ms = cuda_ms(lambda: compute_forces(sim.sys, ff), reps=5)
        print(f"path AC: {sim.natoms} atoms, float64, polar precision "
              f"1e-11, the dense route: minimized E "
              f"{[m[0] for m in script.minimized]} after "
              f"{[m[1] for m in script.minimized]} iterations (fire, cg); "
              f"a force evaluation {ms:.3f} ms (median of 5 by CUDA "
              "events, at the minimized state)")
        minimize_line("AC", calls, peak)
        defer_twin("AC", work, "in.ac", 0,
                   min_twin_check("AC", script), threads=4, cost=120.0)
        del script, sim
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)


# examples/crack, flow and obstacle: in.crack, in.flow.couette,
# in.flow.pois and in.obstacle as LAMMPS ships them (the 5Oct16 examples
# whose logs tests/test_crack.py, test_flow.py and test_obstacle.py hold)
CRACK_SCRIPT = """\
# 2d LJ crack simulation

dimension	2
boundary	s s p

atom_style	atomic
neighbor	0.3 bin
neigh_modify	delay 5

# create geometry

lattice		hex 0.93
region		box block 0 100 0 40 -0.25 0.25
create_box	5 box
create_atoms	1 box

mass		1 1.0
mass		2 1.0
mass		3 1.0
mass		4 1.0
mass		5 1.0

# LJ potentials

pair_style	lj/cut 2.5
pair_coeff	* * 1.0 1.0 2.5

# define groups

region	        1 block INF INF INF 1.25 INF INF
group		lower region 1
region		2 block INF INF 38.75 INF INF INF
group		upper region 2
group		boundary union lower upper
group		mobile subtract all boundary

region		leftupper block INF 20 20 INF INF INF
region		leftlower block INF 20 INF 20 INF INF
group		leftupper region leftupper
group		leftlower region leftlower

set		group leftupper type 2
set		group leftlower type 3
set		group lower type 4
set		group upper type 5

# initial velocities

compute	  	new mobile temp
velocity	mobile create 0.01 887723 temp new
velocity	upper set 0.0 0.3 0.0
velocity	mobile ramp vy 0.0 0.3 y 1.25 38.75 sum yes

# fixes

fix		1 all nve
fix		2 boundary setforce NULL 0.0 0.0

# run

timestep	0.003
thermo		200
thermo_modify	temp new

neigh_modify	exclude type 2 3

#dump		1 all atom 500 dump.crack

#dump		2 all image 250 image.*.jpg type type &
#		zoom 1.6 adiam 1.5
#dump_modify	2 pad 4

#dump		3 all movie 250 movie.mpg type type &
#		zoom 1.6 adiam 1.5
#dump_modify	3 pad 4

run		5000
"""
FLOW_COUETTE_SCRIPT = """\
# 2-d LJ flow simulation

dimension	2
boundary	p s p

atom_style	atomic
neighbor	0.3 bin
neigh_modify	delay 5

# create geometry

lattice		hex 0.7
region		box block 0 20 0 10 -0.25 0.25
create_box	3 box
create_atoms	1 box

mass		1 1.0
mass		2 1.0
mass		3 1.0

# LJ potentials

pair_style	lj/cut 1.12246
pair_coeff	* * 1.0 1.0 1.12246

# define groups

region	     1 block INF INF INF 1.25 INF INF
group	     lower region 1
region	     2 block INF INF 8.75 INF INF INF
group	     upper region 2
group	     boundary union lower upper
group	     flow subtract all boundary

set	     group lower type 2
set	     group upper type 3

# initial velocities

compute	     mobile flow temp
velocity     flow create 1.0 482748 temp mobile
fix	     1 all nve
fix	     2 flow temp/rescale 200 1.0 1.0 0.02 1.0
fix_modify   2 temp mobile

# Couette flow

velocity     lower set 0.0 0.0 0.0
velocity     upper set 3.0 0.0 0.0
fix	     3 boundary setforce 0.0 0.0 0.0
fix	     4 all enforce2d

# Poiseuille flow

#velocity     boundary set 0.0 0.0 0.0
#fix	     3 lower setforce 0.0 0.0 0.0
#fix	     4 upper setforce 0.0 NULL 0.0
#fix	     5 upper aveforce 0.0 -1.0 0.0
#fix	     6 flow addforce 0.5 0.0 0.0
#fix	     7 all enforce2d

# Run

timestep	0.003
thermo		500
thermo_modify	temp mobile

#dump		1 all atom 100 dump.flow

#dump		2 all image 100 image.*.jpg type type &
#		zoom 1.6 adiam 1.5
#dump_modify	2 pad 4

#dump		3 all movie 100 movie.mpg type type &
#		zoom 1.6 adiam 1.5
#dump_modify	3 pad 4

run		10000
"""
FLOW_POIS_SCRIPT = """\
# 2-d LJ flow simulation

dimension	2
boundary	p s p

atom_style	atomic
neighbor	0.3 bin
neigh_modify	delay 5

# create geometry

lattice		hex 0.7
region		box block 0 20 0 10 -0.25 0.25
create_box	3 box
create_atoms	1 box

mass		1 1.0
mass		2 1.0
mass		3 1.0

# LJ potentials

pair_style	lj/cut 1.12246
pair_coeff	* * 1.0 1.0 1.12246

# define groups

region	     1 block INF INF INF 1.25 INF INF
group	     lower region 1
region	     2 block INF INF 8.75 INF INF INF
group	     upper region 2
group	     boundary union lower upper
group	     flow subtract all boundary

set	     group lower type 2
set	     group upper type 3

# initial velocities

compute	     mobile flow temp
velocity     flow create 1.0 482748 temp mobile
fix	     1 all nve
fix	     2 flow temp/rescale 200 1.0 1.0 0.02 1.0
fix_modify   2 temp mobile

# Couette flow

#velocity     lower set 0.0 0.0 0.0
#velocity     upper set 3.0 0.0 0.0
#fix	     3 boundary setforce 0.0 0.0 0.0
#fix	     4 all enforce2d

# Poiseuille flow

velocity     boundary set 0.0 0.0 0.0
fix	     3 lower setforce 0.0 0.0 0.0
fix	     4 upper setforce 0.0 NULL 0.0
fix	     5 upper aveforce 0.0 -1.0 0.0
fix	     6 flow addforce 0.5 0.0 0.0
fix	     7 all enforce2d

# Run

timestep	0.003
thermo		500
thermo_modify	temp mobile

#dump		1 all atom 100 dump.flow

#dump		2 all image 100 image.*.jpg type type &
#		zoom 1.6 adiam 1.5
#dump_modify	2 pad 4

#dump		3 all movie 100 movie.mpg type type &
#		zoom 1.6 adiam 1.5
#dump_modify	3 pad 4

run		10000
"""
OBSTACLE_SCRIPT = """\
# 2d LJ obstacle flow

dimension	2
boundary	p s p

atom_style	atomic
neighbor	0.3 bin
neigh_modify	delay 5

# create geometry

lattice		hex 0.7
region		box block 0 40 0 10 -0.25 0.25
create_box	3 box
create_atoms	1 box

mass		1 1.0
mass		2 1.0
mass		3 1.0

# LJ potentials

pair_style	lj/cut 1.12246
pair_coeff	* * 1.0 1.0 1.12246

# define groups

region	     1 block INF INF INF 1.25 INF INF
group	     lower region 1
region	     2 block INF INF 8.75 INF INF INF
group	     upper region 2
group	     boundary union lower upper
group	     flow subtract all boundary

set	     group lower type 2
set	     group upper type 3

# initial velocities

compute	     mobile flow temp
velocity     flow create 1.0 482748 temp mobile
fix	     1 all nve
fix	     2 flow temp/rescale 200 1.0 1.0 0.02 1.0
fix_modify   2 temp mobile

# Poiseuille flow

velocity     boundary set 0.0 0.0 0.0
fix	     3 lower setforce 0.0 0.0 0.0
fix	     4 upper setforce 0.0 NULL 0.0
fix	     5 upper aveforce 0.0 -1.0 0.0
fix	     6 flow addforce 1.0 0.0 0.0

# 2 obstacles

region	     void1 sphere 10 4 0 3
delete_atoms region void1
region	     void2 sphere 20 7 0 3
delete_atoms region void2

fix	     7 flow indent 100 sphere 10 4 0 4
fix	     8 flow indent 100 sphere 20 7 0 4
fix	     9 all enforce2d

# Run

timestep	0.003
thermo		1000
thermo_modify	temp mobile

#dump		1 all atom 100 dump.obstacle

#dump		2 all image 500 image.*.jpg type type &
#		zoom 1.6 adiam 1.5
#dump_modify	2 pad 4

#dump		3 all movie 500 movie.mpg type type &
#		zoom 1.6 adiam 1.5
#dump_modify	3 pad 4

run		25000
"""


def cut_run(text, steps):
    """A stock script with its one `run` cut to `steps` steps (nothing
    else changed)."""
    lines = text.splitlines(keepends=True)
    runs = [i for i, line in enumerate(lines) if line.startswith("run")]
    if len(runs) != 1:
        raise ValueError("the script has no single run command")
    lines[runs[0]] = f"run\t\t{steps}\n"
    return "".join(lines)


AD_STEPS = 200                 # in.crack's run cut from 5000
AE_STEPS = 100                 # in.flow.couette's and pois's cut from 10000
AF_STEPS = 100                 # in.obstacle's cut from 25000
AG_STEPS = 100                 # the 4x-area crack
AG_REGION = "block 0 200 0 80"
NP_PHASE_STEPS = 20            # the steps each path's phases are timed over
# log.5Oct16.crack.g++.1 (steps 0 and 200) and log.5Oct16.flow.couette.
# g++.1 (step 0), each column at tests/test_crack.py's and test_flow.py's
# bars; test_flow.py holds Poiseuille's Temp and E_pair at step 0
CRACK_GOLD = {
    0: dict(temp=(0.065651733, 5e-9), epair=(-3.2595015, 5e-7),
            etotal=(-3.1987287, 5e-7), press=(-0.036239172, 5e-8)),
    200: dict(temp=(0.060086376, 1e-7), epair=(-3.2531936, 1e-6),
              etotal=(-3.1975725, 1e-6), press=(-0.23125026, 1e-6))}
CRACK_ATOMS = 8141             # the log's `Created 8141 atoms`
FLOW_GOLD0 = dict(temp=(1.0, 1e-9), epair=(0.0, 1e-9),
                  etotal=(0.71190476, 1e-7), press=(0.52314537, 1e-7),
                  vol=(571.54286, 1e-4))
POIS_GOLD0 = dict(temp=(1.0, 1e-9), epair=(0.0, 1e-9))
# tests/test_obstacle.py: 769 in the log, its deletions ulp-sensitive
OBSTACLE_BAND = (765, 771)
# its indenters (x, y, R in lattice units) and test_obstacle.py's bar: no
# atom nearer a centre than 0.55 R
INDENTERS = ((10, 4, 4), (20, 7, 4))
INDENT_DEPTH = 0.55
# AG's step 0 against its float64 twin: path E's float32 bars (LJ_LOG0),
# relative to max(1, |value|) (crack's Press is -0.036)
AG_BARS = dict(temp=1e-6, epair=1e-5, etotal=1e-5, press=1e-4)
# the phases timed on the crack (cells) and flow (dense) paths
CRACK_PHASES = (("pair cells", "lidp_tpu_torch.ops.cells",
                 "cell_pair_forces"),
                ("rebuild", "lidp_tpu_torch.integrate.driver", "_rebuild"),
                ("reset_box", "lidp_tpu_torch.box", "reset_box"))
FLOW_PHASES = DENSE_PHASES[:1]


class ScriptCapture:
    """Within `with ScriptCapture():` the LammpsScript objects that run
    (through the CLI's main() too) are kept in `scripts`."""

    def __enter__(self):
        from lidp_tpu_torch.io import script as script_mod

        self.scripts = []
        self._cls = script_mod.LammpsScript
        self._orig = self._cls.cmd_run

        def run(script, a, _orig=self._orig):
            if script not in self.scripts:
                self.scripts.append(script)
            return _orig(script, a)

        self._cls.cmd_run = run
        return self

    def __exit__(self, *exc):
        self._cls.cmd_run = self._orig
        return False


def check_gold(path, row, gold):
    """A logged row's columns against a LAMMPS log's, each within its
    bar (absolute, as the JAX package's tests hold them)."""
    for k, (want, bar) in gold.items():
        err = abs(row[k] - want)
        print(f"path {path} step {int(row['step'])} {k}: {row[k]!r} against "
              f"LAMMPS's {want!r} (abs err {err:.2e}, bar {bar:g})")
        if not err < bar:
            raise AssertionError(f"path {path} step {int(row['step'])} {k}: "
                                 f"{row[k]}")


def check_shrink(path, script):
    """The box of a shrink-wrapped run is reset_box of the positions at
    the last rebuild (the grid's x_ref): equal bit for bit, its s faces
    the extent -/+ small of those positions, the periodic faces the
    created box's; printed beside the atoms' extent now."""
    import numpy as np
    import torch

    from lidp_tpu_torch.box import reset_box

    sim = script._sim
    spec, box, n = sim.runner.shrink, sim.sys.box, sim.natoms
    want = reset_box(sim.nlist.x_ref, sim.sys.mask, box, spec)
    if not (bool((want.lo == box.lo).all())
            and bool((want.hi == box.hi).all())):
        raise AssertionError(f"path {path}: the box {box} is not reset_box "
                             "of the last rebuild's positions")
    x_ref = sim.nlist.x_ref[:n].double().cpu().numpy()
    x = sim.sys.x[:n].double().cpu().numpy()
    lo, hi = box.lo.double().cpu().numpy(), box.hi.double().cpu().numpy()
    small = np.asarray(spec.small)
    err = max(float(np.abs(lo[:2] - (x_ref[:, :2].min(0) - small[:2])).max()),
              float(np.abs(hi[:2] - (x_ref[:, :2].max(0) + small[:2])).max()))
    c_lo, c_hi = script._created_box
    # the faces are formed in the run's dtype
    tol = 4 * torch.finfo(box.lo.dtype).eps * float(np.abs(hi).max())
    if not (err <= tol and abs(lo[2] - c_lo[2]) <= tol
            and abs(hi[2] - c_hi[2]) <= tol
            and sim.sys.box.periodic == (False, False, True)):
        raise AssertionError(f"path {path}: box {lo} {hi}, extent err {err}")
    print(f"path {path}: the box {lo[:2].tolist()} - {hi[:2].tolist()} in "
          f"x, y is the extent at the last rebuild -/+ small "
          f"{small[:2].tolist()} (max err {err:.2e}, bar {tol:.2e}; "
          f"reset_box's bit for "
          f"bit), the atoms' extent now {x[:, :2].min(0).tolist()} - "
          f"{x[:, :2].max(0).tolist()}; z {lo[2]:.6g} - {hi[2]:.6g} "
          "periodic, the created box's")


def np_phases(path, script, phases):
    """NP_PHASE_STEPS more steps of a path's Simulation, its phases and
    the fixes' hooks timed by CUDA events (fix_phases)."""
    ms = fix_phases(script._sim, phases, NP_PHASE_STEPS)
    print(f"path {path} phases over {NP_PHASE_STEPS} more steps, ms a step "
          "(CUDA events): " + ", ".join(f"{k} {v:.4f}" for k, v in
                                        ms.items()))


def np_cli_run(path, work, name, text, extra=()):
    """`text` (written to work/name) through the CLI's main() on the card,
    its script kept (ScriptCapture): (script, log lines, peak memory)."""
    import torch

    from lidp_tpu_torch.__main__ import main as cli

    with open(os.path.join(work, name), "w") as fh:
        fh.write(text)
    log_path = os.path.join(work, f"log.{name}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with ScriptCapture() as cap:
        cli(["-in", os.path.join(work, name), "-log", log_path, *extra])
    peak = torch.cuda.max_memory_allocated()
    with open(log_path) as fh:
        log = fh.read().splitlines()
    return cap.scripts[-1], log, peak


def created_atoms(path, log):
    """The counts of a log's `Created N atoms` and `Deleted ...` lines."""
    lines = [w for w in log if w.startswith(("Created", "Deleted"))]
    print(f"path {path}: " + "; ".join(lines))
    return lines


def nonperiodic_paths(launches, reset_counts, read_counts):
    """Paths AD, AE, AF and AG: non-periodic boundaries, walls and regions
    from a LAMMPS script (module docstring).  Each sets launches[path]."""
    import numpy as np
    import torch

    work = tempfile.mkdtemp(prefix="chip_smoke_np_")
    try:
        # path AD: examples/crack as shipped through the CLI, run 200
        reset_counts()
        script, log, peak = np_cli_run(
            "AD", work, "in.crack", cut_run(CRACK_SCRIPT, AD_STEPS))
        launches["AD"] = read_counts()
        check_counts("AD", launches["AD"], {})
        lines = created_atoms("AD", log)
        if lines != [f"Created {CRACK_ATOMS} atoms"] \
                or script._sim.natoms != CRACK_ATOMS:
            raise AssertionError(f"path AD: {lines}")
        rows = log_rows(log)
        if [int(r["step"]) for r in rows] != [0, AD_STEPS]:
            raise AssertionError(f"path AD: rows {rows}")
        check_rows_finite("AD", rows, CHAIN_COLS)
        for row in rows:
            check_gold("AD", row, CRACK_GOLD[int(row["step"])])
        route = script_route(script)
        if "cell grid" not in route:
            raise AssertionError(f"path AD: {route}")
        print(f"path AD: examples/crack (in.crack as shipped, run "
              f"{AD_STEPS}: {CRACK_ATOMS} atoms, 2d, boundary s s p, "
              f"float64), {route}")
        check_shrink("AD", script)
        script_peak("AD", log, AD_STEPS, peak)
        state = run_state(script)
        np_phases("AD", script, CRACK_PHASES)
        defer_twin("AD", work, "in.crack", 0,
                   twin_check("AD", state, CHAIN_COLS), threads=4,
                   cost=60.0)
        del script
        torch.cuda.empty_cache()

        # path AE: in.flow.couette and in.flow.pois, run 100, dense
        reset_counts()
        for tag, text, gold in (("AE-couette", FLOW_COUETTE_SCRIPT,
                                 FLOW_GOLD0),
                                ("AE-pois", FLOW_POIS_SCRIPT, POIS_GOLD0)):
            name = f"in.{tag}"
            script, log, _, peak = min_script_run(tag, work, name,
                                                  cut_run(text, AE_STEPS))
            rows = script.thermo_rows
            if [r["step"] for r in rows] != [0, AE_STEPS] \
                    or script._sim.runner.neighbor_cfg is not None:
                raise AssertionError(f"path {tag}: {script_route(script)}")
            check_rows_finite(tag, rows, CHAIN_COLS)
            check_gold(tag, rows[0], gold)
            print(f"path {tag}: {script._sim.natoms} atoms, boundary p s p, "
                  f"float64, {script_route(script)}")
            script_peak(tag, log, AE_STEPS, peak)
            state = run_state(script)
            np_phases(tag, script, FLOW_PHASES)
            defer_twin(tag, work, name, 0,
                       twin_check(tag, state, CHAIN_COLS, rel=1e-8),
                       cost=15.0)
            del script
        launches["AE"] = read_counts()
        check_counts("AE", launches["AE"], {})
        torch.cuda.empty_cache()

        # path AF: in.obstacle, run 100, dense
        reset_counts()
        script, log, _, peak = min_script_run(
            "AF", work, "in.obstacle", cut_run(OBSTACLE_SCRIPT, AF_STEPS))
        launches["AF"] = read_counts()
        check_counts("AF", launches["AF"], {})
        created_atoms("AF", log)
        sim = script._sim
        n = sim.natoms
        rows = script.thermo_rows
        if not OBSTACLE_BAND[0] <= n <= OBSTACLE_BAND[1] \
                or [r["step"] for r in rows] != [0, AF_STEPS] \
                or sim.runner.neighbor_cfg is not None:
            raise AssertionError(f"path AF: {n} atoms, "
                                 f"{script_route(script)}")
        check_rows_finite("AF", rows, CHAIN_COLS)
        s3 = script._spacing3()
        x = sim.sys.x[:n].cpu().numpy()
        for k, (cx, cy, rad) in enumerate(INDENTERS):
            d = np.hypot(x[:, 0] - cx * s3[0], x[:, 1] - cy * s3[1])
            near = float(d.min()) / (rad * s3[0])
            inside = int((d < rad * s3[0]).sum())
            print(f"path AF indenter {k + 1}: nearest atom at {near:.4f} R "
                  f"(bar {INDENT_DEPTH}: tests/test_obstacle.py), {inside} "
                  f"atoms inside R after {AF_STEPS} steps")
            if not near > INDENT_DEPTH:
                raise AssertionError(f"path AF: an atom at {near} R")
        print(f"path AF: in.obstacle, {n} atoms after delete_atoms (band "
              f"{OBSTACLE_BAND}), float64, {script_route(script)}")
        script_peak("AF", log, AF_STEPS, peak)
        state = run_state(script)
        np_phases("AF", script, FLOW_PHASES)

        def af_twin(twin, _check=twin_check("AF", state, CHAIN_COLS,
                                            rel=1e-8), _n=n):
            if twin["x"].shape[0] != _n:
                raise AssertionError(f"path AF: {_n} atoms, the twin "
                                     f"{twin['x'].shape[0]}")
            print(f"path AF: the twin deleted to the same {_n} atoms")
            _check(twin)

        defer_twin("AF", work, "in.obstacle", 0, af_twin, cost=40.0)
        del script, sim
        torch.cuda.empty_cache()

        # path AG: the 4x-area crack in float32 through the CLI
        text = CRACK_SCRIPT.replace("block 0 100 0 40", AG_REGION)
        reset_counts()
        script, log, peak = np_cli_run("AG", work, "in.crack4x",
                                       cut_run(text, AG_STEPS), ["--f32"])
        launches["AG"] = read_counts()
        check_counts("AG", launches["AG"], {})
        created_atoms("AG", log)
        rows = log_rows(log)
        if [int(r["step"]) for r in rows] != [0, AG_STEPS]:
            raise AssertionError(f"path AG: rows {rows}")
        check_rows_finite("AG", rows, CHAIN_COLS)
        route = script_route(script)
        if "cell grid" not in route:
            raise AssertionError(f"path AG: {route}")
        print(f"path AG: in.crack on {AG_REGION} (4x the area), "
              f"{script._sim.natoms} atoms, float32, {route}")
        check_shrink("AG", script)
        script_peak("AG", log, AG_STEPS, peak)
        np_phases("AG", script, CRACK_PHASES)
        with open(os.path.join(work, "in.crack4x0"), "w") as fh:
            fh.write(cut_run(text, 0))
        row0 = rows[0]

        def ag_twin(twin, _row=row0):
            ref = dict(zip(twin["cols"].tolist(), twin["rows"][0]))
            worst = 0.0
            for k, rel in AG_BARS.items():
                bar = rel * max(1.0, abs(ref[k]))
                worst = max(worst, abs(_row[k] - ref[k]) / bar)
                if not abs(_row[k] - ref[k]) <= bar:
                    raise AssertionError(f"path AG step 0 {k}: {_row[k]!r}, "
                                         f"the float64 twin's {ref[k]!r}")
            print(f"path AG step 0 (float32 on the card, as printed) vs its "
                  f"float64 CPU twin: at {worst:.3g} of path E's bars "
                  f"{AG_BARS} (relative to max(1, |value|))")

        defer_twin("AG", work, "in.crack4x0", 0, ag_twin, threads=4,
                   cost=20.0)
        del script
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)


# computes and the output fixes (compute_paths): AH on the polar fluid's
# panel engine, AI on bench/in.lj's cell grid
AH_SIDE = 15                   # 10,125 atoms: path H32's fluid
AH_STEPS = 20                  # H32's run
AH_COMPUTES = """\
group half molecule <= {half}
group other subtract all half
compute cpe all pe
compute ke1 all ke
compute com1 half com
compute gyr half gyration
compute msd1 half msd
compute tcom half temp/com
compute gg half group/group other
compute kr all ke/rigid 1
compute er all erotate/rigid 1
compute ka all ke/atom
compute mka all reduce max c_ka
compute r all rdf 100
variable twice equal 2*c_tcom
fix 2 all ave/time 2 5 10 c_cpe c_gg c_kr file ah_time.out
fix 3 all print 5 "step ${{step}} pe ${{pe}} temp ${{temp}}"
thermo_style custom step etotal ke pe evdwl ecoul elong epol temp press \
c_cpe c_ke1 c_com1[1] c_com1[2] c_com1[3] c_gyr c_msd1[4] c_tcom c_gg \
c_kr c_er c_mka v_twice
"""
AH_COLS = ("c_cpe", "c_ke1", "c_com1[1]", "c_com1[2]", "c_com1[3]", "c_gyr",
           "c_msd1[4]", "c_tcom", "c_gg", "c_kr", "c_er", "c_mka", "v_twice")
AI_STEPS = 100                 # in.lj's run
AI_COMPUTES = """\
compute ka all ke/atom
compute pa all pe/atom
compute sa all stress/atom NULL
compute crd all coord/atom cutoff 1.5
compute dsp all displace/atom
compute rka all reduce sum c_ka
compute rpa all reduce sum c_pa
compute rsa all reduce sum c_sa[1] c_sa[2] c_sa[3]
compute rcrd all reduce ave c_crd
compute rdsp all reduce max c_dsp[4]
compute msd all msd
compute vac all vacf
region half block 0 $(v_xx/2+0.25) 0 ${yy} 0 ${zz}
compute tr all temp/ramp vx 0.0 1.0 x 0.0 ${xx}
compute treg all temp/region half
compute tp all temp/profile 1 1 1 x 7
compute r all rdf 100
fix avg all ave/atom 10 5 50 c_pa c_ka
fix at all ave/time 10 5 50 c_tr c_treg c_tp c_msd[4] file ai_time.out
fix ah all ave/histo 10 5 50 -8.0 -4.0 40 c_pa file ai_histo.out
fix ac all ave/correlate 10 5 50 c_vac[4] c_treg file ai_corr.out
fix vec all vector 10 c_rpa c_rka
thermo_style custom step temp epair emol etotal press c_rka c_rpa \
c_rsa[1] c_rsa[2] c_rsa[3] c_rcrd c_rdsp c_msd[4] c_vac[1] c_vac[4] \
c_tr c_treg c_tp
thermo 10
dump d all custom 50 ai.dump id type x y z c_pa c_sa[1] f_avg[1]
dump_modify d format float %.10g
"""
AI_SCALE = "1"                 # in.lj's x, y, z: 32,000 atoms
AI_COLS = ("c_rka", "c_rpa", "c_rsa[1]", "c_rsa[2]", "c_rsa[3]", "c_rcrd",
           "c_rdsp", "c_msd[4]", "c_vac[1]", "c_vac[4]", "c_tr", "c_treg",
           "c_tp")
# the computes on the card against the same computes evaluated on the CPU
# from the card's final state (cpu_clone): float64 sums (the pair passes
# formed in float64) of the same float32 state, 1e-9 of max(1, |value|);
# the temperature computes, which reduce in the run's dtype as the
# thermo's own temperature does, 1e-6
CLONE_REL = 1e-9
CLONE_TEMP_REL = 1e-6
# the float32 card's step 0 against the float64 twin: path E's bars for the
# thermo columns, the computes at 1e-5 of max(1, |value|), the reduced
# stresses 1e-4 (press's); against the float32 twin (the same float32
# state of step 0: the per-atom pair passes in float64 on it) the compute
# columns and the dump frame's floats at 1e-6 of max(1, |value|) and of
# their column's largest.  The float64 state differs from the float32 one
# by the positions' rounding (up to 1.9e-6 at x ~ 33.6), which moves each
# atom's pe and stress by 2.7e-6 and 4.9e-6 of their columns at 32,000
# atoms (an H100, float32, against the float64 CPU twin)
AI_COMPUTE_BAR = 1e-5
AI_STRESS_BAR = 1e-4
AI_DUMP_REL = 1e-6


def to_cpu(o):
    """A copy of o with every tensor in it (through dataclasses, tuples and
    dicts) on the CPU."""
    import torch

    if isinstance(o, torch.Tensor):
        return o.cpu()
    if dataclasses.is_dataclass(o) and not isinstance(o, type):
        return dataclasses.replace(o, **{
            f.name: to_cpu(getattr(o, f.name))
            for f in dataclasses.fields(o) if f.init})
    if isinstance(o, tuple):
        return tuple(to_cpu(v) for v in o)
    if isinstance(o, dict):
        return {k: to_cpu(v) for k, v in o.items()}
    return o


def cpu_clone(sim):
    """A copy of a Simulation with its state, force field, thermo and
    computes' tensors on the CPU (the runner reduced to its force field
    and integrator parameters), to evaluate the computes there on the
    card's state."""
    import copy
    import types

    mv = to_cpu
    c = copy.copy(sim)
    for name in ("sys", "res", "thermo_params", "istate", "group_thermo",
                 "msd_computes", "vacf_computes", "peratom_computes"):
        setattr(c, name, mv(getattr(sim, name)))
    c.runner = types.SimpleNamespace(
        ff=mv(sim.runner.ff),
        integ=types.SimpleNamespace(params=mv(sim.runner.integ.params)))
    c._peratom = (None, None, {})
    c._row_cache = None
    return c


def clone_check(path, sim, cols, rdf_cid, peratom=()):
    """The thermo row's compute columns, the rdf and the per-atom vectors
    `peratom` on the card against the same evaluated on the CPU from the
    card's state (cpu_clone): rows at CLONE_REL of max(1, |value|)
    (CLONE_TEMP_REL for the temperature computes), the rdf's counts
    exactly, the per-atom vectors at CLONE_REL of their largest entry."""
    import numpy as np

    from lidp_tpu_torch import computes

    sim._row_cache = None
    sim._peratom = (None, None, {})
    row = sim.thermo_row()
    clone = cpu_clone(sim)
    crow = clone.thermo_row()
    worst = 0.0
    for c in cols:
        rel = (CLONE_TEMP_REL if c[2:].split("[")[0] in sim.group_thermo
               else CLONE_REL)
        bar = rel * max(1.0, abs(crow[c]))
        worst = max(worst, abs(row[c] - crow[c]) / bar)
        if not abs(row[c] - crow[c]) <= bar:
            raise AssertionError(f"path {path} {c}: the card's {row[c]!r}, "
                                 f"the CPU's {crow[c]!r} on its state")
    rdf, crdf = sim.compute_rdf(rdf_cid), clone.compute_rdf(rdf_cid)
    ng = int(np.asarray(sim.rdf_computes[rdf_cid][0]).sum())
    counts = np.round(rdf[:, 2] * ng / 2)
    if not np.array_equal(counts, np.round(crdf[:, 2] * ng / 2)) \
            or not np.isfinite(rdf).all():
        raise AssertionError(f"path {path}: the rdf's counts differ from "
                             "the CPU's on the card's state")
    for cid in peratom:
        got = computes.eval_peratom(sim, cid).cpu().numpy()
        want = computes.eval_peratom(clone, cid).numpy()
        err = float(np.abs(got - want).max())
        if not err <= CLONE_REL * float(np.abs(want).max()):
            raise AssertionError(f"path {path} c_{cid}: the card's per-atom "
                                 f"values {err:.3e} from the CPU's")
    print(f"path {path}: the computes on the card vs the same on the CPU "
          f"from the card's state (cpu_clone): {', '.join(cols)} at "
          f"{worst:.3g} of their bar (rel {CLONE_REL:g} of max(1, "
          f"|value|), the temperatures {CLONE_TEMP_REL:g}); the rdf's "
          f"{int(counts[-1])} pair counts equal; "
          f"per-atom {', '.join(peratom) or 'none'} within {CLONE_REL:g} of "
          "their largest")
    return rdf


def timed_phase(path, label, fn):
    """One call of fn on the card, synchronized: its ms by the host clock
    and the peak device memory over it; printed and returned with fn's
    value."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() - base
    print(f"path {path} {label}: {ms:.3f} ms, peak {peak / 2**20:.1f} MiB "
          f"over the state's (host clock, synchronized; {smi_line()})")
    return out


def compute_timings(path, sim, phases):
    """The time and peak of one sample step (the thermo row formed anew:
    every compute and the one transfer) and of each of `phases` ((label,
    fn) on a fresh per-atom cache)."""
    def sample():
        sim._row_cache = None
        sim._peratom = (None, None, {})
        return sim.thermo_row()

    timed_phase(path, "one sample step (thermo_row, every compute)", sample)
    for label, fn in phases:
        sim._peratom = (None, None, {})
        timed_phase(path, label, fn)


def file_lines(name):
    """The whitespace-split lines of a file."""
    with open(name) as fh:
        return [line.split() for line in fh.read().splitlines()]


def check_ave_time_file(path, name, rows, cols, nev, nrep, nfreq):
    """A scalar fix ave/time's file against the rows: each line at step s
    the mean of the row values at the Nrepeat samples before it (rows at
    every sample step), at 1e-9 of max(1, |value|) (%.10g in the file)."""
    by_step = {int(r["step"]): r for r in rows}
    lines = file_lines(name)
    if not lines:
        raise AssertionError(f"path {path}: {name} is empty")
    for words in lines:
        step = int(words[0])
        steps = [step - k * nev for k in range(nrep)]
        for j, c in enumerate(cols):
            want = sum(by_step[s][c] for s in steps) / nrep
            got = float(words[1 + j])
            if not abs(got - want) <= 1e-9 * max(1.0, abs(want)):
                raise AssertionError(f"path {path} {name} step {step} {c}: "
                                     f"{got!r}, the rows' mean {want!r}")
    print(f"path {path}: {name}'s {len(lines)} lines (steps "
          f"{[int(w[0]) for w in lines]}) the means of the rows' "
          f"{', '.join(cols)} over {nrep} samples every {nev}")


def compute_paths(launches, reset_counts, read_counts, rowsH32, launchesG):
    """Paths AH and AI: the computes and the output fixes (module
    docstring).  Each sets launches[path]."""
    import numpy as np
    import torch

    from lidp_tpu_torch import api, computes

    work = tempfile.mkdtemp(prefix="chip_smoke_computes_")
    try:
        # path AH: the polar fluid with computes through api.lammps,
        # float32 at 1e-6 as H32 runs it (the panel engine, fused)
        fluid_script_case(work, AH_SIDE)
        n_mol = AH_SIDE ** 3
        text = FLUID_SCRIPT.replace(
            "thermo_style custom step etotal ke pe evdwl ecoul elong epol "
            "temp press\n", AH_COMPUTES.format(half=n_mol // 2))
        with open(os.path.join(work, "in.ah"), "w") as fh:
            fh.write(text)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        L = api.lammps(cmdargs=["-log", os.path.join(work, "log.ah"),
                                "-var", "prec", "1e-6", "-var", "nstep",
                                str(AH_STEPS)], dtype=torch.float32)
        L.file(os.path.join(work, "in.ah"))
        rdf = L.extract_compute("r")
        launches["AH"] = read_counts()
        peak = torch.cuda.max_memory_allocated()
        script = L.lmp
        sim = script._sim
        with open(os.path.join(work, "log.ah")) as fh:
            log = fh.read().splitlines()
        for line in log:
            if not line.startswith(("step ", "fast-polar")):
                continue
            print(f"  AH| {line}")
        runner = sim.runner
        if type(runner).__name__ != "FastPolarRunner" \
                or runner.mode != "fused":
            raise AssertionError(f"path AH: runner {type(runner).__name__}")
        got = {k for k, v in launches["AH"].items() if v}
        want = {k for k, v in launchesG.items() if v}
        print(f"path AH launches: {launches['AH']}; path G's (the same "
              f"fluid through polar_bench.build_rigid): {launchesG}")
        if got != want:
            raise AssertionError(f"path AH launched {sorted(got)}, path G "
                                 f"{sorted(want)}")
        rows = script.thermo_rows
        if [r["step"] for r in rows] != list(range(AH_STEPS + 1)):
            raise AssertionError(f"path AH: rows {len(rows)}")
        check_rows_finite("AH", rows, G64_COLS + AH_COLS)
        # compute pe: the row's pe, polarization in, the tail term out
        tp = sim.thermo_params
        nrm = float(tp.natoms) if tp.norm else 1.0
        etail = tp.etail / float(sim.sys.box.volume) if tp.etail else 0.0
        for r in rows:
            if not abs(r["c_cpe"] / nrm - (r["pe"] - etail / nrm)) <= \
                    1e-12 * abs(r["pe"]):
                raise AssertionError(f"path AH step {r['step']}: c_cpe "
                                     f"{r['c_cpe']} against pe {r['pe']}")
        worst = rows_agree("AH", [{c: float(f"{r[c]:.8g}") for c in G64_COLS}
                                  for r in rows], rowsH32,
                           [1e-6] + [1e-5] * AH_STEPS)
        print(f"path AH: {sim.natoms} atoms, float32 at 1e-6, the panel "
              f"engine (fused); c_cpe the row's pe (epol "
              f"{rows[-1]['epol']:.6g} in, no tail); its H32 columns (as printed) vs H32's rows at "
              f"{worst:.3g} of H32's bars (step 0 rel 1e-6, steps 1-"
              f"{AH_STEPS} rel 1e-5 of max(1, |value|)); step {AH_STEPS}: "
              + ", ".join(f"{c} {rows[-1][c]:.8g}" for c in AH_COLS))
        if not rows[-1]["c_msd1[4]"] > 0.0:
            raise AssertionError("path AH: msd did not grow")
        check_ave_time_file("AH", os.path.join(work, "ah_time.out"), rows,
                            ("c_cpe", "c_gg", "c_kr"), 2, 5, 10)
        prints = [w for w in log if w.startswith("step ")]
        want_prints = [f"step {s} pe {rows[s]['pe']:.8g} temp "
                       f"{rows[s]['temp']:.8g}" for s in (5, 10, 15, 20)]
        if prints != want_prints:
            raise AssertionError(f"path AH: fix print {prints}")
        if rdf.shape != (100, 3) or not np.isfinite(rdf).all() \
                or not (np.diff(rdf[:, 2]) >= 0).all():
            raise AssertionError("path AH: rdf")
        print(f"path AH: fix print's {len(prints)} lines the rows' values; "
              f"rdf (100, 3) through api.lammps.extract_compute, g(r) peak "
              f"{rdf[:, 1].max():.4f} at r {rdf[rdf[:, 1].argmax(), 0]:.3f}, "
              f"coord at the cutoff {rdf[-1, 2]:.4f}")
        script_peak("AH", log, AH_STEPS, peak)
        clone_check("AH", sim, AH_COLS[:-1], "r")
        compute_timings("AH", sim, (
            ("group/group", lambda: computes.group_group_energy(
                sim, *sim.gg_computes["gg"])),
            ("rdf 100", lambda: sim.compute_rdf("r"))))
        del L, script, sim, runner
        torch.cuda.empty_cache()

        # path AI: bench/in.lj with computes and the output fixes through
        # api.lammps, float32 on the cell grid (L's route)
        text = LJ_SCRIPT.replace("run\t\t100", AI_COMPUTES + "run\t\t100")
        with open(os.path.join(work, "in.ai"), "w") as fh:
            fh.write(text)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        L = api.lammps(cmdargs=["-log", os.path.join(work, "log.ai"),
                                "-var", "x", AI_SCALE, "-var", "y", AI_SCALE,
                                "-var", "z", AI_SCALE], dtype=torch.float32)
        L.file(os.path.join(work, "in.ai"))
        rdf = L.extract_compute("r")
        launches["AI"] = read_counts()
        peak = torch.cuda.max_memory_allocated()
        script = L.lmp
        sim = script._sim
        with open(os.path.join(work, "log.ai")) as fh:
            log = fh.read().splitlines()
        route = script_route(script)
        print(f"path AI: bench/in.lj with computes and output fixes, "
              f"{sim.natoms} atoms, float32, {route}")
        if sim.natoms > 4096 and not (
                launches["AI"]["cell_pair_forces_lj"] > 0
                and "cell_pair_forces_lj" in route):
            raise AssertionError(f"path AI launches {launches['AI']}")
        check_counts("AI", launches["AI"], {
            "cell_pair_forces_lj": launches["AI"]["cell_pair_forces_lj"]})
        rows = script.thermo_rows
        if [r["step"] for r in rows] != list(range(0, AI_STEPS + 1, 10)):
            raise AssertionError(f"path AI: rows {len(rows)}")
        check_rows_finite("AI", rows, ("temp", "epair", "etotal", "press")
                          + AI_COLS)
        for r in rows[::5]:
            print(f"  AI| step {r['step']}: " + ", ".join(
                f"{c} {r[c]:.8g}" for c in ("temp", "epair") + AI_COLS))
        check_ave_time_file("AI", os.path.join(work, "ai_time.out"), rows,
                            ("c_tr", "c_treg", "c_tp", "c_msd[4]"),
                            10, 5, 50)
        series = np.asarray(script.fixes["vec"]._series)
        want = np.array([[r["c_rpa"], r["c_rka"]] for r in rows])
        if series.shape != want.shape or not np.array_equal(series, want):
            raise AssertionError("path AI: fix vector's series is not the "
                                 "rows'")
        histo = file_lines(os.path.join(work, "ai_histo.out"))
        corr = file_lines(os.path.join(work, "ai_corr.out"))
        frames = open(os.path.join(work, "ai.dump")).read().count(
            "ITEM: TIMESTEP")
        if [int(w[0]) for w in histo if len(w) == 6] != [50, 100] \
                or frames != 3 or len(corr) != 12:
            raise AssertionError(f"path AI: histo {len(histo)} lines, "
                                 f"corr {len(corr)}, {frames} dump frames")
        print(f"path AI: ai_time.out, fix vector's {len(series)} samples "
              f"the rows'; ai_histo.out {len(histo)} lines (steps 50, 100; "
              f"{histo[0][2]} values inside over its samples to step 50), "
              f"ai_corr.out {len(corr)} lines, ai.dump {frames} frames; rdf "
              f"(100, 3) through extract_compute, g(r) peak "
              f"{rdf[:, 1].max():.4f}")
        script_peak("AI", log, AI_STEPS, peak)
        clone_check("AI", sim, AI_COLS, "r", peratom=("pa", "sa", "crd"))
        compute_timings("AI", sim, (
            ("per-atom pair pass (pe/atom, stress/atom)",
             lambda: computes.pair_pass(sim, want_stress=True)),
            ("coord/atom", lambda: computes.eval_peratom(sim, "crd")),
            ("rdf 100", lambda: sim.compute_rdf("r"))))
        row0 = rows[0]
        frame0 = open(os.path.join(work, "ai.dump")).read().split(
            "ITEM: TIMESTEP")[1]
        with open(os.path.join(work, "in.ai0"), "w") as fh:
            # the twin sets no -var: the scale goes into the script
            text0 = cut_run(text, 0)
            for a in "xyz":
                text0 = text0.replace(f"variable\t{a} index 1",
                                      f"variable\t{a} index {AI_SCALE}")
            fh.write(text0)

        def ai_twin64(twin, _row=row0):
            ref = dict(zip(twin["cols"].tolist(), twin["rows"][0]))
            worst = 0.0
            bars = {**AG_BARS, **{c: AI_COMPUTE_BAR for c in AI_COLS},
                    **{c: AI_STRESS_BAR for c in AI_COLS if "rsa" in c}}
            for k, rel in bars.items():
                bar = rel * max(1.0, abs(ref[k]))
                worst = max(worst, abs(_row[k] - ref[k]) / bar)
                if not abs(_row[k] - ref[k]) <= bar:
                    raise AssertionError(f"path AI step 0 {k}: {_row[k]!r}, "
                                         f"the float64 twin's {ref[k]!r}")
            print(f"path AI step 0 (float32 on the card) vs its float64 CPU "
                  f"twin: at {worst:.3g} of path E's bars (the computes "
                  f"{AI_COMPUTE_BAR:g}, the reduced stress "
                  f"{AI_STRESS_BAR:g}, of max(1, |value|))")

        def ai_twin32(twin, _row=row0, _frame=frame0):
            ref = dict(zip(twin["cols"].tolist(), twin["rows"][0]))
            worst = 0.0
            for k in AI_COLS:
                bar = AI_DUMP_REL * max(1.0, abs(ref[k]))
                worst = max(worst, abs(_row[k] - ref[k]) / bar)
                if not abs(_row[k] - ref[k]) <= bar:
                    raise AssertionError(f"path AI step 0 {k}: {_row[k]!r}, "
                                         f"the float32 twin's {ref[k]!r}")
            with open(os.path.join(str(twin["root"]), "ai.dump")) as fh:
                tframe = fh.read().split("ITEM: TIMESTEP")[1]
            a = [line.split() for line in _frame.splitlines()]
            b = [line.split() for line in tframe.splitlines()]
            if a != b and ([w for w in a if len(w) != 8]
                           != [w for w in b if len(w) != 8]):
                raise AssertionError("path AI: the dump frame's header")
            ga = np.array([w for w in a if len(w) == 8], float)
            gb = np.array([w for w in b if len(w) == 8], float)
            if not np.array_equal(ga[:, :2], gb[:, :2]):
                raise AssertionError("path AI: the dump's id and type")
            # x y z c_pa c_sa[1] f_avg[1]; a column of zeros (f_avg before
            # its first Nfreq) stays zeros
            scale = np.abs(gb[:, 2:]).max(0)
            diff = np.abs(ga[:, 2:] - gb[:, 2:]).max(0)
            rel = np.where(scale > 0, diff / np.where(scale > 0, scale, 1.0),
                           np.where(diff > 0, np.inf, 0.0))
            if not (rel <= AI_DUMP_REL).all():
                raise AssertionError(f"path AI: the dump frame's columns at "
                                     f"{rel} of their largest")
            print(f"path AI step 0 vs its float32 CPU twin (the same float32 "
                  f"state): the compute columns at {worst:.3g} of rel "
                  f"{AI_DUMP_REL:g} of max(1, |value|); the dump's frame 0 "
                  f"({len(ga)} rows) id and type equal, the floats x y z "
                  f"c_pa c_sa[1] f_avg[1] at " + ", ".join(
                      f"{r:.3g}" for r in rel)
                  + f" of their column's largest (bar {AI_DUMP_REL:g})")

        defer_twin("AI", work, "in.ai0", 0, ai_twin64, threads=4, cost=20.0)
        defer_twin("AI-f32", work, "in.ai0", 0, ai_twin32, threads=4,
                   cost=20.0, dtype="float32")
        del L, script, sim
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)


# paths AJ-AN: the k-space breadth from LAMMPS scripts (ewald/disp's
# dispersion sum, pppm/disp, TIP4P with pppm/tip4p and pppm/disp/tip4p,
# MSM), then the LAMMPS rows of the TIP4P styles and of MSM and the
# point-dipole function (kspace_paths)
KS_SIDE = 15                   # AJ, AK, AN: the fluid's 10,125 atoms
KS_STEPS = 20
KS_TWIN_STEPS = 3              # the CPU twins' steps: rows 0-3 compared
# AN's twin: one step, rows 0-1 (each CPU evaluation of its 3^3 grid of cap
# 640 takes ~50 s on 2 threads)
AN_TWIN_STEPS = 1
WATER_SIDE, WATER_L = 11, 34.1  # AL, AM: 1,331 waters, 3,993 atoms
WATER_STEPS = 20
WATER_COLS = ("etotal", "ke", "temp", "pe", "evdwl", "ecoul", "elong",
              "ebond", "eangle", "press")
# TIP4P/2005's geometry, charges and O-O LJ (scripts/gen_tip4p_goldens.py
# :19-22, the values its LAMMPS rows were made with)
QO, QH = -1.1128, 0.5564
R0, THETA0 = 0.9572, 104.52
QDIST = 0.1546
EPS_OO, SIG_OO = 0.1852, 3.1589
WATER_MASSES = (15.9994, 1.008)
WATER_SCRIPT = """\
variable nstep index 20
units real
atom_style full
read_data {data}
bond_style harmonic
bond_coeff 1 450.0 {r0}
angle_style harmonic
angle_coeff 1 55.0 {theta0}
{pair}
special_bonds lj/coul 0.0 0.0 0.5
neighbor 2.0 bin
velocity all create 300.0 4928459 loop geom
{run}"""
WATER_RUN = """\
timestep 2.0
fix 1 all shake 0.0001 20 0 b 1 a 1
fix 2 all nvt temp 300.0 300.0 100.0
thermo_style custom step etotal ke temp pe evdwl ecoul elong ebond eangle \
press
thermo 1
run ${nstep}
"""
AL_PAIR = (f"pair_style lj/cut/tip4p/long 1 2 1 1 {QDIST} 8.5\n"
           f"pair_coeff 1 1 {EPS_OO} {SIG_OO}\npair_coeff 2 2 0.0 0.0\n"
           "kspace_style pppm/tip4p 1.0e-5")
AM_PAIR = (f"pair_style lj/long/tip4p/long long long 1 2 1 1 {QDIST} 8.5\n"
           f"pair_coeff 1 1 {EPS_OO} {SIG_OO}\npair_coeff 2 2 0.0 0.0\n"
           "kspace_style pppm/disp/tip4p 1.0e-5")
# the five cases of tests/test_tip4p_cut.py on the 8-molecule box
# (scripts/gen_tip4p_goldens.py :79-142 CASES, make_input)
TIP4P_GOLDEN_PAIRS = {
    "tip4pcut": f"pair_style tip4p/cut 1 2 1 1 {QDIST} 5.0\npair_coeff * *",
    "ljtip4pcut": (f"pair_style lj/cut/tip4p/cut 1 2 1 1 {QDIST} 5.9 5.0\n"
                   f"pair_coeff 1 1 {EPS_OO} {SIG_OO}\npair_coeff 2 2 0.0 "
                   "0.0"),
    "tip4plong": (f"pair_style tip4p/long 1 2 1 1 {QDIST} 5.0\npair_coeff "
                  "* *\nkspace_style pppm/tip4p 1.0e-4"),
    "ljlongtip4p_cut": (
        f"pair_style lj/long/tip4p/long cut long 1 2 1 1 {QDIST} 5.9 5.0\n"
        f"pair_coeff 1 1 {EPS_OO} {SIG_OO}\npair_coeff 2 2 0.0 0.0\n"
        "kspace_style pppm/disp/tip4p 1.0e-4\nkspace_modify gewald 0.521103"),
    "ljlongtip4p_long": (
        f"pair_style lj/long/tip4p/long long long 1 2 1 1 {QDIST} 5.9 5.0\n"
        f"pair_coeff 1 1 {EPS_OO} {SIG_OO}\npair_coeff 2 2 0.0 0.0\n"
        "kspace_style pppm/disp/tip4p 1.0e-4\nkspace_modify gewald 0.521103 "
        "gewald/disp 0.28"),
}
TIP4P_GOLDEN_RUN = """\
timestep 0.2
fix 1 all nve
thermo 1
thermo_style custom step temp pe evdwl ecoul elong ebond eangle press
thermo_modify format float %.12g
run 5
"""
# the LAMMPS rows (16Mar18, rebuilt) of those cases, tests/test_tip4p_cut.py
# :22-63: step temp pe evdwl ecoul elong ebond eangle press
TIP4P_GOLDEN_COLS = ("temp", "pe", "evdwl", "ecoul", "elong", "ebond",
                     "eangle", "press")
TIP4P_GOLDEN = {
    'tip4pcut': [
        [0.0, 300.0, 32.0919872983, 0.0, 32.0919872983, 0.0, 3.24724730873e-25, 4.06051359821e-26, 968.570738187],
        [1.0, 297.826060061, -8.88888320993, 0.0, -8.98627783694, 0.0, 0.088513494793, 0.00888113221493, 244.436129027],
        [2.0, 293.264099187, -8.57486580263, 0.0, -8.95702676863, 0.0, 0.346975198177, 0.035185767823, 58.5011235308],
        [3.0, 286.394275108, -8.10201927732, 0.0, -8.93709989981, 0.0, 0.756885669626, 0.0781949528651, -129.707703068],
        [4.0, 277.647062913, -7.49997274399, 0.0, -8.92719794996, 0.0, 1.29029942289, 0.136925783082, -316.029585646],
        [5.0, 267.566113032, -6.80614479418, 0.0, -8.92794110819, 0.0, 1.91164032397, 0.210155990039, -496.029509342],
    ],
    'ljtip4pcut': [
        [0.0, 300.0, 31.9333492905, -0.15863800775, 32.0919872983, 0.0, 3.24724730873e-25, 4.06051359821e-26, 956.404640512],
        [1.0, 297.825424878, -9.04747776331, -0.158594297178, -8.98627828035, 0.0, 0.0885136917657, 0.00888112244913, 232.272264968],
        [2.0, 293.262834304, -8.73341727054, -0.158551170387, -8.95702854198, 0.0, 0.346976752006, 0.0351856898268, 46.3398640525],
        [3.0, 286.392366138, -8.26052666076, -0.158508258673, -8.93710389149, 0.0, 0.756890799005, 0.0781946904026, -141.86603084],
        [4.0, 277.644478554, -7.65843387927, -0.15846520767, -8.92720505267, 0.0, 1.29031121762, 0.136925163456, -328.184696119],
        [5.0, 267.562809166, -6.96455663509, -0.158421683364, -8.92795222141, 0.0, 1.91166248373, 0.210154785962, -508.181152362],
    ],
    'tip4plong': [
        [0.0, 300.0, -0.382946710379, 0.0, 1504.66437039, -1505.0473171, 3.24724730873e-25, 4.06051359821e-26, 534.752678013],
        [1.0, 298.555470982, -0.286620199243, 0.0, 1504.45973653, -1504.84438979, 0.0890808578837, 0.00895220456817, 351.554007651],
        [2.0, 294.357522858, 0.00234892044296, 0.0, 1504.25500284, -1504.63900152, 0.350607580869, 0.0357400158977, 157.887875077],
        [3.0, 287.6522113, 0.463850871337, 0.0, 1504.04957013, -1504.43367013, 0.767936553911, 0.0800143186641, -43.211255083],
        [4.0, 278.833010092, 1.07080206321, 0.0, 1503.84608532, -1504.23099056, 1.31460011816, 0.141107184633, -247.457580552],
        [5.0, 268.415920808, 1.7876845101, 0.0, 1503.64723723, -1504.03358637, 1.95598563041, 0.218048015276, -450.183280415],
    ],
    'ljlongtip4p_cut': [
        [0.0, 300.0, -0.439435361031, -0.15863800775, 1409.81987676, -1410.10067412, 3.24724730873e-25, 4.06051359821e-26, 521.256430613],
        [1.0, 298.551208987, -0.348154781034, -0.158593998369, 1409.64360064, -1409.93119513, 0.08908199751, 0.00895170735857, 336.766652616],
        [2.0, 294.34930684, -0.0579869766052, -0.158549861863, 1409.47409156, -1409.75988308, 0.350618359297, 0.0357360402313, 143.013021977],
        [3.0, 287.63977927, 0.404701441143, -0.158505226894, 1409.30400625, -1409.58877456, 0.767974044323, 0.0800009391059, -58.1586523481],
        [4.0, 278.81601971, 1.01282747447, -0.158459732874, 1409.13549107, -1409.41996794, 1.31468844253, 0.141075636977, -262.461690331],
        [5.0, 268.393981393, 1.73084887493, -0.158413036162, 1408.97070551, -1409.25558435, 1.95615388056, 0.217986871775, -465.227157797],
    ],
    'ljlongtip4p_long': [
        [0.0, 300.0, -0.68656059321, -0.0853489549344, 1409.81987676, -1410.4210884, 3.24724730873e-25, 4.06051359821e-26, 502.274759841],
        [1.0, 298.551347392, -0.595283897253, -0.0853143924021, 1409.64360059, -1410.25160376, 0.089081948359, 0.008951711027, 317.785050743],
        [2.0, 294.34958774, -0.305120208403, -0.0852796856295, 1409.47409137, -1410.08028593, 0.350617970109, 0.035736069235, 124.031394573],
        [3.0, 287.640211676, 0.157563469742, -0.0852446229345, 1409.30400581, -1409.90917151, 0.767972754692, 0.0800010356772, -77.1403884555],
        [4.0, 278.816616917, 0.765683773402, -0.0852089997048, 1409.13549031, -1409.74035887, 1.31468546562, 0.14107586244, -281.443610569],
        [5.0, 268.394760043, 1.48369830625, -0.0851724904123, 1408.97070434, -1409.57596911, 1.95614826528, 0.217987304811, -484.20931629],
    ],
}
# the LAMMPS rows of lj/cut/coul/msm + msm (32^3, order 10, cutoff/adjust
# no) on scripts/gen_breadth_goldens.py's 64-atom box, tests/test_msm.py
# :208-251: step -> temp pe evdwl ecoul elong press
MSM_GOLDEN = {
    0: (1.0, -2.00554866157, -1.42299977076, -0.046983932177,
        -0.535564958637, -0.514594621195),
    5: (1.00633887599, -2.00241169314, -1.4195991171,
        -0.0476721452896, -0.535140430753, -0.50633974749),
}
MSM_GOLDEN_SCRIPT = """\
units lj
atom_style charge
read_data data.breadth
pair_style lj/cut/coul/msm 2.2 2.5
pair_coeff 1 1 1.0 1.0
pair_coeff 2 2 0.8 1.1
kspace_style msm 1.0e-4
kspace_modify cutoff/adjust no
velocity all create 1.0 87287 loop geom
timestep 0.005
fix 1 all nve
thermo 1
run 5
"""


def water_layout(nside, L, seed=7, jitter=0.4):
    """scripts/gen_tip4p_goldens.py write_water_data's layout: nside^3
    flexible TIP4P/2005 waters, O on a grid of spacing L/nside offset by a
    uniform jitter (its 0.4 A by default), each H1-O-H2 at R0 and THETA0
    rotated by a random unit quaternion, in an L^3 box (atom_style full:
    ids O, H1, H2 in turn, types 1 and 2); as the namespace of
    interpreter arrays the port's data writer (io/data_writer.py
    write_data) reads, the positions at 15 significant digits as that
    writer's file holds them."""
    import types

    import numpy as np

    rng = np.random.RandomState(seed)
    th = math.radians(THETA0)
    h1 = np.array([R0 * math.sin(th / 2), R0 * math.cos(th / 2), 0.0])
    h2 = np.array([-R0 * math.sin(th / 2), R0 * math.cos(th / 2), 0.0])
    x, bonds, angles = [], [], []
    for mi in range(nside ** 3):
        i, j, k = mi % nside, (mi // nside) % nside, mi // nside ** 2
        o = (np.array([i, j, k]) + 0.5) * (L / nside) \
            + rng.uniform(-jitter, jitter, 3)
        q = rng.normal(size=4)
        w, a, b, c = q / np.linalg.norm(q)
        rot = np.array([
            [1 - 2 * (b * b + c * c), 2 * (a * b - w * c), 2 * (a * c + w * b)],
            [2 * (a * b + w * c), 1 - 2 * (a * a + c * c), 2 * (b * c - w * a)],
            [2 * (a * c - w * b), 2 * (b * c + w * a), 1 - 2 * (a * a + b * b)]])
        x += [o, o + rot @ h1, o + rot @ h2]
        bonds += [(3 * mi + 1, 3 * mi + 2), (3 * mi + 1, 3 * mi + 3)]
        angles.append((3 * mi + 2, 3 * mi + 1, 3 * mi + 3))
    nmol = nside ** 3
    x = np.array([[float(f"{v:.15g}") for v in p] for p in x])
    return types.SimpleNamespace(
        _sim=None, x=x, v=np.zeros_like(x), box_lo=np.zeros(3),
        box_hi=np.full(3, float(L)), q=np.tile([QO, QH, QH], nmol),
        mol=np.repeat(np.arange(1, nmol + 1), 3), atom_style="full",
        ntypes=2, type=np.tile([1, 2, 2], nmol),
        mass_type=np.array([0.0, *WATER_MASSES]),
        _bonds=np.array(bonds), _bond_types=np.ones(len(bonds), int),
        bond_coeffs={1: [450.0, R0]}, _angles=np.array(angles),
        _angle_types=np.ones(len(angles), int),
        angle_coeffs={1: [55.0, THETA0]}, _dihedrals=None,
        _dihedral_types=None, dihedral_coeffs={}, _impropers=None,
        _improper_types=None, improper_coeffs={})


# path AV: flexible SPC-like waters under tests/test_hbond.py's forms
# (lj/cut beside hbond/dreiding/lj through hybrid/overlay), here with
# the erfc coulomb and pppm
HBOND_Q = (-0.8, 0.4)          # tests/test_hbond.py write_data's charges
HBOND_DENSITY = 1.0            # g/cm^3
HBOND_SCRIPT = """\
variable nstep index 10
units real
atom_style full
read_data {data}
bond_style harmonic
bond_coeff 1 450.0 {r0}
angle_style harmonic
angle_coeff 1 55.0 {theta0}
{pair}special_bonds lj/coul 0.0 0.0 0.5
neighbor 2.0 bin
velocity all create 300.0 4928459 loop geom
timestep 1.0
fix 1 all nvt temp 300.0 300.0 100.0
thermo_style custom step etotal ke temp pe evdwl ecoul elong ebond eangle \
press
thermo 1
run ${{nstep}}
"""
# the hbond styles' settings and coefficients (tests/test_hbond.py HB_LINE)
HBOND_FORMS = {
    "lj": ("hbond/dreiding/lj", "4 6.0 8.0 90", "3.5 2.75 4"),
    "morse": ("hbond/dreiding/morse", "2 6.0 8.0 90", "3.88 1.7241379 2.9 2"),
}


def hbond_script(form="lj", alone=False, cut="10.0"):
    """HBOND_SCRIPT for the data file hbond.data: hybrid/overlay
    lj/cut/coul/long `cut` (with pppm 1e-4) beside hbond/dreiding/<form>,
    in tests/test_hbond.py's coefficient forms; alone: the hbond style by
    itself, without k-space."""
    style, settings, coeffs = HBOND_FORMS[form]
    if alone:
        pair = (f"pair_style {style} {settings}\n"
                f"pair_coeff 1 1 2 i {coeffs}\n")
    else:
        pair = (f"pair_style hybrid/overlay lj/cut/coul/long {cut} {style} "
                f"{settings}\n"
                "pair_coeff 1 1 lj/cut/coul/long 0.1553 3.166\n"
                "pair_coeff 2 2 lj/cut/coul/long 0.0 1.0\n"
                "pair_coeff 1 2 lj/cut/coul/long 0.0 2.083\n"
                f"pair_coeff 1 1 {style} 2 i {coeffs}\n"
                "kspace_style pppm 1e-4\n")
    return HBOND_SCRIPT.format(data="hbond.data", r0=R0, theta0=THETA0,
                               pair=pair)


def hbond_water_layout(nwater, seed=5):
    """nwater flexible waters at HBOND_DENSITY in a cube (1,000: 31.04 A):
    the O on the first nwater sites, in a seeded order, of a k^3 grid (k
    the cube root rounded up) and each water turned by a random unit
    quaternion (water_layout's form), the charges HBOND_Q; the namespace
    the port's data writer reads."""
    import numpy as np

    L = (nwater * (WATER_MASSES[0] + 2 * WATER_MASSES[1]) / 0.602214076
         / HBOND_DENSITY) ** (1.0 / 3.0)
    k = int(math.ceil(nwater ** (1.0 / 3.0) - 1e-9))
    d = water_layout(k, L, seed=seed, jitter=0.0)
    sites = np.sort(np.random.RandomState(seed).permutation(k ** 3)[:nwater])
    rows = (3 * sites[:, None] + np.arange(3)).reshape(-1)
    new_id = np.full(3 * k ** 3 + 1, -1)
    new_id[rows + 1] = np.arange(1, 3 * nwater + 1)
    keep_b = np.all(new_id[d._bonds] > 0, axis=1)
    keep_a = np.all(new_id[d._angles] > 0, axis=1)
    d.x, d.v = d.x[rows], d.v[rows]
    d.q = np.tile(HBOND_Q[:1] + HBOND_Q[1:] * 2, nwater)
    d.mol = np.repeat(np.arange(1, nwater + 1), 3)
    d.type = np.tile([1, 2, 2], nwater)
    d._bonds = new_id[d._bonds[keep_b]]
    d._bond_types = np.ones(len(d._bonds), int)
    d._angles = new_id[d._angles[keep_a]]
    d._angle_types = np.ones(len(d._angles), int)
    return d


def write_breadth_data(path, one_type=False):
    """scripts/gen_breadth_goldens.py write_data's 64-atom box (two
    types; one with one_type): a 4^3 simple cubic lattice in a 6^3 box,
    checkerboard charges +-1 and types 1/2, the RandomState(12345) jitter:
    the file MSM_GOLDEN and BREADTH_GOLDEN were made on."""
    import numpy as np

    rng = np.random.RandomState(12345)
    pos, typ, q = [], [], []
    for i in range(4):
        for j in range(4):
            for k in range(4):
                pos.append((np.array([i, j, k]) + 0.5) * 1.5)
                parity = (i + j + k) % 2
                typ.append(1 if one_type else 1 + parity)
                q.append(1.0 if parity == 0 else -1.0)
    pos = np.array(pos) + rng.uniform(-0.05, 0.05, (len(pos), 3))
    with open(path, "w") as f:
        f.write("breadth golden box\n\n")
        f.write(f"{len(pos)} atoms\n{1 if one_type else 2} atom types\n\n")
        f.write("0.0 6.0 xlo xhi\n0.0 6.0 ylo yhi\n0.0 6.0 zlo zhi\n\n")
        f.write("Masses\n\n1 1.0\n" + ("" if one_type else "2 1.5\n")
                + "\n")
        f.write("Atoms\n\n")
        for m, (p, t, qq) in enumerate(zip(pos, typ, q), start=1):
            f.write(f"{m} {t} {qq:.1f} {p[0]:.15g} {p[1]:.15g} "
                    f"{p[2]:.15g}\n")


def ks_term_calls(sim):
    """The k-space breadth's terms on sim's state, each the call
    forcefield.compute_forces makes (the charge sums on the TIP4P charge
    sites), and the pair term: label -> a callable."""
    from lidp_tpu_torch.ops import ewald, msm, pppm, tip4p
    from lidp_tpu_torch.ops.cells import cell_pair_forces
    from lidp_tpu_torch.ops.pair import dense_pair_forces

    s, ff = sim.sys, sim.runner.ff
    x, L = s.x, s.box.lengths
    xk = x if ff.tip4p is None else tip4p.charge_sites(x, s.box, ff.tip4p)
    calls = {}
    if sim.nlist is None:
        sp = ff.sp_code if ff.sp_code is not None else 0
        calls["pair (dense_pair_forces)"] = lambda: dense_pair_forces(
            x, s.q, s.type, sp, s.mask, s.box, ff.pair, mol=s.mol)
    else:
        calls["pair (cell_pair_forces)"] = lambda: cell_pair_forces(
            x, s.q, s.type, s.mask, sim.nlist.nlist, s.box, ff.pair,
            mol=s.mol)
    if ff.tip4p is not None:
        sp4 = ff.sp_code if ff.sp_code is not None else 0
        calls["tip4p_coul_dense"] = lambda: tip4p.tip4p_coul_dense(
            x, s.q, sp4, s.mask, s.box, ff.pair.cut_coulsq,
            ff.pair.g_ewald, ff.qqrd2e, ff.pair.special_coul, ff.tip4p,
            mode="cut" if ff.tip4p_cut else "long")
    if ff.ewald is not None:
        calls["ewald_forces"] = lambda: ewald.ewald_forces(
            xk, s.q, s.box.volume, ff.ewald)
    if ff.pppm is not None:
        calls["pppm_forces_params"] = lambda: pppm.pppm_forces_params(
            xk - s.box.lo, s.q, L, ff.pppm)
    if ff.msm is not None:
        calls["msm_forces"] = lambda: msm.msm_forces(x - s.box.lo, s.q, L,
                                                     ff.msm)
    if ff.pppm_disp is not None:
        calls["pppm_disp_forces"] = lambda: pppm.pppm_disp_forces(
            x - s.box.lo, ff.b_atom, L, ff.pppm_disp)
    if ff.ewald6 is not None:
        calls["ewald6_forces"] = lambda: ewald.ewald6_forces(
            x, ff.b_atom, s.box.volume, ff.ewald6)
    return calls


def ks_readings(path, sim):
    """A path's terms (ks_term_calls) timed on its final state by CUDA
    events after a warm-up, ms a call; for each mesh term (the spreads add
    by index_add_) the difference between two calls on one state, of
    max |f| and of |E|."""
    calls = ks_term_calls(sim)
    parts = []
    for label, fn in calls.items():
        parts.append(f"{label} {cuda_ms(fn, reps=3, warmup=1):.4f}")
    print(f"path {path} ms a call by CUDA events on its final state: "
          + ", ".join(parts) + f"; {smi_line()}")
    for label in ("pppm_forces_params", "msm_forces", "pppm_disp_forces"):
        if label in calls:
            (f1, e1, _), (f2, e2, _) = calls[label](), calls[label]()
            df = float((f1 - f2).abs().max() / f1.abs().max())
            de = abs(float(e1 - e2)) / abs(float(e1))
            print(f"path {path} {label}: two calls on one state differ by "
                  f"{df:.3e} of max |f|, {de:.3e} of |E| (the spread's "
                  "index_add_)")


def ks_state_check(path, sim):
    """compute_forces on the card against the same on the CPU from the
    card's final state (to_cpu of the System, the force field and the
    cell grid): f, the energies and the virial within rel 1e-9 of max(1,
    |value|) (f of its largest entry), plus CANCEL_REL of what the special
    correction cancels on the cell grid."""
    from lidp_tpu_torch.forcefield import compute_forces
    from lidp_tpu_torch.ops.bonded import special_correction_sparse

    s, ff = sim.sys, sim.runner.ff
    nl = None if sim.nlist is None else sim.nlist.nlist
    res = compute_forces(s, ff, nl)
    sc, ffc = to_cpu(s), to_cpu(ff)
    ref = compute_forces(sc, ffc, to_cpu(nl))
    cancel = dict(f=0.0, evdwl=0.0, ecoul=0.0, elong=0.0, virial=0.0)
    if nl is not None and ffc.sp_idx is not None:
        fc, dev, dec, dvir = special_correction_sparse(
            sc.x, sc.q, sc.type, ffc.sp_idx, ffc.sp_lvl, sc.mask, sc.box,
            ffc.pair)
        cancel.update(f=float(fc.abs().max()), evdwl=abs(float(dev)),
                      ecoul=abs(float(dec)), virial=float(dvir.abs().max()))
    worst = 0.0
    for k in ("f", "evdwl", "ecoul", "elong", "virial"):
        a, b = getattr(res, k).cpu(), getattr(ref, k)
        bar = 1e-9 * max(1.0, float(b.abs().max())) + CANCEL_REL * cancel[k]
        err = float((a - b).abs().max())
        worst = max(worst, err / bar)
        if not err <= bar:
            raise AssertionError(f"path {path} {k} on the card vs the CPU on "
                                 f"its state: {err:.3e} above {bar:.3e}")
    print(f"path {path}: compute_forces on the card vs the CPU on the card's "
          f"final state: f, E_vdwl, E_coul, E_long and the virial at "
          f"{worst:.3g} of their bar (rel 1e-9 of max(1, |value|)"
          + (f" + {CANCEL_REL:g} of the cancelled magnitude)" if nl is not
             None else ")"))


def ks_path(path, work, name, text, steps, cells, launches, reset_counts,
            read_counts, cols, twin_threads, twin_cost,
            twin_steps=KS_TWIN_STEPS):
    """One k-space path: `text` (written to work/name) through
    LammpsScript in float64 on the card for `steps` steps, its launches
    (0 in every counter), route, log, finite rows, steps/s by the Loop
    time line, peak memory, its terms' ms (ks_readings), the state check
    (ks_state_check) and its CPU twin (`twin_steps` steps, rows at rel
    1e-9 of max(1, |value|), plus CANCEL_REL of the cancelled magnitude
    on the cell grid).  Returns the script."""
    import torch

    from lidp_tpu_torch.forcefield import pair_route
    from lidp_tpu_torch.io.script import LammpsScript

    with open(os.path.join(work, name), "w") as fh:
        fh.write(text)
    logs = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    script = LammpsScript(dtype=torch.float64, log=logs.append)
    script.variables["nstep"] = str(steps)
    script.file(os.path.join(work, name))
    launches[path] = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check_counts(path, launches[path], {})
    sim = script._sim
    print(f"path {path}: {sim.natoms} atoms, float64, {steps} steps: "
          f"{script_route(script)}; its log:")
    for line in logs:
        print(f"  {path}| {line}")
    on_cells = sim.runner.neighbor_cfg is not None
    if on_cells != cells or (cells and (
            pair_route(sim.sys, sim.runner.ff, sim.nlist.nlist)
            != "cell_pair_forces" or bool(sim.nlist.overflow))):
        raise AssertionError(f"path {path}: {script_route(script)}")
    rows = script.thermo_rows
    if len(rows) != steps + 1:
        raise AssertionError(f"path {path}: {len(rows)} rows")
    check_rows_finite(path, rows, cols)
    script_peak(path, logs, steps, peak)
    ks_readings(path, sim)
    ks_state_check(path, sim)
    defer_twin(path, work, name, twin_steps,
               twin_check(path, (rows, None), cols,
                          cancel=cancelled(sim) if cells else None),
               threads=twin_threads, cost=twin_cost)
    return script


def dipole_phase(x, lengths, q):
    """ewald_dipole_forces on the card at the fluid's 10,125 atoms (its
    charge function's k set at accuracy 1e-4, seeded dipoles) against the
    same call on the CPU: f within 1e-10 of max |f|, the energy rel 1e-10;
    its ms a call and peak memory."""
    import numpy as np
    import torch

    from lidp_tpu_torch.ops.ewald import ewald_dipole_forces, setup_ewald_disp

    n = x.shape[0]
    es = setup_ewald_disp(accuracy_rel=1e-4, qqrd2e=332.06371,
                          q=q.cpu().numpy(), natoms=n, cutoff=6.5,
                          box_lengths=lengths.cpu().numpy())
    mu = torch.as_tensor(0.3 * np.random.RandomState(21).normal(
        size=(n, 3)), dtype=torch.float64)
    vol = float(torch.prod(lengths))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    f, e = ewald_dipole_forces(x, mu.cuda(), vol, es, scale=332.06371)
    peak = torch.cuda.max_memory_allocated()
    fc, ec = ewald_dipole_forces(x.cpu(), mu, vol, es, scale=332.06371)
    err = float((f.cpu() - fc).abs().max() / fc.abs().max())
    erel = abs(float(e) - float(ec)) / abs(float(ec))
    if not (err <= 1e-10 and erel <= 1e-10):
        raise AssertionError(f"ewald_dipole_forces on the card vs the CPU: "
                             f"f {err:.3e}, E {erel:.3e}")
    ms = cuda_ms(lambda: ewald_dipole_forces(x, mu.cuda(), vol, es,
                                             scale=332.06371), reps=3,
                 warmup=1)
    print(f"ewald_dipole_forces at {n} atoms, K {len(es.hvecs)}, float64: "
          f"card vs CPU f at {err:.3e} of max |f|, E at {erel:.3e} (bar "
          f"1e-10); {ms:.4f} ms a call by CUDA events; peak "
          f"{peak / 2**20:.1f} MiB; {smi_line()}")


def golden_phases():
    """tests/test_tip4p_cut.py's five cases on the 8-molecule box and
    tests/test_msm.py's 32^3 case through LammpsScript in float64 on the
    card, each row against the LAMMPS rows at those tests' tolerances
    (the TIP4P k-space cases at the mesh band: rel 1e-3 or abs 0.2, Press
    rel 5e-2 or abs 25)."""
    import torch

    from lidp_tpu_torch.io.data_writer import write_data
    from lidp_tpu_torch.io.script import LammpsScript

    work = tempfile.mkdtemp(prefix="chip_smoke_gold_")
    try:
        write_data(os.path.join(work, "data.tip4p"), water_layout(2, 12.0))
        for case, pair in TIP4P_GOLDEN_PAIRS.items():
            path = os.path.join(work, f"in.{case}")
            with open(path, "w") as fh:
                fh.write(WATER_SCRIPT.format(
                    data="data.tip4p", r0=R0, theta0=THETA0, pair=pair,
                    run=TIP4P_GOLDEN_RUN))
            s = LammpsScript(dtype=torch.float64, log=lambda line: None)
            s.file(path)
            band = case in ("tip4plong", "ljlongtip4p_cut",
                            "ljlongtip4p_long")
            worst = 0.0
            for r, ref in zip(s.thermo_rows, TIP4P_GOLDEN[case]):
                for name, g in zip(TIP4P_GOLDEN_COLS, ref[1:]):
                    rel, ab = ((5e-2, 25.0) if band and name == "press"
                               else (1e-3, 0.2) if band else (2e-5, 2e-6))
                    bar = max(rel * abs(g), ab)
                    worst = max(worst, abs(r[name] - g) / bar)
                    if not abs(r[name] - g) <= bar:
                        raise AssertionError(
                            f"{case} step {int(r['step'])} {name}: "
                            f"{r[name]!r}, LAMMPS {g!r}")
            if len(s.thermo_rows) != 6:
                raise AssertionError(f"{case}: {len(s.thermo_rows)} rows")
            print(f"golden {case} (tests/test_tip4p_cut.py): 6 rows at "
                  f"{worst:.3g} of that test's bars")
        write_breadth_data(os.path.join(work, "data.breadth"))
        path = os.path.join(work, "in.msm")
        with open(path, "w") as fh:
            fh.write(MSM_GOLDEN_SCRIPT)
        s = LammpsScript(dtype=torch.float64, log=lambda line: None)
        s.file(path)
        if s._sim.runner.ff.msm.grid != (32, 32, 32):
            raise AssertionError(f"msm golden: grid {s._sim.runner.ff.msm}")
        rows = {int(r["step"]): r for r in s.thermo_rows}
        worst = 0.0
        for step, ref in MSM_GOLDEN.items():
            for name, g, rel in zip(
                    ("temp", "pe", "evdwl", "ecoul", "elong", "press"), ref,
                    (2e-6, 2e-6, 2e-6, 2e-5, 2e-5, 2e-3)):
                worst = max(worst, abs(rows[step][name] - g) / (rel * abs(g)))
                if not abs(rows[step][name] - g) <= rel * abs(g):
                    raise AssertionError(f"msm golden step {step} {name}: "
                                         f"{rows[step][name]!r}, LAMMPS {g!r}")
        print(f"golden msm (tests/test_msm.py, 32^3, order 10): steps 0 and "
              f"5 at {worst:.3g} of that test's bars")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def kspace_paths(launches, reset_counts, read_counts):
    """Paths AJ, AK, AL, AM and AN, the goldens and the point-dipole
    function (module docstring).  Each path sets launches[path]."""
    import torch

    from lidp_tpu_torch.io.data_writer import write_data

    fluid_pair = "pair_style lj/cut/coul/long 6.0 6.5"
    work = tempfile.mkdtemp(prefix="chip_smoke_ks_")
    try:
        fluid_script_case(work, n_side=KS_SIDE)
        base = point_charge_script().replace(
            "read_data fluid.data\n",
            f"read_data fluid.data\nneighbor {CELL_SKIN} bin\n")
        aj = base.replace(
            fluid_pair, "pair_style lj/long/coul/long long long 6.0 6.5")
        s = ks_path("AJ", work, "in.aj", aj, KS_STEPS, True, launches,
                    reset_counts, read_counts, G64_COLS, 2, 60.0)
        sys_ = s._sim.sys
        n = s._sim.natoms
        x_aj, len_aj, q_aj = sys_.x[:n].clone(), sys_.box.lengths.clone(), \
            sys_.q[:n].clone()
        del s, sys_
        ks_path("AK", work, "in.ak",
                aj.replace("kspace_style ewald/disp 1e-4",
                           "kspace_style pppm/disp 1e-4"),
                KS_STEPS, True, launches, reset_counts, read_counts,
                G64_COLS, 2, 30.0)
        ks_path("AN", work, "in.an",
                base.replace(fluid_pair,
                             "pair_style lj/cut/coul/msm 6.0 6.5").replace(
                    "kspace_style ewald/disp 1e-4", "kspace_style msm 1e-4"),
                KS_STEPS, True, launches, reset_counts, read_counts,
                G64_COLS, 2, 130.0, twin_steps=AN_TWIN_STEPS)
        torch.cuda.empty_cache()
        dipole_phase(x_aj, len_aj, q_aj)
        del x_aj
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)

    work = tempfile.mkdtemp(prefix="chip_smoke_water_")
    try:
        data = os.path.join(work, "water.data")
        write_data(data, water_layout(WATER_SIDE, WATER_L, jitter=0.0))
        for path, pair in (("AL", AL_PAIR), ("AM", AM_PAIR)):
            text = WATER_SCRIPT.format(data="water.data", r0=R0,
                                       theta0=THETA0, pair=pair,
                                       run=WATER_RUN)
            ks_path(path, work, f"in.{path}", text, WATER_STEPS, False,
                    launches, reset_counts, read_counts, WATER_COLS, 2,
                    40.0)
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    golden_phases()


# the other pair styles (pair_style_paths): AO, the NaCl melt under the
# Born-Mayer-Huggins (Tosi-Fumi) model on the rocksalt lattice; AP, the
# same as hybrid/overlay born + coul/long; AQ, examples/melt through
# pair_write and pair_style table; AR, a Groot-Warren DPD fluid; then the
# breadth goldens (breadth_golden_phases)
NACL_A = 5.64                  # the rocksalt lattice constant, A
NACL_SIDE = 16                 # AO, AP: 16^3 cells, 32,768 ions
NACL_TWIN_SIDE = 10            # AO-8k: 10^3 cells, 8,000 ions (still cells)
NACL_STEPS = 20
AP_STEPS = 5
NACL_MASSES = (22.98977, 35.453)
# pair_coeff A rho sigma C D of Na-Na, Na-Cl, Cl-Cl (eV, A)
NACL_BORN = (("1 1", "0.2637 0.317 2.340 1.0486 -0.4993"),
             ("1 2", "0.2110 0.317 2.755 6.9906 -8.6758"),
             ("2 2", "0.1582 0.317 3.170 75.0547 -150.7520"))
NACL_CUT = "9.0"
NACL_SCRIPT = """\
variable nstep index 20
units metal
atom_style full
read_data {data}
{pair}
kspace_style pppm 1e-5
velocity all create 1100.0 4928459 loop geom
fix 1 all nvt temp 1100.0 1100.0 0.1
timestep 0.002
thermo_style custom step temp pe evdwl ecoul elong press
thermo 1
run ${{nstep}}
"""
NACL_COLS = ("temp", "pe", "evdwl", "ecoul", "elong", "press")
AQ_STEPS = 100
AQ_N = 2000                    # the table's rows (tests/test_pair_table.py)
MELT_COLS = ("temp", "epair", "emol", "etotal", "press")
DPD_N, DPD_L = 3000, 10.0      # AR: rho 3 (Groot and Warren 1997)
DPD_STEPS = 100
DPD_SCRIPT = """\
variable nstep index 100
units lj
atom_style atomic
read_data dpd.data
pair_style dpd 1.0 1.0 34387
pair_coeff 1 1 25.0 4.5
comm_modify vel yes
timestep 0.04
fix 1 all nve
thermo_style custom step temp pe ke etotal press
thermo 1
run ${nstep}
"""
DPD_COLS = ("temp", "pe", "ke", "etotal", "press")
DPD_SUM_BAR = 1e-10            # |sum of f| over max |f|, every step
PAIR_TWIN_STEPS = 2            # AQ's and AR's twins: rows 0-2


def nacl_born_pair(overlay=False, cut=NACL_CUT):
    """AO's pair lines: born/coul/long 9.0 with NACL_BORN; AP's the same
    physics as hybrid/overlay born 9.0 coul/long 9.0."""
    if overlay:
        head = f"pair_style hybrid/overlay born {cut} coul/long {cut}\n"
        return head + "".join(f"pair_coeff {ij} born {c}\n"
                              for ij, c in NACL_BORN) \
            + "pair_coeff * * coul/long\n"
    return f"pair_style born/coul/long {cut}\n" + "".join(
        f"pair_coeff {ij} {c}\n" for ij, c in NACL_BORN)


def nacl_layout(nside, a=NACL_A):
    """nside^3 rocksalt cells of Na+ (type 1) and Cl- (type 2), lattice
    constant a, shifted by a/4 so that no lattice plane lies on a cell-grid
    bin edge (a bin of 2a would take five planes a side and overfill), as
    the interpreter arrays the port's data writer (io/data_writer.py
    write_data) reads; atom_style full (the writer keeps the charges in
    the full layout only, as the JAX package's does), each ion its own
    molecule."""
    import types

    import numpy as np

    basis = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5],
                      [0, 0.5, 0.5]])
    g = np.stack(np.meshgrid(*[np.arange(nside)] * 3, indexing="ij"),
                 -1).reshape(-1, 1, 3)
    na = ((g + basis + 0.25) * a).reshape(-1, 3)
    cl = ((g + basis + np.array([0.75, 0.25, 0.25])) * a).reshape(-1, 3)
    x = np.concatenate([na, cl])
    n = x.shape[0]
    typ = np.repeat([1, 2], n // 2)
    return types.SimpleNamespace(
        _sim=None, x=x, v=np.zeros_like(x), box_lo=np.zeros(3),
        box_hi=np.full(3, nside * a), q=np.where(typ == 1, 1.0, -1.0),
        mol=np.arange(1, n + 1), atom_style="full", ntypes=2, type=typ,
        mass_type=np.array([0.0, *NACL_MASSES]), _bonds=None,
        _bond_types=None, bond_coeffs={}, _angles=None, _angle_types=None,
        angle_coeffs={}, _dihedrals=None, _dihedral_types=None,
        dihedral_coeffs={}, _impropers=None, _improper_types=None,
        improper_coeffs={})


def dpd_layout(n, L, seed=11):
    """AR's beads: n positions uniform in an L^3 box from RandomState(seed),
    at rest, mass 1, one type, as the interpreter arrays the port's data
    writer reads (atom_style atomic)."""
    import types

    import numpy as np

    x = np.random.RandomState(seed).uniform(0.0, L, (n, 3))
    return types.SimpleNamespace(
        _sim=None, x=x, v=np.zeros_like(x), box_lo=np.zeros(3),
        box_hi=np.full(3, float(L)), q=np.zeros(n), mol=np.zeros(n, int),
        atom_style="atomic", ntypes=1, type=np.ones(n, int),
        mass_type=np.array([0.0, 1.0]), _bonds=None, _bond_types=None,
        bond_coeffs={}, _angles=None, _angle_types=None, angle_coeffs={},
        _dihedrals=None, _dihedral_types=None, dihedral_coeffs={},
        _impropers=None, _improper_types=None, improper_coeffs={})


def table_melt_script(pair):
    """examples/melt (MELT_SCRIPT, path M's input) without its dump, with
    `pair_style ...` lines `pair`, a thermo row a step and `run
    ${nstep}`."""
    text = MELT_SCRIPT.replace(
        "pair_style\tlj/cut 2.5\npair_coeff\t1 1 1.0 1.0 2.5", pair)
    text = text.replace("dump\t\tid all atom 50 dump.melt\n", "")
    text = text.replace("thermo\t\t50\nrun\t\t250",
                        "thermo\t\t1\nrun\t\t${nstep}")
    return f"variable nstep index {AQ_STEPS}\n" + text


# the breadth goldens on the card (breadth_golden_phases): the rows of
# tests/test_pair_breadth2.py:32-170 (GOLDEN: a rebuilt 16Mar18 LAMMPS on
# a 64-atom charge checkerboard; step temp pe evdwl ecoul press) and the
# inputs of scripts/gen_breadth_goldens.py:76-139 (CASES: units,
# timestep, the pair lines, the data file), copied
BREADTH_CASES = {
    'lj96': ('lj', 0.005, [
        'pair_style lj96/cut 2.5',
        'pair_coeff 1 1 1.0 1.0',
        'pair_coeff 2 2 0.8 1.1',
    ]),
    'ljsmooth': ('lj', 0.005, [
        'pair_style lj/smooth 2.0 2.5',
        'pair_coeff 1 1 1.0 1.0',
        'pair_coeff 2 2 0.8 1.1',
    ]),
    'ljsmoothlin': ('lj', 0.005, [
        'pair_style lj/smooth/linear 2.5',
        'pair_coeff 1 1 1.0 1.0',
        'pair_coeff 2 2 0.8 1.1',
    ]),
    'ufm': ('lj', 0.005, [
        'pair_style ufm 2.5',
        'pair_coeff 1 1 2.0 1.2',
        'pair_coeff 1 2 1.73205080756887729 1.29614813968157218',
        'pair_coeff 2 2 1.5 1.4',
    ]),
    'beck': ('lj', 0.005, [
        'pair_style beck 2.5',
        'pair_coeff * * 5.0 1.0 0.9 3.0 0.2',
    ]),
    'zbl': ('metal', 1e-05, [
        'pair_style zbl 2.0 2.5',
        'pair_coeff 1 1 13 13',
        'pair_coeff 1 2 13 29',
        'pair_coeff 2 2 29 29',
    ]),
    'couldsf': ('lj', 0.005, [
        'pair_style coul/dsf 0.5 2.5',
        'pair_coeff * *',
    ]),
    'coulwolf': ('lj', 0.005, [
        'pair_style coul/wolf 0.5 2.5',
        'pair_coeff * *',
    ]),
    'ljdsf': ('lj', 0.005, [
        'pair_style lj/cut/coul/dsf 0.5 2.2 2.5',
        'pair_coeff 1 1 1.0 1.0',
        'pair_coeff 2 2 0.8 1.1',
    ]),
    'ljwolf': ('lj', 0.005, [
        'pair_style lj/cut/coul/wolf 0.5 2.5',
        'pair_coeff 1 1 1.0 1.0',
    ], 'data.breadth1'),
    'hybover': ('lj', 0.005, [
        'pair_style hybrid/overlay lj/cut 2.5 coul/dsf 0.5 2.5',
        'pair_coeff 1 1 lj/cut 1.0 1.0',
        'pair_coeff 1 2 lj/cut 0.9 1.05',
        'pair_coeff 2 2 lj/cut 0.8 1.1',
        'pair_coeff * * coul/dsf',
    ]),
    'hybrid': ('lj', 0.005, [
        'pair_style hybrid lj/cut 2.5 morse 3.0',
        'pair_coeff 1 1 lj/cut 1.0 1.0',
        'pair_coeff 1 2 lj/cut 0.9 1.05',
        'pair_coeff 2 2 morse 2.0 1.5 1.2',
    ]),
    'hybmix': ('lj', 0.005, [
        'pair_style hybrid/overlay lj/cut 2.5 morse 3.0',
        'pair_coeff 1 1 lj/cut 1.0 1.0',
        'pair_coeff 2 2 lj/cut 0.8 1.1',
        'pair_coeff 1 2 morse 0.5 1.5 1.6',
    ]),
    'borndsf': ('lj', 0.005, [
        'pair_style born/coul/dsf 0.5 2.2 2.5',
        'pair_coeff 1 1 1.0 0.4 1.0 1.0 0.5',
        'pair_coeff 1 2 0.9 0.45 1.05 1.0 0.5',
        'pair_coeff 2 2 0.8 0.5 1.1 1.0 0.5',
    ]),
    'bornwolf': ('lj', 0.005, [
        'pair_style born/coul/wolf 0.5 2.2 2.5',
        'pair_coeff 1 1 1.0 0.4 1.0 1.0 0.5',
        'pair_coeff 1 2 0.9 0.45 1.05 1.0 0.5',
        'pair_coeff 2 2 0.8 0.5 1.1 1.0 0.5',
    ]),
    'bucklong': ('lj', 0.005, [
        'pair_style buck/long/coul/long long long 2.5',
        'pair_coeff 1 1 100.0 0.5 1.0',
        'pair_coeff 1 2 90.0 0.55 0.894427190999916',
        'pair_coeff 2 2 80.0 0.6 0.8',
        'kspace_style ewald/disp 1.0e-4',
        'pair_modify table/disp 0 table 0',
    ]),
}
BREADTH_GOLDEN = {
    'lj96': [
        [0.0, 1.0, -1.10851734218, -1.10851734218, 0.0, -0.222544426775],
        [1.0, 1.00025254968, -1.10889036676, -1.10889036676, 0.0,
         -0.222358850888],
        [2.0, 1.00063315375, -1.10973492161, -1.10973492161, 0.0,
         -0.222220437058],
        [3.0, 1.00114668601, -1.11133886819, -1.11133886819, 0.0,
         -0.222288708271],
        [4.0, 1.00179065953, -1.11256910708, -1.11256910708, 0.0,
         -0.22191608249],
        [5.0, 1.00255901587, -1.11426632229, -1.11426632229, 0.0,
         -0.221578175859],
    ],
    'ljsmooth': [
        [0.0, 1.0, -1.43481747764, -1.43481747764, 0.0, -0.445534732454],
        [1.0, 1.00056237752, -1.43564794263, -1.43564794263, 0.0,
         -0.44537992762],
        [2.0, 1.0014390293, -1.43747995562, -1.43747995562,
         0.0, -0.44510099716],
        [3.0, 1.00262872047, -1.44084910233, -1.44084910233, 0.0,
         -0.444693170175],
        [4.0, 1.00412945481, -1.44360282863, -1.44360282863, 0.0,
         -0.444149537204],
        [5.0, 1.00593840786, -1.44734917959, -1.44734917959, 0.0,
         -0.443461397888],
    ],
    'ljsmoothlin': [
        [0.0, 1.0, -1.00832341342, -1.00832341342, 0.0, -0.381421060745],
        [1.0, 1.00054645501, -1.00913035163, -1.00913035163, 0.0,
         -0.381329855936],
        [2.0, 1.0013926758, -1.01037993666, -1.01037993666, 0.0,
         -0.381167602454],
        [3.0, 1.00253790504, -1.01207111943, -1.01207111943, 0.0,
         -0.380934123546],
        [4.0, 1.00398077791, -1.01420192583, -1.01420192583, 0.0,
         -0.380620183981],
        [5.0, 1.0057191701, -1.01676919386, -1.01676919386, 0.0,
         -0.380213440376],
    ],
    'ufm': [
        [0.0, 1.0, 2.33083795588, 2.33083795588, 0.0, 1.17903275219],
        [1.0, 0.999739349277, 2.3312228395, 2.3312228395, 0.0, 1.17897075068],
        [2.0, 0.999353737117, 2.3324563221, 2.3324563221, 0.0, 1.1793590721],
        [3.0, 0.998823608116, 2.33522597971, 2.33522597971,
         0.0, 1.18069901161],
        [4.0, 0.998150041348, 2.33687421207, 2.33687421207,
         0.0, 1.18101429841],
        [5.0, 0.997345479155, 2.33872206343, 2.33872206343,
         0.0, 1.18129276843],
    ],
    'beck': [
        [0.0, 1.0, -0.343736969178, -0.343736969178, 0.0, 0.128161197431],
        [1.0, 1.00008191671, -0.343857900226, -0.343857900226, 0.0,
         0.128165404183],
        [2.0, 1.00020638906, -0.344118403892, -0.344118403892, 0.0,
         0.128125588518],
        [3.0, 1.00037559406, -0.344597956316, -0.344597956316, 0.0,
         0.127994288834],
        [4.0, 1.00058992857, -0.344990149319, -0.344990149319, 0.0,
         0.127954175527],
        [5.0, 1.00084910258, -0.345525518419, -0.345525518419, 0.0,
         0.127866306379],
    ],
    'zbl': [
        [0.0, 10.0, 2709.89288474, 2709.89288474, 0.0, 43695226.344],
        [1.0, 10.0310875151, 2709.89263144, 2709.89263144, 0.0, 43695236.3428],
        [2.0, 12.1154176204, 2709.87565607, 2709.87565607, 0.0, 43695226.2252],
        [3.0, 16.2493455875, 2709.84198832, 2709.84198832, 0.0, 43695196.0379],
        [4.0, 22.4258690912, 2709.79168522, 2709.79168522, 0.0, 43695145.8732],
        [5.0, 30.6346419344, 2709.72483103, 2709.72483103, 0.0, 43695075.8683],
    ],
    'couldsf': [
        [0.0, 1.0, -0.620841323336, 0.0, -0.620841323336, 0.236791717932],
        [1.0, 1.00003030179, -0.620886066396, 0.0, -0.620886066396,
         0.236787556325],
        [2.0, 1.00005610758, -0.620924121983, 0.0, -0.620924121983,
         0.236781021482],
        [3.0, 1.00007760095, -0.620955812944, 0.0, -0.620955812944,
         0.236767285708],
        [4.0, 1.00009499973, -0.620981489547, 0.0, -0.620981489547,
         0.236746971323],
        [5.0, 1.00010849638, -0.621001403623, 0.0, -0.621001403623,
         0.236721341802],
    ],
    'coulwolf': [
        [0.0, 1.0, -0.58980503807, 0.0, -0.58980503807, 0.236791713798],
        [1.0, 1.00003030183, -0.58987561584, 0.0, -0.58987561584,
         0.236787552196],
        [2.0, 1.00005610771, -0.589950300881, 0.0, -0.589950300881,
         0.23678101731],
        [3.0, 1.0000776012, -0.590040283627, 0.0, -0.590040283627,
         0.23676728139],
        [4.0, 1.00009500013, -0.590144463389, 0.0, -0.590144463389,
         0.236746966983],
        [5.0, 1.00010849697, -0.590260220134, 0.0, -0.590260220134,
         0.23672133745],
    ],
    'ljdsf': [
        [0.0, 1.0, -2.04384109409, -1.42299977076, -0.620841323336,
         -0.511933877009],
        [1.0, 1.00059594247, -2.04417782702, -1.42329164924, -0.620886177774,
         -0.511537895069],
        [2.0, 1.00151170179, -2.04521311528, -1.42428851739, -0.620924597892,
         -0.511225165566],
        [3.0, 1.00275918595, -2.04255929116, -1.42160231978, -0.620956971374,
         -0.508429943744],
        [4.0, 1.00434913691, -2.04302593566, -1.42204219348, -0.620983742187,
         -0.507120821117],
        [5.0, 1.00627069508, -2.04060334217, -1.41959805883, -0.621005283347,
         -0.503775831543],
    ],
    'ljwolf': [
        [0.0, 1.0, -1.82098700494, -1.23118196687, -0.58980503807,
         -0.4332919483],
        [1.0, 1.00067804433, -1.82201820665, -1.23213224166, -0.589885964991,
         -0.433373276841],
        [2.0, 1.00171729194, -1.82385416598, -1.23387942005, -0.589974745929,
         -0.433640656949],
        [3.0, 1.00312586495, -1.82677958526, -1.23669100099, -0.590088584274,
         -0.434251808558],
        [4.0, 1.00490464067, -1.82975448138, -1.23953989481, -0.590214586574,
         -0.434587387957],
        [5.0, 1.00705227612, -1.83355052668, -1.24319416314, -0.59035636354,
         -0.4350933882],
    ],
    'hybover': [
        [0.0, 1.0, -2.06485785659, -1.44401653326, -0.620841323336,
         -0.522496943896],
        [1.0, 1.00058016947, -2.0657145791, -1.44482839713, -0.620886181974,
         -0.522403537259],
        [2.0, 1.00144843413, -2.06730391051, -1.44637929738, -0.620924613132,
         -0.522422213498],
        [3.0, 1.00261133297, -2.06994087139, -1.44898386691, -0.620957004479,
         -0.522735640256],
        [4.0, 1.00406728088, -2.07239440899, -1.45141060926, -0.620983799725,
         -0.522610105358],
        [5.0, 1.0058107228, -2.07558079595, -1.45457542217, -0.621005373782,
         -0.522575958342],
    ],
    'hybrid': [
        [0.0, 1.0, -4.10034071088, -4.10034071088, 0.0, -1.15570855624],
        [1.0, 1.00074417167, -4.09328778374, -4.09328778374, 0.0,
         -1.15207997336],
        [2.0, 1.0018520244, -4.10336055223, -4.10336055223,
         0.0, -1.15550526127],
        [3.0, 1.00325827677, -4.10229855191, -4.10229855191, 0.0,
         -1.15394295606],
        [4.0, 1.00504132107, -4.10930683543, -4.10930683543, 0.0,
         -1.15538732096],
        [5.0, 1.00720041639, -4.10499288224, -4.10499288224,
         0.0, -1.1516574505],
    ],
    'hybmix': [
        [0.0, 1.0, -2.56277252437, -2.56277252437, 0.0, -0.0316272799458],
        [1.0, 0.999616493769, -2.56220626023, -2.56220626023, 0.0,
         -0.0315542343822],
        [2.0, 0.999032163694, -2.56134343918, -2.56134343918, 0.0,
         -0.0314735784458],
        [3.0, 0.998247300826, -2.5601844905, -2.5601844905, 0.0,
         -0.0313857204259],
        [4.0, 0.997262474439, -2.55873025419, -2.55873025419, 0.0,
         -0.0312912119941],
        [5.0, 0.996078536935, -2.55698198826, -2.55698198826, 0.0,
         -0.0311907462789],
    ],
    'borndsf': [
        [0.0, 1.0, 0.592441002597, 1.21328236779, -0.620841365197,
         0.640916643464],
        [1.0, 0.999927797783, 0.591897339743, 1.21278343735, -0.620886097603,
         0.640490981723],
        [2.0, 0.999781318144, 0.592073855842, 1.21299797277, -0.620924116932,
         0.640212652551],
        [3.0, 0.999546232291, 0.586015273337, 1.20697101153, -0.620955738189,
         0.637062415446],
        [4.0, 0.999209328469, 0.583920481214, 1.20490177928, -0.620981298062,
         0.63564140403],
        [5.0, 0.998780876364, 0.576888879842, 1.19788991694, -0.621001037094,
         0.631896069717],
    ],
    'bornwolf': [
        [0.0, 1.0, 0.623477329724, 1.21328236779, -0.58980503807,
         0.640916643464],
        [1.0, 0.999927797783, 0.622907835414, 1.21278343735, -0.589875601933,
         0.640490981723],
        [2.0, 0.999781318144, 0.623047749934, 1.21299797277, -0.589950222839,
         0.640212652551],
        [3.0, 0.999546232291, 0.616930944398, 1.20697101153, -0.590040067128,
         0.637062415446],
        [4.0, 0.999209328469, 0.614757749521, 1.20490177928, -0.590144029755,
         0.63564140403],
        [5.0, 0.998780876364, 0.607630524401, 1.19788991694, -0.590259392535,
         0.631896069717],
    ],
    'bucklong': [
        [0.0, 1.0, 28.1079554395, 28.9281580226, -0.0226758552563,
         9.05390201464],
        [1.0, 0.997648721184, 28.1114282069, 28.9317318275, -0.0227117412837,
         9.05335678808],
        [2.0, 0.994331680531, 28.1312588766, 28.9516942874, -0.0227653950795,
         9.05916099863],
        [3.0, 0.989803595978, 28.1826615519, 29.0032589311, -0.0228368025403,
         9.07805014336],
        [4.0, 0.984105194842, 28.2058644612, 29.026652203, -0.0229249955975,
         9.08322204009],
        [5.0, 0.97743473188, 28.2305594281, 29.0515649715, -0.0230299363399,
         9.08809008563],
    ],
}


def breadth_input(case):
    """scripts/gen_breadth_goldens.py make_input's script of a case."""
    units, dt, pair_lines = BREADTH_CASES[case][:3]
    data = BREADTH_CASES[case][3] if len(BREADTH_CASES[case]) > 3 \
        else "data.breadth"
    return "\n".join([
        f"units {units}", "atom_style charge", f"read_data {data}",
        *pair_lines, "neighbor 0.3 bin",
        f"velocity all create {'1.0' if units == 'lj' else '10.0'} 87287 "
        "loop geom", f"timestep {dt}", "fix 1 all nve", "thermo 1",
        "thermo_style custom step temp pe evdwl ecoul press",
        "thermo_modify format float %.12g", "run 5"]) + "\n"


def breadth_golden_phases():
    """tests/test_pair_breadth2.py's 16 GOLDEN cases through LammpsScript
    in float64 on the card, each row at that test's bars (rel 2e-6, abs
    5e-8) of the LAMMPS rows."""
    import torch

    from lidp_tpu_torch.io.script import LammpsScript

    work = tempfile.mkdtemp(prefix="chip_smoke_breadth_")
    try:
        write_breadth_data(os.path.join(work, "data.breadth"))
        write_breadth_data(os.path.join(work, "data.breadth1"), one_type=True)
        worst_all = 0.0
        for case, ref in BREADTH_GOLDEN.items():
            path = os.path.join(work, f"in.{case}")
            with open(path, "w") as fh:
                fh.write(breadth_input(case))
            s = LammpsScript(dtype=torch.float64, log=lambda line: None)
            s.file(path)
            got = {int(r["step"]): r for r in s.thermo_rows}
            worst = 0.0
            for row in ref:
                r = got[int(row[0])]
                for name, g in zip(("temp", "pe", "evdwl", "ecoul",
                                    "press"), row[1:]):
                    bar = max(2e-6 * abs(g), 5e-8)
                    worst = max(worst, abs(r[name] - g) / bar)
                    if not abs(r[name] - g) <= bar:
                        raise AssertionError(
                            f"golden {case} step {int(row[0])} {name}: "
                            f"{r[name]!r}, LAMMPS {g!r}")
            worst_all = max(worst_all, worst)
            print(f"golden {case} (tests/test_pair_breadth2.py): "
                  f"{len(ref)} rows at {worst:.3g} of that test's bars")
        print(f"breadth goldens: {len(BREADTH_GOLDEN)} cases on the card, "
              f"the worst at {worst_all:.3g} of the bars")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def pair_term_calls(sim):
    """The pair term of sim's state, each pass compute_forces makes: the
    pair table's and each hybrid sub-style's (cell_pair_forces on the
    grid, dense_pair_forces on the dense route) and the DPD pairs; label
    -> a callable."""
    from lidp_tpu_torch.ops.cells import cell_pair_forces
    from lidp_tpu_torch.ops.dpd import dpd_forces
    from lidp_tpu_torch.ops.pair import dense_pair_forces

    s, ff = sim.sys, sim.runner.ff
    calls = {}
    pairs = ((ff.pair,) if ff.pair is not None else ()) + ff.extra_pairs
    for k, p in enumerate(pairs):
        tag = f"{p.kind}/{p.coul_kind if p.coul else 'no coul'}"
        if sim.nlist is None:
            sp = ff.sp_code if ff.sp_code is not None else 0
            calls[f"dense_pair_forces[{k}: {tag}]"] = (
                lambda p=p, sp=sp: dense_pair_forces(
                    s.x, s.q, s.type, sp, s.mask, s.box, p, mol=s.mol))
        else:
            calls[f"cell_pair_forces[{k}: {tag}]"] = (
                lambda p=p: cell_pair_forces(s.x, s.q, s.type, s.mask,
                                             sim.nlist.nlist, s.box, p,
                                             mol=s.mol))
    if ff.dpd is not None:
        calls["dpd_forces"] = lambda: dpd_forces(
            s.x, s.v, s.type, s.mask, s.box, ff.dpd, s.step,
            sp_code=ff.sp_code)
    return calls


def pair_readings(path, sim):
    """A path's pair passes (pair_term_calls) and its k-space term timed
    on its final state by CUDA events after a warm-up, ms a call."""
    from lidp_tpu_torch.ops.pppm import pppm_forces_params

    s, ff = sim.sys, sim.runner.ff
    calls = pair_term_calls(sim)
    if ff.pppm is not None:
        calls["pppm_forces_params"] = lambda: pppm_forces_params(
            s.x - s.box.lo, s.q, s.box.lengths, ff.pppm)
    parts = [f"{label} {cuda_ms(fn, reps=3, warmup=1):.4f}"
             for label, fn in calls.items()]
    print(f"path {path} ms a call by CUDA events on its final state: "
          + ", ".join(parts) + f"; {smi_line()}")


def pair_path(path, work, name, text, steps, cells, launches, reset_counts,
              read_counts, cols, record=True):
    """One pair-style path: `text` (written to work/name) through
    LammpsScript in float64 on the card for `steps` steps; its launches
    (0 in every counter; kept as launches[path] where `record`), route
    (the cell grid through cell_pair_forces with no overflow, or the dense
    route), log, finite rows, steps/s by the Loop time line and peak
    memory.  Returns the script."""
    import torch

    from lidp_tpu_torch.forcefield import pair_route
    from lidp_tpu_torch.io.script import LammpsScript

    with open(os.path.join(work, name), "w") as fh:
        fh.write(text)
    logs = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    script = LammpsScript(dtype=torch.float64, log=logs.append)
    script.variables["nstep"] = str(steps)
    script.file(os.path.join(work, name))
    counts = read_counts()
    if record:
        launches[path] = counts
    peak = torch.cuda.max_memory_allocated()
    check_counts(path, counts, {})
    sim = script._sim
    print(f"path {path}: {sim.natoms} atoms, float64, {steps} steps: "
          f"{script_route(script)}; its log (rows 0-2 and the last):")
    rows_seen = 0
    for line in logs:
        is_row = line.split()[:1] and line.split()[0].isdigit()
        rows_seen += bool(is_row)
        if not is_row or rows_seen <= 3 or rows_seen == steps + 1:
            print(f"  {path}| {line}")
    on_cells = sim.runner.neighbor_cfg is not None
    if on_cells != cells or (cells and (
            pair_route(sim.sys, sim.runner.ff, sim.nlist.nlist)
            != "cell_pair_forces" or bool(sim.nlist.overflow))):
        raise AssertionError(f"path {path}: {script_route(script)}")
    rows = script.thermo_rows
    if len(rows) != steps + 1:
        raise AssertionError(f"path {path}: {len(rows)} rows")
    check_rows_finite(path, rows, cols)
    if steps > 1:
        script_peak(path, logs, steps, peak)
    return script


def pair_style_paths(launches, reset_counts, read_counts):
    """Paths AO, AP, AQ and AR and the breadth goldens (module
    docstring).  Each path sets launches[path]."""
    import torch

    from lidp_tpu_torch.forcefield import compute_forces
    from lidp_tpu_torch.io.data_writer import write_data
    from lidp_tpu_torch.io.script import LammpsScript
    from lidp_tpu_torch.ops import dpd as dpd_ops

    work = tempfile.mkdtemp(prefix="chip_smoke_pairs_")
    try:
        args = (launches, reset_counts, read_counts)
        # AO: the NaCl melt on the cell grid; its state against the CPU
        write_data(os.path.join(work, "nacl.data"), nacl_layout(NACL_SIDE))
        s = pair_path("AO", work, "in.ao", NACL_SCRIPT.format(
            data="nacl.data", pair=nacl_born_pair()), NACL_STEPS, True,
            *args, NACL_COLS)
        rows_ao = s.thermo_rows
        pair_readings("AO", s._sim)
        ks_state_check("AO", s._sim)
        del s
        # AP: the same physics as hybrid/overlay, two masked passes
        s = pair_path("AP", work, "in.ap", NACL_SCRIPT.format(
            data="nacl.data", pair=nacl_born_pair(overlay=True)), AP_STEPS,
            True, *args, NACL_COLS)
        worst = rows_agree("AP", s.thermo_rows, rows_ao[:AP_STEPS + 1],
                           [1e-10] * (AP_STEPS + 1), cols=NACL_COLS)
        print(f"path AP: rows 0-{AP_STEPS} equal AO's at {worst:.3g} of "
              "their bar (rel 1e-10 of max(1, |value|))")
        pair_readings("AP", s._sim)
        del s, rows_ao
        # AO at 10^3 cells (8,000 ions, still the cell grid): rows 0-1
        # against its CPU twin
        write_data(os.path.join(work, "nacl8k.data"),
                   nacl_layout(NACL_TWIN_SIDE))
        s = pair_path("AO-8k", work, "in.ao8k", NACL_SCRIPT.format(
            data="nacl8k.data", pair=nacl_born_pair()), 1, True, *args,
            NACL_COLS, record=False)
        defer_twin("AO-8k", work, "in.ao8k", 1,
                   twin_check("AO-8k", run_state(s), NACL_COLS), threads=2,
                   cost=60.0)
        del s
        torch.cuda.empty_cache()

        # AQ: examples/melt through pair_write and pair_style table
        lj = LammpsScript(dtype=torch.float64, log=lambda line: None)
        with open(os.path.join(work, "in.aq_lj"), "w") as fh:
            fh.write(table_melt_script(
                "pair_style\tlj/cut 2.5\npair_coeff\t1 1 1.0 1.0 2.5"))
        lj.variables["nstep"] = "0"
        lj.file(os.path.join(work, "in.aq_lj"))
        lj.one(f"pair_write 1 1 {AQ_N} r 0.8 2.5 lj.table LJ11")
        s = pair_path("AQ", work, "in.aq", table_melt_script(
            f"pair_style table linear {AQ_N}\n"
            "pair_coeff 1 1 lj.table LJ11 2.5"), AQ_STEPS, False, *args,
            MELT_COLS)
        # E_pair at step 0; the forces on AQ's final state (the lattice's
        # own are zero by symmetry), the table's against lj/cut's there
        de = abs(s.thermo_rows[0]["epair"] - lj.thermo_rows[0]["epair"])
        f_tab = s._sim.res.f
        f_lj = compute_forces(s._sim.sys, lj._sim.runner.ff).f
        df = float((f_tab - f_lj).abs().max() / f_lj.abs().max())
        if not (de < 2e-5 and df < 1e-3):
            raise AssertionError(f"path AQ against lj/cut: E_pair {de:.3e} "
                                 f"at step 0, f {df:.3e} of max |f| at step "
                                 f"{AQ_STEPS}")
        fmax = float(f_lj.abs().max())
        print(f"path AQ against path M's lj/cut: E_pair {de:.3e} at step 0 "
              f"(bar 2e-5), f {df:.3e} of max |f| ({fmax:.4g}) at step "
              f"{AQ_STEPS} (bar 1e-3; tests/test_pair_table.py's round "
              "trip)")
        pair_readings("AQ", s._sim)
        defer_twin("AQ", work, "in.aq", PAIR_TWIN_STEPS,
                   twin_check("AQ", run_state(s), MELT_COLS), threads=2,
                   cost=30.0)
        del s, lj, f_tab, f_lj
        torch.cuda.empty_cache()

        # AR: a Groot-Warren DPD fluid, sum f = 0 at every evaluation
        write_data(os.path.join(work, "dpd.data"), dpd_layout(DPD_N, DPD_L))
        with open(os.path.join(work, "in.ar"), "w") as fh:
            fh.write(DPD_SCRIPT)
        sums = []
        plain = dpd_ops.dpd_forces

        def summed(*a, **k):
            out = plain(*a, **k)
            f = out[0]
            sums.append(f.sum(0).abs().max() / f.abs().max())
            return out

        dpd_ops.dpd_forces = summed
        try:
            s = pair_path("AR", work, "in.ar", DPD_SCRIPT, DPD_STEPS, False,
                          *args, DPD_COLS)
        finally:
            dpd_ops.dpd_forces = plain
        worst = float(torch.stack(sums).max())
        # every step's evaluation, and the energy re-tally at each thermo
        # row's chunk end (integrate/driver.py _run_chunk)
        if len(sums) < DPD_STEPS + 1 or not worst <= DPD_SUM_BAR:
            raise AssertionError(f"path AR: {len(sums)} evaluations, |sum "
                                 f"f| up to {worst:.3e} of max |f|")
        print(f"path AR: |sum of f| at most {worst:.3e} of max |f| over its "
              f"{len(sums)} evaluations (bar {DPD_SUM_BAR:g})")
        pair_readings("AR", s._sim)
        defer_twin("AR", work, "in.ar", PAIR_TWIN_STEPS,
                   twin_check("AR", run_state(s), DPD_COLS), threads=2,
                   cost=30.0)
        del s
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    breadth_golden_phases()


# the rest of the CHARMM family, fix cmap and the hydrogen bonds
# (charmm_family_paths): AS-AU on path S's fluid doubled along x, AV on
# 1,000 flexible waters; each at a small size against its CPU twin
CHARMM_SIDE = (8, 4, 5)        # 3,840 atoms: the dense route (<= 4096)
CHARMM_TWIN_SIDE = (2, 2, 2)   # 192 atoms
CHARMM_STEPS = 10
CHARMM_TWIN_STEPS = 2          # rows 0-2 against the CPU twins
HBOND_WATERS = 1000
HBOND_TWIN_WATERS = 81
# path -> flexible_script_case's keywords at its full cutoffs
CHARMM_PATHS = {
    "AS": dict(pair="lj/charmmfsw/coul/long 8 10", dihedral="charmmfsw",
               cmap="yes"),
    "AT": dict(pair="lj/charmmfsw/coul/charmmfsh 8 12",
               dihedral="charmmfsw", cmap="yes", kspace=None),
    "AU": dict(pair="lj/charmm/coul/charmm/implicit 8 10", kspace=None),
}
# the small size's cutoffs, inside its 12.6 A box (tests/
# test_torch_charmm_family.py PATHS)
CHARMM_TWIN_PAIRS = {"AS": "lj/charmmfsw/coul/long 4 5.5",
                     "AT": "lj/charmmfsw/coul/charmmfsh 4 5.5",
                     "AU": "lj/charmm/coul/charmm/implicit 4 5.5"}
HBOND_COLS = WATER_COLS
# tests/test_pair_breadth2.py's CHARMM-family rows (:263-275, :470-531):
# case -> (pair lines, k-space line, {step: (column: value)}, bars)
CHARMM_GOLDEN = {
    "charmmfsw/coul/charmmfsh": (
        "pair_style lj/charmmfsw/coul/charmmfsh 1.8 2.2 2.4", "",
        {0: dict(temp=1.0, pe=-1.14747471387, evdwl=-0.904567057545,
                 ecoul=-0.242907656322, press=-0.366306512177),
         5: dict(temp=1.00580226085, pe=-1.15619587224,
                 evdwl=-0.913223875741, ecoul=-0.242971996502,
                 press=-0.368041811185)},
        dict(temp=(2e-6, 0.0), pe=(2e-6, 0.0), evdwl=(2e-6, 0.0),
             ecoul=(2e-6, 0.0), press=(2e-5, 0.0))),
    "charmmfsw/coul/long": (
        "pair_style lj/charmmfsw/coul/long 1.8 2.2 2.4",
        "kspace_style ewald 1.0e-6",
        {0: dict(temp=1.0, pe=-1.48711586758, evdwl=-0.904567057545,
                 ecoul=-0.00246372882613, elong=-0.580085081204,
                 press=-0.364550075037),
         5: dict(temp=1.00593867861, pe=-1.49603843883,
                 evdwl=-0.913225786853, ecoul=-0.00256795946468,
                 elong=-0.58024469251, press=-0.366236953668)},
        dict(temp=(2e-6, 0.0), pe=(2e-6, 0.0), evdwl=(2e-6, 0.0),
             ecoul=(2e-4, 1e-7), elong=(2e-5, 0.0), press=(2e-4, 0.0))),
    "charmm/coul/charmm/implicit": (
        "pair_style lj/charmm/coul/charmm/implicit 1.8 2.2 1.9 2.4", "",
        {0: dict(temp=1.0, pe=-1.66776231135, evdwl=-1.16764098581,
                 ecoul=-0.50012132554),
         5: dict(temp=1.01137285491, pe=-1.68456253001,
                 evdwl=-1.1812279611, ecoul=-0.503334568907)},
        dict(temp=(2e-6, 0.0), pe=(2e-6, 0.0), evdwl=(2e-6, 0.0),
             ecoul=(2e-6, 0.0))),
}
CHARMM_GOLDEN_RUN = """\
units lj
atom_style charge
read_data data.breadth
{pair}
pair_coeff 1 1 1.0 1.0
pair_coeff 2 2 0.8 1.1
{kspace}
velocity all create 1.0 87287 loop geom
timestep 0.005
fix 1 all nve
thermo 5
run 5
"""
# tests/test_hbond.py's rows (GOLDEN, rebuilt 16Mar18 LAMMPS): step temp
# pe evdwl press, at rel 1e-8, abs 1e-10
HBOND_GOLDEN = {
    "lj": [
        [0, 11.6534413544866, -5.02134593821794, -5.02134593821796,
         46.5849943694826],
        [2, 11.5607127992312, -5.01913372467812, -5.02071109317161,
         47.6154345739727],
        [4, 11.4337376921595, -5.01609471626278, -5.02219102815062,
         51.1115889068202],
        [6, 11.3015274756951, -5.0129237952944, -5.02568102958299,
         56.8882377321442],
        [8, 11.2115920138498, -5.01075881356835, -5.0310585625504,
         64.6301800595781],
    ],
    "morse": [
        [0, 11.6534413544866, -11.4839822851457, -11.4839822851457,
         295.422068328193],
        [2, 11.6578863458207, -11.4840929813547, -11.4857123884612,
         297.384709259317],
        [4, 11.6710109590246, -11.4844011542017, -11.4908479756116,
         302.915826813913],
        [6, 11.7052100439714, -11.4852042554603, -11.4991591605188,
         311.706565579536],
        [8, 11.7927626408055, -11.4872760385779, -11.5103756482518,
         323.255996452036],
    ],
}
HBOND_GOLDEN_LINE = {
    "lj": ("hbond/dreiding/lj 4 6.0 8.0 90",
           "pair_coeff 1 1 hbond/dreiding/lj 2 i 3.5 2.75 4"),
    "morse": ("hbond/dreiding/morse 2 6.0 8.0 90",
              "pair_coeff 1 1 hbond/dreiding/morse 2 i "
              "3.88 1.7241379 2.9 2"),
}
HBOND_GOLDEN_SCRIPT = """\
units real
atom_style full
boundary p p p
read_data data.hb
pair_style hybrid/overlay lj/cut 5.0 {style}
pair_coeff 1 1 lj/cut 0.1553 3.166
pair_coeff 2 2 lj/cut 0.0 1.0
pair_coeff 1 2 lj/cut 0.0 2.083
{coeff}
bond_style harmonic
bond_coeff 1 450.0 0.9572
angle_style harmonic
angle_coeff 1 55.0 104.52
special_bonds lj/coul 0.0 0.0 0.5
timestep 0.2
fix 1 all nve
thermo_style custom step temp pe evdwl press
thermo 2
run 8
"""


def write_hbond_golden_data(path):
    """tests/test_hbond.py write_data's box: three waters (9 atoms,
    TIP3P-like geometry, charges -0.8/+0.4) in a 12 A box with the
    RandomState(7) velocities, the file its GOLDEN rows were made on."""
    import numpy as np

    def water(ox, oy, oz, th):
        c, s_ = np.cos(th), np.sin(th)
        o = np.array([ox, oy, oz])
        h1 = o + 0.9572 * np.array([c, s_, 0.0])
        a2 = th + np.deg2rad(104.52)
        h2 = o + 0.9572 * np.array([np.cos(a2), np.sin(a2), 0.0])
        return [o, h1, h2]

    mols = [water(0.0, 0.0, 0.0, 0.1), water(2.9, 0.3, 0.2, np.pi * 0.9),
            water(1.2, 2.7, -0.4, -np.pi / 2)]
    rng = np.random.RandomState(7)
    with open(path, "w") as f:
        f.write("hbond golden\n\n9 atoms\n6 bonds\n3 angles\n\n"
                "2 atom types\n1 bond types\n1 angle types\n\n")
        f.write("-6.0 6.0 xlo xhi\n-6.0 6.0 ylo yhi\n-6.0 6.0 zlo zhi\n\n"
                "Masses\n\n1 15.9994\n2 1.008\n\nAtoms\n\n")
        i = 0
        for m, w in enumerate(mols):
            for k, p in enumerate(w):
                i += 1
                t = 1 if k == 0 else 2
                q = -0.8 if k == 0 else 0.4
                f.write(f"{i} {m+1} {t} {q} "
                        f"{p[0]:.8f} {p[1]:.8f} {p[2]:.8f}\n")
        f.write("\nBonds\n\n")
        bid = 0
        for m in range(3):
            o = 3 * m + 1
            for h in (o + 1, o + 2):
                bid += 1
                f.write(f"{bid} 1 {o} {h}\n")
        f.write("\nAngles\n\n")
        for m in range(3):
            o = 3 * m + 1
            f.write(f"{m+1} 1 {o+1} {o} {o+2}\n")
        f.write("\nVelocities\n\n")
        v = rng.uniform(-0.002, 0.002, (9, 3))
        for i in range(9):
            f.write(f"{i+1} {v[i,0]:.8f} {v[i,1]:.8f} {v[i,2]:.8f}\n")


def charmm_golden_phases():
    """tests/test_pair_breadth2.py's three CHARMM-family LAMMPS rows and
    tests/test_hbond.py's two, through LammpsScript in float64 on the
    card, each column at that test's bars."""
    import torch

    from lidp_tpu_torch.io.script import LammpsScript

    work = tempfile.mkdtemp(prefix="chip_smoke_charmm_gold_")
    try:
        write_breadth_data(os.path.join(work, "data.breadth"))
        write_hbond_golden_data(os.path.join(work, "data.hb"))
        cases = {case: (CHARMM_GOLDEN_RUN.format(pair=pair, kspace=ks), ref,
                        bars, "tests/test_pair_breadth2.py")
                 for case, (pair, ks, ref, bars) in CHARMM_GOLDEN.items()}
        for form, rows in HBOND_GOLDEN.items():
            style, coeff = HBOND_GOLDEN_LINE[form]
            cases[f"hbond/dreiding/{form}"] = (
                HBOND_GOLDEN_SCRIPT.format(style=style, coeff=coeff),
                {int(r[0]): dict(zip(("temp", "pe", "evdwl", "press"),
                                     r[1:])) for r in rows},
                {c: (1e-8, 1e-10) for c in ("temp", "pe", "evdwl",
                                            "press")},
                "tests/test_hbond.py")
        for k, (case, (text, ref, bars, where)) in enumerate(cases.items()):
            path = os.path.join(work, f"in.golden{k}")
            with open(path, "w") as fh:
                fh.write(text)
            s = LammpsScript(dtype=torch.float64, log=lambda line: None)
            s.file(path)
            got = {int(r["step"]): r for r in s.thermo_rows}
            worst = 0.0
            for step, row in ref.items():
                for name, g in row.items():
                    rel, ab = bars[name]
                    bar = max(rel * abs(g), ab)
                    worst = max(worst, abs(got[step][name] - g) / bar)
                    if not abs(got[step][name] - g) <= bar:
                        raise AssertionError(
                            f"golden {case} step {step} {name}: "
                            f"{got[step][name]!r}, LAMMPS {g!r}")
            print(f"golden {case} ({where}): {len(ref)} rows on the card at "
                  f"{worst:.3g} of that test's bars")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def charmm_term_calls(sim):
    """The terms of sim's state that the CHARMM-family paths add or lean
    on, each the call compute_forces makes: the pair passes
    (pair_term_calls), the mesh, the bonded terms (the charmmfsw
    dihedral and its 1-4 term among them), fix cmap's crossterms and the
    hydrogen bonds' [M, N] pass; label -> a callable."""
    import torch

    from lidp_tpu_torch.forcefield import bonded_terms
    from lidp_tpu_torch.ops.cmap import cmap_forces
    from lidp_tpu_torch.ops.hbond import hbond_forces
    from lidp_tpu_torch.ops.pppm import pppm_forces_params

    s, ff = sim.sys, sim.runner.ff
    calls = pair_term_calls(sim)
    if ff.pppm is not None:
        calls["pppm_forces_params"] = lambda: pppm_forces_params(
            s.x - s.box.lo, s.q, s.box.lengths, ff.pppm)
    z = torch.zeros_like(s.x)
    calls["bonded_terms"] = lambda: bonded_terms(
        s, ff, z, z.new_zeros(()), z.new_zeros(()), z.new_zeros(6))
    if ff.cmap is not None:
        calls["cmap_forces"] = lambda: cmap_forces(s.x, ff.cmap)
    for k, hp in enumerate(ff.hbond):
        calls[f"hbond_forces[{k}]"] = (
            lambda hp=hp: hbond_forces(s.x, s.mask, s.box, hp))
    return calls


def charmm_readings(path, sim):
    """A CHARMM-family path's terms (charmm_term_calls) timed on its final
    state by CUDA events after a warm-up, ms a call; the hydrogen bonds'
    and the crossterms' repeats bit for bit (their sums run in a fixed
    order; the crossterms' forces by index_add_ may not)."""
    import torch

    calls = charmm_term_calls(sim)
    parts = [f"{label} {cuda_ms(fn, reps=3, warmup=1):.4f}"
             for label, fn in calls.items()]
    print(f"path {path} ms a call by CUDA events on its final state: "
          + ", ".join(parts) + f"; {smi_line()}")
    for label in [k for k in calls if k.startswith(("hbond", "cmap"))]:
        a, b = calls[label](), calls[label]()
        same = all(torch.equal(u, v) for u, v in zip(a, b))
        print(f"path {path}: {label} twice on one state "
              f"{'bit-identical' if same else 'differs in the last bits'}")
        if label.startswith("hbond") and not same:
            raise AssertionError(f"path {path}: {label} repeats differ")


def charmm_family_paths(launches, reset_counts, read_counts):
    """Paths AS, AT, AU and AV, their CPU twins and the goldens (module
    docstring).  Each path sets launches[path]."""
    import torch

    from lidp_tpu_torch.io.data_writer import write_data

    work = tempfile.mkdtemp(prefix="chip_smoke_charmm_")
    try:
        args = (launches, reset_counts, read_counts)
        cols = FLEX_COLS
        # AS-AU share their atoms: the case written once, with its CMAP
        # section, and without it for the paths with no fix cmap
        full = os.path.join(work, "full")
        os.makedirs(full)
        flexible_script_case(full, n_side=CHARMM_SIDE, **CHARMM_PATHS["AS"])
        with open(os.path.join(full, "flex.data")) as fh:
            data = fh.read()
        with open(os.path.join(full, "flex.nocmap"), "w") as fh:
            fh.write("\n".join(line for line in data.split("\nCMAP\n")[0]
                               .splitlines()
                               if not line.endswith(" crossterms")) + "\n")
        for path, kw in CHARMM_PATHS.items():
            cmap = "cmap" in kw
            text = flexible_script(
                pair=kw["pair"], kspace=kw.get("kspace", "pppm 1e-4"),
                dihedral=kw.get("dihedral", "charmm"), cmap=kw.get("cmap"))
            if not cmap:
                text = text.replace("read_data flex.data",
                                    "read_data flex.nocmap")
            s = pair_path(path, full, f"in.{path}", text, CHARMM_STEPS,
                          False, *args,
                          cols + (("f_cmap",) if cmap else ()))
            sim = s._sim
            ff = sim.runner.ff
            print(f"path {path}: {kw['pair']}, dihedral_style "
                  f"{ff.dihedral[0].style}, "
                  f"{len(ff.cmap.ctype) if cmap else 0} crossterms, "
                  f"qqrd2e {ff.qqrd2e}; f_cmap by row "
                  + (", ".join(f"{r['f_cmap']:.6f}"
                               for r in s.thermo_rows[:3]) if cmap else "-"))
            charmm_readings(path, sim)
            del s, sim, ff
            torch.cuda.empty_cache()
            # the small size against its CPU twin
            ds = os.path.join(work, path + "-192")
            os.makedirs(ds)
            small = dict(kw, pair=CHARMM_TWIN_PAIRS[path])
            flexible_script_case(ds, n_side=CHARMM_TWIN_SIDE, cut=(4.0, 5.5),
                                 **small)
            with open(os.path.join(ds, "in.flex")) as fh:
                text = fh.read()
            s = pair_path(f"{path}-192", ds, "in.flex", text,
                          CHARMM_TWIN_STEPS, False, *args,
                          cols + (("f_cmap",) if cmap else ()), record=False)
            defer_twin(f"{path}-192", ds, "in.flex", CHARMM_TWIN_STEPS,
                       twin_check(f"{path}-192", run_state(s),
                                  cols + (("f_cmap",) if cmap else ())),
                       cost=15.0)
            del s
        # AV: the hydrogen bonds beside lj/cut/coul/long
        for path, nw, steps in (("AV", HBOND_WATERS, CHARMM_STEPS),
                                ("AV-81", HBOND_TWIN_WATERS,
                                 CHARMM_TWIN_STEPS)):
            d = os.path.join(work, path)
            os.makedirs(d)
            write_data(os.path.join(d, "hbond.data"), hbond_water_layout(nw))
            s = pair_path(path, d, "in.av", hbond_script("lj"), steps, False,
                          *args, HBOND_COLS, record=path == "AV")
            if path == "AV":
                hp = s._sim.runner.ff.hbond[0]
                print(f"path AV: {nw} waters, {int(hp.dh_valid.sum())} "
                      f"donor-hydrogen rows against {s._sim.natoms} atoms "
                      "(hbond_forces' [M, N] pass)")
                charmm_readings(path, s._sim)
            else:
                defer_twin(path, d, "in.av", steps,
                           twin_check(path, run_state(s), HBOND_COLS),
                           cost=15.0)
            del s
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    charmm_golden_phases()


# paths AW and AX: compute chunk/atom, the */chunk computes and fix
# ave/chunk, the structure computes and heat/flux on bench/in.lj and
# bench/in.chain (chunk_structure_paths), then the LAMMPS rows of their
# JAX tests on the card (chunk_structure_golden_phases)
AW_STEPS = 100                 # in.lj's own run
AW_COMPUTES = """\
compute cz all chunk/atom bin/1d z lower 0.05 units reduced
fix az all ave/chunk {avc} cz vx density/number temp file aw_chunk.out
compute c3 all chunk/atom bin/3d x lower 0.1 y lower 0.1 z lower 0.1 &
units reduced
compute com3 all com/chunk c3
compute vcm3 all vcm/chunk c3
compute tc3 all temp/chunk c3 temp kecom internal
fix av all ave/time {avt} c_com3 c_vcm3 c_tc3 mode vector file aw_vec.out
compute sl all slice 1 1000 100 c_tc3[1]
compute cen all centro/atom fcc
compute cna all cna/atom 1.43
compute oo all orientorder/atom
compute ga all global/atom c_c3 c_tc3[1]
compute ka all ke/atom
compute pa all pe/atom
compute sa all stress/atom NULL
compute hf all heat/flux ka pa sa
thermo_style custom step temp epair emol etotal press c_hf[1] c_hf[2] &
c_hf[3] c_hf[4] c_hf[5] c_hf[6] c_sl[1] c_sl[5] c_sl[10]
thermo {thermo}
dump d all custom {dump} aw.dump id c_cz c_c3 c_cna c_cen c_oo[1] c_oo[2] &
c_oo[5] c_ga
dump_modify d format float %.10g
"""
AX_STEPS = 100                 # in.chain's own run
AX_COMPUTES = """\
compute mol all chunk/atom molecule
compute cm all com/chunk mol
compute gy all gyration/chunk mol
compute ms all msd/chunk mol
compute in all inertia/chunk mol
compute om all omega/chunk mol
compute pr all property/chunk mol count id
fix avx all ave/time {avt} c_cm c_gy c_ms c_in c_om c_pr mode vector &
file ax_vec.out
fix acx all ave/chunk {avc} mol vx density/mass temp file ax_chunk.out
compute fr all fragment/atom
compute ag all aggregate/atom 1.2
thermo {thermo}
dump d all custom {dump} ax.dump id mol c_mol c_fr c_ag
"""
# the full paths' periods, and the small ones' (a row, a dump frame and
# an output of every fix each step, against the CPU twins)
CHUNK_FULL = dict(thermo=10, dump=50, avt="10 5 50", avc="10 5 100")
CHUNK_SMALL = dict(thermo=1, dump=1, avt="1 1 1", avc="1 1 1")
AW_COLS = ("c_hf[1]", "c_hf[2]", "c_hf[3]", "c_hf[4]", "c_hf[5]", "c_hf[6]",
           "c_sl[1]", "c_sl[5]", "c_sl[10]")
AW_SMALL_SCALE = "0.55"        # in.lj's x, y, z: 5,324 atoms, still cells
AX_SMALL_CHAINS = 50           # 5,000 beads: still cells
CHUNK_TWIN_STEPS = 2           # the small paths' twins: rows 0-2 compared
# the integer-valued dump columns (chunk ids, cna codes, fragment labels)
CHUNK_INT_COLS = ("id", "mol", "c_cz", "c_c3", "c_cna", "c_mol", "c_fr",
                  "c_ag")
CHUNK_TWIN_REL = 1e-9          # the small paths against their float64 twins
CHUNK_F32_REL = 1e-6           # the full paths' step 0 against float32 twins


def aw_text(form, scale="1"):
    """bench/in.lj with AW_COMPUTES at `form`'s periods, run ${nstep}, the
    scale set in the script (the twins set no -var)."""
    text = LJ_SCRIPT.replace("run\t\t100", AW_COMPUTES.format(**form)
                             + "run\t\t${nstep}")
    for a in "xyz":
        text = text.replace(f"variable\t{a} index 1",
                            f"variable\t{a} index {scale}")
    return text


def ax_text(form):
    """bench/in.chain with AX_COMPUTES at `form`'s periods (in.chain's own
    thermo 100 replaced), run ${nstep}."""
    return CHAIN_SCRIPT.replace("thermo          100\n", "").replace(
        "run\t\t100", AX_COMPUTES.format(**form) + "run\t\t${nstep}")


def dump_frames(path):
    """A dump custom file's frames: [(step, columns, (N, k) float array)]."""
    import numpy as np

    with open(path) as fh:
        lines = fh.read().splitlines()
    frames, i = [], 0
    while i < len(lines):
        step = int(lines[i + 1])
        n = int(lines[i + 3])
        cols = lines[i + 8].split()[2:]
        rows = np.array([line.split() for line in lines[i + 9:i + 9 + n]],
                        float)
        frames.append((step, cols, rows))
        i += 9 + n
    return frames


def dumps_agree(path, got, want, rel):
    """Two dump files' frames: the same steps and columns, the integer
    columns equal, the others within rel of their column's largest
    magnitude.  Returns the largest ratio of a difference to its bar."""
    import numpy as np

    a, b = dump_frames(got), dump_frames(want)
    if [(s, c) for s, c, _ in a] != [(s, c) for s, c, _ in b]:
        raise AssertionError(f"path {path}: the dump frames' steps or "
                             "columns differ")
    worst = 0.0
    for (step, cols, x), (_, _, y) in zip(a, b):
        for k, c in enumerate(cols):
            if c in CHUNK_INT_COLS:
                if not np.array_equal(x[:, k], y[:, k]):
                    raise AssertionError(f"path {path} step {step}: dump "
                                         f"column {c} differs")
                continue
            bar = rel * max(float(np.abs(y[:, k]).max()), 1e-300)
            err = float(np.abs(x[:, k] - y[:, k]).max())
            worst = max(worst, err / bar)
            if not err <= bar:
                raise AssertionError(f"path {path} step {step}: dump column "
                                     f"{c} {err:.3e} from the twin's")
    return worst


def files_agree(path, got, want, rel):
    """Two output files, word for word: the integers equal, every other
    number within rel of max(1, |value|) or within one unit of its last
    printed digit (a %g rounding that goes the other way)."""
    with open(got) as fh:
        a = fh.read().split()
    with open(want) as fh:
        b = fh.read().split()
    if len(a) != len(b):
        raise AssertionError(f"path {path}: {os.path.basename(got)} has "
                             f"{len(a)} words, the twin's {len(b)}")
    for x, y in zip(a, b):
        if x == y:
            continue
        try:
            fx, fy = float(x), float(y)
        except ValueError:
            raise AssertionError(f"path {path}: {x!r} against {y!r}")
        mant = y.lstrip("-").split("e")[0].replace(".", "").lstrip("0")
        exp = math.floor(math.log10(abs(fy))) if fy else 0
        unit = 10.0 ** (exp - max(len(mant), 1) + 1)
        if y.lstrip("-").isdigit() or not (
                abs(fx - fy) <= rel * max(1.0, abs(fy))
                or abs(fx - fy) <= 1.01 * unit):
            raise AssertionError(f"path {path} {os.path.basename(got)}: "
                                 f"{x} against the twin's {y}")
    return len(a)


def compute_readings(path, sim, calls):
    """Each of `calls` (label -> fn of the state) on sim's final state,
    every per-state cache dropped first: its ms by the host clock (one
    call, synchronized: the computes read counts to the host, so the host
    does not keep ahead of the card) and its device ms by torch.profiler
    (the CUDA kernels of one call; "not measured" where the profiler
    records none); and the call repeated, its result equal bit for bit
    (raises where not)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def fresh():
        sim._peratom = (None, None, {})
        sim._row_cache = None

    def same(a, b):
        if isinstance(a, dict):
            return a == b
        if isinstance(a, tuple):
            return all(same(u, v) for u, v in zip(a, b))
        return torch.equal(a, b)

    parts = []
    for label, fn in calls.items():
        fresh()
        fn()
        torch.cuda.synchronize()
        fresh()
        t0 = time.perf_counter()
        first = fn()
        torch.cuda.synchronize()
        host = 1e3 * (time.perf_counter() - t0)
        fresh()
        if not same(first, fn()):
            raise AssertionError(f"path {path} {label}: two evaluations of "
                                 "one state differ")
        fresh()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        dev = sum(getattr(ev, "self_device_time_total",
                          getattr(ev, "self_cuda_time_total", 0.0))
                  for ev in prof.key_averages()
                  if str(ev.device_type).endswith("CUDA")) / 1e3
        parts.append(f"{label} {host:.3f} (device "
                     + (f"{dev:.3f})" if dev > 0 else "not measured)"))
    fresh()
    print(f"path {path} ms on its final state, host clock synchronized "
          f"(device by torch.profiler), each repeated bit for bit: "
          + ", ".join(parts) + f"; {smi_line()}")


def chunk_path(path, work, name, text, dtype, steps, launches, reset_counts,
               read_counts, record=True):
    """One chunk/structure path: `text` through LammpsScript on the card in
    `dtype` for `steps` steps (nstep); its launches (kept as
    launches[path] where `record`), route, log (rows 0-2 and the last),
    steps/s by the Loop time line and peak memory.  Returns the script
    and its log."""
    import torch

    from lidp_tpu_torch.io.script import LammpsScript

    with open(os.path.join(work, name), "w") as fh:
        fh.write(text)
    logs = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    script = LammpsScript(dtype=dtype, log=logs.append)
    script.root = work
    script.variables["nstep"] = str(steps)
    script.file(os.path.join(work, name))
    counts = read_counts()
    if record:
        launches[path] = counts
    peak = torch.cuda.max_memory_allocated()
    sim = script._sim
    route = script_route(script)
    print(f"path {path}: {sim.natoms} atoms, {str(dtype)[6:]}, {steps} "
          f"steps: {route}; its log (rows 0-2 and the last):")
    rows = [line for line in logs if line.split()[:1]
            and line.split()[0].isdigit()]
    for line in logs:
        if line in rows[3:-1]:
            continue
        print(f"  {path}| {line}")
    if sim.runner.neighbor_cfg is None or bool(sim.nlist.overflow):
        raise AssertionError(f"path {path}: {route}")
    if steps > 2:
        script_peak(path, logs, steps, peak)
    return script, logs


def chunk_twin32(path, sim, row0, cols, dump):
    """The check of a full path's float32 twin (its script at run 0 on the
    CPU, the same float32 state as the card's step 0): the row's compute
    columns within CHUNK_F32_REL of max(1, |value|), the dump's frame 0
    (its integer columns equal, the others within CHUNK_F32_REL of their
    column's largest)."""
    first = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_f0_"), "d0")
    with open(dump) as fh:
        text = fh.read()
    with open(first, "w") as fh:
        fh.write("ITEM: TIMESTEP" + text.split("ITEM: TIMESTEP")[1])

    def check(twin):
        ref = dict(zip(twin["cols"].tolist(), twin["rows"][0]))
        worst = 0.0
        for c in cols:
            bar = CHUNK_F32_REL * max(1.0, abs(ref[c]))
            worst = max(worst, abs(row0[c] - ref[c]) / bar)
            if not abs(row0[c] - ref[c]) <= bar:
                raise AssertionError(f"path {path} step 0 {c}: {row0[c]!r}, "
                                     f"the float32 twin's {ref[c]!r}")
        w = dumps_agree(path, first, os.path.join(
            str(twin["root"]), os.path.basename(dump)), CHUNK_F32_REL)
        print(f"path {path} step 0 vs its float32 CPU twin (the same float32 "
              f"state): {', '.join(cols) or 'no row column'} at {worst:.3g} "
              f"of rel {CHUNK_F32_REL:g} of max(1, |value|); the dump's "
              f"frame 0: the integer columns equal, the rest at {w:.3g} of "
              f"{CHUNK_F32_REL:g} of their column's largest")
        shutil.rmtree(os.path.dirname(first), ignore_errors=True)

    return check


def chunk_twin64(path, script, work, files, dump):
    """The check of a small path's float64 twin: twin_check's rows 0-2 at
    CHUNK_TWIN_REL and final x, v, mu; then its dump frames (the integer
    columns equal, the rest within CHUNK_TWIN_REL of their column's
    largest) and its output files (files_agree)."""
    cols = (("temp", "epair", "etotal", "press") + AW_COLS
            if path.startswith("AW") else CHAIN_COLS)
    rows_check = twin_check(path, run_state(script), cols,
                            rel=CHUNK_TWIN_REL)
    keep = tempfile.mkdtemp(prefix="chip_smoke_keep_")
    for name in files + (dump,):
        shutil.copy(os.path.join(work, name), keep)

    def check(twin):
        rows_check(twin)
        root = str(twin["root"])
        w = dumps_agree(path, os.path.join(keep, dump),
                        os.path.join(root, dump), CHUNK_TWIN_REL)
        words = sum(files_agree(path, os.path.join(keep, name),
                                os.path.join(root, name), CHUNK_TWIN_REL)
                    for name in files)
        print(f"path {path} vs its float64 CPU twin: the dump's "
              f"{len(dump_frames(os.path.join(keep, dump)))} frames' integer "
              f"columns equal, the rest at {w:.3g} of {CHUNK_TWIN_REL:g} of "
              f"their column's largest; {', '.join(files)}: {words} words, "
              f"the integers equal, the rest within {CHUNK_TWIN_REL:g} or "
              "a last printed digit")
        shutil.rmtree(keep, ignore_errors=True)

    return check


def chunk_structure_paths(launches, reset_counts, read_counts):
    """Paths AW and AX, their small forms and their twins, then the goldens
    (module docstring).  Each full path sets launches[path]."""
    import numpy as np
    import torch

    from lidp_tpu_torch import computes
    from lidp_tpu_torch.styles import fix_output

    work = tempfile.mkdtemp(prefix="chip_smoke_chunks_")
    try:
        args = (launches, reset_counts, read_counts)
        # AW: bench/in.lj, float32, the cell grid and its LJ kernel
        aw = os.path.join(work, "aw")
        os.makedirs(aw)
        s, _ = chunk_path("AW", aw, "in.aw", aw_text(CHUNK_FULL),
                            torch.float32, AW_STEPS, *args)
        sim = s._sim
        if not (launches["AW"]["cell_pair_forces_lj"] > 0
                and "cell_pair_forces_lj" in script_route(s)):
            raise AssertionError(f"path AW launches {launches['AW']}")
        check_counts("AW", launches["AW"], {
            "cell_pair_forces_lj": launches["AW"]["cell_pair_forces_lj"]})
        rows = s.thermo_rows
        if [r["step"] for r in rows] != list(range(0, AW_STEPS + 1, 10)):
            raise AssertionError(f"path AW: rows {len(rows)}")
        check_rows_finite("AW", rows, ("temp", "etotal") + AW_COLS)
        frames = dump_frames(os.path.join(aw, "aw.dump"))
        ids3, nchunk3, _ = computes.chunk_ids(sim, "c3")
        cna = frames[0][2][:, frames[0][1].index("c_cna")]
        vec = file_lines(os.path.join(aw, "aw_vec.out"))
        prof = file_lines(os.path.join(aw, "aw_chunk.out"))
        if [f[0] for f in frames] != [0, 50, 100] or nchunk3 != 1000 \
                or not (cna == 1).all() \
                or [int(w[0]) for w in vec if len(w) == 2] != [50, 100] \
                or [int(w[0]) for w in prof if len(w) == 3] != [100] \
                or len(prof) != 22:
            raise AssertionError(f"path AW: frames {[f[0] for f in frames]}"
                                 f", {nchunk3} chunks, cna codes "
                                 f"{sorted(set(cna.tolist()))}, files "
                                 f"{len(vec)}, {len(prof)} lines")
        counts = [float(w[2]) for w in prof[2:]]
        print(f"path AW: {nchunk3} bin/3d chunks (0.1 reduced), step 0's "
              f"cna codes all fcc (1), centro/atom mean "
              f"{frames[0][2][:, 4].mean():.4g} then "
              f"{frames[-1][2][:, 4].mean():.4g}, Q6 mean "
              f"{frames[-1][2][:, 6].mean():.4f}; aw_chunk.out's 20 z bins "
              f"hold {min(counts):g}-{max(counts):g} atoms (their mean over "
              f"its 10 samples), aw_vec.out 2 outputs of 1000 rows; "
              f"step {AW_STEPS}: " + ", ".join(
                  f"{c} {rows[-1][c]:.8g}" for c in AW_COLS))
        compute_readings("AW", sim, {
            "one sample step (thermo_row: heat/flux, slice)":
                lambda: sim.thermo_row(),
            "chunk/atom bin/3d": lambda: computes.chunk_ids(sim, "c3")[0],
            "com/chunk": lambda: computes.eval_chunk_agg(sim, "com3"),
            "temp/chunk": lambda: computes.eval_chunk_agg(sim, "tc3"),
            "heat/flux": lambda: computes.eval_heat_flux(sim, "hf"),
            "centro/atom": lambda: computes.eval_peratom(sim, "cen"),
            "cna/atom": lambda: computes.eval_peratom(sim, "cna"),
            "orientorder/atom": lambda: computes.eval_peratom(sim, "oo"),
            "global/atom": lambda: computes.eval_peratom(sim, "ga"),
            "slice": lambda: fix_output.eval_slice(sim, "sl")})
        defer_twin("AW-f32", aw, "in.aw", 0,
                   chunk_twin32("AW-f32", sim, rows[0], AW_COLS,
                                os.path.join(aw, "aw.dump")),
                   threads=4, cost=20.0, dtype="float32")
        del s, sim
        torch.cuda.empty_cache()

        # AW at 5,324 atoms in float64, everything each step, its twin
        aws = os.path.join(work, "aw-small")
        os.makedirs(aws)
        s, _ = chunk_path("AW-5k", aws, "in.aw",
                          aw_text(CHUNK_SMALL, AW_SMALL_SCALE),
                          torch.float64, CHUNK_TWIN_STEPS, *args,
                          record=False)
        defer_twin("AW-5k", aws, "in.aw", CHUNK_TWIN_STEPS,
                   chunk_twin64("AW-5k", s, aws,
                                ("aw_chunk.out", "aw_vec.out"), "aw.dump"),
                   cost=15.0)
        del s
        torch.cuda.empty_cache()

        # AX: bench/in.chain, float32, the cell grid (the plain cell pass)
        ax = os.path.join(work, "ax")
        os.makedirs(ax)
        chain_script_case(ax)
        s, _ = chunk_path("AX", ax, "in.ax", ax_text(CHUNK_FULL),
                            torch.float32, AX_STEPS, *args)
        sim = s._sim
        check_counts("AX", launches["AX"], {})
        rows = s.thermo_rows
        if [r["step"] for r in rows] != list(range(0, AX_STEPS + 1, 10)):
            raise AssertionError(f"path AX: rows {len(rows)}")
        check_rows_finite("AX", rows, CHAIN_COLS)
        frames = dump_frames(os.path.join(ax, "ax.dump"))
        cols = frames[0][1]
        fr = frames[-1][2][:, cols.index("c_fr")]
        ag = frames[-1][2][:, cols.index("c_ag")]
        mol = frames[-1][2][:, cols.index("mol")]
        ids = frames[-1][2][:, cols.index("id")]
        first = {m: ids[mol == m].min() for m in np.unique(mol)}
        if [f[0] for f in frames] != [0, 50, 100] or not np.array_equal(
                fr, np.array([first[m] for m in mol])) \
                or not np.array_equal(frames[-1][2][:, cols.index("c_mol")],
                                      mol):
            raise AssertionError("path AX: fragment/atom's labels are not "
                                 "each chain's first bead, or chunk ids not "
                                 "the molecule ids")
        vec = file_lines(os.path.join(ax, "ax_vec.out"))
        rg = [float(w[4]) for w in vec[1:1 + int(vec[0][1])]]
        print(f"path AX: {len(first)} chains, fragment/atom each chain's "
              f"first bead; aggregate/atom 1.2: {len(set(ag.tolist()))} "
              f"aggregates at step {AX_STEPS}; gyration/chunk at step 50 "
              f"(the mean of 5 samples) {min(rg):.4f}-{max(rg):.4f}, "
              f"ax_vec.out {len([w for w in vec if len(w) == 2])} outputs "
              f"of {len(first)} rows")
        compute_readings("AX", sim, {
            "chunk/atom molecule": lambda: computes.chunk_ids(sim, "mol")[0],
            "com/chunk": lambda: computes.eval_chunk_agg(sim, "cm"),
            "gyration/chunk": lambda: computes.eval_chunk_agg(sim, "gy"),
            "msd/chunk": lambda: computes.eval_chunk_agg(sim, "ms"),
            "inertia/chunk": lambda: computes.eval_chunk_agg(sim, "in"),
            "omega/chunk": lambda: computes.eval_chunk_agg(sim, "om"),
            "fragment/atom": lambda: computes.eval_peratom(sim, "fr"),
            "aggregate/atom": lambda: computes.eval_peratom(sim, "ag")})
        defer_twin("AX-f32", ax, "in.ax", 0,
                   chunk_twin32("AX-f32", sim, rows[0], (),
                                os.path.join(ax, "ax.dump")),
                   threads=4, cost=20.0, dtype="float32")
        del s, sim
        torch.cuda.empty_cache()

        # AX at 5,000 beads in float64, everything each step, its twin
        axs = os.path.join(work, "ax-small")
        os.makedirs(axs)
        chain_script_case(axs, n_chains=AX_SMALL_CHAINS)
        s, _ = chunk_path("AX-5k", axs, "in.ax", ax_text(CHUNK_SMALL),
                          torch.float64, CHUNK_TWIN_STEPS, *args,
                          record=False)
        defer_twin("AX-5k", axs, "in.ax", CHUNK_TWIN_STEPS,
                   chunk_twin64("AX-5k", s, axs,
                                ("ax_chunk.out", "ax_vec.out"), "ax.dump"),
                   cost=15.0)
        del s
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    chunk_structure_golden_phases()


# tests/test_chunk_computes.py's cases (HEAD with `compute cc all
# chunk/atom type`, each case's compute g, and its own chunk/atom cb where
# it has one, sampled by fix ave/time 2 1 2 c_g mode vector; the scalars
# in the row) and LAMMPS's rows of them, copied
CHUNK_GOLDEN_HEAD = """\
units lj
atom_style charge
boundary p p p
lattice fcc 0.8442
region box block 0 4 0 4 0 4
create_box 2 box
create_atoms 1 box
mass 1 1.0
mass 2 1.5
region left block 0 2 0 4 0 4
group left region left
set region left type 2
set type 1 charge 0.08
set type 2 charge -0.05
region bottom block 0 4 0 2 0 4
set region bottom charge 0.15
pair_style lj/cut 2.5
pair_coeff * * 1.0 1.0
velocity all create 1.44 87287 loop geom
fix 1 all nve
compute cc all chunk/atom type
"""
GOLDEN_TAIL = """\
thermo 2
thermo_modify format float %.15g norm no
run 4
"""
CHUNK_GOLDEN_CASES = {
    "com": "com/chunk cc", "vcm": "vcm/chunk cc",
    "gyration": "gyration/chunk cc",
    "gyration_tensor": "gyration/chunk cc tensor",
    "angmom": "angmom/chunk cc", "torque": "torque/chunk cc",
    "inertia": "inertia/chunk cc", "omega": "omega/chunk cc",
    "dipole": "dipole/chunk cc", "dipole_geom": "dipole/chunk cc geometry",
    "msd": "msd/chunk cc", "property": "property/chunk cc count",
    "tempchunk_bin": "temp/chunk cb temp", "com_bin2d": "com/chunk cb"}
CHUNK_GOLDEN_CB = {"tempchunk_bin": "bin/1d x lower 2.0",
                   "com_bin2d": "bin/2d x lower 2.0 y lower 2.0"}
CHUNK_SCALAR_CASES = {"tempchunk_scalar": "temp/chunk cc",
                      "tempchunk_com": "temp/chunk cc com yes"}
CHUNK_GOLDEN = {"angmom": {0: [[-33.798, 14.14, -15.852],
                               [-75.6906, 33.9075, 33.7975]],
                           2: [[-33.8231, 14.1226, -15.8208],
                               [-75.6365, 33.8817, 33.7708]],
                           4: [[-33.9288, 14.0432, -15.7336],
                               [-75.4972, 33.8231, 33.7039]]},
                "com": {0: [[5.03879, 2.93929, 2.93929],
                            [1.6796, 2.93929, 2.93929]],
                        2: [[5.04004, 2.93895, 2.93856],
                            [1.6791, 2.93943, 2.93959]],
                        4: [[5.04129, 2.9386, 2.93783],
                            [1.67859, 2.93957, 2.93988]]},
                "com_bin2d": {0: [[1.2597, 1.2597, 2.93929],
                                  [1.2597, 4.61889, 2.93929],
                                  [4.47892, 1.2597, 2.93929],
                                  [4.47892, 4.61889, 2.93929]],
                              2: [[1.57686, 1.6937, 2.90872],
                                  [1.72911, 4.19899, 2.93253],
                                  [4.25762, 1.65886, 2.95619],
                                  [3.78305, 4.03193, 2.97285]],
                              4: [[1.57748, 1.69487, 2.91044],
                                  [1.72696, 4.19898, 2.93223],
                                  [4.25856, 1.65737, 2.95707],
                                  [3.78422, 4.03171, 2.97026]]},
                "dipole": {0: [[-9.23706e-14, -5.29073, 0.117572, 5.29203],
                               [-1.77636e-14, -25.1939, -0.335919, 25.1962]],
                           2: [[-0.000297679, -5.29382, 0.12436, 5.29528],
                               [0.001822, -25.1757, -0.320187, 25.1778]],
                           4: [[-0.000588521, -5.2969, 0.131138, 5.29853],
                               [0.00366289, -25.1576, -0.304464, 25.1594]]},
                "dipole_geom": {0: [[-9.23706e-14, -5.29073, 0.117572,
                                     5.29203],
                                    [-1.42109e-14, -25.1939, -0.335919,
                                     25.1962]],
                                2: [[-0.000297679, -5.29382, 0.12436, 5.29528],
                                    [0.001822, -25.1757, -0.320187, 25.1778]],
                                4: [[-0.000588521, -5.2969, 0.131138, 5.29853],
                                    [0.00366289, -25.1576, -0.304464,
                                     25.1594]]},
                "gyration": {0: [[2.80632], [2.96913]],
                             2: [[2.80771], [2.96709]],
                             4: [[2.80924], [2.96514]]},
                "gyration_tensor": {0: [[0.470174, 3.70262, 3.70262,
                                         3.75027e-17, 2.59379e-17,
                                         -0.0587717],
                                        [1.41052, 3.70262, 3.70262,
                                         3.70074e-18, 1.85037e-17, 0.035263]],
                                    2: [[0.470959, 3.70441, 3.70787,
                                         0.000651384, 0.000801812,
                                         -0.0599507],
                                        [1.40719, 3.6982, 3.69822, 0.00160213,
                                         0.00343339, 0.0336957]],
                                    4: [[0.472045, 3.70648, 3.71332,
                                         0.00132551, 0.00164542, -0.0610855],
                                        [1.40405, 3.69398, 3.69402, 0.00317367,
                                         0.00683782, 0.0321215]]},
                "inertia": {0: [[710.903, 400.588, 400.588, -3.60026e-15,
                                 5.64209, -2.49004e-15],
                                [1777.26, 1227.15, 1227.15, -2.66454e-15,
                                 -8.46313, 6.21725e-15]],
                            2: [[711.579, 401.168, 400.836, -0.0625329,
                                 5.75527, -0.076974],
                                [1775.14, 1225.3, 1225.29, -0.38451, -8.08698,
                                 -0.824013]],
                            4: [[712.301, 401.795, 401.138, -0.127249, 5.86421,
                                 -0.15796],
                                [1773.12, 1223.54, 1223.53, -0.761681,
                                 -7.70917, -1.64108]]},
                "msd": {0: [[0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0]],
                        2: [[1.56886e-06, 1.20704e-07, 5.34313e-07,
                             2.22387e-06],
                            [2.51017e-07, 1.93127e-08, 8.549e-08, 3.5582e-07]],
                        4: [[6.27848e-06, 4.83611e-07, 2.13592e-06, 8.898e-06],
                            [1.00456e-06, 7.73778e-08, 3.41746e-07,
                             1.42368e-06]]},
                "omega": {0: [[-0.0475423, 0.0358625, -0.0400769],
                              [-0.0425884, 0.0278223, 0.0277332]],
                          2: [[-0.0475336, 0.03577, -0.0399923],
                              [-0.0425899, 0.0278214, 0.0277164]],
                          4: [[-0.0476352, 0.0355164, -0.0397602],
                              [-0.0425412, 0.0277915, 0.0276646]]},
                "property": {0: [[96.0], [160.0]],
                             2: [[96.0], [160.0]],
                             4: [[96.0], [160.0]]},
                "tempchunk_bin": {0: [[1.4868], [1.38195]],
                                  2: [[1.46462], [1.38871]],
                                  4: [[1.44531], [1.36281]]},
                "torque": {0: [[-2.60799e-14, -1.18294e-14, 3.94506e-15],
                               [-4.02985e-14, 1.34319e-15, -1.08649e-14]],
                           2: [[-5.59134, -4.00387, 6.08525],
                               [10.3056, -4.70671, -5.0484]],
                           4: [[-16.2566, -12.4727, 11.2827],
                               [17.2087, -6.79467, -8.11273]]},
                "vcm": {0: [[0.125241, -0.0347403, -0.0730981],
                            [-0.0500965, 0.0138961, 0.0292392]],
                        2: [[0.125284, -0.0347568, -0.0730855],
                            [-0.0501136, 0.0139027, 0.0292342]],
                        4: [[0.125329, -0.0348927, -0.0729807],
                            [-0.0501314, 0.0139571, 0.0291923]]}}
CHUNK_SCALAR_GOLDEN = {"tempchunk_com": [[0.0, 1.44, 1.43048377519289],
                                         [2.0, 1.43285519103294,
                                          1.42336511679456],
                                         [4.0, 1.41021682263837,
                                          1.40081424755624]],
                       "tempchunk_scalar": [[0.0, 1.44, 1.434375],
                                            [2.0, 1.43285519103294,
                                             1.42725810044297],
                                            [4.0, 1.41021682263837,
                                             1.40470816317494]]}
CENTRO_GOLDEN = [[0, 0.05, 16.9262601966397, 303.0, 1.41052168305331],
                 [2, 0.0497155436205406, 16.8344794131108, 303.0,
                  1.4039770435622],
                 [4, 0.0488345009278659, 17.0143705321207, 303.0,
                  1.39776467168435]]
HF_GOLDEN = [[0, 1.44, -19.2689191241193, 94.555659420385, 14.9522180121156,
              -6.42297304137323, 31.5185531401283, 4.98407267070516],
             [2, 1.43088638838039, -18.8612691420027, 94.0148280123202,
              13.2503160176701, -6.76130330253762, 30.7961487238246,
              4.18199099216507],
             [4, 1.40164128098338, -16.5834633381717, 94.8852113586248,
              11.0075457474505, -7.22357783617436, 29.5831351867053,
              3.3153339738176]]
SLICE_GOLDEN = [[0, 1.44, 94.555659420385, -6.42297304137323],
                [2, 1.43088638838039, 94.0148280123202, -6.76130330253762],
                [4, 1.40164128098338, 94.8852113586248, -7.22357783617436]]
ORIENT_GOLDEN = [[0, 0.190940653956, 0.574524259714, 0.600083022202, 0.0, 0.0],
                 [2, 0.190993699392, 0.572481281486, 0.592102548126,
                  1.66602237131e-05, -4.02052611497e-05]]
# tests/test_structure_computes.py's and tests/test_order_computes.py's
# scripts and LAMMPS's rows (CENTRO_GOLDEN: step temp c_rc c_rn c_rmax;
# HF_GOLDEN: step temp c_hf[1..6]; SLICE_GOLDEN: step temp c_s[1] c_s[2];
# ORIENT_GOLDEN: step Q4 Q6 Q12 q6[2] q6[8]), copied
STRUCT_MELT = """\
units lj
atom_style atomic
boundary p p p
lattice fcc 0.8442
region box block 0 {n} 0 {n} 0 {n}
create_box 1 box
create_atoms 1 box
mass 1 1.0
pair_style lj/cut 2.5
pair_coeff 1 1 1.0 1.0
"""
STRUCT_GOLDEN_SCRIPTS = {
    "centro/atom, cna/atom": STRUCT_MELT.format(n=4) + """\
region hole sphere 2 2 2 0.4
delete_atoms region hole
velocity all create 0.05 87287 loop geom
fix 1 all nve
compute cc all centro/atom fcc
compute cn all cna/atom 1.4336
compute rc all reduce sum c_cc
compute rn all reduce sum c_cn
compute rmax all reduce max c_cc
thermo_style custom step temp c_rc c_rn c_rmax
""" + GOLDEN_TAIL,
    "heat/flux, slice": STRUCT_MELT.format(n=4) + """\
velocity all create 1.44 87287 loop geom
fix 1 all nve
compute myke all ke/atom
compute mype all pe/atom
compute myst all stress/atom NULL
compute hf all heat/flux myke mype myst
compute s all slice 2 6 2 c_hf
thermo_style custom step temp c_hf[1] c_hf[2] c_hf[3] c_hf[4] c_hf[5] &
c_hf[6] c_s[1] c_s[2]
""" + GOLDEN_TAIL,
    "orientorder/atom": STRUCT_MELT.format(n=3) + """\
velocity all create 1.44 87287 loop geom
fix 1 all nve
compute oo all orientorder/atom
compute q6 all orientorder/atom degrees 1 6 components 6 nnn 12 cutoff 1.8
compute r1 all reduce sum c_oo[1] c_oo[2] c_oo[5]
compute r2 all reduce sum c_q6[2] c_q6[8]
thermo 2
thermo_style custom step c_r1[1] c_r1[2] c_r1[3] c_r2[1] c_r2[2]
run 2
""",
    "hexorder/atom": """\
units lj
dimension 2
atom_style atomic
boundary p p p
lattice hex 0.9
region box block 0 6 0 4 -0.25 0.25
create_box 1 box
create_atoms 1 box
mass 1 1.0
velocity all create 0.5 12345 loop geom
pair_style lj/cut 2.5
pair_coeff 1 1 1.0 1.0
fix 1 all nve
fix 2 all enforce2d
compute hx all hexorder/atom
compute hx4 all hexorder/atom degree 4 nnn 4 cutoff 1.5
compute rh all reduce sum c_hx[1] c_hx[2] c_hx4[1] c_hx4[2]
thermo 2
thermo_style custom step c_rh[1] c_rh[2] c_rh[3] c_rh[4]
run 2
""",
    "global/atom": STRUCT_MELT.format(n=3) + """\
velocity all create 1.44 87287 loop geom
fix 1 all nve
compute cc all chunk/atom bin/1d x lower 0.25 units reduced
compute vc all com/chunk cc
compute ga all global/atom c_cc c_vc[1] c_vc[2]
compute rg all reduce sum c_ga[1] c_ga[2]
thermo 2
thermo_style custom step c_rg[1] c_rg[2]
thermo_modify norm no
run 2
"""}
# (step, column, LAMMPS's value, rel, abs) of each script, at its test's
# bars
HEX_GOLDEN = ((0, "c_rh[1]", 1.0, 1e-12, 0.0), (0, "c_rh[2]", 0.0, 0.0, 1e-12),
              (2, "c_rh[1]", 0.998595202424, 1e-10, 0.0),
              (2, "c_rh[2]", -1.59509088455e-05, 1e-8, 0.0),
              (2, "c_rh[3]", 0.00712479064708, 1e-8, 0.0),
              (2, "c_rh[4]", 0.0394258967726, 1e-8, 0.0))


def struct_golden_rows():
    """STRUCT_GOLDEN_SCRIPTS' bars: name -> [(step, column, value, rel,
    abs)]."""
    out = {"centro/atom, cna/atom": [], "heat/flux, slice": [],
           "orientorder/atom": [], "hexorder/atom": list(HEX_GOLDEN),
           "global/atom": [(s, f"c_rg[{k}]", 226.745485837, 1e-10, 0.0)
                           for s in (0, 2) for k in (1, 2)]}
    for step, temp, rc, rn, rmax in CENTRO_GOLDEN:
        out["centro/atom, cna/atom"] += [
            (step, "temp", temp, 1e-10, 0.0), (step, "c_rc", rc, 1e-8, 0.0),
            (step, "c_rn", rn, 1e-12, 0.0), (step, "c_rmax", rmax, 1e-8, 0.0)]
    for row in HF_GOLDEN:
        out["heat/flux, slice"] += [(int(row[0]), "temp", row[1], 1e-10, 0.0)]
        out["heat/flux, slice"] += [(int(row[0]), f"c_hf[{k + 1}]",
                                     row[2 + k], 2e-7, 0.0) for k in range(6)]
    for step, _, s1, s2 in SLICE_GOLDEN:
        out["heat/flux, slice"] += [(step, "c_s[1]", s1, 2e-7, 0.0),
                                    (step, "c_s[2]", s2, 2e-7, 0.0)]
    for step, q4, q6, q12, c2, c8 in ORIENT_GOLDEN:
        out["orientorder/atom"] += [
            (step, "c_r1[1]", q4, 1e-10, 0.0),
            (step, "c_r1[2]", q6, 1e-10, 0.0),
            (step, "c_r1[3]", q12, 1e-10, 0.0),
            (step, "c_r2[1]", c2, 1e-8, 1e-12),
            (step, "c_r2[2]", c8, 1e-8, 1e-12)]
    return out


def chunk_golden_text():
    """Every case of CHUNK_GOLDEN_CASES and CHUNK_SCALAR_CASES in one
    script: case c's computes g_c (and cb_c), its fix ave/time av_c
    writing out_c.txt; the scalars in the row."""
    text = CHUNK_GOLDEN_HEAD
    for case, style in CHUNK_GOLDEN_CASES.items():
        if case in CHUNK_GOLDEN_CB:
            text += (f"compute cb_{case} all chunk/atom "
                     f"{CHUNK_GOLDEN_CB[case]}\n")
        text += (f"compute g_{case} all "
                 + style.replace(" cb", f" cb_{case}") + "\n"
                 + f"fix av_{case} all ave/time 2 1 2 c_g_{case} mode vector "
                 f"file out_{case}.txt\n")
    for case, style in CHUNK_SCALAR_CASES.items():
        text += f"compute g_{case} all {style}\n"
    return text + "thermo_style custom step temp " + " ".join(
        f"c_g_{case}" for case in CHUNK_SCALAR_CASES) + "\n" + GOLDEN_TAIL


def chunk_frames(path):
    """A fix ave/time mode vector file's frames: step -> rows (the row
    index dropped)."""
    frames, lines = {}, file_lines(path)
    i = 0
    while i < len(lines):
        step, nrow = int(lines[i][0]), int(lines[i][1])
        frames[step] = [[float(v) for v in w[1:]]
                        for w in lines[i + 1:i + 1 + nrow]]
        i += 1 + nrow
    return frames


def chunk_structure_golden_phases():
    """The LAMMPS rows of tests/test_chunk_computes.py (the 14 */chunk
    cases' frames at 5e-5 of their column scale, a frame whose largest
    magnitude is below 1e-9 below 1e-9 too; the temp/chunk scalars at
    1e-9), tests/test_structure_computes.py and tests/test_order_computes.py
    (at their bars), through LammpsScript in float64 on the card."""
    import numpy as np
    import torch

    from lidp_tpu_torch.io.script import LammpsScript

    work = tempfile.mkdtemp(prefix="chip_smoke_chunk_gold_")
    try:
        s = LammpsScript(dtype=torch.float64, log=lambda line: None)
        s.root = work
        s.execute(chunk_golden_text().splitlines())
        worst = {}
        for case, want in CHUNK_GOLDEN.items():
            got = chunk_frames(os.path.join(work, f"out_{case}.txt"))
            if sorted(got) != sorted(want):
                raise AssertionError(f"golden {case}: steps {sorted(got)}")
            for step, rows in want.items():
                g, w = np.asarray(got[step]), np.asarray(rows)
                if g.shape != w.shape:
                    raise AssertionError(f"golden {case} step {step}: shape "
                                         f"{g.shape}")
                if np.abs(w).max() < 1e-9:
                    if not np.abs(g).max() < 1e-9:
                        raise AssertionError(f"golden {case} step {step}")
                    continue
                scale = np.maximum(np.abs(w).max(axis=0, keepdims=True),
                                   1e-6 * np.abs(w).max())
                err = float((np.abs(g - w) / scale).max())
                worst[case] = max(worst.get(case, 0.0), err / 5e-5)
                if not err < 5e-5:
                    raise AssertionError(f"golden {case} step {step}: "
                                         f"{err:.3g} of the column scale")
        rows = {int(r["step"]): r for r in s.thermo_rows}
        for case, ref in CHUNK_SCALAR_GOLDEN.items():
            for step, temp, cg in ref:
                r = rows[int(step)]
                for name, want in (("temp", temp), (f"c_g_{case}", cg)):
                    err = abs(r[name] - want) / (1e-9 * abs(want))
                    worst[case] = max(worst.get(case, 0.0), err)
                    if not err <= 1.0:
                        raise AssertionError(f"golden {case} step {step} "
                                             f"{name}: {r[name]!r}, LAMMPS "
                                             f"{want!r}")
        print("golden */chunk (tests/test_chunk_computes.py, one script on "
              "the card): " + ", ".join(f"{c} {v:.3g}"
                                         for c, v in worst.items())
              + " of that test's bars")
        for name, bars in struct_golden_rows().items():
            s = LammpsScript(dtype=torch.float64, log=lambda line: None)
            s.root = work
            s.execute(STRUCT_GOLDEN_SCRIPTS[name].splitlines())
            rows = {int(r["step"]): r for r in s.thermo_rows}
            worst = 0.0
            for step, col, want, rel, ab in bars:
                bar = max(rel * abs(want), ab)
                worst = max(worst, abs(rows[step][col] - want) / bar)
                if not abs(rows[step][col] - want) <= bar:
                    raise AssertionError(f"golden {name} step {step} {col}: "
                                         f"{rows[step][col]!r}, LAMMPS "
                                         f"{want!r}")
            print(f"golden {name}: {len(bars)} values on the card at "
                  f"{worst:.3g} of their test's bars")
    finally:
        shutil.rmtree(work, ignore_errors=True)


CHUTE_SPACING = 0.98           # grid spacing of chute_layout (diameter 1)
CHUTE_SCRIPT = """\
# bench/in.chute's lines: chute flow with a frozen base at 26 degrees
variable nstep index 100
variable every index 100
units		lj
atom_style	sphere
boundary	p p fs
newton		off
comm_modify	vel yes

read_data	data.chute

pair_style	gran/hooke/history 2000.0 NULL 50.0 NULL 0.5 0
pair_coeff	* *

neighbor	0.1 bin
neigh_modify	every 1 delay 0

timestep	0.0001

group		bottom type 2
group		active subtract all bottom
neigh_modify	exclude group bottom bottom

fix		1 all gravity 1.0 chute 26.0
fix		2 bottom freeze
fix		3 active nve/sphere

compute		1 all erotate/sphere
thermo_style	custom step atoms ke c_1 vol
thermo		${every}
thermo_modify	norm no

run		${nstep}
"""
# the pour-onto-a-bed script (path AZ): hertz/history grains and wall,
# gravity down, fix pour over the bed, every sphere compute in the row
POUR_BED_SCRIPT = """\
variable nstep index 100
variable every index 100
units lj
atom_style sphere
boundary p p f
newton off
comm_modify vel yes
read_data data.bed
pair_style gran/hertz/history 2000.0 NULL 50.0 NULL 0.5 1
pair_coeff * *
neighbor 0.1 bin
neigh_modify every 1 delay 0
timestep 0.001
region ins block 0 {lx} 0 {ly} {zlo} {zhi} units box
fix 1 all gravity 1.0 vector 0 0 -1
fix 2 all nve/sphere
fix 3 all wall/gran hertz/history 2000.0 NULL 50.0 NULL 0.5 1 zplane 0.0 NULL
fix 4 all pour {npour} 1 {seed} region ins vol 0.5 50 diam range 0.9 1.1 \
dens 0.9 1.1 vel 0 0 0 0 -2.0
compute ca all contact/atom
compute cs all reduce sum c_ca
compute cm all reduce max c_ca
compute ts all temp/sphere
compute ea all erotate/sphere/atom
compute es all reduce sum c_ea
compute 1 all erotate/sphere
thermo_style custom step atoms ke c_1 c_ts c_es c_cs c_cm
thermo_modify norm no
thermo ${{every}}
run ${{nstep}}
"""


def chute_layout(path, nx, ny, nz, seed=2026, base_type=True, zhi=None):
    """Write a sphere data file: nx x ny x nz grains of diameter 1 and
    density 1 on a simple cubic grid at CHUTE_SPACING (each overlaps its
    six neighbours by 0.02), every coordinate jittered by a seeded
    uniform +-0.005, velocities and angular velocities N(0, 1), the bottom
    layer type 2 where base_type (in.chute's frozen base).  The box is
    nx x ny spacings in x and y (periodic) and 0 - zhi in z, by default
    (nz - 1) spacings: the grains reach 0.5 spacing past it, so that under
    a shrink-wrapped top face the setup grid's z bins (the script's box
    over 2 r + skin) stay wider than 2 r + skin."""
    import numpy as np

    rng = np.random.default_rng(seed)
    a = CHUTE_SPACING
    ijk = np.stack(np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                               indexing="ij"), -1).reshape(-1, 3)
    x = (ijk + [0.5, 0.5, 0.0]) * a + [0.0, 0.0, 0.5]
    x += rng.uniform(-0.005, 0.005, x.shape)
    v = rng.standard_normal(x.shape)
    w = rng.standard_normal(x.shape)
    types = np.where((ijk[:, 2] == 0) & base_type, 2, 1)
    zhi = (nz - 1) * a if zhi is None else zhi
    n = len(x)
    lines = [f"chute_layout {nx} x {ny} x {nz} seed {seed}", "",
             f"{n} atoms", f"{2 if base_type else 1} atom types", "",
             f"0 {nx * a!r} xlo xhi", f"0 {ny * a!r} ylo yhi",
             f"0 {float(zhi)!r} zlo zhi", "", "Atoms", ""]
    x, v, w = x.tolist(), v.tolist(), w.tolist()
    lines += [f"{i + 1} {types[i]} 1.0 1.0 {x[i][0]!r} {x[i][1]!r} "
              f"{x[i][2]!r}" for i in range(n)]
    lines += ["", "Velocities", ""]
    lines += [f"{i + 1} {v[i][0]!r} {v[i][1]!r} {v[i][2]!r} {w[i][0]!r} "
              f"{w[i][1]!r} {w[i][2]!r}" for i in range(n)]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return n


def pour_bed_case(work, nx, ny, nz, npour, height, seed=7654321):
    """Path AZ's input in `work`: the bed chute_layout(nx, ny, nz, one
    type) in a box nx x ny spacings wide (boundary p p f), and
    POUR_BED_SCRIPT pouring npour grains (diameters 0.9-1.1) from a block
    over the whole footprint, `height` high, its floor 1.5 above the bed's
    top (no grain placed on the bed), the box's top 4 above the block.
    The insertion height is biased to the block's top (fix_pour.cpp), so
    one event places all npour only where the block is tall enough that
    its top layer does not jam.  Returns the script's text."""
    a = CHUTE_SPACING
    zlo = 2.0 + (nz - 1) * a
    chute_layout(os.path.join(work, "data.bed"), nx, ny, nz,
                 base_type=False, zhi=zlo + height + 4.0)
    return POUR_BED_SCRIPT.format(lx=repr(nx * a), ly=repr(ny * a),
                                  zlo=repr(zlo), zhi=repr(zlo + height),
                                  npour=npour, seed=seed)


# paths AY and AZ: granular flow (atom_style sphere, pair gran/*), their
# 2,000-grain twins, and the LAMMPS rows of the JAX package's granular
# tests on the card (granular_golden_phases)
AY_CHUTE = (40, 20, 40)        # 32,000 grains
AZ_BED = (40, 40, 5)           # 8,000 grains
AZ_POUR = 8000
AZ_HEIGHT = 90.0               # the pour block's height: one event
GRAN_STEPS, GRAN_EVERY = 1000, 100
GRAN_TWIN_CHUTE = (10, 10, 20)  # 2,000 grains
GRAN_TWIN_STEPS, GRAN_TWIN_EVERY = 20, 5
AZ_TWIN_BED = (20, 25, 2)      # 1,000 grains
AZ_TWIN_POUR, AZ_TWIN_HEIGHT = 1000, 40.0
AZ_TWIN_STEPS, AZ_TWIN_EVERY = 50, 10
AY_COLS = ("ke", "c_1", "vol")
AZ_COLS = ("ke", "c_1", "c_ts", "c_es", "c_cs", "c_cm")
WALL_GRAN_GOLDEN = {
    # tests/test_wall_gran.py's rows: step ke c_rot (LAMMPS 16Mar18 on
    # scripts/gen_wallgran_goldens.py's inputs)
    'zplane': [
        [0.0, 0.430840043363554, 0.112336233021246],
        [40.0, 0.941507767957806, 0.112336233021246],
        [80.0, 1.70350290483923, 0.112336233021246],
        [120.0, 2.71682545400783, 0.112336233021246],
        [160.0, 3.98147541546359, 0.112336233021246],
        [200.0, 5.12244071545889, 0.106278707199278],
        [240.0, 5.43429387507068, 0.0948416033468421],
        [280.0, 6.1593639958018, 0.0932648768534011],
    ],
    'hooke': [
        [0.0, 0.430840043363554, 0.112336233021246],
        [160.0, 3.98147541546359, 0.112336233021246],
        [200.0, 5.12247575594383, 0.108396439671863],
        [240.0, 5.43293511665156, 0.0911688697988497],
        [280.0, 6.16010769120933, 0.0855054634601906],
    ],
    'hertz': [
        [0.0, 0.430840043363554, 0.112336233021246],
        [160.0, 3.98147541546359, 0.112336233021246],
        [200.0, 5.42174725315351, 0.110994243512174],
        [240.0, 5.80518751222407, 0.103845468403138],
        [280.0, 6.62257499637481, 0.100711181860508],
    ],
    'shear': [
        [0.0, 0.430840043363554, 0.112336233021246],
        [160.0, 3.98147541546359, 0.112336233021246],
        [200.0, 5.13616540811937, 0.129596413356731],
        [240.0, 5.52082292564335, 0.358723359880122],
        [280.0, 6.27105098986118, 0.404621739595248],
    ],
    'zcyl': [
        [0.0, 0.430840043363554, 0.112336233021246],
        [40.0, 0.929570874243157, 0.0971204344862171],
        [80.0, 1.67798430450714, 0.0910770282078867],
        [120.0, 2.68678271472701, 0.093758762802094],
        [160.0, 3.93817377722502, 0.0805317412297482],
        [200.0, 4.72499669818765, 0.0716544336703515],
        [240.0, 5.85000608630325, 0.0677403996541164],
    ],
    'region': [
        [0.0, 0.430840043363554, 0.112336233021246],
        [40.0, 0.980419610630615, 0.115639816210593],
        [80.0, 1.73499046880912, 0.115467674809056],
        [120.0, 2.70875998987395, 0.117434315391927],
        [160.0, 3.28450276236198, 0.09841320961663],
        [200.0, 4.00702146798457, 0.0975789975053053],
        [240.0, 4.71476721802795, 0.0960220202245548],
    ],
}
# the contact-free rows of each case (at rel 1e-9 there; later rows a
# growing bar: test_wall_gran.py)
WALL_FREE_FLIGHT = {"zplane": 160, "hooke": 160, "hertz": 160,
                    "shear": 160, "zcyl": 0, "region": 0}
POUR_GOLDEN_DATA = """pour golden seed box

2 atoms

1 atom types

-3.2 3.2 xlo xhi
-3.2 3.2 ylo yhi
0.0 12.0 zlo zhi

Atoms

1 1 1.0 1.0 -1.1 0.4 0.5
2 1 1.0 1.0 1.3 -0.8 0.5

Velocities

1 0.0 0.0 0.0 0.0 0.0 0.0
2 0.0 0.0 0.0 0.0 0.0 0.0
"""
POUR_GOLDEN_SCRIPT = """units lj
atom_style sphere
boundary p p f
newton off
comm_modify vel yes
read_data data.pour
pair_style gran/hooke/history 400.0 NULL 8.0 NULL 0.5 1
pair_coeff * *
neighbor 0.3 bin
neigh_modify every 1 delay 0 check yes
region ins block -2.5 2.5 -2.5 2.5 8.0 11.5 units box
region ins2 block -2.5 2.5 -2.5 2.5 9.0 10.5 units box
timestep 0.005
fix 1 all gravity 1.0 vector 0 0 -1
fix 2 all nve/sphere
fix w all wall/gran hooke/history 400.0 NULL 8.0 NULL 0.5 1 zplane 0.0 NULL
{pour}
compute rot all erotate/sphere
thermo_style custom step atoms ke c_rot
thermo_modify norm no
thermo 25
run {steps}
"""
POUR_GOLDEN = {
    # tests/test_pour.py's rows: step atoms ke c_rot, and its pour lines
    "one": [
        [0, 2, 0.0, 0.0],
        [25, 12, 5.72951983931557, 0.0],
        [50, 12, 6.63014699052024, 0.0],
        [100, 12, 8.67680222340131, 0.0],
        [150, 12, 11.0507181992047, 0.0],
        [200, 12, 13.7518914999265, 0.0],
        [250, 12, 16.7803153067604, 0.0],
    ],
    "multi": [
        [0, 2, 0.0, 0.0],
        [25, 4, 2.58767581452554, 0.0],
        [125, 4, 3.88086335598149, 0.0],
        [150, 6, 8.6147574746494, 0.0],
        [250, 6, 12.1206654120616, 0.0],
        [275, 8, 15.249594124824, 0.0],
        [400, 10, 24.5778042219482, 0.0],
        [500, 10, 32.2569329135838, 0.0],
        [550, 11, 38.3159600010107, 0.0],
        [575, 11, 31.742043776901, 0.00602620308678922],
        [600, 11, 34.2766394435754, 0.00625192696469843],
    ],
}
POUR_GOLDEN_LINE = {
    "one": ("fix ins all pour 10 1 4767548 region ins vol 0.4 50 "
            "diam one 1.0", 250),
    "multi": ("fix ins all pour 9 1 2847291 region ins2 vol 0.05 50 "
              "diam range 0.8 1.2 dens 0.9 1.1 vel -0.3 0.3 -0.3 0.3 "
              "-2.0", 600),
}
CONTACT_GOLDEN_DATA = """tiny sphere test

6 atoms
1 atom types

0 10 xlo xhi
0 10 ylo yhi
0 10 zlo zhi

Atoms

1 1 1.0 1.0 1.0 1.0 1.0
2 1 1.0 1.0 1.8 1.0 1.0
3 1 1.0 1.0 2.6 1.0 1.0
4 1 2.0 1.0 6.0 6.0 6.0
5 1 2.0 1.0 7.4 6.0 6.0
6 1 1.0 1.0 9.5 9.5 9.5
"""
CONTACT_GOLDEN_SCRIPT = """units lj
atom_style sphere
boundary p p p
newton off
comm_modify vel yes
read_data data.spheres
pair_style gran/hooke/history 200000.0 NULL 50.0 NULL 0.5 0
pair_coeff * *
neighbor 0.1 bin
fix 3 all nve/sphere
compute ca all contact/atom
compute re all reduce sum c_ca
compute rm all reduce max c_ca
thermo_style custom step c_re c_rm
thermo_modify norm no
run 0
"""


def gran_text(text, every):
    """A granular script with its thermo interval's default `every` (the
    CLI's -var sets the steps)."""
    return text.replace("variable every index 100",
                        f"variable every index {every}")


def gran_run(path, work, name, text, steps, launches=None,
             reset_counts=None, read_counts=None):
    """`text` (written to work/name) through the CLI's main on the card,
    float64, `steps` steps: (script, log lines, peak memory); with the
    counters, launches[path] is what the run launched and must be none."""
    if reset_counts is not None:
        reset_counts()
    script, log, peak = np_cli_run(path, work, name, text,
                                   ("-var", "nstep", str(steps)))
    if read_counts is not None:
        launches[path] = read_counts()
        check_counts(path, launches[path], {})
    sim = script._sim
    rows = [line for line in log if line.split()[:1]
            and line.split()[0].isdigit()]
    print(f"path {path}: {sim.natoms} atoms, float64, {steps} steps, the "
          f"granular runner on the grid {sim.runner.neighbor_cfg.nbins} x "
          f"cap {sim.runner.neighbor_cfg.cap}; its log (rows 0-2 and the "
          "last):")
    for line in log:
        if line in rows[3:-1]:
            continue
        print(f"  {path}| {line}")
    return script, log, peak


def gran_readings(path, script, log, steps, peak):
    """A full path's steps/s and peak, rebuilds, candidate pairs, the
    shear history's bytes, then the ms of a contact pass (the shear
    updated in place on a copy of the final history; equal bit for bit
    on a repeat from that history; its device ms, kernels and heaviest
    kernels by torch.profiler) and of the walls' pass (the runner's
    wall_forces) by CUDA events on the final state."""
    import torch

    from lidp_tpu_torch.ops import granular as gran

    sim = script._sim
    runner, st, sys_ = sim.runner, sim.istate, sim.sys
    rate = script_peak(path, log, steps, peak)
    pairs = int(st.pairs.flat.shape[0])
    touch = None

    def contact(shear):
        return gran.gran_cell_forces(
            sys_.x, sys_.v, st.omega, sys_.mask, sim.nlist, sys_.box,
            runner.gp, shear, st.pairs)

    out = contact(st.shear.clone())
    touch = int((out[2].reshape(-1, 3) != 0).any(1).sum()) \
        if runner.gp.kind != "hooke" else None
    again = contact(st.shear.clone())
    if not all(torch.equal(a, b) for a, b in zip(out, again)):
        raise AssertionError(f"path {path}: two contact passes differ")
    work = out[2]
    del out, again
    ms = cuda_ms(lambda: contact(work), reps=10)
    dev, nk, top = profiled(lambda: contact(work))
    del work
    line = (f"path {path}: {runner.rebuilds} rebuilds in {steps} steps; "
            f"{pairs} candidate pairs"
            + (f" ({touch} with a shear history)" if touch is not None
               else "")
            + f"; the shear history {st.shear.numel() * 8 / 2**20:.1f} MiB; "
            f"a contact pass {ms:.4f} ms, bit for bit on a repeat (device "
            f"{dev:.4f} ms by torch.profiler in {nk} kernels; the most: "
            + ", ".join(f"{k} {v:.4f}" for k, v in top) + ")")
    if runner.walls:
        zero = torch.zeros_like(sys_.x)
        styles = "+".join(wf.wallstyle for wf in runner.walls)
        wall_ms = cuda_ms(lambda: runner.wall_forces(sys_, st, zero, zero),
                          reps=20)
        line += f", the walls' pass ({styles}) {wall_ms:.4f} ms"
    print(line + f" (CUDA events); {smi_line()}")
    torch.cuda.synchronize()
    return rate


def profiled(fn, top=3):
    """One call of fn under torch.profiler: (device ms, the CUDA kernels
    launched, the `top` kernels by device ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [(ev.key, getattr(ev, "self_device_time_total",
                            getattr(ev, "self_cuda_time_total", 0.0)) / 1e3,
            ev.count) for ev in prof.key_averages()
           if str(ev.device_type).endswith("CUDA")]
    evs.sort(key=lambda e: -e[1])
    return (sum(e[1] for e in evs), sum(e[2] for e in evs),
            [(k[:40], v) for k, v, _ in evs[:top]])


def gran_twin(path, work, name, text, steps, cols, reset_counts,
              read_counts, cost=20.0):
    """A 2,000-grain path on the card (no launch), then deferred to its
    CPU twin (every row at rel 1e-9, the final x, v within 1e-8)."""
    script, _, _ = gran_run(path, work, name, text, steps, {},
                            reset_counts, read_counts)
    check_rows_finite(path, script.thermo_rows, cols)
    defer_twin(path, work, name, steps,
               twin_check(path, run_state(script), cols), threads=2,
               cost=cost)
    return script


def granular_paths(launches, reset_counts, read_counts):
    """Paths AY, AZ and their 2,000-grain twins, then the goldens (module
    docstring)."""
    import numpy as np
    import torch

    work = tempfile.mkdtemp(prefix="chip_smoke_gran_")
    try:
        args = (launches, reset_counts, read_counts)
        # AY: the chute at full width
        ay = os.path.join(work, "ay")
        os.makedirs(ay)
        n = chute_layout(os.path.join(ay, "data.chute"), *AY_CHUTE)
        s, log, peak = gran_run("AY", ay, "in.chute",
                                gran_text(CHUTE_SCRIPT, GRAN_EVERY),
                                GRAN_STEPS, *args)
        sim = s._sim
        rows = s.thermo_rows
        check_rows_finite("AY", rows, AY_COLS)
        base = np.asarray(s.type) == 2
        x0 = s.data.x
        xb = sim.sys.x[:n].double().cpu().numpy()[base]
        if not (n == math.prod(AY_CHUTE) and all(r["atoms"] == n
                                                 for r in rows)
                and [r["step"] for r in rows]
                == list(range(0, GRAN_STEPS + 1, GRAN_EVERY))
                and base.sum() == AY_CHUTE[0] * AY_CHUTE[1]
                and np.array_equal(xb, x0[base])):
            raise AssertionError(f"path AY: {n} grains, rows "
                                 f"{[(r['step'], r['atoms']) for r in rows]}"
                                 ", or the base moved")
        print(f"path AY: the {base.sum()} base grains at their read "
              "positions; the "
              f"box's z {float(sim.sys.box.lo[2]):.6g} - "
              f"{float(sim.sys.box.hi[2]):.6g} (shrink-wrapped top)")
        gran_readings("AY", s, log, GRAN_STEPS, peak)
        del s, sim
        torch.cuda.empty_cache()

        # AZ: a pour onto a bed
        az = os.path.join(work, "az")
        os.makedirs(az)
        text = gran_text(pour_bed_case(az, *AZ_BED, AZ_POUR, AZ_HEIGHT),
                         GRAN_EVERY)
        s, log, peak = gran_run("AZ", az, "in.bed", text, GRAN_STEPS, *args)
        sim = s._sim
        rows = s.thermo_rows
        check_rows_finite("AZ", rows, AZ_COLS)
        pf = sim.pour_fixes[0]
        nbed = math.prod(AZ_BED)
        if not (rows[0]["atoms"] == nbed
                and all(r["atoms"] == nbed + AZ_POUR for r in rows[1:])
                and pf.nevents == 1 and pf.ninserted == AZ_POUR
                and pf.nper >= AZ_POUR and pf.nfirst == 1):
            raise AssertionError(f"path AZ: atoms "
                                 f"{[r['atoms'] for r in rows]}, events "
                                 f"{pf.nevents}, nper {pf.nper}")
        print(f"path AZ: fix pour's count {pf.nper} covers the {AZ_POUR} "
              f"grains: one event at step {pf.nfirst} ({pf.ninserted} "
              f"inserted, the next event {pf.nfreq} steps on); contacts "
              f"{rows[0]['c_cs']:g} at step 0, {rows[-1]['c_cs']:g} at "
              f"step {GRAN_STEPS}")
        gran_readings("AZ", s, log, GRAN_STEPS, peak)
        del s, sim
        torch.cuda.empty_cache()

        # the 2,000-grain paths and their twins
        tw = os.path.join(work, "ay-2k")
        os.makedirs(tw)
        chute_layout(os.path.join(tw, "data.chute"), *GRAN_TWIN_CHUTE)
        text = gran_text(CHUTE_SCRIPT, GRAN_TWIN_EVERY)
        for path, variant in (
                ("AY-2k", text),
                ("AY-nvt-2k", text.replace(
                    "active nve/sphere",
                    "active nvt/sphere temp 1.0 1.0 0.01")),
                ("AY-hooke-2k", text.replace("gran/hooke/history",
                                             "gran/hooke"))):
            d = os.path.join(work, path)
            shutil.copytree(tw, d)
            gran_twin(path, d, "in.chute", variant, GRAN_TWIN_STEPS,
                      AY_COLS, reset_counts, read_counts)
        d = os.path.join(work, "AZ-2k")
        os.makedirs(d)
        text = gran_text(pour_bed_case(d, *AZ_TWIN_BED, AZ_TWIN_POUR,
                                       AZ_TWIN_HEIGHT), AZ_TWIN_EVERY)
        s = gran_twin("AZ-2k", d, "in.bed", text, AZ_TWIN_STEPS, AZ_COLS,
                      reset_counts, read_counts)
        if [r["atoms"] for r in s.thermo_rows[1:]] != [
                math.prod(AZ_TWIN_BED) + AZ_TWIN_POUR] * (
                    AZ_TWIN_STEPS // AZ_TWIN_EVERY):
            raise AssertionError("path AZ-2k: atoms "
                                 f"{[r['atoms'] for r in s.thermo_rows]}")
        del s
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    granular_golden_phases()


def granular_golden_phases():
    """The LAMMPS rows of tests/test_wall_gran.py (six cases: contact-free
    rows at rel 1e-9, then its growing bar), tests/test_pour.py (two: the
    atom counts equal, rel 1e-9, the multi case's rows from step 575 at
    1e-4) and tests/test_chute.py's contact/atom case (reduce sum 6, max
    2), through LammpsScript in float64 on the card."""
    import importlib.util

    import torch

    from lidp_tpu_torch.io.script import LammpsScript

    spec = importlib.util.spec_from_file_location(
        "gen_wallgran_goldens",
        os.path.join(ROOT, "scripts", "gen_wallgran_goldens.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    work = tempfile.mkdtemp(prefix="chip_smoke_gran_gold_")
    try:
        gen.write_data(os.path.join(work, "data.wallgran"))
        gen.write_data(os.path.join(work, "data.wallgran2"), xyscale=0.7)
        worst = {}
        for case, want in WALL_GRAN_GOLDEN.items():
            s = LammpsScript(dtype=torch.float64, log=lambda line: None)
            s.root = work
            s.execute(gen.make_input(case).splitlines())
            got = {int(r["step"]): r for r in s.thermo_rows}
            free = WALL_FREE_FLIGHT[case]
            for ref in want:
                step = int(ref[0])
                rel = 1e-9 if step <= free else (
                    1e-5 * max(1.0, (step - free) / 40.0) if step <= 240
                    else 1e-3)
                for name, v in zip(("ke", "c_rot"), ref[1:]):
                    bar = max(rel * abs(v), 1e-12)
                    err = abs(got[step][name] - v)
                    worst[case] = max(worst.get(case, 0.0), err / bar)
                    if not err <= bar:
                        raise AssertionError(
                            f"golden wall/gran {case} step {step} {name}: "
                            f"{got[step][name]!r}, LAMMPS {v!r}")
        with open(os.path.join(work, "data.pour"), "w") as fh:
            fh.write(POUR_GOLDEN_DATA)
        for case, want in POUR_GOLDEN.items():
            pour, steps = POUR_GOLDEN_LINE[case]
            s = LammpsScript(dtype=torch.float64, log=lambda line: None)
            s.root = work
            s.execute(POUR_GOLDEN_SCRIPT.format(pour=pour, steps=steps)
                      .splitlines())
            got = {int(r["step"]): r for r in s.thermo_rows}
            for ref in want:
                r = got[int(ref[0])]
                rel = 1e-9 if (case == "one" or ref[0] < 575) else 1e-4
                if r["atoms"] != ref[1]:
                    raise AssertionError(f"golden pour {case} step {ref[0]}"
                                         f": {r['atoms']} atoms")
                for name, v in zip(("ke", "c_rot"), ref[2:]):
                    bar = max(rel * abs(v), 1e-12)
                    err = abs(r[name] - v)
                    worst["pour " + case] = max(
                        worst.get("pour " + case, 0.0), err / bar)
                    if not err <= bar:
                        raise AssertionError(
                            f"golden pour {case} step {ref[0]} {name}: "
                            f"{r[name]!r}, LAMMPS {v!r}")
        with open(os.path.join(work, "data.spheres"), "w") as fh:
            fh.write(CONTACT_GOLDEN_DATA)
        s = LammpsScript(dtype=torch.float64, log=lambda line: None)
        s.root = work
        s.execute(CONTACT_GOLDEN_SCRIPT.splitlines())
        row = s.thermo_rows[0]
        if not (row["c_re"] == 6.0 and row["c_rm"] == 2.0):
            raise AssertionError(f"golden contact/atom: {row}")
        print("golden granular (tests/test_wall_gran.py, test_pour.py, on "
              "the card): " + ", ".join(f"{c} {v:.3g}"
                                         for c, v in worst.items())
              + " of those tests' bars; contact/atom reduce sum 6, max 2 "
              "as LAMMPS's")
    finally:
        shutil.rmtree(work, ignore_errors=True)


# phase 19: output and coupling (output_paths).  BA: the fluid's run
# dumped and rerun on the panel engine; BB: in.lj with the local computes
# and every dump style; BC: fix external through the library
BA_SIDE = 15                   # path BA: path H's fluid, 10,125 atoms
BA_STEPS = 10                  # path BA's run: frames at 0, 2, ..., 10
BA_EVERY = 2
BA_COLS = ("pe", "evdwl", "ecoul", "elong", "epol")
BA_REL = 1e-8                  # rerun rows vs the run's, of max(1, |value|)
BA_PANEL = ("pair_panel_df", "eind_panel_df", "dipole_panel_df")
BA_TWIN_SIDE = 7               # BA-1k: 1,029 atoms, the dense route
BA_DUMP = """\
dump d all custom {every} fluid.dump id type x y z vx vy vz
dump_modify d sort id format float %.17g
"""
BA_RERUN = "rerun fluid.dump dump x y z vx vy vz"
BB_SCALE = "1"                 # in.lj's x, y, z: 32,000 atoms
BB_STEPS = 1000                # in.lj's run
BB_EVERY = 500                 # the local, xyz, cfg and store/state frames
BB_DCD = 100
BB_IMAGE = 2000                # one image frame: step 0
BB_THERMO = 100
BB_TWIN_SCALE = "0.55"         # BB-5k: in.lj at 5,324 atoms (cells)
BB_TWIN_STEPS = 100
BB_TWIN_EVERY = 50
BB_COLS = ("temp", "epair", "emol", "etotal", "press", "v_tcv")
BB_OUTPUT = """\
compute pl all pair/local dist eng force
compute pp all property/local patom1 patom2
dump loc all local {every} bb.local index c_pl[1] c_pl[2] c_pl[3] \
c_pp[1] c_pp[2]
dump xyz all xyz {every} bb.xyz
dump dcd all dcd {dcd} bb.dcd
dump cfg all cfg {every} bb.cfg mass type xs ys zs
dump img all image {image} bb.*.ppm type type
fix ss all store/state 0 x y z
dump st all custom {every} bb.state id f_ss[1] f_ss[2] f_ss[3]
dump_modify st format float %.17g
compute tt all temp
variable tcv internal 0.0
fix pid all controller 10 1.0 0.5 0.1 0.05 c_tt 1.44 tcv
thermo_style custom step temp epair emol etotal press v_tcv
thermo {thermo}
"""
BB_WRITERS = ("write_local_frame", "write_dump_frame", "write_dcd_frame",
              "write_cfg_frame", "write_image_frame")
BC_SCALE = "1"                 # path BC: in.lj at 32,000 atoms
BC_STEPS = 50
BC_REL = 1e-6                  # BC's rows vs spring/self's and addforce's
BC_K = 0.5
BC_FORCE = (0.3, -0.2, 0.1)
BC_THERMO = 10
BC_TWIN_SCALE = "0.55"         # BC-5k: 5,324 atoms (cells), float64
BC_FIX = {"callback": "fix e all external pf/callback 1 1",
          "array": "fix e all external pf/array 1",
          "spring": f"fix e all spring/self {BC_K}",
          "addforce": "fix e all addforce {:g} {:g} {:g}".format(*BC_FORCE),
          "plain": ""}
EXTERNAL_TWIN = """\
import os, sys, time
import numpy as np
import torch
torch.set_num_threads(int(os.environ["TWIN_THREADS"]))
import chip_smoke
with open(sys.argv[2]) as fh:
    text = fh.read()
t0 = time.perf_counter()
rows, calls, L = chip_smoke.external_case(text, int(sys.argv[3]), "callback",
                                          device="cpu", dtype=torch.float64)
seconds = time.perf_counter() - t0
sim = L.lmp._sim
n = sim.natoms
cols = [c for c in rows[0] if c not in ("step", "atoms", "bonds")]
np.savez(sys.argv[1], x=sim.sys.x[:n].numpy(), v=sim.sys.v[:n].numpy(),
         mu=sim.sys.mu[:n].numpy(), cols=np.array(cols, dtype=str),
         root=L.lmp.root, rows=np.array([[r[c] for c in cols] for r in rows]),
         minimized=np.zeros((0, 3)), seconds=seconds,
         calls=np.array([s for s, _ in calls]))
assert "jax" not in sys.modules
"""


def lj_scaled(text, scale):
    """in.lj's lines with its `variable x, y, z index 1` set to scale (a
    twin sets no -var)."""
    for a in "xyz":
        text = text.replace(f"variable\t{a} index 1",
                            f"variable\t{a} index {scale}")
    return text


def bb_text(scale, steps, every, dcd, image, thermo):
    """in.lj (LJ_SCRIPT at `scale`) with BB_OUTPUT before its run of
    `steps`."""
    out = BB_OUTPUT.format(every=every, dcd=dcd, image=image, thermo=thermo)
    return cut_run(lj_scaled(LJ_SCRIPT, scale), steps).replace(
        "run\t\t", out + "run\t\t")


def external_case(text, steps, mode, device="cuda", dtype=None, log=None):
    """in.lj's lines `text` through lidp_tpu_torch.api.lammps with BC_FIX[
    mode] in place of its run, thermo every BC_THERMO, then `run steps`:
    mode "callback" registers a numpy callback, -BC_K times the minimum
    image of x - x0 (fix spring/self's force while no atom moves half a
    box), and keeps (step, x) of each call; "array" sets the uniform
    BC_FORCE on every atom.  Returns (thermo rows, calls, the lammps)."""
    import numpy as np
    import torch

    from lidp_tpu_torch import api

    L = api.lammps(cmdargs=["-log", log] if log else None,
                   dtype=dtype or torch.float32, device=device)
    L.commands_string(text.replace(
        "run\t\t100", f"{BC_FIX[mode]}\nthermo {BC_THERMO}\n"))
    calls = []
    if mode == "callback":
        x0 = np.array(L.lmp.x, float)
        box = np.asarray(L.lmp.box_hi - L.lmp.box_lo, float)

        def callback(caller, step, nlocal, ids, x, fext):
            d = x - x0
            d -= box * np.round(d / box)
            fext[:] = -BC_K * d
            calls.append((int(step), x[:4].copy()))

        L.set_fix_external_callback("e", callback)
    elif mode == "array":
        L.fix_external_set_force("e", np.tile(BC_FORCE,
                                              (L.get_natoms(), 1)))
    L.command(f"run {steps}")
    return L.lmp.thermo_rows, calls, L


class TimedWriters:
    """Within `with TimedWriters() as t:` each dump writer of io/dump.py
    (BB_WRITERS) is timed by the host clock: t.ms[dump ID] lists its
    frames' ms."""

    def __enter__(self):
        from lidp_tpu_torch.io import dump as dump_mod

        self.mod = dump_mod
        self.orig = {w: getattr(dump_mod, w) for w in BB_WRITERS}
        self.ms = {}

        def timed(fn):
            def call(spec, *a, **kw):
                t0 = time.perf_counter()
                out = fn(spec, *a, **kw)
                self.ms.setdefault(spec.did, []).append(
                    1e3 * (time.perf_counter() - t0))
                return out
            return call

        for w, fn in self.orig.items():
            setattr(dump_mod, w, timed(fn))
        return self

    def __exit__(self, *exc):
        for w, fn in self.orig.items():
            setattr(self.mod, w, fn)
        return False


def read_local(path):
    """A dump local file's frames: (step, (rows, columns) float array)."""
    import numpy as np

    with open(path) as fh:
        text = fh.read()
    out = []
    for frame in text.split("ITEM: TIMESTEP\n")[1:]:
        lines = frame.splitlines()
        n = int(lines[2])
        body = [line.split() for line in lines[8:8 + n]]
        out.append((int(lines[0]), np.array(body, float).reshape(n, -1)))
    return out


def read_xyz(path):
    """A dump xyz file's frames: (step, (n, 4) type x y z)."""
    import numpy as np

    with open(path) as fh:
        lines = fh.read().splitlines()
    out, i = [], 0
    while i < len(lines):
        n = int(lines[i])
        step = int(lines[i + 1].split()[-1])
        out.append((step, np.array([w.split() for w in
                                    lines[i + 2:i + 2 + n]], float)))
        i += 2 + n
    return out


def read_cfg(path):
    """A dump cfg file's frames: (n, H0 diagonal, (n, 3) xs ys zs)."""
    import numpy as np

    with open(path) as fh:
        text = fh.read()
    out = []
    for frame in text.split("Number of particles = ")[1:]:
        lines = frame.splitlines()
        h = [float(w.split("=")[1].split()[0]) for w in lines
             if w.startswith(("H0(1,1)", "H0(2,2)", "H0(3,3)"))]
        rows = [w.split() for w in lines if len(w.split()) == 3
                and "=" not in w]
        out.append((int(lines[0]), h, np.array(rows, float)))
    return out


def read_dcd(raw):
    """A dcd file's bytes: (header ints, natoms, frames of (cell 6, (n, 3)
    float32))."""
    import struct

    import numpy as np

    off = 0

    def rec():
        nonlocal off
        n = struct.unpack_from("<i", raw, off)[0]
        payload = raw[off + 4:off + 4 + n]
        if struct.unpack_from("<i", raw, off + 4 + n)[0] != n:
            raise AssertionError("dcd: a record's lengths differ")
        off += 8 + n
        return payload

    hdr = rec()
    rec()
    natoms = struct.unpack("<i", rec())[0]
    frames = []
    while off < len(raw):
        cell = struct.unpack("<6d", rec())
        xyz = [np.frombuffer(rec(), "<f4") for _ in range(3)]
        frames.append((cell, np.stack(xyz, axis=1)))
    return struct.unpack_from("<9i", hdr, 4), natoms, frames


def check_local_frame(path, rows, x, L, cut, eng_total, rel, dev):
    """One pair/local + property/local frame (index dist eng force patom1
    patom2) against the state it was written from: the index 1..n, the
    pairs i < j in (i, j) order, each pair's distance from x (float64) to
    the printed digits, the count of i < j pairs inside the cutoff by a
    dense pass on the run's device, and the eng column's sum against eng_total
    (the thermo's pair energy times N) at rel."""
    import numpy as np
    import torch

    n = len(rows)
    i, j = rows[:, 4].astype(np.int64) - 1, rows[:, 5].astype(np.int64) - 1
    if not (np.array_equal(rows[:, 0], np.arange(1, n + 1))
            and (i < j).all()
            and (np.diff(i * len(x) + j) > 0).all()):
        raise AssertionError(f"path {path}: local rows not i < j in (i, j) "
                             "order")
    d = x[i] - x[j]
    d -= L * np.round(d / L)
    r = np.sqrt((d * d).sum(1))
    if not np.allclose(rows[:, 1], r, rtol=1e-7, atol=0.0):
        raise AssertionError(f"path {path}: local dist vs the positions")
    xt = torch.as_tensor(x, device=dev)
    Lt = torch.as_tensor(L, device=dev)
    count = 0
    for a in range(0, len(x), 2048):
        dd = xt[a:a + 2048, None, :] - xt[None, :, :]
        dd -= Lt * torch.round(dd / Lt)
        rsq = (dd * dd).sum(-1)
        upper = torch.arange(a, min(a + 2048, len(x)),
                             device=dev)[:, None] < torch.arange(
                                 len(x), device=dev)[None, :]
        count += int(((rsq < cut * cut) & upper).sum())
    if count != n:
        raise AssertionError(f"path {path}: {n} local rows, {count} pairs "
                             "inside the cutoff")
    esum = float(rows[:, 2].sum())
    if not abs(esum - eng_total) <= rel * abs(eng_total):
        raise AssertionError(f"path {path}: local eng sum {esum!r}, the "
                             f"thermo's {eng_total!r}")
    return abs(esum - eng_total) / abs(eng_total)


def bb_checks(path, work, script, steps, every, dcd_every, image_step,
              eng_rel):
    """BB's files against its run: the local frames (check_local_frame on
    the last, its eng sum at eng_rel), the xyz, cfg, dcd and store/state
    frames, the image."""
    import numpy as np
    import torch

    if steps % every:
        raise AssertionError(f"path {path}: the last frames are not at the "
                             "run's end")
    sim = script._sim
    n = sim.natoms
    x = sim.sys.x[:n].double().cpu().numpy()
    lo = sim.sys.box.lo.double().cpu().numpy()
    L = (sim.sys.box.hi - sim.sys.box.lo).double().cpu().numpy()
    xw = x - np.floor((x - lo) / L) * L
    frames = list(range(0, steps + 1, every))
    loc = read_local(os.path.join(work, "bb.local"))
    if [s for s, _ in loc] != frames:
        raise AssertionError(f"path {path}: local frames {len(loc)}")
    last = script.thermo_rows[-1]
    worst = check_local_frame(path, loc[-1][1], x, L, 2.5,
                              last["epair"] * n, eng_rel, sim.sys.x.device)
    xyz = read_xyz(os.path.join(work, "bb.xyz"))
    err = float(np.abs(xyz[-1][1][:, 1:] - xw).max())
    if [s for s, _ in xyz] != frames or not err <= 1e-5 * L.max():
        raise AssertionError(f"path {path}: xyz frames or positions {err}")
    cfg = read_cfg(os.path.join(work, "bb.cfg"))
    cerr = float(np.abs(cfg[-1][2] * L + lo - xw).max())
    if len(cfg) != len(frames) or cfg[-1][0] != n \
            or not cerr <= 1e-8 * L.max():
        raise AssertionError(f"path {path}: cfg frames or positions {cerr}")
    with open(os.path.join(work, "bb.dcd"), "rb") as fh:
        _, natoms, dframes = read_dcd(fh.read())
    derr = float(np.abs(dframes[-1][1] - xw.astype(np.float32)).max())
    if natoms != n or len(dframes) != steps // dcd_every + 1 \
            or not derr <= 4e-6 * L.max():
        raise AssertionError(f"path {path}: dcd {natoms} atoms, "
                             f"{len(dframes)} frames, positions {derr}")
    with open(os.path.join(work, "bb.state")) as fh:
        st = fh.read().split("ITEM: TIMESTEP\n")
    rows = np.array([w.split() for w in st[-1].splitlines()[8:]], float)
    x0 = np.asarray(script.x, float)
    if script.dtype == torch.float32:
        x0 = x0.astype(np.float32).astype(float)
    if len(st) != len(frames) + 1 or not np.array_equal(rows[:, 1:], x0):
        raise AssertionError(f"path {path}: store/state's f_ss is not the "
                             "setup positions")
    with open(os.path.join(work, f"bb.{image_step}.ppm"), "rb") as fh:
        img = fh.read()
    if not img.startswith(b"P6\n512 512\n255\n") or len(img) != 15 + 3 * 512 \
            * 512 or not any(img[15:]):
        raise AssertionError(f"path {path}: the image frame")
    print(f"path {path}: {len(loc)} local frames (the last: {len(loc[-1][1])}"
          f" rows, i < j in (i, j) order, the count a dense pass on the "
          f"card gives, eng's sum at {worst:.3g} of the thermo's E_pair x N)"
          f"; {len(xyz)} xyz, {len(cfg)} cfg and {len(dframes)} dcd frames "
          f"at the final positions ({err:.3g}, {cerr:.3g}, {derr:.3g} of "
          f"max L {L.max():.6g}); store/state's f_ss the setup positions; "
          f"one {len(img)}-byte PPM")


def twin_files(path, mine):
    """A check of an output twin's files against `mine` (the card run's:
    name -> text or bytes): the local frames the same rows and (patom1,
    patom2) sequence, their values within rel 1e-9; xyz and cfg values
    within 1e-8 of the largest or one unit of the printed digit; dcd's
    float32 positions within 1e-8 of the largest plus one float32 ulp."""
    import numpy as np

    def local(text):
        return [np.array([w.split() for w in f.splitlines()[8:]], float)
                for f in text.split("ITEM: TIMESTEP\n")[1:]]

    def words(text):
        return [w.split() for w in text.splitlines()]

    def check(root):
        worst = {}
        for name, data in mine.items():
            with open(os.path.join(root, name),
                      "rb" if isinstance(data, bytes) else "r") as fh:
                theirs = fh.read()
            if name.endswith(".local"):
                a, b = local(data), local(theirs)
                if [len(f) for f in a] != [len(f) for f in b] or not all(
                        np.array_equal(fa[:, 4:], fb[:, 4:])
                        for fa, fb in zip(a, b)):
                    raise AssertionError(f"path {path}: {name}'s rows or "
                                         "pairs differ from the twin's")
                rel = max(float((np.abs(fa[:, 1:4] - fb[:, 1:4])
                                 / np.maximum(np.abs(fb[:, 1:4]), 1e-300)
                                 ).max()) if len(fa) else 0.0
                          for fa, fb in zip(a, b))
                if not rel <= 1e-9:
                    raise AssertionError(f"path {path}: {name} values at "
                                         f"rel {rel:.3g}")
                worst[name] = rel
            elif name.endswith(".dcd"):
                a = [f for _, f in read_dcd(data)[2]]
                b = [f for _, f in read_dcd(theirs)[2]]
                big = max(float(np.abs(f).max()) for f in b)
                err = max(float(np.abs(fa.astype(float) - fb).max())
                          for fa, fb in zip(a, b))
                ulp = float(np.spacing(np.float32(big)))
                if len(a) != len(b) or not err <= 1e-8 * big + ulp:
                    raise AssertionError(f"path {path}: {name} at {err}")
                worst[name] = err / (1e-8 * big + ulp)
            else:
                wa, wb = words(data), words(theirs)
                if len(wa) != len(wb):
                    raise AssertionError(f"path {path}: {name}'s lines")
                big = max(abs(float(v)) for line in wb for v in line
                          if _is_number(v))
                ratio = 0.0
                for la, lb in zip(wa, wb):
                    if la == lb:
                        continue
                    fa, fb = np.array(la, float), np.array(lb, float)
                    # one unit of the last printed digit (%g: 6, cfg's
                    # %.10g: 10 significant digits)
                    digits = 10 if name.endswith(".cfg") else 6
                    unit = 10.0 ** (np.floor(np.log10(np.maximum(
                        np.abs(fb), 1e-300))) - digits + 1)
                    bar = np.maximum(1e-8 * big, unit)
                    r = float((np.abs(fa - fb) / bar).max())
                    ratio = max(ratio, r)
                    if not r <= 1.0:
                        raise AssertionError(f"path {path}: {name} line "
                                             f"{la} vs the twin's {lb}")
                worst[name] = ratio
        print(f"path {path} files vs its CPU twin's: " + ", ".join(
            f"{k} at {v:.3g} of its bar" for k, v in worst.items()))

    return check


def _is_number(word):
    try:
        float(word)
    except ValueError:
        return False
    return True


def output_paths(launches, reset_counts, read_counts):
    """Paths BA, BB, BC and their twins BA-1k, BB-5k, BC-5k (module
    docstring)."""
    import numpy as np
    import torch

    from lidp_tpu_torch.io.script import LammpsScript

    work = tempfile.mkdtemp(prefix="chip_smoke_output_")
    try:
        # BA: the fluid's run dumped every 2 steps, then rerun on its frames
        ba = os.path.join(work, "ba")
        os.makedirs(ba)
        fluid_script_case(ba, n_side=BA_SIDE)
        run_text = FLUID_SCRIPT.replace(
            "run ${nstep}", BA_DUMP.format(every=BA_EVERY) + "run ${nstep}")
        rr_text = FLUID_SCRIPT.replace("run ${nstep}", BA_RERUN)
        for name, text in (("in.run", run_text), ("in.rerun", rr_text)):
            with open(os.path.join(ba, name), "w") as fh:
                fh.write(text)
        logs = {}
        scripts = {}
        for name in ("in.run", "in.rerun"):
            logs[name] = []
            s = LammpsScript(dtype=torch.float64, log=logs[name].append)
            s.variables.update(prec="1e-11", nstep=str(BA_STEPS))
            scripts[name] = s
        run, rr = scripts["in.run"], scripts["in.rerun"]
        run.file(os.path.join(ba, "in.run"))
        if type(run._sim.runner).__name__ != "FastPolarRunner":
            raise AssertionError("path BA: the run is off the panel engine")
        frames = []
        orig_run = LammpsScript._run

        def counted(script, nsteps):
            out = orig_run(script, nsteps)
            if script is rr:
                frames.append(read_counts())
            return out

        LammpsScript._run = counted
        try:
            reset_counts()
            rr.file(os.path.join(ba, "in.rerun"))
            launches["BA"] = read_counts()
        finally:
            LammpsScript._run = orig_run
        steps = list(range(0, BA_STEPS + 1, BA_EVERY))
        if [int(r["step"]) for r in rr.thermo_rows] != steps \
                or len(frames) != len(steps):
            raise AssertionError(f"path BA: rerun rows "
                                 f"{[r['step'] for r in rr.thermo_rows]}")
        prev = {k: 0 for k in ALL_KERNELS}
        per_frame = []
        for k, got in enumerate(frames):
            delta = {name: got[name] - prev[name] for name in BA_PANEL}
            if not all(delta.values()):
                raise AssertionError(f"path BA frame {k}: a panel kernel "
                                     f"did not launch: {delta}")
            per_frame.append(delta)
            prev = got
        check_counts("BA", launches["BA"], {
            name: launches["BA"][name] for name in BA_PANEL})
        if type(rr._sim.runner).__name__ != "FastPolarRunner":
            raise AssertionError("path BA: the rerun is off the panel engine")
        byrow = {int(r["step"]): r for r in run.thermo_rows}
        worst = rows_agree("BA", rr.thermo_rows,
                           [byrow[s] for s in steps], [BA_REL] * len(steps),
                           BA_COLS)
        tm = np.array(rr.rerun_timings)
        print(f"path BA: {run._sim.natoms} atoms, float64, precision "
              f"1e-11, FastPolarRunner fused; the run's {BA_STEPS} steps "
              f"dumped every {BA_EVERY} (%.17g), then `{BA_RERUN}`: "
              f"{len(steps)} frames, each rebuilding the Simulation and "
              f"evaluating `run 0`; the rerun rows' {', '.join(BA_COLS)} "
              f"at {worst:.3g} of rel {BA_REL:g} of max(1, |value|) of the "
              f"run's rows at the same steps")
        for k, (d, (b, e)) in enumerate(zip(per_frame, tm)):
            print(f"  BA| frame {k} (step {steps[k]}): rebuild {b:.1f} ms, "
                  f"evaluation {e:.1f} ms; launches {d}")
        print(f"path BA: ms a frame {tm.sum(1).mean():.1f} (rebuild "
              f"{tm[:, 0].mean():.1f} = {100 * tm[:, 0].sum() / tm.sum():.1f}"
              f"%, evaluation {tm[:, 1].mean():.1f}); the run's "
              f"{next(w for w in logs['in.run'] if w.startswith('Loop'))}; "
              f"{smi_line()}")
        del run, rr, scripts
        torch.cuda.empty_cache()

        # BA-1k: the same at 1,029 atoms on the dense route, run and rerun
        # in one script, against its CPU twin
        d = os.path.join(work, "ba-1k")
        os.makedirs(d)
        fluid_script_case(d, n_side=BA_TWIN_SIDE)
        text = FLUID_SCRIPT.replace(
            "run ${nstep}", BA_DUMP.format(every=BA_EVERY)
            + "run ${nstep}\nundump d\n" + BA_RERUN)
        with open(os.path.join(d, "in.ba"), "w") as fh:
            fh.write(text)
        s = LammpsScript(dtype=torch.float64, log=lambda line: None)
        s.variables.update(nstep=str(BA_STEPS))
        fast = os.environ.pop("LIDP_FAST_POLAR", None)
        reset_counts()
        try:
            s.file(os.path.join(d, "in.ba"))
        finally:
            if fast is not None:
                os.environ["LIDP_FAST_POLAR"] = fast
        check_counts("BA-1k", read_counts(), {})
        rows = s.thermo_rows
        if len(rows) != BA_STEPS + 1 + len(steps):
            raise AssertionError(f"path BA-1k: {len(rows)} rows")
        worst = rows_agree("BA-1k", rows[BA_STEPS + 1:],
                           rows[:BA_STEPS + 1:BA_EVERY],
                           [BA_REL] * len(steps), BA_COLS)
        print(f"path BA-1k: {s._sim.natoms} atoms, float64, the dense "
              f"route; {BA_STEPS} steps then the rerun of {len(steps)} "
              f"frames, at {worst:.3g} of BA's bar")
        defer_twin("BA-1k", d, "in.ba", BA_STEPS,
                   twin_check("BA-1k", run_state(s), G64_COLS),
                   threads=4, cost=60.0)
        del s
        torch.cuda.empty_cache()

        # BB: in.lj with the output stack, float32 on the cell grid
        bb = os.path.join(work, "bb")
        os.makedirs(bb)
        with open(os.path.join(bb, "in.bb"), "w") as fh:
            fh.write(bb_text(BB_SCALE, BB_STEPS, BB_EVERY, BB_DCD, BB_IMAGE,
                             BB_THERMO))
        log = []
        s = LammpsScript(dtype=torch.float32, log=log.append)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with TimedWriters() as tw:
            s.file(os.path.join(bb, "in.bb"))
        launches["BB"] = read_counts()
        peak = torch.cuda.max_memory_allocated()
        sim = s._sim
        route = script_route(s)
        print(f"path BB: bench/in.lj with pair/local, property/local and "
              f"dump local every {BB_EVERY}, dump xyz and cfg every "
              f"{BB_EVERY}, dcd every {BB_DCD}, one image frame, fix "
              f"store/state dumped every {BB_EVERY}, fix controller 10 on "
              f"c_tt into v_tcv; {sim.natoms} atoms, float32, {route}")
        lj = launches["BB"]["cell_pair_forces_lj"]
        if not (lj >= BB_STEPS + 1 and "cell_pair_forces_lj" in route):
            raise AssertionError(f"path BB launches {launches['BB']}")
        check_counts("BB", launches["BB"], {"cell_pair_forces_lj": lj})
        rows = s.thermo_rows
        check_rows_finite("BB", rows, BB_COLS)
        for r in rows[::5]:
            print(f"  BB| step {r['step']}: " + ", ".join(
                f"{c} {r[c]:.8g}" for c in BB_COLS))
        if [r["step"] for r in rows] != list(range(0, BB_STEPS + 1,
                                                   BB_THERMO)) \
                or rows[-1]["v_tcv"] == 0.0:
            raise AssertionError("path BB: the rows or the controller")
        # the eng column's sum against the float32 run's own E_pair: the
        # run sums in float32
        bb_checks("BB", bb, s, BB_STEPS, BB_EVERY, BB_DCD, 0, 1e-4)
        script_peak("BB", log, BB_STEPS, peak)
        for k, (dev_ms, fmt_ms, nrows) in enumerate(s.dumps["loc"].timings):
            print(f"  BB| local frame {k}: {nrows} rows, device {dev_ms:.1f}"
                  f" ms (the rows formed and read), formatting {fmt_ms:.1f}"
                  f" ms")
        print("path BB frames by dump (host clock, ms each): " + "; ".join(
            f"{did} " + ", ".join(f"{t:.1f}" for t in ms)
            for did, ms in tw.ms.items()))
        del s, sim
        torch.cuda.empty_cache()

        # BB-5k: the same stack at 5,324 atoms, float64 (the cell grid, the
        # plain cell pass), against its CPU twin, files included
        d = os.path.join(work, "bb-5k")
        os.makedirs(d)
        with open(os.path.join(d, "in.bb"), "w") as fh:
            fh.write(bb_text(BB_TWIN_SCALE, BB_TWIN_STEPS, BB_TWIN_EVERY,
                             BB_TWIN_EVERY, BB_IMAGE, 10))
        s = LammpsScript(dtype=torch.float64, log=lambda line: None)
        reset_counts()
        s.file(os.path.join(d, "in.bb"))
        check_counts("BB-5k", read_counts(), {})
        check_rows_finite("BB-5k", s.thermo_rows, BB_COLS)
        bb_checks("BB-5k", d, s, BB_TWIN_STEPS, BB_TWIN_EVERY,
                  BB_TWIN_EVERY, 0, 1e-9)
        mine = {}
        for name in ("bb.local", "bb.xyz", "bb.cfg", "bb.dcd"):
            with open(os.path.join(d, name),
                      "rb" if name.endswith(".dcd") else "r") as fh:
                mine[name] = fh.read()
        rows_check = twin_check("BB-5k", run_state(s), BB_COLS)
        files_check = twin_files("BB-5k", mine)

        def bb_twin(twin, _rows=rows_check, _files=files_check):
            _rows(twin)
            _files(str(twin["root"]))

        defer_twin("BB-5k", d, "in.bb", BB_TWIN_STEPS, bb_twin, threads=4,
                   cost=60.0)
        del s
        torch.cuda.empty_cache()

        # BC: fix external through the library, float32 on the cell grid
        bc = os.path.join(work, "bc")
        os.makedirs(bc)
        got = {}
        for mode in ("plain", "callback", "spring", "array", "addforce"):
            logp = os.path.join(bc, f"log.{mode}")
            reset_counts()
            rows, calls, L = external_case(lj_scaled(LJ_SCRIPT, BC_SCALE),
                                           BC_STEPS, mode,
                                           log=logp)
            launches["BC" if mode == "callback" else f"BC-{mode}"] = \
                read_counts()
            route = script_route(L.lmp)
            L.close()
            with open(logp) as fh:
                rate = BC_STEPS / loop_seconds(fh.read().splitlines(),
                                               BC_STEPS)
            got[mode] = (rows, calls, rate, route)
            del L
            torch.cuda.empty_cache()
        for mode in ("plain", "callback", "spring", "array", "addforce"):
            lj = launches["BC" if mode == "callback"
                          else f"BC-{mode}"]["cell_pair_forces_lj"]
            if lj < BC_STEPS + 1:
                raise AssertionError(f"path BC {mode}: the LJ kernel "
                                     f"launched {lj} times")
        launches_bc = launches["BC"]
        check_counts("BC", launches_bc, {
            "cell_pair_forces_lj": launches_bc["cell_pair_forces_lj"]})
        calls = got["callback"][1]
        fired = sorted({s for s, _ in calls})
        moved = all(not np.array_equal(a, b) for (sa, a), (sb, b) in
                    zip(calls, calls[1:]) if sa != sb)
        if fired != list(range(BC_STEPS + 1)) or not moved:
            raise AssertionError(f"path BC: the callback fired on {fired}")
        cols = ("temp", "epair", "emol", "etotal", "press")
        w1 = rows_agree("BC", got["callback"][0], got["spring"][0],
                        [BC_REL] * len(got["spring"][0]), cols)
        w2 = rows_agree("BC-array", got["array"][0], got["addforce"][0],
                        [BC_REL] * len(got["addforce"][0]), cols)
        print(f"path BC: bench/in.lj through lidp_tpu_torch.api.lammps, "
              f"float32, {got['callback'][3]}; fix external pf/callback 1 1"
              f" with a numpy callback -{BC_K:g} minimum-image(x - x0): "
              f"{len(calls)} calls on steps 0-{BC_STEPS} (each step once, "
              f"the chunk's re-tally again), the positions changing "
              f"between calls; rows at {w1:.3g} of rel {BC_REL:g} of "
              f"max(1, |value|) of fix spring/self {BC_K:g}'s; pf/array "
              f"with the uniform {BC_FORCE} at {w2:.3g} of fix addforce's")
        print("path BC steps/s by the Loop time line over "
              f"{BC_STEPS} steps: " + ", ".join(
                  f"{m} {got[m][2]:.4f}" for m in got)
              + f"; the callback's host round trip "
              f"{1e3 / got['callback'][2] - 1e3 / got['plain'][2]:.3f} ms a "
              f"step over the plain run; {smi_line()}")
        print(f"steps_per_s_BC {got['callback'][2]:.4f} (Loop time; plain "
              f"in.lj {got['plain'][2]:.4f})")

        # BC-5k: the callback run at 5,324 atoms, float64 (the cell grid),
        # against its CPU twin through the library
        d = os.path.join(work, "bc-5k")
        os.makedirs(d)
        text = lj_scaled(LJ_SCRIPT, BC_TWIN_SCALE)
        with open(os.path.join(d, "in.bc"), "w") as fh:
            fh.write(text)
        reset_counts()
        rows, calls, L = external_case(text, BC_STEPS, "callback",
                                       dtype=torch.float64)
        check_counts("BC-5k", read_counts(), {})
        steps_5k = [s for s, _ in calls]
        if sorted(set(steps_5k)) != list(range(BC_STEPS + 1)):
            raise AssertionError(f"path BC-5k: the callback fired on "
                                 f"{steps_5k}")
        check = twin_check("BC-5k", run_state(L.lmp), cols)

        def bc_twin(twin, _check=check, _steps=steps_5k):
            _check(twin)
            if twin["calls"].tolist() != _steps:
                raise AssertionError("path BC-5k: the callback's steps "
                                     f"{twin['calls'].tolist()} vs {_steps}")
            print(f"path BC-5k: the twin's callback fired on the same "
                  f"{len(_steps)} steps")

        defer_twin("BC-5k", d, "in.bc", BC_STEPS, bc_twin, threads=4,
                   cost=40.0, code=EXTERNAL_TWIN)
        L.close()
        del L
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)


# phase 20: the rest of the modifier fixes and the integrator styles
# (fix_breadth_paths).  BD: in.lj with nve/limit then nve/noforce and the
# post_force, end_of_step and run-control fixes; BE: in.lj under fix
# deform (with compute temp/deform) and then press/berendsen; BF: the
# bead-spring chains with fix tmd, spring/chunk and restrain; BG:
# test_sphere_nh's spheres replicated, nvt/sphere, npt/sphere, nph/sphere;
# BH: a soft-sphere lattice under fix adapt.  Each at full size on the
# card, and its twin size in float64 on the card against its CPU twin.
BD_STEPS = 200                 # BD's first run, a row every 10
BD_NOFORCE = 20                # its nve/noforce run
BD_FIXES = """\
region\t\tslab block INF 2 INF INF INF INF
group\t\tcold region slab
region\t\thot block 3 5 INF INF INF INF
fix\t\t1 all nve/limit 0.05
fix\t\t2 cold drag 0.0 0.0 0.0 0.5 2.0
fix\t\t3 cold spring/rg 2.0 NULL
fix\t\t4 cold heat 10 50.0
fix\t\t5 all ehex 10 -50.0 region hot
fix\t\t6 all temp/csvr 1.44 1.44 1.0 4928
fix\t\t7 all store/force
compute\t\tfmax all reduce max f_7[1] f_7[2] f_7[3]
fix\t\t8 all halt 10 temp > 1000.0
fix\t\t9 all dt/reset 10 NULL 0.005 0.05 units box
thermo\t\t10
thermo_style\tcustom step temp epair etotal press dt c_fmax[1] c_fmax[2] c_fmax[3]
run\t\t${nstep}
unfix\t\t1
fix\t\t1 all nve/noforce
run\t\t%d
""" % BD_NOFORCE
BD_COLS = ("temp", "epair", "etotal", "press", "dt", "c_fmax[1]",
           "c_fmax[2]", "c_fmax[3]")
BE_STEPS = 100
BE_DEFORM = """\
fix\t\t2 all deform 1 x scale 1.05 y scale 1.05 z scale 1.05 remap x
compute\t\ttd all temp/deform
thermo\t\t10
thermo_style\tcustom step temp c_td epair press lx ly lz vol
run\t\t${nstep}
"""
BE_BERENDSEN = """\
fix\t\t2 all press/berendsen iso 0.0 0.0 10.0 modulus 50.0
thermo\t\t10
thermo_style\tcustom step temp epair press lx vol
run\t\t${nstep}
"""
BE_COLS = ("temp", "epair", "press", "lx", "vol")
BF_STEPS = 100
BF_SCRIPT = """\
units\t\tlj
atom_style\tbond
special_bonds\tfene
read_data\tdata.chain
neighbor\t0.4 bin
neigh_modify\tevery 1 delay 1
bond_style\tfene
bond_coeff\t1 30.0 1.5 1.0 1.0
pair_style\tlj/cut 1.12
pair_modify\tshift yes
pair_coeff\t1 1 1.0 1.0 1.12
timestep\t0.005
compute\t\tcm all chunk/atom molecule
compute\t\tcomc all com/chunk cm
fix\t\t1 all nve
fix\t\t2 all spring/chunk 5.0 cm comc
fix\t\t3 all restrain bond 1 50 10.0 20.0 1.5 angle 101 102 103 5.0 8.0 \
100.0 dihedral 201 202 203 204 2.0 4.0 60.0
fix\t\t4 all tmd 0.1 target.tmd 10 tmd.out
thermo\t\t10
thermo_style\tcustom step temp epair emol etotal press
run\t\t${nstep}
"""
BF_COLS = ("temp", "epair", "emol", "etotal", "press")
BF_TWIN_CHAINS = 54            # BF-5k: 5,400 beads (the cell grid)
BG_STEPS = 50                  # each of BG's three runs
BG_REPLICA = 10                # 8 x 10^3 = 8,000 spheres
BG_TWIN_REPLICA = 5            # BG-1k: 1,000 (the dense route)
BG_SCRIPT = """\
units\t\tlj
atom_style\tsphere
boundary\tp p p
read_data\tdata.sph
pair_style\tlj/cut 2.5
pair_coeff\t1 1 1.0 1.0
neighbor\t0.3 bin
thermo\t\t10
thermo_style\tcustom step temp press vol
fix\t\t1 all nvt/sphere temp 0.2 0.2 0.5
run\t\t${nstep}
unfix\t\t1
fix\t\t1 all npt/sphere temp 1.0 1.0 0.5 iso 0.0003 0.0003 5.0
run\t\t${nstep}
unfix\t\t1
fix\t\t1 all nph/sphere iso 0.0003 0.0003 5.0
run\t\t${nstep}
"""
BG_COLS = ("temp", "press", "vol")
BH_STEPS = 50
BH_SCRIPT = """\
variable\tx index 1
variable\txx equal 20*$x
units\t\tlj
atom_style\tatomic
lattice\t\tfcc 0.8442
region\t\tbox block 0 ${xx} 0 ${xx} 0 ${xx}
create_box\t1 box
create_atoms\t1 box
mass\t\t1 1.0
velocity\tall create 1.0 4928 loop geom
pair_style\tsoft 1.12246
pair_coeff\t* * 0.0
variable\tprefactor equal ramp(0.0,30.0)
fix\t\t1 all nve
fix\t\t2 all adapt 1 pair soft a * * v_prefactor
thermo\t\t10
thermo_style\tcustom step temp epair press v_prefactor
run\t\t${nstep}
"""
BH_COLS = ("temp", "epair", "press", "v_prefactor")
BREADTH_TWIN_STEPS = 10        # the twins' runs


def sphere_case(directory, replica):
    """tests/test_sphere_nh's eight spheres (its DATA's rows) replicated
    replica^3 times in a box of replica x 10 a side, as data.sph."""
    base = [(1.0, 1.0, 1.0), (6.0, 1.0, 1.0), (1.0, 6.0, 1.0),
            (1.0, 1.0, 6.0), (6.0, 6.0, 1.0), (6.0, 1.0, 6.0),
            (1.0, 6.0, 6.0), (6.0, 6.0, 6.0)]
    vel = [(0.1, 0.0, 0.0, 0.0, 0.0, 0.1), (-0.1, 0.1, 0.0, 0.1, 0.0, 0.0),
           (0.0, -0.1, 0.1, 0.0, 0.1, 0.0), (0.1, 0.0, -0.1, 0.0, 0.0, -0.1),
           (-0.1, -0.1, 0.0, -0.1, 0.0, 0.0), (0.0, 0.1, 0.1, 0.0, -0.1, 0.0),
           (0.1, 0.1, -0.1, 0.1, 0.1, 0.0), (-0.1, 0.0, 0.1, 0.0, 0.0, 0.1)]
    atoms, vels = [], []
    for iz in range(replica):
        for iy in range(replica):
            for ix in range(replica):
                for (x, y, z), w in zip(base, vel):
                    k = len(atoms) + 1
                    atoms.append(f"{k} 1 2.0 1.2 {x + 10 * ix!r} "
                                 f"{y + 10 * iy!r} {z + 10 * iz!r}")
                    vels.append(f"{k} " + " ".join(repr(c) for c in w))
    L = 10.0 * replica
    lines = ["spheres", "", f"{len(atoms)} atoms", "1 atom types", ""]
    lines += [f"0 {L!r} {a}lo {a}hi" for a in "xyz"]
    lines += ["", "Atoms", ""] + atoms + ["", "Velocities", ""] + vels
    with open(os.path.join(directory, "data.sph"), "w") as fh:
        fh.write("\n".join(lines) + "\n")


def tmd_target(directory, seed=11):
    """fix tmd's target for data.chain: each bead's position jittered by
    up to +-0.3 sigma from the seed, as target.tmd (id x y z)."""
    import numpy as np

    with open(os.path.join(directory, "data.chain")) as fh:
        lines = fh.read().splitlines()
    i = lines.index("Atoms # bond") + 2
    rows = []
    while lines[i].strip():
        w = lines[i].split()
        rows.append((int(w[0]), float(w[3]), float(w[4]), float(w[5])))
        i += 1
    x = np.array([r[1:] for r in rows])
    x = x + np.random.default_rng(seed).uniform(-0.3, 0.3, x.shape)
    with open(os.path.join(directory, "target.tmd"), "w") as fh:
        for (k, *_), p in zip(rows, x):
            fh.write(f"{k} {float(p[0])!r} {float(p[1])!r} "
                     f"{float(p[2])!r}\n")


def breadth_case(path, work, name, text, dtype, steps):
    """`text` through LammpsScript on the card in `dtype` with
    ${nstep} = steps: (script, log lines, peak memory); prints the route
    and the log."""
    import torch

    from lidp_tpu_torch.io.script import LammpsScript

    with open(os.path.join(work, name), "w") as fh:
        fh.write(text)
    logs = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    script = LammpsScript(dtype=dtype, log=logs.append)
    script.variables["nstep"] = str(steps)
    script.file(os.path.join(work, name))
    peak = torch.cuda.max_memory_allocated()
    print(f"path {path}: {script._sim.natoms} atoms, {dtype}, "
          f"{script_route(script)}; its log:")
    for line in logs:
        print(f"  {path}| {line}")
    return script, logs, peak


def breadth_twin(path, work, name, text, cols, threads, cost,
                 reset_counts, read_counts):
    """Path's twin size: `text` in float64 on the card for
    BREADTH_TWIN_STEPS (the plain routes: no kernel launches), its rows
    finite, and its CPU twin deferred (rows within rel 1e-9, the final x
    and v within 1e-8)."""
    import torch

    reset_counts()
    s, _, _ = breadth_case(path, work, name, text, torch.float64,
                           BREADTH_TWIN_STEPS)
    check_counts(path, read_counts(), {})
    check_rows_finite(path, s.thermo_rows, cols)
    defer_twin(path, work, name, BREADTH_TWIN_STEPS,
               twin_check(path, run_state(s), cols), threads=threads,
               cost=cost)
    del s
    torch.cuda.empty_cache()


def lj_breadth(scale, tail):
    """in.lj at `scale` with its fix nve and run replaced by `tail`."""
    text = lj_scaled(LJ_SCRIPT, scale)
    return text[:text.index("fix\t\t1 all nve")] + tail


def fix_breadth_paths(launches, reset_counts, read_counts):
    """Paths BD-BH and their twins BD-5k, BE-5k, BE-ber-5k, BF-5k, BG-1k
    and BH-5k (module docstring)."""
    import torch

    from lidp_tpu_torch import threefry

    work = tempfile.mkdtemp(prefix="chip_smoke_breadth_")
    try:
        # BD: in.lj, float32, the LJ kernel, every modifier on top
        bd = os.path.join(work, "bd")
        os.makedirs(bd)
        tries = []
        orig = threefry.gamma_draw

        def counted(*a, **k):
            out = orig(*a, **k)
            tries.append(out[1])
            return out

        threefry.gamma_draw = counted
        try:
            reset_counts()
            s, log, peak = breadth_case("BD", bd, "in.bd",
                                        lj_breadth("1", BD_FIXES),
                                        torch.float32, BD_STEPS)
            launches["BD"] = read_counts()
        finally:
            threefry.gamma_draw = orig
        lj = launches["BD"]["cell_pair_forces_lj"]
        check_counts("BD", launches["BD"], {"cell_pair_forces_lj": lj})
        rows = s.thermo_rows
        nrows = BD_STEPS // 10 + 1 + BD_NOFORCE // 10 + 1
        if lj < BD_STEPS + BD_NOFORCE + 2 or len(rows) != nrows \
                or int(s.step) != BD_STEPS + BD_NOFORCE:
            raise AssertionError(f"path BD: {len(rows)} rows to step "
                                 f"{s.step}, launches {launches['BD']}")
        check_rows_finite("BD", rows, BD_COLS)
        print(f"path BD: temp/csvr's gamma draws {len(tries)}, their tries "
              f"{sum(tries)} (at most {max(tries)} in one draw); dt "
              f"{rows[0]['dt']:.6g} at step 0, {rows[-1]['dt']:.6g} at the "
              f"end; halt (temp > 1000) never met")
        script_peak("BD", log, BD_STEPS, peak)
        del s
        torch.cuda.empty_cache()
        breadth_twin("BD-5k", bd, "in.bd-5k",
                     lj_breadth(BB_TWIN_SCALE, BD_FIXES), BD_COLS, 4, 60.0,
                     reset_counts, read_counts)

        # BE: in.lj under fix deform, then under press/berendsen
        be = os.path.join(work, "be")
        os.makedirs(be)
        for tag, tail in (("BE", BE_DEFORM), ("BE-ber", BE_BERENDSEN)):
            reset_counts()
            s, log, peak = breadth_case(
                tag, be, f"in.{tag}", lj_breadth(
                    "1", "fix\t\t1 all nve\n" + tail), torch.float32,
                BE_STEPS)
            launches[tag] = read_counts()
            lj = launches[tag]["cell_pair_forces_lj"]
            check_counts(tag, launches[tag], {"cell_pair_forces_lj": lj})
            rows = s.thermo_rows
            check_rows_finite(tag, rows, BE_COLS)
            L0 = (4 / 0.8442) ** (1 / 3) * 20
            if lj < BE_STEPS + 1 or len(rows) != BE_STEPS // 10 + 1:
                raise AssertionError(f"path {tag}: launches {lj}, "
                                     f"{len(rows)} rows")
            if tag == "BE":
                check_rel("BE lx at the last row", rows[-1]["lx"],
                          1.05 * L0, 1e-5)
                print(f"path BE: temp/deform {rows[-1]['c_td']:.6g} against "
                      f"temp {rows[-1]['temp']:.6g} at the last row")
            elif abs(rows[-1]["lx"] - L0) < 1e-6 * L0:
                raise AssertionError("path BE-ber: the box did not move")
            else:
                print(f"path BE-ber: lx {rows[0]['lx']:.6g} -> "
                      f"{rows[-1]['lx']:.6g}, press {rows[0]['press']:.4g}"
                      f" -> {rows[-1]['press']:.4g}")
            script_peak(tag, log, BE_STEPS, peak)
            del s
            torch.cuda.empty_cache()
            breadth_twin(f"{tag}-5k", be, f"in.{tag}-5k", lj_breadth(
                BB_TWIN_SCALE, "fix\t\t1 all nve\n" + tail), BE_COLS, 2,
                40.0, reset_counts, read_counts)

        # BF: the chains with tmd, spring/chunk and restrain
        for tag, chains in (("BF", 320), ("BF-5k", BF_TWIN_CHAINS)):
            d = os.path.join(work, tag.lower())
            os.makedirs(d)
            chain_script_case(d, n_chains=chains, n_beads=100)
            tmd_target(d)
            if tag == "BF":
                reset_counts()
                s, log, peak = breadth_case("BF", d, "in.bf", BF_SCRIPT,
                                            torch.float32, BF_STEPS)
                launches["BF"] = read_counts()
                check_counts("BF", launches["BF"], {})
                check_rows_finite("BF", s.thermo_rows, BF_COLS)
                with open(os.path.join(d, "tmd.out")) as fh:
                    stat = fh.read().splitlines()
                if len(stat) != BF_STEPS // 10 + 1:
                    raise AssertionError(f"path BF: tmd.out {stat}")
                print(f"path BF: tmd.out's last row: {stat[-1]}")
                script_peak("BF", log, BF_STEPS, peak)
                del s
                torch.cuda.empty_cache()
            else:
                breadth_twin(tag, d, "in.bf", BF_SCRIPT, BF_COLS, 2, 40.0,
                             reset_counts, read_counts)

        # BG: the point spheres, three Nose-Hoover styles
        for tag, rep in (("BG", BG_REPLICA), ("BG-1k", BG_TWIN_REPLICA)):
            d = os.path.join(work, tag.lower())
            os.makedirs(d)
            sphere_case(d, rep)
            if tag == "BG":
                reset_counts()
                s, log, peak = breadth_case("BG", d, "in.bg", BG_SCRIPT,
                                            torch.float32, BG_STEPS)
                launches["BG"] = read_counts()
                lj = launches["BG"]["cell_pair_forces_lj"]
                check_counts("BG", launches["BG"],
                             {"cell_pair_forces_lj": lj})
                rows = s.thermo_rows
                check_rows_finite("BG", rows, BG_COLS)
                if lj < 3 * BG_STEPS + 1 or len(rows) != 3 * (
                        BG_STEPS // 10 + 1):
                    raise AssertionError(f"path BG: launches {lj}, "
                                         f"{len(rows)} rows")
                print(f"path BG: vol {rows[0]['vol']:.8g} -> "
                      f"{rows[-1]['vol']:.8g} over the three runs")
                script_peak("BG", log, BG_STEPS, peak)
                del s
                torch.cuda.empty_cache()
            else:
                breadth_twin(tag, d, "in.bg", BG_SCRIPT, BG_COLS, 1, 20.0,
                             reset_counts, read_counts)

        # BH: the soft-sphere lattice under fix adapt, float64
        bh = os.path.join(work, "bh")
        os.makedirs(bh)
        reset_counts()
        s, log, peak = breadth_case("BH", bh, "in.bh", BH_SCRIPT,
                                    torch.float64, BH_STEPS)
        launches["BH"] = read_counts()
        check_counts("BH", launches["BH"], {})
        rows = s.thermo_rows
        check_rows_finite("BH", rows, BH_COLS)
        if rows[-1]["v_prefactor"] != 30.0 or not rows[-1]["epair"] > 0:
            raise AssertionError(f"path BH: the last row {rows[-1]}")
        script_peak("BH", log, BH_STEPS, peak)
        del s
        torch.cuda.empty_cache()
        breadth_twin("BH-5k", bh, "in.bh-5k", BH_SCRIPT.replace(
            "variable\tx index 1", f"variable\tx index {BB_TWIN_SCALE}"),
            BH_COLS, 2, 40.0, reset_counts, read_counts)
    finally:
        shutil.rmtree(work, ignore_errors=True)


FE_SCALE = "1"                 # BI and BJ: in.lj at 32,000 atoms
BI_STEPS = 100                 # BI: in.lj with restart 50 rs.a rs.b
BI_TAIL = """\
fix\t\t1 all nve
balance\t\t1.0 shift x 5 1.0
info\t\tsystem
timer\t\tfull
restart\t\t{every} rs.a rs.b
thermo\t\t10
run\t\t${{nstep}}
"""
BI_RESUME = """\
fix\t\t1 all nve
read_restart\trs.a
thermo\t\t10
run\t\t{steps}
"""
BI_COLS = ("temp", "epair", "etotal", "press")
# the resumed rows against the run's: float32, and the resumed run builds
# its cell grid at step 50, where the run had built it at step 40
BI_RESUME_REL = 1e-4
BJ_STEPS = 50                  # BJ: each of its runs
BJ_TAIL = """\
fix\t\t1 all nve
thermo\t\t10
run\t\t${nstep}
change_box\tall x scale 1.05 y delta -0.5 0.5 remap units box
reset_timestep\t0
write_data\tbj.data
run\t\t${nstep}
"""
BJ_FRESH = """\
units\t\tlj
atom_style\tatomic
read_data\tbj.data
pair_style\tlj/cut 2.5
pair_coeff\t1 1 1.0 1.0 2.5
neighbor\t0.3 bin
neigh_modify\tdelay 0 every 20 check no
fix\t\t1 all nve
thermo\t\t10
run\t\t${nstep}
"""
BJ_REL = 1e-5                  # the changed run against the fresh one
BK_MOLECULES = (25, 20, 20)    # BK: 10,000 waters, 30,000 atoms
BK_TWIN = 12                   # BK-1.7k: 1,728 waters, 5,184 atoms
BK_COLS = ("temp", "pe", "ebond", "eangle", "ecoul", "elong", "press")
BL_SCALE = "2"                 # BL: in.lj at 2, 256,000 atoms
BL_STEPS = 20
BL_SCRIPT = """\
units\t\tlj
atom_style\tatomic
read_data\tbl.data
pair_style\tlj/cut 2.5
pair_coeff\t1 1 1.0 1.0 2.5
neighbor\t0.3 bin
neigh_modify\tdelay 0 every 20 check no
fix\t\t1 all nve
dump\t\t1 all custom 10 bl.dump id type x y z vx vy vz
thermo\t\t10
run\t\t${nstep}
"""


def loop_rate(log):
    """steps/s over every Loop time line of a log (a restart-segmented run
    prints one a chunk)."""
    secs = steps = 0.0
    for line in log:
        if line.startswith("Loop time"):
            w = line.split()
            secs += float(w[3])
            steps += int(w[8])
    return steps / secs


def lj_data(path, scale):
    """in.lj's lattice at `scale` with its velocities, written by the
    port's write_data as `path` (atom_style atomic); returns the atoms."""
    from lidp_tpu_torch.io.script import LammpsScript

    s = LammpsScript(device="cpu", log=lambda line: None)
    s.root = os.path.dirname(path)
    text = lj_scaled(LJ_SCRIPT, scale)
    s.execute(text[:text.index("pair_style")].splitlines())
    s.one(f"write_data {os.path.basename(path)}")
    return len(s.x)


def bi_path(work, launches, reset_counts, read_counts):
    """BI: balance, info, timer full and restart 50 over in.lj, the file
    against the state, then a second script resumed from rs.a."""
    import numpy as np
    import torch

    from lidp_tpu_torch.utils import checkpoint

    reset_counts()
    s, log, peak = breadth_case(
        "BI", work, "in.bi", lj_breadth(FE_SCALE, BI_TAIL.format(every=50)),
        torch.float32, BI_STEPS)
    launches["BI"] = read_counts()
    lj = launches["BI"]["cell_pair_forces_lj"]
    check_counts("BI", launches["BI"], {"cell_pair_forces_lj": lj})
    rows = s.thermo_rows
    if lj < BI_STEPS + 1 or [r["step"] for r in rows] != list(
            range(0, BI_STEPS + 1, 10)):
        raise AssertionError(f"path BI: launches {lj}, rows at "
                             f"{[r['step'] for r in rows]}")
    check_rows_finite("BI", rows, BI_COLS)
    print("path BI: timer full's ms an evaluation (CUDA events): "
          + ", ".join(f"{k} {v * 1e3:.4f}"
                      for k, v in s._sim.timer_breakdown.items()))
    written = checkpoint.flatten_state(s._sim.sys, s._sim.istate)
    read = checkpoint.load_checkpoint(os.path.join(work, "rs.b"))
    if sorted(written) != sorted(read) or not all(
            v.dtype == read[k].dtype and np.array_equal(v, read[k])
            for k, v in written.items()):
        raise AssertionError("path BI: rs.b is not the state written")
    print(f"path BI: rs.b equals the state at step {BI_STEPS} bit for bit "
          f"({len(read)} arrays); steps_per_s_BI {loop_rate(log):.4f} (Loop "
          f"time, two chunks); peak device memory {peak / 2**20:.1f} MiB; "
          f"{smi_line()}")
    first = {int(r["step"]): r for r in rows}
    del s
    torch.cuda.empty_cache()
    half = BI_STEPS // 2
    reset_counts()
    r, log, peak = breadth_case(
        "BI-resume", work, "in.bi-resume",
        lj_breadth(FE_SCALE, BI_RESUME.format(steps=half)), torch.float32,
        half)
    launches["BI-resume"] = read_counts()
    lj = launches["BI-resume"]["cell_pair_forces_lj"]
    check_counts("BI-resume", launches["BI-resume"],
                 {"cell_pair_forces_lj": lj})
    resumed = r.thermo_rows
    if [int(x["step"]) for x in resumed] != list(
            range(half, BI_STEPS + 1, 10)) or lj < half + 1:
        raise AssertionError(f"path BI-resume: launches {lj}, rows "
                             f"{[x['step'] for x in resumed]}")
    worst = rows_agree("BI-resume", resumed,
                       [first[int(x["step"])] for x in resumed],
                       [BI_RESUME_REL] * len(resumed), BI_COLS)
    print(f"path BI-resume: rows {half}-{BI_STEPS} at {worst:.3g} of their "
          f"bar (rel {BI_RESUME_REL:g}) against the uninterrupted run's")
    script_peak("BI-resume", log, half, peak)
    del r
    torch.cuda.empty_cache()
    breadth_twin("BI-5k", work, "in.bi-5k", lj_breadth(
        BB_TWIN_SCALE, BI_TAIL.format(every=5)), BI_COLS, 2, 40.0,
        reset_counts, read_counts)


def bj_path(work, launches, reset_counts, read_counts):
    """BJ: change_box between two runs of in.lj, held to a fresh script
    from its write_data; then clear and a second in.lj in this
    process."""
    import torch

    reset_counts()
    s, log, peak = breadth_case("BJ", work, "in.bj",
                                lj_breadth(FE_SCALE, BJ_TAIL), torch.float32,
                                BJ_STEPS)
    rows = s.thermo_rows
    nrow = BJ_STEPS // 10 + 1
    if len(rows) != 2 * nrow:
        raise AssertionError(f"path BJ: {len(rows)} rows")
    check_rows_finite("BJ", rows, BI_COLS)
    box = s._sim.sys.box
    L0 = (4 / 0.8442) ** (1 / 3) * 20 * float(FE_SCALE)
    check_rel("BJ lx after change_box", float(box.hi[0] - box.lo[0]),
              1.05 * L0, 1e-6)
    check_rel("BJ ly after change_box", float(box.hi[1] - box.lo[1]),
              L0 + 1.0, 1e-6)
    fresh, _, _ = breadth_case("BJ-fresh", work, "in.bj-fresh", BJ_FRESH,
                               torch.float32, BJ_STEPS)
    worst = rows_agree("BJ", rows[nrow:], fresh.thermo_rows,
                       [BJ_REL] * nrow, BI_COLS)
    print(f"path BJ: the rows after change_box at {worst:.3g} of their bar "
          f"(rel {BJ_REL:g}) against a fresh script from its write_data")
    del fresh
    before = torch.cuda.memory_allocated()
    s.one("clear")
    after = torch.cuda.memory_allocated()
    print(f"path BJ: peak device memory {peak / 2**20:.1f} MiB over its "
          f"runs; allocated {before / 2**20:.1f} MiB before clear, "
          f"{after / 2**20:.1f} MiB after; {smi_line()}")
    torch.cuda.reset_peak_memory_stats()
    log2 = []
    s.log = log2.append
    s.variables["nstep"] = str(BJ_STEPS)
    s.execute(lj_breadth(FE_SCALE, BJ_TAIL[:BJ_TAIL.index("change_box")])
              .splitlines())
    peak2 = torch.cuda.max_memory_allocated()
    launches["BJ"] = read_counts()
    lj = launches["BJ"]["cell_pair_forces_lj"]
    check_counts("BJ", launches["BJ"], {"cell_pair_forces_lj": lj})
    if lj < 4 * (BJ_STEPS + 1):
        raise AssertionError(f"path BJ: launches {lj}")
    worst = rows_agree("BJ-clear", s.thermo_rows, rows[:nrow],
                       [BJ_REL] * nrow, BI_COLS)
    print(f"path BJ-clear: the second system's rows at {worst:.3g} of their "
          f"bar against the first run's; peak device memory "
          f"{peak2 / 2**20:.1f} MiB after clear")
    script_peak("BJ", log2, BJ_STEPS, peak2)
    del s
    torch.cuda.empty_cache()
    twin = lj_breadth(BB_TWIN_SCALE, BJ_TAIL) + "clear\n" + lj_scaled(
        LJ_SCRIPT, BB_TWIN_SCALE).replace("run\t\t100", "run\t\t10")
    breadth_twin("BJ-5k", work, "in.bj-5k", twin, BI_COLS, 2, 40.0,
                 reset_counts, read_counts)


def bk_path(work, launches, reset_counts, read_counts):
    """BK: the water template at 10,000 molecules, float64, then
    delete_bonds and a run 0."""
    import numpy as np
    import torch

    with open(os.path.join(work, "wat.mol"), "w") as fh:
        fh.write(WATER_MOL)
    reset_counts()
    s, log, peak = breadth_case("BK", work, "in.bk",
                                water_script(*BK_MOLECULES), torch.float64, 4)
    launches["BK"] = read_counts()
    check_counts("BK", launches["BK"], {})
    rows = s.thermo_rows
    nmol = int(np.prod(BK_MOLECULES))
    check_rows_finite("BK", rows, BK_COLS)
    if (s._sim.natoms != 3 * nmol or len(s._bonds) != 2 * nmol
            or len(s._angles) != nmol or len(rows) != 4
            or rows[-1]["eangle"] != 0.0 or rows[2]["eangle"] == 0.0):
        raise AssertionError(f"path BK: {s._sim.natoms} atoms, rows {rows}")
    print(f"path BK: {nmol} molecules, {len(s._bonds)} bonds, "
          f"{len(s._angles)} angles ({int((s._angle_types < 0).sum())} "
          f"turned off by delete_bonds); E_angle {rows[2]['eangle']:.6g} -> "
          f"{rows[3]['eangle']:.6g}; {script_route(s)}")
    print(f"steps_per_s_BK {4 / loop_seconds(log, 4):.4f} (Loop time); "
          f"peak device memory {peak / 2**20:.1f} MiB; {smi_line()}")
    del s
    torch.cuda.empty_cache()
    breadth_twin("BK-1.7k", work, "in.bk-1.7k", water_script(BK_TWIN),
                 BK_COLS, 4, 60.0, reset_counts, read_counts)


def bl_path(work, launches, reset_counts, read_counts):
    """BL: a 256,000-atom in.lj data file through read_data's C++ and
    Python parses, then 20 steps with dump custom every 10, a frame's rows
    through the C++ and Python formatters."""
    import numpy as np
    import torch

    from lidp_tpu_torch import native
    from lidp_tpu_torch.io import dump as dump_mod
    from lidp_tpu_torch.io.data_reader import read_data

    path = os.path.join(work, "bl.data")
    t0 = time.perf_counter()
    n = lj_data(path, BL_SCALE)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.library()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    dn = read_data(path, "atomic", native=True)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    dp = read_data(path, "atomic", native=False)
    t_python = time.perf_counter() - t0
    for f in ("x", "type", "image", "v", "q", "mol"):
        if not np.array_equal(getattr(dn, f), getattr(dp, f)):
            raise AssertionError(f"path BL: the parses' {f} differ")
    print(f"path BL: {n} atoms written by write_data in {t_write:.2f} s; "
          f"read_data {t_native:.3f} s with the C++ Atoms parse, "
          f"{t_python:.3f} s with the Python one (equal arrays; the library "
          f"loaded or built in {t_build:.2f} s)")
    del dn, dp
    frames = []
    plain = dump_mod.format_rows

    def kept(vals, flags, ffmt="%g"):
        t = time.perf_counter()
        out = plain(vals, flags, ffmt)
        frames.append((vals, flags, time.perf_counter() - t))
        return out

    dump_mod.format_rows = kept
    try:
        reset_counts()
        s, log, peak = breadth_case("BL", work, "in.bl", BL_SCRIPT,
                                    torch.float32, BL_STEPS)
        launches["BL"] = read_counts()
    finally:
        dump_mod.format_rows = plain
    lj = launches["BL"]["cell_pair_forces_lj"]
    check_counts("BL", launches["BL"], {"cell_pair_forces_lj": lj})
    check_rows_finite("BL", s.thermo_rows, BI_COLS)
    if lj < BL_STEPS + 1 or len(frames) != BL_STEPS // 10 + 1:
        raise AssertionError(f"path BL: launches {lj}, {len(frames)} frames")
    with open(os.path.join(work, "bl.dump"), "rb") as fh:
        nlines = sum(1 for _ in fh)
    if nlines != len(frames) * (9 + n):
        raise AssertionError(f"path BL: bl.dump has {nlines} lines")
    vals, flags, _ = frames[-1]
    t0 = time.perf_counter()
    text_py = plain(vals, flags, native=False)
    t_py = time.perf_counter() - t0
    t0 = time.perf_counter()
    text_nat = plain(vals, flags)
    t_nat = time.perf_counter() - t0
    if text_py != text_nat:
        raise AssertionError("path BL: the formatters' rows differ")
    print(f"path BL: a {vals.shape[0]}-row dump frame formatted in "
          f"{t_nat:.3f} s by the C++ rows, {t_py:.3f} s by the Python loop "
          f"(the same {len(text_nat)} bytes); the run's frames "
          + ", ".join(f"{f[2]:.3f}" for f in frames) + " s")
    script_peak("BL", log, BL_STEPS, peak)
    del s, frames
    torch.cuda.empty_cache()
    twin = os.path.join(work, "twin")
    os.makedirs(twin)
    lj_data(os.path.join(twin, "bl.data"), BB_TWIN_SCALE)
    breadth_twin("BL-5k", twin, "in.bl-5k", BL_SCRIPT, BI_COLS, 2, 30.0,
                 reset_counts, read_counts)


def front_end_paths(launches, reset_counts, read_counts):
    """Paths BI-BL and their twins BI-5k, BJ-5k, BK-1.7k and BL-5k
    (module docstring)."""
    work = tempfile.mkdtemp(prefix="chip_smoke_front_end_")
    try:
        for tag, path in (("bi", bi_path), ("bj", bj_path), ("bk", bk_path),
                          ("bl", bl_path)):
            d = os.path.join(work, tag)
            os.makedirs(d)
            path(d, launches, reset_counts, read_counts)
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

    t_start = time.perf_counter()
    t_last = [t_start]

    def mark(label):
        """Print the wall time the script has taken so far and since the
        last mark (the run must end within 1,200 s, the build included)."""
        now = time.perf_counter()
        print(f"wall: {label} done at {now - t_start:.1f} s "
              f"({now - t_last[0]:.1f} s)")
        t_last[0] = now

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
    mark("build")

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

    mark("kernel parity")

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

    mark("paths A-H32")
    rowsI = dense_paths(launches, reset_counts, read_counts)
    mark("dense_paths")
    thermostat_paths(launches, reset_counts, read_counts, rowsI)
    mark("thermostat_paths")

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

    mark("paths E, F, E4")
    script_cell_paths(launches, reset_counts, read_counts, steps_per_s_F)
    mark("script_cell_paths")
    for phase in (barostat_paths, flexible_paths, chain_paths,
                  modifier_paths, eam_paths, minimize_paths,
                  nonperiodic_paths):
        phase(launches, reset_counts, read_counts)
        mark(phase.__name__)
    compute_paths(launches, reset_counts, read_counts, rowsH32,
                  launches["G"])
    mark("compute_paths")
    # phases 19 and 20 before 15-18: their twins are among the costliest
    # (BA-1k, BB-5k, BC-5k, BD-5k), and the last phase's twins are the
    # ones left to run once the card is done
    for phase in (kspace_paths, output_paths, fix_breadth_paths,
                  front_end_paths, pair_style_paths, charmm_family_paths,
                  chunk_structure_paths, granular_paths):
        phase(launches, reset_counts, read_counts)
        mark(phase.__name__)
    run_twins()
    mark("run_twins")

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
