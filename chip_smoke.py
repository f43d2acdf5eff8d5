#!/usr/bin/env python3
"""Smoke test of the paropt_torch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero without the final line).
Phases 1-3b run in this process alone; then phases 4-38 run in seven
child processes of this script at once, all on the one card, each a
group of phases in order (GROUPS: a phase and the later ones that read
its results share a group).  Each group's output is printed whole once
all have ended, with each phase's end on the script's clock; a group that
fails, or is still running DEADLINE_S seconds after the start, ends every
group and fails the script.  The card is mostly idle in these phases (the
host's Python paces them), so their seconds per iteration are taken
beside six other processes on the same card and host:


1. device: a CUDA card must be present; prints nvidia-smi's name and power
   limit, turns TF32 off and checks it;
2. build: compiles the CUDA kernels from paropt_torch/csrc with nvcc, and
   the host sparse Cholesky from src_native/ with g++;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes and at ragged sizes (phi_gram as the factor setup
   calls it: the stack as two row blocks, bw = 0; qn_roll_update also at
   the eigen TR's n = 65,536 and 288 of phases 26 and 27 and at phase 29's
   n = 8,188), and two runs of each
   quasi-definite kernel bitwise equal.  At the main path's shapes in
   float32: the device time of kernel and plain version (CUDA events,
   median of 20 runs after warm-up, L2 flushed), the bound (the bytes the
   function moves over 3.35 TB/s or its float32 operations over
   67 TFLOP/s, whichever is larger) and the share of it reached, with
   nvidia-smi's SM clock, power draw and power limit sampled after each;
   phi_gram must beat its unfused yardstick (quasi_def_apply at K = 21 plus
   torch.mm for the Gram matrix), timed beside it;
3b. kernels with the instance axis (k solves run as one): each kernel's
   instance-axis launch at kb = 4 over the main path's shapes in float32
   (the apply at K = 1 and phi_gram as the factor setup calls it, vals
   shared by the instances with stride 0) against the plain version
   batched, bit for bit against 4 single launches, and at kb = 1 bit for
   bit against the single launch; the device time of the instance-axis
   launch, of 4 single launches and of the plain version batched, and the
   bound (4 times the single call's bytes); phi_gram also at phase 22's
   shape (kb = 32 instances of nwcon = 512, vals shared), against the
   plain version batched and bit for bit against 32 single launches, with
   the time of the instance-axis launch and of the 32 single launches;
4. slice: the fused interior-point solve of SyntheticTopology at n = 2^20
   in float32 (in-loop L-BFGS, msub 10, abs_res_tol 1e-6, no refinement),
   which must converge and must launch every kernel;
5. cross-check: the same solve at n = 2^14 in float64 on the card (kernels)
   and on the host (plain versions) must agree in iteration count and
   objective;
6. MMA at full width: FusedMMA (default options, 10 outer iterations,
   cut from 20 to keep the whole script inside its time limit) on
   FEMTopology(768, 384, cg_iters=25, solver="mgcg"), 294,912 design
   variables and 592,130 dofs, in float32 and then in float64.  Each run
   prints its iterations, final fobj, infeasibility, l1, linf, seconds per
   outer iteration and peak memory, and one further outer iteration under
   torch.profiler: device kernels and busy share, split by the
   paropt.fem.solve, paropt.mma.eval and paropt.mma.inner_ip ranges.
   Checks: finite, fobj < 0.5 of the start, infeasibility < 1e-6, no host
   sync inside one FEM solve (torch.cuda.set_sync_debug_mode("error")),
   and no kernel of phase 3 on the path.  The relative residual
   ||K u - f|| / ||f|| of the final state solve must be < 1e-5 in float64;
   in float32 it is printed beside its floor, the residual of the float64
   solution rounded to float32 (~6e-4 at this mesh: no float32 solve can
   reach 1e-5 here), with the float32 compliance's error against float64;
7. the bench configuration: FusedMMA on FEMTopology(96, 48, cg_iters=25,
   solver="mgcg"), float32, 60 outer iterations; fobj must fall in
   bench.py's band (0.10, 0.18) with infeasibility < 1e-8.  The run, in
   windows of 10 outer iterations (chunk=10), writes its full state every
   10 (checkpoint_path) and keeps each file, for phase 34;
8. card against host in float64: FusedMMA on FEMTopology(24, 12, mgcg,
   cg_iters 25) for 10 outer iterations and on DMOFEMTopology(12, 6,
   cg_iters 120) for 8 (cut from 20 and 15), once with CUDA tensors and
   once on the CPU: the
   same outer and inner iteration counts, fobj within 1e-9 relative;
9. TR at full width: FusedTR (bench.py's TR options: 20 outer iterations,
   abs_res_tol 1e-6, tr_infeas_tol 1e-5, tr_l1_tol 0, tr_linfty_tol 1e-5;
   L-BFGS msub 10) on SyntheticTopology(n = 2^20) in float32.  It must
   converge with infeasibility and linf below 1e-5, a finite x and fobj
   below its start, and must launch every kernel; it prints the outer and
   inner iterations, seconds and host reads per outer iteration, peak
   memory, and one further outer iteration under torch.profiler split by
   the paropt.tr.steer, paropt.tr.qp, paropt.tr.eval and
   paropt.tr.qn_update ranges;
10. bench.py's TR configuration: FusedTR on FEMTopology(48, 24,
   cg_iters=25, solver="mgcg"), float32, 20 outer iterations; fobj must
   fall in bench.py's band (0.18, 0.30) with infeasibility < 1e-6, and of
   the kernels only the outer QN update's may launch (nwcon = 0);
11. card against host in float64: FusedTR on SyntheticTopology(n = 2^14)
   and on FEMTopology(12, 6, mgcg, cg_iters 25), 6 outer iterations each
   (cut from 10),
   once with CUDA tensors and once on the CPU: the same outer and inner
   iteration counts, fobj within 1e-9 relative.

Phases 12-15 run the facade's default routes, the host loops
(`Optimizer(problem, options)` with ``use_fused_loop`` left unset), writing
their logs under build/:

12. host TR at full width: phase 9's problem and options through
   `Optimizer` (algorithm 'tr' by default).  It must converge with
   infeasibility and linf below 1e-5, a finite x and fobj below its start,
   take phase 9's outer iterations with fobj within 1e-5 relative of
   phase 9's, launch every kernel, and write a log that `unpack_tr_output`
   parses to one row per outer iteration; it prints the outer and inner
   iterations, seconds and host reads per outer iteration, peak memory and
   one further outer iteration under torch.profiler;
13. host IP at full width: `Optimizer(..., {"algorithm": "ip", ...})` on
   SyntheticTopology(n = 2^20) in float32 with phase 4's settings (L-BFGS
   msub 10, abs_res_tol 1e-6, no refinement).  It must converge below
   1e-6 (the reason is printed) and launch every kernel; it prints its
   iterations beside phase 4's, seconds and host reads per iteration, peak
   memory and one further iteration under torch.profiler;
14. host MMA against FusedMMA: both on FEMTopology(768, 384, cg_iters=25,
   solver="mgcg") in float64 for 3 outer iterations (cut from 5); fobj
   within 1e-9
   relative, x within 1e-7, the same inner iterations, no kernel launched;
15. card against host in float64: the host IP and TR on
   SyntheticTopology(n = 2^14) and the host MMA on FEMTopology(24, 12,
   mgcg), 10 outer iterations each (or to convergence), once with CUDA
   tensors and once on the CPU: the same iteration counts, fobj within
   1e-9 relative and equal integer columns in their logs.

Phases 16-20 run the Newton-Krylov (GMRES) phase and the 3-D voxel FEM:

16. NK at full width: SyntheticTopology(n = 2^20) in float32 through the
   host IP (`Optimizer`, phase 13's settings) and through FusedIP (phase
   4's settings), each with tests/test_gmres.py's NK options (Hessian-vector
   products, GMRES subspace 25, Eisenstat-Walker gamma 0.05, nk_switch_tol
   1e-3).  Each must converge below 1e-6, take at least one NK step and
   launch every kernel; each prints its iterations beside phases 4 and 13,
   NK steps, GMRES arms, Hessian-vector products, seconds and host reads
   per iteration, peak memory, launches, and one NK iteration under
   torch.profiler;
17. card against host in float64: the host IP and FusedIP with NK on
   SyntheticTopology(n = 2^14), once with CUDA tensors and once on the CPU:
   the same iterations and GMRES arms per iteration, fobj within 1e-9;
18. 3-D MMA at full width: FEMTopology3D(160, 80, 80, cg_iters=40,
   solver="mgcg"), 1,024,000 design variables and 3,168,963 dofs, in
   float32.  First K(E)·u on each multigrid level in both layouts (device
   ms by CUDA events, median of 20; wall ms per call; kernels per call) and
   the layout `auto` takes; then FusedMMA for 12 outer iterations (cut
   from the flagship's 60) with
   phase 6's prints and checks (fobj < 0.5 of the start, infeasibility
   < 1e-6, a sync-free state solve, no phase-3 kernel).  A float64 state
   solve at the final design must reach ||K u - f|| / ||f|| < 1e-5 (its
   cg_iters raised to 80 for that solve alone if 40 do not), and the
   float32 residual is printed beside its floor;
19. bench.py's 3-D configuration: FusedMMA on FEMTopology3D(32, 16, 16,
   cg_iters=25, solver="mgcg"), float32, 40 outer iterations; fobj must
   fall in bench.py's band (0.08, 0.14) with infeasibility < 1e-8;
20. card against host in float64 on FEMTopology3D(8, 4, 4, mgcg): FusedMMA
   and the host MMA through the facade (6 outer iterations each, cut from
   10; equal log columns iter and subiter) and FusedTR (3 outer
   iterations, cut from 5); FusedMMA (6, cut from 12) on DMOFEMTopology3D(6, 3, 3,
   cg_iters=250): the same counts, fobj within 1e-9 relative.

The line before the last is a JSON object with one entry per kernel (its
launches in the phase-4 IP solve, as tr_launches in the phase-9 TR solve,
as host_tr_launches and host_ip_launches in phases 12 and 13, and as
nk_launches in phase 16's host NK solve; its phase-3 error, times and
bound; library_ms is null, since no single PyTorch call computes any of
the three functions); the last line is {"ok": true, "device": {...}}.
Phases 21-25 run the batched solves (`solve_batched`: k solves as one,
every step's phases under torch.func.vmap, each kernel launched once per
call with its instance axis):

21. batched IP at full width: phase 4's problem and settings with k = 4
   starts (x0 scaled by default_rng(0).uniform(0.5, 1.5)), in float32 and
   in float64.  Every instance must converge below 1e-6 and every kernel
   launch must be an instance-axis launch.  float32: one batched step must
   launch each kernel as often as one single step; each instance is
   printed beside its own single solve and beside a single solve from its
   start moved by a relative 1e-7 (float32's roundoff floor: on this
   problem roundoff alone moves a float32 solve by iterations and by
   ~1e-4 in fobj, so float32 cannot hold one summation order to
   another's).  float64: each instance within one iteration of its own
   single solve and fobj within 1e-5 relative (the measured agreement,
   printed, is ~1e-13).  It prints the wall time,
   ms per batched step beside the single solves', host reads per step both
   ways, peak memory, launches, and one float32 batched step under
   torch.profiler;
22. scripts/bench_batched.py's defaults: n = 4096, k = 32, tol 1e-4,
   float32: the batched solve against 32 sequential single solves, wall
   time both ways and their ratio (recorded, not claimed); the same
   convergence flags and fobj within 1e-5;
23. batched MMA at full width: FEMTopology(768, 384, mgcg), k = 4 starts
   clipped to [0.05, 0.95] from uniform(0.6, 1.4).  float32, 6 outer
   iterations (a depth cut): infeasibility < 1e-6 for every instance, no
   kernel launched, instance 1 printed beside its single solve and the
   float32 floor.  float64, 3 outer iterations: instance 1 equal to its
   own single solve in niter and fobj (1e-5 relative);
24. batched TR with k = 4: phase 9's configuration (every instance
   converged, all three kernels launched, every launch with the instance
   axis, instance 2 equal to its single solve in niter and fobj within
   1e-5), and bench.py's FEM 48x24 as examples/fem_topology_tr.py runs it
   (only qn_roll_update): float32, 4 outer iterations (cut from 6),
   instance 2 printed beside its single solve and the float32 floor;
   float64, 3 outer iterations (cut from 4), instance 2 equal to its
   single solve (fobj within 1e-5);
25. card against host in float64: the three batched solves at the CPU
   tests' sizes (SyntheticTopology(256); FEM 8x4), depths cut (the IP to
   60 steps, the MMA and TR to 6 and 4 outer iterations), on the card and
   on the CPU: equal counts, fobj within 1e-12 relative per instance.

The kernels line also carries each kernel's launches in phase 21
(batched_launches) and in phase 24's n = 2^20 batch
(batched_tr_launches), and its phase-3b error and times.

Phases 26-28 run the eigenvalue path (LOBPCG, the frequency models,
FusedEigenTR and the host EigenSubproblem); each prints its wall seconds:

26. the 3-D eigen flagship at full width: FrequencyTopology3D(64, 32, 32,
   N=6, cg_iters=30, solver="mgcg", lobpcg_iters=60) in float32, 65,536
   design variables and 212,355 dofs, through
   build_fused_tr({"tr_max_iterations": 1}) and 3 calls of
   solve(state0=..., jit_loop=False), each resuming the last and running
   one more outer iteration (3 outer iterations, cut from the flagship's
   40).  It prints
   the construction seconds and the lam_target calibration's LOBPCG block
   iterations, ks_rho/lam_target^2 (paropt_tpu measured 5.37e10), seconds
   and host reads per outer iteration, LOBPCG block iterations per
   eigensolve (cold and warm), peak memory, and one further outer
   iteration under torch.profiler split by the paropt.eig.lobpcg,
   paropt.tr.steer, paropt.tr.qp, paropt.tr.eval and paropt.tr.qn_update
   ranges.  Checks: every iterate, fobj and rho finite; fobj below its
   start of 1.0; qn_roll_update launched once per outer iteration and
   quasi_def_apply and phi_gram never (the frequency problems have no
   sparse constraints, nwcon = 0, so no inner solve has a quasi-definite
   block to solve; the reason is printed).  Then the first outer
   iteration is priced again in float64 at the same two points (x0 and
   the first trial), each eigensolve started from the float32 basis there:
   eigenvalues, KS values and rho printed both ways, and float64 must
   accept or reject the trial as float32 did;
27. bench.py's eigen-TR configuration: FrequencyTopology(24, 12, N=4,
   cg_iters=25, solver="mgcg", lobpcg_iters=50) with bench.py:290-297's
   options, float32, 20 outer iterations; fobj must fall in bench.py's
   band (0.25, 0.35) with infeasibility < 2e-3 (printed beside
   paropt_tpu's 6.9e-4), and only qn_roll_update may launch; it prints
   outer iterations/s;
28. card against host in float64: FusedEigenTR on FrequencyTopology(8, 4,
   N=3, mgcg) (4 outer iterations) and on FrequencyTopology3D(4, 3, 2,
   N=3, Jacobi CG 120) (4; ny != nz, since a box symmetric in y and z has
   a double lowest eigenvalue whose basis each eigh picks by roundoff),
   and the host EigenSubproblem through
   Optimizer.set_trust_region_subproblem on the 2-D problem (2): the same
   outer and inner iteration counts and LOBPCG block iterations per
   eigensolve, fobj within 1e-9 relative.

The kernels line also carries each kernel's launches in phase 26
(eig_launches).

Phases 29-31 run the general-CSR path (the host InteriorPoint with the
native sparse Cholesky, g++-built from src_native/ into
build/paropt_torch_sparse/, factoring on the host) and the callback path,
with the trajectory, COPS and truss models; each prints its wall seconds:

29. BrachistochroneCollocation(2048) in float64, 8,188 variables and 6,141
   CSR equalities, through `Optimizer` ('ip') with the dymos options of
   tests/test_brachistochrone.py:13-21.  Checks: converged; tf within
   1e-3 relative of 1.8016; max defect < 1e-6; iterations within 10 of
   paropt_tpu's 71 (its CPU run); no quasi-definite kernel launched and
   qn_roll_update launched.  It prints seconds, host reads and the bytes
   moved each way per iteration, the host factor's and solves' seconds as
   a share of wall time, the factor's fill (nnz(L), fill, supernodes),
   the launches and the peak device memory;
30. ElectronCSR(200) (COPS 3.0's largest instance; registry defaults,
   abs_res_tol 1e-6): converged, fobj within 1e-4 relative of the Thomson
   minimum 18438.84, sphere constraints < 1e-6; SSTOCollocation(160) with
   the dymos options: converged, final time within 1e-3 relative of
   481.8 s, defects and boundary constraints < 1e-6.  Each prints phase
   29's figures;
31. card against host in float64 through the host InteriorPoint:
   ElectronCSR(20), Electron(20), Polygon(6), SSTOCollocation(40),
   BrachistochroneCollocation(48), the callback-only SparseRosenbrock,
   TrussSizing, DMOTruss(4, 3) (40 iterations, a depth cut) and
   CartPole(nsteps=12) (20 of its 47 iterations, a depth cut): equal
   iteration, evaluation and gradient counts,
   fobj within 1e-9 relative (plus 1e-14 absolute: the Rosenbrock ends at
   fobj ~ 1e-16, roundoff); DMOTruss's launches are printed.

The kernels line also carries each kernel's launches in phases 29 and 30
(csr_launches, electron_launches, ssto_launches).

Phases 32-35 run the batched eigen-TR solves, checkpoints and the
reference's user surface; each prints its wall seconds:

32. batched eigen TR at full width: phase 26's FrequencyTopology3D(64, 32,
   32, N=6, cg_iters=30, mgcg, lobpcg_iters=60) in float32 through
   build_fused_tr with phase 26's options and tr_max_iterations 3 (phase
   26's depth, cut from the flagship's 40; at 2 the x0 instance has had
   both trials rejected and still sits at its start), then solve_batched
   on kb = 4 starts
   (x0 = 1 and three from _starts inside the bounds).  It prints per
   instance the outer and inner iterations, fobj, infeasibility and LOBPCG
   block iterations per eigensolve, and for the batch the seconds per
   batched outer iteration beside phase 26's single one, host reads per
   outer iteration, the instance-axis launches and peak memory.  Checks:
   every iterate finite, each fobj below 1, one instance-axis
   qn_roll_update per outer iteration and no single-launch roll, no
   quasi-definite kernel;
33. per-instance holds in float64: solve_batched with kb = 3 on phase 28's
   FrequencyTopology(8, 4, N=3, mgcg) and FrequencyTopology3D(4, 3, 2,
   N=3, Jacobi CG 120), 4 outer iterations: each instance equal to its own
   single solve on the card (outer and inner iterations, LOBPCG block
   iterations per eigensolve, fobj within 1e-9 relative; x0's single
   solve is phase 28's card run), and the card's batch equal to the CPU's
   by the same measures (the CPU's batches run in a child process started
   before phase 26, beside the card's phases);
34. checkpoints at full width: (a) fused_ip_optimize on
   SyntheticTopology(2^20) in float32 with phase 4's settings,
   write_output_frequency 10 and ip_checkpoint_file (the hook at the
   'auto' windows' boundaries, as JAX's: iterations 1, 2 and then every
   64 or at the end) must end as phase 4 does (iterations, fobj and x bit
   for bit); a first solve capped at 10 iterations writes its iteration-10
   state at its last boundary, and that file, restored with restore_state
   (it must hold k = 10) and resumed under the full cap, must end the same
   way; the file's size and write time are printed; (b) phase 13's host
   InteriorPoint with optimize(checkpoint=...): the file read back by
   read_solution_file equals the state written bit for bit and the
   resumed solve converges; (c) phase 7's FusedMMA run on FEMTopology(96,
   48) wrote its state with checkpoint_path at cadence 10: its
   iteration-30 file, resumed by a solver capped at 60 (the absolute
   count, JAX's rule), must end on phase 7's 60-iteration fobj and x bit
   for bit;
35. the reference's surface at full width in float64 on the card: (a) a
   compat.Problem written here with numpy fill callbacks (the objective,
   the volume constraint and the n/8 block constraints of
   SyntheticTopology(2^20), nwblock = 1) through compat.InteriorPoint
   with phase 4's settings against InteriorPoint(SyntheticTopology(2^20)):
   the same iterations, fobj within 1e-9 relative and x within 1e-7, with
   seconds, host reads and bytes each way per iteration and each route's
   launches; (b) a FunctionProblem of the same objective and volume
   constraint against a native problem of the two: the same iterations,
   fobj within 1e-9; (c) ReducedProblem(FEMTopology(768, 384, mgcg)) with
   the 8x8 elements around the load fixed at 1.0: the reduced gradient
   equals the full gradient's free entries (1e-12 relative) and 5 host
   MMA outer iterations in float64 lower fobj and leave the fixed entries
   exactly 1.0.

The kernels line also carries each kernel's launches in phases 32
(eig_batched_launches), 33 (eig_batched_f64_launches, the card's batched
solves), 34 (ckpt_ip_launches, ckpt_host_ip_launches) and 35
(compat_launches, compat_native_launches, function_launches).

Phase 36 runs the main path on sharded state (DTensor over a device mesh,
`paropt_torch.parallel`), in child processes of
``python -m paropt_torch.parallel.worker`` (MASTER_ADDR 127.0.0.1, a free
port, the rank environment set), so that phases 1-35 run with no process
group; a child that fails fails the script:

36. (a) world size 1 over NCCL, `design_mesh("cuda")`, the state placed by
   `shard_tree`: phase 4's solve (SyntheticTopology(2^20), float32, L-BFGS
   msub 10, abs_res_tol 1e-6, no refinement).  It must converge below
   1e-6 in phase 4's iterations with fobj within 1e-6 relative and launch
   each kernel as often as phase 4; it prints max |dx| against phase 4,
   seconds and host reads per step beside phase 4's (the cost of
   DTensor's dispatch) and peak memory.  The same child checks the redistributions a solve makes,
   each kernel's sharded route against its unsharded launch (bit for bit)
   and a DCP checkpoint of the state after 3 steps: written, restored bit
   for bit with its placements, and one identical step from each; its
   size and write time are printed.  (b) With two or more cards:
   min(4, cards) NCCL ranks run (a)'s solve, held to (a)'s checks and to
   (a).  With one card, no run of several ranks is made: NCCL refuses two
   ranks on one device ("Duplicate GPU detected"), and with gloo the
   all-gather of CUDA tensors that DTensor's redistribution calls ends
   the process (SIGSEGV) on the card machine's PyTorch 2.11, so
   multi-rank on the card waits for a machine with two or more cards.
   The kernels line carries each kernel's launches in (a)
   (sharded_launches).
37. the FEM and eigenvalue models on sharded state (x-strips with explicit
   halos, paropt_torch/parallel/halo.py), through the worker's cases fem2d,
   fem3d and eigtr: FusedMMA on FEMTopology(768, 384, cg_iters=25, mgcg)
   in float64 (3 outer iterations), FusedMMA on FEMTopology3D(160, 80, 80,
   cg_iters=40, mgcg) in float32 (2), and FusedEigenTR on
   FrequencyTopology3D(64, 32, 32, N=6, cg_iters=30, mgcg) in float32 (2,
   phase 26's options: the defaults), each solved warm on plain tensors
   and then on sharded state in one process.  (a) One NCCL rank: the sharded run takes
   the plain run's iterations with every fobj within 1e-12 relative in
   float64 and 1e-5 in float32 (the eigen TR also its KS value; basis-free
   quantities only, as the 64x32x32 box has a double lowest eigenvalue);
   max |dx|, seconds per outer iteration, host reads, peak memory, the
   strips' entries of a fine-level CG vector and their exchanges per CG
   iteration are printed, and the eigen TR's sharded run must launch
   qn_roll_update once per outer iteration (fem_sharded_launches in the
   kernels line).  (b) With four or more cards: the same cases on four
   NCCL ranks, held to (a) within the same tolerances (the same
   iterations, the final fobj and infeasibility, the eigen TR's KS
   value; four ranks sum in another order, so (b)'s largest difference
   from its own plain run over the iterations is printed, not held),
   with each rank's peak memory beside (a)'s.

Phase 38 runs in two groups of its own, (a)-(b) and (c): the fused
solvers' chunked execution (jit_loop / chunk,
paropt_torch/utils/chunked.py), JAX's resume rule and the repo's example
programs on the card:

38. (a) phase 4's solve (FusedIP, SyntheticTopology(2^20), float32) with
   jit_loop=True in one window, in windows of 5 and 'auto': each ends on
   the one-window solve's iterations, fobj and x bit for bit, launches
   all three kernels, and the windows of 5 call on_chunk at the
   iterations JAX's run_chunked gives; bench.py's FusedMMA 96x48 (phase
   7) and FusedTR 48x24 (phase 10) in windows of 3 against one window:
   the same bits, the write_output hook at JAX's windows; phase 24's
   batched FusedTR at n = 2^20 float32 (k = 4) in windows of 2 against
   one window: the same counts and bits, every kernel launched with its
   instance axis.
   The kernels line carries the windows-of-5 run's launches
   (chunked_launches).  (b) FusedMMA 96x48 resumed from its state at
   outer iteration 30: the default stops at the absolute cap (60: the
   uninterrupted run's bits; 40: 40), jit_loop=False runs the cap more
   (10: 40, the bits of the default's 40).  (c) Each of the 20 programs of
   paropt_torch/examples at the JAX script's default arguments (a program
   that took more than ~30 s of the card's time runs fewer outer
   iterations: EXAMPLE_CUTS, printed), in build/phase38: its seconds,
   launches, result and last lines printed, and its result held
   (EXAMPLE_HOLDS): the converged flag where the JAX script converges at
   its uncut defaults, its objective and other numbers within 1e-6
   relative (float64) or 1e-2 (the three float32 programs) of the port's
   float64 run of the same program and cut on the CPU;
   openmdao_paraboloid must end with the JAX script's message when
   openmdao is absent.
Only torch and numpy are used.
"""

import json
import math
import os
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BUILD = ROOT / "build"

# one row per kernel: wrapper name -> (source, replaced Pallas kernel)
KERNELS = {
    "qn_roll_update": ("paropt_torch/csrc/qn_roll.cu",
                       "paropt_tpu/ops/pallas_kernels.py:68"),
    "quasi_def_apply": ("paropt_torch/csrc/quasi_def.cu",
                        "paropt_tpu/ops/pallas_kernels.py:258"),
    "phi_gram": ("paropt_torch/csrc/quasi_def.cu",
                 "paropt_tpu/ops/pallas_kernels.py:210"),
}
# relative tolerance of kernel against plain version: f64 exposes indexing
# faults; f32 (and bf16 storage, which accumulates in f32) differ only by
# summation order (tile/tree sums in the kernel, BLAS/reduction order in
# torch), a few ulps of the accumulated magnitude
RTOL = {"float64": 1e-12, "float32": 1e-5, "bfloat16": 1e-5}
N_MAIN = 1 << 20
MSUB = 10
BLOCK = 8
L2_FLUSH_BYTES = 256 << 20   # written between timed runs; the L2 is 50 MB
# the H100 SXM's published peaks (NVIDIA's data sheet): HBM3 bandwidth and
# float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
SPIN_CYCLES = 100_000_000    # ~50 ms at the H100's clock
CSR_N = 8188                 # phase 29's design variables
SLICE = {}                   # phase 4's wall seconds, iterations, reads


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAIL: {msg}")


def cuda_ms(torch, fn, reps=20, warmup=3, clean=False):
    """Median device time of fn() in milliseconds over `reps` runs, each
    between a pair of CUDA events, with the L2 cache flushed before each run
    (an upper bound for a caller whose operands are partly in L2).  The
    flush writes 256 MB, so each run starts with the L2 full of dirty lines
    that its own traffic must write back; with `clean` it reads them
    instead, and each run starts with a clean L2.  A spin
    kernel holds the stream while the host enqueues every run, so the
    events time the device's work and not the host's Python and launch
    overhead; if the host outran the spin, the spin is lengthened."""
    for _ in range(warmup):
        fn()
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    spin = SPIN_CYCLES
    for _ in range(4):
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(reps)]
        torch.cuda.synchronize()
        torch.cuda._sleep(spin)
        for start, stop in events:
            if clean:
                flush.sum()
            else:
                flush.zero_()
            start.record()
            fn()
            stop.record()
        # still spinning (or in the first run) once all runs are enqueued:
        # no run waited for the host
        held = not events[0][1].query()
        torch.cuda.synchronize()
        if held:
            return statistics.median(s.elapsed_time(e) for s, e in events)
        spin *= 4
    raise SystemExit("chip_smoke: FAIL: the host could not enqueue the timed "
                     "runs ahead of the device")


def rel_err(torch, got, want):
    """(max abs error, max abs error / max |want|), in float64."""
    got = got.double()
    want = want.double()
    err = torch.max(torch.abs(got - want)).item()
    scale = max(torch.max(torch.abs(want)).item(), 1e-300)
    return err, err / scale


def _no_tf32(torch):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is on")
    check(not torch.backends.cudnn.allow_tf32, "cuDNN TF32 is on")


def phase_device(torch):
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip().splitlines()[0])
    _no_tf32(torch)
    log(f"[device] {torch.cuda.get_device_name(0)} "
        f"count={torch.cuda.device_count()} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")


def phase_build():
    from paropt_torch.ops import _build
    t0 = time.perf_counter()
    _build.load_library()
    wall = time.perf_counter() - t0
    nvcc = (f"{_build.build_seconds:.2f} s" if _build.build_seconds
            else "cached")
    log(f"[build] kernels ready in {wall:.2f} s (nvcc {nvcc})")
    # the host sparse Cholesky of phases 29-31, built with g++ from
    # src_native/ here so that no phase's factor time holds the build
    from paropt_torch.ops import sparse_native
    t0 = time.perf_counter()
    lib = sparse_native.load_library()
    log(f"[build] native sparse library ready in "
        f"{time.perf_counter() - t0:.2f} s "
        f"({Path(lib._name).relative_to(ROOT)})")
    logfile = _build.BUILD_ROOT / _build.source_hash() / "build.log"
    if logfile.exists():
        # ptxas -v: each kernel's name, then its spills and registers
        for line in logfile.read_text().splitlines():
            if "entry function" in line:
                log(f"[build] {line.split(chr(39))[1][:60]}")
            elif "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")


def _qd_inputs(torch, gen, K, k, W, dtype):
    kw = dict(device="cuda", dtype=dtype, generator=gen)
    dinv = 0.5 + 1.5 * torch.rand((k, W), **kw)
    vals = torch.randn((k, W), **kw)
    c0 = 0.5 + torch.rand((W,), **kw)
    cwinv = 1.0 / (c0 + torch.sum(vals ** 2 * dinv, dim=0))
    bx = torch.randn((K, k, W), **kw)
    bw = torch.randn((K, W), **kw)
    return dinv, cwinv, vals, bx, bw


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound_ms(nbytes, flops):
    """(least time in ms, what bounds it): the bytes the function must move
    over the memory rate, or its float32 operations over the float32 rate,
    whichever is larger."""
    mem = nbytes / HBM_BYTES_PER_S * 1e3
    ops = flops / F32_FLOPS_PER_S * 1e3
    return (mem, "bytes") if mem >= ops else (ops, "operations")


def smi_sample():
    """The card's SM clock, power draw and power limit, as nvidia-smi reads
    them now."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed: {smi.stderr.strip()}"


def phase_kernels(torch):
    """Each kernel against its plain version; returns per-kernel results at
    the main path's shapes in float32 (error, times, bound)."""
    from paropt_torch.ops import kernels
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    out = {}

    def compare(name, label, got, want, dtype_name, exact=()):
        worst = 0.0
        for g, w in exact:
            check(torch.equal(g, w), f"{name} {label}: buffer differs")
        for g, w in zip(got, want):
            err, rel = rel_err(torch, g, w)
            check(rel <= RTOL[dtype_name],
                  f"{name} {label}: relative error {rel:.3e} > "
                  f"{RTOL[dtype_name]:.0e}")
            worst = max(worst, err)
        torch.cuda.synchronize()
        log(f"[kernels] {name} {label}: max abs err {worst:.3e}")
        return worst

    def repeat_bitwise(name, label, fn, first):
        again = fn()
        check(all(torch.equal(a, b) for a, b in zip(first, again)),
              f"{name} {label}: two runs differ")
        log(f"[kernels] {name} {label}: two runs bitwise equal")

    def timed(name, label, fn, plain, nbytes, flops):
        ms = cuda_ms(torch, fn)
        pms = cuda_ms(torch, plain)
        smi = smi_sample()
        clean_ms = cuda_ms(torch, fn, clean=True)
        bms, by = bound_ms(nbytes, flops)
        log(f"[kernels] {name} {label}: {ms:.4f} ms kernel, {pms:.4f} ms "
            f"plain; bound {bms:.4f} ms by {by} ({nbytes / 1e6:.2f} MB, "
            f"{flops / 1e9:.3f} GFLOP), {100 * bms / ms:.1f}% of bound; "
            f"clocks.sm, power.draw, power.limit: {smi}; kernel after a "
            f"clean flush {clean_ms:.4f} ms ({100 * bms / clean_ms:.1f}%)")
        return {"ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by}

    # 1. qn_roll_update: [2m, n] buffer in f32 / f64 / bf16, upd both ways,
    #    at the n of the main path, of the eigen TR paths (phases 26 and
    #    27) and a ragged n
    for n in (N_MAIN, math.prod(EIG3D_MESH), math.prod(EIG_BENCH_MESH),
              CSR_N, 1000):
        for sdt, cdt in ((torch.float32, torch.float32),
                         (torch.float64, torch.float64),
                         (torch.bfloat16, torch.float32)):
            buf = torch.randn((2 * MSUB, n), device="cuda", dtype=cdt,
                              generator=gen).to(sdt)
            s = torch.randn(n, device="cuda", dtype=cdt, generator=gen)
            y = torch.randn(n, device="cuda", dtype=cdt, generator=gen)
            buf0 = buf.clone()
            for flag in (True, False):
                upd = torch.tensor(flag, device="cuda")
                ko, kd = kernels.qn_roll_update(buf, s, y, upd)
                po, pd = kernels.qn_roll_update_plain(buf, s, y, upd)
                name = str(sdt).split(".")[1]
                err = compare("qn_roll_update",
                              f"[{2 * MSUB}, {n}] {name} upd={flag}",
                              [kd], [pd], name, exact=[(ko, po)])
                check(torch.equal(buf, buf0), "qn_roll_update changed buf")
                if n == N_MAIN and sdt == torch.float32:
                    r = out.setdefault("qn_roll_update", {"max_abs_err": 0.0})
                    r["max_abs_err"] = max(r["max_abs_err"], err)
                if n == N_MAIN and sdt == torch.float32 and flag:
                    r.update(timed(
                        "qn_roll_update", f"[{2 * MSUB}, {n}] f32",
                        lambda: kernels.qn_roll_update(buf, s, y, upd),
                        lambda: kernels.qn_roll_update_plain(buf, s, y, upd),
                        _nbytes(buf, s, y, upd, ko, kd),
                        4 * 2 * MSUB * n))

    # 2. quasi_def_apply: K = 1 (every step solve) and K = 21
    W_main = N_MAIN // BLOCK
    B = 2 * MSUB + 1
    for W in (W_main, 1000, 1001):
        for dt in (torch.float32, torch.float64):
            name = str(dt).split(".")[1]
            for K in (1, B):
                args = _qd_inputs(torch, gen, K, BLOCK, W, dt)
                label = f"K={K} k={BLOCK} nwcon={W} {name}"
                got = kernels.quasi_def_apply(*args)
                err = compare("quasi_def_apply", label, got,
                              kernels.quasi_def_apply_plain(*args), name)
                repeat_bitwise("quasi_def_apply", label,
                               lambda: kernels.quasi_def_apply(*args), got)
                if W == W_main and dt == torch.float32:
                    r = out.setdefault("quasi_def_apply",
                                       {"max_abs_err": 0.0})
                    r["max_abs_err"] = max(r["max_abs_err"], err)
                    t = timed("quasi_def_apply", f"K={K} f32",
                              lambda: kernels.quasi_def_apply(*args),
                              lambda: kernels.quasi_def_apply_plain(*args),
                              _nbytes(*args, *got),
                              K * W * (6 * BLOCK + 2))
                    if K == 1:  # the main path's step and init solves
                        r.update(t)

    # 3. phi_gram, B = 21, as the factor setup calls it: the stack as its
    # Z_qn rows (2m) and A's row, bw = 0; and whole with a bw
    for W in (W_main, 1000, 1001):
        for dt in (torch.float32, torch.float64):
            name = str(dt).split(".")[1]
            dinv, cwinv, vals, bx, bw = _qd_inputs(torch, gen, B, BLOCK, W, dt)
            z, a = bx[:2 * MSUB], bx[2 * MSUB:]
            label = f"B={B} k={BLOCK} nwcon={W} {name}"
            got = kernels.phi_gram(dinv, cwinv, vals, z, None, a)
            err = compare("phi_gram", label, got,
                          kernels.phi_gram_plain(dinv, cwinv, vals, z, None,
                                                 a), name)
            repeat_bitwise("phi_gram", label, lambda: kernels.phi_gram(
                dinv, cwinv, vals, z, None, a), got)
            compare("phi_gram", label + " with bw",
                    kernels.phi_gram(dinv, cwinv, vals, bx, bw),
                    kernels.phi_gram_plain(dinv, cwinv, vals, bx, bw), name)
            if W == W_main and dt == torch.float32:
                bw0 = torch.zeros_like(bw)

                def unfused():
                    # the yardstick: the apply at K = 21, then the Gram
                    # matrix as one product (the port never calls this)
                    yx, yw = kernels.quasi_def_apply(dinv, cwinv, vals, bx,
                                                     bw0)
                    return yx, yw, bx.reshape(B, -1) @ yx.reshape(B, -1).T

                compare("phi_gram", label + " unfused yardstick", unfused(),
                        got, name)
                r = {"max_abs_err": err}
                r.update(timed(
                    "phi_gram", f"B={B} f32",
                    lambda: kernels.phi_gram(dinv, cwinv, vals, z, None, a),
                    lambda: kernels.phi_gram_plain(dinv, cwinv, vals, z,
                                                   None, a),
                    _nbytes(dinv, cwinv, vals, bx, *got),
                    2 * B * B * BLOCK * W + B * W * (6 * BLOCK + 2)))
                r["unfused_ms"] = cuda_ms(torch, unfused)
                log(f"[kernels] phi_gram B={B} f32: unfused yardstick "
                    f"(quasi_def_apply K={B} + torch.mm) "
                    f"{r['unfused_ms']:.4f} ms against {r['ms']:.4f} ms "
                    f"fused; clocks.sm, power.draw, power.limit: "
                    f"{smi_sample()}")
                check(r["ms"] < r["unfused_ms"],
                      f"phi_gram {r['ms']:.4f} ms is not faster than its "
                      f"unfused yardstick {r['unfused_ms']:.4f} ms")
                out["phi_gram"] = r
    for name, r in out.items():
        log(f"[kernels] {name} main-path shape f32: {r['ms']:.4f} ms "
            f"kernel, {r['plain_ms']:.4f} ms plain, bound {r['bound_ms']:.4f}"
            f" ms by {r['bound_by']} ({100 * r['bound_ms'] / r['ms']:.1f}%);"
            f" library call: none (no single PyTorch call computes it)")
    return out


def _build_solver(torch, n, dtype, device, **extra):
    from paropt_torch import ip_fused
    from paropt_torch.models.topology import SyntheticTopology
    from paropt_torch.ops import qn as qnmod
    prob = SyntheticTopology(n=n, block=BLOCK, dtype=dtype, device=device)
    opts = ip_fused.FusedIPOptions(**dict(
        dict(use_quasi_newton_update=True, abs_res_tol=1e-6,
             iterative_refinement_steps=0), **extra))
    fused = ip_fused.FusedIP(ip_fused.model_from_problem(prob), prob.nvars,
                             prob.ncon, prob.nwcon, prob.nwblock, opts,
                             dtype=dtype)
    data, x0 = ip_fused.data_template_from_problem(prob, dtype=dtype)
    qn0 = qnmod.qn_init(MSUB, prob.nvars, dtype=dtype, device=device,
                        storage_dtype=qnmod.default_storage_dtype(dtype))
    return fused, data, x0, qn0


def phase_slice(torch):
    """The main path at n = 2^20 in float32; returns the launch counts, the
    iterations, fobj and x (phase 34 holds its checkpointed solve to
    them)."""
    from paropt_torch.ops import kernels
    fused, data, x0, qn0 = _build_solver(torch, N_MAIN, torch.float32,
                                         "cuda")
    warm = fused.solve(x0, data, (), qn0, None, max_iters=2)
    torch.cuda.synchronize()
    check(int(warm.k) == 2, "warm-up solve did not take 2 steps")
    fused.syncs.count = 0
    kernels.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = fused.solve(x0, data, (), qn0, None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    iters = int(state.k)
    fobj = float(state.fobj)
    res = float(state.res_norm)
    log(f"[slice] n={N_MAIN} f32 msub={MSUB}: converged="
        f"{bool(state.converged)} iters={iters} fobj={fobj:.9e} "
        f"res_norm={res:.3e} mu={float(state.mu):.3e}")
    log(f"[slice] wall {wall:.4f} s, {iters / wall:.2f} steps/s, "
        f"{fused.syncs.count / max(iters, 1):.2f} host syncs/step, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[slice] kernel launches in the solve: {launches}")
    SLICE.update(wall=wall, iters=iters, reads=fused.syncs.count)
    check(bool(state.converged), f"solve did not converge (res {res:.3e})")
    check(res < 1e-6, f"res_norm {res:.3e} >= 1e-6")
    check(torch.isfinite(state.fobj).item(), "non-finite objective")
    check(state.vars.x.shape == (N_MAIN,)
          and torch.isfinite(state.vars.x).all().item(), "bad final x")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched by the solve")
    return launches, iters, fobj, state.vars.x


def phase_crosscheck(torch):
    """n = 2^14 float64 on the card (kernels) against the host (plain)."""
    from paropt_torch.ops import kernels
    out = {}
    for device in ("cuda", "cpu"):
        kernels.reset_launches()
        fused, data, x0, qn0 = _build_solver(torch, 1 << 14, torch.float64,
                                             device)
        state = fused.solve(x0, data, (), qn0, None)
        out[device] = (int(state.k), float(state.fobj),
                       float(state.res_norm), bool(state.converged))
        log(f"[crosscheck] {device}: iters={out[device][0]} "
            f"fobj={out[device][1]:.15e} res={out[device][2]:.3e} "
            f"converged={out[device][3]} launches={dict(kernels.LAUNCHES)}")
    (kc, fc, _, cc), (kh, fh, _, ch) = out["cuda"], out["cpu"]
    check(cc and ch, "cross-check solve did not converge")
    check(kc == kh, f"iteration counts differ: cuda {kc}, cpu {kh}")
    check(abs(fc - fh) <= 1e-9 * abs(fh),
          f"objectives differ: cuda {fc!r}, cpu {fh!r}")


def _mma_solver(torch, problem, iters, dtype_name):
    from paropt_torch.mma import FusedMMA
    return FusedMMA(problem, {"mma_max_iterations": iters,
                              "mma_output_file": None, "dtype": dtype_name})


MMA_RANGES = ("paropt.fem.solve", "paropt.mma.eval", "paropt.mma.inner_ip")
TR_RANGES = ("paropt.tr.steer", "paropt.tr.qp", "paropt.tr.eval",
             "paropt.tr.qn_update")


def _profile_outer_step(torch, solver, state, names=MMA_RANGES):
    """One outer iteration of a fused solver under torch.profiler."""
    return _profile_call(torch, lambda: solver._step(state), names)


# device operations in a kineto trace (the gpu_user_annotation events are
# the ranges, not operations)
DEVICE_OP_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _profile_call(torch, fn, names=()):
    """``fn()`` under torch.profiler: the window, device ops, busy seconds
    of the window, and device ops / device ms / host ms inside each range
    of ``names``.  The trace is read from its chrome-trace export: parsing
    it into the profiler's Python events took minutes for an outer
    iteration of ~90,000 device ops."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    t1 = time.perf_counter()
    BUILD.mkdir(exist_ok=True)
    path = BUILD / f"chip_smoke_profile_{os.getpid()}.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    path.unlink()
    ops = [e for e in events if e.get("cat") in DEVICE_OP_CATS]
    busy = sum(e["dur"] for e in ops) * 1e-6
    split = {}
    for name in names:
        spans = [(r["ts"], r["ts"] + r["dur"]) for r in events
                 if r.get("cat") == "gpu_user_annotation"
                 and r.get("name") == name]
        inside = [k for k in ops if any(a <= k["ts"] < b for a, b in spans)]
        host = sum(e["dur"] for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("name") == name)
        split[name] = (len(inside), sum(k["dur"] for k in inside) * 1e-3,
                       host * 1e-3)
    log(f"[profile] {len(events)} trace events read in "
        f"{time.perf_counter() - t1:.2f} s")
    return window, len(ops), busy, split


def _relres(torch, p64, E, u):
    """||K u - f|| / ||f||, evaluated in float64 by the float64 model p64
    (fixed dofs carry the identity)."""
    r = p64._kmul(E.double(), u.double()) - p64.f
    return (torch.linalg.norm(r) / torch.linalg.norm(p64.f)).item()


def phase_mma_full(torch, dtype, nex=768, ney=384, iters=20):
    """FusedMMA on the full-width FEM mesh; returns the final design."""
    from paropt_torch.models.fem_topology import FEMTopology
    from paropt_torch.ops import kernels
    tag = f"[mma {nex}x{ney} {str(dtype).split('.')[1]}]"
    t0 = time.perf_counter()
    prob = FEMTopology(nex, ney, cg_iters=25, solver="mgcg", dtype=dtype,
                       device="cuda")
    torch.cuda.synchronize()
    log(f"{tag} {prob.nvars} design variables, {prob.ndof} dofs, "
        f"{len(prob._mg_dims)} multigrid levels (coarsest "
        f"{prob._mg_dims[-1][0]}x{prob._mg_dims[-1][1]}, "
        f"{2 * (prob._mg_dims[-1][0] + 1) * (prob._mg_dims[-1][1] + 1)}-dof "
        f"Cholesky); built in {time.perf_counter() - t0:.2f} s")
    x0, _, _ = prob.get_vars_and_bounds()
    f0 = float(prob.objective(x0))
    # no host sync inside one state solve (CG and the V-cycle)
    E0 = prob._simp(prob._filter(x0))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        prob._solve(E0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"{tag} one FEM solve ran under set_sync_debug_mode('error')")

    # warm-up: one outer iteration of a separate solver (library init)
    warm = _mma_solver(torch, prob, iters, str(dtype).split(".")[1])
    warm._step(warm._state0)
    solver = _mma_solver(torch, prob, iters, str(dtype).split(".")[1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res, state = solver.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    niter, sub = res["niter"], int(state.subiters)
    log(f"{tag} outer iterations {niter}, inner IP iterations {sub}; "
        f"fobj {res['fobj']:.9e} (start {f0:.9e}), infeas "
        f"{res['infeas']:.3e}, l1 {res['l1']:.6e}, linf {res['linfty']:.6e}")
    log(f"{tag} wall {wall:.3f} s = {wall / max(niter, 1):.4f} s per outer "
        f"iteration ({solver.syncs.count} host reads); peak memory "
        f"{peak:.3f} GiB; phase-3 kernel launches {launches}")
    window, nops, busy, split = _profile_outer_step(torch, solver, state)
    log(f"{tag} one outer iteration under the profiler: {window:.3f} s, "
        f"{nops} device ops, device busy {busy:.4f} s = "
        f"{100 * busy / window:.1f}% (idle {100 * (1 - busy / window):.1f}%)")
    for name, (cnt, dev_ms, host_ms) in split.items():
        log(f"{tag}   {name}: {cnt} device ops, device {dev_ms:.3f} ms, "
            f"host {host_ms:.3f} ms")

    x = res["x"]
    E = prob._simp(prob._filter(x))
    u = prob._solve(E)
    p64 = prob if dtype == torch.float64 else FEMTopology(
        nex, ney, cg_iters=25, solver="mgcg", dtype=torch.float64,
        device="cuda")
    relres = _relres(torch, p64, E, u)
    check(torch.isfinite(x).all().item() and x.shape == (prob.nvars,),
          "bad final design")
    for key in ("fobj", "infeas", "l1", "linfty"):
        check(math.isfinite(res[key]), f"non-finite {key}")
    check(res["fobj"] < 0.5 * f0, f"fobj {res['fobj']:.4e} >= 0.5 of the "
          f"start {f0:.4e}")
    check(res["infeas"] < 1e-6, f"infeas {res['infeas']:.3e} >= 1e-6")
    check(not any(launches.values()),
          f"a phase-3 kernel ran on the MMA/FEM path: {launches}")
    if dtype == torch.float64:
        log(f"{tag} final state solve: relative residual {relres:.3e}")
        check(relres < 1e-5, f"CG relative residual {relres:.3e} >= 1e-5")
    else:
        u64 = p64._solve(E.double())
        floor = _relres(torch, p64, E, u64.float())
        c32 = float(prob.f @ u)
        c64 = float(p64.f @ u64)
        log(f"{tag} final state solve: relative residual {relres:.3e}; "
            f"float32 floor (float64 solution rounded) {floor:.3e}; "
            f"float64 solve {_relres(torch, p64, E, u64):.3e}; float32 "
            f"compliance {c32:.6e} vs float64 {c64:.6e} "
            f"(rel err {abs(c32 - c64) / abs(c64):.3e})")
    return x


def phase_mma_bench(torch):
    """bench.py's MMA configuration as a correctness check.  The run also
    writes its full state every 10 outer iterations (``checkpoint_path``,
    at the boundaries of windows of 10) and keeps each file as the next is
    written; returns fobj and x after the 60 outer iterations and the kept
    files by iteration (phase 34 resumes the iteration-30 one to them)."""
    import shutil

    from paropt_torch.models.fem_topology import FEMTopology
    from paropt_torch.mma import FusedMMA
    prob = FEMTopology(96, 48, cg_iters=25, solver="mgcg",
                       dtype=torch.float32, device="cuda")
    BUILD.mkdir(exist_ok=True)
    path = BUILD / "chip_smoke_mma.pt"
    kept, last = {}, []

    def keep(it, x):
        # the file still holds the previous cadence's state
        if last:
            kept[last[-1]] = BUILD / f"chip_smoke_mma_{last[-1]}.pt"
            shutil.copy(path, kept[last[-1]])
        last.append(it)

    prob.write_output = keep
    solver = FusedMMA(prob, {"mma_max_iterations": 60,
                             "mma_output_file": None, "dtype": "float32",
                             "write_output_frequency": 10})
    t0 = time.perf_counter()
    res, state = solver.solve(chunk=10, checkpoint_path=str(path))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f"[mma 96x48 float32] outer iterations {res['niter']}, inner "
        f"{int(state.subiters)}, fobj {res['fobj']:.6f}, infeas "
        f"{res['infeas']:.3e}, l1 {res['l1']:.4e}; {wall:.2f} s = "
        f"{wall / max(res['niter'], 1):.4f} s per outer iteration "
        f"(checkpoints kept of iterations {sorted(kept)})")
    check(0.10 < res["fobj"] < 0.18,
          f"fobj {res['fobj']:.4f} outside bench.py's band (0.10, 0.18)")
    check(res["infeas"] < 1e-8, f"infeas {res['infeas']:.3e} >= 1e-8")
    path.unlink(missing_ok=True)
    return res["fobj"], state.x, kept


def phase_mma_crosscheck(torch):
    """FEM and DMO in float64, card against host."""
    from paropt_torch.models.fem_topology import DMOFEMTopology, FEMTopology
    cases = (
        ("fem 24x12 mgcg", 10, lambda dev: FEMTopology(
            24, 12, cg_iters=25, solver="mgcg", dtype=torch.float64,
            device=dev)),
        ("dmo 12x6", 8, lambda dev: DMOFEMTopology(
            12, 6, cg_iters=120, dtype=torch.float64, device=dev)),
    )
    for name, iters, make in cases:
        out = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            res, state = _mma_solver(torch, make(dev), iters,
                                     "float64").solve()
            out[dev] = (res["niter"], int(state.subiters), res["fobj"])
            log(f"[mma crosscheck] {name} {dev}: outer {out[dev][0]}, inner "
                f"{out[dev][1]}, fobj {out[dev][2]:.15e} "
                f"({time.perf_counter() - t0:.2f} s)")
        (kc, sc, fc), (kh, sh, fh) = out["cuda"], out["cpu"]
        check(kc == kh and sc == sh,
              f"{name}: iteration counts differ: cuda {kc}/{sc}, "
              f"cpu {kh}/{sh}")
        check(abs(fc - fh) <= 1e-9 * abs(fh),
              f"{name}: objectives differ: cuda {fc!r}, cpu {fh!r}")


TR_OPTS = {"tr_output_file": None, "output_file": None,
           "tr_max_iterations": 20, "abs_res_tol": 1e-6,
           "tr_infeas_tol": 1e-5, "tr_l1_tol": 0.0, "tr_linfty_tol": 1e-5}


def _tr_solver(problem, dtype_name, **extra):
    from paropt_torch.tr import FusedTR
    return FusedTR(problem, dict(TR_OPTS, dtype=dtype_name, **extra))


def phase_tr_full(torch):
    """FusedTR on SyntheticTopology at n = 2^20 in float32; returns the
    kernel launch counts of the solve."""
    from paropt_torch.models.topology import SyntheticTopology
    from paropt_torch.ops import kernels
    tag = f"[tr n={N_MAIN} float32]"
    prob = SyntheticTopology(n=N_MAIN, block=BLOCK, dtype=torch.float32,
                             device="cuda")
    x0, _, _ = prob.get_vars_and_bounds()
    f0 = float(prob.objective(x0))
    warm = _tr_solver(prob, "float32")
    warm._step(warm._state0)
    solver = _tr_solver(prob, "float32")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res, state = solver.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    niter, sub = res["niter"], res["subiters"]
    log(f"{tag} converged={res['converged']} outer iterations {niter}, "
        f"inner IP iterations {sub}; fobj {res['fobj']:.9e} (start "
        f"{f0:.9e}), infeas {res['infeas']:.3e}, l1 {res['l1']:.6e}, "
        f"linf {res['linfty']:.6e}, tr_size {res['tr_size']:.4e}")
    log(f"{tag} wall {wall:.4f} s = {wall / max(niter, 1):.4f} s per outer "
        f"iteration, {wall / max(sub, 1) * 1e3:.2f} ms per inner step; "
        f"{solver.syncs.count} host reads = "
        f"{solver.syncs.count / max(niter, 1):.1f} per outer iteration; "
        f"peak memory {peak:.3f} GiB; kernel launches {launches}")
    window, nops, busy, split = _profile_outer_step(torch, solver, state,
                                                    TR_RANGES)
    log(f"{tag} one outer iteration under the profiler: {window:.3f} s, "
        f"{nops} device ops, device busy {busy:.4f} s = "
        f"{100 * busy / window:.1f}% (idle {100 * (1 - busy / window):.1f}%)")
    for name, (cnt, dev_ms, host_ms) in split.items():
        log(f"{tag}   {name}: {cnt} device ops, device {dev_ms:.3f} ms, "
            f"host {host_ms:.3f} ms")
    x = res["x"]
    check(x.shape == (N_MAIN,) and torch.isfinite(x).all().item(),
          "bad final x")
    check(res["converged"], f"TR did not converge in {niter} outer "
          f"iterations (infeas {res['infeas']:.3e}, linf "
          f"{res['linfty']:.3e})")
    check(res["infeas"] < 1e-5 and res["linfty"] < 1e-5,
          f"infeas {res['infeas']:.3e} or linf {res['linfty']:.3e} >= 1e-5")
    check(math.isfinite(res["fobj"]) and res["fobj"] < f0,
          f"fobj {res['fobj']:.6e} not below the start {f0:.6e}")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched by the TR solve")
    return launches, niter, res["fobj"]


def phase_tr_bench(torch):
    """bench.py's TR configuration as a correctness check."""
    from paropt_torch.models.fem_topology import FEMTopology
    from paropt_torch.ops import kernels
    prob = FEMTopology(48, 24, cg_iters=25, solver="mgcg",
                       dtype=torch.float32, device="cuda")
    solver = _tr_solver(prob, "float32")
    kernels.reset_launches()
    t0 = time.perf_counter()
    res, state = solver.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    log(f"[tr 48x24 float32] outer iterations {res['niter']}, inner "
        f"{res['subiters']}, fobj {res['fobj']:.6f}, infeas "
        f"{res['infeas']:.3e}, l1 {res['l1']:.4e}, linf "
        f"{res['linfty']:.4e}; {wall:.2f} s = "
        f"{wall / max(res['niter'], 1):.4f} s per outer iteration, "
        f"{res['niter'] / wall:.3f} outer iterations/s; launches {launches}")
    check(0.18 < res["fobj"] < 0.30,
          f"fobj {res['fobj']:.4f} outside bench.py's band (0.18, 0.30)")
    check(res["infeas"] < 1e-6, f"infeas {res['infeas']:.3e} >= 1e-6")
    check(launches["qn_roll_update"] == res["niter"]
          and launches["quasi_def_apply"] == launches["phi_gram"] == 0,
          f"unexpected kernel launches on the FEM TR path: {launches}")


def phase_tr_crosscheck(torch):
    """FusedTR in float64, card against host."""
    from paropt_torch.models.fem_topology import FEMTopology
    from paropt_torch.models.topology import SyntheticTopology
    cases = (
        ("synthetic n=2^14", lambda dev: SyntheticTopology(
            n=1 << 14, block=BLOCK, dtype=torch.float64, device=dev)),
        ("fem 12x6 mgcg", lambda dev: FEMTopology(
            12, 6, cg_iters=25, solver="mgcg", dtype=torch.float64,
            device=dev)),
    )
    for name, make in cases:
        out = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            res, _ = _tr_solver(make(dev), "float64",
                                tr_max_iterations=6).solve()
            out[dev] = (res["niter"], res["subiters"], res["fobj"])
            log(f"[tr crosscheck] {name} {dev}: outer {out[dev][0]}, inner "
                f"{out[dev][1]}, fobj {out[dev][2]:.15e}, converged "
                f"{res['converged']} ({time.perf_counter() - t0:.2f} s)")
        (kc, sc, fc), (kh, sh, fh) = out["cuda"], out["cpu"]
        check(kc == kh and sc == sh,
              f"{name}: iteration counts differ: cuda {kc}/{sc}, "
              f"cpu {kh}/{sh}")
        check(abs(fc - fh) <= 1e-9 * abs(fh),
              f"{name}: objectives differ: cuda {fc!r}, cpu {fh!r}")


def _log_busy(tag, what, window, nops, busy):
    log(f"{tag} {what} under the profiler: {window:.3f} s, {nops} device "
        f"ops, device busy {busy:.4f} s = {100 * busy / window:.1f}% (idle "
        f"{100 * (1 - busy / window):.1f}%)")


def _host_route(torch, problem, options, log_name=None):
    """`Optimizer(problem, options).optimize()` with the log (if named)
    under build/, timed, with the kernel launches, peak memory and host
    reads of the run.  Returns (optimizer, result, wall, launches, peak,
    log path)."""
    from paropt_torch import Optimizer
    from paropt_torch.ops import kernels
    path = None
    options = dict(options, output_file=None, tr_output_file=None,
                   mma_output_file=None)
    if log_name is not None:
        BUILD.mkdir(exist_ok=True)
        path = BUILD / log_name
        key = {"ip": "output_file", "tr": "tr_output_file",
               "mma": "mma_output_file"}[options.get("algorithm", "tr")]
        options[key] = str(path)
    opt = Optimizer(problem, options)
    check(opt.options["use_fused_loop"] is False,
          "the facade's default route must be the host loop")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = opt.optimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (opt, res, wall, dict(kernels.LAUNCHES),
            torch.cuda.max_memory_allocated() / 2**30, path)


def phase_host_tr_full(torch, fused_niter, fused_fobj):
    """The host TrustRegion, the facade's default, at n = 2^20 in float32;
    returns the kernel launch counts of the solve."""
    from paropt_torch.models.topology import SyntheticTopology
    from paropt_torch.utils.logging import unpack_tr_output
    tag = f"[host tr n={N_MAIN} float32]"
    prob = SyntheticTopology(n=N_MAIN, block=BLOCK, dtype=torch.float32,
                             device="cuda")
    x0, _, _ = prob.get_vars_and_bounds()
    f0 = float(prob.objective(x0))
    opts = dict(TR_OPTS, dtype="float32", qn_subspace_size=MSUB)
    opt, res, wall, launches, peak, path = _host_route(
        torch, prob, opts, "chip_smoke_host.tr")
    tr = opt._inner
    check(type(tr).__name__ == "TrustRegion", "not the host TrustRegion")
    niter, reads = res["niter"], tr.syncs.count
    log(f"{tag} converged={res['converged']} outer iterations {niter} "
        f"(phase 9: {fused_niter}), inner IP iterations {tr.inner_iters}; "
        f"fobj {res['fobj']:.9e} (phase 9 {fused_fobj:.9e}, start "
        f"{f0:.9e}), infeas {res['infeas']:.3e}, l1 {res['l1']:.6e}, linf "
        f"{res['linfty']:.6e}")
    log(f"{tag} wall {wall:.4f} s = {wall / max(niter, 1):.4f} s per outer "
        f"iteration, {wall / max(tr.inner_iters, 1) * 1e3:.2f} ms per inner "
        f"step; {reads} host reads = {reads / max(niter, 1):.1f} per outer "
        f"iteration; peak memory {peak:.3f} GiB; kernel launches {launches}")
    rows = unpack_tr_output(str(path))
    log(f"{tag} {path.name}: {len(rows['iter'])} rows, iter "
        f"{rows['iter'].astype(int).tolist()}")
    # one further outer iteration from the converged point
    tr.options["tr_max_iterations"] = 1
    tr.options["tr_output_file"] = None
    window, nops, busy, _ = _profile_call(torch, tr.optimize)
    _log_busy(tag, "one further outer iteration", window, nops, busy)
    x = res["x"]
    check(x.shape == (N_MAIN,) and torch.isfinite(x).all().item(),
          "bad final x")
    check(res["converged"] and res["infeas"] < 1e-5 and res["linfty"] < 1e-5,
          f"host TR did not converge: infeas {res['infeas']:.3e}, linf "
          f"{res['linfty']:.3e}")
    check(math.isfinite(res["fobj"]) and res["fobj"] < f0,
          f"fobj {res['fobj']:.6e} not below the start {f0:.6e}")
    check(niter == fused_niter, f"outer iterations {niter} != phase 9's "
          f"{fused_niter}")
    check(abs(res["fobj"] - fused_fobj) <= 1e-5 * abs(fused_fobj),
          f"fobj {res['fobj']!r} differs from phase 9's {fused_fobj!r}")
    check(rows["iter"].astype(int).tolist() == list(range(niter)),
          f"{path.name} does not hold one row per outer iteration")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched by the host TR")
    return launches


def phase_host_ip_full(torch, fused_iters):
    """The host InteriorPoint at n = 2^20 in float32 with phase 4's
    settings; returns the kernel launch counts of the solve."""
    from paropt_torch.models.topology import SyntheticTopology
    from paropt_torch.utils.logging import unpack_output
    tag = f"[host ip n={N_MAIN} float32]"
    prob = SyntheticTopology(n=N_MAIN, block=BLOCK, dtype=torch.float32,
                             device="cuda")
    opts = {"algorithm": "ip", "dtype": "float32", "qn_subspace_size": MSUB,
            "abs_res_tol": 1e-6, "iterative_refinement_steps": 0}
    opt, res, wall, launches, peak, path = _host_route(
        torch, prob, opts, "chip_smoke_host.out")
    ip = opt._inner
    niter, reads = res["niter"], ip.syncs.count
    log(f"{tag} converged={res['converged']} reason={res['reason']!r} "
        f"iterations {niter} (phase 4 FusedIP: {fused_iters}); fobj "
        f"{res['fobj']:.9e}, res_norm {res['res_norm']:.3e}, mu "
        f"{res['mu']:.3e}")
    log(f"{tag} wall {wall:.4f} s = {wall / max(niter, 1) * 1e3:.2f} ms per "
        f"iteration; {reads} host reads = {reads / max(niter, 1):.1f} per "
        f"iteration; peak memory {peak:.3f} GiB; kernel launches {launches}")
    rows = unpack_output(str(path))
    log(f"{tag} {path.name}: {len(rows['iter'])} rows")
    # one further iteration from the converged point
    ip.options["starting_point_strategy"] = "no_start_strategy"
    ip.options["max_major_iters"] = 1
    ip.options["output_file"] = None
    window, nops, busy, _ = _profile_call(torch, ip.optimize)
    _log_busy(tag, "one further iteration", window, nops, busy)
    check(res["converged"] and res["res_norm"] < 1e-6,
          f"host IP did not converge below 1e-6: {res['reason']!r}, "
          f"res_norm {res['res_norm']:.3e}")
    check(torch.isfinite(res["x"]).all().item(), "bad final x")
    check(rows["iter"].astype(int).tolist() == list(range(niter + 1)),
          f"{path.name} does not hold one row per iteration")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched by the host IP")
    return launches, niter


def phase_host_mma(torch):
    """The host MMA against FusedMMA at 768x384 in float64."""
    from paropt_torch.mma import FusedMMA
    from paropt_torch.models.fem_topology import FEMTopology
    tag = "[host mma 768x384 float64]"
    prob = FEMTopology(768, 384, cg_iters=25, solver="mgcg",
                       dtype=torch.float64, device="cuda")
    opts = {"algorithm": "mma", "mma_max_iterations": 3, "dtype": "float64"}
    opt, res, wall, launches, peak, _ = _host_route(
        torch, prob, opts, "chip_smoke_host.mma")
    mma = opt._inner
    t0 = time.perf_counter()
    fres, fstate = FusedMMA(prob, dict(opts, mma_output_file=None)).solve()
    torch.cuda.synchronize()
    fwall = time.perf_counter() - t0
    dx = (res["x"] - fres["x"]).abs().max().item()
    log(f"{tag} host: {mma.mma_iter - 1} outer / {mma.subproblem_iter} inner "
        f"iterations, fobj {res['fobj']:.15e}, {wall:.3f} s "
        f"({mma.syncs.count} host reads); FusedMMA: {fres['niter']} / "
        f"{int(fstate.subiters)}, fobj {fres['fobj']:.15e}, {fwall:.3f} s; "
        f"max |x - x_fused| {dx:.3e}; launches {launches}")
    check(mma.mma_iter - 1 == fres["niter"]
          and mma.subproblem_iter == int(fstate.subiters),
          "host and fused MMA iteration counts differ")
    check(abs(res["fobj"] - fres["fobj"]) <= 1e-9 * abs(fres["fobj"]),
          f"fobj differs: host {res['fobj']!r}, fused {fres['fobj']!r}")
    check(dx <= 1e-7, f"x differs by {dx:.3e}")
    check(not any(launches.values()),
          f"a kernel ran on the host MMA/FEM path: {launches}")


def phase_host_crosscheck(torch):
    """The host loops in float64, card against host."""
    from paropt_torch.models.fem_topology import FEMTopology
    from paropt_torch.models.topology import SyntheticTopology
    from paropt_torch.utils import logging as plog

    def syn(dev):
        return SyntheticTopology(n=1 << 14, block=BLOCK, dtype=torch.float64,
                                 device=dev)

    cases = (
        ("ip", syn, {"algorithm": "ip", "max_major_iters": 10},
         plog.unpack_output, ("iter", "nobj", "ngrd", "nhvc")),
        ("tr", syn, dict(TR_OPTS, tr_max_iterations=10),
         plog.unpack_tr_output, ("iter",)),
        ("mma", lambda dev: FEMTopology(24, 12, cg_iters=25, solver="mgcg",
                                        dtype=torch.float64, device=dev),
         {"algorithm": "mma", "mma_max_iterations": 10},
         plog.unpack_mma_output, ("iter", "subiter")),
    )
    for name, make, opts, unpack, int_cols in cases:
        out = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            opt, res, _, _, _, path = _host_route(
                torch, make(dev), dict(opts, dtype="float64"),
                f"chip_smoke_cross_{name}_{dev}.log")
            rows = unpack(str(path))
            out[dev] = (res["niter"], res["fobj"],
                        [rows[c].astype(int).tolist() for c in int_cols])
            log(f"[host crosscheck] {name} {dev}: niter {res['niter']}, fobj "
                f"{res['fobj']:.15e}, converged {res['converged']}, "
                f"{len(rows['iter'])} log rows "
                f"({time.perf_counter() - t0:.2f} s)")
        (kc, fc, ic), (kh, fh, ih) = out["cuda"], out["cpu"]
        check(kc == kh, f"{name}: iteration counts differ: cuda {kc}, "
              f"cpu {kh}")
        check(abs(fc - fh) <= 1e-9 * abs(fh),
              f"{name}: objectives differ: cuda {fc!r}, cpu {fh!r}")
        check(ic == ih, f"{name}: integer log columns differ")


NK_OPTS = {"use_hvec_product": True, "gmres_subspace_size": 25,
           "eisenstat_walker_gamma": 0.05, "nk_switch_tol": 1e-3}


def _nk_arms(path):
    """The GMRES arms each iteration row of an IP log reports (its
    ``iNK{n}`` flag; 0 for a quasi-Newton step)."""
    arms = []
    with open(path) as fp:
        for line in fp:
            parts = line.split()
            if len(parts) >= 15 and parts[0].isdigit():
                flags = [p for p in parts[15:] if p.startswith("iNK")]
                arms.append(int(flags[0][3:]) if flags else 0)
    return arms


def phase_nk_full(torch, fused_iters, host_iters):
    """Phase 16: the Newton-Krylov phase at n = 2^20 in float32, through
    the facade's host IP and through FusedIP; returns the kernel launch
    counts of the host solve."""
    from paropt_torch.ops import kernels
    from paropt_torch.models.topology import SyntheticTopology
    tag = f"[nk n={N_MAIN} float32]"
    # the host IP, phase 13's settings with the NK options
    prob = SyntheticTopology(n=N_MAIN, block=BLOCK, dtype=torch.float32,
                             device="cuda")
    opts = dict(NK_OPTS, algorithm="ip", dtype="float32",
                qn_subspace_size=MSUB, abs_res_tol=1e-6,
                iterative_refinement_steps=0)
    # warm-up: torch.func's first Hessian-vector product starts its
    # machinery once per process
    x0, _, _ = prob.get_vars_and_bounds()
    zw = torch.zeros(prob.nwcon, dtype=torch.float32, device="cuda")
    t0 = time.perf_counter()
    prob.eval_hvec_product(x0, zw[:1], zw, x0)
    torch.cuda.synchronize()
    log(f"{tag} first Hessian-vector product (warm-up): "
        f"{time.perf_counter() - t0:.3f} s")
    opt, res, wall, launches, peak, path = _host_route(
        torch, prob, opts, "chip_smoke_nk.out")
    ip = opt._inner
    niter, reads = res["niter"], ip.syncs.count
    arms = _nk_arms(path)
    used = [a for a in arms if a]
    log(f"{tag} host IP: converged={res['converged']} reason="
        f"{res['reason']!r} iterations {niter} (phase 4 FusedIP "
        f"{fused_iters}, phase 13 host IP {host_iters}); NK steps "
        f"{len(used)}, GMRES arms used {sum(used)} {used}, run (= hvp "
        f"count) {ip.nhvec}; fobj {res['fobj']:.9e}, res_norm "
        f"{res['res_norm']:.3e}")
    log(f"{tag} host IP: wall {wall:.4f} s = {wall / max(niter, 1):.4f} s "
        f"per iteration; {reads} host reads = {reads / max(niter, 1):.1f} "
        f"per iteration; peak memory {peak:.3f} GiB; kernel launches "
        f"{launches}")
    check(res["converged"] and res["res_norm"] < 1e-6,
          f"host NK solve did not converge below 1e-6: {res['reason']!r}, "
          f"res_norm {res['res_norm']:.3e}")
    check(ip.nhvec > 0, "the host IP took no Newton-Krylov step")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched by the host NK "
              f"solve")
    # one further iteration from the converged point: NK engages there
    ip.options["starting_point_strategy"] = "no_start_strategy"
    ip.options["max_major_iters"] = 1
    ip.options["output_file"] = None
    before = ip.nhvec
    window, nops, busy, _ = _profile_call(torch, ip.optimize)
    _log_busy(tag, f"host IP: one further iteration ({ip.nhvec - before} "
              "GMRES arms)", window, nops, busy)

    # FusedIP, phase 4's settings with the NK options
    fused, data, x0, qn0 = _build_solver(torch, N_MAIN, torch.float32,
                                         "cuda", **NK_OPTS)
    steps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    state = fused.solve(x0, data, (), qn0, None,
                        on_chunk=lambda st: steps.append(st.gmres_iters))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    flaunches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    iters = int(state.k)
    arms = [int(a) for a in steps]
    ran = [a for a in arms if a]
    log(f"{tag} FusedIP: converged={bool(state.converged)} iterations "
        f"{iters} (phase 4 {fused_iters}); NK steps {len(ran)}, GMRES arms "
        f"{sum(ran)} {ran} (the unroll runs {fused.opts.gmres_subspace_size}"
        f" per NK step, the arms counted are those before convergence); "
        f"fobj {float(state.fobj):.9e}, res_norm "
        f"{float(state.res_norm):.3e}")
    log(f"{tag} FusedIP: wall {wall:.4f} s = {wall / max(iters, 1):.4f} s "
        f"per iteration; {fused.syncs.count} host reads = "
        f"{fused.syncs.count / max(iters, 1):.2f} per iteration; peak "
        f"memory {peak:.3f} GiB; kernel launches {flaunches}")
    check(bool(state.converged) and float(state.res_norm) < 1e-6,
          f"FusedIP NK solve did not converge (res "
          f"{float(state.res_norm):.3e})")
    check(ran, "FusedIP took no Newton-Krylov step")
    for name, count in flaunches.items():
        check(count > 0, f"kernel {name} was not launched by the FusedIP NK "
              f"solve")
    # one NK step under the profiler: step again to the first NK step
    first = arms.index(ran[0])
    st = fused.init(x0, data, (), qn0, None)
    for _ in range(first):
        st = fused.step(st, data, (), None)
    window, nops, busy, split = _profile_call(
        torch, lambda: fused.step(st, data, (), None),
        ("paropt.kkt_factor", "paropt.kkt_solve_nk", "paropt.eval"))
    _log_busy(tag, f"FusedIP: NK step {first}", window, nops, busy)
    for name, (cnt, dev_ms, host_ms) in split.items():
        log(f"{tag}   {name}: {cnt} device ops, device {dev_ms:.3f} ms, "
            f"host {host_ms:.3f} ms")
    return launches


def phase_nk_crosscheck(torch):
    """Phase 17: the host IP and FusedIP with NK at n = 2^14 in float64,
    card against host."""
    from paropt_torch.models.topology import SyntheticTopology
    out = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        prob = SyntheticTopology(n=1 << 14, block=BLOCK,
                                 dtype=torch.float64, device=dev)
        opt, res, _, _, _, path = _host_route(
            torch, prob, dict(NK_OPTS, algorithm="ip", dtype="float64",
                              abs_res_tol=1e-6, max_major_iters=60),
            f"chip_smoke_nk_{dev}.out")
        fused, data, x0, qn0 = _build_solver(torch, 1 << 14, torch.float64,
                                             dev, **NK_OPTS)
        steps = []
        state = fused.solve(x0, data, (), qn0, None,
                            on_chunk=lambda st: steps.append(
                                int(st.gmres_iters)))
        out[dev] = (res["niter"], _nk_arms(path), opt._inner.nhvec,
                    res["fobj"], int(state.k), steps, float(state.fobj))
        log(f"[nk crosscheck] {dev}: host IP {res['niter']} iterations, "
            f"arms {[a for a in out[dev][1] if a]}, hvp {out[dev][2]}, fobj "
            f"{res['fobj']:.15e}; FusedIP {int(state.k)} steps, arms "
            f"{[a for a in steps if a]}, fobj {float(state.fobj):.15e} "
            f"({time.perf_counter() - t0:.2f} s)")
        check(res["converged"] and bool(state.converged),
              f"{dev}: an NK cross-check solve did not converge")
        check(opt._inner.nhvec > 0 and any(steps),
              f"{dev}: NK did not engage")
    c, h = out["cuda"], out["cpu"]
    check(c[:3] == h[:3], f"host IP: iterations or GMRES arms differ: cuda "
          f"{c[:3]}, cpu {h[:3]}")
    check(c[4:6] == h[4:6], f"FusedIP: steps or GMRES arms differ: cuda "
          f"{c[4:6]}, cpu {h[4:6]}")
    for i in (3, 6):
        check(abs(c[i] - h[i]) <= 1e-9 * abs(h[i]),
              f"objectives differ: cuda {c[i]!r}, cpu {h[i]!r}")


MESH3D = (160, 80, 80)


def _kernels_per_call(torch, fn, reps=20):
    """The device kernels one call of ``fn`` launches.  The profiler can
    drop the first device events of a window, so ``fn`` runs 2·reps times
    in one window with a spin kernel between the halves, and the kernels
    after the spin are counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda._sleep(1000)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not e.name.startswith("paropt.")),
                 key=lambda e: e.time_range.start)
    spins = [i for i, e in enumerate(dev) if "spin" in e.name]
    check(spins, "the profiler recorded no spin kernel")
    return (len(dev) - spins[-1] - 1) / reps


def _time_layouts(torch, prob):
    """K(E)·u per multigrid level in both layouts at the starting design:
    device ms (CUDA events, median of 20), wall ms per call (host clock
    over 20 calls ending in a synchronise: the launches included) and
    device kernels per call, with the layout `auto` takes."""
    from paropt_torch.models import fem_topology3d as f3
    x0, _, _ = prob.get_vars_and_bounds()
    levels, _ = prob._mg_setup(
        prob._simp(prob._filter(x0)).reshape(prob.nex, prob.ney, prob.nez))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    for li, (Eg, _, fixed, cx, cy, cz) in enumerate(levels):
        ug = torch.randn((3, cx + 1, cy + 1, cz + 1), device="cuda",
                         dtype=Eg.dtype, generator=gen)
        fns = {"grid": lambda: f3._kmul_grid(prob.KE, Eg, ug, fixed, True),
               "aos": lambda: f3._kmul_aos(prob.KE, Eg, ug, fixed, True)}
        _, rel = rel_err(torch, fns["grid"](), fns["aos"]())
        check(rel < 1e-5, f"level {li}: the layouts differ by {rel:.3e}")
        row = {"auto": "grid" if prob._use_grid(cz + 1) else "aos"}
        for name, fn in fns.items():
            dev_ms = cuda_ms(torch, fn)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) / 20 * 1e3
            row[name] = (dev_ms, wall_ms, _kernels_per_call(torch, fn))
        log(f"[mma3d layouts] level {li} {cx}x{cy}x{cz} (nnz {cz + 1}): "
            f"grid {row['grid'][0]:.4f} ms device / {row['grid'][1]:.4f} ms "
            f"wall / {row['grid'][2]:g} kernels; aos {row['aos'][0]:.4f} ms "
            f"device / {row['aos'][1]:.4f} ms wall / {row['aos'][2]:g} "
            f"kernels; auto takes {row['auto']}; layouts agree to "
            f"{rel:.1e}")
    log(f"[mma3d layouts] clocks.sm, power.draw, power.limit: "
        f"{smi_sample()}")


MMA3D_ITERS = 12  # phase 18's depth, cut from the flagship's 60


def phase_mma3d_full(torch):
    """Phase 18: FusedMMA on the JAX package's 1M-voxel flagship mesh in
    float32, MMA3D_ITERS outer iterations."""
    from paropt_torch.models.fem_topology3d import FEMTopology3D
    from paropt_torch.ops import kernels
    tag = "[mma3d {}x{}x{} float32]".format(*MESH3D)
    t0 = time.perf_counter()
    prob = FEMTopology3D(*MESH3D, cg_iters=40, solver="mgcg",
                         dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    cx, cy, cz = prob._mg_dims[-1]
    log(f"{tag} {prob.nvars} design variables, {prob.ndof} dofs, "
        f"{len(prob._mg_dims)} multigrid levels (coarsest {cx}x{cy}x{cz}, "
        f"{3 * (cx + 1) * (cy + 1) * (cz + 1)}-dof Cholesky); built in "
        f"{time.perf_counter() - t0:.2f} s")
    t1 = time.perf_counter()
    _time_layouts(torch, prob)
    log(f"{tag} layouts timed in {time.perf_counter() - t1:.2f} s")
    x0, _, _ = prob.get_vars_and_bounds()
    f0 = float(prob.objective(x0))
    E0 = prob._simp(prob._filter(x0))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        prob._solve(E0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"{tag} one state solve ran under set_sync_debug_mode('error')")

    t1 = time.perf_counter()
    warm = _mma_solver(torch, prob, MMA3D_ITERS, "float32")
    warm._step(warm._state0)
    torch.cuda.synchronize()
    log(f"{tag} warm-up outer iteration {time.perf_counter() - t1:.2f} s")
    solver = _mma_solver(torch, prob, MMA3D_ITERS, "float32")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res, state = solver.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    niter, sub = res["niter"], int(state.subiters)
    log(f"{tag} outer iterations {niter}, inner IP iterations {sub}; "
        f"fobj {res['fobj']:.9e} (start {f0:.9e}), infeas "
        f"{res['infeas']:.3e}, l1 {res['l1']:.6e}, linf {res['linfty']:.6e}")
    log(f"{tag} wall {wall:.3f} s = {wall / max(niter, 1):.4f} s per outer "
        f"iteration ({solver.syncs.count} host reads); peak memory "
        f"{peak:.3f} GiB; phase-3 kernel launches {launches}")
    window, nops, busy, split = _profile_outer_step(torch, solver, state)
    _log_busy(tag, "one outer iteration", window, nops, busy)
    for name, (cnt, dev_ms, host_ms) in split.items():
        log(f"{tag}   {name}: {cnt} device ops, device {dev_ms:.3f} ms, "
            f"host {host_ms:.3f} ms")

    x = res["x"]
    check(torch.isfinite(x).all().item() and x.shape == (prob.nvars,),
          "bad final design")
    for key in ("fobj", "infeas", "l1", "linfty"):
        check(math.isfinite(res[key]), f"non-finite {key}")
    check(res["fobj"] < 0.5 * f0, f"fobj {res['fobj']:.4e} >= 0.5 of the "
          f"start {f0:.4e}")
    check(res["infeas"] < 1e-6, f"infeas {res['infeas']:.3e} >= 1e-6")
    check(not any(launches.values()),
          f"a phase-3 kernel ran on the 3-D MMA path: {launches}")
    # the state solve at the final design, checked in float64
    t1 = time.perf_counter()
    E = prob._simp(prob._filter(x))
    u32 = prob._solve(E)
    del solver, warm, state
    p64 = FEMTopology3D(*MESH3D, cg_iters=40, solver="mgcg",
                        dtype=torch.float64, device="cuda")
    u64 = p64._solve(E.double())
    torch.cuda.synchronize()
    log(f"{tag} float64 model and check solve {time.perf_counter() - t1:.2f}"
        f" s")
    relres = _relres(torch, p64, E, u64)
    log(f"{tag} float64 state solve at the final design, cg_iters 40: "
        f"relative residual {relres:.3e}")
    if relres >= 1e-5:
        p64.cg_iters = 80
        u64 = p64._solve(E.double())
        relres = _relres(torch, p64, E, u64)
        log(f"{tag} the check solve alone raised to cg_iters 80: relative "
            f"residual {relres:.3e}")
    check(relres < 1e-5, f"float64 CG relative residual {relres:.3e} >= "
          f"1e-5")
    floor = _relres(torch, p64, E, u64.float())
    c32 = float(prob.f @ u32)
    c64 = float(p64.f @ u64)
    log(f"{tag} float32 state solve: relative residual "
        f"{_relres(torch, p64, E, u32):.3e}; float32 floor (float64 "
        f"solution rounded) {floor:.3e}; float32 compliance {c32:.6e} vs "
        f"float64 {c64:.6e} (rel err {abs(c32 - c64) / abs(c64):.3e})")


def phase_mma3d_bench(torch):
    """Phase 19: bench.py's 3-D MMA configuration as a correctness check."""
    from paropt_torch.models.fem_topology3d import FEMTopology3D
    prob = FEMTopology3D(32, 16, 16, cg_iters=25, solver="mgcg",
                         dtype=torch.float32, device="cuda")
    solver = _mma_solver(torch, prob, 40, "float32")
    t0 = time.perf_counter()
    res, state = solver.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f"[mma3d 32x16x16 float32] outer iterations {res['niter']}, inner "
        f"{int(state.subiters)}, fobj {res['fobj']:.6f}, infeas "
        f"{res['infeas']:.3e}, l1 {res['l1']:.4e}; {wall:.2f} s = "
        f"{wall / max(res['niter'], 1):.4f} s per outer iteration, "
        f"{res['niter'] / wall:.3f} outer iterations/s")
    check(0.08 < res["fobj"] < 0.14,
          f"fobj {res['fobj']:.4f} outside bench.py's band (0.08, 0.14)")
    check(res["infeas"] < 1e-8, f"infeas {res['infeas']:.3e} >= 1e-8")


def phase_3d_crosscheck(torch):
    """Phase 20: the 3-D models in float64, card against host: FusedMMA,
    the host MMA through the facade and FusedTR on FEMTopology3D(8, 4, 4,
    mgcg), FusedMMA on DMOFEMTopology3D(6, 3, 3)."""
    from paropt_torch.models.fem_topology3d import (DMOFEMTopology3D,
                                                    FEMTopology3D)
    from paropt_torch.ops import kernels
    from paropt_torch.utils.logging import unpack_mma_output

    def fem(dev):
        return FEMTopology3D(8, 4, 4, cg_iters=25, solver="mgcg",
                             dtype=torch.float64, device=dev)

    def fused_mma(make, iters):
        def run(dev):
            res, st = _mma_solver(torch, make(dev), iters, "float64").solve()
            return res["fobj"], (res["niter"], int(st.subiters))
        return run

    def host_mma(dev):
        opt, res, _, _, _, path = _host_route(
            torch, fem(dev), {"algorithm": "mma", "mma_max_iterations": 6,
                              "dtype": "float64"},
            f"chip_smoke_cross_mma3d_{dev}.log")
        rows = unpack_mma_output(str(path))
        return res["fobj"], [rows[c].astype(int).tolist()
                             for c in ("iter", "subiter")]

    def fused_tr(dev):
        res, _ = _tr_solver(fem(dev), "float64",
                            tr_max_iterations=3).solve()
        return res["fobj"], (res["niter"], res["subiters"])

    cases = (("FusedMMA fem3d 8x4x4", fused_mma(fem, 6)),
             ("host MMA fem3d 8x4x4", host_mma),
             ("FusedTR fem3d 8x4x4", fused_tr),
             ("FusedMMA dmo3d 6x3x3", fused_mma(
                 lambda dev: DMOFEMTopology3D(6, 3, 3, cg_iters=250,
                                              dtype=torch.float64,
                                              device=dev), 6)))
    for name, run in cases:
        out = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            kernels.reset_launches()
            out[dev] = run(dev)
            log(f"[3d crosscheck] {name} {dev}: fobj {out[dev][0]:.15e}, "
                f"counts {out[dev][1]}, launches {dict(kernels.LAUNCHES)} "
                f"({time.perf_counter() - t0:.2f} s)")
        (fc, ic), (fh, ih) = out["cuda"], out["cpu"]
        check(ic == ih, f"{name}: iteration counts or log columns differ: "
              f"cuda {ic}, cpu {ih}")
        check(abs(fc - fh) <= 1e-9 * abs(fh),
              f"{name}: objectives differ: cuda {fc!r}, cpu {fh!r}")


KB = 4
# phase 3b's second phi_gram shape: phase 22's batch (scripts/bench_batched.py)
PG_SMALL_KB, PG_SMALL_N = 32, 4096


def _starts(torch, x0, k, lo, hi, clip=None, seed=0):
    """k starts: x0 scaled by default_rng(seed).uniform(lo, hi), clipped to
    ``clip`` when given (numpy makes the scales, as the tests do)."""
    import numpy as np
    scale = np.random.default_rng(seed).uniform(lo, hi, (k, x0.shape[0]))
    xs = x0.detach().cpu().double().numpy()[None, :] * scale
    if clip is not None:
        xs = np.clip(xs, *clip)
    return torch.as_tensor(xs, dtype=x0.dtype, device=x0.device)


def phase_kernels_batched(torch, timing):
    """Phase 3b: each kernel's instance-axis launch at kb = 4 over the main
    path's shapes in float32 against the plain version batched (max abs
    error) and against 4 single launches (bit for bit), at kb = 1 against
    the single launch (bit for bit); times of the instance-axis launch, of
    4 single launches and of the plain version batched, and the bound (4
    times the single call's bytes).  phi_gram also at phase 22's shape
    (kb = 32, nwcon = 512): against the plain version batched and bit for
    bit against 32 single launches, both launches timed.  Adds the
    results to ``timing``."""
    from paropt_torch.ops import kernels
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    W = N_MAIN // BLOCK
    B = 2 * MSUB + 1
    f32 = torch.float32

    def held(name, got, want, singles, one, one_want):
        err = max(rel_err(torch, g, w)[0] for g, w in zip(got, want))
        rel = max(rel_err(torch, g, w)[1] for g, w in zip(got, want))
        check(rel <= RTOL["float32"], f"{name} kb={KB}: relative error "
              f"{rel:.3e} > {RTOL['float32']:.0e}")
        for i, single in enumerate(singles):
            check(all(torch.equal(g[i], s) for g, s in zip(got, single)),
                  f"{name} kb={KB}: instance {i} differs from its single "
                  f"launch")
        check(all(torch.equal(g[0], s) for g, s in zip(one, one_want)),
              f"{name} kb=1: differs from the single launch")
        log(f"[kernels kb={KB}] {name}: max abs err {err:.3e} against the "
            f"plain version batched; {KB} instances and kb=1 bitwise equal "
            f"to single launches")
        return err

    def timed(name, batched, singles, plain, nbytes, flops):
        ms = cuda_ms(torch, batched)
        sms = cuda_ms(torch, singles)
        pms = cuda_ms(torch, plain)
        bms, by = bound_ms(nbytes, flops)
        log(f"[kernels kb={KB}] {name}: {ms:.4f} ms instance-axis launch, "
            f"{sms:.4f} ms {KB} single launches, {pms:.4f} ms plain "
            f"batched; bound {bms:.4f} ms by {by} ({nbytes / 1e6:.2f} MB), "
            f"{100 * bms / ms:.1f}% of bound; clocks.sm, power.draw, "
            f"power.limit: {smi_sample()}")
        return {"batched_ms": ms, "singles_ms": sms, "batched_plain_ms": pms,
                "batched_bound_ms": bms}

    buf = torch.randn((KB, 2 * MSUB, N_MAIN), device="cuda", dtype=f32,
                      generator=gen)
    s = torch.randn((KB, N_MAIN), device="cuda", dtype=f32, generator=gen)
    y = torch.randn((KB, N_MAIN), device="cuda", dtype=f32, generator=gen)
    upd = torch.tensor([True, False, True, True], device="cuda")
    got = kernels.qn_roll_update_batched(buf, s, y, upd)
    err = held("qn_roll_update", got,
               kernels.qn_roll_update_plain_batched(buf, s, y, upd),
               [kernels.qn_roll_update(buf[i], s[i], y[i], upd[i])
                for i in range(KB)],
               kernels.qn_roll_update_batched(buf[:1], s[:1], y[:1],
                                              upd[:1]),
               kernels.qn_roll_update(buf[0], s[0], y[0], upd[0]))
    r = timing["qn_roll_update"]
    r["batched_max_abs_err"] = err
    r.update(timed(
        "qn_roll_update", lambda: kernels.qn_roll_update_batched(
            buf, s, y, upd),
        lambda: [kernels.qn_roll_update(buf[i], s[i], y[i], upd[i])
                 for i in range(KB)],
        lambda: kernels.qn_roll_update_plain_batched(buf, s, y, upd),
        _nbytes(buf, s, y, upd, *got), KB * 4 * 2 * MSUB * N_MAIN))
    del buf, s, y, got

    # the quasi-definite apply at K = 1 with vals shared (stride 0), as a
    # batched solve passes it
    per = [_qd_inputs(torch, gen, 1, BLOCK, W, f32) for _ in range(KB)]
    ops = [torch.stack([p[j] for p in per]) for j in range(5)]
    ops[2] = ops[2][0].expand(KB, BLOCK, W)
    got = kernels.quasi_def_apply_batched(*ops)
    err = held("quasi_def_apply K=1", got,
               kernels.quasi_def_apply_plain_batched(*ops),
               [kernels.quasi_def_apply(*(o[i] for o in ops))
                for i in range(KB)],
               kernels.quasi_def_apply_batched(*(o[:1] for o in ops)),
               kernels.quasi_def_apply(*(o[0] for o in ops)))
    r = timing["quasi_def_apply"]
    r["batched_max_abs_err"] = err
    r.update(timed(
        "quasi_def_apply K=1",
        lambda: kernels.quasi_def_apply_batched(*ops),
        lambda: [kernels.quasi_def_apply(*(o[i] for o in ops))
                 for i in range(KB)],
        lambda: kernels.quasi_def_apply_plain_batched(*ops),
        _nbytes(ops[0], ops[1], ops[2][0], ops[3], ops[4], *got),
        KB * W * (6 * BLOCK + 2)))

    # phi_gram as the factor setup calls it: [Z_qn; A] as two row blocks,
    # bw = 0, vals shared
    per = [_qd_inputs(torch, gen, B, BLOCK, W, f32) for _ in range(KB)]
    dinv, cwinv, vals, bx = (torch.stack([p[j] for p in per])
                             for j in range(4))
    vals = vals[0].expand(KB, BLOCK, W)
    args = (dinv, cwinv, vals, bx[:, :2 * MSUB], None, bx[:, 2 * MSUB:])

    def pick(i):
        return [None if a is None else a[i] for a in args]

    got = kernels.phi_gram_batched(*args)
    err = held("phi_gram B=21", got, kernels.phi_gram_plain_batched(*args),
               [kernels.phi_gram(*pick(i)) for i in range(KB)],
               kernels.phi_gram_batched(*(None if a is None else a[:1]
                                          for a in args)),
               kernels.phi_gram(*pick(0)))
    r = timing["phi_gram"]
    r["batched_max_abs_err"] = err
    r.update(timed(
        "phi_gram B=21", lambda: kernels.phi_gram_batched(*args),
        lambda: [kernels.phi_gram(*pick(i)) for i in range(KB)],
        lambda: kernels.phi_gram_plain_batched(*args),
        _nbytes(dinv, cwinv, vals[0], bx, *got),
        KB * (2 * B * B * BLOCK * W + B * W * (6 * BLOCK + 2))))

    # phi_gram at phase 22's shape: kb = 32 instances of n = 4096 (nwcon =
    # 512, 16 tiles each), as above
    kb, W = PG_SMALL_KB, PG_SMALL_N // BLOCK
    per = [_qd_inputs(torch, gen, B, BLOCK, W, f32) for _ in range(kb)]
    dinv, cwinv, vals, bx = (torch.stack([p[j] for p in per])
                             for j in range(4))
    vals = vals[0].expand(kb, BLOCK, W)
    args = (dinv, cwinv, vals, bx[:, :2 * MSUB], None, bx[:, 2 * MSUB:])
    got = kernels.phi_gram_batched(*args)
    want = kernels.phi_gram_plain_batched(*args)
    err = max(rel_err(torch, g, w)[0] for g, w in zip(got, want))
    rel = max(rel_err(torch, g, w)[1] for g, w in zip(got, want))
    check(rel <= RTOL["float32"], f"phi_gram kb={kb} nwcon={W}: relative "
          f"error {rel:.3e} > {RTOL['float32']:.0e}")
    for i in range(kb):
        check(all(torch.equal(g[i], s) for g, s in zip(
            got, kernels.phi_gram(*pick(i)))), f"phi_gram kb={kb} "
            f"nwcon={W}: instance {i} differs from its single launch")
    ms = cuda_ms(torch, lambda: kernels.phi_gram_batched(*args))
    # 5 runs of 32 single launches: the timer enqueues every run while a
    # spin holds the stream, and 20 runs of 64 kernels would fill the
    # stream's queue of pending launches, which makes the host wait
    sms = cuda_ms(torch, lambda: [kernels.phi_gram(*pick(i))
                                  for i in range(kb)], reps=5)
    bms, by = bound_ms(_nbytes(dinv, cwinv, vals[0], bx, *got),
                       kb * (2 * B * B * BLOCK * W + B * W * (6 * BLOCK + 2)))
    log(f"[kernels kb={kb}] phi_gram B={B} nwcon={W}: max abs err {err:.3e} "
        f"against the plain version batched; {kb} instances bitwise equal "
        f"to single launches; {ms:.4f} ms instance-axis launch, {sms:.4f} "
        f"ms {kb} single launches; bound {bms:.4f} ms by {by}, "
        f"{100 * bms / ms:.1f}% of bound; clocks.sm, power.draw, "
        f"power.limit: {smi_sample()}")
    r.update(kb32_ms=ms, kb32_singles_ms=sms, kb32_bound_ms=bms)


def _perturbed(torch, x, seed=5):
    """x with every entry moved by a relative 1e-7 (uniform in [0, 1e-7)):
    a start that differs from x by roundoff, to measure how far a float32
    solve moves under roundoff alone."""
    g = torch.Generator(device=x.device).manual_seed(seed)
    return x * (1 + 1e-7 * torch.rand(x.shape, generator=g, device=x.device,
                                      dtype=x.dtype))


def _rel(a, b):
    return abs(a - b) / abs(b)


def phase_batched_ip(torch):
    """Batched IP at full width: k = 4 starts of the main path's problem.
    float32 (the main path): every instance converges below 1e-6, every
    launch has the instance axis and one batched step launches each kernel
    as often as one single step; each instance is printed beside its own
    single solve and beside a single solve from its start moved by 1e-7
    (float32's roundoff floor on this solve).  float64 at the same width:
    each instance within one iteration of its own single solve and fobj
    within 1e-5.  Returns the float32 batch's launches."""
    from paropt_torch import ip_fused as tip
    from paropt_torch.ops import kernels
    from paropt_torch.tree import take
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        tag = f"[batched ip k={KB} n={N_MAIN} {name}]"
        fused, data, x0, qn0 = _build_solver(torch, N_MAIN, dtype, "cuda")
        x0s = _starts(torch, x0, KB, 0.5, 1.5)
        fused.solve_batched(x0s, data, (), qn0, max_iters=2)    # warm-up
        singles = []
        for i in range(KB):
            fused.syncs.count = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = fused.solve(x0s[i], data, (), qn0)
            torch.cuda.synchronize()
            singles.append((int(st.k), float(st.fobj),
                            time.perf_counter() - t0, fused.syncs.count,
                            bool(st.converged)))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fused.syncs.count = 0
        kernels.reset_launches()
        t0 = time.perf_counter()
        st = fused.solve_batched(x0s, data, (), qn0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        batched = dict(kernels.BATCHED_LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        steps = int(st.k.max()) + 1          # the converging turn freezes
        reads = fused.syncs.count
        s_steps = sum(k + 1 for k, *_ in singles)
        s_reads = sum(r for *_, r, _ in singles)
        s_wall = sum(t for _, _, t, _, _ in singles)
        fobj = st.fobj.tolist()
        log(f"{tag} iterations {st.k.tolist()} (single solves "
            f"{[k for k, *_ in singles]}), converged "
            f"{st.converged.tolist()}, res_norm "
            f"{[f'{r:.3e}' for r in st.res_norm.tolist()]}")
        log(f"{tag} fobj {[f'{f:.12e}' for f in fobj]} (single "
            f"{[f'{f:.12e}' for _, f, *_ in singles]})")
        log(f"{tag} wall {wall:.4f} s = {wall / steps * 1e3:.2f} ms per "
            f"batched step ({steps} steps); {KB} single solves "
            f"{s_wall:.4f} s = {s_wall / s_steps * 1e3:.2f} ms per step; "
            f"host reads {reads / steps:.2f} per batched step, "
            f"{s_reads / s_steps:.2f} per single step; peak memory "
            f"{peak:.3f} GiB")
        log(f"{tag} kernel launches {launches}, of them instance-axis "
            f"{batched}")
        check(bool(torch.all(st.converged)), "a batched instance did not "
              "converge")
        check(float(torch.max(st.res_norm)) < 1e-6,
              f"res_norm {float(torch.max(st.res_norm)):.3e} >= 1e-6")
        check(torch.isfinite(st.vars.x).all().item()
              and st.vars.x.shape == (KB, N_MAIN), "bad final x")
        for nm, count in launches.items():
            check(count > 0 and batched[nm] == count,
                  f"kernel {nm}: {count} launches, {batched[nm]} with the "
                  f"instance axis")
        if dtype == torch.float64:
            for i, (k, f, _, _, conv) in enumerate(singles):
                check(conv, f"single solve {i} did not converge")
                check(abs(int(st.k[i]) - k) <= 1, f"instance {i}: "
                      f"{int(st.k[i])} iterations against {k} single")
                check(_rel(fobj[i], f) <= 1e-5, f"instance {i}: fobj "
                      f"{fobj[i]!r} against {f!r}")
            continue
        # float32: the roundoff floor, and one profiled batched step
        moved = [fused.solve(_perturbed(torch, x0s[i]), data, (), qn0)
                 for i in range(KB)]
        log(f"{tag} against the single solves: iterations "
            f"{[int(st.k[i]) - k for i, (k, *_) in enumerate(singles)]}, "
            f"fobj rel {[f'{_rel(fobj[i], f):.1e}' for i, (_, f, *_) in enumerate(singles)]}; "
            f"single solves from starts moved by 1e-7: iterations "
            f"{[int(m.k) - k for m, (k, *_) in zip(moved, singles)]}, fobj "
            f"rel {[f'{_rel(float(m.fobj), f):.1e}' for m, (_, f, *_) in zip(moved, singles)]}")
        out = batched
        mid = fused.solve_batched(x0s, data, (), qn0, max_iters=10)
        run = tip._Run(fused.syncs, batched=True)

        def step():
            return tip._fused_step(fused.model, fused.opts, mid, data, (),
                                   None, run=run)

        window, nops, busy, _ = _profile_call(torch, step)
        _log_busy(tag, "one batched step (from step 10)", window, nops, busy)
        kernels.reset_launches()
        step()
        per_batched = dict(kernels.LAUNCHES)
        kernels.reset_launches()
        fused.step(take(mid, 0), data, (), None)
        per_single = dict(kernels.LAUNCHES)
        log(f"{tag} launches in one step: batched {per_batched}, single "
            f"{per_single}")
        check(per_batched == per_single, "a batched step launches the "
              "kernels a different number of times than a single step")
    return out


def phase_batched_small(torch):
    """scripts/bench_batched.py's defaults (n = 4096, k = 32, tol 1e-4,
    float32 on the card): the batched solve against 32 sequential single
    solves, wall time both ways.  The ratio is recorded, not claimed."""
    n, k, tol = 4096, 32, 1e-4
    tag = f"[batched ip k={k} n={n} float32]"
    fused, data, x0, qn0 = _build_solver(torch, n, torch.float32, "cuda",
                                         abs_res_tol=tol,
                                         iterative_refinement_steps=1)
    x0s = _starts(torch, x0, k, 0.5, 1.5)
    fused.solve_batched(x0s, data, (), qn0, max_iters=2)    # warm-up
    fused.solve(x0s[0], data, (), qn0, max_iters=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = fused.solve_batched(x0s, data, (), qn0)
    torch.cuda.synchronize()
    tb = time.perf_counter() - t0
    t0 = time.perf_counter()
    seq = [fused.solve(x0s[i], data, (), qn0) for i in range(k)]
    torch.cuda.synchronize()
    ts = time.perf_counter() - t0
    conv_s = [bool(s.converged) for s in seq]
    iters_s = [int(s.k) for s in seq]
    log(f"{tag} batched {tb:.3f} s (converged "
        f"{int(st.converged.sum())}/{k}, iterations max "
        f"{int(st.k.max())}) vs {k} sequential {ts:.3f} s (converged "
        f"{sum(conv_s)}/{k}, iterations max {max(iters_s)}, total "
        f"{sum(iters_s)}): sequential / batched = {ts / tb:.2f}")
    check(torch.isfinite(st.fobj).all().item(), "non-finite batched fobj")
    check(st.converged.tolist() == conv_s,
          "batched and sequential solves disagree on convergence")
    for i, s in enumerate(seq):
        check(abs(float(st.fobj[i]) - float(s.fobj))
              <= 1e-5 * abs(float(s.fobj)),
              f"instance {i}: fobj {float(st.fobj[i])!r} against "
              f"{float(s.fobj)!r}")


def _mma_single(solver, x):
    import dataclasses
    return solver.solve(dataclasses.replace(solver._state0, x=x, x1=x, x2=x))


def _tr_single(solver, x):
    import dataclasses
    f0, c0, cw0 = solver._ev((), x)
    g0, A0 = solver._gr((), x)
    return solver.solve(dataclasses.replace(
        solver._state0, xk=x, fk=f0, ck=c0, gk=g0, Ak=A0, cwk=cw0))


def _batch_and_one(torch, tag, make_solver, single, x0s, i):
    """A batched solve of the starts x0s and the single solve of start i:
    (batched results, states, single result, single state, the batch's
    launches and instance-axis launches), with times and reads printed."""
    from paropt_torch.ops import kernels
    solver = make_solver()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res, states = solver.solve_batched(x0s)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = dict(kernels.LAUNCHES)
    batched = dict(kernels.BATCHED_LAUNCHES)
    one = make_solver()
    t0 = time.perf_counter()
    r1, s1 = single(one, x0s[i])
    torch.cuda.synchronize()
    ws = time.perf_counter() - t0
    niter = int(res["niter"].max())
    log(f"{tag} outer iterations {res['niter'].tolist()}, inner "
        f"{states.subiters.tolist()}, converged "
        f"{res['converged'].tolist()}, fobj {res['fobj'].tolist()}, infeas "
        f"{res['infeas'].tolist()}, linf {res['linfty'].tolist()}")
    log(f"{tag} wall {wall:.3f} s = {wall / niter:.4f} s per batched outer "
        f"iteration ({solver.syncs.count / niter:.1f} host reads each); "
        f"instance {i} alone {ws / max(r1['niter'], 1):.4f} s per outer "
        f"iteration ({one.syncs.count / max(r1['niter'], 1):.1f} reads), "
        f"niter {r1['niter']}, inner {int(s1.subiters)}, fobj "
        f"{r1['fobj']:.12e}; peak memory {peak:.3f} GiB; launches "
        f"{launches}, of them instance-axis {batched}")
    import numpy as np
    check(np.isfinite(res["fobj"]).all(), "non-finite fobj")
    check(launches == batched, "a launch without the instance axis")
    return res, states, r1, launches


def _held(tag, res, r1, i, rtol):
    check(int(res["niter"][i]) == r1["niter"], f"{tag} instance {i}: "
          f"{res['niter'][i]} outer iterations against {r1['niter']}")
    check(_rel(float(res["fobj"][i]), r1["fobj"]) <= rtol,
          f"{tag} instance {i}: fobj {float(res['fobj'][i])!r} against "
          f"{r1['fobj']!r}")
    log(f"{tag} instance {i} equals its single solve: niter "
        f"{r1['niter']}, fobj rel {_rel(float(res['fobj'][i]), r1['fobj']):.1e}")


def _f32_floor(tag, res, r1, moved, i):
    log(f"{tag} instance {i} against its single solve: niter "
        f"{int(res['niter'][i]) - r1['niter']:+d}, fobj rel "
        f"{_rel(float(res['fobj'][i]), r1['fobj']):.1e}; the single solve "
        f"from its start moved by 1e-7: niter {moved['niter'] - r1['niter']:+d}"
        f", fobj rel {_rel(moved['fobj'], r1['fobj']):.1e}")


def phase_batched_mma(torch):
    """Batched FusedMMA at full width: k = 4 starts on FEMTopology(768,
    384, mgcg), clipped to [0.05, 0.95] from uniform(0.6, 1.4).  float32,
    6 outer iterations (a depth cut): infeasibility < 1e-6 for every
    instance, no kernel launched, instance 1 printed beside its single
    solve and float32's roundoff floor.  float64, 3 outer iterations:
    instance 1 equals its single solve (niter, fobj within 1e-5)."""
    from paropt_torch.models.fem_topology import FEMTopology
    # float32 at 6 outer iterations (a depth cut from 20)
    for dtype, iters in ((torch.float32, 6), (torch.float64, 3)):
        name = str(dtype).split(".")[1]
        tag = f"[batched mma k={KB} 768x384 {name}]"
        prob = FEMTopology(768, 384, cg_iters=25, solver="mgcg",
                           dtype=dtype, device="cuda")
        x0, _, _ = prob.get_vars_and_bounds()
        x0s = _starts(torch, x0, KB, 0.6, 1.4, clip=(0.05, 0.95))

        def make():
            return _mma_solver(torch, prob, iters, name)

        res, _, r1, launches = _batch_and_one(torch, tag, make, _mma_single,
                                              x0s, 1)
        check((res["infeas"] < 1e-6).all(), f"infeas {res['infeas']} >= "
              f"1e-6")
        check(not any(launches.values()),
              f"a phase-3 kernel ran on the MMA/FEM path: {launches}")
        if dtype == torch.float64:
            _held(tag, res, r1, 1, 1e-5)
        else:
            moved, _ = _mma_single(make(), _perturbed(torch, x0s[1]))
            _f32_floor(tag, res, r1, moved, 1)


def phase_batched_tr(torch):
    """Batched FusedTR with k = 4: phase 9's configuration (n = 2^20,
    float32: every instance converged, all three kernels launched, each
    with the instance axis, instance 2 equal to its single solve in niter
    and fobj within 1e-5), and bench.py's FEM 48x24 as
    examples/fem_topology_tr.py runs it (float32, 4 outer iterations:
    only qn_roll_update, instance 2 printed beside its single solve and
    float32's roundoff floor; float64, 3 outer iterations: instance 2
    equal to its single solve, fobj within 1e-5).  Returns the n = 2^20
    batch's launches."""
    from paropt_torch.models.fem_topology import FEMTopology
    from paropt_torch.models.topology import SyntheticTopology
    tag = f"[batched tr k={KB} n={N_MAIN} float32]"
    prob = SyntheticTopology(n=N_MAIN, block=BLOCK, dtype=torch.float32,
                             device="cuda")
    x0, _, _ = prob.get_vars_and_bounds()
    res, _, r2, out = _batch_and_one(
        torch, tag, lambda: _tr_solver(prob, "float32"), _tr_single,
        _starts(torch, x0, KB, 0.5, 1.5), 2)
    check(res["converged"].all() and (res["infeas"] < 1e-5).all()
          and (res["linfty"] < 1e-5).all(),
          "a batched TR instance did not converge")
    for k, count in out.items():
        check(count > 0, f"kernel {k} was not launched")
    _held(tag, res, r2, 2, 1e-5)
    # 4 and 3 outer iterations (a depth cut, from 6 and 4)
    for dtype, iters in ((torch.float32, 4), (torch.float64, 3)):
        name = str(dtype).split(".")[1]
        tag = f"[batched tr k={KB} fem 48x24 {name}]"
        prob = FEMTopology(48, 24, cg_iters=25, solver="mgcg", dtype=dtype,
                           device="cuda")
        x0, _, _ = prob.get_vars_and_bounds()
        x0s = _starts(torch, x0, KB, 0.6, 1.4, clip=(0.05, 0.95))

        def make():
            return _tr_solver(prob, name, tr_max_iterations=iters)

        res, _, r2, launches = _batch_and_one(torch, tag, make, _tr_single,
                                              x0s, 2)
        check(launches["qn_roll_update"] > 0
              and launches["quasi_def_apply"] == launches["phi_gram"] == 0,
              f"unexpected launches on the FEM TR path: {launches}")
        if dtype == torch.float64:
            _held(tag, res, r2, 2, 1e-5)
        else:
            moved, _ = _tr_single(make(), _perturbed(torch, x0s[2]))
            _f32_floor(tag, res, r2, moved, 2)
    return out


def phase_batched_crosscheck(torch):
    """The three batched solves at the CPU tests' sizes in float64 (depths
    cut: the IP to 60 steps, the MMA and TR to 6 and 4 outer iterations),
    on the card and on the host: equal counts, fobj within 1e-12
    relative, per instance."""
    from paropt_torch import ip_fused as tip
    from paropt_torch.models.fem_topology import FEMTopology
    from paropt_torch.models.topology import SyntheticTopology
    from paropt_torch.mma import FusedMMA
    from paropt_torch.ops import qn as qnmod
    from paropt_torch.tr import FusedTR
    f64 = torch.float64

    def ip(dev):
        prob = SyntheticTopology(n=256, block=8, dtype=f64, device=dev)
        fused = tip.FusedIP(tip.model_from_problem(prob), 256, 1, prob.nwcon,
                            1, tip.FusedIPOptions(
                                use_quasi_newton_update=True,
                                abs_res_tol=1e-5, max_major_iters=60),
                            dtype=f64)
        data, x0 = tip.data_template_from_problem(prob, dtype=f64)
        st = fused.solve_batched(_starts(torch, x0, 3, 0.4, 1.6), data, (),
                                 qnmod.qn_init(5, 256, dtype=f64,
                                               device=dev))
        return st.k.tolist(), st.fobj.tolist()

    def fem(dev):
        return FEMTopology(8, 4, cg_iters=200, dtype=f64, device=dev)

    def mma(dev):
        prob = fem(dev)
        x0, _, _ = prob.get_vars_and_bounds()
        res, st = FusedMMA(prob, {"mma_max_iterations": 6,
                                  "mma_output_file": None}).solve_batched(
            _starts(torch, x0, 3, 0.6, 1.4, clip=(0.05, 0.95)))
        return ([*res["niter"].tolist(), *st.subiters.tolist()],
                res["fobj"].tolist())

    def tr(dev):
        prob = fem(dev)
        x0, _, _ = prob.get_vars_and_bounds()
        res, st = FusedTR(prob, {
            "tr_output_file": None, "output_file": None,
            "tr_max_iterations": 4, "abs_res_tol": 1e-7,
            "tr_infeas_tol": 1e-5, "tr_l1_tol": 0.0,
            "tr_linfty_tol": 1e-5}).solve_batched(
            _starts(torch, x0, 3, 0.6, 1.4, clip=(0.05, 0.95), seed=1))
        return ([*res["niter"].tolist(), *st.subiters.tolist()],
                res["fobj"].tolist())

    for name, fn in (("ip synthetic 256", ip), ("mma fem 8x4", mma),
                     ("tr fem 8x4", tr)):
        out = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            out[dev] = fn(dev)
            log(f"[batched crosscheck] {name} {dev}: counts {out[dev][0]}, "
                f"fobj {[f'{f:.15e}' for f in out[dev][1]]} "
                f"({time.perf_counter() - t0:.2f} s)")
        (kc, fc), (kh, fh) = out["cuda"], out["cpu"]
        check(kc == kh, f"{name}: counts differ: cuda {kc}, cpu {kh}")
        for a, b in zip(fc, fh):
            check(abs(a - b) <= 1e-12 * abs(b),
                  f"{name}: objectives differ: cuda {a!r}, cpu {b!r}")


# --- the eigenvalue path (phases 26-28) -----------------------------------

EIG3D_MESH = (64, 32, 32)
EIG3D_ITERS = 3     # phase 26's depth, cut from the flagship's 40
# block iterations of phase 26's float64 reference eigensolves: two
# depths, which must agree to F64_SETTLED (the reference has settled)
EIG3D_F64_ITERS = (2, 4)
F64_SETTLED = 1e-5
EIG_BENCH_MESH = (24, 12)
EIG_RANGES = ("paropt.eig.lobpcg",) + TR_RANGES
# bench.py:290-297's eigen-TR options
EIG_OPTS = {"tr_output_file": None, "output_file": None,
            "tr_max_iterations": 20, "tr_init_size": 0.05,
            "tr_max_size": 0.2, "tr_min_size": 1e-6, "abs_res_tol": 1e-8,
            "tr_l1_tol": 1e-4, "tr_linfty_tol": 1e-4,
            "tr_adaptive_gamma_update": True, "penalty_gamma": 10.0}
NO_QD_REASON = ("the frequency problems have no sparse constraints (nwcon "
                "= 0): the inner solves factor the one dense row and the "
                "merged compact term, with no blocked_t quasi-definite "
                "solve for quasi_def_apply or phi_gram")


def phase_eig3d_full(torch):
    """Phase 26: FusedEigenTR on the JAX package's 3-D eigen flagship in
    float32, EIG3D_ITERS outer iterations, each one call of
    ``solve(state0=..., jit_loop=False)`` resuming the last (one more outer
    iteration per call under tr_max_iterations 1); returns the kernel launches of
    those iterations and the seconds per outer iteration."""
    from paropt_torch.models.fem_frequency import FrequencyTopology3D
    from paropt_torch.ops import kernels
    tag = "[eig3d {}x{}x{} N=6 float32]".format(*EIG3D_MESH)
    t_phase = time.perf_counter()
    prob = FrequencyTopology3D(*EIG3D_MESH, N=6, cg_iters=30,
                               solver="mgcg", lobpcg_iters=60,
                               dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    build = time.perf_counter() - t_phase
    scale = prob.ks_rho / prob.lam_target ** 2
    log(f"{tag} {prob.nvars} design variables, {prob.fem.ndof} dofs; built "
        f"in {build:.2f} s with the lam_target calibration eigensolve of "
        f"{prob.lobpcg_iters_log[0]} LOBPCG block iterations; ks_rho / "
        f"lam_target^2 = {scale:.4e} (paropt_tpu's run: 5.37e10)")
    solves = []                     # (x, lam, V) of every eigensolve
    eig_fn = prob._eig_fn

    def recorded(x, V0=None):
        lam, W, V = eig_fn(x, V0)
        solves.append((x, lam, V))
        return lam, W, V

    prob._eig_fn = recorded
    t1 = time.perf_counter()
    solver = prob.build_fused_tr({"tr_max_iterations": 1,
                                  "dtype": "float32", "output_file": None,
                                  "tr_output_file": None})
    torch.cuda.synchronize()
    log(f"{tag} FusedEigenTR built in {time.perf_counter() - t1:.2f} s, "
        f"its start eigensolve (cold) {prob.lobpcg_iters_log[-1]} block "
        f"iterations")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    reads0, solves0 = solver.syncs.count, len(prob.lobpcg_iters_log)
    state, fobjs, finite, rhos = None, [], [], []
    t0 = time.perf_counter()
    for _ in range(EIG3D_ITERS):
        res, state = solver.solve(state0=state, jit_loop=False)
        fobjs.append(res["fobj"])
        rhos.append(state.rho)
        finite.append(torch.isfinite(res["x"]).all() & torch.isfinite(
            state.rho) & torch.isfinite(state.fk))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    reads = solver.syncs.count - reads0
    warm = prob.lobpcg_iters_log[solves0:]
    log(f"{tag} {res['niter']} outer iterations, {res['subiters']} inner IP "
        f"iterations; fobj {' '.join(f'{f:.6f}' for f in fobjs)} (start "
        f"1.0), rho {' '.join(f'{float(r):.4g}' for r in rhos)}; infeas "
        f"{res['infeas']:.3e}, l1 {res['l1']:.4e}, linf "
        f"{res['linfty']:.4e}, tr_size {res['tr_size']:.4e}")
    log(f"{tag} wall {wall:.3f} s = {wall / EIG3D_ITERS:.4f} s per outer "
        f"iteration; LOBPCG block iterations per eigensolve: cold "
        f"{prob.lobpcg_iters_log[:2]}, warm {warm}; {reads} host reads = "
        f"{reads / EIG3D_ITERS:.1f} per outer iteration; peak memory "
        f"{peak:.3f} GiB; kernel launches {launches}")
    window, nops, busy, split = _profile_call(
        torch, lambda: solver._step(state), EIG_RANGES)
    _log_busy(tag, "one further outer iteration", window, nops, busy)
    for name, (cnt, dev_ms, host_ms) in split.items():
        log(f"{tag}   {name}: {cnt} device ops, device {dev_ms:.3f} ms, "
            f"host {host_ms:.3f} ms")
    for i, ok in enumerate(finite):
        check(bool(ok), f"outer iteration {i + 1}: a non-finite iterate, "
              f"fobj or rho (the float32 _minv_floor failure mode)")
    check(res["niter"] == EIG3D_ITERS, f"{res['niter']} outer iterations, "
          f"not {EIG3D_ITERS}")
    check(fobjs[-1] < 1.0, f"fobj {fobjs[-1]:.6f} not below its start 1.0")
    check(launches["qn_roll_update"] == EIG3D_ITERS,
          f"qn_roll_update launched {launches['qn_roll_update']} times in "
          f"{EIG3D_ITERS} outer iterations")
    check(launches["quasi_def_apply"] == launches["phi_gram"] == 0,
          f"a quasi-definite kernel ran on the eigen path: {launches}")
    log(f"{tag} qn_roll_update once per outer iteration (the outer QN "
        f"update); quasi_def_apply and phi_gram 0 times: {NO_QD_REASON}")
    _eig3d_f64_reference(torch, prob, solves[:2],
                         float(solver._state0.gamma[0]), solver._to.eta,
                         float(rhos[0]))
    log(f"{tag} phase 26 took {time.perf_counter() - t_phase:.2f} s")
    return launches, wall / EIG3D_ITERS


def _ks(lam, lam_t, ks_rho):
    """The frequency models' KS aggregate of the gaps (lam_i - lam_t) /
    lam_t, in float64 on the host."""
    g = [(v - lam_t) / lam_t for v in lam]
    gmin = min(g)
    return gmin - math.log(sum(math.exp(-ks_rho * (v - gmin))
                               for v in g)) / ks_rho


def _eig3d_f64_reference(torch, prob, solves, gamma, eta, rho1):
    """Phase 26's first outer iteration priced again in float64 at the
    same two points, x0 and the first trial: each eigensolve starts from
    the float32 run's basis there and runs a fixed number of block
    iterations, once for each depth of EIG3D_F64_ITERS.  The float64
    model prices the float32 run's constraint (its lam_target); rho in
    float64 divides the float64 merit reduction by the first QP's model
    reduction, recovered from the float32 rho.  Prints the eigenvalues, KS values and rho both ways;
    checks that the float64 eigenvalues have settled and that float64
    accepts or rejects the trial as float32 did."""
    from paropt_torch.models.fem_frequency import FrequencyTopology3D
    tag = "[eig3d float64 reference]"
    t0 = time.perf_counter()
    # its own calibration (one block iteration) is replaced by the
    # float32 run's target
    p64 = FrequencyTopology3D(*EIG3D_MESH, N=6, cg_iters=30, solver="mgcg",
                              lobpcg_iters=1, dtype=torch.float64,
                              device="cuda")
    p64.lam_target = prob.lam_target
    lt, kr = prob.lam_target, prob.ks_rho

    def actual(x_pair, lams):
        # the merit reduction: mass, plus gamma times the inequality's
        # violation max(0, -ks)
        fs = [float(x) for x in x_pair]
        viol = [max(0.0, -_ks(lam, lt, kr)) for lam in lams]
        return (fs[0] - fs[1]) + gamma * (viol[0] - viol[1])

    lam32 = [lam.double().tolist() for _, lam, _ in solves]
    ks32 = [_ks(lam, lt, kr) for lam in lam32]
    actual32 = actual([prob.objective(x) for x, _, _ in solves], lam32)
    model = actual32 / rho1
    f64 = [p64.objective(x.double()) for x, _, _ in solves]
    log(f"{tag} float32: lam at x0 {lam32[0]}, at the trial {lam32[1]}; KS "
        f"{ks32[0]:.6e} -> {ks32[1]:.6e}; rho {rho1:.6e} = the actual "
        f"reduction {actual32:.6e} / the model reduction {model:.6e} "
        f"(float64 model built in {time.perf_counter() - t0:.2f} s)")
    last = None
    for iters in EIG3D_F64_ITERS:
        p64.lobpcg_iters = iters
        t1 = time.perf_counter()
        lam64 = [p64._eig_fn(x.double(), V.double())[0].tolist()
                 for x, _, V in solves]
        ks64 = [_ks(lam, lt, kr) for lam in lam64]
        actual64 = actual(f64, lam64)
        rho64 = actual64 / model
        rel = max(abs(a - b) / b for l32, l64 in zip(lam32, lam64)
                  for a, b in zip(l32, l64))
        log(f"{tag} {iters} block iterations from the float32 basis "
            f"({time.perf_counter() - t1:.2f} s for both points): lam at x0 "
            f"{lam64[0]}, at the trial {lam64[1]}; KS {ks64[0]:.6e} -> "
            f"{ks64[1]:.6e}; rho {rho64:.6e} (the actual reduction "
            f"{actual64:.6e}); largest relative eigenvalue "
            f"gap to float32 {rel:.3e}")
        check(all(math.isfinite(v) and v > 0 for lam in lam64 for v in lam),
              f"{tag}: a non-finite or non-positive eigenvalue")
        if last is not None:
            moved = max(abs(a - b) / b for l0, l1 in zip(last, lam64)
                        for a, b in zip(l0, l1))
            check(moved <= F64_SETTLED, f"{tag}: the float64 eigenvalues "
                  f"moved by {moved:.3e} > {F64_SETTLED:.0e} between "
                  f"depths: not settled")
        last = lam64
    check((rho64 >= eta) == (rho1 >= eta),
          f"{tag}: float64 rho {rho64:.4g} and float32 rho {rho1:.4g} "
          f"decide the trial differently (eta {eta})")
    log(f"{tag} took {time.perf_counter() - t0:.2f} s")


def phase_eig_bench(torch):
    """Phase 27: bench.py's eigen-TR configuration as a correctness
    check."""
    from paropt_torch.models.fem_frequency import FrequencyTopology
    from paropt_torch.ops import kernels
    t_phase = time.perf_counter()
    prob = FrequencyTopology(*EIG_BENCH_MESH, N=4, cg_iters=25,
                             solver="mgcg", lobpcg_iters=50,
                             dtype=torch.float32, device="cuda")
    solver = prob.build_fused_tr(dict(EIG_OPTS, dtype="float32"))
    kernels.reset_launches()
    t0 = time.perf_counter()
    res, _ = solver.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    log(f"[eigtr 24x12 float32] outer iterations {res['niter']}, inner "
        f"{res['subiters']}, fobj {res['fobj']:.6f}, infeas "
        f"{res['infeas']:.3e} (paropt_tpu's 20-iteration window on its "
        f"TPU: 6.9e-4), l1 {res['l1']:.4e}, linf {res['linfty']:.4e}; "
        f"{wall:.2f} s = {wall / max(res['niter'], 1):.4f} s per outer "
        f"iteration, {res['niter'] / wall:.3f} outer iterations/s; LOBPCG "
        f"block iterations {prob.lobpcg_iters_log}; launches {launches}")
    check(0.25 < res["fobj"] < 0.35,
          f"fobj {res['fobj']:.4f} outside bench.py's band (0.25, 0.35)")
    check(res["infeas"] < 2e-3, f"infeas {res['infeas']:.3e} >= 2e-3")
    check(launches["qn_roll_update"] == res["niter"]
          and launches["quasi_def_apply"] == launches["phi_gram"] == 0,
          f"unexpected kernel launches on the eigen-TR path: {launches}")
    log(f"[eigtr 24x12 float32] phase 27 took "
        f"{time.perf_counter() - t_phase:.2f} s")


def phase_eig_crosscheck(torch):
    """Phase 28: the eigen path in float64, card against host: FusedEigenTR
    on FrequencyTopology(8, 4) and FrequencyTopology3D(4, 3, 2), and the
    host EigenSubproblem through `Optimizer.set_trust_region_subproblem`
    on the 2-D problem.  Returns each case's card result (fobj, counts):
    phase 33 holds its batches' x0 instances to the fused ones."""
    from paropt_torch import Optimizer
    from paropt_torch.models.fem_frequency import (FrequencyTopology,
                                                   FrequencyTopology3D)
    t_phase = time.perf_counter()
    opts = dict(EIG_OPTS, dtype="float64")

    def freq2d(dev):
        return FrequencyTopology(8, 4, N=3, cg_iters=25, solver="mgcg",
                                 lobpcg_iters=50, dtype=torch.float64,
                                 device=dev)

    def freq3d(dev):
        # ny != nz: a y <-> z symmetric box has a double lowest eigenvalue,
        # whose basis each eigh picks by roundoff
        return FrequencyTopology3D(4, 3, 2, N=3, cg_iters=120,
                                   solver="jacobi", dtype=torch.float64,
                                   device=dev)

    def fused(make, iters):
        def run(dev):
            prob = make(dev)
            res, _ = prob.build_fused_tr(
                dict(opts, tr_max_iterations=iters)).solve()
            return res["fobj"], (res["niter"], res["subiters"],
                                 prob.lobpcg_iters_log)
        return run

    def host(dev):
        prob = freq2d(dev)
        sub, _ = prob.build_tr_subproblem(msub=10)
        opt = Optimizer(prob, dict(opts, algorithm="tr",
                                   tr_max_iterations=2))
        opt.set_trust_region_subproblem(sub)
        res = opt.optimize()
        return res["fobj"], (res["niter"], opt._inner.inner_iters,
                             prob.lobpcg_iters_log)

    cases = (("FusedEigenTR 2-D 8x4", fused(freq2d, 4)),
             ("FusedEigenTR 3-D 4x3x2", fused(freq3d, 4)),
             ("host EigenSubproblem 2-D 8x4", host))
    cards = {}
    for name, run in cases:
        out = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            out[dev] = run(dev)
            log(f"[eig crosscheck] {name} {dev}: fobj {out[dev][0]:.15e}, "
                f"(outer, inner, LOBPCG block iterations per eigensolve) "
                f"{out[dev][1]} ({time.perf_counter() - t0:.2f} s)")
        (fc, ic), (fh, ih) = out["cuda"], out["cpu"]
        check(ic == ih, f"{name}: counts differ: cuda {ic}, cpu {ih}")
        check(abs(fc - fh) <= 1e-9 * abs(fh),
              f"{name}: objectives differ: cuda {fc!r}, cpu {fh!r}")
        cards[name] = out["cuda"]
    log(f"[eig crosscheck] phase 28 took "
        f"{time.perf_counter() - t_phase:.2f} s")
    return cards


# --- the general-CSR path and the trajectory, COPS and truss models -------
# (phases 29-31)

# the option set of the reference's dymos examples (tests/
# test_brachistochrone.py:13-21, examples/ssto.py)
DYMOS_OPTS = {"algorithm": "ip", "norm_type": "infinity",
              "qn_subspace_size": 10,
              "starting_point_strategy": "least_squares_multipliers",
              "qn_update_type": "damped_update", "abs_res_tol": 1e-6,
              "barrier_strategy": "monotone", "armijo_constant": 1e-5,
              "penalty_gamma": 100.0, "max_major_iters": 500}
# paropt_tpu's host InteriorPoint on the CPU in float64 at the same sizes
# and options: iterations and objective
JAX_BRACH_2048 = (71, 1.8016040)
JAX_ELECTRON_200 = (305, 18438.9228)
JAX_SSTO_160 = (99, 4.81728)
BRACH_TF = 1.8016     # the reference's dymos assertion (rel 1e-3)
THOMSON_200 = 18438.84   # the Thomson minimum for 200 charges (rel 1e-4)
SSTO_TF = 481.8       # dymos's documented SSTO optimum, s (rel 1e-3)


def _csr_solve(torch, tag, prob, opts):
    """The host InteriorPoint through `Optimizer` on a CSR problem on the
    card; prints the path's figures and returns (result, launches)."""
    opt, res, wall, launches, peak, _ = _host_route(
        torch, prob, dict(opts, algorithm="ip"))
    ip = opt._inner
    check(ip._csr_mat is not None, f"{tag}: not the general-CSR path")
    mat = ip._csr_mat.mat
    niter = max(res["niter"], 1)
    syncs = ip.syncs
    log(f"{tag} converged={res['converged']} reason={res['reason']!r} "
        f"iterations {res['niter']}; fobj {res['fobj']:.9e}")
    log(f"{tag} wall {wall:.3f} s = {wall / niter * 1e3:.2f} ms per "
        f"iteration; {syncs.count} host reads = {syncs.count / niter:.1f} "
        f"per iteration; {syncs.bytes_to_host / niter / 1e3:.1f} kB to the "
        f"host and {syncs.bytes_to_device / niter / 1e3:.1f} kB to the card "
        f"per iteration")
    log(f"{tag} host factor: {mat.nfactor} factorizations "
        f"{mat.factor_seconds:.3f} s ({100 * mat.factor_seconds / wall:.1f}% "
        f"of wall), solves {mat.solve_seconds:.3f} s "
        f"({100 * mat.solve_seconds / wall:.1f}%); {mat.get_factor_info()}")
    log(f"{tag} peak memory {peak:.4f} GiB; kernel launches {launches}")
    check(launches["quasi_def_apply"] == 0 and launches["phi_gram"] == 0,
          f"{tag}: a quasi-definite kernel ran on the CSR path: {launches}")
    check(launches["qn_roll_update"] > 0,
          f"{tag}: the QN update kernel was not launched")
    check(torch.isfinite(res["x"]).all().item() and res["x"].is_cuda,
          f"{tag}: bad final x")
    return res, launches


def phase_csr_full(torch):
    """Phase 29: BrachistochroneCollocation(2048) in float64 with the dymos
    options through the host InteriorPoint on the card; returns the kernel
    launches of the solve."""
    from paropt_torch.models import BrachistochroneCollocation
    t_phase = time.perf_counter()
    tag = "[csr brachistochrone N=2048 float64]"
    prob = BrachistochroneCollocation(2048, dtype=torch.float64,
                                      device="cuda")
    log(f"{tag} {prob.nvars} variables, {prob.nwcon} CSR equalities, "
        f"{int(prob.csr_rowp[-1])} Jacobian entries")
    res, launches = _csr_solve(torch, tag, prob, DYMOS_OPTS)
    tf = float(res["x"][prob._otf])
    defect = torch.max(torch.abs(prob.sparse_constraints(res["x"]))).item()
    log(f"{tag} tf {tf:.7f} (reference {BRACH_TF}, paropt_tpu on the CPU "
        f"{JAX_BRACH_2048[1]} in {JAX_BRACH_2048[0]} iterations); max "
        f"defect {defect:.3e}; phase 29 took "
        f"{time.perf_counter() - t_phase:.2f} s")
    check(res["converged"], f"{tag} did not converge: {res['reason']!r}")
    check(abs(tf - BRACH_TF) <= 1e-3 * BRACH_TF, f"{tag} tf {tf!r}")
    check(defect < 1e-6, f"{tag} max defect {defect:.3e}")
    check(abs(res["niter"] - JAX_BRACH_2048[0]) <= 10,
          f"{tag} {res['niter']} iterations, paropt_tpu {JAX_BRACH_2048[0]}")
    return launches


def phase_cops_ssto(torch):
    """Phase 30: ElectronCSR(200) (COPS 3.0's largest electron instance)
    and SSTOCollocation(160) in float64 on the card; returns the kernel
    launches of each solve."""
    from paropt_torch.models import ElectronCSR, SSTOCollocation
    t_phase = time.perf_counter()
    tag = "[csr electron n=200 float64]"
    prob = ElectronCSR(200, dtype=torch.float64, device="cuda")
    res, elec = _csr_solve(torch, tag, prob, {"abs_res_tol": 1e-6})
    sphere = torch.max(torch.abs(prob.sparse_constraints(res["x"]))).item()
    log(f"{tag} fobj {res['fobj']:.6f} (Thomson minimum {THOMSON_200}, "
        f"paropt_tpu on the CPU {JAX_ELECTRON_200[1]} in "
        f"{JAX_ELECTRON_200[0]} iterations); max |sphere constraint| "
        f"{sphere:.3e}")
    check(res["converged"], f"{tag} did not converge: {res['reason']!r}")
    check(abs(res["fobj"] - THOMSON_200) <= 1e-4 * THOMSON_200,
          f"{tag} fobj {res['fobj']!r}")
    check(sphere < 1e-6, f"{tag} sphere constraints {sphere:.3e}")

    tag = "[csr ssto N=160 float64]"
    prob = SSTOCollocation(160, dtype=torch.float64, device="cuda")
    res, ssto = _csr_solve(torch, tag, prob, DYMOS_OPTS)
    tf = prob.final_time(res["x"])
    defect = torch.max(torch.abs(prob.sparse_constraints(res["x"]))).item()
    bc = torch.max(torch.abs(prob.constraints(res["x"]))).item()
    log(f"{tag} final time {tf:.4f} s (dymos {SSTO_TF} s, paropt_tpu on "
        f"the CPU {100 * JAX_SSTO_160[1]:.3f} s in {JAX_SSTO_160[0]} "
        f"iterations); max defect {defect:.3e}, max boundary constraint "
        f"{bc:.3e}; phase 30 took {time.perf_counter() - t_phase:.2f} s")
    check(res["converged"], f"{tag} did not converge: {res['reason']!r}")
    check(abs(tf - SSTO_TF) <= 1e-3 * SSTO_TF, f"{tag} final time {tf!r}")
    check(defect < 1e-6 and bc < 1e-6,
          f"{tag} defects {defect:.3e}, boundary constraints {bc:.3e}")
    return elec, ssto


def _callback_rosenbrock(torch, device):
    """paropt_torch's SparseRosenbrock without its structured Jacobian:
    the callback-product path."""
    from paropt_torch.models.analytic import SparseRosenbrock

    class CallbackOnly(SparseRosenbrock):
        def sparse_jacobian(self, x):
            raise NotImplementedError

        def sparse_inner_product(self, x, cvec):
            Aw = torch.func.jacrev(self.sparse_constraints)(x)
            return ((Aw * cvec) @ Aw.T).reshape(-1, 1, 1)

    return CallbackOnly(dtype=torch.float64, device=device)


def phase_csr_crosscheck(torch):
    """Phase 31: the host InteriorPoint in float64 on the card and on the
    CPU for each new model and the callback path: equal iteration counts,
    fobj within 1e-9 relative."""
    from paropt_torch.models import (BrachistochroneCollocation, CartPole,
                                     DMOTruss, Electron, ElectronCSR,
                                     Polygon, SSTOCollocation, TrussSizing)
    from paropt_torch.ops import kernels
    t_phase = time.perf_counter()
    f64 = dict(dtype=torch.float64)
    tol6 = {"abs_res_tol": 1e-6}
    cases = (
        ("ElectronCSR(20)", lambda d: ElectronCSR(20, device=d, **f64), tol6),
        ("Electron(20)", lambda d: Electron(20, device=d, **f64), tol6),
        ("Polygon(6)", lambda d: Polygon(6, device=d, **f64), tol6),
        ("SSTOCollocation(40)",
         lambda d: SSTOCollocation(40, device=d, **f64), DYMOS_OPTS),
        ("BrachistochroneCollocation(48)",
         lambda d: BrachistochroneCollocation(48, device=d, **f64),
         DYMOS_OPTS),
        ("SparseRosenbrock (callback products)",
         lambda d: _callback_rosenbrock(torch, d), {"abs_res_tol": 1e-7}),
        ("TrussSizing(4, 3)", lambda d: TrussSizing(device=d, **f64), tol6),
        # 40 iterations of the 268 the full solve takes (a depth cut)
        ("DMOTruss(4, 3)", lambda d: DMOTruss(4, 3, device=d, **f64),
         {"abs_res_tol": 1e-5, "max_major_iters": 40}),
        # nsteps = 12 converges in 47 iterations (paropt_tpu and the port
        # on the CPU; at 8 the solve wanders for thousands of iterations);
        # its first 20 (a depth cut: the 47 took 37 s on the card and 15 s
        # on the CPU of an H100 machine)
        ("CartPole(nsteps=12)",
         lambda d: CartPole(nsteps=12, device=d, **f64),
         dict(tol6, max_major_iters=20)),
    )
    dmo_launches = None
    for name, make, opts in cases:
        out = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            opt, res, _, launches, _, _ = _host_route(
                torch, make(dev), dict(opts, algorithm="ip"))
            ip = opt._inner
            out[dev] = (res["fobj"], (res["niter"], res["neval"],
                                      res["ngeval"]))
            log(f"[csr crosscheck] {name} {dev}: fobj {res['fobj']:.15e}, "
                f"(iterations, evaluations, gradients) {out[dev][1]}, "
                f"converged={res['converged']}, host reads "
                f"{ip.syncs.count}, launches {launches} "
                f"({time.perf_counter() - t0:.2f} s)")
            if dev == "cuda" and name.startswith("DMOTruss"):
                dmo_launches = launches
        (fc, ic), (fh, ih) = out["cuda"], out["cpu"]
        check(ic == ih, f"{name}: counts differ: cuda {ic}, cpu {ih}")
        # an absolute 1e-14 for the solves that end at fobj = 0, where
        # only roundoff is left (as tests/_torch_parity.py holds them)
        check(abs(fc - fh) <= 1e-9 * abs(fh) + 1e-14,
              f"{name}: objectives differ: cuda {fc!r}, cpu {fh!r}")
    log(f"[csr crosscheck] DMOTruss's sparse pattern is 'blocked', not "
        f"'blocked_t': its launches on the card were {dmo_launches}")
    log(f"[csr crosscheck] phase 31 took "
        f"{time.perf_counter() - t_phase:.2f} s")


# --- batched eigen-TR solves, checkpoints and the reference's surface -----
# (phases 32-35)

# phase 32's depth, phase 26's (cut from the flagship's 40): at 2 the x0
# instance, phase 26's trajectory, has had both its trials rejected and
# still sits at fobj 1.0
EIG3D_BATCH_ITERS = EIG3D_ITERS


def _instance_lobpcg(log_, start, j):
    """Instance j's LOBPCG block iterations in each batched eigensolve
    recorded from ``start`` on."""
    return [counts[j] for counts in log_[start:]]


def phase_eig3d_batched(torch, single_s_per_iter):
    """Phase 32: FusedEigenTR.solve_batched on phase 26's flagship in
    float32 with KB starts; returns the batch's kernel launches."""
    from paropt_torch.models.fem_frequency import FrequencyTopology3D
    from paropt_torch.ops import kernels
    tag = "[eig3d batched {}x{}x{} N=6 float32 kb={}]".format(*EIG3D_MESH,
                                                               KB)
    t_phase = time.perf_counter()
    prob = FrequencyTopology3D(*EIG3D_MESH, N=6, cg_iters=30,
                               solver="mgcg", lobpcg_iters=60,
                               dtype=torch.float32, device="cuda")
    solver = prob.build_fused_tr({"tr_max_iterations": EIG3D_BATCH_ITERS,
                                  "dtype": "float32", "output_file": None,
                                  "tr_output_file": None})
    x0, _, _ = prob.get_vars_and_bounds()
    x0s = torch.cat([x0[None], _starts(torch, x0, KB - 1, 0.6, 1.0,
                                       clip=(prob.lb, 1.0), seed=1)])
    torch.cuda.synchronize()
    log(f"{tag} model and solver built in "
        f"{time.perf_counter() - t_phase:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    reads0, solves0 = solver.syncs.count, len(prob.lobpcg_iters_log)
    t0 = time.perf_counter()
    res, st = solver.solve_batched(x0s)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    batched = dict(kernels.BATCHED_LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    reads = solver.syncs.count - reads0
    niter = int(res["niter"].max())
    for j in range(KB):
        log(f"{tag} instance {j}: outer {int(res['niter'][j])}, inner "
            f"{int(st.subiters[j])}, fobj {float(res['fobj'][j]):.6f}, "
            f"infeas {float(res['infeas'][j]):.3e}; LOBPCG block "
            f"iterations per eigensolve (start first) "
            f"{_instance_lobpcg(prob.lobpcg_iters_log, solves0, j)}")
    log(f"{tag} wall {wall:.3f} s (the batched start eigensolve included) "
        f"= {wall / niter:.4f} s per batched outer iteration, phase 26's "
        f"single one {single_s_per_iter:.4f} s; {reads} host reads = "
        f"{reads / niter:.1f} per outer iteration; peak memory "
        f"{peak:.3f} GiB; launches {launches}, of them instance-axis "
        f"{batched}")
    finite = (torch.isfinite(st.xk).all() & torch.isfinite(st.fk).all()
              & torch.isfinite(st.rho).all())
    check(bool(finite), "a non-finite batched iterate, fobj or rho")
    check(niter == EIG3D_BATCH_ITERS, f"{niter} outer iterations")
    check(bool((res["fobj"] < 1.0).all()),
          f"fobj {res['fobj'].tolist()} not all below the start 1.0")
    check(batched["qn_roll_update"] == niter
          and launches["qn_roll_update"] == niter,
          f"qn_roll_update: {launches['qn_roll_update']} launches, "
          f"{batched['qn_roll_update']} with the instance axis, in {niter} "
          f"batched outer iterations (one instance-axis roll each)")
    check(launches["quasi_def_apply"] == launches["phi_gram"] == 0,
          f"a quasi-definite kernel ran on the eigen path: {launches}")
    log(f"{tag} phase 32 took {time.perf_counter() - t_phase:.2f} s")
    return launches


# phase 33's models: phase 28's (N = 3 in 3-D: at N = 4 this box's fourth
# mode converges slowly, 39-52 block iterations, and the count is decided
# by roundoff)
EIG33_MODELS = ("FusedEigenTR 2-D 8x4", "FusedEigenTR 3-D 4x3x2")


def _eig33_model(torch, name, dev):
    from paropt_torch.models.fem_frequency import (FrequencyTopology,
                                                   FrequencyTopology3D)
    if name == EIG33_MODELS[0]:
        return FrequencyTopology(8, 4, N=3, cg_iters=25, solver="mgcg",
                                 lobpcg_iters=50, dtype=torch.float64,
                                 device=dev)
    return FrequencyTopology3D(4, 3, 2, N=3, cg_iters=120, solver="jacobi",
                               dtype=torch.float64, device=dev)


def _eig33_starts(torch, prob):
    """x0 and two starts inside the bounds."""
    x0, _, _ = prob.get_vars_and_bounds()
    return torch.cat([x0[None], _starts(torch, x0, 2, 0.6, 1.0,
                                        clip=(prob.lb, 1.0), seed=2)])


EIG33_OPTS = dict(EIG_OPTS, dtype="float64", tr_max_iterations=4)


def _eig33_batched(torch, name, dev):
    """(fobj [3], per instance (outer, inner, LOBPCG block iterations from
    the start's eigensolve), seconds, the model) of one batched solve."""
    prob = _eig33_model(torch, name, dev)
    solver = prob.build_fused_tr(dict(EIG33_OPTS))
    start = len(prob.lobpcg_iters_log)
    t0 = time.perf_counter()
    res, st = solver.solve_batched(_eig33_starts(torch, prob))
    counts = [[int(res["niter"][j]), int(st.subiters[j]),
               _instance_lobpcg(prob.lobpcg_iters_log, start, j)]
              for j in range(3)]
    return res["fobj"].tolist(), counts, time.perf_counter() - t0, prob


def _eig33_cpu_main():
    """Phase 33's batched solves on the CPU, as a JSON line on stdout (run
    in a process of its own, beside the card's phases)."""
    import torch
    torch.set_num_threads(2)
    print(json.dumps({name: _eig33_batched(torch, name, "cpu")[:3]
                      for name in EIG33_MODELS}), flush=True)


def _eig33_cpu_start():
    """Start `_eig33_cpu_main` in a child process; phase 33 reads it."""
    return subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; "
         "chip_smoke._eig33_cpu_main()"], cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def phase_eig_batched_crosscheck(torch, cpu_job, singles):
    """Phase 33: solve_batched with kb = 3 in float64 on FrequencyTopology
    (8, 4) and FrequencyTopology3D(4, 3, 2) (phase 28's models), 4 outer
    iterations: each instance equal to its own single solve on the card
    (x0's is phase 28's card solve, ``singles``), and the card's batch
    equal to the CPU's (run by ``cpu_job``, started beside the card's
    earlier phases).  Returns the kernel launches of the card's batched
    solves."""
    from paropt_torch.ops import kernels
    t_phase = time.perf_counter()
    out, err = cpu_job.communicate(timeout=900)
    check(cpu_job.returncode == 0, f"the CPU batched solves failed:\n{err}")
    cpu = json.loads(out.splitlines()[-1])
    launches = dict.fromkeys(kernels.LAUNCHES, 0)
    for name in EIG33_MODELS:
        kernels.reset_launches()
        fc, cc, secs, prob = _eig33_batched(torch, name, "cuda")
        for k, v in kernels.LAUNCHES.items():
            launches[k] += v
        fh, ch, secs_h = cpu[name]
        for dev, f, c, t in (("cuda", fc, cc, secs), ("cpu", fh, ch, secs_h)):
            log(f"[eig batched crosscheck] {name} {dev}: fobj {f}, (outer, "
                f"inner, LOBPCG block iterations) {c} ({t:.2f} s)")
        check(cc == ch, f"{name}: batched counts differ: cuda {cc}, cpu {ch}")
        for j in range(3):
            check(_rel(fc[j], fh[j]) <= 1e-9,
                  f"{name} instance {j}: cuda {fc[j]!r}, cpu {fh[j]!r}")
        # x0's single solve on the card is phase 28's; the others run on
        # the card's model (its lam_target is every solver's), each
        # solver's build evaluating its start
        f0, (n0, i0, log0) = singles[name]
        ones = [(f0, [n0, i0, log0[1:]])]
        base = prob.get_vars_and_bounds
        for x0j in _eig33_starts(torch, prob)[1:]:
            prob.get_vars_and_bounds = (
                lambda x0j=x0j: (x0j,) + tuple(base()[1:]))
            solver = prob.build_fused_tr(dict(EIG33_OPTS))
            start = len(prob.lobpcg_iters_log)
            r1, s1 = solver.solve()
            # from the start's eigensolve, which the solver's build ran
            ones.append((r1["fobj"], [r1["niter"], int(s1.subiters),
                                      prob.lobpcg_iters_log[start - 1:]]))
        prob.get_vars_and_bounds = base
        for j, (f1, one) in enumerate(ones):
            log(f"[eig batched crosscheck] {name} instance {j} alone on the "
                f"card: fobj {f1:.15e}, counts {one}")
            check(one == cc[j], f"{name} instance {j}: single {one}, "
                  f"batched {cc[j]}")
            check(_rel(f1, fc[j]) <= 1e-9, f"{name} instance {j}: single "
                  f"{f1!r}, batched {fc[j]!r}")
    log(f"[eig batched crosscheck] phase 33 took "
        f"{time.perf_counter() - t_phase:.2f} s")
    return launches


def _bitwise(torch, a, b):
    return a.shape == b.shape and bool(torch.equal(a, b))


def phase_checkpoints(torch, ip_iters, ip_fobj, ip_x, mma_fobj, mma_x,
                      mma_files):
    """Phase 34: checkpoints at full width (a) of the fused IP at n = 2^20
    in float32 (ip_checkpoint_file: a solve capped at 10 iterations writes
    its k = 10 state at its last window's boundary, which is resumed under
    the full cap), (b) of the host IP (optimize(checkpoint=...),
    read_solution_file) and (c) of FusedMMA on the 96x48 bench
    configuration (phase 7's checkpoint_path files, ``mma_files``, resumed
    from iteration 30).  Returns the launches of (a)'s full solve and of
    (b)'s."""
    from paropt_torch import InteriorPoint
    from paropt_torch.ip_fused import fused_ip_optimize
    from paropt_torch.models.fem_topology import FEMTopology
    from paropt_torch.models.topology import SyntheticTopology
    from paropt_torch.mma import FusedMMA
    from paropt_torch.ops import kernels
    from paropt_torch.utils.checkpoint import restore_state, save_state
    t_phase = time.perf_counter()
    BUILD.mkdir(exist_ok=True)
    tag = f"[checkpoint fused ip n={N_MAIN} float32]"
    path = BUILD / "chip_smoke_ip.pt"
    mid_path = BUILD / "chip_smoke_ip_10.pt"

    def problem():
        return SyntheticTopology(n=N_MAIN, block=BLOCK, dtype=torch.float32,
                                 device="cuda")

    opts = {"dtype": "float32", "qn_subspace_size": MSUB,
            "qn_subspace_auto": False, "abs_res_tol": 1e-6,
            "iterative_refinement_steps": 0, "write_output_frequency": 10}
    # the mid-solve file: the facade's windows ('auto') end at the cap, 10,
    # whose boundary is the cadence's and writes the state of iteration 10
    _, mid_state = fused_ip_optimize(problem(), dict(
        opts, max_major_iters=10, ip_checkpoint_file=str(mid_path)))
    check(int(mid_state.k) == 10, f"the capped solve stopped at "
          f"{int(mid_state.k)}, not 10")
    kernels.reset_launches()
    t0 = time.perf_counter()
    res, state = fused_ip_optimize(problem(), dict(
        opts, ip_checkpoint_file=str(path)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    t1 = time.perf_counter()
    save_state(str(path), state)
    write_s = time.perf_counter() - t1
    log(f"{tag} with ip_checkpoint_file at cadence 10: {res['niter']} "
        f"iterations (phase 4: {ip_iters}), fobj {res['fobj']!r} (phase 4: "
        f"{ip_fobj!r}), {wall:.3f} s; file {path.stat().st_size / 2**20:.1f}"
        f" MiB, written in {write_s:.3f} s; launches {launches}")
    check(res["niter"] == ip_iters and res["fobj"] == ip_fobj
          and _bitwise(torch, state.vars.x, ip_x),
          "the checkpointing solve does not end as phase 4 does")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched")
    restored = restore_state(str(mid_path), state)
    check(int(restored.k) == 10, f"the file of the capped solve holds "
          f"iteration {int(restored.k)}, not 10")
    t0 = time.perf_counter()
    res2, state2 = fused_ip_optimize(problem(), dict(
        opts, write_output_frequency=0), state0=restored)
    torch.cuda.synchronize()
    log(f"{tag} the capped solve's file (iteration {int(restored.k)}) "
        f"resumed under the full cap: {res2['niter']} iterations, fobj "
        f"{res2['fobj']!r} ({time.perf_counter() - t0:.3f} s)")
    check(res2["niter"] == ip_iters and res2["fobj"] == ip_fobj
          and _bitwise(torch, state2.vars.x, ip_x),
          "the resumed solve does not end on the uninterrupted one")

    # (b) the host IP's npz solution file
    tag = f"[checkpoint host ip n={N_MAIN} float32]"
    npz = BUILD / "chip_smoke_host_ip.npz"
    hopts = {"output_file": None, "dtype": "float32",
             "qn_subspace_size": MSUB, "abs_res_tol": 1e-6,
             "iterative_refinement_steps": 0, "write_output_frequency": 10}
    ip = InteriorPoint(problem(), dict(hopts))
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = ip.optimize(checkpoint=str(npz))
    torch.cuda.synchronize()
    host_launches = dict(kernels.LAUNCHES)
    log(f"{tag} optimize(checkpoint=...): {res['niter']} iterations, fobj "
        f"{res['fobj']!r}, {time.perf_counter() - t0:.3f} s; launches "
        f"{host_launches}")
    import numpy as np
    with np.load(npz) as dat:
        written = {k: dat[k] for k in dat.files}
    again = InteriorPoint(problem(), dict(hopts))
    again.read_solution_file(str(npz))
    same = all(np.array_equal(getattr(again.vars, k).cpu().numpy(), v)
               for k, v in written.items() if k != "mu")
    check(same and again.mu == float(written["mu"]),
          "read_solution_file does not give back the state written")
    t0 = time.perf_counter()
    res2 = again.optimize()
    log(f"{tag} resumed from the last cadence file: converged "
        f"{res2['converged']} in {res2['niter']} iterations, res_norm "
        f"{res2['res_norm']:.3e} ({time.perf_counter() - t0:.3f} s)")
    check(res2["converged"], "the resumed host IP did not converge")
    ip.write_solution_file(str(npz))
    final = InteriorPoint(problem(), dict(hopts))
    final.read_solution_file(str(npz))
    check(all(_bitwise(torch, getattr(final.vars, f), getattr(ip.vars, f))
              for f in written if f != "mu"),
          "the final state does not read back bit for bit")

    # (c) FusedMMA on the 96x48 bench configuration: phase 7's run wrote
    # its state every 10 outer iterations; its iteration-30 file resumed
    # to the absolute count 60 (JAX's rule)
    tag = "[checkpoint mma 96x48 float32]"
    prob = FEMTopology(96, 48, cg_iters=25, solver="mgcg",
                       dtype=torch.float32, device="cuda")
    solver = FusedMMA(prob, {"mma_max_iterations": 60,
                             "mma_output_file": None, "dtype": "float32"})
    check(30 in mma_files, f"phase 7 kept no iteration-30 checkpoint: "
          f"{sorted(mma_files)}")
    restored = restore_state(str(mma_files[30]), solver._state0)
    kernels.reset_launches()
    t0 = time.perf_counter()
    res, st = solver.solve(state0=restored)
    torch.cuda.synchronize()
    mma_launches = dict(kernels.LAUNCHES)
    log(f"{tag} phase 7's iteration-{int(restored.k)} checkpoint (cadence "
        f"10) resumed to outer iteration 60: fobj {res['fobj']!r} "
        f"(phase 7's uninterrupted 60: {mma_fobj!r}), {res['niter']} outer "
        f"iterations, {time.perf_counter() - t0:.2f} s; launches "
        f"{mma_launches}")
    check(int(restored.k) == 30, "the iteration-30 checkpoint does not "
          "hold iteration 30")
    check(res["niter"] == 60 and res["fobj"] == mma_fobj
          and _bitwise(torch, st.x, mma_x),
          "the resumed MMA does not end on phase 7's 60-iteration run")
    for p in [path, mid_path, npz] + list(mma_files.values()):
        p.unlink(missing_ok=True)
    log(f"[checkpoint] phase 34 took {time.perf_counter() - t_phase:.2f} s")
    return launches, host_launches


def _compat_topology(ParOpt, n, block=BLOCK):
    """SyntheticTopology as a reference user writes a problem: numpy fill
    callbacks for the objective, the volume constraint and the n/block
    block constraints (nwblock = 1), the arithmetic of
    paropt_torch/models/topology.py (weights from default_rng(0), the
    five-tap Hann filter with edge padding).  Returns the problem class
    and the objective and its gradient as numpy functions."""
    import numpy as np
    rng = np.random.default_rng(0)
    w = 0.5 + rng.random(n)
    taps = np.hanning(7)[1:-1]
    taps = taps / taps.sum()
    nw = n // block

    def filt(x):
        xp = np.concatenate([np.full(2, x[0]), x, np.full(2, x[-1])])
        return sum(taps[j] * xp[j:j + n] for j in range(5))

    def objective(x):
        return np.sum(w / (0.01 + filt(x))) / n

    def gradient(x):
        v = -w / (0.01 + filt(x)) ** 2 / n
        gp = np.zeros(n + 4)
        for j in range(5):
            gp[j:j + n] += taps[j] * v
        g = gp[2:2 + n].copy()
        g[0] += gp[:2].sum()
        g[-1] += gp[-2:].sum()
        return g

    class Topology(ParOpt.Problem):
        def __init__(self):
            super().__init__(None, nvars=n, ncon=1, nwcon=nw, nwblock=1)

        def getVarsAndBounds(self, x, lb, ub):
            x[:] = 0.3
            lb[:] = 0.0
            ub[:] = 1.0

        def evalObjCon(self, x):
            return 0, objective(x), [0.4 - np.mean(x)]

        def evalObjConGradient(self, x, g, A):
            g[:] = gradient(x)
            A[0][:] = -1.0 / n
            return 0

        def evalSparseCon(self, x, out):
            out[:] = 0.6 - x.reshape(block, nw).mean(axis=0)

        def addSparseJacobian(self, alpha, x, px, out):
            out += -alpha / block * px.reshape(block, nw).sum(axis=0)

        def addSparseJacobianTranspose(self, alpha, x, pz, out):
            out += (-alpha / block
                    * np.broadcast_to(pz, (block, nw))).reshape(-1)

        def addSparseInnerProduct(self, alpha, x, c, A):
            A += alpha / block ** 2 * c.reshape(block, nw).sum(axis=0)

    return Topology, objective, gradient


def phase_surface(torch):
    """Phase 35: the reference's surface at full width in float64 on the
    card: (a) a compat.Problem of SyntheticTopology(2^20) through
    compat.InteriorPoint against the native InteriorPoint, (b) a
    FunctionProblem of its objective and volume constraint against a
    native problem of the same two functions, (c) ReducedProblem with a
    non-design region on FEMTopology(768, 384) through the host MMA.
    Returns the launches of the compat route and of its native yardstick."""
    import numpy as np

    from paropt_torch import MMA, InteriorPoint, compat
    from paropt_torch.drivers import FunctionProblem
    from paropt_torch.models.fem_topology import FEMTopology
    from paropt_torch.models.topology import SyntheticTopology
    from paropt_torch.ops import kernels
    from paropt_torch.reduced import ReducedProblem
    t_phase = time.perf_counter()
    f64 = torch.float64
    opts = {"output_file": None, "dtype": "float64",
            "qn_subspace_size": MSUB, "abs_res_tol": 1e-6,
            "iterative_refinement_steps": 0}
    Topology, objective, gradient = _compat_topology(compat, N_MAIN)

    def run(tag, solver, syncs):
        times, reads, to_host, to_dev = [], [], [], []

        def mark():
            torch.cuda.synchronize()
            times.append(time.perf_counter())
            reads.append(syncs.count)
            to_host.append(syncs.bytes_to_host)
            to_dev.append(syncs.bytes_to_device)

        solver.problem.write_output = lambda it, x: mark()
        solver.options["write_output_frequency"] = 1
        kernels.reset_launches()
        mark()
        res = solver.optimize()
        mark()
        launches = dict(kernels.LAUNCHES)
        per = [(times[i + 1] - times[i], reads[i + 1] - reads[i],
                to_host[i + 1] - to_host[i], to_dev[i + 1] - to_dev[i])
               for i in range(len(times) - 1)]
        log(f"{tag} {res['niter']} iterations, fobj {res['fobj']!r}, "
            f"converged {res['converged']}, {times[-1] - times[0]:.3f} s; "
            f"launches {launches}")
        log(f"{tag} per iteration (s, host reads, bytes to the host, bytes "
            f"to the card): " + "; ".join(
                f"{s:.4f} {r} {h} {d}" for s, r, h, d in per))
        return res, launches

    # (a) the fill-callback problem with its block constraints
    prob = Topology()
    cres, compat_launches = run(
        f"[compat n={N_MAIN} float64]",
        compat.InteriorPoint(prob, dict(opts)), prob.syncs)
    native = InteriorPoint(SyntheticTopology(n=N_MAIN, block=BLOCK,
                                             dtype=f64, device="cuda"),
                           dict(opts))
    nres, native_launches = run(f"[native n={N_MAIN} float64]", native,
                                native.syncs)
    dx = float(torch.max(torch.abs(cres["x"] - nres["x"])))
    log(f"[compat] against the native route: iterations {cres['niter']} / "
        f"{nres['niter']}, fobj rel {_rel(cres['fobj'], nres['fobj']):.2e}"
        f", max |dx| {dx:.2e}")
    check(cres["converged"] and nres["converged"],
          "a full-width route did not converge")
    check(cres["niter"] == nres["niter"]
          and _rel(cres["fobj"], nres["fobj"]) <= 1e-9 and dx <= 1e-7,
          "the compat route does not match the native one")
    check(compat_launches["qn_roll_update"] > 0
          and all(c > 0 for c in native_launches.values()),
          f"launches: compat {compat_launches}, native {native_launches}")

    # (b) FunctionProblem of the objective and the volume constraint
    n = N_MAIN
    fp = FunctionProblem(
        np.full(n, 0.3), np.zeros(n), np.ones(n), objective=objective,
        gradient=gradient, constraints=lambda x: np.array([0.4 - x.mean()]),
        jacobian=lambda x: np.full((1, n), -1.0 / n))
    fres, fn_launches = run(f"[FunctionProblem n={n} float64]",
                            InteriorPoint(fp, dict(opts)), fp.syncs)
    dense = InteriorPoint(SyntheticTopology(n=n, block=BLOCK,
                                            use_sparse=False, dtype=f64,
                                            device="cuda"), dict(opts))
    dres, _ = run(f"[native dense n={n} float64]", dense, dense.syncs)
    check(fres["niter"] == dres["niter"]
          and _rel(fres["fobj"], dres["fobj"]) <= 1e-9,
          f"FunctionProblem {fres['niter']} / {fres['fobj']!r} against "
          f"{dres['niter']} / {dres['fobj']!r}")

    # (c) a non-design region around the load of the 768x384 cantilever
    tag = "[reduced fem 768x384 float64]"
    fem = FEMTopology(768, 384, cg_iters=25, solver="mgcg", dtype=f64,
                      device="cuda")
    ex, ey = np.meshgrid(np.arange(fem.nex - 8, fem.nex),
                         np.arange(fem.ney // 2 - 4, fem.ney // 2 + 4),
                         indexing="ij")
    fixed = (ex * fem.ney + ey).ravel()
    red = ReducedProblem(fem, fixed, np.ones(fixed.size))
    xr, _, _ = red.get_vars_and_bounds()
    gr, _ = red.eval_obj_con_gradient(xr)
    gf, _ = fem.eval_obj_con_gradient(red.expand(xr))
    gerr = float(torch.max(torch.abs(gr - gf[red.free_idx]))
                 / torch.max(torch.abs(gf)))
    f0 = float(red.eval_obj_con(xr)[0])
    mma = MMA(red, {"mma_max_iterations": 5, "mma_output_file": None,
                    "output_file": None, "dtype": "float64"})
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = mma.optimize()
    torch.cuda.synchronize()
    full = red.expand(res["x"])
    log(f"{tag} {fixed.size} elements fixed at 1.0 around the load; "
        f"reduced gradient against the full one's free entries: rel "
        f"{gerr:.2e}; 5 host MMA outer iterations: fobj {f0:.6f} -> "
        f"{res['fobj']:.6f} ({time.perf_counter() - t0:.2f} s, launches "
        f"{dict(kernels.LAUNCHES)})")
    check(gerr <= 1e-12, f"reduced gradient off by {gerr:.2e}")
    check(bool(torch.all(full[torch.as_tensor(fixed, device="cuda")]
                         == 1.0)), "a fixed element moved")
    check(res["fobj"] < f0, "fobj did not fall")
    log(f"[surface] phase 35 took {time.perf_counter() - t_phase:.2f} s")
    return compat_launches, native_launches, fn_launches


def _ranks(nproc, out, *args):
    """Run ``nproc`` ranks of paropt_torch.parallel.worker on the card(s)
    (a failure raises, and fails the script); each rank's JSON."""
    from paropt_torch.parallel.worker import spawn
    spawn(nproc, ["--device", "cuda", "--out", out, *args], timeout=300,
          cwd=str(ROOT))
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(nproc)]


def _sharded_ip(torch, tag, ranks, n, dtype):
    """Print one sharded solve's figures (rank 0's); returns them."""
    ip = ranks[0]["ip"]
    last = ip["trajectory"][-1]
    iters = last["k"]
    for r in ranks[1:]:
        check(r["ip"]["trajectory"] == ip["trajectory"],
              f"{tag}: rank {r['rank']} saw another trajectory")
    peak = ip["peak_bytes"] or 0
    log(f"[sharded] {tag}: n={n} {dtype} ranks={len(ranks)} "
        f"mesh={ranks[0]['mesh']} backend={ranks[0]['backend']}: "
        f"converged={ip['converged']} iters={iters} "
        f"fobj={last['fobj']:.9e} res={last['res']:.3e}; "
        f"{ip['seconds'] / iters:.4f} s and {ip['reads'] / iters:.2f} host "
        f"reads per step; {ip['collectives'] / iters:.1f} collectives and "
        f"{ip['collective_bytes'] / iters / 2**20:.2f} MiB of their inputs "
        f"per step on rank 0; peak memory {peak / 2**30:.2f} GiB; "
        f"launches {ip['launches']}")
    check(ip["converged"] and last["res"] < 1e-6,
          f"{tag}: the sharded solve did not converge")
    return ip, iters, last["fobj"]


def phase_sharded(torch, ip_launches, ip_iters, ip_fobj, ip_x):
    """36: the main path on sharded state; returns (a)'s launches."""
    import numpy as np
    import shutil
    t_phase = time.perf_counter()
    base = BUILD / "phase36"
    shutil.rmtree(base, ignore_errors=True)
    main_args = ["--dtype", "float32", "--n", N_MAIN, "--msub", MSUB,
                 "--tol", 1e-6, "--steps", 0, "--refine", 0]
    # (a) one rank, NCCL
    out = base / "a"
    ranks = _ranks(1, out, "--cases", "coll,ops,ip,overhead,ckpt",
                   *main_args)
    r0 = ranks[0]
    ip, iters, fobj = _sharded_ip(torch, "(a)", ranks, N_MAIN, "float32")
    x = np.load(out / "ip_x.npy")
    dx = float(np.max(np.abs(x - ip_x.cpu().numpy())))
    step_s, step_4 = ip["seconds"] / iters, SLICE["wall"] / SLICE["iters"]
    log(f"[sharded] (a) against phase 4: iters {iters} vs {ip_iters}, fobj "
        f"{fobj:.9e} vs {ip_fobj:.9e}, max |dx| {dx:.3e}; {step_s:.4f} vs "
        f"{step_4:.4f} s per step ({step_s / step_4:.2f}x), "
        f"{ip['reads'] / iters:.2f} vs {SLICE['reads'] / SLICE['iters']:.2f}"
        f" host reads per step")
    ov = r0["overhead"]
    plain, shd = ov["plain"], ov["sharded"]
    log(f"[sharded] (a) host time per step, each solve warm in the worker: "
        f"plain tensors {plain['seconds'] / plain['iters']:.4f} s, sharded "
        f"{shd['seconds'] / shd['iters']:.4f} s, of which the spmd mode's "
        f"own work (its settle walk and the all-reduces it issues, "
        f"{shd['mode_calls'] / shd['iters']:.0f} torch functions per step) "
        f"{shd['mode_seconds'] / shd['iters']:.4f} s; the rest of the "
        f"excess lies outside the mode (DTensor's dispatch and "
        f"collectives, the gathered host reads), not split further")
    check(plain["iters"] == shd["iters"] == iters,
          "the overhead case's solves took other step counts")
    check(iters == ip_iters, f"(a) took {iters} steps, phase 4 {ip_iters}")
    check(abs(fobj - ip_fobj) <= 1e-6 * abs(ip_fobj), "(a) fobj differs")
    check(ip["launches"] == ip_launches, f"(a) launched {ip['launches']}, "
          f"phase 4 {ip_launches}")
    log(f"[sharded] (a) redistributions, max error: {r0['coll']}")
    check(all(v == 0.0 for k, v in r0["coll"].items()
              if k != "case_seconds"), "a redistribution changed a value")
    log(f"[sharded] (a) each kernel's sharded route against its unsharded "
        f"launch, max |diff|: {r0['ops']['maxdiff']}; launches "
        f"{r0['ops']['launches']}")
    check(all(v == 0.0 for v in r0["ops"]["maxdiff"].values()),
          "a sharded kernel route differs from its unsharded launch")
    check(all(v == 1 for v in r0["ops"]["launches"].values()),
          "a sharded kernel route did not launch its kernel once")
    ck = r0["ckpt"]
    log(f"[sharded] (a) DCP checkpoint of the state after 3 steps: "
        f"{ck['bytes'] / 2**20:.1f} MiB written in {ck['write_seconds']:.3f}"
        f" s; restored max |diff| {ck['maxdiff']}, placements kept "
        f"{ck['placements_kept']}, next step max |diff| "
        f"{ck['step_maxdiff']}")
    check(ck["maxdiff"] == 0.0 and ck["placements_kept"]
          and ck["step_maxdiff"] == 0.0, "the DCP round trip is not exact")
    count = torch.cuda.device_count()
    if count >= 2:
        # (b) one rank per card, NCCL
        P = min(4, count)
        out = base / "b"
        ranks = _ranks(P, out, "--cases", "coll,ops,ip", *main_args)
        ip_b, iters_b, fobj_b = _sharded_ip(torch, "(b)", ranks, N_MAIN,
                                            "float32")
        ops = ranks[0]["ops"]
        log(f"[sharded] (b) redistributions, max error: {ranks[0]['coll']};"
            f" each kernel's sharded route against its unsharded launch, "
            f"max |diff|: {ops['maxdiff']}; launches {ops['launches']}")
        check(all(v == 0.0 for k, v in ranks[0]["coll"].items()
                  if k != "case_seconds"), "(b): a redistribution failed")
        for k in ("buf", "yx", "yw", "gx", "gw"):
            check(ops["maxdiff"][k] == 0.0, f"(b): sharded {k} differs")
        for k in ("dots", "gram"):
            check(ops["maxdiff"][k] <= RTOL["float32"] * ops["scale"][k],
                  f"(b): sharded {k} differs beyond the f32 tolerance")
        check(all(v == 1 for v in ops["launches"].values()),
              "(b): a sharded kernel route did not launch once on rank 0")
        for name, count in ip_b["launches"].items():
            check(count > 0, f"(b): kernel {name} was not launched")
        dx = float(np.max(np.abs(np.load(out / "ip_x.npy") - x)))
        log(f"[sharded] (b) against (a): iters {iters_b} vs {iters}, max "
            f"|dx| {dx:.3e}")
        check(iters_b == iters, "(b) took another iteration count")
        check(abs(fobj_b - fobj) <= 1e-6 * abs(fobj), "(b) fobj differs")
    else:
        log("[sharded] (b) not run: one card.  (c), two ranks sharing it, "
            "is left out: NCCL refuses two ranks on one device, and gloo's "
            "all-gather of CUDA tensors, which DTensor's redistribution "
            "calls, ends the process on this PyTorch (PERF.md)")
    log(f"[sharded] phase 36 took {time.perf_counter() - t_phase:.2f} s")
    return ip["launches"]


# phase 37's cases: worker size strings (with their dtypes) and tolerances
FEM37 = {"fem2d": "768,384,25,3:float64", "fem3d": "160,80,80,40,2:float32",
         "eigtr": "64,32,32,6,30,60,2:float32"}
# (b)'s 3-D case, held to one rank in float64 (four ranks sum the strips'
# dots in another order than one)
FEM37_3D_F64 = "160,80,80,40,2:float64"
# a float32 solve that sums in another order moves by this much (PERF.md:
# 1e-4-1e-3 in fobj under roundoff alone); (b)'s float32 3-D run is held
# to (a) within it
F32_REORDER_RTOL = 1e-3


def _fem37_rtol(spec):
    return RTOL[spec.rpartition(":")[2]]


def _fem37_report(torch, tag, ranks, held, specs=FEM37):
    """Print and check one launch's cases (rank 0's figures; every rank
    must report the same trajectories); ``held``: each sharded run is held
    to its plain run outer iteration by outer iteration (one rank, where
    they are the same computation).  Returns rank 0's results."""
    r0 = ranks[0]
    for r in ranks[1:]:
        for case in specs:
            check(r[case]["sharded"]["trajectory"]
                  == r0[case]["sharded"]["trajectory"],
                  f"{tag} {case}: rank {r['rank']} saw another trajectory")
    for case, spec in specs.items():
        c = r0[case]
        plain, shd = c["plain"], c["sharded"]
        rtol = _fem37_rtol(spec)
        gib = [(q["peak_bytes"] or 0) / 2**30 for q in (plain, shd)]
        ratio = (shd["seconds_per_iteration"]
                 / plain["seconds_per_iteration"])
        log(f"[fem-sharded] {tag} {case} {spec}: {plain['iterations']} vs "
            f"{shd['iterations']} outer iterations (plain vs sharded); "
            f"final fobj {plain['trajectory'][-1]['fobj']:.12e} vs "
            f"{shd['trajectory'][-1]['fobj']:.12e}; max |dx| "
            f"{c['max_dx']:.3e}; {plain['seconds_per_iteration']:.4f} vs "
            f"{shd['seconds_per_iteration']:.4f} s per outer iteration "
            f"({ratio:.2f}x); "
            f"host reads {plain['reads']} vs {shd['reads']}; peak memory "
            f"{gib[0]:.3f} vs {gib[1]:.3f} GiB; launches {plain['launches']}"
            f" vs {shd['launches']}")
        if "local" in c:
            loc = c["local"]
            log(f"[fem-sharded] {tag} {case}: a fine-level CG vector holds "
                f"{loc['fine_cg_entries']} entries on rank 0 "
                f"({loc['node_row_entries']} per node row); the V-cycle "
                f"gathers at level {loc['gather_point']}; one fine-level CG "
                f"iteration exchanges {loc['per_cg_iteration']}")
        dev = max(abs(a["fobj"] - b["fobj"]) / abs(a["fobj"])
                  for a, b in zip(plain["trajectory"], shd["trajectory"]))
        log(f"[fem-sharded] {tag} {case}: largest relative fobj difference "
            f"over the outer iterations {dev:.3e}")
        if case == "eigtr":
            log(f"[fem-sharded] {tag} eigtr: KS {plain['ks']:.9e} vs "
                f"{shd['ks']:.9e}; LOBPCG block iterations {plain['lobpcg']} "
                f"vs {shd['lobpcg']}")
            check(not held or abs(shd["ks"] - plain["ks"]) <= rtol * max(
                1.0, abs(plain["ks"])), f"{tag} eigtr: KS differs")
            n = shd["iterations"]
            check(shd["launches"]["qn_roll_update"] == n,
                  f"{tag} eigtr: {shd['launches']['qn_roll_update']} "
                  f"qn_roll_update launches in {n} outer iterations")
        check(plain["iterations"] == shd["iterations"] > 0,
              f"{tag} {case}: other iteration counts")
        for a, b in zip(plain["trajectory"], shd["trajectory"]):
            check(not held or (a["k"] == b["k"] and abs(a["fobj"] - b["fobj"])
                               <= rtol * abs(a["fobj"])),
                  f"{tag} {case}: fobj differs at outer iteration {a['k']}: "
                  f"{a['fobj']} vs {b['fobj']}")
        check(all(math.isfinite(t["fobj"]) for t in shd["trajectory"]),
              f"{tag} {case}: a non-finite fobj")
    return r0


def _fem37_against(case, pa, pb, rtol, tag, ref, reads=False):
    """Hold run pb (``tag``) to run pa (``ref``): the same iterations, the
    final fobj and infeasibility within ``rtol`` relative (the eigen TR
    also its KS value), and with ``reads`` the same host reads."""
    fa, fb = pa["trajectory"][-1]["fobj"], pb["trajectory"][-1]["fobj"]
    log(f"[fem-sharded] {tag} {case} against {ref}: iterations "
        f"{pb['iterations']} vs {pa['iterations']}, final fobj {fb:.12e} vs "
        f"{fa:.12e} ({abs(fa - fb) / abs(fa):.3e} relative, held to "
        f"{rtol:.0e}); host reads {pb['reads']} vs {pa['reads']}; peak "
        f"memory per rank {(pb['peak_bytes'] or 0) / 2**30:.3f} vs "
        f"{(pa['peak_bytes'] or 0) / 2**30:.3f} GiB")
    check(pb["iterations"] == pa["iterations"],
          f"{tag} {case}: another iteration count than {ref}")
    check(abs(fa - fb) <= rtol * abs(fa),
          f"{tag} {case}: fobj differs from {ref}")
    ia, ib = (p["trajectory"][-1]["infeas"] for p in (pa, pb))
    check(abs(ia - ib) <= rtol * max(1.0, abs(ia)),
          f"{tag} {case}: infeasibility differs from {ref}")
    if case == "eigtr":
        check(abs(pa["ks"] - pb["ks"]) <= rtol * max(1.0, abs(pa["ks"])),
              f"{tag} eigtr: KS differs from {ref}")
    check(not reads or pb["reads"] == pa["reads"],
          f"{tag} {case}: {pb['reads']} host reads against {ref}'s "
          f"{pa['reads']}")


def _fem37_3d_f64(torch, base):
    """37(b)'s 3-D case in float64: one NCCL rank, then four, each solving
    plain and sharded; the four ranks' sharded run takes one rank's
    iterations and host reads, its final fobj within 1e-12 relative."""
    specs = {"fem3d": FEM37_3D_F64}
    args = ["--cases", "fem3d", "--fem3d", FEM37_3D_F64]
    one = _fem37_report(torch, "(b) f64 one rank",
                        _ranks(1, base / "b64_1", *args), True, specs)
    four = _fem37_report(torch, "(b) f64 four ranks",
                         _ranks(4, base / "b64_4", *args), False, specs)
    _fem37_against("fem3d", one["fem3d"]["sharded"],
                   four["fem3d"]["sharded"], RTOL["float64"],
                   "(b) f64 four ranks", "one rank", reads=True)


def phase_fem_sharded(torch):
    """37: the FEM and eigen models on x-strips; returns (a)'s launches of
    the sharded eigen TR."""
    import shutil
    t_phase = time.perf_counter()
    base = BUILD / "phase37"
    shutil.rmtree(base, ignore_errors=True)
    # the eigen TR with phase 26's options (the registry's defaults)
    args = ["--cases", ",".join(FEM37), "--eig-options", json.dumps(
        {"output_file": None, "tr_output_file": None})] + [
        a for case, spec in FEM37.items() for a in (f"--{case}", spec)]
    a = _fem37_report(torch, "(a)", _ranks(1, base / "a", *args), True)
    for case in FEM37:
        if a[case]["max_dx"] == 0.0:
            log(f"[fem-sharded] (a) {case}: the sharded run equals the "
                f"plain run bit for bit")
    count = torch.cuda.device_count()
    if count >= 4:
        # four ranks sum in another order than one: (b) is held to (a),
        # the float32 3-D case at float32's reordering scale (its float64
        # run below holds the strip code to 1e-12)
        b = _fem37_report(torch, "(b)", _ranks(4, base / "b", *args), False)
        for case, spec in FEM37.items():
            rtol = F32_REORDER_RTOL if case == "fem3d" else _fem37_rtol(spec)
            _fem37_against(case, a[case]["sharded"], b[case]["sharded"],
                           rtol, "(b)", "(a)")
        _fem37_3d_f64(torch, base)
    else:
        log(f"[fem-sharded] (b) not run: {count} card(s), four needed")
    log(f"[fem-sharded] phase 37 took {time.perf_counter() - t_phase:.2f} s")
    return a["eigtr"]["sharded"]["launches"]


# phase 38: the fused solvers' chunked execution, JAX's resume rule and the
# repo's examples on the port
CHUNK_IP = 5            # 38(a)'s int window on the main path
CHUNK_OUTER = 3         # and on bench.py's FusedMMA and FusedTR
EXAMPLES = ("brachistochrone", "cart_pole", "cholesky", "cops_electron",
            "dmo_topology", "dmo_truss", "eigenvalue", "fem_frequency",
            "fem_topology", "fem_topology3d", "fem_topology_tr", "maratos",
            "openmdao_paraboloid", "reduced_problem", "rosenbrock", "sellar",
            "small_problems", "sparse_rosenbrock", "ssto", "topology")
# the examples that take more than ~30 s of the card's time at the JAX
# script's defaults, with the flags and the main's keywords (cart_pole's
# cap is an argument of its main, not a flag) that cut their outer
# iterations (each
# alone on an H100 at the defaults or at a few iterations, this script's
# phase 38 and scripts/torch_time_examples.py: cart_pole 339 s
# for 109 iterations, 34 s for 10; fem_frequency 107 s for 5, 22 s of it
# the model's calibration; fem_topology 5.6 s for 5 of 60; fem_topology3d
# 4.9 s for 5 of 40; fem_topology_tr 14.8 s for 5 of 40 with its 4
# batched starts)
EXAMPLE_CUTS = {"cart_pole": ([], {"max_iters": 8}),
                "fem_frequency": (["--iters", "1"], {}),
                "fem_topology": (["--iters", "30"], {}),
                "fem_topology3d": (["--iters", "30"], {}),
                "fem_topology_tr": (["--iters", "12"], {})}

# 38(c)'s hold on each example's result, by path into what its main()
# returns: True, the flag holds (where the JAX script converges at its
# uncut defaults); ("<", b), below b; a number, within EXAMPLE_RTOL of the
# port's run of the same program and cut on the CPU in float64 (printed by
# `python3 scripts/torch_time_examples.py --cuts --device cpu`), plus
# EXAMPLE_ATOL for values near 0.  float64 on the card differs from the CPU
# only in summation order; topology, fem_topology3d and fem_topology_tr
# run float32 on the card and are held at F32_EXAMPLE_RTOL (their f32
# runs ended 7e-5 to 3.7e-3 from the CPU's float64, topology's at another
# iteration, as its script's float32 tolerances stop it sooner)
EXAMPLE_RTOL, EXAMPLE_ATOL, F32_EXAMPLE_RTOL = 1e-6, 1e-9, 1e-2
F32_EXAMPLES = ("topology", "fem_topology3d", "fem_topology_tr")
EXAMPLE_HOLDS = {
    "brachistochrone": {"converged": True, "tf": 1.8017044167736167},
    "cart_pole": {"fobj": 1.3076596529901883},
    "cholesky": {"0/nnz_amd": 3800, "1/nnz_amd": 20462,
                 "2/nnz_amd": 107290, "0/residual": ("<", 1e-10),
                 "1/residual": ("<", 1e-10), "2/residual": ("<", 1e-10)},
    "cops_electron": {"converged": True, "energy": 150.88156833375507},
    "dmo_topology": {"converged": True, "fobj": 0.008022932941832605,
                     "mass": 0.29993063419882515},
    "dmo_truss": {"fobj": 1.5845817701547584},
    "eigenvalue": {"converged": True, "fobj": 0.510436412941218},
    "fem_frequency": {"mass": 0.950001027012103,
                      "freqs/0": 0.012910915066087667},
    "fem_topology": {"fobj": 0.1633437808147086},
    "fem_topology3d": {"fobj": 0.15234431678001506,
                       "volume": 0.29993224805313523},
    "fem_topology_tr": {"fobj": 0.3088204315048228,
                        "batched_fobj/0": 0.28847009650569627,
                        "batched_fobj/3": 0.3011599610861806},
    "maratos": {"converged": True, "fobj": 1.6715728751956933,
                "x/0": 1.4142135623572025},
    "reduced_problem": {"full/1": 0.45000043712142496,
                        "full/2": 0.45000043712142496},
    "rosenbrock": {"converged": True, "fobj": 1.1405980075209335e-13,
                   "x/0": 0.9999996624523957},
    "sellar": {"converged": True, "fobj": 0.7500454041638754},
    "small_problems": {"convex quadratic/best": 0.31250001653720605,
                       "quartic-quadratic/best": -0.49999996533888147,
                       "double well/best": 0.4999999999999999,
                       "sine saddle/best": -31.180733385187974,
                       "rosenbrock/best": 8.295073371128154e-17},
    "sparse_rosenbrock": {"converged": True, "fobj": 8.733964530427047e-17},
    "ssto": {"converged": True, "tf": 481.89706828440603},
    "topology": {"converged": True, "fobj": 2.405844503929197},
}


def _example_holds(name, out):
    """The entries of EXAMPLE_HOLDS[name] that ``out`` misses, each as
    (path, value, hold, relative gap or None), and the largest relative
    gap of its numbers to their references."""
    rtol = F32_EXAMPLE_RTOL if name in F32_EXAMPLES else EXAMPLE_RTOL
    misses, largest = [], 0.0
    for path, hold in EXAMPLE_HOLDS[name].items():
        value = out
        for key in path.split("/"):
            value = value[int(key)] if isinstance(value, list) else value[key]
        if hold is True:
            ok, gap = bool(value), None
        elif isinstance(hold, tuple):
            ok, gap = math.isfinite(value) and abs(value) < hold[1], None
        else:
            gap = abs(value - hold) / max(abs(hold), 1e-300)
            ok = (math.isfinite(value)
                  and abs(value - hold) <= rtol * abs(hold) + EXAMPLE_ATOL)
            largest = max(largest, gap)
        if not ok:
            misses.append((path, value, hold, gap))
    return misses, largest


def _jax_windows(chunk, steps, final_k):
    """The iterations at which JAX's run_chunked calls on_chunk for an int
    ``chunk`` from k = 0 (paropt_tpu/utils/chunked.py:64-69): a boundary
    at each multiple of ``chunk`` before the window of the last of
    ``steps`` steps, then the final count."""
    windows = -(-steps // chunk)
    return [chunk * i for i in range(1, windows)] + [final_k]


def _unique(ks):
    """A write_output hook of cadence 1 fires once per count."""
    return sorted(set(ks))


def _chunked_ip(torch):
    """38(a) on the main path: FusedIP at n = 2^20 float32 with
    jit_loop=True in one window, in windows of CHUNK_IP and 'auto'.
    Returns the launches of the chunked run."""
    from paropt_torch.ops import kernels
    tag = f"[chunked ip n={N_MAIN} float32]"
    fused, data, x0, qn0 = _build_solver(torch, N_MAIN, torch.float32,
                                         "cuda")
    fused.solve(x0, data, (), qn0, None, max_iters=2)          # warm-up
    one = fused.solve(x0, data, (), qn0, None, jit_loop=True)
    runs = {}
    for chunk in (CHUNK_IP, "auto"):
        seen = []
        kernels.reset_launches()
        reads = fused.syncs.count
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = fused.solve(x0, data, (), qn0, None, jit_loop=True, chunk=chunk,
                         on_chunk=lambda s: seen.append(int(s.k)))
        torch.cuda.synchronize()
        runs[chunk] = (st, seen, dict(kernels.LAUNCHES),
                       time.perf_counter() - t0, fused.syncs.count - reads)
    n = int(one.k)
    for chunk, (st, seen, launches, wall, reads) in runs.items():
        log(f"{tag} chunk={chunk!r}: {int(st.k)} iterations (one window: "
            f"{n}), fobj {float(st.fobj)!r} (one window: "
            f"{float(one.fobj)!r}), hook at {seen}, {reads} host reads, "
            f"{wall:.3f} s; launches {launches}")
        check(int(st.k) == n and torch.equal(st.vars.x, one.vars.x)
              and torch.equal(st.fobj, one.fobj),
              f"chunk={chunk!r} does not end on the one-window solve's bits")
        for name, count in launches.items():
            check(count > 0, f"kernel {name} was not launched in the "
                  f"chunk={chunk!r} solve")
    steps = n + 1 if bool(one.converged) else n
    want = _jax_windows(CHUNK_IP, steps, n)
    check(bool(one.converged), "the one-window solve did not converge")
    check(runs[CHUNK_IP][1] == want, f"hook at {runs[CHUNK_IP][1]}, JAX's "
          f"rule gives {want}")
    check(runs["auto"][1][:2] == [1, 2], "'auto' did not probe iterations "
          "1 and 2")
    return runs[CHUNK_IP][2]


def _chunked_outer(torch, kind):
    """38(a) on bench.py's FusedMMA 96x48 (phase 7) or FusedTR 48x24
    (phase 10), float32: chunk=CHUNK_OUTER against chunk=None, the hook
    at JAX's windows.  Returns the unchunked solver and its final state."""
    from paropt_torch.models.fem_topology import FEMTopology
    from paropt_torch.mma import FusedMMA
    mma = kind == "mma"
    mesh = (96, 48) if mma else (48, 24)
    tag = f"[chunked {kind} {mesh[0]}x{mesh[1]} float32]"
    out = {}
    for chunk in (None, CHUNK_OUTER):
        prob = FEMTopology(*mesh, cg_iters=25, solver="mgcg",
                           dtype=torch.float32, device="cuda")
        seen = []
        prob.write_output = lambda it, x: seen.append(int(it))
        if mma:
            solver = FusedMMA(prob, {"mma_max_iterations": 60,
                                     "mma_output_file": None,
                                     "dtype": "float32",
                                     "write_output_frequency": 1})
        else:
            solver = _tr_solver(prob, "float32",
                                tr_write_output_frequency=1)
        t0 = time.perf_counter()
        res, st = solver.solve(chunk=chunk)
        torch.cuda.synchronize()
        out[chunk] = (solver, res, st, seen, time.perf_counter() - t0)
        log(f"{tag} chunk={chunk!r}: {res['niter']} outer iterations, fobj "
            f"{res['fobj']!r}, hook at {seen}, "
            f"{out[chunk][4]:.2f} s")
    (s0, r0, st0, _, _), (_, r1, st1, seen, _) = out[None], out[CHUNK_OUTER]
    x0, x1 = (st0.x, st1.x) if mma else (st0.xk, st1.xk)
    check(r1["niter"] == r0["niter"] and r1["fobj"] == r0["fobj"]
          and torch.equal(x0, x1), f"{tag} chunk={CHUNK_OUTER} does not end "
          "on the one-window solve's bits")
    n = r0["niter"]
    steps = n + 1 if (mma and r0["converged"]) else n
    want = _unique(_jax_windows(CHUNK_OUTER, steps, n))
    check(seen == want, f"{tag} hook at {seen}, JAX's rule gives {want}")
    return s0, st0


def _chunked_batched(torch):
    """38(a): FusedTR.solve_batched on phase 24's configuration (k = KB
    starts of SyntheticTopology(2^20), float32) in windows of 2 against one
    window: the same counts and bits, every kernel launched with its
    instance axis."""
    from paropt_torch.models.topology import SyntheticTopology
    from paropt_torch.ops import kernels
    tag = f"[chunked batched tr k={KB} n={N_MAIN} float32]"
    prob = SyntheticTopology(n=N_MAIN, block=BLOCK, dtype=torch.float32,
                             device="cuda")
    x0, _, _ = prob.get_vars_and_bounds()
    x0s = _starts(torch, x0, KB, 0.5, 1.5)
    _, one = _tr_solver(prob, "float32").solve_batched(x0s, chunk=None)
    kernels.reset_launches()
    t0 = time.perf_counter()
    res, st = _tr_solver(prob, "float32").solve_batched(x0s, chunk=2)
    torch.cuda.synchronize()
    batched = dict(kernels.BATCHED_LAUNCHES)
    log(f"{tag} chunk=2: outer iterations {st.k.tolist()} (one window: "
        f"{one.k.tolist()}), fobj {res['fobj'].tolist()}, "
        f"{time.perf_counter() - t0:.3f} s; instance-axis launches "
        f"{batched}")
    check(st.k.tolist() == one.k.tolist() and torch.equal(st.xk, one.xk)
          and torch.equal(st.fk, one.fk),
          f"{tag} windows of 2 do not end on the one-window batch's bits")
    check(bool(res["converged"].all()), f"{tag} an instance did not "
          "converge")
    for name, count in batched.items():
        check(count > 0, f"{tag} kernel {name} had no instance-axis launch")


def _resume_rule(torch, solver, final):
    """38(b): FusedMMA 96x48 from its state at k = 30: the default stops
    at the absolute cap (60: the uninterrupted run's bits; 40: 40), and
    jit_loop=False runs the cap more (10 from 30: 40, the bits of the
    default's 40)."""
    tag = "[resume mma 96x48 float32]"
    mo = solver._mo

    def capped(n, **kw):
        solver._mo = mo._replace(max_iterations=n)
        try:
            return solver.solve(**kw)
        finally:
            solver._mo = mo

    _, st30 = capped(30, chunk=None)
    check(int(st30.k) == 30, f"{tag} the first solve stopped at "
          f"{int(st30.k)}")
    rows, ends = [], {}
    for cap, jit_loop, want in ((60, True, 60), (40, True, 40),
                                (10, False, 40)):
        res, st = capped(cap, state0=st30, jit_loop=jit_loop)
        rows.append((cap, jit_loop, res["niter"]))
        check(res["niter"] == want, f"{tag} cap {cap}, jit_loop={jit_loop}: "
              f"{res['niter']} outer iterations, JAX's rule gives {want}")
        ends[(cap, jit_loop)] = st.x
    check(torch.equal(ends[(60, True)], final.x), f"{tag} the default "
          "resume to 60 does not land on the uninterrupted run's bits")
    check(torch.equal(ends[(10, False)], ends[(40, True)]), f"{tag} 10 "
          "more steps (jit_loop=False) and the default to 40 differ")
    log(f"{tag} from k = 30, (cap, jit_loop, outer iterations): {rows}; "
        "the default to 60 holds the uninterrupted run's bits, 10 more "
        "steps those of the default to 40")


def phase_examples(torch):
    """Phase 38(c): every example program's main() at the JAX script's default
    arguments (less the cuts in EXAMPLE_CUTS), in build/phase38; its
    output in build/phase38/<name>.out, its last lines, result and seconds
    printed, its result held to EXAMPLE_HOLDS.  openmdao_paraboloid must
    end with the JAX script's message when openmdao is absent."""
    import contextlib
    import importlib
    import io
    from paropt_torch.ops import kernels
    work = BUILD / "phase38"
    work.mkdir(parents=True, exist_ok=True)
    cwd = os.getcwd()
    total = time.perf_counter()
    try:
        os.chdir(work)
        for name in EXAMPLES:
            argv, kw = EXAMPLE_CUTS.get(name, ([], {}))
            if argv or kw:
                cut = " ".join(argv + [f"{k}={v}" for k, v in kw.items()])
                log(f"[example {name}] cut to {cut} (more than ~30 s of "
                    f"the card's time at the defaults)")
            mod = importlib.import_module(f"paropt_torch.examples.{name}")
            buf = io.StringIO()
            kernels.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            message, out = None, None
            with contextlib.redirect_stdout(buf):
                try:
                    out = mod.main(list(argv), **kw)
                except SystemExit as e:
                    message = e.code
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            text = buf.getvalue()
            (work / f"{name}.out").write_text(text)
            last = [line for line in text.splitlines() if line.strip()][-3:]
            log(f"[example {name}] {wall:.2f} s; launches "
                f"{dict(kernels.LAUNCHES)}; result {out!r}"
                + (f"; exit {message!r}" if message is not None else ""))
            for line in last:
                log(f"[example {name}]   {line}")
            if name == "openmdao_paraboloid" and out is None:
                check(isinstance(message, str)
                      and message.startswith("openmdao is not installed"),
                      f"openmdao_paraboloid ended with {message!r}")
            else:
                check(message is None and isinstance(out, (dict, list)),
                      f"example {name} ended with {message!r}")
                misses, largest = _example_holds(name, out)
                log(f"[example {name}]   held: {len(EXAMPLE_HOLDS[name])} "
                    f"values, largest relative gap to the CPU's float64 "
                    f"{largest:.3e}")
                check(not misses, f"example {name} misses its holds "
                      f"(path, value, hold, relative gap): {misses}")
    finally:
        os.chdir(cwd)
    log(f"[examples] all {len(EXAMPLES)} in "
        f"{time.perf_counter() - total:.1f} s")


def phase_chunked(torch):
    """Phase 38 (a) and (b): chunked solves bit-equal to one window (the
    main path, bench.py's FusedMMA and FusedTR, a batched main path), the
    hook at JAX's windows, and JAX's resume rule.  Returns (a)'s chunked
    main-path launches."""
    t_phase = time.perf_counter()
    launches = _chunked_ip(torch)
    solver, final = _chunked_outer(torch, "mma")
    _chunked_outer(torch, "tr")
    _chunked_batched(torch)
    log(f"[chunked] phase 38(a) took {time.perf_counter() - t_phase:.2f} s")
    t_b = time.perf_counter()
    _resume_rule(torch, solver, final)
    log(f"[chunked] phase 38(b) took {time.perf_counter() - t_b:.2f} s")
    return launches


# phases 4-38 as steps on a shared dict: each reads what an earlier step of
# its group left there; the entries ending in "_launches" (phase 4's is
# "launches") are the kernels line's columns
STEPS = {
    "4": lambda t, c: c.update(zip(("launches", "ip_iters", "ip_fobj",
                                    "ip_x"), phase_slice(t))),
    "5": lambda t, c: phase_crosscheck(t),
    "6": lambda t, c: [phase_mma_full(t, d, iters=10)
                       for d in (t.float32, t.float64)],
    "7": lambda t, c: c.update(zip(("mma_fobj", "mma_x", "mma_files"),
                                   phase_mma_bench(t))),
    "8": lambda t, c: phase_mma_crosscheck(t),
    "9": lambda t, c: c.update(zip(("tr_launches", "tr_niter", "tr_fobj"),
                                   phase_tr_full(t))),
    "10": lambda t, c: phase_tr_bench(t),
    "11": lambda t, c: phase_tr_crosscheck(t),
    "12": lambda t, c: c.update(host_tr_launches=phase_host_tr_full(
        t, c["tr_niter"], c["tr_fobj"])),
    "13": lambda t, c: c.update(zip(("host_ip_launches", "host_ip_iters"),
                                    phase_host_ip_full(t, c["ip_iters"]))),
    "14": lambda t, c: phase_host_mma(t),
    "15": lambda t, c: phase_host_crosscheck(t),
    "16": lambda t, c: c.update(nk_launches=phase_nk_full(
        t, c["ip_iters"], c["host_ip_iters"])),
    "17": lambda t, c: phase_nk_crosscheck(t),
    "18": lambda t, c: phase_mma3d_full(t),
    "19": lambda t, c: phase_mma3d_bench(t),
    "20": lambda t, c: phase_3d_crosscheck(t),
    "21": lambda t, c: c.update(batched_launches=phase_batched_ip(t)),
    "22": lambda t, c: phase_batched_small(t),
    "23": lambda t, c: phase_batched_mma(t),
    "24": lambda t, c: c.update(batched_tr_launches=phase_batched_tr(t)),
    "25": lambda t, c: phase_batched_crosscheck(t),
    "26": lambda t, c: c.update(zip(("eig_launches", "eig_s_per_iter"),
                                    phase_eig3d_full(t))),
    "27": lambda t, c: phase_eig_bench(t),
    "28": lambda t, c: c.update(eig_singles=phase_eig_crosscheck(t)),
    "29": lambda t, c: c.update(csr_launches=phase_csr_full(t)),
    "30": lambda t, c: c.update(zip(("electron_launches", "ssto_launches"),
                                    phase_cops_ssto(t))),
    "31": lambda t, c: phase_csr_crosscheck(t),
    "32": lambda t, c: c.update(eig_batched_launches=phase_eig3d_batched(
        t, c["eig_s_per_iter"])),
    "33": lambda t, c: c.update(
        eig_batched_f64_launches=phase_eig_batched_crosscheck(
            t, c["cpu_job"], c["eig_singles"])),
    "34": lambda t, c: c.update(zip(
        ("ckpt_ip_launches", "ckpt_host_ip_launches"), phase_checkpoints(
            t, c["ip_iters"], c["ip_fobj"], c["ip_x"], c["mma_fobj"],
            c["mma_x"], c["mma_files"]))),
    "35": lambda t, c: c.update(zip(
        ("compat_launches", "compat_native_launches", "function_launches"),
        phase_surface(t))),
    "36": lambda t, c: c.update(sharded_launches=phase_sharded(
        t, c["launches"], c["ip_iters"], c["ip_fobj"], c["ip_x"])),
    "37": lambda t, c: c.update(fem_sharded_launches=phase_fem_sharded(t)),
    "38": lambda t, c: c.update(chunked_launches=phase_chunked(t)),
    "38c": lambda t, c: phase_examples(t),
}
# after phase 3, each group runs in a process of its own, all at once on
# the one card: the phases keep the card mostly idle (their hosts' Python
# paces them, PERF.md), so one after another they took 880-1,050 s of the
# script's 1,200 and more on a slower host.  A group holds the phases
# whose results another of its phases reads; the groups are of about
# equal length
GROUPS = (("4", "5", "6", "7", "8", "13", "16", "34", "36"),
          ("9", "10", "11", "12", "14", "15", "17", "18", "19", "20"),
          ("21", "22", "23", "24", "25", "37"),
          ("26", "27", "29", "30", "31", "32"),
          ("28", "33", "35"),
          ("38",),
          ("38c",))
DEADLINE_S = 1100    # from the script's start; the groups are then ended


def _stamp(t0, phase):
    log(f"[time] phase {phase} done at {time.time() - t0:.1f} s")


def _run_group(torch, index, t0):
    """One group's phases (a child process); writes its launch columns."""
    _no_tf32(torch)
    ctx = {}
    if "33" in GROUPS[index]:
        # phase 33's CPU batched solves run in a child process meanwhile
        ctx["cpu_job"] = _eig33_cpu_start()
    try:
        for phase in GROUPS[index]:
            STEPS[phase](torch, ctx)
            _stamp(t0, phase)
    finally:
        job = ctx.get("cpu_job")
        if job is not None and job.poll() is None:
            job.kill()
            job.wait()
    (BUILD / f"chip_smoke_group{index}.json").write_text(json.dumps(
        {k: v for k, v in ctx.items() if k.endswith("launches")}))


def _run_groups(t0):
    """Start every group at once and wait for all; print each group's
    output in turn.  A group that fails or outlasts the deadline ends all
    of them (each with the processes it started) and fails the script.
    Returns the groups' launch columns."""
    procs, logs = [], []
    try:
        for i, group in enumerate(GROUPS):
            logs.append(BUILD / f"chip_smoke_group{i}.log")
            (BUILD / f"chip_smoke_group{i}.json").unlink(missing_ok=True)
            with open(logs[-1], "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"), "--group",
                     str(i), "--t0", repr(t0)], cwd=str(ROOT), stdout=out,
                    stderr=subprocess.STDOUT, start_new_session=True))
            log(f"[groups] group {i} (phases {', '.join(group)}) started, "
                f"pid {procs[-1].pid}")
        failed = None
        while failed is None and any(p.poll() is None for p in procs):
            if time.time() - t0 > DEADLINE_S:
                failed = (None, f"still running after {DEADLINE_S} s")
            for i, p in enumerate(procs):
                if p.poll() not in (None, 0):
                    failed = (i, f"group {i} exited with {p.returncode}")
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None or failed is not None:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                p.wait()
    for i, group in enumerate(GROUPS):
        log(f"[groups] group {i} (phases {', '.join(group)}): "
            f"exit {procs[i].returncode}")
        sys.stdout.write(logs[i].read_text())
        sys.stdout.flush()
    if failed is None and any(p.returncode for p in procs):
        failed = (None, "a group failed")
    check(failed is None, failed and failed[1])
    cols = {}
    for i in range(len(GROUPS)):
        cols.update(json.loads(
            (BUILD / f"chip_smoke_group{i}.json").read_text()))
    return cols


def main():
    import torch
    check((ROOT / "paropt_torch" / "csrc").is_dir(),
          f"paropt_torch not found beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    if "--group" in sys.argv:
        args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
        _run_group(torch, int(args["--group"]), float(args["--t0"]))
        return
    t0 = time.time()
    phase_device(torch)
    _stamp(t0, "1")
    phase_build()
    _stamp(t0, "2")
    timing = phase_kernels(torch)
    _stamp(t0, "3")
    phase_kernels_batched(torch, timing)
    _stamp(t0, "3b")
    cols = _run_groups(t0)
    rows = []
    for name, (source, replaces) in KERNELS.items():
        r = timing[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     **{key: cols[key][name] for key in sorted(
                         cols, key=lambda k: k != "launches")},
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": None,
                     **{key: r[key] for key in (
                         "batched_max_abs_err", "batched_ms", "singles_ms",
                         "batched_plain_ms", "batched_bound_ms",
                         "kb32_ms", "kb32_singles_ms", "kb32_bound_ms")
                         if key in r}})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
