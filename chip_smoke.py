#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, report lines before the last:

1. device — require CUDA; print the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them; check TF32 is off for float32 matmuls.
2. build  — compile every Hopper kernel library of ``pyapes_tpu_torch/csrc``
   (one ``nvcc`` per translation unit, all started together); print ptxas
   registers/spills, and each plane-march kernel's registers by name.
3. kernel — each kernel against its plain PyTorch version on the card
   (axis stencil, radius 1 and 2 (mixed 3/5-point axes), the plane march
   and the per-point kernel each forced: the 3-D kernel, edge and
   advection shapes x f32/bf16/f64, the march at several plane chunks with
   the same bits at each and on another call; the shape's choice at five
   shapes, a 2-D grid among them; both kernels of both radii timed per
   call and back to back at 512^3, 256^3, 129^3, 128^3 and 64^3 f32, the
   Poisson model's 65^3 and 129^3 f64 and every level of the 512^3 V-cycle
   in bf16, beside the shape's choice and a device copy; the stencil
   alpha-dot, its plane march (at several plane chunks) and per-point
   kernel each forced, A x with the same bits, the dot against the plain
   version's f64 dot, at the 3-D kernel and edge shapes and 256^3 x
   f32/bf16/f64; the Jacobi family:
   five shapes x f32/bf16/f64 x their variants, dots included; the
   variable-Γ diffusion apply and Jacobi pass, the plane march and the
   per-point kernel each forced: the same shapes plus a 2-D grid and the
   plane marches' edge shapes x f32/bf16/f64 x isotropic/stacked Γ x
   arithmetic/harmonic faces x no/Neumann surgery x the apply and the
   three Jacobi modes, the march at several plane chunks with the same
   bits at each and on another call, and both timed at every level of the
   Darcy 256^3 and 512^3 V-cycles beside the shape's choice; the
   halo-extended stencil, its plane march (at several plane chunks) and
   per-point kernel each forced, with the same bits:
   four blocks, odd sizes and single-row axes among them, x the three ext
   flags x f32/bf16/f64 x vdim 1/3 x a new or a strided output, and in
   bf16 on the (4, 2, 1) blocks of every 512^3 MG level the decomposed
   cycle applies block-wise; the alpha-dot at 512^3, 256^3 and 128^3 f32
   and the halo-extended stencil on the (4, 2, 1) blocks of those grids in
   f32 and bf16, both kernels timed per call and back to back beside the
   shape's choice, a device copy and the bound (``dot_ext_level_times``);
   the double sweep also at its own edge
   shapes, with explicit plane chunks, and the worst err/limit of all its
   cases, as is the single sweep with its dot), and kernel vs plain timed
   at 512^3 (CUDA events; the halo-extended kernel on the eight blocks of
   512^3 in (4, 2, 1), and the whole block-wise apply against the global
   kernel; the single and double sweeps also at every level of the 512^3
   V-cycle, per call and back to back on the device), beside a CSR product
   (``torch.mv``) of the same linear operator (the variable-Γ apply at
   its fixed Γ), the library yardstick, with GB/s and the share of the
   bound. The 2-D axis stencil's row march on the rz vectors of the
   rz/RFP path (``check_axis_rz``): the 512 x 1024 Laplacian with the
   potentials' faces (r = 0 symmetry surgery, Dirichlet at ru and on z)
   and without faces (the raw r = 0 row), and every level of the rz
   V-cycle, in bf16, f32 and f64, the per-point kernel's bits at several
   row chunks and on another call; timed at 512 x 1024 f32 per call and
   back to back beside the per-point kernel, the plain version, a CSR
   product, a device copy and the bound. The same on the channel's
   operators (``check_axis_channel``): the 441 x 83 u, v and p Laplacians
   of the 2D-2 cell and every level of its pressure V-cycle in f64 (and
   f32, bf16); the pressure operator timed likewise. The peer kernels
   (``phase_peer``, ``csrc/peer.cu``): ``peer_put`` + ``peer_wait`` on
   one card (the put on one stream, the wait on another) against the plain
   ``copy_`` in f32/f64/bf16 on the halo's strided ghost faces into their
   slots, a block into its place in a 512^3 grid and a reduction's stacked
   partials (bits equal), each pair timed beside the plain copy and its
   bound; the probe's ``per_card_graphs`` variant on two streams of the
   card (two graphs, each a WHILE loop of 3 passes, joined by the peer
   kernels: the host loop's 14 on two replays; its launches are the
   kernels' drive); a wait with no put ends with an error within its
   bound, in a process of its own.
4. fastdiag path — the 512^3 f32 all-Dirichlet random-RHS Poisson solve
   through ``Solver.solve`` (fastdiag), as ``bench.py`` drives the JAX
   package: one warm-up and three timed solves; convergence, kernel
   launches per solve, and the true residual recomputed independently.
   Then the same solve with ``DomainDecomposition((4, 2, 1))``: the
   halo-extended kernel in every solve, the same passes, the solution
   equal to the undecomposed one within ``FD_DECOMP_AGREE``, the true
   residual recomputed in f64.
5. MG-PCG path — the same problem through ``bench.py``'s cg config (bf16
   V(2,2), FMG, fused r.z) at 512^3, the same decomposed in (4, 2, 1)
   (the halo-extended kernel in every solve, within 2 iterations of the
   undecomposed solve), and a V(1,1) fused-r.z config at 256^3 (where the
   Jacobi + dot kernel runs): the same checks, each kernel's launches per
   solve, the true residual in f32 and f64.
6. Darcy variable-Γ MG-PCG path — ``bench.py``'s ``bench_darcy`` problem
   (256^3 f32, Γ = exp(0.8 sin 2πx sin 2πy sin 2πz), bf16 V(2,2) FMG)
   through ``Solver.solve``: the same checks, the true residual
   recomputed with the plain variable-Γ operator, and exactly
   ``DARCY_LAUNCHES`` variable-Γ launches per solve.
7. model — ``PoissonSolver`` on the runner's 3-D problem at 65^3 and 129^3
   (f64): convergence, and the error against the exact solution equal to
   the predicted discretization error; the runner's ``darcy`` case (2-D,
   harmonic faces, MG-BiCGSTAB, f64) at 65^2 against the JAX package's
   numbers and at 1025^2: flux balance and the Wiener bounds.
8. advection kernels — the Div and Conv kernels (the shape's choice) and
   the 5-point axis stencil against their plain versions (the 3-D shapes,
   a 2-D and a 1-D grid, a 3-node axis with Neumann faces on both sides,
   mixed 3/5-point axes; f32/bf16/f64; every limiter, both Div forms, the
   surgery kinds none/neumann/periodic, scalar and vector targets); the
   Div and Conv plane march and per-point kernel each forced on the
   march's variants (Div central in both forms and upwind, vector and
   scalar targets; Conv central and upwind) at the 3-D shapes, two grids
   of the march's FULL instance and the paths' 256^3, every dtype and
   surgery kind, the march at several plane chunks with the same bits at
   each, on another call and as the per-point kernel; timed against the
   plain versions at 256^3 and 512^3 f32 (per call and on the device, the
   per-point kernel beside the march), at 256^3 against a CSR product of
   the same operator at its fixed advector, and both kernels on both path
   calls at 512^3, 256^3, 129^3, 128^3 and 64^3 f32 and 256^3 bf16 and
   f64 beside a device copy and the bound (``adv_level_times``).
9. implicit-advection paths, f32 on one card, through the models' ``step``:
   ``BurgersND`` at 257^3 on the periodic box (Taylor-Green start, 3 steps
   of dt 0.01: 9 BiCGSTAB + FD-preconditioner solves through the convection
   kernel); ``AdvectionDiffusion`` at 256^3 with a velocity field (upwind,
   the Div kernel, 5 steps of dt 1e-3) and with a constant velocity and
   QUICK (the 5-point kernel, 3 steps); per path the wall per step (median
   after the first, warm-up, step), ``itr`` per solve, kernel launches per
   step, peak memory, and the true relative residual of the last solve
   recomputed with the plain operators in f64. Then ``BurgersND`` at 257^3
   in f64 (the JAX test's precision) from an x-only field (the 1-D exact
   solution, nu = 0.25, 10 steps): v and w stay zero, u stays
   y/z-independent and matches the 1-D exact solution (the JAX package's
   gates).
10. NS cavity, through ``LidDrivenCavity.step``: ``bench.py``'s cavity
   cell (3-D, Re 100, regularized lid, dt 0.25/n, f32, eager, the default
   ``sync``) at 128^3 and 256^3, 2 warm steps then 5 steps three times:
   wall per step (the median run),
   ``ns_cavity3d_cell_steps_per_s_chip_eager``, ``itr`` per solve, the
   Hopper kernels' launches per step, peak memory, max|div| and the bulk
   divergence, and no unconverged solve; the implicit-advection cavity at
   128^3 (3 steps, the convection kernel); the card against the CPU in
   f64 (33^3 cavity, 10 steps; 33^2 ``NaturalConvection``, Ra 1e3, 3
   steps): the same itr solve by solve, the fields within 1e-10; and the
   JAX model tests' physical gates on the card (the 33^2 cavity, 150
   steps; the Ra 1e3 convection, 60 steps: Nu within 3% of 1.118).
11. rz/RFP, through ``RosenbluthPotentials`` and ``RFPEvolution``:
   ``bench.py``'s rz cell (``bench_rz``: Cylinder[0:4, -4:4] at 512 x 1024
   f32, the potentials H and G of a Maxwellian by the default config, then
   a new ``RFPEvolution(mesh, H, G)`` and 5 ``step_implicit`` of dt 1e-3,
   the FD-preconditioned BiCGSTAB of ``fdm.custom``): one warm-up and
   three timed runs: the wall, ``rfp_rz_dof_per_s_chip`` (nr nz 7 / the
   fastest run, on a line of its own), itr / tol / converge per solve, the
   solves at max_it (listed, not failed: bench's tolerances lie below the
   f32 floor), the true residuals recomputed in f64 with the plain
   operators, the axis-stencil launches per run, the host syncs of a run
   (torch's sync debug mode), peak memory and the density drift; the
   potentials again under ``{"method": "bicgstab", "precond": "mg"}`` (the
   JAX package's resolution: the rz V-cycle, the kernel on every level);
   the card against the CPU in f64 (``tests/test_models.py``'s 32 x 48
   implicit steps; ``run_selfconsistent`` at 40 x 80): the same itr solve
   by solve, the pdf within 1e-10; the JAX tests' gates on the card
   (``test_rosenbluth.py``: the analytic Maxwellian H within 1%,
   isotropization, the steady Maxwellian; ``test_muscl.py``: positivity,
   total variation and mass).
12. channel, through ``ChannelFlow.step``: the Schäfer–Turek 2D-2 cell of
   ``demos/schafer_turek.py`` (flow past a cylinder at Re 100, 441 x 83
   f64, the demo's grid; ``SchaferTurek``): 2 warm steps, then 50 steps
   timed in chunks of 25, each ending in a synchronize, with the demo's
   per-step diagnostics (staircase and control-volume forces, the
   pressure difference) kept on the card: wall per step (the median
   chunk), cell-steps/s, itr per solve (u, v, p), the axis-stencil
   launches per step, the host syncs of a step (torch's sync debug mode),
   peak memory, the flux balance and the last step's forces; no solve at
   ``max_it``. The same at 1761 x 329 for 10 steps (the scale rung). The
   card against the CPU in f64 on ``tests/test_obstacle.py``'s 97 x 33
   cylinder channel for 40 steps (the same itr solve by solve, the fields
   within 1e-10), and the JAX tests' gates on that run (flux imbalance
   under 2%, no slip in the body, the wake, drag > 0, |lift| < 0.3 drag).

13. periodic: the MG-PCG of ``bench.py``'s cg config on the torus (axes 0
   and 1 periodic, 513 x 513 x 512 nodes, the reduced torus 512^3, axis 2
   Dirichlet; the fused r.z is off on a torus) with phase 5's checks and
   ``jacobi3d``/``jacobi3d_x2``/``axis_stencil_dot`` in every solve; the
   Jacobi family against its plain versions with a torus level's masks
   (``mask_axes`` (2,) and ()) at every level of that cycle x
   f32/bf16/f64 x the variants, and timed at 512^3 and 256^3 bf16 with the
   full and the torus masks; the TGV-3D Smagorinsky LES cell of
   ``demos/tgv3d_les.py`` (``tgv_model``: ``PeriodicFlow`` at 64^3 nodes
   f32, Re 1600, cs 0.17, dt 0.2 dx; 2 warm steps, 3 windows of 10): wall
   per step, cell-steps/s, itr per solve (u, v, w / p), the Hopper
   launches and host syncs per step, peak memory, <E>(0) within 2e-3 of
   1/8, no solve at ``max_it``; its 257^3 rung (10 steps, the plane
   marches of ``diff_field`` and ``axis_stencil``); the card against the
   CPU in f64 (17^3 Beltrami flow 20 steps, Smagorinsky TGV 10 steps: the
   same itr, 1e-10) and the 65^2 Taylor-Green test's gates on the card.

14. fused: the cavity at 128^3 f32 (``cavity_model``), the 2D-2 cell at
   441 x 83 f64 (``SchaferTurek``, the demo's per-step diagnostics through
   ``run_batched``) and the TGV-3D LES at 64^3 f32 (``tgv_model``), each as
   two models from the same start: one stepped eagerly, one fused (the
   bootstrap through ``run(fused=True)``, then the model's runner: one
   CUDA graph per step, its solver loops WHILE nodes), in turns, chunks of
   ``FUSED_CHUNK[cell]`` steps, ``FUSED_REPS`` times each: wall per step,
   cell-steps/s (``ns_cavity3d_cell_steps_per_s_chip`` for the fused
   cavity, on a line of its own), itr per solve, host CUDA API calls and
   graph launches per step (``torch.profiler``), the host syncs of a step
   (torch's sync debug mode), the capture's seconds, the WHILE nodes
   captured, the wrappers' launches in an eager step and in a replay (none:
   a replay runs no Python), the change of allocated memory over the fused
   bootstrap (the graphs' pools, less what eager steps held before), peak
   memory of an eager and of a fused chunk. Checked: the fused model equals
   the eager one (f64 1e-12 relative, f32 1e-5), the same itr solve by
   solve, no host sync in a fused step, no fallback warning.

15. adjoint: the differentiable solves (``solver/adjoint.py``) and the
   checkpoints. (a) the path: a 3-D permeability-inversion gradient,
   ``DifferentiableDiffusionSolve`` on the 256^3 f64 unit box (homogeneous
   Dirichlet, ``symmetric=True``, tol 1e-8; Γ the inclusion of
   ``demos/darcy_inversion.py`` lifted to 3-D, a uniform injection, the
   pressure misfit on every 4th interior node): the gradient at Γ = 1
   against Richardson-extrapolated central differences along a smooth
   direction (relative error <= 1e-6), the forward wall (the check's four
   solves) and the value-and-gradient wall (median of 3 after a warm-up),
   itr forward and adjoint, the ``diff_field`` launches of each gradient
   (forward itr + adjoint itr + at most 4, the kernel in every matvec),
   peak memory, 4 Adam steps (lr 0.05, the demo's; the misfit below its
   start after them: the first sign-sized step may overshoot), and the
   idle share of one forward solve (``torch.profiler``'s device time
   against the unprofiled wall) at 256^3 and 128^3; (b) the Neumann and
   harmonic variant at 128^3 (BiCGSTAB, the hand transpose through the
   kernel, tol 1e-10): the same directional check; (c) ``DifferentiableSolve`` on the
   implicit advection-diffusion step of ``tests/test_adjoint.py`` at 128^3
   (the axis stencil's plane march, the transposed coefficients, tol
   1e-12): the check along ``rhs`` (the test's loss, quadratic) and along
   a coefficient vector (a misfit against a perturbed one's state); (d)
   ``DifferentiableTransient``, 4 heat steps at 128^3: the gradient with
   ``checkpoint`` on equals it off (1e-12 relative), the peak memory of
   each; (e) each adjoint class on the card against the CPU at 17^2 and
   17^3 f64 (solutions 1e-10, gradients 1e-9 relative); (f) the fused
   cavity at 128^3 f32: 10 steps straight against 5 steps, a checkpoint
   (``save``; then ``save_orbax(block=False)`` and
   ``wait_for_checkpoints``), a load into a fresh model and 5 more, bit
   for bit; ``write_vtk`` of the final fields and ``read_vtk``, equal in
   f32.

16. utilities and solver options, at full size (the kernels of the path
   solves above, no new one). (a) ``fd_opts``: the 512^3 f32 fastdiag
   Poisson (``fd_cfg()``, phase 4's problem) with ``precision: "highest"``,
   ``"default"`` (TF32 transforms) and ``dtype: "bfloat16"`` (bf16
   factors): the passes, their residual history, the wall per solve (CUDA
   events, median of 5), the GEMM kernels and their device time from one
   profiled solve; "highest" meets the tolerance by the true residual
   (plain operator, f32) on FFMA GEMMs; the narrow transforms' refinement
   stops at their accuracy floor (the stall exit, as in the JAX package):
   each direct narrow solve is held to ``FD_NARROW_LIMITS`` (first pass,
   floor, passes) and to its GEMM class (TF32 or bf16 tensor-op kernels),
   and to the same arithmetic written out in plain PyTorch with each GEMM
   operand rounded explicitly: each transform stage of its first
   eigen-solve must lie within ``EMUL_MODEL`` of its narrow error from one
   rounding model (TF32 to nearest even, ties away or by truncation; bf16;
   ``_stage_errors``), and the refinement with ``_emulated_fd_solve`` under
   that model (``_emulated_refinement``) must stop after as many passes at
   residuals within ``EMUL_FLOOR``x the port's, so the floor is the
   arithmetic's, not the port's; each also runs as CG's FD
   preconditioner (``precond: "fd"``), which must meet the tolerance with
   a true residual (f64) within the Krylov gate 1e-5; "default" must
   differ from "highest" in its bits (TF32 ran); phase 1's TF32 check
   again afterwards. (b) ``debug: "nan"``: the 256^3 V(1,1) MG-PCG (phase 5's
   ``N_V11`` problem) with one NaN in the RHS raises ``NaNError`` naming an
   operation, not the end-of-solve check; the 256^3 Darcy solve (phase 6's)
   with one NaN in Γ raises it naming the hand kernel's wrapper
   (``diff_field`` or ``diff_jacobi``); the clean checked MG-PCG gives the
   unchecked bits and itr, and the ratio of its wall to the unchecked one.
   (c) ``utils/profile.py``: ``measure_achievable_bw()`` beside the card's
   3350 GB/s; ``trace()`` of one fastdiag solve writes a Chrome trace
   naming the ``axis_march`` kernel; ``SolveTimer``'s elapsed of a solve
   at least its CUDA-event time; ``bandwidth_report`` of the 512^3 f32
   ``axis_stencil`` apply. (d) ``donate``: ``max_memory_allocated`` of
   the 512^3 fastdiag solve with and without it, the same bits. (e)
   ``kernel``: "pallas" gives "auto"'s bits and launches on the 256^3
   MG-PCG; "jnp" raises ``NotImplementedError``.

17. placed: a ``DomainDecomposition`` with ``devices`` (each block of the
   loop vectors its own allocation on its device, ``parallel/blocks.py``),
   the blocks round robin over every card the machine shows
   (``phase_placed``). (a) bench's MG-PCG at 512^3 f32 (bf16 V(2,2) FMG)
   in (4, 2, 1) blocks against the view-based decomposed solve of the same
   problem: ``itr`` within ``PLACED_GATE``, solutions within
   ``PLACED_AGREE``, the true residual (f64) within 1e-5; the cards used,
   the wall (median of 3), ``axis_stencil_ext`` launches per solve equal
   to card blocks x placed applies, ``blocks.gathers`` per solve and per
   V-cycle, the bytes exchanged per apply (one fine f32 apply: exactly
   its ghost faces), the peak memory per card and the largest cube one
   card holds at that peak per point. (b) unpreconditioned CG at 512^3
   f32 (4, 2, 1), ``PLACED_CG_MAX_IT`` iterations in both layouts (time):
   no gather, the ghost faces' bytes per apply, solutions within
   ``PLACED_CG_AGREE``. (c) the mixed placement ``("cuda:0", "cpu") * 4``
   at 64^3 f64 (2, 2, 2), CG and MG-PCG, and a 2-D (4, 1) CG on
   ``("cuda:0", "cpu") * 2`` at 256^2 f64: the view-based ``itr`` and
   solution within ``PLACED_CMP_TOL`` (the card blocks launch the kernels,
   the CPU blocks run the plain versions; every block operation takes its
   own device's operands). Peer copies between two cards run only where
   the machine shows two. (a) and (f) hold the exact gathers: one per
   V-cycle (the hand-over from the coarsest placed level to the levels on
   the lead card; the transfers between placed levels run block by
   block), ``hand-overs * (1 + placed levels)`` per FMG start, and (f) one
   for Γ's sampling. (j)-(l) (``placed_fields``): the Field, its RHS and
   (l) Γ on the blocks (``blocks.put``): (j) fastdiag 512^3, (k) bench's
   MG-PCG 512^3 (and in turns with (a)'s whole-Field solve), (l) Darcy
   256^3, each against (d), (a), (f)'s references: the same passes / ``itr``
   (within ``PLACED_GATE``), no scatter of x0 or the RHS at entry and no
   gather at exit, the exact gathers, the peak memory beside the whole
   Field's. (m) (``placed_large``): fastdiag and MG-PCG at 1536^3 f32 on
   four cards with no whole grid anywhere (a manufactured discrete
   solution built block by block): ``itr``, the error against it, the
   wall, every card's peak (the lead within ``LARGE_LEAD_SPREAD``); on one
   card a line says it needs four. (n)-(p) (``placed_graphs``): CUDA graphs
   whose loops the device ends, on ``("cuda:0",) * 8``: (n) fastdiag and
   bench's MG-PCG at 512^3 and Darcy at 256^3 with the Field on blocks,
   and (a)'s whole-Field MG-PCG, each at ``sync: False`` (one graph per
   solve) in turns with ``sync: True``: the same bits and ``itr``, per
   replay one graph launch, no host sync and no counter moved, the
   capture's seconds, the walls, the card's peak and what it holds with the
   graph alive; (o) the TGV-3D LES 257^3 fused on the placed blocks in
   turns with its eager placed steps and the fused view-based run: the
   eager bits, ``itr`` and ⟨E⟩, one capture, no fallback, per step one graph
   launch and no host sync; (p) on four cards the probe's three variants
   (one graph whose WHILE body spans two cards: refused, twice; one graph
   per card joined by the peer kernels: runs), then ``sync: False`` solves
   on (4, 2, 1) round robin over the four cards as one graph per card
   (``graph_across_case``: MG-PCG 512^3 and Darcy 256^3 in f32 V(2,2)
   cycles and fastdiag 512^3 with the Field on blocks, CG + ``precond:
   "fd"`` 256^3 with a whole Field) against ``sync: True`` on the same
   cards: the same bits, ``itr`` and ``tol``, no host sync, one graph
   launch per card, the cards' replicas of ``itr``, ``tol`` and ``go``
   equal, no copy between cards and no event in a loop body; the walls,
   each card's peak; a fused step there still raises
   ``NotImplementedError`` naming "A11f (across cards)" (on one card a line
   says it needs four). (q) (``placed_options``): the last options on
   ``("cuda:0",) * 8`` blocks, f32, each with the Field on blocks against
   the same problem with the whole Field (the same ``itr``, ``OPT_AGREE``,
   the gathers as designed, walls and peaks): obstacle solves (MG-PCG with
   a static Dirichlet body at 256^3; MG-BiCGSTAB with it and a Neumann
   body with nonzero flux at 128^3), an ``fdm.custom`` term with ``fd_hint`` and
   ``precond: "fd"`` at 256^3 (one gather per custom apply), a
   ``per_iteration`` BC at 128^3 (one gather per application), ``debug:
   "nan"`` (the unchecked bits; a NaN in the last block raises naming the
   whole Field's operation) and ``donate`` (each block's storage kept, the
   peak no higher) on the 256^3 Poisson. (r) (``placed_torus``): the
   TGV-3D LES 257^3 with its state on the blocks (``put_state``; the seam
   planes in the last blocks), eager and fused, as many steps as (o): ⟨E⟩
   within ``TORUS_E_TOL`` of (o)'s whole-state runs, no gather in a step,
   one capture, the card's peak beside (o)'s. On four cards (p) also runs
   (q) and (r)'s eager run with the blocks round robin over them
   (``options_across``). Every row prints the cards' names and power
   limits.

Every kernel launch count is set to 0 just before each path (phases 4-7,
9, 10, 11, 12, 13, 15 (a), 16, and each placed drive of 17) and read just after; a kernel of a path that launched no time there
fails the run. Phase 16 counts the launches of its solves alone: its
``axis_stencil`` apply timed for ``bandwidth_report`` is set apart, and the
phase's counts must equal the solves' plus that apply's. Then one JSON line of per-kernel numbers (time, plain
version's time, the bound from ``BOUND_WORK``, the library call's time
or null; two last rows for the 2-D apply: the row march on the rz cell,
its launches the row march's, and the per-point kernel on the channel,
the shape's choice there), and as the LAST line
``{"ok": true, "device": {...}}``. Any failure is an uncaught exception and
a non-zero exit, with no result line.
"""
from __future__ import annotations

import contextlib
import importlib
import json
import os
import statistics
import subprocess
import time
from math import exp, pi, prod, sin

N_MAIN = 512
N_V11 = 256
KERNEL_SHAPES = [  # (shape incl. vdim, dtype name) of the axis stencil
    ((1, 512, 512, 512), "float32"),
    ((3, 64, 64, 64), "float32"),
    ((1, 65, 33, 129), "float32"),
    ((1, 1025, 1025), "float32"),
    ((1, 33, 34, 35), "float64"),
]
# the stencil alpha-dot and the Jacobi family: 3-D shapes, down to tiny
# MG levels, in the three storage dtypes
KERNEL3D_SHAPES = [(1, 512, 512, 512), (3, 64, 64, 64), (1, 65, 33, 129), (1, 4, 4, 4),
                   (1, 5, 9, 17)]
# the plane marches' (single and double sweep) own edges besides: more
# planes than a chunk and not a multiple of it, odd n2 with n1 not a
# multiple of a tile's rows, 3-node axes; each shape also with explicit
# plane chunks (the most, a ragged few)
EDGE_SHAPES = [(1, 130, 16, 64), (2, 70, 19, 131), (1, 3, 3, 3)]
MARCH_CHUNKS = (64, 3)
# the kernels a plane-march wrapper can be forced to: (name, its march=)
FORCED_KERNELS = (("march", True), ("point", False))
# the axis stencil's two kernels (plane march, per-point), each forced, at
# both radii: the 3-D shapes of KERNEL_SHAPES, the marches' edges, the
# 3-D advection shapes (vdim 1, 2 and 3; a 3-node axis 0) and the
# advection paths' grid (AXIS_SHAPES, below), every dtype;
# per radius the points per axis of its equations (3/5 mixed at radius 2)
AXIS_POINTS = {1: ((3, 3, 3),), 2: ((5, 3, 5), (5, 5, 5), (3, 5, 3))}
MARCHES = ("jacobi3d", "jacobi3d_x2")  # the plane-march kernels, by wrapper
DTYPES = ["float32", "bfloat16", "float64"]
# kernel and plain sum the same products in another order (the kernel may
# fuse multiply-adds) in promote(dtype, f32): f32 1e-5 of the output's
# scale, f64 1e-12; bf16 rounds the output once and an f32 difference at a
# rounding boundary moves it by one bf16 ulp (2^-8): 1e-2. Dots are f32
# (f64) sums held to 1e-5 (1e-12) of sum|products|.
REL_TOL = {"float32": 1e-5, "bfloat16": 1e-2, "float64": 1e-12}
DOT_TOL = {"float32": 1e-5, "bfloat16": 1e-5, "float64": 1e-12}
# (name, module, source of the kernel timed as its ms, the TPU function it
# replaces); diff_field and diff_jacobi: the plane march (csrc/diff_march.cu),
# the 512^3 grid's choice, while their per-point kernel (csrc/diff_field.cu)
# takes 2-D grids and the levels below the march's threshold; axis_stencil
# and axis_stencil5 likewise: the plane march (csrc/axis_march.cu) at the
# timed 512^3 / 256^3, the per-point kernels (csrc/axis_stencil.cu) below;
# axis_stencil_dot (512^3) and axis_stencil_ext (the (4, 2, 1) blocks of
# 512^3) likewise: instances of that march, their per-point kernels below
KERNELS = [
    ("axis_stencil", "pyapes_tpu_torch.ops.axis_stencil",
     "pyapes_tpu_torch/csrc/axis_march.cu", "pyapes_tpu/ops/pallas_stencil.py:323"),
    ("axis_stencil_dot", "pyapes_tpu_torch.ops.axis_stencil",
     "pyapes_tpu_torch/csrc/axis_march.cu", "pyapes_tpu/ops/pallas_stencil_db.py:248"),
    ("jacobi3d", "pyapes_tpu_torch.ops.jacobi",
     "pyapes_tpu_torch/csrc/jacobi3d.cu", "pyapes_tpu/ops/pallas_stencil.py:551"),
    ("jacobi3d_dot", "pyapes_tpu_torch.ops.jacobi",
     "pyapes_tpu_torch/csrc/jacobi3d.cu", "pyapes_tpu/ops/pallas_stencil_db.py:570"),
    ("jacobi3d_x2", "pyapes_tpu_torch.ops.jacobi",
     "pyapes_tpu_torch/csrc/jacobi3d.cu", "pyapes_tpu/ops/pallas_stencil_v3.py:881"),
    ("diff_field", "pyapes_tpu_torch.ops.diff_field",
     "pyapes_tpu_torch/csrc/diff_march.cu", "pyapes_tpu/ops/pallas_advect.py:519"),
    ("diff_jacobi", "pyapes_tpu_torch.ops.diff_field",
     "pyapes_tpu_torch/csrc/diff_march.cu", "pyapes_tpu/ops/pallas_advect.py:694"),
    ("conv_component", "pyapes_tpu_torch.ops.advect",
     "pyapes_tpu_torch/csrc/advect_march.cu", "pyapes_tpu/ops/pallas_advect.py:296"),
    ("advect_pair", "pyapes_tpu_torch.ops.advect",
     "pyapes_tpu_torch/csrc/advect_march.cu", "pyapes_tpu/ops/pallas_advect.py:357"),
    ("axis_stencil5", "pyapes_tpu_torch.ops.axis_stencil",
     "pyapes_tpu_torch/csrc/axis_march.cu", "pyapes_tpu/ops/pallas_stencil_v3.py:424"),
    ("axis_stencil_ext", "pyapes_tpu_torch.ops.axis_stencil",
     "pyapes_tpu_torch/csrc/axis_march.cu", "pyapes_tpu/ops/pallas_stencil_v3.py:573"),
    # no Pallas kernel: the counterparts of the transfers XLA inserts between
    # the JAX package's chips (ppermute / psum of its decomposed solve)
    ("peer_put", "pyapes_tpu_torch.ops.peer", "pyapes_tpu_torch/csrc/peer.cu",
     "none (XLA's ppermute / psum between chips: pyapes_tpu/solver/linalg.py:587)"),
    ("peer_wait", "pyapes_tpu_torch.ops.peer", "pyapes_tpu_torch/csrc/peer.cu",
     "none (XLA's ppermute / psum between chips: pyapes_tpu/solver/linalg.py:587)"),
]
PEER_KERNELS = ("peer_put", "peer_wait")
# the decomposed paths' block layout: 512^3 in 8 blocks of 128 x 256 x 512
# (the last, contiguous, axis is never cut)
N_DECOMP = (4, 2, 1)
# the halo-extended kernel's check cases: unextended blocks (vdim, n0, n1,
# n2), odd sizes and single-row axes among them, x the three ext flags
EXT_BLOCKS = [(1, 5, 7, 33), (3, 16, 9, 130), (1, 3, 5, 257), (3, 1, 2, 64)]
EXT_FLAGS = [(1, 0, 0), (0, 1, 0), (1, 1, 0)]
# the alpha-dot's two kernels (plane march, per-point), each forced: the
# 3-D kernel shapes, the marches' edges and the 256^3 V(1,1) grid
DOT_SHAPES = KERNEL3D_SHAPES + EDGE_SHAPES + [(1, N_V11, N_V11, N_V11)]
# The least time of each timed call (bound_ms): the larger of its
# compulsory bytes (each input grid read once, each output grid written
# once; the coefficient vectors, < 0.01% of them, left out) over the
# card's 3.35 TB/s and its operations over the 67 TFLOP/s of float32
# outside the tensor cores (every kernel computes in f32, bf16 storage
# included), from NVIDIA's H100 SXM data sheet at 700 W. Per kernel at
# its timed shape: (grids moved, bytes per element, grid edge, f32
# operations per point, counted from the plain version: a multiply or an
# add is one).
MEM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BOUND_WORK = {
    "axis_stencil": (2, 4, 512, 17),  # read x, write out; 9 products, 8 sums
    "axis_stencil_dot": (2, 4, 512, 19),  # + x * Ax and its sum
    "jacobi3d": (3, 2, 512, 16),  # x, b -> out; Laplacian 11, update 5
    "jacobi3d_dot": (3, 2, 512, 18),
    "jacobi3d_x2": (3, 2, 512, 32),  # two sweeps
    "diff_field": (3, 4, 512, 32),  # x, Γ -> out; per axis 2 face means, 2 fluxes
    "diff_jacobi": (4, 2, 512, 45),  # x, b, Γ -> out; + diagonal and update
    "conv_component": (5, 4, 256, 12),  # x, 3 advectors -> out; 4 per axis
    "advect_pair": (3, 4, 256, 24),  # x, advector -> out; upwind 8 per axis
    "axis_stencil5": (2, 4, 256, 29),  # 5-point on all three axes: 15 products, 14 sums
}
N_DARCY = 256
# the variable-Γ kernels: the 3-D shapes, the Darcy cycle's levels that take
# the plane march (256^3, 128^3: its FULL instance), a 2-D grid, and the
# plane marches' edge shapes; per shape and dtype four (stacked Γ, face
# rule, Neumann surgery) combinations that cover each option, in the four
# modes (the apply and the three Jacobi passes); each of the two kernels
# forced, the plane march also at MARCH_CHUNKS planes per block
VG_SHAPES = KERNEL3D_SHAPES + [(1, N_DARCY, N_DARCY, N_DARCY), (1, 128, 128, 128),
                               (1, 1025, 1025)]
VG_COMBOS = [(False, "arithmetic", False), (False, "harmonic", True),
             (True, "arithmetic", True), (True, "harmonic", False)]
# kernel launches per Darcy 256^3 solve (bench_darcy's 5 CG iterations:
# the FMG start and 6 preconditioner cycles, 5 passes per level, 24 on
# the coarsest; the operator on the finest level)
DARCY_LAUNCHES = {"diff_jacobi": 603, "diff_field": 7}
# bench.py's bench_darcy configuration
DARCY_MG = {"dtype": "bfloat16", "n_pre": 2, "n_post": 2, "omega": 0.857, "fmg": True}
# the JAX package's `runner darcy --n 65 --dtype double` (avg arithmetic) and
# `--avg harmonic`: k_eff on the CPU, float64
DARCY65_K_EFF = {"arithmetic": 0.8474604795147054, "harmonic": 0.8394676532747538}
# bench.py's PYAPES_BENCH_METHOD=cg configuration
BENCH_MG = {"dtype": "bfloat16", "n_pre": 2, "n_post": 2, "omega": 0.857, "fmg": True,
            "fuse_rz": True}
V11_MG = {**BENCH_MG, "n_pre": 1, "n_post": 1}
# the advection kernels: the 3-D shapes (512^3 is timed separately), a
# 3-node axis (axis 0, Neumann on both faces in the "neumann" kind), a 2-D
# and a 1-D grid
ADV_SHAPES = [(3, 64, 64, 64), (1, 65, 33, 129), (1, 4, 4, 4), (1, 5, 9, 17), (3, 3, 9, 11),
              (1, 65, 130), (2, 300)]
ADV_SURGERY = {  # per kind, the (lower, upper) faces of axes 0, 1, 2
    "none": (("none", "none"),) * 3,
    "neumann": (("neumann", "neumann"),) * 3,
    "mixed": (("periodic", "neumann"), ("none", "periodic"), ("neumann", "none")),
}
DIV_VARIANTS = [("none", "conservative"), ("none", "advective"), ("upwind", "conservative"),
                ("quick", "conservative")]
N_ADV = (256, 512)  # timed sizes (f32)
# the advection kernels' plane march and per-point kernel, each forced, on
# the march's variants (Div central in both forms and upwind, vector and
# scalar targets; Conv central and upwind): the 3-D ADV_SHAPES (a 3-node
# axis 0 among them), two grids of the march's FULL instance and the
# paths' grid (below, with N_PATH)
ADV_MARCH_DIV = [("none", "conservative"), ("none", "advective"), ("upwind", "conservative")]
ADV_MARCH_CONV = ("none", "upwind")
N_PATH = 256  # the implicit-advection paths' grid (Burgers: 257 nodes, 256 on the torus)
# (the paths' 256^3 grid among them: Burgers, upwind and QUICK launch the
# march there)
AXIS_SHAPES = list(dict.fromkeys([s for s, _ in KERNEL_SHAPES if len(s) == 4] + EDGE_SHAPES
                                 + [s for s in ADV_SHAPES if len(s) == 4]
                                 + [(1, N_PATH, N_PATH, N_PATH)]))
MODEL_SIZES = (65, 129)  # the Poisson model path's grids (f64)
ADV_MARCH_SHAPES = ([s for s in ADV_SHAPES if len(s) == 4] + [(1, 20, 32, 256), (3, 9, 16, 128)]
                    + [(1, N_PATH, N_PATH, N_PATH)])


def _wrappers() -> dict:
    return {name: getattr(importlib.import_module(mod), name) for name, mod, _, _ in KERNELS}


def _reset_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def _counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def _check_full_precision() -> None:
    """Phase 1's check: TF32 off and float32 matmuls at "highest"."""
    import torch

    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("chip_smoke: TF32 is on")
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("chip_smoke: float32 matmul precision is not 'highest'")


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    from pyapes_tpu_torch.backend import Device

    dev = Device("cuda").device
    _check_full_precision()
    print(smi, flush=True)
    print(
        f"[1 device] {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda} tf32=off",
        flush=True,
    )
    return dev, smi


def _entry_registers(log: str) -> list:
    """(kernel, registers, spill stores) of each plane-march entry and
    each per-point axis-stencil entry that ptxas compiled, from its ``-v``
    log; the kernel as ``name<dtype,flags>`` (the template's int and bool
    parameters, bools as 0/1)."""
    import re

    dtypes = {"13__nv_bfloat16": "bf16", "f": "f32", "d": "f64"}
    out, cur, spill = [], None, 0
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", ln)
        if m:
            cur = re.search(r"((?:jacobi3d(?:_x2)?|diff_(?:jacobi|field)_march|axis_march(?:_dot|_ext)?"
                            r"|axis_stencil(?:_dot|_ext|5)?|advect(?:_march)?)_kernel)"
                            r"I(13__nv_bfloat16|f|d)((?:L[bi]\d+E)*)", m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur:
            args = [dtypes[cur.group(2)], *re.findall(r"L[bi](\d+)E", cur.group(3))]
            out.append((f"{cur.group(1)}<{','.join(args)}>", int(m.group(1)), spill))
            cur = None
    return out


def phase_build():
    from pyapes_tpu_torch.ops import cuda_build

    tic = time.perf_counter()
    builds = cuda_build.build_all()
    wall = time.perf_counter() - tic
    for name, b in builds.items():
        ptxas = [ln.split("info    :")[-1].strip() for ln in b.log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"[2 build] {b.path.name} built in {b.seconds:.2f} s; ptxas: {' | '.join(ptxas)}",
              flush=True)
    regs = _entry_registers(builds["jacobi3d"].log)
    print("[2 build] plane-march registers (ptxas; single sweep <dtype,dot,full>, double sweep "
          "<dtype,from_zero,dot>): " + "; ".join(f"{k} {r} (spill {sp} B)" for k, r, sp in regs),
          flush=True)
    regs = _entry_registers(builds["axis_stencil"].log)
    print("[2 build] axis-stencil registers (ptxas; the plane march axis_march_kernel <dtype,"
          "radius,full>, its alpha-dot and halo-extended instances axis_march_dot_kernel, "
          "axis_march_ext_kernel <dtype,full>; the per-point kernels <dtype[,ndim]>): "
          + "; ".join(f"{k} {r} (spill {sp} B)" for k, r, sp in regs), flush=True)
    regs = _entry_registers(builds["diff_field"].log)
    print("[2 build] variable-Γ plane-march registers (ptxas; diff_jacobi <dtype,mode,iso,full,"
          "harmonic>, mode 0 smooth, 1 smooth0, 2 resid; diff_field <dtype,iso,full,harmonic>): "
          + "; ".join(f"{k} {r} (spill {sp} B)" for k, r, sp in regs), flush=True)
    regs = _entry_registers(builds["advect"].log)
    print("[2 build] advection registers (ptxas; the plane march advect_march_kernel <dtype,"
          "kind,form,full>, kind 0 Conv, 1 scalar Div, 2 vector Div, form 0 central advective, 1 "
          "upwind, 2 central conservative; the per-point advect_kernel <dtype>): "
          + "; ".join(f"{k} {r} (spill {sp} B)" for k, r, sp in regs), flush=True)
    print(f"[2 build] {len(builds)} sources built in parallel in {wall:.2f} s", flush=True)
    return builds


def _time_ms(fn, reps: int = 15) -> float:
    """Median of per-call CUDA-event times after two warm-up calls."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(fn, calls: int = 30) -> float:
    """Device time per call of ``calls`` calls queued back to back behind a
    device sleep (~25 ms, longer than their launches take on the host: the
    advection wrappers spend up to ~0.4 ms of host time per call), so
    that the host's cost per launch, which a per-call timing of a small
    kernel measures, does not show."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def _bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the least time of a call that moves ``nbytes``
    and computes ``ops`` f32 operations on one H100."""
    t_bytes, t_ops = nbytes / MEM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _stencil_csr(coeffs, ext, in_shape):
    """The axis stencil of a ``(1, *in_shape)`` input as one CSR matrix
    (int32 indices, columns sorted per row): one row per output point, the
    summed central coefficient and the +-1 (+-2 on a 5-point axis)
    neighbours, wrapped on an axis with ``ext[a] == 0`` and read from the
    ghost rows of an extended one. A coefficient is a vector along its
    axis, or one value per output point (the variable-Γ and per-point
    advection operators at a fixed Γ or advector). The library yardstick of
    the stencil kernels (``torch.mv`` on it is one cuSPARSE product); the
    port never builds it."""
    import numpy as np
    import torch

    dev = coeffs[0][0].device
    nd = len(in_shape)
    n = [s - 2 * e for s, e in zip(in_shape, ext)]
    stride = [int(np.prod(in_shape[a + 1:])) for a in range(nd)]

    def bshape(a):
        return [-1 if b == a else 1 for b in range(nd)]

    def field(c, a):  # a coefficient of axis a at every output point
        return (c.reshape(bshape(a)) if c.ndim == 1 else c.reshape(n)).expand(n)

    pos = [torch.arange(m, device=dev) for m in n]
    base = sum(((pos[a] + ext[a]) * stride[a]).reshape(bshape(a)) for a in range(nd))
    cols = [base.expand(n)]
    vals = [sum(field(cs[len(cs) // 2], a) for a, cs in enumerate(coeffs))]
    for a, cs in enumerate(coeffs):
        for off, c in zip((2, 1, 0, -1, -2) if len(cs) == 5 else (1, 0, -1), cs):
            if off:
                tgt = pos[a] + ext[a] + off if ext[a] else (pos[a] + off) % n[a] + ext[a]
                cols.append(base + ((tgt - pos[a] - ext[a]) * stride[a]).reshape(bshape(a)))
                vals.append(field(c, a))
    k = len(cols)
    col = torch.stack([c.expand(n).reshape(-1).to(torch.int32) for c in cols])
    del cols, base
    col, order = col.sort(dim=0)
    val = torch.stack([v.reshape(-1) for v in vals]).gather(0, order)
    del order
    rows = col.shape[1]
    crow = torch.arange(0, k * rows + 1, k, device=dev, dtype=torch.int32)
    return torch.sparse_csr_tensor(crow, col.t().reshape(-1), val.t().reshape(-1),
                                   size=(rows, int(np.prod(in_shape))), check_invariants=False)


def _diff_field_csr_coeffs(g, inv):
    """Per axis ``(cp, cc, cm)`` at every point of the variable-Γ operator
    at a fixed isotropic ``g`` ``(*nx)`` (arithmetic faces, no surgery,
    torus wrap): the CSR yardstick's coefficients of ``diff_field``."""
    import torch

    out = []
    for j in range(g.ndim):
        cp = 0.5 * (g + torch.roll(g, -1, j)) * inv[j]
        cm = 0.5 * (g + torch.roll(g, 1, j)) * inv[j]
        out.append((cp, -(cp + cm), cm))
    return tuple(out)


def _advect_csr_coeffs(advs, base, limiter):
    """Per axis ``(cp, cc, cm)`` at every point of the per-point advection
    operator with axis j's advector ``advs[j]`` fixed (central advective
    form, or upwind; no surgery): the CSR yardstick's coefficients of
    ``conv_component`` and ``advect_pair``."""
    out = []
    for j, (a, cs) in enumerate(zip(advs, base)):
        ap0, ac0, am0 = (c.reshape([-1 if k == j else 1 for k in range(a.ndim)]) for c in cs)
        if limiter == "upwind":
            lo, hi = a.clamp(max=0.0), a.clamp(min=0.0)
            s = 2.0 * ap0.abs()  # 1 / dx
            out.append((s * lo, s * (hi - lo) + ac0 * a, -s * hi))
        else:
            out.append((ap0 * a, ac0 * a, am0 * a))
    return tuple(out)


def _library_stencil_ms(coeffs, x, ref, ext=None, blocks=None) -> float:
    """Time of the CSR yardstick (``torch.mv``) on the inputs of a timed
    stencil call, after checking it computes what the plain version does;
    with ``blocks``, one product per block (``[(x_ext, block coeffs,
    ref block)]``)."""
    import torch

    calls = []
    for xb, cb, rb in blocks or [(x, coeffs, ref)]:
        e = ext or (0,) * (xb.ndim - 1)
        A = _stencil_csr(cb, e, tuple(xb.shape[1:]))
        v = xb.reshape(-1)
        got = torch.mv(A, v).reshape(rb.shape)
        err = (got - rb).abs().max().item()
        if not err <= REL_TOL["float32"] * rb.abs().max().item():
            raise RuntimeError(f"chip_smoke: the CSR yardstick disagrees with the plain version "
                               f"({err:.3e})")
        calls.append((A, v))
        del got
    return _time_ms(lambda: [torch.mv(A, v) for A, v in calls])


def _axis_inputs(shape, points, dtype, dev, seed):
    """x of ``shape`` (vdim first) and per axis ``points`` coefficient
    vectors (made in f32, f64 for f64)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    gen = torch.float64 if dtype == torch.float64 else torch.float32
    coeffs = tuple(tuple(torch.randn(n, generator=g, device=dev, dtype=gen).to(dtype)
                         for _ in range(p)) for n, p in zip(shape[1:], points))
    return coeffs, torch.randn(shape, generator=g, device=dev, dtype=gen).to(dtype)


def check_axis(dev, shapes=AXIS_SHAPES, forced=True, radii=(1, 2)) -> tuple:
    """``axis_stencil`` (radius 1) and ``axis_stencil5`` (radius 2, the
    points per axis of ``AXIS_POINTS``), the radii in ``radii``, against
    ``apply_axis_stencil`` at ``shapes`` x ``DTYPES``: with ``forced`` the
    plane march (also at ``MARCH_CHUNKS`` planes per block) and the
    per-point kernel each forced, else the shape's choice through the
    wrappers' common signature only (an older version under
    ``ab_cells_torch.py --root``). Every
    result within ``REL_TOL``, the same bits at every chunk and on another
    call, and (forced) the march the same bits as the per-point kernel, or
    raises. Returns the worst abs error per wrapper and the worst
    err/limit per kernel."""
    import torch

    from pyapes_tpu_torch.ops.axis_stencil import axis_stencil, axis_stencil5
    from pyapes_tpu_torch.ops.stencil import apply_axis_stencil

    kernels = FORCED_KERNELS if forced else (("choice", None),)
    worst, worst_rel, n_cases = {}, {k: 0.0 for k, _ in kernels}, 0
    for seed, shape in enumerate(shapes):
        for dtname in DTYPES:
            here = {k: 0.0 for k, _ in kernels}
            for radius, fn in ((1, axis_stencil), (2, axis_stencil5)):
                if radius not in radii:
                    continue
                name = fn.__name__
                for points in AXIS_POINTS[radius]:
                    coeffs, x = _axis_inputs(shape, points, getattr(torch, dtname), dev,
                                             700 + seed)
                    ref = apply_axis_stencil(coeffs, x)
                    limit = REL_TOL[dtname] * ref.double().abs().max().item()
                    first = {}  # each kernel's output at the auto chunk
                    for kern, march in kernels:
                        kw = {} if march is None else {"march": march}
                        outs = []
                        for ci in (None, *MARCH_CHUNKS) if march else (None,):
                            got = fn(coeffs, x, **({**kw, "chunk": ci} if forced else kw))
                            torch.cuda.synchronize()
                            if got.dtype != ref.dtype or got.shape != ref.shape:
                                raise RuntimeError(f"chip_smoke: {name} returned {got.dtype} "
                                                   f"{tuple(got.shape)}")
                            err = (got.double() - ref.double()).abs().max().item()
                            if not err <= limit:
                                raise RuntimeError(
                                    f"chip_smoke: {name} {points} ({kern} kernel, chunk {ci}) "
                                    f"disagrees with its plain version at {shape} {dtname}: "
                                    f"{err:.3e} > {limit:.3e}")
                            worst[name] = max(worst.get(name, 0.0), err)
                            here[kern] = max(here[kern], err / limit if limit > 0 else 0.0)
                            outs.append(got)
                            n_cases += 1
                        outs.append(fn(coeffs, x, **kw))  # the same bits on another call
                        if not all(torch.equal(o, outs[0]) for o in outs[1:]):
                            raise RuntimeError(f"chip_smoke: {name} {points} ({kern} kernel) "
                                               f"gave other bits at another plane chunk or "
                                               f"call at {shape} {dtname}")
                        first[kern] = outs[0]
                        del outs
                    if forced and not torch.equal(first["march"], first["point"]):
                        raise RuntimeError(f"chip_smoke: {name} {points}: the march and the "
                                           f"per-point kernel gave other bits at {shape} {dtname}")
                    del ref, x, coeffs, first
            for kern in here:
                worst_rel[kern] = max(worst_rel[kern], here[kern])
            print(f"[3 kernel] axis stencil {tuple(shape)} {dtname}: worst err/limit "
                  + ", ".join(f"{k} {v:.3f}" for k, v in here.items())
                  + " (radius 1; radius 2 with 5-point axes (0, 2), all, 1"
                  + (f"; the march at chunks auto, {', '.join(map(str, MARCH_CHUNKS))}"
                     if forced else "") + ": same bits, and on another call"
                  + ("; the march's bits equal the per-point kernel's" if forced else "") + ")",
                  flush=True)
    print(f"[3 kernel] axis stencil: {n_cases} cases hold ({len(shapes)} shapes x "
          f"{len(DTYPES)} dtypes x {sum(len(AXIS_POINTS[r]) for r in radii)} equations"
          + (f" x the per-point kernel and the march at {1 + len(MARCH_CHUNKS)} chunks"
             if forced else ", the shape's choice of kernel")
          + "), worst err/limit " + ", ".join(f"{k} {v:.3f}" for k, v in worst_rel.items()),
          flush=True)
    return worst, worst_rel


def phase_kernel(dev):
    """The axis stencil of both radii, the plane march and the per-point
    kernel each forced, against its plain version (``check_axis``); the
    shape's choice at every ``KERNEL_SHAPES`` shape (a 2-D grid among
    them); the 512^3 f32 apply timed (the shape's choice, the march)
    beside the per-point kernel, the plain version and the CSR yardstick.
    Returns the worst abs error per wrapper and (ms, plain_ms, lib_ms)."""
    import torch

    from pyapes_tpu_torch.ops.axis_stencil import axis_stencil
    from pyapes_tpu_torch.ops.stencil import apply_axis_stencil

    worst, _ = check_axis(dev)
    timing = None
    for seed, (shape, dtname) in enumerate(KERNEL_SHAPES):
        dtype = getattr(torch, dtname)
        coeffs, x = _axis_inputs(shape, (3,) * (len(shape) - 1), dtype, dev, seed)
        out = axis_stencil(coeffs, x)
        ref = apply_axis_stencil(coeffs, x)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        scale = ref.abs().max().item()
        ok = err <= REL_TOL[dtname] * scale
        print(
            f"[3 kernel] axis_stencil {tuple(shape)} {dtname} (the shape's choice): "
            f"max_abs_err={err:.3e} (limit {REL_TOL[dtname]:.0e} x max|out| {scale:.3e}) "
            f"{'ok' if ok else 'FAIL'}",
            flush=True,
        )
        if not ok:
            raise RuntimeError(f"chip_smoke: kernel disagrees with plain version at {shape}")
        worst["axis_stencil"] = max(worst["axis_stencil"], err)
        if shape == (1, N_MAIN, N_MAIN, N_MAIN):
            ms = _time_ms(lambda: axis_stencil(coeffs, x))
            point_ms = _time_ms(lambda: axis_stencil(coeffs, x, march=False))
            plain_ms = _time_ms(lambda: apply_axis_stencil(coeffs, x))
            lib_ms = _library_stencil_ms(coeffs, x, ref)
            gbs = 2 * x.numel() * x.element_size() / (ms * 1e-3) / 1e9
            timing = (ms, plain_ms, lib_ms)
            print(
                f"[3 kernel] axis_stencil {N_MAIN}^3 f32 time: kernel (the plane march) {ms:.4f} "
                f"ms, the per-point kernel {point_ms:.4f} ms, plain {plain_ms:.4f} ms, CSR "
                f"product (torch.mv) {lib_ms:.4f} ms (median of 15 CUDA-event timings); the "
                f"march moves >= {gbs:.1f} GB/s (2 grids of compulsory traffic)",
                flush=True,
            )
        del out, ref, x
    return worst, timing


def axis_level_times(dev, n: int = N_MAIN, forced=True, radii=(1, 2)) -> list:
    """``axis_stencil`` (radius 1) and ``axis_stencil5`` (radius 2,
    5-point on all three axes), the radii in ``radii``, at n^3 f32 (the
    fastdiag and MG-PCG Krylov loops), (n/2)^3 f32 (the advection paths'
    grid), 129^3, 128^3 and 64^3 f32 (the threshold's neighbourhood, and a
    grid that tiles overhang), ``MODEL_SIZES`` f64 (the Poisson model path) and every
    level of the n^3 V-cycle in bf16 (the cycle's dtype; a cycle with
    surgery applies the axis stencil there): per call (``_time_ms``) and on
    the device back to back (``_device_ms``), the shape's choice and, with
    ``forced``, the plane march and the per-point kernel each forced; the
    share of the bound of the choice on the device; a device copy of x
    beside it. Each row's shape-chosen output is first held against
    ``apply_axis_stencil`` within ``REL_TOL`` (raises otherwise). Then the
    wrapper's rule beside the smallest grid from which up the march is at
    or below the per-point kernel on the device at every dtype and radius,
    among grids whose every tile lies inside them (``march_full``). Without
    ``forced`` only the wrappers' common signature is used (an older
    version under ``ab_cells_torch.py --root``)."""
    import torch

    from pyapes_tpu_torch.ops import axis_stencil as A
    from pyapes_tpu_torch.ops.stencil import apply_axis_stencil
    from pyapes_tpu_torch.solver.multigrid import _level_shapes

    cases = [((m,) * 3, "float32") for m in (n, n // 2, 129, 128, 64)]
    cases += [((m,) * 3, "float64") for m in MODEL_SIZES]
    cases += [(shape, "bfloat16") for shape in _level_shapes((n,) * 3)]
    rows = []
    for lvl, (shape, dtname) in enumerate(cases):
        for radius, fn in ((1, A.axis_stencil), (2, A.axis_stencil5)):
            if radius not in radii:
                continue
            coeffs, x = _axis_inputs((1, *shape), (2 * radius + 1,) * 3, getattr(torch, dtname),
                                     dev, 960 + lvl)
            ref = apply_axis_stencil(coeffs, x)
            err = (fn(coeffs, x).double() - ref.double()).abs().max().item()
            limit = REL_TOL[dtname] * ref.double().abs().max().item()
            if not err <= limit:
                raise RuntimeError(f"chip_smoke: {fn.__name__} (the shape's choice) disagrees "
                                   f"with its plain version at {shape} {dtname}: {err:.3e} > "
                                   f"{limit:.3e}")
            del ref
            pts = x.numel()
            bound = _bound(2 * x.element_size() * pts, (17 if radius == 1 else 29) * pts)[0]
            copy = torch.empty_like(x)  # a device copy of x: the traffic's yardstick
            row = {"shape": shape, "dtype": dtname, "kernel": fn.__name__, "bound_ms": bound,
                   "ms": _time_ms(lambda: fn(coeffs, x)),
                   "device_ms": _device_ms(lambda: fn(coeffs, x)),
                   "copy_device_ms": _device_ms(lambda: copy.copy_(x)),
                   "err_over_limit": err / limit if limit > 0 else 0.0}
            if forced:
                for kern, march in FORCED_KERNELS:
                    row[f"{kern}_ms"] = _time_ms(lambda: fn(coeffs, x, march=march))
                    row[f"{kern}_device_ms"] = _device_ms(lambda: fn(coeffs, x, march=march))
                row["march"] = A.uses_march((1, *shape))
            rows.append(row)
            del coeffs, x, copy
    print(f"[3 kernel] axis stencil at {n}^3, {n // 2}^3, 129^3, 128^3 and 64^3 f32, "
          f"{' and '.join(map(str, MODEL_SIZES))}^3 f64 and the {n}^3 V-cycle's levels in bf16 "
          "(5-point on every axis at radius 2), ms per call (median of 15 CUDA-event timings) / "
          "device µs per call (30 back to back), the shape's choice (each within REL_TOL of "
          f"the plain version, worst err/limit {max(r['err_over_limit'] for r in rows):.3f})"
          + ("; the march and the per-point kernel forced" if forced else "")
          + "; a device copy of x (read and write x once: the traffic's yardstick): "
          + "; ".join(
              f"{r['kernel']} {r['shape'][0]}^3 {r['dtype']} {r['ms']:.4f} / "
              f"{1e3 * r['device_ms']:.2f} ({100 * r['bound_ms'] / r['device_ms']:.1f}% of "
              f"{1e3 * r['bound_ms']:.2f}; copy {1e3 * r['copy_device_ms']:.2f})"
              + (f" [march {r['march_ms']:.4f} / {1e3 * r['march_device_ms']:.2f}, per-point "
                 f"{r['point_ms']:.4f} / {1e3 * r['point_device_ms']:.2f}]" if forced else "")
              for r in rows), flush=True)
    if forced:
        wins = {}
        for r in rows:
            if not A.march_full((1, *r["shape"])):
                continue
            pts = r["shape"][0] * r["shape"][1] * r["shape"][2]
            wins[pts] = wins.get(pts, True) and r["march_device_ms"] <= r["point_device_ms"]
        edge = None
        for pts in sorted(wins, reverse=True):  # the run of wins from the largest level down
            if not wins[pts]:
                break
            edge = pts
        other = [f"{r['kernel']} {r['shape'][0]}^3 {r['dtype']}" for r in rows
                 if (r["march_device_ms"] > r["point_device_ms"] if r["march"]
                     else r["point_device_ms"] > r["march_device_ms"])]
        print(f"[3 kernel] axis stencil kernel choice: the march from {A.MARCH_MIN_POINTS} points "
              f"per component on grids whose every tile lies inside them (the wrapper's rule); on "
              f"the device back to back here, among such grids, the march at or below "
              f"the per-point kernel at radius {radii} from "
              f"{round(edge ** (1 / 3)) if edge else '-'}^3 up, and the kernel not chosen faster "
              f"at: {', '.join(other) or 'no level'}", flush=True)
    return rows


def _level_inputs(shape, dtype, dev, seed):
    """A V-cycle level's operands at ``shape`` (unit box): inv_dx2,
    omega/diag, x, b (b at the operator's scale, so out is O(1))."""
    import torch

    inv = [float((n - 1) ** 2) for n in shape[1:]]
    beta = 0.857 / (-2.0 * sum(inv))
    g = torch.Generator(device=dev).manual_seed(seed)
    gen = torch.float64 if dtype == torch.float64 else torch.float32
    x = torch.randn(shape, generator=g, device=dev, dtype=gen).to(dtype)
    b = (sum(inv) * torch.randn(shape, generator=g, device=dev, dtype=gen)).to(dtype)
    coeffs = tuple(
        tuple(torch.randn(n, generator=g, device=dev, dtype=gen).to(dtype) for _ in range(3))
        for n in shape[1:]
    )
    return inv, beta, x, b, coeffs


def _march_cases(kernel, inv, beta, x, b, chunk=None, axes=(0, 1, 2)):
    """(kernel name, variant, kernel call, plain call, dot-terms operand)
    for every variant of a plane march at one input: ``jacobi3d`` the
    single sweep (smooth, residual, residual on a subset of the masked
    axes) and its dot, ``jacobi3d_x2`` the double sweep's four variants;
    with ``chunk`` planes per block where given (only then is the keyword
    passed, so an older wrapper takes the rest); the update masked on the
    end rows of ``axes`` (a torus level's: its non-periodic axes)."""
    from pyapes_tpu_torch.ops import jacobi as K
    from pyapes_tpu_torch.ops import stencil as P

    kw = {} if chunk is None else {"chunk": chunk}
    at = "" if chunk is None else f",chunk={chunk}"
    if axes != (0, 1, 2):
        at += f",mask_axes={axes}"
    ax = axes
    if kernel == "jacobi3d":
        return [
            ("jacobi3d", "smooth" + at, lambda: K.jacobi3d(x, b, inv, 1.0, beta, ax, **kw),
             lambda: P.apply_jacobi3d(x, b, inv, 1.0, beta, ax), None),
            ("jacobi3d", "residual(alpha=0,beta=1)" + at,
             lambda: K.jacobi3d(x, b, inv, 0.0, 1.0, ax, **kw),
             lambda: P.apply_jacobi3d(x, b, inv, 0.0, 1.0, ax), None),
            ("jacobi3d", "residual,mask_axes=(0,2)" + at,
             lambda: K.jacobi3d(x, b, inv, 0.0, 1.0, (0, 2), **kw),
             lambda: P.apply_jacobi3d(x, b, inv, 0.0, 1.0, (0, 2)), None),
            ("jacobi3d_dot", at[1:], lambda: K.jacobi3d_dot(x, b, inv, 1.0, beta, ax, **kw),
             lambda: P.apply_jacobi3d_dot(x, b, inv, 1.0, beta, ax), b),
        ]
    return [
        ("jacobi3d_x2", at[1:], lambda: K.jacobi3d_x2(x, b, inv, beta, ax, **kw),
         lambda: P.apply_jacobi3d_x2(x, b, inv, beta, ax), None),
        ("jacobi3d_x2", "from_zero" + at,
         lambda: K.jacobi3d_x2(None, b, inv, beta, ax, from_zero=True, **kw),
         lambda: P.apply_jacobi3d_x2(None, b, inv, beta, ax, from_zero=True), None),
        ("jacobi3d_x2", "emit_dot" + at,
         lambda: K.jacobi3d_x2(x, b, inv, beta, ax, emit_dot=True, **kw),
         lambda: P.apply_jacobi3d_x2(x, b, inv, beta, ax, emit_dot=True), b),
        ("jacobi3d_x2", "from_zero+emit_dot" + at,
         lambda: K.jacobi3d_x2(None, b, inv, beta, ax, from_zero=True, emit_dot=True, **kw),
         lambda: P.apply_jacobi3d_x2(None, b, inv, beta, ax, from_zero=True, emit_dot=True), b),
    ]


def _check_case(name, variant, kern, plain, dot_op, dtname):
    """Run one case on the card against its plain version: (err, limit,
    ok, tag), the dot held to ``DOT_TOL`` of sum|products|."""
    import torch

    got, ref = kern(), plain()
    torch.cuda.synchronize()
    out, rout = (got[0], ref[0]) if dot_op is not None else (got, ref)
    if out.dtype != rout.dtype or out.shape != rout.shape:
        raise RuntimeError(f"chip_smoke: {name} returned {out.dtype} {tuple(out.shape)}")
    err = (out.double() - rout.double()).abs().max().item()
    limit = REL_TOL[dtname] * rout.double().abs().max().item()
    ok = err <= limit
    tag = f"{name}{'[' + variant + ']' if variant else ''}"
    if dot_op is not None:
        terms = (dot_op.double() * rout.double()).abs().sum(dim=(1, 2, 3))
        derr = (got[1].double() - ref[1].double()).abs().flatten()
        dlim = DOT_TOL[dtname] * terms
        ok = ok and bool((derr <= dlim).all())
        tag += f" dot_err={derr.max().item():.2e}/{dlim.min().item():.2e}"
    return err, limit, ok, tag


def check_march(dev, kernel, shapes=KERNEL3D_SHAPES + EDGE_SHAPES, chunks=True,
                masks=((0, 1, 2),), label="[3 kernel]"):
    """A plane march (``kernel`` in ``MARCHES``) against its plain version
    at ``shapes`` x ``DTYPES`` x its variants masked on each of ``masks``
    (with ``chunks``, also with each of ``MARCH_CHUNKS`` planes per block);
    returns (worst err/limit, worst abs error per kernel name), raises on a
    failure."""
    import torch

    worst = 0.0
    worst_abs = {}
    n = 0
    for seed, shape in enumerate(shapes):
        for dtname in DTYPES:
            inv, beta, x, b, _ = _level_inputs(shape, getattr(torch, dtname), dev, 800 + seed)
            cases = [c for axes in masks for c in _march_cases(kernel, inv, beta, x, b, axes=axes)]
            for ci in MARCH_CHUNKS if chunks else ():
                cases += _march_cases(kernel, inv, beta, x, b, ci)
            for case in cases:
                err, limit, ok, tag = _check_case(*case, dtname)
                if not ok:
                    raise RuntimeError(f"chip_smoke: {tag} disagrees with its plain version at "
                                       f"{shape} {dtname}: {err:.3e} > {limit:.3e}")
                worst = max(worst, err / limit if limit > 0 else float(err > 0))
                worst_abs[case[0]] = max(worst_abs.get(case[0], 0.0), err)
                n += 1
            del x, b
    masked = f" x mask_axes {masks}" if masks != ((0, 1, 2),) else ""
    print(f"{label} {kernel}: {n} cases ({len(shapes)} shapes x {len(DTYPES)} dtypes{masked} x the "
          f"variants{' x plane chunks (auto, ' + str(MARCH_CHUNKS)[1:] if chunks else ''}), "
          f"worst err/limit {worst:.3f}", flush=True)
    return worst, worst_abs


def level_times(dev, kernel, n: int = N_MAIN, axes=(0, 1, 2)) -> list:
    """A plane march (bf16, the cycle's dtype) timed at every level shape
    of the n^3 V-cycle: ``jacobi3d`` as the masked residual (alpha 0, beta
    1: the cycle's call at every level above the coarsest) and as a
    smooth, ``jacobi3d_x2`` as a smooth pair, masked on ``axes`` (a torus
    cycle's: its non-periodic axes). Per level and variant the per-call
    time (``_time_ms``), the device time per call back to back
    (``_device_ms``), GB/s of its 3 grids of compulsory traffic, the bound
    and the share of it (both from the per-call time)."""
    import torch

    from pyapes_tpu_torch.ops import jacobi as K
    from pyapes_tpu_torch.solver.multigrid import _level_shapes

    rows = []
    grids, size, _, ops = BOUND_WORK[kernel]
    for lvl, shape in enumerate(_level_shapes((n,) * 3)):
        inv, beta, x, b, _ = _level_inputs((1, *shape), torch.bfloat16, dev, 900 + lvl)
        calls = {"": lambda: K.jacobi3d_x2(x, b, inv, beta, axes)}
        if kernel == "jacobi3d":
            calls = {"residual": lambda: K.jacobi3d(x, b, inv, 0.0, 1.0, axes),
                     "smooth": lambda: K.jacobi3d(x, b, inv, 1.0, beta, axes)}
        pts = x.numel()
        bound = _bound(grids * size * pts, ops * pts)[0]
        for variant, call in calls.items():
            ms, dev_ms = _time_ms(call), _device_ms(call)
            rows.append({"shape": shape, "variant": variant, "ms": ms, "device_ms": dev_ms,
                         "gb_per_s": grids * size * pts / (ms * 1e-3) / 1e9, "bound_ms": bound,
                         "share_of_bound": bound / ms})
        del x, b
    print(f"[3 kernel] {kernel} bf16 at the {n}^3 V-cycle's levels, mask_axes {axes} "
          "(per call: median of 15 "
          "CUDA-event timings; device: 30 calls back to back; share = bound / per-call time): "
          + "; ".join(f"{r['shape'][0]}^3{' ' + r['variant'] if r['variant'] else ''} "
                      f"{r['ms']:.4f} ms (device {r['device_ms']:.4f}) {r['gb_per_s']:.1f} GB/s "
                      f"{100 * r['share_of_bound']:.1f}%" for r in rows), flush=True)
    return rows


def check_dot(dev, shapes=DOT_SHAPES) -> tuple:
    """``axis_stencil_dot``'s plane march (also at ``MARCH_CHUNKS`` planes
    per block) and per-point kernel, each forced, against
    ``apply_axis_stencil_dot`` at ``shapes`` x ``DTYPES``: ``A x`` within
    ``REL_TOL`` and with the per-point kernel's bits at every chunk; the
    dot within ``DOT_TOL`` x sum|products| of the plain version's f64 dot
    on the same inputs; both with the same bits on another call. Raises
    otherwise; returns the worst abs error of ``A x`` and the worst
    err/limit per kernel (``A x`` and the dot)."""
    import torch

    from pyapes_tpu_torch.ops.axis_stencil import axis_stencil_dot
    from pyapes_tpu_torch.ops.stencil import apply_axis_stencil_dot

    worst, worst_rel, n_cases = 0.0, {k: 0.0 for k, _ in FORCED_KERNELS}, 0
    for seed, shape in enumerate(shapes):
        for dtname in DTYPES:
            _, _, x, _, coeffs = _level_inputs(shape, getattr(torch, dtname), dev, 100 + seed)
            ref = apply_axis_stencil_dot(coeffs, x)[0]
            ref_dot = apply_axis_stencil_dot(tuple(tuple(c.double() for c in cs) for cs in coeffs),
                                             x.double())[1]
            limit = REL_TOL[dtname] * ref.double().abs().max().item()
            dlim = DOT_TOL[dtname] * (x.double() * ref.double()).abs().sum(dim=(1, 2, 3))
            point, here = None, {}
            for kern, march in FORCED_KERNELS[::-1]:  # the per-point kernel first
                for ci in (None, *MARCH_CHUNKS) if march else (None,):
                    (out, dot), again = [axis_stencil_dot(coeffs, x, march=march, chunk=ci)
                                         for _ in range(2)]
                    torch.cuda.synchronize()
                    if out.dtype != ref.dtype or out.shape != ref.shape:
                        raise RuntimeError(f"chip_smoke: axis_stencil_dot returned {out.dtype} "
                                           f"{tuple(out.shape)}")
                    err = (out.double() - ref.double()).abs().max().item()
                    derr = (dot.double() - ref_dot).abs().flatten()
                    if not (err <= limit and bool((derr <= dlim).all())):
                        raise RuntimeError(
                            f"chip_smoke: axis_stencil_dot ({kern} kernel, chunk {ci}) disagrees "
                            f"with its plain version at {shape} {dtname}: A x {err:.3e} > "
                            f"{limit:.3e} or dot {derr.max().item():.3e} > {dlim.min().item():.3e}")
                    if not (torch.equal(again[0], out) and torch.equal(again[1], dot)):
                        raise RuntimeError(f"chip_smoke: axis_stencil_dot ({kern} kernel, chunk "
                                           f"{ci}) gave other bits on another call at {shape} "
                                           f"{dtname}")
                    if point is None:
                        point = out
                    elif not torch.equal(out, point):
                        raise RuntimeError(f"chip_smoke: axis_stencil_dot's march (chunk {ci}) "
                                           f"gave other A x bits than the per-point kernel at "
                                           f"{shape} {dtname}")
                    rel = max(err / limit if limit > 0 else 0.0, (derr / dlim).max().item())
                    here[kern] = max(here.get(kern, 0.0), rel)
                    worst = max(worst, err)
                    n_cases += 1
                    del out, dot, again
            for kern, v in here.items():
                worst_rel[kern] = max(worst_rel[kern], v)
            print(f"[3 kernel] axis_stencil_dot {tuple(shape)} {dtname}: worst err/limit "
                  + ", ".join(f"{k} {v:.3f}" for k, v in here.items())
                  + f" (A x and the dot against the plain f64 dot; the march at chunks auto, "
                  f"{', '.join(map(str, MARCH_CHUNKS))}: A x the per-point kernel's bits; "
                  "the same bits on another call)", flush=True)
            del x, ref, ref_dot, point
    print(f"[3 kernel] axis_stencil_dot: {n_cases} cases hold ({len(shapes)} shapes x "
          f"{len(DTYPES)} dtypes x the per-point kernel and the march at {1 + len(MARCH_CHUNKS)} "
          "chunks), worst err/limit " + ", ".join(f"{k} {v:.3f}" for k, v in worst_rel.items()),
          flush=True)
    return worst, worst_rel


def phase_kernel_slice2(dev):
    """The stencil alpha-dot's two kernels, each forced, against its plain
    version (``check_dot``); the plane marches (the single sweep and its
    dot, the double sweep) at every shape x dtype x variant and at their
    edge shapes and plane chunks; kernel vs plain timed at 512^3 (bf16 for
    the Jacobi family, the cycle dtype; f32 for the alpha-dot, the CG
    dtype, the shape's choice), the plane marches at every 512^3 MG level.
    Returns per-kernel worst abs error, (ms, plain_ms) and the plane
    marches' per-level times."""
    import torch

    from pyapes_tpu_torch.ops import jacobi as K
    from pyapes_tpu_torch.ops import stencil as P
    from pyapes_tpu_torch.ops.axis_stencil import axis_stencil_dot

    worst = {"axis_stencil_dot": check_dot(dev)[0]}
    _, _, x, _, coeffs = _level_inputs((1, N_MAIN, N_MAIN, N_MAIN), torch.float32, dev, 100)
    timing = {"axis_stencil_dot": (_time_ms(lambda: axis_stencil_dot(coeffs, x)),
                                   _time_ms(lambda: P.apply_axis_stencil_dot(coeffs, x)))}
    del x, coeffs
    for kernel in MARCHES:
        worst.update(check_march(dev, kernel)[1])
    # the 512^3 level first: the kernels' times
    levels = {kernel: level_times(dev, kernel, N_MAIN) for kernel in MARCHES}
    inv, beta, x, b, _ = _level_inputs((1, N_MAIN, N_MAIN, N_MAIN), torch.bfloat16, dev, 900)
    ax = (0, 1, 2)
    smooth = [r for r in levels["jacobi3d"] if r["variant"] == "smooth"][0]
    timing["jacobi3d"] = (smooth["ms"], _time_ms(lambda: P.apply_jacobi3d(x, b, inv, 1.0, beta,
                                                                          ax)))
    dot = lambda: K.jacobi3d_dot(x, b, inv, 1.0, beta, ax)  # noqa: E731
    timing["jacobi3d_dot"] = (_time_ms(dot), _time_ms(
        lambda: P.apply_jacobi3d_dot(x, b, inv, 1.0, beta, ax)))
    dot_device = _device_ms(dot)
    timing["jacobi3d_x2"] = (levels["jacobi3d_x2"][0]["ms"], _time_ms(
        lambda: P.apply_jacobi3d_x2(x, b, inv, beta, ax)))
    del x, b
    for name, (ms, plain_ms) in timing.items():
        grids = 2 if name == "axis_stencil_dot" else 3
        size = 4 if name == "axis_stencil_dot" else 2
        gbs = grids * N_MAIN**3 * size / (ms * 1e-3) / 1e9
        bound = _bound(grids * size * N_MAIN**3, BOUND_WORK[name][3] * N_MAIN**3)[0]
        extra = f"; device {dot_device:.4f} ms back to back" if name == "jacobi3d_dot" else ""
        print(f"[3 kernel] {name} {N_MAIN}^3 {'f32' if size == 4 else 'bf16'} time: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms (median of 15 CUDA-event timings{extra}); "
              f"kernel moves >= {gbs:.1f} GB/s ({grids} grids of compulsory traffic), "
              f"{100 * bound / ms:.1f}% of its {bound:.4f} ms bound", flush=True)
    return worst, timing, levels


def _vg_cases(shape, inv, x, b, g, avg, neumann):
    """(kernel name, variant, call) for the variable-Γ apply and the three
    Jacobi modes at one input: ``call(None)`` the plain version,
    ``call(kw)`` the wrapper with the keywords ``kw`` (``march``,
    ``chunk``; only those given are passed, so an older wrapper takes
    ``{}``)."""
    from pyapes_tpu_torch.ops import stencil as P
    from pyapes_tpu_torch.ops.diff_field import diff_field, diff_jacobi

    nd = len(shape) - 1
    mixed = (("neumann", "none"), ("none", "neumann"), ("neumann", "neumann"))
    surg = mixed[:nd] if neumann else (("none", "none"),) * nd
    axes = tuple(range(nd))
    omega = 0.857

    def apply(kw):
        if kw is None:
            return P.apply_diff_field(x, g, inv, surg, avg)
        return diff_field(x, g, inv, surg, avg, **kw)

    cases = [("diff_field", "", apply)]
    for mode in ("smooth", "smooth0", "resid"):
        def jac(kw, mode=mode, xm=None if mode == "smooth0" else x):
            if kw is None:
                return P.apply_diff_jacobi(xm, b, g, inv, surg, avg, omega, axes, mode)
            return diff_jacobi(xm, b, g, inv, surg, avg, omega, axes, mode, **kw)
        cases.append(("diff_jacobi", mode, jac))
    return cases


def _vg_inputs(shape, dtname, dev, seed):
    """inv_dx2, x, b (``_level_inputs``) and a stacked Γ in [1, 2) of a
    variable-Γ case (its first slice: the isotropic Γ)."""
    import torch

    dtype = getattr(torch, dtname)
    inv, _, x, b, _ = _level_inputs(shape, dtype, dev, seed)
    gen = torch.Generator(device=dev).manual_seed(100 + seed)
    gstack = 1.0 + torch.rand((len(shape) - 1, *shape[1:]), generator=gen, device=dev)
    return inv, x, b, gstack.to(dtype)


def check_vg(dev, shapes=VG_SHAPES + EDGE_SHAPES, forced=True) -> tuple:
    """The variable-Γ apply and the three Jacobi modes against their plain
    versions at ``shapes`` x dtype x (Γ layout, face rule, surgery) x mode:
    with ``forced`` the plane march (also at ``MARCH_CHUNKS`` planes per
    block) and the per-point kernel each forced, else the shape's choice
    through the wrappers' common signature only (an older version under
    ``ab_cells_torch.py --root``). Every result within ``REL_TOL``, the
    same bits at every chunk and on another call, or raises. Returns the
    worst abs error per wrapper and the worst err/limit per kernel."""
    import torch

    kernels = FORCED_KERNELS if forced else (("choice", None),)
    worst, worst_rel, n_cases = {}, {k: 0.0 for k, _ in kernels}, 0
    for seed, shape in enumerate(shapes):
        for dtname in DTYPES:
            inv, x, b, gstack = _vg_inputs(shape, dtname, dev, 200 + seed)
            here = {k: 0.0 for k, _ in kernels}
            for aniso, avg, neumann in VG_COMBOS:
                g = gstack if aniso else gstack[0]
                for name, variant, call in _vg_cases(shape, inv, x, b, g, avg, neumann):
                    ref = call(None)
                    limit = REL_TOL[dtname] * ref.double().abs().max().item()
                    tag = (f"{name}{'[' + variant + ']' if variant else ''}"
                           f"({'stacked' if aniso else 'iso'},{avg[:4]},"
                           f"{'neu' if neumann else 'none'})")
                    for kern, march in kernels:
                        kw = {} if march is None else {"march": march}
                        outs = []
                        for ci in (None, *MARCH_CHUNKS) if march else (None,):
                            got = call({**kw, "chunk": ci} if forced else kw)
                            torch.cuda.synchronize()
                            if got.dtype != ref.dtype or got.shape != ref.shape:
                                raise RuntimeError(f"chip_smoke: {name} returned {got.dtype} "
                                                   f"{tuple(got.shape)}")
                            err = (got.double() - ref.double()).abs().max().item()
                            if not err <= limit:
                                raise RuntimeError(
                                    f"chip_smoke: {tag} ({kern} kernel, chunk {ci}) disagrees "
                                    f"with its plain version at {shape} {dtname}: {err:.3e} > "
                                    f"{limit:.3e}")
                            worst[name] = max(worst.get(name, 0.0), err)
                            here[kern] = max(here[kern], err / limit if limit > 0 else 0.0)
                            outs.append(got)
                            n_cases += 1
                        outs.append(call(kw))  # the same bits on another call
                        if not all(torch.equal(o, outs[0]) for o in outs[1:]):
                            raise RuntimeError(f"chip_smoke: {tag} ({kern} kernel) gave other "
                                               f"bits at another plane chunk or call at {shape} "
                                               f"{dtname}")
                        del outs
                    del ref
            for kern in here:
                worst_rel[kern] = max(worst_rel[kern], here[kern])
            print(f"[3 kernel] variable-Γ {tuple(shape)} {dtname}: worst err/limit "
                  + ", ".join(f"{k} {v:.3f}" for k, v in here.items())
                  + f" ({len(VG_COMBOS)} Γ/face/surgery combinations x 4 modes"
                  + (f"; the march at chunks auto, {', '.join(map(str, MARCH_CHUNKS))}"
                     if forced else "") + ": same bits, and on another call)", flush=True)
            del x, b, gstack
    print(f"[3 kernel] variable-Γ: {n_cases} cases hold ({len(shapes)} shapes x {len(DTYPES)} "
          f"dtypes x {len(VG_COMBOS)} combinations x 4 modes"
          + (f" x the per-point kernel and the march at {1 + len(MARCH_CHUNKS)} chunks"
             if forced else ", the shape's choice of kernel")
          + "), worst err/limit " + ", ".join(f"{k} {v:.3f}" for k, v in worst_rel.items()),
          flush=True)
    return worst, worst_rel


def phase_kernel_vargamma(dev):
    """The variable-Γ kernels, the plane march and the per-point kernel
    each forced, against their plain versions (``check_vg``). Then kernel
    (the shape's choice, the march at 512^3) vs plain timed at 512^3 (f32
    for the apply, the outer operator's dtype; bf16 for the Jacobi pass,
    the cycle dtype), the per-point kernel beside it. Returns per-kernel
    worst abs error and (ms, plain_ms, library_ms)."""
    worst, _ = check_vg(dev)
    timing = {}
    for name, dtname, variant in (("diff_field", "float32", ""),
                                  ("diff_jacobi", "bfloat16", "smooth")):
        shape = (1, N_MAIN, N_MAIN, N_MAIN)
        inv, x, b, gstack = _vg_inputs(shape, dtname, dev, 900)
        g = gstack[0].contiguous()
        del gstack
        call = [c for n, v, c in _vg_cases(shape, inv, x, b, g, "arithmetic", False)
                if (n, v) == (name, variant)][0]
        ref = call(None)
        # the apply at a fixed Γ is one sparse product; the Jacobi pass (an
        # update with a division) is none
        lib_ms = (_library_stencil_ms(_diff_field_csr_coeffs(g, inv), x, ref)
                  if name == "diff_field" else None)
        del ref
        ms, plain_ms = _time_ms(lambda: call({})), _time_ms(lambda: call(None))
        point_ms = _time_ms(lambda: call({"march": False}))
        dev_ms = _device_ms(lambda: call({}))
        point_dev = _device_ms(lambda: call({"march": False}))
        timing[name] = (ms, plain_ms, lib_ms)
        grids, size, _, ops = BOUND_WORK[name]
        bound = _bound(grids * size * N_MAIN**3, ops * N_MAIN**3)[0]
        gbs = grids * N_MAIN**3 * size / (ms * 1e-3) / 1e9
        lib = "" if lib_ms is None else f", CSR product (torch.mv) {lib_ms:.4f} ms"
        print(f"[3 kernel] {name} {N_MAIN}^3 {'f32' if size == 4 else 'bf16'}"
              f"{' ' + variant if variant else ''} (isotropic Γ, arithmetic faces) time: kernel "
              f"(the plane march) {ms:.4f} ms (device {dev_ms:.4f} back to back), the per-point "
              f"kernel {point_ms:.4f} ms (device {point_dev:.4f}), plain {plain_ms:.4f} ms{lib} "
              f"(median of 15 CUDA-event timings); the march moves >= {gbs:.1f} GB/s ({grids} "
              f"grids of compulsory traffic), {100 * bound / ms:.1f}% of its {bound:.4f} ms "
              f"bound ({100 * bound / dev_ms:.1f}% on the device)", flush=True)
        del x, b, g
    return worst, timing


def vg_level_times(dev, sizes=(N_DARCY, N_MAIN), forced=True) -> list:
    """``diff_jacobi`` (bf16, isotropic Γ, arithmetic faces: the Darcy
    cycle's call) at every level of the n^3 V-cycle for n in ``sizes``
    (each level once), as smooth and residual: the device time per call
    back to back (``_device_ms``) of the shape's choice and, with
    ``forced``, of the plane march and the per-point kernel each forced;
    then the wrapper's threshold beside the smallest level from which up
    the march is at or below the per-point kernel. Without ``forced`` only
    the wrappers' common signature is used (an older version under
    ``ab_cells_torch.py --root``)."""
    from pyapes_tpu_torch.ops import diff_field as D
    from pyapes_tpu_torch.solver.multigrid import _level_shapes

    shapes = sorted({s for n in sizes for s in _level_shapes((n,) * 3)}, reverse=True)
    rows = []
    for lvl, shape in enumerate(shapes):
        inv, x, b, gstack = _vg_inputs((1, *shape), "bfloat16", dev, 950 + lvl)
        g = gstack[0].contiguous()
        del gstack
        surg = (("none", "none"),) * 3
        pts = x.numel()
        bound = _bound(4 * 2 * pts, BOUND_WORK["diff_jacobi"][3] * pts)[0]
        for mode in ("smooth", "resid"):
            def call(mode=mode, **kw):
                return D.diff_jacobi(x, b, g, inv, surg, "arithmetic", 0.857, (0, 1, 2), mode,
                                     **kw)
            row = {"shape": shape, "mode": mode, "bound_ms": bound,
                   "device_ms": _device_ms(call)}
            if forced:
                row["march_device_ms"] = _device_ms(lambda: call(march=True))
                row["point_device_ms"] = _device_ms(lambda: call(march=False))
                row["march"] = D.uses_march((1, *shape))
            rows.append(row)
        del x, b, g
    text = "; ".join(
        f"{r['shape'][0]}^3 {r['mode']} {1e3 * r['device_ms']:.2f}"
        + (f" (march {1e3 * r['march_device_ms']:.2f}, per-point {1e3 * r['point_device_ms']:.2f})"
           if forced else "") for r in rows)
    print(f"[3 kernel] diff_jacobi bf16 at the {'/'.join(map(str, sizes))}^3 V-cycles' levels, "
          f"device µs per call back to back (the shape's choice"
          f"{'; the march and the per-point kernel forced' if forced else ''}): {text}",
          flush=True)
    if forced:
        wins = {}
        for r in rows:
            wins[r["shape"]] = wins.get(r["shape"], True) and (r["march_device_ms"]
                                                               <= r["point_device_ms"])
        edge = None
        for shape in sorted(wins, reverse=True):  # the run of wins from the largest level down
            if not wins[shape]:
                break
            edge = shape
        other = [f"{r['shape'][0]}^3 {r['mode']}" for r in rows
                 if (r["march_device_ms"] > r["point_device_ms"] if r["march"]
                     else r["point_device_ms"] > r["march_device_ms"])]
        print(f"[3 kernel] diff_jacobi kernel choice: the march from {D.MARCH_MIN_POINTS} points "
              f"per component (the wrapper's threshold, set inside the Darcy solve: PERF.md); "
              f"back to back here, the march at or below the per-point kernel from "
              f"{edge[0] if edge else '-'}^3 up, and the kernel not chosen faster at: "
              f"{', '.join(other) or 'no level'}", flush=True)
    return rows


def _adv_inputs(shape, dtype, dev, seed):
    """A target, advectors (Div: as many components as the target; Conv:
    one per axis), base vectors of the unit box, and 5-point coefficients
    with axes 0 and 2 of 5 vectors and axis 1 of 3."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    gen = torch.float64 if dtype == torch.float64 else torch.float32
    nd = len(shape) - 1

    def rnd(*sh):
        return torch.randn(sh, generator=g, device=dev, dtype=gen).to(dtype)

    base = tuple(tuple(torch.full((n,), v, device=dev, dtype=gen).to(dtype)
                       for v in (0.5 * (n - 1), 0.0, -0.5 * (n - 1))) for n in shape[1:])
    c5 = tuple(tuple(rnd(n) for _ in range(3 if j == 1 else 5)) for j, n in enumerate(shape[1:]))
    return rnd(*shape), rnd(*shape), rnd(nd, *shape[1:]), base, c5


def _adv_cases(shape, x, adv, adv_conv, base, c5):
    """(kernel name, variant, kernel call, plain call) of the three
    advection kernels at one input."""
    from pyapes_tpu_torch.ops import stencil as P
    from pyapes_tpu_torch.ops.advect import advect_pair, conv_component
    from pyapes_tpu_torch.ops.axis_stencil import axis_stencil5

    nd = len(shape) - 1
    cases = []
    for kind, surg in ADV_SURGERY.items():
        surg = surg[:nd]
        for lim, form in DIV_VARIANTS:
            for xs, av, tag in ((x, adv, f"vdim{shape[0]}"), (x[:1], adv[:1], "scalar")):
                cases.append(("advect_pair", f"{lim},{form[:4]},{kind},{tag}",
                              lambda xs=xs, av=av, lim=lim, form=form, surg=surg:
                              advect_pair(xs, av, base, lim, surg, form),
                              lambda xs=xs, av=av, lim=lim, form=form, surg=surg:
                              P.apply_div_field(xs, av, base, lim, surg, form)))
        for lim in ("none", "upwind", "quick"):
            cases.append(("conv_component", f"{lim},{kind}",
                          lambda lim=lim, surg=surg: conv_component(x, adv_conv, base, lim, surg),
                          lambda lim=lim, surg=surg: P.apply_conv_field(x, adv_conv, base, lim,
                                                                        surg)))
    cases.append(("axis_stencil5", "mixed 3/5", lambda: axis_stencil5(c5, x),
                  lambda: P.apply_axis_stencil(c5, x)))
    return cases


def _adv_march_cases(x, adv, adv_conv, base, surg):
    """(kernel name, variant, call) of the advection march's variants at
    one input: ``call(plain, **kw)`` is the plain version with ``plain``,
    else the wrapper with ``kw`` (``march``, ``chunk``)."""
    from pyapes_tpu_torch.ops import stencil as P
    from pyapes_tpu_torch.ops.advect import advect_pair, conv_component

    cases = []
    for lim, form in ADV_MARCH_DIV:
        for xs, av, tag in ((x, adv, f"vdim{x.shape[0]}"), (x[:1], adv[:1], "scalar")):
            def call(plain, xs=xs, av=av, lim=lim, form=form, **kw):
                if plain:
                    return P.apply_div_field(xs, av, base, lim, surg, form)
                return advect_pair(xs, av, base, lim, surg, form, **kw)
            cases.append(("advect_pair", f"{lim},{form[:4]},{tag}", call))
    for lim in ADV_MARCH_CONV:
        def call(plain, lim=lim, **kw):
            if plain:
                return P.apply_conv_field(x, adv_conv, base, lim, surg)
            return conv_component(x, adv_conv, base, lim, surg, **kw)
        cases.append(("conv_component", lim, call))
    return cases


def check_adv(dev, shapes=ADV_MARCH_SHAPES, forced=True,
              names=("advect_pair", "conv_component")) -> tuple:
    """``advect_pair`` and ``conv_component`` on the march's variants
    (``_adv_march_cases``) against their plain versions at ``shapes`` x
    ``DTYPES`` x ``ADV_SURGERY``: with ``forced`` the plane march (also at
    ``MARCH_CHUNKS`` planes per block) and the per-point kernel each
    forced, else the shape's choice through the wrappers' common signature
    only (an older version under ``ab_cells_torch.py --root``); the
    wrappers in ``names``. Every result within ``REL_TOL``, the same bits
    at every chunk and on another call, and (forced) the march the same
    bits as the per-point kernel, or raises. Returns the worst abs error
    per wrapper and the worst err/limit per kernel."""
    import torch

    kernels = FORCED_KERNELS if forced else (("choice", None),)
    worst, worst_rel, n_cases = {}, {k: 0.0 for k, _ in kernels}, 0
    for seed, shape in enumerate(shapes):
        for dtname in DTYPES:
            x, adv, adv_conv, base, _ = _adv_inputs(shape, getattr(torch, dtname), dev, 600 + seed)
            here = {k: 0.0 for k, _ in kernels}
            for kind, surg in ADV_SURGERY.items():
                for name, variant, call in _adv_march_cases(x, adv, adv_conv, base, surg):
                    if name not in names:
                        continue
                    ref = call(True)
                    limit = REL_TOL[dtname] * ref.double().abs().max().item()
                    first = {}
                    for kern, march in kernels:
                        kw = {} if march is None else {"march": march}
                        outs = []
                        for ci in (None, *MARCH_CHUNKS) if march else (None,):
                            got = call(False, **({**kw, "chunk": ci} if forced else kw))
                            torch.cuda.synchronize()
                            if got.dtype != ref.dtype or got.shape != ref.shape:
                                raise RuntimeError(f"chip_smoke: {name} returned {got.dtype} "
                                                   f"{tuple(got.shape)}")
                            err = (got.double() - ref.double()).abs().max().item()
                            if not err <= limit:
                                raise RuntimeError(
                                    f"chip_smoke: {name}[{variant},{kind}] ({kern} kernel, chunk "
                                    f"{ci}) disagrees with its plain version at {shape} {dtname}: "
                                    f"{err:.3e} > {limit:.3e}")
                            worst[name] = max(worst.get(name, 0.0), err)
                            here[kern] = max(here[kern], err / limit if limit > 0 else 0.0)
                            outs.append(got)
                            n_cases += 1
                        outs.append(call(False, **kw))  # the same bits on another call
                        if not all(torch.equal(o, outs[0]) for o in outs[1:]):
                            raise RuntimeError(f"chip_smoke: {name}[{variant},{kind}] ({kern} "
                                               f"kernel) gave other bits at another plane chunk "
                                               f"or call at {shape} {dtname}")
                        first[kern] = outs[0]
                        del outs
                    if forced and not torch.equal(first["march"], first["point"]):
                        raise RuntimeError(f"chip_smoke: {name}[{variant},{kind}]: the march and "
                                           f"the per-point kernel gave other bits at {shape} "
                                           f"{dtname}")
                    del ref, first
            for kern in here:
                worst_rel[kern] = max(worst_rel[kern], here[kern])
            print(f"[8 advection kernels] march variants {tuple(shape)} {dtname}: worst err/limit "
                  + ", ".join(f"{k} {v:.3f}" for k, v in here.items())
                  + f" (surgery {', '.join(ADV_SURGERY)}; Div central both forms and upwind, "
                  "vector and scalar targets; Conv central and upwind"
                  + (f"; the march at chunks auto, {', '.join(map(str, MARCH_CHUNKS))}"
                     if forced else "") + ": same bits, and on another call"
                  + ("; the march's bits equal the per-point kernel's" if forced else "") + ")",
                  flush=True)
            del x, adv, adv_conv, base
    print(f"[8 advection kernels] march variants of {', '.join(names)}: {n_cases} cases hold "
          f"({len(shapes)} shapes x {len(DTYPES)} dtypes x {len(ADV_SURGERY)} surgery kinds x "
          f"their variants (Div {2 * len(ADV_MARCH_DIV)}, Conv {len(ADV_MARCH_CONV)})"
          + (f" x the per-point kernel and the march at {1 + len(MARCH_CHUNKS)} chunks"
             if forced else ", the shape's choice of kernel")
          + "), worst err/limit " + ", ".join(f"{k} {v:.3f}" for k, v in worst_rel.items()),
          flush=True)
    return worst, worst_rel


def adv_level_times(dev, forced=True, names=("conv_component", "advect_pair")) -> list:
    """``conv_component`` (one target component, central: the Burgers
    path's call) and ``advect_pair`` (scalar, upwind: the upwind
    advection-diffusion path's call) at 512^3, 256^3 (the paths' grid),
    129^3, 128^3 and 64^3 f32 and at 256^3 bf16 and f64: per call
    (``_time_ms``) and on the device back to back (``_device_ms``), the
    shape's choice and, with ``forced``, the plane march and the per-point
    kernel each forced; a device copy of x and the bound beside them. Each
    row's shape-chosen output is first held against its plain version
    within ``REL_TOL`` (raises otherwise). Then the wrappers' rule beside
    the smallest grid from which up the march is at or below the per-point
    kernel on the device in every row, among grids whose every tile lies
    inside them (``march_full``). Without ``forced`` only the wrappers'
    common signature is used (an older version under ``ab_cells_torch.py
    --root``); the wrappers in ``names``."""
    import torch

    from pyapes_tpu_torch.ops import advect as A
    from pyapes_tpu_torch.ops import stencil as P

    surg = ADV_SURGERY["none"]
    cases = [(m, "float32") for m in (2 * N_PATH, N_PATH, 129, 128, 64)]
    cases += [(N_PATH, "bfloat16"), (N_PATH, "float64")]
    rows = []
    for lvl, (m, dtname) in enumerate(cases):
        shape = (1, m, m, m)
        x, adv, adv_conv, base, _ = _adv_inputs(shape, getattr(torch, dtname), dev, 980 + lvl)
        calls = {
            "conv_component": (lambda **kw: A.conv_component(x, adv_conv, base, "none", surg, **kw),
                               lambda: P.apply_conv_field(x, adv_conv, base, "none", surg), "none"),
            "advect_pair": (lambda **kw: A.advect_pair(x, adv, base, "upwind", surg, **kw),
                            lambda: P.apply_div_field(x, adv, base, "upwind", surg), "upwind"),
        }
        copy = torch.empty_like(x)  # a device copy of x: the traffic's yardstick
        copy_ms = _device_ms(lambda: copy.copy_(x))
        for name, (fn, plain, lim) in calls.items():
            if name not in names:
                continue
            ref = plain()
            err = (fn().double() - ref.double()).abs().max().item()
            limit = REL_TOL[dtname] * ref.double().abs().max().item()
            if not err <= limit:
                raise RuntimeError(f"chip_smoke: {name} (the shape's choice) disagrees with its "
                                   f"plain version at {shape} {dtname}: {err:.3e} > {limit:.3e}")
            del ref
            grids, _, _, ops = BOUND_WORK[name]
            pts = x.numel()
            row = {"n": m, "dtype": dtname, "kernel": name, "copy_device_ms": copy_ms,
                   "bound_ms": _bound(grids * x.element_size() * pts, ops * pts)[0],
                   "ms": _time_ms(fn), "device_ms": _device_ms(fn),
                   "err_over_limit": err / limit if limit > 0 else 0.0}
            if forced:
                for kern, march in FORCED_KERNELS:
                    row[f"{kern}_ms"] = _time_ms(lambda: fn(march=march))
                    row[f"{kern}_device_ms"] = _device_ms(lambda: fn(march=march))
                row["march"] = A.uses_march(shape, lim)
            rows.append(row)
        del x, adv, adv_conv, base, copy
    print(f"[8 advection kernels] conv_component (central, one target component) and advect_pair "
          f"(scalar, upwind) at {2 * N_PATH}^3, {N_PATH}^3, 129^3, 128^3 and 64^3 f32 and "
          f"{N_PATH}^3 bf16 and f64, ms per call (median of 15 CUDA-event timings) / device µs "
          "per call (30 back to back), the shape's choice (each within REL_TOL of the plain "
          f"version, worst err/limit {max(r['err_over_limit'] for r in rows):.3f})"
          + ("; the march and the per-point kernel forced" if forced else "")
          + "; a device copy of x (the traffic's yardstick) and the bound: "
          + "; ".join(
              f"{r['kernel']} {r['n']}^3 {r['dtype']} {r['ms']:.4f} / "
              f"{1e3 * r['device_ms']:.2f} ({100 * r['bound_ms'] / r['device_ms']:.1f}% of "
              f"{1e3 * r['bound_ms']:.2f}; copy {1e3 * r['copy_device_ms']:.2f})"
              + (f" [march {r['march_ms']:.4f} / {1e3 * r['march_device_ms']:.2f}, per-point "
                 f"{r['point_ms']:.4f} / {1e3 * r['point_device_ms']:.2f}]" if forced else "")
              for r in rows), flush=True)
    if forced:
        wins = {}
        for r in rows:
            if A.march_full((1, r["n"], r["n"], r["n"])):
                wins[r["n"]] = wins.get(r["n"], True) and (r["march_device_ms"]
                                                           <= r["point_device_ms"])
        edge = None
        for m in sorted(wins, reverse=True):  # the run of wins from the largest grid down
            if not wins[m]:
                break
            edge = m
        other = [f"{r['kernel']} {r['n']}^3 {r['dtype']}" for r in rows
                 if (r["march_device_ms"] > r["point_device_ms"] if r["march"]
                     else r["point_device_ms"] > r["march_device_ms"])]
        print(f"[8 advection kernels] kernel choice: the march from {A.MARCH_MIN_POINTS} points "
              f"per component on grids whose every 16 x 128 tile lies inside them, QUICK never "
              f"(the wrappers' rule); on the device back to back here, among such grids, the "
              f"march at or below the per-point kernel from {edge if edge else '-'}^3 up, and "
              f"the kernel not chosen faster at: {', '.join(other) or 'no row'}", flush=True)
    return rows


def phase_kernel_advect(dev):
    """The Div and Conv kernels (the shape's choice) and the 5-point axis
    stencil against their plain versions at every shape x dtype x case;
    the Div and Conv march and per-point kernel each forced on the march's
    variants (``check_adv``); kernel vs plain timed at 256^3 and 512^3 f32
    on the paths' cases (Div upwind, Conv central, QUICK's 5-point axes),
    per call and on the device, the per-point kernel beside the march, and
    at 256^3 the CSR yardstick; then ``adv_level_times``."""
    import torch

    from pyapes_tpu_torch.ops import stencil as P
    from pyapes_tpu_torch.ops.advect import advect_pair, conv_component
    from pyapes_tpu_torch.ops.axis_stencil import axis_stencil5

    worst = {}
    for seed, shape in enumerate(ADV_SHAPES):
        for dtname in DTYPES:
            dtype = getattr(torch, dtname)
            x, adv, adv_conv, base, c5 = _adv_inputs(shape, dtype, dev, 400 + seed)
            parts, fails = [], []
            for name, variant, kern, plain in _adv_cases(shape, x, adv, adv_conv, base, c5):
                got, ref = kern(), plain()
                torch.cuda.synchronize()
                if got.dtype != ref.dtype or got.shape != ref.shape:
                    raise RuntimeError(f"chip_smoke: {name} returned {got.dtype} "
                                       f"{tuple(got.shape)}")
                err = (got.double() - ref.double()).abs().max().item()
                limit = REL_TOL[dtname] * ref.double().abs().max().item()
                worst[name] = max(worst.get(name, 0.0), err)
                parts.append(err / limit if limit > 0 else (0.0 if err == 0 else float("inf")))
                if not err <= limit:
                    fails.append(f"{name}[{variant}] {err:.2e}/{limit:.2e}")
            print(f"[8 advection kernels] {tuple(shape)} {dtname}: {len(parts)} cases, worst "
                  f"err/limit {max(parts):.3f}{'; FAIL ' + '; '.join(fails) if fails else ''}",
                  flush=True)
            if fails:
                raise RuntimeError(f"chip_smoke: advection kernels disagree with their plain "
                                   f"versions at {shape} {dtname}: {fails}")
            del x, adv, adv_conv
    worst_m, _ = check_adv(dev)
    for name, err in worst_m.items():
        worst[name] = max(worst[name], err)
    timing = {}
    for n in N_ADV:
        shape = (1, n, n, n)
        x, adv, adv_conv, base, _ = _adv_inputs(shape, torch.float32, dev, 500 + n)
        c5 = tuple(tuple(torch.randn(n, device=dev) for _ in range(5)) for _ in range(3))
        surg = ADV_SURGERY["none"]
        timed = {
            "advect_pair": (lambda: advect_pair(x, adv, base, "upwind", surg),
                            lambda: P.apply_div_field(x, adv, base, "upwind", surg), 3),
            "conv_component": (lambda: conv_component(x, adv_conv, base, "none", surg),
                               lambda: P.apply_conv_field(x, adv_conv, base, "none", surg), 5),
            "axis_stencil5": (lambda: axis_stencil5(c5, x),
                              lambda: P.apply_axis_stencil(c5, x), 2),
        }
        for name, (kern, plain, grids) in timed.items():
            got, ref = kern(), plain()
            err = (got - ref).abs().max().item()
            limit = REL_TOL["float32"] * ref.abs().max().item()
            if not err <= limit:
                raise RuntimeError(f"chip_smoke: {name} disagrees at {n}^3: {err} > {limit}")
            worst[name] = max(worst[name], err)
            ms, plain_ms, dev_ms = _time_ms(kern), _time_ms(plain), _device_ms(kern)
            point = ""
            if name != "axis_stencil5":  # the per-point kernel of the same call
                args = {"advect_pair": (x, adv, base, "upwind", surg),
                        "conv_component": (x, adv_conv, base, "none", surg)}[name]
                fn = advect_pair if name == "advect_pair" else conv_component
                point = (f", the per-point kernel {_time_ms(lambda: fn(*args, march=False)):.4f} "
                         f"ms (device {_device_ms(lambda: fn(*args, march=False)):.4f})")
            lib_ms = None
            if n == N_PATH:  # at a fixed advector each is one sparse product
                lib_ms = _library_stencil_ms({
                    "advect_pair": lambda: _advect_csr_coeffs([adv[0]] * 3, base, "upwind"),
                    "conv_component": lambda: _advect_csr_coeffs(list(adv_conv), base, "none"),
                    "axis_stencil5": lambda: c5,
                }[name](), x, ref)
            del got, ref
            timing.setdefault(name, {})[n] = (ms, plain_ms, lib_ms)
            gbs = grids * n**3 * 4 / (ms * 1e-3) / 1e9
            lib = "" if lib_ms is None else f", CSR product (torch.mv) {lib_ms:.4f} ms"
            print(f"[8 advection kernels] {name} {n}^3 f32 time: kernel (the shape's choice, the "
                  f"plane march) {ms:.4f} ms (device {dev_ms:.4f} back to back){point}, plain "
                  f"{plain_ms:.4f} ms{lib} (median of 15 CUDA-event timings); kernel moves >= "
                  f"{gbs:.1f} GB/s ({grids} grids of compulsory traffic)", flush=True)
        del x, adv, adv_conv, c5
    adv_level_times(dev)
    return worst, {name: t[N_PATH] for name, t in timing.items()}


def phase_kernel_ext(dev):
    """The halo-extended apply's two kernels, the plane march (also at
    ``MARCH_CHUNKS`` planes per block) and the per-point kernel, each
    forced, against its plain version on every block x ext flag x dtype,
    written into a new tensor and into a strided view of a larger one
    (pair stores or single ones, by its strides), with the same bits; and
    in bf16 on the blocks of the decomposed MG levels (the shape's choice
    and both kernels forced, the same bits); then timed at the decomposed
    paths' blocks (512^3 f32 in ``N_DECOMP``: eight launches, one per
    block, each writing its view of the global result; the shape's choice,
    the march) against the plain version, the CSR yardstick and the bound,
    and the whole block-wise apply (exchange + kernels) against the global
    axis-stencil kernel."""
    import torch

    from pyapes_tpu_torch.ops.axis_stencil import axis_stencil, axis_stencil_ext, uses_march_ext
    from pyapes_tpu_torch.ops.stencil import apply_axis_stencil, apply_axis_stencil_ext
    from pyapes_tpu_torch.parallel import DomainDecomposition, halo
    from pyapes_tpu_torch.solver.multigrid import MGSpec

    worst, ratios = 0.0, []
    for seed, block in enumerate(EXT_BLOCKS):
        for ext in EXT_FLAGS:
            for dtname in DTYPES:
                dtype = getattr(torch, dtname)
                g = torch.Generator(device=dev).manual_seed(600 + seed)
                gen = torch.float64 if dtype == torch.float64 else torch.float32
                coeffs = tuple(tuple(torch.randn(n, generator=g, device=dev, dtype=gen).to(dtype)
                                     for _ in range(3)) for n in block[1:])
                xe = torch.randn((block[0], *(n + 2 * e for n, e in zip(block[1:], ext))),
                                 generator=g, device=dev, dtype=gen).to(dtype)
                ref = apply_axis_stencil_ext(coeffs, xe, ext)
                big = torch.zeros((block[0] + 1, block[1] + 2, block[2] + 3, block[3]),
                                  dtype=dtype, device=dev)
                view = big[1:, 1:1 + block[1], 3:]
                limit = REL_TOL[dtname] * ref.double().abs().max().item()
                first = None
                for out in (None, view):
                    for kern, march in FORCED_KERNELS:
                        for ci in (None, *MARCH_CHUNKS) if march else (None,):
                            got = axis_stencil_ext(coeffs, xe, ext, out=out, march=march,
                                                   chunk=ci)
                            torch.cuda.synchronize()
                            err = (got.double() - ref.double()).abs().max().item()
                            if not (err <= limit and got.shape == ref.shape
                                    and got.dtype == ref.dtype):
                                raise RuntimeError(
                                    f"chip_smoke: axis_stencil_ext ({kern} kernel, chunk {ci}) "
                                    f"disagrees at {block} ext {ext} {dtname}: {err:.3e} > "
                                    f"{limit:.3e}")
                            if first is None:
                                first = got.clone()
                            elif not torch.equal(got, first):
                                raise RuntimeError(
                                    f"chip_smoke: axis_stencil_ext ({kern} kernel, chunk {ci}, "
                                    f"{'a view' if out is not None else 'a new tensor'}) gave "
                                    f"other bits at {block} ext {ext} {dtname}")
                            worst = max(worst, err)
                            ratios.append(err / limit if limit > 0 else 0.0)
                if big[0].any() or big[:, 0].any() or big[:, :, :3].any():
                    raise RuntimeError(f"chip_smoke: axis_stencil_ext wrote outside its view at "
                                       f"{block} ext {ext} {dtname}")
    print(f"[3 kernel] axis_stencil_ext: {len(ratios)} cases ({len(EXT_BLOCKS)} blocks x "
          f"{len(EXT_FLAGS)} ext flags x {len(DTYPES)} dtypes x new/strided output x the "
          f"per-point kernel and the march at {1 + len(MARCH_CHUNKS)} chunks, all with the same "
          f"bits), worst err/limit {max(ratios):.3f}", flush=True)

    # the decomposed MG-PCG's own launches: every level of its 512^3
    # hierarchy that the gate applies block-wise, with the level's bf16
    # Laplacian vectors as MGSpec builds them, each block exchanged as the
    # cycle exchanges it, into the block's view of the level's result
    n = N_MAIN
    dd = DomainDecomposition(N_DECOMP)
    ext = tuple(int(m > 1) for m in N_DECOMP)
    spec = MGSpec((n,) * 3, (1.0,) * 3, dtype=torch.float32, cycle_dtype=BENCH_MG["dtype"],
                  decomp=dd, device=dev)
    levels = {}
    for lvl, shape in enumerate(spec.shapes):
        if not halo.sharded_supported(dd, shape):
            continue
        coeffs = spec._level_coeffs(shape)
        g = torch.Generator(device=dev).manual_seed(650 + lvl)
        x = torch.randn((1, *shape), generator=g, device=dev).to(spec.cdtype)
        out = torch.empty_like(x)
        err = limit = 0.0
        for _, sl in dd.blocks(shape):
            xe, cs = halo.exchange(x, sl, ext, {}), halo._block_coeffs(coeffs, sl)
            ob = axis_stencil_ext(cs, xe, ext, out=out[(slice(None), *sl)])
            ref = apply_axis_stencil_ext(cs, xe, ext)
            if not all(torch.equal(axis_stencil_ext(cs, xe, ext, march=march), ob)
                       for _, march in FORCED_KERNELS):
                raise RuntimeError(f"chip_smoke: axis_stencil_ext's two kernels gave other bits "
                                   f"on the bf16 MG level {shape} blocks")
            torch.cuda.synchronize()
            err = max(err, (ob.double() - ref.double()).abs().max().item())
            limit = max(limit, REL_TOL["bfloat16"] * ref.double().abs().max().item())
        if not err <= limit:
            raise RuntimeError(f"chip_smoke: axis_stencil_ext disagrees on the bf16 MG level "
                               f"{shape} blocks: {err:.3e} > {limit:.3e}")
        glob = apply_axis_stencil(coeffs, x)
        gerr = (out.double() - glob.double()).abs().max().item()
        if not gerr <= REL_TOL["bfloat16"] * glob.double().abs().max().item():
            raise RuntimeError(f"chip_smoke: the bf16 MG level {shape} blocks differ from the "
                               f"global stencil: {gerr:.3e}")
        worst = max(worst, err)
        levels[shape] = (f"{shape} blocks {tuple(xe.shape[1:])} err/limit {err / limit:.3f} "
                         f"({'march' if uses_march_ext(ob.shape, ob) else 'per-point'})")
        del x, out, glob
    if (n,) * 3 not in levels:
        raise RuntimeError(f"chip_smoke: the {n}^3 MG fine level is not applied block-wise")
    print(f"[3 kernel] axis_stencil_ext bf16 on the {N_DECOMP} blocks of the {n}^3 MG levels "
          f"(MGSpec's Laplacian vectors; the shape's choice, both kernels forced with its bits): "
          + "; ".join(levels.values()), flush=True)

    g = torch.Generator(device=dev).manual_seed(700)
    coeffs = tuple(tuple(torch.randn(n, generator=g, device=dev) for _ in range(3))
                   for _ in range(3))
    x = torch.randn((1, n, n, n), generator=g, device=dev)
    blocks = [(sl, halo.exchange(x, sl, ext, {}), halo._block_coeffs(coeffs, sl))
              for _, sl in dd.blocks((n, n, n))]
    out = torch.empty_like(x)

    def kern():
        for sl, xe, cs in blocks:
            axis_stencil_ext(cs, xe, ext, out=out[(slice(None), *sl)])

    def plain():
        for sl, xe, cs in blocks:
            out[(slice(None), *sl)] = apply_axis_stencil_ext(cs, xe, ext)

    kern()
    glob = apply_axis_stencil(coeffs, x)
    err = (out - glob).abs().max().item()
    if not err <= REL_TOL["float32"] * glob.abs().max().item():
        raise RuntimeError(f"chip_smoke: the {N_DECOMP} blocks of axis_stencil_ext differ from the "
                           f"global stencil at {n}^3: {err:.3e}")
    worst = max(worst, err)
    ms, plain_ms = _time_ms(kern), _time_ms(plain)
    lib_ms = _library_stencil_ms(None, None, None, ext, [
        (xe, cs, glob[(slice(None), *sl)]) for sl, xe, cs in blocks])
    nbytes = sum(xe.numel() for _, xe, _ in blocks) * 4 + x.numel() * 4
    bound = _bound(nbytes, BOUND_WORK["axis_stencil"][3] * x.numel())
    apply = halo.make_sharded_apply(dd, 3)
    sharded_ms, global_ms = _time_ms(lambda: apply(coeffs, x)), _time_ms(
        lambda: axis_stencil(coeffs, x))
    print(f"[3 kernel] axis_stencil_ext {n}^3 f32 in {N_DECOMP} blocks of "
          f"{tuple(blocks[0][1].shape[1:])} extended (8 launches): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, CSR products {lib_ms:.4f} ms, bound {bound[0]:.4f} ms "
          f"({nbytes / 1e9:.3f} GB), {nbytes / (ms * 1e-3) / 1e9:.1f} GB/s; block-wise apply (exchange + kernels) "
          f"{sharded_ms:.4f} ms vs global axis_stencil {global_ms:.4f} ms (median of 15 "
          "CUDA-event timings)", flush=True)
    del blocks, out, glob, x
    return worst, (ms, plain_ms, lib_ms, bound)


def dot_ext_level_times(dev, n: int = N_MAIN, forced=True) -> list:
    """``axis_stencil_dot`` at n^3, (n/2)^3 f32 (the MG-PCG and V(1,1) CG
    operators) and (n/4)^3 (the march's threshold) and ``axis_stencil_ext``
    on the ``N_DECOMP`` blocks of the n^3, (n/2)^3 and (n/4)^3 levels (the
    last below the threshold) in f32 and bf16 (one apply: a launch per
    block, each into its block's view of the level's result): per call
    (``_time_ms``) and on the device back to back (``_device_ms``), the
    shape's choice and, with ``forced``, the plane march and the per-point
    kernel each forced; a device copy of x and the bound beside them (the
    dot: read x, write A x; the ext: read every extended block, write the
    result). Each row's choice is first held to its plain version within
    ``REL_TOL`` (raises otherwise). Then where the rule takes the march
    and where the march is at or below the per-point kernel. Without
    ``forced`` only the wrappers' older signature is used (an older
    version under ``ab_cells_torch.py --root``)."""
    import torch

    from pyapes_tpu_torch.ops import axis_stencil as A
    from pyapes_tpu_torch.ops.stencil import apply_axis_stencil, apply_axis_stencil_dot
    from pyapes_tpu_torch.parallel import DomainDecomposition, halo

    dd = DomainDecomposition(N_DECOMP)
    ext = tuple(int(m > 1) for m in N_DECOMP)
    rows = []
    cases = [("axis_stencil_dot", m, "float32") for m in (n, n // 2, n // 4)]
    cases += [("axis_stencil_ext", m, dt) for m in (n, n // 2, n // 4)
              for dt in ("float32", "bfloat16")]
    for lvl, (name, m, dtname) in enumerate(cases):
        coeffs, x = _axis_inputs((1, m, m, m), (3, 3, 3), getattr(torch, dtname), dev, 980 + lvl)
        pts = x.numel()
        if name == "axis_stencil_dot":
            def call(march=None, coeffs=coeffs, x=x):
                kw = {} if march is None else {"march": march}
                return A.axis_stencil_dot(coeffs, x, **kw)[0]

            ref = apply_axis_stencil_dot(coeffs, x)[0]
            nbytes, ops = 2 * x.element_size() * pts, 19 * pts
            march_taken = forced and A.uses_march(x.shape)
        else:
            blocks = [(sl, halo.exchange(x, sl, ext, {}), halo._block_coeffs(coeffs, sl))
                      for _, sl in dd.blocks((m, m, m))]
            res = torch.empty_like(x)

            def call(march=None, blocks=blocks, res=res):
                kw = {} if march is None else {"march": march}
                for sl, xe, cs in blocks:
                    A.axis_stencil_ext(cs, xe, ext, out=res[(slice(None), *sl)], **kw)
                return res

            ref = apply_axis_stencil(coeffs, x)
            nbytes = (sum(xe.numel() for _, xe, _ in blocks) + pts) * x.element_size()
            ops = 17 * pts
            view = res[(slice(None), *blocks[0][0])]
            march_taken = forced and A.uses_march_ext(tuple(view.shape), view)
        err = (call().double() - ref.double()).abs().max().item()
        limit = REL_TOL[dtname] * ref.double().abs().max().item()
        if not err <= limit:
            raise RuntimeError(f"chip_smoke: {name} (the shape's choice) disagrees with its plain "
                               f"version at {m}^3 {dtname}: {err:.3e} > {limit:.3e}")
        del ref
        copy = torch.empty_like(x)
        row = {"kernel": name, "n": m, "dtype": dtname, "bound_ms": _bound(nbytes, ops)[0],
               "ms": _time_ms(call), "device_ms": _device_ms(call),
               "copy_device_ms": _device_ms(lambda: copy.copy_(x)), "march": march_taken,
               "err_over_limit": err / limit if limit > 0 else 0.0}
        if forced:
            for kern, march in FORCED_KERNELS:
                row[f"{kern}_ms"] = _time_ms(lambda: call(march))
                row[f"{kern}_device_ms"] = _device_ms(lambda: call(march))
        rows.append(row)
        del coeffs, x, copy, call
    print(f"[3 kernel] alpha-dot at {n}^3, {n // 2}^3 and {n // 4}^3 f32, halo-extended apply "
          f"on the {N_DECOMP} blocks of {n}^3, {n // 2}^3 and {n // 4}^3 in f32 and bf16 (8 "
          "launches per apply), ms "
          "per call (median of 15 CUDA-event timings) / device µs per call (30 back to back), "
          "the shape's choice (each within REL_TOL of the plain version, worst err/limit "
          f"{max(r['err_over_limit'] for r in rows):.3f})"
          + ("; the march and the per-point kernel forced" if forced else "")
          + "; a device copy of x: "
          + "; ".join(
              f"{r['kernel']} {r['n']}^3 {r['dtype']} {r['ms']:.4f} / "
              f"{1e3 * r['device_ms']:.2f} ({100 * r['bound_ms'] / r['device_ms']:.1f}% of "
              f"{1e3 * r['bound_ms']:.2f}; copy {1e3 * r['copy_device_ms']:.2f})"
              + (f" [march {r['march_ms']:.4f} / {1e3 * r['march_device_ms']:.2f}, per-point "
                 f"{r['point_ms']:.4f} / {1e3 * r['point_device_ms']:.2f}; chosen "
                 f"{'march' if r['march'] else 'per-point'}]" if forced else "")
              for r in rows), flush=True)
    if forced:
        other = [f"{r['kernel']} {r['n']}^3 {r['dtype']}" for r in rows
                 if (r["march_device_ms"] > r["point_device_ms"] if r["march"]
                     else r["point_device_ms"] > r["march_device_ms"])]
        print("[3 kernel] alpha-dot and halo-extended kernel choice: the march on 3-D grids "
              f"(blocks) of at least {A.MARCH_MIN_POINTS} points per component that no tile "
              "overhangs (uses_march, uses_march_ext: and an output view that takes pair stores); "
              f"on the device back to back here the kernel not chosen is faster at: "
              f"{', '.join(other) or 'no row'}", flush=True)
    return rows


def _true_residual(solver) -> float:
    """The TRUE relative residual ``|b - A x| / |b|`` of the solver's last
    equation over its active set, recomputed in f64 with the plain
    operators on the reduced torus of its periodic axes."""
    import numpy as np
    import torch

    from pyapes_tpu_torch.ops import stencil as P
    from pyapes_tpu_torch.solver.fdm import ddt_leading_coeff

    var = solver.var
    nd = var.mesh.dim
    per = [sum(bc.bc_type == "periodic" and bc.bc_face_dim == j for bc in var.bcs) == 2
           for j in range(nd)]
    red = (slice(None),) + tuple(slice(None, -1) if p else slice(None) for p in per)

    def vecs(cs_all):  # host vectors on the reduced torus, as f64 tensors
        out = []
        for j, cs in enumerate(cs_all):
            if per[j]:
                cs = [np.full(len(c) - 1, c[(len(c) - 1) // 2]) for c in cs]
            out.append(tuple(torch.as_tensor(np.asarray(c, np.float64), device=var().device)
                             for c in cs))
        return tuple(out)

    x, b = var()[red].double(), solver.rhs[red].double()
    ax = torch.zeros_like(x)
    for rec in solver.eqs.values():
        if rec["name"] == "Ddt":
            t = x * (ddt_leading_coeff(rec) / rec["dt"])
        elif rec.get("adv") is not None:
            o = rec["other"]
            surg = tuple(("none", "none") if per[j] else k for j, k in enumerate(o["surgery"]))
            adv = rec["adv"][red].double()
            if rec["name"] == "Conv":
                t = P.apply_conv_field(x, adv, vecs(o["base"]), rec["limiter"], surg)
            else:
                t = P.apply_div_field(x, adv, vecs(o["base"]), rec["limiter"], surg, o["form"])
        else:
            t = P.apply_axis_stencil(vecs(rec["axis_coeffs"]), x)
            if rec["name"] == "Laplacian" and rec["param"][0] is not None:
                t = t * float(rec["param"][0])
        ax = ax + rec["sign"] * t
    inner = (slice(None),) + tuple(slice(None) if p else slice(1, -1) for p in per)
    res, bn = (b - ax)[inner].norm().item(), b[inner].norm().item()
    return res / bn if bn > 0 else res  # a zero RHS (w of Taylor-Green): the absolute one


def _drive_steps(model, solver, n_steps: int, label: str, required: tuple) -> dict:
    """Step a model ``n_steps`` times through its public ``step``: wall per
    step (median after the first, warm-up, step), ``itr`` per solve,
    launches per step (every kernel in ``required`` in every step), peak
    memory over the steps after the first (the check's f64 temporaries left
    out) and what was allocated when that window opened, and each solve of
    the last step's true residual (recomputed after the step's wall is
    taken); every solve must converge."""
    import torch

    reports, residuals = [], []
    real_solve = solver.solve

    def solve():
        rep = real_solve()
        reports.append(dict(rep))
        if len(walls) == n_steps - 1:
            torch.cuda.synchronize()
            peak[0] = max(peak[0], torch.cuda.max_memory_allocated())
            tic = time.perf_counter()
            residuals.append(_true_residual(solver))
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - tic
            torch.cuda.reset_peak_memory_stats()
        return rep

    solver.solve = solve
    walls, per_step, spent, peak, start = [], [], [0.0], [0], 0
    torch.cuda.synchronize()
    for k in range(n_steps):
        if k == 1:
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.memory_allocated()
        before = _counts()
        tic = time.perf_counter()
        model.step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - tic - spent[0])
        after = _counts()
        per_step.append({name: after[name] - before[name] for name in after
                         if after[name] > before[name]})
    solver.solve = real_solve
    bad = [r for r in reports if not r["converge"]]
    if bad:
        raise RuntimeError(f"chip_smoke: {label}: a solve did not converge: {bad}")
    missing = [(k, name) for k, ls in enumerate(per_step) for name in required if not ls.get(name)]
    if missing:
        raise RuntimeError(f"chip_smoke: {label}: steps launched no {missing}: {per_step}")
    return {
        "path": label, "steps": n_steps, "wall_s": walls,
        "wall_s_per_step_median": statistics.median(walls[1:]),
        "itr": [r["itr"] for r in reports], "tol": [r["tol"] for r in reports],
        "launches_per_step": per_step,
        "peak_mem_gib": max(peak[0], torch.cuda.max_memory_allocated()) / 2**30,
        "mem_at_window_start_gib": start / 2**30, "true_rel_residual_f64_last_step": residuals,
    }


# the solves' criterion is BiCGSTAB's recursive residual (absolute, the
# models' "delta" criterion), which keeps falling past what an f32 iterate
# can hold; the true residual of the f32 solution is held to this bound
TRUE_RES_F32 = 1e-5


def _check_path(stats) -> None:
    worst = max(stats["true_rel_residual_f64_last_step"])
    if not worst <= TRUE_RES_F32:
        raise RuntimeError(f"chip_smoke: {stats['path']} true residual {worst:.3e} > "
                           f"{TRUE_RES_F32}")


class _Stepper:
    """``step()`` of a model at a fixed dt."""

    def __init__(self, model, dt):
        self.model, self.dt = model, dt

    def step(self):
        self.model.step(self.dt)


def burgers_model(dev, n: int = N_PATH, dtype: str = "single", config=None):
    """``BurgersND`` at (n+1)^3 f32 on the periodic box, Taylor-Green start,
    nu 0.1 (BiCGSTAB + the frozen diffusion+dt FD preconditioner, tol 1e-8,
    the model's defaults, ``config`` added: a decomposition): ``(stepper at
    dt 0.01, steps, kernels every step launches, label)``."""
    import torch

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import BurgersND
    from pyapes_tpu_torch.solver.linalg.dispatch import clear_cache

    mesh = Mesh(Box[0:2 * pi, 0:2 * pi, 0:2 * pi], None, [n + 1] * 3, device=str(dev),
                dtype=dtype)
    X, Y, Z = mesh.X, mesh.Y, mesh.Z
    init = [(torch.sin(X) * torch.cos(Y) * torch.cos(Z))[None],
            (-torch.cos(X) * torch.sin(Y) * torch.cos(Z))[None],
            torch.zeros((1, *mesh.nx), dtype=mesh.dtype.float, device=mesh.device)]
    clear_cache()  # the earlier phases' cached hierarchies and factors
    return (_Stepper(BurgersND(mesh, nu=0.1, init_vals=init, config=config), 0.01), 3,
            ("conv_component", "axis_stencil"),
            f"BurgersND {n + 1}^3 {'f32' if dtype == 'single' else 'f64'} Taylor-Green")


def phase_burgers(dev, n: int = N_PATH) -> dict:
    """``burgers_model``'s 3 steps of dt 0.01."""
    import torch

    stepper, steps, required, label = burgers_model(dev, n)
    model = stepper.model
    _reset_counts()
    stats = _drive_steps(stepper, model.solver, steps, label, required)
    counts = _counts()
    _check_path(stats)
    u = torch.cat([v() for v in model.vel])
    if not bool(u.isfinite().all()) or tuple(u.shape) != (3, n + 1, n + 1, n + 1):
        raise RuntimeError("chip_smoke: BurgersND velocity is not finite of shape (3, n^3)")
    print(f"[9 Burgers path] {json.dumps(stats)}", flush=True)
    return counts


def advdiff_model(dev, limiter: str, n: int = N_PATH, dtype: str = "single", config=None):
    """``AdvectionDiffusion`` at n^3 f32 on the unit box with homogeneous
    Dirichlet faces, eps = 0.01, a Gaussian blob: ``limiter`` "upwind"
    with the velocity field 1 + 0.5 sin 2πx sin 2πy sin 2πz (5 steps),
    "quick" with the constant velocity 1 (3 steps), ``config`` added to the
    model's solver (a decomposition); ``(stepper at dt 1e-3, steps, kernels
    every step launches, label)``."""
    import torch

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import AdvectionDiffusion
    from pyapes_tpu_torch.solver.linalg.dispatch import clear_cache
    from pyapes_tpu_torch.variables.bcs import homogeneous_bcs

    mesh = Mesh(Box[0:1, 0:1, 0:1], None, [n] * 3, device=str(dev), dtype=dtype)
    X, Y, Z = mesh.X, mesh.Y, mesh.Z
    blob = torch.exp(-((X - 0.5) ** 2 + (Y - 0.5) ** 2 + (Z - 0.5) ** 2) / (2 * 0.1**2))[None]
    if limiter == "upwind":
        velocity = (1.0 + 0.5 * torch.sin(2 * pi * X) * torch.sin(2 * pi * Y)
                    * torch.sin(2 * pi * Z))[None].contiguous()
        steps, required, what = 5, ("advect_pair", "axis_stencil"), "velocity field, upwind"
    else:
        velocity, steps, what = 1.0, 3, "constant velocity, QUICK"
        required = ("axis_stencil5", "axis_stencil")
    clear_cache()
    model = AdvectionDiffusion(mesh, homogeneous_bcs(3, 0.0, "dirichlet"), velocity=velocity,
                               epsilon=0.01, limiter=limiter, init_val=blob, config=config)
    return (_Stepper(model, 1e-3), steps, required,
            f"AdvectionDiffusion {n}^3 {'f32' if dtype == 'single' else 'f64'} {what}")


def phase_advdiff(dev, n: int = N_PATH) -> dict:
    """``advdiff_model``'s upwind (5 steps) and QUICK (3 steps) cases."""
    counts = {}
    for limiter in ("upwind", "quick"):
        stepper, steps, required, label = advdiff_model(dev, limiter, n)
        model = stepper.model
        _reset_counts()
        stats = _drive_steps(stepper, model.solver, steps, label, required)
        for name, c in _counts().items():
            counts[name] = counts.get(name, 0) + c
        _check_path(stats)
        phi = model.var()
        if not bool(phi.isfinite().all()) or tuple(phi.shape) != (1, n, n, n):
            raise RuntimeError(f"chip_smoke: {label}: phi is not finite of shape (1, n^3)")
        print(f"[9 advection-diffusion path] {json.dumps(stats)}", flush=True)
        del stepper, model, phi
    return counts


def phase_burgers_xonly(dev, n: int = N_PATH) -> None:
    """``BurgersND`` at (n+1)^3 f64 from an x-only field, the 1-D exact
    solution (nu = 0.25) broadcast along y and z, v = w = 0, 10 steps of dt
    0.01 (f64, as the JAX test: 1e-6 of y/z spread is ~2 f32 ulps of u ~ 4,
    below the rounding of an f32 eigen-transform):
    v and w stay below 1e-6, u y/z-independent to 1e-6, and u matches the
    1-D exact solution to a relative L2 error under 0.05 (and a max error
    under 1.2, the scheme's floor at the front) — the JAX package's gates
    (``tests/test_models.py:376-409``)."""
    import torch

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import BurgersND
    from pyapes_tpu_torch.testing.burgers import burger_exact_nd

    nu, dt, steps = 0.25, 0.01, 10
    mesh1 = Mesh(Box[0:2 * pi], None, [n + 1], device=str(dev), dtype="double")
    mesh = Mesh(Box[0:2 * pi, 0:2 * pi, 0:2 * pi], None, [n + 1] * 3, device=str(dev),
                dtype="double")
    u0 = burger_exact_nd(mesh1, nu, 0.0)[None, :, None, None].expand(1, n + 1, n + 1, n + 1)
    zero = torch.zeros((1, *mesh.nx))
    model = BurgersND(mesh, nu=nu, init_vals=[u0.contiguous(), zero, zero])
    tic = time.perf_counter()
    model.run(dt, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    u, v, w = (f()[0] for f in model.vel)
    vw = max(v.abs().max().item(), w.abs().max().item())
    spread = (u - u[:, :1, :1]).abs().max().item()
    exact = burger_exact_nd(mesh1, nu, dt * steps)
    err = u[:, 0, 0] - exact
    rel_l2 = (err.norm() / exact.norm()).item()
    out = {"steps": steps, "wall_s": wall, "max_abs_vw": vw, "max_yz_spread_u": spread,
           "rel_l2_vs_exact": rel_l2, "max_abs_err": err.abs().max().item(),
           "last_itr": model.report["itr"]}
    if not (vw < 1e-6 and spread < 1e-6 and rel_l2 < 0.05 and out["max_abs_err"] < 1.2):
        raise RuntimeError(f"chip_smoke: x-only Burgers {n + 1}^3 failed its gates: {out}")
    print(f"[9 Burgers x-only check] {n + 1}^3 f64 nu={nu}: {json.dumps(out)}", flush=True)


def _path_problem(dev, n, darcy=False, paxes=(), dtype: str = "single"):
    """The path cells' 3-D f32 (``dtype``) Poisson problem: the mesh, the
    all-Dirichlet field (``paxes`` periodic, n + 1 nodes each), the seeded
    random RHS and the coefficient (1, or with ``darcy`` ``bench_darcy``'s
    Γ field)."""
    import torch

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.variables import Field
    from pyapes_tpu_torch.variables.bcs import mixed_bcs

    nodes = [n + 1 if j in paxes else n for j in range(3)]
    kinds = [k for j in range(3) for k in ("periodic" if j in paxes else "dirichlet",) * 2]
    mesh = Mesh(Box[0:1, 0:1, 0:1], None, nodes, device=str(dev), dtype=dtype)
    var = Field("p", 1, mesh, {"domain": mixed_bcs([None if k == "periodic" else 0.0
                                                    for k in kinds], kinds),
                               "obstacle": None}, init_val=0.0)
    g = torch.Generator(device=mesh.device).manual_seed(0)
    rhs = torch.randn((1, *nodes), generator=g, device=mesh.device, dtype=mesh.dtype.float)
    coeff = 1.0
    if darcy:
        coeff = torch.exp(0.8 * torch.sin(2 * pi * mesh.X) * torch.sin(2 * pi * mesh.Y)
                          * torch.sin(2 * pi * mesh.Z)).contiguous()
    return mesh, var, rhs, coeff


def _plain_operator(mesh, var, coeff, darcy=False, paxes=()):
    """``plain_A(v, dtype)``: the path problem's operator, the PLAIN version,
    in ``dtype`` (on the reduced torus when ``paxes``)."""
    import torch

    from pyapes_tpu_torch.ops.stencil import (
        apply_axis_stencil,
        apply_diff_field,
        div_surgery_info,
        laplacian_axis_coeffs,
    )
    from pyapes_tpu_torch.solver.linalg.dispatch import _reduce_vecs
    from pyapes_tpu_torch.utils.carry import coeffs_from_numpy

    if darcy:
        inv = tuple(1.0 / float(d) ** 2 for d in mesh.dx_np)
        surg = div_surgery_info(var.bcs, 3)

        def plain_A(v, dtype):
            return apply_diff_field(v.to(dtype), coeff.to(dtype), inv, surg)
    else:
        c32 = coeffs_from_numpy(_reduce_vecs(laplacian_axis_coeffs(mesh, var.bcs), paxes),
                                mesh.device, torch.float32)

        def plain_A(v, dtype):
            return apply_axis_stencil(tuple(tuple(c.to(dtype) for c in cs) for cs in c32),
                                      v.to(dtype))
    return plain_A


def _true_residuals(mesh, var, rhs, coeff, x, darcy=False, paxes=()) -> tuple[float, float]:
    """The true relative residual of ``x``, recomputed with the PLAIN
    operator in f32 and in f64 (on the reduced torus: the duplicate seam
    planes dropped, every torus node active)."""
    import torch

    plain_A = _plain_operator(mesh, var, coeff, darcy, paxes)
    red = (slice(None),) + tuple(slice(None, -1) if j in paxes else slice(None) for j in range(3))
    inner = (slice(None),) + tuple(slice(None) if j in paxes else slice(1, -1) for j in range(3))
    xr, rr = x[red], rhs[red]
    res32 = ((rr - plain_A(xr, torch.float32))[inner].norm() / rr[inner].norm()).item()
    r64 = rr.double()
    res64 = ((r64 - plain_A(xr, torch.float64))[inner].norm() / r64[inner].norm()).item()
    return res32, res64


def _solve_path(dev, n, cfg, label, darcy=False, solves=3, paxes=()):
    """One warm-up and ``solves`` timed solves of the 3-D f32 all-Dirichlet
    random-RHS Poisson problem through the public API (with ``darcy``:
    ``bench_darcy``'s variable-Γ problem; with ``paxes``: those axes
    periodic, n + 1 nodes each, so the reduced torus is n^3); returns its
    stats (launches per timed solve included) and the solution."""
    import torch

    from pyapes_tpu_torch.solver.fdm import FDM
    from pyapes_tpu_torch.solver.ops import Solver

    tol = cfg["tol"]
    mesh, var, rhs, coeff = _path_problem(dev, n, darcy, paxes)
    nodes = list(mesh.nx)
    solver = Solver({"fdm": cfg})
    fdm = FDM()

    torch.cuda.synchronize()
    tic = time.perf_counter()
    solver.set_eq(fdm.laplacian(coeff, var) == rhs)
    solver.solve()
    torch.cuda.synchronize()
    first = time.perf_counter() - tic

    torch.cuda.reset_peak_memory_stats()
    walls, cpus, reports, per_solve = [], [], [], []
    for _ in range(solves):
        var.set_var_tensor(torch.zeros_like(var()))
        solver.set_eq(fdm.laplacian(coeff, var) == rhs)
        torch.cuda.synchronize()
        before = _counts()
        tic, ctic = time.perf_counter(), time.process_time()
        rep = solver.solve()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - tic)
        cpus.append(time.process_time() - ctic)
        after = _counts()
        per_solve.append({k: after[k] - before[k] for k in after})
        reports.append(rep)
        if not (rep["converge"] and rep["tol"] <= tol):
            raise RuntimeError(f"chip_smoke: {label} {n}^3 solve did not converge: {rep}")
    peak = torch.cuda.max_memory_allocated()

    x = var()
    res32, res64 = _true_residuals(mesh, var, rhs, coeff, x, darcy, paxes)
    med = statistics.median(walls)
    stats = {
        "path": label, "n": n, "nodes": nodes, "periodic_axes": list(paxes),
        "itr": [r["itr"] for r in reports],
        "tol": [r["tol"] for r in reports], "converge": [r["converge"] for r in reports],
        "first_call_s": first, "wall_s": walls, "wall_s_median": med,
        # the process's CPU time per solve: near the wall where the host
        # binds; a wall that grows without it is time the host was not ours
        "cpu_s": cpus,
        "dof_per_s": n**3 / med, "peak_mem_gib": peak / 2**30,
        "true_rel_residual_f32": res32, "true_rel_residual_f64": res64,
        "launches_per_solve": per_solve,
    }
    return stats, x


FD_TOL = 1e-6
# A decomposed fastdiag solve against the undecomposed one: the block
# kernel sums the same f32 products in the same order as the global one,
# so the two residuals differ by rounding only (below the 1e-6 tolerance
# of |b|), and the fastdiag inverse keeps a white residual's share of a
# white RHS's solution: max|dx| <= 1e-5 max|x|.
FD_DECOMP_AGREE = 1e-5


def fd_cfg(decomp=None) -> dict:
    """The fastdiag cells' solver config (``bench.py``'s Poisson problem)."""
    cfg = {"method": "fastdiag", "tol": FD_TOL, "max_it": 4000, "criterion": "residual"}
    return cfg if decomp is None else {**cfg, "decomp": decomp}


def mg_cfg(mg_opts: dict, decomp=None) -> dict:
    """The MG-PCG cells' solver config (``bench.py``'s cg method) with the
    cycle options ``mg_opts``."""
    cfg = {"method": "cg", "precond": "mg", "tol": 1e-6, "max_it": 200,
           "criterion": "residual", "donate": True, "mg_opts": mg_opts}
    return cfg if decomp is None else {**cfg, "decomp": decomp}


def phase_fastdiag(dev, n: int = N_MAIN):
    """The slice-1 main path: 512^3 fastdiag. Returns its launches, stats
    and solution."""
    _reset_counts()
    stats, x = _solve_path(dev, n, fd_cfg(), "fastdiag")
    counts = _counts()
    for rep_itr, ls in zip(stats["itr"], stats["launches_per_solve"]):
        if ls["axis_stencil"] < rep_itr + 1:
            raise RuntimeError("chip_smoke: the solve did not go through the stencil kernel")
    if not stats["true_rel_residual_f32"] <= FD_TOL:
        raise RuntimeError(f"chip_smoke: recomputed true residual "
                           f"{stats['true_rel_residual_f32']:.3e} > {FD_TOL}")
    print(f"[4 fastdiag path] {json.dumps(stats)}", flush=True)
    return {"axis_stencil": counts["axis_stencil"]}, stats, x.clone()


def phase_fastdiag_decomp(dev, ref_stats, ref_x, n: int = N_MAIN):
    """The slice-8 path: the same 512^3 fastdiag solve with a
    ``DomainDecomposition(N_DECOMP)``: the halo-extended kernel in every
    timed solve (once per block and residual), the undecomposed solve's
    passes, its solution to ``FD_DECOMP_AGREE``, the true residual
    recomputed in f64 within the tolerance; then the block-wise apply of
    the block-wise apply timed against the global kernel on the solution."""
    import torch

    from pyapes_tpu_torch.ops.axis_stencil import axis_stencil
    from pyapes_tpu_torch.parallel import DomainDecomposition, halo

    dd = DomainDecomposition(N_DECOMP)
    label = f"fastdiag {N_DECOMP}"
    _reset_counts()
    stats, x = _solve_path(dev, n, fd_cfg(dd), label)
    counts = _counts()
    for rep_itr, ls in zip(stats["itr"], stats["launches_per_solve"]):
        if ls["axis_stencil_ext"] < dd.n_devices * rep_itr:
            raise RuntimeError(f"chip_smoke: {label} did not go through the block kernel: {ls}")
    if stats["itr"] != ref_stats["itr"]:
        raise RuntimeError(f"chip_smoke: {label} took {stats['itr']} passes, the undecomposed "
                           f"solve {ref_stats['itr']}")
    agree = ((x - ref_x).abs().max() / ref_x.abs().max()).item()
    if not (agree <= FD_DECOMP_AGREE and stats["true_rel_residual_f64"] <= FD_TOL):
        raise RuntimeError(f"chip_smoke: {label}: max|dx|/max|x| = {agree:.3e} (limit "
                           f"{FD_DECOMP_AGREE}), true residual (f64) "
                           f"{stats['true_rel_residual_f64']:.3e} (limit {FD_TOL})")
    coeffs = tuple(tuple(torch.randn(n, device=dev) for _ in range(3)) for _ in range(3))
    apply = halo.make_sharded_apply(dd, 3)
    stats["max_rel_diff_vs_undecomposed"] = agree
    stats["blockwise_apply_ms"] = _time_ms(lambda: apply(coeffs, x))
    stats["global_apply_ms"] = _time_ms(lambda: axis_stencil(coeffs, x))
    print(f"[4b decomposed fastdiag path] {json.dumps(stats)}", flush=True)
    return {"axis_stencil_ext": counts["axis_stencil_ext"]}


def phase_mgpcg(dev, n: int, mg_opts: dict, required: tuple, label: str, decomp=None,
                paxes=()):
    """MG-PCG through ``Solver.solve`` with ``bench.py``'s cg settings (and
    ``decomp``; ``paxes`` periodic, the torus n^3); every kernel in
    ``required`` must launch in every timed solve. Returns its launches and
    stats."""
    _reset_counts()
    stats, _ = _solve_path(dev, n, mg_cfg(mg_opts, decomp), label, paxes=paxes)
    counts = _counts()
    for ls in stats["launches_per_solve"]:
        missing = [k for k in required if ls[k] == 0]
        if missing:
            raise RuntimeError(f"chip_smoke: {label} did not launch {missing}: {ls}")
    # the criterion is the RECURSIVE residual: hold the true one to 1e-5
    if not (stats["true_rel_residual_f32"] <= 1e-5 and stats["true_rel_residual_f64"] <= 1e-5):
        raise RuntimeError(f"chip_smoke: {label} true residual "
                           f"{stats['true_rel_residual_f32']:.3e} / "
                           f"{stats['true_rel_residual_f64']:.3e} > 1e-5")
    print(f"[{'13 periodic' if paxes else '5'} MG-PCG path] {json.dumps(stats)}", flush=True)
    return counts, stats


def darcy_cfg() -> dict:
    """The Darcy cell's solver config (``bench.py``'s ``bench_darcy``)."""
    return {"method": "cg", "precond": "mg", "tol": 1e-6, "max_it": 400,
            "criterion": "residual", "mg_opts": DARCY_MG}


def phase_darcy(dev, n: int = N_DARCY):
    """The variable-Γ path: ``bench_darcy``'s problem through
    ``Solver.solve`` (CG, Γ-aware MG, bf16 V(2,2), FMG); both variable-Γ
    kernels must launch in every timed solve."""
    _reset_counts()
    label = f"Darcy variable-Γ MG-PCG {n}^3 bf16 V(2,2) FMG"
    stats, x = _solve_path(dev, n, darcy_cfg(), label, darcy=True)
    counts = _counts()
    for ls in stats["launches_per_solve"]:
        wrong = {k: ls[k] for k, n in DARCY_LAUNCHES.items() if ls[k] != n}
        if wrong:
            raise RuntimeError(f"chip_smoke: {label} launched {wrong} per solve, not "
                               f"{DARCY_LAUNCHES}: {ls}")
    if not (stats["true_rel_residual_f32"] <= 1e-5 and stats["true_rel_residual_f64"] <= 1e-5):
        raise RuntimeError(f"chip_smoke: {label} true residual {stats['true_rel_residual_f32']:.3e}"
                           f" / {stats['true_rel_residual_f64']:.3e} > 1e-5")
    if not bool(x.isfinite().all()) or tuple(x.shape) != (1, n, n, n):
        raise RuntimeError(f"chip_smoke: {label} solution is not finite of shape (1, {n}^3)")
    print(f"[6 Darcy path] {json.dumps(stats)}", flush=True)
    return counts


def _poisson_model_error(n: int) -> tuple[float, float, dict]:
    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import PoissonSolver
    from pyapes_tpu_torch.testing.poisson import poisson_bcs, poisson_exact_nd, poisson_rhs_nd

    mesh = Mesh(Box[0:1, 0:1, 0:1], None, [n] * 3, device="cuda", dtype="double")
    model = PoissonSolver(mesh, poisson_bcs(3))
    model.solve(poisson_rhs_nd(mesh, model.var))
    if not model.report["converge"]:
        raise RuntimeError(f"chip_smoke: PoissonSolver {n}^3 did not converge: {model.report}")
    exact = poisson_exact_nd(mesh)
    rel = ((model.var()[0] - exact).abs().max() / exact.abs().max()).item()
    h = 1.0 / (n - 1)
    # the discrete operator's eigenvalue for sin(pi x)sin(pi y)sin(pi z)
    predicted = 3 * pi**2 / (3 * (4 / h**2) * sin(pi * h / 2) ** 2) - 1.0
    return rel, predicted, model.report


def _darcy_model(n: int, avg: str) -> dict:
    from pyapes_tpu_torch import runner

    out = runner.run(["darcy", "--n", str(n), "--avg", avg, "--dtype", "double",
                      "--device", "cuda"])
    q_in, q_out, k = out["flux_in"], out["flux_out"], out["k_eff"]
    if not out["report"]["converge"]:
        raise RuntimeError(f"chip_smoke: runner darcy {n}^2 did not converge: {out}")
    # the JAX runner demo's gates: 2% flux balance, the Wiener bounds
    if not abs(q_in - q_out) <= 0.02 * abs(q_in):
        raise RuntimeError(f"chip_smoke: runner darcy {n}^2 flux imbalance: {out}")
    if not out["k_harmonic"] - 1e-6 <= k <= out["k_arithmetic"] + 1e-6:
        raise RuntimeError(f"chip_smoke: runner darcy {n}^2 k_eff outside the Wiener bounds: {out}")
    return out


def phase_model():
    _reset_counts()
    out = {}
    for n in MODEL_SIZES:
        rel, predicted, rep = _poisson_model_error(n)
        if abs(rel / predicted - 1.0) > 0.05:
            raise RuntimeError(
                f"chip_smoke: PoissonSolver {n}^3 error {rel:.3e} is not the predicted "
                f"discretization error {predicted:.3e}"
            )
        out[n] = (rel, predicted, rep)
    ratio = out[65][0] / out[129][0]
    print(
        "[7 model] PoissonSolver f64: "
        + "; ".join(f"{n}^3 itr={r['itr']} tol={r['tol']:.2e} rel_err={e:.4e} "
                    f"(predicted {p:.4e})" for n, (e, p, r) in out.items())
        + f"; error ratio 65->129 = {ratio:.3f} (second order: ~4)",
        flush=True,
    )
    counts = _counts()
    if counts["axis_stencil"] == 0:
        raise RuntimeError("chip_smoke: the model path launched no axis-stencil kernel")
    # a 65^2 run of each face rule against the JAX package's numbers; the
    # path's own size, 1025^2 with harmonic faces, with its launch counts
    for avg, k_ref in DARCY65_K_EFF.items():
        small = _darcy_model(65, avg)
        if not abs(small["k_eff"] - k_ref) <= 1e-9 * k_ref:
            raise RuntimeError(f"chip_smoke: runner darcy 65^2 {avg} k_eff {small['k_eff']!r} "
                               f"differs from the JAX package's {k_ref!r}")
    _reset_counts()
    big = _darcy_model(1025, "harmonic")
    dcounts = _counts()
    if dcounts["diff_field"] == 0 or dcounts["diff_jacobi"] == 0:
        raise RuntimeError(f"chip_smoke: the Darcy model launched no variable-Γ kernel: {dcounts}")
    print(f"[7 model] runner darcy 65^2 f64 k_eff matches the JAX package (arithmetic, "
          f"harmonic); 1025^2 f64 harmonic: {json.dumps(big)}", flush=True)
    return {"axis_stencil": counts["axis_stencil"], "diff_field": dcounts["diff_field"],
            "diff_jacobi": dcounts["diff_jacobi"]}


# the NS cavity: bench.py's PYAPES_BENCH_CASE=cavity cell (3-D lid-driven
# cavity, Re = 100, regularized lid, dt = 0.25 / n, f32) at 128^3 and the
# 256^3 scale rung, and the 128^3 cell in f64, eager (2 warm steps, then 5
# timed steps three times). In f32 the model's tolerances (momentum 1e-8,
# pressure 1e-5) lie below the f32 floor of a true residual (the stencil's
# cancellation on a smooth field, ~eps n^2 / pi^2: 1.3e-5 for the pressure
# at 64^3 on the CPU), so a fastdiag solve there ends at its stall exit
# with converge false; in f64 every solve must converge
CAVITY_CELLS = ((128, "single"), (256, "single"), (128, "double"))
CAVITY_WARM, CAVITY_STEPS, CAVITY_REPS = 2, 5, 3
N_CAVITY_CMP = 33  # the card against the CPU, f64
CAVITY_CMP_TOL = 1e-10


def cavity_model(dev, n: int = 128, implicit: bool = False, dtype: str = "single"):
    """``bench.py``'s cavity cell: ``LidDrivenCavity`` on the unit cube at
    n^3, nu 0.01, the regularized unit lid, the model's default solves
    (fastdiag momentum and pressure; ``implicit``: BiCGSTAB with the FD
    preconditioner through the convection kernel), the default ``sync``
    (phase 14 steps it fused too); ``(stepper at dt 0.25/n, kernels
    every step launches, label)``."""
    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import LidDrivenCavity
    from pyapes_tpu_torch.solver.linalg.dispatch import clear_cache

    clear_cache()
    mesh = Mesh(Box[0:1, 0:1, 0:1], None, [n] * 3, device=str(dev), dtype=dtype)
    model = LidDrivenCavity(mesh, nu=0.01, lid_velocity=1.0, lid_profile="regularized",
                            implicit_advection=implicit)
    required = ("conv_component", "axis_stencil") if implicit else ("axis_stencil",)
    what = "implicit advection" if implicit else "explicit advection"
    return _Stepper(model, 0.25 / n), required, f"NS cavity {n}^3 {dtype} {what}"


def _record_solves(model) -> list:
    """Every solve's report of the model, in order, appended to the list
    returned, each with its solver's ``max_it``."""
    reports = []
    for solver in (model.mom_solver, model.p_solver):
        real, max_it = solver.solve, int(solver.config["fdm"]["max_it"])

        def solve(real=real, max_it=max_it):
            rep = real()
            reports.append({**rep, "max_it": max_it})
            return rep

        solver.solve = solve
    return reports


def _divergence(model) -> dict:
    """max|div u| over the grid and the mean |div u| of the bulk (two
    layers at every wall excluded, the JAX model test's measure)."""
    div = model.divergence().abs()
    bulk = div[(slice(2, -2),) * model.mesh.dim]
    return {"max_abs_div": div.max().item(), "bulk_mean_abs_div": bulk.mean().item()}


def _run_cell(stepper, required: tuple, label: str, warm: int, steps: int, reps: int,
              must_converge: bool) -> dict:
    """``warm`` steps of a flow model's ``stepper``, then ``reps`` times
    ``steps`` steps, each run ended by ``torch.cuda.synchronize()``: wall
    per step (the median run), itr and tol per solve, the solves that did
    not converge, the Hopper kernels' launches per step, peak memory of the
    timed runs and the divergence after them. No solve may reach its
    ``max_it``; with ``must_converge`` every solve must converge (in f32 a
    fastdiag solve may end at its stall exit, the f32 floor, and is
    listed); every step must launch the kernels in ``required``."""
    import torch

    model = stepper.model
    reports = _record_solves(model)
    for _ in range(warm):
        stepper.step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_warm_solves = len(reports)
    walls, per_step = [], []
    for _ in range(reps):
        tic = time.perf_counter()
        for _ in range(steps):
            before = _counts()
            stepper.step()
            after = _counts()
            per_step.append({k: after[k] - before[k] for k in after if after[k] > before[k]})
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - tic) / steps)
    peak = torch.cuda.max_memory_allocated() / 2**30
    unconverged = [(k, r["itr"], r["tol"]) for k, r in enumerate(reports) if not r["converge"]]
    bad = [r for r in reports if r["itr"] >= r["max_it"] or not r["tol"] == r["tol"]]
    if bad or (must_converge and unconverged):
        raise RuntimeError(f"chip_smoke: {label}: solves at max_it or not converged: "
                           f"{(bad or unconverged)[:3]}")
    missing = [(k, name) for k, ls in enumerate(per_step) for name in required if not ls.get(name)]
    if missing:
        raise RuntimeError(f"chip_smoke: {label}: steps launched no {missing[:3]}")
    u = torch.cat([v() for v in model.vel])
    if not bool(u.isfinite().all()) or not bool(model.p().isfinite().all()):
        raise RuntimeError(f"chip_smoke: {label}: the velocity or pressure is not finite")
    per_solve = len(model.vel) + 1
    timed = reports[n_warm_solves:]
    return {
        "path": label, "dt": stepper.dt, "warm_steps": warm, "steps": steps,
        "wall_s_per_step_runs": walls, "wall_s_per_step_median": statistics.median(walls),
        "itr_per_step_timed": [[r["itr"] for r in timed[k:k + per_solve]]
                               for k in range(0, len(timed), per_solve)],
        "tol_last_step": [r["tol"] for r in reports[-per_solve:]],
        "solves": len(reports), "unconverged_solves": len(unconverged),
        "unconverged_max_tol": max((t for _, _, t in unconverged), default=None),
        "unconverged_first_solve_itr_tol": unconverged[:4],
        "hopper_launches_per_step": (per_step[0] if all(ls == per_step[0] for ls in per_step)
                                     else per_step),
        "peak_mem_gib_timed": peak, **_divergence(model), "t": model.t,
    }


def run_cavity_cell(dev, n: int, implicit: bool = False, warm: int = CAVITY_WARM,
                    steps: int = CAVITY_STEPS, reps: int = CAVITY_REPS,
                    dtype: str = "single") -> dict:
    """The cavity cell through ``_run_cell`` (in f64 every solve must
    converge), with bench's ``ns_cavity3d_cell_steps_per_s_chip_eager``."""
    stepper, required, label = cavity_model(dev, n, implicit, dtype)
    stats = _run_cell(stepper, required, label, warm, steps, reps, dtype == "double")
    return {**stats, "n": n,
            "ns_cavity3d_cell_steps_per_s_chip_eager": n**3 / stats["wall_s_per_step_median"],
            "sync": "default (the port raises on sync: False)"}


def _cavity_cmp_run(dev, kind: str, n: int, steps: int):
    """``steps`` steps on ``dev`` in f64 of the cavity (``kind`` "cavity":
    n^3, ``cavity_model``'s set-up) or of ``NaturalConvection`` (n^2, Ra
    1e3, dt 0.0125): ``(itr per solve, state fields on the host)``."""
    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import NaturalConvection

    if kind == "cavity":
        stepper = cavity_model(dev, n, dtype="double")[0]
        model, dt = stepper.model, stepper.dt
    else:
        mesh = Mesh(Box[0:1, 0:1], None, [n, n], device=str(dev), dtype="double")
        model, dt = NaturalConvection(mesh, ra=1e3, pr=0.71), 0.0125
    reports = _record_solves(model)
    model.run(dt, steps)
    return [r["itr"] for r in reports], [f().cpu() for f in model.state_fields()]


def _card_vs_cpu(dev, run, kind: str, tol: float) -> tuple:
    """``run(device) -> (itr per solve, state fields on the host)`` on the
    CPU and on the card: the same itr solve by solve and the fields within
    ``tol`` relative to each field's max, else raise. Returns (itr, the
    largest relative difference)."""
    import torch

    cpu_itr, cpu_f = run(torch.device("cpu"))
    card_itr, card_f = run(dev)
    rel = max(((a - b).abs().max() / a.abs().max().clamp_min(1e-30)).item()
              for a, b in zip(cpu_f, card_f))
    if card_itr != cpu_itr or not rel <= tol:
        raise RuntimeError(f"chip_smoke: the {kind} on the card differs from the CPU run: itr "
                           f"{card_itr} vs {cpu_itr}, max rel diff {rel:.3e}")
    return card_itr, rel


def _cavity_gates(dev) -> dict:
    """The JAX model tests' physical gates on the card (f64, eager):
    ``test_lid_driven_cavity`` (33^2, 150 steps of 0.02) and
    ``test_natural_convection_davis_ra1e3`` (33^2, 60 steps of 0.0125)."""
    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import LidDrivenCavity, NaturalConvection

    mesh = Mesh(Box[0:1, 0:1], None, [33, 33], device=str(dev), dtype="double")
    model = LidDrivenCavity(mesh, nu=0.01, lid_velocity=1.0)
    model.run(0.02, 150)
    u, v = model.u()[0].cpu(), model.v()[0].cpu()
    mid = u.shape[0] // 2
    div = model.divergence()[2:-2, 2:-2].abs().mean().item()
    cav = {"u_mid_min": u[mid, :].min().item(), "v_mid_max": v[:, mid].max().item(),
           "v_mid_min": v[:, mid].min().item(), "bulk_mean_abs_div": div,
           "lid_max_err": (u[1:-1, -1] - 1.0).abs().max().item(),
           "bottom_max_abs": u[:, 0].abs().max().item()}
    if not (cav["u_mid_min"] < -0.05 and cav["v_mid_max"] > 0.02 and cav["v_mid_min"] < -0.02
            and div < 0.05 and cav["lid_max_err"] <= 1e-12 and cav["bottom_max_abs"] <= 1e-12):
        raise RuntimeError(f"chip_smoke: the 33^2 cavity failed the JAX test's gates: {cav}")
    mesh = Mesh(Box[0:1, 0:1], None, [33, 33], device=str(dev), dtype="double")
    nc = NaturalConvection(mesh, ra=1e3, pr=0.71)
    nc.run(0.0125, 60)
    T, vv = nc.T()[0].cpu(), nc.v()[0].cpu()
    conv = {"nusselt_hot_wall": nc.nusselt_hot_wall(), "v_max": vv.max().item(),
            "v_min": vv.min().item(), "T_max": T.max().item(), "T_min": T.min().item()}
    if not (abs(conv["nusselt_hot_wall"] - 1.118) < 0.03 * 1.118 and conv["v_max"] > 0.5
            and conv["v_min"] < -0.5 and conv["T_max"] <= 1.0 + 1e-8 and conv["T_min"] >= -1e-8):
        raise RuntimeError(f"chip_smoke: the Ra 1e3 convection failed the JAX test's gates: {conv}")
    return {"cavity_33x33_150_steps": cav, "convection_ra1e3_33x33_60_steps": conv}


def phase_cavity(dev) -> dict:
    """The NS cavity: bench's cell at 128^3 and 256^3 (f32) and at 128^3
    in f64, and the implicit-advection cavity at 128^3 (3 steps), each with
    the launch
    counts set to 0 just before and read just after; then the card
    against the CPU (33^3 cavity, 10 steps; 33^2 convection, 3 steps: the
    same itr solve by solve, the fields within ``CAVITY_CMP_TOL``) and the
    JAX model tests' gates. Returns the cells' launch counts."""
    import torch

    counts = {}
    cells = [(n, dt, False, CAVITY_WARM, CAVITY_STEPS, CAVITY_REPS) for n, dt in CAVITY_CELLS]
    cells.append((CAVITY_CELLS[0][0], "single", True, 0, 3, 1))
    for n, dtype, implicit, warm, steps, reps in cells:
        _reset_counts()
        stats = run_cavity_cell(dev, n, implicit, warm, steps, reps, dtype)
        for name, c in _counts().items():
            counts[name] = counts.get(name, 0) + c
        print(f"[10 NS cavity] {json.dumps(stats)}", flush=True)
        torch.cuda.empty_cache()
    cmp = {}
    for kind, steps in (("cavity", 10), ("convection", 3)):
        itr, rel = _card_vs_cpu(dev, lambda d: _cavity_cmp_run(d, kind, N_CAVITY_CMP, steps),
                                kind, CAVITY_CMP_TOL)
        cmp[kind] = {"n": N_CAVITY_CMP, "steps": steps, "itr": itr, "max_rel_diff": rel}
    print(f"[10 NS cavity] card against CPU, f64 (tolerance {CAVITY_CMP_TOL}): "
          f"{json.dumps(cmp)}", flush=True)
    print(f"[10 NS cavity] the JAX model tests' gates on the card, f64: "
          f"{json.dumps(_cavity_gates(dev))}", flush=True)
    return counts


# the rz / RFP path: bench.py's PYAPES_BENCH_CASE=rz cell (bench_rz): a
# Cylinder[0:4, -4:4] velocity mesh of 512 x 1024 nodes in f32, the
# Rosenbluth potentials H and G of f0 = exp(-(R^2 + Z^2)/2) / (2 pi)^1.5
# (RosenbluthPotentials' default config: the port resolves it to fastdiag,
# tol 1e-8 on the true residual), then 5 implicit RFP steps of dt 1e-3
# (BiCGSTAB, tol 1e-9 on the recursive residual, the FD preconditioner of
# the frozen separable diffusion surrogate); one warm-up then RZ_REPS
# timed runs. Bench's tolerances lie below the f32 floor: a solve that
# ends unconverged or at max_it is listed with its true residual, not
# failed
RZ_CELL = (512, 1024)
RZ_BOUNDS = ((0.0, 4.0), (-4.0, 4.0))
RZ_STEPS, RZ_DT, RZ_REPS = 5, 1e-3, 3
RZ_POT_TOL, RZ_STEP_TOL, RZ_MAX_IT = 1e-8, 1e-9, 2000  # the models' own settings
RZ_SHARED = {"method": "bicgstab", "precond": "mg"}  # the JAX package's resolution
RZ_CMP_TOL = 1e-10  # the card against the CPU, f64, relative to max|field|
# the row march's rows per thread forced in the 2-D checks (with the
# shape's choice): the longest of 1, 2, 4, 8 not above each
ROW_CHUNKS = (1, 2, 4, 8)


def rz_mesh(dev, nr: int, nz: int, dtype: str = "single", bounds=RZ_BOUNDS):
    from pyapes_tpu_torch.geometry import Cylinder
    from pyapes_tpu_torch.mesh import Mesh

    (r0, r1), (z0, z1) = bounds
    return Mesh(Cylinder[r0:r1, z0:z1], None, [nr, nz], device=str(dev), dtype=dtype)


def _rz_potential_bcs():
    """The potentials' faces: the symmetry axis at r = 0, Dirichlet on the
    other three (``RosenbluthPotentials``)."""
    from pyapes_tpu_torch.variables.bcs import CylinderBoundary

    return CylinderBoundary(rl={"bc_type": "symmetry", "bc_val": None},
                            ru={"bc_type": "dirichlet", "bc_val": 0.0},
                            zl={"bc_type": "dirichlet", "bc_val": 0.0},
                            zu={"bc_type": "dirichlet", "bc_val": 0.0})()


def _rz_operators(dev, dtname: str, cell=RZ_CELL) -> list:
    """(label, coeffs, shape) of every rz operator the path applies through
    the axis stencil, in ``dtname``: the fine Laplacian with the
    potentials' faces (r = 0 symmetry surgery, Dirichlet at ru and on z),
    the same with no faces (the raw r = 0 row, ``nan_to_num(dr / 2r)`` =
    0), and every level of the rz V-cycle of the shared config."""
    import torch

    from pyapes_tpu_torch.ops.stencil import laplacian_axis_coeffs
    from pyapes_tpu_torch.solver.multigrid import MGSpec
    from pyapes_tpu_torch.utils.carry import coeffs_from_numpy
    from pyapes_tpu_torch.variables import Field

    dtype = getattr(torch, dtname)
    mesh = rz_mesh(dev, *cell, "double" if dtname == "float64" else "single")
    var = Field("h", 1, mesh, {"domain": _rz_potential_bcs()})
    ops = [(f"fine {cell} faces", laplacian_axis_coeffs(mesh, var.bcs), cell),
           (f"fine {cell} no faces", laplacian_axis_coeffs(mesh, None), cell)]
    ops = [(lbl, coeffs_from_numpy(c, dev, dtype), shp) for lbl, c, shp in ops]
    spec = MGSpec(cell, [float(l) for l in mesh._lx_np], rz=True, r_lower=0.0,
                  face_kinds=(("neumann", "dirichlet"), ("dirichlet", "dirichlet")),
                  dtype=dtype, device=dev)
    ops += [(f"MG level {shp}", spec._level_coeffs(shp), shp) for shp in spec.shapes]
    return ops


def _check_2d(label: str, coeffs, x) -> float:
    """The 2-D apply of one operator: the shape's choice (twice), the
    per-point kernel and the row march at ``ROW_CHUNKS`` rows per thread,
    each forced, all the same bits and within ``REL_TOL`` of
    ``apply_axis_stencil``, or raises. Returns the worst abs error."""
    import torch

    from pyapes_tpu_torch.ops.axis_stencil import axis_stencil
    from pyapes_tpu_torch.ops.stencil import apply_axis_stencil

    dtname = str(x.dtype).split(".")[1]
    ref = apply_axis_stencil(coeffs, x)
    got = axis_stencil(coeffs, x)
    same = [axis_stencil(coeffs, x), axis_stencil(coeffs, x, march=False)]
    same += [axis_stencil(coeffs, x, march=True, chunk=c) for c in ROW_CHUNKS]
    torch.cuda.synchronize()
    limit = REL_TOL[dtname] * ref.double().abs().max().item()
    err = (got.double() - ref.double()).abs().max().item()
    if got.dtype != ref.dtype or not err <= limit or not all(torch.equal(got, o) for o in same):
        raise RuntimeError(f"chip_smoke: axis_stencil on the {label} {dtname} disagrees with its "
                           f"plain version ({err:.3e} > {limit:.3e}) or the row march gave other "
                           "bits than the per-point kernel, another chunk or another call")
    return err


def _time_2d(coeffs, x) -> dict:
    """One 2-D operator timed per call (``_time_ms``) and back to back on
    the device (``_device_ms``): the shape's choice (``ms``, ``device_ms``;
    ``kernel``: which), the row march and the per-point kernel each forced,
    the plain version, the CSR product of the same operator (``torch.mv``)
    and a device copy of x, beside the bound (x read and out written once;
    6 products and 5 sums per point at the f32 rate: f64 has no row in the
    guide's table, and the bytes bound it anyway)."""
    import torch

    from pyapes_tpu_torch.ops.axis_stencil import axis_stencil, uses_row_march
    from pyapes_tpu_torch.ops.stencil import apply_axis_stencil

    ref = apply_axis_stencil(coeffs, x)
    copy = torch.empty_like(x)
    bound_ms, bound_by = _bound(2 * x.element_size() * x.numel(), 11 * x.numel())
    row = {"shape": tuple(x.shape[1:]), "dtype": str(x.dtype).split(".")[1],
           "kernel": "row march" if uses_row_march(x.shape) else "per-point"}
    for key, march in (("", None), ("row_", True), ("point_", False)):
        row[f"{key}ms"] = _time_ms(lambda: axis_stencil(coeffs, x, march=march))
        row[f"{key}device_ms"] = _device_ms(lambda: axis_stencil(coeffs, x, march=march))
    return {**row, "plain_ms": _time_ms(lambda: apply_axis_stencil(coeffs, x)),
            "library_ms": _library_stencil_ms(coeffs, x, ref),
            "copy_device_ms": _device_ms(lambda: copy.copy_(x)),
            "bound_ms": bound_ms, "bound_by": bound_by}


def _print_2d(label: str, row: dict) -> None:
    print(f"[3 kernel] axis stencil 2-D {label} {row['shape']} {row['dtype']} time, ms per call / "
          f"back to back on the device: the shape's choice ({row['kernel']}) {row['ms']:.4f} / "
          f"{row['device_ms']:.4f}; the row march {row['row_ms']:.4f} / "
          f"{row['row_device_ms']:.4f}; the per-point kernel {row['point_ms']:.4f} / "
          f"{row['point_device_ms']:.4f}; plain {row['plain_ms']:.4f}, CSR product (torch.mv) "
          f"{row['library_ms']:.4f}, device copy {row['copy_device_ms']:.4f}, bound "
          f"{row['bound_ms']:.5f} ({row['bound_by']}); per call the shape's choice "
          f"{'beats' if row['ms'] < row['library_ms'] else 'does not beat'} the CSR product",
          flush=True)


def check_axis_rz(dev, cell=RZ_CELL) -> tuple:
    """The 2-D ``axis_stencil`` on the rz vectors (``_rz_operators``) in
    bf16, f32 and f64: the row march the same bits as the per-point kernel
    and within ``REL_TOL`` of ``apply_axis_stencil`` (``_check_2d``); then
    the fine operator at the cell in f32 timed (``_time_2d``). Returns
    (worst abs error, timing row)."""
    import torch

    worst, n_cases = 0.0, 0
    for dtname in ("bfloat16", "float32", "float64"):
        for seed, (label, coeffs, shape) in enumerate(_rz_operators(dev, dtname, cell)):
            g = torch.Generator(device=dev).manual_seed(1100 + seed)
            x = torch.randn((1, *shape), generator=g, device=dev,
                            dtype=torch.float64 if dtname == "float64" else torch.float32)
            x = x.to(getattr(torch, dtname))
            worst = max(worst, _check_2d(f"rz {label}", coeffs, x))
            n_cases += 1
    print(f"[3 kernel] axis stencil 2-D rz: {n_cases} cases hold (the fine {cell} operator with "
          "and without faces, every rz MG level, bf16/f32/f64; the row march the per-point "
          f"kernel's bits at chunks {ROW_CHUNKS} and the shape's, on another call too)",
          flush=True)
    coeffs = _rz_operators(dev, "float32", cell)[0][1]
    g = torch.Generator(device=dev).manual_seed(1099)
    x = torch.randn((1, *cell), generator=g, device=dev, dtype=torch.float32)
    row = {**_time_2d(coeffs, x), "max_abs_err": worst}
    _print_2d("rz", row)
    return worst, row


def _rz_f0(mesh):
    import torch

    return torch.exp(-(mesh.R**2 + mesh.Z**2) / 2.0) / (2 * pi) ** 1.5


def _step_true_residual(model, f_old, f_new, dt: float) -> float:
    """The true relative residual of one implicit RFP step, recomputed in
    f64 with the plain operators: ``|f_old/dt - (f_new/dt + Fr f_new - Di
    f_new)| / |f_old/dt|`` over the grid (the pdf has no faces: every node
    is active)."""
    import torch

    from pyapes_tpu_torch.solver.rfp import diffusion_apply, friction_apply

    mesh = model.mesh
    m64 = rz_mesh(mesh.device, *mesh.nx, "double",
                  tuple(zip(mesh._lower_np.tolist(), mesh._upper_np.tolist())))
    d = {k: v.double() for k, v in (("hr", model.jacH.r), ("hz", model.jacH.z),
                                   ("rr", model.hessG.rr), ("rz", model.hessG.rz),
                                   ("zz", model.hessG.zz))}
    x, b = f_new[0].double(), f_old[0].double() / dt
    ax = x / dt + friction_apply(d["hr"], d["hz"], x, m64) - diffusion_apply(
        d["rr"], d["rz"], d["zz"], x, m64)
    return ((b - ax).norm() / b.norm()).item()


def _count_syncs(fn) -> int:
    """Host syncs of ``fn()``: the synchronizing CUDA operations (reads to
    the host, blocking copies from it) that torch's sync debug mode
    reports."""
    import warnings

    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


class RzCell:
    """bench's rz cell (``bench_rz``) on ``dev``: ``step()`` is one run
    (the potentials of the current pdf, a new ``RFPEvolution(mesh, H, G)``,
    ``steps`` x ``step_implicit(pdf, RZ_DT)``, ended by ``float(sum(pdf))``);
    ``reset()`` puts the pdf back to f0. ``model`` is the last run's
    ``RFPEvolution``, ``reports`` its solves' reports (H, G, the steps);
    with ``record`` a run also recomputes each solve's true residual in
    f64 (``residuals``)."""

    def __init__(self, dev, nr: int, nz: int, steps: int = RZ_STEPS):
        from pyapes_tpu_torch.models import RosenbluthPotentials
        from pyapes_tpu_torch.variables import Field

        self.mesh = rz_mesh(dev, nr, nz)
        self.f0 = _rz_f0(self.mesh)
        self.pots = RosenbluthPotentials(self.mesh, self.f0)
        self.pdf = Field("pdf", 1, self.mesh, None).set_var_tensor(self.f0[None])
        self.steps, self.model, self.reports, self.residuals = steps, None, [], []

    def reset(self) -> None:
        self.pdf.set_var_tensor(self.f0[None])

    def step(self, record: bool = False) -> float:
        import torch

        from pyapes_tpu_torch.models import RFPEvolution

        H, G = self.pots.solve(self.pdf())
        self.model = RFPEvolution(self.mesh, H, G)
        self.reports = [dict(r) for r in self.pots.reports]
        self.residuals = ([_true_residual(self.pots._solver_h),
                           _true_residual(self.pots._solver_g)] if record else [])
        for _ in range(self.steps):
            f_old = self.pdf().clone() if record else None
            self.model.step_implicit(self.pdf, RZ_DT)
            self.reports.append(dict(self.model.report))
            if record:
                self.residuals.append(_step_true_residual(self.model, f_old, self.pdf(), RZ_DT))
        return float(torch.sum(self.pdf()))


def run_rz_cell(dev, cell=RZ_CELL, reps: int = RZ_REPS, steps: int = RZ_STEPS) -> dict:
    """bench's rz cell (``bench_rz``) through the public API: the
    potentials, a fresh ``RFPEvolution(mesh, H, G)`` and ``steps`` x
    ``step_implicit(pdf, RZ_DT)`` per run, ended by ``float(sum(pdf))``;
    one warm-up run (the first call), ``reps`` timed runs (the wall, the
    process's CPU time, ``rfp_rz_dof_per_s_chip`` = nr nz (2 + steps) /
    wall of the fastest run, as bench reports it), then one run with the
    host syncs counted (not timed). Per run: itr, tol and converge of
    every solve, the solves at max_it, the true residuals (the potentials'
    recomputed with the plain rz Laplacian in f64, each step's with the
    plain RFP operators in f64), the axis-stencil launches, and the
    density drift (``volume_integral``)."""
    import torch

    nr, nz = cell
    rz = RzCell(dev, nr, nz, steps)
    den0 = rz.pdf.volume_integral()[0].item()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    rz.step()
    torch.cuda.synchronize()
    first = time.perf_counter() - tic
    torch.cuda.reset_peak_memory_stats()
    walls, cpus, runs = [], [], []
    for _ in range(reps):
        rz.reset()
        before = _counts()
        torch.cuda.synchronize()
        tic, ctic = time.perf_counter(), time.process_time()
        rz.step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - tic)
        cpus.append(time.process_time() - ctic)
        after = _counts()
        runs.append({"itr": [r["itr"] for r in rz.reports],
                     "converge": [r["converge"] for r in rz.reports],
                     "launches": {k: after[k] - before[k] for k in after if after[k] > before[k]}})
    peak = torch.cuda.max_memory_allocated() / 2**30
    drift = abs(rz.pdf.volume_integral()[0].item() - den0) / den0
    rz.reset()
    syncs = _count_syncs(rz.step)
    rz.reset()
    rz.step(record=True)  # the true residuals, after the timed runs
    labels = ["H", "G"] + [f"step {k + 1}" for k in range(steps)]
    tols = [RZ_POT_TOL] * 2 + [RZ_STEP_TOL] * steps
    if not bool(rz.pdf().isfinite().all()):
        raise RuntimeError("chip_smoke: the rz cell's pdf is not finite")
    if any(not (r["tol"] == r["tol"]) for r in rz.reports):
        raise RuntimeError(f"chip_smoke: a NaN tolerance in the rz cell: {rz.reports}")
    for ls in runs:
        if not ls["launches"].get("axis_stencil"):
            raise RuntimeError(f"chip_smoke: an rz run launched no axis stencil: {ls}")
    wall = min(walls)
    return {
        "path": f"rz/RFP {nr}x{nz} f32 (bench_rz)", "nr": nr, "nz": nz, "steps": steps,
        "dt": RZ_DT, "first_call_s": first, "wall_s": walls, "wall_s_min": wall,
        "wall_s_median": statistics.median(walls), "cpu_s": cpus,
        "rfp_rz_dof_per_s_chip": nr * nz * (2 + steps) / wall,
        "solves": labels, "runs": runs,
        "tol_last_run": [r["tol"] for r in rz.reports],
        "solves_at_max_it": [lbl for lbl, r in zip(labels, rz.reports) if r["itr"] >= RZ_MAX_IT],
        "solves_above_their_tol": [lbl for lbl, r, t in zip(labels, rz.reports, tols)
                                   if r["tol"] > t],
        "true_rel_residual_f64": dict(zip(labels, rz.residuals)),
        "host_syncs_per_run": syncs, "peak_mem_gib_timed": peak,
        "density_drift_per_run": drift,
    }


def run_rz_potentials_shared(dev, cell=RZ_CELL) -> dict:
    """The potentials at the cell under the config both packages resolve
    alike (BiCGSTAB with the rz V-cycle): one warm-up, one timed solve of
    H and G; itr, tol, converge, the true residuals in f64 and the
    axis-stencil launches (the kernel applies every level)."""
    import torch

    from pyapes_tpu_torch.models import RosenbluthPotentials

    mesh = rz_mesh(dev, *cell)
    f0 = _rz_f0(mesh)
    pots = RosenbluthPotentials(mesh, f0, RZ_SHARED)
    pots.solve(f0)
    torch.cuda.synchronize()
    before = _counts()
    tic = time.perf_counter()
    pots.solve(f0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    after = _counts()
    reps = [dict(r) for r in pots.reports]
    launches = {k: after[k] - before[k] for k in after if after[k] > before[k]}
    if not launches.get("axis_stencil") or any(r["itr"] >= RZ_MAX_IT for r in reps):
        raise RuntimeError(f"chip_smoke: the rz MG potentials: {reps}, {launches}")
    return {"path": f"rz potentials {cell} f32 {RZ_SHARED}", "wall_s": wall,
            "itr": [r["itr"] for r in reps], "tol": [r["tol"] for r in reps],
            "converge": [r["converge"] for r in reps],
            "true_rel_residual_f64": [_true_residual(pots._solver_h),
                                      _true_residual(pots._solver_g)],
            "launches": launches}


def _rz_cmp_run(dev, kind: str):
    """f64 on ``dev``: ``"steps"`` — ``tests/test_models.py``'s 32 x 48
    implicit RFP steps (3 of dt 2e-3, the default FD-preconditioned
    BiCGSTAB); ``"selfconsistent"`` — ``run_selfconsistent`` at 40 x 80
    (the runner's anisotropic Maxwellian, 20 steps of 4e-4, potentials
    every 10). Returns (itr per solve, pdf on the host)."""
    import torch

    from pyapes_tpu_torch.models import RFPEvolution
    from pyapes_tpu_torch.solver import ops as ops_mod
    from pyapes_tpu_torch.variables import Field

    itrs = []
    real = ops_mod.Solver.solve

    def solve(self):
        rep = real(self)
        itrs.append(int(rep["itr"]))
        return rep

    ops_mod.Solver.solve = solve
    try:
        if kind == "steps":
            mesh = rz_mesh(dev, 32, 48, "double", ((0.0, 3.0), (-3.0, 3.0)))
            R, Z = mesh.R, mesh.Z
            f = Field("pdf", 1, mesh, None).set_var_tensor(torch.exp(-(R**2 + Z**2) / 1.28))
            model = RFPEvolution(mesh, -torch.sqrt(R**2 + Z**2 + 0.5),
                                 torch.sqrt(R**2 + Z**2 + 0.5))
            for _ in range(3):
                f = model.step_implicit(f, 2e-3)
        else:
            mesh = rz_mesh(dev, 40, 80, "double", ((0.0, 4.5), (-4.5, 4.5)))
            R, Z = mesh.R, mesh.Z
            f = Field("pdf", 1, mesh, None).set_var_tensor(torch.exp(-R**2 / 0.72 - Z**2 / 2.0))
            f = RFPEvolution(mesh).run_selfconsistent(f, dt=4e-4, n_steps=20, refresh_every=10)
    finally:
        ops_mod.Solver.solve = real
    return itrs, f().cpu()


def _rz_gates(dev) -> dict:
    """The JAX tests' physical gates on the card (f64):
    ``test_rosenbluth.py`` (the analytic Maxwellian H within 1% and the
    far-field G; isotropization with density conserved; the steady
    Maxwellian) and ``test_muscl.py`` (positivity and total variation of a
    transported box; mass of a transported Gaussian)."""
    import numpy as np
    import torch

    from pyapes_tpu_torch.models import RFPEvolution, RosenbluthPotentials
    from pyapes_tpu_torch.models.rosenbluth import maxwellian_H
    from pyapes_tpu_torch.solver.rfp import friction_apply, friction_apply_muscl
    from pyapes_tpu_torch.variables import Field

    def maxwellian(mesh, vth):
        return (torch.exp(-(mesh.R**2 + mesh.Z**2) / (2 * vth**2))
                / ((2 * np.pi * vth**2) ** 1.5))

    def moments(mesh, f):
        R, Z = (torch.as_tensor(g, device=f.device) for g in mesh._grid_np)
        dr, dz = (float(d) for d in mesh.dx_np)
        w = 2.0 * np.pi * R * dr * dz
        n = (f * w).sum().item()
        return n, (f * R**2 * w).sum().item() / n / 2.0, (f * Z**2 * w).sum().item() / n

    out = {}
    mesh = rz_mesh(dev, 48, 96, "double")
    pots = RosenbluthPotentials(mesh, maxwellian(mesh, 0.8))
    H, G = pots.solve(maxwellian(mesh, 0.8))
    Ha = maxwellian_H(mesh, pots.N, 0.8)
    out["H_rel_err"] = float((np.abs(H.cpu().numpy() - Ha) / np.abs(Ha).max()).max())
    out["G_far_rel_err"] = abs(G[-1, 48].item() - pots.N * 4.0) / (pots.N * 4.0)
    ok = (abs(pots.N - 1.0) < 2e-3 and out["H_rel_err"] < 0.01 and out["G_far_rel_err"] < 0.01
          and all(r["converge"] for r in pots.reports))

    mesh = rz_mesh(dev, 40, 80, "double", ((0.0, 4.5), (-4.5, 4.5)))
    f0 = torch.exp(-mesh.R**2 / 0.72 - mesh.Z**2 / 2.0) / (2 * np.pi * 0.36 * np.sqrt(2 * np.pi))
    n0, tp0, tz0 = moments(mesh, f0)
    f = RFPEvolution(mesh).run_selfconsistent(Field("pdf", 1, mesh, None).set_var_tensor(f0),
                                             dt=4e-4, n_steps=300, refresh_every=50)
    n1, tp1, tz1 = moments(mesh, f()[0])
    out["isotropize"] = {"density_drift": abs(n1 - n0) / n0, "aniso0": abs(tz0 - tp0),
                         "aniso1": abs(tz1 - tp1), "t_perp": tp1, "t_par": tz1}
    ok = ok and bool(f().isfinite().all()) and abs(n1 - n0) / n0 < 5e-3 and (
        abs(tz1 - tp1) < 0.95 * abs(tz0 - tp0) and tp0 - 1e-3 < tp1 < tz1 < tz0 + 1e-3)

    mesh = rz_mesh(dev, 40, 80, "double", ((0.0, 3.2), (-3.2, 3.2)))
    f0 = maxwellian(mesh, 0.8)
    f = RFPEvolution(mesh).run_selfconsistent(Field("pdf", 1, mesh, None).set_var_tensor(f0),
                                             dt=2e-4, n_steps=50, refresh_every=25)
    out["maxwellian_drift"] = ((f()[0] - f0).abs().max() / f0.max()).item()
    ok = ok and out["maxwellian_drift"] < 5e-3

    mesh = rz_mesh(dev, 32, 128, "double", ((0.0, 2.0), (-4.0, 4.0)))
    hr = torch.zeros(mesh.nx, dtype=torch.float64, device=dev)
    hz = torch.full(mesh.nx, -1.0, dtype=torch.float64, device=dev)
    dt = 0.4 * float(mesh.dx_np[1])

    def advect(f, n, scheme):
        for _ in range(n):
            f = f + dt * -(friction_apply(hr, hz, f, mesh) if scheme == "central" else
                           friction_apply_muscl(hr, hz, f, mesh, limiter=scheme))
        return f

    box = torch.where((mesh.Z > -0.5) & (mesh.Z < 0.5), 1.0, 0.0).to(torch.float64)
    f_c, f_m = advect(box, int(1.5 / dt), "central"), advect(box, int(1.5 / dt), "mc")
    tv = lambda v: v.diff(dim=1).abs().sum().item()  # noqa: E731
    out["muscl"] = {"central_min": f_c.min().item(), "mc_min": f_m.min().item(),
                    "mc_max": f_m.max().item(), "tv": tv(f_m), "tv0": tv(box)}
    gauss = torch.exp(-4.0 * (mesh.R**2 + (mesh.Z + 1.0) ** 2))
    moved = advect(gauss, int(1.0 / dt), "mc")
    m0, m1 = (gauss * mesh.R).sum().item(), (moved * mesh.R).sum().item()
    out["muscl"]["mass_drift"] = abs(m1 - m0) / m0
    ok = ok and (out["muscl"]["central_min"] < -0.05 and out["muscl"]["mc_min"] > -1e-12
                 and out["muscl"]["mc_max"] < 1.0 + 1e-12
                 and out["muscl"]["tv"] <= out["muscl"]["tv0"] + 1e-10
                 and out["muscl"]["mass_drift"] < 1e-6)
    if not ok:
        raise RuntimeError(f"chip_smoke: the rz/RFP gates of the JAX tests failed: {out}")
    return out


def phase_rz(dev) -> tuple:
    """The rz/RFP path: bench's cell (``run_rz_cell``) and the potentials
    under the shared config (``run_rz_potentials_shared``), with the launch
    counts set to 0 just before and read just after; then the card against
    the CPU in f64 (the same itr solve by solve, the pdf within
    ``RZ_CMP_TOL``) and the JAX tests' gates. Returns (the path's launch
    counts, its axis-stencil launches per run, the row march's launches
    among the path's, which must be some)."""
    import torch

    from pyapes_tpu_torch.ops import axis_stencil as A
    from pyapes_tpu_torch.solver.linalg.dispatch import clear_cache

    clear_cache()
    _reset_counts()
    A.axis_stencil.row_launches = 0
    cell = run_rz_cell(dev)
    print(f"[11 rz] {json.dumps(cell)}", flush=True)
    print(json.dumps({"rfp_rz_dof_per_s_chip": cell["rfp_rz_dof_per_s_chip"],
                      "wall_s": cell["wall_s_min"], "nr": cell["nr"], "nz": cell["nz"]}),
          flush=True)
    shared = run_rz_potentials_shared(dev)
    counts, row = _counts(), A.axis_stencil.row_launches
    if not row:
        raise RuntimeError("chip_smoke: the rz path never launched the 2-D row march")
    print(f"[11 rz] {json.dumps(shared)}", flush=True)
    torch.cuda.empty_cache()
    cmp = {}
    for kind in ("steps", "selfconsistent"):
        cpu_itr, cpu_f = _rz_cmp_run(torch.device("cpu"), kind)
        card_itr, card_f = _rz_cmp_run(dev, kind)
        rel = ((cpu_f - card_f).abs().max() / cpu_f.abs().max()).item()
        if card_itr != cpu_itr or not rel <= RZ_CMP_TOL:
            raise RuntimeError(f"chip_smoke: the rz {kind} run on the card differs from the CPU "
                               f"run: itr {card_itr} vs {cpu_itr}, max rel diff {rel:.3e}")
        cmp[kind] = {"itr": card_itr, "max_rel_diff": rel}
    print(f"[11 rz] card against CPU, f64 (tolerance {RZ_CMP_TOL}): {json.dumps(cmp)}",
          flush=True)
    print(f"[11 rz] the JAX tests' gates on the card, f64: {json.dumps(_rz_gates(dev))}",
          flush=True)
    per_run = [r["launches"].get("axis_stencil", 0) for r in cell["runs"]]
    return counts, per_run, row


# the channel path: the Schäfer–Turek 2D-2 cell of demos/schafer_turek.py
# (Schäfer & Turek 1996, flow past a cylinder at Re 100): Box[0:2.2,
# 0:0.41] with a MaskObstacle circle of d = 0.1 at (0.2, 0.2), ny = 83 and
# nx = round(2.2 / dy) + 1 = 441 nodes in f64 (the demo's default grid and
# dtype, not cut), nu 1e-3, parabolic inflow of peak 1.5 (mean 1.0), dt =
# 0.2 dy / 2.3, through ChannelFlow's default solves (plain BiCGSTAB
# momentum; BiCGSTAB with the plain-domain V-cycle for the pressure). The
# demo's config={"sync": False} and run_batched are phase 14's (here the
# eager steps); the per-step diagnostics stay on the card and are fetched
# once
ST_D, ST_UM, ST_NU = 0.1, 1.5, 1e-3
ST_U_MEAN = 2.0 / 3.0 * ST_UM
ST_NY, ST_RUNG_NY = 83, 329  # the cell; the scale rung (1761 x 329)
ST_WARM, ST_STEPS, ST_CHUNK, ST_RUNG_STEPS = 2, 50, 25, 10
ST_MARGIN = 6  # the demo's CV margin
N_CHANNEL_CMP, CHANNEL_CMP_STEPS = (97, 33), 40  # tests/test_obstacle.py's cylinder channel
CHANNEL_CMP_TOL = 1e-10


class SchaferTurek:
    """The 2D-2 cell at ``ny`` on ``dev``: ``model`` (``ChannelFlow``),
    ``dt``, and ``diag()``, the demo's per-step diagnostics as one device
    vector: the staircase force (2), the control-volume force (2), the
    front-rear pressure difference at the probe nodes and extrapolated to
    the cylinder surface (``demos/schafer_turek.py``)."""

    def __init__(self, dev, ny: int = ST_NY, dtype: str = "double", config=None):
        from pyapes_tpu_torch.geometry import Box, MaskObstacle
        from pyapes_tpu_torch.mesh import Mesh
        from pyapes_tpu_torch.models import ChannelFlow

        dy = 0.41 / (ny - 1)
        self.nx, self.ny = int(round(2.2 / dy)) + 1, ny
        body = MaskObstacle(lambda X, Y: (X - 0.2) ** 2 + (Y - 0.2) ** 2 < (ST_D / 2) ** 2)
        mesh = Mesh(Box[0:2.2, 0:0.41], [body], [self.nx, ny], device=str(dev), dtype=dtype)
        self.model = ChannelFlow(mesh, nu=ST_NU, u_in=ST_UM, config=config)
        self.dt = 0.2 * dy / 2.3  # peak speed ~2.3 over the cylinder
        self.ia, self.ib, self.jc = (int(round(v / dy)) for v in (0.15, 0.25, 0.20))

    def diag(self):
        import torch

        m, ia, ib, jc = self.model, self.ia, self.ib, self.jc
        p = m.p()[0]
        p_front = 3.0 * p[ia - 1, jc] - 3.0 * p[ia - 2, jc] + p[ia - 3, jc]
        p_rear = 3.0 * p[ib + 1, jc] - 3.0 * p[ib + 2, jc] + p[ib + 3, jc]
        return torch.cat([m.body_force_device(), m.body_force_cv_device(margin=ST_MARGIN),
                          torch.stack([p[ia, jc] - p[ib, jc], p_front - p_rear])])

    def run(self, steps: int, series: list | None = None) -> None:
        """``steps`` steps; with ``series``, each step's ``diag()`` appended
        (device tensors, no host read)."""
        for _ in range(steps):
            self.model.step(self.dt)
            if series is not None:
                series.append(self.diag())


def st_functionals(series, dt: float, t0_steps: int) -> dict:
    """The demo's functionals from a per-step diagnostic series (rows of
    ``SchaferTurek.diag``, fetched to the host; the first taken after
    ``t0_steps`` steps): the Strouhal number from the spectral peak of the
    developed half of the CV lift, the maxima of Cd and Cl (staircase and
    CV), the lift amplitude, and the pressure differences half a period
    after the lift maximum (``demos/schafer_turek.py``)."""
    import numpy as np

    s = np.asarray(series, dtype=np.float64)
    scale = 2.0 / (ST_U_MEAN**2 * ST_D)
    cd, cl, cd_cv, cl_cv = (scale * s[:, k] for k in range(4))
    t_arr = (np.arange(len(s)) + t0_steps + 1) * dt
    half = len(cl) // 2
    sig = cl_cv[half:] - cl_cv[half:].mean()
    out = {}
    if len(sig) > 16 and np.abs(sig).max() > 1e-6:
        freqs = np.fft.rfftfreq(len(sig), dt)
        amp = np.abs(np.fft.rfft(sig))
        k = int(np.argmax(amp[1:])) + 1
        delta = 0.0
        if 1 <= k < len(amp) - 1:  # parabolic interpolation of the peak
            a, b, c = amp[k - 1], amp[k], amp[k + 1]
            delta = 0.5 * (a - c) / (a - 2 * b + c)
        f_shed = float(freqs[k] + delta * (freqs[1] - freqs[0]))
        i_max = half + int(np.argmax(cl_cv[half:]))
        i_rep = int(np.argmin(np.abs(t_arr - (t_arr[i_max] + 0.5 / f_shed))))
        out = {"St": f_shed * ST_D / ST_U_MEAN, "Cl_max": float(cl[half:].max()),
               "Cd_max": float(cd[half:].max()), "Cl_amp": float(np.abs(sig).max()),
               "Cd_max_cv": float(cd_cv[half:].max()), "Cl_max_cv": float(cl_cv[half:].max()),
               "dP": float(s[i_rep, 4]), "dP_surf": float(s[i_rep, 5])}
    return out


def _channel_operators(dev, ny: int = ST_NY) -> list:
    """(label, coeffs, shape) of every operator the channel path applies
    through the 2-D axis stencil, in f64: the fine u, v (momentum) and p
    Laplacians and every level of the pressure's V-cycle (the spec the
    path's solve builds)."""
    from pyapes_tpu_torch.ops.stencil import laplacian_axis_coeffs
    from pyapes_tpu_torch.solver.linalg.build import make_mg_spec
    from pyapes_tpu_torch.utils.carry import coeffs_from_numpy

    m = SchaferTurek(dev, ny).model
    mesh, x = m.mesh, m.p()
    ops = [(f"fine {f.name} {mesh.nx}",
            coeffs_from_numpy(laplacian_axis_coeffs(mesh, f.bcs), dev, x.dtype), mesh.nx)
           for f in (m.u, m.v, m.p)]
    spec = make_mg_spec(m.p_solver.config["fdm"], x, m.p.bcs, mesh, ())
    return ops + [(f"MG level {shp}", spec._level_coeffs(shp), shp) for shp in spec.shapes]


def check_axis_channel(dev, ny: int = ST_NY) -> tuple:
    """The 2-D ``axis_stencil`` on the channel's operators
    (``_channel_operators``) in f64, and in bf16 and f32 on the same
    vectors rounded: the row march the same bits as the per-point kernel
    and within ``REL_TOL`` of ``apply_axis_stencil`` (``_check_2d``); then
    the fine pressure operator in f64 timed (``_time_2d``). Returns (worst
    abs error, timing row)."""
    import torch

    worst, ops = 0.0, _channel_operators(dev, ny)
    for dtname in ("float64", "float32", "bfloat16"):
        dtype = getattr(torch, dtname)
        for seed, (label, coeffs, shape) in enumerate(ops):
            g = torch.Generator(device=dev).manual_seed(1200 + seed)
            x = torch.randn((1, *shape), generator=g, device=dev, dtype=torch.float64)
            c = tuple(tuple(v.to(dtype) for v in cs) for cs in coeffs)
            worst = max(worst, _check_2d(f"channel {label}", c, x.to(dtype)))
    label, coeffs, shape = ops[2]
    print(f"[3 kernel] axis stencil 2-D channel: {len(ops)} operators hold in f64/f32/bf16 (u, "
          f"v, p at {shape}, every pressure MG level {[o[2] for o in ops[3:]]}; the row march "
          f"the per-point kernel's bits at chunks {ROW_CHUNKS} and the shape's, on another call "
          "too)", flush=True)
    g = torch.Generator(device=dev).manual_seed(1199)
    x = torch.randn((1, *shape), generator=g, device=dev, dtype=torch.float64)
    row = {**_time_2d(coeffs, x), "max_abs_err": worst}
    _print_2d("channel pressure", row)
    return worst, row


# the 2-D grids of the row march's choice (``row_level_times``): the rz
# cell and its MG levels (f32), the 2D-2 grid, its pressure levels and its
# 1761 x 329 rung (f64), and square grids around them
ROW_LEVELS = ([((512 >> s, 1024 >> s), "float32") for s in range(6)]
              + [((n, n), "float32") for n in (2049, 1025, 257)]
              + [((441, 83), "float64"), ((221, 42), "float64"), ((111, 21), "float64"),
                 ((56, 11), "float64"), ((28, 6), "float64"), ((1761, 329), "float64"),
                 ((881, 165), "float64")])


def row_level_times(dev, levels=ROW_LEVELS) -> list:
    """The 2-D apply's two kernels, each forced, on the device back to back
    (``_device_ms``) at ``levels``, the row march the per-point kernel's
    bits; prints each beside the shape's choice (``uses_row_march``)."""
    import torch

    from pyapes_tpu_torch.ops import axis_stencil as A

    rows = []
    for seed, (shape, dtname) in enumerate(levels):
        coeffs, x = _axis_inputs((1, *shape), (3, 3), getattr(torch, dtname), dev, 1400 + seed)
        if not torch.equal(A.axis_stencil(coeffs, x, march=True),
                           A.axis_stencil(coeffs, x, march=False)):
            raise RuntimeError(f"chip_smoke: the row march gave other bits than the per-point "
                               f"kernel at {shape} {dtname}")
        rows.append({"shape": shape, "dtype": dtname, "row": A.uses_row_march((1, *shape)),
                     "row_device_ms": _device_ms(lambda: A.axis_stencil(coeffs, x, march=True)),
                     "point_device_ms": _device_ms(
                         lambda: A.axis_stencil(coeffs, x, march=False))})
    print("[3 kernel] axis stencil 2-D, device µs back to back, row march / per-point (the "
          "shape's choice marked *): " + "; ".join(
              f"{r['shape'][0]}x{r['shape'][1]} {r['dtype']} "
              f"{'*' if r['row'] else ''}{1e3 * r['row_device_ms']:.2f} / "
              f"{'' if r['row'] else '*'}{1e3 * r['point_device_ms']:.2f}" for r in rows),
          flush=True)
    return rows


def axis_2d_times(dev, chunks=(None, 1, 2, 4, 8), forced=True) -> list:
    """The 2-D apply at the rz cell (512 x 1024 f32, the potentials' fine
    operator) and the 2D-2 grid (441 x 83 f64, the pressure operator), per
    call and back to back on the device (``_time_2d``); with ``forced``
    the row march also at each of ``chunks`` rows per thread (device
    only). Without ``forced`` only the wrapper's common signature is used
    (an older version under ``ab_cells_torch.py --root``)."""
    import torch

    from pyapes_tpu_torch.ops.axis_stencil import axis_stencil
    from pyapes_tpu_torch.ops.stencil import apply_axis_stencil

    rows = []
    for label, (_, coeffs, shape), dtype in (
            ("rz", _rz_operators(dev, "float32")[0], torch.float32),
            ("channel", _channel_operators(dev)[2], torch.float64)):
        g = torch.Generator(device=dev).manual_seed(1300)
        x = torch.randn((1, *shape), generator=g, device=dev, dtype=dtype)
        ref = apply_axis_stencil(coeffs, x)
        err = (axis_stencil(coeffs, x) - ref).abs().max().item()
        if not err <= REL_TOL[str(dtype).split(".")[1]] * ref.abs().max().item():
            raise RuntimeError(f"chip_smoke: axis_stencil on the {label} grid disagrees with its "
                               f"plain version ({err:.3e})")
        if forced:
            row = _time_2d(coeffs, x)
            row["chunks"] = {str(c): _device_ms(lambda: axis_stencil(coeffs, x, march=True,
                                                                     chunk=c))
                             for c in chunks}
        else:
            copy = torch.empty_like(x)
            row = {"shape": shape, "ms": _time_ms(lambda: axis_stencil(coeffs, x)),
                   "device_ms": _device_ms(lambda: axis_stencil(coeffs, x)),
                   "copy_device_ms": _device_ms(lambda: copy.copy_(x))}
        rows.append({"label": label, **row})
    return rows


def run_st_cell(dev, ny: int = ST_NY, warm: int = ST_WARM, steps: int = ST_STEPS,
                chunk: int = ST_CHUNK) -> tuple:
    """The 2D-2 cell through ``ChannelFlow.step``: ``warm`` steps, then
    ``steps`` steps with the per-step diagnostics on the card, timed in
    chunks of ``chunk`` steps that each end in a synchronize; then one step
    with its host syncs counted. Wall per step (the median chunk),
    cell-steps/s, itr per solve (u, v, p) per step, the axis-stencil
    launches per step, peak memory, the flux balance, the last step's
    forces. A solve at ``max_it`` or unconverged, a step without an
    axis-stencil launch or a non-finite field fails. Returns (stats, the
    diagnostic series on the host)."""
    import torch

    cell = SchaferTurek(dev, ny)
    model = cell.model
    reports = _record_solves(model)
    cell.run(warm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n0 = len(reports)
    series, walls, per_step = [], [], []
    for _ in range(0, steps, chunk):
        tic = time.perf_counter()
        for _ in range(chunk):
            before = _counts()
            cell.run(1, series)
            after = _counts()
            per_step.append({k: after[k] - before[k] for k in after if after[k] > before[k]})
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - tic) / chunk)
    peak = torch.cuda.max_memory_allocated() / 2**30
    syncs = _count_syncs(lambda: cell.run(1))
    host = torch.stack(series).cpu().numpy()
    timed = reports[n0:n0 + 3 * steps]
    bad = [(k, r["itr"], r["tol"]) for k, r in enumerate(reports)
           if r["itr"] >= r["max_it"] or not r["converge"] or not r["tol"] == r["tol"]]
    if bad:
        raise RuntimeError(f"chip_smoke: 2D-2 {ny}: solves at max_it or not converged: {bad[:3]}")
    missing = [k for k, ls in enumerate(per_step) if not ls.get("axis_stencil")]
    if missing:
        raise RuntimeError(f"chip_smoke: 2D-2 {ny}: steps launched no axis_stencil: {missing[:3]}")
    if not bool(torch.cat([v() for v in model.vel] + [model.p()]).isfinite().all()):
        raise RuntimeError(f"chip_smoke: 2D-2 {ny}: a field is not finite")
    itr = [[r["itr"] for r in timed[k:k + 3]] for k in range(0, len(timed), 3)]
    wall = statistics.median(walls)
    fin, fout = model.flux(1), model.flux(cell.nx - 2)
    scale = 2.0 / (ST_U_MEAN**2 * ST_D)
    stats = {
        "path": f"Schäfer–Turek 2D-2 {cell.nx} x {ny} f64", "dt": cell.dt, "warm_steps": warm,
        "steps": steps, "chunk": chunk, "wall_s_per_step_chunks": walls,
        "wall_s_per_step_median": wall, "cell_steps_per_s": cell.nx * ny / wall,
        "itr_uvp_min": [min(c) for c in zip(*itr)], "itr_uvp_max": [max(c) for c in zip(*itr)],
        "itr_uvp_mean": [sum(c) / len(c) for c in zip(*itr)], "itr_uvp_last": itr[-1],
        "axis_stencil_launches_per_step": sorted({ls["axis_stencil"] for ls in per_step}),
        "launches_per_step_first": per_step[0], "host_syncs_per_step": syncs,
        "peak_mem_gib": peak, "flux_in": fin, "flux_out": fout,
        "flux_imbalance": abs(fin - fout) / abs(fin),
        "force_staircase_last": host[-1, 0:2].tolist(), "force_cv_last": host[-1, 2:4].tolist(),
        "cd_cl_staircase_last": (scale * host[-1, 0:2]).tolist(),
        "cd_cl_cv_last": (scale * host[-1, 2:4]).tolist(), "solves_at_max_it": 0,
        "t": model.t,
    }
    return stats, host


def _channel_cmp_run(dev, steps: int = CHANNEL_CMP_STEPS):
    """``tests/test_obstacle.py``'s cylinder channel (Box[0:3, 0:1], a
    MaskObstacle circle of radius 0.12 at (0.7, 0.5), 97 x 33 f64, nu
    0.02, dt 0.005) for ``steps`` eager steps on ``dev``: ``(itr per solve,
    state fields on the host, the model)``."""
    from pyapes_tpu_torch.geometry import Box, MaskObstacle
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import ChannelFlow

    body = MaskObstacle(lambda X, Y: (X - 0.7) ** 2 + (Y - 0.5) ** 2 < 0.12**2)
    mesh = Mesh(Box[0:3, 0:1], [body], list(N_CHANNEL_CMP), device=str(dev), dtype="double")
    model = ChannelFlow(mesh, nu=0.02, u_in=1.0)
    reports = _record_solves(model)
    model.run(0.005, steps)
    return [r["itr"] for r in reports], [f().cpu() for f in model.state_fields()], model


def _channel_gates(model) -> dict:
    """The JAX tests' gates (``tests/test_obstacle.py:458``, ``:516``) on a
    40-step cylinder channel: flux imbalance under 2%, no slip in the
    body, the wake slower than half the free stream, drag > 0 and |lift|
    < 0.3 drag."""
    fin, fout = model.flux(0), model.flux(-1)
    u = model.u()[0].cpu().numpy()
    body = model.mesh.obstacle_body_masks[0]
    iy = 16
    ix_body = int(body[:, iy].nonzero()[0].max())
    drag, lift = model.body_force()
    gates = {"flux_imbalance": abs(fin - fout) / abs(fin),
             "max_abs_u_in_body": float(abs(u[body]).max()),
             "u_wake": float(u[ix_body + 2, iy]), "u_free": float(u[10, iy]),
             "drag": float(drag), "lift": float(lift)}
    if not (gates["flux_imbalance"] < 0.02 and gates["max_abs_u_in_body"] < 1e-6
            and gates["u_wake"] < 0.5 * gates["u_free"] and drag > 0.0
            and abs(lift) < 0.3 * drag):
        raise RuntimeError(f"chip_smoke: the cylinder channel failed the JAX tests' gates: {gates}")
    return gates


def phase_channel(dev) -> tuple:
    """The channel path: the 2D-2 cell at 441 x 83 (``run_st_cell``) and
    the scale rung at 1761 x 329 (10 steps), each with the launch counts
    set to 0 just before and read just after; the card against the CPU in
    f64 (the cylinder channel, 40 steps: the same itr solve by solve, the
    fields within ``CHANNEL_CMP_TOL`` relative); the JAX tests' gates on
    the card. Returns (the path's launch counts, its axis-stencil launches
    per step at 441 x 83)."""
    import torch

    from pyapes_tpu_torch.solver.linalg.dispatch import clear_cache

    clear_cache()
    _reset_counts()
    cell, _ = run_st_cell(dev)
    counts = _counts()
    print(f"[12 channel] {json.dumps(cell)}", flush=True)
    torch.cuda.empty_cache()
    _reset_counts()
    rung, _ = run_st_cell(dev, ST_RUNG_NY, warm=1, steps=ST_RUNG_STEPS, chunk=ST_RUNG_STEPS // 2)
    for name, c in _counts().items():
        counts[name] += c
    print(f"[12 channel] scale rung: {json.dumps(rung)}", flush=True)
    torch.cuda.empty_cache()
    cpu_itr, cpu_f, _ = _channel_cmp_run(torch.device("cpu"))
    card_itr, card_f, card_model = _channel_cmp_run(dev)
    rel = max(((a - b).abs().max() / a.abs().max().clamp_min(1e-30)).item()
              for a, b in zip(cpu_f, card_f))
    if card_itr != cpu_itr or not rel <= CHANNEL_CMP_TOL:
        raise RuntimeError(f"chip_smoke: the cylinder channel on the card differs from the CPU "
                           f"run: itr {card_itr} vs {cpu_itr}, max rel diff {rel:.3e}")
    print(f"[12 channel] card against CPU, f64 (tolerance {CHANNEL_CMP_TOL}): "
          f"{json.dumps({'n': N_CHANNEL_CMP, 'steps': CHANNEL_CMP_STEPS, 'solves': len(card_itr), 'itr_sum': sum(card_itr), 'max_rel_diff': rel})}",
          flush=True)
    print(f"[12 channel] the JAX tests' gates on the card, f64: "
          f"{json.dumps(_channel_gates(card_model))}", flush=True)
    return counts, cell["axis_stencil_launches_per_step"]


# the periodic path (phase 13): bench.py's cg problem with axes 0 and 1
# periodic (513 x 513 x 512 nodes, the reduced torus 512^3, axis 2
# Dirichlet); the Jacobi family checked with a torus level's masks at the
# torus levels of that cycle; the 3-D Taylor-Green vortex at Re 1600 with
# Smagorinsky LES (demos/tgv3d_les.py: 64^3 nodes f32, cs 0.17, dt = 0.2
# dx), 2 warm steps then 3 timed windows of 10, and its 257^3 rung for 10
# steps (the first grid where diff_field and axis_stencil take the plane
# march on this path); the card against the CPU in f64 at 17^3 (the
# Beltrami flow of tests/test_models.py 20 steps, the Smagorinsky TGV 10)
PERIODIC_AXES = (0, 1)
TORUS_MASKS = ((2,), ())
TGV_N, TGV_RUNG = 64, 257
TGV_WARM, TGV_STEPS, TGV_REPS, TGV_RUNG_STEPS = 2, 10, 3, 10
N_PERIODIC_CMP = 17
PERIODIC_CMP_TOL = 1e-10


def tgv_model(dev, n: int = TGV_N, dtype: str = "single", les: bool = True, cs: float = 0.17,
              re: float = 1600.0, config=None):
    """``demos/tgv3d_les.py``'s cell: ``PeriodicFlow`` on [0, 2 pi]^3 at n^3
    nodes, nu 1/re, the Smagorinsky closure (cs; without it with ``les``
    false), the model's default solves (BiCGSTAB momentum through the
    variable-Γ kernel, fastdiag pressure), the default ``sync``, ``config``
    added to them (a decomposition); the Taylor-Green start. Returns
    (model, dt = 0.2 dx)."""
    import torch

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import PeriodicFlow, smagorinsky_viscosity
    from pyapes_tpu_torch.solver.linalg.dispatch import clear_cache

    clear_cache()
    L, nu = 2 * pi, 1.0 / re
    mesh = Mesh(Box[0:L, 0:L, 0:L], None, [n] * 3, device=str(dev), dtype=dtype)
    model = PeriodicFlow(mesh, nu=nu, config=config,
                         mu_strain_fn=smagorinsky_viscosity(nu, mesh, cs=cs) if les else None)
    X, Y, Z = mesh.X, mesh.Y, mesh.Z
    model.set_velocity(torch.sin(X) * torch.cos(Y) * torch.cos(Z),
                       -torch.cos(X) * torch.sin(Y) * torch.cos(Z), torch.zeros_like(X))
    return model, 0.2 * L / (n - 1)


def run_tgv_cell(dev, n: int = TGV_N, warm: int = TGV_WARM, steps: int = TGV_STEPS,
                 reps: int = TGV_REPS) -> dict:
    """The TGV-3D LES cell through ``_run_cell`` (``diff_field``, the
    momentum's variable-Γ apply, and ``axis_stencil``, the pressure's
    fastdiag residual, in every step): <E>(0) held to 1/8 within 2e-3
    first; then cell-steps/s and the host syncs of one more step (torch's
    sync debug mode)."""
    model, dt = tgv_model(dev, n)
    label = f"TGV-3D Re 1600 Smagorinsky {n}^3 f32"
    vol = (2 * pi) ** 3
    e0 = float(model.kinetic_energy()) / vol
    if not abs(e0 - 0.125) < 2e-3:
        raise RuntimeError(f"chip_smoke: {label}: <E>(0) = {e0} is not 1/8")
    stepper = _Stepper(model, dt)
    stats = _run_cell(stepper, ("diff_field", "axis_stencil"), label, warm, steps, reps, False)
    return {**stats, "n": n, "cell_steps_per_s": n**3 / stats["wall_s_per_step_median"],
            "host_syncs_per_step": _count_syncs(stepper.step), "E0": e0,
            "E_end": float(model.kinetic_energy()) / vol}


def _periodic_cmp_run(dev, kind: str, n: int = N_PERIODIC_CMP):
    """f64 on ``dev``: the Beltrami/ABC flow (``kind`` "beltrami": L 2 pi,
    nu 0.2, the JAX test's dt, 20 steps) or the Smagorinsky TGV (10 steps)
    at n^3: ``(itr per solve, state fields on the host)``."""
    import torch

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import PeriodicFlow

    if kind == "beltrami":
        L = 2 * pi
        mesh = Mesh(Box[0:L, 0:L, 0:L], None, [n] * 3, device=str(dev), dtype="double")
        model = PeriodicFlow(mesh, nu=0.2)
        X, Y, Z = mesh.X, mesh.Y, mesh.Z
        model.set_velocity(torch.sin(Z) + torch.cos(Y), torch.sin(X) + torch.cos(Z),
                           torch.sin(Y) + torch.cos(X))
        steps = int(round(0.5 / (0.2 * (L / (n - 1)) / 2.0)))
        dt, n_steps = 0.5 / steps, 20
    else:
        model, dt = tgv_model(dev, n, "double")
        n_steps = 10
    reports = _record_solves(model)
    model.run(dt, n_steps)
    return [r["itr"] for r in reports], [f().cpu() for f in model.state_fields()]


def _periodic_gates(dev) -> dict:
    """``tests/test_models.py::test_taylor_green_decay`` on the card (65^2
    f64, nu 0.01, 50 steps of 2e-3): the velocity within 1% of the exact
    decay, the kinetic energy within 2%, max|div| < 0.05."""
    import torch

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.models import PeriodicFlow

    mesh = Mesh(Box[0:1, 0:1], None, [65, 65], device=str(dev), dtype="double")
    model = PeriodicFlow(mesh, nu=0.01)
    k = 2 * pi
    u0 = -torch.cos(k * mesh.X) * torch.sin(k * mesh.Y)
    v0 = torch.sin(k * mesh.X) * torch.cos(k * mesh.Y)
    model.set_velocity(u0, v0)
    model.run(2e-3, 50)
    decay = exp(-2 * k**2 * 0.01 * 2e-3 * 50)
    rel = [((f()[0] - e * decay).norm() / (e * decay).norm()).item()
           for f, e in ((model.u, u0), (model.v, v0))]
    gates = {"rel_u": rel[0], "rel_v": rel[1],
             "ke_ratio": float(model.kinetic_energy()) / (0.25 * decay**2),
             "max_abs_div": model.divergence().abs().max().item()}
    if not (max(rel) < 0.01 and abs(gates["ke_ratio"] - 1.0) < 0.02
            and gates["max_abs_div"] < 0.05):
        raise RuntimeError(f"chip_smoke: the Taylor-Green decay failed the JAX test's gates: "
                           f"{gates}")
    return gates


def phase_periodic(dev) -> tuple:
    """The periodic path: the MG-PCG on the 512^3 torus (bench's cg
    config; ``jacobi3d``/``jacobi3d_x2`` and ``axis_stencil_dot`` must
    launch), the Jacobi family with the torus masks at its levels, the
    TGV-3D LES cell at 64^3 and its 257^3 rung (each path with the launch
    counts set to 0 just before and read just after), the card against the
    CPU in f64 (the same itr solve by solve, the fields within
    ``PERIODIC_CMP_TOL`` relative), the Taylor-Green gates on the card.
    Returns (the paths' launch counts, the worst abs errors of the torus
    checks per kernel)."""
    import torch

    from pyapes_tpu_torch.solver.multigrid import _level_shapes

    tic = time.perf_counter()
    counts, _ = phase_mgpcg(
        dev, N_MAIN, BENCH_MG, ("axis_stencil_dot", "jacobi3d", "jacobi3d_x2"),
        f"MG-PCG periodic {PERIODIC_AXES} torus {N_MAIN}^3 bf16 V(2,2) FMG", paxes=PERIODIC_AXES)
    torch.cuda.empty_cache()
    worst_abs = {}
    levels = [(1, *shape) for shape in _level_shapes((N_MAIN,) * 3)]
    for kernel in MARCHES:  # every level of the torus cycle
        for k, v in check_march(dev, kernel, levels, chunks=False, masks=TORUS_MASKS,
                                label="[13 periodic]")[1].items():
            worst_abs[k] = max(worst_abs.get(k, 0.0), v)
    torch.cuda.empty_cache()
    for kernel in MARCHES:  # beside phase 3's full-mask rows
        for axes in TORUS_MASKS:
            level_times(dev, kernel, axes=axes)
    torch.cuda.empty_cache()
    for n, warm, steps, reps in ((TGV_N, TGV_WARM, TGV_STEPS, TGV_REPS),
                                 (TGV_RUNG, 1, TGV_RUNG_STEPS, 1)):
        _reset_counts()
        cell = run_tgv_cell(dev, n, warm, steps, reps)
        for name, c in _counts().items():
            counts[name] = counts.get(name, 0) + c
        print(f"[13 periodic] {json.dumps(cell)}", flush=True)
        torch.cuda.empty_cache()
    cmp = {}
    for kind in ("beltrami", "tgv_les"):
        itr, rel = _card_vs_cpu(dev, lambda d: _periodic_cmp_run(d, kind), kind,
                                PERIODIC_CMP_TOL)
        cmp[kind] = {"n": N_PERIODIC_CMP, "solves": len(itr), "itr_sum": sum(itr),
                     "max_rel_diff": rel}
    print(f"[13 periodic] card against CPU, f64 (tolerance {PERIODIC_CMP_TOL}): "
          f"{json.dumps(cmp)}", flush=True)
    print(f"[13 periodic] the Taylor-Green test's gates on the card, f64 (65^2, 50 steps): "
          f"{json.dumps(_periodic_gates(dev))}", flush=True)
    print(f"[13 periodic] phase wall {time.perf_counter() - tic:.1f} s", flush=True)
    return counts, worst_abs


# phase 14: eager against fused steps of the three flow cells, in turns
FUSED_CELLS = ("cavity", "2D-2", "tgv")
FUSED_CHUNK = {"cavity": 10, "2D-2": 25, "tgv": 10}
FUSED_REPS = 2
FUSED_TOL = {"double": 1e-12, "single": 1e-5}
FUSED_N = {"cavity": 128, "2D-2": ST_NY, "tgv": TGV_N}


def _fused_cell(dev, cell: str):
    """Two models of ``cell`` from the same start: ``(eager, fused, dt,
    cells, dtype, diag)``; ``diag(model)`` the per-step diagnostics (the
    2D-2 demo's) or None."""
    n = FUSED_N[cell]
    if cell == "cavity":
        a, b = cavity_model(dev, n)[0], cavity_model(dev, n)[0]
        return a.model, b.model, a.dt, n**3, "single", None
    if cell == "2D-2":
        a, b = SchaferTurek(dev, n), SchaferTurek(dev, n)

        def diag(model, ca=a, cb=b):
            return (ca if model is ca.model else cb).diag()

        return a.model, b.model, a.dt, a.nx * a.ny, "double", diag
    (ma, dt), (mb, _) = tgv_model(dev, n), tgv_model(dev, n)
    return ma, mb, dt, n**3, "single", None


def _api_calls(fn) -> dict:
    """The CUDA runtime/driver API calls of ``fn()`` on the host, by name
    (``torch.profiler``), and their total."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
    calls = {e.key: e.count for e in prof.key_averages()
             if e.key.startswith(("cuda", "cu")) and not e.key.startswith("cudaDeviceSync")}
    return {"total": sum(calls.values()), "graph_launches": calls.get("cudaGraphLaunch", 0),
            "kernel_launches": sum(v for k, v in calls.items() if "LaunchKernel" in k),
            "memcpy": sum(v for k, v in calls.items() if "Memcpy" in k)}


def _graph_replays(fn) -> int:
    """The CUDA graph launches of ``fn()``: its calls of
    ``torch.cuda.CUDAGraph.replay``, counted on the host (no profiler)."""
    import torch

    real = torch.cuda.CUDAGraph.replay
    count = [0]

    def counted(graph):
        count[0] += 1
        return real(graph)

    torch.cuda.CUDAGraph.replay = counted
    try:
        fn()
    finally:
        torch.cuda.CUDAGraph.replay = real
    return count[0]


def _max_rel(ma, mb) -> float:
    worst = 0.0
    for a, b in zip(ma.state_fields(), mb.state_fields()):
        scale = max(float(a().abs().max()), 1e-30)
        worst = max(worst, float((a() - b()).abs().max()) / scale)
    return worst


def run_fused_cell(dev, cell: str, chunk: int | None = None, reps: int = FUSED_REPS) -> dict:
    """Phase 14 on one cell (see the module docstring)."""
    import warnings

    import torch

    from pyapes_tpu_torch.ops import graph_loop
    from pyapes_tpu_torch.solver.ops import solve_log

    chunk = chunk or FUSED_CHUNK[cell]
    ma, mb, dt, cells, dtype, diag = _fused_cell(dev, cell)
    label = f"fused {cell}"
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ma.run(dt, 2)
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        nodes0 = graph_loop.nodes
        mb.run(dt, 2, fused=True)
        fell_back = [str(w.message) for w in caught if "falling back" in str(w.message)]
        if fell_back:
            raise RuntimeError(f"chip_smoke: {label}: the fused bootstrap fell back: "
                               f"{fell_back[0]}")
        if diag is not None:  # the batched program (diagnostics in the graph)
            mb.run_batched(dt, 1, diag_fn=diag)
            ma.step(dt)
        torch.cuda.synchronize()
        runner = mb.fused_runner()
        alloc_change = (torch.cuda.memory_allocated() - mem0) / 2**30
        nodes = graph_loop.nodes - nodes0
        walls = {"eager": [], "fused": []}
        peaks = {"eager": 0.0, "fused": 0.0}
        series_a, series_b, itrs = [], [], []
        for _ in range(reps):
            for kind in ("eager", "fused"):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                tic = time.perf_counter()
                if kind == "eager":
                    for _ in range(chunk):
                        with solve_log() as log:
                            ma.step(dt)
                        if diag is not None:
                            series_a.append(diag(ma))
                    itr_a = [int(r["itr"]) for r in log]
                elif diag is not None:
                    series_b.append(mb.run_batched(dt, chunk, diag_fn=diag))
                else:
                    runner.run(dt, chunk)
                torch.cuda.synchronize()
                walls[kind].append((time.perf_counter() - tic) / chunk)
                peaks[kind] = max(peaks[kind], torch.cuda.max_memory_allocated() / 2**30)
            fell_back = [str(w.message) for w in caught if "falling back" in str(w.message)
                         or "stepping eagerly" in str(w.message)]
            if fell_back:
                raise RuntimeError(f"chip_smoke: {label}: the fused run fell back: "
                                   f"{fell_back[0]}")
            itr_b = [int(r["itr"]) for r in runner.reports]
            itrs.append((itr_a, itr_b))
            if itr_a != itr_b:
                raise RuntimeError(f"chip_smoke: {label}: itr per solve eager {itr_a}, fused "
                                   f"{itr_b}")
        captures = runner.captures
        syncs_b = _count_syncs(lambda: runner.step(dt))
        syncs_a = _count_syncs(lambda: ma.step(dt))
        api_b = _api_calls(lambda: runner.step(dt))
        api_a = _api_calls(lambda: ma.step(dt))
        launches = {}
        for kind, fn in (("eager", lambda: ma.step(dt)), ("fused", lambda: runner.step(dt))):
            c0 = _counts()
            fn()
            launches[kind] = {k: v - c0[k] for k, v in _counts().items() if v > c0[k]}
        torch.cuda.synchronize()
    fell_back = [str(w.message) for w in caught if "falling back" in str(w.message)
                 or "stepping eagerly" in str(w.message)]
    if fell_back:
        raise RuntimeError(f"chip_smoke: {label}: the fused run fell back: {fell_back[0]}")
    rel = _max_rel(ma, mb)
    if not rel <= FUSED_TOL[dtype]:
        raise RuntimeError(f"chip_smoke: {label}: fused against eager max rel diff {rel:.3e} > "
                           f"{FUSED_TOL[dtype]}")
    if syncs_b:
        raise RuntimeError(f"chip_smoke: {label}: a fused step made {syncs_b} host syncs")
    if api_b["graph_launches"] != 1 or nodes == 0:
        raise RuntimeError(f"chip_smoke: {label}: {api_b['graph_launches']} graph launches per "
                           f"step, {nodes} WHILE nodes captured")
    if not bool(torch.cat([f() for f in mb.state_fields()]).isfinite().all()):
        raise RuntimeError(f"chip_smoke: {label}: a field is not finite")
    out = {"cell": cell, "dtype": dtype, "dt": dt, "chunk": chunk, "reps": reps,
           "wall_s_per_step": walls,
           "wall_s_per_step_median": {k: statistics.median(v) for k, v in walls.items()},
           "cell_steps_per_s": {k: cells / statistics.median(v) for k, v in walls.items()},
           "itr_per_solve_last_step": itrs[-1][1], "host_syncs_per_step":
           {"eager": syncs_a, "fused": syncs_b}, "cuda_api_calls_per_step":
           {"eager": api_a, "fused": api_b}, "captures": captures,
           "capture_s": runner.capture_s, "while_nodes_captured": nodes,
           "wrapper_launches_per_step": launches,
           "allocated_change_over_fused_bootstrap_gib": alloc_change,
           "peak_mem_gib": peaks, "max_rel_diff_fused_vs_eager": rel}
    if diag is not None:
        sa = torch.stack(series_a).cpu().numpy()
        sb = torch.cat(series_b).cpu().numpy()
        out["diag_max_abs_diff"] = float(abs(sa - sb).max())
        if not out["diag_max_abs_diff"] <= 1e-12 * max(float(abs(sa).max()), 1e-30):
            raise RuntimeError(f"chip_smoke: {label}: the diagnostics differ: "
                               f"{out['diag_max_abs_diff']}")
    return out


def phase_fused(dev) -> dict:
    """Phase 14: eager against fused steps, in turns (module docstring)."""
    out = {}
    for cell in FUSED_CELLS:
        out[cell] = run_fused_cell(dev, cell)
        print(f"[14 fused] {json.dumps(out[cell])}", flush=True)
    cav = out["cavity"]["cell_steps_per_s"]
    print(f"[14 fused] ns_cavity3d_cell_steps_per_s_chip {cav['fused']} (eager "
          f"{cav['eager']}; {FUSED_N['cavity']}^3 f32, the median of {FUSED_REPS} chunks of "
          f"{FUSED_CHUNK['cavity']})", flush=True)
    return out


# -- phase 15: the adjoint tier --------------------------------------------------

ADJ_N = 256  # (a): the 3-D permeability-inversion gradient, f64
ADJ_N_VARIANT = 128  # (b)-(d) and the host-bound probe of (a)'s problem
ADJ_TOL = 1e-8  # (a)'s solves
ADJ_VARIANT_TOL = 1e-10  # (b)'s: the directional check's error is ~60 tol (CPU probe)
ADJ_TRANSPORT_TOL = 1e-12  # (c)'s: its loss (the test's) is ~1e5 times its derivative
ADJ_SENSOR_STRIDE = 4  # (a)'s sensors: every 4th interior node
ADJ_DIR_TOL = 1e-6  # the directional check, relative
ADJ_EPS = 1e-2  # its central differences, Richardson-extrapolated over eps and eps/2
ADJ_ADAM = 4  # (a)'s Adam updates (the warm-up's gradient takes the first)
ADJ_TRANSIENT_STEPS = 4
ADJ_CMP_N = 17  # (e): the card against the CPU, 17^2 and 17^3 f64
ADJ_CMP_TOL = (1e-10, 1e-9)  # (e): solutions, gradients, relative to the largest entry
ADJ_CKPT_N = 128  # (f): the fused cavity, f32
ADJ_CKPT_STEPS = 5  # (f): steps before and after the checkpoint


def _adj_bcs(mesh, kinds):
    """The BC objects of the face kinds ``kinds`` (xl, xu, yl, ...), all of
    value 0."""
    from pyapes_tpu_torch.variables import Field
    from pyapes_tpu_torch.variables.bcs import mixed_bcs

    return Field("p", 1, mesh, {"domain": mixed_bcs([0.0] * len(kinds), list(kinds)),
                                "obstacle": None}).bcs


def _adj_mesh(dev, n: int, dims: int = 3):
    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh

    return Mesh(Box[tuple(slice(0, 1) for _ in range(dims))], None, [n] * dims, device=str(dev),
                dtype="double")


def _smooth(mesh, shape=None):
    """A smooth direction of unit amplitude on the mesh's nodes."""
    import torch

    v = None
    for j, x in enumerate(mesh.grid):
        f = torch.sin(pi * (j + 1) * x + 0.3 * j)
        v = f if v is None else v * f
    return v if shape is None else v.reshape(shape)


def _directional(loss, p, g, v, eps: float = ADJ_EPS) -> dict:
    """``<g, v>`` against the central differences of ``loss`` along ``v``
    at ``p`` (Richardson over eps and eps/2), and the wall of each of the
    four loss evaluations (one forward solve each)."""
    import torch

    walls = []

    def val(q):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        with torch.no_grad():
            out = float(loss(q))
        walls.append(time.perf_counter() - tic)
        return out

    def cd(e):
        return (val(p + e * v) - val(p - e * v)) / (2 * e)

    d1, d2 = cd(eps), cd(eps / 2)
    fd = (4 * d2 - d1) / 3
    ad = float(torch.sum(g * v))
    return {"ad": ad, "fd": fd, "rel_err": abs(ad - fd) / abs(fd), "forward_walls_s": walls}


def _value_grad(loss, p):
    """``(loss value, gradient, wall, diff_field and axis_stencil launches)``
    of one reverse pass, ending in a synchronize."""
    import torch

    from pyapes_tpu_torch.ops import axis_stencil as ax_mod
    from pyapes_tpu_torch.ops import diff_field as df_mod

    c0 = (df_mod.diff_field.launches, ax_mod.axis_stencil.launches)
    torch.cuda.synchronize()
    tic = time.perf_counter()
    q = p.detach().clone().requires_grad_(True)
    val = loss(q)
    (g,) = torch.autograd.grad(val, q)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    return (float(val.detach()), g, wall, {"diff_field": df_mod.diff_field.launches - c0[0],
                                  "axis_stencil": ax_mod.axis_stencil.launches - c0[1]})


def _busy(fn) -> dict:
    """The unprofiled wall of ``fn()`` and the device's busy time over a
    profiled second call (the sum of its kernels, memory copies and sets:
    one stream, so they never overlap); ``idle_share`` is ``1 - busy /
    wall``, or None when the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    tic = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy_us = 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy_us += getattr(e, "self_device_time_total", None) or getattr(
                e, "self_cuda_time_total", 0.0)
    busy = busy_us / 1e6
    return {"wall_s": wall, "device_busy_s": busy,
            "idle_share": 1.0 - busy / wall if busy > 0 else None}


def inversion_cell(dev, n: int = ADJ_N):
    """(a)'s problem: ``DifferentiableDiffusionSolve`` on the n^3 f64 unit
    box, homogeneous Dirichlet faces, ``symmetric=True``, tol 1e-8; Γ the
    inclusion field of ``demos/darcy_inversion.py`` lifted to 3-D (a
    sphere of Γ 0.25, radius 0.18 at (0.6, 0.45, 0.5), in a background of
    1); a uniform injection. ``(mesh, dsolve, misfit(theta = log Γ),
    theta0)``:
    the misfit of the pressure on every 4th interior node against the
    true Γ's."""
    import torch

    from pyapes_tpu_torch.solver.adjoint import DifferentiableDiffusionSolve

    mesh = _adj_mesh(dev, n)
    dsolve = DifferentiableDiffusionSolve(mesh, _adj_bcs(mesh, ["dirichlet"] * 6), tol=ADJ_TOL,
                                          symmetric=True)
    X, Y, Z = mesh.grid
    k_true = torch.where((X - 0.6) ** 2 + (Y - 0.45) ** 2 + (Z - 0.5) ** 2 < 0.18**2, 0.25,
                         1.0).to(torch.float64)
    rhs = torch.ones((1, n, n, n), dtype=torch.float64, device=mesh.device)
    s = ADJ_SENSOR_STRIDE
    sensors = torch.zeros((1, n, n, n), dtype=torch.float64, device=mesh.device)
    sensors[:, s:-s:s, s:-s:s, s:-s:s] = 1.0
    with torch.no_grad():
        p_obs = dsolve(k_true.contiguous(), rhs) * sensors

    def misfit(theta):
        return torch.sum((dsolve(torch.exp(theta), rhs) * sensors - p_obs) ** 2)

    return mesh, dsolve, misfit, torch.zeros_like(k_true).contiguous()


def run_inversion_cell(dev, n: int = ADJ_N) -> dict:
    """(a): the gradient's directional check at Γ = 1, the walls (forward:
    the check's four solves; value and gradient: the median of the 3 Adam
    steps after the warm-up), itr forward and adjoint, the ``diff_field``
    launches of each gradient (forward itr + adjoint itr + at most 4), peak
    memory, ``ADJ_ADAM`` Adam steps (lr 0.05; the misfit below its start
    after them), the Γ-gradient pass alone (CUDA events), and the device's
    idle share over one forward solve here and at 128^3."""
    import torch

    mesh, dsolve, misfit, theta = inversion_cell(dev, n)
    label = f"adjoint (a) {n}^3 f64 inversion gradient"
    torch.cuda.reset_peak_memory_stats()
    l0, g0, warm_s, warm_launch = _value_grad(misfit, theta)
    peak = torch.cuda.max_memory_allocated() / 2**30
    itr0 = dict(dsolve.itr)
    check = _directional(misfit, theta, g0, _smooth(mesh))
    if not check["rel_err"] <= ADJ_DIR_TOL:
        raise RuntimeError(f"chip_smoke: {label}: <g, v> {check['ad']!r} against the "
                           f"differences {check['fd']!r}: rel err {check['rel_err']:.3e}")
    param = theta.clone().requires_grad_(True)
    opt = torch.optim.Adam([param], lr=0.05)
    param.grad = g0.clone()
    opt.step()
    losses, walls, launches, itrs = [l0], [], [warm_launch], [itr0]
    for _ in range(ADJ_ADAM - 1):
        val, g, wall, lc = _value_grad(misfit, param.detach())
        losses.append(val)
        walls.append(wall)
        launches.append(lc)
        itrs.append(dict(dsolve.itr))
        param.grad = g
        opt.step()
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"chip_smoke: {label}: the misfit did not fall: {losses}")
    for lc, it in zip(launches, itrs):
        extra = lc["diff_field"] - it["forward"] - it["adjoint"]
        if lc["diff_field"] == 0 or not 0 <= extra <= 4:
            raise RuntimeError(f"chip_smoke: {label}: {lc['diff_field']} diff_field launches "
                               f"for itr {it}")
    if not bool(g0.isfinite().all()) or tuple(g0.shape) != (n, n, n):
        raise RuntimeError(f"chip_smoke: {label}: the gradient is not finite of shape {n}^3")
    from pyapes_tpu_torch.solver.adjoint import diff_field_gamma_vjp

    mu, xm = torch.randn_like(g0)[None], torch.randn_like(g0)[None]
    gamma_grad_ms = _time_ms(lambda: diff_field_gamma_vjp(
        mu, xm, g0, dsolve._inv_dx2, dsolve._surgery, dsolve.avg), reps=5)
    del mu, xm
    busy = _busy(lambda: misfit(theta).item())
    _, dsolve_v, misfit_v, theta_v = inversion_cell(dev, ADJ_N_VARIANT)
    busy_v = _busy(lambda: misfit_v(theta_v).item())
    fw = check.pop("forward_walls_s")
    return {"n": n, "dtype": "float64", "tol": ADJ_TOL, "directional": check,
            "forward_wall_s_median": statistics.median(fw), "forward_walls_s": fw,
            "value_and_grad_wall_s_median": statistics.median(walls),
            "value_and_grad_walls_s": walls, "warm_up_value_and_grad_s": warm_s,
            "itr": itrs, "launches_per_gradient": launches, "peak_mem_gib": peak,
            "adam_misfit": losses, "gamma_gradient_pass_ms": gamma_grad_ms,
            "forward_solve_busy": busy,
            f"forward_solve_busy_{ADJ_N_VARIANT}": {**busy_v, "itr": dict(dsolve_v.itr)}}


def run_adjoint_variants(dev, n: int = ADJ_N_VARIANT) -> dict:
    """(b) the Neumann and harmonic variant of (a)'s problem (Neumann on
    the x-lower and y-upper faces: BiCGSTAB, the hand transpose in the
    adjoint), (c) ``DifferentiableSolve`` on the implicit
    advection-diffusion step of ``tests/test_adjoint.py`` lifted to n^3
    (the axis stencil's plane march, the transposed coefficients in the
    adjoint; checks along ``rhs`` and along axis 1's ``ap``), (d)
    ``DifferentiableTransient``: 4 heat steps, the gradient with
    ``checkpoint`` on and off (1e-12) and the peak memory of each."""
    import numpy as np
    import torch

    from pyapes_tpu_torch.ops.stencil import div_axis_coeffs, laplacian_axis_coeffs
    from pyapes_tpu_torch.solver.adjoint import (
        DifferentiableDiffusionSolve,
        DifferentiableSolve,
        DifferentiableTransient,
    )

    out = {}
    mesh = _adj_mesh(dev, n)
    X, Y, Z = mesh.grid
    dev_t = mesh.device

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev_t)

    # (b)
    bcs = _adj_bcs(mesh, ["neumann", "dirichlet", "dirichlet", "neumann", "dirichlet",
                          "dirichlet"])
    ds = DifferentiableDiffusionSolve(mesh, bcs, tol=ADJ_VARIANT_TOL, avg="harmonic")
    k_true = torch.where((X - 0.6) ** 2 + (Y - 0.45) ** 2 + (Z - 0.5) ** 2 < 0.18**2, 0.25,
                         1.0).to(torch.float64)
    rhs = torch.ones((1, n, n, n), dtype=torch.float64, device=dev_t)
    with torch.no_grad():
        obs = ds(k_true.contiguous(), rhs)

    def misfit(theta):
        return torch.sum((ds(torch.exp(theta), rhs) - obs) ** 2)

    theta = torch.zeros((n, n, n), dtype=torch.float64, device=dev_t)
    _, g, wall, lc = _value_grad(misfit, theta)
    check = _directional(misfit, theta, g, _smooth(mesh))
    out["b_neumann_harmonic"] = {"value_and_grad_wall_s": wall, "itr": dict(ds.itr),
                                 "launches_per_gradient": lc, **check}
    # (c)
    dbcs = _adj_bcs(mesh, ["dirichlet"] * 6)
    nu, u, dt = 0.05, 1.0, 0.1
    lap = laplacian_axis_coeffs(mesh, dbcs)
    div = div_axis_coeffs(mesh, dbcs, u, "none")
    coeffs = [[t(div[j][k] - nu * lap[j][k] + (1.0 / dt if (j, k) == (0, 1) else 0.0))
               for k in range(3)] for j in range(3)]
    dsolve = DifferentiableSolve(mesh, dbcs, tol=ADJ_TRANSPORT_TOL)
    c0 = t(np.random.default_rng(8).standard_normal((1, n, n, n)))

    def step_loss(c, cs=coeffs):
        return torch.sum((dsolve(cs, c / dt) - 0.3) ** 2)

    _, g, wall, lc = _value_grad(step_loss, c0)
    # the loss is quadratic in c: the differences are exact at any step,
    # and a long one keeps the solves' tolerance out of the derivative
    chk_rhs = _directional(step_loss, c0, g, _smooth(mesh, (1, n, n, n)), eps=0.5)
    ap1 = coeffs[1][0]
    v_ap = torch.sin(pi * mesh.x[1]) * ap1.abs().max()

    def with_ap(a):
        return [coeffs[0], [a, coeffs[1][1], coeffs[1][2]], coeffs[2]]

    # the coefficient: a misfit against the state of a perturbed ap (the
    # JAX test's loss would drown it likewise)
    with torch.no_grad():
        c_obs = dsolve(with_ap(ap1 + 0.1 * v_ap), c0 / dt)

    def coeff_loss(a):
        return torch.sum((dsolve(with_ap(a), c0 / dt) - c_obs) ** 2)

    _, g_ap, _, lc_ap = _value_grad(coeff_loss, ap1)
    chk_ap = _directional(coeff_loss, ap1, g_ap, v_ap, eps=1e-4)
    out["c_transport_step"] = {"value_and_grad_wall_s": wall, "itr": dict(dsolve.itr),
                               "launches_per_gradient": lc, "along_rhs": chk_rhs,
                               "along_ap_axis1": chk_ap, "launches_ap_gradient": lc_ap}
    # (d)
    lap_t = [[t(c) for c in cs] for cs in lap]
    x0 = t(np.random.default_rng(3).standard_normal((1, n, n, n)))
    target = (torch.sin(pi * X) * torch.sin(pi * Y) * torch.sin(pi * Z))[None]
    grads, peaks = {}, {}
    for ck in (False, True):
        roll = DifferentiableTransient(
            mesh, dbcs, lambda v: tuple((-v * ap, -v * ac, -v * am) for ap, ac, am in lap_t),
            dt=0.02, checkpoint=ck)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _, g, wall, _ = _value_grad(
            lambda v: torch.sum((roll(v, x0, ADJ_TRANSIENT_STEPS) - target) ** 2),
            torch.tensor(0.05, dtype=torch.float64, device=dev_t))
        peaks["on" if ck else "off"] = (torch.cuda.max_memory_allocated() - base) / 2**30
        grads["on" if ck else "off"] = float(g)
    rel = abs(grads["on"] - grads["off"]) / abs(grads["off"])
    out["d_transient"] = {"steps": ADJ_TRANSIENT_STEPS, "grad": grads, "rel_diff": rel,
                          "peak_above_start_gib": peaks,
                          "peak_on_below_off": peaks["on"] < peaks["off"]}
    for name, chk in (("b", out["b_neumann_harmonic"]), ("c rhs", chk_rhs), ("c ap", chk_ap)):
        chk.pop("forward_walls_s", None)
        if not chk["rel_err"] <= ADJ_DIR_TOL:
            raise RuntimeError(f"chip_smoke: adjoint ({name}) {n}^3: <g, v> {chk['ad']!r} "
                               f"against {chk['fd']!r}: rel err {chk['rel_err']:.3e}")
    if lc["axis_stencil"] == 0 or out["b_neumann_harmonic"]["launches_per_gradient"][
            "diff_field"] == 0:
        raise RuntimeError(f"chip_smoke: adjoint variants: a gradient launched no kernel: {out}")
    if not rel <= 1e-12:
        raise RuntimeError(f"chip_smoke: adjoint (d): checkpoint on {grads['on']!r} off "
                           f"{grads['off']!r} (rel {rel:.3e})")
    return out


def _adj_cmp_case(kind: str, dev, dims: int, n: int = ADJ_CMP_N):
    """``(forward(param) -> solution, param0, weight)`` of one adjoint class
    on an n^dims f64 box; the same seeded inputs on every device."""
    import numpy as np
    import torch

    from pyapes_tpu_torch.ops.stencil import laplacian_axis_coeffs
    from pyapes_tpu_torch.solver.adjoint import (
        DifferentiableDiffusionSolve,
        DifferentiableSolve,
        DifferentiableTransient,
        DifferentiableTransientDiffusion,
    )

    mesh = _adj_mesh(dev, n, dims)
    rng = np.random.default_rng(11 + dims)
    shape = (1,) + (n,) * dims

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=mesh.device)

    rhs, weight = t(rng.standard_normal(shape)), t(rng.standard_normal(shape))
    gamma = t(1.0 + 0.5 * rng.random(shape[1:]))
    dirichlet = _adj_bcs(mesh, ["dirichlet"] * 2 * dims)
    lap = [[t(c) for c in cs] for cs in laplacian_axis_coeffs(mesh, dirichlet)]
    if kind == "solve":
        ds = DifferentiableSolve(mesh, dirichlet, tol=1e-12)
        cs = [(ap, ac + (20.0 if j == 0 else 0.0), am - 3.0 * ap) for j, (ap, ac, am) in
              enumerate(lap)]
        return (lambda b: ds(cs, b)), rhs, weight
    if kind == "diffusion":
        ds = DifferentiableDiffusionSolve(mesh, dirichlet, tol=1e-12, symmetric=True)
        return (lambda g: ds(g, rhs)), gamma, weight
    if kind == "diffusion_neumann":
        kinds = ["neumann", "dirichlet", "dirichlet", "neumann", "dirichlet", "dirichlet"]
        ds = DifferentiableDiffusionSolve(mesh, _adj_bcs(mesh, kinds[:2 * dims]), tol=1e-12,
                                          avg="harmonic")
        return (lambda g: ds(g, rhs)), gamma, weight
    if kind == "transient":
        roll = DifferentiableTransient(
            mesh, dirichlet, lambda v: tuple((-v * ap, -v * ac, -v * am) for ap, ac, am in lap),
            dt=0.02, tol=1e-12)
        return (lambda v: roll(v, rhs, 3)), t(0.05), weight
    roll = DifferentiableTransientDiffusion(mesh, dirichlet, dt=0.02, tol=1e-12)
    return (lambda g: roll(g, rhs, 3)), gamma, weight


ADJ_CMP_KINDS = ("solve", "diffusion", "diffusion_neumann", "transient", "transient_diffusion")


def adjoint_card_vs_cpu(dev) -> dict:
    """(e): each adjoint class on the card against the CPU at 17^2 and
    17^3 f64: the solution within 1e-10 and the gradient of ``sum(w x) +
    sum(x^2)`` within 1e-9, relative to the largest entry."""
    import torch

    def run(kind, d, dims):
        forward, p0, w = _adj_cmp_case(kind, d, dims)
        p = p0.detach().clone().requires_grad_(True)
        x = forward(p)
        (g,) = torch.autograd.grad(torch.sum(w * x) + torch.sum(x * x), p)
        return x.detach().cpu(), g.cpu()

    worst = {}
    for dims in (2, 3):
        for kind in ADJ_CMP_KINDS:
            xc, gc = run(kind, torch.device("cpu"), dims)
            xg, gg = run(kind, dev, dims)
            rx = float((xg - xc).abs().max() / xc.abs().max())
            rg = float((gg - gc).abs().max() / gc.abs().max())
            worst[f"{kind} {dims}-D"] = (rx, rg)
            if not (rx <= ADJ_CMP_TOL[0] and rg <= ADJ_CMP_TOL[1]):
                raise RuntimeError(f"chip_smoke: adjoint (e) {kind} {dims}-D: the card differs "
                                   f"from the CPU: solution {rx:.3e}, gradient {rg:.3e}")
    return worst


def run_checkpoint_cell(dev, tmp: str, n: int = ADJ_CKPT_N, k: int = ADJ_CKPT_STEPS) -> dict:
    """(f): the cavity at n^3 f32, fused: 2k steps straight against k
    steps, a checkpoint, a load into a fresh model and k more steps, bit
    for bit, through ``save``/``load`` and through ``save_orbax(block=
    False)``/``wait_for_checkpoints``/``load_orbax``; then ``write_vtk``
    of the final fields and ``read_vtk``, equal in f32."""
    import os

    import numpy as np
    import torch

    from pyapes_tpu_torch.utils import checkpoint
    from pyapes_tpu_torch.utils.io import read_vtk, write_vtk

    def model():
        return cavity_model(dev, n)[0]

    ref = model()
    ref.model.run(ref.dt, 2 * k, fused=True)
    want = [f().clone() for f in ref.model.state_fields()]
    out = {}
    for how in ("npz", "orbax"):
        a = model()
        a.model.run(a.dt, k, fused=True)
        fields = a.model.vel + [a.model.p]
        path = os.path.join(tmp, f"cavity_{how}")
        tic = time.perf_counter()
        if how == "npz":
            checkpoint.save(path, fields)
        else:
            checkpoint.save_orbax(path, fields, block=False)
        save_s = time.perf_counter() - tic
        a.model.run(a.dt, 1, fused=True)  # writes the live state after the save
        checkpoint.wait_for_checkpoints()
        b = model()
        fields_b = b.model.vel + [b.model.p]
        (checkpoint.load if how == "npz" else checkpoint.load_orbax)(path, fields_b)
        b.model.t = max(float(f._t) for f in fields_b)
        b.model.run(b.dt, k, fused=True)
        same = all(torch.equal(w, f()) for w, f in zip(want, b.model.state_fields()))
        out[how] = {"save_call_s": save_s, "bit_equal": same,
                    "captures_after_load": b.model.fused_runner().captures}
        if not same:
            raise RuntimeError(f"chip_smoke: adjoint (f) {how}: the resumed fused cavity "
                               "differs from the straight run")
    fields = {f.name: f()[0] for f in ref.model.vel}
    fields["p"] = ref.model.p()[0]
    tic = time.perf_counter()
    vtk = write_vtk(os.path.join(tmp, "cavity"), ref.model.mesh, fields)
    out["write_vtk_s"] = time.perf_counter() - tic
    back = read_vtk(vtk)["fields"]
    for name, f in fields.items():
        if not np.array_equal(back[name], f.float().cpu().numpy()):
            raise RuntimeError(f"chip_smoke: adjoint (f): VTK field {name} differs")
    return out


def phase_adjoint(dev) -> dict:
    """Phase 15 (module docstring): (a) is the path whose launches count;
    (b)-(f) follow it; (f)'s files go to a temporary directory under the
    checkout's ``build/``."""
    import tempfile

    from pyapes_tpu_torch.ops.cuda_build import BUILD_DIR

    _reset_counts()
    cell = run_inversion_cell(dev)
    counts = _counts()
    print(f"[15 adjoint] (a) {json.dumps(cell)}", flush=True)
    variants = run_adjoint_variants(dev)
    print(f"[15 adjoint] (b)-(d) {json.dumps(variants)}", flush=True)
    print(f"[15 adjoint] (e) card against CPU (solution, gradient rel): "
          f"{json.dumps(adjoint_card_vs_cpu(dev))}", flush=True)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        print(f"[15 adjoint] (f) {json.dumps(run_checkpoint_cell(dev, tmp))}", flush=True)
    return counts


FD_OPTS_CELLS = (("highest", None), ("default", {"precision": "default"}),
                 ("bf16 factors", {"dtype": "bfloat16"}))
TRACE_KERNEL = "axis_march"  # (c): a trace of a fastdiag solve must name it
# The direct narrow-precision fastdiag solves at 512^3 stop at their
# refinement's floor above FD_TOL (the stall exit). Limits (first pass,
# floor) from the card's readings with a ~3x margin (NVIDIA H100 80GB HBM3,
# 700 W: TF32 2.99e-3 then 2.70e-6, bf16 factors 3.36e-2 then 1.79e-3, 3
# passes each), and at most FD_NARROW_PASSES passes.
FD_NARROW_LIMITS = {"default": (1e-2, 1e-5), "bf16 factors": (0.1, 6e-3)}
FD_NARROW_PASSES = 5
# The rounding models of each cell's GEMMs (``_round``), and the class of
# its GEMM kernels by name: FFMA for "highest", tensor-op TF32 (s1688) or
# bf16 for the narrow ones.
FD_MODELS = {"highest": ("f32",), "default": ("tf32_rne", "tf32_rna", "tf32_rz"),
             "bf16 factors": ("bf16",)}
FD_GEMM_CLASS = {"highest": r"^(?!.*(tensorop|tf32|bf16)).*(ffma|simt|sgemm)",
                 "default": r"^(?!.*bf16).*(tensorop_s1688|tf32)",
                 "bf16 factors": r"bf16.*(tensorop|s16816)"}
# Each transform stage of the port (one axis' GEMM, identities on the
# others) against its rounding model: within 0.25 of its distance from the
# unrounded ("f32") stage for a narrow cell; "highest" within 1e-4 of the
# stage's norm (f32 sums in another order). The tensor cores add their
# products in their own order and rounding, so on the card the
# round-to-nearest models read 0.08-0.10 (TF32) and 0.03 (bf16); a model
# that is not the card's reads ~1 or more (truncation 3.6; no rounding 1
# by definition) (NVIDIA H100 80GB HBM3, 700 W). A whole solve is not
# compared element by element: its intermediate sums, added in another
# order, round to other narrow values wherever they cancel. The
# refinement is held to the emulated one instead: as many passes, each
# pass's residual within 1.25x.
EMUL_MODEL = 0.25
EMUL_F32 = 1e-4
EMUL_FLOOR = 1.25


class _PathSolver:
    """``_path_problem``'s problem with a solve from a given (zero) guess:
    ``solve(cfg, rhs=, coeff=, x0=)`` returns the report; the solution is
    ``self.var()``. The kernel launches of every solve, a raising one
    included, add into ``tally`` (a Counter)."""

    def __init__(self, dev, n: int, tally, darcy: bool = False):
        self.mesh, self.var, self.rhs, self.coeff = _path_problem(dev, n, darcy)
        self.tally = tally

    def solve(self, cfg, rhs=None, coeff=None, x0=None):
        import torch

        from pyapes_tpu_torch.solver.fdm import FDM
        from pyapes_tpu_torch.solver.ops import Solver

        s = Solver({"fdm": cfg})
        self.var.set_var_tensor(torch.zeros_like(self.var()) if x0 is None else x0)
        s.set_eq(FDM().laplacian(self.coeff if coeff is None else coeff, self.var)
                 == (self.rhs if rhs is None else rhs))
        before = _counts()
        try:
            return s.solve()
        finally:
            after = _counts()
            self.tally.update({k: after[k] - before[k] for k in after})


@contextlib.contextmanager
def _first_fd_solve():
    """Within: the first ``FastDiag.solve`` call is recorded in the dict
    yielded: its factors' object (``fd``), ``r``, ``c_ax``, ``c_dt`` and
    ``pseudo``."""
    from pyapes_tpu_torch.solver.fastdiag import FastDiag

    real, seen = FastDiag.solve, {}

    def solve(self, r, c_ax, c_dt=0.0, pseudo=False):
        out = real(self, r, c_ax, c_dt, pseudo)
        if not seen:
            seen.update(fd=self, r=r.clone(), c_ax=c_ax, c_dt=c_dt, pseudo=pseudo)
        return out

    FastDiag.solve = solve
    try:
        yield seen
    finally:
        FastDiag.solve = real


def _round(t, model: str):
    """``t`` (float32) as a GEMM operand under ``model``: "f32" as it is,
    "tf32_rne" / "tf32_rna" / "tf32_rz" cut to TF32's 10-bit mantissa to
    nearest with ties to even / ties away / by truncation, "bf16" rounded
    to bfloat16 (to nearest even)."""
    import torch

    if model == "f32":
        return t
    if model == "bf16":
        return t.bfloat16().float()
    i = t.contiguous().view(torch.int32)
    if model == "tf32_rne":
        i = i + (0xFFF + ((i >> 13) & 1))
    elif model == "tf32_rna":
        i = i + 0x1000
    return (i & ~0x1FFF).view(torch.float32)


def _emulated_transform(mats, x, model: str):
    """``FastDiag._transform``'s contraction of mesh axis j of ``x``
    (``(1, *shape)``) with ``mats[j]``, written as f32 ``tensordot``s (TF32
    off: FFMA) on operands rounded by ``model``; with "bf16" each stage's
    output is rounded to bf16 too (the JAX package's ``_transform``)."""
    import torch

    for j, F in enumerate(mats):
        x = torch.tensordot(_round(F.float(), model), _round(x, model), dims=([1], [j + 1]))
        x = torch.movedim(x, 0, j + 1)
        if model == "bf16":
            x = _round(x, model)
    return x.contiguous()


def _emulated_fd_solve(fd, r, c_ax, c_dt, model: str):
    """``FastDiag.solve`` (nonsingular) in plain PyTorch under the rounding
    ``model``: forward transforms, the f32 symbol divide, inverse
    transforms; f32 out."""
    y = _emulated_transform(fd.fwd, r.float(), model)
    lam = fd.lams[0].reshape(-1, 1, 1) + fd.lams[1].reshape(1, -1, 1)
    lam = lam + fd.lams[2].reshape(1, 1, -1)
    y = y / (c_ax * lam + c_dt)[None]
    return _emulated_transform(fd.inv, y, model)


def _emulated_refinement(seen, plain_A, rhs, model: str, tol: float, max_it: int) -> list:
    """The fastdiag refinement (``x += FD(b - A x)`` from zero on the
    all-Dirichlet interior, the plain f32 operator) with
    ``_emulated_fd_solve`` under ``model`` and the loop's exits (the
    tolerance, ``max_it``, a pass contracting less than 2x); returns the
    relative residual after each pass."""
    import torch

    inner = (slice(None), slice(1, -1), slice(1, -1), slice(1, -1))
    x = torch.zeros_like(rhs)
    r0 = rhs[inner].norm()
    r, hist, prev = rhs[inner], [], 1.0
    while len(hist) < max_it:
        x[inner] += _emulated_fd_solve(seen["fd"], r.contiguous(), seen["c_ax"], seen["c_dt"],
                                       model)
        r = (rhs - plain_A(x, torch.float32))[inner]
        t = (r.norm() / r0).item()
        hist.append(t)
        if t <= tol or t > 0.5 * prev:
            break
        prev = t
    return hist


def _stage_errors(fd, r, models) -> dict:
    """Per model, the largest over the mesh axes j of the port's
    ``FastDiag._transform`` of ``r`` through ``fd.fwd[j]`` alone (exact
    identities on the other axes) against ``_emulated_transform`` under the
    model, relative to the port's distance from the unrounded stage (for
    the "f32" model: to the stage's norm)."""
    import torch

    worst = dict.fromkeys(models, 0.0)
    x = r.to(fd.fwd[0].dtype)
    for j in range(fd.ndim):
        mats = [F if k == j else torch.eye(F.shape[0], dtype=F.dtype, device=F.device)
                for k, F in enumerate(fd.fwd)]
        port = fd._transform(mats, x).float()
        exact = _emulated_transform(mats, x.float(), "f32")
        for m in models:
            d = (port - _emulated_transform(mats, x.float(), m)).norm()
            ref = exact.norm() if m == "f32" else (port - exact).norm()
            worst[m] = max(worst[m], (d / ref).item())
    return worst


def _check_fd_cell(label, rep, seen, gemm_names, fd, cfg) -> dict:
    """(a)'s checks of one ``fd_opts`` cell beyond the tolerance: its GEMM
    kernels' class; for a narrow cell ``FD_NARROW_LIMITS``; each transform
    stage against the rounding models (``_stage_errors``) and, for a narrow
    cell, its refinement against the emulated one under the closest model.
    Returns the readings."""
    import re

    if not gemm_names or not all(re.search(FD_GEMM_CLASS[label], k, re.I) for k in gemm_names):
        raise RuntimeError(f"chip_smoke: fastdiag {label}: GEMM kernels {gemm_names} are not "
                           f"all of the class {FD_GEMM_CLASS[label]!r}")
    hist = [float(h) for h in rep["history"]]
    if label in FD_NARROW_LIMITS:
        first, floor = FD_NARROW_LIMITS[label]
        if not (hist[0] <= first and rep["tol"] <= floor and rep["itr"] <= FD_NARROW_PASSES):
            raise RuntimeError(f"chip_smoke: direct fastdiag {label}: history {hist} outside "
                               f"(first pass <= {first}, floor <= {floor}, passes <= "
                               f"{FD_NARROW_PASSES})")
    if seen.get("pseudo") or seen["fd"].ndim != 3:
        raise RuntimeError(f"chip_smoke: fastdiag {label}: not the 3-D nonsingular eigen-solve")
    stage = _stage_errors(seen["fd"], seen["r"], FD_MODELS[label])
    best = min(stage, key=stage.get)
    limit = EMUL_F32 if label == "highest" else EMUL_MODEL
    row = {"stage_model_err": stage, "model": best}
    if not stage[best] <= limit:
        raise RuntimeError(f"chip_smoke: fastdiag {label}: a transform stage is off every "
                           f"rounding model: {stage}, limit {limit}")
    if label in FD_NARROW_LIMITS:
        emul = _emulated_refinement(seen, _plain_operator(fd.mesh, fd.var, fd.coeff), fd.rhs,
                                    best, cfg["tol"], cfg["max_it"])
        row["emulated_history"] = emul
        if not (len(emul) == len(hist) and all(
                a / EMUL_FLOOR <= b <= a * EMUL_FLOOR for a, b in zip(emul, hist))):
            raise RuntimeError(f"chip_smoke: fastdiag {label}: the refinement {hist} is not the "
                               f"emulated one {emul} (within {EMUL_FLOOR}x, as many passes)")
    return row


def _gemm_device_ms(prof) -> tuple[float, list]:
    """Device ms of a profile's GEMM kernels (cuBLAS / CUTLASS names) and
    their names."""
    import re

    from torch.autograd import DeviceType

    total, names = 0.0, []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and re.search(r"gemm|xmma|cutlass", e.key, re.I):
            total += getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
            names.append(e.key)
    return total / 1e3, names


def _expect_nan_error(fn, label: str):
    """Run ``fn``; it must raise ``NaNError`` (not the end-of-solve check).
    Returns the operation it names."""
    from pyapes_tpu_torch.utils.debug import NaNError

    try:
        fn()
    except NaNError as e:
        return e.op
    raise RuntimeError(f"chip_smoke: {label}: the checked solve did not raise NaNError")


def phase_utilities(dev) -> dict:
    """Phase 16 (module docstring). Returns the launches of its solves."""
    import collections
    import os
    import tempfile

    import torch

    from pyapes_tpu_torch.ops.axis_stencil import axis_stencil
    from pyapes_tpu_torch.ops.cuda_build import BUILD_DIR
    from pyapes_tpu_torch.utils import profile

    _reset_counts()
    solves = collections.Counter()
    out = {}
    # (a) fd_opts, and (c)'s trace on the "highest" solve
    fd = _PathSolver(dev, N_MAIN, solves)
    sols = {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        for label, opts in FD_OPTS_CELLS:
            cfg = {**fd_cfg(), "history": True, **({"fd_opts": opts} if opts else {})}
            with _first_fd_solve() as seen:
                fd.solve(cfg)  # the factors, built once
            ms = _time_ms(lambda: fd.solve(cfg), reps=5)
            rep = fd.solve(cfg)
            sols[label] = fd.var().clone()
            res32, res64 = _true_residuals(fd.mesh, fd.var, fd.rhs, fd.coeff, sols[label])
            logdir = os.path.join(tmp, label.replace(" ", "_"))
            with profile.trace(logdir) as prof:
                fd.solve(cfg)
            gemm_ms, gemm_names = _gemm_device_ms(prof)
            row = {"itr": rep["itr"], "tol": rep["tol"], "converge": rep["converge"],
                   "history": [float(h) for h in rep["history"]],
                   "true_rel_residual_f32": res32, "true_rel_residual_f64": res64,
                   "wall_ms": ms, "gemm_device_ms": gemm_ms,
                   "gemm_kernels": sorted(set(gemm_names))}
            row.update(_check_fd_cell(label, rep, seen, sorted(set(gemm_names)), fd, cfg))
            del seen
            if opts:
                # the same eigen-solve as CG's preconditioner (the JAX package's
                # remedy for the refinement's stall at a narrow transform's floor)
                kcfg = {**mg_cfg({}), "precond": "fd", "fd_opts": opts}
                del kcfg["mg_opts"]
                fd.solve(kcfg)
                kms = _time_ms(lambda: fd.solve(kcfg), reps=3)
                krep = fd.solve(kcfg)
                k32, k64 = _true_residuals(fd.mesh, fd.var, fd.rhs, fd.coeff, fd.var())
                row["cg_fd"] = {"itr": krep["itr"], "tol": krep["tol"], "wall_ms": kms,
                                "true_rel_residual_f32": k32, "true_rel_residual_f64": k64}
            out[f"fd {label}"] = row
            print(f"[16 fd_opts {label}] {json.dumps(row)}", flush=True)
            if not opts and not (rep["converge"] and res32 <= FD_TOL):
                raise RuntimeError(f"chip_smoke: fastdiag {label}: {rep}, true residual "
                                   f"{res32:.3e} > {FD_TOL}")
            if opts and not (krep["converge"] and k64 <= 1e-5):
                raise RuntimeError(f"chip_smoke: CG + FD preconditioner, {label}: {krep}, true "
                                   f"residual (f64) {k64:.3e} > 1e-5")
            if label == "highest":
                files = [os.path.join(logdir, f) for f in os.listdir(logdir)]
                with open(files[0]) as fh:
                    in_file = TRACE_KERNEL in fh.read()
                in_prof = any(TRACE_KERNEL in e.key for e in prof.key_averages())
                if not (len(files) == 1 and in_file and in_prof):
                    raise RuntimeError(f"chip_smoke: trace() of a fastdiag solve: {files}, "
                                       f"{TRACE_KERNEL} in the file {in_file}, in the profile "
                                       f"{in_prof}")
                out["trace"] = {"file_bytes": os.path.getsize(files[0]), TRACE_KERNEL: True}
    if torch.equal(sols["default"], sols["highest"]):
        raise RuntimeError("chip_smoke: fd_opts precision 'default' gave 'highest''s bits: "
                           "no TF32 transform ran")
    _check_full_precision()

    # (c) the other profile utilities, on the same problem
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile.SolveTimer() as st:
        start.record()
        fd.solve(fd_cfg())
        end.record()
    ev_ms = start.elapsed_time(end)
    if not st.elapsed * 1e3 >= ev_ms:
        raise RuntimeError(f"chip_smoke: SolveTimer {st.elapsed * 1e3:.3f} ms < its CUDA-event "
                           f"time {ev_ms:.3f} ms")
    bw = profile.measure_achievable_bw()
    x = fd.var()
    coeffs = tuple(tuple(torch.randn(N_MAIN, device=dev) for _ in range(3)) for _ in range(3))
    before = _counts()
    apply_ms = _time_ms(lambda: axis_stencil(coeffs, x))
    after = _counts()
    apart = {k: after[k] - before[k] for k in after}  # the apply's launches: not a path's
    out["profile"] = {"solve_timer_ms": st.elapsed * 1e3, "solve_event_ms": ev_ms,
                      "achievable_gbps": bw, "nominal_gbps": profile.H100_HBM_GBPS,
                      "axis_stencil_512_ms": apply_ms,
                      "axis_stencil_512_report": profile.bandwidth_report(
                          (N_MAIN,) * 3, apply_ms / 1e3, achievable_gbps=bw)}
    print(f"[16 profile] {json.dumps(out['profile'])}", flush=True)

    # (d) donate: the peak of one 512^3 solve, with and without
    peaks, don = {}, {}
    for donate in (False, True):
        cfg = {**fd_cfg(), "donate": donate}
        x0 = torch.zeros_like(fd.var())
        fd.var.set_var_tensor(x0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fd.solve(cfg, x0=x0)
        torch.cuda.synchronize()
        peaks[donate] = (torch.cuda.max_memory_allocated(), base)
        don[donate] = (fd.var().clone(), fd.var().data_ptr() == x0.data_ptr())
        del x0
    if not (torch.equal(don[False][0], don[True][0]) and don[True][1] and not don[False][1]):
        raise RuntimeError("chip_smoke: donate changed the bits or did not use the guess")
    out["donate"] = {f"peak_gib_{k}": peaks[v][0] / 2**30
                     for k, v in (("off", False), ("on", True))}
    out["donate"].update({f"above_base_gib_{k}": (peaks[v][0] - peaks[v][1]) / 2**30
                          for k, v in (("off", False), ("on", True))})
    # the base (live tensors before the solve) differs by the clone kept
    out["donate"]["saved_gib"] = ((peaks[False][0] - peaks[False][1])
                                  - (peaks[True][0] - peaks[True][1])) / 2**30
    print(f"[16 donate] {json.dumps(out['donate'])}", flush=True)
    del fd, sols, don, x
    torch.cuda.empty_cache()

    # (b) debug: "nan" and (e) kernel, on the 256^3 V(1,1) MG-PCG
    mg = _PathSolver(dev, N_V11, solves)
    cfg = mg_cfg(V11_MG)
    mg.solve(cfg)
    plain_ms = _time_ms(lambda: mg.solve(cfg), reps=3)
    rep_u = mg.solve(cfg)
    x_u = mg.var().clone()
    chk = {**cfg, "debug": "nan"}
    checked_ms = _time_ms(lambda: mg.solve(chk), reps=3)
    rep_c = mg.solve(chk)
    if not (torch.equal(mg.var(), x_u) and rep_c == rep_u):
        raise RuntimeError(f"chip_smoke: the checked MG-PCG solve differs: {rep_c} vs {rep_u}")
    bad = mg.rhs.clone()
    n = N_V11
    bad[0, n // 2, n // 3, n // 4] = float("nan")
    op_rhs = _expect_nan_error(lambda: mg.solve(chk, rhs=bad), "MG-PCG with a NaN in rhs")
    reps = {}
    for kernel in ("auto", "pallas"):
        before = _counts()
        rep_k = mg.solve({**cfg, "kernel": kernel})
        after = _counts()
        reps[kernel] = (rep_k, mg.var().clone(), {k: after[k] - before[k] for k in after})
    if not (reps["auto"][0] == reps["pallas"][0] and torch.equal(reps["auto"][1], reps["pallas"][1])
            and reps["auto"][2] == reps["pallas"][2]):
        raise RuntimeError(f"chip_smoke: kernel 'pallas' differs from 'auto': {reps['auto'][2]} "
                           f"vs {reps['pallas'][2]}")
    try:
        mg.solve({**cfg, "kernel": "jnp"})
        raise RuntimeError("chip_smoke: kernel 'jnp' did not raise")
    except NotImplementedError:
        pass
    out["kernel"] = {"pallas_equals_auto": True, "jnp": "NotImplementedError",
                     "launches_per_solve": {k: c for k, c in reps["pallas"][2].items() if c}}
    del mg, x_u, bad, reps
    dy = _PathSolver(dev, N_DARCY, solves, darcy=True)
    g = dy.coeff.clone()
    g[N_DARCY // 2, N_DARCY // 3, N_DARCY // 4] = float("nan")
    op_gamma = _expect_nan_error(lambda: dy.solve({**darcy_cfg(), "debug": "nan"}, coeff=g),
                                 "Darcy with a NaN in Γ")
    if op_gamma not in ("diff_field", "diff_jacobi"):
        raise RuntimeError(f"chip_smoke: a NaN in Γ was first seen in {op_gamma}, not in a "
                           "variable-Γ kernel's wrapper")
    out["debug"] = {"itr": rep_c["itr"], "unchecked_ms": plain_ms, "checked_ms": checked_ms,
                    "checked_over_unchecked": checked_ms / plain_ms, "nan_rhs_op": op_rhs,
                    "nan_gamma_op": op_gamma}
    print(f"[16 debug] {json.dumps(out['debug'])}", flush=True)
    print(f"[16 kernel] {json.dumps(out['kernel'])}", flush=True)
    _check_full_precision()
    total = _counts()
    if any(total[k] != solves[k] + apart[k] for k in total):
        raise RuntimeError(f"chip_smoke: phase 16 launched {total}, its solves {dict(solves)} "
                           f"and the timed apply {apart}")
    print(f"[16 launches] solves {json.dumps({k: solves[k] for k in total})}, the timed "
          f"apply apart {json.dumps(apart)}", flush=True)
    return {k: solves[k] for k in total}


# -- phase 17: placed decompositions (blocks on their own devices) ------------

PLACED_GATE = 2  # |d itr| of (a)'s placed MG-PCG against the view-based solve
# (a): two MG-PCG solves to a 1e-6 recursive residual in f32 (bf16 cycle)
# whose dots sum in another order: max|dx| / max|x| within 1e-4
PLACED_AGREE = 1e-4
PLACED_CG_MAX_IT = 200  # (b)'s cap: both layouts stop at it (time)
# (b): the same 200 f32 CG iterations in two summation orders of the dots:
# max|dx| / max|x| within 1e-4
PLACED_CG_AGREE = 1e-4
PLACED_CMP_N = 64  # (c): 64^3 f64 (2, 2, 2) and 256^2 f64 (4, 1)
PLACED_CMP_N2 = 256
PLACED_CMP_TOL = 1e-10  # (c): the same itr, max|dx| / max|x|
PLACED_CMP_CG = {"method": "cg", "tol": 1e-8, "max_it": 2000, "criterion": "residual"}
MIXED_PAIR = ("cuda:0", "cpu")  # (c)'s placement, repeated
PLACED_FD_TURNS = 3  # (d): view-based and placed fastdiag solves in turns, one each per turn
PLACED_FD_CG_N = 256  # (e): CG with precond "fd", f32


def placed_devices(n_blocks: int) -> tuple:
    """Round robin over every card the machine shows."""
    import torch

    k = torch.cuda.device_count()
    return tuple(f"cuda:{i % k}" for i in range(n_blocks))


def placed_problem(dev, nodes, dtype: str = "single", seed: int = 0):
    """A Dirichlet Poisson problem on the unit box of ``nodes`` (2-D or 3-D)
    with a seeded random RHS on the card: ``(mesh, var, rhs)``."""
    import torch

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.variables import Field
    from pyapes_tpu_torch.variables.bcs import homogeneous_bcs

    mesh = Mesh(Box[(slice(0, 1),) * len(nodes)], None, list(nodes), device=str(dev),
                dtype=dtype)
    var = Field("p", 1, mesh, {"domain": homogeneous_bcs(len(nodes), 0.0, "dirichlet"),
                               "obstacle": None}, init_val=0.0)
    g = torch.Generator(device=mesh.device).manual_seed(seed)
    rhs = torch.randn((1, *nodes), generator=g, device=mesh.device, dtype=mesh.dtype.float)
    return mesh, var, rhs


def _sync_all() -> None:
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _placed_counters() -> dict:
    from pyapes_tpu_torch.parallel import blocks, halo
    from pyapes_tpu_torch.solver import multigrid
    from pyapes_tpu_torch.solver.linalg import dispatch

    return {**_counts(), "gathers": blocks.gathers, "exchange_bytes": halo.exchange_bytes,
            "exchange_bytes_across": halo.exchange_bytes_across,
            "placed_applies": halo.placed_applies, "vcycles": multigrid.vcycles,
            "cycle_gathers": multigrid.cycle_gathers, "fmg_gathers": multigrid.fmg_gathers,
            "operand_scatters": blocks.operand_scatters, "repartitions": blocks.repartitions,
            "repartition_bytes_across": blocks.repartition_bytes_across,
            "repartition_bytes_within": blocks.repartition_bytes_within,
            "gamma_gathers": multigrid.gamma_gathers, "host_gathers": blocks.host_gathers,
            "transfer_ghost_bytes": halo.transfer_ghost_bytes,
            "entry_scatters": dispatch.entry_scatters, "exit_gathers": dispatch.exit_gathers,
            "transfers_across": blocks.transfers_across,
            "transfer_bytes_across": blocks.transfer_bytes_across}


def _no_host_gathers(counts: dict) -> dict:
    """A timed drive's counter deltas, checked: it read no block vector on
    the host (``blocks.host_gathers``)."""
    if counts["host_gathers"]:
        raise RuntimeError(f"chip_smoke: {counts['host_gathers']} host gathers of a block vector "
                           f"in a timed drive: {json.dumps(counts)}")
    return counts


def _counted_drive(launches: dict, fn):
    """``fn()`` with the kernels' counts set to 0 just before and added to
    ``launches`` just after (a placed drive)."""
    _reset_counts()
    out = fn()
    for k, c in _counts().items():
        launches[k] = launches.get(k, 0) + c
    return out


def run_layout(var, rhs, cfg: dict, solves: int, warm: bool = True, coeff=1.0) -> dict:
    """A warm-up (``warm``) and ``solves`` timed solves of ``lap(coeff) =
    rhs`` through ``Solver.solve`` with ``cfg``: per timed solve its report, wall
    and counter deltas (launches, ``blocks.gathers``, ``exchange_bytes``,
    placed applies, V-cycles and their gathers, repartitions and their
    bytes); the last solution; the peak memory of each card over the timed
    solves."""
    import torch

    from pyapes_tpu_torch.solver.fdm import FDM
    from pyapes_tpu_torch.solver.ops import Solver

    solver = Solver({"fdm": {"report": False, **cfg}})
    fdm = FDM()
    if warm:
        solver.set_eq(fdm.laplacian(coeff, var) == rhs)
        solver.solve()
    _sync_all()
    cards = range(torch.cuda.device_count())
    for i in cards:
        torch.cuda.reset_peak_memory_stats(i)
    rows = []
    for _ in range(solves):
        var.set_var_tensor(torch.zeros_like(var()))
        solver.set_eq(fdm.laplacian(coeff, var) == rhs)
        _sync_all()
        c0 = _placed_counters()
        tic = time.perf_counter()
        rep = solver.solve()
        _sync_all()
        wall = time.perf_counter() - tic
        c1 = _placed_counters()
        rows.append({"itr": rep["itr"], "tol": rep["tol"], "converge": rep["converge"],
                     "wall_s": wall, **_no_host_gathers({k: c1[k] - c0[k] for k in c1})})
    return {"rows": rows, "x": var().clone(),
            "peak_gib": [torch.cuda.max_memory_allocated(i) / 2**30 for i in cards]}


def _ghost_bytes(ms, shape, itemsize: int) -> int:
    """Bytes of every block's ghost faces: two per cut axis, each the
    block's extent on the other axes."""
    local = [n // m for n, m in zip(shape[1:], ms)]
    per = sum(2 * shape[0] * (prod(local) // local[j]) * itemsize
              for j, m in enumerate(ms) if m > 1)
    return prod(ms) * per


def _rel(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def _handover(decomp, grid, var_gamma: bool = False) -> tuple[int, int]:
    """``(placed levels, hand-overs)`` of the multigrid hierarchy of ``grid``
    on the placed ``decomp``: the levels the placed gate takes (the
    variable-Γ one with ``var_gamma``), and 1 where a level below them runs
    on the lead device (the one gather of a V-cycle, and of Γ's sampling
    per solve), else 0. An FMG start gathers ``hand-overs * (1 + placed
    levels)``: its restriction chain's and one per V-cycle of a placed
    level."""
    from pyapes_tpu_torch.parallel import halo
    from pyapes_tpu_torch.solver.multigrid import _level_shapes

    gate = halo.placed_field_supported if var_gamma else halo.placed_supported
    shapes = _level_shapes(grid)
    n = sum(bool(gate(decomp, s)) for s in shapes)
    return n, int(n < len(shapes))


def _placed_summary(label, run, n_cuda_blocks: int, ghost=None) -> dict:
    """The phase's numbers of one placed layout, checked: every timed
    solve launched ``axis_stencil_ext`` once per card block and placed
    apply (3-D) and, with ``ghost`` (one apply's ghost bytes, a one-level
    solve), moved exactly the ghost faces per apply."""
    rows = run["rows"]
    for r in rows:
        if r["placed_applies"] == 0:
            raise RuntimeError(f"chip_smoke: {label} ran no placed apply: {r}")
        if r["axis_stencil_ext"] != n_cuda_blocks * r["placed_applies"]:
            raise RuntimeError(f"chip_smoke: {label}: {r['axis_stencil_ext']} axis_stencil_ext "
                               f"launches, not {n_cuda_blocks} card blocks x "
                               f"{r['placed_applies']} applies")
        if ghost is not None and r["exchange_bytes"] != ghost * r["placed_applies"]:
            raise RuntimeError(f"chip_smoke: {label}: {r['exchange_bytes']} bytes exchanged, "
                               f"not {ghost} per apply x {r['placed_applies']}")
    last = rows[-1]
    return {
        "itr": [r["itr"] for r in rows], "tol": [r["tol"] for r in rows],
        "wall_s": [r["wall_s"] for r in rows],
        "wall_s_median": statistics.median(r["wall_s"] for r in rows),
        "axis_stencil_ext_per_solve": last["axis_stencil_ext"],
        "axis_stencil_per_solve": last["axis_stencil"],
        "placed_applies_per_solve": last["placed_applies"],
        "gathers_per_solve": last["gathers"],
        "gathers_per_vcycle": (last["cycle_gathers"] / last["vcycles"]) if last["vcycles"]
        else None,
        "vcycles_per_solve": last["vcycles"],
        "exchange_bytes_per_solve": last["exchange_bytes"],
        "exchange_bytes_per_apply": last["exchange_bytes"] / last["placed_applies"],
        "exchange_bytes_across_per_solve": last["exchange_bytes_across"],
        "repartitions_per_solve": last["repartitions"],
        "repartition_bytes_across_per_solve": last["repartition_bytes_across"],
        "repartition_bytes_within_per_solve": last["repartition_bytes_within"],
        "peak_mem_gib_per_card": run["peak_gib"],
    }


def _repartitions_per_apply(decomp, grid, dev) -> int:
    """Block vectors an FD apply moves between pencils on ``decomp``'s
    blocks of ``grid``: each change of layout along ``Layout.pencils`` on
    the way there, and as many back."""
    from pyapes_tpu_torch.parallel import blocks

    lay = blocks.layout(decomp, grid, dev)
    pens = [p for _, p in lay.pencils()]
    return 2 * sum(a is not b for a, b in zip([lay] + pens, pens))


def _driver(launches: dict):
    """``drive(var, rhs, cfg, solves, warm=True)``: ``run_layout`` with the
    kernels' counts set to 0 just before and added to ``launches`` just
    after."""
    def drive(var, rhs, cfg, solves, warm=True):
        return _counted_drive(launches, lambda: run_layout(var, rhs, cfg, solves, warm))

    return drive


def placed_fastdiag(dev, drive, refs: dict) -> dict:
    """Phase 17 (d) and (e) (``phase_placed``): the placed fastdiag and the
    placed CG with the FD preconditioner, blocks round robin over the cards
    the machine shows, each solve through ``drive`` (``_driver``); returns
    their numbers, checked."""
    import torch

    from pyapes_tpu_torch.parallel import DomainDecomposition

    devs = placed_devices(prod(N_DECOMP))
    n_cards = len(set(devs))
    n_cuda = sum(1 for d in devs if d.startswith("cuda"))
    placed_dd = DomainDecomposition(N_DECOMP, devices=devs)
    out = {}

    # (d) bench's fastdiag: the undecomposed solve (its passes and solution),
    # then the view-based and the placed solves in turns
    mesh, var, rhs = placed_problem(dev, (N_MAIN,) * 3)
    undec = run_layout(var, rhs, fd_cfg(), 1)
    ref_x, ref_itr = undec["x"], undec["rows"][0]["itr"]
    del undec
    view_rows, view_peaks, rows, peaks = [], [], [], []
    for turn in range(PLACED_FD_TURNS):
        view = run_layout(var, rhs, fd_cfg(DomainDecomposition(N_DECOMP)), 1, warm=turn == 0)
        view_rows += view["rows"]
        view_peaks.append(view["peak_gib"])
        del view
        placed = drive(var, rhs, fd_cfg(placed_dd), 1, warm=turn == 0)
        rows += placed["rows"]
        peaks.append(placed["peak_gib"])
        x = placed["x"]
        del placed
    d = _placed_summary("(d) placed fastdiag", {"rows": rows, "x": x,
                                                "peak_gib": [max(p) for p in zip(*peaks)]}, n_cuda)
    agree = _rel(x, ref_x)
    res32, res64 = _true_residuals(mesh, var, rhs, 1.0, x)
    per_apply = _repartitions_per_apply(placed_dd, (N_MAIN,) * 3, dev)
    vec_bytes = N_MAIN**3 * 4
    moved = [r["repartition_bytes_across"] + r["repartition_bytes_within"] for r in rows]
    if not (all(r["converge"] and r["itr"] == ref_itr and r["gathers"] == 0
                and r["axis_stencil_ext"] >= n_cuda * (r["itr"] + 1)
                and r["repartitions"] == per_apply * r["itr"] for r in rows)
            and all(m == r["repartitions"] * vec_bytes for m, r in zip(moved, rows))
            and agree <= FD_DECOMP_AGREE and res64 <= FD_TOL):
        raise RuntimeError(f"chip_smoke: (d) placed fastdiag: {json.dumps(rows)}; the undecomposed "
                           f"solve's passes {ref_itr}, max|dx|/max|x| {agree:.3e} (limit "
                           f"{FD_DECOMP_AGREE}), true residual f64 {res64:.3e} (limit {FD_TOL}), "
                           f"{per_apply} repartitions per apply")
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    peak = d["peak_mem_gib_per_card"]
    d.update({"undecomposed_itr": ref_itr, "max_rel_diff_vs_undecomposed": agree,
              "true_rel_residual_f32": res32, "true_rel_residual_f64": res64,
              "repartitions_per_apply": per_apply,
              "repartition_bytes_per_apply": moved[-1] / rows[-1]["itr"],
              "view_itr": [r["itr"] for r in view_rows],
              "view_wall_s": [r["wall_s"] for r in view_rows],
              "view_wall_s_median": statistics.median(r["wall_s"] for r in view_rows),
              "view_axis_stencil_ext_per_solve": view_rows[-1]["axis_stencil_ext"],
              "view_peak_mem_gib_per_card": [max(p) for p in zip(*view_peaks)],
              "placed_over_view": d["wall_s_median"] / statistics.median(
                  r["wall_s"] for r in view_rows),
              "dof_per_s": N_MAIN**3 / d["wall_s_median"],
              "peak_bytes_per_point": max(peak) * 2**30 / N_MAIN**3,
              "largest_cube_these_cards": int(N_MAIN * (card_bytes / (max(peak) * 2**30))
                                              ** (1 / 3)),
              "lead_minus_other_gib": peak[0] - max(peak[1:]) if len(peak) > 1 else None})
    out["d_fastdiag"] = d
    refs["d"] = {"itr": ref_itr, "x": ref_x.cpu(), "placed_x": x.cpu(), "agree": agree,
                 "peak_gib": peak}
    print(f"[17 placed] (d) fastdiag {N_MAIN}^3 f32 {N_DECOMP} on {n_cards} card(s), in turns "
          f"with the view-based solve: {json.dumps(d)}", flush=True)
    del x, ref_x, var, rhs, mesh

    # (e) CG with the FD preconditioner, against the view-based solve
    n = PLACED_FD_CG_N
    _, var, rhs = placed_problem(dev, (n,) * 3)
    cfg = {"method": "cg", "precond": "fd", "tol": 1e-6, "max_it": 200, "criterion": "residual"}
    view = run_layout(var, rhs, {**cfg, "decomp": DomainDecomposition(N_DECOMP)}, 1)
    placed = drive(var, rhs, {**cfg, "decomp": placed_dd}, 1)
    e = _placed_summary("(e) placed CG + FD", placed, n_cuda)
    rp, rv = placed["rows"][-1], view["rows"][-1]
    agree = _rel(placed["x"], view["x"])
    per_apply = _repartitions_per_apply(placed_dd, (n,) * 3, dev)
    if not (rp["converge"] and rp["itr"] == rv["itr"] and rp["gathers"] == 0
            and rp["repartitions"] == per_apply * (rp["itr"] + 1) and agree <= PLACED_CG_AGREE):
        raise RuntimeError(f"chip_smoke: (e) placed CG + FD: {json.dumps(rp)} against the "
                           f"view-based itr {rv['itr']}, max|dx|/max|x| {agree:.3e} (limit "
                           f"{PLACED_CG_AGREE}), {per_apply} repartitions per FD apply")
    e.update({"view_itr": rv["itr"], "view_wall_s": rv["wall_s"], "max_rel_diff_vs_view": agree,
              "view_peak_mem_gib_per_card": view["peak_gib"]})
    out["e_cg_fd"] = e
    print(f"[17 placed] (e) CG + precond fd {n}^3 f32 {N_DECOMP}: {json.dumps(e)}", flush=True)
    del view, placed, var, rhs
    return out


PLACED_E_TOL = 1e-5  # (i): <E> of the placed LES against the view-based run, relative (f32)
# (g)-(i): f32 BiCGSTAB solves, whose count follows the dots' rounding (the
# placed dots sum per block; one solve may end at the f32 floor a few passes
# before or after the view-based one): the total itr of the run within this
# slack per step of the view-based total
PLACED_BICG_SLACK = 5
PLACED_TGV_WARM, PLACED_TGV_STEPS = 2, 10  # (i): steps of the 257^3 rung
# (i): the f32 LES's momentum solves end at the f32 floor (tol 1e-8), a
# pass sooner or later in the two layouts; 12 steps spread the fields to
# ~3e-3 of their largest value (2.6e-3 on an H100 80GB HBM3 at 700 W),
# while <E> stays within PLACED_E_TOL
PLACED_LES_AGREE = 1e-2
PLACED_TERMS_CMP = {"darcy": 32, "burgers": 16, "tgv": 17}  # the card/CPU mixes, f64


def _model_solvers(model) -> list:
    return [getattr(model, k) for k in ("mom_solver", "p_solver", "solver") if hasattr(model, k)]


def run_steps(stepper, steps: int, warm: int = 0) -> dict:
    """``warm`` steps, then ``steps`` timed steps of a model: every solve's
    report of the timed steps (``itr``, ``tol``; ``converge``: every Krylov
    solve converged), the wall of
    each step, the counters' deltas over the timed steps, the peak memory
    of each card over them, and the state fields (and a flow's kinetic
    energy) after them."""
    import torch

    reports = []
    for solver in _model_solvers(stepper.model):
        real = solver.solve

        def solve(real=real, method=solver.config["fdm"]["method"]):
            rep = real()
            reports.append({**rep, "method": method})
            return rep

        solver.solve = solve
    for _ in range(warm):
        stepper.step()
    _sync_all()
    cards = range(torch.cuda.device_count())
    for i in cards:
        torch.cuda.reset_peak_memory_stats(i)
    del reports[:]
    c0, walls = _placed_counters(), []
    for _ in range(steps):
        tic = time.perf_counter()
        stepper.step()
        _sync_all()
        walls.append(time.perf_counter() - tic)
    c1 = _placed_counters()
    model = stepper.model
    fields = (model.state_fields() if hasattr(model, "state_fields")
              else getattr(model, "vel", None) or [model.var])
    energy = float(model.kinetic_energy()) if hasattr(model, "kinetic_energy") else None
    return {"itr": [r["itr"] for r in reports], "tol": [r["tol"] for r in reports],
            # an f32 fastdiag solve may end at its stall exit (the f32 floor)
            "converge": all(r["converge"] or r["method"] == "fastdiag" for r in reports),
            "wall_s": walls, "energy": energy,
            "wall_s_per_step_median": statistics.median(walls),
            "counts": _no_host_gathers({k: c1[k] - c0[k] for k in c1}),
            "peak_gib": [torch.cuda.max_memory_allocated(i) / 2**30 for i in cards],
            "fields": [f().clone() for f in fields]}


def _fields_rel(a: list, b: list) -> float:
    return max(_rel(x, y) for x, y in zip(a, b))


def _apply_bytes(fn) -> int:
    """``halo.exchange_bytes`` moved by one call of ``fn``."""
    from pyapes_tpu_torch.parallel import halo

    b0 = halo.exchange_bytes
    fn()
    _sync_all()
    return halo.exchange_bytes - b0


def _placed_model_case(label, make, placed_dd, launches, steps, required, n_cuda, warm=0,
                       agree=PLACED_AGREE) -> tuple:
    """A model stepped ``warm`` + ``steps`` times with the view-based
    decomposition, then on the placed blocks (the kernels counted from 0
    into ``launches``): each of ``required`` launched a multiple of the card
    blocks, no gather, every solve converged, the timed steps' total ``itr``
    within ``PLACED_BICG_SLACK`` per step of the view-based total, the
    fields within ``agree`` relative. Returns
    (the numbers, the placed model)."""
    from pyapes_tpu_torch.parallel import DomainDecomposition

    view_stepper = make({"decomp": DomainDecomposition(N_DECOMP)})
    view = run_steps(view_stepper, steps, warm)
    del view_stepper
    stepper = make({"decomp": placed_dd})
    run = _counted_drive(launches, lambda: run_steps(stepper, steps, warm))
    c = run["counts"]
    d_itr = abs(sum(run["itr"]) - sum(view["itr"]))
    rel = _fields_rel(run["fields"], view["fields"])
    bad = [k for k in required if c[k] == 0 or c[k] % max(n_cuda, 1)]
    if not (run["converge"] and len(run["itr"]) == len(view["itr"])
            and d_itr <= PLACED_BICG_SLACK * steps and rel <= agree and c["gathers"] == 0
            and not bad):
        raise RuntimeError(f"chip_smoke: {label}: itr {run['itr']} against the view-based "
                           f"{view['itr']}, fields max|dx|/max|x| {rel:.3e} (limit {agree}), "
                           f"gathers {c['gathers']}, launches not per card block {bad}: {c}")
    out = {"steps": steps, "warm": warm, "itr": run["itr"], "view_itr": view["itr"],
           "tol": run["tol"], "max_rel_diff_vs_view": rel,
           "wall_s_per_step": run["wall_s"],
           "wall_s_per_step_median": run["wall_s_per_step_median"],
           "view_wall_s_per_step_median": view["wall_s_per_step_median"],
           "placed_over_view": run["wall_s_per_step_median"] / view["wall_s_per_step_median"],
           "gathers": c["gathers"], "operand_scatters": c["operand_scatters"],
           "repartitions": c["repartitions"],
           "launches_per_card_block": {k: c[k] / max(n_cuda, 1) for k in required},
           "launches": {k: c[k] for k in _counts() if c[k]},
           "exchange_bytes": c["exchange_bytes"],
           "exchange_bytes_across_cards": c["exchange_bytes_across"],
           "repartition_bytes_across_cards": c["repartition_bytes_across"],
           "placed_applies": c["placed_applies"],
           "peak_mem_gib_per_card": run["peak_gib"], "view_peak_mem_gib_per_card": view["peak_gib"]}
    if run["energy"] is not None:
        out.update({"energy": run["energy"], "view_energy": view["energy"]})
    return out, stepper.model


def _mixed_case(dev, label, run_fn, placed_devs) -> dict:
    """``run_fn(decomp) -> (itr per solve, fields)`` with the view-based
    decomposition on the card and on the mixed placement ``placed_devs``:
    the same itr solve by solve and the fields within ``PLACED_CMP_TOL``."""
    from pyapes_tpu_torch.parallel import DomainDecomposition, blocks

    v_itr, v_f = run_fn(DomainDecomposition(N_DECOMP))
    g0, tic = blocks.gathers, time.perf_counter()
    p_itr, p_f = run_fn(DomainDecomposition(N_DECOMP, devices=placed_devs))
    wall = time.perf_counter() - tic
    rel = _fields_rel(p_f, v_f)
    if p_itr != v_itr or not rel <= PLACED_CMP_TOL:
        raise RuntimeError(f"chip_smoke: (mixed) {label} on {placed_devs}: itr {p_itr} against "
                           f"{v_itr}, max|dx|/max|x| {rel:.3e} (limit {PLACED_CMP_TOL})")
    return {"devices": list(placed_devs), "solves": len(p_itr), "itr": p_itr,
            "max_rel_diff_vs_view": rel, "gathers": blocks.gathers - g0, "wall_s": wall}


def placed_terms(dev, launches: dict, refs: dict) -> dict:
    """Phase 17 (f)-(i) (``phase_placed``): the variable-Γ and Div/Conv terms
    and ``PeriodicFlow`` on ``N_DECOMP`` placed blocks (round robin over the
    cards), each against the view-based decomposition of the same problem,
    and a card/CPU mix of (f), (g) and (i) at a small f64 size; the placed
    drives' kernels counted into ``launches``. Returns the numbers,
    checked."""
    import torch

    from pyapes_tpu_torch.ops.advect import advect_pair, conv_component
    from pyapes_tpu_torch.ops.diff_field import diff_field
    from pyapes_tpu_torch.parallel import DomainDecomposition, blocks, halo
    from pyapes_tpu_torch.solver.multigrid import _level_shapes

    devs = placed_devices(prod(N_DECOMP))
    n_cuda = sum(1 for d in devs if d.startswith("cuda"))
    placed_dd = DomainDecomposition(N_DECOMP, devices=devs)
    out = {}

    # (f) bench_darcy's problem: CG + the bf16 Γ-aware V(2,2) FMG
    n = N_DARCY
    mesh, var, rhs, coeff = _path_problem(dev, n, darcy=True)
    view = run_layout(var, rhs, {**darcy_cfg(), "decomp": DomainDecomposition(N_DECOMP)}, 2,
                      coeff=coeff)
    placed = _counted_drive(launches, lambda: run_layout(
        var, rhs, {**darcy_cfg(), "decomp": placed_dd}, 2, coeff=coeff))
    rows, x = placed["rows"], placed["x"]
    agree = _rel(x, view["x"])
    res32, res64 = _true_residuals(mesh, var, rhs, coeff, x, darcy=True)
    n_levels = sum(halo.placed_field_supported(placed_dd, s) for s in _level_shapes((n,) * 3))
    lay = blocks.layout(placed_dd, (n,) * 3, dev)
    ghost = halo.field_ghost_bytes(lay, 1, 4)
    gb = blocks.scatter_operand(coeff, lay)
    xb = blocks.scatter(x, lay)
    inv = [float(n - 1) ** 2] * 3
    fine = _apply_bytes(lambda: halo.placed_diff_field(xb, gb, inv, (("none", "none"),) * 3,
                                                       "arithmetic", (), {}))
    del xb, gb
    _, hand = _handover(placed_dd, (n,) * 3, var_gamma=True)
    # Γ scattered once and sampled down block by block (its hand-over level
    # gathered once per solve); a V-cycle gathers at its hand-over only
    ok = all(r["converge"] and r["tol"] <= 1e-6
             and r["gathers"] == r["cycle_gathers"] + r["fmg_gathers"] + r["gamma_gathers"]
             and r["cycle_gathers"] == hand * r["vcycles"]
             and r["fmg_gathers"] == hand * (1 + n_levels) and r["gamma_gathers"] == hand
             and r["operand_scatters"] == 1
             and r["diff_jacobi"] > 0 and r["diff_field"] > 0 for r in rows)
    d_itr = max(abs(p["itr"] - v["itr"]) for p, v in zip(rows, view["rows"]))
    if not (ok and d_itr <= PLACED_GATE and agree <= PLACED_AGREE and res64 <= 1e-5
            and fine == ghost):
        raise RuntimeError(f"chip_smoke: (f) placed Darcy: {json.dumps(rows)} against the "
                           f"view-based {json.dumps(view['rows'])}, max|dx|/max|x| {agree:.3e}, "
                           f"true residual f64 {res64:.3e}, one fine apply moved {fine} bytes "
                           f"(its x faces {ghost}), {n_levels} placed levels")
    last = rows[-1]
    out["f_darcy"] = {
        "n": n, "itr": [r["itr"] for r in rows], "view_itr": [r["itr"] for r in view["rows"]],
        "tol": [r["tol"] for r in rows], "wall_s": [r["wall_s"] for r in rows],
        "wall_s_median": statistics.median(r["wall_s"] for r in rows),
        "view_wall_s_median": statistics.median(r["wall_s"] for r in view["rows"]),
        "max_rel_diff_vs_view": agree, "true_rel_residual_f32": res32,
        "true_rel_residual_f64": res64, "placed_levels": n_levels,
        "gathers_per_solve": last["gathers"], "cycle_gathers_per_solve": last["cycle_gathers"],
        "fmg_gathers_per_solve": last["fmg_gathers"],
        "gathers_in_krylov_loop": last["gathers"] - last["cycle_gathers"] - last["fmg_gathers"]
        - last["gamma_gathers"],
        "gathers_per_vcycle": last["cycle_gathers"] / max(last["vcycles"], 1),
        "vcycles_per_solve": last["vcycles"], "operand_scatters_per_solve":
        last["operand_scatters"], "diff_jacobi_per_solve": last["diff_jacobi"],
        "diff_field_per_solve": last["diff_field"],
        "diff_jacobi_per_card_block": last["diff_jacobi"] / max(n_cuda, 1),
        "diff_field_per_card_block": last["diff_field"] / max(n_cuda, 1),
        "fine_apply_exchange_bytes_f32": fine,
        "ring_ghost_bytes_f32": _ghost_bytes(N_DECOMP, (1,) + (n,) * 3, 4),
        "exchange_bytes_per_solve": last["exchange_bytes"],
        "exchange_bytes_across_cards_per_solve": last["exchange_bytes_across"],
        "gamma_gathers_per_solve": last["gamma_gathers"],
        "transfer_ghost_bytes_per_solve": last["transfer_ghost_bytes"],
        "peak_mem_gib_per_card": placed["peak_gib"],
        "view_peak_mem_gib_per_card": view["peak_gib"]}
    refs["f"] = {"itr": [r["itr"] for r in view["rows"]], "x": view["x"].cpu(),
                 "peak_gib": placed["peak_gib"]}
    print(f"[17 placed] (f) Darcy {n}^3 f32 CG + bf16 Γ-aware V(2,2) FMG {N_DECOMP}: "
          f"{json.dumps(out['f_darcy'])}", flush=True)
    del view, placed, var, rhs, coeff, mesh, x
    torch.cuda.empty_cache()

    # (g) BurgersND on the torus: the placed Conv and the placed FD preconditioner
    g, model = _placed_model_case(
        "(g) placed BurgersND", lambda c: burgers_model(dev, N_PATH, config=c)[0], placed_dd,
        launches, 3, ("conv_component",), n_cuda)
    lay = blocks.layout(placed_dd, (N_PATH,) * 3, dev)
    u = torch.cat([v()[(slice(None),) + (slice(0, -1),) * 3] for v in model.vel]).contiguous()
    base = next(r for r in model.solver.eqs.values() if r["name"] == "Conv")["other"]["base"]
    base_t = tuple(tuple(torch.as_tensor(c[:-1], device=dev) for c in cs) for cs in base)
    conv = halo.make_sharded_advect_apply(placed_dd, "conv", 1, "none", (("none",) * 2,) * 3,
                                          "advective")
    ub, xb = blocks.scatter_operand(u, lay), blocks.scatter(u[:1].contiguous(), lay)
    g["fine_apply_exchange_bytes_f32"] = _apply_bytes(lambda: conv(xb, ub, base_t))
    g["ring_ghost_bytes_f32"] = _ghost_bytes(N_DECOMP, (1,) + (N_PATH,) * 3, 4)
    if g["fine_apply_exchange_bytes_f32"] != g["ring_ghost_bytes_f32"] or g["repartitions"] == 0:
        raise RuntimeError(f"chip_smoke: (g) placed BurgersND: one Conv apply moved "
                           f"{g['fine_apply_exchange_bytes_f32']} bytes, x's faces "
                           f"{g['ring_ghost_bytes_f32']}; repartitions {g['repartitions']}")
    out["g_burgers"] = g
    print(f"[17 placed] (g) BurgersND {N_PATH + 1}^3 f32 torus {N_DECOMP}: {json.dumps(g)}",
          flush=True)
    del model, u, ub, xb
    torch.cuda.empty_cache()

    # (h) AdvectionDiffusion, upwind, a velocity field: the placed Div
    h, model = _placed_model_case(
        "(h) placed AdvectionDiffusion upwind",
        lambda c: advdiff_model(dev, "upwind", N_PATH, config=c)[0], placed_dd, launches, 5,
        ("advect_pair",), n_cuda)
    lay = blocks.layout(placed_dd, (N_PATH,) * 3, dev)
    rec = next(r for r in model.solver.eqs.values() if r.get("adv") is not None)
    base_t = tuple(tuple(torch.as_tensor(c, device=dev) for c in cs)
                   for cs in rec["other"]["base"])
    div = halo.make_sharded_advect_apply(placed_dd, "div", 1, "upwind",
                                         rec["other"]["surgery"], rec["other"]["form"])
    ab = blocks.scatter_operand(torch.as_tensor(rec["adv"], device=dev).contiguous(), lay)
    xb = blocks.scatter(model.var(), lay)
    h["fine_apply_exchange_bytes_f32"] = _apply_bytes(lambda: div(xb, ab, base_t))
    h["ring_ghost_bytes_f32"] = _ghost_bytes(N_DECOMP, (1,) + (N_PATH,) * 3, 4)
    if h["fine_apply_exchange_bytes_f32"] != h["ring_ghost_bytes_f32"]:
        raise RuntimeError(f"chip_smoke: (h): one Div apply moved "
                           f"{h['fine_apply_exchange_bytes_f32']} bytes, x's faces "
                           f"{h['ring_ghost_bytes_f32']}")
    out["h_upwind"] = h
    print(f"[17 placed] (h) AdvectionDiffusion upwind {N_PATH}^3 f32 {N_DECOMP}: "
          f"{json.dumps(h)}", flush=True)
    del model, ab, xb
    torch.cuda.empty_cache()

    # (i) the TGV-3D Smagorinsky LES at the 257^3 rung: the momentum's
    # variable-Γ apply per block, the pressure's placed fastdiag
    vol = (2 * pi) ** 3

    def tgv(c):
        model, dt = tgv_model(dev, TGV_RUNG, config=c)
        return _Stepper(model, dt)

    i, model = _placed_model_case(
        "(i) placed TGV-3D LES", tgv, placed_dd, launches, PLACED_TGV_STEPS,
        ("diff_field",), n_cuda, warm=PLACED_TGV_WARM, agree=PLACED_LES_AGREE)
    e_placed, e_view = i.pop("energy") / vol, i.pop("view_energy") / vol
    lay = blocks.layout(placed_dd, (TGV_RUNG - 1,) * 3, dev)
    nu = model._nu_coeff()
    nu = nu if torch.is_tensor(nu) else torch.full((TGV_RUNG,) * 3, float(nu), device=dev)
    red = (slice(0, -1),) * 3
    gb = blocks.scatter_operand(nu[red].contiguous(), lay)
    xb = blocks.scatter(model.u()[(slice(None),) + red].contiguous(), lay)
    inv = [(1.0 / float(d)) ** 2 for d in model.mesh.dx_np]
    i["fine_apply_exchange_bytes_f32"] = _apply_bytes(lambda: halo.placed_diff_field(
        xb, gb, inv, (("none", "none"),) * 3, "arithmetic", (0, 1, 2), {}))
    i["ring_ghost_bytes_f32"] = _ghost_bytes(N_DECOMP, (1,) + (TGV_RUNG - 1,) * 3, 4)
    i.update({"E_mean": e_placed, "view_E_mean": e_view,
              "E_rel_diff": abs(e_placed - e_view) / e_view})
    if not (i["E_rel_diff"] <= PLACED_E_TOL and i["repartitions"] > 0
            and i["fine_apply_exchange_bytes_f32"] == i["ring_ghost_bytes_f32"]):
        raise RuntimeError(f"chip_smoke: (i) placed TGV-3D LES: <E> {e_placed} against "
                           f"{e_view} (limit {PLACED_E_TOL} relative), repartitions "
                           f"{i['repartitions']}, one apply moved "
                           f"{i['fine_apply_exchange_bytes_f32']} bytes (x's faces "
                           f"{i['ring_ghost_bytes_f32']})")
    out["i_tgv_les"] = i
    print(f"[17 placed] (i) TGV-3D LES {TGV_RUNG}^3 f32 torus {N_DECOMP}, {PLACED_TGV_WARM} "
          f"warm + {PLACED_TGV_STEPS} steps: {json.dumps(i)}", flush=True)
    del model, gb, xb, nu
    torch.cuda.empty_cache()

    # the card against the CPU: (f), (g) and (i) on a mixed placement, f64
    mdevs = MIXED_PAIR * (prod(N_DECOMP) // 2)

    def darcy64(decomp):
        from pyapes_tpu_torch.solver.fdm import FDM
        from pyapes_tpu_torch.solver.ops import Solver

        _, var, rhs, coeff = _path_problem(dev, PLACED_TERMS_CMP["darcy"], darcy=True,
                                           dtype="double")
        s = Solver({"fdm": {**PLACED_CMP_CG, "precond": "mg", "report": False,
                            "decomp": decomp}})
        s.set_eq(FDM().laplacian(coeff, var) == rhs)
        return [s.solve()["itr"]], [var().clone()]

    def burgers64(decomp):
        run = run_steps(burgers_model(dev, PLACED_TERMS_CMP["burgers"], "double",
                                      {"decomp": decomp})[0], 2)
        return run["itr"], run["fields"]

    def tgv64(decomp):
        model, dt = tgv_model(dev, PLACED_TERMS_CMP["tgv"], "double", config={"decomp": decomp})
        run = run_steps(_Stepper(model, dt), 3)
        return run["itr"], run["fields"]

    mixed = {}
    for label, fn in ((f"(f) Darcy {PLACED_TERMS_CMP['darcy']}^3 f64", darcy64),
                      (f"(g) BurgersND {PLACED_TERMS_CMP['burgers'] + 1}^3 f64", burgers64),
                      (f"(i) TGV-3D LES {PLACED_TERMS_CMP['tgv']}^3 f64", tgv64)):
        mixed[label] = _counted_drive(launches, lambda fn=fn, label=label: _mixed_case(
            dev, label, fn, mdevs))
    out["mixed"] = mixed
    print(f"[17 placed] mixed card/CPU placements of (f), (g), (i), f64 (tolerance "
          f"{PLACED_CMP_TOL}): {json.dumps(mixed)}", flush=True)
    for name, fn in (("conv_component", conv_component), ("advect_pair", advect_pair),
                     ("diff_field", diff_field)):
        if launches.get(name, 0) == 0:
            raise RuntimeError(f"chip_smoke: the placed drives launched no {name} ({fn})")
    return out


PLACED_FIELD_SOLVES = 2  # (j), (k): timed solves of a Field on blocks (after a warm-up)
PLACED_FIELD_DARCY_SOLVES = 1  # (l)
N_LARGE = 1536  # (m): the grid only four cards hold, f32 (4, 2, 1)
LARGE_CARDS = 4
# (m): the lead card's peak against the others' (the whole-grid tensors
# gone from it, it holds what they hold: the loop state and the reductions'
# partials beside its blocks)
LARGE_LEAD_SPREAD = 0.10
LARGE_TOL = 1e-6  # (m): the solves' tolerance (relative residual)
# (m): the largest error against the manufactured u in [0, 1) (a wrong
# apply, transfer or exchange leaves errors of order 1; measured on four
# H100s: 3.2e-6 and 7.1e-4, the MG-PCG's f32 solve to a 1e-6 residual
# keeping more of the smooth error)
LARGE_ERR = {"fastdiag": 1e-4, "mgpcg": 5e-3}


def _block_problem(dev, placed_dd, nodes, darcy=False):
    """The path cells' problem (``_path_problem``: the seeded RHS, Darcy's Γ)
    with the Field, the RHS and Γ block vectors of ``placed_dd``: made whole
    on the card as the whole-Field cases make them, put on the blocks, the
    whole ones dropped (and the card's cache emptied) before anything is
    measured. ``(mesh, var, rhs, coeff)``."""
    import torch

    from pyapes_tpu_torch.parallel import blocks
    from pyapes_tpu_torch.variables import Field

    mesh, var, rhs, coeff = (_path_problem(dev, nodes[0], darcy=True) if darcy
                             else (*placed_problem(dev, nodes), 1.0))
    rb = blocks.put(rhs, placed_dd)
    gb = blocks.put(coeff[None], placed_dd) if darcy else 1.0
    zeros = blocks.build(rb.placement, lambda sl, d: torch.zeros(
        (1, *(x.stop - x.start for x in sl)), dtype=rhs.dtype, device=d))
    vb = Field(var.name, 1, mesh, var.bc_config, init_val=zeros)
    del var, rhs, coeff
    torch.cuda.empty_cache()
    return mesh, vb, rb, gb


def _field_rows_ok(rows) -> bool:
    """Every timed solve of a Field on blocks took its x0 and RHS as they
    are and left the solution on its blocks: no scatter at the entry, no
    gather at the exit."""
    return all(r["entry_scatters"] == 0 and r["exit_gathers"] == 0 for r in rows)


def placed_fields(dev, launches: dict, refs: dict) -> dict:
    """Phase 17 (j)-(l) (``phase_placed``): the Field's value on its
    ``N_DECOMP`` blocks (round robin over the cards; ``blocks.put``), its
    RHS and Γ too, through ``Solver.solve``, against (a), (d) and (f)'s
    view-based solves of the same problems (``refs``): (j) fastdiag 512^3,
    (k) bench's MG-PCG 512^3 (bf16 V(2,2) FMG), (l) Darcy 256^3 with Γ on
    blocks; each with its peak memory beside the whole Field's. Returns the
    numbers, checked."""
    import torch

    from pyapes_tpu_torch.parallel import DomainDecomposition, blocks

    devs = placed_devices(prod(N_DECOMP))
    n_cuda = sum(1 for d in devs if d.startswith("cuda"))
    placed_dd = DomainDecomposition(N_DECOMP, devices=devs)
    out = {}

    def drive(var, rhs, cfg, solves, coeff=1.0, warm=True):
        return _counted_drive(launches, lambda: run_layout(var, rhs, cfg, solves, warm,
                                                           coeff=coeff))

    def host(x):
        return x.cpu() if isinstance(x, blocks.BlockTensor) else x.detach().cpu()

    # (j) fastdiag 512^3, against (d)'s view-based solve
    mesh, var, rhs, _ = _block_problem(dev, placed_dd, (N_MAIN,) * 3)
    run = drive(var, rhs, fd_cfg(placed_dd), PLACED_FIELD_SOLVES)
    j = _placed_summary("(j) fastdiag, the Field on blocks", run, n_cuda)
    rows, x = run["rows"], host(run["x"])
    agree = _rel(x, refs["d"]["x"])
    # the same blocks, kernels and order as (d)'s placed solve of the whole
    # Field: its bits
    same_bits = torch.equal(x, refs["d"]["placed_x"])
    on_blocks = isinstance(var(), blocks.BlockTensor)
    if not (on_blocks and same_bits and _field_rows_ok(rows)
            and all(r["converge"] and r["itr"] == refs["d"]["itr"] and r["gathers"] == 0
                    for r in rows)):
        raise RuntimeError(f"chip_smoke: (j) fastdiag on blocks: {json.dumps(rows)} against "
                           f"(d)'s {refs['d']['itr']} passes, (d)'s placed bits {same_bits} "
                           f"(max|dx| {(x - refs['d']['placed_x']).abs().max().item():.3e}), "
                           f"max|dx|/max|x| against the undecomposed solve {agree:.3e} ((d) "
                           f"{refs['d']['agree']:.3e}), on blocks {on_blocks}")
    j.update({"undecomposed_itr": refs["d"]["itr"], "max_rel_diff_vs_undecomposed": agree,
              "bits_of_d_placed": same_bits,
              "d_max_rel_diff_vs_undecomposed": refs["d"]["agree"],
              "d_peak_mem_gib_per_card": refs["d"]["peak_gib"],
              "entry_scatters_per_solve": rows[-1]["entry_scatters"],
              "exit_gathers_per_solve": rows[-1]["exit_gathers"]})
    out["j_fastdiag_field"] = j
    print(f"[17 placed] (j) fastdiag {N_MAIN}^3 f32 {N_DECOMP}, the Field on blocks: "
          f"{json.dumps(j)}", flush=True)
    del var, rhs, run, x, mesh
    torch.cuda.empty_cache()

    # (k) bench's MG-PCG 512^3, against (a)'s view-based solve
    mesh, var, rhs, _ = _block_problem(dev, placed_dd, (N_MAIN,) * 3)
    mg = {k: v for k, v in mg_cfg(BENCH_MG).items() if k != "donate"}
    run = drive(var, rhs, {**mg, "decomp": placed_dd}, PLACED_FIELD_SOLVES)
    k = _placed_summary("(k) MG-PCG, the Field on blocks", run, n_cuda)
    rows, x = run["rows"], host(run["x"])
    n_lv, hand = _handover(placed_dd, (N_MAIN,) * 3)
    agree = _rel(x, refs["a"]["x"])
    d_itr = max(abs(r["itr"] - v) for r, v in zip(rows, refs["a"]["itr"]))
    if not (_field_rows_ok(rows) and d_itr <= PLACED_GATE and agree <= PLACED_AGREE
            and all(r["converge"] and r["tol"] <= 1e-6
                    and r["cycle_gathers"] == hand * r["vcycles"]
                    and r["fmg_gathers"] == hand * (1 + n_lv)
                    and r["gathers"] == r["cycle_gathers"] + r["fmg_gathers"] for r in rows)):
        raise RuntimeError(f"chip_smoke: (k) MG-PCG on blocks: {json.dumps(rows)} against "
                           f"(a)'s view-based itr {refs['a']['itr']}, max|dx|/max|x| "
                           f"{agree:.3e}; {n_lv} placed levels, hand-over {hand}")
    # in turns with the whole Field's placed solve (a)'s problem: whole,
    # blocks, blocks, whole (the same hierarchy, warm)
    _, wvar, wrhs = placed_problem(dev, (N_MAIN,) * 3)
    turns = {"whole": [], "blocks": []}
    for kind in ("whole", "blocks", "blocks", "whole"):
        v, b = (wvar, wrhs) if kind == "whole" else (var, rhs)
        r = drive(v, b, {**mg, "decomp": placed_dd}, 1, warm=False)["rows"][-1]
        turns[kind].append(r["wall_s"])
    del v, b, wvar, wrhs
    k.update({"view_itr": refs["a"]["itr"], "max_rel_diff_vs_view": agree,
              "placed_levels": n_lv, "handover_gathers_per_vcycle": hand,
              "fmg_gathers_per_solve": rows[-1]["fmg_gathers"],
              "transfer_ghost_bytes_per_solve": rows[-1]["transfer_ghost_bytes"],
              "a_peak_mem_gib_per_card": refs["a"]["peak_gib"],
              "in_turns_whole_field_wall_s": turns["whole"],
              "in_turns_block_field_wall_s": turns["blocks"]})
    out["k_mgpcg_field"] = k
    print(f"[17 placed] (k) MG-PCG {N_MAIN}^3 f32 bf16 V(2,2) FMG {N_DECOMP}, the Field on "
          f"blocks: {json.dumps(k)}", flush=True)
    del var, rhs, run, x, mesh
    torch.cuda.empty_cache()

    # (l) Darcy 256^3 with Γ on blocks, against (f)'s view-based solve
    n = N_DARCY
    mesh, var, rhs, gb = _block_problem(dev, placed_dd, (n,) * 3, darcy=True)
    run = drive(var, rhs, {**darcy_cfg(), "decomp": placed_dd}, PLACED_FIELD_DARCY_SOLVES,
                coeff=gb)
    rows, x = run["rows"], host(run["x"])
    n_lv, hand = _handover(placed_dd, (n,) * 3, var_gamma=True)
    agree = _rel(x, refs["f"]["x"])
    d_itr = max(abs(r["itr"] - v) for r, v in zip(rows, refs["f"]["itr"]))
    if not (_field_rows_ok(rows) and d_itr <= PLACED_GATE and agree <= PLACED_AGREE
            and all(r["converge"] and r["tol"] <= 1e-6 and r["operand_scatters"] == 0
                    and r["gamma_gathers"] == hand and r["cycle_gathers"] == hand * r["vcycles"]
                    and r["gathers"] == r["cycle_gathers"] + r["fmg_gathers"]
                    + r["gamma_gathers"] and r["diff_jacobi"] > 0 for r in rows)):
        raise RuntimeError(f"chip_smoke: (l) Darcy with Γ on blocks: {json.dumps(rows)} "
                           f"against (f)'s view-based itr {refs['f']['itr']}, max|dx|/max|x| "
                           f"{agree:.3e}; {n_lv} placed levels, hand-over {hand}")
    last = rows[-1]
    out["l_darcy_field"] = {
        "n": n, "itr": [r["itr"] for r in rows], "view_itr": refs["f"]["itr"],
        "tol": [r["tol"] for r in rows], "wall_s": [r["wall_s"] for r in rows],
        "wall_s_median": statistics.median(r["wall_s"] for r in rows),
        "max_rel_diff_vs_view": agree, "placed_levels": n_lv,
        # the fine Γ is never gathered: Γ's one gather is its hand-over level's
        "fine_gamma_gathers": 0, "gamma_gathers_per_solve": last["gamma_gathers"],
        "operand_scatters_per_solve": last["operand_scatters"],
        "gathers_per_solve": last["gathers"], "cycle_gathers_per_solve": last["cycle_gathers"],
        "fmg_gathers_per_solve": last["fmg_gathers"], "vcycles_per_solve": last["vcycles"],
        "transfer_ghost_bytes_per_solve": last["transfer_ghost_bytes"],
        "diff_jacobi_per_solve": last["diff_jacobi"], "diff_field_per_solve": last["diff_field"],
        "peak_mem_gib_per_card": run["peak_gib"], "f_peak_mem_gib_per_card": refs["f"]["peak_gib"]}
    print(f"[17 placed] (l) Darcy {n}^3 f32 CG + bf16 Γ-aware V(2,2) FMG {N_DECOMP}, Γ and "
          f"the Field on blocks: {json.dumps(out['l_darcy_field'])}", flush=True)
    del var, rhs, gb, run, x, mesh
    torch.cuda.empty_cache()
    return out


def _large_field(dev, placed_dd, n: int):
    """(m)'s problem at ``n^3`` f32: ``lap u = f`` with homogeneous Dirichlet
    faces and a manufactured discrete solution ``u``: uniform random values
    in the interior (each block's from its own seeded generator on its
    card), 0 on the faces, and ``f`` the plain 7-point Laplacian of ``u``
    per block, the neighbours' rows next to the block remade by ``exact``
    (0 past the faces): none of the solver's placed code makes it, so the
    solve's answer is ``u`` to its tolerance only if the placed apply,
    transfers and exchanges are right. (A smooth ``u`` would not do in f32
    at this spacing: its ``A u`` cancels ~1/h^2 terms, a residual floor
    near 1e-2.) The Field's zeros, ``u`` and ``f`` are made block by block
    on each block's card: no whole tensor on the host or on a card.
    ``(mesh, var, f, exact)``, ``exact(sl, device)`` remaking a block of
    ``u``."""
    import torch

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.parallel import blocks
    from pyapes_tpu_torch.variables import Field
    from pyapes_tpu_torch.variables.bcs import homogeneous_bcs

    mesh = Mesh(Box[0:1, 0:1, 0:1], None, [n] * 3, device=str(dev), dtype="single")
    lay = blocks.layout(placed_dd, (n,) * 3, dev)

    def exact(sl, d):
        seed = 1 + sum(s.start * 7919**j for j, s in enumerate(sl))
        g = torch.Generator(device=d).manual_seed(seed)
        u = torch.rand((1, *(s.stop - s.start for s in sl)), generator=g, device=d)
        for j, s in enumerate(sl):  # 0 on the Dirichlet faces
            m = torch.ones(s.stop - s.start, device=d)
            if s.start == 0:
                m[0] = 0.0
            if s.stop == n:
                m[-1] = 0.0
            u = u * m.reshape([-1 if k == j else 1 for k in range(3)])
        return u

    zeros = blocks.build(lay, lambda sl, d: torch.zeros(
        (1, *(s.stop - s.start for s in sl)), dtype=torch.float32, device=d))
    var = Field("p", 1, mesh, {"domain": homogeneous_bcs(3, 0.0, "dirichlet"), "obstacle": None},
                init_val=zeros)
    inv_h2 = [1.0 / float(h) ** 2 for h in mesh.dx_np]
    slices = [sl for _, sl, _ in lay.blocks]

    def lap_u(sl, d):
        """The block ``sl`` of ``f = lap u``: ``u`` padded by one row per
        side, each filled from the neighbouring block's ``exact`` along
        that axis (0 past a face: ``u`` is 0 there)."""
        u = exact(sl, d)
        ue = torch.nn.functional.pad(u, (1, 1, 1, 1, 1, 1))
        inner = [slice(None)] + [slice(1, 1 + s.stop - s.start) for s in sl]
        for j in range(3):
            for side, at in ((-1, 0), (1, sl[j].stop - sl[j].start + 1)):
                nb = next((o for o in slices if all(
                    (o[k] == sl[k]) if k != j else
                    (o[k].stop == sl[k].start if side < 0 else o[k].start == sl[k].stop)
                    for k in range(3))), None)
                if nb is None:
                    continue
                row = exact(nb, d).narrow(1 + j, 0 if side > 0 else nb[j].stop - nb[j].start - 1,
                                          1)
                ue[tuple(inner[:1 + j] + [slice(at, at + 1)] + inner[2 + j:])] = row
        f = torch.zeros_like(u)
        for j in range(3):
            lo = inner[:1 + j] + [slice(0, sl[j].stop - sl[j].start)] + inner[2 + j:]
            hi = inner[:1 + j] + [slice(2, sl[j].stop - sl[j].start + 2)] + inner[2 + j:]
            f += (ue[tuple(lo)] + ue[tuple(hi)] - 2.0 * u) * inv_h2[j]
        return f

    return mesh, var, blocks.build(lay, lap_u), exact


def placed_large(dev, launches: dict) -> dict:
    """Phase 17 (m): fastdiag and bench's MG-PCG at ``N_LARGE``^3 f32 in
    ``N_DECOMP`` blocks round robin over ``LARGE_CARDS`` cards, a grid no one
    card holds: the Field, its RHS and the solution on the blocks, no whole
    grid on any card. Per solve: ``itr``, the largest error against the
    manufactured solution (per block, combined in block order; ``_large_field``),
    the wall, and every card's peak (the lead within ``LARGE_LEAD_SPREAD`` of the others).
    On fewer cards, one line says it needs four (not a failure)."""
    import torch

    from pyapes_tpu_torch.parallel import DomainDecomposition

    n_cards = torch.cuda.device_count()
    if n_cards < LARGE_CARDS:
        print(f"[17 placed] (m) fastdiag and MG-PCG {N_LARGE}^3 f32 {N_DECOMP}: needs "
              f"{LARGE_CARDS} cards; this machine shows {n_cards} (run it on a host with "
              f"{LARGE_CARDS})", flush=True)
        return {"skipped": f"needs {LARGE_CARDS} cards, has {n_cards}"}
    devs = tuple(f"cuda:{i % LARGE_CARDS}" for i in range(prod(N_DECOMP)))
    placed_dd = DomainDecomposition(N_DECOMP, devices=devs)
    tic0 = time.perf_counter()
    mesh, var, f, exact = _large_field(dev, placed_dd, N_LARGE)
    setup_s = time.perf_counter() - tic0
    out = {"n": N_LARGE, "devices": list(devs), "setup_s": setup_s}
    mg = {k: v for k, v in mg_cfg(BENCH_MG).items() if k != "donate"}
    for label, cfg in (("fastdiag", {**fd_cfg(placed_dd), "tol": LARGE_TOL}),
                       ("mgpcg", {**mg, "decomp": placed_dd, "tol": LARGE_TOL})):
        run = _counted_drive(launches, lambda cfg=cfg: run_layout(var, f, cfg, 1))
        r, x = run["rows"][-1], run["x"]
        lay = x.placement
        err = None
        for b, (_, sl, d) in enumerate(lay.blocks):
            e = (x.parts[b] - exact(sl, d)).abs().max().to(dev)
            err = e if err is None else torch.maximum(err, e)
        peak = run["peak_gib"][:LARGE_CARDS]
        spread = (peak[0] - max(peak[1:])) / max(peak[1:])
        row = {"itr": r["itr"], "tol": r["tol"], "converge": r["converge"],
               "wall_s": r["wall_s"], "max_abs_err_vs_manufactured": err.item(),
               "max_abs_err_limit": LARGE_ERR[label],
               "peak_mem_gib_per_card": peak, "lead_over_others": spread,
               "gathers": r["gathers"], "entry_scatters": r["entry_scatters"],
               "exit_gathers": r["exit_gathers"],
               "repartition_bytes_across": r["repartition_bytes_across"],
               "exchange_bytes_across": r["exchange_bytes_across"],
               "transfer_ghost_bytes": r["transfer_ghost_bytes"]}
        out[label] = row
        print(f"[17 placed] (m) {label} {N_LARGE}^3 f32 {N_DECOMP} on {LARGE_CARDS} cards, the "
              f"Field on blocks: {json.dumps(row)}", flush=True)
        if not (r["converge"] and r["tol"] <= LARGE_TOL and r["entry_scatters"] == 0
                and r["exit_gathers"] == 0 and spread <= LARGE_LEAD_SPREAD
                and row["max_abs_err_vs_manufactured"] <= LARGE_ERR[label]):
            raise RuntimeError(f"chip_smoke: (m) {label} {N_LARGE}^3: {json.dumps(row)}")
        del run, x
        torch.cuda.empty_cache()
    return out


# (n)-(p): placed sync: False solves and fused steps as CUDA graphs
GRAPH_PAIRS = 3  # (n): sync: True and sync: False solves in turns, one each per pair
GRAPH_WARM, GRAPH_STEPS, GRAPH_CHUNK = 2, 10, 5  # (o): eager steps, then chunks in turns
GRAPH_CARDS = 4  # (p): the cards of the round robin


def _card_line() -> str:
    """Every card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them, joined by "; "."""
    return "; ".join(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines())


def _one_card_dd():
    from pyapes_tpu_torch.parallel import DomainDecomposition

    return DomainDecomposition(N_DECOMP, devices=("cuda:0",) * prod(N_DECOMP))


def _delta(c1: dict, c0: dict) -> dict:
    return {k: c1[k] - c0[k] for k in c1}


def graph_solve_case(label, var, rhs, cfg, coeff=1.0) -> dict:
    """(n)'s gates on one placed problem: a ``sync: True`` solve (the warm
    caches and the reference), the first ``sync: False`` solve (its eager
    warm-up and its capture), then ``GRAPH_PAIRS`` pairs in turns, each
    ``sync: False`` replay held to the reference's bits (``torch.equal``
    per block, or of the whole Field) and ``itr`` (a 0-d tensor); one more
    replay moves no counter, and one each is counted for API calls (1
    graph launch) and host syncs (0). Returns the numbers: the walls, the
    capture's seconds, the counters of an eager solve and of the first
    ``sync: False`` call (warm-up + capture: a replay's work is the
    capture's), the card's peak per kind."""
    import torch

    from pyapes_tpu_torch.parallel import blocks
    from pyapes_tpu_torch.solver.fdm import FDM
    from pyapes_tpu_torch.solver.linalg import dispatch
    from pyapes_tpu_torch.solver.ops import Solver

    fdm = FDM()
    solvers = {sync: Solver({"fdm": {"report": False, **cfg, "sync": sync}})
               for sync in (True, False)}

    def solve(sync):
        var.set_var_tensor(torch.zeros_like(var()))
        solvers[sync].set_eq(fdm.laplacian(coeff, var) == rhs)
        return solvers[sync].solve()

    def bits():
        x = var()
        return [p.clone() for p in x.parts] if isinstance(x, blocks.BlockTensor) else [x.clone()]

    rep_t = solve(True)
    ref = bits()
    _sync_all()
    c0 = _placed_counters()
    tic = time.perf_counter()
    solve(False)
    _sync_all()
    first_s = time.perf_counter() - tic
    first = _delta(_placed_counters(), c0)
    call = next(reversed(dispatch._GRAPH_CACHE.values()))[0]
    walls = {"sync_true": [], "sync_false": []}
    peaks = {"sync_true": 0.0, "sync_false": 0.0}
    same, itrs, eager = [], [], None
    c_timed = _placed_counters()
    for i in range(GRAPH_PAIRS):
        for sync in ((True, False) if i % 2 == 0 else (False, True)):
            kind = "sync_true" if sync else "sync_false"
            _sync_all()
            torch.cuda.reset_peak_memory_stats()
            c0 = _placed_counters()
            tic = time.perf_counter()
            rep = solve(sync)
            _sync_all()
            walls[kind].append(time.perf_counter() - tic)
            peaks[kind] = max(peaks[kind], torch.cuda.max_memory_allocated() / 2**30)
            if sync:
                eager = _delta(_placed_counters(), c0)
                continue
            if not (isinstance(rep["itr"], torch.Tensor) and rep["itr"].dim() == 0):
                raise RuntimeError(f"chip_smoke: {label}: sync: False reported {rep['itr']!r}")
            out = bits()
            same.append(len(out) == len(ref) and all(torch.equal(a, b) for a, b in zip(out, ref)))
            itrs.append(int(rep["itr"]))
    timed = _no_host_gathers(_delta(_placed_counters(), c_timed))
    # what the card holds with the graph alive: its static inputs and its
    # pools' blocks are reserved, not allocated, between replays
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved() / 2**30
    c0 = _placed_counters()
    solve(False)
    _sync_all()
    replay = {k: v for k, v in _delta(_placed_counters(), c0).items() if v}
    api = _api_calls(lambda: solve(False))
    syncs = _count_syncs(lambda: solve(False))
    out = {"itr": rep_t["itr"], "sync_false_itr": itrs, "same_bits": same,
           "wall_s": walls, "wall_s_median": {k: statistics.median(v) for k, v in walls.items()},
           "first_sync_false_call_s": first_s, "capture_s": call.capture_s,
           "graph_launches_per_replay": api["graph_launches"],
           "cuda_api_calls_per_replay": api["total"], "host_syncs_per_replay": syncs,
           "counters_moved_by_a_replay": replay,
           "counts_eager_solve": {k: v for k, v in eager.items() if v},
           "counts_warm_up_and_capture": {k: v for k, v in first.items() if v},
           "host_gathers_timed": timed["host_gathers"], "peak_gib_card0": peaks,
           "reserved_gib_card0_graph_alive": reserved}
    if not (all(same) and itrs == [rep_t["itr"]] * GRAPH_PAIRS and api["graph_launches"] == 1
            and syncs == 0 and not replay):
        raise RuntimeError(f"chip_smoke: {label}: sync: False against sync: True: "
                           f"{json.dumps(out)}")
    return out


def graph_les_case(dev, label, dd) -> dict:
    """(o)'s gates: the TGV-3D LES at ``TGV_RUNG``^3 f32 with its solves on
    the placed ``dd``, ``GRAPH_WARM`` steps then ``GRAPH_STEPS`` in chunks of
    ``GRAPH_CHUNK``, kinds in turns: eager placed, fused placed and fused
    view-based (``DomainDecomposition(N_DECOMP)``). The fused placed run
    equals the eager one bit for bit after every chunk, with the same
    ``itr`` per solve of its last step and the same ⟨E⟩; its runner
    captured once, no fallback (the warning is an error here); one more
    step each counted for host syncs (0) and graph launches (1: the replays
    of ``torch.cuda.CUDAGraph``, ``_graph_replays``; the profiler's CUPTI
    tracing of this step's replay crashed the process in a whole-script
    run, ``graph.replay`` under ``_api_calls``).
    Returns the numbers."""
    import warnings

    import torch

    from pyapes_tpu_torch.parallel import DomainDecomposition
    from pyapes_tpu_torch.solver.ops import solve_log

    vol = (2 * pi) ** 3
    (m_e, dt), (m_f, _), (m_v, _) = (tgv_model(dev, TGV_RUNG, config={"decomp": d})
                                     for d in (dd, dd, DomainDecomposition(N_DECOMP)))

    def itr_eager():
        with solve_log() as log:
            m_e.step(dt)
        return [int(r["itr"]) for r in log]

    def bits_equal():
        return all(torch.equal(a(), b()) for a, b in zip(m_e.state_fields(), m_f.state_fields()))

    walls = {"eager_placed": [], "fused_placed": [], "fused_view": []}
    peaks = {k: 0.0 for k in walls}
    same, itr_same = [], []
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*(falling back|stepping eagerly).*")
        m_e.run(dt, GRAPH_WARM)
        tic = time.perf_counter()
        m_f.run(dt, GRAPH_WARM, fused=True)
        _sync_all()
        boot_s = time.perf_counter() - tic
        m_v.run(dt, GRAPH_WARM, fused=True)
        r_f, r_v = m_f.fused_runner(), m_v.fused_runner()
        c0 = _placed_counters()
        order = (("eager_placed", "fused_placed", "fused_view"),
                 ("fused_view", "fused_placed", "eager_placed"))
        for i in range(GRAPH_STEPS // GRAPH_CHUNK):
            for kind in order[i % 2]:
                _sync_all()
                torch.cuda.reset_peak_memory_stats()
                tic = time.perf_counter()
                if kind == "eager_placed":
                    for _ in range(GRAPH_CHUNK - 1):
                        m_e.step(dt)
                    itr_e = itr_eager()
                else:
                    (r_f if kind == "fused_placed" else r_v).run(dt, GRAPH_CHUNK)
                _sync_all()
                walls[kind].append((time.perf_counter() - tic) / GRAPH_CHUNK)
                peaks[kind] = max(peaks[kind], torch.cuda.max_memory_allocated() / 2**30)
            same.append(bits_equal())
            itr_same.append(itr_e == [int(r["itr"]) for r in r_f.reports])
        timed = _no_host_gathers(_delta(_placed_counters(), c0))
        syncs = _count_syncs(lambda: r_f.step(dt))
        replays = _graph_replays(lambda: r_f.step(dt))
        r_v.step(dt)
        r_v.step(dt)
        itr_e = [itr_eager(), itr_eager()][-1]
    same.append(bits_equal())
    itr_same.append(itr_e == [int(r["itr"]) for r in r_f.reports])
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved() / 2**30
    e_e, e_f, e_v = (float(m.kinetic_energy()) / vol for m in (m_e, m_f, m_v))
    rel_v = _fields_rel([f() for f in m_f.state_fields()], [f() for f in m_v.state_fields()])
    out = {"dt": dt, "warm": GRAPH_WARM, "steps": GRAPH_STEPS, "chunk": GRAPH_CHUNK,
           "wall_s_per_step": walls,
           "wall_s_per_step_median": {k: statistics.median(v) for k, v in walls.items()},
           "same_bits_per_chunk": same, "same_itr_last_step": itr_same,
           "itr_per_solve_last_step": itr_e, "captures": r_f.captures,
           "bootstrap_s_fused_placed": boot_s, "capture_s": r_f.capture_s,
           "host_syncs_per_step": syncs, "graph_launches_per_step": replays,
           "E_mean": {"eager_placed": e_e,
           "fused_placed": e_f, "fused_view": e_v}, "max_rel_diff_vs_fused_view": rel_v,
           "gathers_timed": timed["gathers"], "peak_gib_card0": peaks,
           "reserved_gib_card0_three_models_two_graphs": reserved}
    if not (all(same) and all(itr_same) and e_e == e_f and r_f.captures == 1 and syncs == 0
            and replays == 1 and rel_v <= PLACED_LES_AGREE
            and abs(e_f - e_v) <= PLACED_E_TOL * e_v):
        raise RuntimeError(f"chip_smoke: {label}: {json.dumps(out)}")
    return out


def placed_graphs(dev, launches: dict) -> dict:
    """Phase 17 (n)-(p): placed ``sync: False`` solves and fused steps as CUDA
    graphs whose loops the device ends. (n) on one card, ``("cuda:0",) *
    8`` in ``N_DECOMP`` blocks, the Field, RHS and Γ on the blocks:
    fastdiag 512^3, bench's MG-PCG 512^3 (bf16 V(2,2) FMG) and Darcy 256^3,
    and (a)'s whole-Field MG-PCG 512^3 (the entry's scatter and the exit's
    gather inside the graph), each ``graph_solve_case``; (o) the TGV-3D LES
    257^3 (``graph_les_case``); (p) on ``GRAPH_CARDS`` cards
    (``placed_graphs_across``). Every drive's kernels counted from 0 into
    ``launches``. Returns the numbers, checked."""
    import torch

    from pyapes_tpu_torch.solver.linalg.dispatch import clear_cache

    dd = _one_card_dd()
    card = _card_line()
    mg = {k: v for k, v in mg_cfg(BENCH_MG).items() if k != "donate"}
    out = {}
    cases = (("n_fastdiag", f"(n) fastdiag {N_MAIN}^3 f32, the Field on blocks", N_MAIN, False,
              fd_cfg(dd)),
             ("n_mgpcg", f"(n) MG-PCG {N_MAIN}^3 f32 bf16 V(2,2) FMG, the Field on blocks",
              N_MAIN, False, {**mg, "decomp": dd}),
             ("n_darcy", f"(n) Darcy {N_DARCY}^3 f32, Γ and the Field on blocks", N_DARCY, True,
              {**darcy_cfg(), "decomp": dd}),
             ("n_mgpcg_whole", f"(n) MG-PCG {N_MAIN}^3 f32 bf16 V(2,2) FMG, (a)'s whole Field",
              N_MAIN, None, {**mg, "decomp": dd}))
    for key, label, n, darcy, cfg in cases:
        if darcy is None:
            _, var, rhs = placed_problem(dev, (n,) * 3)
            coeff = 1.0
        else:
            _, var, rhs, coeff = _block_problem(dev, dd, (n,) * 3, darcy=darcy)
        out[key] = _counted_drive(launches, lambda: graph_solve_case(label, var, rhs, cfg,
                                                                       coeff))
        print(f"[17 placed] {label}, {N_DECOMP} on ('cuda:0',) * {prod(N_DECOMP)}, sync: False "
              f"(one graph per solve) against sync: True; card {card}: {json.dumps(out[key])}",
              flush=True)
        del var, rhs, coeff
        clear_cache()
        torch.cuda.empty_cache()
    label = f"(o) TGV-3D LES {TGV_RUNG}^3 f32 torus {N_DECOMP}, fused"
    out["o_tgv_les"] = _counted_drive(launches, lambda: graph_les_case(dev, label, dd))
    print(f"[17 placed] {label} on ('cuda:0',) * {prod(N_DECOMP)} against eager placed and "
          f"fused view-based steps; card {card}: {json.dumps(out['o_tgv_les'])}", flush=True)
    clear_cache()
    torch.cuda.empty_cache()
    out["p_across"] = placed_graphs_across(dev)
    for k, c in out["p_across"].get("counts", {}).items():
        launches[k] = launches.get(k, 0) + c
    return out


# the peer kernels' check: the ghost faces of a (4, 2, 1) block of 512^3
# (128 x 256 x 512; each cut axis' face and the uncut last axis' column,
# strided) into the slots of its halo-extended buffer, a block of 512^3
# into its place in a whole grid, a reduction's stacked partials (2, 3, 1,
# 1, 1); every dtype; a copy is exact, so the error must be 0
PEER_BLOCK = (1, 128, 256, 512)
PEER_TIME_REPS = 200  # put/wait pairs per timing


def _peer_cases(dev, dtype):
    """(name, source view, destination buffer, destination view) per case."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(7)
    block = torch.randn(PEER_BLOCK, generator=g).to(dtype).to(dev)
    out = []
    for j in range(3):
        ext = [0, 0, 0]
        ext[j] = 1
        buf = torch.zeros((1, *(n + 2 * e for n, e in zip(PEER_BLOCK[1:], ext))), dtype=dtype,
                          device=dev)
        face = block.narrow(1 + j, PEER_BLOCK[1 + j] - 1, 1)
        slot = buf.narrow(1 + j, 0, 1)
        inner = [slice(None)] + [slice(e, e + n) for n, e in zip(PEER_BLOCK[1:], ext)]
        inner[1 + j] = slice(0, 1)
        out.append((f"ghost face axis {j} {tuple(face.shape)}", face, buf, buf[tuple(inner)]))
        del slot
    whole = torch.zeros((1, 512, 512, 512), dtype=dtype, device=dev)
    out.append(("block into a 512^3 grid", block, whole, whole[:, 128:256, 256:512, :]))
    parts = torch.randn((2, 3, 1, 1, 1), generator=g).to(dtype).to(dev)[:, :, 0]
    stack = torch.zeros((2, 3, 1, 1), dtype=dtype, device=dev)
    out.append(("reduction partials (2, 3, 1, 1)", parts, stack, stack))
    return out


def _peer_pair_ms(src, dst, reps: int) -> float:
    """Device time per put/wait pair on one card: the put on one stream, the
    wait on another (on one stream the put would wait for a wait queued
    behind it), ``reps`` pairs queued behind a device sleep on the wait's
    stream, CUDA events there around them."""
    import torch

    from pyapes_tpu_torch.ops import peer

    dev = src.device
    sa, sb = torch.cuda.Stream(device=dev), torch.cuda.Stream(device=dev)
    ch = peer.Channel.make(dev, dev)
    torch.cuda.synchronize(dev)

    def pairs(n):
        for _ in range(n):
            with torch.cuda.stream(sa):
                peer.peer_put(src, dst, ch)
            with torch.cuda.stream(sb):
                peer.peer_wait(ch)

    pairs(3)
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.cuda.stream(sb):
        torch.cuda._sleep(50_000_000)
        start.record()
    pairs(reps)
    with torch.cuda.stream(sb):
        end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps


def _peer_timeout(seconds: float = 0.5) -> dict:
    """A ``peer_wait`` with no put, in a process of its own with
    ``peer.TIMEOUT_S = seconds``: it must end with an error within its bound
    (the kernel traps), never hang. Returns the exit code, the wall and the
    error's line."""
    import sys

    code = ("import torch; from pyapes_tpu_torch.ops import peer; "
            f"peer.TIMEOUT_S = {seconds}; ch = peer.Channel.make('cuda:0', 'cuda:0'); "
            "torch.cuda.synchronize(); peer.peer_wait(ch); torch.cuda.synchronize(); "
            "print('no error')")
    tic = time.perf_counter()
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=os.path.dirname(os.path.abspath(__file__)))
    err = [ln for ln in run.stderr.splitlines() if "Error" in ln or "error" in ln]
    return {"exit_code": run.returncode, "wall_s": time.perf_counter() - tic,
            "error": err[-1].strip() if err else None, "stdout": run.stdout.strip()}


def phase_peer(dev) -> tuple[dict, dict, dict]:
    """The peer kernels on one card: ``peer_put`` + ``peer_wait`` against
    their plain version (``dst.copy_(src)``) on every ``_peer_cases`` case
    and dtype (a put between two buffers of ``dev``, the wait on another
    stream; the rest of the destination untouched), the pair timed per case
    in f32 beside the plain copy and its bound; the probe's
    ``per_card_graphs`` variant on two streams of ``dev`` (its launches
    counted from 0: the kernels' drive), then again with ``LARGE_TOP``
    kernels ahead of each loop behind a wait for the other lane (a lane
    launched after the other from one thread would deadlock there: the
    lanes launch side by side); a wait with no put ends within its bound
    with an error. Returns (launches, worst abs error, timing)."""
    import importlib.util

    import torch

    from pyapes_tpu_torch.ops import peer

    _reset_counts()
    worst = {k: 0.0 for k in PEER_KERNELS}
    rows = []
    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        for name, src, buf, view in _peer_cases(dev, dtype):
            ref = buf.clone()
            peer.plain_put(src, _same_view(ref, buf, view))
            sa, sb = torch.cuda.Stream(device=dev), torch.cuda.Stream(device=dev)
            ch = peer.Channel.make(dev, dev)
            torch.cuda.synchronize(dev)
            with torch.cuda.stream(sb):
                peer.peer_wait(ch)
            with torch.cuda.stream(sa):
                peer.peer_put(src, view, ch)
            torch.cuda.synchronize(dev)
            err = float((buf.double() - ref.double()).abs().max())
            worst["peer_put"] = max(worst["peer_put"], err)
            if not torch.equal(buf, ref):
                raise RuntimeError(f"chip_smoke: peer_put {name} {dtype}: the destination differs "
                                   f"from the plain copy (max abs {err})")
            if dtype == torch.float32:
                nbytes = src.numel() * src.element_size()
                ms = _peer_pair_ms(src, view, PEER_TIME_REPS)
                plain = _time_ms(lambda: peer.plain_put(src, view))
                lib = _time_ms(lambda: view.copy_(src))
                rows.append({"case": name, "bytes": nbytes, "pair_ms": ms, "plain_ms": plain,
                             "library_ms": lib, "bound_ms": _bound(2 * nbytes, 0)[0]})
            del buf, view, ref
    _counts_check = _counts()
    if _counts_check["peer_put"] == 0 or _counts_check["peer_wait"] == 0:
        raise RuntimeError("chip_smoke: the peer check launched no kernel")
    spec = importlib.util.spec_from_file_location(
        "probe_loop_across_cards_torch",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                     "probe_loop_across_cards_torch.py"))
    probe_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe_mod)
    _reset_counts()
    probe = probe_mod.probe_per_card_graphs(str(dev), str(dev))
    counts = {k: v for k, v in _counts().items() if k in PEER_KERNELS}
    if not probe.get("ok") or not all(counts.values()):
        raise RuntimeError(f"chip_smoke: the per_card_graphs probe on two streams of {dev}: "
                           f"{json.dumps(probe)}; launches {counts}")
    # the same with LARGE_TOP kernels ahead of each loop, behind a wait for
    # the other lane: the lanes' launches side by side (graph_loop's
    # _launch_lanes) hold; one after the other they deadlocked on cards
    large = probe_mod.probe_per_card_graphs(str(dev), str(dev), top_nodes=probe_mod.LARGE_TOP)
    if not large.get("ok"):
        raise RuntimeError(f"chip_smoke: the per_card_graphs probe with {probe_mod.LARGE_TOP} "
                           f"kernels ahead of its loop on two streams of {dev}: "
                           f"{json.dumps(large)}")
    timeout = _peer_timeout()
    if timeout["exit_code"] == 0 or timeout["wall_s"] > 60 or timeout["stdout"] == "no error":
        raise RuntimeError(f"chip_smoke: a peer_wait with no put did not end with an error "
                           f"within its bound: {json.dumps(timeout)}")
    big = max(rows, key=lambda r: r["bytes"])
    small = min(rows, key=lambda r: r["bytes"])
    timing = {
        "peer_put": (big["pair_ms"], big["plain_ms"], big["library_ms"], big["bound_ms"],
                     "bytes"),
        "peer_wait": (small["pair_ms"], small["plain_ms"], small["library_ms"],
                      _bound(3 * 8 * 2, 0)[0], "bytes"),
    }
    print(f"[peer] peer_put + peer_wait against dst.copy_(src) on {dev} (two streams; f32, f64, "
          f"bf16; bits equal, worst abs {worst['peer_put']}); per case, f32, ms per put/wait "
          f"pair (device, {PEER_TIME_REPS} pairs) beside the plain copy and the bound (bytes "
          f"read + written at {MEM_BYTES_PER_S / 1e12} TB/s): {json.dumps(rows)}; the "
          f"per_card_graphs probe on two streams of {dev}: {json.dumps(probe)}; with "
          f"{probe_mod.LARGE_TOP} kernels ahead of its loop: {json.dumps(large)}; a wait with no "
          f"put (TIMEOUT_S 0.5): {json.dumps(timeout)}; card {_card_line()}", flush=True)
    return counts, worst, timing


def _same_view(ref, buf, view):
    """The view of ``ref`` at ``view``'s place in ``buf`` (same shape and
    strides, offset by the same number of elements)."""
    return ref.as_strided(view.shape, view.stride(),
                          ref.storage_offset() + view.storage_offset() - buf.storage_offset())


ACROSS_CALLS = 5  # (p): sync: True and sync: False solves in turns, one each per turn
LES_TWO_CARDS = 2  # (p): the fused LES with its state on blocks, four per card


def graph_across_case(label, var, rhs, cfg, coeff=1.0) -> dict:
    """(p)'s gates on one problem whose blocks lie on several cards: a
    ``sync: True`` solve (the reference), the first ``sync: False`` solve
    (its eager warm-up and its capture of one graph per card), then
    ``ACROSS_CALLS`` of each kind in turns; every ``sync: False`` call gives
    the reference's solution bits (per block, or of the whole Field),
    ``itr`` and ``tol`` bits; one more call counts its host syncs (0) and
    graph launches (one per card); after it the four cards' replicas of
    ``itr``, ``tol`` and each loop's ``go`` are equal. Returns the walls
    (median of the calls), the capture's seconds and each card's peak."""
    import torch

    from pyapes_tpu_torch.ops import peer
    from pyapes_tpu_torch.parallel import blocks
    from pyapes_tpu_torch.solver.fdm import FDM
    from pyapes_tpu_torch.solver.linalg import dispatch
    from pyapes_tpu_torch.solver.ops import Solver

    fdm = FDM()
    cards = sorted({str(d) for d in cfg["decomp"].devices})
    solvers = {sync: Solver({"fdm": {"report": False, **cfg, "sync": sync}})
               for sync in (True, False)}

    def solve(sync):
        x = var()
        var.set_var_tensor(torch.zeros_like(x) if not isinstance(x, blocks.BlockTensor)
                           else x.zero_())
        solvers[sync].set_eq(fdm.laplacian(coeff, var) == rhs)
        return solvers[sync].solve()

    def bits():
        x = var()
        return [p.clone() for p in x.parts] if isinstance(x, blocks.BlockTensor) else [x.clone()]

    print(f"[17 placed] {label}: the sync: True reference, then the capture", flush=True)
    rep_t = solve(True)
    ref = bits()
    _sync_all()
    c0 = _placed_counters()
    puts0 = peer.peer_put.launches
    tic = time.perf_counter()
    solve(False)
    _sync_all()
    first_s = time.perf_counter() - tic
    first = _delta(_placed_counters(), c0)
    call = next(reversed(dispatch._GRAPH_CACHE.values()))[0]
    walls = {"sync_true": [], "sync_false": []}
    peaks = {"sync_true": {c: 0.0 for c in cards}, "sync_false": {c: 0.0 for c in cards}}
    same, itrs, tols = [], [], []
    for i in range(ACROSS_CALLS):
        for sync in ((True, False) if i % 2 == 0 else (False, True)):
            kind = "sync_true" if sync else "sync_false"
            _sync_all()
            for c in cards:
                torch.cuda.reset_peak_memory_stats(c)
            tic = time.perf_counter()
            rep = solve(sync)
            _sync_all()
            walls[kind].append(time.perf_counter() - tic)
            for c in cards:
                peaks[kind][c] = max(peaks[kind][c], torch.cuda.max_memory_allocated(c) / 2**30)
            if sync:
                continue
            out = bits()
            same.append(len(out) == len(ref) and all(torch.equal(a, b) for a, b in zip(out, ref)))
            itrs.append(int(rep["itr"]))
            tols.append(float(rep["tol"]) == rep_t["tol"])
    syncs = _count_syncs(lambda: solve(False))
    launches = _graph_replays(lambda: solve(False))
    _sync_all()
    out_itr, out_tol = call.static_outputs[1], call.static_outputs[2]
    replicas = {"itr": [int(p) for p in out_itr.parts], "tol": [float(p) for p in out_tol.parts],
                "go": [[bool(f) for f in flags] for flags in call.flags]}
    equal = all(len(set(map(str, v))) == 1 for v in (replicas["itr"], replicas["tol"])) and all(
        len(set(f)) == 1 for f in replicas["go"])
    # each card's loop body by node type: kernels and same-card copies, no
    # copy between two cards, no event node
    bodies = call.body_nodes
    across_nodes = sum(n.get("memcpy_across_devices", 0) + n.get("wait_event", 0)
                       + n.get("event_record", 0) for lanes in bodies for n in lanes)
    out = {"cards": cards, "itr": rep_t["itr"], "tol": rep_t["tol"], "sync_false_itr": itrs,
           "same_bits": same, "same_tol_bits": tols, "wall_s": walls,
           "wall_s_median": {k: statistics.median(v) for k, v in walls.items()},
           "first_sync_false_call_s": first_s, "capture_s": call.capture_s,
           "graphs": len(call.graphs), "graph_launches_per_call": launches,
           "host_syncs_per_call": syncs, "replicas": replicas, "replicas_equal": equal,
           "body_nodes_per_card": bodies, "cross_card_copy_or_event_nodes": across_nodes,
           "peer_put_launches_at_capture": peer.peer_put.launches - puts0,
           "transfers_across_at_capture": first["transfers_across"],
           "transfer_bytes_across_at_capture": first["transfer_bytes_across"],
           "peak_gib_per_card": peaks}
    if not (all(same) and all(tols) and itrs == [rep_t["itr"]] * ACROSS_CALLS and syncs == 0
            and launches == len(cards) == len(call.graphs) and equal and across_nodes == 0):
        raise RuntimeError(f"chip_smoke: {label}: sync: False across cards against sync: True: "
                           f"{json.dumps(out)}")
    return out


def graph_les_across_case(dev, label, dd, on_blocks: bool) -> dict:
    """(p)'s gates on the fused LES across cards: the TGV-3D LES at
    ``TGV_RUNG``^3 f32 with its solves on the placed ``dd`` (blocks on
    several cards), the state whole on the lead card or on the blocks
    (``on_blocks``: ``put_state``), two models stepped ``GRAPH_WARM`` steps
    then ``GRAPH_STEPS`` in chunks of ``GRAPH_CHUNK``, in turns: eager, and
    fused (one graph per card, ``FusedStepRunner`` with
    ``GraphedCall(lanes=...)``). After every chunk the fused state equals
    the eager one bit for bit (each Field's value and history), with the
    same ``itr`` per solve of the chunk's last step; the runner captured
    once, no fallback (the warning is an error here); one more step each
    counted for host syncs (0) and graph launches (one per card: the
    replays of ``torch.cuda.CUDAGraph``, ``_graph_replays``); no copy between
    cards and no event in any card's loop bodies (``GraphedCall.body_nodes``).
    Returns the numbers: ms per step of both, each card's peak."""
    import warnings

    import torch

    from pyapes_tpu_torch.parallel import blocks
    from pyapes_tpu_torch.solver.ops import solve_log

    cards = sorted({str(d) for d in dd.devices})
    (m_e, dt), (m_f, _) = (tgv_model(dev, TGV_RUNG, config={"decomp": dd}) for _ in range(2))
    if on_blocks:
        m_e.put_state(dd)
        m_f.put_state(dd)

    def itr_eager():
        with solve_log() as log:
            m_e.step(dt)
        return [int(r["itr"]) for r in log]

    def parts(x):
        return list(x.parts) if isinstance(x, blocks.BlockTensor) else [x]

    def bits_equal():
        return all(torch.equal(p, q) for a, b in zip(m_e.state_fields(), m_f.state_fields())
                   for lvl in ("_VAR", "_VARo")
                   for p, q in zip(parts(getattr(a, lvl)), parts(getattr(b, lvl))))

    def peaks_reset():
        for c in cards:
            torch.cuda.reset_peak_memory_stats(c)

    walls = {"eager": [], "fused": []}
    peaks = {k: {c: 0.0 for c in cards} for k in walls}
    same, itr_same = [], []
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*(falling back|stepping eagerly).*")
        m_e.run(dt, GRAPH_WARM)
        print(f"[17 placed] {label}: the eager warm steps ran; the fused ones (their warm-up "
              "and capture)", flush=True)
        tic = time.perf_counter()
        m_f.run(dt, GRAPH_WARM, fused=True)
        _sync_all()
        boot_s = time.perf_counter() - tic
        r_f = m_f.fused_runner()
        for i in range(GRAPH_STEPS // GRAPH_CHUNK):
            for kind in (("eager", "fused") if i % 2 == 0 else ("fused", "eager")):
                _sync_all()
                peaks_reset()
                tic = time.perf_counter()
                if kind == "eager":
                    for _ in range(GRAPH_CHUNK - 1):
                        m_e.step(dt)
                    itr_e = itr_eager()
                else:
                    r_f.run(dt, GRAPH_CHUNK)
                _sync_all()
                walls[kind].append((time.perf_counter() - tic) / GRAPH_CHUNK)
                for c in cards:
                    peaks[kind][c] = max(peaks[kind][c], torch.cuda.max_memory_allocated(c) / 2**30)
            same.append(bits_equal())
            itr_same.append(itr_e == [int(r["itr"]) for r in r_f.reports])
        syncs = _count_syncs(lambda: r_f.step(dt))
        replays = _graph_replays(lambda: r_f.step(dt))
        itr_e = [itr_eager(), itr_eager()][-1]
    _sync_all()
    same.append(bits_equal())
    itr_same.append(itr_e == [int(r["itr"]) for r in r_f.reports])
    call = next(iter(r_f._compiled.values())).call
    across_nodes = sum(n.get("memcpy_across_devices", 0) + n.get("wait_event", 0)
                       + n.get("event_record", 0) for lanes in call.body_nodes for n in lanes)
    out = {"cards": cards, "state": "blocks" if on_blocks else "whole", "dt": dt,
           "warm": GRAPH_WARM, "steps": GRAPH_STEPS, "chunk": GRAPH_CHUNK,
           "ms_per_step": {k: [1e3 * w for w in v] for k, v in walls.items()},
           "ms_per_step_median": {k: 1e3 * statistics.median(v) for k, v in walls.items()},
           "same_bits_per_chunk": same, "same_itr_last_step": itr_same,
           "itr_per_solve_last_step": itr_e, "captures": r_f.captures,
           "graphs": len(call.graphs), "bootstrap_s_fused": boot_s,
           "capture_s": r_f.capture_s, "host_syncs_per_step": syncs,
           "graph_launches_per_step": replays, "while_nodes_per_card": len(call.body_nodes),
           "cross_card_copy_or_event_nodes": across_nodes,
           "E_mean": float(m_f.kinetic_energy()) / (2 * pi) ** 3,
           "peak_gib_per_card": peaks}
    if not (all(same) and all(itr_same) and r_f.captures == 1 and syncs == 0
            and replays == len(cards) == len(call.graphs) and across_nodes == 0):
        raise RuntimeError(f"chip_smoke: {label}: {json.dumps(out)}")
    del m_e, m_f, r_f, call
    return out


def placed_graphs_across(dev) -> dict:
    """Phase 17 (p): the blocks round robin over ``GRAPH_CARDS`` cards. The
    probe (``scripts/probe_loop_across_cards_torch.py``, each variant a
    process of its own) records the runtime's refusal of one graph whose
    WHILE body spans two cards (two variants) and must run the design the
    port builds on, one graph per card joined by ``ops.peer``'s kernels
    (``per_card_graphs``). Then ``sync: False`` solves at full width on
    ``N_DECOMP`` blocks round robin, each one graph per card held to the
    ``sync: True`` solve on the same cards (``graph_across_case``): bench's
    MG-PCG 512^3 (bf16 V(2,2) FMG) with the Field on blocks, Darcy 256^3
    (its bf16 FMG cycle) with Γ and the Field on blocks, fastdiag 512^3 on
    blocks, CG + ``precond: "fd"`` 256^3 with a whole Field (the entry's
    scatter and the exit's gather outside the graphs). Then the fused TGV-3D
    LES 257^3 across the cards, one graph per card per step, its state whole
    and on the blocks, and on the blocks over ``LES_TWO_CARDS`` cards (four
    blocks on each), each held to its eager steps
    (``graph_les_across_case``). On fewer cards one line says it needs
    them. Returns the numbers and the drive's kernel launches
    (``counts``)."""
    import sys

    import torch

    from pyapes_tpu_torch.parallel import DomainDecomposition
    from pyapes_tpu_torch.solver.linalg.dispatch import clear_cache

    n_cards = torch.cuda.device_count()
    if n_cards < GRAPH_CARDS:
        print(f"[17 placed] (p) graphs across cards: needs {GRAPH_CARDS} cards; this machine "
              f"shows {n_cards} (run it on a host with {GRAPH_CARDS})", flush=True)
        return {"skipped": f"needs {GRAPH_CARDS} cards, has {n_cards}"}
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                          "probe_loop_across_cards_torch.py")
    run = subprocess.run([sys.executable, script], capture_output=True, text=True, timeout=900)
    probe = json.loads(run.stdout.strip().splitlines()[-1])
    card = _card_line()
    out = {"probe": probe, "cards": probe.get("cards")}
    print(f"[17 placed] (p) the probe: {json.dumps(probe)}", flush=True)
    if not all(probe[k].get("ok") for k in ("per_card_graphs", "per_card_graphs_one_card",
                                             "per_card_graphs_large",
                                             "per_card_graphs_one_card_large")):
        raise RuntimeError("chip_smoke: (p) the runtime refuses one graph per card joined by "
                           f"the peer kernels: {json.dumps(probe)}")
    dd = DomainDecomposition(N_DECOMP, devices=tuple(f"cuda:{i % GRAPH_CARDS}"
                                                     for i in range(prod(N_DECOMP))))
    mg = {k: v for k, v in mg_cfg(BENCH_MG).items() if k != "donate"}
    cases = (
        ("p_mgpcg", f"(p) MG-PCG {N_MAIN}^3 f32 bf16 V(2,2) FMG (bench's), the Field on "
         "blocks", N_MAIN, False, {**mg, "decomp": dd}),
        ("p_darcy", f"(p) Darcy {N_DARCY}^3 f32 bf16 V(2,2) FMG (Darcy's), Γ and the Field on "
         "blocks", N_DARCY, True, {**darcy_cfg(), "decomp": dd}),
        ("p_fastdiag", f"(p) fastdiag {N_MAIN}^3 f32, the Field on blocks", N_MAIN, False,
         fd_cfg(dd)),
        ("p_cg_fd", f"(p) CG + precond fd {PLACED_FD_CG_N}^3 f32, a whole Field",
         PLACED_FD_CG_N, None, {"method": "cg", "precond": "fd", "tol": 1e-6, "max_it": 200,
                                "criterion": "residual", "decomp": dd}))
    counts = {}
    for key, label, n, darcy, cfg in cases:
        if darcy is None:
            _, var, rhs = placed_problem(dev, (n,) * 3)
            coeff = 1.0
        else:
            _, var, rhs, coeff = _block_problem(dev, dd, (n,) * 3, darcy=darcy)
        out[key] = _counted_drive(counts, lambda: graph_across_case(label, var, rhs, cfg, coeff))
        print(f"[17 placed] {label}, {N_DECOMP} round robin over {GRAPH_CARDS} cards, sync: False "
              f"(one graph per card) against sync: True on the same cards; cards {card}: "
              f"{json.dumps(out[key])}", flush=True)
        del var, rhs, coeff
        clear_cache()
        for i in range(GRAPH_CARDS):
            with torch.cuda.device(i):
                torch.cuda.empty_cache()
    dd2 = DomainDecomposition(N_DECOMP, devices=tuple(f"cuda:{i % LES_TWO_CARDS}"
                                                      for i in range(prod(N_DECOMP))))
    for key, on_blocks, d, n_cards in (("p_tgv_les_fused", False, dd, GRAPH_CARDS),
                                       ("p_tgv_les_fused_blocks", True, dd, GRAPH_CARDS),
                                       ("p_tgv_les_fused_blocks_two_cards", True, dd2,
                                        LES_TWO_CARDS)):
        label = (f"(p) TGV-3D LES {TGV_RUNG}^3 f32 torus {N_DECOMP}, fused, the state "
                 f"{'on the blocks' if on_blocks else 'whole'}")
        out[key] = _counted_drive(counts, lambda: graph_les_across_case(dev, label, d,
                                                                        on_blocks))
        print(f"[17 placed] {label}, round robin over {n_cards} cards, one graph per card "
              f"per step against eager steps on the same cards; cards {card}: "
              f"{json.dumps(out[key])}", flush=True)
        clear_cache()
        for i in range(GRAPH_CARDS):
            with torch.cuda.device(i):
                torch.cuda.empty_cache()
    out["counts"] = counts
    print(f"[17 placed] (p) the drive's kernel launches "
          f"{json.dumps({k: v for k, v in counts.items() if v})}", flush=True)
    return out


# (q)-(r): the last options on placed blocks, block Fields on periodic axes
OPT_N, OPT_PI_N = 256, 128  # (q): the obstacle, custom, debug and donate grid; per_iteration
OPT_NEUMANN_N = 128  # (q): the Neumann body's MG-BiCGSTAB (163 iterations at 256^3 f32, 36 s)
OPT_MG = {"method": "cg", "tol": 1e-5, "max_it": 300, "criterion": "residual", "precond": "mg"}
OPT_AGREE = 1e-5  # (q): the block Field's solution against the whole Field's, relative (f32)
OPT_CUSTOM_W = 0.9  # (q): the custom operator's neighbour weight
TORUS_STEPS = GRAPH_WARM + GRAPH_STEPS + 2  # (r): (o)'s steps, so <E> compares step for step
TORUS_E_TOL = 1e-6  # (r): <E> against (o)'s whole-state run, relative


def _opt_obstacle(dev, n, dd, on_blocks, neumann: bool):
    """(q)'s obstacle problem: the unit cube at ``n``^3 f32, Dirichlet
    walls, a Dirichlet body at 1 and (``neumann``) a Neumann body with flux 2
    (its shells cut by block faces), a seeded RHS; the Field and RHS on
    ``dd``'s blocks with ``on_blocks``. ``(var, lhs, rhs)``, ``lhs`` making the
    equation's left-hand side."""
    import torch

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.parallel import blocks
    from pyapes_tpu_torch.solver.fdm import FDM
    from pyapes_tpu_torch.variables import Field
    from pyapes_tpu_torch.variables.bcs import homogeneous_bcs

    bodies = [Box[0.2:0.35, 0.3:0.6, 0.3:0.6], Box[0.6:0.8, 0.35:0.65, 0.4:0.7]]
    kinds = [{"bc_type": "dirichlet", "bc_val": 1.0}, {"bc_type": "neumann", "bc_val": 2.0}]
    k = 2 if neumann else 1
    mesh = Mesh(Box[0:1, 0:1, 0:1], bodies[:k], [n] * 3, device=str(dev), dtype="single")
    var = Field("p", 1, mesh, {"domain": homogeneous_bcs(3, 0.0, "dirichlet"),
                               "obstacle": kinds[:k]}, init_val=0.0)
    g = torch.Generator(device=mesh.device).manual_seed(0)
    rhs = torch.randn((1, n, n, n), generator=g, device=mesh.device, dtype=mesh.dtype.float)
    if on_blocks:
        var.VAR = blocks.put(var(), dd)
        rhs = blocks.put(rhs, dd)
    return var, lambda: FDM().laplacian(1.0, var), rhs


def _opt_custom(dev, n, dd, on_blocks, calls: list):
    """(q)'s custom problem: ``fdm.custom`` of a weighted diagonal minus the
    six neighbours (``OPT_CUSTOM_W``; an opaque torch function of the
    whole tensor) with a separable ``fd_hint``, Dirichlet walls, a seeded
    RHS; each apply appended to ``calls``."""
    import torch

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.parallel import blocks
    from pyapes_tpu_torch.solver.fdm import FDM
    from pyapes_tpu_torch.variables import Field
    from pyapes_tpu_torch.variables.bcs import homogeneous_bcs

    mesh = Mesh(Box[0:1, 0:1, 0:1], None, [n] * 3, device=str(dev), dtype="single")
    var = Field("u", 1, mesh, {"domain": homogeneous_bcs(3, 0.0, "dirichlet")}, init_val=0.0)
    g = torch.Generator(device=mesh.device).manual_seed(1)
    w = 1.0 + 0.2 * torch.rand((n,) * 3, generator=g, device=mesh.device)
    rhs = torch.randn((1, n, n, n), generator=g, device=mesh.device)

    def op(x, c):
        calls.append(1)
        nb = sum(torch.roll(x, s, a) for a in (1, 2, 3) for s in (1, -1))
        return 6.0 * c * x - OPT_CUSTOM_W * nb

    hint = tuple(tuple([v] * n for v in (-OPT_CUSTOM_W, 6.0 * 1.1 / 3, -OPT_CUSTOM_W))
                 for _ in range(3))
    if on_blocks:
        var.VAR = blocks.put(var(), dd)
        rhs = blocks.put(rhs, dd)
    return var, lambda: FDM().custom(op, var, params=(w,), fd_hint=hint), rhs


def _opt_per_iteration(dev, n, dd, on_blocks):
    """(q)'s per_iteration problem: the upper x face chases half the
    iterate's mean, resolved at every application, the other faces 0, a
    seeded RHS."""
    import torch

    from pyapes_tpu_torch.geometry import Box
    from pyapes_tpu_torch.mesh import Mesh
    from pyapes_tpu_torch.parallel import blocks
    from pyapes_tpu_torch.solver.fdm import FDM
    from pyapes_tpu_torch.variables import Field

    def follower(grid, mask, var, opt):
        return 0.5 * torch.mean(var)

    faces = ("xl", "xu", "yl", "yu", "zl", "zu")
    bcs = [{"bc_face": f, "bc_type": "dirichlet", "bc_val": follower if f == "xu" else 0.0,
            "bc_val_opt": {"per_iteration": True} if f == "xu" else None} for f in faces]
    mesh = Mesh(Box[0:1, 0:1, 0:1], None, [n] * 3, device=str(dev), dtype="single")
    var = Field("u", 1, mesh, {"domain": bcs}, init_val=0.0)
    g = torch.Generator(device=mesh.device).manual_seed(2)
    rhs = torch.randn((1, n, n, n), generator=g, device=mesh.device)
    if on_blocks:
        var.VAR = blocks.put(var(), dd)
        rhs = blocks.put(rhs, dd)
    return var, lambda: FDM().laplacian(1.0, var), rhs


def _opt_poisson(dev, n, dd, on_blocks, nan_at=None):
    """(q)'s 256^3 Poisson (``placed_problem``'s), the Field and RHS on
    ``dd``'s blocks with ``on_blocks``; ``nan_at``: a NaN planted in the
    RHS at that node."""
    from pyapes_tpu_torch.parallel import blocks
    from pyapes_tpu_torch.solver.fdm import FDM

    _, var, rhs = placed_problem(dev, (n,) * 3)
    if nan_at is not None:
        rhs[(0, *nan_at)] = float("nan")
    if on_blocks:
        var.VAR = blocks.put(var(), dd)
        rhs = blocks.put(rhs, dd)
    return var, lambda: FDM().laplacian(1.0, var), rhs


def _opt_solve(var, lhs, rhs, cfg) -> dict:
    """One solve through ``Solver.solve``: its report, wall, the counter
    deltas, the first card's peak and the solution (on the host)."""
    import torch

    from pyapes_tpu_torch.parallel import blocks
    from pyapes_tpu_torch.solver.ops import Solver

    s = Solver({"fdm": {"report": False, **cfg}})
    s.set_eq(lhs() == rhs)
    _sync_all()
    cards = range(torch.cuda.device_count())
    for i in cards:
        torch.cuda.reset_peak_memory_stats(i)
    c0 = {**_placed_counters(), "per_iteration_gathers": blocks.per_iteration_gathers}
    tic = time.perf_counter()
    rep = s.solve()
    _sync_all()
    wall = time.perf_counter() - tic
    c1 = {**_placed_counters(), "per_iteration_gathers": blocks.per_iteration_gathers}
    peaks = [torch.cuda.max_memory_allocated(i) / 2**30 for i in cards]
    counts = {k: v for k, v in _delta(c1, c0).items() if v}
    return {"itr": rep["itr"], "tol": rep["tol"], "converge": rep["converge"], "wall_s": wall,
            "peak_gib_card0": peaks[0], "peak_gib_per_card": peaks, "counts": counts,
            "x": var().cpu()}


def _opt_pair(label, make, cfg, gathers_ok, launches, calls=None) -> dict:
    """A (q) case: a warm-up solve of the whole Field (its hierarchy and
    factors are the block Field's too), then the whole Field (placed, the
    entry's scatter and the exit's gather) and the Field on blocks: the
    same ``itr``, the solutions within ``OPT_AGREE``, ``gathers_ok(counts)``
    on the block Field's counts (``calls``: the list a custom operator
    appends to at each apply, counted as ``custom_applies``). Returns the
    numbers."""
    import torch

    runs = {}
    for kind in ("whole_field", "block_field"):
        var, lhs, rhs = make(kind == "block_field")
        if kind == "whole_field":
            _counted_drive(launches, lambda: _opt_solve(var, lhs, rhs, cfg))  # warm
            var.set_var_tensor(torch.zeros_like(var()))
        n0 = len(calls) if calls is not None else 0
        runs[kind] = _counted_drive(launches, lambda: _opt_solve(var, lhs, rhs, cfg))
        if calls is not None:
            runs[kind]["counts"]["custom_applies"] = len(calls) - n0
        del var, rhs
        torch.cuda.empty_cache()
    w, b = runs["whole_field"], runs["block_field"]
    agree = _rel(b.pop("x"), w.pop("x"))
    out = {"itr": b["itr"], "whole_itr": w["itr"], "max_rel_diff_vs_whole": agree,
           "wall_s": b["wall_s"], "whole_wall_s": w["wall_s"],
           "peak_gib_per_card": b["peak_gib_per_card"],
           "whole_peak_gib_per_card": w["peak_gib_per_card"],
           "counts": b["counts"], "whole_counts": w["counts"]}
    if not (b["converge"] and b["itr"] == w["itr"] and agree <= OPT_AGREE
            and gathers_ok(b["counts"]) and not b["counts"].get("host_gathers")):
        raise RuntimeError(f"chip_smoke: {label}: {json.dumps(out)}")
    return out


def _opt_debug_donate(dev, dd, launches) -> dict:
    """(q)'s ``debug: "nan"`` and ``donate`` on the ``OPT_N``^3 Poisson, the
    Field on blocks: the checked solve gives the unchecked one's ``itr``
    and bits, a NaN planted in the last block (at ``OPT_PI_N``^3) raises
    ``NaNError`` naming the whole Field's first operation, no gather; the donated solve gives
    the undonated bits in the Field's own blocks (each ``data_ptr`` kept)
    with a peak no higher than the undonated one's."""
    import torch

    from pyapes_tpu_torch.parallel import blocks
    from pyapes_tpu_torch.utils.debug import NaNError

    out = {}
    cfg = {**OPT_MG, "decomp": dd}
    runs = {}
    for key, extra in (("plain", {}), ("debug_nan", {"debug": "nan"}),
                       ("donate", {"donate": True})):
        var, lhs, rhs = _opt_poisson(dev, OPT_N, dd, True)
        ptrs = [p.data_ptr() for p in var().parts]
        runs[key] = _counted_drive(launches, lambda: _opt_solve(var, lhs, rhs, {**cfg, **extra}))
        runs[key]["same_storage"] = [p.data_ptr() for p in var().parts] == ptrs
        del var, rhs
        torch.cuda.empty_cache()
    x0 = runs["plain"]["x"]
    for key in ("debug_nan", "donate"):
        r = runs[key]
        out[key] = {"itr": r["itr"], "plain_itr": runs["plain"]["itr"],
                    "same_bits": bool(torch.equal(r["x"], x0)), "wall_s": r["wall_s"],
                    "plain_wall_s": runs["plain"]["wall_s"], "counts": r["counts"],
                    "peak_gib_card0": r["peak_gib_card0"],
                    "peak_gib_per_card": r["peak_gib_per_card"], "same_storage": r["same_storage"]}
    out["donate"]["plain_peak_gib_card0"] = runs["plain"]["peak_gib_card0"]
    # the NaN's detection at the per_iteration grid: no scale is at stake
    names = {}
    last = tuple(s.start + 3 for s in blocks.layout(dd, (OPT_PI_N,) * 3, dev).blocks[-1][1])
    for kind in ("block_field", "whole_field"):
        var, lhs, rhs = _opt_poisson(dev, OPT_PI_N, dd, kind == "block_field", nan_at=last)
        c0 = _placed_counters()
        try:
            _counted_drive(launches, lambda: _opt_solve(var, lhs, rhs, {**cfg, "debug": "nan"}))
        except NaNError as e:
            names[kind] = e.op
        else:
            raise RuntimeError(f"chip_smoke: (q) debug 'nan' missed the NaN at {last} ({kind})")
        c = _delta(_placed_counters(), c0)
        if kind == "block_field" and c["gathers"] != c["cycle_gathers"]:
            raise RuntimeError("chip_smoke: (q) the NaN check of a block Field gathered: "
                               f"{json.dumps(c)}")
        del var, rhs
        torch.cuda.empty_cache()
    out["debug_nan"].update({"nan_at": list(last), "nan_op": names})
    d, n = out["donate"], out["debug_nan"]
    if not (n["same_bits"] and n["itr"] == n["plain_itr"] and names["block_field"]
            == names["whole_field"] and d["same_bits"] and d["same_storage"]
            and d["itr"] == d["plain_itr"]
            and d["peak_gib_card0"] <= d["plain_peak_gib_card0"] + 1e-3):
        raise RuntimeError(f"chip_smoke: (q) debug / donate on blocks: {json.dumps(out)}")
    return out


def placed_options(dev, launches: dict, dd=None, prefix: str = "(q)") -> dict:
    """Phase 17 (q): the last options on placed blocks (``("cuda:0",) * 8``
    in ``N_DECOMP`` unless ``dd``), f32, each held to the same problem with
    the whole Field (the same ``itr``, ``OPT_AGREE``, the gathers as
    designed): obstacle solves, MG-PCG with a static Dirichlet body at
    ``OPT_N``^3 and MG-BiCGSTAB with it and a Neumann body with nonzero
    flux at ``OPT_NEUMANN_N``^3 (no gather but the V-cycle's hand-over), a
    custom term with ``fd_hint`` and ``precond: "fd"`` at
    ``OPT_N``^3 (one gather per custom apply), a ``per_iteration`` BC at
    ``OPT_PI_N``^3 (one gather per application: two per CG solve), and
    ``debug: "nan"`` and ``donate`` on the ``OPT_N``^3 Poisson. Returns the
    numbers, checked."""
    dd = dd or _one_card_dd()
    card = _card_line()
    tic = time.perf_counter()
    out = {}
    hand = lambda c: c.get("gathers", 0) == c.get("cycle_gathers", 0)  # noqa: E731
    out["obstacle_mgpcg"] = _opt_pair(
        f"{prefix} Dirichlet body, MG-PCG {OPT_N}^3",
        lambda b: _opt_obstacle(dev, OPT_N, dd, b, False), {**OPT_MG, "decomp": dd}, hand,
        launches)
    # a Neumann body makes the system nonsymmetric: MG-BiCGSTAB, as the JAX
    # package's test_mg_bicgstab_obstacle_poisson and the models choose (CG
    # + MG stalls near the tolerance from 128^3 on)
    out["obstacle_mgbicgstab"] = _opt_pair(
        f"{prefix} Dirichlet and Neumann bodies, MG-BiCGSTAB {OPT_NEUMANN_N}^3",
        lambda b: _opt_obstacle(dev, OPT_NEUMANN_N, dd, b, True),
        {**OPT_MG, "method": "bicgstab", "decomp": dd}, hand, launches)
    calls: list = []
    out["custom_fd"] = _opt_pair(
        f"{prefix} custom + fd_hint {OPT_N}^3", lambda b: _opt_custom(dev, OPT_N, dd, b, calls),
        {"method": "bicgstab", "tol": 1e-5, "max_it": 200, "criterion": "residual",
         "precond": "fd", "decomp": dd},
        lambda c: c["custom_applies"] > 0 and c.get("gathers", 0) == c["custom_applies"],
        launches, calls)
    out["per_iteration"] = _opt_pair(
        f"{prefix} per_iteration {OPT_PI_N}^3",
        lambda b: _opt_per_iteration(dev, OPT_PI_N, dd, b), {**OPT_MG, "decomp": dd},
        lambda c: c.get("per_iteration_gathers") == 2
        and c.get("gathers", 0) == 2 + c.get("cycle_gathers", 0), launches)
    out.update(_opt_debug_donate(dev, dd, launches))
    out["phase_s"] = time.perf_counter() - tic
    print(f"[17 placed] {prefix} the last options on {N_DECOMP} blocks on {dd.devices[:2]}..., "
          f"f32, the Field on blocks against the whole Field; card {card}: {json.dumps(out)}",
          flush=True)
    return out


def _torus_run(dev, dd, fused: bool, steps: int) -> dict:
    """The TGV-3D LES at ``TGV_RUNG``^3 f32 with its solves on ``dd`` and its
    state on the blocks (``put_state``), ``steps`` steps eager or fused
    (the first ``GRAPH_WARM`` through ``run``): wall per step, counter
    deltas, the cards' peaks, <E>, the captures."""
    import torch

    from pyapes_tpu_torch.parallel import blocks

    model, dt = tgv_model(dev, TGV_RUNG, config={"decomp": dd})
    model.put_state(dd)
    torch.cuda.empty_cache()
    _sync_all()
    cards = range(torch.cuda.device_count())
    for i in cards:
        torch.cuda.reset_peak_memory_stats(i)
    model.run(dt, GRAPH_WARM, fused=fused)
    _sync_all()
    c0 = _placed_counters()
    tic = time.perf_counter()
    if fused:
        model.fused_runner().run(dt, steps - GRAPH_WARM)
    else:
        for _ in range(steps - GRAPH_WARM):
            model.step(dt)
    _sync_all()
    wall = (time.perf_counter() - tic) / (steps - GRAPH_WARM)
    counts = _no_host_gathers(_delta(_placed_counters(), c0))
    on_blocks = all(isinstance(f(), blocks.BlockTensor) for f in model.state_fields())
    out = {"wall_s_per_step": wall, "gathers": counts["gathers"],
           "state_on_blocks": on_blocks,
           "E_mean": float(model.kinetic_energy()) / (2 * pi) ** 3,
           "peak_gib_per_card": [torch.cuda.max_memory_allocated(i) / 2**30 for i in cards],
           "captures": model.fused_runner().captures if fused else None}
    del model
    torch.cuda.empty_cache()
    return out


def placed_torus(dev, launches: dict, o_ref: dict, dd=None, prefix: str = "(r)",
                 kinds=("eager", "fused")) -> dict:
    """Phase 17 (r): the TGV-3D LES at ``TGV_RUNG``^3 f32 with its state on
    the blocks (``("cuda:0",) * 8`` unless ``dd``), eager and fused,
    ``TORUS_STEPS`` steps (as many as (o)'s), against (o)'s runs with the
    whole state: <E> within ``TORUS_E_TOL`` relative, no gather in a step,
    the state still on the blocks, one capture; the lead card's peak beside
    (o)'s. Returns the numbers, checked."""
    dd = dd or _one_card_dd()
    tic = time.perf_counter()
    out = {}
    for kind in kinds:
        r = _counted_drive(launches, lambda: _torus_run(dev, dd, kind == "fused", TORUS_STEPS))
        ref = o_ref["E_mean"][f"{kind}_placed"]
        r.update({"o_E_mean": ref, "E_rel_diff": abs(r["E_mean"] - ref) / ref,
                  "o_peak_gib_card0": o_ref["peak_gib_card0"][f"{kind}_placed"],
                  "o_wall_s_per_step_median":
                  o_ref["wall_s_per_step_median"][f"{kind}_placed"]})
        if not (r["E_rel_diff"] <= TORUS_E_TOL and r["gathers"] == 0 and r["state_on_blocks"]
                and r["captures"] in (None, 1)):
            raise RuntimeError(f"chip_smoke: {prefix} {kind}: {json.dumps(r)}")
        out[kind] = r
    out["phase_s"] = time.perf_counter() - tic
    print(f"[17 placed] {prefix} TGV-3D LES {TGV_RUNG}^3 f32, the state on {N_DECOMP} blocks "
          f"on {dd.devices[:2]}..., {TORUS_STEPS} steps, against (o)'s whole state; card "
          f"{_card_line()}: {json.dumps(out)}", flush=True)
    return out


def options_across(dev, launches: dict, o_ref: dict) -> dict:
    """Phase 17 (p), continued: (q)'s cases and (r)'s eager LES with the
    blocks round robin over ``GRAPH_CARDS`` cards (``sync: True``: fused
    steps across cards stay refused); on fewer cards one line says it needs
    them."""
    import torch

    from pyapes_tpu_torch.parallel import DomainDecomposition

    n_cards = torch.cuda.device_count()
    if n_cards < GRAPH_CARDS:
        print(f"[17 placed] (p) (q) and (r) across cards: needs {GRAPH_CARDS} cards; this "
              f"machine shows {n_cards}", flush=True)
        return {"skipped": f"needs {GRAPH_CARDS} cards, has {n_cards}"}
    dd = DomainDecomposition(N_DECOMP, devices=tuple(f"cuda:{i % GRAPH_CARDS}"
                                                     for i in range(prod(N_DECOMP))))
    return {"q": placed_options(dev, launches, dd, "(p) (q) across cards"),
            "r": placed_torus(dev, launches, o_ref, dd, "(p) (r) across cards", ("eager",))}


def phase_placed(dev) -> dict:
    """Phase 17: a placed ``DomainDecomposition`` (each block of every loop
    vector its own allocation on its card, round robin over the cards the
    machine shows) through ``Solver.solve``: (a) bench's MG-PCG at 512^3
    f32 (bf16 V(2,2) FMG) in (4, 2, 1) blocks against the view-based
    decomposed solve of the same problem, 3 timed solves each; (b)
    unpreconditioned CG at 512^3 f32 (4, 2, 1), ``PLACED_CG_MAX_IT``
    iterations in both layouts, zero gathers; (c) the mixed placement
    ``("cuda:0", "cpu") * 4`` at 64^3 f64 (2, 2, 2), CG and MG-PCG, and a
    2-D (4, 1) CG on ``("cuda:0", "cpu") * 2`` at 256^2 f64, each equal to
    the view-based solve (the same itr, ``PLACED_CMP_TOL``); (d) bench's
    fastdiag at 512^3 f32 in (4, 2, 1) placed blocks, ``PLACED_FD_TURNS``
    solves in turns with the view-based one: the undecomposed solve's
    passes and solution (``FD_DECOMP_AGREE``), the f64 true residual
    within ``FD_TOL``, no gather, the halo-extended kernel once per block
    and residual, the pencil repartitions of every FD apply (each moving
    the whole vector); (e) CG with ``precond: "fd"`` at 256^3 f32 placed:
    the view-based itr; (f)-(i) the variable-Γ and Div/Conv terms and
    ``PeriodicFlow`` (``placed_terms``): bench_darcy's 256^3 solve,
    ``BurgersND`` 257^3, the upwind advection-diffusion 256^3 and the
    TGV-3D LES 257^3 rung, each against the view-based run, and their
    card/CPU mixes in f64; (j)-(l) the Field on blocks (``placed_fields``):
    fastdiag and MG-PCG 512^3, Darcy 256^3 with Γ on blocks; (m) 1536^3
    f32 on four cards (``placed_large``). Returns the launches of the placed
    drives (each counted from 0)."""
    import torch

    from pyapes_tpu_torch.parallel import DomainDecomposition, blocks, halo
    from pyapes_tpu_torch.solver.linalg.dispatch import clear_cache

    tic0 = time.perf_counter()
    launches = {name: 0 for name in _counts()}
    refs: dict = {}  # (a), (d) and (f)'s view-based solutions and peaks, for (j)-(l)
    drive = _driver(launches)
    devs = placed_devices(prod(N_DECOMP))
    n_cards = len(set(devs))
    n_cuda = sum(1 for d in devs if d.startswith("cuda"))
    out = {"cards_used": n_cards, "devices": list(devs), "decomp": list(N_DECOMP)}
    placed_dd = DomainDecomposition(N_DECOMP, devices=devs)
    mesh, var, rhs = placed_problem(dev, (N_MAIN,) * 3)

    # (a) MG-PCG: the view-based decomposed solve, then the placed one
    mg = {k: v for k, v in mg_cfg(BENCH_MG).items() if k != "donate"}
    view = run_layout(var, rhs, {**mg, "decomp": DomainDecomposition(N_DECOMP)}, 3)
    placed = drive(var, rhs, {**mg, "decomp": placed_dd}, 3)
    a = _placed_summary("(a) placed MG-PCG", placed, n_cuda)
    d_itr = [abs(p["itr"] - v["itr"]) for p, v in zip(placed["rows"], view["rows"])]
    agree = _rel(placed["x"], view["x"])
    res32, res64 = _true_residuals(mesh, var, rhs, 1.0, placed["x"])
    n_lv, hand = _handover(placed_dd, (N_MAIN,) * 3)
    # the transfers between placed levels run block by block: a V-cycle
    # gathers at its hand-over only, an FMG start there once per V-cycle and
    # its restriction chain
    counts_ok = all(r["cycle_gathers"] == hand * r["vcycles"]
                    and r["fmg_gathers"] == hand * (1 + n_lv)
                    and r["gathers"] == r["cycle_gathers"] + r["fmg_gathers"]
                    and r["entry_scatters"] == 2 and r["exit_gathers"] == 1
                    for r in placed["rows"])
    if not (all(r["converge"] and r["tol"] <= 1e-6 for r in placed["rows"])
            and max(d_itr) <= PLACED_GATE and agree <= PLACED_AGREE and res64 <= 1e-5
            and counts_ok):
        raise RuntimeError(f"chip_smoke: (a) placed MG-PCG: itr {a['itr']} against "
                           f"{[r['itr'] for r in view['rows']]}, max|dx|/max|x| {agree:.3e} "
                           f"(limit {PLACED_AGREE}), true residual f64 {res64:.3e}, gathers "
                           f"{json.dumps(placed['rows'])} ({n_lv} placed levels, hand-over "
                           f"{hand})")
    refs["a"] = {"itr": [r["itr"] for r in view["rows"]], "x": view["x"].cpu(),
                 "peak_gib": placed["peak_gib"]}
    # one apply of the fine operator in f32, its exchange alone
    lay = blocks.layout(placed_dd, (N_MAIN,) * 3, dev)
    xb = blocks.scatter(placed["x"], lay)
    coeffs = tuple(tuple(torch.ones(N_MAIN, device=dev) for _ in range(3)) for _ in range(3))
    b0 = halo.exchange_bytes
    halo.make_sharded_apply(placed_dd, 3)(coeffs, xb)
    _sync_all()
    ghost32 = _ghost_bytes(N_DECOMP, (1,) + (N_MAIN,) * 3, 4)
    if halo.exchange_bytes - b0 != ghost32:
        raise RuntimeError(f"chip_smoke: one placed apply moved {halo.exchange_bytes - b0} bytes, "
                           f"its ghost faces {ghost32}")
    del xb
    a.update({"view_itr": [r["itr"] for r in view["rows"]],
              "view_wall_s": [r["wall_s"] for r in view["rows"]],
              "view_wall_s_median": statistics.median(r["wall_s"] for r in view["rows"]),
              "view_axis_stencil_ext_per_solve": view["rows"][-1]["axis_stencil_ext"],
              "view_peak_mem_gib_per_card": view["peak_gib"],
              "max_rel_diff_vs_view": agree, "true_rel_residual_f32": res32,
              "true_rel_residual_f64": res64, "fine_apply_exchange_bytes_f32": ghost32})
    # the memory reckoning: the peak per grid point, and the largest cube
    # whose solve one card of this memory holds at that rate
    per_point = max(placed["peak_gib"]) * 2**30 / N_MAIN**3
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    a.update({"peak_bytes_per_point": per_point, "card_bytes": card_bytes,
              "largest_cube_one_card": int((card_bytes / per_point) ** (1 / 3))})
    out["a_mgpcg"] = a
    print(f"[17 placed] (a) MG-PCG {N_MAIN}^3 f32 bf16 V(2,2) FMG {N_DECOMP} on {n_cards} "
          f"card(s): {json.dumps(a)}", flush=True)
    del view, placed

    # (b) CG, capped: both layouts at the same itr, no gather
    cg = {"method": "cg", "tol": 1e-6, "max_it": PLACED_CG_MAX_IT, "criterion": "residual"}
    view = run_layout(var, rhs, {**cg, "decomp": DomainDecomposition(N_DECOMP)}, 1)
    placed = drive(var, rhs, {**cg, "decomp": placed_dd}, 1)
    b = _placed_summary("(b) placed CG", placed, n_cuda, ghost32)
    agree = _rel(placed["x"], view["x"])
    if not (b["itr"] == [r["itr"] for r in view["rows"]] == [PLACED_CG_MAX_IT]
            and b["gathers_per_solve"] == 0 and agree <= PLACED_CG_AGREE):
        raise RuntimeError(f"chip_smoke: (b) placed CG: itr {b['itr']}, gathers "
                           f"{b['gathers_per_solve']}, max|dx|/max|x| {agree:.3e} (limit "
                           f"{PLACED_CG_AGREE})")
    b.update({"max_it_cap": PLACED_CG_MAX_IT, "gathers_per_iteration": 0.0,
              "view_wall_s": view["rows"][-1]["wall_s"], "max_rel_diff_vs_view": agree,
              "view_peak_mem_gib_per_card": view["peak_gib"]})
    out["b_cg"] = b
    print(f"[17 placed] (b) CG {N_MAIN}^3 f32 {N_DECOMP}, capped at {PLACED_CG_MAX_IT} "
          f"iterations (time): {json.dumps(b)}", flush=True)
    del view, placed, var, rhs, mesh

    # (c) the mixed placement: card and CPU blocks, against the view-based solve
    mixed = {}
    n3, n2 = PLACED_CMP_N, PLACED_CMP_N2
    cases = [(f"CG {n3}^3 (2, 2, 2)", (n3,) * 3, (2, 2, 2), PLACED_CMP_CG),
             (f"MG-PCG {n3}^3 (2, 2, 2)", (n3,) * 3, (2, 2, 2),
              {**PLACED_CMP_CG, "precond": "mg"}),
             (f"CG {n2}^2 (4, 1)", (n2,) * 2, (4, 1), PLACED_CMP_CG)]
    for label, nodes, ms, cfg in cases:
        mdevs = MIXED_PAIR * (prod(ms) // 2)
        n_card = sum(1 for d in mdevs if d.startswith("cuda"))
        _, var, rhs = placed_problem(dev, nodes, "double", seed=1)
        view = run_layout(var, rhs, {**cfg, "decomp": DomainDecomposition(ms)}, 1)
        placed = drive(var, rhs, {**cfg, "decomp": DomainDecomposition(ms, devices=mdevs)}, 1)
        rp, rv = placed["rows"][-1], view["rows"][-1]
        agree = _rel(placed["x"], view["x"])
        if len(nodes) == 3 and rp["axis_stencil_ext"] != n_card * rp["placed_applies"]:
            raise RuntimeError(f"chip_smoke: (c) {label}: {rp['axis_stencil_ext']} "
                               "axis_stencil_ext launches for the card blocks' "
                               f"{rp['placed_applies']} applies")
        if len(nodes) == 2 and rp["axis_stencil"] < n_card * rp["placed_applies"]:
            raise RuntimeError(f"chip_smoke: (c) {label}: {rp['axis_stencil']} axis_stencil "
                               f"launches for the card blocks' {rp['placed_applies']} applies")
        if not (rp["converge"] and rp["itr"] == rv["itr"] and agree <= PLACED_CMP_TOL):
            raise RuntimeError(f"chip_smoke: (c) {label} on {mdevs}: itr {rp['itr']} against "
                               f"{rv['itr']}, max|dx|/max|x| {agree:.3e} (limit "
                               f"{PLACED_CMP_TOL})")
        mixed[label] = {"devices": list(mdevs), "itr": rp["itr"], "view_itr": rv["itr"],
                        "max_rel_diff_vs_view": agree, "wall_s": rp["wall_s"],
                        "view_wall_s": rv["wall_s"], "gathers": rp["gathers"],
                        "axis_stencil_ext": rp["axis_stencil_ext"],
                        "axis_stencil": rp["axis_stencil"],
                        "exchange_bytes": rp["exchange_bytes"]}
        del view, placed, var, rhs
    out["c_mixed"] = mixed
    print(f"[17 placed] (c) mixed card/CPU placements, f64 (tolerance {PLACED_CMP_TOL}): "
          f"{json.dumps(mixed)}", flush=True)

    out.update(placed_fastdiag(dev, drive, refs))
    out.update(placed_terms(dev, launches, refs))
    out.update(placed_fields(dev, launches, refs))
    out["m_large"] = placed_large(dev, launches)
    out.update(placed_graphs(dev, launches))
    out["q_options"] = placed_options(dev, launches)
    clear_cache()
    torch.cuda.empty_cache()
    out["r_torus"] = placed_torus(dev, launches, out["o_tgv_les"])
    out["p_options_across"] = options_across(dev, launches, out["o_tgv_les"])
    print(f"[17 placed] launches of the placed drives {json.dumps(launches)}; peer copies "
          f"between two cards {'ran' if n_cards > 1 else 'not exercised (one card)'}; phase "
          f"wall {time.perf_counter() - tic0:.1f} s", flush=True)
    return launches


PHASE_S: dict = {}
"""Each phase's seconds in this run (``_timed``), printed before the
kernels line."""


def _timed(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its seconds kept in ``PHASE_S[name]`` and
    printed."""
    tic = time.perf_counter()
    out = fn(*args, **kwargs)
    PHASE_S[name] = PHASE_S.get(name, 0.0) + time.perf_counter() - tic
    print(f"[phase] {name}: {PHASE_S[name]:.1f} s", flush=True)
    return out


def main() -> None:
    import faulthandler

    import torch

    faulthandler.enable()  # a fatal signal prints the Python stack of every thread
    tic = time.perf_counter()
    dev, _ = _timed("1 device", phase_device)
    _timed("2 build", phase_build)
    worst1, timing1 = _timed("3 kernels", phase_kernel, dev)
    worst_rz, timing_rz = _timed("3 kernels", check_axis_rz, dev)
    worst_ch, timing_ch = _timed("3 kernels", check_axis_channel, dev)
    _timed("3 kernels", row_level_times, dev)
    _timed("3 kernels", axis_level_times, dev)
    worst2, timing2, _ = _timed("4 kernels slice 2", phase_kernel_slice2, dev)
    worst3, timing3 = _timed("5 kernels variable-Γ", phase_kernel_vargamma, dev)
    _timed("5 kernels variable-Γ", vg_level_times, dev)
    worst4, timing4 = _timed("6 kernels advection", phase_kernel_advect, dev)
    worst5, timing5 = _timed("7 kernel halo-extended", phase_kernel_ext, dev)
    _timed("7 kernel halo-extended", dot_ext_level_times, dev)
    peer_counts, worst6, timing6 = _timed("7b peer", phase_peer, dev)
    worst = {**worst1, **worst2, **worst3, **worst4, "axis_stencil_ext": worst5, **worst6}
    worst["axis_stencil5"] = max(worst1["axis_stencil5"], worst4["axis_stencil5"])
    timing = {"axis_stencil": timing1, **timing2, **timing3, **timing4,
              "axis_stencil_ext": timing5, **timing6}

    from pyapes_tpu_torch.parallel import DomainDecomposition

    launches = {name: 0 for name, _, _, _ in KERNELS}
    fd_counts, fd_stats, fd_x = _timed("8 fastdiag", phase_fastdiag, dev)
    fd_decomp_counts = _timed("8 fastdiag", phase_fastdiag_decomp, dev, fd_stats, fd_x)
    del fd_x
    mg_counts, mg_stats = _timed(
        "9 MG-PCG", phase_mgpcg,
        dev, N_MAIN, BENCH_MG, ("axis_stencil_dot", "jacobi3d", "jacobi3d_x2"),
        f"MG-PCG {N_MAIN}^3 bf16 V(2,2) FMG fuse_rz")
    # under a decomposition the fused alpha-dot, Jacobi, double-sweep and
    # r.z kernels are off: the block kernel applies every fine level
    mg_decomp_counts, mg_decomp_stats = _timed(
        "9 MG-PCG", phase_mgpcg,
        dev, N_MAIN, BENCH_MG, ("axis_stencil_ext",),
        f"MG-PCG {N_MAIN}^3 bf16 V(2,2) FMG {N_DECOMP}", DomainDecomposition(N_DECOMP))
    d_itr = [abs(a - b) for a, b in zip(mg_decomp_stats["itr"], mg_stats["itr"])]
    if max(d_itr) > 2:
        raise RuntimeError(f"chip_smoke: the decomposed MG-PCG took {mg_decomp_stats['itr']} "
                           f"iterations, the undecomposed {mg_stats['itr']} (|d itr| > 2)")
    path_counts = [
        peer_counts, fd_counts, fd_decomp_counts, mg_counts, mg_decomp_counts,
        _timed("9 MG-PCG", phase_mgpcg,
               dev, N_V11, V11_MG, ("axis_stencil_dot", "jacobi3d", "jacobi3d_dot"),
               f"MG-PCG {N_V11}^3 bf16 V(1,1) FMG fuse_rz")[0],
        _timed("9 Darcy", phase_darcy, dev),
        _timed("9 model", phase_model),
        _timed("9 Burgers", phase_burgers, dev),
        _timed("9 advection-diffusion", phase_advdiff, dev),
        _timed("10 cavity", phase_cavity, dev),
    ]
    rz_counts, rz_per_run, rz_row = _timed("11 rz", phase_rz, dev)
    path_counts.append(rz_counts)
    ch_counts, ch_per_step = _timed("12 channel", phase_channel, dev)
    path_counts.append(ch_counts)
    _timed("12 Burgers x only", phase_burgers_xonly, dev)
    per_counts, per_worst_abs = _timed("13 periodic", phase_periodic, dev)
    path_counts.append(per_counts)
    _timed("14 fused", phase_fused, dev)
    path_counts.append(_timed("15 adjoint", phase_adjoint, dev))
    path_counts.append(_timed("16 utilities", phase_utilities, dev))
    path_counts.append(_timed("17 placed", phase_placed, dev))
    for name, err in per_worst_abs.items():
        worst[name] = max(worst[name], err)
    for counts in path_counts:
        for name, c in counts.items():
            launches[name] += c
    never = [name for name, c in launches.items() if c == 0]
    if never:
        raise RuntimeError(f"chip_smoke: the main paths never launched {never}")

    def bound(name):
        if name == "axis_stencil_ext":
            return timing[name][3]
        if name in PEER_KERNELS:
            return timing[name][3:5]
        grids, size, n, ops = BOUND_WORK[name]
        return _bound(grids * size * n**3, ops * n**3)

    print(f"[{len(KERNELS)} kernels] ms/plain_ms/library_ms/bound_ms: the advection kernels at "
          f"{N_PATH}^3 f32 (their paths' grid), the others at {N_MAIN}^3 (512^3 bf16 for the "
          f"Jacobi family, the halo-extended kernel on the {N_DECOMP} blocks of 512^3); "
          "diff_field and diff_jacobi: ms of the plane march (diff_*_march_kernel in "
          "csrc/diff_march.cu, the source named), their launches of both kernels (the per-point "
          "diff_*_kernel in csrc/diff_field.cu below the march's threshold); axis_stencil and "
          "axis_stencil5 likewise (axis_march_kernel in csrc/axis_march.cu, the per-point "
          "kernels in csrc/axis_stencil.cu); library_ms: one CSR "
          "product (torch.mv) of the same linear operator (the variable-Γ apply at its Γ, Div "
          "and Conv at their advectors), none for the fused ones; the last two rows: the 2-D "
          "apply, the kernel of the shape's choice: the row march (axis_row_march_kernel in "
          f"csrc/axis_march2d.cu) on the rz Laplacian at {RZ_CELL} f32 (bench's rz cell), its "
          f"launches the row march's in phase 11 ({rz_row}; axis stencil per run: "
          f"{rz_per_run}), and the per-point kernel (axis_stencil_kernel in "
          f"csrc/axis_stencil.cu, below ROW_MIN_POINTS) on the 2D-2 channel's pressure "
          f"Laplacian at {timing_ch['shape']} f64, its launches those of phase 12 (per step at "
          f"the cell: {ch_per_step}); peer_put / peer_wait (csrc/peer.cu, no Pallas kernel: "
          "the transfers between chips XLA inserts): ms per put + wait pair on one card, two "
          "streams (peer_put at the largest checked case, a 128 x 256 block of 512^3 into its "
          "place in the grid; peer_wait at a reduction's 24-byte partials), plain_ms the plain "
          "copy_, library_ms torch's Tensor.copy_, bound the bytes read and written; launches "
          "those of the per_card_graphs probe on two streams of one card (on four cards also "
          "phase 17 (p)'s)", flush=True)
    print("[phases] seconds " + json.dumps({**{k: round(v, 1) for k, v in PHASE_S.items()},
                                            "total": round(time.perf_counter() - tic, 1)}),
          flush=True)
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": worst[name],
        "ms": timing[name][0],
        "plain_ms": timing[name][1],
        "bound_ms": bound(name)[0],
        "bound_by": bound(name)[1],
        "library_ms": timing[name][2] if len(timing[name]) > 2 else None,
    } for name, _, source, replaces in KERNELS] + [{
        "name": "axis_stencil (2-D, rz)",
        "route": "cuda",
        "source": "pyapes_tpu_torch/csrc/axis_march2d.cu",
        "replaces": "pyapes_tpu/ops/pallas_stencil.py:432",
        "launches": rz_row,
        "max_abs_err": worst_rz,
        "ms": timing_rz["ms"],
        "plain_ms": timing_rz["plain_ms"],
        "bound_ms": timing_rz["bound_ms"],
        "bound_by": timing_rz["bound_by"],
        "library_ms": timing_rz["library_ms"],
    }, {
        "name": "axis_stencil (2-D, channel)",
        "route": "cuda",
        "source": "pyapes_tpu_torch/csrc/axis_stencil.cu",
        "replaces": "pyapes_tpu/ops/pallas_stencil.py:432",
        "launches": ch_counts["axis_stencil"],
        "max_abs_err": worst_ch,
        "ms": timing_ch["ms"],
        "plain_ms": timing_ch["plain_ms"],
        "bound_ms": timing_ch["bound_ms"],
        "bound_by": timing_ch["bound_by"],
        "library_ms": timing_ch["library_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
