#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (msom_tpu_torch).

    python3 chip_smoke.py [phase ...]

Needs one CUDA card, nvcc and the repository checkout; imports nothing of
JAX or msom_tpu. With no argument every phase runs; with phase names
(kernels, steps, paths, fused_mm, mg, node, periodic, stochastic, driver,
driver_node, mspg, coupling, varro, newqg, sqg, rows, shard, vshard,
pgshard, api, f32val, refine, dryrun)
the build and those phases only (for work on one part: the kernels' record
then lists what ran). Phases, in order; any failure exits non-zero:

1. build every kernel from msom_tpu_torch/csrc (one nvcc per source, all
   started together);
2. hold each kernel against its plain PyTorch version on the card, in f32
   and f64: the fused RHS (K1) uncoupled, with each coupling option alone
   (pg; pg + flsrv; topo; qforc; energy_conserv; sbc = 1) and with all of
   them, and the fused tracer tendency (K2, a row-marching strip kernel)
   with 1, 2 and 3 tracers (3: the loop over a run-time count), with and
   without a relaxation field, each at N = 256 with nl = 1, 3, 4, at
   N = 100, 130 and 257 (partial strips; at 257 the last strip is one row
   and one column, copied one element at a time), at N = 48 (one strip
   holds all four walls) and at 2048^2 x 4; the fused spectral solve (K7)
   at N = 128, 512, 1024 with nl = 1, 4, in f32 also against the f64 chain
   beside the FP32 cuBLAS chain (K7's 3-pass TF32 error within 4 times the
   FP32 chain's);
3. hold the whole step on the card against the port on the CPU, 128^2 x 3
   in f64 over 20 steps from one numpy IC: the Verron double gyre, and the
   coupled configuration (psipg, topo, qforc, 2 tracers);
4. run the uncoupled main path: bench.py's 2048^2 x 4 f32 spectral
   configuration from a numpy-seeded noise IC, 20 warm-up steps, 40 steps
   timed with CUDA events, counting K1's launches; time K1 alone, its plain
   version and its roofline bound on the final state; profile four steps;
5. run the coupled path: bench.py's coupled configuration at 2048^2 x 4 f32
   (a large-scale streamfunction, bottom topography, two passive tracers),
   the same protocol, counting K1's and K2's launches; time both kernels
   alone against their plain versions and bounds; profile four steps;
6. run the fused-solve path: the uncoupled step at 1024^2 x 4 f32 with
   fused_mm=True (K7), beside the same step with transform="matmul" (the
   cuBLAS chain) and with the default folded DST: 10 warm-up steps each,
   then 20 timed steps of each in turns, three times, the least reported;
   time K7 alone against its plain version (that cuBLAS chain, which is
   also its library yardstick) and its two bounds (the FP32 pipe's, and the
   TF32 tensor cores' for its three passes, which it is held to), and
   fail if K7 is not faster than that chain; the host time of a solve of
   each; profile four steps of the K7 variant; then K7 on the periodic
   Fourier basis (fourier_matrix, the naturally ordered inv_den) against
   the cuBLAS chain at N = 128 and 1024 with nl = 4, f64 and f32, in f32
   within K7_F64_RATIO of the FP32 chain's error against f64;
7. the multigrid (phase name mg): hold the red-black line sweep (K3, four
   sweeps in a row, so that a fault on a tile's rim can spread) and the
   fused residual (K4) against their plain versions in f32 and f64, with
   Dirichlet and Neumann signs (and mixed signs at n = 100), with stretching
   profiles and in the modal shape (no stretching, a Helmholtz profile), at
   n = 256 (nl = 1, 3, 4), n = 100, n = 2, 4, 8 and 2048^2 x 4; a whole
   solve_layered on the card against the CPU in f64 (128^2 x 3, tol 1e-8:
   same cycles, same nrelax), layered and modal; the mg step and the
   mode_pv_invert step on the card against the CPU step (128^2 x 3, f64,
   20 steps, the same V-cycles every step); then the mg path at full width:
   bench.py's mg row, 2048^2 x 4 f32, solver="mg", tol = 1e-3, mg_extrap,
   from the numpy-seeded noise IC, bench.py's 200 spin-up steps, then 40
   steps timed with CUDA events, counting K1's, K3's and K4's launches and
   the V-cycles of every solve; K3 and K4 alone on the final state against
   their plain versions and bounds, K3 by level (launches and device time
   a step on the timed path, each level's time against its bound); a
   four-step profile.
8. the qg-node family (phase name node): hold the nodal tendency (K5)
   against its plain version in f32 and f64 with every option set (bench's
   own no-slip configuration, free slip, no slip with nu4, pg, topo, qf3,
   flag_ms, an island mask, bench's coastline mask, all together) at
   N = 256 with nl = 3, 4, N = 100 (partial strips), N = 24 (one strip
   holds all four walls), N = 130 (last strips of three columns and
   three rows), 2048^2 x 4, and the barotropic form (nl = 1 with gp_low)
   at N = 256, 100 and 2048; the masked vertex relaxation (K6: five
   sweeps in one launch, beside five one-sweep launches, bitwise, and the
   plain version) on a coastline grid with an
   x-varying S2 at nl = 1-4, n = 3, 5, 9, 17, 65, 257, 2049; a whole masked
   vpoisson on the card against the CPU (128^2 x 3 f64, tol 1e-8: same
   cycles, one K6 launch a level and cycle); the node step on the card
   against the CPU step (128^2 x 3 f64,
   20 steps, spectral and solver="vmg" with the coastline: the same
   V-cycles every step); then bench.py's two node rows (measure_node,
   bench.py:166-240) at 2048^2 x 4 f32 from a numpy-seeded noise IC: node
   (spectral + K5, 40 spin-up steps) and node_masked (solver="vmg", the
   coastline, K6 + K5, 100 spin-up steps), 40 steps each timed with CUDA
   events, counting K5's and K6's launches and the V-cycles of every solve;
   K5 and K6 (a relaxation, and five one-sweep launches) alone on the final
   state against their plain versions and bounds, K6 by level; a four-step
   profile of each; on the node row bench.py's filter timing (five chained
   wavelet_filter calls, best of two).
9. the doubly periodic msqg (phase name periodic): K1's periodic kernel
   with each option set (uncoupled, pg, pg + flsrv, topo, qforc,
   energy_conserv, all together; pp's ghosts from a uniform flow) and K2's
   periodic mode (1-3 tracers, relaxation on and off) against their plain
   versions in f64 and f32 at the sizes of phase 2; the periodic step on the
   card against the CPU (128^2 x 3 f64, 20 steps: uncoupled, coupled with
   upg/vpg, _LS_RV, topography, forcing and two tracers, and solver="mg"
   with the same V-cycles); then the periodic_coupled path at 2048^2 x 4
   f32 (bench's physics with sbc = -1, flsrv = 1, a uniform flow, bench's
   topography and two tracers, the rfft2 inversion): 20 warm-up and 40
   timed steps counting K1's and K2's launches, both kernels on the final
   state against their plain versions and bounds, a four-step profile and
   the device time of the rfft2/irfft2 pair (cuFFT) a step.
10. the stochastic msqg (phase name stochastic): K1's stochastic mode,
   walled and periodic, uncoupled and with every coupling option, against
   its plain version in f64 and f32 at the sizes of phase 2; the step at
   amp_stoch = 0 on the card against the CPU (128^2 x 3 f64, 20 steps);
   then bench.py's stochastic row at 1024^2 x 4 f32 (walled, the folded
   DST, tr_stoch = 50, amp_stoch = 1e-6, noise from a seeded generator on
   the card): 60 spin-up and 20 timed steps counting K1's launches, K1 on
   the final state against its plain version and bound, a four-step
   profile.
11. the msqg driver and its events (phase name driver): driver.run_qg with
   the wavelet filter (dtflt), the energy budget (ediag = 0) and an
   OutputWriter on the card against the CPU, 128^2 x 3 f64 to tend = 0.75
   (about 30 steps, two output and two filter events): walled, with
   bench's coupling (psipg, topography, two tracers) and periodic; the
   final q, psi, qof, nbar, the six energy fields and the KE log within
   STEP_LIMIT, every .bas file within float32 rounding. Then bench's
   coupled configuration at 2048^2 x 4 f32 through run_qg (dtflt = 0.25,
   dtout = 0.5, tend = 0.9: about 40 steps, two output and three filter
   events, the files into a temporary directory removed afterwards),
   counting K1's and K2's launches: the driver's ms/step between events
   beside the bare make_step loop's on the same state, energy_tend's ms a
   step, the filter event's ms, the output event's seconds, the idle
   share of the driver loop (a profile of four steps), K1 and K2 on the
   final state against their plain versions and bounds.
12. the qg-node driver and its events (phase name driver_node):
   driver_node.run_node with a NodeOutput (vars.nc, diag_1d.dat), the
   masked wavelet filter and the node events on the card against the CPU,
   bench's node physics at 128^2 x 3 f64 (33 steps, three records, four
   diag rows, two filter events): walled, coastline-masked (vmg), periodic
   (bc_fac = -1) and stochastic at amp_stoch = 0; the final state, the diag
   rows and the KE log within STEP_LIMIT, every vars.nc record within
   float32 rounding. The card's noise draw at 4 x 2049^2 in distribution.
   Then bench's masked node configuration (the coastline, vmg) at
   2048^2 x 4 f32 through run_node (about 53 steps, three 134 MB records,
   eight diag rows, four filter events, into a temporary directory removed
   afterwards), counting K5's and K6's launches: the driver's ms/step
   between events beside the bare make_step loop's, the filter event's ms
   and profile, each output event's seconds by record, the driver loop's
   idle share and K5's and K6's device ms a step (a profile of four
   steps), K5 and K6 on the final state against their plain versions and
   bounds.
13. mspg (phase name mspg; it has no kernel): build_constants (the
   barotropic solve) and 20 steps on the card against the CPU, f64,
   32^2 x 8 from a numpy stratified IC: plain, with Gent-McWilliams
   (k_gm > 0) and with a numpy-seeded b_forc, psibt and the state within
   STEP_LIMIT with the same bt-solve cycles; driver.run_pg with a
   PGOutputWriter on both (four output events), the state, the means and
   every .bas within float32 rounding. Then bench.py's mspg row (64^2 x 30
   f32): the bt solve's seconds and cycles, 120 spin-up and 60 timed
   steps, a ten-step profile (launches a step, idle share), the host's
   queue time a step, and run_pg with five output events, each event's
   seconds.
14. the PG <-> QG coupling loop (phase name coupling): the five stages of
   tests/test_coupling_workflow.py (PG 32^2 x 8 -> QG 64^2 x 3, f64) on
   the card against the CPU stage by stage (the PG state; psipg, frpg,
   rdpg, dh, Rom; the QG state, pf and the V-cycles; b_forc; the two
   continuations) within STEP_LIMIT, with the workflow's checks; then
   README.md's workflow at full width: PG 64^2 x 30 f32 spun up 150 steps,
   msqg at 2048^2 x 3 f32 (solver="mg", the 2-D frpg) for 20 steps with a
   filter event every 5, the feedback regridded to 64^2 and 30 PG steps
   with and without it: each stage's seconds, the QG stage's ms/step and
   V-cycles, and K1, K3 and K4 at 0 launches in the QG stage (a 2-D frpg
   is no mode of theirs, in either package).
15. varRo and the y-profile direct solve (phase name varro): the
   block-Thomas y-sweeps (KV) against their plain version in f64 and f32
   at N = 64, 100 (a partial block), 256 and 2048 with nl = 2, 3, 4; one
   vary solve on the card against the CPU (128^2 x 3 f64); the step on
   the card against the CPU, 128^2 x 3 f64, 20 steps: varRo spectral (KV
   twice a step), varRo mg (the same V-cycles, K3/K4) and a frpg varying
   in y only with spectral; then tools/vary_bench.py's configuration at
   2048^2 x 4 f32 with solver="spectral" (the fold, KV, K1) and "mg" (K1,
   K3, K4): 20 warm-up steps, five rounds of 20 steps timed with CUDA
   events (median and range), the kernels' launches, device busy and
   idle share (a four-step profile); on the spectral path KV and K1 alone
   on the final state against their plain versions and bounds, and the
   f32 solve against the f64 solve of the same q.
16. newqg (phase name newqg): the step on the card against the CPU,
   128^2 f64, 20 steps, nl = 1 and nl = 2 with gp_low, each with mg and
   spectral, walled and periodic (the same V-cycles; K3/K4 on the walled
   mg); run_newqg on the card against the CPU with its vars.nc records;
   then the newqg reference deck (tests/test_newqg_io.py:24-37) at
   2048^2 x 1 f32, nu and DT scaled by 64/N: mg (K3, K4) and spectral,
   the same protocol, K3 and K4 alone on the mg path's final state.
17. the SQG variant (phase name sqg): the step on the card against the
   CPU, 128^2 x 3 f64, 20 steps (the same V-cycles; K6 on the card, K5
   never: SQG's rhs_pv is torch ops); run_sqg on the card against the
   CPU with output and a restart; then bench's measure_node physics at
   2048^2 x 4 f32 (N2 at the surface and three interfaces, the default
   mask, numpy psi and bs): 40 spin-up steps, the same protocol, K6's
   launches and V-cycles a solve, bs2, K6 alone on the final state.

18. the rows-sharded msqg step (phase name rows): K1's rows mode (every
   option set, walled, slip, periodic, stochastic) and K2's (1-3 tracers,
   walled and periodic) on 4 virtual shards of one field, f64 and f32, at
   256^2 with nl = 1, 3, 4, 160^2 x 3 (shards of 40 rows: a 32-row strip
   and an 8-row one) and 2048^2 x 4: put together, bit for bit the
   whole-domain kernel (within 4 ulp where the rows build contracts a
   multiply-add differently), and within LIMITS of the plain rows
   version; then
   a process group of world size 1 under NCCL (a file:// store): the rows
   step on the card against the unsharded CPU step (128^2 x 3 f64,
   coupled, two tracers, 20 steps), run_qg(sharded="rows") against
   run_qg (the filter, the energy budget, the files), and bench.py's
   sharded_rows row at 2048^2 x 4 f32, uncoupled and coupled, beside the
   unsharded step in turns (five rounds of 20 steps each, the medians'
   ratio, device busy and idle share of each, the rows launches, the two
   states after the same steps); K1's and K2's rows launch on a 512-row
   shard timed against its bound, beside the whole-domain launch.
18b. the sharded multigrid and the general-mesh step (phase name shard),
   world size 1 under NCCL: run_qg(sharded="auto") at 128^2 x 3 f64 on
   spectral, mg, mode_pv_invert and varRo returns the mode the JAX
   package's run_qg records and the unsharded run's state; then at
   2048^2 x 4 f32 each sharded step beside its unsharded step in turns
   (SHARD_WARM warm-up steps, SHARD_ROUNDS rounds of SHARD_STEPS steps
   of each: medians and ranges, device busy and idle share, every
   kernel's launches, the first solve's V-cycles a step): the rows step
   with solver="mg" (bench's mg row), uncoupled and coupled (K1 and K2
   rows twice a step, no K3 or K4: the sharded multigrid is torch ops),
   and the general-mesh step ("gspmd") on the (1, 1) mesh, spectral (the
   matmul basis), mg, mode_pv_invert and varRo (no K1-K4; KV twice a
   step); from each unsharded run's final state one f64 step of each
   within STEP_LIMIT; K1 and K2 rows (coupled rows mg) and KV (gspmd
   varRo) timed on their final states against their bounds. The gspmd
   spectral and mg steps also run with the overlapped forms' rings held
   in flight until their wait, as on a mesh of several ranks (the
   interior/rim split on tiles of halo.SPLIT_MIN_BYTES or more: here the
   finest level), in turns with the shipped step: the final states bit
   for bit equal, each form's median and range (on one card nothing is
   in flight, so the split measures what the overlapped form costs, not
   what it gains).
   Multi-rank runs are not measured here (one card).
18c. the vertex-sharded qg-node run (phase name vshard), world size 1
   under NCCL: run_node(sharded=True) on the card against the unsharded
   run_node on the CPU (128^2 x 3 f64, the coastline, solver="vmg", the
   filter event, the files and diag rows); then bench's masked node
   configuration at 2048^2 x 4 f32, the sharded step (torch ops: no K5,
   no K6) beside the unsharded step (K5, K6) in turns as in 18b, and one
   f64 step of each from the same state within STEP_LIMIT.
18d. the sharded mspg run (phase name pgshard), world size 1 under NCCL:
   run_pg(sharded=True) on the card against the unsharded run_pg on the
   CPU (32^2 x 4 f64, four output events, the files); then bench's mspg
   row (64^2 x 30 f32) sharded beside unsharded in turns.
19. the tendency API (phase name api): api.qg_tendency on the card through
   K1 (with tracers K2) against the same call through their plain
   versions, at bench's uncoupled and coupled 2048^2 x 4 f32, direction
   +1 and -1 (the irreversible half large enough to show a missed flip),
   and against the CPU at 128^2 x 3 f64; bfn_integrate at bench's
   uncoupled 2048^2 x 4 f32, forward and then backward from the
   forward's end (dt < 0), nudged toward the bare step's final q: five
   rounds of one call of 20 AB3 steps each (median and range), K1's
   launches a step (1), device busy and idle share, beside the bare
   make_step's rounds in the same phase; K1 alone on the backward's
   final state (the flipped config); pg_steady_state at 8^2 x 3 f64 on
   the card and the CPU (seconds, Newton iterations, final max|F|); the
   native AsyncBasWriter on the forward's 2048^2 x 4 psi beside
   io/bas.write_bas, read back equal.
20. the f32 validation (phase name f32val): the Verron 256^2 x 3 double gyre
   in f32 on the card from the committed f64 truth's q at step 100
   (tools/f32val_float64_cpu.npz) to step 3000: the KE mean of the last
   1000 steps within 1% of the truth's and the final surface KE
   spectrum's ratio to the truth's, median within 0.97-1.03 (GOLDEN.md's
   bar); q's drift at the truth's snapshots.
21. the bf16 + refinement spectral solve (phase name refine; no kernel of
   its own: cuBLAS GEMMs with bf16 operands and float32 outputs, torch
   ops): the float64 refine solve on the card against the CPU (256^2 x 4,
   walled and periodic) and, at world size 1 under NCCL, the sharded
   refine solve against the unsharded one, within REFINE_F64_LIMIT; on
   tools/refine_error.py's problem at N = 256-2048 with nl = 4 the bf16
   pass against its plain emulation on a normal q_m (refine_pass_ok), and
   the solution error and residual of the f32 fold ("auto"), the f32
   basis matmul, one bf16 pass and refine against the float64 solve
   (recorded, not gated);
   each mode's solve time at 2048^2 x 4; then bench's uncoupled
   configuration at 2048^2 x 4 f32 with the refine constants in turns
   with the fold step (five rounds of 20 steps each, K1 twice a step,
   busy and idle share, finite states).
22. the multi-device dry run (phase name dryrun; msom_tpu_torch.entry, the
   counterpart of the JAX package's __graft_entry__.py): entry()'s
   256^2 x 3 f32 forward step on the card against the same state and
   step on the CPU (q, psi and KE within LIMITS[4]); then, at world size 1
   under NCCL, dryrun_multichip's seven modes (gspmd_mg, gspmd_spectral,
   shard_map_spectral, shard_map_mg, rows_kernel, vshard_node,
   gspmd_mspg) in float32 and in float64, each against the unsharded
   step from the same state on the card (float64 within STEP_LIMIT), the
   launches of every kernel over each dry run (K1 rows and K2 rows in
   rows_kernel), the seconds of each.

TF32 is switched off for matmuls and convolutions before anything runs:
1-pass reduced-precision transforms give O(1) solution error at N = 2048.
The last lines are the kernels' JSON record, the card's name and power
limit, and {"ok": true, "device": {...}}.
"""

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

# published H100 SXM peaks (NVIDIA data sheet), for the roofline bound
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {4: 67e12, 8: 34e12}    # FP32 / FP64 outside tensor cores
PEAK_TF32_OPS_PER_S = 495e12              # TF32 on the tensor cores, dense
LIMITS = {4: 1e-4, 8: 1e-11}             # K1, K2 vs plain, of max|out|
K7_LIMITS = {4: 1e-5, 8: 1e-12}          # K7 vs plain, of max|psi_m|
K7_F64_RATIO = 4.0    # K7's f32 error against f64 over the FP32 chain's
STEP_LIMIT = 1e-10                        # CUDA step vs CPU step, f64
# K3 (after up to 9 sweeps) and K4 vs plain, of max|out|: the kernels
# contract a*b+c into one rounding and multiply by 1/delta^2 where the plain
# version divides, a few ulp a cell
MG_LIMITS = {4: 1e-5, 8: 1e-12}
# the relaxations K3 is checked at: 1, 2, KMAX, KMAX + 1 sweeps and 9; K3's
# record times a relaxation of MG_RELAX = KMAX sweeps (one strip launch)
MG_NRELAX = (1, 2, 4, 5, 9)
MG_RELAX = 4
MG_SOLVE_LIMIT = 1e-10                    # CUDA solve vs CPU solve, f64
MG_MAX_CYCLES = 20      # a solve that needs more at tol 1e-3 is spinning
MG_MAX_K3_LAUNCHES = 50  # K3 launches a step on the mg path, at most
PHASES = ("kernels", "steps", "paths", "fused_mm", "mg", "node", "periodic",
          "stochastic", "driver", "driver_node", "mspg", "coupling", "varro",
          "newqg", "sqg", "rows", "shard", "vshard", "pgshard", "api",
          "f32val", "refine", "dryrun")
K1_OPTIONS = ("pg", "pg_flsrv", "topo", "qforc", "energy_conserv", "slip",
              "all")
# the periodic kernel's option sets (no slip: the domain has no wall), and
# the stochastic variant's, walled and periodic
K1_PERIODIC_OPTIONS = ("pg", "pg_flsrv", "topo", "qforc", "energy_conserv",
                       "all")
K1_STOCHASTIC_OPTIONS = ("stochastic", "stochastic_all")
TRACERS = dict(nptr=2, Pe=(1e3, 2e3), ptr_r=(100.0, 0.0))
# the kernels' check sizes: nl = 1, 3, 4; partial strips (100, 130, and at
# 257 one row and one column, copied one element at a time); one strip
# holding the whole width (48); and the paths' width
KERNEL_SIZES = [(256, 1), (256, 3), (256, 4), (100, 3), (130, 4), (257, 4),
                (48, 3), (2048, 4)]
# a uniform large-scale flow (tests/test_pallas_rhs.py:299-301), the fourth
# layer at rest: pp = vpg x - upg y, which does not wrap
PG_FLOW = dict(upg=(0.02, 0.01, 0.0, 0.0), vpg=(0.01, -0.005, 0.0, 0.0))
STOCH = dict(stochastic=True, tr_stoch=50.0, amp_stoch=1e-6)


def verron(QGConfig, N, **kw):
    """The Verron (1992) double gyre at 3 layers (tests/test_lockstep.py)."""
    base = dict(N=N, nl=3, L0=80, Rom=0.025, Ekb=0.002, tau0=1e-4, Re4=1563,
                beta=0.5, Fr=(0.0023669, 0.0076173), dh=(0.06, 0.14, 0.8),
                DT=5e-2, tend=500., dtout=1., CFL=0.6, dtype="float64",
                solver="spectral")
    base.update(kw)
    return QGConfig(**base).validate()


def bench_config(QGConfig, N, nl, dtype, solver="spectral", **kw):
    """bench.py's 4-layer Verron variant scaled to N (bench.py:63-68)."""
    return QGConfig(N=N, nl=nl, L0=80, Rom=0.025, Ekb=0.002, tau0=1e-4,
                    Re4=1563 * (N / 256) ** 3, beta=0.5,
                    Fr=tuple([0.003] * (nl - 1)), dh=tuple([1.0 / nl] * nl),
                    DT=5e-2, tend=1e9, dtout=1e9, CFL=0.6, dtype=dtype,
                    solver=solver, **kw).validate()


def coupled_fields(cfg, noise=0.0, seed=0):
    """bench.py's coupling inputs (bench.py:69-74): a gyre-shaped large-scale
    streamfunction and a sine topography; `noise` adds a rough part (and a
    3-D forcing) so that a kernel check exercises every stencil point."""
    N, nl = cfg.N, cfg.nl
    y = (np.arange(N) + 0.5) * cfg.delta
    gyre = np.sin(np.pi * y / cfg.L0)
    fields = dict(
        psipg=0.01 * gyre[None, :, None] * np.ones((nl, N, N)),
        topo=0.05 * np.outer(gyre, np.sin(2 * np.pi * y / cfg.L0)))
    if noise:
        rng = np.random.default_rng(seed)
        fields["psipg"] = fields["psipg"] \
            + noise * rng.uniform(-1, 1, (nl, N, N))
        fields["topo"] = fields["topo"] \
            + 10 * noise * rng.uniform(-1, 1, (N, N))
        # of the size of dq itself, so that a fault in it shows in f32 too
        fields["qforc"] = 1e3 * noise * rng.uniform(-1, 1, (nl, N, N))
    return fields


def k1_variant(cfg, const, name):
    """(cfg, const) of one K1 option set, cut out of constants built with
    every coupling field and flsrv = 1. A periodic cfg (sbc = -1) stays
    periodic; "slip" needs walls."""
    no_pg = dict(pp_pad=None, pp=None, zetap_pad=None, umax_pp=None,
                 pp_t=None, zetap_t=None)
    no_topo = dict(topo_pad=None, topo=None, iro=None)
    off = {"uncoupled": {**no_pg, **no_topo, "qforc": None},
           "pg": {**no_topo, "zetap_pad": None, "zetap_t": None,
                  "qforc": None},
           "pg_flsrv": {**no_topo, "qforc": None},
           "topo": {**no_pg, "qforc": None},
           "qforc": {**no_pg, **no_topo},
           "energy_conserv": {**no_pg, **no_topo, "qforc": None},
           "slip": {**no_pg, **no_topo, "qforc": None},
           "stochastic": {**no_pg, **no_topo, "qforc": None},
           "stochastic_all": {},
           "all": {}}[name]
    walled_sbc = 1.0 if name in ("slip", "all", "stochastic_all") else 0.0
    stoch = name.startswith("stochastic")
    kw = dict(flsrv=int(name in ("pg_flsrv", "all", "stochastic_all")),
              energy_conserv=name in ("energy_conserv", "all"),
              stochastic=stoch, tr_stoch=50.0 if stoch else cfg.tr_stoch,
              sbc=cfg.sbc if cfg.sbc == -1 else walled_sbc)
    return (dataclasses.replace(cfg, **kw).validate(),
            dataclasses.replace(const, **off))


def cuda_ms(fn, n):
    """Mean milliseconds of fn() over n calls, timed with CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def host_ms(fn, n=50):
    """Mean host milliseconds of fn() over n calls: the time to queue its
    launches, the device's work not waited for."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    ms = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    return ms


def kernel_times(kernel, plain, n_kernel=50, n_plain=10):
    """(kernel ms, plain ms), in turns kernel, plain, kernel after a
    warm-up; the kernel's time is the lesser of its two."""
    for _ in range(3):
        kernel()
        plain()
    k1 = cuda_ms(kernel, n_kernel)
    p = cuda_ms(plain, n_plain)
    k2 = cuda_ms(kernel, n_kernel)
    return min(k1, k2), p


def roofline(nbytes, nops, itemsize):
    """(bound ms, what bounds it, bytes ms, operations ms)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_OPS_PER_S[itemsize] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", t_bytes, t_ops)


def device_ms(fn, n=20):
    """Mean device milliseconds of fn() over n calls: the time of the
    kernels the profiler records, without the host's gaps between them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(_device_us(e) for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / n


def _device_us(event):
    us = getattr(event, "self_device_time_total", None)
    return event.self_cuda_time_total if us is None else us


def kernel_profile(label, step_fn, steps, ms_step):
    """Device time by kernel over a profiled window of `steps` steps, and
    the share of the step the device is busy (against the unprofiled
    ms/step); returns the rows (ms a step, launches a step, name)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step_fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = _device_us(e)
        if us > 0:
            rows.append((us / 1e3 / steps, e.count / steps, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if not rows or busy <= 0:
        raise RuntimeError("the profiler recorded no device time")
    print(f"profile {label}: device busy {busy:.4f} ms/step of "
          f"{ms_step:.4f} (idle share {1 - busy / ms_step:.4f}), "
          f"{len(rows)} kernels, {sum(r[1] for r in rows):.1f} launches/step")
    for ms, n, name in rows[:14]:
        print(f"  {ms:9.4f} ms/step {n:6.1f} launches/step  {name[:90]}")
    return rows


def timed_steps(step, state, const, steps):
    """Time `steps` steps with CUDA events: (state, last diag, ms/step)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        state, diag = step(state, const, 1e18)
    end.record()
    torch.cuda.synchronize()
    return state, diag, start.elapsed_time(end) / steps


def state_ok(state, diag, shape):
    """Finite fields of the expected shape, a finite KE and dt > 0."""
    import torch
    fields = [state.q, state.psi] + ([state.tracers]
                                     if state.tracers is not None else [])
    return (all(bool(torch.isfinite(f).all()) for f in fields)
            and np.isfinite(diag.ke.item()) and diag.dt.item() > 0
            and tuple(state.q.shape) == shape)


def mg_level(nl, n, dtype, modal, rng):
    """(level, idh0, idh1): one multigrid level on the card with random
    y-profile coefficients, layered (stretching profiles and metrics) or in
    the modal shape (no stretching, a Helmholtz profile per mode), as
    tests/test_pallas_mg.py makes them."""
    import torch
    from msom_tpu_torch.solvers import mg
    tdt = getattr(torch, dtype)
    s = lam = None
    idh0 = idh1 = np.zeros(nl)
    if modal:
        lam = torch.as_tensor(-rng.uniform(0.0, 5.0, (nl, n, 1)),
                              dtype=tdt).cuda()
    elif nl > 1:
        s = torch.as_tensor(rng.uniform(0.5, 2.0, (nl - 1, n, 1)),
                            dtype=tdt).cuda()
        idh0 = np.r_[0.0, rng.uniform(1, 3, nl - 1)]
        idh1 = np.r_[rng.uniform(1, 3, nl - 1), 0.0]
    lvl = mg._build_level(nl, n, 80.0 / n, s, lam, idh0, idh1, tdt,
                          torch.device("cuda"))
    return lvl, idh0, idh1


def mg_kernel_checks():
    """K3 and K4 against their plain versions on the card; returns (ok,
    {kernel: max abs error at 2048^2 x 4 f32, layered, Dirichlet}). K3:
    relaxations of MG_NRELAX sweeps (one launch each at most KMAX sweeps on
    a strip level, one launch in all on a whole level), each also BIT FOR
    BIT the chain of one-sweep launches; periodic_x; K4: one launch a
    residual, its maximum included, and a NaN carried."""
    import torch
    from msom_tpu_torch.solvers import fused_mg
    sizes = [(256, 1), (256, 3), (256, 4), (100, 3), (2, 3), (4, 4), (8, 1),
             (16, 2), (32, 4), (64, 4), (128, 4), (256, 8), (2048, 4)]
    ok, main_err = True, {}
    for dtype in ("float64", "float32"):
        isz = 8 if dtype == "float64" else 4
        lim = MG_LIMITS[isz]
        tdt = getattr(torch, dtype)
        for n, nl in sizes:
            most = fused_mg.sweeps_per_launch(n, nl, tdt)
            for modal in (False, True):
                rng = np.random.default_rng(n + nl)
                lvl, idh0, idh1 = mg_level(nl, n, dtype, modal, rng)
                da = torch.as_tensor(rng.standard_normal((nl, n, n)),
                                     dtype=tdt).cuda()
                res = torch.as_tensor(rng.standard_normal((nl, n, n)),
                                      dtype=tdt).cuda()
                d2 = lvl.delta * lvl.delta
                signs = [(-1.0, -1.0), (1.0, 1.0)]
                if n == 100:
                    signs.append((1.0, -1.0))
                for sx, sy in signs:
                    kw = dict(d2=d2, sign_x=sx, sign_y=sy)
                    worst, bitwise, counts = 0.0, True, True
                    for nrelax in MG_NRELAX:
                        before = (fused_mg.sweep_launches, fused_mg.sweeps)
                        k = fused_mg.relax(da, res, lvl.sw, nrelax=nrelax,
                                           **kw)
                        counted = (fused_mg.sweep_launches - before[0],
                                   fused_mg.sweeps - before[1])
                        p = fused_mg.relax_reference(da, res, lvl.sw,
                                                     nrelax=nrelax, **kw)
                        one = da
                        for _ in range(nrelax):
                            one = fused_mg.rb_line_sweep(one, res, lvl.sw,
                                                         **kw)
                        torch.cuda.synchronize()
                        err = (k - p).abs().max().item()
                        worst = max(worst, err / p.abs().max().item())
                        bitwise &= torch.equal(k, one)
                        counts &= counted == (-(-nrelax // most), nrelax)
                        if (dtype == "float32" and (n, nl) == (2048, 4)
                                and not modal and sx < 0
                                and nrelax == MG_RELAX):
                            main_err["mg_sweep"] = err
                        del k, p, one
                    kw = dict(delta=lvl.delta, idh0=idh0, idh1=idh1,
                              sign_x=sx, sign_y=sy)
                    before = fused_mg.residual_launches
                    r_k, m_k = fused_mg.residual_norm(da, res, lvl.rp, **kw)
                    launched = fused_mg.residual_launches - before
                    r_p, m_p = fused_mg.residual_norm_reference(
                        da, res, lvl.rp, **kw)
                    torch.cuda.synchronize()
                    err_r = (r_k - r_p).abs().max().item()
                    rel_r = err_r / r_p.abs().max().item()
                    rel_m = abs(m_k.item() - m_p.item()) / m_p.item()
                    good = (worst <= lim and bitwise and counts
                            and rel_r <= lim and rel_m <= lim
                            and launched == 1 and m_k.ndim == 0
                            and torch.equal(m_k, r_k.abs().max()))
                    ok &= good
                    print(f"K3/K4 check {dtype} n={n} nl={nl} "
                          f"{'modal' if modal else 'layered'} signs "
                          f"({sx:+g}, {sy:+g}): relaxations of "
                          f"{'/'.join(map(str, MG_NRELAX))} sweeps "
                          f"({most if most <= 64 else 'all'} a launch) "
                          f"max|d da|/max|da| = {worst:.3e}, bitwise the "
                          f"one-sweep launches {bitwise}, launches as "
                          f"counted {counts}; K4 one launch {launched == 1}"
                          f", max|d res|/max|res| = {rel_r:.3e}, d max/max "
                          f"= {rel_m:.3e} (limit {lim:g}) "
                          f"{'ok' if good else 'FAIL'}")
                    if (dtype == "float32" and (n, nl) == (2048, 4)
                            and not modal and sx < 0):
                        main_err["mg_residual"] = err_r
                    del r_k, r_p
                del lvl, da, res
                torch.cuda.empty_cache()
        # periodic_x: x wraps, the ghost rows are rows 7 and n - 8
        for n, nl in ((64, 3), (256, 2)):
            rng = np.random.default_rng(n)
            lvl, idh0, idh1 = mg_level(nl, n, dtype, False, rng)
            da = torch.as_tensor(rng.standard_normal((nl, n, n)),
                                 dtype=tdt).cuda()
            res = torch.as_tensor(rng.standard_normal((nl, n, n)),
                                  dtype=tdt).cuda()
            kw = dict(d2=lvl.delta ** 2, sign_x=-1.0, sign_y=-1.0,
                      periodic_x=True)
            k = fused_mg.relax(da, res, lvl.sw, nrelax=3, **kw)
            p = fused_mg.relax_reference(da, res, lvl.sw, nrelax=3, **kw)
            rkw = dict(delta=lvl.delta, idh0=idh0, idh1=idh1, sign_x=-1.0,
                       sign_y=-1.0, periodic_x=True)
            r_k, m_k = fused_mg.residual_norm(da, res, lvl.rp, **rkw)
            r_p, m_p = fused_mg.residual_norm_reference(da, res, lvl.rp,
                                                        **rkw)
            rel_s = _rel(k, p)
            rel_r = _rel(r_k, r_p)
            rel_m = abs(m_k.item() - m_p.item()) / m_p.item()
            good = max(rel_s, rel_r, rel_m) <= lim
            ok &= good
            print(f"K3/K4 check periodic_x {dtype} n={n} nl={nl}: three "
                  f"sweeps max|d da|/max|da| = {rel_s:.3e}, max|d res|/"
                  f"max|res| = {rel_r:.3e}, d max/max = {rel_m:.3e} (limit "
                  f"{lim:g}) {'ok' if good else 'FAIL'}")
    # a NaN in the field must reach the norm, as it does in the plain max
    lvl, idh0, idh1 = mg_level(3, 100, "float32", False,
                               np.random.default_rng(1))
    a = torch.zeros((3, 100, 100), device="cuda")
    a[1, 50, 99] = float("nan")
    _, m = fused_mg.residual_norm(a, a, lvl.rp, delta=lvl.delta, idh0=idh0,
                                  idh1=idh1, sign_x=-1.0, sign_y=-1.0)
    good = bool(torch.isnan(m))
    print(f"K4 check: a NaN cell gives a NaN norm: {'ok' if good else 'FAIL'}")
    return ok and good, main_err


def mg_solve_check():
    """A whole solve_layered on the card against the CPU in f64, layered
    and modal: the same cycles, the same nrelax, the same solution."""
    import torch
    from msom_tpu_torch.solvers import fused_mg, mg
    nl, n = 3, 128
    ok = True
    for modal in (False, True):
        rng = np.random.default_rng(5)
        kw = dict(L0=80.0, tolerance=1e-8)
        coef = {}
        if modal:
            coef["lam"] = torch.tensor(-rng.uniform(0.0, 5.0, (nl, n, 1)))
        else:
            coef["s"] = torch.tensor(rng.uniform(0.5, 2.0, (nl - 1, n, 1)))
            kw["idh0"] = np.r_[0.0, rng.uniform(1, 3, nl - 1)]
            kw["idh1"] = np.r_[rng.uniform(1, 3, nl - 1), 0.0]
        b = torch.tensor(rng.standard_normal((nl, n, n)))
        out = {}
        for where in ("cpu", "cuda"):
            before = fused_mg.sweep_launches, fused_mg.residual_launches
            a, st = mg.solve_layered(
                torch.zeros_like(b).to(where), b.to(where),
                **{k: v.to(where) for k, v in coef.items()}, **kw)
            out[where] = (a.cpu(), st, fused_mg.sweep_launches - before[0],
                          fused_mg.residual_launches - before[1])
        (a_c, st_c, *n_c), (a_g, st_g, *n_g) = out["cpu"], out["cuda"]
        rel = ((a_g - a_c).abs().max() / a_c.abs().max()).item()
        good = (st_g.iters == st_c.iters and st_g.nrelax == st_c.nrelax
                and rel <= MG_SOLVE_LIMIT and st_g.resa <= 1e-8
                and n_c == [0, 0] and n_g[1] == st_g.iters + 1
                and n_g[0] > 0)
        ok &= good
        print(f"solve check {'modal' if modal else 'layered'} {n}^2 x {nl} "
              f"f64 tol 1e-8, cuda vs cpu: cycles {st_g.iters} vs "
              f"{st_c.iters}, nrelax {st_g.nrelax} vs {st_c.nrelax}, resa "
              f"{st_g.resa:.3e} vs {st_c.resa:.3e}, rel a = {rel:.3e} "
              f"(limit {MG_SOLVE_LIMIT:g}), K3 launches {n_g[0]}, K4 "
              f"launches {n_g[1]} {'ok' if good else 'FAIL'}")
    return ok


def mg_rows(label, lvl, state, idh0, idh1, n_sweep, n_res, b_zero=False):
    """K3's and K4's records on a path's final state at its finest level
    (Dirichlet walls): K3 a relaxation of MG_RELAX sweeps (one launch) of
    the correction against the residual, K4 the residual of psi against q
    (against 0 with b_zero: the residual of a converged state is a
    cancellation, whose rounding is not the kernel's error). Each row is
    None if the kernel disagrees with its plain version."""
    import torch
    from msom_tpu_torch.solvers import fused_mg
    nl, N = state.psi.shape[0], state.psi.shape[-1]
    sign = dict(sign_x=-1.0, sign_y=-1.0)
    rkw = dict(delta=lvl.delta, idh0=idh0, idh1=idh1, **sign)
    skw = dict(d2=lvl.delta * lvl.delta, **sign)
    psi, q = state.psi.contiguous(), state.q.contiguous()
    res, _ = fused_mg.residual_norm(psi, q, lvl.rp, **rkw)
    da = fused_mg.rb_line_sweep(torch.zeros_like(res), res, lvl.sw, **skw)
    skw["nrelax"] = MG_RELAX
    b = torch.zeros_like(psi) if b_zero else q
    mode = f"nl = {nl}, Dirichlet"
    rows = []
    for name, kernel, plain, work, n_launch, src, line, what in (
            ("mg_sweep", lambda: fused_mg.relax(da, res, lvl.sw, **skw),
             lambda: fused_mg.relax_reference(da, res, lvl.sw, **skw),
             fused_mg.sweep_bound_work(nl, N, 4, MG_RELAX), n_sweep,
             fused_mg.SWEEP_SOURCE, 179,
             f"a relaxation of {MG_RELAX} sweeps"),
            ("mg_residual",
             lambda: fused_mg.residual_norm(psi, b, lvl.rp, **rkw)[0],
             lambda: fused_mg.residual_norm_reference(psi, b, lvl.rp,
                                                      **rkw)[0],
             fused_mg.residual_bound_work(nl, N, 4, lvl.rp.s is not None,
                                          lvl.rp.lam is not None), n_res,
             fused_mg.RESIDUAL_SOURCE, 247,
             f"{'b = 0, ' if b_zero else ''}its max norm in the launch")):
        row = _kernel_row(label, name, kernel, plain, work, n_launch, src,
                          f"msom_tpu/solvers/pallas_mg.py:{line}",
                          f"{mode}, {what}", limit=MG_LIMITS[4], n_plain=3)
        rows.append(row)
    return rows


def mg_path(QGConfig, rows, main_err):
    """The multigrid path at full width; appends K3's and K4's records to
    `rows`. Returns False if the path failed."""
    import torch
    from msom_tpu_torch.models import fused_rhs, fused_tracer, qg
    from msom_tpu_torch.solvers import fused_mg, fused_spectral
    N, nl, warm, steps = 2048, 4, 200, 40
    shape = (nl, N, N)
    cfg = bench_config(QGConfig, N, nl, "float32", solver="mg", tol=1e-3)
    t0 = time.perf_counter()
    const = qg.build_constants(cfg, device="cuda")
    psi0 = 1e-3 * np.random.default_rng(0).uniform(-1, 1, shape)
    state = qg.init_state(cfg, const, psi0=psi0)
    step = qg.make_step(cfg)
    torch.cuda.synchronize()
    print(f"mg path set-up: {time.perf_counter() - t0:.1f} s, "
          f"{len(const.levels)} levels, profiles on every level: "
          f"{all(lv.sw is not None for lv in const.levels)}")
    t0 = time.perf_counter()
    spin = []
    for _ in range(warm):
        state, diag = step(state, const, 1e18)
        spin.append(diag.mg_iters)
    torch.cuda.synchronize()
    print(f"mg path spin-up: {warm} steps in {time.perf_counter() - t0:.1f} "
          f"s, V-cycles of the first solve: first ten steps {spin[:10]}, "
          f"last ten {spin[-10:]}")
    torch.cuda.reset_peak_memory_stats()
    fused_rhs.launches = fused_tracer.launches = 0
    fused_spectral.launches = 0
    fused_mg.sweep_launches = fused_mg.residual_launches = 0
    fused_mg.sweeps = 0
    fused_mg.sweep_launches_by_n.clear()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = []       # V-cycles of every solve of the timed steps
    start.record()
    for _ in range(steps):
        n0 = fused_mg.residual_launches
        state, diag = step(state, const, 1e18)
        # a solve launches K4 once for its first residual and once a cycle
        both = fused_mg.residual_launches - n0 - 2
        cycles += [diag.mg_iters, both - diag.mg_iters]
    end.record()
    torch.cuda.synchronize()
    ms_step = start.elapsed_time(end) / steps
    n_rhs, n_sweep, n_res = (fused_rhs.launches, fused_mg.sweep_launches,
                             fused_mg.residual_launches)
    sweeps_by_n = dict(fused_mg.sweep_launches_by_n)
    finite = state_ok(state, diag, shape)
    mean_c, max_c = float(np.mean(cycles)), max(cycles)
    print(f"mg path {N}^2 x {nl} f32 solver=mg tol=1e-3 mg_extrap after "
          f"{warm} spin-up steps: {ms_step:.4f} ms/step, "
          f"{N * N * nl / (ms_step * 1e-3):.4e} grid-points/s, V-cycles a "
          f"solve mean {mean_c:.4f} max {max_c} min {min(cycles)}, "
          f"mg_sweep launches {n_sweep} ({n_sweep / steps:.1f} a step, "
          f"{fused_mg.sweeps / steps:.1f} sweeps a step), "
          f"mg_residual launches {n_res} ({n_res / steps:.1f} a step), "
          f"fused_rhs launches {n_rhs} (expected {2 * steps}), host reads "
          f"of the residual norm {n_res / steps:.1f} a step, last mg_res "
          f"{diag.mg_res:.3e}, ke {diag.ke.item():.6e}, dt "
          f"{diag.dt.item():.6e}, t {state.t.item():.6e}, finite {finite}, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if (n_rhs != 2 * steps or not finite or n_sweep == 0
            or min(cycles) < 1
            or max_c > MG_MAX_CYCLES or fused_tracer.launches != 0
            or fused_spectral.launches != 0):
        return False

    # one more inversion from the older psi, for its statistics
    _, st = qg.invert_q(cfg, const, state.psi_old, state.q)
    print(f"mg inversion of the final q from psi one step back: {st.iters} "
          f"cycles, residual {st.resb:.3e} -> {st.resa:.3e}, final nrelax "
          f"{st.nrelax}")
    if st.iters > MG_MAX_CYCLES or not st.resa <= cfg.tol:
        return False

    # K3 and K4 alone on the final state, K3 a relaxation of MG_RELAX
    lvl = const.levels[0]
    for row in mg_rows("mg", lvl, state, const.idh0, const.idh1, n_sweep,
                       n_res):
        if row is None:
            return False
        row["max_abs_err"] = max(row["max_abs_err"], main_err[row["name"]])
        rows.append(row)
    # K3 by level on the timed path: launches a step, the device time of a
    # relaxation at the path's final nrelax, and so device ms a step,
    # against the bound of the launches
    sign = dict(sign_x=-1.0, sign_y=-1.0)
    nrelax = st.nrelax
    by_level, total, total_b = [], 0.0, 0.0
    for lv in const.levels:
        n = lv.sw.t0.shape[-1]
        z = torch.zeros((nl, n, n), device="cuda")
        kw = dict(nrelax=nrelax, d2=lv.delta * lv.delta, **sign)
        most = fused_mg.sweeps_per_launch(n, nl, torch.float32)
        a_relax = -(-nrelax // most)            # launches a relaxation
        dev = device_ms(lambda: fused_mg.relax(z, z, lv.sw, **kw))
        k = sweeps_by_n.pop(n, 0) / steps
        bound = sum(roofline(*fused_mg.sweep_bound_work(
            nl, n, 4, min(most, nrelax - i * most)), 4)[0]
            for i in range(a_relax))
        by_level.append((n, k, a_relax, dev, bound))
        total += k / a_relax * dev
        total_b += k / a_relax * bound
    print(f"mg_sweep by level on the timed path at nrelax {nrelax} (n: "
          "launches a step, launches a relaxation, device ms a relaxation, "
          "device ms a step, bound ms a relaxation, device over bound): "
          + ", ".join(f"n={n}: {k:.2f}, {a}, {dev:.4f}, {k / a * dev:.4f}, "
                      f"{b:.5f}, {dev / b:.1f}"
                      for n, k, a, dev, b in by_level)
          + f"; in all {total:.4f} device ms a step against a bound of "
          f"{total_b:.4f}; launches at other widths "
          f"{sum(sweeps_by_n.values())}")
    if n_sweep / steps > MG_MAX_K3_LAUNCHES:
        print(f"mg path: {n_sweep / steps:.1f} K3 launches a step, more than "
              f"{MG_MAX_K3_LAUNCHES} FAIL")
        return False

    box = [state]

    def one_step():
        box[0], _ = step(box[0], const, 1e18)

    prof = kernel_profile("mg", one_step, 4, ms_step)
    k3 = [r for r in prof if "mg_strip_kernel" in r[2]
          or "mg_whole_kernel" in r[2]]
    k4 = [r for r in prof if "mg_residual_kernel" in r[2]]
    reduce = [r for r in prof if "reduce_kernel" in r[2]]
    print(f"profile mg: K3 {sum(r[0] for r in k3):.4f} device ms a step in "
          f"{sum(r[1] for r in k3):.1f} launches, K4 "
          f"{sum(r[0] for r in k4):.4f} in {sum(r[1] for r in k4):.1f}, "
          f"torch reductions {sum(r[1] for r in reduce):.1f} launches a "
          "step")
    return True


def fused_mm_path(QGConfig, rows, main_err):
    """The fused-solve path at 1024^2 x 4; appends K7's record to `rows`.
    Returns False if the path failed."""
    import torch
    from msom_tpu_torch.models import fused_rhs, fused_tracer, qg
    from msom_tpu_torch.solvers import fused_spectral, spectral
    N, nl, warm, steps = 1024, 4, 10, 20
    shape = (nl, N, N)
    psi0 = 1e-3 * np.random.default_rng(0).uniform(-1, 1, shape)
    # the device work of a step is short at this size, so the host shows in
    # ms/step: the three variants are timed in turns, `rounds` times each
    rounds = 3
    runs = {}
    for label, kw, build_kw in (
            ("fused_mm (K7)", {}, dict(fused_mm=True)),
            ("transform=matmul (cuBLAS chain)", dict(transform="matmul"), {}),
            ("default (folded DST)", {}, {})):
        cfg = bench_config(QGConfig, N, nl, "float32", **kw)
        const = qg.build_constants(cfg, device="cuda", **build_kw)
        state = qg.init_state(cfg, const, psi0=psi0)
        step = qg.make_step(cfg)
        for _ in range(warm):
            state, diag = step(state, const, 1e18)
        runs[label] = dict(const=const, state=state, step=step, ms=[],
                           want=8 * steps if build_kw else 0)
    torch.cuda.synchronize()
    for _ in range(rounds):
        for label, run in runs.items():
            fused_rhs.launches = fused_tracer.launches = 0
            fused_spectral.launches = 0
            run["state"], run["diag"], ms_step = timed_steps(
                run["step"], run["state"], run["const"], steps)
            run["ms"].append(ms_step)
            run["n_k7"] = fused_spectral.launches
            if run["n_k7"] != run["want"] \
                    or fused_rhs.launches != 2 * steps:
                print(f"{label}: fused_spectral launches {run['n_k7']} "
                      f"(expected {run['want']}), fused_rhs launches "
                      f"{fused_rhs.launches} (expected {2 * steps})")
                return False
    for label, run in runs.items():
        diag, ms_step = run["diag"], min(run["ms"])
        finite = state_ok(run["state"], diag, shape)
        print(f"{N}^2 x {nl} f32 step, {label}: {ms_step:.4f} ms/step (the "
              f"least of {', '.join(f'{m:.4f}' for m in run['ms'])}), "
              f"{N * N * nl / (ms_step * 1e-3):.4e} grid-points/s, "
              f"fused_spectral launches {run['n_k7']} a round (expected "
              f"{run['want']}), fused_rhs launches {2 * steps}, "
              f"ke {diag.ke.item():.6e}, dt {diag.dt.item():.6e}, "
              f"finite {finite}")
        if not finite:
            return False
    k7_run, mm_run = list(runs.values())[:2]
    k7_launches, k7_state, k7_const = (k7_run["n_k7"], k7_run["state"],
                                       k7_run["const"])
    a, b = k7_run["state"].psi, mm_run["state"].psi
    rel = ((a - b).abs().max() / b.abs().max()).item()
    print(f"K7 path against the cuBLAS path after {warm + rounds * steps} "
          f"steps: "
          f"max|d psi|/max|psi| = {rel:.3e} (limit 1e-3)")
    if not rel <= 1e-3:
        return False
    spec = k7_const.spec
    qm = torch.einsum("ml,lyx->myx", spec.l2m, k7_state.q).contiguous()
    def k7_solve():
        return fused_spectral.fused_mm_solve(spec.S, spec.inv_den, qm, spec.mm)

    def chain_solve():
        return spectral._mm_solve(spec.S, spec.inv_den, qm)

    k_ms, p_ms = kernel_times(k7_solve, chain_solve, 20, 20)
    k_host, p_host = host_ms(k7_solve), host_ms(chain_solve)
    nbytes, nops = fused_spectral.bound_work(N, nl, 4)
    fp32_bound, _, t_b, t_o = roofline(nbytes, nops, 4)
    tc_ops = fused_spectral.tensor_core_work(N, nl)
    t_tc = tc_ops / PEAK_TF32_OPS_PER_S * 1e3
    bound, by = max(t_b, t_tc), "bytes" if t_b >= t_tc else "operations"
    e_k, e_r = main_err["fused_spectral_f64"]
    print(f"K7 at {N}^2 x {nl} f32: kernel {k_ms:.4f} ms a solve (4 "
          f"launches), plain = library (cuBLAS chain, TF32 off) {p_ms:.4f} "
          f"ms, kernel / library {k_ms / p_ms:.3f}; bound {bound:.4f} ms by "
          f"{by} on the TF32 tensor cores ({fused_spectral.TF32_PASSES} "
          f"passes, operations {tc_ops} -> {t_tc:.4f} ms), the FP32 pipe's "
          f"{fp32_bound:.4f} ms (operations {nops} -> {t_o:.4f} ms; bytes "
          f"{nbytes} -> {t_b:.4f} ms); error against the f64 chain: kernel "
          f"{e_k:.3e}, cuBLAS FP32 chain {e_r:.3e}; host time a solve "
          f"(launches queued, not waited for): kernel {k_host:.4f} ms, "
          f"cuBLAS chain {p_host:.4f} ms")
    if not k_ms < p_ms:
        return False
    box = [k7_state]

    def one_step():
        box[0], _ = k7_run["step"](box[0], k7_const, 1e18)

    kernel_profile("fused_mm (K7)", one_step, 4, min(k7_run["ms"]))
    rows.append({
        "name": "fused_spectral", "path": f"fused_mm {N}^2 x {nl} f32",
        "route": "cuda", "source": fused_spectral.SOURCE,
        "replaces": "msom_tpu/solvers/pallas_spectral.py:82",
        "launches": k7_launches, "max_abs_err": main_err["fused_spectral"],
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
        "library_ms": p_ms})
    return True


# ---------------------------------------------------------------------------
# the qg-node family (phase name node): K5, K6, a masked solve, the steps and
# bench.py's two node rows at full width
# ---------------------------------------------------------------------------

NODE_SIZES = [(256, 1), (256, 3), (256, 4), (100, 3), (100, 1), (24, 4),
              (130, 4), (2048, 4), (2048, 1)]
VMG_SIZES = [3, 5, 9, 17, 65, 257, 2049]


def node_config(NodeQGConfig, N, nl, dtype, **kw):
    """bench.py's measure_node configuration (bench.py:178-185) at N; the
    filter (dtflt = 1) where N is a power of 2, which its wavelet pyramid
    needs (the kernel checks' other widths run without it)."""
    base = dict(N=N, nl=nl, L0=100.0, f0=46.5, beta=0.5, hEkb=1e-3,
                tau0=1e-3, nu=5.0 / (N / 64), dh=tuple([1.0 / nl] * nl),
                N2=tuple([1.0] * (nl - 1)), noise_init=1e-3, bc_fac=1.0,
                DT=5e-2, tend=1e18, dtout=1e18, CFL=0.2, TOLERANCE=1e-5,
                dtflt=-1.0 if N & (N - 1) else 1.0, Lfmax=30.0,
                Lfmin=10.0, dtype=dtype)
    base.update(kw)
    return NodeQGConfig(**base)


def node_noise_ic(cfg, seed=0):
    """A numpy-seeded noise IC of bench's kind: noise_init * (uniform noise
    + sin(2 pi y / L0)) (the JAX init_state's formula, numpy's draw)."""
    M = cfg.N + 1
    y = np.arange(M)[:, None] * cfg.delta
    rng = np.random.default_rng(seed)
    return cfg.noise_init * (rng.uniform(-1, 1, (cfg.nl, M, M))
                             + np.sin(2 * np.pi * y / cfg.L0))


def node_variants(NodeQGConfig, N, nl, dtype, rng):
    """{option: (cfg, const)} of K5's option sets on the card, cut out of
    constants built once with every coupling field; flag_ms takes S2 of its
    form, f_var^2 / N2 with f_var = f0 + beta (y - L0/2), as the y-profile
    (qg_baroclinic_ms.h:48)."""
    import torch
    from msom_tpu_torch.models import qg_node
    M = N + 1
    if nl == 1:
        cfg = node_config(NodeQGConfig, N, 1, dtype, gp_low=4.0)
        return {"barotropic": (cfg, qg_node.build_constants(cfg))}
    cfg0 = node_config(NodeQGConfig, N, nl, dtype)
    full = qg_node.build_constants(
        cfg0, psi_pg=1e-3 * rng.uniform(-1, 1, (nl, M, M)),
        topo=1e-2 * rng.uniform(-1, 1, (M, M)),
        q_forcing_3d=rng.uniform(-1, 1, (nl, M, M)))
    tdt = getattr(torch, dtype)
    f_var = cfg0.f0 + cfg0.beta * (np.arange(M) * cfg0.delta - 0.5 * cfg0.L0)
    prof = torch.as_tensor(f_var[None] ** 2 / np.asarray(cfg0.N2)[:, None],
                           dtype=tdt).cuda()
    flag_ms = dict(S2_prof=prof,
                   S2=prof[..., None].expand(nl - 1, M, M).contiguous())
    island = full.mask.clone()
    island[M // 3:M // 3 + 6, M // 2:M // 2 + 7] = 0.0
    coast = torch.as_tensor(qg_node.coastline_mask(N), dtype=tdt).cuda()
    nu4 = 50.0 * (64 / N) ** 4
    bare = dict(has_pg=False, has_topo=False, q_forcing_3d=None)
    cuts = {"bench": ({}, bare), "freeslip": (dict(bc_fac=0.0), bare),
            "noslip_nu4": (dict(nu4=nu4), bare),
            "pg": ({}, {**bare, "has_pg": True}),
            "topo": ({}, {**bare, "has_topo": True}),
            "qf3": ({}, {**bare, "q_forcing_3d": full.q_forcing_3d}),
            "flag_ms": (dict(flag_ms=1), {**bare, **flag_ms}),
            "island": ({}, {**bare, "mask": island}),
            "coast": ({}, {**bare, "mask": coast}),
            "all": (dict(flag_ms=1, nu4=nu4), dict(mask=island, **flag_ms))}
    return {name: (node_config(NodeQGConfig, N, nl, dtype, **kw),
                   dataclasses.replace(full, **cut))
            for name, (kw, cut) in cuts.items()}


def node_kernel_checks(NodeQGConfig):
    """K5 against its plain version on the card with every option set;
    returns (ok, {(path option): max abs error at 2048^2 x 4 f32})."""
    import torch
    from msom_tpu_torch.models import fused_node_rhs, qg_node
    from msom_tpu_torch.ops import vertex
    ok, main_err = True, {}
    for dtype in ("float64", "float32"):
        lim = LIMITS[8 if dtype == "float64" else 4]
        for N, nl in NODE_SIZES:
            rng = np.random.default_rng(N + nl)
            psi = vertex.bc_psi(torch.as_tensor(
                1e-3 * rng.uniform(-1, 1, (nl, N + 1, N + 1)),
                dtype=getattr(torch, dtype)).cuda())
            t = torch.tensor(0.37, dtype=psi.dtype, device="cuda")
            for name, (cfg, const) in node_variants(
                    NodeQGConfig, N, nl, dtype, rng).items():
                q = qg_node.comp_q(cfg, const, psi)
                qf = qg_node.q_forcing_profile(cfg, const.yv[:, 0], t)
                before = fused_node_rhs.launches
                dq_k = fused_node_rhs.rhs_fused_node(cfg, const, q, psi, qf)
                dq_r = fused_node_rhs.rhs_node_reference(cfg, const, q, psi,
                                                         qf)
                torch.cuda.synchronize()
                abs_err = (dq_k - dq_r).abs().max().item()
                rel = abs_err / dq_r.abs().max().item()
                good = (rel <= lim and fused_node_rhs.launches == before + 1
                        and dq_k.shape == psi.shape)
                ok &= good
                print(f"K5 check {dtype} N={N} nl={nl} {name}: max|d dq|/"
                      f"max|dq| = {rel:.3e} (limit {lim:g}) "
                      f"{'ok' if good else 'FAIL'}")
                if dtype == "float32" and (N, nl) == (2048, 4):
                    main_err[name] = abs_err
                del q, dq_k, dq_r
            del psi
            torch.cuda.empty_cache()
    return ok, main_err


def vmg_level_on_card(nl, n, dtype, rng):
    """The finest vertex level of the coastline grid with an x-varying S2
    on the card, and two random masked fields."""
    import torch
    from msom_tpu_torch.models.qg_node import coastline_mask
    from msom_tpu_torch.solvers import vmg
    tdt = getattr(torch, dtype)
    N = n - 1
    mask = torch.as_tensor(coastline_mask(N), dtype=tdt).cuda()
    S2 = None
    if nl > 1:
        S2 = torch.as_tensor(1.0 + 0.3 * rng.standard_normal(
            (nl - 1, n, n)) ** 2, dtype=tdt).cuda()
    idh0 = np.r_[0.0, rng.uniform(1, 3, nl - 1)]
    idh1 = np.r_[rng.uniform(1, 3, nl - 1), 0.0]
    lvl = vmg.build_vlevels(nl=nl, N=N, L0=100.0, S2=S2, idh0=idh0,
                            idh1=idh1, mask=mask, dtype=tdt,
                            iRd2_low=0.0 if nl > 1 else 5.0)[0]
    da, res = (torch.as_tensor(rng.standard_normal((nl, n, n)), dtype=tdt)
               .cuda() * mask for _ in range(2))
    return lvl, da, res


def vmg_kernel_checks():
    """K6 against its plain version: a relaxation of NRELAX sweeps in one
    launch, beside NRELAX one-sweep launches (bitwise) and the plain
    version; returns (ok, max abs error at 2049^2 x 4 f32)."""
    import torch
    from msom_tpu_torch.solvers import fused_vmg
    from msom_tpu_torch.solvers.vmg import NRELAX
    ok, main_err = True, None
    for dtype in ("float64", "float32"):
        lim = MG_LIMITS[8 if dtype == "float64" else 4]
        for n in VMG_SIZES:
            for nl in (1, 2, 3, 4):
                rng = np.random.default_rng(n + nl)
                lvl, da, res = vmg_level_on_card(nl, n, dtype, rng)
                n0 = fused_vmg.launches
                k = fused_vmg.vrb_relax(da, res, lvl, NRELAX)
                n1 = fused_vmg.launches
                s = da
                for _ in range(NRELAX):
                    s = fused_vmg.vrb_sweep(s, res, lvl)
                n5 = fused_vmg.launches
                p = fused_vmg.vrb_relax_reference(da, res, lvl, NRELAX)
                torch.cuda.synchronize()
                err = (k - p).abs().max().item()
                rel = err / p.abs().max().item()
                same = torch.equal(k, s)
                good = (rel <= lim and same and k.shape == da.shape
                        and (n1 - n0, n5 - n1) == (1, NRELAX))
                ok &= good
                print(f"K6 check {dtype} n={n} nl={nl} coastline, x-varying "
                      f"S2: a relaxation of {NRELAX} sweeps in one launch "
                      f"max|d da|/max|da| = {rel:.3e} (limit {lim:g}), equal "
                      f"to {NRELAX} one-sweep launches bitwise {same}, "
                      f"launches {n1 - n0} and {n5 - n1} "
                      f"{'ok' if good else 'FAIL'}")
                if dtype == "float32" and (n, nl) == (2049, 4):
                    main_err = err
                del lvl, da, res, k, p, s
            torch.cuda.empty_cache()
    return ok, main_err


def vpoisson_check():
    """A whole masked vpoisson on the card against the CPU in f64 (128^2 x 3,
    coastline, x-varying S2, tol 1e-8): the same cycles, the solution
    within 1e-10, every relaxation one K6 launch on the card."""
    import torch
    from msom_tpu_torch.models.qg_node import coastline_mask
    from msom_tpu_torch.solvers import fused_vmg, vmg
    nl, N = 3, 128
    rng = np.random.default_rng(5)
    S2 = torch.tensor(1.0 + 0.3 * rng.standard_normal(
        (nl - 1, N + 1, N + 1)) ** 2)
    mask = torch.tensor(coastline_mask(N))
    idh0 = np.r_[0.0, rng.uniform(1, 3, nl - 1)]
    idh1 = np.r_[rng.uniform(1, 3, nl - 1), 0.0]
    b = torch.tensor(rng.standard_normal((nl, N + 1, N + 1))) * mask
    out = {}
    for where in ("cpu", "cuda"):
        levels = vmg.build_vlevels(nl=nl, N=N, L0=100.0, S2=S2.to(where),
                                   idh0=idh0, idh1=idh1, mask=mask.to(where),
                                   dtype=torch.float64)
        before = fused_vmg.launches
        a, st = vmg.vpoisson(torch.zeros_like(b).to(where), b.to(where),
                             levels=levels, idh0=idh0, idh1=idh1,
                             tolerance=1e-8)
        out[where] = (a.cpu(), st, fused_vmg.launches - before, len(levels))
    (a_c, st_c, n_c, _), (a_g, st_g, n_g, nlev) = out["cpu"], out["cuda"]
    rel = ((a_g - a_c).abs().max() / a_c.abs().max()).item()
    good = (st_g.iters == st_c.iters and rel <= MG_SOLVE_LIMIT
            and st_g.resa <= 1e-8 and n_c == 0
            and n_g == st_g.iters * nlev)
    print(f"vpoisson check coastline {N}^2 x {nl} f64 tol 1e-8, cuda vs cpu: "
          f"cycles {st_g.iters} vs {st_c.iters}, resa {st_g.resa:.3e} vs "
          f"{st_c.resa:.3e}, rel a = {rel:.3e} (limit {MG_SOLVE_LIMIT:g}), K6 "
          f"launches {n_g} {'ok' if good else 'FAIL'}")
    return good


def node_step_checks(NodeQGConfig):
    """The node step on the card against the CPU step, f64, 128^2 x 3, 20
    steps from one numpy IC: the spectral inversion, and solver="vmg" with
    the coastline mask (the same V-cycles every step)."""
    import torch
    from msom_tpu_torch.models import fused_node_rhs, qg_node
    from msom_tpu_torch.solvers import fused_vmg
    ok = True
    for solver in ("auto", "vmg"):
        cfg = node_config(NodeQGConfig, 128, 3, "float64", solver=solver,
                          TOLERANCE=1e-8)
        inputs = (dict(mask=qg_node.coastline_mask(128)) if solver == "vmg"
                  else {})
        psi0 = node_noise_ic(cfg, 42)
        step = qg_node.make_step(cfg)
        runs = {}
        for where in ("cpu", "cuda"):
            const = qg_node.build_constants(cfg, device=where, **inputs)
            state = qg_node.init_state(cfg, const, psi0=psi0)
            before = fused_node_rhs.launches, fused_vmg.launches
            cycles = []
            for _ in range(20):
                state, diag = step(state, const, 1e9)
                cycles.append(diag.mg_iters)
            runs[where] = (state, cycles,
                           fused_node_rhs.launches - before[0],
                           fused_vmg.launches - before[1])
        (cpu, c_cpu, *n_cpu), (gpu, c_gpu, *n_gpu) = runs["cpu"], runs["cuda"]
        rels = {name: ((getattr(gpu, name).cpu() - getattr(cpu, name)).abs()
                       .max() / getattr(cpu, name).abs().max()).item()
                for name in ("q", "psi")}
        good = (all(r <= STEP_LIMIT for r in rels.values())
                and c_gpu == c_cpu and n_cpu == [0, 0] and n_gpu[0] == 40
                and (n_gpu[1] > 0) == (solver == "vmg")
                and (solver != "vmg" or min(c_gpu) >= 1))
        ok &= good
        print(f"step check node solver={solver} 128^2 x 3 f64, 20 steps cuda "
              f"vs cpu: " + ", ".join(f"rel {k} = {v:.3e}"
                                      for k, v in rels.items())
              + f" (limit {STEP_LIMIT:g}), V-cycles of the first solve cuda "
              f"{c_gpu} cpu {c_cpu}, K5/K6 launches {n_gpu} "
              f"{'ok' if good else 'FAIL'}")
    return ok


def node_paths(NodeQGConfig, rows, k5_err, k6_err):
    """bench.py's two node rows at 2048^2 x 4 f32: the spectral step (K5)
    and the coastline-masked vmg step (K6 and K5); appends the kernels'
    records to `rows`. Returns False if a path failed."""
    import torch
    from msom_tpu_torch.models import fused_node_rhs, fused_rhs, qg_node
    from msom_tpu_torch.solvers import fused_mg, fused_vmg, vmg
    N, nl, steps = 2048, 4, 40
    shape = (nl, N + 1, N + 1)
    for label, warm in (("node", 40), ("node_masked", 100)):
        masked = label == "node_masked"
        cfg = node_config(NodeQGConfig, N, nl, "float32",
                          **(dict(solver="vmg") if masked else {}))
        t0 = time.perf_counter()
        const = qg_node.build_constants(
            cfg, **(dict(mask=qg_node.coastline_mask(N)) if masked else {}))
        state = qg_node.init_state(cfg, const, psi0=node_noise_ic(cfg))
        step = qg_node.make_step(cfg)
        torch.cuda.synchronize()
        nlev = len(const.vlevels) if masked else 0
        print(f"{label} path set-up: {time.perf_counter() - t0:.1f} s, "
              f"inversion {'vmg, %d levels' % nlev if masked else 'spectral'}"
              f" ({type(const.nspec.fac).__name__ if const.nspec else ''})")
        t0 = time.perf_counter()
        spin = []
        for _ in range(warm):
            state, diag = step(state, const, 1e18)
            spin.append(diag.mg_iters)
        torch.cuda.synchronize()
        print(f"{label} path spin-up: {warm} steps in "
              f"{time.perf_counter() - t0:.1f} s"
              + (f", V-cycles of the first solve: first ten {spin[:10]}, "
                 f"last ten {spin[-10:]}" if masked else ""))
        torch.cuda.reset_peak_memory_stats()
        fused_node_rhs.launches = fused_vmg.launches = 0
        fused_rhs.launches = fused_mg.sweep_launches = 0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        cycles = []       # V-cycles of every solve of the timed steps
        start.record()
        for _ in range(steps):
            n0 = fused_vmg.launches
            state, diag = step(state, const, 1e18)
            if masked:
                # a relaxation is one K6 launch a level and cycle
                both = (fused_vmg.launches - n0) // nlev
                cycles += [diag.mg_iters, both - diag.mg_iters]
        end.record()
        torch.cuda.synchronize()
        ms_step = start.elapsed_time(end) / steps
        n_k5, n_k6 = fused_node_rhs.launches, fused_vmg.launches
        finite = (bool(torch.isfinite(state.q).all())
                  and bool(torch.isfinite(state.psi).all())
                  and np.isfinite(diag.ke.item()) and diag.dt.item() > 0
                  and tuple(state.q.shape) == shape)
        extra = ""
        if masked:
            extra = (f", V-cycles a solve mean {np.mean(cycles):.4f} max "
                     f"{max(cycles)} min {min(cycles)}, host reads of the "
                     f"residual norm {(sum(cycles) + 2 * steps) / steps:.1f} "
                     "a step")
        print(f"{label} path {N}^2 x {nl} f32 after {warm} spin-up steps: "
              f"{ms_step:.4f} ms/step, {N * N * nl / (ms_step * 1e-3):.4e} "
              f"grid-points/s, node_rhs launches {n_k5} "
              f"({n_k5 / steps:.1f} a step), vmg_sweep launches {n_k6} "
              f"({n_k6 / steps:.1f} a step){extra}, ke {diag.ke.item():.6e}, "
              f"dt {diag.dt.item():.6e}, t {state.t.item():.6e}, finite "
              f"{finite}, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if (n_k5 != 2 * steps or not finite or fused_rhs.launches
                or fused_mg.sweep_launches or (n_k6 > 0) != masked
                or (masked and (min(cycles) < 1 or max(cycles) > 99))):
            return False

        psi, q = state.psi.contiguous(), state.q.contiguous()
        qf = qg_node.q_forcing_profile(cfg, const.yv[:, 0], state.t)
        k_ms, p_ms = kernel_times(
            lambda: fused_node_rhs.rhs_fused_node(cfg, const, q, psi, qf),
            lambda: fused_node_rhs.rhs_node_reference(cfg, const, q, psi,
                                                      qf))
        work = fused_node_rhs.bound_work(cfg, const, 4)
        bound, by, t_b, t_o = roofline(*work, 4)
        print(f"K5 {label} at {N}^2 x {nl} f32: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, bound {bound:.4f} ms by {by} (bytes {work[0]} "
              f"-> {t_b:.4f} ms, operations {work[1]} -> {t_o:.4f} ms), "
              f"{t_b / k_ms:.3f} of the byte bound, library_ms null")
        rows.append({
            "name": "node_rhs", "path": f"{label} {N}^2 x {nl} f32",
            "route": "cuda", "source": fused_node_rhs.SOURCE,
            "replaces": "msom_tpu/models/pallas_node_rhs.py:126",
            "launches": n_k5,
            "max_abs_err": k5_err["coast" if masked else "bench"],
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None})
        if not masked:
            # bench.py's filter protocol (bench.py:218-240): five chained
            # wavelet_filter calls, nbar held, the best of two rounds
            def chain():
                s = state
                for _ in range(5):
                    s = dataclasses.replace(
                        qg_node.wavelet_filter(cfg, const, s), nbar=s.nbar)
                return s

            chain()
            walls = [cuda_ms(chain, 1) / 5 for _ in range(2)]
            print(f"node filter at {N}^2 x {nl} f32 (bench.py's protocol, "
                  f"5 chained wavelet_filter calls, best of 2): "
                  f"{min(walls):.4f} ms a filter (rounds "
                  + ", ".join(f"{w:.4f}" for w in walls) + ")")
        if masked:
            lvl = const.vlevels[0]
            res, _ = vmg.residual_v(psi, q, lvl, const.idh0, const.idh1)
            da = fused_vmg.vrb_sweep(torch.zeros_like(res), res, lvl)

            def five_sweeps():
                d = da
                for _ in range(vmg.NRELAX):
                    d = fused_vmg.vrb_sweep(d, res, lvl)

            k_ms, p_ms = kernel_times(
                lambda: fused_vmg.vrb_relax(da, res, lvl, vmg.NRELAX),
                lambda: fused_vmg.vrb_relax_reference(da, res, lvl,
                                                      vmg.NRELAX))
            s_ms = cuda_ms(five_sweeps, 10)
            work = fused_vmg.bound_work(nl, N + 1, 4, vmg.NRELAX)
            bound, by, t_b, t_o = roofline(*work, 4)
            sweep_bound = roofline(*fused_vmg.bound_work(nl, N + 1, 4), 4)[0]
            print(f"K6 at {N + 1}^2 x {nl} f32, a relaxation of "
                  f"{vmg.NRELAX} sweeps: kernel {k_ms:.4f} ms in one launch, "
                  f"{s_ms:.4f} ms as {vmg.NRELAX} one-sweep launches "
                  f"({s_ms / vmg.NRELAX:.4f} a sweep), plain {p_ms:.4f} ms; "
                  f"bound {bound:.4f} ms by {by} for the relaxation (bytes "
                  f"{work[0]} -> {t_b:.4f} ms, operations {work[1]} -> "
                  f"{t_o:.4f} ms), {sweep_bound:.4f} ms a sweep "
                  f"({vmg.NRELAX * sweep_bound:.4f} for {vmg.NRELAX} "
                  f"one-sweep launches), library_ms null")
            if not k_ms < s_ms:
                return False
            rows.append({
                "name": "vmg_sweep", "path": f"{label} {N}^2 x {nl} f32",
                "route": "cuda", "source": fused_vmg.SOURCE,
                "replaces": "msom_tpu/solvers/pallas_vmg.py:105",
                "launches": n_k6, "max_abs_err": k6_err, "ms": k_ms,
                "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
                "library_ms": None})
            total_bound, per_level = 0.0, []
            for lv in const.vlevels:
                n = lv.mask.shape[-1]
                z = torch.zeros((nl, n, n), device="cuda")
                ms = cuda_ms(
                    lambda: fused_vmg.vrb_relax(z, z, lv, vmg.NRELAX), 50)
                total_bound += roofline(
                    *fused_vmg.bound_work(nl, n, 4, vmg.NRELAX), 4)[0]
                per_level.append((n, ms))
            print(f"vmg_sweep by level, ms a relaxation of {vmg.NRELAX} "
                  "sweeps (one launch): "
                  + ", ".join(f"n={n}: {ms:.4f}" for n, ms in per_level)
                  + f"; one V-cycle: {sum(ms for _, ms in per_level):.4f} ms "
                  f"in {len(per_level)} launches against a summed bound of "
                  f"{total_bound:.4f} ms")
            _, st = qg_node.invert_q(cfg, const, psi, q)
            print(f"vmg inversion of the final q from the final psi: "
                  f"{st.iters} cycles, residual {st.resb:.3e} -> "
                  f"{st.resa:.3e}")

        box = [state]

        def one_step():
            box[0], _ = step(box[0], const, 1e18)

        kernel_profile(label, one_step, 4, ms_step)
        del const, state, psi, q, box
        torch.cuda.empty_cache()
    return True


# ---------------------------------------------------------------------------
# the doubly periodic and the stochastic msqg (phase names periodic and
# stochastic): K1's periodic and stochastic modes, K2's periodic mode, the
# steps on the card against the CPU, and the two paths at full width
# ---------------------------------------------------------------------------

def k1_mode_checks(QGConfig, periodic, names, sizes=KERNEL_SIZES):
    """K1 against its plain version on the card, f64 and f32, every option
    set in `names` (k1_variant), periodic (sbc = -1, pp from a uniform
    flow and a rough psipg: its ghosts follow the non-wrap law) or walled;
    returns (ok, {name: max|d dq| at 2048^2 x 4 f32})."""
    import torch
    from msom_tpu_torch.models import fused_rhs, qg
    ok, errs = True, {}
    for dtype in ("float64", "float32"):
        lim = LIMITS[8 if dtype == "float64" else 4]
        for N, nl in sizes:
            Re = 0.0 if N in (100, 2048) else 1000.0
            flow = {k: v[:nl] for k, v in PG_FLOW.items()} if periodic \
                else {}
            cfg = bench_config(QGConfig, N, nl, dtype, Re=Re, Eks=0.001,
                               flsrv=1, sbc=-1.0 if periodic else 0.0,
                               **flow)
            full = qg.build_constants(cfg, device="cuda",
                                      **coupled_fields(cfg, 1e-3, N + nl))
            rng = np.random.default_rng(N + nl)
            psi = torch.as_tensor(1e-3 * rng.uniform(-1, 1, (nl, N, N)),
                                  dtype=getattr(torch, dtype),
                                  device="cuda")
            q = qg.comp_q(cfg, full, psi).contiguous()
            for name in names:
                vcfg, vconst = k1_variant(cfg, full, name)
                qin = q if vcfg.energy_conserv or vcfg.stochastic else None
                dq_k, um_k = fused_rhs.rhs_fused(vcfg, vconst, psi, qin)
                dq_r, um_r = fused_rhs.rhs_fused_reference(vcfg, vconst, psi,
                                                           qin)
                torch.cuda.synchronize()
                abs_err = (dq_k - dq_r).abs().max().item()
                rel = abs_err / dq_r.abs().max().item()
                rel_u = ((um_k - um_r).abs() / um_r).max().item()
                good = rel <= lim and rel_u <= lim
                ok &= good
                print(f"K1 {'periodic' if periodic else 'walled'} check "
                      f"{dtype} N={N} nl={nl} Re={Re:g} {name}: max|d dq|/"
                      f"max|dq| = {rel:.3e}, max|d umax|/umax = {rel_u:.3e} "
                      f"(limit {lim:g}) {'ok' if good else 'FAIL'}")
                if dtype == "float32" and (N, nl) == (2048, 4):
                    errs[name] = abs_err
                del dq_k, dq_r
            del full, psi, q
            torch.cuda.empty_cache()
    return ok, errs


def k2_checks(QGConfig, periodic, sizes=KERNEL_SIZES):
    """K2, walled or periodic, against its plain version on the card, f64
    and f32, 1, 2 and 3 tracers (3: the loop over a run-time count), with
    and without a relaxation field; returns (ok, max|d dtr| at 2048^2 x 4 x
    2 f32 without relaxation)."""
    import torch
    from msom_tpu_torch.models import fused_tracer, qg
    ok, err = True, None
    for dtype in ("float64", "float32"):
        lim = LIMITS[8 if dtype == "float64" else 4]
        for N, nl in sizes:
            rng = np.random.default_rng(N + nl)
            psi = torch.as_tensor(1e-3 * rng.uniform(-1, 1, (nl, N, N)),
                                  dtype=getattr(torch, dtype),
                                  device="cuda")
            for nptr in (1, 2, 3):
                cfg = bench_config(QGConfig, N, nl, dtype,
                                   sbc=-1.0 if periodic else 0.0,
                                   nptr=nptr, Pe=(1e3, 2e3, 7e2)[:nptr],
                                   ptr_r=(100.0, 0.0, 13.0)[:nptr])
                const = qg.build_constants(cfg, device="cuda")
                shape = (nl, nptr, N, N)
                tr = torch.as_tensor(1e-3 * rng.uniform(-1, 1, shape),
                                     dtype=psi.dtype, device="cuda")
                relax = torch.as_tensor(1e-3 * rng.uniform(-1, 1, shape),
                                        dtype=psi.dtype, device="cuda")
                for with_relax in (False, True):
                    tconst = dataclasses.replace(
                        const, ptr_relax=relax if with_relax else None)
                    d_k = fused_tracer.tracer_fused(cfg, tconst, psi, tr)
                    d_r = fused_tracer.tracer_fused_reference(cfg, tconst,
                                                              psi, tr)
                    torch.cuda.synchronize()
                    abs_err = (d_k - d_r).abs().max().item()
                    rel = abs_err / d_r.abs().max().item()
                    good = rel <= lim
                    ok &= good
                    print(f"K2 {'periodic' if periodic else 'walled'} "
                          f"check {dtype} N={N} nl={nl} "
                          f"nptr={nptr} relax={with_relax}: max|d dtr|/"
                          f"max|dtr| = {rel:.3e} (limit {lim:g}) "
                          f"{'ok' if good else 'FAIL'}")
                    if (dtype == "float32" and (N, nl, nptr) == (2048, 4, 2)
                            and not with_relax):
                        err = abs_err
                    del d_k, d_r
                del const, tr, relax
            del psi
            torch.cuda.empty_cache()
    return ok, err


def step_check(QGConfig, label, cfg, coupled=False, fields=None):
    """The step on the card against the port on the CPU, f64, 20 steps from
    one numpy IC (coupled: bench's fields, a weak 3-D forcing, numpy
    tracers; a periodic cfg takes its pp from upg/vpg, not psipg; a
    stochastic cfg draws from a generator seeded alike on each side;
    `fields`: input fields given to build_constants, such as frpg).
    Returns False if they differ beyond STEP_LIMIT, or with solver="mg"
    the V-cycles differ or the kernels did not run."""
    import torch
    from msom_tpu_torch.models import qg
    from msom_tpu_torch.solvers import fused_mg
    rng = np.random.default_rng(42)
    psi0 = 1e-3 * rng.uniform(-1, 1, (cfg.nl, cfg.N, cfg.N))
    fields, tr0 = dict(fields or {}), None
    if coupled:
        fields = coupled_fields(cfg)
        if cfg.sbc == -1:
            del fields["psipg"]
        fields["qforc"] = 1e-5 * rng.standard_normal(psi0.shape)
        tr0 = 1e-3 * rng.uniform(-1, 1, (cfg.nl, cfg.nptr, cfg.N, cfg.N))
    states, cycles, launched = {}, {}, {}
    for where in ("cpu", "cuda"):
        const = qg.build_constants(cfg, device=where, **fields)
        state = qg.init_state(cfg, const, psi0=psi0, tracers0=tr0)
        gen = torch.Generator(device=where).manual_seed(7) \
            if cfg.stochastic else None
        step = qg.make_step(cfg, gen)
        before = fused_mg.sweep_launches, fused_mg.residual_launches
        cycles[where] = []
        for _ in range(20):
            state, diag = step(state, const, 1e9)
            cycles[where].append(diag.mg_iters)
        states[where] = state
        launched[where] = (fused_mg.sweep_launches - before[0],
                           fused_mg.residual_launches - before[1])
    names = ["q", "psi"] + (["tracers"] if tr0 is not None else [])
    rels = {}
    for name in names:
        want = getattr(states["cpu"], name)
        rels[name] = ((getattr(states["cuda"], name).cpu() - want)
                      .abs().max() / want.abs().max()).item()
    good = all(r <= STEP_LIMIT for r in rels.values())
    extra = ""
    if cfg.solver == "mg":
        # the same V-cycles every step, through the kernels on the card
        # only (each of the 40 solves: one K4 for the first residual and
        # one a cycle, at least one cycle); a periodic solve runs torch
        # ops, no kernel (solvers/mg.py)
        want_k = cfg.sbc != -1
        good &= (cycles["cuda"] == cycles["cpu"]
                 and min(cycles["cuda"]) >= 1
                 and launched["cpu"] == (0, 0)
                 and (launched["cuda"][0] > 0) == want_k
                 and (launched["cuda"][1] >= 60 + sum(cycles["cuda"])
                      if want_k else launched["cuda"][1] == 0))
        extra = (f", V-cycles of the first solve cuda {cycles['cuda']} "
                 f"cpu {cycles['cpu']}, K3/K4 launches "
                 f"{launched['cuda']}")
    print(f"step check {label} 128^2 x 3 f64, 20 steps cuda vs cpu: "
          + ", ".join(f"rel {k} = {v:.3e}" for k, v in rels.items())
          + f" (limit {STEP_LIMIT:g}){extra} {'ok' if good else 'FAIL'}")
    return good


def _path_run(label, cfg, const, state, step, warm, steps, want):
    """Warm up, then time `steps` steps with CUDA events, counting the
    launches of K1, K2, K7, K3 and K4: (state, ms/step, K1 launches, K2
    launches), or None if a count differs from `want` (K1, K2) or zero
    for the others, or the state is not finite."""
    import torch
    from msom_tpu_torch.models import fused_rhs, fused_tracer
    from msom_tpu_torch.solvers import fused_mg, fused_spectral
    N, nl = cfg.N, cfg.nl
    for _ in range(warm):
        state, diag = step(state, const, 1e18)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_rhs.launches = fused_tracer.launches = 0
    fused_spectral.launches = 0
    fused_mg.sweep_launches = fused_mg.residual_launches = 0
    state, diag, ms_step = timed_steps(step, state, const, steps)
    n_rhs, n_tr = fused_rhs.launches, fused_tracer.launches
    finite = state_ok(state, diag, (nl, N, N))
    print(f"{label} path {N}^2 x {nl} f32: {ms_step:.4f} ms/step, "
          f"{N * N * nl / (ms_step * 1e-3):.4e} grid-points/s, fused_rhs "
          f"launches {n_rhs} (expected {want[0]}), fused_tracer launches "
          f"{n_tr} (expected {want[1]}), ke {diag.ke.item():.6e}, dt "
          f"{diag.dt.item():.6e}, t {state.t.item():.6e}, finite {finite}, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if (n_rhs, n_tr) != want or not finite or fused_spectral.launches \
            or fused_mg.sweep_launches or fused_mg.residual_launches:
        return None
    return state, ms_step, n_rhs, n_tr


def _kernel_row(label, name, kernel, plain, bound_work, launches, source,
                replaces, mode, limit=LIMITS[4], n_plain=10):
    """Hold one kernel against its plain version on the path's final state
    (f32, `limit` of max|out|; `kernel` and `plain` return the tendency or
    the correction), time both and print them beside the bound; returns
    the kernels' JSON record, or None if they disagree."""
    import torch
    out_k, out_r = kernel(), plain()
    torch.cuda.synchronize()
    abs_err = (out_k - out_r).abs().max().item()
    rel = abs_err / out_r.abs().max().item()
    del out_k, out_r
    k_ms, p_ms = kernel_times(kernel, plain, n_plain=n_plain)
    nbytes, nops = bound_work
    bound, by, t_b, t_o = roofline(nbytes, nops, 4)
    good = rel <= limit
    print(f"{name} ({mode}) on the {label} path's final state, f32: "
          f"max|d out|/max|out| = {rel:.3e} (limit {limit:g}) "
          f"{'ok' if good else 'FAIL'}; kernel {k_ms:.4f} ms, plain "
          f"{p_ms:.4f} ms, bound {bound:.4f} ms by {by} (bytes {nbytes} -> "
          f"{t_b:.4f} ms, operations {nops} -> {t_o:.4f} ms), "
          f"{t_b / k_ms:.3f} of the byte bound, library_ms null")
    if not good:
        return None
    return {"name": name, "path": label, "mode": mode, "route": "cuda",
            "source": source, "replaces": replaces, "launches": launches,
            "max_abs_err": abs_err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None}


def periodic_path(QGConfig, rows):
    """The doubly periodic coupled path (the "_LS_RV class" multiple-scale
    patch) at 2048^2 x 4 f32: bench's physics with sbc = -1, flsrv = 1,
    the uniform flow PG_FLOW, bench's sine topography and two tracers, the
    spectral "auto" inversion (rfft2); 20 warm-up and 40 timed steps, K1
    and K2 alone against their plain versions and bounds, a four-step
    profile and the device time of the rfft2/irfft2 pair. Appends K1's and
    K2's records to `rows`; returns False if the path failed."""
    import torch
    from msom_tpu_torch.models import fused_rhs, fused_tracer, qg
    N, nl, warm, steps = 2048, 4, 20, 40
    cfg = bench_config(QGConfig, N, nl, "float32", sbc=-1.0, flsrv=1,
                       **PG_FLOW, **TRACERS)
    t0 = time.perf_counter()
    const = qg.build_constants(cfg, device="cuda",
                               topo=coupled_fields(cfg)["topo"])
    rng = np.random.default_rng(0)
    psi0 = 1e-3 * rng.uniform(-1, 1, (nl, N, N))
    tr0 = 1e-3 * rng.uniform(-1, 1, (nl, cfg.nptr, N, N))
    state = qg.init_state(cfg, const, psi0=psi0, tracers0=tr0)
    step = qg.make_step(cfg)
    torch.cuda.synchronize()
    spec = const.spec
    print(f"periodic_coupled path set-up: {time.perf_counter() - t0:.1f} s, "
          f"spectral solve by rfft2/irfft2 {spec.periodic and spec.S is None}"
          f" (inv_den {tuple(spec.inv_den.shape)})")
    label = f"periodic_coupled {N}^2 x {nl} f32"
    run = _path_run("periodic_coupled", cfg, const, state, step, warm, steps,
                    (2 * steps, 2 * steps))
    if run is None:
        return False
    state, ms_step, n_rhs, n_tr = run
    psi, tr = state.psi.contiguous(), state.tracers
    for rec in (
            _kernel_row(label, "fused_rhs",
                        lambda: fused_rhs.rhs_fused(cfg, const, psi)[0],
                        lambda: fused_rhs.rhs_fused_reference(cfg, const,
                                                              psi)[0],
                        fused_rhs.bound_work(cfg, const, 4), n_rhs,
                        fused_rhs.SOURCE,
                        "msom_tpu/models/pallas_rhs.py:441", "periodic"),
            _kernel_row(label, "fused_tracer",
                        lambda: fused_tracer.tracer_fused(cfg, const, psi,
                                                          tr),
                        lambda: fused_tracer.tracer_fused_reference(
                            cfg, const, psi, tr),
                        fused_tracer.bound_work(cfg, const, 4), n_tr,
                        fused_tracer.SOURCE,
                        "msom_tpu/models/pallas_rhs.py:778", "periodic")):
        if rec is None:
            return False
        rows.append(rec)
    box = [state]

    def one_step():
        box[0], _ = step(box[0], const, 1e18)

    prof = kernel_profile("periodic_coupled", one_step, 4, ms_step)
    fft = [(ms, n) for ms, n, name in prof if "fft" in name.lower()]
    print(f"periodic_coupled: rfft2/irfft2 (cuFFT) device time "
          f"{sum(ms for ms, _ in fft):.4f} ms/step in "
          f"{sum(n for _, n in fft):.1f} launches/step ({len(fft)} kernels)")
    return bool(fft)


def stochastic_path(QGConfig, rows):
    """bench.py's stochastic row (bench.py:60-62, :370-377) at 1024^2 x 4
    f32: walled, spectral (the folded DST), tr_stoch = 50, amp_stoch =
    1e-6, noise from a seeded generator on the card; bench's 60 spin-up
    steps, then 20 timed; K1's stochastic mode alone against its plain
    version and bound, and a four-step profile. Appends K1's record to
    `rows`; returns False if the path failed."""
    import torch
    from msom_tpu_torch.models import fused_rhs, qg
    N, nl, warm, steps = 1024, 4, 60, 20
    cfg = bench_config(QGConfig, N, nl, "float32", **STOCH)
    const = qg.build_constants(cfg, device="cuda")
    psi0 = 1e-3 * np.random.default_rng(0).uniform(-1, 1, (nl, N, N))
    state = qg.init_state(cfg, const, psi0=psi0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    step = qg.make_step(cfg, gen)
    label = f"stochastic {N}^2 x {nl} f32"
    run = _path_run("stochastic", cfg, const, state, step, warm, steps,
                    (2 * steps, 0))
    if run is None:
        return False
    state, ms_step, n_rhs, _ = run
    psi, q = state.psi.contiguous(), state.q.contiguous()
    rec = _kernel_row(label, "fused_rhs",
                      lambda: fused_rhs.rhs_fused(cfg, const, psi, q)[0],
                      lambda: fused_rhs.rhs_fused_reference(cfg, const, psi,
                                                            q)[0],
                      fused_rhs.bound_work(cfg, const, 4), n_rhs,
                      fused_rhs.SOURCE, "msom_tpu/models/pallas_rhs.py:441",
                      "stochastic")
    if rec is None:
        return False
    rows.append(rec)
    box = [state]

    def one_step():
        box[0], _ = step(box[0], const, 1e18)

    kernel_profile("stochastic", one_step, 4, ms_step)
    return True


def driver_check(QGConfig, label, cfg, coupled=False):
    """run_qg on the card against the CPU, f64, from one numpy IC, with the
    filter, the energy budget and an OutputWriter each (coupled: bench's
    psipg and topography, numpy tracers): the final q, psi, qof, nbar,
    tracers and the six energy fields and the KE log within STEP_LIMIT,
    the same output files, each .bas within float32 rounding (2^-23 of its
    max|value|). Returns False on any difference."""
    import os
    import tempfile
    from msom_tpu_torch import driver
    from msom_tpu_torch.io.bas import read_bas
    from msom_tpu_torch.models import fused_rhs, qg, qg_energy
    rng = np.random.default_rng(42)
    psi0 = 1e-3 * rng.uniform(-1, 1, (cfg.nl, cfg.N, cfg.N))
    fields, tr0 = {}, None
    if coupled:
        fields = coupled_fields(cfg)
        tr0 = 1e-3 * rng.uniform(-1, 1, (cfg.nl, cfg.nptr, cfg.N, cfg.N))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for where in ("cpu", "cuda"):
            const = qg.build_constants(cfg, device=where, **fields)
            state = qg.init_state(cfg, const, psi0=psi0, tracers0=tr0)
            logs = []
            hooks = driver.RunHooks(
                on_log=lambda *a: logs.append(a),
                on_output=driver.OutputWriter(
                    cfg, const, outdir=os.path.join(tmp, where)))
            before = fused_rhs.launches
            state, energy = driver.run_qg(cfg, const=const, state=state,
                                          hooks=hooks)
            out[where] = (state, energy, logs, fused_rhs.launches - before)
        (cs, ce, clog, cn), (gs, ge, glog, gn) = out["cpu"], out["cuda"]
        rels = {}
        names = ["q", "psi", "qof"] + (["tracers"] if coupled else [])
        pairs = [(n, getattr(gs, n), getattr(cs, n)) for n in names]
        pairs += [(n, getattr(ge, n), getattr(ce, n))
                  for n in qg_energy.FIELDS]
        for name, got, want in pairs:
            scale = want.abs().max().item()
            err = (got.cpu() - want).abs().max().item()
            rels[name] = err / scale if scale else err
        ke_rel = max(abs(g[3] - c[3]) / abs(c[3]) for g, c in zip(glog, clog))
        files = sorted(os.listdir(os.path.join(tmp, "cpu")))
        same_files = files == sorted(os.listdir(os.path.join(tmp, "cuda")))
        bas_rel = 0.0      # the worst file's max|diff| over its max|value|
        for name in (n for n in files if same_files and n.endswith(".bas")):
            got = read_bas(os.path.join(tmp, "cuda", name))[0]
            want = read_bas(os.path.join(tmp, "cpu", name))[0]
            err = np.abs(got.astype(np.float64) - want).max()
            scale = np.abs(want.astype(np.float64)).max()
            bas_rel = max(bas_rel, err / scale if scale else
                          (np.inf if err else 0.0))
    steps = int(gs.i)
    good = (all(r <= STEP_LIMIT for r in rels.values())
            and ke_rel <= STEP_LIMIT and same_files
            and bas_rel <= 2.0 ** -23
            and int(gs.nbar) == int(cs.nbar) == 2 and int(cs.i) == steps
            and len(glog) == len(clog) == steps
            and cn == 0 and gn == 2 * steps)
    print(f"driver check {label} 128^2 x 3 f64, {steps} steps, "
          f"{int(gs.nbar)} filter events, cuda vs cpu: "
          + ", ".join(f"rel {k} = {v:.3e}" for k, v in rels.items())
          + f", KE log {ke_rel:.3e} (limit {STEP_LIMIT:g}); {len(files)} "
          f"files, same names {same_files}, .bas {bas_rel:.3e} of max "
          f"(limit 2^-23); K1 launches cuda {gn} cpu {cn} "
          f"{'ok' if good else 'FAIL'}")
    return good


def driver_path(QGConfig, rows):
    """bench.py's coupled configuration (bench.py:58-74) at 2048^2 x 4 f32
    through driver.run_qg with the filter (dtflt = 0.25, afilt = 10), the
    energy budget (ediag = 0) and an OutputWriter into a temporary
    directory: tend = 0.9 and dtout = 0.5 give about 40 steps with the
    output event at t = 0 and 0.5 and the filter event at 0.25, 0.5 and
    0.75. Prints the driver's ms/step between events (host clock: the loop
    reads t and KE every step, so each step ends synchronised) beside the
    bare make_step loop's (CUDA events, no host read) on the final state,
    energy_tend's and the filter event's ms (CUDA events), the output
    event's seconds (host clock, synchronised), the driver loop's idle
    share (a profile of four steps) and K1 and K2 on the final state
    against their plain versions. Appends their records to `rows`;
    returns False if a check failed."""
    import os
    import shutil
    import tempfile
    import torch
    from msom_tpu_torch import driver
    from msom_tpu_torch.io.bas import read_bas
    from msom_tpu_torch.models import fused_rhs, fused_tracer, qg, qg_energy
    from msom_tpu_torch.ops.wavelet import wavelet_filter_step
    N, nl = 2048, 4
    cfg = dataclasses.replace(
        bench_config(QGConfig, N, nl, "float32", **TRACERS), dtflt=0.25,
        dtout=0.5, tend=0.9, ediag=0).validate()
    t0 = time.perf_counter()
    const = qg.build_constants(cfg, device="cuda", **coupled_fields(cfg))
    rng = np.random.default_rng(0)
    psi0 = 1e-3 * rng.uniform(-1, 1, (nl, N, N))
    tr0 = 1e-3 * rng.uniform(-1, 1, (nl, cfg.nptr, N, N))
    state = qg.init_state(cfg, const, psi0=psi0, tracers0=tr0)
    torch.cuda.synchronize()
    print(f"driver path set-up: {time.perf_counter() - t0:.1f} s "
          f"(sig_lev pyramid of {len(const.sig_lev)} levels)")
    label = f"driver {N}^2 x {nl} f32"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_driver_")
    try:
        # the host clock at each logged step, the steps an event preceded
        # and the output events' steps and seconds
        clock, events, out_steps, out_s = [0.0], set(), [], []
        writer = driver.OutputWriter(cfg, const, outdir=tmp)

        def on_output(st, t):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            writer(st, t)
            out_s.append(time.perf_counter() - t1)
            out_steps.append(int(st.i))
            events.add(int(st.i))

        def on_filter(st, t):
            events.add(int(st.i))

        logs = []

        def on_log(i, dt, t, ke):
            clock.append(time.perf_counter())
            logs.append((i, dt, t, ke))

        # the energy window is flushed through the writer, as run_qg does
        # with a hook that has write_energy
        on_output.write_energy = writer.write_energy
        hooks = driver.RunHooks(on_log=on_log, on_output=on_output,
                                on_filter=on_filter)
        fused_rhs.launches = fused_tracer.launches = 0
        clock[0] = time.perf_counter()
        state, energy = driver.run_qg(cfg, const=const, state=state,
                                      hooks=hooks, max_steps=80)
        n_rhs, n_tr = fused_rhs.launches, fused_tracer.launches
        steps = int(state.i)
        wall = np.diff(clock) * 1e3              # ms of step k = 1..steps
        quiet = [wall[k] for k in range(steps) if k not in events]
        ms_driver = float(np.median(quiet))
        finite = all(bool(torch.isfinite(f).all()) for f in
                     (state.q, state.psi, state.tracers, state.qof,
                      *(getattr(energy, n) for n in qg_energy.FIELDS)))
        # every file there with its blocks
        want_files = {"sig_filt.bas": 1, f"rdpg_{nl}l_N{N}.bas": 1,
                      f"psipg_{nl}l_N{N}.bas": nl,
                      f"frpg_{nl}l_N{N}.bas": nl - 1, f"topo_N{N}.bas": 1}
        for i in out_steps:
            for kind, blocks in (("po", nl), ("qo", nl), ("pf", nl),
                                 ("ptr", nl * cfg.nptr)) + tuple(
                                     (n, nl) for n in qg_energy.FIELDS):
                want_files[f"{kind}{i:09d}.bas"] = blocks
        shapes_ok = True
        for name, blocks in want_files.items():
            path = os.path.join(tmp, name)
            if not os.path.exists(path):
                shapes_ok = False
                print(f"  missing {name}")
                continue
            if os.path.getsize(path) != blocks * (N + 1) ** 2 * 4:
                shapes_ok = False
                print(f"  {name}: {os.path.getsize(path)} bytes")
        if shapes_ok:
            pf = read_bas(os.path.join(tmp, f"pf{out_steps[-1]:09d}.bas"))[0]
            shapes_ok = pf.shape == (nl, N, N) and bool(np.isfinite(pf).all())
        n_out = len(out_s)
        ok = (finite and shapes_ok and n_rhs == 2 * steps
              and n_tr == 2 * steps and n_out == 2 and int(state.nbar) >= 3
              and len(logs) == steps)
        print(f"{label}: {steps} steps to t {state.t.item():.6e}, "
              f"{n_out} output events (files {len(want_files)}, sizes and "
              f"blocks right {shapes_ok}), {int(state.nbar)} filter events, "
              f"fused_rhs launches {n_rhs} (expected {2 * steps}), "
              f"fused_tracer launches {n_tr} (expected {2 * steps}), "
              f"finite {finite}, ke {logs[-1][3]:.6e} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            return False
        # the bare step loop on the same state, no host read a step
        step = qg.make_step(cfg)
        bare, _, _ = timed_steps(step, state, const, 10)
        _, _, ms_bare = timed_steps(step, bare, const, 40)
        del bare
        print(f"{label}: driver {ms_driver:.4f} ms/step (median of "
              f"{len(quiet)} steps between events; mean over all "
              f"{steps} steps {wall.mean():.4f}), bare make_step loop "
              f"{ms_bare:.4f} ms/step: the driver's per-step host reads "
              f"and energy_tend cost {ms_driver - ms_bare:.4f} ms/step")
        psi = state.psi.contiguous()
        dt = torch.tensor(logs[-1][1], device="cuda")
        ms_energy = cuda_ms(lambda: qg_energy.energy_tend(
            cfg, const, energy, psi, dt), 20)
        ms_fde = cuda_ms(lambda: qg_energy.filter_de(
            cfg, const, energy, state.q, state.psi), 10)
        ms_flt = cuda_ms(lambda: wavelet_filter_step(cfg, const, state), 10)
        print(f"{label}: energy_tend {ms_energy:.4f} ms a step, filter "
              f"event {ms_fde + ms_flt:.4f} ms (filter_de {ms_fde:.4f}, "
              f"wavelet_filter_step {ms_flt:.4f}), output event "
              + ", ".join(f"{s:.3f}" for s in out_s) + " s")
        # where the filter event's device time goes (one wavelet_filter_step;
        # filter_de adds the same inversion, pyramid and comp_q again)
        kernel_profile("filter event (wavelet_filter_step)",
                       lambda: wavelet_filter_step(cfg, const, state), 2,
                       ms_flt)
        # the driver loop's idle share: the device time of four steps of
        # run_qg without events against the driver's ms/step between events
        quiet_cfg = dataclasses.replace(cfg, dtflt=-1.0, dtout=1e9,
                                        tend=1e9)
        box = [state]

        def driver_step():
            box[0], _ = driver.run_qg(quiet_cfg, const=const, state=box[0],
                                      max_steps=int(box[0].i) + 1)

        driver_step()
        kernel_profile("driver", driver_step, 4, ms_driver)
        for rec in (
                _kernel_row(label, "fused_rhs",
                            lambda: fused_rhs.rhs_fused(cfg, const, psi)[0],
                            lambda: fused_rhs.rhs_fused_reference(
                                cfg, const, psi)[0],
                            fused_rhs.bound_work(cfg, const, 4), n_rhs,
                            fused_rhs.SOURCE,
                            "msom_tpu/models/pallas_rhs.py:441", "coupled"),
                _kernel_row(label, "fused_tracer",
                            lambda: fused_tracer.tracer_fused(
                                cfg, const, psi, state.tracers),
                            lambda: fused_tracer.tracer_fused_reference(
                                cfg, const, psi, state.tracers),
                            fused_tracer.bound_work(cfg, const, 4), n_tr,
                            fused_tracer.SOURCE,
                            "msom_tpu/models/pallas_rhs.py:778", "walled")):
            if rec is None:
                return False
            rows.append(rec)
        return True
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# the qg-node driver and its events (phase name driver_node)
# ---------------------------------------------------------------------------

# the card-against-CPU runs: 33 steps at 128^2 (dt <= 0.01, bench's beta
# clamp), three vars.nc records, four diag rows, two filter events
NODE_CHECK_EVENTS = dict(dtout=0.125, dtdiag=0.0625, dtflt=0.125, tend=0.25)
# the full-width run: bench's node physics clamps dt to 1.9e-3 at N = 2048
# (the viscous limit of nu = 5 / 32), so these give about 53 steps with
# three vars.nc records (t = 0, 0.04, 0.08), eight diag rows and four
# filter events
NODE_PATH_EVENTS = dict(dtout=0.04, dtdiag=0.01, dtflt=0.02, tend=0.08)
NODE_DRIVER_RUNS = {
    "walled": ({}, False),
    "coastline": (dict(solver="vmg"), True),
    "periodic": (dict(bc_fac=-1.0), False),
    "stochastic (amp_stoch = 0)": (dict(stochastic=True, amp_stoch=0.0,
                                        L_filt_stoch=20.0), False),
}


class _NoOutput:
    """An output that writes nothing, for the driver steps profiled."""

    def write(self, t, **fields):
        pass

    def diag_header(self):
        pass

    def diag_row(self, *values):
        pass

    def close(self):
        pass


def node_driver_check(NodeQGConfig, label, over, masked):
    """driver_node.run_node on the card against the CPU, f64, bench's node
    physics at 128^2 x 3 (TOLERANCE 1e-8) with NODE_CHECK_EVENTS from one
    numpy IC: the final q, psi and psi_f, the diag rows' values and the KE
    log within STEP_LIMIT, every vars.nc record within float32 rounding
    (2^-23 of the file's max|value|), the same record times; K5 launched
    twice a step on the card on a walled grid and never on the CPU, K6
    launched iff the inversion is vmg. Returns False on any difference."""
    import os
    import tempfile
    import torch
    from msom_tpu_torch import driver_node
    from msom_tpu_torch.io.netcdf import read_nc
    from msom_tpu_torch.models import fused_node_rhs, qg_node
    from msom_tpu_torch.solvers import fused_vmg
    cfg = node_config(NodeQGConfig, 128, 3, "float64", TOLERANCE=1e-8,
                      **NODE_CHECK_EVENTS, **over)
    inputs = dict(mask=qg_node.coastline_mask(128)) if masked else {}
    psi0 = node_noise_ic(cfg, 42)
    if cfg.periodic:
        psi0 = psi0[..., :-1, :-1]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for where in ("cpu", "cuda"):
            const = qg_node.build_constants(cfg, device=where, **inputs)
            state = qg_node.init_state(cfg, const, psi0=psi0)
            output = driver_node.NodeOutput(cfg, os.path.join(tmp, where))
            rows, logs = [], []
            write_row = output.diag_row

            def diag_row(*values, rows=rows, write_row=write_row):
                rows.append(values)
                write_row(*values)

            output.diag_row = diag_row
            hooks = driver_node.RunHooks(
                on_log=lambda *a, logs=logs: logs.append(a))
            before = fused_node_rhs.launches, fused_vmg.launches
            state, _ = driver_node.run_node(
                cfg, const=const, state=state, hooks=hooks, output=output,
                restart=None,
                generator=torch.Generator(device=where).manual_seed(3))
            nc = read_nc(os.path.join(tmp, where, "vars.nc"), ["psi", "q"],
                         None)
            out[where] = (state, rows, logs,
                          fused_node_rhs.launches - before[0],
                          fused_vmg.launches - before[1], nc)
    (cs, crow, clog, c5, c6, cnc), (gs, grow, glog, g5, g6, gnc) = \
        out["cpu"], out["cuda"]
    rels = {}
    for name in ("q", "psi", "psi_f"):
        want = getattr(cs, name)
        rels[name] = ((getattr(gs, name).cpu() - want).abs().max()
                      / want.abs().max()).item()
    g, c = np.array(grow), np.array(crow)
    rels["diag"] = max(np.abs(g[:, k] - c[:, k]).max() / np.abs(c[:, k]).max()
                       for k in range(1, 4)) if len(c) else np.inf
    ke_rel = max(abs(a[3] - b[3]) / abs(b[3]) for a, b in zip(glog, clog))
    nc_rel = max(np.abs(gnc[0][n] - cnc[0][n]).max()
                 / np.abs(cnc[0][n]).max() for n in ("psi", "q"))
    steps = int(gs.i)
    walled = not cfg.periodic
    good = (all(r <= STEP_LIMIT for r in rels.values())
            and ke_rel <= STEP_LIMIT and nc_rel <= 2.0 ** -23
            and np.array_equal(gnc[1], cnc[1]) and len(cnc[1]) == 3
            and len(grow) == len(crow) == 4 and int(cs.i) == steps
            and len(glog) == len(clog) == steps
            and int(gs.nbar) == int(cs.nbar) == 1
            and c5 == c6 == 0 and g5 == (2 * steps if walled else 0)
            and (g6 > 0) == masked)
    print(f"driver_node check {label} 128^2 x 3 f64, {steps} steps, "
          f"{len(cnc[1])} records, {len(crow)} diag rows, cuda vs cpu: "
          + ", ".join(f"rel {k} = {v:.3e}" for k, v in rels.items())
          + f", KE log {ke_rel:.3e} (limit {STEP_LIMIT:g}); vars.nc "
          f"{nc_rel:.3e} of max (limit 2^-23); K5/K6 launches cuda "
          f"{g5}/{g6} cpu {c5}/{c6} {'ok' if good else 'FAIL'}")
    return good


def node_noise_check(NodeQGConfig):
    """The card's stochastic draw at the full width (4 x 2049^2, f32, a
    seeded CUDA generator) in distribution: the normalised white field's
    mean and std within four standard errors of a standard normal
    sample's; its high-pass filtered noise (bench's coastline) finite,
    zero off the mask, and its ms (CUDA events)."""
    import torch
    from msom_tpu_torch.models import qg_node
    cfg = node_config(NodeQGConfig, 2048, 4, "float32", solver="vmg",
                      stochastic=True, amp_stoch=1e-6, L_filt_stoch=20.0)
    const = qg_node.build_constants(cfg, mask=qg_node.coastline_mask(2048))
    shape = (4, 2049, 2049)
    gen = torch.Generator(device="cuda").manual_seed(5)
    xi = qg_node.draw_white(cfg, const, gen, shape).double() / cfg.amp_stoch
    m = xi.numel()
    mean, std = xi.mean().item(), xi.std().item()
    noise = qg_node.generate_noise(cfg, const, gen, shape)
    ms = cuda_ms(lambda: qg_node.generate_noise(cfg, const, gen, shape), 5)
    good = (abs(mean) < 4 / np.sqrt(m) and abs(std - 1) < 4 / np.sqrt(2 * m)
            and bool(torch.isfinite(noise).all())
            and not (noise * (1 - const.mask)).any()
            and noise.abs().max().item() > 0)
    print(f"node noise check 4 x 2049^2 f32 on the card: mean {mean:.3e} "
          f"(limit {4 / np.sqrt(m):.3e}), std - 1 {std - 1:.3e} (limit "
          f"{4 / np.sqrt(2 * m):.3e}); generate_noise {ms:.4f} ms "
          f"(12-level high-pass pyramid) {'ok' if good else 'FAIL'}")
    return good


def driver_node_path(NodeQGConfig, rows):
    """bench.py's masked node configuration (bench.py:178-195: the
    coastline, solver="vmg") at 2048^2 x 4 f32 through driver_node.run_node
    as a user runs it, with a NodeOutput into a temporary directory removed
    afterwards, the filter (Lfmax = 30, Lfmin = 10) and NODE_PATH_EVENTS,
    from a numpy-seeded IC. Prints the driver's ms/step between events
    (host clock: the loop reads t every step) beside the bare make_step
    loop's (CUDA events) on the final state, the filter event's ms (CUDA
    events) and its profile, each output event's seconds by record (host
    clock, synchronised), the driver loop's idle share and K5's and K6's
    launches and device ms a step (a profile of four driver steps), and K5
    and K6 on the final state against their plain versions and bounds.
    Appends their records to `rows`; returns False if a check failed."""
    import os
    import shutil
    import tempfile
    import torch
    from msom_tpu_torch import driver_node
    from msom_tpu_torch.io.netcdf import read_nc
    from msom_tpu_torch.models import fused_node_rhs, qg_node
    from msom_tpu_torch.solvers import fused_vmg, vmg
    N, nl = 2048, 4
    cfg = node_config(NodeQGConfig, N, nl, "float32", solver="vmg",
                      **NODE_PATH_EVENTS)
    t0 = time.perf_counter()
    const = qg_node.build_constants(cfg, mask=qg_node.coastline_mask(N))
    state = qg_node.init_state(cfg, const, psi0=node_noise_ic(cfg))
    start = dataclasses.replace(state)
    nlev = len(const.vlevels)
    torch.cuda.synchronize()
    print(f"driver_node path set-up: {time.perf_counter() - t0:.1f} s "
          f"({len(const.vlevels)} vmg levels, filter pyramids of "
          f"{len(const.sig_lev_c)} levels)")
    label = f"driver_node {N}^2 x {nl} f32"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_driver_node_")
    try:
        output = driver_node.NodeOutput(cfg, tmp)
        clock, events, logs, out_s = [0.0], set(), [], []
        write, diag_row = output.write, output.diag_row

        def timed_write(t, **fields):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            write(t, **fields)
            out_s.append(time.perf_counter() - t1)

        def marked_diag_row(*values):
            events.add(len(logs))
            diag_row(*values)

        output.write, output.diag_row = timed_write, marked_diag_row

        def on_log(i, dt, t, ke):
            clock.append(time.perf_counter())
            logs.append((i, dt, t, ke))

        hooks = driver_node.RunHooks(
            on_log=on_log,
            on_output=lambda st, t: events.add(int(st.i)),
            on_filter=lambda st, t: events.add(int(st.i)))
        fused_node_rhs.launches = fused_vmg.launches = 0
        clock[0] = time.perf_counter()
        state, _ = driver_node.run_node(cfg, const=const, state=state,
                                        hooks=hooks, output=output,
                                        restart=None, max_steps=200)
        n_k5, n_k6 = fused_node_rhs.launches, fused_vmg.launches
        steps = int(state.i)
        wall = np.diff(clock) * 1e3
        quiet = [wall[k] for k in range(steps) if k not in events]
        ms_driver = float(np.median(quiet))
        finite = all(bool(torch.isfinite(f).all())
                     for f in (state.q, state.psi, state.psi_f))
        nc, times = read_nc(os.path.join(tmp, "vars.nc"), ["psi"], None)
        diag = open(os.path.join(tmp, "diag_1d.dat")).read().splitlines()
        files_ok = (nc["psi"].shape == (3, nl, N + 1, N + 1)
                    and bool(np.isfinite(nc["psi"]).all())
                    and np.allclose(times, [0.0, 0.04, 0.08])
                    and len(diag) == 9 and diag[0].startswith("#"))
        del nc
        ok = (finite and files_ok and n_k5 == 2 * steps and n_k6 > 0
              and int(state.nbar) == 1 and len(out_s) == 3
              and abs(state.t.item() - cfg.tend) < 1e-6
              and len(logs) == steps and min(l[1] for l in logs) > 0)
        print(f"{label}: {steps} steps to t {state.t.item():.6e} "
              f"(dt {logs[-1][1]:.6e}), {len(out_s)} output events, "
              f"{len(diag) - 1} diag rows, vars.nc records and diag right "
              f"{files_ok}, node_rhs launches {n_k5} (expected {2 * steps}),"
              f" vmg_sweep launches {n_k6} ({n_k6 / steps:.1f} a step), "
              f"finite {finite}, ke {logs[-1][3]:.6e} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            return False
        # the bare make_step loop over the same steps from the same IC (the
        # V-cycles a solve fall from about 9 to 2 over them), and on the
        # final state; the driver stepping on from the final state
        step = qg_node.make_step(cfg)
        n0 = fused_vmg.launches
        _, _, ms_bare_ic = timed_steps(step, start, const, steps)
        cyc_bare = (fused_vmg.launches - n0) / nlev / (2 * steps)
        del start
        bare, _, _ = timed_steps(step, state, const, 5)
        n0 = fused_vmg.launches
        _, _, ms_bare = timed_steps(step, bare, const, 20)
        cyc_final = (fused_vmg.launches - n0) / nlev / 40
        del bare
        quiet_cfg = dataclasses.replace(cfg, dtflt=-1.0, dtdiag=-1.0,
                                        dtout=1e9, tend=1e9)
        box = [state]

        def driver_step():
            box[0], _ = driver_node.run_node(
                quiet_cfg, const=const, state=box[0], output=_NoOutput(),
                restart=None, max_steps=int(box[0].i) + 1)

        driver_step()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(20):
            driver_step()
        torch.cuda.synchronize()
        ms_final = (time.perf_counter() - t1) / 20 * 1e3
        print(f"{label}: driver {ms_driver:.4f} ms/step from the IC (median "
              f"of {len(quiet)} steps between events; mean over all {steps} "
              f"steps {wall.mean():.4f}; {n_k6 / nlev / steps:.2f} V-cycles "
              f"a step with the filter's re-inversions) beside the bare "
              f"make_step loop over the same {steps} steps from the IC "
              f"{ms_bare_ic:.4f} ms/step ({cyc_bare:.2f} V-cycles a "
              f"solve); on the final state: driver {ms_final:.4f} ms/step "
              f"(20 one-step run_node calls, host clock), bare loop "
              f"{ms_bare:.4f} ms/step (20 steps, {cyc_final:.2f} V-cycles "
              f"a solve)")
        ms_flt = cuda_ms(lambda: qg_node.wavelet_filter(cfg, const, state),
                         3)
        print(f"{label}: filter event {ms_flt:.4f} ms (wavelet_filter: a "
              f"vmg re-inversion and the masked {len(const.sig_lev_c)}-level "
              f"pyramid), output "
              f"event by record: " + ", ".join(
                  f"record {k} {s:.3f} s" for k, s in enumerate(out_s))
              + f" ({4 * 2 * nl * (N + 1) ** 2 / 1e6:.1f} MB a record)")
        kernel_profile("driver_node filter event (wavelet_filter)",
                       lambda: qg_node.wavelet_filter(cfg, const, state), 1,
                       ms_flt)
        prof = kernel_profile("driver_node", driver_step, 4, ms_final)
        for kname, key in (("K5 node_rhs", "node_kernel"),
                           ("K6 vmg_sweep", "vrelax_kernel")):
            ms = sum(r[0] for r in prof if key in r[2])
            n = sum(r[1] for r in prof if key in r[2])
            print(f"{label}: {kname} {ms:.4f} device ms a step in "
                  f"{n:.1f} launches a step (driver profile)")
        psi, q = state.psi.contiguous(), state.q.contiguous()
        qf = qg_node.q_forcing_profile(cfg, const.yv[:, 0], state.t)
        lvl = const.vlevels[0]
        res, _ = vmg.residual_v(psi, q, lvl, const.idh0, const.idh1)
        da = fused_vmg.vrb_sweep(torch.zeros_like(res), res, lvl)
        for rec in (
                _kernel_row(label, "node_rhs",
                            lambda: fused_node_rhs.rhs_fused_node(
                                cfg, const, q, psi, qf),
                            lambda: fused_node_rhs.rhs_node_reference(
                                cfg, const, q, psi, qf),
                            fused_node_rhs.bound_work(cfg, const, 4), n_k5,
                            fused_node_rhs.SOURCE,
                            "msom_tpu/models/pallas_node_rhs.py:126",
                            "walled, coastline"),
                _kernel_row(label, "vmg_sweep",
                            lambda: fused_vmg.vrb_relax(da, res, lvl,
                                                        vmg.NRELAX),
                            lambda: fused_vmg.vrb_relax_reference(
                                da, res, lvl, vmg.NRELAX),
                            fused_vmg.bound_work(nl, N + 1, 4, vmg.NRELAX),
                            n_k6, fused_vmg.SOURCE,
                            "msom_tpu/solvers/pallas_vmg.py:105",
                            f"coastline, a relaxation of {vmg.NRELAX} "
                            "sweeps", limit=MG_LIMITS[4])):
            if rec is None:
                return False
            rows.append(rec)
        return True
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# mspg and the PG <-> QG coupling loop (phase names mspg, coupling)
# ---------------------------------------------------------------------------

# bench.py's mspg physics (bench.py:247-249, the reference's params.in);
# the checks' size is tests/test_coupling_workflow.py:30-34's, the path's
# bench's 64^2 x 30 row
PG_PHYSICS = dict(ys=0.3, r=0.02, tau_s=3e-2, tau0=0.12, kv=1e-4, kh=1e-4,
                  omega=0.2, DT=1e-2, CFL=0.4, tend=1e18, dtout=1e18)
PG_CHECK = dict(N=32, nl=8, dtype="float64")
PG_PATH = dict(N=64, nl=30, dtype="float32")
PG_GM = 0.05                       # k_gm of the GM check
COUPLING_IL = [0, 2, 4, 8]         # sigma bands -> 3 QG layers
COUPLING_RE4 = 50.0                # the workflow's Re4 at N = 64
COUPLING_N_QG, COUPLING_STEPS = 2048, 20   # the full-width QG stage


def pg_ic(cfg, seed=9):
    """A numpy-seeded stratified buoyancy with noise, so that the
    convective sweep has unstable pairs to mix."""
    rng = np.random.default_rng(seed)
    return (np.linspace(1.0, 0.0, cfg.nl)[:, None, None]
            + 0.2 * rng.standard_normal((cfg.nl, cfg.N, cfg.N)))


def _rel(got, want):
    """max|got - want| over max|want| (NaN where either holds a NaN)."""
    import torch
    got, want = (np.asarray(a.double().cpu().numpy()
                            if isinstance(a, torch.Tensor) else a,
                            np.float64) for a in (got, want))
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    return err / scale if scale else err


def kernel_counts():
    """The launch counters of the eight kernels' wrappers."""
    from msom_tpu_torch.models import fused_node_rhs, fused_rhs, fused_tracer
    from msom_tpu_torch.solvers import (fused_mg, fused_spectral, fused_vary,
                                        fused_vmg)
    return {"K1": fused_rhs.launches, "K2": fused_tracer.launches,
            "K3": fused_mg.sweep_launches, "K4": fused_mg.residual_launches,
            "K5": fused_node_rhs.launches, "K6": fused_vmg.launches,
            "K7": fused_spectral.launches, "KV": fused_vary.launches}


def reset_counts():
    """Set every wrapper's launch counter to 0."""
    from msom_tpu_torch.models import fused_node_rhs, fused_rhs, fused_tracer
    from msom_tpu_torch.solvers import (fused_mg, fused_spectral, fused_vary,
                                        fused_vmg)
    for mod in (fused_rhs, fused_tracer, fused_node_rhs, fused_vmg,
                fused_spectral, fused_vary):
        mod.launches = 0
    fused_mg.sweep_launches = fused_mg.residual_launches = 0
    fused_mg.sweeps = 0
    fused_mg.sweep_launches_by_n.clear()


def mspg_check(PGConfig, label, over, b_forc=False):
    """build_constants and 20 steps of mspg on the card against the CPU,
    f64, 32^2 x 8, from one numpy stratified IC: psibt and the stepped b,
    ux, uy within STEP_LIMIT, the same bt-solve cycles, dt to 1e-12."""
    import torch
    from msom_tpu_torch.models import mspg
    cfg = PGConfig(**PG_PHYSICS, **PG_CHECK, **over)
    bf = 1e-2 * np.random.default_rng(8).standard_normal(
        (cfg.nl, cfg.N, cfg.N)) if b_forc else None
    out = {}
    for where in ("cpu", "cuda"):
        const = mspg.build_constants(cfg, device=where, b_forc=bf)
        state = mspg.init_state(cfg, const, b0=pg_ic(cfg))
        step = mspg.make_step(cfg)
        dts = []
        for _ in range(20):
            state, diag = step(state, const, 1e18)
            dts.append(diag.dt.item())
        out[where] = (const, state, dts)
    (cc, cs, cdt), (gc, gs, gdt) = out["cpu"], out["cuda"]
    rels = {"psibt": _rel(gc.psibt, cc.psibt)}
    rels.update({n: _rel(getattr(gs, n), getattr(cs, n))
                 for n in ("b", "ux", "uy")})
    dt_rel = max(abs(g - c) / c for g, c in zip(gdt, cdt))
    good = (all(r <= STEP_LIMIT for r in rels.values()) and dt_rel <= 1e-12
            and gc.bt_stats.iters == cc.bt_stats.iters
            and bool(torch.isfinite(gs.b).all()))
    print(f"mspg check {label} {cfg.N}^2 x {cfg.nl} f64, 20 steps, cuda vs "
          f"cpu: " + ", ".join(f"rel {k} = {v:.3e}" for k, v in rels.items())
          + f", dt {dt_rel:.3e} (limit {STEP_LIMIT:g}); bt solve cycles cuda "
          f"{gc.bt_stats.iters} cpu {cc.bt_stats.iters} "
          f"{'ok' if good else 'FAIL'}")
    return good


def run_pg_check(PGConfig):
    """driver.run_pg with a PGOutputWriter on the card against the CPU,
    f64, 32^2 x 8, tend = 0.3, dtout = 0.1 (266 steps at the CFL limit,
    four output events, the means every 10 steps): the final state and means within
    STEP_LIMIT, the same steps and nme, the same files, each .bas within
    float32 rounding."""
    import os
    import tempfile
    from msom_tpu_torch import driver
    from msom_tpu_torch.io.bas import read_bas
    from msom_tpu_torch.models import mspg
    cfg = PGConfig(**{**PG_PHYSICS, **PG_CHECK, "tend": 0.3, "dtout": 0.1})
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for where in ("cpu", "cuda"):
            const = mspg.build_constants(cfg, device=where)
            seen = []
            writer = driver.PGOutputWriter(cfg, const,
                                           outdir=os.path.join(tmp, where))

            def on_output(st, t, writer=writer, seen=seen):
                writer(st, t)
                seen.append(t)

            state = driver.run_pg(
                cfg, const=const, state=mspg.init_state(cfg, const,
                                                        b0=pg_ic(cfg)),
                hooks=driver.RunHooks(on_output=on_output))
            out[where] = (state, seen)
        (cs, cseen), (gs, gseen) = out["cpu"], out["cuda"]
        rels = {n: _rel(getattr(gs, n), getattr(cs, n))
                for n in ("b", "ux", "uy", "b_me", "ux_me", "uy_me")}
        files = sorted(os.listdir(os.path.join(tmp, "cpu")))
        same = files == sorted(os.listdir(os.path.join(tmp, "cuda")))
        bas_rel = 0.0
        for name in (n for n in files if same and n.endswith(".bas")):
            bas_rel = max(bas_rel, _rel(
                read_bas(os.path.join(tmp, "cuda", name))[0],
                read_bas(os.path.join(tmp, "cpu", name))[0]))
    good = (all(r <= STEP_LIMIT for r in rels.values()) and same
            and bas_rel <= 2.0 ** -23 and int(gs.i) == int(cs.i)
            and int(gs.nme) == int(cs.nme) and len(gseen) == len(cseen) == 4
            and len(files) == 9)
    print(f"mspg run_pg check {cfg.N}^2 x {cfg.nl} f64, {int(gs.i)} steps, "
          f"{len(gseen)} output events at t "
          + ", ".join(f"{t:.4f}" for t in gseen) + ", cuda vs cpu: "
          + ", ".join(f"rel {k} = {v:.3e}" for k, v in rels.items())
          + f" (limit {STEP_LIMIT:g}); {len(files)} files, same names "
          f"{same}, .bas {bas_rel:.3e} of max (limit 2^-23) "
          f"{'ok' if good else 'FAIL'}")
    return good


def mspg_path(PGConfig):
    """bench.py's mspg row (measure_mspg, bench.py:243-270): 64^2 x 30 f32
    from rest, the barotropic solve at build (its seconds and cycles),
    bench's 120 spin-up steps, 60 timed with CUDA events, a profile of ten
    steps (device busy, idle share, launches a step), the host's time to
    queue a step; then driver.run_pg with a PGOutputWriter into a
    temporary directory (dtout = 0.05, tend = 0.2: five output events),
    each output event's seconds. mspg runs none of the kernels.
    Returns False if a check failed."""
    import os
    import shutil
    import tempfile
    import torch
    from msom_tpu_torch import driver
    from msom_tpu_torch.models import mspg
    cfg = PGConfig(**PG_PHYSICS, **PG_PATH)
    N, nl = cfg.N, cfg.nl
    label = f"mspg path {N}^2 x {nl} f32"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    const = mspg.build_constants(cfg, device="cuda")
    torch.cuda.synchronize()
    bt_s = time.perf_counter() - t0
    st = const.bt_stats
    print(f"{label}: build_constants with the bt solve {bt_s:.3f} s, "
          f"{st.iters} V-cycles, residual {st.resb:.3e} -> {st.resa:.3e} "
          f"(tol {cfg.tol:g}), final nrelax {st.nrelax}")
    state = mspg.init_state(cfg, const)
    step = mspg.make_step(cfg)
    before = kernel_counts()
    t0 = time.perf_counter()
    for _ in range(120):
        state, _ = step(state, const, 1e18)
    torch.cuda.synchronize()
    spin_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(60):
        state, diag = step(state, const, 1e18)
    end.record()
    torch.cuda.synchronize()
    ms_step = start.elapsed_time(end) / 60
    box = [state]

    def one_step():
        box[0], _ = step(box[0], const, 1e18)

    q_ms = host_ms(one_step, 20)
    rows = kernel_profile("mspg", one_step, 10, ms_step)
    busy = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    state = box[0]
    launched = {k: v - before[k] for k, v in kernel_counts().items()}
    finite = all(bool(torch.isfinite(f).all())
                 for f in (state.b, state.ux, state.uy))
    ok = (finite and not any(launched.values()) and diag.dt.item() > 0
          and st.resa <= cfg.tol)
    print(f"{label}: {ms_step:.4f} ms/step ({N * N * nl / (ms_step * 1e-3):.4e}"
          f" grid-points/s) over 60 steps after 120 spin-up steps "
          f"({spin_s:.2f} s), host queue time {q_ms:.4f} ms/step, device "
          f"busy {busy:.4f} ms/step, idle share {1 - busy / ms_step:.4f}, "
          f"{launches:.1f} launches/step; dt {diag.dt.item():.6e}, t "
          f"{state.t.item():.6e}, max|b| {state.b.abs().max().item():.4e}, "
          f"finite {finite}; kernel launches "
          + ", ".join(f"{k} {v}" for k, v in launched.items())
          + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        return False
    # driver.run_pg from rest with its output events
    ev_cfg = dataclasses.replace(cfg, dtout=0.05, tend=0.2)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mspg_")
    try:
        out_s, out_t = [], []
        writer = driver.PGOutputWriter(ev_cfg, const, outdir=tmp)

        def on_output(st, t):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            writer(st, t)
            out_s.append(time.perf_counter() - t1)
            out_t.append(t)

        t0 = time.perf_counter()
        state = driver.run_pg(ev_cfg, const=const,
                              hooks=driver.RunHooks(on_output=on_output))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        steps = int(state.i)
        sizes = {name: os.path.getsize(os.path.join(tmp, name))
                 for name in os.listdir(tmp)}
        block = (N + 1) ** 2 * 4
        files_ok = sizes.get("psibt.bas") == block and all(
            sizes.get(f"{k}{i:09d}.bas") == n * block
            for i in (0,) for k, n in (("b", nl + 2), ("u", 2 * (nl + 2))))
        ok = (len(out_s) == 5 and files_ok and len(sizes) == 11
              and np.allclose(out_t, [0.0, 0.05, 0.1, 0.15, 0.2], atol=1e-6)
              and bool(torch.isfinite(state.b_me).all()))
        print(f"{label}: run_pg to t {state.t.item():.6e} in {steps} steps, "
              f"{run_s:.2f} s ({run_s / steps * 1e3:.2f} ms/step with the "
              f"events), {len(out_s)} output events at t "
              + ", ".join(f"{t:.4f}" for t in out_t) + ", each "
              + ", ".join(f"{s:.4f}" for s in out_s) + f" s; {len(sizes)} "
              f"files, sizes right {files_ok} {'ok' if ok else 'FAIL'}")
        return ok
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def coupling_loop(PGConfig, QGConfig, device, pg_over, N_qg, qg_dtype,
                  qg_steps, Re4, pg_spinup=150, pg_cont=30):
    """The workflow's five stages (tests/test_coupling_workflow.py) on
    `device`, each fed the one before: mspg spun up from rest; the PG
    state -> msqg inputs (psipg, frpg, rdpg, dh, Rom); msqg (solver="mg",
    the coupling fields, a filter event after every 5th step) and the
    filter mean inverted to pf; the feedback b_forc regridded to the PG
    grid; pg_cont PG steps with and without it. Returns each stage's
    outputs, seconds (host clock, synchronised), the kernels launched in
    the QG stage and the V-cycles of its solves."""
    import torch
    from msom_tpu_torch import coupling
    from msom_tpu_torch.analysis import regrid_bicubic
    from msom_tpu_torch.models import mspg, qg
    from msom_tpu_torch.ops.wavelet import wavelet_filter_step
    from msom_tpu_torch.solvers import mg

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    secs, out = {}, {}
    t0 = time.perf_counter()
    pcfg = PGConfig(**PG_PHYSICS, **pg_over)
    pconst = mspg.build_constants(pcfg, device=device)
    pstep = mspg.make_step(pcfg)
    s1 = mspg.init_state(pcfg, pconst)
    for _ in range(pg_spinup):
        s1, _ = pstep(s1, pconst, 1e18)
    sync()
    secs["1 PG spin-up"] = time.perf_counter() - t0
    out["pg"] = s1

    t0 = time.perf_counter()
    b, ux, uy = (a.double().cpu().numpy() for a in (s1.b, s1.ux, s1.uy))
    u_c = 0.5 * (ux[:, :, :-1] + ux[:, :, 1:])
    v_c = 0.5 * (uy[:, :-1, :] + uy[:, 1:, :])
    inp = coupling.pg_to_qg_inputs(pcfg, b, u_c, v_c, il=COUPLING_IL,
                                   N_qg=N_qg, device=device)
    secs["2 pg_to_qg_inputs"] = time.perf_counter() - t0
    out["inp"] = inp

    t0 = time.perf_counter()
    nl = len(COUPLING_IL) - 1
    qcfg = QGConfig(N=N_qg, nl=nl, L0=1.0, Rom=inp["Rom"], Ekb=0.002,
                    tau0=1e-5, Re4=Re4, beta=0.5, Fr=(0.003,) * (nl - 1),
                    dh=inp["dh"], DT=2e-2, tend=1e18, dtout=1e18, dtflt=0.1,
                    afilt=10.0, Lfmax=0.5, CFL=0.5, solver="mg",
                    dtype=qg_dtype).validate()
    qconst = qg.build_constants(qcfg, device=device, psipg=inp["psipg"],
                                frpg=inp["frpg"], rdpg=inp["rdpg"])
    # the workflow's 1e-3 noise at N = 64, scaled by (64/N)^2 so that the
    # PV noise keeps its size: at 2048^2 its |q| ~ 1e4 would put float32
    # rounding above the multigrid's absolute tolerance 1e-3
    psi0 = 1e-3 * (64 / N_qg) ** 2 * np.random.default_rng(0).uniform(
        -1, 1, (nl, N_qg, N_qg))
    qs = qg.init_state(qcfg, qconst, psi0=psi0)
    qstep = qg.make_step(qcfg)
    sync()
    secs["3a QG set-up"] = time.perf_counter() - t0
    cycles, solve = [], mg.solve_layered

    def counted(*args, **kw):
        res = solve(*args, **kw)
        cycles.append(res[1].iters)
        return res

    before = kernel_counts()
    mg.solve_layered = counted     # the stage's solves, steps and filters
    try:
        t0 = time.perf_counter()
        for k in range(qg_steps):
            qs, diag = qstep(qs, qconst, 1e18)
            if k % 5 == 4:
                qs = wavelet_filter_step(qcfg, qconst, qs)
        sync()
        secs["3b QG steps and filter events"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        pf, _ = qg.invert_q(qcfg, qconst, torch.zeros_like(qs.qof),
                            qs.qof / int(qs.nbar))
        pf = pf.double().cpu().numpy()
        secs["3c pf inversion"] = time.perf_counter() - t0
    finally:
        mg.solve_layered = solve
    out["launched"] = {k: v - before[k] for k, v in kernel_counts().items()}
    out.update(qcfg=qcfg, qconst=qconst, qg=qs, pf=pf, cycles=cycles,
               qdiag=diag)

    t0 = time.perf_counter()
    Fr_prof = np.array([np.median(inp["frpg"][k]) for k in range(nl - 1)])
    bf = coupling.qg_feedback_forcing(pf, np.asarray(inp["dh"]), Fr_prof,
                                      inp["Rom"], pcfg.nl)
    secs["4a qg_feedback_forcing"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bf_coarse = regrid_bicubic(bf, 1.0, pcfg.N)
    secs["4b regrid_bicubic"] = time.perf_counter() - t0
    out.update(bf=bf, bf_coarse=bf_coarse)

    t0 = time.perf_counter()
    amp = 1e-2 / max(np.abs(bf_coarse).max(), 1e-30)
    b_forc = amp * bf_coarse
    forced_const = dataclasses.replace(pconst, b_forc=torch.as_tensor(
        b_forc, dtype=pconst.yc.dtype).to(pconst.yc.device))
    forced = plain = s1
    for _ in range(pg_cont):
        forced, _ = pstep(forced, forced_const, 1e18)
        plain, _ = pstep(plain, pconst, 1e18)
    sync()
    secs["5 PG continuations"] = time.perf_counter() - t0
    out.update(b_forc=b_forc, forced=forced, plain=plain, secs=secs)
    return out


def workflow_checks(out, N_qg, nl_pg):
    """tests/test_coupling_workflow.py's checks (:85-136) on one loop, by
    name, the layer thicknesses summing to the share of the column that
    COUPLING_IL spans (all of it at the workflow's nl = 8, the top 8 of 30
    in README's call); returns ({name: passed}, the response's max|db|
    over the integrated forcing)."""
    import torch
    inp = out["inp"]
    nl = len(COUPLING_IL) - 1
    db = (out["forced"].b - out["plain"].b).double().cpu().numpy()
    elapsed = out["forced"].t.item() - out["pg"].t.item()
    expect = np.abs(out["b_forc"]).max() * elapsed
    ratio = np.abs(db).max() / expect if expect > 0 else np.nan
    checks = {
        "finite": bool(torch.isfinite(out["pg"].b).all()
                       and np.isfinite(inp["psipg"]).all()
                       and np.isfinite(inp["frpg"]).all()
                       and np.isfinite(out["pf"]).all()
                       and np.isfinite(out["bf"]).all()
                       and np.isfinite(db).all()),
        "shapes": (inp["psipg"].shape == inp["frpg"].shape
                   == (nl, N_qg, N_qg) and inp["rdpg"].shape == (N_qg, N_qg)
                   and out["bf"].shape == (nl_pg, N_qg, N_qg)),
        "frpg > 0": bool((inp["frpg"][:-1] > 0).all()),
        "rdpg > 0, median 0.05-50": bool((inp["rdpg"] > 0).all()
                                         and 0.05 < np.median(inp["rdpg"])
                                         < 50.0),
        "dh spans il": abs(sum(inp["dh"]) - COUPLING_IL[-1] / nl_pg) < 1e-12,
        "psipg nonzero": bool(np.abs(inp["psipg"]).max() > 0),
        "nbar > 0": int(out["qg"].nbar) > 0,
        "pf nonzero": bool(np.abs(out["pf"]).max() > 0),
        "b_forc nonzero": bool(np.abs(out["bf"]).max() > 0),
        "response 0.1-50": bool(0.1 < ratio < 50.0),
    }
    return checks, ratio


def coupling_check(PGConfig, QGConfig):
    """The whole loop at the workflow test's sizes (PG 32^2 x 8 -> QG
    64^2 x 3) in f64 on the card against the CPU, stage by stage within
    STEP_LIMIT: the PG state; psipg, frpg, rdpg, dh, Rom; the QG state
    (q, psi, qof, nbar) and pf with the same V-cycles; b_forc; the two
    continuations. The workflow's checks on the card's loop; no kernel
    launched in its QG stage."""
    loops = {where: coupling_loop(PGConfig, QGConfig, where, PG_CHECK, 64,
                                  "float64", 40, COUPLING_RE4)
             for where in ("cpu", "cuda")}
    c, g = loops["cpu"], loops["cuda"]
    rels = {}
    for n in ("b", "ux", "uy"):
        rels[f"1 {n}"] = _rel(getattr(g["pg"], n), getattr(c["pg"], n))
    for n in ("psipg", "frpg", "rdpg"):
        rels[f"2 {n}"] = _rel(g["inp"][n], c["inp"][n])
    rels["2 dh"] = _rel(np.asarray(g["inp"]["dh"]), np.asarray(c["inp"]["dh"]))
    rels["2 Rom"] = abs(g["inp"]["Rom"] - c["inp"]["Rom"]) / c["inp"]["Rom"]
    for n in ("q", "psi", "qof"):
        rels[f"3 {n}"] = _rel(getattr(g["qg"], n), getattr(c["qg"], n))
    rels["3 pf"] = _rel(g["pf"], c["pf"])
    rels["4 b_forc"] = _rel(g["b_forc"], c["b_forc"])
    for run in ("forced", "plain"):
        for n in ("b", "ux", "uy"):
            rels[f"5 {run} {n}"] = _rel(getattr(g[run], n),
                                        getattr(c[run], n))
    flow, ratio = workflow_checks(g, 64, PG_CHECK["nl"])
    flow_ok = all(flow.values())
    good = (all(r <= STEP_LIMIT for r in rels.values())
            and g["cycles"] == c["cycles"]
            and int(g["qg"].nbar) == int(c["qg"].nbar) == 8
            and not g["qconst"].rhs_kernel and flow_ok
            and not any(g["launched"].values()))
    print("coupling check PG 32^2 x 8 -> QG 64^2 x 3 f64, cuda vs cpu: "
          + ", ".join(f"rel {k} = {v:.3e}" for k, v in rels.items())
          + f" (limit {STEP_LIMIT:g}); V-cycles equal "
          f"{g['cycles'] == c['cycles']} ({len(g['cycles'])} solves), nbar "
          f"{int(g['qg'].nbar)}; workflow checks all pass {flow_ok} "
          f"({', '.join(k for k, v in flow.items() if not v) or 'none'} "
          f"failed; response "
          f"{ratio:.3f} of the integrated forcing); QG-stage launches "
          + ", ".join(f"{k} {v}" for k, v in g["launched"].items())
          + f" {'ok' if good else 'FAIL'}")
    return good


def coupling_path(PGConfig, QGConfig):
    """README.md's workflow at full width: PG 64^2 x 30 f32 spun up 150
    steps, pg_to_qg_inputs(il=[0, 2, 4, 8], N_qg=2048), msqg at
    2048^2 x 3 f32 (solver="mg", psipg/frpg/rdpg, the workflow's physics
    with Re4 scaled by (N/64)^3 as bench.py:65 scales it) for 20 steps
    with a filter event every 5, pf, the feedback regridded to 64^2 and
    30 PG steps with and without it. Each stage's seconds, the QG stage's
    ms/step and V-cycles a solve, the workflow's checks and the kernels'
    launches in the QG stage (K1, K3, K4 must stay at 0: a 2-D frpg is no
    mode of theirs). Returns False if a check failed."""
    N_qg, steps = COUPLING_N_QG, COUPLING_STEPS
    out = coupling_loop(PGConfig, QGConfig, "cuda", PG_PATH, N_qg, "float32",
                        steps, COUPLING_RE4 * (N_qg / 64) ** 3)
    secs = out["secs"]
    qconst, cycles = out["qconst"], out["cycles"]
    flow, ratio = workflow_checks(out, N_qg, PG_PATH["nl"])
    # the checks the full-width loop is held to; at 64^2 x 30 the bicubic
    # regrid overshoots below 0 where Fr jumps (the JAX package's
    # coupling gives the same frpg), so "frpg > 0" is reported, not held
    held = ("finite", "shapes", "dh spans il", "nbar > 0", "pf nonzero",
            "b_forc nonzero", "response 0.1-50")
    flow_ok = all(flow[k] for k in held)
    fr = out["inp"]["frpg"][:-1]
    launched = out["launched"]
    ms_qg = secs["3b QG steps and filter events"] / steps * 1e3
    full = all(lv.sw is None for lv in qconst.levels)
    ok = (flow_ok and not qconst.rhs_kernel and full
          and not any(launched.values()) and max(cycles) <= MG_MAX_CYCLES)
    print(f"coupling path PG 64^2 x 30 -> QG {N_qg}^2 x 3 f32: stage seconds "
          + ", ".join(f"{k} {v:.3f}" for k, v in secs.items())
          + f"; QG {steps} steps and {steps // 5} filter events "
          f"{ms_qg:.2f} ms/step with the events, dt "
          f"{out['qdiag'].dt.item():.4e}, V-cycles a solve mean "
          f"{np.mean(cycles):.3f} max {max(cycles)} over {len(cycles)} "
          f"solves; rhs_kernel {qconst.rhs_kernel}, full-field levels "
          f"{full}; QG-stage launches "
          + ", ".join(f"{k} {v}" for k, v in launched.items())
          + f" (K1, K3, K4 must be 0); workflow checks held "
          + ", ".join(f"{k} {flow[k]}" for k in held)
          + "; reported " + ", ".join(f"{k} {v}" for k, v in flow.items()
                                      if k not in held)
          + f" (frpg min {fr.min():.4e}, {int((fr <= 0).sum())} of "
          f"{fr.size} values <= 0); response {ratio:.3f} of the integrated "
          f"forcing, Rom "
          f"{out['inp']['Rom']:.4f}, dh "
          + ", ".join(f"{d:.4f}" for d in out["inp"]["dh"])
          + f") {'ok' if ok else 'FAIL'}")
    return ok


# ---------------------------------------------------------------------------
# varRo and the y-profile direct solve (phase name varro), newqg (newqg)
# and the SQG variant (sqg): KV against its plain version, the steps and
# drivers on the card against the CPU, and the three paths at full width
# ---------------------------------------------------------------------------

# KV's check sizes (N rows, Kx columns, nl): partial column blocks
# (Kx = 100), the paths' width, nl 2-4; N shorter than a stage (1, 3) and
# not a multiple of one (33, 100); Kx * itemsize not a multiple of 16
# bytes (257, 33, 3, 1), which takes the element copies; nl 5-8 at
# N <= 256
KV_SIZES = ([(N, N, nl) for N in (64, 100, 256, 2048) for nl in (2, 3, 4)]
            + [(N, K, nl) for N, K in ((1, 64), (3, 100), (33, 128),
                                       (1, 1), (3, 3), (33, 33), (64, 257))
               for nl in (2, 3, 4)]
            + [(256, 257, 4)]
            + [(N, K, nl) for N, K in ((33, 100), (256, 256), (100, 257))
               for nl in (5, 6, 7, 8)])
KV_LIMITS = {4: 1e-5, 8: 1e-11}          # KV vs plain, of max|psi|
# the f32 vary solve against the f64 solve of the same q at 2048^2 x 4, of
# max|psi|: f32 rounding through the folded transform and 4096 dependent
# rows (about 1e-5 on the CPU at N = 512); a wrong factor or row gives O(1)
VARY_F32_LIMIT = 1e-3
ROUNDS, ROUND_STEPS = 5, 20              # ROADMAP item 5's protocol
# the newqg reference deck (tests/test_newqg_io.py:24-37, N = 64)
NEWQG_DECK = dict(L0=100.0, tau0=1e-3, nu=5.0, beta=0.5, dh=(1.0,), sbc=0.0,
                  DT=5e-2, CFL=0.2, TOLERANCE=1e-5, tend=1e18, dtout=1e18)


def newqg_deck(N, **kw):
    """The newqg deck at N: nu scaled by 64/N as bench's node row scales it
    (bench.py:178-185), and DT with it, which keeps the deck's viscous
    number nu DT / Delta^2 (newqg has no viscous clamp: at 2048 with the
    deck's DT = 5e-2 the run is unstable; on one H100 it read 100 V-cycles
    a solve and ke 3.2e3 after 140 steps)."""
    deck = dict(NEWQG_DECK, N=N, nu=5.0 * 64 / N, DT=5e-2 * 64 / N)
    deck.update(kw)
    return deck
NEWQG_NL2 = dict(nl=2, gp_low=2.0, dh=(0.5, 0.5), hEkb=1e-2, f0=2.0)


def timed_rounds(one_step, rounds=ROUNDS, steps=ROUND_STEPS):
    """`rounds` rounds of `steps` calls of one_step(), each timed with CUDA
    events: (median ms a call, each round's ms)."""
    ms = [cuda_ms(one_step, steps) for _ in range(rounds)]
    return float(np.median(ms)), ms


def rounds_line(ms, med, busy, steps=ROUND_STEPS):
    return (f"{med:.4f} ms/step, the median of {len(ms)} rounds of "
            f"{steps} steps (range {min(ms):.4f}-{max(ms):.4f}: "
            + ", ".join(f"{m:.4f}" for m in ms) + f"), device busy "
            f"{busy:.4f} ms/step, idle share {1 - busy / med:.4f}")


def kv_problem(N, K, nl, dtype, seed=None):
    """(W, X, a) on the card for KV: block inverses W (nl, nl, N, K) drawn
    so that the chain is stable (|a W| row sums 1/2, as the real factors'
    are at most), a standard normal X (nl, N, K)."""
    import torch
    tdt = getattr(torch, dtype)
    if seed is None:   # the square cases keep their earlier seeds
        seed = N + nl if K == N else (N, K, nl)
    rng = np.random.default_rng(seed)
    a = (N / 80.0) ** 2
    W = torch.as_tensor(rng.uniform(-0.5, 0.5, (nl, nl, N, K)) / (a * nl),
                        dtype=tdt).cuda()
    X = torch.as_tensor(rng.standard_normal((nl, N, K)), dtype=tdt).cuda()
    return W, X, a


def kv_checks():
    """KV against its plain version on the card, f64 and f32, at each
    (N, Kx, nl) of KV_SIZES (kv_problem's inputs), with its geometry;
    returns (ok, max abs error at 2048 x 4 f32)."""
    import torch
    from msom_tpu_torch.solvers import fused_vary
    ok, main_err = True, None
    for dtype in ("float64", "float32"):
        lim = KV_LIMITS[8 if dtype == "float64" else 4]
        for N, K, nl in KV_SIZES:
            W, X, a = kv_problem(N, K, nl, dtype)
            g = fused_vary.geometry(nl, N, K, X.element_size())
            n0 = fused_vary.launches
            k = fused_vary.sweep(W, X, a)
            n1 = fused_vary.launches
            p = fused_vary.sweep_reference(W, X, a)
            torch.cuda.synchronize()
            err = (k - p).abs().max().item()
            rel = err / p.abs().max().item()
            good = (rel <= lim and n1 - n0 == 1 and k.shape == X.shape
                    and bool(torch.isfinite(k).all()))
            ok &= good
            print(f"KV check {dtype} N={N} Kx={K} nl={nl} ({g.rows} rows x "
                  f"{g.stages} stages, {'TMA' if g.tma else 'copies'}): "
                  f"max|d psi|/max|psi| = {rel:.3e} (limit {lim:g}), "
                  f"launches {n1 - n0} {'ok' if good else 'FAIL'}")
            if dtype == "float32" and (N, K, nl) == (2048, 2048, 4):
                main_err = err
            del W, X, k, p
        torch.cuda.empty_cache()
    return ok, main_err


def vary_s_prof(cfg):
    """The varRo strl y-profile (nl-1, N) of a config, as build_constants
    forms it (msqg/qg.h:1032-1048)."""
    y = (np.arange(cfg.N) + 0.5) * cfg.delta
    Ro = cfg.Rom / (1.0 + cfg.Rom * cfg.beta * (y - 0.5 * cfg.L0))
    return (np.asarray(cfg.Fr[:cfg.nl - 1])[:, None] / Ro[None, :]) ** 2


def vary_solve_check(QGConfig):
    """One y-profile direct solve on the card against the CPU, f64,
    128^2 x 3 (the Verron physics with varRo): psi within STEP_LIMIT, one
    KV launch on the card, none on the CPU."""
    import torch
    from msom_tpu_torch.ops.stretch import layer_metrics
    from msom_tpu_torch.solvers import fused_vary, vary
    cfg = verron(QGConfig, 128, varRo=1)
    _, idh0, idh1 = layer_metrics(np.asarray(cfg.dh[:cfg.nl]))
    q = np.random.default_rng(5).standard_normal((cfg.nl, cfg.N, cfg.N))
    out, launched = {}, {}
    for where in ("cpu", "cuda"):
        data = vary.build_spectral_vary(
            nl=cfg.nl, N=cfg.N, L0=cfg.L0, s_prof=vary_s_prof(cfg),
            idh0=idh0, idh1=idh1, dtype=torch.float64, device=where)
        n0 = fused_vary.launches
        out[where] = vary.solve_spectral_vary(
            data, torch.as_tensor(q).to(where)).cpu()
        launched[where] = fused_vary.launches - n0
    rel = _rel(out["cuda"], out["cpu"])
    good = rel <= STEP_LIMIT and launched == {"cpu": 0, "cuda": 1}
    print(f"vary solve check 128^2 x 3 f64 cuda vs cpu: rel psi = {rel:.3e} "
          f"(limit {STEP_LIMIT:g}), KV launches {launched} "
          f"{'ok' if good else 'FAIL'}")
    return good


def varro_checks(QGConfig):
    """The varRo step and an x-constant frpg on the card against the CPU,
    f64, 128^2 x 3, 20 steps (step_check): spectral (KV twice a step on
    the card), mg (the same V-cycles every step, K3/K4 on the card), and
    a frpg varying in y only with spectral."""
    from msom_tpu_torch.solvers import fused_vary
    y = (np.arange(128) + 0.5) / 128
    frpg = np.stack([0.0023669 * (1 + 0.4 * y), 0.0076173 * (1 - 0.3 * y)])
    frpg = np.broadcast_to(frpg[:, :, None], (2, 128, 128)).copy()
    ok = True
    for label, cfg, fields in (
            ("varRo spectral", verron(QGConfig, 128, varRo=1), None),
            ("varRo mg", verron(QGConfig, 128, varRo=1, solver="mg"), None),
            ("frpg (y only) spectral", verron(QGConfig, 128),
             dict(frpg=frpg))):
        n0 = fused_vary.launches
        good = step_check(QGConfig, label, cfg, fields=fields)
        n_kv = fused_vary.launches - n0
        want = 40 if cfg.solver == "spectral" else 0
        print(f"  {label}: KV launches {n_kv} (expected {want})")
        ok &= good and n_kv == want
    return ok


def varro_path(QGConfig, rows, kv_err):
    """tools/vary_bench.py's configuration (bench's 4-layer Verron variant
    with varRo, tol 1e-3) at 2048^2 x 4 f32: solver="spectral" (the fold,
    KV, K1) and solver="mg" (K1, K3, K4), 20 warm-up steps, then
    timed_rounds with the kernels' launches counted; on the spectral path
    KV and K1 alone on the final state against their plain versions and
    bounds, and the f32 solve against the f64 solve of the same q; a
    four-step profile of each. Appends the records to `rows`."""
    import torch
    from msom_tpu_torch.models import fused_rhs, qg
    from msom_tpu_torch.solvers import ctdst, fused_mg, fused_vary, vary
    N, nl, warm = 2048, 4, 20
    shape = (nl, N, N)
    for solver in ("spectral", "mg"):
        label = f"varro {solver}"
        cfg = bench_config(QGConfig, N, nl, "float32", solver=solver,
                           varRo=1, tol=1e-3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        const = qg.build_constants(cfg, device="cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        psi0 = 1e-3 * np.random.default_rng(0).uniform(-1, 1, shape)
        state = qg.init_state(cfg, const, psi0=psi0)
        step = qg.make_step(cfg)
        spec = const.spec
        print(f"{label} path set-up: {build_s:.2f} s"
              + (" (the host's f64 block-Thomas factors and their copy to "
                 "the card)" if spec is not None else "")
              + f", Ro {const.Ro.min().item():.4f}-"
              f"{const.Ro.max().item():.4f}, inversion "
              f"{type(spec).__name__ if spec is not None else 'multigrid'}"
              + (f" with the fold {spec.fac is not None}"
                 if spec is not None else
                 f", profiles on every level "
                 f"{all(lv.sw is not None for lv in const.levels)}"))
        for _ in range(warm):
            state, diag = step(state, const, 1e18)
        torch.cuda.synchronize()
        box, cycles = [state, diag], []

        def one_step():
            n0 = fused_mg.residual_launches
            box[0], box[1] = step(box[0], const, 1e18)
            if solver == "mg":
                # a solve launches K4 once for its first residual and once
                # a cycle
                both = fused_mg.residual_launches - n0 - 2
                cycles.extend([box[1].mg_iters, both - box[1].mg_iters])

        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        med, ms = timed_rounds(one_step)
        launched = kernel_counts()
        state, diag = box
        steps = ROUNDS * ROUND_STEPS
        finite = state_ok(state, diag, shape)
        prof = kernel_profile(label, one_step, 4, med)
        busy = sum(r[0] for r in prof)
        want = {"K1": 2 * steps,
                "KV": 2 * steps if solver == "spectral" else 0}
        ok = (finite and all(launched[k] == v for k, v in want.items())
              and all(launched[k] == 0 for k in ("K2", "K5", "K6", "K7"))
              and ((launched["K3"] > 0 and launched["K4"] > 0)
                   == (solver == "mg")))
        extra = ""
        if solver == "mg":
            ok &= min(cycles) >= 1 and max(cycles) <= MG_MAX_CYCLES
            extra = (f", V-cycles a solve mean {np.mean(cycles):.4f} max "
                     f"{max(cycles)} min {min(cycles)}")
        print(f"{label} path {N}^2 x {nl} f32 after {warm} warm-up steps: "
              + rounds_line(ms, med, busy) + ", kernel launches "
              + ", ".join(f"{k} {v}" for k, v in launched.items())
              + f" over {steps} steps{extra}, ke {diag.ke.item():.6e}, dt "
              f"{diag.dt.item():.6e}, t {state.t.item():.6e}, finite "
              f"{finite}, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            return False
        if solver == "mg":
            for row in mg_rows(label, const.levels[0], state, const.idh0,
                               const.idh1, launched["K3"], launched["K4"]):
                if row is None:
                    return False
                rows.append(row)
        psi, q = state.psi.contiguous(), state.q.contiguous()
        if solver == "spectral":
            X = (ctdst.fdst_x(spec.fac, q) if spec.fac is not None
                 else torch.matmul(q, spec.S.T)).contiguous()
            row = _kernel_row(
                label, "vary_sweep",
                lambda: fused_vary.sweep(spec.W, X, spec.a),
                lambda: fused_vary.sweep_reference(spec.W, X, spec.a),
                fused_vary.bound_work(nl, N, N, 4), launched["KV"],
                fused_vary.SOURCE, "msom_tpu/solvers/vary.py:270",
                "block-Thomas y-sweeps, forward and backward",
                limit=KV_LIMITS[4], n_plain=2)
            if row is None:
                return False
            row["max_abs_err"] = max(row["max_abs_err"], kv_err)
            rows.append(row)
            row = _kernel_row(
                label, "fused_rhs", lambda: fused_rhs.rhs_fused(cfg, const,
                                                                psi)[0],
                lambda: fused_rhs.rhs_fused_reference(cfg, const, psi)[0],
                fused_rhs.bound_work(cfg, const, 4), launched["K1"],
                fused_rhs.SOURCE, "msom_tpu/models/pallas_rhs.py:441",
                "varRo: y-profile strl")
            if row is None:
                return False
            rows.append(row)
            # the f32 solve against the f64 solve of the same q
            t0 = time.perf_counter()
            spec64 = vary.build_spectral_vary(
                nl=nl, N=N, L0=cfg.L0, s_prof=const.strl[..., 0].double()
                .cpu().numpy(), idh0=const.idh0, idh1=const.idh1,
                dtype=torch.float64, device="cuda")
            psi64 = vary.solve_spectral_vary(spec64, q.double())
            psi32 = vary.solve_spectral_vary(spec, q)
            rel = _rel(psi32, psi64)
            good = rel <= VARY_F32_LIMIT
            print(f"{label}: the f32 solve against the f64 solve of the final "
                  f"q: max|d psi|/max|psi| = {rel:.3e} (limit "
                  f"{VARY_F32_LIMIT:g}; the f64 build and solve "
                  f"{time.perf_counter() - t0:.2f} s) "
                  f"{'ok' if good else 'FAIL'}")
            if not good:
                return False
            del spec64, psi64, psi32, X
        del const, state, psi, q, box
        torch.cuda.empty_cache()
    return True


def newqg_step_check(NewQGConfig, label, cfg):
    """The newqg step on the card against the CPU, f64, 20 steps from one
    numpy psi: q and psi within STEP_LIMIT, the same V-cycles every step;
    K3/K4 on the card iff the multigrid runs with walls."""
    import torch
    from msom_tpu_torch.models import newqg
    from msom_tpu_torch.solvers import fused_mg
    rng = np.random.default_rng(11)
    psi0 = 1e-2 * rng.uniform(-1, 1, (cfg.nl, cfg.N, cfg.N))
    states, cycles, launched = {}, {}, {}
    for where in ("cpu", "cuda"):
        _, lam = newqg.build_levels(cfg, where)
        state = newqg.init_state(cfg, lam, psi0=psi0, device=where)
        step = newqg.make_step(cfg, device=where)
        before = fused_mg.sweep_launches, fused_mg.residual_launches
        cycles[where] = []
        for _ in range(20):
            state, diag = step(state, 1e9)
            cycles[where].append(diag.mg_iters)
        states[where] = state
        launched[where] = (fused_mg.sweep_launches - before[0],
                           fused_mg.residual_launches - before[1])
    rels = {n: _rel(getattr(states["cuda"], n), getattr(states["cpu"], n))
            for n in ("q", "psi")}
    kernels = cfg.solver == "mg" and cfg.sbc != -1
    good = (all(r <= STEP_LIMIT for r in rels.values())
            and cycles["cuda"] == cycles["cpu"] and launched["cpu"] == (0, 0)
            and (min(launched["cuda"]) > 0) == kernels
            and (max(launched["cuda"]) == 0) == (not kernels)
            and (min(cycles["cuda"]) >= 1) == (cfg.solver == "mg"))
    print(f"newqg step check {label} {cfg.N}^2 x {cfg.nl} f64, 20 steps cuda "
          f"vs cpu: "
          + ", ".join(f"rel {k} = {v:.3e}" for k, v in rels.items())
          + f" (limit {STEP_LIMIT:g}), V-cycles of the first solve cuda "
          f"{cycles['cuda']} cpu {cycles['cpu']}, K3/K4 launches "
          f"{launched['cuda']} {'ok' if good else 'FAIL'}")
    return good


def newqg_checks(NewQGConfig):
    """newqg_step_check for nl = 1 and nl = 2 with gp_low, each with mg
    and spectral, walled and periodic (no wind: the pulse's mean has no
    periodic solution), with the reference deck at 128^2 (newqg_deck,
    TOLERANCE 1e-8)."""
    ok = True
    for nl_kw in ({}, NEWQG_NL2):
        for solver in ("mg", "spectral"):
            for per in (False, True):
                kw = newqg_deck(128, TOLERANCE=1e-8, dtype="float64",
                                solver=solver, **nl_kw)
                if per:
                    kw.update(sbc=-1.0, tau0=0.0)
                cfg = NewQGConfig(**kw)
                label = (f"nl={cfg.nl} {solver} "
                         f"{'periodic' if per else 'walled'}")
                ok &= newqg_step_check(NewQGConfig, label, cfg)
    return ok


def _nc_agree(tmp, names):
    """(max record difference over max|value| of the CPU's file, the same
    record times) between the cpu/ and cuda/ vars.nc under `tmp`."""
    import os
    from msom_tpu_torch.io.netcdf import read_nc
    nc = {w: read_nc(os.path.join(tmp, w, "vars.nc"), names, None)
          for w in ("cpu", "cuda")}
    rel = max(np.abs(nc["cuda"][0][n] - nc["cpu"][0][n]).max()
              / np.abs(nc["cpu"][0][n]).max() for n in names)
    return rel, np.array_equal(nc["cuda"][1], nc["cpu"][1]), nc["cpu"][1]


def run_newqg_check(NewQGConfig):
    """driver_node.run_newqg on the card against the CPU, f64, 128^2 x 2
    with gp_low (mg), from one numpy psi to tend = 0.5 with dtout = 0.25:
    the final q and psi within STEP_LIMIT, the three vars.nc records within
    float32 rounding at the same times."""
    import tempfile
    from msom_tpu_torch import driver_node
    from msom_tpu_torch.models import newqg
    cfg = NewQGConfig(**newqg_deck(128, TOLERANCE=1e-8, dtype="float64",
                                   tend=0.5, dtout=0.25, **NEWQG_NL2))
    psi0 = 1e-2 * np.random.default_rng(12).uniform(-1, 1, (2, 128, 128))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for where in ("cpu", "cuda"):
            _, lam = newqg.build_levels(cfg, where)
            state = newqg.init_state(cfg, lam, psi0=psi0, device=where)
            out[where], _ = driver_node.run_newqg(
                cfg, lam=lam, state=state, restart=None,
                outdir=f"{tmp}/{where}")
        nc_rel, same_t, times = _nc_agree(tmp, ["psi", "q"])
    rels = {n: _rel(getattr(out["cuda"], n), getattr(out["cpu"], n))
            for n in ("q", "psi")}
    good = (all(r <= STEP_LIMIT for r in rels.values())
            and nc_rel <= 2.0 ** -23 and same_t and len(times) == 3
            and int(out["cuda"].i) == int(out["cpu"].i))
    print(f"run_newqg check 128^2 x 2 f64, {int(out['cpu'].i)} steps, "
          f"records at t {list(times)}, cuda vs cpu: "
          + ", ".join(f"rel {k} = {v:.3e}" for k, v in rels.items())
          + f"; vars.nc {nc_rel:.3e} of max (limit 2^-23) "
          f"{'ok' if good else 'FAIL'}")
    return good


def newqg_path(NewQGConfig, rows):
    """The newqg reference deck (tests/test_newqg_io.py:24-37) at
    2048^2 x 1 f32, nu and DT scaled by 64/N (newqg_deck), from a numpy
    noise psi: solver="mg" (K3, K4) and
    "spectral" (the fold, no kernel), 20 warm-up steps, timed_rounds with
    the launches and the V-cycles a solve counted, K3 and K4 alone on the
    mg path's final state (K4 with b = 0), a four-step profile of each. Appends the
    records to `rows`."""
    import torch
    from msom_tpu_torch.models import newqg
    from msom_tpu_torch.solvers import fused_mg
    N, nl, warm = 2048, 1, 20
    for solver in ("mg", "spectral"):
        label = f"newqg {solver}"
        cfg = NewQGConfig(**newqg_deck(N, dtype="float32", solver=solver))
        levels, lam = newqg.build_levels(cfg, "cuda")
        psi0 = 1e-3 * np.random.default_rng(0).uniform(-1, 1, (nl, N, N))
        state = newqg.init_state(cfg, lam, psi0=psi0, device="cuda")
        step = newqg.make_step(cfg, device="cuda")
        for _ in range(warm):
            state, diag = step(state, 1e18)
        torch.cuda.synchronize()
        box, cycles = [state, diag], []

        def one_step():
            n0 = fused_mg.residual_launches
            box[0], box[1] = step(box[0], 1e18)
            if solver == "mg":
                both = fused_mg.residual_launches - n0 - 2
                cycles.extend([box[1].mg_iters, both - box[1].mg_iters])

        reset_counts()
        med, ms = timed_rounds(one_step)
        launched = kernel_counts()
        state, diag = box
        prof = kernel_profile(label, one_step, 4, med)
        busy = sum(r[0] for r in prof)
        finite = (bool(torch.isfinite(state.q).all())
                  and bool(torch.isfinite(state.psi).all())
                  and np.isfinite(diag.ke.item()) and diag.dt.item() > 0)
        mg = solver == "mg"
        ok = (finite and all(v == 0 for k, v in launched.items()
                             if k not in ("K3", "K4"))
              and (launched["K3"] > 0 and launched["K4"] > 0) == mg
              and (launched["K3"] == launched["K4"] == 0) == (not mg))
        extra = ""
        if mg:
            ok &= min(cycles) >= 1 and max(cycles) <= MG_MAX_CYCLES
            extra = (f", V-cycles a solve mean {np.mean(cycles):.4f} max "
                     f"{max(cycles)} min {min(cycles)}")
        print(f"{label} path {N}^2 x {nl} f32 after {warm} warm-up steps: "
              + rounds_line(ms, med, busy) + ", kernel launches "
              + ", ".join(f"{k} {v}" for k, v in launched.items())
              + f" over {ROUNDS * ROUND_STEPS} steps{extra}, ke "
              f"{diag.ke.item():.6e}, dt {diag.dt.item():.6e}, t "
              f"{state.t.item():.6e}, finite {finite} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            return False
        if mg:
            for row in mg_rows(label, levels[0], state, np.zeros(1),
                               np.zeros(1), launched["K3"], launched["K4"],
                               b_zero=True):
                if row is None:
                    return False
                rows.append(row)
        del state, box, levels, lam
        torch.cuda.empty_cache()
    return True


def sqg_config(NodeQGConfig, N, nl, dtype, **kw):
    """bench's measure_node physics (bench.py:178-185) for the SQG variant:
    N2 at the surface and the nl-1 interfaces, no filter."""
    return node_config(NodeQGConfig, N, nl, dtype, N2=(1.0,) * nl,
                       dtflt=-1.0, **kw)


def sqg_ic(cfg, seed=0):
    """(psi0, bs0): node_noise_ic's psi, and noise_init uniform noise for
    bs, zero on the walls."""
    psi0 = node_noise_ic(cfg, seed)
    M = cfg.N + 1
    bs0 = cfg.noise_init * np.random.default_rng(seed + 1).uniform(
        -1, 1, (M, M))
    bs0[0] = bs0[-1] = bs0[:, 0] = bs0[:, -1] = 0.0
    return psi0, bs0


def sqg_step_check(NodeQGConfig):
    """The SQG step on the card against the CPU, f64, 128^2 x 3, 20 steps
    from one numpy psi and bs (TOLERANCE 1e-8): q, bs and psi within
    STEP_LIMIT, the same V-cycles every step; K6 on the card only, K5
    never (SQG's rhs_pv is torch ops in both packages)."""
    from msom_tpu_torch.models import fused_node_rhs, sqg
    from msom_tpu_torch.solvers import fused_vmg
    cfg = sqg_config(NodeQGConfig, 128, 3, "float64", TOLERANCE=1e-8)
    psi0, bs0 = sqg_ic(cfg, 42)
    states, cycles, launched = {}, {}, {}
    for where in ("cpu", "cuda"):
        const = sqg.build_constants(cfg, device=where)
        state = sqg.init_state(cfg, const, psi0=psi0, bs0=bs0)
        step = sqg.make_step(cfg)
        before = fused_vmg.launches, fused_node_rhs.launches
        cycles[where] = []
        for _ in range(20):
            state, diag = step(state, const, 1e9)
            cycles[where].append(diag.mg_iters)
        states[where] = state
        launched[where] = (fused_vmg.launches - before[0],
                           fused_node_rhs.launches - before[1])
    rels = {n: _rel(getattr(states["cuda"], n), getattr(states["cpu"], n))
            for n in ("q", "bs", "psi")}
    good = (all(r <= STEP_LIMIT for r in rels.values())
            and cycles["cuda"] == cycles["cpu"] and min(cycles["cuda"]) >= 1
            and launched["cpu"] == (0, 0) and launched["cuda"][0] > 0
            and launched["cuda"][1] == 0)
    print(f"sqg step check 128^2 x 3 f64, 20 steps cuda vs cpu: "
          + ", ".join(f"rel {k} = {v:.3e}" for k, v in rels.items())
          + f" (limit {STEP_LIMIT:g}), V-cycles of the first solve cuda "
          f"{cycles['cuda']} cpu {cycles['cpu']}, K6/K5 launches "
          f"{launched['cuda']} {'ok' if good else 'FAIL'}")
    return good


def run_sqg_check(NodeQGConfig):
    """driver_node.run_sqg on the card against the CPU, f64, 128^2 x 3,
    from one numpy psi and bs to tend = 0.25 with dtout = 0.125, then
    both from the CPU run's vars.nc as restart.nc to tend = 0.375: the
    final q, bs and psi within STEP_LIMIT, every vars.nc record (psi, q,
    bs) within float32 rounding at the same times."""
    import os
    import shutil
    import tempfile
    from msom_tpu_torch import driver_node
    from msom_tpu_torch.models import sqg
    cfg = sqg_config(NodeQGConfig, 128, 3, "float64", TOLERANCE=1e-8,
                     dtout=0.125, tend=0.25)
    cfg2 = dataclasses.replace(cfg, tend=0.375)
    psi0, bs0 = sqg_ic(cfg, 43)
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        for leg, c in (("run", cfg), ("restart", cfg2)):
            out = {}
            rp = os.path.join(tmp, "restart.nc")
            for where in ("cpu", "cuda"):
                const = sqg.build_constants(c, device=where)
                state = None if leg == "restart" else sqg.init_state(
                    c, const, psi0=psi0, bs0=bs0)
                out[where], _ = driver_node.run_sqg(
                    c, const=const, state=state,
                    restart=rp if leg == "restart" else None,
                    outdir=os.path.join(tmp, leg, where))
            nc_rel, same_t, times = _nc_agree(os.path.join(tmp, leg),
                                              ["psi", "q", "bs"])
            if leg == "run":
                shutil.copy(os.path.join(tmp, leg, "cpu", "vars.nc"), rp)
            rels = {n: _rel(getattr(out["cuda"], n), getattr(out["cpu"], n))
                    for n in ("q", "bs", "psi")}
            good = (all(r <= STEP_LIMIT for r in rels.values())
                    and nc_rel <= 2.0 ** -23 and same_t and len(times) >= 2
                    and abs(out["cuda"].t.item() - c.tend) < 1e-12)
            ok &= good
            print(f"run_sqg check ({leg}) 128^2 x 3 f64, to t "
                  f"{out['cuda'].t.item():.4f}, records at t {list(times)}, "
                  f"cuda vs cpu: "
                  + ", ".join(f"rel {k} = {v:.3e}" for k, v in rels.items())
                  + f"; vars.nc {nc_rel:.3e} of max (limit 2^-23) "
                  f"{'ok' if good else 'FAIL'}")
    return ok


def sqg_path(NodeQGConfig, rows):
    """bench's measure_node physics for SQG at 2048^2 x 4 f32 (N2 at the
    surface and three interfaces, the default walled mask, numpy psi and
    bs): 40 spin-up steps, timed_rounds with K6's launches and the
    V-cycles a solve counted, bs2 printed, K6 alone on the final state
    against its plain version and bound, a four-step profile. Appends K6's
    record to `rows`."""
    import torch
    from msom_tpu_torch.models import sqg
    from msom_tpu_torch.solvers import fused_vmg, vmg
    N, nl, warm = 2048, 4, 40
    cfg = sqg_config(NodeQGConfig, N, nl, "float32")
    t0 = time.perf_counter()
    const = sqg.build_constants(cfg, device="cuda")
    psi0, bs0 = sqg_ic(cfg)
    state = sqg.init_state(cfg, const, psi0=psi0, bs0=bs0)
    step = sqg.make_step(cfg)
    torch.cuda.synchronize()
    nlev = len(const.vlevels)
    print(f"sqg path set-up: {time.perf_counter() - t0:.1f} s, vmg "
          f"{nlev} levels, dt clamp {cfg.dt_clamped():.4e}")
    spin = []
    for _ in range(warm):
        state, diag = step(state, const, 1e18)
        spin.append(diag.mg_iters)
    torch.cuda.synchronize()
    box, cycles = [state, diag], []

    def one_step():
        n0 = fused_vmg.launches
        box[0], box[1] = step(box[0], const, 1e18)
        # a relaxation is one K6 launch a level and cycle
        both = (fused_vmg.launches - n0) // nlev
        cycles.extend([box[1].mg_iters, both - box[1].mg_iters])

    reset_counts()
    med, ms = timed_rounds(one_step)
    launched = kernel_counts()
    state, diag = box
    prof = kernel_profile("sqg", one_step, 4, med)
    busy = sum(r[0] for r in prof)
    finite = all(bool(torch.isfinite(f).all())
                 for f in (state.q, state.psi, state.bs)) \
        and diag.dt.item() > 0
    ok = (finite and launched["K6"] > 0
          and all(v == 0 for k, v in launched.items() if k != "K6")
          and min(cycles) >= 1 and max(cycles) <= 99)
    print(f"sqg path {N}^2 x {nl} f32 after {warm} spin-up steps (V-cycles "
          f"of the first solve: first ten {spin[:10]}, last ten "
          f"{spin[-10:]}): " + rounds_line(ms, med, busy)
          + ", kernel launches "
          + ", ".join(f"{k} {v}" for k, v in launched.items())
          + f" over {ROUNDS * ROUND_STEPS} steps "
          f"({launched['K6'] / (ROUNDS * ROUND_STEPS):.1f} a step), V-cycles "
          f"a solve mean {np.mean(cycles):.4f} max {max(cycles)} min "
          f"{min(cycles)}, bs2 {diag.bs2.item():.6e}, ke "
          f"{diag.ke.item():.6e}, dt {diag.dt.item():.6e}, t "
          f"{state.t.item():.6e}, finite {finite} {'ok' if ok else 'FAIL'}")
    if not ok:
        return False
    lvl = const.vlevels[0]
    psi = state.psi.contiguous()
    rhs = (state.q - sqg.bs_source(cfg, const, state.bs)).contiguous()
    res, _ = vmg.residual_v(psi, rhs, lvl, (0.0,) + const.idh0[1:],
                            const.idh1)
    da = fused_vmg.vrb_sweep(torch.zeros_like(res), res, lvl)
    row = _kernel_row(
        "sqg", "vmg_sweep",
        lambda: fused_vmg.vrb_relax(da, res, lvl, vmg.NRELAX),
        lambda: fused_vmg.vrb_relax_reference(da, res, lvl, vmg.NRELAX),
        fused_vmg.bound_work(nl, N + 1, 4, vmg.NRELAX), launched["K6"],
        fused_vmg.SOURCE, "msom_tpu/solvers/pallas_vmg.py:105",
        f"a relaxation of {vmg.NRELAX} sweeps, SQG interface metrics",
        limit=MG_LIMITS[4])
    if row is None:
        return False
    rows.append(row)
    return True


ROWS_SHARDS = 4                          # virtual shards of the checks
# the rows kernels are their own build of the same source; where the two
# builds contract a multiply-add differently (one FFMA of the f32 coupled
# periodic kernel with a run-time nl, on one H100), the shards put together
# differ from the whole-domain launch by an ulp: within ROWS_ULPS units in
# the last place of max|out| there, bit for bit everywhere else
ROWS_ULPS = 4
# the rows kernels' check sizes: nl = 1, 3, 4 at 256 (shards of 64 rows),
# N = 160 (shards of 40: a 32-row strip and an 8-row one) and the path's
ROWS_SIZES = [(256, 1), (256, 3), (256, 4), (160, 3), (2048, 4)]
# one f32 step from the same state, rows and unsharded, each against the
# f64 step: the rows step's error at most ROWS_F32_RATIO times the
# unsharded step's. At 2048^2 the biharmonic multiplies psi's grid-scale
# f32 rounding (the two order the transforms' stages differently) by about
# iRe4 (8/delta^2)^3 = 2e5, so the two f32 steps differ by far more than
# f32's epsilon (5.5e-3 of max|q| on one H100) while each is as far from
# the f64 step; a wrong slab or wall is O(1) in f64 too
ROWS_F32_RATIO = 2.0


def _rows_checks(label, lim, dtype, cases):
    """Each case (name, kernel(psi_ext, q_ext, row0, ny), plain(...),
    whole(), fields): the rows launches on ROWS_SHARDS virtual shards put
    together against the whole-domain launch (bitwise, or within ROWS_ULPS
    ulp of max|out|) and against the plain rows version (within `lim` of
    max|out|); returns (ok, the worst max abs error against the plain rows
    version, the number of cases that were not bitwise)."""
    import torch
    from msom_tpu_torch.parallel import halo
    ok, worst, n_ulp = True, 0.0, 0
    for name, kernel, plain, whole, fields, wrap in cases:
        exts = [halo.split_rows8(f, ROWS_SHARDS, wrap) for f in fields]
        N = fields[0].shape[-2]
        n = N // ROWS_SHARDS
        got, ref = [], []
        for d in range(ROWS_SHARDS):
            args = [e[d] for e in exts] + [d * n, n]
            got.append(kernel(*args))
            ref.append(plain(*args))
        want = whole()
        torch.cuda.synchronize()
        parts = list(zip(*got))
        eps = torch.finfo(want[0].dtype).eps
        bitwise, ulps = True, 0.0
        for k, (g, w) in enumerate(zip(parts, want)):
            g = torch.cat(list(g), dim=-2) if k == 0 \
                else torch.stack(list(g)).amax(0)
            bitwise &= torch.equal(g, w)
            ulps = max(ulps, ((g - w).abs().max()
                              / (eps * w.abs().max())).item())
        n_ulp += not bitwise
        errs = []
        for k, (g, r) in enumerate(zip(parts, zip(*ref))):
            g = torch.cat(list(g), dim=-2) if k == 0 \
                else torch.stack(list(g)).amax(0)
            r = torch.cat(list(r), dim=-2) if k == 0 \
                else torch.stack(list(r)).amax(0)
            errs.append(((g - r).abs().max().item(), r.abs().max().item()))
        rel = max(e / m for e, m in errs)
        good = ulps <= ROWS_ULPS and rel <= lim
        ok &= good
        worst = max(worst, errs[0][0])
        print(f"{label} {name} {dtype} N={N}, {ROWS_SHARDS} shards of {n} "
              f"rows: bitwise equal to the whole-domain launch {bitwise}"
              + ("" if bitwise else f" ({ulps:.2f} ulp of max|out|, limit "
                 f"{ROWS_ULPS})")
              + f", against the plain rows version {rel:.3e} of max|out| "
              f"(limit {lim:g}) {'ok' if good else 'FAIL'}")
    return ok, worst, n_ulp


def rows_kernel_checks(QGConfig):
    """K1's and K2's rows mode on ROWS_SHARDS virtual shards of one field
    (halo slabs cut from it, row0 = d * n_loc), f64 and f32, every K1
    option set (walled, slip, periodic, stochastic walled and periodic)
    and K2 with 1-3 tracers (walled and periodic) at ROWS_SIZES: each put
    together must equal the whole-domain kernel bit for bit (or within
    ROWS_ULPS ulp, see there) and lie within LIMITS of the plain rows
    version. Returns (ok, {"K1": worst max abs error at 2048^2 x 4 f32,
    "K2": ...})."""
    import torch
    from msom_tpu_torch.models import fused_rhs, fused_tracer, qg
    ok, main_err, n_ulp, n_cases = True, {"K1": 0.0, "K2": 0.0}, 0, 0
    for dtype in ("float64", "float32"):
        lim = LIMITS[8 if dtype == "float64" else 4]
        tdt = getattr(torch, dtype)
        for N, nl in ROWS_SIZES:
            rng = np.random.default_rng(N + nl + 1)
            psi = torch.as_tensor(1e-3 * rng.uniform(-1, 1, (nl, N, N)),
                                  dtype=tdt, device="cuda")
            k1_cases = []
            for periodic, names in (
                    (False, ("uncoupled",) + K1_OPTIONS
                     + K1_STOCHASTIC_OPTIONS),
                    (True, ("uncoupled",) + K1_PERIODIC_OPTIONS
                     + K1_STOCHASTIC_OPTIONS)):
                flow = {k: v[:nl] for k, v in PG_FLOW.items()} \
                    if periodic else {}
                cfg = bench_config(QGConfig, N, nl, dtype, Re=1000.0,
                                   Eks=0.001, flsrv=1,
                                   sbc=-1.0 if periodic else 0.0, **flow)
                full = qg.build_constants(
                    cfg, device="cuda", **coupled_fields(cfg, 1e-3, N + nl))
                q = qg.comp_q(cfg, full, psi).contiguous()
                for name in names:
                    vcfg, vc = k1_variant(cfg, full, name)
                    need = vcfg.energy_conserv or vcfg.stochastic

                    def kern(pe, qe, r0, n, vcfg=vcfg, vc=vc, need=need):
                        return fused_rhs.rhs_fused(
                            vcfg, vc, pe[:, 8:8 + n], psi_ext=pe,
                            q_ext=qe if need else None, row0=r0)

                    def plain(pe, qe, r0, n, vcfg=vcfg, vc=vc):
                        return fused_rhs.rhs_fused_reference(
                            vcfg, vc, pe[:, 8:8 + n], psi_ext=pe, q_ext=qe,
                            row0=r0)

                    def whole(vcfg=vcfg, vc=vc, need=need, q=q):
                        return fused_rhs.rhs_fused(vcfg, vc, psi,
                                                   q if need else None)

                    k1_cases.append((f"{'periodic' if periodic else 'walled'}"
                                     f" {name} nl={nl}", kern, plain, whole,
                                     (psi, q), periodic))
            good, err, nu = _rows_checks("K1 rows", lim, dtype, k1_cases)
            ok &= good
            n_ulp, n_cases = n_ulp + nu, n_cases + len(k1_cases)
            k2_cases = []
            for periodic in (False, True):
                for nptr in (1, 2, 3):
                    cfg = bench_config(QGConfig, N, nl, dtype,
                                       sbc=-1.0 if periodic else 0.0,
                                       nptr=nptr, Pe=(1e3, 2e3, 7e2)[:nptr],
                                       ptr_r=(100.0, 0.0, 13.0)[:nptr])
                    shape = (nl, nptr, N, N)
                    tr = torch.as_tensor(1e-3 * rng.uniform(-1, 1, shape),
                                         dtype=tdt, device="cuda")
                    const = qg.build_constants(
                        cfg, device="cuda",
                        ptr_relax=1e-3 * rng.uniform(-1, 1, shape))

                    def kern(pe, te, r0, n, cfg=cfg, const=const, tr=tr):
                        return (fused_tracer.tracer_fused(
                            cfg, const, pe[:, 8:8 + n], tr[..., r0:r0 + n, :]
                            .contiguous(), psi_ext=pe, tr_ext=te,
                            row0=r0).reshape(-1, n, cfg.N),)

                    def plain(pe, te, r0, n, cfg=cfg, const=const, tr=tr):
                        return (fused_tracer.tracer_fused_reference(
                            cfg, const, pe[:, 8:8 + n], tr[..., r0:r0 + n, :],
                            psi_ext=pe, tr_ext=te, row0=r0)
                            .reshape(-1, n, cfg.N),)

                    def whole(cfg=cfg, const=const, tr=tr):
                        return (fused_tracer.tracer_fused(cfg, const, psi, tr)
                                .reshape(-1, cfg.N, cfg.N),)

                    k2_cases.append((
                        f"{'periodic' if periodic else 'walled'} nptr={nptr}"
                        f" nl={nl}", kern, plain, whole,
                        (psi, tr.reshape(-1, N, N)), periodic))
            good2, err2, nu = _rows_checks("K2 rows", lim, dtype, k2_cases)
            ok &= good2
            n_ulp, n_cases = n_ulp + nu, n_cases + len(k2_cases)
            if dtype == "float32" and (N, nl) == (2048, 4):
                main_err = {"K1": err, "K2": err2}
            del psi, k1_cases, k2_cases
            torch.cuda.empty_cache()
    print(f"rows kernel checks: {n_cases - n_ulp} of {n_cases} bit for bit "
          f"the whole-domain launch, {n_ulp} within {ROWS_ULPS} ulp "
          f"{'ok' if ok else 'FAIL'}")
    return ok, main_err


def _rows_group():
    """A process group of world size 1 under NCCL on a file:// store in a
    temporary directory (the card runs one rank)."""
    import tempfile
    from msom_tpu_torch.parallel import dist
    tmp = tempfile.mkdtemp()
    dist.init("cuda", init_method=f"file://{tmp}/store", world_size=1,
              rank=0)
    return tmp


def rows_step_check(QGConfig):
    """The rows step under NCCL at world size 1 on the card against the
    port's unsharded step on the CPU: 128^2 x 3 f64, coupled (bench's
    fields, a weak forcing) with two tracers, 20 steps, q, psi and the
    tracers within STEP_LIMIT, dt to 1e-12, two K1 and two K2 rows
    launches a step."""
    import torch
    from msom_tpu_torch.models import fused_rhs, fused_tracer, qg
    from msom_tpu_torch.parallel.step import make_qg_step_sharded
    cfg = verron(QGConfig, 128, **TRACERS)
    rng = np.random.default_rng(42)
    psi0 = 1e-3 * rng.uniform(-1, 1, (cfg.nl, cfg.N, cfg.N))
    fields = coupled_fields(cfg)
    fields["qforc"] = 1e-5 * rng.standard_normal(psi0.shape)
    tr0 = 1e-3 * rng.uniform(-1, 1, (cfg.nl, cfg.nptr, cfg.N, cfg.N))
    steps, out = 20, {}
    for where in ("cpu", "cuda"):
        const = qg.build_constants(cfg, device=where, **fields)
        state = qg.init_state(cfg, const, psi0=psi0, tracers0=tr0)
        if where == "cpu":
            step = qg.make_step(cfg)
        else:
            rs = make_qg_step_sharded(cfg, device="cuda")
            step, const, state = rs.step, rs.shard(const), rs.shard(state)
            fused_rhs.rows_launches = fused_tracer.rows_launches = 0
        for _ in range(steps):
            state, diag = step(state, const, 1e9)
        out[where] = (state, diag)
    n1, n2 = fused_rhs.rows_launches, fused_tracer.rows_launches
    (cs, cd), (gs, gd) = out["cpu"], out["cuda"]
    rels = {n: _rel(getattr(gs, n), getattr(cs, n))
            for n in ("q", "psi", "tracers")}
    dt_rel = abs(gd.dt.item() - cd.dt.item()) / cd.dt.item()
    good = (all(r <= STEP_LIMIT for r in rels.values()) and dt_rel <= 1e-12
            and n1 == n2 == 2 * steps)
    print(f"rows step check 128^2 x 3 f64 coupled, world size 1 under NCCL, "
          f"{steps} steps cuda vs the unsharded cpu step: "
          + ", ".join(f"rel {k} = {v:.3e}" for k, v in rels.items())
          + f" (limit {STEP_LIMIT:g}), rel dt {dt_rel:.3e}, K1 rows "
          f"launches {n1}, K2 rows launches {n2} (expected {2 * steps} "
          f"each) {'ok' if good else 'FAIL'}")
    return good


def rows_driver_check(QGConfig):
    """run_qg(sharded="rows") at world size 1 on the card against the
    unsharded run_qg on the card, 128^2 x 3 f64, coupled with two tracers,
    the filter, the energy budget and an OutputWriter each: the final
    state within STEP_LIMIT, the same files, each .bas within float32
    rounding (2^-23 of its max|value|), the mode returned."""
    import os
    import tempfile
    from msom_tpu_torch import driver
    from msom_tpu_torch.io.bas import read_bas
    from msom_tpu_torch.models import qg
    cfg = verron(QGConfig, 128, dtflt=0.25, dtout=0.5, tend=0.75, ediag=0,
                 afilt=7.0, **TRACERS)
    rng = np.random.default_rng(42)
    psi0 = 1e-3 * rng.uniform(-1, 1, (cfg.nl, cfg.N, cfg.N))
    tr0 = 1e-3 * rng.uniform(-1, 1, (cfg.nl, cfg.nptr, cfg.N, cfg.N))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for mode in (False, "rows"):
            const = qg.build_constants(cfg, device="cuda",
                                       **coupled_fields(cfg))
            state = qg.init_state(cfg, const, psi0=psi0, tracers0=tr0)
            hooks = driver.RunHooks(on_output=driver.OutputWriter(
                cfg, const, outdir=os.path.join(tmp, str(mode))))
            out[mode] = driver.run_qg(cfg, const=const, state=state,
                                      hooks=hooks, sharded=mode)
        files = sorted(os.listdir(os.path.join(tmp, "False")))
        same = files == sorted(os.listdir(os.path.join(tmp, "rows")))
        bas = max(_rel(read_bas(os.path.join(tmp, "rows", n))[0],
                       read_bas(os.path.join(tmp, "False", n))[0])
                  for n in files if n.endswith(".bas")) if same else np.inf
    (s0, _), (s1, _, mode) = out[False], out["rows"]
    rels = {n: _rel(getattr(s1, n), getattr(s0, n))
            for n in ("q", "psi", "qof", "tracers")}
    good = (mode == "rows" and same and bas <= 2.0 ** -23
            and all(r <= STEP_LIMIT for r in rels.values())
            and int(s1.i) == int(s0.i) and int(s1.nbar) == 2)
    print(f"rows driver check 128^2 x 3 f64 coupled, run_qg(sharded='rows') "
          f"at world size 1 vs run_qg on the card, {int(s1.i)} steps, "
          f"mode {mode!r}: " + ", ".join(f"rel {k} = {v:.3e}"
                                         for k, v in rels.items())
          + f"; {len(files)} files, same names {same}, .bas {bas:.3e} of "
          f"max (limit 2^-23) {'ok' if good else 'FAIL'}")
    return good


def _rows_one_step(QGConfig, cfg, coupled, state, unsharded, rows_step):
    """From the f32 `state`, one step each: (f64 rows against f64
    unsharded, f32 unsharded against f64 unsharded, f32 rows against f64
    unsharded), as max|d q| over max|q|."""
    from msom_tpu_torch.models import qg
    from msom_tpu_torch.parallel.step import make_qg_step_sharded
    step, const = unsharded
    rs, rconst = rows_step
    cfg64 = dataclasses.replace(cfg, dtype="float64").validate()
    const64 = qg.build_constants(
        cfg64, device="cuda", **(coupled_fields(cfg64) if coupled else {}))
    s64 = _to64(state)
    u64, _ = qg.make_step(cfg64)(s64, const64, 1e18)
    rs64 = make_qg_step_sharded(cfg64, device="cuda")
    r64, _ = rs64.step(rs64.shard(s64), rs64.shard(const64), 1e18)
    u32, _ = step(state, const, 1e18)
    r32, _ = rs.step(rs.shard(state), rconst, 1e18)
    return (_rel(rs64.gather(r64).q, u64.q), _rel(u32.q, u64.q),
            _rel(rs.gather(r32).q, u64.q))


def rows_path(QGConfig, rows, rows_err):
    """bench.py's sharded_rows row (bench.py:127-163) at world size 1 under
    NCCL: 2048^2 x 4 f32, uncoupled and coupled (bench's fields and two
    tracers, so that K2 rows runs), the rows step beside the unsharded
    step from the same IC: 20 warm-up steps each, then five rounds of 20
    steps of each in turns (timed_rounds), the ratio of the medians, the
    device busy time and idle share of each (a four-step profile), the
    rows launches a step; a finite state; from the unsharded run's final
    state one rows and one unsharded step in f64 (within STEP_LIMIT of
    each other) and in f32 (each against the f64 step: the rows step's
    error within ROWS_F32_RATIO of the unsharded one's); and how far the
    two runs drifted apart beside how far an unsharded run from an IC one
    f32 ulp away drifts in the same steps (f32 rounding that the flow's
    growth amplifies; printed, not held to a limit). On the coupled
    path K1's and K2's rows launches on a 512-row shard (rows 512-1023 of
    the final state) are timed beside the whole-domain launch and their
    plain rows versions, against their bounds; their records go to
    `rows`. Returns False if the path failed."""
    import torch
    from msom_tpu_torch.models import fused_rhs, fused_tracer, qg
    from msom_tpu_torch.parallel import halo
    from msom_tpu_torch.parallel.step import make_qg_step_sharded
    N, nl, warm = 2048, 4, 20
    shape = (nl, N, N)
    for label in ("uncoupled", "coupled"):
        coupled = label == "coupled"
        cfg = bench_config(QGConfig, N, nl, "float32",
                           **(TRACERS if coupled else {}))
        const = qg.build_constants(
            cfg, device="cuda", **(coupled_fields(cfg) if coupled else {}))
        rng = np.random.default_rng(0)
        psi0 = 1e-3 * rng.uniform(-1, 1, shape)
        tr0 = 1e-3 * rng.uniform(-1, 1, (nl, cfg.nptr, N, N)) \
            if coupled else None
        rs = make_qg_step_sharded(cfg, device="cuda")
        rconst = rs.shard(const)
        steps = {"unsharded": qg.make_step(cfg), "rows": rs.step}
        consts = {"unsharded": const, "rows": rconst}
        box = {k: [qg.init_state(cfg, const, psi0=psi0, tracers0=tr0), None]
               for k in steps}
        box["rows"][0] = rs.shard(box["rows"][0])
        # the yardstick of the drift: psi0 one f32 ulp up
        p32 = psi0.astype(np.float32)
        ulp = qg.init_state(cfg, const, psi0=np.nextafter(p32, np.inf),
                            tracers0=tr0)

        def stepper(k):
            def one():
                box[k][0], box[k][1] = steps[k](box[k][0], consts[k], 1e18)
            return one

        for k in steps:
            for _ in range(warm):
                stepper(k)()
        torch.cuda.synchronize()
        ms = {k: [] for k in steps}
        counts = {}
        for r in range(ROUNDS):
            for k in ("unsharded", "rows"):
                reset_counts()
                fused_rhs.rows_launches = fused_tracer.rows_launches = 0
                ms[k].append(cuda_ms(stepper(k), ROUND_STEPS))
                if k == "rows":
                    counts[r] = (fused_rhs.rows_launches,
                                 fused_tracer.rows_launches,
                                 kernel_counts())
        med = {k: float(np.median(v)) for k, v in ms.items()}
        busy = {k: sum(x[0] for x in kernel_profile(
            f"sharded_rows {label} {k}", stepper(k), 4, med[k]))
            for k in steps}
        n_rows = steps_done = ROUNDS * ROUND_STEPS
        k1r = sum(c[0] for c in counts.values())
        k2r = sum(c[1] for c in counts.values())
        others = {n: sum(c[2][n] for c in counts.values())
                  for n in ("K3", "K4", "K5", "K6", "K7", "KV")}
        whole = rs.gather(box["rows"][0])
        finite = state_ok(whole, box["rows"][1], shape)
        final = box["unsharded"][0]
        drift = _rel(whole.q, final.q)
        for _ in range(warm + steps_done + 4):
            ulp, _ = steps["unsharded"](ulp, const, 1e18)
        drift_ulp = _rel(ulp.q, final.q)
        del ulp
        err = _rows_one_step(QGConfig, cfg, coupled, final,
                             (steps["unsharded"], const), (rs, rconst))
        want2 = 2 * steps_done if coupled else 0
        ok = (finite and err[0] <= STEP_LIMIT
              and err[2] <= ROWS_F32_RATIO * err[1] and k1r == 2 * n_rows
              and k2r == want2 and not any(others.values()))
        for k in steps:
            print(f"sharded_rows {label} {k} {N}^2 x {nl} f32 after {warm} "
                  f"warm-up steps: " + rounds_line(ms[k], med[k], busy[k]))
        print(f"sharded_rows {label} path at world size 1 under NCCL: rows "
              f"{med['rows']:.4f} ms/step against unsharded "
              f"{med['unsharded']:.4f} (ratio "
              f"{med['rows'] / med['unsharded']:.4f}; device busy ratio "
              f"{busy['rows'] / busy['unsharded']:.4f}), K1 rows launches "
              f"{k1r} (expected {2 * n_rows}), K2 rows launches {k2r} "
              f"(expected {want2}), other kernels {others}; ke "
              f"{box['rows'][1].ke.item():.6e}, dt "
              f"{box['rows'][1].dt.item():.6e}, finite {finite}; one step "
              f"from the unsharded final state: in f64 rows against "
              f"unsharded max|d q|/max|q| = {err[0]:.3e} (limit "
              f"{STEP_LIMIT:g}), in f32 against the f64 step unsharded "
              f"{err[1]:.3e}, rows {err[2]:.3e} (at most "
              f"{ROWS_F32_RATIO:g} x unsharded); the two runs after "
              f"{warm + steps_done + 4} steps {drift:.3e} apart, an "
              f"unsharded run from psi0 one f32 ulp up {drift_ulp:.3e} "
              f"apart {'ok' if ok else 'FAIL'}")
        if not ok:
            return False
        if coupled:
            state = box["unsharded"][0]
            psi, q, tr = state.psi, state.q, state.tracers
            n, r0 = N // ROWS_SHARDS, N // ROWS_SHARDS
            sl = slice(r0, r0 + n)
            pe = halo.split_rows8(psi, ROWS_SHARDS)[1]
            te = halo.split_rows8(tr.reshape(-1, N, N), ROWS_SHARDS)[1]
            ps, ts = pe[:, 8:8 + n], tr[..., sl, :].contiguous()
            for name, kern, plain, wfn, bw, launched, src, err in (
                    ("fused_rhs rows",
                     lambda: fused_rhs.rhs_fused(cfg, const, ps, psi_ext=pe,
                                                 row0=r0)[0],
                     lambda: fused_rhs.rhs_fused_reference(
                         cfg, const, ps, psi_ext=pe, row0=r0)[0],
                     lambda: fused_rhs.rhs_fused(cfg, const, psi)[0],
                     lambda rows_: fused_rhs.bound_work(cfg, const, 4,
                                                        rows_),
                     k1r, fused_rhs.ROWS_SOURCE, rows_err["K1"]),
                    ("fused_tracer rows",
                     lambda: fused_tracer.tracer_fused(
                         cfg, const, ps, ts, psi_ext=pe, tr_ext=te,
                         row0=r0),
                     lambda: fused_tracer.tracer_fused_reference(
                         cfg, const, ps, ts, psi_ext=pe, tr_ext=te,
                         row0=r0),
                     lambda: fused_tracer.tracer_fused(cfg, const, psi, tr),
                     lambda rows_: fused_tracer.bound_work(cfg, const, 4,
                                                           rows_),
                     k2r, fused_tracer.ROWS_SOURCE, rows_err["K2"])):
                row = _kernel_row(
                    "sharded_rows coupled", name, kern, plain,
                    bw((r0, n)), launched, src,
                    "msom_tpu/models/pallas_rhs.py:"
                    + ("441" if name.startswith("fused_rhs") else "778"),
                    f"rows mode, a {n}-row shard (rows {r0}-{r0 + n - 1})")
                if row is None:
                    return False
                row["max_abs_err"] = max(row["max_abs_err"], err)
                w_ms = cuda_ms(wfn, 50)
                wb = roofline(*bw(None), 4)[0]
                print(f"{name}: the whole-domain launch on the same state "
                      f"{w_ms:.4f} ms (bound {wb:.4f} ms); the {n}-row "
                      f"shard's launch {row['ms']:.4f} ms (bound "
                      f"{row['bound_ms']:.4f} ms), {ROWS_SHARDS} such "
                      f"launches {ROWS_SHARDS * row['ms']:.4f} ms")
                rows.append(row)
            del pe, te, ps, ts
        del const, rconst, box
        torch.cuda.empty_cache()
    return True


# the shard phases' protocol: two rounds of five steps (with two rounds
# of ten the whole script took 1176 s of its 1200 on one H100 whose host
# ran every phase 1.3-1.6 times slower than usual)
SHARD_ROUNDS, SHARD_STEPS = 2, 5
SHARD_WARM = 3
# the gspmd configurations of the shard phase: {label: bench_config kwargs}
SHARD_GSPMD = {"spectral": {}, "mg": dict(solver="mg", tol=1e-3),
               "modal": dict(solver="mg", tol=1e-3, mode_pv_invert=True),
               "varro": dict(varRo=1)}
# the routing checks: {label: (verron kwargs, the mode JAX's run_qg records
# at world size 1, msom_tpu/driver.py:193-240)}
SHARD_ROUTES = {"spectral": ({}, "rows"), "mg": (dict(solver="mg"), "rows"),
                "mode_pv_invert": (dict(solver="mg", mode_pv_invert=True),
                                   "gspmd"),
                "varro": (dict(varRo=1), "gspmd")}


def _to64(state):
    """A float64 copy of a QGState's floating-point leaves."""
    import torch
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).double()
        for f in dataclasses.fields(state)
        if isinstance(getattr(state, f.name), torch.Tensor)
        and getattr(state, f.name).is_floating_point()})


def _shard_pair(label, runs, warm=SHARD_WARM):
    """`runs` {name: (step, const, state)}: warm-up steps of each, then
    SHARD_ROUNDS rounds of SHARD_STEPS steps of each in turns, timed with
    CUDA events, the launches of every kernel and the first solve's
    V-cycles of every timed step; a two-step profile of each for its
    device busy time. Returns {name: dict(med, ms, busy, counts, cycles,
    state, diag)}."""
    import torch
    from msom_tpu_torch.models import fused_rhs, fused_tracer
    box = {k: [st, None] for k, (_, _, st) in runs.items()}
    cycles = {k: [] for k in runs}

    def stepper(k):
        step, const, _ = runs[k]

        def one():
            box[k][0], box[k][1] = step(box[k][0], const, 1e18)
            cycles[k].append(getattr(box[k][1], "mg_iters", 0))
        return one

    for k in runs:
        for _ in range(warm):
            stepper(k)()
    torch.cuda.synchronize()
    out = {k: dict(ms=[], counts={}) for k in runs}
    for k in runs:
        cycles[k].clear()
    for _ in range(SHARD_ROUNDS):
        for k in runs:
            reset_counts()
            fused_rhs.rows_launches = fused_tracer.rows_launches = 0
            out[k]["ms"].append(cuda_ms(stepper(k), SHARD_STEPS))
            c = dict(kernel_counts(), K1rows=fused_rhs.rows_launches,
                     K2rows=fused_tracer.rows_launches)
            for n, v in c.items():
                out[k]["counts"][n] = out[k]["counts"].get(n, 0) + v
    for k in runs:
        r = out[k]
        r["cycles"] = list(cycles[k])
        r["med"] = float(np.median(r["ms"]))
        r["busy"] = sum(x[0] for x in kernel_profile(
            f"shard {label} {k}", stepper(k), 2, r["med"]))
        r["state"], r["diag"] = box[k]
    return out


def _qg_final(r):
    """(whether a QGState run ended finite, its shape and final numbers)."""
    shape = tuple(r["state"].q.shape)
    finite = state_ok(r["state"], r["diag"], shape)
    return finite, f" {shape[1]}^2 x {shape[0]}", (
        f", ke {r['diag'].ke.item():.6e}, dt {r['diag'].dt.item():.6e}, "
        f"finite {finite}")


def _shard_report(label, res, want, extra="", final=_qg_final):
    """Print each run's rounds, launches and V-cycles; check the launches
    against `want` {run: {counter: count}} (every other counter 0) and,
    by `final(run)` -> (ok, shape text, final text), the final state.
    Returns whether all held."""
    ok = True
    n_steps = SHARD_ROUNDS * SHARD_STEPS
    for k, r in res.items():
        finite, shape, tail = final(r)
        good = finite and all(r["counts"][n] == want[k].get(n, 0)
                              for n in r["counts"])
        ok &= good
        c = r["cycles"]
        print(f"shard {label} {k}{shape}: "
              + rounds_line(r["ms"], r["med"], r["busy"], SHARD_STEPS)
              + (f", V-cycles of the first solve a step mean "
                 f"{np.mean(c):.4f} max {max(c)}" if max(c) else "")
              + f", launches over {n_steps} steps "
              + (", ".join(f"{n} {v}" for n, v in r["counts"].items() if v)
                 or "none")
              + f" (expected {want[k] or 'none'}){tail} "
              f"{'ok' if good else 'FAIL'}")
    a, *others = list(res)
    for b in others:
        print(f"shard {label}: {b} {res[b]['med']:.4f} ms/step against {a} "
              f"{res[a]['med']:.4f} (ratio "
              f"{res[b]['med'] / res[a]['med']:.4f}, device busy ratio "
              f"{res[b]['busy'] / res[a]['busy']:.4f}); a multi-rank run is "
              f"not measured: one card{extra}")
    return ok


def _shard_f64_step(cfg, fields, state, sharded):
    """From the f32 `state`, one f64 step of the unsharded step and one of
    the sharded step of `sharded` kwargs: max|d q|/max|q| between them."""
    from msom_tpu_torch.models import qg
    from msom_tpu_torch.parallel.step import make_qg_step_sharded
    cfg64 = dataclasses.replace(cfg, dtype="float64").validate()
    const64 = qg.build_constants(cfg64, device="cuda", **fields)
    s64 = _to64(state)
    u64, _ = qg.make_step(cfg64)(s64, const64, 1e18)
    rs = make_qg_step_sharded(cfg64, device="cuda", const=const64, **sharded)
    r64, _ = rs.step(rs.shard(s64), rs.shard(const64), 1e18)
    return _rel(rs.gather(r64).q, u64.q)


def shard_routing_check(QGConfig):
    """run_qg(sharded="auto") at world size 1 on the card, 128^2 x 3 f64,
    two steps of each of SHARD_ROUTES: the mode JAX's run_qg records, and
    the unsharded run_qg's state within STEP_LIMIT."""
    from msom_tpu_torch import driver
    from msom_tpu_torch.models import qg
    ok = True
    for label, (over, want) in SHARD_ROUTES.items():
        cfg = verron(QGConfig, 128, tend=1e9, dtout=1e9, **over)
        psi0 = 1e-3 * np.random.default_rng(7).uniform(
            -1, 1, (cfg.nl, cfg.N, cfg.N))
        out = {}
        for sharded in (False, "auto"):
            const = qg.build_constants(cfg, device="cuda")
            state = qg.init_state(cfg, const, psi0=psi0)
            out[sharded] = driver.run_qg(cfg, const=const, state=state,
                                         max_steps=2, sharded=sharded)
        mode = out["auto"][2]
        rel = _rel(out["auto"][0].q, out[False][0].q)
        good = mode == want and rel <= STEP_LIMIT
        ok &= good
        print(f"shard routing {label}: run_qg(sharded='auto') at world size "
              f"1 took {mode!r} (JAX's run_qg records {want!r}), two steps "
              f"against the unsharded run_qg max|d q|/max|q| = {rel:.3e} "
              f"(limit {STEP_LIMIT:g}) {'ok' if good else 'FAIL'}")
    return ok


def _halo_rim(step):
    """`step` with every ring of halo.ghosted_issue held in flight until
    its wait (on one card there is no transfer), so that the overlapped
    stencils split as on a mesh of several ranks: from a tile of
    halo.SPLIT_MIN_BYTES up."""
    from msom_tpu_torch.parallel import halo
    issue = halo.ghosted_issue

    def held(a, bc, mesh):
        return halo.PendingGhosted(a, [], issue(a, bc, mesh).wait)

    def run(*args):
        halo.ghosted_issue = held
        try:
            return step(*args)
        finally:
            halo.ghosted_issue = issue
    return run


def _overlap_report(label, res):
    """The halo forms of one gspmd step: as shipped (at world size 1 the
    ring is complete at once and summed whole) and with the rings held in
    flight (the split from a tile of SPLIT_MIN_BYTES up): each one's
    median, range and device busy time, and the final states bit for bit.
    Returns whether they are."""
    import torch
    n = SHARD_ROUNDS * SHARD_STEPS
    runs = {"shipped": res["gspmd"], "rings in flight": res["gspmd rim"]}
    base = res["gspmd"]
    same = all(torch.equal(getattr(r["state"], f), getattr(base["state"], f))
               for r in runs.values() for f in ("q", "psi"))
    print(f"shard {label} halo overlap: "
          + "".join(f"{k} {r['med']:.4f} ms/step (range {min(r['ms']):.4f}-"
                    f"{max(r['ms']):.4f}, ratio to shipped "
                    f"{r['med'] / base['med']:.4f}, device busy "
                    f"{r['busy']:.4f} ms/step); " for k, r in runs.items())
          + f"the final q and psi bit for bit equal: {same}; on one card "
          f"nothing is in flight, so a split's ratio is what the "
          f"overlapped form costs, not what it gains "
          f"({n} steps each) {'ok' if same else 'FAIL'}")
    return same


def shard_path(QGConfig, rows, rows_err, kv_err):
    """The sharded multigrid and the general-mesh step at world size 1
    under NCCL, at 2048^2 x 4 f32. (a) The rows step with solver="mg"
    (bench's mg row, tol 1e-3), uncoupled and coupled (bench's fields, two
    tracers), beside the unsharded mg step (K3, K4): the rows step
    launches K1 and K2 rows twice a step and neither K3 nor K4 (the
    sharded multigrid is torch ops, as JAX's shard_mg is XLA ops). (b) The
    general-mesh step ("gspmd") on the (1, 1) mesh beside the unsharded
    step, spectral (the matmul basis), mg, mode_pv_invert and varRo
    spectral: no K1, K2, K3 or K4 (JAX strips its kernels under GSPMD);
    varRo launches KV twice a step. Each pair by _shard_pair; from the
    unsharded run's final state one f64 step of each within STEP_LIMIT.
    Appends the records of K1 rows and K2 rows (coupled rows mg) and KV
    (gspmd varRo) to `rows`. Returns False if the path failed."""
    import torch
    from msom_tpu_torch.models import fused_rhs, fused_tracer, qg
    from msom_tpu_torch.parallel import halo
    from msom_tpu_torch.parallel.step import make_qg_step_sharded
    from msom_tpu_torch.solvers import fused_vary
    N, nl = 2048, 4
    shape = (nl, N, N)
    psi0 = 1e-3 * np.random.default_rng(0).uniform(-1, 1, shape)
    cases = [("rows mg " + c, dict(solver="mg", tol=1e-3,
                                   **(TRACERS if c == "coupled" else {})),
              c == "coupled", dict(mode="rows")) for c in ("uncoupled",
                                                            "coupled")]
    cases += [(f"gspmd {c}", over, False, dict(mode="gspmd", mesh=(1, 1)))
              for c, over in SHARD_GSPMD.items()]
    for label, over, coupled, sharded in cases:
        t0 = time.perf_counter()
        cfg = bench_config(QGConfig, N, nl, "float32", **over)
        fields = coupled_fields(cfg) if coupled else {}
        const = qg.build_constants(cfg, device="cuda", **fields)
        tr0 = 1e-3 * np.random.default_rng(1).uniform(
            -1, 1, (nl, cfg.nptr, N, N)) if coupled else None
        state = qg.init_state(cfg, const, psi0=psi0, tracers0=tr0)
        rs = make_qg_step_sharded(cfg, device="cuda", const=const, **sharded)
        mode = sharded["mode"]
        runs = {"unsharded": (qg.make_step(cfg), const, state),
                mode: (rs.step, rs.shard(const), rs.shard(state))}
        overlap = label in ("gspmd spectral", "gspmd mg")
        if overlap:
            runs["gspmd rim"] = (_halo_rim(rs.step), runs[mode][1],
                                 runs[mode][2])
        torch.cuda.synchronize()
        print(f"shard {label} set-up {time.perf_counter() - t0:.1f} s")
        res = _shard_pair(label, runs)
        n = 2 * SHARD_ROUNDS * SHARD_STEPS
        if mode == "rows":
            want = {"rows": dict(K1=n, K1rows=n,
                                 **(dict(K2=n, K2rows=n) if coupled else {}))}
        else:
            want = {"gspmd": dict(KV=n) if label.endswith("varro") else {},
                    "gspmd rim": {}}
        solver_mg = cfg.solver == "mg"
        u = dict(K1=n, **(dict(K2=n) if coupled else {}),
                 **(dict(KV=n) if label.endswith("varro") else {}))
        # the unsharded mg step launches K3 and K4 as its cycles need
        want["unsharded"] = u
        if solver_mg:
            for k in ("K3", "K4"):
                want["unsharded"][k] = res["unsharded"]["counts"][k]
        err = _shard_f64_step(cfg, fields, res["unsharded"]["state"],
                              sharded)
        ok = _shard_report(
            label, res, want, f"; one f64 step from the unsharded final "
            f"state, {mode} against unsharded max|d q|/max|q| = {err:.3e} "
            f"(limit {STEP_LIMIT:g})")
        if solver_mg:
            ok &= res["unsharded"]["counts"]["K3"] > 0 and all(
                1 <= c <= MG_MAX_CYCLES for r in res.values()
                for c in r["cycles"])
        if overlap:
            ok &= _overlap_report(label, res)
        if not (ok and err <= STEP_LIMIT):
            print(f"shard {label} FAIL")
            return False
        final = res[mode]
        sconst = runs[mode][1]
        if label == "rows mg coupled":
            st = final["state"]
            psi, tr = st.psi, st.tracers
            pe = halo.ext_rows8(psi)
            te = halo.ext_rows8(tr.reshape(-1, N, N))
            for name, kern, plain, bw, launched, src, line, e in (
                    ("fused_rhs rows",
                     lambda: fused_rhs.rhs_fused(cfg, sconst, psi,
                                                 psi_ext=pe, row0=0)[0],
                     lambda: fused_rhs.rhs_fused_reference(
                         cfg, sconst, psi, psi_ext=pe, row0=0)[0],
                     fused_rhs.bound_work(cfg, sconst, 4, (0, N)),
                     final["counts"]["K1rows"], fused_rhs.ROWS_SOURCE,
                     "441", rows_err["K1"]),
                    ("fused_tracer rows",
                     lambda: fused_tracer.tracer_fused(
                         cfg, sconst, psi, tr, psi_ext=pe, tr_ext=te,
                         row0=0),
                     lambda: fused_tracer.tracer_fused_reference(
                         cfg, sconst, psi, tr, psi_ext=pe, tr_ext=te,
                         row0=0),
                     fused_tracer.bound_work(cfg, sconst, 4, (0, N)),
                     final["counts"]["K2rows"], fused_tracer.ROWS_SOURCE,
                     "778", rows_err["K2"])):
                row = _kernel_row(
                    f"shard {label}", name, kern, plain, bw, launched, src,
                    f"msom_tpu/models/pallas_rhs.py:{line}",
                    f"rows mode at world size 1, the {N}-row shard")
                if row is None:
                    return False
                row["max_abs_err"] = max(row["max_abs_err"], e)
                rows.append(row)
            del pe, te
        if label == "gspmd varro":
            spec = sconst.spec
            q = final["state"].q.contiguous()
            X = torch.matmul(q, spec.S.T).contiguous()
            row = _kernel_row(
                f"shard {label}", "vary_sweep",
                lambda: fused_vary.sweep(spec.W, X, spec.a),
                lambda: fused_vary.sweep_reference(spec.W, X, spec.a),
                fused_vary.bound_work(nl, N, spec.kb, 4),
                final["counts"]["KV"], fused_vary.SOURCE,
                "msom_tpu/solvers/vary.py:270",
                "the gspmd y-profile solve's whole columns, (1, 1) mesh",
                limit=KV_LIMITS[4], n_plain=2)
            if row is None:
                return False
            row["max_abs_err"] = max(row["max_abs_err"], kv_err)
            rows.append(row)
            del X, q
        del const, state, runs, res, rs, final, sconst
        torch.cuda.empty_cache()
    return True


VSHARD_CHECK_EVENTS = dict(NODE_CHECK_EVENTS, tend=0.125)


def vshard_driver_check(NodeQGConfig):
    """driver_node.run_node(sharded=True) under NCCL at world size 1 on the
    card against the unsharded run_node on the CPU: bench's node physics
    at 128^2 x 3 f64 with the coastline, solver="vmg", TOLERANCE 1e-8 and
    VSHARD_CHECK_EVENTS (records at t = 0 and 0.125, two diag rows, the
    filter at t = 0.125), from one numpy IC: the final q and psi and the
    diag rows within STEP_LIMIT, every vars.nc record within float32
    rounding; K5 never
    launched on the card (the sharded step is torch ops; K6 only in the
    t = 0 output's re-inversion on the whole constants)."""
    import os
    import tempfile
    from msom_tpu_torch import driver_node
    from msom_tpu_torch.io.netcdf import read_nc
    from msom_tpu_torch.models import qg_node
    cfg = node_config(NodeQGConfig, 128, 3, "float64", TOLERANCE=1e-8,
                      solver="vmg", **VSHARD_CHECK_EVENTS)
    psi0 = node_noise_ic(cfg, 42)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for where in ("cpu", "cuda"):
            const = qg_node.build_constants(
                cfg, device=where, mask=qg_node.coastline_mask(128))
            state = qg_node.init_state(cfg, const, psi0=psi0)
            output = driver_node.NodeOutput(cfg, os.path.join(tmp, where))
            rows = []
            write_row = output.diag_row

            def diag_row(*values, rows=rows, write_row=write_row):
                rows.append(values)
                write_row(*values)

            output.diag_row = diag_row
            reset_counts()
            t0 = time.perf_counter()
            state, _ = driver_node.run_node(
                cfg, const=const, state=state, output=output, restart=None,
                sharded=where == "cuda")
            secs = time.perf_counter() - t0
            nc = read_nc(os.path.join(tmp, where, "vars.nc"), ["psi", "q"],
                         None)
            out[where] = (state, rows, kernel_counts(), nc, secs)
    (cs, crow, cn, cnc, csec), (gs, grow, gn, gnc, gsec) = \
        out["cpu"], out["cuda"]
    rels = {n: _rel(getattr(gs, n), getattr(cs, n)) for n in ("q", "psi")}
    g, c = np.array(grow), np.array(crow)
    rels["diag"] = max(np.abs(g[:, k] - c[:, k]).max() / np.abs(c[:, k]).max()
                       for k in range(1, 4)) if len(c) else np.inf
    nc_rel = max(_rel(gnc[0][n], cnc[0][n]) for n in ("psi", "q"))
    steps = int(gs.i)
    good = (all(r <= STEP_LIMIT for r in rels.values())
            and nc_rel <= 2.0 ** -23 and np.array_equal(gnc[1], cnc[1])
            and len(cnc[1]) == 2 and len(grow) == len(crow) >= 2
            and int(cs.i) == steps and int(gs.nbar) == int(cs.nbar) == 1
            and gn["K5"] == 0 and not any(cn.values()))
    print(f"vshard run_node check 128^2 x 3 f64 coastline, {steps} steps, "
          f"{len(cnc[1])} records, {len(crow)} diag rows, one filter event, "
          f"sharded on the card (world size 1, NCCL, {gsec:.2f} s) vs "
          f"unsharded on the cpu ({csec:.2f} s): "
          + ", ".join(f"rel {k} = {v:.3e}" for k, v in rels.items())
          + f" (limit {STEP_LIMIT:g}); vars.nc {nc_rel:.3e} of max (limit "
          f"2^-23); card launches K5 {gn['K5']}, K6 {gn['K6']} (the t = 0 "
          f"re-inversion) {'ok' if good else 'FAIL'}")
    return good


def vshard_path(NodeQGConfig):
    """Bench's masked node configuration (coastline, solver="vmg") at
    2048^2 x 4 f32: the vertex-sharded step at world size 1 beside the
    unsharded step (K5, K6) in turns (_shard_pair: SHARD_WARM warm-up
    steps from the same state, SHARD_ROUNDS rounds of SHARD_STEPS steps of
    each), K5 and K6 expected 0 on the sharded side; from the unsharded
    run's final state one f64 step of each within STEP_LIMIT."""
    import torch
    from msom_tpu_torch.models import qg_node
    from msom_tpu_torch.parallel import vshard
    from msom_tpu_torch.parallel.mesh import make_mesh
    N, nl = 2048, 4
    label = f"vshard node_masked {N}^2 x {nl} f32"
    t0 = time.perf_counter()
    cfg = node_config(NodeQGConfig, N, nl, "float32", solver="vmg")
    mask = qg_node.coastline_mask(N)
    const = qg_node.build_constants(cfg, mask=mask)
    state = qg_node.init_state(cfg, const, psi0=node_noise_ic(cfg))
    mesh = make_mesh()
    sstep, place, csh = vshard.make_node_step_sharded(cfg, const, state.q,
                                                      mesh)
    runs = {"unsharded": (qg_node.make_step(cfg), const, state),
            "vshard": (sstep, csh, place(vshard.owned_state(state)))}
    torch.cuda.synchronize()
    print(f"{label} set-up {time.perf_counter() - t0:.1f} s, mesh "
          f"{mesh.shape}, {len(csh.vlevels)} levels all tiles "
          f"{all(csh.sharded_flags)}")
    res = _shard_pair(label, runs)
    n = 2 * SHARD_ROUNDS * SHARD_STEPS
    want = {"unsharded": dict(K5=n, K6=res["unsharded"]["counts"]["K6"]),
            "vshard": {}}

    def final(r):
        st, d = r["state"], r["diag"]
        finite = (bool(torch.isfinite(st.q).all())
                  and bool(torch.isfinite(st.psi).all())
                  and np.isfinite(d.ke.item()) and d.dt.item() > 0)
        return finite, "", (f", after {int(st.i)} steps t "
                            f"{st.t.item():.6e}, ke {d.ke.item():.6e}, "
                            f"finite {finite}")

    ok = _shard_report(label, res, want, final=final) \
        and res["unsharded"]["counts"]["K6"] > 0
    # one f64 step of each from the unsharded run's final state
    cfg64 = dataclasses.replace(cfg, dtype="float64")
    const64 = qg_node.build_constants(cfg64, mask=mask)
    u = res["unsharded"]["state"]
    s64 = dataclasses.replace(u, **{f: getattr(u, f).double() for f in (
        "q", "psi", "t", "dt_prev") if getattr(u, f) is not None},
        psi_f=None if u.psi_f is None else u.psi_f.double())
    want64, _ = qg_node.make_step(cfg64)(s64, const64, 1e18)
    step64, place64, csh64 = vshard.make_node_step_sharded(
        cfg64, const64, s64.q, mesh)
    got64, _ = step64(place64(vshard.owned_state(s64)), csh64, 1e18)
    err = _rel(vshard.full_state(got64, csh64).q, want64.q)
    good = err <= STEP_LIMIT
    print(f"{label}: one f64 step from the unsharded final state, vshard "
          f"against unsharded max|d q|/max|q| = {err:.3e} (limit "
          f"{STEP_LIMIT:g}) {'ok' if good else 'FAIL'}")
    del const, const64, runs, res, csh, csh64
    torch.cuda.empty_cache()
    return ok and good


def pgshard_driver_check(PGConfig):
    """driver.run_pg(sharded=True) under NCCL at world size 1 on the card
    against the unsharded run_pg on the CPU, f64, 32^2 x 4, tend = 0.3,
    dtout = 0.1 (four output events), with a PGOutputWriter: the final
    state and means within STEP_LIMIT, the same steps and nme, the same
    files, each .bas within float32 rounding."""
    import os
    import tempfile
    from msom_tpu_torch import driver
    from msom_tpu_torch.io.bas import read_bas
    from msom_tpu_torch.models import mspg
    cfg = PGConfig(**{**PG_PHYSICS, **PG_CHECK, "nl": 4, "tend": 0.3,
                      "dtout": 0.1})
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for where in ("cpu", "cuda"):
            const = mspg.build_constants(cfg, device=where)
            writer = driver.PGOutputWriter(cfg, const,
                                           outdir=os.path.join(tmp, where))
            t0 = time.perf_counter()
            state = driver.run_pg(
                cfg, const=const, state=mspg.init_state(cfg, const,
                                                        b0=pg_ic(cfg)),
                hooks=driver.RunHooks(on_output=writer),
                sharded=where == "cuda")
            out[where] = (state, time.perf_counter() - t0)
        (cs, csec), (gs, gsec) = out["cpu"], out["cuda"]
        rels = {n: _rel(getattr(gs, n), getattr(cs, n))
                for n in ("b", "ux", "uy", "b_me", "ux_me", "uy_me")}
        files = sorted(os.listdir(os.path.join(tmp, "cpu")))
        same = files == sorted(os.listdir(os.path.join(tmp, "cuda")))
        bas_rel = 0.0
        for name in (n for n in files if same and n.endswith(".bas")):
            bas_rel = max(bas_rel, _rel(
                read_bas(os.path.join(tmp, "cuda", name))[0],
                read_bas(os.path.join(tmp, "cpu", name))[0]))
    good = (all(r <= STEP_LIMIT for r in rels.values()) and same
            and bas_rel <= 2.0 ** -23 and int(gs.i) == int(cs.i)
            and int(gs.nme) == int(cs.nme) and len(files) == 9)
    print(f"pgshard run_pg check {cfg.N}^2 x {cfg.nl} f64, {int(gs.i)} "
          f"steps, sharded on the card (world size 1, NCCL, {gsec:.2f} s) "
          f"vs unsharded on the cpu ({csec:.2f} s): "
          + ", ".join(f"rel {k} = {v:.3e}" for k, v in rels.items())
          + f" (limit {STEP_LIMIT:g}); {len(files)} files, same names "
          f"{same}, .bas {bas_rel:.3e} of max (limit 2^-23) "
          f"{'ok' if good else 'FAIL'}")
    return good


def pgshard_path(PGConfig):
    """bench.py's mspg row (64^2 x 30 f32) after 120 unsharded spin-up
    steps from rest: the rows-sharded step at world size 1 beside the
    unsharded step in turns (_shard_pair); no kernel on either side."""
    import torch
    from msom_tpu_torch.models import mspg
    from msom_tpu_torch.parallel.pg_step import make_pg_step_sharded
    cfg = PGConfig(**PG_PHYSICS, **PG_PATH)
    label = f"pgshard mspg {cfg.N}^2 x {cfg.nl} f32"
    const = mspg.build_constants(cfg, device="cuda")
    state = mspg.init_state(cfg, const)
    step = mspg.make_step(cfg)
    for _ in range(120):
        state, _ = step(state, const, 1e18)
    rs = make_pg_step_sharded(cfg)
    runs = {"unsharded": (step, const, state),
            "pgshard": (rs.step, rs.shard(const), rs.shard(state))}
    res = _shard_pair(label, runs)

    def final(r):
        st = r["state"]
        finite = all(bool(torch.isfinite(getattr(st, n)).all())
                     for n in ("b", "ux", "uy")) and r["diag"].dt.item() > 0
        return finite, "", f", after {int(st.i)} steps finite {finite}"

    ok = _shard_report(label, res, {"unsharded": {}, "pgshard": {}},
                       final=final)
    g = rs.gather(res["pgshard"]["state"])
    u = res["unsharded"]["state"]
    rels = {n: _rel(getattr(g, n), getattr(u, n)) for n in ("b", "ux", "uy")}
    print(f"{label}: the states after the same steps, sharded against "
          "unsharded " + ", ".join(f"rel {k} = {v:.3e}"
                                   for k, v in rels.items()) + " (f32)")
    return ok


def k7_checks(periodic, shapes):
    """K7 against its plain version, the cuBLAS chain, f64 and f32, at each
    (N, nl) of `shapes`, on the DST-II basis or (periodic) the Fourier
    basis (build_spectral(periodic=True, transform="matmul",
    fused_mm=True): fourier_matrix and the naturally ordered inv_den); in
    f32 also its error against the f64 chain, within K7_F64_RATIO times the
    FP32 chain's. Returns (ok, the errors at 1024^2 x 4 f32: "fused_spectral"
    max|d psi_m| and "fused_spectral_f64" (kernel, chain) against f64)."""
    import torch
    from msom_tpu_torch.solvers import fused_spectral, spectral
    ok, errs = True, {}
    for dtype in ("float64", "float32"):
        isz = 8 if dtype == "float64" else 4
        for N, nl in shapes:
            spec = spectral.build_spectral(
                nl=nl, N=N, L0=80.0, dh=np.full(nl, 1.0 / nl),
                s_profile=np.full(nl - 1, (0.003 / 0.025) ** 2),
                periodic=periodic, dtype=getattr(torch, dtype),
                transform="matmul", fused_mm=True, device="cuda")
            qm = torch.as_tensor(np.random.default_rng(N + nl)
                                 .standard_normal((nl, N, N)),
                                 dtype=getattr(torch, dtype), device="cuda")
            before = fused_spectral.launches
            pm_k = fused_spectral.fused_mm_solve(spec.S, spec.inv_den, qm,
                                                 spec.mm)
            pm_r = spectral._mm_solve(spec.S, spec.inv_den, qm)
            torch.cuda.synchronize()
            abs_err = (pm_k - pm_r).abs().max().item()
            scale = pm_r.abs().max().item()
            rel = abs_err / scale
            good = (rel <= K7_LIMITS[isz]
                    and fused_spectral.launches == before + 4)
            extra = ""
            if dtype == "float32":
                # both against the f64 chain: the 3-pass TF32 split within
                # K7_F64_RATIO of the FP32 chain's own error
                pm_d = spectral._mm_solve(spec.S.double(),
                                          spec.inv_den.double(), qm.double())
                e_k = (pm_k - pm_d).abs().max().item() / scale
                e_r = (pm_r - pm_d).abs().max().item() / scale
                good &= e_k <= K7_F64_RATIO * e_r
                extra = (f", against the f64 chain: kernel {e_k:.3e}, "
                         f"cuBLAS FP32 {e_r:.3e}, ratio {e_k / e_r:.2f} "
                         f"(limit {K7_F64_RATIO:g})")
                if (N, nl) == (1024, 4):
                    errs["fused_spectral"] = abs_err
                    errs["fused_spectral_f64"] = (e_k, e_r)
                del pm_d
            ok &= good
            print(f"K7 {'Fourier-basis ' if periodic else ''}check {dtype} "
                  f"N={N} nl={nl}: max|d psi_m|/max|psi_m| = {rel:.3e} "
                  f"(limit {K7_LIMITS[isz]:g}){extra} "
                  f"{'ok' if good else 'FAIL'}")
            del spec, qm, pm_k, pm_r
    return ok, errs


# ---------------------------------------------------------------------------
# the tendency API (api) and the f32 validation of the main path (f32val)
# ---------------------------------------------------------------------------

# every irreversible term on, so that direction = -1 flips each of them
API_PHYSICS = dict(Re=500.0, Eks=0.001)
# AB3's stability interval on the negative real axis ends near -0.545; the
# clamped DT puts the biharmonic's fastest mode at -1, so bfn_integrate
# steps a quarter of it
BFN_DT_FRAC = 0.25
BFN_NUDGE = 0.5           # nudging rate toward the observed q
PG_NK = dict(N=8, nl=3, ys=0.3, r=0.05, tau_s=3e-2, tau0=0.05, kv=5e-4,
             kh=5e-4, omega=0.2, DT=5e-3, dtype="float64")
PG_NK_SPINUP = 400        # tests/test_api_analysis.py's warm start
BAS_SNAPSHOTS = 3
# GOLDEN.md:169-208: the f32 run's KE mean over the last 1000 steps within
# 1% of the f64 truth's, the final spectrum's ratio median in 0.97-1.03
F32VAL_TRUTH = "tools/f32val_float64_cpu.npz"
F32VAL_START, F32VAL_STEPS, F32VAL_WINDOW = 100, 3000, 1000
F32VAL_KE_BAR, F32VAL_SPEC_BAR = 0.01, (0.97, 1.03)


def api_kernel_checks(QGConfig, rows):
    """K1 (and with tracers K2) on the tendency route: api.qg_tendency on
    the card against the same call routed to K1's plain version
    (const.rhs_kernel False) and K2's plain version of the same psi, at
    bench's uncoupled 2048^2 x 4 f32 and the coupled configuration with
    two tracers, direction = +1 and -1, within LIMITS; the irreversible
    half (fwd - bwd)/2 must be large enough that a flip the kernel missed
    would show. Then qg_tendency on the card against the CPU in f64 at
    128^2 x 3 (the Verron physics with Re and Eks on; with the coupling
    and two tracers too), each direction, within STEP_LIMIT. Appends K2's
    record on the route; returns (ok, K1's largest f32 error)."""
    import torch
    from msom_tpu_torch import api
    from msom_tpu_torch.models import fused_tracer, qg
    N, nl = 2048, 4
    ok, k1_err = True, 0.0
    for label in ("uncoupled", "coupled"):
        coupled = label == "coupled"
        cfg = bench_config(QGConfig, N, nl, "float32", **API_PHYSICS,
                           **(TRACERS if coupled else {}))
        const = qg.build_constants(
            cfg, device="cuda", **(coupled_fields(cfg) if coupled else {}))
        plain = dataclasses.replace(const, rhs_kernel=False)
        rng = np.random.default_rng(1)
        psi0 = 1e-3 * rng.uniform(-1, 1, (nl, N, N))
        tr0 = 1e-3 * rng.uniform(-1, 1, (nl, cfg.nptr, N, N)) \
            if coupled else None
        state = qg.init_state(cfg, const, psi0=psi0, tracers0=tr0)
        q, tr = state.q, state.tracers
        out = {}
        reset_counts()
        for d in (1.0, -1.0):
            out[d] = api.qg_tendency(cfg, const, q, d, tracers=tr)
        launched = kernel_counts()
        torch.cuda.synchronize()
        want = {"K1": 2, "K2": 2 if coupled else 0}
        good = all(launched[k] == want.get(k, 0) for k in launched)
        for d in (1.0, -1.0):
            got = out[d] if coupled else (out[d],)
            c = api.signed_config(cfg, d)
            ref = [api.qg_tendency(cfg, plain, q, d)]
            if coupled:
                ref.append(fused_tracer.tracer_fused_reference(
                    c, const, api.q_to_psi(c, const, q), tr))
            for name, g, r in zip(("K1", "K2"), got, ref):
                err = (g - r).abs().max().item()
                rel = err / r.abs().max().item()
                good &= rel <= LIMITS[4]
                if name == "K1":
                    k1_err = max(k1_err, err)
                print(f"api {name} {label} {N}^2 x {nl} f32 direction "
                      f"{d:+.0f}: max|d out|/max|out| = {rel:.3e} (limit "
                      f"{LIMITS[4]:g})")
        fwd, bwd = (out[d][0] if coupled else out[d] for d in (1.0, -1.0))
        share = (0.5 * (fwd - bwd)).abs().max().item() \
            / fwd.abs().max().item()
        good &= share >= 10 * LIMITS[4]
        print(f"api tendency route {label}: launches "
              + ", ".join(f"{k} {v}" for k, v in launched.items())
              + f" in two calls; irreversible share max|fwd - bwd|/2 / "
              f"max|fwd| = {share:.3e} (at least {10 * LIMITS[4]:g}) "
              f"{'ok' if good else 'FAIL'}")
        ok &= good
        if good and coupled:
            psi = api.q_to_psi(cfg, const, q)
            row = _kernel_row(
                "api coupled", "fused_tracer",
                lambda: fused_tracer.tracer_fused(cfg, const, psi, tr),
                lambda: fused_tracer.tracer_fused_reference(cfg, const, psi,
                                                            tr),
                fused_tracer.bound_work(cfg, const, 4), launched["K2"],
                fused_tracer.SOURCE, "msom_tpu/models/pallas_rhs.py:778",
                "qg_tendency with tracers, directions +1 and -1")
            if row is None:
                return False, k1_err
            rows.append(row)
            del psi
        del const, plain, state, q, tr, out, fwd, bwd
        torch.cuda.empty_cache()
    if not ok:
        return False, k1_err

    # the card against the CPU, f64, 128^2 x 3
    for label, coupled in (("uncoupled", False), ("coupled", True)):
        cfg = verron(QGConfig, 128, **API_PHYSICS,
                     **(TRACERS if coupled else {}))
        rng = np.random.default_rng(2)
        psi0 = 1e-3 * rng.uniform(-1, 1, (cfg.nl, 128, 128))
        tr0 = 1e-3 * rng.uniform(-1, 1, (cfg.nl, cfg.nptr, 128, 128)) \
            if coupled else None
        res = {}
        for where in ("cpu", "cuda"):
            const = qg.build_constants(
                cfg, device=where, **(coupled_fields(cfg) if coupled
                                      else {}))
            state = qg.init_state(cfg, const, psi0=psi0, tracers0=tr0)
            res[where] = {d: api.qg_tendency(cfg, const, state.q, d,
                                             tracers=state.tracers)
                          for d in (1.0, -1.0)}
        rels = []
        for d in (1.0, -1.0):
            pairs = zip(res["cuda"][d], res["cpu"][d]) if coupled \
                else [(res["cuda"][d], res["cpu"][d])]
            rels += [_rel(g, w) for g, w in pairs]
        good = max(rels) <= STEP_LIMIT
        print(f"api qg_tendency {label} 128^2 x 3 f64 cuda vs cpu, "
              f"directions +1 and -1: rel " + ", ".join(f"{r:.3e}"
                                                        for r in rels)
              + f" (limit {STEP_LIMIT:g}) {'ok' if good else 'FAIL'}")
        ok &= good
    return ok, k1_err


def bfn_path(QGConfig, rows, k1_err):
    """bfn_integrate at bench's uncoupled 2048^2 x 4 f32: the bare
    make_step first (20 warm-up steps, timed_rounds, a four-step profile),
    whose final q is the observation; then from the state after the
    warm-up, forward (direction +1, dt = BFN_DT_FRAC x the clamped DT,
    nudged toward the observation at BFN_NUDGE) and backward from the
    forward's end (direction -1, dt < 0, the nudge's sign flipped so that
    it still pulls toward the observation), each as timed_rounds of one
    bfn_integrate call of ROUND_STEPS AB3 steps, with K1's launches a
    step and a profile of one call. K1 alone on the backward's final psi
    (the flipped config) against its plain version and bound. Returns
    (ok, the forward's final psi)."""
    import torch
    from msom_tpu_torch import api
    from msom_tpu_torch.models import fused_rhs, qg
    N, nl, warm = 2048, 4, 20
    shape = (nl, N, N)
    cfg = bench_config(QGConfig, N, nl, "float32")
    const = qg.build_constants(cfg, device="cuda")
    psi0 = 1e-3 * np.random.default_rng(0).uniform(-1, 1, shape)
    state = qg.init_state(cfg, const, psi0=psi0)
    step = qg.make_step(cfg)
    for _ in range(warm):
        state, diag = step(state, const, 1e18)
    torch.cuda.synchronize()
    q_start = state.q.clone()
    box = [state, diag]

    def one_step():
        box[0], box[1] = step(box[0], const, 1e18)

    reset_counts()
    med_s, ms_s = timed_rounds(one_step)
    k1_bare = kernel_counts()["K1"]
    busy_s = sum(r[0] for r in kernel_profile("bare step", one_step, 4,
                                              med_s))
    finite = state_ok(box[0], box[1], shape)
    print(f"bfn bare make_step {N}^2 x {nl} f32 after {warm} warm-up steps: "
          + rounds_line(ms_s, med_s, busy_s)
          + f", K1 launches {k1_bare} over {ROUNDS * ROUND_STEPS} steps, "
          f"finite {finite}")
    if not finite:
        return False, None
    q_obs = box[0].q.clone()
    del box
    dt = BFN_DT_FRAC * cfg.dt_clamped()
    scale = q_obs.abs().max().item()

    def dist(q):
        return (q - q_obs).abs().max().item() / scale

    ok, qbox = True, [q_start]
    print(f"bfn: dt = {dt:.6e} ({BFN_DT_FRAC} x the clamped DT), nudging "
          f"rate {BFN_NUDGE}, max|q - q_obs|/max|q_obs| at the start "
          f"{dist(q_start):.4e}")
    launched_all = 0
    for label, d, sign in (("forward", 1.0, 1.0), ("backward", -1.0, -1.0)):
        def nudge(q, i, sign=sign):
            return sign * BFN_NUDGE * (q_obs - q)

        def one_call(d=d, sign=sign, nudge=nudge):
            qbox[0] = api.bfn_integrate(cfg, const, qbox[0], ROUND_STEPS,
                                        direction=d, dt=sign * dt,
                                        nudge_fn=nudge)

        reset_counts()
        med, ms = timed_rounds(one_call, steps=1)
        launched = kernel_counts()
        steps = ROUNDS * ROUND_STEPS
        per = [m / ROUND_STEPS for m in ms]
        busy = sum(r[0] for r in kernel_profile(f"bfn {label} (one call of "
                                                f"{ROUND_STEPS} AB3 steps)",
                                                one_call, 1, med))
        q = qbox[0]
        finite = bool(torch.isfinite(q).all())
        good = (finite and launched["K1"] == steps
                and all(v == 0 for k, v in launched.items() if k != "K1"))
        launched_all += launched["K1"]
        print(f"bfn {label} path {N}^2 x {nl} f32 (direction {d:+.0f}, "
              f"dt {sign * dt:+.6e}): "
              + rounds_line(per, med / ROUND_STEPS, busy / ROUND_STEPS)
              .replace("ms/step", "ms/AB3 step")
              + f"; K1 launches {launched['K1']} over {steps} AB3 steps "
              f"({launched['K1'] / steps:.2f} a step; expected 1), others "
              + ", ".join(f"{k} {v}" for k, v in launched.items()
                          if k != "K1")
              + f"; max|q - q_obs|/max|q_obs| {dist(q):.4e}, finite "
              f"{finite}; bare make_step {med_s:.4f} ms/step, ratio "
              f"{med / ROUND_STEPS / med_s:.4f} {'ok' if good else 'FAIL'}")
        ok &= good
    if not ok:
        return False, None
    c = api.signed_config(cfg, -1.0)
    psi_b = api.q_to_psi(c, const, qbox[0]).contiguous()
    row = _kernel_row(
        "api bfn backward", "fused_rhs",
        lambda: fused_rhs.rhs_fused(c, const, psi_b)[0],
        lambda: fused_rhs.rhs_fused_reference(c, const, psi_b)[0],
        fused_rhs.bound_work(c, const, 4), launched_all, fused_rhs.SOURCE,
        "msom_tpu/models/pallas_rhs.py:441",
        "qg_tendency in bfn_integrate, direction -1 (Re4 and Ekb "
        "flipped)")
    if row is None:
        return False, None
    row["max_abs_err"] = max(row["max_abs_err"], k1_err)
    rows.append(row)
    psi_f = api.q_to_psi(cfg, const, q_obs)
    del const, psi_b, qbox, q_obs, q_start
    torch.cuda.empty_cache()
    return True, psi_f


def pg_nk_check(PGConfig):
    """pg_steady_state on the card and on the CPU, f64, the test's small
    PG config (tests/test_api_analysis.py:124) warm-started by 400 CPU
    steps, the test's call (f_tol 1e-8, 40 iterations: the convection
    switch's Newton floor stops it first, and it returns its best
    iterate): seconds, Newton iterations (scipy's callback), final
    max|F| of each; pg_tendency on the card against the CPU at the start
    within STEP_LIMIT, and the card's solution below 0.15 of the start's
    residual (the test's contract)."""
    import warnings

    import torch
    from msom_tpu_torch import api
    from msom_tpu_torch.models import mspg
    cfg = PGConfig(**PG_NK)
    const = mspg.build_constants(cfg, device="cpu")
    state = mspg.init_state(cfg, const)
    step = mspg.make_step(cfg)
    big = torch.tensor(1e9, dtype=torch.float64)
    for _ in range(PG_NK_SPINUP):
        state, _ = step(state, const, big)
    x0 = api.pg_pack(state)
    res, F0 = {}, {}
    for where in ("cpu", "cuda"):
        const = mspg.build_constants(cfg, device=where)
        F0[where] = api.pg_tendency(cfg, const, x0)
        n = [0]

        def count(x, f, n=n):
            n[0] += 1

        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always", RuntimeWarning)
            sol = api.pg_steady_state(cfg, const, x0, f_tol=1e-8,
                                      maxiter=40, callback=count)
        secs = time.perf_counter() - t0
        r = np.abs(api.pg_tendency(cfg, const, sol)).max()
        stalled = any("best iterate" in str(w.message) for w in caught)
        res[where] = (secs, n[0], r, stalled, np.isfinite(sol).all())
    r0 = np.abs(F0["cpu"]).max()
    rel = np.abs(F0["cuda"] - F0["cpu"]).max() / r0
    good = (rel <= STEP_LIMIT and res["cuda"][4]
            and res["cuda"][2] < 0.15 * r0)
    print(f"api pg_steady_state {cfg.N}^2 x {cfg.nl} f64 (f_tol 1e-8, "
          f"maxiter 40, from {PG_NK_SPINUP} CPU steps, max|F| {r0:.6e}): "
          + "; ".join(f"{w} {s:.3f} s, {it} Newton iterations, final "
                      f"max|F| {r:.6e}, stalled at the Newton floor "
                      f"{st}" for w, (s, it, r, st, _) in res.items())
          + f"; pg_tendency cuda vs cpu at the start rel {rel:.3e} (limit "
          f"{STEP_LIMIT:g}) {'ok' if good else 'FAIL'}")
    return good


def async_writer_check(psi, L0):
    """AsyncBasWriter on the forward run's psi (4 x 2048^2 f32):
    BAS_SNAPSHOTS submissions (each a copy to the host, then the writer's
    copy) and a flush, beside io/bas.write_bas of one snapshot: seconds a
    snapshot, the submit's own seconds (what the step loop would wait),
    each file read back equal and byte for byte write_bas's."""
    import shutil
    import tempfile

    from msom_tpu_torch import native
    from msom_tpu_torch.io.bas import read_bas, write_bas
    t0 = time.perf_counter()
    native.load()
    build_s = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="chip_smoke_api_")
    try:
        ref = f"{tmp}/write_bas.bas"
        t0 = time.perf_counter()
        host = psi.cpu().numpy()
        write_bas(ref, host, L0)
        sync_s = time.perf_counter() - t0
        w = native.AsyncBasWriter()
        paths = [f"{tmp}/async{k}.bas" for k in range(BAS_SNAPSHOTS)]
        t0 = time.perf_counter()
        submit_s = 0.0
        for p in paths:
            t1 = time.perf_counter()
            w.submit(p, psi, L0)
            submit_s += time.perf_counter() - t1
        failed = w.flush()
        async_s = (time.perf_counter() - t0) / BAS_SNAPSHOTS
        w.close()
        want = open(ref, "rb").read()
        same = all(open(p, "rb").read() == want for p in paths)
        back = native.read_bas_native(paths[0])
        equal = bool(np.array_equal(back, host)
                     and np.array_equal(read_bas(paths[-1])[0], host))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    good = failed == 0 and same and equal
    print(f"api AsyncBasWriter {tuple(psi.shape)} f32 ({host.nbytes} B): "
          f"{async_s:.4f} s a snapshot over {BAS_SNAPSHOTS} (submit "
          f"{submit_s / BAS_SNAPSHOTS:.4f} s of it, the copy to the host "
          f"included), io/bas.write_bas {sync_s:.4f} s; the library's "
          f"load or build {build_s:.2f} s; failed writes {failed}, files "
          f"byte for byte write_bas's {same}, read back equal {equal} "
          f"{'ok' if good else 'FAIL'}")
    return good


def f32val_check(QGConfig):
    """The f32 validation of the main path: the Verron 256^2 x 3 double gyre
    (tools/f32_validation.py:33-36) in f32 on the card from the f64
    truth's q at step 100 (tools/f32val_float64_cpu.npz; psi from
    api.q_to_psi in f64, t = the sum of the truth's first 100 dt, dt_prev
    = its dt[99]: the step's dt, where the state it came from held the
    corrector's smoothed CFL value, which the truth does not store) to
    step 3000. The KE mean over the last 1000 steps against the truth's,
    and the surface layer's ke_spectrum against the truth's final psi's
    over the bins above 1e-6 of its peak: GOLDEN.md's bar, KE mean within
    1% and the ratio's median within 0.97-1.03. Also q's drift from the
    truth's snapshots (GOLDEN.md's trajectory table), printed only: f32
    trajectories part from f64 ones by chaos."""
    import os

    import torch
    from msom_tpu_torch import analysis, api
    from msom_tpu_torch.models import qg
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        F32VAL_TRUTH)
    truth = np.load(path)
    cfg32, cfg64 = (verron(QGConfig, 256, dtype=t, tend=1e18, dtout=1e18)
                    for t in ("float32", "float64"))
    q100 = torch.as_tensor(truth[f"q_{F32VAL_START}"]).cuda()
    const64 = qg.build_constants(cfg64, device="cuda")
    psi100 = api.q_to_psi(cfg64, const64, q100)
    del const64
    const = qg.build_constants(cfg32, device="cuda")
    dts = truth["dt"]

    def scalar(v, dtype=torch.float32):
        return torch.tensor(v, dtype=dtype, device="cuda")

    state = qg.QGState(q=q100.float().contiguous(),
                       psi=psi100.float().contiguous(),
                       t=scalar(dts[:F32VAL_START].sum()),
                       dt_prev=scalar(dts[F32VAL_START - 1]),
                       i=scalar(F32VAL_START, torch.int32))
    step = qg.make_step(cfg32)
    kes, dt_run, snaps = [], [], {}
    n = F32VAL_STEPS - F32VAL_START
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for k in range(F32VAL_START + 1, F32VAL_STEPS + 1):
        state, diag = step(state, const, 1e18)
        kes.append(diag.ke)
        dt_run.append(diag.dt)
        if f"q_{k}" in truth.files:
            snaps[k] = state.q.clone()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / n
    ke = torch.stack(kes).double().cpu().numpy()
    dt_run = torch.stack(dt_run).double().cpu().numpy()
    w = F32VAL_WINDOW
    ke_err = ke[-w:].mean() / truth["ke"][-w:].mean() - 1.0
    delta = cfg32.delta
    _, E32 = analysis.ke_spectrum(state.psi[0], delta)
    _, E64 = analysis.ke_spectrum(truth["psi_final"][0], delta)
    m = E64 > E64.max() * 1e-6
    rat = E32[m] / E64[m]
    med = float(np.median(rat))
    finite = bool(torch.isfinite(state.q).all()) and np.isfinite(ke).all()
    drift = {k: _rel(v, truth[f"q_{k}"]) for k, v in snaps.items()}
    good = (finite and abs(ke_err) <= F32VAL_KE_BAR
            and F32VAL_SPEC_BAR[0] <= med <= F32VAL_SPEC_BAR[1])
    print(f"f32val Verron 256^2 x 3 f32 on the card, steps "
          f"{F32VAL_START}-{F32VAL_STEPS} from the f64 truth's q_"
          f"{F32VAL_START}: {ms:.4f} ms/step, t {state.t.item():.6f} "
          f"(truth {float(truth['t_final']):.6f}); KE mean of the last {w} "
          f"steps {ke[-w:].mean():.6e} against {truth['ke'][-w:].mean():.6e}"
          f" (error {ke_err:+.4%}, bar {F32VAL_KE_BAR:.0%}), std "
          f"{ke[-w:].std():.4e} against {truth['ke'][-w:].std():.4e}, dt "
          f"mean {dt_run[-w:].mean():.6e} against "
          f"{truth['dt'][-w:].mean():.6e}; surface KE spectrum ratio over "
          f"{int(m.sum())} bins above 1e-6 of the peak: median {med:.4f} "
          f"(bar {F32VAL_SPEC_BAR[0]}-{F32VAL_SPEC_BAR[1]}), range "
          f"{rat.min():.4f}-{rat.max():.4f}; q's drift from the truth "
          f"max|dq|/max|q| " + ", ".join(f"step {k} {v:.3e}"
                                         for k, v in drift.items())
          + f"; finite {finite} "
          f"{'ok' if good else 'FAIL (a finding: ROADMAP.md section 3)'}")
    return good


# the bf16 + refinement solve (phase name refine)
REFINE_SIZES = (256, 512, 1024, 2048)
# the card's bf16 pass against its plain emulation (the same bf16
# operands, the products summed in another order) on a seeded normal q_m,
# relative RMS difference of p_m: where a float32 partial sum falls on the
# other side of a bf16 rounding boundary, the next stage's operand differs
# by one bf16 ulp in that element. A first limit of 3e-4 failed on the card
# at N = 2048 (3.3e-4): the tensor cores' sums and cuBLAS's float32 ones
# part further than two float32 orders do on the CPU. A pass that rounded
# its outputs to bf16, or skipped the bf16 operands, would differ by about
# 2^-9 in every element: REFINE_PASS_MARGIN holds the card's pass that much
# closer to its emulation than to the full-float32 chain.
REFINE_PASS_LIMIT = 1e-3
REFINE_PASS_MARGIN = 3.0
REFINE_F64_LIMIT = 1e-10     # float64 refine solve: card vs CPU, sharded
REFINE_TIMINGS = 25          # CUDA-event timings of a solve, the median
PEAK_BF16_OPS_PER_S = 989e12  # bf16 on the tensor cores, dense


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return smi.stdout.strip().splitlines()[0]


def refine_pass_error(spec, qm):
    """(relative RMS, relative max) difference of the card's bf16 pass
    (spectral.refine_pass on a CUDA float32 tensor) from its plain
    emulation (spectral.refine_pass_reference) on the same qm, and the
    relative RMS difference of the card's pass from the full-float32
    chain (spectral._mm_solve)."""
    from msom_tpu_torch.solvers import spectral
    got = spectral.refine_pass(spec, qm).double()
    want = spectral.refine_pass_reference(spec, qm).double()
    f32 = spectral._mm_solve(spec.S, spec.inv_den, qm).double()
    d = got - want
    return (float(d.norm() / want.norm()),
            float(d.abs().max() / want.abs().max()),
            float((got - f32).norm() / f32.norm()))


def refine_pass_ok(rms, rms_f32):
    """Whether the card's bf16 pass agrees with its emulation on a normal
    q_m: within REFINE_PASS_LIMIT and REFINE_PASS_MARGIN times closer to
    it than to the full-float32 chain."""
    return rms <= REFINE_PASS_LIMIT and rms * REFINE_PASS_MARGIN <= rms_f32


def refine_problem(N, nl=4, seed=0):
    """tools/refine_error.py's problem (:73-84) on the card: L0 = 80, equal
    dh, stretching (0.003/0.025)^2 at every interface, q = L(psi_t) of a
    seeded normal psi_t in float64. Returns (build_spectral's keywords,
    q, L as a function of psi in float64)."""
    import torch
    from msom_tpu_torch.ops.bc import BC
    from msom_tpu_torch.ops.ghost import ghosted, laplacian_g
    from msom_tpu_torch.ops.stretch import layer_metrics, stretch
    dh = np.full(nl, 1.0 / nl)
    sprof = np.full(nl - 1, (0.003 / 0.025) ** 2)
    _, idh0, idh1 = layer_metrics(dh)
    h = 80.0 / N
    strl = torch.as_tensor(sprof, device="cuda")[:, None, None]

    def op(psi):
        psi = psi.double()
        return (laplacian_g(ghosted(psi, BC.DIRICHLET), h)
                + stretch(psi, strl, idh0, idh1))

    psi_t = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (nl, N, N)), device="cuda")
    kw = dict(nl=nl, N=N, L0=80.0, dh=dh, s_profile=sprof, device="cuda")
    return kw, op(psi_t), op


def refine_checks(card):
    """The refine phase's gates: the float64 refine solve on the card
    against the CPU (256^2 x 4, walled and periodic) within
    REFINE_F64_LIMIT, and at world size 1 under NCCL the sharded refine
    solve on the (1, 1) mesh against the unsharded one, the same."""
    import torch
    from msom_tpu_torch.parallel import spectral_shard
    from msom_tpu_torch.parallel.mesh import make_mesh
    from msom_tpu_torch.solvers import spectral
    N, nl = 256, 4
    mesh = make_mesh((1, 1))
    q = torch.as_tensor(np.random.default_rng(1).standard_normal((nl, N, N)))
    ok = True
    for periodic in (False, True):
        kw = dict(refine_problem(N, nl)[0], periodic=periodic,
                  transform="matmul", refine=True, dtype=torch.float64)
        spec = spectral.build_spectral(**kw)
        got = spectral.solve_spectral(spec, q.cuda())
        want = spectral.solve_spectral(
            spectral.build_spectral(**dict(kw, device="cpu")), q)
        shard = spectral_shard.solve_spectral_sharded(
            spectral_shard.mesh_data(spec, mesh), q.cuda())
        e_cpu, e_shard = _rel(got, want), _rel(shard, got)
        good = e_cpu <= REFINE_F64_LIMIT and e_shard <= REFINE_F64_LIMIT
        ok &= good
        print(f"refine f64 {N}^2 x {nl} {'periodic' if periodic else 'walled'}"
              f": the card against the CPU {e_cpu:.3e}, the sharded solve "
              f"(world 1, NCCL, (1, 1) mesh) against the unsharded "
              f"{e_shard:.3e} (limit {REFINE_F64_LIMIT:g}) on {card} "
              f"{'ok' if good else 'FAIL'}")
    return ok


def refine_path(QGConfig, card):
    """The bf16 + refinement solve on the card at N = REFINE_SIZES, nl = 4,
    f32: the bf16 pass against its plain emulation on a seeded normal q_m
    (gated: refine_pass_ok) and, recorded, on refine_problem's q_m (which
    the transforms' cancellation makes ill-conditioned); each mode's
    solution error and
    residual against the float64 basis-matmul solve on the card (recorded,
    not gated): the f32 "auto" (the fold at N >= 512), the f32 basis
    matmul, one bf16 pass, refine. At 2048^2 x 4 each mode's solve time
    (the median of REFINE_TIMINGS CUDA-event timings) and one pass's
    against its bf16 bound. Then bench's uncoupled configuration at
    2048^2 x 4 f32 with the refine constants beside the fold step: one
    step of each from the same state, 20 warm-up steps each, ROUNDS
    rounds of ROUND_STEPS steps in turns, K1's launches, busy and idle
    share (four-step profiles), finite states."""
    import torch
    from msom_tpu_torch.models import qg
    from msom_tpu_torch.solvers import spectral
    f32 = torch.float32
    ok = True
    for N in REFINE_SIZES:
        kw, q, op = refine_problem(N)
        psi_ref = spectral.solve_spectral(spectral.build_spectral(
            dtype=torch.float64, transform="matmul", **kw), q)
        specs = {"auto": spectral.build_spectral(dtype=f32, **kw),
                 "matmul": spectral.build_spectral(dtype=f32,
                                                   transform="matmul", **kw),
                 "refine": spectral.build_spectral(
                     dtype=f32, transform="matmul", refine=True, **kw)}
        ref = specs["refine"]
        q32 = q.float()

        def one_pass(q32):
            qm = torch.einsum("ml,lyx->myx", ref.l2m, q32)
            return torch.einsum("lm,myx->lyx", ref.m2l,
                                spectral.refine_pass(ref, qm))

        solves = {"auto": lambda q: spectral.solve_spectral(specs["auto"], q),
                  "matmul": lambda q: spectral.solve_spectral(
                      specs["matmul"], q),
                  "bf16": one_pass,
                  "refine": lambda q: spectral.solve_spectral(ref, q)}
        qm = torch.as_tensor(np.random.default_rng(N).standard_normal(
            (4, N, N)), dtype=f32, device="cuda")
        rms, mx, rms_f32 = refine_pass_error(ref, qm)
        good = refine_pass_ok(rms, rms_f32)
        ok &= good
        print(f"refine {N}^2 x 4: the bf16 pass against its plain emulation "
              f"on a normal q_m: relative RMS {rms:.3e} (limit "
              f"{REFINE_PASS_LIMIT:g}), max {mx:.3e}; against the float32 "
              f"chain RMS {rms_f32:.3e} (at least {REFINE_PASS_MARGIN:g} "
              f"times the first) on {card} {'ok' if good else 'FAIL'}")
        qm = torch.einsum("ml,lyx->myx", ref.l2m, q32)
        rms, mx, rms_f32 = refine_pass_error(ref, qm)
        print(f"refine {N}^2 x 4: the bf16 pass against its plain emulation "
              f"on the problem's q_m (recorded): relative RMS {rms:.3e}, max "
              f"{mx:.3e}; against the float32 chain RMS {rms_f32:.3e} on "
              f"{card}")
        scale, q_scale = psi_ref.abs().max(), q.abs().max()
        for name, fn in solves.items():
            psi = fn(q32).double()
            err = float((psi - psi_ref).abs().max() / scale)
            res = float((q - op(psi)).abs().max() / q_scale)
            print(f"refine error at {N}^2 x 4 f32 {name}: solution {err:.4e}"
                  f", residual {res:.4e} (against the f64 matmul solve on "
                  f"the card) on {card}")
        if N == REFINE_SIZES[-1]:
            for name, fn in solves.items():
                for _ in range(3):
                    fn(q32)
                ms = [cuda_ms(lambda: fn(q32), 1)
                      for _ in range(REFINE_TIMINGS)]
                print(f"refine solve time at {N}^2 x 4 f32 {name}: median "
                      f"{np.median(ms):.4f} ms of {len(ms)} (range "
                      f"{min(ms):.4f}-{max(ms):.4f}) on {card}")
            flops = 4 * 4 * 2 * N ** 3       # four GEMM stages, 4 layers
            bound = flops / PEAK_BF16_OPS_PER_S * 1e3
            p_ms = cuda_ms(lambda: spectral.refine_pass(ref, qm), 20)
            e_ms = cuda_ms(lambda: spectral.refine_pass_reference(ref, qm), 5)
            print(f"refine bf16 pass at {N}^2 x 4: {p_ms:.4f} ms, plain "
                  f"emulation {e_ms:.4f} ms, bound {bound:.4f} ms "
                  f"({flops:.4e} operations, bf16 tensor cores) on {card}")
        del specs, ref, psi_ref, q, q32, qm
        torch.cuda.empty_cache()
    if not ok:
        return False

    # the msqg step on the refine constants at full width
    N, nl, warm = 2048, 4, 20
    shape = (nl, N, N)
    cfg = bench_config(QGConfig, N, nl, "float32")
    const = qg.build_constants(cfg, device="cuda")
    rconst = dataclasses.replace(const, spec=spectral.build_spectral(
        nl=nl, N=N, L0=cfg.L0, dh=np.asarray(cfg.dh[:nl]),
        s_profile=const.strl[:, 0, 0].double().cpu().numpy(), dtype=f32,
        transform="matmul", refine=True, device="cuda"))
    psi0 = 1e-3 * np.random.default_rng(0).uniform(-1, 1, shape)
    s0 = qg.init_state(cfg, const, psi0=psi0)
    step = qg.make_step(cfg)
    s_f, _ = step(s0, const, 1e18)
    s_r, _ = step(s0, rconst, 1e18)
    print(f"refine step: one step from the noise IC, max|psi_refine - "
          f"psi_fold|/max|psi_fold| {_rel(s_r.psi, s_f.psi):.4e}, q "
          f"{_rel(s_r.q, s_f.q):.4e} on {card}")
    boxes = {"fold": [s0, const, None], "refine": [s0, rconst, None]}

    def stepper(box):
        def one_step():
            box[0], box[2] = step(box[0], box[1], 1e18)
        return one_step

    steps = {k: stepper(b) for k, b in boxes.items()}
    for _ in range(warm):
        steps["fold"]()
        steps["refine"]()
    torch.cuda.synchronize()
    ms = {"fold": [], "refine": []}
    launched = dict.fromkeys(kernel_counts(), 0)
    for _ in range(ROUNDS):
        ms["fold"].append(cuda_ms(steps["fold"], ROUND_STEPS))
        c0 = kernel_counts()
        ms["refine"].append(cuda_ms(steps["refine"], ROUND_STEPS))
        c1 = kernel_counts()
        for k in launched:
            launched[k] += c1[k] - c0[k]
    n_steps = ROUNDS * ROUND_STEPS
    for name in ("refine", "fold"):
        box = boxes[name]
        med = float(np.median(ms[name]))
        busy = sum(r[0] for r in kernel_profile(f"{name} step", steps[name],
                                                4, med))
        finite = state_ok(box[0], box[2], shape)
        good = finite
        extra = ""
        if name == "refine":
            good &= (launched["K1"] == 2 * n_steps
                     and all(v == 0 for k, v in launched.items()
                             if k != "K1"))
            extra = (f", kernel launches over {n_steps} steps "
                     + ", ".join(f"{k} {v}" for k, v in launched.items())
                     + f" ({launched['K1'] / n_steps:.2f} K1 a step)")
        ok &= good
        print(f"refine path {N}^2 x {nl} f32 {name} step after {warm} "
              f"warm-up steps, rounds in turns: " + rounds_line(ms[name], med,
                                                                 busy)
              + f"{extra}, ke {box[2].ke.item():.6e}, dt "
              f"{box[2].dt.item():.6e}, finite {finite} on {card} "
              f"{'ok' if good else 'FAIL'}")
    print(f"refine path: the final psi of the two runs (the same steps) "
          f"differ by {_rel(boxes['refine'][0].psi, boxes['fold'][0].psi):.4e}"
          f" of max|psi| on {card}")
    return ok


def entry_check():
    """entry()'s 256^2 x 3 f32 forward step on the card against the same
    state and step on the CPU: q, psi and the KE within LIMITS[4] of their
    maxima; the card's step time (CUDA events, after one warm-up call)."""
    import torch
    from msom_tpu_torch import entry
    fn, (state, const, tnext) = entry.entry("cuda")
    fn(state, const, tnext)
    ms = cuda_ms(lambda: fn(state, const, tnext), 20)
    q, psi, ke = fn(state, const, tnext)
    cfn, (_, cconst, ctnext) = entry.entry("cpu")
    cstate = dataclasses.replace(state, **{
        f.name: getattr(state, f.name).cpu()
        for f in dataclasses.fields(state)
        if isinstance(getattr(state, f.name), torch.Tensor)})
    cq, cpsi, cke = cfn(cstate, cconst, ctnext)
    rels = dict(q=_rel(q, cq), psi=_rel(psi, cpsi),
                ke=abs(ke.item() - cke.item()) / abs(cke.item()))
    good = (bool(torch.isfinite(ke)) and tuple(q.shape) == (3, 256, 256)
            and all(r <= LIMITS[4] for r in rels.values()))
    print(f"dryrun entry(): the msqg forward step at 256^2 x 3 f32 on the "
          f"card {ms:.4f} ms a call, ke {ke.item():.6e}; against the same "
          f"state and step on the CPU "
          + ", ".join(f"rel {k} = {v:.3e}" for k, v in rels.items())
          + f" (limit {LIMITS[4]:g}) {'ok' if good else 'FAIL'}")
    return good


def dryrun_check():
    """dryrun_multichip at world size 1 under NCCL (the group is the
    caller's), float32 then float64: every mode's KE, deviation from the
    unsharded step on the card (float64 within STEP_LIMIT), seconds, and
    every kernel's launches over each dry run (rows_kernel's K1 rows and
    K2 rows among them)."""
    from msom_tpu_torch import entry
    ok = True
    for dtype in ("float32", "float64"):
        t0 = time.perf_counter()
        reset_counts()
        res = entry.dryrun_multichip("cuda", dtype=dtype)
        counts = {k: v for k, v in kernel_counts().items() if v}
        k1r, k2r = (res["modes"]["rows_kernel"]["launches"][k]
                    for k in ("K1rows", "K2rows"))
        seconds = time.perf_counter() - t0
        for name, r in res["modes"].items():
            good = dtype == "float32" or r["rel"] <= STEP_LIMIT
            ok &= good
            print(f"dryrun {dtype} {name}: ke {r['ke']:.6e}, {r['taken']} "
                  f"on {r['mesh'][0]}x{r['mesh'][1]}, against the unsharded "
                  f"step on the card {r['rel']:.3e}"
                  + (f" (limit {STEP_LIMIT:g})" if dtype == "float64"
                     else "") + f", {r['seconds']:.2f} s "
                  f"{'ok' if good else 'FAIL'}")
        rows_ok = k1r > 0 and k2r > 0
        ok &= rows_ok
        print(f"dryrun {dtype}: {res['line']}; {seconds:.1f} s; launches "
              f"over the dry run "
              + (", ".join(f"{k} {v}" for k, v in counts.items()) or "none")
              + f"; rows_kernel K1 rows {k1r}, K2 rows {k2r} "
              f"{'ok' if rows_ok else 'FAIL'}")
    return ok


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from msom_tpu_torch import _build
    from msom_tpu_torch.models import fused_rhs, fused_tracer, qg
    from msom_tpu_torch.models.newqg import NewQGConfig
    from msom_tpu_torch.models.qg_node import NodeQGConfig
    from msom_tpu_torch.params import PGConfig, QGConfig
    from msom_tpu_torch.solvers import fused_mg, fused_spectral

    only = set(sys.argv[1:])
    if only - set(PHASES):
        print(f"chip_smoke: phases are {', '.join(PHASES)}", file=sys.stderr)
        return 1

    if only & {"paths", "fused_mm"}:
        only.add("kernels")      # their records carry the checks' errors

    def wanted(phase):
        return not only or phase in only

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t_start = time.perf_counter()

    # 1. build
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(sorted(logs))})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "entry function" in line:     # the kernel the lines below are
                line = line.split("'")[1]    # of, as its mangled name
            elif "registers" not in line and "spill" not in line:
                continue
            print(f"  {name}: {line.strip()}")

    # 2. each kernel against its plain version on the card
    main_err = {}
    ok = True
    if wanted("kernels"):
        good1, errs = k1_mode_checks(QGConfig, False,
                                     ("uncoupled",) + K1_OPTIONS)
        main_err.update({("fused_rhs", n): e for n, e in errs.items()})
        good2, main_err["fused_tracer"] = k2_checks(QGConfig, False)
        good7, errs = k7_checks(False, [(N, nl) for N in (128, 512, 1024)
                                        for nl in (1, 4)])
        main_err.update(errs)
        ok = good1 and good2 and good7
    if not ok:
        return 2
    print(f"kernel checks done at {time.perf_counter() - t_start:.0f} s")

    # 7a. the multigrid's kernels and a whole solve
    if wanted("mg"):
        good, mg_err = mg_kernel_checks()
        main_err.update(mg_err)
        if not (good and mg_solve_check()):
            return 7
        print(f"multigrid checks done at {time.perf_counter() - t_start:.0f} "
              "s")

    # 3. whole step, CUDA against CPU, f64: uncoupled and coupled; 7b. the
    # multigrid step, layered and modal
    checks = []
    if wanted("steps"):
        checks += [("uncoupled", verron(QGConfig, 128)),
                   ("coupled", verron(QGConfig, 128, **TRACERS))]
    if wanted("mg"):
        checks += [("mg", verron(QGConfig, 128, solver="mg")),
                   ("mg mode_pv_invert", verron(QGConfig, 128, solver="mg",
                                                mode_pv_invert=True))]
    for label, cfg in checks:
        if not step_check(QGConfig, label, cfg, coupled=label == "coupled"):
            return 3

    # 4 and 5. the uncoupled main path and the coupled path at full size
    N, nl, warm, steps = 2048, 4, 20, 40
    shape = (nl, N, N)
    rows = []
    for label in ("uncoupled", "coupled") if wanted("paths") else ():
        coupled = label == "coupled"
        cfg = bench_config(QGConfig, N, nl, "float32",
                           **(TRACERS if coupled else {}))
        t0 = time.perf_counter()
        const = qg.build_constants(
            cfg, device="cuda", **(coupled_fields(cfg) if coupled else {}))
        rng = np.random.default_rng(0)
        psi0 = 1e-3 * rng.uniform(-1, 1, shape)
        tr0 = 1e-3 * rng.uniform(-1, 1, (nl, cfg.nptr, N, N)) \
            if coupled else None
        state = qg.init_state(cfg, const, psi0=psi0, tracers0=tr0)
        step = qg.make_step(cfg)
        torch.cuda.synchronize()
        print(f"{label} path set-up: {time.perf_counter() - t0:.1f} s")
        for _ in range(warm):
            state, diag = step(state, const, 1e18)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fused_rhs.launches = fused_tracer.launches = 0
        fused_spectral.launches = 0
        fused_mg.sweep_launches = fused_mg.residual_launches = 0
        state, diag, ms_step = timed_steps(step, state, const, steps)
        n_rhs, n_tr = fused_rhs.launches, fused_tracer.launches
        want_tr = 2 * steps if coupled else 0
        finite = state_ok(state, diag, shape)
        print(f"{label} path {N}^2 x {nl} f32 spectral: {ms_step:.4f} "
              f"ms/step, {N * N * nl / (ms_step * 1e-3):.4e} grid-points/s, "
              f"fused_rhs launches {n_rhs} (expected {2 * steps}), "
              f"fused_tracer launches {n_tr} (expected {want_tr}), "
              f"ke {diag.ke.item():.6e}, dt {diag.dt.item():.6e}, "
              f"t {state.t.item():.6e}, finite {finite}, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if n_rhs != 2 * steps or n_tr != want_tr or not finite \
                or fused_spectral.launches != 0 \
                or fused_mg.sweep_launches or fused_mg.residual_launches:
            return 4

        psi = state.psi.contiguous()
        k_ms, p_ms = kernel_times(
            lambda: fused_rhs.rhs_fused(cfg, const, psi),
            lambda: fused_rhs.rhs_fused_reference(cfg, const, psi))
        nbytes, nops = fused_rhs.bound_work(cfg, const, 4)
        bound, by, t_b, t_o = roofline(nbytes, nops, 4)
        print(f"K1 {label} at {N}^2 x {nl} f32: kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms, bound {bound:.4f} ms by {by} (bytes "
              f"{nbytes} -> {t_b:.4f} ms, operations {nops} -> {t_o:.4f} "
              f"ms), {t_b / k_ms:.3f} of the byte bound, library_ms null")
        rows.append({
            "name": "fused_rhs", "path": f"{label} {N}^2 x {nl} f32",
            "route": "cuda", "source": fused_rhs.SOURCE,
            "replaces": "msom_tpu/models/pallas_rhs.py:441",
            "launches": n_rhs,
            # the coupled path's K1 runs the pg and topo options: the
            # larger of the two checks' errors at these shapes
            "max_abs_err": max(main_err["fused_rhs", "pg"],
                               main_err["fused_rhs", "topo"]) if coupled
            else main_err["fused_rhs", "uncoupled"],
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None})
        if coupled:
            tr = state.tracers
            k_ms, p_ms = kernel_times(
                lambda: fused_tracer.tracer_fused(cfg, const, psi, tr),
                lambda: fused_tracer.tracer_fused_reference(cfg, const, psi,
                                                            tr))
            nbytes, nops = fused_tracer.bound_work(cfg, const, 4)
            bound, by, t_b, t_o = roofline(nbytes, nops, 4)
            print(f"K2 (row-marching strip) at {N}^2 x {nl} x {cfg.nptr} "
                  f"tracers f32: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                  f"bound {bound:.4f} ms by {by} (bytes {nbytes} -> "
                  f"{t_b:.4f} ms, operations {nops} -> {t_o:.4f} ms), "
                  f"{t_b / k_ms:.3f} of the byte bound, library_ms null")
            rows.append({
                "name": "fused_tracer", "path": f"{label} {N}^2 x {nl} f32",
                "design": "row-marching strip",
                "route": "cuda", "source": fused_tracer.SOURCE,
                "replaces": "msom_tpu/models/pallas_rhs.py:778",
                "launches": n_tr, "max_abs_err": main_err["fused_tracer"],
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                "bound_by": by, "library_ms": None})
            del tr

        # where a step's device time goes
        box = [state]

        def one_step():
            box[0], _ = step(box[0], const, 1e18)

        kernel_profile(label, one_step, 4, ms_step)
        del const, state, psi, box
        torch.cuda.empty_cache()
    print(f"full-size paths done at {time.perf_counter() - t_start:.0f} s")

    # 6. the fused-solve path: 1024^2 x 4, K7 beside cuBLAS and the fold;
    # K7 on the periodic Fourier basis
    if wanted("fused_mm") and not (
            fused_mm_path(QGConfig, rows, main_err)
            and k7_checks(True, [(128, 4), (1024, 4)])[0]):
        return 5

    # 7c. the multigrid path at full width
    if wanted("mg"):
        if not mg_path(QGConfig, rows, main_err):
            return 7
        print(f"multigrid path done at {time.perf_counter() - t_start:.0f} s")

    # 8. the qg-node family
    if wanted("node"):
        good5, k5_err = node_kernel_checks(NodeQGConfig)
        good6, k6_err = vmg_kernel_checks()
        if not (good5 and good6 and vpoisson_check()
                and node_step_checks(NodeQGConfig)):
            return 8
        print(f"node checks done at {time.perf_counter() - t_start:.0f} s")
        if not node_paths(NodeQGConfig, rows, k5_err, k6_err):
            return 8
        print(f"node paths done at {time.perf_counter() - t_start:.0f} s")

    # 9. the doubly periodic msqg: K1's and K2's periodic modes, the steps,
    # the periodic coupled path
    if wanted("periodic"):
        good1, _ = k1_mode_checks(QGConfig, True,
                                  ("uncoupled",) + K1_PERIODIC_OPTIONS)
        good2, _ = k2_checks(QGConfig, True)
        per = dict(sbc=-1.0, upg=(0.02, 0.01, 0.0), vpg=(0.01, -0.005, 0.0))
        if not (good1 and good2
                and step_check(QGConfig, "periodic uncoupled",
                               verron(QGConfig, 128, sbc=-1.0))
                and step_check(QGConfig, "periodic coupled",
                               verron(QGConfig, 128, flsrv=1, **per,
                                      **TRACERS), coupled=True)
                and step_check(QGConfig, "periodic mg",
                               verron(QGConfig, 128, sbc=-1.0,
                                      solver="mg"))):
            return 9
        print(f"periodic checks done at {time.perf_counter() - t_start:.0f} "
              "s")
        if not periodic_path(QGConfig, rows):
            return 9
        print(f"periodic path done at {time.perf_counter() - t_start:.0f} s")

    # 10. the stochastic msqg: K1's stochastic mode, walled and periodic,
    # the step, bench.py's stochastic row
    if wanted("stochastic"):
        good_w, _ = k1_mode_checks(QGConfig, False, K1_STOCHASTIC_OPTIONS)
        good_p, _ = k1_mode_checks(QGConfig, True, K1_STOCHASTIC_OPTIONS)
        if not (good_w and good_p
                and step_check(QGConfig, "stochastic (amp_stoch = 0)",
                               verron(QGConfig, 128, stochastic=True,
                                      tr_stoch=50.0, amp_stoch=0.0))):
            return 10
        print(f"stochastic checks done at "
              f"{time.perf_counter() - t_start:.0f} s")
        if not stochastic_path(QGConfig, rows):
            return 10
        print(f"stochastic path done at {time.perf_counter() - t_start:.0f} "
              "s")

    # 11. the msqg driver and its events: card against CPU, then bench's
    # coupled configuration through run_qg at full width
    if wanted("driver"):
        ev = dict(dtflt=0.25, dtout=0.5, tend=0.75, ediag=0, afilt=7.0)
        if not (driver_check(QGConfig, "walled", verron(QGConfig, 128, **ev))
                and driver_check(QGConfig, "coupled",
                                 verron(QGConfig, 128, **ev, **TRACERS),
                                 coupled=True)
                and driver_check(QGConfig, "periodic",
                                 verron(QGConfig, 128, sbc=-1.0, **ev))):
            return 11
        print(f"driver checks done at {time.perf_counter() - t_start:.0f} s")
        if not driver_path(QGConfig, rows):
            return 11
        print(f"driver path done at {time.perf_counter() - t_start:.0f} s")

    # 12. the qg-node driver and its events: card against CPU, the card's
    # noise draw, then bench's masked node configuration through run_node
    # at full width
    if wanted("driver_node"):
        for label, (over, masked) in NODE_DRIVER_RUNS.items():
            if not node_driver_check(NodeQGConfig, label, over, masked):
                return 12
        if not node_noise_check(NodeQGConfig):
            return 12
        print(f"driver_node checks done at "
              f"{time.perf_counter() - t_start:.0f} s")
        if not driver_node_path(NodeQGConfig, rows):
            return 12
        print(f"driver_node path done at "
              f"{time.perf_counter() - t_start:.0f} s")

    # 13. mspg: card against CPU (build, 20 steps plain, GM, b_forc;
    # run_pg with its files), then bench.py's 64^2 x 30 row and run_pg's
    # output events
    if wanted("mspg"):
        if not (mspg_check(PGConfig, "plain", {})
                and mspg_check(PGConfig, "gm", {"k_gm": PG_GM})
                and mspg_check(PGConfig, "b_forc", {}, b_forc=True)
                and run_pg_check(PGConfig)):
            return 13
        print(f"mspg checks done at {time.perf_counter() - t_start:.0f} s")
        if not mspg_path(PGConfig):
            return 13
        print(f"mspg path done at {time.perf_counter() - t_start:.0f} s")

    # 14. the PG <-> QG coupling loop: card against CPU stage by stage at
    # the workflow's sizes, then README.md's workflow at full width
    if wanted("coupling"):
        if not coupling_check(PGConfig, QGConfig):
            return 14
        print(f"coupling check done at {time.perf_counter() - t_start:.0f} "
              "s")
        if not coupling_path(PGConfig, QGConfig):
            return 14
        print(f"coupling path done at {time.perf_counter() - t_start:.0f} "
              "s")

    rows_err = kv_err = None       # the shard phase's records take them
    # 15. varRo and the y-profile direct solve: KV, the solve, the steps on
    # the card against the CPU, the spectral and mg paths at full width
    if wanted("varro"):
        good, kv_err = kv_checks()
        if not (good and vary_solve_check(QGConfig)
                and varro_checks(QGConfig)):
            return 15
        print(f"varro checks done at {time.perf_counter() - t_start:.0f} s")
        if not varro_path(QGConfig, rows, kv_err):
            return 15
        print(f"varro paths done at {time.perf_counter() - t_start:.0f} s")

    # 16. newqg: the steps and run_newqg on the card against the CPU, then
    # the reference deck at 2048^2
    if wanted("newqg"):
        if not (newqg_checks(NewQGConfig) and run_newqg_check(NewQGConfig)):
            return 16
        print(f"newqg checks done at {time.perf_counter() - t_start:.0f} s")
        if not newqg_path(NewQGConfig, rows):
            return 16
        print(f"newqg paths done at {time.perf_counter() - t_start:.0f} s")

    # 17. SQG: the step and run_sqg on the card against the CPU, then
    # bench's node physics at 2048^2 x 4
    if wanted("sqg"):
        if not (sqg_step_check(NodeQGConfig)
                and run_sqg_check(NodeQGConfig)):
            return 17
        print(f"sqg checks done at {time.perf_counter() - t_start:.0f} s")
        if not sqg_path(NodeQGConfig, rows):
            return 17
        print(f"sqg path done at {time.perf_counter() - t_start:.0f} s")

    # 18. the rows-sharded step: K1's and K2's rows mode on virtual shards,
    # then at world size 1 under NCCL the step and run_qg against the
    # unsharded ones, and bench's sharded_rows row at full width
    if wanted("rows"):
        good, rows_err = rows_kernel_checks(QGConfig)
        if not good:
            return 18
        print(f"rows kernel checks done at "
              f"{time.perf_counter() - t_start:.0f} s")
        import shutil
        from msom_tpu_torch.parallel import dist
        tmp = _rows_group()
        try:
            if not (rows_step_check(QGConfig)
                    and rows_driver_check(QGConfig)):
                return 18
            print(f"rows checks done at {time.perf_counter() - t_start:.0f}"
                  " s")
            if not rows_path(QGConfig, rows, rows_err):
                return 18
            print(f"rows path done at {time.perf_counter() - t_start:.0f} s")
        finally:
            dist.shutdown()
            shutil.rmtree(tmp, ignore_errors=True)

    # 18b. the sharded multigrid and the general-mesh step at world size 1
    # under NCCL: run_qg's routing, then the rows mg step and the gspmd
    # step beside the unsharded steps at full width
    if wanted("shard"):
        import shutil
        from msom_tpu_torch.parallel import dist
        if rows_err is None:           # the records' check errors
            good, rows_err = rows_kernel_checks(QGConfig)
            if not good:
                return 18
        if kv_err is None:
            good, kv_err = kv_checks()
            if not good:
                return 18
        tmp = _rows_group()
        try:
            if not shard_routing_check(QGConfig):
                return 18
            print(f"shard checks done at {time.perf_counter() - t_start:.0f}"
                  " s")
            if not shard_path(QGConfig, rows, rows_err, kv_err):
                return 18
            print(f"shard path done at {time.perf_counter() - t_start:.0f} "
                  "s")
        finally:
            dist.shutdown()
            shutil.rmtree(tmp, ignore_errors=True)

    # 18c and 18d. the vertex-sharded qg-node run and the sharded mspg run
    # at world size 1 under NCCL: run_node and run_pg against the CPU, then
    # each sharded step beside its unsharded step
    for phase, checks, path in (
            ("vshard", lambda: vshard_driver_check(NodeQGConfig),
             lambda: vshard_path(NodeQGConfig)),
            ("pgshard", lambda: pgshard_driver_check(PGConfig),
             lambda: pgshard_path(PGConfig))):
        if not wanted(phase):
            continue
        import shutil
        from msom_tpu_torch.parallel import dist
        t0 = time.perf_counter()
        tmp = _rows_group()
        try:
            if not checks():
                return 18
            print(f"{phase} checks done at "
                  f"{time.perf_counter() - t_start:.0f} s")
            if not path():
                return 18
            print(f"{phase} path done at {time.perf_counter() - t_start:.0f}"
                  f" s ({time.perf_counter() - t0:.0f} s for the phase)")
        finally:
            dist.shutdown()
            shutil.rmtree(tmp, ignore_errors=True)

    # 19. the tendency API: K1 and K2 on the tendency route, the card
    # against the CPU, bfn_integrate at full width beside the bare step,
    # pg_steady_state, the native AsyncBasWriter
    if wanted("api"):
        good, k1_err = api_kernel_checks(QGConfig, rows)
        if not good:
            return 19
        print(f"api checks done at {time.perf_counter() - t_start:.0f} s")
        good, psi = bfn_path(QGConfig, rows, k1_err)
        if not (good and pg_nk_check(PGConfig)
                and async_writer_check(psi, 80.0)):
            return 19
        del psi
        torch.cuda.empty_cache()
        print(f"api path done at {time.perf_counter() - t_start:.0f} s")

    # 20. the f32 validation of the main path
    if wanted("f32val"):
        if not f32val_check(QGConfig):
            return 20
        print(f"f32val done at {time.perf_counter() - t_start:.0f} s")

    # 21. the bf16 + refinement solve: the float64 solve on the card
    # against the CPU and, at world size 1 under NCCL, sharded; the bf16
    # pass against its emulation, the error table, the solve times and the
    # msqg step on it at full width
    if wanted("refine"):
        import shutil
        from msom_tpu_torch.parallel import dist
        t0 = time.perf_counter()
        card = card_line()
        tmp = _rows_group()
        try:
            good = refine_checks(card)
        finally:
            dist.shutdown()
            shutil.rmtree(tmp, ignore_errors=True)
        if not (good and refine_path(QGConfig, card)):
            return 21
        print(f"refine done at {time.perf_counter() - t_start:.0f} s "
              f"({time.perf_counter() - t0:.0f} s for the phase)")

    # 22. the multi-device dry run: entry() on the card against the CPU,
    # then dryrun_multichip's seven modes at world size 1 under NCCL
    if wanted("dryrun"):
        import shutil
        from msom_tpu_torch.parallel import dist
        t0 = time.perf_counter()
        if not entry_check():
            return 22
        tmp = _rows_group()
        try:
            good = dryrun_check()
        finally:
            dist.shutdown()
            shutil.rmtree(tmp, ignore_errors=True)
        if not good:
            return 22
        print(f"dryrun done at {time.perf_counter() - t_start:.0f} s "
              f"({time.perf_counter() - t0:.0f} s for the phase)")

    print(f"total {time.perf_counter() - t_start:.0f} s")
    print("kernels: " + json.dumps(sorted({r["name"] for r in rows})))
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
