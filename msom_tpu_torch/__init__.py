"""msom_tpu_torch: the PyTorch/CUDA port of msom_tpu.

Stands beside the JAX package, which stays the reference it is tested
against. It imports torch and numpy, never jax or msom_tpu. Entry points
take a `device` and run on "cuda" unless the caller passes "cpu"; the
multigrid level builders (mg.build_layered_coeffs, vmg.build_vlevels) take
the device of the coefficient fields they are given, else `device`.

Ported so far: the msqg step, walled (free slip and partial slip) or doubly
periodic (sbc = -1), with the direct spectral inversion (periodic: rfft2 or
the Fourier basis) or the multigrid (solver="mg", layered or
mode_pv_invert), uncoupled or coupled to a large-scale streamfunction,
bottom topography, a 3-D forcing and passive tracers, with or without
stochastic forcing (a torch.Generator given to make_step); and the qg-node family's walled step (models/qg_node.py: any
interior mask, partial-slip rings, the nodal spectral inversion or the
masked vertex multigrid solvers/vmg.py); the msqg driver with its events
(driver.py: run_qg, OutputWriter, the command line; the wavelet filter
ops/wavelet.py, the energy budget models/qg_energy.py, the .bas and deck
readers and the checkpoint in io/); the planetary-geostrophic model mspg
(models/mspg.py, its barotropic solver mg.solve_bt, driver.run_pg and
PGOutputWriter, `--model pg`); and the offline PG <-> QG coupling loop
(coupling.py, analysis.py; msqg takes the 2-D Froude field frpg, whose
tendency then runs as torch ops); and the sharded msqg run over
torch.distributed (parallel/: the process group and its (my, mx) mesh,
the halo exchanges, the pencil and mesh spectral solves, the sharded
multigrid, make_qg_step_sharded; driver.run_qg(sharded=) routed as the
JAX package's: the rows step, whose shards run K1's and K2's rows mode,
or the general-mesh step, the port's form of JAX's GSPMD run); the
tendency API (api.py:
q_to_psi, psi_to_q, qg_tendency through K1 and K2, qg_energy_tendencies,
the back-and-forth-nudging loop bfn_integrate, and mspg's flat-vector
pg_tendency with its Newton-Krylov steady state and continuations), the
analysis toolchain (analysis.py: spectra, budgets, .bas to NetCDF,
regrid, modes, linear stability) and the native host library (native/:
the .bas codec, AsyncBasWriter, eig_tridiag_batch; basio.cpp built with
g++ at first use). Eight hand-written Hopper kernels:
the fused tendency (models/fused_rhs.py, csrc/fused_rhs.cu), the fused
tracer tendency (models/fused_tracer.py, csrc/fused_tracer.cu), the fused
basis-matmul spectral solve (solvers/fused_spectral.py,
csrc/fused_spectral.cu; f32 on the tensor cores), the multigrid's
red-black line sweep and fused residual (solvers/fused_mg.py,
csrc/mg_sweep.cu, csrc/mg_residual.cu), and the qg-node tendency and
masked vertex relaxation (models/fused_node_rhs.py, csrc/node_rhs.cu;
solvers/fused_vmg.py, csrc/vmg_sweep.cu: five sweeps a launch), and the
y-profile solve's block-Thomas sweeps (solvers/fused_vary.py,
csrc/vary_sweep.cu).

    from msom_tpu_torch.params import QGConfig
    from msom_tpu_torch.models import qg
    cfg = QGConfig(N=256, nl=3, L0=80, Rom=0.025, Ekb=0.002, tau0=1e-4,
                   Re4=1563, beta=0.5, Fr=(0.0023669, 0.0076173),
                   dh=(0.06, 0.14, 0.8), DT=5e-2, CFL=0.6,
                   solver="spectral").validate()
    const = qg.build_constants(cfg)              # device="cuda"; coupling
                                                 # fields: psipg=, topo=, ...
    state = qg.init_state(cfg, const, seed=0)
    step = qg.make_step(cfg)
    state, diag = step(state, const, 1.0)
    from msom_tpu_torch import driver
    state, energy = driver.run_qg(cfg, const=const, state=state,
                                  hooks=driver.stdout_hooks())

    from msom_tpu_torch.models import qg_node
    ncfg = qg_node.NodeQGConfig(N=256, nl=4, L0=100.0, f0=46.5, beta=0.5,
                                hEkb=1e-3, tau0=1e-3, nu=1.25,
                                dh=(0.25,) * 4, N2=(1.0,) * 3,
                                noise_init=1e-3, bc_fac=1.0, CFL=0.2)
    nconst = qg_node.build_constants(ncfg)       # mask=, psi_pg=, topo=, ...
    nstate = qg_node.init_state(ncfg, nconst, seed=0)
    nstate, ndiag = qg_node.make_step(ncfg)(nstate, nconst, 1.0)

    from msom_tpu_torch.models import mspg
    from msom_tpu_torch.params import PGConfig
    pcfg = PGConfig(N=64, nl=30, ys=0.3, r=0.02, tau_s=3e-2, tau0=0.12,
                    kv=1e-4, kh=1e-4, omega=0.2, DT=1e-2, CFL=0.4)
    pconst = mspg.build_constants(pcfg)          # the bt solve; b_forc=
    pstate = mspg.init_state(pcfg, pconst)
    pstate, pdiag = mspg.make_step(pcfg)(pstate, pconst, 1.0)
    pstate = driver.run_pg(pcfg, const=pconst, state=pstate)

    from msom_tpu_torch import api
    dq = api.qg_tendency(cfg, const, state.q, direction=-1.0)
    x = api.pg_steady_state(pcfg, pconst, api.pg_pack(pstate))
"""
