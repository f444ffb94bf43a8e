"""msom_tpu_torch: the PyTorch/CUDA port of msom_tpu.

Stands beside the JAX package, which stays the reference it is tested
against. It imports torch and numpy, never jax or msom_tpu. Entry points
take a `device` and run on "cuda" unless the caller passes "cpu".

Ported so far: the msqg step for the walled configurations (free slip and
partial slip) with the direct spectral inversion or the multigrid
(solver="mg", layered or mode_pv_invert), uncoupled or coupled to a
large-scale streamfunction, bottom topography, a 3-D forcing and passive
tracers, with five hand-written Hopper kernels: the fused tendency
(models/fused_rhs.py, csrc/fused_rhs.cu), the fused tracer tendency
(models/fused_tracer.py, csrc/fused_tracer.cu), the fused basis-matmul
spectral solve (solvers/fused_spectral.py, csrc/fused_spectral.cu) and the
multigrid's red-black line sweep and fused residual (solvers/fused_mg.py,
csrc/mg_sweep.cu, csrc/mg_residual.cu).

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
"""
