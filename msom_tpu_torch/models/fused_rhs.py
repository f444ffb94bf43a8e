"""Fused msqg tendency: kernel K1 of the port.

`rhs_fused(cfg, const, psi, q=None) -> (dq, umax)` computes what the JAX
package's Pallas kernel (`msom_tpu.models.pallas_rhs.rhs_fused`,
`_rhs_kernel`) computes: the whole update_qg tendency, with the options the
constants and the config switch on (the large-scale streamfunction pp and
its cascade cross terms, _LS_RV, topography, the 3-D forcing, ENERGY_CONSERV
advection of `q`, the stochastic variant, which reads `q` too, partial-slip
ghosts, the doubly periodic domain), and the (nl,) per-layer maximum |face
velocity| of psi for the CFL controller (the pp part of that chain is
const.umax_pp, made at build). In the periodic run the kernel reads pp and
zetap padded (const.pp_t, const.zetap_t: pp_pad and zetap_pad, widened for
aligned copies), their ghosts made at build: pp's follow the reference's
non-wrap law, zetap's wrap.

On a CUDA tensor it launches the hand-written Hopper kernel in
`csrc/fused_rhs.cu` (built at first use by `_build`, bound with ctypes) or
raises. On a CPU tensor it computes the plain PyTorch version,
`rhs_fused_reference`, built from `qg.rhs` and `max_face_speed_layers`.
`launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from msom_tpu_torch import _build
from msom_tpu_torch.ops.ghost import (ghosted, laplacian_g,
                                      max_face_speed_layers)

SOURCE = "msom_tpu_torch/csrc/fused_rhs.cu"
SMEM_LIMIT = 232448          # shared memory one block may use on sm_90
MIN_PERIODIC_N = 4           # the periodic halo wraps once

launches = 0


def rhs_fused_reference(cfg, const, psi: torch.Tensor,
                        q: torch.Tensor | None = None):
    """The plain PyTorch version: (dq, umax) from qg.rhs and
    max_face_speed_layers under the config's ghost law, on any device."""
    from msom_tpu_torch.models import qg
    psi_g = ghosted(psi, qg._bc_psi(cfg))
    zeta = laplacian_g(psi_g, cfg.delta)
    dq, _ = qg.rhs(cfg, const, q, psi_g, zeta,
                   qg._ghost_deriv(cfg, zeta, psi_g))
    return dq, max_face_speed_layers(psi_g, cfg.delta)


@functools.cache
def _lib():
    """The built library with its C signatures declared."""
    lib = _build.load("fused_rhs")
    ptr = ctypes.c_void_p
    dbl = ctypes.POINTER(ctypes.c_double)
    for fn in (lib.fused_rhs_f32, lib.fused_rhs_f64):
        fn.argtypes = [ctypes.POINTER(ptr), ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, dbl, dbl, dbl, ptr]
        fn.restype = ctypes.c_int
    lib.fused_rhs_num_blocks.argtypes = [ctypes.c_int]
    lib.fused_rhs_num_blocks.restype = ctypes.c_int
    lib.fused_rhs_smem_bytes.argtypes = [ctypes.c_int] * 7
    lib.fused_rhs_smem_bytes.restype = ctypes.c_longlong
    lib.fused_rhs_error_string.argtypes = [ctypes.c_int]
    lib.fused_rhs_error_string.restype = ctypes.c_char_p
    return lib


def _doubles(vals):
    return (ctypes.c_double * len(vals))(*vals)


# bits of the launch's `flags`, csrc/fused_rhs.cu's `Flag`
FLSRV, PERIODIC, STOCHASTIC = 1, 2, 4


def _options(cfg, const):
    """The kernel's options from the config and the constants:
    (pp, zetap, topo, iro, qforc, need_q, cslip, flags). The advection
    block, pp terms and the stochastic damping included, does not run at
    nl == 1, so pp and q are dropped there. pp is the interior of pp_pad
    with walls, pp_t (pp_pad widened) in the periodic run, where zetap_t
    comes with it (_LS_RV); with walls the kernel makes zetap itself."""
    periodic = cfg.sbc == -1
    has_pg = const.pp is not None and cfg.nl > 1
    flsrv = bool(has_pg and const.zetap_pad is not None)
    stoch = bool(cfg.stochastic and cfg.nl > 1)
    cslip = cfg.sbc / ((0.5 * cfg.sbc + 1.0) * cfg.delta ** 2) \
        if cfg.sbc > 0 else 0.0
    pp = None
    if has_pg:
        pp = const.pp_t if periodic else const.pp
    flags = (FLSRV * flsrv) | (PERIODIC * periodic) | (STOCHASTIC * stoch)
    return (pp, const.zetap_t if flsrv and periodic else None,
            const.topo, const.iro, const.qforc,
            bool((cfg.energy_conserv or cfg.stochastic) and cfg.nl > 1),
            cslip, flags)


def rhs_fused(cfg, const, psi: torch.Tensor, q: torch.Tensor | None = None):
    """(dq, umax): the kernel on a CUDA tensor, the plain version on a CPU
    tensor. `q` is needed for ENERGY_CONSERV advection and the stochastic
    variant only."""
    global launches
    if psi.device.type == "cpu":
        return rhs_fused_reference(cfg, const, psi, q)
    if psi.device.type != "cuda":
        raise ValueError(f"rhs_fused: unsupported device {psi.device}")
    nl, N = cfg.nl, cfg.N
    if psi.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"rhs_fused: dtype {psi.dtype} (float32 or float64)")
    if tuple(psi.shape) != (nl, N, N) or not psi.is_contiguous():
        raise ValueError(f"rhs_fused: psi must be a contiguous {(nl, N, N)} "
                         f"tensor, got {tuple(psi.shape)}")
    pp, zetap, topo, iro, qforc, need_q, cslip, flags = _options(cfg, const)
    if need_q and q is None:
        raise ValueError("rhs_fused: ENERGY_CONSERV advection or the "
                         "stochastic variant needs q")
    if flags & PERIODIC and N < MIN_PERIODIC_N:
        raise ValueError(f"rhs_fused: the periodic kernel takes N >= "
                         f"{MIN_PERIODIC_N}, got {N}")
    ppn, pps = ("const.pp_t", (nl, N + 2, N + 8)) if flags & PERIODIC \
        else ("const.pp", (nl, N, N))
    fields = [("const.wind", const.wind, (N, 1)), (ppn, pp, pps),
              ("const.zetap_t", zetap, (nl, N + 2, N + 8)),
              ("const.topo", topo, (N, N)), ("const.iro", iro, (N, 1)),
              ("const.qforc", qforc, (nl, N, N)),
              ("q", q if need_q else None, (nl, N, N))]
    if nl > 1:
        fields.append(("const.strl", const.strl, (nl - 1, N, 1)))
    for name, t, shape in fields:
        if t is None and name not in ("const.wind", "const.strl"):
            continue
        if (t is None or tuple(t.shape) != shape or t.device != psi.device
                or t.dtype != psi.dtype or not t.is_contiguous()):
            raise ValueError(f"rhs_fused: {name} must be a contiguous "
                             f"{psi.dtype} tensor {shape} on {psi.device}")
    lib = _lib()
    smem = lib.fused_rhs_smem_bytes(nl, psi.element_size(),
                                    int(pp is not None), int(flags & FLSRV),
                                    int(need_q), int(topo is not None),
                                    int(flags & PERIODIC))
    if smem > SMEM_LIMIT:
        raise ValueError(f"rhs_fused: nl = {nl} with these options needs "
                         f"{smem} B of shared memory per block, more than "
                         f"{SMEM_LIMIT}")
    dq = torch.empty_like(psi)
    umax_part = torch.empty((lib.fused_rhs_num_blocks(N), nl),
                            dtype=psi.dtype, device=psi.device)
    with torch.cuda.device(psi.device):
        stream = torch.cuda.current_stream(psi.device).cuda_stream
        rc = launch(lib, cfg, const, psi, q, dq, umax_part, stream)
    if rc != 0:
        raise RuntimeError("fused_rhs launch failed: "
                           + lib.fused_rhs_error_string(rc).decode())
    launches += 1
    return dq, umax_part.amax(dim=0)


def launch(lib, cfg, const, psi, q, dq, umax_part, stream) -> int:
    """Call the library's C entry for psi's type with this configuration's
    fields and scalars, writing dq and the per-block maxima umax_part
    (fused_rhs_num_blocks(N), nl) on `stream`; returns its error code. The
    caller has checked the fields (rhs_fused), or runs the kernel's source
    in a host emulation (tools/k1_emulation.py)."""
    nl = cfg.nl
    pp, zetap, topo, iro, qforc, need_q, cslip, flags = _options(cfg, const)
    dh = cfg.dh
    scal = _doubles([cfg.delta, cfg.beta, cfg.iRe, cfg.iRe4,
                     cfg.Eks / (cfg.Rom * 2 * dh[0]),
                     cfg.Ekb / (cfg.Rom * 2 * dh[nl - 1]), cslip,
                     cfg.itr_stoch])
    fn = lib.fused_rhs_f32 if psi.dtype == torch.float32 \
        else lib.fused_rhs_f64
    # the order of csrc/fused_rhs.cu's `Ptr` enumeration; absent fields null
    tensors = [psi, const.strl if nl > 1 else None, const.wind, dq, umax_part,
               pp, q if need_q else None, topo, iro, qforc, zetap]
    ptrs = (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])
    return fn(ptrs, cfg.N, nl, flags, scal, _doubles(const.idh0),
              _doubles(const.idh1), stream)


def bound_work(cfg, const, itemsize: int):
    """(bytes, operations) that the tendency needs at least: every input
    field read once (psi and, where the options bring them, pp, q, topo,
    qforc; the periodic run's pp with its ghost ring, (N + 2)^2 a layer),
    dq written once,
    plus the y-profiles read and the (nl,) maxima written, and the
    arithmetic counted per cell and layer from the formula, not from the
    kernel's redundant halo work. zetap, which the periodic kernel reads
    where the walled one computes it, counts as computed. Used for the
    roofline bound."""
    N, nl = cfg.N, cfg.nl
    pp, _, topo, _, qforc, need_q, cslip, flags = _options(cfg, const)
    flsrv = bool(flags & FLSRV)
    stoch = bool(flags & STOCHASTIC)
    cells = N * N * nl
    planes = 2 * nl + (nl if need_q else 0) \
        + (1 if topo is not None else 0) + (nl if qforc is not None else 0)
    side = N + 2 if flags & PERIODIC else N
    pp_cells = 0 if pp is None else nl * side * side
    nbytes = (planes * N * N + pp_cells + N * nl + nl
              + (N if topo is not None else 0)) * itemsize
    gamma = 8 if nl > 1 else 0   # Gamma(.) at one cell
    jac = 32                     # one 12-point Arakawa bracket
    ops = 6 + 27 + 4             # zeta Laplacian, face speeds, wind/Ekman
    if nl > 1:
        ops += jac + 3 + 6       # self advection, beta, cascade weights
        if not need_q:
            ops += jac           # interface -J(psi_l, psi_l+1)
        if stoch:
            ops += 2             # -q / tr_stoch
        if pp is not None:
            ops += 3 * jac + 3   # -J(pp, zeta) and the two cross terms
        if flsrv:
            ops += 6 + jac + 1   # zetap = lap pp, -J(psi, zetap)
    if cfg.iRe != 0.0 or cfg.iRe4 != 0.0:
        ops += 6                 # tmp = lap zeta
    if cfg.iRe != 0.0:
        ops += 2 + gamma
    if cfg.iRe4 != 0.0:
        ops += 6 + 2 + gamma     # lap tmp
    total = ops * cells
    if stoch:
        total -= jac * N * N     # no self advection in the top layer
    if topo is not None:
        total += (jac + 2) * N * N      # bottom layer only
    if qforc is not None:
        total += cells
    return nbytes, total
