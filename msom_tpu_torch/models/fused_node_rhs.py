"""Fused qg-node tendency: kernel K5 of the port.

`rhs_fused_node(cfg, const, q, psi, qf_profile) -> dq` computes what the JAX
package's Pallas kernel (`msom_tpu.models.pallas_node_rhs.rhs_fused_node`,
`_node_kernel`) computes: the whole walled qg-node `rhs_pv` on the
(nl, N+1, N+1) vertex grid (qg_baroclinic_ms.h:103-196, or
qg_barotropic.h:16-29 at nl = 1), with the options the constants switch on
(the large-scale streamfunction psi_pg, topography, the 3-D forcing, any
mask) and the stratification S2 as an (nl-1, N+1) y-profile. `qf_profile`
is the (N+1,) y-profile of the time-varying wind (qg_node.q_forcing_profile).

On a CUDA tensor it launches the hand-written Hopper kernel in
`csrc/node_rhs.cu` (built at first use by `_build`, bound with ctypes), a
row-marching strip kernel whose rings of rows fit a block's shared memory
for every nl up to 8 in both types, or raises. On a CPU tensor it computes the plain PyTorch version
`rhs_node_reference`, the walled rhs_pv as torch ops, which is also what
`qg_node.rhs_pv` runs on either device when S2 varies in x (an N2 field
input). `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from msom_tpu_torch import _build
from msom_tpu_torch.ops import vertex
from msom_tpu_torch.ops.stencil import arakawa_mjac
from msom_tpu_torch.ops.stretch import stretch

SOURCE = "msom_tpu_torch/csrc/node_rhs.cu"
SMEM_LIMIT = 232448          # shared memory one block may use on sm_90

launches = 0


def rhs_node_reference(cfg, const, q: torch.Tensor, psi: torch.Tensor,
                       qf_profile: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: rhs_pv_baroclinic / rhs_pv_barotropic
    (models/qg_node.rhs_pv of the JAX package) with the full S2 field, on
    any device. J(p, q) is arakawa_mjac(q, p) (the qg-node macro swaps the
    roles, giving +J), zero on the ring."""
    d = cfg.delta
    nl = cfg.nl
    m = const.mask

    def J(p, qq):
        return F.pad(arakawa_mjac(qq, p, d), (1, 1, 1, 1))

    def betaterm(p):
        return F.pad(cfg.beta * (p[..., 1:-1, 2:] - p[..., 1:-1, :-2])
                     / (2 * d), (1, 1, 1, 1))

    qf = qf_profile[:, None]
    fric = -cfg.hEkb * cfg.f0 / (2 * cfg.dh[nl - 1])

    if nl == 1:
        dq = (-J(psi, q) - betaterm(psi) + fric * q + qf[None]
              + cfg.nu * vertex.vlap(q, d))
        return dq * m

    psi = psi * m
    zeta = vertex.bc_deriv(vertex.vlap(psi, d), psi, cfg.bc_fac, d)
    pp = const.psi_pg if const.has_pg else None
    dq = -J(psi, zeta)
    if pp is not None:
        dq = dq - J(pp, zeta)
    dq = dq - betaterm(psi)
    # interface cascade Jd = J(psi_l, psi_l+1) + J(pp_l, psi_l+1)
    # + J(psi_l, pp_l+1) (qg_baroclinic_ms.h:124)
    Jd = J(psi[:-1], psi[1:])
    if pp is not None:
        Jd = Jd + J(pp[:-1], psi[1:]) + J(psi[:-1], pp[1:])
    i0 = torch.tensor(const.idh0, dtype=q.dtype,
                      device=q.device).reshape(nl, 1, 1)
    i1 = torch.tensor(const.idh1, dtype=q.dtype,
                      device=q.device).reshape(nl, 1, 1)
    dq[:-1] += -const.S2 * Jd * i1[:-1]
    dq[1:] += const.S2 * Jd * i0[1:]
    # bottom friction and topography (:150)
    bot = fric * zeta[nl - 1]
    if const.has_topo:
        bot = bot - J(psi[nl - 1], const.topo) * cfg.f0 / cfg.dh[nl - 1]
    dq[nl - 1] += bot
    # dissipation (:159-170): harmonic on stretch + del2 of zeta, biharmonic
    dq = dq + cfg.nu * stretch(zeta, const.S2, const.idh0, const.idh1)
    # set_bc_ms's tmp rule (qg_baroclinic_ms.h:67-69): the parent's own ring
    # value is subtracted (zeta's slip ring is nonzero for bc_fac > 0)
    tmp = vertex.bc_deriv_rel(vertex.vlap(zeta, d), zeta, cfg.bc_fac, d)
    dq = dq + cfg.nu * tmp
    if cfg.nu4 != 0.0:
        dq = dq - cfg.nu4 * (stretch(tmp, const.S2, const.idh0, const.idh1)
                             + vertex.vlap(tmp, d))
    # surface and 3-D forcing (:176-186)
    dq[0] += qf
    if const.q_forcing_3d is not None:
        dq = dq + const.q_forcing_3d
    return dq * m


@functools.cache
def _lib():
    """The built library with its C signatures declared."""
    lib = _build.load("node_rhs")
    ptr = ctypes.c_void_p
    dbl = ctypes.POINTER(ctypes.c_double)
    for fn in (lib.node_rhs_f32, lib.node_rhs_f64):
        fn.argtypes = [ctypes.POINTER(ptr), ctypes.c_int, ctypes.c_int, dbl,
                       dbl, dbl, ptr]
        fn.restype = ctypes.c_int
    lib.node_rhs_max_nl.argtypes = []
    lib.node_rhs_max_nl.restype = ctypes.c_int
    lib.node_rhs_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.node_rhs_smem_bytes.restype = ctypes.c_longlong
    lib.node_rhs_error_string.argtypes = [ctypes.c_int]
    lib.node_rhs_error_string.restype = ctypes.c_char_p
    return lib


def _doubles(vals):
    return (ctypes.c_double * len(vals))(*vals)


def _inputs(cfg, const, q, qf_profile):
    """(name, tensor, shape) of every field the kernel reads beside psi, in
    the order of csrc/node_rhs.cu's `Ptr` enumeration (dq in its place is
    None here), None where the options leave a field out."""
    nl, M = cfg.nl, cfg.N + 1
    lay = nl > 1
    return [("const.mask", const.mask, (M, M)),
            ("qf_profile", qf_profile, (M,)),
            ("const.S2_prof", const.S2_prof if lay else None, (nl - 1, M)),
            ("dq", None, None),
            ("q", None if lay else q, (nl, M, M)),
            ("const.psi_pg", const.psi_pg if lay and const.has_pg else None,
             (nl, M, M)),
            ("const.topo", const.topo if lay and const.has_topo else None,
             (M, M)),
            ("const.q_forcing_3d", const.q_forcing_3d if lay else None,
             (nl, M, M))]


def rhs_fused_node(cfg, const, q: torch.Tensor, psi: torch.Tensor,
                   qf_profile: torch.Tensor) -> torch.Tensor:
    """dq: the kernel on a CUDA tensor, the plain version on a CPU tensor.
    `q` is read at nl = 1 only. The kernel takes S2 as a y-profile
    (const.S2_prof); a CUDA call without one raises, and so does a call
    with a periodic config (bc_fac = -1), whose tendency is
    qg_node._rhs_pv_periodic on either device."""
    global launches
    if cfg.periodic:
        raise ValueError("rhs_fused_node: the walled tendency; the periodic "
                         "node grid (bc_fac = -1) has no kernel mode")
    if psi.device.type == "cpu":
        return rhs_node_reference(cfg, const, q, psi, qf_profile)
    if psi.device.type != "cuda":
        raise ValueError(f"rhs_fused_node: unsupported device {psi.device}")
    nl, M = cfg.nl, cfg.N + 1
    if psi.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"rhs_fused_node: dtype {psi.dtype} (float32 or "
                        "float64)")
    if tuple(psi.shape) != (nl, M, M) or not psi.is_contiguous():
        raise ValueError(f"rhs_fused_node: psi must be a contiguous "
                         f"{(nl, M, M)} tensor, got {tuple(psi.shape)}")
    if nl > 1 and const.S2_prof is None:
        raise ValueError("rhs_fused_node: S2 varies in x; the kernel takes "
                         "a y-profile (qg_node.rhs_pv runs the torch ops "
                         "for this configuration)")
    fields = _inputs(cfg, const, q, qf_profile)
    for name, t, shape in fields:
        if t is None:
            continue
        if (tuple(t.shape) != shape or t.device != psi.device
                or t.dtype != psi.dtype or not t.is_contiguous()):
            raise ValueError(f"rhs_fused_node: {name} must be a contiguous "
                             f"{psi.dtype} tensor {shape} on {psi.device}")
    lib = _lib()
    if not 1 <= nl <= lib.node_rhs_max_nl():
        raise ValueError(f"rhs_fused_node: nl = {nl}, the kernel takes 1 to "
                         f"{lib.node_rhs_max_nl()}")
    has_pg, has_topo = (nl > 1 and const.has_pg), (nl > 1 and const.has_topo)
    smem = lib.node_rhs_smem_bytes(nl, psi.element_size(), has_pg, has_topo)
    if smem > SMEM_LIMIT:
        raise ValueError(f"rhs_fused_node: nl = {nl} in {psi.dtype} with "
                         f"psi_pg {has_pg}, topo {has_topo} needs {smem} B "
                         f"of shared memory per block, more than "
                         f"{SMEM_LIMIT}")
    dq = torch.empty_like(psi)
    dh = cfg.dh
    scal = _doubles([cfg.delta, cfg.beta, cfg.nu, cfg.nu4,
                     cfg.hEkb * cfg.f0 / (2.0 * dh[nl - 1]),
                     cfg.f0 / dh[nl - 1],
                     2.0 * cfg.bc_fac / (cfg.delta * cfg.delta)])
    fn = lib.node_rhs_f32 if psi.dtype == torch.float32 \
        else lib.node_rhs_f64
    tensors = [psi] + [dq if name == "dq" else t for name, t, _ in fields]
    ptrs = (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])
    with torch.cuda.device(psi.device):
        stream = torch.cuda.current_stream(psi.device).cuda_stream
        rc = fn(ptrs, M, nl, scal, _doubles(const.idh0),
                _doubles(const.idh1), stream)
    if rc != 0:
        raise RuntimeError("node_rhs launch failed: "
                           + lib.node_rhs_error_string(rc).decode())
    launches += 1
    return dq


def bound_work(cfg, const, itemsize: int):
    """(bytes, operations) that the tendency needs at least: psi (and q at
    nl = 1), the mask and, where the options bring them, pp, topo and qf3
    read once, dq written once, the profiles read; the arithmetic counted
    per node from the formula, not from the kernel's redundant halo work.
    Used for the roofline bound."""
    nl, M = cfg.nl, cfg.N + 1
    nodes = M * M
    jac = 32                       # one 12-point Arakawa bracket
    lap = 6
    if nl == 1:
        # J(psi, q), beta, friction, wind, nu lap q, mask
        ops = jac + 3 + 2 + 1 + lap + 2 + 1
        return (4 * nodes + M) * itemsize, ops * nodes
    has_qf3 = const.q_forcing_3d is not None
    planes = 2 * nl + 1 + (nl if const.has_pg else 0) \
        + (1 if const.has_topo else 0) + (nl if has_qf3 else 0)
    nbytes = (planes * nodes + (nl - 1) * M + M) * itemsize
    gamma = 8                      # Gamma(.) at one node
    # per node and layer: psi * mask, zeta, -J(psi, zeta), beta, the
    # cascade's two weighted terms, tmp, nu (Gamma(zeta) + tmp), the mask
    per_layer = 1 + lap + jac + 3 + 6 + lap + gamma + 4 + 1
    if cfg.nu4 != 0.0:
        per_layer += gamma + lap + 3
    if const.has_pg:
        per_layer += jac + 1
    if has_qf3:
        per_layer += 1
    per_interface = jac + (2 * jac + 2 if const.has_pg else 0)
    total = (per_layer * nl + per_interface * (nl - 1) + 2 + 1) * nodes
    if const.has_topo:
        total += (jac + 2) * nodes
    return nbytes, total
