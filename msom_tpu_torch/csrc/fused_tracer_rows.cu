// K2's rows mode for Hopper (sm_90a): csrc/fused_tracer.cu built with the
// compile-time constant EXT on, a library of its own (hazard 7 in
// fused_tracer.cu). Replaces the rows layout of the Pallas TPU kernel
// `_tracer_kernel` (msom_tpu/models/pallas_rhs.py:778, the SMEM row0 at
// :778-795; entry `tracer_fused(psi_ext=, tr_ext=, row0=)` :820-872).
#define FUSED_TRACER_ROWS 1
#include "fused_tracer.cu"
