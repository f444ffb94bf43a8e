// K1's rows mode for Hopper (sm_90a): csrc/fused_rhs.cu built with the
// compile-time constant EXT on, a library of its own (see "Rows mode" in
// fused_rhs.cu). Replaces the rows layout of the Pallas TPU kernel
// `_rhs_kernel` (msom_tpu/models/pallas_rhs.py:441, the SMEM row0 at :462,
// :481; entry `rhs_fused(psi_ext=, q_ext=, row0=)` :640-737).
#define FUSED_RHS_ROWS 1
#include "fused_rhs.cu"
