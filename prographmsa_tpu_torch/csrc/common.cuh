// Shared constants of the graph-pair DP kernels.
//
// The sentinels are the JAX package's float32 values, given as bit patterns
// so that no decimal-to-float rounding can move them
// (prographmsa_tpu/align/graph_dp_pallas.py: NEG, COST_INF, FLOOR, BIG).
// Decision codes and unreachable-cell values depend on them.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define PGM_NEG_BITS 0xfcf0bdc2u       // -1e37f: finite "-inf"
#define PGM_COST_INF_BITS 0x7cf0bdc2u  //  1e37f: "no edge" cost
#define PGM_FLOOR_BITS 0xff61b1e6u     // -3e38f: max-accumulator init
#define PGM_BIG_BITS 0x7f61b1e6u       //  3e38f: min-accumulator init
#define PGM_NAN_X86_BITS 0xffc00000u   // x86 default NaN (negative quiet)

#define PGM_ST_M 0
#define PGM_ST_X 1
#define PGM_ST_Y 2

#define PGM_EV_CAP 8   // repeat events recorded per pair before fb_rep

// per-pair integer row: [n1, n2, nl1, nl2, R, shb, 0, 0]
#define PGM_IV_N1 0
#define PGM_IV_N2 1
#define PGM_IV_NL1 2
#define PGM_IV_NL2 3
#define PGM_IV_R 4
#define PGM_IV_SHB 5
#define PGM_IV_W 8

// per-pair float row: [ge, gi, sg, si, em, eg, es, 0]
#define PGM_PAR_W 8

__device__ __forceinline__ float pgm_f(unsigned bits) {
  return __uint_as_float(bits);
}

// jnp.maximum(v, NEG): NaN propagates (the comparison is false for NaN)
__device__ __forceinline__ float pgm_clamp_neg(float v) {
  const float neg = pgm_f(PGM_NEG_BITS);
  return (v < neg) ? neg : v;
}

// One 4-byte asynchronous copy from global to shared memory (the address
// from __cvta_generic_to_shared), and the wait for all of this thread's.
__device__ __forceinline__ void cp_async4(unsigned smem_addr,
                                          const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}
