// The Pallas and Vesta instances of K4, the port of make_mont_mul
// (halo2_lasso_tpu/ops/pallas_field.py:225, pallas_call :239), which the
// TPU instantiates for any FieldSpec and runs for the Pasta curves' group
// ops: csrc/mont_mul.cu's elementwise kernel and csrc/mont_chain.cu's
// power, scan and batch inversion. The kernel bodies are those files',
// unchanged; only the modulus differs (field.cuh's Pallas and Vesta, p a
// 255-bit prime). Their entry points (field ids 2 and 3) call the
// launchers below. The instances build in a source of their own so that
// the parallel build's slowest job stays what it was. Bound and design:
// as their BN254 twins.
#define H2L_PASTA_SOURCE
#include "mont_mul.cu"
#include "mont_chain.cu"

int ew_launch_pasta(int field, int op, const EwParams& p, cudaStream_t s) {
  switch (field) {
    case 2: return ew_launch<Pallas>(op, p, s);
    case 3: return ew_launch<Vesta>(op, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int pow_launch_pasta(int field, const void* a, void* out, long long n, const void* exp, int nbits,
                     cudaStream_t s) {
  switch (field) {
    case 2: return pow_launch<Pallas>(a, out, n, exp, nbits, s);
    case 3: return pow_launch<Vesta>(a, out, n, exp, nbits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int chain_pasta(int field, const void* x, void* out, long long n, int reverse, int inv, void* scratch,
                const void* exp, int nbits, cudaStream_t s) {
  switch (field) {
    case 2: return chain<Pallas>(x, out, n, reverse, inv, scratch, exp, nbits, s);
    case 3: return chain<Vesta>(x, out, n, reverse, inv, scratch, exp, nbits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
