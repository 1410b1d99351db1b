// K8a and K8b's bfloat16 C entry; the kernel, its design and its launcher
// are in fv4_slab.cuh (the float and double entries: fv4_slab.cu).

#include "fv4_slab.cuh"

// the arguments of fv4_slab.cu's entries; bf16 storage (the fields; the
// slabs float), float arithmetic: a bfloat16 solve's K8a and K8b
extern "C" int hpgmg_fv4_slab_bf16(const void* x, const void* ilo, const void* ihi,
                                   const void* jlo, const void* jhi, const void* klo,
                                   const void* khi, const void* bie, const void* bje,
                                   const void* bke, const void* alpha, const void* rhs,
                                   const void* kdinv, void* out, int ni, int nj, int nk,
                                   int mode, int periodic, int ksplit, int parity, int chunk,
                                   double scale, double a_coef, int pass, void* stream) {
  return launch_slab<bf16>(x, ilo, ihi, jlo, jhi, klo, khi, bie, bje, bke, alpha, rhs,
                           kdinv, out, ni, nj, nk, mode, periodic, ksplit, parity, chunk,
                           scale, a_coef, pass, stream);
}
