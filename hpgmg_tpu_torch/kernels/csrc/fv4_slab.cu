// K8a and K8b's float and double C entries; the kernel, its design and its
// launcher are in fv4_slab.cuh (the bf16 entry: fv4_slab_bf16.cu).

#include "fv4_slab.cuh"

// pass 0: K8a over the whole block; 1: K8b's interior pass (slab pointers
// unread); 2: K8b's edge pass, writing the rest of `out`. periodic: k
// ghosts wrapped (i and j ghosts are the slabs'); ksplit: the block is
// split along k, its k ghosts in klo / khi (null otherwise; unread by
// pass 1); parity: the colour gsrb updates; chunk: i-planes per block (0:
// the launcher's rule)
extern "C" int hpgmg_fv4_slab_f32(const void* x, const void* ilo, const void* ihi,
                                  const void* jlo, const void* jhi, const void* klo,
                                  const void* khi, const void* bie, const void* bje,
                                  const void* bke, const void* alpha, const void* rhs,
                                  const void* kdinv, void* out, int ni, int nj, int nk,
                                  int mode, int periodic, int ksplit, int parity, int chunk,
                                  double scale, double a_coef, int pass, void* stream) {
  return launch_slab<float>(x, ilo, ihi, jlo, jhi, klo, khi, bie, bje, bke, alpha, rhs,
                            kdinv, out, ni, nj, nk, mode, periodic, ksplit, parity, chunk,
                            scale, a_coef, pass, stream);
}

extern "C" int hpgmg_fv4_slab_f64(const void* x, const void* ilo, const void* ihi,
                                  const void* jlo, const void* jhi, const void* klo,
                                  const void* khi, const void* bie, const void* bje,
                                  const void* bke, const void* alpha, const void* rhs,
                                  const void* kdinv, void* out, int ni, int nj, int nk,
                                  int mode, int periodic, int ksplit, int parity, int chunk,
                                  double scale, double a_coef, int pass, void* stream) {
  return launch_slab<double>(x, ilo, ihi, jlo, jhi, klo, khi, bie, bje, bke, alpha, rhs,
                             kdinv, out, ni, nj, nk, mode, periodic, ksplit, parity, chunk,
                             scale, a_coef, pass, stream);
}
