// Dense-batch collator of the crystal loader (host code); counterpart of
// arreau_tpu/native/collate.cc, with a float64 instantiation beside the
// float32 one.
//
// Gathers each selected crystal's atoms from the packed columnar store into
// the padded dense [B, A] batch buffers, in one loop. Built as a plain
// shared library and called through ctypes (arreau_tpu_torch/native).
//
// Layout contracts (all row-major, caller-allocated):
//   type_indices [total_atoms] int64 - z-table indices per atom
//   frac_coords  [total_atoms, 3] double
//   offsets      [n_crystals + 1] int64 prefix sums into the atom axis
//   lattices     [n_crystals, 3, 3] double
//   idx          [B] int64 - crystals to collate; idx < 0 emits an empty
//                padding example (mask all 0, num_atoms 0, identity lattice)
// Outputs (T = float or double):
//   frac_out     [B, A, 3] T      (padded with 0)
//   types_out    [B, A] int32     (padded with 0)
//   lattice_out  [B, 3, 3] T
//   num_atoms_out[B] int32
//   mask_out     [B, A] uint8
// Returns 0, or 1 + b where crystal idx[b] has more atoms than A (the
// outputs are then incomplete).

#include <cstdint>
#include <cstring>

namespace {

template <typename T>
int collate_dense(const int64_t* type_indices, const double* frac_coords,
                  const int64_t* offsets, const double* lattices, const int64_t* idx,
                  int64_t batch, int64_t max_atoms, T* frac_out, int32_t* types_out,
                  T* lattice_out, int32_t* num_atoms_out, uint8_t* mask_out) {
  for (int64_t b = 0; b < batch; ++b) {
    const int64_t ci = idx[b];
    T* frac_b = frac_out + b * max_atoms * 3;
    int32_t* types_b = types_out + b * max_atoms;
    uint8_t* mask_b = mask_out + b * max_atoms;
    T* lat_b = lattice_out + b * 9;
    int64_t count = 0;
    if (ci < 0) {  // padding sentinel: the identity lattice keeps the codecs finite
      for (int k = 0; k < 9; ++k) lat_b[k] = (k % 4 == 0) ? T(1) : T(0);
    } else {
      const int64_t start = offsets[ci];
      count = offsets[ci + 1] - start;
      if (count > max_atoms) return static_cast<int>(1 + b);
      for (int64_t a = 0; a < count; ++a) {
        const double* src = frac_coords + (start + a) * 3;
        for (int c = 0; c < 3; ++c) frac_b[a * 3 + c] = static_cast<T>(src[c]);
        types_b[a] = static_cast<int32_t>(type_indices[start + a]);
        mask_b[a] = 1;
      }
      const double* lat_src = lattices + ci * 9;
      for (int k = 0; k < 9; ++k) lat_b[k] = static_cast<T>(lat_src[k]);
    }
    const int64_t pad = max_atoms - count;
    std::memset(frac_b + count * 3, 0, sizeof(T) * 3 * pad);
    std::memset(types_b + count, 0, sizeof(int32_t) * pad);
    std::memset(mask_b + count, 0, sizeof(uint8_t) * pad);
    num_atoms_out[b] = static_cast<int32_t>(count);
  }
  return 0;
}

}  // namespace

extern "C" {

int arreau_collate_dense_f32(const int64_t* type_indices, const double* frac_coords,
                             const int64_t* offsets, const double* lattices,
                             const int64_t* idx, int64_t batch, int64_t max_atoms,
                             float* frac_out, int32_t* types_out, float* lattice_out,
                             int32_t* num_atoms_out, uint8_t* mask_out) {
  return collate_dense<float>(type_indices, frac_coords, offsets, lattices, idx, batch,
                              max_atoms, frac_out, types_out, lattice_out, num_atoms_out,
                              mask_out);
}

int arreau_collate_dense_f64(const int64_t* type_indices, const double* frac_coords,
                             const int64_t* offsets, const double* lattices,
                             const int64_t* idx, int64_t batch, int64_t max_atoms,
                             double* frac_out, int32_t* types_out, double* lattice_out,
                             int32_t* num_atoms_out, uint8_t* mask_out) {
  return collate_dense<double>(type_indices, frac_coords, offsets, lattices, idx, batch,
                               max_atoms, frac_out, types_out, lattice_out, num_atoms_out,
                               mask_out);
}

}  // extern "C"
