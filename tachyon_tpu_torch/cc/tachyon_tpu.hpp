// Header-only C++ wrapper over the tachyon_tpu C ABI — value semantics,
// RAII, exceptions.  The port's copy of tachyon_tpu/cc/tachyon_tpu.hpp, over
// the port's ../c/api.h (the same symbols).  Analog of the reference's cc layer
// (reference: tachyon/cc/api.h and tachyon/cc/math/... wrappers over
// tachyon/c).  Link against the port's libtachyon_tpu_c.so
// (make -C tachyon_tpu_torch/c); test_cc.cc beside it drives every call.
#ifndef TACHYON_TPU_CC_TACHYON_TPU_HPP_
#define TACHYON_TPU_CC_TACHYON_TPU_HPP_

#include <array>
#include <cstdint>
#include <stdexcept>
#include <string>
#include <utility>
#include <vector>

#include "../c/api.h"

namespace tachyon_tpu {

class Error : public std::runtime_error {
 public:
  explicit Error(const std::string& what) : std::runtime_error(what) {}
};

inline void Check(int rc) {
  if (rc != 0) throw Error(tachyon_tpu_last_error());
}

// 32-byte little-endian field element (standard form).
using Fe = std::array<uint8_t, 32>;

struct G1Affine {
  Fe x{};
  Fe y{};
  bool infinity() const {
    for (auto b : x) if (b) return false;
    for (auto b : y) if (b) return false;
    return true;
  }
};

class Runtime {
 public:
  // platform: "cuda" or "gpu" (or empty) for the card, "cpu" for the plain
  // PyTorch path; the card on a host without CUDA is an error.
  explicit Runtime(const std::string& platform = "") {
    Check(tachyon_tpu_init(platform.empty() ? nullptr : platform.c_str()));
  }
  static std::string Version() { return tachyon_tpu_version_str(); }
};

// sum_i scalars[i] * bases[i] (bn254 G1, variable-base Pippenger).
inline G1Affine MsmG1(const std::vector<G1Affine>& bases,
                      const std::vector<Fe>& scalars) {
  if (bases.size() != scalars.size()) throw Error("size mismatch");
  std::vector<uint8_t> b(bases.size() * 64), s(scalars.size() * 32);
  for (size_t i = 0; i < bases.size(); ++i) {
    std::copy(bases[i].x.begin(), bases[i].x.end(), &b[i * 64]);
    std::copy(bases[i].y.begin(), bases[i].y.end(), &b[i * 64 + 32]);
    std::copy(scalars[i].begin(), scalars[i].end(), &s[i * 32]);
  }
  uint8_t out[64];
  Check(tachyon_tpu_bn254_g1_msm(b.data(), s.data(), bases.size(), out));
  G1Affine r;
  std::copy(out, out + 32, r.x.begin());
  std::copy(out + 32, out + 64, r.y.begin());
  return r;
}

inline std::vector<Fe> Fft(const std::vector<Fe>& values, bool inverse) {
  std::vector<uint8_t> in(values.size() * 32), out(values.size() * 32);
  for (size_t i = 0; i < values.size(); ++i)
    std::copy(values[i].begin(), values[i].end(), &in[i * 32]);
  Check(tachyon_tpu_bn254_fft(in.data(), values.size(), inverse ? 1 : 0,
                              out.data()));
  std::vector<Fe> r(values.size());
  for (size_t i = 0; i < r.size(); ++i)
    std::copy(&out[i * 32], &out[i * 32] + 32, r[i].begin());
  return r;
}

inline Fe Poseidon2Hash(const std::vector<Fe>& inputs) {
  std::vector<uint8_t> in(inputs.size() * 32);
  for (size_t i = 0; i < inputs.size(); ++i)
    std::copy(inputs[i].begin(), inputs[i].end(), &in[i * 32]);
  Fe out{};
  Check(tachyon_tpu_bn254_poseidon2_hash(in.data(), inputs.size(),
                                         out.data()));
  return out;
}

// Halo2 (bn254, Scroll-compat) proof over the JSON circuit schema of
// c/api.h; the backend proves and self-verifies, returning proof hex.
inline std::string Halo2Prove(const std::string& circuit_json) {
  char* hex = nullptr;
  Check(tachyon_tpu_halo2_bn254_prove(circuit_json.c_str(), &hex));
  std::string r(hex ? hex : "");
  tachyon_tpu_free_string(hex);
  return r;
}

// BabyBear Poseidon2 TwoAdicFRI commit (SP1 PCS swap): u32-LE matrix
// stream in (see c/api.h), 8-u32-LE MMCS root out.
inline std::array<uint8_t, 32> Sp1FriCommit(uint32_t log_blowup,
                                            const std::vector<uint8_t>& m) {
  std::array<uint8_t, 32> out{};
  Check(tachyon_tpu_sp1_baby_bear_fri_commit(log_blowup, m.data(), m.size(),
                                             out.data()));
  return out;
}

// Full commit -> challenger-bound open -> verify roundtrip.
inline std::array<uint8_t, 32> Sp1FriProveVerify(
    uint32_t log_blowup, uint32_t num_queries, uint32_t pow_bits,
    const std::vector<uint8_t>& m) {
  std::array<uint8_t, 32> out{};
  Check(tachyon_tpu_sp1_baby_bear_fri_prove_verify(
      log_blowup, num_queries, pow_bits, m.data(), m.size(), out.data()));
  return out;
}

struct Groth16Result {
  std::string proof_json;
  std::string public_json;
};

inline Groth16Result Groth16Prove(const std::string& zkey_path,
                                  const std::string& wtns_path,
                                  bool no_zk = false, bool verify = true) {
  char* proof = nullptr;
  char* pub = nullptr;
  Check(tachyon_tpu_bn254_groth16_prove(zkey_path.c_str(), wtns_path.c_str(),
                                        no_zk ? 1 : 0, verify ? 1 : 0,
                                        &proof, &pub));
  Groth16Result r{proof ? proof : "", pub ? pub : ""};
  tachyon_tpu_free_string(proof);
  tachyon_tpu_free_string(pub);
  return r;
}

}  // namespace tachyon_tpu

#endif  // TACHYON_TPU_CC_TACHYON_TPU_HPP_
