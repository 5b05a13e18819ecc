/* tachyon_tpu C ABI — the language-binding boundary, over the PyTorch/CUDA
 * port (tachyon_tpu_torch).
 *
 * The same surface as tachyon_tpu/c/api.h: the same tachyon_tpu_* symbols,
 * signatures, version and error model, so the rs, node and cc bindings link
 * this libtachyon_tpu_c.so unchanged.  Analog of the reference's
 * monomorphized C API layer (reference: tachyon/c/api.h,
 * c/math/elliptic_curves/msm/msm.h, c/zk/plonk/halo2/bn254_prover.h,
 * tachyon/c/version.h).  The library embeds a CPython runtime that drives
 * tachyon_tpu_torch.c.bridge on the card; external frontends (Rust via
 * bindgen, C++, Node) never see Python.
 *
 * All functions return 0 on success, negative on failure unless stated;
 * tachyon_tpu_last_error() describes the most recent failure.
 * Field elements cross the boundary as 32-byte little-endian values
 * (standard form, not Montgomery), matching the reference's default I/O
 * convention (tachyon_bn254_fq / tachyon_bn254_fr byte layout).
 */
#ifndef TACHYON_TPU_C_API_H_
#define TACHYON_TPU_C_API_H_

#include <stddef.h>
#include <stdint.h>

#if defined(__cplusplus)
extern "C" {
#endif

#define TACHYON_TPU_VERSION_MAJOR 0
#define TACHYON_TPU_VERSION_MINOR 2
#define TACHYON_TPU_VERSION_PATCH 0
#define TACHYON_TPU_VERSION                                        \
  (TACHYON_TPU_VERSION_MAJOR * 10000 + TACHYON_TPU_VERSION_MINOR * 100 + \
   TACHYON_TPU_VERSION_PATCH)

uint32_t tachyon_tpu_version(void);
const char* tachyon_tpu_version_str(void);

/* Runtime ----------------------------------------------------------------
 * platform: "cuda", "gpu", NULL or "" for the card (cuda:0), "cpu" for the
 * plain PyTorch path; anything else is an error, and so is the card on a
 * host without CUDA (there is no fallback to the CPU).  Initializes the
 * embedded Python runtime (or joins the caller's) and the port's bridge;
 * safe to call more than once after it has succeeded. */
int tachyon_tpu_init(const char* platform);
void tachyon_tpu_shutdown(void);
const char* tachyon_tpu_last_error(void);

/* Frees any string returned through a char** out-param. */
void tachyon_tpu_free_string(char* s);

/* MSM --------------------------------------------------------------------
 * bases: n affine points, 64 bytes each (x||y, 32-byte LE limbs; the
 * point at infinity is encoded as x=y=0).  scalars: n 32-byte LE values.
 * out: 64-byte affine result (x=y=0 for infinity).
 * (reference: tachyon_bn254_g1_point2_msm, c/math/.../msm.h) */
int tachyon_tpu_bn254_g1_msm(const uint8_t* bases, const uint8_t* scalars,
                             size_t n, uint8_t* out64);

/* NTT --------------------------------------------------------------------
 * In-place-style radix-2 (i)FFT over BN254 Fr: n 32-byte LE scalars in,
 * same out.  n must be a power of two dividing the field's 2-adic
 * subgroup.  (reference: tachyon_bn254_univariate_evaluation_domain_fft /
 * _ifft, c/math/polynomials/univariate/bn254_univariate_evaluation_domain.h)
 */
int tachyon_tpu_bn254_fft(const uint8_t* in, size_t n, int inverse,
                          uint8_t* out);

/* Poseidon2 --------------------------------------------------------------
 * Hashes n BN254 Fr elements (32-byte LE each) with the Horizen-flavor
 * width-3 Poseidon2 sponge; writes the 32-byte LE digest.
 * (reference: c/crypto/hashes/sponge/poseidon2 surface) */
int tachyon_tpu_bn254_poseidon2_hash(const uint8_t* inputs, size_t n,
                                     uint8_t* out32);

/* Groth16 ----------------------------------------------------------------
 * Proves a circom circuit from .zkey/.wtns paths; returns snarkjs-format
 * proof.json / public.json strings (caller frees with
 * tachyon_tpu_free_string).  no_zk!=0 makes the proof deterministic
 * (r = s = 0); verify!=0 verifies before returning (failure -> error).
 * (reference: vendors/circom/prover_main.cc CreateProof flow) */
int tachyon_tpu_bn254_groth16_prove(const char* zkey_path,
                                    const char* wtns_path, int no_zk,
                                    int verify, char** proof_json_out,
                                    char** public_json_out);

/* Halo2 (bn254, Scroll vendor) --------------------------------------------
 * Proves a circuit described as JSON and verifies the result; the proof
 * bytes come back hex-encoded (caller frees with tachyon_tpu_free_string).
 * The pipeline is bit-compatible with halo2 (reference:
 * c/zk/plonk/halo2/bn254_prover.cc tachyon_halo2_bn254_prover_create_proof;
 * goldens in tests/test_halo2_golden.py).
 *
 * circuit_json schema:
 *   { "k": 4, "pcs": "shplonk"|"gwc", "lookup_type": "halo2"|
 *     "log_derivative",
 *     "num_advice": 3, "num_fixed": 1, "num_instance": 1,
 *     "equality": [["advice",0], ...],  "constants": [["fixed",0]],
 *     "selectors": ["simple"|"complex", ...],
 *     "gates": [[<expr>, ...], ...],
 *     "lookups": [{"inputs": [<expr>...], "tables": [<expr>...]}],
 *     "shuffles": [{"inputs": [...], "shuffles": [...]}],
 *     "assignments": {"advice": [[row-major ints]...],
 *                     "fixed": [[...]...],
 *                     "selectors": [[0/1...]...],
 *                     "copies": [[["advice",0,row],["instance",0,row]]...]},
 *     "instances": [[...], ...] }
 *   <expr> = ["const", v] | ["fixed", col, rot] | ["advice", col, rot]
 *          | ["instance", col, rot] | ["challenge", idx, phase]
 *          | ["selector", idx] | ["neg", e] | ["sum", a, b]
 *          | ["prod", a, b] | ["scaled", e, v]
 */
int tachyon_tpu_halo2_bn254_prove(const char* circuit_json,
                                  char** proof_hex_out);

/* SP1 / AIR (BabyBear Poseidon2 TwoAdicFRI) -------------------------------
 * Commits the given matrices (coset LDE batch + field-merkle-tree MMCS),
 * opens them at a challenger-bound point and verifies the FRI proof.
 * matrices: u32 LE stream: num_matrices, then per matrix
 * (rows, cols, rows*cols row-major BabyBear values).  out32 receives the
 * tallest tree's Poseidon2 commitment (8 u32 LE).
 * (reference: c/zk/air/sp1/baby_bear_poseidon2_two_adic_fri.cc) */
int tachyon_tpu_sp1_baby_bear_fri_prove_verify(
    uint32_t log_blowup, uint32_t num_queries, uint32_t pow_bits,
    const uint8_t* matrices, size_t matrices_len, uint8_t* out32);

/* Commit-only variant for the SP1 PCS swap: coset-LDE batch + Poseidon2
 * field-merkle-tree commitment of the matrices, no opening proof.  Same
 * matrix stream; out32 receives the 8-u32-LE MMCS root.
 * (reference: the commit half of vendors/sp1/src/two_adic_fri_pcs.rs) */
int tachyon_tpu_sp1_baby_bear_fri_commit(uint32_t log_blowup,
                                         const uint8_t* matrices,
                                         size_t matrices_len, uint8_t* out32);

#if defined(__cplusplus)
}
#endif

#endif /* TACHYON_TPU_C_API_H_ */
