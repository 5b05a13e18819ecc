/* Smoke test for the port's C ABI (pure C, no Python visible).
 *
 *   test_capi [platform] [steps]
 *
 * platform is passed to tachyon_tpu_init (default "cuda"); steps is a
 * comma-separated subset of msm,fft,poseidon2,halo2,sp1 (default all).
 * Mirrors the role of the reference's c API unittests
 * (reference: tachyon/c/math/elliptic_curves/msm/msm_unittest.cc flavor):
 * exercises init, MSM, FFT roundtrip, Poseidon2, a halo2 proof and the SP1
 * FRI commit through the ABI and self-checks the algebra
 * (msm([G,G],[1,2]) == msm([G],[3])).  Prints OK on success.
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "api.h"

static void put_le(unsigned char* out, unsigned long v) {
  memset(out, 0, 32);
  for (int i = 0; i < 8; ++i) out[i] = (unsigned char)((v >> (8 * i)) & 0xff);
}

static const char* g_steps = "msm,fft,poseidon2,halo2,sp1";

/* 1 iff `name` is one of the comma-separated entries of g_steps. */
static int step(const char* name) {
  size_t len = strlen(name);
  for (const char* p = g_steps; *p;) {
    const char* end = strchr(p, ',');
    size_t n = end ? (size_t)(end - p) : strlen(p);
    if (n == len && strncmp(p, name, len) == 0) return 1;
    if (!end) break;
    p = end + 1;
  }
  return 0;
}

int main(int argc, char** argv) {
  const char* platform = argc > 1 ? argv[1] : "cuda";
  if (argc > 2) g_steps = argv[2];
  if (tachyon_tpu_init(platform) != 0) {
    fprintf(stderr, "init failed: %s\n", tachyon_tpu_last_error());
    return 1;
  }
  printf("version %s, platform %s, steps %s\n", tachyon_tpu_version_str(), platform,
         g_steps);

  /* MSM: 1*G + 2*G must equal 3*G (G = (1, 2) on bn254). */
  if (step("msm")) {
    unsigned char bases[128], scalars[64], out_a[64], out_b[64];
    memset(bases, 0, sizeof(bases));
    put_le(bases + 0, 1);  /* G.x */
    put_le(bases + 32, 2); /* G.y */
    memcpy(bases + 64, bases, 64);
    put_le(scalars + 0, 1);
    put_le(scalars + 32, 2);
    if (tachyon_tpu_bn254_g1_msm(bases, scalars, 2, out_a) != 0) {
      fprintf(stderr, "msm failed: %s\n", tachyon_tpu_last_error());
      return 1;
    }
    put_le(scalars, 3);
    if (tachyon_tpu_bn254_g1_msm(bases, scalars, 1, out_b) != 0) {
      fprintf(stderr, "msm(3G) failed: %s\n", tachyon_tpu_last_error());
      return 1;
    }
    if (memcmp(out_a, out_b, 64) != 0) {
      fprintf(stderr, "msm mismatch: G+2G != 3G\n");
      return 1;
    }
  }

  /* FFT then IFFT must round-trip. */
  if (step("fft")) {
    enum { N = 8 };
    unsigned char data[N * 32], freq[N * 32], back[N * 32];
    memset(data, 0, sizeof(data));
    for (int i = 0; i < N; ++i) put_le(data + 32 * i, 100 + i);
    if (tachyon_tpu_bn254_fft(data, N, 0, freq) != 0 ||
        tachyon_tpu_bn254_fft(freq, N, 1, back) != 0) {
      fprintf(stderr, "fft failed: %s\n", tachyon_tpu_last_error());
      return 1;
    }
    if (memcmp(data, back, sizeof(data)) != 0) {
      fprintf(stderr, "fft roundtrip mismatch\n");
      return 1;
    }
  }

  /* Poseidon2 digest must be deterministic and non-zero. */
  if (step("poseidon2")) {
    unsigned char msg[64], d1[32], d2[32], zero[32];
    memset(msg, 0, sizeof(msg));
    memset(zero, 0, sizeof(zero));
    put_le(msg, 7);
    put_le(msg + 32, 11);
    if (tachyon_tpu_bn254_poseidon2_hash(msg, 2, d1) != 0 ||
        tachyon_tpu_bn254_poseidon2_hash(msg, 2, d2) != 0) {
      fprintf(stderr, "poseidon2 failed: %s\n", tachyon_tpu_last_error());
      return 1;
    }
    if (memcmp(d1, d2, 32) != 0 || memcmp(d1, zero, 32) == 0) {
      fprintf(stderr, "poseidon2 digest unstable or zero\n");
      return 1;
    }
  }

  /* Halo2 prove over a JSON mul circuit (self-verified inside). */
  if (step("halo2")) {
    const char* circuit =
        "{\"k\": 4, \"num_advice\": 2, \"num_fixed\": 0, "
        "\"num_instance\": 1, "
        "\"equality\": [[\"advice\", 0], [\"instance\", 0]], "
        "\"selectors\": [\"simple\"], "
        "\"gates\": [[[\"prod\", [\"selector\", 0], "
        "[\"sum\", [\"prod\", [\"advice\", 0, 0], [\"advice\", 1, 0]], "
        "[\"neg\", [\"advice\", 0, 1]]]]]], "
        "\"assignments\": {\"advice\": [[3, 12, 0], [4, 0, 0]], "
        "\"selectors\": [[1]], "
        "\"copies\": [[[\"advice\", 0, 1], [\"instance\", 0, 0]]]}, "
        "\"instances\": [[12]]}";
    char* proof_hex = NULL;
    if (tachyon_tpu_halo2_bn254_prove(circuit, &proof_hex) != 0) {
      fprintf(stderr, "halo2 prove failed: %s\n", tachyon_tpu_last_error());
      return 1;
    }
    if (!proof_hex || strlen(proof_hex) < 128) {
      fprintf(stderr, "halo2 proof too short\n");
      return 1;
    }
    tachyon_tpu_free_string(proof_hex);
  }

  /* SP1 FRI: commit-only root must equal the prove_verify roundtrip's. */
  if (step("sp1")) {
    unsigned char mats[4 * (3 + 8 * 2)];
    unsigned char *p = mats;
    unsigned int header[3] = {1u, 8u, 2u}; /* 1 matrix, 8x2 */
    for (int i = 0; i < 3; ++i) {
      memcpy(p, &header[i], 4);
      p += 4;
    }
    for (unsigned int v = 0; v < 16; ++v) {
      unsigned int val = v * 7u + 3u;
      memcpy(p, &val, 4);
      p += 4;
    }
    unsigned char root_c[32], root_pv[32];
    if (tachyon_tpu_sp1_baby_bear_fri_commit(1, mats, sizeof(mats),
                                             root_c) != 0) {
      fprintf(stderr, "sp1 commit failed: %s\n", tachyon_tpu_last_error());
      return 1;
    }
    if (tachyon_tpu_sp1_baby_bear_fri_prove_verify(1, 2, 1, mats,
                                                   sizeof(mats),
                                                   root_pv) != 0) {
      fprintf(stderr, "sp1 prove_verify failed: %s\n",
              tachyon_tpu_last_error());
      return 1;
    }
    if (memcmp(root_c, root_pv, 32) != 0) {
      fprintf(stderr, "sp1 commit root != prove_verify root\n");
      return 1;
    }
  }

  printf("OK\n");
  return 0;
}
