// Test program of the header-only C++ binding (tachyon_tpu.hpp) over the port's
// C ABI: every call of the header, on inputs read from files, its outputs
// written beside them, so a caller can hold its bytes against another
// path (the ctypes calls, the JAX package's recorded bytes).
//
//   test_cc PLATFORM DIR JOB...
//
// PLATFORM goes to tachyon_tpu::Runtime ("cuda", "cpu"); each JOB is
// KIND:NAME[:ARGS] and reads DIR/NAME.<ext>:
//   msm:NAME                      NAME.bases (64-byte x || y), NAME.scalars
//                                 -> NAME.out (64 bytes)
//   fft:NAME:INVERSE              NAME.in (32-byte values) -> NAME.out
//   poseidon2:NAME                NAME.in -> NAME.out (32 bytes)
//   groth16:NAME                  NAME.zkey, NAME.wtns (no_zk, verified)
//                                 -> NAME.proof.json, NAME.public.json
//   halo2:NAME                    NAME.json -> NAME.hex
//   sp1_commit:NAME:B             NAME.bin (matrix stream) -> NAME.out
//   sp1_prove:NAME:B:Q:POW        NAME.bin -> NAME.out
// Each job prints "JOB seconds"; then the error model is checked (a size
// mismatch and a failing call throw tachyon_tpu::Error with the ABI's
// message).  Prints OK last; exits 1 on any failure.
#include <chrono>
#include <cstdio>
#include <fstream>
#include <iostream>
#include <iterator>
#include <sstream>
#include <string>
#include <vector>

#include "tachyon_tpu.hpp"

namespace {

using tachyon_tpu::Fe;

std::vector<uint8_t> ReadFile(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) throw tachyon_tpu::Error("cannot read " + path);
  return std::vector<uint8_t>(std::istreambuf_iterator<char>(f), {});
}

void WriteFile(const std::string& path, const void* data, size_t n) {
  std::ofstream f(path, std::ios::binary);
  f.write(static_cast<const char*>(data), static_cast<std::streamsize>(n));
  if (!f) throw tachyon_tpu::Error("cannot write " + path);
}

void WriteText(const std::string& path, const std::string& s) {
  WriteFile(path, s.data(), s.size());
}

std::vector<Fe> Elements(const std::vector<uint8_t>& bytes) {
  if (bytes.size() % 32) throw tachyon_tpu::Error("not a whole number of 32-byte values");
  std::vector<Fe> out(bytes.size() / 32);
  for (size_t i = 0; i < out.size(); ++i)
    std::copy(&bytes[i * 32], &bytes[i * 32] + 32, out[i].begin());
  return out;
}

std::vector<std::string> Split(const std::string& s, char sep) {
  std::vector<std::string> parts;
  std::stringstream ss(s);
  std::string item;
  while (std::getline(ss, item, sep)) parts.push_back(item);
  return parts;
}

void RunJob(const std::string& dir, const std::string& job) {
  std::vector<std::string> a = Split(job, ':');
  if (a.size() < 2) throw tachyon_tpu::Error("bad job " + job);
  const std::string& kind = a[0];
  const std::string base = dir + "/" + a[1];
  if (kind == "msm") {
    std::vector<uint8_t> b = ReadFile(base + ".bases");
    std::vector<Fe> scalars = Elements(ReadFile(base + ".scalars"));
    std::vector<tachyon_tpu::G1Affine> bases(b.size() / 64);
    for (size_t i = 0; i < bases.size(); ++i) {
      std::copy(&b[i * 64], &b[i * 64] + 32, bases[i].x.begin());
      std::copy(&b[i * 64 + 32], &b[i * 64] + 64, bases[i].y.begin());
    }
    tachyon_tpu::G1Affine r = tachyon_tpu::MsmG1(bases, scalars);
    uint8_t out[64];
    std::copy(r.x.begin(), r.x.end(), out);
    std::copy(r.y.begin(), r.y.end(), out + 32);
    WriteFile(base + ".out", out, sizeof(out));
  } else if (kind == "fft" && a.size() == 3) {
    std::vector<Fe> r = tachyon_tpu::Fft(Elements(ReadFile(base + ".in")), a[2] == "1");
    std::vector<uint8_t> out;
    for (const Fe& v : r) out.insert(out.end(), v.begin(), v.end());
    WriteFile(base + ".out", out.data(), out.size());
  } else if (kind == "poseidon2") {
    Fe d = tachyon_tpu::Poseidon2Hash(Elements(ReadFile(base + ".in")));
    WriteFile(base + ".out", d.data(), d.size());
  } else if (kind == "groth16") {
    tachyon_tpu::Groth16Result r =
        tachyon_tpu::Groth16Prove(base + ".zkey", base + ".wtns", /*no_zk=*/true);
    WriteText(base + ".proof.json", r.proof_json);
    WriteText(base + ".public.json", r.public_json);
  } else if (kind == "halo2") {
    std::vector<uint8_t> spec = ReadFile(base + ".json");
    WriteText(base + ".hex", tachyon_tpu::Halo2Prove(std::string(spec.begin(), spec.end())));
  } else if (kind == "sp1_commit" && a.size() == 3) {
    std::array<uint8_t, 32> r =
        tachyon_tpu::Sp1FriCommit(std::stoul(a[2]), ReadFile(base + ".bin"));
    WriteFile(base + ".out", r.data(), r.size());
  } else if (kind == "sp1_prove" && a.size() == 5) {
    std::array<uint8_t, 32> r = tachyon_tpu::Sp1FriProveVerify(
        std::stoul(a[2]), std::stoul(a[3]), std::stoul(a[4]), ReadFile(base + ".bin"));
    WriteFile(base + ".out", r.data(), r.size());
  } else {
    throw tachyon_tpu::Error("bad job " + job);
  }
}

// The header's error model: a size mismatch and a call the ABI refuses
// both throw tachyon_tpu::Error, the latter with tachyon_tpu_last_error().
void CheckErrors() {
  bool threw = false;
  try {
    tachyon_tpu::MsmG1(std::vector<tachyon_tpu::G1Affine>(2), std::vector<Fe>(1));
  } catch (const tachyon_tpu::Error& e) {
    threw = std::string(e.what()) == "size mismatch";
  }
  if (!threw) throw std::runtime_error("MsmG1 took bases and scalars of two sizes");
  threw = false;
  try {
    tachyon_tpu::Fft(std::vector<Fe>(3), false);  // 3 is not a power of two
  } catch (const tachyon_tpu::Error& e) {
    threw = std::string(e.what()).size() > 0 &&
            std::string(e.what()) == tachyon_tpu_last_error();
  }
  if (!threw) throw std::runtime_error("Fft took 3 values without an Error");
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 3) {
    std::cerr << "usage: test_cc PLATFORM DIR JOB...\n";
    return 2;
  }
  try {
    tachyon_tpu::Runtime rt(argv[1]);
    std::cout << "version " << tachyon_tpu::Runtime::Version() << ", platform " << argv[1]
              << std::endl;
    for (int i = 3; i < argc; ++i) {
      auto t0 = std::chrono::steady_clock::now();
      RunJob(argv[2], argv[i]);
      std::chrono::duration<double> s = std::chrono::steady_clock::now() - t0;
      std::cout << argv[i] << " " << s.count() << std::endl;
    }
    CheckErrors();
  } catch (const std::exception& e) {
    std::cerr << "test_cc: " << e.what() << std::endl;
    return 1;
  }
  std::cout << "OK" << std::endl;
  return 0;
}
