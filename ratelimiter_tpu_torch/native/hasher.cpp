// Bulk 64-bit string hashing: the host-ingest hot path of the port.
//
// A copy of ratelimiter_tpu/native/hasher.cpp (same algorithm, same ABI
// version), so a string key hashes to the same u64 in both packages. Two
// entry points:
//
// * hash_keylist (CPython module function): iterates a Python list of str
//   directly (PyUnicode_AsUTF8AndSize is zero-copy for ASCII and cached
//   per object), with no Python-level packing step. native.bulk_hash_u64
//   uses it.
// * rl_bulk_hash_u64 (plain C ABI, ctypes): hashes a pre-packed
//   buffer+offsets+lengths batch; native.hash_packed uses it.
//
// The algorithm is a word-at-a-time multiply-rotate construction in the
// xxHash/Murmur family (8-byte little-endian lanes, one round per lane,
// splitmix64 finalizer). Its plain twin is native/fallback.py;
// tests/test_torch_hasher.py holds this file bit-identical to it and to
// the JAX package's hasher. Little-endian hosts only (x86-64 / aarch64).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -I$PYTHON_INCLUDE hasher.cpp,
// on first use (native/__init__.py, into ratelimiter_tpu_torch/_build/).

#include <Python.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr uint64_t P1 = 0x9E3779B185EBCA87ULL;  // golden-ratio primes
constexpr uint64_t P2 = 0xC2B2AE3D27D4EB4FULL;
constexpr uint64_t P3 = 0x165667B19E3779F9ULL;

inline uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

// splitmix64 finalizer — same mix as ops/hashing.splitmix64, so integer-id
// and string-key hashes share avalanche quality.
inline uint64_t fmix64(uint64_t x) {
  x ^= x >> 30; x *= 0xBF58476D1CE4E5B9ULL;
  x ^= x >> 27; x *= 0x94D049BB133111EBULL;
  x ^= x >> 31;
  return x;
}

inline uint64_t round64(uint64_t h, uint64_t lane) {
  return rotl64(h ^ (lane * P1), 27) * P2 + P3;
}

inline uint64_t hash_one(const uint8_t* p, int64_t len, uint64_t seed) {
  uint64_t h = seed ^ (static_cast<uint64_t>(len) * P1);
  const int64_t nw = len >> 3;
  for (int64_t w = 0; w < nw; ++w) {
    uint64_t lane;
    std::memcpy(&lane, p + 8 * w, 8);
    h = round64(h, lane);
  }
  const int64_t rem = len & 7;
  if (rem) {
    uint64_t lane = 0;
    std::memcpy(&lane, p + 8 * nw, static_cast<size_t>(rem));
    h = round64(h, lane);
  }
  return fmix64(h);
}

}  // namespace

extern "C" {

// Hash n byte strings packed back-to-back in buf. offsets[i]/lengths[i]
// locate key i; out receives the 64-bit hashes. Single pass, no allocation.
void rl_bulk_hash_u64(const uint8_t* buf, const int64_t* offsets,
                      const int64_t* lengths, uint64_t seed,
                      uint64_t* out, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    out[i] = hash_one(buf + offsets[i], lengths[i], seed);
  }
}

// ABI version so the Python loader can reject a library built from
// another version of the algorithm.
int64_t rl_hasher_abi_version() { return 2; }

}  // extern "C"

// ------------------------------------------------------------------ module

// hash_keylist(keys: list[str], seed: int, out_addr: int) -> None
// Writes hashes into the uint64 buffer at out_addr (len(keys) elements) —
// the caller (native/__init__.py) owns a numpy array and passes
// arr.ctypes.data, which keeps numpy headers out of the build.
static PyObject* hash_keylist(PyObject*, PyObject* args) {
  PyObject* list;
  unsigned long long seed;
  unsigned long long out_addr;
  if (!PyArg_ParseTuple(args, "O!KK", &PyList_Type, &list, &seed, &out_addr)) {
    return nullptr;
  }
  uint64_t* out = reinterpret_cast<uint64_t*>(out_addr);
  const Py_ssize_t n = PyList_GET_SIZE(list);
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* item = PyList_GET_ITEM(list, i);  // borrowed
    Py_ssize_t len;
    const char* data = PyUnicode_AsUTF8AndSize(item, &len);
    if (data == nullptr) {
      return nullptr;  // not a str (or encode failure) — TypeError raised
    }
    out[i] = hash_one(reinterpret_cast<const uint8_t*>(data),
                      static_cast<int64_t>(len),
                      static_cast<uint64_t>(seed));
  }
  Py_RETURN_NONE;
}

static PyMethodDef kMethods[] = {
    {"hash_keylist", hash_keylist, METH_VARARGS,
     "Hash a list of str into the uint64 buffer at out_addr."},
    {nullptr, nullptr, 0, nullptr},
};

static struct PyModuleDef kModule = {
    PyModuleDef_HEAD_INIT, "_hasher",
    "Native bulk string hasher (see hasher.cpp).", -1, kMethods,
    nullptr, nullptr, nullptr, nullptr,
};

PyMODINIT_FUNC PyInit__hasher(void) { return PyModule_Create(&kModule); }
