// One-pass batch encoder over a Python list of sequences.
//
// Port-only source (the JAX package has no copy), built apart from
// packer.cpp and traceback.cpp into a library of its own by
// agatha_tpu_torch/native/__init__.py and loaded through ctypes.PyDLL:
// it calls the CPython API, so it runs with the GIL held, on the calling
// thread.  A host without Python's headers loses only this entry.
//
// agatha_encode_list reads each item's bytes in place (a str's UTF-8
// through PyUnicode_AsUTF8AndSize, the same bytes str.encode() gives and,
// for an ASCII str, its own buffer with no copy; a bytes object's
// buffer) and writes the codes of agatha_encode_batch (packer.cpp) into
// one flat slab, each sequence at an offset padded to 8 bases:
//   * 4-bit code = byte & 0xF
//   * pad with 'N' (code 14) to a multiple of 8 bases
//   * op bit0: reverse over the FULL padded width
//   * op bit1: complement A<->T (1<->4), C<->G (3<->7)

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <vector>

namespace {

const uint8_t kNCode = 14;  // 'N' & 0xF

struct Lut {
  uint8_t plain[16];
  uint8_t comp[16];
  Lut() {
    for (int c = 0; c < 16; ++c) plain[c] = comp[c] = uint8_t(c);
    comp[1] = 4;  // A -> T
    comp[4] = 1;  // T -> A
    comp[3] = 7;  // C -> G
    comp[7] = 3;  // G -> C
  }
};
const Lut kLut;

// One padded row: codes, N padding, then the op, as packer.cpp does it
// (the complement of N is N, so the order of the two steps is free).
void encode_row(const uint8_t* __restrict__ seq, int64_t len, uint8_t op,
                uint8_t* __restrict__ row) {
  const int64_t padded = (len + 7) & ~int64_t(7);
  const uint8_t* map = (op & 0x2) ? kLut.comp : kLut.plain;
  if (op & 0x1) {  // reverse over the padded width: the padding leads
    uint8_t* end = row + padded - 1;
    for (int64_t j = 0; j < len; ++j) end[-j] = map[seq[j] & 0xF];
    for (int64_t j = 0; j < padded - len; ++j) row[j] = kNCode;
  } else if (op & 0x2) {
    for (int64_t j = 0; j < len; ++j) row[j] = map[seq[j] & 0xF];
    for (int64_t j = len; j < padded; ++j) row[j] = kNCode;
  } else {
    for (int64_t j = 0; j < len; ++j) row[j] = seq[j] & 0xF;
    for (int64_t j = len; j < padded; ++j) row[j] = kNCode;
  }
}

}  // namespace

extern "C" {

// Encode the n = len(seqs) items of a list of str / bytes.
//
//   seqs    : list of str or bytes
//   ops     : list of n ints (bit0 reverse, bit1 complement), or None
//   slab    : output codes, cap bytes; may be NULL when cap is 0
//   offsets : out, n+1 padded offsets into slab (offsets[n] = total)
//   lens    : out, per-sequence length in bytes
//
// Always fills offsets and lens.  Returns the total padded size; the
// codes are written only when it is <= cap, so a call with cap 0 sizes
// the slab.  Returns -1 if seqs is not a list, ops is neither None nor
// a list of n ints, or an item is neither str nor bytes; -2 if a str
// has no UTF-8 form (a lone surrogate).  No Python error is left set.
int64_t agatha_encode_list(PyObject* seqs, PyObject* ops, uint8_t* slab,
                           int64_t cap, int64_t* offsets, int32_t* lens) {
  if (!PyList_Check(seqs)) return -1;
  const Py_ssize_t n = PyList_GET_SIZE(seqs);
  if (ops != Py_None && (!PyList_Check(ops) || PyList_GET_SIZE(ops) != n)) {
    return -1;
  }
  std::vector<const uint8_t*> ptrs(n);
  int64_t total = 0;
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* item = PyList_GET_ITEM(seqs, i);
    Py_ssize_t len;
    const char* p;
    if (PyUnicode_Check(item)) {
      p = PyUnicode_AsUTF8AndSize(item, &len);
      if (p == nullptr) {
        PyErr_Clear();
        return -2;
      }
    } else if (PyBytes_Check(item)) {
      p = PyBytes_AS_STRING(item);
      len = PyBytes_GET_SIZE(item);
    } else {
      return -1;
    }
    ptrs[i] = reinterpret_cast<const uint8_t*>(p);
    offsets[i] = total;
    lens[i] = static_cast<int32_t>(len);
    total += (int64_t(len) + 7) & ~int64_t(7);
  }
  offsets[n] = total;
  if (total > cap) return total;
  for (Py_ssize_t i = 0; i < n; ++i) {
    uint8_t op = 0;
    if (ops != Py_None) {
      const long v = PyLong_AsLong(PyList_GET_ITEM(ops, i));
      if (v == -1 && PyErr_Occurred()) {
        PyErr_Clear();
        return -1;
      }
      op = static_cast<uint8_t>(v);
    }
    encode_row(ptrs[i], lens[i], op, slab + offsets[i]);
  }
  return total;
}

}  // extern "C"
