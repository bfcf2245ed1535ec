// _b32native_torch: native runtime helpers for the bonnie32_tpu_torch data
// loader (a copy of the JAX package's _b32native under its own module name,
// so that the two never share a loaded module).
//
// ron_loads(text) — single-pass recursive-descent RON parser building
// Python objects directly.  Matches bonnie32_tpu_torch/io/ron.py's value
// model exactly (see that module's docstring): structs -> dict, tuples -> tuple,
// unit () -> empty tuple, single-item tuple unwraps, Some(x) -> x,
// enum variants -> Tag(name, payload), maps -> {"__ron_map__": True,
// "items": [(k, v), ...]}.
//
// The reference framework parses RON with serde on the Rust side
// (/root/reference/src/world/level.rs, asset/asset.rs, tracker/io.rs);
// this is the equivalent native-speed asset loader.
//
// Built with the CPython C API (no pybind11) by native/__init__.py: g++ at
// first use, into build/native/ under a name keyed on this file's hash.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <string>

namespace {

PyObject *g_tag_factory = nullptr;  // bonnie32_tpu_torch/io/ron.py's Tag

struct Parser {
  const char *p;
  const char *end;
  const char *begin;

  explicit Parser(const char *data, Py_ssize_t n)
      : p(data), end(data + n), begin(data) {}

  bool eof() const { return p >= end; }

  void fail(const char *msg) const {
    PyErr_Format(PyExc_ValueError, "RON parse error at offset %zd: %s",
                 (Py_ssize_t)(p - begin), msg);
  }

  // whitespace + // and /* */ comments (non-nested, like the Python regex)
  void skip_ws() {
    for (;;) {
      while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
        ++p;
      if (p + 1 < end && p[0] == '/' && p[1] == '/') {
        while (p < end && *p != '\n') ++p;
        continue;
      }
      if (p + 1 < end && p[0] == '/' && p[1] == '*') {
        p += 2;
        while (p + 1 < end && !(p[0] == '*' && p[1] == '/')) ++p;
        if (p + 1 < end) p += 2;
        continue;
      }
      return;
    }
  }

  bool at(char c) {
    skip_ws();
    return p < end && *p == c;
  }

  bool eat(char c) {
    if (at(c)) {
      ++p;
      return true;
    }
    return false;
  }

  // ---- strings ----------------------------------------------------------

  PyObject *parse_quoted(char quote) {
    ++p;  // opening quote
    std::string out;
    out.reserve(16);
    while (p < end && *p != quote) {
      char c = *p;
      if (c == '\\') {
        ++p;
        if (p >= end) break;
        char e = *p;
        switch (e) {
          case 'n': out.push_back('\n'); break;
          case 't': out.push_back('\t'); break;
          case 'r': out.push_back('\r'); break;
          case '0': out.push_back('\0'); break;
          case '\\': out.push_back('\\'); break;
          case '"': out.push_back('"'); break;
          case '\'': out.push_back('\''); break;
          case 'u': {
            // \u{XXXX}
            if (p + 1 < end && p[1] == '{') {
              p += 2;
              uint32_t cp = 0;
              while (p < end && *p != '}') {
                char h = *p;
                cp <<= 4;
                if (h >= '0' && h <= '9') cp |= h - '0';
                else if (h >= 'a' && h <= 'f') cp |= h - 'a' + 10;
                else if (h >= 'A' && h <= 'F') cp |= h - 'A' + 10;
                ++p;
              }
              // encode cp as UTF-8
              if (cp < 0x80) {
                out.push_back((char)cp);
              } else if (cp < 0x800) {
                out.push_back((char)(0xC0 | (cp >> 6)));
                out.push_back((char)(0x80 | (cp & 0x3F)));
              } else if (cp < 0x10000) {
                out.push_back((char)(0xE0 | (cp >> 12)));
                out.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
                out.push_back((char)(0x80 | (cp & 0x3F)));
              } else {
                out.push_back((char)(0xF0 | (cp >> 18)));
                out.push_back((char)(0x80 | ((cp >> 12) & 0x3F)));
                out.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
                out.push_back((char)(0x80 | (cp & 0x3F)));
              }
            }
            break;
          }
          default: out.push_back(e); break;  // unknown escape -> literal
        }
        ++p;
      } else {
        out.push_back(c);
        ++p;
      }
    }
    if (p >= end) {
      fail("unterminated string");
      return nullptr;
    }
    ++p;  // closing quote
    return PyUnicode_DecodeUTF8(out.data(), (Py_ssize_t)out.size(), "replace");
  }

  // ---- numbers ----------------------------------------------------------

  PyObject *parse_number() {
    const char *start = p;
    bool neg = false;
    if (*p == '+' || *p == '-') {
      neg = (*p == '-');
      ++p;
    }
    // inf / NaN with sign
    if (p + 2 < end + 1 && strncmp(p, "inf", 3) == 0) {
      p += 3;
      return PyFloat_FromDouble(neg ? -HUGE_VAL : HUGE_VAL);
    }
    if (p + 2 < end + 1 && strncmp(p, "NaN", 3) == 0) {
      p += 3;
      return PyFloat_FromDouble(Py_NAN);
    }
    // hex
    if (p + 1 < end && p[0] == '0' && (p[1] == 'x' || p[1] == 'X')) {
      p += 2;
      std::string digits;
      while (p < end && (isxdigit((unsigned char)*p) || *p == '_')) {
        if (*p != '_') digits.push_back(*p);
        ++p;
      }
      PyObject *v = PyLong_FromString(digits.c_str(), nullptr, 16);
      if (v && neg) {
        PyObject *n = PyNumber_Negative(v);
        Py_DECREF(v);
        return n;
      }
      return v;
    }
    bool is_float = false;
    std::string buf;
    buf.reserve(24);
    if (neg) buf.push_back('-');
    while (p < end) {
      char c = *p;
      if (c >= '0' && c <= '9') {
        buf.push_back(c);
      } else if (c == '_') {
        // skip
      } else if (c == '.') {
        // a '.' only continues the number if followed by digit/_/end-ish
        is_float = true;
        buf.push_back(c);
      } else if (c == 'e' || c == 'E') {
        is_float = true;
        buf.push_back(c);
        if (p + 1 < end && (p[1] == '+' || p[1] == '-')) {
          ++p;
          buf.push_back(*p);
        }
      } else {
        break;
      }
      ++p;
    }
    if (buf.empty() || (buf.size() == 1 && buf[0] == '-')) {
      p = start;
      fail("bad number");
      return nullptr;
    }
    if (is_float) {
      return PyFloat_FromDouble(PyOS_string_to_double(buf.c_str(), nullptr,
                                                      nullptr));
    }
    return PyLong_FromString(buf.c_str(), nullptr, 10);
  }

  // ---- idents -----------------------------------------------------------

  bool ident_start(char c) const {
    return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') || c == '_';
  }
  bool ident_char(char c) const {
    return ident_start(c) || (c >= '0' && c <= '9');
  }

  // returns (start, len) of an ident at p (after skip_ws); empty if none
  Py_ssize_t peek_ident(const char **out_start) {
    skip_ws();
    if (p >= end || !ident_start(*p)) return 0;
    const char *s = p;
    const char *q = p;
    while (q < end && ident_char(*q)) ++q;
    *out_start = s;
    return q - s;
  }

  // ---- compound values ---------------------------------------------------

  PyObject *parse_paren() {
    ++p;  // '('
    if (eat(')')) return PyTuple_New(0);
    // struct lookahead: ident ':'
    const char *is_;
    Py_ssize_t ilen = peek_ident(&is_);
    if (ilen > 0) {
      const char *save = p;
      p = is_ + ilen;
      bool is_struct = at(':');
      p = save;
      if (is_struct) return parse_struct_fields();
    }
    // tuple
    PyObject *items = PyList_New(0);
    if (!items) return nullptr;
    for (;;) {
      if (eat(')')) break;
      PyObject *v = parse_value();
      if (!v) {
        Py_DECREF(items);
        return nullptr;
      }
      PyList_Append(items, v);
      Py_DECREF(v);
      eat(',');
    }
    if (PyList_GET_SIZE(items) == 1) {
      PyObject *only = PyList_GET_ITEM(items, 0);
      Py_INCREF(only);
      Py_DECREF(items);
      return only;  // Some(x)/newtype unwraps
    }
    PyObject *tup = PyList_AsTuple(items);
    Py_DECREF(items);
    return tup;
  }

  PyObject *parse_struct_fields() {
    PyObject *d = PyDict_New();
    if (!d) return nullptr;
    for (;;) {
      if (eat(')')) break;
      const char *ks;
      Py_ssize_t klen = peek_ident(&ks);
      if (klen == 0) {
        fail("expected field name");
        Py_DECREF(d);
        return nullptr;
      }
      p = ks + klen;
      if (!eat(':')) {
        fail("expected ':' after field name");
        Py_DECREF(d);
        return nullptr;
      }
      PyObject *key = PyUnicode_DecodeUTF8(ks, klen, "replace");
      PyObject *v = parse_value();
      if (!key || !v) {
        Py_XDECREF(key);
        Py_XDECREF(v);
        Py_DECREF(d);
        return nullptr;
      }
      PyDict_SetItem(d, key, v);
      Py_DECREF(key);
      Py_DECREF(v);
      eat(',');
    }
    return d;
  }

  PyObject *parse_list() {
    ++p;  // '['
    PyObject *out = PyList_New(0);
    if (!out) return nullptr;
    for (;;) {
      if (eat(']')) break;
      PyObject *v = parse_value();
      if (!v) {
        Py_DECREF(out);
        return nullptr;
      }
      PyList_Append(out, v);
      Py_DECREF(v);
      eat(',');
    }
    return out;
  }

  PyObject *parse_map() {
    ++p;  // '{'
    PyObject *items = PyList_New(0);
    if (!items) return nullptr;
    for (;;) {
      if (eat('}')) break;
      PyObject *k = parse_value();
      if (!k || !eat(':')) {
        if (k && !PyErr_Occurred()) fail("expected ':' in map");
        Py_XDECREF(k);
        Py_DECREF(items);
        return nullptr;
      }
      PyObject *v = parse_value();
      if (!v) {
        Py_DECREF(k);
        Py_DECREF(items);
        return nullptr;
      }
      PyObject *pair = PyTuple_Pack(2, k, v);
      Py_DECREF(k);
      Py_DECREF(v);
      PyList_Append(items, pair);
      Py_DECREF(pair);
      eat(',');
    }
    PyObject *d = PyDict_New();
    if (!d) {
      Py_DECREF(items);
      return nullptr;
    }
    PyDict_SetItemString(d, "__ron_map__", Py_True);
    PyDict_SetItemString(d, "items", items);
    Py_DECREF(items);
    return d;
  }

  PyObject *make_tag(const char *name, Py_ssize_t len, PyObject *payload) {
    PyObject *nm = PyUnicode_DecodeUTF8(name, len, "replace");
    if (!nm) return nullptr;
    PyObject *tag;
    if (payload)
      tag = PyObject_CallFunctionObjArgs(g_tag_factory, nm, payload, nullptr);
    else
      tag = PyObject_CallFunctionObjArgs(g_tag_factory, nm, nullptr);
    Py_DECREF(nm);
    return tag;
  }

  PyObject *parse_value() {
    skip_ws();
    if (eof()) {
      fail("unexpected end of input");
      return nullptr;
    }
    char c = *p;
    if (c == '"') return parse_quoted('"');
    if (c == '\'') return parse_quoted('\'');
    if (c == '(') return parse_paren();
    if (c == '[') return parse_list();
    if (c == '{') return parse_map();
    if (c == '+' || c == '-' || (c >= '0' && c <= '9') || c == '.')
      return parse_number();
    if (ident_start(c)) {
      const char *s;
      Py_ssize_t len = peek_ident(&s);
      p = s + len;
      if (len == 4 && strncmp(s, "true", 4) == 0) Py_RETURN_TRUE;
      if (len == 5 && strncmp(s, "false", 5) == 0) Py_RETURN_FALSE;
      if (len == 4 && strncmp(s, "None", 4) == 0) Py_RETURN_NONE;
      if (len == 3 && strncmp(s, "inf", 3) == 0)
        return PyFloat_FromDouble(HUGE_VAL);
      if (len == 3 && strncmp(s, "NaN", 3) == 0)
        return PyFloat_FromDouble(Py_NAN);
      if (at('(')) {
        PyObject *payload = parse_paren();
        if (!payload) return nullptr;
        if (len == 4 && strncmp(s, "Some", 4) == 0) return payload;
        PyObject *tag = make_tag(s, len, payload);
        Py_DECREF(payload);
        return tag;
      }
      return make_tag(s, len, nullptr);
    }
    fail("unexpected character");
    return nullptr;
  }
};

PyObject *ron_loads(PyObject *, PyObject *arg) {
  if (!g_tag_factory) {
    PyErr_SetString(PyExc_RuntimeError, "tag factory not set");
    return nullptr;
  }
  Py_ssize_t n = 0;
  const char *data = nullptr;
  PyObject *decoded = nullptr;
  if (PyBytes_Check(arg)) {
    data = PyBytes_AS_STRING(arg);
    n = PyBytes_GET_SIZE(arg);
  } else if (PyUnicode_Check(arg)) {
    data = PyUnicode_AsUTF8AndSize(arg, &n);
    if (!data) return nullptr;
  } else {
    PyErr_SetString(PyExc_TypeError, "ron_loads expects str or bytes");
    return nullptr;
  }
  Parser parser(data, n);
  PyObject *v = parser.parse_value();
  if (!v) {
    Py_XDECREF(decoded);
    return nullptr;
  }
  parser.skip_ws();
  if (!parser.eof()) {
    Py_DECREF(v);
    PyErr_SetString(PyExc_ValueError, "RON: trailing data");
    return nullptr;
  }
  return v;
}

PyObject *set_tag_factory(PyObject *, PyObject *arg) {
  Py_XDECREF(g_tag_factory);
  Py_INCREF(arg);
  g_tag_factory = arg;
  Py_RETURN_NONE;
}

PyMethodDef methods[] = {
    {"ron_loads", ron_loads, METH_O,
     "Parse RON text (str/bytes) into Python objects."},
    {"set_tag_factory", set_tag_factory, METH_O,
     "Install the Tag class used for enum variants."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_b32native_torch",
    "Native data-loader helpers for bonnie32_tpu_torch.", -1, methods,
    nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__b32native_torch(void) {
  return PyModule_Create(&moduledef);
}
