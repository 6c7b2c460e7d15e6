// _gofr_torch_http: native HTTP/1.1 wire codec for the gofr_tpu_torch HTTP
// plane (a copy of gofr_tpu/native/httpcore.cc under its own module name, so
// both extensions load in one process).
//
// Parity note: the reference framework's HTTP plane is compiled Go
// (net/http behind pkg/gofr/httpServer.go:19-50); a pure-Python asyncio
// server cannot sit in the same performance league on the CPU-bound
// config-1 benchmark. This extension moves the per-request wire work
// (request-line + header parse, chunked-body decode, response-head
// serialization) into C++, leaving routing/middleware/handlers in Python.
//
// Exposed functions (CPython C API — pybind11 is not in this image):
//   parse(buffer, offset=0)       -> None | (end, method, target, minor,
//                                            headers dict, content_length,
//                                            flags)
//   parse_chunked(buffer, offset) -> None | (body bytes, end)
//   build_head(status, headers, content_length, close, chunked, body=None)
//                                 -> bytes (head, or head+body when given)
//
// Error protocol: malformed input raises ValueError whose args are
// (http_status, message) so the server can answer 400/413/431/505 without
// string matching. Incomplete input returns None (caller buffers more).
//
// Semantics match the pure-Python parser in gofr_tpu_torch/http/server.py
// (_read_headers/_read_body): header keys lowercased + OWS-stripped,
// duplicate keys last-wins, chunk extensions ignored, trailers skipped.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstring>
#include <cstdint>

namespace {

constexpr Py_ssize_t MAX_BODY = 100LL * 1024 * 1024;  // matches server.py cap

// flags returned by parse()
constexpr int F_CHUNKED = 1;
constexpr int F_CLOSE = 2;
constexpr int F_EXPECT_CONTINUE = 4;
constexpr int F_KEEPALIVE = 8;  // explicit "connection: keep-alive"

PyObject *http_error(int status, const char *msg) {
  PyObject *args = Py_BuildValue("(is)", status, msg);
  if (args) {
    PyErr_SetObject(PyExc_ValueError, args);
    Py_DECREF(args);
  }
  return nullptr;
}

inline char ascii_lower(char c) {
  return (c >= 'A' && c <= 'Z') ? char(c + 32) : c;
}

inline bool is_ows(char c) { return c == ' ' || c == '\t'; }

// strip optional whitespace in [b, e)
inline void strip_ows(const char *&b, const char *&e) {
  while (b < e && is_ows(*b)) ++b;
  while (e > b && is_ows(e[-1])) --e;
}

// case-insensitive equality against a lowercase literal; bounded by the
// literal's own terminator so network bytes containing NULs cannot walk
// past the end of the rodata string
bool ieq(const char *b, Py_ssize_t n, const char *lit) {
  Py_ssize_t i = 0;
  for (; i < n; ++i) {
    if (lit[i] == '\0' || ascii_lower(b[i]) != lit[i]) return false;
  }
  return lit[i] == '\0';
}

// parse(buffer, offset=0)
PyObject *parse(PyObject *, PyObject *args) {
  Py_buffer view;
  Py_ssize_t offset = 0;
  if (!PyArg_ParseTuple(args, "y*|n", &view, &offset)) return nullptr;
  const char *buf = static_cast<const char *>(view.buf);
  const Py_ssize_t len = view.len;
  PyObject *result = nullptr;

  do {
    if (offset < 0 || offset > len) {
      PyBuffer_Release(&view);
      return http_error(500, "bad offset");
    }
    const char *base = buf + offset;
    const Py_ssize_t n = len - offset;
    // locate end of head: CRLFCRLF
    const char *head_end = static_cast<const char *>(
        memmem(base, static_cast<size_t>(n), "\r\n\r\n", 4));
    if (!head_end) break;  // incomplete -> None
    const Py_ssize_t end = (head_end - base) + 4 + offset;

    // ---- request line ---------------------------------------------------
    const char *p = base;
    const char *line_end = static_cast<const char *>(
        memchr(p, '\r', static_cast<size_t>(head_end - p + 1)));
    if (!line_end) line_end = head_end;
    // bare CR is not a line terminator (RFC 9112 2.2) — treating it as one
    // while a peer parser doesn't is a request-smuggling differential
    if (line_end[1] != '\n') {
      PyBuffer_Release(&view);
      return http_error(400, "bare CR in request line");
    }
    const char *sp1 = static_cast<const char *>(
        memchr(p, ' ', static_cast<size_t>(line_end - p)));
    if (!sp1) {
      PyBuffer_Release(&view);
      return http_error(400, "malformed request line");
    }
    const char *sp2 = static_cast<const char *>(
        memchr(sp1 + 1, ' ', static_cast<size_t>(line_end - sp1 - 1)));
    if (!sp2 || static_cast<const char *>(memchr(
                    sp2 + 1, ' ', static_cast<size_t>(line_end - sp2 - 1)))) {
      PyBuffer_Release(&view);
      return http_error(400, "malformed request line");
    }
    // empty method/target reject BEFORE the version check — server.py
    // validates in that order, and the status must match on requests that
    // are invalid in multiple ways
    char method_buf[32];
    Py_ssize_t mlen = sp1 - p;
    if (mlen <= 0 || mlen > 31 || sp2 - sp1 <= 1) {
      PyBuffer_Release(&view);
      return http_error(400, "malformed request line");
    }
    for (Py_ssize_t i = 0; i < mlen; ++i) {
      char c = p[i];
      method_buf[i] = (c >= 'a' && c <= 'z') ? char(c - 32) : c;
    }

    // version: HTTP/1.<minor>
    const char *v = sp2 + 1;
    const Py_ssize_t vlen = line_end - v;
    if (vlen < 8 || memcmp(v, "HTTP/1.", 7) != 0) {
      PyBuffer_Release(&view);
      return http_error(505, "http version not supported");
    }
    int minor = 1;
    if (v[7] == '0' && vlen == 8) minor = 0;
    PyObject *method = PyUnicode_DecodeLatin1(method_buf, mlen, nullptr);
    PyObject *target = PyUnicode_DecodeLatin1(sp1 + 1, sp2 - sp1 - 1, nullptr);
    PyObject *headers = PyDict_New();
    if (!method || !target || !headers) {
      Py_XDECREF(method); Py_XDECREF(target); Py_XDECREF(headers);
      PyBuffer_Release(&view);
      return nullptr;
    }

    // ---- header lines ---------------------------------------------------
    Py_ssize_t content_length = -1;
    int flags = 0;
    bool bad = false;
    bool saw_cl = false, saw_te = false;
    int bad_status = 400;
    const char *bad_msg = "malformed header";
    p = (line_end < head_end) ? line_end + 2 : head_end;
    char keybuf[256];
    while (p < head_end && !bad) {
      const char *eol = static_cast<const char *>(
          memchr(p, '\r', static_cast<size_t>(head_end - p + 1)));
      if (!eol) eol = head_end;
      if (eol[1] != '\n') {  // bare CR inside a field line (RFC 9112 2.2)
        bad = true; bad_msg = "bare CR in header"; break;
      }
      if (eol == p) { p = eol + 2; continue; }  // empty line
      // obs-fold (RFC 7230 3.2.4): a continuation line would otherwise
      // parse as a fresh header and desync against proxies that unfold
      if (is_ows(*p)) { bad = true; bad_msg = "obsolete line folding"; break; }
      const char *colon = static_cast<const char *>(
          memchr(p, ':', static_cast<size_t>(eol - p)));
      if (!colon) { bad = true; break; }
      const char *kb = p, *ke = colon;
      strip_ows(kb, ke);
      const char *vb = colon + 1, *ve = eol;
      strip_ows(vb, ve);
      Py_ssize_t klen = ke - kb;
      if (klen <= 0 || klen > 255) { bad = true; break; }
      for (Py_ssize_t i = 0; i < klen; ++i) keybuf[i] = ascii_lower(kb[i]);

      // special-case the connection-management headers as we go
      if (klen == 14 && memcmp(keybuf, "content-length", 14) == 0) {
        Py_ssize_t cl = 0;
        bool overflow = false;
        if (vb == ve) { bad = true; bad_msg = "bad content-length"; break; }
        for (const char *q = vb; q < ve; ++q) {
          if (*q < '0' || *q > '9') {
            bad = true; bad_msg = "bad content-length"; break;
          }
          if (cl > MAX_BODY) overflow = true;  // clamp, keep validating digits
          else cl = cl * 10 + (*q - '0');
        }
        if (bad) break;
        Py_ssize_t parsed = overflow ? MAX_BODY + 1 : cl;
        // duplicate Content-Length with a different value is a smuggling
        // vector (proxies disagree on which wins) -> hard 400
        if (saw_cl && parsed != content_length) {
          bad = true; bad_msg = "conflicting content-length"; break;
        }
        saw_cl = true;
        // a numeric but oversized length is 413, not 400 (server.py parity)
        content_length = parsed;
      } else if (klen == 17 && memcmp(keybuf, "transfer-encoding", 17) == 0) {
        // RFC 7230 3.3.3: the FINAL coding must be chunked; anything else
        // (e.g. "gzip") would leave the body length undefined and lets a
        // front proxy frame the stream differently than we do -> 400
        saw_te = true;
        const char *lb = vb, *le = ve;  // last comma-separated token
        for (const char *q = ve; q > vb; --q) {
          if (q[-1] == ',') { lb = q; break; }
        }
        strip_ows(lb, le);
        if (le - lb == 7 && ieq(lb, 7, "chunked")) flags |= F_CHUNKED;
        else { bad = true; bad_msg = "unsupported transfer-encoding"; break; }
      } else if (klen == 10 && memcmp(keybuf, "connection", 10) == 0) {
        if (ieq(vb, ve - vb, "close")) flags |= F_CLOSE;
        else if (ieq(vb, ve - vb, "keep-alive")) flags |= F_KEEPALIVE;
      } else if (klen == 6 && memcmp(keybuf, "expect", 6) == 0) {
        if (ieq(vb, ve - vb, "100-continue")) flags |= F_EXPECT_CONTINUE;
      }

      PyObject *key = PyUnicode_DecodeLatin1(keybuf, klen, nullptr);
      PyObject *val = PyUnicode_DecodeLatin1(vb, ve - vb, nullptr);
      if (!key || !val || PyDict_SetItem(headers, key, val) < 0) {
        Py_XDECREF(key); Py_XDECREF(val);
        Py_DECREF(method); Py_DECREF(target); Py_DECREF(headers);
        PyBuffer_Release(&view);
        return nullptr;
      }
      Py_DECREF(key); Py_DECREF(val);
      p = eol + 2;
    }
    // Transfer-Encoding and Content-Length together is the canonical
    // request-smuggling ambiguity (RFC 7230 3.3.3 says TE wins, but
    // proxies differ) -> reject outright
    if (!bad && saw_te && saw_cl) {
      bad = true; bad_msg = "content-length with transfer-encoding";
    }
    if (bad) {
      Py_DECREF(method); Py_DECREF(target); Py_DECREF(headers);
      PyBuffer_Release(&view);
      return http_error(bad_status, bad_msg);
    }
    if (content_length > MAX_BODY) {
      Py_DECREF(method); Py_DECREF(target); Py_DECREF(headers);
      PyBuffer_Release(&view);
      return http_error(413, "body too large");
    }
    result = Py_BuildValue("(nNNiNni)", end, method, target, minor, headers,
                           content_length, flags);
  } while (false);

  PyBuffer_Release(&view);
  if (!result && !PyErr_Occurred()) Py_RETURN_NONE;
  return result;
}

// parse_chunked(buffer, offset) -> None | (body bytes, end)
PyObject *parse_chunked(PyObject *, PyObject *args) {
  Py_buffer view;
  Py_ssize_t offset = 0;
  if (!PyArg_ParseTuple(args, "y*|n", &view, &offset)) return nullptr;
  const char *buf = static_cast<const char *>(view.buf);
  const Py_ssize_t len = view.len;

  // first pass: walk chunks, compute total size; second: copy
  Py_ssize_t p = offset;
  Py_ssize_t total = 0;
  bool incomplete = false;
  // record (start, size) pairs in a small growable stack buffer
  Py_ssize_t static_spans[64][2];
  Py_ssize_t (*spans)[2] = static_spans;
  Py_ssize_t nspans = 0, cap_spans = 64;
  PyObject *result = nullptr;

  for (;;) {
    const char *nl = static_cast<const char *>(
        memmem(buf + p, static_cast<size_t>(len - p), "\r\n", 2));
    if (!nl) { incomplete = true; break; }
    // hex size, extensions after ';' ignored
    Py_ssize_t q = p;
    Py_ssize_t size = 0;
    bool any = false, badsize = false;
    for (; buf + q < nl; ++q) {
      char c = buf[q];
      int d;
      if (c >= '0' && c <= '9') d = c - '0';
      else if (c >= 'a' && c <= 'f') d = c - 'a' + 10;
      else if (c >= 'A' && c <= 'F') d = c - 'A' + 10;
      else if (c == ';') break;
      else { badsize = true; break; }
      size = size * 16 + d;
      any = true;
      if (size > MAX_BODY) { badsize = true; break; }
    }
    if (badsize || !any) {
      if (spans != static_spans) PyMem_Free(spans);
      PyBuffer_Release(&view);
      // valid hex that merely exceeds the cap is an oversized body (413,
      // server.py parity); non-hex garbage is a framing error (400)
      if (badsize && any && size > MAX_BODY)
        return http_error(413, "body too large");
      return http_error(400, "bad chunk size");
    }
    p = (nl - buf) + 2;
    if (size == 0) {
      // trailers until blank line
      for (;;) {
        const char *t = static_cast<const char *>(
            memmem(buf + p, static_cast<size_t>(len - p), "\r\n", 2));
        if (!t) { incomplete = true; break; }
        Py_ssize_t tl = t - (buf + p);
        p = (t - buf) + 2;
        if (tl == 0) break;  // blank line terminates trailers
      }
      break;
    }
    total += size;
    if (total > MAX_BODY) {
      if (spans != static_spans) PyMem_Free(spans);
      PyBuffer_Release(&view);
      return http_error(413, "body too large");
    }
    if (p + size + 2 > len) { incomplete = true; break; }
    if (nspans == cap_spans) {
      Py_ssize_t newcap = cap_spans * 2;
      Py_ssize_t (*ns)[2] = static_cast<Py_ssize_t (*)[2]>(
          PyMem_Malloc(sizeof(Py_ssize_t) * 2 * newcap));
      if (!ns) {
        if (spans != static_spans) PyMem_Free(spans);
        PyBuffer_Release(&view);
        return PyErr_NoMemory();
      }
      memcpy(ns, spans, sizeof(Py_ssize_t) * 2 * nspans);
      if (spans != static_spans) PyMem_Free(spans);
      spans = ns;
      cap_spans = newcap;
    }
    spans[nspans][0] = p;
    spans[nspans][1] = size;
    ++nspans;
    p += size;
    if (buf[p] != '\r' || buf[p + 1] != '\n') {
      if (spans != static_spans) PyMem_Free(spans);
      PyBuffer_Release(&view);
      return http_error(400, "bad chunk framing");
    }
    p += 2;
  }

  if (!incomplete) {
    result = PyBytes_FromStringAndSize(nullptr, total);
    if (result) {
      char *dst = PyBytes_AS_STRING(result);
      for (Py_ssize_t i = 0; i < nspans; ++i) {
        memcpy(dst, buf + spans[i][0], static_cast<size_t>(spans[i][1]));
        dst += spans[i][1];
      }
      PyObject *tup = Py_BuildValue("(Nn)", result, p);
      result = tup;  // tup owns body ref; nullptr on failure propagates
    }
  }
  if (spans != static_spans) PyMem_Free(spans);
  PyBuffer_Release(&view);
  if (!result && !PyErr_Occurred()) Py_RETURN_NONE;
  return result;
}

// parse_chunked_step(buffer, offset) -> (data bytes, new_offset, done)
//
// Incremental sibling of parse_chunked: consumes every COMPLETE chunk
// available from `offset` and returns their concatenated payload plus the
// resume offset. done=1 once the terminating 0-chunk AND its trailers are
// fully present (new_offset then points past the body). The protocol
// server keeps (offset, collected parts) across data_received calls so a
// large chunked upload is parsed once, not re-scanned per TCP segment
// (O(n) total instead of O(n^2)).
PyObject *parse_chunked_step(PyObject *, PyObject *args) {
  Py_buffer view;
  Py_ssize_t offset = 0;
  if (!PyArg_ParseTuple(args, "y*|n", &view, &offset)) return nullptr;
  const char *buf = static_cast<const char *>(view.buf);
  const Py_ssize_t len = view.len;

  Py_ssize_t p = offset;
  Py_ssize_t total = 0;
  int done = 0;
  Py_ssize_t static_spans[64][2];
  Py_ssize_t (*spans)[2] = static_spans;
  Py_ssize_t nspans = 0, cap_spans = 64;

  for (;;) {
    const Py_ssize_t chunk_start = p;
    const char *nl = static_cast<const char *>(
        memmem(buf + p, static_cast<size_t>(len - p), "\r\n", 2));
    if (!nl) break;  // size line incomplete -> resume at chunk_start
    Py_ssize_t q = p;
    Py_ssize_t size = 0;
    bool any = false, badsize = false;
    for (; buf + q < nl; ++q) {
      char c = buf[q];
      int d;
      if (c >= '0' && c <= '9') d = c - '0';
      else if (c >= 'a' && c <= 'f') d = c - 'a' + 10;
      else if (c >= 'A' && c <= 'F') d = c - 'A' + 10;
      else if (c == ';') break;
      else { badsize = true; break; }
      size = size * 16 + d;
      any = true;
      if (size > MAX_BODY) { badsize = true; break; }
    }
    if (badsize || !any) {
      if (spans != static_spans) PyMem_Free(spans);
      PyBuffer_Release(&view);
      if (badsize && any && size > MAX_BODY)
        return http_error(413, "body too large");
      return http_error(400, "bad chunk size");
    }
    p = (nl - buf) + 2;
    if (size == 0) {
      // trailers must be fully present to finish; else resume at the
      // 0-chunk so the next call re-examines it with more data
      bool trailers_done = false;
      Py_ssize_t tp = p;
      for (;;) {
        const char *t = static_cast<const char *>(
            memmem(buf + tp, static_cast<size_t>(len - tp), "\r\n", 2));
        if (!t) break;
        Py_ssize_t tl = t - (buf + tp);
        tp = (t - buf) + 2;
        if (tl == 0) { trailers_done = true; break; }
      }
      if (trailers_done) { p = tp; done = 1; }
      else p = chunk_start;
      break;
    }
    if (p + size + 2 > len) { p = chunk_start; break; }  // data incomplete
    if (nspans == cap_spans) {
      Py_ssize_t newcap = cap_spans * 2;
      Py_ssize_t (*ns)[2] = static_cast<Py_ssize_t (*)[2]>(
          PyMem_Malloc(sizeof(Py_ssize_t) * 2 * newcap));
      if (!ns) {
        if (spans != static_spans) PyMem_Free(spans);
        PyBuffer_Release(&view);
        return PyErr_NoMemory();
      }
      memcpy(ns, spans, sizeof(Py_ssize_t) * 2 * nspans);
      if (spans != static_spans) PyMem_Free(spans);
      spans = ns;
      cap_spans = newcap;
    }
    spans[nspans][0] = p;
    spans[nspans][1] = size;
    ++nspans;
    total += size;
    if (total > MAX_BODY) {
      if (spans != static_spans) PyMem_Free(spans);
      PyBuffer_Release(&view);
      return http_error(413, "body too large");
    }
    p += size;
    if (buf[p] != '\r' || buf[p + 1] != '\n') {
      if (spans != static_spans) PyMem_Free(spans);
      PyBuffer_Release(&view);
      return http_error(400, "bad chunk framing");
    }
    p += 2;
  }

  PyObject *data = PyBytes_FromStringAndSize(nullptr, total);
  PyObject *result = nullptr;
  if (data) {
    char *dst = PyBytes_AS_STRING(data);
    for (Py_ssize_t i = 0; i < nspans; ++i) {
      memcpy(dst, buf + spans[i][0], static_cast<size_t>(spans[i][1]));
      dst += spans[i][1];
    }
    result = Py_BuildValue("(Nni)", data, p, done);
  }
  if (spans != static_spans) PyMem_Free(spans);
  PyBuffer_Release(&view);
  return result;
}

const char *status_text(int s) {
  switch (s) {
    case 200: return "OK";
    case 201: return "Created";
    case 204: return "No Content";
    case 301: return "Moved Permanently";
    case 302: return "Found";
    case 304: return "Not Modified";
    case 400: return "Bad Request";
    case 401: return "Unauthorized";
    case 403: return "Forbidden";
    case 404: return "Not Found";
    case 405: return "Method Not Allowed";
    case 408: return "Request Timeout";
    case 409: return "Conflict";
    case 413: return "Payload Too Large";
    case 429: return "Too Many Requests";
    case 431: return "Request Header Fields Too Large";
    case 500: return "Internal Server Error";
    case 503: return "Service Unavailable";
    case 505: return "HTTP Version Not Supported";
    default: return "Status";
  }
}

// build_head(status, headers, content_length, close, chunked, body=None)
PyObject *build_head(PyObject *, PyObject *args) {
  int status, close_conn, chunked;
  PyObject *headers;        // sequence of (str, str)
  Py_ssize_t content_length;  // -1 = omit
  PyObject *body = Py_None;
  if (!PyArg_ParseTuple(args, "iOnii|O", &status, &headers, &content_length,
                        &close_conn, &chunked, &body))
    return nullptr;

  PyObject *seq = PySequence_Fast(headers, "headers must be a sequence");
  if (!seq) return nullptr;
  const Py_ssize_t nh = PySequence_Fast_GET_SIZE(seq);

  // measure pass
  size_t need = 64;  // status line + final CRLF slack
  bool has_cl = false, has_te = false;
  for (Py_ssize_t i = 0; i < nh; ++i) {
    PyObject *item = PySequence_Fast_GET_ITEM(seq, i);
    if (!PyTuple_Check(item) || PyTuple_GET_SIZE(item) != 2) {
      Py_DECREF(seq);
      PyErr_SetString(PyExc_TypeError, "header items must be 2-tuples");
      return nullptr;
    }
    Py_ssize_t kl, vl;
    const char *k = PyUnicode_AsUTF8AndSize(PyTuple_GET_ITEM(item, 0), &kl);
    const char *v = PyUnicode_AsUTF8AndSize(PyTuple_GET_ITEM(item, 1), &vl);
    if (!k || !v) { Py_DECREF(seq); return nullptr; }
    // CR/LF/NUL in a name or value would let a handler echoing untrusted
    // input split the response (Go's net/http sanitizes these too)
    for (Py_ssize_t j = 0; j < kl; ++j) {
      char c = k[j];
      if (c == '\r' || c == '\n' || c == '\0') {
        Py_DECREF(seq);
        PyErr_SetString(PyExc_ValueError, "invalid header name");
        return nullptr;
      }
    }
    for (Py_ssize_t j = 0; j < vl; ++j) {
      char c = v[j];
      if (c == '\r' || c == '\n' || c == '\0') {
        Py_DECREF(seq);
        PyErr_SetString(PyExc_ValueError, "invalid header value");
        return nullptr;
      }
    }
    need += size_t(kl) + size_t(vl) + 4;
    if (kl == 14 && ieq(k, 14, "content-length")) has_cl = true;
    if (kl == 17 && ieq(k, 17, "transfer-encoding")) has_te = true;
  }
  need += 48 /* content-length line */ + 48 /* te/conn lines */;
  const char *body_buf = nullptr;
  Py_ssize_t body_len = 0;
  if (body != Py_None) {
    if (PyBytes_Check(body)) {
      body_buf = PyBytes_AS_STRING(body);
      body_len = PyBytes_GET_SIZE(body);
    } else {
      Py_DECREF(seq);
      PyErr_SetString(PyExc_TypeError, "body must be bytes or None");
      return nullptr;
    }
    if (content_length < 0 && !chunked) content_length = body_len;
    need += size_t(body_len);
  }

  PyObject *out = PyBytes_FromStringAndSize(nullptr, Py_ssize_t(need));
  if (!out) { Py_DECREF(seq); return nullptr; }
  char *w = PyBytes_AS_STRING(out);
  char *w0 = w;
  w += snprintf(w, 64, "HTTP/1.1 %d %s\r\n", status, status_text(status));
  for (Py_ssize_t i = 0; i < nh; ++i) {
    PyObject *item = PySequence_Fast_GET_ITEM(seq, i);
    Py_ssize_t kl, vl;
    const char *k = PyUnicode_AsUTF8AndSize(PyTuple_GET_ITEM(item, 0), &kl);
    const char *v = PyUnicode_AsUTF8AndSize(PyTuple_GET_ITEM(item, 1), &vl);
    memcpy(w, k, size_t(kl)); w += kl;
    *w++ = ':'; *w++ = ' ';
    memcpy(w, v, size_t(vl)); w += vl;
    *w++ = '\r'; *w++ = '\n';
  }
  Py_DECREF(seq);
  if (close_conn) {
    memcpy(w, "Connection: close\r\n", 19); w += 19;
  }
  if (chunked && !has_te) {
    memcpy(w, "Transfer-Encoding: chunked\r\n", 28); w += 28;
  }
  if (!chunked && !has_cl && content_length >= 0) {
    // %zd of a 64-bit value can need 37 bytes incl. terminator; bound at
    // 48 (reserved above) so snprintf can never truncate and over-advance
    w += snprintf(w, 48, "Content-Length: %zd\r\n", content_length);
  }
  *w++ = '\r'; *w++ = '\n';
  if (body_buf && body_len) {
    memcpy(w, body_buf, size_t(body_len)); w += body_len;
  }
  if (_PyBytes_Resize(&out, w - w0) < 0) return nullptr;
  return out;
}

PyMethodDef methods[] = {
    {"parse", parse, METH_VARARGS,
     "parse(buf, offset=0) -> None | (end, method, target, minor, headers, "
     "content_length, flags)"},
    {"parse_chunked", parse_chunked, METH_VARARGS,
     "parse_chunked(buf, offset=0) -> None | (body, end)"},
    {"parse_chunked_step", parse_chunked_step, METH_VARARGS,
     "parse_chunked_step(buf, offset=0) -> (data, new_offset, done)"},
    {"build_head", build_head, METH_VARARGS,
     "build_head(status, headers, content_length, close, chunked, body=None) "
     "-> bytes"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_gofr_torch_http",
    "Native HTTP/1.1 wire codec (see gofr_tpu_torch/native/httpcore.cc)",
    -1, methods, nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__gofr_torch_http(void) {
  PyObject *m = PyModule_Create(&moduledef);
  if (!m) return nullptr;
  PyModule_AddIntConstant(m, "F_CHUNKED", F_CHUNKED);
  PyModule_AddIntConstant(m, "F_CLOSE", F_CLOSE);
  PyModule_AddIntConstant(m, "F_EXPECT_CONTINUE", F_EXPECT_CONTINUE);
  PyModule_AddIntConstant(m, "F_KEEPALIVE", F_KEEPALIVE);
  return m;
}
