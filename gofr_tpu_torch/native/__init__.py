"""Native (C++) host components, compiled on demand (counterpart of
gofr_tpu/native/__init__.py).

``_gofr_torch_http`` is the HTTP/1.1 wire codec behind the protocol-mode
HTTP server (``httpcore.cc``, used by ``http/nativeserver.py``): request
line and header parse, chunked-body decode, response-head serialization.
It is a copy of the JAX package's ``_gofr_http`` under its own module name,
so both extensions load in one process. ``_gofr_torch_data``
(``datacore.cc``, a copy of JAX's ``_gofr_data`` under its own name) is
the training data loader's batch gather (``gather_windows``: memcpys from
the memory-mapped corpus with the GIL released), loaded by
``load_data_core()``; without it ``data.TokenDataset`` gathers with numpy.

Build: the extension is compiled straight from source with the system
``g++`` against the running interpreter's headers (``sysconfig``; no
pybind11), cached under ``native/_build/`` keyed by the source's mtime and
the interpreter's version. Each process compiles into a name of its own
and renames the result into place, so processes building at once never
load a half-written library. A failed build (no compiler) leaves the
compiler's message in ``_build/<module>.err``; ``load_http_codec()``
then returns None and the App serves through the pure-Python
``AsyncHTTPServer`` with a warning (``load_data_core()`` likewise, and the
loader gathers with numpy). ``GOFR_NATIVE=0`` disables both.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys
import sysconfig

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(_HERE, "_build")
MODULE = "_gofr_torch_http"
DATA_MODULE = "_gofr_torch_data"

_loaded: dict = {}  # module name -> the module, or None once its load failed


def _ext_suffix() -> str:
    return sysconfig.get_config_var("EXT_SUFFIX") or ".so"


def build_error(module: str = MODULE) -> str | None:
    """The compiler's message of ``module``'s last failed build, if any."""
    try:
        with open(os.path.join(_BUILD_DIR, module + ".err")) as f:
            return f.read()
    except OSError:
        return None


def _build(src: str, modname: str) -> str | None:
    """Compile ``src`` into ``_build/<modname><ext_suffix>``; the path, or
    None when compilation is impossible or fails."""
    src_path = os.path.join(_HERE, src)
    out_path = os.path.join(_BUILD_DIR, modname + _ext_suffix())
    stamp_path = out_path + ".stamp"
    stamp = f"{os.path.getmtime(src_path)}:{sys.version_info[:2]}"
    if os.path.exists(out_path) and os.path.exists(stamp_path):
        try:
            with open(stamp_path) as f:
                if f.read() == stamp:
                    return out_path
        except OSError:
            pass
    include = sysconfig.get_paths()["include"]
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # a name per process: two processes building at once must not
    # interleave writes and rename a half-written library into the cache
    tmp_out = out_path + f".tmp.{os.getpid()}"
    cmd = [
        "g++", "-O2", "-std=c++17", "-shared", "-fPIC",
        "-fvisibility=hidden", f"-I{include}", src_path, "-o", tmp_out,
    ]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120, check=False)
    except (OSError, subprocess.TimeoutExpired) as e:
        proc = None
        err = repr(e)
    else:
        err = proc.stderr
    if proc is None or proc.returncode != 0:
        try:
            with open(os.path.join(_BUILD_DIR, modname + ".err"), "w") as f:
                f.write(err)
        except OSError:
            pass
        return None
    os.replace(tmp_out, out_path)
    with open(stamp_path, "w") as f:
        f.write(stamp)
    return out_path


def _import_from(path: str, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    if spec is None or spec.loader is None:
        return None
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load(src: str, modname: str):
    """``modname`` built from ``src`` and imported, once per process; None
    when native components are disabled or the build fails."""
    if modname not in _loaded:
        mod = None
        if os.environ.get("GOFR_NATIVE", "1") != "0":
            try:
                path = _build(src, modname)
                if path:
                    mod = _import_from(path, modname)
            except Exception:  # noqa: BLE001 — a native load must never break the app
                mod = None
        _loaded[modname] = mod
    return _loaded[modname]


def load_http_codec():
    """The ``_gofr_torch_http`` extension module, built if needed; None
    when native components are disabled or the build fails."""
    return _load("httpcore.cc", MODULE)


def load_data_core():
    """The ``_gofr_torch_data`` extension (the data loader's native batch
    gather), built if needed; None when native components are disabled or
    the build fails."""
    return _load("datacore.cc", DATA_MODULE)
