"""Build and load the port's C++ host runtime (``native/*.cpp``).

Two libraries, each from one source: ``tokenizer`` (the batch WordPiece
tokenizer, no dependency) and ``image_decode`` (libjpeg/libpng decode and
bilinear resize), so a machine without the image libraries loses only the
decoder.  Each compiles with ``g++`` at first use into ``_build/`` inside
the package, named by a hash of its source and flags, so an edited source is
rebuilt and a stale library is never loaded.  ``ctypes`` releases the GIL
during every call, so threaded callers decode and tokenize in parallel.

The decoder has two routes, tried in order: the system's libjpeg and
libpng (``-ljpeg -lpng``, as the JAX package's ``native/build.sh``), and,
where their development files are missing, the copies of libjpeg-turbo
(ABI 62) and libpng 1.6 that Pillow's wheel bundles in ``pillow.libs/``,
compiled through the public headers in ``native/include/``.

Nothing is built at import time; a library that cannot build or load is
None, its compiler output stays in :data:`errors`, and callers fall back to
the pure-Python paths.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import importlib.util
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Sequence, Tuple

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE_DIR = os.path.join(_PKG, "native")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")
SOURCES = {"tokenizer": "tokenizer.cpp", "image_decode": "image_decode.cpp"}
BUILD_TIMEOUT_S = 120

_locks = {name: threading.Lock() for name in SOURCES}
_loaded: Dict[str, Optional[ctypes.CDLL]] = {}
# Why a library is None, or why a route before the one that loaded failed:
# the compiler's output or the loader's error, by library name.
errors: Dict[str, str] = {}
# The route each loaded library was built by ("system" or "pillow").
routes: Dict[str, str] = {}


def _pillow_libs() -> Optional[Tuple[str, str]]:
    """Pillow's bundled libjpeg and libpng16, or None."""
    spec = importlib.util.find_spec("PIL")
    if spec is None or spec.origin is None:
        return None
    libs = os.path.join(os.path.dirname(os.path.dirname(spec.origin)),
                        "pillow.libs")
    jpeg = sorted(glob.glob(os.path.join(libs, "libjpeg-*.so*")))
    png = sorted(glob.glob(os.path.join(libs, "libpng16-*.so*")))
    return (jpeg[0], png[0]) if jpeg and png else None


def _routes(name: str) -> List[Tuple[str, Tuple[str, ...]]]:
    """``(route, extra g++ arguments)`` to try in order for ``name``."""
    if name == "tokenizer":
        return [("system", ())]
    routes_ = [("system", ("-ljpeg", "-lpng"))]
    bundled = _pillow_libs()
    if bundled is not None:
        routes_.append(("pillow", (
            "-I", os.path.join(SOURCE_DIR, "include"), *bundled,
            "-Wl,-rpath," + os.path.dirname(bundled[0]))))
    return routes_


def lib_path(name: str, extra: Sequence[str] = ()) -> str:
    """The library of ``SOURCES[name]`` built with ``extra`` arguments,
    named by a hash of the source (and headers) and of every flag."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS + tuple(extra)).encode())
    files = [os.path.join(SOURCE_DIR, SOURCES[name])]
    if "-I" in extra:
        files += sorted(glob.glob(os.path.join(SOURCE_DIR, "include", "*.h")))
    for path in files:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:12]}.so")


def _compile(name: str, extra: Sequence[str]) -> Tuple[str, Optional[str]]:
    """Start ``g++`` for one route; ``(output, error)`` once it ends."""
    out = lib_path(name, extra)
    if os.path.exists(out):
        return out, None
    cxx = shutil.which("g++")
    if cxx is None:
        return out, "g++ not found"
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.Popen(
        [cxx, *CXX_FLAGS, os.path.join(SOURCE_DIR, SOURCES[name]), *extra,
         "-o", tmp], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        log, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        return out, f"g++ timed out after {BUILD_TIMEOUT_S} s"
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        return out, f"g++ failed (rc={proc.returncode}):\n{log}"
    os.replace(tmp, out)          # atomic: concurrent builders never clash
    return out, None


def build(names: Sequence[str]) -> Dict[str, Optional[str]]:
    """Build and load the named libraries, one thread each (:func:`load`).
    Returns the route that each came from, None where none did (the
    reasons are in :data:`errors`).  Never raises for a failed build."""
    threads = [threading.Thread(target=load, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return {n: routes.get(n) for n in names}


def _declare(name: str, lib: ctypes.CDLL) -> None:
    if name == "tokenizer":
        lib.wp_create.restype = ctypes.c_void_p
        lib.wp_create.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.wp_destroy.restype = None
        lib.wp_destroy.argtypes = [ctypes.c_void_p]
        lib.wp_encode_batch.restype = None
        lib.wp_encode_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
    else:
        lib.img_decode_resize.restype = ctypes.c_int
        lib.img_decode_resize.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8)]
        lib.img_jpeg_lib_version.restype = ctypes.c_int
        lib.img_jpeg_lib_version.argtypes = []
        lib.img_png_version.restype = ctypes.c_char_p
        lib.img_png_version.argtypes = []


def load(name: str) -> Optional[ctypes.CDLL]:
    """The loaded library ``name`` (``"tokenizer"`` or ``"image_decode"``),
    built on first use: the first route that compiles and loads (a library
    built against libraries this machine lacks fails to load, and the next
    route is tried).  None when none does; the reasons are in
    :data:`errors`.  The outcome is kept for the life of the process."""
    with _locks[name]:
        if name in _loaded:
            return _loaded[name]
        os.makedirs(BUILD_DIR, exist_ok=True)
        lib, failed = None, []
        for route, extra in _routes(name):
            path, err = _compile(name, extra)
            if err is None:
                try:
                    lib = ctypes.CDLL(path)
                    _declare(name, lib)
                    routes[name] = route
                    break
                except (OSError, AttributeError) as e:
                    lib, err = None, f"load failed: {e}"
            failed.append(f"[{route}] {err}")
        if failed:
            errors[name] = "\n".join(failed)
        _loaded[name] = lib
        return lib
