"""ctypes binding of the native dataset loader native/dataset_loader.cpp
(counterpart of dani_slam_tpu/utils/native.py): zlib-PNG and PNM decoding
and a std::thread read-ahead pool, built with g++ on first use.

The library is built into build/native/ of the checkout, never next to its
source, and safely for processes that build at the same time: each build
holds an exclusive `fcntl.flock` on build/native/libdataset_loader.lock,
compiles to a temporary file in that directory and `os.replace`s it into
place, so a process either finds a finished library and loads it or waits
for the one building. Without g++ or zlib the loaders of utils/io decode
the images in Python (PNM; PIL where installed): this is the host's image
decoder, not a device path.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import tempfile
import threading

import numpy as np

_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
SRC = os.path.normpath(os.path.join(_ROOT, "native", "dataset_loader.cpp"))
BUILD_DIR = os.path.normpath(os.path.join(_ROOT, "build", "native"))
LIB_NAME = "libdataset_loader.so"

_libs: dict = {}                 # build dir -> loaded library or None
_libs_lock = threading.Lock()


def _fresh(so: str) -> bool:
    return os.path.exists(so) and \
        os.path.getmtime(so) >= os.path.getmtime(SRC)


def build_library(build_dir: str = BUILD_DIR):
    """Path of an up-to-date build of the loader in `build_dir`, compiling
    it under the directory's file lock when missing or older than its
    source; None when it cannot be built (no source, g++ or zlib)."""
    so = os.path.join(build_dir, LIB_NAME)
    if not os.path.exists(SRC):
        return None
    if _fresh(so):
        return so
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, "libdataset_loader.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            if _fresh(so):               # another process built it meanwhile
                return so
            fd, tmp = tempfile.mkstemp(dir=build_dir, suffix=".so.tmp")
            os.close(fd)
            cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", SRC,
                   "-lz", "-lpthread", "-o", tmp]
            try:
                subprocess.run(cmd, check=True, capture_output=True,
                               timeout=300)
            except (OSError, subprocess.CalledProcessError,
                    subprocess.TimeoutExpired):
                os.unlink(tmp)
                return None
            os.replace(tmp, so)
            return so
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)


def _bind(lib):
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.dsl_decode.restype = ctypes.c_int
    lib.dsl_decode.argtypes = [ctypes.c_char_p, u8p, ctypes.c_int64, i32p,
                               i32p, i32p, i32p]
    lib.dsl_probe.restype = ctypes.c_int
    lib.dsl_probe.argtypes = [ctypes.c_char_p, i32p, i32p, i32p, i32p]
    lib.dsl_prefetcher_create.restype = ctypes.c_void_p
    lib.dsl_prefetcher_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int]
    lib.dsl_prefetcher_get.restype = ctypes.c_int
    lib.dsl_prefetcher_get.argtypes = [ctypes.c_void_p, ctypes.c_int64, u8p,
                                       ctypes.c_int64, i32p, i32p, i32p, i32p]
    lib.dsl_prefetcher_destroy.restype = None
    lib.dsl_prefetcher_destroy.argtypes = [ctypes.c_void_p]
    return lib


def get_lib(build_dir: str = BUILD_DIR):
    """The loaded library of `build_dir`, built on first use; None when it
    cannot be built or loaded. Memoized per directory for the process."""
    with _libs_lock:
        if build_dir not in _libs:
            so = build_library(build_dir)
            try:
                _libs[build_dir] = None if so is None else \
                    _bind(ctypes.CDLL(so))
            except OSError:
                _libs[build_dir] = None
        return _libs[build_dir]


def _wrap(buf, w, h, c, bps):
    dt = np.uint16 if bps.value == 2 else np.uint8
    arr = np.frombuffer(buf, dtype=dt, count=w.value * h.value * c.value)
    arr = arr.reshape(h.value, w.value, c.value)
    return arr[..., 0] if c.value == 1 else arr


def load_image_native(path: str):
    """Decode one image with the native library; None on any failure."""
    lib = get_lib()
    if lib is None:
        return None
    w, h, c, bps = (ctypes.c_int32() for _ in range(4))
    if lib.dsl_probe(path.encode(), ctypes.byref(w), ctypes.byref(h),
                     ctypes.byref(c), ctypes.byref(bps)) != 0:
        return None
    cap = w.value * h.value * c.value * bps.value
    buf = (ctypes.c_uint8 * cap)()
    if lib.dsl_decode(path.encode(), buf, cap, ctypes.byref(w),
                      ctypes.byref(h), ctypes.byref(c),
                      ctypes.byref(bps)) != 0:
        return None
    return _wrap(buf, w, h, c, bps).copy()


class ImagePrefetcher:
    """Sequential dataset reader with native threaded read-ahead: images
    arrive decoded while the previous frame runs on the device. Decodes
    synchronously with utils/io.load_image when the library is absent.
    Close it (or use it as a context manager) to stop its threads."""

    def __init__(self, paths, n_threads: int = 2, window: int = 8):
        self.paths = list(paths)
        self._handle = None
        self._lib = get_lib()
        if self._lib is not None and self.paths:
            self._arr = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths])            # kept alive
            self._handle = self._lib.dsl_prefetcher_create(
                self._arr, len(self.paths), n_threads, window)

    def __len__(self):
        return len(self.paths)

    def __iter__(self):
        for i in range(len(self.paths)):
            yield self.get(i)

    def get(self, i: int):
        from dani_slam_tpu_torch.utils.io import load_image
        if self._handle is None:
            return load_image(self.paths[i])
        w, h, c, bps = (ctypes.c_int32() for _ in range(4))
        cap = 4 * 4096 * 4096
        buf = (ctypes.c_uint8 * cap)()
        if self._lib.dsl_prefetcher_get(
                self._handle, i, buf, cap, ctypes.byref(w), ctypes.byref(h),
                ctypes.byref(c), ctypes.byref(bps)) != 0:
            return load_image(self.paths[i])
        return _wrap(buf, w, h, c, bps).copy()

    def close(self):
        if self._handle is not None:
            self._lib.dsl_prefetcher_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
