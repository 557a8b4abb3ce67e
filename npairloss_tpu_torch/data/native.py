"""The port's ctypes binding of the native data runtime
(``native/npair_data.cpp``, built unchanged from that file).

The C++ library reads a ``relative/path label`` list file, samples
identity-balanced batches, decodes (JPEG where it links libjpeg;
PPM/PGM/BMP and uint8 NPY always) and resizes with OpenCV's half-pixel
bilinear rule, all on worker threads off the GIL, into a bounded ring of
uint8 NHWC batches.  It is compiled with g++ at first use into
``build/native_torch/`` at the repository root, named by a hash of the
source and the flags; nothing is built when this module is imported.

Batches come out as uint8 tensors, in pinned memory when asked, so the
loader can copy them to the card asynchronously.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

SRC = Path(__file__).resolve().parents[2] / "native" / "npair_data.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native_torch"
_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

log = logging.getLogger(__name__)

_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_U8P = ctypes.POINTER(ctypes.c_ubyte)
_IP = ctypes.POINTER(ctypes.c_int)
_LLP = ctypes.POINTER(ctypes.c_longlong)

# Every entry point of the C ABI: name -> (restype, argtypes).
_SIGNATURES = {
    "nd_last_error": (ctypes.c_char_p, []),
    "nd_has_jpeg": (_I, []),
    "nd_dataset_open": (_VP, [ctypes.c_char_p, ctypes.c_char_p, _I, _I,
                              _LLP]),
    "nd_dataset_labels": (None, [_VP, _LLP]),
    "nd_dataset_dims": (_I, [_VP, _LL, _IP, _IP]),
    "nd_dataset_load": (_I, [_VP, _LL, _U8P, _IP, _IP]),
    "nd_dataset_close": (None, [_VP]),
    "nd_loader_create": (_VP, [_VP, _I, _I, _I, _I, ctypes.c_ulonglong,
                               _I, _I]),
    "nd_loader_next": (_I, [_VP, _U8P, _IP]),
    "nd_loader_close": (None, [_VP]),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_error: Optional[str] = None


def _compile(out: str, extra) -> None:
    subprocess.run(["g++", *_FLAGS, str(SRC), "-o", out, *extra],
                   check=True, capture_output=True, text=True)


def build(force: bool = False) -> Path:
    """Compile the runtime unless this exact build exists (or ``force``);
    returns its path.  Links libjpeg first; only a link failure that
    names jpeg (the header is there, the library is not) retries without
    JPEG (``-DND_NO_JPEG``), any other failure raises."""
    digest = hashlib.sha256(" ".join(_FLAGS).encode() + SRC.read_bytes())
    so = BUILD_DIR / f"libnpair_data-{digest.hexdigest()[:16]}.so"
    if so.exists() and not force:
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Compile to a temporary name and rename: a concurrent process never
    # loads a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        try:
            _compile(tmp, ["-ljpeg"])
        except subprocess.CalledProcessError as exc:
            if "jpeg" not in (exc.stderr or "").lower():
                raise RuntimeError(
                    f"native build failed: {exc.stderr}") from exc
            log.warning("libjpeg link failed (%s); building the native "
                        "data runtime without JPEG",
                        (exc.stderr or "").strip().splitlines()[-1:])
            try:
                _compile(tmp, ["-DND_NO_JPEG"])
            except subprocess.CalledProcessError as exc2:
                raise RuntimeError(
                    f"native build failed: {exc2.stderr}") from exc2
        os.replace(tmp, so)
    except FileNotFoundError as exc:  # no g++
        raise RuntimeError(f"native build failed: {exc}") from exc
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def library() -> ctypes.CDLL:
    """The bound runtime, built at first use; a failure is kept and
    raised again (RuntimeError) on every later call."""
    global _lib, _lib_error
    with _lock:
        if _lib is not None:
            return _lib
        if _lib_error is not None:
            raise RuntimeError(_lib_error)
        try:
            try:
                lib = ctypes.CDLL(str(build()))
            except OSError:
                # A build this machine cannot load (made on another one,
                # against a libjpeg this one lacks): build it here, once.
                lib = ctypes.CDLL(str(build(force=True)))
        except (OSError, RuntimeError) as exc:
            _lib_error = f"native data runtime unavailable: {exc}"
            raise RuntimeError(_lib_error) from exc
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
        return lib


def native_available() -> bool:
    """True when the runtime builds (or was built) and loads."""
    try:
        library()
        return True
    except RuntimeError:
        return False


def native_suffixes() -> Tuple[str, ...]:
    """Image suffixes the loaded runtime decodes itself: the loader's
    routing contract."""
    base = (".ppm", ".pgm", ".bmp", ".npy")
    if library().nd_has_jpeg():
        return base + (".jpg", ".jpeg")
    return base


def _err(lib) -> str:
    return lib.nd_last_error().decode("utf-8", "replace")


def _ptr(t: torch.Tensor, ctype):
    """A ctypes pointer to a CPU tensor's data (kept alive by the
    caller)."""
    return ctypes.cast(t.data_ptr(), ctypes.POINTER(ctype))


class NativeListFileDataset:
    """The native counterpart of ``ListFileDataset``: the same list-file
    contract, decoded and resized in C++."""

    def __init__(self, root_folder: str, source: str,
                 new_height: int = 0, new_width: int = 0):
        self._lib = library()
        n = ctypes.c_longlong()
        self._handle = self._lib.nd_dataset_open(
            root_folder.encode(), source.encode(), int(new_height),
            int(new_width), ctypes.byref(n))
        if not self._handle:
            raise RuntimeError(_err(self._lib))
        self._n = int(n.value)
        self.new_height = int(new_height)
        self.new_width = int(new_width)
        labels = np.empty(self._n, np.int64)
        self._lib.nd_dataset_labels(
            self._handle, labels.ctypes.data_as(_LLP))
        self.labels = labels

    def __len__(self) -> int:
        return self._n

    def dims(self, index: int) -> Tuple[int, int]:
        """(h, w) of the item: the resize dims, or its own when unset."""
        if self._handle is None:
            raise RuntimeError("dataset is closed")
        oh, ow = ctypes.c_int(), ctypes.c_int()
        if self._lib.nd_dataset_dims(self._handle, int(index),
                                     ctypes.byref(oh), ctypes.byref(ow)):
            raise RuntimeError(_err(self._lib))
        return int(oh.value), int(ow.value)

    def load(self, index: int) -> np.ndarray:
        """One image, uint8 RGB [new_height, new_width, 3]."""
        if self._handle is None:
            raise RuntimeError("dataset is closed")
        if not (self.new_height and self.new_width):
            raise ValueError("load() needs new_height/new_width (the "
                             "MultibatchData contract's fixed shape)")
        out = np.empty((self.new_height, self.new_width, 3), np.uint8)
        oh, ow = ctypes.c_int(), ctypes.c_int()
        if self._lib.nd_dataset_load(self._handle, int(index),
                                     out.ctypes.data_as(_U8P),
                                     ctypes.byref(oh), ctypes.byref(ow)):
            raise RuntimeError(_err(self._lib))
        return out

    def load_batch(self, indices) -> np.ndarray:
        return np.stack([self.load(int(i)) for i in indices])

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.nd_dataset_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter shutdown: nothing left to report
            pass


class NativePrefetcher:
    """Iterator of (uint8 images [B, H, W, 3], int32 labels [B]) CPU
    tensors from the C++ worker pool; ``pin_memory`` puts them in pinned
    memory, which the native copy fills directly."""

    def __init__(self, dataset: NativeListFileDataset,
                 identity_num_per_batch: int, img_num_per_identity: int,
                 rand_identity: bool = True, shuffle: bool = True,
                 seed: int = 0, threads: int = 2, prefetch: int = 2,
                 pin_memory: bool = False):
        self._ds = dataset  # the loader holds a raw pointer to it
        self._lib = dataset._lib
        self.batch_size = identity_num_per_batch * img_num_per_identity
        self.h, self.w = dataset.new_height, dataset.new_width
        self.pin_memory = pin_memory
        self._handle = self._lib.nd_loader_create(
            dataset._handle, int(identity_num_per_batch),
            int(img_num_per_identity), int(bool(rand_identity)),
            int(bool(shuffle)), int(seed), int(threads), int(prefetch))
        if not self._handle:
            raise RuntimeError(_err(self._lib))

    def __iter__(self):
        return self

    def __next__(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self._handle is None:
            raise StopIteration("loader is closed")
        images = torch.empty((self.batch_size, self.h, self.w, 3),
                             dtype=torch.uint8, pin_memory=self.pin_memory)
        labels = torch.empty(self.batch_size, dtype=torch.int32,
                             pin_memory=self.pin_memory)
        if self._lib.nd_loader_next(self._handle,
                                    _ptr(images, ctypes.c_ubyte),
                                    _ptr(labels, ctypes.c_int)):
            raise RuntimeError(_err(self._lib))
        return images, labels

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.nd_loader_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter shutdown: nothing left to report
            pass
