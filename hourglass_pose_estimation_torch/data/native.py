"""ctypes binding for the native host JPEG loader (`native/hostloader.cpp`).

Port of `hourglass_pose_estimation_tpu/data/native.py`. The library is
built from the source in `native/` with g++ at first use, into this
package's own build directory (`data/native_build/`, ignored by git); the
files under `native/` are only read, and no library found there is loaded
(it may have been built against another machine's libjpeg). The build
links -ljpeg, so it needs libjpeg and `jpeglib.h`; where either is missing
`available()` is false, `unavailable_reason()` says why, and the loaders
return None: `PoseDataset.canvas_batch` then fills every slot with cv2.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

SOURCE = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                       '..', '..', 'native', 'hostloader.cpp'))
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'native_build')
# the C ABI this binding declares (hl_version() of native/hostloader.cpp)
ABI_VERSION = 4

_lock = threading.Lock()
_lib = None
_reason: Optional[str] = None      # why the library is unavailable, once known


def library_path(build_dir: str = BUILD_DIR) -> str:
    return os.path.join(build_dir, 'libhostloader.so')


def build(build_dir: str = BUILD_DIR) -> Optional[str]:
    """Compile `native/hostloader.cpp` into `build_dir`; None on success,
    else why it failed. The compiler writes a name of its own process, which
    is then renamed into place, so another process building at the same time
    never loads a half-written library."""
    if not os.path.isfile(SOURCE):
        return f'no source at {SOURCE}'
    if shutil.which('g++') is None:
        return 'no g++'
    os.makedirs(build_dir, exist_ok=True)
    path = library_path(build_dir)
    tmp = f'{path}.tmp{os.getpid()}'
    try:
        r = subprocess.run(['g++', '-O3', '-fPIC', '-shared', '-std=c++17', '-o', tmp, SOURCE,
                            '-ljpeg', '-lpthread'], capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            err = r.stderr
            if 'jpeglib.h' in err:
                return 'no jpeglib.h (libjpeg headers)'
            if '-ljpeg' in err:
                return 'link failed: no libjpeg'
            tail = [ln for ln in err.splitlines() if ln.strip()][-1:] or ['']
            return f'g++ failed ({r.returncode}): {tail[0]}'
        os.replace(tmp, path)
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _declare(lib) -> None:
    f32p, u8p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_ubyte)
    paths, i = ctypes.POINTER(ctypes.c_char_p), ctypes.c_int
    lib.hl_version.restype = i
    lib.hl_version.argtypes = []
    lib.hl_load_canvas_batch.restype = i
    # paths, n, canvas, threads, out, scales, widths, heights
    lib.hl_load_canvas_batch.argtypes = [paths, i, i, i, u8p, f32p, f32p, f32p]
    lib.hl_load_region_batch.restype = i
    # paths, n, canvas, threads, cx, cy, side, out, q, ox, oy, widths, heights
    lib.hl_load_region_batch.argtypes = [paths, i, i, i, f32p, f32p, f32p, u8p,
                                         f32p, f32p, f32p, f32p, f32p]


def get_lib():
    """The loaded library (built first if this package's build directory
    lacks it), or None when it cannot be built or loaded."""
    global _lib, _reason
    with _lock:
        if _lib is not None or _reason is not None:
            return _lib
        path = library_path()
        if not os.path.isfile(path):
            _reason = build()
            if _reason is not None:
                return None
        try:
            lib = ctypes.CDLL(path)
            _declare(lib)
        except (OSError, AttributeError) as e:
            _reason = f'dlopen failed: {e}'
            return None
        if lib.hl_version() != ABI_VERSION:
            _reason = f'{path} has ABI {lib.hl_version()}, not {ABI_VERSION}'
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def unavailable_reason() -> Optional[str]:
    """None when the library loads; else why not (no g++, no jpeglib.h, the
    link failed, dlopen failed)."""
    get_lib()
    return _reason


def _threads(threads: int) -> int:
    return threads if threads > 0 else min(8, os.cpu_count() or 1)


def load_canvas_batch(paths: List[str], canvas: int, threads: int = 0
                      ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Decode, resize (q = canvas / max(H, W)) and pad a batch of JPEGs.

    Returns (canvases [N, c, c, 3] u8, canvas_scale [N], widths [N],
    ok [N] bool), or None if the library is unavailable. A failed decode
    has scale 0 and ok False (the caller fills that slot with cv2)."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(paths)
    out = np.zeros((n, canvas, canvas, 3), np.uint8)
    scales = np.zeros((n,), np.float32)
    widths = np.zeros((n,), np.float32)
    heights = np.zeros((n,), np.float32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    f32p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    lib.hl_load_canvas_batch(arr, n, canvas, _threads(threads),
                             out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                             f32p(scales), f32p(widths), f32p(heights))
    return out, scales, widths, scales > 0


def load_region_batch(paths: List[str], canvas: int, centers: np.ndarray,
                      sides: np.ndarray, threads: int = 0):
    """Crop-aware packing: the side x side region around each center,
    at q = 1 when it fits the canvas, else downscaled by canvas / side.

    Returns (canvases [N, c, c, 3] u8, q [N], offsets [N, 2] (ox, oy),
    widths [N], ok [N] bool), or None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(paths)
    centers = np.asarray(centers, np.float32)
    cx = np.ascontiguousarray(centers[:, 0])
    cy = np.ascontiguousarray(centers[:, 1])
    sides = np.ascontiguousarray(np.asarray(sides, np.float32))
    if cx.shape != (n,) or sides.shape != (n,):
        raise ValueError(f'{n} paths, centers {centers.shape}, sides {sides.shape}')
    out = np.zeros((n, canvas, canvas, 3), np.uint8)
    q, ox, oy, widths, heights = (np.zeros((n,), np.float32) for _ in range(5))
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    f32p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    lib.hl_load_region_batch(arr, n, canvas, _threads(threads), f32p(cx), f32p(cy), f32p(sides),
                             out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                             f32p(q), f32p(ox), f32p(oy), f32p(widths), f32p(heights))
    return out, q, np.stack([ox, oy], axis=-1), widths, q > 0
