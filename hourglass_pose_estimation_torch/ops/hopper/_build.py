"""Build and load the Hopper kernels of `csrc/*.cu`.

Each source is compiled by its own `nvcc` (all started together) for
`sm_90a` into an object with a plain C interface; the objects are linked
into one shared library that `ctypes` loads. Nothing here touches CUDA
until `library()` is first called, so every module imports on a machine
without a GPU or a CUDA toolkit.

The library lands in `ops/hopper/build/` (ignored by git), named by a
hash of the sources and flags, so a changed source rebuilds and an
unchanged one loads at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

PKG_ROOT = Path(__file__).resolve().parents[2]
CSRC = PKG_ROOT / 'csrc'
BUILD_DIR = Path(__file__).resolve().parent / 'build'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C entry point -> argument types (each returns cudaError_t as int, but
# hpe_bn_reduce_blocks, which returns a block count)
SIGNATURES = {
    'hpe_bottleneck_fwd': [_P] * 14 + [_I] * 6 + [_P],
    'hpe_bottleneck_smem_bytes': [_I, _I],
    'hpe_bottleneck_image_fwd': [_P] * 14 + [_I] * 6 + [_P],
    'hpe_bottleneck_image_max_clusters': [_I, _I, _I, ctypes.POINTER(_I)],
    'hpe_upsample2x_add': [_P, _P, _P] + [_I] * 6 + [_P],
    'hpe_upsample2x_add_bwd': [_P, _P] + [_I] * 6 + [_P],
    'hpe_maxpool2x2_fwd': [_P, _P] + [_I] * 6 + [_P],
    'hpe_maxpool2x2_bwd': [_P, _P, _P] + [_I] * 7 + [_P],
    'hpe_render_gaussian': [_P, _P, _P] + [_I] * 5 + [_F, _I, _P],
    'hpe_decode_peaks': [_P, _P, _P] + [_I] * 8 + [_P],
    'hpe_bn_reduce_blocks': [_L, _I, _I],
    'hpe_bn_stats': [_P, _L, _I, _I, _F, _P, _I, _P, _P, _P],
    'hpe_bn_apply': [_P, _I, _P, _I, _L, _I, _P, _F, _P, _P, _F, _I, _P, _P, _P, _P,
                     _F, _F, _I, _P],
    'hpe_bn_bwd_reduce': [_P, _I, _P, _I, _L, _I, _P, _F, _P, _P, _F, _I, _P, _I, _P, _P,
                          _P, _P, _P, _P],
    'hpe_bn_bwd_dx': [_P, _I, _P, _I, _P, _L, _L, _I, _P, _F, _P, _P, _F, _I, _P, _F, _I, _P],
}

_lock = threading.Lock()
_loaded = {}


def find_nvcc() -> str:
    nvcc = shutil.which('nvcc')
    if nvcc is None:
        home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
        cand = os.path.join(home, 'bin', 'nvcc')
        nvcc = cand if os.path.isfile(cand) else None
    if nvcc is None:
        raise RuntimeError('nvcc not found (PATH, $CUDA_HOME/bin, '
                           '/usr/local/cuda/bin): the Hopper kernels are '
                           'built from csrc/*.cu at first CUDA use')
    return nvcc


def _sources():
    srcs = sorted(CSRC.glob('*.cu'))
    if not srcs:
        raise RuntimeError(f'no CUDA sources under {CSRC}')
    return srcs


def _digest(srcs) -> str:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple:
    """Compile (if needed) -> (path of the .so, compiler log)."""
    srcs = _sources()
    so = BUILD_DIR / f'libhpe_kernels_{_digest(srcs)}.so'
    log_path = so.with_suffix('.log')
    if so.exists():
        return so, log_path.read_text() if log_path.exists() else ''
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for s in srcs:
            obj = os.path.join(tmp, s.stem + '.o')
            cmd = [nvcc, *NVCC_FLAGS, '-c', str(s), '-o', obj]
            procs.append((s, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for s, _, p in procs:
            out, _ = p.communicate()
            log.append(f'== {s.name}\n{out}')
            if p.returncode != 0:
                failed.append(s.name)
        if failed:
            raise RuntimeError(f'nvcc failed on {failed}:\n' + '\n'.join(log))
        tmp_so = os.path.join(tmp, so.name)
        link = subprocess.run(
            [nvcc, '-gencode', 'arch=compute_90a,code=sm_90a', '-shared',
             '-o', tmp_so] + [obj for _, obj, _ in procs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f'nvcc link failed:\n{link.stdout}')
        text = '\n'.join(log)
        # several processes may build at once (ranks on one card): each
        # renames its own finished files into place, the log first
        tmp_log = os.path.join(tmp, log_path.name)
        Path(tmp_log).write_text(text)
        os.replace(tmp_log, log_path)
        os.replace(tmp_so, so)
    return so, text


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = _loaded.get('lib')
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get('lib')
        if lib is None:
            path, log = build()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.build_log = log
            _loaded['lib'] = lib
        return lib


def stream_for(t) -> int:
    """Handle of the current stream of t's device, which must be the
    current device (the kernels launch there). Through the raw calls that
    `torch.cuda.current_stream` wraps: a train step asks a few thousand
    times, and the wrapper costs ~3.5 us a call."""
    import torch
    index = t.device.index
    if index != torch._C._cuda_getDevice():
        raise ValueError(f'tensor on {t.device}, current device is '
                         f'cuda:{torch.cuda.current_device()}')
    return torch._C._cuda_getCurrentRawStream(index)


_sms = {}


def num_sms(t) -> int:
    """Streaming multiprocessors of t's device."""
    n = _sms.get(t.device.index)
    if n is None:
        import torch
        n = _sms[t.device.index] = torch.cuda.get_device_properties(
            t.device).multi_processor_count
    return n


def on_meta(*ts) -> bool:
    """Whether an op's fake was given meta tensors (shapes and strides that a
    caller made, no data), on which it refuses what the CUDA kernel would.
    A tensor that `torch.export` traces reports its own device instead, and
    its checks wait for the launch, on the real tensor: the tracer's strides
    are a guess (on an H100 it gave the model's channels-last convolutions
    NCHW strides)."""
    return any(t.device.type == 'meta' for t in ts)


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f'{what}: CUDA error {err} at launch')
