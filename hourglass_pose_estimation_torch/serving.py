"""Dynamic micro-batching and the HTTP front-end of the serving path.

Port of `hourglass_pose_estimation_tpu/serving.py` (`MicroBatcher`,
`make_server`), the same in behaviour: collect up to `batch_size` frames
(or until `max_wait_ms` passes after the first), zero-pad the tail to the
static batch, run one call of the inference function, and fan the
per-frame results back to each caller's Future. One worker thread owns
the device. Backpressure is explicit: the queue is capped (`max_queue`,
default 8 batches) and `submit` raises QueueFull at capacity; entries
whose caller cancelled while still queued are shed at dequeue time, so
the card never computes results nobody will read.

The inference function is built by `export.make_inference_fn`, or loaded
from an exported program by `load_serving_artifact`; its outputs are CUDA
tensors, fetched with one device-to-host copy per output tensor.
`serve_http.py` serves either.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Callable, Sequence, Tuple

import numpy as np
import torch

from hourglass_pose_estimation_torch._device import resolve_device


class Unavailable(RuntimeError):
    """The batcher cannot take this request (HTTP layer maps to 503)."""


class QueueFull(Unavailable):
    """submit() called with the request queue at capacity."""


class MicroBatcher:
    """Coalesce concurrent single-frame requests into batched calls.

    infer_fn: callable taking one [B, ...] array and returning an array
    or (nested) tuple of arrays whose leading axis is the batch.
    frame_shape: per-frame input shape (H, W, C); dtype: input dtype.
    """

    def __init__(self, infer_fn: Callable[[np.ndarray], Any],
                 batch_size: int, frame_shape: Sequence[int],
                 dtype=np.uint8, max_wait_ms: float = 5.0,
                 max_queue: int = 0):
        self.infer_fn = infer_fn
        self.batch_size = int(batch_size)
        self.frame_shape = tuple(frame_shape)
        self.dtype = np.dtype(dtype)
        self.max_wait_s = float(max_wait_ms) / 1e3
        # queue cap = the real backpressure: at sustained overload,
        # reject at ingress instead of buffering frames (~MBs each)
        # for results the client has long stopped waiting for
        self.max_queue = int(max_queue) or 8 * self.batch_size
        self._q: deque = deque()
        self._cv = threading.Condition()
        self._closed = False
        self.n_requests = 0
        self.n_batches = 0
        self.n_frames = 0
        self.n_rejected = 0
        self.n_shed = 0
        # last-1000 per-batch wall latencies (infer + result fan-out,
        # i.e. including the host value fetch) for /stats percentiles
        self._lat: deque = deque(maxlen=1000)
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, frame: np.ndarray) -> Future:
        """Enqueue one frame; resolves to this frame's slice of the
        model output (same nesting, leading batch axis removed)."""
        frame = np.asarray(frame, self.dtype)
        if frame.shape != self.frame_shape:
            raise ValueError(
                f'frame shape {frame.shape} != expected {self.frame_shape}')
        fut: Future = Future()
        with self._cv:
            if self._closed:
                raise Unavailable('MicroBatcher is closed')
            if len(self._q) >= self.max_queue:
                self.n_rejected += 1
                raise QueueFull(
                    f'request queue at capacity ({self.max_queue})')
            self._q.append((frame, fut))
            self.n_requests += 1
            self._cv.notify()
        return fut

    def __call__(self, frame: np.ndarray):
        """Blocking convenience: submit and wait."""
        return self.submit(frame).result()

    def _take_batch(self):
        """Block for the first frame, then linger up to max_wait_s for
        more (returns early once batch_size are queued)."""
        with self._cv:
            while not self._q and not self._closed:
                self._cv.wait(0.1)
            if not self._q:
                return []
            deadline = time.monotonic() + self.max_wait_s
            while (len(self._q) < self.batch_size and not self._closed):
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._cv.wait(left)
            # shed entries whose caller already gave up (Future.cancel
            # succeeds while queued — these never ran) so the device
            # only computes results somebody is still waiting for.
            # set_running_or_notify_cancel atomically claims survivors:
            # from here on cancel() fails, so the result fan-out cannot
            # race a cancel into InvalidStateError.
            batch = []
            while self._q and len(batch) < self.batch_size:
                frame, fut = self._q.popleft()
                if fut.set_running_or_notify_cancel():
                    batch.append((frame, fut))
                else:
                    self.n_shed += 1
            return batch

    def _run(self):
        buf = np.zeros((self.batch_size,) + self.frame_shape, self.dtype)
        while True:
            batch = self._take_batch()
            if not batch:
                if self._closed and not self._q:
                    return
                continue
            n = len(batch)
            for i, (frame, _) in enumerate(batch):
                buf[i] = frame
            if n < self.batch_size:
                buf[n:] = 0
            t0 = time.monotonic()
            try:
                out = self.infer_fn(buf)
            except Exception as e:          # fan the failure to all waiters
                for _, fut in batch:
                    _set_quietly(fut.set_exception, e)
                continue
            self.n_batches += 1
            self.n_frames += n
            # ONE bulk D2H before slicing: a fetch per future would be
            # a device slice + blocking copy per frame (x outputs) on
            # this single worker thread — at batch 64 with a keypoint
            # function that is 128 round trips per batch instead of 2
            out = _fetch_tree(out)
            for i, (_, fut) in enumerate(batch):
                # per-future isolation: a failure delivering one result
                # must neither poison its batchmates nor kill this
                # worker thread (the whole server hangs without it)
                try:
                    fut.set_result(_slice_tree(out, i))
                except Exception as e:
                    _set_quietly(fut.set_exception, e)
            with self._cv:
                self._lat.append(time.monotonic() - t0)

    def stats(self) -> dict:
        with self._cv:
            lat = sorted(self._lat)
            depth = len(self._q)
        pct = (lambda q: round(lat[int(q * (len(lat) - 1))] * 1e3, 3)) \
            if lat else (lambda q: None)
        return {'requests': self.n_requests, 'batches': self.n_batches,
                'frames': self.n_frames, 'rejected': self.n_rejected,
                'shed': self.n_shed, 'batch_size': self.batch_size,
                'queue_depth': depth, 'batch_latency_ms_p50': pct(0.50),
                'batch_latency_ms_p95': pct(0.95)}

    def close(self, timeout: float = 10.0):
        """Drain the queue and stop the worker."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._worker.join(timeout)


def _set_quietly(setter, e):
    """Deliver a Future failure without ever raising (InvalidStateError
    on an already-failed future must not kill the worker thread)."""
    try:
        setter(e)
    except Exception:
        pass


def _fetch_tree(out: Any):
    """Device outputs -> host numpy, one device-to-host copy per output
    tensor (np.asarray does not take a CUDA tensor)."""
    if isinstance(out, (tuple, list)):
        return tuple(_fetch_tree(o) for o in out)
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    return np.asarray(out)


def _slice_tree(out: Any, i: int):
    if isinstance(out, (tuple, list)):
        return tuple(_slice_tree(o, i) for o in out)
    return np.asarray(out[i])


def load_serving_artifact(path: str, device='cuda') -> Tuple[Callable, int, Tuple[int, ...],
                                                             np.dtype]:
    """Load a program `export.export_program` saved, for serving ->
    (callable over frames, batch size, per-frame shape, input dtype), read
    from the program's own static input. The counterpart of the JAX
    package's `load_serving_artifact`; the callable's results stay on
    `device`."""
    from hourglass_pose_estimation_torch.export import read_program, serving_callable
    dev = resolve_device(device)
    program = read_program(path, dev)
    name = program.graph_signature.user_inputs[0]
    spec = next(n for n in program.graph.nodes if n.name == name).meta['val']
    shape = tuple(int(d) for d in spec.shape)
    dtype = torch.empty((), dtype=spec.dtype).numpy().dtype
    return serving_callable(program.module(), dev), shape[0], shape[1:], dtype


def make_server(batcher: MicroBatcher, host: str = '127.0.0.1',
                port: int = 0, result_timeout: float = 60.0):
    """Threaded stdlib HTTP server over a MicroBatcher.

    POST /keypoints with an encoded image body (JPEG/PNG, decoded via
    cv2) or a raw .npy frame (Content-Type: application/x-npy) returns
    {"keypoints": [[x, y], ...], "scores": [...]} for a keypoint
    function, or {"shape": [...]} metadata + heatmaps for a heatmap
    function. GET /healthz and /stats for liveness / batching counters.
    Frames are resized on the host (cv2) to the batcher's static frame
    shape; the inference function itself runs /255 + normalize + any
    model-side resize when built with `preprocess`.
    """
    import io
    import json
    from concurrent.futures import TimeoutError as FuturesTimeout
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    H, W = batcher.frame_shape[0], batcher.frame_shape[1]

    def decode_body(body: bytes, ctype: str) -> np.ndarray:
        if 'npy' in ctype:
            arr = np.load(io.BytesIO(body), allow_pickle=False)
        else:
            import cv2
            arr = cv2.imdecode(np.frombuffer(body, np.uint8),
                               cv2.IMREAD_COLOR)
            if arr is None:
                raise ValueError('could not decode image body')
        if arr.shape[:2] != (H, W):
            import cv2
            arr = cv2.resize(arr, (W, H))
        return arr.astype(batcher.dtype)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):       # quiet
            pass

        def _json(self, code: int, payload: dict):
            blob = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def do_GET(self):
            if self.path == '/healthz':
                self._json(200, {'ok': True})
            elif self.path == '/stats':
                self._json(200, batcher.stats())
            else:
                self._json(404, {'error': 'not found'})

        def do_POST(self):
            if self.path != '/keypoints':
                self._json(404, {'error': 'not found'})
                return
            # 400 = bad input (decode/shape); 503 = overload/shutdown
            # (retryable, load balancers eject the backend); 500 = the
            # inference call itself failed. Conflating them makes
            # clients treat an overloaded server as their own bad input.
            try:
                n = int(self.headers.get('Content-Length', 0))
                frame = decode_body(self.rfile.read(n),
                                    self.headers.get('Content-Type', ''))
            except Exception as e:
                self._json(400, {'error': f'{type(e).__name__}: {e}'})
                return
            try:
                fut = batcher.submit(frame)
            except Unavailable as e:
                self._json(503, {'error': f'{type(e).__name__}: {e}'})
                return
            except ValueError as e:     # frame shape/dtype rejected
                self._json(400, {'error': f'{type(e).__name__}: {e}'})
                return
            try:
                out = fut.result(timeout=result_timeout)
            except FuturesTimeout:
                fut.cancel()                 # shed: don't compute for nobody
                self._json(503, {'error': 'inference queue timeout'})
                return
            except Exception as e:
                self._json(500, {'error': f'{type(e).__name__}: {e}'})
                return
            if isinstance(out, tuple) and len(out) == 2:
                kps, maxv = out
                self._json(200, {
                    'keypoints': np.asarray(kps, np.float64).tolist(),
                    'scores': np.asarray(maxv, np.float64).ravel().tolist()})
            else:
                hm = np.asarray(out)
                self._json(200, {'shape': list(hm.shape),
                                 'heatmaps': hm.astype(np.float64).tolist()})

    class Server(ThreadingHTTPServer):
        # listen backlog: the stdlib default of 5 drops the connects of
        # concurrent clients beyond it (each then retries after a 1 s
        # SYN timeout), which starves the batcher of frames
        request_queue_size = 1024

    return Server((host, port), Handler)
