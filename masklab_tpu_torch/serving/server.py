"""Serving front end: HTTP server, client, and folder processing.

Port of ``masklab_tpu/serving/server.py:35-258``, hosting the torch
predictor in process:

  * POST /predict   body = JPEG/PNG bytes -> JSON {objs: [...]} analytics
    and the base64 annotated JPEG (the reference's {visualize, summarize}
    signature); ``?outputs=summarize`` skips the frame, ``?outputs=raw``
    answers boxes, and ``?outputs=jpeg`` returns the annotated JPEG bytes
    (Content-Type image/jpeg, analytics in the X-Masklab-Summary header);
  * POST /reload    polls the watched checkpoint directory now and answers
    {"reloaded", "model_version"}; 400 without ``watch_dir``;
  * GET  /healthz   readiness probe, with the served checkpoint as
    ``model_version`` when a directory is watched;
  * ``send_image_to_server``: client round trip with a request deadline;
  * ``process_folder``: offline processing of an image folder, one image
    per call or in stacked batches.

The server and ``process_folder`` take a predictor; where it runs is the
caller's choice.
"""
from __future__ import annotations

import base64
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

from .batching import CheckpointWatcher, MicroBatcher
from .predictor import (MaskLabPredictor, decode_image_bytes,
                        summary_to_records)

DEFAULT_PORT = 8501  # the REST port of the reference's TF-Serving


class _Handler(BaseHTTPRequestHandler):
    predictor: MaskLabPredictor = None
    batcher: Optional[MicroBatcher] = None
    watcher: Optional[CheckpointWatcher] = None
    instance_labels = ()

    def log_message(self, fmt, *args):  # quiet
        pass

    def do_GET(self):
        if self.path == '/healthz':
            info = {'status': 'ok'}
            if self.watcher is not None:
                info['model_version'] = self.watcher.current
            self._respond(200, json.dumps(info).encode())
        else:
            self._respond(404, b'{"error": "not found"}')

    def do_POST(self):
        if self.path == '/reload':
            # the version check on demand (the poll thread's, now)
            if self.watcher is None:
                self._respond(400, b'{"error": "no watch dir configured"}')
                return
            try:
                swapped = self.watcher.check_once()
            except Exception as exc:  # noqa: BLE001 - answered to the client
                self._respond(500, json.dumps({'error': str(exc)}).encode())
                return
            self._respond(200, json.dumps(
                {'reloaded': swapped,
                 'model_version': self.watcher.current}).encode())
            return
        path, _, query = self.path.partition('?')
        if path != '/predict':
            self._respond(404, b'{"error": "not found"}')
            return
        mode = 'visualize'
        binary = False
        if 'outputs=summarize' in query:
            mode = 'summarize'
        elif 'outputs=raw' in query:
            mode = 'raw'
        elif 'outputs=jpeg' in query:
            # the annotated JPEG bytes in the body, the analytics in a
            # header: no base64 inflation and no large JSON
            binary = True
        length = int(self.headers.get('Content-Length', 0))
        content = self.rfile.read(length)
        started = time.time()
        try:
            if self.batcher is not None:
                out = self.batcher.submit(decode_image_bytes(content), mode)
            else:
                out = self.predictor.predict_bytes(content, mode)
        except Exception as exc:  # noqa: BLE001 - answered to the client
            self._respond(400, json.dumps({'error': str(exc)}).encode())
            return
        latency_ms = (time.time() - started) * 1000.0
        if binary and 'visualize' in out:
            objs = summary_to_records(out['summarize'][0],
                                      self.instance_labels)
            self._respond(
                200, MaskLabPredictor.encode_jpeg(out['visualize'][0]),
                content_type='image/jpeg',
                headers={'X-Masklab-Summary': json.dumps(objs),
                         'X-Masklab-Latency-Ms': f'{latency_ms:.1f}'})
            return
        payload: Dict = {'latency_ms': latency_ms}
        if 'summarize' in out:
            payload['objs'] = summary_to_records(
                out['summarize'][0], self.instance_labels)
        if 'visualize' in out:
            payload['visualize_jpeg_b64'] = base64.b64encode(
                MaskLabPredictor.encode_jpeg(out['visualize'][0])).decode()
        elif 'summarize' not in out:
            # raw mode: boxes and the semantic map's shape
            payload['det_boxes'] = out['det_boxes'][0].tolist()
            payload['semantic_shape'] = list(out['semantic'].shape[1:])
        self._respond(200, json.dumps(payload).encode())

    def _respond(self, code: int, body: bytes,
                 content_type: str = 'application/json',
                 headers: Optional[Dict[str, str]] = None):
        self.send_response(code)
        self.send_header('Content-Type', content_type)
        self.send_header('Content-Length', str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)


class MaskLabServer:
    def __init__(self, predictor: MaskLabPredictor,
                 port: int = DEFAULT_PORT, instance_labels=(),
                 max_batch: int = 8, window_ms: float = 4.0,
                 watch_dir: Optional[str] = None,
                 watch_poll_s: float = 10.0):
        """``max_batch > 1`` turns on server-side micro-batching;
        ``watch_dir`` turns on checkpoint hot-reload, polled every
        ``watch_poll_s`` seconds. ``port`` 0 binds a free port, which
        ``self.port`` then holds."""
        self.watcher = None
        if watch_dir:
            self.watcher = CheckpointWatcher(predictor, watch_dir,
                                             poll_s=watch_poll_s)
        self.batcher = (MicroBatcher(predictor.predict, max_batch=max_batch,
                                     window_ms=window_ms)
                        if max_batch > 1 else None)
        handler = type('BoundHandler', (_Handler,), {
            'predictor': predictor,
            'batcher': self.batcher,
            'watcher': self.watcher,
            'instance_labels': tuple(instance_labels),
        })
        # the default listen backlog (5) resets connections under the
        # concurrent load that micro-batching exists to absorb
        server_cls = type('MaskLabHTTPServer', (ThreadingHTTPServer,),
                          {'request_queue_size': 128})
        self.httpd = server_cls(('0.0.0.0', port), handler)
        self.port = self.httpd.server_address[1]
        self.thread: Optional[threading.Thread] = None
        self.serving = False
        if self.watcher is not None:
            self.watcher.start()

    def start(self, background: bool = True):
        self.serving = True
        if background:
            self.thread = threading.Thread(
                target=self.httpd.serve_forever, daemon=True)
            self.thread.start()
        else:
            self.httpd.serve_forever()

    def stop(self):
        """Stop serving (a server never started only closes its socket:
        ``shutdown`` would wait for a loop that never ran)."""
        if self.serving:
            self.httpd.shutdown()
        self.httpd.server_close()
        if self.batcher is not None:
            self.batcher.close()
        if self.watcher is not None:
            self.watcher.stop()


def send_image_to_server(image_path: str, host: str = 'localhost',
                         port: int = DEFAULT_PORT,
                         deadline_s: float = 10.25) -> Dict:
    """Client round trip with the reference's 10.25 s deadline."""
    import urllib.request
    with open(image_path, 'rb') as f:
        content = f.read()
    req = urllib.request.Request(
        f'http://{host}:{port}/predict', data=content, method='POST',
        headers={'Content-Type': 'application/octet-stream'})
    with urllib.request.urlopen(req, timeout=deadline_s) as resp:
        return json.loads(resp.read())


def process_folder(predictor: MaskLabPredictor, src_dir: str, dst_dir: str,
                   instance_labels=(), batch_size: int = 1) -> Dict[str, Dict]:
    """Annotate every JPEG/PNG of ``src_dir`` into ``dst_dir`` and write
    the analytics to ``dst_dir/results.json``.

    ``batch_size > 1`` decodes the images first, groups them by
    resolution and runs stacked batches, the last of each group
    zero-padded to ``batch_size`` and sliced back: the same results as one
    image per call (the pipeline is per image)."""
    os.makedirs(dst_dir, exist_ok=True)
    names = [n for n in sorted(os.listdir(src_dir))
             if os.path.splitext(n)[1].lower() in ('.jpg', '.jpeg', '.png')]
    results: Dict[str, Dict] = {}

    def record(name: str, out: Dict, i: int):
        entry: Dict = {}
        if 'summarize' in out:
            entry['objs'] = summary_to_records(out['summarize'][i],
                                               instance_labels)
        if 'visualize' in out:
            with open(os.path.join(dst_dir, name), 'wb') as f:
                f.write(MaskLabPredictor.encode_jpeg(out['visualize'][i]))
        results[name] = entry

    if batch_size <= 1:
        for name in names:
            with open(os.path.join(src_dir, name), 'rb') as f:
                out = predictor.predict_bytes(f.read())
            record(name, out, 0)
    else:
        groups: Dict[tuple, list] = {}
        for name in names:
            with open(os.path.join(src_dir, name), 'rb') as f:
                rgb = decode_image_bytes(f.read())
            groups.setdefault(rgb.shape[:2], []).append((name, rgb))
        for _, items in sorted(groups.items()):
            for lo in range(0, len(items), batch_size):
                chunk = items[lo:lo + batch_size]
                stack = np.stack([rgb for _, rgb in chunk])
                if len(chunk) < batch_size:
                    pad = np.zeros((batch_size - len(chunk),)
                                   + stack.shape[1:], stack.dtype)
                    stack = np.concatenate([stack, pad])
                out = predictor.predict(stack)
                for i, (name, _) in enumerate(chunk):
                    record(name, out, i)

    with open(os.path.join(dst_dir, 'results.json'), 'w') as f:
        json.dump(results, f, indent=2)
    return results
