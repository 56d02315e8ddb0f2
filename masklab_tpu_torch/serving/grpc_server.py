"""gRPC serving front end.

Port of ``masklab_tpu/serving/grpc_server.py:31-103``: one unary method
with generic handlers (no protoc), the encoded image in and a JSON
response out (the analytics table and the base64 annotated JPEG, or the
boxes for a raw-mode predictor). grpc is imported where it is used.

Service: ``/masklab.MaskLab/Predict``  bytes -> JSON bytes.
"""
from __future__ import annotations

import base64
import json
from concurrent import futures
from typing import Dict, Optional

from .batching import MicroBatcher
from .predictor import (MaskLabPredictor, decode_image_bytes,
                        summary_to_records)

SERVICE_NAME = 'masklab.MaskLab'
METHOD = f'/{SERVICE_NAME}/Predict'
DEFAULT_GRPC_PORT = 8500  # the gRPC port of the reference's TF-Serving


def _identity(b: bytes) -> bytes:
    return b


class MaskLabGrpcServer:
    """``port`` 0 binds a free port, which ``self.port`` then holds;
    concurrent calls coalesce in a ``MicroBatcher`` when ``max_batch > 1``."""

    def __init__(self, predictor: MaskLabPredictor,
                 port: int = DEFAULT_GRPC_PORT, instance_labels=(),
                 max_workers: int = 4, max_batch: int = 8,
                 window_ms: float = 4.0):
        import grpc

        self.predictor = predictor
        self.instance_labels = tuple(instance_labels)
        self.batcher = (MicroBatcher(predictor.predict, max_batch=max_batch,
                                     window_ms=window_ms)
                        if max_batch > 1 else None)

        def predict(request: bytes, context) -> bytes:
            if self.batcher is not None:
                out = self.batcher.submit(decode_image_bytes(request))
            else:
                out = self.predictor.predict_bytes(request)
            payload: Dict = {}
            if 'summarize' in out:
                payload['objs'] = summary_to_records(
                    out['summarize'][0], self.instance_labels)
            if 'visualize' in out:
                payload['visualize_jpeg_b64'] = base64.b64encode(
                    MaskLabPredictor.encode_jpeg(
                        out['visualize'][0])).decode()
            else:
                payload['det_boxes'] = out['det_boxes'][0].tolist()
            return json.dumps(payload).encode()

        handler = grpc.method_handlers_generic_handler(
            SERVICE_NAME,
            {'Predict': grpc.unary_unary_rpc_method_handler(
                predict, request_deserializer=_identity,
                response_serializer=_identity)})
        self.server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers))
        self.server.add_generic_rpc_handlers((handler,))
        self.port = self.server.add_insecure_port(f'[::]:{port}')

    def start(self):
        self.server.start()

    def stop(self, grace: Optional[float] = 0.5):
        self.server.stop(grace).wait()
        if self.batcher is not None:
            self.batcher.close()

    def wait(self):
        self.server.wait_for_termination()


def send_image_to_grpc(image_path: str, host: str = 'localhost',
                       port: int = DEFAULT_GRPC_PORT,
                       deadline_s: float = 10.25) -> Dict:
    """Client round trip with the reference's 10.25 s deadline."""
    import grpc

    with open(image_path, 'rb') as f:
        content = f.read()
    with grpc.insecure_channel(f'{host}:{port}') as channel:
        stub = channel.unary_unary(METHOD, request_serializer=_identity,
                                   response_deserializer=_identity)
        response = stub(content, timeout=deadline_s)
    return json.loads(response)
