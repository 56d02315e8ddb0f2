"""Walkthrough 5 (PyTorch port): inference and serving.

The port's counterpart of ``examples/05_inference_and_serving.py``: the
predictor on the best checkpoint of ``save_dir`` (or seeded random weights)
with per-stage timings, then the HTTP server and a client round trip on a
synthetic frame (the reference's test/test_input.jpg smoke check,
serving.py:97-106).

    python examples/torch/05_inference_and_serving.py [save_dir] [port] [cuda|cpu]
"""
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', '..'))


def main(save_dir=None, port=0, device=None):
    """``port`` 0 binds a free one. Returns {'outputs': {key: shape},
    'response': the server's JSON answer, 'stages': {stage: s}}."""
    import importlib.util
    from masklab_tpu_torch.data.synthetic import make_synthetic_dataset
    from masklab_tpu_torch.models import build_masklab
    from masklab_tpu_torch.serving import (MaskLabPredictor, MaskLabServer,
                                           send_image_to_server)
    from masklab_tpu_torch.train.checkpoints import (CheckpointManager,
                                                     load_variables)
    from masklab_tpu_torch.utils import StageTimer

    spec = importlib.util.spec_from_file_location(
        'ex04', os.path.join(os.path.dirname(__file__), '04_evaluate.py'))
    ex04 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex04)
    cfg = ex04.demo_config((256, 448))

    timer = StageTimer()
    with timer.stage('init'):
        model = build_masklab(cfg, device=device)
        if save_dir and os.path.isdir(save_dir):
            load_variables(model, CheckpointManager(
                save_dir).restore_variables())
    predictor = MaskLabPredictor(model, cfg, visualization=True,
                                 device=device)

    with tempfile.TemporaryDirectory() as tmp:
        make_synthetic_dataset(tmp, num_images=1, image_hw=(256, 448))
        with open(os.path.join(tmp, 'images', 'frame_0000.jpg'), 'rb') as f:
            frame = f.read()
        with timer.stage('first-predict'):
            out = predictor.predict_bytes(frame)
        with timer.stage('steady-state-predict'):
            out = predictor.predict_bytes(frame)
        outputs = {k: v.shape for k, v in out.items()}
        print('outputs:', outputs)

        server = MaskLabServer(predictor, port=int(port),
                               instance_labels=cfg.dataset.instance_labels)
        server.start(background=True)
        time.sleep(0.5)
        try:
            with timer.stage('http-round-trip'):
                resp = send_image_to_server(
                    os.path.join(tmp, 'images', 'frame_0000.jpg'),
                    port=server.port)
        finally:
            server.stop()
    print('server objs:', resp.get('objs'))
    print('latency_ms:', resp.get('latency_ms'))
    print(timer.summary())
    return dict(outputs=outputs, response=resp, stages=timer.stages)


if __name__ == '__main__':
    main(*sys.argv[1:])
