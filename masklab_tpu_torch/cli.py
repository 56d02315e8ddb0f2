"""Command-line entry points of the port.

The counterpart of ``masklab_tpu/cli.py``:
  * ``etl``     — process a labelled dataset (``data.process_dataset``);
  * ``train``   — config overrides via -group.attr flags, the 3-phase
    trainer (one rank a card over ``compute.mesh_data`` cards where that
    many are present), then the mIoU eval of its best checkpoint;
  * ``eval``    — the mIoU eval alone, of the best checkpoint in
    ``-train.save_dir``, with the model rebuilt from its config.json;
  * ``serve``   — the predictor of ``-train.save_dir`` over HTTP, with
    micro-batching and checkpoint hot-reload (over a mesh of
    ``--mesh-data=N`` cards);
  * ``process`` — annotate a folder of images;
  * ``export``  — refresh ``serving_config.json``, or write a versioned
    serving bundle.

Everything runs on the CUDA card unless ``--device=<name>`` names another
(``--device=cpu``). Checkpoints and bundles hold torch files
(``train/checkpoints.py``): the JAX package's orbax checkpoints and bundles
are not read here, nor these there.

Usage: python -m masklab_tpu_torch.cli <command> [--preset=road]
       [--device=cpu] [-group.attr value ...]
"""
from __future__ import annotations

import json
import os
import sys
import time

from .config import ModelConfiguration


def _load_config(args) -> ModelConfiguration:
    """A config from the optional ``--preset=<name>`` plus -group.attr
    overrides. A flag present on the command line always applies, even at
    the library default, so a preset's value can be re-asserted back to it
    (``--preset=road -detection.use_squeeze_excite False``)."""
    rest = []
    preset = None
    for a in args:
        if a.startswith('--preset='):
            preset = a.split('=', 1)[1]
        else:
            rest.append(a)
    if preset in (None, 'default'):
        cfg = ModelConfiguration()
    elif preset == 'road':
        from .presets import road_project_config
        cfg = road_project_config()
    else:
        raise SystemExit(f'unknown preset: {preset} (default|road)')
    ns = ModelConfiguration().get_arg_parser(args=rest)
    defaults = ModelConfiguration()
    explicit = set()
    for a in rest:
        if a.startswith('-'):
            key = a.lstrip('-').split('=', 1)[0]
            if key in vars(ns):
                explicit.add(key)
    for key, value in vars(ns).items():
        group, _, attr = key.partition('.')
        if attr and (key in explicit or
                     value != getattr(getattr(defaults, group), attr)):
            cfg.update(group, attr, value)
    return cfg


def _split_device(args):
    """(arguments without ``--device=``, the device it names or None)."""
    device = None
    rest = []
    for a in args:
        if a.startswith('--device='):
            device = a.split('=', 1)[1]
        else:
            rest.append(a)
    return rest, device


def cmd_train(args) -> None:
    from .train.trainer import train_masklab_model
    rest, device = _split_device(args)
    cfg = _load_config(rest)
    stamp = time.strftime('%Y%m%d_%H%M%S')
    cfg.train.save_dir = os.path.join(cfg.train.save_dir, stamp)
    trainer = train_masklab_model(cfg, device=device)
    print(f'best checkpoint: {trainer.ckpt.best_checkpoint()}')
    cmd_eval(args, save_dir=cfg.train.save_dir)


def cmd_eval(args, save_dir: str = None) -> None:
    from .data.dataset import MaskLabDataset
    from .eval.miou import evaluate_dataset
    from .models.masklab import build_masklab
    from .serving.predictor import MaskLabPredictor
    from .train.checkpoints import CheckpointManager, load_variables

    rest, device = _split_device(args)
    cfg = _load_config(rest)
    save_dir = save_dir or cfg.train.save_dir
    ckpt = CheckpointManager(save_dir, None)
    # rebuild the model from the checkpoint's config snapshot: CLI flags
    # only override the dataset, not the architecture
    saved_cfg = ckpt.load_config()
    if saved_cfg is not None:
        saved_cfg.dataset = cfg.dataset
        cfg = saved_cfg
    model = load_variables(build_masklab(cfg, device=device),
                           ckpt.restore_variables())
    predictor = MaskLabPredictor(model, cfg, device=device)
    valid_cases = cfg.dataset.valid_cases
    if not valid_cases and not cfg.dataset.train_cases:
        # the ETL's held-out split when one exists, not the train set
        from .data.process import load_split_cases
        _, valid_cases = load_split_cases(cfg.dataset.data_dir)
    validset = MaskLabDataset(valid_cases or None,
                              min_area=cfg.dataset.min_area,
                              data_dir=cfg.dataset.data_dir,
                              instance_labels=cfg.dataset.instance_labels,
                              semantic_labels=cfg.dataset.semantic_labels)
    metrics = evaluate_dataset(predictor, validset,
                               cfg.dataset.instance_labels,
                               cfg.dataset.semantic_labels)
    print(json.dumps(metrics, indent=2))
    with open(os.path.join(save_dir, 'eval.json'), 'w') as f:
        json.dump(metrics, f, indent=2)


def cmd_etl(args) -> None:
    """Only the arguments that start with '-' reach the config, as in the
    reference: give values in the ``-dataset.data_dir=<dir>`` form."""
    from .data.process import process_dataset
    rest, _ = _split_device(args)
    cfg = _load_config([a for a in rest if a.startswith('-')])
    process_dataset(cfg.dataset.data_dir,
                    except_semantic_labels=cfg.dataset.except_semantic_labels)
    print(f'ETL complete: {cfg.dataset.data_dir}/processed')


def _build_predictor(cfg, save_dir, mesh_data: int = 0, device=None):
    """The serving predictor (default mode 'visualize') of the best
    checkpoint in ``save_dir``: the model is rebuilt from the directory's
    ``serving_config.json`` where ``export`` wrote one, else from its
    ``config.json`` with ``cfg``'s postprocess (the serving knobs), else
    from ``cfg``. Without a checkpoint directory, seeded random weights
    (``init_weights``, seed 0: smoke mode). ``mesh_data`` > 1 serves over
    a mesh of that many cards (one replica each) where they are present;
    above the cards present it serves on one, as the reference does with
    too few chips."""
    import torch
    from .device import resolve_device
    from .models.masklab import MaskLab, build_masklab
    from .serving.predictor import MaskLabPredictor
    from .train.checkpoints import CheckpointManager, load_variables

    device = resolve_device(device)
    mesh = None
    if mesh_data and mesh_data > 1:
        n = torch.cuda.device_count() if device.type == 'cuda' else 1
        if n < mesh_data:
            print(f'WARNING: --mesh-data={mesh_data} but only {n} '
                  'device(s); serving single-device')
        else:
            from .parallel import make_mesh
            mesh = make_mesh(data=mesh_data)
    if save_dir and os.path.isdir(save_dir):
        ckpt = CheckpointManager(save_dir, None)
        serving_cfg_path = os.path.join(save_dir, 'serving_config.json')
        if os.path.exists(serving_cfg_path):
            cfg = ModelConfiguration.load_json(serving_cfg_path)
        else:
            saved_cfg = ckpt.load_config()
            if saved_cfg is not None:
                saved_cfg.postprocess = cfg.postprocess
                cfg = saved_cfg
        model = load_variables(MaskLab(cfg), ckpt.restore_variables())
    else:
        print('WARNING: no checkpoint dir, serving randomly-initialized '
              'weights (smoke mode)')
        model = build_masklab(cfg, device=device, seed=0)
    return MaskLabPredictor(model, cfg, visualization=True, device=device,
                            mesh=mesh)


def build_server(args):
    """``serve``'s arguments -> a ``MaskLabServer`` bound to its port, not
    yet started. ``--port=N`` (0: a free one; default 8501),
    ``--max-batch=N`` (8), ``--no-watch`` (no hot-reload of
    ``-train.save_dir``), ``--warmup`` / ``--warmup-sizes=HxW,...`` (run
    every (client size, batch bucket, mode) once first),
    ``--mesh-data=N``, ``--device=``, then -group.attr overrides."""
    from .serving.batching import default_buckets
    from .serving.server import DEFAULT_PORT, MaskLabServer
    rest, device = _split_device(args)
    flags = ('--port', '--max-batch', '--no-watch', '--warmup',
             '--mesh-data')
    cfg = _load_config([a for a in rest if not a.startswith(flags)])
    port, max_batch, watch, warmup = DEFAULT_PORT, 8, True, False
    mesh_data = 0
    warmup_sizes = []
    for a in rest:
        if a.startswith('--port='):
            port = int(a.split('=', 1)[1])
        elif a.startswith('--max-batch='):
            max_batch = int(a.split('=', 1)[1])
        elif a.startswith('--mesh-data='):
            mesh_data = int(a.split('=', 1)[1])
        elif a == '--no-watch':
            watch = False
        elif a.startswith('--warmup-sizes='):
            # client image sizes, which need not be postprocess.resolution
            warmup = True
            for tok in a.split('=', 1)[1].split(','):
                if tok:
                    h, w = tok.lower().split('x')
                    warmup_sizes.append((int(h), int(w)))
        elif a == '--warmup':
            warmup = True
    if warmup and not warmup_sizes:
        warmup_sizes = [tuple(cfg.postprocess.resolution)]
    predictor = _build_predictor(cfg, cfg.train.save_dir, mesh_data, device)
    if warmup:
        sizes = [(h, w, b, mode) for (h, w) in warmup_sizes
                 for b in default_buckets(max_batch)
                 for mode in ('visualize', 'summarize')]
        print(f'warming {len(sizes)} pipelines...')
        predictor.warmup(sizes)
    watch_dir = cfg.train.save_dir if (
        watch and cfg.train.save_dir
        and os.path.isdir(cfg.train.save_dir)) else None
    server = MaskLabServer(predictor, port=port,
                           instance_labels=cfg.dataset.instance_labels,
                           max_batch=max_batch, watch_dir=watch_dir)
    print(f'serving on :{server.port} (POST /predict, GET /healthz, '
          f'POST /reload; micro-batch<={max_batch}, '
          f'hot-reload={"on" if watch_dir else "off"})')
    return server


def cmd_serve(args) -> None:
    build_server(args).start(background=False)


def cmd_process(args) -> None:
    """``process <src> <dst> [--batch=N] [--device=] [overrides]``:
    ``--batch=N`` (N > 1) runs stacked batches, for offline runs where
    throughput matters more than the first result's latency. Only the
    arguments that start with '-' reach the config, as in the reference:
    give values in the ``-group.attr=value`` form."""
    from .serving.server import process_folder
    rest, device = _split_device(args)
    paths = [a for a in rest if not a.startswith('-')]
    if len(paths) < 2:
        raise SystemExit(
            'usage: process <src_dir> <dst_dir> [--batch=N] [overrides]')
    src, dst = paths[0], paths[1]
    batch = 1
    overrides = []
    for a in rest:
        if a.startswith('--batch='):
            batch = int(a.split('=', 1)[1])
        elif a.startswith('-') and a not in (src, dst):
            overrides.append(a)
    cfg = _load_config(overrides)
    predictor = _build_predictor(cfg, cfg.train.save_dir, device=device)
    results = process_folder(predictor, src, dst,
                             cfg.dataset.instance_labels, batch_size=batch)
    print(f'processed {len(results)} images -> {dst} (batch={batch})')


def cmd_export(args) -> None:
    """Two forms:

    * ``export <save_dir> [-postprocess.* ...]`` refreshes
      ``serving_config.json`` beside the checkpoints: the saved config
      with the flags given applied (flags not given keep the saved values);
    * ``export <save_dir> --dest=<bundle_root> [--h5] [-postprocess.*]``
      writes a self-contained versioned bundle ``<bundle_root>/<N>/`` (N
      = 1, 2, ...): the best checkpoint, config.json and
      serving_config.json, which ``serve -train.save_dir <bundle>`` loads
      by path alone. ``--h5`` adds ``model.h5``, the weights in the
      reference's Keras h5 format, written through the reference's own
      network (``utils/keras_export.py``); where the reference or
      TensorFlow cannot be imported it warns and the bundle stands
      without it.
    """
    if not args or args[0].startswith('-'):
        raise SystemExit('usage: export <save_dir> [--dest=<bundle_root>] '
                         '[--h5] [-postprocess.* ...]')
    save_dir = args[0]
    dest = None
    want_h5 = False
    rest = []
    for a in args[1:]:
        if a.startswith('--dest='):
            dest = a.split('=', 1)[1]
        elif a == '--h5':
            want_h5 = True
        else:
            rest.append(a)
    from .train.checkpoints import CheckpointManager
    ckpt = CheckpointManager(save_dir, None)
    cfg = ckpt.load_config() or ModelConfiguration()
    # the saved config is the parser's defaults: flags not passed keep it
    cfg.apply_namespace(cfg.get_arg_parser(args=rest))

    if dest is None:
        cfg.save_json(os.path.join(save_dir, 'serving_config.json'))
        print(f'serving config exported to {save_dir}/serving_config.json')
        return

    import shutil
    best = ckpt.best_checkpoint()
    if best is None:
        raise SystemExit(f'no checkpoints in {save_dir}')
    os.makedirs(dest, exist_ok=True)
    existing = [int(n) for n in os.listdir(dest) if n.isdigit()]
    version = max(existing, default=0) + 1
    bundle = os.path.join(dest, str(version))
    os.makedirs(bundle)
    shutil.copytree(best, os.path.join(bundle, os.path.basename(best)))
    cfg.save_json(os.path.join(bundle, 'config.json'))
    cfg.save_json(os.path.join(bundle, 'serving_config.json'))
    if want_h5:
        _export_reference_h5(cfg, bundle)
    print(f'bundle exported to {bundle} '
          f'(serve with: -train.save_dir {bundle})')


def _export_reference_h5(cfg, bundle: str) -> None:
    """Best-effort reference-format h5 into the bundle (the port's weights
    transplanted into the reference's network, ``utils/keras_export.py``).
    Needs the reference checkout and TensorFlow importable; a failure must
    not void the bundle itself."""
    try:
        from .models.masklab import MaskLab
        from .train.checkpoints import CheckpointManager, load_variables
        from .utils import keras_export as ke
        model = load_variables(MaskLab(cfg), CheckpointManager(
            bundle, None).restore_variables())
        net = ke.build_reference_inference_network(cfg)
        ke.transplant_into_reference(model, cfg, net)
        ke.save_reference_h5(net, os.path.join(bundle, 'model.h5'))
        print(f'reference-format weights: {bundle}/model.h5')
    except Exception as exc:  # noqa: BLE001 (an optional artifact)
        print(f'WARNING: --h5 export skipped ({type(exc).__name__}: '
              f'{str(exc)[:200]})', file=sys.stderr)


COMMANDS = {'train': cmd_train, 'eval': cmd_eval, 'serve': cmd_serve,
            'process': cmd_process, 'etl': cmd_etl, 'export': cmd_export}


def main(argv=None) -> None:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] not in COMMANDS:
        raise SystemExit(
            f'usage: python -m masklab_tpu_torch.cli {{{"|".join(COMMANDS)}}}'
            ' [--preset=road] [--device=cpu] [-group.attr value ...]')
    COMMANDS[argv[0]](argv[1:])


if __name__ == '__main__':
    main()
