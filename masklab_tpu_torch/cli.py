"""Command-line entry points of the port.

The counterpart of ``masklab_tpu/cli.py``:
  * ``etl``   — process a labelled dataset (``data.process_dataset``);
  * ``train`` — config overrides via -group.attr flags, the 3-phase
    trainer, then the mIoU eval of its best checkpoint;
  * ``eval``  — the mIoU eval alone, of the best checkpoint in
    ``-train.save_dir``, with the model rebuilt from its config.json.

``serve``, ``process`` and ``export`` are not ported yet (ROADMAP.md) and
exit with a message saying so. Everything runs on the CUDA card unless
``--device=<name>`` names another (``--device=cpu``).

Usage: python -m masklab_tpu_torch.cli <command> [--preset=road]
       [--device=cpu] [-group.attr value ...]
"""
from __future__ import annotations

import json
import os
import sys
import time

from .config import ModelConfiguration

NOT_PORTED = ('serve', 'process', 'export')


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


def _not_ported(name):
    def command(args) -> None:
        raise SystemExit(f'{name} is not ported to PyTorch yet (ROADMAP.md, '
                         'Queue 1 item 3); use python -m masklab_tpu.cli '
                         f'{name}')
    return command


COMMANDS = {'train': cmd_train, 'eval': cmd_eval, 'etl': cmd_etl,
            **{name: _not_ported(name) for name in NOT_PORTED}}


def main(argv=None) -> None:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] not in COMMANDS:
        raise SystemExit(
            f'usage: python -m masklab_tpu_torch.cli {{{"|".join(COMMANDS)}}}'
            ' [--preset=road] [--device=cpu] [-group.attr value ...]')
    COMMANDS[argv[0]](argv[1:])


if __name__ == '__main__':
    main()
