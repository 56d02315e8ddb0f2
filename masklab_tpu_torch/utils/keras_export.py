"""Reference-interchange export: write the port's weights back into the
reference's Keras network / h5 checkpoint format.

The port's copy of ``masklab_tpu/utils/keras_export.py``. The reference's
checkpoint interchange format is a Keras h5 of its inference model
(engine/callbacks.py:152-158), reloaded with ``load_model`` + layer-name
regexes (engine/retinamasklab.py:498-643). keras_import.py reads that
format; this module writes it, so a model trained here can be handed back
to the reference stack. A port model enters as its flax variable tree
(``weights.to_flax_tree``).

Design: every import converter is a pure index shuffle (reshapes,
transposes, concats and reorderings of the Keras weight arrays, no
arithmetic). Instead of hand-writing an inverse for each backbone family
and subnet head, :func:`invert_converter` traces integer index tags
*through the forward converter* and scatters the flax values back into the
Keras weight slots. One function inverts every converter, and bijectivity
is proven at run time: each Keras slot must be written exactly once, or the
export raises.

Because the reference's ``load_model`` needs the architecture graph (its
own custom layer classes), a standalone h5 cannot carry it; export
therefore targets a *live* reference-built network
(:func:`transplant_into_reference`) and then saves its weights in the
Keras legacy ``model_weights`` layout (:func:`save_reference_h5`), the
section ``SaveInferenceModel``'s h5 carries and both loaders read. The
reference and TensorFlow are imported only inside those functions.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from . import keras_import as ki
from .keras_import import ImportMismatch, Weight

# float32 represents consecutive integers exactly only below 2**24; tag
# batches stay under it so WeightCursor.take's astype(float32) is lossless
_TAG_BATCH = (1 << 24) - 1


def _tree_leaves_with_paths(tree, prefix=()):
    """Deterministic (path, leaf) pairs: dicts by sorted key, tuples by
    index — mirrors jax's pytree ordering without requiring jax here."""
    from collections.abc import Mapping
    if isinstance(tree, Mapping):
        tree = dict(tree)
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_tree_leaves_with_paths(tree[k], prefix + (k,)))
        return out
    if isinstance(tree, (tuple, list)):
        out = []
        for i, v in enumerate(tree):
            out.extend(_tree_leaves_with_paths(v, prefix + (i,)))
        return out
    return [(prefix, tree)]


def invert_converter(converter, named_weights: Sequence[Weight],
                     flax_tree) -> List[np.ndarray]:
    """Invert an import ``converter`` numerically.

    ``named_weights`` is the Keras layer-group weight list [(name, array)]
    in its native order (shapes + names are what the converter validates);
    ``flax_tree`` is the matching flax subtree the converter would have
    produced. Returns new Keras weight arrays, same order as the input.
    """
    specs = [(name, tuple(np.asarray(v).shape)) for name, v in named_weights]
    sizes = [int(np.prod(s)) if s else 1 for _, s in specs]
    total = int(np.sum(sizes))
    src_paths = _tree_leaves_with_paths(flax_tree)
    flat = np.full(total, np.nan, dtype=np.float64)
    written = np.zeros(total, dtype=bool)

    # batch the tag passes so each stays float32-exact (tag 0 = "not in
    # this batch"; real tags start at 1)
    start = 0
    while start < total:
        stop = min(start + _TAG_BATCH, total)
        tagged, offset = [], 0
        for (name, shape), size in zip(specs, sizes):
            lo, hi = offset, offset + size
            tags = np.zeros(size, dtype=np.float64)
            blo, bhi = max(lo, start), min(hi, stop)
            if blo < bhi:
                tags[blo - lo:bhi - lo] = np.arange(
                    blo - start + 1, bhi - start + 1, dtype=np.float64)
            tagged.append((name, tags.reshape(shape)))
            offset += size
        tag_tree = converter(tagged)
        tag_paths = _tree_leaves_with_paths(tag_tree)
        if [p for p, _ in tag_paths] != [p for p, _ in src_paths]:
            got = [p for p, _ in tag_paths][:6]
            want = [p for p, _ in src_paths][:6]
            raise ImportMismatch(
                f'flax tree does not match converter output: converter '
                f'leaves {got}... vs params leaves {want}...')
        for (_, tag_leaf), (path, src_leaf) in zip(tag_paths, src_paths):
            t = np.asarray(tag_leaf, dtype=np.float64).ravel()
            s = np.asarray(src_leaf, dtype=np.float32).ravel()
            if t.shape != s.shape:
                raise ImportMismatch(
                    f'leaf {"/".join(map(str, path))}: converter shape '
                    f'{np.asarray(tag_leaf).shape} vs params shape '
                    f'{np.asarray(src_leaf).shape}')
            sel = t > 0
            idx = start + t[sel].astype(np.int64) - 1
            # injectivity: a Keras slot written twice (within a leaf OR
            # across leaves — e.g. a converter aliasing one weight into
            # two flax leaves) would be silent last-write-wins; together
            # with the unwritten-slot nan check below, this proves the
            # bijection the docstring claims
            if written[idx].any() or np.unique(idx).size != idx.size:
                raise ImportMismatch(
                    f'leaf {"/".join(map(str, path))}: converter writes '
                    f'an already-written Keras slot — not a bijection')
            written[idx] = True
            flat[idx] = s[sel]
        start = stop

    if np.isnan(flat).any():
        n = int(np.isnan(flat).sum())
        raise ImportMismatch(
            f'{n}/{total} Keras weight slots unwritten — converter is not '
            f'a bijection over this layer group')
    out, pos = [], 0
    for (_, shape), size in zip(specs, sizes):
        out.append(flat[pos:pos + size].reshape(shape).astype(np.float32))
        pos += size
    return out


def _live_groups(model) -> List[Tuple[str, object, List[Weight]]]:
    """(name, layer, ordered weight list) for each weight-bearing
    top-level layer of a live Keras model."""
    out = []
    for layer in model.layers:
        if layer.weights:
            out.append((layer.name, layer, ki.weights_of_layer(layer)))
    return out


def transplant_into_reference(masklab, config, model) -> None:
    """Write the port's ``masklab`` (a ``MaskLab``, read through
    ``weights.to_flax_tree``) into a live reference inference network
    ``model`` (the Model ``construct_inference_network`` returns,
    engine/retinamasklab.py:420-495) in place.

    Mirrors ``load_reference_h5``'s dispatch in reverse: locates each
    subnet layer by the same name regexes the reference uses
    (retinamasklab.py:528-584), inverts its import converter, and
    ``set_weights`` the result. The backbone is every weight-bearing
    layer that is not a subnet (flattened into the top level by
    construct_inference_network).
    """
    import re

    from ..weights import to_flax_tree
    variables = to_flax_tree(masklab)
    groups = _live_groups(model)
    names = [n for n, _, _ in groups]
    det = config.detection
    ins = config.instance
    sem = config.semantic
    num_levels = len(config.backbone.backbone_outputs)
    num_fpn = len([n for n in config.backbone.backbone_outputs
                   if n in det.feature_pyramid_inputs])
    params = variables['params']
    stats = variables.get('batch_stats', {})

    subnet_specs = [
        (r'^feature_pyramid',
         lambda w: ki.convert_fpn(w, num_fpn), params['fpn']),
        (r'^classification_sub_net',
         lambda w: ki.convert_head_subnet(
             w, num_levels, det.num_depth, det.use_separable_conv,
             det.use_squeeze_excite, name='classification_sub_net'),
         params['cls_subnet']),
        # reference quirk kept: loc head's use_squeeze_excite is wired
        # from use_separable_conv (retinamasklab.py:95)
        (r'^box_regression_sub_net',
         lambda w: ki.convert_head_subnet(
             w, num_levels, det.num_depth, det.use_separable_conv,
             det.use_separable_conv, name='box_regression_sub_net'),
         params['loc_subnet']),
        (r'^mask_sub_net',
         lambda w: ki.convert_mask_subnet(
             w, ins.max_k + 1, ins.num_depth, ins.use_separable_conv,
             ins.use_squeeze_excite), params['mask_subnet']),
        (r'^aspp',
         lambda w: ki.convert_aspp(w, tuple(sem.atrous_rate)),
         params['aspp']),
        (r'^segmentation_sub_net',
         lambda w: ki.convert_seg_subnet(
             w, sem.num_depth, sem.use_separable_conv,
             sem.use_squeeze_excite), params['seg_subnet']),
    ]
    subnet_names = set()
    for pattern, conv, tree in subnet_specs:
        name = ki.find_group(names, pattern)
        subnet_names.add(name)
        _, layer, weights = groups[names.index(name)]
        layer.set_weights(invert_converter(conv, weights, tree))

    # backbone: remaining weight-bearing layers, in model order, as one
    # flat weight list (matching the import side, keras_import.py:833-839)
    backbone_items = [(name, layer, weights)
                      for name, layer, weights in groups
                      if name not in subnet_names
                      and not re.match(r'^prior_layer', name)]
    backbone_weights = [w for _, _, weights in backbone_items
                        for w in weights]
    new = invert_converter(
        lambda w: ki.convert_backbone(w, config.backbone.backbone_type),
        backbone_weights,
        (params['backbone'], stats.get('backbone', {})))
    pos = 0
    for _, layer, weights in backbone_items:
        n = len(weights)
        layer.set_weights(new[pos:pos + n])
        pos += n


def build_reference_inference_network(config):
    """Build the reference's own inference network for ``config``
    (engine/retinamasklab.py:420-495) with ImageNet weight loading
    disabled (the caller is about to transplant trained weights in).

    Requires the reference checkout + its TF shims (utils/ref_shim.py) to
    be importable; raises otherwise: callers treat the h5 interchange as
    best-effort.
    """
    import contextlib
    import types

    from .ref_shim import install_shims
    install_shims()
    import engine.backbone.base as ref_base
    from engine import retinamasklab as rml
    from engine.config import ModelConfiguration as RefConfig

    # translate the config: groups/attrs share names by design; tuples
    # become lists (the reference mutates them), extra groups (compute)
    # and extra attrs are skipped
    import dataclasses as dc
    rcfg = RefConfig()
    for gname in ('postprocess', 'backbone', 'detection', 'instance',
                  'semantic', 'loss', 'dataset', 'train'):
        mg = getattr(config, gname, None)
        rg = getattr(rcfg, gname, None)
        if mg is None or rg is None:
            continue
        for f in dc.fields(mg):
            if hasattr(rg, f.name):
                v = getattr(mg, f.name)
                setattr(rg, f.name, list(v) if isinstance(v, tuple) else v)

    @contextlib.contextmanager
    def no_imagenet():
        """Force weights=None through every builder load_backbone uses."""
        def wrap(fn):
            def inner(*a, **kw):
                kw['weights'] = None
                return fn(*a, **kw)
            return inner

        saved = {}
        for n in ('ResNet50', 'MobileNet', 'VGG16', 'ResNet101V2',
                  'ResNeXt50'):
            if hasattr(ref_base, n):
                saved[n] = getattr(ref_base, n)
                setattr(ref_base, n, wrap(saved[n]))
        if hasattr(ref_base, 'Classifiers'):
            saved['Classifiers'] = ref_base.Classifiers
            orig_get = ref_base.Classifiers.get

            def patched_get(name):
                builder, pre = orig_get(name)
                return wrap(builder), pre

            ref_base.Classifiers = types.SimpleNamespace(get=patched_get)
        if hasattr(ref_base, 'efn'):
            saved['efn'] = ref_base.efn
            ref_base.efn = types.SimpleNamespace(**{
                n: wrap(getattr(ref_base.efn, n))
                for n in ('EfficientNetB2', 'EfficientNetB3',
                          'EfficientNetB4')
                if hasattr(ref_base.efn, n)})
        try:
            yield
        finally:
            for n, v in saved.items():
                setattr(ref_base, n, v)

    with no_imagenet():
        backbone_net = rml.build_backbone_network(rcfg)
        det = rml.build_detection_network(rcfg)
        ins = rml.build_instance_network(rcfg)
        sem = rml.build_semantic_network(rcfg)
        return rml.construct_inference_network(rcfg, backbone_net, det,
                                               sem, ins)


def save_reference_h5(model, path: str) -> None:
    """Save a (transplanted) reference network's weights in the Keras
    legacy h5 layout under ``model_weights`` — the section the reference
    checkpoint carries (engine/callbacks.py:152-158) and that
    ``load_reference_h5`` / ``Model.load_weights`` read."""
    import h5py
    from keras.src.legacy.saving import legacy_h5_format
    with h5py.File(path, 'w') as f:
        legacy_h5_format.save_weights_to_hdf5_group(
            f.create_group('model_weights'), model)
