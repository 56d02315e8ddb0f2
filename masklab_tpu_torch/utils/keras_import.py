"""Keras h5 checkpoint import: reference weights -> flax parameter trees.

The port's own copy of ``masklab_tpu/utils/keras_import.py`` (numpy, with
h5py imported where a file is read). The flax trees it builds load into the
port's modules through ``weights.load_flax_variables``;
``load_reference_h5_into`` does both.

The reference checkpoints whole inference models to layer-name-addressed h5
(engine/callbacks.py:152-158) and rebuilds them by layer-name regex
(engine/retinamasklab.py:528-584). This module implements the inverse for
the TPU framework: per-subnet converters that consume a reference layer's
weights **in Keras creation order with name+shape validation at every
step** (a mismatch raises — nothing is silently mis-assigned) and emit the
matching flax subtree, plus ``load_reference_h5`` which assembles full
MaskLab ``variables`` from a reference inference-model h5.

Layout conversions:
  * Conv2D kernel [kh, kw, in, out] — identical in flax;
  * DepthwiseConv2D kernel [kh, kw, C, mult] -> flax grouped-conv kernel
    [kh, kw, 1, C*mult];
  * Conv2DTranspose kernel [kh, kw, out, in] -> flax [kh, kw, in, out],
    spatially flipped (Keras deconv scatters K[a,b] at out[s*i+a]; XLA
    conv_transpose convolves the dilated input with the unflipped kernel);
  * 1x1-conv SE blocks (ChannelSE) -> Dense [in, out];
  * GroupNormalization gamma/beta -> GroupNorm scale/bias;
  * BatchNorm gamma/beta/moving_mean/moving_variance -> params+batch_stats.

Every converter mirrors the *creation order* of the reference layer's
sublayers (Keras ``layer.weights`` order and the h5 ``weight_names`` attr
both follow it), with the weight-name suffix checked against the expected
kind, so a structural divergence anywhere fails loudly with the full
context path. The JAX package's copy is verified live against the reference's own Keras
layers (tests/test_weight_transplant.py); this copy against the JAX
package's on a synthetic h5 (tests/test_torch_utils.py).
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..nn.backbone import body_module_name

Weight = Tuple[str, np.ndarray]

# accepted weight-name suffixes per kind (Keras 2 / Keras 3 variants)
_KINDS = {
    'kernel': ('kernel',),
    'depthwise_kernel': ('depthwise_kernel', 'kernel'),
    'bias': ('bias',),
    'gamma': ('gamma',),
    'beta': ('beta',),
    'moving_mean': ('moving_mean',),
    'moving_variance': ('moving_variance',),
}


class ImportMismatch(ValueError):
    """Raised when the checkpoint does not match the expected structure."""


class WeightCursor:
    """Ordered, validated consumption of a layer's weight list."""

    def __init__(self, items: Sequence[Weight], ctx: str = ''):
        self._items = [(self._norm(n), np.asarray(v)) for n, v in items]
        self._pos = 0
        self.ctx = ctx

    @staticmethod
    def _norm(name: str) -> str:
        name = name.split(':')[0]
        return name.rsplit('/', 1)[-1]

    def __len__(self):
        return len(self._items) - self._pos

    def take(self, kind: str, shape: Optional[tuple] = None) -> np.ndarray:
        if self._pos >= len(self._items):
            raise ImportMismatch(
                f'{self.ctx}: ran out of weights wanting a {kind!r}')
        name, value = self._items[self._pos]
        if name not in _KINDS[kind]:
            raise ImportMismatch(
                f'{self.ctx}: weight #{self._pos} is {name!r}, '
                f'expected {kind!r}')
        if shape is not None and tuple(value.shape) != tuple(shape):
            raise ImportMismatch(
                f'{self.ctx}: {name!r} has shape {value.shape}, '
                f'expected {shape}')
        self._pos += 1
        return value.astype(np.float32)

    def finish(self):
        if self._pos != len(self._items):
            left = [n for n, _ in self._items[self._pos:]]
            raise ImportMismatch(
                f'{self.ctx}: {len(left)} unconsumed weights: {left[:6]}')

    def sub(self, n: int, ctx: str) -> 'WeightCursor':
        """Split off the next ``n`` weights as a child cursor."""
        child = WeightCursor(self._items[self._pos:self._pos + n],
                             ctx=f'{self.ctx}/{ctx}')
        self._pos += n
        return child


def weights_of_layer(layer) -> List[Weight]:
    """Ordered [(name, array)] of a live Keras layer (creation order)."""
    return [(getattr(w, 'path', None) or w.name, np.asarray(w))
            for w in layer.weights]


# ---------------------------------------------------------------------------
# elementary converters (cursor position -> flax subtree)
# ---------------------------------------------------------------------------

def take_conv(cur: WeightCursor, use_bias: bool = True) -> Dict:
    out = {'kernel': cur.take('kernel')}
    if use_bias:
        out['bias'] = cur.take('bias')
    return out


def take_depthwise(cur: WeightCursor) -> Dict:
    """DepthwiseConv2D [kh,kw,C,mult] -> grouped nn.Conv [kh,kw,1,C*mult]."""
    k = cur.take('depthwise_kernel')
    kh, kw, cin, mult = k.shape
    return {'kernel': k.reshape(kh, kw, 1, cin * mult)}


def take_conv_transpose(cur: WeightCursor, use_bias: bool = True,
                        flip: bool = True) -> Dict:
    """Conv2DTranspose [kh,kw,out,in] -> flax ConvTranspose [kh,kw,in,out]."""
    k = cur.take('kernel').transpose(0, 1, 3, 2)
    if flip:
        k = k[::-1, ::-1]
    out = {'kernel': np.ascontiguousarray(k)}
    if use_bias:
        out['bias'] = cur.take('bias')
    return out


def take_dense_from_conv(cur: WeightCursor, use_bias: bool = True) -> Dict:
    """1x1 Conv2D used as a Dense (ChannelSE) -> Dense kernel [in, out]."""
    k = cur.take('kernel')
    if k.ndim == 4:
        k = k[0, 0]
    out = {'kernel': k}
    if use_bias:
        out['bias'] = cur.take('bias')
    return out


def take_gn(cur: WeightCursor) -> Dict:
    """Reference GroupNormalization (gamma, beta) -> GroupNorm params."""
    gamma = cur.take('gamma')
    beta = cur.take('beta')
    return {'scale': gamma, 'bias': beta}


def take_bn(cur: WeightCursor, scale: bool = True) -> Tuple[Dict, Dict]:
    """BatchNorm -> (params {scale?, bias}, stats {mean, var})."""
    params = {}
    if scale:
        params['scale'] = cur.take('gamma')
    params['bias'] = cur.take('beta')
    stats = {'mean': cur.take('moving_mean'),
             'var': cur.take('moving_variance')}
    return params, stats


def take_squeeze_excite(cur: WeightCursor) -> Dict:
    """engine SqueezeExcite (two bias-free Dense) -> flax SqueezeExcite."""
    return {'Dense_0': {'kernel': cur.take('kernel')},
            'Dense_1': {'kernel': cur.take('kernel')}}


def take_channel_se(cur: WeightCursor) -> Dict:
    """classification_models ChannelSE (two biased 1x1 convs) -> _SE tree."""
    return {'fc1': take_dense_from_conv(cur),
            'fc2': take_dense_from_conv(cur)}


def take_mobile_sep(cur: WeightCursor) -> Dict:
    """MobileSeparableConv2D (misc.py:57-117): expand conv -> GN ->
    depthwise -> GN -> squeeze conv -> GN (creation order)."""
    return {
        'Conv_0': take_conv(cur, use_bias=False),
        'GroupNorm_0': take_gn(cur),
        'Conv_1': take_depthwise(cur),
        'GroupNorm_1': take_gn(cur),
        'Conv_2': take_conv(cur, use_bias=False),
        'GroupNorm_2': take_gn(cur),
    }


def take_atrous_sep(cur: WeightCursor) -> Dict:
    """AtrousSeparableConv2D (semantic.py:32-90). Creation order is both
    convs first, then both GNs (attribute order in __init__)."""
    depth = take_depthwise(cur)
    point = take_conv(cur, use_bias=False)
    depth_gn = take_gn(cur)
    point_gn = take_gn(cur)
    return {'Conv_0': depth, 'GroupNorm_0': depth_gn,
            'Conv_1': point, 'GroupNorm_1': point_gn}


def take_head_block(cur: WeightCursor, num_depth: int,
                    use_separable_conv: bool,
                    use_squeeze_excite: bool) -> Dict:
    """The shared depth x [SE? -> Conv|MSC -> GN] stack (HeadBlock)."""
    out: Dict = {}
    for d in range(num_depth):
        if use_squeeze_excite:
            out[f'SqueezeExcite_{d}'] = take_squeeze_excite(cur)
        if use_separable_conv:
            out[f'MobileSeparableConv_{d}'] = take_mobile_sep(cur)
        else:
            out[f'Conv_{d}'] = take_conv(cur)
        out[f'GroupNorm_{d}'] = take_gn(cur)
    return out


# ---------------------------------------------------------------------------
# subnet converters (reference layer weights -> flax module params)
# ---------------------------------------------------------------------------

def convert_fpn(weights: Sequence[Weight], num_levels: int) -> Dict:
    """FeaturePyramid (detection.py:30-74): per level (stride-descending),
    1x1 lateral + 3x3 output, both biased."""
    cur = WeightCursor(weights, 'feature_pyramid')
    out: Dict = {}
    for idx in range(num_levels):
        out[f'lateral_{idx}'] = take_conv(cur)
        out[f'output_{idx}'] = take_conv(cur)
    cur.finish()
    return out


def convert_head_subnet(weights: Sequence[Weight], num_blocks: int,
                        num_depth: int = 4, use_separable_conv: bool = False,
                        use_squeeze_excite: bool = False,
                        name: str = 'sub_net') -> Dict:
    """ClassificationSubNet / BoxRegressionSubNet (detection.py:89-228):
    per level, HeadBlock + biased 3x3 output conv."""
    cur = WeightCursor(weights, name)
    out: Dict = {}
    for idx in range(num_blocks):
        out[f'block_{idx}'] = take_head_block(
            cur, num_depth, use_separable_conv, use_squeeze_excite)
        out[f'output_{idx}'] = take_conv(cur)
    cur.finish()
    return out


def convert_mask_subnet(weights: Sequence[Weight], num_blocks: int,
                        num_depth: int = 4, use_separable_conv: bool = False,
                        use_squeeze_excite: bool = False) -> Dict:
    """MaskSubNet (instance.py:158-240): per level, HeadBlock + 2x2/2
    transposed conv + 1x1 sigmoid output."""
    cur = WeightCursor(weights, 'mask_sub_net')
    out: Dict = {}
    for idx in range(num_blocks):
        out[f'level_{idx}'] = {
            'block': take_head_block(cur, num_depth, use_separable_conv,
                                     use_squeeze_excite),
            'upsample': take_conv_transpose(cur),
            'output': take_conv(cur),
        }
    cur.finish()
    return out


def convert_aspp(weights: Sequence[Weight],
                 atrous_rate: Sequence[int] = (6, 12, 18)) -> Dict:
    """ASPPNetwork (semantic.py:93-168)."""
    cur = WeightCursor(weights, 'aspp')
    out: Dict = {}
    out['aspp_1x1'] = take_conv(cur, use_bias=False)
    out['GroupNorm_0'] = take_gn(cur)
    for rate in atrous_rate:
        out[f'aspp_{rate}'] = take_atrous_sep(cur)
    out['aspp_pool'] = take_conv(cur, use_bias=False)
    out['concat_projection'] = take_conv(cur, use_bias=False)
    out['GroupNorm_1'] = take_gn(cur)
    cur.finish()
    return out


def convert_seg_subnet(weights: Sequence[Weight], num_depth: int = 2,
                       use_separable_conv: bool = False,
                       use_squeeze_excite: bool = False) -> Dict:
    """SegmentationSubNet (semantic.py:178-246)."""
    cur = WeightCursor(weights, 'segmentation_sub_net')
    out: Dict = {}
    out['skip_projection'] = take_conv(cur, use_bias=False)
    out['GroupNorm_0'] = take_gn(cur)
    out['HeadBlock_0'] = take_head_block(cur, num_depth, use_separable_conv,
                                         use_squeeze_excite)
    out['seg_output'] = take_conv(cur)
    cur.finish()
    return out


# ---------------------------------------------------------------------------
# backbones (name-addressed layer weights)
# ---------------------------------------------------------------------------

def _group_by_layer(weights: Sequence[Weight]) -> List[Tuple[str, List[Weight]]]:
    """Group a flat ordered weight list by its owning layer (the name's
    second-to-last path component), preserving order."""
    groups: List[Tuple[str, List[Weight]]] = []
    for name, value in weights:
        stripped = name.split(':')[0]
        parts = stripped.split('/')
        layer = parts[-2] if len(parts) >= 2 else stripped
        if groups and groups[-1][0] == layer:
            groups[-1][1].append((name, value))
        else:
            groups.append((layer, [(name, value)]))
    return groups


def _check_all_consumed(named, family: str) -> None:
    """Every weight-bearing layer must be consumed by the converter:
    leftovers mean the h5's topology is LARGER than the converter's
    (e.g. a resnet101v2 checkpoint fed to the resnet50v2 entry) — fail
    loudly instead of importing a structurally wrong subset (the
    'nothing is silently mis-assigned' contract)."""
    if named:
        raise ImportMismatch(
            f'{family}: {len(named)} unconsumed weight-bearing layers: '
            f'{sorted(named)[:6]}')


def convert_mobilenet(weights: Sequence[Weight]) -> Tuple[Dict, Dict]:
    """keras.applications MobileNet(alpha=1) -> MobileNetV1 body
    (params, batch_stats). Layer names: conv1, conv1_bn, conv_dw_k,
    conv_dw_k_bn, conv_pw_k, conv_pw_k_bn."""
    by_layer = dict(_group_by_layer(weights))

    def conv_bn(conv_name: str, bn_name: str, depthwise: bool,
                flax_name: str, params: Dict, stats: Dict):
        cur = WeightCursor(by_layer.pop(conv_name), conv_name)
        conv = take_depthwise(cur) if depthwise else take_conv(
            cur, use_bias=False)
        cur.finish()
        cur = WeightCursor(by_layer.pop(bn_name), bn_name)
        bn_p, bn_s = take_bn(cur)
        cur.finish()
        params[flax_name] = {'Conv_0': conv, 'BatchNorm_0': bn_p}
        stats[flax_name] = {'BatchNorm_0': bn_s}

    params: Dict = {}
    stats: Dict = {}
    conv_bn('conv1', 'conv1_bn', False, 'stem', params, stats)
    for i in range(1, 14):
        conv_bn(f'conv_dw_{i}', f'conv_dw_{i}_bn', True, f'dw{i}',
                params, stats)
        conv_bn(f'conv_pw_{i}', f'conv_pw_{i}_bn', False, f'pw{i}',
                params, stats)
    _check_all_consumed(by_layer, 'mobilenet')
    return params, stats


def convert_seresnet34(weights: Sequence[Weight],
                       stage_blocks: Sequence[int] = (3, 4, 6, 3)
                       ) -> Tuple[Dict, Dict]:
    """classification_models SEResNet34 -> CMResNet (params, batch_stats).

    Named layers (bn_data, conv0, bn0, stage{k}_unit{j}_{conv1,bn1,...},
    bn1) map by name; the ChannelSE 1x1 convs are anonymous ('conv2d_N')
    and are consumed in creation order, two per unit, with shape checks.
    """
    groups = _group_by_layer(weights)
    named: Dict[str, List[Weight]] = {}
    anon: List[List[Weight]] = []
    for layer, items in groups:
        if re.fullmatch(r'conv2d(_\d+)?', layer):
            anon.append(items)
        else:
            named.setdefault(layer, []).extend(items)

    def gcur(name: str) -> WeightCursor:
        if name not in named:
            raise ImportMismatch(f'seresnet34: missing layer {name!r}')
        return WeightCursor(named.pop(name), name)

    def bn(name: str, scale: bool = True):
        cur = gcur(name)
        p, s = take_bn(cur, scale=scale)
        cur.finish()
        return {'BatchNorm_0': p}, {'BatchNorm_0': s}

    def conv(name: str):
        cur = gcur(name)
        out = take_conv(cur, use_bias=False)
        cur.finish()
        return out

    params: Dict = {}
    stats: Dict = {}
    params['bn_data'], stats['bn_data'] = bn('bn_data', scale=False)
    params['conv0'] = conv('conv0')
    params['bn0'], stats['bn0'] = bn('bn0')

    se_iter = iter(anon)
    for si, blocks in enumerate(stage_blocks):
        for bi in range(blocks):
            unit = f'stage{si + 1}_unit{bi + 1}'
            p: Dict = {}
            s: Dict = {}
            p['bn1'], s['bn1'] = bn(unit + '_bn1')
            if bi == 0:
                p['sc'] = conv(unit + '_sc')
            p['conv1'] = conv(unit + '_conv1')
            p['bn2'], s['bn2'] = bn(unit + '_bn2')
            p['conv2'] = conv(unit + '_conv2')
            try:
                se1 = next(se_iter)
                se2 = next(se_iter)
            except StopIteration:
                raise ImportMismatch(f'seresnet34: no SE convs for {unit}')
            c = p['conv2']['kernel'].shape[-1]
            cur = WeightCursor(se1 + se2, unit + '_se')
            se = take_channel_se(cur)
            cur.finish()
            if se['fc1']['kernel'].shape[0] != c:
                raise ImportMismatch(
                    f'{unit}: SE reduce kernel {se["fc1"]["kernel"].shape} '
                    f'does not match {c} channels')
            p['se'] = se
            params[unit] = p
            stats[unit] = s
    params['bn1'], stats['bn1'] = bn('bn1')
    for leftover in se_iter:
        raise ImportMismatch(f'seresnet34: unconsumed SE convs {leftover}')
    _check_all_consumed(named, 'seresnet34')
    return params, stats


def convert_resnet_v2(weights: Sequence[Weight],
                      stage_blocks: Sequence[int] = (3, 4, 6, 3)
                      ) -> Tuple[Dict, Dict]:
    """keras_applications resnet_v2 (ResNet50V2/ResNet101V2,
    thirdparty/classification_models/models_factory.py:30;
    engine/backbone/base.py:204-212) -> ResNetV2 (params, batch_stats).

    Layer names: conv1_conv; conv{s}_block{b}_{preact_bn,1_conv,1_bn,
    2_conv,2_bn,3_conv} plus _0_conv on each stack's first block; post_bn.
    """
    named: Dict[str, List[Weight]] = {}
    for layer, items in _group_by_layer(weights):
        named.setdefault(layer, []).extend(items)

    def gcur(name: str) -> WeightCursor:
        if name not in named:
            raise ImportMismatch(f'resnet_v2: missing layer {name!r}')
        return WeightCursor(named.pop(name), name)

    def bn(name: str):
        cur = gcur(name)
        p, s = take_bn(cur)
        cur.finish()
        return {'BatchNorm_0': p}, {'BatchNorm_0': s}

    def conv(name: str, use_bias: bool):
        cur = gcur(name)
        out = take_conv(cur, use_bias=use_bias)
        cur.finish()
        return out

    params: Dict = {'stem': conv('conv1_conv', True)}
    stats: Dict = {}
    for si, blocks in enumerate(stage_blocks):
        for bi in range(blocks):
            ref = f'conv{si + 2}_block{bi + 1}'
            flax_name = f'stage{si + 2}_block{bi + 1}'
            p: Dict = {}
            s: Dict = {}
            p['preact_bn'], s['preact_bn'] = bn(ref + '_preact_bn')
            if bi == 0:
                p['conv0'] = conv(ref + '_0_conv', True)
            p['conv1'] = conv(ref + '_1_conv', False)
            p['bn1'], s['bn1'] = bn(ref + '_1_bn')
            p['conv2'] = conv(ref + '_2_conv', False)
            p['bn2'], s['bn2'] = bn(ref + '_2_bn')
            p['conv3'] = conv(ref + '_3_conv', True)
            params[flax_name] = p
            stats[flax_name] = s
    params['post_bn'], stats['post_bn'] = bn('post_bn')
    _check_all_consumed(named, 'resnet_v2')
    return params, stats


def convert_vgg16(weights: Sequence[Weight]) -> Tuple[Dict, Dict]:
    """keras.applications VGG16 (engine/backbone/base.py:248-252) -> VGG16
    body. Named biased convs block{i}_conv{j}; no normalization layers."""
    named: Dict[str, List[Weight]] = {}
    for layer, items in _group_by_layer(weights):
        named.setdefault(layer, []).extend(items)
    params: Dict = {}
    for bi, convs in enumerate((2, 2, 3, 3, 3), start=1):
        for ci in range(1, convs + 1):
            name = f'block{bi}_conv{ci}'
            if name not in named:
                raise ImportMismatch(f'vgg16: missing layer {name!r}')
            cur = WeightCursor(named.pop(name), name)
            params[name] = take_conv(cur, use_bias=True)
            cur.finish()
    _check_all_consumed(named, 'vgg16')
    return params, {}


def _stack_group_convs(kernels: List[np.ndarray],
                       biases: Optional[List[np.ndarray]] = None) -> Dict:
    """Concatenate per-group Conv2D kernels (GroupConv2D,
    _common_blocks.py:13-78: slice -> conv -> concat) along the output
    axis into one XLA grouped-conv kernel [H, W, in/G, out]."""
    out = {'kernel': np.concatenate(kernels, axis=-1)}
    if biases is not None:
        out['bias'] = np.concatenate(biases, axis=-1)
    return out


def _depthwise_to_grouped(kernel: np.ndarray, groups: int) -> np.ndarray:
    """ResNext.py's grouped conv (DepthwiseConv2D depth_multiplier=c +
    SplitGroups/ReduceGroups/MergeGroups, ResNext.py:23-77,213-219) ->
    XLA grouped kernel.

    Reference: out[.., g*c + m] = sum_i conv(x[.., g*c + i],
    K[:, :, g*c + i, m]) with c = in_ch // groups. XLA layout
    [H, W, in/G, out]: F[h, w, i, g*c + m] = K[h, w, g*c + i, m].
    """
    h, w, in_ch, mult = kernel.shape
    c = in_ch // groups
    if mult != c:
        raise ImportMismatch(
            f'resnext 3x3: depth_multiplier {mult} != in/groups {c}')
    k = kernel.reshape(h, w, groups, c, mult)
    return k.transpose(0, 1, 3, 2, 4).reshape(h, w, c, groups * mult)


def convert_resnext50(weights: Sequence[Weight]) -> Tuple[Dict, Dict]:
    """engine/backbone/ResNext.py ResNeXt50 -> ResNet(groups=32,
    expansion=2) body. Keras-style names conv{s}_block{b}_{0,1,2,3}_conv /
    _bn; all convs bias-free; the 3x3 is the depthwise+reduce trick."""
    named: Dict[str, List[Weight]] = {}
    for layer, items in _group_by_layer(weights):
        named.setdefault(layer, []).extend(items)

    def gcur(name: str) -> WeightCursor:
        if name not in named:
            raise ImportMismatch(f'resnext50: missing layer {name!r}')
        return WeightCursor(named.pop(name), name)

    def bn(name: str):
        cur = gcur(name)
        p, s = take_bn(cur)
        cur.finish()
        return {'BatchNorm_0': p}, {'BatchNorm_0': s}

    def conv(name: str):
        cur = gcur(name)
        out = take_conv(cur, use_bias=False)
        cur.finish()
        return out

    params: Dict = {'stem': conv('conv1_conv')}
    stats: Dict = {}
    params['stem_bn'], stats['stem_bn'] = bn('conv1_bn')
    for si, blocks in enumerate((3, 4, 6, 3)):
        sp: Dict = {}
        ss: Dict = {}
        for bi in range(blocks):
            ref = f'conv{si + 2}_block{bi + 1}'
            flax_name = f'BottleneckBlock_{bi}'
            p: Dict = {}
            s: Dict = {}
            p['Conv_0'] = conv(ref + '_1_conv')
            p['_BN_0'], s['_BN_0'] = bn(ref + '_1_bn')
            dw = conv(ref + '_2_conv')
            p['Conv_1'] = {
                'kernel': _depthwise_to_grouped(dw['kernel'], 32)}
            p['_BN_1'], s['_BN_1'] = bn(ref + '_2_bn')
            p['Conv_2'] = conv(ref + '_3_conv')
            p['_BN_2'], s['_BN_2'] = bn(ref + '_3_bn')
            if bi == 0:
                p['Conv_3'] = conv(ref + '_0_conv')
                p['_BN_3'], s['_BN_3'] = bn(ref + '_0_bn')
            sp[flax_name] = p
            ss[flax_name] = s
        params[f'stage{si + 2}'] = sp
        stats[f'stage{si + 2}'] = ss
    _check_all_consumed(named, 'resnext50')
    return params, stats


def convert_resnet50(weights: Sequence[Weight]) -> Tuple[Dict, Dict]:
    """tf.keras.applications ResNet50 v1 (engine/backbone/base.py:190-195;
    endpoint taps base.py:105-111 are the stage-output relus) ->
    ResNet(stride_first=True, conv_bias=True) (params, batch_stats).

    Layer names: conv1_conv/conv1_bn (biased 7x7 stem), then per block
    ``conv{s}_block{b}_{1,2,3}_{conv,bn}`` (biased convs, stride on the
    first 1x1 — 'caffe style') plus ``_0_{conv,bn}`` shortcut on each
    stack's first block; eps 1.001e-5 everywhere.
    """
    named: Dict[str, List[Weight]] = {}
    for layer, items in _group_by_layer(weights):
        named.setdefault(layer, []).extend(items)

    def gcur(name: str) -> WeightCursor:
        if name not in named:
            raise ImportMismatch(f'resnet50: missing layer {name!r}')
        return WeightCursor(named.pop(name), name)

    def bn(name: str):
        cur = gcur(name)
        p, st = take_bn(cur)
        cur.finish()
        return {'BatchNorm_0': p}, {'BatchNorm_0': st}

    def conv(name: str):
        cur = gcur(name)
        out = take_conv(cur, use_bias=True)
        cur.finish()
        return out

    params: Dict = {'stem': conv('conv1_conv')}
    stats: Dict = {}
    params['stem_bn'], stats['stem_bn'] = bn('conv1_bn')
    for si, blocks in enumerate((3, 4, 6, 3)):
        sp: Dict = {}
        ss: Dict = {}
        for bi in range(blocks):
            ref = f'conv{si + 2}_block{bi + 1}'
            flax_name = f'BottleneckBlock_{bi}'
            p: Dict = {}
            st: Dict = {}
            p['Conv_0'] = conv(ref + '_1_conv')
            p['_BN_0'], st['_BN_0'] = bn(ref + '_1_bn')
            p['Conv_1'] = conv(ref + '_2_conv')
            p['_BN_1'], st['_BN_1'] = bn(ref + '_2_bn')
            p['Conv_2'] = conv(ref + '_3_conv')
            p['_BN_2'], st['_BN_2'] = bn(ref + '_3_bn')
            if bi == 0:
                p['Conv_3'] = conv(ref + '_0_conv')
                p['_BN_3'], st['_BN_3'] = bn(ref + '_0_bn')
            sp[flax_name] = p
            ss[flax_name] = st
        params[f'stage{si + 2}'] = sp
        stats[f'stage{si + 2}'] = ss
    _check_all_consumed(named, 'resnet50')
    return params, stats


def convert_senet(weights: Sequence[Weight], groups: int = 1,
                  stage_blocks: Sequence[int] = (3, 4, 6, 3)
                  ) -> Tuple[Dict, Dict]:
    """Vendored senet.py SEResNet50/SEResNeXt50 -> ResNet(use_se=True)
    body. All block layers are anonymous, so weights are consumed in
    functional build order (senet.py:46-135,299-307): stem conv+bn; per
    block conv1/bn, 3x3 (one conv, or ``groups`` per-group convs)/bn,
    conv3/bn, then the two SE convs, then shortcut conv+bn on stage-first
    blocks (tf2 Model.weights is graph-topological: the SE branch hangs
    off bn3 and sorts before the shortcut conv even though the shortcut
    layer is *created* first, senet.py:73-81)."""
    cur = WeightCursor(list(weights), 'senet')

    def bn():
        p, s = take_bn(cur)
        return {'BatchNorm_0': p}, {'BatchNorm_0': s}

    def conv():
        return take_conv(cur, use_bias=False)

    params: Dict = {'stem': conv()}
    stats: Dict = {}
    params['stem_bn'], stats['stem_bn'] = bn()
    for si, blocks in enumerate(stage_blocks):
        sp: Dict = {}
        ss: Dict = {}
        for bi in range(blocks):
            p: Dict = {}
            s: Dict = {}
            p['Conv_0'] = conv()
            p['_BN_0'], s['_BN_0'] = bn()
            if groups > 1:
                ks = [conv()['kernel'] for _ in range(groups)]
                p['Conv_1'] = _stack_group_convs(ks)
            else:
                p['Conv_1'] = conv()
            p['_BN_1'], s['_BN_1'] = bn()
            p['Conv_2'] = conv()
            p['_BN_2'], s['_BN_2'] = bn()
            p['_SE_0'] = take_channel_se(cur)
            if bi == 0:
                p['Conv_3'] = conv()
                p['_BN_3'], s['_BN_3'] = bn()
            sp[f'BottleneckBlock_{bi}'] = p
            ss[f'BottleneckBlock_{bi}'] = s
        params[f'stage{si + 2}'] = sp
        stats[f'stage{si + 2}'] = ss
    cur.finish()
    return params, stats


def convert_efficientnet(weights: Sequence[Weight],
                         width: float = 1.1,
                         depth: float = 1.2) -> Tuple[Dict, Dict]:
    """EfficientNet (the ``efficientnet`` package the reference builds at
    engine/backbone/base.py:259-279; keras.applications shares its layer
    naming) -> flax EfficientNet (params, batch_stats).

    Layer names: stem_conv/stem_bn; per block ``block{S}{a..}_`` with
    expand_conv/expand_bn (expand!=1 only), dwconv/bn, se_reduce/se_expand
    (biased), project_conv/project_bn; then top_conv/top_bn.
    """
    from ..nn.backbone.efficientnet import (_BASE_BLOCKS, _round_filters,
                                            _round_repeats)
    named: Dict[str, List[Weight]] = {}
    for layer, items in _group_by_layer(weights):
        named.setdefault(layer, []).extend(items)

    def gcur(name: str) -> WeightCursor:
        if name not in named:
            raise ImportMismatch(f'efficientnet: missing layer {name!r}')
        return WeightCursor(named.pop(name), name)

    def bn(name: str):
        cur = gcur(name)
        p, s = take_bn(cur)
        cur.finish()
        return {'BatchNorm_0': p}, {'BatchNorm_0': s}

    def conv(name: str, use_bias: bool):
        cur = gcur(name)
        out = take_conv(cur, use_bias=use_bias)
        cur.finish()
        return out

    def dwconv(name: str):
        cur = gcur(name)
        out = take_depthwise(cur)
        cur.finish()
        return out

    params: Dict = {'stem': conv('stem_conv', False)}
    got_ch = params['stem']['kernel'].shape[-1]
    want_ch = _round_filters(32, width)
    if got_ch != want_ch:
        raise ImportMismatch(
            f'efficientnet: stem width {got_ch} != {want_ch} — the h5 is '
            f'a different width variant than the configured backbone')
    stats: Dict = {}
    params['stem_bn'], stats['stem_bn'] = bn('stem_bn')
    for si, (expand, ch, repeats, stride, kernel) in enumerate(_BASE_BLOCKS):
        for bi in range(_round_repeats(repeats, depth)):
            ref = f'block{si + 1}{chr(97 + bi)}'
            flax_name = f'stage{si}_block{bi}'
            p: Dict = {}
            s: Dict = {}
            ci = 0
            bni = 0
            if expand != 1:
                p[f'Conv_{ci}'] = conv(ref + '_expand_conv', False)
                ci += 1
                p[f'_BN_{bni}'], s[f'_BN_{bni}'] = bn(ref + '_expand_bn')
                bni += 1
            p[f'Conv_{ci}'] = dwconv(ref + '_dwconv')
            ci += 1
            p[f'_BN_{bni}'], s[f'_BN_{bni}'] = bn(ref + '_bn')
            bni += 1
            p[f'Conv_{ci}'] = conv(ref + '_se_reduce', True)
            ci += 1
            p[f'Conv_{ci}'] = conv(ref + '_se_expand', True)
            ci += 1
            p[f'Conv_{ci}'] = conv(ref + '_project_conv', False)
            p[f'_BN_{bni}'], s[f'_BN_{bni}'] = bn(ref + '_project_bn')
            params[flax_name] = p
            stats[flax_name] = s
    params['top_conv'] = conv('top_conv', False)
    params['top_bn'], stats['top_bn'] = bn('top_bn')
    # tf.keras EfficientNet bakes input normalization into the model as a
    # 'normalization' layer (mean/variance buffers); the reference's
    # efficientnet package does not, and this framework applies the same
    # normalization through the preprocessing combo table
    # (nn/backbone/preprocess.py, normalize=3) — discard, don't import
    named.pop('normalization', None)
    _check_all_consumed(named, 'efficientnet')
    return params, stats


_BACKBONE_CONVERTERS = {
    'mobilenet': convert_mobilenet,
    'resnet50': convert_resnet50,
    'seresnet34': convert_seresnet34,
    'resnet50v2': lambda w: convert_resnet_v2(w, (3, 4, 6, 3)),
    'resnet101v2': lambda w: convert_resnet_v2(w, (3, 4, 23, 3)),
    'resnext50': convert_resnext50,
    'vgg16': convert_vgg16,
    'seresnet50': lambda w: convert_senet(w, groups=1),
    'seresnext50': lambda w: convert_senet(w, groups=32),
    'efficientnetb2': lambda w: convert_efficientnet(w, 1.1, 1.2),
    'efficientnetb3': lambda w: convert_efficientnet(w, 1.2, 1.4),
    'efficientnetb4': lambda w: convert_efficientnet(w, 1.4, 1.8),
}


def convert_backbone(weights: Sequence[Weight],
                     backbone_type: str) -> Tuple[Dict, Dict]:
    """Reference backbone Model weights (body + P6/P7 extras,
    base.py:185-316) -> BackboneNetwork (params, batch_stats)."""
    bt = backbone_type.lower()
    if bt not in _BACKBONE_CONVERTERS:
        raise NotImplementedError(
            f'no weight converter for backbone {backbone_type!r} yet; '
            f'available: {sorted(_BACKBONE_CONVERTERS)}')
    body_w: List[Weight] = []
    extras: Dict[str, List[Weight]] = {}
    for name, value in weights:
        layer = name.split(':')[0].split('/')[-2] if '/' in name else name
        if layer in ('P6_conv', 'P6_norm', 'P7_conv'):
            extras.setdefault(layer, []).append((name, value))
        else:
            body_w.append((name, value))
    body_params, body_stats = _BACKBONE_CONVERTERS[bt](body_w)
    # the body's module name inside BackboneNetwork, from the registry
    body_name = body_module_name(bt)
    params: Dict = {body_name: body_params}
    stats: Dict = {body_name: body_stats}
    if extras:
        cur = WeightCursor(extras['P6_conv'], 'P6_conv')
        params['extras_P6_conv'] = take_conv(cur)
        cur.finish()
        if 'P6_norm' in extras:
            cur = WeightCursor(extras['P6_norm'], 'P6_norm')
            params['extras_P6_norm'] = take_gn(cur)
            cur.finish()
        if 'P7_conv' in extras:
            cur = WeightCursor(extras['P7_conv'], 'P7_conv')
            params['extras_P7_conv'] = take_conv(cur)
            cur.finish()
    return params, stats


# ---------------------------------------------------------------------------
# whole-model h5 import
# ---------------------------------------------------------------------------

def read_h5_groups(path: str) -> Dict[str, List[Weight]]:
    """Read a Keras h5 into {top_level_layer_name: ordered [(name, arr)]}.

    Uses the ``layer_names`` / ``weight_names`` attrs (Keras 2 and Keras 3
    legacy format both write them) so order is the layer's creation order.
    """
    import h5py
    out: Dict[str, List[Weight]] = {}
    with h5py.File(path, 'r') as f:
        root = f['model_weights'] if 'model_weights' in f else f
        layer_names = [n.decode() if isinstance(n, bytes) else n
                       for n in root.attrs['layer_names']]
        for layer in layer_names:
            grp = root[layer]
            wnames = [n.decode() if isinstance(n, bytes) else n
                      for n in grp.attrs.get('weight_names', [])]
            out[layer] = [(wn, np.asarray(grp[wn])) for wn in wnames]
    return out


def read_h5_weights(path: str) -> List[Weight]:
    """Flatten an h5 weight file into [(path, array)] in storage order."""
    import h5py
    out: List[Weight] = []

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            out.append((name, np.asarray(obj)))

    with h5py.File(path, 'r') as f:
        root = f['model_weights'] if 'model_weights' in f else f
        root.visititems(visit)
    return out


def find_group(names: Sequence[str], pattern: str) -> str:
    """Regex lookup of a layer-group name, like the reference's
    find_layer_name (retinamasklab.py:646-650)."""
    matches = [n for n in names if re.search(pattern, n)]
    if len(matches) != 1:
        raise ImportMismatch(
            f'pattern {pattern!r} matched {matches} in {list(names)}')
    return matches[0]


def load_reference_h5(path: str, config) -> Dict:
    """Reference inference-model h5 -> MaskLab ``variables``.

    Discovers the subnet layer groups by the same name regexes the
    reference uses to rebuild inference models
    (retinamasklab.py:528-584), converts each with its structure-validated
    converter, and returns {'params': ..., 'batch_stats': ...} matching
    ``MaskLab`` (models/masklab.py).
    """
    groups = read_h5_groups(path)
    names = list(groups)
    det = config.detection
    ins = config.instance
    sem = config.semantic
    num_levels = len(config.backbone.backbone_outputs)
    num_fpn = len([n for n in config.backbone.backbone_outputs
                   if n in det.feature_pyramid_inputs])

    subnet_names = {find_group(names, pat) for pat in (
        r'^feature_pyramid', r'^classification_sub_net',
        r'^box_regression_sub_net', r'^mask_sub_net', r'^aspp',
        r'^segmentation_sub_net')}
    params: Dict = {}
    stats: Dict = {}
    bt = config.backbone.backbone_type.lower()
    if bt in names:
        # backbone saved as a nested Model layer
        backbone_weights = groups[bt]
    else:
        # construct_inference_network reuses the backbone's input tensor
        # (retinamasklab.py:427), flattening its layers into the top level;
        # the backbone is every weight-bearing group that is not a subnet
        backbone_weights = [w for name in names
                            if name not in subnet_names
                            for w in groups[name]]
    params['backbone'], stats['backbone'] = convert_backbone(
        backbone_weights, config.backbone.backbone_type)
    params['fpn'] = convert_fpn(
        groups[find_group(names, r'^feature_pyramid')], num_fpn)
    params['cls_subnet'] = convert_head_subnet(
        groups[find_group(names, r'^classification_sub_net')],
        num_levels, det.num_depth, det.use_separable_conv,
        det.use_squeeze_excite, name='classification_sub_net')
    # reference quirk: loc head's use_squeeze_excite is wired from
    # use_separable_conv (retinamasklab.py:95)
    params['loc_subnet'] = convert_head_subnet(
        groups[find_group(names, r'^box_regression_sub_net')],
        num_levels, det.num_depth, det.use_separable_conv,
        det.use_separable_conv, name='box_regression_sub_net')
    params['mask_subnet'] = convert_mask_subnet(
        groups[find_group(names, r'^mask_sub_net')],
        ins.max_k + 1, ins.num_depth, ins.use_separable_conv,
        ins.use_squeeze_excite)
    params['aspp'] = convert_aspp(
        groups[find_group(names, r'^aspp')], tuple(sem.atrous_rate))
    params['seg_subnet'] = convert_seg_subnet(
        groups[find_group(names, r'^segmentation_sub_net')],
        sem.num_depth, sem.use_separable_conv, sem.use_squeeze_excite)
    return {'params': params, 'batch_stats': stats}


def load_reference_h5_into(model, path: str):
    """Fill the port's ``model`` (a ``MaskLab``) from a reference
    inference-model h5: ``load_reference_h5`` with the model's own config,
    then ``weights.load_flax_variables``. Returns the model."""
    from ..weights import load_flax_variables
    return load_flax_variables(model, load_reference_h5(path, model.config))
