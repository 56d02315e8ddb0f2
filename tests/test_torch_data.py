"""The port's data pipeline against the JAX package's: exactly equal.

Every step on both sides is host numpy / cv2 (the port reads and writes the
ETL's tables without pandas), so the same seed gives the same files, bytes
and arrays: synthetic datasets, the ETL's outputs (in process and through
the worker pool), the seed-777 split, dataset samples and slices, generator
batches over two epochs, the worker-process loader, ``pad_boxes_to``; and
the prefetcher, imglab adapters and native rasterizer by their own cases.
"""
import filecmp
import io
import json
import os
import shutil
import time

import numpy as np
import pandas as pd
import pytest

from masklab_tpu import data as jdata
from masklab_tpu.data import process as jprocess
from masklab_tpu_torch import data as tdata
from masklab_tpu_torch.data import generator as tgenerator
from masklab_tpu_torch.data import process as tprocess
from masklab_tpu_torch.data import tables

# 20 frames: a 18 / 2 split, and ~90 annotations, past the 16 rows below
# which numpy's quicksort (the reference's sort_values) happens to be stable
FRAMES, HW = 20, (128, 160)


def _make(package, root, name, frames=FRAMES, workers=1, seed=1,
          per_label_images=False):
    d = os.path.join(root, name)
    package.make_synthetic_dataset(d, num_images=frames, image_hw=HW,
                                   seed=seed)
    if per_label_images:
        # each label's json lists only the images it annotates, so the
        # labels' image lists differ (the reference then sorts names)
        for label in os.listdir(os.path.join(d, 'labels')):
            path = os.path.join(d, 'labels', label, 'labels.json')
            with open(path) as f:
                payload = json.load(f)
            used = {a['image_id'] for a in payload['annotations']}
            payload['images'] = [im for im in payload['images']
                                 if im['id'] in used]
            with open(path, 'w') as f:
                json.dump(payload, f)
    package.process_dataset(d, num_workers=workers)
    return d


@pytest.fixture(scope='module')
def dirs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('torch_data'))
    return {pkg: _make(mod, root, pkg)
            for pkg, mod in (('jax', jdata), ('port', tdata))}


def _tree_files(d):
    return sorted(os.path.relpath(os.path.join(base, f), d)
                  for base, _, files in os.walk(d) for f in files)


def _assert_same_files(a, b, sub=''):
    fa, fb = _tree_files(os.path.join(a, sub)), _tree_files(os.path.join(b,
                                                                          sub))
    assert fa == fb
    assert fa
    for f in fa:
        assert filecmp.cmp(os.path.join(a, sub, f), os.path.join(b, sub, f),
                           shallow=False), f


@pytest.mark.parametrize('sub', ['images', 'labels'])
def test_synthetic_dataset_files_identical(dirs, sub):
    """The JPEGs and the labels/*/labels.json, byte for byte."""
    _assert_same_files(dirs['jax'], dirs['port'], sub)


@pytest.mark.parametrize('case', ['in process', 'pool', 'per-label images'])
def test_etl_outputs_identical(dirs, tmp_path, case):
    """label_exists.tsv, boxes.tsv, train.csv, valid.csv and every semantic
    and instance PNG, byte for byte: in process, through the port's pool of
    two workers (against the reference in process: a fork of this process,
    which holds JAX's threads, is not safe), and with labels whose jsons
    list different images."""
    a, b = dirs['jax'], dirs['port']
    if case == 'pool':
        b = _make(tdata, str(tmp_path), 'port', workers=2)
    elif case == 'per-label images':
        a = _make(jdata, str(tmp_path), 'jax', per_label_images=True)
        b = _make(tdata, str(tmp_path), 'port', per_label_images=True)
    _assert_same_files(a, b, 'processed')
    with open(os.path.join(b, 'processed', 'boxes.tsv')) as f:
        assert len(f.readlines()) > 17


def test_split_cases(dirs, tmp_path):
    """The seed-777 split, and the small-set and unprocessed fallbacks to
    (None, None)."""
    split = tprocess.load_split_cases(dirs['port'])
    assert split == jprocess.load_split_cases(dirs['jax'])
    assert (len(split[0]), len(split[1])) == (18, 2)
    small = _make(tdata, str(tmp_path), 'small', frames=6)
    assert tprocess.load_split_cases(small) == (None, None)
    assert jprocess.load_split_cases(small) == (None, None)
    assert tprocess.load_split_cases(str(tmp_path / 'none')) == (None, None)


def _assert_same_arrays(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _instance_box_area(d):
    """w * h, as pandas parses them, of boxes.tsv's first instance box."""
    df = pd.read_csv(os.path.join(d, 'processed', 'boxes.tsv'), sep='\t')
    df = df[df.label.isin(jdata.synthetic.INSTANCE_LABELS)]
    return float(df.w.iloc[0] * df.h.iloc[0])


@pytest.mark.parametrize('min_area', [50.0, 1000.0, 'a box area'])
def test_dataset_samples_and_slices(dirs, min_area):
    """Every sample and two slices, arrays and dtypes equal. 'a box area'
    sets min_area to an instance box's own area, which the strict > drops
    on both sides."""
    if min_area == 'a box area':
        min_area = _instance_box_area(dirs['jax'])
        kept = tdata.MaskLabDataset(data_dir=dirs['port'], min_area=min_area)
        assert sum(map(len, kept.boxes.values())) < sum(map(len, (
            tdata.MaskLabDataset(data_dir=dirs['port'], min_area=0.0)
            .boxes.values())))
    want = jdata.MaskLabDataset(data_dir=dirs['jax'], min_area=min_area)
    got = tdata.MaskLabDataset(data_dir=dirs['port'], min_area=min_area)
    assert list(got.cases) == list(want.cases)
    for i in range(len(want)):
        _assert_same_arrays(got[i], want[i])
    for sl in (slice(0, 4), slice(5, 12)):
        _assert_same_arrays(got[sl], want[sl])
    _assert_same_arrays(got[str(want.cases[2])], want[str(want.cases[2])])


def test_generator_two_epochs(dirs):
    """Same seed: the same shuffles and scale draws, batch for batch, over
    two epochs (each list() runs one epoch to its end-of-epoch shuffle)."""
    kw = dict(batch_size=3, seed=5, scale_ratio=(0.4, 0.6),
              scale_buckets=(0.4, 0.45, 0.5, 0.55, 0.6))
    want = jdata.MaskLabGenerator(
        jdata.MaskLabDataset(data_dir=dirs['jax'], min_area=50.0)
        .get_config(), **kw)
    got = tdata.MaskLabGenerator(
        tdata.MaskLabDataset(data_dir=dirs['port'], min_area=50.0)
        .get_config(), **kw)
    for _ in range(2):
        w_batches, g_batches = list(want), list(got)
        assert len(g_batches) == len(w_batches) == FRAMES // 3
        for g, w in zip(g_batches, w_batches):
            _assert_same_arrays(g, w)


@pytest.mark.parametrize('slots', [2, 12])
def test_pad_boxes_to(dirs, slots):
    batch = tdata.MaskLabGenerator(
        tdata.MaskLabDataset(data_dir=dirs['port'], min_area=50.0)
        .get_config(), batch_size=4, shuffle=False)[0]
    _assert_same_arrays(tdata.pad_boxes_to(batch, slots),
                        jdata.pad_boxes_to(batch, slots))


def test_multiprocess_loader(dirs):
    """Two spawned workers on each side, two epochs: the same batches in the
    same order."""
    out = []
    for pkg, d in ((jdata, dirs['jax']), (tdata, dirs['port'])):
        loader = pkg.MultiprocessLoader(
            pkg.MaskLabDataset(data_dir=d, min_area=50.0).get_config(),
            num_workers=2, batch_size=4, scale_ratio=(0.4, 0.6),
            scale_buckets=(0.4, 0.5, 0.6), seed=3)
        try:
            out.append([b for _ in range(2) for b in loader])
        finally:
            loader.close()
    want, got = out
    assert len(got) == len(want) == 2 * (FRAMES // 4)
    for g, w in zip(got, want):
        _assert_same_arrays(g, w)


# ---- PrefetchIterator: tests/test_data_pipeline.py's behaviour cases ----

def test_prefetch_iterator_close_stops_consuming():
    """close() stops the fill thread without advancing the source further."""
    consumed = []

    def source():
        for i in range(1000):
            consumed.append(i)
            yield i

    pf = tgenerator.PrefetchIterator(source(), prefetch=2)
    it = iter(pf)
    assert next(it) == 0 and next(it) == 1
    pf.close()
    assert not pf.thread.is_alive()
    n_after_close = len(consumed)
    time.sleep(0.3)
    assert len(consumed) == n_after_close
    assert n_after_close <= 2 + 2 + 1         # consumed + prefetch + in-flight


def test_prefetch_iterator_continues_across_epoch_boundary():
    """6 batches pulled from a 4-batch source via rotation cover the whole
    source and wrap, as the trainer's one prefetcher per phase does."""

    class Source:
        def __init__(self):
            self.epochs = 0

        def __iter__(self):
            for i in range(4):
                yield (self.epochs, i)
            self.epochs += 1

    src = Source()
    pf = tgenerator.PrefetchIterator(src, prefetch=2)
    it = iter(pf)
    got = []
    for _ in range(6):
        try:
            got.append(next(it))
        except StopIteration:
            pf.close()
            pf = tgenerator.PrefetchIterator(src, prefetch=2)
            it = iter(pf)
            got.append(next(it))
    pf.close()
    assert got == [(0, 0), (0, 1), (0, 2), (0, 3), (1, 0), (1, 1)]
    assert src.epochs >= 1


# ---- imglab ----

def test_imglab_round_trip_and_reference(dirs):
    """json -> rows -> json -> rows keeps the annotations; rows -> json
    equals the reference's adapter on the same table as a plain DataFrame
    (annotations ordered by area, largest first, within each image)."""
    path = os.path.join(dirs['port'], 'labels', 'my_road', 'labels.json')
    with open(path) as f:
        payload = json.load(f)
    rows = tdata.imglabformat_to_dataframe(payload)
    assert rows and set(rows[0]) == {'file_name', 'segmentation', 'name',
                                     'bbox'}
    frame = jdata.imglabformat_to_dataframe(payload)
    assert [r['file_name'] for r in rows] == list(frame.file_name.astype(str))
    back = tdata.dataframe_to_imglabformat(rows, image_wh=(160, 128))
    assert len(tdata.imglabformat_to_dataframe(back)) == len(rows)
    # uneven areas within one image, so the area order is exercised
    for i, r in enumerate(rows):
        r['file_name'] = f'frame_{i % 3:04d}.jpg'
        r['segmentation'] = [[v * (1 + 0.1 * i) for v in
                              r['segmentation'][0]]]
    want = jdata.dataframe_to_imglabformat(pd.DataFrame(rows),
                                           image_wh=(160, 128))
    got = tdata.dataframe_to_imglabformat(rows, image_wh=(160, 128))
    assert json.dumps(got) == json.dumps(want)


# ---- the tables' pandas semantics ----

def test_parse_float_matches_pandas():
    """pandas' default converter is not correctly rounded; the port's
    parser gives its exact bits (float() differs on ~1 in 5 values)."""
    rng = np.random.RandomState(0)
    values = np.concatenate([rng.uniform(0, 2000, 3000),
                             rng.uniform(0, 1, 1000),
                             -rng.uniform(0, 2000, 500),
                             rng.uniform(0, 1, 500) * 1e-7,
                             rng.uniform(0, 1, 500) * 1e20,
                             [0.0, 1e-5, 123.0, 5.0, 1.5e300]])
    text = list(values.astype(str))
    want = pd.read_csv(io.StringIO('\n'.join(['x'] + text))).x.values
    got = np.array([tables.parse_float(t) for t in text])
    np.testing.assert_array_equal(got, want)
    assert (want != values).any()


@pytest.mark.parametrize('kind', ['categorical', 'float descending'])
def test_sort_order_matches_pandas(kind):
    rng = np.random.RandomState(1)
    if kind == 'categorical':
        names = [f'f{i}' for i in rng.randint(0, 7, 300)]
        cats = sorted(set(names))
        frame = pd.DataFrame({'k': pd.Categorical(names, categories=cats),
                              'i': range(len(names))})
        want = frame.sort_values('k').i.values
        got = tables.sort_order(tables.category_codes(names, cats))
    else:
        keys = rng.randint(0, 5, 300).astype(np.float64)
        frame = pd.DataFrame({'k': keys, 'i': range(len(keys))})
        want = frame.sort_values('k', ascending=False).i.values
        got = tables.sort_order(keys, ascending=False)
    np.testing.assert_array_equal(got, want)


# ---- the native rasterizer: tests/test_native.py's cases ----

@pytest.fixture(scope='module')
def native():
    from masklab_tpu_torch import native
    if shutil.which('g++') is None or native.load() is None:
        pytest.skip('no C++ toolchain available')
    return native


def test_native_fill_rect_matches_cv2(native):
    import cv2
    pts = np.asarray([[5, 3], [20, 3], [20, 12], [5, 12]], np.float64)
    ours = np.zeros((16, 24), np.uint8)
    assert native.fill_polygon_native(ours, pts)
    ref = np.zeros((16, 24), np.uint8)
    cv2.fillPoly(ref, [pts.astype(np.int32)], 1)
    diff = np.abs(ours.astype(int) - ref.astype(int))
    assert diff.sum() <= 2 * (np.ptp(pts[:, 0]) + np.ptp(pts[:, 1]))
    assert ours[7, 12] == 1 and ours[0, 0] == 0


def test_native_fill_triangle_interior(native):
    pts = np.asarray([[2, 2], [30, 2], [2, 30]], np.float64)
    mask = np.zeros((32, 32), np.uint8)
    native.fill_polygon_native(mask, pts)
    assert mask[5, 5] == 1
    assert mask[31, 31] == 0
    assert mask.sum() > 300


def test_native_row_extents(native):
    mask = np.zeros((8, 16), np.uint8)
    mask[2, 3:9] = 1
    mask[5, 0] = 1
    x_min, x_max = native.row_extents_native(mask)
    assert x_min[2] == 3 and x_max[2] == 8
    assert x_min[5] == 0 and x_max[5] == 0
    assert x_min[0] == -1 and x_max[0] == -1


def test_fill_polygon_without_cv2_takes_the_native_filler(native,
                                                          monkeypatch):
    """Without cv2 the ETL's filler is the native one: the same pixels as
    the reference's native filler, within cv2's boundary pixels."""
    import cv2
    from masklab_tpu.native import fill_polygon_native as jax_native
    pts = np.asarray([[10.3, 4.6], [60.2, 9.1], [48.7, 50.5], [7.5, 40.2]])
    monkeypatch.setattr(tprocess, 'cv2', None)
    ours = np.zeros((64, 72), np.uint8)
    tprocess._fill_polygon(ours, pts)
    ref = np.zeros((64, 72), np.uint8)
    assert jax_native(ref, pts)
    np.testing.assert_array_equal(ours, ref)
    with_cv2 = np.zeros((64, 72), np.uint8)
    cv2.fillPoly(with_cv2, [np.round(pts).astype(np.int32)], 1)
    assert np.abs(ours.astype(int) - with_cv2).sum() <= 2 * (64 + 72)
