"""The traffic is reproducible from ``--seed``: the batch cell's frames and
the frames it judges, and the training cell's labelled dataset; another
seed draws other frames of the same sizes."""
import numpy as np

from perfbench.harness import dataset, spec
from perfbench.tools.control import judged_frames

BIG_SEED = 2 ** 31 + 12345
TRAFFIC = dict(spec.traffic_of({'traffic': 'batch-summarize'}),
               frame_hw=[72, 128], batch=2, distinct_batches=3, judged=2)


def test_batch_frames_reproducible_from_the_seed():
    a = judged_frames({}, TRAFFIC, BIG_SEED, 1.0)
    b = judged_frames({}, TRAFFIC, BIG_SEED, 1.0)
    assert len(a) == 2
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    c = judged_frames({}, TRAFFIC, BIG_SEED + 1, 1.0)
    assert [x.shape for x in c] == [(72, 128, 3)] * 2
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))
    assert a[0].dtype == np.uint8


def test_dataset_reproducible_from_the_seed(tmp_path):
    def write(name, seed):
        return dataset.write_dataset(str(tmp_path / name), seed, 3,
                                     (72, 128), 3.0)
    one, two, other = write('a', BIG_SEED), write('b', BIG_SEED), \
        write('c', BIG_SEED + 1)
    assert [w['jpeg'] for w in one] == [w['jpeg'] for w in two]
    assert [w['shapes'] for w in one] == [w['shapes'] for w in two]
    assert [w['jpeg'] for w in one] != [w['jpeg'] for w in other]
    assert all(w['shapes'] for w in one)
