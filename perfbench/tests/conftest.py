"""The benchmark's own tests (``python -m pytest perfbench/tests``): the
CPU ones at small sizes; the ``gpu`` ones run the control at a cell's own
size and skip, inside a fixture, where no card is present."""
import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line('markers', 'gpu: needs a CUDA card')


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('no CUDA card: the control runs at the cell\'s size on '
                    'the card')
    return 'cuda'


@pytest.fixture(autouse=True, scope='session')
def few_threads():
    torch.set_num_threads(4)
