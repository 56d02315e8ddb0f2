"""No module a run loads has jax, jaxlib, flax or masklab_tpu as its
top-level name (compared whole: the port's name begins with the JAX
package's), and the reference imports nothing of the program."""
import json
import os
import subprocess
import sys

from perfbench.harness import env, spec


def _loaded(code: str) -> list:
    out = subprocess.run([sys.executable, '-c', code], cwd=spec.ROOT,
                         capture_output=True, text=True, check=True,
                         env=dict(os.environ, PYTHONPATH=spec.ROOT))
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_whole_names_compared():
    assert env.forbidden_modules(['masklab_tpu_torch.models', 'jaxtyping',
                                  'flaxen']) == []
    assert env.forbidden_modules(['masklab_tpu.config', 'jax.numpy',
                                  'flax', 'jaxlib.xla']) == [
        'flax', 'jax.numpy', 'jaxlib.xla', 'masklab_tpu.config']


def test_run_modules_load_no_jax():
    found = _loaded(
        'import json, sys\n'
        'from perfbench.harness import main, env, trace, readings\n'
        'from perfbench.harness import device_spans\n'
        'from perfbench.drivers import batch_predict, trainer\n'
        'from perfbench.reference import control, judge, train\n'
        'from perfbench.tools import control, faults, spread, witness\n'
        'from perfbench.tools import body_swap\n'
        'import masklab_tpu_torch.serving.predictor\n'
        'import masklab_tpu_torch.train, masklab_tpu_torch.data\n'
        'print(json.dumps(env.forbidden_modules()))')
    assert found == []


def test_reference_imports_nothing_of_the_program():
    found = _loaded(
        'import json, sys\n'
        'from perfbench.reference import pipeline, judge, control, train\n'
        'from perfbench.reference import roofline\n'
        'print(json.dumps(sorted(m for m in sys.modules\n'
        '    if m.split(".")[0] in ("masklab_tpu_torch", "masklab_tpu",\n'
        '                           "jax", "flax"))))')
    assert found == []
