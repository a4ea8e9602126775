"""bench.py contract pieces that must never regress: ONE parseable JSON
line within its budget on a GPU, and no result at all without one (a CPU
number is never a device metric).

These tests exercise the budget/forensics helpers and the device check
WITHOUT any measure() call.
"""

import importlib.util
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_bench():
    spec = importlib.util.spec_from_file_location(
        'bench_under_test', os.path.join(REPO, 'bench.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_child_subprocess_failure_reasons():
    bench = _load_bench()
    # no budget left -> explicit reason, not a silent null
    assert bench._child_subprocess('--child-am', 0) == 'failed(no budget)'
    r = bench._child_subprocess('--no-such-mode', 30)
    # an unknown mode runs main() without a child flag; whatever happens,
    # the caller gets either a dict or a 'failed(...)' string — never None
    assert isinstance(r, (dict, str))
    if isinstance(r, str):
        assert r.startswith('failed(')


def test_estimate_forward_flops_scales():
    bench = _load_bench()

    class K:
        K, K_local, G = 44, 20, 16

    class S:
        fft_len = 1280

    class P:
        interp_num = 30

    one = bench.estimate_forward_flops(P, K, S, 1)
    many = bench.estimate_forward_flops(P, K, S, 18)
    assert one > 0
    assert many == pytest.approx(18 * one)
    # the headline config lands in the documented ballpark (~2.4 GFLOP/day)
    assert 1e9 < one < 1e10


def test_bench_refuses_without_gpu():
    """No GPU, no result: the headline child finds the CPU and exits, and
    the bench exits non-zero without printing a JSON record."""
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    r = subprocess.run([sys.executable, os.path.join(REPO, 'bench.py')],
                       capture_output=True, text=True, timeout=240,
                       env=env, cwd=REPO)
    assert r.returncode != 0
    assert r.stdout.strip() == ''
    assert 'measures a GPU; JAX found cpu' in r.stderr


def test_peak_table_keyed_by_device_kind():
    bench = _load_bench()
    assert bench.peak_f32_tflops('NVIDIA H100 80GB HBM3') == 67.0
    with pytest.raises(KeyError, match='no f32 peak on record'):
        bench.peak_f32_tflops('Unknown Card 9000')
