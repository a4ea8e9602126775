"""Pytest configuration.

Tests run on the CPU with 8 virtual devices, so multi-device sharding logic
is exercised without accelerators (mirrors the reference's config-driven
CUDA-on/off test gating, test_CalcSol.py:15-33, replaced here by a platform
default).  Tests marked ``chip`` need a GPU and skip elsewhere; run them on
the card with ``JAX_PLATFORMS=cuda python -m pytest -m chip tests/``.
"""

import os
import sys

# Must happen before jax is imported anywhere.
os.environ.setdefault('JAX_PLATFORMS', 'cpu')
_flags = os.environ.get('XLA_FLAGS', '')
if 'xla_force_host_platform_device_count' not in _flags:
    os.environ['XLA_FLAGS'] = (
        _flags + ' --xla_force_host_platform_device_count=8').strip()

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)
os.chdir(REPO_ROOT)  # data files are addressed repo-relative, as in reference

import pytest  # noqa: E402

from parasitoids_tpu.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()


def pytest_addoption(parser):
    parser.addoption('--runslow', action='store_true', help='run slow tests')


def pytest_collection_modifyitems(config, items):
    if config.getoption('--runslow'):
        return
    skip_slow = pytest.mark.skip(reason='need --runslow option to run')
    for item in items:
        if 'slow' in item.keywords:
            item.add_marker(skip_slow)


def pytest_configure(config):
    config.addinivalue_line('markers', 'slow: mark test as slow to run')
    config.addinivalue_line(
        'markers', 'chip: needs a GPU (request the ``gpu`` fixture); skips '
                   'elsewhere')


@pytest.fixture(scope='session')
def gpu():
    """The first JAX device when it is a GPU; skips the test otherwise.
    Decided here, at run time, never while a module is imported: every
    xdist worker must collect the same tests."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        pytest.skip('needs a GPU; JAX found {}'.format(dev.platform))
    return dev


@pytest.fixture(scope='session')
def params():
    from parasitoids_tpu.config import Params
    p = Params()
    p.OUTPUT = False
    p.PLOT = False
    return p


@pytest.fixture(scope='session')
def domain_info():
    # (dist from center to side in m, cells from center to side)
    return (8000.0, 320)
