import os

# Smoke tests and benches must see the single real CPU device (the dry-run
# sets its own XLA_FLAGS in-process; never globally here).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


# lock construction sites the lock-order sanitizer should track: repo code
# only — stdlib Condition/Queue internals stay real locks (harmless for
# cycle detection but noisy, and patching them buys nothing)
_REPRO_LOCK_FILES = (
    "stripe_cache.py", "tectonic.py", "master.py", "worker.py",
    "service.py", "client.py", "prefetch.py", "tensor_cache.py",
    "dedup.py", "warehouse.py", "autoscale.py", "engine.py", "trainer.py",
    "embedding_cache.py",
)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "lockdep: run the test under the lock-order sanitizer "
        "(module-wide via `pytestmark = pytest.mark.lockdep`)")
    config.addinivalue_line(
        "markers",
        "raced: run the test under the lockset race detector")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (a CUDA kernel has no CPU mode); skips "
        "without one")


@pytest.fixture
def lockdep():
    """Opt-in lock-order sanitizer: every Lock/RLock a repro module builds
    during the test is tracked; teardown fails the test on any lock-order
    cycle (potential deadlock), with ordered acquisition stacks."""
    from repro.analysis import lockdep as ld

    with ld.patched(
        name_filter=lambda s: s.startswith(_REPRO_LOCK_FILES)
    ) as graph:
        yield graph
    graph.assert_no_cycles()


@pytest.fixture(autouse=True)
def _lockdep_marked(request):
    """Applies lockdep to every test carrying the `lockdep` marker (the
    whole of test_dpp.py / test_cache.py via module-level pytestmark)
    without double-patching tests that request the fixture explicitly."""
    if (request.node.get_closest_marker("lockdep") is None
            or "lockdep" in request.fixturenames):
        yield
        return
    from repro.analysis import lockdep as ld

    with ld.patched(
        name_filter=lambda s: s.startswith(_REPRO_LOCK_FILES)
    ) as graph:
        yield
    graph.assert_no_cycles()


@pytest.fixture
def raced():
    """Opt-in lockset race detector (sibling of `lockdep`): attribute
    accesses on the core threaded classes are tracked against the locks
    held at each access; teardown fails the test on any attribute shared
    across threads whose lockset intersection is empty."""
    from repro.analysis import lockdep as ld
    from repro.analysis import racedep as rd

    with ld.patched(
        name_filter=lambda s: s.startswith(_REPRO_LOCK_FILES)
    ) as graph:
        with rd.instrument(graph) as det:
            yield det
    det.assert_no_races()
    graph.assert_no_cycles()
