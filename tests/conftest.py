import pytest

try:  # optional dep: property tests importorskip hypothesis themselves
    import hypothesis

    # "ci" profile: bounded examples, no deadline flake, and derandomized —
    # a pinned seed derived from each test, so CI runs are reproducible.
    # CI selects it explicitly with --hypothesis-profile=ci (the plugin
    # applies the flag in pytest_configure, after this import, so it wins).
    hypothesis.settings.register_profile(
        "ci", deadline=None, max_examples=20, derandomize=True
    )
    # "dev" (local default): same bounds but RANDOMIZED, so repeated local
    # runs keep exploring fresh inputs.  deadline=None — jit compiles
    # inside examples blow any per-example deadline on CPU.
    hypothesis.settings.register_profile("dev", deadline=None, max_examples=20)
    hypothesis.settings.load_profile("dev")
except ImportError:  # pragma: no cover
    pass


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running (512-device dry-run) tests")
    config.addinivalue_line(
        "markers",
        "no_leak_check: skip the autouse PagedEngine page-leak audit "
        "(for tests that corrupt engine state on purpose)",
    )
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (a CUDA kernel has no interpret mode); skips without one"
    )


@pytest.fixture(autouse=True)
def _paged_engine_leak_check(request):
    """Every PagedEngine built during a test must END the test with clean
    page-ownership invariants — zero leaked pages, refcounts matching
    block-table references, a consistent prefix chain (serving/audit.py).
    This turns every engine test in the suite into a leak regression test
    for every error path it happens to exercise."""
    try:
        from repro.serving.audit import audit_engine
        from repro.serving.engine import PagedEngine
        from repro.serving.state_engine import StatePagedEngine
    except Exception:  # pragma: no cover - serving deps unavailable
        yield
        return
    engines = []
    # StatePagedEngine defines its own __init__ (it never chains to
    # PagedEngine.__init__), so both constructors must be wrapped.
    originals = []
    for klass in (PagedEngine, StatePagedEngine):
        orig_init = klass.__init__

        def tracking_init(self, *args, __orig=orig_init, **kwargs):
            __orig(self, *args, **kwargs)
            engines.append(self)

        originals.append((klass, orig_init))
        klass.__init__ = tracking_init
    try:
        yield
    finally:
        for klass, orig_init in originals:
            klass.__init__ = orig_init
    if request.node.get_closest_marker("no_leak_check"):
        return
    for eng in engines:
        # a pipelined engine must end every test drained: an in-flight
        # decode launch at teardown means tokens were silently dropped
        assert len(eng._inflight) == 0, (
            f"PagedEngine left {len(eng._inflight)} decode launch(es) "
            f"in flight at test teardown (missing drain()?)"
        )
        report = audit_engine(eng)
        assert report.ok, (
            f"PagedEngine left dirty page-ownership state at test teardown: "
            f"{report.violations}"
        )


def pytest_collection_modifyitems(config, items):
    if config.getoption("-m"):
        return
    skip = pytest.mark.skip(reason="slow; run with -m slow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
