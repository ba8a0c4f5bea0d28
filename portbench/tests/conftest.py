"""The benchmark's CPU tests (python -m pytest portbench/tests). Tests that
need a CUDA card carry the `cuda` marker and skip here."""


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (skips without one)")
