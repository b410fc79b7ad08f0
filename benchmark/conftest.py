"""pytest settings of the benchmark's own tests (`python3 -m pytest benchmark/tests`)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; the test decides inside itself and skips without one")
