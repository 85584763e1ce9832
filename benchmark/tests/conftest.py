"""The benchmark's CPU tests (``python -m pytest benchmark/tests``)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips where there is none")
