"""The benchmark's tests: ``cuda`` marks a test that needs the card; it
decides inside the test whether one is there, and skips here."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without one)")
