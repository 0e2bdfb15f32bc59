def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips, with its reason, on a machine without one "
        "(run on the chip: python -m pytest -q -m card perfbench/tests)")
