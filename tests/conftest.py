import os
import sys

# Tests run on the single host device (the dry-run, and only the dry-run,
# forces 512 host devices — see launch/dryrun.py).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without one")
