import os
import sys

# Run JAX on CPU with a virtual 8-device mesh for sharding tests, unless the
# caller explicitly asked for a real platform.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest

DATA_DIRS = [
    "/root/reference/src/pyrodigal/tests/data",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "data"),
]


def data_path(name):
    for d in DATA_DIRS:
        p = os.path.join(d, name)
        if os.path.exists(p):
            return p
    pytest.skip(f"test data file {name} not available")


@pytest.fixture(scope="session")
def data():
    return data_path
