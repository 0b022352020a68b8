"""Test configuration.

Unit tests run on the CPU backend with 8 virtual devices so that sharding
/ multi-device code paths are exercised without an accelerator. These env
vars must be set before JAX is first imported, which is why they live
here; subprocesses the tests start inherit them.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
