"""Test configuration: run everything on a virtual 8-device CPU platform.

Sharding paths are validated on a host-platform device mesh, and the Pallas
kernels run in interpret mode, which is switched on here explicitly. Set
FA_TEST_PLATFORM=gpu to run the suite on the card instead (kernels then
compile for the GPU); tests marked ``gpu`` run only there.
"""

import os

import pytest

# Must be appended before the first CPU backend initialization.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

from flash_attention_tpu.ops.common import set_interpret_default  # noqa: E402

_PLATFORM = os.environ.get("FA_TEST_PLATFORM", "cpu")
jax.config.update("jax_platforms", _PLATFORM)
jax.config.update("jax_enable_x64", False)
set_interpret_default(_PLATFORM != "gpu")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none."""
    devices = [d for d in jax.devices() if d.platform == "gpu"]
    if not devices:
        pytest.skip("needs an NVIDIA GPU (run with FA_TEST_PLATFORM=gpu)")
    return devices[0]
