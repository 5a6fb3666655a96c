"""Test helpers (the JAX package's ``utils/testing.py``)."""

__all__ = ["requires_device"]


def requires_device(device_type):
    """Skip marker for a test that needs a device of ``device_type``
    (``"cuda"`` or ``"cpu"``, as torch names them; ``"gpu"`` is taken as
    ``"cuda"``)."""
    import pytest
    import torch

    device_type = {"gpu": "cuda"}.get(device_type, device_type)
    available = {"cpu"} | ({"cuda"} if torch.cuda.is_available() else set())
    return pytest.mark.skipif(device_type not in available,
                              reason=f"Missing support for device "
                                     f"{device_type}")
