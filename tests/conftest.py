"""Shared test helpers."""


def has_host_memory() -> bool:
    """True when the backend exposes the pinned_host memory kind (real
    two-tier placement); CPU jaxlibs without it skip the physical-move
    tests."""
    try:
        import jax

        kinds = [m.kind for m in jax.devices()[0].addressable_memories()]
        return "pinned_host" in kinds
    except (ImportError, AttributeError, RuntimeError, IndexError,
            NotImplementedError):
        return False


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device (the port's kernels); skips without one")
