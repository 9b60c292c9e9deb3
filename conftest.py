"""Root test bootstrap.

* jax 0.9 moved ``jax.experimental.enable_x64`` to ``jax.enable_x64``;
  the reference package still imports the old name, so it is aliased here
  (only when missing) to a context manager over ``jax.enable_x64(True)``.
* Registers the ``gpu`` marker: tests that need a CUDA card decide inside
  their body whether one is present and skip otherwise.
"""
import contextlib


def _alias_enable_x64() -> None:
    try:
        import jax
        import jax.experimental as jexp
    except ImportError:
        return
    if hasattr(jexp, "enable_x64") or not hasattr(jax, "enable_x64"):
        return

    @contextlib.contextmanager
    def enable_x64():
        with jax.enable_x64(True):
            yield

    jexp.enable_x64 = enable_x64


_alias_enable_x64()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips with a reason without one")
