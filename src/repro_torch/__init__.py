"""PyTorch and CUDA port of ``repro``'s serving path.

It imports ``torch`` and numpy only, never ``jax`` and nothing of
``repro``; ``repro`` stays the reference the tests hold it against.
"""
