"""PyTorch and CUDA port of ``repro``: its serving path and its caching
federation (``repro_torch.core``), with the simulator's max-min solver on
the card.

It imports ``torch`` and numpy only, never ``jax`` and nothing of
``repro``; ``repro`` stays the reference the tests hold it against.
"""
