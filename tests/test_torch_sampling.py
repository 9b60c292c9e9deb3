"""Sampling with ``greedy=False`` is held to the float32 softmax.

The port draws with ``torch.multinomial`` and the reference with
``jax.random.categorical``, so their token streams cannot match; what
both must do is draw each token with its softmax probability.  At fixed
logits over 32 tokens, 20,000 draws with a seeded generator on the CPU
must fit the f32 softmax by Pearson's chi-square test: the statistic
must stay under 83.64, the 1 - 1e-6 quantile of chi-square with 31
degrees of freedom (``scipy.stats.chi2.ppf(1 - 1e-6, 31)``), so a right
sampler fails it once in a million seeds.  A control holds the same
draws to the softmax of perturbed logits, which must fail the bound.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.serve import ServeEngine

VOCAB = 32
DRAWS = 20_000
CHI2_BOUND = 83.64          # chi2.ppf(1 - 1e-6, df=31)


def chi_square(tokens: np.ndarray, probs: np.ndarray) -> float:
    seen = np.bincount(tokens, minlength=len(probs))
    expected = DRAWS * probs
    return float(((seen - expected) ** 2 / expected).sum())


@pytest.fixture(scope="module")
def draws():
    rng = np.random.default_rng(0)
    logits = rng.normal(0.0, 1.0, VOCAB).astype(np.float32)
    sampler = types.SimpleNamespace(
        greedy=False, generator=torch.Generator().manual_seed(1234))
    batch = torch.from_numpy(np.tile(logits, (DRAWS, 1)))
    tokens = ServeEngine._sample(sampler, batch)
    assert tokens.shape == (DRAWS,)
    return logits, tokens, rng


def _softmax(logits: np.ndarray) -> np.ndarray:
    return torch.softmax(torch.from_numpy(logits).float(), -1) \
        .double().numpy()


def test_sampled_frequencies_fit_the_softmax(draws):
    logits, tokens, _ = draws
    probs = _softmax(logits)
    assert probs.min() * DRAWS > 50           # every cell is well filled
    assert chi_square(tokens, probs) < CHI2_BOUND


def test_control_with_perturbed_logits_fails(draws):
    logits, tokens, rng = draws
    perturbed = logits + rng.normal(0.0, 0.25, VOCAB).astype(np.float32)
    assert chi_square(tokens, _softmax(perturbed)) > CHI2_BOUND
