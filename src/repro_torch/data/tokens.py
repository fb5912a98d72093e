"""Synthetic LM token pipeline (port of ``repro.data.tokens``).

A first-order Markov stream over a Zipf-distributed vocabulary gives
the LM something learnable (bigram structure) without a downloaded
corpus.  numpy, as the reference's: the same seed gives the same
tokens and batches bit for bit; batches come out as int32 tensors.
"""
from __future__ import annotations

import bisect
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def synthetic_token_stream(vocab_size: int, length: int, seed: int = 0,
                           n_states: int = 64) -> np.ndarray:
    """Markov chain over ``n_states`` latent states, each emitting a
    Zipf slice of the vocabulary."""
    rng = np.random.default_rng(seed)
    trans = rng.dirichlet(np.ones(n_states) * 0.1, size=n_states)
    # each state emits from a contiguous vocab slice, Zipf-weighted
    slice_size = max(vocab_size // n_states, 1)
    ranks = np.arange(1, slice_size + 1)
    zipf = (1.0 / ranks) / (1.0 / ranks).sum()
    # rng.choice(n_states, p=trans[s]) at each step, unrolled: it draws
    # one double and finds it in the row's normalised cumulative sum,
    # so the same draws give the same states, bit for bit
    cdf = np.cumsum(trans, axis=1)
    cdf /= cdf[:, -1:]
    rows = cdf.tolist()
    u = rng.random(length).tolist()
    states = np.zeros(length, np.int64)
    s = 0
    for t in range(length):
        states[t] = s
        s = bisect.bisect_right(rows[s], u[t])
    offs = (states * slice_size) % max(vocab_size - slice_size, 1)
    tok = offs + rng.choice(slice_size, size=length, p=zipf)
    return tok.astype(np.int32)


def lm_batch_iterator(tokens: np.ndarray, batch_size: int, seq_len: int,
                      seed: int = 0, device: DeviceLike = None
                      ) -> Iterator[Dict[str, torch.Tensor]]:
    """Yields {tokens: (B, S), labels: (B, S)} next-token batches on
    ``device`` (the card unless named)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = tokens.shape[0] - seq_len - 1
    while True:
        starts = rng.integers(0, n, size=(batch_size,))
        xs = np.stack([tokens[s:s + seq_len] for s in starts])
        ys = np.stack([tokens[s + 1:s + seq_len + 1] for s in starts])
        yield {"tokens": torch.from_numpy(xs).to(dev),
               "labels": torch.from_numpy(ys).to(dev)}
