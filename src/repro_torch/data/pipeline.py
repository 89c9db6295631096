"""Deterministic, index-sharded, resumable synthetic token pipeline (the
port's copy of ``repro.data.pipeline``, numpy only; the draws are the
reference's in the same order, so both packages give the same batches bit
for bit for every (seed, step, shard)).

Properties a production loader needs and this one has:
  * deterministic function of (seed, step, shard) — restart-safe: resuming
    from a checkpoint at step k regenerates exactly the batches k, k+1, ...;
  * index-sharded: each data-parallel host pulls only its slice, no host ever
    materializes the global batch;
  * stateless iteration (the "state" is the integer step in the checkpoint).

The token stream is a mixture of Zipfian unigrams and short Markov motifs so
small-model training has learnable structure
instead of uniform noise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1          # data-parallel host count
    shard: int = 0             # this host's index
    zipf_a: float = 1.2
    motif_len: int = 8
    n_motifs: int = 256


class SyntheticTokenPipeline:
    """batch(step) -> {'tokens': (local_batch, seq_len) int32} deterministic."""

    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.n_shards == 0, (
            "global batch must divide across data shards")
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.n_shards
        base = np.random.default_rng(cfg.seed)
        # fixed motif table: short token sequences the model can learn
        self._motifs = base.integers(
            0, cfg.vocab, (cfg.n_motifs, cfg.motif_len), dtype=np.int32)
        # Zipf-ish unigram distribution over the vocab
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = 1.0 / ranks ** cfg.zipf_a
        self._unigram = p / p.sum()

    def _rng(self, step: int, row: int) -> np.random.Generator:
        # independent stream per (seed, step, global row) — shard-invariant
        return np.random.default_rng(
            (self.cfg.seed, step, row))

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rows = range(cfg.shard * self.local_batch,
                     (cfg.shard + 1) * self.local_batch)
        out = np.empty((self.local_batch, cfg.seq_len), np.int32)
        for i, row in enumerate(rows):
            rng = self._rng(step, row)
            seq = rng.choice(cfg.vocab, size=cfg.seq_len,
                             p=self._unigram).astype(np.int32)
            # overwrite random spans with motifs (learnable bigram structure)
            n_spans = cfg.seq_len // (2 * cfg.motif_len)
            starts = rng.integers(0, cfg.seq_len - cfg.motif_len, n_spans)
            which = rng.integers(0, cfg.n_motifs, n_spans)
            for s, w in zip(starts, which):
                seq[s:s + cfg.motif_len] = self._motifs[w]
            out[i] = seq
        return {"tokens": out}

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1
