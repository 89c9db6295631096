"""The port's synthetic token pipeline against the reference's: the same
batches bit for bit across seeds, steps and shards, and from a resumed
iterator; plus the reference's own properties (shards partition the
global batch, motifs give learnable structure)."""

import numpy as np
import pytest

from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticTokenPipeline as JPipeline
from repro_torch.data import DataConfig, SyntheticTokenPipeline


@pytest.mark.parametrize("seed,vocab,seq,batch,shards", [
    (0, 512, 64, 4, 1), (7, 256, 33, 8, 4), (3, 49152, 128, 2, 2)])
def test_batches_equal_the_reference(seed, vocab, seq, batch, shards):
    for shard in range(shards):
        kw = dict(vocab=vocab, seq_len=seq, global_batch=batch, seed=seed,
                  n_shards=shards, shard=shard)
        mine, ref = SyntheticTokenPipeline(DataConfig(**kw)), JPipeline(
            JDataConfig(**kw))
        for step in (0, 1, 13):
            got, want = mine.batch(step)["tokens"], ref.batch(step)["tokens"]
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want)


def test_resume_reproduces_the_reference_stream():
    kw = dict(vocab=128, seq_len=16, global_batch=2)
    it = SyntheticTokenPipeline(DataConfig(**kw)).iterate(start_step=42)
    ref = JPipeline(JDataConfig(**kw))
    for step in range(42, 45):
        np.testing.assert_array_equal(next(it)["tokens"],
                                      ref.batch(step)["tokens"])


def test_shards_partition_global_batch():
    full = SyntheticTokenPipeline(DataConfig(vocab=256, seq_len=32,
                                             global_batch=8, seed=3))
    parts = [SyntheticTokenPipeline(DataConfig(
        vocab=256, seq_len=32, global_batch=8, seed=3, n_shards=4, shard=i))
        for i in range(4)]
    got = np.concatenate([p.batch(5)["tokens"] for p in parts])
    np.testing.assert_array_equal(got, full.batch(5)["tokens"])


def test_learnable_structure():
    p = SyntheticTokenPipeline(DataConfig(vocab=64, seq_len=2048,
                                          global_batch=2))
    toks = p.batch(0)["tokens"].reshape(-1)
    pairs = toks[:-1] * 64 + toks[1:]
    _, counts = np.unique(pairs, return_counts=True)
    probs = counts / counts.sum()
    assert -(probs * np.log2(probs)).sum() < 11.0


def test_uneven_shards_are_refused():
    with pytest.raises(AssertionError, match="divide"):
        SyntheticTokenPipeline(DataConfig(vocab=8, seq_len=8, global_batch=3,
                                          n_shards=2))
