"""The port's synthetic data pipeline against the reference's: byte-identical batches.

``repro_torch.data.pipeline`` is a numpy-only copy of
``src/repro/data/pipeline.py``; the two must give the same bytes for every
(seed, step, rank) address, so that a run in either framework sees the same data.
"""

import numpy as np
import pytest

from repro.data.pipeline import ShardedPipeline as JaxShardedPipeline
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro_torch.data import ShardedPipeline, SyntheticLM

GENS = {
    "launcher": dict(vocab_size=512, seq_len=128, period=16, vocab_eff=256),
    "gemma2-vocab": dict(vocab_size=256000, seq_len=2048, seed=7, period=16, vocab_eff=256),
    "defaults-ragged-period": dict(vocab_size=1000, seq_len=100, seed=3),
}


@pytest.mark.parametrize("name", sorted(GENS))
def test_samples_are_byte_identical(name):
    ours, ref = SyntheticLM(**GENS[name]), JaxSyntheticLM(**GENS[name])
    for step in range(3):
        for row in range(3):
            a, b = ours.sample(step, row), ref.sample(step, row)
            assert a.dtype == b.dtype == np.int32 and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("dp_size", [1, 2, 4])
def test_sharded_batches_are_byte_identical_over_steps_and_ranks(dp_size):
    gen = dict(vocab_size=512, seq_len=64, seed=1, period=16, vocab_eff=256)
    for rank in range(dp_size):
        ours = ShardedPipeline(SyntheticLM(**gen), global_batch=8, dp_rank=rank, dp_size=dp_size)
        ref = JaxShardedPipeline(JaxSyntheticLM(**gen), global_batch=8, dp_rank=rank, dp_size=dp_size)
        for step in (0, 1, 5):
            a, b = ours.batch_at(step), ref.batch_at(step)
            assert sorted(a) == sorted(b) == ["targets", "tokens"]
            for key in a:
                assert a[key].shape == (8 // dp_size, 64) and a[key].tobytes() == b[key].tobytes()
            np.testing.assert_array_equal(a["tokens"][:, 1:], a["targets"][:, :-1])


def test_reshard_readdresses_the_same_stream():
    gen = dict(vocab_size=512, seq_len=32, period=16, vocab_eff=256)
    ours = ShardedPipeline(SyntheticLM(**gen), global_batch=4)
    ref = JaxShardedPipeline(JaxSyntheticLM(**gen), global_batch=4)
    whole = ours.batch_at(2)["tokens"]
    halves = [ours.reshard(r, 2).batch_at(2)["tokens"] for r in range(2)]
    np.testing.assert_array_equal(np.concatenate(halves), whole)
    for r in range(4):
        assert ours.reshard(r, 4).batch_at(3)["tokens"].tobytes() == ref.reshard(r, 4).batch_at(3)["tokens"].tobytes()


def test_iteration_walks_the_steps():
    pipe = ShardedPipeline(SyntheticLM(vocab_size=64, seq_len=16), global_batch=2)
    it = iter(pipe)
    for step in range(3):
        assert next(it)["tokens"].tobytes() == pipe.batch_at(step)["tokens"].tobytes()


def test_global_batch_must_split_over_ranks():
    with pytest.raises(ValueError):
        ShardedPipeline(SyntheticLM(vocab_size=64, seq_len=16), global_batch=6, dp_size=4)
