"""The port's token pipeline (a copy of ``repro/data/pipeline.py``) gives
the reference's batches bit for bit: from the start, after ``seek``
(O(1), counter-based), on other shards and seeds, and through the
iterator."""

import itertools

import numpy as np
import pytest

from repro.data import DataCursor as RCursor
from repro.data import TokenPipeline as RPipeline
from repro_torch.data import DataCursor, TokenPipeline


@pytest.mark.parametrize("vocab,seq,batch,seed", [(128, 16, 4, 0), (8192, 64, 2, 3),
                                                  (122753, 32, 2, 0)])
def test_batches_equal_the_references(vocab, seq, batch, seed):
    ours, theirs = TokenPipeline(vocab, seq, batch, seed=seed), RPipeline(vocab, seq, batch,
                                                                         seed=seed)
    for _ in range(5):
        (a, b), (c, d) = ours.next_batch(), theirs.next_batch()
        assert a.dtype == c.dtype == np.int32 and a.shape == (batch, seq)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    assert ours.cursor.as_dict() == theirs.cursor.as_dict() == {"step": 5, "shard": 0}


@pytest.mark.parametrize("shard", [0, 1, 3])
def test_seek_and_shards_equal_the_references(shard):
    ours = TokenPipeline(512, 24, 3, seed=7, n_shards=4, shard=shard)
    theirs = RPipeline(512, 24, 3, seed=7, n_shards=4, shard=shard)
    ours.seek(DataCursor.from_dict({"step": 11, "shard": shard}))
    theirs.seek(RCursor.from_dict({"step": 11, "shard": shard}))
    for (a, b), (c, d) in zip(itertools.islice(ours, 3), itertools.islice(theirs, 3)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    # seek is O(1) and exact: batch 12 read directly equals batch 12 read in order
    direct = TokenPipeline(512, 24, 3, seed=7, n_shards=4, shard=shard)
    direct.seek(DataCursor(step=12, shard=shard))
    fresh = TokenPipeline(512, 24, 3, seed=7, n_shards=4, shard=shard)
    for _ in range(12):
        fresh.next_batch()
    np.testing.assert_array_equal(direct.next_batch()[0], fresh.next_batch()[0])


def test_labels_are_inputs_shifted_and_shards_differ():
    pipe = TokenPipeline(128, 16, 4, seed=0)
    pipe.seek(DataCursor(step=2, shard=0))
    inputs, labels = pipe.next_batch()
    np.testing.assert_array_equal(inputs[:, 1:], labels[:, :-1])
    other = TokenPipeline(128, 16, 4, seed=0, shard=1)
    other.seek(DataCursor(step=2, shard=1))
    assert not np.array_equal(other.next_batch()[0], inputs)
