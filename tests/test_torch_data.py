"""Port parity: the synthetic-LM data pipeline (``repro_torch.data``)
against the reference's (``repro.data``).

Both draw from numpy's ``default_rng((seed, step))``, so every batch is
byte-equal (the same arrays, dtypes and bytes) for the plain, ``embed_dim``
and ``dec_len`` forms; shards tile the batch; the prefetcher hands out
steps in order and stops its thread on ``close``.
"""
import numpy as np
import pytest
import torch

from repro.data import SyntheticLM as JSyntheticLM
from repro_torch.data import Prefetcher, SyntheticLM, make_batch_iterator

torch.set_num_threads(2)

FORMS = {"plain": {}, "embed": {"embed_dim": 24},
         "encdec": {"embed_dim": 16, "dec_len": 8}}


def _assert_bytes_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("seed", [0, 5])
def test_batches_are_byte_equal_to_reference(form, seed):
    kw = dict(vocab=300, seq_len=40, global_batch=6, seed=seed,
              **FORMS[form])
    ours, theirs = SyntheticLM(**kw), JSyntheticLM(**kw)
    for step in (0, 1, 17):
        _assert_bytes_equal(ours.batch_at(step), theirs.batch_at(step))


@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_shards_tile_the_batch_as_the_reference_cuts_them(n_shards):
    kw = dict(vocab=64, seq_len=8, global_batch=8, seed=1, embed_dim=4)
    ours, theirs = SyntheticLM(**kw), JSyntheticLM(**kw)
    full = ours.batch_at(5)
    parts = [ours.shard_at(5, i, n_shards) for i in range(n_shards)]
    for k in full:
        np.testing.assert_array_equal(
            np.concatenate([p[k] for p in parts]), full[k])
    for i in range(n_shards):
        _assert_bytes_equal(parts[i], theirs.shard_at(5, i, n_shards))


def test_labels_are_the_next_token():
    b = SyntheticLM(vocab=128, seq_len=16, global_batch=4, seed=3,
                    dec_len=8).batch_at(2)
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert b["tokens"].shape == (4, 8)


def test_prefetcher_hands_out_steps_in_order_and_closes():
    src = SyntheticLM(vocab=64, seq_len=8, global_batch=4, seed=0)
    pf = Prefetcher(src.batch_at, start_step=3, depth=2)
    try:
        got = [pf.next() for _ in range(5)]
    finally:
        pf.close()
    assert not pf._thread.is_alive()
    assert [s for s, _ in got] == [3, 4, 5, 6, 7]
    for s, b in got:
        _assert_bytes_equal(b, src.batch_at(s))


def test_batch_iterator_resumes_at_its_start_step():
    src = SyntheticLM(vocab=64, seq_len=8, global_batch=2, seed=4)
    it = make_batch_iterator(src, start_step=10, prefetch=1)
    try:
        steps = [next(it) for _ in range(3)]
    finally:
        it.close()
    assert [s for s, _ in steps] == [10, 11, 12]
    _assert_bytes_equal(steps[2][1], JSyntheticLM(
        vocab=64, seq_len=8, global_batch=2, seed=4).batch_at(12))
