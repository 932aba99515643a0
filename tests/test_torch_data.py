"""The port's synthetic LM stream against the reference's (ROADMAP A14b):
``SyntheticLM.batch_at`` bit for bit, whole batches and the per-host
slices, for several vocabularies, seeds and steps; and the reference's
data tests (``tests/test_train.py``) on the port."""
import numpy as np
import pytest

from repro.data.synthetic import SyntheticLM as RefSyntheticLM
from repro_torch.data.synthetic import SyntheticLM


@pytest.mark.parametrize("vocab,seq,batch,seed", [
    (64, 16, 8, 5), (256, 32, 8, 2), (151936, 64, 4, 0), (31, 8, 2, 7)])
def test_batches_equal_the_reference(vocab, seq, batch, seed):
    port = SyntheticLM(vocab=vocab, seq_len=seq, global_batch=batch,
                       seed=seed)
    ref = RefSyntheticLM(vocab=vocab, seq_len=seq, global_batch=batch,
                         seed=seed)
    assert (port.a, port.c) == (ref.a, ref.c)
    for step in (0, 1, 17, 2 ** 40 + 3):
        want = ref.batch_at(step)
        got = port.batch_at(step)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), (k, step)
        half = batch // 2
        for off in (0, half):
            w = ref.batch_at(step, batch=half, batch_offset=off)
            g = port.batch_at(step, batch=half, batch_offset=off)
            for k in w:
                assert np.array_equal(g[k], w[k]), (k, step, off)


def test_data_determinism_and_sharded_slices():
    d = SyntheticLM(vocab=64, seq_len=16, global_batch=8, seed=5)
    a = d.batch_at(3)
    b = d.batch_at(3)
    assert np.array_equal(a["tokens"], b["tokens"])
    c = d.batch_at(4)
    assert not np.array_equal(a["tokens"], c["tokens"])
    # per-host slicing reassembles to the global batch
    s0 = d.batch_at(3, batch=4, batch_offset=0)
    s1 = d.batch_at(3, batch=4, batch_offset=4)
    assert np.array_equal(np.concatenate([s0["tokens"], s1["tokens"]]),
                          a["tokens"])


def test_data_is_learnable_structure():
    """targets follow the affine rule ~(1-p_noise) of the time."""
    d = SyntheticLM(vocab=64, seq_len=128, global_batch=4, seed=6)
    b = d.batch_at(0)
    pred = (d.a * b["tokens"] + d.c) % d.vocab
    agreement = (pred == b["targets"]).mean()
    assert 0.7 < agreement <= 1.0
