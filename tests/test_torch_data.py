"""repro_torch.data.libsvm against repro.data.libsvm: byte-identical data."""
import numpy as np
import pytest
import torch

from repro.data import libsvm as jlib
from repro_torch.data import libsvm as plib


@pytest.mark.parametrize("name", ["rcv1", "real-sim", "news20"])
def test_synthetic_bytes_identical(name):
    a = jlib.make_synthetic_libsvm(name, seed=3, scale=0.005)
    b = plib.make_synthetic_libsvm(name, seed=3, scale=0.005)
    assert a.X.dtype == b.X.dtype == np.float32
    assert a.X.tobytes() == b.X.tobytes()
    assert a.y.tobytes() == b.y.tobytes()
    assert (a.name, a.l2_reg, a.n, a.p) == (b.name, b.l2_reg, b.n, b.p)
    X, y = b.as_torch("cpu")
    assert X.dtype == torch.float32 and np.array_equal(X.numpy(), b.X)
    assert np.array_equal(y.numpy(), b.y)


def test_parse_libsvm_file_matches(tmp_path):
    path = tmp_path / "tiny.libsvm"
    path.write_text("+1 1:0.5 3:-2\n\n-1 2:1.25 9:4\n0 1:1\n")
    a = jlib.parse_libsvm_file(str(path), num_features=4)
    b = plib.parse_libsvm_file(str(path), num_features=4)
    assert np.array_equal(a.X, b.X) and np.array_equal(a.y, b.y)
    assert b.X.shape == (3, 4) and b.y.tolist() == [1.0, -1.0, -1.0]


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_lm_batches_equal_jax_bit_for_bit(seed):
    """`SyntheticLMDataset.batch_at` at 3 steps and 2 shards (and the
    unsharded batch) against the JAX package's."""
    from repro.data.synthetic_lm import SyntheticLMDataset as Jax
    from repro_torch.data import SyntheticLMDataset
    for shards in (1, 2):
        for shard in range(shards):
            a = Jax(97, 24, 6, seed=seed, shard_index=shard,
                    num_shards=shards)
            b = SyntheticLMDataset(97, 24, 6, seed=seed, shard_index=shard,
                                   num_shards=shards)
            for step in (0, 1, 5):
                want, got = a.batch_at(step), b.batch_at(step)
                assert sorted(got) == sorted(want)
                for key in want:
                    assert got[key].dtype == want[key].dtype
                    assert got[key].shape == (6 // shards, 24)
                    assert got[key].tobytes() == want[key].tobytes(), key
    with pytest.raises(ValueError, match="shards"):
        SyntheticLMDataset(97, 24, 6, num_shards=4)
