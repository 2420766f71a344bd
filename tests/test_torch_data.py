"""The port's synthetic data stream against the JAX package's (CPU): the
same batches bit for bit for several (seed, index) pairs, on the device as
int32 tensors, and the stub frontends' host-side embeddings equal to the
reference ``sharded_batches``' on a one-device sharding, in float32 and in
bf16 (the same rounding of the same float32 draws)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.configs import ARCHS as JARCHS
from repro.data import pipeline as jpipe
from repro_torch.configs import ARCHS
from repro_torch.data import DataConfig, SyntheticLMDataset, sharded_batches

PAIRS = [(0, 0), (0, 5), (1, 0), (3, 17), (12345, 2)]


@pytest.mark.parametrize("seed,index", PAIRS)
def test_batches_bit_identical_to_reference(seed, index):
    kw = dict(vocab=97, seq_len=24, global_batch=3, seed=seed)
    ours = SyntheticLMDataset(DataConfig(**kw)).batch(index)
    ref = jpipe.SyntheticLMDataset(jpipe.DataConfig(**kw)).batch(index)
    for k in ("tokens", "labels"):
        assert ours[k].dtype == ref[k].dtype == np.int32
        np.testing.assert_array_equal(ours[k], ref[k])


def test_sharded_batches_on_device_from_start_index():
    ds = SyntheticLMDataset(DataConfig(vocab=64, seq_len=16, global_batch=2, seed=4))
    it = sharded_batches(ds, "cpu", start_index=3)
    for i in (3, 4):
        b = next(it)
        want = ds.batch(i)
        assert set(b) == {"tokens", "labels"}
        for k in b:
            assert b[k].dtype == torch.int32 and b[k].device.type == "cpu"
            np.testing.assert_array_equal(b[k].numpy(), want[k])


def test_data_deterministic_and_learnable():
    """The port's copy of the reference test: deterministic, next-token
    labels, and the bigram table predicts the stream."""
    dc = DataConfig(vocab=64, seq_len=32, global_batch=4, seed=1)
    b1, b2 = SyntheticLMDataset(dc).batch(5), SyntheticLMDataset(dc).batch(5)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    table = SyntheticLMDataset(dc).table
    assert (table[b1["tokens"]] == b1["labels"][..., None]).any(-1).mean() > 0.9


@pytest.mark.parametrize("name", ["musicgen-large", "pixtral-12b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stub_embeddings_match_reference(name, dtype):
    jcfg = dataclasses.replace(JARCHS[name].reduced(), compute_dtype=getattr(jax.numpy, dtype))
    tcfg = dataclasses.replace(ARCHS[name].reduced(), compute_dtype=getattr(torch, dtype))
    kw = dict(vocab=jcfg.vocab, seq_len=16, global_batch=2, seed=2)
    mesh = jax.make_mesh((1,), ("data",))
    rep = NamedSharding(mesh, P())
    ref = next(jpipe.sharded_batches(jpipe.SyntheticLMDataset(jpipe.DataConfig(**kw)),
                                     {"embeds": rep, "labels": rep}, start_index=1, embeds_cfg=jcfg))
    ours = next(sharded_batches(SyntheticLMDataset(DataConfig(**kw)), "cpu", start_index=1, embeds_cfg=tcfg))
    assert set(ours) == {"embeds", "labels"}
    assert ours["embeds"].dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(ours["embeds"].float().numpy(), np.asarray(ref["embeds"]).astype(np.float32))
    np.testing.assert_array_equal(ours["labels"].numpy(), np.asarray(ref["labels"]))


def test_sharded_batches_defaults_to_cuda():
    ds = SyntheticLMDataset(DataConfig(vocab=16, seq_len=4, global_batch=1))
    if torch.cuda.is_available():
        assert next(sharded_batches(ds))["tokens"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            sharded_batches(ds)
