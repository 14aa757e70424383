"""Port parity: the GPT data path (``fleetx_tpu_torch/data``).

The port's copies of the synthetic and memmap GPT datasets, the batch
samplers and the prefetching loader must yield exactly the JAX package's
samples, index mappings and batches: the same numpy code, so equality
is exact.
"""

import numpy as np
import pytest
import torch

from fleetx_tpu.data import build_dataloader as j_build_dataloader
from fleetx_tpu.data.dataset import gpt_dataset as JDS
from fleetx_tpu.data.sampler.batch_sampler import GPTBatchSampler as JSampler
from fleetx_tpu_torch.data import build_dataloader
from fleetx_tpu_torch.data.dataset import gpt_dataset as TDS
from fleetx_tpu_torch.data.sampler.batch_sampler import GPTBatchSampler

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """This file's tensors are tiny: torch runs them on one intra-op
    thread (its default pool, on cores the other test workers share,
    costs far more than the work). The count is restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

VOCAB, SEQ = 256, 128


def test_synthetic_dataset_and_sampler_match_jax():
    jds = JDS.SyntheticGPTDataset(num_samples=32, seq_length=SEQ,
                                  vocab_size=VOCAB, seed=11)
    tds = TDS.SyntheticGPTDataset(num_samples=32, seq_length=SEQ,
                                  vocab_size=VOCAB, seed=11)
    for i in (0, 5, 31):
        for k, v in jds[i].items():
            np.testing.assert_array_equal(tds[i][k], v)
    j_idx = list(JSampler(32, 4, consumed_samples=8))
    t_idx = list(GPTBatchSampler(32, 4, consumed_samples=8))
    assert t_idx == j_idx and len(t_idx) == 6


def test_gpt_dataset_index_mappings_and_samples_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    docs = [rng.randint(0, 300, size=rng.randint(5, 90)).tolist()
            for _ in range(40)]
    prefix = str(tmp_path / "corpus")
    JDS.write_corpus(prefix, docs)
    kw = dict(num_samples=60, seq_length=16, seed=3, eos_id=7)
    jds = JDS.GPTDataset(prefix, cache_dir=str(tmp_path / "j"), **kw)
    tds = TDS.GPTDataset(prefix, cache_dir=str(tmp_path / "t"), **kw)
    for a, b in ((jds.doc_idx, tds.doc_idx), (jds.sample_idx, tds.sample_idx),
                 (jds.shuffle_idx, tds.shuffle_idx)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    assert len(tds) == len(jds)
    for i in range(0, len(tds), 7):
        for k, v in jds[i].items():
            np.testing.assert_array_equal(tds[i][k], v)


def test_dataloader_batches_match_jax():
    data = {"Train": {"dataset": {"name": "SyntheticGPTDataset",
                                  "num_samples": 24},
                      "sampler": {"name": "GPTBatchSampler"},
                      "loader": {"batch_size": 4, "prefetch": 2}}}
    kw = dict(batch_size=4, seq_length=SEQ, vocab_size=VOCAB)
    j_batches = list(j_build_dataloader(data, "Train", **kw))
    t_batches = list(build_dataloader(data, "Train", **kw))
    assert len(t_batches) == len(j_batches) == 6
    for jb, tb in zip(j_batches, t_batches):
        for k, v in jb.items():
            np.testing.assert_array_equal(tb[k], v)
