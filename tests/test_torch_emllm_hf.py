"""EM-LLM's HF runner in hebo_tpu_torch (``emllm/hf_integration.py``) against
hebo_tpu's on the CPU.

``EMLLMRunner(device="cpu")`` and the JAX package's runner drive the same
seeded random-weight GPT-2 (tests/test_emllm_hf.py's; nothing is
downloaded) over tests/test_emllm_hf.py's three streams.  Tolerances: the
same ``nll_per_token`` within 1e-5 (float32 on both sides; the port's
episodic memory scores and segments with torch where the JAX package's
uses numpy and jnp), the same ``n_events`` and ``retrieved_per_chunk``,
and the same greedy ``generate`` tokens.  The JAX package's own runner
tests run on the port at their sizes.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("transformers")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The many small ops here run no faster on more threads, and the
    test run's other workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_gpt2():
    """tests/test_emllm_hf.py's seeded random GPT-2."""
    from transformers import GPT2Config, GPT2LMHeadModel

    torch.manual_seed(0)
    return GPT2LMHeadModel(GPT2Config(n_layer=2, n_head=4, n_embd=64, vocab_size=128, n_positions=512))


RUNNER_CASES = {  # tests/test_emllm_hf.py's three streams
    "long": (dict(chunk_size=48, event_len=24), lambda: np.random.default_rng(0).integers(0, 128, 300)),
    "per_layer": (dict(chunk_size=32, event_len=16), lambda: np.random.default_rng(1).integers(0, 128, 160)),
    "repeated": (dict(chunk_size=64, event_len=32, n_retrieve=3, n_contig=1),
                 lambda: np.tile(np.random.default_rng(2).integers(0, 128, 64), 3)),
}


@pytest.mark.parametrize("case", list(RUNNER_CASES))
def test_runner_as_reference(tiny_gpt2, case):
    from hebo_tpu.emllm.hf_integration import EMLLMRunner as JRunner
    from hebo_tpu_torch.emllm.hf_integration import EMLLMRunner

    kw, ids = RUNNER_CASES[case]
    jr, pr = JRunner(tiny_gpt2, **kw), EMLLMRunner(tiny_gpt2, device="cpu", **kw)
    want, got = jr.process(ids()), pr.process(ids())
    np.testing.assert_allclose(got["nll_per_token"], want["nll_per_token"], rtol=0, atol=1e-5)
    assert len(got["nll_per_token"]) == len(ids()) - int(np.ceil(len(ids()) / kw["chunk_size"]))
    assert got["n_events"] == want["n_events"] > 0
    assert got["retrieved_per_chunk"] == want["retrieved_per_chunk"]
    assert got["retrieved_per_chunk"][0] == 0 and any(r > 0 for r in got["retrieved_per_chunk"][1:])
    assert len({len(m) for m in pr.memories}) == 1
    q = ids()[:8]
    assert pr.generate(q, n_new=4) == jr.generate(q, n_new=4)
    assert pr.generate(q, n_new=2, pos0=40) == jr.generate(q, n_new=2, pos0=40)


def test_retrieval_changes_predictions(tiny_gpt2):
    """tests/test_emllm_hf.py::test_retrieval_changes_predictions on the
    port: the injected KV changes the later chunks' predictions."""
    from hebo_tpu_torch.emllm.hf_integration import EMLLMRunner

    kw, ids = RUNNER_CASES["repeated"]
    out_mem = EMLLMRunner(tiny_gpt2, device="cpu", **kw).process(ids())
    out_no = EMLLMRunner(tiny_gpt2, device="cpu", **dict(kw, n_retrieve=0, n_contig=0)).process(ids())
    a, b = out_mem["nll_per_token"][-60:], out_no["nll_per_token"][-60:]
    assert np.all(np.isfinite(a)) and np.all(np.isfinite(b))
    assert not np.allclose(a, b)
