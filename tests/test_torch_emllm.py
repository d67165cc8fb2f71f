"""EM-LLM's episodic memory in hebo_tpu_torch (``emllm/*``) against hebo_tpu
on the CPU.

The same numpy-seeded inputs go through both packages (float32 on both
sides).  Tolerances:
* ``surprise_boundaries``: equal; ``_modularity_gain``: within 1e-6
  relative to the larger of its two terms (intra-event similarity and its
  expectation, which the gain cancels);
* ``refine_boundaries`` / ``segment_events`` on the JAX tests' inputs and 4
  more seeds: equal spans.  The one exception allowed is a boundary where
  the two packages pick another candidate while the port's top two scores
  lie within 1e-6 relative (a float32 tie, rounding and not a fault); the
  test counts such boundaries, and on these inputs there are none;
* the memory: ``add_events`` gives equal K / V buffers, lens and the same
  representatives; ``retrieve`` in both modes the same ids, ``gather_kv``
  equal values;
* ``masked_attention`` within 1e-5 of the largest |output| (a fully masked
  key set gives the mean of V); ``EMLLMAttention`` on
  tests/test_emllm.py's stream: the same event count, the output within
  1e-5;
* ``retrieve_sharded`` at world 1 in this process and at worlds 2 and 4 on
  gloo ranks (tests/test_torch_mesh.py's ``spawn``): the JAX function's
  indices on its virtual CPU mesh of as many devices.  The data are
  tie-free (``lax.top_k`` breaks ties to the lower index, ``torch.topk``
  promises no order);
The JAX package's own EM-LLM tests (tests/test_emllm.py) run on the port at
their sizes; the HF runner is held in tests/test_torch_emllm_hf.py, and the
import of the slice with JAX blocked in tests/test_torch_agent.py.  The spawned ranks import this module, so the JAX package is
imported only in the parent (the ``J`` fixture).
"""

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from hebo_tpu_torch.emllm import (EMLLMAttention, EpisodicKVMemory, masked_attention, refine_boundaries,
                                  retrieve_sharded, segment_events, surprise_boundaries)
from hebo_tpu_torch.emllm.segmentation import _modularity_gain

TIE = 1e-6  # relative gap of the top two scores below which a pick is rounding


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The many small ops here run no faster on more threads, and the
    test run's other workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def J():
    """The JAX package's EM-LLM modules (imported in the parent only)."""
    from hebo_tpu.emllm import attention, memory, segmentation

    return SimpleNamespace(seg=segmentation, mem=memory, att=attention)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# ------------------------------------------------------------ segmentation
def _seg_case(seed):
    """tests/test_emllm.py's segmentation input at seed 0; other seeds the
    same recipe with the planted spikes moved."""
    rng = np.random.default_rng(seed)
    keys = rng.standard_normal((120, 8)).astype(np.float32)
    s = rng.random(120)
    s[[30, 60, 90] if seed == 0 else np.sort(rng.choice(np.arange(5, 115), 5, replace=False))] = 10.0
    return keys, s


SEG_SEEDS = [0, 1, 2, 3, 4]


def test_surprise_boundaries_as_reference(J):
    s = np.ones(100) * 0.5
    s[[20, 55, 57, 80]] = 5.0
    b = surprise_boundaries(s, gamma=1.0, min_event=8)
    assert 20 in b and 55 in b and 80 in b and 57 not in b
    for seed in SEG_SEEDS:
        _, s = _seg_case(seed)
        for gamma, min_event in ((1.0, 8), (0.5, 4), (2.0, 16)):
            np.testing.assert_array_equal(surprise_boundaries(torch.as_tensor(s), gamma, min_event),
                                          J.seg.surprise_boundaries(s, gamma, min_event))


def test_modularity_gain_as_reference(J):
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    K = rng.standard_normal((60, 8)).astype(np.float32)
    K /= np.linalg.norm(K, axis=1, keepdims=True)
    S = K.astype(np.float64) @ K.T.astype(np.float64)
    batch = []
    for b in ([10, 25, 40], [3], [20, 21, 50], []):
        lab = np.searchsorted(np.asarray(b, np.int64), np.arange(60), side="right")
        same = lab[:, None] == lab[None, :]
        scale = max(abs(S[same].sum()), abs(S.sum() * same.mean())) / 60 ** 2
        want = float(J.seg._modularity_gain(jnp.asarray(K), jnp.asarray(lab)))
        got = float(_modularity_gain(torch.as_tensor(K), torch.as_tensor(lab)))
        assert abs(got - want) <= 1e-6 * scale, (b, got, want, scale)
        batch.append((lab, want, scale))
    got = _modularity_gain(torch.as_tensor(K), torch.as_tensor(np.stack([l for l, _, _ in batch]))).numpy()
    for g, (_, w, scale) in zip(got, batch):
        assert abs(g - w) <= 1e-6 * scale


def _ref_picks(J, keys, b0, trace):
    """The JAX package's pick at every boundary the port scored, from the
    port's own boundaries so far (its scores by ``_modularity_gain``, as
    ``refine_boundaries`` takes them); → number of boundaries where the
    picks part on a float32 tie of the port's scores.  A pick that parts
    anywhere else fails."""
    import jax.numpy as jnp

    K = jnp.asarray(keys / (np.linalg.norm(keys, axis=1, keepdims=True) + 1e-8), jnp.float32)
    bounds, ties = [int(b) for b in b0], 0
    for bi, cand, scores in trace:
        ref = []
        for c in cand:
            trial = np.asarray(bounds)
            trial[bi] = c
            lab = jnp.asarray(np.searchsorted(trial, np.arange(len(keys)), side="right"))
            ref.append(float(J.seg._modularity_gain(K, lab)))
        if int(np.argmax(ref)) != int(np.argmax(scores)):
            top = np.sort(scores)[-2:]
            assert top[1] - top[0] <= TIE * abs(top[1]), (bi, cand, scores, ref)
            ties += 1
        bounds[bi] = cand[int(np.argmax(scores))]
    return ties


@pytest.mark.parametrize("seed", SEG_SEEDS)
def test_segment_events_as_reference(J, seed):
    keys, s = _seg_case(seed)
    trace = []
    spans = segment_events(torch.as_tensor(keys), s, gamma=1.0, min_event=8, trace=trace)
    b0 = J.seg.surprise_boundaries(s, 1.0, 8)
    assert _ref_picks(J, keys, b0, trace) == 0  # no float32 tie on these inputs
    assert spans == J.seg.segment_events(keys, s, gamma=1.0, min_event=8)
    assert spans[0][0] == 0 and spans[-1][1] == 120
    assert all(b == c for (_, b), (c, _) in zip(spans[:-1], spans[1:]))
    for window in (2, 6):
        np.testing.assert_array_equal(refine_boundaries(keys, b0, window),
                                      J.seg.refine_boundaries(keys, b0, window))


# ------------------------------------------------------------------ memory
def _memory_pair(J, seed=3, n_chunks=6, H=2, Dh=8, L=16):
    """Both packages' memories fed the same chunks and spans (events of
    1..2L rows, some shorter than n_rep, some longer than L)."""
    rng = np.random.default_rng(seed)
    jm, pm = J.mem.EpisodicKVMemory(event_len=L, n_rep=4), EpisodicKVMemory(event_len=L, n_rep=4,
                                                                             device="cpu")
    for _ in range(n_chunks):
        T = int(rng.integers(20, 60))
        K = rng.standard_normal((T, H, Dh)).astype(np.float32) * rng.uniform(0.1, 2.0, (T, 1, 1)).astype(np.float32)
        V = rng.standard_normal((T, H, Dh)).astype(np.float32)
        cuts = np.sort(rng.choice(np.arange(1, T), int(rng.integers(1, 4)), replace=False))
        edges = [0] + [int(c) for c in cuts] + [T]
        spans = [(a, b) for a, b in zip(edges[:-1], edges[1:])] + [(T, T + 3)]  # an empty span
        jm.add_events(K, V, spans)
        pm.add_events(torch.as_tensor(K), torch.as_tensor(V), spans)
    return jm, pm, rng


def test_memory_add_events_as_reference(J):
    jm, pm, _ = _memory_pair(J)
    assert len(pm) == len(jm)
    k, v, reps, lens = (_np(t) for t in pm.buffers())
    jk, jv, jreps, jlens = jm.buffers()
    np.testing.assert_array_equal(k, jk)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(lens, jlens)
    # the same representatives (their order is the falling norm in both)
    np.testing.assert_array_equal(reps, jreps)


@pytest.mark.parametrize("mode", ["reps", "full"])
def test_memory_retrieve_and_gather_as_reference(J, mode):
    jm, pm, rng = _memory_pair(J)
    for i in range(16):
        q = rng.standard_normal((int(rng.integers(1, 5)), 2, 8)).astype(np.float32)
        for k_sim, k_contig in ((2, 0), (3, 1), (4, 2)):
            ids = pm.retrieve(q, k_sim, k_contig, mode=mode)
            assert ids == jm.retrieve(q, k_sim, k_contig, mode=mode), (i, k_sim, k_contig)
        kk, vv, mm = pm.gather_kv(ids)
        jk, jv, jmask = jm.gather_kv(ids)
        np.testing.assert_array_equal(_np(kk), jk)
        np.testing.assert_array_equal(_np(vv), jv)
        np.testing.assert_array_equal(_np(mm), jmask)
    assert pm.gather_kv([]) is None and EpisodicKVMemory(device="cpu").retrieve(q) == []


def test_memory_retrieval_finds_needle():
    """tests/test_emllm.py::test_memory_retrieval_finds_needle on the port."""
    rng = np.random.default_rng(1)
    H, Dh = 2, 8
    mem = EpisodicKVMemory(event_len=16, n_rep=2, device="cpu")
    needle_dir = np.zeros((H, Dh), np.float32)
    needle_dir[:, 0] = 10.0
    for _ in range(10):
        K = rng.standard_normal((16, H, Dh)).astype(np.float32) * 0.1
        V = rng.standard_normal((16, H, Dh)).astype(np.float32)
        mem.add_events(K, V, [(0, 16)])
    K = np.repeat(needle_dir[None], 16, axis=0) + 0.01 * rng.standard_normal((16, H, Dh)).astype(np.float32)
    mem.add_events(K, np.ones((16, H, Dh), np.float32), [(0, 16)])
    assert 10 in mem.retrieve(needle_dir[None], k_sim=2, k_contig=0)
    assert 10 in mem.retrieve(needle_dir[None], k_sim=2, k_contig=0, mode="full")


def test_memory_buffers_grow_by_doubling():
    mem = EpisodicKVMemory(event_len=4, n_rep=2, device="cpu")
    K = torch.randn((40, 1, 2), generator=torch.Generator().manual_seed(0))
    caps = []
    for i in range(10):
        mem.add_events(K[4 * i:4 * i + 4], K[4 * i:4 * i + 4], [(0, 4)])
        caps.append(mem._k.shape[0])
    assert caps == [1, 2, 4, 4, 8, 8, 8, 8, 16, 16]
    k, _, _, lens = mem.buffers()
    assert k.shape == (10, 4, 1, 2) and k.data_ptr() == mem._k.data_ptr()  # a view
    torch.testing.assert_close(k.reshape(40, 1, 2), K, rtol=0, atol=0)
    assert lens.tolist() == [4] * 10


# --------------------------------------------------------------- attention
def test_masked_attention_as_reference(J):
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    q = rng.standard_normal((5, 3, 16)).astype(np.float32)
    k = rng.standard_normal((40, 3, 16)).astype(np.float32)
    v = rng.standard_normal((40, 3, 16)).astype(np.float32)
    for mask in (rng.random(40) < 0.6, np.zeros(40, bool), np.ones(40, bool)):
        want = np.asarray(J.att.masked_attention(*(jnp.asarray(a) for a in (q, k, v, mask))))
        got = masked_attention(*(torch.as_tensor(a) for a in (q, k, v, mask))).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
        if not mask.any():  # every key masked: the mean of V, not NaN
            np.testing.assert_allclose(got, np.broadcast_to(v.mean(0), got.shape), rtol=0, atol=1e-6)


def _stream(att, rng, H=2, Dh=8):
    """tests/test_emllm.py::test_em_attention_end_to_end_recall's stream."""
    needle_k = np.zeros((16, H, Dh), np.float32)
    needle_k[:, :, 1] = 8.0
    needle_v = np.full((16, H, Dh), 7.0, np.float32)
    for _ in range(4):
        K = rng.standard_normal((32, H, Dh)).astype(np.float32) * 0.1
        V = rng.standard_normal((32, H, Dh)).astype(np.float32) * 0.1
        att.ingest(K, V, rng.random(32))
    s = np.ones(16) * 0.1
    s[0] = 10.0
    att.ingest(needle_k, needle_v, s)
    for _ in range(4):
        K = rng.standard_normal((32, H, Dh)).astype(np.float32) * 0.1
        V = rng.standard_normal((32, H, Dh)).astype(np.float32) * 0.1
        att.ingest(K, V, rng.random(32))
    Q = np.zeros((1, H, Dh), np.float32)
    Q[:, :, 1] = 8.0
    return att.attend(Q)


def test_em_attention_end_to_end_as_reference(J):
    jatt = J.att.EMLLMAttention(2, 8, local_window=32, event_len=16, k_sim=3)
    patt = EMLLMAttention(2, 8, local_window=32, event_len=16, k_sim=3, device="cpu")
    want = _stream(jatt, np.random.default_rng(2))
    got = _stream(patt, np.random.default_rng(2)).numpy()
    assert len(patt.memory) == len(jatt.memory) and len(patt.memory) > 0
    assert got.shape == (1, 2, 8) and np.mean(got) > 3.0  # the JAX test's recall
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------- sharded stage
def _sharded_inputs():
    rng = np.random.default_rng(3)  # tests/test_emllm.py's (E, F) = (32, 16), and a larger one
    return {"small": (rng.standard_normal((32, 16)).astype(np.float32),
                      rng.standard_normal(16).astype(np.float32), 4),
            "large": (rng.standard_normal((96, 24)).astype(np.float32),
                      rng.standard_normal(24).astype(np.float32), 7)}


def _sharded_case(inp, mesh):
    return {key: retrieve_sharded(mesh, torch.as_tensor(r), torch.as_tensor(q), k_sim=k, axis="mem")
            for key, (r, q, k) in inp.items()}


def _rank_main(rank, world, store, in_path, out_dir, cases):
    """One gloo rank: the mesh over axis "mem", ``retrieve_sharded`` on
    every input."""
    import torch.distributed as dist

    from hebo_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world)
    try:
        out = _sharded_case(torch.load(in_path, weights_only=False), make_mesh(axis="mem", device="cpu"))
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _jax_sharded(J, inp, world):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    mesh = Mesh(np.array(jax.devices()[:world]), ("mem",))
    return {key: np.asarray(J.mem.retrieve_sharded(mesh, jnp.asarray(r), jnp.asarray(q), k_sim=k, axis="mem"))
            for key, (r, q, k) in inp.items()}


@pytest.mark.parametrize("world", [1, 2, 4])
def test_retrieve_sharded_as_reference(J, world, tmp_path):
    inp = _sharded_inputs()
    if world == 1:
        ranks = [_sharded_case(inp, None)]
    else:
        from test_torch_mesh import spawn

        ranks = spawn(world, inp, (), tmp_path, main=_rank_main)
    want = _jax_sharded(J, inp, world)
    for key, (r, q, k) in inp.items():
        host = np.argsort(-(r @ q))[:k]
        np.testing.assert_array_equal(np.sort(want[key]), np.sort(host))
        for out in ranks:
            np.testing.assert_array_equal(_np(out[key]), want[key])  # by falling score, as lax.top_k


def test_retrieve_sharded_refuses_an_uneven_split():
    r, q = torch.zeros((10, 4)), torch.zeros(4)

    class _Mesh:  # a stand-in of three ranks: the check comes before any collective
        mesh_dim_names = ("mem",)

        def size(self):
            return 3

    with pytest.raises(ValueError, match="do not divide"):
        retrieve_sharded(_Mesh(), r, q)
    with pytest.raises(ValueError, match="axis"):
        retrieve_sharded(_Mesh(), r, q, axis="pop")
