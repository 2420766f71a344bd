"""``release_captured`` (ROADMAP C5): one call drops every captured program
and its static storage, and every ``CapturedCall``'s graph and buffers, so
the caching allocator can hand their memory back to the device.  On the
CPU the programs hold their static grids and index tensors as on the card;
after the release nothing reachable holds them (weak references die), and
the next drain compiles and captures again with a first drain's counters,
equal to the JAX package's first drain after its own cache clear."""

import gc
import weakref

import numpy as np
import torch

import repro.core as jcore
import repro.linalg as jlin
import repro_torch.core as tcore
import repro_torch.core.executors.captured as tcap
import repro_torch.core.executors.jit_wave as tjw
import repro_torch.linalg as tlin
from repro.core.executors import clear_compile_cache as jclear
from repro_torch.core.executors import release_captured

STATS = ("compiles", "launches", "tasks", "groups", "groups_prefusion", "slots")


def _drain(core, lin, n=128, p=4, seed=0, **kw):
    d = core.Dispatcher(graph="g2p")
    a = tcore.spd_matrix(n, seed=seed, device="cpu").numpy()
    A = core.GData((n, n), partitions=((p, p),), value=a, **kw)
    lin.utp_cholesky(d, A)
    d.run()
    v = A.value
    res = np.tril(v.numpy() if hasattr(v, "numpy") else np.asarray(v))
    return res, {k: d.executor.stats.get(k, 0) for k in STATS}, d.stats["memo_hits"]


def test_release_drops_every_captured_program_and_the_next_drain_recaptures():
    jclear()
    tjw.clear_compile_cache()
    _drain(jcore, jlin)
    _, first, _ = _drain(tcore, tlin, device="cpu")
    assert first["compiles"] == 1 and tjw.program_cache_stats()["entries"] == 1
    _, replay, hits = _drain(tcore, tlin, device="cpu")
    assert replay["compiles"] == 0 and hits == 1
    prog = next(iter(tjw._PROGRAMS._entries.values()))
    refs = [weakref.ref(prog), weakref.ref(prog.idxs), *(weakref.ref(g) for g in prog.grids)]
    del prog
    gc.collect()
    assert all(r() is not None for r in refs[:2])  # held by the program cache

    release_captured()
    gc.collect()
    assert all(r() is None for r in refs)
    assert tjw.program_cache_stats()["entries"] == 0 and tjw.drain_memo_stats()["entries"] == 0

    jclear()
    want, jst, jhits = _drain(jcore, jlin, seed=1)
    got, tst, thits = _drain(tcore, tlin, seed=1, device="cpu")
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert tst == jst == first and thits == jhits == 0
    assert tjw.program_cache_stats()["entries"] == 1


def test_release_drops_captured_calls():
    """A ``CapturedCall`` (the train and decode steps' capture) loses its
    graph and static buffers; on the CPU it runs eagerly before and after."""
    call = tcap.CapturedCall(lambda x: x * 2, "double", donate=[False])
    call.static, call.outputs = (torch.ones(3),), torch.ones(3)
    ref = weakref.ref(call.static[0])
    assert call in set(tcap._CALLS)
    release_captured()
    gc.collect()
    assert call.static is None and call.outputs is None and call.graph is None and ref() is None
    assert torch.equal(call(torch.ones(2)), torch.full((2,), 2.0))
