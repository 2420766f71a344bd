"""Row-owned storage of the port's distributed graphs, checked in one process.

No process group is needed: ``plan_exchanges`` and ``OwnedProgram`` are
host functions of a plan and a mesh's shape.

- Which blocks move: for flat 32 x 32 Cholesky on a (4, 1) mesh exactly the
  panel blocks L(j, k), k <= j, to every rank below row j's owner (472
  blocks, 108 / 200 / 164 / 0 sent a rank), and for LU the blocks of row k
  to every rank below row k's owner; each after the slot that wrote it.
- Lockstep: one ``OwnedProgram`` a mesh position, run slot by slot over
  stores of the position's own blocks (received slots filled with NaN),
  with each message of ``plan_exchanges`` done by a copy between stores:
  the owners' blocks put together equal the world-size-1 drain bit for bit,
  on a (4, 1) mesh and on a (2, 2) mesh split on both axes or on rows only.
- ``Split`` offsets and ``SplitStore``'s layout.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import repro_torch.core as tcore
import repro_torch.linalg as tlin
from repro_torch.core.data import Split, SplitStore, to_grid
from repro_torch.core.executors import clear_compile_cache
from repro_torch.core.executors.jit_wave import WaveExecutor
from repro_torch.core.executors.sharded import OwnedProgram, Placement, plan_exchanges

NAMES = ("data", "model")


def _roots(kind, n, leaf, b_cols=16, b_leaf=(8, 2)):
    make = tcore.spd_matrix if kind == "cholesky" else tcore.dd_matrix
    A = tcore.GData((n, n), partitions=((leaf, leaf),), value=make(n, seed=3, device="cpu"), device="cpu")
    if kind != "lu_solve":
        return [A]
    b = np.random.default_rng(3).standard_normal((n, b_cols)).astype(np.float32)
    return [A, tcore.GData(b.shape, partitions=(b_leaf,), value=b, device="cpu")]


def _submit(d, kind, roots):
    {"cholesky": tlin.utp_cholesky, "lu": tlin.utp_getrf, "lu_solve": tlin.utp_lu_solve}[kind](d, *roots)


def _plan(kind, roots, monkeypatch):
    """The one leaf plan of a one-level drain of ``roots`` (not run)."""
    seen = []
    monkeypatch.setattr(WaveExecutor, "_run_program", lambda self, plan, stack=None: seen.append(plan) or 0)
    clear_compile_cache()
    d = tcore.Dispatcher(graph="g2")
    _submit(d, kind, roots)
    d.run()
    monkeypatch.undo()
    clear_compile_cache()
    (plan,) = seen
    return plan


def _placements(plan, mesh_shape, axes):
    out = []
    for d, (br, bc) in zip(plan.roots_order, plan.blocks):
        grid = (plan.datas[d].shape[0] // br, plan.datas[d].shape[1] // bc)
        spec, sizes = [], []
        for g, ax in zip(grid, axes):
            size = 1 if ax is None else mesh_shape[NAMES.index(ax)]
            split = ax is not None and size > 1 and g % size == 0
            spec.append(ax if split else None)
            sizes.append(size if split else 1)
        out.append(Placement(grid, tuple(spec), tuple(sizes)))
    return out


def _messages(msgs):
    return [m for point in sorted(msgs) for m in msgs[point]]


def test_flat_cholesky_on_four_ranks_moves_only_the_panel_blocks(monkeypatch):
    """A GEMM on block (i, j) reads L(i, k) and L(j, k) and a TRSM on (j, k)
    reads L(k, k): the reads that cross ranks are L(j, k), k <= j, on the
    ranks below row j's owner, 472 blocks in all (29.5 MiB at 128 x 128
    fp32), against 5984 written blocks that the all-reduce of every written
    block gave every rank."""
    plan = _plan("cholesky", _roots("cholesky", 128, 32), monkeypatch)
    assert len(plan.tasks) == 5984
    owner = lambda row: row * 4 // 32  # noqa: E731
    _, msgs = plan_exchanges(plan, _placements(plan, (4, 1), ("data", None)), (4, 1), NAMES)
    got = _messages(msgs)
    want = {(owner(j), q, 0, j, k) for j in range(32) for k in range(j + 1) for q in range(4) if q > owner(j)}
    assert len(got) == len(set(got)) == len(want) == 472 and set(got) == want
    assert [sum(m[0] == p for m in got) for p in range(4)] == [108, 200, 164, 0]
    assert [sum(m[1] == p for m in got) for p in range(4)] == [0, 36, 136, 300]
    assert -1 not in msgs  # every block read across ranks is written in the plan first


def test_flat_lu_on_four_ranks_moves_only_row_k_to_the_rows_below(monkeypatch):
    """LU's cross-rank reads are row k's blocks, U(k, j) for j >= k, on the
    ranks below row k's owner."""
    plan = _plan("lu", _roots("lu", 64, 16), monkeypatch)
    owner = lambda row: row * 4 // 16  # noqa: E731
    _, msgs = plan_exchanges(plan, _placements(plan, (4, 1), ("data", None)), (4, 1), NAMES)
    got = _messages(msgs)
    want = {(owner(k), q, 0, k, j) for k in range(16) for j in range(k, 16) for q in range(4) if q > owner(k)}
    assert len(got) == len(want) and set(got) == want


def _lockstep(plan, mesh_shape, axes, backend="torch"):
    """Every mesh position's cut of ``plan`` run in this process, slot by
    slot, the blocks of ``plan_exchanges`` moved by copies; returns the
    programs and each position's grids after the run."""
    placements = _placements(plan, mesh_shape, axes)
    P = int(np.prod(mesh_shape))
    progs = [OwnedProgram(plan, placements, backend, mesh_shape, NAMES, p, None, list(range(P))) for p in range(P)]
    first = [to_grid(plan.datas[d].value, *blk) for d, blk in zip(plan.roots_order, plan.blocks)]
    stores = []
    for prog in progs:
        grids = []
        for r, (pl, g) in enumerate(zip(placements, first)):
            if not pl.distributed:
                grids.append(g.clone())
                continue
            s = g.new_full((1, prog.store_blocks[r], *g.shape[2:]), float("nan"))
            r0, c0, nr, nc = prog._local[r]
            for i in range(r0, r0 + nr):
                for j in range(c0, c0 + nc):
                    s[0, prog.position(r, i, j)] = g[i, j]
            grids.append(s)
        stores.append(grids)

    def move(point):
        for src, dst, r, i, j in progs[0].messages.get(point, []):
            stores[dst][r][0, progs[dst].position(r, i, j)] = stores[src][r][0, progs[src].position(r, i, j)]

    move(-1)
    for s in range(len(plan.slots)):
        for prog, grids in zip(progs, stores):
            fn, idxs, _ = prog.steps[s]
            if fn is not None:
                fn(grids, idxs)
        move(s)
    return placements, progs, stores


CASES = {
    "cholesky_rows": ("cholesky", (4, 1), ("data", None), 1),
    "lu_solve_blocks": ("lu_solve", (2, 2), ("data", "model"), 1),
    "lu_rows_of_a_2d_mesh": ("lu", (2, 2), ("data", None), 2),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_owned_programs_in_lockstep_equal_world_size_one(monkeypatch, name):
    """The owners' blocks after the lockstep run equal the drain at world
    size 1 bit for bit (every owner of a block alike); the owned tasks add up
    to the plan's once per owner; each store holds the owned blocks and one
    slot for each block received; what a position sends and receives is its
    share of the messages."""
    kind, mesh_shape, axes, owners = CASES[name]
    roots = _roots(kind, 64, 8)
    plan = _plan(kind, roots, monkeypatch)
    ref = _roots(kind, 64, 8)
    d = tcore.Dispatcher(graph="g2")
    _submit(d, kind, ref)
    d.run()
    placements, progs, stores = _lockstep(plan, mesh_shape, axes)
    msgs = _messages(progs[0].messages)
    assert sum(p.n_owned for p in progs) == owners * len(plan.tasks)
    for r, (pl, blk, root) in enumerate(zip(placements, plan.blocks, ref)):
        want = to_grid(root.value, *blk)
        for p, (prog, grids) in enumerate(zip(progs, stores)):
            if not pl.distributed:
                torch.testing.assert_close(grids[r], want, rtol=0, atol=0)
                continue
            r0, c0, nr, nc = prog._local[r]
            got = grids[r][0, : nr * nc].view(nr, nc, *blk)
            assert torch.equal(got, want[r0 : r0 + nr, c0 : c0 + nc])
            received = {(i, j) for s, t, rr, i, j in msgs if t == p and rr == r}
            assert prog.store_blocks[r] == nr * nc + len(received)
        assert sum(p.sent_bytes for p in progs) == sum(p.received_bytes for p in progs)
    for p, prog in enumerate(progs):
        mine = [m for m in msgs if m[0] == p]
        assert prog.sent_bytes == sum(plan.blocks[m[2]][0] * plan.blocks[m[2]][1] * 4 for m in mine)
        assert prog.n_exchanges == len(progs[0].messages)


def test_split_offsets_follow_the_mesh_coordinate():
    """Each part's offset is its coordinate times the even chunk, a dim split
    over two mesh dims in mesh-dim order, as DTensor's ``Shard`` does."""
    mesh = SimpleNamespace(get_coordinate=lambda: [1, 0], mesh=np.zeros((2, 2)))
    sp = Split.of(mesh, (Shard(0), Shard(1)), (64, 32))
    assert (sp.offset, sp.local_shape) == ((32, 0), (32, 16))
    assert sp.offset_at((2, 2), (1, 1)) == (32, 16)
    rows = Split.of(mesh, (Shard(0), Replicate()), (64, 32))
    assert (rows.offset, rows.local_shape) == ((32, 0), (32, 32))
    twice = Split.of(mesh, (Shard(0), Shard(0)), (64, 32))
    assert (twice.offset, twice.local_shape) == ((32, 0), (16, 32))
    with pytest.raises(ValueError, match="does not split evenly"):
        Split.of(mesh, (Shard(0), Replicate()), (63, 32))
    pl = Placement((64, 32), ("data", "model"), (2, 2))
    assert pl.dtensor_placements(NAMES) == (Shard(0), Shard(1))
    assert Placement((64, 32), ("data", None), (2, 1)).dtensor_placements(NAMES) == (Shard(0), Replicate())


def test_split_store_keeps_owned_blocks_first_and_grows_in_place():
    local = torch.arange(16 * 64, dtype=torch.float32).reshape(16, 64)
    split = Split(None, (Shard(0), Replicate()), (64, 64), (16, 0), (16, 64))
    st = SplitStore(split, local, (8, 16))
    assert st.grid == (2, 4) and st.n_owned == 8 and tuple(st.store.shape) == (1, 8, 8, 16)
    assert torch.equal(st.owned(), to_grid(local, 8, 16))
    assert torch.equal(st.store[0, 5], local[8:16, 16:32])  # row-major: block (1, 1) is the sixth
    before = st.store
    assert st.reserve(8) is before
    grown = st.reserve(11)
    assert tuple(grown.shape) == (1, 11, 8, 16) and torch.equal(st.owned(), to_grid(local, 8, 16))
    with pytest.raises(ValueError, match="does not divide"):
        SplitStore(split, local, (6, 16))
