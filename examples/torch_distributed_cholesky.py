"""Distributed Cholesky (or LU solve) with the PyTorch port over a
``torch.distributed`` mesh (paper Fig. 3(b)).

Starts one process a rank, joins them in a process group and runs the SAME
application program under a distributed graph (g3 by default) on a
(ranks, 1) mesh.  The DuctTeip analog splits the matrix by block rows over
the ``data`` axis: each rank is given only its rows (a ``DTensor``), holds
only its own blocks plus the blocks of other ranks it reads, computes the
tasks whose written block it owns, and after each issue slot sends the
blocks another rank reads straight to that rank.  The result stays split;
each rank prints its shard's shape, what it sent, received and held, and
its peak memory, then the error of the whole result (``full_tensor()``)
against float64.  A second drain of the same shape (another seed) replays
the first from the drain memo, and a third (the first seed again) is a
steady replay.  On the cards each rank captures every launch list it cuts,
the exchanges' collectives inside, into a CUDA graph on the first drain and
replays it after: each rank's line gives its graph replays beside its
lists (``launches``), and the host dispatch (``dispatch_ms``: the drain's
calls, before the host waits for the card) beside the wall.

    PYTHONPATH=src python examples/torch_distributed_cholesky.py            # 2 CPU ranks, gloo
    PYTHONPATH=src python examples/torch_distributed_cholesky.py --cuda     # one rank a card, NCCL
    PYTHONPATH=src python examples/torch_distributed_cholesky.py --cuda --graph g4 --n 4096 --levels 4x4,8x8
    PYTHONPATH=src python examples/torch_distributed_cholesky.py --cuda --kind lu_solve --graph g4 --n 4096 \\
        --levels 4x4,8x8 --b-levels 4x4,8x1 --rhs 512
"""

import argparse
import hashlib
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard


def _levels(text: str):
    return tuple(tuple(int(x) for x in level.split("x")) for level in text.split(","))


def rank_main(rank: int, world: int, args, init: str) -> None:
    from repro_torch.core import Dispatcher, GData, dd_matrix, spd_matrix
    from repro_torch.core.executors import release_captured
    from repro_torch.linalg import utp_cholesky, utp_lu_solve

    device_type = "cuda" if args.cuda else "cpu"
    if args.cuda:
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if args.cuda else "gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world, **({"device_id": torch.device("cuda", rank)} if args.cuda else {}))
    try:
        mesh = init_device_mesh(device_type, (world, 1), mesh_dim_names=("data", "model"))
        device = torch.device(device_type, rank) if args.cuda else torch.device("cpu")
        rows = slice(rank * args.n // world, (rank + 1) * args.n // world)
        lines = []
        for drain, seed in (("first", 0), ("replay", 1), ("steady", 0)):
            # the same seeded matrix on every rank, of which each is given its rows
            host = (spd_matrix if args.kind == "cholesky" else dd_matrix)(args.n, seed=seed, device="cpu")
            rhs = torch.from_numpy(np.random.default_rng(seed).standard_normal((args.n, args.rhs)).astype(np.float32))
            if args.cuda:
                torch.cuda.synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
            split = lambda t: DTensor.from_local(t[rows].to(device), mesh, (Shard(0), Replicate()),  # noqa: E731
                                                 run_check=False)
            d = Dispatcher(graph=args.graph, mesh=mesh)
            A = GData(host.shape, partitions=_levels(args.levels), value=split(host), device=device)
            if args.kind == "cholesky":
                utp_cholesky(d, A)
                out = A
            else:
                out = GData(rhs.shape, partitions=_levels(args.b_levels), value=split(rhs), device=device)
                utp_lu_solve(d, A, out)
            dist.barrier()
            t0 = time.perf_counter()
            leaves = d.run()
            dispatch = time.perf_counter() - t0
            d.executor.sync()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated(device) if args.cuda else None
            v = out.value
            shard = tuple(v.to_local().shape) if isinstance(v, DTensor) else tuple(v.shape)
            whole = v.full_tensor() if isinstance(v, DTensor) else v
            if args.kind == "cholesky":
                whole = torch.tril(whole)
                want = torch.linalg.cholesky(host.to(device, torch.float64))
            else:
                want = torch.linalg.solve(host.to(device, torch.float64), rhs.to(device, torch.float64))
            err = (whole.double() - want).abs().max().item()
            digest = hashlib.sha1(whole.cpu().numpy().tobytes()).hexdigest()[:12]
            st = d.executor.stats
            if rank == 0:
                lines.append(f"{args.graph} {args.kind} on ({world},1) {device_type} mesh, n={args.n}, "
                             f"levels={args.levels}, {drain} drain: {leaves} leaf tasks, {d.stats['waves']} waves, "
                             f"memo_hits={d.stats['memo_hits']}, wall_ms={wall * 1e3:.3f}")
            lines.append(f"  rank {rank} {drain}: launches={st['launches']} graph_replays={st.get('graph_replays', 0)} "
                         f"dispatch_ms={dispatch * 1e3:.3f} wall_ms={wall * 1e3:.3f} shard={shard} "
                         f"owned_tasks={st['owned_tasks']} "
                         f"exchanges={st.get('exchanges', 0)} exchanged_bytes={st.get('exchanged_bytes', 0)} "
                         f"received_bytes={st.get('received_bytes', 0)} resident_bytes={st.get('resident_bytes', 0)} "
                         f"peak_bytes={peak} max_err={err:.6e} sha1={digest}")
            del d, A, out, v, whole, want  # the next drain's peak counts its own tensors only
        for r in range(world):  # one rank's lines at a time
            if r == rank:
                print("\n".join(lines), flush=True)
            dist.barrier()
    finally:
        release_captured()  # a graph holding NCCL collectives keeps their communicator: drop it first
        dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=None, help="ranks (CPU default 2; CUDA default every card)")
    ap.add_argument("--cuda", action="store_true", help="one rank on each CUDA card, over NCCL")
    ap.add_argument("--graph", default="g3", choices=("g3", "g4", "g3flat"))
    ap.add_argument("--kind", default="cholesky", choices=("cholesky", "lu_solve"))
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--levels", default="8x8,2x2", help="partitions, level by level")
    ap.add_argument("--b-levels", default="8x8,2x1", help="the right-hand side's partitions (lu_solve)")
    ap.add_argument("--rhs", type=int, default=128, help="right-hand-side columns (lu_solve)")
    args = ap.parse_args()
    cards = torch.cuda.device_count() if args.cuda else None
    world = args.ranks or (cards if args.cuda else 2)
    if args.cuda and not 1 <= world <= cards:
        raise SystemExit(f"--cuda needs one card a rank: {world} ranks, {cards} cards")
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(rank_main, args=(world, args, os.path.join(tmp, "init")), nprocs=world)


if __name__ == "__main__":
    main()
