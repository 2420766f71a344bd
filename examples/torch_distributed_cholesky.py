"""Distributed Cholesky with the PyTorch port over a ``torch.distributed``
mesh (paper Fig. 3(b)).

Starts one process a rank, joins them in a process group and runs the SAME
application program under a distributed graph (g3 by default) on a
(ranks, 1) mesh.  The DuctTeip analog places block rows over the ``data``
axis; each rank computes the tasks whose written block it owns, and after
every issue slot one all-reduce makes the slot's written blocks current on
every rank.  A second drain of the same shape (another seed) replays the
first from the drain memo.

    PYTHONPATH=src python examples/torch_distributed_cholesky.py            # 2 CPU ranks, gloo
    PYTHONPATH=src python examples/torch_distributed_cholesky.py --cuda     # one rank a card, NCCL
    PYTHONPATH=src python examples/torch_distributed_cholesky.py --cuda --graph g4 --n 4096 --levels 4x4,8x8
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh


def rank_main(rank: int, world: int, args, init: str) -> None:
    from repro_torch.core import Dispatcher, GData, spd_matrix
    from repro_torch.linalg import utp_cholesky

    device_type = "cuda" if args.cuda else "cpu"
    if args.cuda:
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if args.cuda else "gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world, **({"device_id": torch.device("cuda", rank)} if args.cuda else {}))
    try:
        mesh = init_device_mesh(device_type, (world, 1), mesh_dim_names=("data", "model"))
        device = f"cuda:{rank}" if args.cuda else "cpu"
        parts = tuple(tuple(int(x) for x in level.split("x")) for level in args.levels.split(","))
        lines = []
        for drain, seed in (("first", 0), ("replay", 1)):
            a = spd_matrix(args.n, seed=seed, device=device)  # the same seeded matrix on every rank
            d = Dispatcher(graph=args.graph, mesh=mesh)
            A = GData(a.shape, partitions=parts, value=a, device=device)
            utp_cholesky(d, A)
            dist.barrier()
            t0 = time.perf_counter()
            leaves = d.run()
            d.executor.sync()
            wall = time.perf_counter() - t0
            err = (torch.tril(A.value).double() - torch.linalg.cholesky(a.double())).abs().max().item()
            st = d.executor.stats
            if rank == 0:
                lines.append(f"{args.graph} on ({world},1) {device_type} mesh, n={args.n}, {drain} drain: "
                             f"{leaves} leaf tasks, {d.stats['waves']} waves, memo_hits={d.stats['memo_hits']}, "
                             f"wall_ms={wall * 1e3:.3f}")
            lines.append(f"  rank {rank} {drain}: owned_tasks={st['owned_tasks']} "
                         f"exchanges={st.get('exchanges', 0)} exchanged_bytes={st.get('exchanged_bytes', 0)} "
                         f"max_err={err:.2e}")
        for r in range(world):  # one rank's lines at a time
            if r == rank:
                print("\n".join(lines), flush=True)
            dist.barrier()
    finally:
        dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2, help="CPU ranks (ignored with --cuda)")
    ap.add_argument("--cuda", action="store_true", help="one rank on each CUDA card, over NCCL")
    ap.add_argument("--graph", default="g3", choices=("g3", "g4", "g3flat"))
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--levels", default="8x8,2x2", help="partitions, level by level")
    args = ap.parse_args()
    world = torch.cuda.device_count() if args.cuda else args.ranks
    if world < 1:
        raise SystemExit("--cuda needs at least one CUDA card")
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(rank_main, args=(world, args, os.path.join(tmp, "init")), nprocs=world)


if __name__ == "__main__":
    main()
