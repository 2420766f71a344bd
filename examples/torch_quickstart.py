"""Quickstart with the PyTorch port: the paper's programming model end to
end (Fig. 2 analog; the counterpart of ``examples/quickstart.py``).

ONE application program (define data, partition, call utp_cholesky, wait)
runs unchanged under every task-flow graph: library leaves one at a time
(g1), wave-batched library leaves (g2), the hand-written CUDA tile kernels
(g2p; their plain versions on the CPU) and the two-level distributed plan
(g3, over a one-rank ``DeviceMesh`` this script starts: NCCL on the card,
gloo on the CPU).

    PYTHONPATH=src python examples/torch_quickstart.py [N] [b1] [b2]                 # on the card
    PYTHONPATH=src python examples/torch_quickstart.py 64 4 2 --device cpu
"""

import argparse
import os
import sys
import tempfile
from contextlib import contextmanager, nullcontext

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import torch


@contextmanager
def one_rank_mesh(device_type: str):
    """A world-size-1 process group and its (1, 1) ("data", "model") mesh,
    destroyed on exit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if dist.is_initialized():
        raise RuntimeError("a process group is already running; this example starts its own")
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo", store=dist.FileStore(f"{tmp}/store", 1),
                                rank=0, world_size=1)
        try:
            yield init_device_mesh(device_type, (1, 1), mesh_dim_names=("data", "model"))
        finally:
            dist.destroy_process_group()


def main(argv=None) -> dict:
    """Returns the printed lines, each graph's factor (on the CPU) and its
    (leaf tasks, waves)."""
    from repro_torch.core import Dispatcher, GData, resolve_device, spd_matrix
    from repro_torch.linalg import utp_cholesky

    ap = argparse.ArgumentParser(prog="torch_quickstart.py")
    ap.add_argument("params", nargs="*", type=int, help="N b1 b2 (default 256 4 2)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    n, b1, b2 = (list(args.params) + [256, 4, 2][len(args.params):])[:3]
    dev = resolve_device(args.device)
    a = spd_matrix(n, device=dev)
    want = torch.linalg.cholesky(a)
    lines = [f"Cholesky of {n}x{n} SPD matrix on {dev.type}, partitions {b1}x{b1} then {b2}x{b2}"]
    print(lines[-1])
    factors, stats = {}, {}
    for graph, parts in [
        ("g1", ((b1, b1),)),
        ("g2", ((b1, b1),)),
        ("g2p", ((b1, b1),)),
        ("g3", ((b1, b1), (b2, b2))),
    ]:
        with (one_rank_mesh(dev.type) if graph == "g3" else nullcontext()) as mesh:
            # ---- the application program (identical for every graph) ----
            d = Dispatcher(graph=graph, mesh=mesh)
            A = GData(tuple(a.shape), partitions=parts, dtype=a.dtype, value=a, device=dev)
            utp_cholesky(d, A)
            n_leaf = d.run()
            # --------------------------------------------------------------
            L = torch.tril(A.value)
        err = float((L - want).abs().max())
        factors[graph] = L.cpu()
        stats[graph] = (n_leaf, d.stats["waves"])
        lines.append(f"  graph {graph:6s} [{d.graph.describe():47s}] "
                     f"leaf_tasks={n_leaf:4d} waves={d.stats['waves']:3d} max_err={err:.2e}")
        print(lines[-1])
    lines.append("same program, four execution plans — the paper's portability claim.")
    print(lines[-1])
    return {"lines": lines, "factors": factors, "stats": stats}


if __name__ == "__main__":
    main()
