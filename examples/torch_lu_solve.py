"""Walkthrough with the PyTorch port: solve ``A x = b`` end to end in ONE
dispatcher drain (the counterpart of ``examples/lu_solve.py``).

The root task is the composed LUSOLVE operation, whose expansion emits LU
panel tasks, forward-substitution (TRSML) tasks and backward-substitution
(TRSMUL) tasks into one scope.  The dispatcher versions all of them into
one task DAG and plans the whole pipeline as ONE launch list, so:

  * there is one launch per drain (captured into one CUDA graph on the
    card), not three barrier-separated drains,
  * the cross-wave fusion pass overlaps solve groups with late factor
    groups (``groups < groups_prefusion`` below),
  * a structurally repeated drain replays from the drain memo with no new
    build (``compiles`` stays 0 on the second call).

``b`` is a numpy standard normal draw (seed 0): torch cannot reproduce the
reference's ``jax.random`` draw.  g3 runs over a one-rank ``DeviceMesh``
this script starts (NCCL on the card, gloo on the CPU).

    PYTHONPATH=src python examples/torch_lu_solve.py [N] [b1] [b2]                 # on the card
    PYTHONPATH=src python examples/torch_lu_solve.py 64 4 2 --device cpu
"""

import argparse
import os
import sys
import tempfile
from contextlib import contextmanager, nullcontext

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np
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


def rhs(n: int, seed: int) -> np.ndarray:
    """The right-hand side: (n, n) standard normal, float32."""
    return np.random.default_rng(seed).standard_normal((n, n)).astype(np.float32)


def main(argv=None) -> dict:
    """Returns the printed lines, each graph's solution, the two drains'
    counters and the inverse (on the CPU)."""
    from repro_torch.core import Dispatcher, GData, dd_matrix, resolve_device
    from repro_torch.core.executors import clear_compile_cache
    from repro_torch.linalg import run_inv, run_lu_solve
    from repro_torch.linalg.lu import utp_lu_solve

    ap = argparse.ArgumentParser(prog="torch_lu_solve.py")
    ap.add_argument("params", nargs="*", type=int, help="N b1 b2 (default 256 4 2)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    n, b1, b2 = (list(args.params) + [256, 4, 2][len(args.params):])[:3]
    dev = resolve_device(args.device)
    a = dd_matrix(n, device=dev)  # column-diagonally dominant -> pivot-free LU is exact
    b = torch.from_numpy(rhs(n, 0)).to(dev)
    want = torch.linalg.solve(a.double(), b.double()).float()
    lines = [f"Solve A x = b for {n}x{n} A on {dev.type}, partitions {b1}x{b1} then {b2}x{b2}"]
    print(lines[-1])
    out = {"lines": lines, "x": {}, "drains": []}

    # ---- one program, every task-flow graph ------------------------------
    for graph, parts in [
        ("g1", ((b1, b1),)),
        ("g2", ((b1, b1),)),
        ("g2p", ((b1, b1),)),
        ("g3", ((b1, b1), (b2, b2))),
    ]:
        with (one_rank_mesh(dev.type) if graph == "g3" else nullcontext()) as mesh:
            x = run_lu_solve(a, b, graph=graph, partitions=parts, mesh=mesh, device=dev)
        out["x"][graph] = x.cpu()
        lines.append(f"  graph {graph:4s} max_err={float((x - want).abs().max()):.2e}")
        print(lines[-1])

    # ---- the single-drain claim, witnessed by the counters ---------------
    def drain(seed):
        d = Dispatcher(graph="g2")
        A = GData(tuple(a.shape), partitions=((b1, b1),), dtype=a.dtype, value=dd_matrix(n, seed=seed, device=dev),
                  device=dev)
        B = GData(tuple(b.shape), partitions=((b1, b1),), dtype=b.dtype, value=torch.from_numpy(rhs(n, seed)).to(dev),
                  device=dev)
        utp_lu_solve(d, A, B)
        n_leaf = d.run()
        s = d.executor.stats
        out["drains"].append({"leaf_tasks": n_leaf, **{k: s[k] for k in ("launches", "compiles", "groups",
                                                                        "groups_prefusion")}})
        lines.append(f"  drain(seed={seed}): leaf_tasks={n_leaf} launches={s['launches']} compiles={s['compiles']} "
                     f"groups={s['groups']} (prefusion {s['groups_prefusion']})")
        print(lines[-1])

    lines.append("factor + L-solve + U-solve in ONE launch list:")
    print(lines[-1])
    clear_compile_cache()  # forget the runs above: show a cold first drain
    drain(seed=1)  # compiles=1: one program for the whole pipeline
    drain(seed=2)  # compiles=0: structurally repeated drain -> memo replay

    # ---- second application of the same ops: matrix inverse --------------
    inv = run_inv(a, partitions=((b1, b1),), device=dev)
    out["inv"] = inv.cpu()
    err = float((inv @ a - torch.eye(n, device=dev)).abs().max())
    lines.append(f"run_inv (A X = I through the same pipeline): |inv(a)@a - I| = {err:.2e}")
    print(lines[-1])
    return out


if __name__ == "__main__":
    main()
