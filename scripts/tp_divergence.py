"""How far a step split over ``model`` lies from one device's, against how
far one device's own bf16 step lies from its float32 one.

Run over four ranks (one rank a card over NCCL; ``--cpu``: gloo ranks and
reduced widths)::

    torchrun --standalone --nproc-per-node 4 scripts/tp_divergence.py
    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 scripts/tp_divergence.py --cpu

For starcoder2-7b (seeded random weights):

- at 1 and 2 layers in bf16 and float32 on a (1, 4) mesh: the last-token
  logits of the prefill plan over the mesh and of ``Model.prefill`` on
  rank 0's device, as relative L2, and beside them the one-device bf16
  logits against the one-device float32 logits of the same weights (the
  size of a rounding difference after the random network amplifies it
  layer by layer);
- at 1 layer in bf16 on a (1, 4) and a (2, 2) mesh: each leaf's gradient
  of the first train step (Adam's first moment after it, (1 - b1) g in
  fp32, the same scale on every side) over the mesh against one device's
  float32 step, beside one device's bf16 step against the same float32
  step, and the mesh's against one device's bf16, as relative L2 (max and
  median over the leaves).  Where the first two agree, the split step is
  as near the float32 step as one device's bf16 step is.
"""

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import torch
import torch.distributed as dist

CASES = ((1, "bfloat16"), (2, "bfloat16"), (1, "float32"), (2, "float32"))
B, T, PROMPT = 2, 512, 64
TRAIN_B = 4  # the gradient witness's global batch (the (2, 2) mesh splits it)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).norm() / b.norm()).item()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU, reduced widths")
    args = ap.parse_args()
    rank = int(os.environ["RANK"])
    dev = "cpu" if args.cpu else "cuda"
    if args.cpu:
        dist.init_process_group("gloo")
    else:
        torch.cuda.set_device(rank)
        dist.init_process_group("nccl", device_id=torch.device("cuda", rank))
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import steps as st
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map

    try:
        if rank == 0:
            print(_card(), flush=True)
        mesh = make_local_mesh(model=dist.get_world_size(), data=1, device_type=dev)
        for layers, dtype in CASES:
            cfg = get_arch("starcoder2-7b")
            cfg = cfg.reduced() if args.cpu else cfg
            dt = getattr(torch, dtype)
            cfg = dataclasses.replace(cfg, n_layers=layers, compute_dtype=dt, cache_dtype=dt)
            pre = st.make_prefill_step(cfg, mesh, ShapeConfig("p", T, B, "prefill"), device=dev)
            p_shard, b_shard, c_shard = pre.in_shardings
            blocks = build_model(cfg, seed=0, device=dev, shardings=p_shard).train_params()
            params = {k: sh.place(v.detach(), p_shard[k], tuple(pre.args[0][k].shape)) for k, v in blocks.items()}
            cache = st.place_params(tree_map(lambda c: torch.zeros(c.shape, dtype=c.dtype, device=dev),
                                             st.cache_specs(cfg, B, T)), c_shard)
            gen = torch.Generator().manual_seed(10)
            prompt = torch.randint(0, cfg.vocab, (B, PROMPT), generator=gen, dtype=torch.int32).to(dev)
            with torch.no_grad():
                logits, _ = pre.fn(params, st.place_params({"tokens": prompt}, b_shard), cache)
            got = logits.full_tensor().float()
            del params, cache, blocks
            if rank == 0:
                with torch.no_grad():
                    one = build_model(cfg, seed=0, device=dev)
                    want = one.prefill({"tokens": prompt}, one.init_cache(B, T))[0].float()
                    del one
                    c32 = dataclasses.replace(cfg, compute_dtype=torch.float32, cache_dtype=torch.float32)
                    one32 = build_model(c32, seed=0, device=dev)
                    ref32 = one32.prefill({"tokens": prompt}, one32.init_cache(B, T))[0].float()
                    del one32
                print(f"{dtype} {layers} layers: prefill logits rel_l2, (1, {mesh.size()}) against one device "
                      f"{_rel(got, want):.3e}; one device against its float32 prefill {_rel(want, ref32):.3e}",
                      flush=True)
            if not args.cpu:
                torch.cuda.empty_cache()
            dist.barrier()
        _grad_witness(args, rank, dev)
    finally:
        dist.destroy_process_group()


def _first_moments(cfg, mesh, dev, rank):
    """Adam's first moment of every leaf after one train step from the
    seeded init on the seeded batch, over ``mesh`` (None: one device),
    whole on rank 0's host (None elsewhere)."""
    from torch.distributed.tensor import DTensor

    from repro_torch import optim
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset, sharded_batches
    from repro_torch.launch import steps as st
    from repro_torch.models import build_model

    shape = ShapeConfig("train", T, TRAIN_B, "train")
    opt_cfg = optim.AdamWConfig(lr=3e-4, clip_norm=0.0, state_dtype=cfg.optim_state_dtype)
    plan = st.make_train_step(cfg, mesh, shape, opt_cfg, device=dev)
    shardings = plan.in_shardings[0] if mesh is not None else None
    blocks = build_model(cfg, seed=0, device=dev, train=True, shardings=shardings).train_params()
    p, o = st.train_state(plan, blocks, opt_cfg)
    ds = SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=T, global_batch=TRAIN_B))
    batch = next(sharded_batches(ds, dev, embeds_cfg=cfg, shardings=plan.in_shardings[2] if mesh else None))
    plan.jitted()(p, o, batch)
    out = {}
    for k, v in o["m"].items():
        w = v.full_tensor() if isinstance(v, DTensor) else v
        if rank == 0:
            out[k] = w.detach().to("cpu", torch.float64)
    return out if rank == 0 else None


def _grad_witness(args, rank, dev) -> None:
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_local_mesh

    world = dist.get_world_size()
    cfg = get_arch("starcoder2-7b")
    cfg = dataclasses.replace(cfg.reduced() if args.cpu else cfg, n_layers=1, compute_dtype=torch.bfloat16,
                              cache_dtype=torch.bfloat16)
    meshes = [(1, world)] + ([(world // 2, 2)] if world >= 4 else [])
    split = {m: _first_moments(cfg, make_local_mesh(model=m[1], data=m[0], device_type=dev), dev, rank)
             for m in meshes}
    if rank == 0:
        one = _first_moments(cfg, None, dev, rank)
        ref = _first_moments(dataclasses.replace(cfg, compute_dtype=torch.float32, cache_dtype=torch.float32),
                             None, dev, rank)

        def stats(a, b):
            r = sorted(_rel(a[k], b[k]) for k in b)
            return f"max {r[-1]:.3e} median {r[len(r) // 2]:.3e}"

        print(f"bfloat16 1 layer, first-step gradients (rel_l2 over {len(ref)} leaves): one device against its "
              f"float32 step {stats(one, ref)}", flush=True)
        for m, g in split.items():
            print(f"bfloat16 1 layer, first-step gradients: {m} against one device's float32 step {stats(g, ref)}; "
                  f"against one device's bfloat16 step {stats(g, one)}", flush=True)
    dist.barrier()


def _card() -> str:
    """The card's name and power limit (``nvidia-smi``), or "no card"."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip().splitlines()
        return out[0] if out else "no card"
    except (OSError, subprocess.SubprocessError):
        return "no card"


if __name__ == "__main__":
    main()
