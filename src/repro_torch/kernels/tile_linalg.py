"""Hand-written CUDA tile kernels for blocked Cholesky, with plain versions.

The leaves of the ``"cuda"`` backend (the paper's cuBLAS wrapper analog).
Four kernels in ``csrc/tile_linalg.cu`` — POTRF, TRSM, SYRK and GEMM —
each serve two forms:

- the fused grid form (``grid_*``), the counterpart of the JAX package's
  ``make_grid_fused``: every argument is a resident ``(nr, nc, b, b)`` grid
  plus an ``(n, 2)`` int32 tensor of block indices; the kernel reads each
  task's blocks through them and updates the written argument's grid IN
  PLACE (one CTA per task; tasks of one call must write distinct blocks
  that no other task of the call reads, which the planner guarantees);
- the batched form (``batched_*``) on ``(n, b, b)`` stacks, which returns a
  new stack: the wrapper copies the written stack and runs the same kernel
  on it viewed as an ``(n, 1, b, b)`` grid with identity indices.

Beside each kernel is its plain PyTorch version (``*_plain``): the same
column recurrence as the JAX tile body, batched over the stack.  The
wrappers run the plain version for tensors on the CPU and launch the kernel
for tensors on a CUDA device — there is no fallback between the two.
``LAUNCHES`` counts kernel launches per kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import torch

from . import _build
from .ref import fp32_matmul

MAX_TILE = 128  # largest tile edge the kernels accept (csrc kMaxB)

# kernel name -> number of launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {"potrf": 0, "trsm": 0, "syrk": 0, "gemm": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------------
# Plain versions: the JAX tile bodies' recurrences, batched over (n, b, b),
# with float32 matmuls in full float32 on the card (see ref.fp32_matmul)
# --------------------------------------------------------------------------
@fp32_matmul()
def potrf_plain(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of each tile, zeros above the diagonal."""
    a = a.float()
    b = a.shape[-1]
    idx = torch.arange(b, device=a.device)
    L = torch.zeros_like(a)
    for j in range(b):
        # s[i] = sum_{k<j} L[i,k] * L[j,k]  (columns >= j of L are still zero)
        s = (L @ L[:, j, :, None])[..., 0]
        djj = torch.sqrt(a[:, j, j] - s[:, j])
        col = (a[:, :, j] - s) / djj[:, None]
        col = torch.where(idx > j, col, 0.0)
        col[:, j] = djj
        L[:, :, j] = col
    return L


@fp32_matmul()
def trsm_plain(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """X = B inv(L)^T for each pair of tiles."""
    l = l.float()
    b = b.float()
    X = torch.zeros_like(b)
    for j in range(l.shape[-1]):
        # (X L^T)[:, j] = sum_{k<=j} X[:,k] L[j,k]; cols >= j of X still zero
        s = (X @ l[:, j, :, None])[..., 0]
        X[:, :, j] = (b[:, :, j] - s) / l[:, j, j, None]
    return X


@fp32_matmul()
def syrk_plain(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """C - A A^T for each pair of tiles, float32 accumulate."""
    a = a.float()
    return c.float() - a @ a.mT


@fp32_matmul()
def gemm_plain(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """C - A B^T for each triple of tiles, float32 accumulate."""
    return c.float() - a.float() @ b.float().mT


def _grid_plain(body, write_arg: int):
    """Plain fused grid form: gather the blocks, apply ``body``, write the
    result back into the written argument's grid in place."""

    def call(idxs: Sequence[torch.Tensor], grids: Sequence[torch.Tensor]) -> torch.Tensor:
        tiles = [g[ix[:, 0], ix[:, 1]] for ix, g in zip(idxs, grids)]
        w, ix = grids[write_arg], idxs[write_arg]
        w.index_put_((ix[:, 0], ix[:, 1]), body(*tiles).to(w.dtype))
        return w

    return call


grid_potrf_plain = _grid_plain(potrf_plain, 0)
grid_trsm_plain = _grid_plain(trsm_plain, 1)
grid_syrk_plain = _grid_plain(syrk_plain, 1)
grid_gemm_plain = _grid_plain(gemm_plain, 2)


# --------------------------------------------------------------------------
# Kernel launch
# --------------------------------------------------------------------------
_VP, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "potrf": [_VP, _I, _VP, _I, _I, _VP],
    "trsm": [_VP, _I, _VP] * 2 + [_I, _I, _VP],
    "syrk": [_VP, _I, _VP] * 2 + [_I, _I, _VP],
    "gemm": [_VP, _I, _VP] * 3 + [_I, _I, _VP],
}


_FNS: Dict[str, object] = {}


def _kernel_fn(name: str):
    """The C entry ``tile_<name>``, with its argument types declared (the
    library is built and loaded on first use)."""
    fn = _FNS.get(name)
    if fn is None:
        lib = _build.load("tile_linalg")
        for k, argtypes in _ARGTYPES.items():
            f = getattr(lib, f"tile_{k}")
            f.argtypes = argtypes
            f.restype = ctypes.c_int
            _FNS[k] = f
        fn = _FNS[name]
    return fn


def _tile_edge(t: torch.Tensor) -> int:
    """The tile edge of a grid or stack; the kernels take 1..MAX_TILE, and
    the plain versions keep the same limit so both devices agree."""
    b = t.shape[-1]
    if not 1 <= b <= MAX_TILE:
        raise ValueError(f"tile edge {b} outside the kernels' limit 1..{MAX_TILE}")
    return b


def _check(idxs: Sequence[torch.Tensor], grids: Sequence[torch.Tensor]) -> int:
    """Validate one fused call's arguments; returns the tile edge."""
    dev = grids[0].device
    if dev.type != "cuda":
        raise ValueError(f"the tile kernels run on CUDA tensors, got {dev}")
    b = _tile_edge(grids[0])
    n = idxs[0].shape[0]
    for g in grids:
        if g.device != dev or g.dtype != torch.float32 or g.dim() != 4:
            raise ValueError(
                f"grids must be float32 (nr, nc, b, b) tensors on {dev}, "
                f"got {g.dtype} {tuple(g.shape)} on {g.device}"
            )
        if tuple(g.shape[-2:]) != (b, b) or not g.is_contiguous():
            raise ValueError(f"grid {tuple(g.shape)} is not a contiguous grid of {b}x{b} tiles")
    for ix in idxs:
        if ix.device != dev or ix.dtype != torch.int32 or tuple(ix.shape) != (n, 2):
            raise ValueError(
                f"block indices must be ({n}, 2) int32 on {dev}, "
                f"got {ix.dtype} {tuple(ix.shape)} on {ix.device}"
            )
        if not ix.is_contiguous():
            raise ValueError("block indices must be contiguous")
    return b


def _launch(name: str, idxs: Sequence[torch.Tensor], grids: Sequence[torch.Tensor]) -> None:
    b = _check(idxs, grids)
    n = idxs[0].shape[0]
    if n == 0:
        return
    args = []
    for ix, g in zip(idxs, grids):
        args += [g.data_ptr(), g.shape[1], ix.data_ptr()]
    stream = torch.cuda.current_stream(grids[0].device).cuda_stream
    with torch.cuda.device(grids[0].device):
        err = _kernel_fn(name)(*args, n, b, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def _fused(name: str, write_arg: int, plain):
    def call(idxs: Sequence[torch.Tensor], grids: Sequence[torch.Tensor]) -> torch.Tensor:
        _tile_edge(grids[write_arg])
        if grids[write_arg].device.type == "cpu":
            return plain(idxs, grids)
        _launch(name, idxs, grids)
        return grids[write_arg]

    call.__name__ = f"grid_{name}"
    call.__doc__ = (
        f"Fused {name.upper()} over resident grids, in place in grid "
        f"{write_arg}; CUDA kernel on the card, plain version on the CPU."
    )
    return call


grid_potrf = _fused("potrf", 0, grid_potrf_plain)
grid_trsm = _fused("trsm", 1, grid_trsm_plain)
grid_syrk = _fused("syrk", 1, grid_syrk_plain)
grid_gemm = _fused("gemm", 2, grid_gemm_plain)


def _batched(grid_call, write_arg: int, plain):
    def call(*stacks: torch.Tensor) -> torch.Tensor:
        _tile_edge(stacks[write_arg])
        if stacks[write_arg].device.type == "cpu":
            return plain(*stacks)
        n = stacks[0].shape[0]
        ident = torch.zeros((n, 2), dtype=torch.int32, device=stacks[0].device)
        ident[:, 0] = torch.arange(n, dtype=torch.int32, device=stacks[0].device)
        grids = [s.float().contiguous().unsqueeze(1) for s in stacks]
        grids[write_arg] = grids[write_arg].clone()
        grid_call([ident] * len(stacks), grids)
        return grids[write_arg][:, 0]

    return call


batched_potrf = _batched(grid_potrf, 0, potrf_plain)
batched_trsm = _batched(grid_trsm, 1, trsm_plain)
batched_syrk = _batched(grid_syrk, 1, syrk_plain)
batched_gemm = _batched(grid_gemm, 2, gemm_plain)

# op name -> (fused call, write_arg); consumed by ``build_program``
# when the backend is 'cuda' and the group writes exactly that argument.
GRID_FUSED = {
    "potrf": (grid_potrf, 0),
    "trsm": (grid_trsm, 1),
    "syrk": (grid_syrk, 1),
    "gemm": (grid_gemm, 2),
}
