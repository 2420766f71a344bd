"""Hand-written CUDA tile kernels for blocked Cholesky and LU, with plain
versions.

The leaves of the ``"cuda"`` backend (the paper's cuBLAS wrapper analog).
Nine kernels — POTRF, TRSM, SYRK and GEMM for Cholesky; GETRF, TRSML,
TRSMU, TRSMUL and GEMMNN for pivot-free LU — each serve three forms.  All
nine live in ``csrc/tile_lu_sm90.cu``, one library (``LIBRARY``): POTRF and
GETRF keep their tile in registers, and the other seven split a task over
several CTAs, the four triangular solves by rows or columns of the
right-hand side, SYRK, GEMM and GEMMNN by output tiles on the tensor cores
in 3xTF32; the wrapper chooses that split from the group's size
(``launch_shape``).  The three forms:

- the fused grid form (``grid_*``), the counterpart of the JAX package's
  ``make_grid_fused``: every argument is a resident ``(nr, nc, br, bc)``
  grid plus an ``(n, 2)`` int32 tensor of block indices; the kernel reads
  each task's blocks through them and updates the written argument's grid
  IN PLACE (tasks of one call must write distinct blocks that no other task
  of the call reads, which the planner guarantees).  A call may span
  several segments, each its own grids (a group the planner fused across
  roots): ``grid_*(idxs, [(grids, size), ...])``, the indices' rows segment
  by segment.  On the card it is one launch whatever the segment count up
  to ``MAX_SEGMENTS`` (each argument passes a segment table), consecutive
  launches of at most that many beyond it (``pack_segments``); the plain
  version runs its body once on the segments' concatenated blocks;
- the stacked grid form, the same call on ``(B, nr, nc, br, bc)`` grids
  (``make_grid_fused``'s ``kernel_stacked``): lane ``b`` of every argument
  is one independent workload, all lanes share the index tensors, and the
  kernel runs the B x n (lane, task) pairs;
- the batched form (``batched_*``) on ``(n, br, bc)`` stacks, which returns
  a new stack: the wrapper copies the written stack and runs the same
  kernel on it viewed as an ``(n, 1, br, bc)`` grid with identity indices.

Each argument has its own tile shape; ``_dims`` holds every kernel's shape
contract (the Cholesky four and GETRF take square tiles of one edge,
TRSML/TRSMUL an edge-b triangle and a ``(b, bc)`` right-hand side, TRSMU a
``(br, b)`` one, GEMMNN ``(m, k)``, ``(k, q)`` and ``(m, q)``), every edge
within 1..MAX_TILE, on both devices.

Beside each kernel is its plain PyTorch version (``*_plain``): the same
recurrence as the JAX tile body, over any leading batch dimensions.  The
wrappers run the plain version for tensors on the CPU and launch the kernel
for tensors on a CUDA device — there is no fallback between the two.
``LAUNCHES`` counts unstacked kernel launches per kernel, ``STACKED_LAUNCHES``
stacked ones, and ``SEGMENTED_LAUNCHES`` those of either that span several
segments.

``matmul`` (``csrc/matmul.cu``) is the standalone product C = A B on three
routes that ``matmul_route`` picks by shape: bf16 on ``wgmma`` fed by TMA,
fp32 in 3xTF32 on ``mma.sync``, and the simple kernel for the bf16 shapes
TMA cannot read; ``MATMUL_LAUNCHES`` counts each route.  No drain calls it.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch

from . import _build, ref
from .ref import fp32_matmul

MAX_TILE = 128  # largest tile edge the kernels accept (csrc kMaxB)

# kernel name -> (arity, number of tile dimensions its C entry takes)
_SIGNATURES = {
    "potrf": (1, 1), "trsm": (2, 1), "syrk": (2, 1), "gemm": (3, 1),
    "getrf": (1, 1), "trsml": (2, 2), "trsmu": (2, 2), "trsmul": (2, 2), "gemmnn": (3, 3),
}

MAX_BATCH = 65535  # most lanes of one stacked launch (csrc kMaxBatch, gridDim.y)
MAX_SEGMENTS = 8  # most segments of one launch (csrc kMaxSeg); more run as consecutive launches

# the kernels that cut a task across CTAs: their C entries take one
# launch-shape integer after the tile dimensions
SPLIT = ("trsm", "trsml", "trsmu", "trsmul", "syrk", "gemm", "gemmnn")
# kernel name -> the csrc library that holds its C entry (csrc/tile_lu_sm90.cu)
LIBRARY = {k: "tile_lu_sm90" for k in _SIGNATURES}

# kernel name -> number of launches since the last reset_launches(), of the
# unstacked forms (4-D grids, batched stacks) and of the stacked grid form;
# SEGMENTED_LAUNCHES counts again those of either that span several segments
LAUNCHES: Dict[str, int] = {k: 0 for k in _SIGNATURES}
STACKED_LAUNCHES: Dict[str, int] = {k: 0 for k in _SIGNATURES}
SEGMENTED_LAUNCHES: Dict[str, int] = {k: 0 for k in _SIGNATURES}


def reset_launches() -> None:
    for counts in COUNTERS:
        for k in counts:
            counts[k] = 0


# --------------------------------------------------------------------------
# Plain versions: the JAX tile bodies' recurrences, over leading batch
# dimensions, with float32 matmuls in full float32 on the card (see
# ref.fp32_matmul)
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
        s = (L @ L[..., j, :, None])[..., 0]
        djj = torch.sqrt(a[..., j, j] - s[..., j])
        col = (a[..., :, j] - s) / djj[..., None]
        col = torch.where(idx > j, col, 0.0)
        col[..., j] = djj
        L[..., :, j] = col
    return L


@fp32_matmul()
def trsm_plain(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """X = B inv(L)^T for each pair of tiles."""
    l = l.float()
    b = b.float()
    X = torch.zeros_like(b)
    for j in range(l.shape[-1]):
        # (X L^T)[:, j] = sum_{k<=j} X[:,k] L[j,k]; cols >= j of X still zero
        s = (X @ l[..., j, :, None])[..., 0]
        X[..., :, j] = (b[..., :, j] - s) / l[..., j, j, None]
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


def getrf_plain(a: torch.Tensor) -> torch.Tensor:
    """Pivot-free right-looking LU of each tile, L\\U packed (unit L
    implicit): scale column k below the pivot, then a masked rank-1 update
    of the trailing block.  Written without in-place writes, so it also
    runs under ``torch.func.vmap`` (the ``"torch"`` oracle on the CPU)."""
    m = a.float()
    b = m.shape[-1]
    idx = torch.arange(b, device=m.device)
    for k in range(b):
        col = torch.where(idx > k, m[..., :, k] / m[..., k, k, None], m[..., :, k])
        l = torch.where(idx > k, col, 0.0)
        u = torch.where(idx > k, m[..., k, :], 0.0)
        m = torch.where(idx == k, col[..., :, None], m) - l[..., :, None] * u[..., None, :]
    return m


@fp32_matmul()
def trsml_plain(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """X = inv(L) B, L unit-lower: X[i] = B[i] - L[i] X.  Rows >= i of X are
    still zero, so L's diagonal and upper junk multiply zeros."""
    l = l.float()
    b = b.float()
    X = torch.zeros_like(b)
    for i in range(l.shape[-1]):
        X[..., i, :] = b[..., i, :] - (l[..., i, None, :] @ X)[..., 0, :]
    return X


@fp32_matmul()
def trsmu_plain(u: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """X = B inv(U), U non-unit upper: X[:, j] = (B[:, j] - X U[:, j]) /
    U[j, j].  Columns >= j of X are still zero, masking U's lower junk."""
    u = u.float()
    b = b.float()
    X = torch.zeros_like(b)
    for j in range(u.shape[-1]):
        s = (X @ u[..., :, j, None])[..., 0]
        X[..., :, j] = (b[..., :, j] - s) / u[..., j, j, None]
    return X


@fp32_matmul()
def trsmul_plain(u: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """X = inv(U) B, U non-unit upper, bottom-up: X[i] = (B[i] - U[i] X) /
    U[i, i].  Rows <= i of X are still zero, masking U's lower junk."""
    u = u.float()
    b = b.float()
    X = torch.zeros_like(b)
    nb = u.shape[-1]
    for j in range(nb):
        i = nb - 1 - j
        s = (u[..., i, None, :] @ X)[..., 0, :]
        X[..., i, :] = (b[..., i, :] - s) / u[..., i, i, None]
    return X


@fp32_matmul()
def gemmnn_plain(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """C - A B for each triple of (possibly non-square) tiles."""
    return c.float() - a.float() @ b.float()


Segments = List[Tuple[Tuple[torch.Tensor, ...], int]]


def _segments(idxs: Sequence[torch.Tensor], grids) -> Segments:
    """A fused call's segments: ``grids`` is either one segment's grids (a
    sequence of tensors, every task of ``idxs``) or a sequence of ``(grids,
    size)`` pairs, the indices' rows segment by segment."""
    if len(grids) and isinstance(grids[0], torch.Tensor):
        return [(tuple(grids), idxs[0].shape[0])]
    return [(tuple(g), int(size)) for g, size in grids]


def _grid_plain(body, write_arg: int):
    """Plain fused grid form: gather the blocks, apply ``body``, write the
    result back into the written argument's grid in place.  Each argument's
    blocks are gathered segment by segment and joined, as the launch list's
    gather path joins them, the body runs once on the joined stack, and each
    segment's rows go back into its own grid: the same bits as that path.
    On stacked ``(B, nr, nc, br, bc)`` grids every lane gathers the same
    blocks (``g[:, ix0, ix1]``), the body runs once on the flattened
    ``(B * n)`` stack, and the result is written back lane by lane.  Returns
    the (first segment's) written grid."""

    def call(idxs: Sequence[torch.Tensor], grids) -> torch.Tensor:
        segments = _segments(idxs, grids)
        stacked = segments[0][0][0].dim() == 5
        bounds, off = [], 0
        for _, size in segments:
            bounds.append((off, off + size))
            off += size
        tiles = []
        for a, ix in enumerate(idxs):
            parts = [g[a][:, ix[lo:hi, 0], ix[lo:hi, 1]] if stacked else g[a][ix[lo:hi, 0], ix[lo:hi, 1]]
                     for (g, _), (lo, hi) in zip(segments, bounds)]
            stack = torch.cat(parts, dim=1 if stacked else 0)
            tiles.append(stack.flatten(0, 1) if stacked else stack)
        out = body(*tiles)
        if stacked:
            out = out.reshape(segments[0][0][0].shape[0], off, *out.shape[1:])
        ix = idxs[write_arg]
        for (g, _), (lo, hi) in zip(segments, bounds):
            w = g[write_arg]
            if stacked:
                w[:, ix[lo:hi, 0], ix[lo:hi, 1]] = out[:, lo:hi].to(w.dtype)
            else:
                w.index_put_((ix[lo:hi, 0], ix[lo:hi, 1]), out[lo:hi].to(w.dtype))
        return segments[0][0][write_arg]

    return call


grid_potrf_plain = _grid_plain(potrf_plain, 0)
grid_trsm_plain = _grid_plain(trsm_plain, 1)
grid_syrk_plain = _grid_plain(syrk_plain, 1)
grid_gemm_plain = _grid_plain(gemm_plain, 2)
grid_getrf_plain = _grid_plain(getrf_plain, 0)
grid_trsml_plain = _grid_plain(trsml_plain, 1)
grid_trsmu_plain = _grid_plain(trsmu_plain, 1)
grid_trsmul_plain = _grid_plain(trsmul_plain, 1)
grid_gemmnn_plain = _grid_plain(gemmnn_plain, 2)


# --------------------------------------------------------------------------
# Shape contracts
# --------------------------------------------------------------------------
def tile_shapes(name: str, b: int, bc: int) -> List[Tuple[int, int]]:
    """Per-argument tile shapes that fit ``name``'s contract at edge ``b``
    and right-hand-side width ``bc`` (the square kernels ignore ``bc``)."""
    wide = {
        "trsml": [(b, b), (b, bc)],
        "trsmul": [(b, b), (b, bc)],
        "trsmu": [(b, b), (bc, b)],
        "gemmnn": [(b, b), (b, bc), (b, bc)],
    }
    return wide.get(name, [(b, b)] * _SIGNATURES[name][0])


def _dims(name: str, shapes: Sequence[Tuple[int, int]]) -> Tuple[int, ...]:
    """The integer dimensions the C entry of ``name`` takes after the task
    count, from each argument's ``(rows, cols)`` tile shape; raises
    ``ValueError`` on a shape the kernel does not take.  Every edge must be
    in 1..MAX_TILE, and the plain versions keep the same limit so both
    devices agree."""
    for r, c in shapes:
        for e in (r, c):
            if not 1 <= e <= MAX_TILE:
                raise ValueError(f"tile edge {e} outside the kernels' limit 1..{MAX_TILE}")
    if name in ("trsml", "trsmul"):
        (b, b2), (rb, bc) = shapes
        ok, dims = b == b2 == rb, (b, bc)
    elif name == "trsmu":
        (b, b2), (br, cb) = shapes
        ok, dims = b == b2 == cb, (br, b)
    elif name == "gemmnn":
        (m, k), (k2, q), (m2, q2) = shapes
        ok, dims = (k, m, q) == (k2, m2, q2), (m, k, q)
    else:
        b = shapes[0][0]
        ok, dims = all(s == (b, b) for s in shapes), (b,)
    if not ok:
        raise ValueError(f"{name}: tile shapes {list(shapes)} do not fit its contract")
    return dims


def launch_shape(name: str, shapes: Sequence[Tuple[int, int]], n: int, batch: int, sms: int) -> Tuple[int, ...]:
    """The launch-shape integers the C entry of ``name`` takes after its tile
    dimensions, for ``n`` tasks of tile ``shapes`` over ``batch`` lanes on a
    card of ``sms`` SMs; raises ``ValueError`` as ``_dims`` does.

    TRSMU and TRSM take the rows of B one CTA solves: 32, or 16 where 32
    would leave SMs without a CTA.  TRSML and TRSMUL take their columns of B:
    16 where bc <= 16 or where CTAs of 16 all fit on the SMs at once, else 32
    (which stage the triangle half as often).  GEMMNN, SYRK and GEMM take
    their output tile: 64 (64 x 64 tiles) where those give every SM a CTA, or
    32; GEMMNN takes 0 (the matrix-vector mapping) for q < 8.  GETRF and
    POTRF take none."""
    dims = _dims(name, shapes)
    if name in ("trsmu", "trsm"):
        br = dims[0]
        return (32 if n * batch * -(-br // 32) >= sms else 16,)
    if name in ("trsml", "trsmul"):
        bc = dims[1]
        return (32 if bc > 16 and n * batch * -(-bc // 16) > sms else 16,)
    if name in ("gemmnn", "syrk", "gemm"):
        m, q = (dims[0], dims[2]) if name == "gemmnn" else (dims[0], dims[0])
        if name == "gemmnn" and q < 8:
            return (0,)
        return (64 if n * batch * -(-m // 64) * -(-q // 64) >= sms else 32,)
    return ()


# --------------------------------------------------------------------------
# Kernel launch
# --------------------------------------------------------------------------
_VP, _I = ctypes.c_void_p, ctypes.c_int
# C entry tile_<name>(per arg: segment table, idx; nseg; n; batch; dims...;
# launch shape (SPLIT); stream)
_ARGTYPES = {
    name: [_VP, _VP] * arity + [_I] * (3 + n_dims + (name in SPLIT)) + [_VP]
    for name, (arity, n_dims) in _SIGNATURES.items()
}


_FNS: Dict[str, object] = {}
_SMS: Dict[int, int] = {}  # device index -> its SM count


def _kernel_fn(name: str):
    """The C entry ``tile_<name>``, with its argument types declared (its
    library is built and loaded on first use)."""
    fn = _FNS.get(name)
    if fn is None:
        lib = _build.load(LIBRARY[name])
        for k, argtypes in _ARGTYPES.items():
            if LIBRARY[k] == LIBRARY[name]:
                f = getattr(lib, f"tile_{k}")
                f.argtypes = argtypes
                f.restype = ctypes.c_int
                _FNS[k] = f
        fn = _FNS[name]
    return fn


def sm_count(device: torch.device) -> int:
    """The SM count of a CUDA ``device``, which ``launch_shape`` takes."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]


def _lanes(grids: Sequence[torch.Tensor]) -> int:
    """The lane count of a fused call: 1 for ``(nr, nc, br, bc)`` grids, B
    for stacked ``(B, nr, nc, br, bc)`` ones, which every argument must
    share; raises ``ValueError`` on anything else."""
    dims = {g.dim() for g in grids}
    if dims == {4}:
        return 1
    if dims != {5}:
        raise ValueError(
            "grids must all be (nr, nc, br, bc) or all (B, nr, nc, br, bc), "
            f"got shapes {[tuple(g.shape) for g in grids]}"
        )
    lanes = {g.shape[0] for g in grids}
    if len(lanes) != 1:
        raise ValueError(f"stacked grids disagree on the lane count: {sorted(lanes)}")
    batch = lanes.pop()
    if not 1 <= batch <= MAX_BATCH:
        raise ValueError(f"lane count {batch} outside the kernels' limit 1..{MAX_BATCH}")
    return batch


def _segment_dims(name: str, idxs: Sequence[torch.Tensor], segments: Segments) -> Tuple[int, ...]:
    """The kernel's dims for a fused call's segments, on either device: one
    grid an argument in every segment, every segment's tiles in ``name``'s
    contract and alike, one lane count, and segment sizes that add up to
    the indices' rows; raises ``ValueError`` otherwise."""
    _lanes([g for grids, _ in segments for g in grids])
    dims = None
    for grids, size in segments:
        if len(grids) != len(idxs) or size < 0:
            raise ValueError(f"a segment of {size} tasks over {len(grids)} grids, for {len(idxs)} index tensors")
        seg_dims = _dims(name, [tuple(g.shape[-2:]) for g in grids])
        if dims is not None and seg_dims != dims:
            raise ValueError(f"{name}: segments disagree on their tiles: {dims} and {seg_dims}")
        dims = seg_dims
    n = idxs[0].shape[0]
    if sum(size for _, size in segments) != n:
        raise ValueError(f"segments of {[size for _, size in segments]} tasks for {n} block indices")
    return dims


def _check(name: str, idxs: Sequence[torch.Tensor], segments: Segments) -> Tuple[int, ...]:
    """Validate one fused call's arguments for the card, every segment's
    grids; returns the kernel's dims."""
    dev = segments[0][0][0].device
    if dev.type != "cuda":
        raise ValueError(f"the tile kernels run on CUDA tensors, got {dev}")
    dims = _segment_dims(name, idxs, segments)
    n = idxs[0].shape[0]
    for grids, _ in segments:
        for g in grids:
            if g.device != dev or g.dtype != torch.float32:
                raise ValueError(
                    f"grids must be float32 tensors on {dev}, "
                    f"got {g.dtype} {tuple(g.shape)} on {g.device}"
                )
            if not g.is_contiguous():
                raise ValueError(f"grid {tuple(g.shape)} is not contiguous")
    for ix in idxs:
        if ix.device != dev or ix.dtype != torch.int32 or tuple(ix.shape) != (n, 2):
            raise ValueError(
                f"block indices must be ({n}, 2) int32 on {dev}, "
                f"got {ix.dtype} {tuple(ix.shape)} on {ix.device}"
            )
        if not ix.is_contiguous():
            raise ValueError("block indices must be contiguous")
    return dims


def pack_segments(sizes: Sequence[int]) -> List[Tuple[int, int, Tuple[Tuple[int, int], ...]]]:
    """A group's launches, from its segments' task counts: at most
    ``MAX_SEGMENTS`` non-empty segments a launch, in order.  Each launch is
    (its first task in the group, its task count, and per segment (the
    segment's index, its first task within the launch)); together they
    cover every task once."""
    launches, members, first, count = [], [], 0, 0
    for k, size in enumerate(sizes):
        if size <= 0:
            continue
        if len(members) == MAX_SEGMENTS:
            launches.append((first, count, tuple(members)))
            members, first, count = [], first + count, 0
        members.append((k, count))
        count += size
    if members:
        launches.append((first, count, tuple(members)))
    return launches


def _launch(name: str, idxs: Sequence[torch.Tensor], segments: Segments) -> None:
    dims = _check(name, idxs, segments)
    grids0 = segments[0][0]
    stacked = grids0[0].dim() == 5
    batch = grids0[0].shape[0] if stacked else 1
    shapes = [tuple(g.shape[-2:]) for g in grids0]
    device = grids0[0].device
    stream = torch.cuda.current_stream(device).cuda_stream
    for first, count, members in pack_segments([size for _, size in segments]):
        args = []
        for a, ix in enumerate(idxs):
            table = []
            for k, start in members:
                g = segments[k][0][a]
                table += [g.data_ptr(), g.shape[-3], g.stride(0) if stacked else 0, start]
            # the launch's rows of the indices: 8 bytes a task
            args += [(ctypes.c_longlong * len(table))(*table), ix.data_ptr() + 8 * first]
        shape = launch_shape(name, shapes, count, batch, sm_count(device)) if name in SPLIT else ()
        with torch.cuda.device(device):
            err = _kernel_fn(name)(*args, len(members), count, batch, *dims, *shape, stream)
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
        (STACKED_LAUNCHES if stacked else LAUNCHES)[name] += 1
        if len(members) > 1:
            SEGMENTED_LAUNCHES[name] += 1


def _fused(name: str, write_arg: int, plain):
    def call(idxs: Sequence[torch.Tensor], grids) -> torch.Tensor:
        segments = _segments(idxs, grids)
        if segments[0][0][write_arg].device.type == "cpu":
            _segment_dims(name, idxs, segments)
            return plain(idxs, segments)
        _launch(name, idxs, segments)
        return segments[0][0][write_arg]

    call.__name__ = f"grid_{name}"
    call.__doc__ = (
        f"Fused {name.upper()} over resident grids (4-D, or stacked 5-D with "
        f"one lane per workload), in place in grid {write_arg}: ``grids`` are "
        f"one segment's grids, or (grids, size) segments; CUDA kernel on the "
        f"card, plain version on the CPU."
    )
    return call


grid_potrf = _fused("potrf", 0, grid_potrf_plain)
grid_trsm = _fused("trsm", 1, grid_trsm_plain)
grid_syrk = _fused("syrk", 1, grid_syrk_plain)
grid_gemm = _fused("gemm", 2, grid_gemm_plain)
grid_getrf = _fused("getrf", 0, grid_getrf_plain)
grid_trsml = _fused("trsml", 1, grid_trsml_plain)
grid_trsmu = _fused("trsmu", 1, grid_trsmu_plain)
grid_trsmul = _fused("trsmul", 1, grid_trsmul_plain)
grid_gemmnn = _fused("gemmnn", 2, grid_gemmnn_plain)


def _batched(name: str, grid_call, write_arg: int, plain):
    def call(*stacks: torch.Tensor) -> torch.Tensor:
        if stacks[write_arg].device.type == "cpu":
            _dims(name, [tuple(s.shape[-2:]) for s in stacks])
            return plain(*stacks)
        n = stacks[0].shape[0]
        ident = torch.zeros((n, 2), dtype=torch.int32, device=stacks[0].device)
        ident[:, 0] = torch.arange(n, dtype=torch.int32, device=stacks[0].device)
        grids = [s.float().contiguous().unsqueeze(1) for s in stacks]
        grids[write_arg] = grids[write_arg].clone()
        grid_call([ident] * len(stacks), grids)
        return grids[write_arg][:, 0]

    call.__name__ = f"batched_{name}"
    return call


batched_potrf = _batched("potrf", grid_potrf, 0, potrf_plain)
batched_trsm = _batched("trsm", grid_trsm, 1, trsm_plain)
batched_syrk = _batched("syrk", grid_syrk, 1, syrk_plain)
batched_gemm = _batched("gemm", grid_gemm, 2, gemm_plain)
batched_getrf = _batched("getrf", grid_getrf, 0, getrf_plain)
batched_trsml = _batched("trsml", grid_trsml, 1, trsml_plain)
batched_trsmu = _batched("trsmu", grid_trsmu, 1, trsmu_plain)
batched_trsmul = _batched("trsmul", grid_trsmul, 1, trsmul_plain)
batched_gemmnn = _batched("gemmnn", grid_gemmnn, 2, gemmnn_plain)

# op name -> (fused call, write_arg); consumed by ``build_program``
# when the backend is 'cuda' and the group writes exactly that argument,
# whatever its segment count: the call takes the group's (grids, size)
# segments.
GRID_FUSED = {
    "potrf": (grid_potrf, 0),
    "trsm": (grid_trsm, 1),
    "syrk": (grid_syrk, 1),
    "gemm": (grid_gemm, 2),
    "getrf": (grid_getrf, 0),
    "trsml": (grid_trsml, 1),
    "trsmu": (grid_trsmu, 1),
    "trsmul": (grid_trsmul, 1),
    "gemmnn": (grid_gemmnn, 2),
}


# --------------------------------------------------------------------------
# General matmul (``csrc/matmul.cu``, replacing the JAX package's
# ``_matmul_kernel`` / ``matmul``): standalone, on no drain path.  Its own
# source, so that editing it rebuilds nothing of the nine tile kernels.
# --------------------------------------------------------------------------
WGMMA, TF32X3, SIMPLE = "wgmma", "tf32x3", "simple"
# route -> launches since the last reset_launches()
MATMUL_LAUNCHES: Dict[str, int] = {WGMMA: 0, TF32X3: 0, SIMPLE: 0}

# every launch counter of this module; a captured launch list (whose replay
# makes no Python launch) adds its recorded tally to these
COUNTERS = (LAUNCHES, STACKED_LAUNCHES, SEGMENTED_LAUNCHES, MATMUL_LAUNCHES)


matmul_plain = ref.matmul  # C = A B in float32, cast to A's dtype


def matmul_route(dtype: torch.dtype, m: int, k: int, n: int, aligned: bool) -> str:
    """The kernel a call on the card takes: ``WGMMA`` for bfloat16 that TMA
    can read (k and n multiples of 8, 16-byte ``aligned`` bases), ``TF32X3``
    for float32 at any shape, ``SIMPLE`` for the other bfloat16 shapes."""
    if dtype == torch.float32:
        return TF32X3
    if k % 8 == 0 and n % 8 == 0 and aligned:
        return WGMMA
    return SIMPLE


_MATMUL_FNS: Dict[str, object] = {}


def _matmul_fn(route: str):
    fn = _MATMUL_FNS.get(route)
    if fn is None:
        lib = _build.load("matmul")
        for name in (WGMMA, TF32X3, SIMPLE):
            f = getattr(lib, f"matmul_{name}")
            f.argtypes = [_VP, _VP, _VP, _I, _I, _I, _VP]
            f.restype = ctypes.c_int
            _MATMUL_FNS[name] = f
        fn = _MATMUL_FNS[route]
    return fn


def _matmul_launch(route: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One launch of ``route``'s kernel on checked contiguous CUDA tensors;
    raises on a failed launch."""
    (m, k), n = a.shape, b.shape[1]
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = _matmul_fn(route)(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, stream)
    if err != 0:
        raise RuntimeError(f"matmul ({route} kernel) launch failed: error {err} (a CUDA error code; 10000 + a "
                           f"CUresult: a TMA tensor map was refused; 20000: no tensor-map encoder)")
    MATMUL_LAUNCHES[route] += 1
    return c


def matmul(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128, bn: int = 128, bk: int = 128) -> torch.Tensor:
    """C = A B with a float32 accumulator, in A's dtype (float32 or
    bfloat16).  The blocks keep the JAX kernel's divisibility contract
    (each dimension a multiple of its block, clipped to the dimension);
    the CUDA kernels tile on their own and mask their edges.  On the card
    the route ``matmul_route`` names; plain version on the CPU."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul needs (m, k) @ (k, n), got {tuple(a.shape)} @ {tuple(b.shape)}")
    (m, k), n = a.shape, b.shape[1]
    bm, bn, bk = min(bm, m), min(bn, n), min(bk, k)
    if m % bm or n % bn or k % bk:
        raise ValueError(f"{tuple(a.shape)} @ {tuple(b.shape)} not divisible by blocks ({bm}, {bn}, {bk})")
    if a.dtype != b.dtype or a.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"a and b must share float32 or bfloat16, got {a.dtype}, {b.dtype}")
    if a.device.type == "cpu":
        return matmul_plain(a, b)
    if a.device != b.device or a.device.type != "cuda":
        raise ValueError(f"a and b must lie on one CUDA device, got {a.device}, {b.device}")
    a, b = a.contiguous(), b.contiguous()
    aligned = a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    return _matmul_launch(matmul_route(a.dtype, m, k, n, aligned), a, b)
