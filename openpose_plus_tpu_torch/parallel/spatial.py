"""The spatial mesh axis: the image height sharded over ranks, with the
rows a conv reads beyond a rank's band exchanged between ranks.

The JAX package shards images over a (data, spatial) mesh and lets GSPMD
partition the convolutions and insert their halo exchanges
(`openpose_plus_tpu/parallel/sharding.py`). Here each rank of the spatial
axis runs the model on its band of rows, and the band-aware ops of
`models/common.py` call into this module:

  * bands on the output grid: spatial rank s of n owns output rows
    [s*hout//n, (s+1)*hout//n), and at a layer of stride 2^l (l = 0 for the
    image, log2(stride) for the output grid) those rows times
    stride / 2^l. Every level's band is then aligned (a 2x2 pool or a
    stride-2 conv never straddles two ranks), each level's global height is
    hout times its scale, known without a collective, and the band's scale
    at a layer is its local height over its output rows. Uneven bands (hout
    not divisible by n) work; a rank owns at least one output row;
  * `conv_rows` (`conv2d_same` under a band): the rows a SAME conv reads
    for its output band, this rank's own rows with the rows beyond them
    taken from the ranks that own them (`HaloExchange`) and zeros beyond
    the global top and bottom, so the conv runs unpadded along H. Only
    boundary rows move, however wide the halo: a 7x7 conv on bands of 2
    rows reads rows of the next two ranks. Stride-2 convs on even heights
    pad (0, 1) and read one row from below;
  * `check_pool` (`maxpool2x2` under a band): a 2x2 pool is band-local on
    aligned bands, and raises on the output grid, where it is not;
  * `gather_rows`: the heads' output bands all-gathered along H into full
    maps (the loss runs on the full maps, as the reference's `map_sharding`
    keeps them); its backward keeps this rank's band of the gradient;
  * `band_forward`: the model called once under the band, then the map
    gather. 1x1 convs, elementwise ops and the concats stay band-local.

The collectives are `all_to_all_single` with per-rank splits (the halo
rows, as bytes) and `all_gather_into_tensor` (the maps): both run on NCCL
and on gloo with CUDA tensors. Under gloo a CUDA tensor passes through
host memory inside gloo's CUDA work; under NCCL it stays on the device.

A rank's parameter gradients are its band's share; the sum over the
spatial axis is the gradient of the full image (`parallel.kungfu`'s
sync-sgd sums over the mesh and divides by the data axis). `STATS` counts
what the exchanges and gathers move on this rank (`parallel.spatial.*`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from openpose_plus_tpu_torch.parallel import sharding as S

# this rank's traffic: exchanges (forward and backward), the elements and
# bytes it received in them, the map gathers and the bytes they brought;
# with `timed`, the seconds spent in each, the device synchronised around
# every call (instrumented runs only)
STATS = {"halo_calls": 0, "halo_elements": 0, "halo_bytes": 0,
         "halo_seconds": 0.0, "gather_calls": 0, "gather_bytes": 0,
         "gather_seconds": 0.0}
_TIMED = [False]
_ACTIVE: list[Optional["Band"]] = [None]


def reset_stats(timed: bool = False) -> None:
    """Zero `STATS`; with `timed`, the exchanges and gathers that follow
    synchronise the device around their collectives and add their wall
    time."""
    for k, v in STATS.items():
        STATS[k] = type(v)()
    _TIMED[0] = timed


def check_geometry(hin: int, stride: int, n: int) -> int:
    """hout = hin / stride for `n` spatial ranks, after the band rule's
    checks: hin divisible by the stride, and a row of the output grid for
    every rank."""
    if n > 1 and hin % stride:
        raise ValueError(f"spatial_parallelism={n}: the image height {hin} "
                         f"is not divisible by the output stride {stride}")
    hout = hin // stride
    if hout < n:
        raise ValueError(f"spatial_parallelism={n}: the output grid has "
                         f"{hout} rows, fewer than the {n} spatial ranks")
    return hout


def bands(hout: int, n: int) -> list[tuple[int, int]]:
    """Each spatial rank's [lo, hi) of the output grid's rows."""
    return [(s * hout // n, (s + 1) * hout // n) for s in range(n)]


@dataclasses.dataclass(frozen=True)
class _Plan:
    """One exchange as one rank sees it, at a layer of `scale` rows a grid
    row: `send` (dest, first, stop) of its local rows that each other rank
    reads, `recv` (source, first, stop) of the global rows it reads from
    each other rank; both in rank order."""

    scale: int
    send: tuple[tuple[int, int, int], ...]
    recv: tuple[tuple[int, int, int], ...]


@dataclasses.dataclass(frozen=True, eq=False)
class Band:
    """Spatial rank `index` of `size` (process group `group`) on an output
    grid of `hout` rows, `stride` image rows a grid row."""

    index: int
    size: int
    group: Any
    hout: int
    stride: int

    def __post_init__(self):
        object.__setattr__(self, "rows", bands(self.hout, self.size))
        object.__setattr__(self, "_plans", {})

    @property
    def lo(self) -> int:
        return self.rows[self.index][0]

    @property
    def hi(self) -> int:
        return self.rows[self.index][1]

    def scale(self, h: int) -> int:
        """Rows a grid row at a layer whose local height is `h`."""
        own = self.hi - self.lo
        scale = h // own
        if h % own or scale & (scale - 1) or scale > self.stride:
            raise ValueError(f"spatial rank {self.index}: a layer of {h} "
                             f"rows is not its band of {own} output rows "
                             f"at any stride up to {self.stride}")
        return scale

    def needed(self, s: int, scale: int, kernel: int, stride: int,
               top: int) -> tuple[int, int]:
        """[first, stop) of the global rows, at the conv's input level,
        that rank s's output band of a SAME conv reads."""
        lo, hi = self.rows[s]
        out = scale // stride
        return lo * out * stride - top, (hi * out - 1) * stride - top + kernel

    def _reads(self, s: int, j: int, scale: int, key: tuple
               ) -> tuple[int, int]:
        """[first, stop) of rank j's rows that rank s reads (empty if
        first >= stop)."""
        first, stop = self.needed(s, scale, *key)
        return (max(first, self.rows[j][0] * scale),
                min(stop, self.rows[j][1] * scale))

    def plan(self, scale: int, kernel: int, stride: int, top: int) -> _Plan:
        key = (kernel, stride, top)
        if (scale, key) not in self._plans:
            me, a = self.index, self.lo * scale
            send, recv = [], []
            for j in range(self.size):
                if j == me:
                    continue
                lo, hi = self._reads(j, me, scale, key)
                if lo < hi:
                    send.append((j, lo - a, hi - a))
                lo, hi = self._reads(me, j, scale, key)
                if lo < hi:
                    recv.append((j, lo, hi))
            self._plans[scale, key] = _Plan(scale, tuple(send), tuple(recv))
        return self._plans[scale, key]

    def reads_own_rows(self, scale: int, kernel: int, stride: int,
                       top: int) -> bool:
        """Whether every rank's output band of this conv reads exactly its
        own rows (a 1x1 conv): the same answer on every rank, so all of
        them exchange or none does."""
        return all(self.needed(s, scale, kernel, stride, top)
                   == (lo * scale, hi * scale)
                   for s, (lo, hi) in enumerate(self.rows))


def active() -> Optional[Band]:
    """The band the model is running under, or None."""
    return _ACTIVE[0]


@contextlib.contextmanager
def use(band: Optional[Band]):
    """Run the enclosed model code on `band` (None: unsharded)."""
    saved = _ACTIVE[0]
    _ACTIVE[0] = band
    try:
        yield band
    finally:
        _ACTIVE[0] = saved


def keep_band(fn: Callable) -> Callable:
    """`fn` bound to the band active now: it runs under that band whenever
    it is called, also when `torch.utils.checkpoint` recomputes it in the
    backward pass, after the forward's `use` has exited."""
    band = active()

    @functools.wraps(fn)
    def run(*args, **kw):
        with use(band):
            return fn(*args, **kw)

    return run


@contextlib.contextmanager
def _timed(key: str, device: torch.device):
    if not _TIMED[0]:
        yield
        return
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda *a: None))
    sync(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        sync(device)
        STATS[key] += time.perf_counter() - t0


def _wire(t: torch.Tensor) -> torch.Tensor:
    """An NCHW row block as flat bytes, in NHWC order (a channels-last
    tensor's own order)."""
    return t.permute(0, 2, 3, 1).contiguous().view(-1).view(torch.uint8)


def _unwire(buf: torch.Tensor, shape: torch.Size, dtype: torch.dtype,
            rows: int) -> torch.Tensor:
    b, c, _, w = shape
    return buf.view(dtype).view(b, rows, w, c).permute(0, 3, 1, 2)


def _exchange(group, send: list[torch.Tensor], send_splits: list[int],
              recv_splits: list[int], device: torch.device) -> list:
    """One all_to_all_single of byte blocks: `send` concatenated, split
    per rank by `send_splits`; returns the non-empty blocks that arrive,
    in rank order."""
    buf = (torch.cat(send) if send
           else torch.empty(0, dtype=torch.uint8, device=device))
    out = torch.empty(sum(recv_splits), dtype=torch.uint8, device=device)
    with _timed("halo_seconds", device):
        dist.all_to_all_single(out, buf, recv_splits, send_splits,
                               group=group)
    STATS["halo_calls"] += 1
    STATS["halo_bytes"] += out.numel()
    return [p for p in out.split(recv_splits) if p.numel()]


def _memory_format(x: torch.Tensor) -> torch.memory_format:
    return (torch.channels_last
            if x.is_contiguous(memory_format=torch.channels_last)
            and not x.is_contiguous() else torch.contiguous_format)


class HaloExchange(torch.autograd.Function):
    """x (this rank's band, NCHW) -> the rows [first, stop) of the global
    tensor that a conv's output band reads: x's own rows, the rows other
    ranks own (received in one all_to_all_single), zeros outside the
    global tensor. Backward: the gradient of each received row goes back
    to its owner (one all_to_all_single), which adds it to its own.

    Every rank of the axis calls it for the same convs in the same order,
    so its output is always used: a rank that receives nothing still
    sends in both passes."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, band: "Band", plan: "_Plan",
                first: int, stop: int):
        n, row = band.size, x.shape[0] * x.shape[1] * x.shape[3] \
            * x.element_size()
        send_splits, recv_splits = [0] * n, [0] * n
        for j, lo, hi in plan.send:
            send_splits[j] = (hi - lo) * row
        for j, lo, hi in plan.recv:
            recv_splits[j] = (hi - lo) * row
        blocks = _exchange(band.group,
                           [_wire(x[:, :, lo:hi]) for _, lo, hi in plan.send],
                           send_splits, recv_splits, x.device)
        STATS["halo_elements"] += sum(b.numel() for b in blocks) \
            // x.element_size()
        out = torch.zeros((x.shape[0], x.shape[1], stop - first, x.shape[3]),
                          dtype=x.dtype, device=x.device
                          ).contiguous(memory_format=_memory_format(x))
        a = band.lo * plan.scale
        own0, own1 = max(first, a), min(stop, a + x.shape[2])
        out[:, :, own0 - first:own1 - first] = x[:, :, own0 - a:own1 - a]
        for blk, (_, lo, hi) in zip(blocks, plan.recv):
            out[:, :, lo - first:hi - first] = _unwire(
                blk, x.shape, x.dtype, hi - lo)
        ctx.band, ctx.plan, ctx.first = band, plan, first
        ctx.shape, ctx.dtype, ctx.device = x.shape, x.dtype, x.device
        ctx.format = _memory_format(x)
        ctx.splits = (send_splits, recv_splits)
        ctx.own = (own0, own1, a)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        plan, first = ctx.plan, ctx.first
        send_splits, recv_splits = ctx.splits
        blocks = _exchange(ctx.band.group,
                           [_wire(g[:, :, lo - first:hi - first])
                            for _, lo, hi in plan.recv],
                           recv_splits, send_splits, ctx.device)
        STATS["halo_elements"] += sum(b.numel() for b in blocks) \
            // g.element_size()
        grad = torch.zeros(ctx.shape, dtype=ctx.dtype, device=ctx.device
                           ).contiguous(memory_format=ctx.format)
        own0, own1, a = ctx.own
        grad[:, :, own0 - a:own1 - a] = g[:, :, own0 - first:own1 - first]
        for blk, (_, lo, hi) in zip(blocks, plan.send):
            grad[:, :, lo:hi] += _unwire(blk, ctx.shape, ctx.dtype, hi - lo)
        return grad, None, None, None, None


def conv_rows(band: Band, x: torch.Tensor, kernel: int, stride: int,
              top: int) -> torch.Tensor:
    """The rows of the global tensor that this rank's output band of a
    SAME conv (kernel rows `kernel`, `stride`, `top` rows of padding above
    the global tensor) reads: x's own rows, the halo rows of the ranks that
    own them, zeros beyond the global top and bottom. x: NCHW, this rank's
    band. The conv then runs with no padding along H."""
    scale = band.scale(x.shape[-2])
    if scale % stride:
        raise ValueError(f"a stride-{stride} conv at {scale} rows a grid "
                         f"row would leave the output grid's bands")
    if band.reads_own_rows(scale, kernel, stride, top):
        return x
    first, stop = band.needed(band.index, scale, kernel, stride, top)
    return HaloExchange.apply(x, band, band.plan(scale, kernel, stride, top),
                              first, stop)


def check_pool(band: Band, x: torch.Tensor) -> None:
    """A 2x2 pool is band-local where a band spans an even number of rows
    on an even row: below the output grid's level."""
    if band.scale(x.shape[-2]) < 2:
        raise ValueError("a 2x2 pool on the output grid would split the "
                         "spatial bands; pool above the output stride")


class GatherRows(torch.autograd.Function):
    """NHWC band tensors (B, rows, W, C_i) of one dtype -> the full
    (B, hout * scale, W, C_i) tensors, gathered over the spatial axis in
    one all_gather_into_tensor (bands padded to the widest). Backward:
    this rank's rows of each gradient."""

    @staticmethod
    def forward(ctx, band: Band, *tensors: torch.Tensor):
        scale = band.scale(tensors[0].shape[1])
        widths = [t.shape[-1] for t in tensors]
        x = torch.cat(tensors, dim=-1) if len(tensors) > 1 else tensors[0]
        b, rows, w, c = x.shape
        most = max(hi - lo for lo, hi in band.rows) * scale
        buf = x.new_zeros((b, most, w, c))
        buf[:, :rows] = x
        out = x.new_empty((band.size * b, most, w, c))
        with _timed("gather_seconds", x.device):
            dist.all_gather_into_tensor(
                out.view(-1).view(torch.uint8),
                buf.view(-1).view(torch.uint8), group=band.group)
        STATS["gather_calls"] += 1
        STATS["gather_bytes"] += (out.numel() - buf.numel()) * x.element_size()
        out = out.view(band.size, b, most, w, c)
        full = torch.cat([out[j, :, :(hi - lo) * scale]
                          for j, (lo, hi) in enumerate(band.rows)], dim=1)
        ctx.band, ctx.scale, ctx.widths = band, scale, widths
        return tuple(full.split(widths, dim=-1))

    @staticmethod
    def backward(ctx, *grads):
        band, scale = ctx.band, ctx.scale
        rows = slice(band.lo * scale, band.hi * scale)
        return (None, *(g[:, rows] if g is not None else None
                        for g in grads))


def gather_rows(band: Band, *tensors: torch.Tensor) -> tuple:
    """The full tensors of NHWC band tensors of one dtype (`GatherRows`)."""
    return GatherRows.apply(band, *tensors)


def axis_band(mesh, hin: int, stride: int) -> Band:
    """This rank's band on the mesh's spatial axis for images of height
    `hin` (`check_geometry`'s errors)."""
    s, n, group = S.spatial_axis(mesh)
    return Band(s, n, group, check_geometry(hin, stride, n), stride)


def check_model(model: torch.nn.Module) -> None:
    """The fused and int8 layers run whole-height kernels: a band refuses
    them."""
    for m in model.modules():
        if getattr(m, "fused", False) or getattr(m, "int8", False):
            raise ValueError(
                "spatial sharding runs the plain float layers only: "
                "fused_inference and int8 take the whole image height")


def band_forward(band: Band, model: torch.nn.Module, images: torch.Tensor
                 ) -> dict:
    """model(images) on this rank's band of NHWC images (plain, or a
    space-to-depth layout), under the band; the conf and paf outputs of
    every stage gathered into full maps (one collective), `feature` left as
    this rank's band."""
    check_model(model)
    per = {3: 1, 12: 2, 48: 4}.get(images.shape[-1], 1)
    want = (band.hi - band.lo) * band.stride
    if images.shape[1] * per != want:
        raise ValueError(f"spatial rank {band.index}: images of "
                         f"{images.shape[1] * per} rows, its band has {want}")
    with use(band):
        out = model(images)
    n = len(out["conf"])
    full = gather_rows(band, *out["conf"], *out["paf"])
    return dict(out, conf=list(full[:n]), paf=list(full[n:]))
