"""Halo exchange primitives for the distributed stencil stepper.

The port of `repro.distributed.halo`. Deep halos (depth g = R * t_block)
amortize one neighbour exchange over t_block local steps. The exchange is
two-phase, z first, then y over the z-extended block, so corner halos
arrive transitively, which multi-step star-stencil composition needs.

One process holds every shard (see `launch.mesh`), so these functions take
the shards themselves: a ring is the list of one mesh axis's blocks in
axis order, a grid the ``[iz][iy]`` lists of all of them. Neighbours trade
slabs as in the reference's ring (`ppermute` forward and backward), and the
ranks at a global edge take an edge clamp in place of the wrapped slab.

Every received slab is a real copy into a receive buffer on the receiving
block's device, made by a `Wire`: on CUDA each copy is a ``copy_(...,
non_blocking=True)`` on that device's communication stream, after the
stream has waited for the compute stream that produced the source, and the
compute streams wait for the copies only when the wire lands (`Wire.land`).
The whole exchange runs there, the copy of each block's own cells and the
edge clamps included, so its two phases stay ordered on the wire alone.
Between the two, the caller may launch work that reads no halo (the
overlapped super-step's interior). The receive buffers and the sources are
marked with `record_stream`, so the caching allocator reuses neither before
the communication stream is done with it. On the CPU the copies are plain
and immediate.

Across processes (`distributed.process`) a ring entry another rank holds
is a `Remote` placeholder: its owner and its shape, no data. Every rank
walks the same global ring, so a neighbour pair split across ranks is one
call on both sides: the owner of the slab sends it, the owner of the halo
receives it, and a `Carrier` (a `Wire` that also talks to other ranks)
posts both, matched by a tag that numbers the call in the walk (its
axis, direction and ring position). A Carrier stages sends as the walk
meets them and trades them only at `Carrier.flush`: under gloo, which
moves CPU tensors, a CUDA slab goes to a pinned host buffer on the
communication stream and the received one comes back from it; under NCCL
the device buffers are posted under the communication stream. The
two-phase exchange flushes between its phases, so no y-phase copy reads a
z halo before it has landed: the corners travel through both hops.
"""

from __future__ import annotations

import contextlib
import functools
import time

import torch
import torch.distributed as dist

from repro_torch.distributed import compression


@functools.lru_cache(maxsize=None)
def comm_stream(device: torch.device):
    """The communication stream of one card (created once)."""
    return torch.cuda.Stream(device=device)


class Wire:
    """Copies between shards, on per-device communication streams on CUDA.

    `send` enqueues one copy into a receive buffer; `land` makes every
    compute stream that took part wait for the copies. A Wire that is
    never landed leaves the copies unordered against later compute.
    """

    def __init__(self):
        self._started: dict[torch.device, object] = {}

    def _start(self, device: torch.device):
        """The device's communication stream, ordered after the work its
        compute stream has queued so far (once per wire)."""
        stream = self._started.get(device)
        if stream is None:
            stream = comm_stream(device)
            stream.wait_stream(torch.cuda.current_stream(device))
            self._started[device] = stream
        return stream

    @contextlib.contextmanager
    def on(self, device: torch.device):
        """Run the enclosed work on the device's communication stream
        (plain on the CPU)."""
        if torch.device(device).type != "cuda":
            yield
            return
        with torch.cuda.stream(self._start(torch.device(device))):
            yield

    def send(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        """Copy `src` into the receive buffer `dst` (a view is fine)."""
        if not (dst.is_cuda or src.is_cuda):
            dst.copy_(src)
            return
        s_src, s_dst = self._start(src.device), self._start(dst.device)
        if src.device != dst.device:
            # the source may have been written on its own wire stream (the
            # z phase of a two-phase exchange)
            s_dst.wait_stream(s_src)
        with contextlib.ExitStack() as ctx:
            ctx.enter_context(torch.cuda.stream(s_src))
            if src.device != dst.device:
                ctx.enter_context(torch.cuda.stream(s_dst))
            dst.copy_(src, non_blocking=True)
        src.record_stream(s_src)
        dst.record_stream(s_dst)

    def flush(self) -> None:
        """End a phase of the exchange (nothing to do on one process:
        the streams order the phases)."""

    def deferred(self):
        """The context of a phase run late (`Carrier.deferred`); on one
        process no phase is."""
        return contextlib.nullcontext()

    def hand_over(self, blocks) -> None:
        """Hand a deferred phase's blocks to compute (`Carrier.hand_over`);
        nothing on one process."""

    def land(self) -> None:
        """Order every compute stream that took part after the copies."""
        for device, stream in self._started.items():
            torch.cuda.current_stream(device).wait_stream(stream)
        self._started.clear()


class Remote:
    """A block another rank holds: its owner and its shape, no data.

    Shape arithmetic runs on a ``meta`` tensor, so the exchange slices,
    expands and allocates it as it does a local block; `apply` runs any
    shape function (a pad) on it.
    """

    __slots__ = ("rank", "meta")

    def __init__(self, rank: int, meta: torch.Tensor):
        self.rank, self.meta = rank, meta

    @classmethod
    def like(cls, rank: int, shape, dtype=torch.float32) -> "Remote":
        """A placeholder of `shape` and `dtype` owned by `rank`."""
        return cls(rank, torch.empty(tuple(shape), dtype=dtype,
                                     device="meta"))

    shape = property(lambda self: self.meta.shape)
    ndim = property(lambda self: self.meta.ndim)
    dtype = property(lambda self: self.meta.dtype)

    def __getitem__(self, idx) -> "Remote":
        return Remote(self.rank, self.meta[idx])

    def expand_as(self, other) -> "Remote":
        return Remote(self.rank, self.meta.expand(tuple(other.shape)))

    def new_empty(self, shape) -> "Remote":
        return Remote(self.rank, self.meta.new_empty(tuple(shape)))

    def apply(self, fn) -> "Remote":
        """`fn` applied to the shape: the placeholder of its result."""
        return Remote(self.rank, fn(self.meta))

    def __repr__(self) -> str:
        return (f"Remote(rank={self.rank}, shape={tuple(self.shape)}, "
                f"{self.dtype})")


def is_remote(x) -> bool:
    """True for a `Remote` placeholder."""
    return isinstance(x, Remote)


def _flat(blocks):
    for b in blocks:
        if isinstance(b, (list, tuple)):
            yield from _flat(b)
        elif isinstance(b, dict):
            yield from _flat(list(b.values()))
        else:
            yield b


def wire_for(blocks) -> "Wire":
    """A new `Carrier` when any of `blocks` (a ring or grid) is another
    rank's, else a new `Wire`."""
    return Carrier() if any(map(is_remote, _flat(blocks))) else Wire()


class Carrier(Wire):
    """A `Wire` whose ring may cross processes.

    ``send(dst, src)`` copies as a Wire when both sides are local, stages
    a send when `dst` is another rank's, allocates a receive buffer when
    `src` is, and skips a pair that is all another rank's. Each call draws
    the next tag, so every rank numbers the walk's calls alike. `flush`
    trades the staged sends and receives (`batch_isend_irecv`) and lands
    the receives in their halos; `after_landing` defers work on received
    data (a dequantization) to that point. `sent_bytes` counts the payload
    this rank sends; with ``timed=True`` `times` holds seconds spent
    staging to the host (``d2h_s``), on the wire (``wire_s``) and landing
    on the device (``h2d_s``), each piece synchronized.
    """

    def __init__(self, *, timed: bool = False):
        super().__init__()
        if not dist.is_initialized():
            raise RuntimeError("a Carrier needs a process group "
                               "(repro_torch.distributed.process."
                               "initialize)")
        self.host_staged = dist.get_backend() == "gloo"
        self.sent_bytes = 0
        self.times = {"d2h_s": 0.0, "wire_s": 0.0, "h2d_s": 0.0} \
            if timed else None
        self._tag = 0
        self._sends: list = []
        self._recvs: list = []
        self._after: list = []

    def _buffer(self, shape, dtype, device):
        """A contiguous buffer the backend moves: pinned host memory for a
        CUDA tensor under gloo, else on `device`."""
        device = torch.device(device)
        if device.type == "cuda" and self.host_staged:
            return torch.empty(tuple(shape), dtype=dtype, pin_memory=True)
        return torch.empty(tuple(shape), dtype=dtype, device=device)

    def send(self, dst, src) -> None:
        """Copy, stage a send, or post a receive (see the class)."""
        tag = self._tag
        self._tag += 1
        if is_remote(dst) and is_remote(src):
            return
        if not (is_remote(dst) or is_remote(src)):
            super().send(dst, src)
            return
        if is_remote(dst):
            buf = self._buffer(src.shape, src.dtype, src.device)
            if src.is_cuda:
                with torch.cuda.stream(self._start(src.device)):
                    buf.copy_(src, non_blocking=True)
                src.record_stream(comm_stream(src.device))
            else:
                buf.copy_(src)
            self._sends.append((buf, dst.rank, tag))
            self.sent_bytes += buf.numel() * buf.element_size()
            return
        buf = self._buffer(dst.shape, dst.dtype, dst.device)
        self._recvs.append((dst, buf, src.rank, tag))

    @contextlib.contextmanager
    def deferred(self):
        """Run a phase that starts after the compute streams went on past
        the wire's start (the overlapped interior): its allocations come
        from the communication streams' pools, whose order its copies
        follow, never from memory that pending compute still uses. Hand
        what it returns to compute with `hand_over`."""
        with contextlib.ExitStack() as ctx:
            for device in list(self._started):
                ctx.enter_context(torch.cuda.stream(comm_stream(device)))
            yield

    def hand_over(self, blocks) -> None:
        """Mark the CUDA tensors of a ring or grid (nested lists, tuples
        and dicts) as used by their devices' compute streams: blocks a
        `deferred` phase allocated are not reused before the compute work
        on them."""
        for b in _flat(blocks):
            if isinstance(b, torch.Tensor) and b.is_cuda:
                b.record_stream(torch.cuda.current_stream(b.device))

    def after_landing(self, fn) -> None:
        """Run `fn` once this phase's receives have landed."""
        self._after.append(fn)

    def _sync(self, devices) -> None:
        for device in devices:
            if device.type == "cuda":
                comm_stream(device).synchronize()

    def flush(self) -> None:
        """Trade this phase's staged sends and receives, land the
        receives in their halos, then run the deferred work."""
        if self._sends or self._recvs:
            t0 = time.perf_counter()
            staged = {b[0].device for b in self._sends}
            if self.host_staged:
                # the D2H copies must be on the host before gloo reads them
                self._sync([d for d in self._started if d.type == "cuda"])
            t1 = time.perf_counter()
            ops = [dist.P2POp(dist.isend, buf, peer, tag=tag)
                   for buf, peer, tag in self._sends]
            ops += [dist.P2POp(dist.irecv, buf, peer, tag=tag)
                    for _, buf, peer, tag in self._recvs]
            staged |= {buf.device for _, buf, _, _ in self._recvs}
            nccl_dev = next((d for d in staged if d.type == "cuda"), None)
            with contextlib.ExitStack() as ctx:
                if not self.host_staged and nccl_dev is not None:
                    ctx.enter_context(torch.cuda.stream(
                        self._start(nccl_dev)))
                for work in dist.batch_isend_irecv(ops):
                    work.wait()
            t2 = time.perf_counter()
            for dst, buf, _, _ in self._recvs:
                if dst.is_cuda:
                    with torch.cuda.stream(self._start(dst.device)):
                        dst.copy_(buf, non_blocking=True)
                    dst.record_stream(comm_stream(dst.device))
                else:
                    dst.copy_(buf)
            if self.times is not None:
                self._sync([dst.device for dst, *_ in self._recvs])
                t3 = time.perf_counter()
                self.times["d2h_s"] += t1 - t0
                self.times["wire_s"] += t2 - t1
                self.times["h2d_s"] += t3 - t2
            self._sends, self._recvs = [], []
        after, self._after = self._after, []
        for fn in after:
            fn()

    def land(self) -> None:
        """Flush the last phase, then order the compute streams after it."""
        self.flush()
        super().land()


@contextlib.contextmanager
def _using(wire, blocks=()):
    """`wire`, or a new one (`wire_for` the blocks) that lands when the
    block ends."""
    if wire is not None:
        yield wire
        return
    own = wire_for(blocks)
    yield own
    own.land()


def _edge(block, axis: int, lo: bool):
    """The one-cell edge slab of `block` on `axis` (a view)."""
    idx = [slice(None)] * block.ndim
    idx[axis] = slice(0, 1) if lo else slice(-1, None)
    return block[tuple(idx)]


def _slab(block, axis: int, start: int, stop: int):
    idx = [slice(None)] * block.ndim
    idx[axis] = slice(start, stop)
    return block[tuple(idx)]


def _check_depth(blocks, axis: int, depth: int) -> None:
    n_ax = blocks[0].shape[axis]
    if depth > n_ax:
        raise ValueError(
            f"halo depth {depth} exceeds local block extent {n_ax} on axis "
            f"{axis}: lower t_block or use a coarser decomposition "
            f"(single-hop exchange only)")


def _ring_fill(blocks, axis: int, depth: int, los, his, wire: Wire) -> None:
    """Write each block's low/high halo into `los[i]`/`his[i]`: the
    neighbour's high/low slab, or the edge clamp at the global edges."""
    n = len(blocks)
    for i, block in enumerate(blocks):
        ext = block.shape[axis]
        if i == 0:
            wire.send(los[i], _edge(block, axis, True).expand_as(los[i]))
        else:
            wire.send(los[i], _slab(blocks[i - 1], axis, ext - depth, ext))
        if i == n - 1:
            wire.send(his[i], _edge(block, axis, False).expand_as(his[i]))
        else:
            wire.send(his[i], _slab(blocks[i + 1], axis, 0, depth))


def _halo_shape(block, axis: int, depth: int):
    shape = list(block.shape)
    shape[axis] = depth
    return shape


def exchange_axis_parts(blocks, axis: int, depth: int, wire=None):
    """The two halo slabs of each block of one ring, not concatenated.

    Returns ``[(lo_halo, hi_halo), ...]``, each a fresh receive buffer
    `depth` thick along `axis` on its block's device. Without a `wire` the
    exchange lands before returning.
    """
    _check_depth(blocks, axis, depth)
    los = [b.new_empty(_halo_shape(b, axis, depth)) for b in blocks]
    his = [b.new_empty(_halo_shape(b, axis, depth)) for b in blocks]
    with _using(wire, blocks) as w:
        _ring_fill(blocks, axis, depth, los, his, w)
    return list(zip(los, his))


def exchange_axis(blocks, axis: int, depth: int, wire=None):
    """Each block of one ring extended by `depth` halo cells on both sides
    of `axis`: the neighbours' slabs copied straight into the extended
    block, edge clamps at the global edges (the Dirichlet frame makes their
    values irrelevant). Another rank's block extends to a `Remote` of the
    extended shape."""
    _check_depth(blocks, axis, depth)
    outs, los, his = [], [], []
    with _using(wire, blocks) as w:
        for b in blocks:
            shape = list(b.shape)
            shape[axis] += 2 * depth
            out = b.new_empty(shape)
            w.send(_slab(out, axis, depth, depth + b.shape[axis]), b)
            outs.append(out)
            los.append(_slab(out, axis, 0, depth))
            his.append(_slab(out, axis, depth + b.shape[axis], shape[axis]))
        _ring_fill(blocks, axis, depth, los, his, w)
    return outs


def _columns(grid):
    return [list(col) for col in zip(*grid)]


def exchange_2d_phases(grid, depth: int, wire, *, z_dim: int = -3,
                       y_dim: int = -2):
    """`exchange_2d` as a generator: the z phase, a ``yield`` where the
    caller flushes `wire` (the z halos land), the y phase; the extended
    grid is its return value (`drive`)."""
    ndim = grid[0][0].ndim
    cols = [exchange_axis(col, z_dim % ndim, depth, wire)
            for col in _columns(grid)]
    yield
    return [exchange_axis(row, y_dim % ndim, depth, wire)
            for row in _columns(cols)]


def drive(phases, wire) -> list:
    """Run phase generators in lock step to their ends, flushing `wire`
    after each phase they all took; their return values in order."""
    results = [None] * len(phases)
    live = list(range(len(phases)))
    while live:
        still = []
        for i in live:
            try:
                next(phases[i])
                still.append(i)
            except StopIteration as stop:
                results[i] = stop.value
        if still:
            wire.flush()
        live = still
    return results


def exchange_2d(grid, depth: int, *, z_dim: int = -3, y_dim: int = -2,
                wire=None):
    """Two-phase deep-halo exchange of a ``[iz][iy]`` grid of blocks: z
    along each column, then y along each row of z-extended blocks."""
    with _using(wire, grid) as w:
        return drive([exchange_2d_phases(grid, depth, w, z_dim=z_dim,
                                         y_dim=y_dim)], w)[0]


def _quantized_placeholder(block: Remote, axis: int, depth: int):
    """The (payload, scale) another rank's block sends on `axis`."""
    return (Remote.like(block.rank, _halo_shape(block, axis, depth),
                        torch.int8),
            Remote.like(block.rank, (), torch.float32))


def exchange_axis_compressed(blocks, axis: int, depth: int, errs_lo, errs_hi,
                             wire=None):
    """`exchange_axis` shipping int8 payloads and float32 scales.

    Each block quantizes the two slabs it sends (`compression.
    quantize_slab`, its own scale, with error feedback from `errs_lo[i]` /
    `errs_hi[i]`, float32 residuals shaped like the slabs); the int8
    payload and the scale cross to the neighbour's device, which
    dequantizes into the stream dtype. A slab that would wrap around the
    ring is quantized (its residual advances, as in the reference) but not
    sent: the global-edge ranks take the edge clamp. With one block on the
    axis the exchange is the exact edge clamp and the residuals pass
    through. Another rank's block has no residuals here (None) and is
    neither quantized nor dequantized; a payload from another rank is
    dequantized once it has landed (`Carrier.after_landing`). Returns
    ``(extended_blocks, new_errs_lo, new_errs_hi)``.
    """
    _check_depth(blocks, axis, depth)
    n = len(blocks)
    if n == 1:
        return exchange_axis(blocks, axis, depth, wire), errs_lo, errs_hi
    with _using(wire, blocks) as wire:
        sent_hi, sent_lo, new_lo, new_hi = [], [], [], []
        for b, e_lo, e_hi in zip(blocks, errs_lo, errs_hi):
            if is_remote(b):
                sent_hi.append(_quantized_placeholder(b, axis, depth))
                sent_lo.append(_quantized_placeholder(b, axis, depth))
                new_lo.append(None)
                new_hi.append(None)
                continue
            ext = b.shape[axis]
            # on the wire's stream: `b` may be a block the wire is still
            # extending (the y phase reads the z phase's output)
            with wire.on(b.device):
                q_hi, s_hi, ne_hi = compression.quantize_slab(
                    _slab(b, axis, ext - depth, ext), e_hi)
                q_lo, s_lo, ne_lo = compression.quantize_slab(
                    _slab(b, axis, 0, depth), e_lo)
            if b.is_cuda:
                for t in (b, e_lo, e_hi):
                    t.record_stream(comm_stream(t.device))
            sent_hi.append((q_hi, s_hi))
            sent_lo.append((q_lo, s_lo))
            new_lo.append(ne_lo)
            new_hi.append(ne_hi)
        outs = []
        for i, b in enumerate(blocks):
            shape = list(b.shape)
            shape[axis] += 2 * depth
            out = b.new_empty(shape)
            wire.send(_slab(out, axis, depth, depth + b.shape[axis]), b)
            for side, j, sent in (("lo", i - 1, sent_hi),
                                  ("hi", i + 1, sent_lo)):
                dst = (_slab(out, axis, 0, depth) if side == "lo" else
                       _slab(out, axis, depth + b.shape[axis], shape[axis]))
                if not 0 <= j < n:
                    wire.send(dst, _edge(b, axis, side == "lo").expand_as(dst))
                    continue
                q, s = sent[j]
                if is_remote(b):
                    q_r = Remote.like(b.rank, q.shape, torch.int8)
                    s_r = Remote.like(b.rank, (), torch.float32)
                else:
                    q_r = torch.empty(q.shape, dtype=torch.int8,
                                      device=b.device)
                    s_r = torch.empty((), dtype=torch.float32,
                                      device=b.device)
                wire.send(q_r, q)
                wire.send(s_r, s)
                if is_remote(b):
                    continue

                def dequantize(dst=dst, q_r=q_r, s_r=s_r, b=b, out=out):
                    # on the receiving side, behind its payload
                    with wire.on(b.device):
                        dst.copy_(compression.dequantize_slab(q_r, s_r,
                                                              b.dtype))
                    if out.is_cuda:
                        out.record_stream(comm_stream(out.device))

                if is_remote(q):
                    wire.after_landing(dequantize)
                else:
                    dequantize()
            outs.append(out)
        return outs, new_lo, new_hi


def _face(err, key):
    return None if err is None else err[key]


def exchange_2d_compressed_phases(grid, depth: int, errs, wire, *,
                                  z_dim: int = -3, y_dim: int = -2):
    """`exchange_2d_compressed` as a generator, phased as
    `exchange_2d_phases`; returns ``(ext, new_errs)``."""
    ndim = grid[0][0].ndim
    zd, yd = z_dim % ndim, y_dim % ndim
    cols, zlo, zhi = [], [], []
    for col, ecol in zip(_columns(grid), _columns(errs)):
        ext, lo, hi = exchange_axis_compressed(
            col, zd, depth, [_face(e, "z_lo") for e in ecol],
            [_face(e, "z_hi") for e in ecol], wire)
        cols.append(ext)
        zlo.append(lo)
        zhi.append(hi)
    yield
    out, new = [], []
    for iz, row in enumerate(_columns(cols)):
        ext, ylo, yhi = exchange_axis_compressed(
            row, yd, depth, [_face(e, "y_lo") for e in errs[iz]],
            [_face(e, "y_hi") for e in errs[iz]], wire)
        out.append(ext)
        new.append([None if errs[iz][iy] is None else
                    {"z_lo": zlo[iy][iz], "z_hi": zhi[iy][iz],
                     "y_lo": ylo[iy], "y_hi": yhi[iy]}
                    for iy in range(len(row))])
    return out, new


def exchange_2d_compressed(grid, depth: int, errs, *, z_dim: int = -3,
                           y_dim: int = -2, wire=None):
    """Two-phase compressed deep-halo exchange; returns ``(ext, new_errs)``.

    `errs` is a ``[iz][iy]`` grid of per-block residual dicts: float32
    faces ``z_lo``/``z_hi`` shaped like the z slabs the block sends and
    ``y_lo``/``y_hi`` shaped like the y slabs of its z-extended block
    (`init_halo_error`); None for another rank's block.
    """
    with _using(wire, grid) as w:
        return drive([exchange_2d_compressed_phases(
            grid, depth, errs, w, z_dim=z_dim, y_dim=y_dim)], w)[0]


def init_halo_error(local_shape, depth: int, device="cpu"):
    """Zero error-feedback faces for one local block."""
    nz, ny, nx = local_shape[-3:]
    lead = tuple(local_shape[:-3])
    z_face = lead + (depth, ny, nx)
    y_face = lead + (nz + 2 * depth, depth, nx)
    zeros = functools.partial(torch.zeros, dtype=torch.float32,
                              device=device)
    return {"z_lo": zeros(z_face), "z_hi": zeros(z_face),
            "y_lo": zeros(y_face), "y_hi": zeros(y_face)}


FACES = ("z_lo", "z_hi", "y_lo", "y_hi")


def halo_bytes(local_shape, depth: int, word_bytes: int, n_streams: int,
               compress: bool = False, faces=FACES) -> int:
    """Per-super-step halo bytes per shard (both axes, both directions).

    compress=True counts the int8 wire format of the compressed exchange:
    1 byte per halo cell plus one float32 scale per sent slab (4 slabs per
    stream), independent of the stream word size. `faces` keeps the slabs
    the shard sends across some of its faces only (those whose neighbour
    is another rank's: what its `Carrier` sends).
    """
    nz, ny, nx = local_shape[-3:]
    size = {"z_lo": depth * ny * nx, "z_hi": depth * ny * nx,
            "y_lo": depth * (nz + 2 * depth) * nx,
            "y_hi": depth * (nz + 2 * depth) * nx}
    cells = sum(size[f] for f in faces)
    if compress:
        return cells * n_streams + 4 * len(faces) * n_streams
    return cells * word_bytes * n_streams
