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
"""

from __future__ import annotations

import contextlib
import functools

import torch

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

    def land(self) -> None:
        """Order every compute stream that took part after the copies."""
        for device, stream in self._started.items():
            torch.cuda.current_stream(device).wait_stream(stream)
        self._started.clear()


@contextlib.contextmanager
def _using(wire):
    """`wire`, or a new Wire that lands when the block ends."""
    if wire is not None:
        yield wire
        return
    own = Wire()
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
    with _using(wire) as w:
        _ring_fill(blocks, axis, depth, los, his, w)
    return list(zip(los, his))


def exchange_axis(blocks, axis: int, depth: int, wire=None):
    """Each block of one ring extended by `depth` halo cells on both sides
    of `axis`: the neighbours' slabs copied straight into the extended
    block, edge clamps at the global edges (the Dirichlet frame makes their
    values irrelevant)."""
    _check_depth(blocks, axis, depth)
    outs, los, his = [], [], []
    with _using(wire) as w:
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


def exchange_2d(grid, depth: int, *, z_dim: int = -3, y_dim: int = -2,
                wire=None):
    """Two-phase deep-halo exchange of a ``[iz][iy]`` grid of blocks: z
    along each column, then y along each row of z-extended blocks."""
    ndim = grid[0][0].ndim
    with _using(wire) as w:
        cols = [exchange_axis(col, z_dim % ndim, depth, w)
                for col in _columns(grid)]
        return [exchange_axis(row, y_dim % ndim, depth, w)
                for row in _columns(cols)]


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
    through. Returns ``(extended_blocks, new_errs_lo, new_errs_hi)``.
    """
    _check_depth(blocks, axis, depth)
    n = len(blocks)
    if n == 1:
        return exchange_axis(blocks, axis, depth, wire), errs_lo, errs_hi
    with _using(wire) as wire:
        sent_hi, sent_lo, new_lo, new_hi = [], [], [], []
        for b, e_lo, e_hi in zip(blocks, errs_lo, errs_hi):
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
                q_r = torch.empty_like(q, device=b.device)
                s_r = torch.empty_like(s, device=b.device)
                wire.send(q_r, q)
                wire.send(s_r, s)
                # dequantize on the receiving side, behind its payload
                with wire.on(b.device):
                    dst.copy_(compression.dequantize_slab(q_r, s_r, b.dtype))
                if out.is_cuda:
                    out.record_stream(comm_stream(out.device))
            outs.append(out)
        return outs, new_lo, new_hi


def exchange_2d_compressed(grid, depth: int, errs, *, z_dim: int = -3,
                           y_dim: int = -2, wire=None):
    """Two-phase compressed deep-halo exchange; returns ``(ext, new_errs)``.

    `errs` is a ``[iz][iy]`` grid of per-block residual dicts: float32
    faces ``z_lo``/``z_hi`` shaped like the z slabs the block sends and
    ``y_lo``/``y_hi`` shaped like the y slabs of its z-extended block
    (`init_halo_error`).
    """
    ndim = grid[0][0].ndim
    zd, yd = z_dim % ndim, y_dim % ndim
    with _using(wire) as wire:
        ecols = _columns(errs)
        cols, zlo, zhi = [], [], []
        for col, ecol in zip(_columns(grid), ecols):
            ext, lo, hi = exchange_axis_compressed(
                col, zd, depth, [e["z_lo"] for e in ecol],
                [e["z_hi"] for e in ecol], wire)
            cols.append(ext)
            zlo.append(lo)
            zhi.append(hi)
        rows = _columns(cols)
        out, new = [], []
        for iz, row in enumerate(rows):
            ext, ylo, yhi = exchange_axis_compressed(
                row, yd, depth, [e["y_lo"] for e in errs[iz]],
                [e["y_hi"] for e in errs[iz]], wire)
            out.append(ext)
            new.append([{"z_lo": zlo[iy][iz], "z_hi": zhi[iy][iz],
                         "y_lo": ylo[iy], "y_hi": yhi[iy]}
                        for iy in range(len(row))])
        return out, new


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


def halo_bytes(local_shape, depth: int, word_bytes: int, n_streams: int,
               compress: bool = False) -> int:
    """Per-super-step halo bytes per shard (both axes, both directions).

    compress=True counts the int8 wire format of the compressed exchange:
    1 byte per halo cell plus one float32 scale per sent slab (4 slabs per
    stream), independent of the stream word size.
    """
    nz, ny, nx = local_shape[-3:]
    z_face = depth * ny * nx
    y_face = depth * (nz + 2 * depth) * nx
    if compress:
        return 2 * (z_face + y_face) * 1 * n_streams + 4 * 4 * n_streams
    return 2 * (z_face + y_face) * word_bytes * n_streams
