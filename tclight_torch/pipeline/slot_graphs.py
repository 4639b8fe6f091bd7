"""The yt pass's chunk slots as CUDA graph replays (the Generator's
`_temporal_noises` on the card, without a mesh).

A yt slot's launched work depends only on host values known before it
runs: the window's shape, `randf % stride` at each local merge level, the
global `flip` and whether the slot merges against the banks (`use_global`,
every slot but the first). That is its variant key (`variant_keys`): at a
4-frame chunk 4 keys for the first slot and 8 for the others. Each key's
CFG forward (`Generator._pred_chunk`: the UNet with its ToMe merges and
attentions, unchanged) is captured once into CUDA graphs split at each
call of the ToMe matcher (`SplitRecorder`): the matcher runs eagerly
between two replays, through the module attribute
`tome.online_argmax_scores`, so whatever wraps that attribute sees every
matching once, in the eager order, with the eager operands. The same
kernels run on the same operands in the same order as in the eager pass,
so the output is the eager one bit for bit.

The first yt window a Generator runs on the card runs its first two slots
eagerly (one without the global merge, one with it: the warm-up of cuDNN,
cuBLAS and the kernels' attribute setting, and the sizes of the matcher's
operands), then captures every key and replays from the third slot on.
Nothing is captured after that window; a window of another shape runs
eagerly.

Memory. Every key reads and writes the same few buffers: the slot's
inputs (gathered into them before each replay), the timestep and the
prompt embeddings (set once a window), the staging buffer that holds the
matcher's operands and results (sized for the largest call), the output,
and the ToMe banks carried from slot to slot. The banks are allocated in
the graphs' pool by the first capture and released to it after the last:
from then on only the graphs use that memory, since nothing else is
captured into the pool. So the banks do not count among the allocated
bytes while the xy pass runs; the staging buffer and the inputs do.

`stage_times["yt_graphs"]` counts the keys, the CUDA graphs captured, the
slots replayed and those run eagerly, and the seconds the capture took.
"""

from __future__ import annotations

import collections
import math
import time
from typing import NamedTuple

import torch

from tclight_torch.ops import kernels, tome
from tclight_torch.utils.logging import span

__all__ = ["MatchList", "SplitRecorder", "SlotGraphs", "slot_key", "variant_keys"]


def _strides(spec) -> tuple:
    if spec is None or spec.n_frames <= 1:
        return ()
    return tuple(lvl.stride for lvl in tome.plan_local_levels(
        spec.n_frames, 1, spec.local_ratio, spec.target_stride))


def slot_key(spec, randf: int, flip: bool, use_global: bool) -> tuple:
    """The variant key of a slot: (randf % stride at each local level,
    flip, use_global), with flip and use_global False where the slot makes
    no global merge."""
    glob = bool(use_global) and spec is not None and spec.merge_global
    return tuple(randf % s for s in _strides(spec)), bool(flip) and glob, glob


def variant_keys(spec) -> tuple[dict, dict]:
    """({key: (randf, flip, use_global)} of the first slot, the same of
    the later slots): every key a slot can have, each with arguments of a
    slot that has it."""
    strides = _strides(spec)
    period = math.lcm(*strides) if strides else 1
    first, later = {}, {}
    for r in range(period):
        first.setdefault(slot_key(spec, r, False, False), (r, False, False))
        for flip in (False, True):
            later.setdefault(slot_key(spec, r, flip, True), (r, flip, True))
    return first, later


class MatchList:
    """A matcher hook that calls the matcher (the module attribute
    `tome.online_argmax_scores`) and lists each call's operand shapes."""

    def __init__(self) -> None:
        self.calls: list[tuple] = []  # (a shape, bt shape, dtype)

    def __call__(self, a: torch.Tensor, bt: torch.Tensor):
        self.calls.append((tuple(a.shape), tuple(bt.shape), a.dtype))
        return tome.online_argmax_scores(a, bt)


def _offset(n: int, esize: int) -> int:
    """n elements rounded up to a multiple of 16 bytes (K2's alignment)."""
    per = max(16 // esize, 1)
    return -(-n // per) * per


def staging_size(calls) -> tuple[int, int]:
    """(elements of the staging buffer, rows of the results) that hold the
    largest of `calls` (MatchList.calls)."""
    n = max(_offset(math.prod(a), torch.finfo(dt).bits // 8) + math.prod(b)
            for a, b, dt in calls)
    return n, max(a[1] for a, _, _ in calls)


class SplitRecorder:
    """A matcher hook that splits a capture at each matching. It writes the
    operands a and bt into the staging buffer (16-byte aligned views), ends
    the current segment's capture, notes the call, opens the next
    segment's capture and hands back the result buffers `node_max[:S]`,
    `node_idx[:S]`, which the replay fills by calling the matcher. With no
    graph pool (`pool` None) nothing is captured: the calls are only
    listed, as on the CPU."""

    def __init__(self, staging: torch.Tensor, node_max: torch.Tensor,
                 node_idx: torch.Tensor, pool=None) -> None:
        self.staging, self.node_max, self.node_idx, self.pool = staging, node_max, node_idx, pool
        self.calls: list[tuple] = []     # (a, bt, node_max, node_idx) views
        self.segments: list = []         # CUDA graphs, one more than the calls
        self._graph = None

    def begin(self) -> None:
        if self.pool is not None:
            self._graph = torch.cuda.CUDAGraph()
            self._graph.capture_begin(pool=self.pool)

    def end(self) -> None:
        if self._graph is not None:
            self._graph.capture_end()
            self.segments.append(self._graph)
            self._graph = None

    def __call__(self, a: torch.Tensor, bt: torch.Tensor):
        na = a.numel()
        off = _offset(na, self.staging.element_size())
        av = self.staging[:na].view(a.shape)
        bv = self.staging[off: off + bt.numel()].view(bt.shape)
        av.copy_(a)
        bv.copy_(bt)
        s = a.shape[1]
        out = self.node_max[:s], self.node_idx[:s]
        self.end()
        self.calls.append((av, bv) + out)
        self.begin()
        return out


class _Graphed(NamedTuple):
    segments: list  # CUDA graphs
    calls: list     # (a, bt, node_max, node_idx) between segments k and k + 1
    launches: dict  # {STATS name: (launches, Counter of shapes)} of one replay


def _launches() -> dict:
    return {k: (st.launches, collections.Counter(st.shapes)) for k, st in kernels.STATS.items()}


def _launches_since(before: dict) -> dict:
    """The launches recorded since `before` (`_launches()`), taken back out
    of STATS: a capture launches nothing, its replays do."""
    out = {}
    for k, (n, shapes) in _launches().items():
        if n > before[k][0]:
            out[k] = (n - before[k][0], shapes - before[k][1])
        st = kernels.STATS[k]
        st.launches = before[k][0]
        st.shapes.clear()
        st.shapes.update(before[k][1])
    return out


class SlotGraphs:
    """The yt slots of one Generator as CUDA graph replays (module
    docstring). `pred` gives a yt window's slot forward for
    `Generator._run_plan`."""

    def __init__(self, gen) -> None:
        self.gen = gen
        self.graphs: dict[tuple, _Graphed] = {}
        self.signature = None
        self.first = True  # no window has run yet: the next may capture
        self.counter = {"keys": 0, "captured": 0, "replayed": 0, "eager": 0, "capture_s": 0.0}
        gen.stage_times["yt_graphs"] = self.counter

    @staticmethod
    def _signature(models, x, cc, embeds, cs: int) -> tuple:
        """What the captured work was specialised to besides the keys: the
        models and the shapes (another clip's length gives other windows)."""
        return (id(models.unet), models.tome_spec, models.attn_backend, cs,
                tuple(x.shape[1:]), x.dtype, tuple(cc.shape[1:]), cc.dtype,
                tuple((tuple(e.shape), e.dtype) for e in embeds))

    def pred(self, models, x, cc, embeds, t: float, cs: int):
        """A yt window's `pred(idx, randf, flip, banks, use_global)` for
        `Generator._run_plan`, over slots of `cs` columns: graph replays
        where the window's shape was captured; in the first window, eager
        slots 0 and 1, then the capture, then replays; else eager slots."""
        gen = self.gen
        sig = self._signature(models, x, cc, embeds, cs)
        live = bool(self.graphs) and sig == self.signature
        capture, self.first = not live and self.first, False
        if live:
            self._stage(embeds, t)
        spec, listed = models.tome_spec, []

        def pred(idx, randf, flip, banks, use_global):
            nonlocal live
            if live:  # the graphs carry the banks themselves
                torch.index_select(x, 0, idx, out=self.x_in)
                torch.index_select(cc, 0, idx, out=self.cc_in)
                self.counter["replayed"] += 1
                return self._replay(self.graphs[slot_key(spec, randf, flip, use_global)]), None
            self.counter["eager"] += 1
            if not capture:
                return gen._pred_chunk(models, x[idx], cc[idx], embeds, t, randf, flip,
                                       banks, use_global)
            listed.append(MatchList())
            with tome.matcher_hook(listed[-1]):
                e, banks = gen._pred_chunk(models, x[idx], cc[idx], embeds, t, randf, flip,
                                           banks, use_global)
            if use_global:  # slots 0 and 1 have run: a slot of each kind
                self._capture(models, x, cc, embeds, e, banks, listed)
                self.signature, live = sig, True
                self._stage(embeds, t)
            return e, banks
        return pred

    def _stage(self, embeds, t: float) -> None:
        self.t_in.fill_(t)
        for dst, src in zip(self.emb_in, embeds):
            dst.copy_(src)

    def _replay(self, g: _Graphed) -> torch.Tensor:
        with span("unet"):
            for k, seg in enumerate(g.segments):
                seg.replay()
                if k < len(g.calls):
                    a, bt, node_max, node_idx = g.calls[k]
                    with span("tome"):
                        m, i = tome.online_argmax_scores(a, bt)
                        node_max.copy_(m)
                        node_idx.copy_(i)
        for k, (n, shapes) in g.launches.items():
            kernels.STATS[k].launches += n
            kernels.STATS[k].shapes.update(shapes)
        return self.out

    def _capture(self, models, x, cc, embeds, e, banks, listed) -> None:
        """Capture every key of the window's shape, after the eager slots 0
        (`listed[0]`'s calls) and 1, whose banks the graphs take over."""
        t0 = time.perf_counter()
        dev = x.device
        cs = e.shape[0]
        self.x_in = torch.empty((cs,) + tuple(x.shape[1:]), dtype=x.dtype, device=dev)
        self.cc_in = torch.empty((cs,) + tuple(cc.shape[1:]), dtype=cc.dtype, device=dev)
        self.t_in = torch.empty((), dtype=torch.float32, device=dev)
        self.emb_in = tuple(torch.empty_like(v) for v in embeds)
        calls = listed[0].calls + listed[1].calls
        n, rows = staging_size(calls)
        self.staging = torch.empty(n, dtype=calls[0][2], device=dev)
        self.node_max = torch.empty(rows, dtype=torch.float32, device=dev)
        self.node_idx = torch.empty(rows, dtype=torch.int32, device=dev)
        expected = {False: len(listed[0].calls), True: len(listed[1].calls)}
        first, later = variant_keys(models.tome_spec)
        pool = torch.cuda.graph_pool_handle()
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        keep: dict = {}  # the banks and the output, in the pool
        with torch.cuda.stream(stream):
            for key, (randf, flip, use_global) in (first | later).items():
                rec = SplitRecorder(self.staging, self.node_max, self.node_idx, pool)
                before = _launches()
                with tome.matcher_hook(rec):
                    rec.begin()
                    if not keep:
                        keep["banks"] = {k: torch.empty_like(v) for k, v in banks.items()}
                        keep["out"] = torch.empty_like(e)
                    eps, new_banks = self.gen._pred_chunk(
                        models, self.x_in, self.cc_in, self.emb_in, self.t_in, randf, flip,
                        keep["banks"] if use_global else None, use_global)
                    for k, v in new_banks.items():
                        keep["banks"][k].copy_(v)
                    keep["out"].copy_(eps)
                    rec.end()
                if len(rec.calls) != expected[key[2]]:
                    raise RuntimeError(f"yt slot graphs: key {key} made {len(rec.calls)} "
                                       f"matchings, the eager slot {expected[key[2]]}")
                self.graphs[key] = _Graphed(rec.segments, rec.calls, _launches_since(before))
                self.counter["captured"] += len(rec.segments)
        torch.cuda.current_stream(dev).wait_stream(stream)
        # cuBLAS keeps a workspace for each stream it ran on: the capture
        # stream's was allocated in the pool during the capture, and only
        # the graphs' GEMMs use it. Released, it stays theirs as long as
        # nothing else is captured into the pool (the default stream's is
        # made again at its next GEMM). A private PyTorch call, which drops
        # the workspaces of every stream: re-check it on an upgrade.
        torch._C._cuda_clearCublasWorkspaces()
        for k, v in banks.items():  # slot 1's banks, for slot 2's replay
            keep["banks"][k].copy_(v)
        self.out = keep["out"]
        self.counter["keys"] = len(self.graphs)
        self.counter["capture_s"] += time.perf_counter() - t0

