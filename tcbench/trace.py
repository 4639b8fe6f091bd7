"""The device trace of a traced window, read from torch.profiler's Chrome
trace: device operations (kernels, copies, fills) and what the host ran.

Kernels are grouped by name into the port's hand-written kernels (K1 the
flash attention, K2 the ToMe matcher, K6 / K7 the int8 attentions),
convolutions, GEMMs, and "other" (elementwise, normalisation, layout
copies, fills). The device's busy time is the union of its operations'
intervals, so overlapping operations count once.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
from pathlib import Path

GROUPS = (("flash_attention", ("flash_fwd_wgmma_kernel",)),
          ("flash_attention_int8", ("flash_int8",)),
          ("match_argmax", ("match_argmax",)),
          ("convolution", ("conv", "fprop", "winograd", "dgrad", "wgrad")),
          ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "cublas")))
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "cuda_runtime", "cuda_driver"}


def group_of(name: str) -> str:
    low = name.lower()
    return next((g for g, keys in GROUPS if any(k in low for k in keys)), "other")


@dataclasses.dataclass
class Trace:
    device: list   # (start_us, end_us, name) of every device operation
    host: list     # (start_us, end_us, name) of host operations and runtime calls
    steps: int     # whole steps in the traced window
    wall_s: float  # host-clock length of the traced window

    def device_s(self, group: str | None = None) -> float:
        return sum(e - s for s, e, n in self.device
                   if group is None or group_of(n) == group) * 1e-6

    def kernels(self) -> int:
        return sum(1 for _, _, n in self.device if not n.startswith(("Memcpy", "Memset")))

    def busy(self) -> list:
        """The union of the device intervals, sorted."""
        out: list = []
        for s, e, _ in sorted(self.device):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) * 1e-6

    def by_group(self) -> dict:
        out: dict = {}
        for s, e, n in self.device:
            out[group_of(n)] = out.get(group_of(n), 0.0) + (e - s) * 1e-6
        return out

    def top_kernels(self, k: int) -> list:
        out: dict = {}
        for s, e, n in self.device:
            out[n] = out.get(n, 0.0) + (e - s) * 1e-6
        return sorted(out.items(), key=lambda kv: -kv[1])[:k]

    def idle_gaps(self, k: int, min_us: float = 5.0) -> list:
        """Idle time between device operations, summed by the innermost
        host operation running at each gap's middle ("python" when none)."""
        busy = self.busy()
        host = sorted(self.host)
        starts = [h[0] for h in host]
        out: dict = {}
        for (_, e0), (s1, _) in zip(busy, busy[1:]):
            if s1 - e0 < min_us:
                continue
            mid = 0.5 * (e0 + s1)
            j = bisect.bisect_right(starts, mid)
            cover = [h for h in host[max(0, j - 2000):j] if h[1] >= mid]
            name = min(cover, key=lambda h: h[1] - h[0])[2] if cover else "python"
            out[name] = out.get(name, 0.0) + (s1 - e0) * 1e-6
        return sorted(out.items(), key=lambda kv: -kv[1])[:k]


def read_chrome(path: Path, steps: int, wall_s: float) -> Trace:
    events = json.loads(Path(path).read_text()).get("traceEvents", [])
    device, host = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = float(ev["ts"])
        item = (s, s + float(ev["dur"]), str(ev.get("name", "")))
        if ev.get("cat") in DEVICE_CATS:
            device.append(item)
        elif ev.get("cat") in HOST_CATS:
            host.append(item)
    return Trace(device, host, steps, wall_s)
