"""Profiling (JAX reference: utils/profiler.py): torch.profiler traces of
the host and the card captured between two configured steps, written as
Chrome traces (viewable in Perfetto or chrome://tracing) into the run
directory, and a profile's time summed by op (`device_op_stats`, which
scripts/profile_step.py and chip_smoke.py read)."""

from __future__ import annotations

import os
from typing import Dict, List


def device_op_stats(prof, device_type: str = "cuda") -> List[Dict]:
    """Each op of one device type in a finished torch.profiler profile: its
    name, count and self ms, by self ms, largest first. On "cuda" the ops
    are the card's kernels, copies and fills, which do not nest, so self
    time is duration; on "cpu" an operator's self time is its duration less
    that of the operators nested in it on its thread.

    The raw kineto events are summed by name in one pass: the profiler's
    Python event list (`events()`, `key_averages()`) took 10-20 s a
    training step's profile with the host's ops, 3-4 s for the card's ops
    alone."""
    from torch.autograd import DeviceType

    want = DeviceType.CUDA if device_type == "cuda" else DeviceType.CPU
    events = [e for e in prof.profiler.kineto_results.events() if e.device_type() == want]
    self_ns = [e.duration_ns() for e in events]
    if want == DeviceType.CPU:
        order = sorted(range(len(events)), key=lambda i: (
            events[i].start_thread_id(), events[i].start_ns(), -events[i].end_ns()))
        stack, thread = [], None
        for i in order:
            e = events[i]
            if e.start_thread_id() != thread:
                stack, thread = [], e.start_thread_id()
            while stack and events[stack[-1]].end_ns() <= e.start_ns():
                stack.pop()
            if stack:
                self_ns[stack[-1]] -= e.duration_ns()
            stack.append(i)
    by_name: Dict[str, List] = {}
    for e, ns in zip(events, self_ns):
        entry = by_name.setdefault(e.name(), [0, 0])
        entry[0] += 1
        entry[1] += ns
    rows = [{"name": k, "count": n, "self_ms": ns / 1e6} for k, (n, ns) in by_name.items()]
    return sorted(rows, key=lambda r: -r["self_ms"])


class TorchTraceProfiler:
    """torch.profiler traces of the host and the card, one for each
    configured step (maybe_start before the step, maybe_stop after it, as
    profiler.py:61-80 steps jax.profiler), each written to
    <log_dir>/torch_trace/trace-step-<step>.json."""

    def __init__(self, log_dir: str, steps=(12, 17)):
        self.log_dir = os.path.join(log_dir, "torch_trace")
        self.steps = set(steps)
        self._prof = None
        self._start = None

    def maybe_start(self, step: int):
        if step in self.steps and self._prof is None:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            self._start = step

    def maybe_stop(self, step: int):
        if self._prof is not None and step in self.steps:
            self._prof.__exit__(None, None, None)
            os.makedirs(self.log_dir, exist_ok=True)
            self._prof.export_chrome_trace(
                os.path.join(self.log_dir, f"trace-step-{self._start}.json"))
            self._prof = None
