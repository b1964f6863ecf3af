"""Profiling (JAX reference: utils/profiler.py): torch.profiler traces of
the host and the card captured between two configured steps, written as
Chrome traces (viewable in Perfetto or chrome://tracing) into the run
directory."""

from __future__ import annotations

import os


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
