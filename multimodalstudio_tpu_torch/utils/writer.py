"""Buffered event writing to the terminal and TensorBoard (JAX reference:
utils/writer.py): scalars, dicts, images and times are put into a buffer
and flushed on a step cadence to the registered writers (a terminal table,
tensorboardX when it can be imported, wandb when asked for and
installed). Rays/s come from host-timed steps up to
`torch.cuda.synchronize()`.
"""

from __future__ import annotations

import collections
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

# tracked throughput/time event names (reference writer.py:48-59)
ITER_TRAIN_TIME = "Train Iter (time)"
TRAIN_RAYS_PER_SEC = "Train Rays / Sec"
TEST_RAYS_PER_SEC = "Test Rays / Sec"
VIS_RAYS_PER_SEC = "Vis Rays / Sec"
ETA = "ETA (time)"


class EventBuffer:
    """Accumulates events between flushes (reference EVENT_STORAGE)."""

    def __init__(self, max_buffer_size: int = 20):
        self.scalars: Dict[str, float] = {}
        self.images: Dict[str, np.ndarray] = {}
        self.times: Dict[str, collections.deque] = collections.defaultdict(
            lambda: collections.deque(maxlen=max_buffer_size)
        )
        self.step = 0

    def put_scalar(self, name: str, value: float, step: int):
        self.scalars[name] = float(value)
        self.step = step

    def put_dict(self, values: Dict[str, float], step: int, prefix: str = ""):
        for k, v in values.items():
            try:
                self.put_scalar(prefix + k, float(v), step)
            except (TypeError, ValueError):
                pass

    def put_image(self, name: str, image: np.ndarray, step: int):
        self.images[name] = image
        self.step = step

    def put_time(self, name: str, duration: float, step: int, avg_over_steps: bool = True):
        self.times[name].append(duration)
        self.step = step

    def avg_time(self, name: str) -> Optional[float]:
        q = self.times.get(name)
        return float(np.mean(q)) if q else None


class LocalWriter:
    """Scrolling terminal stats table (reference writer.py:372-488)."""

    def __init__(self, max_log_size: int = 10):
        self.max_log_size = max_log_size
        self._header_printed = False

    def write(self, buffer: EventBuffer, step: int, max_steps: int):
        cols = ["step"]
        vals = [str(step)]
        it = buffer.avg_time(ITER_TRAIN_TIME)
        if it is not None:
            cols.append("iter (ms)")
            vals.append(f"{it * 1000:.1f}")
            remaining = (max_steps - step) * it
            cols.append("ETA")
            vals.append(_fmt_time(remaining))
        for name in (TRAIN_RAYS_PER_SEC, TEST_RAYS_PER_SEC):
            v = buffer.avg_time(name)
            if v is not None:
                cols.append(name)
                vals.append(f"{v:,.0f}")
        for k in sorted(buffer.scalars):
            if k.startswith(("losses/total", "metrics/psnr")):
                cols.append(k.split("/")[-1])
                vals.append(f"{buffer.scalars[k]:.3f}")
        widths = [max(len(c), len(v)) + 2 for c, v in zip(cols, vals)]
        if not self._header_printed or step % (self.max_log_size * 10) == 0:
            print("".join(c.ljust(w) for c, w in zip(cols, widths)))
            self._header_printed = True
        print("".join(v.ljust(w) for v, w in zip(vals, widths)), flush=True)


class TensorboardWriter:
    """tensorboardX writer (reference writer.py:320-340)."""

    def __init__(self, log_dir: str):
        from tensorboardX import SummaryWriter

        self.writer = SummaryWriter(log_dir=log_dir)

    def write(self, buffer: EventBuffer, step: int, max_steps: int):
        for k, v in buffer.scalars.items():
            self.writer.add_scalar(k, v, step)
        for k, img in buffer.images.items():
            self.writer.add_image(k, img, step, dataformats="HWC")
        for name, q in buffer.times.items():
            if q:
                self.writer.add_scalar(f"time/{name}", float(np.mean(q)), step)


class WandbWriter:
    """Weights & Biases writer (reference writer.py:295-317); requires the
    optional `wandb` package."""

    def __init__(self, log_dir: str, project: str = "mms-tpu"):
        import wandb

        self.run = wandb.init(project=project, dir=log_dir, reinit=True)
        self.wandb = wandb

    def write(self, buffer: EventBuffer, step: int, max_steps: int):
        payload = dict(buffer.scalars)
        for k, img in buffer.images.items():
            payload[k] = self.wandb.Image(img)
        self.run.log(payload, step=step)


class Writer:
    """Front-end: buffer + registered writers, flushed on cadence
    (reference writer.py:42-172)."""

    def __init__(
        self,
        log_dir: Optional[str] = None,
        use_tensorboard: bool = True,
        use_local: bool = True,
        use_wandb: bool = False,
        max_buffer_size: int = 20,
    ):
        self.buffer = EventBuffer(max_buffer_size)
        self.writers: List = []
        if use_local:
            self.writers.append(LocalWriter())
        if use_tensorboard and log_dir is not None:
            try:
                self.writers.append(TensorboardWriter(os.path.join(log_dir, "tb")))
            except ImportError:
                pass
        if use_wandb and log_dir is not None:
            try:
                self.writers.append(WandbWriter(log_dir))
            except ImportError:
                print("wandb not installed; skipping WandbWriter")

    def put_scalar(self, name, value, step):
        self.buffer.put_scalar(name, value, step)

    def put_dict(self, values, step, prefix=""):
        self.buffer.put_dict(values, step, prefix)

    def put_image(self, name, image, step):
        self.buffer.put_image(name, image, step)

    def put_time(self, name, duration, step):
        self.buffer.put_time(name, duration, step)

    def flush(self, step: int, max_steps: int):
        for w in self.writers:
            w.write(self.buffer, step, max_steps)
        self.buffer.scalars = {}
        self.buffer.images = {}


def _fmt_time(seconds: float) -> str:
    seconds = int(seconds)
    h, rem = divmod(seconds, 3600)
    m, s = divmod(rem, 60)
    if h:
        return f"{h}h{m:02d}m"
    if m:
        return f"{m}m{s:02d}s"
    return f"{s}s"


class TimeWriter:
    """Context timer feeding put_time (writer.py:187-208); with `block` a
    CUDA device, the exit first waits for that device's queued work."""

    def __init__(self, writer: Optional[Writer], name: str, step: int, block=None):
        self.writer = writer
        self.name = name
        self.step = step
        self.block = block

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.block is not None and torch.device(self.block).type == "cuda":
            torch.cuda.synchronize(self.block)
        self.duration = time.perf_counter() - self.start
        if self.writer is not None:
            self.writer.put_time(self.name, self.duration, self.step)
        return False
