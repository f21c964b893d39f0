"""The timing decorator and the trace context of
``LocalExpertOI.run(profile_dir=...)``.

Port of ``gpsat_tpu/decorators.py``: ``timer`` as it is (ref:
GPSat/decorators.py:6-47). Where the JAX package
wraps a run in a ``jax.profiler`` trace, ``profile_trace`` wraps it in a
``torch.profiler`` one (host ops, and the card's kernels when a CUDA device
is present), written under ``log_dir`` by ``tensorboard_trace_handler`` as a
Chrome trace (``*.pt.trace.json``) that TensorBoard or Perfetto opens.
"""

from __future__ import annotations

import contextlib
import os
import time
from functools import wraps


def timer(func):
    """Print "'name': X.xxx seconds" per call."""

    @wraps(func)
    def caller(*args, **kwargs):
        t0 = time.perf_counter()
        result = func(*args, **kwargs)
        t1 = time.perf_counter()
        print(f"'{func.__name__}': {t1 - t0:.3f} seconds")
        return result

    return caller


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """A torch.profiler trace of the block's work, written under ``log_dir``
    when the block ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
