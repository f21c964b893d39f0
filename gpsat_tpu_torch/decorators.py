"""The trace context of ``LocalExpertOI.run(profile_dir=...)``.

Port of ``gpsat_tpu/decorators.py::profile_trace``: where the JAX package
wraps a run in a ``jax.profiler`` trace, ``profile_trace`` wraps it in a
``torch.profiler`` one (host ops, and the card's kernels when a CUDA device
is present), written under ``log_dir`` by ``tensorboard_trace_handler`` as a
Chrome trace (``*.pt.trace.json``) that TensorBoard or Perfetto opens.
"""

from __future__ import annotations

import contextlib
import os


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
